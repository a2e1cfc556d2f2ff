"""Command-line entry points of the port (the counterpart of ``tmar.cli``):

    python -m tmar_torch.cli test --checkpoint reports/compare_r4/flagship.pth \\
        --set data.dataset=synthetic model.use_pallas_attention=true [--tiled]
    python -m tmar_torch.cli train --config tmar_torch/configs/train_syndeeplesion.yaml \\
        --set data.dataset=synthetic
    python -m torch.distributed.run --nproc-per-node N -m tmar_torch.cli train \\
        --set parallel.mode=fsdp n_devices=N
    python -m tmar_torch.cli finetune --arch dudo --artifact-dir <npy dir> \\
        --clean-dir <npy dir> --epochs 1
    python -m tmar_torch.cli compare --checkpoints flagship=reports/compare_r4/flagship.pth \\
        identity --set data.dataset=synthetic --num-samples 4
    python -m tmar_torch.cli ablate --ablations A1_no_physics B2_no_spectral_norm \\
        --inference-only --set data.dataset=synthetic
    python -m tmar_torch.cli export --checkpoint reports/compare_r4/flagship.pth \\
        --batch 8 --size 512 [--torch]

Each takes the JAX CLI's arguments plus ``--device`` (default ``cuda``; ``cpu``
runs the plain versions).  ``test`` serves the generator of the config from a
``.pth`` file or a port checkpoint directory, full-slice or with the 64/32
tiled eval on the device, and writes ``metrics.json`` in the JAX CLI's schema.
``train`` under ``torch.distributed.run`` runs one process per card (NCCL on
``cuda:LOCAL_RANK``; gloo with ``--device cpu``) with ``parallel.mode`` dp,
fsdp or tp.  ``finetune`` fine-tunes a baseline or DuDo and writes
``<out>/{arch}_finetuned.pkl`` in the flax layout, which the JAX package's
model loads, and ``history.json``.  ``compare`` runs the comparison harness
(``tmar_torch.eval.harness``) over generator checkpoints, out-of-process
adapters and fine-tuned DuDo pickles; ``ablate`` trains (or, with
``--inference-only``, restores) each ablation and evaluates it
(``tmar_torch.eval.ablation``).  Both write the JAX CLI's files.  ``export``
writes the generator's forward for one input bucket as a ``torch.export``
artifact (``ngswin_<size>b<batch>.pt2``, ``tmar_torch.export``), or with
``--torch`` its weights as a reference-layout ``.pth``.

The block form of the generator (``test``, ``compare``, ``ablate``, ``export``) comes
from the JAX package's environment variables, read here and nowhere else in
the port, and passed to ``build_generator`` as constructor arguments: ``TMAR_NSTB_FUSED=0`` (the
unfused block), ``TMAR_NSTB_MAP=0`` (the token-level fused block),
``TMAR_NGRAM_FUSED=0`` (the n-gram context on its composition path).
``train`` builds the config's form, which trains on the kernels that have
backward kernels and in which only ``TMAR_NGRAM_FUSED`` holds, as in the
JAX package.  ``TMAR_ATTN_IMPL`` names one of the JAX
package's TPU attention kernels; it is checked against their names and
changes nothing else, since every name computes the function that K3
computes (``tmar_torch.ops.cuda_attention.IMPLS``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List

def _parse_sets(pairs) -> Dict[str, Any]:
    """``--set`` pairs -> {dotted key: YAML value}.  argparse's
    action="append" with nargs="*" gives a list of lists, one per ``--set``:
    both ``--set a=1 b=2`` and ``--set a=1 --set b=2`` work."""
    import yaml

    flat: List[str] = []
    for p in pairs or []:
        flat.extend(p) if isinstance(p, list) else flat.append(p)
    out = {}
    for p in flat:
        if "=" not in p:
            raise SystemExit(f"--set expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        out[k] = yaml.safe_load(v)
    return out


def block_form(environ=os.environ) -> Dict[str, bool]:
    """The generator's block form from the JAX package's environment
    variables, as ``build_generator`` keywords; an unknown ``TMAR_ATTN_IMPL``
    raises ``ValueError``."""
    from tmar_torch.ops.cuda_attention import check_impl

    check_impl(environ.get("TMAR_ATTN_IMPL") or None)
    return {
        "ngram_fused": environ.get("TMAR_NGRAM_FUSED", "1") != "0",
        "nstb_fused": environ.get("TMAR_NSTB_FUSED", "1") != "0",
        "nstb_map": environ.get("TMAR_NSTB_MAP", "1") != "0",
    }


def train(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tmar_torch.cli train",
                                 description="Train TransMAR on the card")
    ap.add_argument("--config", default=None, help="YAML config path")
    ap.add_argument("--variant", default=None, help="variant/ablation name (baseline, v1..v5, full, A*, B*)")
    ap.add_argument("--set", nargs="*", action="append", default=[], help="dotted config overrides key=value (repeatable)")
    ap.add_argument("--resume", action="store_true", help="resume from latest checkpoint in run dir")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--no-val", action="store_true", help="skip periodic validation")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from tmar_torch.core.mesh import init_from_env, is_main_process
    from tmar_torch.train import Trainer, load_config, resolve_variant
    from tmar_torch.train.trainer import build_val_dataset

    cfg = load_config(args.config, _parse_sets(args.set))
    if args.variant:
        cfg = resolve_variant(cfg, args.variant)
        cfg.variant = args.variant
    # under torch.distributed.run: one process per device, this rank's card
    device = init_from_env(args.device)
    try:
        trainer = Trainer(
            cfg, device=device, val_dataset=None if args.no_val else build_val_dataset(cfg),
            ngram_fused=block_form()["ngram_fused"],
        )
        if args.resume:
            ok = trainer.resume()
            if is_main_process():
                print(f"[resume] {'restored from epoch ' + str(trainer.start_epoch) if ok else 'no checkpoint found, fresh start'}")
        trainer.fit(num_epochs=args.epochs)
        if is_main_process():
            print(json.dumps({"run_dir": trainer.run_dir, "best_psnr": trainer.best_psnr}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def test(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tmar_torch.cli test",
                                 description="Evaluate a checkpoint")
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint", required=True, help="port checkpoint dir or torch .pth file")
    ap.add_argument("--set", nargs="*", action="append", default=[])
    ap.add_argument("--tiled", action="store_true", help="64/32 overlapping tiled inference")
    ap.add_argument("--out", default="test_results")
    ap.add_argument("--max-samples", type=int, default=200)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from tmar_torch.eval import full_slice_eval, make_inference_fn, make_tiled_eval
    from tmar_torch.eval.metrics import mae, psnr, rmse, ssim
    from tmar_torch.train import load_config
    from tmar_torch.train.trainer import build_generator

    cfg = load_config(args.config, _parse_sets(args.set))
    gen = build_generator(cfg, args.device, **block_form())
    gen.load_state_dict(_load_generator_params(args.checkpoint, gen, cfg))
    # tiled mode: extraction, one batched forward and the coverage assembly
    # on the device; full-slice: the plain forward
    forward = (
        make_tiled_eval(gen, device=args.device) if args.tiled
        else make_inference_fn(gen, device=args.device)
    )

    ds = _build_test_dataset(cfg)
    os.makedirs(args.out, exist_ok=True)
    rows = []
    n = min(len(ds), args.max_samples)
    for i in range(n):
        sample = ds[i]
        ct = sample["ct"][None, ..., None]
        gt01 = (sample["gt"] + 1) / 2
        pred = (forward(ct) if args.tiled else full_slice_eval(forward, ct))[0, ..., 0]
        pred01 = np.clip((pred + 1) / 2, 0, 1)
        rows.append(
            {
                "index": i,
                "psnr": psnr(pred01, gt01),
                "ssim": ssim(pred01, gt01),
                "mae": mae(pred01, gt01),
                "rmse": rmse(pred01, gt01),
            }
        )
    summary = {k: float(np.mean([r[k] for r in rows])) for k in ("psnr", "ssim", "mae", "rmse")}
    summary["n"] = n
    summary["mode"] = "tiled" if args.tiled else "full_slice"
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump({"summary": summary, "per_sample": rows}, f, indent=2)
    print(json.dumps(summary))
    return 0


def finetune(argv=None) -> int:
    """Fine-tune a benchmark architecture on paired artifact/clean data, with
    the trace-masked sinogram loss unless ``--lambda-sino 0``."""
    ap = argparse.ArgumentParser(prog="python -m tmar_torch.cli finetune",
                                 description="Fine-tune a baseline or DuDo on the card")
    ap.add_argument("--arch", default="redcnn", choices=["redcnn", "transformer", "bafresnet", "dudo"],
                    help="architecture to fine-tune (dudo: the dual-domain unrolled net)")
    ap.add_argument("--stages", type=int, default=4, help="dudo only: unrolled proximal iterations")
    ap.add_argument("--channels", type=int, default=32, help="dudo only: cross-stage memory channels")
    ap.add_argument("--freeze-stages", type=int, default=0,
                    help="dudo only: freeze the first N stages and the prior net")
    ap.add_argument("--artifact-dir", default=None)
    ap.add_argument("--clean-dir", default=None)
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="generate N synthetic pairs instead of reading npy dirs")
    ap.add_argument("--mode", default="patch", choices=["patch", "resize"])
    ap.add_argument("--patch-size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--lambda-sino", type=float, default=0.1,
                    help="0 disables the sinogram term (image-domain loop)")
    ap.add_argument("--num-angles", type=int, default=180)
    ap.add_argument("--out", default="finetune_results")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import pickle
    import tempfile

    import numpy as np

    from tmar_torch.checkpoint.convert import module_to_flax
    from tmar_torch.data import BenchmarkFinetuneDataset, SyntheticMARDataset
    from tmar_torch.nn.baselines import BAFResNet, DenoisingTransformer, RedCNN
    from tmar_torch.nn.dudo import DuDoMARNet
    from tmar_torch.ops.radon import Radon
    from tmar_torch.train.finetune import FinetuneWeights, dudo_freeze_prefixes
    from tmar_torch.train.finetune import finetune as run_finetune

    with tempfile.TemporaryDirectory(prefix="tmar_torch_ft_syn_") as tmp:
        if args.synthetic:
            art, cln = os.path.join(tmp, "artifact"), os.path.join(tmp, "clean")
            os.makedirs(art)
            os.makedirs(cln)
            syn = SyntheticMARDataset(size=args.patch_size, length=args.synthetic)
            for i in range(args.synthetic):
                s = syn[i]
                # stored as HU, so that the dataset's window maps them back
                np.save(os.path.join(art, f"{i:04d}.npy"), (s["ct"] + 1) / 2 * 3000 - 1000)
                np.save(os.path.join(cln, f"{i:04d}.npy"), (s["gt"] + 1) / 2 * 3000 - 1000)
            args.artifact_dir, args.clean_dir = art, cln
        if not args.artifact_dir or not args.clean_dir:
            raise SystemExit("pass --artifact-dir/--clean-dir or --synthetic N")
        ds = BenchmarkFinetuneDataset(args.artifact_dir, args.clean_dir,
                                      patch_size=args.patch_size, mode=args.mode)
        projector = None
        if args.lambda_sino or args.arch == "dudo":
            projector = Radon(args.patch_size, np.linspace(0, np.pi, args.num_angles, endpoint=False),
                              device=args.device)
        freeze_prefixes = ()
        if args.arch == "dudo":
            model = DuDoMARNet(projector=projector, stages=args.stages, channels=args.channels)
            if args.freeze_stages:
                freeze_prefixes = dudo_freeze_prefixes(args.freeze_stages)
        elif args.arch == "transformer":
            model = DenoisingTransformer(img_size=args.patch_size, device=args.device)
        else:
            model = {"redcnn": RedCNN, "bafresnet": BAFResNet}[args.arch](device=args.device)
        result = run_finetune(
            model, ds, num_epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
            weights=FinetuneWeights(sino=args.lambda_sino), projector=projector, progress=True,
            freeze_prefixes=freeze_prefixes, device=args.device,
        )
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.arch}_finetuned.pkl"), "wb") as f:
        pickle.dump(module_to_flax(model)[0], f)
    with open(os.path.join(args.out, "history.json"), "w") as f:
        json.dump(result["history"], f, indent=2)
    print(json.dumps({"final": result["history"][-1], "out": args.out}))
    return 0


def ablate(argv=None) -> int:
    """The ablation sweep: train each ablation (or, with --inference-only,
    restore its checkpoint from its run directory), evaluate it on the test
    set with the global, regional and HU metric families and the plot
    families at fixed vis-sample indices, then write the cross-ablation
    summary.  A failing ablation is a FAILED row."""
    ap = argparse.ArgumentParser(prog="python -m tmar_torch.cli ablate",
                                 description="Run the ablation matrix")
    ap.add_argument("--config", default=None)
    ap.add_argument("--ablations", nargs="*", default=None, help="default: all")
    ap.add_argument("--set", nargs="*", action="append", default=[])
    ap.add_argument("--epochs", type=int, default=10, help="10-epoch ablations by default")
    ap.add_argument("--inference-only", action="store_true",
                    help="skip training; restore each ablation's checkpoint "
                         "from its run dir and re-run the evaluation")
    ap.add_argument("--max-eval-samples", type=int, default=None,
                    help="cap the test-set evaluation (default: full set)")
    ap.add_argument("--vis-samples", type=int, default=8,
                    help="fixed seeded visualization samples shared across ablations")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from tmar_torch.eval import make_inference_fn
    from tmar_torch.eval.ablation import cross_ablation_summary, evaluate_run, fixed_vis_indices
    from tmar_torch.train import ABLATIONS, Trainer, load_config, resolve_variant
    from tmar_torch.train.trainer import build_generator, build_val_dataset

    form = block_form()
    names = args.ablations or sorted(ABLATIONS)
    base_cfg = load_config(args.config, _parse_sets(args.set))
    test_ds = _build_test_dataset(base_cfg)
    vis = fixed_vis_indices(min(len(test_ds), args.max_eval_samples or len(test_ds)),
                            k=args.vis_samples)
    results = {}
    for name in names:
        cfg = resolve_variant(load_config(args.config, _parse_sets(args.set)), name)
        cfg.variant = name
        cfg.run_name = f"ablation_{name}"
        run_dir = os.path.join(cfg.run_dir, cfg.run_name)
        try:
            history = val_history = None
            gen = build_generator(cfg, args.device, **form)
            if args.inference_only:
                sd = _load_generator_params(os.path.join(run_dir, "checkpoints"), gen, cfg)
            else:
                trainer = Trainer(cfg, device=args.device, val_dataset=build_val_dataset(cfg),
                                  ngram_fused=form["ngram_fused"])
                trainer.fit(num_epochs=args.epochs)
                run_dir = trainer.run_dir
                sd = (trainer.state.g_ema if trainer.state.g_ema is not None
                      else trainer.generator.state_dict())
                history, val_history = trainer.history, trainer.val_history
                del trainer
            gen.load_state_dict({k: v.detach() for k, v in sd.items()})
            summary = evaluate_run(
                make_inference_fn(gen, device=args.device), test_ds,
                os.path.join(run_dir, "evaluation"), vis_indices=vis,
                max_samples=args.max_eval_samples, history=history, val_history=val_history,
                name=name,
            )
            results[name] = {"status": "ok", "summary": summary, "run_dir": run_dir}
        except Exception as e:  # a FAILED row, as the JAX sweep records it
            results[name] = {"status": "FAILED", "error": str(e)}
    summary_csv = cross_ablation_summary(results, base_cfg.run_dir)
    print(json.dumps({n: r["status"] for n, r in results.items()} | {"summary_csv": summary_csv},
                     indent=2))
    return 0


def compare(argv=None) -> int:
    """The multi-model benchmark comparison over generator checkpoints,
    out-of-process adapters and fine-tuned DuDo nets."""
    ap = argparse.ArgumentParser(prog="python -m tmar_torch.cli compare",
                                 description="Compare models on one seeded sample set")
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoints", nargs="*", default=[],
                    help="name=path pairs (port checkpoint dir or .pth); 'identity' allowed")
    ap.add_argument("--adapter", nargs="*", default=[],
                    help="name=[protocol:]<shell command> out-of-process adapters; the "
                         "command gets <input.npz> <output.npy> appended.  Without a "
                         "protocol prefix the raw enriched sample crosses the boundary "
                         "(SubprocessAdapter); with x255/x255half/sparse/nmar the "
                         "preprocessing protocol wraps the subprocess as its model core "
                         "(make_protocol_subprocess_runner); sparse/nmar need --sinograms")
    ap.add_argument("--dudo", nargs="*", default=[],
                    help="name=<params.pkl> entries for the in-tree dual-domain net "
                         "(finetune --arch dudo output); implies --sinograms")
    ap.add_argument("--dudo-stages", type=int, default=4)
    ap.add_argument("--dudo-channels", type=int, default=32)
    ap.add_argument("--dudo-li", default="train", choices=["train", "sample"],
                    help="dudo entry preprocessing: 'train' rebuilds XLI/SLI with the "
                         "finetune engine's mean-fill construction; 'sample' trusts the "
                         "dataset's LI images")
    ap.add_argument("--sinograms", action="store_true",
                    help="synthesize Sma/SLI/Tr sinograms for dual-domain adapters")
    ap.add_argument("--composites", type=int, default=3,
                    help="composite+profile figures for the first N samples")
    ap.add_argument("--set", nargs="*", action="append", default=[])
    ap.add_argument("--out", default="comparison_results")
    ap.add_argument("--num-samples", type=int, default=25)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import pickle
    import shlex

    import numpy as np

    from tmar_torch.eval import make_inference_fn
    from tmar_torch.eval.adapters import (PROTOCOL_CORE_KEYS, SubprocessAdapter,
                                          make_dudo_runner, make_protocol_subprocess_runner)
    from tmar_torch.eval.harness import ModelEntry, run_comparison
    from tmar_torch.train import load_config
    from tmar_torch.train.trainer import build_generator

    cfg = load_config(args.config, _parse_sets(args.set))
    form = block_form()
    entries = []
    for spec in args.checkpoints:
        name, _, path = spec.partition("=")
        if path == "" and name == "identity":
            entries.append(ModelEntry("identity", lambda x: x))
            continue
        gen = build_generator(cfg, args.device, **form)
        gen.load_state_dict(_load_generator_params(path, gen, cfg))
        entries.append(ModelEntry(name, make_inference_fn(gen, device=args.device)))
    # adapters parse in two steps: the sparse / nmar protocols need the
    # Radon operator, which is sized from the dataset below
    adapter_specs = []
    for spec in args.adapter:
        name, _, cmd = spec.partition("=")
        if not cmd:
            raise SystemExit(f"--adapter expects name=[protocol:]command, got {spec!r}")
        protocol = None
        head, sep, rest = cmd.partition(":")
        if sep and head in (*PROTOCOL_CORE_KEYS, "raw"):
            protocol, cmd = (None if head == "raw" else head), rest
        adapter_specs.append((name, protocol, cmd))

    ds = _build_test_dataset(cfg)
    radon = None
    if args.sinograms or args.dudo or any(p in ("sparse", "nmar") for _, p, _ in adapter_specs):
        from tmar_torch.ops.radon import Radon

        radon = Radon(ds[0]["ct"].shape[0],
                      np.linspace(0, np.pi, cfg.radon.num_angles, endpoint=False),
                      device=args.device)
    for name, protocol, cmd in adapter_specs:
        runner = (SubprocessAdapter(shlex.split(cmd)) if protocol is None
                  else make_protocol_subprocess_runner(protocol, shlex.split(cmd), radon=radon))
        entries.append(ModelEntry(name, runner=runner))
    for spec in args.dudo:
        from tmar_torch.nn.dudo import DuDoMARNet

        name, _, path = spec.partition("=")
        if not path:
            raise SystemExit(f"--dudo expects name=params.pkl, got {spec!r}")
        with open(path, "rb") as f:
            dudo_params = pickle.load(f)
        net = DuDoMARNet(projector=radon, stages=args.dudo_stages, channels=args.dudo_channels)
        entries.append(ModelEntry(name, runner=make_dudo_runner(
            net, dudo_params, radon=radon, li_mode=args.dudo_li)))
    if not entries:
        raise SystemExit("no entries: pass --checkpoints / --adapter / --dudo")
    results = run_comparison(entries, ds, args.out, num_samples=args.num_samples,
                             seed=args.seed, radon=radon, composite_samples=args.composites)
    print(json.dumps({k: v.get("status") for k, v in results.items()}))
    return 0


def _load_generator_params(path: str, gen, cfg):
    """The generator ``state_dict`` to serve: a ``.pth`` file's, or from a
    port checkpoint directory the ``best`` checkpoint when there is one (else
    the latest), its EMA weights when the run kept them."""
    if path.endswith(".pth"):
        from tmar_torch.checkpoint import load_pth

        return load_pth(path)
    import torch

    from tmar_torch.checkpoint.io import CheckpointManager
    from tmar_torch.train.steps import create_train_state
    from tmar_torch.train.trainer import build_discriminator, build_optimizers

    device = next(gen.parameters()).device
    mgr = CheckpointManager(path)

    def restore(ema_decay: float):
        disc = build_discriminator(cfg, device)
        state = create_train_state(torch.Generator().manual_seed(0), gen, disc,
                                   *build_optimizers(cfg, gen, disc), ema_decay=ema_decay)
        restored = mgr.restore(state, best=os.path.isdir(os.path.join(path, "best")))
        return restored if restored is not None else mgr.restore(state)

    # Whether the saved state carries an EMA is a property of the training
    # run, not of this serving config: try the config's layout, then the
    # other one
    cfg_ema = getattr(cfg.optim, "ema_decay", 0.0)
    try:
        restored = restore(cfg_ema)
    except ValueError:
        restored = restore(0.0 if cfg_ema else 0.999)
    if restored is None:
        raise SystemExit(f"no checkpoint found under {path}")
    state = restored[0]
    if state.g_ema is not None:
        return {k: v.detach().clone() for k, v in state.g_ema.items()}
    return {k: v.detach().clone() for k, v in state.generator.state_dict().items()}


def _build_test_dataset(cfg):
    from tmar_torch.data import SpineWebDataset, SynDeepLesionTestDataset, SyntheticMARDataset

    d = cfg.data
    if d.dataset == "syndeeplesion":
        return SynDeepLesionTestDataset(d.root)
    if d.dataset == "spineweb":
        return SpineWebDataset(d.spineweb_artifact, d.spineweb_clean, train=False)
    # synthetic: full 416² slices by default, or the configured patch size
    # when one is set
    size = d.patch_size if d.patch_size and d.patch_size != 128 else 416
    return SyntheticMARDataset(size=size, length=32)


def export(argv=None) -> int:
    from tmar_torch.export import main as export_main

    return export_main(argv)


_COMMANDS = {"train": train, "test": test, "finetune": finetune, "ablate": ablate,
             "compare": compare, "export": export}


def main(argv=None) -> int:
    """``python -m tmar_torch.cli <command> [args]``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    names = sorted(_COMMANDS)
    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: python -m tmar_torch.cli {{{' | '.join(names)}}} [options]\n"
              f"run 'python -m tmar_torch.cli <command> -h' for command options")
        return 0 if argv else 2
    cmd = argv[0]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}; expected one of {names}", file=sys.stderr)
        return 2
    return _COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
