#!/usr/bin/env python3
"""The port's training launch on several NVIDIA GPUs of one host, over NCCL.

    python3 chip_multicard.py [--nproc N]

Needs N CUDA cards (default 4).  Builds the kernels from this checkout, then
trains the promoted recipe (``train_syndeeplesion.yaml``, ``full`` variant)
at full width on synthetic data in float32, one step of N rows and one
validation, through ``tmar_torch.cli train`` as a user launches it:

* ``one``: one process on ``cuda:0``, the reference;
* ``dp``, ``fsdp``: ``python -m torch.distributed.run --standalone
  --nproc-per-node N -m tmar_torch.cli train --set parallel.mode=<mode>
  n_devices=N``: one rank per card, NCCL (``init_from_env``), one row a rank;
* ``tp``: the same with ``parallel.model_parallel=2`` in the plain form, a
  (N/2, 2) mesh of the data and model axes.

Each run writes its checkpoint (rank 0, whole tensors).  The script holds
each launched run's generator, EMA and discriminator against the
reference's: max |diff| <= 2.1·lr and mean <= 0.01·lr, ``chip_smoke.py``
phase 22's bounds on the parameters after one step (Adam's first update is
about lr·sign(g), so only the components whose gradient is rounding noise
can move apart, by at most two such steps); the validation PSNR rtol 1e-4.
TF32 is off in every process (``NVIDIA_TF32_OVERRIDE=0``), so both sides'
products and convolutions run in float32.  The ranks' kernel launches are
not counted here: ``chip_smoke.py`` counts them under every layout.

Prints one ``[multicard]`` line a run with its wall time (process start,
kernel loading, the ``Trainer`` build, the step, the validation and the
checkpoint), one ``[check]`` line a comparison, the card line and last
``{"ok": ..., "device": ...}``; a run that fails has the end of its output
printed.  Exits non-zero when a run or a check fails, or without N cards.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_TIMEOUT = 180  # seconds a run may take


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def run_sets(nproc: int, run_dir: str, name: str) -> dict:
    """The config overrides of run ``name``: the promoted recipe at full
    width, f32, one step of ``nproc`` rows, one validation of as many."""
    sets = {"data.dataset": "synthetic", "data.batch_size": nproc, "data.samples_per_epoch": nproc,
            "data.num_workers": 2, "bf16": False, "optim.ema_decay": 0.999, "num_epochs": 1,
            "val_every_n_epochs": 1, "checkpoint_every_n_epochs": 1, "log_every": 1,
            "run_dir": run_dir, "run_name": name}
    if name != "one":
        sets.update({"parallel.mode": name, "n_devices": nproc})
    if name == "tp":
        sets.update({"parallel.model_parallel": 2, "model.use_pallas_attention": False})
    return sets


def launch(nproc: int, run_dir: str, name: str) -> dict:
    """Run ``tmar_torch.cli train`` (under the launcher unless ``name`` is
    ``one``); returns its exit code, wall time and last stdout line."""
    cmd = [sys.executable, "-m"]
    if name != "one":
        cmd += ["torch.distributed.run", "--standalone", "--nproc-per-node", str(nproc), "-m"]
    cmd += ["tmar_torch.cli", "train", "--config",
            os.path.join(ROOT, "tmar_torch", "configs", "train_syndeeplesion.yaml"),
            "--variant", "full", "--set",
            *(f"{k}={json.dumps(v)}" for k, v in run_sets(nproc, run_dir, name).items())]
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0",
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    log = os.path.join(run_dir, f"{name}.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        # a session of its own, so that a run past its time is ended with
        # every process it started
        p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=f, text=True,
                             start_new_session=True)
        try:
            out, _ = p.communicate(timeout=RUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            out, _ = p.communicate()
        f.write(out)
    lines = out.strip().splitlines()
    return {"rc": p.returncode, "s": time.perf_counter() - t0, "last": lines[-1] if lines else "",
            "log": log}


def checkpoint(run_dir: str, name: str) -> dict:
    import torch

    path = os.path.join(run_dir, name, "checkpoints", "step_0000000001", "state.pt")
    return torch.load(path, map_location="cpu", weights_only=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=4, help="cards, one rank each")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < args.nproc:
        print(f"chip_multicard: needs {args.nproc} CUDA cards", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import tempfile

    from tmar_torch import kernels

    card = card_line()
    t0 = time.perf_counter()
    kernels.build()  # once here: every rank then loads the same libraries
    print(f"[build] every kernel in {time.perf_counter() - t0:.1f} s")
    failures = []

    def check(cond, what):
        print(f"[check] multicard {what}: {'ok' if cond else 'FAIL'}", flush=True)
        if not cond:
            failures.append(what)

    with tempfile.TemporaryDirectory(prefix="tmar_multicard_") as run_dir:
        runs = {}
        for name in ("one", "dp", "fsdp", "tp"):
            r = runs[name] = launch(args.nproc, run_dir, name)
            where = ("one process on cuda:0" if name == "one" else
                     f"{args.nproc} ranks, one a card, NCCL, mesh (data, model) "
                     + str((args.nproc // 2, 2) if name == "tp" else (args.nproc, 1)))
            print(f"[multicard] {name}: {where}: exit {r['rc']} in {r['s']:.1f} s (start, build, "
                  f"one f32 step of {args.nproc} rows, validation, checkpoint) on {card}", flush=True)
            check(r["rc"] == 0, f"{name}: tmar_torch.cli train ran")
        if failures:
            for name, r in runs.items():
                if r["rc"]:
                    with open(r["log"]) as f:
                        print(f"[log] {name}:\n" + f.read()[-6000:])
            raise SystemExit(f"multicard runs failed: {failures}")

        ref = checkpoint(run_dir, "one")
        ref_psnr = json.loads(runs["one"]["last"])["best_psnr"]
        lrs = {"generator": 1.0e-4, "g_ema": 1.0e-4, "discriminator": 2.0e-4}  # the recipe's
        for name in ("dp", "fsdp", "tp"):
            got = checkpoint(run_dir, name)
            check(got["step"] == ref["step"] == 1, f"{name}: one step (step {got['step']})")
            for part, lr in lrs.items():
                keys = [k for k, v in ref[part].items() if v.is_floating_point()]
                diffs = [(got[part][k] - ref[part][k]).abs() for k in keys]
                top = max(float(d.max()) for d in diffs)
                mean = sum(float(d.sum()) for d in diffs) / sum(d.numel() for d in diffs)
                check(top <= 2.1 * lr and mean <= 0.01 * lr,
                      f"{name} vs one process, {part} after the step: max|diff| {top:.3e} "
                      f"(tol 2.1 lr = {2.1 * lr:.1e}), mean {mean:.3e} (tol 0.01 lr = {0.01 * lr:.1e})")
            psnr = json.loads(runs[name]["last"])["best_psnr"]
            check(abs(psnr - ref_psnr) <= 1e-4 * abs(ref_psnr),
                  f"{name}: validation PSNR {psnr:.6f} dB, one process {ref_psnr:.6f} (rtol 1e-4)")
    if failures:
        raise SystemExit(f"multicard checks failed: {failures}")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
