"""Trainer: the loop around the GAN train step (the counterpart of
``tmar.train.trainer``): run-dir layout (checkpoints / samples / logs / tb),
per-epoch checkpointing with retention, periodic validation with
best-model-by-PSNR tracking, CSV / JSON metric history, resume from a
checkpoint, and TTUR dual-Adam optimisation, all driven by a ``TrainConfig``
(variants and ablations are LossWeights / DiscConfig overrides).

``Trainer(cfg)`` runs on the card and raises without one;
``Trainer(cfg, device="cpu")`` runs the plain versions.  It builds every
generator (NGswin and the baselines), discriminator (multi-scale PatchGAN
and the DCGAN critic) and dataset (synthetic, synthetic_cache, syndeeplesion,
spineweb, each with its validation split) of the JAX trainer.

``parallel.mode`` lays the state over a mesh of processes, one per device
(``tmar_torch.core.mesh``; launch with ``python -m torch.distributed.run
--nproc-per-node N -m tmar_torch.cli train ...``): ``dp`` replicates both
networks and averages their gradients, ``fsdp`` shards both with FSDP2 by
``fsdp_spec``, ``tp`` Megatron-splits the generator's window attention and
FFN over ``parallel.model_parallel`` ranks by ``tp_spec``.  Under ``tp`` the
NGswin runs the JAX package's plain form (``use_pallas_attention: false``)
as torch ops, on the card too, as the JAX package runs no Pallas kernel
there.  Each rank loads its rows of every batch; validation gathers every
rank's rows, so its numbers are those of one process; rank 0 alone writes
logs, samples and checkpoints.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from tmar_torch.checkpoint.io import CheckpointManager
from tmar_torch.core.mesh import (
    all_gather_rows,
    apply_fsdp,
    apply_tensor_parallel,
    create_mesh,
    full_tensor,
    gan_state_shardings,
    is_main_process,
    replicate,
)
from tmar_torch.data import (
    Loader,
    ShardCachedDataset,
    SpineWebDataset,
    SynDeepLesionTrainDataset,
    SynDeepLesionValDataset,
    SyntheticMARDataset,
    build_shard_cache,
)
from tmar_torch.device import resolve_device
from tmar_torch.nn import MultiScaleDiscriminator, NGswin
from tmar_torch.nn.baselines import BAFResNet, DCGANCritic, DenoisingTransformer, RedCNN
from tmar_torch.ops.radon import Radon
from tmar_torch.train.config import TrainConfig
from tmar_torch.train.schedules import build_optimizer, build_schedule
from tmar_torch.train.steps import (
    GANTrainState,
    draw_parameters,
    make_eval_step,
    make_train_step,
    new_ema,
)
from tmar_torch.utils.tfevents import TBWriter


def build_generator(
    cfg: TrainConfig, device="cuda", *, ngram_fused: bool = True, nstb_fused: bool = True,
    nstb_map: bool = True, form: Optional[str] = None,
):
    """The generator of ``cfg.model``: the NGswin, or with ``model.arch`` one
    of the baselines (``redcnn``, ``transformer``, ``bafresnet``; the
    transformer's position embedding sized for ``data.patch_size``).  For the
    NGswin, ``use_pallas_attention`` with ``attn_backward="pallas"`` gives
    the training form (kernels with backward kernels), with ``"xla"`` the
    form whose attention backward is the plain recompute; anything else the
    ``"auto"`` form, which trains on the training form's kernels and serves
    in the block form the keywords pick (``tmar_torch.nn.blocks``; they stand
    in for the JAX package's ``TMAR_NSTB_FUSED`` and ``TMAR_NSTB_MAP``).  ``ngram_fused`` (the JAX
    package's ``TMAR_NGRAM_FUSED``) holds in both forms.  ``form`` overrides
    the NGswin's form (``"plain"``: the JAX package's plain attention path
    as torch ops, which tensor parallelism trains)."""
    m = cfg.model
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    arch = getattr(m, "arch", "ngswin")
    if arch != "ngswin":
        archs = {
            "redcnn": lambda: RedCNN(in_chans=m.in_chans, dtype=dtype, device=device),
            "transformer": lambda: DenoisingTransformer(in_chans=m.in_chans, img_size=cfg.data.patch_size,
                                                        dtype=dtype, device=device),
            "bafresnet": lambda: BAFResNet(in_chans=m.in_chans, dtype=dtype, device=device),
        }
        if arch not in archs:
            raise ValueError(f"unknown generator arch {arch!r}")
        return archs[arch]()
    form = form or (m.attn_backward if m.use_pallas_attention else "auto")
    return NGswin(
        ngrams=tuple(m.ngrams),
        in_chans=m.in_chans,
        embed_dim=m.embed_dim,
        depths=tuple(m.depths),
        num_heads=tuple(m.num_heads),
        dec_dim=m.dec_dim,
        dec_depths=m.dec_depths,
        dec_num_heads=m.dec_num_heads,
        window_size=m.window_size,
        mlp_ratio=m.mlp_ratio,
        qkv_bias=m.qkv_bias,
        dtype=dtype,
        attn_backward=form,
        ngram_fused=ngram_fused,
        nstb_fused=nstb_fused,
        nstb_map=nstb_map,
        device=device,
    )


def build_discriminator(cfg: TrainConfig, device="cuda"):
    """The multi-scale PatchGAN, or with ``disc.kind: dcgan`` the DCGAN
    critic (``ndf = disc.base_channels``) of the ``baseline`` and ``v1``
    variants; either takes the (input ‖ image) pair."""
    d = cfg.disc
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    if d.kind == "multiscale":
        return MultiScaleDiscriminator(
            in_chans=2 * cfg.model.in_chans,
            base_channels=d.base_channels,
            num_layers=d.num_layers,
            num_scales=d.num_scales,
            use_sn=d.use_sn,
            dtype=dtype,
            device=device,
        )
    if d.kind == "dcgan":
        return DCGANCritic(ndf=d.base_channels, in_chans=2 * cfg.model.in_chans, dtype=dtype,
                           device=device)
    raise ValueError(f"unknown discriminator kind {d.kind!r}")


def build_optimizers(cfg: TrainConfig, generator, discriminator):
    """The TTUR pair (generator's, discriminator's ``ScheduledAdam``) of
    ``cfg.optim``, scheduled over the run's steps."""
    o = cfg.optim
    total_steps = max(1, cfg.num_epochs * (cfg.data.samples_per_epoch // cfg.data.batch_size))
    g_opt = build_optimizer(
        generator.named_parameters(), o.lr_g, o.beta1, o.beta2,
        schedule=build_schedule(o, o.lr_g, total_steps), grad_clip=o.grad_clip,
        llrd={"decay": o.llrd_decay} if o.llrd_decay else None, fused=o.fused_update,
    )
    d_opt = build_optimizer(
        discriminator.named_parameters(), o.lr_d, o.beta1, o.beta2,
        schedule=build_schedule(o, o.lr_d, total_steps), grad_clip=o.grad_clip,
        fused=o.fused_update,
    )
    return g_opt, d_opt


def build_dataset(cfg: TrainConfig):
    """The training set of ``cfg.data.dataset``, branch for branch the JAX
    trainer's."""
    d = cfg.data
    if d.dataset == "synthetic":
        return SyntheticMARDataset(size=d.patch_size, length=d.samples_per_epoch, base_seed=d.seed)
    if d.dataset == "synthetic_cache":
        # full 416² synthetic slices written once into a shard cache, then
        # mmap reads with a random crop and flip at read time.  The default
        # directory is named apart from the JAX package's, so that two
        # processes never write one directory at once (the bytes are the same)
        cache_dir = d.cache_dir or os.path.join(
            tempfile.gettempdir(), f"tmar_torch_synth_cache_{d.cache_slices}_{d.seed}"
        )
        if not os.path.isfile(os.path.join(cache_dir, "index.json")):
            build_shard_cache(
                SyntheticMARDataset(size=416, length=d.cache_slices, base_seed=d.seed),
                cache_dir, shard_size=64,
            )
        return ShardCachedDataset(
            cache_dir, patch_size=d.patch_size, augment=True, seed=d.seed,
            length=d.samples_per_epoch,
        )
    if d.dataset == "syndeeplesion":
        return SynDeepLesionTrainDataset(
            d.root, patch_size=d.patch_size, length=d.samples_per_epoch, seed=d.seed
        )
    if d.dataset == "spineweb":
        return SpineWebDataset(
            d.spineweb_artifact, d.spineweb_clean, patch_size=d.patch_size, train=True,
            seed=d.seed, length=d.samples_per_epoch,
        )
    raise ValueError(f"unknown dataset {d.dataset!r}")


def build_val_dataset(cfg: TrainConfig):
    """The validation split of ``cfg.data.dataset``: for the synthetic sets a
    held-out seeded synthetic set (the offset of the base seed keeps it apart
    from the training samples), for SynDeepLesion the last 10 % of the train
    tree at full slices, for SpineWeb the full test slices."""
    d = cfg.data
    if d.dataset in ("synthetic", "synthetic_cache"):
        return SyntheticMARDataset(
            size=d.patch_size, length=min(32, d.samples_per_epoch), base_seed=d.seed + 10_000
        )
    if d.dataset == "syndeeplesion":
        return SynDeepLesionValDataset(d.root)
    if d.dataset == "spineweb":
        return SpineWebDataset(d.spineweb_artifact, d.spineweb_clean, train=False)
    raise ValueError(f"unknown dataset {d.dataset!r}")


class Trainer:
    def __init__(self, cfg: TrainConfig, device="cuda", val_dataset=None, ngram_fused=True,
                 mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        par = cfg.parallel
        mode = par.mode
        if mode not in ("dp", "tp", "fsdp"):
            raise ValueError(f"unknown parallel.mode {mode!r} (dp | tp | fsdp)")
        if mode == "tp" and cfg.model.use_pallas_attention:
            raise ValueError(
                "parallel.mode=tp requires the plain attention path (set "
                "model.use_pallas_attention=false): tensor parallelism Megatron-splits the "
                "qkv/proj weights across heads, and the CUDA kernels are written against the "
                "full head set.  FSDP composes with the kernels: parameters are sharded at "
                "rest and gathered at use, so the kernels see whole tensors."
            )
        if mode == "tp" and par.model_parallel < 2:
            raise ValueError("parallel.mode=tp needs parallel.model_parallel >= 2")
        self.parallel_mode = mode
        if mesh is None and (dist.is_initialized() or mode != "dp" or (cfg.n_devices or 1) > 1):
            mesh = create_mesh(cfg.n_devices, model_parallel=par.model_parallel if mode == "tp"
                               else 1, device=self.device)
        self.mesh = mesh
        self.ngram_fused = ngram_fused
        self.generator = build_generator(cfg, self.device, ngram_fused=ngram_fused,
                                         form="plain" if mode == "tp" else None)
        self.discriminator = build_discriminator(cfg, self.device)
        draw_parameters(torch.Generator().manual_seed(cfg.seed), self.generator,
                        self.discriminator)
        if mesh is not None:
            replicate(mesh, self.generator)
            replicate(mesh, self.discriminator)
            if mode == "fsdp":
                units = getattr(self.generator, "fsdp_units", lambda: [])()
                apply_fsdp(self.generator, mesh, units)
                apply_fsdp(self.discriminator, mesh)
            elif mode == "tp":
                apply_tensor_parallel(self.generator, mesh)

        o = cfg.optim
        self.g_opt, self.d_opt = build_optimizers(cfg, self.generator, self.discriminator)

        projector = None
        if cfg.radon.enabled and cfg.loss.phys:
            projector = Radon(
                cfg.data.patch_size,
                np.linspace(0, np.pi, cfg.radon.num_angles, endpoint=False),
                precision=cfg.radon.precision, device=self.device,
            )
        self.projector = projector

        ema_decay = getattr(o, "ema_decay", 0.0)
        self.state = GANTrainState(0, self.generator, self.g_opt, self.discriminator, self.d_opt,
                                   new_ema(self.generator) if ema_decay else None)
        self.state_shardings = None if mode == "dp" else gan_state_shardings(
            mesh, self.state, tensor_parallel=mode == "tp", fsdp=mode == "fsdp")
        self.train_step = make_train_step(
            self.generator, self.discriminator, self.g_opt, self.d_opt, cfg.loss,
            projector=projector, fused_pairs=cfg.disc.fused_pairs, ema_decay=ema_decay,
            device=self.device, mesh=mesh, state_shardings=self.state_shardings,
        )
        self.eval_step = make_eval_step(self.generator, device=self.device, mesh=mesh)
        self._replica = None  # the whole generator validation runs under fsdp / tp

        run_name = cfg.run_name or time.strftime("run_%Y%m%d_%H%M%S")
        self.run_dir = os.path.join(cfg.run_dir, run_name)
        for sub in ("checkpoints", "samples", "logs"):
            os.makedirs(os.path.join(self.run_dir, sub), exist_ok=True)
        self.ckpt = CheckpointManager(
            os.path.join(self.run_dir, "checkpoints"), keep_last_n=cfg.keep_last_n
        )
        self.history: list = []
        self.val_history: list = []
        self.best_psnr = -np.inf
        self.start_epoch = 0
        self.val_dataset = val_dataset
        self.main = is_main_process()  # the rank that writes files
        self.tb = None
        if self.main:
            self.tb = TBWriter(os.path.join(self.run_dir, "tb"))
            with open(os.path.join(self.run_dir, "config.json"), "w") as f:
                json.dump(cfg.to_dict(), f, indent=2, default=str)

    # ------------------------------------------------------------------ io
    def resume(self, step: Optional[int] = None) -> bool:
        """Restore the latest (or a specific) checkpoint; returns success."""
        restored = self.ckpt.restore(self.state, step=step)
        if restored is None:
            return False
        self.state, meta = restored
        self.start_epoch = int(meta.get("epoch", 0))
        self.best_psnr = float(meta.get("best_psnr", -np.inf))
        return True

    # ----------------------------------------------------------------- loop
    def fit(self, num_epochs: Optional[int] = None, progress: bool = True):
        cfg = self.cfg
        epochs = num_epochs or cfg.num_epochs
        loader = Loader(
            build_dataset(cfg),
            batch_size=cfg.data.batch_size,
            num_workers=cfg.data.num_workers,
            seed=cfg.data.seed,
            device=self.device,
            mesh=self.mesh,
        )
        for epoch in range(self.start_epoch, epochs):
            t0 = time.time()
            # the metrics are summed ON THE DEVICE (one stack and one add per
            # step): reading them back every step would stall the stream and
            # serialise the host's data preparation with the device's work
            names, epoch_acc = None, None
            n = 0
            for i, batch in enumerate(loader):
                self.state, metrics = self.train_step(self.state, batch)
                n += 1
                names = list(metrics)
                row = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                                   device=self.device) for k in names])
                epoch_acc = row if epoch_acc is None else epoch_acc + row
                if (i + 1) % cfg.log_every == 0 or i == 0:
                    host = dict(zip(names, row.tolist()))
                    step_no = int(self.state.step)
                    if self.main:
                        self.tb.scalars({f"Train/{k}": v for k, v in host.items()}, step_no)
                    host.update(epoch=epoch, iter=i, step=step_no)
                    self.history.append(host)
                    if progress and self.main:
                        msg = " ".join(f"{k}={v:.4f}" for k, v in host.items()
                                       if k.startswith("loss"))
                        print(f"[epoch {epoch+1}/{epochs} it {i+1}] {msg}", flush=True)
            epoch_metrics = dict(zip(names, epoch_acc.tolist())) if n else {}
            wall = time.time() - t0
            epoch_summary = {k: v / max(n, 1) for k, v in epoch_metrics.items()}
            epoch_summary.update(epoch=epoch, wall_s=wall, steps_per_s=n / wall)

            if (epoch + 1) % cfg.val_every_n_epochs == 0 and self.val_dataset is not None:
                val = self.validate()
                if self.main:
                    self.tb.scalars({f"Val/{k}": v for k, v in val.items()}, int(self.state.step))
                epoch_summary.update({f"val_{k}": v for k, v in val.items()})
                if val["psnr"] > self.best_psnr:
                    self.best_psnr = val["psnr"]
                    self.ckpt.save(
                        self.state,
                        step=int(self.state.step),
                        meta={"epoch": epoch + 1, "best_psnr": self.best_psnr},
                        best=True,
                    )
            self.val_history.append(epoch_summary)

            if (epoch + 1) % cfg.checkpoint_every_n_epochs == 0:
                self.ckpt.save(
                    self.state,
                    step=int(self.state.step),
                    meta={"epoch": epoch + 1, "best_psnr": self.best_psnr},
                )
            self._write_logs()
        return self.state

    def validate(
        self,
        max_batches: int = 16,
        save_samples: bool = True,
        full_metrics: bool = True,
    ) -> Dict[str, float]:
        """Validation with the full metric families.

        The device computes MSE / PSNR; with ``full_metrics`` the host adds
        SSIM / MAE / RMSE and the regional metal / band / non-metal and
        HU-domain families.  The result is the mean over batches of each
        batch's mean.  Under a mesh each rank evaluates its rows and every
        rank gathers the whole batch, so the numbers are one process's."""
        # pad_last: a val split smaller than one batch must still validate;
        # cyclic padding keeps every batch at one shape
        loader = Loader(
            self.val_dataset,
            batch_size=self.cfg.data.batch_size,
            shuffle=False,
            num_workers=self.cfg.data.num_workers,
            device=self.device,
            drop_last=False,
            pad_last=True,
            mesh=self.mesh,
        )
        psnrs, mses = [], []
        extra: Dict[str, list] = {}
        # validate with the EMA weights when tracked; the generator's own
        # otherwise
        eval_step, g_eval = self._validation_model()
        for i, batch in enumerate(loader):
            if i >= max_batches:
                break
            fake, m = eval_step(batch, params=g_eval)
            batch = {k: all_gather_rows(self.mesh, v) for k, v in batch.items()}
            vm = batch.pop("valid", None)
            B = batch["ct"].shape[0]
            n_valid = int(vm.sum()) if vm is not None else B
            fk4 = fake.float().cpu().numpy()
            gt4 = batch["gt"].cpu().numpy()
            if B % max(n_valid, 1) == 0:
                # full batch, or cyclic padding with an exact mean (each
                # distinct sample appears B / n_valid times)
                psnrs.append(float(m["psnr"]))
                mses.append(float(m["mse"]))
            else:
                per_mse = np.mean((fk4[:n_valid] - gt4[:n_valid]) ** 2, axis=(1, 2, 3))
                mses.append(float(per_mse.mean()))
                psnrs.append(
                    float(np.mean(10.0 * np.log10(4.0 / np.maximum(per_mse, 1e-12))))
                )
            if full_metrics:
                from tmar_torch.eval import metrics as M

                fk, gt = fk4[..., 0], gt4[..., 0]
                ct = batch["ct"].cpu().numpy()[..., 0]
                for b in range(min(fk.shape[0], n_valid)):
                    p01 = np.clip((fk[b] + 1) / 2, 0, 1)
                    g01 = np.clip((gt[b] + 1) / 2, 0, 1)
                    row = {
                        "ssim": M.ssim(p01, g01),
                        "mae": M.mae(p01, g01),
                        "rmse": M.rmse(p01, g01),
                    }
                    row.update(M.compute_regional_metrics(fk[b], gt[b], ct[b]))
                    hu = M.compute_hu_accuracy(p01, g01)
                    row.update({k: v for k, v in hu.items() if k.endswith("MAE") or k.endswith("RMSE")})
                    row.update(M.hu_tolerance_rates(p01, g01))
                    for k, v in row.items():
                        extra.setdefault(k, []).append(float(v))
            if i == 0 and save_samples and self.main:
                self._save_sample_grid(batch, fk4)
        out = {"psnr": float(np.mean(psnrs)), "mse": float(np.mean(mses))}
        out.update({k: float(np.mean(v)) for k, v in extra.items()})
        return out

    def _validation_model(self):
        """(eval step, stand-in parameters) of validation.  Under dp the
        generator itself with the EMA standing in; under fsdp and tp a whole
        replica of the generator in its form, loaded with the gathered EMA
        (or parameters)."""
        if self.parallel_mode == "dp":
            return self.eval_step, self.state.g_ema
        src = self.state.g_ema or {k: p.detach() for k, p in self.generator.named_parameters()}
        whole = {k: full_tensor(self.generator, k, v) for k, v in src.items()}
        if self._replica is None:
            self._replica = build_generator(self.cfg, self.device, ngram_fused=self.ngram_fused,
                                            form=self.generator.attn_backward
                                            if hasattr(self.generator, "attn_backward") else None)
            self._replica_step = make_eval_step(self._replica, device=self.device, mesh=self.mesh)
        with torch.no_grad():
            for k, p in self._replica.named_parameters():
                p.copy_(whole[k])
        return self._replica_step, None

    def _save_sample_grid(self, batch, fake: np.ndarray, max_rows: int = 4):
        """Input / restored / target triplet grid."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        ct = batch["ct"].cpu().numpy()[..., 0]
        gt = batch["gt"].cpu().numpy()[..., 0]
        fk = fake[..., 0]
        n = min(max_rows, ct.shape[0])
        fig, axes = plt.subplots(n, 3, figsize=(9, 3 * n), squeeze=False)
        for r in range(n):
            for c, (img, title) in enumerate(
                ((ct[r], "input"), (fk[r], "restored"), (gt[r], "target"))
            ):
                axes[r][c].imshow((img + 1) / 2, cmap="gray", vmin=0, vmax=1)
                if r == 0:
                    axes[r][c].set_title(title)
                axes[r][c].axis("off")
        fig.tight_layout()
        fig.savefig(
            os.path.join(self.run_dir, "samples", f"step_{int(self.state.step):08d}.png"),
            dpi=110,
        )
        plt.close(fig)

    def _write_logs(self):
        import csv

        if not self.main:
            return
        self.tb.flush()
        logs = os.path.join(self.run_dir, "logs")
        for name, rows in (("training_history.csv", self.history),
                           ("validation_history.csv", self.val_history)):
            if rows:
                with open(os.path.join(logs, name), "w", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=sorted({k for h in rows for k in h}))
                    w.writeheader()
                    w.writerows(rows)
        with open(os.path.join(logs, "summary.json"), "w") as f:
            json.dump(
                {
                    "best_psnr": self.best_psnr,
                    "epochs": len(self.val_history),
                    "last": self.val_history[-1] if self.val_history else None,
                },
                f,
                indent=2,
            )
