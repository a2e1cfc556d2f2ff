"""What each rank of ``tests/test_torch_port_parallel.py`` runs.

A spawned rank imports this module, which imports numpy, torch and
tmar_torch only: the test files import JAX, and ``conftest.py`` sets up
eight virtual XLA devices.  Each rank writes what the test compares to
``<out>/<name>_rank<r>.pt``.  The module holds no test of its own; the
functions of its last section are the ranks of the GPU tests in
``tests/test_torch_port_gpu.py``.
"""

import os

import numpy as np
import torch

from tmar_torch.core.mesh import DATA_AXIS, create_mesh, full_tensor, local
from tmar_torch.data import Loader, SyntheticMARDataset
from tmar_torch.nn import NGswin
from tmar_torch.nn.baselines import RedCNN
from tmar_torch.parallel import sharded_tiled_eval
from tmar_torch.train import Trainer, load_config
from tmar_torch.train.finetune import FinetuneWeights, finetune
from tmar_torch.train.trainer import build_val_dataset

# tests/test_parallel_config.py's TINY_SETS, two steps of batch 4, and a clip
# low enough to act, so that the sharded norm decides the update
TINY_SETS = {
    "model.embed_dim": 32,
    "model.depths": [1, 1, 1],
    "model.num_heads": [2, 2, 2],
    "model.dec_dim": 32,
    "model.dec_depths": 1,
    "model.dec_num_heads": 2,
    "data.dataset": "synthetic",
    "data.patch_size": 64,
    "data.batch_size": 4,
    "data.samples_per_epoch": 8,
    "data.num_workers": 0,
    "radon.num_angles": 12,
    "loss.dilation_radius": 2,
    "disc.base_channels": 16,
    "disc.num_scales": 2,
    "num_epochs": 1,
    "checkpoint_every_n_epochs": 1,
    "bf16": False,
    "log_every": 100,
    "optim.grad_clip": 1.0,
    "optim.ema_decay": 0.999,
}
# the training form for dp and fsdp; tp takes the plain form, as in JAX
MODES = {
    "dp": {"model.use_pallas_attention": True, "model.attn_backward": "pallas"},
    "fsdp": {"parallel.mode": "fsdp", "model.use_pallas_attention": True,
             "model.attn_backward": "pallas"},
    "tp": {"parallel.mode": "tp", "parallel.model_parallel": 2},
}
QKV = "encoder_layer1.blocks.0.attn.qkv.weight"
TILED = dict(embed_dim=32, depths=(1, 1, 1), num_heads=(2, 2, 2), dec_dim=32, dec_depths=1,
             dec_num_heads=2)


def config(out, mode, run_name=None, **extra):
    sets = dict(TINY_SETS, **MODES[mode], **extra)
    sets.update(run_dir=os.path.join(out, "runs"), run_name=run_name or mode)
    return load_config(None, sets)


class Pairs:
    """A fine-tune dataset whose sample i depends on i alone."""

    def __init__(self, n=8, size=32):
        self.n, self.size = n, size

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(100 + i)
        gt = rng.uniform(0, 1, (self.size, self.size)).astype(np.float32)
        mask = (rng.uniform(size=(self.size, self.size)) > 0.9).astype(np.float32)
        return {"Xma": np.clip(gt + 0.3 * mask, 0, 1), "Xgt": gt, "mask": mask}


def whole(module, tensors):
    """Every tensor of ``tensors`` ({name: tensor}) whole, on the CPU."""
    return {k: full_tensor(module, k, v.detach()).cpu() for k, v in tensors.items()}


def summary(trainer):
    """What the test holds of a fitted trainer: the whole parameters, EMA and
    first moments, the global norm of the last G gradients, validation."""
    g = trainer.generator
    d = trainer.discriminator
    moments = {n: trainer.g_opt.state[p]["exp_avg"] for n, p in g.named_parameters()}
    d_moments = {n: trainer.d_opt.state[p]["exp_avg"] for n, p in d.named_parameters()}
    return {
        "g": whole(g, dict(g.named_parameters())),
        "ema": whole(g, trainer.state.g_ema),
        "mu": whole(g, moments),
        "d": whole(d, dict(d.named_parameters())),
        "d_mu": whole(d, d_moments),
        "norm": float(trainer.g_opt.grad_norm),
        "val": trainer.validate(max_batches=1, save_samples=False, full_metrics=False),
        "qkv_rows": local(dict(g.named_parameters())[QKV]).shape[0],
        "step": trainer.state.step,
    }


def run_all(rank, world, out):
    """Every check of the spawn: the three modes through ``Trainer.fit`` and
    their resumes, the sharded tiled eval, the fine-tune mesh and the
    loader's rows."""
    results = {}
    for mode in MODES:
        cfg = config(out, mode)
        trainer = Trainer(cfg, device="cpu", val_dataset=build_val_dataset(cfg))
        trainer.fit(progress=False)
        results[mode] = summary(trainer)
        again = Trainer(cfg, device="cpu")
        assert again.resume()
        g = again.generator
        results[mode]["resumed"] = whole(g, dict(g.named_parameters()))
        results[mode]["resumed_ema"] = whole(g, again.state.g_ema)
        results[mode]["resumed_qkv_rows"] = local(dict(g.named_parameters())[QKV]).shape[0]

    mesh = create_mesh(world, device="cpu")
    torch.manual_seed(0)
    model = NGswin(**TILED, device="cpu")
    ct = np.random.default_rng(0).uniform(-1, 1, (1, 96, 96, 1)).astype(np.float32)
    results["tiled"] = {"out": sharded_tiled_eval(model, mesh, ct), "ct": ct,
                        "weights": model.state_dict()}

    ft = finetune(RedCNN(8, device="cpu"), Pairs(), batch_size=4, num_epochs=1,
                  weights=FinetuneWeights(sino=0.0), mesh=mesh, device="cpu")
    results["finetune"] = {"history": ft["history"],
                           "params": {k: v.detach().clone() for k, v in
                                      ft["state"].model.named_parameters()}}

    ds = SyntheticMARDataset(size=32, length=10, base_seed=3)
    results["loader"] = {
        "train": [b["ct"] for b in Loader(ds, batch_size=4, seed=5, num_workers=2, mesh=mesh)],
        "val": [(b["gt"], b["valid"]) for b in Loader(ds, batch_size=4, shuffle=False,
                                                      drop_last=False, pad_last=True,
                                                      num_workers=2, mesh=mesh)],
        "data_rank": mesh.get_local_rank(DATA_AXIS),
    }
    torch.save(results, os.path.join(out, f"results_rank{rank}.pt"))


# ---- on the card (tests/test_torch_port_gpu.py) ---------------------------------
def kernel_launches():
    """The training kernels' launch counters, K1, K7, K3-K6, read now."""
    from tmar_torch.ops import cuda_attention, cuda_ffn, cuda_ngram

    f = (cuda_ngram.fused_ngram_context, cuda_attention.fused_window_attention,
         cuda_ffn.fused_residual_ffn)
    return [getattr(k, a) for k in f for a in ("launches", "backward_launches")]


def card_config(out, run_name, batch, **extra):
    """The promoted recipe at full width, f32, on synthetic data."""
    from tmar_torch.train import config_path, resolve_variant

    sets = {"data.dataset": "synthetic", "data.batch_size": batch, "bf16": False,
            "optim.ema_decay": 0.999, "run_dir": os.path.join(out, "runs"),
            "run_name": run_name, **extra}
    cfg = load_config(config_path("train_syndeeplesion.yaml"), sets)
    return resolve_variant(cfg, cfg.variant)


def card_batch(n, size=128):
    ds = SyntheticMARDataset(size=size, length=n, base_seed=7)
    return {k: torch.from_numpy(np.stack([ds[i][k] for i in range(n)])[..., None]).cuda()
            for k in ("ct", "gt")}


def card_dp_step(rank, world, out):
    """One f32 ``full`` step at full width on the card, one row a rank."""
    from tmar_torch.core.mesh import shard_batch

    torch.backends.cudnn.allow_tf32 = False  # as the one process runs (the test's fixture)
    trainer = Trainer(card_config(out, "dp", 2))
    before = kernel_launches()
    _, m = trainer.train_step(trainer.state, shard_batch(trainer.mesh, card_batch(2)))
    torch.cuda.synchronize()
    g = trainer.generator
    torch.save({"metrics": {k: float(v) for k, v in m.items()},
                "grads": {k: p.grad.cpu() for k, p in g.named_parameters()},
                "launches": [a - b for a, b in zip(kernel_launches(), before)]},
               os.path.join(out, f"dp_rank{rank}.pt"))


def card_fsdp_views(rank, world, out):
    """The demo-width NGswin in its training form under FSDP2 on the card:
    a forward and a backward of this rank's 2 rows, its kernels reading the
    gathered parameter views; the whole gradients and outputs saved."""
    from tmar_torch.core.mesh import apply_fsdp, average_gradients, replicate, shard_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    model = NGswin(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 2, 2), dec_dim=32, dec_depths=2,
                   dec_num_heads=2, attn_backward="pallas")
    mesh = create_mesh(world)
    replicate(mesh, model)
    apply_fsdp(model, mesh, model.fsdp_units())
    x = shard_batch(mesh, card_batch(4, 64)["ct"])
    before = kernel_launches()
    y = model(x)
    y.square().mean().backward()
    average_gradients(mesh, model.parameters())
    torch.cuda.synchronize()
    torch.save({"y": y.detach().cpu(), "launches": [a - b for a, b in zip(kernel_launches(), before)],
                "grads": whole(model, {k: p.grad for k, p in model.named_parameters()})},
               os.path.join(out, f"fsdp_rank{rank}.pt"))
