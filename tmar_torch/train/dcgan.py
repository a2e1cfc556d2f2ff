"""DCGAN z -> image tutorial training loop (the counterpart of
``tmar.train.dcgan``).

One step updates D, then G against the updated D:
  D: BCE(D(x_real), 1) + BCE(D(G(z)), 0)
  G: BCE(D(G(z)), 1)                          (non-saturating)
with ONE generator forward in training mode, whose batch statistics move
the BatchNorm running averages once per step: its detached value feeds the
D update, its graph the G update (dL/dfake from a detached leaf, as in
``tmar_torch.train.steps``).  The BCE takes the critic's output as logits,
clipped at ±30; with ``DCGANDiscriminator``, whose output is a sigmoid, that
is the sigmoid's value, exactly as the JAX loop computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tmar_torch.device import resolve_device
from tmar_torch.nn.baselines import DCGANDiscriminator, DCGANGenerator


@dataclasses.dataclass
class DCGANState:
    """The modules hold the parameters and the generator's BatchNorm
    statistics, the optimizers their moments."""

    generator: nn.Module
    discriminator: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    step: int = 0


def _bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    z = logits.float().clamp(-30.0, 30.0)
    return F.softplus(-z).mean() if target == 1.0 else F.softplus(z).mean()


def _d_logits(disc: nn.Module, x: torch.Tensor) -> torch.Tensor:
    out = disc(x)
    return out[0][0] if isinstance(out, tuple) else out


@torch.no_grad()
def create_dcgan_state(
    rng: torch.Generator,
    gen: DCGANGenerator,
    disc: nn.Module,
    g_opt: torch.optim.Optimizer,
    d_opt: torch.optim.Optimizer,
) -> DCGANState:
    """Draw both networks' parameters anew from ``rng`` (the JAX module's
    initialisers; BatchNorm statistics reset) and wrap them with their
    optimizers."""
    gen.draw_parameters(rng)
    disc.draw_parameters(rng)
    return DCGANState(gen, disc, g_opt, d_opt)


def make_dcgan_step(
    gen: DCGANGenerator,
    disc: nn.Module,
    g_opt: torch.optim.Optimizer,
    d_opt: torch.optim.Optimizer,
    device="cuda",
) -> Callable:
    """``step(state, real, z) -> (state, {"loss_d", "loss_g"})``: ``real``
    [B, H, W, nc] in [-1, 1], ``z`` [B, 1, 1, nz]; the state is updated in
    place and returned, the losses are float32 scalars on the device."""
    dev = resolve_device(device)
    gen.to(dev)
    disc.to(dev)

    def step(state: DCGANState, real, z):
        real = torch.as_tensor(real, dtype=torch.float32, device=dev)
        z = torch.as_tensor(z, dtype=torch.float32, device=dev)
        fake = gen(z, train=True)

        loss_d = _bce_logits(_d_logits(disc, real), 1.0) + _bce_logits(_d_logits(disc, fake.detach()), 0.0)
        d_opt.zero_grad(set_to_none=True)
        loss_d.backward()
        d_opt.step()

        fake_leaf = fake.detach().requires_grad_(True)
        loss_g = _bce_logits(_d_logits(disc, fake_leaf), 1.0)
        (dfake,) = torch.autograd.grad(loss_g, fake_leaf)
        g_opt.zero_grad(set_to_none=True)
        fake.backward(dfake)
        g_opt.step()
        state.step += 1
        return state, {"loss_d": loss_d.detach(), "loss_g": loss_g.detach()}

    return step


def train_dcgan(
    data: Iterable[np.ndarray],
    steps: int = 200,
    nz: int = 100,
    image_size: int = 64,
    nc: int = 1,
    lr: float = 2e-4,
    seed: int = 0,
    sample_every: Optional[int] = None,
    device="cuda",
) -> Tuple[DCGANState, Dict[str, list]]:
    """Tutorial loop: iterate ``data`` (batches [B, H, W, nc] in [-1, 1],
    ``image_size`` = 64 as the generator's), one D and one G update per batch
    with fresh z ~ N(0, 1) from a ``torch.Generator`` seeded by ``seed``.
    Returns the final state and the loss history (with sample batches of 8
    every ``sample_every`` steps)."""
    if image_size != 64:
        raise ValueError(f"the DCGAN generator makes 64² images, not {image_size}²")
    dev = resolve_device(device)
    gen = DCGANGenerator(nz=nz, nc=nc, device=dev)
    disc = DCGANDiscriminator(in_chans=nc, device=dev)
    g_opt = torch.optim.Adam(gen.parameters(), lr, betas=(0.5, 0.999), eps=1e-8)
    d_opt = torch.optim.Adam(disc.parameters(), lr, betas=(0.5, 0.999), eps=1e-8)
    rng = torch.Generator().manual_seed(seed)
    state = create_dcgan_state(rng, gen, disc, g_opt, d_opt)
    step = make_dcgan_step(gen, disc, g_opt, d_opt, device=dev)

    hist: Dict[str, list] = {"loss_d": [], "loss_g": [], "samples": []}
    it = iter(data)
    for i in range(steps):
        try:
            real = next(it)
        except StopIteration:
            it = iter(data)
            real = next(it)
        z = torch.randn((real.shape[0], 1, 1, nz), generator=rng).to(dev)
        state, metrics = step(state, real, z)
        hist["loss_d"].append(float(metrics["loss_d"]))
        hist["loss_g"].append(float(metrics["loss_g"]))
        if sample_every and (i + 1) % sample_every == 0:
            with torch.no_grad():
                hist["samples"].append(gen(z[:8]).cpu().numpy())
    return state, hist
