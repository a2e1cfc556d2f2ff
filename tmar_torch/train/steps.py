"""GAN train and eval steps (the counterpart of ``tmar.train.steps``).

One iteration is a D step, then a G step against the updated D, with TTUR
Adam updates and the spectral-norm power iterations, and ONE generator
forward: its detached value feeds the D step, its graph feeds the G step.
The G loss is taken as a function of the generator OUTPUT on a detached
leaf, dL/dfake is pulled out with ``torch.autograd.grad`` (which leaves the
discriminator's parameter gradients untouched), and ``fake.backward(dfake)``
carries it into the generator.  That equals re-running the forward, because
the D update never touches the generator's parameters.

The discriminator is the multi-scale PatchGAN or the DCGAN critic (no
spectral norm), the generator the NGswin or a baseline.  The generator
forward runs under autograd, so every NGswin form takes kernels that have
backward kernels (``tmar_torch.nn.blocks``); the whole-block kernels of
the inference form never run in a step.

With a ``mesh`` (``tmar_torch.core.mesh``) each process takes its rows of the
global batch.  After each backward the gradients of that network are
averaged over the data axis that FSDP does not reduce itself
(``average_gradients``: one flat bucket per network), as the psum of the JAX
step, and the metrics are averaged so that every rank returns the global
mean.  The networks carry their layout (replicated, FSDP2 or tensor
parallel) in their parameters.  The JAX step's donation has no counterpart:
the state is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn

from tmar_torch.core.mesh import (
    all_gather_rows,
    average_gradients,
    global_means,
    local,
    spec_dim,
)
from tmar_torch.device import resolve_device
from tmar_torch.losses import LossWeights, generator_loss, hinge_d_loss, vanilla_d_loss
from tmar_torch.nn.layers import init_weights
from tmar_torch.nn.spectral_norm import SNConv, _l2_normalize


@dataclasses.dataclass
class GANTrainState:
    """The modules hold the parameters (and the discriminator's ``u``/``v``
    buffers), the optimizers their moments; ``g_ema`` is the exponential
    moving average of the generator's parameters by name, or None."""

    step: int
    generator: nn.Module
    g_opt: torch.optim.Optimizer
    discriminator: nn.Module
    d_opt: torch.optim.Optimizer
    g_ema: Optional[Dict[str, torch.Tensor]] = None


@torch.no_grad()
def create_train_state(
    rng: torch.Generator,
    generator: nn.Module,
    discriminator: nn.Module,
    g_opt: torch.optim.Optimizer,
    d_opt: torch.optim.Optimizer,
    ema_decay: float = 0.0,
) -> GANTrainState:
    """Draw the parameters of both networks anew from ``rng``
    (``draw_parameters``) and wrap them with their optimizers.
    ``ema_decay > 0`` also tracks an exponential moving average of the
    generator's parameters, started as a copy."""
    draw_parameters(rng, generator, discriminator)
    return GANTrainState(0, generator, g_opt, discriminator, d_opt,
                         new_ema(generator) if ema_decay else None)


def new_ema(generator: nn.Module) -> Dict[str, torch.Tensor]:
    """The EMA's start: a copy of the generator's parameters by name, each
    held as its parameter is (a shard where the parameter is sharded)."""
    return {k: p.detach().clone() for k, p in generator.named_parameters()}


@torch.no_grad()
def draw_parameters(rng: torch.Generator, generator: nn.Module, discriminator: nn.Module) -> None:
    """Draw the parameters of both networks anew from ``rng`` (on the
    generator's device, then copied to the networks', so a CPU generator
    gives the same state on any device; the same initialisers as at
    construction, the discriminator's ``u``/``v`` included)."""
    if hasattr(generator, "draw_parameters"):  # the baselines: flax's initialisers
        generator.draw_parameters(rng)
    else:
        for module in generator.modules():
            init_weights(module, generator=rng)

    def randn(like):
        return torch.randn(like.shape, generator=rng, device=rng.device)

    for module in discriminator.modules():
        if isinstance(module, (SNConv, nn.Conv2d)):
            module.weight.copy_(randn(module.weight) * 0.02)
            if module.bias is not None:
                module.bias.zero_()
        if isinstance(module, SNConv):
            module.u.copy_(_l2_normalize(randn(module.u)))
            module.v.copy_(_l2_normalize(randn(module.v)))


def _split_rf(tree, B: int):
    """Split every tensor of a nested list along the concatenated batch:
    (real half, fake half)."""
    if isinstance(tree, torch.Tensor):
        return tree[:B], tree[B:]
    halves = [_split_rf(t, B) for t in tree]
    return [h[0] for h in halves], [h[1] for h in halves]


def _detach(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return [_detach(t) for t in tree]


def make_train_step(
    generator: nn.Module,
    discriminator: nn.Module,
    g_opt: torch.optim.Optimizer,
    d_opt: torch.optim.Optimizer,
    weights: LossWeights,
    projector=None,
    fused_pairs: bool = False,
    ema_decay: float = 0.0,
    device="cuda",
    mesh=None,
    state_shardings=None,
) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)``.  ``batch`` is a dict
    with ``ct`` (corrupted input) and ``gt`` (clean target), [B, H, W, C] in
    [-1, 1]; ``metrics`` are float32 scalars on the device (``loss_d``,
    ``loss_g`` and one ``g_<term>`` per active loss term).  The state is
    updated in place and returned.

    ``fused_pairs=True`` runs each loss's real and fake discriminator
    applications as ONE batch-concatenated pass (2 passes and 2 power
    iterations per step instead of 4).  ``projector`` is the Radon projector
    of the sinogram term; without one a non-zero ``weights.phys`` is skipped.

    ``mesh``: ``batch`` holds this rank's rows (``shard_batch``), gradients
    and metrics are averaged over the data axis.  ``state_shardings``
    (``gan_state_shardings``) names the layout the networks were put in; the
    step checks that every parameter it says is split is held as a shard.
    """
    dev = resolve_device(device)
    if state_shardings is not None:
        _check_layout(generator, state_shardings["generator"])
        _check_layout(discriminator, state_shardings["discriminator"])
    generator.to(dev)
    discriminator.to(dev)
    has_sn = getattr(discriminator, "use_sn", True)
    g_params: List[torch.Tensor] = [p for p in generator.parameters()]
    g_names = [k for k, _ in generator.named_parameters()]
    d_params = list(discriminator.parameters())

    def apply_d(x, want_features):
        if has_sn:
            return discriminator(x, update_sn=True, return_features=want_features)
        return discriminator(x, return_features=want_features)

    def train_step(state: GANTrainState, batch):
        if ema_decay and state.g_ema is None:
            raise ValueError(
                "ema_decay > 0 but state.g_ema is None: build the state with "
                "create_train_state(..., ema_decay=ema_decay)"
            )
        if not ema_decay and state.g_ema is not None:
            raise ValueError(
                "state carries g_ema but ema_decay=0: pass the training ema_decay to "
                "make_train_step (a stale EMA would otherwise be carried forever)"
            )
        ct = torch.as_tensor(batch["ct"], dtype=torch.float32, device=dev)
        real = torch.as_tensor(batch["gt"], dtype=torch.float32, device=dev)
        B = ct.shape[0]

        fake = generator(ct)
        fake_sg = fake.detach()
        real_pair = torch.cat([ct, real], dim=-1)

        # ---------------- D step (G frozen) ---------------------------------
        fake_pair = torch.cat([ct, fake_sg], dim=-1)
        if fused_pairs:
            logits, _ = apply_d(torch.cat([real_pair, fake_pair], dim=0), False)
            real_logits, fake_logits = _split_rf(logits, B)
        else:
            real_logits, _ = apply_d(real_pair, False)
            fake_logits, _ = apply_d(fake_pair, False)
        d_loss_fn = hinge_d_loss if weights.gan_mode == "hinge" else vanilla_d_loss
        d_loss = d_loss_fn(real_logits, fake_logits)
        d_opt.zero_grad(set_to_none=True)
        d_loss.backward()
        average_gradients(mesh, d_params)
        d_opt.step()

        # ---------------- G step (new D) ------------------------------------
        # the loss as a function of the generator OUTPUT, on a detached leaf
        fake_leaf = fake_sg.clone().requires_grad_(True)
        fake_pair = torch.cat([ct, fake_leaf], dim=-1)
        fake_logits = fake_feats = real_feats = None
        if fused_pairs and weights.fm:
            # one pass over [real ‖ fake]: the gradient flows only through
            # the fake half (the real half is a constant input)
            logits, feats = apply_d(torch.cat([real_pair, fake_pair], dim=0), True)
            _, fake_logits = _split_rf(logits, B)
            real_feats, fake_feats = _split_rf(feats, B)
            real_feats = _detach(real_feats)
        elif weights.adv or weights.fm:
            fake_logits, fake_feats = apply_d(fake_pair, True)
            if weights.fm:
                _, real_feats = apply_d(real_pair, True)
                real_feats = _detach(real_feats)
        g_loss, g_terms = generator_loss(
            fake_leaf, real, ct, fake_logits, fake_feats, real_feats, weights,
            projector=projector,
        )
        (dfake,) = torch.autograd.grad(g_loss, fake_leaf)
        g_opt.zero_grad(set_to_none=True)
        fake.backward(dfake)
        average_gradients(mesh, g_params, getattr(generator, "tp_summed", ()))
        g_opt.step()

        if ema_decay:
            # ema <- d_t * ema + (1 - d_t) * theta with a warmed-up decay
            # d_t = min(d, (1 + t) / (10 + t)) on the pre-increment step
            t = float(state.step)
            eff_d = min(ema_decay, (1.0 + t) / (10.0 + t))
            with torch.no_grad():
                # on each rank's own part: the EMA lies as its parameter
                ema = [local(state.g_ema[k]) for k in g_names]
                torch._foreach_mul_(ema, eff_d)
                torch._foreach_add_(ema, [local(p.detach()) for p in g_params],
                                    alpha=1.0 - eff_d)

        metrics = {"loss_d": d_loss.detach(), "loss_g": g_loss.detach()}
        for k, v in g_terms.items():
            metrics[f"g_{k}"] = v.detach() if isinstance(v, torch.Tensor) else v
        if mesh is not None:
            metrics = global_means(mesh, metrics, dev)
        state.step += 1
        return state, metrics

    return train_step


def _check_layout(module: nn.Module, specs) -> None:
    for name, p in module.named_parameters():
        if spec_dim(specs.get(name, ())) is not None and local(p) is p:
            raise ValueError(f"{name}: the layout splits it, but the module holds it whole")


def make_eval_step(generator: nn.Module, device="cuda", mesh=None) -> Callable:
    """Validation forward: ``eval_step(batch, params=None) -> (restored,
    {"mse", "psnr"})`` with the data-range-2 PSNR, 10 log10(4 / mse),
    averaged over the batch.  ``params`` ({name: tensor}, e.g. the state's
    ``g_ema``) stands in for the generator's own parameters for that call.
    With a ``mesh``, ``batch`` holds this rank's rows: the restored rows of
    every data rank are gathered, and the metrics are over the global batch,
    on every rank.  The generator must then hold whole parameters."""
    dev = resolve_device(device)
    generator.to(dev)

    @torch.no_grad()
    def eval_step(batch, params=None):
        ct = torch.as_tensor(batch["ct"], dtype=torch.float32, device=dev)
        gt = torch.as_tensor(batch["gt"], dtype=torch.float32, device=dev)
        if params is None:
            fake = generator(ct)
        else:
            fake = torch.func.functional_call(generator, params, (ct,))
        mse = (fake - gt).square().mean(dim=(1, 2, 3))
        if mesh is not None:
            fake, mse = all_gather_rows(mesh, fake.float()), all_gather_rows(mesh, mse.float())
        psnr = 10.0 * torch.log10(4.0 / mse.clamp(min=1e-12))
        return fake, {"mse": mse.mean(), "psnr": psnr.mean()}

    return eval_step
