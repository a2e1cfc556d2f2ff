"""LR schedules, layer-wise LR decay and the TTUR Adam optimizer (the
counterpart of ``tmar.train.schedules``).

A schedule is a function ``step count -> learning rate``.  ``build_optimizer``
returns a ``torch.optim.Adam`` whose ``step`` keeps optax's order of
operations, clip -> Adam -> schedule: it clips the gradients by their global
norm, sets every group's learning rate to ``schedule(count)`` times the
group's layer-wise decay factor, and then takes the Adam step.  The first
step uses ``schedule(0)``.  The count lives in the parameter groups, so the
optimizer's ``state_dict`` carries it.  Parameters sharded as ``DTensor``s
(FSDP, tensor parallelism) may sit beside whole ones: the clip takes the
global norm over both, and each group updates its two kinds apart.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from tmar_torch.core.mesh import is_dtensor, local

Schedule = Callable[[int], float]


def warmup_cosine(base_lr: float, total_steps: int, warmup_steps: int = 0,
                  min_lr: float = 0.0) -> Schedule:
    """Linear warmup from 0 over ``warmup_steps``, then cosine decay to
    ``min_lr`` at ``total_steps`` (which includes the warmup)."""
    alpha = min_lr / base_lr if base_lr else 0.0
    decay_steps = total_steps - warmup_steps if warmup_steps > 0 else total_steps
    if not decay_steps > 0:
        raise ValueError(f"the cosine schedule needs positive decay steps, got {decay_steps}")

    def schedule(count):
        if warmup_steps > 0 and count < warmup_steps:
            return base_lr * count / warmup_steps
        t = min(count - warmup_steps if warmup_steps > 0 else count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def step_half(base_lr: float, step_size: int) -> Schedule:
    """Halve the LR every ``step_size`` steps."""

    def schedule(count):
        return base_lr * (0.5 ** (count // step_size))

    return schedule


def multistep(base_lr: float, milestones, gamma: float = 0.5) -> Schedule:
    """Multiply the LR by ``gamma`` at every milestone reached."""
    milestones = sorted(milestones)

    def schedule(count):
        factor = 1.0
        for m in milestones:
            factor = factor * gamma if count >= m else factor
        return base_lr * factor

    return schedule


def build_schedule(optim_cfg, base_lr: float, total_steps: int) -> Optional[Schedule]:
    """Resolve an OptimConfig's schedule fields (None = constant LR).  The
    Trainer builds one for each of the two TTUR optimizers."""
    kind = getattr(optim_cfg, "schedule", "none") or "none"
    if kind == "none":
        return None
    if kind == "cosine":
        return warmup_cosine(base_lr, total_steps, warmup_steps=optim_cfg.warmup_steps,
                             min_lr=optim_cfg.min_lr)
    if kind == "step_half":
        return step_half(base_lr, optim_cfg.schedule_step_size)
    if kind == "multistep":
        return multistep(base_lr, list(optim_cfg.milestones), optim_cfg.gamma)
    raise ValueError(f"unknown schedule {kind!r}")


# --------------------------------------------------------------------- LLRD
def ngswin_layer_id(path: str, num_encoder_stages: int = 3) -> int:
    """The depth id of an NGswin parameter for layer-wise decay: shallow
    extractor 0, encoder-stage blocks rising with depth, bottleneck, decoder
    blocks, and the final norm and head highest (largest LR).  ``path`` is a
    ``named_parameters`` name (``encoder_layer1.blocks.0.attn.qkv.weight``);
    the JAX package's ``encoder_layer1/blocks_0/...`` form gives the same id."""
    path = path.replace("/", ".").replace("blocks_", "blocks.")
    if "shallow_extract" in path:
        return 0
    m = re.search(r"encoder_layer(\d+)\.blocks\.(\d+)", path)
    if m:
        return 1 + int(m.group(1)) * 10 + int(m.group(2))
    m = re.search(r"encoder_layer(\d+)\.downsample", path)
    if m:
        return 1 + int(m.group(1)) * 10 + 9
    if "bottleneck" in path:
        return 1 + (num_encoder_stages + 1) * 10
    m = re.search(r"decoder_layer1\.blocks\.(\d+)", path)
    if m:
        return 2 + (num_encoder_stages + 1) * 10 + int(m.group(1))
    return 3 + (num_encoder_stages + 2) * 10  # norm / reconstruction head


def layerwise_lr_decay(named_params: Iterable[Tuple[str, torch.Tensor]], decay: float = 0.9,
                       num_encoder_stages: int = 3) -> Dict[str, float]:
    """{parameter name: decay ** (max_id - id)}, the BEiT-style LR factor."""
    ids = {k: ngswin_layer_id(k, num_encoder_stages) for k, _ in named_params}
    max_id = max(ids.values())
    return {k: decay ** (max_id - i) for k, i in ids.items()}


def global_norm(grads) -> torch.Tensor:
    """The L2 norm of all of ``grads`` together, on their device.  The
    squares of sharded ``DTensor`` gradients (each element held by one rank
    of its mesh) are summed over their mesh by c10d's all-reduce, a
    collective every rank calls: DTensor's own reduction goes through the
    functional collectives, which took a rank down over gloo on the card.
    Whole gradients sit beside them."""
    sharded = [g for g in grads if is_dtensor(g)]
    plain = [g for g in grads if not is_dtensor(g)]
    if not sharded:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(plain)))
    mesh = sharded[0].device_mesh
    sq = torch.stack(torch._foreach_norm([local(g) for g in sharded])).square().sum()
    dist.all_reduce(sq, group=mesh.get_group())  # a 1-D mesh: the data or the model axis
    if plain:
        sq = sq + torch.stack(torch._foreach_norm(plain)).square().sum()
    return sq.sqrt()


def _by_kind(params):
    """The whole parameters and the ``DTensor`` ones of a list, apart (the
    multi-tensor updates take one kind at a time)."""
    kinds = ([p for p in params if not is_dtensor(p)], [p for p in params if is_dtensor(p)])
    return [k for k in kinds if k]


class ScheduledAdam(torch.optim.Adam):
    """Adam whose ``step`` first clips the gradients by their global norm
    (optax's rule: untouched below ``grad_clip``, else scaled to it), then
    sets each group's ``lr`` to ``schedule(count) * lr_scale``, then updates."""

    def __init__(self, params, base_lr, schedule=None, grad_clip=None, **adam):
        super().__init__(params, lr=base_lr, **adam)
        self.base_lr = base_lr
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.grad_norm = None  # the global norm the last clip read, before clipping
        for group in self.param_groups:
            group.setdefault("lr_scale", 1.0)
            group.setdefault("count", 0)
            group["lr"] = base_lr * group["lr_scale"]

    @torch.no_grad()
    def step(self, closure=None):
        if self.grad_clip:
            grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
            if grads:
                norm = self.grad_norm = global_norm(grads)
                # stays on the device: no read-back of the norm
                torch._foreach_mul_([local(g) for g in grads],
                                    torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm))
        for group in self.param_groups:
            lr = self.base_lr if self.schedule is None else float(self.schedule(group["count"]))
            group["lr"] = lr * group["lr_scale"]
            group["count"] += 1
        groups = self.param_groups
        split = [dict(g, params=kind) for g in groups for kind in _by_kind(g["params"])]
        if len(split) == len(groups):
            return super().step(closure)
        self.param_groups = split  # for this update only; the state is keyed by parameter
        try:
            return super().step(closure)
        finally:
            self.param_groups = groups


def build_optimizer(named_params: Iterable[Tuple[str, torch.Tensor]], base_lr: float,
                    beta1: float = 0.5, beta2: float = 0.999,
                    schedule: Optional[Schedule] = None,
                    grad_clip: Optional[float] = None,
                    llrd: Optional[Dict[str, Any]] = None,
                    fused: bool = False) -> ScheduledAdam:
    """clip -> Adam (eps 1e-8) -> layer-wise decay -> schedule over the named
    parameters.  ``llrd`` ({"decay": d}) puts the parameters of one depth id
    in one group with its LR factor.

    ``fused=True`` is the counterpart of the JAX package's one-vector update:
    on a CUDA device the whole update is PyTorch's single multi-tensor kernel
    (``torch.optim.Adam(fused=True)``), elsewhere its ``foreach``
    implementation.  Without it PyTorch picks its default, which on a CUDA
    device is already the ``foreach`` (a few multi-tensor kernels) update.
    Unlike the JAX flag it does not change the layout of the state."""
    named = list(named_params)
    if llrd:
        scales = layerwise_lr_decay(named, **llrd)
        by_scale: Dict[float, list] = {}
        for k, p in named:
            by_scale.setdefault(scales[k], []).append(p)
        groups = [{"params": ps, "lr_scale": s} for s, ps in by_scale.items()]
    else:
        groups = [{"params": [p for _, p in named]}]
    impl = {}
    if fused:
        on_cuda = all(p.device.type == "cuda" for _, p in named)
        impl = {"fused": True} if on_cuda else {"foreach": True}
    return ScheduledAdam(groups, base_lr, schedule=schedule, grad_clip=grad_clip,
                         betas=(beta1, beta2), eps=1e-8, **impl)
