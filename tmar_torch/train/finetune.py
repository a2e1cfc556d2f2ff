"""Dual-domain fine-tune engine (the counterpart of ``tmar.train.finetune``).

Two loops in one step:

* image domain: L1 reconstruction + edge-preservation loss;
* dual domain (a ``projector`` is given, or the model is dual-domain):
  also the trace-masked sinogram L1 of the prediction against the target,
  the trace ``Tr = (Radon(mask) < 0.1)``, the data-side projections taken
  without gradient.  A dual-domain model (``DuDoMARNet``) gets its
  sinograms of [Xma, XLI, mask] projected inside the step, in one call.

Freezing by parameter path (the JAX package's optax ``multi_transform`` with
``set_to_zero``) leaves the frozen parameters and their Adam state unchanged
while the gradient still flows through them: here the frozen parameters are
left out of the optimizer, which gives the same result.  With a ``mesh``
(``tmar_torch.core.mesh``) fine-tuning is data parallel, as in the JAX
package: the parameters are replicated (broadcast from rank 0), each rank
takes its rows of every batch, and the gradients of the trained parameters
and the metrics are averaged over the data axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn as nn

from tmar_torch.core.mesh import average_gradients, global_means, replicate
from tmar_torch.device import resolve_device
from tmar_torch.ops.gradients import image_gradients


@dataclasses.dataclass
class FinetuneWeights:
    """Loss weights."""

    rec: float = 1.0
    edge: float = 0.1
    sino: float = 0.1
    trace_threshold: float = 0.1  # Tr = (Radon(mask) < 0.1)


@dataclasses.dataclass
class FinetuneState:
    """The model holds the parameters, the optimizer the moments of the
    trainable ones."""

    step: int
    model: nn.Module
    opt: torch.optim.Optimizer


def _is_dual_domain(model) -> bool:
    return bool(getattr(model, "dual_domain", False))


def freeze_by_path(named_params: Iterable[Tuple[str, torch.Tensor]],
                   frozen_prefixes) -> List[torch.Tensor]:
    """The parameters that train: those whose flax path ("prox_s_0/in_conv/
    kernel"; here the name with "/" for ".") starts with none of
    ``frozen_prefixes``, a plain string prefix as in the JAX package."""
    frozen = tuple(frozen_prefixes)
    return [p for name, p in named_params if not name.replace(".", "/").startswith(frozen)]


def dudo_freeze_prefixes(freeze_stages: int, freeze_prior: bool = True):
    """Prefixes freezing the prior net and the first ``freeze_stages``
    unrolled stages of a ``DuDoMARNet``."""
    prefixes = ["prior_net"] if freeze_prior else []
    for k in range(freeze_stages):
        prefixes += [f"prox_s_{k}", f"prox_x_{k}"]
    return tuple(prefixes)


def create_finetune_state(generator: torch.Generator, model: nn.Module, lr: float = 1e-4,
                          freeze_prefixes=()) -> FinetuneState:
    """Draw ``model``'s parameters from ``generator`` (the JAX module's
    initialisers) and build its Adam state at ``lr`` over the parameters
    that ``freeze_prefixes`` leaves trainable (``freeze_by_path``); the
    counterpart of the JAX package's ``create_finetune_state`` (there the
    optimizer is an optax transformation and the state holds the tree)."""
    model.draw_parameters(generator)
    opt = torch.optim.Adam(freeze_by_path(model.named_parameters(), freeze_prefixes), lr,
                           betas=(0.9, 0.999), eps=1e-8)
    return FinetuneState(0, model, opt)


def make_finetune_step(model: nn.Module, optimizer: torch.optim.Optimizer, weights: FinetuneWeights,
                       projector=None, mesh=None, device="cuda"):
    """``step(state, batch) -> (state, metrics)``: ``batch`` carries ``Xma``,
    ``Xgt`` and ``mask`` (and ``XLI`` for a dual-domain model) as
    [B, H, W, 1]; ``metrics`` are ``loss``, ``rec``, ``edge`` and, with the
    sinogram term, ``sino``, float32 scalars on the device.  The state is
    updated in place and returned.  With a ``mesh`` the batch holds this
    rank's rows, and gradients and metrics are averaged over the data axis."""
    dev = resolve_device(device)
    model.to(dev)
    dual = _is_dual_domain(model)
    proj = model.projector if dual and projector is None else projector
    trained = [p for g in optimizer.param_groups for p in g["params"]] if mesh is not None else []

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    def step(state: FinetuneState, batch):
        xma, xgt, mask = tensor(batch["Xma"]), tensor(batch["Xgt"]), tensor(batch["mask"])
        s_out = tr = None
        if dual:
            xli = tensor(batch["XLI"]) if "XLI" in batch else xma
            with torch.no_grad():
                sinos = proj.forward(torch.cat([xma[..., 0], xli[..., 0], mask[..., 0]], dim=0))
            b = xma.shape[0]
            sma, sli, trace = sinos[:b], sinos[b:2 * b], sinos[2 * b:]
            tr = (trace < weights.trace_threshold).to(sma.dtype)
            out = model(xma, xli, 1.0 - mask, sma, sli, tr)
            xout, s_out = out["x"], out["s"]
        else:
            xout = model(xma)
        l_rec = (xout - xgt).abs().mean()
        pdx, pdy = image_gradients(xout)
        gdx, gdy = image_gradients(xgt)
        l_edge = (pdx - gdx).abs().mean() + (pdy - gdy).abs().mean()
        total = weights.rec * l_rec + weights.edge * l_edge
        terms = {"rec": l_rec, "edge": l_edge}
        if proj is not None and weights.sino:
            if s_out is None:
                s_out = proj.forward(xout)
                with torch.no_grad():
                    tr = (proj.forward(mask) < weights.trace_threshold).to(s_out.dtype)
            with torch.no_grad():
                s_gt = proj.forward(xgt)
            l_sino = ((s_out - s_gt).abs() * tr).mean()
            total = total + weights.sino * l_sino
            terms["sino"] = l_sino
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        average_gradients(mesh, trained)
        optimizer.step()
        state.step += 1
        metrics = {"loss": total.detach(), **{k: v.detach() for k, v in terms.items()}}
        return state, metrics if mesh is None else global_means(mesh, metrics, dev)

    return step


def finetune(
    model: nn.Module,
    dataset,
    num_epochs: int = 1,
    batch_size: int = 4,
    lr: float = 1e-4,
    weights: Optional[FinetuneWeights] = None,
    projector=None,
    mesh=None,
    seed: int = 0,
    num_workers: int = 0,
    progress: bool = False,
    freeze_prefixes=(),
    device="cuda",
) -> Dict[str, Any]:
    """Fine-tune ``model`` on a ``BenchmarkFinetuneDataset``: its parameters
    drawn anew from ``torch.Generator().manual_seed(seed)`` (the JAX
    module's initialisers), Adam at ``lr``, ``freeze_prefixes`` frozen (see
    ``freeze_by_path``; ``dudo_freeze_prefixes`` builds DuDo's set).
    Returns {"state", "history"} with the per-epoch mean losses.  With a
    ``mesh`` ``batch_size`` is the global batch, split over the data axis."""
    from tmar_torch.data import Loader

    dev = resolve_device(device)
    weights = weights or FinetuneWeights()
    model.to(dev)
    state = create_finetune_state(torch.Generator().manual_seed(seed), model, lr, freeze_prefixes)
    replicate(mesh, model)
    step = make_finetune_step(model, state.opt, weights, projector=projector, mesh=mesh, device=dev)
    keys = ("Xma", "Xgt", "mask") + (("XLI",) if _is_dual_domain(model) else ())
    loader = Loader(dataset, batch_size=batch_size, num_workers=num_workers, seed=seed,
                    device=dev, keys=keys, mesh=mesh)
    history = []
    for epoch in range(num_epochs):
        # the metrics are summed on the device and read once an epoch
        sums, n = None, 0
        for batch in loader:
            state, metrics = step(state, batch)
            names = list(metrics)
            row = torch.stack([metrics[k] for k in names])
            sums = row if sums is None else sums + row
            n += 1
        row = dict(zip(names, (sums / n).tolist())) if n else {}
        row["epoch"] = epoch
        history.append(row)
        if progress:
            print(f"[finetune epoch {epoch + 1}/{num_epochs}] "
                  + " ".join(f"{k}={v:.5f}" for k, v in row.items() if k != "epoch"), flush=True)
    return {"state": state, "history": history}
