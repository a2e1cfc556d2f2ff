"""Checkpointing of the GAN train state (the counterpart of
``tmar.checkpoint.io``): {generator and discriminator ``state_dict`` (the
spectral-norm ``u``/``v`` buffers included), both optimizers' ``state_dict``
(moments, step counts, schedule counts), the EMA, the step} through
``torch.save`` / ``torch.load``, with ``keep_last_n`` retention and a
``best`` slot.  Each checkpoint is a directory ``step_<10 digits>`` (or
``best``) holding ``state.pt`` and ``meta.json``.

One file layout serves every device layout: under FSDP or tensor
parallelism every rank gathers each sharded tensor (in the reference order
of its rows, ``tmar_torch.core.mesh.full_tensor``), rank 0 alone writes, and
``restore`` puts each rank's part back.  So a checkpoint written under one
layout resumes under any other, or in one process.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from tmar_torch.core.mesh import (
    dist_barrier,
    full_tensor,
    is_main_process,
    rank_part,
    set_rank_part_,
)


def _opt_names(module, opt):
    """The parameter names in the order of the optimizer's state indices."""
    name_of = {id(p): n for n, p in module.named_parameters()}
    return [name_of[id(p)] for g in opt.param_groups for p in g["params"]]


def _full_opt_state(module, opt):
    sd = opt.state_dict()
    names = _opt_names(module, opt)
    state = {i: {k: full_tensor(module, names[i], v) if torch.is_tensor(v) and v.dim() else v
                 for k, v in st.items()} for i, st in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def state_to_dict(state) -> Dict[str, Any]:
    """The tensors of a ``GANTrainState``, whole, on the CPU (a collective
    when the state is sharded: every rank calls it)."""
    def cpu(obj):
        if isinstance(obj, torch.Tensor):
            return obj.detach().cpu()
        if isinstance(obj, dict):
            return {k: cpu(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(cpu(v) for v in obj)
        return obj

    def whole(module):
        return {k: full_tensor(module, k, v) for k, v in module.state_dict().items()}

    g, d = state.generator, state.discriminator
    return cpu({
        "step": int(state.step),
        "generator": whole(g),
        "discriminator": whole(d),
        "g_opt": _full_opt_state(g, state.g_opt),
        "d_opt": _full_opt_state(d, state.d_opt),
        "g_ema": None if state.g_ema is None else {
            k: full_tensor(g, k, v) for k, v in state.g_ema.items()},
    })


@torch.no_grad()
def _load_module(module, sd: Dict[str, torch.Tensor]) -> None:
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    if set(sd) != set(targets):
        raise KeyError(f"state_dict keys differ: missing {sorted(set(targets) - set(sd))}, "
                       f"unexpected {sorted(set(sd) - set(targets))}")
    for k, t in targets.items():
        if tuple(sd[k].shape) != tuple(t.shape):
            raise ValueError(f"{k}: shape {tuple(sd[k].shape)} in the checkpoint, {tuple(t.shape)} here")
        set_rank_part_(module, k, t, sd[k])


def _load_opt(module, opt, sd) -> None:
    names = _opt_names(module, opt)
    params = dict(module.named_parameters())
    state = {i: {k: rank_part(module, names[i], params[names[i]], v)
                 if torch.is_tensor(v) and v.dim() else v for k, v in st.items()}
             for i, st in sd["state"].items()}
    opt.load_state_dict({"state": state, "param_groups": sd["param_groups"]})


def load_state_dict(state, blob: Dict[str, Any]):
    """Load what ``state_to_dict`` made into ``state``'s modules and
    optimizers, in place and on their devices, each rank its own part of a
    sharded tensor; returns ``state``."""
    g, d = state.generator, state.discriminator
    _load_module(g, blob["generator"])
    _load_module(d, blob["discriminator"])
    _load_opt(g, state.g_opt, blob["g_opt"])
    _load_opt(d, state.d_opt, blob["d_opt"])
    if (blob["g_ema"] is None) != (state.g_ema is None):
        raise ValueError("the checkpoint and the state disagree on tracking an EMA")
    if state.g_ema is not None:
        with torch.no_grad():
            for k, v in state.g_ema.items():
                set_rank_part_(g, k, v, blob["g_ema"][k])
    state.step = int(blob["step"])
    return state


class CheckpointManager:
    def __init__(self, directory: str, keep_last_n: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_last_n = keep_last_n

    # ------------------------------------------------------------------ save
    def save(self, state, step: int, meta: Optional[Dict[str, Any]] = None, best: bool = False):
        """Write ``state`` (every rank calls it; rank 0 writes)."""
        name = "best" if best else f"step_{step:010d}"
        path = os.path.join(self.directory, name)
        blob = state_to_dict(state)
        if is_main_process():
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, "state.pt.tmp")
            torch.save(blob, tmp)
            os.replace(tmp, os.path.join(path, "state.pt"))
            with open(os.path.join(path, "meta.json"), "w") as f:
                json.dump({"step": step, **(meta or {})}, f)
            if not best:
                self._prune()
        dist_barrier()
        return path

    def _steps(self):
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _prune(self):
        steps = self._steps()
        for s in steps[: -self.keep_last_n] if self.keep_last_n else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def restore(
        self, target, step: Optional[int] = None, best: bool = False
    ) -> Optional[Tuple[Any, Dict[str, Any]]]:
        """Restore into ``target`` (a ``GANTrainState``, updated in place);
        returns (state, meta) or None when no checkpoint exists."""
        if best:
            name = "best"
        else:
            steps = self._steps()
            if step is not None:
                if step not in steps:
                    return None
                name = f"step_{step:010d}"
            elif steps:
                name = f"step_{steps[-1]:010d}"
            elif os.path.isdir(os.path.join(self.directory, "best")):
                name = "best"
            else:
                return None
        path = os.path.join(self.directory, name)
        if not os.path.isfile(os.path.join(path, "state.pt")):
            return None
        blob = torch.load(os.path.join(path, "state.pt"), map_location="cpu", weights_only=True)
        state = load_state_dict(target, blob)
        meta: Dict[str, Any] = {}
        meta_path = os.path.join(path, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return state, meta

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None
