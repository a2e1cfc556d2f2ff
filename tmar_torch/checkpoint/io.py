"""Checkpointing of the GAN train state (the counterpart of
``tmar.checkpoint.io``): {generator and discriminator ``state_dict`` (the
spectral-norm ``u``/``v`` buffers included), both optimizers' ``state_dict``
(moments, step counts, schedule counts), the EMA, the step} through
``torch.save`` / ``torch.load``, with ``keep_last_n`` retention and a
``best`` slot.  Each checkpoint is a directory ``step_<10 digits>`` (or
``best``) holding ``state.pt`` and ``meta.json``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch


def state_to_dict(state) -> Dict[str, Any]:
    """The tensors of a ``GANTrainState``, on the CPU."""
    def cpu(obj):
        if isinstance(obj, torch.Tensor):
            return obj.detach().cpu()
        if isinstance(obj, dict):
            return {k: cpu(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(cpu(v) for v in obj)
        return obj

    return cpu({
        "step": int(state.step),
        "generator": state.generator.state_dict(),
        "discriminator": state.discriminator.state_dict(),
        "g_opt": state.g_opt.state_dict(),
        "d_opt": state.d_opt.state_dict(),
        "g_ema": state.g_ema,
    })


def load_state_dict(state, blob: Dict[str, Any]):
    """Load what ``state_to_dict`` made into ``state``'s modules and
    optimizers, in place and on their devices; returns ``state``."""
    state.generator.load_state_dict(blob["generator"])
    state.discriminator.load_state_dict(blob["discriminator"])
    state.g_opt.load_state_dict(blob["g_opt"])
    state.d_opt.load_state_dict(blob["d_opt"])
    if (blob["g_ema"] is None) != (state.g_ema is None):
        raise ValueError("the checkpoint and the state disagree on tracking an EMA")
    if state.g_ema is not None:
        with torch.no_grad():
            for k, v in state.g_ema.items():
                v.copy_(blob["g_ema"][k])
    state.step = int(blob["step"])
    return state


class CheckpointManager:
    def __init__(self, directory: str, keep_last_n: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_last_n = keep_last_n

    # ------------------------------------------------------------------ save
    def save(self, state, step: int, meta: Optional[Dict[str, Any]] = None, best: bool = False):
        name = "best" if best else f"step_{step:010d}"
        path = os.path.join(self.directory, name)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, "state.pt.tmp")
        torch.save(state_to_dict(state), tmp)
        os.replace(tmp, os.path.join(path, "state.pt"))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
        if not best:
            self._prune()
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
