"""Checkpoint conversion for the port.

* ``load_pth`` reads a reference-layout ``.pth`` (``netG_state_dict`` /
  ``generator_state_dict`` / ``state_dict`` / raw) and strips the ``module.``
  and ``main.`` wrapper prefixes.  The port's ``state_dict`` keys are the
  reference layout's, so the result loads with ``load_state_dict``.
* ``from_flax_params`` turns a flax NGswin param tree (numpy arrays) into the
  port's ``state_dict``: flax ``blocks_3`` -> ``blocks.3``,
  ``to_target_before_shuffle`` -> ``to_target.before_shuffle``; Linear kernels
  [in, out] -> weight [out, in]; HWIO conv kernels -> [out, in/g, kh, kw];
  LayerNorm scale -> weight.  The port keeps its own copy of this mapping.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """The generator ``state_dict`` in a ``.pth`` file, on the CPU."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, Mapping):
        raise TypeError(f"unexpected checkpoint type {type(blob)}")
    for key in ("netG_state_dict", "generator_state_dict", "state_dict"):
        if key in blob:
            blob = blob[key]
            break
    out = {}
    for k, v in blob.items():
        for prefix in ("module.", "main."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        out[k] = v
    return out


def _flatten(tree: Mapping[str, Any], path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _module_path(parts) -> str:
    out = []
    for p in parts:
        if p.startswith("blocks_") and p[len("blocks_"):].isdigit():
            out += ["blocks", p[len("blocks_"):]]
        elif p.startswith("to_target_"):
            out += ["to_target", p[len("to_target_"):]]
        else:
            out.append(p)
    return ".".join(out)


def from_flax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax NGswin param tree -> the port's (reference-layout) state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(params):
        mod = _module_path(path[:-1])
        leaf = path[-1]
        v = np.asarray(v, np.float32)
        if leaf == "kernel":
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            sd[f"{mod}.weight"] = torch.from_numpy(np.array(v))  # a contiguous copy
        elif leaf == "scale":
            sd[f"{mod}.weight"] = torch.from_numpy(np.array(v))
        elif leaf in ("bias", "logit_scale", "relative_position_bias_table"):
            sd[f"{mod}.{leaf}"] = torch.from_numpy(np.array(v))
        else:
            raise ValueError(f"unmapped flax leaf {'.'.join(path)!r}")
    return sd
