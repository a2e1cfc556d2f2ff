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
* ``disc_from_flax`` does the same for a flax ``MultiScaleDiscriminator``:
  the ``params`` tree (HWIO conv kernels -> OIHW weights) and the ``sn``
  collection, whose power-iteration vectors ``u``/``v`` are copied, never
  drawn anew.
* ``adam_state_from_optax`` loads optax Adam moments (converted by the two
  functions above, as the parameters are) and the step count into a
  ``torch.optim.Adam``, so that a JAX ``GANTrainState`` becomes the port's.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Tuple

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


def disc_from_flax(params: Mapping[str, Any], sn: Mapping[str, Any] = None) -> Dict[str, torch.Tensor]:
    """A flax discriminator's ``params`` tree and ``sn`` collection (``u``,
    ``v`` per conv; None or empty without spectral norm) -> the port's
    ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(params):
        name = {"kernel": "weight", "bias": "bias"}.get(path[-1])
        if name is None:
            raise ValueError(f"unmapped flax leaf {'.'.join(path)!r}")
        v = np.asarray(v, np.float32)
        if name == "weight":
            v = v.transpose(3, 2, 0, 1)
        sd[".".join(path[:-1] + (name,))] = torch.from_numpy(np.array(v))
    for path, v in _flatten(sn or {}):
        if path[-1] not in ("u", "v"):
            raise ValueError(f"unmapped spectral-norm leaf {'.'.join(path)!r}")
        sd[".".join(path)] = torch.from_numpy(np.array(v, np.float32))
    return sd


@torch.no_grad()
def adam_state_from_optax(
    optimizer: torch.optim.Adam,
    named_params: Iterable[Tuple[str, torch.Tensor]],
    mu: Mapping[str, torch.Tensor],
    nu: Mapping[str, torch.Tensor],
    count: int,
) -> None:
    """Set ``optimizer``'s state from optax's ``ScaleByAdamState``: ``mu`` and
    ``nu`` are its moment trees in the port's layout ({parameter name:
    tensor}, through ``from_flax_params`` / ``disc_from_flax``), ``count`` its
    step count, which is also the schedule count of a ``ScheduledAdam``."""
    for name, p in named_params:
        if mu[name].shape != p.shape or nu[name].shape != p.shape:
            raise ValueError(f"moment shape mismatch at {name}")
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu[name].to(device=p.device, dtype=p.dtype).clone(),
            "exp_avg_sq": nu[name].to(device=p.device, dtype=p.dtype).clone(),
        }
    for group in optimizer.param_groups:
        if "count" in group:
            group["count"] = int(count)
