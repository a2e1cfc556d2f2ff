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
  ``to_flax_params`` is its inverse.  A grouped conv's kernel crosses as
  [3, 3, in/groups, out] <-> [out, in/groups, 3, 3] (the SCDP bottleneck's
  depthwise conv takes 20 inputs in 5 groups at two encoder stages).
* ``disc_from_flax`` does the same for a flax ``MultiScaleDiscriminator``:
  the ``params`` tree (HWIO conv kernels -> OIHW weights) and the ``sn``
  collection, whose power-iteration vectors ``u``/``v`` are copied, never
  drawn anew.
* ``module_from_flax`` / ``module_to_flax`` carry the baselines, the DCGAN
  pair and DuDo (``tmar_torch.nn.baselines``, ``tmar_torch.nn.dudo``) across
  in both directions, walking the port's modules, whose names are flax's:
  conv kernels HWIO <-> OIHW, transposed-conv kernels flipped spatially,
  Dense / DenseGeneral kernels flattened to [in, out] and transposed, norm
  ``scale`` <-> ``weight``, the DCGAN generator's ``batch_stats`` <-> its
  BatchNorm buffers, other parameters (position embedding, step sizes) as
  they are.  ``python -m tmar_torch.cli finetune`` writes its pickle with
  ``module_to_flax``, which the JAX model loads.
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


def _flax_path(module: str):
    """The inverse of ``_module_path``: ``blocks.3`` -> ``blocks_3``,
    ``to_target.before_shuffle`` -> ``to_target_before_shuffle``."""
    out = []
    for p in module.split("."):
        if out and out[-1] == "blocks" and p.isdigit():
            out[-1] = f"blocks_{p}"
        elif out and out[-1] == "to_target":
            out[-1] = f"to_target_{p}"
        else:
            out.append(p)
    return out


def to_flax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``from_flax_params``: the port's NGswin ``state_dict`` ->
    a flax param tree of float32 numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        mod, leaf = key.rsplit(".", 1)
        v = t.detach().float().cpu().numpy()
        if leaf == "weight":
            leaf = "kernel" if v.ndim > 1 else "scale"
            v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
        elif leaf not in ("bias", "logit_scale", "relative_position_bias_table"):
            raise ValueError(f"unmapped state_dict entry {key!r}")
        node = tree
        for p in _flax_path(mod):
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(v, dtype=np.float32)
    return tree


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


def _lookup(tree: Mapping[str, Any], path, used: set):
    node = tree
    for p in path:
        if not isinstance(node, Mapping) or p not in node:
            raise ValueError(f"flax tree has no leaf {'/'.join(path)!r}")
        node = node[p]
    used.add(tuple(path))
    return np.asarray(node, np.float32)


def _conversions(model):
    """(module name, flax path, torch <- flax, flax <- torch, collection) for
    every parameter and buffer of the baselines' and DuDo's layers."""
    from tmar_torch.nn.baselines import BatchNorm, Conv, ConvTranspose, Dense, LayerNorm

    conv = (lambda k: k.transpose(3, 2, 0, 1), lambda w: w.transpose(2, 3, 1, 0))
    # flax's transposed conv correlates the dilated input with the kernel
    # unflipped; torch's is the conv's gradient, flipped
    deconv = (lambda k: k[::-1, ::-1].transpose(2, 3, 0, 1),
              lambda w: w.transpose(2, 3, 0, 1)[::-1, ::-1])
    same = (lambda a: a, lambda a: a)
    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(mod, ConvTranspose):
            yield name, "weight", path + ("kernel",), deconv, "params"
        elif isinstance(mod, Conv):
            yield name, "weight", path + ("kernel",), conv, "params"
        elif isinstance(mod, Dense):
            shape = mod.kernel_shape
            yield name, "weight", path + ("kernel",), (
                lambda k, n=mod.out_features: k.reshape(-1, n).T,
                lambda w, s=shape: w.T.reshape(s)), "params"
        elif isinstance(mod, (LayerNorm, BatchNorm)):
            yield name, "weight", path + ("scale",), same, "params"
        if isinstance(mod, (Conv, ConvTranspose, Dense, LayerNorm, BatchNorm)):
            if mod.bias is not None:
                shape = mod.bias_shape if isinstance(mod, Dense) else mod.bias.shape
                yield name, "bias", path + ("bias",), (
                    lambda b: b.reshape(-1), lambda b, s=tuple(shape): b.reshape(s)), "params"
            if isinstance(mod, BatchNorm):
                yield name, "mean", path + ("mean",), same, "batch_stats"
                yield name, "var", path + ("var",), same, "batch_stats"
            continue
        for pname, _ in mod.named_parameters(recurse=False):
            yield name, pname, path + (pname,), same, "params"


@torch.no_grad()
def module_from_flax(model, params: Mapping[str, Any],
                     batch_stats: Mapping[str, Any] = None) -> Dict[str, torch.Tensor]:
    """A flax baseline / DCGAN / DuDo tree (numpy ``params`` and, for the
    DCGAN generator, ``batch_stats``) -> the ``state_dict`` of ``model``, the
    port's module of the same configuration.  Every leaf of the trees must
    be used.  Without ``batch_stats`` the BatchNorm buffers are left out
    (a tree of Adam moments converts so)."""
    sd: Dict[str, torch.Tensor] = {}
    trees = {"params": params, "batch_stats": batch_stats}
    used = {k: set() for k in trees}
    for name, attr, path, (to_torch, _), coll in _conversions(model):
        if trees[coll] is None:
            continue
        v = to_torch(_lookup(trees[coll], path, used[coll]))
        sd[f"{name}.{attr}" if name else attr] = torch.from_numpy(np.array(v, np.float32))
    for coll, tree in trees.items():
        extra = {p for p, _ in _flatten(tree or {})} - used[coll]
        if extra:
            raise ValueError(f"unmapped flax {coll} leaves: {sorted('/'.join(p) for p in extra)}")
    return sd


@torch.no_grad()
def module_to_flax(model) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of ``module_from_flax``: ``model``'s parameters and
    buffers as flax's (``params``, ``batch_stats``) trees of float32 numpy
    arrays (``batch_stats`` empty where the model has no BatchNorm)."""
    trees: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for name, attr, path, (_, to_flax), coll in _conversions(model):
        t = model.get_submodule(name) if name else model
        v = getattr(t, attr).detach().float().cpu().numpy()
        node = trees[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(to_flax(v), dtype=np.float32)
    return trees["params"], trees["batch_stats"]
