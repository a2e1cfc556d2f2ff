"""Serving-artifact export (the counterpart of ``tmar.export``): the
generator's forward and its weights in ONE portable file.

``torch.export`` traces the eval-mode generator under ``torch.no_grad()``
for one static input bucket ``[batch, size, size, in_chans]`` float32 and
``torch.export.save`` writes the program, weights included, to bytes.  A
serving host loads it with ``load_artifact`` and runs it with torch alone:
no model class, no checkpoint, no re-tracing.

On the card the five forward kernels (K1 ``tmar::ngram_context``, K2
``tmar::nstb_map``, K8 ``tmar::nstb_tokens``, K3
``tmar::window_attention_fwd``, K5 ``tmar::residual_ffn_fwd``) are
``torch.library`` operators, each one node of the program, which launches
the kernel when the program runs (and counts the launch on its wrapper).
They must be registered before a program is loaded: ``load_artifact``
imports their modules.  On the CPU the program holds the plain versions.

Shapes are static per artifact, as in JAX: export one artifact per serving
bucket with ``export_generator`` or ``python -m tmar_torch.cli export``.
The file is a ``.pt2`` (``torch.export``'s format), not JAX's ``.tmarx``
(StableHLO).

Usage::

    blob = export_generator(gen, batch=8, size=512)
    save_artifact("ngswin_512b8.pt2", blob)
    ...
    fn = load_artifact("ngswin_512b8.pt2")       # serving host
    y = fn(x)                                    # [8, 512, 512, 1] -> same
"""

from __future__ import annotations

import io
import os
from typing import Callable, Union

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from tmar_torch.device import resolve_device

__all__ = [
    "export_generator",
    "save_artifact",
    "load_artifact",
    "main",
]


def export_generator(model: torch.nn.Module, *, batch: int = 8, size: int = 512,
                     in_chans: int = 1, device="cuda") -> bytes:
    """``model``'s forward for the fixed input bucket ``[batch, size, size,
    in_chans]`` float32 on ``device``, with its weights, as
    ``torch.export`` bytes.  Moves the model there and sets it to eval
    mode."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    x = torch.zeros((batch, size, size, in_chans), dtype=torch.float32, device=dev)
    with torch.no_grad(), _NoOpCasts():
        program = torch.export.export(model, (x,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


class _NoOpCasts(TorchFunctionMode):
    """Leaves out of a traced program the casts that change nothing
    (``t.float()`` of a float32 tensor, ``t.to(dtype, device)`` to its own):
    eager PyTorch returns ``t`` itself for them, but ``torch.export``
    records each as a cast and a metadata check, a fifth of the nodes of the
    plain versions' program, each of which costs time to save and load."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.float and len(args) == 1 and not kwargs:
            if args[0].dtype == torch.float32:
                return args[0]
        elif func is torch.Tensor.to and _changes_nothing(args[0], args[1:], kwargs):
            return args[0]
        return func(*args, **kwargs)


def _changes_nothing(t, args, kwargs) -> bool:
    """Whether ``t.to(*args, **kwargs)`` asks only for t's own dtype and
    device."""
    if not (args or kwargs) or set(kwargs) - {"dtype", "device"}:
        return False
    for want in (*args, *kwargs.values()):
        if isinstance(want, torch.dtype):
            if want != t.dtype:
                return False
        elif not isinstance(want, (str, torch.device)) or torch.device(want) != t.device:
            return False
    return True


def save_artifact(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def load_artifact(path: str) -> Callable[[Union[np.ndarray, torch.Tensor]], torch.Tensor]:
    """Load an artifact into a callable that takes a numpy array or a tensor
    and runs the program, with autograd off, on the device it was exported
    for (no model code; an input of another shape raises)."""
    # the operators of the kernels, which a program for the card calls
    from tmar_torch.ops import cuda_attention, cuda_ffn, cuda_ngram, cuda_nstb  # noqa: F401

    with open(path, "rb") as f:
        program = torch.export.load(f)
    dev = next(iter(program.state_dict.values())).device
    module = program.module()

    @torch.no_grad()
    def run(x):
        return module(torch.as_tensor(x, dtype=torch.float32, device=dev))

    return run


def main(argv=None) -> int:
    """``python -m tmar_torch.cli export``: build a serving artifact from a
    checkpoint."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m tmar_torch.cli export",
        description="Export a generator checkpoint to a serving artifact "
        "(torch.export program; weights inside)",
    )
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint", required=True,
                    help="port checkpoint dir or torch .pth file")
    ap.add_argument("--set", nargs="*", action="append", default=[])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--out", default=None,
                    help="output path (default ngswin_<size>b<batch>.pt2)")
    ap.add_argument("--platform", default=None,
                    help="the JAX CLI's lowering target: cpu, or gpu / cuda (the card)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--torch", action="store_true",
                    help="write a reference-layout torch .pth instead of an artifact "
                    "(tmar_torch.checkpoint.save_pth)")
    args = ap.parse_args(argv)

    from tmar_torch.checkpoint import save_pth
    from tmar_torch.cli import _load_generator_params, _parse_sets, block_form
    from tmar_torch.train import load_config
    from tmar_torch.train.trainer import build_generator

    device = args.device or {None: "cuda", "gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}.get(
        args.platform)
    if device is None:
        raise SystemExit(f"--platform {args.platform!r}: the port runs on cpu or gpu/cuda")
    cfg = load_config(args.config, _parse_sets(args.set))
    gen = build_generator(cfg, device, **block_form())
    gen.load_state_dict(_load_generator_params(args.checkpoint, gen, cfg))
    if args.torch:
        out = args.out or "ngswin_exported.pth"
        save_pth(gen, out)
        print(f"[export] {out}: {os.path.getsize(out) / 1e6:.1f} MB "
              "(torch state_dict, reference NGswin layout)")
        return 0
    blob = export_generator(gen, batch=args.batch, size=args.size,
                            in_chans=cfg.model.in_chans, device=device)
    out = args.out or f"ngswin_{args.size}b{args.batch}.pt2"
    save_artifact(out, blob)
    print(f"[export] {out}: {os.path.getsize(out) / 1e6:.1f} MB "
          f"(batch {args.batch}, {args.size}², device {device})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
