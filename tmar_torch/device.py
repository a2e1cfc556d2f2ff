"""Device selection for the port's entry points.

Entry points default to ``"cuda"`` and never fall back to the CPU: with no
card they raise, and a caller that wants the CPU asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def refuse_grad(name: str, tensors) -> None:
    """Raise if autograd would record a call of the forward-only kernel
    ``name`` on ``tensors``: it has no backward kernel, and its result would
    carry no graph."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is a forward-only kernel: it cannot run on a CUDA tensor with "
            "autograd on and an argument that requires grad.  Call it under "
            "torch.no_grad() (as make_inference_fn does), or build the model in its "
            "training form, attn_backward='pallas', whose kernels have backwards."
        )


def float32_data(t: torch.Tensor, contiguous: bool = False) -> torch.Tensor:
    """The float32 data of a parameter, outside the graph, as a kernel reads
    it; a copy only when its dtype (or, if asked, its layout) demands one."""
    t = t.detach()
    if t.dtype != torch.float32:
        t = t.to(torch.float32)
    return t.contiguous() if contiguous and not t.is_contiguous() else t
