"""Fused scaled-cosine window attention with a fused backward: CUDA kernel
wrapper (the counterpart of ``tmar.ops.pallas_attention`` with
``backward="pallas"``).

``fused_window_attention`` computes qkv projection -> cosine attention ->
output projection on [B_, N, D] windows.  Its plain version is
``tmar_torch.ops.attention.window_attention_math`` under ordinary autograd,
which a CPU tensor takes.  A CUDA tensor goes through a
``torch.autograd.Function`` whose forward launches
``csrc/window_attention_fwd.cu`` and whose backward launches
``csrc/window_attention_bwd.cu`` (all seven cotangents, recomputed from x and
the saved row-wise log-sum-exp), or raises.

The kernels compute in float32 on the float32 parameters whatever the
activation dtype; the activations and their cotangents are float32 or
bfloat16.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from tmar_torch.device import float32_data
from tmar_torch.ops.attention import LOGIT_SCALE_MAX, on_device, window_attention_math

# (N, D, num_heads, head_dim) the kernels are compiled for: the full-width
# NGswin's 8x8 windows at D = 64 and its 2x2 n-gram windows at D/2 = 32
KERNEL_GEOMETRIES = {(64, 64, 6, 10), (64, 64, 4, 16), (4, 32, 6, 5), (4, 32, 4, 8)}


def fused_window_attention(
    x: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: Optional[torch.Tensor],
    logit_scale: torch.Tensor,
    bias: torch.Tensor,
    wproj: torch.Tensor,
    bproj: Optional[torch.Tensor],
    num_heads: int,
    mask_components: Optional[Tuple] = None,
) -> torch.Tensor:
    """x [B_, N, D] -> [B_, N, D].  wqkv [D, 3A] and wproj [A, D] in the
    [in, out] layout (a transposed view is read in place), logit_scale
    [nh, 1, 1] raw, bias the gathered relative-position bias [nh, N, N],
    mask_components (m_row [N, N], m_col [N, N], wh, ww) as
    ``cosine_window_attention`` takes them.  Differentiable in all seven
    tensor arguments.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernels (float32 or bfloat16) or raises."""
    if x.device.type == "cpu":
        cd = x.dtype
        return window_attention_math(
            x, wqkv.to(cd), None if bqkv is None else bqkv.to(cd), logit_scale, bias,
            wproj.to(cd), None if bproj is None else bproj.to(cd), num_heads,
            mask_components=mask_components,
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_window_attention: unsupported device {x.device}")
    return _WindowAttention.apply(
        x, wqkv, bqkv, logit_scale, bias, wproj, bproj, num_heads, mask_components
    )


fused_window_attention.launches = 0           # forward kernel
fused_window_attention.backward_launches = 0  # backward kernel


def _geometry(x, wqkv, num_heads):
    B_, N, D = x.shape
    A = wqkv.shape[1] // 3
    if A % num_heads or (N, D, num_heads, A // num_heads) not in KERNEL_GEOMETRIES:
        raise NotImplementedError(
            "window attention kernels are built for (N, D, heads, head_dim) in "
            f"{sorted(KERNEL_GEOMETRIES)}; got N={N}, D={D}, heads={num_heads}, A={A}"
        )
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_window_attention: unsupported dtype {x.dtype}")
    if B_ < 1:
        raise ValueError("fused_window_attention: no windows")
    return B_, N, D, A


def _device_mask(mask_components, N, nwin, device):
    """The decomposed shift mask on the device: (m_row, m_col, wh, ww), or
    (None, None, 0, 0) without a mask."""
    if mask_components is None:
        return None, None, 0, 0
    m_row, m_col, wh, ww = mask_components
    if nwin % (wh * ww):
        raise ValueError(f"{nwin} windows are not a multiple of the {wh}x{ww} grid")
    for m in (m_row, m_col):
        if np.shape(m) != (N, N):
            raise ValueError(f"mask component shape {np.shape(m)} != {(N, N)}")
    return on_device(m_row, device), on_device(m_col, device), int(wh), int(ww)


def _ptr(t):
    return None if t is None else t.data_ptr()


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, logit_scale, bias, wproj, bproj, num_heads, mask_components):
        from tmar_torch import kernels

        B_, N, D, A = _geometry(x, wqkv, num_heads)
        dev = x.device
        x = x.detach().contiguous()
        w_qkv, w_proj = float32_data(wqkv), float32_data(wproj)
        b_qkv = torch.zeros(3 * A, device=dev) if bqkv is None else float32_data(bqkv, True)
        b_proj = torch.zeros(D, device=dev) if bproj is None else float32_data(bproj, True)
        scale = torch.exp(
            torch.clamp(float32_data(logit_scale).reshape(num_heads), max=LOGIT_SCALE_MAX)
        )
        bias32 = float32_data(bias, True)
        if tuple(bias32.shape) != (num_heads, N, N):
            raise ValueError(f"bias shape {tuple(bias32.shape)} != {(num_heads, N, N)}")
        m_row, m_col, wh, ww = _device_mask(mask_components, N, B_, dev)
        out = torch.empty_like(x)
        lse = torch.empty((B_, num_heads, N), device=dev, dtype=torch.float32)
        blocks = min((B_ * N + 63) // 64, kernels.sm_count(dev))
        ints = (
            B_, N, num_heads, A // num_heads, *w_qkv.stride(), *w_proj.stride(),
            wh, ww, blocks, int(x.dtype == torch.bfloat16),
        )
        kernels.launch(
            "window_attention_fwd", _FWD_ARGTYPES, dev,
            x.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(), scale.data_ptr(),
            bias32.data_ptr(), w_proj.data_ptr(), b_proj.data_ptr(), _ptr(m_row),
            _ptr(m_col), out.data_ptr(), lse.data_ptr(), *ints,
        )
        fused_window_attention.launches += 1
        ctx.save_for_backward(x, w_qkv, b_qkv, scale, bias32, w_proj, lse, logit_scale)
        ctx.mask = (m_row, m_col)
        ctx.ints = ints
        ctx.grad_dtypes = [
            None if t is None else t.dtype for t in (wqkv, bqkv, logit_scale, bias, wproj, bproj)
        ]
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from tmar_torch import kernels

        x, w_qkv, b_qkv, scale, bias32, w_proj, lse, logit_scale = ctx.saved_tensors
        m_row, m_col = ctx.mask
        B_, N, nh, hd = ctx.ints[:4]
        blocks = ctx.ints[-2]
        D, A = x.shape[-1], nh * hd
        dev = x.device
        g = g.to(x.dtype).contiguous()
        sizes = [D * 3 * A, 3 * A, nh, nh * N * N, A * D, D]
        dx = torch.empty_like(x)
        part = torch.empty((blocks, sum(sizes)), device=dev, dtype=torch.float32)
        dparams = torch.empty(sum(sizes), device=dev, dtype=torch.float32)
        kernels.launch(
            "window_attention_bwd", _BWD_ARGTYPES, dev,
            x.data_ptr(), g.data_ptr(), w_qkv.data_ptr(), b_qkv.data_ptr(),
            scale.data_ptr(), bias32.data_ptr(), w_proj.data_ptr(), _ptr(m_row),
            _ptr(m_col), lse.data_ptr(), dx.data_ptr(), part.data_ptr(),
            dparams.data_ptr(), *ctx.ints,
        )
        fused_window_attention.backward_launches += 1
        dwqkv, dbqkv, dscale, dbias, dwproj, dbproj = torch.split(dparams, sizes)
        # the kernel's cotangent is on the effective scale exp(min(ls, ln 100)):
        # d/d ls = scale below the clip, zero above it
        ls = logit_scale.detach().to(torch.float32).reshape(nh)
        dls = (dscale * scale * (ls <= LOGIT_SCALE_MAX)).reshape(logit_scale.shape)
        grads = [
            dwqkv.reshape(D, 3 * A), dbqkv, dls, dbias.reshape(nh, N, N),
            dwproj.reshape(A, D), dbproj,
        ]
        grads = [None if dt is None else t.to(dt) for t, dt in zip(grads, ctx.grad_dtypes)]
        return (dx, *grads, None, None)


_P = ctypes.c_void_p
_FWD_ARGTYPES = [_P] * 11 + [ctypes.c_int] * 12 + [_P]
_BWD_ARGTYPES = [_P] * 13 + [ctypes.c_int] * 12 + [_P]
