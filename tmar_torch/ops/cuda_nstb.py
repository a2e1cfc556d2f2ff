"""A whole NSTB on the feature map: plain version and CUDA kernel wrapper.

The counterpart of ``tmar.ops.pallas_nstb`` (map mode).  The n-gram context
is added per window BEFORE the cyclic shift, so after a roll by ``shift``
each shifted window covers a 2x2 neighbourhood of pre-shift windows and its
context is constant per quadrant: ``ctx_tok = sel @ ctx_quads[window]``.
Then

    x_attn = x + ctx_tok
    a      = window_attention(x_attn)
    y      = x + LN1(a)                      (residual WITHOUT the context)
    z      = y + LN2(fc2(GELU(fc1(y))))

``fused_nstb_map`` runs the plain version for a CPU tensor and launches
``csrc/nstb_map.cu`` for a CUDA tensor.  Both return the block output in
ROLLED space; the caller applies the reverse cyclic shift.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from tmar_torch.device import refuse_grad
from tmar_torch.ops.attention import (
    LOGIT_SCALE_MAX,
    gather_rel_pos_bias,
    relative_position_index,
    window_attention_math,
)
from tmar_torch.ops.ffn import ffn_math
from tmar_torch.ops.window import (
    cyclic_shift,
    shift_mask_components,
    window_partition,
    window_unpartition,
)

# (num_heads, head_dim) pairs the kernel is compiled for: the full-width
# NGswin's 6-head (A = 60) and 4-head (A = 64) blocks at D = 64
KERNEL_HEADS = {(6, 10), (4, 16)}


def quadrant_selector(window_size: int, shift_size: int) -> np.ndarray:
    """[N, 4] one-hot: token (r, c) -> which pre-shift window (own / right /
    down / down-right) its context comes from after a roll by ``shift_size``."""
    ws = window_size
    sel = np.zeros((ws * ws, 4), np.float32)
    for r in range(ws):
        for c in range(ws):
            qr = 1 if (shift_size > 0 and r >= ws - shift_size) else 0
            qc = 1 if (shift_size > 0 and c >= ws - shift_size) else 0
            sel[r * ws + c, 2 * qr + qc] = 1.0
    return sel


def context_quads(ctx: torch.Tensor, shift_size: int) -> torch.Tensor:
    """ctx [B, wh, ww, D] -> [B, wh, ww, 4, D]: each window's own context and
    its right / down / down-right neighbours (cyclic)."""
    if shift_size == 0:
        return ctx[:, :, :, None, :].expand(*ctx.shape[:3], 4, ctx.shape[-1])
    right = torch.roll(ctx, -1, dims=2)
    down = torch.roll(ctx, -1, dims=1)
    downright = torch.roll(down, -1, dims=2)
    return torch.stack([ctx, right, down, downright], dim=3)


def nstb_math(
    x, ctx_quads, sel,
    wqkv, bqkv, logit_scale, bias, wproj, bproj,
    g1, b1, w1, bw1, w2, bw2, g2, b2,
    num_heads, mask_components=None, eps=1e-5,
):
    """Token-level NSTB: x [B_, N, D] context-free rolled windows,
    ctx_quads [B_, Q, D], sel [N, Q], bias the gathered RPB [nh, N, N]."""
    B_, N, D = x.shape
    sel_t = torch.as_tensor(sel, dtype=torch.float32, device=x.device)
    ctx_tok = torch.einsum("nq,bqd->bnd", sel_t, ctx_quads.float())
    x_attn = (x.float() + ctx_tok).to(x.dtype)
    a = window_attention_math(
        x_attn, wqkv, bqkv, logit_scale, bias, wproj, bproj,
        num_heads=num_heads, mask_components=mask_components,
    )
    z = ffn_math(
        x.reshape(B_ * N, D), a.reshape(B_ * N, D).to(x.dtype),
        g1, b1, w1, bw1, w2, bw2, g2, b2, eps=eps,
    )
    return z.reshape(B_, N, D)


def nstb_map_math(
    xmap, ctx_quads, wqkv, bqkv, logit_scale, table, wproj, bproj,
    ln1, ffn1, ffn2, ln2, *, num_heads, window_size, shift=0, eps=1e-5,
):
    """Plain version of the map-level block: roll, partition, ``nstb_math``,
    unpartition.  Arguments as in ``fused_nstb_map``."""
    B, ph, pw, D = xmap.shape
    ws = window_size
    N = ws * ws
    wh, ww = ph // ws, pw // ws
    sel, mask_components = _selector_and_mask(ctx_quads.shape[1], ws, shift, wh, ww)
    bias = gather_rel_pos_bias(table, relative_position_index(ws, ws), num_heads)
    wins, _ = window_partition(cyclic_shift(xmap, shift), ws)
    # matrices and attention biases in the activation dtype; LayerNorm and
    # FFN biases stay float32 (as the JAX block passes them)
    cd = xmap.dtype
    opt = lambda t: None if t is None else t.to(cd)  # noqa: E731
    z = nstb_math(
        wins.reshape(-1, N, D), ctx_quads.to(cd), sel, wqkv.to(cd), opt(bqkv),
        logit_scale, bias, wproj.to(cd), opt(bproj), ln1[0], ln1[1],
        ffn1[0].to(cd), ffn1[1], ffn2[0].to(cd), ffn2[1], ln2[0], ln2[1],
        num_heads=num_heads, mask_components=mask_components, eps=eps,
    )
    return window_unpartition(z.reshape(-1, ws, ws, D), (wh, ww))


def _selector_and_mask(Q, ws, shift, wh, ww):
    """Q = 1: every token reads its own window's context; Q = 4: the 2x2
    quadrant selector.  The shift mask exists only for shifted blocks."""
    sel = np.ones((ws * ws, 1), np.float32) if Q == 1 else quadrant_selector(ws, shift)
    mask = None
    if shift > 0:
        m_row, m_col = shift_mask_components(ws, shift)
        mask = (m_row, m_col, wh, ww)
    return sel, mask


def fused_nstb_map(
    xmap: torch.Tensor,
    ctx_quads: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: Optional[torch.Tensor],
    logit_scale: torch.Tensor,
    table: torch.Tensor,
    wproj: torch.Tensor,
    bproj: Optional[torch.Tensor],
    ln1: Tuple[torch.Tensor, torch.Tensor],
    ffn1: Tuple[torch.Tensor, torch.Tensor],
    ffn2: Tuple[torch.Tensor, torch.Tensor],
    ln2: Tuple[torch.Tensor, torch.Tensor],
    num_heads: int,
    window_size: int,
    shift: int = 0,
    eps: float = 1e-5,
) -> torch.Tensor:
    """xmap [B, ph, pw, D]: the UNROLLED, context-free map.  ctx_quads
    [B·wh·ww, Q, D] in window row-major order, Q = 1 (own context) or 4 (the
    2x2 pre-shift neighbourhood).  wqkv [D, 3A], wproj [A, D], ffn1 = (w1
    [D, H], b1), ffn2 = (w2 [H, D], b2) in the [in, out] layout; ln1/ln2 =
    (gain, bias); table [(2ws-1)², nh] is the relative-position bias table.
    Returns the block output [B, ph, pw, D] in ROLLED space.  A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel or raises.  The
    kernel is forward-only: with autograd on and an argument that requires
    grad it raises (train in the block's training form instead)."""
    if xmap.device.type == "cpu":
        return nstb_map_math(
            xmap, ctx_quads, wqkv, bqkv, logit_scale, table, wproj, bproj,
            ln1, ffn1, ffn2, ln2, num_heads=num_heads, window_size=window_size,
            shift=shift, eps=eps,
        )
    if xmap.device.type != "cuda":
        raise ValueError(f"fused_nstb_map: unsupported device {xmap.device}")
    refuse_grad(
        "fused_nstb_map",
        (xmap, ctx_quads, wqkv, bqkv, logit_scale, table, wproj, bproj, *ln1, *ffn1, *ffn2, *ln2),
    )
    operands, out, ints = _kernel_operands(
        xmap, ctx_quads, wqkv, bqkv, logit_scale, table, wproj, bproj,
        ln1, ffn1, ffn2, ln2, num_heads, window_size, shift,
    )
    _launch(operands, out, ints, eps)
    return out


def _kernel_operands(
    xmap, ctx_quads, wqkv, bqkv, logit_scale, table, wproj, bproj,
    ln1, ffn1, ffn2, ln2, num_heads, window_size, shift,
):
    """Check the geometry and lay out the kernel's operands on xmap's device:
    returns (the 16 input tensors in the C entry point's order, the output,
    the entry point's integer arguments)."""
    B, ph, pw, D = xmap.shape
    A = wqkv.shape[1] // 3
    H = ffn1[0].shape[1]
    Q = ctx_quads.shape[1]
    if (
        (window_size, D, H) != (8, 64, 128)
        or A % num_heads
        or (num_heads, A // num_heads) not in KERNEL_HEADS
    ):
        raise NotImplementedError(
            f"nstb_map kernel is built for window 8, D=64, H=128, (heads, head_dim) "
            f"in {sorted(KERNEL_HEADS)}; got window {window_size}, D={D}, H={H}, "
            f"heads={num_heads}, A={A}"
        )
    wh, ww = ph // 8, pw // 8
    if ph % 8 or pw % 8 or not 0 <= shift < 8 or Q not in (1, 4):
        raise ValueError(f"fused_nstb_map: bad geometry {tuple(xmap.shape)}, Q={Q}, shift={shift}")
    if tuple(ctx_quads.shape) != (B * wh * ww, Q, D):
        raise ValueError(f"ctx_quads shape {tuple(ctx_quads.shape)} != {(B * wh * ww, Q, D)}")
    if xmap.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_nstb_map: unsupported dtype {xmap.dtype}")
    dev, cd = xmap.device, xmap.dtype

    def f32(t):
        return t.detach().to(device=dev, dtype=torch.float32).contiguous()

    def mat(t):
        return t.detach().to(device=dev, dtype=cd).contiguous()

    operands = [
        xmap.contiguous(),
        ctx_quads.to(cd).contiguous(),
        mat(wqkv),
        torch.zeros(3 * A, device=dev) if bqkv is None else f32(bqkv),
        torch.exp(torch.clamp(f32(logit_scale).reshape(num_heads), max=LOGIT_SCALE_MAX)),
        f32(table),
        mat(wproj),
        torch.zeros(D, device=dev) if bproj is None else f32(bproj),
        f32(ln1[0]), f32(ln1[1]),
        mat(ffn1[0]), f32(ffn1[1]),
        mat(ffn2[0]), f32(ffn2[1]),
        f32(ln2[0]), f32(ln2[1]),
    ]
    ints = (B, ph, pw, Q, shift, num_heads, A // num_heads, int(cd == torch.bfloat16))
    return operands, torch.empty_like(operands[0]), ints


fused_nstb_map.launches = 0

_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def _launch(operands, out, ints, eps):
    from tmar_torch import kernels

    kernels.launch(
        "nstb_map", _ARGTYPES, out.device,
        *[t.data_ptr() for t in operands], out.data_ptr(), *ints, float(eps),
    )
    fused_nstb_map.launches += 1
