"""Scaled-cosine window attention (SwinV2-style), plain PyTorch.

The counterpart of ``tmar.ops.attention``: L2-normalised q·kᵀ, a per-head
logit scale clamped at ln(100) then exponentiated, a relative-position bias,
an optional decomposed SW-MSA shift mask, a softmax with the row max
subtracted, then attn·v.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

LOGIT_SCALE_MAX = math.log(1.0 / 0.01)  # ln(100)


@lru_cache(maxsize=None)
def relative_position_index(win_h: int, win_w: int) -> np.ndarray:
    """int32 [win_h*win_w, win_h*win_w] index into a ((2h-1)(2w-1), nh) table:
    (ri - rj + h - 1)·(2w - 1) + (ci - cj + w - 1)."""
    coords = np.stack(np.meshgrid(np.arange(win_h), np.arange(win_w), indexing="ij"))
    coords_flat = coords.reshape(2, -1)
    rel = (coords_flat[:, :, None] - coords_flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += win_h - 1
    rel[:, :, 1] += win_w - 1
    rel[:, :, 0] *= 2 * win_w - 1
    return rel.sum(-1).astype(np.int32)


def gather_rel_pos_bias(table: torch.Tensor, index: np.ndarray, num_heads: int) -> torch.Tensor:
    """table [(2h-1)(2w-1), nh], index [N, N] -> bias [nh, N, N]."""
    n = index.shape[0]
    return static_gather(table, index).reshape(n, n, num_heads).permute(2, 0, 1)


def static_gather(x: torch.Tensor, index: np.ndarray) -> torch.Tensor:
    """x [..., R, C] and a constant integer index (any shape, M entries) into
    R -> [..., M, C].  Its backward, a scatter-add over repeated indices, is
    a gather over the fixed inverse map and a sum: deterministic on every
    device (no atomics).  ``index`` should be a long-lived array (the cached
    result of ``relative_position_index`` and the like): what is derived from
    it is cached on its identity."""
    return _StaticGather.apply(x, index)


_const_cache = {}    # id(array) -> (array, {device: tensor})
_inverse_cache = {}  # id(index) -> (index, rows, inverse)


def on_device(array: np.ndarray, device) -> torch.Tensor:
    """A constant numpy array as a contiguous tensor on ``device`` (integers
    as int64, floats as float32), copied there once per array object: a copy
    from host memory on every call would stall the CUDA stream.  While a
    trace runs (``torch.export``, ``torch.compile``, a fake-tensor mode) it
    returns a fresh tensor, which the trace records as a constant, and
    caches nothing: a cached tensor made there would be a fake one."""
    dtype = torch.long if array.dtype.kind in "iu" else torch.float32
    if tracing():
        return torch.as_tensor(np.ascontiguousarray(array), dtype=dtype, device=device)
    entry = _const_cache.get(id(array))
    if entry is None or entry[0] is not array:
        if len(_const_cache) >= 512:  # callers that pass fresh arrays every time
            _const_cache.clear()
        entry = _const_cache[id(array)] = (array, {})
    tensor = entry[1].get(device)
    if tensor is None:
        tensor = torch.as_tensor(np.ascontiguousarray(array), dtype=dtype, device=device)
        entry[1][device] = tensor
    return tensor


def tracing() -> bool:
    """True while ``torch.export`` or ``torch.compile`` traces, or a
    fake-tensor mode is active (``torch.export`` runs under one)."""
    return (torch.compiler.is_compiling()
            or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None)


def _inverse_index(index: np.ndarray, rows: int) -> np.ndarray:
    """[rows, max count] int64: for each of the ``rows`` sources, the flat
    positions of ``index`` that read it, padded with ``index.size`` (one past
    the end)."""
    entry = _inverse_cache.get(id(index))
    if entry is None or entry[0] is not index or entry[1] != rows:
        if len(_inverse_cache) >= 512:
            _inverse_cache.clear()
        flat = index.reshape(-1)
        counts = np.bincount(flat, minlength=rows)
        inv = np.full((rows, max(int(counts.max()), 1)), flat.size, np.int64)
        order = np.argsort(flat, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        for t in range(rows):
            inv[t, : counts[t]] = order[starts[t] : starts[t] + counts[t]]
        entry = _inverse_cache[id(index)] = (index, rows, inv)
    return entry[2]


class _StaticGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index):
        ctx.index = index
        ctx.rows = x.shape[-2]
        return x.index_select(-2, on_device(index, x.device).reshape(-1))

    @staticmethod
    def backward(ctx, g):
        return static_gather_transpose(g, ctx.index, ctx.rows), None


def static_gather_transpose(g: torch.Tensor, index: np.ndarray, rows: int) -> torch.Tensor:
    """The transpose of ``static_gather``: g [..., M, C], the cotangent of the
    gathered rows -> [..., rows, C], each source row the sum of its readers,
    by a gather over the fixed inverse map (no atomics)."""
    inv = on_device(_inverse_index(index, rows), g.device)
    padded = torch.cat([g, g.new_zeros(*g.shape[:-2], 1, g.shape[-1])], dim=-2)
    readers = padded.index_select(-2, inv.reshape(-1))
    # [..., rows, max count, C] summed over the readers of each row
    return readers.reshape(*g.shape[:-2], *inv.shape, g.shape[-1]).sum(-2)


def l2_normalize(t: torch.Tensor) -> torch.Tensor:
    """t / (|t| + 1e-12) over the last axis, the norm taken in float32."""
    norm = t.float().square().sum(-1, keepdim=True).sqrt() + 1e-12
    return t * norm.to(t.dtype).reciprocal()


def cosine_window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    logit_scale: torch.Tensor,
    rel_pos_bias: torch.Tensor,
    mask_components: Optional[tuple] = None,
) -> torch.Tensor:
    """q, k, v [B_, nh, N, hd]; logit_scale [nh, 1, 1] raw; rel_pos_bias
    [nh, N, N]; mask_components (m_row [N, N], m_col [N, N], wh, ww) with B_
    a multiple of wh·ww in window row-major order.  -> [B_, nh, N, hd]."""
    cd = q.dtype
    attn = torch.matmul(l2_normalize(q), l2_normalize(k).transpose(-1, -2)).float()
    scale = torch.exp(torch.clamp(logit_scale.float(), max=LOGIT_SCALE_MAX))
    attn = add_shift_mask(attn * scale[None] + rel_pos_bias.float()[None], mask_components)
    attn = torch.exp(attn - attn.amax(-1, keepdim=True))
    attn = attn / attn.sum(-1, keepdim=True)
    return torch.matmul(attn.to(cd), v)


def add_shift_mask(attn: torch.Tensor, mask_components: Optional[tuple]) -> torch.Tensor:
    """attn [B_, nh, N, N] plus the decomposed SW-MSA mask: m_row on the
    last window row of each (wh, ww) image grid, m_col on its last column."""
    if mask_components is None:
        return attn
    m_row, m_col, wh, ww = mask_components
    B_, nh, N, _ = attn.shape
    dev = attn.device
    attn = attn.reshape(B_ // (wh * ww), wh, ww, nh, N, N)
    row_gate = (torch.arange(wh, device=dev) == wh - 1).float()
    col_gate = (torch.arange(ww, device=dev) == ww - 1).float()
    attn = attn + row_gate[:, None, None, None, None] * torch.as_tensor(m_row, device=dev)
    attn = attn + col_gate[:, None, None, None] * torch.as_tensor(m_col, device=dev)
    return attn.reshape(B_, nh, N, N)


def window_attention_math(
    x, wqkv, bqkv, logit_scale, bias, wproj, bproj, num_heads, mask_components=None
):
    """qkv projection -> cosine attention -> output projection on [B_, N, D]
    windows; weights in the [in, out] layout (``x @ w``)."""
    qkv = x @ wqkv
    if bqkv is not None:
        qkv = qkv + bqkv
    q, k, v = qkv.chunk(3, dim=-1)
    out = cosine_window_attention(
        split_heads(q, num_heads),
        split_heads(k, num_heads),
        split_heads(v, num_heads),
        logit_scale,
        bias,
        mask_components=mask_components,
    )
    out = merge_heads(out) @ wproj
    if bproj is not None:
        out = out + bproj
    return out


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B_, N, nh*hd] -> [B_, nh, N, hd]."""
    B_, N, C = x.shape
    return x.reshape(B_, N, num_heads, C // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B_, nh, N, hd] -> [B_, N, nh*hd]."""
    B_, nh, N, hd = x.shape
    return x.transpose(1, 2).reshape(B_, N, nh * hd)
