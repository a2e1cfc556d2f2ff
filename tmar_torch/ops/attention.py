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
    idx = torch.as_tensor(index.reshape(-1), dtype=torch.long, device=table.device)
    return table[idx].reshape(n, n, num_heads).permute(2, 0, 1)


def _l2_normalize(t: torch.Tensor) -> torch.Tensor:
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
    attn = torch.matmul(_l2_normalize(q), _l2_normalize(k).transpose(-1, -2)).float()
    scale = torch.exp(torch.clamp(logit_scale.float(), max=LOGIT_SCALE_MAX))
    attn = attn * scale[None] + rel_pos_bias.float()[None]
    if mask_components is not None:
        m_row, m_col, wh, ww = mask_components
        B_, nh, N, _ = attn.shape
        dev = attn.device
        attn = attn.reshape(B_ // (wh * ww), wh, ww, nh, N, N)
        row_gate = (torch.arange(wh, device=dev) == wh - 1).float()
        col_gate = (torch.arange(ww, device=dev) == ww - 1).float()
        attn = attn + row_gate[:, None, None, None, None] * torch.as_tensor(m_row, device=dev)
        attn = attn + col_gate[:, None, None, None] * torch.as_tensor(m_col, device=dev)
        attn = attn.reshape(B_, nh, N, N)
    attn = torch.exp(attn - attn.amax(-1, keepdim=True))
    attn = attn / attn.sum(-1, keepdim=True)
    return torch.matmul(attn.to(cd), v)


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
