"""WindowAttention parameters (scaled-cosine, SwinV2-style), the counterpart
of ``tmar.nn.window_attention``.

The module holds ``logit_scale`` [nh, 1, 1] (initialised to ln 10), the
relative-position bias table [(2h-1)(2w-1), nh], and the ``qkv`` and
``proj`` linears, under the reference checkpoint's names.  The whole-block
inference kernels read them through ``params()``; ``forward`` is the
differentiable attention on [B_, N, D] windows, through
``fused_window_attention`` (forward and backward kernels on a CUDA tensor).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from tmar_torch.nn.layers import Linear
from tmar_torch.ops.attention import gather_rel_pos_bias, relative_position_index
from tmar_torch.ops.cuda_attention import fused_window_attention


class WindowAttention(nn.Module):
    def __init__(
        self,
        dim: int,
        num_heads: int,
        window_size: Tuple[int, int],
        head_dim: Optional[int] = None,
        qkv_bias: bool = True,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = tuple(window_size)
        hd = head_dim or dim // num_heads
        attn_dim = hd * num_heads
        win_h, win_w = self.window_size
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * win_h - 1) * (2 * win_w - 1), num_heads)
        )
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02, a=-0.04, b=0.04)
        self.qkv = Linear(dim, 3 * attn_dim, bias=qkv_bias)
        self.proj = Linear(attn_dim, dim)

    def forward(self, x: torch.Tensor, mask_components: Optional[tuple] = None) -> torch.Tensor:
        """x [B_, N, D] windows -> [B_, N, D]; mask_components is the
        decomposed shift mask (m_row, m_col, wh, ww) or None."""
        wqkv, bqkv, logit_scale, _, wproj, bproj = self.params()
        return fused_window_attention(
            x, wqkv, bqkv, logit_scale, self.bias(), wproj, bproj, self.num_heads,
            mask_components=mask_components,
        )

    def params(self):
        """(wqkv [in, 3A], bqkv, logit_scale, table, wproj [A, out], bproj)."""
        return (
            self.qkv.weight.t(), self.qkv.bias, self.logit_scale,
            self.relative_position_bias_table, self.proj.weight.t(), self.proj.bias,
        )

    def bias(self) -> torch.Tensor:
        """The gathered relative-position bias [nh, N, N]."""
        return gather_rel_pos_bias(
            self.relative_position_bias_table,
            relative_position_index(*self.window_size),
            self.num_heads,
        )
