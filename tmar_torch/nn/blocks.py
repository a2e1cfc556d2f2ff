"""NSTB — the N-Gram Swin Transformer Block (the counterpart of
``tmar.nn.blocks``), on its inference path: the whole-block fusion in map
mode, which runs exactly two kernels per block (``fused_ngram_context`` and
``fused_nstb_map``).

Post-norm residual order, as in the reference: ``x + norm1(attn(x))`` then
``x + norm2(mlp(x))``.  The block returns ``(x_in, x_out)`` so stages can
apply the within-stage residual ``next_input = out + prev_input``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tmar_torch.nn.layers import LayerNorm, Mlp
from tmar_torch.nn.ngram import NGramWindowPartition
from tmar_torch.nn.window_attention import WindowAttention
from tmar_torch.ops.cuda_nstb import context_quads, fused_nstb_map
from tmar_torch.ops.window import reverse_cyclic_shift


class NSTB(nn.Module):
    def __init__(
        self,
        dim: int,
        ngram: int,
        num_heads: int,
        window_size: int,
        shift_size: int,
        head_dim: Optional[int] = None,
        mlp_ratio: float = 2.0,
        qkv_bias: bool = True,
    ):
        super().__init__()
        if not 0 <= shift_size < window_size:
            raise ValueError(f"shift_size {shift_size} outside [0, {window_size})")
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.ngram_window_partition = NGramWindowPartition(dim, window_size, ngram, num_heads)
        self.attn = WindowAttention(dim, num_heads, (window_size, window_size), head_dim, qkv_bias)
        self.norm1 = LayerNorm(dim)
        self.ffn = Mlp(dim, int(dim * mlp_ratio), dim)
        self.norm2 = LayerNorm(dim)

    def forward(
        self, x: torch.Tensor, num_patches: Tuple[int, int]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, ph*pw, D] -> (x_in, x_out)."""
        ph, pw = num_patches
        B, p, D = x.shape
        if p != ph * pw:
            raise ValueError("token count does not match the patch grid")
        xmap, (wh, ww), ctx = self.ngram_window_partition(x.reshape(B, ph, pw, D))
        if self.shift_size == 0:
            cq = ctx.reshape(-1, 1, D)  # every token reads its own window's context
        else:
            cq = context_quads(ctx, self.shift_size).reshape(-1, 4, D)
        zmap = fused_nstb_map(
            xmap, cq, *self.kernel_args(), shift=self.shift_size, eps=self.norm1.eps
        )
        out = reverse_cyclic_shift(zmap, self.shift_size)
        return x, out.reshape(B, p, D)

    def kernel_args(self):
        """This block's weights as ``fused_nstb_map`` takes them, from
        ``wqkv`` to ``window_size``."""
        return (
            *self.attn.params(),
            (self.norm1.weight, self.norm1.bias),
            (self.ffn.fc1.weight.t(), self.ffn.fc1.bias),
            (self.ffn.fc2.weight.t(), self.ffn.fc2.bias),
            (self.norm2.weight, self.norm2.bias),
            self.num_heads,
            self.window_size,
        )
