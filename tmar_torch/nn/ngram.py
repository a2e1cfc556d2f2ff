"""N-Gram context modules (the counterpart of ``tmar.nn.ngram``).

* ``NGramContext``: per-window unigram embedding (the grouped conv, kernel =
  stride = window), then both directional 2x2 sliding attentions over the
  sequence-reflect padded unigram grid, their token means and the 1x1 merge,
  all through ``fused_ngram_context``.
* ``NGramWindowPartition``: the map form of the JAX module's
  ``return_context="map"``: the map itself and its per-window context, for the
  fused NSTB to add per quadrant.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tmar_torch.nn.layers import Conv2d
from tmar_torch.nn.window_attention import WindowAttention
from tmar_torch.ops.cuda_ngram import fused_ngram_context


class NGramContext(nn.Module):
    def __init__(self, dim: int, window_size: int, ngram: int, ngram_num_heads: int):
        super().__init__()
        if ngram != 2:
            raise NotImplementedError("the port implements the ngram = 2 context only")
        half = dim // 2
        self.num_heads = ngram_num_heads
        # grouped conv dim -> dim/2, 2 input channels per group: the same
        # function as the JAX package's dense expansion of this kernel
        self.unigram_embed = Conv2d(dim, half, window_size, stride=window_size, groups=half)
        self.ngram_attn = WindowAttention(half, ngram_num_heads, (ngram, ngram))
        self.merge = Conv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, ph, pw, D] -> context [B, wh, ww, D] in x's dtype."""
        return fused_ngram_context(self.unigram_embed(x), *self.kernel_args())

    def kernel_args(self):
        """The weights as ``fused_ngram_context`` takes them, from ``wqkv``
        to ``num_heads``."""
        wmerge = self.merge.weight[:, :, 0, 0].t()
        return (*self.ngram_attn.params(), wmerge, self.merge.bias, self.num_heads)


class NGramWindowPartition(nn.Module):
    def __init__(self, dim: int, window_size: int, ngram: int, ngram_num_heads: int):
        super().__init__()
        self.window_size = window_size
        self.ngram_context = NGramContext(dim, window_size, ngram, ngram_num_heads)

    def forward(self, x: torch.Tensor):
        """x [B, ph, pw, D] -> (x, (wh, ww), context [B, wh, ww, D])."""
        B, ph, pw, D = x.shape
        wh, ww = ph // self.window_size, pw // self.window_size
        if wh == 0 or ww == 0:
            raise ValueError("feature map smaller than the window size")
        return x, (wh, ww), self.ngram_context(x)
