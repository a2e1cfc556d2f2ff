"""N-Gram context modules (the counterpart of ``tmar.nn.ngram``).

* ``NGramContext``: per-window unigram embedding (the grouped conv, kernel =
  stride = window), then both directional n x n sliding attentions over the
  sequence-reflect padded unigram grid (n = 1 reads the grid unpadded),
  their token means and the 1x1 merge.  With n = 2 and ``ngram_fused=True``
  (the default, as the JAX package on hardware) all of it is
  ``fused_ngram_context``: one forward kernel and, under autograd, one
  backward kernel.  With ``ngram_fused=False`` (the JAX package's
  ``TMAR_NGRAM_FUSED=0``), with any n other than 2 (the fused kernels are
  built for n = 2, as the JAX package's are), and on a window grid smaller
  than 2x2, it is the composition: both directions through ``ngram_attn``
  (the attention kernels at N = n²), the token mean and the ``merge`` conv
  under autograd.  The parameters and their names are the same in every
  form.  The plain form (``attn_backward="plain"``, the JAX package's
  ``use_pallas_attention=false``) takes the composition with the plain
  attention on every device, as the JAX package's XLA path does.
* ``NGramWindowPartition``: ``forward`` is the map form of the JAX module's
  ``return_context="map"`` (the map itself and its per-window context, for the
  fused NSTB to add per quadrant); ``windows`` is its ``return_context=True``
  (the windows of the rolled map without the context, for the token-level
  fused NSTB); ``partition`` adds the context to every window, shifts and
  partitions, for the unfused block.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmar_torch.nn.layers import Conv2d
from tmar_torch.nn.window_attention import WindowAttention
from tmar_torch.ops.cuda_ngram import fused_ngram_context
from tmar_torch.ops.ngram import ngram_windows
from tmar_torch.ops.window import cyclic_shift, window_partition

ATTN_BACKWARDS = ("auto", "pallas", "plain")


def check_attn_backward(attn_backward: str) -> str:
    if attn_backward not in ATTN_BACKWARDS:
        raise ValueError(f"attn_backward {attn_backward!r} not in {ATTN_BACKWARDS}")
    return attn_backward


class _UnigramEmbed(torch.autograd.Function):
    """The grouped conv with kernel = stride = window on an NHWC map.  Forward
    is the library's convolution.  The backward is written out, because the
    library runs a grouped conv's backward as one small kernel per group
    (thousands of launches per train step): with kernel = stride every input
    element meets exactly one weight, so dx is an outer product of the
    cotangent and the weight, and dw one contraction over the windows."""

    @staticmethod
    def forward(ctx, x, weight, bias, ws, groups):
        ctx.save_for_backward(x, weight)
        ctx.geometry = (ws, groups)
        y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), bias.to(x.dtype),
                     stride=ws, groups=groups)
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        ws, groups = ctx.geometry
        B, ph, pw, D = x.shape
        wh, ww = ph // ws, pw // ws
        t = D // groups  # input channels per group; one output channel per group
        dx = torch.einsum("bhwc,ctij->bhiwjct", g, weight.to(g.dtype))
        dx = dx.reshape(B, wh * ws, ww * ws, D)
        if (wh * ws, ww * ws) != (ph, pw):  # rows and columns no window covers
            dx = F.pad(dx, (0, 0, 0, pw - ww * ws, 0, ph - wh * ws))
        xw = x[:, : wh * ws, : ww * ws].reshape(B, wh, ws, ww, ws, groups, t)
        dw = torch.einsum("bhiwjct,bhwc->ctij", xw, g)
        return dx, dw.to(weight.dtype), g.sum(dim=(0, 1, 2)).to(weight.dtype), None, None


class NGramContext(nn.Module):
    def __init__(
        self, dim: int, window_size: int, ngram: int, ngram_num_heads: int,
        attn_backward: str = "auto", ngram_fused: bool = True,
    ):
        super().__init__()
        self.attn_backward = check_attn_backward(attn_backward)
        self.ngram_fused = bool(ngram_fused)
        self.ngram = ngram
        half = dim // 2
        self.num_heads = ngram_num_heads
        # grouped conv dim -> dim/2, 2 input channels per group: the same
        # function as the JAX package's dense expansion of this kernel
        self.unigram_embed = Conv2d(dim, half, window_size, stride=window_size, groups=half)
        self.ngram_attn = WindowAttention(half, ngram_num_heads, (ngram, ngram),
                                          plain=attn_backward == "plain")
        self.merge = Conv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, ph, pw, D] -> context [B, wh, ww, D] in x's dtype."""
        u = self._unigram(x)
        if (self.ngram != 2 or not self.ngram_fused or min(u.shape[1:3]) < 2
                or self.attn_backward == "plain"):
            return self._composition(u)
        return fused_ngram_context(u, *self.kernel_args())

    def _unigram(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, ph, pw, D] -> the unigram grid [B, wh, ww, D/2]."""
        conv = self.unigram_embed
        return _UnigramEmbed.apply(x, conv.weight, conv.bias, conv.stride[0], conv.groups)

    def _composition(self, u: torch.Tensor) -> torch.Tensor:
        B, wh, ww, C = u.shape
        if wh < self.ngram or ww < self.ngram:
            raise ValueError(
                f"the n-gram context needs a window grid of at least {self.ngram}x"
                f"{self.ngram} to reflect-pad, got {wh}x{ww}"
            )

        def direction(back: bool) -> torch.Tensor:
            tokens = ngram_windows(u, self.ngram, back=back)
            return self.ngram_attn(tokens).mean(dim=1).reshape(B, wh, ww, C)

        both = torch.cat([direction(False), direction(True)], dim=-1)
        # the 1x1 merge conv is a linear map of the channels
        wmerge = self.merge.weight[:, :, 0, 0].to(u.dtype)
        return F.linear(both, wmerge, self.merge.bias.to(u.dtype))

    def kernel_args(self):
        """The weights as ``fused_ngram_context`` takes them, from ``wqkv``
        to ``num_heads``."""
        wmerge = self.merge.weight[:, :, 0, 0].t()
        return (*self.ngram_attn.params(), wmerge, self.merge.bias, self.num_heads)


class NGramWindowPartition(nn.Module):
    def __init__(
        self, dim: int, window_size: int, ngram: int, ngram_num_heads: int,
        attn_backward: str = "auto", ngram_fused: bool = True,
    ):
        super().__init__()
        self.window_size = window_size
        self.ngram_context = NGramContext(
            dim, window_size, ngram, ngram_num_heads, attn_backward, ngram_fused
        )

    def forward(self, x: torch.Tensor):
        """x [B, ph, pw, D] -> (x, (wh, ww), context [B, wh, ww, D])."""
        B, ph, pw, D = x.shape
        wh, ww = ph // self.window_size, pw // self.window_size
        if wh == 0 or ww == 0:
            raise ValueError("feature map smaller than the window size")
        return x, (wh, ww), self.ngram_context(x)

    def windows(self, x: torch.Tensor, shift_size: int):
        """x [B, ph, pw, D] -> (windows [B*wh*ww, ws, ws, D] of the map after
        the cyclic shift, WITHOUT the context; (wh, ww); context
        [B, wh, ww, D])."""
        x, (wh, ww), context = self(x)
        wins, _ = window_partition(cyclic_shift(x, shift_size), self.window_size)
        return wins, (wh, ww), context

    def partition(self, x: torch.Tensor, shift_size: int):
        """x [B, ph, pw, D] -> (windows [B*wh*ww, ws, ws, D], (wh, ww)) of the
        map with each window's context added, after the cyclic shift."""
        x, (wh, ww), context = self(x)
        B, ph, pw, D = x.shape
        ws = self.window_size
        xw = x.reshape(B, wh, ws, ww, ws, D) + context[:, :, None, :, None, :]
        return window_partition(cyclic_shift(xw.reshape(B, ph, pw, D), shift_size), ws)
