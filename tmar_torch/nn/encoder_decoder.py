"""Encoder/decoder stages, patch merging, pools and the SCDP bottleneck (the
counterpart of ``tmar.nn.encoder_decoder``), on NHWC maps and [B, N, D]
tokens.

* ``EncoderLayer``: optional across-cascade projection, ``depth`` NSTBs with
  alternating shift 0 / ws/2 and the within-stage residual
  ``next_in = out_i + in_i``; an optional PatchMerging tail applied to
  ``out_last + in_last``.
* ``PatchMerging``: 2x2 concat -> LayerNorm(4D) -> Linear 4D -> D (no bias).
* ``SCDPBottleneck``: pixel-shuffle each stage output (plus the pooled
  shallow skip) to full resolution, concat, depthwise 3x3 + GELU, pointwise
  Linear, LayerNorm.
* ``DecoderLayer``: an NSTB stack with the same within-stage residual.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmar_torch.nn.blocks import NSTB
from tmar_torch.nn.layers import Conv2d, LayerNorm, Linear


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool of [B, H, W, C] (H, W even)."""
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def pixel_shuffle_permute(
    x: torch.Tensor, num_patches: Tuple[int, int], out_size: Tuple[int, int]
) -> torch.Tensor:
    """[B, h*w, D] -> [B, (h*s)*(w*s), D/s²] with the '(c ch cw)' channel split."""
    h, w = num_patches
    s_h = out_size[0] // h
    s_w = out_size[1] // w
    B, N, D = x.shape
    c = D // (s_h * s_w)
    x = x.reshape(B, h, w, c, s_h, s_w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, h * s_h * w * s_w, c)


class ShallowExtractor(nn.Module):
    def __init__(self, in_chans: int, out_chans: int):
        super().__init__()
        self.conv1 = Conv2d(in_chans, out_chans, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1(x)


class InterPool(nn.Module):
    """MaxPool2d(2) re-embedding for the across-stage pooling cascade."""

    def forward(self, x: torch.Tensor, num_patches: Tuple[int, int]) -> torch.Tensor:
        B, N, C = x.shape
        y = max_pool2(x.reshape(B, *num_patches, C))
        return y.reshape(B, -1, C)


class BottleneckPool(nn.Module):
    """``exp`` max pools then LeakyReLU(0.01), for the shallow-skip injection."""

    def forward(self, x: torch.Tensor, exp: int) -> torch.Tensor:
        for _ in range(exp):
            x = max_pool2(x)
        x = F.leaky_relu(x, negative_slope=0.01)
        return x.reshape(x.shape[0], -1, x.shape[-1])


class PatchMerging(nn.Module):
    def __init__(self, dim: int, downsample_dim: Optional[int] = None):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, downsample_dim or dim, bias=False)

    def forward(self, x: torch.Tensor, num_patches: Tuple[int, int]):
        ph, pw = num_patches
        B, p, D = x.shape
        if p != ph * pw or ph % 2 or pw % 2:
            raise ValueError(f"PatchMerging needs an even {ph}x{pw} grid of {p} tokens")
        img = x.reshape(B, ph, pw, D)
        merged = torch.cat(
            [img[:, 0::2, 0::2], img[:, 0::2, 1::2], img[:, 1::2, 0::2], img[:, 1::2, 1::2]],
            dim=-1,
        ).reshape(B, (ph // 2) * (pw // 2), 4 * D)
        return self.reduction(self.norm(merged)), (ph // 2, pw // 2)


def _stage_blocks(dim, ngram, depth, num_heads, window_size, head_dim, mlp_ratio, qkv_bias,
                  **form):
    """``depth`` NSTBs with alternating shift 0 / ws/2; ``form`` holds the
    block-form arguments (``attn_backward``, ``ngram_fused``, ``nstb_fused``,
    ``nstb_map``)."""
    return nn.ModuleList(
        NSTB(
            dim, ngram, num_heads, window_size,
            shift_size=0 if i % 2 == 0 else window_size // 2,
            head_dim=head_dim, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, **form,
        )
        for i in range(depth)
    )


def _run_blocks(blocks, x, num_patches):
    """The within-stage residual: block i sees out_{i-1} + in_{i-1}.
    Returns (last block's input, last block's output)."""
    x_prev_in = 0.0
    for blk in blocks:
        x_prev_in, x = blk(x + x_prev_in, num_patches)
    return x_prev_in, x


class EncoderLayer(nn.Module):
    def __init__(
        self,
        dim: int,
        ngram: int,
        depth: int,
        num_heads: int,
        window_size: int,
        head_dim: Optional[int] = None,
        mlp_ratio: float = 2.0,
        qkv_bias: bool = True,
        downsample: bool = False,
        downsample_dim: Optional[int] = None,
        num_cas: int = 1,
        attn_backward: str = "auto",
        ngram_fused: bool = True,
        nstb_fused: bool = True,
        nstb_map: bool = True,
    ):
        super().__init__()
        self.across_cascade_proj = Linear(num_cas * dim, dim) if num_cas != 1 else None
        self.blocks = _stage_blocks(
            dim, ngram, depth, num_heads, window_size, head_dim, mlp_ratio, qkv_bias,
            attn_backward=attn_backward, ngram_fused=ngram_fused, nstb_fused=nstb_fused,
            nstb_map=nstb_map,
        )
        self.downsample = PatchMerging(dim, downsample_dim) if downsample else None

    def forward(self, x: torch.Tensor, num_patches: Tuple[int, int]):
        """-> (last block output, downsampled map or that output, new grid)."""
        if self.across_cascade_proj is not None:
            x = self.across_cascade_proj(x)
        x_prev_in, x = _run_blocks(self.blocks, x, num_patches)
        if self.downsample is None:
            return x, x, num_patches
        x_down, new_np = self.downsample(x + x_prev_in, num_patches)
        return x, x_down, new_np


class SCDPBottleneck(nn.Module):
    def __init__(self, num_encoder_stages: int, enc_dim: int, dec_dim: int):
        super().__init__()
        self.num_encoder_stages = num_encoder_stages
        concat_dim = sum(4**i for i in range(num_encoder_stages)) * (enc_dim // 16)
        self.bottleneck_pool = BottleneckPool()
        self.depthwise = Conv2d(concat_dim, concat_dim, 3, padding=1, groups=concat_dim)
        self.pointwise = Linear(concat_dim, dec_dim)
        self.norm = LayerNorm(dec_dim)

    def forward(
        self,
        shallow: torch.Tensor,
        x_list: List[torch.Tensor],
        num_patches_list: List[Tuple[int, int]],
    ):
        """shallow [B, H, W, D]; x_list of [B, N_i, D] stage outputs."""
        if len(x_list) != self.num_encoder_stages:
            raise ValueError("one stage output per encoder stage expected")
        out_np = num_patches_list[0]
        x = torch.cat(
            [
                pixel_shuffle_permute(
                    x + self.bottleneck_pool(shallow, i), num_patches_list[i], out_np
                )
                for i, x in enumerate(x_list)
            ],
            dim=-1,
        )
        B, N, C = x.shape
        img = F.gelu(self.depthwise(x.reshape(B, *out_np, C)), approximate="none")
        x = self.pointwise(img.reshape(B, N, C))
        return self.norm(x), out_np


class DecoderLayer(nn.Module):
    def __init__(
        self,
        dim: int,
        ngram: int,
        depth: int,
        num_heads: int,
        window_size: int,
        head_dim: Optional[int] = None,
        mlp_ratio: float = 2.0,
        qkv_bias: bool = True,
        attn_backward: str = "auto",
        ngram_fused: bool = True,
        nstb_fused: bool = True,
        nstb_map: bool = True,
    ):
        super().__init__()
        self.blocks = _stage_blocks(
            dim, ngram, depth, num_heads, window_size, head_dim, mlp_ratio, qkv_bias,
            attn_backward=attn_backward, ngram_fused=ngram_fused, nstb_fused=nstb_fused,
            nstb_map=nstb_map,
        )

    def forward(self, x: torch.Tensor, num_patches: Tuple[int, int]) -> torch.Tensor:
        return _run_blocks(self.blocks, x, num_patches)[1]
