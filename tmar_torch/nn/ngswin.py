"""NGswin generator, the N-Gram Swin encoder-decoder restoration transformer
(the counterpart of ``tmar.nn.ngswin``), in NHWC.

Three encoder stages (depths 6/4/4, patch merging after stages 1-2) with
across-stage pooling cascading, the SCDP bottleneck, a depth-6 decoder at
full resolution with an encoder-stage-1 skip, a global shallow residual, and
a two-conv head with tanh.  Input and output are [B, H, W, C] in [-1, 1]; H
and W are padded to multiples of 4·window_size and cropped back.

``attn_backward`` selects the form of every block as in the JAX package:
``"auto"`` is the inference form (two forward-only kernels per block),
``"pallas"`` the training form (attention and FFN kernels with backwards),
``"plain"`` the JAX package's ``use_pallas_attention=false`` path as torch
ops on every device (the form tensor parallelism splits).
``ngram_fused`` (default True, as the JAX package on hardware, where its
``TMAR_NGRAM_FUSED`` environment variable decides) sends every block's
n-gram context through ``fused_ngram_context``, forward and backward
kernels; False sends it down the composition path.  In the inference form
``nstb_fused`` and ``nstb_map`` pick the block form as the JAX package's
``TMAR_NSTB_FUSED`` and ``TMAR_NSTB_MAP`` do (``tmar_torch.nn.blocks``); the
training form ignores them.  Every form
holds the same parameters under the same names.

Submodule names follow the reference checkpoint layout, so a reference
``state_dict`` (``flagship.pth``) loads key for key.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tmar_torch.device import resolve_device
from tmar_torch.nn.encoder_decoder import (
    DecoderLayer,
    EncoderLayer,
    InterPool,
    SCDPBottleneck,
    ShallowExtractor,
)
from tmar_torch.nn.layers import Conv2d, LayerNorm, init_weights
from tmar_torch.ops.window import pad_to_multiple


class _Head(nn.Module):
    """The reconstruction convs, named ``to_target.{before_shuffle,to_origin}``."""

    def __init__(self, dim: int, in_chans: int):
        super().__init__()
        self.before_shuffle = Conv2d(dim, in_chans, 3, padding=1)
        self.to_origin = Conv2d(in_chans, in_chans, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.to_origin(self.before_shuffle(x))


class NGswin(nn.Module):
    def __init__(
        self,
        ngrams: Tuple[int, ...] = (2, 2, 2, 2),
        in_chans: int = 1,
        embed_dim: int = 64,
        depths: Tuple[int, ...] = (6, 4, 4),
        num_heads: Tuple[int, ...] = (6, 4, 4),
        head_dim: Optional[int] = None,
        dec_dim: int = 64,
        dec_depths: int = 6,
        dec_num_heads: int = 6,
        dec_head_dim: Optional[int] = None,
        window_size: int = 8,
        mlp_ratio: float = 2.0,
        qkv_bias: bool = True,
        dtype: torch.dtype = torch.float32,
        attn_backward: str = "auto",
        ngram_fused: bool = True,
        nstb_fused: bool = True,
        nstb_map: bool = True,
        device="cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        self.ngrams = tuple(ngrams)
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.num_heads = tuple(num_heads)
        self.dec_dim = dec_dim
        self.dec_depths = dec_depths
        self.dec_num_heads = dec_num_heads
        self.window_size = window_size
        self.mlp_ratio = mlp_ratio
        self.dtype = dtype
        self.attn_backward = attn_backward
        self.ngram_fused = ngram_fused
        form = dict(attn_backward=attn_backward, ngram_fused=ngram_fused, nstb_fused=nstb_fused,
                    nstb_map=nstb_map)
        n_enc = len(self.depths)

        self.shallow_extract = ShallowExtractor(in_chans, embed_dim)
        self.inter_pool = InterPool()
        for i in range(n_enc):
            last = i + 1 == n_enc
            self.add_module(f"encoder_layer{i + 1}", EncoderLayer(
                embed_dim, self.ngrams[i], self.depths[i], self.num_heads[i], window_size,
                head_dim=head_dim, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                downsample=not last, downsample_dim=None if last else embed_dim,
                num_cas=i + 1, **form,
            ))
        self.bottleneck = SCDPBottleneck(n_enc, embed_dim, dec_dim)
        self.decoder_layer1 = DecoderLayer(
            dec_dim, self.ngrams[n_enc], dec_depths, dec_num_heads, window_size,
            head_dim=dec_head_dim, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, **form,
        )
        self.norm = LayerNorm(dec_dim)
        self.to_target = _Head(dec_dim, in_chans)
        self.apply(init_weights)
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] in [-1, 1] -> restored [B, H, W, C] (float32)."""
        x, (H_ori, W_ori) = pad_to_multiple(x.to(self.dtype), 4 * self.window_size)
        B, H, W, C = x.shape
        n_enc = len(self.depths)

        shallow = self.shallow_extract(x)
        c0 = shallow.reshape(B, H * W, -1)

        cas, num_patches = c0, (H, W)
        pre_merge, np_list = [], []
        for i in range(n_enc):
            np_list.append(num_patches)
            e_, e_down, num_patches_next = getattr(self, f"encoder_layer{i + 1}")(
                cas, num_patches
            )
            pre_merge.append(e_)
            if i + 1 < n_enc:
                cas = torch.cat([self.inter_pool(cas, num_patches), e_down], dim=-1)
            num_patches = num_patches_next

        bottleneck_out, np_scdp = self.bottleneck(shallow, pre_merge, np_list)
        dec = self.decoder_layer1(bottleneck_out + pre_merge[0], np_scdp)
        dec = self.norm(dec) + c0

        img = self.to_target(dec.reshape(B, H, W, -1))
        return torch.tanh(img.float())[:, :H_ori, :W_ori, :]

    def fsdp_units(self):
        """The modules FSDP shards one by one: every block, then every stage."""
        stages = [m for n, m in self.named_children() if n.startswith(("encoder_layer", "decoder_layer"))]
        return [b for s in stages for b in s.blocks] + stages

    def flops(self, resolution: Tuple[int, int]) -> int:
        """Analytic FLOPs (multiply-adds, counted as the reference's flops())
        for an HxW input, padded as ``forward`` pads it."""
        unit = 4 * self.window_size
        H = resolution[0] + (-resolution[0]) % unit
        W = resolution[1] + (-resolution[1]) % unit
        D = self.embed_dim
        ws = self.window_size
        total = H * W * 9 * self.in_chans * D + H * W * D

        def win_attn_flops(dim, heads, area, num_windows):
            f = area * dim * 3 * dim + 3 * dim
            f += heads * area * (dim // heads) * area * 2
            f += area * dim * dim + dim
            return f * num_windows

        def nstb_flops(h, w, dim, heads, ngram):
            wh, ww = h // ws, w // ws
            f = wh * ww * ws * ws * dim + wh * ww * dim
            f += 2 * win_attn_flops(dim // 2, heads, ngram * ngram, wh * ww)
            f += wh * ww * 4 * dim + wh * ww * dim * dim
            f += win_attn_flops(dim, heads, ws * ws, wh * ww)
            f += 2 * h * w * dim
            f += h * w * dim * int(self.mlp_ratio * dim) * 2
            return f

        for i, depth in enumerate(self.depths):
            h, w = H // 2**i, W // 2**i
            if i > 0:
                total += h * w * (i + 1) * D * D
                total += h * w * 4 * (i * D)
            for _ in range(depth):
                total += nstb_flops(h, w, D, self.num_heads[i], self.ngrams[i])
            if i + 1 != len(self.depths):
                total += h * w * 4 * D + (h // 2) * (w // 2) * 4 * D * D
        concat_dim = sum(4**j for j in range(len(self.depths))) * (D // 16)
        total += H * W * (9 + 2) * concat_dim + H * W * concat_dim * self.dec_dim
        for _ in range(self.dec_depths):
            total += nstb_flops(H, W, self.dec_dim, self.dec_num_heads, self.ngrams[-1])
        total += H * W * self.dec_dim
        total += H * W * 9 * self.dec_dim * self.in_chans + H * W * 9 * self.in_chans
        return int(total)
