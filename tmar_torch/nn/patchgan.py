"""Multi-scale conditional PatchGAN discriminator with spectral norm (the
counterpart of ``tmar.nn.patchgan``), on NHWC tensors.

* ``SingleScaleDiscriminator``: ``num_layers`` 4x4 convs with strides
  (2, 2, 2, 2, 1) and padding 1, channels in -> 64 -> 128 -> 256 -> 512 ->
  512 (doubling capped at 8 x base), LeakyReLU(0.2) after all but the last,
  then a 1x1 logit conv; spectral norm on every conv.  Returns (logits,
  [the features after each of the first ``num_layers - 1`` convs]).
* ``MultiScaleDiscriminator``: ``num_scales`` independent single-scale
  discriminators over the input at 1x, 1/2x, 1/4x (2x2 average pools).
  Input: concat([condition, real or fake]) on the channel axis.
* ``ConditionalDiscriminator``: the legacy pix2pix-style single
  discriminator with instance norm.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmar_torch.device import resolve_device
from tmar_torch.nn.layers import Conv2d
from tmar_torch.nn.spectral_norm import SNConv


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool of [B, H, W, C]; an odd last row or column
    is dropped."""
    B, H, W, C = x.shape
    x = x[:, : H // 2 * 2, : W // 2 * 2]
    return x.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))


def _conv(in_ch, out_ch, kernel, stride, padding, use_sn, generator):
    if use_sn:
        return SNConv(in_ch, out_ch, kernel, stride, padding, generator=generator)
    conv = Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding)
    nn.init.normal_(conv.weight, std=0.02, generator=generator)
    nn.init.zeros_(conv.bias)
    return conv


class SingleScaleDiscriminator(nn.Module):
    def __init__(
        self,
        in_chans: int = 2,
        base_channels: int = 64,
        num_layers: int = 5,
        use_sn: bool = True,
        generator: torch.Generator = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.use_sn = use_sn
        ch_in, ch_out = in_chans, base_channels
        for i in range(num_layers):
            stride = 1 if i == num_layers - 1 else 2
            self.add_module(f"conv_{i}", _conv(ch_in, ch_out, 4, stride, 1, use_sn, generator))
            ch_in = ch_out
            if i < num_layers - 2:
                ch_out = min(ch_out * 2, base_channels * 8)
        self.final_conv = _conv(ch_in, 1, 1, 1, 0, use_sn, generator)

    def _apply_conv(self, conv, h, update_sn):
        return conv(h, update_sn=update_sn) if self.use_sn else conv(h)

    def forward(self, x: torch.Tensor, update_sn: bool = False, return_features: bool = True):
        feats: List[torch.Tensor] = []
        h = x
        for i in range(self.num_layers):
            h = self._apply_conv(getattr(self, f"conv_{i}"), h, update_sn)
            if i != self.num_layers - 1:
                h = F.leaky_relu(h, negative_slope=0.2)
            if return_features and i < self.num_layers - 1:
                feats.append(h)
        if h.shape[1] < 1 or h.shape[2] < 1:
            raise ValueError(
                f"input too small for a {self.num_layers}-layer PatchGAN "
                f"(empty {tuple(h.shape)} feature map)"
            )
        logits = self._apply_conv(self.final_conv, h, update_sn)
        return logits, (feats if return_features else None)


class MultiScaleDiscriminator(nn.Module):
    def __init__(
        self,
        in_chans: int = 2,
        base_channels: int = 64,
        num_layers: int = 5,
        num_scales: int = 3,
        use_sn: bool = True,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        self.num_scales = num_scales
        self.use_sn = use_sn
        self.dtype = dtype
        for s in range(num_scales):
            self.add_module(f"discriminators_{s}", SingleScaleDiscriminator(
                in_chans, base_channels, num_layers, use_sn, generator))
        self.to(dev)

    def forward(self, x: torch.Tensor, update_sn: bool = False, return_features: bool = True):
        """x [B, H, W, 2] -> ([logits per scale], [features per scale] or None)."""
        logits_all, features_all = [], []
        x_scale = x.to(self.dtype)
        for s in range(self.num_scales):
            logits, feats = getattr(self, f"discriminators_{s}")(
                x_scale, update_sn=update_sn, return_features=return_features
            )
            logits_all.append(logits)
            features_all.append(feats)
            x_scale = avg_pool2(x_scale)
        return logits_all, (features_all if return_features else None)


class ConditionalDiscriminator(nn.Module):
    """Four 4x4 stride-2 conv blocks (instance norm without affine on all but
    the first, LeakyReLU(0.2)), then a 4x4 stride-1 logit conv."""

    def __init__(
        self,
        in_chans: int = 2,
        base_channels: int = 64,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        ch_in, ch = in_chans, base_channels
        for i in range(4):
            self.add_module(f"block_{i}_conv", _conv(ch_in, ch, 4, 2, 1, False, generator))
            ch_in, ch = ch, min(ch * 2, base_channels * 8)
        self.final_conv = _conv(ch_in, 1, 4, 1, 1, False, generator)
        self.to(dev)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = torch.cat([x, cond], dim=-1)
        for i in range(4):
            h = getattr(self, f"block_{i}_conv")(h)
            if i > 0:
                h32 = h.float()
                mu = h32.mean(dim=(1, 2), keepdim=True)
                var = (h32 - mu).square().mean(dim=(1, 2), keepdim=True)
                h = ((h32 - mu) * torch.rsqrt(var + 1e-5)).to(h.dtype)
            h = F.leaky_relu(h, negative_slope=0.2)
        return self.final_conv(h)
