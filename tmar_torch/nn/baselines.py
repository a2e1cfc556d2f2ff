"""Baseline architectures (the counterpart of ``tmar.nn.baselines``), NHWC:

* ``RedCNN``: 5 VALID convs and 5 VALID transposed convs, residuals after
  conv2 / conv4 and at the input;
* ``DenoisingTransformer``: patchify conv, learned 2-D position embedding,
  pre-LN transformer encoder (flax's ``MultiHeadDotProductAttention`` as its
  einsums), transposed-conv upsampling, 3x3 out conv, global residual;
* ``BAFResNet``: boosting-attention-fusion ResNet with channel and spatial
  attention blocks;
* ``DCGANGenerator`` / ``DCGANCritic`` / ``DCGANDiscriminator``: the DCGAN
  pair; the critic presents the ``(logits_list, features_list)`` interface
  of the GAN train step (the ``baseline`` and ``v1`` variants), the
  discriminator the sigmoid output of the tutorial loop.

Module and parameter names are flax's (``conv1``, ``attn_0.query``,
``bafb_3.ca.fc1``, ``bn_2``, ...), so ``tmar_torch.checkpoint.convert``
maps a flax tree onto a ``state_dict`` path for path.  The layers below keep
flax's semantics where torch's defaults differ: "SAME" padding computed per
call (a stride-2 conv on an even input pads (0, 1), not (1, 1)), transposed
convolutions whose flax kernel is the spatial flip of torch's, LayerNorm at
eps 1e-6, GELU by its tanh approximation, BatchNorm with momentum 0.99 and
the biased batch variance in the running average.  Parameters stay float32;
with ``dtype=torch.bfloat16`` each layer casts its input and weights, as a
flax layer with ``dtype`` does.  ``draw_parameters`` draws flax's
initialisers: normal(0.02) where the JAX module names ``conv_normal_init``,
else lecun-normal kernels, zero biases.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmar_torch.device import resolve_device

# ---------------------------------------------------------------- layers


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax / XLA "SAME": out = ceil(size / s), the padding split low-first."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` on NHWC tensors: ``padding`` is "SAME", "VALID" or a
    symmetric int.  ``init`` names the kernel initialiser ("normal" for
    normal(0.02), "lecun" for flax's default)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding="SAME",
                 bias: bool = True, dtype: torch.dtype = torch.float32, init: str = "normal"):
        super().__init__(in_ch, out_ch, kernel, stride=stride,
                         padding=padding if isinstance(padding, int) else 0, bias=bias)
        self.same = padding == "SAME"
        self.compute_dtype = dtype
        self.init = init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        if self.same:
            k, s = self.kernel_size[0], self.stride[0]
            top, bottom = _same_pads(x.shape[2], k, s)
            left, right = _same_pads(x.shape[3], k, s)
            x = F.pad(x, (left, right, top, bottom))
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b).permute(0, 2, 3, 1)


class ConvTranspose(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose`` on NHWC tensors, VALID: out = (in - 1)·s + k.
    Where these modules keep flax's default "SAME", k equals s, and "SAME"
    and VALID agree.  The weight is torch's layout; the flax kernel is its
    spatial flip (``convert``).  Every one is drawn from normal(0.02)."""

    init = "normal"

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel, stride=stride, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv_transpose2d(x, self.weight.to(x.dtype), b, stride=self.stride)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Linear):
    """flax ``nn.Dense`` / ``DenseGeneral``: ``kernel_shape`` is the flax
    kernel's shape (its input axes, then its output axes), whose flattening
    to [in, out] is the transpose of ``weight``.  Every one is drawn by
    flax's default, lecun-normal over its ``in_features``."""

    init = "lecun"

    def __init__(self, in_features: int, out_features: int, kernel_shape: Optional[Sequence[int]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.kernel_shape = tuple(kernel_shape or (in_features, out_features))
        n_in = next(i for i in range(1, len(self.kernel_shape))
                    if math.prod(self.kernel_shape[:i]) == in_features)
        self.bias_shape = self.kernel_shape[n_in:]
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: eps 1e-6, statistics in float32."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis of NHWC tensors.  In
    training the batch statistics normalise (var = E[x²] - E[x]², clipped at
    0) and the running ones move as ra <- 0.99·ra + 0.01·batch, the BIASED
    variance included (torch's BatchNorm2d keeps the unbiased one); in
    evaluation the running statistics normalise.  eps 1e-5."""

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.momentum, self.eps = momentum, eps

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        if train:
            mean = x.mean(dim=(0, 1, 2))
            var = (x * x).mean(dim=(0, 1, 2)) - mean * mean
            var = var.clamp(min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(mean.detach(), alpha=1.0 - self.momentum)
                self.var.mul_(self.momentum).add_(var.detach(), alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class MultiHeadDotProductAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` (self-attention, no mask) as
    its einsums: q, k, v by [dim, heads, hd] kernels, q scaled by 1/sqrt(hd),
    softmax over the keys, the head outputs merged by a [heads, hd, dim]
    kernel."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        hd = dim // num_heads
        self.num_heads, self.head_dim = num_heads, hd
        for name in ("query", "key", "value"):
            self.add_module(name, Dense(dim, dim, (dim, num_heads, hd), dtype))
        self.out = Dense(dim, dim, (num_heads, hd, dim), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        q, k, v = (getattr(self, n)(x).reshape(B, L, self.num_heads, self.head_dim)
                   for n in ("query", "key", "value"))
        q = q / math.sqrt(self.head_dim)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        y = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, L, -1)
        return self.out(y)


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator) -> torch.Tensor:
    # flax's variance_scaling(1, "fan_in", "truncated_normal"): a normal cut at
    # two standard deviations, rescaled to keep the variance 1 / fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def _fan_in(module) -> int:
    return module.in_features if isinstance(module, Dense) else module.weight[0].numel()


def _fill(t: torch.Tensor, draw, generator) -> None:
    """``draw(tensor, generator)`` on the generator's device, copied over, so
    a CPU generator gives the same parameters on any device."""
    if generator is None:
        draw(t, None)
        return
    tmp = torch.empty(t.shape, dtype=t.dtype, device=generator.device)
    draw(tmp, generator)
    t.copy_(tmp)


@torch.no_grad()
def draw_parameters(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Draw every parameter of ``model`` by the JAX module's initialisers, in
    module order, from ``generator`` (the global one if None).  A module may
    add its own (``reset_extra``) for parameters of its own, such as a
    position embedding or step sizes."""
    for m in model.modules():
        if isinstance(m, (Conv, ConvTranspose, Dense)):
            if m.init == "normal":
                _fill(m.weight, lambda t, g: nn.init.normal_(t, std=0.02, generator=g), generator)
            else:
                fan = _fan_in(m)
                _fill(m.weight, lambda t, g: _lecun_normal_(t, fan, g), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (LayerNorm, BatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.mean.zero_()
                m.var.fill_(1.0)
        if hasattr(m, "reset_extra"):
            m.reset_extra(generator)


class _Baseline(nn.Module):
    def _finish(self, device) -> None:
        draw_parameters(self)
        self.to(resolve_device(device))

    def draw_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        draw_parameters(self, generator)


# ---------------------------------------------------------------- models


class RedCNN(_Baseline):
    def __init__(self, features: int = 96, in_chans: int = 1, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        self.features, self.in_chans, self.dtype = features, in_chans, dtype
        f = features
        for i in range(1, 6):
            self.add_module(f"conv{i}", Conv(in_chans if i == 1 else f, f, 5, padding="VALID",
                                             dtype=dtype))
        for i in range(1, 6):
            self.add_module(f"deconv{i}", ConvTranspose(f, in_chans if i == 5 else f, 5, dtype=dtype))
        self._finish(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r0 = x
        h = F.relu(self.conv1(x))
        h = F.relu(self.conv2(h))
        r1 = h
        h = F.relu(self.conv3(h))
        h = F.relu(self.conv4(h))
        r2 = h
        h = F.relu(self.conv5(h))
        h = F.relu(self.deconv1(h) + r2)
        h = F.relu(self.deconv2(h))
        h = F.relu(self.deconv3(h) + r1)
        h = F.relu(self.deconv4(h))
        return F.relu(self.deconv5(h) + r0)


class DenoisingTransformer(_Baseline):
    """``img_size`` sizes the position embedding (flax sizes it by the input
    of ``init``): [1, ceil(img_size / patch)², dim]."""

    def __init__(self, dim: int = 128, depth: int = 4, num_heads: int = 4, patch: int = 8,
                 in_chans: int = 1, img_size: int = 64, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        self.dim, self.depth, self.patch, self.dtype = dim, depth, patch, dtype
        g = -(-img_size // patch)
        self.proj = Conv(in_chans, dim, patch, stride=patch, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, dim))
        for i in range(depth):
            self.add_module(f"norm1_{i}", LayerNorm(dim))
            self.add_module(f"attn_{i}", MultiHeadDotProductAttention(dim, num_heads, dtype))
            self.add_module(f"norm2_{i}", LayerNorm(dim))
            self.add_module(f"mlp1_{i}", Dense(dim, 4 * dim, dtype=dtype))
            self.add_module(f"mlp2_{i}", Dense(4 * dim, dim, dtype=dtype))
        self.up = ConvTranspose(dim, dim // 2, patch, stride=patch, dtype=dtype)
        self.out = Conv(dim // 2, in_chans, 3, dtype=dtype)
        self._finish(device)

    def reset_extra(self, generator) -> None:
        _fill(self.pos_embed, lambda t, g: nn.init.normal_(t, std=0.02, generator=g), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        h = self.proj(x)
        hh, ww = h.shape[1], h.shape[2]
        tokens = (h + self.pos_embed).reshape(B, hh * ww, self.dim)
        for i in range(self.depth):
            y = getattr(self, f"norm1_{i}")(tokens)
            tokens = tokens + getattr(self, f"attn_{i}")(y)
            y = getattr(self, f"norm2_{i}")(tokens)
            y = F.gelu(getattr(self, f"mlp1_{i}")(y), approximate="tanh")
            tokens = tokens + getattr(self, f"mlp2_{i}")(y)
        h = self.up(tokens.reshape(B, hh, ww, self.dim))
        return self.out(F.relu(h)) + x


class _SpatialAttention(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(2, 1, 7, dtype=dtype, init="lecun")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = x.mean(dim=-1, keepdim=True)
        mx = x.amax(dim=-1, keepdim=True)
        return x * torch.sigmoid(self.conv(torch.cat([avg, mx], dim=-1)))


class _ChannelAttention(nn.Module):
    def __init__(self, channels: int, reduction: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(channels, channels // reduction, dtype=dtype)
        self.fc2 = Dense(channels // reduction, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.fc2(F.relu(self.fc1(x.mean(dim=(1, 2)))))
        return x * torch.sigmoid(a)[:, None, None, :]


class _BAFB(nn.Module):
    """Boosting attention fusion block: conv-conv residual + dual attention."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(features, features, 3, dtype=dtype, init="lecun")
        self.conv2 = Conv(features, features, 3, dtype=dtype, init="lecun")
        self.ca = _ChannelAttention(features, dtype=dtype)
        self.sa = _SpatialAttention(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(F.relu(self.conv1(x)))
        return F.relu(self.sa(self.ca(h)) + x)


class BAFResNet(_Baseline):
    def __init__(self, features: int = 64, num_blocks: int = 8, in_chans: int = 1,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.features, self.num_blocks, self.dtype = features, num_blocks, dtype
        self.head = Conv(in_chans, features, 3, dtype=dtype, init="lecun")
        for i in range(num_blocks):
            self.add_module(f"bafb_{i}", _BAFB(features, dtype))
        self.fuse = Conv(features, features, 3, dtype=dtype, init="lecun")
        self.tail = Conv(features, in_chans, 3, dtype=dtype, init="lecun")
        self._finish(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.head(x)
        skip, boosted = h, 0.0
        for i in range(self.num_blocks):
            h = getattr(self, f"bafb_{i}")(h)
            boosted = boosted + h  # boosting merge: the block outputs accumulate
        h = F.relu(self.fuse(boosted / self.num_blocks) + skip)
        return self.tail(h)


class DCGANGenerator(_Baseline):
    """z [B, 1, 1, nz] -> image [B, 64, 64, nc] through transposed convs:
    torch's ConvTranspose2d(k=4, s=2, p=1) written as the full VALID
    transpose (2·in + 2) cropped by one pixel a side, as the JAX module
    does."""

    def __init__(self, nz: int = 100, ngf: int = 64, nc: int = 1, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        self.nz, self.ngf, self.nc = nz, ngf, nc
        chans = [nz, ngf * 8, ngf * 4, ngf * 2, ngf]
        for i in range(4):
            self.add_module(f"up_{i}", ConvTranspose(chans[i], chans[i + 1], 4, stride=1 if i == 0 else 2,
                                                     bias=False, dtype=dtype))
            self.add_module(f"bn_{i}", BatchNorm(chans[i + 1]))
        self.out = ConvTranspose(ngf, nc, 4, stride=2, bias=False, dtype=dtype)
        self._finish(device)

    def forward(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = z
        for i in range(4):
            h = getattr(self, f"up_{i}")(h)
            if i:
                h = h[:, 1:-1, 1:-1, :]
            h = F.relu(getattr(self, f"bn_{i}")(h, train=train))
        return torch.tanh(self.out(h)[:, 1:-1, 1:-1, :])


class _DCGANConvs(_Baseline):
    def __init__(self, ndf: int, in_chans: int, dtype: torch.dtype, device):
        super().__init__()
        self.ndf = ndf
        chans = [in_chans, ndf, ndf * 2, ndf * 4, ndf * 8]
        for i in range(4):
            self.add_module(f"conv_{i}", Conv(chans[i], chans[i + 1], 4, stride=2, padding=1,
                                              bias=False, dtype=dtype))
        self.final = Conv(ndf * 8, 1, 4, padding="VALID", bias=False, dtype=dtype)
        self._finish(device)

    def _features(self, x: torch.Tensor):
        feats, h = [], x
        for i in range(4):
            h = F.leaky_relu(getattr(self, f"conv_{i}")(h), 0.2)
            feats.append(h)
        return self.final(h), feats


class DCGANCritic(_DCGANConvs):
    """DCGAN strided-conv critic with the ``(logits_list, features_list)``
    interface of the GAN train step; pre-sigmoid logits, so the vanilla BCE
    losses apply directly.  ``in_chans`` is the conditional pair's (input ‖
    image): 2 for one-channel slices."""

    use_sn = False

    def __init__(self, ndf: int = 64, in_chans: int = 2, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__(ndf, in_chans, dtype, device)

    def forward(self, x: torch.Tensor, update_sn: bool = False, return_features: bool = True):
        logits, feats = self._features(x)
        return [logits], ([feats] if return_features else None)


class DCGANDiscriminator(_DCGANConvs):
    """The strided-conv critic with a sigmoid output (the tutorial loop)."""

    def __init__(self, ndf: int = 64, in_chans: int = 1, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__(ndf, in_chans, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self._features(x)[0])
