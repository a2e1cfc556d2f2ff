"""Shared building blocks: Linear/Conv/LayerNorm that follow the activation
dtype, the MLP, and the initialisers (the counterpart of ``tmar.nn.layers``).

Parameters stay float32, as in the JAX package; each layer casts its weights
to the dtype of the activation it receives, so a bfloat16 model is a float32
model fed bfloat16 activations.  DropPath and dropout are identities: the
port runs the recipes that set them to 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv2d(nn.Conv2d):
    """A convolution that takes and returns NHWC tensors."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = self._conv_forward(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    """LayerNorm at eps 1e-5 (torch's default, which the JAX package matches),
    with statistics in float32 and the output in the input's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class Mlp(nn.Module):
    """fc1 -> GELU (erf) -> fc2.  Holds the weights; the fused block kernel
    (and its plain version, ``tmar_torch.ops.ffn.ffn_math``) applies them."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features)


def _draw(param: torch.Tensor, init, generator) -> None:
    """Fill ``param`` by ``init(tensor, generator=...)``.  With a generator
    the values are drawn on the generator's device and copied over, so a
    CPU generator gives the same parameters on any device."""
    if generator is None:
        init(param, generator=None)
        return
    tmp = torch.empty(param.shape, dtype=param.dtype, device=generator.device)
    init(tmp, generator=generator)
    param.copy_(tmp)


def _trunc_normal(t, generator):
    return nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)


def _normal(t, generator):
    return nn.init.normal_(t, std=0.02, generator=generator)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator = None) -> None:
    """The JAX package's initialisers: trunc-normal(0.02) linears, normal(0.02)
    convs, zero biases, LayerNorm (1, 0), trunc-normal(0.02) relative-position
    bias tables and ln 10 logit scales; drawn from ``generator`` (the global
    one if None)."""
    if isinstance(module, nn.Linear):
        _draw(module.weight, _trunc_normal, generator)
        if module.bias is not None:
            nn.init.zeros_(module.bias)
    elif isinstance(module, nn.Conv2d):
        _draw(module.weight, _normal, generator)
        if module.bias is not None:
            nn.init.zeros_(module.bias)
    elif isinstance(module, nn.LayerNorm):
        nn.init.ones_(module.weight)
        nn.init.zeros_(module.bias)
    elif hasattr(module, "relative_position_bias_table"):  # WindowAttention
        _draw(module.relative_position_bias_table, _trunc_normal, generator)
        module.logit_scale.fill_(math.log(10.0))
