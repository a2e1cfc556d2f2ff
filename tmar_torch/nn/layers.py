"""Shared building blocks: Linear/Conv/LayerNorm that follow the activation
dtype, the MLP, and the initialisers (the counterpart of ``tmar.nn.layers``).

Parameters stay float32, as in the JAX package; each layer casts its weights
to the dtype of the activation it receives, so a bfloat16 model is a float32
model fed bfloat16 activations.  DropPath and dropout are identities: the
port serves inference only.
"""

from __future__ import annotations

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


@torch.no_grad()
def init_weights(module: nn.Module) -> None:
    """The JAX package's initialisers: trunc-normal(0.02) linears, normal(0.02)
    convs, zero biases, LayerNorm (1, 0)."""
    if isinstance(module, nn.Linear):
        nn.init.trunc_normal_(module.weight, std=0.02, a=-0.04, b=0.04)
        if module.bias is not None:
            nn.init.zeros_(module.bias)
    elif isinstance(module, nn.Conv2d):
        nn.init.normal_(module.weight, std=0.02)
        if module.bias is not None:
            nn.init.zeros_(module.bias)
    elif isinstance(module, nn.LayerNorm):
        nn.init.ones_(module.weight)
        nn.init.zeros_(module.bias)
