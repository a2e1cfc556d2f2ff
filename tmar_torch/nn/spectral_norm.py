"""Spectral normalisation with explicit power-iteration state (the
counterpart of ``tmar.nn.spectral_norm``).

``SNConv`` keeps ``u`` [out] and ``v`` [fan_in] as buffers.  The weight is
flattened to [out, in*kh*kw]; with ``update_sn`` a forward runs one power
iteration from the detached weight, v <- normalize(Wᵀu), u <- normalize(Wv),
and stores the new vectors; sigma = uᵀWv is differentiable through W and the
conv uses W / sigma.  ``_l2_normalize`` is x * rsqrt(sum x² + 1e-12), which
is not what ``torch.nn.utils.spectral_norm`` computes (x / max(|x|, eps)),
so that utility is not used.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum() + eps)


class SNConv(nn.Module):
    """Conv2d with spectral normalisation, on NHWC tensors.  Parameters and
    buffers are float32; the normalised kernel is cast to the activation's
    dtype."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int,
        stride: int = 1,
        padding: int = 0,
        use_bias: bool = True,
        generator: torch.Generator = None,
    ):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel_size, kernel_size))
        nn.init.normal_(self.weight, std=0.02, generator=generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        fan_in = in_features * kernel_size * kernel_size
        self.register_buffer("u", _l2_normalize(torch.randn(features, generator=generator)))
        self.register_buffer("v", _l2_normalize(torch.randn(fan_in, generator=generator)))

    def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
        w_mat = self.weight.reshape(self.weight.shape[0], -1)
        u, v = self.u, self.v
        if update_sn:
            with torch.no_grad():
                v = _l2_normalize(w_mat.t() @ u)
                u = _l2_normalize(w_mat @ v)
                self.u.copy_(u)
                self.v.copy_(v)
        sigma = torch.dot(u, w_mat @ v)
        kernel = (self.weight / sigma).to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(
            x.permute(0, 3, 1, 2), kernel, bias, stride=self.stride, padding=self.padding
        )
        return y.permute(0, 2, 3, 1)
