"""Post-norm residual FFN, plain PyTorch (``tmar.ops.pallas_ffn.ffn_math``).

    y = x + LN1(attn_out)
    z = y + LN2(fc2(GELU(fc1(y))))

LayerNorm statistics and the exact (erf) GELU run in float32.  The
kernels' GELU (``gelu_as_kernels``) computes the erf as the TPU kernels do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(v32: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mu = v32.mean(-1, keepdim=True)
    var = (v32 - mu).square().mean(-1, keepdim=True)
    return (v32 - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def erf_as_kernels(x: torch.Tensor) -> torch.Tensor:
    """erf as the TPU kernels compute it (``tmar/ops/pallas_ffn.py:334``,
    ``_erf_approx``: Abramowitz & Stegun 7.1.26, |err| < 1.5e-7), and as K2,
    K5, K6 and K8 do (``csrc/gelu.cuh``)."""
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = ((((1.061405429 * t - 1.453152027) * t + 1.421413741) * t - 0.284496736) * t
            + 0.254829592) * t
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def gelu_as_kernels(u: torch.Tensor) -> torch.Tensor:
    """The GELU of the FFN kernels: the erf one, with ``erf_as_kernels``."""
    return 0.5 * u * (1.0 + erf_as_kernels(u * 0.7071067811865476))


def ffn_math(x, attn_out, g1, b1, w1, bb1, w2, bb2, g2, b2, eps=1e-5):
    """x, attn_out [M, D]; w1 [D, H], w2 [H, D] in the [in, out] layout."""
    y = x.float() + layer_norm(attn_out.float(), g1, b1, eps)
    h = F.gelu(y @ w1.float() + bb1.float(), approximate="none")
    z = y + layer_norm(h @ w2.float() + bb2.float(), g2, b2, eps)
    return z.to(x.dtype)
