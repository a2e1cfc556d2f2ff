"""Post-norm residual FFN, plain PyTorch (``tmar.ops.pallas_ffn.ffn_math``).

    y = x + LN1(attn_out)
    z = y + LN2(fc2(GELU(fc1(y))))

LayerNorm statistics and the exact (erf) GELU run in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ln(v32: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mu = v32.mean(-1, keepdim=True)
    var = (v32 - mu).square().mean(-1, keepdim=True)
    return (v32 - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def ffn_math(x, attn_out, g1, b1, w1, bb1, w2, bb2, g2, b2, eps=1e-5):
    """x, attn_out [M, D]; w1 [D, H], w2 [H, D] in the [in, out] layout."""
    y = x.float() + _ln(attn_out.float(), g1, b1, eps)
    h = F.gelu(y @ w1.float() + bb1.float(), approximate="none")
    z = y + _ln(h @ w2.float() + bb2.float(), g2, b2, eps)
    return z.to(x.dtype)
