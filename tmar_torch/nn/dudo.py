"""Dual-domain unrolled MAR network (the counterpart of ``tmar.nn.dudo``).

An unrolled proximal-gradient network that couples the sinogram and image
domains through the port's differentiable :class:`tmar_torch.ops.radon.Radon`:

    min_{S,X}  ||Tr ⊙ (S − Sma)||²  +  α ||A X − S||²  +  g₁(S) + g₂(X)

Each of ``stages`` iterations takes one proximal-gradient step per domain,
the prox operators small residual CNNs that carry ``channels`` memory maps
across stages:

    S ← proxS_k( S − η1ₖ [ Tr ⊙ (S − Sma) + αₖ (S − A X) ] | Sp, memS )
    X ← proxX_k( X − η2ₖ · FBP( A X − S )                   | Xp, memX )

η1ₖ, η2ₖ, αₖ are per-stage step sizes, softplus of raw parameters that start
at softplus⁻¹ of 1, 5 and 0.5.  The image-side direction is the ramp-filtered
backprojection of the residual; gradients flow through ``filter_sinogram``
and the adjoint.  A two-scale prior U-Net predicts Xp from (Xma, XLI, M);
its projection Sp conditions the sinogram prox (passing ``x_prior`` bypasses
the prior net).  Images are NHWC [B, H, W, 1] in [0, 1], sinograms
[B, A, det], ``tr`` the non-metal trace (``Radon(mask) < 0.1``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmar_torch.device import resolve_device
from tmar_torch.nn.baselines import Conv, ConvTranspose, _Baseline


class _ProxNet(nn.Module):
    """Learned proximal operator: a residual CNN over [main | memory | cond];
    returns (main + correction, the memory for the next stage)."""

    def __init__(self, cond: int, channels: int = 32, blocks: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = blocks
        self.in_conv = Conv(1 + channels + cond, channels, 3, dtype=dtype)
        for i in range(blocks):
            self.add_module(f"res{i}_a", Conv(channels, channels, 3, dtype=dtype))
            self.add_module(f"res{i}_b", Conv(channels, channels, 3, dtype=dtype))
        self.out_conv = Conv(channels, 1 + channels, 3, dtype=dtype)

    def forward(self, main, mem, cond):
        h = self.in_conv(torch.cat([main, mem, cond], dim=-1))
        for i in range(self.blocks):
            r = getattr(self, f"res{i}_b")(F.relu(getattr(self, f"res{i}_a")(h)))
            h = F.relu(h + r)
        out = self.out_conv(h).float()
        return main + out[..., :1], out[..., 1:]


class _PriorUNet(nn.Module):
    """Two-scale U-Net predicting the coarse prior image from (Xma, XLI, M).
    Its stride-2 ``down`` conv pads flax's "SAME" way, (0, 1) on an even
    input."""

    def __init__(self, channels: int = 32, in_ch: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channels
        self.e0a = Conv(in_ch, c, 3, dtype=dtype)
        self.e0b = Conv(c, c, 3, dtype=dtype)
        self.down = Conv(c, 2 * c, 3, stride=2, dtype=dtype)
        self.e1b = Conv(2 * c, 2 * c, 3, dtype=dtype)
        self.up = ConvTranspose(2 * c, c, 2, stride=2, dtype=dtype)
        self.fuse = Conv(2 * c, c, 3, dtype=dtype)
        self.out = Conv(c, 1, 3, dtype=dtype)

    def forward(self, x):
        e0 = F.relu(self.e0b(F.relu(self.e0a(x))))
        e1 = F.relu(self.e1b(F.relu(self.down(e0))))
        h = F.relu(self.fuse(torch.cat([self.up(e1), e0], dim=-1)))
        return self.out(h).float()


class DuDoMARNet(_Baseline):
    """Unrolled dual-domain metal-artifact-reduction network.

    Args:
        projector: a :class:`tmar_torch.ops.radon.Radon` for the input size,
            shared by every stage (its device is the network's).
        stages: unrolled proximal iterations.
        channels: cross-stage memory feature maps.
        blocks: residual blocks per prox net.
        share_weights: one (``prox_s``, ``prox_x``) pair serves every stage,
            instead of ``prox_s_k`` / ``prox_x_k`` per stage.

    ``forward(xma, xli, m, sma, sli, tr, x_prior=None)`` returns a dict with
    the final image ``x`` [B, H, W, 1], the final sinogram ``s`` [B, A, det],
    the prior image ``x_prior`` and the per-stage images ``xs``.
    """

    dual_domain = True  # the fine-tune step feeds it the six-tensor signature

    def __init__(self, projector=None, stages: int = 4, channels: int = 32, blocks: int = 3,
                 share_weights: bool = False, eta1_init: float = 1.0, eta2_init: float = 5.0,
                 alpha_init: float = 0.5, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if projector is None:
            raise ValueError("DuDoMARNet requires a Radon projector")
        self.projector = projector
        self.stages, self.channels, self.share_weights = stages, channels, share_weights
        self.inits = {"eta1": eta1_init, "eta2": eta2_init, "alpha": alpha_init}
        self.prior_net = _PriorUNet(channels, dtype=dtype)
        for name in self.inits:
            self.register_parameter(name, nn.Parameter(torch.zeros(stages)))
        names = ["prox_s", "prox_x"] if share_weights else [
            f"prox_{d}_{k}" for k in range(stages) for d in ("s", "x")]
        for name in names:
            # the sinogram prox is conditioned on (Sp, Tr, Sma), the image
            # prox on (Xp, XLI)
            self.add_module(name, _ProxNet(3 if name.startswith("prox_s") else 2, channels, blocks, dtype))
        self._finish(projector.device if device is None else resolve_device(device))

    def reset_extra(self, generator) -> None:
        for name, init in self.inits.items():
            getattr(self, name).fill_(math.log(math.expm1(init)))  # softplus⁻¹(init)

    def _prox(self, d: str, k: int) -> _ProxNet:
        return getattr(self, f"prox_{d}" if self.share_weights else f"prox_{d}_{k}")

    def forward(self, xma, xli, m, sma, sli, tr, x_prior: Optional[torch.Tensor] = None):
        A = self.projector
        xma, xli, sma, sli, tr = (t.float() for t in (xma, xli, sma, sli, tr))
        if x_prior is None:
            x_prior = xli + self.prior_net(torch.cat([xma, xli, m.float()], dim=-1))
        sp = A.forward(x_prior)
        eta1, eta2, alpha = (F.softplus(getattr(self, n)) for n in ("eta1", "eta2", "alpha"))

        # initial estimates: the measured data off the metal, LI inside the trace
        s = tr * sma + (1.0 - tr) * sli
        x = xli
        mem_s = sma.new_zeros(sma.shape + (self.channels,))
        mem_x = xma.new_zeros(xma.shape[:3] + (self.channels,))
        cond_s = torch.stack([sp, tr, sma], dim=-1)
        xs = []
        for k in range(self.stages):
            ax = A.forward(x)
            grad_s = tr * (s - sma) + alpha[k] * (s - ax)
            s_new, mem_s = self._prox("s", k)((s - eta1[k] * grad_s)[..., None], mem_s, cond_s)
            s = s_new[..., 0]
            # the FBP-preconditioned gradient: a well-scaled descent direction
            x_half = x - eta2[k] * A.fbp(ax - s)[..., None]
            x, mem_x = self._prox("x", k)(x_half, mem_x, torch.cat([x_prior, xli], dim=-1))
            xs.append(x)
        return {"x": x, "s": s, "x_prior": x_prior, "xs": xs}
