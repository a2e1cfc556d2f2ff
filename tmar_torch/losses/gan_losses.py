"""GAN and metal-aware loss functions on NHWC tensors (the counterpart of
``tmar.losses.gan_losses``), and ``generator_loss``, which assembles the
recipe under one weight structure: a weight of 0 removes its term.

Default weights, the canonical recipe: adv 0.1, fm 10.0, rec 1.0, edge 0.2,
phys 0.02, metal 0.5; metal threshold 0.6 (data in [-1, 1]), dilation radius
5, beta 1.0, w_max 3.0.  The sinogram term ``physics_loss_syn`` needs a
Radon projector (``tmar_torch.ops.radon.Radon``): ``generator_loss`` skips a
non-zero ``phys`` when none is given, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from tmar_torch.ops.gradients import image_gradients
from tmar_torch.ops.morphology import dilate_mask


# --------------------------------------------------------------- adversarial
def hinge_d_loss(real_logits: Sequence[torch.Tensor], fake_logits: Sequence[torch.Tensor]):
    """Sum over scales of E[relu(1 - D(real))] + E[relu(1 + D(fake))]."""
    loss = 0.0
    for r, f in zip(real_logits, fake_logits):
        loss = loss + F.relu(1.0 - r.float()).mean() + F.relu(1.0 + f.float()).mean()
    return loss


def hinge_g_loss(fake_logits: Sequence[torch.Tensor]):
    """Sum over scales of -E[D(fake)]."""
    loss = 0.0
    for f in fake_logits:
        loss = loss - f.float().mean()
    return loss


def _bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    logits = logits.float()
    return (
        logits.clamp(min=0.0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    ).mean()


def vanilla_d_loss(real_logits: Sequence[torch.Tensor], fake_logits: Sequence[torch.Tensor]):
    """BCE-with-logits discriminator loss."""
    loss = 0.0
    for r, f in zip(real_logits, fake_logits):
        loss = loss + _bce_with_logits(r, 1.0) + _bce_with_logits(f, 0.0)
    return loss


def vanilla_g_loss(fake_logits: Sequence[torch.Tensor]):
    """BCE-with-logits generator loss."""
    loss = 0.0
    for f in fake_logits:
        loss = loss + _bce_with_logits(f, 1.0)
    return loss


def feature_matching_loss(
    real_features: Sequence[Sequence[torch.Tensor]],
    fake_features: Sequence[Sequence[torch.Tensor]],
):
    """Sum over scales and layers of mean|feat_real - feat_fake|.  Callers
    detach the real features."""
    total = 0.0
    for fr_scale, ff_scale in zip(real_features, fake_features):
        for fr, ff in zip(fr_scale, ff_scale):
            total = total + (fr.float() - ff.float()).abs().mean()
    return total


# --------------------------------------------------------------- metal-aware
def extract_metal_mask(ct: torch.Tensor, threshold: float = 0.6) -> torch.Tensor:
    """Binary metal mask M = (ct > threshold), float32."""
    return (ct > threshold).float()


def compute_weight_map(
    ct: torch.Tensor,
    beta: float = 1.0,
    radius: int = 5,
    w_max: float = 3.0,
    threshold: float = 0.6,
) -> torch.Tensor:
    """w = min(1 + beta * dilate(M, r), w_max)."""
    dilated = dilate_mask(extract_metal_mask(ct, threshold), radius)
    return (1.0 + beta * dilated).clamp(max=w_max)


def compute_metal_aware_loss(fake, real, ct, beta=1.0, radius=5, w_max=3.0, threshold=0.6):
    """mean|w * (fake - real)|."""
    w = compute_weight_map(ct, beta, radius, w_max, threshold)
    return (w * (fake - real)).abs().mean()


def compute_metal_aware_edge_loss(fake, real, w):
    """mean[w * (|d gx| + |d gy|)]."""
    gfx, gfy = image_gradients(fake)
    grx, gry = image_gradients(real)
    return (w * ((gfx - grx).abs() + (gfy - gry).abs())).mean()


def metal_consistency_loss(fake, real, M):
    """mean|M * (fake - real)|: accuracy inside the metal."""
    return (M * (fake - real)).abs().mean()


def physics_loss_syn(fake, real, M, projector):
    """Sinogram consistency outside the metal trace:
    mean[(1 - Mp)·|P(fake) - P(real)|], Mp = (P(M) > 0).

    Only P(fake) is on the gradient path.  The projections of the clean image
    and of the mask are constants, so they run as one batched projection
    without a graph, and the adjoint in the backward covers B images, not 3B."""
    B = fake.shape[0]
    proj_fake = projector.forward(fake)
    with torch.no_grad():
        const = projector.forward(torch.cat([real, M], dim=0))
        proj_real, m_proj = const[:B], const[B:]
        outside = 1.0 - (m_proj > 0).float()
    return (outside * (proj_fake - proj_real).abs()).mean()


# --------------------------------------------------------------- combined
@dataclasses.dataclass(frozen=True)
class LossWeights:
    """The canonical recipe's defaults.  A weight of 0 removes its term, so
    the variant ladder and the ablations are configuration only."""

    adv: float = 0.1
    fm: float = 10.0
    rec: float = 1.0
    edge: float = 0.2
    phys: float = 0.02
    metal: float = 0.5
    gan_mode: str = "hinge"  # "hinge" | "vanilla"
    metal_threshold: float = 0.6
    dilation_radius: int = 5
    beta_weight: float = 1.0
    w_max: float = 3.0


def generator_loss(
    fake: torch.Tensor,
    real: torch.Tensor,
    ct: torch.Tensor,
    fake_logits: Optional[Sequence[torch.Tensor]],
    fake_feats: Optional[Sequence[Sequence[torch.Tensor]]],
    real_feats: Optional[Sequence[Sequence[torch.Tensor]]],
    weights: LossWeights,
    projector=None,
):
    """The weighted generator objective: (total, dict of unweighted terms).
    ``projector`` is the Radon projector of the sinogram term; without one
    the term is skipped."""
    terms = {}
    total = 0.0
    w = weights
    if w.adv and fake_logits is not None:
        g_adv = hinge_g_loss(fake_logits) if w.gan_mode == "hinge" else vanilla_g_loss(fake_logits)
        terms["adv"] = g_adv
        total = total + w.adv * g_adv
    if w.fm and fake_feats is not None and real_feats is not None:
        fm = feature_matching_loss(real_feats, fake_feats)
        terms["fm"] = fm
        total = total + w.fm * fm
    if w.rec:
        rec = compute_metal_aware_loss(
            fake, real, ct, w.beta_weight, w.dilation_radius, w.w_max, w.metal_threshold
        )
        terms["rec"] = rec
        total = total + w.rec * rec
    if w.edge:
        wmap = compute_weight_map(
            ct, w.beta_weight, w.dilation_radius, w.w_max, w.metal_threshold
        )
        edge = compute_metal_aware_edge_loss(fake, real, wmap)
        terms["edge"] = edge
        total = total + w.edge * edge
    if w.phys and projector is not None:
        M = extract_metal_mask(ct, w.metal_threshold)
        phys = physics_loss_syn(fake, real, M, projector)
        terms["phys"] = phys
        total = total + w.phys * phys
    if w.metal:
        M = extract_metal_mask(ct, w.metal_threshold)
        metal = metal_consistency_loss(fake, real, M)
        terms["metal"] = metal
        total = total + w.metal * metal
    terms["total"] = total
    return total, terms
