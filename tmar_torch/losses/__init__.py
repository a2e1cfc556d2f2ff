"""GAN and metal-aware losses."""

from tmar_torch.losses.gan_losses import (
    LossWeights,
    compute_metal_aware_edge_loss,
    compute_metal_aware_loss,
    compute_weight_map,
    extract_metal_mask,
    feature_matching_loss,
    generator_loss,
    hinge_d_loss,
    hinge_g_loss,
    metal_consistency_loss,
    physics_loss_syn,
    vanilla_d_loss,
    vanilla_g_loss,
)

__all__ = [
    "LossWeights",
    "compute_metal_aware_edge_loss",
    "compute_metal_aware_loss",
    "compute_weight_map",
    "extract_metal_mask",
    "feature_matching_loss",
    "generator_loss",
    "hinge_d_loss",
    "hinge_g_loss",
    "metal_consistency_loss",
    "physics_loss_syn",
    "vanilla_d_loss",
    "vanilla_g_loss",
]
