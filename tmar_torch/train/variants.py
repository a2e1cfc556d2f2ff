"""Variant ladder and ablation matrix as pure configuration (the
counterpart of ``tmar.train.variants``): each name is a dict of overrides
applied to a TrainConfig, so every variant takes the same train step with
different loss weights and discriminator settings.

Variant ladder:
    baseline  NGswin + DCGAN-D + MSE only
    v1        baseline + adversarial (BCE)
    v2        NGswin + MS-PatchGAN + hinge adversarial
    v3        v2 + feature matching
    v4        v3 + metal-aware reconstruction
    v5        v4 + metal-aware edge
    full      v5 + physics + metal-consistency (the canonical recipe)

Ablations: A0 mse-only, A1 no-physics, A2 no-metal-consistency, A3
no-metal-weighting, A4 no-adversarial, A5 no-FM, A6 no-edge, A7 hinge
(default), A8 vanilla BCE; B1 single-scale D, B2 no spectral norm, B3
dilation radius in {0, 3, 5, 7}.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from tmar_torch.train.config import TrainConfig

# Each entry: {dotted.config.key: value}
VARIANTS: Dict[str, Dict[str, Any]] = {
    "baseline": {
        "disc.kind": "dcgan",
        "loss.gan_mode": "vanilla",
        "loss.adv": 0.0, "loss.fm": 0.0, "loss.edge": 0.0,
        "loss.phys": 0.0, "loss.metal": 0.0, "loss.beta_weight": 0.0,
        "radon.enabled": False,
    },
    "v1": {
        "disc.kind": "dcgan",
        "loss.gan_mode": "vanilla",
        "loss.adv": 0.1, "loss.fm": 0.0, "loss.edge": 0.0,
        "loss.phys": 0.0, "loss.metal": 0.0, "loss.beta_weight": 0.0,
        "radon.enabled": False,
    },
    "v2": {
        "loss.fm": 0.0, "loss.edge": 0.0, "loss.phys": 0.0,
        "loss.metal": 0.0, "loss.beta_weight": 0.0,
        "radon.enabled": False,
    },
    "v3": {
        "loss.edge": 0.0, "loss.phys": 0.0, "loss.metal": 0.0,
        "loss.beta_weight": 0.0, "radon.enabled": False,
    },
    "v4": {
        "loss.edge": 0.0, "loss.phys": 0.0, "loss.metal": 0.0,
        "radon.enabled": False,
    },
    "v5": {"loss.phys": 0.0, "loss.metal": 0.0, "radon.enabled": False},
    "full": {},
}

ABLATIONS: Dict[str, Dict[str, Any]] = {
    "A0_mse_only": {
        "loss.adv": 0.0, "loss.fm": 0.0, "loss.edge": 0.0,
        "loss.phys": 0.0, "loss.metal": 0.0, "loss.beta_weight": 0.0,
        "radon.enabled": False,
    },
    "A1_no_physics": {"loss.phys": 0.0, "radon.enabled": False},
    "A2_no_metal_consistency": {"loss.metal": 0.0},
    "A3_no_metal_weighting": {"loss.beta_weight": 0.0},
    "A4_no_adversarial": {"loss.adv": 0.0},
    "A5_no_feature_matching": {"loss.fm": 0.0},
    "A6_no_edge": {"loss.edge": 0.0},
    "A7_hinge_gan": {"loss.gan_mode": "hinge"},
    "A8_vanilla_gan": {"loss.gan_mode": "vanilla"},
    "B1_single_scale_disc": {"disc.num_scales": 1},
    "B2_no_spectral_norm": {"disc.use_sn": False},
    "B3_dilation_r0": {"loss.dilation_radius": 0},
    "B3_dilation_r3": {"loss.dilation_radius": 3},
    "B3_dilation_r5": {"loss.dilation_radius": 5},
    "B3_dilation_r7": {"loss.dilation_radius": 7},
}


def apply_overrides(cfg: TrainConfig, overrides: Dict[str, Any]) -> TrainConfig:
    cfg = dataclasses.replace(cfg)  # shallow copy of the top level
    # deep-copy nested dataclasses so the original is untouched
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            object.__setattr__(cfg, f.name, dataclasses.replace(v))
    for key, value in overrides.items():
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        if not hasattr(obj, parts[-1]):
            raise KeyError(f"unknown override {key!r}")
        object.__setattr__(obj, parts[-1], value)
    return cfg


def resolve_variant(cfg: TrainConfig, name: str) -> TrainConfig:
    """Apply a variant or ablation name to a base config."""
    if name in VARIANTS:
        return apply_overrides(cfg, VARIANTS[name])
    if name in ABLATIONS:
        return apply_overrides(cfg, ABLATIONS[name])
    raise KeyError(f"unknown variant/ablation {name!r}; "
                   f"choose from {sorted(VARIANTS) + sorted(ABLATIONS)}")
