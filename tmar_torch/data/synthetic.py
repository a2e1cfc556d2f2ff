"""Procedural synthetic MAR dataset (the port's own copy of
``tmar.data.synthetic``; host-side numpy, the same samples per index).

Generates paired (artifact, clean, LI) CT-like slices entirely in memory:
smooth anatomy phantoms (sums of Gaussian blobs + an ellipse "body"), bright
metal inserts, and streak artifacts radiating from the metal (the visual
signature the physics loss targets).  Used by the tests and the trainer's
synthetic runs.

Deterministic per index: sample i is generated from seed ``base_seed + i``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur with reflect padding (no scipy)."""
    r = max(1, int(3.0 * sigma))
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2).astype(np.float32)
    k /= k.sum()
    p = np.pad(img, ((r, r), (0, 0)), mode="reflect")
    img = sum(k[i] * p[i : i + img.shape[0]] for i in range(2 * r + 1))
    p = np.pad(img, ((0, 0), (r, r)), mode="reflect")
    img = sum(k[i] * p[:, i : i + img.shape[1]] for i in range(2 * r + 1))
    return img.astype(np.float32)


def apply_metal_artifacts(gt01: np.ndarray, rng: np.random.Generator):
    """Insert metal + streaks into a clean [0,1] slice and synthesize the
    LI-proxy inpainting; returns (ma01, li01).

    RNG call order here defines per-index sample identity; do not reorder.
    """
    s = gt01.shape[0]
    y, x = np.mgrid[0:s, 0:s] / s - 0.5
    n_metal = rng.integers(1, 3)
    metal = np.zeros((s, s), np.float32)
    centers = []
    for _ in range(n_metal):
        cx, cy = rng.uniform(-0.25, 0.25, 2)
        r = rng.uniform(0.015, 0.04)
        metal += (((x - cx) ** 2 + (y - cy) ** 2) < r * r).astype(np.float32)
        centers.append((cx, cy))
    metal = np.clip(metal, 0, 1)
    # streaks radiating through each metal center
    streaks = np.zeros((s, s), np.float32)
    for cx, cy in centers:
        for _ in range(rng.integers(6, 12)):
            th = rng.uniform(0, np.pi)
            d = (x - cx) * np.sin(th) - (y - cy) * np.cos(th)
            w = rng.uniform(0.002, 0.006)
            amp = rng.uniform(0.05, 0.18) * rng.choice([-1.0, 1.0])
            streaks += amp * np.exp(-(d / w) ** 2)
    ma01 = np.clip(gt01 + streaks, 0, 1)
    ma01 = np.where(metal > 0, 1.0, ma01)          # saturated metal
    # LI proxy: sinogram linear interpolation removes the metal and
    # most streaks but blurs tissue near the metal trace and leaves
    # faint low-frequency shading.
    smooth = _gaussian_blur(gt01, sigma=max(2.0, s / 24.0))
    w = np.clip(_gaussian_blur(metal, sigma=max(2.0, s / 12.0)) * 4.0, 0.0, 1.0)
    # interpolated-trace shading: wide soft bands spanning the whole
    # slice through each metal center (every projection angle crosses
    # the trace, so LI residue is not confined to the metal's
    # neighbourhood)
    shade = np.zeros((s, s), np.float32)
    for cx, cy in centers:
        for _ in range(rng.integers(2, 4)):
            th = rng.uniform(0, np.pi)
            d = (x - cx) * np.sin(th) - (y - cy) * np.cos(th)
            wdt = rng.uniform(0.03, 0.07)
            shade += rng.uniform(0.02, 0.06) * rng.choice([-1.0, 1.0]) * np.exp(
                -(d / wdt) ** 2
            )
    li01 = np.clip((1.0 - w) * gt01 + w * smooth + shade, 0, 1)
    return ma01.astype(np.float32), li01.astype(np.float32)


class SyntheticMARDataset:
    def __init__(
        self,
        size: int = 128,
        length: int = 256,
        base_seed: int = 0,
        metal_prob: float = 1.0,
    ):
        self.size = size
        self.length = length
        self.base_seed = base_seed
        self.metal_prob = metal_prob

    def __len__(self) -> int:
        return self.length

    def _phantom(self, rng: np.random.Generator) -> np.ndarray:
        s = self.size
        y, x = np.mgrid[0:s, 0:s] / s - 0.5
        # body ellipse
        img = 0.35 * (((x / 0.42) ** 2 + (y / 0.46) ** 2) < 1.0).astype(np.float32)
        # soft-tissue blobs
        for _ in range(rng.integers(3, 7)):
            cx, cy = rng.uniform(-0.3, 0.3, 2)
            sx, sy = rng.uniform(0.04, 0.18, 2)
            amp = rng.uniform(0.05, 0.25)
            img += amp * np.exp(-(((x - cx) / sx) ** 2 + ((y - cy) / sy) ** 2))
        return np.clip(img, 0, 1).astype(np.float32)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.base_seed + idx)
        s = self.size
        gt01 = self._phantom(rng)

        ma01 = gt01.copy()
        li01 = gt01.copy()
        if rng.random() < self.metal_prob:
            ma01, li01 = apply_metal_artifacts(gt01, rng)

        to_pm1 = lambda a: (np.clip(a, 0, 1) * 2 - 1).astype(np.float32)
        return {"ct": to_pm1(ma01), "gt": to_pm1(gt01), "li": to_pm1(li01)}
