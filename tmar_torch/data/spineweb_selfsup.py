"""Self-supervised SpineWeb preparation dataset (the port's own copy of
``tmar.data.spineweb_selfsup``; the same samples per index and seed).

When no paired clean slices exist, a pseudo-clean target is built on the
fly: metal mask by HU threshold (>3000) with dilation, then row-wise +
column-wise masked linear interpolation.  Uses the host library
(``tmar_torch.data.native``), or its numpy versions without a compiler.

Returns {ct: artifact, gt: pseudo-clean, li: artifact} in [-1, 1].
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from tmar_torch.data import native
from tmar_torch.data.transforms import random_crop_pair, random_flip_pair


class SpineWebSelfSupervisedDataset:
    def __init__(
        self,
        artifact_dir: str,
        patch_size: int = 0,
        train: bool = True,
        max_hu_artifact: float = 3000.0,
        hu_range: Tuple[float, float] = (-1000.0, 2000.0),
        dilate_radius: int = 1,
        seed: int = 123,
    ):
        self.files = []
        for dirpath, _, files in os.walk(artifact_dir):
            for f in sorted(files):
                if f.endswith(".npy"):
                    self.files.append(os.path.join(dirpath, f))
        if not self.files:
            raise ValueError(f"no .npy slices under {artifact_dir}")
        self.patch_size = patch_size
        self.train = train
        self.max_hu = max_hu_artifact
        self.hu_range = hu_range
        self.dilate_radius = dilate_radius
        self.crop_state = np.random.RandomState(seed)
        self.aug_state = np.random.RandomState(seed + 1)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img_hu = np.load(self.files[idx % len(self.files)]).astype(np.float32)

        # metal mask in HU domain (prepare_spineweb_data.py:113-116)
        mask = (img_hu > self.max_hu).astype(np.float32)
        if self.dilate_radius > 0:
            mask = native.metal_mask_dilate(img_hu, self.max_hu, self.dilate_radius)

        # HU window to [0, 1]
        lo, hi = self.hu_range
        img01 = (np.clip(img_hu, lo, hi) - lo) / (hi - lo)

        # pseudo-clean by masked separable linear interpolation
        clean01 = native.li_interpolate(img01, mask) if mask.any() else img01

        artifact = (img01 * 2 - 1).astype(np.float32)
        clean = (np.clip(clean01, 0, 1) * 2 - 1).astype(np.float32)
        if self.train and self.patch_size:
            artifact, clean = random_crop_pair(
                (artifact, clean), self.patch_size, self.crop_state
            )
            artifact, clean = random_flip_pair((artifact, clean), self.aug_state)
        return {"ct": artifact, "gt": clean, "li": artifact}
