"""SynDeepLesion HDF5 pipeline (the port's own copy of
``tmar.data.syndeeplesion``; the same samples per index and seed).

On-disk layout: ``<root>/train_640geo/*/*/gt.h5`` with dataset ``image``,
sibling ``<k>.h5`` files (k = metal-mask id) with datasets ``ma_CT`` and
``LI_CT``; the test split listed in ``<root>/test_640geo_dir.txt`` with 10
masks per image.

Per sample: a random mask id 0-78 for train/val, clip [0,1] -> [-1,1], a
seeded random crop to the patch size (its coordinates drawn before a
partial HDF5 read of just the patch), shared h/v flips, and skip-and-advance
on unreadable files.  ``h5py`` is imported at first read.

Returns HW numpy dicts {ct, gt, li}; the loader adds the batch and channel
axes (``tmar_torch.data.loader``).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np

from tmar_torch.data.transforms import normalize01_to_pm1, random_flip_pair


def _read_h5(path: str, keys: List[str], window=None) -> List[np.ndarray]:
    """Read datasets, optionally only a ``(row, col, patch)`` window —
    partial h5 reads touch ~p²/416² of the bytes of a full slice, the
    difference between the train loader streaming crops and re-reading
    whole slices (SURVEY §7.3 names h5 random access as the reference's
    input bottleneck; its loader always reads full slices)."""
    import h5py

    with h5py.File(path, "r") as f:
        if window is None:
            return [np.asarray(f[k]) for k in keys]
        r, c, p = window
        return [np.asarray(f[k][r : r + p, c : c + p]) for k in keys]


class _SynDeepLesionBase:
    def __init__(self, root: str, files: List[str], n_masks: int, seed: int = 66):
        self.root = root
        self.files = files
        self.n_masks = n_masks
        self.crop_state = np.random.RandomState(seed)
        self.aug_state = np.random.RandomState(seed + 1)
        self.mask_state = np.random.RandomState(seed + 2)
        if not files:
            raise ValueError(f"no gt.h5 files found under {root}")

    def __len__(self) -> int:
        return len(self.files)

    def _load_triplet(self, gt_path: str, mask_id: int, window=None):
        data_path = os.path.join(os.path.dirname(gt_path), f"{mask_id}.h5")
        xma, xli = _read_h5(data_path, ["ma_CT", "LI_CT"], window)
        (xgt,) = _read_h5(gt_path, ["image"], window)
        return (
            normalize01_to_pm1(xma),
            normalize01_to_pm1(xgt),
            normalize01_to_pm1(xli),
        )

    def _slice_shape(self, gt_path: str):
        cache = getattr(self, "_shape_cache", None)
        if cache is None:
            cache = self._shape_cache = {}
        shape = cache.get(gt_path)
        if shape is None:
            import h5py

            with h5py.File(gt_path, "r") as f:
                shape = cache[gt_path] = f["image"].shape
        return shape


class SynDeepLesionTrainDataset(_SynDeepLesionBase):
    def __init__(
        self,
        root: str,
        patch_size: int = 128,
        length: int = 16000,
        seed: int = 66,
        val_fraction: float = 0.0,
    ):
        files = sorted(glob.glob(os.path.join(root, "train_640geo", "*", "*", "gt.h5")))
        if val_fraction > 0:
            files = files[: int(len(files) * (1 - val_fraction))]
        super().__init__(root, files, n_masks=79, seed=seed)
        self.patch_size = patch_size
        self.length = length

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        attempts = 0
        while True:
            try:
                gt_path = self.files[idx % len(self.files)]
                mask_id = int(self.mask_state.randint(0, self.n_masks))
                # crop coords first (same crop_state randint,randint call
                # order as random_crop_pair, so sample streams are
                # unchanged), then PARTIAL h5 reads of just the patch —
                # normalize/crop commute pointwise
                h, w = self._slice_shape(gt_path)
                p = self.patch_size
                if h == p and w == p:
                    window = None
                else:
                    row = self.crop_state.randint(0, h - p + 1)
                    col = self.crop_state.randint(0, w - p + 1)
                    window = (row, col, p)
                ct, gt, li = self._load_triplet(gt_path, mask_id, window)
                ct, gt, li = random_flip_pair((ct, gt, li), self.aug_state)
                return {"ct": ct, "gt": gt, "li": li}
            except (OSError, FileNotFoundError, KeyError):
                # skip-and-advance fault tolerance (reference datasets.py:148)
                idx += 1
                attempts += 1
                if attempts > 4 * len(self.files):
                    raise


class SynDeepLesionValDataset(_SynDeepLesionBase):
    """Last 10% of the train tree, full 416x416 slices (datasets.py:165-236)."""

    def __init__(self, root: str, seed: int = 66, fraction: float = 0.1):
        files = sorted(glob.glob(os.path.join(root, "train_640geo", "*", "*", "gt.h5")))
        files = files[int(len(files) * (1 - fraction)):]
        super().__init__(root, files, n_masks=79, seed=seed)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        attempts = 0
        while True:
            try:
                gt_path = self.files[idx % len(self.files)]
                mask_id = int(self.mask_state.randint(0, self.n_masks))
                ct, gt, li = self._load_triplet(gt_path, mask_id)
                return {"ct": ct, "gt": gt, "li": li}
            except (OSError, FileNotFoundError, KeyError):
                idx += 1
                attempts += 1
                if attempts > 4 * len(self.files):
                    raise


class SynDeepLesionTestDataset(_SynDeepLesionBase):
    """Test list from test_640geo_dir.txt; 10 masks per image, len = files*10
    and mask id = idx // file_num to cover all pairs deterministically
    (the reference's random.randint(0, 9) made runs non-reproducible —
    capability kept, sampling made deterministic)."""

    def __init__(self, root: str, seed: int = 66):
        txt = os.path.join(root, "test_640geo_dir.txt")
        with open(txt) as f:
            rel = [line.strip() for line in f if line.strip()]
        files = [os.path.join(root, "test_640geo", r) for r in rel]
        super().__init__(root, files, n_masks=10, seed=seed)

    def __len__(self) -> int:
        return len(self.files) * 10

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        file_idx = idx % len(self.files)
        mask_id = (idx // len(self.files)) % 10
        ct, gt, li = self._load_triplet(self.files[file_idx], mask_id)
        return {"ct": ct, "gt": gt, "li": li}
