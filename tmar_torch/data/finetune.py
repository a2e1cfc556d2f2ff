"""Benchmark fine-tune dataset (the port's own copy of
``tmar.data.finetune``; the same samples per index and seed): paired
artifact/clean .npy slices, HU [-1000, 2000] -> [0, 1] (optionally x255),
patch or resize mode, an approximate metal mask from the 95th percentile of
|ma - gt|, and a mean-fill LI image.  Each sample is a dict of [H, W]
float32 arrays:

    Xma  — metal-affected input
    Xgt  — clean target
    XLI  — mean-fill linear-interpolation approximation
    M    — NON-metal mask (1 - mask), what dual-domain models consume
    mask — metal mask
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from tmar_torch.data.spineweb import _paired_files


def create_metal_mask(ma: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """|ma - gt| above its 95th percentile."""
    diff = np.abs(ma - gt)
    threshold = np.percentile(diff, 95) if diff.max() > 0 else 0.1
    return (diff > threshold).astype(np.float32)


def create_li_image(ma: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Metal pixels replaced by the mean of the others."""
    li = ma.copy()
    if mask.sum() > 0:
        non_metal = ma[mask < 0.5]
        li[mask > 0.5] = non_metal.mean() if non_metal.size else ma.mean()
    return li


def _resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """Separable bilinear resize to size x size."""
    h, w = img.shape
    ys = np.linspace(0, h - 1, size)
    xs = np.linspace(0, w - 1, size)
    y0 = np.floor(ys).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    fy = (ys - y0)[:, None]
    rows = img[y0] * (1 - fy) + img[y1] * fy
    x0 = np.floor(xs).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    fx = (xs - x0)[None, :]
    return (rows[:, x0] * (1 - fx) + rows[:, x1] * fx).astype(np.float32)


class BenchmarkFinetuneDataset:
    """Paired artifact/clean .npy tree -> the fine-tune dict.  ``mode``:
    "patch" (random crops in training, the centre crop otherwise) or
    "resize" (the whole slice resized to ``patch_size``)."""

    def __init__(
        self,
        artifact_dir: str,
        clean_dir: str,
        patch_size: int = 64,
        mode: str = "patch",
        normalize_range: str = "0_1",
        train: bool = True,
        hu_range: Tuple[float, float] = (-1000.0, 2000.0),
        seed: int = 66,
    ):
        if mode not in ("patch", "resize"):
            raise ValueError(f"mode must be patch|resize, got {mode!r}")
        self.artifact_files, self.clean_files = _paired_files(artifact_dir, clean_dir)
        self.patch_size = patch_size
        self.mode = mode
        self.normalize_range = normalize_range
        self.train = train
        self.hu_range = hu_range
        self.crop_state = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.artifact_files)

    def _normalize(self, img: np.ndarray) -> np.ndarray:
        lo, hi = self.hu_range
        img = np.clip((img - lo) / (hi - lo), 0, 1)
        if self.normalize_range == "0_255":
            img = img * 255.0
        return img.astype(np.float32)

    def _extract(self, ma: np.ndarray, gt: np.ndarray):
        ps = self.patch_size
        if self.mode == "resize":
            return _resize_bilinear(ma, ps), _resize_bilinear(gt, ps)
        h, w = ma.shape
        if h <= ps or w <= ps:
            pad_ma = np.zeros((max(h, ps), max(w, ps)), np.float32)
            pad_gt = np.zeros_like(pad_ma)
            pad_ma[:h, :w] = ma
            pad_gt[:h, :w] = gt
            ma, gt = pad_ma, pad_gt
            h, w = ma.shape
        if self.train:
            y = self.crop_state.randint(0, h - ps + 1)
            x = self.crop_state.randint(0, w - ps + 1)
        else:
            y, x = (h - ps) // 2, (w - ps) // 2
        return ma[y:y + ps, x:x + ps], gt[y:y + ps, x:x + ps]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        i = idx % len(self.artifact_files)
        ma = self._normalize(np.load(self.artifact_files[i]).astype(np.float32))
        gt = self._normalize(np.load(self.clean_files[i]).astype(np.float32))
        ma, gt = self._extract(ma, gt)
        mask = create_metal_mask(ma, gt)
        return {
            "Xma": ma,
            "Xgt": gt,
            "XLI": create_li_image(ma, mask),
            "M": (1.0 - mask).astype(np.float32),
            "mask": mask,
        }
