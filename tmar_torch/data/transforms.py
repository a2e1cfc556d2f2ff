"""Host-side (numpy) data transforms (the port's own copy of
``tmar.data.transforms``):

* clip to [0,1] then scale to [-1,1];
* SpineWeb HU window [-1000, 2000] -> [0,1] -> [-1,1];
* paired random crop with a dedicated seeded RandomState;
* paired random horizontal/vertical flips sharing one draw across images.

All arrays are HW (single-channel); the channel axis is added at batch time.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def normalize01_to_pm1(x: np.ndarray) -> np.ndarray:
    """clip [0,1] then map to [-1,1] (float32)."""
    x = np.clip(x, 0.0, 1.0)
    return (x * 2.0 - 1.0).astype(np.float32)


def hu_window(x: np.ndarray, hu_min: float = -1000.0, hu_max: float = 2000.0) -> np.ndarray:
    """HU window -> [0,1] -> [-1,1]."""
    x = np.clip(x, hu_min, hu_max)
    x = (x - hu_min) / (hu_max - hu_min)
    return (x * 2.0 - 1.0).astype(np.float32)


def random_crop_pair(
    images: Sequence[np.ndarray], patch: int, rng: np.random.RandomState
) -> Tuple[np.ndarray, ...]:
    """Same random crop applied to all images (all HxW, same shape)."""
    h, w = images[0].shape[:2]
    if h == patch and w == patch:
        return tuple(images)
    row = rng.randint(0, h - patch + 1)
    col = rng.randint(0, w - patch + 1)
    return tuple(img[row : row + patch, col : col + patch] for img in images)


def random_flip_pair(
    images: Sequence[np.ndarray], rng: np.random.RandomState
) -> Tuple[np.ndarray, ...]:
    """Shared random horizontal/vertical flips."""
    hflip = rng.rand() < 0.5
    vflip = rng.rand() < 0.5
    out = []
    for img in images:
        if hflip:
            img = img[:, ::-1]
        if vflip:
            img = img[::-1, :]
        out.append(np.ascontiguousarray(img))
    return tuple(out)
