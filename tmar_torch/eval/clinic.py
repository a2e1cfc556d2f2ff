"""Clinical NIfTI volume inference (the counterpart of ``tmar.eval.clinic``):
load a CT volume, HU-window each slice, run the generator on the slices in
batches, rescale to [0, 1], and write the restored volume back as NIfTI.
The generator is fed the artifact image, never the LI image.
"""

from __future__ import annotations

import os
from typing import Callable, Tuple

import numpy as np

from tmar_torch.data.nifti import read_nifti, write_nifti
from tmar_torch.data.transforms import hu_window


def restore_volume(
    forward: Callable[[np.ndarray], np.ndarray],
    volume_hu: np.ndarray,
    batch_size: int = 8,
    hu_range: Tuple[float, float] = (-1000.0, 2000.0),
) -> np.ndarray:
    """volume_hu: [H, W, S] HU volume -> restored [H, W, S] in [0, 1]."""
    H, W, S = volume_hu.shape
    slices = np.stack([hu_window(volume_hu[:, :, s], *hu_range) for s in range(S)])
    slices = slices[..., None]  # [S, H, W, 1] in [-1, 1]
    out = np.empty_like(slices)
    pad = (-S) % batch_size
    if pad:
        slices = np.concatenate([slices, np.zeros((pad, H, W, 1), np.float32)])
    for i in range(0, slices.shape[0], batch_size):
        out_chunk = forward(slices[i : i + batch_size])
        end = min(i + batch_size, S)
        out[i:end] = out_chunk[: end - i]
    restored = (out[..., 0] + 1.0) / 2.0  # [S, H, W] in [0, 1]
    return np.transpose(restored, (1, 2, 0))


def restore_nifti_file(
    forward: Callable[[np.ndarray], np.ndarray],
    in_path: str,
    out_path: str,
    batch_size: int = 8,
    hu_range: Tuple[float, float] = (-1000.0, 2000.0),
) -> str:
    vol, affine = read_nifti(in_path)
    if vol.ndim != 3:
        raise ValueError(f"{in_path}: expected a 3-D volume, got shape {vol.shape}")
    restored = restore_volume(forward, vol.astype(np.float32), batch_size, hu_range)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_nifti(out_path, restored.astype(np.float32), affine)
    return out_path
