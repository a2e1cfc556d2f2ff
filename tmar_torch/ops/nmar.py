"""NMAR prior and sinogram-domain fine-tune helpers (the port's own copy of
``tmar.ops.nmar``):

* ``nmar_prior``: the tissue-classified prior image: gaussian smoothing,
  thresholds from a 1-D k-means (3 clusters seeded at air / water /
  2·water; Lloyd's algorithm, no sklearn), then air / water flattening.
  numpy and scipy on the host, as in the JAX package;
* ``sinogram_loss``: the trace-masked sinogram L1, in torch;
* ``sparse_view_subsample``: keep every ``factor``-th projection angle.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy.ndimage import gaussian_filter


def _kmeans_1d(x: np.ndarray, init_centers: np.ndarray, max_iter: int = 300) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd's k-means on 1-D data from fixed initial centres (one init)."""
    centers = init_centers.astype(np.float64).copy()
    labels = np.zeros(x.shape[0], np.int64)
    for it in range(max_iter):
        new_labels = np.abs(x[:, None] - centers[None, :]).argmin(axis=1)
        if it > 0 and (new_labels == labels).all():
            break
        labels = new_labels
        for k in range(len(centers)):
            sel = x[labels == k]
            if sel.size:
                centers[k] = sel.mean()
    return centers, labels


def nmar_prior(
    xli: np.ndarray,
    metal_mask: np.ndarray,
    miu_air: float = 0.0,
    miu_water: float = 0.192 * 255.0,
    smooth_sigma: float = 1.0,
) -> np.ndarray:
    """Tissue-classified NMAR prior of a batch of [B, H, W] LI images.
    ``metal_mask`` is 1 on non-metal pixels (metal pixels, < 0.5, are filled
    with water first).  Returns [B, H, W] float32."""
    out = []
    for i in range(xli.shape[0]):
        im = xli[i].astype(np.float64).copy()
        im[metal_mask[i] < 0.5] = miu_water
        x1d = im.ravel()
        try:
            _, labels = _kmeans_1d(x1d, np.array([miu_air, miu_water, 2 * miu_water]))
            bone = x1d[labels == 2]
            thresh_bone = max(bone.min() if bone.size else np.inf, 1.2 * miu_water)
            water = x1d[labels == 1]
            thresh_water = water.min() if water.size else 0.5 * miu_water
        except Exception:
            thresh_bone, thresh_water = 1.5 * miu_water, 0.5 * miu_water
        im_sm = gaussian_filter(im, smooth_sigma, mode="nearest")
        prior = im_sm.copy()
        prior[im_sm <= thresh_water] = miu_air
        prior[(prior > thresh_water) & (im_sm < thresh_bone)] = miu_water
        out.append(prior)
    return np.stack(out).astype(np.float32)


def sinogram_loss(pred_sino: torch.Tensor, gt_sino: torch.Tensor, trace_mask=None) -> torch.Tensor:
    """Mean |pred - gt|, weighted by the trace mask where one is given."""
    diff = (pred_sino - gt_sino).abs()
    return (diff * trace_mask).mean() if trace_mask is not None else diff.mean()


def sparse_view_subsample(sino, factor: int):
    """[B, A, det] -> [B, A // factor, det] (every ``factor``-th angle)."""
    return sino[:, ::factor, :]
