"""Evaluation metrics: PSNR, SSIM, MAE/RMSE, regional, HU-domain (the
port's own copy of ``tmar.eval.metrics``; numpy and scipy on the host).

* PSNR / SSIM with skimage semantics (data_range 1.0 on [0,1] images; SSIM
  with a win_size=7 uniform window, or the gaussian variant);
* regional metal / band / non-metal MSE + PSNR with the data-range-2 formula;
* HU-domain MAE/RMSE per tissue class, HU = norm·4000 − 1000, and
  ±10/20/50-HU tolerance rates.

All image args are 2-D numpy arrays unless noted; [0,1] range for the
psnr/ssim/hu helpers, [-1,1] for the regional helper.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from scipy.ndimage import uniform_filter

from tmar_torch.losses import extract_metal_mask
from tmar_torch.ops.morphology import dilate_mask


def crop_border(img: np.ndarray, border: int) -> np.ndarray:
    """Crop a pixel border before metric computation (SwinIR-style)."""
    if border == 0:
        return img
    return img[border:-border, border:-border]


def to_y_channel(img: np.ndarray) -> np.ndarray:
    """RGB [H,W,3] in [0,1] -> BT.601 luma in [0,1] (CT slices are already
    single-channel)."""
    if img.ndim == 2 or img.shape[-1] == 1:
        return img.reshape(img.shape[:2])
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return (65.481 * r + 128.553 * g + 24.966 * b + 16.0) / 255.0


def mae(pred: np.ndarray, target: np.ndarray) -> float:
    return float(np.abs(pred - target).mean())


def rmse(pred: np.ndarray, target: np.ndarray) -> float:
    return float(np.sqrt(((pred - target) ** 2).mean()))


def psnr(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(((pred - target) ** 2).mean())
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def ssim(
    pred: np.ndarray,
    target: np.ndarray,
    data_range: float = 1.0,
    win_size: int = 7,
    gaussian: bool = False,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """Mean SSIM, skimage-compatible.

    gaussian=False: uniform win_size window with sample covariance
    normalisation (N/(N-1)), skimage's default.  gaussian=True: 11-tap gaussian
    (sigma 1.5), skimage's gaussian_weights variant.
    """
    pred = pred.astype(np.float64)
    target = target.astype(np.float64)

    if gaussian:
        from scipy.ndimage import gaussian_filter

        filt = lambda a: gaussian_filter(a, sigma, truncate=3.5)
        win_size = 2 * int(3.5 * sigma + 0.5) + 1  # skimage's derived window (11)
        n = win_size ** pred.ndim
        cov_norm = n / (n - 1)
    else:
        filt = lambda a: uniform_filter(a, win_size)
        n = win_size ** pred.ndim
        cov_norm = n / (n - 1)

    ux = filt(pred)
    uy = filt(target)
    uxx = filt(pred * pred)
    uyy = filt(target * target)
    uxy = filt(pred * target)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    num = (2 * ux * uy + c1) * (2 * vxy + c2)
    den = (ux**2 + uy**2 + c1) * (vx + vy + c2)
    s = num / den
    # skimage crops the (win_size-1)/2 border before averaging
    pad = (win_size - 1) // 2
    s = s[pad:-pad, pad:-pad] if pad else s
    return float(s.mean())


def compute_regional_metrics(
    pred: np.ndarray,
    target: np.ndarray,
    ct: np.ndarray,
    threshold: float = 0.6,
    radius: int = 5,
) -> Dict[str, float]:
    """Metal / band / non-metal MSE+PSNR (data range 2); inputs in [-1, 1],
    2-D.  The mask and its dilation are the losses' own, on the CPU."""
    ct4 = torch.from_numpy(np.ascontiguousarray(ct, dtype=np.float32))[None, ..., None]
    M4 = extract_metal_mask(ct4, threshold)
    M = M4[0, ..., 0].numpy()
    B = dilate_mask(M4, radius)[0, ..., 0].numpy()
    band = B - M
    non_metal = 1.0 - B

    out: Dict[str, float] = {}
    for name, mask in (("metal", M), ("band", band), ("non_metal", non_metal)):
        s = mask.sum()
        if s > 0:
            mse = float((((pred - target) ** 2) * mask).sum() / s)
            out[f"{name}_MSE"] = mse
            out[f"{name}_PSNR"] = float(10 * np.log10(4.0 / (mse + 1e-10)))
        else:
            out[f"{name}_MSE"] = 0.0
            out[f"{name}_PSNR"] = 0.0
    return out


def to_hu(x01: np.ndarray) -> np.ndarray:
    """normalised [0,1] -> approximate HU."""
    return x01 * 4000.0 - 1000.0


TISSUE_RANGES: Dict[str, Tuple[float, float]] = {
    "air": (0.0, 0.125),            # -1000..-500 HU
    "soft_tissue": (0.2375, 0.275), # -50..100 HU
    "bone": (0.275, 0.5),           # 100..1000 HU
    "metal_region": (0.5, 1.0),     # >1000 HU
}


def compute_hu_accuracy(pred01: np.ndarray, target01: np.ndarray) -> Dict[str, float]:
    """Overall + per-tissue HU MAE (inputs in [0,1])."""
    pred_hu = to_hu(pred01)
    target_hu = to_hu(target01)
    err = np.abs(pred_hu - target_hu)
    out: Dict[str, float] = {
        "overall_HU_MAE": float(err.mean()),
        "overall_HU_RMSE": float(np.sqrt((err**2).mean())),
    }
    for tissue, (lo, hi) in TISSUE_RANGES.items():
        mask = (target01 >= lo) & (target01 < hi)
        if mask.sum() > 0:
            out[f"{tissue}_HU_MAE"] = float(err[mask].mean())
            out[f"{tissue}_pixel_count"] = int(mask.sum())
        else:
            out[f"{tissue}_HU_MAE"] = 0.0
            out[f"{tissue}_pixel_count"] = 0
    return out


def hu_tolerance_rates(
    pred01: np.ndarray, target01: np.ndarray, tolerances=(10.0, 20.0, 50.0)
) -> Dict[str, float]:
    """Fraction of pixels within ±N HU of ground truth."""
    err = np.abs(to_hu(pred01) - to_hu(target01))
    return {f"within_{int(t)}HU": float((err <= t).mean()) for t in tolerances}
