"""Metrics and inference entry points.  The comparison harness, the adapters,
the ablation engine, the figures and the clinical volume path are modules of
their own (``tmar_torch.eval.harness`` and the rest); ``figures`` needs
matplotlib and is imported only where a figure is drawn."""

from tmar_torch.eval.inference import (
    full_slice_eval,
    make_inference_fn,
    make_tiled_eval,
    tiled_eval,
)
from tmar_torch.eval.metrics import (
    compute_hu_accuracy,
    compute_regional_metrics,
    hu_tolerance_rates,
    mae,
    psnr,
    rmse,
    ssim,
)

__all__ = [
    "psnr",
    "ssim",
    "mae",
    "rmse",
    "compute_regional_metrics",
    "compute_hu_accuracy",
    "hu_tolerance_rates",
    "full_slice_eval",
    "make_inference_fn",
    "make_tiled_eval",
    "tiled_eval",
]
