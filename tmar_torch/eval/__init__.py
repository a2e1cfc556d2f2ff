"""Inference entry points."""

from tmar_torch.eval.inference import (
    full_slice_eval,
    make_inference_fn,
    make_tiled_eval,
    tiled_eval,
)

__all__ = ["full_slice_eval", "make_inference_fn", "make_tiled_eval", "tiled_eval"]
