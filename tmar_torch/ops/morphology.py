"""Morphological dilation by a max window (the counterpart of
``tmar.ops.morphology``): dilating a binary mask with a square structuring
element of radius r is ``max_pool2d(kernel 2r+1, stride 1, padding r)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilate_mask(mask: torch.Tensor, radius: int = 5) -> torch.Tensor:
    """Dilate a [B, H, W, C] (or [B, H, W]) mask with a (2r+1)² max window."""
    if radius == 0:
        return mask
    squeeze = mask.ndim == 3
    if squeeze:
        mask = mask[..., None]
    # max_pool2d pads with -inf, which never wins over a mask in {0, 1}
    out = F.max_pool2d(
        mask.permute(0, 3, 1, 2), kernel_size=2 * radius + 1, stride=1, padding=radius
    ).permute(0, 2, 3, 1)
    out = out.clamp(min=0.0)
    return out[..., 0] if squeeze else out
