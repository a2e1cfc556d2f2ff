"""Finite-difference image gradients with replicate padding (the counterpart
of ``tmar.ops.gradients``): forward differences, padded back to the input
size by repeating the last column / row of the difference.
"""

from __future__ import annotations

from typing import Tuple

import torch


def image_gradients(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, H, W, C] -> (grad_x over W, grad_y over H), both [B, H, W, C]."""
    dx = x[:, :, 1:, :] - x[:, :, :-1, :]
    dy = x[:, 1:, :, :] - x[:, :-1, :, :]
    grad_x = torch.cat([dx, dx[:, :, -1:, :]], dim=2)
    grad_y = torch.cat([dy, dy[:, -1:, :, :]], dim=1)
    return grad_x, grad_y
