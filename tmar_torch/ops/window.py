"""Window partitioning utilities for shifted-window attention.

Pure layout ops (reshape/permute/roll) on NHWC tensors, the PyTorch
counterpart of ``tmar.ops.window``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def window_partition(x: torch.Tensor, window_size: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """[B, H, W, C] -> ([B*wh*ww, ws, ws, C], (wh, ww)); H, W multiples of ws."""
    B, H, W, C = x.shape
    ws = window_size
    wh, ww = H // ws, W // ws
    x = x.reshape(B, wh, ws, ww, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (wh, ww)


def window_unpartition(windows: torch.Tensor, num_windows: Tuple[int, int]) -> torch.Tensor:
    """[B*wh*ww, ws, ws, C] -> [B, H, W, C]."""
    wh, ww = num_windows
    ws = windows.shape[1]
    C = windows.shape[-1]
    B = windows.shape[0] // (wh * ww)
    x = windows.reshape(B, wh, ww, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, wh * ws, ww * ws, C)


def cyclic_shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Roll the spatial dims of [B, H, W, C] by ``-shift`` (SW-MSA shift)."""
    if shift == 0:
        return x
    return torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))


def reverse_cyclic_shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    if shift == 0:
        return x
    return torch.roll(x, shifts=(shift, shift), dims=(1, 2))


def pad_to_multiple(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Zero-pad H, W (bottom/right) of [B, H, W, C] to a multiple; returns the
    padded tensor and the original (H, W) for the crop after."""
    B, H, W, C = x.shape
    pad_h = (-H) % multiple
    pad_w = (-W) % multiple
    if pad_h == 0 and pad_w == 0:
        return x, (H, W)
    return F.pad(x, (0, 0, 0, pad_w, 0, pad_h)), (H, W)


@lru_cache(maxsize=None)
def shift_mask_components(window_size: int, shift: int) -> Tuple[np.ndarray, np.ndarray]:
    """Decomposed SW-MSA mask (m_edge_row, m_edge_col), each [N, N] float32
    (cached per geometry: treat the arrays as read-only).

    Window (r, c) of a (wh, ww) grid gets [r == wh-1]·m_row + [c == ww-1]·m_col:
    -100 where two tokens lie in different row (column) bands, so -200 where
    both differ, which is the same as the dense -100 mask after softmax.
    """
    ws = window_size
    band = (np.arange(ws) >= ws - shift).astype(np.int32)
    tok_row = np.repeat(band, ws)
    tok_col = np.tile(band, ws)
    m_row = np.where(tok_row[:, None] != tok_row[None, :], -100.0, 0.0)
    m_col = np.where(tok_col[:, None] != tok_col[None, :], -100.0, 0.0)
    return m_row.astype(np.float32), m_col.astype(np.float32)
