"""N-Gram context primitives (the counterpart of ``tmar.ops.ngram``).

``seq_refl_win_pad`` pads the unigram grid "sequence-reflectively": forward
appends rows/cols [L-n : L-1] at the bottom/right, backward prepends rows/cols
[1 : n] at the top/left (single-element reflect padding for ngram = 2).
``sliding_patches`` takes every n×n sliding block of the padded grid.
``ngram_windows`` is the two in one gather over a constant index map.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from tmar_torch.ops.attention import static_gather


def seq_refl_win_pad(x: torch.Tensor, ngram: int, back: bool = False) -> torch.Tensor:
    """Pad [B, H, W, C] by (ngram-1) on bottom/right (forward) or top/left (back)."""
    n = ngram
    if n == 1:
        return x
    if not back:
        x = torch.cat([x, x[:, -n:-1]], dim=1)
        return torch.cat([x, x[:, :, -n:-1]], dim=2)
    x = torch.cat([x[:, 1:n], x], dim=1)
    return torch.cat([x[:, :, 1:n], x], dim=2)


def sliding_patches(x: torch.Tensor, ngram: int) -> torch.Tensor:
    """[B, H+n-1, W+n-1, C] -> [B, H, W, n(di), n(dj), C] of n×n sliding blocks."""
    n = ngram
    B, Hp, Wp, C = x.shape
    H, W = Hp - n + 1, Wp - n + 1
    rows = [
        torch.stack([x[:, di : di + H, dj : dj + W] for dj in range(n)], dim=3)
        for di in range(n)
    ]
    return torch.stack(rows, dim=3)


@lru_cache(maxsize=None)
def ngram_window_index(wh: int, ww: int, ngram: int, back: bool) -> np.ndarray:
    """int64 [wh*ww*n*n]: for window (i, j) and offset (di, dj), the flat cell
    of the [wh, ww] grid that ``sliding_patches(seq_refl_win_pad(...))`` puts
    there.  Computed in numpy, the same padding and blocks on the grid of
    cell numbers, so that it stays a host array when a trace first asks."""
    n = ngram
    cells = np.arange(wh * ww, dtype=np.int64).reshape(wh, ww)
    if n > 1:
        if back:
            cells = np.concatenate([cells[1:n], cells], axis=0)
            cells = np.concatenate([cells[:, 1:n], cells], axis=1)
        else:
            cells = np.concatenate([cells, cells[-n:-1]], axis=0)
            cells = np.concatenate([cells, cells[:, -n:-1]], axis=1)
    blocks = [[cells[di : di + wh, dj : dj + ww] for dj in range(n)] for di in range(n)]
    # [wh, ww, n(di), n(dj)], flattened
    return np.stack([np.stack(row, axis=-1) for row in blocks], axis=-2).reshape(-1)


def ngram_windows(u: torch.Tensor, ngram: int, back: bool = False) -> torch.Tensor:
    """u [B, wh, ww, C] -> the n×n sliding windows over the sequence-reflect
    padded grid as tokens [B*wh*ww, n*n, C]: the same values as
    ``sliding_patches(seq_refl_win_pad(u, n, back), n)``, by one gather (and
    one deterministic gather-and-sum in the backward) instead of a dozen
    slices, stacks and concatenations."""
    B, wh, ww, C = u.shape
    tokens = static_gather(u.reshape(B, wh * ww, C), ngram_window_index(wh, ww, ngram, back))
    return tokens.reshape(B * wh * ww, ngram * ngram, C)
