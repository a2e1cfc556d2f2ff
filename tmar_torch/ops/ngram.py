"""N-Gram context primitives (the counterpart of ``tmar.ops.ngram``).

``seq_refl_win_pad`` pads the unigram grid "sequence-reflectively": forward
appends rows/cols [L-n : L-1] at the bottom/right, backward prepends rows/cols
[1 : n] at the top/left (single-element reflect padding for ngram = 2).
``sliding_patches`` takes every n×n sliding block of the padded grid.
"""

from __future__ import annotations

import torch


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
