"""Inference paths: full-slice and overlapping tiled evaluation (the
counterpart of ``tmar.eval.inference``).

* full-slice: the generator pads H, W to multiples of 32 internally and
  crops back, so a 416² slice runs as one 448²-padded forward;
* tiled: overlapping tiles (default 64 px, stride 32) through the forward,
  averaged by coverage weight: ``tiled_eval`` batches them through a numpy
  forward and assembles on the host; ``make_tiled_eval`` extracts every tile,
  runs one batched forward and assembles on the device, with a ``mesh``
  spreading the tiles over the data axis (``tmar_torch.parallel``).
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from tmar_torch.core.mesh import DATA_AXIS, all_gather_rows, axis_rank, axis_size
from tmar_torch.device import resolve_device


def make_inference_fn(model: torch.nn.Module, device="cuda") -> Callable[[np.ndarray], np.ndarray]:
    """An NHWC numpy -> numpy forward closure running ``model`` on ``device``
    with autograd off.  Moves the model there and sets it to eval mode."""
    dev = resolve_device(device)
    model = model.to(dev).eval()

    @torch.no_grad()
    def forward(x: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
        return model(t).float().cpu().numpy()

    return forward


def full_slice_eval(forward: Callable[[np.ndarray], np.ndarray], ct: np.ndarray) -> np.ndarray:
    """ct: [B, H, W, 1] in [-1, 1] -> restored [B, H, W, 1]."""
    return forward(ct)


def _tile_positions(size: int, tile: int, stride: int) -> List[int]:
    if size <= tile:
        return [0]
    pos = list(range(0, size - tile + 1, stride))
    if pos[-1] != size - tile:
        pos.append(size - tile)
    return pos


def tiled_eval(
    forward: Callable[[np.ndarray], np.ndarray],
    ct: np.ndarray,
    tile: int = 64,
    stride: int = 32,
    tile_batch: int = 64,
) -> np.ndarray:
    """Overlapping tiled inference with coverage-weight averaging.  ct
    [B, H, W, 1]; tiles go through ``forward`` ``tile_batch`` at a time
    (the last batch zero-padded, so every call has one shape)."""
    B, H, W, C = ct.shape
    rows = _tile_positions(H, tile, stride)
    cols = _tile_positions(W, tile, stride)

    out = np.zeros_like(ct, dtype=np.float64)
    weight = np.zeros((1, H, W, 1), dtype=np.float64)

    coords = [(r, c) for r in rows for c in cols]
    tiles = np.stack(
        [ct[b, r : r + tile, c : c + tile, :] for b in range(B) for (r, c) in coords]
    )
    n = tiles.shape[0]
    pad = (-n) % tile_batch
    if pad:
        tiles = np.concatenate([tiles, np.zeros((pad,) + tiles.shape[1:], tiles.dtype)])
    results = np.concatenate(
        [forward(tiles[i : i + tile_batch]) for i in range(0, tiles.shape[0], tile_batch)]
    )[:n]

    k = 0
    for b in range(B):
        for r, c in coords:
            out[b, r : r + tile, c : c + tile, :] += results[k]
            k += 1
    for r, c in coords:
        weight[0, r : r + tile, c : c + tile, :] += 1.0
    return (out / weight).astype(np.float32)


def make_tiled_eval(
    model: torch.nn.Module, tile: int = 64, stride: int = 32, device="cuda", mesh=None
) -> Callable[[np.ndarray], np.ndarray]:
    """Device-side tiled eval (the counterpart of
    ``tmar.eval.inference.make_tiled_eval_jit``): tile extraction, ONE
    batched forward of all tiles and the coverage-weighted assembly run on
    ``device``, with autograd off; numpy [B, H, W, C] in, numpy out.  Moves
    the model there and sets it to eval mode.  One indexed gather and
    scatter serve every geometry, where the JAX function reshapes aligned
    ones by phase group.

    With a ``mesh`` (``tmar_torch.core.mesh``; every rank calls ``run`` on
    the same slices) the flat tile batch is split over the data axis: the
    tile count is padded to a multiple of the data ranks with repeated
    tiles, each rank runs its tiles, ``all_gather_into_tensor`` brings them
    back (the padding dropped), and every rank assembles the same output."""
    dev = resolve_device(device)
    model = model.to(dev).eval()

    @torch.no_grad()
    def run(ct: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(ct, dtype=np.float32)).to(dev)
        return _tiled_run(model, tile, stride, t, mesh).cpu().numpy()

    return run


def sharded_forward(model, tiles: torch.Tensor, mesh) -> torch.Tensor:
    """``model`` over a tile batch split over the data axis of ``mesh``: the
    count padded to a multiple of the data ranks with repeated tiles, each
    rank's share run, the results gathered and the padding dropped.  float32."""
    dp = axis_size(mesh, DATA_AXIS)
    n = tiles.shape[0]
    per = -(-n // dp)
    padded = tiles[torch.arange(per * dp, device=tiles.device) % n]
    r = axis_rank(mesh, DATA_AXIS)
    return all_gather_rows(mesh, model(padded[r * per:(r + 1) * per]).float())[:n]


def _tiled_run(model, tile: int, stride: int, ct: torch.Tensor, mesh=None) -> torch.Tensor:
    """ct [B, H, W, C] on the device -> the coverage-weighted average of the
    restored tiles, float32.  One index of flat pixel positions, tile by tile,
    gathers every tile of every image; the tiles go through the model in one
    batch (split over the data axis of ``mesh``), and ``index_add_`` puts
    each result and its coverage back."""
    B, H, W, C = ct.shape
    th, tw = min(tile, H), min(tile, W)
    dev = ct.device
    rows = torch.tensor(_tile_positions(H, tile, stride), device=dev)
    cols = torch.tensor(_tile_positions(W, tile, stride), device=dev)
    r = (rows[:, None] + torch.arange(th, device=dev))[:, None, :, None]  # [nr, 1, th, 1]
    c = (cols[:, None] + torch.arange(tw, device=dev))[None, :, None, :]  # [1, nc, 1, tw]
    idx = (r * W + c).reshape(-1)
    n = idx.numel() // (th * tw)
    tiles = ct.reshape(B, H * W, C)[:, idx].reshape(B * n, th, tw, C)
    res = model(tiles).float() if mesh is None else sharded_forward(model, tiles, mesh)
    out = torch.zeros((B, H * W, C), device=dev).index_add_(1, idx, res.reshape(B, -1, C))
    weight = torch.zeros(H * W, device=dev).index_add_(0, idx, torch.ones(idx.numel(), device=dev))
    return (out / weight[:, None]).reshape(B, H, W, C)
