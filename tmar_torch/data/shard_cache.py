"""Pre-sharded npy cache for the host input pipeline (the port's own copy of
``tmar.data.shard_cache``: the same ``index.json``, version 1, and the same
shard file names, so either package reads the other's cache).

SynDeepLesion's native layout is thousands of small HDF5 files read at
random.  This module materialises any dataset into a few large ``.npy``
shards that are read back with ``mmap`` (sequential, page-cache-friendly IO,
no per-sample file opens) and serves them through the dict-of-arrays
protocol that ``tmar_torch.data.loader`` consumes.

Layout of a cache directory::

    index.json                     {keys, shard_sizes, shape, dtype, version}
    <key>_00000.npy ...            one array [n_i, H, W] per key per shard

Cropping/flipping stay read-time (ShardCachedDataset) so a full-slice cache
serves any patch size; the random mask-id choice of the train dataset is
frozen at build time (``masks_per_image`` copies per slice keep diversity).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from tmar_torch.data.transforms import random_crop_pair, random_flip_pair

_VERSION = 1


def build_shard_cache(
    dataset,
    out_dir: str,
    keys: Sequence[str] = ("ct", "gt", "li"),
    shard_size: int = 256,
    dtype: str = "float32",
    indices: Optional[Sequence[int]] = None,
) -> str:
    """Materialise ``dataset[i]`` dicts into npy shards under ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    idxs = list(indices) if indices is not None else list(range(len(dataset)))
    if not idxs:
        raise ValueError("empty dataset / indices")
    shard_sizes: List[int] = []
    shape = None
    shard_id = 0
    buf: Dict[str, List[np.ndarray]] = {k: [] for k in keys}

    def flush():
        nonlocal shard_id
        n = len(buf[keys[0]])
        if n == 0:
            return
        for k in keys:
            arr = np.stack(buf[k]).astype(dtype)
            np.save(os.path.join(out_dir, f"{k}_{shard_id:05d}.npy"), arr)
            buf[k].clear()
        shard_sizes.append(n)
        shard_id += 1

    for i in idxs:
        sample = dataset[int(i)]
        for k in keys:
            a = np.asarray(sample[k])
            if shape is None:
                shape = list(a.shape)
            buf[k].append(a)
        if len(buf[keys[0]]) >= shard_size:
            flush()
    flush()

    index = {
        "version": _VERSION,
        "keys": list(keys),
        "shard_sizes": shard_sizes,
        "shape": shape,
        "dtype": dtype,
    }
    with open(os.path.join(out_dir, "index.json"), "w") as f:
        json.dump(index, f)
    return out_dir


def cache_syndeeplesion(
    root: str,
    out_dir: str,
    masks_per_image: int = 4,
    shard_size: int = 256,
    dtype: str = "float32",
    seed: int = 66,
) -> str:
    """Freeze the SynDeepLesion train tree (full slices, ``masks_per_image``
    deterministic mask ids per slice) into a shard cache."""
    import glob as _glob

    from tmar_torch.data.syndeeplesion import _SynDeepLesionBase

    files = sorted(_glob.glob(os.path.join(root, "train_640geo", "*", "*", "gt.h5")))
    base = _SynDeepLesionBase(root, files, n_masks=79, seed=seed)
    rng = np.random.RandomState(seed + 3)

    class _FullSliceView:
        def __len__(self):
            return len(files) * masks_per_image

        def __getitem__(self, i):
            f = files[i // masks_per_image]
            mask_id = int(rng.randint(0, base.n_masks))
            ct, gt, li = base._load_triplet(f, mask_id)
            return {"ct": ct, "gt": gt, "li": li}

    return build_shard_cache(
        _FullSliceView(), out_dir, keys=("ct", "gt", "li"),
        shard_size=shard_size, dtype=dtype,
    )


class ShardCachedDataset:
    """Random-access view over a shard cache; optional read-time crop/flip.

    mmap-backed: each shard is opened once with ``np.load(mmap_mode='r')``;
    a sample read touches only its pages.  Drop-in for the Loader protocol.
    """

    def __init__(
        self,
        cache_dir: str,
        patch_size: Optional[int] = None,
        augment: bool = False,
        seed: int = 66,
        length: Optional[int] = None,
    ):
        with open(os.path.join(cache_dir, "index.json")) as f:
            self.index = json.load(f)
        if self.index.get("version") != _VERSION:
            raise ValueError(f"unsupported cache version in {cache_dir}")
        self.cache_dir = cache_dir
        self.keys = self.index["keys"]
        self.shard_sizes = self.index["shard_sizes"]
        self.offsets = np.concatenate([[0], np.cumsum(self.shard_sizes)])
        self.n = int(self.offsets[-1])
        self.length = length if length is not None else self.n
        self.patch_size = patch_size
        self.augment = augment
        self.crop_state = np.random.RandomState(seed)
        self.aug_state = np.random.RandomState(seed + 1)
        self._mmaps: Dict[str, List[np.ndarray]] = {
            k: [
                np.load(os.path.join(cache_dir, f"{k}_{s:05d}.npy"), mmap_mode="r")
                for s in range(len(self.shard_sizes))
            ]
            for k in self.keys
        }

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        i = idx % self.n
        s = int(np.searchsorted(self.offsets, i, side="right") - 1)
        j = i - int(self.offsets[s])
        arrs = [np.asarray(self._mmaps[k][s][j], dtype=np.float32) for k in self.keys]
        if self.patch_size is not None:
            arrs = list(random_crop_pair(arrs, self.patch_size, self.crop_state))
        if self.augment:
            arrs = list(random_flip_pair(arrs, self.aug_state))
        return dict(zip(self.keys, arrs))
