"""SpineWeb .npy pipeline (HU-windowed), train and test modes (the port's
own copy of ``tmar.data.spineweb``; the same samples per index and seed).

Paired artifact/clean .npy files matched by basename, HU window
[-1000, 2000] -> [0,1] -> [-1,1], random crop + shared flips for training,
full slices for test.  Returns the (artifact, clean, artifact) triplet: the
LI slot holds the artifact image.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from tmar_torch.data.transforms import hu_window, random_crop_pair, random_flip_pair


def _paired_files(artifact_dir: str, clean_dir: str):
    def _scan(d):
        return {
            fn: os.path.join(d, fn)
            for fn in sorted(os.listdir(d))
            if fn.endswith(".npy")
        }

    art = _scan(artifact_dir)
    cln = _scan(clean_dir)
    common = sorted(set(art) & set(cln))
    if not common:
        raise ValueError(
            f"no matching artifact/clean basenames between {artifact_dir} and {clean_dir}"
        )
    return [art[b] for b in common], [cln[b] for b in common]


class SpineWebDataset:
    def __init__(
        self,
        artifact_dir: str,
        clean_dir: str,
        patch_size: int = 0,
        train: bool = True,
        hu_range: Tuple[float, float] = (-1000.0, 2000.0),
        seed: int = 66,
        length: int = 0,
    ):
        """``length`` (train mode): virtual epoch size — samples cycle over
        the file list, one random crop each.  Without it an epoch is one
        pass over the files, which with few slice pairs is a handful of
        steps.  The SynDeepLesion train dataset has the same knob."""
        self.artifact_files, self.clean_files = _paired_files(artifact_dir, clean_dir)
        self.patch_size = patch_size
        self.train = train
        self.hu_range = hu_range
        self.crop_state = np.random.RandomState(seed)
        self.aug_state = np.random.RandomState(seed + 1)
        self.length = length if (train and length) else 0

    def __len__(self) -> int:
        return self.length or len(self.artifact_files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        attempts = 0
        while True:
            try:
                i = idx % len(self.artifact_files)
                # mmap + crop-BEFORE-window: hu_window is pointwise, so
                # window(crop(x)) == crop(window(x)) exactly, and the mmap
                # read touches only the cropped rows instead of two full
                # 416² slices per 128² patch
                artifact = np.load(self.artifact_files[i], mmap_mode="r")
                clean = np.load(self.clean_files[i], mmap_mode="r")
                if self.train and self.patch_size:
                    artifact, clean = random_crop_pair(
                        (artifact, clean), self.patch_size, self.crop_state
                    )
                artifact = hu_window(np.asarray(artifact, np.float32), *self.hu_range)
                clean = hu_window(np.asarray(clean, np.float32), *self.hu_range)
                if self.train and self.patch_size:
                    artifact, clean = random_flip_pair((artifact, clean), self.aug_state)
                return {"ct": artifact, "gt": clean, "li": artifact}
            except (OSError, ValueError) as e:
                if isinstance(e, ValueError) and "matching" in str(e):
                    raise
                idx += 1
                attempts += 1
                if attempts > len(self.artifact_files):
                    raise
