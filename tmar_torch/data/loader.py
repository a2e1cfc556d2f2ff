"""Batched, prefetching host-side loader (the counterpart of
``tmar.data.loader``).

Worker threads run the numpy per-sample pipeline and assemble NHWC batches in
order.  With a ``device``, each batch is handed over as tensors on it: for a
CUDA device through pinned host memory and ``non_blocking`` copies, so the
copy overlaps the train step that is still running (the place of the JAX
package's ``shard_batch``).  Without one the batch stays numpy.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 2,
        prefetch: int = 4,
        drop_last: bool = True,
        pad_last: bool = False,
        device=None,
        keys=("ct", "gt"),
    ):
        """``pad_last`` (with ``drop_last=False``): cycle a short final
        batch back to ``batch_size``, so that every batch has one shape, and
        attach a float ``valid`` mask [B] marking the distinct samples.
        Without it a dataset smaller than one batch yields NOTHING
        (drop_last) or an off-shape batch."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last and not pad_last
        self.pad_last = pad_last
        self.device = None if device is None else torch.device(device)
        self.keys = keys
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        nb = len(self)
        for b in range(nb):
            yield order[b * self.batch_size : (b + 1) * self.batch_size]

    def _assemble(self, indices) -> Dict[str, np.ndarray]:
        n_valid = len(indices)
        if self.pad_last and n_valid < self.batch_size:
            # cycle, don't repeat-last: when batch_size % n_valid == 0 the
            # padded batch-mean of any metric equals the true mean over the
            # distinct samples
            indices = np.resize(np.asarray(indices), self.batch_size)
        samples = [self.dataset[int(i)] for i in indices]
        batch = {}
        for k in self.keys:
            arr = np.stack([s[k] for s in samples])
            if arr.ndim == 3:
                arr = arr[..., None]  # NHWC
            batch[k] = np.ascontiguousarray(arr, dtype=np.float32)
        if self.pad_last:
            batch["valid"] = (np.arange(len(indices)) < n_valid).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._epoch += 1
        work: "queue.Queue" = queue.Queue()
        done: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        batches = list(self._batch_indices())
        for i, idx in enumerate(batches):
            work.put((i, idx))
        for _ in range(self.num_workers):
            work.put(None)

        results = {}
        lock = threading.Lock()

        def worker():
            while True:
                item = work.get()
                if item is None:
                    done.put(None)
                    return
                i, idx = item
                try:
                    batch = self._assemble(idx)
                    done.put((i, batch))
                except Exception as e:  # surface worker errors to the consumer
                    done.put((i, e))

        threads = [
            threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        next_i = 0
        finished_workers = 0
        try:
            while next_i < len(batches):
                item = done.get()
                if item is None:
                    finished_workers += 1
                    if finished_workers == self.num_workers and next_i >= len(batches):
                        break
                    continue
                i, batch = item
                with lock:
                    results[i] = batch
                while next_i in results:
                    b = results.pop(next_i)
                    if isinstance(b, Exception):
                        raise b
                    yield self._to_device(b)
                    next_i += 1
        finally:
            for t in threads:
                t.join(timeout=0.1)

    def _to_device(self, batch):
        if self.device is None:
            return batch
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(v)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out
