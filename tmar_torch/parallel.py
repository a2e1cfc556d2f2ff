"""Multi-device helpers, the one import for distributed use (the counterpart
of ``tmar.parallel``).

* training: each process takes its rows of the batch and the train step
  averages the gradients over the data axis (``tmar_torch.train.steps``;
  FSDP and tensor parallelism by ``parallel.mode``);
* large-slice inference: ``sharded_tiled_eval`` spreads the overlapping
  tiles of full CT slices over the data axis of the mesh and assembles the
  same output on every rank.

Re-exports the mesh utilities of ``tmar_torch.core.mesh``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from tmar_torch.core.mesh import (  # noqa: F401  (re-exports)
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    create_mesh,
    free_port,
    local_mesh_devices,
    replicate,
    replicated_sharding,
    shard_batch,
)
from tmar_torch.eval.inference import make_tiled_eval, sharded_forward


def sharded_tile_forward(model: torch.nn.Module, mesh) -> Callable[[np.ndarray], np.ndarray]:
    """A tile-batch forward (numpy [N, h, w, C] -> numpy, every rank calling
    it with the same tiles) with the tiles split over the data axis and the
    parameters replicated from rank 0."""
    dev = next(model.parameters()).device
    replicate(mesh, model.eval())

    @torch.no_grad()
    def forward(tiles: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(tiles, dtype=np.float32)).to(dev)
        return sharded_forward(model, t, mesh).cpu().numpy()

    return forward


def sharded_tiled_eval(model: torch.nn.Module, mesh, ct: np.ndarray, tile: int = 64,
                       stride: int = 32) -> np.ndarray:
    """Overlapping tiled inference with the tiles spread over the mesh:
    ct [B, H, W, 1] in [-1, 1] -> restored [B, H, W, 1], on every rank
    (``make_tiled_eval(..., mesh=mesh)`` on the model's device)."""
    dev = next(model.parameters()).device
    return make_tiled_eval(model, tile, stride, device=dev, mesh=mesh)(ct)


def spawn_ranks(fn: Callable, world: int, *args, cuda_device: Optional[int] = None,
                threads: Optional[int] = 1) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes (the spawn
    start method: the caller may hold CUDA state) over one gloo process group
    on this host (127.0.0.1, a free port).  ``fn`` must live in a module the
    ranks can import.  Each rank takes ``threads`` CPU threads and, with
    ``cuda_device``, that card.  Raises when a rank raises."""
    torch.multiprocessing.start_processes(
        _rank_main, args=(world, free_port(), fn, args, cuda_device, threads), nprocs=world,
        start_method="spawn")


def _rank_main(rank, world, port, fn, args, cuda_device, threads):
    import faulthandler

    faulthandler.enable()  # a rank that crashes prints its Python stack
    if threads:
        torch.set_num_threads(threads)
    if cuda_device is not None:
        torch.cuda.set_device(cuda_device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
