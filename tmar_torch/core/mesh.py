"""Device mesh and sharding helpers (the counterpart of ``tmar.core.mesh``).

The JAX package runs one controller over a ``jax.sharding.Mesh`` and lets XLA
insert the collectives from sharding annotations.  The port runs one process
per device, as PyTorch does, over ``torch.distributed``:

* a mesh is a ``DeviceMesh`` of shape (dp, mp) with the dims named ``data``
  and ``model``, built over the process group the caller initialised (for
  example by ``python -m torch.distributed.run``), or a 1-rank mesh when
  there is none;
* ``shard_batch`` hands each rank its rows of the global batch (split over
  the data axis only, so the ranks of one model group see the same rows),
  and ``replicate`` broadcasts parameters from rank 0;
* the layouts of the train step are explicit: data parallelism averages the
  gradients after each backward (``average_gradients``), FSDP is FSDP2's
  ``fully_shard`` placed by ``fsdp_spec`` (``apply_fsdp``), and tensor
  parallelism Megatron-splits the window attention and the FFN by
  ``tp_spec`` with the f / g operators (``apply_tensor_parallel``).

``tp_spec`` and ``fsdp_spec`` are the JAX rules (``tmar/core/mesh.py``
``_tp_spec`` / ``_fsdp_spec``) on the port's parameter names and torch
layouts: they pick the same leaves and the same logical dim.  A spec is a
tuple of one entry per tensor dim, the axis name the dim is split over or
None; ``()`` is replicated.  At rest a tensor-parallel ``qkv`` keeps each
rank's heads of q, k and v together (rows in (rank, q/k/v, head, head_dim)
order), where the JAX package splits the [in, 3A] kernel contiguously; the
numbers are the same, and checkpoints hold the reference order.

The JAX package's ``force_host_device_count`` sets a flag of the XLA runtime
so that one process sees N virtual CPU devices; it has no counterpart here:
the tests spawn N gloo ranks instead.
"""

from __future__ import annotations

import os
import sys
from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

DATA_AXIS = "data"
MODEL_AXIS = "model"

Spec = Tuple[Optional[str], ...]

LAUNCH_HINT = (
    "launch one process per device, e.g. `python -m torch.distributed.run "
    "--nproc-per-node N -m tmar_torch.cli train ...`, or initialise "
    "torch.distributed yourself before building the mesh"
)


# ---------------------------------------------------------------- the mesh
def local_mesh_devices(n_devices: Optional[int] = None, device="cuda") -> List[torch.device]:
    """Up to ``n_devices`` devices of this host (all cards by default); on the
    CPU ``n_devices`` (default 1) entries of the one CPU device, which that
    many gloo ranks share."""
    kind = torch.device(device).type
    if kind != "cuda":
        return [torch.device(kind)] * (n_devices or 1)
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n > count:
        raise ValueError(f"requested {n} devices but only {count} available")
    return [torch.device("cuda", i) for i in range(n)]


def create_mesh(n_devices: Optional[int] = None, *, model_parallel: int = 1, device="cuda"):
    """A (dp, mp) ``DeviceMesh`` with dims (``data``, ``model``) over the
    initialised process group, whose world size must be ``n_devices`` (when
    given).  With no process group and at most one device it first
    initialises a 1-rank group (NCCL on a card, gloo on the CPU); asking for
    more devices than processes raises and says how to launch."""
    from torch.distributed.device_mesh import init_device_mesh

    kind = torch.device(device).type
    if not dist.is_initialized():
        if (n_devices or 1) > 1:
            raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} processes: {LAUNCH_HINT}")
        kw = {"device_id": torch.device(device)} if kind == "cuda" else {}
        dist.init_process_group("nccl" if kind == "cuda" else "gloo", store=dist.HashStore(),
                                rank=0, world_size=1, **kw)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices} but the process group has {world} ranks: {LAUNCH_HINT}")
    if world % model_parallel:
        raise ValueError(f"{world} devices not divisible by model_parallel={model_parallel}")
    return init_device_mesh(kind, (world // model_parallel, model_parallel),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh[axis].size()


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def is_main_process() -> bool:
    """Rank 0, or no process group: the process that writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shard_rows(mesh, n: int) -> slice:
    """This rank's rows of a global batch of ``n``, split over the data axis."""
    dp = axis_size(mesh, DATA_AXIS)
    if n % dp:
        raise ValueError(f"a global batch of {n} does not split over {dp} data ranks")
    r = axis_rank(mesh, DATA_AXIS)
    return slice(r * n // dp, (r + 1) * n // dp)


def batch_sharding(mesh, ndim: int = 4) -> Spec:
    """The spec of a batch: the leading dim split over the data axis."""
    return (DATA_AXIS,) + (None,) * (ndim - 1)


def replicated_sharding(mesh) -> Spec:
    return ()


def shard_batch(mesh, batch):
    """This rank's rows of every array or tensor of ``batch`` (a dict, list or
    single array, batch dim first), split over the data axis only."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return batch[shard_rows(mesh, batch.shape[0])]


@torch.no_grad()
def replicate(mesh, tree):
    """Broadcast a module's parameters and buffers (or a dict / list of
    tensors) from rank 0 to every rank, in place; returns ``tree``."""
    if mesh is None or mesh.size() == 1:
        return tree
    if isinstance(tree, nn.Module):
        tensors = [t.data for t in tree.parameters()] + list(tree.buffers())
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    for t in tensors:
        dist.broadcast(t, src=0)
    return tree


def all_gather_rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """The data ranks' row blocks of ``t`` (the same shape on every rank)
    concatenated in rank order, on every rank."""
    dp = axis_size(mesh, DATA_AXIS)
    if dp == 1:
        return t
    t = t.contiguous()
    out = t.new_empty((dp * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=mesh.get_group(DATA_AXIS))
    return out


def all_reduce_(mesh, tensors: Sequence[torch.Tensor], axis: str = DATA_AXIS,
                mean: bool = True) -> None:
    """Average (or with ``mean=False`` sum) ``tensors`` over ``axis`` in
    place, through one flat float32 bucket: one all-reduce, a fixed order of
    the sum."""
    size = axis_size(mesh, axis)
    tensors = [t for t in tensors if t is not None]
    if size == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=mesh.get_group(axis))
    if mean:
        flat.div_(size)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset: offset + t.numel()].view_as(t))
        offset += t.numel()


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``DTensor``, without importing the DTensor package
    (a second of start-up) where nothing has made one."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def global_means(mesh, metrics, device):
    """Scalar metrics ({name: tensor or number}) averaged over the data axis
    in one all-reduce, so that every rank holds the global batch's means."""
    names = list(metrics)
    row = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32, device=device)
                       for k in names])
    all_reduce_(mesh, [row], DATA_AXIS)
    return dict(zip(names, row.unbind()))


def local(t):
    """The rank's own part of a ``DTensor`` (sharing its storage); any other
    tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def _is_fsdp_managed(p) -> bool:
    return is_dtensor(p) and p.device_mesh.mesh_dim_names == (DATA_AXIS,)


@torch.no_grad()
def average_gradients(mesh, params: Iterable[torch.Tensor], model_summed=()) -> None:
    """After a backward: average every gradient over the data axis that FSDP
    does not reduce itself (the parameters of a data-parallel network, the
    replicated leaves under FSDP, each tensor-parallel shard), in one bucket;
    then sum the gradients of ``model_summed`` (parameters that each model
    rank uses only in part: the attention's logit scale and bias table,
    sliced to its heads) over the model axis."""
    if mesh is None:
        return
    all_reduce_(mesh, [local(p.grad) for p in params if p.grad is not None
                       and not _is_fsdp_managed(p)])
    all_reduce_(mesh, [p.grad for p in model_summed], MODEL_AXIS, mean=False)


# --------------------------------------------------------------- the rules
def _flax_axes(ndim: int) -> Tuple[int, ...]:
    """The torch dims in the order of the flax leaf's dims: a conv's OIHW
    weight is flax's HWIO kernel, a linear's [out, in] weight its [in, out]
    kernel (``tmar_torch.checkpoint.convert``)."""
    return {4: (2, 3, 1, 0), 2: (1, 0)}.get(ndim, tuple(range(ndim)))


def tp_spec(name: str) -> Spec:
    """The Megatron rule on a parameter name: ``qkv`` and ``fc1`` split on
    their output features (weight rows and bias), ``proj`` and ``fc2`` on
    their input features (weight columns; their biases replicated), the
    n-gram context and every other leaf replicated (``tmar/core/mesh.py``
    ``_tp_spec``, which says why the n-gram context stays out)."""
    if ".ngram_context." in f".{name}":
        return ()
    parts = name.split(".")
    layer, leaf = (parts[-2], parts[-1]) if len(parts) > 1 else ("", name)
    if layer in ("qkv", "fc1"):
        return {"weight": (MODEL_AXIS, None), "bias": (MODEL_AXIS,)}.get(leaf, ())
    if layer in ("proj", "fc2") and leaf == "weight":
        return (None, MODEL_AXIS)
    return ()


def fsdp_spec(name: str, shape: Sequence[int], data_size: int) -> Spec:
    """The ZeRO rule: split the largest dim divisible by the data-axis size
    (ties to the first in the flax leaf's order, as the JAX rule breaks
    them); the n-gram context and leaves with no such dim replicated
    (``tmar/core/mesh.py`` ``_fsdp_spec``)."""
    if ".ngram_context." in f".{name}":
        return ()
    shape = tuple(shape)
    axes = _flax_axes(len(shape))
    for j in sorted(range(len(shape)), key=lambda j: -shape[axes[j]]):
        d = axes[j]
        if shape[d] >= 2 and shape[d] % data_size == 0:
            return tuple(DATA_AXIS if i == d else None for i in range(len(shape)))
    return ()


def spec_dim(spec: Spec) -> Optional[int]:
    """The dim a spec splits, or None when it replicates."""
    split = [i for i, a in enumerate(spec) if a is not None]
    return split[0] if split else None


def gan_state_shardings(mesh, state, *, tensor_parallel: bool = False, fsdp: bool = False):
    """The spec of every tensor of a ``GANTrainState`` by name: {"generator",
    "discriminator", "g_opt", "d_opt", "g_ema": {parameter name: spec}} (an
    optimizer's moments and the EMA lie as their parameter).  Default: all
    replicated (data parallel).  ``tensor_parallel``: the generator's
    parameters, moments and EMA by ``tp_spec``, the discriminator
    replicated.  ``fsdp``: both networks by ``fsdp_spec`` over the data
    axis.  The spectral-norm vectors and the step stay replicated."""
    if tensor_parallel and fsdp:
        raise ValueError("choose tensor_parallel OR fsdp (not both)")
    data = axis_size(mesh, DATA_AXIS)

    def rule(module, split):
        out = {}
        for name, p in module.named_parameters():
            if split and tensor_parallel:
                out[name] = tp_spec(name)
            elif split and fsdp:
                out[name] = fsdp_spec(name, p.shape, data)
            else:
                out[name] = ()
        return out

    g = rule(state.generator, True)
    d = rule(state.discriminator, fsdp)
    return {"generator": g, "g_opt": dict(g), "g_ema": None if state.g_ema is None else dict(g),
            "discriminator": d, "d_opt": dict(d)}


# ------------------------------------------------------------------- FSDP
def apply_fsdp(module: nn.Module, mesh, units: Sequence[nn.Module] = ()) -> nn.Module:
    """FSDP2 over the data axis: ``fully_shard`` on each of ``units`` (the
    NGswin's blocks and stages) and on ``module``, each parameter placed by
    ``fsdp_spec``, the replicated leaves left out (their gradients are
    averaged by ``average_gradients``).  Float32 parameters, no FSDP
    mixed-precision policy: the network's own precision policy holds."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    data_mesh = mesh[DATA_AXIS]
    size = data_mesh.size()
    name_of = {id(p): n for n, p in module.named_parameters()}

    def placement(p):
        return Shard(spec_dim(fsdp_spec(name_of[id(p)], p.shape, size)))

    ignored = {p for n, p in module.named_parameters() if not fsdp_spec(n, p.shape, size)}
    for unit in units:
        fully_shard(unit, mesh=data_mesh, shard_placement_fn=placement, ignored_params=ignored)
    fully_shard(module, mesh=data_mesh, shard_placement_fn=placement, ignored_params=ignored)
    return module


# ------------------------------------------------------- tensor parallelism
class TensorParallel:
    """A rank's place on the model axis: its process group, rank and size."""

    def __init__(self, mesh):
        self.mesh = mesh[MODEL_AXIS]
        self.group = mesh.get_group(MODEL_AXIS)
        self.rank = mesh.get_local_rank(MODEL_AXIS)
        self.size = mesh[MODEL_AXIS].size()

    def heads(self, num_heads: int) -> slice:
        """This rank's heads of an attention with ``num_heads``."""
        n = num_heads // self.size
        return slice(self.rank * n, (self.rank + 1) * n)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    return x if tp is None else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    return x if tp is None else _ReduceFromModel.apply(x, tp.group)


def qkv_row_order(num_heads: int, head_dim: int, model_size: int) -> torch.Tensor:
    """The rows of a fused qkv weight at rest under tensor parallelism:
    position i holds reference row ``order[i]``; the reference rows are in
    (q/k/v, head, head_dim) order, the rest rows in (rank, q/k/v, head of the
    rank, head_dim) order, so that a contiguous split gives each rank its
    heads of q, k and v."""
    ref = torch.arange(3 * num_heads * head_dim).reshape(3, model_size, num_heads // model_size,
                                                         head_dim)
    return ref.permute(1, 0, 2, 3).reshape(-1)


@torch.no_grad()
def apply_tensor_parallel(module: nn.Module, mesh) -> nn.Module:
    """Megatron-split every submodule with a ``tensor_parallel`` method (the
    NSTB in its plain form: window attention and FFN) over the model axis:
    its leaves that ``tp_spec`` splits become ``DTensor`` shards (a qkv in
    the head-aligned row order of ``qkv_row_order``), the rest stay
    replicated.  Records on ``module`` the head-sliced parameters whose
    gradients sum over the model axis (``tp_summed``) and the permuted rows
    (``tp_row_order``: name -> order) that checkpoints undo."""
    from torch.distributed.tensor import DTensor, Shard

    tp = TensorParallel(mesh)
    module.tp_summed, module.tp_row_order = [], {}
    units = [(n, m) for n, m in module.named_modules() if hasattr(m, "tensor_parallel")]
    if not units:
        raise ValueError(f"tensor parallelism splits the NGswin's blocks; {type(module).__name__} "
                         "has none")
    for prefix, unit in units:
        summed, orders = unit.tensor_parallel(tp)
        module.tp_summed += summed
        orders = {f"{prefix}.{k}": v for k, v in orders.items()}
        module.tp_row_order.update(orders)
        for leaf_name, p in list(unit.named_parameters()):
            name = f"{prefix}.{leaf_name}"
            dim = spec_dim(tp_spec(name))
            if dim is None:
                continue
            full = p.detach()
            if name in orders:
                full = full[orders[name].to(full.device)]
            shard = full.chunk(tp.size, dim=dim)[tp.rank].contiguous()
            owner, leaf = _owner(unit, leaf_name)
            setattr(owner, leaf, nn.Parameter(
                DTensor.from_local(shard, tp.mesh, [Shard(dim)], run_check=False)))
    return module


def _owner(module: nn.Module, name: str):
    path, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    return (module.get_submodule(path) if path else module), leaf


# ---------------------------------------------- full tensors and rank parts
def full_tensor(module: Optional[nn.Module], name: str, t: torch.Tensor) -> torch.Tensor:
    """The whole of ``t`` (a collective for a ``DTensor``: every rank calls it
    in the same order) in the reference layout of parameter ``name``."""
    if is_dtensor(t):
        t = _gather_shards(t)
    order = getattr(module, "tp_row_order", {}).get(name)
    if order is not None and t.dim():
        t = t[torch.argsort(order).to(t.device)]
    return t


def _gather_shards(t) -> torch.Tensor:
    """The whole of a ``DTensor`` split on one dim in equal parts (the
    placements of ``fsdp_spec`` and ``tp_spec``), by c10d's
    ``all_gather_into_tensor`` over its mesh dim's group: gloo takes CUDA
    tensors there, where DTensor's own redistribution (functional
    collectives) took a rank down on the card."""
    from torch.distributed.tensor import Shard

    split = [(i, p.dim) for i, p in enumerate(t.placements) if isinstance(p, Shard)]
    part = t.to_local().detach()
    if not split:
        return part
    (mesh_dim, d), = split
    n = t.device_mesh.size(mesh_dim)
    part = part.movedim(d, 0).contiguous()
    out = part.new_empty((n * part.shape[0],) + tuple(part.shape[1:]))
    dist.all_gather_into_tensor(out, part, group=t.device_mesh.get_group(mesh_dim))
    return out.movedim(0, d)


def rank_part(module: Optional[nn.Module], name: str, like: torch.Tensor,
              full: torch.Tensor) -> torch.Tensor:
    """The part of ``full`` (reference layout) that this rank holds where
    ``like`` (the parameter, or its moment) is held: a ``DTensor`` of the
    same placement, or the tensor itself."""
    full = full.to(device=like.device, dtype=like.dtype)
    order = getattr(module, "tp_row_order", {}).get(name)
    if order is not None and full.dim():
        full = full[order.to(full.device)]
    if is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(full, like.device_mesh, like.placements, src_data_rank=None)
    return full


def set_rank_part_(module, name: str, target: torch.Tensor, full: torch.Tensor) -> None:
    """Copy this rank's part of ``full`` into ``target`` in place."""
    local(target).copy_(local(rank_part(module, name, target, full)))


def dist_barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def free_port() -> int:
    """A free TCP port on this host (for a process group's address)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_from_env(device="cuda") -> torch.device:
    """Initialise the process group from ``torch.distributed.run``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL on ``cuda:LOCAL_RANK``, gloo for ``device="cpu"``.
    Returns this rank's device; without ``WORLD_SIZE`` it initialises
    nothing and returns ``device``."""
    kind = torch.device(device).type
    if "WORLD_SIZE" not in os.environ:
        return torch.device(device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if kind == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", rank=rank, world_size=world, device_id=dev)
        return dev
    dist.init_process_group("gloo", rank=rank, world_size=world)
    return torch.device(kind)

