"""Mesh and precision policy of the port (the names ``tmar.core`` exports)."""

from tmar_torch.core.mesh import (
    batch_sharding,
    create_mesh,
    local_mesh_devices,
    replicate,
    replicated_sharding,
    shard_batch,
)
from tmar_torch.core.precision import BF16_POLICY, DEFAULT_POLICY, Policy

__all__ = [
    "create_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate",
    "local_mesh_devices",
    "Policy",
    "DEFAULT_POLICY",
    "BF16_POLICY",
]
