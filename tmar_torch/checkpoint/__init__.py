"""Checkpoint loading and conversion."""

from tmar_torch.checkpoint.convert import (
    adam_state_from_optax,
    disc_from_flax,
    from_flax_params,
    load_pth,
    to_flax_params,
)
from tmar_torch.checkpoint.io import CheckpointManager

__all__ = [
    "CheckpointManager",
    "adam_state_from_optax",
    "disc_from_flax",
    "from_flax_params",
    "load_pth",
    "to_flax_params",
]
