"""Checkpoint loading and conversion."""

from tmar_torch.checkpoint.convert import from_flax_params, load_pth

__all__ = ["from_flax_params", "load_pth"]
