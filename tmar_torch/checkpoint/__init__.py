"""Checkpoint loading and conversion."""

from tmar_torch.checkpoint.convert import disc_from_flax, from_flax_params, load_pth

__all__ = ["disc_from_flax", "from_flax_params", "load_pth"]
