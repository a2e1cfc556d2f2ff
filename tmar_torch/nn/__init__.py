"""The NGswin generator's modules."""

from tmar_torch.nn.ngswin import NGswin

__all__ = ["NGswin"]
