"""Host-side data pipeline: transforms, the synthetic dataset, the loader."""

from tmar_torch.data import transforms
from tmar_torch.data.loader import Loader
from tmar_torch.data.synthetic import SyntheticMARDataset

__all__ = ["Loader", "SyntheticMARDataset", "transforms"]
