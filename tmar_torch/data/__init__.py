"""Host-side data pipeline (the counterpart of ``tmar.data``): transforms, the
synthetic, SynDeepLesion and SpineWeb datasets, the benchmark fine-tune
dataset, the shard cache, the loader,
the native host library (``native``) and the NIfTI reader (``nifti``)."""

from tmar_torch.data import native, nifti, transforms
from tmar_torch.data.finetune import BenchmarkFinetuneDataset
from tmar_torch.data.loader import Loader
from tmar_torch.data.shard_cache import ShardCachedDataset, build_shard_cache, cache_syndeeplesion
from tmar_torch.data.spineweb import SpineWebDataset
from tmar_torch.data.spineweb_selfsup import SpineWebSelfSupervisedDataset
from tmar_torch.data.syndeeplesion import (
    SynDeepLesionTestDataset,
    SynDeepLesionTrainDataset,
    SynDeepLesionValDataset,
)
from tmar_torch.data.synthetic import SyntheticMARDataset
from tmar_torch.data.transforms import (
    hu_window,
    normalize01_to_pm1,
    random_crop_pair,
    random_flip_pair,
)

__all__ = [
    "normalize01_to_pm1",
    "hu_window",
    "random_crop_pair",
    "random_flip_pair",
    "SyntheticMARDataset",
    "SynDeepLesionTrainDataset",
    "SynDeepLesionValDataset",
    "SynDeepLesionTestDataset",
    "SpineWebDataset",
    "SpineWebSelfSupervisedDataset",
    "BenchmarkFinetuneDataset",
    "Loader",
    "ShardCachedDataset",
    "build_shard_cache",
    "cache_syndeeplesion",
    "native",
    "nifti",
    "transforms",
]
