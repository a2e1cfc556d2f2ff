"""tmar_torch — the PyTorch / CUDA port of tmar: the NGswin serving path, the
GAN train step of the full recipe (Radon sinogram term included) and the
Trainer around it.

The JAX package ``tmar`` is the reference; this package imports nothing of
it.  Plain tensor code is PyTorch; the TPU kernels of the two paths are
hand-written CUDA C++ for Hopper (``csrc/``), built on first use.  Entry
points default to ``device="cuda"`` and raise without a card.
"""

from tmar_torch.checkpoint import disc_from_flax, from_flax_params, load_pth
from tmar_torch.eval import full_slice_eval, make_inference_fn, tiled_eval
from tmar_torch.losses import LossWeights
from tmar_torch.nn import MultiScaleDiscriminator, NGswin
from tmar_torch.ops.radon import Radon
from tmar_torch.train import (
    Trainer,
    create_train_state,
    load_config,
    make_eval_step,
    make_train_step,
    resolve_variant,
)

__all__ = [
    "LossWeights",
    "MultiScaleDiscriminator",
    "NGswin",
    "Radon",
    "Trainer",
    "create_train_state",
    "disc_from_flax",
    "from_flax_params",
    "full_slice_eval",
    "load_config",
    "load_pth",
    "make_eval_step",
    "make_inference_fn",
    "make_train_step",
    "resolve_variant",
    "tiled_eval",
]
