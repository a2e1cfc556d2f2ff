"""tmar_torch — the PyTorch / CUDA port of tmar's NGswin serving path.

The JAX package ``tmar`` is the reference; this package imports nothing of
it.  Plain tensor code is PyTorch; the two TPU kernels of the inference path
are hand-written CUDA C++ for Hopper (``csrc/``), built on first use.  Entry
points default to ``device="cuda"`` and raise without a card.
"""

from tmar_torch.checkpoint import from_flax_params, load_pth
from tmar_torch.eval import full_slice_eval, make_inference_fn, tiled_eval
from tmar_torch.nn import NGswin

__all__ = [
    "NGswin",
    "from_flax_params",
    "full_slice_eval",
    "load_pth",
    "make_inference_fn",
    "tiled_eval",
]
