"""Mixed-precision policy (the counterpart of ``tmar.core.precision``):
parameters and optimizer state in float32, activations and compute
optionally bfloat16, losses and metrics always float32.  The port's layers
keep float32 parameters and cast them at use to the dtype of the activation
they receive, so a policy is applied by giving the models its
``compute_dtype`` (``NGswin(dtype=...)``, ``MultiScaleDiscriminator(dtype=...)``).
"""

from __future__ import annotations

import dataclasses

import torch


def _cast(tree, dtype):
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    return tree


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree):
        """Every floating-point tensor of a (nested dict/list/tuple) tree in
        the compute dtype."""
        return _cast(tree, self.compute_dtype)

    def cast_to_output(self, tree):
        return _cast(tree, self.output_dtype)


DEFAULT_POLICY = Policy()
BF16_POLICY = Policy(compute_dtype=torch.bfloat16)
