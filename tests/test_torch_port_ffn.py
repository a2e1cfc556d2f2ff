"""The port's fused residual FFN (tmar_torch.ops.cuda_ffn) against the JAX
package's, forward and all ten gradients, on the same seeded numpy inputs,
at float32 on the CPU.

The JAX side is ``tmar.ops.pallas_ffn.fused_residual_ffn`` with its Pallas
forward and backward kernels in interpret mode (``interpret=True,
backward="pallas"``); the port runs its plain version under autograd, which
is what a CPU tensor takes.  M = 200 is ragged against the JAX kernel's
128-row tiles and against the CUDA kernel's 64-row tiles.

Tolerance atol 2e-4, rtol 2e-3 on every tensor: the JAX kernel evaluates erf
by a rational approximation (|err| < 1.5e-7) where the port calls erf, and
the gradients sum 200 rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.ops.pallas_ffn import fused_residual_ffn as jfused
from tmar_torch.ops.cuda_ffn import fused_residual_ffn
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

TOL = dict(atol=2e-4, rtol=2e-3)
NAMES = ["dx", "dattn_out", "dg1", "db1", "dw1", "dbw1", "dw2", "dbw2", "dg2", "db2"]


def _inputs(M, D=64, H=128, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    args = [
        n(M, D), n(M, D), 1 + 0.1 * n(D), 0.1 * n(D), 0.1 * n(D, H), 0.1 * n(H),
        0.1 * n(H, D), 0.1 * n(D), 1 + 0.1 * n(D), 0.1 * n(D),
    ]
    return args, n(M, D)


@pytest.mark.parametrize("M,D", [(200, 64), (64, 32)])
def test_residual_ffn_and_gradients_match_pallas(M, D):
    args, g = _inputs(M, D, 2 * D)
    ref, vjp = jax.vjp(
        lambda *a: jfused(*a, block_rows=128, interpret=True, backward="pallas"),
        *[jnp.asarray(a) for a in args],
    )
    ref_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    got = fused_residual_ffn(*leaves)
    got_grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    for name, a, b in zip(NAMES, got_grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)
