"""The port's fused window attention (tmar_torch.ops.cuda_attention) against
the JAX package's, forward and all seven gradients, on the same seeded numpy
inputs, at float32 on the CPU.

The JAX side is ``tmar.ops.pallas_attention.fused_window_attention`` with its
Pallas forward and backward kernels in interpret mode (``interpret=True,
backward="pallas"``), as tests/test_pallas_attention_bwd.py runs it; the port
runs its plain version under autograd, which is what a CPU tensor takes.

Tolerance: forward atol 2e-4; gradients atol 5e-4, rtol 5e-3, the JAX
package's own kernel-vs-math tolerances (tests/test_pallas_attention_bwd.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.ops.attention import gather_rel_pos_bias as jgather
from tmar.ops.attention import relative_position_index as jrel_index
from tmar.ops.pallas_attention import fused_window_attention as jfused
from tmar.ops.window import shift_mask_components
from tmar_torch.ops.attention import gather_rel_pos_bias, relative_position_index
from tmar_torch.ops.cuda_attention import fused_window_attention

NAMES = ["dx", "dwqkv", "dbqkv", "dlogit_scale", "dbias", "dwproj", "dbproj"]


def _inputs(B_, N, D, nh, hd, seed=0):
    rng = np.random.default_rng(seed)
    A = nh * hd
    n = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    args = [
        n(B_, N, D), n(D, 3 * A) * 0.1, n(3 * A) * 0.1,
        rng.uniform(0.5, 2.3, size=(nh, 1, 1)).astype(np.float32),
        n(nh, N, N) * 0.2, n(A, D) * 0.1, n(D) * 0.1,
    ]
    return args, n(B_, N, D)


def _jax_side(args, g, nh, mc):
    out, vjp = jax.vjp(
        lambda *a: jfused(*a, num_heads=nh, mask_components=mc, interpret=True,
                          backward="pallas"),
        *[jnp.asarray(a) for a in args],
    )
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _torch_side(args, g, nh, mc):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fused_window_attention(*leaves, nh, mask_components=mc)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    return out.detach().numpy(), [t.numpy() for t in grads]


def _compare(args, g, nh, mc):
    ref_out, ref_grads = _jax_side(args, g, nh, mc)
    got_out, got_grads = _torch_side(args, g, nh, mc)
    np.testing.assert_allclose(got_out, ref_out, atol=2e-4)
    for name, got, ref in zip(NAMES, got_grads, ref_grads):
        np.testing.assert_allclose(got, ref, atol=5e-4, rtol=5e-3, err_msg=name)


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("nh,hd", [(6, 10), (4, 16)])
def test_window_attention_and_gradients_match_pallas(mask, nh, hd):
    """64-token windows, 2 images of a 2x2 window grid, so a gated mask has
    its last row, last column and corner."""
    wh = ww = 2
    args, g = _inputs(2 * wh * ww, 64, 64, nh, hd)
    mc = (*shift_mask_components(8, 4), wh, ww) if mask else None
    _compare(args, g, nh, mc)


def test_small_window_attention_and_gradients_match_pallas():
    """The block-diagonal kernel's case: 4-token n-gram windows."""
    args, g = _inputs(96, 4, 16, 2, 8, seed=5)
    _compare(args, g, 2, None)


def test_logit_scale_gradient_is_zero_above_the_clip():
    args, g = _inputs(4, 4, 16, 2, 8, seed=6)
    args[3] = np.array([[[5.0]], [[1.0]]], np.float32)  # head 0 above ln 100
    _, ref_grads = _jax_side(args, g, 2, None)
    _, got_grads = _torch_side(args, g, 2, None)
    assert got_grads[3][0, 0, 0] == 0.0 and got_grads[3][1, 0, 0] != 0.0
    np.testing.assert_allclose(got_grads[3], ref_grads[3], atol=5e-4, rtol=5e-3)


@pytest.mark.parametrize("win", [(8, 8), (2, 2)])
def test_bias_gather_and_its_transpose_match_jax(win):
    """table -> bias [nh, N, N] and the cotangent's way back into the table
    (the port does it as a fixed gather and a sum, without atomics)."""
    rng = np.random.default_rng(7)
    nh, N = 3, win[0] * win[1]
    table = rng.normal(size=((2 * win[0] - 1) * (2 * win[1] - 1), nh)).astype(np.float32)
    g = rng.normal(size=(nh, N, N)).astype(np.float32)
    ref, vjp = jax.vjp(lambda t: jgather(t, jrel_index(*win), nh), jnp.asarray(table))
    leaf = torch.from_numpy(table).requires_grad_()
    got = gather_rel_pos_bias(leaf, relative_position_index(*win), nh)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    (dtable,) = torch.autograd.grad(got, leaf, torch.from_numpy(g))
    np.testing.assert_allclose(dtable.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=1e-5, rtol=1e-5)
