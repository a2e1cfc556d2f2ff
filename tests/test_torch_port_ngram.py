"""The port's n-gram context (tmar_torch.ops.cuda_ngram / nn.ngram) against
the JAX megakernel run in Pallas interpret mode and against the JAX
composition, on the same seeded numpy inputs, at float32.

Tolerance atol 3e-5, rtol 3e-5: the JAX package's own megakernel-vs-
composition tolerance (tests/test_pallas_ngram.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.nn.ngram import NGramContext as FlaxNGramContext
from tmar.ops.attention import gather_rel_pos_bias, relative_position_index
from tmar.ops.pallas_ngram import fused_ngram_context as jfused
from tmar.ops.pallas_ngram import ngram_context_math as jmath
from tmar_torch.checkpoint import from_flax_params
from tmar_torch.nn.ngram import NGramContext
from tmar_torch.ops import cuda_ngram
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

TOL = dict(atol=3e-5, rtol=3e-5)


def _inputs(dim, heads, B, wh, ww, seed=0):
    rng = np.random.default_rng(seed)
    C = dim // 2
    A = (C // heads) * heads

    def n(*s, sc=1.0):
        return (rng.standard_normal(s) * sc).astype(np.float32)

    u = n(B, wh, ww, C)
    params = [n(C, 3 * A, sc=0.2), n(3 * A, sc=0.1), n(heads, 1, 1), n(9, heads, sc=0.5),
              n(A, C, sc=0.2), n(C, sc=0.1), n(dim, dim, sc=0.2), n(dim, sc=0.1)]
    return u, params


def _jax_args(u, params, heads):
    j = [jnp.asarray(p) for p in params]
    bias = gather_rel_pos_bias(j[3], relative_position_index(2, 2), heads)
    return (jnp.asarray(u), j[0], j[1], j[2], bias, j[4], j[5], j[6], j[7])


@pytest.mark.parametrize(
    "dim,heads,wh,ww,stripe",
    [
        (64, 6, 4, 4, None),   # full-width 6-head geometry: head_dim 32 // 6 = 5
        (64, 4, 3, 5, None),   # 4-head stages, odd grid
        (32, 2, 2, 2, None),   # smallest legal grid: both reflections hit index 0/1
        (64, 6, 8, 8, 2),      # four stripes: first, middle and last
    ],
)
def test_ngram_context_matches_pallas_interpret(dim, heads, wh, ww, stripe):
    u, params = _inputs(dim, heads, 2, wh, ww)
    ref = jfused(*_jax_args(u, params, heads), heads, interpret=True, stripe_rows=stripe)
    got = cuda_ngram.fused_ngram_context(
        torch.from_numpy(u), *map(torch.from_numpy, params), heads
    )
    assert got.shape == (2, wh, ww, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("dim,heads,wh,ww", [(64, 6, 4, 4), (64, 4, 3, 5), (32, 2, 2, 2)])
def test_ngram_context_math_matches_jax_math(dim, heads, wh, ww):
    u, params = _inputs(dim, heads, 2, wh, ww, seed=1)
    ref = jmath(*_jax_args(u, params, heads), num_heads=heads)
    got = cuda_ngram.ngram_context_math(
        torch.from_numpy(u), *map(torch.from_numpy, params), num_heads=heads
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_ngram_context_cpu_leaves_launch_count(monkeypatch):
    monkeypatch.setattr(cuda_ngram.fused_ngram_context, "launches", 0)
    u, params = _inputs(64, 6, 1, 2, 3)
    cuda_ngram.fused_ngram_context(torch.from_numpy(u), *map(torch.from_numpy, params), 6)
    assert cuda_ngram.fused_ngram_context.launches == 0


@pytest.mark.parametrize("dim,heads,wh,ww", [(64, 6, 3, 3), (64, 4, 2, 3)])
def test_ngram_context_module_matches_flax(monkeypatch, dim, heads, wh, ww):
    """The port's NGramContext (grouped unigram conv + context) against the
    flax module on its megakernel path in interpret mode, same weights."""
    ws = 8
    flax_mod = FlaxNGramContext(dim=dim, window_size=ws, ngram=2, ngram_num_heads=heads,
                                use_pallas=True, pallas_interpret=True)
    x = np.random.default_rng(2).standard_normal((2, wh * ws, ww * ws, dim)).astype(np.float32)
    params = flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    monkeypatch.setenv("TMAR_NGRAM_FUSED", "1")
    ref = flax_mod.apply({"params": params}, jnp.asarray(x))

    mod = NGramContext(dim, ws, 2, heads)
    mod.load_state_dict(from_flax_params(params))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
