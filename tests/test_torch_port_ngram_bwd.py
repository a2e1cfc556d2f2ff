"""The plain version of the port's n-gram backward kernel
(``tmar_torch.ops.cuda_ngram.ngram_context_backward_math``, which is what
``fused_ngram_context`` differentiates to on the CPU) against ``jax.grad`` of
the JAX megakernel with its fused recompute backward kernel in Pallas
interpret mode (``backward="pallas"``), on the same seeded numpy inputs, at
float32: du and every parameter cotangent.

Tolerance atol = rtol = 5e-5, the JAX package's own for that kernel against
its composition (tests/test_pallas_ngram.py).  The JAX function takes the
gathered bias [nh, 4, 4], the port the [9, nh] table: the JAX bias cotangent
is folded into the table by the transpose of the gather before comparing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.nn.ngram import NGramContext as FlaxNGramContext
from tmar.ops.attention import gather_rel_pos_bias, relative_position_index
from tmar.ops.pallas_ngram import fused_ngram_context as jfused
from tmar_torch.checkpoint import from_flax_params
from tmar_torch.nn.ngram import NGramContext
from tmar_torch.ops import cuda_ngram

TOL = dict(atol=5e-5, rtol=5e-5)
NAMES = ["u", "wqkv", "bqkv", "logit_scale", "table", "wproj", "bproj", "wmerge", "bmerge"]


def _inputs(dim, heads, wh, ww, seed=7):
    rng = np.random.default_rng(seed)
    C = dim // 2
    A = (C // heads) * heads

    def n(*s, sc=1.0):
        return (rng.standard_normal(s) * sc).astype(np.float32)

    u = n(2, wh, ww, C)
    params = [n(C, 3 * A, sc=0.2), n(3 * A, sc=0.1), n(heads, 1, 1), n(9, heads, sc=0.02),
              n(A, C, sc=0.2), n(C, sc=0.1), n(dim, dim, sc=0.2), n(dim, sc=0.1)]
    return u, params, n(2, wh, ww, dim)


def _table_cotangent(dbias, heads):
    """d(bias) [nh, 4, 4] -> d(table) [9, nh]: the transpose of the gather."""
    index = np.asarray(relative_position_index(2, 2)).reshape(-1)
    out = np.zeros((9, heads), np.float32)
    np.add.at(out, index, np.asarray(dbias).transpose(1, 2, 0).reshape(16, heads))
    return out


def _jax_cotangents(u, params, g, heads, has_bqkv=True, has_bproj=True):
    j = [jnp.asarray(p) for p in params]
    bias = gather_rel_pos_bias(j[3], relative_position_index(2, 2), heads)
    args = [jnp.asarray(u), j[0], j[1], j[2], bias, j[4], j[5], j[6], j[7]]

    def loss(*a):
        a = list(a)
        out = jfused(a[0], a[1], a[2] if has_bqkv else None, a[3], a[4], a[5],
                     a[6] if has_bproj else None, a[7], a[8], heads,
                     interpret=True, backward="pallas")
        return jnp.sum(out * jnp.asarray(g))

    grads = list(jax.grad(loss, argnums=tuple(range(9)))(*args))
    grads[4] = _table_cotangent(grads[4], heads)
    return [np.asarray(x) for x in grads]


def _port_cotangents(u, params, g, heads):
    t = [None if p is None else torch.from_numpy(p) for p in params]
    return cuda_ngram.ngram_context_backward_math(
        torch.from_numpy(u), torch.from_numpy(g), *t, num_heads=heads)


@pytest.mark.parametrize("dim,heads,wh,ww", [(64, 6, 4, 4), (64, 4, 3, 5), (32, 2, 2, 2)])
def test_plain_backward_matches_jax_backward_kernel(dim, heads, wh, ww):
    u, params, g = _inputs(dim, heads, wh, ww)
    ref = _jax_cotangents(u, params, g, heads)
    got = _port_cotangents(u, params, g, heads)
    assert len(got) == len(ref) == 9
    for name, a, b in zip(NAMES, got, ref):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **TOL)


@pytest.mark.parametrize("has_bqkv,has_bproj", [(False, True), (True, False), (False, False)])
def test_plain_backward_without_biases_matches_jax(has_bqkv, has_bproj):
    """An absent bqkv / bproj gets no cotangent, and the others still agree."""
    u, params, g = _inputs(64, 4, 3, 4, seed=8)
    ref = _jax_cotangents(u, params, g, 4, has_bqkv, has_bproj)
    if not has_bqkv:
        params[1] = None
    if not has_bproj:
        params[5] = None
    got = _port_cotangents(u, params, g, 4)
    assert (got[2] is None) == (not has_bqkv) and (got[6] is None) == (not has_bproj)
    for name, a, b in zip(NAMES, got, ref):
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b, err_msg=name, **TOL)


def test_saturated_logit_scale_gets_a_zero_cotangent_on_both_sides():
    """exp(clip(ls, ln 100)) is flat above ln 100 ≈ 4.605.  At a scale of 100
    the softmaxes saturate and the cotangents lose digits on both sides:
    each tensor is held to 5e-5 of its largest entry."""
    u, params, g = _inputs(64, 4, 3, 3, seed=9)
    params[2] = np.array([10.0, 1.0, 4.7, 2.0], np.float32).reshape(4, 1, 1)
    ref = _jax_cotangents(u, params, g, 4)
    got = _port_cotangents(u, params, g, 4)
    for side in (got[3].numpy().reshape(4), ref[3].reshape(4)):
        assert side[0] == 0 and side[2] == 0 and side[1] != 0 and side[3] != 0
    for name, a, b in zip(NAMES, got, ref):
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, rtol=0,
                                   atol=5e-5 * max(1.0, float(np.abs(b).max())))


def test_fused_wrapper_differentiates_to_the_plain_backward_on_the_cpu(monkeypatch):
    """On a CPU tensor the wrapper is the plain version under autograd: the
    same cotangents as ``ngram_context_backward_math``, and no launch."""
    f = cuda_ngram.fused_ngram_context
    monkeypatch.setattr(f, "launches", 0)
    monkeypatch.setattr(f, "backward_launches", 0)
    u, params, g = _inputs(64, 6, 2, 3, seed=10)
    leaves = [torch.from_numpy(u).requires_grad_()] + [
        torch.from_numpy(p).requires_grad_() for p in params]
    out = f(*leaves, 6)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    ref = _port_cotangents(u, params, g, 6)
    for name, a, b in zip(NAMES, got, ref):
        assert torch.equal(a, b), name
    assert f.launches == 0 and f.backward_launches == 0


@pytest.mark.parametrize("dim,heads,wh,ww", [(64, 6, 3, 3), (64, 4, 2, 3)])
def test_ngram_context_module_fused_matches_flax_forward_and_gradients(monkeypatch, dim, heads, wh, ww):
    """``NGramContext(attn_backward="pallas", ngram_fused=True)`` against the
    flax module under ``TMAR_NGRAM_FUSED=1`` (megakernel primal and fused
    backward kernel, interpret mode), same weights: the context, the input
    gradient and every parameter gradient.  Forward atol = rtol = 3e-5 (the
    megakernel's tolerance), gradients atol = rtol = 5e-5."""
    ws = 8
    flax_mod = FlaxNGramContext(dim=dim, window_size=ws, ngram=2, ngram_num_heads=heads,
                                use_pallas=True, pallas_interpret=True, attn_backward="pallas")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, wh * ws, ww * ws, dim)).astype(np.float32)
    g = rng.standard_normal((2, wh, ww, dim)).astype(np.float32)
    monkeypatch.setenv("TMAR_NGRAM_FUSED", "1")
    params = flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def loss(p, xx):
        return jnp.sum(flax_mod.apply({"params": p}, xx) * jnp.asarray(g))

    ref_out = flax_mod.apply({"params": params}, jnp.asarray(x))
    ref_gp, ref_gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    mod = NGramContext(dim, ws, 2, heads, attn_backward="pallas", ngram_fused=True)
    mod.load_state_dict(from_flax_params(jax.tree_util.tree_map(np.asarray, params)))
    xt = torch.from_numpy(x).requires_grad_()
    out = mod(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=3e-5, rtol=3e-5)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_gx), err_msg="x", **TOL)
    ref_grads = from_flax_params(jax.tree_util.tree_map(np.asarray, ref_gp))
    got = dict(mod.named_parameters())
    assert set(got) == set(ref_grads)
    for k, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[k].numpy(), err_msg=k, **TOL)


def test_ngram_fused_flag_selects_the_path_and_keeps_the_state_dict(monkeypatch):
    """ngram_fused=True goes through ``fused_ngram_context``, False and a
    grid below 2x2 through the composition; the state_dict is the same."""
    from tmar_torch.nn import ngram as ngram_mod

    calls = []
    real = ngram_mod.fused_ngram_context
    monkeypatch.setattr(ngram_mod, "fused_ngram_context",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    fused = NGramContext(64, 8, 2, 4, attn_backward="pallas", ngram_fused=True)
    comp = NGramContext(64, 8, 2, 4, attn_backward="pallas", ngram_fused=False)
    assert list(fused.state_dict()) == list(comp.state_dict())
    comp.load_state_dict(fused.state_dict())
    x = torch.from_numpy(np.random.default_rng(12).standard_normal((1, 16, 24, 64)).astype(np.float32))
    a = fused(x)
    assert calls == [1]
    b = comp(x)
    assert calls == [1]
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=3e-5, rtol=3e-5)
    with pytest.raises(ValueError, match="at least 2x2"):
        fused(x[:, :8])  # a 1x3 grid takes the composition, which refuses it
    assert calls == [1]
