"""Windows past 8x8 and heads wider than 32 channels: the port against the
JAX package at float32 on the CPU, on the same seeded numpy inputs.

On the card these geometries run the long-window bodies of K3/K4 and K2/K8
(``csrc/window_attention_long.cuh``, ``csrc/nstb_long.cuh``); here the
plain versions they are held to there run, against the Pallas kernels in
interpret mode (which take any window and head width) and the flax NGswin:

* ``fused_window_attention``, the output and all seven cotangents, at N =
  81 (9x9) and 256 (16x16, HAT's window) with head_dim 40 and 64 (A > D),
  the shift mask on and off: atol 2e-4 on the output; cotangents atol 5e-4
  + rtol 5e-3 of the tensor's largest (sums over 256 keys and the windows);
* the whole NSTB at window 16 in the map and the token form, shift 0 and 8,
  head_dim 10 and 40: atol 2e-5, rtol 2e-5 (tests/test_torch_port_nstb.py's);
* a tiny NGswin at window 16 on a 128² input (the JAX model fails on a
  reshape at 64²: its third stage's 16² map is one window), forward against
  the flax model with the weights carried over: atol 5e-5, rtol 1e-4.

The envelope's long-window rule and plans are held in
tests/test_torch_port_envelope.py; the kernels themselves run only on the
card (tests/test_torch_port_gpu.py, chip_smoke.py phase 25)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.nn import NGswin as FlaxNGswin
from tmar.ops.attention import gather_rel_pos_bias, relative_position_index
from tmar.ops.pallas_attention import fused_window_attention as jfused
from tmar.ops.pallas_nstb import fused_nstb as jfused_tokens
from tmar.ops.pallas_nstb import fused_nstb_map as jfused_map
from tmar.ops.pallas_nstb import quadrant_selector as jquadrant_selector
from tmar.ops.window import cyclic_shift, shift_mask_components, window_partition
from tmar_torch import NGswin, from_flax_params
from tmar_torch.checkpoint import to_flax_params
from tmar_torch.ops import cuda_attention, cuda_nstb, envelope
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

NAMES = ["out", "dx", "dwqkv", "dbqkv", "dlogit_scale", "dbias", "dwproj", "dbproj"]
NSTB_TOL = dict(atol=2e-5, rtol=2e-5)
MODEL_TOL = dict(atol=5e-5, rtol=1e-4)


def _normal(rng, *shape, sc=1.0):
    return (rng.standard_normal(shape) * sc).astype(np.float32)


# ---- window attention (K3/K4's function) -------------------------------------

@functools.lru_cache(maxsize=None)
def _attention_case(N, hd, mask):
    """Four windows of N tokens on a 2x2 grid at D 32 (A = nh·hd > D), the
    JAX kernels' output and cotangents as numpy."""
    rng = np.random.default_rng(N + hd)
    D, nh, B_ = 32, (2 if hd == 40 else 1), 4
    A = nh * hd
    ws = int(round(N ** 0.5))
    x, g = _normal(rng, B_, N, D), _normal(rng, B_, N, D)
    params = [_normal(rng, D, 3 * A, sc=0.15), _normal(rng, 3 * A, sc=0.1),
              rng.uniform(0.5, 2.3, (nh, 1, 1)).astype(np.float32),
              _normal(rng, nh, N, N, sc=0.2), _normal(rng, A, D, sc=0.15),
              _normal(rng, D, sc=0.1)]
    mc = (*shift_mask_components(ws, ws // 2), 2, 2) if mask else None

    def f(xx, *ps):
        return jfused(xx, *ps, nh, mask_components=mc, interpret=True, backward="pallas",
                      windows_per_step=B_)

    def forward_and_cotangents(xx, gg, *ps):
        out, vjp = jax.vjp(f, xx, *ps)
        return (out, *vjp(gg))

    # one jit of the forward and its VJP (the same kernels, one compile)
    ref = jax.jit(forward_and_cotangents)(jnp.asarray(x), jnp.asarray(g),
                                          *[jnp.asarray(p) for p in params])
    return nh, x, g, params, mc, [np.asarray(t) for t in ref]


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("N,hd", [(81, 40), (81, 64), (256, 40), (256, 64)])
def test_long_window_attention_matches_pallas_interpret(N, hd, mask):
    nh, x, g, params, mc, ref = _attention_case(N, hd, mask)
    assert envelope.attention_body(N, 32, nh, hd, torch.float32) == "long-window"
    leaves = [torch.from_numpy(x).requires_grad_()] + [
        torch.from_numpy(p).requires_grad_() for p in params]
    out = cuda_attention.fused_window_attention(*leaves, nh, mask_components=mc)
    cots = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), ref[0], atol=2e-4, rtol=0, err_msg="out")
    for name, a, b in zip(NAMES[1:], cots, ref[1:]):
        assert a.shape == b.shape, name
        err = float(np.abs(a.numpy() - b).max())
        assert err <= 5e-4 + 5e-3 * float(np.abs(b).max()), (name, err)


def test_long_window_bf16_plain_pair_is_the_autograd_path():
    """At bfloat16 a CPU tensor runs the rounding-matched plain pair, which
    the long-window bodies are held to on the card: forward finite, and the
    explicit backward's cotangents those of autograd through the
    Function."""
    nh, x, g, params, mc, _ = _attention_case(256, 64, True)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    ps = [torch.from_numpy(p).requires_grad_() for p in params]
    out = cuda_attention.fused_window_attention(xt, *ps, nh, mask_components=mc)
    cots = torch.autograd.grad(out, [xt, *ps], torch.from_numpy(g).to(torch.bfloat16))
    want = cuda_attention.window_attention_backward_math(
        xt.detach(), torch.from_numpy(g).to(torch.bfloat16), *[p.detach() for p in ps], nh,
        mask_components=mc)
    assert torch.isfinite(out.float()).all() and out.dtype == torch.bfloat16
    for name, a, b in zip(NAMES[1:], cots, want):
        assert torch.equal(a, b.to(a.dtype)), name


# ---- the whole NSTB at window 16 (K2/K8's function) -----------------------------

def _nstb_inputs(hd, Q, seed):
    """A 2 x 32 x 48 map (a 2x3 grid of 16x16 windows) at D 32, nh heads of
    hd, hidden 64, and the weights (numpy float32)."""
    rng = np.random.default_rng(seed)
    D, nh, H, ws = 32, 2, 64, 16
    A = nh * hd
    x = _normal(rng, 2, 32, 48, D)
    cq = _normal(rng, 2 * 2 * 3, Q, D, sc=0.5)
    params = [_normal(rng, D, 3 * A, sc=0.15), _normal(rng, 3 * A, sc=0.1),
              _normal(rng, nh, 1, 1), _normal(rng, (2 * ws - 1) ** 2, nh, sc=0.5),
              _normal(rng, A, D, sc=0.15), _normal(rng, D, sc=0.1),
              (1 + _normal(rng, D, sc=0.1), _normal(rng, D, sc=0.1)),
              (_normal(rng, D, H, sc=0.15), _normal(rng, H, sc=0.1)),
              (_normal(rng, H, D, sc=0.1), _normal(rng, D, sc=0.1)),
              (1 + _normal(rng, D, sc=0.1), _normal(rng, D, sc=0.1))]
    return nh, x, cq, params


def _each(f, p):
    return tuple(f(q) for q in p) if isinstance(p, tuple) else f(p)


@pytest.mark.parametrize("form", ["map", "tokens"])
@pytest.mark.parametrize("shift", [0, 8])
@pytest.mark.parametrize("hd", [10, 40])
def test_window_16_nstb_matches_pallas_interpret(form, shift, hd):
    # the map form takes one context a window at shift 0, the token form
    # always the four quadrants (slot 0 read at shift 0), as the blocks pass them
    ws, Q = 16, (1 if shift == 0 and form == "map" else 4)
    nh, x, cq, params = _nstb_inputs(hd, Q, seed=hd + shift)
    assert envelope.nstb_body(ws * ws, 32, nh, hd, 64, torch.float32) == "long-window"
    jp = [_each(jnp.asarray, p) for p in params]
    bias = gather_rel_pos_bias(jp[3], relative_position_index(ws, ws), nh)
    sel = np.ones((ws * ws, 1), np.float32) if Q == 1 else jquadrant_selector(ws, shift)
    mc = (*shift_mask_components(ws, shift), 2, 3) if shift else None
    tp = [_each(torch.from_numpy, p) for p in params]
    if form == "map":
        ref = jax.jit(lambda xx, cc, w: jfused_map(
            xx, cc, sel, w[0], w[1], w[2], bias, w[4], w[5], *w[6:], num_heads=nh,
            window_size=ws, mask_components=mc, interpret=True, shift=shift))(
            jnp.asarray(x), jnp.asarray(cq), jp)
        got = cuda_nstb.fused_nstb_map(torch.from_numpy(x), torch.from_numpy(cq), *tp, nh, ws,
                                       shift=shift)
    else:
        wins, _ = window_partition(cyclic_shift(jnp.asarray(x), shift), ws)
        wins = np.array(wins).reshape(-1, ws * ws, 32)
        ref = jax.jit(lambda xx, cc, w: jfused_tokens(
            xx, cc, sel, w[0], w[1], w[2], bias, w[4], w[5], *w[6:], num_heads=nh,
            mask_components=mc, windows_per_step=6, interpret=True))(
            jnp.asarray(wins), jnp.asarray(cq), jp)
        got = cuda_nstb.fused_nstb(torch.from_numpy(wins), torch.from_numpy(cq), *tp, nh, ws,
                                   shift=shift, grid=(2, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **NSTB_TOL)


# ---- a tiny NGswin at window 16 ------------------------------------------------------

TINY16 = dict(ngrams=(2, 2, 2, 2), embed_dim=32, depths=(1, 1, 1), num_heads=(2, 2, 2),
              dec_dim=32, dec_depths=1, dec_num_heads=2, window_size=16)


def test_tiny_window_16_ngswin_matches_flax():
    """Window 16 at embed 32: every block's attention runs 256-token
    windows (the long-window bodies on the card), on a 128² input.  The
    port's weights go to flax (``to_flax_params``), whose tree is the flax
    model's own (``jax.eval_shape`` of its init), and back bit for bit."""
    x = np.random.default_rng(16).uniform(-1, 1, (1, 128, 128, 1)).astype(np.float32)
    torch.manual_seed(16)
    model = NGswin(**TINY16, device="cpu")
    params = to_flax_params(model.state_dict())
    flax_model = FlaxNGswin(**TINY16)
    shapes = jax.eval_shape(flax_model.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(shapes), jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape
    assert all(torch.equal(a, b) for a, b in zip(
        from_flax_params(params).values(), model.state_dict().values()))
    apply = jax.jit(flax_model.apply).lower({"params": params}, jnp.asarray(x)).compile(
        {"xla_llvm_disable_expensive_passes": True})  # the same arithmetic, a shorter compile
    ref = np.asarray(apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, ref, **MODEL_TOL)


def test_window_16_needs_a_two_by_two_window_grid_at_the_third_stage():
    """At window 16 a 64² input (padded to 4·16 = 64) leaves the third
    stage a single 16x16 window, whose n-gram context cannot reflect-pad:
    the port raises naming the grid (the JAX model fails on a reshape
    there); 80² pads to 128² and runs."""
    model = NGswin(**TINY16, device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="at least 2x2"):
        model(torch.zeros(1, 64, 64, 1))
    with torch.no_grad():
        assert model(torch.zeros(1, 80, 80, 1)).shape == (1, 80, 80, 1)
