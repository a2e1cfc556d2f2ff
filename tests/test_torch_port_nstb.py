"""The port's whole-NSTB map block (tmar_torch.ops.cuda_nstb / nn.blocks)
against the JAX map kernel run in Pallas interpret mode, on the same seeded
numpy inputs, at float32.

Tolerance atol 2e-5, rtol 2e-5 (the JAX package's fused-vs-unfused NSTB
tolerance, tests/test_pallas_nstb.py); 5e-5 at a saturated logit scale, as
there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.nn.blocks import NSTB as FlaxNSTB
from tmar.ops.attention import gather_rel_pos_bias, relative_position_index
from tmar.ops.pallas_nstb import fused_nstb_map as jfused_map
from tmar.ops.pallas_nstb import quadrant_selector as jquadrant_selector
from tmar.ops.window import shift_mask_components
from tmar_torch.checkpoint import from_flax_params
from tmar_torch.nn.blocks import NSTB
from tmar_torch.ops import cuda_nstb
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(nh, B, ph, pw, Q, D=64, seed=0):
    rng = np.random.default_rng(seed)
    H = 2 * D
    A = (D // nh) * nh

    def n(*s, sc=1.0):
        return (rng.standard_normal(s) * sc).astype(np.float32)

    x = n(B, ph, pw, D)
    cq = n(B * (ph // 8) * (pw // 8), Q, D, sc=0.5)
    params = [n(D, 3 * A, sc=0.15), n(3 * A, sc=0.1), n(nh, 1, 1), n(225, nh, sc=0.5),
              n(A, D, sc=0.15), n(D, sc=0.1), (1 + n(D, sc=0.1), n(D, sc=0.1)),
              (n(D, H, sc=0.15), n(H, sc=0.1)), (n(H, D, sc=0.1), n(D, sc=0.1)),
              (1 + n(D, sc=0.1), n(D, sc=0.1))]
    return x, cq, params


def _map(f, p):
    return tuple(f(q) for q in p) if isinstance(p, tuple) else f(p)


@pytest.mark.parametrize("nh", [6, 4])
@pytest.mark.parametrize("shift", [0, 4])
def test_nstb_map_matches_pallas_interpret(nh, shift):
    """16x24 map, B = 2: a 2x3 window grid, so the shift mask's last row and
    last column and their corner all occur."""
    Q = 1 if shift == 0 else 4
    x, cq, params = _inputs(nh, 2, 16, 24, Q)
    jp = [_map(jnp.asarray, p) for p in params]
    bias = gather_rel_pos_bias(jp[3], relative_position_index(8, 8), nh)
    sel = np.ones((64, 1), np.float32) if Q == 1 else jquadrant_selector(8, shift)
    mc = (*shift_mask_components(8, shift), 2, 3) if shift else None
    ref = jfused_map(
        jnp.asarray(x), jnp.asarray(cq), sel, jp[0], jp[1], jp[2], bias, jp[4], jp[5],
        *jp[6:], num_heads=nh, window_size=8, mask_components=mc, interpret=True, shift=shift,
    )
    got = cuda_nstb.fused_nstb_map(
        torch.from_numpy(x), torch.from_numpy(cq), *[_map(torch.from_numpy, p) for p in params],
        nh, 8, shift=shift,
    )
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_nstb_map_cpu_leaves_launch_count(monkeypatch):
    monkeypatch.setattr(cuda_nstb.fused_nstb_map, "launches", 0)
    x, cq, params = _inputs(4, 1, 16, 16, 4)
    cuda_nstb.fused_nstb_map(
        torch.from_numpy(x), torch.from_numpy(cq), *[_map(torch.from_numpy, p) for p in params],
        4, 8, shift=4,
    )
    assert cuda_nstb.fused_nstb_map.launches == 0


def test_quadrant_selector_and_context_quads():
    for shift in (0, 2, 4):
        np.testing.assert_array_equal(
            cuda_nstb.quadrant_selector(8, shift), jquadrant_selector(8, shift)
        )
    from tmar.ops.pallas_nstb import context_quads as jcq

    ctx = np.random.default_rng(3).standard_normal((2, 3, 4, 5)).astype(np.float32)
    for shift in (0, 4):
        np.testing.assert_array_equal(
            cuda_nstb.context_quads(torch.from_numpy(ctx), shift).numpy(),
            np.asarray(jcq(jnp.asarray(ctx), shift)),
        )


def _flax_block(dim, heads, shift, ph, pw, saturate=False, seed=0):
    blk = FlaxNSTB(dim=dim, ngram=2, num_heads=heads, window_size=8, shift_size=shift,
                   use_pallas=True, pallas_interpret=True)
    x = np.random.default_rng(seed).standard_normal((1, ph * pw, dim)).astype(np.float32)
    params = blk.init(jax.random.PRNGKey(seed), jnp.asarray(x), (ph, pw))["params"]
    if saturate:
        params = jax.tree_util.tree_map_with_path(
            lambda path, v: jnp.full_like(v, 10.0) if path[-1].key == "logit_scale" else v,
            params,
        )
    return blk, params, x


@pytest.mark.parametrize("heads,shift", [(6, 0), (6, 4), (4, 4)])
def test_nstb_module_matches_flax(monkeypatch, heads, shift):
    """The port's NSTB against the flax NSTB on its fused map path
    (use_pallas=True, interpret mode), with the flax block's weights."""
    monkeypatch.setenv("TMAR_NSTB_FUSED", "1")
    monkeypatch.setenv("TMAR_NSTB_MAP", "1")
    ph, pw = 16, 16
    blk, params, x = _flax_block(64, heads, shift, ph, pw)
    _, ref = blk.apply({"params": params}, jnp.asarray(x), (ph, pw))
    mod = NSTB(64, 2, heads, 8, shift)
    mod.load_state_dict(from_flax_params(params))
    with torch.no_grad():
        x_in, got = mod(torch.from_numpy(x), (ph, pw))
    np.testing.assert_array_equal(x_in.numpy(), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_nstb_module_finite_at_saturated_logit_scale(monkeypatch):
    """logit_scale at its ln(100) clamp: logits reach ~100 and the softmax
    must stay finite (its row max subtraction is load-bearing)."""
    monkeypatch.setenv("TMAR_NSTB_FUSED", "1")
    monkeypatch.setenv("TMAR_NSTB_MAP", "1")
    blk, params, x = _flax_block(64, 4, 4, 16, 16, saturate=True, seed=7)
    _, ref = blk.apply({"params": params}, jnp.asarray(x), (16, 16))
    mod = NSTB(64, 2, 4, 8, 4)
    mod.load_state_dict(from_flax_params(params))
    with torch.no_grad():
        _, got = mod(torch.from_numpy(x), (16, 16))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-5)
