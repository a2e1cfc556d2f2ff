"""The port's serving block forms against the JAX package's, on the same
seeded numpy inputs, at float32 on the CPU:

* the token-level whole NSTB (``tmar_torch.ops.cuda_nstb.fused_nstb``, its
  plain version on a CPU tensor) against ``tmar.ops.pallas_nstb.fused_nstb``
  with its Pallas kernel in interpret mode;
* the port's ``NSTB`` in each of its three inference forms (fused map, fused
  tokens, unfused) against the flax ``NSTB`` under ``TMAR_NSTB_MAP=1``,
  ``TMAR_NSTB_MAP=0`` and ``TMAR_NSTB_FUSED=0`` (``use_pallas=True``,
  interpret mode), with the flax block's weights;
* ``fused_window_attention(impl=name)`` against the JAX op under every name
  of ``TMAR_ATTN_IMPL``, in interpret mode.

Tolerance atol 5e-5, rtol 1e-4 (the JAX package's model-level tolerance);
the attention forward atol 2e-4, the JAX package's kernel-vs-math tolerance
(tests/test_pallas_attention.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.nn.blocks import NSTB as FlaxNSTB
from tmar.ops.attention import gather_rel_pos_bias as jgather
from tmar.ops.attention import relative_position_index as jrel_index
from tmar.ops.pallas_attention import fused_window_attention as jfused_attn
from tmar.ops.pallas_nstb import fused_nstb as jfused_nstb
from tmar.ops.pallas_nstb import quadrant_selector as jquadrant_selector
from tmar.ops.window import shift_mask_components
from tmar_torch.checkpoint import from_flax_params
from tmar_torch.nn.blocks import NSTB
from tmar_torch.ops import cuda_attention, cuda_nstb
from tmar_torch.ops.attention import gather_rel_pos_bias, relative_position_index
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

TOL = dict(atol=5e-5, rtol=1e-4)
FORMS = {
    "map": ({"TMAR_NSTB_FUSED": "1", "TMAR_NSTB_MAP": "1"}, {}),
    "tokens": ({"TMAR_NSTB_FUSED": "1", "TMAR_NSTB_MAP": "0"}, {"nstb_map": False}),
    "unfused": ({"TMAR_NSTB_FUSED": "0"}, {"nstb_fused": False}),
}


def _nstb_inputs(B_, D, nh, seed=0):
    """Context-free windows [B_, 64, D], 4 context quads per window and the
    block's weights (fused_nstb_map's order), H = 2D."""
    rng = np.random.default_rng(seed)
    H = 2 * D
    A = (D // nh) * nh

    def n(*s, sc=1.0):
        return (rng.standard_normal(s) * sc).astype(np.float32)

    params = [n(D, 3 * A, sc=0.3), n(3 * A, sc=0.1), n(nh, 1, 1), n(225, nh, sc=0.5),
              n(A, D, sc=0.3), n(D, sc=0.1), (1 + n(D, sc=0.1), n(D, sc=0.1)),
              (n(D, H, sc=0.3), n(H, sc=0.1)), (n(H, D, sc=0.2), n(D, sc=0.1)),
              (1 + n(D, sc=0.1), n(D, sc=0.1))]
    return n(B_, 64, D), n(B_, 4, D, sc=0.5), params


def _map(f, p):
    return tuple(f(q) for q in p) if isinstance(p, tuple) else f(p)


@pytest.mark.parametrize("shift", [0, 4])
def test_fused_nstb_matches_pallas_interpret(shift):
    """D = 8, 2 heads, 3 windows on a 1x3 grid; the JAX kernel at 2 windows
    per step pads a zero window and wraps its gate, the port walks 3."""
    nh, D = 2, 8
    x, cq, params = _nstb_inputs(3, D, nh)
    jp = [_map(jnp.asarray, p) for p in params]
    bias = jgather(jp[3], jrel_index(8, 8), nh)
    mc = (*shift_mask_components(8, shift), 1, 3) if shift else None
    ref = jfused_nstb(
        jnp.asarray(x), jnp.asarray(cq), jquadrant_selector(8, shift), jp[0], jp[1], jp[2],
        bias, jp[4], jp[5], *jp[6:], num_heads=nh, mask_components=mc, windows_per_step=2,
        interpret=True,
    )
    got = cuda_nstb.fused_nstb(
        torch.from_numpy(x), torch.from_numpy(cq), *[_map(torch.from_numpy, p) for p in params],
        nh, 8, shift=shift, grid=(1, 3),
    )
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_fused_nstb_token_and_map_forms_agree():
    """The token form on the rolled windows equals the map form on the map
    (Q = 4 at shift 4; Q = 1 and Q = 4 at shift 0 read the same context)."""
    rng = np.random.default_rng(5)
    nh, D, B, ph, pw = 2, 16, 2, 16, 24
    xmap = torch.from_numpy(rng.standard_normal((B, ph, pw, D)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((B, 2, 3, D)).astype(np.float32))
    _, _, params = _nstb_inputs(1, D, nh, seed=6)
    params = [_map(torch.from_numpy, p) for p in params]
    from tmar_torch.ops.window import cyclic_shift, window_partition, window_unpartition

    for shift in (0, 4):
        cq4 = cuda_nstb.context_quads(ctx, shift).reshape(-1, 4, D)
        wins, _ = window_partition(cyclic_shift(xmap, shift), 8)
        z = cuda_nstb.fused_nstb(wins.reshape(-1, 64, D), cq4, *params, nh, 8, shift=shift,
                                 grid=(2, 3))
        got = window_unpartition(z.reshape(-1, 8, 8, D), (2, 3))
        cq_map = ctx.reshape(-1, 1, D) if shift == 0 else cq4
        ref = cuda_nstb.fused_nstb_map(xmap, cq_map, *params, nh, 8, shift=shift)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_fused_nstb_shifted_block_needs_its_grid():
    x, cq, params = _nstb_inputs(2, 8, 2)
    with pytest.raises(ValueError, match="window grid"):
        cuda_nstb.fused_nstb(torch.from_numpy(x), torch.from_numpy(cq),
                             *[_map(torch.from_numpy, p) for p in params], 2, 8, shift=4)


def _flax_block(dim, heads, shift, ph, pw, B=2, saturate=False, seed=0):
    blk = FlaxNSTB(dim=dim, ngram=2, num_heads=heads, window_size=8, shift_size=shift,
                   use_pallas=True, pallas_interpret=True)
    x = np.random.default_rng(seed).standard_normal((B, ph * pw, dim)).astype(np.float32)
    params = blk.init(jax.random.PRNGKey(seed), jnp.asarray(x), (ph, pw))["params"]
    if saturate:
        params = jax.tree_util.tree_map_with_path(
            lambda path, v: jnp.full_like(v, 10.0) if path[-1].key == "logit_scale" else v,
            params,
        )
    return blk, params, x


@pytest.mark.parametrize("form", list(FORMS))
def test_nstb_form_matches_flax(monkeypatch, form):
    """A shifted block on a 2 x 16 x 24 map (a 2x3 window grid: the mask's
    last row, last column and corner all occur), 32 channels, 2 heads.  (The
    unshifted blocks of every form are held in tests/test_torch_port_serving.py,
    inside the tiny NGswin.)"""
    shift = 4
    env, kwargs = FORMS[form]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ph, pw = 16, 24
    blk, params, x = _flax_block(32, 2, shift, ph, pw)
    _, ref = blk.apply({"params": params}, jnp.asarray(x), (ph, pw))
    mod = NSTB(32, 2, 2, 8, shift, **kwargs)
    mod.load_state_dict(from_flax_params(params))
    with torch.no_grad():
        _, got = mod(torch.from_numpy(x), (ph, pw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_nstb_token_form_finite_at_saturated_logit_scale(monkeypatch):
    """logit_scale at its ln(100) clamp: logits reach ~100 and the token
    form's softmax must stay finite (its row max subtraction is load-bearing),
    as tests/test_pallas_nstb.py holds the JAX token kernel."""
    monkeypatch.setenv("TMAR_NSTB_FUSED", "1")
    monkeypatch.setenv("TMAR_NSTB_MAP", "0")
    blk, params, x = _flax_block(32, 2, 4, 16, 16, B=1, saturate=True, seed=7)
    _, ref = blk.apply({"params": params}, jnp.asarray(x), (16, 16))
    mod = NSTB(32, 2, 2, 8, 4, nstb_map=False)
    mod.load_state_dict(from_flax_params(params))
    with torch.no_grad():
        _, got = mod(torch.from_numpy(x), (16, 16))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5, rtol=5e-5)


def test_training_form_ignores_the_block_form():
    mod = NSTB(32, 2, 2, 8, 4, attn_backward="pallas", nstb_map=False)
    assert not mod.nstb_fused


def _attn_inputs(B_, N, D, nh, hd, seed=0):
    rng = np.random.default_rng(seed)
    A = nh * hd
    n = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return [
        n(B_, N, D), n(D, 3 * A) * 0.1, n(3 * A) * 0.1,
        rng.uniform(0.5, 2.3, size=(nh, 1, 1)).astype(np.float32),
        None, n(A, D) * 0.1, n(D) * 0.1,
    ], n((2 * int(np.sqrt(N)) - 1) ** 2, nh) * 0.2


ATTN_CASES = [(name, 64, shift) for name in sorted(cuda_attention.IMPLS) for shift in (0, 4)]
ATTN_CASES += [("diag", 4, 0), ("blockdiag", 4, 0)]


@pytest.mark.parametrize("impl,N,shift", ATTN_CASES)
def test_attention_impl_matches_jax(impl, N, shift):
    """N = 64: 2 images of a 2x2 window grid, D 32, 3 heads of 10; N = 4:
    12 n-gram windows, D 32, 3 heads of 10.  The port runs the same function
    under every name; the JAX op runs the named Pallas kernel."""
    nh, hd, D = 3, 10, 32
    ws = int(np.sqrt(N))
    args, table = _attn_inputs(8 if N == 64 else 12, N, D, nh, hd)
    args[4] = np.asarray(jgather(jnp.asarray(table), jrel_index(ws, ws), nh))
    mc = (*shift_mask_components(ws, shift), 2, 2) if shift else None
    ref = jfused_attn(*[jnp.asarray(a) for a in args], num_heads=nh, mask_components=mc,
                      interpret=True, impl=impl)
    bias = gather_rel_pos_bias(torch.from_numpy(table), relative_position_index(ws, ws), nh)
    t = [torch.from_numpy(a) for a in args[:4]] + [bias] + [torch.from_numpy(a) for a in args[5:]]
    got = cuda_attention.fused_window_attention(*t, nh, mask_components=mc, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-4)


def test_attention_impl_unknown_name_raises():
    args, table = _attn_inputs(2, 64, 32, 3, 10)
    bias = gather_rel_pos_bias(torch.from_numpy(table), relative_position_index(8, 8), 3)
    t = [torch.from_numpy(a) for a in args[:4]] + [bias] + [torch.from_numpy(a) for a in args[5:]]
    with pytest.raises(ValueError, match="unknown attention impl"):
        cuda_attention.fused_window_attention(*t, 3, impl="blockdiag_fast")
    from tmar_torch import cli

    with pytest.raises(ValueError, match="unknown attention impl"):
        cli.block_form({"TMAR_ATTN_IMPL": "batched2"})


def test_attention_impl_defaults_follow_the_window_length():
    assert cuda_attention.resolve_impl(None, 64) == "batched"
    assert cuda_attention.resolve_impl(None, 32) == "batched"
    assert cuda_attention.resolve_impl(None, 4) == "blockdiag"
    assert cuda_attention.resolve_impl("diag", 64) == "diag"
