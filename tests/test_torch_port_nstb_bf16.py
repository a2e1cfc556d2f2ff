"""The port's whole-NSTB plain versions at bfloat16 against the JAX kernels
run in Pallas interpret mode at bfloat16, on the same seeded numpy inputs.

The JAX kernel rounds every product's operands to the activation dtype
(tmar/ops/pallas_nstb.py:_nstb_body and pallas_attention.py:
batched_attention_core): x_attn, q_n, k_n, v, the normalised P, the
attention output, y and the GELU output.  ``cuda_nstb.nstb_math`` rounds at
the same points, so the two differ only by summation order and libm: the
output within one bf16 ulp, max |err| <= 2^-7·max|ref| and mean |err| <=
5e-5.  The float32 plain version on the same bf16 inputs does not meet the
mean bound: the last test shows that the rounding is applied.

Inputs, matrices and context quads are bfloat16 on both sides; biases,
LayerNorms, the bias table and the logit scale stay float32 (both kernels
read them so)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.ops.attention import gather_rel_pos_bias, relative_position_index
from tmar.ops.pallas_nstb import fused_nstb as jfused
from tmar.ops.pallas_nstb import fused_nstb_map as jfused_map
from tmar.ops.pallas_nstb import quadrant_selector as jquadrant_selector
from tmar.ops.window import shift_mask_components
from tmar_torch.ops import cuda_nstb
from tmar_torch.ops.window import cyclic_shift, window_partition

MAX_TOL = 2.0**-7   # x max|ref|
MEAN_TOL = 5e-5
MATS = (0, 4)       # wqkv, wproj; and the first member of ffn1, ffn2


def _inputs(nh, Q, B=2, ph=16, pw=24, D=64, seed=0):
    """The inputs of tests/test_torch_port_nstb.py on its 2x16x24 map (a 2x3
    window grid, so the shift mask's last row, last column and corner all
    occur), the matrices, x and the context quads rounded to bf16."""
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
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    params = [bf(p) if i in MATS else p for i, p in enumerate(params)]
    params[7] = (bf(params[7][0]), params[7][1])
    params[8] = (bf(params[8][0]), params[8][1])
    return bf(x), bf(cq), params


def _jax(p):
    return tuple(jnp.asarray(q) for q in p) if isinstance(p, tuple) else jnp.asarray(p)


def _torch(p):
    if isinstance(p, tuple):
        return tuple(_torch(q) for q in p)
    return torch.from_numpy(np.asarray(p, np.float32)).to(
        torch.bfloat16 if p.dtype == jnp.bfloat16 else torch.float32)


def _jax_args(nh, shift, params):
    jp = [_jax(p) for p in params]
    bias = gather_rel_pos_bias(jp[3], relative_position_index(8, 8), nh)
    mc = (*shift_mask_components(8, shift), 2, 3) if shift else None
    return jp, bias, mc


def _errors(got, ref):
    d = np.abs(got.float().numpy() - np.asarray(ref, np.float32))
    return float(d.max()), float(d.mean()), float(np.abs(np.asarray(ref, np.float32)).max())


def _map_case(nh, shift):
    Q = 1 if shift == 0 else 4
    x, cq, params = _inputs(nh, Q)
    jp, bias, mc = _jax_args(nh, shift, params)
    sel = np.ones((64, 1), np.float32) if Q == 1 else jquadrant_selector(8, shift)
    ref = jfused_map(
        jnp.asarray(x), jnp.asarray(cq), sel, jp[0], jp[1], jp[2], bias, jp[4], jp[5],
        *jp[6:], num_heads=nh, window_size=8, mask_components=mc, interpret=True, shift=shift,
    )
    return x, cq, params, ref


@pytest.mark.parametrize("nh", [6, 4])
@pytest.mark.parametrize("shift", [0, 4])
def test_nstb_map_bf16_plain_matches_pallas_interpret(nh, shift):
    x, cq, params, ref = _map_case(nh, shift)
    got = cuda_nstb.fused_nstb_map(
        _torch(x), _torch(cq), *[_torch(p) for p in params], nh, 8, shift=shift)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    err, mean, scale = _errors(got, ref)
    assert err <= MAX_TOL * scale, (err, MAX_TOL * scale)
    assert mean <= MEAN_TOL, mean


@pytest.mark.parametrize("nh", [6, 4])
@pytest.mark.parametrize("shift", [0, 4])
def test_nstb_tokens_bf16_plain_matches_pallas_interpret(nh, shift):
    """The token form on the windows of the rolled map, Q = 4 (at shift 0
    every token reads slot 0)."""
    x, cq, params = _inputs(nh, 4)
    jp, bias, mc = _jax_args(nh, shift, params)
    wins, _ = window_partition(cyclic_shift(_torch(x), shift), 8)
    wins = wins.reshape(-1, 64, 64)
    ref = jfused(
        jnp.asarray(wins.float().numpy(), jnp.bfloat16), jnp.asarray(cq),
        jquadrant_selector(8, shift), jp[0], jp[1], jp[2], bias, jp[4], jp[5], *jp[6:],
        num_heads=nh, mask_components=mc, interpret=True,
    )
    got = cuda_nstb.fused_nstb(
        wins, _torch(cq), *[_torch(p) for p in params], nh, 8, shift=shift, grid=(2, 3))
    assert got.dtype == torch.bfloat16 and got.shape == wins.shape
    err, mean, scale = _errors(got, ref)
    assert err <= MAX_TOL * scale, (err, MAX_TOL * scale)
    assert mean <= MEAN_TOL, mean


def test_float32_plain_on_bf16_inputs_misses_the_mean_bound():
    """The float32 plain version, on the same bf16 inputs and matrices,
    rounds only its output: its mean distance to the JAX kernel is far
    above the bound the rounding-matched version meets."""
    nh, shift = 6, 4
    x, cq, params, ref = _map_case(nh, shift)
    f32 = cuda_nstb.fused_nstb_map(
        _torch(x).float(), _torch(cq).float(),
        *[_torch(p).float() if i in MATS else _torch(p) for i, p in enumerate(params[:7])],
        *[(_torch(p[0]).float(), _torch(p[1])) for p in params[7:9]], _torch(params[9]),
        nh, 8, shift=shift,
    )
    assert f32.dtype == torch.float32
    _, mean, _ = _errors(f32.to(torch.bfloat16), ref)
    assert mean > 10 * MEAN_TOL, mean
