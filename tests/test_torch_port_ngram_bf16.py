"""The port's n-gram context plain versions at bfloat16 against the JAX
kernels run in Pallas interpret mode at bfloat16, the output and all nine
cotangents, on the same seeded numpy inputs.

The JAX side is ``tmar.ops.pallas_ngram.fused_ngram_context(...,
interpret=True, backward="pallas")`` under ``jax.vjp``
(``_ngram_stripe_kernel`` and ``_ngram_bwd_stripe_kernel``), fed as
``tmar/nn/ngram.py:170-176`` feeds it: u, wqkv, bqkv, wproj, bproj and the
merge weight in bf16, logit_scale, the bias and the merge bias in float32,
the output cotangent bf16.  The port's side is
``cuda_ngram.ngram_context_kernel_math`` and
``ngram_context_kernel_backward_math`` on the float32 parameters, which round
where those kernels round (and where K1's and K7's bfloat16 bodies round on
the card).  The JAX bias cotangent [nh, 4, 4] is folded into the [9, nh]
table by the transpose of the gather.  Cases: 6 heads on a 2x8x8 grid with
``stripe_rows=4``, so that the JAX backward folds halo rows across stripes,
and 4 heads on a 2x3x5 grid (one stripe, odd sides).

Tolerance, each tensor against its own largest entry max|ref|:
- max <= 2^-7·max|ref| on the output, du and all eight parameter cotangents;
- mean <= 1e-5·max|ref| on the output (measured 0);
- mean <= 5e-4·max|ref| on du, dwqkv and dbqkv (measured <= 2e-4, with
  dwqkv and dbqkv rounded to bf16 as JAX returns them).  The JAX backward
  takes each stripe's halo-row cotangents through the norm and the qkv
  products before it adds them to the neighbouring stripe's, and it sums in
  another float32 order: both flip bf16 roundings of dq and dk;
- mean <= 2e-5·max|ref| on the other six (measured <= 2e-7).
The current plain version (``ngram_context_math`` and its autograd) on the
same bf16 inputs misses the output's mean bound fiftyfold, and du's max
bound on the odd grid.  At float32 the new pair equals ``ngram_context_math``
and its autograd within 1e-5·max(1, max|ref|)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.ops.attention import gather_rel_pos_bias, relative_position_index
from tmar.ops.pallas_ngram import fused_ngram_context as jfused
from tmar_torch.ops import cuda_ngram
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

MAX_TOL = 2.0**-7          # x max|ref|, every tensor
OUT_MEAN_TOL = 1e-5        # x max|ref|
QKV_MEAN_TOL = 5e-4        # x max|ref|: du, dwqkv, dbqkv
MEAN_TOL = 2e-5            # x max|ref|: the other six cotangents
NAMES = ["out", "du", "dwqkv", "dbqkv", "dlogit_scale", "dtable", "dwproj", "dbproj",
         "dwmerge", "dbmerge"]
QKV = ("du", "dwqkv", "dbqkv")
BF16_PARAMS = (0, 1, 4, 5, 6)  # wqkv, bqkv, wproj, bproj, wmerge: the ones the model casts
# (heads, B, wh, ww, stripe_rows of the JAX kernels) at the full-width
# NGswin's C = 32, D = 64
CASES = [(6, 2, 8, 8, 4), (4, 2, 3, 5, None)]
# (..., C) at other widths: the demo NGswin's (embed 32) C = 16, D = 32, 2 x 8;
# the envelope's top C = 64, D = 128, 4 x 16 on a small grid
WIDTH_CASES = [(2, 2, 8, 8, None, 16), (4, 1, 4, 5, None, 64)]


def _inputs(heads, B, wh, ww, seed, C=32):
    rng = np.random.default_rng(seed)
    D = 2 * C
    A = (C // heads) * heads

    def n(*s, sc=1.0):
        return (rng.standard_normal(s) * sc).astype(np.float32)

    u = n(B, wh, ww, C)
    params = [n(C, 3 * A, sc=0.2), n(3 * A, sc=0.1), n(heads, 1, 1), n(9, heads, sc=0.02),
              n(A, C, sc=0.2), n(C, sc=0.1), n(D, D, sc=0.2), n(D, sc=0.1)]
    return u, params, n(B, wh, ww, D)


def _as_written(f, *args):
    """f(*args) under ``jax.jit``, compiled with XLA's excess precision off.
    With it on (XLA's default) the CPU compiler may keep float32 between
    fused operations where the interpreted kernel rounds to bf16, at some
    shapes only (the n-gram context at two heads): off, every rounding the
    kernel writes happens, as it does on the TPU."""
    return jax.jit(f).lower(*args).compile({"xla_allow_excess_precision": False})(*args)


def _table_cotangent(dbias, heads):
    """d(bias) [nh, 4, 4] -> d(table) [9, nh]: the transpose of the gather."""
    index = np.asarray(relative_position_index(2, 2)).reshape(-1)
    out = np.zeros((9, heads), np.float32)
    np.add.at(out, index, np.asarray(dbias).transpose(1, 2, 0).reshape(16, heads))
    return out


@functools.lru_cache(maxsize=None)
def _case(heads, B, wh, ww, stripe, C=32, seed=7):
    """Inputs (numpy float32), the output cotangent, and the JAX kernels'
    output and nine cotangents (the table's folded) as float32 numpy."""
    u, params, g = _inputs(heads, B, wh, ww, seed, C)
    bf = jnp.bfloat16
    j = [jnp.asarray(p, bf) if i in BF16_PARAMS else jnp.asarray(p) for i, p in enumerate(params)]
    j[3] = gather_rel_pos_bias(j[3], relative_position_index(2, 2), heads)

    def fwd_bwd(uu, gg, *jj):
        out, vjp = jax.vjp(
            lambda *a: jfused(*a, heads, interpret=True, backward="pallas", stripe_rows=stripe),
            uu, *jj)
        return out, vjp(gg)

    out, cots = _as_written(fwd_bwd, jnp.asarray(u, bf), jnp.asarray(g, bf), *j)
    cots = [np.asarray(t.astype(jnp.float32)) for t in cots]
    cots[4] = _table_cotangent(cots[4], heads)
    return u, params, g, [np.asarray(out.astype(jnp.float32))] + cots


def _torch(u, params, g, dtype=torch.bfloat16):
    return (torch.from_numpy(u).to(dtype), [torch.from_numpy(p) for p in params],
            torch.from_numpy(g).to(dtype))


def _port(u, params, g, heads, dtype=torch.bfloat16):
    tu, tp, tg = _torch(u, params, g, dtype)
    out = cuda_ngram.ngram_context_kernel_math(tu, *tp, num_heads=heads)
    return [out, *cuda_ngram.ngram_context_kernel_backward_math(tu, tg, *tp, num_heads=heads)]


def _errors(got, ref):
    d = np.abs(got.detach().float().numpy().reshape(ref.shape) - ref)
    return float(d.max()), float(d.mean()), float(np.abs(ref).max())


@pytest.mark.parametrize("case", CASES + WIDTH_CASES)
def test_ngram_bf16_plain_matches_pallas_interpret(case):
    heads = case[0]
    u, params, g, ref = _case(*case)
    got = _port(u, params, g, heads)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in got[2:])
    for name, a, b in zip(NAMES, got, ref):
        assert a.numel() == b.size, name
        err, mean, scale = _errors(a, b)
        assert err <= MAX_TOL * scale, (name, err, MAX_TOL * scale)
        tol = OUT_MEAN_TOL if name == "out" else QKV_MEAN_TOL if name in QKV else MEAN_TOL
        assert mean <= tol * scale, (name, mean, tol * scale)
    # the five cotangents of the parameters the model casts are bf16 values
    for i in (2, 3, 6, 7, 8):
        assert torch.equal(got[i], got[i].to(torch.bfloat16).float()), NAMES[i]


def test_current_plain_version_misses_the_bounds():
    """``ngram_context_math`` and its autograd on the same bf16 inputs round
    only what torch's bf16 arithmetic rounds: the output's mean distance to
    the JAX kernels is over fifty times its bound in both cases, and du's
    max distance misses its bound on the odd grid."""
    for case in CASES:
        heads = case[0]
        u, params, g, ref = _case(*case)
        tu, tp, tg = _torch(u, params, g)
        out = cuda_ngram.ngram_context_math(tu, *tp, num_heads=heads)
        _, mean, scale = _errors(out, ref[0])
        assert mean > 50 * OUT_MEAN_TOL * scale, (case, mean)
    heads = CASES[1][0]
    u, params, g, ref = _case(*CASES[1])
    tu, tp, tg = _torch(u, params, g)
    du = cuda_ngram.ngram_context_backward_math(tu, tg, *tp, num_heads=heads)[0]
    err, _, scale = _errors(du, ref[1])
    assert err > MAX_TOL * scale, (err, MAX_TOL * scale)


def test_ngram_bf16_autograd_path_is_the_plain_pair():
    """A bf16 CPU tensor through ``fused_ngram_context`` under autograd gives
    the two plain versions' results: du in bf16, the parameter cotangents in
    the parameters' float32."""
    heads = CASES[1][0]
    u, params, g, _ = _case(*CASES[1])
    tu, tp, tg = _torch(u, params, g)
    leaves = [tu.requires_grad_()] + [p.requires_grad_() for p in tp]
    out = cuda_ngram.fused_ngram_context(*leaves, heads)
    cots = torch.autograd.grad(out, leaves, tg)
    want = _port(u, params, g, heads)
    assert out.dtype == torch.bfloat16 and cots[0].dtype == torch.bfloat16
    for name, a, b in zip(NAMES, [out, *cots], want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("heads,B,wh,ww", [(6, 2, 4, 5), (4, 1, 2, 3)])
def test_float32_plain_pair_is_ngram_context_math_and_its_autograd(heads, B, wh, ww):
    u, params, g = _inputs(heads, B, wh, ww, seed=3)
    got = _port(u, params, g, heads, dtype=torch.float32)
    tu, tp, tg = _torch(u, params, g, torch.float32)
    ref = [cuda_ngram.ngram_context_math(tu, *tp, num_heads=heads),
           *cuda_ngram.ngram_context_backward_math(tu, tg, *tp, num_heads=heads)]
    for name, a, b in zip(NAMES, got, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        err = float((a - b).abs().max())
        assert err <= 1e-5 * max(1.0, float(b.abs().max())), (name, err)
