"""The port's residual-FFN plain versions at bfloat16 against the JAX
kernels run in Pallas interpret mode at bfloat16, forward and all ten
cotangents, on the same seeded numpy inputs.

The JAX side is ``tmar.ops.pallas_ffn.fused_residual_ffn(...,
interpret=True, backward="pallas")`` under ``jax.vjp`` (``_ffn_kernel`` and
``_ffn_bwd_kernel``), fed as ``tmar/nn/blocks.py:148-155`` feeds it: x,
attn_out, w1 and w2 cast to bf16, the output cotangent bf16, the biases and
LayerNorm parameters float32.  The port's side is
``cuda_ffn.ffn_kernel_math`` and ``ffn_backward_math`` on the float32
weights, which round where those kernels round (and where K5's and K6's
bfloat16 bodies round on the card), and compute the GELU and its
derivative with the kernels' rational erf (``_erf_approx``, which
``ffn.erf_as_kernels`` and ``csrc/gelu.cuh`` also compute).  M = 1000 is ragged against the JAX kernel's 128-row tiles and the CUDA
kernels' 64-row tiles.

Tolerance: every tensor within max 2^-7·max|ref| of its own tensor; the
output, dx and dattn_out within mean 5e-5; each parameter cotangent within
mean 2e-5·max|ref|.  The float32 plain version on the same bf16 inputs
misses the mean bounds (the rounding is applied); at float32 the plain
pair is ``ffn_math`` and its autograd but for the erf (1e-5·max(1,
max|ref|))."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.ops.pallas_ffn import fused_residual_ffn as jfused
from tmar_torch.ops import cuda_ffn
from tmar_torch.ops.ffn import ffn_math
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

MAX_TOL = 2.0**-7  # x max|ref|
MEAN_TOL = 5e-5    # out, dx, dattn_out
PARAM_MEAN_TOL = 2e-5  # x max|ref|, each parameter cotangent
NAMES = ["out", "dx", "dattn_out", "dg1", "db1", "dw1", "dbw1", "dw2", "dbw2", "dg2", "db2"]
BF16_ARGS = (0, 1, 4, 6)  # x, attn_out, w1, w2: the arguments the block casts


def _as_written(f, *args):
    """f(*args) under ``jax.jit``, compiled with XLA's excess precision off.
    With it on (XLA's default) the CPU compiler may keep float32 between
    fused operations where the interpreted kernel rounds to bf16, at some
    shapes only (the n-gram context at two heads): off, every rounding the
    kernel writes happens, as it does on the TPU."""
    return jax.jit(f).lower(*args).compile({"xla_allow_excess_precision": False})(*args)


@functools.lru_cache(maxsize=None)
def _case(M, D=64, H=128, seed=0):
    """Inputs (numpy float32), the output cotangent, and the JAX kernels'
    output and cotangents as float32 numpy."""
    rng = np.random.default_rng(seed)

    def n(*s):
        return rng.normal(size=s).astype(np.float32)

    args = [n(M, D), n(M, D), 1 + 0.1 * n(D), 0.1 * n(D), 0.1 * n(D, H), 0.1 * n(H),
            0.1 * n(H, D), 0.1 * n(D), 1 + 0.1 * n(D), 0.1 * n(D)]
    g = n(M, D)
    jargs = [jnp.asarray(a, jnp.bfloat16) if i in BF16_ARGS else jnp.asarray(a)
             for i, a in enumerate(args)]

    def fwd_bwd(gg, *a):
        out, vjp = jax.vjp(
            lambda *b: jfused(*b, block_rows=128, interpret=True, backward="pallas"), *a)
        return out, vjp(gg)

    out, cots = _as_written(fwd_bwd, jnp.asarray(g, jnp.bfloat16), *jargs)
    ref = [np.asarray(t.astype(jnp.float32)) for t in (out, *cots)]
    return args, g, ref


def _torch_args(args, dtype=torch.bfloat16):
    return [torch.from_numpy(a).to(dtype) if i < 2 else torch.from_numpy(a)
            for i, a in enumerate(args)]


def _port(args, g, dtype=torch.bfloat16):
    ta = _torch_args(args, dtype)
    out = cuda_ffn.ffn_kernel_math(*ta)
    cots = cuda_ffn.ffn_backward_math(*ta, torch.from_numpy(g).to(dtype))
    return [out, *cots]


def _errors(got, ref):
    d = np.abs(got.detach().float().numpy() - ref)
    return float(d.max()), float(d.mean()), float(np.abs(ref).max())


@pytest.mark.parametrize("M,D,H", [
    pytest.param(1000, 64, 128, id="1000"), pytest.param(64, 64, 128, id="64"),
    # the demo NGswin's width (embed 32, mlp_ratio 2), a ragged last tile
    pytest.param(1000, 32, 64, id="1000-32-64"),
    # the envelope's top (D 128, hidden 512), a ragged last tile
    pytest.param(200, 128, 512, id="200-128-512"),
])
def test_ffn_bf16_plain_matches_pallas_interpret(M, D, H):
    args, g, ref = _case(M, D, H)
    got = _port(args, g)
    assert all(t.dtype == torch.bfloat16 for t in got[:3])
    assert all(t.dtype == torch.float32 for t in got[3:])
    for i, (name, a, b) in enumerate(zip(NAMES, got, ref)):
        assert a.shape == b.shape, name
        err, mean, scale = _errors(a, b)
        assert err <= MAX_TOL * scale, (name, err, MAX_TOL * scale)
        if i < 3:
            assert mean <= MEAN_TOL, (name, mean)
        else:
            assert mean <= PARAM_MEAN_TOL * scale, (name, mean, PARAM_MEAN_TOL * scale)


def test_ffn_bf16_autograd_path_is_the_plain_pair():
    """A bf16 CPU tensor through ``fused_residual_ffn`` under autograd gives
    the two plain versions' results, in the arguments' dtypes."""
    args, g, _ = _case(64)
    leaves = [t.requires_grad_() for t in _torch_args(args)]
    out = cuda_ffn.fused_residual_ffn(*leaves)
    cots = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(torch.bfloat16))
    want = _port(args, g)
    assert out.dtype == torch.bfloat16 and cots[0].dtype == torch.bfloat16
    for name, a, b in zip(NAMES, [out, *cots], want):
        assert torch.equal(a, b), name


def test_float32_plain_on_bf16_inputs_misses_the_mean_bounds():
    """The float32 plain version on the same bf16 inputs rounds only its
    output: its mean distance to the JAX kernels is far above the bounds the
    rounding-matched versions meet, on the output, on dx and on dw1."""
    args, g, ref = _case(1000)
    leaves = [t.float().requires_grad_() for t in _torch_args(args)]
    out = ffn_math(*leaves)
    cots = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(torch.bfloat16).float())
    _, mean, _ = _errors(out.to(torch.bfloat16), ref[0])
    assert mean > 10 * MEAN_TOL, mean
    _, mean, _ = _errors(cots[0].to(torch.bfloat16), ref[1])
    assert mean > 10 * MEAN_TOL, mean
    _, mean, scale = _errors(cots[4], ref[5])
    assert mean > 10 * PARAM_MEAN_TOL * scale, (mean, scale)


def test_float32_plain_pair_is_ffn_math_and_its_autograd():
    """At float32 the plain pair is ``ffn_math`` and its autograd with the
    kernels' erf in the GELU (|err| < 1.5e-7): the output within
    1e-5·max(1, max|ref|) of ``ffn_math``, and the explicit backward within
    that of autograd of ``ffn_math`` and of ``ffn_kernel_math``."""
    args, g, _ = _case(64)
    leaves = [t.requires_grad_() for t in _torch_args(args, torch.float32)]
    got = _port(args, g, dtype=torch.float32)
    for plain in (ffn_math, cuda_ffn.ffn_kernel_math):
        out = plain(*leaves)
        ref = torch.autograd.grad(out, leaves, torch.from_numpy(g))
        for name, a, b in zip(NAMES, got, [out.detach(), *ref]):
            assert a.dtype == torch.float32, name
            err = float((a - b).abs().max())
            assert err <= 1e-5 * max(1.0, float(b.abs().max())), (plain.__name__, name, err)
    assert torch.equal(got[0], cuda_ffn.ffn_kernel_math(*leaves).detach())
