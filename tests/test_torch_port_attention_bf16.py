"""The port's window-attention plain versions at bfloat16 against the JAX
kernels run in Pallas interpret mode at bfloat16, forward and all seven
cotangents, on the same seeded numpy inputs.

The JAX side is ``tmar.ops.pallas_attention.fused_window_attention(...,
interpret=True, backward="pallas")`` under ``jax.vjp``: at N = 64 its
``_attn_kernel_batched`` and ``_attn_bwd_kernel_batched`` with ``cot_bf16``
(the default for bf16 inputs), at N = 4 ``_attn_kernel`` and
``_attn_bwd_kernel``.  The port's side is
``cuda_attention.window_attention_kernel_math`` and
``window_attention_backward_math``, which round where those kernels round
(and where K3's and K4's bfloat16 bodies round on the card).  The two then
differ by summation order, the norm's form (rsqrt(|q|² + 1e-24) against
1 / (|q| + 1e-12)) and the bf16 roundings that such differences flip.

Tolerance: the output and dx within max 2^-7·max|ref| and mean 5e-5; each
parameter cotangent within 2^-7·max|ref| of its own tensor.  The float32
plain version on the same bf16 inputs misses the mean bound on the output
(the rounding is applied); at float32 the explicit backward equals autograd
of ``window_attention_math`` (1e-5·max(1, max|ref|)).

x, the output cotangent g and the two matrices are bf16 values; the biases,
the logit scale and the gathered relative-position bias are float32 (the
JAX kernel reads them so).  Both sides get float32 parameters holding those
values, so neither rounds a parameter cotangent on output."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.ops.pallas_attention import fused_window_attention as jfused
from tmar.ops.window import shift_mask_components
from tmar_torch.ops import cuda_attention
from tmar_torch.ops.attention import window_attention_math
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

MAX_TOL = 2.0**-7  # x max|ref|
MEAN_TOL = 5e-5
NAMES = ["out", "dx", "dwqkv", "dbqkv", "dlogit_scale", "dbias", "dwproj", "dbproj"]
# (N, D, heads, head_dim, mask): the full-width NGswin's two 64-token head
# layouts on a 2x2 window grid (its last row, last column and corner all
# masked), and the 4-token n-gram windows of its 6-head stages; then the
# demo NGswin's (embed 32, 2 heads): its 64-token windows, masked, and its
# 4-token n-gram windows on 16 channels
CASES = [(64, 64, 6, 10, False), (64, 64, 6, 10, True), (64, 64, 4, 16, False),
         (64, 64, 4, 16, True), (4, 32, 6, 5, False),
         (64, 32, 2, 16, True), (4, 16, 2, 8, False)]


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _case(N, D, nh, hd, mask, seed=0):
    """Inputs (numpy float32, x, g and the matrices bf16-valued), the mask
    components, and the JAX kernels' output and cotangents as numpy."""
    rng = np.random.default_rng(seed)
    A = nh * hd
    B_ = 8 if N == 64 else 64

    def n(*s, sc=1.0):
        return (rng.standard_normal(s) * sc).astype(np.float32)

    x, g = _bf16(n(B_, N, D)), _bf16(n(B_, N, D))
    params = [_bf16(n(D, 3 * A, sc=0.15)), n(3 * A, sc=0.1),
              rng.uniform(0.5, 2.3, (nh, 1, 1)).astype(np.float32), n(nh, N, N, sc=0.2),
              _bf16(n(A, D, sc=0.15)), n(D, sc=0.1)]
    mc = (*shift_mask_components(8, 4), 2, 2) if mask else None

    def f(xx, *ps):  # the forward in one grid step (its tiling, not its numerics)
        return jfused(xx, *ps, nh, mask_components=mc, interpret=True, backward="pallas",
                      windows_per_step=B_)

    jx = jnp.asarray(x, jnp.bfloat16)
    out, vjp = jax.vjp(f, jx, *[jnp.asarray(p) for p in params])
    cots = vjp(jnp.asarray(g, jnp.bfloat16))
    ref = [np.asarray(t.astype(jnp.float32)) for t in (out, *cots)]
    return x, g, params, mc, ref


def _port(x, g, params, mc, nh, dtype=torch.bfloat16):
    xt = torch.from_numpy(x).to(dtype)
    ps = [torch.from_numpy(p) for p in params]
    out = cuda_attention.window_attention_kernel_math(xt, *ps, nh, mask_components=mc)
    cots = cuda_attention.window_attention_backward_math(
        xt, torch.from_numpy(g).to(dtype), *ps, nh, mask_components=mc)
    return [out, *cots]


def _errors(got, ref):
    d = np.abs(got.float().numpy() - ref)
    return float(d.max()), float(d.mean()), float(np.abs(ref).max())


@pytest.mark.parametrize("N,D,nh,hd,mask", CASES)
def test_attention_bf16_plain_matches_pallas_interpret(N, D, nh, hd, mask):
    x, g, params, mc, ref = _case(N, D, nh, hd, mask)
    got = _port(x, g, params, mc, nh)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.bfloat16
    for i, (name, a, b) in enumerate(zip(NAMES, got, ref)):
        assert a.shape == b.shape, name
        err, mean, scale = _errors(a, b)
        assert err <= MAX_TOL * scale, (name, err, MAX_TOL * scale)
        if i < 2:
            assert mean <= MEAN_TOL, (name, mean)


def test_attention_bf16_autograd_path_is_the_plain_pair():
    """A bf16 CPU tensor through ``fused_window_attention`` under autograd
    gives the two plain versions' results, in the arguments' dtypes."""
    N, D, nh, hd, mask = CASES[1]
    x, g, params, mc, _ = _case(N, D, nh, hd, mask)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    ps = [torch.from_numpy(p).requires_grad_() for p in params]
    out = cuda_attention.fused_window_attention(xt, *ps, nh, mask_components=mc)
    cots = torch.autograd.grad(out, [xt, *ps], torch.from_numpy(g).to(torch.bfloat16))
    want = _port(x, g, params, mc, nh)
    assert out.dtype == torch.bfloat16 and cots[0].dtype == torch.bfloat16
    for name, a, b in zip(NAMES, [out, *cots], want):
        assert torch.equal(a, b), name


def test_float32_plain_on_bf16_inputs_misses_the_mean_bound():
    """At N = 64 the float32 plain version on the same bf16 inputs and
    matrices rounds only its output: its mean distance to the JAX kernel is
    far above the bound the rounding-matched version meets."""
    N, D, nh, hd, mask = CASES[1]
    x, g, params, mc, ref = _case(N, D, nh, hd, mask)
    f32 = window_attention_math(
        torch.from_numpy(x), *[torch.from_numpy(p) for p in params], nh, mask_components=mc)
    _, mean, _ = _errors(f32.to(torch.bfloat16), ref[0])
    assert mean > 10 * MEAN_TOL, mean


@pytest.mark.parametrize("N,D,nh,hd,mask", [CASES[1], CASES[4]])
def test_float32_explicit_backward_is_autograd_of_the_math(N, D, nh, hd, mask):
    x, g, params, mc, _ = _case(N, D, nh, hd, mask)
    leaves = [torch.from_numpy(x).requires_grad_()] + [
        torch.from_numpy(p).requires_grad_() for p in params]
    out = window_attention_math(*leaves, nh, mask_components=mc)
    ref = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    got = _port(x, g, params, mc, nh, dtype=torch.float32)
    assert torch.equal(got[0], out.detach())
    for name, a, b in zip(NAMES[1:], got[1:], ref):
        assert a.dtype == torch.float32, name
        err = float((a - b).abs().max())
        assert err <= 1e-5 * max(1.0, float(b.abs().max())), (name, err)
