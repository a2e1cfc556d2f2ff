"""On-card tests of the port's CUDA kernels against their plain versions.

Marked ``gpu``; each test asks the ``cuda`` fixture for a card and skips
without one.  Run on a CUDA host (no JAX needed there):

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

Tolerances: at float32 (TF32 off) the kernel and the plain version differ
only in summation order and libm rounding, so max |err| <= 1e-4·max(1, max|ref|).
At bfloat16 the kernel computes in float32 and rounds once on output, so it
is held against the plain version run in float32 on the same bf16-rounded
inputs and weights: max |err| <= 2^-7·max|ref| (twice the bf16 half-ulp).
"""

import numpy as np
import pytest
import torch

from tmar_torch.ops import cuda_ngram, cuda_nstb

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def ngram_inputs(rng, nh, B, wh, ww):
    C, D = 32, 64
    A = (C // nh) * nh
    return _t(rng, B, wh, ww, C), [
        _t(rng, C, 3 * A, scale=0.2), _t(rng, 3 * A, scale=0.1), _t(rng, nh, 1, 1),
        _t(rng, 9, nh, scale=0.5), _t(rng, A, C, scale=0.2), _t(rng, C, scale=0.1),
        _t(rng, 2 * C, D, scale=0.2), _t(rng, D, scale=0.1),
    ]


def nstb_inputs(rng, nh, B, ph, pw, Q):
    D, H = 64, 128
    A = (D // nh) * nh
    nwin = B * (ph // 8) * (pw // 8)
    ln = lambda: (1 + _t(rng, D, scale=0.1), _t(rng, D, scale=0.1))  # noqa: E731
    return _t(rng, B, ph, pw, D), _t(rng, nwin, Q, D, scale=0.5), [
        _t(rng, D, 3 * A, scale=0.15), _t(rng, 3 * A, scale=0.1), _t(rng, nh, 1, 1),
        _t(rng, 225, nh, scale=0.5), _t(rng, A, D, scale=0.15), _t(rng, D, scale=0.1),
        ln(), (_t(rng, D, H, scale=0.15), _t(rng, H, scale=0.1)),
        (_t(rng, H, D, scale=0.1), _t(rng, D, scale=0.1)), ln(),
    ]


def _to(obj, dev, dtype=None):
    if isinstance(obj, tuple):
        return tuple(_to(o, dev, dtype) for o in obj)
    return obj.to(dev) if dtype is None else obj.to(dev, dtype)


def _tol(ref, dtype):
    scale = float(ref.abs().max())
    return 1e-4 * max(1.0, scale) if dtype == torch.float32 else 2.0**-7 * scale


# nstb params that the kernel reads in the I/O dtype (the matrices); the
# others stay float32 in both versions
_NSTB_MATS = {0, 4}


def _round_mats(params, dtype):
    out = []
    for i, p in enumerate(params):
        if i in _NSTB_MATS:
            p = p.to(dtype).float()
        elif i in (7, 8):
            p = (p[0].to(dtype).float(), p[1])
        out.append(p)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,B,wh,ww", [(6, 2, 8, 12), (4, 1, 5, 37), (6, 1, 2, 2), (4, 8, 16, 16)])
def test_ngram_context_kernel_matches_plain(cuda, dtype, nh, B, wh, ww):
    rng = np.random.default_rng(0)
    u, params = ngram_inputs(rng, nh, B, wh, ww)
    u = u.to(cuda, dtype)
    params = _to(tuple(params), cuda)
    before = cuda_ngram.fused_ngram_context.launches
    got = cuda_ngram.fused_ngram_context(u, *params, nh)
    torch.cuda.synchronize()
    assert cuda_ngram.fused_ngram_context.launches == before + 1
    ref = cuda_ngram.ngram_context_math(u.float(), *params, num_heads=nh)
    assert got.dtype == dtype and got.shape == (B, wh, ww, 64)
    err = float((got.float() - ref).abs().max())
    assert err <= _tol(ref, dtype), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh", [6, 4])
@pytest.mark.parametrize("shift,Q", [(0, 1), (4, 4)])
def test_nstb_map_kernel_matches_plain(cuda, dtype, nh, shift, Q):
    rng = np.random.default_rng(1)
    x, cq, params = nstb_inputs(rng, nh, 2, 48, 72, Q)
    x, cq = x.to(cuda, dtype), cq.to(cuda, dtype)
    params = [_to(p, cuda) for p in params]
    before = cuda_nstb.fused_nstb_map.launches
    got = cuda_nstb.fused_nstb_map(x, cq, *params, nh, 8, shift=shift)
    torch.cuda.synchronize()
    assert cuda_nstb.fused_nstb_map.launches == before + 1
    ref = cuda_nstb.nstb_map_math(
        x.float(), cq.float(), *_round_mats(params, dtype), num_heads=nh,
        window_size=8, shift=shift,
    )
    assert got.dtype == dtype and got.shape == x.shape
    err = float((got.float() - ref).abs().max())
    assert err <= _tol(ref, dtype), err


def test_nstb_map_kernel_finite_at_saturated_logit_scale(cuda):
    rng = np.random.default_rng(2)
    x, cq, params = nstb_inputs(rng, 4, 1, 16, 16, 4)
    params[2] = torch.full((4, 1, 1), 10.0)  # exp(clip(10, ln 100)) = 100
    params = [_to(p, cuda) for p in params]
    got = cuda_nstb.fused_nstb_map(x.to(cuda), cq.to(cuda), *params, 4, 8, shift=4)
    ref = cuda_nstb.nstb_map_math(x.to(cuda), cq.to(cuda), *params, num_heads=4,
                                  window_size=8, shift=4)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= _tol(ref, torch.float32)


def test_ngram_kernel_rejects_grid_below_2x2(cuda):
    rng = np.random.default_rng(3)
    u, params = ngram_inputs(rng, 6, 1, 1, 4)
    with pytest.raises(NotImplementedError, match="_attn_kernel"):
        cuda_ngram.fused_ngram_context(u.to(cuda), *_to(tuple(params), cuda), 6)
