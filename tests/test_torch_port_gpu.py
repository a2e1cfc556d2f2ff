"""On-card tests of the port's CUDA kernels against their plain versions.

Marked ``gpu``; each test asks the ``cuda`` fixture for a card and skips
without one.  Run on a CUDA host (no JAX needed there):

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

Tolerances: at float32 (TF32 off) the kernel and the plain version differ
only in summation order and libm rounding, so max |err| <= 1e-4·max(1, max|ref|).
At bfloat16 the tolerance is max |err| <= 2^-7·max|ref| (twice the bf16
half-ulp), against a reference that depends on the kernel.  Every
kernel's bfloat16 body rounds to bf16 where the JAX kernel does (on the
tensor cores; K3/K4 at N = 64): the n-gram context K1 and K7, the
whole-block kernels K2 and K8, the window-attention kernels K3 and K4 and
the residual-FFN kernels K5 and K6.  So each is held against its plain
version at bfloat16, which rounds at the same points.
The training kernels keep their parameters and parameter cotangents in
float32 at either activation dtype, so those cotangents are held to the
float32 tolerance, but for K4's bf16 body at N = 64, K6's and K7's bf16
bodies, whose cotangent products take bf16 operands as the JAX kernels' do
(K6's dw1 and dw2 and K7's dwqkv, dbqkv, dwproj, dbproj and dwmerge are
bf16 values, as JAX returns them): their parameter cotangents are held to
2^-7·max|ref| of each tensor.
"""

import numpy as np
import pytest
import torch

from tmar_torch.ops import cuda_attention, cuda_ffn, cuda_ngram, cuda_nstb
from tmar_torch.ops.attention import window_attention_math
from tmar_torch.ops.ffn import ffn_math
from tmar_torch.ops.window import shift_mask_components

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,B,wh,ww", [
    (6, 2, 8, 12), (4, 1, 5, 37), (6, 1, 2, 2), (4, 8, 16, 16),
    (4, 2, 2, 2), (6, 3, 13, 7), (4, 3, 13, 7), (6, 8, 16, 16), (6, 8, 64, 64),
])
def test_ngram_context_kernel_matches_plain(cuda, dtype, nh, B, wh, ww):
    """At float32 against ``ngram_context_math``; at bfloat16 against the
    rounding-matched ``ngram_context_kernel_math`` on the same inputs."""
    rng = np.random.default_rng(0)
    u, params = ngram_inputs(rng, nh, B, wh, ww)
    u = u.to(cuda, dtype)
    params = _to(tuple(params), cuda)
    before = cuda_ngram.fused_ngram_context.launches
    got = cuda_ngram.fused_ngram_context(u, *params, nh)
    torch.cuda.synchronize()
    assert cuda_ngram.fused_ngram_context.launches == before + 1
    ref = (cuda_ngram.ngram_context_math if dtype == torch.float32
           else cuda_ngram.ngram_context_kernel_math)(u, *params, num_heads=nh).float()
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
    ref = cuda_nstb.nstb_map_math(x, cq, *params, num_heads=nh, window_size=8, shift=shift)
    assert got.dtype == dtype and got.shape == x.shape
    err = float((got.float() - ref.float()).abs().max())
    assert err <= _tol(ref.float(), dtype), err


def test_nstb_map_kernel_finite_at_saturated_logit_scale(cuda):
    _saturated_map(cuda, torch.float32)


def test_nstb_map_kernel_bf16_finite_at_saturated_logit_scale(cuda):
    _saturated_map(cuda, torch.bfloat16)


def _saturated_map(cuda, dtype):
    rng = np.random.default_rng(2)
    x, cq, params = nstb_inputs(rng, 4, 1, 16, 16, 4)
    params[2] = torch.full((4, 1, 1), 10.0)  # exp(clip(10, ln 100)) = 100
    params = [_to(p, cuda) for p in params]
    x, cq = x.to(cuda, dtype), cq.to(cuda, dtype)
    got = cuda_nstb.fused_nstb_map(x, cq, *params, 4, 8, shift=4)
    ref = cuda_nstb.nstb_map_math(x, cq, *params, num_heads=4, window_size=8, shift=4)
    assert torch.isfinite(got).all()
    assert float((got.float() - ref.float()).abs().max()) <= _tol(ref.float(), dtype)


NGRAM_NAMES = ["out", "du", "dwqkv", "dbqkv", "dlogit_scale", "dtable", "dwproj", "dbproj",
               "dwmerge", "dbmerge"]


def _ngram_kernel_and_plain(u, g, params, nh):
    """(forward and cotangents through the kernels, twice; the plain
    version's: at bfloat16 the rounding-matched pair)."""
    f = cuda_ngram.fused_ngram_context
    present = [p for p in params if p is not None]

    def run():
        leaves = [u.clone().requires_grad_()] + [
            None if p is None else p.clone().requires_grad_() for p in params]
        out = f(*leaves, nh)
        grads = iter(torch.autograd.grad(out, [t for t in leaves if t is not None], g))
        return [out.detach()] + [None if t is None else next(grads) for t in leaves]

    got, again = run(), run()
    if u.dtype == torch.bfloat16:
        ref = [cuda_ngram.ngram_context_kernel_math(u, *params, num_heads=nh)] + list(
            cuda_ngram.ngram_context_kernel_backward_math(u, g, *params, num_heads=nh))
    else:
        ref = [cuda_ngram.ngram_context_math(u, *params, num_heads=nh)] + list(
            cuda_ngram.ngram_context_backward_math(u, g, *params, num_heads=nh))
    assert len(present) + 2 == sum(t is not None for t in got)
    return got, again, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,B,wh,ww", [
    (6, 8, 16, 16), (4, 8, 8, 8), (4, 8, 4, 4),   # the 8x128² train step's grids
    (6, 1, 13, 7), (4, 2, 5, 37),                 # odd grids, a ragged tile
    (6, 2, 2, 2), (4, 1, 2, 2),                   # both reflections hit index 0 and 1
    (6, 1, 2, 19), (4, 1, 18, 2),
    (4, 8, 16, 16), (6, 3, 13, 7), (4, 3, 13, 7),
])
def test_ngram_context_backward_kernel_matches_plain(cuda, dtype, nh, B, wh, ww):
    rng = np.random.default_rng(8)
    u, params = ngram_inputs(rng, nh, B, wh, ww)
    g = _t(rng, B, wh, ww, 64).to(cuda, dtype)
    u = u.to(cuda, dtype)
    params = [p.to(cuda) for p in params]
    f = cuda_ngram.fused_ngram_context
    before = (f.launches, f.backward_launches)
    got, again, ref = _ngram_kernel_and_plain(u, g, params, nh)
    torch.cuda.synchronize()
    assert (f.launches, f.backward_launches) == (before[0] + 2, before[1] + 2)
    assert got[1].dtype == dtype and got[2].dtype == torch.float32
    _hold(NGRAM_NAMES, 1, got, ref, dtype, param_dtype=dtype)
    for name, a, b in zip(NGRAM_NAMES, got, again):
        assert torch.equal(a, b), f"{name} differs between two runs"


def test_ngram_context_backward_kernel_without_biases_and_saturated_scale(cuda):
    """Absent bqkv / bproj get no cotangent; a logit scale above ln 100 gets a
    zero one."""
    rng = np.random.default_rng(9)
    u, params = ngram_inputs(rng, 4, 2, 6, 5)
    params[1] = params[5] = None
    params[2] = torch.tensor([10.0, 1.0, 10.0, 2.0]).reshape(4, 1, 1)
    g = _t(rng, 2, 6, 5, 64).to(cuda)
    params = [None if p is None else p.to(cuda) for p in params]
    got, _, ref = _ngram_kernel_and_plain(u.to(cuda), g, params, 4)
    assert got[3] is None and got[7] is None and ref[3] is None and ref[7] is None
    assert got[4].flatten()[0] == 0 and got[4].flatten()[2] == 0 and got[4].flatten()[1] != 0
    keep = [i for i, t in enumerate(got) if t is not None]
    _hold([NGRAM_NAMES[i] for i in keep], 1, [got[i] for i in keep], [ref[i] for i in keep],
          torch.float32)


def test_ngram_context_backward_kernel_zero_head_is_nan_as_autograd(cuda):
    """A position whose q and k are zero (u = 0 without a qkv bias): the norm
    backward is 0 / 0 in the kernel as in autograd through the plain version."""
    rng = np.random.default_rng(10)
    u, params = ngram_inputs(rng, 6, 1, 4, 4)
    params[1] = None
    u[0, 1, 2] = 0.0
    g = _t(rng, 1, 4, 4, 64).to(cuda)
    params = [None if p is None else p.to(cuda) for p in params]
    got, _, ref = _ngram_kernel_and_plain(u.to(cuda), g, params, 6)
    assert torch.isfinite(got[0]).all()
    assert torch.equal(torch.isnan(got[1]), torch.isnan(ref[1])) and torch.isnan(got[1]).any()


def test_ngram_kernel_rejects_grid_below_2x2(cuda):
    rng = np.random.default_rng(3)
    u, params = ngram_inputs(rng, 6, 1, 1, 4)
    with pytest.raises(NotImplementedError, match="2x2 window grid"):
        cuda_ngram.fused_ngram_context(u.to(cuda), *_to(tuple(params), cuda), 6)


# ---- the training kernels: forward and every cotangent ----------------------
ATTN_NAMES = ["out", "dx", "dwqkv", "dbqkv", "dlogit_scale", "dbias", "dwproj", "dbproj"]
FFN_NAMES = ["out", "dx", "dattn_out", "dg1", "db1", "dw1", "dbw1", "dw2", "dbw2", "dg2", "db2"]


def attention_inputs(rng, nwin, N, D, nh, hd):
    A = nh * hd
    acts = [_t(rng, nwin, N, D), _t(rng, nwin, N, D)]  # x, output cotangent
    params = [
        _t(rng, D, 3 * A, scale=0.1), _t(rng, 3 * A, scale=0.1),
        torch.from_numpy(rng.uniform(0.5, 2.3, (nh, 1, 1)).astype(np.float32)),
        _t(rng, nh, N, N, scale=0.2), _t(rng, A, D, scale=0.1), _t(rng, D, scale=0.1),
    ]
    return acts, params


def ffn_inputs(rng, M):
    D, H = 64, 128
    acts = [_t(rng, M, D), _t(rng, M, D), _t(rng, M, D)]  # x, attn_out, output cotangent
    params = [
        1 + _t(rng, D, scale=0.1), _t(rng, D, scale=0.1), _t(rng, D, H, scale=0.1),
        _t(rng, H, scale=0.1), _t(rng, H, D, scale=0.1), _t(rng, D, scale=0.1),
        1 + _t(rng, D, scale=0.1), _t(rng, D, scale=0.1),
    ]
    return acts, params


def _forward_and_cotangents(fn, acts, params, g):
    leaves = [a.clone().requires_grad_() for a in acts] + [p.clone().requires_grad_() for p in params]
    out = fn(*leaves)
    return [out.detach()] + list(torch.autograd.grad(out, leaves, g.to(out.dtype)))


def _hold(names, n_acts, got, ref, dtype, param_dtype=torch.float32):
    """Activations and their cotangents at the I/O dtype's tolerance, the
    parameter cotangents at ``param_dtype``'s."""
    for i, (name, a, b) in enumerate(zip(names, got, ref)):
        tol = _tol(b, dtype if i <= n_acts else param_dtype)
        err = float((a.float() - b.float()).abs().max())
        assert a.shape == b.shape and err <= tol, f"{name}: {err} > {tol}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nwin,N,D,nh,hd,grid", [
    (24, 64, 64, 6, 10, None), (24, 64, 64, 6, 10, (3, 4)), (24, 64, 64, 4, 16, (2, 3)),
    (37, 4, 32, 6, 5, None), (512, 4, 32, 4, 8, None),
])
def test_window_attention_kernels_match_plain(cuda, dtype, nwin, N, D, nh, hd, grid):
    """At float32 against autograd of the plain math; at bfloat16 against
    the rounding-matched plain forward and explicit backward on the same
    bf16 inputs."""
    rng = np.random.default_rng(4)
    (x, g), params = attention_inputs(rng, nwin, N, D, nh, hd)
    x, g = x.to(cuda, dtype), g.to(cuda, dtype)
    params = [p.to(cuda) for p in params]
    mc = None if grid is None else (*shift_mask_components(8, 4), *grid)
    f = cuda_attention.fused_window_attention
    before = (f.launches, f.backward_launches)
    got = _forward_and_cotangents(lambda *a: f(*a, nh, mask_components=mc), [x], params, g)
    again = _forward_and_cotangents(lambda *a: f(*a, nh, mask_components=mc), [x], params, g)
    torch.cuda.synchronize()
    assert (f.launches, f.backward_launches) == (before[0] + 2, before[1] + 2)
    assert got[0].dtype == dtype and got[1].dtype == dtype and got[2].dtype == torch.float32
    if dtype == torch.float32:
        ref = _forward_and_cotangents(
            lambda *a: window_attention_math(*a, nh, mask_components=mc), [x], params, g)
        _hold(ATTN_NAMES, 1, got, ref, dtype)
    else:
        ref = [cuda_attention.window_attention_kernel_math(x, *params, nh, mask_components=mc),
               *cuda_attention.window_attention_backward_math(x, g, *params, nh, mask_components=mc)]
        _hold(ATTN_NAMES, 1, got, ref, dtype, torch.bfloat16 if N == 64 else torch.float32)
    for name, a, b in zip(ATTN_NAMES, got, again):
        assert torch.equal(a, b), f"{name} differs between two runs"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 15, 1000, 131072])
def test_residual_ffn_kernels_match_plain(cuda, dtype, M):
    """At float32 against autograd of the plain math; at bfloat16 against
    the rounding-matched plain forward and explicit backward on the same
    bf16 inputs (M = 131072: the 8x128² train step's stage 1)."""
    rng = np.random.default_rng(5)
    (x, ao, g), params = ffn_inputs(rng, M)
    x, ao, g = (t.to(cuda, dtype) for t in (x, ao, g))
    params = [p.to(cuda) for p in params]
    f = cuda_ffn.fused_residual_ffn
    before = (f.launches, f.backward_launches)
    got = _forward_and_cotangents(f, [x, ao], params, g)
    again = _forward_and_cotangents(f, [x, ao], params, g)
    torch.cuda.synchronize()
    assert (f.launches, f.backward_launches) == (before[0] + 2, before[1] + 2)
    assert got[0].dtype == dtype and got[3].dtype == torch.float32
    if dtype == torch.float32:
        ref = _forward_and_cotangents(ffn_math, [x, ao], params, g)
        _hold(FFN_NAMES, 2, got, ref, dtype)
    else:
        ref = [cuda_ffn.ffn_kernel_math(x, ao, *params),
               *cuda_ffn.ffn_backward_math(x, ao, *params, g)]
        _hold(FFN_NAMES, 2, got, ref, dtype, torch.bfloat16)
    for name, a, b in zip(FFN_NAMES, got, again):
        assert torch.equal(a, b), f"{name} differs between two runs"


def test_window_attention_kernels_at_saturated_logit_scale(cuda):
    """exp(clip(10, ln 100)) = 100: the softmax keeps its max subtraction,
    and the logit-scale cotangent is zero above the clip."""
    rng = np.random.default_rng(6)
    (x, g), params = attention_inputs(rng, 8, 64, 64, 4, 16)
    params[2] = torch.tensor([10.0, 1.0, 10.0, 2.0]).reshape(4, 1, 1)
    x, g = x.to(cuda), g.to(cuda)
    params = [p.to(cuda) for p in params]
    got = _forward_and_cotangents(
        lambda *a: cuda_attention.fused_window_attention(*a, 4), [x], params, g)
    ref = _forward_and_cotangents(lambda *a: window_attention_math(*a, 4), [x], params, g)
    assert all(torch.isfinite(t).all() for t in got)
    assert got[4].flatten()[0] == 0 and got[4].flatten()[2] == 0 and got[4].flatten()[1] != 0
    _hold(ATTN_NAMES, 1, got, ref, torch.float32)


def test_training_kernels_refuse_other_geometries(cuda):
    rng = np.random.default_rng(7)
    (x, _), params = attention_inputs(rng, 4, 16, 32, 2, 16)
    with pytest.raises(NotImplementedError, match="window attention kernels"):
        cuda_attention.fused_window_attention(x.to(cuda), *[p.to(cuda) for p in params], 2)
    z = torch.zeros(8, 32, device=cuda)
    with pytest.raises(NotImplementedError, match="residual FFN kernels"):
        cuda_ffn.fused_residual_ffn(z, z, *[torch.zeros(s, device=cuda) for s in
                                            ((32,), (32,), (32, 64), (64,), (64, 32), (32,), (32,), (32,))])


# ---- K8: the token-level whole NSTB ------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,B,wh,ww,shift,Q", [
    (6, 2, 4, 6, 0, 4), (6, 2, 4, 6, 4, 4), (4, 1, 3, 5, 0, 1), (4, 1, 3, 5, 4, 1),
    (4, 3, 13, 13, 4, 4),  # the 416² stage 3's odd grid, three images
])
def test_nstb_tokens_kernel_matches_plain(cuda, dtype, nh, B, wh, ww, shift, Q):
    rng = np.random.default_rng(11)
    nwin = B * wh * ww
    _, _, params = nstb_inputs(rng, nh, 1, 8, 8, Q)
    x = _t(rng, nwin, 64, 64).to(cuda, dtype)
    cq = _t(rng, nwin, Q, 64, scale=0.5).to(cuda, dtype)
    params = [_to(p, cuda) for p in params]
    before = cuda_nstb.fused_nstb.launches
    got = cuda_nstb.fused_nstb(x, cq, *params, nh, 8, shift=shift, grid=(wh, ww))
    torch.cuda.synchronize()
    assert cuda_nstb.fused_nstb.launches == before + 1
    ref = cuda_nstb.nstb_tokens_math(
        x, cq, *params, num_heads=nh, window_size=8, shift=shift, grid=(wh, ww))
    assert got.dtype == dtype and got.shape == x.shape
    err = float((got.float() - ref.float()).abs().max())
    assert err <= _tol(ref.float(), dtype), err


def test_nstb_tokens_kernel_equals_map_kernel_on_the_rolled_windows(cuda):
    """K8 on the windows of the rolled map and K2 on the map compute the same
    block; both run float32 on the CUDA cores in the same order."""
    _tokens_equal_map(cuda, torch.float32)


def test_nstb_tokens_kernel_equals_map_kernel_at_bf16(cuda):
    """The same at bfloat16: one tensor-core body, the same order."""
    _tokens_equal_map(cuda, torch.bfloat16)


def _tokens_equal_map(cuda, dtype):
    from tmar_torch.ops.window import cyclic_shift, window_partition, window_unpartition

    rng = np.random.default_rng(12)
    x, cq, params = nstb_inputs(rng, 6, 2, 32, 48, 4)
    x, cq = x.to(cuda, dtype), cq.to(cuda, dtype)
    params = [_to(p, cuda) for p in params]
    zmap = cuda_nstb.fused_nstb_map(x, cq, *params, 6, 8, shift=4)
    wins, _ = window_partition(cyclic_shift(x, 4), 8)
    z = cuda_nstb.fused_nstb(wins.reshape(-1, 64, 64), cq, *params, 6, 8, shift=4, grid=(4, 6))
    assert torch.equal(window_unpartition(z.reshape(-1, 8, 8, 64), (4, 6)), zmap)


def test_nstb_tokens_kernel_finite_at_saturated_logit_scale(cuda):
    rng = np.random.default_rng(13)
    _, _, params = nstb_inputs(rng, 4, 1, 8, 8, 4)
    params[2] = torch.full((4, 1, 1), 10.0)  # exp(clip(10, ln 100)) = 100
    params = [_to(p, cuda) for p in params]
    x, cq = _t(rng, 4, 64, 64).to(cuda), _t(rng, 4, 4, 64, scale=0.5).to(cuda)
    got = cuda_nstb.fused_nstb(x, cq, *params, 4, 8, shift=4, grid=(2, 2))
    ref = cuda_nstb.nstb_tokens_math(x, cq, *params, num_heads=4, window_size=8, shift=4,
                                     grid=(2, 2))
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= _tol(ref, torch.float32)


def test_nstb_tokens_kernel_refuses_grad_and_bad_grids(cuda):
    rng = np.random.default_rng(14)
    _, _, params = nstb_inputs(rng, 4, 1, 8, 8, 4)
    params = [_to(p, cuda) for p in params]
    x, cq = _t(rng, 6, 64, 64).to(cuda), _t(rng, 6, 4, 64).to(cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        cuda_nstb.fused_nstb(x.requires_grad_(), cq, *params, 4, 8)
    x = x.detach()
    with pytest.raises(ValueError, match="whole"):
        cuda_nstb.fused_nstb(x, cq, *params, 4, 8, shift=4, grid=(2, 2))
    with pytest.raises(ValueError, match="ctx_quads"):
        cuda_nstb.fused_nstb(x, cq[:5], *params, 4, 8)


def test_every_attention_impl_name_launches_k3(cuda):
    """Each JAX name counts one K3 launch under its own name, moves no other
    counter, and gives the same bits as every other name."""
    rng = np.random.default_rng(15)
    (x, _), params = attention_inputs(rng, 32, 64, 64, 6, 10)
    x = x.to(cuda, torch.bfloat16)
    params = [p.to(cuda) for p in params]
    mc = (*shift_mask_components(8, 4), 4, 4)
    f = cuda_attention.fused_window_attention
    outs = {}
    for name in sorted(cuda_attention.IMPLS):
        by_impl, total = dict(f.launches_by_impl), f.launches
        with torch.no_grad():
            outs[name] = f(x, *params, 6, mask_components=mc, impl=name)
        torch.cuda.synchronize()
        moved = {k: f.launches_by_impl[k] - by_impl[k] for k in by_impl}
        assert moved == {k: int(k == name) for k in by_impl} and f.launches == total + 1
    ref = cuda_attention.window_attention_kernel_math(x, *params, 6, mask_components=mc)
    for name, out in outs.items():
        assert torch.equal(out, outs["batched"]), name
        assert float((out.float() - ref).abs().max()) <= _tol(ref, torch.bfloat16)


def test_make_tiled_eval_on_the_card_matches_host_tiled_eval(cuda):
    """The 64/32 tiled eval at 416² (144 tiles, 4 phase groups) in one
    forward on the card against the host-side path through the same model,
    at float32: the same tiles through the same kernels, batched otherwise."""
    from tmar_torch import NGswin, make_inference_fn, make_tiled_eval, tiled_eval

    torch.manual_seed(0)
    model = NGswin()  # full width: the kernels' head geometry
    x = np.random.default_rng(16).uniform(-1, 1, (1, 416, 416, 1)).astype(np.float32)
    got = make_tiled_eval(model)(x)
    ref = tiled_eval(make_inference_fn(model), x, 64, 32)
    assert got.shape == x.shape and np.isfinite(got).all()
    assert float(np.abs(got - ref).max()) <= 1e-4
