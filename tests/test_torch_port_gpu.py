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


def ngram_inputs(rng, nh, B, wh, ww, C=32, D=64, hd=None):
    A = (hd or C // nh) * nh
    return _t(rng, B, wh, ww, C), [
        _t(rng, C, 3 * A, scale=0.2), _t(rng, 3 * A, scale=0.1), _t(rng, nh, 1, 1),
        _t(rng, 9, nh, scale=0.5), _t(rng, A, C, scale=0.2), _t(rng, C, scale=0.1),
        _t(rng, 2 * C, D, scale=0.2), _t(rng, D, scale=0.1),
    ]


def nstb_inputs(rng, nh, B, ph, pw, Q, D=64, H=128, hd=None, ws=8):
    A = (hd or D // nh) * nh
    nwin = B * (ph // ws) * (pw // ws)
    ln = lambda: (1 + _t(rng, D, scale=0.1), _t(rng, D, scale=0.1))  # noqa: E731
    return _t(rng, B, ph, pw, D), _t(rng, nwin, Q, D, scale=0.5), [
        _t(rng, D, 3 * A, scale=0.15), _t(rng, 3 * A, scale=0.1), _t(rng, nh, 1, 1),
        _t(rng, (2 * ws - 1) ** 2, nh, scale=0.5), _t(rng, A, D, scale=0.15),
        _t(rng, D, scale=0.1),
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


# other widths (C, D, heads x head_dim): the demo width's stages (C 16, D 32,
# 2 x 8), the envelope's top (C 64, D 128, 4 x 16), a head_dim of 5 at C 20,
# eight heads at C 64
NGRAM_WIDTHS = [(16, 32, 2, 8), (64, 128, 4, 16), (20, 40, 4, 5), (64, 128, 8, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,B,wh,ww,C,D,hd", [
    (6, 2, 8, 12, 32, 64, 5), (4, 1, 5, 37, 32, 64, 8), (6, 1, 2, 2, 32, 64, 5),
    (4, 8, 16, 16, 32, 64, 8), (4, 2, 2, 2, 32, 64, 8), (6, 3, 13, 7, 32, 64, 5),
    (4, 3, 13, 7, 32, 64, 8), (6, 8, 16, 16, 32, 64, 5), (6, 8, 64, 64, 32, 64, 5),
    # K1's tensor-core generic body at bf16 on each of its tiles (2 x 4 the
    # demo stage 1, 4 x 16), grids narrower than a tile, both reflections at
    # 2 x 2, head_dim 5 and 32, C and D not multiples of 16
    (2, 8, 8, 8, 16, 32, 8), (2, 8, 64, 64, 16, 32, 8), (2, 1, 2, 2, 16, 32, 8),
    (3, 1, 18, 2, 24, 48, 5), (4, 2, 5, 37, 40, 80, 10), (3, 3, 13, 7, 16, 32, 5),
    (2, 2, 9, 19, 64, 128, 32),
] + [(nh, B, wh, ww, C, D, hd) for C, D, nh, hd in NGRAM_WIDTHS
     for B, wh, ww in ((8, 32, 32), (3, 13, 7))])
def test_ngram_context_kernel_matches_plain(cuda, dtype, nh, B, wh, ww, C, D, hd):
    """At float32 against ``ngram_context_math``; at bfloat16 against the
    rounding-matched ``ngram_context_kernel_math`` on the same inputs; two
    runs give the same bits."""
    rng = np.random.default_rng(0)
    u, params = ngram_inputs(rng, nh, B, wh, ww, C, D, hd)
    u = u.to(cuda, dtype)
    params = _to(tuple(params), cuda)
    before = cuda_ngram.fused_ngram_context.launches
    got = cuda_ngram.fused_ngram_context(u, *params, nh)
    again = cuda_ngram.fused_ngram_context(u, *params, nh)
    torch.cuda.synchronize()
    assert cuda_ngram.fused_ngram_context.launches == before + 2
    ref = (cuda_ngram.ngram_context_math if dtype == torch.float32
           else cuda_ngram.ngram_context_kernel_math)(u, *params, num_heads=nh).float()
    assert got.dtype == dtype and got.shape == (B, wh, ww, D)
    err = float((got.float() - ref).abs().max())
    assert err <= _tol(ref, dtype), err
    assert torch.equal(got, again)


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


# other widths of the whole block (D, heads, head_dim, H, window): the demo
# width, the JAX kernel tests', window 4, the envelope's top, 3 x 10 heads;
# windows padded to 16-row fragments (7, 3, 5, 6, 2) at widths padded to 16
# columns (40, 24) and head_dim padded to 32 (24); the streamed weights at a
# hidden width that ends inside a 64-column stage (D 96, hidden 360)
NSTB_WIDTHS = [(32, 2, 16, 64, 8), (8, 2, 4, 16, 8), (32, 2, 16, 64, 4), (128, 4, 32, 512, 8),
               (32, 3, 10, 64, 8), (40, 2, 8, 80, 7), (24, 3, 8, 48, 3), (32, 2, 16, 64, 5),
               (48, 2, 24, 96, 6), (16, 2, 8, 32, 2), (96, 3, 32, 360, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,nh,hd,H,ws", NSTB_WIDTHS)
@pytest.mark.parametrize("shift,Q", [(0, 1), (0, 4), ("half", 4), ("half", 1)])
@pytest.mark.parametrize("B,wh,ww", [(2, 3, 4), (1, 3, 13)])  # the second: a ragged ww
def test_nstb_generic_bodies_match_plain(cuda, dtype, D, nh, hd, H, ws, shift, Q, B, wh, ww):
    """K2 on the map and K8 on the windows of the rolled map, on their generic
    bodies, against their plain versions (at bfloat16 the rounding-matched
    ones), masked (shift ws/2) and unmasked, Q 1 and 4, an odd windows-per-
    stripe; each one launch, and the two agree bit for bit."""
    from tmar_torch.ops.window import cyclic_shift, window_partition, window_unpartition

    shift = ws // 2 if shift == "half" else shift
    rng = np.random.default_rng(21)
    x, cq, params = nstb_inputs(rng, nh, B, wh * ws, ww * ws, Q, D, H, hd, ws)
    x, cq = x.to(cuda, dtype), cq.to(cuda, dtype)
    params = [_to(p, cuda) for p in params]
    before = (cuda_nstb.fused_nstb_map.launches, cuda_nstb.fused_nstb.launches)
    zmap = cuda_nstb.fused_nstb_map(x, cq, *params, nh, ws, shift=shift)
    wins, _ = window_partition(cyclic_shift(x, shift), ws)
    z = cuda_nstb.fused_nstb(wins.reshape(-1, ws * ws, D), cq, *params, nh, ws, shift=shift,
                             grid=(wh, ww))
    torch.cuda.synchronize()
    assert (cuda_nstb.fused_nstb_map.launches, cuda_nstb.fused_nstb.launches) == (
        before[0] + 1, before[1] + 1)
    ref = cuda_nstb.nstb_map_math(x, cq, *params, num_heads=nh, window_size=ws, shift=shift)
    assert zmap.dtype == dtype and zmap.shape == x.shape
    err = float((zmap.float() - ref.float()).abs().max())
    assert err <= _tol(ref.float(), dtype), err
    assert torch.equal(window_unpartition(z.reshape(-1, ws, ws, D), (wh, ww)), zmap)


# the whole block at chip_smoke.py's phase-20c geometries (label, B, wh, ww,
# D, heads, head_dim, hidden, window): the demo 8x256² request's stage 1, the
# JAX kernel tests' width, window 4, the envelope's top, a ragged 13 x 13 grid
WIDTH_NSTB_CASES = [
    ("demo stage1", 8, 32, 32, 32, 2, 16, 64, 8),
    ("jax tests D8", 8, 16, 16, 8, 2, 4, 16, 8),
    ("window 4", 8, 32, 32, 32, 2, 16, 64, 4),
    ("envelope top", 2, 16, 16, 128, 4, 32, 512, 8),
    ("demo ragged 13x13", 3, 13, 13, 32, 2, 16, 64, 8),
]


@pytest.mark.parametrize("label,B,wh,ww,D,nh,hd,H,ws", WIDTH_NSTB_CASES,
                         ids=[c[0] for c in WIDTH_NSTB_CASES])
@pytest.mark.parametrize("shift,Q", [(0, 1), ("half", 4)])
def test_nstb_tensor_core_generic_body_matches_plain(cuda, label, B, wh, ww, D, nh, hd, H, ws,
                                                      shift, Q):
    """At bfloat16 each of these geometries runs the tensor-core generic body
    (``envelope.nstb_body``), which K2 on the map and K8 on the windows of
    the rolled map hold to the rounding-matched plain version, unmasked with
    Q 1 and masked with Q 4; the two agree bit for bit."""
    from tmar_torch.ops import envelope
    from tmar_torch.ops.window import cyclic_shift, window_partition, window_unpartition

    assert envelope.nstb_body(ws * ws, D, nh, hd, H, torch.bfloat16) == "tensor-core generic"
    shift = ws // 2 if shift == "half" else shift
    rng = np.random.default_rng(23)
    x, cq, params = nstb_inputs(rng, nh, B, wh * ws, ww * ws, Q, D, H, hd, ws)
    x, cq = x.to(cuda, torch.bfloat16), cq.to(cuda, torch.bfloat16)
    params = [_to(p, cuda) for p in params]
    zmap = cuda_nstb.fused_nstb_map(x, cq, *params, nh, ws, shift=shift)
    wins, _ = window_partition(cyclic_shift(x, shift), ws)
    z = cuda_nstb.fused_nstb(wins.reshape(-1, ws * ws, D), cq, *params, nh, ws, shift=shift,
                             grid=(wh, ww))
    ref = cuda_nstb.nstb_map_math(x, cq, *params, num_heads=nh, window_size=ws, shift=shift)
    err = float((zmap.float() - ref.float()).abs().max())
    assert err <= _tol(ref.float(), torch.bfloat16), err
    assert torch.equal(window_unpartition(z.reshape(-1, ws, ws, D), (wh, ww)), zmap)


def test_nstb_generic_body_refuses_past_its_envelope(cuda):
    """Past the envelope, and only there, K2 and K8 refuse with the limit
    named; a head count that does not divide the attention width is a
    ValueError."""
    rng = np.random.default_rng(22)
    x, cq, params = nstb_inputs(rng, 2, 1, 8, 8, 1, D=80, H=160, hd=40)
    with pytest.raises(NotImplementedError, match="head_dim 40"):
        cuda_nstb.fused_nstb_map(x.to(cuda), cq.to(cuda), *[_to(p, cuda) for p in params], 2, 8)
    x, cq, params = nstb_inputs(rng, 8, 1, 8, 8, 1, D=256, H=1024, hd=32)
    with pytest.raises(NotImplementedError, match="bytes of shared memory"):
        cuda_nstb.fused_nstb_map(x.to(cuda), cq.to(cuda), *[_to(p, cuda) for p in params], 8, 8)
    x, cq, params = nstb_inputs(rng, 2, 1, 9, 9, 1, D=32, H=64, hd=16, ws=9)
    with pytest.raises(NotImplementedError, match="N=81"):
        cuda_nstb.fused_nstb(x.reshape(1, 81, 32).to(cuda), cq.to(cuda),
                             *[_to(p, cuda) for p in params], 2, 9)


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
@pytest.mark.parametrize("nh,B,wh,ww,C,D,hd", [
    (6, 8, 16, 16, 32, 64, 5), (4, 8, 8, 8, 32, 64, 8),  # the 8x128² train step's grids
    (4, 8, 4, 4, 32, 64, 8),
    (6, 1, 13, 7, 32, 64, 5), (4, 2, 5, 37, 32, 64, 8),  # odd grids, a ragged tile
    (6, 2, 2, 2, 32, 64, 5), (4, 1, 2, 2, 32, 64, 8),    # both reflections hit 0 and 1
    (6, 1, 2, 19, 32, 64, 5), (4, 1, 18, 2, 32, 64, 8),
    (4, 8, 16, 16, 32, 64, 8), (6, 3, 13, 7, 32, 64, 5), (4, 3, 13, 7, 32, 64, 8),
    (2, 8, 8, 8, 16, 32, 8),  # chip_smoke.py's phase-20 demo stage 1
] + [(nh, B, wh, ww, C, D, hd) for C, D, nh, hd in NGRAM_WIDTHS
     for B, wh, ww in ((8, 32, 32), (2, 2, 2), (3, 13, 7))])
def test_ngram_context_backward_kernel_matches_plain(cuda, dtype, nh, B, wh, ww, C, D, hd):
    rng = np.random.default_rng(8)
    u, params = ngram_inputs(rng, nh, B, wh, ww, C, D, hd)
    g = _t(rng, B, wh, ww, D).to(cuda, dtype)
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


def ffn_inputs(rng, M, D=64, H=128):
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
    # the n-gram composition path at n = 3 (seven windows to a tile, the last
    # ragged) and n = 1
    (37, 9, 32, 6, 5, None), (100, 9, 32, 4, 8, None), (70, 1, 32, 6, 5, None),
    # other widths: the demo width's 8x8 windows with and without the mask,
    # its n-gram windows, the JAX tests' head layouts, window 4, the
    # envelope's top
    (24, 64, 32, 2, 16, None), (24, 64, 32, 2, 16, (2, 3)), (64, 4, 16, 2, 8, None),
    (63, 9, 16, 2, 8, None), (70, 1, 16, 2, 8, None), (12, 64, 32, 3, 10, (2, 2)),
    (12, 64, 16, 2, 8, None), (36, 16, 32, 2, 16, (3, 3)), (8, 64, 128, 4, 32, (2, 2)),
    # many narrow heads: 16 x 8 at D 128, 12 x 5 at D 60
    (8, 64, 128, 16, 8, (2, 2)), (40, 9, 60, 12, 5, None),
    # the tensor-core generic bodies' padding: windows of side 6 and 7 (N 36
    # and 49: padded rows and keys), head_dim 10 at the demo width (padded
    # to 16)
    (24, 36, 32, 2, 16, (2, 3)), (24, 49, 32, 2, 16, (2, 3)), (24, 64, 32, 2, 10, None),
    # the full-width NGswin's n-gram windows at both head splits with the
    # mask on (the templated bodies at both dtypes); the short-window bodies
    # at bf16: window 4 without the mask, a ragged window count (the last
    # unit and tile part-filled) at the demo width, two 16-row fragments a
    # window (25 and 31 tokens), head_dim 16 at D 64
    (2048, 4, 32, 6, 5, (16, 16)), (512, 4, 32, 4, 8, (8, 8)), (2048, 9, 32, 6, 5, (16, 16)),
    (512, 9, 32, 4, 8, (8, 8)), (2048, 1, 32, 6, 5, (16, 16)), (512, 1, 32, 4, 8, (8, 8)),
    (2048, 16, 32, 2, 16, None), (1003, 4, 16, 2, 8, (17, 59)), (45, 25, 32, 2, 16, (3, 3)),
    (30, 31, 32, 3, 10, None), (50, 16, 64, 4, 16, (5, 5)),
])
def test_window_attention_kernels_match_plain(cuda, dtype, nwin, N, D, nh, hd, grid):
    """At float32 against autograd of the plain math; at bfloat16 against
    the rounding-matched plain forward and explicit backward on the same
    bf16 inputs."""
    rng = np.random.default_rng(4)
    (x, g), params = attention_inputs(rng, nwin, N, D, nh, hd)
    x, g = x.to(cuda, dtype), g.to(cuda, dtype)
    params = [p.to(cuda) for p in params]
    ws = int(round(N ** 0.5))  # the window's side
    mc = None if grid is None else (*shift_mask_components(ws, ws // 2), *grid)
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
        # from 32 tokens up every cotangent product takes bf16 operands
        # (``_roundings``), so the parameter cotangents are bf16 sums
        _hold(ATTN_NAMES, 1, got, ref, dtype, torch.bfloat16 if N >= 32 else torch.float32)
    for name, a, b in zip(ATTN_NAMES, got, again):
        assert torch.equal(a, b), f"{name} differs between two runs"


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("N,nh,hd", [(n * n, nh, hd) for n in (2, 3, 1) for nh, hd in ((6, 5), (4, 8))])
def test_short_window_bodies_at_the_ngram_geometries_match_plain(cuda, N, nh, hd, masked):
    """K3's and K4's short-window bodies through their own C entries
    (``tmar_window_attention_*_smma``) at the full-width NGswin's n-gram
    windows, where the templated bodies run bf16: the output and dx at the
    bf16 tolerance, the parameter cotangents at the float32 one, against
    the rounding-matched plain versions; two runs bit for bit."""
    import ctypes

    from tmar_torch import kernels
    from tmar_torch.ops.attention import LOGIT_SCALE_MAX

    ca = cuda_attention
    rng = np.random.default_rng(6)
    nwin, D, A, ws = 96, 32, nh * hd, int(round(N ** 0.5))
    (x, g), params = attention_inputs(rng, nwin, N, D, nh, hd)
    x, g = x.to(cuda, torch.bfloat16), g.to(cuda, torch.bfloat16)
    params = [p.to(cuda) for p in params]
    mc = (*shift_mask_components(ws, ws // 2), 4, 24) if masked else None
    fwd = kernels.host_function("window_attention_fwd", "tmar_window_attention_fwd_smma",
                                ca._FWD_ARGTYPES, ctypes.c_int)
    bwd = kernels.host_function("window_attention_bwd", "tmar_window_attention_bwd_smma",
                                ca._BWD_ARGTYPES, ctypes.c_int)
    floats = kernels.host_function("window_attention_bwd", "tmar_window_attention_bwd_smma_workspace",
                                   [ctypes.c_int] * 5, ctypes.c_longlong)(nwin, N, D, nh, hd)
    ops, geo = ca._kernel_operands(x, *params, nh, mc)
    p = [ca._ptr(t) for t in ops]
    stream = torch.cuda.current_stream().cuda_stream
    runs = []
    for _ in range(2):
        out, lse, dx = torch.empty_like(x), torch.empty(nwin, nh, N, device=cuda), torch.empty_like(x)
        work = torch.empty(floats, device=cuda)
        dp = torch.empty(D * 3 * A + 3 * A + nh + nh * N * N + A * D + D, device=cuda)
        kernels.check("window_attention_fwd", fwd(*p, out.data_ptr(), lse.data_ptr(),
                                                  *geo.ints(False), stream))
        kernels.check("window_attention_bwd", bwd(
            p[0], g.data_ptr(), *p[1:5], p[5], p[7], p[8], lse.data_ptr(), dx.data_ptr(),
            work.data_ptr(), dp.data_ptr(), *geo.ints(True), stream))
        dwqkv, dbqkv, dscale, dbias, dwproj, dbproj = torch.split(
            dp, [D * 3 * A, 3 * A, nh, nh * N * N, A * D, D])
        dls = dscale * ops[3] * (params[2].reshape(nh) <= LOGIT_SCALE_MAX)
        runs.append([out, dx, dwqkv.reshape(D, 3 * A), dbqkv, dls.reshape(nh, 1, 1),
                     dbias.reshape(nh, N, N), dwproj.reshape(A, D), dbproj])
    torch.cuda.synchronize()
    ref = [ca.window_attention_kernel_math(x, *params, nh, mask_components=mc),
           *ca.window_attention_backward_math(x, g, *params, nh, mask_components=mc)]
    _hold(ATTN_NAMES, 1, runs[0], ref, torch.bfloat16)
    for name, a, b in zip(ATTN_NAMES, runs[0], runs[1]):
        assert torch.equal(a, b), f"{name} differs between two runs"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D,H", [
    (1, 64, 128), (15, 64, 128), (1000, 64, 128), (131072, 64, 128),
    # other widths: the demo width (a ragged last tile), the JAX test's, the
    # envelope's top (32-row tiles in the backward)
    (1000, 32, 64), (32768, 32, 64), (77, 32, 64), (1000, 128, 512), (130, 16, 48),
    (500, 96, 384),
    # chip_smoke.py's phase-20 envelope top (K6's tensor-core generic body in
    # eight hidden slices)
    (8192, 128, 512),
    # the tensor-core generic bodies at bf16: D not a multiple of 16 (40, 24,
    # 8), hidden not a multiple of 16 (72, 40) or of K5's 64-column stage
    # (200, streamed), resident weights at D 64
    (333, 40, 72), (1000, 24, 40), (4096, 128, 200), (17, 8, 16), (65536, 64, 256),
])
def test_residual_ffn_kernels_match_plain(cuda, dtype, M, D, H):
    """At float32 against autograd of the plain math; at bfloat16 against
    the rounding-matched plain forward and explicit backward on the same
    bf16 inputs (M = 131072: the 8x128² train step's stage 1)."""
    rng = np.random.default_rng(5)
    (x, ao, g), params = ffn_inputs(rng, M, D, H)
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
    """Past the envelope, and only there, the wrappers refuse with the limit
    named: head_dim past 32, a window past 64 tokens, a tile past the card's
    shared memory."""
    rng = np.random.default_rng(7)
    (x, _), params = attention_inputs(rng, 4, 16, 80, 2, 40)
    with pytest.raises(NotImplementedError, match="head_dim 40"):
        cuda_attention.fused_window_attention(x.to(cuda), *[p.to(cuda) for p in params], 2)
    (x, _), params = attention_inputs(rng, 1, 81, 32, 2, 16)
    with pytest.raises(NotImplementedError, match="N=81"):
        cuda_attention.fused_window_attention(x.to(cuda), *[p.to(cuda) for p in params], 2)
    z = torch.zeros(8, 512, device=cuda)
    with pytest.raises(NotImplementedError, match="bytes of shared memory"):
        cuda_ffn.fused_residual_ffn(z, z, *[torch.zeros(s, device=cuda) for s in
                                            ((512,), (512,), (512, 2048), (2048,), (2048, 512),
                                             (512,), (512,), (512,))])


@pytest.mark.parametrize("D,nh,hd,N", [
    (32, 2, 16, 64), (32, 3, 10, 64), (16, 2, 8, 64), (32, 2, 16, 16), (16, 2, 8, 4),
    (16, 2, 8, 9), (16, 2, 8, 1), (64, 6, 10, 64), (64, 4, 16, 64), (128, 4, 32, 64),
    (96, 3, 5, 49), (48, 3, 10, 36),
])
def test_generic_bodies_launch_with_the_envelopes_shared_memory(cuda, D, nh, hd, N):
    """Each CUDA source's count of its generic body's shared memory equals
    ``envelope``'s, at the tile sizes the envelope picks, so a geometry it
    admits launches."""
    from tmar_torch.ops import envelope as env

    built = env.built_smem
    H = 4 * D
    _, rows, _ = env.ffn_envelope(D, H)
    assert built("ffn_fwd", D, H) == env.ffn_fwd_bytes(D, H)
    assert built("ffn_bwd", D, H, rows) == env.ffn_bwd_bytes(D, H, rows)
    hg_f, fwd, hg_b, bwd = env.attention_envelope(N, D, nh, hd)
    assert built("attention_fwd", D, nh, hd, hg_f) == fwd
    assert built("attention_bwd", N, D, hd, hg_b) == bwd
    C = D // 2
    fwd, p1, p2 = env.ngram_envelope(C, D, nh, hd)
    assert built("ngram_fwd", C, nh, hd) == fwd
    assert (built("ngram_bwd", C, D, nh, hd, 1), built("ngram_bwd", C, D, nh, hd, 2)) == (p1, p2)
    nstb = env.nstb_envelope(N, D, nh, hd, H)
    assert built("nstb_map", N, D, nh, hd, H, 2) == built("nstb_tokens", N, D, nh, hd, H, 2) == nstb
    mma = env.nstb_mma_plan(N, D, nh, hd, H)
    assert built("nstb_map", N, D, nh, hd, H, 1) == built("nstb_tokens", N, D, nh, hd, H, 1) == (
        -1 if mma is None else mma[1])
    attn = env.attention_mma_bytes(N, D, nh, hd) or (-1, -1, -1)
    assert (built("attention_fwd_mma", N, D, nh, hd), built("attention_bwd_mma", N, D, nh, hd, 1),
            built("attention_bwd_mma", N, D, nh, hd, 2)) == tuple(attn)
    for dtype in (torch.float32, torch.bfloat16):
        assert env.built_nstb_body("nstb_map", N, D, nh, hd, H, dtype) == env.built_nstb_body(
            "nstb_tokens", N, D, nh, hd, H, dtype) == env.nstb_body(N, D, nh, hd, H, dtype)


@pytest.mark.parametrize("N,D,nh,hd", [
    (64, 32, 2, 16), (64, 32, 3, 10), (64, 16, 2, 8), (64, 128, 4, 32), (36, 32, 2, 16),
    (49, 32, 2, 16), (64, 32, 2, 10), (16, 32, 2, 16), (4, 16, 2, 8), (9, 16, 2, 8),
    (1, 16, 2, 8), (64, 64, 6, 10), (64, 64, 4, 16), (4, 32, 6, 5), (64, 128, 8, 32),
    (4, 32, 4, 8), (9, 32, 6, 5), (9, 32, 4, 8), (1, 32, 6, 5), (1, 32, 4, 8), (16, 64, 4, 16),
    (25, 32, 2, 16), (31, 32, 3, 10), (31, 128, 4, 32), (4, 12, 2, 6),
])
def test_attention_body_query_equals_the_envelope_rule(cuda, N, D, nh, hd):
    """The body K3's and K4's built sources pick (``tmar_*_body``) is
    ``envelope.attention_body``'s, at both dtypes, and their short-window
    shared memory (``tmar_*_short_smem``) is ``attention_short_plan``'s."""
    from tmar_torch.ops import envelope as env

    short = env.attention_short_plan(N, D, nh, hd) if 8 <= D and D % 8 == 0 else None
    assert (env.built_smem("attention_fwd_short", N, D, nh, hd),
            env.built_smem("attention_bwd_short", N, D, nh, hd)) == (
        (-1, -1) if short is None else (short["fwd"][1], short["bwd"][1]))
    for dtype in (torch.float32, torch.bfloat16):
        want = env.attention_body(N, D, nh, hd, dtype)
        assert env.built_attention_body("window_attention_fwd", N, D, nh, hd, dtype) == want
        assert env.built_attention_body("window_attention_bwd", N, D, nh, hd, dtype) == want


@pytest.mark.parametrize("D,H", [(32, 64), (128, 512), (64, 128), (8, 16), (16, 48), (96, 384),
                                 (12, 24)])
def test_ffn_body_and_tensor_core_plan_queries_equal_the_envelope(cuda, D, H):
    """The body K6's built source picks and its tensor-core generic plan's
    shared memory (-1 without one) are ``envelope.ffn_body``'s and
    ``ffn_mma_plan``'s, at both dtypes."""
    from tmar_torch.ops import envelope as env

    for dtype in (torch.float32, torch.bfloat16):
        assert env.built_ffn_body(D, H, dtype) == env.ffn_body(D, H, dtype)
    plan = env.ffn_mma_plan(D, H)
    assert env.built_smem("ffn_bwd_mma", D, H) == (-1 if plan is None else plan[-1])


@pytest.mark.parametrize("C,D,nh,hd", [(16, 32, 2, 8), (64, 128, 4, 16), (16, 32, 3, 5),
                                       (32, 64, 6, 5), (32, 64, 4, 8), (20, 40, 4, 5),
                                       (64, 128, 8, 8), (64, 128, 8, 16)])
def test_ngram_body_and_tensor_core_plan_queries_equal_the_envelope(cuda, C, D, nh, hd):
    """The body K7's built source picks and its tensor-core generic plan's
    two passes' shared memory (-1 without one) are ``envelope.ngram_body``'s
    and ``ngram_mma_plan``'s, at both dtypes."""
    from tmar_torch.ops import envelope as env

    for dtype in (torch.float32, torch.bfloat16):
        assert env.built_ngram_body(C, D, nh, hd, dtype) == env.ngram_body(C, D, nh, hd, dtype)
    want = env.ngram_mma_plan(C, D, nh, hd) or (-1, -1)
    assert (env.built_smem("ngram_bwd_mma", C, D, nh, hd, 1),
            env.built_smem("ngram_bwd_mma", C, D, nh, hd, 2)) == tuple(want)


@pytest.mark.parametrize("D,H", [(32, 64), (128, 512), (64, 128), (8, 16), (16, 48), (96, 384),
                                 (12, 24), (40, 72), (128, 128)])
def test_ffn_forward_body_and_tensor_core_plan_queries_equal_the_envelope(cuda, D, H):
    """The body K5's built source picks is K6's and ``envelope.ffn_body``'s
    (one rule), and its tensor-core generic plan's shared memory (-1
    without one) ``ffn_mma_fwd_plan``'s, at both dtypes."""
    from tmar_torch.ops import envelope as env

    for dtype in (torch.float32, torch.bfloat16):
        want = env.ffn_body(D, H, dtype)
        assert env.built_ffn_body(D, H, dtype, lib="residual_ffn_fwd") == want
        assert env.built_ffn_body(D, H, dtype) == want
    plan = env.ffn_mma_fwd_plan(D, H)
    assert env.built_smem("ffn_fwd_mma", D, H) == (-1 if plan is None else plan[-1])


@pytest.mark.parametrize("C,D,nh,hd", [(16, 32, 2, 8), (64, 128, 4, 16), (16, 32, 3, 5),
                                       (32, 64, 6, 5), (32, 64, 4, 8), (20, 40, 4, 5),
                                       (64, 128, 8, 8), (64, 128, 8, 16)])
def test_ngram_forward_body_tile_and_plan_queries_equal_the_envelope(cuda, C, D, nh, hd):
    """The body K1's built source picks is ``envelope.ngram_body``'s with
    ``forward`` (K7's but for the templated float32 body), its tensor-core
    generic body's shared memory on each tile ``ngram_mma_fwd_bytes`` (-1
    without a plan), and the tile it takes for a grid
    ``ngram_mma_fwd_tile``'s."""
    from tmar_torch.ops import envelope as env

    for dtype in (torch.float32, torch.bfloat16):
        assert (env.built_ngram_body(C, D, nh, hd, dtype, lib="ngram_context")
                == env.ngram_body(C, D, nh, hd, dtype, forward=True))
    planned = env.ngram_mma_plan(C, D, nh, hd) is not None
    for S, TJ in env.NGRAM_FWD_TILES:
        want = env.ngram_mma_fwd_bytes(C, D, nh, hd, S, TJ) if planned else -1
        assert env.built_smem("ngram_fwd_mma", C, D, nh, hd, S, TJ) == want
    for B, wh, ww in ((8, 8, 8), (8, 32, 32), (3, 13, 7), (8, 64, 64), (1, 2, 2), (1, 18, 2)):
        for sms in (132, 114, 16):
            assert (env.built_ngram_tile(B, wh, ww, C, D, nh, hd, sms)
                    == env.ngram_mma_fwd_tile(B, wh, ww, C, D, nh, hd, sms))


@pytest.mark.parametrize("M,D,H", [(1000, 24, 40), (2049, 128, 512)])
def test_residual_ffn_tensor_core_generic_forward_reads_transposed_weight_views(cuda, M, D, H):
    """K5's tensor-core generic body, its weights resident (24, 40) and
    streamed (128, 512), given w1 and w2 as transposed views of [out, in]
    tensors: the bits of contiguous weights, within 2^-7·max|ref| of
    ``ffn_kernel_math``."""
    rng = np.random.default_rng(12)
    (x, ao, _), params = ffn_inputs(rng, M, D, H)
    x, ao = x.to(cuda, torch.bfloat16), ao.to(cuda, torch.bfloat16)
    params = [p.to(cuda) for p in params]
    views = list(params)
    views[2], views[4] = params[2].t().contiguous().t(), params[4].t().contiguous().t()
    assert views[2].stride() == (1, D) and views[4].stride() == (1, H)
    with torch.no_grad():
        got = cuda_ffn.fused_residual_ffn(x, ao, *views)
        want = cuda_ffn.fused_residual_ffn(x, ao, *params)
    ref = cuda_ffn.ffn_kernel_math(x, ao, *params).float()
    assert torch.equal(got, want)
    assert float((got.float() - ref).abs().max()) <= _tol(ref, torch.bfloat16)


# the demo width (examples/demo_end_to_end.py, tests/test_ngswin_pallas.py)
# on the shipped recipe: 8 NSTBs of embed 32 and 2 heads
DEMO_OVERRIDES = {
    "model.embed_dim": 32, "model.depths": [2, 2, 2], "model.num_heads": [2, 2, 2],
    "model.dec_dim": 32, "model.dec_depths": 2, "model.dec_num_heads": 2,
    "disc.base_channels": 16, "disc.num_scales": 2, "data.patch_size": 64,
    "data.batch_size": 8, "radon.num_angles": 24, "data.dataset": "synthetic",
}


def test_demo_width_full_step_launches_each_training_kernel_8_times(cuda, tmp_path):
    """One ``full`` step of the shipped recipe at the demo width on 8x64²
    bf16 launches each of K1, K7 and K3-K6 eight times (one forward and one
    backward kernel per NSTB), no whole-block kernel, and gives finite
    metrics."""
    from tmar_torch.data import SyntheticMARDataset
    from tmar_torch.train import Trainer, config_path, load_config, resolve_variant

    cfg = load_config(config_path("train_syndeeplesion.yaml"),
                      {**DEMO_OVERRIDES, "run_dir": str(tmp_path)})
    trainer = Trainer(resolve_variant(cfg, cfg.variant))
    ds = SyntheticMARDataset(size=64, length=8, base_seed=7)
    samples = [ds[i] for i in range(8)]
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples])[..., None]).to(cuda)
             for k in ("ct", "gt")}
    counters = [(cuda_ngram.fused_ngram_context, "launches"),
                (cuda_ngram.fused_ngram_context, "backward_launches"),
                (cuda_attention.fused_window_attention, "launches"),
                (cuda_attention.fused_window_attention, "backward_launches"),
                (cuda_ffn.fused_residual_ffn, "launches"),
                (cuda_ffn.fused_residual_ffn, "backward_launches"),
                (cuda_nstb.fused_nstb_map, "launches"), (cuda_nstb.fused_nstb, "launches")]
    before = [getattr(f, a) for f, a in counters]
    trainer.state, metrics = trainer.train_step(trainer.state, batch)
    torch.cuda.synchronize()
    assert [getattr(f, a) - b for (f, a), b in zip(counters, before)] == [8] * 6 + [0, 0]
    assert all(np.isfinite(float(v)) for v in metrics.values())


@pytest.mark.parametrize("pallas,backward,k4", [
    (False, "auto", 8), (True, "auto", 8), (True, "xla", 0), (True, "pallas", 8)])
def test_each_model_form_trains_one_step_on_the_card(cuda, tmp_path, pallas, backward, k4):
    """Every NGswin form the config can name trains on the card: one
    ``full`` step at the demo width on 8x64² bf16 launches 8 of each of K1,
    K7, K3, K5 and K6 and ``k4`` of K4 (none in the ``xla`` form, whose
    attention backward is the plain recompute), no whole-block kernel, and
    gives finite metrics."""
    from tmar_torch.data import SyntheticMARDataset
    from tmar_torch.train import Trainer, config_path, load_config, resolve_variant

    cfg = load_config(config_path("train_syndeeplesion.yaml"), {
        **DEMO_OVERRIDES, "run_dir": str(tmp_path), "model.use_pallas_attention": pallas,
        "model.attn_backward": backward})
    trainer = Trainer(resolve_variant(cfg, cfg.variant))
    ds = SyntheticMARDataset(size=64, length=8, base_seed=7)
    samples = [ds[i] for i in range(8)]
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples])[..., None]).to(cuda)
             for k in ("ct", "gt")}
    counters = [(cuda_ngram.fused_ngram_context, "launches"),
                (cuda_ngram.fused_ngram_context, "backward_launches"),
                (cuda_attention.fused_window_attention, "launches"),
                (cuda_attention.fused_window_attention, "backward_launches"),
                (cuda_ffn.fused_residual_ffn, "launches"),
                (cuda_ffn.fused_residual_ffn, "backward_launches"),
                (cuda_nstb.fused_nstb_map, "launches"), (cuda_nstb.fused_nstb, "launches")]
    before = [getattr(f, a) for f, a in counters]
    trainer.state, metrics = trainer.train_step(trainer.state, batch)
    torch.cuda.synchronize()
    assert [getattr(f, a) - b for (f, a), b in zip(counters, before)] == [8, 8, 8, k4, 8, 8, 0, 0]
    assert all(np.isfinite(float(v)) for v in metrics.values())


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


# ---- parallelism on the one card (two gloo ranks) ------------------------------
def _rel_grad_err(got, ref):
    """The worst max|diff| / max(max|ref|, 1e-3 of the network's largest) per
    tensor: the train-step bound of chip_smoke.py (``STEP_TOL``)."""
    floor = 1e-3 * max(float(r.abs().max()) for r in ref.values())
    return max(float((got[k].cpu() - r.cpu()).abs().max()) / max(float(r.abs().max()), floor)
               for k, r in ref.items())


def test_dp_step_on_two_ranks_matches_one_process(cuda, tmp_path):
    """Phase 22's f32 dp check: one ``full`` step of the promoted recipe at
    full width, two gloo ranks on the one card taking a row each, against
    one process taking both: loss terms within 1e-4·max(1, |ref|), the
    generator's gradients within 2e-3 (the train-step bound), 20 launches
    each of K1, K7 and K3-K6 on every rank."""
    import test_torch_port_parallel_ranks as R
    from tmar_torch.parallel import spawn_ranks
    from tmar_torch.train import Trainer

    out = str(tmp_path)
    spawn_ranks(R.card_dp_step, 2, out, cuda_device=0, threads=None)
    trainer = Trainer(R.card_config(out, "one", 2))
    _, m = trainer.train_step(trainer.state, R.card_batch(2))
    ref = {k: p.grad for k, p in trainer.generator.named_parameters()}
    for r in range(2):
        got = torch.load(tmp_path / f"dp_rank{r}.pt", weights_only=False)
        assert got["launches"] == [20] * 6
        for k, v in m.items():
            assert abs(got["metrics"][k] - float(v)) <= 1e-4 * max(1.0, abs(float(v))), k
        assert _rel_grad_err(got["grads"], ref) <= 2e-3


def test_fsdp2_parameter_views_reach_each_training_kernel(cuda, tmp_path):
    """Under FSDP2 the kernels read the gathered views of the parameters
    (K3-K6; the n-gram context's K1/K7 stay replicated): two ranks of the
    demo-width NGswin, forward and backward on their rows, against one
    process on all rows: outputs within 1e-4, gradients within 2e-3 of the
    network's scale, each training kernel launched once a block (8 blocks)."""
    import test_torch_port_parallel_ranks as R
    from tmar_torch import NGswin
    from tmar_torch.parallel import spawn_ranks

    spawn_ranks(R.card_fsdp_views, 2, str(tmp_path), cuda_device=0, threads=None)
    torch.manual_seed(0)
    model = NGswin(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 2, 2), dec_dim=32, dec_depths=2,
                   dec_num_heads=2, attn_backward="pallas")
    y = model(R.card_batch(4, 64)["ct"])
    y.square().mean().backward()
    got = [torch.load(tmp_path / f"fsdp_rank{r}.pt", weights_only=False) for r in range(2)]
    assert all(g["launches"] == [8] * 6 for g in got)
    assert float((torch.cat([g["y"] for g in got]) - y.detach().cpu()).abs().max()) <= 1e-4
    ref = {k: p.grad for k, p in model.named_parameters()}
    assert all(_rel_grad_err(g["grads"], ref) <= 2e-3 for g in got)


def test_kernel_wrappers_copy_misaligned_parameter_views(cuda):
    """A parameter that starts off a 16-byte boundary (a view into a gathered
    buffer) gives the bits of an aligned one through K1, K3 and K5."""
    rng = np.random.default_rng(22)

    def misaligned(p):
        buf = torch.empty(p.numel() + 1, device=cuda)
        view = buf[1:].view(p.shape).copy_(p)
        assert view.data_ptr() % 16
        return view

    (x, _), params = attention_inputs(rng, 64, 64, 64, 6, 10)
    x, params = x.to(cuda), [p.to(cuda) for p in params]
    f = cuda_attention.fused_window_attention
    with torch.no_grad():
        assert torch.equal(f(x, *params, 6), f(x, *[misaligned(p) for p in params], 6))
    (x, ao, _), params = ffn_inputs(rng, 1000)
    x, ao, params = x.to(cuda), ao.to(cuda), [p.to(cuda) for p in params]
    with torch.no_grad():
        assert torch.equal(cuda_ffn.fused_residual_ffn(x, ao, *params),
                           cuda_ffn.fused_residual_ffn(x, ao, *[misaligned(p) for p in params]))
    u, params = ngram_inputs(rng, 6, 2, 8, 8)
    u, params = u.to(cuda), [p.to(cuda) for p in params]
    with torch.no_grad():
        assert torch.equal(cuda_ngram.fused_ngram_context(u, *params, 6),
                           cuda_ngram.fused_ngram_context(u, *[misaligned(p) for p in params], 6))


# ---- the kernels' operators and the exported program --------------------------
OPERATORS = ("ngram_context", "nstb_map", "nstb_tokens", "window_attention_fwd", "residual_ffn_fwd")


def _operator_call(name, cuda, dtype):
    """(the operator, its arguments) at the demo width (embed 32, 2 heads of
    16, hidden 64, 8x8 windows; the n-gram context at C 16, D 32, 2 heads of
    8), laid out by its wrapper's ``_layout`` as the wrapper calls it."""
    rng = np.random.default_rng(23)
    if name == "ngram_context":
        u, params = ngram_inputs(rng, 2, 2, 8, 8, C=16, D=32)
        ops = cuda_ngram._layout(u.to(cuda, dtype), *_to(tuple(params), cuda), 2)
        return cuda_ngram.NGRAM_CONTEXT, (*ops, 2)
    if name in ("nstb_map", "nstb_tokens"):
        x, cq, params = nstb_inputs(rng, 2, 2, 16, 16, 4, D=32, H=64)
        x, cq, params = x.to(cuda, dtype), cq.to(cuda, dtype), _to(tuple(params), cuda)
        if name == "nstb_map":
            return cuda_nstb.NSTB_MAP, (*cuda_nstb._layout(x, cq, *params, 2), 2, 8, 4, 1e-5)
        x = x.reshape(-1, 64, 32)  # 8 windows of a 2 x 2 grid per image
        return cuda_nstb.NSTB_TOKENS, (*cuda_nstb._layout(x, cq, *params, 2), 2, 8, 4, 2, 2, 1e-5)
    if name == "window_attention_fwd":
        (x, _), params = attention_inputs(rng, 8, 64, 32, 2, 16)
        mask = (*shift_mask_components(8, 4), 2, 2)
        ops, grid = cuda_attention._layout(x.to(cuda, dtype), *_to(tuple(params), cuda), 2, mask)
        return cuda_attention.WINDOW_ATTENTION, (*ops, *grid, 2, "batched")
    (x, ao, _), params = ffn_inputs(rng, 1000, D=32, H=64)
    ops = cuda_ffn._layout(x.to(cuda, dtype), ao.to(cuda, dtype), *_to(tuple(params), cuda))
    return cuda_ffn.RESIDUAL_FFN, (*ops, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", OPERATORS)
def test_kernel_operator_passes_opcheck_and_its_fake_matches(cuda, name, dtype):
    """``torch.library.opcheck`` (schema, fake tensor, AOT dispatch) on each
    kernel's operator, inputs that need no gradient as in serving; and the
    fake implementation's outputs have the real outputs' shapes, dtypes,
    strides and device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args = _operator_call(name, cuda, dtype)
    torch.library.opcheck(op, args)
    real = op(*args)
    mode = FakeTensorMode()
    fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
    with mode:
        fake = op(*fake_args)
    for r, f in zip(*(o if isinstance(o, tuple) else (o,) for o in (real, fake))):
        assert (r.shape, r.dtype, r.stride(), r.device) == (f.shape, f.dtype, f.stride(), f.device)


def test_demo_width_generator_exported_on_the_card_equals_eager(cuda, tmp_path):
    """The demo-width NGswin (embed 32, depths 2/2/2 + 2, 2 heads) in bf16,
    exported on the card and loaded back: bit for bit the eager forward, 8
    launches of K1 and of K2 per call (one of each per NSTB), each an
    operator of the program."""
    from tmar_torch import NGswin
    from tmar_torch.export import export_generator, load_artifact, save_artifact

    model = NGswin(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 2, 2), dec_dim=32,
                   dec_depths=2, dec_num_heads=2, dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(24).uniform(-1, 1, (2, 128, 128, 1))
                         .astype(np.float32)).to(cuda)
    path = str(tmp_path / "demo.pt2")
    save_artifact(path, export_generator(model, batch=2, size=128))
    program = torch.export.load(path)
    targets = [str(n.target) for n in program.graph.nodes]
    assert targets.count("tmar.ngram_context.default") == 8
    assert targets.count("tmar.nstb_map.default") == 8
    fn = load_artifact(path)
    with torch.no_grad():
        ref = model(x)
    counters = (cuda_ngram.fused_ngram_context, cuda_nstb.fused_nstb_map)
    before = [f.launches for f in counters]
    got = fn(x)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [8, 8]
    assert got.dtype == torch.float32 and torch.equal(got, ref)
    with pytest.raises(Exception, match="Guard failed"):
        fn(x[:1])
