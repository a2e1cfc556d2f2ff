"""Every width the JAX NGswin takes up to D = 512, on the CPU.

On the card K5/K6 and K1/K7 size their tiles by width (rows a tile, cells
a block) and take any head_dim, and K2/K8 and K3/K4 send what their
CUDA-core generic tiles do not fit to the long-window bodies
(``tmar_torch.ops.envelope``).  Here:

* (a) the envelope admits the whole region (D a multiple of 8 up to 512 and
  180, hidden 2·D and 4·D, head_dim 8 to 128 with A <= 2·D, windows of 1 to
  256 tokens, the n-gram context at C = D/2 with heads of up to 128
  channels) and names the bytes past it;
* (b) the body of every earlier geometry stays, and each geometry refused
  before this rule gets the body named here;
* (c) the plain versions the kernels are held to on the card against the
  Pallas kernels in interpret mode, forward and VJP, at float32, at the
  tolerances of the existing parity files: K5/K6 at (256, 1024) (atol 2e-4,
  rtol 2e-3, tests/test_torch_port_ffn.py), K1/K7 at C = 128 with 8 x 16 and
  2 x 64 heads (atol = rtol = 5e-5, tests/test_torch_port_ngram_bwd.py),
  K2 on the map and K8 on the windows at D = 256, 8 x 32, hidden 1024
  (atol = rtol = 2e-5, tests/test_torch_port_nstb.py), K3/K4 at D = 256
  with 8 x 32 and 2 x 128 heads (out atol 2e-4; cotangents atol 5e-4 +
  rtol 5e-3 of the tensor's largest, tests/test_torch_port_long_windows.py);
* (d) the wide NGswin (D 256, heads 8 / 2 / 8 + 8, mlp_ratio 4) at depths
  1/1/1 + 1 on a 1x64² input: the flax model's weights carried over by
  ``from_flax_params``, the port's plain forward against the flax model's
  (atol 5e-5, rtol 1e-4, the long-window file's model tolerance).

The kernels themselves run on the card only (tests/test_torch_port_gpu.py,
chip_smoke.py phase 26)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.nn import NGswin as FlaxNGswin
from tmar.ops.attention import gather_rel_pos_bias, relative_position_index
from tmar.ops.pallas_attention import fused_window_attention as jattention
from tmar.ops.pallas_ffn import fused_residual_ffn as jffn
from tmar.ops.pallas_ngram import fused_ngram_context as jngram
from tmar.ops.pallas_nstb import fused_nstb as jfused_tokens
from tmar.ops.pallas_nstb import fused_nstb_map as jfused_map
from tmar.ops.window import shift_mask_components
from tmar_torch import NGswin, from_flax_params
from tmar_torch.ops import cuda_attention, cuda_ffn, cuda_ngram, cuda_nstb, envelope
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

F32, BF16 = torch.float32, torch.bfloat16
LIMIT = envelope.H100_SMEM_PER_BLOCK


def _normal(rng, *shape, sc=1.0):
    return (rng.standard_normal(shape) * sc).astype(np.float32)


# ---- (a) the region ---------------------------------------------------------------

def _heads(D, hd, limit):
    """Head counts at head_dim hd with A = nh·hd <= limit: one head, the
    most, and A = D and D/2 where they fall on whole heads."""
    most = limit // hd
    return sorted({n for n in (1, 2, most, D // hd, D // (2 * hd)) if 1 <= n <= most})


@pytest.mark.parametrize("D", [*range(8, 513, 8), 180])
def test_the_region_is_admitted(D):
    """Window attention and the whole block at every window of 1 to 16x16
    tokens and heads of 8 to 128 channels (A <= 2·D), the FFN at hidden 2·D
    and 4·D, the n-gram context at C = D/2 with heads of up to 128 channels
    (A <= C): each admitted, on a body that fits a block."""
    for H in (2 * D, 4 * D):
        fwd, rows, bwd = envelope.ffn_envelope(D, H)
        assert max(fwd, bwd) <= LIMIT and envelope.ffn_tiles(D, H)[1::2] == (H, H)
    for hd in (8, 16, 30, 32, 64, 128):
        for nh in _heads(D, hd, 2 * D):
            for N in (1, 4, 9, 16, 64, 81, 256):
                _, fwd, _, bwd = envelope.attention_envelope(N, D, nh, hd)
                assert max(fwd, bwd) <= LIMIT
                for H in (2 * D, 4 * D):
                    for dtype in (F32, BF16):
                        assert envelope.nstb_envelope(N, D, nh, hd, H, dtype=dtype) <= LIMIT
        C = D // 2
        for nh in _heads(C, hd, C) if hd <= C else ():
            assert max(envelope.ngram_envelope(C, D, nh, hd)) <= LIMIT


def test_past_the_region_the_bytes_are_named():
    """A 64x64 window, a 16,384-wide model and a 4,096-channel n-gram grid
    fit no block at one head, row or cell a tile: each refusal names the
    kernel, the geometry and the bytes against the card's."""
    past = "needs \\d+ bytes of shared memory, past the card's 232448"
    with pytest.raises(NotImplementedError, match=r"window attention \(K3/K4\): the long-window "
                                                  r"body at N=4096, D=512.*" + past):
        envelope.attention_envelope(4096, 512, 16, 32)
    with pytest.raises(NotImplementedError, match=r"whole NSTB \(K2/K8\).*N=4096.*" + past):
        envelope.nstb_envelope(4096, 512, 16, 32, 2048)
    with pytest.raises(NotImplementedError, match=r"residual FFN \(K5/K6\): the backward at "
                                                  r"D=16384, hidden=65536, 1 rows.*" + past):
        envelope.ffn_envelope(16384, 65536)
    with pytest.raises(NotImplementedError, match=r"n-gram context \(K1/K7\).*C=4096.*" + past):
        envelope.ngram_envelope(4096, 8192, 32, 128)


# ---- (b) the bodies ----------------------------------------------------------------

# (N, D, heads, head_dim, hidden) -> K2/K8's body at (bf16, f32) and K3/K4's:
# the flagship, the demo width, the envelope's top at 128, window 16, head_dim
# 64 and a short window keep today's; the refused widths move to the
# long-window bodies
BODIES = {
    (64, 64, 6, 10, 128): (("flagship", "flagship"), ("flagship", "templated")),
    (64, 32, 2, 16, 64): (("tensor-core generic", "CUDA-core generic"),
                          ("tensor-core generic", "CUDA-core generic")),
    (64, 128, 4, 32, 512): (("tensor-core generic", "CUDA-core generic"),
                            ("tensor-core generic", "CUDA-core generic")),
    (256, 64, 6, 10, 128): (("tensor-core long-window", "long-window"),
                            ("tensor-core long-window", "long-window")),
    (64, 64, 6, 64, 128): (("tensor-core long-window", "long-window"),
                           ("tensor-core long-window", "long-window")),
    (16, 32, 2, 16, 64): (("tensor-core generic", "CUDA-core generic"),
                          ("tensor-core short-window", "CUDA-core generic")),
    (64, 256, 8, 32, 1024): (("long-window", "long-window"), ("long-window", "long-window")),
    (64, 512, 16, 32, 2048): (("long-window", "long-window"), ("long-window", "long-window")),
    (64, 256, 2, 128, 1024): (("long-window", "long-window"), ("long-window", "long-window")),
    (64, 384, 12, 32, 1536): (("long-window", "long-window"), ("long-window", "long-window")),
    (64, 180, 6, 30, 720): (("long-window", "long-window"), ("CUDA-core generic",) * 2),
    (64, 232, 8, 29, 464): (("long-window", "long-window"), ("long-window", "long-window")),
    (16, 256, 8, 32, 1024): (("long-window", "long-window"), ("long-window", "long-window")),
}


@pytest.mark.parametrize("geometry", sorted(BODIES))
def test_the_body_rule_keeps_today_s_bodies_and_moves_the_refused(geometry):
    N, D, nh, hd, H = geometry
    (nb, nf), (ab, af) = BODIES[geometry]
    assert (envelope.nstb_body(*geometry, BF16), envelope.nstb_body(*geometry, F32)) == (nb, nf)
    assert (envelope.attention_body(N, D, nh, hd, BF16),
            envelope.attention_body(N, D, nh, hd, F32)) == (ab, af)
    generic_fits = envelope.nstb_bytes(*geometry) <= LIMIT
    # a move happens only where the CUDA-core generic tile fits no block
    assert (nf == "long-window") == (envelope.long_window(N, hd) or not generic_fits)
    assert (af == "long-window") == (envelope.long_window(N, hd) or not
                                     envelope.attention_generic_fits(N, D, nh, hd))


# (D, hidden) -> K5's rows a tile and hidden columns a chunk, K6's: 64 and
# today's rows up to the envelope's top, fewer from D = 180 on, the hidden
# layer in chunks only where one row of it fits no block
FFN_TILES = {(32, 64): (64, 64, 64, 64), (64, 128): (64, 128, 64, 128),
             (128, 512): (64, 512, 32, 512), (180, 720): (32, 720, 16, 720),
             (256, 1024): (32, 1024, 16, 1024), (512, 2048): (16, 2048, 8, 2048),
             (64, 65536): (1, 32768, 1, 16384)}
# (C, D, heads, head_dim) -> (K1's cells a block, K7's cells and positions a tile)
NGRAM_TILES = {(32, 64, 6, 5): (32, 16, 32), (16, 32, 2, 8): (32, 16, 32),
               (64, 128, 4, 16): (32, 16, 32), (128, 256, 8, 16): (16, 16, 32),
               (128, 256, 2, 64): (16, 16, 32), (256, 512, 16, 16): (8, 8, 32),
               (256, 512, 2, 128): (8, 8, 32), (96, 192, 2, 48): (32, 16, 32)}


@pytest.mark.parametrize("widths", sorted(FFN_TILES))
def test_ffn_rows_are_sized_by_width(widths):
    k5, c5, k6, c6 = FFN_TILES[widths]
    assert envelope.ffn_tiles(*widths) == (k5, c5, k6, c6)
    fwd, rows, bwd = envelope.ffn_envelope(*widths)
    assert rows == k6 and fwd == envelope.ffn_fwd_bytes(*widths, k5, c5) <= LIMIT
    assert bwd == envelope.ffn_bwd_bytes(*widths, k6, c6) <= LIMIT
    if k5 < 64:
        assert envelope.ffn_fwd_bytes(*widths, 2 * k5) > LIMIT
    if c5 < widths[1]:
        assert envelope.ffn_fwd_bytes(*widths, 1) > LIMIT >= envelope.ffn_fwd_bytes(*widths, 1, c5)
        assert envelope.ffn_fwd_bytes(*widths, 1, 2 * c5) > LIMIT
    # (f32, bf16) bodies: the flagship's, and hidden 65,536 (its bias alone
    # fills the tensor-core plans' shared memory); else bf16 up to D = 128 on
    # the tensor cores
    want = {(64, 128): ("templated", "flagship"),
            (64, 65536): ("CUDA-core generic", "CUDA-core generic")}.get(widths)
    for dtype in (F32, BF16):
        body = envelope.ffn_body(*widths, dtype)
        assert body == (want[dtype == BF16] if want else "tensor-core generic"
                        if dtype == BF16 and widths[0] <= 128 else "CUDA-core generic")


@pytest.mark.parametrize("geometry", sorted(NGRAM_TILES))
def test_ngram_tiles_are_sized_by_width(geometry):
    tiles = envelope.ngram_tiles(*geometry)
    assert tiles == NGRAM_TILES[geometry]
    C, D, nh, hd = geometry
    fwd, p1, p2 = envelope.ngram_envelope(*geometry)
    assert fwd == envelope.ngram_fwd_bytes(C, nh, hd, tiles[0])
    assert (p1, p2) == envelope.ngram_bwd_bytes(C, D, nh, hd, *tiles[1:])
    if hd > 32:
        assert envelope.ngram_body(*geometry, BF16) == "CUDA-core generic"


# ---- (c) the plain versions against the Pallas kernels -------------------------------

def _vjp(f, args, g):
    """One jit of f's output and its VJP at g, as numpy."""
    def both(gg, *a):
        out, vjp = jax.vjp(f, *a)
        return (out, *vjp(gg))

    return [np.asarray(t) for t in jax.jit(both)(jnp.asarray(g), *[jnp.asarray(a) for a in args])]


def _torch_vjp(f, args, g):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = f(*leaves)
    return [out.detach().numpy()] + [t.numpy() for t in torch.autograd.grad(
        out, leaves, torch.from_numpy(g))]


def test_residual_ffn_at_d256_matches_pallas():
    rng = np.random.default_rng(256)
    D, H, M = 256, 1024, 40
    args = [_normal(rng, M, D), _normal(rng, M, D), 1 + _normal(rng, D, sc=0.1),
            _normal(rng, D, sc=0.1), _normal(rng, D, H, sc=0.05), _normal(rng, H, sc=0.1),
            _normal(rng, H, D, sc=0.05), _normal(rng, D, sc=0.1), 1 + _normal(rng, D, sc=0.1),
            _normal(rng, D, sc=0.1)]
    g = _normal(rng, M, D)
    ref = _vjp(lambda *a: jffn(*a, block_rows=128, interpret=True, backward="pallas"), args, g)
    got = _torch_vjp(cuda_ffn.fused_residual_ffn, args, g)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-3, err_msg=str(i))


@pytest.mark.parametrize("nh,hd", [(8, 16), (2, 64)])
def test_ngram_context_at_c128_matches_pallas(nh, hd):
    """The n-gram context at C = 128, D = 256 on a 3x4 grid, output and
    every cotangent (the JAX bias cotangent folded into the [9, nh] table by
    the transpose of the gather)."""
    rng = np.random.default_rng(128 + hd)
    C, D, A = 128, 256, nh * hd
    u, g = _normal(rng, 2, 3, 4, C), _normal(rng, 2, 3, 4, D)
    params = [_normal(rng, C, 3 * A, sc=0.1), _normal(rng, 3 * A, sc=0.1), _normal(rng, nh, 1, 1),
              _normal(rng, 9, nh, sc=0.02), _normal(rng, A, C, sc=0.1), _normal(rng, C, sc=0.1),
              _normal(rng, 2 * C, D, sc=0.1), _normal(rng, D, sc=0.1)]
    index = relative_position_index(2, 2)

    def f(uu, wqkv, bqkv, ls, table, *rest):
        bias = gather_rel_pos_bias(table, index, nh)
        return jngram(uu, wqkv, bqkv, ls, bias, *rest, nh, interpret=True, backward="pallas")

    ref = _vjp(f, [u, *params], g)
    got = _torch_vjp(lambda *a: cuda_ngram.fused_ngram_context(*a, num_heads=nh), [u, *params], g)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=5e-5, err_msg=str(i))


@functools.lru_cache(maxsize=None)
def _nstb_case():
    """A 1 x 16 x 24 map (a 2x3 grid of 8x8 windows) at D 256, 8 x 32 heads,
    hidden 1024, shift 4 with the four context quadrants."""
    rng = np.random.default_rng(1024)
    D, nh, H, ws = 256, 8, 1024, 8
    A = nh * 32
    x = _normal(rng, 1, 16, 24, D)
    cq = _normal(rng, 6, 4, D, sc=0.5)
    params = [_normal(rng, D, 3 * A, sc=0.05), _normal(rng, 3 * A, sc=0.1),
              _normal(rng, nh, 1, 1), _normal(rng, (2 * ws - 1) ** 2, nh, sc=0.5),
              _normal(rng, A, D, sc=0.05), _normal(rng, D, sc=0.1),
              (1 + _normal(rng, D, sc=0.1), _normal(rng, D, sc=0.1)),
              (_normal(rng, D, H, sc=0.05), _normal(rng, H, sc=0.1)),
              (_normal(rng, H, D, sc=0.05), _normal(rng, D, sc=0.1)),
              (1 + _normal(rng, D, sc=0.1), _normal(rng, D, sc=0.1))]
    return nh, ws, x, cq, params


def _each(f, p):
    return tuple(f(q) for q in p) if isinstance(p, tuple) else f(p)


@pytest.mark.parametrize("form", ["map", "tokens"])
def test_whole_block_at_d256_matches_pallas(form):
    from tmar.ops.pallas_nstb import quadrant_selector
    from tmar.ops.window import cyclic_shift, window_partition

    nh, ws, x, cq, params = _nstb_case()
    shift, D = ws // 2, x.shape[-1]
    assert envelope.nstb_body(ws * ws, D, nh, 32, 1024, torch.float32) == "long-window"
    jp = [_each(jnp.asarray, p) for p in params]
    bias = gather_rel_pos_bias(jp[3], relative_position_index(ws, ws), nh)
    sel = quadrant_selector(ws, shift)
    mc = (*shift_mask_components(ws, shift), 2, 3)
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
        wins = np.array(wins).reshape(-1, ws * ws, D)
        ref = jax.jit(lambda xx, cc, w: jfused_tokens(
            xx, cc, sel, w[0], w[1], w[2], bias, w[4], w[5], *w[6:], num_heads=nh,
            mask_components=mc, windows_per_step=6, interpret=True))(
            jnp.asarray(wins), jnp.asarray(cq), jp)
        got = cuda_nstb.fused_nstb(torch.from_numpy(wins), torch.from_numpy(cq), *tp, nh, ws,
                                   shift=shift, grid=(2, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("nh,hd", [(8, 32), (2, 128)])
def test_window_attention_at_d256_matches_pallas(nh, hd):
    """Four 8x8 windows on a 2x2 grid, the shift mask on: the output and all
    seven cotangents."""
    rng = np.random.default_rng(hd)
    D, N, A = 256, 64, nh * hd
    x, g = _normal(rng, 4, N, D), _normal(rng, 4, N, D)
    params = [_normal(rng, D, 3 * A, sc=0.05), _normal(rng, 3 * A, sc=0.1),
              rng.uniform(0.5, 2.3, (nh, 1, 1)).astype(np.float32), _normal(rng, nh, N, N, sc=0.2),
              _normal(rng, A, D, sc=0.05), _normal(rng, D, sc=0.1)]
    mc = (*shift_mask_components(8, 4), 2, 2)
    assert envelope.attention_body(N, D, nh, hd, torch.float32) == "long-window"
    ref = _vjp(lambda *a: jattention(*a, nh, mask_components=mc, interpret=True,
                                     backward="pallas", windows_per_step=4), [x, *params], g)
    got = _torch_vjp(lambda *a: cuda_attention.fused_window_attention(
        *a, nh, mask_components=mc), [x, *params], g)
    np.testing.assert_allclose(got[0], ref[0], atol=2e-4, rtol=0, err_msg="out")
    for i, (a, b) in enumerate(zip(got[1:], ref[1:])):
        assert a.shape == b.shape, i
        assert float(np.abs(a - b).max()) <= 5e-4 + 5e-3 * float(np.abs(b).max()), i


# ---- (d) the wide NGswin ----------------------------------------------------------

WIDE = dict(ngrams=(2, 2, 2, 2), embed_dim=256, dec_dim=256, depths=(1, 1, 1), dec_depths=1,
            num_heads=(8, 2, 8), dec_num_heads=8, mlp_ratio=4.0, window_size=8)


def test_wide_ngswin_matches_flax():
    """The flax model's own initialisation, carried into the port by
    ``from_flax_params``; the port's plain forward against the flax model's
    on the same 1x64² input."""
    x = np.random.default_rng(64).uniform(-1, 1, (1, 64, 64, 1)).astype(np.float32)
    flax_model = FlaxNGswin(**WIDE)
    params = jax.jit(flax_model.init)(jax.random.PRNGKey(23), jnp.asarray(x))["params"]
    model = NGswin(**WIDE, device="cpu")
    model.load_state_dict(from_flax_params(params))
    apply = jax.jit(flax_model.apply).lower({"params": params}, jnp.asarray(x)).compile(
        {"xla_llvm_disable_expensive_passes": True})  # the same arithmetic, a shorter compile
    ref = np.asarray(apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)
