"""The widths the kernels take (``tmar_torch.ops.envelope``), on the CPU:
the envelope functions are plain functions of the shapes, which the CUDA
wrappers call before they launch.

They must admit every geometry the port runs or tests (the
full-width NGswin's, the demo NGswin's of examples/demo_end_to_end.py, the
JAX package's own kernel tests', window 4, the envelope's top) and the
whole envelope (D <= 128, head_dim <= 32, hidden <= 4·D, n-gram C = D/2,
windows of 1, 4, 9, 16 and 64 tokens), and refuse past it with a
``NotImplementedError`` that names the limit."""

import itertools

import pytest
import torch

from tmar_torch.ops import envelope
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

# (N, D, heads, head_dim) of window attention (K3/K4)
ATTENTION = [
    (64, 64, 6, 10), (64, 64, 4, 16),                      # the full-width NGswin
    *[(n * n, 32, nh, hd) for n in (1, 2, 3) for nh, hd in ((6, 5), (4, 8))],
    (64, 32, 2, 16), *[(n * n, 16, 2, 8) for n in (1, 2, 3)],  # the demo width
    (64, 32, 3, 10), (64, 16, 2, 8),                       # the JAX kernel tests'
    (16, 32, 2, 16),                                       # window 4
    (64, 128, 4, 32),                                      # the envelope's top
]
FFN = [(64, 128), (32, 64), (128, 512)]                    # (D, hidden)
NGRAM = [(32, 64, 6, 5), (32, 64, 4, 8), (16, 32, 2, 8), (64, 128, 4, 16)]  # (C, D, heads, hd)
# (N, D, heads, head_dim, hidden) of the whole block (K2/K8): the demo width,
# the JAX kernel tests', window 4, the envelope's top, the full-width
# NGswin's (whose float32 and bfloat16 run their own bodies)
NSTB = [(64, 32, 2, 16, 64), (64, 8, 2, 4, 16), (16, 32, 2, 16, 64), (64, 128, 4, 32, 512),
        (64, 64, 6, 10, 128), (64, 64, 4, 16, 128)]


@pytest.mark.parametrize("N,D,nh,hd", ATTENTION)
def test_attention_envelope_admits_the_listed_geometries(N, D, nh, hd):
    hg_fwd, fwd, hg_bwd, bwd = envelope.attention_envelope(N, D, nh, hd)
    assert 1 <= hg_fwd <= nh and 1 <= hg_bwd <= nh
    assert 0 < fwd <= envelope.H100_SMEM_PER_BLOCK and 0 < bwd <= envelope.H100_SMEM_PER_BLOCK


@pytest.mark.parametrize("D,H", FFN)
def test_ffn_envelope_admits_the_listed_widths(D, H):
    fwd, rows, bwd = envelope.ffn_envelope(D, H)
    assert rows in (64, 32, 16)
    assert 0 < fwd <= envelope.H100_SMEM_PER_BLOCK and 0 < bwd <= envelope.H100_SMEM_PER_BLOCK


@pytest.mark.parametrize("C,D,nh,hd", NGRAM)
def test_ngram_envelope_admits_the_listed_widths(C, D, nh, hd):
    sizes = envelope.ngram_envelope(C, D, nh, hd)
    assert all(0 < s <= envelope.H100_SMEM_PER_BLOCK for s in sizes)


@pytest.mark.parametrize("N,D,nh,hd,H", NSTB)
def test_nstb_envelope_admits_the_listed_widths(N, D, nh, hd, H):
    nbytes = envelope.nstb_envelope(N, D, nh, hd, H)
    assert nbytes == envelope.nstb_bytes(N, D, nh, hd, H)
    assert 0 < nbytes <= envelope.H100_SMEM_PER_BLOCK


# (N, D, heads, head_dim, hidden) of chip_smoke.py's phase-20c geometries
# (WIDTH_NSTB_CASES: the demo stage 1, the JAX tests' D 8, window 4, the
# envelope's top; the ragged 13 x 13 grid is the demo width's), each with
# whether the tensor-core generic body keeps its weights resident
NSTB_TENSOR_CORE = [(64, 32, 2, 16, 64, True), (64, 8, 2, 4, 16, True), (16, 32, 2, 16, 64, True),
                    (64, 128, 4, 32, 512, False)]


@pytest.mark.parametrize("N,D,nh,hd,H,resident", NSTB_TENSOR_CORE)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_nstb_body_is_a_rule_of_geometry_and_dtype(N, D, nh, hd, H, resident, dtype):
    """bfloat16 runs the tensor-core generic body at every phase-20c
    geometry (weights streamed at the envelope's top, where they do not fit
    a block), float32 the CUDA-core one; the full-width NGswin's geometry
    its own bodies at both dtypes."""
    want = "tensor-core generic" if dtype == torch.bfloat16 else "CUDA-core generic"
    assert envelope.nstb_body(N, D, nh, hd, H, dtype) == want
    plan = envelope.nstb_mma_plan(N, D, nh, hd, H)
    assert plan == (resident, envelope.nstb_mma_bytes(N, D, nh, hd, H, resident))
    assert plan[1] <= envelope.H100_SMEM_PER_BLOCK
    for nh, hd in ((6, 10), (4, 16)):
        assert envelope.nstb_body(64, 64, nh, hd, 128, dtype) == "flagship"


def test_nstb_body_keeps_the_cuda_core_body_where_the_tensor_cores_take_no_plan():
    """Widths not a multiple of 8 (16-byte rows) or past 128, and weights
    that fit no block with head_dim or hidden not a multiple of 8, keep the
    CUDA-core generic body at bfloat16; each stays inside the envelope.
    The demo stage-1 block's byte count is the CUDA source's layout."""
    for N, D, nh, hd, H in ((64, 12, 2, 6, 24), (64, 144, 4, 32, 576), (64, 120, 4, 30, 480)):
        assert envelope.nstb_mma_plan(N, D, nh, hd, H) is None
        assert envelope.nstb_body(N, D, nh, hd, H, torch.bfloat16) == "CUDA-core generic"
        envelope.nstb_envelope(N, D, nh, hd, H)
    assert envelope.nstb_mma_bytes(64, 32, 2, 16, 64, True) == 68496
    assert envelope.nstb_mma_bytes(64, 128, 4, 32, 512, False) == 196384


# (N, D, heads, head_dim) of chip_smoke.py's phase-20a window-attention
# geometries (WIDTH_ATTN_CASES: the demo, the JAX tests' 3 x 10 and D 16,
# window 4, the envelope's top, the demo's n-gram windows), the windows of
# side 6 and 7 (padded rows and keys), head_dim 10 at the demo width, the
# full-width NGswin's, windows of 16, 25 and 31 tokens (one and two 16-row
# fragments a unit), and a width the short-window body takes no plan for
# (D not a multiple of 8), with the body each runs at bfloat16 and float32
ATTENTION_BODY_CASES = [
    ((64, 32, 2, 16), "tensor-core generic", "CUDA-core generic"),
    ((64, 32, 3, 10), "tensor-core generic", "CUDA-core generic"),
    ((64, 16, 2, 8), "tensor-core generic", "CUDA-core generic"),
    ((64, 128, 4, 32), "tensor-core generic", "CUDA-core generic"),
    ((36, 32, 2, 16), "tensor-core generic", "CUDA-core generic"),
    ((49, 32, 2, 16), "tensor-core generic", "CUDA-core generic"),
    ((64, 32, 2, 10), "tensor-core generic", "CUDA-core generic"),
    ((16, 32, 2, 16), "tensor-core short-window", "CUDA-core generic"),
    ((4, 16, 2, 8), "tensor-core short-window", "CUDA-core generic"),
    ((9, 16, 2, 8), "tensor-core short-window", "CUDA-core generic"),
    ((1, 16, 2, 8), "tensor-core short-window", "CUDA-core generic"),
    ((64, 64, 6, 10), "flagship", "templated"),
    ((64, 64, 4, 16), "flagship", "templated"),
    ((4, 32, 6, 5), "templated", "templated"),
    ((9, 32, 4, 8), "templated", "templated"),
    ((16, 64, 4, 16), "tensor-core short-window", "CUDA-core generic"),
    ((25, 32, 2, 16), "tensor-core short-window", "CUDA-core generic"),
    ((31, 32, 3, 10), "tensor-core short-window", "CUDA-core generic"),
    ((4, 12, 2, 6), "CUDA-core generic", "CUDA-core generic"),
]


@pytest.mark.parametrize("geometry,bf16,f32", ATTENTION_BODY_CASES)
def test_attention_body_is_a_rule_of_geometry_and_dtype(geometry, bf16, f32):
    """K3's and K4's body by geometry and dtype alone: bfloat16 windows of
    32 to 64 tokens run the tensor-core generic bodies (their plan's shared
    memory fits a block, the envelope's top with its weights streamed in
    K4), bfloat16 windows below 32 tokens the short-window bodies wherever
    they have a plan, every float32 geometry and the plan-less widths the
    CUDA-core one, the full-width NGswin's geometries their own bodies (its
    n-gram windows too, at both dtypes); the wrapper passes the code of the
    same name."""
    assert envelope.attention_body(*geometry, torch.bfloat16) == bf16
    assert envelope.attention_body(*geometry, torch.float32) == f32
    short = envelope.attention_short_plan(*geometry)
    # (the full-width NGswin's n-gram windows have a plan; their templated
    # bodies measured faster at bfloat16 and keep them)
    assert (short is not None) == (bf16 == "tensor-core short-window"
                                   or (geometry[0] < 32 and bf16 == "templated"))
    plan = envelope.attention_mma_plan(*geometry)
    assert (plan is not None) == (geometry[0] >= 32)
    if plan is not None:
        nbytes = envelope.attention_mma_bytes(*geometry)
        assert nbytes == (plan["fwd"][1], plan["bwd"][-1], plan["sums"][1])
        assert max(nbytes) <= envelope.H100_SMEM_PER_BLOCK
        assert nbytes[0] == envelope.attention_mma_fwd_bytes(*geometry, plan["fwd"][0])
    if bf16 != "flagship":
        envelope.attention_envelope(*geometry)  # inside the envelope


def test_attention_tensor_core_plan_counts_the_sources_layout():
    """The demo geometry's and the envelope top's plans: the byte counts of
    the CUDA source's layout, and at the top K4's per-window launch with
    two window groups, its weights streamed and its tiles single-buffered."""
    assert envelope.attention_mma_bytes(64, 32, 2, 16) == (34320, 127440, 57344)
    top = envelope.attention_mma_plan(64, 128, 4, 32)
    assert top["fwd"] == (True, 178192) and top["bwd"] == (2, False, False, 217232)
    assert top["sums"] == (True, 204800)
    for N, D, nh, hd in ((64, 12, 2, 6), (64, 144, 4, 32), (64, 128, 16, 32)):
        assert envelope.attention_mma_plan(N, D, nh, hd) is None
        assert envelope.attention_body(N, D, nh, hd, torch.bfloat16) == "CUDA-core generic"


def test_attention_short_window_plan_counts_the_sources_layout():
    """The short-window plans of the full-width NGswin's n-gram window at
    n = 2, window 4 and a 25-token window: the byte counts of the CUDA
    source's layout (``make_short_fwd`` / ``make_short_bwd``), four warps a
    block where they fit and fewer where they do not; none past the
    sources' reach (31 tokens at the envelope's top, D 136)."""
    assert envelope.attention_short_plan(4, 32, 6, 5) == {"fwd": (4, 64224), "bwd": (4, 163776)}
    assert envelope.attention_short_plan(16, 32, 2, 16) == {"fwd": (4, 48912),
                                                            "bwd": (4, 120224)}
    assert envelope.attention_short_plan(25, 64, 4, 16) == {"fwd": (4, 186544),
                                                            "bwd": (1, 217984)}
    # n = 2 at 6 x 5 heads: head_dim 5 pads to 8, 48 columns a part.  float32
    # bqkv, bproj and the scale (144 + 32 + 6, rounded up to 184), the bias
    # [6][4][4] and the mask's rows and columns [2][4][4]; the bf16 weights
    # [32][152] and [48][40]; per warp 16 rows of bf16 outputs [16][56] and
    # x [16][40], and float32 q_n | k_n | v [16][145]
    assert envelope.attention_short_fwd_bytes(4, 32, 6, 5, 4) == (
        4 * (184 + 96 + 32) + 2 * (32 * 152 + 48 * 40)
        + 4 * (2 * 16 * (56 + 40) + 4 * 16 * 145))
    for N, D, nh, hd in ((31, 128, 4, 32), (4, 136, 2, 8), (32, 32, 2, 16)):
        assert envelope.attention_short_plan(N, D, nh, hd) is None


# (D, hidden) of K6 with the body each runs at bfloat16 and float32 and the
# tensor-core generic body's plan (resident, hidden slice, slices, bytes):
# the demo width, the full-width NGswin's, the envelope's top (weights
# streamed, eight hidden slices), the JAX tests' D 8 / hidden 16
FFN_BODY_CASES = [
    ((32, 64), "tensor-core generic", "CUDA-core generic", (True, 64, 1, 85248)),
    ((64, 128), "flagship", "templated", (True, 128, 1, 176640)),
    ((128, 512), "tensor-core generic", "CUDA-core generic", (False, 64, 8, 203776)),
    ((8, 16), "tensor-core generic", "CUDA-core generic", (True, 16, 1, 35648)),
    ((12, 24), "CUDA-core generic", "CUDA-core generic", None),  # D not a multiple of 8
]


@pytest.mark.parametrize("widths,bf16,f32,plan", FFN_BODY_CASES)
def test_ffn_body_is_a_rule_of_widths_and_dtype(widths, bf16, f32, plan):
    """K6's body by (D, hidden) and dtype alone: bfloat16 the tensor-core
    generic body wherever it has a plan (the byte count of the CUDA source's
    layout), the full-width NGswin's widths their own bodies, float32 and
    what that body does not take the CUDA-core one; every case stays inside
    the envelope."""
    assert envelope.ffn_body(*widths, torch.bfloat16) == bf16
    assert envelope.ffn_body(*widths, torch.float32) == f32
    assert envelope.ffn_mma_plan(*widths) == plan
    if plan is not None:
        resident, hs, slices, nbytes = plan
        assert nbytes == envelope.ffn_mma_bytes(*widths, hs, resident) <= envelope.H100_SMEM_PER_BLOCK
        assert slices == -(-widths[1] // 16 * 16 // hs)
    envelope.ffn_envelope(*widths)


# (C, D, heads, head_dim) of K7 with the body each runs at bfloat16 and
# float32 and the tensor-core generic body's (pass 1, pass 2) bytes: the demo
# width, the envelope's top, a head_dim not a multiple of 8, the full-width
# NGswin's, C not a multiple of 8, an attention width past what fits a block
NGRAM_BODY_CASES = [
    ((16, 32, 2, 8), "tensor-core generic", "CUDA-core generic", (29024, 14592)),
    ((64, 128, 4, 16), "tensor-core generic", "CUDA-core generic", (214048, 107136)),
    ((16, 32, 3, 5), "tensor-core generic", "CUDA-core generic", (30176, 14208)),
    ((32, 64, 6, 5), "flagship", "CUDA-core generic", (76096, 35056)),
    ((32, 64, 4, 8), "flagship", "CUDA-core generic", (73888, 36224)),
    ((20, 40, 4, 5), "CUDA-core generic", "CUDA-core generic", None),
    ((64, 128, 8, 16), "CUDA-core generic", "CUDA-core generic", None),
]


@pytest.mark.parametrize("geometry,bf16,f32,nbytes", NGRAM_BODY_CASES)
def test_ngram_body_is_a_rule_of_geometry_and_dtype(geometry, bf16, f32, nbytes):
    """K7's body by geometry and dtype alone: bfloat16 the tensor-core
    generic body wherever both of its passes fit a block (the byte counts of
    the CUDA source's layout), the full-width NGswin's geometries their own
    body, float32 and what that body does not take the CUDA-core one."""
    assert envelope.ngram_body(*geometry, torch.bfloat16) == bf16
    assert envelope.ngram_body(*geometry, torch.float32) == f32
    assert envelope.ngram_mma_plan(*geometry) == nbytes
    if nbytes is not None:
        assert nbytes == envelope.ngram_mma_bytes(*geometry)
        assert max(nbytes) <= envelope.H100_SMEM_PER_BLOCK
    envelope.ngram_envelope(*geometry)


# (D, hidden) of K5 with its tensor-core generic body's plan (resident,
# bytes): the demo width, the envelope's top (two 64-column stages
# streamed), the JAX tests' D 8 / hidden 16, a hidden width whose resident
# weights leave no room for two strip stages, the full-width NGswin's (its
# bf16 runs the flagship body all the same), D not a multiple of 8
FFN_FWD_PLAN_CASES = [
    ((32, 64), (True, 51584)), ((128, 512), (False, 145920)), ((8, 16), (True, 26496)),
    ((96, 384), (False, 110976)), ((64, 128), (True, 111360)), ((12, 24), None),
]


@pytest.mark.parametrize("widths,plan", FFN_FWD_PLAN_CASES)
def test_ffn_forward_plan_counts_the_sources_layout(widths, plan):
    """K5's tensor-core generic plan: resident weights where they fit with
    two stages of strips, else streamed; its bytes are the CUDA source's
    layout's and fit a block; K5 runs the body ``ffn_body`` names, K6's."""
    assert envelope.ffn_mma_fwd_plan(*widths) == plan
    if plan is not None:
        assert plan[1] == envelope.ffn_mma_fwd_bytes(*widths, plan[0]) <= envelope.H100_SMEM_PER_BLOCK
        if plan[0]:
            assert envelope.ffn_mma_fwd_bytes(*widths, True) <= envelope.H100_SMEM_PER_BLOCK
        else:
            assert envelope.ffn_mma_fwd_bytes(*widths, True) > envelope.H100_SMEM_PER_BLOCK
    if widths != envelope.FFN_KERNEL_DIMS:
        assert (envelope.ffn_body(*widths, torch.bfloat16) == "tensor-core generic") == (plan is not None)


def test_k5_and_k6_share_one_body_rule():
    """Over the envelope (D up to 136, hidden up to 4·D): K5's plan exists
    wherever K6's does, so the rule that asks both (``ffn_body``, the
    sources' ``ffn_g::body``) gives the tensor-core generic body exactly
    where K6's plan exists, at bfloat16 only."""
    for D in range(8, 137, 8):
        for H in range(8, 4 * D + 1, 8):
            k6 = envelope.ffn_mma_plan(D, H) is not None
            assert k6 <= (envelope.ffn_mma_fwd_plan(D, H) is not None)
            if (D, H) != envelope.FFN_KERNEL_DIMS:
                want = "tensor-core generic" if k6 else "CUDA-core generic"
                assert envelope.ffn_body(D, H, torch.bfloat16) == want
                assert envelope.ffn_body(D, H, torch.float32) == "CUDA-core generic"


# (C, D, heads, head_dim) with the body K1 runs at bfloat16 and float32: the
# full-width NGswin's (its float32 the templated body, which K7 lacks), the
# demo width, the envelope's top, C not a multiple of 8
NGRAM_FWD_BODY_CASES = [
    ((32, 64, 6, 5), "flagship", "templated"), ((32, 64, 4, 8), "flagship", "templated"),
    ((16, 32, 2, 8), "tensor-core generic", "CUDA-core generic"),
    ((64, 128, 4, 16), "tensor-core generic", "CUDA-core generic"),
    ((20, 40, 4, 5), "CUDA-core generic", "CUDA-core generic"),
]


@pytest.mark.parametrize("geometry,bf16,f32", NGRAM_FWD_BODY_CASES)
def test_ngram_forward_body_is_k7_s_rule_and_names_the_templated_body(geometry, bf16, f32):
    """K1's body by geometry and dtype alone: ``ngram_body``'s rule with
    ``forward``, which differs from K7's only in naming K1's float32
    templated body at the full-width NGswin's geometries."""
    assert envelope.ngram_body(*geometry, torch.bfloat16, forward=True) == bf16
    assert envelope.ngram_body(*geometry, torch.float32, forward=True) == f32
    assert envelope.ngram_body(*geometry, torch.bfloat16) == bf16
    assert envelope.ngram_body(*geometry, torch.float32) == (
        "CUDA-core generic" if f32 == "templated" else f32)
    assert envelope.NGRAM_BODIES.index("templated") == 3


# K1's tile on the tensor-core generic body for a [B, wh, ww] grid on 132
# SMs: the demo width's 8 x 8 stage 1 (2 x 4 cells), the envelope's top
# (2 x 8: 4 x 16 tiles would leave SMs idle), a large grid (4 x 16), an odd
# one, a grid narrower than 4 cells; and the tile's bytes (2 x 4, 2 x 8,
# 4 x 16) at the demo width
NGRAM_TILE_CASES = [
    ((8, 8, 8, 16, 32, 2, 8), (2, 4)), ((8, 32, 32, 64, 128, 4, 16), (2, 8)),
    ((8, 64, 64, 16, 32, 2, 8), (4, 16)), ((3, 13, 7, 16, 32, 2, 8), (2, 4)),
    ((64, 64, 2, 16, 32, 2, 8), (2, 4)),
]


@pytest.mark.parametrize("grid,tile", NGRAM_TILE_CASES)
def test_ngram_forward_tile_is_sized_to_the_grid(grid, tile):
    assert envelope.ngram_mma_fwd_tile(*grid, 132) == tile
    assert [envelope.ngram_mma_fwd_bytes(16, 32, 2, 8, *t) for t in envelope.NGRAM_FWD_TILES] == [
        50960, 23056, 17424]


def test_ngram_forward_smallest_tile_fits_wherever_k7_has_a_plan():
    """K1's 2 x 4-cell tile stages what K7's pass 1 stages and less, so it
    fits wherever K7 has a plan: the rule's forward condition never bites."""
    for C in range(8, 129, 8):
        for D in (C, 2 * C):
            for hd in (1, 5, 8, 16, 32):
                for nh in range(1, 17):
                    plan = envelope.ngram_mma_plan(C, D, nh, hd)
                    if plan is not None:
                        assert envelope.ngram_mma_fwd_bytes(C, D, nh, hd, 2, 4) <= plan[0]


def test_nstb_envelope_refuses_past_the_card_s_shared_memory():
    """The FFN tail is not cut into chunks: at D = 128 (4 x 32 heads) a
    hidden width of 649 still fits, 650 does not, and the refusal names the
    bytes; at hidden = 4·D the first width past the card is D = 152."""
    assert envelope.nstb_envelope(64, 128, 4, 32, 649) == envelope.H100_SMEM_PER_BLOCK
    with pytest.raises(NotImplementedError, match=r"whole NSTB \(K2/K8\).*needs 232704 bytes"):
        envelope.nstb_envelope(64, 128, 4, 32, 650)
    envelope.nstb_envelope(64, 144, 4, 32, 576)
    with pytest.raises(NotImplementedError, match="D=152.*past the card's 232448"):
        envelope.nstb_envelope(64, 152, 4, 32, 608)
    with pytest.raises(NotImplementedError, match="head_dim 40 is past the bound"):
        envelope.nstb_envelope(64, 80, 2, 40, 160)
    with pytest.raises(NotImplementedError, match="N=81 tokens is past the bound N <= 64"):
        envelope.nstb_envelope(81, 32, 2, 16, 64)
    with pytest.raises(ValueError):
        envelope.nstb_envelope(64, 32, 2, 16, 0)


def test_the_whole_envelope_is_admitted():
    """Every width up to D = 128 with heads of up to 32 channels (A <= D),
    every window of the envelope, hidden up to 4·D (the whole block's too),
    and the n-gram context at C = D/2 (A <= C)."""
    for D in range(8, 129, 8):
        for hd, nh in itertools.product((1, 5, 8, 10, 16, 31, 32), range(1, 17)):
            if nh * hd <= D:
                for N in (1, 4, 9, 16, 64):
                    envelope.attention_envelope(N, D, nh, hd)
                    envelope.nstb_envelope(N, D, nh, hd, 4 * D)
            if nh * hd <= D // 2:
                envelope.ngram_envelope(D // 2, D, nh, hd)
        for H in range(D, 4 * D + 1, 8):
            envelope.ffn_envelope(D, H)


def test_past_the_envelope_the_limit_is_named():
    with pytest.raises(NotImplementedError, match="head_dim 40 is past the bound head_dim <= 32"):
        envelope.attention_envelope(64, 80, 2, 40)
    with pytest.raises(NotImplementedError, match="N=81 tokens is past the bound N <= 64"):
        envelope.attention_envelope(81, 32, 2, 16)
    with pytest.raises(NotImplementedError, match="head_dim 48"):
        envelope.ngram_envelope(96, 192, 2, 48)
    with pytest.raises(NotImplementedError,
                       match=r"needs \d+ bytes of shared memory, past the card's 232448"):
        envelope.ffn_envelope(512, 2048)
    with pytest.raises(NotImplementedError, match="bytes of shared memory"):
        envelope.ngram_envelope(512, 1024, 16, 32)
    # the whole-block kernels K2/K8 refuse past their envelope too, naming the limit
    with pytest.raises(NotImplementedError,
                       match=r"whole NSTB \(K2/K8\): the block at N=64, D=512.* needs \d+ bytes"):
        envelope.nstb_envelope(64, 512, 16, 32, 2048)
