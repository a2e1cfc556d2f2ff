"""The widths the kernels take (K1-K8), as plain functions of the shapes.

Each kernel has a runtime-dimension body (``csrc/*.cu``, "the generic
body") beside the full-width NGswin's bodies, which takes D, hidden, C, the
head count, head_dim and the window length at run time and sizes its
dynamic shared memory at launch.  Each has two: a tensor-core one for
bfloat16 and a CUDA-core one; ``nstb_body``, ``attention_body``,
``ffn_body`` and ``ngram_body`` say which body runs a call.
What bounds them is the card's opt-in shared memory per block
(``cudaDevAttrMaxSharedMemoryPerBlockOptin``, 232,448 bytes on an H100).
K5/K6 and K1/K7 size their tiles by width at launch (rows of a tile, cells
of a block: the most that fit, and the FFN's hidden layer in chunks where
one row does not fit; ``ffn_tiles``, ``ngram_tiles``).  Windows of more than 64 tokens, heads wider than 32
channels, and every window attention or whole-NSTB geometry whose
generic tile fits no block run K3/K4's and K2/K8's long-window bodies
(``attention_long_plan``, ``nstb_long_plan``), which keep a window in a
workspace in device memory and are bounded by shared memory alone.  So
every NGswin geometry with D <= 512, hidden <= 4·D, attention heads of up
to 128 channels, windows of 1 to 16x16 tokens and an n-gram context at
C = D/2 with heads of up to 128 channels runs on the card.  The functions
below count the shared memory as the CUDA sources do (each source's
``tmar_*_smem`` query gives its own count, ``built_smem``; a GPU test
holds the two equal), pick the tile sizes the generic bodies are launched
with, and refuse, with a ``NotImplementedError`` that names the bytes, only
what lies past them.  Weights are read from device memory (L2) by the
generic bodies, so their size bounds nothing.

A CPU tensor never comes here: it runs the plain versions at any width.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

# the opt-in shared memory of one sm_90 block, and of one SM
H100_SMEM_PER_BLOCK = 232448
H100_SMEM_PER_SM = 233472
HEAD_DIM_MAX = 32   # the widest head of K2-K4's generic bodies and K1/K7's tensor-core ones
ROWS = 64           # token rows of a window-attention tile, the most of an FFN tile
THREADS = 256       # threads of a generic block
NGRAM_TJ = 32       # K1's CUDA-core generic body's cells per block, at most (a grid row's segment)
NGRAM_BWD_TJ = 16   # K7's cells per pass-1 tile, at most
NGRAM_BWD_TP = 32   # K7's positions per pass-2 tile, at most


def smem_limit(device: Optional[torch.device] = None) -> int:
    """The opt-in shared memory of one block on ``device`` (the H100's
    figure without a CUDA device)."""
    if device is not None and device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        return int(getattr(props, "shared_memory_per_block_optin", H100_SMEM_PER_BLOCK))
    return H100_SMEM_PER_BLOCK


def _refuse(kernel: str, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{kernel}: {what}.  The kernels take any geometry whose tiles fit the card's shared "
        "memory at one row, one cell or one head a tile (every NGswin with D <= 512, hidden "
        "<= 4·D, heads of up to 128 channels and windows of up to 16x16 tokens among them); "
        "past that only the plain version computes it, on the CPU")


def _most(start: int, size) -> int:
    """The most of start, start / 2, ..., 1 rows (or cells) whose
    ``size(rows)`` fits a block of the card's shared memory; 1 where none
    does (the caller's count then names the bytes)."""
    rows = start
    while rows > 1 and size(rows) > H100_SMEM_PER_BLOCK:
        rows //= 2
    return rows


def _fits(kernel: str, nbytes: int, limit: int, what: str) -> int:
    if nbytes > limit:
        raise _refuse(kernel, f"{what} needs {nbytes} bytes of shared memory, past the "
                              f"card's {limit} bytes a block")
    return nbytes


def blocks_for(tiles: int, nbytes: int, sms: int) -> int:
    """Persistent blocks for ``tiles`` tiles of a body using ``nbytes`` of
    shared memory: as many as the SMs hold (at most 8 of 256 threads each),
    never more than the tiles."""
    per_sm = max(1, min(8, H100_SMEM_PER_SM // (nbytes + 1024)))
    return max(1, min(tiles, per_sm * sms))


# ---- K5 / K6: residual FFN ---------------------------------------------------

def ffn_fwd_bytes(D: int, H: int, rows: int = ROWS, hc: Optional[int] = None) -> int:
    """K5's generic body: y, ``hc`` hidden columns (all H by default) and
    fc2's output of a tile of ``rows`` rows."""
    return 4 * rows * (2 * (D + 1) + (hc or H) + 1)


def ffn_bwd_bytes(D: int, H: int, rows: int, hc: Optional[int] = None) -> int:
    """K6's generic body: n1, y, o, dz of a tile of ``rows`` rows at width D,
    u and h at ``hc`` hidden columns (all H by default), the two rows'
    LayerNorm scales."""
    return 4 * rows * (4 * (D + 1) + 2 * ((hc or H) + 1) + 2)


@functools.lru_cache(maxsize=None)
def ffn_tiles(D: int, H: int) -> Tuple[int, int, int, int]:
    """(K5's rows a tile, its hidden columns a chunk, K6's rows, its chunk)
    of the CUDA-core generic bodies: the most of 64, 32, ..., 1 rows whose
    tile holds the whole hidden row and fits a block; where one row does not
    fit (about 58,000 hidden columns in K5, 28,000 in K6, far past 4·D),
    one row with the most of H, H / 2, ... hidden columns a chunk (K6 then
    recomputes each chunk's hidden layer for its backward)."""
    def tile(size):
        rows = _most(ROWS, lambda r: size(r, H))
        return rows, H if size(rows, H) <= H100_SMEM_PER_BLOCK else _most(H, lambda c: size(1, c))

    return (*tile(lambda r, c: ffn_fwd_bytes(D, H, r, c)),
            *tile(lambda r, c: ffn_bwd_bytes(D, H, r, c)))


def ffn_envelope(D: int, H: int, device: Optional[torch.device] = None):
    """-> (K5's bytes, K6's rows per tile, K6's bytes) for (D, hidden) on
    ``ffn_tiles``' tiles, or NotImplementedError naming the limit."""
    limit = smem_limit(device)
    kernel = "residual FFN (K5/K6)"
    if D < 1 or H < 1:
        raise ValueError(f"{kernel}: D={D}, hidden={H}")
    rows5, hc5, rows6, hc6 = ffn_tiles(D, H)
    what = f"D={D}, hidden={H}"
    fwd = _fits(kernel, ffn_fwd_bytes(D, H, rows5, hc5), limit,
                f"the forward at {what}, {rows5} rows, {hc5} hidden columns")
    bwd = _fits(kernel, ffn_bwd_bytes(D, H, rows6, hc6), limit,
                f"the backward at {what}, {rows6} rows, {hc6} hidden columns")
    return fwd, rows6, bwd


# the bodies of K5 and K6, in the order of the CUDA sources' codes (ffn_g::Body
# in csrc/ffn_generic_mma.cuh); each kernel has all four
FFN_BODIES = ("flagship", "templated", "tensor-core generic", "CUDA-core generic")
FFN_KERNEL_DIMS = (64, 128)  # the full-width NGswin's (D, hidden)
FFN_MMA_WARPS = 8     # warps of K5's and K6's tensor-core generic blocks
FFN_MMA_CHUNK = 64    # hidden columns of one of their streamed stages
FFN_MMA_MAX_D = 128   # the widest D their fragment arrays take


def _ffn_units(DP: int) -> int:
    """16x16 tiles of each of dw1 and dw2 a warp of K6's tensor-core
    generic body keeps in registers (its fragment width DM 32: 2, else 4)."""
    return 2 if DP <= 32 else 4


def ffn_mma_bytes(D: int, H: int, HS: int, resident: bool) -> int:
    """K6's tensor-core generic body (``csrc/ffn_generic_mma.cuh``:
    ``make_plan``) with hidden slices of HS columns: float32 g1, b1, g2, bw2
    [DP] and bw1 [HP]; the bf16 weights, w1 as [h][DP + 8] and w2 as
    [DP][h + 8], all hidden columns (``resident``) or 64 of them; per warp
    its x, attn_out and dz strips [16][DP + 8], its hc and duc strips
    [16][HS + 8], and its float32 vector partials [5·DP + HS]."""
    DP, HP = _up(D, 16), _up(H, 16)
    cols = HP if resident else FFN_MMA_CHUNK
    floats = _up(4 * DP + HP, 4)
    welems = cols * (DP + 8) + DP * (cols + 8)
    strip = 3 * 16 * (DP + 8) + 2 * 16 * (HS + 8)
    return 4 * floats + 2 * (welems + FFN_MMA_WARPS * strip) + 4 * FFN_MMA_WARPS * (5 * DP + HS)


def ffn_mma_plan(D: int, H: int) -> Optional[Tuple[bool, int, int, int]]:
    """-> (resident, HS, slices, bytes) of K6's tensor-core generic body's
    launch (``csrc/ffn_generic_mma.cuh``: ``plan``), or None where it takes
    none: D not a multiple of 8 (16-byte rows) or past 128, or no layout
    that fits a block.  Resident weights where they fit, else streamed; at
    that the widest hidden slice HS that fits, from min(HP, 8 warps x UNITS
    x 256 / DP) down by 16 (dw1 and dw2 of a slice stay in the warps'
    registers); slices = ceil(HP / HS)."""
    if not (8 <= D <= FFN_MMA_MAX_D and D % 8 == 0 and H >= 1):
        return None
    DP, HP = _up(D, 16), _up(H, 16)
    hs0 = min(HP, FFN_MMA_WARPS * _ffn_units(DP) * 256 // DP // 16 * 16)
    for resident in (True, False):
        for hs in range(hs0, 0, -16):
            nbytes = ffn_mma_bytes(D, H, hs, resident)
            if nbytes <= H100_SMEM_PER_BLOCK:
                return resident, hs, -(-HP // hs), nbytes
    return None


def ffn_mma_fwd_bytes(D: int, H: int, resident: bool) -> int:
    """K5's tensor-core generic body (``csrc/ffn_generic_mma.cuh``:
    ``make_fwd_plan``): float32 g1, b1, g2, b2, bw2 [DP] and bw1 [HP]; the
    bf16 weights, w1 as [h][DP + 8] and w2 as [DP][h + 8], all hidden
    columns (``resident``) or two stages of 64; per warp its x and attn_out
    strips [16][DP + 8], two stages of them where the weights are
    resident."""
    DP, HP = _up(D, 16), _up(H, 16)
    cols = HP if resident else FFN_MMA_CHUNK
    floats = _up(5 * DP + HP, 4)
    welems = (1 if resident else 2) * (cols * (DP + 8) + DP * (cols + 8))
    strips = (4 if resident else 2) * 16 * (DP + 8)
    return 4 * floats + 2 * (welems + FFN_MMA_WARPS * strips)


def ffn_mma_fwd_plan(D: int, H: int) -> Optional[Tuple[bool, int]]:
    """-> (resident, bytes) of K5's tensor-core generic body's launch
    (``csrc/ffn_generic_mma.cuh``: ``fwd_plan``), or None where it takes
    none (D not a multiple of 8 or past 128, what fits no block): resident
    weights where they fit, else streamed 64 hidden columns at a time."""
    if not (8 <= D <= FFN_MMA_MAX_D and D % 8 == 0 and H >= 1):
        return None
    for resident in (True, False):
        nbytes = ffn_mma_fwd_bytes(D, H, resident)
        if nbytes <= H100_SMEM_PER_BLOCK:
            return resident, nbytes
    return None


@functools.lru_cache(maxsize=None)
def ffn_body(D: int, H: int, dtype: torch.dtype) -> str:
    """The body of K5 and of K6 that runs width D, hidden H at I/O type
    ``dtype`` (one of ``FFN_BODIES``), by geometry and dtype alone, as the
    CUDA sources' ``ffn_g::body`` picks it: the full-width NGswin's (64,
    128) their own bodies (bfloat16 the tensor-core ones, float32 the ones
    templated on the widths); bfloat16 the tensor-core generic bodies
    wherever both have a plan (``ffn_mma_plan``, ``ffn_mma_fwd_plan``); the
    rest (float32, the exactness path, and widths those bodies do not take)
    the CUDA-core generic bodies."""
    bf16 = dtype == torch.bfloat16
    if (D, H) == FFN_KERNEL_DIMS:
        return FFN_BODIES[0] if bf16 else FFN_BODIES[1]
    if bf16 and ffn_mma_plan(D, H) is not None and ffn_mma_fwd_plan(D, H) is not None:
        return FFN_BODIES[2]
    return FFN_BODIES[3]


# ---- K3 / K4: window attention ---------------------------------------------

def attention_fwd_bytes(D: int, nh: int, hd: int, hg: int) -> int:
    """K3's generic body, heads taken ``hg`` at a time: x, one group's q/k/v,
    all heads' outputs of a 64-row tile."""
    return 4 * ROWS * ((D + 1) + (3 * hg * hd + 1) + (nh * hd + 1))


def attention_bwd_bytes(N: int, D: int, hd: int, hg: int) -> int:
    """K4's generic body, heads taken ``hg`` at a time: x, g and dx of a
    64-row tile; one group's q/k/v and their cotangents, dacc and the head
    outputs; per row and head the two norms, lse, delta and the dscale
    share; with several windows to a tile, the group's ds per window."""
    G = hg * hd
    wpb = ROWS // N
    ds = hg * wpb * N * N if wpb > 1 else 0
    return 4 * (3 * ROWS * (D + 1) + ROWS * (2 * (3 * G + 1) + 2 * (G + 1)) + ROWS * 5 * hg + ds)


# (N, D, num_heads, head_dim) of the full-width NGswin, for which K3/K4 keep
# bodies of their own: its 8x8 windows at D = 64 (bfloat16 on the tensor
# cores, the flagship bodies; float32 on the body templated on the
# geometry) and its n x n n-gram windows at D/2 = 32 (n = 1, 2, 3; the
# templated body at both dtypes).  The same set as
# csrc/window_attention_geometries.cuh.
ATTENTION_MMA_GEOMETRIES = {(64, 64, 6, 10), (64, 64, 4, 16)}
ATTENTION_KERNEL_GEOMETRIES = ATTENTION_MMA_GEOMETRIES | {
    (n * n, 32, nh, hd) for n in (1, 2, 3) for nh, hd in ((6, 5), (4, 8))}
# the bodies of K3 and K4, in the order of the CUDA sources' codes
# (attn_mma::Body in csrc/window_attention_generic_mma.cuh)
ATTENTION_BODIES = ("flagship", "templated", "tensor-core generic", "CUDA-core generic",
                    "tensor-core short-window", "long-window", "tensor-core long-window")
ATTN_MMA_WARPS = 8      # warps of a tensor-core generic block
ATTN_MMA_MIN_N = 32     # the shortest window it takes (JAX rounds q_n, k_n, P from 32 up)


def _attn_mma_geometry(N, D, nh, hd):
    DP, HP = _up(D, 16), 16 if hd <= 16 else 32
    NP = _up(N, 16)
    return DP, HP, nh * HP, NP, NP // 16


def attention_mma_fwd_bytes(N: int, D: int, nh: int, hd: int, resident: bool) -> int:
    """K3's tensor-core generic body (``csrc/window_attention_generic_mma.cuh``:
    ``fwd_plan``): float32 bqkv, bproj and the scale; the bf16 weights
    [in][out] with rows padded by 8, all heads' (``resident``) or one
    head's; per window group two head buffers of k_n and v [NP][HP + 8]."""
    DP, HP, AP, NP, WW = _attn_mma_geometry(N, D, nh, hd)
    G = ATTN_MMA_WARPS // WW
    floats = _up(3 * AP + DP + nh, 4)
    cols, rows = (3 * AP, AP) if resident else (3 * HP, HP)
    weights = DP * (cols + 8) + rows * (DP + 8)
    return 4 * floats + 2 * (weights + G * 4 * NP * (HP + 8))


def attention_mma_bwd_bytes(N: int, D: int, nh: int, hd: int, groups: int, resident: bool,
                            double: bool) -> int:
    """K4's per-window launch on the tensor cores (``bwd_plan``): float32
    bqkv, the scale and each warp's sums of dbqkv and dscale; the bf16
    weights as K3 stages them; per window group its x and g tiles [NP][DP + 8]
    (two slots where ``double``), q_n and dacc [NP][HP + 8] double-buffered by
    head, k_n and v, P and dcos [NP][NP + 8]."""
    DP, HP, AP, NP, WW = _attn_mma_geometry(N, D, nh, hd)
    warps = WW * groups
    floats = _up(3 * AP + nh + warps * (3 * AP + nh), 4)
    cols, rows = (3 * AP, AP) if resident else (3 * HP, HP)
    weights = DP * (cols + 8) + rows * (DP + 8)
    group = ((2 if double else 1) * 2 * NP * (DP + 8) + 6 * NP * (HP + 8)
             + 2 * NP * (NP + 8))
    return 4 * floats + 2 * (weights + groups * group)


def attention_mma_sums_bytes(D: int, nh: int, hd: int, double: bool) -> int:
    """K4's token sums (``sums_plan``): a 64-row step of x and g [64][DP + 8],
    dqkv [64][3AP + 8] and the attention output [64][AP + 8] in bf16, two
    steps where ``double``."""
    DP, _, AP, _, _ = _attn_mma_geometry(ROWS, D, nh, hd)
    return (2 if double else 1) * 2 * ROWS * (2 * (DP + 8) + 3 * AP + 8 + AP + 8)


def attention_mma_plan(N: int, D: int, nh: int, hd: int) -> Optional[dict]:
    """The tensor-core generic bodies' launch (``csrc/window_attention_generic_mma.cuh``:
    ``plan``), or None where they take no plan: a window outside 32..64
    tokens, D not a multiple of 8 or past 128, head_dim past 32, or what
    fits no block of the card's shared memory.  K3 keeps its weights
    resident where they fit, else streams them by head; K4's per-window
    launch takes the most window groups that fit, and at that count
    resident weights and double-buffered tiles where they fit (in that
    order of preference), its token sums double-buffered where they fit."""
    if not (ATTN_MMA_MIN_N <= N <= ROWS and 8 <= D <= NSTB_MMA_MAX_D and D % 8 == 0
            and 1 <= hd <= HEAD_DIM_MAX and nh >= 1):
        return None
    limit = H100_SMEM_PER_BLOCK
    plan = {}
    for resident in (True, False):
        nbytes = attention_mma_fwd_bytes(N, D, nh, hd, resident)
        if nbytes <= limit:
            plan["fwd"] = (resident, nbytes)
            break
    else:
        return None
    gmax = ATTN_MMA_WARPS // _attn_mma_geometry(N, D, nh, hd)[4]
    for groups in range(gmax, 0, -1):
        for resident, double in ((True, True), (True, False), (False, True), (False, False)):
            nbytes = attention_mma_bwd_bytes(N, D, nh, hd, groups, resident, double)
            if nbytes <= limit:
                plan["bwd"] = (groups, resident, double, nbytes)
                break
        if "bwd" in plan:
            break
    else:
        return None
    for double in (True, False):
        nbytes = attention_mma_sums_bytes(D, nh, hd, double)
        if nbytes <= limit:
            plan["sums"] = (double, nbytes)
            return plan
    return None


def attention_mma_bytes(N: int, D: int, nh: int, hd: int) -> Optional[Tuple[int, int, int]]:
    """(K3's, K4's per-window, K4's token sums) shared memory of the
    tensor-core generic bodies' plan, or None without one: what the CUDA
    sources' ``tmar_window_attention_*_mma_smem`` queries give."""
    plan = attention_mma_plan(N, D, nh, hd)
    if plan is None:
        return None
    return plan["fwd"][-1], plan["bwd"][-1], plan["sums"][-1]


def _short_geometry(N, D, nh, hd):
    """The short-window body's padded geometry (``short_geom``): DP, HP,
    APP, the unit's rows R and the weights' bf16 elements."""
    DP = _up(D, 16)
    HP = 8 if hd <= 8 else 16 if hd <= 16 else 32
    APP = _up(nh * HP, 16)
    R = 16 if N <= 16 else 32
    welems = DP * (3 * APP + 8) + APP * (DP + 8)
    return DP, HP, APP, R, welems


def _short_raw(N, D, nh, hd):
    """The floats of the parameters as the short-window bodies read them,
    before staging (``stage_short``): wqkv, wproj, bqkv, bproj, the scale,
    the bias and the two mask components."""
    A = nh * hd
    return D * 3 * A + A * D + 3 * A + D + nh + (nh + 2) * N * N


def attention_short_fwd_bytes(N: int, D: int, nh: int, hd: int, warps: int) -> int:
    """K3's short-window body (``csrc/window_attention_generic_mma.cuh``:
    ``make_short_fwd``): float32 bqkv, bproj and the scale, the bias and
    the shift mask's rows and columns, each region on 16 bytes; the bf16
    weights; per warp the head outputs in bf16 [R][APP + 8], its x rows in
    bf16 [R][DP + 8] and q_n | k_n | v in float32 [R][3·APP + 1]; the
    warps' regions hold the raw parameters first, so they take at least
    their bytes."""
    DP, _, APP, R, welems = _short_geometry(N, D, nh, hd)
    floats = _up(3 * APP + DP + nh, 4) + _up(nh * N * N, 4) + _up(2 * N * N, 4)
    warp = 2 * R * (APP + 8 + DP + 8) + 4 * R * (3 * APP + 1)
    return 4 * floats + 2 * welems + max(warps * warp, 4 * _up(_short_raw(N, D, nh, hd), 4))


def attention_short_bwd_bytes(N: int, D: int, nh: int, hd: int, warps: int) -> int:
    """K4's short-window body (``make_short_bwd``), each float32 region on
    16 bytes: bqkv, the scale, the bias and the shift mask's rows and
    columns; the block's sums of dwqkv, dwproj, dbqkv,
    dbproj, dscale and dbias; the tile's (``warps`` units') dqkv, attention
    output, dscale shares and ds per window; per warp q_n | k_n | v, dacc
    and four values per row and head (from the tile's dqkv on, the raw
    parameters first: at least their floats); then in bf16 the weights and
    the tile's x and g [rows][DP + 8]."""
    DP, _, APP, R, welems = _short_geometry(N, D, nh, hd)
    BR, NN = warps * R, nh * N * N
    wpu = R // N
    regions = [3 * APP, nh, NN, 2 * N * N, DP * 3 * APP, APP * DP, 3 * APP, DP, nh, NN,
               BR * (3 * APP + 1), BR * (APP + 1), BR * nh, warps * wpu * NN]
    warp = _up(_up(R * (3 * APP + 1), 4) + _up(R * (APP + 1), 4) + R * 4 * nh, 4)
    head = sum(_up(n, 4) for n in regions[:10])  # up to the tile's dqkv
    floats = max(sum(_up(n, 4) for n in regions) + _up(warps * warp, 4),
                 head + _up(_short_raw(N, D, nh, hd), 4))
    return 4 * floats + 2 * (welems + 2 * BR * (DP + 8))


def attention_short_plan(N: int, D: int, nh: int, hd: int) -> Optional[dict]:
    """The short-window bodies' launch (``short_plan``), or None where they
    take no plan: a window outside 1..31 tokens, D not a multiple of 8 or
    past 128, head_dim past 32, or what fits no block.  Each of K3 and K4
    takes the most warps of 4, 2, 1 whose block fits: {"fwd": (warps,
    bytes), "bwd": (warps, bytes)}."""
    if not (1 <= N < ATTN_MMA_MIN_N and 8 <= D <= NSTB_MMA_MAX_D and D % 8 == 0
            and 1 <= hd <= HEAD_DIM_MAX and nh >= 1):
        return None
    plan = {}
    for half, size in (("fwd", attention_short_fwd_bytes), ("bwd", attention_short_bwd_bytes)):
        for warps in (4, 2, 1):
            nbytes = size(N, D, nh, hd, warps)
            if nbytes <= H100_SMEM_PER_BLOCK:
                plan[half] = (warps, nbytes)
                break
        else:
            return None
    return plan


# the long-window bodies (csrc/window_attention_long.cuh: attn_long, and
# csrc/nstb_long.cuh): warps of a block, query rows a warp of the attention
# holds, keys of a staged tile, the most token rows of a row-product tile
# and of a token-sum step
LONG_WARPS, LONG_RPW, LONG_KT, LONG_ROWS = 8, 4, 64, 32


def _odd(n: int) -> int:
    return n | 1


def _long_gemm_bytes(K: int) -> int:
    """A row-product tile at inner width K (``attn_long::gemm_rows``): the
    most of 32, 16, ..., 1 rows [rows][K | 1] whose float32 tile fits 48 KB,
    padded to a multiple of the 8 rows a thread holds."""
    rows = LONG_ROWS
    while rows > 1 and 4 * rows * _odd(K) > 49152:
        rows //= 2
    return 4 * _up(rows, 8) * _odd(K)


def _long_attn_bytes(N: int, hd: int) -> int:
    """The forward attention block (``attn_long::fwd_bytes``): a key tile
    [64][hd | 1], and per warp its 4 rows' scores [4][N], q and outputs [4][hd]."""
    return 4 * (LONG_KT * _odd(hd) + LONG_WARPS * LONG_RPW * (N + 2 * hd))


def _long_sums_bytes(D: int, A: int, rows: int) -> int:
    """K4's token-sum step (``attn_long::sums_bytes``): ``rows`` rows of x
    and g [D | 1], dqkv [3A | 1] and o [A | 1]."""
    return 4 * rows * (2 * _odd(D) + _odd(3 * A) + _odd(A))


def long_sum_rows(D: int, A: int) -> int:
    """The token rows of a step of K4's long-window token sums
    (``attn_long::sum_rows``): the most of 32, 16, ..., 1 that fit a block
    (32 up to D = 296 at A = D)."""
    return _most(LONG_ROWS, lambda rows: _long_sums_bytes(D, A, rows))


def attention_long_bytes(N: int, D: int, nh: int, hd: int) -> Tuple[int, int]:
    """(K3's, K4's) largest block of the long-window bodies' launches
    (``attn_long::plan_bytes``): K3 the qkv and projection products and the
    attention; K4 also the rows pass (k_n and v tiles, per warp its row's
    cos, P, dp and dbias [N] and four head vectors), the columns pass (q_n
    and dacc tiles, lse and delta, per warp four head vectors and two tile
    rows), the token sums (``long_sum_rows`` rows of x, g, dqkv and o) and
    dx's product (its rows sized by its inner width 3A, ``_long_gemm_bytes``)."""
    A = nh * hd
    fwd = max(_long_attn_bytes(N, hd), _long_gemm_bytes(D), _long_gemm_bytes(A))
    rows = 4 * (2 * LONG_KT * _odd(hd) + LONG_WARPS * (4 * N + 4 * hd))
    cols = 4 * (2 * LONG_KT * _odd(hd) + 2 * LONG_KT + LONG_WARPS * (4 * hd + 2 * LONG_KT))
    sums = _long_sums_bytes(D, A, long_sum_rows(D, A))
    return fwd, max(fwd, rows, cols, sums, _long_gemm_bytes(3 * A))


def attention_long_plan(N: int, D: int, nh: int, hd: int) -> Optional[dict]:
    """The long-window bodies' launches (``attn_long::fits``): {"fwd":
    K3's largest block, "bwd": K4's} in bytes, or None where a launch of
    either fits no block of the card's shared memory."""
    if min(N, D, nh, hd) < 1:
        return None
    fwd, bwd = attention_long_bytes(N, D, nh, hd)
    return {"fwd": fwd, "bwd": bwd} if bwd <= H100_SMEM_PER_BLOCK else None


def long_window(N: int, hd: int) -> bool:
    """Whether windows of N tokens with heads of hd channels take the
    long-window bodies (K3/K4 and K2/K8) whatever the widths: past 64
    tokens or 32 channels, which no other body takes.  Those bodies also
    take what the CUDA-core generic bodies' tiles do not fit
    (``attention_generic_fits``, ``nstb_bytes``): ``attention_body`` and
    ``nstb_body`` hold the whole rule."""
    return N > ROWS or hd > HEAD_DIM_MAX


def attention_generic_fits(N: int, D: int, nh: int, hd: int) -> bool:
    """Whether K3's and K4's CUDA-core generic bodies take windows of N
    (<= 64) tokens at width D with nh heads of hd (<= 32): one head's tile
    of each fits a block (``attn_mma::generic_fits``).  From D = 214 at
    heads of 32 channels K4's does not."""
    return (attention_fwd_bytes(D, nh, hd, 1) <= H100_SMEM_PER_BLOCK
            and attention_bwd_bytes(N, D, hd, 1) <= H100_SMEM_PER_BLOCK)


# the tensor-core long-window bodies (csrc/long_mma.cuh: long_mma): the
# widest head and D their fragment arrays take, the shortest K3/K4 window
# (the JAX kernel rounds q_n, k_n and P from 32 tokens up), the rows of a
# row-tile block (heads_gemm, proj_gemm, the NSTB tail), of K4's rows-pass
# and columns-pass blocks, a proj_gemm stage's inner width, a token-sum
# step's rows, a streamed tail stage's hidden columns
LONG_TC_MAX_HD, LONG_TC_MAX_D, LONG_TC_MIN_N = 64, 128, 32
LONG_TC_GR, LONG_TC_AR, LONG_TC_CR = 128, 64, 64
LONG_TC_KC, LONG_TC_SR, LONG_TC_CHUNK = 64, 64, 64


def _long_tc_geometry(N, D, nh, hd):
    """(HP, AP, NP, DP, LDK) of ``long_mma::geom``: head_dim padded to 16,
    the heads' columns, the window's rows padded to 16, D padded to 16, a
    staged head row with its 8 padding columns."""
    HP = _up(hd, 16)
    return HP, nh * HP, _up(N, 16), _up(D, 16), HP + 8


def _long_tc_widths(D: int, nh: int, hd: int) -> bool:
    return 8 <= D <= LONG_TC_MAX_D and D % 8 == 0 and 1 <= hd <= LONG_TC_MAX_HD and nh >= 1


def long_tc_gemm_bytes(N: int, D: int, nh: int, hd: int, parts: int) -> int:
    """``heads_gemm`` with ``parts`` groups of heads (3 the qkv product, 1
    K4's dacc): float32 biases; the bf16 matrix [DP][cols + 8], every head's
    columns where that fits a block (resident), else one head's; the row
    tile [128][DP + 8] (``long_mma::gemm_plan_bytes``)."""
    HP, AP, _, DP, _ = _long_tc_geometry(N, D, nh, hd)

    def size(cols):
        return 4 * _up(parts * AP, 4) + 2 * (DP * (cols + 8) + LONG_TC_GR * (DP + 8))

    resident = size(parts * AP)
    return resident if resident <= H100_SMEM_PER_BLOCK else size(parts * HP)


def long_tc_attn_bytes(N: int, D: int, nh: int, hd: int, table: int = 0) -> int:
    """``attn_fwd_tc``: the bias's floats (K2/K8: the table (2ws - 1)²
    padded to 4, then an int a key [NP]; K3: 0), q_n, k_n and v of one
    (window, head) [NP][LDK] bf16."""
    _, _, NP, _, LDK = _long_tc_geometry(N, D, nh, hd)
    return 4 * _up(table, 4) + 2 * 3 * NP * LDK


def long_tc_bytes(N: int, D: int, nh: int, hd: int) -> dict:
    """Every launch of K3's and K4's tensor-core long-window bodies, in
    bytes of shared memory (``long_mma``'s counts): the qkv product, the
    attention, the projection (and dx), K4's dacc product, rows pass (its
    rows of the bias [64][N] float32 where they fit, its rows' dbias
    [64][N], the key halves' delta [2][64], k_n and v [NP][LDK], q_n and
    dacc [64][LDK]), columns pass (lse and delta, q_n and dacc [NP][LDK], k_n and
    v [64][LDK]) and token sums (64 rows of x, g, dqkv and o)."""
    _, AP, NP, DP, LDK = _long_tc_geometry(N, D, nh, hd)
    AR = LONG_TC_AR

    def rows(staged):
        return 4 * (AR * N * (2 if staged else 1) + 2 * AR) + 2 * (2 * NP * LDK + 2 * AR * LDK)

    return {
        "qkv": long_tc_gemm_bytes(N, D, nh, hd, 3),
        "attention": long_tc_attn_bytes(N, D, nh, hd),
        "projection": 2 * (LONG_TC_GR * (LONG_TC_KC + 8) + LONG_TC_KC * (DP + 8)),
        "dacc": long_tc_gemm_bytes(N, D, nh, hd, 1),
        "rows": rows(True) if rows(True) <= H100_SMEM_PER_BLOCK else rows(False),
        "cols": 4 * 2 * NP + 2 * (2 * NP * LDK + 2 * LONG_TC_CR * LDK),
        "sums": 2 * LONG_TC_SR * (2 * (DP + 8) + (3 * AP + 8) + (AP + 8)),
    }


def attention_long_tc_plan(N: int, D: int, nh: int, hd: int) -> Optional[dict]:
    """The tensor-core long-window bodies' plan (``long_mma::attn_plan_bytes``):
    {"fwd": K3's largest block, "bwd": K4's} in bytes, or None where they
    take none: a window under 32 tokens, D not a multiple of 8 or past 128,
    head_dim past 64, a launch past the card's shared memory (K3's plan
    needs K4's: one rule picks both kernels' body)."""
    if N < LONG_TC_MIN_N or not _long_tc_widths(D, nh, hd):
        return None
    b = long_tc_bytes(N, D, nh, hd)
    fwd = max(b["qkv"], b["attention"], b["projection"])
    bwd = max(b.values())
    return {"fwd": fwd, "bwd": bwd} if bwd <= H100_SMEM_PER_BLOCK else None


def long_tc_tail_bytes(N: int, D: int, nh: int, hd: int, H: int, resident: bool) -> int:
    """K2's and K8's tail (``nstb_long.cuh: nstb_tail_tc``): float32 biases
    and gains [6][DP] and bw1 [H padded to 64]; bf16 wproj [AP][DP + 8],
    fc1 [DP][HC + 8] and fc2 [HC][DP + 8] (HC: every hidden column padded to
    16 resident, 64 a streamed stage); per 128-row tile the head outputs
    [128][AP + 8] and x [128][DP + 8]."""
    _, AP, _, DP, _ = _long_tc_geometry(N, D, nh, hd)
    HC = _up(H, 16) if resident else LONG_TC_CHUNK
    return (4 * _up(6 * DP + _up(H, LONG_TC_CHUNK), 4)
            + 2 * (AP * (DP + 8) + DP * (HC + 8) + HC * (DP + 8)
                   + LONG_TC_GR * ((AP + 8) + (DP + 8))))


def nstb_long_tc_plan(N: int, D: int, nh: int, hd: int, H: int) -> Optional[Tuple[bool, int]]:
    """-> (the tail's fc1 / fc2 resident, the largest block in bytes) of
    K2's and K8's tensor-core long-window body (``long_mma::nstb_plan_bytes``:
    the qkv product, the attention with the table [(2ws - 1)²] in shared
    memory with each key's offset and bands, the tail resident or
    streamed by 64 hidden columns, H a
    multiple of 8), or None where it takes none (D not a multiple of 8 or
    past 128, head_dim past 64, a launch past the card's shared memory)."""
    ws = round(N ** 0.5)
    if ws * ws != N or H < 1 or not _long_tc_widths(D, nh, hd):
        return None
    resident = long_tc_tail_bytes(N, D, nh, hd, H, True) <= H100_SMEM_PER_BLOCK
    if not resident and (H % 8 or long_tc_tail_bytes(N, D, nh, hd, H, False) > H100_SMEM_PER_BLOCK):
        return None
    nbytes = max(long_tc_gemm_bytes(N, D, nh, hd, 3),
                 long_tc_attn_bytes(N, D, nh, hd, _up((2 * ws - 1) ** 2, 4) + _up(N, 16)),
                 long_tc_tail_bytes(N, D, nh, hd, H, resident))
    return (resident, nbytes) if nbytes <= H100_SMEM_PER_BLOCK else None


@functools.lru_cache(maxsize=None)
def attention_body(N: int, D: int, nh: int, hd: int, dtype: torch.dtype) -> str:
    """The body of K3 and K4 that runs windows of N tokens at width D, nh
    heads of hd and I/O type ``dtype`` (one of ``ATTENTION_BODIES``), by
    geometry and dtype alone, as the CUDA sources' ``attn_mma::body`` picks
    it: bfloat16 at the full-width NGswin's 64-token windows the flagship
    tensor-core bodies; its other geometries (those windows at float32, its
    n-gram windows at both dtypes: at bfloat16 the templated bodies
    measured faster there than the short-window bodies, PERF.md §6) the
    bodies templated on the geometry; bfloat16 windows shorter than 32
    tokens the short-window tensor-core bodies wherever they have a plan
    (``attention_short_plan``); bfloat16 windows of 32 to 64 tokens the
    tensor-core generic bodies wherever they have a plan
    (``attention_mma_plan``); the rest (float32, the exactness path, and
    bfloat16 widths without a plan) the CUDA-core generic bodies.  Windows
    of more than 64 tokens or heads wider than 32 channels the long-window
    bodies (``long_window``): at bfloat16 from 32 tokens up the tensor-core
    ones wherever they have a plan (``attention_long_tc_plan``), the rest
    (float32, bf16 windows under 32 tokens, where the JAX kernel keeps q_n,
    k_n and P float32) the CUDA-core ones.  Where the CUDA-core generic
    bodies would run but one head's tile of K3 or K4 fits no block
    (``attention_generic_fits``: D past 213 at heads of 32), the long-window
    bodies by the same choice; no other geometry moves."""
    bf16 = dtype == torch.bfloat16
    long = ATTENTION_BODIES[6 if bf16 and attention_long_tc_plan(N, D, nh, hd) else 5]
    if long_window(N, hd):
        return long
    if bf16 and (N, D, nh, hd) in ATTENTION_MMA_GEOMETRIES:
        return ATTENTION_BODIES[0]
    if (N, D, nh, hd) in ATTENTION_KERNEL_GEOMETRIES:
        return ATTENTION_BODIES[1]
    if bf16 and N < ATTN_MMA_MIN_N and attention_short_plan(N, D, nh, hd) is not None:
        return ATTENTION_BODIES[4]
    if bf16 and attention_mma_plan(N, D, nh, hd) is not None:
        return ATTENTION_BODIES[2]
    return ATTENTION_BODIES[3] if attention_generic_fits(N, D, nh, hd) else long


def attention_long(N: int, D: int, nh: int, hd: int, dtype: torch.dtype = torch.float32) -> bool:
    """Whether K3/K4 run one of the long-window bodies at this geometry and
    dtype (``attention_body``)."""
    return attention_body(N, D, nh, hd, dtype) in ATTENTION_BODIES[5:]


def attention_envelope(N: int, D: int, nh: int, hd: int,
                       device: Optional[torch.device] = None,
                       dtype: torch.dtype = torch.float32):
    """-> (K3's heads per group, K3's bytes, K4's heads per group, K4's
    bytes): each the most heads whose tile fits, or NotImplementedError
    naming the limit (one head's tile past the card's shared memory).  On
    the long-window bodies (``attention_long`` at ``dtype``) all heads and
    the largest block of each kernel's launches (``attention_long_bytes``)."""
    limit = smem_limit(device)
    kernel = "window attention (K3/K4)"
    if N < 1 or hd < 1 or D < 1 or nh < 1:
        raise ValueError(f"{kernel}: N={N}, D={D}, heads={nh}x{hd}")
    if attention_long(N, D, nh, hd, dtype):
        fwd, bwd = attention_long_bytes(N, D, nh, hd)
        _fits(kernel, bwd, limit, f"the long-window body at N={N}, D={D}, heads={nh}x{hd}")
        return nh, fwd, nh, bwd
    out = []
    for size in (lambda g: attention_fwd_bytes(D, nh, hd, g),
                 lambda g: attention_bwd_bytes(N, D, hd, g)):
        _fits(kernel, size(1), limit, f"one head at N={N}, D={D}, heads={nh}x{hd}")
        hg = max(g for g in range(1, nh + 1) if size(g) <= limit)
        out += [hg, size(hg)]
    return tuple(out)


# ---- K1 / K7: the n-gram context ---------------------------------------------

def ngram_fwd_bytes(C: int, nh: int, hd: int, tj: int = NGRAM_TJ) -> int:
    """K1's CUDA-core generic body on blocks of ``tj`` cells: u and q/k/v of
    the 3 x (tj + 2) staged positions, the mean tokens and ctx of tj cells
    in both directions."""
    A = nh * hd
    npos = 3 * (tj + 2)
    return 4 * (npos * C + npos * (3 * A + 1) + tj * 2 * A + tj * 2 * C)


def ngram_bwd_bytes(C: int, D: int, nh: int, hd: int, tj: int = NGRAM_BWD_TJ,
                    tp: int = NGRAM_BWD_TP):
    """(pass 1, pass 2) of K7's CUDA-core generic body.  Pass 1 on tiles of
    ``tj`` cells: u and q/k/v of the staged positions, g, dctx, dacc, the
    mean tokens, ctx, ds and the dscale shares of tj cells; pass 2 on tiles
    of ``tp`` positions: u, raw q/k and the cotangents."""
    A = nh * hd
    npos = 3 * (tj + 2)
    p1 = (npos * C + npos * (3 * A + 1) + tj * D + tj * 2 * C + tj * 2 * A + tj * 2 * A
          + tj * 2 * C + tj * 2 * 16 * nh + tj * 2 * nh)
    p2 = tp * ((C + 1) + 2 * (3 * A + 1))
    return 4 * p1, 4 * p2


def ngram_tiles(C: int, D: int, nh: int, hd: int) -> Tuple[int, int, int]:
    """(K1's cells a block, K7's cells a pass-1 tile, K7's positions a
    pass-2 tile) of the CUDA-core generic bodies (``ngram_rt_tiles`` in the
    sources): each the most of 32 (16 for K7's cells), half that, ..., 1
    that fits a block; the full-width NGswin's and every width up to D =
    128 keep 32, 16 and 32."""
    return (_most(NGRAM_TJ, lambda tj: ngram_fwd_bytes(C, nh, hd, tj)),
            _most(NGRAM_BWD_TJ, lambda tj: ngram_bwd_bytes(C, D, nh, hd, tj=tj)[0]),
            _most(NGRAM_BWD_TP, lambda tp: ngram_bwd_bytes(C, D, nh, hd, tp=tp)[1]))


def ngram_envelope(C: int, D: int, nh: int, hd: int, device: Optional[torch.device] = None):
    """-> (K1's bytes, K7's pass-1 bytes, K7's pass-2 bytes) on a [.., C]
    unigram grid with a [2C, D] merge at the tiles ``ngram_tiles`` picks,
    or NotImplementedError naming the limit.  Any head_dim: the CUDA-core
    bodies walk a head's channels one at a time."""
    limit = smem_limit(device)
    kernel = "n-gram context (K1/K7)"
    if C < 1 or D < 1 or nh < 1 or hd < 1:
        raise ValueError(f"{kernel}: C={C}, D={D}, heads={nh}x{hd}")
    what = f"C={C}, D={D}, heads={nh}x{hd}"
    tj, tj7, tp7 = ngram_tiles(C, D, nh, hd)
    fwd = _fits(kernel, ngram_fwd_bytes(C, nh, hd, tj), limit, f"the forward at {what}")
    p1, p2 = ngram_bwd_bytes(C, D, nh, hd, tj7, tp7)
    _fits(kernel, max(p1, p2), limit, f"the backward at {what}")
    return fwd, p1, p2


# the bodies of K1 and K7, in the order of the CUDA sources' codes (ngram_g::Body
# in csrc/ngram_generic_mma.cuh); "templated" (float32 at the full-width
# NGswin's geometries) is K1's alone
NGRAM_BODIES = ("flagship", "tensor-core generic", "CUDA-core generic", "templated")
NGRAM_MMA_MAX_W = 128  # the widest C and D of K7's tensor-core generic body
# (C, D, heads, head_dim) of the full-width NGswin, whose bf16 runs the
# flagship bodies
NGRAM_FLAGSHIP = {(32, 64, 6, 5), (32, 64, 4, 8)}


def ngram_mma_bytes(C: int, D: int, nh: int, hd: int) -> Tuple[int, int]:
    """(pass 1, pass 2) shared memory of K7's tensor-core generic body
    (``csrc/ngram_context_bwd.cu``: ``ngram_g::make_plan``), C, D and A =
    nh·hd padded to 16, each region rounded up to 16 bytes.  Pass 1: the
    bf16 weights (wqkv [CP][3AP + 8], wproj [AP][CP + 8], wmerge
    [2CP][DP + 8]), float32 bqkv, bproj, the scales and the bias table; the
    tile's bf16 u [32][CP + 8] and q_n | k_n | v [32][3AP + 8], float32 raw
    q | k [32][2AP + 4], bf16 g [16][DP + 8], float32 dctx [8][2CP], bf16
    dctxc [16][CP + 8], float32 dacc [16][AP], bf16 mean [16][AP + 8] and
    ctx [16][2CP + 8], float32 ds [16][16·nh] and dscale shares [16][nh];
    the block's float32 sums of pass 1.  Pass 2: bf16 wqkv, float32 bqkv; a
    tile's bf16 u [16][CP + 8], float32 raw q | k [16][2AP + 4] and the
    slots' sums [16][3A + 4], bf16 dc [16][3AP + 8]; the block's float32
    dwqkv and dbqkv; the slots' offsets [16][18]."""
    A = nh * hd
    CP, DP, AP = _up(C, 16), _up(D, 16), _up(A, 16)
    LU, LQKV, LM, LA, LCX, LQK = CP + 8, 3 * AP + 8, DP + 8, AP + 8, 2 * CP + 8, 2 * AP + 4
    p1size = 17 * nh + A * C + C + 2 * C * D + D
    pass1 = [2 * CP * LQKV, 2 * AP * LU, 4 * CP * LM, 12 * AP, 4 * CP, 4 * nh, 64 * nh,
             2 * 32 * LU, 2 * 32 * LQKV, 4 * 32 * LQK, 2 * 16 * LM, 4 * 8 * 2 * CP, 2 * 16 * LU,
             4 * 16 * AP, 2 * 16 * LA, 2 * 16 * LCX, 4 * 16 * 16 * nh, 4 * 16 * nh, 4 * p1size]
    pass2 = [2 * CP * LQKV, 12 * AP, 2 * 16 * LU, 4 * 16 * LQK, 4 * 16 * (3 * A + 4),
             2 * 16 * LQKV, 4 * (C * 3 * A + 3 * A), 4 * 16 * 18]
    return sum(_up(b, 16) for b in pass1), sum(_up(b, 16) for b in pass2)


def ngram_mma_plan(C: int, D: int, nh: int, hd: int) -> Optional[Tuple[int, int]]:
    """-> ``ngram_mma_bytes`` where K7's tensor-core generic body takes the
    geometry (``ngram_g::plan``), None where it takes none: C or D not a
    multiple of 8 (16-byte rows for cp.async) or past 128, head_dim past 32,
    a pass that fits no block."""
    if not (8 <= C <= NGRAM_MMA_MAX_W and C % 8 == 0 and 8 <= D <= NGRAM_MMA_MAX_W and D % 8 == 0
            and nh >= 1 and 1 <= hd <= HEAD_DIM_MAX):
        return None
    nbytes = ngram_mma_bytes(C, D, nh, hd)
    return nbytes if max(nbytes) <= H100_SMEM_PER_BLOCK else None


# K1's tiles on the tensor-core generic body (S grid rows x TJ cells), in
# order of preference (ngram_g::FWD_TILES)
NGRAM_FWD_TILES = ((4, 16), (2, 8), (2, 4))


def ngram_mma_fwd_bytes(C: int, D: int, nh: int, hd: int, S: int, TJ: int) -> int:
    """K1's tensor-core generic body on tiles of S grid rows x TJ cells
    (``csrc/ngram_generic_mma.cuh``: ``make_fwd_plan``), C, D and A padded to
    16, each region rounded up to 16 bytes: pass 1's staged parameters (bf16
    wqkv [CP][3AP + 8], wproj [AP][CP + 8], wmerge [2CP][DP + 8]; float32
    bqkv, bproj, the scales, the bias table) and float32 bmerge [DP]; bf16 u
    [PROWS][CP + 8] of the (S + 2) x (TJ + 2) staged positions (PROWS: their
    count up to 16) and q_n | k_n | v [PROWS][3AP + 8], float32 raw q | k
    [PROWS][2AP + 4], bf16 mean tokens [2·S·TJ][AP + 8] and ctx [S·TJ up to
    16][2CP + 8]."""
    CP, DP, AP = _up(C, 16), _up(D, 16), _up(nh * hd, 16)
    LU, LQKV, LM, LA, LCX, LQK = CP + 8, 3 * AP + 8, DP + 8, AP + 8, 2 * CP + 8, 2 * AP + 4
    cells = S * TJ
    prows, ct = _up((S + 2) * (TJ + 2), 16), _up(cells, 16)
    parts = [2 * CP * LQKV, 2 * AP * LU, 4 * CP * LM, 12 * AP, 4 * CP, 4 * nh, 64 * nh, 4 * DP,
             2 * prows * LU, 2 * prows * LQKV, 4 * prows * LQK, 2 * 2 * cells * LA, 2 * ct * LCX]
    return sum(_up(b, 16) for b in parts)


def ngram_mma_fwd_tile(B: int, wh: int, ww: int, C: int, D: int, nh: int, hd: int,
                       sms: int) -> Tuple[int, int]:
    """(S, TJ) of the tile K1's tensor-core generic body takes for a [B, wh,
    ww] grid on ``sms`` SMs (``ngram_g::fwd_tile``): the first of
    ``NGRAM_FWD_TILES`` that fits a block, is no wider than the grid and
    still gives every SM a tile; else the smallest."""
    for S, TJ in NGRAM_FWD_TILES[:-1]:
        tiles = B * -(-wh // S) * -(-ww // TJ)
        if (ngram_mma_fwd_bytes(C, D, nh, hd, S, TJ) <= H100_SMEM_PER_BLOCK and TJ <= ww
                and tiles >= sms):
            return S, TJ
    return NGRAM_FWD_TILES[-1]


@functools.lru_cache(maxsize=None)
def ngram_body(C: int, D: int, nh: int, hd: int, dtype: torch.dtype, forward: bool = False) -> str:
    """The body of K7 (of K1 with ``forward``) that runs a [.., C] unigram
    grid with a [2C, D] merge and nh heads of hd at I/O type ``dtype`` (one
    of ``NGRAM_BODIES``), by geometry and dtype alone, as the CUDA sources'
    ``ngram_g::body`` picks it: bfloat16 at the full-width NGswin's
    geometries the flagship bodies, float32 there K1's body templated on the
    heads (K7 has none); bfloat16 the tensor-core generic bodies wherever
    both have a plan (``ngram_mma_plan``, and K1's smallest tile, which fits
    wherever K7's pass 1 does); the rest (float32, the exactness path, and
    what those bodies do not take) the CUDA-core generic bodies."""
    bf16 = dtype == torch.bfloat16
    if (C, D, nh, hd) in NGRAM_FLAGSHIP:
        if bf16:
            return NGRAM_BODIES[0]
        if forward:
            return NGRAM_BODIES[3]
    if (bf16 and ngram_mma_plan(C, D, nh, hd) is not None
            and ngram_mma_fwd_bytes(C, D, nh, hd, *NGRAM_FWD_TILES[-1]) <= H100_SMEM_PER_BLOCK):
        return NGRAM_BODIES[1]
    return NGRAM_BODIES[2]


# ---- K2 / K8: the whole NSTB -----------------------------------------------

def nstb_bytes(N: int, D: int, nh: int, hd: int, H: int) -> int:
    """K2's and K8's CUDA-core generic body: a tile of the whole windows
    that fit in 64 rows (one window past 64 tokens), in three float32 regions, rows padded to an odd
    length: x then y at width D; x_attn, the head outputs and fc2's output
    at max(D, A); qkv, the projection and the hidden layer at max(3A, H, D)."""
    A = nh * hd
    rows = max(1, ROWS // N) * N
    return 4 * rows * ((D + 1) + (max(D, A) + 1) + (max(3 * A, H, D) + 1))


def nstb_envelope(N: int, D: int, nh: int, hd: int, H: int,
                  device: Optional[torch.device] = None,
                  dtype: torch.dtype = torch.float32) -> int:
    """-> the bytes of the body K2 / K8 run for windows of N tokens at width
    D, nh heads of hd, FFN hidden H and I/O type ``dtype``
    (``nstb_body``), or NotImplementedError naming the limit (a block past
    the card's shared memory): the long-window bodies their CUDA-core
    body's largest block (``nstb_long_bytes``, whose FFN tail takes the
    most rows that fit), the bf16 tensor-core generic body its plan's
    (``nstb_mma_plan``), the others the CUDA-core generic body's tile
    (``nstb_bytes``)."""
    kernel = "whole NSTB (K2/K8)"
    if N < 1 or hd < 1 or D < 1 or nh < 1 or H < 1:
        raise ValueError(f"{kernel}: N={N}, D={D}, heads={nh}x{hd}, hidden={H}")
    what = f"N={N}, D={D}, heads={nh}x{hd}, hidden={H}"
    body = nstb_body(N, D, nh, hd, H, dtype)
    if body in NSTB_BODIES[3:]:
        return _fits(kernel, nstb_long_bytes(N, D, nh, hd, H), smem_limit(device),
                     f"the long-window body at {what}")
    if body == NSTB_BODIES[1]:
        return nstb_mma_plan(N, D, nh, hd, H)[1]
    return _fits(kernel, nstb_bytes(N, D, nh, hd, H), smem_limit(device), f"the block at {what}")


def nstb_long_bytes(N: int, D: int, nh: int, hd: int, H: int) -> int:
    """The largest block of K2's and K8's long-window body's launches
    (``csrc/nstb_long.cuh``: ``plan_bytes``): the qkv product at inner width
    D, the attention (``_long_attn_bytes``), and the tail on the most of 32,
    16, ..., 1 token rows that fit a block, [rows] x (A | 1 + 2·(D | 1) +
    H | 1) floats."""
    A = nh * hd

    def tail(rows):
        return 4 * rows * (_odd(A) + 2 * _odd(D) + _odd(H))

    rows = LONG_ROWS
    while rows > 1 and tail(rows) > H100_SMEM_PER_BLOCK:
        rows //= 2
    return max(_long_gemm_bytes(D), _long_attn_bytes(N, hd), tail(rows))


def nstb_long_plan(N: int, D: int, nh: int, hd: int, H: int) -> Optional[int]:
    """``nstb_long_bytes`` where every launch fits a block (``nstb_long::fits``),
    else None."""
    if min(N, D, nh, hd, H) < 1:
        return None
    nbytes = nstb_long_bytes(N, D, nh, hd, H)
    return nbytes if nbytes <= H100_SMEM_PER_BLOCK else None


# the bodies of K2/K8, in the order of the CUDA sources' codes (nstb_mma::Body)
NSTB_BODIES = ("flagship", "tensor-core generic", "CUDA-core generic", "long-window",
               "tensor-core long-window")
# the full-width NGswin's geometry, which K2/K8's own bodies take: (N, D,
# hidden), then its 6-head (A = 60) and 4-head (A = 64) (heads, head_dim)
NSTB_FLAGSHIP = (64, 64, 128, (6, 10), (4, 16))
NSTB_MMA_WARPS = 8    # warps of a tensor-core generic block
NSTB_MMA_CHUNK = 64   # hidden columns of one of its streamed stages
NSTB_MMA_MAX_D = 128  # the widest D its fragment arrays take


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def nstb_mma_bytes(N: int, D: int, nh: int, hd: int, H: int, resident: bool) -> int:
    """K2's and K8's tensor-core generic body (``csrc/nstb_generic_mma.cuh``:
    ``make_plan``): float32 biases, gains, scales and the bias table; the bf16
    weights [in][out] with rows padded by 8, all of them (``resident``) or
    one stage's slices (a head's q/k/v columns and projection rows, 64 hidden
    columns of fc1 and rows of fc2); per window group, two slots of the tile
    (N padded to 16 rows, D to 16 columns) and its four context quads and
    two head buffers of k_n and v."""
    ws = round(N ** 0.5)
    DP, HP = _up(D, 16), 16 if hd <= 16 else 32
    AP, NP = nh * HP, _up(N, 16)
    G = NSTB_MMA_WARPS // (NP // 16)
    H16 = _up(H, 16)
    floats = _up(3 * AP + 6 * DP + _up(H, NSTB_MMA_CHUNK) + nh + nh * (2 * ws - 1) ** 2, 4)
    if resident:
        weights = DP * (3 * AP + 8) + AP * (DP + 8) + DP * (H16 + 8) + H16 * (DP + 8)
    else:
        weights = (DP * (3 * HP + 8) + HP * (DP + 8) + DP * (NSTB_MMA_CHUNK + 8)
                   + NSTB_MMA_CHUNK * (DP + 8))
    group = 2 * (NP + 4) * (DP + 8) + 4 * NP * (HP + 8)
    return 4 * floats + 2 * (weights + G * group)


def nstb_mma_plan(N: int, D: int, nh: int, hd: int, H: int) -> Optional[Tuple[bool, int]]:
    """-> (resident, bytes) of the tensor-core generic body's launch
    (``csrc/nstb_generic_mma.cuh``: ``plan``), or None where it takes no
    plan: D not a multiple of 8 (16-byte rows) or past 128, head_dim past
    32, a window past 64 tokens, or weights that fit no block resident
    (the card's shared memory) and cannot be streamed (head_dim and H
    multiples of 8)."""
    if not (1 <= N <= ROWS and 8 <= D <= NSTB_MMA_MAX_D and D % 8 == 0 and 1 <= hd <= HEAD_DIM_MAX
            and nh >= 1 and H >= 1):
        return None
    nbytes = nstb_mma_bytes(N, D, nh, hd, H, True)
    if nbytes <= H100_SMEM_PER_BLOCK:
        return True, nbytes
    if hd % 8 or H % 8:
        return None
    nbytes = nstb_mma_bytes(N, D, nh, hd, H, False)
    return (False, nbytes) if nbytes <= H100_SMEM_PER_BLOCK else None


@functools.lru_cache(maxsize=None)
def nstb_body(N: int, D: int, nh: int, hd: int, H: int, dtype: torch.dtype) -> str:
    """The body of K2 and K8 that runs windows of N tokens at width D, nh
    heads of hd, hidden H and I/O type ``dtype`` (one of ``NSTB_BODIES``),
    by geometry and dtype alone, as the CUDA sources' ``nstb_mma::body``
    picks it: the full-width NGswin's geometry (window 8, D 64, hidden 128,
    6 x 10 or 4 x 16 heads) its own bodies; bfloat16 the tensor-core generic
    body wherever it has a plan (``nstb_mma_plan``); the rest (float32, the
    exactness path, and the bf16 geometries that body does not take) the
    CUDA-core generic body.  Windows past 64 tokens and heads wider than 32
    channels (``long_window``) the long-window bodies: bfloat16 the
    tensor-core one wherever it has a plan (``nstb_long_tc_plan``), the rest
    the CUDA-core one.  Where the CUDA-core generic body would run but its
    tile fits no block (``nstb_bytes``: D = 186 at hidden 2·D with 6 heads,
    D = 256 with 8 heads of 32 and hidden 1024), the long-window bodies by
    the same choice; no other geometry moves."""
    bf16 = dtype == torch.bfloat16
    long = NSTB_BODIES[4 if bf16 and nstb_long_tc_plan(N, D, nh, hd, H) else 3]
    if long_window(N, hd):
        return long
    if (N, D, H) == NSTB_FLAGSHIP[:3] and (nh, hd) in NSTB_FLAGSHIP[3:]:
        return NSTB_BODIES[0]
    if bf16 and nstb_mma_plan(N, D, nh, hd, H) is not None:
        return NSTB_BODIES[1]
    return NSTB_BODIES[2] if nstb_bytes(N, D, nh, hd, H) <= H100_SMEM_PER_BLOCK else long


# ---- the CUDA sources' own counts ----------------------------------------------

# query -> (kernel library, C function, its int arguments): (D, hidden
# columns a chunk, rows a tile) of ffn_fwd_bytes and ffn_bwd_bytes (the
# chunk is all of hidden where one row fits), (D, hidden) for K6's and for K5's
# tensor-core generic body (ffn_mma_plan's and ffn_mma_fwd_plan's bytes, -1
# without a plan), attention_fwd_bytes, attention_bwd_bytes,
# (N, D, heads, head_dim) for K3's tensor-core generic body and the same
# with the launch (1 per window, 2 the token sums) last for K4's (the
# entries of attention_mma_bytes, -1 without a plan), (N, D, heads,
# head_dim) for K3's and K4's short-window body (attention_short_plan's
# bytes, -1 without a plan), ngram_fwd_bytes, ngram_bwd_bytes with the pass (1 or 2) last, the same
# for K7's tensor-core generic body (ngram_mma_bytes, -1 without a plan),
# ngram_mma_fwd_bytes for K1's (-1 without a plan), for each
# of K2 and K8 (N, D, heads, head_dim, hidden) with the generic body's code
# last (1: nstb_mma_bytes of its plan, -1 without one; 2: nstb_bytes; 3:
# nstb_long_plan's bytes, -1 without a plan; 4: nstb_long_tc_plan's bytes,
# -1 without one), and (N, D, heads, head_dim) with K3 (1) or K4 (2) last
# for the CUDA-core long-window bodies (attention_long_plan's entries, -1
# without a plan), K3 (3) or K4 (4) for the tensor-core ones
# (attention_long_tc_plan's)
SMEM_QUERIES = {
    "ffn_fwd": ("residual_ffn_fwd", "tmar_residual_ffn_fwd_smem", 3),
    "ffn_bwd": ("residual_ffn_bwd", "tmar_residual_ffn_bwd_smem", 3),
    "ffn_bwd_mma": ("residual_ffn_bwd", "tmar_residual_ffn_bwd_mma_smem", 2),
    "ffn_fwd_mma": ("residual_ffn_fwd", "tmar_residual_ffn_fwd_mma_smem", 2),
    "attention_fwd": ("window_attention_fwd", "tmar_window_attention_fwd_smem", 4),
    "attention_bwd": ("window_attention_bwd", "tmar_window_attention_bwd_smem", 4),
    "attention_fwd_mma": ("window_attention_fwd", "tmar_window_attention_fwd_mma_smem", 4),
    "attention_bwd_mma": ("window_attention_bwd", "tmar_window_attention_bwd_mma_smem", 5),
    "attention_fwd_short": ("window_attention_fwd", "tmar_window_attention_fwd_short_smem", 4),
    "attention_bwd_short": ("window_attention_bwd", "tmar_window_attention_bwd_short_smem", 4),
    "ngram_fwd": ("ngram_context", "tmar_ngram_context_smem", 3),
    "ngram_bwd": ("ngram_context_bwd", "tmar_ngram_context_bwd_smem", 5),
    "ngram_bwd_mma": ("ngram_context_bwd", "tmar_ngram_context_bwd_mma_smem", 5),
    "ngram_fwd_mma": ("ngram_context", "tmar_ngram_context_mma_smem", 6),
    "nstb_map": ("nstb_map", "tmar_nstb_map_smem", 6),
    "nstb_tokens": ("nstb_tokens", "tmar_nstb_tokens_smem", 6),
    "attention_long": ("window_attention_fwd", "tmar_window_attention_fwd_long_smem", 5),
}


def built_smem(query: str, *dims: int) -> int:
    """The shared memory, in bytes, that the built CUDA source launches a
    generic body with (``SMEM_QUERIES``); needs a CUDA host."""
    from tmar_torch import kernels

    lib, symbol, n = SMEM_QUERIES[query]
    fn = kernels.host_function(lib, symbol, [ctypes.c_int] * n, ctypes.c_longlong)
    return int(fn(*dims))


def built_nstb_body(lib: str, N: int, D: int, nh: int, hd: int, H: int,
                    dtype: torch.dtype) -> str:
    """The body that the built CUDA source of K2 (``lib`` "nstb_map") or K8
    ("nstb_tokens") picks (its ``tmar_*_body`` query), as ``nstb_body``
    names it; needs a CUDA host."""
    from tmar_torch import kernels

    fn = kernels.host_function(lib, f"tmar_{lib}_body", [ctypes.c_int] * 6, ctypes.c_int)
    return NSTB_BODIES[int(fn(N, D, nh, hd, H, int(dtype == torch.bfloat16)))]


def built_attention_body(lib: str, N: int, D: int, nh: int, hd: int, dtype: torch.dtype) -> str:
    """The body that the built CUDA source of K3 (``lib``
    "window_attention_fwd") or K4 ("window_attention_bwd") picks (its
    ``tmar_*_body`` query), as ``attention_body`` names it; needs a CUDA
    host."""
    from tmar_torch import kernels

    fn = kernels.host_function(lib, f"tmar_{lib}_body", [ctypes.c_int] * 5, ctypes.c_int)
    return ATTENTION_BODIES[int(fn(N, D, nh, hd, int(dtype == torch.bfloat16)))]


def built_ffn_body(D: int, H: int, dtype: torch.dtype, lib: str = "residual_ffn_bwd") -> str:
    """The body that the built CUDA source of K6 (``lib``
    "residual_ffn_bwd") or K5 ("residual_ffn_fwd") picks (its
    ``tmar_*_body`` query), as ``ffn_body`` names it; needs a CUDA host."""
    from tmar_torch import kernels

    fn = kernels.host_function(lib, f"tmar_{lib}_body", [ctypes.c_int] * 3, ctypes.c_int)
    return FFN_BODIES[int(fn(D, H, int(dtype == torch.bfloat16)))]


def built_ngram_body(C: int, D: int, nh: int, hd: int, dtype: torch.dtype,
                     lib: str = "ngram_context_bwd") -> str:
    """The body that the built CUDA source of K7 (``lib``
    "ngram_context_bwd") or K1 ("ngram_context") picks (its ``tmar_*_body``
    query), as ``ngram_body`` names it (with ``forward`` for K1); needs a
    CUDA host."""
    from tmar_torch import kernels

    fn = kernels.host_function(lib, f"tmar_{lib}_body", [ctypes.c_int] * 5, ctypes.c_int)
    return NGRAM_BODIES[int(fn(C, D, nh, hd, int(dtype == torch.bfloat16)))]


def built_ngram_tile(B: int, wh: int, ww: int, C: int, D: int, nh: int, hd: int,
                     sms: int) -> Tuple[int, int]:
    """(S, TJ) of the tile the built CUDA source of K1 takes on its
    tensor-core generic body (``tmar_ngram_context_tile``), as
    ``ngram_mma_fwd_tile`` picks it; needs a CUDA host."""
    from tmar_torch import kernels

    fn = kernels.host_function("ngram_context", "tmar_ngram_context_tile", [ctypes.c_int] * 8,
                               ctypes.c_int)
    return divmod(int(fn(B, wh, ww, C, D, nh, hd, sms)), 100)
