"""The widths the kernels take (K1-K8), as plain functions of the shapes.

Each kernel has a runtime-dimension body (``csrc/*.cu``, "the generic
body") beside the full-width NGswin's bodies, which takes D, hidden, C, the
head count, head_dim and the window length at run time and sizes its
dynamic shared memory at launch.  Each has two: a tensor-core one for
bfloat16 and a CUDA-core one; ``nstb_body``, ``attention_body``,
``ffn_body`` and ``ngram_body`` say which body runs a call.
What bounds it is the card's opt-in shared memory per block
(``cudaDevAttrMaxSharedMemoryPerBlockOptin``, 232,448 bytes on an H100) and
the per-thread head registers (head_dim <= 32).  The functions below count
the shared memory as the CUDA sources do (each source's ``tmar_*_smem``
query gives its own count, ``built_smem``; a GPU test holds the two equal),
pick the tile sizes the generic bodies are launched with, and refuse, with
a ``NotImplementedError`` that names the limit, only what lies past them.
Weights are read from device memory (L2) by the generic bodies, so their
size bounds nothing.

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
HEAD_DIM_MAX = 32   # the generic bodies keep a head's row in registers
ROWS = 64           # token rows of a window-attention / FFN-forward tile
THREADS = 256       # threads of a generic block
NGRAM_TJ = 32       # K1's CUDA-core generic body's cells per block (a grid row's segment)
NGRAM_BWD_TJ = 16   # K7's cells per pass-1 tile
NGRAM_BWD_TP = 32   # K7's positions per pass-2 tile


def smem_limit(device: Optional[torch.device] = None) -> int:
    """The opt-in shared memory of one block on ``device`` (the H100's
    figure without a CUDA device)."""
    if device is not None and device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        return int(getattr(props, "shared_memory_per_block_optin", H100_SMEM_PER_BLOCK))
    return H100_SMEM_PER_BLOCK


def _refuse(kernel: str, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{kernel}: {what}.  The generic bodies take any width whose tile fits the card's "
        "shared memory, head_dim <= 32 and windows of at most 64 tokens; past that only "
        "the plain version computes it, on the CPU (ROADMAP queue 2)")


def _head_dim(kernel: str, hd: int) -> None:
    if not 1 <= hd <= HEAD_DIM_MAX:
        raise _refuse(kernel, f"head_dim {hd} is past the bound head_dim <= {HEAD_DIM_MAX}")


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

def ffn_fwd_bytes(D: int, H: int) -> int:
    """K5's generic body: y, hidden and fc2's output of a 64-row tile."""
    return 4 * ROWS * (2 * (D + 1) + H + 1)


def ffn_bwd_bytes(D: int, H: int, rows: int) -> int:
    """K6's generic body: n1, y, o, dz of a tile of ``rows`` rows at width D,
    u and h at the hidden width, the two rows' LayerNorm scales."""
    return 4 * rows * (4 * (D + 1) + 2 * (H + 1) + 2)


def ffn_envelope(D: int, H: int, device: Optional[torch.device] = None):
    """-> (K5's bytes, K6's rows per tile, K6's bytes) for (D, hidden), or
    NotImplementedError naming the limit.  K6 takes 64-row tiles where they
    fit, else 32 or 16."""
    limit = smem_limit(device)
    kernel = "residual FFN (K5/K6)"
    if D < 1 or H < 1:
        raise ValueError(f"{kernel}: D={D}, hidden={H}")
    fwd = _fits(kernel, ffn_fwd_bytes(D, H), limit, f"the forward at D={D}, hidden={H}")
    for rows in (64, 32, 16):
        if ffn_bwd_bytes(D, H, rows) <= limit:
            return fwd, rows, ffn_bwd_bytes(D, H, rows)
    _fits(kernel, ffn_bwd_bytes(D, H, 16), limit, f"the backward at D={D}, hidden={H}")


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
                    "tensor-core short-window")
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
    bfloat16 widths without a plan) the CUDA-core generic bodies."""
    bf16 = dtype == torch.bfloat16
    if bf16 and (N, D, nh, hd) in ATTENTION_MMA_GEOMETRIES:
        return ATTENTION_BODIES[0]
    if (N, D, nh, hd) in ATTENTION_KERNEL_GEOMETRIES:
        return ATTENTION_BODIES[1]
    if bf16 and N < ATTN_MMA_MIN_N and attention_short_plan(N, D, nh, hd) is not None:
        return ATTENTION_BODIES[4]
    if bf16 and attention_mma_plan(N, D, nh, hd) is not None:
        return ATTENTION_BODIES[2]
    return ATTENTION_BODIES[3]


def attention_envelope(N: int, D: int, nh: int, hd: int,
                       device: Optional[torch.device] = None):
    """-> (K3's heads per group, K3's bytes, K4's heads per group, K4's
    bytes): each the most heads whose tile fits, or NotImplementedError
    naming the limit (a window longer than a 64-row tile, head_dim past 32,
    one head's tile past the card's shared memory)."""
    limit = smem_limit(device)
    kernel = "window attention (K3/K4)"
    if not 1 <= N <= ROWS:
        raise _refuse(kernel, f"a window of N={N} tokens is past the bound N <= {ROWS} "
                              "(one window to a 64-row tile)")
    _head_dim(kernel, hd)
    if D < 1 or nh < 1:
        raise ValueError(f"{kernel}: D={D}, heads={nh}")
    out = []
    for size in (lambda g: attention_fwd_bytes(D, nh, hd, g),
                 lambda g: attention_bwd_bytes(N, D, hd, g)):
        _fits(kernel, size(1), limit, f"one head at N={N}, D={D}, heads={nh}x{hd}")
        hg = max(g for g in range(1, nh + 1) if size(g) <= limit)
        out += [hg, size(hg)]
    return tuple(out)


# ---- K1 / K7: the n-gram context ---------------------------------------------

def ngram_fwd_bytes(C: int, nh: int, hd: int) -> int:
    """K1's generic body: u and q/k/v of the 3 x (TJ + 2) staged positions,
    the mean tokens and ctx of TJ cells in both directions."""
    A = nh * hd
    npos = 3 * (NGRAM_TJ + 2)
    return 4 * (npos * C + npos * (3 * A + 1) + NGRAM_TJ * 2 * A + NGRAM_TJ * 2 * C)


def ngram_bwd_bytes(C: int, D: int, nh: int, hd: int):
    """(pass 1, pass 2) of K7's generic body.  Pass 1: u and q/k/v of the
    staged positions, g, dctx, dacc, the mean tokens, ctx, ds and the
    dscale shares of TJ cells; pass 2: u, raw q/k and the cotangents of TP
    positions."""
    A = nh * hd
    tj = NGRAM_BWD_TJ
    npos = 3 * (tj + 2)
    p1 = (npos * C + npos * (3 * A + 1) + tj * D + tj * 2 * C + tj * 2 * A + tj * 2 * A
          + tj * 2 * C + tj * 2 * 16 * nh + tj * 2 * nh)
    p2 = NGRAM_BWD_TP * ((C + 1) + 2 * (3 * A + 1))
    return 4 * p1, 4 * p2


def ngram_envelope(C: int, D: int, nh: int, hd: int, device: Optional[torch.device] = None):
    """-> (K1's bytes, K7's pass-1 bytes, K7's pass-2 bytes) on a [.., C]
    unigram grid with a [2C, D] merge, or NotImplementedError naming the
    limit."""
    limit = smem_limit(device)
    kernel = "n-gram context (K1/K7)"
    _head_dim(kernel, hd)
    if C < 1 or D < 1 or nh < 1:
        raise ValueError(f"{kernel}: C={C}, D={D}, heads={nh}")
    what = f"C={C}, D={D}, heads={nh}x{hd}"
    fwd = _fits(kernel, ngram_fwd_bytes(C, nh, hd), limit, f"the forward at {what}")
    p1, p2 = ngram_bwd_bytes(C, D, nh, hd)
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
    that fit in 64 rows, in three float32 regions, rows padded to an odd
    length: x then y at width D; x_attn, the head outputs and fc2's output
    at max(D, A); qkv, the projection and the hidden layer at max(3A, H, D)."""
    A = nh * hd
    rows = (ROWS // N) * N
    return 4 * rows * ((D + 1) + (max(D, A) + 1) + (max(3 * A, H, D) + 1))


def nstb_envelope(N: int, D: int, nh: int, hd: int, H: int,
                  device: Optional[torch.device] = None) -> int:
    """-> K2's / K8's CUDA-core generic body's bytes for windows of N tokens
    at width D, nh heads of hd, FFN hidden H, or NotImplementedError naming
    the limit (a window past 64 tokens, head_dim past 32, the tile past the
    card's shared memory).  The FFN tail is not cut into chunks: past the
    card's bytes the refusal names them, as K5's does.  This is K2's and
    K8's envelope at either dtype; inside it ``nstb_body`` picks the body."""
    kernel = "whole NSTB (K2/K8)"
    if not 1 <= N <= ROWS:
        raise _refuse(kernel, f"a window of N={N} tokens is past the bound N <= {ROWS}")
    _head_dim(kernel, hd)
    if D < 1 or nh < 1 or H < 1:
        raise ValueError(f"{kernel}: D={D}, heads={nh}, hidden={H}")
    return _fits(kernel, nstb_bytes(N, D, nh, hd, H), smem_limit(device),
                 f"the block at N={N}, D={D}, heads={nh}x{hd}, hidden={H}")


# the bodies of K2/K8, in the order of the CUDA sources' codes (nstb_mma::Body)
NSTB_BODIES = ("flagship", "tensor-core generic", "CUDA-core generic")
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


def nstb_body(N: int, D: int, nh: int, hd: int, H: int, dtype: torch.dtype) -> str:
    """The body of K2 and K8 that runs windows of N tokens at width D, nh
    heads of hd, hidden H and I/O type ``dtype`` (one of ``NSTB_BODIES``),
    by geometry and dtype alone, as the CUDA sources' ``nstb_mma::body``
    picks it: the full-width NGswin's geometry (window 8, D 64, hidden 128,
    6 x 10 or 4 x 16 heads) its own bodies; bfloat16 the tensor-core generic
    body wherever it has a plan (``nstb_mma_plan``); the rest (float32, the
    exactness path, and the bf16 geometries that body does not take) the
    CUDA-core generic body."""
    if (N, D, H) == NSTB_FLAGSHIP[:3] and (nh, hd) in NSTB_FLAGSHIP[3:]:
        return NSTB_BODIES[0]
    if dtype == torch.bfloat16 and nstb_mma_plan(N, D, nh, hd, H) is not None:
        return NSTB_BODIES[1]
    return NSTB_BODIES[2]


# ---- the CUDA sources' own counts ----------------------------------------------

# query -> (kernel library, C function, its int arguments): the arguments of
# ffn_fwd_bytes, ffn_bwd_bytes, (D, hidden) for K6's and for K5's
# tensor-core generic body (ffn_mma_plan's and ffn_mma_fwd_plan's bytes, -1
# without a plan), attention_fwd_bytes, attention_bwd_bytes,
# (N, D, heads, head_dim) for K3's tensor-core generic body and the same
# with the launch (1 per window, 2 the token sums) last for K4's (the
# entries of attention_mma_bytes, -1 without a plan), (N, D, heads,
# head_dim) for K3's and K4's short-window body (attention_short_plan's
# bytes, -1 without a plan), ngram_fwd_bytes, ngram_bwd_bytes with the pass (1 or 2) last, the same
# for K7's tensor-core generic body (ngram_mma_bytes, -1 without a plan),
# ngram_mma_fwd_bytes for K1's (-1 without a plan), and for each
# of K2 and K8 (N, D, heads, head_dim, hidden) with the generic body's code
# last (1: nstb_mma_bytes of its plan, -1 without one; 2: nstb_bytes)
SMEM_QUERIES = {
    "ffn_fwd": ("residual_ffn_fwd", "tmar_residual_ffn_fwd_smem", 2),
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
