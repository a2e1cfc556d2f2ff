"""The widths the kernels take (K1-K8), as plain functions of the shapes.

Each kernel has a runtime-dimension body (``csrc/*.cu``, "the generic
body") beside the full-width NGswin's bodies, which takes D, hidden, C, the
head count, head_dim and the window length at run time and sizes its
dynamic shared memory at launch.
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
from typing import Optional

import torch

# the opt-in shared memory of one sm_90 block, and of one SM
H100_SMEM_PER_BLOCK = 232448
H100_SMEM_PER_SM = 233472
HEAD_DIM_MAX = 32   # the generic bodies keep a head's row in registers
ROWS = 64           # token rows of a window-attention / FFN-forward tile
THREADS = 256       # threads of a generic block
NGRAM_TJ = 32       # K1's cells per block (a grid row's segment)
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


# ---- K2 / K8: the whole NSTB -----------------------------------------------

def nstb_bytes(N: int, D: int, nh: int, hd: int, H: int) -> int:
    """K2's and K8's generic body: a tile of the whole windows that fit in
    64 rows, in three float32 regions, rows padded to an odd length: x then
    y at width D; x_attn, the head outputs and fc2's output at max(D, A);
    qkv, the projection and the hidden layer at max(3A, H, D)."""
    A = nh * hd
    rows = (ROWS // N) * N
    return 4 * rows * ((D + 1) + (max(D, A) + 1) + (max(3 * A, H, D) + 1))


def nstb_envelope(N: int, D: int, nh: int, hd: int, H: int,
                  device: Optional[torch.device] = None) -> int:
    """-> K2's / K8's generic body's bytes for windows of N tokens at width
    D, nh heads of hd, FFN hidden H, or NotImplementedError naming the limit
    (a window past 64 tokens, head_dim past 32, the tile past the card's
    shared memory).  The FFN tail is not cut into chunks: past the card's
    bytes the refusal names them, as K5's does."""
    kernel = "whole NSTB (K2/K8)"
    if not 1 <= N <= ROWS:
        raise _refuse(kernel, f"a window of N={N} tokens is past the bound N <= {ROWS}")
    _head_dim(kernel, hd)
    if D < 1 or nh < 1 or H < 1:
        raise ValueError(f"{kernel}: D={D}, heads={nh}, hidden={H}")
    return _fits(kernel, nstb_bytes(N, D, nh, hd, H), smem_limit(device),
                 f"the block at N={N}, D={D}, heads={nh}x{hd}, hidden={H}")


# ---- the CUDA sources' own counts ----------------------------------------------

# query -> (kernel library, C function, its int arguments): the arguments of
# ffn_fwd_bytes, ffn_bwd_bytes, attention_fwd_bytes, attention_bwd_bytes,
# ngram_fwd_bytes, ngram_bwd_bytes with the pass (1 or 2) last, and
# nstb_bytes for each of K2 and K8
SMEM_QUERIES = {
    "ffn_fwd": ("residual_ffn_fwd", "tmar_residual_ffn_fwd_smem", 2),
    "ffn_bwd": ("residual_ffn_bwd", "tmar_residual_ffn_bwd_smem", 3),
    "attention_fwd": ("window_attention_fwd", "tmar_window_attention_fwd_smem", 4),
    "attention_bwd": ("window_attention_bwd", "tmar_window_attention_bwd_smem", 4),
    "ngram_fwd": ("ngram_context", "tmar_ngram_context_smem", 3),
    "ngram_bwd": ("ngram_context_bwd", "tmar_ngram_context_bwd_smem", 5),
    "nstb_map": ("nstb_map", "tmar_nstb_map_smem", 5),
    "nstb_tokens": ("nstb_tokens", "tmar_nstb_tokens_smem", 5),
}


def built_smem(query: str, *dims: int) -> int:
    """The shared memory, in bytes, that the built CUDA source launches a
    generic body with (``SMEM_QUERIES``); needs a CUDA host."""
    from tmar_torch import kernels

    lib, symbol, n = SMEM_QUERIES[query]
    fn = kernels.host_function(lib, symbol, [ctypes.c_int] * n, ctypes.c_longlong)
    return int(fn(*dims))
