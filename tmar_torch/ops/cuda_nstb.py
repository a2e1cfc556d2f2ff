"""A whole NSTB: plain versions and the wrappers of its two CUDA kernels.

The counterpart of ``tmar.ops.pallas_nstb``.  The n-gram context is added
per window BEFORE the cyclic shift, so after a roll by ``shift`` each
shifted window covers a 2x2 neighbourhood of pre-shift windows and its
context is constant per quadrant: ``ctx_tok = sel @ ctx_quads[window]``.
Then

    x_attn = x + ctx_tok
    a      = window_attention(x_attn)
    y      = x + LN1(a)                      (residual WITHOUT the context)
    z      = y + LN2(fc2(GELU(fc1(y))))

Two forms of one function, both forward-only:

* ``fused_nstb_map`` (map mode, the default): the unrolled map in, roll and
  window partition in the kernel, ``csrc/nstb_map.cu`` (K2);
* ``fused_nstb`` (token mode, the JAX package's ``TMAR_NSTB_MAP=0``): the
  windows of the rolled map in, ``csrc/nstb_tokens.cu`` (K8).

Each runs its plain version for a CPU tensor and launches its kernel for a
CUDA tensor, through the operator ``tmar::nstb_map`` / ``tmar::nstb_tokens``
(one node of a ``torch.export`` program), or raises.  Both return the block output in ROLLED space; the
caller unpartitions (token mode) and applies the reverse cyclic shift.

On the card the kernel picks its body by geometry and dtype alone
(``envelope.nstb_body``, the CUDA sources' ``nstb_mma::body``): the
full-width NGswin's (``envelope.NSTB_FLAGSHIP``) runs its
own bodies, the tensor-core one at bfloat16 and the templated float32 one at
float32; every other geometry inside ``envelope.nstb_envelope`` runs a
generic body, at bfloat16 the tensor-core one (``csrc/nstb_generic_mma.cuh``)
wherever it has a plan, else the CUDA-core one (``csrc/nstb_generic.cuh``);
windows of more than 64 tokens (HAT's 16x16), heads wider than 32
channels, and the widths whose CUDA-core generic tile fits no block (D =
256 with 8 heads of 32 and hidden 1024, Swin-B's stage 2) run the
long-window bodies, over a workspace the wrapper allocates: at bfloat16 the tensor-core one wherever
``envelope.nstb_long_tc_plan`` has a plan (``csrc/nstb_long.cuh:
launch_tc`` over ``csrc/long_mma.cuh``), else the CUDA-core one
(``csrc/nstb_long.cuh: launch``).  A geometry past the envelope
raises ``NotImplementedError`` naming the limit; a build or launch failure
raises, and nothing gives way to another
body or to the plain version.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from tmar_torch import kernels
from tmar_torch.device import aligned, refuse_grad
from tmar_torch.ops import envelope
from tmar_torch.ops.attention import (
    LOGIT_SCALE_MAX,
    add_shift_mask,
    gather_rel_pos_bias,
    merge_heads,
    relative_position_index,
    split_heads,
)
from tmar_torch.ops.ffn import gelu_as_kernels, layer_norm
from tmar_torch.ops.window import (
    cyclic_shift,
    shift_mask_components,
    window_partition,
    window_unpartition,
)

def quadrant_selector(window_size: int, shift_size: int) -> np.ndarray:
    """[N, 4] one-hot: token (r, c) -> which pre-shift window (own / right /
    down / down-right) its context comes from after a roll by ``shift_size``."""
    ws = window_size
    sel = np.zeros((ws * ws, 4), np.float32)
    for r in range(ws):
        for c in range(ws):
            qr = 1 if (shift_size > 0 and r >= ws - shift_size) else 0
            qc = 1 if (shift_size > 0 and c >= ws - shift_size) else 0
            sel[r * ws + c, 2 * qr + qc] = 1.0
    return sel


def context_quads(ctx: torch.Tensor, shift_size: int) -> torch.Tensor:
    """ctx [B, wh, ww, D] -> [B, wh, ww, 4, D]: each window's own context and
    its right / down / down-right neighbours (cyclic)."""
    if shift_size == 0:
        return ctx[:, :, :, None, :].expand(*ctx.shape[:3], 4, ctx.shape[-1])
    right = torch.roll(ctx, -1, dims=2)
    down = torch.roll(ctx, -1, dims=1)
    downright = torch.roll(down, -1, dims=2)
    return torch.stack([ctx, right, down, downright], dim=3)


def nstb_math(
    x, ctx_quads, sel,
    wqkv, bqkv, logit_scale, bias, wproj, bproj,
    g1, b1, w1, bw1, w2, bw2, g2, b2,
    num_heads, mask_components=None, eps=1e-5, compute_dtype=torch.float32,
):
    """Token-level NSTB: x [B_, N, D] context-free rolled windows,
    ctx_quads [B_, Q, D], sel [N, Q], bias the gathered RPB [nh, N, N].

    Computes in ``compute_dtype`` (float32; float64 evaluates the same
    function between its rounding points more exactly) and rounds to x's
    dtype where the JAX kernel (``tmar.ops.pallas_nstb._nstb_body``) and the
    kernels' bfloat16 body round: the context quads and the four matrices on
    input; x_attn; q_n, k_n and v; P after its normalisation; the attention
    output before the projection; y before fc1; the GELU output before fc2;
    the output.  The biases, the LayerNorms and every statistic stay in
    ``compute_dtype``; the GELU's erf is the kernels' (``gelu_as_kernels``).
    At float32 every rounding is the identity."""
    cd, acc = x.dtype, compute_dtype

    def r(t):
        return t.to(cd).to(acc)

    def f(t):
        return t.to(acc)

    def l2n(t):  # l2_normalize in the compute dtype
        return t * (t.square().sum(-1, keepdim=True).sqrt() + 1e-12).reciprocal()

    x32 = f(x)
    sel_t = torch.as_tensor(sel, dtype=acc, device=x.device)
    x_attn = r(x32 + torch.einsum("nq,bqd->bnd", sel_t, r(ctx_quads)))
    qkv = x_attn @ r(wqkv)
    if bqkv is not None:
        qkv = qkv + f(bqkv)
    q, k, v = (split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    attn = torch.matmul(r(l2n(q)), r(l2n(k)).transpose(-1, -2))
    scale = torch.exp(torch.clamp(f(logit_scale), max=LOGIT_SCALE_MAX))
    attn = add_shift_mask(attn * scale[None] + f(bias)[None], mask_components)
    attn = torch.exp(attn - attn.amax(-1, keepdim=True))
    attn = attn / attn.sum(-1, keepdim=True)
    a = r(merge_heads(torch.matmul(r(attn), r(v)))) @ r(wproj)
    if bproj is not None:
        a = a + f(bproj)
    y = x32 + layer_norm(a, f(g1), f(b1), eps)
    h = gelu_as_kernels(r(y) @ r(w1) + f(bw1))
    z = y + layer_norm(r(h) @ r(w2) + f(bw2), f(g2), f(b2), eps)
    return z.to(cd)


def nstb_tokens_math(
    x, ctx_quads, wqkv, bqkv, logit_scale, table, wproj, bproj,
    ln1, ffn1, ffn2, ln2, *, num_heads, window_size, shift=0, grid=None, eps=1e-5,
    compute_dtype=torch.float32,
):
    """Plain version of the token-level block.  Arguments as in
    ``fused_nstb``; ``compute_dtype`` as ``nstb_math`` takes it."""
    B_, N, D = x.shape
    ws = window_size
    sel, mask_components = _selector_and_mask(ctx_quads.shape[1], ws, shift, grid)
    bias = gather_rel_pos_bias(table, relative_position_index(ws, ws), num_heads)
    return nstb_math(
        x, ctx_quads, sel, wqkv, bqkv, logit_scale, bias, wproj, bproj, ln1[0], ln1[1],
        ffn1[0], ffn1[1], ffn2[0], ffn2[1], ln2[0], ln2[1],
        num_heads=num_heads, mask_components=mask_components, eps=eps,
        compute_dtype=compute_dtype,
    )


def nstb_map_math(
    xmap, ctx_quads, wqkv, bqkv, logit_scale, table, wproj, bproj,
    ln1, ffn1, ffn2, ln2, *, num_heads, window_size, shift=0, eps=1e-5,
    compute_dtype=torch.float32,
):
    """Plain version of the map-level block: roll, partition,
    ``nstb_tokens_math``, unpartition.  Arguments as in ``fused_nstb_map``;
    ``compute_dtype`` as ``nstb_math`` takes it."""
    B, ph, pw, D = xmap.shape
    ws = window_size
    wh, ww = ph // ws, pw // ws
    wins, _ = window_partition(cyclic_shift(xmap, shift), ws)
    z = nstb_tokens_math(
        wins.reshape(-1, ws * ws, D), ctx_quads, wqkv, bqkv, logit_scale, table, wproj,
        bproj, ln1, ffn1, ffn2, ln2, num_heads=num_heads, window_size=ws, shift=shift,
        grid=(wh, ww), eps=eps, compute_dtype=compute_dtype,
    )
    return window_unpartition(z.reshape(-1, ws, ws, D), (wh, ww))


def _selector_and_mask(Q, ws, shift, grid):
    """Q = 1: every token reads its own window's context; Q = 4: the 2x2
    quadrant selector.  The shift mask exists only for shifted blocks, on
    the window grid ``grid`` = (wh, ww) of one image."""
    sel = np.ones((ws * ws, 1), np.float32) if Q == 1 else quadrant_selector(ws, shift)
    mask = None
    if shift > 0:
        if grid is None:
            raise ValueError("a shifted block needs the window grid (wh, ww) of its mask")
        m_row, m_col = shift_mask_components(ws, shift)
        mask = (m_row, m_col, *grid)
    return sel, mask


def fused_nstb_map(
    xmap: torch.Tensor,
    ctx_quads: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: Optional[torch.Tensor],
    logit_scale: torch.Tensor,
    table: torch.Tensor,
    wproj: torch.Tensor,
    bproj: Optional[torch.Tensor],
    ln1: Tuple[torch.Tensor, torch.Tensor],
    ffn1: Tuple[torch.Tensor, torch.Tensor],
    ffn2: Tuple[torch.Tensor, torch.Tensor],
    ln2: Tuple[torch.Tensor, torch.Tensor],
    num_heads: int,
    window_size: int,
    shift: int = 0,
    eps: float = 1e-5,
) -> torch.Tensor:
    """xmap [B, ph, pw, D]: the UNROLLED, context-free map.  ctx_quads
    [B·wh·ww, Q, D] in window row-major order, Q = 1 (own context) or 4 (the
    2x2 pre-shift neighbourhood).  wqkv [D, 3A], wproj [A, D], ffn1 = (w1
    [D, H], b1), ffn2 = (w2 [H, D], b2) in the [in, out] layout; ln1/ln2 =
    (gain, bias); table [(2ws-1)², nh] is the relative-position bias table.
    Returns the block output [B, ph, pw, D] in ROLLED space.  A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel or raises.  The
    kernel is forward-only: with autograd on and an argument that requires
    grad it raises (train in the block's training form instead)."""
    weights = (wqkv, bqkv, logit_scale, table, wproj, bproj, ln1, ffn1, ffn2, ln2)
    if xmap.device.type == "cpu":
        return nstb_map_math(
            xmap, ctx_quads, *weights, num_heads=num_heads, window_size=window_size,
            shift=shift, eps=eps,
        )
    if xmap.device.type != "cuda":
        raise ValueError(f"fused_nstb_map: unsupported device {xmap.device}")
    refuse_grad("fused_nstb_map", (xmap, ctx_quads, *_flat(weights)))
    _map_ints(xmap, ctx_quads, wqkv, ffn1, num_heads, window_size, shift)
    return NSTB_MAP(*_layout(xmap, ctx_quads, *weights, num_heads), num_heads, window_size,
                    shift, float(eps))


def fused_nstb(
    x: torch.Tensor,
    ctx_quads: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: Optional[torch.Tensor],
    logit_scale: torch.Tensor,
    table: torch.Tensor,
    wproj: torch.Tensor,
    bproj: Optional[torch.Tensor],
    ln1: Tuple[torch.Tensor, torch.Tensor],
    ffn1: Tuple[torch.Tensor, torch.Tensor],
    ffn2: Tuple[torch.Tensor, torch.Tensor],
    ln2: Tuple[torch.Tensor, torch.Tensor],
    num_heads: int,
    window_size: int,
    shift: int = 0,
    grid: Optional[Tuple[int, int]] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The token-level block (the counterpart of ``tmar.ops.pallas_nstb.
    fused_nstb``).  x [B_, N, D]: the context-free windows of the ROLLED map,
    N = window_size²; ctx_quads [B_, Q, D], Q = 1 (own context) or 4 (the
    2x2 pre-shift neighbourhood; at shift 0 slot 0 is read).  ``grid`` =
    (wh, ww) is the window grid of one image: window b's place in it,
    b mod (wh·ww), gates the shift mask, so a shifted block needs it and B_
    must be a multiple of wh·ww.  The weights as ``fused_nstb_map`` takes
    them.  Returns z [B_, N, D] in rolled window space.

    The JAX op's tiling arguments (``windows_per_step``, ``interpret``)
    shape the TPU grid and have no counterpart here; its ``sel``, ``bias``
    and ``mask_components`` are derived from Q, ``table``, ``shift`` and
    ``grid``.  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel or raises.  Forward-only, as ``fused_nstb_map``."""
    weights = (wqkv, bqkv, logit_scale, table, wproj, bproj, ln1, ffn1, ffn2, ln2)
    if x.device.type == "cpu":
        return nstb_tokens_math(
            x, ctx_quads, *weights, num_heads=num_heads, window_size=window_size,
            shift=shift, grid=grid, eps=eps,
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_nstb: unsupported device {x.device}")
    refuse_grad("fused_nstb", (x, ctx_quads, *_flat(weights)))
    _token_ints(x, ctx_quads, wqkv, ffn1, num_heads, window_size, shift, grid)
    wh, ww = (0, 0) if grid is None else (int(grid[0]), int(grid[1]))
    return NSTB_TOKENS(*_layout(x, ctx_quads, *weights, num_heads), num_heads, window_size,
                       shift, wh, ww, float(eps))


def _flat(weights):
    return [t for w in weights for t in (w if isinstance(w, tuple) else (w,))]


def _geometry(name, n_windows, D, wqkv, ffn1, num_heads, window_size, Q, shift, dtype, device):
    """Check the block's geometry: -> the entry point's (D, H, window, Q,
    shift, heads, head_dim, is_bf16, blocks).  Past ``envelope.nstb_envelope``
    (any geometry but the full-width NGswin's) NotImplementedError names the
    limit.  The entry point picks the body by the rule of
    ``envelope.nstb_body``; ``blocks``, the persistent blocks for
    ``n_windows`` windows, is read by the CUDA-core generic body alone (the
    others size their grids from the card's occupancy or the windows)."""
    A = wqkv.shape[1] // 3
    H = ffn1[0].shape[1]
    if A % num_heads:
        raise ValueError(f"{name}: attention width {A} is not a multiple of {num_heads} heads")
    hd = A // num_heads
    if not 0 <= shift < window_size or Q not in (1, 4):
        raise ValueError(f"{name}: bad Q={Q} or shift={shift} at window {window_size}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported dtype {dtype}")
    N = window_size * window_size
    blocks = 0
    body = envelope.nstb_body(N, D, num_heads, hd, H, dtype)
    if body != envelope.NSTB_BODIES[0]:
        nbytes = envelope.nstb_envelope(N, D, num_heads, hd, H, device, dtype)
    if body == envelope.NSTB_BODIES[2]:  # never a long window: tiles of whole windows
        tiles = -(-n_windows // (envelope.ROWS // N))
        blocks = envelope.blocks_for(tiles, nbytes, kernels.sm_count(device))
    return (D, H, window_size, Q, shift, num_heads, hd, int(dtype == torch.bfloat16), blocks)


def _layout(x, ctx_quads, wqkv, bqkv, logit_scale, table, wproj, bproj, ln1, ffn1, ffn2, ln2,
            num_heads):
    """The 16 input operands in the C entry points' order, as they read
    them, in tensor operations that a trace records: x and the context quads
    contiguous in x's dtype ``cd``, the four matrices in ``cd``, the rest
    float32, the logit scale as exp(min(ls, ln 100)); outside the graph; an
    absent bias stays None."""
    dev, cd = x.device, x.dtype

    def f32(t):
        return None if t is None else t.detach().to(device=dev, dtype=torch.float32).contiguous()

    def mat(t):
        return t.detach().to(device=dev, dtype=cd).contiguous()

    return [
        x.contiguous(), ctx_quads.to(cd).contiguous(),
        mat(wqkv), f32(bqkv),
        torch.exp(torch.clamp(f32(logit_scale).reshape(num_heads), max=LOGIT_SCALE_MAX)),
        f32(table), mat(wproj), f32(bproj),
        f32(ln1[0]), f32(ln1[1]),
        mat(ffn1[0]), f32(ffn1[1]),
        mat(ffn2[0]), f32(ffn2[1]),
        f32(ln2[0]), f32(ln2[1]),
    ]


def _bind(operands):
    """``_layout``'s operands as the entry points take them: each on a
    16-byte boundary, zeros for an absent bias.  Reads data pointers, so it
    runs inside the operator, never in a trace."""
    dev = operands[0].device
    widths = {3: operands[2].shape[1], 7: operands[6].shape[1]}  # bqkv, bproj
    return [aligned(torch.zeros(widths[i], device=dev) if t is None else t)
            for i, t in enumerate(operands)]


def _map_ints(xmap, ctx_quads, wqkv, ffn1, num_heads, window_size, shift):
    """Check K2's geometry: -> the entry point's integer arguments."""
    B, ph, pw, D = xmap.shape
    Q = ctx_quads.shape[1]
    ws = window_size
    wh, ww = ph // ws, pw // ws
    if ph % ws or pw % ws or not (B and wh and ww):
        raise ValueError(f"fused_nstb_map: bad geometry {tuple(xmap.shape)} at window {ws}")
    geo = _geometry("nstb_map", B * wh * ww, D, wqkv, ffn1, num_heads, ws, Q, shift,
                    xmap.dtype, xmap.device)
    if tuple(ctx_quads.shape) != (B * wh * ww, Q, D):
        raise ValueError(f"ctx_quads shape {tuple(ctx_quads.shape)} != {(B * wh * ww, Q, D)}")
    return (B, ph, pw, *geo)


def _token_ints(x, ctx_quads, wqkv, ffn1, num_heads, window_size, shift, grid):
    """Check K8's geometry: -> the entry point's integer arguments."""
    B_, N, D = x.shape
    Q = ctx_quads.shape[1]
    if N != window_size * window_size or B_ < 1:
        raise ValueError(f"fused_nstb: bad window shape {tuple(x.shape)} at window {window_size}")
    geo = _geometry("nstb_tokens", B_, D, wqkv, ffn1, num_heads, window_size, Q, shift,
                    x.dtype, x.device)
    if tuple(ctx_quads.shape) != (B_, Q, D):
        raise ValueError(f"ctx_quads shape {tuple(ctx_quads.shape)} != {(B_, Q, D)}")
    wh, ww = (0, 0) if grid is None else (int(grid[0]), int(grid[1]))
    if shift > 0 and (wh < 1 or ww < 1 or B_ % (wh * ww)):
        raise ValueError(f"fused_nstb: {B_} windows do not fill whole {wh}x{ww} grids")
    return (B_, wh, ww, *geo)


def _kernel_operands(
    xmap, ctx_quads, wqkv, bqkv, logit_scale, table, wproj, bproj,
    ln1, ffn1, ffn2, ln2, num_heads, window_size, shift,
):
    """Check the geometry and lay out K2's operands on xmap's device:
    returns (the 16 input tensors in the C entry point's order, the output,
    the entry point's integer arguments)."""
    ints = _map_ints(xmap, ctx_quads, wqkv, ffn1, num_heads, window_size, shift)
    operands = _bind(_layout(xmap, ctx_quads, wqkv, bqkv, logit_scale, table, wproj, bproj,
                             ln1, ffn1, ffn2, ln2, num_heads))
    return operands, torch.empty_like(operands[0]), ints


def _token_operands(
    x, ctx_quads, wqkv, bqkv, logit_scale, table, wproj, bproj,
    ln1, ffn1, ffn2, ln2, num_heads, window_size, shift, grid,
):
    """Check the geometry and lay out K8's operands on x's device, as
    ``_kernel_operands`` does for K2."""
    ints = _token_ints(x, ctx_quads, wqkv, ffn1, num_heads, window_size, shift, grid)
    operands = _bind(_layout(x, ctx_quads, wqkv, bqkv, logit_scale, table, wproj, bproj,
                             ln1, ffn1, ffn2, ln2, num_heads))
    return operands, torch.empty_like(operands[0]), ints


fused_nstb_map.launches = 0
fused_nstb.launches = 0
# launches by the body that ran them (envelope.NSTB_BODIES' names)
fused_nstb_map.launches_by_body = Counter()
fused_nstb.launches_by_body = Counter()


def _body_name(ints):
    """The body the entry point runs for its integer arguments (``envelope.nstb_body``)."""
    D, H, ws, nh, hd, is_bf16 = ints[3], ints[4], ints[5], ints[8], ints[9], ints[10]
    return envelope.nstb_body(ws * ws, D, nh, hd, H, torch.bfloat16 if is_bf16 else torch.float32)


_ARGTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p]


def _workspace(lib, nwin, ints, device):
    """The float32 workspace of K2 (``lib`` "nstb_map") or K8 ("nstb_tokens")
    for ``nwin`` windows at the entry point's integer arguments ``ints``, as
    the library sizes it (``tmar_*_workspace``: the long-window bodies' qkv
    and head outputs), or None where the body needs none."""
    D, H, ws, nh, hd, is_bf16 = ints[3], ints[4], ints[5], ints[8], ints[9], ints[10]
    if _body_name(ints) not in envelope.NSTB_BODIES[3:]:
        return None
    fn = kernels.host_function(lib, f"tmar_{lib}_workspace", [ctypes.c_int] * 7,
                               ctypes.c_longlong)
    floats = fn(nwin, ws * ws, D, nh, hd, H, is_bf16)
    if floats < 0:
        raise ValueError(f"{lib}: no workspace size for {nwin} windows of {ws}x{ws}")
    return torch.empty(floats, device=device, dtype=torch.float32) if floats else None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(operands, out, ints, eps):
    B, ph, pw, ws = ints[0], ints[1], ints[2], ints[5]
    work = _workspace("nstb_map", B * (ph // ws) * (pw // ws), ints, out.device)
    kernels.launch(
        "nstb_map", _ARGTYPES, out.device,
        *[t.data_ptr() for t in operands], out.data_ptr(), _ptr(work), *ints, float(eps),
    )
    fused_nstb_map.launches += 1
    fused_nstb_map.launches_by_body[_body_name(ints)] += 1


def _launch_tokens(operands, out, ints, eps):
    work = _workspace("nstb_tokens", ints[0], ints, out.device)
    kernels.launch(
        "nstb_tokens", _ARGTYPES, out.device,
        *[t.data_ptr() for t in operands], out.data_ptr(), _ptr(work), *ints, float(eps),
    )
    fused_nstb.launches += 1
    fused_nstb.launches_by_body[_body_name(ints)] += 1


def _nstb_map_cuda(*args):
    *tensors, num_heads, window_size, shift, eps = args
    operands = _bind(tensors)
    ints = _map_ints(operands[0], operands[1], operands[2], (operands[10],), num_heads,
                     window_size, shift)
    out = torch.empty_like(operands[0])
    _launch(operands, out, ints, eps)
    return out


def _nstb_tokens_cuda(*args):
    *tensors, num_heads, window_size, shift, wh, ww, eps = args
    operands = _bind(tensors)
    ints = _token_ints(operands[0], operands[1], operands[2], (operands[10],), num_heads,
                       window_size, shift, (wh, ww) if wh else None)
    out = torch.empty_like(operands[0])
    _launch_tokens(operands, out, ints, eps)
    return out


def _like_x(x, *_):
    return x.new_empty(x.shape)


_OPERANDS = (
    "(Tensor x, Tensor ctx_quads, Tensor wqkv, Tensor? bqkv, Tensor scale, Tensor table, "
    "Tensor wproj, Tensor? bproj, Tensor ln1_gain, Tensor ln1_bias, Tensor w1, Tensor b1, "
    "Tensor w2, Tensor b2, Tensor ln2_gain, Tensor ln2_bias, int num_heads, int window_size, "
    "int shift, "
)
# K2 and K8 as the operators ``tmar::nstb_map`` and ``tmar::nstb_tokens`` on
# ``_layout``'s operands (K8's grid (wh, ww) = (0, 0) when it has none)
NSTB_MAP = kernels.define_op("nstb_map", _OPERANDS + "float eps) -> Tensor", _nstb_map_cuda,
                             _like_x)
NSTB_TOKENS = kernels.define_op("nstb_tokens", _OPERANDS + "int wh, int ww, float eps) -> Tensor",
                                _nstb_tokens_cuda, _like_x)
