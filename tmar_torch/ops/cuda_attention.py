"""Fused scaled-cosine window attention with a fused backward: CUDA kernel
wrapper (the counterpart of ``tmar.ops.pallas_attention`` with
``backward="pallas"``).

``fused_window_attention`` computes qkv projection -> cosine attention ->
output projection on [B_, N, D] windows.  A CUDA tensor goes through a
``torch.autograd.Function`` whose forward launches
``csrc/window_attention_fwd.cu`` (K3, through the operator
``tmar::window_attention_fwd``, one node of a ``torch.export`` program)
and whose backward launches
``csrc/window_attention_bwd.cu`` (K4: all seven cotangents, recomputed from
x and the saved row-wise log-sum-exp), or raises.  A CPU tensor runs the
plain versions: at float32 ``tmar_torch.ops.attention.window_attention_math``
under ordinary autograd; at bfloat16 ``window_attention_kernel_math`` and
its explicit backward ``window_attention_backward_math``, which round where
the kernels and the JAX kernels round.

The kernels read the float32 parameters; the activations and their
cotangents are float32 or bfloat16, and the parameter cotangents float32.
Which body runs is ``envelope.attention_body``'s rule of geometry and dtype,
and only that: bfloat16 at the full-width NGswin's 64-token windows
(``MMA_GEOMETRIES``) the flagship tensor-core bodies; its other geometries
(``KERNEL_GEOMETRIES``) bodies templated on the geometry; bfloat16 windows
of 1 to 31 tokens the short-window tensor-core bodies wherever
``envelope.attention_short_plan`` has a plan; bfloat16 windows of 32 to 64
tokens the tensor-core generic bodies wherever
``envelope.attention_mma_plan`` has a plan; windows of more than 64 tokens,
heads wider than 32 channels, and the widths whose CUDA-core generic tile
fits no block (``envelope.attention_generic_fits``: D = 256 with 8 heads of
32) the long-window bodies, over a workspace
the wrapper allocates: at bfloat16 from 32 tokens up the tensor-core ones
(``csrc/long_mma.cuh``; ``envelope.attention_long_tc_plan``), else the
CUDA-core ones (``csrc/window_attention_long.cuh``;
``envelope.attention_long_plan``); every other case the
CUDA-core generic bodies, which take N, D, the heads and head_dim at run
time within ``envelope.attention_envelope``.  At bfloat16 all round to
bf16 where the JAX kernels do: on windows of 32 tokens or more as
``_attn_kernel_batched`` and ``_attn_bwd_kernel_batched`` with ``cot_bf16``
on (the JAX default for bf16 inputs; the ``TMAR_ATTN_BWD_COT`` override is
not read), below as
``_attn_kernel`` and ``_attn_bwd_kernel``.  At float32 they compute in
float32 on the CUDA cores.  A body that fails to build or launch raises.

``impl`` takes the names of the JAX package's forward kernels
(``TMAR_ATTN_IMPL``).  Each is a way of feeding the TPU's matrix unit (how
windows and heads are stacked into one product) and computes the same
function, which K3 computes per window; so every name launches K3, and only
its counter in ``fused_window_attention.launches_by_impl`` tells them apart.
The backward is K4 for every name, as the JAX op's ``_fused_backward`` is
one kernel per window length.  The names (``IMPLS``), the TPU kernel each
selects in ``tmar/ops/pallas_attention.py``, and its kernel here:

    batched           _attn_kernel_batched                   :1143  -> K3
    batched_hm        _attn_kernel_batched(merge_heads)      :1143  -> K3
    blockdiag         _attn_kernel                           :1175  -> K3
    blockdiag_mxnorm  _attn_kernel(mxu_norms)                :1175  -> K3
    diag              _attn_kernel_diag                      :1241  -> K3
    packed            _attn_kernel_packed                    :813   -> K3

(K3 = ``csrc/window_attention_fwd.cu``; None selects ``batched`` for windows
of 32 tokens or more and ``blockdiag`` below, as the JAX op does.)
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from tmar_torch import kernels
from tmar_torch.device import aligned, float32_data
from tmar_torch.ops import envelope
from tmar_torch.ops.attention import (
    LOGIT_SCALE_MAX,
    add_shift_mask,
    merge_heads,
    on_device,
    split_heads,
    window_attention_math,
)

# (N, D, num_heads, head_dim) of the full-width NGswin, for which the
# kernels keep bodies of their own: its 8x8 windows at D = 64 (bfloat16 on
# the tensor cores, ``MMA_GEOMETRIES``; float32 on a body templated on the
# geometry) and its n x n n-gram windows at D/2 = 32 (n = 2, the default,
# and n = 1 and 3 of ``model.ngrams``; the templated body at both dtypes).
# The same set as csrc/window_attention_geometries.cuh, which both kernels'
# dispatches expand.  Every other geometry inside
# ``envelope.attention_envelope`` runs a generic body, the one
# ``envelope.attention_body`` names.
MMA_GEOMETRIES = envelope.ATTENTION_MMA_GEOMETRIES
KERNEL_GEOMETRIES = envelope.ATTENTION_KERNEL_GEOMETRIES

# impl name -> the TPU kernel it selects in tmar/ops/pallas_attention.py; on
# the card every one is K3, csrc/window_attention_fwd.cu
IMPLS = {
    "batched": "_attn_kernel_batched, pallas_attention.py:1143",
    "batched_hm": "_attn_kernel_batched(merge_heads=True), pallas_attention.py:1143 "
                  "(batched_attention_core :933-971)",
    "blockdiag": "_attn_kernel, pallas_attention.py:1175",
    "blockdiag_mxnorm": "_attn_kernel(mxu_norms=True), pallas_attention.py:1175 (:1199-1210)",
    "diag": "_attn_kernel_diag, pallas_attention.py:1241",
    "packed": "_attn_kernel_packed, pallas_attention.py:813",
}


# the JAX op's ``backward`` names that it computes with kernels: K4, or the
# plain recompute after K3 ("auto", XLA math under grad, is the block's
# choice of kernels: tmar_torch.nn.blocks)
BACKWARDS = ("pallas", "xla")


def check_impl(impl: Optional[str]) -> Optional[str]:
    """``impl`` if it is None or a name of ``IMPLS``; an unknown name raises
    (the JAX package falls back to ``blockdiag`` silently)."""
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; expected one of {sorted(IMPLS)}")
    return impl


def resolve_impl(impl: Optional[str], N: int) -> str:
    """``impl``, or the JAX package's default for N-token windows when None:
    ``batched`` from 32 tokens up, ``blockdiag`` below."""
    if check_impl(impl) is None:
        return "batched" if N >= 32 else "blockdiag"
    return impl


def _roundings(dtype, N):
    """(r, rk): the rounding to ``dtype`` (back in float32) of the products'
    operands that both window lengths' JAX kernels round (x, the two
    matrices, the head outputs before the projection), and of those only the
    64-token kernels round (q_n, k_n, v and P in the forward and its
    recompute; every cotangent product's operands, ``cot_bf16``).  The set
    is the JAX op's default ``impl`` for N: ``batched`` from 32 tokens up."""

    def r(t):
        return t.to(dtype).float()

    return r, (r if resolve_impl(None, N) == "batched" else (lambda t: t))


def _attention_terms(x, wqkv, bqkv, logit_scale, bias, num_heads, mask_components, rk):
    """The forward's intermediates in float32, per head [B_, nh, N, ·]: x's
    qkv product with the (rounded) weight ``wqkv``, then q, k, v, the
    reciprocal norms, q_n, k_n, the cosine, the effective scale and P."""
    qkv = x.float() @ wqkv
    if bqkv is not None:
        qkv = qkv + bqkv.float()
    q, k, v = (split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    iq = (q.square().sum(-1, keepdim=True).sqrt() + 1e-12).reciprocal()
    ik = (k.square().sum(-1, keepdim=True).sqrt() + 1e-12).reciprocal()
    qn, kn = q * iq, k * ik
    cos = rk(qn) @ rk(kn).transpose(-1, -2)
    scale = torch.exp(torch.clamp(logit_scale.float(), max=LOGIT_SCALE_MAX))
    s = add_shift_mask(cos * scale[None] + bias.float()[None], mask_components)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    return v, iq, ik, qn, kn, cos, scale, p


def window_attention_kernel_math(
    x, wqkv, bqkv, logit_scale, bias, wproj, bproj, num_heads, mask_components=None
):
    """The plain version of K3 at x's dtype: computes in float32 and rounds
    to x's dtype where the kernel and the JAX kernels round
    (``tmar/ops/pallas_attention.py``).  On 64-token windows
    (``_attn_kernel_batched`` by way of ``batched_attention_core``): the two
    matrices (``_pack_params`` :183), q_n, k_n and v (:1052-1062), P after
    its normalisation (:1133-1135), the merged head outputs (:1170).  On
    4-token windows (``_attn_kernel``): the matrices and the head outputs
    (:1236).  The biases, norms, scale, bias, mask and softmax stay float32;
    at float32 every rounding is the identity.  Arguments as
    ``fused_window_attention`` takes them; returns x's dtype."""
    cd = x.dtype
    r, rk = _roundings(cd, x.shape[1])
    v, _, _, _, _, _, _, p = _attention_terms(
        x, r(wqkv), bqkv, logit_scale, bias, num_heads, mask_components, rk)
    out = r(merge_heads(rk(p) @ rk(v))) @ r(wproj)
    if bproj is not None:
        out = out + bproj.float()
    return out.to(cd)


def window_attention_backward_math(
    x, g, wqkv, bqkv, logit_scale, bias, wproj, bproj, num_heads, mask_components=None
):
    """The plain version of K4 at x's dtype: the seven cotangents (dx,
    dwqkv, dbqkv, dlogit_scale, dbias, dwproj, dbproj) of
    ``window_attention_kernel_math`` at the output cotangent g, written out
    as the JAX kernels compute them.  On 64-token windows
    (``_attn_bwd_kernel_batched`` with ``cot_bf16``): the recompute rounds as
    the forward (:629-642), and every cotangent product's operands are
    rounded (:645-697): g, wp_h, dacc, v, P, dcos, k_n, q_n, the attention
    output, dqkv, x and wqkv; ds with delta = Σ_j dp·p from the rounded
    operands' dp (:658), the L2-norm backward and the sums into dbias,
    dscale, dbqkv and dbproj stay float32.  On 4-token windows
    (``_attn_bwd_kernel``): the qkv product's operands only (:728); the
    cotangent products run in float32 on the rounded matrices (:767,
    :802-807).  dx has x's dtype, the parameter cotangents are float32."""
    cd = x.dtype
    B_, N, D = x.shape
    r, rk = _roundings(cd, N)
    nh = num_heads
    w, wp = r(wqkv), r(wproj)
    v, iq, ik, qn, kn, cos, scale, p = _attention_terms(
        x, w, bqkv, logit_scale, bias, nh, mask_components, rk)
    o = rk(p) @ rk(v)                                   # [B_, nh, N, hd]
    g32 = r(g)
    dacc = split_heads(rk(g32) @ rk(wp).t(), nh)        # g @ wp_hᵀ per head
    dp = rk(dacc) @ rk(v).transpose(-1, -2)
    dv = rk(p).transpose(-1, -2) @ rk(dacc)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dbias = ds.sum(0)
    dscale = (ds * cos).sum((0, 2, 3))
    dcos = ds * scale[None]
    dqn = rk(dcos) @ rk(kn)
    dkn = rk(dcos).transpose(-1, -2) @ rk(qn)
    dq = iq * (dqn - qn * (dqn * qn).sum(-1, keepdim=True))
    dk = ik * (dkn - kn * (dkn * kn).sum(-1, keepdim=True))
    dqkv = torch.cat([merge_heads(dq), merge_heads(dk), merge_heads(dv)], dim=-1)
    dx = (rk(dqkv) @ rk(w).t()).to(cd)
    dwqkv = rk(r(x)).reshape(-1, D).t() @ rk(dqkv).reshape(-1, dqkv.shape[-1])
    dwproj = rk(merge_heads(o)).reshape(-1, o.shape[1] * o.shape[-1]).t() @ rk(g32).reshape(-1, D)
    ls = logit_scale.detach().float().reshape(nh)
    dls = (dscale * scale.reshape(nh) * (ls <= LOGIT_SCALE_MAX)).reshape(logit_scale.shape)
    return dx, dwqkv, dqkv.sum((0, 1)), dls, dbias, dwproj, g32.sum((0, 1))


class _PlainAttention(torch.autograd.Function):
    """The CPU path at bfloat16: the two rounding-matched plain versions as
    one differentiable function, as the kernels compose on the card."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, logit_scale, bias, wproj, bproj, num_heads, mask_components):
        ctx.save_for_backward(x, wqkv, bqkv, logit_scale, bias, wproj, bproj)
        ctx.num_heads, ctx.mask = num_heads, mask_components
        return window_attention_kernel_math(
            x, wqkv, bqkv, logit_scale, bias, wproj, bproj, num_heads, mask_components)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        args = ctx.saved_tensors
        grads = window_attention_backward_math(
            args[0], g, *args[1:], ctx.num_heads, mask_components=ctx.mask)
        return (*[None if a is None else t.to(a.dtype) for t, a in zip(grads, args)], None, None)


def fused_window_attention(
    x: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: Optional[torch.Tensor],
    logit_scale: torch.Tensor,
    bias: torch.Tensor,
    wproj: torch.Tensor,
    bproj: Optional[torch.Tensor],
    num_heads: int,
    mask_components: Optional[Tuple] = None,
    impl: Optional[str] = None,
    backward: str = "pallas",
) -> torch.Tensor:
    """x [B_, N, D] -> [B_, N, D].  wqkv [D, 3A] and wproj [A, D] in the
    [in, out] layout (a transposed view is read in place), logit_scale
    [nh, 1, 1] raw, bias the gathered relative-position bias [nh, N, N],
    mask_components (m_row [N, N], m_col [N, N], wh, ww) as
    ``cosine_window_attention`` takes them.  ``impl`` names the JAX
    package's forward kernel (``IMPLS``; None: its default for N); every
    name launches K3 and counts in ``launches_by_impl``, so the name
    changes no result.  The JAX op's ``windows_per_step`` and ``interpret``
    shape the TPU grid and have no counterpart here.  Differentiable in all
    seven tensor arguments.  ``backward`` is the JAX op's: ``"pallas"``
    the backward kernel K4, ``"xla"`` the plain recompute (autograd over
    ``window_attention_kernel_math``, the JAX op's ``jax.vjp`` of the pure
    function) after K3's forward.  A CPU tensor runs the plain versions (at
    bfloat16 the rounding-matched ones); a CUDA tensor launches the kernels
    (float32 or bfloat16, any geometry inside ``envelope.attention_envelope``)
    or raises."""
    impl = resolve_impl(impl, x.shape[1])
    if backward not in BACKWARDS:
        raise ValueError(f"unknown attention backward {backward!r}; expected one of {BACKWARDS}")
    if x.device.type == "cpu":
        if x.dtype == torch.bfloat16 and backward == "xla":
            return window_attention_kernel_math(
                x, wqkv, bqkv, logit_scale, bias, wproj, bproj, num_heads, mask_components)
        if x.dtype == torch.bfloat16:
            return _PlainAttention.apply(
                x, wqkv, bqkv, logit_scale, bias, wproj, bproj, num_heads, mask_components)
        cd = x.dtype
        return window_attention_math(
            x, wqkv.to(cd), None if bqkv is None else bqkv.to(cd), logit_scale, bias,
            wproj.to(cd), None if bproj is None else bproj.to(cd), num_heads,
            mask_components=mask_components,
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_window_attention: unsupported device {x.device}")
    function = _WindowAttention if backward == "pallas" else _RecomputedAttention
    return function.apply(
        x, wqkv, bqkv, logit_scale, bias, wproj, bproj, num_heads, mask_components, impl
    )


fused_window_attention.launches = 0           # forward kernel
fused_window_attention.backward_launches = 0  # backward kernel
fused_window_attention.launches_by_impl = dict.fromkeys(IMPLS, 0)  # forward, by impl name
fused_window_attention.launches_by_n = Counter()           # forward, by window length N
fused_window_attention.backward_launches_by_n = Counter()  # backward, by window length N
fused_window_attention.launches_by_body = Counter()           # forward, by ATTENTION_BODIES name
fused_window_attention.backward_launches_by_body = Counter()  # backward, by body name


class _Geometry:
    """What the C entry points take besides the tensors: the window length,
    the widths, the heads, the weights' strides, the mask grid, the I/O
    dtype, the body (``envelope.attention_body``, which the sources check
    against their own rule), and per kernel its heads per group and
    persistent blocks (the CUDA-core generic body's; the tensor-core and
    long-window bodies size their own grids)."""

    def __init__(self, x, w_qkv, w_proj, num_heads, wh, ww, sms):
        B_, self.N, self.D = x.shape
        A = w_qkv.shape[1] // 3
        if A % num_heads or tuple(w_proj.shape) != (A, self.D):
            raise ValueError(f"fused_window_attention: wqkv {tuple(w_qkv.shape)}, wproj "
                             f"{tuple(w_proj.shape)}, {num_heads} heads")
        self.nwin, self.nh, self.hd = B_, num_heads, A // num_heads
        self.strides = (*w_qkv.stride(), *w_proj.stride())
        self.wh, self.ww = wh, ww
        self.is_bf16 = int(x.dtype == torch.bfloat16)
        self.body = envelope.ATTENTION_BODIES.index(
            envelope.attention_body(self.N, self.D, self.nh, self.hd, x.dtype))
        # the long-window bodies (windows past 64 tokens, heads past 32
        # channels, and what the CUDA-core generic bodies' tiles do not fit)
        self.long = envelope.ATTENTION_BODIES[self.body] in envelope.ATTENTION_BODIES[5:]
        if (self.N, self.D, self.nh, self.hd) in KERNEL_GEOMETRIES:
            # the full-width NGswin's own bodies: at most one block per SM
            self.hg_fwd = self.hg_bwd = self.nh
            self.blocks_fwd = self.blocks_bwd = min(-(-B_ // (envelope.ROWS // self.N)), sms)
        elif self.long:
            # either long-window body: checks that every launch fits a
            # block; the grids follow the windows
            self.hg_fwd, _, self.hg_bwd, _ = envelope.attention_envelope(
                self.N, self.D, self.nh, self.hd, x.device, x.dtype)
            self.blocks_fwd = self.blocks_bwd = 1
        else:
            self.hg_fwd, fwd_bytes, self.hg_bwd, bwd_bytes = envelope.attention_envelope(
                self.N, self.D, self.nh, self.hd, x.device)
            tiles = -(-B_ // (envelope.ROWS // self.N))
            self.blocks_fwd = envelope.blocks_for(tiles, fwd_bytes, sms)
            self.blocks_bwd = envelope.blocks_for(tiles, bwd_bytes, sms)

    def ints(self, backward):
        hg, blocks = (self.hg_bwd, self.blocks_bwd) if backward else (self.hg_fwd, self.blocks_fwd)
        return (self.nwin, self.N, self.D, self.nh, self.hd, hg, *self.strides, self.wh, self.ww,
                blocks, self.is_bf16, self.body)


def _device_mask(mask_components, N, nwin, device):
    """The decomposed shift mask on the device: (m_row, m_col, wh, ww), or
    (None, None, 0, 0) without a mask."""
    if mask_components is None:
        return None, None, 0, 0
    m_row, m_col, wh, ww = mask_components
    if nwin % (wh * ww):
        raise ValueError(f"{nwin} windows are not a multiple of the {wh}x{ww} grid")
    for m in (m_row, m_col):
        if np.shape(m) != (N, N):
            raise ValueError(f"mask component shape {np.shape(m)} != {(N, N)}")
    return on_device(m_row, device), on_device(m_col, device), int(wh), int(ww)


def _ptr(t):
    return None if t is None else t.data_ptr()


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, bqkv, logit_scale, bias, wproj, bproj, num_heads, mask_components,
                impl):
        operands, grid = _layout(
            x, wqkv, bqkv, logit_scale, bias, wproj, bproj, num_heads, mask_components)
        out, lse = WINDOW_ATTENTION(*operands, *grid, num_heads, impl)
        ctx.save_for_backward(*operands[:7], lse, logit_scale)
        ctx.mask = (*operands[7:], *grid)
        ctx.num_heads = num_heads
        ctx.grad_dtypes = [
            None if t is None else t.dtype for t in (wqkv, bqkv, logit_scale, bias, wproj, bproj)
        ]
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *operands, lse, logit_scale = ctx.saved_tensors
        operands, geo = _bind(operands + list(ctx.mask[:2]), ctx.num_heads, *ctx.mask[2:])
        scale = operands[3]
        N, D, nh, A = geo.N, geo.D, geo.nh, geo.nh * geo.hd
        dx, dparams = _launch_backward(operands, lse, g, geo)
        sizes = [D * 3 * A, 3 * A, nh, nh * N * N, A * D, D]
        dwqkv, dbqkv, dscale, dbias, dwproj, dbproj = torch.split(dparams, sizes)
        # the kernel's cotangent is on the effective scale exp(min(ls, ln 100)):
        # d/d ls = scale below the clip, zero above it
        ls = logit_scale.detach().to(torch.float32).reshape(nh)
        dls = (dscale * scale * (ls <= LOGIT_SCALE_MAX)).reshape(logit_scale.shape)
        grads = [
            dwqkv.reshape(D, 3 * A), dbqkv, dls, dbias.reshape(nh, N, N),
            dwproj.reshape(A, D), dbproj,
        ]
        grads = [None if dt is None else t.to(dt) for t, dt in zip(grads, ctx.grad_dtypes)]
        return (dx, *grads, None, None, None)


class _RecomputedAttention(torch.autograd.Function):
    """``backward="xla"``: K3's forward; the backward recomputes
    ``window_attention_kernel_math`` under autograd from the saved inputs,
    so K4 never runs."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, logit_scale, bias, wproj, bproj, num_heads, mask_components,
                impl):
        operands, grid = _layout(
            x, wqkv, bqkv, logit_scale, bias, wproj, bproj, num_heads, mask_components)
        out, _ = WINDOW_ATTENTION(*operands, *grid, num_heads, impl)
        ctx.save_for_backward(x, wqkv, bqkv, logit_scale, bias, wproj, bproj)
        ctx.num_heads = num_heads
        ctx.mask = None if mask_components is None else (
            *(on_device(m, x.device) for m in mask_components[:2]), *mask_components[2:])
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        args = [None if t is None else t.detach().requires_grad_(need)
                for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        leaves = [t for t in args if t is not None and t.requires_grad]
        with torch.enable_grad():
            out = window_attention_kernel_math(*args, ctx.num_heads, ctx.mask)
            grads = iter(torch.autograd.grad(out, leaves, g))
        return (*[next(grads) if t is not None and t.requires_grad else None for t in args],
                None, None, None)


def _layout(x, wqkv, bqkv, logit_scale, bias, wproj, bproj, num_heads, mask_components):
    """Check the geometry against the envelope (``envelope.attention_envelope``)
    and lay out the kernels' operands as they read them, in tensor
    operations that a trace records: returns ([x, wqkv, bqkv, scale, bias,
    wproj, bproj, m_row, m_col], (wh, ww)): x contiguous, the parameters'
    float32 data (a transposed weight read in place), the logit scale as
    exp(min(ls, ln 100)), the shift mask's components (None and (0, 0)
    without a mask); an absent bias stays None."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_window_attention: unsupported dtype {x.dtype}")
    if x.shape[0] < 1:
        raise ValueError("fused_window_attention: no windows")
    B_, N, D = x.shape
    m_row, m_col, wh, ww = _device_mask(mask_components, N, B_, x.device)
    w_qkv, w_proj = float32_data(wqkv), float32_data(wproj)
    _Geometry(x, w_qkv, w_proj, num_heads, wh, ww, kernels.sm_count(x.device))  # checks the shapes
    scale = torch.exp(
        torch.clamp(float32_data(logit_scale).reshape(num_heads), max=LOGIT_SCALE_MAX)
    )
    bias32 = float32_data(bias, True)
    if tuple(bias32.shape) != (num_heads, N, N):
        raise ValueError(f"bias shape {tuple(bias32.shape)} != {(num_heads, N, N)}")
    operands = [
        x.detach().contiguous(), w_qkv, None if bqkv is None else float32_data(bqkv, True),
        scale, bias32, w_proj, None if bproj is None else float32_data(bproj, True), m_row, m_col,
    ]
    return operands, (wh, ww)


def _bind(operands, num_heads, wh, ww):
    """``_layout``'s operands as the entry points take them: each on a
    16-byte boundary, zeros for an absent bias; and their ``_Geometry``.
    Reads data pointers, so it runs inside the operator, never in a trace."""
    x = operands[0]
    widths = {2: operands[1].shape[1], 6: x.shape[2]}  # bqkv, bproj
    operands = [torch.zeros(widths[i], device=x.device) if t is None and i in widths else t
                for i, t in enumerate(operands)]
    operands = [None if t is None else aligned(t) for t in operands]  # no mask: None
    return operands, _Geometry(operands[0], operands[1], operands[5], num_heads, wh, ww,
                               kernels.sm_count(x.device))


def _kernel_operands(x, wqkv, bqkv, logit_scale, bias, wproj, bproj, num_heads, mask_components):
    """Check the geometry and lay out the kernels' operands on x's device:
    returns ([x, wqkv, bqkv, scale, bias, wproj, bproj, m_row, m_col] as the
    C entry points read them, the ``_Geometry``)."""
    operands, grid = _layout(x, wqkv, bqkv, logit_scale, bias, wproj, bproj, num_heads,
                             mask_components)
    return _bind(operands, num_heads, *grid)


def _launch(operands, geo):
    """K3 on laid-out operands: -> (out, lse)."""
    x = operands[0]
    out = torch.empty_like(x)
    lse = torch.empty((geo.nwin, geo.nh, geo.N), device=x.device, dtype=torch.float32)
    # the long-window body's qkv and head outputs, as the library sizes them
    floats = _fwd_workspace_floats(geo) if geo.long else 0
    workspace = torch.empty(floats, device=x.device, dtype=torch.float32) if floats else None
    kernels.launch(
        "window_attention_fwd", _FWD_ARGTYPES, x.device,
        *[_ptr(t) for t in operands], out.data_ptr(), lse.data_ptr(), _ptr(workspace),
        *geo.ints(False),
    )
    fused_window_attention.launches += 1
    fused_window_attention.launches_by_n[geo.N] += 1
    fused_window_attention.launches_by_body[envelope.ATTENTION_BODIES[geo.body]] += 1
    return out, lse


def _launch_backward(operands, lse, g, geo):
    """K4 on the forward's operands, its lse and the output cotangent g: ->
    (dx, the concatenated float32 parameter cotangents)."""
    x = operands[0]
    N, D, nh, A = geo.N, geo.D, geo.nh, geo.nh * geo.hd
    g = g.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    # the per-block partial sums (and the tensor-core body's dqkv and
    # attention output tiles), as the library sizes them
    workspace = torch.empty(_workspace_floats(geo), device=x.device, dtype=torch.float32)
    dparams = torch.empty(D * 3 * A + 3 * A + nh + nh * N * N + A * D + D, device=x.device,
                          dtype=torch.float32)
    p = [_ptr(t) for t in operands]
    kernels.launch(
        "window_attention_bwd", _BWD_ARGTYPES, x.device,
        p[0], g.data_ptr(), *p[1:5], p[5], p[7], p[8], lse.data_ptr(), dx.data_ptr(),
        workspace.data_ptr(), dparams.data_ptr(), *geo.ints(True),
    )
    fused_window_attention.backward_launches += 1
    fused_window_attention.backward_launches_by_n[N] += 1
    fused_window_attention.backward_launches_by_body[envelope.ATTENTION_BODIES[geo.body]] += 1
    return dx, dparams


def _workspace_floats(geo):
    global _workspace_fn
    if _workspace_fn is None:
        _workspace_fn = kernels.host_function(
            "window_attention_bwd", "tmar_window_attention_bwd_workspace",
            [ctypes.c_int] * 7, ctypes.c_longlong)
    floats = _workspace_fn(geo.nwin, geo.N, geo.D, geo.nh, geo.hd, geo.blocks_bwd, geo.is_bf16)
    if floats < 0:
        raise ValueError(f"window_attention_bwd: no workspace size for N={geo.N}, D={geo.D}, "
                         f"heads={geo.nh}x{geo.hd}")
    return floats


def _fwd_workspace_floats(geo):
    global _fwd_workspace_fn
    if _fwd_workspace_fn is None:
        _fwd_workspace_fn = kernels.host_function(
            "window_attention_fwd", "tmar_window_attention_fwd_workspace",
            [ctypes.c_int] * 6, ctypes.c_longlong)
    floats = _fwd_workspace_fn(geo.nwin, geo.N, geo.D, geo.nh, geo.hd, geo.is_bf16)
    if floats < 0:
        raise ValueError(f"window_attention_fwd: no workspace size for N={geo.N}, D={geo.D}, "
                         f"heads={geo.nh}x{geo.hd}")
    return floats


_workspace_fn = _fwd_workspace_fn = None
_P = ctypes.c_void_p
_FWD_ARGTYPES = [_P] * 12 + [ctypes.c_int] * 15 + [_P]
_BWD_ARGTYPES = [_P] * 13 + [ctypes.c_int] * 15 + [_P]


def _window_attention_cuda(x, wqkv, bqkv, scale, bias, wproj, bproj, m_row, m_col, wh, ww,
                           num_heads, impl):
    operands, geo = _bind([x, wqkv, bqkv, scale, bias, wproj, bproj, m_row, m_col],
                          num_heads, wh, ww)
    out, lse = _launch(operands, geo)
    fused_window_attention.launches_by_impl[impl] += 1
    return out, lse


def _window_attention_fake(x, wqkv, bqkv, scale, bias, *_):
    nh, N = bias.shape[0], x.shape[1]
    return x.new_empty(x.shape), x.new_empty((x.shape[0], nh, N), dtype=torch.float32)


# K3 as the operator ``tmar::window_attention_fwd`` on ``_layout``'s
# operands: -> (out, the row-wise log-sum-exp K4 reads)
WINDOW_ATTENTION = kernels.define_op(
    "window_attention_fwd",
    "(Tensor x, Tensor wqkv, Tensor? bqkv, Tensor scale, Tensor bias, Tensor wproj, "
    "Tensor? bproj, Tensor? m_row, Tensor? m_col, int wh, int ww, int num_heads, str impl) "
    "-> (Tensor, Tensor)",
    _window_attention_cuda,
    _window_attention_fake,
)
