"""N-gram context of one NSTB: plain versions and CUDA kernel wrapper.

The counterpart of ``tmar.ops.pallas_ngram``.  On a [B, wh, ww, C] unigram
grid it computes both directional 4-token sliding attentions over the
sequence-reflect padded grid, their token means, and the [2C, D] merge.

A CUDA tensor goes through a ``torch.autograd.Function`` whose forward
launches ``csrc/ngram_context.cu`` (K1, through the operator
``tmar::ngram_context``, one node of a ``torch.export`` program) and whose
backward launches
``csrc/ngram_context_bwd.cu`` (K7: du and every parameter cotangent,
recomputed from u; three launches), or raises.  The kernels read the
float32 parameters; u, the output and du are float32 or bfloat16, the
parameter cotangents float32.  bfloat16 at the full-width NGswin's widths
(``MMA_GEOMETRIES``) runs the tensor-core bodies; every other case the
generic bodies, which take C, D, the heads and head_dim at run time within
``envelope.ngram_envelope``: K1 and K7 at bfloat16 their tensor-core
generic bodies wherever those have a plan, and the CUDA-core ones elsewhere
(one rule, ``envelope.ngram_body``, which the CUDA sources apply
themselves; K1's float32 at the full-width widths is its templated body).
The CUDA-core ones take any head_dim and pick their cells and positions a
tile by width (``envelope.ngram_tiles``, the sources' own copy of the
rule).  At
bfloat16 all round to bf16 where
``_ngram_stripe_kernel`` and ``_ngram_bwd_stripe_kernel`` do, with the
parameters rounded as ``tmar/nn/ngram.py`` casts them, and return dwqkv,
dbqkv, dwproj, dbproj and dwmerge as bf16 values; at float32 they compute
in float32 on the CUDA cores.

A CPU tensor runs the plain versions: at float32 ``ngram_context_math``
under ordinary autograd (``ngram_context_backward_math`` is that
autograd); at bfloat16 ``ngram_context_kernel_math`` and its explicit
backward ``ngram_context_kernel_backward_math``, which round where the
kernels and the JAX kernels round.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Optional

import torch

from tmar_torch import kernels
from tmar_torch.device import aligned
from tmar_torch.ops import envelope
from tmar_torch.ops.attention import (
    LOGIT_SCALE_MAX,
    gather_rel_pos_bias,
    relative_position_index,
    static_gather_transpose,
    window_attention_math,
)
from tmar_torch.ops.ngram import (
    ngram_window_index,
    ngram_windows,
    seq_refl_win_pad,
    sliding_patches,
)

# (C, D, num_heads, head_dim) of the tensor-core bodies (bfloat16 only): the
# full-width NGswin's 6- and 4-head stages on the D/2 = 32-channel unigram
# grid; every other geometry inside ``envelope.ngram_envelope`` runs the
# generic bodies
MMA_GEOMETRIES = envelope.NGRAM_FLAGSHIP


def ngram_context_math(
    u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, *, num_heads
):
    """Plain version.  u [B, wh, ww, C]; wqkv [C, 3A], wproj [A, C] and
    wmerge [2C, D] in the [in, out] layout; table [9, nh] is the 2x2
    relative-position bias table.  -> [B, wh, ww, D] in u's dtype."""
    cd = u.dtype
    bias = gather_rel_pos_bias(table, relative_position_index(2, 2), num_heads)

    def _dir(back):
        patches = sliding_patches(seq_refl_win_pad(u, 2, back=back), 2)
        B, wh, ww, n, _, C = patches.shape
        tokens = patches.reshape(B * wh * ww, n * n, C)
        out = window_attention_math(
            tokens, wqkv.to(cd), None if bqkv is None else bqkv.to(cd),
            logit_scale, bias, wproj.to(cd), None if bproj is None else bproj.to(cd),
            num_heads,
        )
        return out.mean(dim=1).reshape(B, wh, ww, C)

    both = torch.cat([_dir(False), _dir(True)], dim=-1).to(cd)
    return both @ wmerge.to(cd) + bmerge.to(cd)


def ngram_context_backward_math(
    u, g, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, *, num_heads
):
    """Plain version of the backward kernel: the cotangents of
    ``ngram_context_math`` for the output cotangent g [B, wh, ww, D], by
    autograd, as (du, dwqkv, dbqkv, dlogit_scale, dtable, dwproj, dbproj,
    dwmerge, dbmerge); None where ``bqkv`` / ``bproj`` is absent."""
    args = [u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge]
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().clone().requires_grad_() for t in args]
        out = ngram_context_math(*leaves, num_heads=num_heads)
        present = [t for t in leaves if t is not None]
        grads = iter(torch.autograd.grad(out, present, g.to(out.dtype)))
    return tuple(None if t is None else next(grads) for t in leaves)


def _rounding(dtype):
    """The rounding to ``dtype``, back in float32 (the identity at float32)."""
    return lambda t: t.to(dtype).float()


def _tokens(x, back):
    """x [B, wh, ww, X] -> [B, wh*ww, 4, X]: each cell's 2x2 window over the
    sequence-reflect padded grid, token p = 2·di + dj."""
    B, wh, ww, X = x.shape
    return ngram_windows(x, 2, back=back).reshape(B, wh * ww, 4, X)


def _untokens(t, back, wh, ww):
    """The transpose of ``_tokens``: [B, wh*ww, 4, X] -> [B, wh, ww, X], each
    cell the sum of the window tokens that read it."""
    B, n, _, X = t.shape
    out = static_gather_transpose(t.reshape(B, n * 4, X), ngram_window_index(wh, ww, 2, back), n)
    return out.reshape(B, wh, ww, X)


def _heads(t, nh):
    return t.reshape(*t.shape[:-1], nh, t.shape[-1] // nh)


def _kernel_forward(u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, nh):
    """The forward of ``_ngram_stripe_kernel`` over the whole map at u's
    dtype, with what the backward reads: returns (out, state)."""
    r = _rounding(u.dtype)
    B, wh, ww, C = u.shape
    A = wqkv.shape[1] // 3
    w, wp, wm = r(wqkv), r(wproj), r(wmerge)
    b = u.new_zeros(3 * A, dtype=torch.float32) if bqkv is None else r(bqkv)
    bp = u.new_zeros(C, dtype=torch.float32) if bproj is None else r(bproj)
    scale = torch.exp(torch.clamp(logit_scale.float().reshape(nh), max=LOGIT_SCALE_MAX))
    # [4 (query p), 4 (key q), nh]
    bias = gather_rel_pos_bias(table.float(), relative_position_index(2, 2), nh).permute(1, 2, 0)
    uf = u.float()
    q, k, v = (uf @ w + b).split(A, dim=-1)
    v = r(v)

    def normalize(t):  # n2 = Σ bf16(t²); inv = bf16(1 / bf16(√n2 + 1e-12))
        th = _heads(t, nh)
        n2 = r(th * th).sum(-1)
        rr = torch.sqrt(n2)
        inv = r(1.0 / r(rr + 1e-12))
        return r(th * inv[..., None]).reshape(t.shape), rr, inv

    qn, q_r, q_inv = normalize(q)
    kn, k_r, k_inv = normalize(k)
    dirs = []
    for back in (False, True):
        qs, ks, vs = (_heads(_tokens(t, back), nh) for t in (qn, kn, v))  # [B, n, 4, nh, hd]
        # cos[p, q] = Σ_d bf16(qn_p·kn_q) per head
        cos = r(qs[:, :, :, None] * ks[:, :, None]).sum(-1)               # [B, n, 4, 4, nh]
        s = cos * scale + bias
        e = torch.exp(s - s.amax(dim=3, keepdim=True))
        a = e * (1.0 / e.sum(dim=3, keepdim=True))
        acc = torch.einsum("bnpqh,bnqhd->bnhd", r(a), vs)
        mean = r(acc * 0.25).reshape(B, wh * ww, A)
        ctx = r(mean @ wp + bp)
        dirs.append(dict(qs=qs, ks=ks, vs=vs, cos=cos, a=a, mean=mean, ctx=ctx))
    both = torch.cat([dirs[0]["ctx"], dirs[1]["ctx"]], dim=-1)
    out = (both @ wm + bmerge.float()).reshape(B, wh, ww, -1).to(u.dtype)
    state = dict(r=r, w=w, wp=wp, wm=wm, scale=scale, q=q, k=k, q_r=q_r, k_r=k_r,
                 q_inv=q_inv, k_inv=k_inv, dirs=dirs)
    return out, state


def _kernel_backward(u, g, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, nh):
    _, st = _kernel_forward(u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, nh)
    r, scale = st["r"], st["scale"]
    B, wh, ww, C = u.shape
    A = wqkv.shape[1] // 3
    gf = r(g).reshape(B, wh * ww, -1)
    dqn = dkn = dv = 0.0
    dscale = dbias = dwproj = dbproj = 0.0
    dwm = []
    for back, d in zip((False, True), st["dirs"]):
        wm_d = st["wm"][back * C:(back + 1) * C]
        dwm.append(torch.einsum("bnc,bnd->cd", d["ctx"], gf))
        dctx = gf @ wm_d.t()
        dbproj = dbproj + dctx.sum((0, 1))
        dctxc = r(dctx)
        dwproj = dwproj + torch.einsum("bna,bnc->ac", d["mean"], dctxc)
        dacc = (dctxc @ st["wp"].t()) * 0.25
        daccc = _heads(r(dacc), nh)                                        # [B, n, nh, hd]
        dacc = _heads(dacc, nh)
        a, ra = d["a"], r(d["a"])                                          # [B, n, p, q, nh]
        # dv_q = Σ_p bf16(a_pq)·dacc;  da_q = Σ_d bf16(daccc·v_q)
        dv_t = torch.einsum("bnpqh,bnhd->bnqhd", ra, dacc)
        da = r(daccc[:, :, None] * d["vs"]).sum(-1)                        # [B, n, q, nh]
        inner = (a * da[:, :, None]).sum(3, keepdim=True)
        ds = a * (da[:, :, None] - inner)
        dbias = dbias + ds.sum((0, 1))
        dscale = dscale + (ds * d["cos"]).sum((0, 1, 2, 3))
        dprod = r(ds * scale)
        dqn_t = torch.einsum("bnpqh,bnqhd->bnphd", dprod, d["ks"])
        dkn_t = torch.einsum("bnpqh,bnphd->bnqhd", dprod, d["qs"])
        dqn = dqn + _untokens(dqn_t.flatten(-2), back, wh, ww)
        dkn = dkn + _untokens(dkn_t.flatten(-2), back, wh, ww)
        dv = dv + _untokens(dv_t.flatten(-2), back, wh, ww)

    def norm_backward(dn, t, rr, inv):  # dt = dn·inv - t·bf16(Σ bf16(dn·t)·inv²/r)
        dh, th = _heads(dn, nh), _heads(t, nh)
        factor = r(dh * th).sum(-1) * inv * inv / rr
        return (dh * inv[..., None] - th * r(factor)[..., None]).reshape(dn.shape)

    dt = torch.cat([norm_backward(dqn, st["q"], st["q_r"], st["q_inv"]),
                    norm_backward(dkn, st["k"], st["k_r"], st["k_inv"]), dv], dim=-1)
    dc = r(dt)
    du = (dc @ st["w"].t()).to(u.dtype)
    dwqkv = torch.einsum("bijc,bijo->co", u.float(), dc)
    dls = (dscale * scale * (logit_scale.float().reshape(nh) <= LOGIT_SCALE_MAX))
    dtable = static_gather_transpose(dbias.reshape(16, nh), relative_position_index(2, 2), 9)
    return (du, r(dwqkv), None if bqkv is None else r(dt.sum((0, 1, 2))),
            dls.reshape(logit_scale.shape), dtable, r(dwproj),
            None if bproj is None else r(dbproj), r(torch.cat(dwm, 0)), gf.sum((0, 1)))


def ngram_context_kernel_math(
    u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, *, num_heads
):
    """The plain version of K1 at u's dtype: ``_ngram_stripe_kernel``
    (``tmar/ops/pallas_ngram.py:813``) step by step over the whole map,
    computing in float32 and rounding to u's dtype where it rounds.  wqkv,
    bqkv, wproj, bproj and wmerge are rounded as ``tmar/nn/ngram.py:170-176``
    casts them (logit_scale, the table and bmerge stay float32); v (:851); the
    squares before each head's sum (:855), √n2 + 1e-12 and its reciprocal
    (:857), and the normalised q and k (:859); each q·k product before its
    head's sum (:904); the softmax weights (:912); the token mean (:917);
    ctx (:919) and the output (:929).  At float32 every rounding is the identity and this is
    ``ngram_context_math`` up to float32 summation order."""
    return _kernel_forward(u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge,
                           num_heads)[0]


def ngram_context_kernel_backward_math(
    u, g, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, *, num_heads
):
    """The plain version of K7 at u's dtype: the cotangents of
    ``ngram_context_kernel_math`` at the output cotangent g, written out as
    ``_ngram_bwd_stripe_kernel`` (``tmar/ops/pallas_ngram.py:520``) computes
    them over the whole map, since it rounds the cotangents themselves.
    Besides the forward's roundings (recomputed) it rounds g (:359); dctx
    before dwproj and dacc (:718); dacc before the per-head sums (:727);
    each daccc·v product before its head's sum (:743); ds·scale before the
    key and query products (:760); each dn·t product before its head's sum
    (:780) and the norm factor (:787); each of dq, dk, dv before the qkv
    products (:802); du on output (:444).  The softmax weights stay float32 where
    the JAX kernel keeps them, and the cotangents go back through the
    shifts' transposes in float32.  Returns (du, dwqkv, dbqkv, dlogit_scale,
    dtable, dwproj, dbproj, dwmerge, dbmerge) as ``ngram_context_backward_math``
    does: du in u's dtype; dwqkv, dbqkv, dwproj, dbproj and dwmerge rounded
    to u's dtype (:446-467: the parameters' dtype in the model) and returned
    as float32; the rest float32.  At float32 it is the autograd of
    ``ngram_context_math`` up to float32 summation order."""
    return _kernel_backward(u, g, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge,
                            num_heads)


class _PlainNGram(torch.autograd.Function):
    """The CPU path at bfloat16: the two rounding-matched plain versions as
    one differentiable function, as K1 and K7 compose on the card."""

    @staticmethod
    def forward(ctx, u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, num_heads):
        args = (u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge)
        ctx.save_for_backward(*args)
        ctx.num_heads = num_heads
        return ngram_context_kernel_math(*args, num_heads=num_heads)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        args = ctx.saved_tensors
        u, rest = args[0], args[1:]
        grads = ngram_context_kernel_backward_math(u, g, *rest, num_heads=ctx.num_heads)
        return (*[None if t is None else t.to(a.dtype) for t, a in zip(grads, args)], None)


def fused_ngram_context(
    u: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: Optional[torch.Tensor],
    logit_scale: torch.Tensor,
    table: torch.Tensor,
    wproj: torch.Tensor,
    bproj: Optional[torch.Tensor],
    wmerge: torch.Tensor,
    bmerge: torch.Tensor,
    num_heads: int,
) -> torch.Tensor:
    """u [B, wh, ww, C] -> context [B, wh, ww, D].  Arguments as in
    ``ngram_context_math``.  Differentiable in all nine tensor arguments.  A
    CPU tensor runs the plain version under ordinary autograd; a CUDA tensor
    launches the kernels (float32 or bfloat16, any width inside
    ``envelope.ngram_envelope``), forward and backward, or raises."""
    if u.device.type == "cpu":
        if u.dtype == torch.bfloat16:
            return _PlainNGram.apply(
                u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, num_heads
            )
        return ngram_context_math(
            u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge,
            num_heads=num_heads,
        )
    if u.device.type != "cuda":
        raise ValueError(f"fused_ngram_context: unsupported device {u.device}")
    return _NGramContext.apply(
        u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, num_heads
    )


fused_ngram_context.launches = 0           # forward kernel
fused_ngram_context.backward_launches = 0  # backward kernel
fused_ngram_context.launches_by_body = Counter()           # forward, by NGRAM_BODIES name
fused_ngram_context.backward_launches_by_body = Counter()  # backward, by body name


class _NGramContext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, num_heads):
        params = (wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge)
        operands = _layout(u, *params, num_heads)
        out = NGRAM_CONTEXT(*operands, num_heads)
        # bmerge (the last operand) has no part in the backward
        ctx.save_for_backward(*operands[:-1])
        ctx.num_heads = num_heads
        ctx.grad_dtypes = [None if t is None else t.dtype for t in params]
        ctx.ls_shape = logit_scale.shape
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        operands, ints = _bind(list(ctx.saved_tensors), ctx.num_heads)
        du, dparams = _launch_backward(operands, g, ints)
        C, D, nh, hd = ints[3:7]
        A = nh * hd
        shapes = [(C, 3 * A), (3 * A,), ctx.ls_shape, (9, nh), (A, C), (C,), (2 * C, D), (D,)]
        sizes = [math.prod(s) for s in shapes]
        # the reduce wrote the logit scale's and the table's cotangents: views
        # of one buffer, cast only where a parameter is not float32
        grads = [
            None if dt is None else t.view(shape) if dt == torch.float32 else t.view(shape).to(dt)
            for t, shape, dt in zip(torch.split(dparams, sizes), shapes, ctx.grad_dtypes)
        ]
        return (du, *grads, None)


def _layout(u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, num_heads):
    """Check the geometry and lay out the kernels' operands as they read
    them, in tensor operations that a trace records: [u, wqkv, bqkv,
    logit_scale [nh] (raw: the kernels take exp(min(ls, ln 100))), table,
    wproj, bproj, wmerge, bmerge], u contiguous in its dtype, the parameters
    float32 and contiguous, outside the graph; an absent bias stays None."""
    B, wh, ww, C = u.shape
    A = wqkv.shape[1] // 3
    D = wmerge.shape[1]
    if wh < 2 or ww < 2:
        raise NotImplementedError(
            f"the n-gram context kernel needs a >= 2x2 window grid, got {wh}x{ww}: "
            "the sequence-reflect padding has nothing to reflect on a smaller one"
        )
    if A % num_heads or tuple(wproj.shape) != (A, C) or tuple(wmerge.shape) != (2 * C, D):
        raise ValueError(f"fused_ngram_context: u {tuple(u.shape)}, wqkv {tuple(wqkv.shape)}, "
                         f"wproj {tuple(wproj.shape)}, wmerge {tuple(wmerge.shape)}, "
                         f"{num_heads} heads")
    hd = A // num_heads
    if not (u.dtype == torch.bfloat16 and (C, D, num_heads, hd) in MMA_GEOMETRIES):
        envelope.ngram_envelope(C, D, num_heads, hd, u.device)
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_ngram_context: unsupported dtype {u.dtype}")

    def f32(t):
        return None if t is None else t.detach().to(device=u.device, dtype=torch.float32).contiguous()

    return [u.detach().contiguous(), f32(wqkv), f32(bqkv), f32(logit_scale).reshape(num_heads),
            f32(table), f32(wproj), f32(bproj), f32(wmerge), f32(bmerge)]


def _bind(operands, num_heads):
    """Laid-out operands (``_layout``'s, the last ones may be left off) as
    the entry points take them: each on a 16-byte boundary, zeros for an
    absent bias.  Returns (them, the entry points' integer arguments).
    Reads data pointers, so it runs inside the operator, never in a trace."""
    u = operands[0]
    B, wh, ww, C = u.shape
    A = operands[1].shape[1] // 3
    widths = {2: 3 * A, 6: C}  # bqkv, bproj
    operands = [aligned(torch.zeros(widths[i], device=u.device) if t is None else t)
                for i, t in enumerate(operands)]
    ints = (B, wh, ww, C, operands[7].shape[1], num_heads, A // num_heads,
            int(u.dtype == torch.bfloat16), kernels.sm_count(u.device))
    return operands, ints


def _kernel_operands(u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, num_heads):
    """Check the geometry and lay out the kernels' operands on u's device:
    returns (the 9 input tensors in the C entry points' order, the output,
    the entry points' integer arguments)."""
    operands, ints = _bind(
        _layout(u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, num_heads),
        num_heads)
    return operands, _empty_out(u, wmerge), ints


def _empty_out(u, wmerge):
    return u.new_empty((*u.shape[:3], wmerge.shape[1]))


def _ngram_context_cuda(u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge,
                        num_heads):
    operands, ints = _bind([u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge],
                           num_heads)
    out = _empty_out(u, wmerge)
    _launch(operands, out, ints)
    return out


# K1 as the operator ``tmar::ngram_context`` on ``_layout``'s operands
NGRAM_CONTEXT = kernels.define_op(
    "ngram_context",
    "(Tensor u, Tensor wqkv, Tensor? bqkv, Tensor logit_scale, Tensor table, Tensor wproj, "
    "Tensor? bproj, Tensor wmerge, Tensor bmerge, int num_heads) -> Tensor",
    _ngram_context_cuda,
    lambda u, wqkv, bqkv, ls, table, wproj, bproj, wmerge, *_: _empty_out(u, wmerge),
)


_P = ctypes.c_void_p
_ARGTYPES = [_P] * 10 + [ctypes.c_int] * 9 + [_P]
_BWD_ARGTYPES = [_P] * 12 + [ctypes.c_int] * 9 + [_P]
_workspace_floats = {}  # the backward's integer arguments -> floats of scratch


def _body_name(ints, forward):
    """The body K1 (``forward``) or K7 runs for the entry points' integer
    arguments (``envelope.ngram_body``)."""
    C, D, nh, hd, is_bf16 = ints[3:8]
    return envelope.ngram_body(C, D, nh, hd, torch.bfloat16 if is_bf16 else torch.float32,
                               forward=forward)


def _workspace(ints):
    """The floats of scratch the backward kernel needs for this geometry
    (its slots and the per-block partial sums), asked of the library once."""
    n = _workspace_floats.get(ints)
    if n is None:
        query = kernels.host_function(
            "ngram_context_bwd", "tmar_ngram_context_bwd_workspace",
            [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_longlong)], ctypes.c_int)
        out = ctypes.c_longlong(0)
        kernels.check("ngram_context_bwd", query(*ints, ctypes.byref(out)))
        n = _workspace_floats[ints] = out.value
    return n


def _launch_backward(operands, g, ints):
    """Launch the backward kernel (a cells pass, a positions pass and one
    reduce) on the forward's first eight operands (u to wmerge) and the
    output cotangent g.  Returns (du, the parameter cotangents as the
    reduce writes them, concatenated in float32: dwqkv, dbqkv,
    dlogit_scale, dtable, dwproj, dbproj, dwmerge, dbmerge)."""
    u = operands[0]
    B, wh, ww, C, D, nh, hd, is_bf16, sms = ints
    A = nh * hd
    dev = u.device
    g = aligned(g.to(u.dtype).contiguous())
    du = torch.empty_like(u)
    scratch = torch.empty(_workspace(ints), device=dev, dtype=torch.float32)
    dparams = torch.empty(C * 3 * A + 3 * A + 10 * nh + A * C + C + 2 * C * D + D,
                          device=dev, dtype=torch.float32)
    kernels.launch(
        "ngram_context_bwd", _BWD_ARGTYPES, dev,
        u.data_ptr(), g.data_ptr(), *[t.data_ptr() for t in operands[1:8]],
        du.data_ptr(), scratch.data_ptr(), dparams.data_ptr(), *ints,
    )
    fused_ngram_context.backward_launches += 1
    fused_ngram_context.backward_launches_by_body[_body_name(ints, False)] += 1
    return du, dparams


def _launch(operands, out, ints):
    kernels.launch(
        "ngram_context", _ARGTYPES, out.device,
        *[t.data_ptr() for t in operands], out.data_ptr(), *ints,
    )
    fused_ngram_context.launches += 1
    fused_ngram_context.launches_by_body[_body_name(ints, True)] += 1
