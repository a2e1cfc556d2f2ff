"""Fused post-norm residual FFN with a fused backward: CUDA kernel wrapper
(the counterpart of ``tmar.ops.pallas_ffn`` with ``backward="pallas"``).

    y = x + LN1(attn_out)
    z = y + LN2(fc2(GELU(fc1(y))))

A CUDA tensor goes through a ``torch.autograd.Function`` whose forward
launches ``csrc/residual_ffn_fwd.cu`` (K5, through the operator
``tmar::residual_ffn_fwd``, one node of a ``torch.export`` program) and
whose backward launches
``csrc/residual_ffn_bwd.cu`` (K6: all ten cotangents, recomputed from x and
attn_out), or raises.  A CPU tensor runs the plain versions: at float32
``tmar_torch.ops.ffn.ffn_math`` under ordinary autograd; at bfloat16
``ffn_kernel_math`` and its explicit backward ``ffn_backward_math``, which
round where the kernels and the JAX kernels round.

The kernels read the float32 parameters; the activations and their
cotangents are float32 or bfloat16, and the parameter cotangents float32.
The I/O dtype and the widths pick the body.  At the full-width NGswin's
(D, hidden) = (64, 128) (``KERNEL_DIMS``) bfloat16 runs the tensor-core
bodies and float32 bodies templated on the widths; every other width the
generic bodies, which take D and hidden at run time, within
``envelope.ffn_envelope``.  At bfloat16 both round to bf16 where
``_ffn_kernel`` and ``_ffn_bwd_kernel`` do, with the weights cast to the
activation dtype as ``tmar/nn/blocks.py`` casts them: w1 and w2, y before
fc1, the GELU output before fc2 and the output; in the backward also the
output cotangent, do before its two products, du before its two, and dw1
and dw2 after their sums over rows.
"""

from __future__ import annotations

import ctypes

import torch

from tmar_torch import kernels
from tmar_torch.device import aligned, float32_data
from tmar_torch.ops import envelope
from tmar_torch.ops.ffn import erf_as_kernels, ffn_math, gelu_as_kernels, layer_norm

# (D, hidden) of the full-width NGswin, for which the kernels keep bodies of
# their own: on the tensor cores at bfloat16, templated on the widths at
# float32; every other width inside ``envelope.ffn_envelope`` runs the
# generic bodies
KERNEL_DIMS = (64, 128)


def _rounding(dtype):
    """The rounding to ``dtype``, back in float32 (the identity at float32)."""
    return lambda t: t.to(dtype).float()


def ffn_kernel_math(x, attn_out, g1, b1, w1, bw1, w2, bw2, g2, b2, eps=1e-5):
    """The plain version of K5 at x's dtype: computes in float32 and rounds
    to x's dtype where the kernel and ``_ffn_kernel``
    (``tmar/ops/pallas_ffn.py:352``) round: w1 and w2 (cast at the call,
    ``tmar/nn/blocks.py:148-155``), y before fc1 and the GELU output before
    fc2 (:360, :362), and the output.  attn_out is read in x's dtype, as the
    wrapper reads it.  The biases, LayerNorm gains and statistics, the GELU
    and the residual y stay float32.  The GELU's erf is the kernels'
    (``gelu_as_kernels``); at float32 every rounding is the identity, and
    this is ``ffn_math`` but for that erf (|err| < 1.5e-7)."""
    r = _rounding(x.dtype)
    y = x.float() + layer_norm(r(attn_out), g1, b1, eps)
    h = gelu_as_kernels(r(y) @ r(w1) + bw1.float())
    z = y + layer_norm(r(h) @ r(w2) + bw2.float(), g2, b2, eps)
    return z.to(x.dtype)


def _ln_stats(v, eps):
    mu = v.mean(-1, keepdim=True)
    rstd = torch.rsqrt((v - mu).square().mean(-1, keepdim=True) + eps)
    return (v - mu) * rstd, rstd


def _ln_backward(dout, n, rstd, gain):
    """(d input, d gain, d bias) of n·gain + bias, n the normalised rows."""
    dn = dout * gain.float()
    din = rstd * (dn - dn.mean(-1, keepdim=True) - n * (dn * n).mean(-1, keepdim=True))
    return din, (dout * n).sum(0), dout.sum(0)


def ffn_backward_math(x, attn_out, g1, b1, w1, bw1, w2, bw2, g2, b2, dz, eps=1e-5):
    """The plain version of K6 at x's dtype: the ten cotangents (dx,
    dattn_out, dg1, db1, dw1, dbw1, dw2, dbw2, dg2, db2) of
    ``ffn_kernel_math`` at the output cotangent dz, written out step by step
    as ``_ffn_bwd_kernel`` (``tmar/ops/pallas_ffn.py:249``) computes them,
    since it rounds the cotangents themselves.  It recomputes y, yc = r(y),
    u = yc·r(w1) + bw1, hc = r(GELU(u)), o = hc·r(w2) + bw2 (:275-287) and
    rounds dz (:170), do before dh = do·w2ᵀ and dw2 = hcᵀ·do (:305), du
    before dy = dz + du·w1ᵀ and dw1 = ycᵀ·du (:319), dw1 and dw2 after their
    sums over rows (:240, :242), dx and dattn_out on output.  The LayerNorm
    backwards, the GELU derivative Φ(u) + u·φ(u) (Φ with the kernels' erf)
    and the sums into the vector cotangents stay float32; at float32 every
    rounding is the identity.  dx and dattn_out have x's dtype, the
    parameter cotangents are float32."""
    cd = x.dtype
    r = _rounding(cd)
    n1, r1 = _ln_stats(r(attn_out), eps)
    y = x.float() + (n1 * g1.float() + b1.float())
    yc, w1c, w2c = r(y), r(w1), r(w2)
    u = yc @ w1c + bw1.float()
    hc = r(gelu_as_kernels(u))
    n2, r2 = _ln_stats(hc @ w2c + bw2.float(), eps)
    dz = r(dz)
    do, dg2, db2 = _ln_backward(dz, n2, r2, g2)
    doc = r(do)
    cdf = 0.5 * (1.0 + erf_as_kernels(u * 0.7071067811865476))
    du = (doc @ w2c.t()) * (cdf + u * torch.exp(-0.5 * u * u) * 0.3989422804014327)
    duc = r(du)
    dy = dz + duc @ w1c.t()
    dao, dg1, db1 = _ln_backward(dy, n1, r1, g1)
    return (dy.to(cd), dao.to(cd), dg1, db1, r(yc.t() @ duc), du.sum(0), r(hc.t() @ doc),
            do.sum(0), dg2, db2)


class _PlainFFN(torch.autograd.Function):
    """The CPU path at bfloat16: the two rounding-matched plain versions as
    one differentiable function, as the kernels compose on the card."""

    @staticmethod
    def forward(ctx, x, attn_out, g1, b1, w1, bw1, w2, bw2, g2, b2, eps):
        ctx.save_for_backward(x, attn_out, g1, b1, w1, bw1, w2, bw2, g2, b2)
        ctx.eps = eps
        return ffn_kernel_math(x, attn_out, g1, b1, w1, bw1, w2, bw2, g2, b2, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dz):
        args = ctx.saved_tensors
        grads = ffn_backward_math(*args, dz, eps=ctx.eps)
        return (*[t.to(a.dtype) for t, a in zip(grads, args)], None)


def fused_residual_ffn(
    x: torch.Tensor,
    attn_out: torch.Tensor,
    ln1_scale: torch.Tensor,
    ln1_bias: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    ln2_scale: torch.Tensor,
    ln2_bias: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """x, attn_out [M, D] -> z [M, D] in x's dtype.  w1 [D, H] and w2 [H, D]
    in the [in, out] layout (a transposed view is read in place).
    Differentiable in all ten tensor arguments.  A CPU tensor runs the plain
    versions (at bfloat16 the rounding-matched ones); a CUDA tensor launches
    the kernels (float32 or bfloat16, any M, any width inside
    ``envelope.ffn_envelope``) or raises."""
    if x.device.type == "cpu":
        if x.dtype == torch.bfloat16:
            return _PlainFFN.apply(
                x, attn_out, ln1_scale, ln1_bias, w1, b1, w2, b2, ln2_scale, ln2_bias, eps)
        return ffn_math(
            x, attn_out, ln1_scale, ln1_bias, w1, b1, w2, b2, ln2_scale, ln2_bias, eps=eps
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_ffn: unsupported device {x.device}")
    return _ResidualFFN.apply(
        x, attn_out, ln1_scale, ln1_bias, w1, b1, w2, b2, ln2_scale, ln2_bias, eps
    )


fused_residual_ffn.launches = 0           # forward kernel
fused_residual_ffn.backward_launches = 0  # backward kernel


class _ResidualFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, attn_out, g1, b1, w1, bw1, w2, bw2, g2, b2, eps):
        operands = _layout(x, attn_out, g1, b1, w1, bw1, w2, bw2, g2, b2)
        out = RESIDUAL_FFN(*operands, float(eps))
        # b2 (the last operand) has no part in the backward
        ctx.save_for_backward(*operands[:9])
        ctx.eps = eps
        ctx.grad_dtypes = [t.dtype for t in (attn_out, g1, b1, w1, bw1, w2, bw2, g2, b2)]
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dz):
        operands, geo = _bind(ctx.saved_tensors, ctx.eps)
        D, H = geo.D, geo.H
        dx, dao, dparams = _launch_backward(operands, dz, geo)
        dg1, db1, dw1, dbw1, dw2, dbw2, dg2, db2 = torch.split(dparams, _param_sizes(D, H))
        grads = [dao, dg1, db1, dw1.reshape(D, H), dbw1, dw2.reshape(H, D), dbw2, dg2, db2]
        grads = [t.to(dt) for t, dt in zip(grads, ctx.grad_dtypes)]
        return (dx, *grads, None)


class _Geometry:
    """What the C entry points take besides the tensors: the widths, K6's
    rows per tile, the weights' strides, eps, the I/O dtype and each
    kernel's persistent blocks."""

    def __init__(self, x, w_1, w_2, eps, sms):
        M, self.D = x.shape
        self.H = w_1.shape[1]
        self.strides = (*w_1.stride(), *w_2.stride())
        self.eps = float(eps)
        self.is_bf16 = int(x.dtype == torch.bfloat16)
        if (self.D, self.H) == KERNEL_DIMS:
            # the full-width NGswin's own bodies: one block per SM at most
            self.rows, self.fwd_blocks = 64, min((M + 63) // 64, sms)
            self.bwd_blocks = self.fwd_blocks
        else:
            fwd_bytes, self.rows, bwd_bytes = envelope.ffn_envelope(self.D, self.H, x.device)
            self.fwd_blocks = envelope.blocks_for((M + 63) // 64, fwd_bytes, sms)
            self.bwd_blocks = envelope.blocks_for(
                (M + self.rows - 1) // self.rows, bwd_bytes, sms)


def _param_sizes(D, H):
    """dg1, db1, dw1, dbw1, dw2, dbw2, dg2, db2 as the backward concatenates them."""
    return [D, D, D * H, H, H * D, D, D, D]


def _layout(x, attn_out, g1, b1, w1, bw1, w2, bw2, g2, b2):
    """Check the shapes and lay out the kernels' operands as they read them,
    in tensor operations that a trace records: [x, attn_out, g1, b1, w1,
    bw1, w2, bw2, g2, b2], the activations contiguous in x's dtype, the
    parameters' float32 data (a transposed weight read in place)."""
    M, D = x.shape
    H = w1.shape[1]
    if tuple(w1.shape) != (D, H) or tuple(w2.shape) != (H, D):
        raise ValueError(f"fused_residual_ffn: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_residual_ffn: unsupported dtype {x.dtype}")
    if attn_out.shape != x.shape or M < 1:
        raise ValueError(f"fused_residual_ffn: x {tuple(x.shape)}, attn_out {tuple(attn_out.shape)}")
    if (D, H) != KERNEL_DIMS:
        envelope.ffn_envelope(D, H, x.device)
    g1_, b1_, bw1_, bw2_, g2_, b2_ = (float32_data(t, True) for t in (g1, b1, bw1, bw2, g2, b2))
    return [x.detach().contiguous(), attn_out.detach().to(x.dtype).contiguous(), g1_, b1_,
            float32_data(w1), bw1_, float32_data(w2), bw2_, g2_, b2_]


def _bind(operands, eps):
    """``_layout``'s operands (b2 may be left off) on 16-byte boundaries,
    and their ``_Geometry``.  Reads data pointers, so it runs inside the
    operator, never in a trace."""
    operands = [aligned(t) for t in operands]
    return operands, _Geometry(operands[0], operands[4], operands[6], eps,
                               kernels.sm_count(operands[0].device))


def _kernel_operands(x, attn_out, g1, b1, w1, bw1, w2, bw2, g2, b2, eps):
    """Check the shapes and the envelope (``envelope.ffn_envelope``) and lay
    out the kernels' operands on x's device: returns ([x, attn_out, g1, b1,
    w1, bw1, w2, bw2, g2, b2] as the C entry points read them, the
    ``_Geometry``)."""
    return _bind(_layout(x, attn_out, g1, b1, w1, bw1, w2, bw2, g2, b2), eps)


def _launch(operands, geo):
    """K5 on laid-out operands: -> z."""
    x = operands[0]
    out = torch.empty_like(x)
    kernels.launch(
        "residual_ffn_fwd", _FWD_ARGTYPES, x.device,
        *[t.data_ptr() for t in operands], out.data_ptr(), x.shape[0], geo.D, geo.H,
        *geo.strides, geo.eps, geo.fwd_blocks, geo.is_bf16,
    )
    fused_residual_ffn.launches += 1
    return out


def _launch_backward(operands, dz, geo):
    """K6 (one kernel and one reduce) on the forward's operands (b2 is not
    read) and the output cotangent dz: -> (dx, d attn_out, the concatenated
    float32 parameter cotangents)."""
    x = operands[0]
    dz = dz.to(x.dtype).contiguous()
    dx, dao = torch.empty_like(x), torch.empty_like(x)
    size = sum(_param_sizes(geo.D, geo.H))
    part = torch.empty((geo.bwd_blocks, size), device=x.device, dtype=torch.float32)
    dparams = torch.empty(size, device=x.device, dtype=torch.float32)
    p = [t.data_ptr() for t in operands[:9]]
    kernels.launch(
        "residual_ffn_bwd", _BWD_ARGTYPES, x.device,
        p[0], p[1], dz.data_ptr(), *p[2:], dx.data_ptr(), dao.data_ptr(), part.data_ptr(),
        dparams.data_ptr(), x.shape[0], geo.D, geo.H, geo.rows, *geo.strides, geo.eps,
        geo.bwd_blocks, geo.is_bf16,
    )
    fused_residual_ffn.backward_launches += 1
    return dx, dao, dparams


_P = ctypes.c_void_p
_TAIL = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, _P]
_FWD_ARGTYPES = [_P] * 11 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + _TAIL
_BWD_ARGTYPES = [_P] * 14 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + _TAIL


def _residual_ffn_cuda(x, attn_out, g1, b1, w1, bw1, w2, bw2, g2, b2, eps):
    operands, geo = _bind([x, attn_out, g1, b1, w1, bw1, w2, bw2, g2, b2], eps)
    return _launch(operands, geo)


# K5 as the operator ``tmar::residual_ffn_fwd`` on ``_layout``'s operands
RESIDUAL_FFN = kernels.define_op(
    "residual_ffn_fwd",
    "(Tensor x, Tensor attn_out, Tensor ln1_gain, Tensor ln1_bias, Tensor w1, Tensor b1, "
    "Tensor w2, Tensor b2, Tensor ln2_gain, Tensor ln2_bias, float eps) -> Tensor",
    _residual_ffn_cuda,
    lambda x, *_: x.new_empty(x.shape),
)
