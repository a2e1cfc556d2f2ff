"""Fused post-norm residual FFN with a fused backward: CUDA kernel wrapper
(the counterpart of ``tmar.ops.pallas_ffn`` with ``backward="pallas"``).

    y = x + LN1(attn_out)
    z = y + LN2(fc2(GELU(fc1(y))))

``fused_residual_ffn``'s plain version is ``tmar_torch.ops.ffn.ffn_math``
under ordinary autograd, which a CPU tensor takes.  A CUDA tensor goes
through a ``torch.autograd.Function`` whose forward launches
``csrc/residual_ffn_fwd.cu`` and whose backward launches
``csrc/residual_ffn_bwd.cu`` (all ten cotangents, recomputed from x and
attn_out), or raises.  The kernels compute in float32 on the float32
parameters whatever the activation dtype.
"""

from __future__ import annotations

import ctypes

import torch

from tmar_torch.device import float32_data
from tmar_torch.ops.ffn import ffn_math

KERNEL_DIMS = (64, 128)  # (D, hidden) the kernels are compiled for


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
    version; a CUDA tensor launches the kernels (float32 or bfloat16, any M)
    or raises."""
    if x.device.type == "cpu":
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
        from tmar_torch import kernels

        M, D = x.shape
        H = w1.shape[1]
        if (D, H) != KERNEL_DIMS or tuple(w2.shape) != (H, D):
            raise NotImplementedError(
                f"residual FFN kernels are built for (D, hidden) = {KERNEL_DIMS}; "
                f"got D={D}, hidden={H}, w2 {tuple(w2.shape)}"
            )
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"fused_residual_ffn: unsupported dtype {x.dtype}")
        if attn_out.shape != x.shape or M < 1:
            raise ValueError(f"fused_residual_ffn: x {tuple(x.shape)}, attn_out {tuple(attn_out.shape)}")
        dev = x.device
        x = x.detach().contiguous()
        ao = attn_out.detach().to(x.dtype).contiguous()
        vecs = [float32_data(t, True) for t in (g1, b1, bw1, bw2, g2, b2)]
        w_1, w_2 = float32_data(w1), float32_data(w2)
        out = torch.empty_like(x)
        blocks = min((M + 63) // 64, kernels.sm_count(dev))
        tail = (
            *w_1.stride(), *w_2.stride(), float(eps), blocks, int(x.dtype == torch.bfloat16)
        )
        g1_, b1_, bw1_, bw2_, g2_, b2_ = vecs
        kernels.launch(
            "residual_ffn_fwd", _FWD_ARGTYPES, dev,
            x.data_ptr(), ao.data_ptr(), g1_.data_ptr(), b1_.data_ptr(), w_1.data_ptr(),
            bw1_.data_ptr(), w_2.data_ptr(), bw2_.data_ptr(), g2_.data_ptr(),
            b2_.data_ptr(), out.data_ptr(), M, *tail,
        )
        fused_residual_ffn.launches += 1
        ctx.save_for_backward(x, ao, g1_, b1_, w_1, bw1_, w_2, bw2_, g2_)
        ctx.tail = tail
        ctx.grad_dtypes = [t.dtype for t in (attn_out, g1, b1, w1, bw1, w2, bw2, g2, b2)]
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dz):
        from tmar_torch import kernels

        x, ao, g1, b1, w1, bw1, w2, bw2, g2 = ctx.saved_tensors
        M, D = x.shape
        H = w1.shape[1]
        dev = x.device
        blocks = ctx.tail[-2]
        dz = dz.to(x.dtype).contiguous()
        sizes = [D, D, D * H, H, H * D, D, D, D]
        dx, dao = torch.empty_like(x), torch.empty_like(x)
        part = torch.empty((blocks, sum(sizes)), device=dev, dtype=torch.float32)
        dparams = torch.empty(sum(sizes), device=dev, dtype=torch.float32)
        kernels.launch(
            "residual_ffn_bwd", _BWD_ARGTYPES, dev,
            x.data_ptr(), ao.data_ptr(), dz.data_ptr(), g1.data_ptr(), b1.data_ptr(),
            w1.data_ptr(), bw1.data_ptr(), w2.data_ptr(), bw2.data_ptr(), g2.data_ptr(),
            dx.data_ptr(), dao.data_ptr(), part.data_ptr(), dparams.data_ptr(), M,
            *ctx.tail,
        )
        fused_residual_ffn.backward_launches += 1
        dg1, db1, dw1, dbw1, dw2, dbw2, dg2, db2 = torch.split(dparams, sizes)
        grads = [dao, dg1, db1, dw1.reshape(D, H), dbw1, dw2.reshape(H, D), dbw2, dg2, db2]
        grads = [t.to(dt) for t, dt in zip(grads, ctx.grad_dtypes)]
        return (dx, *grads, None)


_P = ctypes.c_void_p
_TAIL = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, _P]
_FWD_ARGTYPES = [_P] * 11 + [ctypes.c_longlong] + _TAIL
_BWD_ARGTYPES = [_P] * 14 + [ctypes.c_longlong] + _TAIL
