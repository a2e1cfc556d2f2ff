"""N-gram context of one NSTB: plain version and CUDA kernel wrapper.

The counterpart of ``tmar.ops.pallas_ngram``.  On a [B, wh, ww, C] unigram
grid it computes both directional 4-token sliding attentions over the
sequence-reflect padded grid, their token means, and the [2C, D] merge.
``fused_ngram_context`` runs the plain version for a CPU tensor.  A CUDA
tensor goes through a ``torch.autograd.Function`` whose forward launches
``csrc/ngram_context.cu`` and whose backward launches
``csrc/ngram_context_bwd.cu`` (du and every parameter cotangent, recomputed
from u), or raises.  ``ngram_context_backward_math`` is the backward's plain
version: autograd through ``ngram_context_math``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tmar_torch.ops.attention import (
    LOGIT_SCALE_MAX,
    gather_rel_pos_bias,
    relative_position_index,
    static_gather_transpose,
    window_attention_math,
)
from tmar_torch.ops.ngram import seq_refl_win_pad, sliding_patches

# (num_heads, head_dim) pairs the kernel is compiled for: the full-width
# NGswin's 6- and 4-head stages on the D/2 = 32-channel unigram grid
KERNEL_HEADS = {(6, 5), (4, 8)}


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
    launches the kernels (float32 or bfloat16), forward and backward, or
    raises."""
    if u.device.type == "cpu":
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


class _NGramContext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, num_heads):
        params = (wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge)
        operands, out, ints = _kernel_operands(u.detach(), *params, num_heads)
        _launch(operands, out, ints)
        # bmerge (the last operand) has no part in the backward
        ctx.save_for_backward(*operands[:-1], logit_scale)
        ctx.ints = ints
        ctx.grad_dtypes = [None if t is None else t.dtype for t in params]
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *operands, logit_scale = ctx.saved_tensors
        u, scale = operands[0], operands[3]
        nh, hd = ctx.ints[3:5]
        C, A = u.shape[-1], nh * hd
        D = 2 * C
        du, (dwqkv, dbqkv, dscale, dbias, dwproj, dbproj, dwmerge, dbmerge) = _launch_backward(
            operands, g.to(u.dtype).contiguous(), ctx.ints
        )
        # the kernel's cotangent is on the effective scale exp(min(ls, ln 100)):
        # d/d ls = scale below the clip, zero above it
        ls = logit_scale.detach().to(torch.float32).reshape(nh)
        dls = (dscale * scale * (ls <= LOGIT_SCALE_MAX)).reshape(logit_scale.shape)
        # dbias [16 (query, key) pairs, nh] -> the [9, nh] table: the transpose
        # of gather_rel_pos_bias
        dtable = static_gather_transpose(dbias.reshape(16, nh), relative_position_index(2, 2), 9)
        grads = [
            dwqkv.reshape(C, 3 * A), dbqkv, dls, dtable, dwproj.reshape(A, C), dbproj,
            dwmerge.reshape(2 * C, D), dbmerge,
        ]
        grads = [None if dt is None else t.to(dt) for t, dt in zip(grads, ctx.grad_dtypes)]
        return (du, *grads, None)


def _kernel_operands(u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, num_heads):
    """Check the geometry and lay out the kernel's operands on u's device:
    returns (the 9 input tensors in the C entry point's order, the output,
    the entry point's integer arguments)."""
    B, wh, ww, C = u.shape
    A = wqkv.shape[1] // 3
    D = wmerge.shape[1]
    if wh < 2 or ww < 2:
        raise NotImplementedError(
            f"the n-gram context kernel needs a >= 2x2 window grid, got {wh}x{ww}: "
            "the sequence-reflect padding has nothing to reflect on a smaller one"
        )
    if (C, D) != (32, 64) or A % num_heads or (num_heads, A // num_heads) not in KERNEL_HEADS:
        raise NotImplementedError(
            f"ngram_context kernel is built for C=32, D=64, (heads, head_dim) in "
            f"{sorted(KERNEL_HEADS)}; got C={C}, D={D}, heads={num_heads}, A={A}"
        )
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_ngram_context: unsupported dtype {u.dtype}")
    dev = u.device

    def f32(t):
        return t.detach().to(device=dev, dtype=torch.float32).contiguous()

    operands = [
        u.contiguous(),
        f32(wqkv),
        torch.zeros(3 * A, device=dev) if bqkv is None else f32(bqkv),
        torch.exp(torch.clamp(f32(logit_scale).reshape(num_heads), max=LOGIT_SCALE_MAX)),
        f32(table),
        f32(wproj),
        torch.zeros(C, device=dev) if bproj is None else f32(bproj),
        f32(wmerge),
        f32(bmerge),
    ]
    out = torch.empty((B, wh, ww, D), device=dev, dtype=u.dtype)
    ints = (B, wh, ww, num_heads, A // num_heads, int(u.dtype == torch.bfloat16))
    return operands, out, ints


_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _launch_backward(operands, g, ints):
    """Launch the backward kernel on the forward's first eight operands (u to
    wmerge) and the output cotangent g, allocating du, the workspace of
    per-window slots and the per-block partial sums.  Returns (du, the eight
    float32 parameter cotangents as flat views of one buffer, in the C entry
    point's order)."""
    from tmar_torch import kernels

    u = operands[0]
    B, wh, ww, nh, hd, is_bf16 = ints
    C, A = u.shape[-1], nh * hd
    D = 2 * C
    dev = u.device
    sizes = [C * 3 * A, 3 * A, nh, 16 * nh, A * C, C, 2 * C * D, D]
    # pass 1 runs one block per SM over tiles of 16 cells of a grid row,
    # pass 2 up to two per SM over tiles of 32 positions
    sms = kernels.sm_count(dev)
    blocks1 = min(B * wh * ((ww + 15) // 16), sms)
    blocks2 = min((B * wh * ww + 31) // 32, 2 * sms)
    du = torch.empty_like(u)
    ws = torch.empty((B * wh * ww, 2, 4, 3 * A), device=dev, dtype=torch.float32)
    part = torch.empty(
        blocks1 * sum(sizes[2:]) + blocks2 * sum(sizes[:2]), device=dev, dtype=torch.float32
    )
    dparams = torch.empty(sum(sizes), device=dev, dtype=torch.float32)
    kernels.launch(
        "ngram_context_bwd", _BWD_ARGTYPES, dev,
        u.data_ptr(), g.data_ptr(), *[t.data_ptr() for t in operands[1:]],
        du.data_ptr(), ws.data_ptr(), part.data_ptr(), dparams.data_ptr(),
        B, wh, ww, nh, hd, blocks1, blocks2, is_bf16,
    )
    fused_ngram_context.backward_launches += 1
    return du, torch.split(dparams, sizes)


def _launch(operands, out, ints):
    from tmar_torch import kernels

    kernels.launch(
        "ngram_context", _ARGTYPES, out.device,
        *[t.data_ptr() for t in operands], out.data_ptr(), *ints,
    )
    fused_ngram_context.launches += 1
