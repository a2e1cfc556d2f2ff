"""N-gram context of one NSTB: plain version and CUDA kernel wrapper.

The counterpart of ``tmar.ops.pallas_ngram``.  On a [B, wh, ww, C] unigram
grid it computes both directional 4-token sliding attentions over the
sequence-reflect padded grid, their token means, and the [2C, D] merge.
``fused_ngram_context`` runs the plain version for a CPU tensor and launches
``csrc/ngram_context.cu`` for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tmar_torch.ops.attention import (
    LOGIT_SCALE_MAX,
    gather_rel_pos_bias,
    relative_position_index,
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
    ``ngram_context_math``.  A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel (float32 or bfloat16) or raises."""
    if u.device.type == "cpu":
        return ngram_context_math(
            u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge,
            num_heads=num_heads,
        )
    if u.device.type != "cuda":
        raise ValueError(f"fused_ngram_context: unsupported device {u.device}")
    operands, out, ints = _kernel_operands(
        u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, num_heads
    )
    _launch(operands, out, ints)
    return out


def _kernel_operands(u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge, num_heads):
    """Check the geometry and lay out the kernel's operands on u's device:
    returns (the 9 input tensors in the C entry point's order, the output,
    the entry point's integer arguments)."""
    B, wh, ww, C = u.shape
    A = wqkv.shape[1] // 3
    D = wmerge.shape[1]
    if wh < 2 or ww < 2:
        raise NotImplementedError(
            f"the n-gram context kernel needs a >= 2x2 window grid, got {wh}x{ww}; "
            "smaller grids need the block-diagonal attention kernel "
            "(ROADMAP queue 2, pallas_attention._attn_kernel)"
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


fused_ngram_context.launches = 0


_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _launch(operands, out, ints):
    from tmar_torch import kernels

    fn = kernels.entry("ngram_context", _ARGTYPES)
    dev = out.device
    with torch.cuda.device(dev):
        err = fn(
            *[t.data_ptr() for t in operands], out.data_ptr(), *ints,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check("ngram_context", err)
    fused_ngram_context.launches += 1
