"""WindowAttention parameters (scaled-cosine, SwinV2-style), the counterpart
of ``tmar.nn.window_attention``.

The module holds ``logit_scale`` [nh, 1, 1] (initialised to ln 10), the
relative-position bias table [(2h-1)(2w-1), nh], and the ``qkv`` and
``proj`` linears, under the reference checkpoint's names.  The whole-block
inference kernels read them through ``params()``; ``forward`` is the
differentiable attention on [B_, N, D] windows, through
``fused_window_attention`` (forward and backward kernels on a CUDA tensor).

``recompute=True`` is the JAX package's ``attn_backward="xla"``: the
forward kernel K3 and, under autograd, the plain recompute in place of the
backward kernel K4 (``fused_window_attention``'s ``backward="xla"``).

``plain=True`` is the JAX package's plain attention (its
``use_pallas_attention=false`` path) as torch ops on every device, the form
that tensor parallelism splits: after ``split_heads_over`` the module
computes its rank's heads (its shards of ``qkv`` and ``proj``, its slices of
the logit scale and the bias table) between Megatron's f and g operators.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from tmar_torch.core.mesh import copy_to_model, local, qkv_row_order, reduce_from_model
from tmar_torch.nn.layers import Linear
from tmar_torch.ops.attention import (
    gather_rel_pos_bias,
    relative_position_index,
    window_attention_math,
)
from tmar_torch.ops.cuda_attention import fused_window_attention


class WindowAttention(nn.Module):
    def __init__(
        self,
        dim: int,
        num_heads: int,
        window_size: Tuple[int, int],
        head_dim: Optional[int] = None,
        qkv_bias: bool = True,
        plain: bool = False,
        recompute: bool = False,
    ):
        super().__init__()
        self.plain = plain
        self.backward = "xla" if recompute else "pallas"
        self.tp = None  # the model axis, once split_heads_over has run
        self.num_heads = num_heads
        self.window_size = tuple(window_size)
        hd = head_dim or dim // num_heads
        attn_dim = hd * num_heads
        win_h, win_w = self.window_size
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * win_h - 1) * (2 * win_w - 1), num_heads)
        )
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02, a=-0.04, b=0.04)
        self.qkv = Linear(dim, 3 * attn_dim, bias=qkv_bias)
        self.proj = Linear(attn_dim, dim)

    def forward(self, x: torch.Tensor, mask_components: Optional[tuple] = None) -> torch.Tensor:
        """x [B_, N, D] windows -> [B_, N, D]; mask_components is the
        decomposed shift mask (m_row, m_col, wh, ww) or None."""
        if self.plain:
            return self._forward_plain(x, mask_components)
        wqkv, bqkv, logit_scale, _, wproj, bproj = self.params()
        return fused_window_attention(
            x, wqkv, bqkv, logit_scale, self.bias(), wproj, bproj, self.num_heads,
            mask_components=mask_components, backward=self.backward,
        )

    def _forward_plain(self, x: torch.Tensor, mask_components) -> torch.Tensor:
        tp = self.tp
        heads = slice(None) if tp is None else tp.heads(self.num_heads)
        nh = self.num_heads // (1 if tp is None else tp.size)
        cd = x.dtype
        bqkv = None if self.qkv.bias is None else local(self.qkv.bias).to(cd)
        bias = gather_rel_pos_bias(self.relative_position_bias_table[:, heads],
                                   relative_position_index(*self.window_size), nh)
        out = window_attention_math(
            copy_to_model(x, tp), local(self.qkv.weight).t().to(cd), bqkv,
            self.logit_scale[heads], bias, local(self.proj.weight).t().to(cd), None, nh,
            mask_components=mask_components,
        )
        return reduce_from_model(out, tp) + self.proj.bias.to(cd)

    def split_heads_over(self, tp):
        """Prepare the plain form to run this rank's heads of the model axis
        ``tp`` (``tmar_torch.core.mesh.apply_tensor_parallel`` then shards
        the weights): returns (the parameters it uses in part, whose
        gradients sum over the model axis; {name: row order at rest} of the
        fused qkv)."""
        if not self.plain:
            raise ValueError("tensor parallelism splits the plain form of the attention only")
        if self.num_heads % tp.size:
            raise ValueError(f"{self.num_heads} heads do not split over {tp.size} model ranks")
        self.tp = tp
        hd = self.qkv.weight.shape[0] // (3 * self.num_heads)
        order = qkv_row_order(self.num_heads, hd, tp.size)
        orders = {"qkv.weight": order}
        if self.qkv.bias is not None:
            orders["qkv.bias"] = order
        return [self.logit_scale, self.relative_position_bias_table], orders

    def params(self):
        """(wqkv [in, 3A], bqkv, logit_scale, table, wproj [A, out], bproj)."""
        return (
            self.qkv.weight.t(), self.qkv.bias, self.logit_scale,
            self.relative_position_bias_table, self.proj.weight.t(), self.proj.bias,
        )

    def bias(self) -> torch.Tensor:
        """The gathered relative-position bias [nh, N, N]."""
        return gather_rel_pos_bias(
            self.relative_position_bias_table,
            relative_position_index(*self.window_size),
            self.num_heads,
        )
