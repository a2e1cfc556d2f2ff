"""NSTB — the N-Gram Swin Transformer Block (the counterpart of
``tmar.nn.blocks``), in several forms over one parameter set, selected by
``attn_backward`` as in the JAX package:

* ``"auto"``: which kernels run depends, as in the JAX package, on whether
  the forward is differentiated.  Under autograd (grad enabled and x or a
  parameter requiring grad) it takes the training form's path below: the
  same function through the kernels that have backward kernels (K1 with
  K7, K3 with K4, K5 with K6), the port's counterpart of the JAX package's
  XLA math under grad.  Without grad, the inference form, in one of three
  block forms chosen by the constructor arguments that stand in for the JAX
  package's environment variables (``nstb_fused`` for ``TMAR_NSTB_FUSED``,
  ``nstb_map`` for ``TMAR_NSTB_MAP``):

  - fused, map (the default): the whole-block fusion on the map, two
    forward-only kernels per block (``fused_ngram_context``,
    ``fused_nstb_map``);
  - fused, tokens (``nstb_map=False``): the n-gram context, then roll and
    partition, the 2x2 context quads (Q = 4 even at shift 0, as the JAX
    token form passes them), ``fused_nstb`` on the windows, unpartition and
    reverse roll;
  - unfused (``nstb_fused=False``): the training form's code path below;
    served under ``torch.no_grad()`` it runs the forward kernels only.  The
    JAX package's ``TMAR_ATTN_IMPL`` names a TPU attention kernel here; every
    name computes the same function, which K3 computes
    (``tmar_torch.ops.cuda_attention.IMPLS``), so the block takes no name;

* ``"pallas"``, training: the n-gram context through
  ``fused_ngram_context`` (or, with ``ngram_fused=False``, on its composition
  path), the window attention through ``fused_window_attention`` and the
  post-norm residual FFN through ``fused_residual_ffn``; all three have
  backward kernels.  ``nstb_fused`` and ``nstb_map`` are ignored here, as the JAX package's block fusion stands aside in training;

* ``"xla"``: as ``"auto"``, except that under autograd the window attention
  runs K3 forward and the plain recompute backward (the JAX package's
  Pallas forward with the recompute VJP), so K4 never runs;

* ``"plain"``: the JAX package's ``use_pallas_attention=false`` path, the
  unfused block as torch ops on every device (no kernel), the form that
  tensor parallelism splits: after ``tensor_parallel`` the attention runs
  the rank's heads and the FFN its share of the hidden features, and the
  partial sums of ``proj`` and ``fc2`` are all-reduced (Megatron's g)
  before LN1 and LN2, their biases added once.

Post-norm residual order, as in the reference: ``x + norm1(attn(x))`` then
``x + norm2(mlp(x))``.  The block returns ``(x_in, x_out)`` so stages can
apply the within-stage residual ``next_input = out + prev_input``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

import torch.nn.functional as F

from tmar_torch.core.mesh import copy_to_model, local, reduce_from_model
from tmar_torch.nn.layers import LayerNorm, Mlp
from tmar_torch.nn.ngram import NGramWindowPartition, check_attn_backward
from tmar_torch.nn.window_attention import WindowAttention
from tmar_torch.ops.cuda_ffn import fused_residual_ffn
from tmar_torch.ops.cuda_nstb import context_quads, fused_nstb, fused_nstb_map
from tmar_torch.ops.ffn import layer_norm
from tmar_torch.ops.window import (
    reverse_cyclic_shift,
    shift_mask_components,
    window_unpartition,
)


class NSTB(nn.Module):
    def __init__(
        self,
        dim: int,
        ngram: int,
        num_heads: int,
        window_size: int,
        shift_size: int,
        head_dim: Optional[int] = None,
        mlp_ratio: float = 2.0,
        qkv_bias: bool = True,
        attn_backward: str = "auto",
        ngram_fused: bool = True,
        nstb_fused: bool = True,
        nstb_map: bool = True,
    ):
        super().__init__()
        self.attn_backward = check_attn_backward(attn_backward)
        if not 0 <= shift_size < window_size:
            raise ValueError(f"shift_size {shift_size} outside [0, {window_size})")
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        inference = self.attn_backward in ("auto", "xla")
        self.nstb_fused = bool(nstb_fused) and inference
        self.nstb_map = bool(nstb_map)
        self.ngram_window_partition = NGramWindowPartition(
            dim, window_size, ngram, num_heads, attn_backward, ngram_fused
        )
        self.tp = None  # the model axis, once tensor_parallel has run
        self.attn = WindowAttention(dim, num_heads, (window_size, window_size), head_dim, qkv_bias,
                                    plain=attn_backward == "plain",
                                    recompute=attn_backward == "xla")
        self.norm1 = LayerNorm(dim)
        self.ffn = Mlp(dim, int(dim * mlp_ratio), dim)
        self.norm2 = LayerNorm(dim)

    def forward(
        self, x: torch.Tensor, num_patches: Tuple[int, int]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, ph*pw, D] -> (x_in, x_out)."""
        ph, pw = num_patches
        B, p, D = x.shape
        if p != ph * pw:
            raise ValueError("token count does not match the patch grid")
        if not self.nstb_fused or self._differentiated(x):
            return x, self._forward_unfused(x, num_patches)
        if not self.nstb_map:
            return x, self._forward_tokens(x, num_patches)
        xmap, (wh, ww), ctx = self.ngram_window_partition(x.reshape(B, ph, pw, D))
        if self.shift_size == 0:
            cq = ctx.reshape(-1, 1, D)  # every token reads its own window's context
        else:
            cq = context_quads(ctx, self.shift_size).reshape(-1, 4, D)
        zmap = fused_nstb_map(
            xmap, cq, *self.kernel_args(), shift=self.shift_size, eps=self.norm1.eps
        )
        out = reverse_cyclic_shift(zmap, self.shift_size)
        return x, out.reshape(B, p, D)

    def _differentiated(self, x: torch.Tensor) -> bool:
        """Whether autograd records this call: the inference form's
        whole-block kernels are forward-only, so such a call takes the
        training form's path."""
        return torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))

    def _forward_tokens(self, x: torch.Tensor, num_patches: Tuple[int, int]) -> torch.Tensor:
        ph, pw = num_patches
        B, p, D = x.shape
        ws = self.window_size
        windows, (wh, ww), ctx = self.ngram_window_partition.windows(
            x.reshape(B, ph, pw, D), self.shift_size
        )
        cq = context_quads(ctx, self.shift_size).reshape(-1, 4, D)
        z = fused_nstb(
            windows.reshape(-1, ws * ws, D), cq, *self.kernel_args(), shift=self.shift_size,
            grid=(wh, ww), eps=self.norm1.eps,
        )
        out = window_unpartition(z.reshape(-1, ws, ws, D), (wh, ww))
        return reverse_cyclic_shift(out, self.shift_size).reshape(B, p, D)

    def _forward_unfused(self, x: torch.Tensor, num_patches: Tuple[int, int]) -> torch.Tensor:
        ph, pw = num_patches
        B, p, D = x.shape
        ws = self.window_size
        windows, (wh, ww) = self.ngram_window_partition.partition(
            x.reshape(B, ph, pw, D), self.shift_size
        )
        mask_components = None
        if self.shift_size > 0:
            mask_components = (*shift_mask_components(ws, self.shift_size), wh, ww)
        attn = self.attn(windows.reshape(-1, ws * ws, D), mask_components=mask_components)
        attn = window_unpartition(attn.reshape(-1, ws, ws, D), (wh, ww))
        attn = reverse_cyclic_shift(attn, self.shift_size)
        if self.attn_backward == "plain":
            return self._ffn_plain(x.reshape(B * p, D), attn.reshape(B * p, D)).reshape(B, p, D)
        z = fused_residual_ffn(
            x.reshape(B * p, D), attn.reshape(B * p, D),
            self.norm1.weight, self.norm1.bias,
            self.ffn.fc1.weight.t(), self.ffn.fc1.bias,
            self.ffn.fc2.weight.t(), self.ffn.fc2.bias,
            self.norm2.weight, self.norm2.bias, eps=self.norm1.eps,
        )
        return z.reshape(B, p, D)

    def _ffn_plain(self, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """``ffn_math`` as torch ops; under tensor parallelism on the rank's
        hidden features, the fc2 partial sums reduced before LN2."""
        eps, tp = self.norm1.eps, self.tp
        y = x.float() + layer_norm(attn.float(), self.norm1.weight, self.norm1.bias, eps)
        h = F.gelu(copy_to_model(y, tp) @ local(self.ffn.fc1.weight).t().float()
                   + local(self.ffn.fc1.bias).float(), approximate="none")
        o = reduce_from_model(h @ local(self.ffn.fc2.weight).t().float(), tp)
        z = y + layer_norm(o + self.ffn.fc2.bias.float(), self.norm2.weight, self.norm2.bias, eps)
        return z.to(x.dtype)

    def tensor_parallel(self, tp):
        """Run this block's attention heads and FFN hidden features of the
        model axis ``tp`` (the plain form only): returns what
        ``WindowAttention.split_heads_over`` returns, names relative to the
        block."""
        if self.attn_backward != "plain":
            raise ValueError("tensor parallelism splits the plain form (attn_backward='plain')")
        if self.ffn.fc1.weight.shape[0] % tp.size:
            raise ValueError(f"{self.ffn.fc1.weight.shape[0]} hidden features do not split over "
                             f"{tp.size} model ranks")
        self.tp = tp
        summed, orders = self.attn.split_heads_over(tp)
        return summed, {f"attn.{k}": v for k, v in orders.items()}

    def kernel_args(self):
        """This block's weights as ``fused_nstb_map`` and ``fused_nstb``
        take them, from ``wqkv`` to ``window_size``."""
        return (
            *self.attn.params(),
            (self.norm1.weight, self.norm1.bias),
            (self.ffn.fc1.weight.t(), self.ffn.fc1.bias),
            (self.ffn.fc2.weight.t(), self.ffn.fc2.bias),
            (self.norm2.weight, self.norm2.bias),
            self.num_heads,
            self.window_size,
        )
