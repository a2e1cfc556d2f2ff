#!/usr/bin/env python3
"""Compare checkouts of the port (``tmar_torch``) on one CUDA card, in turns.

    python3 chip_ab.py [--kernels | --long] TREE [TREE ...]

Each TREE is the root of a checkout (this one is ``.``), for example an
earlier commit unpacked with ``git archive`` into a gitignored directory.
The trees run one after another, each in a fresh process that builds its
own kernels, in the order given: list them as A B B A to see the spread
between processes beside the difference between trees.  Each prints, on
lines tagged ``[ab TREE]``:

* K1 and K7 (the n-gram context's forward and backward), the launch alone
  on operands laid out once by that tree's wrapper, at the 8x512² request's
  stage-1 grid (u [8, 64, 64, 32]) and the 8x128² train step's (u
  [8, 16, 16, 32]), 6 heads, bf16 and f32;
* K2 (the whole block on the map), the launch alone, at the 8x512² stage-1
  shift-4 block with the flagship's weights, bf16, three times;
* the trainer's ``full`` step at 8x128² bf16, by that tree's
  ``chip_smoke.train_full`` (its ``[time]`` and ``[profile]`` lines).

With ``--kernels`` it prints, in place of K2 and the step, K5 and K6, K1
and K7 at bf16 and f32 at each geometry of that tree's
``chip_smoke.WIDTH_FFN_CASES`` and ``WIDTH_NGRAM_CASES`` (their generic
bodies; the demo stage 1 first, the ragged / odd cases, the envelope's
top), the launch alone, the device time alone by torch.profiler (K7's
summed over its three launches, K6's over its kernel and reduce) and the
rounding-matched plain version's time; then K3 and K4 at
bf16 at each geometry of that tree's ``chip_smoke.WIDTH_ATTN_CASES`` with
windows of 32 to 64 tokens (their generic bodies; the demo 8x64² step's
stage 1 first) and at ``SHORT_ATTN_CASES`` (window 4, a ragged window
count), the launch alone and its device time by torch.profiler
(``chip_smoke.device_ms``, K4's by kernel); then the training kernels'
launch alone (K3/K4 with their device time) (that tree's ``chip_smoke.attention_launch_ms`` and
``ffn_launch_ms``) at the full-width NGswin's geometries, bf16 and f32:
K3/K4 at the 8x128² step's stage 1 (2048 windows of 64 tokens, 6 x 10
heads) and at its n-gram windows (2048 of N = 4, 9 and 1 on 32 channels,
6 x 5 and 4 x 8 heads), shift mask on; K5/K6 at 131,072 rows; then K2 and K8 (the
whole block on the map and on its rolled windows), the launch alone, at
the 8x512² stage-1 shift-4 block with the flagship's weights, bf16 and f32,
and at bf16 at every geometry of that tree's ``chip_smoke.WIDTH_NSTB_CASES``
(the demo 8x256² request's stage 1 first; shift ws/2, Q 4, random weights
from a seed), where their generic bodies run; then the long-window
bodies at bf16 (``LONG_ATTN_AB``, ``LONG_NSTB_AB``): K3/K4 at the
window-16 8x128² step's stage 1 (512 windows of 256 tokens, 6 x 10 heads,
mask on) and with heads of 64, K2 at the window-16 8x512² request's stage
1 and the 8x128² map, K8 on that map's rolled windows, K2 at the
head_dim=64 model's 2x256² stage 1; the launch alone and the device time
alone of the long-window kernels (names holding "long"), and their
device time by kernel (``device_profile``).  ``--long``
prints those long-window rows alone.

Times are CUDA events (``chip_smoke.cuda_ms``), beside the card's name and
power limit.  Needs one card; imports nothing of JAX or of ``tmar``.
"""

from __future__ import annotations

import os
import subprocess
import sys


def training_kernels(cs, tag, card, randn):
    """K3/K4 and K5/K6, the launch alone, at the full-width NGswin's
    geometries (see the module docstring)."""
    import torch

    from tmar_torch.ops import cuda_attention as ca
    from tmar_torch.ops import envelope
    from tmar_torch.ops.window import shift_mask_components

    # the 64-token windows, then the n-gram windows (n = 2, 3, 1) at both
    # head splits, shift mask on (stage 1's 16 x 16 grid of windows)
    for N, D, nh, hd in ((64, 64, 6, 10), *((n * n, 32, nh, hd) for n in (2, 3, 1)
                                            for nh, hd in ((6, 5), (4, 8)))):
        dtypes = (torch.bfloat16, torch.float32)
        A, nwin, ws = nh * hd, 2048, int(round(N ** 0.5))
        mc = (*shift_mask_components(ws, ws // 2), 16, 16)
        params = [randn(D, 3 * A, scale=0.1), randn(3 * A, scale=0.1),
                  torch.full((nh, 1, 1), 1.2, device="cuda"), randn(nh, N, N, scale=0.2),
                  randn(A, D, scale=0.1), randn(D, scale=0.1)]
        x, g = randn(nwin, N, D), randn(nwin, N, D)
        for dtype in dtypes:
            fwd, bwd = cs.attention_launch_ms(x.to(dtype), params, g.to(dtype), nh, mc)
            d3, d4 = attention_device_ms(cs, ca, x.to(dtype), params, g.to(dtype), nh, mc)
            print(f"{tag} K3/K4 launch alone, x [{nwin}, {N}, {D}] {str(dtype).split('.')[1]}, "
                  f"{nh} x {hd} heads, mask {'on' if mc else 'off'} "
                  f"({envelope.attention_body(N, D, nh, hd, dtype)}): forward {fwd:.4f} ms, "
                  f"backward {bwd:.4f} ms; device time alone forward {d3:.4f} ms, backward "
                  f"{sum(d4.values()):.4f} ms on {card}", flush=True)
            short = (short_body_device_ms(cs, ca, x.to(dtype), params, g.to(dtype), nh, mc)
                     if dtype == torch.bfloat16 and N < 32 else None)
            if short:
                print(f"{tag} K3/K4 short-window bodies (their own C entries, not a dispatch), "
                      f"x [{nwin}, {N}, {D}] bfloat16, {nh} x {hd} heads, mask on: device time "
                      f"alone forward {short[0]:.4f} ms, backward {short[1]:.4f} ms on {card}",
                      flush=True)
    M, D, H = 131072, 64, 128
    params = [randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1), randn(D, H, scale=0.1),
              randn(H, scale=0.1), randn(H, D, scale=0.1), randn(D, scale=0.1),
              randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1)]
    x, ao, g = randn(M, D), randn(M, D), randn(M, D)
    for dtype in (torch.bfloat16, torch.float32):
        fwd, bwd = cs.ffn_launch_ms(x.to(dtype), ao.to(dtype), params, g.to(dtype))
        print(f"{tag} K5/K6 launch alone, x [{M}, {D}] {str(dtype).split('.')[1]}: forward "
              f"{fwd:.4f} ms, backward {bwd:.4f} ms on {card}", flush=True)


# K4's device kernels in every body: the per-window (or per-tile) kernel
# (the short-window body's reduce too: window_attention_bwd_smma_reduce),
# the tensor-core bodies' token sums, the reduce of the partial sums
K4_KERNELS = ("window_attention_bwd", "attention_param_sums", "reduce_partials",
              "reduce_backward_partials")

# windows shorter than 32 tokens off the full-width NGswin's n-gram
# geometries (bf16: the short-window bodies, before them the CUDA-core
# generic ones): (label, windows, N, D, heads, head_dim, window side, mask
# grid): window 4 at stage 1 of the 8x128² step, and a ragged window count
# (the last unit and tile part-filled) at n = 2
SHORT_ATTN_CASES = (
    ("window 4 shift", 2048, 16, 32, 2, 16, 4, (16, 16)),
    ("demo ngram n=2 ragged", 1003, 4, 16, 2, 8, 2, None),
)


def short_body_device_ms(cs, ca, x, params, g, nh, mc):
    """(K3's, K4's) device time alone of the short-window bodies through
    their own C entries (``tmar_window_attention_*_smma``, not a dispatch)
    on the wrapper's operands, or None in a tree without them."""
    import ctypes

    import torch

    from tmar_torch import kernels

    try:
        fwd = kernels.host_function("window_attention_fwd", "tmar_window_attention_fwd_smma",
                                    ca._FWD_ARGTYPES, ctypes.c_int)
        bwd = kernels.host_function("window_attention_bwd", "tmar_window_attention_bwd_smma",
                                    ca._BWD_ARGTYPES, ctypes.c_int)
        wsq = kernels.host_function("window_attention_bwd",
                                    "tmar_window_attention_bwd_smma_workspace",
                                    [ctypes.c_int] * 5, ctypes.c_longlong)
    except AttributeError:
        return None
    ops, geo = ca._kernel_operands(x, *params, nh, mc)
    p = [ca._ptr(t) for t in ops]
    nwin, N, D = x.shape
    A = params[0].shape[1] // 3
    out, lse, dx = torch.empty_like(x), torch.empty(nwin, nh, N, device=x.device), torch.empty_like(x)
    work = torch.empty(wsq(nwin, N, D, nh, A // nh), device=x.device)
    dp = torch.empty(D * 3 * A + 3 * A + nh + nh * N * N + A * D + D, device=x.device)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    k3 = lambda: kernels.check("window_attention_fwd", fwd(  # noqa: E731
        *p, out.data_ptr(), lse.data_ptr(), None, *geo.ints(False), stream()))
    k4 = lambda: kernels.check("window_attention_bwd", bwd(  # noqa: E731
        p[0], g.contiguous().data_ptr(), *p[1:5], p[5], p[7], p[8], lse.data_ptr(),
        dx.data_ptr(), work.data_ptr(), dp.data_ptr(), *geo.ints(True), stream()))
    k3()
    d3, _ = cs.device_ms(k3, "window_attention_fwd_smma", calls=10)
    d4, _ = cs.device_ms(k4, "window_attention_bwd_smma", calls=10)
    return d3, d4


def attention_device_ms(cs, ca, x, params, g, nh, mc):
    """(K3's device time alone, {K4's kernel: device time alone}) in ms per
    launch on operands laid out once, by the tree's ``chip_smoke.device_ms``
    (one name at a time: an earlier tree's takes one); the counters are put
    back."""
    f = ca.fused_window_attention
    before = (f.launches, f.backward_launches)
    ops, geo = ca._kernel_operands(x, *params, nh, mc)
    d3, _ = cs.device_ms(lambda: ca._launch(ops, geo), "window_attention_fwd", calls=10)
    _, lse = ca._launch(ops, geo)
    d4 = {part: cs.device_ms(lambda: ca._launch_backward(ops, lse, g, geo), part, calls=10)[0]
          for part in K4_KERNELS}
    f.launches, f.backward_launches = before
    return d3, d4


def generic_attention_kernels(cs, tag, card):
    """K3 and K4 at bf16, the launch alone and its device time, at each
    geometry of the tree's ``chip_smoke.WIDTH_ATTN_CASES`` with windows of
    32 to 64 tokens (the demo 8x64² step's stage 1 first), where their
    generic bodies run, and at ``SHORT_ATTN_CASES``, on operands laid out
    once by that tree's wrapper from one seed."""
    import torch

    from tmar_torch.ops import cuda_attention as ca
    from tmar_torch.ops.window import shift_mask_components

    gen = torch.Generator(device="cuda").manual_seed(21)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + shift

    for label, nwin, N, D, nh, hd, ws, grid in (
            *(c for c in cs.WIDTH_ATTN_CASES if c[2] >= 32), *SHORT_ATTN_CASES):
        A = nh * hd
        params = [randn(D, 3 * A, scale=0.1), randn(3 * A, scale=0.1),
                  torch.full((nh, 1, 1), 1.2, device="cuda"), randn(nh, N, N, scale=0.2),
                  randn(A, D, scale=0.1), randn(D, scale=0.1)]
        x = randn(nwin, N, D).to(torch.bfloat16)
        g = randn(nwin, N, D).to(torch.bfloat16)
        mc = None if grid is None else (*shift_mask_components(ws, ws // 2), *grid)
        fwd, bwd = cs.attention_launch_ms(x, params, g, nh, mc)
        d3, d4 = attention_device_ms(cs, ca, x, params, g, nh, mc)
        print(f"{tag} K3/K4 launch alone, {label} x [{nwin}, {N}, {D}] bf16, {nh} x {hd} heads, "
              f"mask {'on' if mc else 'off'}: forward {fwd:.4f} ms, backward {bwd:.4f} ms; "
              f"device time alone forward {d3:.4f} ms, backward {sum(d4.values()):.4f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in d4.items() if v) + f") on {card}", flush=True)
        del x, g
    torch.cuda.empty_cache()


# K5's, K6's, K1's and K7's device kernels in every body (the main kernels
# and their reduces): the names torch.profiler gives them hold one of these
K5_KERNELS = ("residual_ffn_fwd",)
K6_KERNELS = ("ffn_bwd", "reduce_partials")
K1_KERNELS = ("ngram_context_",)
K7_KERNELS = ("ngram_bwd",)


def generic_ffn_ngram_kernels(cs, tag, card):
    """K5, K6, K1 and K7 at bf16 and f32 at each geometry of the tree's
    ``chip_smoke.WIDTH_FFN_CASES`` and ``WIDTH_NGRAM_CASES`` (the demo stage
    1, the ragged / odd cases, the envelope's top), where their generic
    bodies run: the launch alone by CUDA events, the device time alone by
    torch.profiler (summed over each call's kernels: K7's three, K6's main
    kernel and reduce, K5's and K1's one) and the rounding-matched plain
    version's time, on operands laid out once by that tree's wrappers from
    one seed; the counters are put back."""
    import torch

    from tmar_torch.ops import cuda_ffn as cf
    from tmar_torch.ops import cuda_ngram as cn

    gen = torch.Generator(device="cuda").manual_seed(22)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + shift

    f = cf.fused_residual_ffn
    before = (f.launches, f.backward_launches)
    for label, M, D, H in cs.WIDTH_FFN_CASES:
        params = [randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1), randn(D, H, scale=0.1),
                  randn(H, scale=0.1), randn(H, D, scale=0.1), randn(D, scale=0.1),
                  randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1)]
        x, ao, g = randn(M, D), randn(M, D), randn(M, D)
        for dtype in (torch.bfloat16, torch.float32):
            xx, aa, gg = x.to(dtype), ao.to(dtype), g.to(dtype)
            ops, geo = cf._kernel_operands(xx, aa, *params, 1e-5)
            dn = str(dtype).split('.')[1]
            k5 = cs.cuda_ms(lambda: cf._launch(ops, geo), iters=20)
            dev5 = sum(cs.device_ms(lambda: cf._launch(ops, geo), part, calls=10)[0]
                       for part in K5_KERNELS)
            plain5 = cs.cuda_ms(lambda: cf.ffn_kernel_math(xx, aa, *params), iters=10)
            print(f"{tag} K5 {label} x [{M}, {D}] hidden {H} {dn}: launch alone {k5:.4f} ms, "
                  f"device time alone {dev5:.4f} ms, plain {plain5:.4f} ms on {card}", flush=True)
            k6 = cs.cuda_ms(lambda: cf._launch_backward(ops, gg, geo), iters=20)
            dev = sum(cs.device_ms(lambda: cf._launch_backward(ops, gg, geo), part, calls=10)[0]
                      for part in K6_KERNELS)
            plain = cs.cuda_ms(lambda: cf.ffn_backward_math(xx, aa, *params, gg), iters=10)
            print(f"{tag} K6 {label} x [{M}, {D}] hidden {H} {str(dtype).split('.')[1]}: launch "
                  f"alone {k6:.4f} ms, device time alone {dev:.4f} ms, plain {plain:.4f} ms on "
                  f"{card}", flush=True)
            del ops
    f.launches, f.backward_launches = before
    f = cn.fused_ngram_context
    before = (f.launches, f.backward_launches)
    for label, B, wh, ww, C, D, nh, hd in cs.WIDTH_NGRAM_CASES:
        A = nh * hd
        params = [randn(C, 3 * A, scale=0.2), randn(3 * A, scale=0.1),
                  torch.full((nh, 1, 1), 1.2, device="cuda"), randn(9, nh, scale=0.5),
                  randn(A, C, scale=0.2), randn(C, scale=0.1), randn(2 * C, D, scale=0.2),
                  randn(D, scale=0.1)]
        u, g = randn(B, wh, ww, C), randn(B, wh, ww, D)
        for dtype in (torch.bfloat16, torch.float32):
            uu, gg = u.to(dtype), g.to(dtype)
            ops, out, ints = cn._kernel_operands(uu, *params, nh)
            dn = str(dtype).split('.')[1]
            k1 = cs.cuda_ms(lambda: cn._launch(ops, out, ints), iters=50)
            dev1, n1 = cs.device_ms(lambda: cn._launch(ops, out, ints), K1_KERNELS[0], calls=10)
            plain1 = cs.cuda_ms(lambda: cn.ngram_context_kernel_math(uu, *params, num_heads=nh),
                                iters=5)
            print(f"{tag} K1 {label} u [{B}, {wh}, {ww}, {C}] D {D} {nh} x {hd} heads {dn}: "
                  f"launch alone {k1:.4f} ms, device time alone {dev1:.4f} ms ({n1} kernels), "
                  f"plain {plain1:.4f} ms on {card}", flush=True)
            k7 = cs.cuda_ms(lambda: cn._launch_backward(ops[:-1], gg, ints), iters=50)
            dev, n7 = cs.device_ms(lambda: cn._launch_backward(ops[:-1], gg, ints), K7_KERNELS[0],
                                   calls=10)
            plain = cs.cuda_ms(lambda: cn.ngram_context_kernel_backward_math(
                uu, gg, *params, num_heads=nh), iters=5)
            print(f"{tag} K7 {label} u [{B}, {wh}, {ww}, {C}] D {D} {nh} x {hd} heads "
                  f"{str(dtype).split('.')[1]}: launch alone {k7:.4f} ms, device time alone "
                  f"{dev:.4f} ms ({n7} kernels), plain {plain:.4f} ms on {card}", flush=True)
            del ops, out
    f.launches, f.backward_launches = before
    torch.cuda.empty_cache()


def whole_block_kernels(cs, tag, card, randn):
    """K2 and K8, the launch alone, on operands laid out once by that tree's
    wrappers (their signatures have not changed since they were written),
    at the 8x512² stage-1 shift-4 block with the flagship's weights; the
    counters are put back."""
    import torch

    from tmar_torch import NGswin, load_pth
    from tmar_torch.ops import cuda_nstb
    from tmar_torch.ops.window import cyclic_shift, window_partition

    model = NGswin(dtype=torch.float32)
    model.load_state_dict(load_pth(cs.CKPT))
    args = model.encoder_layer1.blocks[1].kernel_args()
    before = (cuda_nstb.fused_nstb_map.launches, cuda_nstb.fused_nstb.launches)
    with torch.no_grad():
        x = randn(8, 512, 512, 64)
        cq = randn(8 * 64 * 64, 4, 64, scale=0.5)
        for dtype in (torch.bfloat16, torch.float32):
            xx, cc = x.to(dtype), cq.to(dtype)
            ops, out, ints = cuda_nstb._kernel_operands(xx, cc, *args, shift=4)
            k2 = cs.cuda_ms(lambda: cuda_nstb._launch(ops, out, ints, 1e-5), iters=10)
            wins = window_partition(cyclic_shift(xx, 4), 8)[0].reshape(-1, 64, 64)
            tops, tout, tints = cuda_nstb._token_operands(wins, cc, *args, 4, (64, 64))
            k8 = cs.cuda_ms(lambda: cuda_nstb._launch_tokens(tops, tout, tints, 1e-5), iters=10)
            print(f"{tag} K2/K8 launch alone, x [8, 512, 512, 64] {str(dtype).split('.')[1]}, 6 "
                  f"heads, shift 4: K2 {k2:.4f} ms, K8 {k8:.4f} ms on {card}", flush=True)
            del ops, out, wins, tops, tout
    cuda_nstb.fused_nstb_map.launches, cuda_nstb.fused_nstb.launches = before
    del model, x, cq
    torch.cuda.empty_cache()


def generic_block_kernels(cs, tag, card):
    """K2 and K8 at bf16, the launch alone, at each geometry of the tree's
    ``chip_smoke.WIDTH_NSTB_CASES`` (shift ws/2, Q 4), on operands laid out
    once by that tree's wrappers from one seed; the counters are put back."""
    import torch

    from tmar_torch.ops import cuda_nstb
    from tmar_torch.ops.window import cyclic_shift, window_partition

    gen = torch.Generator(device="cuda").manual_seed(20)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + shift

    before = (cuda_nstb.fused_nstb_map.launches, cuda_nstb.fused_nstb.launches)
    with torch.no_grad():
        for label, B, wh, ww, D, nh, hd, H, ws in cs.WIDTH_NSTB_CASES:
            A, N, shift = nh * hd, ws * ws, ws // 2
            ln = (randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1))
            args = (randn(D, 3 * A, scale=0.15), randn(3 * A, scale=0.1),
                    randn(nh, 1, 1, scale=0.5, shift=1.4), randn((2 * ws - 1) ** 2, nh, scale=0.5),
                    randn(A, D, scale=0.15), randn(D, scale=0.1), ln,
                    (randn(D, H, scale=0.15), randn(H, scale=0.1)),
                    (randn(H, D, scale=0.1), randn(D, scale=0.1)), ln, nh, ws)
            x = randn(B, wh * ws, ww * ws, D).to(torch.bfloat16)
            cq = randn(B * wh * ww, 4, D, scale=0.5).to(torch.bfloat16)
            ops, out, ints = cuda_nstb._kernel_operands(x, cq, *args, shift=shift)
            k2 = cs.cuda_ms(lambda: cuda_nstb._launch(ops, out, ints, 1e-5), iters=10)
            wins = window_partition(cyclic_shift(x, shift), ws)[0].reshape(-1, N, D)
            tops, tout, tints = cuda_nstb._token_operands(wins, cq, *args, shift, (wh, ww))
            k8 = cs.cuda_ms(lambda: cuda_nstb._launch_tokens(tops, tout, tints, 1e-5), iters=10)
            print(f"{tag} K2/K8 launch alone, {label} x [{B}, {wh * ws}, {ww * ws}, {D}] bf16, "
                  f"{nh} x {hd} heads, hidden {H}, window {ws}, shift {shift}: K2 {k2:.4f} ms, "
                  f"K8 {k8:.4f} ms on {card}", flush=True)
            del ops, out, wins, tops, tout, x, cq
    cuda_nstb.fused_nstb_map.launches, cuda_nstb.fused_nstb.launches = before
    torch.cuda.empty_cache()


# the long-window bodies' rows, bf16: K3/K4 (label, windows, N, D, heads,
# head_dim, mask grid) and K2/K8 (label, form, B, side, D, heads, head_dim),
# window 16, hidden 128, shift 8
LONG_LIBS = ("window_attention_fwd", "window_attention_bwd", "nstb_map", "nstb_tokens")
LONG_ATTN_AB = (("window-16 step stage 1", 512, 256, 64, 6, 10, (8, 8)),
                ("head_dim 64 window 16", 512, 256, 64, 6, 64, (8, 8)))
LONG_NSTB_AB = (("window-16 8x512² request stage 1", "map", 8, 512, 64, 6, 10),
                ("window-16 8x128² stage 1", "map", 8, 128, 64, 6, 10),
                ("window-16 8x128² stage 1", "token", 8, 128, 64, 6, 10),
                ("head_dim 64 2x256² stage 1", "map", 2, 256, 64, 6, 64))


def long_window_kernels(cs, tag, card):
    """K3/K4 and K2/K8 on the long-window bodies at bf16 (``LONG_ATTN_AB``,
    ``LONG_NSTB_AB``): the launch alone by CUDA events and the device time
    alone of the kernels whose names hold "long" (the CUDA-core bodies'
    ``attn_long::`` / ``nstb_long::`` and the tensor-core ones' ``long_mma::``
    / ``nstb_long::nstb_tail_tc``), on operands laid out once by that tree's
    wrappers from one seed."""
    import torch

    from tmar_torch.ops import cuda_attention as ca
    from tmar_torch.ops import cuda_nstb
    from tmar_torch.ops.window import cyclic_shift, shift_mask_components, window_partition

    from tmar_torch.utils.profiling import device_profile

    gen = torch.Generator(device="cuda").manual_seed(25)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + shift

    def by_kernel(label, fn):
        def call():  # ends on the device: no call's kernels run into the next's trace step
            fn()
            torch.cuda.synchronize()

        rows = [r for r in device_profile(call, iters=3, top=1 << 30) if "long" in r["op"]]
        print(f"{tag} {label} by device kernel, ms per call: " + "; ".join(
            f"{r['op']} {r['ms']:.4f} (x{r['count']} in 3)" for r in rows) + f" on {card}",
            flush=True)

    for label, nwin, N, D, nh, hd, grid in LONG_ATTN_AB:
        A, ws = nh * hd, int(round(N ** 0.5))
        params = [randn(D, 3 * A, scale=0.1), randn(3 * A, scale=0.1),
                  torch.full((nh, 1, 1), 1.2, device="cuda"), randn(nh, N, N, scale=0.2),
                  randn(A, D, scale=0.1), randn(D, scale=0.1)]
        x = randn(nwin, N, D).to(torch.bfloat16)
        g = randn(nwin, N, D).to(torch.bfloat16)
        mc = (*shift_mask_components(ws, ws // 2), *grid)
        fwd, bwd = cs.attention_launch_ms(x, params, g, nh, mc, iters=5)
        ops, geo = ca._kernel_operands(x, *params, nh, mc)
        d3, n3 = cs.device_ms(lambda: ca._launch(ops, geo), "long", calls=5)
        _, lse = ca._launch(ops, geo)
        d4, n4 = cs.device_ms(lambda: ca._launch_backward(ops, lse, g, geo), "long", calls=5)
        print(f"{tag} K3/K4 long-window launch alone, {label} x [{nwin}, {N}, {D}] bf16, {nh} x "
              f"{hd} heads, mask on: forward {fwd:.4f} ms, backward {bwd:.4f} ms; device time "
              f"alone forward {d3:.4f} ms ({n3} kernels), backward {d4:.4f} ms ({n4} kernels) on "
              f"{card}", flush=True)
        by_kernel(f"K3 {label}", lambda: ca._launch(ops, geo))
        by_kernel(f"K4 {label}", lambda: ca._launch_backward(ops, lse, g, geo))
        del ops, lse, x, g
        torch.cuda.empty_cache()
    before = (cuda_nstb.fused_nstb_map.launches, cuda_nstb.fused_nstb.launches)
    with torch.no_grad():
        for label, form, B, side, D, nh, hd in LONG_NSTB_AB:
            A, ws, H, shift = nh * hd, 16, 128, 8
            ln = (randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1))
            args = (randn(D, 3 * A, scale=0.15), randn(3 * A, scale=0.1),
                    randn(nh, 1, 1, scale=0.5, shift=1.4), randn((2 * ws - 1) ** 2, nh, scale=0.5),
                    randn(A, D, scale=0.15), randn(D, scale=0.1), ln,
                    (randn(D, H, scale=0.15), randn(H, scale=0.1)),
                    (randn(H, D, scale=0.1), randn(D, scale=0.1)), ln, nh, ws)
            x = randn(B, side, side, D).to(torch.bfloat16)
            cq = randn(B * (side // ws) ** 2, 4, D, scale=0.5).to(torch.bfloat16)
            if form == "map":
                ops, out, ints = cuda_nstb._kernel_operands(x, cq, *args, shift=shift)
                fn = lambda: cuda_nstb._launch(ops, out, ints, 1e-5)  # noqa: E731
            else:
                wins = window_partition(cyclic_shift(x, shift), ws)[0].reshape(-1, ws * ws, D)
                ops, out, ints = cuda_nstb._token_operands(wins, cq, *args, shift,
                                                           (side // ws, side // ws))
                fn = lambda: cuda_nstb._launch_tokens(ops, out, ints, 1e-5)  # noqa: E731
            ms = cs.cuda_ms(fn, iters=5, warmup=1)
            dev, n = cs.device_ms(fn, "long", calls=3)
            print(f"{tag} {'K2' if form == 'map' else 'K8'} long-window launch alone, {label} x "
                  f"[{B}, {side}, {side}, {D}] bf16, {nh} x {hd} heads, window {ws}, shift "
                  f"{shift}: {ms:.4f} ms; device time alone {dev:.4f} ms ({n} kernels) on {card}",
                  flush=True)
            by_kernel(f"{'K2' if form == 'map' else 'K8'} {label}", fn)
            del ops, out, x, cq
            torch.cuda.empty_cache()
    cuda_nstb.fused_nstb_map.launches, cuda_nstb.fused_nstb.launches = before


def run_tree(tree: str, kernels_only: bool = False, long_only: bool = False) -> int:
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from tmar_torch import NGswin, kernels, load_pth
    from tmar_torch.ops import cuda_ngram, cuda_nstb

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.abspath(kernels.__file__).startswith(tree):
        print(f"chip_ab: tmar_torch is not {tree}'s", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # --long: the four libraries of the long-window bodies alone
    kernels.build(LONG_LIBS if long_only else kernels.KERNELS)
    card = cs.card_line()
    tag = f"[ab {os.path.relpath(tree, os.path.dirname(os.path.abspath(__file__)))}]"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    if long_only:
        long_window_kernels(cs, tag, card)
        return 0
    C, D, nh = 32, 64, 6
    A = 30
    params = [randn(C, 3 * A, scale=0.2), randn(3 * A, scale=0.1),
              torch.rand(nh, 1, 1, generator=gen, device=dev) * 1.8 + 0.5, randn(9, nh, scale=0.5),
              randn(A, C, scale=0.2), randn(C, scale=0.1), randn(2 * C, D, scale=0.2),
              randn(D, scale=0.1)]
    f = cuda_ngram.fused_ngram_context
    for grid in (64, 16):
        for dtype in (torch.bfloat16, torch.float32):
            # the wrapper's own operand layout and launch functions (their
            # signatures have not changed since they were written); the
            # counters are put back
            u, g = randn(8, grid, grid, C).to(dtype), randn(8, grid, grid, D).to(dtype)
            before = (f.launches, f.backward_launches)
            ops, out, ints = cuda_ngram._kernel_operands(u, *params, nh)
            fwd = cs.cuda_ms(lambda: cuda_ngram._launch(ops, out, ints), iters=50)
            bwd = cs.cuda_ms(lambda: cuda_ngram._launch_backward(ops[:-1], g, ints), iters=50)
            f.launches, f.backward_launches = before
            print(f"{tag} K1/K7 launch alone, u [8, {grid}, {grid}, 32] {str(dtype).split('.')[1]}, "
                  f"6 heads: forward {fwd:.4f} ms, backward {bwd:.4f} ms on {card}", flush=True)

    if kernels_only:
        generic_ffn_ngram_kernels(cs, tag, card)
        generic_attention_kernels(cs, tag, card)
        training_kernels(cs, tag, card, randn)
        whole_block_kernels(cs, tag, card, randn)
        generic_block_kernels(cs, tag, card)
        long_window_kernels(cs, tag, card)
        return 0
    model = NGswin(dtype=torch.float32)
    model.load_state_dict(load_pth(cs.CKPT))
    args = model.encoder_layer1.blocks[1].kernel_args()
    with torch.no_grad():
        x = randn(8, 512, 512, 64).to(torch.bfloat16)
        cq = randn(8 * 64 * 64, 4, 64, scale=0.5).to(torch.bfloat16)
        ops, out, ints = cuda_nstb._kernel_operands(x, cq, *args, shift=4)
        k2 = [cs.cuda_ms(lambda: cuda_nstb._launch(ops, out, ints, 1e-5), iters=10) for _ in range(3)]
    print(f"{tag} K2 launch alone, x [8, 512, 512, 64] bf16, 6 heads, shift 4: "
          f"{', '.join(f'{v:.4f}' for v in k2)} ms on {card}", flush=True)
    del model, x, cq, ops, out
    torch.cuda.empty_cache()
    cs.train_full(card)
    return 0


def main(argv) -> int:
    kernels_only, long_only = "--kernels" in argv, "--long" in argv
    argv = [a for a in argv if a not in ("--kernels", "--long")]
    if len(argv) == 3 and argv[1] == "--tree":
        return run_tree(argv[2], kernels_only, long_only)
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    flag = ["--kernels"] if kernels_only else ["--long"] if long_only else []
    for tree in argv[1:]:
        rc |= subprocess.call([sys.executable, os.path.abspath(__file__), *flag, "--tree", tree])
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
