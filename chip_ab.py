#!/usr/bin/env python3
"""Compare checkouts of the port (``tmar_torch``) on one CUDA card, in turns.

    python3 chip_ab.py [--kernels] TREE [TREE ...]

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

With ``--kernels`` it prints, in place of K2 and the step, the training
kernels' launch alone (that tree's ``chip_smoke.attention_launch_ms`` and
``ffn_launch_ms``) at the full-width NGswin's geometries, bf16 and f32:
K3/K4 at the 8x128² step's stage 1 (2048 windows of 64 tokens, 6 x 10
heads, shift mask on) and at its n-gram windows (2048 of N = 4, 9 and 1 on
32 channels, 6 x 5 heads); K5/K6 at 131,072 rows; then K2 and K8 (the
whole block on the map and on its rolled windows), the launch alone, at
the 8x512² stage-1 shift-4 block with the flagship's weights, bf16 and f32.

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

    from tmar_torch.ops.window import shift_mask_components

    for N, D, nh, hd, dtypes in ((64, 64, 6, 10, (torch.bfloat16, torch.float32)),
                                 (4, 32, 6, 5, (torch.bfloat16, torch.float32)),
                                 (9, 32, 6, 5, (torch.bfloat16, torch.float32)),
                                 (1, 32, 6, 5, (torch.bfloat16, torch.float32))):
        A, nwin = nh * hd, 2048
        mc = (*shift_mask_components(8, 4), 16, 16) if N == 64 else None
        params = [randn(D, 3 * A, scale=0.1), randn(3 * A, scale=0.1),
                  torch.full((nh, 1, 1), 1.2, device="cuda"), randn(nh, N, N, scale=0.2),
                  randn(A, D, scale=0.1), randn(D, scale=0.1)]
        x, g = randn(nwin, N, D), randn(nwin, N, D)
        for dtype in dtypes:
            fwd, bwd = cs.attention_launch_ms(x.to(dtype), params, g.to(dtype), nh, mc)
            print(f"{tag} K3/K4 launch alone, x [{nwin}, {N}, {D}] {str(dtype).split('.')[1]}, "
                  f"{nh} x {hd} heads, mask {'on' if mc else 'off'}: forward {fwd:.4f} ms, "
                  f"backward {bwd:.4f} ms on {card}", flush=True)
    M, D, H = 131072, 64, 128
    params = [randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1), randn(D, H, scale=0.1),
              randn(H, scale=0.1), randn(H, D, scale=0.1), randn(D, scale=0.1),
              randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1)]
    x, ao, g = randn(M, D), randn(M, D), randn(M, D)
    for dtype in (torch.bfloat16, torch.float32):
        fwd, bwd = cs.ffn_launch_ms(x.to(dtype), ao.to(dtype), params, g.to(dtype))
        print(f"{tag} K5/K6 launch alone, x [{M}, {D}] {str(dtype).split('.')[1]}: forward "
              f"{fwd:.4f} ms, backward {bwd:.4f} ms on {card}", flush=True)


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


def run_tree(tree: str, kernels_only: bool = False) -> int:
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
    kernels.build()
    card = cs.card_line()
    tag = f"[ab {os.path.relpath(tree, os.path.dirname(os.path.abspath(__file__)))}]"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

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
        training_kernels(cs, tag, card, randn)
        whole_block_kernels(cs, tag, card, randn)
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
    kernels_only = "--kernels" in argv
    argv = [a for a in argv if a != "--kernels"]
    if len(argv) == 3 and argv[1] == "--tree":
        return run_tree(argv[2], kernels_only)
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    flag = ["--kernels"] if kernels_only else []
    for tree in argv[1:]:
        rc |= subprocess.call([sys.executable, os.path.abspath(__file__), *flag, "--tree", tree])
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
