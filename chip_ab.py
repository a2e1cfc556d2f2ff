#!/usr/bin/env python3
"""Compare checkouts of the port (``tmar_torch``) on one CUDA card, in turns.

    python3 chip_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (this one is ``.``), for example an
earlier commit unpacked with ``git archive`` into a gitignored directory.
The trees run one after another, each in a fresh process that builds its
own kernels, in the order given: list them as A B B A to see the spread
between processes beside the difference between trees.  Each prints, on
lines tagged ``[ab TREE]``:

* K5 and K6 (the residual FFN's forward and backward), the launch alone on
  operands laid out once, at 131,072 rows (the 8x128² train step's stage 1)
  and 2,097,152 rows (the 8x512² unfused serving form's), bf16 and f32;
* K2 (the whole block on the map), the launch alone, at the 8x512² stage-1
  shift-4 block with the flagship's weights, bf16, three times;
* the trainer's ``full`` step at 8x128² bf16, by that tree's
  ``chip_smoke.train_full`` (its ``[time]`` and ``[profile]`` lines).

Times are CUDA events (``chip_smoke.cuda_ms``), beside the card's name and
power limit.  Needs one card; imports nothing of JAX or of ``tmar``.
"""

from __future__ import annotations

import os
import subprocess
import sys


def run_tree(tree: str) -> int:
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from tmar_torch import NGswin, kernels, load_pth
    from tmar_torch.device import float32_data
    from tmar_torch.ops import cuda_ffn, cuda_nstb

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

    D, H = 64, 128
    g1, b1, w1, bw1, w2, bw2, g2, b2 = [
        randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1), randn(D, H, scale=0.1),
        randn(H, scale=0.1), randn(H, D, scale=0.1), randn(D, scale=0.1),
        randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1)]
    for M in (131072, 2097152):
        for dtype in (torch.bfloat16, torch.float32):
            # the C entry points as the wrapper calls them (their
            # arguments have not changed since they were written), without
            # the wrapper's counters
            x, ao, dz = (randn(M, D).to(dtype) for _ in range(3))
            blocks = min((M + 63) // 64, kernels.sm_count(dev))
            tail = (*w1.stride(), *w2.stride(), 1e-5, blocks, int(dtype == torch.bfloat16))
            out, dx, dao = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
            size = 2 * D + D * H + H + H * D + 3 * D
            part = torch.empty((blocks, size), device=dev)
            dparams = torch.empty(size, device=dev)
            p = [float32_data(t).data_ptr() for t in (g1, b1, w1, bw1, w2, bw2, g2, b2)]
            fwd = cs.cuda_ms(lambda: kernels.launch(
                "residual_ffn_fwd", cuda_ffn._FWD_ARGTYPES, dev, x.data_ptr(), ao.data_ptr(), *p,
                out.data_ptr(), M, *tail))
            bwd = cs.cuda_ms(lambda: kernels.launch(
                "residual_ffn_bwd", cuda_ffn._BWD_ARGTYPES, dev, x.data_ptr(), ao.data_ptr(),
                dz.data_ptr(), *p[:7], dx.data_ptr(), dao.data_ptr(), part.data_ptr(),
                dparams.data_ptr(), M, *tail))
            print(f"{tag} K5/K6 launch alone, x [{M}, 64] {str(dtype).split('.')[1]}: forward "
                  f"{fwd:.4f} ms, backward {bwd:.4f} ms on {card}", flush=True)
            del x, ao, dz, out, dx, dao, part
            torch.cuda.empty_cache()

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
    if len(argv) == 3 and argv[1] == "--tree":
        return run_tree(argv[2])
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in argv[1:]:
        rc |= subprocess.call([sys.executable, os.path.abspath(__file__), "--tree", tree])
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
