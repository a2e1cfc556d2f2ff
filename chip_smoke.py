#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``tmar_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. the card (``nvidia-smi`` name and power limit) and the kernel build, timed;
2. each CUDA kernel against its plain PyTorch version on the card, at the
   shapes of the full-width NGswin's 8x512² forward (stage 1: 512² map, 6
   heads; stage 2: 256², 4 heads; n-gram grids 64², 32², 16²), at float32
   (TF32 off) and bfloat16, with the tolerances of
   ``tests/test_torch_port_gpu.py``; then each kernel's time from CUDA events
   at the stage-1 shape beside its plain version's time and its bound;
3. the serving path: the full-width NGswin with the trained weights
   ``reports/compare_r4/flagship.pth`` in bfloat16 answers a full-slice
   8x512² request, a full-slice 4x416² request (padded to 448²) and one 416²
   slice through the 64/32 tiled eval, with the launch counts reset just
   before and read just after (20 launches of each kernel per forward);
4. correctness: outputs finite and in [-1, 1]; a float32 run on the card
   against the port's CPU (plain) run at 1x128²; bfloat16 against float32 on
   the card at 8x512²; then the median request time at 8x512².

It prints a ``kernels`` JSON line, the card line, and last
``{"ok": true, "device": {...}}``.  It needs one CUDA card, exits non-zero
without one, and imports nothing of JAX or of the ``tmar`` package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "reports", "compare_r4", "flagship.pth")

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and FLOP/s by type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

F32_TOL = 1e-4     # x max(1, max|ref|): summation order and libm rounding
BF16_TOL = 2.0**-7  # x max|ref|: one bf16 rounding of the output, twice over


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ngram_work(B, wh, ww, nh, itemsize):
    """(FLOPs, bytes) the n-gram context needs: q/k/v once per cell, 4x4
    scores and AV per direction and head, the mean token's projection per
    direction, the merge; u read once, the context written once, weights."""
    C, D = 32, 64
    A = (C // nh) * nh
    cells = B * wh * ww
    flops = cells * (2 * C * 3 * A + 2 * (2 * 16 * A + 2 * 16 * A + 2 * A * C) + 2 * 2 * C * D)
    weights = 4 * (C * 3 * A + 3 * A + A * C + C + 2 * C * D + D + nh + 9 * nh)
    return flops, cells * (C + D) * itemsize + weights


def nstb_work(B, ph, pw, nh, Q, itemsize):
    """(FLOPs, bytes) the NSTB needs per token: qkv, scores, AV, projection,
    fc1, fc2; x read once, the output written once, the context quads and
    weights read once."""
    D, H, N = 64, 128, 64
    A = (D // nh) * nh
    tokens = B * ph * pw
    flops = tokens * 2 * (D * 3 * A + N * A + N * A + A * D + D * H + H * D)
    weights = itemsize * (D * 3 * A + A * D + 2 * D * H) + 4 * (3 * A + 6 * D + H + nh + 225 * nh)
    return flops, tokens * 2 * D * itemsize + (tokens // N) * Q * D * itemsize + weights


def bound_ms(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def err_and_tol(got, ref, dtype):
    import torch

    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    tol = F32_TOL * max(1.0, scale) if dtype == torch.float32 else BF16_TOL * scale
    return err, tol


def check_kernels(model, dev, card):
    """Phase 2: each kernel against its plain version on the card, then
    timed.  Returns the kernel records for the JSON line (without launches)."""
    import torch

    from tmar_torch.ops import cuda_ngram, cuda_nstb

    gen = torch.Generator(device=dev).manual_seed(0)
    failures = []
    records = {}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    # ---- K1: n-gram context, on the unigram grids of stages 1-3 ----------
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for name, stage, B, g in (("stage1", 1, 8, 64), ("stage2", 2, 8, 32), ("stage3", 3, 8, 16)):
        ctx_mod = getattr(model, f"encoder_layer{stage}").blocks[0].ngram_window_partition.ngram_context
        args = ctx_mod.kernel_args()
        u = randn(B, g, g, 32)
        for dtype in (torch.float32, torch.bfloat16):
            uu = u.to(dtype)
            got = cuda_ngram.fused_ngram_context(uu, *args)
            ref = cuda_ngram.ngram_context_math(uu.float(), *args[:-1], num_heads=args[-1])
            torch.cuda.synchronize()
            err, tol = err_and_tol(got, ref, dtype)
            dn = str(dtype).split(".")[1]
            errs[dn] = max(errs[dn], err)
            ok = err <= tol and bool(torch.isfinite(got).all())
            print(f"[kernel] ngram_context {name} u={list(uu.shape)} heads={args[-1]} {dn}: "
                  f"max_abs_err {err:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"ngram_context {name} {dn}")
    # time at the stage-1 grid, bf16 (the serving dtype) and f32
    ctx_mod = model.encoder_layer1.blocks[0].ngram_window_partition.ngram_context
    args = ctx_mod.kernel_args()
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        u = randn(8, 64, 64, 32).to(dtype)
        ops, out, ints = cuda_ngram._kernel_operands(u, *args)
        k_ms = cuda_ms(lambda: cuda_ngram._launch(ops, out, ints))
        p_ms = cuda_ms(lambda: cuda_ngram.ngram_context_math(u, *args[:-1], num_heads=args[-1]))
        dn = str(dtype).split(".")[1]
        flops, nbytes = ngram_work(8, 64, 64, 6, u.element_size())
        b_ms, b_by = bound_ms(flops, nbytes, dn)
        times[dn] = (k_ms, p_ms, b_ms, b_by)
        print(f"[time] ngram_context u=[8, 64, 64, 32] {dn}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB) on {card}")
    k_ms, p_ms, b_ms, b_by = times["bfloat16"]
    records["ngram_context"] = {
        "name": "ngram_context", "route": "cuda", "source": "tmar_torch/csrc/ngram_context.cu",
        "replaces": "tmar/ops/pallas_ngram.py:813", "max_abs_err": errs["float32"],
        "max_abs_err_bf16": errs["bfloat16"], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_f32": times["float32"][0], "plain_ms_f32": times["float32"][1],
        "shape": "u [8, 64, 64, 32] bf16, 6 heads",
    }

    # ---- K2: whole NSTB on the map, stage 1 (6 heads) and stage 2 (4) -----
    errs = {"float32": 0.0, "bfloat16": 0.0}
    cases = (("stage1", 1, 0, 512), ("stage1", 1, 1, 512), ("stage2", 2, 0, 256), ("stage2", 2, 1, 256))
    for name, stage, blk_i, size in cases:
        blk = getattr(model, f"encoder_layer{stage}").blocks[blk_i]
        args = blk.kernel_args()
        shift = blk.shift_size
        Q = 1 if shift == 0 else 4
        x = randn(8, size, size, 64)
        cq = randn(8 * (size // 8) ** 2, Q, 64, scale=0.5)
        for dtype in (torch.float32, torch.bfloat16):
            xx, cc = x.to(dtype), cq.to(dtype)
            got = cuda_nstb.fused_nstb_map(xx, cc, *args, shift=shift)
            ref_args = _round_nstb_mats(args, dtype)
            ref = cuda_nstb.nstb_map_math(
                xx.float(), cc.float(), *ref_args[:-2], num_heads=args[-2],
                window_size=args[-1], shift=shift,
            )
            torch.cuda.synchronize()
            err, tol = err_and_tol(got, ref, dtype)
            dn = str(dtype).split(".")[1]
            errs[dn] = max(errs[dn], err)
            ok = err <= tol and bool(torch.isfinite(got).all())
            print(f"[kernel] nstb_map {name} x={list(xx.shape)} heads={args[-2]} shift={shift} "
                  f"Q={Q} {dn}: max_abs_err {err:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"nstb_map {name} shift={shift} {dn}")
            del got, ref
        del x, cq
        torch.cuda.empty_cache()
    blk = model.encoder_layer1.blocks[1]  # stage 1, shift 4: the masked, Q = 4 block
    args = blk.kernel_args()
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = randn(8, 512, 512, 64).to(dtype)
        cq = randn(32768, 4, 64, scale=0.5).to(dtype)
        ops, out, ints = cuda_nstb._kernel_operands(x, cq, *args, shift=4)
        k_ms = cuda_ms(lambda: cuda_nstb._launch(ops, out, ints, 1e-5), iters=10)
        p_ms = cuda_ms(lambda: cuda_nstb.nstb_map_math(
            x, cq, *args[:-2], num_heads=args[-2], window_size=args[-1], shift=4), iters=3, warmup=1)
        dn = str(dtype).split(".")[1]
        flops, nbytes = nstb_work(8, 512, 512, 6, 4, x.element_size())
        b_ms, b_by = bound_ms(flops, nbytes, dn)
        times[dn] = (k_ms, p_ms, b_ms, b_by)
        print(f"[time] nstb_map x=[8, 512, 512, 64] heads=6 shift=4 {dn}: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e9:.3f} GB) on {card}")
        del x, cq, ops, out
        torch.cuda.empty_cache()
    k_ms, p_ms, b_ms, b_by = times["bfloat16"]
    records["nstb_map"] = {
        "name": "nstb_map", "route": "cuda", "source": "tmar_torch/csrc/nstb_map.cu",
        "replaces": "tmar/ops/pallas_nstb.py:640", "max_abs_err": errs["float32"],
        "max_abs_err_bf16": errs["bfloat16"], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_f32": times["float32"][0], "plain_ms_f32": times["float32"][1],
        "shape": "x [8, 512, 512, 64] bf16, 6 heads, shift 4",
    }
    if failures:
        raise SystemExit(f"kernel checks failed: {failures}")
    return records


def _round_nstb_mats(args, dtype):
    """The kernel reads the four matrices in the I/O dtype: give the float32
    reference the same rounded values."""
    wqkv, bqkv, ls, table, wproj, bproj, ln1, ffn1, ffn2, ln2, nh, ws = args
    r = lambda t: t.to(dtype).float()  # noqa: E731
    return (r(wqkv), bqkv, ls, table, r(wproj), bproj, ln1, (r(ffn1[0]), ffn1[1]),
            (r(ffn2[0]), ffn2[1]), ln2, nh, ws)


def serve(sd, card):
    """Phase 3-4: the serving path with the trained weights."""
    import torch

    from tmar_torch import NGswin, full_slice_eval, make_inference_fn, tiled_eval
    from tmar_torch.ops import cuda_ngram, cuda_nstb

    counters = (cuda_ngram.fused_ngram_context, cuda_nstb.fused_nstb_map)
    failures = []

    def check(cond, what):
        print(f"[check] {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(what)

    model = NGswin(dtype=torch.bfloat16)
    model.load_state_dict(sd)
    fwd = make_inference_fn(model)
    rng = np.random.default_rng(0)
    req512 = rng.uniform(-1, 1, (8, 512, 512, 1)).astype(np.float32)
    req416 = rng.uniform(-1, 1, (4, 416, 416, 1)).astype(np.float32)
    tile416 = rng.uniform(-1, 1, (1, 416, 416, 1)).astype(np.float32)
    fwd(req512[:1, :128, :128])  # first call: lazy CUDA/cuDNN set-up

    for f in counters:
        f.launches = 0
    outputs = {}
    for name, run, forwards in (
        ("full-slice 8x512²", lambda: full_slice_eval(fwd, req512), 1),
        ("full-slice 4x416²", lambda: full_slice_eval(fwd, req416), 1),
        ("tiled 1x416² 64/32", lambda: tiled_eval(fwd, tile416, 64, 32), 3),
    ):
        before = [f.launches for f in counters]
        y = run()
        got = [f.launches - b for f, b in zip(counters, before)]
        outputs[name] = y
        print(f"[serve] {name}: out {list(y.shape)} range [{y.min():.4f}, {y.max():.4f}] "
              f"launches ngram_context {got[0]}, nstb_map {got[1]} over {forwards} forward(s)")
        check(bool(np.isfinite(y).all()) and y.min() >= -1 and y.max() <= 1,
              f"{name} finite and in [-1, 1]")
        check(got == [20 * forwards] * 2, f"{name} 20 launches of each kernel per forward")
    launches = {f.__name__: f.launches for f in counters}
    check(outputs["full-slice 8x512²"].shape == req512.shape
          and outputs["full-slice 4x416²"].shape == req416.shape
          and outputs["tiled 1x416² 64/32"].shape == tile416.shape, "output shapes")

    # float32 on the card against the port's CPU (plain) run
    model32 = NGswin(dtype=torch.float32)
    model32.load_state_dict(sd)
    cpu32 = NGswin(dtype=torch.float32, device="cpu")
    cpu32.load_state_dict(sd)
    small = req512[:1, :128, :128]
    y_gpu = make_inference_fn(model32)(small)
    y_cpu = make_inference_fn(cpu32, device="cpu")(small)
    d = float(np.abs(y_gpu - y_cpu).max())
    print(f"[check] f32 card vs CPU plain at 1x128²: max_abs_err {d:.3e} tol 1e-4")
    check(d <= 1e-4, "f32 card vs CPU plain")

    # bfloat16 against float32 on the card: bf16 rounds every block's I/O
    # through 20 blocks; tolerance max 0.1, mean 1e-2 on the [-1, 1] output
    y32 = make_inference_fn(model32)(req512)
    diff = np.abs(outputs["full-slice 8x512²"] - y32)
    print(f"[check] bf16 vs f32 on the card at 8x512²: max {diff.max():.3e} (tol 0.1), "
          f"mean {diff.mean():.3e} (tol 1e-2)")
    check(diff.max() <= 0.1 and diff.mean() <= 1e-2, "bf16 vs f32 on the card")
    del model32, y32

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        full_slice_eval(fwd, req512)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(f"[time] full-slice 8x512² bf16 request (numpy in, numpy out): median {med * 1e3:.1f} ms "
          f"of {[round(t * 1e3, 1) for t in times]}, {8 / med:.2f} slices/s on {card}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_request(lambda: full_slice_eval(fwd, req512), card)
    if failures:
        raise SystemExit(f"serving checks failed: {failures}")
    return launches


def profile_request(request, card):
    """Where one request's time goes: device time by kernel from
    torch.profiler, and the device's idle share of the request's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if dev_us > 0 and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        print("[profile] torch.profiler recorded no device time: breakdown not measured")
        return
    print(f"[profile] full-slice 8x512² bf16 request under torch.profiler: wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy / 1e3:.1f} ms, idle share {1 - busy / wall_us:.3f} on {card}")
    for dev_us, count, key in sorted(rows, reverse=True)[:15]:
        print(f"[profile]   {dev_us / 1e3:9.3f} ms {100 * dev_us / busy:5.1f}% x{count:<4d} {key[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import tmar_torch
    from tmar_torch import NGswin, kernels, load_pth

    if not os.path.abspath(tmar_torch.__file__).startswith(ROOT):
        print("chip_smoke: tmar_torch is not this checkout's", file=sys.stderr)
        return 2
    if any(m == "jax" or m.startswith(("jax.", "flax", "tmar.")) or m == "tmar" for m in sys.modules):
        print("chip_smoke: JAX or the tmar package was imported", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"[card] {card}")
    t0 = time.perf_counter()
    kernels.build()
    print(f"[build] {', '.join(kernels.KERNELS)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(kernels.NVCC_FLAGS)})")
    for name, log in kernels.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    sd = load_pth(CKPT)
    dev = torch.device("cuda")
    ref_model = NGswin(dtype=torch.float32)
    ref_model.load_state_dict(sd)
    with torch.no_grad():
        records = check_kernels(ref_model, dev, card)
    del ref_model
    torch.cuda.empty_cache()

    launches = serve(sd, card)
    for name, rec in records.items():
        rec["launches"] = launches[f"fused_{name}"]
        rec["card"] = card
    print(json.dumps({"kernels": list(records.values())}))
    print(f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
