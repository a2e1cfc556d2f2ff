#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``tmar_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run if it fails:

1. the card (``nvidia-smi`` name and power limit) and the kernel build, timed;
2. each CUDA kernel against its plain PyTorch version on the card, at the
   shapes of the full-width NGswin's 8x512² forward (stage 1: 512² map, 6
   heads; stage 2: 256², 4 heads; n-gram grids 64², 32², 16²), at float32
   (TF32 off) and bfloat16, with the tolerances of
   ``tests/test_torch_port_gpu.py`` (at bfloat16 the n-gram context K1 and
   the whole-block kernels K2 and K8 against their plain versions at
   bfloat16, which round where the kernels' tensor-core bodies and the JAX
   kernels round, with the distance to the float32 plain version printed
   beside it, and for K2 at stage 1 both sides' distance to that function
   evaluated in float64 between its rounding points); then each kernel's
   time from CUDA events at the stage-1 shape (K2 also at stage 2's, K1
   also at the 8x128² train step's 8x16x16 grid) beside its plain version's
   time and its bound (K1 also as device time alone, by torch.profiler);
3. the serving path: the full-width NGswin with the trained weights
   ``reports/compare_r4/flagship.pth`` in bfloat16 answers a full-slice
   8x512² request, a full-slice 4x416² request (padded to 448²) and one 416²
   slice through the 64/32 tiled eval, with the launch counts reset just
   before and read just after (20 launches of each kernel per forward);
4. correctness: outputs finite and in [-1, 1]; a float32 run on the card
   against the port's CPU (plain) run at 1x128²; bfloat16 against float32 on
   the card at 8x512²; then the median request time at 8x512²;
5. the training kernels (window attention, residual FFN and the n-gram
   context's backward) against their plain versions' autograd on the card,
   forward and every cotangent, at the shapes of the 8x128² train step (2048
   windows of 64 tokens with 6 heads, with and without the shift mask; 512
   with 4 heads; 2048 and 512 n-gram windows of 4 tokens, and of 9 and 1
   (the composition path at n = 3 and n = 1); 131,072 FFN rows;
   n-gram grids 8x16x16 at 6 heads, 8x8x8 and 8x4x4 at 4, and also 8x64x64,
   13x7 and 2x2), at float32 (TF32 off) and bfloat16 (at bfloat16 against
   their rounding-matched plain forwards and explicit backwards, the
   distance to the float32 plain version printed beside it; the FFN also at
   1000 rows, a ragged last tile), each backward run twice and compared bit
   for bit; the n-gram backward's device kernels per call counted by
   torch.profiler (three: two passes and one reduce); then each kernel's
   time (as the launch alone and through the wrapper) beside its plain
   version's and its bound;
6. the composition training path: the full-width NGswin in its training
   form with ``ngram_fused=False`` and the 3-scale spectral-norm PatchGAN,
   from a seed, take 3 warm-up and 10 timed GAN steps in bfloat16 on a fixed
   seeded 8x128² batch (the recipe without the sinogram term,
   ``fused_pairs``, TTUR Adam, EMA), with the launch counts reset just
   before and read just after; every metric finite at every step and
   ``g_rec`` falling; steps/s, and one step's breakdown;
7. training correctness: one float32 step at 1x128² on the card against the
   same step on the CPU (plain versions) from the same state, loss terms and
   the gradients of both networks; then the trained generator, loaded into
   the inference form, serves one request;
8. the Radon projector at 8x128² and 180 angles: forward and adjoint on the
   card against the port's CPU run, the adjoint identity, their times;
9. the trainer: ``Trainer(load_config(train_syndeeplesion.yaml, synthetic
   data, batch 8, EMA)).fit()`` takes two epochs of four ``full``-variant
   steps at full width, validates once, writes checkpoints, and a fresh
   trainer resumes to the same state bit for bit; then ``trainer.train_step``
   takes 3 warm-up and 20 timed steps on one fixed batch on the card, with
   the launch counts reset just before and read just after (20 launches per
   step of each of the six training kernels: the n-gram context is one
   forward and one backward kernel per block), and one step's breakdown
   (its kernels and copies at most ``FULL_STEP_MAX_KERNELS``);
   then one float32 ``full`` step at 1x128² on the card against the CPU;
10. the token-level whole-block kernel (K8) against its plain version at the
   shapes of the token form's 8x512² forward (stage 1: 32,768 windows, 6
   heads; stage 2: 8,192 windows, 4 heads) and on a 3 x 13 x 13 grid, at
   shift 0 and 4 (Q = 4), float32 and bfloat16 (held as K2 is); then its
   time beside its plain version's, K2's on the same block, and its bound;
11. every attention kernel name of the JAX package (``TMAR_ATTN_IMPL``) at
   the 8x128² step's stage-1 shape: each launches K3 under its own counter,
   all give the same bits and agree with the plain version (at bfloat16 the
   rounding-matched one);
12. serving in the two other block forms, full width, flagship, bfloat16: the
   token form (20 launches of K1 and of K8 per forward) and the unfused form
   (20 of K1, K3 and K5), each against the map form, with its request time;
   K3 and K5 on the inputs the unfused form's 8x512² request gave them (the
   first shifted block of each window and head count, the first block of
   each row count), at bfloat16 and cast to float32, against their plain
   versions (at bfloat16 against the rounding-matched ones), and timed at
   stage 1 in both dtypes (32,768 windows, 2,097,152 rows; K5 also as the
   launch alone);
13. the ``test`` entry point (``tmar_torch.cli.test``) called in-process on
   the flagship, full-slice and ``--tiled`` (all 144 tiles of a 416² slice
   in one forward), in each of the three block forms: ``metrics.json``
   written, the prediction's PSNR above the corrupted input's, the forms
   agreeing within 0.05 dB; and the device-side tiled eval against the
   host-side one on one slice;
14. the data layer: the host library (``tmar_torch/native/tmar_host.cc``,
   built by g++ at first use) loaded, each of its five functions against its
   numpy version on a 416² slice; then small trees in the real layouts,
   written here from the port's synthetic generator as
   tools/make_ref_layout.py writes them (16 SpineWeb HU slice pairs; where
   h5py imports, a SynDeepLesion HDF5 tree of 2 train images x 79 masks and
   1 test image x 10 masks; where it does not, one ``[skip] syndeeplesion``
   line), and each training set's Loader rate onto the card;
15. the shipped configs as written, with only the data paths, the epoch
   length and the run directory set: ``Trainer.fit`` on
   finetune_spineweb.yaml (batch 32, 128², bf16, full width) with
   validation on the full slices and one more epoch under torch.profiler;
   train_syndeeplesion.yaml on ``synthetic_cache`` (16 cached 416² slices)
   and, where h5py imports, on the SynDeepLesion tree with validation on
   ``SynDeepLesionValDataset``, each with 20 launches per step of K1, K7
   and K3-K6; ``tmar_torch.cli.test`` on test_config.yaml with the
   flagship, full-slice and tiled, on each tree: the prediction's PSNR above
   the corrupted input's, 20 launches of K1 and K2 per slice;
16. the composition recipe with ``ngrams=(3, 3, 3, 3)`` (``ngram_fused``
   left on: n = 3 takes the composition path) at full width, 8x128² bf16,
   3 steps: 40 launches each of K3 and K4 at N = 9 per step, none of
   K1/K7, ``g_rec`` falling;
17. the ``v1`` variant (the DCGAN critic, vanilla BCE) through the Trainer
   at full width, 8x128² bf16: 4 steps, a checkpoint and a resume, then 10
   steps with 20 launches per step of each of K1, K7 and K3-K6, their time
   and profile, and one float32 step at 1x128² on the card against the CPU;
18. ``python -m tmar_torch.cli finetune`` for RedCNN, DenoisingTransformer,
   BAFResNet and DuDo at the command's defaults, one epoch each on a
   SpineWeb tree written here: the pickle and history written, no
   hand-written kernel launched, one float32 step of each on the card
   against the CPU;
19. ``train_dcgan`` at its defaults, 16 steps of batch 64: losses finite,
   ms per step;
20. other widths, on the training-form kernels' generic bodies: K1, K3-K7
   against their plain versions (forward and every cotangent, f32 and bf16,
   each backward twice and bit for bit) at the demo NGswin's geometries
   (embed 32, 2 heads: attention (64, 32, 2, 16) with and without the shift
   mask, its n-gram windows of 4, 9 and 1 tokens at 16 channels, the n-gram
   context at C 16, D 32, the FFN at (32, 64), also with a ragged last
   tile), the JAX tests' (64, 32, 3 x 10) and (64, 16, 2 x 8), window 4 and
   the envelope's top (D 128, 4 x 32; FFN (128, 512); n-gram C 64, D 128),
   each timed beside its bound (also windows of 6 and 7 tokens a side; every geometry of 32 to 64 tokens held at both shifts, its
   body named, and K3's and K4's tensor-core generic bodies timed at the flagship's
   geometry beside its own bodies, printed only; the body of K6 and K7 named
   at each FFN and n-gram geometry and dtype, bf16 on their tensor-core
   generic bodies; each source's body and shared-memory queries against
   ``envelope.py``'s rule); then ``Trainer.fit`` on the shipped recipe
   at the demo width (8x64² bf16, 4 ``full`` steps, then 12 on one batch:
   8 launches per step of each of K1, K7 and K3-K6, ``g_rec`` falling, the
   median step and its profile with each training kernel's device time a
   step), one f32 step at 1x64² on the card against
   the CPU, then the demo example's own config in the JAX
   package's default model form through ``Trainer.fit`` at bf16, 3 steps
   on one batch (8 launches each of K1, K7, K3-K6) and one step's device
   time by kernel (K3's and K4's beside their time before their
   tensor-core generic bodies), and the trained generator in the unfused serving form: an
   8x256² bf16 request (8 launches each of K1, K3, K5), f32 at 1x128²
   against the CPU within 1e-4; then K2's and K8's generic bodies against
   their plain versions at the demo width, the JAX tests' (D 8), window 4,
   the envelope's top (D 128, 4 x 32, hidden 512) and a ragged 13 x 13
   grid, shift 0 (Q 1) and shift ws/2 (Q 4), f32 and bf16, K8 bit for bit
   equal to K2, each timed beside its bound, and the refusal past the
   envelope; then the demo generator served in the map form (8 launches of
   K1 and K2 per forward) and the token form (8 of K1 and K8) at 8x256²
   bf16 against the unfused form, and at 1x128² f32 against the CPU;
21. evaluation on the card: ``tmar_torch.cli.compare`` in process on
   4 synthetic 416² slices with the flagship (bf16, and f32 in a second
   call), the identity, a subprocess adapter, the DuDo pickle of phase 18
   and ``--sinograms``, and on the same slices with a demo-width checkpoint;
   ``tmar_torch.cli.ablate --inference-only`` over two ablations at the demo
   width from the checkpoints a short ``Trainer.fit`` writes here: every row
   ``ok``, the flagship's PSNR above the input's, K2's launches counted (20
   per flagship forward, 8 per demo forward); without matplotlib one
   ``[skip] figures`` line;
22. parallelism on the one card: every mode as two gloo ranks on ``cuda:0``
   (NCCL takes one rank per device; the choice is fixed here and printed on
   the ``[parallel]`` lines), spawned together.  For dp, fsdp and tp
   (``model_parallel=2``, the plain form) one float32 ``full`` step of the
   promoted recipe at full width, each rank taking its rows of a 2-row
   batch (tp: both), against one process taking both rows from the same
   seeded state: loss terms, both networks' gradients and the parameters
   after the update; dp and fsdp also take three bf16 steps of 4 rows a
   rank (metrics finite and equal on both ranks, ``g_rec`` falling, 20
   launches per step of each of K1, K7 and K3-K6 on every rank, 0 under tp),
   timed beside one process's 8-row step; a checkpoint written under fsdp
   resumes in one process bit for bit; the flagship's tiled eval on 4
   synthetic 416² slices, the tiles split over the ranks, against one
   process at f32 and bf16 (20 launches of K1 and K2 per forward on every
   rank); two fine-tune steps of RedCNN on the mesh against one process.
   The ``kernels`` line gains ``launches_parallel_path`` ({path: [rank 0,
   rank 1]});
23. the export path: ``python -m tmar_torch.cli export`` on the flagship
   (the map form at 8x512² bf16 and 1x128² f32, the token and unfused forms
   at 1x128² f32), each artifact loaded in a fresh process that builds no
   model and called on the input of the eager forward of its form: f32
   within 1e-4, bf16 within the serving bounds (max 0.1, mean 1e-2), the
   error printed; 20 launches per call of each kernel of the form and none
   of the others, counted there; ``export --torch`` read back by
   ``load_pth`` bit for bit; ``device_profile`` of the eager request (K1
   and K2 60 times over 3 forwards); the artifact's and the eager forward's
   median ms, printed only.  The ``kernels`` line gains
   ``launches_export_path`` ({artifact: launches per call}).

24. the JAX package's default model form trains on the card: the
   default ``TrainConfig`` model (``use_pallas_attention: false``,
   ``attn_backward: auto``, full width) on the promoted recipe's data
   settings, ``Trainer.fit`` for 4 ``full`` steps of 8x128² bf16, 3 more on
   one batch (20 launches per step of each of K1, K7, K3-K6, ``g_rec``
   falling), and one f32 step at 1x128² against the CPU in that form and
   with ``use_pallas_attention: true`` and ``attn_backward`` ``auto`` and
   ``xla`` (K4 0 there).  The ``kernels`` line gains
   ``launches_default_form_step_path``.
25. windows past 8x8 and heads past 32 channels: the long-window bodies of
   K3/K4 and K2/K8 (their rule and shared memory equal to the envelope's)
   against the plain versions at 9x9 and 16x16 windows with heads of 10,
   16, 40 and 64 channels and at 8x8 with 40, mask on and off, f32 and
   bf16, two backward runs bit for bit; their times beside the plain
   versions and bounds (K4 also by device kernel); the window-16 NGswin at
   the flagship's widths (random weights from a seed) serving 8x512² bf16
   in the map and token forms and one 416² slice (20 launches of K1 and of
   K2 / K8 per forward, all on the long-window body, the first launch of
   each stage held to its plain version at NSTB_BF16_TOL), a float32
   1x128² request against the CPU, three ``full`` steps at 8x128² through
   the ``Trainer`` (20 launches of K3 and K4 a step on the long-window
   bodies, metrics finite, every generator parameter moved), and the
   ``head_dim=dec_head_dim=64`` model's 2x256² request and step.  The
   ``kernels`` line gains the long-window bodies' rows.  At bf16 the
   tensor-core long-window bodies run (K3/K4 from 32 tokens up): the
   cases above hold them to the plain versions (K3/K4 under BF16_TOL, K2/K8
   under NSTB_BF16_TOL and NSTB_MEAN_TOL), the CUDA-core ones stay held at
   f32 and at bf16 windows of 16 tokens with heads of 64; every launch of
   the window-16 and head_dim-64 requests and steps counts under
   "tensor-core long-window"; a float32 window-16 step at 1x128² and the
   float32 map- and token-form requests count the CUDA-core bodies'
   launches; each body's device time by kernel, and
   ``scaled_dot_product_attention`` on the same q_n, k_n, v with the bias
   and mask as a float mask (``attention_core_library_ms`` on K3's row, a
   yardstick of the attention core alone that the port never calls; the
   whole-kernel rows keep ``library_ms`` null) beside the attention kernel
   and its bound; and the timed window-16 stage-1 shapes (K4's rows pass
   over groups of 22 windows) held against the plain versions.
26. widths past the envelope, up to D = 512: the sources' body rule and
   shared memory at the new widths equal to the envelope's; K5/K6 at
   (256, 1024), (512, 2048) and (180, 720) on rows sized by width and at
   (64, 65536) on hidden chunks, K3/K4
   at 512 windows of 64 tokens with D 256 (8 x 32) and D 384 (12 x 32) and
   K2 / K8 on x [2, 128², 256] (8 x 32, hidden 1024) and [1, 64², 512]
   (16 x 32, hidden 2048) on the long-window bodies, K1/K7 at C 128 with
   8 x 16 and 2 x 64 heads on cells sized by width, each against its plain
   version at bf16 and f32 (BF16_TOL, NSTB_BF16_TOL for K2/K8, F32_TOL),
   every backward twice and bit for bit, timed beside its plain version
   and bound; the wide NGswin (``WIDE``: D 256, heads 8 / 2 / 8 + 8,
   mlp_ratio 4, the flagship's depths, random weights from a seed) served
   at 2x256² bf16 in the map, token and unfused forms (20 launches of each
   kernel on the body ``WIDE_BODY`` names, finite, in [-1, 1]) and at
   1x128² f32 against the port's CPU run, three ``full`` steps at 4x128²
   bf16 through the ``Trainer`` (20 launches a step of K1, K7, K3-K6),
   one profiled, and one f32 step at 1x64² against the CPU.  The
   ``kernels`` line gains the ``*_wide`` rows.

It prints a ``kernels`` JSON line, the card line, and last
``{"ok": true, "device": {...}}``.  It needs one CUDA card, exits non-zero
without one, and imports nothing of JAX or of the ``tmar`` package.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
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
# The training kernels keep parameters and parameter cotangents in float32 at
# either activation dtype; activations and their cotangents take the
# activation dtype's tolerance.  K1 and K3-K7 at bfloat16 round where the
# JAX kernels round, and so do their plain versions
# (ngram_context_kernel_math and ngram_context_kernel_backward_math;
# window_attention_kernel_math and window_attention_backward_math;
# ffn_kernel_math and ffn_backward_math), their reference; K4's cotangent
# products at N = 64, K6's and K7's take bf16 operands (K6's dw1 and dw2,
# K7's dwqkv, dbqkv, dwproj, dbproj and dwmerge are bf16 values), so their
# parameter cotangents are held to BF16_TOL there, K4's at N = 4 to
# F32_TOL.
# K2/K8 at bf16 round every product's operands where the JAX kernel does, and
# so does their plain version.  Two evaluations of that function that differ
# only in float32 summation order round a few intermediates to neighbouring
# bf16 values, and LN1/LN2 amplify such a flip by 1/std at a low-variance
# token: over the 134 M outputs of a stage-1 launch with the flagship's
# weights the kernel and the plain version differ by up to ~1.2x BF16_TOL in
# a handful of elements (the stage-1 `[kernel] nstb_map` lines also print
# how far the plain version on the CPU lands from the one on the card).  So
# the max is held to twice BF16_TOL, and the mean to NSTB_MEAN_TOL, which
# the float32 plain version misses a hundredfold (the rounding is applied).
NSTB_BF16_TOL = 2.0**-6  # x max|ref|
NSTB_MEAN_TOL = 5e-5
STEP_TOL = 2e-3     # card vs CPU, one f32 train step: x max|ref| per tensor
# kernels and copies of one `full` step while the n-gram backward was four
# launches and its wrapper ran the logit-scale and table cotangents as torch
# ops: the step may launch no more
FULL_STEP_MAX_KERNELS = 3512
TRAIN_BATCH, TRAIN_PATCH = 8, 128


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


def device_ms(fn, name_part, calls=20):
    """(device ms per call, device kernels per call) of the kernels whose
    name holds ``name_part``, by torch.profiler over ``calls`` calls of fn.
    A kernel launched first inside the window opens it (the profiler can
    drop the first kernel it sees).  Where fn's launches cost the host more
    than the device takes to run them, CUDA events time the host; this
    times the device alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if name_part in e.key
            and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    us = sum(getattr(e, "device_time_total", 0.0) for e in rows)
    # the profiler may still miss a kernel at a window's edge: kernels per
    # call to the nearest whole number
    return us / 1e3 / calls, round(sum(e.count for e in rows) / calls)


def ngram_work(B, wh, ww, nh, itemsize, C=32, D=64, hd=None):
    """(FLOPs, bytes) the n-gram context needs: q/k/v once per cell, 4x4
    scores and AV per direction and head, the mean token's projection per
    direction, the merge; u read once, the context written once, weights.
    On a [B, wh, ww, C] grid with a [2C, D] merge and nh heads of hd (the
    full-width NGswin's by default)."""
    A = (hd or C // nh) * nh
    cells = B * wh * ww
    flops = cells * (2 * C * 3 * A + 2 * (2 * 16 * A + 2 * 16 * A + 2 * A * C) + 2 * 2 * C * D)
    weights = 4 * (C * 3 * A + 3 * A + A * C + C + 2 * C * D + D + nh + 9 * nh)
    return flops, cells * (C + D) * itemsize + weights


def nstb_work(B, ph, pw, nh, Q, itemsize, D=64, H=128, hd=None, ws=8):
    """(FLOPs, bytes) the NSTB needs per token: qkv, scores, AV, projection,
    fc1, fc2; x read once, the output written once, the context quads and
    weights read once.  At width D, hidden H, nh heads of hd (the full-width
    NGswin's by default) and windows of ws x ws tokens."""
    N = ws * ws
    A = (hd or D // nh) * nh
    tokens = B * ph * pw
    flops = tokens * 2 * (D * 3 * A + N * A + N * A + A * D + D * H + H * D)
    weights = itemsize * (D * 3 * A + A * D + 2 * D * H) + 4 * (
        3 * A + 6 * D + H + nh + (2 * ws - 1) ** 2 * nh)
    return flops, tokens * 2 * D * itemsize + (tokens // N) * Q * D * itemsize + weights


def bound_ms(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def err_and_tol(got, ref, dtype):
    import torch

    got, ref = got.detach(), ref.detach()
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
    # at bf16 against the rounding-matched plain version, the float32 plain
    # version's distance printed beside it (not gated)
    errs = {"float32": 0.0, "bfloat16": 0.0, "bf16_mean": 0.0, "bf16_vs_f32_plain": 0.0}
    for name, stage, B, g in (("stage1", 1, 8, 64), ("stage2", 2, 8, 32), ("stage3", 3, 8, 16)):
        ctx_mod = getattr(model, f"encoder_layer{stage}").blocks[0].ngram_window_partition.ngram_context
        args = ctx_mod.kernel_args()
        u = randn(B, g, g, 32)
        for dtype in (torch.float32, torch.bfloat16):
            uu = u.to(dtype)
            got = cuda_ngram.fused_ngram_context(uu, *args)
            ref32 = cuda_ngram.ngram_context_math(uu.float(), *args[:-1], num_heads=args[-1])
            ref = ref32 if dtype == torch.float32 else cuda_ngram.ngram_context_kernel_math(
                uu, *args[:-1], num_heads=args[-1]).float()
            torch.cuda.synchronize()
            err, tol = err_and_tol(got, ref, dtype)
            dn = str(dtype).split(".")[1]
            errs[dn] = max(errs[dn], err)
            ok = err <= tol and bool(torch.isfinite(got).all())
            line = f"max_abs_err {err:.3e} tol {tol:.3e}"
            if dtype == torch.bfloat16:
                mean = float((got.float() - ref).abs().mean())
                d32 = float((got.float() - ref32).abs().max())
                errs["bf16_mean"] = max(errs["bf16_mean"], mean)
                errs["bf16_vs_f32_plain"] = max(errs["bf16_vs_f32_plain"], d32)
                line += (f" against the rounding-matched plain version, mean {mean:.2e}; not gated: "
                         f"against the float32 plain version max {d32:.3e}, mean "
                         f"{float((got.float() - ref32).abs().mean()):.2e}")
            print(f"[kernel] ngram_context {name} u={list(uu.shape)} heads={args[-1]} {dn}: "
                  f"{line} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"ngram_context {name} {dn}")
    # time at the stage-1 grid of the 8x512² request and of the 8x128² train
    # step, bf16 (the serving dtype) and f32; the plain version at bf16 is
    # the rounding-matched one
    ctx_mod = model.encoder_layer1.blocks[0].ngram_window_partition.ngram_context
    args = ctx_mod.kernel_args()
    times = {}
    # the step grid's inputs from a generator of their own, so that every
    # later check draws the inputs it always drew
    gen16 = torch.Generator(device=dev).manual_seed(16)
    for grid in (64, 16):
        for dtype in (torch.bfloat16, torch.float32):
            u = (randn(8, grid, grid, 32) if grid == 64 else
                 torch.randn(8, grid, grid, 32, generator=gen16, device=dev)).to(dtype)
            plain = (cuda_ngram.ngram_context_kernel_math if dtype == torch.bfloat16
                     else cuda_ngram.ngram_context_math)
            ops, out, ints = cuda_ngram._kernel_operands(u, *args)
            before = cuda_ngram.fused_ngram_context.launches
            k_ms = cuda_ms(lambda: cuda_ngram._launch(ops, out, ints), iters=50)
            d_ms, _ = device_ms(lambda: cuda_ngram._launch(ops, out, ints), "ngram_context")
            cuda_ngram.fused_ngram_context.launches = before
            p_ms = cuda_ms(lambda: plain(u, *args[:-1], num_heads=args[-1]))
            dn = str(dtype).split(".")[1]
            flops, nbytes = ngram_work(8, grid, grid, 6, u.element_size())
            b_ms, b_by = bound_ms(flops, nbytes, dn)
            times[(grid, dn)] = (k_ms, p_ms, b_ms, b_by, d_ms)
            print(f"[time] ngram_context u=[8, {grid}, {grid}, 32] {dn}: kernel {k_ms:.4f} ms "
                  f"(CUDA events over back-to-back launches; device time alone {d_ms:.4f} ms by "
                  f"torch.profiler), plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
                  f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB); library: none (no single "
                  f"PyTorch call computes it) on {card}")
    k_ms, p_ms, b_ms, b_by, d_ms = times[(64, "bfloat16")]
    records["ngram_context"] = {
        "name": "ngram_context", "route": "cuda", "source": "tmar_torch/csrc/ngram_context.cu",
        "headers": NGRAM_HEADERS,
        "replaces": "tmar/ops/pallas_ngram.py:813", "max_abs_err": errs["float32"],
        "max_abs_err_bf16": errs["bfloat16"], "mean_abs_err_bf16": errs["bf16_mean"],
        "max_abs_err_bf16_vs_f32_plain": errs["bf16_vs_f32_plain"], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_f32": times[(64, "float32")][0], "plain_ms_f32": times[(64, "float32")][1],
        "device_ms": d_ms, "device_ms_f32": times[(64, "float32")][4],
        "ms_step_grid": times[(16, "bfloat16")][0], "plain_ms_step_grid": times[(16, "bfloat16")][1],
        "bound_ms_step_grid": times[(16, "bfloat16")][2],
        "device_ms_step_grid": times[(16, "bfloat16")][4],
        "ms_step_grid_f32": times[(16, "float32")][0],
        "device_ms_step_grid_f32": times[(16, "float32")][4],
        "shape": "u [8, 64, 64, 32] bf16, 6 heads; step grid: u [8, 16, 16, 32]",
    }

    # ---- K2: whole NSTB on the map, stage 1 (6 heads) and stage 2 (4) -----
    errs = {"float32": 0.0, "bfloat16": 0.0, "bf16_mean": 0.0, "bf16_vs_f32_plain": 0.0}
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
            ok, line = hold_nstb(got, lambda xi, ci, a, cdt=torch.float32: cuda_nstb.nstb_map_math(
                xi, ci, *a[:-2], num_heads=a[-2], window_size=a[-1], shift=shift, compute_dtype=cdt),
                xx, cc, args, errs, on_cpu=stage == 1)
            print(f"[kernel] nstb_map {name} x={list(xx.shape)} heads={args[-2]} shift={shift} "
                  f"Q={Q} {line}")
            if not ok:
                failures.append(f"nstb_map {name} shift={shift} {xx.dtype}")
            del got
        del x, cq
        torch.cuda.empty_cache()
    # the saturated logit scale: exp(min(10, ln 100)) = 100 takes the logits
    # to ~100, and the softmax must keep its row max subtraction
    for stage in (1, 2):
        args = list(getattr(model, f"encoder_layer{stage}").blocks[1].kernel_args())
        args[2] = torch.full_like(args[2], 10.0)
        x, cq = randn(2, 64, 64, 64), randn(128, 4, 64, scale=0.5)
        for dtype in (torch.float32, torch.bfloat16):
            xx, cc = x.to(dtype), cq.to(dtype)
            got = cuda_nstb.fused_nstb_map(xx, cc, *args, shift=4)
            ok, line = hold_nstb(got, lambda xi, ci, a: cuda_nstb.nstb_map_math(
                xi, ci, *a[:-2], num_heads=a[-2], window_size=a[-1], shift=4), xx, cc, args, errs)
            print(f"[kernel] nstb_map saturated logit scale x={list(xx.shape)} heads={args[-2]} "
                  f"shift=4 Q=4 {line}")
            if not ok:
                failures.append(f"nstb_map saturated logit scale stage {stage} {dtype}")
    # stage 1's shift-4 block (6 heads, Q = 4: the masked block) and stage
    # 2's (4 heads: the other instantiation)
    times = {}
    for stage, size, nh in ((1, 512, 6), (2, 256, 4)):
        args = getattr(model, f"encoder_layer{stage}").blocks[1].kernel_args()
        nwin = 8 * (size // 8) ** 2
        for dtype in (torch.bfloat16, torch.float32):
            x = randn(8, size, size, 64).to(dtype)
            cq = randn(nwin, 4, 64, scale=0.5).to(dtype)
            ops, out, ints = cuda_nstb._kernel_operands(x, cq, *args, shift=4)
            k_ms = cuda_ms(lambda: cuda_nstb._launch(ops, out, ints, 1e-5), iters=10)
            p_ms = cuda_ms(lambda: cuda_nstb.nstb_map_math(
                x, cq, *args[:-2], num_heads=nh, window_size=args[-1], shift=4), iters=3, warmup=1)
            dn = str(dtype).split(".")[1]
            flops, nbytes = nstb_work(8, size, size, nh, 4, x.element_size())
            b_ms, b_by = bound_ms(flops, nbytes, dn)
            times[(stage, dn)] = (k_ms, p_ms, b_ms, b_by)
            print(f"[time] nstb_map x=[8, {size}, {size}, 64] heads={nh} shift=4 {dn}: kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
                  f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e9:.3f} GB) on {card}")
            del x, cq, ops, out
            torch.cuda.empty_cache()
    k_ms, p_ms, b_ms, b_by = times[(1, "bfloat16")]
    records["nstb_map"] = {
        "name": "nstb_map", "route": "cuda", "source": "tmar_torch/csrc/nstb_map.cu",
        "headers": NSTB_HEADERS,
        "replaces": "tmar/ops/pallas_nstb.py:640", "max_abs_err": errs["float32"],
        "max_abs_err_bf16": errs["bfloat16"], "mean_abs_err_bf16": errs["bf16_mean"],
        "max_abs_err_bf16_vs_f32_plain": errs["bf16_vs_f32_plain"], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_f32": times[(1, "float32")][0], "plain_ms_f32": times[(1, "float32")][1],
        "ms_stage2": times[(2, "bfloat16")][0], "plain_ms_stage2": times[(2, "bfloat16")][1],
        "bound_ms_stage2": times[(2, "bfloat16")][2], "ms_stage2_f32": times[(2, "float32")][0],
        "shape": "x [8, 512, 512, 64] bf16, 6 heads, shift 4; stage 2: x [8, 256, 256, 64], 4 heads",
    }
    if failures:
        raise SystemExit(f"kernel checks failed: {failures}")
    return records


def hold_nstb(got, plain, xx, cc, args, errs, on_cpu=False):
    """K2 or K8 output ``got`` on inputs (xx, cc) against ``plain(x, ctx
    quads, args)`` on the same inputs.  At float32, max |err| <= F32_TOL.  At
    bfloat16 the plain version rounds where the kernel and the JAX kernel
    round: max |err| <= NSTB_BF16_TOL and mean |err| <= NSTB_MEAN_TOL; the
    line also gives the elements above BF16_TOL, the distance to the float32
    plain version on the same bf16 inputs and bf16-rounded matrices (the
    yardstick of the float32 body), not gated, and with ``on_cpu`` the distance
    between the plain version on the CPU and on the card, and both sides'
    distance to the same function evaluated in float64 (``plain(...,
    torch.float64)``, one image at a time).  Updates the largest errors in
    ``errs``; returns (ok, the line's result)."""
    import torch

    ref = plain(xx, cc, args)
    torch.cuda.synchronize()
    dn = str(xx.dtype).split(".")[1]
    if xx.dtype == torch.float32:
        err, tol = err_and_tol(got, ref, xx.dtype)
        errs[dn] = max(errs[dn], err)
        ok = err <= tol and bool(torch.isfinite(got).all())
        return ok, f"{dn}: max_abs_err {err:.3e} tol {tol:.3e}" + (" ok" if ok else " FAIL")
    d = (got.float() - ref.float()).abs()
    err, mean = float(d.max()), float(d.mean())
    scale = float(ref.float().abs().max())
    tol = NSTB_BF16_TOL * scale
    ok = err <= tol and mean <= NSTB_MEAN_TOL and bool(torch.isfinite(got).all())
    errs[dn] = max(errs[dn], err)
    errs["bf16_mean"] = max(errs["bf16_mean"], mean)
    line = (f"{dn}: max_abs_err {err:.3e} tol {tol:.3e}, mean {mean:.2e} tol {NSTB_MEAN_TOL:.0e}; "
            f"{int((d > BF16_TOL * scale).sum())} of {d.numel()} above 2^-7·max|ref|")
    del d
    d32 = (got.float() - plain(xx.float(), cc.float(), _round_nstb_mats(args, xx.dtype))).abs()
    errs["bf16_vs_f32_plain"] = max(errs["bf16_vs_f32_plain"], float(d32.max()))
    line += (f"; not gated: against the float32 plain version max {float(d32.max()):.3e}, mean "
             f"{float(d32.mean()):.2e}")
    del d32
    if on_cpu:
        cpu = lambda a: tuple(map(cpu, a)) if isinstance(a, (tuple, list)) else (  # noqa: E731
            a.cpu() if isinstance(a, torch.Tensor) else a)
        dc = (plain(xx.cpu(), cc.cpu(), cpu(args)).float() - ref.float().cpu()).abs()
        line += (f"; the plain version on the CPU against on the card max {float(dc.max()):.3e}, "
                 f"{int((dc > BF16_TOL * scale).sum())} above 2^-7·max|ref|")
        del dc
        line += "; " + float64_distances(got, ref, plain, xx, cc, args, BF16_TOL * scale)
    return ok, line + (" ok" if ok else " FAIL")


def float64_distances(got, ref, plain, xx, cc, args, tol):
    """The kernel's output ``got`` and its plain version's ``ref`` against
    the same rounding-matched function evaluated in float64 between its bf16
    rounding points (``plain(..., torch.float64)``), one image at a time (a
    whole window grid, so the shift mask's gates hold).  Where kernel and
    plain version differ by more than ``tol``, which of the two lies nearer
    the float64 value.  Not gated: it tells which side an outlier is on."""
    import torch

    B = xx.shape[0]
    per = cc.shape[0] // B
    stats = {"kernel": [0.0, 0.0, 0], "plain": [0.0, 0.0, 0]}
    split, nearer_kernel, nearer_plain = 0, 0, 0
    for b in range(B):
        exact = plain(xx[b:b + 1], cc[b * per:(b + 1) * per], args, torch.float64).double()
        for name, y in (("kernel", got[b:b + 1]), ("plain", ref[b:b + 1])):
            d = (y.double() - exact).abs()
            st = stats[name]
            st[0], st[1], st[2] = max(st[0], float(d.max())), st[1] + float(d.sum()), st[2] + int((d > tol).sum())
        apart = (got[b:b + 1].double() - ref[b:b + 1].double()).abs() > tol
        if bool(apart.any()):
            dk = (got[b:b + 1].double() - exact).abs()[apart]
            dp = (ref[b:b + 1].double() - exact).abs()[apart]
            split += int(apart.sum())
            nearer_kernel += int((dk < dp).sum())
            nearer_plain += int((dp < dk).sum())
        del exact, apart
    n = got.numel()
    out = "against the same function in float64: " + ", ".join(
        f"{k} max {v[0]:.3e} mean {v[1] / n:.2e}, {v[2]} above 2^-7·max|ref|" for k, v in stats.items())
    return out + (f"; of the {split} outputs where kernel and plain version differ by more than "
                  f"2^-7·max|ref|, the kernel is nearer at {nearer_kernel}, the plain version at "
                  f"{nearer_plain}")


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
    return launches, req512, outputs["full-slice 8x512²"], med


# the training kernels' device kernels, by name parts (each body's, where
# they are its own; K6's and K7's tensor-core generic bodies' launches are
# ffn_bwd_gmma* and ngram_bwd_*), for the demo step's [profile] lines
STEP_KERNELS = {"K1": ("ngram_context_",), "K7": ("ngram_bwd",),
                "K3": ("window_attention_fwd",),
                "K4": ("window_attention_bwd", "attention_param_sums", "reduce_backward_partials"),
                "K5": ("residual_ffn_fwd",),
                "K6": ("ffn_bwd", "reduce_partials_rounded", "reduce_partials_bf16")}
# device ms a demo `full` step of the kernels whose generic bodies ran on the
# CUDA cores before they moved to the tensor cores (PERF.md §5, the last
# profile of the CUDA-core bodies, NVIDIA H100 80GB HBM3, 700 W), printed
# beside the step's own
STEP_KERNELS_BEFORE = {"K5": 0.529, "K1": 0.321}


def profile_request(request, card, label="full-slice 8x512² bf16 request", kernels=None,
                    before=None):
    """Where one request's (or step's) time goes: device time by kernel from
    torch.profiler, and the device's idle share of its wall time; with
    ``kernels`` ({name: name parts}) also each named kernel's device time
    (the sum over the device kernels whose name holds one of its parts),
    beside ``before``'s figure where it names the kernel."""
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
        if dev_us <= 0 or getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False) or e.key.startswith(("Optimizer.", "ProfilerStep")):
            continue  # a range over kernels that are listed themselves
        rows.append((dev_us, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        print("[profile] torch.profiler recorded no device time: breakdown not measured")
        return None
    print(f"[profile] {label} under torch.profiler: wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy / 1e3:.1f} ms in {sum(r[1] for r in rows)} kernels and copies, "
          f"idle share {1 - busy / wall_us:.3f} on {card}")
    for dev_us, count, key in sorted(rows, reverse=True)[:15]:
        print(f"[profile]   {dev_us / 1e3:9.3f} ms {100 * dev_us / busy:5.1f}% x{count:<4d} {key[:110]}")
    by_count = sorted(rows, key=lambda r: r[1], reverse=True)[:6]
    print("[profile]   most launched: " + "; ".join(f"x{c} {k[:60]}" for _, c, k in by_count))
    for name, parts in (kernels or {}).items():
        mine = [r for r in rows if any(part in r[2] for part in parts)]
        was = (before or {}).get(name)
        print(f"[profile]   {name}: {sum(r[0] for r in mine) / 1e3:.3f} ms of device time in "
              f"{sum(r[1] for r in mine)} device kernels"
              + ("" if was is None else f" (before its tensor-core generic body: {was} ms)"))
    return busy / 1e3, sum(r[1] for r in rows)


def attention_work(nwin, N, D, nh, hd, itemsize, backward):
    """(FLOPs, bytes) window attention needs.  Forward: qkv, scores, AV,
    projection; x read, the output and the row-wise lse written, parameters
    read.  Backward, recomputing from x: qkv, scores and AV again, then the
    cotangents of the projection (2 products), of AV (2), of the scores (2)
    and of qkv (2); x, g and lse read, dx and the parameter cotangents
    written."""
    A = nh * hd
    rows = nwin * N
    params = 4 * (D * 3 * A + 3 * A + nh + nh * N * N + A * D + D)
    if not backward:
        flops = rows * 2 * (D * 3 * A + 2 * N * A + A * D)
        return flops, rows * 2 * D * itemsize + rows * nh * 4 + params
    flops = rows * 2 * (3 * D * 3 * A + 6 * N * A + 2 * A * D)
    return flops, rows * 3 * D * itemsize + rows * nh * 4 + 2 * params


def ffn_work(M, itemsize, backward, D=64, H=128):
    """(FLOPs, bytes) the residual FFN needs (D = 64, hidden 128 by default).
    Forward: fc1, fc2; x and attn_out read, z written.  Backward,
    recomputing: fc1 and fc2 again, then two products each for their
    cotangents; x, attn_out and dz read, dx and d attn_out written."""
    params = 4 * (2 * D * H + H + 5 * D)
    if not backward:
        return M * 2 * 2 * D * H, M * 3 * D * itemsize + params
    return M * 2 * 6 * D * H, M * 5 * D * itemsize + 2 * params


def ngram_bwd_work(B, wh, ww, nh, itemsize, C=32, D=64, hd=None):
    """(FLOPs, bytes) the n-gram context's backward needs, recomputing from
    u: per cell q/k/v again, per direction and head the 4x4 scores, the AV and
    the mean token's projection again; then the cotangents of the merge and
    the projection (two products each), of the AV and the scores (two each,
    per direction) and of q/k/v (two).  u and g read once, du and the
    parameter cotangents written once, the parameters read once.  Widths as
    ``ngram_work``."""
    A = (hd or C // nh) * nh
    cells = B * wh * ww
    forward = 2 * C * 3 * A + 2 * (2 * 16 * A + 2 * 16 * A + 2 * A * C)
    backward = 2 * 2 * 2 * C * D + 2 * 2 * 2 * A * C + 2 * 4 * 2 * 16 * A + 2 * 2 * C * 3 * A
    params = 4 * (C * 3 * A + 3 * A + A * C + C + 2 * C * D + D + nh + 9 * nh)
    return cells * (forward + backward), cells * (2 * C + D) * itemsize + 2 * params


def ffn_launch_ms(x, ao, params, g, eps=1e-5, iters=20, warmup=3):
    """(K5, K6 or None without g) in ms on operands laid out once, the
    launches alone (the C entry points and their allocations), as K3 and K4
    are timed; the counters are put back."""
    from tmar_torch.ops import cuda_ffn as cf

    f = cf.fused_residual_ffn
    before = (f.launches, f.backward_launches)
    ops, tail = cf._kernel_operands(x, ao, *params, eps)
    fwd = cuda_ms(lambda: cf._launch(ops, tail), iters=iters, warmup=warmup)
    bwd = None if g is None else cuda_ms(lambda: cf._launch_backward(ops, g, tail), iters=iters,
                                         warmup=warmup)
    f.launches, f.backward_launches = before
    return fwd, bwd


NGRAM_HEADERS = ["tmar_torch/csrc/ngram_mma.cuh", "tmar_torch/csrc/mma.cuh"]
FFN_HEADERS = ["tmar_torch/csrc/ffn_mma.cuh", "tmar_torch/csrc/ffn_generic_mma.cuh",
               "tmar_torch/csrc/mma.cuh", "tmar_torch/csrc/common.cuh"]
NSTB_HEADERS = ["tmar_torch/csrc/nstb_window.cuh", "tmar_torch/csrc/nstb_window_mma.cuh",
                "tmar_torch/csrc/nstb_generic.cuh", "tmar_torch/csrc/nstb_generic_mma.cuh",
                "tmar_torch/csrc/ffn_mma.cuh",
                "tmar_torch/csrc/mma.cuh", "tmar_torch/csrc/common.cuh"]


def attention_launch_ms(x, params, g, nh, mc, iters=20):
    """(K3, K4) in ms on operands laid out once, the launches alone (the C
    entry points and their allocations), as K2 and K7 are timed; the counters
    are put back."""
    from tmar_torch.ops import cuda_attention as ca

    f = ca.fused_window_attention
    before = (f.launches, f.backward_launches)
    ops, ints = ca._kernel_operands(x, *params, nh, mc)
    fwd = cuda_ms(lambda: ca._launch(ops, ints), iters=iters)
    _, lse = ca._launch(ops, ints)
    bwd = cuda_ms(lambda: ca._launch_backward(ops, lse, g, ints), iters=iters)
    f.launches, f.backward_launches = before
    return fwd, bwd


# the device kernels of K4's bodies: the per-window (or per-tile) kernel, the
# tensor-core bodies' token sums and every body's reduce of the partial sums
K4_KERNEL_NAMES = ("window_attention_bwd", "attention_param_sums", "reduce_partials",
                   "reduce_backward_partials")


def generic_bodies_at_the_flagship_geometry(dev, card, randn):
    """Printed only, not a dispatch: K3's and K4's tensor-core generic bodies
    (their own C entries ``tmar_window_attention_*_gmma``) at the flagship's
    8x128² train step's stage 1 (2048 windows of 64 tokens, D 64, 6 x 10
    heads, the shift mask on, random weights) beside the flagship's own
    bodies on the same operands, the launch alone, and how far apart their
    outputs land; the counters are put back."""
    import ctypes

    import torch

    from tmar_torch import kernels
    from tmar_torch.ops import cuda_attention as ca
    from tmar_torch.ops.window import shift_mask_components

    nwin, N, D, nh, hd = 2048, 64, 64, 6, 10
    A = nh * hd
    params = [randn(D, 3 * A, scale=0.1), randn(3 * A, scale=0.1),
              torch.full((nh, 1, 1), 1.2, device=dev), randn(nh, N, N, scale=0.2),
              randn(A, D, scale=0.1), randn(D, scale=0.1)]
    x = randn(nwin, N, D).to(torch.bfloat16)
    g = randn(nwin, N, D).to(torch.bfloat16)
    mc = (*shift_mask_components(8, 4), 16, 16)
    f = ca.fused_window_attention
    before = (f.launches, f.backward_launches)
    ops, geo = ca._kernel_operands(x, *params, nh, mc)
    p = [ca._ptr(t) for t in ops]
    fwd = kernels.host_function("window_attention_fwd", "tmar_window_attention_fwd_gmma",
                                ca._FWD_ARGTYPES, ctypes.c_int)
    bwd = kernels.host_function("window_attention_bwd", "tmar_window_attention_bwd_gmma",
                                ca._BWD_ARGTYPES, ctypes.c_int)
    floats = kernels.host_function("window_attention_bwd", "tmar_window_attention_bwd_gmma_workspace",
                                   [ctypes.c_int] * 5, ctypes.c_longlong)(nwin, N, D, nh, hd)
    out_g, lse_g = torch.empty_like(x), torch.empty(nwin, nh, N, device=dev)
    dx_g = torch.empty_like(x)
    work = torch.empty(floats, device=dev)
    dp_g = torch.empty(D * 3 * A + 3 * A + nh + nh * N * N + A * D + D, device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def k3():
        kernels.check("window_attention_fwd", fwd(*p, out_g.data_ptr(), lse_g.data_ptr(), None,
                                                  *geo.ints(False), stream()))

    def k4():
        kernels.check("window_attention_bwd", bwd(
            p[0], g.data_ptr(), *p[1:5], p[5], p[7], p[8], lse_g.data_ptr(), dx_g.data_ptr(),
            work.data_ptr(), dp_g.data_ptr(), *geo.ints(True), stream()))

    flag3 = cuda_ms(lambda: ca._launch(ops, geo), iters=10)
    out, lse = ca._launch(ops, geo)
    flag4 = cuda_ms(lambda: ca._launch_backward(ops, lse, g, geo), iters=10)
    dx, dparams = ca._launch_backward(ops, lse, g, geo)
    gen3, gen4 = cuda_ms(k3, iters=10), cuda_ms(k4, iters=10)
    f.launches, f.backward_launches = before
    d_out = float((out.float() - out_g.float()).abs().max())
    d_dx = float((dx.float() - dx_g.float()).abs().max())
    d_dp = float((dparams - dp_g).abs().max()) / float(dparams.abs().max())
    print(f"[time] window attention at the flagship's geometry, x [{nwin}, 64, 64] bf16, 6 x 10 "
          f"heads, mask on (printed only, not a dispatch): tensor-core generic bodies K3 "
          f"{gen3:.4f} ms, K4 {gen4:.4f} ms; the flagship's own K3 {flag3:.4f} ms, K4 "
          f"{flag4:.4f} ms; max |diff| out {d_out:.3e} (max|out| "
          f"{float(out.float().abs().max()):.3e}), dx {d_dx:.3e} (max|dx| "
          f"{float(dx.float().abs().max()):.3e}), parameter cotangents {d_dp:.3e} of their max "
          f"on {card}")
    del ops, out, out_g, dx, dx_g, work
    torch.cuda.empty_cache()


# the full-width NGswin's n-gram windows (N, heads, head_dim) at D 32, where
# the templated bodies run bf16 (they measured faster there) and the
# short-window bodies are held through their own C entries
NGRAM_WINDOWS = tuple((n * n, nh, hd) for n in (2, 3, 1) for nh, hd in ((6, 5), (4, 8)))


def short_bodies_at_the_ngram_geometries(dev, randn, failures):
    """K3's and K4's short-window bodies through their own C entries
    (``tmar_window_attention_*_smma``; not a dispatch: the templated bodies
    run these geometries) at the full-width NGswin's n-gram windows, 2048
    (n = 2, 1) or 512 (n = 3, a ragged last tile) windows at D 32, both head
    splits, the shift mask on and off, against the rounding-matched plain
    versions: the output and dx at BF16_TOL, the float32 parameter
    cotangents at F32_TOL (``_attn_bwd_kernel`` keeps them float32), two
    runs bit for bit.  A failure is appended to ``failures``."""
    import ctypes

    import torch

    from tmar_torch import kernels
    from tmar_torch.ops import cuda_attention as ca
    from tmar_torch.ops.attention import LOGIT_SCALE_MAX
    from tmar_torch.ops.window import shift_mask_components

    fwd = kernels.host_function("window_attention_fwd", "tmar_window_attention_fwd_smma",
                                ca._FWD_ARGTYPES, ctypes.c_int)
    bwd = kernels.host_function("window_attention_bwd", "tmar_window_attention_bwd_smma",
                                ca._BWD_ARGTYPES, ctypes.c_int)
    wsq = kernels.host_function("window_attention_bwd", "tmar_window_attention_bwd_smma_workspace",
                                [ctypes.c_int] * 5, ctypes.c_longlong)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for N, nh, hd in NGRAM_WINDOWS:
        nwin, D, A, ws = (512 if N == 9 else 2048), 32, nh * hd, int(round(N ** 0.5))
        params = [randn(D, 3 * A, scale=0.1), randn(3 * A, scale=0.1),
                  randn(nh, 1, 1, scale=0.5, shift=1.2), randn(nh, N, N, scale=0.2),
                  randn(A, D, scale=0.1), randn(D, scale=0.1)]
        x = randn(nwin, N, D).to(torch.bfloat16)
        g = randn(nwin, N, D).to(torch.bfloat16)
        for mc in (None, (*shift_mask_components(ws, ws // 2), 16, nwin // 16)):
            label = (f"x=[{nwin}, {N}, {D}] heads={nh}x{hd} mask={'on' if mc else 'off'}")
            ops, geo = ca._kernel_operands(x, *params, nh, mc)
            p = [ca._ptr(t) for t in ops]
            runs = []
            for _ in range(2):
                out, lse = torch.empty_like(x), torch.empty(nwin, nh, N, device=dev)
                dx = torch.empty_like(x)
                work = torch.empty(wsq(nwin, N, D, nh, hd), device=dev)
                dp = torch.empty(D * 3 * A + 3 * A + nh + nh * N * N + A * D + D, device=dev)
                kernels.check("window_attention_fwd", fwd(*p, out.data_ptr(), lse.data_ptr(), None,
                                                          *geo.ints(False), stream()))
                kernels.check("window_attention_bwd", bwd(
                    p[0], g.data_ptr(), *p[1:5], p[5], p[7], p[8], lse.data_ptr(), dx.data_ptr(),
                    work.data_ptr(), dp.data_ptr(), *geo.ints(True), stream()))
                dwqkv, dbqkv, dscale, dbias, dwproj, dbproj = torch.split(
                    dp, [D * 3 * A, 3 * A, nh, nh * N * N, A * D, D])
                ls = params[2].reshape(nh)
                dls = dscale * ops[3] * (ls <= LOGIT_SCALE_MAX)
                runs.append([out, dx, dwqkv.reshape(D, 3 * A), dbqkv, dls.reshape(nh, 1, 1),
                             dbias.reshape(nh, N, N), dwproj.reshape(A, D), dbproj])
            torch.cuda.synchronize()
            ref = [ca.window_attention_kernel_math(x, *params, nh, mask_components=mc),
                   *ca.window_attention_backward_math(x, g, *params, nh, mask_components=mc)]
            bad, worst = [], ("", 0.0)
            for i, (name, a, b, c) in enumerate(zip(ATTN_NAMES, runs[0], ref, runs[1])):
                err, tol = err_and_tol(a, b, torch.bfloat16 if i <= 1 else torch.float32)
                if err / max(tol, 1e-30) >= worst[1]:
                    worst = (name, err / max(tol, 1e-30))
                if not (err <= tol and bool(torch.isfinite(a).all())):
                    bad.append(f"{name} err {err:.3e} > tol {tol:.3e}")
                if not torch.equal(a, c):
                    bad.append(f"{name} differs between two runs")
            print(f"[kernel] window_attention short-window body (its own C entries, not a "
                  f"dispatch) {label} bfloat16: out and 7 cotangents, worst {worst[0]} at "
                  f"{worst[1]:.3f} of its tolerance; two runs bit-identical: "
                  f"{not any('differs' in b for b in bad)} {'ok' if not bad else 'FAIL ' + '; '.join(bad)}")
            if bad:
                failures.append(f"window_attention short-window body {label}")
            del ops, runs, ref
    torch.cuda.empty_cache()


ATTN_NAMES = ["out", "dx", "dwqkv", "dbqkv", "dlogit_scale", "dbias", "dwproj", "dbproj"]
NGRAM_NAMES = ["out", "du", "dwqkv", "dbqkv", "dlogit_scale", "dtable", "dwproj", "dbproj",
               "dwmerge", "dbmerge"]
# (label, B, wh, ww, heads): the 8x128² step's three stages, the 8x512² serving
# size's stage 1, an odd grid, and the smallest (both reflections hit 0 and 1)
NGRAM_BWD_CASES = (
    ("stage1", 8, 16, 16, 6), ("stage2", 8, 8, 8, 4), ("stage3", 8, 4, 4, 4),
    ("512² stage1", 8, 64, 64, 6), ("odd", 3, 13, 7, 4), ("2x2", 2, 2, 2, 6),
)
FFN_NAMES = ["out", "dx", "dattn_out", "dg1", "db1", "dw1", "dbw1", "dw2", "dbw2", "dg2", "db2"]
# (label, windows, N, D, heads, head_dim, window grid of the shift mask)
ATTN_CASES = (
    ("stage1", 2048, 64, 64, 6, 10, None),
    ("stage1 shift", 2048, 64, 64, 6, 10, (16, 16)),
    ("stage2 shift", 512, 64, 64, 4, 16, (8, 8)),
    ("ngram stage1", 2048, 4, 32, 6, 5, None),
    ("ngram stage2", 512, 4, 32, 4, 8, None),
    # the composition path's windows at n = 3 (9 tokens: seven to a 64-row
    # tile, the last tile ragged) and n = 1, at the step's stages 1-3
    ("ngram n=3 stage1", 2048, 9, 32, 6, 5, None),
    ("ngram n=3 stage2", 512, 9, 32, 4, 8, None),
    ("ngram n=3 stage3", 128, 9, 32, 4, 8, None),
    ("ngram n=1 stage1", 2048, 1, 32, 6, 5, None),
    ("ngram n=1 stage2", 512, 1, 32, 4, 8, None),
    # the same n-gram windows with the shift mask on (bf16: the short-window
    # bodies, f32: the templated ones)
    ("ngram stage1 shift", 2048, 4, 32, 6, 5, (16, 16)),
    ("ngram stage2 shift", 512, 4, 32, 4, 8, (8, 8)),
    ("ngram n=3 stage1 shift", 2048, 9, 32, 6, 5, (16, 16)),
    ("ngram n=3 stage2 shift", 512, 9, 32, 4, 8, (8, 8)),
    ("ngram n=1 stage1 shift", 2048, 1, 32, 6, 5, (16, 16)),
    ("ngram n=1 stage2 shift", 512, 1, 32, 4, 8, (8, 8)),
)
FFN_ROWS = 131072


def _run(fn, acts, params, g):
    import torch

    leaves = [a.clone().requires_grad_() for a in acts] + [p.clone().requires_grad_() for p in params]
    out = fn(*leaves)
    return [out.detach()] + list(torch.autograd.grad(out, leaves, g.to(out.dtype)))


def _hold(kernel, label, names, n_acts, fused, plain, acts, params, g, errs, plain_bf16=None,
          param_bf16=False, failures=None):
    """forward (index 0) feeds the forward kernel's record, the
    cotangents the backward kernel's; errs[kernel half][dtype].  At
    bfloat16 the reference is plain_bf16(acts, params, g), the
    rounding-matched plain versions' outputs and cotangents, where the
    kernels round as the JAX kernels do (the parameter cotangents then
    at the bf16 tolerance with param_bf16), else autograd of the plain
    version in float32 on the same bf16 inputs.  A failure is appended to
    ``failures``."""
    import torch

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        a = [t.to(dtype) for t in acts]
        got = _run(fused, a, params, g.to(dtype))
        again = _run(fused, a, params, g.to(dtype))
        ref32 = _run(plain, [t.float() for t in a], params, g.to(dtype).float())
        matched = dtype == torch.bfloat16 and plain_bf16 is not None
        ref = plain_bf16(a, params, g.to(dtype)) if matched else ref32
        torch.cuda.synchronize()
        worst, bad = ("", 0.0, 0.0), []
        for i, (name, x, y, z) in enumerate(zip(names, got, ref, again)):
            pdt = torch.bfloat16 if (matched and param_bf16) else torch.float32
            err, tol = err_and_tol(x, y, dtype if i <= n_acts else pdt)
            half = "fwd" if i == 0 else "bwd"
            errs[half][dn] = max(errs[half][dn], err)
            if err / tol >= worst[1]:
                worst = (name, err / tol, err)
            if not (err <= tol and bool(torch.isfinite(x).all())):
                bad.append(f"{name} err {err:.3e} > tol {tol:.3e}")
            if not torch.equal(x, z):
                bad.append(f"{name} differs between two runs")
        line = (f"[kernel] {kernel} {label} {dn}: forward max_abs_err "
                f"{float((got[0].float() - ref[0].float()).abs().max()):.3e}")
        if matched:
            means = [float((got[i].float() - ref[i].float()).abs().mean()) for i in (0, 1)]
            d32 = [float((got[i].float() - ref32[i].float()).abs().mean()) for i in (0, 1)]
            # a cotangent that is zero on both sides has no relative
            # distance (at N = 1 the scores' cotangents vanish: a softmax
            # over one key is constant)
            w32 = max((e / t for e, t in (err_and_tol(x, y, dtype) for x, y in zip(got, ref32))
                       if t > 0), default=0.0)
            line += (f" (against the rounding-matched plain versions; mean out {means[0]:.2e}, "
                     f"dx {means[1]:.2e}; not gated: against the float32 plain version mean "
                     f"out {d32[0]:.2e}, dx {d32[1]:.2e}, worst {w32:.2f} of the bf16 tolerance)")
            errs.setdefault("bf16_mean", {"fwd": 0.0, "bwd": 0.0})
            errs["bf16_mean"]["fwd"] = max(errs["bf16_mean"]["fwd"], means[0])
            errs["bf16_mean"]["bwd"] = max(errs["bf16_mean"]["bwd"], means[1])
        print(line + f"; {len(names) - 1} cotangents, worst {worst[0]} at {worst[1]:.3f} of its "
              f"tolerance (max_abs_err {worst[2]:.3e}); two backward runs bit-identical: "
              f"{not any('differs' in b for b in bad)} {'ok' if not bad else 'FAIL ' + '; '.join(bad)}")
        if bad:
            failures.append(f"{kernel} {label} {dn}")
        del got, again, ref, ref32
    torch.cuda.empty_cache()


def _time_pair(fused, plain, acts, params, g, dtype):
    """(kernel fwd, kernel bwd, plain fwd, plain bwd) in ms.  The plain
    version runs in the activation dtype, as it would in the model."""
    import torch

    a = [t.to(dtype) for t in acts]
    gg = g.to(dtype)
    out = []
    for fn in (fused, plain):
        leaves = [t.clone().requires_grad_() for t in a] + [p.clone().requires_grad_() for p in params]
        with torch.no_grad():
            fwd = cuda_ms(lambda: fn(*leaves))
        y = fn(*leaves)
        bwd = cuda_ms(lambda: torch.autograd.grad(y, leaves, gg, retain_graph=True))
        out += [fwd, bwd]
        del y, leaves
    torch.cuda.empty_cache()
    return out[0], out[1], out[2], out[3]


def attention_body_line(label, N, D, nh, hd, failures):
    """Print the body K3's and K4's built sources run at this geometry at
    each dtype (their ``tmar_*_body`` queries); a source that disagrees
    with ``envelope.attention_body`` or with the other is a failure."""
    import torch

    from tmar_torch.ops import envelope as env

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        got = (env.built_attention_body("window_attention_fwd", N, D, nh, hd, dtype),
               env.built_attention_body("window_attention_bwd", N, D, nh, hd, dtype))
        want = env.attention_body(N, D, nh, hd, dtype)
        ok = got == (want, want)
        print(f"[body] window attention {label} {dn}: K3 {got[0]}, K4 {got[1]} (the sources' "
              f"body queries; envelope.attention_body: {want}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"attention body {label} {dn}")


def check_train_kernels(dev, card):
    """Phase 5: the four training kernels against their plain versions'
    autograd, forward and every cotangent, then timed.  Returns the kernel
    records for the JSON line (without launches)."""
    import torch

    from tmar_torch.ops.attention import window_attention_math
    from tmar_torch.ops.cuda_attention import (
        _PlainAttention,
        fused_window_attention,
        window_attention_backward_math,
        window_attention_kernel_math,
    )
    from tmar_torch.ops import cuda_ngram
    from tmar_torch.ops.cuda_ngram import (
        _PlainNGram,
        fused_ngram_context,
        ngram_context_kernel_backward_math,
        ngram_context_kernel_math,
        ngram_context_math,
    )
    from tmar_torch.ops.cuda_ffn import (
        _PlainFFN,
        ffn_backward_math,
        ffn_kernel_math,
        fused_residual_ffn,
    )
    from tmar_torch.ops.ffn import ffn_math
    from tmar_torch.ops.window import shift_mask_components

    gen = torch.Generator(device=dev).manual_seed(1)
    failures = []

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    def attention_inputs(nwin, N, D, nh, hd):
        A = nh * hd
        ls = torch.rand(nh, 1, 1, generator=gen, device=dev) * 1.8 + 0.5
        return [randn(nwin, N, D)], [
            randn(D, 3 * A, scale=0.1), randn(3 * A, scale=0.1), ls, randn(nh, N, N, scale=0.2),
            randn(A, D, scale=0.1), randn(D, scale=0.1)], randn(nwin, N, D)

    def ffn_inputs(M):
        D, H = 64, 128
        return [randn(M, D), randn(M, D)], [
            randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1), randn(D, H, scale=0.1),
            randn(H, scale=0.1), randn(H, D, scale=0.1), randn(D, scale=0.1),
            randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1)], randn(M, D)

    hold = functools.partial(_hold, failures=failures)
    time_pair = _time_pair

    # ---- K3 / K4: window attention ------------------------------------------
    errs = {h: {"float32": 0.0, "bfloat16": 0.0} for h in ("fwd", "bwd")}
    for label, nwin, N, D, nh, hd, grid in ATTN_CASES:
        acts, params, g = attention_inputs(nwin, N, D, nh, hd)
        ws = int(round(N ** 0.5))  # the window's side
        mc = None if grid is None else (*shift_mask_components(ws, ws // 2), *grid)
        attention_body_line(f"{label} x=[{nwin}, {N}, {D}] heads={nh}x{hd}", N, D, nh, hd,
                            failures)
        hold("window_attention", f"{label} x=[{nwin}, {N}, {D}] heads={nh}x{hd} "
             f"mask={'on' if grid else 'off'}", ATTN_NAMES, 1,
             lambda *a: fused_window_attention(*a, nh, mask_components=mc),
             lambda *a: window_attention_math(
                 a[0], a[1].to(a[0].dtype), a[2].to(a[0].dtype), a[3], a[4], a[5].to(a[0].dtype),
                 a[6].to(a[0].dtype), nh, mask_components=mc),
             acts, params, g, errs,
             plain_bf16=lambda a, p, gg: [
                 window_attention_kernel_math(a[0], *p, nh, mask_components=mc),
                 *window_attention_backward_math(a[0], gg, *p, nh, mask_components=mc)],
             param_bf16=N == 64)
    short_bodies_at_the_ngram_geometries(dev, randn, failures)
    times = {}
    for label, nwin, N, D, nh, hd, grid in (ATTN_CASES[1], ATTN_CASES[3], ATTN_CASES[5],
                                             ATTN_CASES[8]):
        acts, params, g = attention_inputs(nwin, N, D, nh, hd)
        ws = int(round(N ** 0.5))
        mc = None if grid is None else (*shift_mask_components(ws, ws // 2), *grid)
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            # the plain versions: at bf16 the rounding-matched pair (K3's and
            # K4's as one autograd function), at f32 autograd of the math
            t = time_pair(
                lambda *a: fused_window_attention(*a, nh, mask_components=mc),
                (lambda *a: _PlainAttention.apply(*a, nh, mc)) if dtype == torch.bfloat16 else
                (lambda *a: window_attention_math(*a, nh, mask_components=mc)),
                acts, params, g, dtype)
            launch = attention_launch_ms(acts[0].to(dtype), params, g.to(dtype), nh, mc)
            bounds = [bound_ms(*attention_work(nwin, N, D, nh, hd, acts[0].to(dtype).element_size(), b), dn)
                      for b in (False, True)]
            times[(N, dn)] = (t, bounds, launch)
            for i, (half, p_ms, (b_ms, b_by)) in enumerate((("fwd", t[2], bounds[0]), ("bwd", t[3], bounds[1]))):
                print(f"[time] window_attention_{half} {label} x=[{nwin}, {N}, {D}] heads={nh} {dn}: "
                      f"kernel {launch[i]:.4f} ms (launch alone; {t[i]:.4f} ms through the wrapper"
                      f"{' under autograd' if half == 'bwd' else ''}), plain {p_ms:.4f} ms, bound "
                      f"{b_ms:.5f} ms ({b_by}); library: none (no single PyTorch call computes it) "
                      f"on {card}")
    records = {}
    for i, half in enumerate(("fwd", "bwd")):
        t, bounds, launch = times[(64, "bfloat16")]
        t32, b32, launch32 = times[(64, "float32")]
        t4, b4, launch4 = times[(4, "bfloat16")]
        t9, b9, launch9 = times[(9, "bfloat16")]
        t1, b1, launch1 = times[(1, "bfloat16")]
        records[f"window_attention_{half}"] = {
            "name": f"window_attention_{half}", "route": "cuda",
            "source": f"tmar_torch/csrc/window_attention_{half}.cu",
            "replaces": ("tmar/ops/pallas_attention.py:1143, :1175, :1241 and :813" if half == "fwd"
                         else "tmar/ops/pallas_attention.py:568 and :704"),
            "max_abs_err": errs[half]["float32"], "max_abs_err_bf16": errs[half]["bfloat16"],
            "mean_abs_err_bf16": errs["bf16_mean"][half],
            "ms": launch[i], "plain_ms": t[2 + i], "bound_ms": bounds[i][0], "bound_by": bounds[i][1],
            "library_ms": None, "ms_through_wrapper": t[i], "ms_f32": launch32[i],
            "plain_ms_f32": t32[2 + i], "bound_ms_f32": b32[i][0],
            "ms_n4": launch4[i], "plain_ms_n4": t4[2 + i], "bound_ms_n4": b4[i][0],
            "ms_n9": launch9[i], "plain_ms_n9": t9[2 + i], "bound_ms_n9": b9[i][0],
            "ms_n1": launch1[i], "plain_ms_n1": t1[2 + i], "bound_ms_n1": b1[i][0],
            "shape": "x [2048, 64, 64] bf16, 6 heads, shift mask on (n4 / n9 / n1: x [2048, 4 / 9 / "
                     "1, 32], 6 heads)",
        }

    # ---- K5 / K6: residual FFN ---------------------------------------------
    errs = {h: {"float32": 0.0, "bfloat16": 0.0} for h in ("fwd", "bwd")}

    def ffn_plain_bf16(a, p, gg):
        return [ffn_kernel_math(a[0], a[1], *p), *ffn_backward_math(a[0], a[1], *p, gg)]

    acts, params, g = ffn_inputs(FFN_ROWS)
    racts, rparams, rg = ffn_inputs(1000)
    for label, case in ((f"x=[{FFN_ROWS}, 64]", (acts, params, g)),
                        ("x=[1000, 64] (ragged last tile)", (racts, rparams, rg))):
        hold("residual_ffn", label, FFN_NAMES, 2, fused_residual_ffn, ffn_math, *case, errs,
             plain_bf16=ffn_plain_bf16, param_bf16=True)
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        # the plain versions: at bf16 the rounding-matched pair (K5's and
        # K6's as one autograd function), at f32 autograd of the math
        t = time_pair(fused_residual_ffn,
                      (lambda *a: _PlainFFN.apply(*a, 1e-5)) if dtype == torch.bfloat16 else ffn_math,
                      acts, params, g, dtype)
        launch = ffn_launch_ms(acts[0].to(dtype), acts[1].to(dtype), params, g.to(dtype))
        bounds = [bound_ms(*ffn_work(FFN_ROWS, acts[0].to(dtype).element_size(), b), dn)
                  for b in (False, True)]
        times[dn] = (t, bounds, launch)
        for i, (half, p_ms, (b_ms, b_by)) in enumerate((("fwd", t[2], bounds[0]), ("bwd", t[3], bounds[1]))):
            print(f"[time] residual_ffn_{half} x=[{FFN_ROWS}, 64] {dn}: kernel {launch[i]:.4f} ms "
                  f"(launch alone; {t[i]:.4f} ms through the wrapper"
                  f"{' under autograd' if half == 'bwd' else ''}), plain {p_ms:.4f} ms, bound "
                  f"{b_ms:.5f} ms ({b_by}); library: none (no single PyTorch call computes it) "
                  f"on {card}")
    for i, half in enumerate(("fwd", "bwd")):
        t, bounds, launch = times["bfloat16"]
        t32, b32, launch32 = times["float32"]
        records[f"residual_ffn_{half}"] = {
            "name": f"residual_ffn_{half}", "route": "cuda",
            "source": f"tmar_torch/csrc/residual_ffn_{half}.cu", "headers": FFN_HEADERS,
            "replaces": "tmar/ops/pallas_ffn.py:352" if half == "fwd" else "tmar/ops/pallas_ffn.py:249",
            "max_abs_err": errs[half]["float32"], "max_abs_err_bf16": errs[half]["bfloat16"],
            "mean_abs_err_bf16": errs["bf16_mean"][half],
            "ms": launch[i], "plain_ms": t[2 + i], "bound_ms": bounds[i][0],
            "bound_by": bounds[i][1], "library_ms": None, "ms_through_wrapper": t[i],
            "ms_f32": launch32[i], "ms_through_wrapper_f32": t32[i], "plain_ms_f32": t32[2 + i],
            "bound_ms_f32": b32[i][0],
            "shape": f"x [{FFN_ROWS}, 64] bf16",
        }

    # ---- K7: the n-gram context's backward (K1 is its forward) --------------
    def ngram_inputs(B, wh, ww, nh):
        C, D = 32, 64
        A = (C // nh) * nh
        ls = torch.rand(nh, 1, 1, generator=gen, device=dev) * 1.8 + 0.5
        return [randn(B, wh, ww, C)], [
            randn(C, 3 * A, scale=0.2), randn(3 * A, scale=0.1), ls, randn(9, nh, scale=0.5),
            randn(A, C, scale=0.2), randn(C, scale=0.1), randn(2 * C, D, scale=0.2),
            randn(D, scale=0.1)], randn(B, wh, ww, D)

    def ngram_fns(nh):
        return (lambda *a: fused_ngram_context(*a, nh),
                lambda *a: ngram_context_math(*a, num_heads=nh))

    def ngram_plain_bf16(nh):
        return lambda a, p, gg: [ngram_context_kernel_math(a[0], *p, num_heads=nh),
                                 *ngram_context_kernel_backward_math(a[0], gg, *p, num_heads=nh)]

    errs = {h: {"float32": 0.0, "bfloat16": 0.0} for h in ("fwd", "bwd")}
    for label, B, wh, ww, nh in NGRAM_BWD_CASES:
        acts, params, g = ngram_inputs(B, wh, ww, nh)
        hold("ngram_context_bwd", f"{label} u=[{B}, {wh}, {ww}, 32] heads={nh}", NGRAM_NAMES, 1,
             *ngram_fns(nh), acts, params, g, errs, plain_bf16=ngram_plain_bf16(nh),
             param_bf16=True)
    label, B, wh, ww, nh = NGRAM_BWD_CASES[0]
    acts, params, g = ngram_inputs(B, wh, ww, nh)
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        # the plain versions: at bf16 the rounding-matched pair (K1's and
        # K7's as one autograd function), at f32 autograd of the math
        t = time_pair(ngram_fns(nh)[0],
                      (lambda *a: _PlainNGram.apply(*a, nh)) if dtype == torch.bfloat16
                      else ngram_fns(nh)[1], acts, params, g, dtype)
        # the launch alone, as K1 is timed: operands laid out once, then the
        # C entry point (its two passes and its reduce) and its allocations
        uu, gg = acts[0].to(dtype), g.to(dtype)
        ops, _, ints = cuda_ngram._kernel_operands(uu, *params, nh)
        launches_before = fused_ngram_context.backward_launches
        k_ms = cuda_ms(lambda: cuda_ngram._launch_backward(ops[:-1], gg, ints), iters=50)
        # the device kernels of a call and their device time, by torch.profiler
        d_ms, per_call = device_ms(lambda: cuda_ngram._launch_backward(ops[:-1], gg, ints),
                                   "ngram_bwd")
        fused_ngram_context.backward_launches = launches_before
        print(f"[check] ngram_context_bwd {dn}: {per_call:g} device kernels per call (at most 3: "
              f"cells pass, positions pass, reduce): {'ok' if 0 < per_call <= 3 else 'FAIL'}")
        if not 0 < per_call <= 3:
            failures.append(f"ngram_context_bwd {dn}: {per_call} kernels per call")
        flops, nbytes = ngram_bwd_work(B, wh, ww, nh, uu.element_size())
        b_ms, b_by = bound_ms(flops, nbytes, dn)
        times[dn] = (k_ms, t, b_ms, b_by, per_call, d_ms)
        print(f"[time] ngram_context_bwd {label} u=[{B}, {wh}, {ww}, 32] heads={nh} {dn}: kernel "
              f"{k_ms:.4f} ms (launch alone; device time alone {d_ms:.4f} ms by torch.profiler; "
              f"{t[1]:.4f} ms through the wrapper under autograd), "
              f"plain {t[3]:.4f} ms, bound {b_ms:.5f} ms ({b_by}: {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB); its forward through the wrapper: kernel {t[0]:.4f} ms, "
              f"plain {t[2]:.4f} ms; library: none (no single PyTorch call computes it) on {card}")
    k_ms, t, b_ms, b_by, per_call, d_ms = times["bfloat16"]
    records["ngram_context_bwd"] = {
        "name": "ngram_context_bwd", "route": "cuda",
        "source": "tmar_torch/csrc/ngram_context_bwd.cu",
        "headers": NGRAM_HEADERS + ["tmar_torch/csrc/common.cuh"],
        "replaces": "tmar/ops/pallas_ngram.py:520",
        "max_abs_err": errs["bwd"]["float32"], "max_abs_err_bf16": errs["bwd"]["bfloat16"],
        "mean_abs_err_bf16": errs["bf16_mean"]["bwd"],
        "ms": k_ms, "plain_ms": t[3], "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_f32": times["float32"][0], "plain_ms_f32": times["float32"][1][3],
        "ms_through_autograd": t[1], "ms_through_autograd_f32": times["float32"][1][1],
        "forward_ms_through_wrapper": t[0], "forward_plain_ms": t[2],
        "device_kernels_per_call": per_call, "device_ms": d_ms,
        "device_ms_f32": times["float32"][5],
        "shape": f"u [{B}, {wh}, {ww}, 32] bf16, {nh} heads",
    }
    if failures:
        raise SystemExit(f"training kernel checks failed: {failures}")
    return records


# ---- phase 20: other widths (the demo NGswin's, the JAX tests', the
# envelope's top) --------------------------------------------------------------
# (label, windows, N, D, heads, head_dim, window side, mask grid)
WIDTH_ATTN_CASES = (
    ("demo", 512, 64, 32, 2, 16, 8, None),
    ("demo shift", 512, 64, 32, 2, 16, 8, (8, 8)),
    ("demo ngram n=2", 512, 4, 16, 2, 8, 2, None),
    ("demo ngram n=3", 512, 9, 16, 2, 8, 3, None),
    ("demo ngram n=1", 512, 1, 16, 2, 8, 1, None),
    ("jax 3x10 shift", 512, 64, 32, 3, 10, 8, (8, 8)),
    ("jax D16", 512, 64, 16, 2, 8, 8, None),
    ("window 4 shift", 2048, 16, 32, 2, 16, 4, (16, 16)),
    ("envelope top shift", 512, 64, 128, 4, 32, 8, (8, 8)),
    ("window 6 shift", 512, 36, 32, 2, 16, 6, (8, 8)),
    ("window 7 shift", 512, 49, 32, 2, 16, 7, (8, 8)),
    # a ragged window count on the short-window bodies at bf16 (the last
    # unit and tile part-filled), its mask on a 17 x 59 grid of windows
    ("demo ngram ragged shift", 1003, 4, 16, 2, 8, 2, (17, 59)),
)
# (label, rows, D, hidden)
WIDTH_FFN_CASES = (("demo", 32768, 32, 64), ("demo ragged", 1000, 32, 64),
                   ("envelope top", 8192, 128, 512))
# (label, B, wh, ww, C, D, heads, head_dim)
WIDTH_NGRAM_CASES = (("demo stage1", 8, 8, 8, 16, 32, 2, 8), ("demo odd", 3, 13, 7, 16, 32, 2, 8),
                     ("envelope top", 8, 32, 32, 64, 128, 4, 16))
# the whole block, K2 / K8: (label, B, wh, ww, D, heads, head_dim, hidden,
# window side): the demo 8x256² request's stage 1, the JAX kernel tests'
# width, window 4, the envelope's top, a ragged 13 x 13 grid (a 416² slice's
# stage-3 windows-per-stripe) at the demo width
WIDTH_NSTB_CASES = (
    ("demo stage1", 8, 32, 32, 32, 2, 16, 64, 8),
    ("jax tests D8", 8, 16, 16, 8, 2, 4, 16, 8),
    ("window 4", 8, 32, 32, 32, 2, 16, 64, 4),
    ("envelope top", 2, 16, 16, 128, 4, 32, 512, 8),
    ("demo ragged 13x13", 3, 13, 13, 32, 2, 16, 64, 8),
)
# past the envelope: (D, heads, head_dim, hidden, window) whose long-window
# attention block, a 64x64 window's scores, overflows the card's shared
# memory (D 152 at hidden 4·D, refused until the long-window bodies took
# what the generic tile does not fit, now runs)
NSTB_PAST_ENVELOPE = (64, 2, 32, 128, 64)


def smem_count_failures():
    """The shared memory each CUDA source launches its generic body with
    (its ``tmar_*_smem`` query) against ``envelope``'s count, at every
    geometry of phase 20 and the full-width NGswin's (its float32 runs the
    generic bodies; K2/K8, K3/K4, K6 and K7: both generic bodies), and the
    body K2's, K8's, K3's, K4's, K6's and K7's sources pick (``tmar_*_body``)
    against ``envelope.nstb_body``, ``attention_body``, ``ffn_body`` and
    ``ngram_body`` at both dtypes: -> the geometries where they differ."""
    import torch

    from tmar_torch.ops import envelope as env

    built, bad = env.built_smem, []
    for N, D, nh, hd in {(c[2], c[3], c[4], c[5]) for c in WIDTH_ATTN_CASES} | {
            (64, 64, 6, 10), (64, 64, 4, 16), *((n * n, 32, nh, hd) for n in (1, 2, 3)
                                                 for nh, hd in ((6, 5), (4, 8)))}:
        hg_f, fwd, hg_b, bwd = env.attention_envelope(N, D, nh, hd)
        if (built("attention_fwd", D, nh, hd, hg_f), built("attention_bwd", N, D, hd, hg_b)) \
                != (fwd, bwd):
            bad.append(("attention", N, D, nh, hd))
        mma = env.attention_mma_bytes(N, D, nh, hd) or (-1, -1, -1)
        if (built("attention_fwd_mma", N, D, nh, hd), built("attention_bwd_mma", N, D, nh, hd, 1),
                built("attention_bwd_mma", N, D, nh, hd, 2)) != tuple(mma):
            bad.append(("attention tensor-core generic", N, D, nh, hd))
        short = env.attention_short_plan(N, D, nh, hd)
        if (built("attention_fwd_short", N, D, nh, hd), built("attention_bwd_short", N, D, nh, hd)) \
                != ((-1, -1) if short is None else (short["fwd"][1], short["bwd"][1])):
            bad.append(("attention short-window", N, D, nh, hd))
        for dtype in (torch.float32, torch.bfloat16):
            want = env.attention_body(N, D, nh, hd, dtype)
            if (env.built_attention_body("window_attention_fwd", N, D, nh, hd, dtype),
                    env.built_attention_body("window_attention_bwd", N, D, nh, hd, dtype)) \
                    != (want, want):
                bad.append(("attention body", str(dtype), N, D, nh, hd))
    for _, _, D, H in WIDTH_FFN_CASES + (("flagship", 0, 64, 128),):
        fwd, rows, bwd = env.ffn_envelope(D, H)
        rows5, hc5, _, hc6 = env.ffn_tiles(D, H)
        if (built("ffn_fwd", D, hc5, rows5), built("ffn_bwd", D, hc6, rows)) != (fwd, bwd):
            bad.append(("ffn", D, H))
        mma = env.ffn_mma_plan(D, H)
        if built("ffn_bwd_mma", D, H) != (-1 if mma is None else mma[-1]):
            bad.append(("ffn tensor-core generic", D, H))
        fwd_mma = env.ffn_mma_fwd_plan(D, H)
        if built("ffn_fwd_mma", D, H) != (-1 if fwd_mma is None else fwd_mma[-1]):
            bad.append(("ffn forward tensor-core generic", D, H))
        for dtype in (torch.float32, torch.bfloat16):
            want = env.ffn_body(D, H, dtype)
            if (env.built_ffn_body(D, H, dtype),
                    env.built_ffn_body(D, H, dtype, lib="residual_ffn_fwd")) != (want, want):
                bad.append(("ffn body", str(dtype), D, H))
    for C, D, nh, hd in {c[4:] for c in WIDTH_NGRAM_CASES} | {(32, 64, 6, 5), (32, 64, 4, 8)}:
        want = env.ngram_envelope(C, D, nh, hd)
        if (built("ngram_fwd", C, nh, hd), built("ngram_bwd", C, D, nh, hd, 1),
                built("ngram_bwd", C, D, nh, hd, 2)) != want:
            bad.append(("ngram", C, D, nh, hd))
        mma = env.ngram_mma_plan(C, D, nh, hd) or (-1, -1)
        if (built("ngram_bwd_mma", C, D, nh, hd, 1),
                built("ngram_bwd_mma", C, D, nh, hd, 2)) != tuple(mma):
            bad.append(("ngram tensor-core generic", C, D, nh, hd))
        for S, TJ in env.NGRAM_FWD_TILES:
            want = -1 if mma == (-1, -1) else env.ngram_mma_fwd_bytes(C, D, nh, hd, S, TJ)
            if built("ngram_fwd_mma", C, D, nh, hd, S, TJ) != want:
                bad.append(("ngram forward tensor-core generic", C, D, nh, hd, S, TJ))
        for dtype in (torch.float32, torch.bfloat16):
            if env.built_ngram_body(C, D, nh, hd, dtype) != env.ngram_body(C, D, nh, hd, dtype):
                bad.append(("ngram body", str(dtype), C, D, nh, hd))
            if (env.built_ngram_body(C, D, nh, hd, dtype, lib="ngram_context")
                    != env.ngram_body(C, D, nh, hd, dtype, forward=True)):
                bad.append(("ngram forward body", str(dtype), C, D, nh, hd))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for _, B, wh, ww, C, D, nh, hd in WIDTH_NGRAM_CASES:
        if (env.built_ngram_tile(B, wh, ww, C, D, nh, hd, sms)
                != env.ngram_mma_fwd_tile(B, wh, ww, C, D, nh, hd, sms)):
            bad.append(("ngram forward tile", B, wh, ww, C, D, nh, hd))
    for _, _, _, _, D, nh, hd, H, ws in WIDTH_NSTB_CASES:
        N = ws * ws
        mma = env.nstb_mma_plan(N, D, nh, hd, H)
        for body, want in ((1, -1 if mma is None else mma[1]),
                           (2, env.nstb_envelope(N, D, nh, hd, H))):
            if (built("nstb_map", N, D, nh, hd, H, body),
                    built("nstb_tokens", N, D, nh, hd, H, body)) != (want, want):
                bad.append(("nstb", env.NSTB_BODIES[body], N, D, nh, hd, H))
        for dtype in (torch.float32, torch.bfloat16):
            want = env.nstb_body(N, D, nh, hd, H, dtype)
            if (env.built_nstb_body("nstb_map", N, D, nh, hd, H, dtype),
                    env.built_nstb_body("nstb_tokens", N, D, nh, hd, H, dtype)) != (want, want):
                bad.append(("nstb body", str(dtype), N, D, nh, hd, H))
    return bad


def check_width_kernels(dev, card):
    """Phase 20a: the CUDA sources' shared-memory counts against
    ``envelope``'s; K1, K3-K7 at other widths than the full-width NGswin's
    (their generic bodies) against their plain versions, forward and every
    cotangent, at f32 and bf16 (held as phase 5 holds them), each backward
    twice and bit for bit; then each one's time (the launch alone) beside
    its plain version's and its bound.  Returns {kernel record name: [one
    row per geometry and dtype]}."""
    import torch

    from tmar_torch.ops import cuda_ngram
    from tmar_torch.ops import envelope as env
    from tmar_torch.ops.attention import window_attention_math
    from tmar_torch.ops.cuda_attention import (
        _PlainAttention, fused_window_attention, window_attention_backward_math,
        window_attention_kernel_math)
    from tmar_torch.ops.cuda_ffn import (
        _PlainFFN, ffn_backward_math, ffn_kernel_math, fused_residual_ffn)
    from tmar_torch.ops.cuda_ngram import (
        _PlainNGram, fused_ngram_context, ngram_context_kernel_backward_math,
        ngram_context_kernel_math, ngram_context_math)
    from tmar_torch.ops.ffn import ffn_math
    from tmar_torch.ops.window import shift_mask_components

    gen = torch.Generator(device=dev).manual_seed(11)
    failures = [("shared memory counts differ", g) for g in smem_count_failures()]
    print(f"[check] the generic bodies' shared memory, CUDA sources against envelope.py: "
          f"{'equal' if not failures else failures}", flush=True)
    rows = {k: [] for k in ("window_attention_fwd", "window_attention_bwd", "residual_ffn_fwd",
                            "residual_ffn_bwd", "ngram_context", "ngram_context_bwd")}
    hold = functools.partial(_hold, failures=failures)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    def record(kernel, label, dn, ms, plain_ms, bound, errs):
        half = "fwd" if kernel in ("window_attention_fwd", "residual_ffn_fwd", "ngram_context") else "bwd"
        rows[kernel].append({"geometry": label, "dtype": dn, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
                             "max_abs_err": errs[half][dn]})
        print(f"[time] {kernel} {label} {dn}: kernel {ms:.4f} ms (launch alone), plain "
              f"{plain_ms:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}); library: none (no "
              f"single PyTorch call computes it) on {card}")

    for label, nwin, N, D, nh, hd, ws, grid in WIDTH_ATTN_CASES:
        A = nh * hd
        acts = [randn(nwin, N, D)]
        params = [randn(D, 3 * A, scale=0.1), randn(3 * A, scale=0.1),
                  torch.rand(nh, 1, 1, generator=gen, device=dev) * 1.8 + 0.5,
                  randn(nh, N, N, scale=0.2), randn(A, D, scale=0.1), randn(D, scale=0.1)]
        g = randn(nwin, N, D)
        mc = None if grid is None else (*shift_mask_components(ws, ws // 2), *grid)
        name = f"{label} x=[{nwin}, {N}, {D}] heads={nh}x{hd} mask={'on' if grid else 'off'}"
        attention_body_line(f"{label} x=[{nwin}, {N}, {D}] heads={nh}x{hd}", N, D, nh, hd,
                            failures)
        errs = {h: {"float32": 0.0, "bfloat16": 0.0} for h in ("fwd", "bwd")}
        # every geometry is held at both shifts: the case's own, and the
        # other one (shift 0 beside ws/2 on an 8 x 8 grid of windows)
        masks = [(name, mc)]
        other = (*shift_mask_components(ws, ws // 2), 8, 8) if mc is None else None
        masks.append((f"{label} x=[{nwin}, {N}, {D}] heads={nh}x{hd} "
                      f"mask={'off' if mc is not None else 'on'}", other))
        for held, m in masks:
            hold("window_attention", held, ATTN_NAMES, 1,
                 lambda *a, m=m: fused_window_attention(*a, nh, mask_components=m),
                 lambda *a, m=m: window_attention_math(
                     a[0], a[1].to(a[0].dtype), a[2].to(a[0].dtype), a[3], a[4],
                     a[5].to(a[0].dtype), a[6].to(a[0].dtype), nh, mask_components=m),
                 acts, params, g, errs,
                 plain_bf16=lambda a, p, gg, m=m: [
                     window_attention_kernel_math(a[0], *p, nh, mask_components=m),
                     *window_attention_backward_math(a[0], gg, *p, nh, mask_components=m)],
                 param_bf16=N >= 32)
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            t = _time_pair(
                lambda *a: fused_window_attention(*a, nh, mask_components=mc),
                (lambda *a: _PlainAttention.apply(*a, nh, mc)) if dtype == torch.bfloat16 else
                (lambda *a: window_attention_math(*a, nh, mask_components=mc)),
                acts, params, g, dtype)
            launch = attention_launch_ms(acts[0].to(dtype), params, g.to(dtype), nh, mc)
            size = acts[0].to(dtype).element_size()
            body = env.attention_body(N, D, nh, hd, dtype)
            for i, kernel in enumerate(("window_attention_fwd", "window_attention_bwd")):
                record(kernel, name, dn, launch[i], t[2 + i],
                       bound_ms(*attention_work(nwin, N, D, nh, hd, size, i == 1), dn), errs)
                rows[kernel][-1]["body"] = body
        if N == 64 and (D, nh, hd) == (32, 2, 16) and mc is None:
            generic_bodies_at_the_flagship_geometry(dev, card, randn)

    for label, M, D, H in WIDTH_FFN_CASES:
        acts = [randn(M, D), randn(M, D)]
        params = [randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1), randn(D, H, scale=0.1),
                  randn(H, scale=0.1), randn(H, D, scale=0.1), randn(D, scale=0.1),
                  randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1)]
        g = randn(M, D)
        name = f"{label} x=[{M}, {D}] hidden={H}"
        errs = {h: {"float32": 0.0, "bfloat16": 0.0} for h in ("fwd", "bwd")}
        hold("residual_ffn", name, FFN_NAMES, 2, fused_residual_ffn, ffn_math, acts, params, g,
             errs, plain_bf16=lambda a, p, gg: [ffn_kernel_math(a[0], a[1], *p),
                                                *ffn_backward_math(a[0], a[1], *p, gg)],
             param_bf16=True)
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            t = _time_pair(fused_residual_ffn,
                           (lambda *a: _PlainFFN.apply(*a, 1e-5)) if dtype == torch.bfloat16
                           else ffn_math, acts, params, g, dtype)
            launch = ffn_launch_ms(acts[0].to(dtype), acts[1].to(dtype), params, g.to(dtype))
            size = acts[0].to(dtype).element_size()
            body = env.built_ffn_body(D, H, dtype)
            k5_body = env.built_ffn_body(D, H, dtype, lib="residual_ffn_fwd")
            print(f"[body] residual FFN {name} {dn}: K6 {body}, K5 {k5_body}")
            for i, kernel in enumerate(("residual_ffn_fwd", "residual_ffn_bwd")):
                record(kernel, name, dn, launch[i], t[2 + i],
                       bound_ms(*ffn_work(M, size, i == 1, D, H), dn), errs)
            rows["residual_ffn_fwd"][-1]["body"] = k5_body
            rows["residual_ffn_bwd"][-1]["body"] = body

    for label, B, wh, ww, C, D, nh, hd in WIDTH_NGRAM_CASES:
        A = nh * hd
        acts = [randn(B, wh, ww, C)]
        params = [randn(C, 3 * A, scale=0.2), randn(3 * A, scale=0.1),
                  torch.rand(nh, 1, 1, generator=gen, device=dev) * 1.8 + 0.5,
                  randn(9, nh, scale=0.5), randn(A, C, scale=0.2), randn(C, scale=0.1),
                  randn(2 * C, D, scale=0.2), randn(D, scale=0.1)]
        g = randn(B, wh, ww, D)
        name = f"{label} u=[{B}, {wh}, {ww}, {C}] D={D} heads={nh}x{hd}"
        errs = {h: {"float32": 0.0, "bfloat16": 0.0} for h in ("fwd", "bwd")}
        hold("ngram_context", name, NGRAM_NAMES, 1, lambda *a: fused_ngram_context(*a, nh),
             lambda *a: ngram_context_math(*a, num_heads=nh), acts, params, g, errs,
             plain_bf16=lambda a, p, gg: [
                 ngram_context_kernel_math(a[0], *p, num_heads=nh),
                 *ngram_context_kernel_backward_math(a[0], gg, *p, num_heads=nh)],
             param_bf16=True)
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            t = _time_pair(lambda *a: fused_ngram_context(*a, nh),
                           (lambda *a: _PlainNGram.apply(*a, nh)) if dtype == torch.bfloat16
                           else (lambda *a: ngram_context_math(*a, num_heads=nh)),
                           acts, params, g, dtype)
            uu, gg = acts[0].to(dtype), g.to(dtype)
            f = fused_ngram_context
            before = (f.launches, f.backward_launches)
            ops, out, ints = cuda_ngram._kernel_operands(uu, *params, nh)
            k1 = cuda_ms(lambda: cuda_ngram._launch(ops, out, ints), iters=50)
            k7 = cuda_ms(lambda: cuda_ngram._launch_backward(ops[:-1], gg, ints), iters=50)
            f.launches, f.backward_launches = before
            size = uu.element_size()
            record("ngram_context", name, dn, k1, t[2],
                   bound_ms(*ngram_work(B, wh, ww, nh, size, C, D, hd), dn), errs)
            body = env.built_ngram_body(C, D, nh, hd, dtype)
            k1_body = env.built_ngram_body(C, D, nh, hd, dtype, lib="ngram_context")
            if k1_body == "tensor-core generic":
                tile = env.built_ngram_tile(B, wh, ww, C, D, nh, hd,
                                            torch.cuda.get_device_properties(0).multi_processor_count)
                k1_body += f" on {tile[0]} x {tile[1]}-cell tiles"
            print(f"[body] n-gram context {name} {dn}: K7 {body}, K1 {k1_body}")
            rows["ngram_context"][-1]["body"] = k1_body
            record("ngram_context_bwd", name, dn, k7, t[3],
                   bound_ms(*ngram_bwd_work(B, wh, ww, nh, size, C, D, hd), dn), errs)
            rows["ngram_context_bwd"][-1]["body"] = body
    if failures:
        raise SystemExit(f"kernel checks at other widths failed: {failures}")
    return rows


def check_width_nstb(dev, card):
    """Phase 20c: K2 and K8 at other widths than the full-width NGswin's
    (their generic bodies: the tensor-core one at bf16, the CUDA-core one at
    f32, ``envelope.nstb_body``) against their plain versions
    (``WIDTH_NSTB_CASES``): K2 on the map and K8 on the windows of the
    rolled map, shift 0 with Q 1 and shift ws/2 with Q 4 (the mask on), f32
    and bf16, held as phase 2 holds K2 (f32 1e-4·max(1, max|ref|); bf16
    NSTB_BF16_TOL and NSTB_MEAN_TOL against the rounding-matched plain
    version), K8 bit for bit equal to K2; then each one's time (the launch
    alone, shift ws/2) beside its plain version's and its bound; past the
    envelope the refusal that names the bytes; and, printed only, the
    tensor-core generic body at the flagship's 8x512² stage-1 geometry
    beside the flagship's own body.  Returns {"nstb_map": rows,
    "nstb_tokens": rows}, one row per geometry and dtype, each naming its
    body."""
    import torch

    from tmar_torch.ops import cuda_nstb, envelope
    from tmar_torch.ops.window import cyclic_shift, window_partition, window_unpartition

    gen = torch.Generator(device=dev).manual_seed(20)
    failures = []
    rows = {"nstb_map": [], "nstb_tokens": []}
    counters = (cuda_nstb.fused_nstb_map.launches, cuda_nstb.fused_nstb.launches)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    for label, B, wh, ww, D, nh, hd, H, ws in WIDTH_NSTB_CASES:
        A, N = nh * hd, ws * ws
        ln = lambda: (randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1))  # noqa: E731
        args = (randn(D, 3 * A, scale=0.15), randn(3 * A, scale=0.1),
                torch.rand(nh, 1, 1, generator=gen, device=dev) * 1.8 + 0.5,
                randn((2 * ws - 1) ** 2, nh, scale=0.5), randn(A, D, scale=0.15),
                randn(D, scale=0.1), ln(), (randn(D, H, scale=0.15), randn(H, scale=0.1)),
                (randn(H, D, scale=0.1), randn(D, scale=0.1)), ln(), nh, ws)
        x = randn(B, wh * ws, ww * ws, D)
        name = (f"{label} x=[{B}, {wh * ws}, {ww * ws}, {D}] heads={nh}x{hd} hidden={H} "
                f"window={ws}")
        errs = {"float32": 0.0, "bfloat16": 0.0, "bf16_mean": 0.0, "bf16_vs_f32_plain": 0.0}
        for shift, Q in ((0, 1), (ws // 2, 4)):
            cq = randn(B * wh * ww, Q, D, scale=0.5)

            def plain_map(xi, ci, a, cdt=torch.float32):
                return cuda_nstb.nstb_map_math(xi, ci, *a[:-2], num_heads=a[-2],
                                               window_size=a[-1], shift=shift, compute_dtype=cdt)

            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[1]
                body = envelope.nstb_body(N, D, nh, hd, H, dtype)
                xx, cc = x.to(dtype), cq.to(dtype)
                zmap = cuda_nstb.fused_nstb_map(xx, cc, *args, shift=shift)
                wins = window_partition(cyclic_shift(xx, shift), ws)[0].reshape(-1, N, D)
                z = cuda_nstb.fused_nstb(wins, cc, *args, shift=shift, grid=(wh, ww))
                ok, line = hold_nstb(zmap, plain_map, xx, cc, args, errs)
                same = torch.equal(window_unpartition(z.reshape(-1, ws, ws, D), (wh, ww)), zmap)
                print(f"[kernel] nstb_map / nstb_tokens {body} body {name} shift={shift} Q={Q} "
                      f"{line}; K8 on the rolled windows equal to K2 bit for bit: {same}")
                if not (ok and same):
                    failures.append(f"nstb generic {label} shift={shift} {dn}")
                if shift == 0:
                    continue
                # the launch alone, the counters put back
                ops, out, ints = cuda_nstb._kernel_operands(xx, cc, *args, shift=shift)
                tops, tout, tints = cuda_nstb._token_operands(wins, cc, *args, shift, (wh, ww))
                k2 = cuda_ms(lambda: cuda_nstb._launch(ops, out, ints, 1e-5), iters=10)
                k8 = cuda_ms(lambda: cuda_nstb._launch_tokens(tops, tout, tints, 1e-5), iters=10)
                p2 = cuda_ms(lambda: plain_map(xx, cc, args), iters=3, warmup=1)
                p8 = cuda_ms(lambda: cuda_nstb.nstb_tokens_math(
                    wins, cc, *args[:-2], num_heads=nh, window_size=ws, shift=shift,
                    grid=(wh, ww)), iters=3, warmup=1)
                flops, nbytes = nstb_work(B, wh * ws, ww * ws, nh, Q, xx.element_size(), D, H, hd, ws)
                b_ms, b_by = bound_ms(flops, nbytes, dn)
                for kernel, k_ms, p_ms in (("nstb_map", k2, p2), ("nstb_tokens", k8, p8)):
                    rows[kernel].append({
                        "geometry": f"{name} shift={shift} Q={Q}", "dtype": dn, "body": body,
                        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None, "max_abs_err": errs[dn]})
                    print(f"[time] {kernel} {body} body {name} shift={shift} {dn}: kernel {k_ms:.4f} ms "
                          f"(launch alone), plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
                          f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB); library: none (no "
                          f"single PyTorch call computes it) on {card}")
                del ops, out, tops, tout
            del zmap, z, wins
        del x
        torch.cuda.empty_cache()
    cuda_nstb.fused_nstb_map.launches, cuda_nstb.fused_nstb.launches = counters

    D, nh, hd, H, ws = NSTB_PAST_ENVELOPE
    A = nh * hd
    past = [torch.zeros(s, device=dev) for s in ((D, 3 * A), (3 * A,), (nh, 1, 1),
                                                  ((2 * ws - 1) ** 2, nh), (A, D), (D,))]
    pair = lambda a, b: (torch.zeros(a, device=dev), torch.zeros(b, device=dev))  # noqa: E731
    try:
        cuda_nstb.fused_nstb_map(torch.zeros(1, ws, ws, D, device=dev),
                                 torch.zeros(1, 1, D, device=dev), *past, pair(D, D),
                                 pair((D, H), H), pair((H, D), D), pair(D, D), nh, ws)
        refused = ""
    except NotImplementedError as e:
        refused = str(e)
    ok = "bytes of shared memory" in refused and "K2/K8" in refused
    print(f"[check] past the envelope (window {ws}, D {D}, {nh} x {hd} heads, hidden {H}) K2 "
          f"refuses naming the bytes: {refused[:160]!r}: {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("K2 past the envelope")
    if failures:
        raise SystemExit(f"whole-block checks at other widths failed: {failures}")
    flagship_geometry_line(dev, card, randn)
    return rows


def flagship_geometry_line(dev, card, randn):
    """Printed only, not a dispatch: the tensor-core generic body (its own C
    entry ``tmar_nstb_map_mma``) at the flagship's 8x512² stage-1 shift-4
    block (6 x 10 heads, random weights) beside the flagship's own bf16 body
    on the same operands, the launch alone, and how far apart the two
    outputs land; K2's counter is put back."""
    import ctypes

    import torch

    from tmar_torch import kernels
    from tmar_torch.ops import cuda_nstb

    D, nh, hd, H, ws = 64, 6, 10, 128, 8
    A = nh * hd
    ln = lambda: (randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1))  # noqa: E731
    args = (randn(D, 3 * A, scale=0.15), randn(3 * A, scale=0.1),
            randn(nh, 1, 1, scale=0.5, shift=1.4), randn(225, nh, scale=0.5),
            randn(A, D, scale=0.15), randn(D, scale=0.1), ln(),
            (randn(D, H, scale=0.15), randn(H, scale=0.1)),
            (randn(H, D, scale=0.1), randn(D, scale=0.1)), ln(), nh, ws)
    x = randn(8, 512, 512, D).to(torch.bfloat16)
    cq = randn(8 * 64 * 64, 4, D, scale=0.5).to(torch.bfloat16)
    before = cuda_nstb.fused_nstb_map.launches
    ops, out, ints = cuda_nstb._kernel_operands(x, cq, *args, shift=4)
    out_mma = torch.empty_like(out)
    mma = kernels.host_function("nstb_map", "tmar_nstb_map_mma",
                                cuda_nstb._ARGTYPES, ctypes.c_int)

    def launch_mma():
        kernels.check("nstb_map", mma(*[t.data_ptr() for t in ops], out_mma.data_ptr(), None, *ints,
                                      1e-5, torch.cuda.current_stream().cuda_stream))

    flag = cuda_ms(lambda: cuda_nstb._launch(ops, out, ints, 1e-5), iters=10)
    gen = cuda_ms(launch_mma, iters=10)
    cuda_nstb.fused_nstb_map.launches = before
    diff = float((out.float() - out_mma.float()).abs().max())
    scale = float(out.float().abs().max())
    print(f"[time] nstb_map at the flagship's geometry, x [8, 512, 512, 64] bf16, 6 x 10 heads, "
          f"shift 4 (printed only, not a dispatch): tensor-core generic body {gen:.4f} ms, the "
          f"flagship's own body {flag:.4f} ms; outputs max |diff| {diff:.3e} of max|out| "
          f"{scale:.3e} on {card}")
    del ops, out, out_mma, x, cq
    torch.cuda.empty_cache()


# the demo width (examples/demo_end_to_end.py, tests/test_ngswin_pallas.py)
# on the shipped recipe, nothing else changed: 8 NSTBs of embed 32, 2 heads
DEMO_OVERRIDES = {
    "model.embed_dim": 32, "model.depths": [2, 2, 2], "model.num_heads": [2, 2, 2],
    "model.dec_dim": 32, "model.dec_depths": 2, "model.dec_num_heads": 2,
    "disc.base_channels": 16, "disc.num_scales": 2, "data.patch_size": 64,
    "data.batch_size": 8, "radon.num_angles": 24, "data.dataset": "synthetic",
}
DEMO_PATCH = 64


def demo_width(card):
    """Phase 20b: the shipped recipe at the demo width through the Trainer
    (K1, K7 and K3-K6 on their generic bodies, 8 launches each per step),
    one f32 step on the card against the CPU, then the trained generator in
    the unfused serving form (K1 + K3 + K5), the map form (K1 + K2) and the
    token form (K1 + K8), the latter two timed and device-profiled (busy
    time, the whole-block kernel's share, the idle share of the median
    request).  Returns the launches per step of the timed run."""
    import tempfile

    import torch

    from tmar_torch import NGswin, make_inference_fn
    from tmar_torch.data import SyntheticMARDataset
    from tmar_torch.train import Trainer
    from tmar_torch.utils.profiling import device_profile

    failures = []

    def check(cond, what):
        print(f"[check] demo width: {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(what)

    def demo_batch(n, device):
        ds = SyntheticMARDataset(size=DEMO_PATCH, length=n, base_seed=7)
        samples = [ds[i] for i in range(n)]
        return {k: torch.from_numpy(np.stack([sm[k] for sm in samples])[..., None]).to(device)
                for k in ("ct", "gt")}

    counters = _train_counters()
    with tempfile.TemporaryDirectory(prefix="tmar_demo_") as tmp:
        cfg = _trainer_config(tmp, **{**DEMO_OVERRIDES, "data.samples_per_epoch": 4 * 8,
                                       "num_epochs": 1, "run_name": "demo"})
        m = cfg.model
        check((m.embed_dim, tuple(m.depths), tuple(m.num_heads), m.dec_dim, m.dec_depths,
               m.window_size, cfg.variant, cfg.radon.enabled, cfg.disc.fused_pairs)
              == (32, (2, 2, 2), (2, 2, 2), 32, 2, 8, "full", True, True),
              "the shipped recipe at embed 32, depths 2/2/2 + 2, heads 2, window 8, full variant, "
              "sinogram term, fused_pairs")
        trainer = Trainer(cfg)
        for f, attr in counters.values():
            setattr(f, attr, 0)
        t0 = time.perf_counter()
        trainer.fit(progress=False)
        wall = time.perf_counter() - t0
        steps = int(trainer.state.step)
        fit_launches = {k: getattr(f, attr) for k, (f, attr) in counters.items()}
        print(f"[demo] Trainer.fit: {steps} full steps of 8x{DEMO_PATCH}² bf16 at the demo width "
              f"in {wall:.1f} s; launches {fit_launches} on {card}")
        check(steps == 4 and all(np.isfinite(v) for h in trainer.history for v in h.values()),
              "Trainer.fit takes 4 steps, every logged metric finite")
        check([fit_launches[k] for k in counters] == [8 * steps] * 6 + [0],
              "Trainer.fit: 8 launches per step of each of K3, K4, K5, K6, K1 and K7, none of K2")

        # the step alone on one fixed batch already on the card
        batch = demo_batch(8, "cuda")
        for f, attr in counters.values():
            setattr(f, attr, 0)
        history, times = [], []
        warmup, timed = 2, 10
        for _ in range(warmup + timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.state, metrics = trainer.train_step(trainer.state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            history.append({k: float(v) for k, v in metrics.items()})
        n = warmup + timed
        per_step = {k: getattr(f, attr) / n for k, (f, attr) in counters.items()}
        print("[demo] launches per step: " + ", ".join(f"{k} {v:g}" for k, v in per_step.items()))
        check([per_step[k] for k in counters] == [8] * 6 + [0],
              "8 launches per full step of each of K3, K4, K5, K6, K1 and K7, none of K2")
        check(all(np.isfinite(v) for h in history for v in h.values()),
              f"every metric finite at each of the {n} steps")
        check(history[-1]["g_rec"] < history[0]["g_rec"],
              f"g_rec falls on the fixed batch: {history[0]['g_rec']:.5f} -> {history[-1]['g_rec']:.5f}")
        med = statistics.median(times[warmup:])
        print(f"[time] train step (full, demo width) 8x{DEMO_PATCH}² bf16: median {med * 1e3:.2f} ms "
              f"of {timed} steps (min {min(times[warmup:]) * 1e3:.2f}, max "
              f"{max(times[warmup:]) * 1e3:.2f}), {1 / med:.3f} steps/s on {card}")
        prof = profile_request(lambda: trainer.train_step(trainer.state, batch), card,
                               label=f"train step (full, demo width) 8x{DEMO_PATCH}² bf16",
                               kernels=STEP_KERNELS, before=STEP_KERNELS_BEFORE)
        check(prof is not None, "the profiler saw the step's device time")
        trained = trainer.generator
        sd = {k: v.detach().float() for k, v in trained.state_dict().items()}
        del trainer
        torch.cuda.empty_cache()

        # one float32 full step on the card against the same step on the CPU
        cfg32 = _trainer_config(tmp, **{**DEMO_OVERRIDES, "bf16": False, "data.batch_size": 1,
                                        "run_name": "demo_f32"})
        on_cpu, on_card = Trainer(cfg32, device="cpu"), Trainer(cfg32)
        b1 = demo_batch(1, "cpu")
        _, cpu_m = on_cpu.train_step(on_cpu.state, b1)
        _, gpu_m = on_card.train_step(on_card.state, {k: v.cuda() for k, v in b1.items()})
        compare_step(on_cpu.state, on_card.state, cpu_m, gpu_m, "demo width f32 full step", check,
                     patch=DEMO_PATCH)
        del on_cpu, on_card
        torch.cuda.empty_cache()
        demo_default_form(tmp, card, demo_batch(8, "cuda"), check)

    # the trained generator served in the unfused form (K1 + K3 + K5)
    kw = dict(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 2, 2), dec_dim=32, dec_depths=2,
              dec_num_heads=2)
    served = NGswin(dtype=torch.bfloat16, nstb_fused=False, **kw)
    served.load_state_dict(sd)
    x = np.random.default_rng(5).uniform(-1, 1, (8, 256, 256, 1)).astype(np.float32)
    _reset_serving_counters()
    fwd = make_inference_fn(served)
    y = fwd(x)
    got, _ = _read_serving_counters()
    print(f"[demo] unfused 8x256² bf16 request: out {list(y.shape)} range [{y.min():.4f}, "
          f"{y.max():.4f}]; launches {got}")
    check(bool(np.isfinite(y).all()) and y.min() >= -1 and y.max() <= 1,
          "the unfused request serves finite values in [-1, 1]")
    check(got["ngram_context"] == 8 and got["window_attention_fwd"] == 8
          and got["residual_ffn_fwd"] == 8 and got["nstb_map"] == 0 and got["nstb_tokens"] == 0,
          "the unfused request launches 8 each of K1, K3 and K5, none of K2 or K8")
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"[time] unfused request (demo width) 8x256² bf16: median "
          f"{statistics.median(times[1:]) * 1e3:.2f} ms of 5 on {card}")
    x1 = x[:1, :128, :128]
    f32_card = NGswin(dtype=torch.float32, nstb_fused=False, **kw)
    f32_card.load_state_dict(sd)
    f32_cpu = NGswin(dtype=torch.float32, nstb_fused=False, device="cpu", **kw)
    f32_cpu.load_state_dict(sd)
    d = float(np.abs(make_inference_fn(f32_card)(x1) - make_inference_fn(f32_cpu, "cpu")(x1)).max())
    print(f"[check] demo width unfused f32 1x128², card vs CPU plain: max |diff| {d:.3e} tol 1e-4")
    check(d <= 1e-4, "the unfused f32 request matches the CPU within 1e-4")
    # the map form (K1 + K2) and the token form (K1 + K8) at this width, on
    # K2's and K8's generic body: against the unfused form at bf16, the CPU
    # at f32
    for form, kwargs, kernel in (("map", {}, "nstb_map"), ("token", {"nstb_map": False}, "nstb_tokens")):
        served = NGswin(dtype=torch.bfloat16, **kw, **kwargs)
        served.load_state_dict(sd)
        fwd = make_inference_fn(served)
        _reset_serving_counters()
        yf = fwd(x)
        got, _ = _read_serving_counters()
        d = np.abs(yf - y)
        print(f"[demo] {form} form 8x256² bf16 request: launches {got}; against the unfused form "
              f"max |diff| {d.max():.3e} mean {d.mean():.2e} (tol 0.1, 1e-2)")
        others = {k: v for k, v in got.items() if k not in ("ngram_context", kernel)}
        check(got["ngram_context"] == 8 and got[kernel] == 8 and not any(others.values()),
              f"the {form}-form request launches 8 each of K1 and {'K2' if form == 'map' else 'K8'}, "
              f"nothing else")
        check(bool(np.isfinite(yf).all()) and d.max() <= 0.1 and d.mean() <= 1e-2,
              f"the {form}-form request against the unfused form at bf16")
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print(f"[time] {form}-form request (demo width) 8x256² bf16: median "
              f"{statistics.median(times[1:]) * 1e3:.2f} ms of 5 on {card}")
        # the device's share of the request: busy ms an iteration (device_profile
        # over 3), the whole-block kernel's rows, the five longest ops
        rows = device_profile(fwd, x, iters=3, top=1 << 30)
        busy = sum(r["ms"] for r in rows)
        named = lambda rs: ", ".join("%s %.3f x%d" % (r["op"][:48], r["ms"], r["count"])  # noqa: E731
                                     for r in rs)
        print(f"[profile] {form}-form request (demo width) 8x256² bf16, device ms an iteration "
              f"(x: launches in 3): busy {busy:.3f}, idle share "
              f"{1 - busy / (statistics.median(times[1:]) * 1e3):.3f} of the median; "
              f"{named(r for r in rows if 'nstb' in r['op'])}; top: {named(rows[:5])} on {card}")
        f32_card = NGswin(dtype=torch.float32, **kw, **kwargs)
        f32_card.load_state_dict(sd)
        f32_cpu = NGswin(dtype=torch.float32, device="cpu", **kw, **kwargs)
        f32_cpu.load_state_dict(sd)
        d = float(np.abs(make_inference_fn(f32_card)(x1)
                         - make_inference_fn(f32_cpu, "cpu")(x1)).max())
        print(f"[check] demo width {form} form f32 1x128², card vs CPU plain: max |diff| {d:.3e} "
              f"tol 1e-4")
        check(d <= 1e-4, f"the {form}-form f32 request matches the CPU within 1e-4")
        del served, f32_card, f32_cpu
    if failures:
        raise SystemExit(f"demo-width checks failed: {failures}")
    return {k: int(v) for k, v in per_step.items()}


# examples/demo_end_to_end.py's own config: the JAX package's default
# TrainConfig (use_pallas_attention false, attn_backward auto) with the
# example's overrides, trained here at bf16
DEMO_EXAMPLE = {
    "model.embed_dim": 32, "model.depths": [2, 2, 2], "model.num_heads": [2, 2, 2],
    "model.dec_dim": 32, "model.dec_depths": 2, "model.dec_num_heads": 2,
    "disc.base_channels": 16, "disc.num_scales": 2, "data.patch_size": 64, "data.batch_size": 8,
    "data.samples_per_epoch": 32, "data.num_workers": 2, "radon.num_angles": 24,
    "loss.dilation_radius": 2, "log_every": 2, "data.dataset": "synthetic",
}
# K3's and K4's device time per demo-width full step before their
# tensor-core generic bodies (PERF.md §5, the 8x64² bf16 step's [profile])
DEMO_STEP_K3_K4_BEFORE = (1.59, 4.48)


def demo_default_form(tmp, card, batch, check):
    """Phase 20b, the demo example's own config in the JAX package's default
    model form through ``Trainer.fit`` at bf16 (one epoch of 4 ``full``
    steps, no validation), then 3 steps on one fixed batch: 8 launches per
    step of each of K1, K7 and K3-K6 (the forward-only whole-block kernels
    never run under autograd), ``g_rec`` falling; and one step's device
    time by kernel, K3's and K4's (their tensor-core generic bodies) beside
    their time before those bodies."""
    import torch

    from tmar_torch.train import Trainer, load_config
    from tmar_torch.utils.profiling import device_profile

    cfg = load_config(None, {**DEMO_EXAMPLE, "bf16": True, "num_epochs": 1,
                             "val_every_n_epochs": 2, "run_dir": tmp, "run_name": "demo_default"})
    check(not cfg.model.use_pallas_attention and cfg.model.attn_backward == "auto"
          and cfg.variant == "full", "the demo example's config: the JAX default model form")
    trainer = Trainer(cfg)
    counters = _train_counters()
    for f, attr in counters.values():
        setattr(f, attr, 0)
    trainer.fit(progress=False)
    fit = {k: getattr(f, attr) for k, (f, attr) in counters.items()}
    steps = int(trainer.state.step)
    check(steps == 4 and all(np.isfinite(v) for h in trainer.history for v in h.values()),
          f"the default form's Trainer.fit takes 4 steps, every metric finite (launches {fit})")
    for f, attr in counters.values():
        setattr(f, attr, 0)
    history = []
    for _ in range(3):
        trainer.state, metrics = trainer.train_step(trainer.state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
    torch.cuda.synchronize()
    per_step = {k: getattr(f, attr) / 3 for k, (f, attr) in counters.items()}
    print("[demo default form] launches per step: "
          + ", ".join(f"{k} {v:g}" for k, v in per_step.items()))
    check([per_step[k] for k in counters] == [8] * 6 + [0],
          "the default form: 8 launches per full step of each of K3, K4, K5, K6, K1 and K7, "
          "none of K2")
    check(all(np.isfinite(v) for h in history for v in h.values())
          and history[-1]["g_rec"] < history[0]["g_rec"],
          f"the default form: metrics finite, g_rec falls on the fixed batch "
          f"{history[0]['g_rec']:.5f} -> {history[-1]['g_rec']:.5f}")
    rows = device_profile(lambda: trainer.train_step(trainer.state, batch), iters=3, top=1 << 30)
    busy = sum(r["ms"] for r in rows)
    k3 = sum(r["ms"] for r in rows if "window_attention_fwd" in r["op"])
    k4 = sum(r["ms"] for r in rows if any(n in r["op"] for n in K4_KERNEL_NAMES))
    print(f"[profile] demo default form full step 8x{DEMO_PATCH}² bf16, device ms per step: busy "
          f"{busy:.3f}; K3 {k3:.3f} ({100 * k3 / busy:.1f} %), K4 {k4:.3f} ({100 * k4 / busy:.1f} "
          f"%), on their tensor-core generic bodies; before them (PERF.md §5) K3 "
          f"{DEMO_STEP_K3_K4_BEFORE[0]}, K4 {DEMO_STEP_K3_K4_BEFORE[1]} on {card}")
    check(k3 > 0 and k4 > 0, "the profile holds K3's and K4's device time")
    del trainer
    torch.cuda.empty_cache()


def train_forms(card):
    """Phase 24: the JAX package's default model form trains on the card.
    The default ``TrainConfig`` model (embed 64, depths 6/4/4 + 6, heads
    6/4/4 + 6, ``use_pallas_attention: false``, ``attn_backward: auto``) on
    the promoted recipe's data settings: ``Trainer.fit`` takes one epoch of
    4 ``full`` steps of 8x128² bf16 (no validation), then 3 steps on one
    fixed batch with the launch counts (20 per step of each of K1, K7 and
    K3-K6) and ``g_rec`` falling.  Then one f32 step at 1x128² on the card
    against the same step on the CPU (the plain path computes one function
    in every form: one CPU step is the reference of all three) for the
    default form, ``use_pallas_attention: true`` with ``attn_backward:
    auto`` and with ``xla``, each with its launches (``xla``: no K4).
    Returns the default form's launches per bf16 step."""
    import tempfile

    import torch

    from tmar_torch.train import Trainer
    from tmar_torch.train.config import ModelConfig

    failures = []

    def check(cond, what):
        print(f"[check] default form: {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(what)

    default = ModelConfig()
    widths = {f"model.{k}": getattr(default, k) for k in (
        "embed_dim", "depths", "num_heads", "dec_dim", "dec_depths", "dec_num_heads",
        "use_pallas_attention", "attn_backward")}
    counters = _train_counters()
    kernel_order = list(counters)
    with tempfile.TemporaryDirectory(prefix="tmar_forms_") as tmp:
        cfg = _trainer_config(tmp, **{**widths, "num_epochs": 1, "val_every_n_epochs": 2,
                                      "run_name": "default"})
        m = cfg.model
        check((m.embed_dim, tuple(m.depths), m.use_pallas_attention, m.attn_backward)
              == (64, (6, 4, 4), False, "auto"),
              "the JAX default model (embed 64, depths 6/4/4, use_pallas_attention false, "
              "attn_backward auto) on the promoted recipe")
        trainer = Trainer(cfg)
        check(trainer.generator.attn_backward == "auto", "the Trainer builds the auto form")
        t0 = time.perf_counter()
        trainer.fit(progress=False)
        wall = time.perf_counter() - t0
        check(int(trainer.state.step) == 4
              and all(np.isfinite(v) for h in trainer.history for v in h.values()),
              f"Trainer.fit takes 4 full steps of {TRAIN_BATCH}x{TRAIN_PATCH}² bf16 in {wall:.1f} s, "
              f"every metric finite")
        batch = _synthetic_batch(TRAIN_BATCH, "cuda")
        for f, attr in counters.values():
            setattr(f, attr, 0)
        history = []
        for _ in range(3):
            trainer.state, metrics = trainer.train_step(trainer.state, batch)
            history.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        per_step = {k: getattr(f, attr) / 3 for k, (f, attr) in counters.items()}
        print("[train default form] launches per step: "
              + ", ".join(f"{k} {v:g}" for k, v in per_step.items()))
        check([per_step[k] for k in kernel_order] == [20] * 6 + [0],
              "20 launches per full step of each of K3, K4, K5, K6, K1 and K7, none of K2")
        check(all(np.isfinite(v) for h in history for v in h.values())
              and history[-1]["g_rec"] < history[0]["g_rec"],
              f"metrics finite, g_rec falls on the fixed batch: {history[0]['g_rec']:.5f} -> "
              f"{history[-1]['g_rec']:.5f}")
        del trainer
        torch.cuda.empty_cache()

        # one f32 step at 1x128² of each kernel form against the CPU
        f32 = lambda pallas, backward, name: _trainer_config(tmp, **{  # noqa: E731
            **widths, "bf16": False, "data.batch_size": 1, "run_name": name,
            "model.use_pallas_attention": pallas, "model.attn_backward": backward})
        on_cpu = Trainer(f32(False, "auto", "cpu"), device="cpu")
        batch = _synthetic_batch(1, "cpu")
        _, cpu_m = on_cpu.train_step(on_cpu.state, batch)
        for pallas, backward, k4 in ((False, "auto", 20), (True, "auto", 20), (True, "xla", 0)):
            label = f"use_pallas_attention {str(pallas).lower()}, attn_backward {backward}"
            on_card = Trainer(f32(pallas, backward, f"f32_{pallas}_{backward}"))
            for f, attr in counters.values():
                setattr(f, attr, 0)
            _, gpu_m = on_card.train_step(on_card.state, {k: v.cuda() for k, v in batch.items()})
            torch.cuda.synchronize()
            got = {k: getattr(f, attr) for k, (f, attr) in counters.items()}
            print(f"[train default form] {label}: f32 step launches {got}")
            check([got[k] for k in kernel_order] == [20, k4, 20, 20, 20, 20, 0],
                  f"{label}: 20 launches of each of K3, K5, K6, K1 and K7, {k4} of K4, none of K2")
            compare_step(on_cpu.state, on_card.state, cpu_m, gpu_m, f"f32 full step, {label}",
                         check)
            del on_card
            torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"default-form training checks failed: {failures}")
    return {k: int(v) for k, v in per_step.items()}


def _train_counters():
    from tmar_torch.ops import cuda_attention, cuda_ffn, cuda_ngram, cuda_nstb

    return {
        "window_attention_fwd": (cuda_attention.fused_window_attention, "launches"),
        "window_attention_bwd": (cuda_attention.fused_window_attention, "backward_launches"),
        "residual_ffn_fwd": (cuda_ffn.fused_residual_ffn, "launches"),
        "residual_ffn_bwd": (cuda_ffn.fused_residual_ffn, "backward_launches"),
        "ngram_context": (cuda_ngram.fused_ngram_context, "launches"),
        "ngram_context_bwd": (cuda_ngram.fused_ngram_context, "backward_launches"),
        "nstb_map": (cuda_nstb.fused_nstb_map, "launches"),
    }


def _gan(dtype, device, seed, batch_size, ngrams=(2, 2, 2, 2), ngram_fused=False):
    """Full-width generator (training form, n-gram context on its
    composition path: ``ngram_fused=False``, or any n but 2) and
    discriminator from a seed,
    their optimizers, state and step, and a fixed seeded batch (input uniform
    in [-1, 1], so the metal mask at 0.6 is non-empty)."""
    import torch

    from tmar_torch import (LossWeights, MultiScaleDiscriminator, NGswin, create_train_state,
                            make_train_step)

    gen = NGswin(ngrams=ngrams, dtype=dtype, attn_backward="pallas", ngram_fused=ngram_fused,
                 device=device)
    disc = MultiScaleDiscriminator(dtype=dtype, device=device)
    g_opt = torch.optim.Adam(gen.parameters(), 1e-4, betas=(0.5, 0.999), eps=1e-8)
    d_opt = torch.optim.Adam(disc.parameters(), 2e-4, betas=(0.5, 0.999), eps=1e-8)
    state = create_train_state(torch.Generator().manual_seed(seed), gen, disc, g_opt, d_opt,
                               ema_decay=0.999)
    step = make_train_step(gen, disc, g_opt, d_opt, LossWeights(phys=0.0), fused_pairs=True,
                           ema_decay=0.999, device=device)
    rng = np.random.default_rng(0)
    shape = (batch_size, TRAIN_PATCH, TRAIN_PATCH, 1)
    ct = rng.uniform(-1, 1, shape).astype(np.float32)
    # The target is a function of the input, so that there is something to
    # learn in a few steps: half the input, minus the pixels above the metal
    # threshold.  (A target of independent noise leaves the reconstruction
    # term at its floor, mean |w·gt|, from the first step on.)
    gt = np.where(ct > 0.6, -0.5, 0.5 * ct).astype(np.float32)
    return state, step, {"ct": ct, "gt": gt}


def train(card):
    """Phase 6: GAN steps at full width in bfloat16.  Returns the launch
    counts of the run and the trained generator."""
    import torch

    failures = []

    def check(cond, what):
        print(f"[check] {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(what)

    dev = torch.device("cuda")
    state, step, batch = _gan(torch.bfloat16, "cuda", seed=0, batch_size=TRAIN_BATCH)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    n_g = sum(p.numel() for p in state.generator.parameters())
    n_d = sum(p.numel() for p in state.discriminator.parameters())
    print(f"[train] generator {n_g} parameters (training form), discriminator {n_d} "
          f"(3 scales, spectral norm); batch {TRAIN_BATCH}x{TRAIN_PATCH}² bf16, fused_pairs, "
          f"phys=0, Adam 1e-4/2e-4 b1 0.5, EMA 0.999")
    check(n_g == 990_811, "generator has the full-width 990,811 parameters")

    counters = _train_counters()
    warmup, timed = 3, 10
    for f, attr in counters.values():
        setattr(f, attr, 0)
    history, times = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(warmup + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        history.append({k: float(v) for k, v in metrics.items()})
    launches = {name: getattr(f, attr) for name, (f, attr) in counters.items()}
    steps = warmup + timed
    for i in (0, 1, warmup, steps - 1):
        print(f"[train] step {i + 1}: " + " ".join(f"{k} {v:.5f}" for k, v in history[i].items())
              + f" ({times[i] * 1e3:.1f} ms)")
    print("[train] g_rec by step: " + " ".join(f"{h['g_rec']:.5f}" for h in history))
    want = {"loss_d", "loss_g", "g_adv", "g_fm", "g_rec", "g_edge", "g_metal"}
    check(all(want <= set(h) for h in history), "every metric of the step is reported")
    check(all(np.isfinite(v) for h in history for v in h.values()),
          f"every metric finite at each of the {steps} steps")
    check(history[-1]["g_rec"] < history[0]["g_rec"],
          f"g_rec falls on the fixed batch: {history[0]['g_rec']:.5f} -> {history[-1]['g_rec']:.5f}")
    per_step = {k: v / steps for k, v in launches.items()}
    print("[train] launches per step: " + ", ".join(f"{k} {v:g}" for k, v in per_step.items())
          + f" (totals over {steps} steps: {launches})")
    check([per_step[k] for k in counters] == [60, 60, 20, 20, 0, 0, 0],
          "60 attention and 20 FFN launches, forward and backward, per step; none of the "
          "n-gram context's or the whole-block kernel")
    check(state.step == steps, "the state counts its steps")
    med = statistics.median(times[warmup:])
    print(f"[time] train step {TRAIN_BATCH}x{TRAIN_PATCH}² bf16 (A1_no_physics recipe, composition "
          f"n-gram, batch on the card): median {med * 1e3:.2f} ms of {timed} steps "
          f"(min {min(times[warmup:]) * 1e3:.2f}, max {max(times[warmup:]) * 1e3:.2f}), "
          f"{1 / med:.3f} steps/s, {TRAIN_BATCH / med:.1f} patches/s on {card}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # K3 and K4 on the n-gram windows (40 launches each a step: 4 tokens at
    # n = 2, the templated bodies at bf16; K4's reduce_partials shares its
    # name with K6's and is left out) beside the 64-token windows' (20 each,
    # the flagship bodies)
    profile_request(lambda: step(state, batch), card,
                    label=f"train step {TRAIN_BATCH}x{TRAIN_PATCH}² bf16",
                    kernels={"K3 n-gram windows (window_attention_fwd_kernel)":
                             ("window_attention_fwd_kernel<",),
                             "K4 n-gram windows (window_attention_bwd_kernel)":
                             ("window_attention_bwd_kernel<",),
                             "K3 64-token windows (window_attention_fwd_mma)":
                             ("window_attention_fwd_mma",),
                             "K4 64-token windows (window_attention_bwd_mma, its sums and reduce)":
                             ("window_attention_bwd_mma", "attention_param_sums<",
                              "reduce_backward_partials")})
    if failures:
        raise SystemExit(f"training checks failed: {failures}")
    return launches, state.generator


def compare_step(cpu_state, gpu_state, cpu_m, gpu_m, label, check, patch=None):
    """One train step on the card against the same step on the CPU: the loss
    terms and the gradients the step left in both networks."""
    worst = 0.0
    for k in cpu_m:
        a, b = float(gpu_m[k]), float(cpu_m[k])
        worst = max(worst, abs(a - b) / max(1.0, abs(b)))
    check(set(cpu_m) == set(gpu_m), f"{label}: the same loss terms on both sides")
    print(f"[check] {label} at 1x{patch or TRAIN_PATCH}², card vs CPU plain, {len(cpu_m)} loss terms "
          f"({' '.join(sorted(cpu_m))}): worst |diff| / max(1, |ref|) {worst:.3e} tol 1e-4")
    check(worst <= 1e-4, f"{label} loss terms, card vs CPU plain")
    for name, a_net, b_net in (("generator", gpu_state.generator, cpu_state.generator),
                               ("discriminator", gpu_state.discriminator, cpu_state.discriminator)):
        worst, where, n = 0.0, "", 0
        b_grads = dict(b_net.named_parameters())
        # a tensor's scale is its own largest gradient, but not less than
        # 1e-3 of the network's: a gradient that is zero in exact arithmetic
        # (the hinge loss's in a logit bias) is rounding noise on both sides
        floor = 1e-3 * max(float(p.grad.abs().max()) for p in b_grads.values())
        for k, p in a_net.named_parameters():
            ref = b_grads[k].grad
            rel = float((p.grad.cpu() - ref).abs().max()) / max(float(ref.abs().max()), floor)
            n += 1
            if rel > worst:
                worst, where = rel, k
        print(f"[check] {label} gradients of the {name}, card vs CPU plain, {n} tensors: worst "
              f"max|diff| / max(max|ref|, 1e-3 of the network's) {worst:.3e} at {where} "
              f"tol {STEP_TOL:g}")
        check(worst <= STEP_TOL, f"{label} gradients of the {name}, card vs CPU plain")


def train_correctness(trained, card):
    """Phase 7: one float32 step on the card against the same step on the
    CPU; then the trained generator serves in its inference form."""
    import torch

    from tmar_torch import NGswin, make_inference_fn

    failures = []

    def check(cond, what):
        print(f"[check] {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(what)

    cpu_state, cpu_step, batch = _gan(torch.float32, "cpu", seed=1, batch_size=1)
    gpu_state, gpu_step, _ = _gan(torch.float32, "cuda", seed=2, batch_size=1)
    gpu_state.generator.load_state_dict(cpu_state.generator.state_dict())
    gpu_state.discriminator.load_state_dict(cpu_state.discriminator.state_dict())
    gpu_state.g_ema = {k: v.detach().clone() for k, v in gpu_state.generator.named_parameters()}
    _, cpu_m = cpu_step(cpu_state, batch)
    _, gpu_m = gpu_step(gpu_state, batch)
    compare_step(cpu_state, gpu_state, cpu_m, gpu_m, "f32 step", check)
    del cpu_state, gpu_state
    torch.cuda.empty_cache()

    # the trained generator in the inference form, on the same state_dict
    served = NGswin(dtype=torch.bfloat16)
    served.load_state_dict(trained.state_dict())
    x = np.random.default_rng(3).uniform(-1, 1, (TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 1)).astype(np.float32)
    y = make_inference_fn(served)(x)
    y_train = make_inference_fn(trained)(x)
    d = float(np.abs(y - y_train).max())
    print(f"[serve] trained generator in the inference form: out {list(y.shape)} range "
          f"[{y.min():.4f}, {y.max():.4f}]; max |diff| to its training form {d:.3e} (tol 0.1, bf16)")
    check(bool(np.isfinite(y).all()) and y.min() >= -1 and y.max() <= 1,
          "trained generator serves finite values in [-1, 1]")
    check(d <= 0.1, "inference and training forms agree on the trained weights")
    if failures:
        raise SystemExit(f"training correctness checks failed: {failures}")


def check_radon(card):
    """Phase 8: the Radon projector on the card against the port's CPU run."""
    import torch

    from tmar_torch.ops.radon import Radon

    failures = []

    def check(cond, what):
        print(f"[check] {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(what)

    angles = np.linspace(0, np.pi, 180, endpoint=False)
    rng = np.random.default_rng(4)
    img = rng.uniform(-1, 1, (TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH)).astype(np.float32)
    sino = rng.standard_normal((TRAIN_BATCH, 180, TRAIN_PATCH)).astype(np.float32)
    on_card, on_cpu = Radon(TRAIN_PATCH, angles), Radon(TRAIN_PATCH, angles, device="cpu")
    x, y = torch.from_numpy(img).cuda(), torch.from_numpy(sino).cuda()
    px, aty = on_card.forward(x), on_card.backward(y)
    px_ref, aty_ref = on_cpu.forward(torch.from_numpy(img)), on_cpu.backward(torch.from_numpy(sino))
    torch.cuda.synchronize()
    for name, got, ref in (("forward", px, px_ref), ("adjoint", aty, aty_ref)):
        err, scale = float((got.cpu() - ref).abs().max()), float(ref.abs().max())
        print(f"[radon] {name} {list(got.shape)} f32, card vs CPU: max_abs_err {err:.3e} on values "
              f"up to {scale:.1f} (tol 1e-4 x that)")
        check(err <= 1e-4 * scale and bool(torch.isfinite(got).all()), f"radon {name}, card vs CPU")
    lhs = float((px.double() * y.double()).sum())
    rhs = float((x.double() * aty.double()).sum())
    print(f"[radon] adjoint identity <P x, y> = {lhs:.6e}, <x, P^T y> = {rhs:.6e}, relative "
          f"difference {abs(lhs - rhs) / abs(lhs):.3e} (tol 1e-4)")
    check(abs(lhs - rhs) <= 1e-4 * abs(lhs), "radon adjoint identity on the card")
    xg = x.clone().requires_grad_()
    (gx,) = torch.autograd.grad((on_card.forward(xg) * y).sum(), xg)
    check(torch.equal(gx, aty), "the gradient of <P x, y> is the adjoint, bit for bit")
    f_ms = cuda_ms(lambda: on_card.forward(x), iters=10)
    a_ms = cuda_ms(lambda: on_card.backward(y), iters=10)
    x16 = torch.cat([x, x])
    f16_ms = cuda_ms(lambda: on_card.forward(x16), iters=10)
    print(f"[time] radon {TRAIN_BATCH}x{TRAIN_PATCH}² x 180 angles f32 (TF32 off): forward {f_ms:.3f} ms, "
          f"adjoint {a_ms:.3f} ms; forward at batch 16 (the constant half of the physics term) "
          f"{f16_ms:.3f} ms on {card}")
    if failures:
        raise SystemExit(f"radon checks failed: {failures}")


def _trainer_config(run_dir, **overrides):
    """The promoted recipe on synthetic data at full width."""
    from tmar_torch.train import config_path, load_config, resolve_variant

    base = {
        "data.dataset": "synthetic", "data.batch_size": TRAIN_BATCH, "data.num_workers": 2,
        "data.samples_per_epoch": 4 * TRAIN_BATCH, "optim.ema_decay": 0.999,
        "run_dir": run_dir, "run_name": "smoke", "num_epochs": 2, "val_every_n_epochs": 2,
        "log_every": 2,
    }
    base.update(overrides)
    cfg = load_config(config_path("train_syndeeplesion.yaml"), base)
    return resolve_variant(cfg, cfg.variant)


def _synthetic_batch(batch_size, device):
    import torch

    from tmar_torch.data import SyntheticMARDataset

    ds = SyntheticMARDataset(size=TRAIN_PATCH, length=batch_size, base_seed=7)
    samples = [ds[i] for i in range(batch_size)]
    return {k: torch.from_numpy(np.stack([s[k] for s in samples])[..., None]).to(device)
            for k in ("ct", "gt")}


def train_full(card):
    """Phase 9: the trainer takes ``full``-variant steps at full width.
    Returns the launch counts of the timed run."""
    import tempfile

    import torch

    from tmar_torch.train import Trainer
    from tmar_torch.train.trainer import build_val_dataset

    failures = []

    def check(cond, what):
        print(f"[check] {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(what)

    with tempfile.TemporaryDirectory(prefix="tmar_smoke_") as tmp:
        cfg = _trainer_config(tmp)
        check(cfg.variant == "full" and cfg.radon.enabled and cfg.loss.phys == 0.02
              and cfg.model.attn_backward == "pallas" and cfg.disc.fused_pairs
              and (cfg.model.embed_dim, tuple(cfg.model.depths), tuple(cfg.model.num_heads),
                   cfg.model.dec_depths) == (64, (6, 4, 4), (6, 4, 4), 6),
              "the promoted recipe: full variant, 180-angle sinogram term, full width")
        val_ds = build_val_dataset(cfg)
        val_ds.length = TRAIN_BATCH
        trainer = Trainer(cfg, val_dataset=val_ds)
        check(next(trainer.generator.parameters()).device.type == "cuda"
              and trainer.projector is not None and trainer.projector.num_angles == 180,
              "Trainer(cfg) is on the card and holds the 180-angle projector")
        t0 = time.perf_counter()
        trainer.fit(progress=False)
        wall = time.perf_counter() - t0
        steps = trainer.state.step
        print(f"[trainer] fit: 2 epochs x 4 steps of {TRAIN_BATCH}x{TRAIN_PATCH}² bf16 on the synthetic "
              f"dataset (2 loader threads), one validation of {TRAIN_BATCH} slices, 2 checkpoints, in "
              f"{wall:.1f} s; steps/s by epoch "
              + ", ".join(f"{h['steps_per_s']:.2f}" for h in trainer.val_history))
        for h in trainer.history:
            print("[trainer] step {step}: ".format(**h) + " ".join(
                f"{k} {v:.5f}" for k, v in h.items() if k not in ("step", "epoch", "iter")))
        want = {"loss_d", "loss_g", "g_adv", "g_fm", "g_rec", "g_edge", "g_phys", "g_metal"}
        check(steps == 8, "the state counts 8 steps")
        check(all(want <= set(h) for h in trainer.history), "every metric is logged, g_phys included")
        check(all(np.isfinite(v) for h in trainer.history + trainer.val_history for v in h.values()),
              "every logged metric and every validation metric is finite")
        check(all(h["g_phys"] > 0 for h in trainer.history), "g_phys is positive on synthetic slices")
        last = trainer.val_history[-1]
        print(f"[trainer] validation with the EMA weights: psnr {last['val_psnr']:.3f} dB, ssim "
              f"{last['val_ssim']:.4f}, best_psnr {trainer.best_psnr:.3f}")
        check(np.isfinite(trainer.best_psnr), "validation set best_psnr")
        ckpts = sorted(os.listdir(os.path.join(trainer.run_dir, "checkpoints")))
        check(ckpts == ["best", "step_0000000004", "step_0000000008"], f"checkpoints written: {ckpts}")
        for sub in ("logs/training_history.csv", "logs/validation_history.csv", "logs/summary.json",
                    "config.json", "tb"):
            check(os.path.exists(os.path.join(trainer.run_dir, sub)), f"run dir has {sub}")

        fresh = Trainer(cfg)
        check(fresh.resume() and fresh.state.step == 8 and fresh.start_epoch == 2
              and fresh.best_psnr == trainer.best_psnr, "a fresh trainer resumes the latest checkpoint")
        same = all(torch.equal(a, b) for a, b in zip(
            list(trainer.generator.state_dict().values()) + list(trainer.discriminator.state_dict().values())
            + list(trainer.state.g_ema.values()),
            list(fresh.generator.state_dict().values()) + list(fresh.discriminator.state_dict().values())
            + list(fresh.state.g_ema.values())))
        moments = all(
            torch.equal(trainer.g_opt.state[p][k], fresh.g_opt.state[q][k])
            for p, q in zip(trainer.generator.parameters(), fresh.generator.parameters())
            for k in ("exp_avg", "exp_avg_sq", "step"))
        check(same, "resumed parameters, buffers and EMA are bit-identical")
        check(moments, "resumed Adam moments and step counts are bit-identical")
        del fresh
        torch.cuda.empty_cache()

        # the step alone, on one fixed batch already on the card
        batch = _synthetic_batch(TRAIN_BATCH, "cuda")
        counters = _train_counters()
        warmup, timed = 3, 20
        for f, attr in counters.values():
            setattr(f, attr, 0)
        history, times = [], []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(warmup + timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.state, metrics = trainer.train_step(trainer.state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            history.append({k: float(v) for k, v in metrics.items()})
        launches = {name: getattr(f, attr) for name, (f, attr) in counters.items()}
        n = warmup + timed
        per_step = {k: v / n for k, v in launches.items()}
        print("[train full] launches per step: " + ", ".join(f"{k} {v:g}" for k, v in per_step.items())
              + f" (totals over {n} steps: {launches})")
        check([per_step[k] for k in counters] == [20, 20, 20, 20, 20, 20, 0],
              "per full step 20 launches each of K3, K4, K5, K6, K1 and K7 (none at N = 4: the "
              "attention kernels run once per block), none of the whole-block kernel")
        check(all(np.isfinite(v) for h in history for v in h.values()) and all(want <= set(h) for h in history),
              f"every metric finite at each of the {n} steps, g_phys included")
        check(history[-1]["g_rec"] < history[0]["g_rec"],
              f"g_rec falls on the fixed batch: {history[0]['g_rec']:.5f} -> {history[-1]['g_rec']:.5f}")
        print(f"[train full] g_phys by step: " + " ".join(f"{h['g_phys']:.4f}" for h in history))
        med = statistics.median(times[warmup:])
        print(f"[time] train step (full) {TRAIN_BATCH}x{TRAIN_PATCH}² bf16 (full variant: 180-angle "
              f"sinogram term, n-gram context as one forward and one backward kernel, batch on the "
              f"card): median {med * 1e3:.2f} ms of {timed} steps (min {min(times[warmup:]) * 1e3:.2f}, "
              f"max {max(times[warmup:]) * 1e3:.2f}), {1 / med:.3f} steps/s, {TRAIN_BATCH / med:.1f} "
              f"patches/s on {card}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        prof = profile_request(lambda: trainer.train_step(trainer.state, batch), card,
                               label=f"train step (full) {TRAIN_BATCH}x{TRAIN_PATCH}² bf16")
        check(prof is not None and prof[1] <= FULL_STEP_MAX_KERNELS,
              f"the full step's kernels and copies ({prof and prof[1]}) no more than "
              f"{FULL_STEP_MAX_KERNELS}")
        del trainer
        torch.cuda.empty_cache()

        # one float32 full step on the card against the same step on the CPU
        cfg32 = _trainer_config(tmp, **{"bf16": False, "data.batch_size": 1, "run_name": "f32"})
        on_cpu, on_card = Trainer(cfg32, device="cpu"), Trainer(cfg32)
        batch = _synthetic_batch(1, "cpu")
        _, cpu_m = on_cpu.train_step(on_cpu.state, batch)
        _, gpu_m = on_card.train_step(on_card.state, batch)
        compare_step(on_cpu.state, on_card.state, cpu_m, gpu_m, "f32 full step", check)
        check("g_phys" in gpu_m and float(gpu_m["g_phys"]) > 0, "the f32 full step has a sinogram term")
    if failures:
        raise SystemExit(f"full training checks failed: {failures}")
    return launches


# ---- phases 10-13: the token kernel, the attention kernel names, the block
# forms and the test entry point ---------------------------------------------
# (label, stage, images, window grid): the token form's 8x512² stages 1 and
# 2, and an odd grid at stage 3's width
TOKEN_CASES = (("stage1", 1, 8, 64, 64), ("stage2", 2, 8, 32, 32), ("3x13x13", 3, 3, 13, 13))
# block form -> (the JAX package's environment, NGswin keywords, kernels that
# run 20 times per forward, kernels that must not run)
FORMS = {
    "map": ({}, {}, ("ngram_context", "nstb_map"),
            ("nstb_tokens", "window_attention_fwd", "residual_ffn_fwd")),
    "tokens": ({"TMAR_NSTB_MAP": "0"}, {"nstb_map": False}, ("ngram_context", "nstb_tokens"),
               ("nstb_map", "window_attention_fwd", "residual_ffn_fwd")),
    "unfused": ({"TMAR_NSTB_FUSED": "0"}, {"nstb_fused": False},
                ("ngram_context", "window_attention_fwd", "residual_ffn_fwd"),
                ("nstb_map", "nstb_tokens")),
}


# the line of the TPU kernel each attention name selects
IMPL_LINES = {"batched": 1143, "batched_hm": 1143, "blockdiag": 1175, "blockdiag_mxnorm": 1175,
              "diag": 1241, "packed": 813}


def _serving_counters():
    from tmar_torch.ops import cuda_attention, cuda_ffn, cuda_ngram, cuda_nstb

    return {
        "ngram_context": cuda_ngram.fused_ngram_context,
        "nstb_map": cuda_nstb.fused_nstb_map,
        "nstb_tokens": cuda_nstb.fused_nstb,
        "window_attention_fwd": cuda_attention.fused_window_attention,
        "residual_ffn_fwd": cuda_ffn.fused_residual_ffn,
    }


def _reset_serving_counters():
    from tmar_torch.ops.cuda_attention import IMPLS, fused_window_attention

    for f in _serving_counters().values():
        f.launches = 0
    fused_window_attention.launches_by_impl = dict.fromkeys(IMPLS, 0)


def _read_serving_counters():
    from tmar_torch.ops.cuda_attention import fused_window_attention

    got = {k: f.launches for k, f in _serving_counters().items()}
    return got, dict(fused_window_attention.launches_by_impl)


def check_token_kernel(model, dev, card):
    """Phase 10: K8 against its plain version on the card, then timed beside
    K2 on the same block.  Returns its record for the JSON line (without
    launches)."""
    import torch

    from tmar_torch.ops import cuda_nstb

    gen = torch.Generator(device=dev).manual_seed(3)
    failures = []

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    errs = {"float32": 0.0, "bfloat16": 0.0, "bf16_mean": 0.0, "bf16_vs_f32_plain": 0.0}
    for name, stage, B, wh, ww in TOKEN_CASES:
        for blk in getattr(model, f"encoder_layer{stage}").blocks[:2]:
            args, shift = blk.kernel_args(), blk.shift_size
            x = randn(B * wh * ww, 64, 64)
            cq = randn(B * wh * ww, 4, 64, scale=0.5)
            for dtype in (torch.float32, torch.bfloat16):
                xx, cc = x.to(dtype), cq.to(dtype)
                got = cuda_nstb.fused_nstb(xx, cc, *args, shift=shift, grid=(wh, ww))
                ok, line = hold_nstb(got, lambda xi, ci, a: cuda_nstb.nstb_tokens_math(
                    xi, ci, *a[:-2], num_heads=a[-2], window_size=a[-1], shift=shift,
                    grid=(wh, ww)), xx, cc, args, errs)
                print(f"[kernel] nstb_tokens {name} x={list(xx.shape)} grid={B}x{wh}x{ww} "
                      f"heads={args[-2]} shift={shift} Q=4 {line}")
                if not ok:
                    failures.append(f"nstb_tokens {name} shift={shift} {dtype}")
                del got
            del x, cq
            torch.cuda.empty_cache()
    for stage in (1, 2):  # the saturated logit scale, as for K2
        args = list(getattr(model, f"encoder_layer{stage}").blocks[1].kernel_args())
        args[2] = torch.full_like(args[2], 10.0)
        x, cq = randn(2 * 64, 64, 64), randn(2 * 64, 4, 64, scale=0.5)
        for dtype in (torch.float32, torch.bfloat16):
            xx, cc = x.to(dtype), cq.to(dtype)
            got = cuda_nstb.fused_nstb(xx, cc, *args, shift=4, grid=(8, 8))
            ok, line = hold_nstb(got, lambda xi, ci, a: cuda_nstb.nstb_tokens_math(
                xi, ci, *a[:-2], num_heads=a[-2], window_size=a[-1], shift=4, grid=(8, 8)),
                xx, cc, args, errs)
            print(f"[kernel] nstb_tokens saturated logit scale x={list(xx.shape)} grid=2x8x8 "
                  f"heads={args[-2]} shift=4 Q=4 {line}")
            if not ok:
                failures.append(f"nstb_tokens saturated logit scale stage {stage} {dtype}")
    blk = model.encoder_layer1.blocks[1]  # stage 1, shift 4: the masked block
    args = blk.kernel_args()
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = randn(32768, 64, 64).to(dtype)
        cq = randn(32768, 4, 64, scale=0.5).to(dtype)
        xmap = randn(8, 512, 512, 64).to(dtype)
        ops, out, ints = cuda_nstb._token_operands(x, cq, *args, 4, (64, 64))
        ops2, out2, ints2 = cuda_nstb._kernel_operands(xmap, cq, *args, shift=4)
        k8 = lambda: cuda_nstb._launch_tokens(ops, out, ints, 1e-5)  # noqa: E731
        k2 = lambda: cuda_nstb._launch(ops2, out2, ints2, 1e-5)  # noqa: E731
        # in turns on one card: K2, K8, K8, K2
        t2a, t8a, t8b, t2b = (cuda_ms(f, iters=5, warmup=1) for f in (k2, k8, k8, k2))
        k_ms, k2_ms = (t8a + t8b) / 2, (t2a + t2b) / 2
        p_ms = cuda_ms(lambda: cuda_nstb.nstb_tokens_math(
            x, cq, *args[:-2], num_heads=args[-2], window_size=args[-1], shift=4, grid=(64, 64)),
            iters=2, warmup=1)
        dn = str(dtype).split(".")[1]
        flops, nbytes = nstb_work(8, 512, 512, 6, 4, x.element_size())
        b_ms, b_by = bound_ms(flops, nbytes, dn)
        times[dn] = (k_ms, p_ms, b_ms, b_by, k2_ms)
        print(f"[time] nstb_tokens x=[32768, 64, 64] grid 8x64x64 heads=6 shift=4 {dn}: kernel "
              f"{k_ms:.4f} ms ({t8a:.4f}, {t8b:.4f}), plain {p_ms:.4f} ms, K2 nstb_map on the same "
              f"block {k2_ms:.4f} ms ({t2a:.4f}, {t2b:.4f}), bound {b_ms:.5f} ms ({b_by}: "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e9:.3f} GB); library: none (no single PyTorch "
              f"call computes it) on {card}")
        del x, cq, xmap, ops, out, ops2, out2
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"token kernel checks failed: {failures}")
    k_ms, p_ms, b_ms, b_by, k2_ms = times["bfloat16"]
    return {
        "name": "nstb_tokens", "route": "cuda", "source": "tmar_torch/csrc/nstb_tokens.cu",
        "headers": NSTB_HEADERS,
        "replaces": "tmar/ops/pallas_nstb.py:334", "max_abs_err": errs["float32"],
        "max_abs_err_bf16": errs["bfloat16"], "mean_abs_err_bf16": errs["bf16_mean"],
        "max_abs_err_bf16_vs_f32_plain": errs["bf16_vs_f32_plain"], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_f32": times["float32"][0], "plain_ms_f32": times["float32"][1],
        "nstb_map_ms_same_block": k2_ms, "nstb_map_ms_same_block_f32": times["float32"][4],
        "shape": "x [32768, 64, 64] bf16 (8x512² stage 1), 6 heads, shift 4, Q 4",
    }


def check_attention_impls(dev, card):
    """Phase 11: each attention kernel name of the JAX package at the 8x128²
    step's stage-1 shape.  Returns, per name, the TPU kernel it selects and
    K3's errors, time and launches under it, for K3's record."""
    import torch

    from tmar_torch.ops.attention import window_attention_math
    from tmar_torch.ops.cuda_attention import IMPLS, fused_window_attention, window_attention_kernel_math
    from tmar_torch.ops.window import shift_mask_components

    label, nwin, N, D, nh, hd, grid = ATTN_CASES[1]
    gen = torch.Generator(device=dev).manual_seed(4)
    A = nh * hd

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    params = [randn(D, 3 * A, scale=0.1), randn(3 * A, scale=0.1),
              torch.rand(nh, 1, 1, generator=gen, device=dev) * 1.8 + 0.5,
              randn(nh, N, N, scale=0.2), randn(A, D, scale=0.1), randn(D, scale=0.1)]
    x = randn(nwin, N, D)
    mc = (*shift_mask_components(8, 4), *grid)
    f = fused_window_attention
    failures, errs, outs = [], {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        xx = x.to(dtype)
        # at bf16 the rounding-matched plain version, with the float32 one's
        # distance printed beside it
        ref = window_attention_kernel_math(xx, *params, nh, mask_components=mc)
        ref32 = window_attention_math(xx.float(), *params, nh, mask_components=mc)
        for name in sorted(IMPLS):
            by_impl, total, bwd = dict(f.launches_by_impl), f.launches, f.backward_launches
            with torch.no_grad():
                out = f(xx, *params, nh, mask_components=mc, impl=name)
            torch.cuda.synchronize()
            moved = {k: f.launches_by_impl[k] - by_impl[k] for k in by_impl}
            err, tol = err_and_tol(out, ref, dtype)
            mean = float((out.float() - ref.float()).abs().mean())
            errs[(name, dn)] = err
            same = name == "batched" or torch.equal(out, outs[("batched", dn)])
            ok = (moved == {k: int(k == name) for k in by_impl} and f.launches == total + 1
                  and f.backward_launches == bwd and err <= tol and same)
            outs[(name, dn)] = out
            far = (f"; not gated: against the float32 plain version max "
                   f"{float((out.float() - ref32).abs().max()):.3e}, mean "
                   f"{float((out.float() - ref32).abs().mean()):.2e}" if dtype == torch.bfloat16 else "")
            print(f"[impl] {name} -> K3 x=[{nwin}, {N}, {D}] heads={nh} mask on {dn}: its counter "
                  f"+{moved[name]}, the others +{sum(moved.values()) - moved[name]}; max_abs_err "
                  f"{err:.3e} tol {tol:.3e}, mean {mean:.2e}{far}; bits equal to 'batched': {same} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"impl {name} {dn}")
        del ref, ref32
    outs.clear()
    xx = x.to(torch.bfloat16)
    with torch.no_grad():
        p_ms = cuda_ms(lambda: window_attention_kernel_math(xx, *params, nh, mask_components=mc))
        t = {name: cuda_ms(lambda: f(xx, *params, nh, mask_components=mc, impl=name))
             for name in sorted(IMPLS)}
    b_ms, b_by = bound_ms(*attention_work(nwin, N, D, nh, hd, 2, False), "bfloat16")
    print(f"[time] window_attention_fwd by name, x=[{nwin}, {N}, {D}] heads={nh} bf16: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
          + f"; plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}) on {card}")
    if failures:
        raise SystemExit(f"attention kernel name checks failed: {failures}")
    return {
        name: {
            "replaces": f"tmar/ops/pallas_attention.py:{IMPL_LINES[name]}", "jax_kernel": IMPLS[name],
            "max_abs_err": errs[(name, "float32")], "max_abs_err_bf16": errs[(name, "bfloat16")],
            "ms": t[name], "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "launches_per_call": 1, "shape": f"x [{nwin}, {N}, {D}] bf16, {nh} heads, shift mask on",
        }
        for name in sorted(IMPLS)
    }


@contextlib.contextmanager
def _capture_unfused_kernel_inputs():
    """A context in which the unfused block's K3 and K5 calls are kept, the
    first of each window count and head count (K3, shifted blocks: the mask
    is on) and of each row count (K5), and passed on unchanged."""
    from unittest import mock

    from tmar_torch.nn import blocks, window_attention

    attn, ffn = window_attention.fused_window_attention, blocks.fused_residual_ffn
    kept = {"attention": {}, "ffn": {}}

    def keep_attn(x, *args, mask_components=None, **kw):
        if mask_components is not None:
            kept["attention"].setdefault((x.shape[0], args[-1]), (x, args, mask_components))
        return attn(x, *args, mask_components=mask_components, **kw)

    def keep_ffn(x, *args, **kw):
        kept["ffn"].setdefault(x.shape[0], (x, args, kw))
        return ffn(x, *args, **kw)

    with mock.patch.object(window_attention, "fused_window_attention", keep_attn), \
            mock.patch.object(blocks, "fused_residual_ffn", keep_ffn):
        yield kept


def check_unfused_kernels(kept, card):
    """K3 and K5 on the inputs the unfused form gave them in its 8x512²
    request, at the served bfloat16 and cast to float32, against their plain
    versions; then each timed at the stage-1 shape.  Returns {kernel: the
    cases' record}."""
    import torch

    from tmar_torch.ops.attention import window_attention_math
    from tmar_torch.ops.cuda_attention import fused_window_attention, window_attention_kernel_math
    from tmar_torch.ops.cuda_ffn import ffn_kernel_math, fused_residual_ffn
    from tmar_torch.ops.ffn import ffn_math

    # (kernel, label, kernel call, plain version in float32 (bf16 inputs and
    # matrices rounded), rounding-matched plain version at bf16, the
    # captured input, the work, the launch alone's ms or None)
    failures, cases = [], {"window_attention_fwd": [], "residual_ffn_fwd": []}
    runs = [("window_attention_fwd", f"x={list(x.shape)} heads={args[-1]} mask on",
             lambda xx, args=args, mc=mc: fused_window_attention(xx, *args, mask_components=mc),
             lambda xx, args=args, mc=mc: window_attention_math(
                 xx, *[t.to(xx.dtype) if i in (0, 1, 4, 5) else t for i, t in enumerate(args)],
                 mask_components=mc),
             lambda xx, args=args, mc=mc: window_attention_kernel_math(xx, *args, mask_components=mc),
             x,
             lambda size, x=x, args=args: attention_work(
                 x.shape[0], x.shape[1], x.shape[2], args[-1], args[0].shape[1] // 3 // args[-1],
                 size, False), None)
            for (x, args, mc) in sorted(kept["attention"].values(), key=lambda c: -c[0].shape[0])]
    runs += [("residual_ffn_fwd", f"x={list(x.shape)}",
              lambda xx, args=args, kw=kw: fused_residual_ffn(xx, args[0].to(xx.dtype), *args[1:], **kw),
              lambda xx, args=args, kw=kw: ffn_math(xx, args[0].to(xx.dtype), *args[1:], **kw),
              lambda xx, args=args, kw=kw: ffn_kernel_math(xx, *args, **kw),
              x, lambda size, x=x: ffn_work(x.shape[0], size, False),
              lambda xx, args=args, kw=kw: ffn_launch_ms(xx, args[0], args[1:], None, iters=5, **kw)[0])
             for (x, args, kw) in sorted(kept["ffn"].values(), key=lambda c: -c[0].shape[0])]
    for kernel, label, fused, plain, matched, x, work, alone in runs:
        ref32 = plain(x.float())
        case = {"shape": label}
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            got = fused(x.to(dtype))
            ref = matched(x.to(dtype)) if matched is not None and dtype == torch.bfloat16 else ref32
            torch.cuda.synchronize()
            err, tol = err_and_tol(got, ref, dtype)
            ok = err <= tol and bool(torch.isfinite(got).all())
            case["max_abs_err" if dtype == torch.float32 else "max_abs_err_bf16"] = err
            line = f"max_abs_err {err:.3e} tol {tol:.3e}"
            if ref is not ref32:
                mean = float((got.float() - ref.float()).abs().mean())
                d32 = (got.float() - ref32).abs()
                case["mean_abs_err_bf16"] = mean
                line += (f", mean {mean:.2e} (against the rounding-matched plain version; not gated: "
                         f"against the float32 plain version max {float(d32.max()):.3e}, mean "
                         f"{float(d32.mean()):.2e})")
                del d32
            print(f"[kernel] {kernel} on the unfused form's 8x512² request input {label} {dn}: "
                  f"{line} {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{kernel} {label} {dn}")
            del got, ref
        del ref32
        if not cases[kernel]:  # the largest shape: the stage-1 block, both bodies
            for dtype in (torch.bfloat16, torch.float32):
                xb = x.to(dtype)
                pb = matched if matched is not None and dtype == torch.bfloat16 else plain
                k_ms = cuda_ms(lambda: fused(xb), iters=5, warmup=1)
                p_ms = cuda_ms(lambda: pb(xb), iters=2, warmup=1)
                dn = str(dtype).split(".")[1]
                b_ms, b_by = bound_ms(*work(xb.element_size()), dn)
                sfx = "" if dtype == torch.bfloat16 else "_f32"
                case.update({f"ms{sfx}": k_ms, f"plain_ms{sfx}": p_ms, f"bound_ms{sfx}": b_ms,
                             f"bound_by{sfx}": b_by})
                a_ms = None if alone is None else alone(xb)
                if a_ms is not None:
                    case[f"ms_launch_alone{sfx}"] = a_ms
                print(f"[time] {kernel} {label} {dn} (the unfused form's stage 1): kernel "
                      f"{k_ms:.4f} ms{'' if a_ms is None else f' ({a_ms:.4f} ms the launch alone)'}, "
                      f"plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); library: none on {card}")
                del xb
        cases[kernel].append(case)
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"unfused serving kernel checks failed: {failures}")
    return cases


def serve_forms(sd, card, req512, map_out, map_med):
    """Phase 12: the token and unfused block forms serve the flagship; K3
    and K5 are held on the inputs of the unfused form's request.  Returns
    each form's launch counts and K3's and K5's cases."""
    import torch

    from tmar_torch import NGswin, full_slice_eval, make_inference_fn

    failures = []

    def check(cond, what):
        print(f"[check] {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(what)

    small = req512[:1, :128, :128]
    map32 = NGswin(dtype=torch.float32)
    map32.load_state_dict(sd)
    y_map32 = make_inference_fn(map32)(small)
    del map32
    launches, cases = {}, {}
    for form in ("tokens", "unfused"):
        _, kw, runs, idle = FORMS[form]
        model = NGswin(dtype=torch.bfloat16, **kw)
        model.load_state_dict(sd)
        fwd = make_inference_fn(model)
        fwd(small)  # first call: lazy set-up
        with _capture_unfused_kernel_inputs() as kept:
            _reset_serving_counters()
            y = full_slice_eval(fwd, req512)
            got, by_impl = _read_serving_counters()
        launches[form] = got
        print(f"[serve {form}] full-slice 8x512² bf16: out {list(y.shape)} range [{y.min():.4f}, "
              f"{y.max():.4f}]; launches " + ", ".join(f"{k} {v}" for k, v in got.items())
              + f"; by attention name {({k: v for k, v in by_impl.items() if v})}")
        check(bool(np.isfinite(y).all()) and y.min() >= -1 and y.max() <= 1,
              f"{form} form: finite and in [-1, 1]")
        check(all(got[k] == 20 for k in runs) and all(got[k] == 0 for k in idle),
              f"{form} form: 20 launches per forward of {', '.join(runs)}; none of {', '.join(idle)}")
        diff = np.abs(y - map_out)
        print(f"[check] {form} form vs map form, bf16 on the card at 8x512²: max {diff.max():.3e} "
              f"(tol 0.1), mean {diff.mean():.3e} (tol 1e-2)")
        check(diff.max() <= 0.1 and diff.mean() <= 1e-2, f"{form} form vs map form at bf16")
        if form == "unfused":
            cases = check_unfused_kernels(kept, card)
        del kept
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            full_slice_eval(fwd, req512)
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        print(f"[time] full-slice 8x512² bf16 request, {form} form: median {med * 1e3:.1f} ms of "
              f"{[round(t * 1e3, 1) for t in times]}, {8 / med:.2f} slices/s (map form "
              f"{map_med * 1e3:.1f} ms, {8 / map_med:.2f} slices/s) on {card}")
        profile_request(lambda: full_slice_eval(fwd, req512), card,
                        label=f"full-slice 8x512² bf16 request, {form} form")
        del model, fwd, y
        model32 = NGswin(dtype=torch.float32, **kw)
        model32.load_state_dict(sd)
        d = float(np.abs(make_inference_fn(model32)(small) - y_map32).max())
        print(f"[check] {form} form vs map form, f32 on the card at 1x128²: max_abs_err {d:.3e} "
              f"tol 1e-4")
        check(d <= 1e-4, f"{form} form vs map form at f32")
        del model32
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"block form serving checks failed: {failures}")
    return launches, cases


def serve_entry_point(sd, card):
    """Phase 13: ``tmar_torch.cli.test`` in every block form, full-slice and
    tiled, in-process; then the device-side tiled eval against the host-side
    one.  Returns the launch counts of the first run of each form."""
    import tempfile
    from unittest import mock

    import torch

    from tmar_torch import NGswin, make_inference_fn, make_tiled_eval, tiled_eval
    from tmar_torch import cli
    from tmar_torch.data import SyntheticMARDataset
    from tmar_torch.eval.metrics import psnr

    failures = []

    def check(cond, what):
        print(f"[check] {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(what)

    n = 4
    ds = SyntheticMARDataset(size=416, length=32)  # the test set the CLI builds
    samples = [ds[i] for i in range(n)]
    input_psnr = float(np.mean([psnr(np.clip((s["ct"] + 1) / 2, 0, 1), (s["gt"] + 1) / 2)
                                for s in samples]))
    print(f"[test] corrupted input on the first {n} synthetic 416² slices: mean psnr "
          f"{input_psnr:.3f} dB")
    means = {}
    for form, (env, _, runs, idle) in FORMS.items():
        for tiled in (False, True):
            mode = "tiled" if tiled else "full_slice"
            with tempfile.TemporaryDirectory(prefix="tmar_test_") as out, \
                    mock.patch.dict(os.environ, env):
                argv = ["--checkpoint", CKPT, "--set", "data.dataset=synthetic",
                        "model.use_pallas_attention=true", "--max-samples", str(n), "--out", out]
                _reset_serving_counters()
                t0 = time.perf_counter()
                rc = cli.test(argv + (["--tiled"] if tiled else []))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got, _ = _read_serving_counters()
                path = os.path.join(out, "metrics.json")
                written = rc == 0 and os.path.isfile(path)
                summary = json.load(open(path))["summary"] if written else {}
            means[(form, mode)] = summary.get("psnr", float("nan"))
            print(f"[test] {form} form {mode}: rc {rc}, {summary} in {wall:.2f} s (synthesis and "
                  f"metrics on the host included); launches " + ", ".join(f"{k} {v}" for k, v in got.items()))
            check(written and summary.get("n") == n and summary.get("mode") == mode,
                  f"test entry point, {form} form, {mode}: metrics.json written for {n} slices")
            check(summary.get("psnr", 0) > input_psnr,
                  f"{form} form, {mode}: mean psnr {summary.get('psnr', 0):.3f} dB above the input's")
            check(all(got[k] == 20 * n for k in runs) and all(got[k] == 0 for k in idle),
                  f"{form} form, {mode}: one forward per slice (20 launches each of "
                  f"{', '.join(runs)}), none of {', '.join(idle)}")
    for mode in ("full_slice", "tiled"):
        vals = [means[(f, mode)] for f in FORMS]
        spread = max(vals) - min(vals)
        check(spread <= 0.05, f"{mode}: the three forms' mean psnr agree within 0.05 dB "
                              f"({', '.join(f'{v:.4f}' for v in vals)}; spread {spread:.4f})")

    model = NGswin(dtype=torch.float32)
    model.load_state_dict(sd)
    ct = samples[0]["ct"][None, ..., None]
    dev_out = make_tiled_eval(model)(ct)
    host_out = tiled_eval(make_inference_fn(model), ct, 64, 32)
    d = float(np.abs(dev_out - host_out).max())
    print(f"[check] make_tiled_eval (144 tiles in one forward, assembled on the card) vs the "
          f"host-side tiled_eval (3 forwards of 64), f32, one 416² slice: max_abs_err {d:.3e} tol 1e-4")
    check(d <= 1e-4, "device-side tiled eval vs host-side tiled eval")
    del model
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"test entry point checks failed: {failures}")


# ---- phases 14-16: the data layer, the shipped configs as written, and the
# n-gram context at n = 3 ------------------------------------------------------
TREE_SIZE = 416
SPINE_SLICES = 16
SYN_TRAIN_IMAGES, SYN_TEST_IMAGES = 2, 1
DATA_BATCH, PATCH = 32, 128  # the shipped training configs' batch and patch
PROFILE_STEPS = 8  # the spineweb steps profiled alone, without an epoch's end


def _has_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def check_native(card):
    """Phase 14a: the host library, built from ``tmar_torch/native`` and
    loaded, against its numpy versions on a 416² slice: bit for bit where the
    C++ and the numpy arithmetic agree, else at tests/test_native.py's
    tolerances; each timed beside its numpy version (host time)."""
    from tmar_torch.data import native

    failures = []
    t0 = time.perf_counter()
    ok = native.available()
    print(f"[data] native: host library {'built and loaded' if ok else 'NOT available'} from "
          f"{os.path.relpath(native.SOURCE, ROOT)} into "
          f"{os.path.relpath(native.library_path(), ROOT)} in {time.perf_counter() - t0:.2f} s "
          f"(g++ {' '.join(native.CXX_FLAGS)})")
    if not ok:
        raise SystemExit(f"the host library did not build: {native.build_error}")
    rng = np.random.default_rng(11)
    img = rng.uniform(-0.3, 1.3, (TREE_SIZE, TREE_SIZE)).astype(np.float32)
    hu = rng.uniform(-2000, 4000, (TREE_SIZE, TREE_SIZE)).astype(np.float32)
    mask = (img > 1.0).astype(np.uint8)
    mask[TREE_SIZE // 4, :] = 1  # a fully masked row: the column pass
    batch = rng.standard_normal((DATA_BATCH, 3, TREE_SIZE, TREE_SIZE)).astype(np.float32)
    pos = rng.integers(0, TREE_SIZE - PATCH + 1, (2, DATA_BATCH))
    flips = rng.random((2, DATA_BATCH)) < 0.5
    cases = (  # (name, args, atol, rtol): zero where the arithmetic agrees
        ("normalize01_pm1", (img,), 0.0, 1e-6),
        ("hu_window", (hu, -1000.0, 2000.0), 1e-5, 0.0),
        ("assemble_batch", (batch, PATCH, pos[0], pos[1], flips[0], flips[1]), 0.0, 0.0),
        ("metal_mask_dilate", (img, 0.6, 5), 0.0, 0.0),
        ("li_interpolate", (img, mask), 1e-6, 0.0),
    )
    for name, args, atol, rtol in cases:
        lib_fn, np_fn = getattr(native, name), getattr(native, f"{name}_np")
        if name == "assemble_batch":  # the numpy version takes the wrapper's arrays
            np_args = (args[0], args[1], *(np.asarray(a, np.int32) for a in args[2:4]),
                       *(np.asarray(a, np.uint8) for a in args[4:]))
        elif name == "li_interpolate":
            np_args = (args[0], (args[1] > 0).astype(np.uint8))
        else:
            np_args = args
        got, ref = lib_fn(*args), np_fn(*np_args)
        t_lib = min(_host_ms(lambda: lib_fn(*args)) for _ in range(3))
        t_np = min(_host_ms(lambda: np_fn(*np_args)) for _ in range(3))
        err = float(np.abs(got.astype(np.float64) - ref).max())
        good = got.shape == ref.shape and err <= atol + rtol * float(np.abs(ref).max())
        exact = "bit for bit" if atol == rtol == 0.0 else f"atol {atol:g} rtol {rtol:g}"
        shape = (f"[{DATA_BATCH}, 3, {TREE_SIZE}, {TREE_SIZE}] -> {PATCH}²" if name == "assemble_batch"
                 else f"{TREE_SIZE}²")
        print(f"[data] native {name} on {shape}:"
              f" max |lib - numpy| {err:.3e} ({exact}) {'ok' if good else 'FAIL'}; library "
              f"{t_lib:.3f} ms, numpy {t_np:.3f} ms (host time, {card})")
        if not good:
            failures.append(name)
    if failures:
        raise SystemExit(f"host library checks failed: {failures}")


def _host_ms(fn):
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def write_trees(root, syndeeplesion):
    """The on-disk layouts the real loaders read, written from the port's
    synthetic generator as tools/make_ref_layout.py writes them (that tool
    imports the JAX package): the same file names, seed 0, a 416² phantom per
    image and one artifact draw per (image, mask); SpineWeb as HU npy pairs
    (``a * 3000 - 1000``), SynDeepLesion as one HDF5 file per (image, mask)
    with 79 masks per train image and 10 per test image.  Returns {layout:
    (root, seconds)}."""
    from tmar_torch.data.synthetic import SyntheticMARDataset, apply_metal_artifacts

    phantom = SyntheticMARDataset(size=TREE_SIZE, length=1, base_seed=0)._phantom

    def gt01(split, i):
        return phantom(np.random.default_rng((0, split, i)))

    def pair(gt, split, i, k):
        return apply_metal_artifacts(gt, np.random.default_rng((0, split, i, 1000 + k)))

    out = {}
    t0 = time.perf_counter()
    spine = os.path.join(root, "spineweb")
    for sub in ("artifact", "clean"):
        os.makedirs(os.path.join(spine, sub))
    for i in range(SPINE_SLICES):
        gt = gt01(2, i)
        ma, _ = pair(gt, 2, i, 0)
        np.save(os.path.join(spine, "artifact", f"case{i:04d}.npy"), (ma * 3000.0 - 1000.0).astype(np.float32))
        np.save(os.path.join(spine, "clean", f"case{i:04d}.npy"), (gt * 3000.0 - 1000.0).astype(np.float32))
    out["spineweb"] = (spine, time.perf_counter() - t0)
    if not syndeeplesion:
        return out
    import h5py

    def h5(path, arrays):
        with h5py.File(path, "w") as f:
            for k, v in arrays.items():
                f.create_dataset(k, data=np.asarray(v, np.float32))

    t0 = time.perf_counter()
    syn = os.path.join(root, "syndeeplesion")
    for split, n_img, n_masks, sub in ((0, SYN_TRAIN_IMAGES, 79, "train_640geo"),
                                       (1, SYN_TEST_IMAGES, 10, "test_640geo")):
        for i in range(n_img):
            d = os.path.join(syn, sub, f"P{i // 4:03d}", f"S{i:04d}")
            os.makedirs(d)
            gt = gt01(split, i)
            h5(os.path.join(d, "gt.h5"), {"image": gt})
            for k in range(n_masks):
                ma, li = pair(gt, split, i, k)
                h5(os.path.join(d, f"{k}.h5"), {"ma_CT": ma, "LI_CT": li})
    with open(os.path.join(syn, "test_640geo_dir.txt"), "w") as f:
        f.writelines(f"P{i // 4:03d}/S{i:04d}/gt.h5\n" for i in range(SYN_TEST_IMAGES))
    out["syndeeplesion"] = (syn, time.perf_counter() - t0)
    return out


def _data_overrides(layout, path):
    if layout == "spineweb":
        return {"data.dataset": "spineweb",
                "data.spineweb_artifact": os.path.join(path, "artifact"),
                "data.spineweb_clean": os.path.join(path, "clean")}
    return {"data.root": path}


def loader_rate(cfg, card, batches=64):
    """How fast the trainer's Loader feeds the card: ``batches`` batches of
    the training set through it (its threads, pinned memory, the copy onto
    the card), timed from ``iter()`` to the last batch on the card, so that
    no batch is built before the clock starts and the prefetch queue (the
    threads plus ``prefetch`` batches) is a small part of the run; and one
    thread's ``dataset[i]`` alone over one batch of indices.  Returns the
    loader's samples/s."""
    import copy

    import torch

    from tmar_torch.data import Loader
    from tmar_torch.train.trainer import build_dataset

    cfg = copy.deepcopy(cfg)
    d = cfg.data
    d.samples_per_epoch = batches * d.batch_size
    dataset = build_dataset(cfg)
    t0 = time.perf_counter()
    for i in range(d.batch_size):
        dataset[i]
    per_sample = (time.perf_counter() - t0) / d.batch_size
    loader = Loader(dataset, batch_size=d.batch_size, num_workers=d.num_workers, seed=d.seed,
                    device="cuda")
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rate = n * d.batch_size / wall
    print(f"[data] loader {d.dataset}: {rate:.1f} samples/s ({n} batches of {d.batch_size} "
          f"{d.patch_size}² patches onto the card in {wall:.3f} s from iter(), {d.num_workers} "
          f"threads, prefetch {loader.prefetch}); one thread's dataset[i] alone "
          f"{per_sample * 1e3:.3f} ms a sample ({1 / per_sample:.1f} samples/s); host and card {card}")
    return rate


def fit_phase(label, cfg, card, val_dataset, check, profile=False):
    """``Trainer(cfg).fit()`` on the card with the launch counts reset just
    before and read just after.  Returns the trainer and the counts."""
    import torch

    from tmar_torch.train import Trainer

    trainer = Trainer(cfg, val_dataset=val_dataset)
    counters = _train_counters()
    for f, attr in counters.values():
        setattr(f, attr, 0)
    t0 = time.perf_counter()
    trainer.fit(progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(f, attr) for name, (f, attr) in counters.items()}
    steps = int(trainer.state.step)
    epoch = trainer.val_history[-1]
    d = cfg.data
    print(f"[trainer] {label}: fit {steps} steps of {d.batch_size}x{d.patch_size}² "
          f"{'bf16' if cfg.bf16 else 'f32'} ({cfg.variant} variant, {d.num_workers} loader threads) "
          f"in {wall:.2f} s with{'' if val_dataset is not None else 'out'} validation: "
          f"{epoch['steps_per_s']:.3f} steps/s, {epoch['steps_per_s'] * d.batch_size:.1f} patches/s "
          f"(first steps included) on {card}")
    want = d.samples_per_epoch // d.batch_size
    check(steps == want, f"{label}: the state counts {want} steps")
    check(all(np.isfinite(v) for h in trainer.history + trainer.val_history for v in h.values()),
          f"{label}: every logged training and validation metric is finite")
    val_batches = 0
    if val_dataset is not None:
        val_batches = min(16, -(-len(val_dataset) // d.batch_size))
        print(f"[trainer] {label}: validation on {len(val_dataset)} full slices "
              f"({type(val_dataset).__name__}, EMA weights): psnr {epoch['val_psnr']:.3f} dB, "
              f"ssim {epoch['val_ssim']:.4f}")
        check(np.isfinite(epoch["val_psnr"]), f"{label}: validation psnr is finite")
    per_step = {k: v / max(steps, 1) for k, v in launches.items()}
    print(f"[trainer] {label}: launches per step " + ", ".join(f"{k} {v:g}" for k, v in per_step.items())
          + f" (totals {launches}; the forward kernels also run once per block in each of "
          f"{val_batches} validation batch(es))")
    fwd = ("window_attention_fwd", "residual_ffn_fwd", "ngram_context")
    bwd = ("window_attention_bwd", "residual_ffn_bwd", "ngram_context_bwd")
    check(all(launches[k] == 20 * steps for k in bwd)
          and all(launches[k] == 20 * (steps + val_batches) for k in fwd)
          and launches["nstb_map"] == 0,
          f"{label}: 20 launches per step of each of K3, K4, K5, K6, K1 and K7 (and 20 of K1, "
          f"K3, K5 per validation batch), none of K2")
    if profile:
        # warm, under the profiler: the steps alone, fed by the Loader as fit
        # feeds them; then one more epoch as fit runs it, whose end (the
        # validation, the sample grid, the checkpoint, the logs) a short
        # epoch's steps do not outweigh
        import copy

        from tmar_torch.data import Loader
        from tmar_torch.train.trainer import build_dataset

        steps_cfg = copy.deepcopy(cfg)
        steps_cfg.data.samples_per_epoch = PROFILE_STEPS * d.batch_size
        loader = Loader(build_dataset(steps_cfg), batch_size=d.batch_size,
                        num_workers=d.num_workers, seed=d.seed, device=trainer.device)

        def steps():
            for batch in loader:
                trainer.state, _ = trainer.train_step(trainer.state, batch)

        profile_request(steps, card, label=f"{label}: {PROFILE_STEPS} train steps fed by the Loader, "
                                           f"no validation or checkpoint")
        trainer.start_epoch = 1
        profile_request(lambda: trainer.fit(num_epochs=2, progress=False), card,
                        label=f"Trainer.fit {label}, one epoch of {want} steps with its validation, "
                              f"sample grid, checkpoint and logs")
    return trainer, launches


def data_phases(card):
    """Phases 14-15: the host library; the port's three shipped configs run
    as written, on small trees written here, with only the data paths, the
    epoch length and the run directory set: ``Trainer.fit`` on
    finetune_spineweb.yaml (and train_syndeeplesion.yaml where h5py
    imports), train_syndeeplesion.yaml on the shard cache of synthetic
    slices, and ``tmar_torch.cli.test`` on test_config.yaml with the
    flagship, full-slice and tiled.  Returns the launch counts of the
    spineweb fit."""
    import tempfile

    import torch

    from tmar_torch import cli
    from tmar_torch.eval.metrics import psnr
    from tmar_torch.train import config_path, load_config, resolve_variant
    from tmar_torch.train.trainer import build_dataset, build_val_dataset

    failures = []

    def check(cond, what):
        print(f"[check] {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(what)

    check_native(card)
    h5 = _has_h5py()
    if not h5:
        print("[skip] syndeeplesion: h5py is not installed on this machine")
    with tempfile.TemporaryDirectory(prefix="tmar_data_") as tmp:
        trees = write_trees(tmp, syndeeplesion=h5)
        for layout, (path, sec) in trees.items():
            print(f"[data] wrote the {layout} layout at {TREE_SIZE}² in {sec:.2f} s (host, {card})")

        def shipped(name, **over):
            cfg = load_config(config_path(name), {"run_dir": os.path.join(tmp, "runs"), **over})
            return resolve_variant(cfg, cfg.variant)

        # SpineWeb fine-tuning as written
        cfg = shipped("finetune_spineweb.yaml", **_data_overrides("spineweb", trees["spineweb"][0]),
                      **{"data.samples_per_epoch": 2 * DATA_BATCH, "num_epochs": 1,
                         "val_every_n_epochs": 1, "run_name": "spineweb"})
        check((cfg.data.batch_size, cfg.data.patch_size, cfg.optim.lr_g, cfg.variant, cfg.bf16,
               cfg.model.embed_dim, tuple(cfg.model.depths)) == (32, 128, 1e-5, "full", True, 64, (6, 4, 4)),
              "finetune_spineweb.yaml as written: batch 32, 128² patches, lr_g 1e-5, full, bf16, full width")
        loader_rate(cfg, card)
        trainer, spine_launches = fit_phase("spineweb", cfg, card, build_val_dataset(cfg), check,
                                            profile=True)
        del trainer
        torch.cuda.empty_cache()

        # the shard cache of synthetic slices
        cfg = shipped("train_syndeeplesion.yaml", **{
            "data.dataset": "synthetic_cache", "data.cache_slices": 16,
            "data.cache_dir": os.path.join(tmp, "synth_cache"),
            "data.samples_per_epoch": 3 * DATA_BATCH, "num_epochs": 1, "run_name": "cache"})
        t0 = time.perf_counter()
        build_dataset(cfg)
        print(f"[trainer] synthetic_cache: built the shard cache of {cfg.data.cache_slices} "
              f"{TREE_SIZE}² synthetic slices in {time.perf_counter() - t0:.2f} s (host, {card})")
        loader_rate(cfg, card)
        trainer, _ = fit_phase("synthetic_cache", cfg, card, None, check)
        del trainer
        torch.cuda.empty_cache()

        # SynDeepLesion training as written
        if h5:
            cfg = shipped("train_syndeeplesion.yaml",
                          **_data_overrides("syndeeplesion", trees["syndeeplesion"][0]),
                          **{"data.samples_per_epoch": 2 * DATA_BATCH, "num_epochs": 1,
                             "val_every_n_epochs": 1, "run_name": "syndeeplesion"})
            loader_rate(cfg, card)
            trainer, _ = fit_phase("syndeeplesion", cfg, card, build_val_dataset(cfg), check)
            del trainer
            torch.cuda.empty_cache()

        # the test entry point on the real layouts
        for layout, (path, _) in trees.items():
            sets = [f"{k}={v}" for k, v in _data_overrides(layout, path).items()]
            cfg = load_config(config_path("test_config.yaml"), _data_overrides(layout, path))
            ds = cli._build_test_dataset(cfg)
            input_psnr = float(np.mean([psnr(np.clip((ds[i]["ct"] + 1) / 2, 0, 1), (ds[i]["gt"] + 1) / 2)
                                        for i in range(len(ds))]))
            print(f"[test] {layout}: corrupted input on its {len(ds)} {TREE_SIZE}² test slices: mean "
                  f"psnr {input_psnr:.3f} dB")
            for tiled in (False, True):
                mode = "tiled" if tiled else "full_slice"
                out = os.path.join(tmp, f"test_{layout}_{mode}")
                argv = ["--config", config_path("test_config.yaml"), "--checkpoint", CKPT,
                        "--out", out, "--set", *sets] + (["--tiled"] if tiled else [])
                _reset_serving_counters()
                t0 = time.perf_counter()
                rc = cli.test(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got, _ = _read_serving_counters()
                path_json = os.path.join(out, "metrics.json")
                summary = json.load(open(path_json))["summary"] if rc == 0 and os.path.isfile(path_json) else {}
                n = summary.get("n", 0)
                print(f"[test] {layout} {mode}: rc {rc}, psnr {summary.get('psnr', float('nan')):.3f} dB, "
                      f"ssim {summary.get('ssim', float('nan')):.4f} over {n} slices in {wall:.2f} s "
                      f"(loading and metrics on the host included), flagship bf16 map form on {card}; "
                      f"launches " + ", ".join(f"{k} {v}" for k, v in got.items()))
                check(n == len(ds) and summary.get("mode") == mode,
                      f"test {layout} {mode}: metrics.json written for all {len(ds)} slices")
                check(summary.get("psnr", 0) > input_psnr,
                      f"test {layout} {mode}: psnr {summary.get('psnr', 0):.3f} dB above the input's "
                      f"{input_psnr:.3f}")
                check(got["ngram_context"] == got["nstb_map"] == 20 * n,
                      f"test {layout} {mode}: 20 launches each of K1 and K2 per slice")
    if failures:
        raise SystemExit(f"data phase checks failed: {failures}")
    return spine_launches


def train_ngram3(card):
    """Phase 16: the composition recipe with ``ngrams=(3, 3, 3, 3)`` at full
    width, 8x128² bf16: the n-gram context through K3/K4 at N = 9 (phase 5
    held them there and at N = 1 against their plain versions), whatever
    ``ngram_fused`` says; 3 steps on one fixed batch."""
    import torch

    from tmar_torch.ops.cuda_attention import fused_window_attention

    failures = []

    def check(cond, what):
        print(f"[check] {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(what)

    state, step, batch = _gan(torch.bfloat16, "cuda", seed=0, batch_size=TRAIN_BATCH,
                              ngrams=(3, 3, 3, 3), ngram_fused=True)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}
    ctx = state.generator.encoder_layer1.blocks[0].ngram_window_partition.ngram_context
    check(ctx.ngram == 3 and ctx.ngram_fused and ctx.ngram_attn.window_size == (3, 3),
          "n = 3 with ngram_fused=True: a 3x3 n-gram attention (its table 25 rows)")
    counters = _train_counters()
    for f, attr in counters.values():
        setattr(f, attr, 0)
    fused_window_attention.launches_by_n.clear()
    fused_window_attention.backward_launches_by_n.clear()
    history, times = [], []
    steps = 3
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        history.append({k: float(v) for k, v in metrics.items()})
    launches = {name: getattr(f, attr) for name, (f, attr) in counters.items()}
    fwd_by_n = dict(fused_window_attention.launches_by_n)
    bwd_by_n = dict(fused_window_attention.backward_launches_by_n)
    print(f"[train] ngram n=3: {TRAIN_BATCH}x{TRAIN_PATCH}² bf16, composition recipe (phys=0): "
          f"K3 at N = 9 {fwd_by_n.get(9, 0) / steps:g} and K4 at N = 9 {bwd_by_n.get(9, 0) / steps:g} "
          f"launches per step, as the wrappers count them by window length (K3 {fwd_by_n}, "
          f"K4 {bwd_by_n} in {steps} steps); all launches "
          f"per step " + ", ".join(f"{k} {v / steps:g}" for k, v in launches.items())
          + f"; steps {', '.join(f'{t * 1e3:.1f}' for t in times)} ms on {card}")
    print("[train] ngram n=3: g_rec by step: " + " ".join(f"{h['g_rec']:.5f}" for h in history))
    want = {9: 40 * steps, 64: 20 * steps}
    check(fwd_by_n == want and bwd_by_n == want,
          "per step 40 K3 and 40 K4 launches at N = 9 (two directions in each of 20 blocks) "
          "beside the 20 of each at N = 64, and none at another length")
    check(launches["ngram_context"] == launches["ngram_context_bwd"] == 0,
          "the fused n-gram kernels K1/K7 (built for n = 2) do not run")
    check(all(np.isfinite(v) for h in history for v in h.values()), "every metric finite")
    check(history[-1]["g_rec"] < history[0]["g_rec"],
          f"g_rec falls: {history[0]['g_rec']:.5f} -> {history[-1]['g_rec']:.5f}")
    del state, step
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"n = 3 training checks failed: {failures}")


# ---- phases 17-19: the v1 variant, fine-tuning, the DCGAN loop --------------
FINETUNE_ARCHS = ("redcnn", "transformer", "bafresnet", "dudo")
FINETUNE_PATCH, FINETUNE_BATCH = 64, 4  # the finetune command's defaults
DCGAN_BATCH, DCGAN_STEPS = 64, 16


def _all_counters():
    """Every hand-written kernel's launch counter: the training kernels' and
    the token-level whole-block kernel's."""
    from tmar_torch.ops import cuda_nstb

    return {**_train_counters(), "nstb_tokens": (cuda_nstb.fused_nstb, "launches")}


def _zero(counters):
    for f, attr in counters.values():
        setattr(f, attr, 0)


def _read(counters):
    return {name: getattr(f, attr) for name, (f, attr) in counters.items()}


def train_v1(card):
    """Phase 17: the ``v1`` variant (the DCGAN critic with ``ndf =
    disc.base_channels``, vanilla BCE, adv 0.1, no sinogram term) through
    the Trainer at full width, 8x128² bf16: one epoch of 4 steps with a
    checkpoint and a resume, then 2 warm-up and 8 timed steps on one fixed
    batch with the launch counts reset just before and read just after (20
    launches per step of each of K1, K7 and K3-K6), one step's profile; then
    one float32 step at 1x128² on the card against the CPU.  Returns the
    launch counts of the timed steps."""
    import tempfile

    import torch

    from tmar_torch.nn.baselines import DCGANCritic
    from tmar_torch.train import Trainer

    failures = []

    def check(cond, what):
        print(f"[check] {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(what)

    with tempfile.TemporaryDirectory(prefix="tmar_smoke_v1_") as tmp:
        cfg = _trainer_config(tmp, variant="v1", num_epochs=1, run_name="v1")
        trainer = Trainer(cfg)
        d = trainer.discriminator
        n_g = sum(p.numel() for p in trainer.generator.parameters())
        n_d = sum(p.numel() for p in d.parameters())
        check(cfg.variant == "v1" and cfg.loss.gan_mode == "vanilla" and cfg.loss.adv == 0.1
              and not cfg.radon.enabled and isinstance(d, DCGANCritic) and d.ndf == cfg.disc.base_channels
              and n_g == 990_811,
              f"the v1 variant: full-width NGswin ({n_g} parameters), DCGAN critic ndf "
              f"{cfg.disc.base_channels} ({n_d} parameters), vanilla BCE, adv 0.1, no sinogram term")
        t0 = time.perf_counter()
        trainer.fit(progress=False)
        wall = time.perf_counter() - t0
        print(f"[trainer] v1: fit 4 steps of {TRAIN_BATCH}x{TRAIN_PATCH}² bf16 on the synthetic dataset "
              f"in {wall:.2f} s (first steps included), checkpoint written, on {card}")
        for h in trainer.history:
            print("[trainer] v1 step {step}: ".format(**h) + " ".join(
                f"{k} {v:.5f}" for k, v in h.items() if k not in ("step", "epoch", "iter")))
        check(trainer.state.step == 4 and all(np.isfinite(v) for h in trainer.history for v in h.values())
              and all("g_adv" in h for h in trainer.history), "v1: 4 steps, every logged metric finite")
        fresh = Trainer(cfg)
        same = fresh.resume() and fresh.state.step == 4 and all(
            torch.equal(a, b) for a, b in zip(
                list(trainer.generator.state_dict().values()) + list(d.state_dict().values()),
                list(fresh.generator.state_dict().values()) + list(fresh.discriminator.state_dict().values())))
        check(same, "v1: a fresh trainer resumes the checkpoint bit for bit, critic included")
        del fresh

        batch = _synthetic_batch(TRAIN_BATCH, "cuda")
        counters = _train_counters()
        warmup, timed = 2, 8
        _zero(counters)
        history, times = [], []
        for _ in range(warmup + timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.state, metrics = trainer.train_step(trainer.state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            history.append({k: float(v) for k, v in metrics.items()})
        launches = _read(counters)
        n = warmup + timed
        per_step = {k: v / n for k, v in launches.items()}
        print("[trainer] v1: launches per step " + ", ".join(f"{k} {v:g}" for k, v in per_step.items())
              + f" (totals over {n} steps: {launches})")
        check([per_step[k] for k in counters] == [20, 20, 20, 20, 20, 20, 0],
              "v1: per step 20 launches each of K3, K4, K5, K6, K1 and K7, none of the whole-block kernel")
        check(all(np.isfinite(v) for h in history for v in h.values()), f"v1: every metric finite at each of "
              f"the {n} steps")
        med = statistics.median(times[warmup:])
        print(f"[time] train step (v1) {TRAIN_BATCH}x{TRAIN_PATCH}² bf16 (DCGAN critic, vanilla BCE, batch "
              f"on the card): median {med * 1e3:.2f} ms of {timed} steps (min {min(times[warmup:]) * 1e3:.2f}, "
              f"max {max(times[warmup:]) * 1e3:.2f}), {1 / med:.3f} steps/s on {card}")
        profile_request(lambda: trainer.train_step(trainer.state, batch), card,
                        label=f"train step (v1) {TRAIN_BATCH}x{TRAIN_PATCH}² bf16")
        del trainer
        torch.cuda.empty_cache()

        cfg32 = _trainer_config(tmp, variant="v1", bf16=False, run_name="v1_f32",
                                **{"data.batch_size": 1})
        on_cpu, on_card = Trainer(cfg32, device="cpu"), Trainer(cfg32)
        batch = _synthetic_batch(1, "cpu")
        _, cpu_m = on_cpu.train_step(on_cpu.state, batch)
        _, gpu_m = on_card.train_step(on_card.state, batch)
        compare_step(on_cpu.state, on_card.state, cpu_m, gpu_m, "f32 v1 step", check)
    if failures:
        raise SystemExit(f"v1 training checks failed: {failures}")
    return launches


def _finetune_model(arch, device, projector):
    from tmar_torch.nn.baselines import BAFResNet, DenoisingTransformer, RedCNN
    from tmar_torch.nn.dudo import DuDoMARNet

    if arch == "dudo":
        return DuDoMARNet(projector=projector)
    if arch == "transformer":
        return DenoisingTransformer(img_size=FINETUNE_PATCH, device=device)
    return {"redcnn": RedCNN, "bafresnet": BAFResNet}[arch](device=device)


def finetune_phases(card):
    """Phase 18: ``python -m tmar_torch.cli finetune`` for each architecture
    at the command's defaults (64² patches, batch 4, 180 angles, lambda_sino
    0.1; RedCNN 96 features, DenoisingTransformer 128 x 4, BAFResNet 64 x 8,
    DuDo 4 stages x 32 channels x 3 blocks) for one epoch on a SpineWeb tree
    written here (16 slice pairs at 416²), called in-process with every
    launch counter reset just before and read just after (these networks
    launch no hand-written kernel: 0 of each); the pickle and history.json
    written; then one float32 step of each at 1x64² on the card against the
    CPU from the same weights: the loss terms and every parameter's
    gradient.  Returns the bytes of DuDo's pickle (phase 21 compares it)."""
    import tempfile

    import torch

    from tmar_torch import cli
    from tmar_torch.data import BenchmarkFinetuneDataset
    from tmar_torch.ops.radon import Radon
    from tmar_torch.train.finetune import FinetuneState, FinetuneWeights, make_finetune_step

    failures = []

    def check(cond, what):
        print(f"[check] {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(what)

    angles = np.linspace(0, np.pi, 180, endpoint=False)
    counters = _all_counters()
    dudo_pickle = b""
    with tempfile.TemporaryDirectory(prefix="tmar_smoke_ft_") as tmp:
        spine, sec = write_trees(tmp, syndeeplesion=False)["spineweb"]
        art, cln = os.path.join(spine, "artifact"), os.path.join(spine, "clean")
        ds = BenchmarkFinetuneDataset(art, cln, patch_size=FINETUNE_PATCH)
        sample = ds[0]
        batch = {k: sample[k][None, ..., None] for k in ("Xma", "Xgt", "mask", "XLI")}
        for arch in FINETUNE_ARCHS:
            out = os.path.join(tmp, f"ft_{arch}")
            _zero(counters)
            t0 = time.perf_counter()
            rc = cli.finetune(["--arch", arch, "--artifact-dir", art, "--clean-dir", cln, "--epochs", "1",
                               "--out", out])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _read(counters)
            steps = len(ds) // FINETUNE_BATCH
            hist_path = os.path.join(out, "history.json")
            history = json.load(open(hist_path)) if rc == 0 and os.path.isfile(hist_path) else []
            print(f"[finetune] {arch}: rc {rc}, 1 epoch of {steps} steps of {FINETUNE_BATCH}x{FINETUNE_PATCH}² "
                  f"f32 on the {SPINE_SLICES}-pair SpineWeb tree in {wall:.2f} s, {steps / wall:.2f} steps/s "
                  f"(model build, first steps and the pickle included) on {card}; loss history "
                  f"{json.dumps(history)}; hand-written kernel launches "
                  + ", ".join(f"{k} {v}" for k, v in launches.items()))
            pkl = os.path.join(out, f"{arch}_finetuned.pkl")
            check(rc == 0 and os.path.isfile(pkl) and len(history) == 1,
                  f"finetune {arch}: {arch}_finetuned.pkl and history.json written")
            if arch == "dudo" and os.path.isfile(pkl):
                with open(pkl, "rb") as f:
                    dudo_pickle = f.read()
            check(bool(history) and all(np.isfinite(v) for v in history[0].values())
                  and history[0].get("sino", 0) > 0, f"finetune {arch}: every loss finite, the sinogram term on")
            check(not any(launches.values()), f"finetune {arch}: no hand-written kernel launched "
                  f"(0 of each of the {len(counters)} counted)")

            # one float32 step on the card against the same step on the CPU,
            # from weights drawn from a stated seed (the global generator's
            # state here depends on the phases before)
            torch.manual_seed(18)
            nets, start = {}, None
            for dev in ("cpu", "cuda"):
                proj = Radon(FINETUNE_PATCH, angles, device=dev)
                net = _finetune_model(arch, dev, proj)
                if start is None:
                    start = {k: v.clone() for k, v in net.state_dict().items()}
                else:
                    net.load_state_dict(start)
                opt = torch.optim.Adam(net.parameters(), 1e-4)
                step = make_finetune_step(net, opt, FinetuneWeights(), projector=proj, device=dev)
                _, m = step(FinetuneState(0, net, opt), batch)
                nets[dev] = (net, {k: float(v) for k, v in m.items()})
            (cpu_net, cpu_m), (gpu_net, gpu_m) = nets["cpu"], nets["cuda"]
            worst_m = max(abs(gpu_m[k] - cpu_m[k]) / max(1.0, abs(cpu_m[k])) for k in cpu_m)
            ref = dict(cpu_net.named_parameters())
            floor = 1e-3 * max(float(p.grad.abs().max()) for p in ref.values())
            worst, where = 0.0, ""
            for k, p in gpu_net.named_parameters():
                r = ref[k].grad
                rel = float((p.grad.cpu() - r).abs().max()) / max(float(r.abs().max()), floor)
                if rel > worst:
                    worst, where = rel, k
            print(f"[check] finetune {arch} f32 step at 1x{FINETUNE_PATCH}², card vs CPU: loss terms "
                  f"({' '.join(sorted(cpu_m))}) worst |diff| / max(1, |ref|) {worst_m:.3e} tol 1e-4; "
                  f"gradients of {len(ref)} tensors worst max|diff| / max(max|ref|, 1e-3 of the "
                  f"network's) {worst:.3e} at {where} tol {STEP_TOL:g}")
            check(set(cpu_m) == set(gpu_m) and worst_m <= 1e-4 and worst <= STEP_TOL,
                  f"finetune {arch} f32 step, card vs CPU")
            del nets, start, cpu_net, gpu_net
            torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"fine-tune checks failed: {failures}")
    return dudo_pickle


def dcgan_phase(card):
    """Phase 19: ``train_dcgan`` at its defaults (nz 100, ngf / ndf 64, 64²,
    Adam 2e-4 b1 0.5) for 16 steps of batch 64 (64² crops of synthetic clean
    slices in [-1, 1]) with every launch counter reset just before and read
    just after (0 of each: the DCGAN pair runs on cuDNN)."""
    import torch

    from tmar_torch.data import SyntheticMARDataset
    from tmar_torch.train.dcgan import train_dcgan

    ds = SyntheticMARDataset(size=64, length=4 * DCGAN_BATCH, base_seed=11)
    gt = np.stack([ds[i]["gt"] for i in range(len(ds))])[..., None].astype(np.float32)
    data = [gt[i:i + DCGAN_BATCH] for i in range(0, len(gt), DCGAN_BATCH)]
    counters = _all_counters()
    _zero(counters)
    t0 = time.perf_counter()
    state, hist = train_dcgan(data, steps=DCGAN_STEPS, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    _, more = train_dcgan(data, steps=DCGAN_STEPS, seed=1)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t1
    launches = _read(counters)
    print(f"[dcgan] train_dcgan {DCGAN_STEPS} steps of {DCGAN_BATCH}x64² (nz 100, ngf/ndf 64): "
          f"{wall * 1e3 / DCGAN_STEPS:.2f} ms/step in a first run (cuDNN's first calls included), "
          f"{warm * 1e3 / DCGAN_STEPS:.2f} ms/step in a second on {card}; loss_d "
          + " ".join(f"{v:.4f}" for v in hist["loss_d"]) + "; loss_g "
          + " ".join(f"{v:.4f}" for v in hist["loss_g"]) + "; hand-written kernel launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    ok = (state.step == DCGAN_STEPS and np.isfinite(hist["loss_d"] + hist["loss_g"]).all()
          and np.isfinite(more["loss_d"] + more["loss_g"]).all() and not any(launches.values()))
    print(f"[check] dcgan: {DCGAN_STEPS} steps, every loss finite, no hand-written kernel launched: "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("dcgan checks failed")


# ---- phase 21: evaluation on the card ----------------------------------------
EVAL_ABLATIONS = ("A1_no_physics", "A6_no_edge")
EVAL_SLICES = 4  # synthetic 416² slices of the comparison
IDENTITY_ADAPTER = """import sys
import numpy as np
d = np.load(sys.argv[1])
np.save(sys.argv[2], d["Xma"])
"""


def _sets(overrides):
    """``--set`` arguments for a dict of dotted config overrides."""
    return ["--set", *(f"{k}={json.dumps(v)}" for k, v in overrides.items())]


def eval_phase(card, dudo_pickle):
    """Phase 21: the evaluation commands in process on the card, every
    launch counter reset just before each and read just after.

    ``compare`` on 4 synthetic 416² slices: (a) the flagship at bf16 (K1 +
    the tensor-core K2), the identity, an identity subprocess adapter and
    the DuDo pickle of phase 18, with ``--sinograms``; (b) the flagship at
    f32 (the templated K2); (c) a demo-width checkpoint written below (K2's
    generic body).  ``ablate --inference-only`` over two ablations at the
    demo width on 2 of its 64² test slices, from the checkpoints one short
    ``Trainer.fit`` per ablation writes here.  Every row ``ok``; the
    flagship's PSNR above the input's (the identity's); K2's launches: 20 per
    flagship forward and 8 per demo forward (the harness warms each model
    up on its first sample: 5 forwards for 4 slices).  Returns the K2
    launches of the whole phase."""
    import tempfile

    import torch

    from tmar_torch import cli
    from tmar_torch.train import Trainer

    failures = []

    def check(cond, what):
        print(f"[check] eval: {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(what)

    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("[skip] figures: matplotlib is not installed")
    counters = _serving_counters()
    total = {k: 0 for k in counters}
    # the demo-width generator and critic (the checkpoint's layout), on the
    # comparison's 416² slices
    demo_net = {k: v for k, v in DEMO_OVERRIDES.items() if k.startswith(("model.", "disc."))}
    # the recipe builds the training form, in which the whole-block kernels
    # stand aside (as in the JAX package); the serving form runs K1 + K2
    serving = {"model.attn_backward": "auto"}
    recipe = os.path.join(ROOT, "tmar_torch", "configs", "train_syndeeplesion.yaml")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tmar_smoke_eval_") as tmp:
        # the demo-width checkpoints of the two ablations
        for name in EVAL_ABLATIONS:
            cfg = _trainer_config(tmp, **{**DEMO_OVERRIDES, "variant": name,
                                          "run_name": f"ablation_{name}", "num_epochs": 1,
                                          "data.samples_per_epoch": 16})
            trainer = Trainer(cfg)
            trainer.fit(progress=False)
            check(int(trainer.state.step) == 2 and os.path.isdir(
                os.path.join(tmp, f"ablation_{name}", "checkpoints")),
                f"Trainer.fit wrote {name}'s demo-width checkpoint after 2 steps")
            del trainer
        torch.cuda.empty_cache()
        script = os.path.join(tmp, "identity_adapter.py")
        with open(script, "w") as f:
            f.write(IDENTITY_ADAPTER)
        pkl = os.path.join(tmp, "dudo_finetuned.pkl")
        with open(pkl, "wb") as f:
            f.write(dudo_pickle)

        def run(label, command, argv, per_forward, forwards):
            for f in counters.values():
                f.launches = 0
            t0 = time.perf_counter()
            rc = getattr(cli, command)(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: f.launches for k, f in counters.items()}
            for k, v in got.items():
                total[k] += v
            print(f"[eval] {label}: rc {rc} in {wall:.2f} s; launches {got} on {card}")
            check(rc == 0, f"{label} returns 0")
            want = {"ngram_context": per_forward * forwards, "nstb_map": per_forward * forwards}
            check({k: v for k, v in got.items() if v} == want,
                  f"{label}: {per_forward} launches each of K1 and K2 per forward, {forwards} "
                  f"forwards, nothing else")

        def rows(out):
            res = {m: json.load(open(os.path.join(out, m, "metrics.json")))
                   for m in sorted(os.listdir(out)) if os.path.isfile(os.path.join(out, m, "metrics.json"))}
            for m, r in res.items():
                s_ = r.get("summary", {})
                print(f"[eval] {os.path.basename(out)} {m}: {r['status']}"
                      + (f", PSNR {s_['psnr']['mean']:.4f} dB, SSIM {s_['ssim']['mean']:.5f}, "
                         f"{s_['latency_s']['mean'] * 1e3:.2f} ms a slice" if r["status"] == "ok"
                         else f": {r.get('error')}"))
            return res

        common = ["--num-samples", str(EVAL_SLICES), "--composites", "1"]
        synth = {"data.dataset": "synthetic"}
        out = os.path.join(tmp, "compare_bf16")
        run("compare, full width bf16", "compare",
            ["--checkpoints", f"flagship={CKPT}", "identity", "--adapter",
             f"adapter={sys.executable} {script}", "--dudo", f"dudo={pkl}", "--sinograms",
             "--out", out, *common, *_sets(synth)], 20, EVAL_SLICES + 1)
        res = rows(out)
        check(sorted(res) == ["adapter", "dudo", "flagship", "identity"]
              and all(r["status"] == "ok" for r in res.values()),
              "compare at full width: the flagship, the identity, the adapter and DuDo all ok")
        if all(r["status"] == "ok" for r in res.values()):
            p = {m: r["summary"]["psnr"]["mean"] for m, r in res.items()}
            check(p["flagship"] > p["identity"] and abs(p["adapter"] - p["identity"]) < 1e-6,
                  f"the flagship's PSNR {p['flagship']:.4f} dB above the input's "
                  f"{p['identity']:.4f}; the identity adapter equal to the identity")
        out = os.path.join(tmp, "compare_f32")
        run("compare, full width f32", "compare",
            ["--checkpoints", f"flagship={CKPT}", "identity", "--out", out, *common,
             *_sets({**synth, "bf16": False})], 20, EVAL_SLICES + 1)
        res = rows(out)
        check(all(r["status"] == "ok" for r in res.values()) and len(res) == 2
              and res["flagship"]["summary"]["psnr"]["mean"] > res["identity"]["summary"]["psnr"]["mean"],
              "compare at f32: both rows ok, the flagship's PSNR above the input's")
        out = os.path.join(tmp, "compare_demo")
        run("compare, demo width bf16", "compare",
            ["--checkpoints", f"demo={os.path.join(tmp, 'ablation_A1_no_physics', 'checkpoints')}",
             "identity", "--config", recipe, "--out", out, *common,
             *_sets({**synth, **demo_net, **serving})], 8,
            EVAL_SLICES + 1)
        res = rows(out)
        check(all(r["status"] == "ok" for r in res.values()) and len(res) == 2,
              "compare at the demo width: both rows ok")
        run("ablate --inference-only, demo width", "ablate",
            ["--config", recipe, "--ablations", *EVAL_ABLATIONS, "--inference-only", "--max-eval-samples", "2",
             "--vis-samples", "1", *_sets({**DEMO_OVERRIDES, **serving, "run_dir": tmp})], 8,
            2 * len(EVAL_ABLATIONS))
        with open(os.path.join(tmp, "ablation_summary.json")) as f:
            summary = json.load(f)
        for name in EVAL_ABLATIONS:
            r = summary.get(name, {})
            s_ = r.get("summary", {})
            print(f"[eval] ablate {name}: {r.get('status')}"
                  + (f", PSNR {s_['psnr']:.4f} dB, SSIM {s_['ssim']:.5f}, metal PSNR "
                     f"{s_.get('metal_PSNR', float('nan')):.4f}, within 10 HU "
                     f"{s_.get('within_10HU', float('nan')):.4f}" if r.get("status") == "ok"
                     else f": {r.get('error')}"))
        check(sorted(summary) == sorted(EVAL_ABLATIONS)
              and all(r["status"] == "ok" for r in summary.values()),
              "ablate: every ablation ok, ablation_summary.csv / json written")
    print(f"[time] phase 21 (compare x3, ablate) in {time.perf_counter() - t_phase:.1f} s on {card}")
    if failures:
        raise SystemExit(f"evaluation checks failed: {failures}")
    return total


# ---- phase 22: parallelism on the card ----------------------------------------
# NCCL takes one rank per device, and the card is one.  gloo takes CUDA
# tensors in every collective the modes use (all-reduce for dp and tp,
# broadcast, all-gather and reduce-scatter for fsdp, all-gather for the tiled
# eval; each checked on an H100 with two ranks on one card), so every
# mode runs two ranks on the one card over gloo.  The choice is fixed here and
# printed, not taken at run time.
PARALLEL_WORLD, PARALLEL_BACKEND = 2, "gloo"
PARALLEL_SLICES, PARALLEL_BF16_STEPS = 4, 3


def _parallel_cfg(run_dir, mode, batch, bf16, run_name):
    """The promoted recipe at full width, batch ``batch`` (global), in
    ``mode``; tp in the plain form (the JAX package refuses tp on Pallas)."""
    sets = {"data.batch_size": batch, "bf16": bf16, "run_name": run_name, "num_epochs": 1}
    if mode == "fsdp":
        sets["parallel.mode"] = "fsdp"
    if mode == "tp":
        sets.update({"parallel.mode": "tp", "parallel.model_parallel": 2,
                     "model.use_pallas_attention": False})
    return _trainer_config(run_dir, **sets)


def _whole_step(g, d, m):
    """The metrics, and both networks' parameters and gradients whole, on the
    CPU (a collective on sharded networks)."""
    from tmar_torch.core.mesh import full_tensor

    out = {"metrics": {k: float(v) for k, v in m.items()}}
    for name, net in (("g", g), ("d", d)):
        out[name] = {k: full_tensor(net, k, p.detach()).cpu() for k, p in net.named_parameters()}
        out[f"{name}_grad"] = {k: full_tensor(net, k, p.grad).cpu() for k, p in net.named_parameters()}
    return out


def _tiled_slices(n):
    from tmar_torch.data import SyntheticMARDataset

    ds = SyntheticMARDataset(size=416, length=n)
    return np.stack([ds[i]["ct"] for i in range(n)])[..., None].astype(np.float32)


class _FinetunePairs:
    """Fine-tune pairs at 64² whose sample i depends on i alone."""

    def __len__(self):
        return 2 * FINETUNE_BATCH

    def __getitem__(self, i):
        from tmar_torch.data import SyntheticMARDataset

        s = SyntheticMARDataset(size=FINETUNE_PATCH, length=len(self), base_seed=22)[i]
        to01 = lambda a: np.clip((a + 1) / 2, 0, 1).astype(np.float32)  # noqa: E731
        return {"Xma": to01(s["ct"]), "Xgt": to01(s["gt"]),
                "mask": (s["ct"] - s["gt"] > 0.2).astype(np.float32)}


def parallel_rank(rank, world, out):
    """What each rank of phase 22 runs (in a process of its own, on the one
    card): for dp, fsdp and tp one float32 step of the promoted recipe at full
    width from the seeded state; for dp and fsdp three bf16 steps of 4 rows a
    rank, timed, fsdp then writing a checkpoint; the flagship's sharded tiled
    eval at f32 and bf16; two fine-tune steps of RedCNN.  Each counted by the
    wrappers' launch counters, reset just before and read just after.
    Writes ``<out>/rank<r>.pt``."""
    import warnings

    import torch

    from tmar_torch import NGswin, load_pth
    from tmar_torch.core.mesh import create_mesh, full_tensor, shard_batch
    from tmar_torch.nn.baselines import RedCNN
    from tmar_torch.parallel import sharded_tiled_eval
    from tmar_torch.train import Trainer
    from tmar_torch.train.finetune import FinetuneWeights, finetune

    warnings.filterwarnings("ignore", message="FSDP2-wrapped module")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    counters = _train_counters()
    res = {}
    for mode in ("dp", "fsdp", "tp"):
        tr = Trainer(_parallel_cfg(out, mode, 2, False, f"{mode}_f32"), device=dev)
        batch = shard_batch(tr.mesh, _synthetic_batch(2, dev))
        _zero(counters)
        _, m = tr.train_step(tr.state, batch)
        torch.cuda.synchronize()
        res[mode] = {"f32": _whole_step(tr.generator, tr.discriminator, m),
                     "f32_launches": _read(counters), "rows": int(batch["ct"].shape[0]),
                     "mesh": tuple(tr.mesh.shape), "form": tr.generator.attn_backward}
        del tr
        torch.cuda.empty_cache()
        if mode == "tp":
            continue
        tr = Trainer(_parallel_cfg(out, mode, TRAIN_BATCH, True, f"{mode}_bf16"), device=dev)
        batch = shard_batch(tr.mesh, _synthetic_batch(TRAIN_BATCH, dev))
        history, times = [], []
        _zero(counters)
        for _ in range(PARALLEL_BF16_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.state, m = tr.train_step(tr.state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            history.append({k: float(v) for k, v in m.items()})
        res[mode]["bf16"] = {"history": history, "times": times, "launches": _read(counters),
                             "rows": int(batch["ct"].shape[0])}
        if mode == "fsdp":
            tr.ckpt.save(tr.state, step=tr.state.step, meta={"epoch": 1})
            g = tr.generator
            res[mode]["saved"] = {k: full_tensor(g, k, p.detach()).cpu() for k, p in g.named_parameters()}
            qkv = dict(g.named_parameters())["encoder_layer1.blocks.0.attn.qkv.weight"]
            res[mode]["qkv_rows"] = (qkv.to_local().shape[0], qkv.shape[0])
        del tr
        torch.cuda.empty_cache()

    mesh = create_mesh(world, device=dev)
    ct = _tiled_slices(PARALLEL_SLICES)
    sd = load_pth(CKPT)
    res["tiled_eval"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = NGswin(dtype=dtype, device=dev)
        model.load_state_dict(sd)
        sharded_tiled_eval(model, mesh, ct)  # warm-up: the timed call is the second
        _zero(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sharded_tiled_eval(model, mesh, ct)
        torch.cuda.synchronize()
        res["tiled_eval"][str(dtype).split(".")[-1]] = {
            "out": got, "ms": (time.perf_counter() - t0) * 1e3, "launches": _read(counters)}
        del model
    torch.cuda.empty_cache()

    _zero(counters)
    torch.manual_seed(22)
    ft = finetune(RedCNN(device=dev), _FinetunePairs(), batch_size=FINETUNE_BATCH,
                  weights=FinetuneWeights(sino=0.0), mesh=mesh, seed=22, device=dev)
    res["finetune"] = {"history": ft["history"], "launches": _read(counters),
                       "params": {k: p.detach().cpu() for k, p in ft["state"].model.named_parameters()}}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def _hold_step(ref, got, label, check, lrs):
    """A step of the ranks against one process's: the loss terms, both
    networks' gradients (the train-step bounds of PERF.md §2), and the
    parameters after the update, within 2.1·lr (Adam's first update is
    lr·g / (|g| + eps), so a gradient inside its bound moves a component by
    at most the two steps of opposite sign) and 0.01·lr on average."""
    worst = max(abs(got["metrics"][k] - v) / max(1.0, abs(v)) for k, v in ref["metrics"].items())
    check(set(ref["metrics"]) == set(got["metrics"]) and worst <= 1e-4,
          f"{label}: {len(ref['metrics'])} loss terms worst |diff| / max(1, |ref|) {worst:.3e} tol 1e-4")
    for net in ("g", "d"):
        grads, ref_grads = got[f"{net}_grad"], ref[f"{net}_grad"]
        floor = 1e-3 * max(float(t.abs().max()) for t in ref_grads.values())
        rel, where = max((float((grads[k] - r).abs().max()) / max(float(r.abs().max()), floor), k)
                         for k, r in ref_grads.items())
        check(rel <= STEP_TOL, f"{label}: gradients of the {'generator' if net == 'g' else 'discriminator'} "
              f"worst max|diff| / max(max|ref|, 1e-3 of the network's) {rel:.3e} at {where} "
              f"tol {STEP_TOL:g}")
        diffs = [(got[net][k] - r).abs() for k, r in ref[net].items()]
        top = max(float(d.max()) for d in diffs)
        mean = sum(float(d.sum()) for d in diffs) / sum(d.numel() for d in diffs)
        net_lr = lrs[net]
        check(top <= 2.1 * net_lr and mean <= 0.01 * net_lr,
              f"{label}: {'generator' if net == 'g' else 'discriminator'} parameters after the update "
              f"max|diff| {top:.3e} (tol 2.1 lr = {2.1 * net_lr:.1e}), mean {mean:.3e} "
              f"(tol 0.01 lr = {0.01 * net_lr:.1e})")


def parallel_phase(card):
    """Phase 22: the parallel layouts on the one card (two gloo ranks each),
    against one process.  Returns {kernel: {path: [launches of rank 0,
    rank 1]}}."""
    import tempfile
    import warnings

    import torch

    from tmar_torch import NGswin, load_pth, make_tiled_eval
    from tmar_torch.nn.baselines import RedCNN
    from tmar_torch.ops.radon import Radon
    from tmar_torch.parallel import spawn_ranks
    from tmar_torch.train import Trainer
    from tmar_torch.train.finetune import FinetuneWeights, finetune
    from tmar_torch.train.steps import GANTrainState, draw_parameters, make_train_step, new_ema
    from tmar_torch.train.trainer import build_discriminator, build_generator, build_optimizers

    warnings.filterwarnings("ignore", message="FSDP2-wrapped module")
    failures = []

    def check(cond, what):
        print(f"[check] parallel {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(what)

    t_phase = time.perf_counter()
    dev = "cuda"
    print(f"[parallel] dp, fsdp, tp, tiled eval, finetune: world size {PARALLEL_WORLD}, "
          f"{PARALLEL_BACKEND}, every rank on cuda:0 (fixed in chip_smoke.py: NCCL takes one rank "
          "per device)")
    with tempfile.TemporaryDirectory(prefix="tmar_smoke_par_") as out:
        t0 = time.perf_counter()
        spawn_ranks(parallel_rank, PARALLEL_WORLD, out, threads=None, cuda_device=0)
        print(f"[parallel] two ranks ran every mode in {time.perf_counter() - t0:.1f} s "
              "(process start, kernel loading and every Trainer's build included)")
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(2)]

        # one process, from the same seeded state, on the same rows
        batch2 = _synthetic_batch(2, dev)
        ref_tr = Trainer(_parallel_cfg(out, "dp", 2, False, "ref_f32"), device=dev)
        _, m = ref_tr.train_step(ref_tr.state, batch2)
        ref = _whole_step(ref_tr.generator, ref_tr.discriminator, m)
        lrs = {"g": ref_tr.cfg.optim.lr_g, "d": ref_tr.cfg.optim.lr_d}
        del ref_tr
        cfg = _parallel_cfg(out, "tp", 2, False, "ref_plain")
        g, d = build_generator(cfg, dev, form="plain"), build_discriminator(cfg, dev)
        draw_parameters(torch.Generator().manual_seed(cfg.seed), g, d)
        g_opt, d_opt = build_optimizers(cfg, g, d)
        proj = Radon(cfg.data.patch_size, np.linspace(0, np.pi, cfg.radon.num_angles, endpoint=False),
                     precision=cfg.radon.precision, device=dev)
        step = make_train_step(g, d, g_opt, d_opt, cfg.loss, projector=proj,
                               fused_pairs=cfg.disc.fused_pairs, ema_decay=cfg.optim.ema_decay,
                               device=dev)
        _, m = step(GANTrainState(0, g, g_opt, d, d_opt, new_ema(g)), batch2)
        ref_plain = _whole_step(g, d, m)
        del g, d, g_opt, d_opt, step
        torch.cuda.empty_cache()

        launches = {}
        for mode in ("dp", "fsdp", "tp"):
            r0 = ranks[0][mode]
            print(f"[parallel] {mode}: mesh (data, model) {r0['mesh']}, generator form "
                  f"{r0['form']}, f32 step on {r0['rows']} row(s) a rank; launches a rank: "
                  + "; ".join(f"rank {i} " + ", ".join(f"{k} {v}" for k, v in r[mode]["f32_launches"].items())
                              for i, r in enumerate(ranks)))
            for i, r in enumerate(ranks):
                _hold_step(ref_plain if mode == "tp" else ref, r[mode]["f32"],
                           f"{mode} f32 step, rank {i} of 2 vs one process taking both rows", check, lrs)
            want = 0 if mode == "tp" else 20
            check(all(v == (0 if k == "nstb_map" else want) for r in ranks
                      for k, v in r[mode]["f32_launches"].items()),
                  f"{mode} f32 step: {want} launches each of K1, K7 and K3-K6 on every rank"
                  + (" (the plain form runs no kernel, as the JAX package runs none under tp)"
                     if mode == "tp" else ""))
            for name in ranks[0][mode]["f32_launches"]:
                launches.setdefault(name, {})[f"{mode}_f32"] = [r[mode]["f32_launches"][name] for r in ranks]
            if mode == "tp":
                continue
            hist = [r[mode]["bf16"]["history"] for r in ranks]
            check(all(np.isfinite(v) for h in hist for row in h for v in row.values()),
                  f"{mode} bf16: every metric finite at each of the {PARALLEL_BF16_STEPS} steps")
            check(hist[0] == hist[1], f"{mode} bf16: both ranks return the same (global) metrics")
            check(hist[0][-1]["g_rec"] < hist[0][0]["g_rec"],
                  f"{mode} bf16: g_rec falls: {hist[0][0]['g_rec']:.5f} -> {hist[0][-1]['g_rec']:.5f}")
            n = PARALLEL_BF16_STEPS
            check(all(v == (0 if k == "nstb_map" else 20 * n) for r in ranks
                      for k, v in r[mode]["bf16"]["launches"].items()),
                  f"{mode} bf16: 20 launches per step each of K1, K7 and K3-K6 on every rank "
                  f"({n} steps: {ranks[0][mode]['bf16']['launches']})")
            for name in ranks[0][mode]["bf16"]["launches"]:
                launches[name][f"{mode}_bf16"] = [r[mode]["bf16"]["launches"][name] for r in ranks]
            times = ranks[0][mode]["bf16"]["times"]
            print(f"[time] parallel {mode} bf16 step, 2 ranks x {ranks[0][mode]['bf16']['rows']} rows on one "
                  f"card: steps of {' '.join(f'{t * 1e3:.1f}' for t in times)} ms (the first warms up), "
                  f"{1 / statistics.median(times[1:]):.3f} steps/s on {card}")

        # the one-process 8-row bf16 step beside them
        tr = Trainer(_parallel_cfg(out, "dp", TRAIN_BATCH, True, "ref_bf16"), device=dev)
        batch8 = _synthetic_batch(TRAIN_BATCH, dev)
        times = []
        for _ in range(PARALLEL_BF16_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.state, _ = tr.train_step(tr.state, batch8)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print(f"[time] parallel one process {TRAIN_BATCH} rows bf16 step: steps of "
              f"{' '.join(f'{t * 1e3:.1f}' for t in times)} ms, {1 / statistics.median(times[1:]):.3f} "
              f"steps/s on {card}")
        del tr
        torch.cuda.empty_cache()

        # the fsdp checkpoint resumes in one process, bit for bit
        rows = [r["fsdp"]["qkv_rows"] for r in ranks]
        check(all(2 * held == whole for held, whole in rows),
              f"fsdp: each rank holds half of a qkv's rows (held, whole: {rows})")
        one = Trainer(_parallel_cfg(out, "dp", TRAIN_BATCH, True, "fsdp_bf16"), device=dev)
        ok = one.resume()
        saved = ranks[0]["fsdp"]["saved"]
        check(ok and one.state.step == PARALLEL_BF16_STEPS and all(
            torch.equal(p.detach().cpu(), saved[k]) for k, p in one.generator.named_parameters()),
            "a checkpoint written under fsdp resumes in one process with bit-equal parameters")
        del one

        # the sharded tiled eval against one process
        ct = _tiled_slices(PARALLEL_SLICES)
        sd = load_pth(CKPT)
        tile_count = PARALLEL_SLICES * 144
        for dn, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            model = NGswin(dtype=dtype, device=dev)
            model.load_state_dict(sd)
            tiled = make_tiled_eval(model, device=dev)
            tiled(ct)  # warm-up, as on the ranks
            t0 = time.perf_counter()
            want = tiled(ct)
            ms = (time.perf_counter() - t0) * 1e3
            del model
            got = [r["tiled_eval"][dn] for r in ranks]
            err = max(float(np.abs(g["out"] - want).max()) for g in got)
            # both sides run the same per-tile work (1.2e-7 apart at either
            # dtype): a misplaced or padded tile shows far above this
            check(err <= 1e-5 and np.isfinite(got[0]["out"]).all(),
                  f"sharded tiled eval {dn}, {PARALLEL_SLICES} slices of 416² ({tile_count} tiles of "
                  f"64², {tile_count // 2} a rank) vs one process: max|err| {err:.3e} (tol 1e-5)")
            check(all(g["launches"]["ngram_context"] == 20 and g["launches"]["nstb_map"] == 20
                      for g in got), f"sharded tiled eval {dn}: 20 launches each of K1 and K2 on every "
                  f"rank ({[g['launches'] for g in got]})")
            for name in got[0]["launches"]:
                launches.setdefault(name, {})[f"tiled_eval_{dn}"] = [g["launches"][name] for g in got]
            rank_ms = " / ".join(f"{g['ms']:.1f}" for g in got)
            print(f"[time] parallel tiled eval {dn}, {PARALLEL_SLICES}x416²: 2 ranks {rank_ms} ms a "
                  f"call (both on one card, the second call), one process {ms:.1f} ms, "
                  f"{ms / PARALLEL_SLICES:.1f} ms a slice on {card}")
        torch.cuda.empty_cache()

        # fine-tuning on the mesh against one process
        torch.manual_seed(22)
        ft = finetune(RedCNN(device=dev), _FinetunePairs(), batch_size=FINETUNE_BATCH,
                      weights=FinetuneWeights(sino=0.0), seed=22, device=dev)
        for i, r in enumerate(ranks):
            got = r["finetune"]
            worst = max(abs(got["history"][0][k] - v) / max(1.0, abs(v))
                        for k, v in ft["history"][0].items() if k != "epoch")
            top = max(float((got["params"][k] - p.detach().cpu()).abs().max())
                      for k, p in ft["state"].model.named_parameters())
            check(worst <= 1e-4 and top <= 2.1 * 1e-4,
                  f"finetune RedCNN on the mesh, rank {i}, 2 steps vs one process: mean losses worst "
                  f"|diff| / max(1, |ref|) {worst:.3e} tol 1e-4; parameters max|diff| {top:.3e} tol "
                  "2.1 lr = 2.1e-04")
            check(not any(r["finetune"]["launches"].values()),
                  f"finetune on the mesh, rank {i}: no hand-written kernel launched")
    print(f"[time] phase 22 (parallelism: dp, fsdp, tp, tiled eval, finetune) in "
          f"{time.perf_counter() - t_phase:.1f} s on {card}")
    if failures:
        raise SystemExit(f"parallel checks failed: {failures}")
    return launches


# ---- phase 23: the export path ------------------------------------------------
# the flagship's artifacts, each made by ``python -m tmar_torch.cli export``
# in process: (label, block form, environment of the form, float32, batch, size)
EXPORT_CASES = (
    ("map bf16 8x512²", "map", {}, False, 8, 512),
    ("map f32 1x128²", "map", {}, True, 1, 128),
    ("tokens f32 1x128²", "tokens", {"TMAR_NSTB_MAP": "0"}, True, 1, 128),
    ("unfused f32 1x128²", "unfused", {"TMAR_NSTB_FUSED": "0"}, True, 1, 128),
)
# a fresh process loads each artifact (building no model: NGswin refuses to
# be built there), calls it once with the launch counts set to 0 just before
# and read just after, keeps its output and times 5 more calls
REPLAY = r"""import json, statistics, sys, time
import numpy as np
import torch
import tmar_torch.nn.ngswin as ngswin

torch.backends.cuda.matmul.allow_tf32 = False  # as in the process of the eager side
torch.backends.cudnn.allow_tf32 = False


def refuse(*args, **kwargs):
    raise RuntimeError("the replay built a model")


ngswin.NGswin.__init__ = refuse
from tmar_torch.export import load_artifact
from tmar_torch.ops import cuda_attention, cuda_ffn, cuda_ngram, cuda_nstb

counters = {"ngram_context": (cuda_ngram.fused_ngram_context, "launches"),
            "nstb_map": (cuda_nstb.fused_nstb_map, "launches"),
            "nstb_tokens": (cuda_nstb.fused_nstb, "launches"),
            "window_attention_fwd": (cuda_attention.fused_window_attention, "launches"),
            "residual_ffn_fwd": (cuda_ffn.fused_residual_ffn, "launches"),
            "ngram_context_bwd": (cuda_ngram.fused_ngram_context, "backward_launches"),
            "window_attention_bwd": (cuda_attention.fused_window_attention, "backward_launches"),
            "residual_ffn_bwd": (cuda_ffn.fused_residual_ffn, "backward_launches")}
results = {}
for label, artifact, inp, out in json.load(open(sys.argv[1])):
    t0 = time.perf_counter()
    fn = load_artifact(artifact)
    load_s = time.perf_counter() - t0
    x = torch.from_numpy(np.load(inp)).cuda()
    fn(x)
    torch.cuda.synchronize()
    for f, attr in counters.values():
        setattr(f, attr, 0)
    y = fn(x)
    torch.cuda.synchronize()
    launches = {k: getattr(f, attr) for k, (f, attr) in counters.items()}
    np.save(out, y.float().cpu().numpy())
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    results[label] = {"launches": launches, "load_s": load_s, "ms": statistics.median(times) * 1e3,
                      "dtype": str(y.dtype), "device": str(y.device)}
json.dump(results, open(sys.argv[2], "w"))
"""
# 20 launches per call of each kernel of the form, none of the others
EXPORT_KERNELS = {
    "map": ("ngram_context", "nstb_map"),
    "tokens": ("ngram_context", "nstb_tokens"),
    "unfused": ("ngram_context", "window_attention_fwd", "residual_ffn_fwd"),
}


@contextlib.contextmanager
def _block_form_env(env):
    """The JAX package's block-form variables set to ``env`` (the others
    unset) for the duration, as ``tmar_torch.cli`` reads them."""
    names = ("TMAR_NSTB_FUSED", "TMAR_NSTB_MAP", "TMAR_NGRAM_FUSED", "TMAR_ATTN_IMPL")
    saved = {k: os.environ.pop(k, None) for k in names}
    os.environ.update(env)
    try:
        yield
    finally:
        for k in names:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]


def export_phase(card):
    """Phase 23: ``python -m tmar_torch.cli export`` on the flagship, each
    artifact replayed in a fresh process against the eager forward of its
    form on the same input; ``export --torch``; the eager request's device
    profile.  Returns {kernel: {artifact: launches per call}}."""
    import tempfile

    import torch

    from tmar_torch import NGswin, cli, load_pth
    from tmar_torch.utils.profiling import device_profile

    failures = []

    def check(cond, what):
        print(f"[check] export {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(what)

    t_phase = time.perf_counter()
    sd = load_pth(CKPT)
    rng = np.random.default_rng(23)
    x512 = rng.uniform(-1, 1, (8, 512, 512, 1)).astype(np.float32)
    inputs = {512: x512, 128: np.ascontiguousarray(x512[:1, :128, :128])}
    eager, cases = {}, []
    with tempfile.TemporaryDirectory(prefix="tmar_export_") as tmp:
        for label, form, env, f32, batch, size in EXPORT_CASES:
            path = os.path.join(tmp, f"{form}_{'f32' if f32 else 'bf16'}_{size}b{batch}.pt2")
            sets = ["--set", "bf16=false"] if f32 else []
            t0 = time.perf_counter()
            with _block_form_env(env):
                rc = cli.main(["export", "--checkpoint", CKPT, "--batch", str(batch),
                               "--size", str(size), "--out", path, *sets])
            print(f"[export] {label}: cli export exit {rc} in {time.perf_counter() - t0:.1f} s, "
                  f"{os.path.getsize(path) / 1e6:.1f} MB")
            check(rc == 0, f"{label} exported")
            inp = os.path.join(tmp, f"x{size}.npy")
            np.save(inp, inputs[size])
            cases.append((label, path, inp, os.path.join(tmp, f"{form}_{size}_{f32}.npy")))
            # the eager forward of the same form on the same input
            kwargs = {"map": {}, "tokens": {"nstb_map": False}, "unfused": {"nstb_fused": False}}[form]
            model = NGswin(dtype=torch.float32 if f32 else torch.bfloat16, **kwargs).eval()
            model.load_state_dict(sd)
            x = torch.from_numpy(inputs[size]).cuda()
            with torch.no_grad():
                eager[label] = model(x).float().cpu().numpy()
                if label == "map bf16 8x512²":
                    times = []
                    for _ in range(6):
                        t0 = time.perf_counter()
                        model(x)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                    eager_ms = statistics.median(times[1:]) * 1e3
                    # every row: the checks below must not hang on a kernel's rank
                    rows = device_profile(model, x, iters=3, top=1 << 30)
            del model
        # the eager request's profile: K1 and K2 20 times a forward
        print(f"[profile] eager map bf16 8x512² request, device_profile (3 iterations) on {card}: "
              f"{len(rows)} rows, the top 12 and the kernels'")
        for i, r in enumerate(rows):
            if i < 12 or "ngram_context" in r["op"] or "nstb" in r["op"]:
                print(f"[profile]   {r['ms']:9.3f} ms/iter x{r['count']:<4d} {r['op'][:100]}")
        for part in ("ngram_context", "nstb"):
            counts = [r["count"] for r in rows if part in r["op"]]
            check(counts == [60], f"device_profile shows {part} x60 over 3 eager forwards")
        # export --torch reads back through load_pth bit for bit
        pth = os.path.join(tmp, "flagship_exported.pth")
        with _block_form_env({}):
            rc = cli.main(["export", "--checkpoint", CKPT, "--torch", "--out", pth])
        back = load_pth(pth)
        check(rc == 0 and set(back) == set(sd)
              and all(back[k].dtype == torch.float32 and torch.equal(back[k], sd[k].float())
                      for k in sd), "export --torch read back by load_pth bit for bit")
        # the replay, in a fresh process
        spec, result = os.path.join(tmp, "cases.json"), os.path.join(tmp, "replay.json")
        with open(spec, "w") as f:
            json.dump(cases, f)
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", REPLAY, spec, result], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        print(f"[export] replay process: exit {res.returncode} in {time.perf_counter() - t0:.1f} s")
        if res.returncode != 0:
            print(res.stdout[-3000:] + res.stderr[-3000:])
            raise SystemExit("export checks failed: the replay process failed")
        with open(result) as f:
            replay = json.load(f)
        launches = {}
        for (label, form, _, f32, batch, size), (_, _, _, out) in zip(EXPORT_CASES, cases):
            rep = replay[label]
            got = np.load(out)
            diff = np.abs(got - eager[label])
            err, mean = float(diff.max()), float(diff.mean())
            if f32:
                print(f"[check] export {label} artifact vs eager {form}: max_abs_err {err:.3e} "
                      f"(tol 1e-4)")
                check(err <= 1e-4, f"{label} artifact vs eager")
            else:
                print(f"[check] export {label} artifact vs eager {form}: max_abs_err {err:.3e} "
                      f"(tol 0.1), mean {mean:.3e} (tol 1e-2)")
                check(err <= 0.1 and mean <= 1e-2, f"{label} artifact vs eager")
            check(got.shape == inputs[size].shape and rep["dtype"] == "torch.float32"
                  and rep["device"].startswith("cuda"), f"{label} output float32 on the card")
            want = {k: 20 if k in EXPORT_KERNELS[form] else 0 for k in rep["launches"]}
            print(f"[export] {label}: launches per artifact call {rep['launches']}; load "
                  f"{rep['load_s']:.1f} s; median call {rep['ms']:.2f} ms on {card}")
            check(rep["launches"] == want, f"{label} launches 20 of each of {EXPORT_KERNELS[form]}")
            for k, n in rep["launches"].items():
                launches.setdefault(k, {})[label] = n
        print(f"[time] map bf16 8x512² forward, tensor in and out: artifact median "
              f"{replay['map bf16 8x512²']['ms']:.2f} ms, eager {eager_ms:.2f} ms on {card} "
              "(printed only)")
    print(f"[time] phase 23 (export) in {time.perf_counter() - t_phase:.1f} s on {card}")
    if failures:
        raise SystemExit(f"export checks failed: {failures}")
    return launches


# ---- phase 25: windows past 8x8 and heads past 32 channels -------------------

# K3/K4's long-window bodies at kernel level: (N, heads, head_dim) at D 64,
# 9x9 and HAT's 16x16 windows with heads of 10, 16, 40 and 64 channels (A > D
# at 40 and 64), 8x8 windows with heads of 40, and 4x4 windows with one head
# of 64 (bf16 there stays on the CUDA-core body: under 32 tokens)
LONG_ATTN_CASES = [(N, nh, hd) for N in (81, 256) for nh, hd in ((6, 10), (4, 16), (2, 40), (6, 64))
                   ] + [(64, 2, 40), (16, 1, 64)]
TC_LONG = "tensor-core long-window"  # the tensor-core long-window bodies' name
# the long-window bodies' device kernels: the CUDA-core ones (attn_long::,
# nstb_long::nstb_tail) and the tensor-core ones (long_mma::,
# nstb_long::nstb_tail_tc)
LONG_KERNELS = ("attn_long::", "nstb_long::", "long_mma::")
# K2/K8's long-window body: (window side, heads, head_dim) at D 64, hidden 128
LONG_NSTB_CASES = [(16, 6, 10), (16, 4, 16), (9, 2, 40), (16, 6, 64)]
# the window-16 NGswin at the flagship's widths, and with heads of 64 channels
WINDOW16 = {"window_size": 16}
HEAD64 = {"window_size": 16, "head_dim": 64, "dec_head_dim": 64}


def _attn_parts(dparams, ops, params, N, D, nh, hd):
    """K4's concatenated float32 cotangents as the plain version returns
    them (dlogit_scale from the kernel's cotangent on the effective scale)."""
    import torch

    from tmar_torch.ops.attention import LOGIT_SCALE_MAX

    A = nh * hd
    dwqkv, dbqkv, dscale, dbias, dwproj, dbproj = torch.split(
        dparams, [D * 3 * A, 3 * A, nh, nh * N * N, A * D, D])
    dls = dscale * ops[3] * (params[2].reshape(nh) <= LOGIT_SCALE_MAX)
    return [dwqkv.reshape(D, 3 * A), dbqkv, dls.reshape(nh, 1, 1), dbias.reshape(nh, N, N),
            dwproj.reshape(A, D), dbproj]


def _hold_long_attention(label, body, want, x, g, params, nh, mc, ops, out, runs, failures):
    """K3's output and K4's two backward runs on x (``_launch`` /
    ``_launch_backward`` of ``ops``) against the rounding-matched plain
    versions: out and dx at the dtype's tolerance, the parameter cotangents
    at BF16_TOL where their products take bf16 operands (bf16 from 32 tokens
    up, ``cot_bf16``), else F32_TOL; the two runs bit for bit; the rule's
    body ``want``.  Appends to failures on a miss; returns out's error."""
    import torch

    from tmar_torch.ops import cuda_attention as ca

    torch.cuda.synchronize()
    N, D = x.shape[1:]
    dtype, hd = x.dtype, params[4].shape[0] // nh
    got = [out, runs[0][0], *_attn_parts(runs[0][1], ops, params, N, D, nh, hd)]
    ref = [ca.window_attention_kernel_math(x, *params, nh, mask_components=mc),
           *ca.window_attention_backward_math(x, g, *params, nh, mask_components=mc)]
    param_dtype = torch.bfloat16 if dtype == torch.bfloat16 and N >= 32 else torch.float32
    bad, worst, out_err = [], ("", 0.0), 0.0
    for i, (name, a, b) in enumerate(zip(ATTN_NAMES, got, ref)):
        err, tol = err_and_tol(a, b, dtype if i <= 1 else param_dtype)
        if i == 0:
            out_err = err
        if err / max(tol, 1e-30) >= worst[1]:
            worst = (name, err / max(tol, 1e-30))
        if not (err <= tol and bool(torch.isfinite(a).all())):
            bad.append(f"{name} err {err:.3e} > tol {tol:.3e}")
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    if not same:
        bad.append("two backward runs differ")
    if body != want:
        bad.append(f"the rule names {body!r}")
    print(f"[kernel] window_attention {body} body {label}: out and 7 cotangents, "
          f"worst {worst[0]} at {worst[1]:.3f} of its tolerance; two backward runs "
          f"bit-identical: {same} {'ok' if not bad else 'FAIL ' + '; '.join(bad)}")
    if bad:
        failures.append(f"window_attention {body} body {label}")
    del got, ref
    return out_err


def long_attention_kernels(dev, randn, failures):
    """K3's and K4's long-window bodies against the rounding-matched plain
    versions at ``LONG_ATTN_CASES``, 16 windows on a 4x4 grid, the shift mask
    on and off, float32 and bfloat16: the output and dx at the dtype's
    tolerance; the parameter cotangents at F32_TOL where their products take
    float32 operands (float32), at BF16_TOL where they take bf16 ones (bf16
    from 32 tokens up, ``cot_bf16``); two backward runs bit for bit.  The
    rule's body: bf16 from 32 tokens up the tensor-core one, the rest the
    CUDA-core one.  Returns {body name: the largest output error}."""
    import torch

    from tmar_torch.ops import cuda_attention as ca
    from tmar_torch.ops import envelope as env
    from tmar_torch.ops.window import shift_mask_components

    f = ca.fused_window_attention
    before = (f.launches, f.backward_launches, f.launches_by_body.copy(),
              f.backward_launches_by_body.copy(), f.launches_by_n.copy(),
              f.backward_launches_by_n.copy())
    worst_out = {"long-window": 0.0, TC_LONG: 0.0}
    nwin, D = 16, 64
    for N, nh, hd in LONG_ATTN_CASES:
        A, ws = nh * hd, int(round(N ** 0.5))
        params = [randn(D, 3 * A, scale=0.1), randn(3 * A, scale=0.1),
                  randn(nh, 1, 1, scale=0.5, shift=1.2), randn(nh, N, N, scale=0.2),
                  randn(A, D, scale=0.1), randn(D, scale=0.1)]
        for dtype in (torch.float32, torch.bfloat16):
            x, g = randn(nwin, N, D).to(dtype), randn(nwin, N, D).to(dtype)
            body = env.attention_body(N, D, nh, hd, dtype)
            for mc in (None, (*shift_mask_components(ws, ws // 2), 4, 4)):
                dn = str(dtype).split(".")[1]
                label = f"x=[{nwin}, {N}, {D}] heads={nh}x{hd} mask={'on' if mc else 'off'} {dn}"
                ops, geo = ca._kernel_operands(x, *params, nh, mc)
                out, lse = ca._launch(ops, geo)
                runs = [ca._launch_backward(ops, lse, g, geo) for _ in range(2)]
                want = TC_LONG if dtype == torch.bfloat16 and N >= 32 else "long-window"
                err = _hold_long_attention(label, body, want, x, g, params, nh, mc, ops, out,
                                           runs, failures)
                worst_out[body] = max(worst_out[body], err)
                del ops, runs
    (f.launches, f.backward_launches, f.launches_by_body, f.backward_launches_by_body,
     f.launches_by_n, f.backward_launches_by_n) = before
    torch.cuda.empty_cache()
    return worst_out


def _nstb_long_case(randn, ws, nh, hd, D=64, H=128):
    A = nh * hd
    return [randn(D, 3 * A, scale=0.15), randn(3 * A, scale=0.1), randn(nh, 1, 1),
            randn((2 * ws - 1) ** 2, nh, scale=0.5), randn(A, D, scale=0.15), randn(D, scale=0.1),
            (1 + randn(D, scale=0.1), randn(D, scale=0.1)),
            (randn(D, H, scale=0.15), randn(H, scale=0.1)),
            (randn(H, D, scale=0.1), randn(D, scale=0.1)),
            (1 + randn(D, scale=0.1), randn(D, scale=0.1))]


def _hold_long_nstb(label, body, want, z, zt, grid, ref, failures):
    """K2's output z against its plain version ref (F32_TOL at f32; at bf16
    the max within NSTB_BF16_TOL x max|ref|, the mean within NSTB_MEAN_TOL),
    K8's zt on the partitioned windows bit for bit z, the rule's body
    ``want``.  Appends to failures on a miss; returns z's error."""
    import torch

    from tmar_torch.ops.window import window_unpartition

    torch.cuda.synchronize()
    dtype, ws, D = z.dtype, int(round(zt.shape[1] ** 0.5)), z.shape[-1]
    err, tol = err_and_tol(z, ref, dtype)
    mean = float((z.float() - ref.float()).abs().mean())
    mean_ok = True
    if dtype == torch.bfloat16:
        tol = NSTB_BF16_TOL * float(ref.float().abs().max())
        mean_ok = mean <= NSTB_MEAN_TOL
    same = torch.equal(window_unpartition(zt.reshape(-1, ws, ws, D), grid), z)
    ok = err <= tol and mean_ok and same and bool(torch.isfinite(z).all()) and body == want
    print(f"[kernel] nstb {body} body {label}: max_abs_err {err:.3e} tol {tol:.3e}, "
          f"mean {mean:.2e}; K8 bit for bit K2: {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"nstb {body} body {label}")
    return err


def long_nstb_kernels(dev, randn, failures):
    """K2's and K8's long-window body against the rounding-matched plain
    versions at ``LONG_NSTB_CASES`` on a 2 x 2ws x 3ws map (a 2x3 window grid),
    shift 0 (Q 1) and ws/2 (Q 4), float32 (the CUDA-core body, F32_TOL) and
    bfloat16 (the tensor-core body: the max within NSTB_BF16_TOL x max|ref|,
    the mean within NSTB_MEAN_TOL); K8 on the partitioned windows bit for
    bit K2.  Returns {body name: the largest error}."""
    import torch

    from tmar_torch.ops import cuda_nstb as cn
    from tmar_torch.ops import envelope as env
    from tmar_torch.ops.window import cyclic_shift, window_partition

    before = (cn.fused_nstb_map.launches, cn.fused_nstb.launches,
              cn.fused_nstb_map.launches_by_body.copy(), cn.fused_nstb.launches_by_body.copy())
    worst = {"long-window": 0.0, TC_LONG: 0.0}
    for ws, nh, hd in LONG_NSTB_CASES:
        args = _nstb_long_case(randn, ws, nh, hd)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            for shift in (0, ws // 2):
                Q = 1 if shift == 0 else 4
                x = randn(2, 2 * ws, 3 * ws, 64).to(dtype)
                cq = randn(12, Q, 64, scale=0.5).to(dtype)
                with torch.no_grad():
                    z = cn.fused_nstb_map(x, cq, *args, nh, ws, shift)
                    wins, grid = window_partition(cyclic_shift(x, shift), ws)
                    cq4 = cq if Q == 4 else cq.expand(12, 4, 64).contiguous()
                    zt = cn.fused_nstb(wins.reshape(-1, ws * ws, 64).contiguous(), cq4, *args, nh,
                                       ws, shift, grid=grid)
                    ref = cn.nstb_map_math(x, cq, *args, num_heads=nh, window_size=ws, shift=shift)
                body = env.nstb_body(ws * ws, 64, nh, hd, 128, dtype)
                want = TC_LONG if dtype == torch.bfloat16 else "long-window"
                err = _hold_long_nstb(f"x=[2, {2 * ws}, {3 * ws}, 64] window {ws} heads={nh}x{hd} "
                                      f"shift {shift} {dn}", body, want, z, zt, grid, ref, failures)
                worst[body] = max(worst[body], err)
    (cn.fused_nstb_map.launches, cn.fused_nstb.launches, cn.fused_nstb_map.launches_by_body,
     cn.fused_nstb.launches_by_body) = before
    torch.cuda.empty_cache()
    return worst


def attention_core_work(nwin, N, nh, hd):
    """(FLOPs, bytes) of the attention core alone at bf16: S = q·kᵀ and P·v
    per (window, head); q, k, v read once and o written once in bf16, the
    float32 bias [nh, N, N] read once."""
    return nwin * nh * 4 * N * N * hd, 2 * 4 * nwin * N * nh * hd + 4 * nh * N * N


def sdpa_yardstick(x, params, nh, mc):
    """``torch.nn.functional.scaled_dot_product_attention`` on K3's own
    q_n, k_n and v (bf16, from x as the plain version computes them), the
    logit scale folded into q, the bias and shift mask as one float mask
    [nwin, nh, N, N] in bf16: ms per call by CUDA events.  A yardstick of
    the attention core alone; the port never calls it."""
    import torch
    import torch.nn.functional as F

    from tmar_torch.ops.attention import LOGIT_SCALE_MAX, add_shift_mask, split_heads

    wqkv, bqkv, ls, bias = params[:4]
    qkv = x.float() @ wqkv.to(torch.bfloat16).float() + bqkv.float()
    q, k, v = (split_heads(t, nh) for t in qkv.chunk(3, dim=-1))
    qn = q / (q.square().sum(-1, keepdim=True).sqrt() + 1e-12)
    kn = k / (k.square().sum(-1, keepdim=True).sqrt() + 1e-12)
    scale = torch.exp(torch.clamp(ls.float(), max=LOGIT_SCALE_MAX)).reshape(1, nh, 1, 1)
    qs, kb, vb = (qn * scale).bfloat16(), kn.bfloat16(), v.bfloat16()
    nwin, N = x.shape[:2]
    mask = add_shift_mask(bias.float()[None].expand(nwin, nh, N, N), mc).bfloat16().contiguous()
    del qkv, q, k, v, qn, kn
    ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, kb, vb, attn_mask=mask, scale=1.0),
                 iters=5, warmup=1)
    del qs, kb, vb, mask
    torch.cuda.empty_cache()
    return ms


def by_kernel(fn):
    """{kernel: device ms per call} of the long-window kernels
    (``LONG_KERNELS``) of one call of fn, by ``device_profile``."""
    import torch

    from tmar_torch.utils.profiling import device_profile

    def call():  # each call ends on the device, so no call's kernels run into the next's trace step
        fn()
        torch.cuda.synchronize()

    return {r["op"]: r["ms"] for r in device_profile(call, iters=3, top=1 << 30)
            if any(p in r["op"] for p in LONG_KERNELS)}


def _parts(label, parts, card):
    print(f"[profile] {label} by device kernel, ms per call: "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + f" on {card}")


def long_kernel_times(dev, randn, card, failures):
    """The long-window bodies at the window-16 NGswin's stage 1 in the
    8x128² step (512 windows of 256 tokens, D 64, 6 x 10 heads, mask on):
    K3 and K4 by CUDA events over their launches and as device time alone
    (the sum of ``by_kernel``) and by device
    kernel, at bf16 (the tensor-core bodies) and f32 (the CUDA-core ones),
    beside the plain versions and the bounds, and at bf16 the attention
    kernel (``long_mma::attn_fwd_tc``) beside ``sdpa_yardstick`` and the
    attention core's bound; K2 and K8 on that map (8 x 128² x 64, shift 8)
    likewise, and K2 alone at the 8x512² request's stage 1.  At this shape
    K4's rows pass takes 22 windows a group (ragged last group) and the
    token sums and products loop over many tiles a block, which the small
    cases do not reach: each body is first held against its plain version
    here (``_hold_long_attention``, ``_hold_long_nstb``), a miss appended to
    failures.  Returns
    ({dtype name: K3 and K4's times}, {dtype name: K2 and K8's times}), each
    a dict."""
    import torch

    from tmar_torch.ops import cuda_attention as ca
    from tmar_torch.ops import cuda_nstb as cn
    from tmar_torch.ops import envelope as env
    from tmar_torch.ops.window import cyclic_shift, shift_mask_components, window_partition

    f = ca.fused_window_attention
    saved = (f.launches, f.backward_launches, f.launches_by_body.copy(),
             f.backward_launches_by_body.copy(), f.launches_by_n.copy(),
             f.backward_launches_by_n.copy(), cn.fused_nstb_map.launches, cn.fused_nstb.launches,
             cn.fused_nstb_map.launches_by_body.copy(), cn.fused_nstb.launches_by_body.copy())
    nwin, N, D, nh, hd, ws = 512, 256, 64, 6, 10, 16
    A = nh * hd
    params = [randn(D, 3 * A, scale=0.1), randn(3 * A, scale=0.1),
              randn(nh, 1, 1, scale=0.5, shift=1.2), randn(nh, N, N, scale=0.2),
              randn(A, D, scale=0.1), randn(D, scale=0.1)]
    mc = (*shift_mask_components(ws, ws // 2), 8, 8)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        body = env.attention_body(N, D, nh, hd, dtype)
        x, g = randn(nwin, N, D).to(dtype), randn(nwin, N, D).to(dtype)
        ops, geo = ca._kernel_operands(x, *params, nh, mc)
        out, lse = ca._launch(ops, geo)
        runs = [ca._launch_backward(ops, lse, g, geo) for _ in range(2)]
        want = TC_LONG if dtype == torch.bfloat16 else "long-window"
        _hold_long_attention(f"x=[{nwin}, {N}, {D}] heads={nh}x{hd} mask=on {dn} (the timed "
                             f"shape)", body, want, x, g, params, nh, mc, ops, out, runs, failures)
        del out, runs
        torch.cuda.empty_cache()
        k3 = cuda_ms(lambda: ca._launch(ops, geo), iters=5, warmup=1)
        k4 = cuda_ms(lambda: ca._launch_backward(ops, lse, g, geo), iters=5, warmup=1)
        parts3 = by_kernel(lambda: ca._launch(ops, geo))
        parts4 = by_kernel(lambda: ca._launch_backward(ops, lse, g, geo))
        d3, n3, d4, n4 = sum(parts3.values()), len(parts3), sum(parts4.values()), len(parts4)
        _parts(f"K3 {body} body {dn}", parts3, card)
        _parts(f"K4 {body} body {dn}", parts4, card)
        p3 = cuda_ms(lambda: ca.window_attention_kernel_math(x, *params, nh, mask_components=mc),
                     iters=3, warmup=1)
        p4 = cuda_ms(lambda: ca.window_attention_backward_math(x, g, *params, nh, mask_components=mc),
                     iters=3, warmup=1)
        b3 = bound_ms(*attention_work(nwin, N, D, nh, hd, x.element_size(), False), dn)
        b4 = bound_ms(*attention_work(nwin, N, D, nh, hd, x.element_size(), True), dn)
        print(f"[time] window_attention {body} body x=[{nwin}, {N}, {D}] {nh}x{hd} mask on "
              f"{dn}: K3 {k3:.4f} ms (device {d3:.4f} ms in {n3} kernels), K4 {k4:.4f} ms (device "
              f"{d4:.4f} ms in {n4} kernels); plain {p3:.4f} / {p4:.4f} ms; bound {b3[0]:.4f} / "
              f"{b4[0]:.4f} ms by {b3[1]} / {b4[1]} on {card}")
        rows[dn] = {"k3": k3, "k4": k4, "d3": d3, "d4": d4, "p3": p3, "p4": p4, "b3": b3,
                    "b4": b4, "parts3": parts3, "parts4": parts4}
        if dtype == torch.bfloat16:
            lib = sdpa_yardstick(x, params, nh, mc)
            core = bound_ms(*attention_core_work(nwin, N, nh, hd), dn)
            attn = sum(v for k, v in parts3.items() if "attn_fwd" in k)
            print(f"[time] attention core x=[{nwin}, {N}] {nh}x{hd} bf16 mask on: the tensor-core "
                  f"body's attention kernel {attn:.4f} ms, scaled_dot_product_attention (float "
                  f"mask, attention_core_library_ms) {lib:.4f} ms, bound {core[0]:.4f} ms by {core[1]} on {card}")
            rows[dn].update(library=lib, attention=attn, core_bound=core)
        del ops, lse, x, g
        torch.cuda.empty_cache()
    args = _nstb_long_case(randn, ws, nh, hd)
    nrows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        body = env.nstb_body(N, D, nh, hd, 128, dtype)
        x = randn(8, 128, 128, D).to(dtype)
        cq = randn(8 * 64, 4, D, scale=0.5).to(dtype)
        wins, grid = window_partition(cyclic_shift(x, 8), ws)
        wins = wins.reshape(-1, N, D).contiguous()
        with torch.no_grad():
            z = cn.fused_nstb_map(x, cq, *args, nh, ws, 8)
            zt = cn.fused_nstb(wins, cq, *args, nh, ws, 8, grid=grid)
            ref = cn.nstb_map_math(x, cq, *args, num_heads=nh, window_size=ws, shift=8)
        want = TC_LONG if dtype == torch.bfloat16 else "long-window"
        _hold_long_nstb(f"x=[8, 128, 128, {D}] window {ws} heads={nh}x{hd} shift 8 {dn} (the "
                        f"timed shape)", body, want, z, zt, grid, ref, failures)
        del z, zt, ref
        torch.cuda.empty_cache()
        with torch.no_grad():
            k2 = cuda_ms(lambda: cn.fused_nstb_map(x, cq, *args, nh, ws, 8), iters=5, warmup=1)
            k8 = cuda_ms(lambda: cn.fused_nstb(wins, cq, *args, nh, ws, 8, grid=grid), iters=5,
                         warmup=1)
            parts2 = by_kernel(lambda: cn.fused_nstb_map(x, cq, *args, nh, ws, 8))
            parts8 = by_kernel(lambda: cn.fused_nstb(wins, cq, *args, nh, ws, 8, grid=grid))
            d2, n2, d8, n8 = (sum(parts2.values()), len(parts2), sum(parts8.values()),
                              len(parts8))
            _parts(f"K2 {body} body {dn}", parts2, card)
            _parts(f"K8 {body} body {dn}", parts8, card)
            p2 = cuda_ms(lambda: cn.nstb_map_math(x, cq, *args, num_heads=nh, window_size=ws,
                                                  shift=8), iters=3, warmup=1)
            p8 = cuda_ms(lambda: cn.nstb_tokens_math(wins, cq, *args, num_heads=nh,
                                                     window_size=ws, shift=8, grid=grid),
                         iters=3, warmup=1)
        b = bound_ms(*nstb_work(8, 128, 128, nh, 4, x.element_size(), hd=hd, ws=ws), dn)
        print(f"[time] nstb {body} body x=[8, 128, 128, {D}] window {ws} {nh}x{hd} shift 8 "
              f"{dn}: K2 {k2:.4f} ms (device {d2:.4f} ms in {n2} kernels), K8 {k8:.4f} ms (device "
              f"{d8:.4f} ms in {n8} kernels); plain {p2:.4f} / {p8:.4f} ms; bound {b[0]:.4f} ms by "
              f"{b[1]} on {card}")
        nrows[dn] = {"k2": k2, "k8": k8, "d2": d2, "d8": d8, "p2": p2, "p8": p8, "b": b,
                     "parts2": parts2, "parts8": parts8}
        del x, cq, wins
        torch.cuda.empty_cache()
    x = randn(8, 512, 512, D).to(torch.bfloat16)
    cq = randn(8 * 1024, 4, D, scale=0.5).to(torch.bfloat16)
    with torch.no_grad():
        k2_512 = cuda_ms(lambda: cn.fused_nstb_map(x, cq, *args, nh, ws, 8), iters=3, warmup=1)
        parts512 = by_kernel(lambda: cn.fused_nstb_map(x, cq, *args, nh, ws, 8))
    _parts("K2 at the 8x512² request's stage 1, bf16", parts512, card)
    b512 = bound_ms(*nstb_work(8, 512, 512, nh, 4, 2, hd=hd, ws=ws), "bfloat16")
    print(f"[time] nstb {TC_LONG} body x=[8, 512, 512, {D}] window {ws} {nh}x{hd} shift 8 "
          f"bfloat16 (the 8x512² request's stage 1): K2 {k2_512:.4f} ms, bound {b512[0]:.4f} ms "
          f"by {b512[1]} on {card}")
    nrows["bfloat16"].update(k2_512=k2_512, b512=b512)
    del x, cq
    torch.cuda.empty_cache()
    (f.launches, f.backward_launches, f.launches_by_body, f.backward_launches_by_body,
     f.launches_by_n, f.backward_launches_by_n, cn.fused_nstb_map.launches, cn.fused_nstb.launches,
     cn.fused_nstb_map.launches_by_body, cn.fused_nstb.launches_by_body) = saved
    return rows, nrows


def idle_share(fn, wall_ms, label, card):
    """The device's busy time in one call of fn (``device_profile``: every
    kernel, copy and memset, retaken where a launch lost its record) beside
    the call's median wall time: its idle share.  Returns (busy ms, idle
    share)."""
    from tmar_torch.utils.profiling import device_profile

    rows = device_profile(fn, iters=1, top=1 << 30)
    busy = sum(r["ms"] for r in rows)
    print(f"[profile] {label}: device busy {busy:.3f} ms in {sum(r['count'] for r in rows)} "
          f"kernels and copies a call, median wall {wall_ms:.1f} ms, idle share "
          f"{1 - busy / wall_ms:.3f} on {card}; "
          + "; ".join(f"{r['op'][:48]} {r['ms']:.3f}" for r in rows[:6]))
    return busy, 1 - busy / wall_ms


def _capture_nstb(module, name, keep):
    """Wrap ``module.name`` (a whole-block kernel as the blocks call it) so
    that the calls whose index is in ``keep`` record their arguments and
    output; returns (the list of records, a function that puts it back)."""
    original = getattr(module, name)
    calls, kept = [0], []

    def wrapper(*args, **kwargs):
        out = original(*args, **kwargs)
        if calls[0] in keep:
            kept.append((calls[0], args, kwargs, out))
        calls[0] += 1
        return out

    setattr(module, name, wrapper)
    return kept, lambda: setattr(module, name, original)


def _hold_long_serving(form, kept, check):
    """Each kept K2 / K8 call of a window-16 request against its plain
    version on the first image's windows: max within NSTB_BF16_TOL x
    max|ref|, mean within NSTB_MEAN_TOL."""
    import torch

    from tmar_torch.ops import cuda_nstb as cn

    worst = 0.0
    for i, args, kwargs, out in kept:
        x, cq, *weights = args
        nh, ws = weights[-2], weights[-1]
        weights = weights[:-2]
        shift = kwargs.get("shift", 0)
        with torch.no_grad():
            if form == "map":
                per = (x.shape[1] // ws) * (x.shape[2] // ws)
                ref = cn.nstb_map_math(x[:1], cq[:per], *weights, num_heads=nh, window_size=ws,
                                       shift=shift)
                got = out[:1]
            else:
                wh, ww = kwargs["grid"]
                per = wh * ww
                ref = cn.nstb_tokens_math(x[:per], cq[:per], *weights, num_heads=nh,
                                          window_size=ws, shift=shift, grid=(wh, ww))
                got = out[:per]
        d = (got.float() - ref.float()).abs()
        err, mean, scale = float(d.max()), float(d.mean()), float(ref.float().abs().max())
        worst = max(worst, err / scale)
        check(err <= NSTB_BF16_TOL * scale and mean <= NSTB_MEAN_TOL,
              f"window 16, {form} form, launch {i} (x {list(x.shape)}, shift {shift}): first "
              f"image against the plain version, max_abs_err {err:.3e} tol "
              f"{NSTB_BF16_TOL * scale:.3e}, mean {mean:.2e} tol {NSTB_MEAN_TOL:.0e}")
    return worst


def long_window_serving(card, check):
    """The window-16 NGswin at the flagship's widths (random weights from a
    seed) serves 8x512² bf16 in the map form (K1 + K2) and the token form
    (K1 + K8) and one 416² slice (padded to 448², a 7x7 window grid at stage
    3), the counters set to 0 just before each request and read just after:
    20 launches of K1 and 20 of K2 (K8) per forward, all on the tensor-core
    long-window body; the first launch of each stage held to its plain
    version on the first image; outputs finite and in [-1, 1]; the median
    request; and float32 1x128² requests on the card in both forms (20
    launches of K2 / K8 on the CUDA-core long-window body), the map form
    against the CPU.  Returns {kernel row name: its launches}: the
    tensor-core body's on the 8x512² requests, the CUDA-core body's on the
    float32 ones."""
    import torch

    import tmar_torch.nn.blocks as blocks
    from tmar_torch import NGswin, make_inference_fn
    from tmar_torch.ops import cuda_ngram, cuda_nstb

    torch.manual_seed(25)
    model = NGswin(**WINDOW16, dtype=torch.bfloat16)
    sd = model.state_dict()
    tokens = NGswin(**WINDOW16, dtype=torch.bfloat16, nstb_map=False)
    tokens.load_state_dict(sd)
    rng = np.random.default_rng(25)
    req512 = rng.uniform(-1, 1, (8, 512, 512, 1)).astype(np.float32)
    slice416 = rng.uniform(-1, 1, (1, 416, 416, 1)).astype(np.float32)
    launches = {}
    # the first block of each stage: encoder stages of 6, 4, 4 blocks, then the decoder
    keep = {0, 6, 10, 14}
    for form, net, kernel, name in (("map", model, cuda_nstb.fused_nstb_map, "fused_nstb_map"),
                                    ("token", tokens, cuda_nstb.fused_nstb, "fused_nstb")):
        fwd = make_inference_fn(net)
        for req, label in ((req512, "8x512²"), (slice416, "1x416²")):
            kept, restore = _capture_nstb(blocks, name, keep if label == "8x512²" else set())
            cuda_ngram.fused_ngram_context.launches = 0
            kernel.launches = 0
            kernel.launches_by_body.clear()
            try:
                y = fwd(req)
            finally:
                restore()
            k1, k2 = cuda_ngram.fused_ngram_context.launches, kernel.launches
            by_body = dict(kernel.launches_by_body)
            print(f"[serve window 16] {form} form {label} bf16: out {list(y.shape)} range "
                  f"[{y.min():.4f}, {y.max():.4f}], launches ngram_context {k1}, {name[6:]} {k2} "
                  f"by body {by_body}")
            check(bool(np.isfinite(y).all()) and y.min() >= -1 and y.max() <= 1
                  and y.shape == req.shape, f"window 16, {form} form {label}: finite, in [-1, 1]")
            check(k1 == 20 and by_body == {TC_LONG: 20},
                  f"window 16, {form} form {label}: 20 launches of K1 and 20 of "
                  f"{'K2' if form == 'map' else 'K8'}, all on the {TC_LONG} body")
            if label == "8x512²":
                row = "nstb_map" if form == "map" else "nstb_tokens"
                launches[f"{row}_long_tc"] = by_body.get(TC_LONG, 0)
                worst = _hold_long_serving("map" if form == "map" else "tokens", kept, check)
                print(f"[serve window 16] {form} form: the kept launches' largest error "
                      f"{worst:.3e} x max|ref|")
                del kept
        if form == "map":
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                fwd(req512)
                times.append(time.perf_counter() - t0)
            med = statistics.median(times)
            print(f"[time] window-16 full-slice 8x512² bf16 request, map form: median "
                  f"{med * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in times]} on {card}; peak "
                  f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            idle_share(lambda: fwd(req512), med * 1e3,
                       "window-16 full-slice 8x512² bf16 request, map form", card)
        torch.cuda.empty_cache()
    del model, tokens
    # float32 on the card (the CUDA-core long-window body) at 1x128²: the
    # map form against the CPU, the token form's launches
    small = req512[:1, :128, :128]
    for form, kernel, name in (("map", cuda_nstb.fused_nstb_map, "nstb_map"),
                               ("token", cuda_nstb.fused_nstb, "nstb_tokens")):
        on_card = NGswin(**WINDOW16, dtype=torch.float32, nstb_map=form == "map")
        on_card.load_state_dict(sd)
        kernel.launches_by_body.clear()
        y = make_inference_fn(on_card)(small)
        by_body = dict(kernel.launches_by_body)
        launches[f"{name}_long"] = by_body.get("long-window", 0)
        check(by_body == {"long-window": 20}, f"window 16, f32 {form} form at 1x128²: K2 / K8 by "
                                              f"body {by_body}, all on the long-window body")
        if form == "map":
            on_cpu = NGswin(**WINDOW16, dtype=torch.float32, device="cpu")
            on_cpu.load_state_dict(sd)
            d = float(np.abs(y - make_inference_fn(on_cpu, device="cpu")(small)).max())
            check(d <= 1e-4, f"window 16, f32 map form at 1x128² on the card against the CPU: "
                             f"max_abs_err {d:.3e} tol 1e-4")
            del on_cpu
        del on_card
    torch.cuda.empty_cache()
    return launches


def long_window_training(card, check):
    """The promoted ``full`` step of the window-16 NGswin at the flagship's
    widths through the ``Trainer`` (``attn_backward: pallas``, bf16,
    ``fused_pairs``) at 8x128²: 3 steps on one batch with the counters set
    to 0 just before and read just after (20 launches per step of K3 and K4
    on the tensor-core long-window body, at N = 256; K1/K7 and K5/K6 at
    widths they already take), metrics finite, the generator's parameters
    moved; one float32 ``full``-recipe step at 1x128² (20 launches of K3 and
    K4 on the CUDA-core long-window body).  Then the
    ``head_dim=dec_head_dim=64`` model (A = 384 / 256 > D): one map-form
    request and one ``full``-recipe step at 2x256².  Returns {kernel row
    name: its launches}: K3's and K4's on the tensor-core body over the 3
    bf16 steps, on the CUDA-core body in the float32 step."""
    import tempfile

    import torch

    from tmar_torch import (LossWeights, MultiScaleDiscriminator, NGswin, create_train_state,
                            make_inference_fn, make_train_step)
    from tmar_torch.ops import cuda_attention
    from tmar_torch.train import Trainer

    f = cuda_attention.fused_window_attention
    with tempfile.TemporaryDirectory(prefix="tmar_win16_") as tmp:
        cfg = _trainer_config(tmp, **{"model.window_size": 16, "run_name": "window16"})
        m = cfg.model
        check(m.window_size == 16 and m.use_pallas_attention and m.attn_backward == "pallas"
              and cfg.bf16 and cfg.disc.fused_pairs and cfg.variant == "full",
              "window 16: the promoted recipe (full, attn_backward pallas, bf16, fused_pairs)")
        torch.manual_seed(16)
        trainer = Trainer(cfg)
        gen = trainer.state.generator
        before = {k: p.detach().clone() for k, p in gen.named_parameters()}
        batch = _synthetic_batch(TRAIN_BATCH, "cuda")
        history, times = [], []
        f.launches_by_body.clear()
        f.backward_launches_by_body.clear()
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.state, metrics = trainer.train_step(trainer.state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            history.append({k: float(v) for k, v in metrics.items()})
        fwd, bwd = dict(f.launches_by_body), dict(f.backward_launches_by_body)
        moved = sum(not torch.equal(p.detach(), before[k]) for k, p in gen.named_parameters())

        def one_step():
            trainer.state, _ = trainer.train_step(trainer.state, batch)
            torch.cuda.synchronize()

        idle_share(one_step, statistics.median(times) * 1e3,
                   f"window-16 full step, {TRAIN_BATCH}x{TRAIN_PATCH}² bf16", card)
        print(f"[train window 16] {TRAIN_BATCH}x{TRAIN_PATCH}² bf16 full step x3: K3 by body {fwd}, "
              f"K4 by body {bwd}; g_rec {[round(h['g_rec'], 5) for h in history]}; "
              f"{moved} of {len(before)} generator tensors moved; step ms "
              f"{[round(t * 1e3, 1) for t in times]} on {card}")
        check(fwd == {TC_LONG: 60} and bwd == {TC_LONG: 60},
              f"window 16: 20 launches per step of each of K3 and K4, on the {TC_LONG} bodies")
        check(all(np.isfinite(v) for h in history for v in h.values()),
              "window 16: every metric of the 3 steps finite")
        check(moved == len(before), "window 16: every generator parameter moved")
        launches = {"window_attention_fwd_long_tc": fwd.get(TC_LONG, 0),
                    "window_attention_bwd_long_tc": bwd.get(TC_LONG, 0)}
        del trainer, gen, before
        torch.cuda.empty_cache()

    # float32 (the CUDA-core long-window bodies): one full-recipe step at 1x128²
    torch.manual_seed(32)
    gen32 = NGswin(**WINDOW16, dtype=torch.float32, attn_backward="pallas")
    disc32 = MultiScaleDiscriminator(dtype=torch.float32)
    g_opt = torch.optim.Adam(gen32.parameters(), 1e-4, betas=(0.5, 0.999), eps=1e-8)
    d_opt = torch.optim.Adam(disc32.parameters(), 2e-4, betas=(0.5, 0.999), eps=1e-8)
    state = create_train_state(torch.Generator().manual_seed(32), gen32, disc32, g_opt, d_opt,
                               ema_decay=0.999)
    step = make_train_step(gen32, disc32, g_opt, d_opt, LossWeights(phys=0.0), fused_pairs=True,
                           ema_decay=0.999, device="cuda")
    x32 = np.random.default_rng(32).uniform(-1, 1, (1, 128, 128, 1)).astype(np.float32)
    gt32 = np.where(x32 > 0.6, -0.5, 0.5 * x32).astype(np.float32)
    f.launches_by_body.clear()
    f.backward_launches_by_body.clear()
    state, metrics = step(state, {"ct": torch.from_numpy(x32).cuda(),
                                  "gt": torch.from_numpy(gt32).cuda()})
    torch.cuda.synchronize()
    fwd, bwd = dict(f.launches_by_body), dict(f.backward_launches_by_body)
    print(f"[train window 16] 1x128² f32 step: K3 by body {fwd}, K4 by body {bwd}; "
          + " ".join(f"{k} {float(v):.5f}" for k, v in metrics.items()))
    check(fwd == {"long-window": 20} and bwd == {"long-window": 20}
          and all(np.isfinite(float(v)) for v in metrics.values()),
          "window 16, f32: one step, metrics finite, 20 launches of K3 and K4 on the long-window "
          "bodies")
    launches.update(window_attention_fwd_long=fwd.get("long-window", 0),
                    window_attention_bwd_long=bwd.get("long-window", 0))
    del gen32, disc32, state
    torch.cuda.empty_cache()

    # heads of 64 channels: one map-form request, one full-recipe step at 2x256²
    torch.manual_seed(64)
    net = NGswin(**HEAD64, dtype=torch.bfloat16)
    x = np.random.default_rng(64).uniform(-1, 1, (2, 256, 256, 1)).astype(np.float32)
    from tmar_torch.ops import cuda_nstb

    cuda_nstb.fused_nstb_map.launches_by_body.clear()
    y = make_inference_fn(net)(x)
    by_body = dict(cuda_nstb.fused_nstb_map.launches_by_body)
    check(bool(np.isfinite(y).all()) and by_body == {TC_LONG: 20},
          f"head_dim 64: a map-form 2x256² request, finite, K2 by body {by_body}")
    gen = NGswin(**HEAD64, dtype=torch.bfloat16, attn_backward="pallas")
    gen.load_state_dict(net.state_dict())
    disc = MultiScaleDiscriminator(dtype=torch.bfloat16)
    g_opt = torch.optim.Adam(gen.parameters(), 1e-4, betas=(0.5, 0.999), eps=1e-8)
    d_opt = torch.optim.Adam(disc.parameters(), 2e-4, betas=(0.5, 0.999), eps=1e-8)
    state = create_train_state(torch.Generator().manual_seed(64), gen, disc, g_opt, d_opt,
                               ema_decay=0.999)
    step = make_train_step(gen, disc, g_opt, d_opt, LossWeights(phys=0.0), fused_pairs=True,
                           ema_decay=0.999, device="cuda")
    gt = np.where(x > 0.6, -0.5, 0.5 * x).astype(np.float32)
    f.launches_by_body.clear()
    f.backward_launches_by_body.clear()
    state, metrics = step(state, {"ct": torch.from_numpy(x).cuda(), "gt": torch.from_numpy(gt).cuda()})
    torch.cuda.synchronize()
    fwd, bwd = dict(f.launches_by_body), dict(f.backward_launches_by_body)
    print(f"[train head_dim 64] 2x256² bf16 step: K3 by body {fwd}, K4 by body {bwd}; "
          + " ".join(f"{k} {float(v):.5f}" for k, v in metrics.items()))
    check(fwd == {TC_LONG: 20} and bwd == {TC_LONG: 20}
          and all(np.isfinite(float(v)) for v in metrics.values()),
          f"head_dim 64: one step, metrics finite, 20 launches of K3 and K4 on the {TC_LONG} "
          f"bodies")
    del net, gen, disc, state
    torch.cuda.empty_cache()
    return launches


def long_windows(dev, card):
    """Phase 25.  Returns the ``kernels`` line's rows of the long-window
    bodies."""
    import torch

    failures = []

    def check(cond, what):
        print(f"[check] {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            failures.append(what)

    from tmar_torch.ops import envelope as env

    gen = torch.Generator(device="cpu").manual_seed(25)

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

    for N, nh, hd in LONG_ATTN_CASES:
        for lib in ("window_attention_fwd", "window_attention_bwd"):
            for dtype in (torch.float32, torch.bfloat16):
                got = env.built_attention_body(lib, N, 64, nh, hd, dtype)
                if got != env.attention_body(N, 64, nh, hd, dtype):
                    failures.append(f"{lib} body at N={N}, {nh}x{hd}: {got}")
        plan = env.attention_long_plan(N, 64, nh, hd)
        if (env.built_smem("attention_long", N, 64, nh, hd, 1),
                env.built_smem("attention_long", N, 64, nh, hd, 2)) != (plan["fwd"], plan["bwd"]):
            failures.append(f"long-window shared memory at N={N}, {nh}x{hd}")
    for ws, nh, hd in LONG_NSTB_CASES:
        for lib in ("nstb_map", "nstb_tokens"):
            if env.built_smem(lib, ws * ws, 64, nh, hd, 128, 3) != env.nstb_long_plan(
                    ws * ws, 64, nh, hd, 128):
                failures.append(f"{lib} long-window shared memory at window {ws}, {nh}x{hd}")
            for dtype in (torch.float32, torch.bfloat16):
                got = env.built_nstb_body(lib, ws * ws, 64, nh, hd, 128, dtype)
                if got != env.nstb_body(ws * ws, 64, nh, hd, 128, dtype):
                    failures.append(f"{lib} body at window {ws}, {nh}x{hd}: {got}")
    print(f"[check] long-window bodies: the sources' body rule and shared memory equal the "
          f"envelope's: {'ok' if not failures else 'FAIL ' + '; '.join(failures)}")
    attn_err = long_attention_kernels(dev, randn, failures)
    nstb_err = long_nstb_kernels(dev, randn, failures)
    times, ntimes = long_kernel_times(dev, randn, card, failures)
    launches = long_window_serving(card, check)
    launches.update(long_window_training(card, check))
    if failures:
        raise SystemExit(f"long-window checks failed: {failures}")
    shape = "x [512, 256, 64] {}, 6 x 10 heads, mask on (the window-16 8x128² step's stage 1)"
    nshape = "x [8, 128, 128, 64] {}, window 16, 6 x 10 heads, shift 8"
    attn_src, nstb_src = ("tmar_torch/csrc/window_attention_long.cuh",
                          "tmar_torch/csrc/nstb_long.cuh")
    tc_src = "tmar_torch/csrc/long_mma.cuh"
    rows = {}
    # (row, body, source, TPU kernel, dtype the row is timed at)
    for name, body, source, replaces, dn in (
            ("window_attention_fwd_long", "long-window", attn_src,
             "tmar/ops/pallas_attention.py:1143", "float32"),
            ("window_attention_bwd_long", "long-window", attn_src,
             "tmar/ops/pallas_attention.py:568", "float32"),
            ("nstb_map_long", "long-window", nstb_src, "tmar/ops/pallas_nstb.py:640", "float32"),
            ("nstb_tokens_long", "long-window", nstb_src, "tmar/ops/pallas_nstb.py:334",
             "float32"),
            ("window_attention_fwd_long_tc", TC_LONG, tc_src,
             "tmar/ops/pallas_attention.py:1143", "bfloat16"),
            ("window_attention_bwd_long_tc", TC_LONG, tc_src,
             "tmar/ops/pallas_attention.py:568", "bfloat16"),
            ("nstb_map_long_tc", TC_LONG, f"{tc_src}, {nstb_src}", "tmar/ops/pallas_nstb.py:640",
             "bfloat16"),
            ("nstb_tokens_long_tc", TC_LONG, f"{tc_src}, {nstb_src}",
             "tmar/ops/pallas_nstb.py:334", "bfloat16")):
        t, nt = times[dn], ntimes[dn]
        kind = name.split("_long")[0]
        if kind.startswith("window_attention"):
            fwd = kind.endswith("fwd")
            ms, dev_ms, plain, bound = ((t["k3"], t["d3"], t["p3"], t["b3"]) if fwd else
                                        (t["k4"], t["d4"], t["p4"], t["b4"]))
            err, shp = attn_err[body], shape.format(dn)
            parts = t["parts3"] if fwd else t["parts4"]
        else:
            form = "k2" if kind == "nstb_map" else "k8"
            ms, dev_ms = nt[form], nt["d2" if form == "k2" else "d8"]
            plain, bound = nt["p2" if form == "k2" else "p8"], nt["b"]
            err, shp = nstb_err[body], nshape.format(dn)
            parts = nt["parts2" if form == "k2" else "parts8"]
        rows[name] = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "launches": launches[name], "max_abs_err": err, "ms": ms,
                      "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1],
                      "library_ms": None, "device_ms": dev_ms, "device_ms_by_kernel": parts,
                      "body": body, "shape": shp, "card": card}
    bf, nbf = times["bfloat16"], ntimes["bfloat16"]
    rows["window_attention_fwd_long_tc"].update(
        attention_kernel_ms=bf["attention"], attention_core_bound_ms=bf["core_bound"][0],
        attention_core_library_ms=bf["library"])
    rows["nstb_map_long_tc"].update(ms_8x512_stage1=nbf["k2_512"],
                                    bound_ms_8x512_stage1=nbf["b512"][0])
    return rows


# ---- phase 26: every width the JAX NGswin takes, up to D = 512 --------------

# the wide NGswin: the flagship's depths and window at Swin-B's stage-2
# widths (torchvision's swin_b: D 256, 8 heads of 32, mlp_ratio 4) at stages
# 1 and 3 and in the decoder; stage 2 at 2 heads, so that its attention heads
# are 128 channels and its n-gram heads 64
WIDE = {"embed_dim": 256, "dec_dim": 256, "depths": (6, 4, 4), "dec_depths": 6,
        "num_heads": (8, 2, 8), "dec_num_heads": 8, "mlp_ratio": 4.0, "window_size": 8}
WIDE_OVERRIDES = {"model.embed_dim": 256, "model.dec_dim": 256, "model.depths": [6, 4, 4],
                  "model.dec_depths": 6, "model.num_heads": [8, 2, 8], "model.dec_num_heads": 8,
                  "model.mlp_ratio": 4.0}
WIDE_BLOCKS = 20  # NSTBs of the wide NGswin: 6 + 4 + 4 encoder, 6 decoder
# (label, M, D, hidden) of K5/K6: Swin-B's stages 2 and 3, SwinIR's and HAT's
# width, and a hidden width one row of which fits no block (K5 in 2 chunks,
# K6 in 4)
WIDE_FFN_CASES = (("Swin-B stage 2", 16384, 256, 1024), ("Swin-B stage 3", 16384, 512, 2048),
                  ("SwinIR D 180", 16384, 180, 720), ("hidden chunks", 128, 64, 65536))
# (label, windows, N, D, heads, head_dim) of K3/K4
WIDE_ATTN_CASES = (("D 256 8x32", 512, 64, 256, 8, 32), ("D 384 12x32", 512, 64, 384, 12, 32))
# (label, B, wh, ww, C, D, heads, head_dim) of K1/K7: the wide NGswin's
# stage 1 and stage 2 n-gram geometries on a 2x256² request's window grid
WIDE_NGRAM_CASES = (("C 128 8x16", 2, 32, 32, 128, 256, 8, 16),
                    ("C 128 2x64", 2, 32, 32, 128, 256, 2, 64))
# (label, B, map height and width, D, heads, head_dim, hidden) of K2/K8 at window 8
WIDE_NSTB_CASES = (("D 256 8x32", 2, 128, 256, 8, 32, 1024),
                   ("D 512 16x32", 1, 64, 512, 16, 32, 2048))


def wide_smem_failures():
    """The body rule and the shared-memory counts of the sources at phase
    26's widths against ``envelope``'s: -> the geometries where they
    differ."""
    import torch

    from tmar_torch.ops import envelope as env

    built, bad = env.built_smem, []
    for _, _, D, H in WIDE_FFN_CASES:
        fwd, rows, bwd = env.ffn_envelope(D, H)
        rows5, hc5, _, hc6 = env.ffn_tiles(D, H)
        if (built("ffn_fwd", D, hc5, rows5), built("ffn_bwd", D, hc6, rows)) != (fwd, bwd):
            bad.append(("ffn", D, H))
        for dtype in (torch.float32, torch.bfloat16):
            want = env.ffn_body(D, H, dtype)
            if (env.built_ffn_body(D, H, dtype),
                    env.built_ffn_body(D, H, dtype, lib="residual_ffn_fwd")) != (want, want):
                bad.append(("ffn body", str(dtype), D, H))
    for _, _, N, D, nh, hd in WIDE_ATTN_CASES + (("", 0, 64, 256, 2, 128),):
        plan = env.attention_long_plan(N, D, nh, hd)
        if (built("attention_long", N, D, nh, hd, 1), built("attention_long", N, D, nh, hd, 2)) \
                != (plan["fwd"], plan["bwd"]):
            bad.append(("attention long-window", N, D, nh, hd))
        for dtype in (torch.float32, torch.bfloat16):
            want = env.attention_body(N, D, nh, hd, dtype)
            for lib in ("window_attention_fwd", "window_attention_bwd"):
                if env.built_attention_body(lib, N, D, nh, hd, dtype) != want:
                    bad.append(("attention body", lib, str(dtype), N, D, nh, hd))
    for _, _, _, _, C, D, nh, hd in WIDE_NGRAM_CASES + (("", 0, 0, 0, 256, 512, 16, 16),
                                                        ("", 0, 0, 0, 256, 512, 2, 128)):
        if (built("ngram_fwd", C, nh, hd), built("ngram_bwd", C, D, nh, hd, 1),
                built("ngram_bwd", C, D, nh, hd, 2)) != env.ngram_envelope(C, D, nh, hd):
            bad.append(("ngram", C, D, nh, hd))
        for dtype in (torch.float32, torch.bfloat16):
            if (env.built_ngram_body(C, D, nh, hd, dtype), env.built_ngram_body(
                    C, D, nh, hd, dtype, lib="ngram_context")) != (
                    env.ngram_body(C, D, nh, hd, dtype), env.ngram_body(C, D, nh, hd, dtype,
                                                                         forward=True)):
                bad.append(("ngram body", str(dtype), C, D, nh, hd))
    for _, _, _, D, nh, hd, H in WIDE_NSTB_CASES + (("", 0, 0, 256, 2, 128, 1024),):
        for lib in ("nstb_map", "nstb_tokens"):
            if built(lib, 64, D, nh, hd, H, 3) != env.nstb_long_plan(64, D, nh, hd, H):
                bad.append((lib, "long-window", D, nh, hd, H))
            for dtype in (torch.float32, torch.bfloat16):
                if env.built_nstb_body(lib, 64, D, nh, hd, H, dtype) != env.nstb_body(
                        64, D, nh, hd, H, dtype):
                    bad.append((lib, "body", str(dtype), D, nh, hd, H))
    return bad


def wide_kernels(dev, card, failures):
    """Phase 26a: K5/K6, K3/K4 and K1/K7 at phase 26's widths against their
    plain versions (``_hold``: forward and every cotangent, f32 within
    F32_TOL, bf16 within BF16_TOL of the rounding-matched plain versions,
    each backward twice and bit for bit), K2 on the map and K8 on the
    windows of the rolled map (``hold_nstb``: bf16 within NSTB_BF16_TOL, K8
    equal to K2 bit for bit); each one's launch alone by CUDA events beside
    its plain version's and its bound, and its body.  Returns {row name:
    (the first case's numbers at bf16, every case's rows)}."""
    import torch

    from tmar_torch.ops import cuda_ngram, cuda_nstb
    from tmar_torch.ops import envelope as env
    from tmar_torch.ops.attention import window_attention_math
    from tmar_torch.ops.cuda_attention import (
        _PlainAttention, fused_window_attention, window_attention_backward_math,
        window_attention_kernel_math)
    from tmar_torch.ops.cuda_ffn import (
        _PlainFFN, ffn_backward_math, ffn_kernel_math, fused_residual_ffn)
    from tmar_torch.ops.cuda_ngram import (
        _PlainNGram, fused_ngram_context, ngram_context_kernel_backward_math,
        ngram_context_kernel_math, ngram_context_math)
    from tmar_torch.ops.ffn import ffn_math
    from tmar_torch.ops.window import (cyclic_shift, shift_mask_components, window_partition,
                                       window_unpartition)

    gen = torch.Generator(device=dev).manual_seed(26)
    hold = functools.partial(_hold, failures=failures)
    rows = {k: [] for k in ("residual_ffn_fwd", "residual_ffn_bwd", "window_attention_fwd",
                            "window_attention_bwd", "ngram_context", "ngram_context_bwd",
                            "nstb_map", "nstb_tokens")}

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    def plain_ms(plain, acts, params, g, dtype):
        """(forward, backward) ms of the plain version in the activation
        dtype, as the model would run it: a few calls by CUDA events."""
        leaves = [t.to(dtype).clone().requires_grad_() for t in acts] + [
            p.clone().requires_grad_() for p in params]
        with torch.no_grad():
            fwd = cuda_ms(lambda: plain(*leaves), iters=3, warmup=1)
        y = plain(*leaves)
        bwd = cuda_ms(lambda: torch.autograd.grad(y, leaves, g.to(dtype), retain_graph=True),
                      iters=3, warmup=1)
        del y, leaves
        return fwd, bwd

    def record(kernel, label, dn, body, ms, plain_ms, bound, err):
        rows[kernel].append({"geometry": label, "dtype": dn, "body": body, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                             "library_ms": None, "max_abs_err": err})
        print(f"[time] {kernel} {body} body {label} {dn}: kernel {ms:.4f} ms (launch alone), "
              f"plain {plain_ms:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}); library: none "
              f"on {card}", flush=True)

    for label, M, D, H in WIDE_FFN_CASES:
        acts = [randn(M, D), randn(M, D)]
        params = [randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1), randn(D, H, scale=0.05),
                  randn(H, scale=0.1), randn(H, D, scale=0.05), randn(D, scale=0.1),
                  randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1)]
        g = randn(M, D)
        name = f"{label} x=[{M}, {D}] hidden={H}"
        errs = {h: {"float32": 0.0, "bfloat16": 0.0} for h in ("fwd", "bwd")}
        hold("residual_ffn", name, FFN_NAMES, 2, fused_residual_ffn, ffn_math, acts, params, g,
             errs, plain_bf16=lambda a, p, gg: [ffn_kernel_math(a[0], a[1], *p),
                                                *ffn_backward_math(a[0], a[1], *p, gg)],
             param_bf16=True)
        tiles = env.ffn_tiles(D, H)
        print(f"[body] residual FFN {name}: K5 {tiles[0]} rows a tile, {tiles[1]} hidden "
              f"columns a chunk; K6 {tiles[2]}, {tiles[3]}")
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            t = plain_ms((lambda *a: _PlainFFN.apply(*a, 1e-5)) if dtype == torch.bfloat16
                         else ffn_math, acts, params, g, dtype)
            launch = ffn_launch_ms(acts[0].to(dtype), acts[1].to(dtype), params, g.to(dtype),
                                   iters=3, warmup=1)
            size = acts[0].to(dtype).element_size()
            body = env.built_ffn_body(D, H, dtype)
            for i, kernel in enumerate(("residual_ffn_fwd", "residual_ffn_bwd")):
                record(kernel, name, dn, body, launch[i], t[i],
                       bound_ms(*ffn_work(M, size, i == 1, D, H), dn),
                       errs["fwd" if i == 0 else "bwd"][dn])
        del acts, params, g
        torch.cuda.empty_cache()

    for label, nwin, N, D, nh, hd in WIDE_ATTN_CASES:
        A = nh * hd
        acts = [randn(nwin, N, D)]
        params = [randn(D, 3 * A, scale=0.05), randn(3 * A, scale=0.1),
                  torch.rand(nh, 1, 1, generator=gen, device=dev) * 1.8 + 0.5,
                  randn(nh, N, N, scale=0.2), randn(A, D, scale=0.05), randn(D, scale=0.1)]
        g = randn(nwin, N, D)
        mc = (*shift_mask_components(8, 4), 16, 32)
        name = f"{label} x=[{nwin}, {N}, {D}] heads={nh}x{hd} mask=on"
        attention_body_line(f"{label} x=[{nwin}, {N}, {D}] heads={nh}x{hd}", N, D, nh, hd,
                            failures)
        errs = {h: {"float32": 0.0, "bfloat16": 0.0} for h in ("fwd", "bwd")}
        hold("window_attention", name, ATTN_NAMES, 1,
             lambda *a: fused_window_attention(*a, nh, mask_components=mc),
             lambda *a: window_attention_math(
                 a[0], a[1].to(a[0].dtype), a[2].to(a[0].dtype), a[3], a[4],
                 a[5].to(a[0].dtype), a[6].to(a[0].dtype), nh, mask_components=mc),
             acts, params, g, errs,
             plain_bf16=lambda a, p, gg: [
                 window_attention_kernel_math(a[0], *p, nh, mask_components=mc),
                 *window_attention_backward_math(a[0], gg, *p, nh, mask_components=mc)],
             param_bf16=True)
        print(f"[body] window attention {name}: K4's token sums "
              f"{env.long_sum_rows(D, A)} rows a step")
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            t = plain_ms((lambda *a: _PlainAttention.apply(*a, nh, mc)) if dtype == torch.bfloat16
                         else (lambda *a: window_attention_math(*a, nh, mask_components=mc)),
                         acts, params, g, dtype)
            launch = attention_launch_ms(acts[0].to(dtype), params, g.to(dtype), nh, mc, iters=5)
            size = acts[0].to(dtype).element_size()
            body = env.attention_body(N, D, nh, hd, dtype)
            for i, kernel in enumerate(("window_attention_fwd", "window_attention_bwd")):
                record(kernel, name, dn, body, launch[i], t[i],
                       bound_ms(*attention_work(nwin, N, D, nh, hd, size, i == 1), dn),
                       errs["fwd" if i == 0 else "bwd"][dn])
        del acts, params, g
        torch.cuda.empty_cache()

    for label, B, wh, ww, C, D, nh, hd in WIDE_NGRAM_CASES:
        A = nh * hd
        acts = [randn(B, wh, ww, C)]
        params = [randn(C, 3 * A, scale=0.1), randn(3 * A, scale=0.1),
                  torch.rand(nh, 1, 1, generator=gen, device=dev) * 1.8 + 0.5,
                  randn(9, nh, scale=0.5), randn(A, C, scale=0.1), randn(C, scale=0.1),
                  randn(2 * C, D, scale=0.1), randn(D, scale=0.1)]
        g = randn(B, wh, ww, D)
        name = f"{label} u=[{B}, {wh}, {ww}, {C}] D={D} heads={nh}x{hd}"
        errs = {h: {"float32": 0.0, "bfloat16": 0.0} for h in ("fwd", "bwd")}
        hold("ngram_context", name, NGRAM_NAMES, 1, lambda *a: fused_ngram_context(*a, nh),
             lambda *a: ngram_context_math(*a, num_heads=nh), acts, params, g, errs,
             plain_bf16=lambda a, p, gg: [
                 ngram_context_kernel_math(a[0], *p, num_heads=nh),
                 *ngram_context_kernel_backward_math(a[0], gg, *p, num_heads=nh)],
             param_bf16=True)
        print(f"[body] n-gram context {name}: (K1 cells a block, K7 cells a pass-1 tile, "
              f"positions a pass-2 tile) {env.ngram_tiles(C, D, nh, hd)}")
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            t = plain_ms((lambda *a: _PlainNGram.apply(*a, nh)) if dtype == torch.bfloat16
                         else (lambda *a: ngram_context_math(*a, num_heads=nh)),
                         acts, params, g, dtype)
            uu, gg = acts[0].to(dtype), g.to(dtype)
            f = fused_ngram_context
            before = (f.launches, f.backward_launches, dict(f.launches_by_body),
                      dict(f.backward_launches_by_body))
            ops, out, ints = cuda_ngram._kernel_operands(uu, *params, nh)
            k1 = cuda_ms(lambda: cuda_ngram._launch(ops, out, ints), iters=5, warmup=1)
            k7 = cuda_ms(lambda: cuda_ngram._launch_backward(ops[:-1], gg, ints), iters=5, warmup=1)
            f.launches, f.backward_launches = before[:2]
            f.launches_by_body.clear()
            f.launches_by_body.update(before[2])
            f.backward_launches_by_body.clear()
            f.backward_launches_by_body.update(before[3])
            size = uu.element_size()
            body = env.built_ngram_body(C, D, nh, hd, dtype, lib="ngram_context")
            record("ngram_context", name, dn, body, k1, t[0],
                   bound_ms(*ngram_work(B, wh, ww, nh, size, C, D, hd), dn), errs["fwd"][dn])
            record("ngram_context_bwd", name, dn, env.built_ngram_body(C, D, nh, hd, dtype), k7,
                   t[1], bound_ms(*ngram_bwd_work(B, wh, ww, nh, size, C, D, hd), dn),
                   errs["bwd"][dn])
        del acts, params, g
        torch.cuda.empty_cache()

    counters = (cuda_nstb.fused_nstb_map.launches, cuda_nstb.fused_nstb.launches,
                dict(cuda_nstb.fused_nstb_map.launches_by_body),
                dict(cuda_nstb.fused_nstb.launches_by_body))
    ws = 8
    for label, B, side, D, nh, hd, H in WIDE_NSTB_CASES:
        A, N, wh = nh * hd, ws * ws, side // ws
        ln = lambda: (randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1))  # noqa: E731
        args = (randn(D, 3 * A, scale=0.05), randn(3 * A, scale=0.1),
                torch.rand(nh, 1, 1, generator=gen, device=dev) * 1.8 + 0.5,
                randn((2 * ws - 1) ** 2, nh, scale=0.5), randn(A, D, scale=0.05),
                randn(D, scale=0.1), ln(), (randn(D, H, scale=0.05), randn(H, scale=0.1)),
                (randn(H, D, scale=0.05), randn(D, scale=0.1)), ln(), nh, ws)
        x = randn(B, side, side, D)
        name = f"{label} x=[{B}, {side}, {side}, {D}] heads={nh}x{hd} hidden={H} window={ws}"
        errs = {"float32": 0.0, "bfloat16": 0.0, "bf16_mean": 0.0, "bf16_vs_f32_plain": 0.0}
        shift, Q = ws // 2, 4
        cq = randn(B * wh * wh, Q, D, scale=0.5)

        def plain_map(xi, ci, a, cdt=torch.float32):
            return cuda_nstb.nstb_map_math(xi, ci, *a[:-2], num_heads=a[-2], window_size=a[-1],
                                           shift=shift, compute_dtype=cdt)

        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            body = env.built_nstb_body("nstb_map", N, D, nh, hd, H, dtype)
            xx, cc = x.to(dtype), cq.to(dtype)
            zmap = cuda_nstb.fused_nstb_map(xx, cc, *args, shift=shift)
            wins = window_partition(cyclic_shift(xx, shift), ws)[0].reshape(-1, N, D)
            z = cuda_nstb.fused_nstb(wins, cc, *args, shift=shift, grid=(wh, wh))
            ok, line = hold_nstb(zmap, plain_map, xx, cc, args, errs)
            same = torch.equal(window_unpartition(z.reshape(-1, ws, ws, D), (wh, wh)), zmap)
            print(f"[kernel] nstb_map / nstb_tokens {body} body {name} shift={shift} Q={Q} "
                  f"{line}; K8 on the rolled windows equal to K2 bit for bit: {same}", flush=True)
            if not (ok and same):
                failures.append(f"nstb {label} {dn}")
            ops, out, ints = cuda_nstb._kernel_operands(xx, cc, *args, shift=shift)
            tops, tout, tints = cuda_nstb._token_operands(wins, cc, *args, shift, (wh, wh))
            k2 = cuda_ms(lambda: cuda_nstb._launch(ops, out, ints, 1e-5), iters=3, warmup=1)
            k8 = cuda_ms(lambda: cuda_nstb._launch_tokens(tops, tout, tints, 1e-5), iters=3,
                         warmup=1)
            p2 = cuda_ms(lambda: plain_map(xx, cc, args), iters=3, warmup=1)
            p8 = cuda_ms(lambda: cuda_nstb.nstb_tokens_math(
                wins, cc, *args[:-2], num_heads=nh, window_size=ws, shift=shift,
                grid=(wh, wh)), iters=3, warmup=1)
            bound = bound_ms(*nstb_work(B, side, side, nh, Q, xx.element_size(), D, H, hd, ws), dn)
            record("nstb_map", name, dn, body, k2, p2, bound, errs[dn])
            record("nstb_tokens", name, dn, body, k8, p8, bound, errs[dn])
            del ops, out, tops, tout, zmap, z, wins
        del x, cq, args
        torch.cuda.empty_cache()
    cuda_nstb.fused_nstb_map.launches, cuda_nstb.fused_nstb.launches = counters[:2]
    for f, kept in ((cuda_nstb.fused_nstb_map, counters[2]), (cuda_nstb.fused_nstb, counters[3])):
        f.launches_by_body.clear()
        f.launches_by_body.update(kept)
    return rows


def _wide_by_body():
    """{kernel: Counter of launches by body} of the eight wrappers."""
    from tmar_torch.ops import cuda_attention, cuda_ffn, cuda_ngram, cuda_nstb

    a, f, n = (cuda_attention.fused_window_attention, cuda_ffn.fused_residual_ffn,
               cuda_ngram.fused_ngram_context)
    return {"ngram_context": n.launches_by_body, "ngram_context_bwd": n.backward_launches_by_body,
            "nstb_map": cuda_nstb.fused_nstb_map.launches_by_body,
            "nstb_tokens": cuda_nstb.fused_nstb.launches_by_body,
            "window_attention_fwd": a.launches_by_body,
            "window_attention_bwd": a.backward_launches_by_body,
            "residual_ffn_fwd": f.launches_by_body, "residual_ffn_bwd": f.backward_launches_by_body}


def _wide_read():
    return {k: dict(c) for k, c in _wide_by_body().items() if c}


def _wide_zero():
    for c in _wide_by_body().values():
        c.clear()


# the body each kernel of the wide NGswin runs at both dtypes: the
# re-routed whole block and window attention on the long-window bodies,
# K5/K6 and K1/K7 on their CUDA-core generic bodies with tiles sized by width
WIDE_BODY = {"ngram_context": "CUDA-core generic", "ngram_context_bwd": "CUDA-core generic",
             "nstb_map": "long-window", "nstb_tokens": "long-window",
             "window_attention_fwd": "long-window", "window_attention_bwd": "long-window",
             "residual_ffn_fwd": "CUDA-core generic", "residual_ffn_bwd": "CUDA-core generic"}


def wide_model(card, check):
    """Phase 26b: the wide NGswin (``WIDE``, random weights from a seed)
    served at 2x256² bf16 in the map (K1 + K2), token (K1 + K8) and unfused
    (K1 + K3 + K5) forms, each finite in [-1, 1] with 20 launches of each of
    its kernels on ``WIDE_BODY``'s body; a 1x128² f32 request in each form
    against the port's own CPU run of the same weights (within 1e-4); 3
    ``full`` steps at 4x128² bf16 through the ``Trainer`` (K1, K7, K3-K6, 20
    launches each per step), metrics finite; one f32 step at 1x64² on the
    card against the CPU (``compare_step``).  The counters are set to 0
    just before each run and read just after.  Returns {kernel: launches
    by body} over the bf16 requests and steps."""
    import tempfile

    import torch

    from tmar_torch import NGswin, make_inference_fn
    from tmar_torch.data import SyntheticMARDataset
    from tmar_torch.train import Trainer
    from tmar_torch.utils.profiling import device_profile

    forms = (("map", {}, {"ngram_context", "nstb_map"}),
             ("token", {"nstb_map": False}, {"ngram_context", "nstb_tokens"}),
             ("unfused", {"nstb_fused": False},
              {"ngram_context", "window_attention_fwd", "residual_ffn_fwd"}))
    torch.manual_seed(26)
    model = NGswin(**WIDE, dtype=torch.bfloat16)
    sd = {k: v.detach().float() for k, v in model.state_dict().items()}
    nparams = sum(p.numel() for p in model.parameters())
    del model
    rng = np.random.default_rng(26)
    x = rng.uniform(-1, 1, (2, 256, 256, 1)).astype(np.float32)
    total = {}

    def add(got):
        for k, by in got.items():
            for b, n in by.items():
                total.setdefault(k, {}).setdefault(b, 0)
                total[k][b] += n

    for form, kw, kernels in forms:
        net = NGswin(**WIDE, dtype=torch.bfloat16, **kw)
        net.load_state_dict(sd)
        fwd = make_inference_fn(net)
        _wide_zero()
        y = fwd(x)
        got = _wide_read()
        add(got)
        want = {k: {WIDE_BODY[k]: WIDE_BLOCKS} for k in kernels}
        print(f"[wide] {form} form 2x256² bf16 ({nparams} parameters): out {list(y.shape)} range "
              f"[{y.min():.4f}, {y.max():.4f}]; launches by body {got}")
        check(bool(np.isfinite(y).all()) and y.min() >= -1 and y.max() <= 1
              and y.shape == x.shape, f"wide NGswin, {form} form 2x256² bf16: finite, in [-1, 1]")
        check(got == want, f"wide NGswin, {form} form: launches by body {want}")
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print(f"[time] wide NGswin {form}-form 2x256² bf16 request: median "
              f"{statistics.median(times) * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in times]} "
              f"on {card}")
        del net, fwd
        torch.cuda.empty_cache()

    # float32 1x128² in each form against the port's CPU run of the same weights
    small = x[:1, :128, :128]
    on_cpu = NGswin(**WIDE, dtype=torch.float32, device="cpu")
    on_cpu.load_state_dict(sd)
    ref = make_inference_fn(on_cpu, device="cpu")(small)
    del on_cpu
    for form, kw, kernels in forms:
        net = NGswin(**WIDE, dtype=torch.float32, **kw)
        net.load_state_dict(sd)
        _wide_zero()
        y = make_inference_fn(net)(small)
        got = _wide_read()
        d = float(np.abs(y - ref).max())
        check(d <= 1e-4 and got == {k: {WIDE_BODY[k]: WIDE_BLOCKS} for k in kernels},
              f"wide NGswin, f32 {form} form 1x128² on the card against the CPU: max_abs_err "
              f"{d:.3e} tol 1e-4; launches by body {got}")
        del net
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="tmar_wide_") as tmp:
        cfg = _trainer_config(tmp, **{**WIDE_OVERRIDES, "data.batch_size": 4, "run_name": "wide"})
        m = cfg.model
        check((m.embed_dim, tuple(m.depths), tuple(m.num_heads), m.dec_dim, m.dec_depths,
               m.dec_num_heads, m.mlp_ratio, m.window_size, cfg.variant, cfg.bf16)
              == (256, (6, 4, 4), (8, 2, 8), 256, 6, 8, 4.0, 8, "full", True),
              "wide NGswin: the promoted recipe at embed 256, heads 8/2/8 + 8, mlp_ratio 4")
        torch.manual_seed(26)
        trainer = Trainer(cfg)
        batch = _synthetic_batch(4, "cuda")
        history, times = [], []
        _wide_zero()
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.state, metrics = trainer.train_step(trainer.state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            history.append({k: float(v) for k, v in metrics.items()})
        got = _wide_read()
        add(got)
        want = {k: {WIDE_BODY[k]: 3 * WIDE_BLOCKS} for k in WIDE_BODY
                if k not in ("nstb_map", "nstb_tokens")}
        print(f"[wide] 4x128² bf16 full step x3: g_rec {[round(h['g_rec'], 5) for h in history]}; "
              f"step ms {[round(t * 1e3, 1) for t in times]}; launches by body {got} on {card}")
        check(all(np.isfinite(v) for h in history for v in h.values()),
              "wide NGswin: every metric of the 3 full steps finite")
        check(got == want, f"wide NGswin full steps: launches by body {want}")

        def one_step():
            trainer.state, _ = trainer.train_step(trainer.state, batch)
            torch.cuda.synchronize()

        rows = device_profile(one_step, iters=1, top=1 << 30)
        busy = sum(r["ms"] for r in rows)
        print(f"[profile] wide NGswin full step 4x128² bf16: device busy {busy:.1f} ms a step, idle "
              f"share {1 - busy / (statistics.median(times[1:]) * 1e3):.3f} of the median; top: "
              + ", ".join(f"{r['op'][:40]} {r['ms']:.1f} x{r['count']}" for r in rows[:8])
              + f" on {card}")
        del trainer, batch
        torch.cuda.empty_cache()

        # at 64² the discriminator takes two scales (a third's input would be
        # smaller than its kernel), as the demo width's step does
        cfg32 = _trainer_config(tmp, **{**WIDE_OVERRIDES, "bf16": False, "data.batch_size": 1,
                                        "data.patch_size": 64, "disc.num_scales": 2,
                                        "run_name": "wide_f32"})
        on_cpu, on_card = Trainer(cfg32, device="cpu"), Trainer(cfg32)
        sample = SyntheticMARDataset(size=64, length=1, base_seed=7)[0]
        b1 = {k: torch.from_numpy(sample[k][None, ..., None]) for k in ("ct", "gt")}
        _, cpu_m = on_cpu.train_step(on_cpu.state, b1)
        _wide_zero()
        _, gpu_m = on_card.train_step(on_card.state, {k: v.cuda() for k, v in b1.items()})
        torch.cuda.synchronize()
        got = _wide_read()
        check(got == {k: {WIDE_BODY[k]: WIDE_BLOCKS} for k in WIDE_BODY
                      if k not in ("nstb_map", "nstb_tokens")},
              f"wide NGswin f32 step: launches by body {got}")
        compare_step(on_cpu.state, on_card.state, cpu_m, gpu_m, "wide NGswin f32 full step", check,
                     patch=64)
        del on_cpu, on_card
        torch.cuda.empty_cache()
    return total


# each new row of the kernels line: (row, kernel record, source, TPU kernel)
WIDE_ROWS = (
    ("residual_ffn_fwd_wide", "residual_ffn_fwd", "tmar_torch/csrc/residual_ffn_fwd.cu",
     "tmar/ops/pallas_ffn.py:352"),
    ("residual_ffn_bwd_wide", "residual_ffn_bwd", "tmar_torch/csrc/residual_ffn_bwd.cu",
     "tmar/ops/pallas_ffn.py:249"),
    ("window_attention_fwd_wide", "window_attention_fwd",
     "tmar_torch/csrc/window_attention_long.cuh", "tmar/ops/pallas_attention.py:1143"),
    ("window_attention_bwd_wide", "window_attention_bwd",
     "tmar_torch/csrc/window_attention_long.cuh", "tmar/ops/pallas_attention.py:568"),
    ("ngram_context_wide", "ngram_context", "tmar_torch/csrc/ngram_context.cu",
     "tmar/ops/pallas_ngram.py:813"),
    ("ngram_context_bwd_wide", "ngram_context_bwd", "tmar_torch/csrc/ngram_context_bwd.cu",
     "tmar/ops/pallas_ngram.py:520"),
    ("nstb_map_wide", "nstb_map", "tmar_torch/csrc/nstb_long.cuh", "tmar/ops/pallas_nstb.py:640"),
    ("nstb_tokens_wide", "nstb_tokens", "tmar_torch/csrc/nstb_long.cuh",
     "tmar/ops/pallas_nstb.py:334"),
)


def wide_widths(dev, card):
    """Phase 26: every width the JAX NGswin takes, up to D = 512.  Returns
    the ``kernels`` line's rows of the re-routed and resized bodies: each
    timed at its first geometry at bf16, its launches those of the wide
    NGswin's bf16 requests and steps."""
    import torch

    failures = []

    def check(cond, what):
        print(f"[check] {what}: {'ok' if cond else 'FAIL'}", flush=True)
        if not cond:
            failures.append(what)

    bad = wide_smem_failures()
    check(not bad, f"phase 26's widths: the sources' body rule and shared memory equal the "
                   f"envelope's {bad or ''}")
    t0 = time.perf_counter()
    rows = wide_kernels(dev, card, failures)
    print(f"[time] phase 26a (kernels at the new widths) in {time.perf_counter() - t0:.1f} s on "
          f"{card}")
    launches = wide_model(card, check)
    if failures:
        raise SystemExit(f"phase 26 checks failed: {failures}")
    out = {}
    for name, kernel, source, replaces in WIDE_ROWS:
        first = next(r for r in rows[kernel] if r["dtype"] == "bfloat16")
        out[name] = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches.get(kernel, {}).get(WIDE_BODY[kernel], 0),
                     "max_abs_err": max(r["max_abs_err"] for r in rows[kernel]),
                     "ms": first["ms"], "plain_ms": first["plain_ms"],
                     "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                     "library_ms": None, "body": first["body"], "shape": first["geometry"],
                     "widths": rows[kernel], "card": card}
    torch.cuda.empty_cache()
    return out


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
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"[build] {name}: {len(regs)} kernel instantiations, at most {max(regs, default=0)} "
              f"registers, {sum(spills)} bytes of spill stores in all")

    sd = load_pth(CKPT)
    dev = torch.device("cuda")
    ref_model = NGswin(dtype=torch.float32)
    ref_model.load_state_dict(sd)
    with torch.no_grad():
        records = check_kernels(ref_model, dev, card)
        records["nstb_tokens"] = check_token_kernel(ref_model, dev, card)
    del ref_model
    torch.cuda.empty_cache()

    launches, req512, map_out, map_med = serve(sd, card)
    launches = {k.replace("fused_", ""): v for k, v in launches.items()}
    form_launches, unfused_cases = serve_forms(sd, card, req512, map_out, map_med)
    launches["nstb_tokens"] = form_launches["tokens"]["nstb_tokens"]
    del req512, map_out
    serve_entry_point(sd, card)

    records.update(check_train_kernels(dev, card))
    # every attention kernel name of the JAX package maps to K3
    records["window_attention_fwd"]["variants"] = check_attention_impls(dev, card)
    for name, cases in unfused_cases.items():
        records[name]["launches_unfused_serving"] = form_launches["unfused"][name]
        records[name]["unfused_serving_cases"] = cases
    train_launches, trained = train(card)
    launches.update({k: v for k, v in train_launches.items() if k not in launches})
    train_correctness(trained, card)
    del trained
    torch.cuda.empty_cache()
    check_radon(card)
    full_launches = train_full(card)
    launches.update({k: v for k, v in full_launches.items() if k not in launches or not launches[k]})
    data_launches = data_phases(card)
    train_ngram3(card)
    t0 = time.perf_counter()
    v1_launches = train_v1(card)
    dudo_pickle = finetune_phases(card)
    dcgan_phase(card)
    print(f"[time] phases 17-19 (v1, finetune, dcgan) in {time.perf_counter() - t0:.1f} s on {card}")
    t0 = time.perf_counter()
    width_rows = check_width_kernels(dev, card)
    width_rows.update(check_width_nstb(dev, card))
    demo_launches = demo_width(card)
    print(f"[time] phase 20 (other widths, the demo width) in {time.perf_counter() - t0:.1f} s on "
          f"{card}")
    eval_launches = eval_phase(card, dudo_pickle)
    parallel_launches = parallel_phase(card)
    export_launches = export_phase(card)
    t0 = time.perf_counter()
    forms_launches = train_forms(card)
    print(f"[time] phase 24 (the default model form) in {time.perf_counter() - t0:.1f} s on {card}")
    t0 = time.perf_counter()
    long_rows = long_windows(dev, card)
    print(f"[time] phase 25 (windows past 8x8, heads past 32 channels) in "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    t0 = time.perf_counter()
    wide_rows = wide_widths(dev, card)
    print(f"[time] phase 26 (widths past the envelope, up to D = 512) in "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    for name, rec in records.items():
        # launches: the count of the first path above that ran the kernel
        # (serving, composition training, the trainer's full step)
        rec["launches"] = launches[name]
        rec["launches_full_step_path"] = full_launches.get(name, 0)
        rec["launches_spineweb_fit"] = data_launches.get(name, 0)
        rec["launches_v1_step_path"] = v1_launches.get(name, 0)
        rec["launches_demo_step_path"] = demo_launches.get(name, 0)
        rec["launches_eval_path"] = eval_launches.get(name, 0)
        rec["launches_parallel_path"] = parallel_launches.get(name, {})
        rec["launches_export_path"] = export_launches.get(name, {})
        rec["launches_default_form_step_path"] = forms_launches.get(name, 0)
        rec["widths"] = width_rows.get(name, [])
        rec["card"] = card
    records.update(long_rows)
    records.update(wide_rows)
    print(json.dumps({"kernels": list(records.values())}))
    print(f"{card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
