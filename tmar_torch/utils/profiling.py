"""Profiling and timing utilities (the counterpart of ``tmar.utils.profiling``).

Wall timing bracketed by a wait on the CUDA streams of the result (the
counterpart of ``jax.block_until_ready``); FLOPs counted by
``torch.utils.flop_counter``; ``torch.profiler`` traces in place of
``jax.profiler``'s, aggregated per op without TensorBoard.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


def synchronize(result) -> None:
    """Wait until the work that produced ``result`` is done: the current
    CUDA stream of every device that holds a tensor in it (tensors at any
    depth of tuples, lists and dicts)."""
    devices = set()
    stack = [result]
    while stack:
        obj = stack.pop()
        if isinstance(obj, torch.Tensor):
            if obj.is_cuda:
                devices.add(obj.device)
        elif isinstance(obj, dict):
            stack.extend(obj.values())
        elif isinstance(obj, (list, tuple)):
            stack.extend(obj)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class StepTimer:
    """Synchronized per-step timing with percentile summary
    (the reference's per-sample timing, test_transmar_syndeeplesion.py:929-938)."""

    def __init__(self):
        self.times: List[float] = []

    @contextlib.contextmanager
    def measure(self, result_getter: Optional[Callable] = None):
        t0 = time.perf_counter()
        yield
        if result_getter is not None:
            synchronize(result_getter())
        self.times.append(time.perf_counter() - t0)

    def time_fn(self, fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
        for _ in range(warmup):
            synchronize(fn(*args))
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn(*args)
            synchronize(out)
            self.times.append(time.perf_counter() - t0)
        return self.summary()["mean"]

    def summary(self) -> Dict[str, float]:
        t = np.asarray(self.times)
        if t.size == 0:
            return {}
        return {
            "mean": float(t.mean()),
            "median": float(np.median(t)),
            "p5": float(np.percentile(t, 5)),
            "p95": float(np.percentile(t, 95)),
            "n": int(t.size),
        }


@contextlib.contextmanager
def trace_profile(logdir: str, schedule: Optional[Callable] = None):
    """A ``torch.profiler`` trace of the host and, where there is a card, of
    the device, written into ``logdir`` as a ``*.pt.trace.json`` (Chrome
    trace format; TensorBoard's profiler plugin and ``parse_trace_device_ops``
    read it).  Yields the profiler; with a ``torch.profiler.schedule``, the
    caller marks each step with ``prof.step()``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, schedule=schedule,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def model_flops(fn: Callable, *args) -> float:
    """The FLOPs of one call ``fn(*args)``, as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (a product of
    [m, k] and [k, n] is 2·m·k·n).  The kernels' operators (``tmar::*``)
    count 0, as XLA counts none for a ``pallas_call`` without a cost
    estimate (none in ``tmar/ops/pallas_*.py`` has one); on the CPU the plain
    versions run and are counted."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


# trace event categories of the device lanes in a torch.profiler trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _coarse(name: str) -> str:
    """A kernel or op name without its template arguments, parameter list
    and anonymous namespace (``void (anonymous namespace)::k<4, float>(int,
    float*)`` -> ``k``), so that one kernel's instantiations and calls
    collapse into one row."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return (name[:min(cut)] if cut else name).strip()


def _trace_events(logdir: str) -> List[Dict]:
    """The complete ("X") events of the trace files in ``logdir``."""
    import glob
    import gzip
    import json

    events = []
    for path in sorted(glob.glob(os.path.join(logdir, "**", "*.json*"), recursive=True)):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            events += [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    return events


def lost_launches(logdir: str) -> int:
    """The kernel launches in the traces of ``logdir`` (host API events
    named ``*Launch*``) whose device record is missing: no ``kernel``,
    ``gpu_memcpy`` or ``gpu_memset`` event has their correlation id."""
    events = _trace_events(logdir)
    recorded = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") in DEVICE_CATEGORIES}
    return sum(1 for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "Launch" in e.get("name", "")
               and e.get("args", {}).get("correlation") not in recorded)


def parse_trace_device_ops(logdir: str, top: int = 30) -> List[Dict]:
    """Aggregate the op times of the ``trace_profile`` traces in ``logdir``
    (a text-mode substitute for the trace viewer).

    Returns [{"op": <coarse name>, "ms": total, "count": n}, ...] sorted by
    time: over the device lanes' events (categories ``kernel``,
    ``gpu_memcpy``, ``gpu_memset``) where the traces have any, else, as on
    the CPU, over the host's ``cpu_op`` events (nested ops each counted)."""
    from collections import defaultdict

    events = _trace_events(logdir)
    cats = DEVICE_CATEGORIES if any(e.get("cat") in DEVICE_CATEGORIES for e in events) \
        else ("cpu_op",)
    agg: Dict[str, float] = defaultdict(float)
    cnt: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.get("cat") in cats:
            kind = _coarse(e.get("name", ""))
            agg[kind] += e.get("dur", 0) / 1e3
            cnt[kind] += 1
    rows = [
        {"op": k, "ms": round(v, 3), "count": cnt[k]}
        for k, v in sorted(agg.items(), key=lambda kv: -kv[1])
    ]
    return rows[:top]


def device_profile(fn: Callable, *args, iters: int = 3, top: int = 30,
                   attempts: int = 3) -> List[Dict]:
    """One-call profile of ``fn(*args)``: runs it ``iters`` times under a
    ``torch.profiler`` trace (after one untraced call) and returns the
    aggregated per-op times, ms per iteration, on the device where there is
    one (the host's ops on the CPU).

    The trace opens with one more call, which the profiler runs but does
    not keep: on the card a trace otherwise loses the device records of its
    first launches, more of them the longer the process has run.  A trace
    that still lost any (``lost_launches``) is taken again, up to
    ``attempts`` traces."""
    import tempfile

    from torch.profiler import schedule

    synchronize(fn(*args))
    for _ in range(attempts):
        with tempfile.TemporaryDirectory() as logdir:
            with trace_profile(logdir, schedule(wait=0, warmup=1, active=iters, repeat=1)) as prof:
                for _ in range(1 + iters):
                    synchronize(fn(*args))
                    prof.step()
            rows = parse_trace_device_ops(logdir, top=top)
            lost = lost_launches(logdir)
        if not lost:
            break
    for r in rows:
        # ms is per ITERATION; count stays the total over the trace so
        # one-time ops (count < iters) are visible rather than floored to 0
        r["ms"] = round(r["ms"] / iters, 3)
    return rows
