"""The port's logging and profiling utilities (``tmar_torch.utils``) against
the JAX package's (``tmar.utils``), on the CPU: the metric files byte for
byte, the timer's summary keys, the FLOPs of one matmul, and the per-op
profile rows, here of the host's ops (there is no device lane on the CPU);
the device-lane branch and the count of lost device records on trace files
written here."""

import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.utils import MetricLogger as JaxMetricLogger
from tmar.utils import StepTimer as JaxStepTimer
from tmar.utils import model_flops as jax_model_flops
from tmar.utils.logging import setup_logging as jax_setup_logging
from tmar_torch.utils import MetricLogger, StepTimer, model_flops, trace_profile
from tmar_torch.utils.logging import setup_logging
from tmar_torch.utils import profiling
from tmar_torch.utils.profiling import _coarse, device_profile, lost_launches, parse_trace_device_ops
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

ROWS = [(0, {"g_rec": 0.5, "d_loss": 1.25}, ""), (10, {"g_rec": 0.25}, ""),
        (10, {"psnr": 31.5, "ssim": 0.875}, "Val/")]


def test_metric_logger_writes_the_jax_files(tmp_path):
    written = {}
    for name, cls in (("jax", JaxMetricLogger), ("port", MetricLogger)):
        logger = cls(str(tmp_path / name))
        for step, metrics, prefix in ROWS:
            logger.log(step, metrics, prefix=prefix)
        logger.flush("history")
        written[name] = {f: (tmp_path / name / f).read_bytes()
                         for f in ("history.csv", "history.json")}
    assert written["port"] == written["jax"]


def test_setup_logging_splits_file_and_console_as_jax(tmp_path):
    got = setup_logging(str(tmp_path / "port" / "run.log"), name="tmar_torch_test")
    ref = jax_setup_logging(str(tmp_path / "jax" / "run.log"), name="tmar_jax_test")
    for lg in (got, ref):
        assert [(type(h).__name__, h.level) for h in lg.handlers] == [
            ("StreamHandler", logging.INFO), ("FileHandler", logging.DEBUG)]
        lg.debug("to the file only")
        for h in lg.handlers:
            h.close()
    assert os.path.getsize(tmp_path / "port" / "run.log") > 0


def test_step_timer_summary_has_the_jax_keys():
    a = torch.ones(64, 64)
    port, ref = StepTimer(), JaxStepTimer()
    assert port.time_fn(torch.matmul, a, a, iters=3, warmup=1) > 0
    ref.time_fn(jnp.matmul, jnp.ones((64, 64)), jnp.ones((64, 64)), iters=3, warmup=1)
    with port.measure(lambda: a @ a):
        pass
    assert port.summary().keys() == ref.summary().keys() and port.summary()["n"] == 4
    assert StepTimer().summary() == JaxStepTimer().summary() == {}


def test_model_flops_of_a_matmul_equals_jax():
    a = np.random.default_rng(0).standard_normal((128, 128)).astype(np.float32)
    ref = jax_model_flops(jnp.matmul, jnp.asarray(a), jnp.asarray(a))
    assert model_flops(torch.matmul, torch.from_numpy(a), torch.from_numpy(a)) == ref == 2 * 128**3


def test_device_profile_rows_have_the_jax_schema():
    a = torch.ones(128, 128)
    rows = device_profile(lambda: a @ a, iters=3)
    assert rows and all(set(r) == {"op", "ms", "count"} and isinstance(r["op"], str)
                        and isinstance(r["ms"], float) and isinstance(r["count"], int)
                        for r in rows)
    mm = [r for r in rows if r["op"].endswith("mm")]
    assert mm and mm[0]["count"] == 3
    assert [r["ms"] for r in rows] == sorted((r["ms"] for r in rows), reverse=True)


@pytest.mark.parametrize("top", [1, 30])
def test_parse_trace_reads_what_trace_profile_wrote(tmp_path, top):
    a = torch.ones(32, 32)
    with trace_profile(str(tmp_path)):
        for _ in range(2):
            torch.relu(a @ a)
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))
    rows = parse_trace_device_ops(str(tmp_path), top=top)
    assert len(rows) == min(top, len(parse_trace_device_ops(str(tmp_path), top=100)))
    counts = {r["op"]: r["count"] for r in parse_trace_device_ops(str(tmp_path), top=100)}
    assert counts["aten::relu"] == 2 and counts["aten::mm"] == 2


@pytest.mark.parametrize("name,coarse", [
    ("void (anonymous namespace)::nstb_mma_kernel<true, 6>(float const*, int)", "nstb_mma_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
     "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)",
     "at::native::vectorized_elementwise_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
    ("aten::mm", "aten::mm"),
])
def test_coarse_names_collapse_instantiations(name, coarse):
    assert _coarse(name) == coarse


def test_parse_trace_takes_the_device_lanes_where_there_are_any(tmp_path):
    """A trace with device events (as on the card) aggregates only the
    kernels, copies and sets, by coarse name."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "void k<1>(int)", "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "void k<2>(float)", "dur": 500},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "dur": 250},
        {"ph": "i", "cat": "kernel", "name": "k", "dur": 7},
    ]
    (tmp_path / "host.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    assert parse_trace_device_ops(str(tmp_path)) == [
        {"op": "k", "ms": 1.5, "count": 2}, {"op": "Memcpy DtoH", "ms": 0.25, "count": 1}]


def test_lost_launches_counts_the_launches_without_a_device_record(tmp_path):
    events = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemsetAsync", "args": {"correlation": 4}},
        {"ph": "X", "cat": "kernel", "name": "k", "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "args": {"correlation": 3}},
    ]
    (tmp_path / "host.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    assert lost_launches(str(tmp_path)) == 1


def test_device_profile_retakes_a_trace_that_lost_device_records(monkeypatch):
    """One untraced call, then traces of a warm-up call and ``iters`` kept
    ones until a trace has lost no device record."""
    lost = iter([2, 0])
    monkeypatch.setattr(profiling, "lost_launches", lambda logdir: next(lost))
    calls = []
    a = torch.ones(16, 16)
    rows = device_profile(lambda: calls.append(1) or a @ a, iters=2)
    assert len(calls) == 1 + 2 * (1 + 2)
    assert [r["count"] for r in rows if r["op"] == "aten::mm"] == [2]
