"""Build and bind the hand-written CUDA kernels under ``tmar_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use, by its own ``nvcc`` process, into ``kernels/_build/<name>-<hash>.so``
(the hash covers the source, every header under ``csrc/`` and the flags, so
an edited source or header rebuilds).
The library is loaded with ``ctypes``: every pointer and the CUDA stream go
in as ``c_void_p``, and the entry point returns ``cudaGetLastError()``.

Each kernel's launch is also a ``torch.library`` operator, ``tmar::<name>``
(``define_op``), with a CUDA implementation and a fake one that gives the
outputs' shapes and dtypes, so that ``torch.export`` records the launch as
one node of the graph and a loaded program launches the kernel again.

Nothing here builds at import time: this module is imported on hosts without
``nvcc`` or a card, where only the plain PyTorch versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "kernels", "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
KERNELS = (
    "ngram_context", "ngram_context_bwd", "nstb_map", "nstb_tokens",
    "window_attention_fwd", "window_attention_bwd",
    "residual_ffn_fwd", "residual_ffn_bwd",
)
# every header under csrc/ (common.cuh for the kernels with a backward, the
# whole-block bodies of nstb_map and nstb_tokens): part of every hash
HEADERS = tuple(sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")))

_libs: Dict[str, ctypes.CDLL] = {}
_ops = None  # the torch.library fragment of the namespace ``tmar``
_lock = threading.Lock()
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a CUDA host")
    return found


def _target(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha1()
    for path in (src, *(os.path.join(CSRC, f) for f in HEADERS)):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns {name: library path}; raises with
    the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs: List = []
    for n, out in targets.items():
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, out, tmp, p in procs:
        log, _ = p.communicate()
        build_logs[n] = log
        if p.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {p.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


def _library(name: str) -> ctypes.CDLL:
    """Kernel library ``name``, built and loaded on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            getattr(lib, f"tmar_{name}").restype = ctypes.c_int
            getattr(lib, f"tmar_{name}_error").restype = ctypes.c_char_p
            getattr(lib, f"tmar_{name}_error").argtypes = [ctypes.c_int]
            _libs[name] = lib
    return lib


def entry(name: str, argtypes: List) -> ctypes._CFuncPtr:
    """The C entry point ``tmar_<name>`` of kernel library ``name`` (built
    and loaded on first use), with its argument types set."""
    fn = getattr(_library(name), f"tmar_{name}")
    fn.argtypes = argtypes
    return fn


def host_function(name: str, symbol: str, argtypes: List, restype) -> ctypes._CFuncPtr:
    """Another C function of kernel library ``name`` (a host-side query,
    such as a workspace size), with its argument and result types set."""
    fn = getattr(_library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


_entries: Dict[str, ctypes._CFuncPtr] = {}
_sm_counts: Dict[int, int] = {}


def launch(name: str, argtypes: List, device, *args) -> None:
    """Call kernel ``name``'s entry point with ``args`` followed by
    ``device``'s current CUDA stream, and raise if it returns a CUDA error.
    ``argtypes`` are those of the whole call, the stream included."""
    import torch

    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = entry(name, argtypes)
    if torch.cuda.current_device() == device.index:
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(name, err)


def sm_count(device) -> int:
    """The number of SMs of a CUDA device: the persistent kernels launch at
    most one block per SM."""
    import torch

    n = _sm_counts.get(device.index)
    if n is None:
        n = _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def check(name: str, err: int) -> None:
    """Raise if kernel ``name``'s entry point returned a CUDA error code."""
    if err != 0:
        msg = getattr(_libs[name], f"tmar_{name}_error")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def define_op(name: str, schema: str, cuda, fake):
    """Define the operator ``tmar::<name>`` with ``schema`` (its arguments
    and results, as ``torch.library`` writes them): ``cuda`` runs it on CUDA
    tensors (puts the operands on 16-byte boundaries, launches the kernel,
    counts the launch),
    ``fake`` returns empty outputs of the right shapes and dtypes without
    touching data, for tracing.  It has no CPU implementation: the wrappers
    run the plain versions on CPU tensors.  Returns the operator."""
    import torch

    global _ops
    if _ops is None:
        _ops = torch.library.Library("tmar", "FRAGMENT")
    _ops.define(name + schema)
    _ops.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"tmar::{name}", fake, lib=_ops)
    return getattr(torch.ops.tmar, name).default
