"""The port stands alone and stays off the CPU unless asked: tmar_torch
imports no JAX, flax or tmar module; its entry points default to CUDA and
raise without a card; CPU tensors take the plain versions and launch nothing."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import tmar_torch
from tmar_torch import NGswin, make_inference_fn
from tmar_torch import kernels
from tmar_torch.ops import cuda_ngram, cuda_nstb

PKG = pathlib.Path(tmar_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tmar")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_import_loads_no_jax_or_tmar():
    mods = sorted(
        "tmar_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import tmar_torch\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(PKG.parent))
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_no_jax_or_tmar():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), f"{path}: imports {names}"


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NGswin()
    model = NGswin(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 2, 2), dec_dim=32,
                   dec_depths=2, dec_num_heads=2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_inference_fn(model)


def test_cpu_forward_takes_plain_versions_and_launches_nothing(monkeypatch):
    monkeypatch.setattr(cuda_ngram.fused_ngram_context, "launches", 0)
    monkeypatch.setattr(cuda_nstb.fused_nstb_map, "launches", 0)
    model = NGswin(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 2, 2), dec_dim=32,
                   dec_depths=2, dec_num_heads=2, device="cpu")
    x = np.random.default_rng(0).uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
    y = make_inference_fn(model, device="cpu")(x)
    assert y.shape == x.shape and np.isfinite(y).all()
    assert cuda_ngram.fused_ngram_context.launches == 0
    assert cuda_nstb.fused_nstb_map.launches == 0
    assert not kernels._libs


def test_wrappers_refuse_other_devices():
    u = torch.zeros(1, 2, 2, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_ngram.fused_ngram_context(u, *([None] * 8), 6)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_nstb.fused_nstb_map(torch.zeros(1, 8, 8, 64, device="meta"), None, *([None] * 10),
                                 6, 8)
