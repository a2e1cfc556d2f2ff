"""The port stands alone and stays off the CPU unless asked: tmar_torch
imports no JAX, flax or tmar module; its entry points default to CUDA and
raise without a card; CPU tensors take the plain versions and launch nothing;
the forward-only kernel refuses to run where autograd would record it."""

import ast
import fnmatch
import pathlib
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import torch

import tmar_torch
from tmar_torch import NGswin, make_inference_fn
from tmar_torch import kernels
from tmar_torch.device import refuse_grad
from tmar_torch.ops import cuda_attention, cuda_ffn, cuda_ngram, cuda_nstb

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


# the modules of the trainer slice: each is among those the two tests around
# this list import and scan
TRAINER_SLICE = (
    "ops/radon.py", "train/schedules.py", "train/config.py", "train/variants.py",
    "train/trainer.py", "checkpoint/io.py", "data/transforms.py", "data/synthetic.py",
    "data/loader.py", "eval/metrics.py", "utils/tfevents.py",
)


def test_trainer_slice_modules_are_in_the_package_and_scanned():
    scanned = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert set(TRAINER_SLICE) <= scanned
    for sub in ("data", "utils", "train", "checkpoint", "eval", "ops"):
        assert (PKG / sub / "__init__.py").is_file(), sub


def test_package_data_patterns_cover_every_kernel_source_header_and_config():
    """An installed tmar_torch must hold what ``kernels.build`` compiles and
    hashes and what ``config_path`` finds."""
    with open(PKG.parent / "pyproject.toml", "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"]["tmar_torch"]
    needed = [f"csrc/{k}.cu" for k in kernels.KERNELS] + [f"csrc/{h}" for h in kernels.HEADERS]
    needed += [p.relative_to(PKG).as_posix() for p in (PKG / "configs").glob("*.yaml")]
    assert len(needed) == len(kernels.KERNELS) + len(kernels.HEADERS) + 3
    for rel in needed:
        assert (PKG / rel).is_file(), rel
        assert any(fnmatch.fnmatch(rel, pat) for pat in patterns), f"{rel} matches none of {patterns}"
    # and nothing under csrc/ is left out of the build's view
    on_disk = {p.name for p in (PKG / "csrc").iterdir()}
    assert on_disk == {f"{k}.cu" for k in kernels.KERNELS} | set(kernels.HEADERS)


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


def test_cpu_training_form_takes_plain_versions_and_launches_nothing(monkeypatch):
    wrappers = (cuda_attention.fused_window_attention, cuda_ffn.fused_residual_ffn,
                cuda_ngram.fused_ngram_context)
    for f in wrappers:
        monkeypatch.setattr(f, "launches", 0)
        monkeypatch.setattr(f, "backward_launches", 0)
    model = NGswin(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 2, 2), dec_dim=32,
                   dec_depths=2, dec_num_heads=2, attn_backward="pallas", device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, 64, 64, 1)).astype(np.float32))
    model(x).square().mean().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())
    assert all(f.launches == 0 and f.backward_launches == 0 for f in wrappers)
    assert not kernels._libs


def test_training_wrappers_refuse_other_devices():
    x = torch.zeros(1, 64, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_attention.fused_window_attention(x, *([None] * 6), 6)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_ffn.fused_residual_ffn(x[0], x[0], *([None] * 8))


class _CudaStandIn:
    """What the wrappers look at before they touch the card: a CUDA device
    and ``requires_grad``."""

    device = torch.device("cuda")
    requires_grad = True


@pytest.mark.parametrize("call", [
    lambda t: cuda_nstb.fused_nstb_map(t, None, *([None] * 6), *([(None, None)] * 4), 6, 8),
], ids=["fused_nstb_map"])
def test_forward_only_kernels_refuse_a_graphless_result_under_grad(call):
    """On a CUDA tensor with autograd on and an argument that requires grad,
    the forward-only wrapper raises and names the training form; with
    autograd off it goes on (here: to a stand-in's missing shape)."""
    with torch.enable_grad(), pytest.raises(RuntimeError, match="training form"):
        call(_CudaStandIn())
    with torch.no_grad(), pytest.raises(AttributeError):
        call(_CudaStandIn())


@pytest.mark.parametrize("grad", [True, False], ids=["grad", "no_grad"])
def test_ngram_context_has_a_backward_and_refuses_nothing(grad):
    """``fused_ngram_context`` has a backward kernel: on a CUDA tensor it
    goes to its autograd function with autograd on or off (here: as far as a
    stand-in that is no tensor lets it), and never to the plain version."""
    with torch.set_grad_enabled(grad), pytest.raises((TypeError, AttributeError)):
        cuda_ngram.fused_ngram_context(_CudaStandIn(), *([None] * 8), 6)


def test_refuse_grad_looks_at_grad_mode_and_requires_grad():
    w = torch.zeros(2, requires_grad=True)
    refuse_grad("k", (torch.zeros(2), None))
    with torch.no_grad():
        refuse_grad("k", (w,))
    with pytest.raises(RuntimeError, match="forward-only"):
        refuse_grad("k", (torch.zeros(2), None, w))
