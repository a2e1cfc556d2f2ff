"""The port's serving slice against the JAX package's, on the CPU at float32:
the tiny NGswin in each block form, the device-side tiled eval and the
``test`` entry point.

* The tiny NGswin (``TINY_FLAX`` of tests/test_torch_export.py) in the map,
  token and unfused forms, one ``state_dict`` loaded into all three, against
  the flax NGswin (``use_pallas_attention=True``, interpret mode) under
  ``TMAR_NSTB_MAP=1``, ``TMAR_NSTB_MAP=0`` and ``TMAR_NSTB_FUSED=0``.
  Tolerance atol 5e-5, rtol 1e-4, the JAX package's model-level tolerance.
* ``make_tiled_eval`` against ``make_tiled_eval_jit`` on the tiny model at
  1x128² (the JAX function's aligned phase-group path) and 1x100² (its
  general path), same tolerance; against the host-side ``tiled_eval`` on a
  stand-in forward, aligned and not, one channel and several, to float32
  rounding.
* ``python -m tmar_torch.cli test --device cpu`` against ``tmar.cli.test`` on
  one tiny ``.pth`` and the same synthetic 64² set: the same ``metrics.json``
  keys, PSNR within 1e-3 dB, SSIM within 1e-5.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tmar.cli as jcli
from tmar.checkpoint import import_ngswin_state_dict
from tmar.eval.inference import make_tiled_eval_jit
from tmar.nn import NGswin as FlaxNGswin
from tmar_torch import NGswin, make_tiled_eval, tiled_eval
from tmar_torch import cli
from tmar_torch.ops import cuda_attention, cuda_ffn, cuda_ngram, cuda_nstb
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

TOL = dict(atol=5e-5, rtol=1e-4)
TINY = dict(
    ngrams=(2, 2, 2, 2), in_chans=1, embed_dim=32, depths=(2, 2, 2), num_heads=(2, 2, 2),
    dec_dim=32, dec_depths=2, dec_num_heads=2, window_size=8,
)
FORMS = {
    "map": ({"TMAR_NSTB_FUSED": "1", "TMAR_NSTB_MAP": "1"}, {}),
    "tokens": ({"TMAR_NSTB_FUSED": "1", "TMAR_NSTB_MAP": "0"}, {"nstb_map": False}),
    "unfused": ({"TMAR_NSTB_FUSED": "0"}, {"nstb_fused": False}),
}
CLI_SETS = [
    "--set", "model.embed_dim=32", "model.depths=[2,2,2]", "model.num_heads=[2,2,2]",
    "model.dec_dim=32", "model.dec_depths=2", "model.dec_num_heads=2",
    "data.dataset=synthetic", "data.patch_size=64", "bf16=false",
]


@pytest.fixture(scope="module")
def tiny():
    """The tiny model's seeded weights as the flax tree and as the port's
    ``state_dict`` (the reference layout, which the JAX package imports)."""
    torch.manual_seed(0)
    sd = NGswin(**TINY, device="cpu").state_dict()
    params = import_ngswin_state_dict({k: v.numpy() for k, v in sd.items()})
    return params, sd


@pytest.mark.parametrize("form", list(FORMS))
def test_tiny_ngswin_form_matches_flax(tiny, monkeypatch, form):
    params, sd = tiny
    env, kwargs = FORMS[form]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    x = np.random.default_rng(0).uniform(-1, 1, (1, 64, 64, 1)).astype(np.float32)
    flax_model = FlaxNGswin(**TINY, use_pallas_attention=True, pallas_interpret=True)
    # a fresh function per form: the environment is read while tracing
    ref = jax.jit(lambda p, v: flax_model.apply({"params": p}, v))(params, jnp.asarray(x))
    model = NGswin(**TINY, device="cpu", **kwargs)
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("hw", [(128, 128), (100, 100)], ids=["aligned", "general"])
def test_make_tiled_eval_matches_jax(tiny, hw):
    params, sd = tiny
    x = np.random.default_rng(1).uniform(-1, 1, (1, *hw, 1)).astype(np.float32)
    ref = make_tiled_eval_jit(FlaxNGswin(**TINY), params)(x)
    model = NGswin(**TINY, device="cpu")
    model.load_state_dict(sd)
    got = make_tiled_eval(model, device="cpu")(x)
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **TOL)


class _StandIn(torch.nn.Module):
    """A forward that differs per tile position and channel and remembers
    its batch sizes."""

    def __init__(self):
        super().__init__()
        self.batches = []

    def forward(self, t):
        self.batches.append(t.shape[0])
        C = t.shape[-1]
        return torch.tanh(2.0 * t + torch.arange(C, dtype=t.dtype) / C + t.mean(dim=(1, 2, 3), keepdim=True))


@pytest.mark.parametrize("shape,forwards", [
    ((2, 128, 96, 1), 2 * 3 * 2), ((1, 128, 128, 2), 3 * 3), ((2, 100, 64, 1), 2 * 3 * 1),
    ((1, 70, 90, 3), 2 * 2),
], ids=["aligned C=1", "aligned C=2", "general C=1", "general C=3"])
def test_make_tiled_eval_paths_match_host_tiled_eval(shape, forwards):
    """All tiles in ONE forward, assembled on the device, against the
    host-side assembly of the same forward."""
    x = np.random.default_rng(2).uniform(-1, 1, shape).astype(np.float32)
    model = _StandIn()
    got = make_tiled_eval(model, device="cpu")(x)
    assert model.batches == [forwards]
    ref = tiled_eval(lambda t: model(torch.from_numpy(t)).numpy(), x, 64, 32, tile_batch=1)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def tiny_pth(tiny, tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "tiny.pth"
    torch.save(tiny[1], path)
    return str(path)


@pytest.mark.parametrize("tiled", [False, True], ids=["full_slice", "tiled"])
def test_cli_test_matches_jax_cli(tiny_pth, tmp_path, monkeypatch, tiled):
    # the JAX CLI points jax at a persistent compile cache; the test keeps
    # the process's jax configuration as it is
    monkeypatch.setattr(jcli, "_honor_env_platforms", lambda: None)
    extra = ["--tiled"] if tiled else []
    common = ["--checkpoint", tiny_pth, "--max-samples", "2", *CLI_SETS, *extra]
    assert jcli.test(["--out", str(tmp_path / "jax"), *common]) == 0
    assert cli.main(["test", "--device", "cpu", "--out", str(tmp_path / "port"), *common]) == 0
    ref = json.load(open(tmp_path / "jax" / "metrics.json"))
    got = json.load(open(tmp_path / "port" / "metrics.json"))
    assert got.keys() == ref.keys()
    assert got["summary"].keys() == ref["summary"].keys()
    assert [r.keys() for r in got["per_sample"]] == [r.keys() for r in ref["per_sample"]]
    assert got["summary"]["n"] == ref["summary"]["n"] == 2
    assert got["summary"]["mode"] == ref["summary"]["mode"] == ("tiled" if tiled else "full_slice")
    for g, r in zip(got["per_sample"] + [got["summary"]], ref["per_sample"] + [ref["summary"]]):
        assert abs(g["psnr"] - r["psnr"]) <= 1e-3
        assert abs(g["ssim"] - r["ssim"]) <= 1e-5


def test_cli_serves_a_checkpoint_directory_s_best_ema(tmp_path):
    """A port checkpoint directory: ``best`` over the latest step, and the
    EMA weights over the generator's when the run kept them."""
    from tmar_torch.checkpoint import CheckpointManager
    from tmar_torch.train import load_config
    from tmar_torch.train.steps import create_train_state
    from tmar_torch.train.trainer import build_discriminator, build_generator, build_optimizers

    cfg = load_config(None, {**cli._parse_sets([CLI_SETS[1:]]), "optim.ema_decay": 0.999,
                             "disc.base_channels": 8, "disc.num_scales": 1,
                             "disc.num_layers": 2})
    gen, disc = build_generator(cfg, "cpu"), build_discriminator(cfg, "cpu")
    state = create_train_state(torch.Generator().manual_seed(3), gen, disc,
                               *build_optimizers(cfg, gen, disc), ema_decay=0.999)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    for k, v in state.g_ema.items():
        v.fill_(0.5)
    mgr.save(state, step=4, best=True)
    for k, v in state.g_ema.items():
        v.fill_(0.25)
    mgr.save(state, step=8)
    for ema in (0.999, 0.0):  # the serving config's EMA setting does not matter
        cfg.optim.ema_decay = ema
        sd = cli._load_generator_params(str(tmp_path / "ckpt"), build_generator(cfg, "cpu"), cfg)
        assert set(sd) == set(gen.state_dict())
        assert all(bool((v == 0.5).all()) for v in sd.values())


def test_cli_reads_the_block_form_from_the_environment():
    assert cli.block_form({}) == dict(ngram_fused=True, nstb_fused=True, nstb_map=True)
    env = {"TMAR_NSTB_FUSED": "0", "TMAR_NSTB_MAP": "0", "TMAR_ATTN_IMPL": "diag",
           "TMAR_NGRAM_FUSED": "0"}
    assert cli.block_form(env) == dict(ngram_fused=False, nstb_fused=False, nstb_map=False)
    model = NGswin(**TINY, device="cpu", **cli.block_form(env))
    blk = model.decoder_layer1.blocks[1]
    assert not blk.nstb_fused
    assert not blk.ngram_window_partition.ngram_context.ngram_fused


def test_cli_commands_not_ported_exit_2_and_name_their_item(capsys, tmp_path):
    """Every command of the JAX CLI is ported: ``export`` answers ``--help``
    (tests/test_torch_port_export.py runs it); an unknown command exits 2
    and names the commands there are."""
    with pytest.raises(SystemExit) as e:
        cli.main(["export", "--help"])
    assert e.value.code == 0 and "--checkpoint" in capsys.readouterr().out
    assert cli.main(["nope"]) == 2
    assert "'export'" in capsys.readouterr().err
    assert cli.main([]) == 2
    # the real datasets build now (tests/test_torch_port_data.py runs the
    # command on them): an empty SpineWeb tree is refused by the loader itself
    with pytest.raises(ValueError, match="no matching artifact/clean"):
        cli._build_test_dataset(cli_cfg({"data.dataset": "spineweb",
                                         "data.spineweb_artifact": str(tmp_path),
                                         "data.spineweb_clean": str(tmp_path)}))


def cli_cfg(over):
    from tmar_torch.train import load_config

    return load_config(None, over)


def test_cli_runs_as_a_module_and_defaults_to_the_card(tiny_pth, tmp_path):
    """``python -m tmar_torch.cli test`` without ``--device`` asks for the
    card, and on a host without one it stops with the device error."""
    code = ("import sys, runpy, torch; torch.cuda.is_available = lambda: False; "
            "sys.argv = ['tmar_torch.cli'] + sys.argv[1:]; "
            "runpy.run_module('tmar_torch.cli', run_name='__main__')")
    res = subprocess.run(
        [sys.executable, "-c", code, "test", "--checkpoint", tiny_pth,
         "--out", str(tmp_path / "o"), *CLI_SETS],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(cli.__file__))),
    )
    assert res.returncode != 0 and "no CUDA device" in res.stderr, res.stderr[-2000:]


def test_cpu_serving_forms_launch_nothing(monkeypatch, tiny):
    wrappers = (cuda_ngram.fused_ngram_context, cuda_nstb.fused_nstb_map, cuda_nstb.fused_nstb,
                cuda_attention.fused_window_attention, cuda_ffn.fused_residual_ffn)
    for f in wrappers:
        monkeypatch.setattr(f, "launches", 0)
    monkeypatch.setattr(cuda_attention.fused_window_attention, "launches_by_impl",
                        dict.fromkeys(cuda_attention.IMPLS, 0))
    x = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (1, 64, 64, 1)).astype(np.float32))
    for _, kwargs in FORMS.values():
        model = NGswin(**TINY, device="cpu", **kwargs)
        model.load_state_dict(tiny[1])
        with torch.no_grad():
            assert torch.isfinite(model(x)).all()
    assert all(f.launches == 0 for f in wrappers)
    assert not any(cuda_attention.fused_window_attention.launches_by_impl.values())


def test_cli_train_honors_the_ngram_environment(monkeypatch, tmp_path):
    """``train`` passes ``TMAR_NGRAM_FUSED`` on to the ``Trainer``, as the JAX
    trainer reads it; the block-form variables do not reach training."""
    import tmar_torch.train as port_train

    seen = []

    class _Trainer:
        run_dir, best_psnr = str(tmp_path), 0.0

        def __init__(self, cfg, device, val_dataset, ngram_fused):
            seen.append(ngram_fused)

        def fit(self, num_epochs=None):
            pass

    monkeypatch.setattr(port_train, "Trainer", _Trainer)
    for value, fused in (("0", False), ("1", True)):
        monkeypatch.setenv("TMAR_NGRAM_FUSED", value)
        assert cli.train(["--device", "cpu", "--no-val", *CLI_SETS]) == 0
        assert seen[-1] is fused
