"""The port's evaluation slice (``tmar_torch.eval.harness``, ``adapters``,
``ablation``, ``figures``, ``clinic``, ``tmar_torch.data.measurements`` and
the ``compare`` / ``ablate`` commands) against the JAX package's, on the CPU,
on the same seeded numpy inputs.

* The harness and the ablation engine, given the same numpy forward on both
  sides, write the same set of files and the same metrics (1e-6; latency
  apart); the fixed vis indices and the cross-ablation summary are equal.
* The sinograms of ``enrich_sample`` agree to 1e-4 of their largest value
  (the two Radon operators sum in another order); the runners and the DuDo
  runner (a tiny DuDo, its flax weights carried across) to atol 5e-5.
* The slice ranking, the metal centre and the zoom box are equal; each
  figure function writes its file.
* ``compare`` and ``ablate --inference-only`` on one tiny NGswin, ``--device
  cpu``, against ``tmar.cli.compare`` / ``tmar.cli.ablate``: the same rows,
  PSNR within 1e-3 dB and SSIM within 1e-5, as the ``test`` command's parity
  test holds them.
"""

import csv
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import tmar.cli as jcli
from tmar.eval import ablation as jablation
from tmar.eval import adapters as jadapters
from tmar.eval import clinic as jclinic
from tmar.eval import figures as jfigures
from tmar.eval import harness as jharness
from tmar.ops import Radon as JRadon
from tmar_torch import NGswin, cli
from tmar_torch.data import SyntheticMARDataset
from tmar_torch.data import measurements
from tmar_torch.eval import ablation, adapters, clinic, figures, harness
from tmar_torch.ops.radon import Radon
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

SIZE, ANGLES = 32, np.linspace(0, np.pi, 16, endpoint=False)
TINY = dict(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 2, 2), dec_dim=32, dec_depths=2,
            dec_num_heads=2)
CLI_SETS = [
    "--set", "model.embed_dim=32", "model.depths=[2,2,2]", "model.num_heads=[2,2,2]",
    "model.dec_dim=32", "model.dec_depths=2", "model.dec_num_heads=2",
    "data.dataset=synthetic", "data.patch_size=64", "bf16=false", "radon.num_angles=16",
    "disc.base_channels=8", "disc.num_scales=1", "disc.num_layers=2",
]
ABLATED = ["A1_no_physics", "A6_no_edge"]
ADAPTER_SCRIPT = """
import sys
import numpy as np
d = np.load(sys.argv[1])
np.save(sys.argv[2], np.clip(d["Xma"] * 0.9, 0, 1))
"""
CORE_SCRIPT = """
import sys
import numpy as np
d = np.load(sys.argv[1])
np.save(sys.argv[2], 0.8 * d["Xma255"] + 0.2 * d["XLI255"])
"""


def _forward(x):
    """The numpy forward both sides are given: [B, H, W, 1] in [-1, 1]."""
    return np.tanh(0.9 * x + 0.05)


@pytest.fixture(scope="module")
def ds():
    return SyntheticMARDataset(size=SIZE, length=6)


@pytest.fixture(scope="module")
def radons():
    return Radon(SIZE, ANGLES, device="cpu"), JRadon(SIZE, ANGLES)


@pytest.fixture(scope="module")
def enriched(ds, radons):
    sample = ds[1]
    return adapters.enrich_sample(sample, radon=radons[0]), jadapters.enrich_sample(
        sample, radon=radons[1])


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _close(a, b, tol=1e-6, skip=("latency_s",)):
    assert a.keys() == b.keys()
    for k in a:
        if k not in skip:
            assert abs(a[k] - b[k]) <= tol * max(1.0, abs(b[k])), (k, a[k], b[k])


def test_run_comparison_matches_jax(tmp_path, ds):
    """A forward entry, a runner entry and a failing one: the same rows, the
    same files (composites and distribution figures included)."""
    def broken(x):
        raise RuntimeError("boom")

    results = {}
    for name, mod in (("port", harness), ("jax", jharness)):
        runner = (adapters if mod is harness else jadapters).make_neg11_runner(_forward)
        entries = [mod.ModelEntry("fwd", _forward), mod.ModelEntry("run", runner=runner),
                   mod.ModelEntry("broken", broken)]
        results[name] = mod.run_comparison(entries, ds, str(tmp_path / name), num_samples=4,
                                           composite_samples=2)
    got, ref = results["port"], results["jax"]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert [r["status"] for r in got.values()] == [r["status"] for r in ref.values()] == [
        "ok", "ok", "FAILED"]
    for m in ("fwd", "run"):
        for g, r in zip(got[m]["per_sample"], ref[m]["per_sample"]):
            _close(g, r)
        for k in ("psnr", "ssim", "mae", "rmse"):
            _close(got[m]["summary"][k], ref[m]["summary"][k])
    for f in _files(tmp_path / "jax" / "fwd"):
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "port" / "fwd" / f),
                                          np.load(tmp_path / "jax" / "fwd" / f))
    assert "boom" in got["broken"]["error"]
    table = (tmp_path / "port" / "summary_table.txt").read_text().splitlines()
    assert table[0].split() == ["model", "status", "PSNR", "SSIM", "MAE", "RMSE", "ms/sample"]


def test_evaluate_run_and_the_ablation_summary_match_jax(tmp_path, ds):
    vis = ablation.fixed_vis_indices(len(ds), k=2, seed=3)
    assert vis == jablation.fixed_vis_indices(len(ds), k=2, seed=3)
    assert ablation.fixed_vis_indices(4, k=8) == jablation.fixed_vis_indices(4, k=8)
    history = [{"loss_g": 1.0 / (i + 1), "g_rec": 0.5 / (i + 1)} for i in range(3)]
    val_history = [{"epoch": i, "val_psnr": 20.0 + i} for i in range(2)]
    summaries = {}
    for name, mod in (("port", ablation), ("jax", jablation)):
        summaries[name] = mod.evaluate_run(_forward, ds, str(tmp_path / name / "eval"),
                                           vis_indices=vis, max_samples=3, history=history,
                                           val_history=val_history, name="m")
    _close(summaries["port"], summaries["jax"])
    assert summaries["port"]["n_samples"] == 3
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    results = {"A": {"status": "ok", "summary": summaries["jax"]},
               "B": {"status": "FAILED", "error": "x"}}
    ablation.cross_ablation_summary(results, str(tmp_path / "port" / "sum"))
    jablation.cross_ablation_summary(results, str(tmp_path / "jax" / "sum"))
    for f in ("ablation_summary.csv", "ablation_summary.json"):
        assert (tmp_path / "port" / "sum" / f).read_text() == (tmp_path / "jax" / "sum" / f).read_text()
    assert _files(tmp_path / "port" / "sum") == _files(tmp_path / "jax" / "sum")


def test_enrich_sample_matches_jax(enriched, radons, ds):
    got, ref = enriched
    assert got.keys() == ref.keys() and got["has_sinogram"] and ref["has_sinogram"]
    for k in ("Xma", "Xgt", "XLI", "Mask"):
        np.testing.assert_array_equal(got[k], ref[k])
    for k in ("Sma", "SLI"):
        assert got[k].shape == ref[k].shape == (16, SIZE)
        assert np.abs(got[k] - ref[k]).max() <= 1e-4 * np.abs(ref[k]).max()
    # the trace where the mask's projection is clear of the summation noise
    mask_sino = adapters._on_radon(radons[0], "forward", got["Mask"][None])[0]
    clear = np.abs(mask_sino) > 1e-4 * np.abs(mask_sino).max()
    np.testing.assert_array_equal(got["Tr"][clear], ref["Tr"][clear])
    bare = adapters.enrich_sample(ds[2])
    assert bare["Sma"] is None and not bare["has_sinogram"]


def test_runners_match_jax(enriched, radons):
    """Each protocol on the same enriched sample (the port's), the same numpy
    core on both sides; the sparse-view protocol through each side's FBP."""
    sample = enriched[0]

    def x255(xma, xli, non_mask):
        return 0.7 * xma + 0.3 * xli * non_mask

    def nmar(xma, xli, sma, sli, tr, prior):
        return 0.5 * xma + 0.3 * prior + 0.2 * xli + 0.01 * (sma * tr).mean()

    def sparse(xma, xli, mask, sma, sli, trdc):
        return 0.6 * xma + 0.4 * xli + 0.01 * (sli * trdc).mean()

    pairs = [
        (adapters.make_neg11_runner(_forward), jadapters.make_neg11_runner(_forward)),
        (adapters.make_x255_runner(x255), jadapters.make_x255_runner(x255)),
        (adapters.make_x255_runner(x255, "half"), jadapters.make_x255_runner(x255, "half")),
        (adapters.make_nmar_runner(nmar), jadapters.make_nmar_runner(nmar)),
        (adapters.make_sparse_view_runner(sparse, radons[0]),
         jadapters.make_sparse_view_runner(sparse, radons[1])),
    ]
    for ours, ref in pairs:
        got, want = ours(sample), ref(sample)
        assert got.shape == want.shape == (SIZE, SIZE)
        np.testing.assert_allclose(got, want, atol=5e-5)
    with pytest.raises(ValueError, match="sinograms"):
        adapters.make_nmar_runner(nmar)(adapters.enrich_sample({"ct": sample["Xma"] * 2 - 1,
                                                                "gt": sample["Xgt"] * 2 - 1}))


def test_dudo_runner_matches_jax(enriched, radons):
    """A tiny DuDo: the port's drawn weights, carried to the flax tree, run
    by each side's runner with the training-time LI construction."""
    from tmar.nn import DuDoMARNet as JDuDo
    from tmar_torch.checkpoint.convert import module_to_flax
    from tmar_torch.nn.dudo import DuDoMARNet

    kw = dict(stages=2, channels=8, blocks=1)
    src = DuDoMARNet(radons[0], **kw)
    src.draw_parameters(torch.Generator().manual_seed(4))
    params = module_to_flax(src)[0]
    ours = adapters.make_dudo_runner(DuDoMARNet(radons[0], **kw), params, radon=radons[0])
    ref = jadapters.make_dudo_runner(JDuDo(projector=radons[1], **kw), params, radon=radons[1])
    got, want = ours(enriched[0]), ref(enriched[0])
    assert got.shape == want.shape == (SIZE, SIZE)
    np.testing.assert_allclose(got, want, atol=5e-5)
    with pytest.raises(ValueError, match="li_mode"):
        adapters.make_dudo_runner(src, li_mode="nope")


def test_subprocess_adapter_and_protocol_core(tmp_path, enriched):
    script, core, bad = tmp_path / "ad.py", tmp_path / "core.py", tmp_path / "bad.py"
    script.write_text(ADAPTER_SCRIPT)
    core.write_text(CORE_SCRIPT)
    bad.write_text("import sys; sys.exit(3)")
    sample = enriched[0]
    out = adapters.SubprocessAdapter([sys.executable, str(script)])(sample)
    np.testing.assert_array_equal(out, np.clip(sample["Xma"] * 0.9, 0, 1))
    got = adapters.make_protocol_subprocess_runner("x255", [sys.executable, str(core)])(sample)
    want = jadapters.make_protocol_subprocess_runner("x255", [sys.executable, str(core)])(sample)
    np.testing.assert_array_equal(got, want)
    assert adapters.PROTOCOL_CORE_KEYS == jadapters.PROTOCOL_CORE_KEYS
    with pytest.raises(RuntimeError, match="rc=3"):
        adapters.SubprocessAdapter([sys.executable, str(bad)])(sample)
    with pytest.raises(ValueError, match="unknown adapter protocol"):
        adapters.make_protocol_subprocess_runner("nope", ["x"])
    with pytest.raises(ValueError, match="radon"):
        adapters.make_protocol_subprocess_runner("sparse", ["x"])


def test_figure_helpers_match_jax_and_each_figure_is_written(tmp_path, ds):
    s = ds[0]
    ct01, gt01 = (s["ct"] + 1) / 2, (s["gt"] + 1) / 2
    pred01 = np.clip((_forward(s["ct"][None, ..., None])[0, ..., 0] + 1) / 2, 0, 1)
    assert harness.find_metal_center(ct01) == jharness.find_metal_center(ct01)
    assert harness.find_metal_center(np.zeros((8, 8))) == (4, 4)
    assert figures.compute_artifact_score(ct01, gt01) == jfigures.compute_artifact_score(ct01, gt01)
    assert figures.zoom_box(ct01) == jfigures.zoom_box(ct01)
    assert figures.zoom_box(ct01, 12) == jfigures.zoom_box(ct01, 12)
    cache = str(tmp_path / "best.npy")
    top = figures.select_best_slices(ds, k=3, cache_path=cache)
    assert top == jfigures.select_best_slices(ds, k=3) == figures.select_best_slices(ds, 3, cache)
    preds = {"a": pred01, "b": np.clip(pred01 * 0.9, 0, 1)}
    rows = {"a": [{"sample": 0, "psnr": 20.0, "ssim": 0.5}, {"sample": 1, "psnr": 21.0, "ssim": 0.6}],
            "b": [{"sample": 0, "psnr": 19.0, "ssim": 0.4}, {"sample": 1, "psnr": 22.0, "ssim": 0.7}]}
    calls = {
        "masks": lambda p: figures.figure_metal_aware_masks(s["ct"], p, radii=(0, 3)),
        "physics": lambda p: figures.figure_physics_consistency(
            pred01 * 2 - 1, s["gt"], s["ct"], p, num_angles=16, device="cpu"),
        "receptive": lambda p: figures.figure_multiscale_receptive_fields(s["ct"], p),
        "heatmaps": lambda p: figures.figure_error_heatmaps(preds, gt01, p),
        "mse": lambda p: figures.figure_mse_limitation(pred01, gt01, gt01, p),
        "loss": lambda p: figures.plot_loss_curves([{"loss_g": 1.0}, {"loss_g": 0.5}], p),
        "hist": lambda p: figures.plot_histograms(preds, gt01, p),
        "box": lambda p: figures.plot_metric_boxplots(rows, p),
        "per_image": lambda p: figures.plot_per_image_metrics(rows, p),
        "regional": lambda p: figures.plot_regional_comparison({"a": {"metal_PSNR": 20.0}}, p),
        "segmentation": lambda p: figures.plot_intensity_segmentation(pred01, gt01, p),
        "waves": lambda p: figures.plot_artifact_waves(pred01, gt01, ct01, p),
        "metric_curves": lambda p: figures.plot_metric_curves([{"epoch": 0, "val_psnr": 1.0}], p),
        "contrast": lambda p: figures.contrast_sweep(gt01, p),
        "profiles": lambda p: figures.intensity_profiles(preds, gt01, ct01, p),
        "composite": lambda p: figures.composite_figure(ct01, gt01, preds, p),
    }
    for name, call in calls.items():
        path = str(tmp_path / f"{name}.png")
        call(path)
        assert os.path.getsize(path) > 0, name
    run = tmp_path / "run"
    for m in ("a", "b"):
        os.makedirs(run / m)
        np.save(run / m / "sample_00000.npy", preds[m])
    written = figures.regenerate_profiles_from_run(str(run), ds)
    assert [os.path.basename(p) for p in written] == ["profile_00000.png"]
    with open(run / "profiles" / "profile_00000.csv") as f:
        assert next(csv.reader(f)) == ["x", "gt", "input", "a", "b"]


def test_restore_volume_and_nifti_match_jax(tmp_path):
    from tmar_torch.data.nifti import read_nifti, write_nifti

    rng = np.random.default_rng(2)
    vol = rng.uniform(-1000, 2500, (16, 12, 5)).astype(np.float32)
    got = clinic.restore_volume(_forward, vol, batch_size=2)
    np.testing.assert_array_equal(got, jclinic.restore_volume(_forward, vol, batch_size=2))
    assert got.shape == vol.shape
    src = str(tmp_path / "in.nii.gz")
    write_nifti(src, vol, np.diag([0.5, 0.5, 2.0, 1.0]))
    ours = clinic.restore_nifti_file(_forward, src, str(tmp_path / "o" / "port.nii.gz"), 2)
    theirs = jclinic.restore_nifti_file(_forward, src, str(tmp_path / "o" / "jax.nii.gz"), 2)
    (a, aff_a), (b, aff_b) = read_nifti(ours), read_nifti(theirs)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(aff_a, aff_b)
    write_nifti(str(tmp_path / "2d.nii.gz"), vol[..., 0])
    with pytest.raises(ValueError, match="3-D"):
        clinic.restore_nifti_file(_forward, str(tmp_path / "2d.nii.gz"), str(tmp_path / "x.nii"))


def test_show_first_result(tmp_path, monkeypatch):
    import matplotlib.pyplot as plt

    monkeypatch.delenv("DISPLAY", raising=False)
    assert measurements.show_first_result(str(tmp_path / "missing")) is None
    assert measurements.show_first_result(str(tmp_path)) is None
    plt.imsave(tmp_path / "b.png", np.zeros((8, 8)))
    plt.imsave(tmp_path / "a.png", np.ones((8, 8)))
    assert measurements.show_first_result(str(tmp_path)) == str(tmp_path / "a.png")
    assert os.path.exists(tmp_path / "_first_result_view.png")
    # the saved view is not taken for a result on the next call
    assert measurements.show_first_result(str(tmp_path)) == str(tmp_path / "a.png")


@pytest.fixture(scope="module")
def tiny_pth(tmp_path_factory):
    torch.manual_seed(0)
    path = tmp_path_factory.mktemp("cmp") / "tiny.pth"
    torch.save(NGswin(**TINY, device="cpu").state_dict(), path)
    return str(path)


def _rows_match(got, ref):
    assert [r.keys() for r in got] == [r.keys() for r in ref]
    for g, r in zip(got, ref):
        assert abs(g["psnr"] - r["psnr"]) <= 1e-3
        assert abs(g["ssim"] - r["ssim"]) <= 1e-5


def test_cli_compare_matches_jax_cli(tiny_pth, tmp_path, monkeypatch):
    monkeypatch.setattr(jcli, "_honor_env_platforms", lambda: None)
    script = tmp_path / "ad.py"
    script.write_text(ADAPTER_SCRIPT)
    common = ["--checkpoints", f"tiny={tiny_pth}", "identity", "--adapter",
              f"sub={sys.executable} {script}", "--sinograms", "--num-samples", "2",
              "--composites", "1", *CLI_SETS]
    assert jcli.compare(["--out", str(tmp_path / "jax"), *common]) == 0
    assert cli.main(["compare", "--device", "cpu", "--out", str(tmp_path / "port"), *common]) == 0
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for m in ("tiny", "identity", "sub"):
        got = json.load(open(tmp_path / "port" / m / "metrics.json"))
        ref = json.load(open(tmp_path / "jax" / m / "metrics.json"))
        assert got["status"] == ref["status"] == "ok"
        _rows_match(got["per_sample"], ref["per_sample"])


def _save_checkpoints(run_dir, sd, name):
    """The same generator weights as a port checkpoint and as the JAX
    package's (orbax), each under its own run directory of ablation ``name``."""
    import optax
    from tmar.checkpoint import import_ngswin_state_dict
    from tmar.checkpoint.io import CheckpointManager as JManager
    from tmar.train import load_config as jload_config
    from tmar.train import resolve_variant as jresolve
    from tmar.train.steps import create_train_state as jcreate
    from tmar.train.trainer import build_discriminator as jdisc
    from tmar.train.trainer import build_generator as jgen
    from tmar_torch.checkpoint import CheckpointManager
    from tmar_torch.train import load_config, resolve_variant
    from tmar_torch.train.steps import create_train_state
    from tmar_torch.train.trainer import build_discriminator, build_generator, build_optimizers

    sets = cli._parse_sets([CLI_SETS[1:]])
    cfg = resolve_variant(load_config(None, sets), name)
    gen, disc = build_generator(cfg, "cpu"), build_discriminator(cfg, "cpu")
    state = create_train_state(torch.Generator().manual_seed(1), gen, disc,
                               *build_optimizers(cfg, gen, disc))
    gen.load_state_dict(sd)
    CheckpointManager(os.path.join(run_dir, "port", f"ablation_{name}", "checkpoints")).save(
        state, step=1)
    jcfg = jresolve(jload_config(None, sets), name)
    jstate = jcreate(jax.random.PRNGKey(0), jgen(jcfg), jdisc(jcfg), optax.adam(1e-4),
                     optax.adam(1e-4), 128, 1)
    jstate = jstate.replace(g_params=import_ngswin_state_dict({k: v.numpy() for k, v in sd.items()}))
    JManager(os.path.join(run_dir, "jax", f"ablation_{name}", "checkpoints")).save(jstate, step=1)


def test_cli_ablate_inference_only_matches_jax_cli(tmp_path, monkeypatch):
    monkeypatch.setattr(jcli, "_honor_env_platforms", lambda: None)
    for i, name in enumerate(ABLATED):
        torch.manual_seed(10 + i)
        _save_checkpoints(str(tmp_path), NGswin(**TINY, device="cpu").state_dict(), name)
    common = ["--ablations", *ABLATED, "--inference-only", "--max-eval-samples", "2",
              "--vis-samples", "1"]
    assert jcli.ablate([*common, *CLI_SETS, f"run_dir={tmp_path / 'jax'}"]) == 0
    assert cli.main(["ablate", "--device", "cpu", *common, *CLI_SETS,
                     f"run_dir={tmp_path / 'port'}"]) == 0
    # the checkpoints are each package's own format; everything else is alike
    assert [f for f in _files(tmp_path / "port") if "/checkpoints/" not in f] == [
        f for f in _files(tmp_path / "jax") if "/checkpoints/" not in f]
    for name in ABLATED:
        got = json.load(open(tmp_path / "port" / f"ablation_{name}" / "evaluation" / "metrics.json"))
        ref = json.load(open(tmp_path / "jax" / f"ablation_{name}" / "evaluation" / "metrics.json"))
        assert got["summary"]["n_samples"] == ref["summary"]["n_samples"] == 2
        _rows_match([got["summary"]], [ref["summary"]])
        with open(tmp_path / "port" / f"ablation_{name}" / "evaluation" / "metrics.csv") as f:
            g_rows = [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]
        with open(tmp_path / "jax" / f"ablation_{name}" / "evaluation" / "metrics.csv") as f:
            r_rows = [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]
        _rows_match(g_rows, r_rows)
    with open(tmp_path / "port" / "ablation_summary.json") as f:
        assert {n: r["status"] for n, r in json.load(f).items()} == {n: "ok" for n in ABLATED}
