"""The port's trainer and what it stands on (tmar_torch.train.config,
variants, schedules, trainer; checkpoint.io; data; eval.metrics;
utils.tfevents) against the JAX package's, on the CPU.

Configuration, variants, layer ids, the synthetic samples, the loader's
batches and the host-side metrics are held equal exactly.  Schedules: rtol
1e-6 (float32 on the optax side, float64 here).  The optimizer (clip ->
Adam -> layer-wise decay -> schedule) against the optax chain over three
steps: rtol 1e-5 + atol 1e-8.  The Trainer runs at a tiny size (32² patches,
window 4, depths 2/1/1 + 2, a 12-angle projector).
"""

import dataclasses
import glob
import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tmar.train.config as jconfig
import tmar.train.schedules as jsched
import tmar.train.variants as jvariants
from tmar.data import Loader as JLoader
from tmar.data import SyntheticMARDataset as JSynthetic
from tmar.data import transforms as jtransforms
from tmar.eval import metrics as jmetrics
from tmar.nn import NGswin as FlaxNGswin
from tmar_torch import NGswin
from tmar_torch.checkpoint import CheckpointManager
from tmar_torch.data import Loader, SyntheticMARDataset, transforms
from tmar_torch.eval import metrics
from tmar_torch.train import Trainer, config, schedules, variants
from tmar_torch.train.steps import make_eval_step
from tmar_torch.train.trainer import build_dataset, build_generator, build_val_dataset
from tmar_torch.utils import tfevents
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

YAMLS = ("train_syndeeplesion.yaml", "finetune_spineweb.yaml", "test_config.yaml")
JAX_CONFIGS = os.path.join(os.path.dirname(jconfig.__file__), "..", "configs")


# ---- configuration and variants ---------------------------------------------
@pytest.mark.parametrize("name", YAMLS)
def test_load_config_equals_the_jax_package_s(name):
    ref = jconfig.load_config(os.path.join(JAX_CONFIGS, name)).to_dict()
    got = config.load_config(config.config_path(name)).to_dict()
    assert got == ref


def test_default_config_and_overrides_equal_the_jax_package_s():
    assert config.load_config().to_dict() == jconfig.load_config().to_dict()
    over = {"loss.phys": 0.0, "model.depths": [2, 2, 2], "data.batch_size": 8, "bf16": False}
    assert config.load_config(None, over).to_dict() == jconfig.load_config(None, over).to_dict()
    with pytest.raises(KeyError, match="unknown override"):
        config.load_config(None, {"model.nope": 1})
    with pytest.raises(KeyError, match="unknown config key"):
        config._build(config.TrainConfig, {"nope": 1})


@pytest.mark.parametrize("name", sorted(jvariants.VARIANTS) + sorted(jvariants.ABLATIONS))
def test_resolve_variant_equals_the_jax_package_s(name):
    assert (sorted(variants.VARIANTS), sorted(variants.ABLATIONS)) == (
        sorted(jvariants.VARIANTS), sorted(jvariants.ABLATIONS))
    base = config.load_config(config.config_path(YAMLS[0]))
    got = variants.resolve_variant(base, name)
    ref = jvariants.resolve_variant(jconfig.load_config(os.path.join(JAX_CONFIGS, YAMLS[0])), name)
    assert got.to_dict() == ref.to_dict()
    assert base.to_dict() == config.load_config(config.config_path(YAMLS[0])).to_dict()  # untouched


def test_resolve_variant_refuses_unknown_names():
    with pytest.raises(KeyError, match="unknown variant"):
        variants.resolve_variant(config.TrainConfig(), "A9")


# ---- schedules, layer ids, the optimizer -----------------------------------
STEPS = [0, 1, 2, 9, 10, 11, 50, 99, 100, 101, 250, 999, 1000, 1001, 5000]


@pytest.mark.parametrize("kind,fields", [
    ("cosine", dict(warmup_steps=10, min_lr=1e-6)),
    ("cosine", dict(warmup_steps=0, min_lr=0.0)),
    ("step_half", dict(schedule_step_size=100)),
    ("multistep", dict(milestones=(100, 250, 1000), gamma=0.3)),
])
def test_schedules_equal_optax_s(kind, fields):
    cfg = config.OptimConfig(schedule=kind, **fields)
    jcfg = jconfig.OptimConfig(schedule=kind, **fields)
    got, ref = schedules.build_schedule(cfg, 2e-4, 1000), jsched.build_schedule(jcfg, 2e-4, 1000)
    for step in STEPS:
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6, atol=1e-7 * 2e-4,
                                   err_msg=f"{kind} at {step}")


def test_build_schedule_none_and_unknown():
    assert schedules.build_schedule(config.OptimConfig(), 1e-4, 10) is None
    with pytest.raises(ValueError, match="unknown schedule"):
        schedules.build_schedule(config.OptimConfig(schedule="linear"), 1e-4, 10)


def test_ngswin_layer_id_equals_jax_on_every_generator_parameter():
    tiny = dict(embed_dim=32, depths=(2, 3, 2), num_heads=(2, 2, 2), dec_dim=32, dec_depths=2,
                dec_num_heads=2)
    shapes = jax.eval_shape(FlaxNGswin(**tiny).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 1)))["params"]
    paths = ["/".join(str(k.key) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    names = [k for k, _ in NGswin(**tiny, device="cpu").named_parameters()]
    assert len(paths) == len(names)
    ref = sorted(jsched.ngswin_layer_id(p) for p in paths)
    assert sorted(schedules.ngswin_layer_id(n) for n in names) == ref
    assert [schedules.ngswin_layer_id(p) for p in paths] == [jsched.ngswin_layer_id(p) for p in paths]
    assert len(set(ref)) >= 12 and min(ref) == 0


@pytest.mark.parametrize("fused", [False, True], ids=["per_group", "fused_update"])
def test_optimizer_equals_the_optax_chain_over_three_steps(fused):
    """clip by global norm -> Adam -> layer-wise decay -> cosine schedule."""
    rng = np.random.default_rng(0)
    tree = {"shallow_extract": {"w": rng.standard_normal((3, 4))},
            "encoder_layer1": {"blocks_0": {"w": rng.standard_normal((4,))},
                               "blocks_1": {"w": rng.standard_normal((2, 2))}},
            "norm": {"scale": rng.standard_normal((5,))}}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    names = {"shallow_extract.w": ("shallow_extract", "w"),
             "encoder_layer1.blocks.0.w": ("encoder_layer1", "blocks_0", "w"),
             "encoder_layer1.blocks.1.w": ("encoder_layer1", "blocks_1", "w"),
             "norm.scale": ("norm", "scale")}

    def leaf(t, path):
        for k in path:
            t = t[k]
        return t

    sched_j = jsched.warmup_cosine(1e-2, 10, warmup_steps=2, min_lr=1e-4)
    tx = jsched.build_optimizer(1e-2, 0.5, 0.999, schedule=sched_j, grad_clip=0.5,
                                llrd={"decay": 0.8}, params=tree, fused=fused)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jopt = tx.init(jparams)
    tparams = {n: torch.nn.Parameter(torch.from_numpy(np.array(leaf(tree, p)))) for n, p in names.items()}
    topt = schedules.build_optimizer(
        tparams.items(), 1e-2, 0.5, 0.999,
        schedule=schedules.warmup_cosine(1e-2, 10, warmup_steps=2, min_lr=1e-4), grad_clip=0.5,
        llrd={"decay": 0.8}, fused=fused)
    assert len(topt.param_groups) == 4  # four depth ids
    for step in range(3):
        # large gradients at step 0 (clipped), small ones afterwards (untouched)
        grads = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * (1.0 if step == 0 else 0.01)).astype(np.float32), tree)
        updates, jopt = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in names.items():
            tparams[n].grad = torch.from_numpy(np.array(leaf(grads, p)))
        topt.step()
        for n, p in names.items():
            np.testing.assert_allclose(tparams[n].detach().numpy(), np.asarray(leaf(jparams, p)),
                                       rtol=1e-5, atol=1e-8, err_msg=f"{n} after step {step + 1}")
    assert [g["count"] for g in topt.param_groups] == [3] * 4
    assert topt.state_dict()["param_groups"][0]["count"] == 3


# ---- data, metrics, event files ----------------------------------------------
def test_synthetic_dataset_equals_the_jax_package_s():
    a, b = SyntheticMARDataset(48, 4, base_seed=5), JSynthetic(48, 4, base_seed=5)
    for i in (0, 3):
        assert set(a[i]) == set(b[i]) == {"ct", "gt", "li"}
        for k in a[i]:
            np.testing.assert_array_equal(a[i][k], b[i][k])


def test_transforms_equal_the_jax_package_s():
    rng = np.random.default_rng(0)
    a, b = rng.uniform(-0.2, 1.2, (20, 20)), rng.uniform(-1500, 2500, (20, 20))
    np.testing.assert_array_equal(transforms.normalize01_to_pm1(a), jtransforms.normalize01_to_pm1(a))
    np.testing.assert_array_equal(transforms.hu_window(b), jtransforms.hu_window(b))
    for fn, args in (("random_crop_pair", (8,)), ("random_flip_pair", ())):
        got = getattr(transforms, fn)((a, b), *args, np.random.RandomState(66))
        ref = getattr(jtransforms, fn)((a, b), *args, np.random.RandomState(66))
        for x, y in zip(got, ref):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kwargs", [
    dict(shuffle=True, seed=3), dict(shuffle=False, drop_last=False, pad_last=True),
    dict(shuffle=False, drop_last=False),
], ids=["shuffled_drop_last", "pad_last", "ragged_last"])
def test_loader_batches_equal_the_jax_package_s(kwargs):
    ds = SyntheticMARDataset(16, 7, base_seed=1)
    got = list(Loader(ds, batch_size=3, num_workers=2, **kwargs))
    ref = list(JLoader(JSynthetic(16, 7, base_seed=1), batch_size=3, num_workers=2, **kwargs))
    assert len(got) == len(ref) == (2 if kwargs.get("drop_last", True) else 3)
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    if kwargs.get("pad_last"):
        np.testing.assert_array_equal(got[-1]["valid"], [1.0, 0.0, 0.0])
        np.testing.assert_array_equal(got[-1]["ct"][1], got[-1]["ct"][0])  # cycled, not repeated-last


def test_loader_hands_tensors_to_the_device_and_surfaces_worker_errors():
    batch = next(iter(Loader(SyntheticMARDataset(16, 4), batch_size=2, device="cpu")))
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32 for v in batch.values())
    assert batch["ct"].shape == (2, 16, 16, 1)

    class Broken:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            raise OSError("unreadable slice")

    with pytest.raises(OSError, match="unreadable slice"):
        list(Loader(Broken(), batch_size=2))


def test_metrics_equal_the_jax_package_s():
    s = SyntheticMARDataset(64, 1, base_seed=2)[0]
    rng = np.random.default_rng(0)
    pred = np.clip(s["gt"] + 0.05 * rng.standard_normal(s["gt"].shape).astype(np.float32), -1, 1)
    p01, g01 = (pred + 1) / 2, (s["gt"] + 1) / 2
    for fn in ("mae", "rmse", "psnr", "ssim"):
        assert getattr(metrics, fn)(p01, g01) == getattr(jmetrics, fn)(p01, g01), fn
    assert metrics.ssim(p01, g01, gaussian=True) == jmetrics.ssim(p01, g01, gaussian=True)
    regional = metrics.compute_regional_metrics(pred, s["gt"], s["ct"])
    assert regional == jmetrics.compute_regional_metrics(pred, s["gt"], s["ct"])
    assert metrics.compute_hu_accuracy(p01, g01) == jmetrics.compute_hu_accuracy(p01, g01)
    assert metrics.hu_tolerance_rates(p01, g01) == jmetrics.hu_tolerance_rates(p01, g01)
    assert regional["metal_MSE"] > 0


def test_tfevents_round_trip(tmp_path):
    w = tfevents.TBWriter(str(tmp_path))
    w.scalars({"Train/loss_g": 1.5, "Train/g_phys": 40.25}, 3)
    w.scalar("Val/psnr", 30.0, 4)
    w.close()
    assert tfevents.read_scalars(w.path) == [
        (3, "Train/loss_g", 1.5), (3, "Train/g_phys", 40.25), (4, "Val/psnr", 30.0)]
    assert tfevents.crc32c(b"123456789") == 0xE3069283


# ---- the Trainer ---------------------------------------------------------------
def _tiny_cfg(run_dir, **over):
    base = {
        "data.dataset": "synthetic", "data.batch_size": 2, "data.patch_size": 32,
        "data.samples_per_epoch": 4, "data.num_workers": 1,
        "model.embed_dim": 32, "model.depths": (2, 1, 1), "model.num_heads": (2, 2, 2),
        "model.dec_dim": 32, "model.dec_depths": 2, "model.dec_num_heads": 2, "model.window_size": 4,
        "disc.base_channels": 8, "disc.num_scales": 2, "disc.num_layers": 3,
        "optim.ema_decay": 0.999, "radon.num_angles": 12, "bf16": False, "num_epochs": 2,
        "val_every_n_epochs": 1, "keep_last_n": 1, "log_every": 1, "run_dir": str(run_dir),
        "run_name": "tiny",
    }
    base.update(over)
    cfg = config.load_config(config.config_path(YAMLS[0]), base)
    return variants.resolve_variant(cfg, cfg.variant)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    cfg = _tiny_cfg(tmp_path_factory.mktemp("runs"))
    trainer = Trainer(cfg, device="cpu", val_dataset=build_val_dataset(cfg))
    trainer.fit(progress=False)
    return cfg, trainer


def test_trainer_takes_full_variant_steps_and_logs_them(fitted):
    cfg, trainer = fitted
    assert cfg.variant == "full" and trainer.projector is not None and trainer.projector.num_angles == 12
    assert trainer.generator.attn_backward == "pallas" and trainer.generator.ngram_fused
    assert trainer.state.step == 4 and len(trainer.history) == 4 and len(trainer.val_history) == 2
    want = {"loss_d", "loss_g", "g_adv", "g_fm", "g_rec", "g_edge", "g_phys", "g_metal", "g_total"}
    for h in trainer.history:
        assert want <= set(h) and all(np.isfinite(v) for v in h.values())
        assert h["g_phys"] > 0
    assert [h["step"] for h in trainer.history] == [1, 2, 3, 4]
    last = trainer.val_history[-1]
    assert {"val_psnr", "val_mse", "val_ssim", "val_metal_PSNR", "val_within_10HU", "steps_per_s"} <= set(last)
    np.testing.assert_allclose(last["loss_g"], np.mean([h["loss_g"] for h in trainer.history[2:]]),
                               rtol=1e-5)


def test_trainer_run_dir_layout_and_checkpoint_pruning(fitted):
    _, trainer = fitted
    run = trainer.run_dir
    assert sorted(os.listdir(run)) == ["checkpoints", "config.json", "logs", "samples", "tb"]
    assert sorted(os.listdir(os.path.join(run, "logs"))) == [
        "summary.json", "training_history.csv", "validation_history.csv"]
    # keep_last_n = 1: the first epoch's checkpoint went when the second was written
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["best", "step_0000000004"]
    assert sorted(os.listdir(os.path.join(run, "checkpoints", "best"))) == ["meta.json", "state.pt"]
    with open(os.path.join(run, "config.json")) as f:
        assert json.load(f)["loss"]["phys"] == 0.02
    with open(os.path.join(run, "logs", "summary.json")) as f:
        assert json.load(f)["best_psnr"] == trainer.best_psnr
    events = glob.glob(os.path.join(run, "tb", "events.out.tfevents.*"))
    tags = {t for _, t, _ in tfevents.read_scalars(events[0])}
    assert {"Train/g_phys", "Val/psnr"} <= tags


def test_validate_uses_the_ema_and_equals_the_eval_step(fitted):
    cfg, trainer = fitted
    val = trainer.validate(save_samples=False, full_metrics=False)
    batches = list(Loader(trainer.val_dataset, batch_size=2, shuffle=False, drop_last=False,
                          pad_last=True))
    assert len(batches) == 2  # min(32, samples_per_epoch) = 4 held-out slices
    step = make_eval_step(trainer.generator, device="cpu")
    ema = [step(b, params=trainer.state.g_ema)[1] for b in batches]
    np.testing.assert_allclose(val["psnr"], np.mean([float(m["psnr"]) for m in ema]), rtol=1e-6)
    np.testing.assert_allclose(val["mse"], np.mean([float(m["mse"]) for m in ema]), rtol=1e-6)
    raw = [step(b)[1] for b in batches]
    assert not np.isclose(val["mse"], np.mean([float(m["mse"]) for m in raw]), rtol=1e-9)
    assert val["psnr"] == pytest.approx(trainer.val_history[-1]["val_psnr"], rel=1e-6)


def test_resume_restores_state_and_best_psnr(fitted):
    cfg, trainer = fitted
    fresh = Trainer(cfg, device="cpu")
    before = {k: v.clone() for k, v in fresh.generator.state_dict().items()}
    assert fresh.resume() and fresh.start_epoch == 2 and fresh.state.step == 4
    assert fresh.best_psnr == trainer.best_psnr and np.isfinite(fresh.best_psnr)
    for a, b in ((trainer.generator, fresh.generator), (trainer.discriminator, fresh.discriminator)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), k
    assert any(not torch.equal(v, fresh.generator.state_dict()[k]) for k, v in before.items())
    assert all(torch.equal(v, fresh.state.g_ema[k]) for k, v in trainer.state.g_ema.items())
    for p, q in zip(trainer.generator.parameters(), fresh.generator.parameters()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(trainer.g_opt.state[p][k], fresh.g_opt.state[q][k])
    assert fresh.g_opt.param_groups[0]["count"] == 4
    assert not fresh.resume(step=3)  # no such checkpoint
    other = Trainer(dataclasses.replace(cfg, run_name="elsewhere"), device="cpu")
    assert not other.resume()


def test_checkpoint_manager_best_slot_and_meta(fitted, tmp_path):
    _, trainer = fitted
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
    assert mgr.restore(trainer.state) is None and mgr.latest_step() is None
    mgr.save(trainer.state, step=9, meta={"best_psnr": 1.0}, best=True)
    state, meta = mgr.restore(trainer.state)  # falls back to best when no step exists
    assert meta == {"step": 9, "best_psnr": 1.0} and state is trainer.state
    for s in (1, 2, 3):
        mgr.save(trainer.state, step=s, meta={"epoch": s})
    assert mgr._steps() == [2, 3] and mgr.latest_step() == 3
    assert mgr.restore(trainer.state, step=2)[1]["epoch"] == 2
    assert mgr.restore(trainer.state, best=True)[1]["step"] == 9
    trainer.state.step = 4


def test_trainer_defaults_to_the_card_and_refuses_what_is_not_ported(monkeypatch, tmp_path):
    cfg = _tiny_cfg(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    with pytest.raises(ValueError, match="use_pallas_attention=false"):
        Trainer(_tiny_cfg(tmp_path, **{"parallel.mode": "tp"}), device="cpu")
    with pytest.raises(ValueError, match="unknown parallel.mode"):
        Trainer(_tiny_cfg(tmp_path, **{"parallel.mode": "pp"}), device="cpu")
    # the baselines and the DCGAN critic build (tests/test_torch_port_baselines.py
    # holds them to the JAX package); an unknown name raises
    assert type(build_generator(_tiny_cfg(tmp_path, **{"model.arch": "redcnn"}), device="cpu")).__name__ == "RedCNN"
    assert type(Trainer(_tiny_cfg(tmp_path, **{"disc.kind": "dcgan"}), device="cpu").discriminator).__name__ \
        == "DCGANCritic"
    with pytest.raises(ValueError, match="unknown generator arch"):
        build_generator(_tiny_cfg(tmp_path, **{"model.arch": "unet"}), device="cpu")
    # every dataset of the JAX trainer builds (tests/test_torch_port_data.py
    # holds their samples to the JAX package's); an unknown name raises
    root = tmp_path / "syn" / "train_640geo" / "000" / "00"
    os.makedirs(root)
    with h5py.File(root / "gt.h5", "w") as f:
        f["image"] = np.zeros((32, 32), np.float32)
    for fn, name in ((build_dataset, "SynDeepLesionTrainDataset"),
                     (build_val_dataset, "SynDeepLesionValDataset")):
        assert type(fn(_tiny_cfg(tmp_path, **{"data.dataset": "syndeeplesion",
                                              "data.root": str(tmp_path / "syn")}))).__name__ == name
        with pytest.raises(ValueError, match="unknown dataset"):
            fn(_tiny_cfg(tmp_path, **{"data.dataset": "nope"}))


def test_variant_without_physics_builds_no_projector(tmp_path):
    cfg = variants.resolve_variant(_tiny_cfg(tmp_path, run_name="a1"), "A1_no_physics")
    trainer = Trainer(cfg, device="cpu")
    assert trainer.projector is None and cfg.loss.phys == 0.0 and not cfg.radon.enabled
    batch = next(iter(Loader(build_dataset(cfg), batch_size=2, num_workers=1)))
    _, m = trainer.train_step(trainer.state, batch)
    assert "g_phys" not in m and np.isfinite(float(m["loss_g"]))
    inference_form = build_generator(_tiny_cfg(tmp_path, **{"model.use_pallas_attention": False}),
                                     device="cpu")
    assert inference_form.attn_backward == "auto"
