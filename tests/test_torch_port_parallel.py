"""The port's parallelism (tmar_torch.core.mesh, tmar_torch.parallel, the
Trainer's ``parallel.mode``, ``finetune(mesh=)``, ``make_tiled_eval(mesh=)``)
against the JAX package's rules and against one process, on the CPU.

The sharding rules are held to ``tmar.core.mesh._tp_spec`` / ``_fsdp_spec``
on the flax tree of the same model (names through
``tmar_torch.checkpoint.convert``): the same leaves split, on the same
logical dim, at data sizes 2 and 8.  The refusals are held to
``tmar.train.Trainer``'s.

One spawn of 2 gloo ranks (``tests/test_torch_port_parallel_ranks.py``) trains the
tiny config of ``tests/test_parallel_config.py`` for two steps of batch 4 through
``Trainer.fit`` in each mode, with the clip acting (``grad_clip`` 1.0) and
the EMA on, and compares with one process on the same seed and data:

* dp: parameters and EMA within 0.2·lr everywhere (mean 0.002·lr), the
  discriminator within the two-step bounds of
  ``tests/test_torch_port_train_step.py`` (0.2·lr where the first moment is
  at least 1e-7, 2.1·lr where the gradient is rounding noise: the hinge
  loss's logit biases);
  the clip's global norm rtol 1e-5 (two half-batch means against one mean);
* fsdp and tp: against one process with the bounds of dp, and within the
  JAX test's 2e-3 of dp (``tests/test_parallel_config.py``); the clip's norm
  rtol 1e-4 (tp runs the plain form, whose gradients differ from the
  kernels' plain versions by rounding); state really sharded (each rank
  holds half of a qkv's rows);
* validation: PSNR and MSE of the gathered batch rtol 1e-5 of one process;
* resume: a checkpoint written in each mode restores exactly in the same
  mode and in one process;
* the launcher: ``python -m torch.distributed.run --nproc-per-node 2 -m
  tmar_torch.cli train --device cpu`` under fsdp (``init_from_env`` over
  gloo) writes the spawned fsdp run's checkpoint, bit for bit.

The same spawn runs ``sharded_tiled_eval`` on a 96² slice against
``make_tiled_eval`` (atol 2e-5, rtol 1e-4, ``tests/test_parallel.py``),
``finetune(mesh=)`` (RedCNN, two steps; losses rtol 1e-5, parameters within
0.2·lr) and the loader's rows against the 1-device batches,
exactly.
"""

import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_parallel_ranks as R
from tmar.core.mesh import _fsdp_spec, _tp_spec, gan_state_shardings as j_gan_state_shardings
from tmar.nn import MultiScaleDiscriminator as FlaxDisc
from tmar.nn import NGswin as FlaxNGswin
from tmar.train import Trainer as JTrainer
from tmar.train import load_config as jload_config
from tmar_torch.checkpoint.convert import disc_from_flax, from_flax_params
from tmar_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    _flax_axes,
    fsdp_spec,
    gan_state_shardings,
    spec_dim,
    tp_spec,
)
from tmar_torch.data import Loader, SyntheticMARDataset
from tmar_torch.eval.inference import make_tiled_eval
from tmar_torch.nn import NGswin
from tmar_torch.nn.baselines import RedCNN
from tmar_torch.parallel import spawn_ranks
from tmar_torch.train import Trainer, load_config
from tmar_torch.train.finetune import FinetuneWeights, finetune
from tmar_torch.train.trainer import build_val_dataset
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

G_LR, D_LR, FT_LR = 1e-4, 2e-4, 1e-4  # the config's and finetune's


# ---- the rules against the JAX package's --------------------------------------
def _leaf_names(tree, to_port):
    """{flax path: (port name, flax shape)}: each leaf of ``tree`` marked by
    its index, carried through the port's converter."""
    paths = jax.tree_util.tree_leaves_with_path(tree)
    marked = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        [np.full(leaf.shape, i, np.float32) for i, (_, leaf) in enumerate(paths)])
    index = {int(v.reshape(-1)[0]): k for k, v in to_port(marked).items()}
    return {path: (index[i], tuple(leaf.shape)) for i, (path, leaf) in enumerate(paths)}


@pytest.fixture(scope="module")
def flax_leaves():
    """The flax NGswin and discriminator of the tiny config (shapes only)."""
    x = jnp.zeros((1, 64, 64, 1))
    gen = FlaxNGswin(embed_dim=32, depths=(1, 1, 1), num_heads=(2, 2, 2), dec_dim=32,
                     dec_depths=1, dec_num_heads=2)
    g = jax.eval_shape(gen.init, jax.random.PRNGKey(0), x)["params"]
    disc = FlaxDisc(base_channels=16, num_layers=5, num_scales=2)
    d = jax.eval_shape(disc.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 2)))["params"]
    return (_leaf_names(g, from_flax_params), _leaf_names(d, lambda t: disc_from_flax(t)))


def _torch_dim(spec, axis, ndim):
    """The torch dim a JAX PartitionSpec splits over ``axis``, or None."""
    for j, a in enumerate(tuple(spec)):
        if a == axis:
            return _flax_axes(ndim)[j]
    return None


def _torch_shape(shape):
    axes = _flax_axes(len(shape))
    out = [0] * len(shape)
    for j, d in enumerate(axes):
        out[d] = shape[j]
    return tuple(out)


@pytest.mark.parametrize("data_size", [2, 8])
def test_sharding_rules_split_the_jax_leaves_on_the_same_dim(flax_leaves, data_size):
    port = NGswin(**R.TILED, device="cpu")
    g_leaves, d_leaves = flax_leaves
    assert {n for n, _ in g_leaves.values()} == {n for n, _ in port.named_parameters()}
    split_tp = split_fsdp = 0
    for leaves in (g_leaves, d_leaves):
        for path, (name, shape) in leaves.items():
            want = _torch_dim(_tp_spec(path), MODEL_AXIS, len(shape))
            assert spec_dim(tp_spec(name)) == want, name
            split_tp += want is not None
            leaf = jax.ShapeDtypeStruct(shape, jnp.float32)
            want = _torch_dim(_fsdp_spec(leaf, data_size, path), DATA_AXIS, len(shape))
            assert spec_dim(fsdp_spec(name, _torch_shape(shape), data_size)) == want, name
            split_fsdp += want is not None
    assert split_tp == 4 * 6 and split_fsdp > 80  # qkv w/b, fc1 w/b, proj w, fc2 w; 4 blocks


class _DataAxis:
    """Stands in for a DeviceMesh whose data dim has ``n`` ranks."""

    def __init__(self, n):
        self.n = n

    def __getitem__(self, axis):
        return self

    def size(self):
        return self.n


def test_gan_state_shardings_lay_out_the_state_as_the_jax_package(tmp_path, flax_leaves, mesh8):
    """Per network as ``tmar.core.mesh.gan_state_shardings`` lays out a JAX
    state: tp splits the generator alone, fsdp both, dp neither; the moments
    and the EMA lie as their parameters."""
    trainer = Trainer(R.config(str(tmp_path), "dp"), device="cpu")
    g_leaves, d_leaves = flax_leaves
    for kw in ({"tensor_parallel": True}, {"fsdp": True}, {}):
        got = gan_state_shardings(_DataAxis(8), trainer.state, **kw)
        assert set(got) == {"generator", "g_opt", "g_ema", "discriminator", "d_opt"}
        for key, leaves, split in (("generator", g_leaves, True),
                                   ("discriminator", d_leaves, "fsdp" in kw)):
            for path, (name, shape) in leaves.items():
                if not split:
                    ref = None
                elif "fsdp" in kw:
                    ref = _torch_dim(_fsdp_spec(jax.ShapeDtypeStruct(shape, jnp.float32), 8, path),
                                     DATA_AXIS, len(shape))
                elif kw:
                    ref = _torch_dim(_tp_spec(path), MODEL_AXIS, len(shape))
                else:
                    ref = None
                assert spec_dim(got[key][name]) == ref, (kw, name)
        assert got["g_opt"] == got["generator"] == got["g_ema"]
        assert got["d_opt"] == got["discriminator"]
    for fn, mesh in ((gan_state_shardings, None), (j_gan_state_shardings, mesh8)):
        with pytest.raises(ValueError, match="tensor_parallel OR fsdp"):
            fn(mesh, trainer.state, tensor_parallel=True, fsdp=True)


# ---- the refusals against tmar.train.Trainer's --------------------------------
@pytest.mark.parametrize("sets, fix", [
    ({"parallel.mode": "tp", "parallel.model_parallel": 2, "model.use_pallas_attention": True},
     "use_pallas_attention=false"),
    ({"parallel.mode": "tp"}, "model_parallel"),
    ({"parallel.mode": "pipeline"}, "parallel.mode"),
])
def test_trainer_refuses_what_the_jax_trainer_refuses(tmp_path, sets, fix):
    sets = dict(R.TINY_SETS, **sets, run_dir=str(tmp_path))
    with pytest.raises(ValueError) as jerr:
        JTrainer(jload_config(None, sets), val_dataset=None)
    with pytest.raises(ValueError) as err:
        Trainer(load_config(None, sets), device="cpu")
    key = fix.split("=")[0]
    assert key in str(jerr.value) and fix in str(err.value)


# ---- two gloo ranks against one process ---------------------------------------
CLI_SETS = dict(R.TINY_SETS, **R.MODES["fsdp"], n_devices=2, run_name="cli")


def _launch_cli_train(run_dir):
    """``python -m torch.distributed.run --nproc-per-node 2 -m tmar_torch.cli
    train --device cpu`` under fsdp, started (the ranks' launch as users run
    it: RANK, WORLD_SIZE and MASTER_* from the launcher)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    sets = dict(CLI_SETS, run_dir=run_dir)
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "tmar_torch.cli", "train", "--device", "cpu",
         "--set", *(f"{k}={json.dumps(v)}" for k, v in sets.items())],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The spawn's results by rank, one process's fitted summary, and the
    launcher's run (its run dir, exit code, output and errors)."""
    out = str(tmp_path_factory.mktemp("parallel"))
    cli_dir = os.path.join(out, "cli_runs")
    cli = _launch_cli_train(cli_dir)
    errors = []

    def spawn():
        try:
            spawn_ranks(R.run_all, 2, out)
        except Exception as e:  # re-raised below, in the test's thread
            errors.append(e)

    # the one-process run overlaps the ranks' (the thread only waits on them)
    ranks_done = threading.Thread(target=spawn)
    ranks_done.start()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = R.config(out, "dp", run_name="one")
        one = Trainer(cfg, device="cpu", val_dataset=build_val_dataset(cfg))
        one.fit(progress=False)
        summary = R.summary(one)
    finally:
        torch.set_num_threads(threads)
        ranks_done.join(timeout=600)
        try:
            cli_out, cli_err = cli.communicate(timeout=600)
        finally:
            cli.kill()
    assert not ranks_done.is_alive() and not errors, errors
    results = [torch.load(os.path.join(out, f"results_rank{r}.pt"), weights_only=False)
               for r in range(2)]
    return out, results, summary, (cli_dir, cli.returncode, cli_out, cli_err)


def _max_diff(a, b):
    assert set(a) == set(b)
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _close_in_lr(got, ref, lr, what, mu=None):
    """The bounds of tests/test_torch_port_train_step.py's ``_close_in_lr``:
    max |diff| <= 0.2·lr and mean <= 0.002·lr; with ``mu`` (one process's
    first moments) only where |mu| >= 1e-7, and 2.1·lr where the gradient is
    rounding noise.  Without ``mu`` every component is held to 0.2·lr."""
    worst, noisy, mean, n = 0.0, 0.0, 0.0, 0
    assert set(got) == set(ref), what
    for k in ref:
        d = (got[k] - ref[k]).abs().numpy()
        well = np.ones(d.shape, bool) if mu is None else mu[k].abs().numpy() >= 1e-7
        worst = max(worst, float(d[well].max(initial=0.0)))
        noisy = max(noisy, float(d[~well].max(initial=0.0)))
        mean, n = mean + float(d[well].sum()), n + int(well.sum())
    assert worst <= 0.2 * lr, f"{what}: max |diff| {worst:.3e} > 0.2 lr"
    assert mean / n <= 0.002 * lr, f"{what}: mean |diff| {mean / n:.3e} > 0.002 lr"
    assert noisy <= 2.1 * lr, f"{what}: max |diff| {noisy:.3e} > 2.1 lr where the gradient is noise"


def test_dp_two_ranks_match_one_process(ranks):
    _, results, one, _ = ranks
    dp = results[0]["dp"]
    assert dp["step"] == one["step"] == 2
    _close_in_lr(dp["g"], one["g"], G_LR, "generator")
    _close_in_lr(dp["ema"], one["ema"], G_LR, "EMA")
    _close_in_lr(dp["d"], one["d"], D_LR, "discriminator", mu=one["d_mu"])
    np.testing.assert_allclose(dp["norm"], one["norm"], rtol=1e-5)
    assert one["norm"] > 1.0  # the clip acted


@pytest.mark.parametrize("mode", ["fsdp", "tp"])
def test_fsdp_and_tp_match_dp_and_shard_the_state(ranks, mode):
    _, results, one, _ = ranks
    for rank in results:
        assert rank[mode]["qkv_rows"] == rank[mode]["resumed_qkv_rows"] == one["qkv_rows"] // 2
        assert rank["dp"]["qkv_rows"] == one["qkv_rows"]
        assert _max_diff(rank[mode]["g"], results[0][mode]["g"]) == 0.0  # one state
    got = results[0][mode]
    _close_in_lr(got["g"], one["g"], G_LR, f"{mode} generator")
    _close_in_lr(got["ema"], one["ema"], G_LR, f"{mode} EMA")
    _close_in_lr(got["d"], one["d"], D_LR, f"{mode} discriminator", mu=one["d_mu"])
    assert _max_diff(got["g"], results[0]["dp"]["g"]) < 2e-3
    assert _max_diff(got["ema"], results[0]["dp"]["ema"]) < 2e-3
    np.testing.assert_allclose(got["norm"], one["norm"], rtol=1e-4)


@pytest.mark.parametrize("mode", ["dp", "fsdp", "tp"])
def test_validation_of_the_gathered_batch_is_one_process_s(ranks, mode):
    _, results, one, _ = ranks
    for k in ("psnr", "mse"):
        np.testing.assert_allclose(results[0][mode]["val"][k], one["val"][k], rtol=1e-5)


@pytest.mark.parametrize("mode", ["dp", "fsdp", "tp"])
def test_checkpoints_resume_exactly_in_the_mode_and_in_one_process(ranks, mode):
    out, results, _, _ = ranks
    got = results[0][mode]
    assert _max_diff(got["resumed"], got["g"]) == 0.0
    assert _max_diff(got["resumed_ema"], got["ema"]) == 0.0
    single = Trainer(R.config(out, "dp", run_name=mode), device="cpu")
    assert single.resume() and single.state.step == 2
    assert _max_diff({k: p.detach() for k, p in single.generator.named_parameters()},
                     got["g"]) == 0.0
    assert _max_diff(single.state.g_ema, got["ema"]) == 0.0


def test_sharded_tiled_eval_matches_one_process(ranks):
    _, results, _, _ = ranks
    tiled = results[0]["tiled"]
    model = NGswin(**R.TILED, device="cpu")
    model.load_state_dict(tiled["weights"])
    ref = make_tiled_eval(model, 64, 32, device="cpu")(tiled["ct"])
    for rank in results:
        np.testing.assert_allclose(rank["tiled"]["out"], ref, atol=2e-5, rtol=1e-4)


def test_finetune_mesh_matches_one_process(ranks):
    _, results, _, _ = ranks
    ref = finetune(RedCNN(8, device="cpu"), R.Pairs(), batch_size=4, num_epochs=1,
                   weights=FinetuneWeights(sino=0.0), device="cpu")
    for rank in results:
        got = rank["finetune"]
        for k, v in ref["history"][0].items():
            np.testing.assert_allclose(got["history"][0][k], v, rtol=1e-5, err_msg=k)
        model = ref["state"].model
        _close_in_lr(got["params"], {k: p.detach() for k, p in model.named_parameters()}, FT_LR,
                     "fine-tune")


def test_loader_ranks_rows_are_the_one_device_batch(ranks):
    _, results, _, _ = ranks
    ds = SyntheticMARDataset(size=32, length=10, base_seed=3)
    train = [b["ct"] for b in Loader(ds, batch_size=4, seed=5, num_workers=2)]
    val = [(b["gt"], b["valid"]) for b in Loader(ds, batch_size=4, shuffle=False,
                                                  drop_last=False, pad_last=True, num_workers=2)]
    assert [r["loader"]["data_rank"] for r in results] == [0, 1]
    assert len(train) == 2 and len(val) == 3
    for i, b in enumerate(train):
        np.testing.assert_array_equal(np.concatenate([r["loader"]["train"][i] for r in results]), b)
    for i, (gt, valid) in enumerate(val):
        np.testing.assert_array_equal(np.concatenate([r["loader"]["val"][i][0] for r in results]), gt)
        np.testing.assert_array_equal(np.concatenate([r["loader"]["val"][i][1] for r in results]),
                                      valid)


def test_cli_train_under_the_launcher_is_the_spawned_fsdp_run(ranks):
    """The launch users run: ``torch.distributed.run`` sets RANK, WORLD_SIZE
    and MASTER_*, ``tmar_torch.cli train`` initialises gloo from them
    (``init_from_env``) and fits under fsdp; rank 0's checkpoint, restored in
    one process, is the spawned ranks' fsdp state bit for bit."""
    _, results, _, (run_dir, rc, stdout, stderr) = ranks
    assert rc == 0, stderr[-4000:]
    assert json.loads(stdout.strip().splitlines()[-1])["run_dir"]
    sets = dict(CLI_SETS, run_dir=run_dir, **{"parallel.mode": "dp", "n_devices": None})
    single = Trainer(load_config(None, sets), device="cpu")
    assert single.resume() and single.state.step == 2
    want = results[0]["fsdp"]
    assert _max_diff({k: p.detach() for k, p in single.generator.named_parameters()}, want["g"]) == 0.0
    assert _max_diff(single.state.g_ema, want["ema"]) == 0.0
    assert _max_diff({k: p.detach() for k, p in single.discriminator.named_parameters()},
                     want["d"]) == 0.0
