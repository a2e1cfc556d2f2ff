"""The port's fine-tuning stack (``tmar_torch.data.finetune``,
``tmar_torch.ops.nmar``, ``tmar_torch.nn.dudo``, ``tmar_torch.train.finetune``
and ``python -m tmar_torch.cli finetune``) against the JAX package at
float32 on the CPU: DuDo at 2 stages x 8 channels x 1 block on 32² with 30
angles, RedCNN at 8 features; the port's Radon at ``precision="highest"``.

The dataset and the NMAR prior are numpy on both sides and held exactly
(``assert_array_equal``).  Tolerances otherwise: DuDo's outputs rtol 1e-4 +
atol 5e-5 (the port's model bound, PERF.md §2); its parameter gradients
atol 2e-6 + 2e-3 of the tensor's largest; the sinogram loss rtol 1e-5 (a mean of
5,760 float32 terms, summed in another order); two
fine-tune steps: losses rtol 1e-4 + atol 1e-6, parameters within 0.2·lr
where the JAX Adam first moment is at least 1e-7 (2.1·lr below it, where
the gradient is rounding noise), as in tests/test_torch_port_train_step.py;
the frozen subtree bit for bit unchanged.  The command's pickle applied by
``tmar.nn.RedCNN`` against the port's model on it: rtol 1e-4 + atol 5e-5.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tmar.data import BenchmarkFinetuneDataset as JDataset
from tmar.data import finetune as jdata
from tmar.nn import DuDoMARNet as JDuDo
from tmar.nn import RedCNN as JRedCNN
from tmar.ops import Radon as JRadon
from tmar.ops import nmar as jnmar
from tmar.train import FinetuneState as JFinetuneState
from tmar.train import FinetuneWeights as JWeights
from tmar.train import make_finetune_step as jmake_finetune_step
from tmar.train.finetune import freeze_by_path as jfreeze_by_path
from tmar_torch import cli
from tmar_torch.checkpoint.convert import module_from_flax, module_to_flax
from tmar_torch.data import BenchmarkFinetuneDataset
from tmar_torch.data import finetune as tdata
from tmar_torch.nn.baselines import RedCNN
from tmar_torch.nn.dudo import DuDoMARNet
from tmar_torch.ops import nmar
from tmar_torch.ops.radon import Radon
from tmar_torch.train.finetune import (
    FinetuneState,
    FinetuneWeights,
    dudo_freeze_prefixes,
    finetune,
    freeze_by_path,
    make_finetune_step,
)

SIZE, LR = 32, 1e-4
ANGLES = np.linspace(0, np.pi, 30, endpoint=False)
DUDO = dict(stages=2, channels=8, blocks=1)
# XLA's CPU compiler without LLVM's expensive passes: the same arithmetic
# (no fast-math either way), compiled sooner.  (Its optimisation level 0 is
# not used: it gave NaN in the second v1 step here.)
FAST_COMPILE = {"xla_llvm_disable_expensive_passes": True}


def _compiled(fn, *args):
    """``fn`` (jitted or not) compiled for ``args`` with ``FAST_COMPILE``."""
    return (fn if hasattr(fn, "lower") else jax.jit(fn)).lower(*args).compile(FAST_COMPILE)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pairs_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ft_pairs")
    art, cln = root / "artifact", root / "clean"
    os.makedirs(art)
    os.makedirs(cln)
    rng = np.random.default_rng(0)
    for i in range(6):
        gt = rng.uniform(-1000, 800, (48, 48)).astype(np.float32)
        ma = gt.copy()
        ma[20:26, 20:26] += 2500.0
        ma += rng.normal(0, 30, ma.shape)
        np.save(art / f"{i}.npy", ma)
        np.save(cln / f"{i}.npy", gt)
    return str(art), str(cln)


@pytest.mark.parametrize("kw", [
    dict(patch_size=32), dict(patch_size=32, train=False), dict(patch_size=64),
    dict(patch_size=40, mode="resize", normalize_range="0_255"),
], ids=["patch", "centre", "padded", "resize255"])
def test_dataset_matches_jax_sample_for_sample(pairs_root, kw):
    ours, ref = BenchmarkFinetuneDataset(*pairs_root, **kw), JDataset(*pairs_root, **kw)
    assert len(ours) == len(ref) == 6
    for i in range(2 * len(ref)):  # two passes: the crop stream continues
        a, b = ours[i], ref[i]
        assert set(a) == set(b) == {"Xma", "Xgt", "XLI", "M", "mask"}
        for k in b:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} at {i}")
    with pytest.raises(ValueError, match="patch|resize"):
        BenchmarkFinetuneDataset(*pairs_root, mode="crop")


def test_dataset_helpers_and_nmar_match_jax():
    rng = np.random.default_rng(1)
    ma, gt = rng.uniform(0, 1, (2, 24, 24)).astype(np.float32)
    for a, b in ((ma, gt), (ma, ma)):  # a zero difference takes the fixed threshold
        np.testing.assert_array_equal(tdata.create_metal_mask(a, b), jdata.create_metal_mask(a, b))
    mask = tdata.create_metal_mask(ma, gt)
    np.testing.assert_array_equal(tdata.create_li_image(ma, mask), jdata.create_li_image(ma, mask))
    np.testing.assert_array_equal(tdata._resize_bilinear(ma, 37), jdata._resize_bilinear(ma, 37))

    xli = rng.uniform(0, 120, (2, 24, 24)).astype(np.float32)
    m = (rng.uniform(size=(2, 24, 24)) > 0.1).astype(np.float32)
    np.testing.assert_array_equal(nmar.nmar_prior(xli, m), jnmar.nmar_prior(xli, m))
    np.testing.assert_array_equal(nmar.nmar_prior(xli, m, smooth_sigma=2.0),
                                  jnmar.nmar_prior(xli, m, smooth_sigma=2.0))
    x = rng.uniform(0, 100, 500)
    init = np.array([0.0, 49.0, 98.0])
    for a, b in zip(nmar._kmeans_1d(x, init), jnmar._kmeans_1d(x, init)):
        np.testing.assert_array_equal(a, b)

    pred, gt_s = rng.standard_normal((2, 3, 30, 32)).astype(np.float32)
    tr = (rng.uniform(size=(30, 32)) > 0.5).astype(np.float32)
    for trace in (None, tr):
        got = nmar.sinogram_loss(torch.from_numpy(pred), torch.from_numpy(gt_s),
                                 None if trace is None else torch.from_numpy(trace))
        ref = jnmar.sinogram_loss(jnp.asarray(pred), jnp.asarray(gt_s), trace)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_array_equal(nmar.sparse_view_subsample(pred, 4), jnmar.sparse_view_subsample(pred, 4))
    assert nmar.sparse_view_subsample(torch.from_numpy(pred), 4).shape == (3, 8, 32)


# ---------------------------------------------------------------- DuDo
def _dudo_inputs(b=2, seed=0):
    rng = np.random.default_rng(seed)
    xgt = rng.uniform(0, 1, (b, SIZE, SIZE, 1)).astype(np.float32)
    mask = np.zeros_like(xgt)
    mask[:, 12:16, 12:16] = 1.0
    xma = np.clip(xgt + 0.5 * mask + 0.05 * rng.normal(size=xgt.shape), 0, 2).astype(np.float32)
    xli = np.where(mask > 0, xgt.mean(), xma).astype(np.float32)
    sinos = Radon(SIZE, ANGLES, device="cpu").forward(
        torch.from_numpy(np.concatenate([xma, xli, mask])[..., 0])).numpy()
    sma, sli, trace = sinos[:b], sinos[b:2 * b], sinos[2 * b:]
    return dict(xma=xma, xli=xli, m=1.0 - mask, sma=sma, sli=sli, tr=(trace < 0.1).astype(np.float32)), xgt


@torch.no_grad()
def _spread(model, seed, gain=0.5):
    """Weights of ``gain`` over unit gain, biases of 0.1, from a numpy seed
    (the step sizes keep their initial values)."""
    rng = np.random.default_rng(seed)
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if name == "weight":
                fan = p.numel() // p.shape[1] if isinstance(mod, torch.nn.ConvTranspose2d) else p[0].numel()
                p.copy_(torch.from_numpy((gain * rng.standard_normal(p.shape) / np.sqrt(fan)).astype(np.float32)))
            elif name == "bias":
                p.copy_(torch.from_numpy((0.1 * rng.standard_normal(p.shape)).astype(np.float32)))
    return model


@pytest.mark.parametrize("share", [False, True], ids=["per_stage", "shared"])
def test_dudo_forward_and_gradients_match_flax(share):
    """Per-stage prox nets: forward and every gradient; one shared pair: the
    forward."""
    net = _spread(DuDoMARNet(Radon(SIZE, ANGLES, device="cpu"), share_weights=share, **DUDO), 2)
    jnet = JDuDo(projector=JRadon(SIZE, ANGLES), share_weights=share, **DUDO)
    names = {k.split(".")[0] for k, _ in net.named_parameters()}
    assert names == {"prior_net", "eta1", "eta2", "alpha"} | (
        {"prox_s", "prox_x"} if share else {"prox_s_0", "prox_x_0", "prox_s_1", "prox_x_1"})
    np.testing.assert_allclose(torch.nn.functional.softplus(net.eta2).detach().numpy(), 5.0, rtol=1e-6)
    d, xgt = _dudo_inputs()
    params, _ = module_to_flax(net)
    ref = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), *map(jnp.asarray, d.values()))["params"]
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(params)
    rng = np.random.default_rng(3)
    wx, ws = rng.standard_normal(xgt.shape).astype(np.float32), rng.standard_normal(d["sma"].shape).astype(np.float32)

    def loss(p, args):
        out = jnet.apply({"params": p}, *args)
        return jnp.mean(out["x"] * wx) + jnp.mean(out["s"] * ws) / 100.0, out

    args = (params, tuple(map(jnp.asarray, d.values())))
    if share:  # the forward alone: one compile less
        jout = _compiled(lambda p, a: loss(p, a)[1], *args)(*args)
    else:
        (_, jout), jgrads = _compiled(jax.value_and_grad(loss, has_aux=True), *args)(*args)
    out = net(*(torch.from_numpy(v) for v in d.values()))
    (out["x"] * torch.from_numpy(wx)).mean().add((out["s"] * torch.from_numpy(ws)).mean() / 100.0).backward()
    for k in ("x", "s", "x_prior"):
        assert float(np.abs(np.asarray(jout[k])).max()) > 0.1
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]), rtol=1e-4, atol=5e-5, err_msg=k)
    for a, b in zip(out["xs"], jout["xs"]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-4, atol=5e-5)
    if share:
        return
    ref_grads = module_from_flax(net, _np(jgrads))
    for k, p in net.named_parameters():
        r = ref_grads[k].numpy()
        assert np.abs(r).max() > 0, k
        np.testing.assert_allclose(p.grad.numpy(), r, atol=2e-6 + 2e-3 * np.abs(r).max(), rtol=0, err_msg=k)


# ---------------------------------------------------------------- fine-tune steps
def _close_in_lr(model, ref, mu, lr, what):
    worst, noisy = 0.0, 0.0
    for k, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - ref[k].numpy())
        well = np.abs(mu[k].numpy()) >= 1e-7
        worst = max(worst, float(d[well].max(initial=0.0)))
        noisy = max(noisy, float(d[~well].max(initial=0.0)))
    assert worst <= 0.2 * lr, f"{what}: max |diff| {worst:.3e} > 0.2 lr"
    assert noisy <= 2.1 * lr, f"{what}: max |diff| {noisy:.3e} > 2.1 lr where the gradient is noise"


def _batch(pairs_root):
    ds = BenchmarkFinetuneDataset(*pairs_root, patch_size=SIZE)
    samples = [ds[i] for i in range(2)]
    return {k: np.stack([s[k] for s in samples])[..., None] for k in ("Xma", "Xgt", "mask", "XLI")}


@pytest.mark.parametrize("arch", ["redcnn_sino", "dudo_frozen"])
def test_two_finetune_steps_match_jax(pairs_root, arch):
    if arch == "redcnn_sino":
        net, jnet = _spread(RedCNN(8, device="cpu"), 4, gain=1.0), JRedCNN(features=8)
        proj, jproj, frozen = Radon(SIZE, ANGLES, device="cpu"), JRadon(SIZE, ANGLES), ()
    else:
        net = _spread(DuDoMARNet(Radon(SIZE, ANGLES, device="cpu"), **DUDO), 5)
        jnet, proj, jproj = JDuDo(projector=JRadon(SIZE, ANGLES), **DUDO), None, None
        frozen = dudo_freeze_prefixes(1)
        assert frozen == ("prior_net", "prox_s_0", "prox_x_0")
    params, _ = module_to_flax(net)
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    tx = optax.adam(LR)
    if frozen:
        tx = jfreeze_by_path(tx, params, frozen)
    jstate = JFinetuneState(step=jnp.zeros((), jnp.int32), params=params, opt=tx.init(params))
    jstep = jmake_finetune_step(jnet, tx, JWeights(), projector=jproj, mesh=None, donate=False)
    opt = torch.optim.Adam(freeze_by_path(net.named_parameters(), frozen), LR)
    state = FinetuneState(0, net, opt)
    step = make_finetune_step(net, opt, FinetuneWeights(), projector=proj, device="cpu")
    batch = _batch(pairs_root)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = _compiled(jstep, jstate, jbatch)
    for _ in range(2):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, batch)
        assert set(m) == set(jm) == {"loss", "rec", "edge", "sino"}
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    assert state.step == int(jstate.step) == 2
    mu = jstate.opt.inner_states["train"].inner_state[0].mu if frozen else jstate.opt[0].mu
    # the frozen leaves have no moments (optax's MaskedNode): zeros in their place
    mu = jax.tree_util.tree_map(lambda p, m: np.zeros_like(p) if isinstance(m, optax.MaskedNode) else m,
                                params, mu)
    _close_in_lr(net, module_from_flax(net, _np(jstate.params)), module_from_flax(net, _np(mu)), LR, arch)
    held = [k for k in before if k.replace(".", "/").startswith(frozen)] if frozen else []
    assert len(held) == (sum(1 for k in before if k.startswith(("prior_net.", "prox_s_0.", "prox_x_0.")))
                         if frozen else 0)
    for k, p in net.named_parameters():
        assert torch.equal(p.detach(), before[k]) == (k in held), k


def test_finetune_runs_one_epoch(pairs_root):
    ds = BenchmarkFinetuneDataset(*pairs_root, patch_size=SIZE)
    out = finetune(RedCNN(8, device="cpu"), ds, batch_size=2, weights=FinetuneWeights(sino=0.0),
                   device="cpu")
    assert out["state"].step == 3 and set(out["history"][0]) == {"loss", "rec", "edge", "epoch"}


def test_finetune_on_a_one_rank_mesh_is_the_meshless_run(pairs_root):
    """A 1-rank mesh (the process group ``create_mesh`` starts when there is
    none) runs the data-parallel path and changes nothing; two ranks are
    held to one process in tests/test_torch_port_parallel.py."""
    import torch.distributed as dist

    from tmar_torch.core.mesh import create_mesh

    ds = BenchmarkFinetuneDataset(*pairs_root, patch_size=SIZE, train=False)
    ref = finetune(RedCNN(8, device="cpu"), ds, batch_size=2, weights=FinetuneWeights(sino=0.0),
                   device="cpu")
    assert not dist.is_initialized()
    try:
        mesh = create_mesh(device="cpu")
        got = finetune(RedCNN(8, device="cpu"), ds, batch_size=2,
                       weights=FinetuneWeights(sino=0.0), mesh=mesh, device="cpu")
    finally:
        dist.destroy_process_group()
    assert mesh.size() == 1 and got["history"] == ref["history"]
    for (k, p), q in zip(got["state"].model.named_parameters(), ref["state"].model.parameters()):
        assert torch.equal(p, q), k


def test_finetune_command_writes_a_pickle_the_jax_model_loads(tmp_path):
    out = str(tmp_path / "ft")
    assert cli.main(["finetune", "--arch", "redcnn", "--synthetic", "4", "--patch-size", str(SIZE),
                     "--epochs", "1", "--batch-size", "2", "--num-angles", "30", "--out", out,
                     "--device", "cpu"]) == 0
    history = json.load(open(os.path.join(out, "history.json")))
    assert len(history) == 1 and set(history[0]) == {"loss", "rec", "edge", "sino", "epoch"}
    with open(os.path.join(out, "redcnn_finetuned.pkl"), "rb") as f:
        params = pickle.load(f)
    x = np.random.default_rng(6).uniform(0, 1, (2, SIZE, SIZE, 1)).astype(np.float32)
    ref = _compiled(JRedCNN().apply, {"params": params}, jnp.asarray(x))({"params": params}, jnp.asarray(x))
    net = RedCNN(device="cpu")
    net.load_state_dict(module_from_flax(net, params))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=5e-5)
