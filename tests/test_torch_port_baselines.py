"""The port's baselines, DCGAN pair and loop, and the ``v1`` variant
(``tmar_torch.nn.baselines``, ``tmar_torch.train.dcgan``, the trainer's
builders) against the JAX package at float32 on the CPU, at narrow widths:
RedCNN 8 features, DenoisingTransformer dim 32 x depth 1, BAFResNet 8 x 2
blocks on 32², the DCGAN pair at nz 8, ngf / ndf 8 on 64².

The weights are the port's, drawn from a seed and then spread to unit gain
(so that every layer's output is of order one and an absolute bound means
something), and carried to flax by ``module_to_flax``; the flax tree's
structure and shapes are held to ``jax.eval_shape`` of the flax module's
``init``.  Each flax function runs under ``jax.jit`` (one compile each).

Tolerances.  Forwards: rtol 1e-4 + atol 5e-5 (the port's model bound,
PERF.md §2).  The DCGAN generator's running statistics after one
train-mode forward: rtol 1e-5 + atol 1e-7.  Gradients: atol 2e-6 + rtol
2e-3 of the tensor's largest.  Two train steps (DCGAN loop, the ``v1``
variant): losses rtol 1e-4 + atol 1e-6; parameters within 0.2·lr, where the
JAX Adam first moment is at least 1e-7 (below it the gradient is rounding
noise and Adam turns its sign into a whole step: held to 2.1·lr), as in
tests/test_torch_port_train_step.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tmar.nn import baselines as jb
from tmar.train import GANTrainState as JGANTrainState
from tmar.train import load_config as jload_config
from tmar.train import make_train_step as jmake_train_step
from tmar.train import resolve_variant as jresolve_variant
from tmar.train.dcgan import DCGANState as JDCGANState
from tmar.train.dcgan import make_dcgan_step as jmake_dcgan_step
from tmar.train.trainer import build_discriminator as jbuild_discriminator
from tmar.train.trainer import build_generator as jbuild_generator
from tmar_torch.checkpoint import from_flax_params
from tmar_torch.checkpoint.convert import module_from_flax, module_to_flax
from tmar_torch.nn import baselines as tb
from tmar_torch.train import Trainer, load_config, make_train_step, resolve_variant
from tmar_torch.train.dcgan import create_dcgan_state, make_dcgan_step, train_dcgan
from tmar_torch.train.steps import GANTrainState
from tmar_torch.train.trainer import build_discriminator, build_generator

RTOL, ATOL = 1e-4, 5e-5
# XLA's CPU compiler without LLVM's expensive passes: the same arithmetic
# (no fast-math either way), compiled sooner.  (Its optimisation level 0 is
# not used: it gave NaN in the second v1 step here.)
FAST_COMPILE = {"xla_llvm_disable_expensive_passes": True}


def _compiled(fn, *args):
    """``fn`` (jitted or not) compiled for ``args`` with ``FAST_COMPILE``."""
    return (fn if hasattr(fn, "lower") else jax.jit(fn)).lower(*args).compile(FAST_COMPILE)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@torch.no_grad()
def _excite(model, seed):
    """Unit-gain weights, norm scales near 1, other parameters (biases,
    position embedding) of 0.1, from a numpy seed."""
    rng = np.random.default_rng(seed)
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if name == "weight" and isinstance(mod, torch.nn.ConvTranspose2d):
                v = rng.standard_normal(p.shape) / np.sqrt(p.numel() // p.shape[1])
            elif name == "weight" and isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
                v = rng.standard_normal(p.shape) / np.sqrt(p[0].numel())
            elif name == "weight":
                v = 1.0 + 0.1 * rng.standard_normal(p.shape)
            else:
                v = 0.1 * rng.standard_normal(p.shape)
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return model


def _flax_params(flax_module, torch_module, *init_args, **init_kw):
    """The port's weights as a flax tree, its layout held to flax's own."""
    params, stats = module_to_flax(torch_module)
    ref = jax.eval_shape(functools.partial(flax_module.init, **init_kw), jax.random.PRNGKey(0), *init_args)
    got = {"params": params, **({"batch_stats": stats} if stats else {})}
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(got)
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(ref),
                                                   jax.tree_util.tree_leaves(got)))
    return got


def _x(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


MODELS = {
    "redcnn": (lambda: jb.RedCNN(features=8), lambda: tb.RedCNN(8, device="cpu"), (2, 32, 32, 1)),
    "transformer": (lambda: jb.DenoisingTransformer(dim=32, depth=1),
                    lambda: tb.DenoisingTransformer(32, 1, img_size=32, device="cpu"), (2, 32, 32, 1)),
    "bafresnet": (lambda: jb.BAFResNet(features=8, num_blocks=2),
                  lambda: tb.BAFResNet(8, 2, device="cpu"), (2, 32, 32, 1)),
    "dcgan_critic": (lambda: jb.DCGANCritic(ndf=8), lambda: tb.DCGANCritic(8, device="cpu"),
                     (2, 64, 64, 2)),
    "dcgan_discriminator": (lambda: jb.DCGANDiscriminator(ndf=8),
                            lambda: tb.DCGANDiscriminator(8, device="cpu"), (2, 64, 64, 1)),
    "dcgan_generator": (lambda: jb.DCGANGenerator(nz=8, ngf=8),
                        lambda: tb.DCGANGenerator(8, 8, device="cpu"), (2, 1, 1, 8)),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_flax_on_converted_weights(name):
    make_flax, make_torch, shape = MODELS[name]
    fm, tm = make_flax(), _excite(make_torch(), 1)
    if name == "dcgan_generator":
        # running statistics taken from a seeded batch (momentum 0 for one
        # train-mode pass), so that the evaluation-mode output is of order one
        bns = [getattr(tm, f"bn_{i}") for i in range(4)]
        for bn in bns:
            bn.momentum = 0.0
        with torch.no_grad():
            tm(torch.from_numpy(np.random.default_rng(1).standard_normal((8, 1, 1, 8)).astype(np.float32)),
               train=True)
        for bn in bns:
            bn.momentum = 0.99
    x = _x(shape) if name != "dcgan_generator" else np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    variables = _flax_params(fm, tm, jnp.asarray(x))
    ref = _compiled(fm.apply, variables, jnp.asarray(x))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    if name == "dcgan_critic":  # ([logits], [[features]])
        (ref, ref_feats), (got, got_feats) = (ref[0][0], ref[1][0]), (got[0][0], got[1][0])
        for r, g in zip(ref_feats, got_feats):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
    assert got.shape == ref.shape
    assert float(np.abs(np.asarray(ref)).max()) > 0.05, "the forward must not be trivially small"
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_flax_tree_round_trips_through_the_state_dict(name):
    tm = _excite(MODELS[name][1](), 2)
    params, stats = module_to_flax(tm)
    sd = module_from_flax(tm, params, stats)
    assert set(sd) == set(tm.state_dict())
    assert all(torch.equal(sd[k], v) for k, v in tm.state_dict().items())
    with pytest.raises(ValueError, match="unmapped flax params"):
        module_from_flax(tm, {**params, "stray": {"kernel": np.zeros(1)}}, stats)


def test_dcgan_generator_batch_stats_after_one_train_forward():
    fm, tm = jb.DCGANGenerator(nz=8, ngf=8), _excite(tb.DCGANGenerator(8, 8, device="cpu"), 3)
    z = np.random.default_rng(1).standard_normal((4, 1, 1, 8)).astype(np.float32)
    variables = _flax_params(fm, tm, jnp.asarray(z), train=True)
    out, mut = _compiled(lambda v, z: fm.apply(v, z, train=True, mutable=["batch_stats"]),
                         variables, jnp.asarray(z))(variables, jnp.asarray(z))
    got = tm(torch.from_numpy(z), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=RTOL, atol=ATOL)
    _, stats = module_to_flax(tm)
    for r, g in zip(jax.tree_util.tree_leaves(_np(mut["batch_stats"])), jax.tree_util.tree_leaves(stats)):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-7)
    # flax keeps the biased batch variance (torch's BatchNorm2d the unbiased)
    with torch.no_grad():
        h = tm.up_0(torch.from_numpy(z))
    for unbiased, same in ((False, True), (True, False)):
        want = 0.99 + 0.01 * h.var(dim=(0, 1, 2), unbiased=unbiased)
        assert torch.allclose(tm.bn_0.var, want, rtol=1e-5, atol=1e-7) == same


def test_redcnn_gradients_match_flax():
    fm, tm = jb.RedCNN(features=8), _excite(tb.RedCNN(8, device="cpu"), 4)
    x, t = _x((2, 32, 32, 1), 5), _x((2, 32, 32, 1), 6)
    variables = _flax_params(fm, tm, jnp.asarray(x))

    def loss(p, x, t):
        return jnp.mean((fm.apply({"params": p}, x) - t) ** 2)

    args = (variables["params"], jnp.asarray(x), jnp.asarray(t))
    ref = module_from_flax(tm, _np(_compiled(jax.grad(loss), *args)(*args)))
    ((tm(torch.from_numpy(x)) - torch.from_numpy(t)) ** 2).mean().backward()
    for k, p in tm.named_parameters():
        r = ref[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, atol=2e-6 + 2e-3 * np.abs(r).max(), rtol=0, err_msg=k)


def _close_in_lr(got, ref, mu, lr, what):
    worst, noisy = 0.0, 0.0
    for k in ref:
        d = np.abs(got[k].detach().numpy() - ref[k].numpy())
        well = np.abs(mu[k].numpy()) >= 1e-7
        worst = max(worst, float(d[well].max(initial=0.0)))
        noisy = max(noisy, float(d[~well].max(initial=0.0)))
    assert worst <= 0.2 * lr, f"{what}: max |diff| {worst:.3e} > 0.2 lr"
    assert noisy <= 2.1 * lr, f"{what}: max |diff| {noisy:.3e} > 2.1 lr where the gradient is noise"


def test_two_dcgan_steps_match_jax_with_the_same_z():
    lr = 2e-4
    gen, disc = tb.DCGANGenerator(8, 8, device="cpu"), tb.DCGANDiscriminator(8, device="cpu")
    g_opt = torch.optim.Adam(gen.parameters(), lr, betas=(0.5, 0.999), eps=1e-8)
    d_opt = torch.optim.Adam(disc.parameters(), lr, betas=(0.5, 0.999), eps=1e-8)
    state = create_dcgan_state(torch.Generator().manual_seed(0), gen, disc, g_opt, d_opt)
    jgen, jdisc = jb.DCGANGenerator(nz=8, ngf=8), jb.DCGANDiscriminator(ndf=8)
    g_tx = optax.adam(lr, b1=0.5, b2=0.999)
    d_tx = optax.adam(lr, b1=0.5, b2=0.999)
    gv = _flax_params(jgen, gen, jnp.zeros((1, 1, 1, 8)), train=True)
    dv = _flax_params(jdisc, disc, jnp.zeros((1, 64, 64, 1)))
    jstate = JDCGANState(g_params=gv["params"], g_batch_stats=gv["batch_stats"], d_params=dv["params"],
                         g_opt=g_tx.init(gv["params"]), d_opt=d_tx.init(dv["params"]),
                         step=jnp.zeros((), jnp.int32))
    step = make_dcgan_step(gen, disc, g_opt, d_opt, device="cpu")
    rng = np.random.default_rng(7)
    jstep = None
    for _ in range(2):
        real = rng.uniform(-1, 1, (4, 64, 64, 1)).astype(np.float32)
        z = rng.standard_normal((4, 1, 1, 8)).astype(np.float32)
        args = (jstate, jnp.asarray(real), jnp.asarray(z))
        jstep = jstep or _compiled(jmake_dcgan_step(jgen, jdisc, g_tx, d_tx), *args)
        jstate, jm = jstep(*args)
        state, m = step(state, real, z)
        for k in ("loss_d", "loss_g"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    assert state.step == int(jstate.step) == 2
    for net, jp, jopt in ((gen, jstate.g_params, jstate.g_opt), (disc, jstate.d_params, jstate.d_opt)):
        _close_in_lr(dict(net.named_parameters()), module_from_flax(net, _np(jp)),
                     module_from_flax(net, _np(jopt[0].mu)), lr, type(net).__name__)
    _, stats = module_to_flax(gen)
    for r, g in zip(jax.tree_util.tree_leaves(_np(jstate.g_batch_stats)), jax.tree_util.tree_leaves(stats)):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-7)


def test_train_dcgan_runs_on_the_cpu_and_samples():
    data = [np.random.default_rng(i).uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32) for i in range(2)]
    state, hist = train_dcgan(data, steps=3, nz=8, sample_every=3, device="cpu")
    assert state.step == 3 and len(hist["loss_d"]) == 3 and np.isfinite(hist["loss_g"]).all()
    assert hist["samples"][0].shape == (2, 64, 64, 1)
    with pytest.raises(ValueError, match="64²"):
        train_dcgan(data, steps=1, image_size=32, device="cpu")


# ---------------------------------------------------------------- the v1 variant
V1_MODEL = {
    "model.embed_dim": 16, "model.depths": [1, 1, 1], "model.num_heads": [1, 1, 1],
    "model.dec_dim": 16, "model.dec_depths": 1, "model.dec_num_heads": 1,
    "data.patch_size": 64, "disc.base_channels": 8, "bf16": False,
}


@pytest.fixture(scope="module")
def v1_two_steps():
    """Two ``v1`` steps on both sides from the same weights and batch."""
    jcfg = jresolve_variant(jload_config(None, V1_MODEL), "v1")
    tcfg = resolve_variant(load_config(None, {**V1_MODEL, "model.use_pallas_attention": True,
                                              "model.attn_backward": "pallas"}), "v1")
    jgen, jdisc = jbuild_generator(jcfg), jbuild_discriminator(jcfg)
    tgen, tdisc = build_generator(tcfg, "cpu"), build_discriminator(tcfg, "cpu")
    rng = np.random.default_rng(8)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return np.ones(s.shape, np.float32)
        if name == "logit_scale":
            return np.full(s.shape, np.log(10.0), np.float32)
        return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)

    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))["params"]
    g_params = jax.tree_util.tree_map_with_path(leaf, shapes)
    tgen.load_state_dict(from_flax_params(g_params))
    _excite(tdisc, 9)
    d_params = _flax_params(jdisc, tdisc, jnp.zeros((1, 64, 64, 2)))["params"]
    o = tcfg.optim
    g_tx, d_tx = (optax.adam(lr, b1=o.beta1, b2=o.beta2) for lr in (o.lr_g, o.lr_d))
    g_opt = torch.optim.Adam(tgen.parameters(), o.lr_g, betas=(o.beta1, o.beta2), eps=1e-8)
    d_opt = torch.optim.Adam(tdisc.parameters(), o.lr_d, betas=(o.beta1, o.beta2), eps=1e-8)
    jstate = JGANTrainState(step=jnp.zeros((), jnp.int32), g_params=g_params, g_opt=g_tx.init(g_params),
                            d_params=d_params, d_sn={}, d_opt=d_tx.init(d_params), g_ema=None)
    jstep = jmake_train_step(jgen, jdisc, g_tx, d_tx, jcfg.loss, mesh=None, donate=False,
                             fused_pairs=jcfg.disc.fused_pairs)
    tstate = GANTrainState(0, tgen, g_opt, tdisc, d_opt)
    tstep = make_train_step(tgen, tdisc, g_opt, d_opt, tcfg.loss, fused_pairs=tcfg.disc.fused_pairs,
                            device="cpu")
    batch = {k: _x((2, 64, 64, 1), s) for k, s in (("ct", 10), ("gt", 11))}
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jstep = _compiled(jstep, jstate, jbatch)
    jm, tm = [], []
    for _ in range(2):
        jstate, m = jstep(jstate, jbatch)
        jm.append({k: float(v) for k, v in m.items()})
        tstate, m = tstep(tstate, batch)
        tm.append({k: float(v) for k, v in m.items()})
    return tcfg, jstate, jm, tstate, tm


def test_v1_variant_builds_the_dcgan_critic_and_matches_jax_metrics(v1_two_steps):
    tcfg, _, jm, tstate, tm = v1_two_steps
    assert tcfg.disc.kind == "dcgan" and tcfg.loss.gan_mode == "vanilla" and tcfg.loss.adv == 0.1
    assert isinstance(tstate.discriminator, tb.DCGANCritic) and tstate.discriminator.ndf == 8
    for j, t in zip(jm, tm):
        assert set(t) == set(j) and "g_adv" in t
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_v1_variant_parameters_match_jax_after_two_steps(v1_two_steps):
    tcfg, jstate, _, tstate, _ = v1_two_steps
    assert tstate.step == int(jstate.step) == 2
    _close_in_lr(dict(tstate.generator.named_parameters()), from_flax_params(_np(jstate.g_params)),
                 from_flax_params(_np(jstate.g_opt[0].mu)), tcfg.optim.lr_g, "generator")
    d = tstate.discriminator
    _close_in_lr(dict(d.named_parameters()), module_from_flax(d, _np(jstate.d_params)),
                 module_from_flax(d, _np(jstate.d_opt[0].mu)), tcfg.optim.lr_d, "critic")


def test_trainer_fits_and_resumes_a_baseline_against_the_dcgan_critic(tmp_path):
    over = {"model.arch": "transformer", "data.dataset": "synthetic", "data.patch_size": 64,
            "data.batch_size": 2, "data.samples_per_epoch": 4, "data.num_workers": 1,
            "disc.base_channels": 8, "bf16": False, "num_epochs": 1, "log_every": 1,
            "run_dir": str(tmp_path), "run_name": "v1"}
    cfg = resolve_variant(load_config(None, over), "v1")
    trainer = Trainer(cfg, device="cpu")
    assert isinstance(trainer.generator, tb.DenoisingTransformer)
    assert isinstance(trainer.discriminator, tb.DCGANCritic)
    trainer.fit(progress=False)
    assert trainer.state.step == 2 and all(np.isfinite(v) for h in trainer.history for v in h.values())
    fresh = Trainer(cfg, device="cpu")
    assert fresh.resume() and fresh.state.step == 2
    for a, b in ((trainer.generator, fresh.generator), (trainer.discriminator, fresh.discriminator)):
        assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
