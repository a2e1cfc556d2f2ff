"""Two consecutive GAN train steps of the port (tmar_torch.train) against
``tmar.train.make_train_step(mesh=None, donate=False)``, from the same
weights, power-iteration vectors and seeded numpy batch, at float32 on the
CPU: tiny generator in its training form, discriminator ``base_channels=16,
num_scales=2`` on 64² patches, ``fused_pairs=True``, no sinogram term, EMA on.

The flax generator runs its XLA path (the same function and gradients as its
Pallas kernels, see tests/test_torch_port_train_form.py).

Tolerances.  Adam's first moments, which are the gradients scaled by
(1 - b1): rtol 2e-3 + atol 1e-7; second moments rtol 4e-3 + atol 1e-13.
Adam's first update is lr·g / (|g| + eps), so a component whose |g| is near
eps = 1e-8 turns rounding noise into a visible share of one learning-rate
step.  Parameters and the EMA are therefore held to max |diff| <= 0.2·lr and
mean |diff| <= 0.002·lr after the two steps (lr 1e-4 for G, 2e-4 for D),
wherever the JAX first moment is at least 1e-7 in magnitude (ten times eps).  Below that the
gradient is rounding noise in both frameworks (the hinge loss's gradient in
a logit bias is -1 from the real half and +1 from the fake half, zero while
all |logits| < 1) and Adam turns its sign into a whole step, so those
components are held only to the two steps Adam can take, 2.1·lr.  Metrics:
rtol 1e-4 + atol 1e-6, except that such a bias step of D shifts every logit
by up to lr_D per scale and step: ``g_adv`` is held to 2 scales x 2 steps x
lr_D = 8e-4, and the totals that hold 0.1·g_adv to 8e-5.  u, v: rtol 1e-4 +
atol 1e-5.

The ``full``-variant case at the end takes the same two steps with the
sinogram term (a 12-angle Radon projector) and the n-gram context through
``fused_ngram_context`` (``ngram_fused=True``), against the JAX step on its
Pallas kernels in interpret mode with ``TMAR_NGRAM_FUSED=1`` (megakernel
primal, fused backward kernel): a smaller generator (depths 2/1/1 + 2,
window 4) and a 3-layer discriminator on 32² patches, so that JAX compiles
in about a minute.  It holds the metrics, parameters, EMA and moments to the
same tolerances, and also carries JAX's state after its first step across
(parameters, power-iteration vectors, EMA, Adam moments and count through
``adam_state_from_optax``) and holds the port's second step from there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tmar.losses import LossWeights as JLossWeights
from tmar.nn import MultiScaleDiscriminator as FlaxMSD
from tmar.nn import NGswin as FlaxNGswin
from tmar.ops import Radon as JRadon
from tmar.train import GANTrainState as JGANTrainState
from tmar.train import create_train_state as jcreate_train_state
from tmar.train import make_train_step as jmake_train_step
from tmar_torch import (
    LossWeights,
    MultiScaleDiscriminator,
    NGswin,
    create_train_state,
    disc_from_flax,
    from_flax_params,
    make_eval_step,
    make_train_step,
)
from tmar_torch.checkpoint import adam_state_from_optax
from tmar_torch.ops.radon import Radon
from tmar_torch.train import GANTrainState

TINY = dict(
    ngrams=(2, 2, 2, 2), embed_dim=32, depths=(2, 2, 2), num_heads=(2, 2, 2),
    dec_dim=32, dec_depths=2, dec_num_heads=2, window_size=8,
)
G_LR, D_LR, EMA = 1e-4, 2e-4, 0.999
WEIGHTS = dict(phys=0.0, dilation_radius=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch():
    rng = np.random.default_rng(0)
    return {k: rng.uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32) for k in ("ct", "gt")}


def _torch_nets():
    gen = NGswin(**TINY, attn_backward="pallas", device="cpu")
    disc = MultiScaleDiscriminator(base_channels=16, num_scales=2, device="cpu")
    g_opt = torch.optim.Adam(gen.parameters(), G_LR, betas=(0.5, 0.999), eps=1e-8)
    d_opt = torch.optim.Adam(disc.parameters(), D_LR, betas=(0.5, 0.999), eps=1e-8)
    return gen, disc, g_opt, d_opt


@pytest.fixture(scope="module")
def jax_start():
    """The JAX side before its first step: its state and its step, the flax
    NGswin in its default form (``use_pallas_attention=False``, XLA math)."""
    gen = FlaxNGswin(**TINY)
    disc = FlaxMSD(base_channels=16, num_scales=2)
    g_tx = optax.adam(G_LR, b1=0.5, b2=0.999)
    d_tx = optax.adam(D_LR, b1=0.5, b2=0.999)
    jstate = jcreate_train_state(jax.random.PRNGKey(0), gen, disc, g_tx, d_tx, patch_size=64,
                                 ema_decay=EMA)
    jstep = jmake_train_step(gen, disc, g_tx, d_tx, JLossWeights(**WEIGHTS), mesh=None,
                             donate=False, fused_pairs=True, ema_decay=EMA)
    return jstate, jstep


@pytest.fixture(scope="module")
def two_steps(jax_start):
    """Both sides after each of two steps: [(jax state, jax metrics)], and
    the port's state after two steps with its metrics per step."""
    jstate, jstep = jax_start
    tgen, tdisc, g_opt, d_opt = _torch_nets()
    tgen.load_state_dict(from_flax_params(_np(jstate.g_params)))
    tdisc.load_state_dict(disc_from_flax(_np(jstate.d_params), _np(jstate.d_sn)))
    g_ema = {k: p.detach().clone() for k, p in tgen.named_parameters()}
    tstate = GANTrainState(0, tgen, g_opt, tdisc, d_opt, g_ema)
    tstep = make_train_step(tgen, tdisc, g_opt, d_opt, LossWeights(**WEIGHTS), fused_pairs=True,
                            ema_decay=EMA, device="cpu")
    batch = _batch()
    jout, tmetrics = [], []
    for _ in range(2):
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
        jout.append((jstate, {k: float(v) for k, v in jm.items()}))
        tstate, tm = tstep(tstate, batch)
        tmetrics.append({k: float(v) for k, v in tm.items()})
    return jout, tstate, tmetrics


def test_metrics_match_jax_at_both_steps(two_steps):
    jout, _, tmetrics = two_steps
    for (_, jm), tm in zip(jout, tmetrics):
        assert set(tm) == set(jm) == {
            "loss_d", "loss_g", "g_adv", "g_fm", "g_rec", "g_edge", "g_metal", "g_total"}
        for k in jm:
            atol = {"g_adv": 8e-4, "g_total": 8e-5, "loss_g": 8e-5}.get(k, 1e-6)
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=atol, err_msg=k)


def _close_in_lr(got, ref, mu, lr, what):
    """``mu``: the JAX first moments, which tell the well-conditioned
    components (|mu| >= 1e-7, ten times eps) from those whose gradient is rounding noise."""
    worst, noisy, mean, n = 0.0, 0.0, 0.0, 0
    assert set(got) == set(ref) == set(mu), what
    for k in ref:
        d = np.abs(got[k].detach().numpy() - ref[k].numpy())
        well = np.abs(mu[k].numpy()) >= 1e-7
        worst = max(worst, float(d[well].max(initial=0.0)))
        noisy = max(noisy, float(d[~well].max(initial=0.0)))
        mean, n = mean + float(d[well].sum()), n + int(well.sum())
    assert n > 0.8 * sum(v.numel() for v in ref.values()), f"{what}: too few components held"
    assert worst <= 0.2 * lr, f"{what}: max |diff| {worst:.3e} > 0.2 lr"
    assert mean / n <= 0.002 * lr, f"{what}: mean |diff| {mean / n:.3e} > 0.002 lr"
    assert noisy <= 2.1 * lr, f"{what}: max |diff| {noisy:.3e} > 2.1 lr where the gradient is noise"


def test_parameters_and_ema_match_jax_after_two_steps(two_steps):
    jout, tstate, _ = two_steps
    jstate = jout[-1][0]
    assert tstate.step == int(jstate.step) == 2
    g_mu = from_flax_params(_np(jstate.g_opt[0].mu))
    _close_in_lr(dict(tstate.generator.named_parameters()),
                 from_flax_params(_np(jstate.g_params)), g_mu, G_LR, "generator")
    _close_in_lr(tstate.g_ema, from_flax_params(_np(jstate.g_ema)), g_mu, G_LR, "EMA")
    _close_in_lr(dict(tstate.discriminator.named_parameters()),
                 disc_from_flax(_np(jstate.d_params)),
                 disc_from_flax(_np(jstate.d_opt[0].mu)), D_LR, "discriminator")


def test_power_iteration_vectors_match_jax_after_two_steps(two_steps):
    jout, tstate, _ = two_steps
    ref = disc_from_flax({}, _np(jout[-1][0].d_sn))
    got = dict(tstate.discriminator.named_buffers())
    assert set(got) == set(ref) and len(ref) == 2 * 2 * 6
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_adam_moments_match_jax_after_two_steps(two_steps):
    jout, tstate, _ = two_steps
    jstate = jout[-1][0]
    for net, opt, jopt, conv in (
        (tstate.generator, tstate.g_opt, jstate.g_opt, from_flax_params),
        (tstate.discriminator, tstate.d_opt, jstate.d_opt, disc_from_flax),
    ):
        mu, nu = conv(_np(jopt[0].mu)), conv(_np(jopt[0].nu))
        assert int(jopt[0].count) == 2
        for k, p in net.named_parameters():
            st = opt.state[p]
            assert int(st["step"]) == 2
            np.testing.assert_allclose(st["exp_avg"].numpy(), mu[k].numpy(), rtol=2e-3,
                                       atol=1e-7, err_msg=f"exp_avg {k}")
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[k].numpy(), rtol=4e-3,
                                       atol=1e-13, err_msg=f"exp_avg_sq {k}")


def test_g_step_leaves_no_gradient_in_the_discriminator(two_steps):
    """After a step D's .grad is what the D step left (d_opt consumed it):
    the G step's pass through D must not add to it."""
    _, tstate, _ = two_steps
    gen, disc, g_opt, d_opt = _torch_nets()
    gen.load_state_dict(tstate.generator.state_dict())
    disc.load_state_dict(tstate.discriminator.state_dict())
    seen = {}
    d_step = d_opt.step

    def recording_step():
        seen.update({k: p.grad.clone() for k, p in disc.named_parameters()})
        return d_step()

    d_opt.step = recording_step
    step = make_train_step(gen, disc, g_opt, d_opt, LossWeights(**WEIGHTS), fused_pairs=True,
                           device="cpu")
    step(GANTrainState(0, gen, g_opt, disc, d_opt), _batch())
    for k, p in disc.named_parameters():
        assert torch.equal(p.grad, seen[k]), k


def test_ema_wiring_errors_raise():
    gen, disc, g_opt, d_opt = _torch_nets()
    rng = torch.Generator().manual_seed(0)
    with_ema = create_train_state(rng, gen, disc, g_opt, d_opt, ema_decay=EMA)
    without = create_train_state(rng, gen, disc, g_opt, d_opt)
    assert with_ema.g_ema is not None and without.g_ema is None
    args = (gen, disc, g_opt, d_opt, LossWeights(**WEIGHTS))
    with pytest.raises(ValueError, match="g_ema is None"):
        make_train_step(*args, ema_decay=EMA, device="cpu")(without, _batch())
    with pytest.raises(ValueError, match="ema_decay=0"):
        make_train_step(*args, device="cpu")(with_ema, _batch())


def test_create_train_state_draws_from_its_generator():
    def draw(seed):
        gen, disc, g_opt, d_opt = _torch_nets()
        create_train_state(torch.Generator().manual_seed(seed), gen, disc, g_opt, d_opt)
        return {**gen.state_dict(), **{f"d.{k}": v for k, v in disc.state_dict().items()}}

    a, b, c = draw(0), draw(0), draw(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    changed = [k for k in a if not torch.equal(a[k], c[k])]
    assert any(k.startswith("d.") and k.endswith(".u") for k in changed)
    assert any(k.endswith("qkv.weight") for k in changed)
    u = a["d.discriminators_0.conv_0.u"]
    np.testing.assert_allclose(float(u.square().sum()), 1.0, rtol=1e-5)


def test_unfused_pairs_take_four_power_iterations_and_eval_step_runs():
    gen, disc, g_opt, d_opt = _torch_nets()
    calls = []
    conv = disc.discriminators_0.conv_0
    conv.register_forward_hook(lambda m, a, kw, out: calls.append(kw.get("update_sn")),
                               with_kwargs=True)
    state = GANTrainState(0, gen, g_opt, disc, d_opt)
    step = make_train_step(gen, disc, g_opt, d_opt, LossWeights(**WEIGHTS), device="cpu")
    state, metrics = step(state, _batch())
    assert calls == [True] * 4 and state.step == 1
    assert all(np.isfinite(float(v)) for v in metrics.values())
    fake, m = make_eval_step(gen, device="cpu")(_batch())
    assert fake.shape == (2, 64, 64, 1) and not fake.requires_grad
    mse = float((fake - torch.from_numpy(_batch()["gt"])).square().mean())
    np.testing.assert_allclose(float(m["mse"]), mse, rtol=1e-5)
    assert float(m["psnr"]) > 0


def test_trainer_in_the_jax_default_form_matches_jax_after_two_steps(jax_start, two_steps):
    """The port's ``Trainer`` on the JAX package's default ``TrainConfig``
    model form (``use_pallas_attention: false``, ``attn_backward: auto``,
    which the port trains on the kernels' plain versions here) against the
    same two JAX steps, from the same weights: metrics, parameters, EMA and
    Adam moments at the tolerances above."""
    from tmar_torch.train import Trainer, config

    jstate, _ = jax_start
    jout, _, _ = two_steps
    cfg = config.load_config(None, {
        "model.embed_dim": 32, "model.depths": (2, 2, 2), "model.num_heads": (2, 2, 2),
        "model.dec_dim": 32, "model.dec_depths": 2, "model.dec_num_heads": 2,
        "disc.base_channels": 16, "disc.num_scales": 2, "disc.fused_pairs": True,
        "optim.ema_decay": EMA, "loss.phys": 0.0, "loss.dilation_radius": 2,
        "data.patch_size": 64, "bf16": False})
    assert not cfg.model.use_pallas_attention and cfg.model.attn_backward == "auto"
    trainer = Trainer(cfg, device="cpu")
    assert trainer.generator.attn_backward == "auto" and trainer.projector is None
    with torch.no_grad():
        trainer.generator.load_state_dict(from_flax_params(_np(jstate.g_params)))
        trainer.discriminator.load_state_dict(disc_from_flax(_np(jstate.d_params),
                                                             _np(jstate.d_sn)))
    state = trainer.state
    state.g_ema = {k: p.detach().clone() for k, p in trainer.generator.named_parameters()}
    for (_, jm) in jout:
        state, tm = trainer.train_step(state, _batch())
        for k in jm:
            atol = {"g_adv": 8e-4, "g_total": 8e-5, "loss_g": 8e-5}.get(k, 1e-6)
            np.testing.assert_allclose(float(tm[k]), jm[k], rtol=1e-4, atol=atol, err_msg=k)
    last = jout[-1][0]
    g_mu = from_flax_params(_np(last.g_opt[0].mu))
    _close_in_lr(dict(state.generator.named_parameters()), from_flax_params(_np(last.g_params)),
                 g_mu, G_LR, "generator")
    _close_in_lr(state.g_ema, from_flax_params(_np(last.g_ema)), g_mu, G_LR, "EMA")
    _close_in_lr(dict(state.discriminator.named_parameters()), disc_from_flax(_np(last.d_params)),
                 disc_from_flax(_np(last.d_opt[0].mu)), D_LR, "discriminator")
    for k, p in state.generator.named_parameters():
        np.testing.assert_allclose(state.g_opt.state[p]["exp_avg"].numpy(), g_mu[k].numpy(),
                                   rtol=2e-3, atol=1e-7, err_msg=f"exp_avg {k}")


# ---- the full variant: sinogram term, n-gram context fused -------------------
FULL_TINY = dict(TINY, depths=(2, 1, 1), window_size=4)
FULL_WEIGHTS = dict(dilation_radius=2)  # phys stays at its 0.02
FULL_DISC = dict(base_channels=16, num_scales=2, num_layers=3)
ANGLES = np.linspace(0, np.pi, 12, endpoint=False)


def _full_batch():
    rng = np.random.default_rng(1)
    ct = rng.uniform(-1, 0.5, (2, 32, 32, 1)).astype(np.float32)
    ct[0, 8:11, 12:15] = 0.9  # small metal inserts: the sinogram mask leaves most rays in
    ct[1, 20:22, 5:9] = 0.8
    return {"ct": ct, "gt": rng.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32)}


def _full_port_state(jstate):
    """The port's networks, optimizers and state holding what ``jstate`` holds."""
    gen = NGswin(**FULL_TINY, attn_backward="pallas", ngram_fused=True, device="cpu")
    disc = MultiScaleDiscriminator(**FULL_DISC, device="cpu")
    g_opt = torch.optim.Adam(gen.parameters(), G_LR, betas=(0.5, 0.999), eps=1e-8)
    d_opt = torch.optim.Adam(disc.parameters(), D_LR, betas=(0.5, 0.999), eps=1e-8)
    gen.load_state_dict(from_flax_params(_np(jstate.g_params)))
    disc.load_state_dict(disc_from_flax(_np(jstate.d_params), _np(jstate.d_sn)))
    count = int(jstate.g_opt[0].count)
    if count:
        adam_state_from_optax(g_opt, gen.named_parameters(), from_flax_params(_np(jstate.g_opt[0].mu)),
                              from_flax_params(_np(jstate.g_opt[0].nu)), count)
        adam_state_from_optax(d_opt, disc.named_parameters(), disc_from_flax(_np(jstate.d_opt[0].mu)),
                              disc_from_flax(_np(jstate.d_opt[0].nu)), int(jstate.d_opt[0].count))
    g_ema = from_flax_params(_np(jstate.g_ema))
    state = GANTrainState(int(jstate.step), gen, g_opt, disc, d_opt, g_ema)
    step = make_train_step(gen, disc, g_opt, d_opt, LossWeights(**FULL_WEIGHTS),
                           projector=Radon(32, ANGLES, device="cpu"), fused_pairs=True,
                           ema_decay=EMA, device="cpu")
    return state, step


@pytest.fixture(scope="module")
def full_two_steps():
    """JAX after each of two full steps; the port after two steps from the
    same start; the port after one step from JAX's state after its first."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TMAR_NGRAM_FUSED", "1")
    try:
        gen = FlaxNGswin(**FULL_TINY, use_pallas_attention=True, attn_backward="pallas")
        disc = FlaxMSD(**FULL_DISC)
        g_tx = optax.adam(G_LR, b1=0.5, b2=0.999)
        d_tx = optax.adam(D_LR, b1=0.5, b2=0.999)
        # the same parameter tree as the kernel path's, initialised under jit
        g_vars = jax.jit(FlaxNGswin(**FULL_TINY).init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
        d_vars = jax.jit(disc.init)(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 2)))
        jstate = JGANTrainState(
            step=jnp.zeros((), jnp.int32), g_params=g_vars["params"],
            g_opt=g_tx.init(g_vars["params"]), d_params=d_vars["params"], d_sn=d_vars["sn"],
            d_opt=d_tx.init(d_vars["params"]),
            g_ema=jax.tree_util.tree_map(jnp.array, g_vars["params"]),
        )
        jstep = jmake_train_step(gen, disc, g_tx, d_tx, JLossWeights(**FULL_WEIGHTS),
                                 projector=JRadon(32, ANGLES), mesh=None, donate=False,
                                 fused_pairs=True, ema_decay=EMA)
        batch = _full_batch()
        tstate, tstep = _full_port_state(jstate)
        jout, tmetrics = [], []
        for i in range(2):
            jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
            jout.append((jstate, {k: float(v) for k, v in jm.items()}))
            tstate, tm = tstep(tstate, batch)
            tmetrics.append({k: float(v) for k, v in tm.items()})
        carried, cstep = _full_port_state(jout[0][0])
        carried, cm = cstep(carried, batch)
    finally:
        mp.undo()
    return jout, tstate, tmetrics, carried, {k: float(v) for k, v in cm.items()}


def test_full_variant_metrics_match_jax_at_both_steps(full_two_steps):
    jout, _, tmetrics, _, carried_metrics = full_two_steps
    for (_, jm), tm in zip(jout + [jout[1]], tmetrics + [carried_metrics]):
        assert set(tm) == set(jm) == {
            "loss_d", "loss_g", "g_adv", "g_fm", "g_rec", "g_edge", "g_phys", "g_metal", "g_total"}
        assert jm["g_phys"] > 0.1
        for k in jm:
            atol = {"g_adv": 8e-4, "g_total": 8e-5, "loss_g": 8e-5}.get(k, 1e-6)
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=atol, err_msg=k)


def test_full_variant_parameters_ema_and_moments_match_jax_after_two_steps(full_two_steps):
    jout, tstate, _, carried, _ = full_two_steps
    jstate = jout[-1][0]
    g_mu = from_flax_params(_np(jstate.g_opt[0].mu))
    d_mu = disc_from_flax(_np(jstate.d_opt[0].mu))
    for label, st in (("two steps", tstate), ("carried across after JAX's first step", carried)):
        assert st.step == int(jstate.step) == 2
        _close_in_lr(dict(st.generator.named_parameters()), from_flax_params(_np(jstate.g_params)),
                     g_mu, G_LR, f"generator, {label}")
        _close_in_lr(st.g_ema, from_flax_params(_np(jstate.g_ema)), g_mu, G_LR, f"EMA, {label}")
        _close_in_lr(dict(st.discriminator.named_parameters()), disc_from_flax(_np(jstate.d_params)),
                     d_mu, D_LR, f"discriminator, {label}")
        g_nu = from_flax_params(_np(jstate.g_opt[0].nu))
        for k, p in st.generator.named_parameters():
            mom = st.g_opt.state[p]
            assert int(mom["step"]) == 2
            np.testing.assert_allclose(mom["exp_avg"].numpy(), g_mu[k].numpy(), rtol=2e-3,
                                       atol=1e-7, err_msg=f"exp_avg {k}, {label}")
            np.testing.assert_allclose(mom["exp_avg_sq"].numpy(), g_nu[k].numpy(), rtol=4e-3,
                                       atol=1e-13, err_msg=f"exp_avg_sq {k}, {label}")


def test_adam_state_from_optax_carries_moments_and_count(full_two_steps):
    jout, _, _, _, _ = full_two_steps
    jstate = jout[0][0]
    state, _ = _full_port_state(jstate)
    mu = from_flax_params(_np(jstate.g_opt[0].mu))
    for k, p in state.generator.named_parameters():
        mom = state.g_opt.state[p]
        assert float(mom["step"]) == 1.0 and torch.equal(mom["exp_avg"], mu[k])
    with pytest.raises(ValueError, match="shape mismatch"):
        adam_state_from_optax(state.g_opt, [("w", torch.zeros(2))], {"w": torch.zeros(3)},
                              {"w": torch.zeros(3)}, 1)
