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
def two_steps():
    """Both sides after each of two steps: [(jax state, jax metrics)], and
    the port's state after two steps with its metrics per step."""
    gen = FlaxNGswin(**TINY)
    disc = FlaxMSD(base_channels=16, num_scales=2)
    g_tx = optax.adam(G_LR, b1=0.5, b2=0.999)
    d_tx = optax.adam(D_LR, b1=0.5, b2=0.999)
    jstate = jcreate_train_state(jax.random.PRNGKey(0), gen, disc, g_tx, d_tx, patch_size=64,
                                 ema_decay=EMA)
    jstep = jmake_train_step(gen, disc, g_tx, d_tx, JLossWeights(**WEIGHTS), mesh=None,
                             donate=False, fused_pairs=True, ema_decay=EMA)

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
