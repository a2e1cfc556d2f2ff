"""The port's spectral-norm conv and PatchGAN discriminators
(tmar_torch.nn.spectral_norm, nn.patchgan) against the flax modules, on the
same seeded numpy inputs and the same weights and power-iteration vectors
(carried across by ``disc_from_flax``), at float32 on the CPU.

Tolerance atol 1e-5, rtol 1e-4 on u, v, sigma, logits and features: the two
frameworks' convolutions sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.nn import MultiScaleDiscriminator as FlaxMSD
from tmar.nn.patchgan import ConditionalDiscriminator as FlaxCond
from tmar.nn.spectral_norm import SNConv as FlaxSNConv
from tmar_torch.checkpoint import disc_from_flax
from tmar_torch.nn.patchgan import ConditionalDiscriminator, MultiScaleDiscriminator
from tmar_torch.nn.spectral_norm import SNConv
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

TOL = dict(atol=1e-5, rtol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_snconv_power_iteration_and_sigma_match_flax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    flax_conv = FlaxSNConv(features=8, kernel_size=(4, 4), strides=2, padding=((1, 1), (1, 1)))
    variables = flax_conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"kernel": variables["params"]["kernel"] * 20.0, "bias": variables["params"]["bias"] + 0.1}
    sn = variables["sn"]
    conv = SNConv(3, 8, 4, stride=2, padding=1)
    conv.load_state_dict(disc_from_flax(_np(params), _np(sn)))
    np.testing.assert_array_equal(conv.u.numpy(), np.asarray(sn["u"]))

    # frozen vectors, then one and two updates: y, u, v each time
    for update in (False, True, True):
        ref, mut = flax_conv.apply({"params": params, "sn": sn}, jnp.asarray(x),
                                   update_sn=update, mutable=["sn"])
        sn = mut["sn"]
        got = conv(torch.from_numpy(x), update_sn=update)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
        np.testing.assert_allclose(conv.u.numpy(), np.asarray(sn["u"]), **TOL)
        np.testing.assert_allclose(conv.v.numpy(), np.asarray(sn["v"]), **TOL)

    # sigma is differentiable through the weight, the vectors are constants
    def loss(p):
        return jnp.sum(flax_conv.apply({"params": p, "sn": sn}, jnp.asarray(x)) ** 2)

    ref_g = jax.grad(loss)(params)
    conv.zero_grad()
    conv(torch.from_numpy(x)).square().sum().backward()
    np.testing.assert_allclose(conv.weight.grad.numpy(),
                               np.asarray(ref_g["kernel"]).transpose(3, 2, 0, 1),
                               atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("use_sn", [True, False])
def test_multiscale_discriminator_matches_flax(use_sn):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 64, 64, 2)).astype(np.float32)
    flax_d = FlaxMSD(base_channels=16, num_scales=2, use_sn=use_sn)
    variables = flax_d.init(jax.random.PRNGKey(1), jnp.asarray(x))
    disc = MultiScaleDiscriminator(base_channels=16, num_scales=2, use_sn=use_sn, device="cpu")
    sd = disc_from_flax(_np(variables["params"]), _np(variables.get("sn", {})))
    assert set(sd) == set(disc.state_dict())
    disc.load_state_dict(sd)
    if use_sn:
        (ref_logits, ref_feats), mut = flax_d.apply(variables, jnp.asarray(x), update_sn=True,
                                                    mutable=["sn"])
        logits, feats = disc(torch.from_numpy(x), update_sn=True)
        new = disc_from_flax(_np(variables["params"]), _np(mut["sn"]))
        for k, v in disc.state_dict().items():
            np.testing.assert_allclose(v.numpy(), new[k].numpy(), err_msg=k, **TOL)
    else:
        ref_logits, ref_feats = flax_d.apply(variables, jnp.asarray(x))
        logits, feats = disc(torch.from_numpy(x))
    assert len(logits) == len(ref_logits) == 2 and len(feats[0]) == len(ref_feats[0]) == 4
    for a, b in zip(logits, ref_logits):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    for fa, fb in zip(feats, ref_feats):
        for a, b in zip(fa, fb):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    assert disc(torch.from_numpy(x), return_features=False)[1] is None


def test_too_small_an_input_is_refused():
    disc = MultiScaleDiscriminator(base_channels=8, num_scales=3, device="cpu")
    with pytest.raises((ValueError, RuntimeError)):
        disc(torch.zeros(1, 64, 64, 2))


def test_conditional_discriminator_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
    cond = rng.uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
    flax_d = FlaxCond(base_channels=8)
    variables = flax_d.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(cond))
    disc = ConditionalDiscriminator(base_channels=8, device="cpu")
    sd = disc_from_flax(_np(variables["params"]))
    assert set(sd) == set(disc.state_dict())
    disc.load_state_dict(sd)
    ref = flax_d.apply(variables, jnp.asarray(x), jnp.asarray(cond))
    got = disc(torch.from_numpy(x), torch.from_numpy(cond))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-3)
