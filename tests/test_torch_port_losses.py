"""The port's morphology, image gradients and GAN / metal-aware losses
(tmar_torch.ops.morphology, ops.gradients, losses.gan_losses) against the
JAX package's, value and gradient in the generated image, on the same seeded
numpy inputs, at float32 on the CPU.

Tolerance atol 1e-6, rtol 1e-5: elementwise arithmetic and means, which
differ in summation order only.  With a Radon projector the sinogram term
sums up to 24 products per ray in another order: its value, the total and
the gradient take rtol 1e-5 + atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tmar.losses as jl
import tmar_torch.losses as tl
from tmar.ops import Radon as JRadon
from tmar.ops.gradients import image_gradients as jimage_gradients
from tmar.ops.morphology import dilate_mask as jdilate
from tmar_torch.core import BF16_POLICY, DEFAULT_POLICY
from tmar_torch.ops.gradients import image_gradients
from tmar_torch.ops.morphology import dilate_mask
from tmar_torch.ops.radon import Radon
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

TOL = dict(atol=1e-6, rtol=1e-5)
RNG = np.random.default_rng(0)
SHAPE = (2, 24, 20, 1)
FAKE, REAL, CT = (RNG.uniform(-1, 1, SHAPE).astype(np.float32) for _ in range(3))
# 2 scales of logits, 2 scales x 2 layers of features, for a batch of 2
LOGITS_R, LOGITS_F = ([RNG.standard_normal(s).astype(np.float32) * 2 for s in ((2, 5, 5, 1), (2, 2, 2, 1))]
                      for _ in range(2))
FEATS_R, FEATS_F = ([[RNG.standard_normal(s).astype(np.float32) for s in ((2, 6, 6, 4), (2, 3, 3, 8))]
                     for _ in range(2)] for _ in range(2))


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    return [_t(x) for x in tree]


@pytest.mark.parametrize("radius", [0, 2, 5])
def test_dilate_mask_matches_jax(radius):
    m = (CT > 0.6).astype(np.float32)
    np.testing.assert_array_equal(dilate_mask(_t(m), radius).numpy(), np.asarray(jdilate(_j(m), radius)))
    np.testing.assert_array_equal(dilate_mask(_t(m[..., 0]), radius).numpy(),
                                  np.asarray(jdilate(_j(m[..., 0]), radius)))


def test_image_gradients_match_jax():
    for got, ref in zip(image_gradients(_t(FAKE)), jimage_gradients(_j(FAKE))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name,args", [
    ("hinge_d_loss", (LOGITS_R, LOGITS_F)),
    ("hinge_g_loss", (LOGITS_F,)),
    ("vanilla_d_loss", (LOGITS_R, LOGITS_F)),
    ("vanilla_g_loss", (LOGITS_F,)),
    ("feature_matching_loss", (FEATS_R, FEATS_F)),
    ("extract_metal_mask", (CT,)),
    ("compute_weight_map", (CT, 1.0, 3, 3.0, 0.6)),
    ("compute_metal_aware_loss", (FAKE, REAL, CT, 1.0, 3)),
    ("compute_metal_aware_edge_loss", (FAKE, REAL, np.abs(CT) + 1)),
    ("metal_consistency_loss", (FAKE, REAL, (CT > 0.6).astype(np.float32))),
])
def test_loss_matches_jax(name, args):
    ref = getattr(jl, name)(*[_j(a) if isinstance(a, (list, np.ndarray)) else a for a in args])
    got = getattr(tl, name)(*[_t(a) if isinstance(a, (list, np.ndarray)) else a for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("weights", [
    dict(phys=0.0, dilation_radius=2),
    dict(phys=0.02, dilation_radius=2),             # no projector: the term is skipped
    dict(phys=0.0, gan_mode="vanilla", fm=0.0, edge=0.0),
    dict(phys=0.0, adv=0.0, fm=0.0, metal=0.0),
])
def test_generator_loss_assembly_and_gradient_match_jax(weights):
    def ref_fn(fake):
        return jl.generator_loss(fake, _j(REAL), _j(CT), _j(LOGITS_F), _j(FEATS_F), _j(FEATS_R),
                                 jl.LossWeights(**weights))

    (ref_total, ref_terms), ref_grad = jax.value_and_grad(ref_fn, has_aux=True)(_j(FAKE))
    fake = _t(FAKE).requires_grad_()
    total, terms = tl.generator_loss(fake, _t(REAL), _t(CT), _t(LOGITS_F), _t(FEATS_F),
                                     _t(FEATS_R), tl.LossWeights(**weights))
    assert set(terms) == set(ref_terms) and "phys" not in terms
    for k in terms:
        np.testing.assert_allclose(float(terms[k].detach()), float(ref_terms[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(float(total), float(ref_total), **TOL)
    (grad,) = torch.autograd.grad(total, fake)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), atol=1e-7, rtol=1e-5)


def test_loss_weights_defaults_match_jax():
    assert dataclasses.asdict(tl.LossWeights()) == dataclasses.asdict(jl.LossWeights())


@pytest.mark.parametrize("weights", [
    dict(dilation_radius=2),                                  # the full recipe
    dict(adv=0.0, fm=0.0, rec=0.0, edge=0.0, metal=0.0),      # the sinogram term alone
])
def test_generator_loss_with_a_projector_matches_jax(weights):
    """``generator_loss`` with a Radon projector: the ``phys`` term is there,
    and terms, total and d/d(fake) agree with the JAX package."""
    size = 24
    rng = np.random.default_rng(1)
    fake, real = (rng.uniform(-1, 1, (2, size, size, 1)).astype(np.float32) for _ in range(2))
    ct = rng.uniform(-1, 0.5, (2, size, size, 1)).astype(np.float32)
    ct[0, 8:11, 12:15] = 0.9   # a small metal insert in each slice
    ct[1, 15:17, 4:8] = 0.8
    angles = np.linspace(0, np.pi, 10, endpoint=False)
    jproj, tproj = JRadon(size, angles), Radon(size, angles, device="cpu")
    logits = [rng.standard_normal(s).astype(np.float32) for s in ((2, 3, 3, 1), (2, 1, 1, 1))]

    def ref_fn(f):
        return jl.generator_loss(f, _j(real), _j(ct), _j(logits), _j(FEATS_F), _j(FEATS_R),
                                 jl.LossWeights(**weights), projector=jproj)

    (ref_total, ref_terms), ref_grad = jax.value_and_grad(ref_fn, has_aux=True)(_j(fake))
    f = _t(fake).requires_grad_()
    total, terms = tl.generator_loss(f, _t(real), _t(ct), _t(logits), _t(FEATS_F), _t(FEATS_R),
                                     tl.LossWeights(**weights), projector=tproj)
    assert set(terms) == set(ref_terms) and "phys" in terms and float(terms["phys"]) > 0
    for k in terms:
        np.testing.assert_allclose(float(terms[k].detach()), float(ref_terms[k]), err_msg=k,
                                   rtol=1e-5, atol=1e-5)
    (grad,) = torch.autograd.grad(total, f)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), atol=1e-7, rtol=1e-4)


def test_precision_policies():
    tree = {"a": torch.ones(2), "b": [torch.ones(2, dtype=torch.int32), (torch.zeros(1),)]}
    cast = BF16_POLICY.cast_to_compute(tree)
    assert cast["a"].dtype == torch.bfloat16 and cast["b"][0].dtype == torch.int32
    assert cast["b"][1][0].dtype == torch.bfloat16
    assert BF16_POLICY.cast_to_output(cast)["a"].dtype == torch.float32
    assert DEFAULT_POLICY.cast_to_compute(tree)["a"].dtype == torch.float32
