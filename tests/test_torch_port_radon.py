"""The port's Radon projector (tmar_torch.ops.radon) and sinogram term
against the JAX package's (tmar.ops.Radon at Precision.HIGHEST,
tmar.losses.physics_loss_syn), on the same seeded numpy inputs, at float32
on the CPU.

Tolerance: atol 1e-4 relative to the largest value of the reference result
(sums of up to 128 float32 products in another order on both sides); the
constants are built by the same float64 numpy code and are held equal bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tmar.losses as jl
import tmar_torch.losses as tl
from tmar.ops import Radon as JRadon
from tmar_torch.ops.radon import Radon
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

RNG = np.random.default_rng(0)


def _pair(size, num_angles, det=None):
    angles = np.linspace(0, np.pi, num_angles, endpoint=False)
    return JRadon(size, angles, det_count=det), Radon(size, angles, det_count=det, device="cpu")


def _close(got, ref, what):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape, what
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                               err_msg=what)


@pytest.fixture(scope="module", params=[(24, 10, 31), (32, 12, None)], ids=["det31", "det32"])
def small(request):
    size, num_angles, det = request.param
    jr, tr = _pair(size, num_angles, det)
    img = RNG.uniform(-1, 1, (3, size, size)).astype(np.float32)
    sino = RNG.standard_normal((3, num_angles, tr.det_count)).astype(np.float32)
    return jr, tr, img, sino


def test_constants_equal_the_jax_package_s(small):
    jr, tr, _, _ = small
    np.testing.assert_array_equal(tr._proj_mat.numpy(), jr._proj_mat)
    np.testing.assert_array_equal(tr._shift_bins.numpy(), jr._shift_bins)
    assert (tr._k_min, tr._K, tr._s_pad) == (jr._k_min, jr._K, jr._s_pad)
    assert tr._proj_mat.device.type == "cpu" and tr.det_count == jr.det_count


def test_forward_matches_jax(small):
    jr, tr, img, _ = small
    _close(tr.forward(torch.from_numpy(img)), jr.forward(jnp.asarray(img)), "forward")
    _close(tr(torch.from_numpy(img[..., None])), jr(jnp.asarray(img[..., None])), "forward NHWC")


def test_adjoint_matches_jax(small):
    jr, tr, _, sino = small
    _close(tr.backward(torch.from_numpy(sino)), jr.backward(jnp.asarray(sino)), "adjoint")


def test_filter_and_fbp_match_jax(small):
    jr, tr, img, sino = small
    _close(tr.filter_sinogram(torch.from_numpy(sino)), jr.filter_sinogram(jnp.asarray(sino)), "filter")
    _close(tr.fbp(torch.from_numpy(sino)), jr.fbp(jnp.asarray(sino)), "fbp")


def test_adjoint_identity(small):
    """<P x, y> = <x, P^T y> to float32 rounding (rtol 1e-5 in float64 sums)."""
    _, tr, img, sino = small
    x, y = torch.from_numpy(img), torch.from_numpy(sino)
    lhs = float((tr.forward(x).double() * y.double()).sum())
    rhs = float((x.double() * tr.backward(y).double()).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)


def test_autograd_of_each_direction_is_the_other(small):
    """The gradient of a sinogram loss is the adjoint of its cotangent, and
    the gradient through the adjoint is the forward: bit for bit, since the
    backward of each Function calls the other's implementation."""
    _, tr, img, sino = small
    x = torch.from_numpy(img).requires_grad_()
    y = torch.from_numpy(sino)
    (gx,) = torch.autograd.grad((tr.forward(x) * y).sum(), x)
    assert torch.equal(gx, tr.backward(y))
    s = torch.from_numpy(sino).requires_grad_()
    w = torch.from_numpy(img)
    (gs,) = torch.autograd.grad((tr.backward(s) * w).sum(), s)
    assert torch.equal(gs, tr.forward(w))


def test_full_size_forward_and_adjoint_match_jax():
    """128² x 180 angles, the training geometry, once."""
    jr, tr = _pair(128, 180)
    img = RNG.uniform(-1, 1, (1, 128, 128)).astype(np.float32)
    sino = RNG.standard_normal((1, 180, 128)).astype(np.float32)
    _close(tr.forward(torch.from_numpy(img)), jr.forward(jnp.asarray(img)), "forward 128² x 180")
    _close(tr.backward(torch.from_numpy(sino)), jr.backward(jnp.asarray(sino)), "adjoint 128² x 180")


def test_physics_loss_value_and_gradient_match_jax():
    """mean[(1 - Mp)|P(fake) - P(real)|]: value rtol 1e-5; d/d(fake) atol 1e-4
    of its largest entry."""
    jr, tr = _pair(32, 12)
    fake, real = (RNG.uniform(-1, 1, (2, 32, 32, 1)).astype(np.float32) for _ in range(2))
    mask = np.zeros((2, 32, 32, 1), np.float32)
    mask[0, 10:13, 14:17] = 1.0
    mask[1, 20:22, 5:8] = 1.0
    ref, ref_grad = jax.value_and_grad(
        lambda f: jl.physics_loss_syn(f, jnp.asarray(real), jnp.asarray(mask), jr))(jnp.asarray(fake))
    f = torch.from_numpy(fake).requires_grad_()
    got = tl.physics_loss_syn(f, torch.from_numpy(real), torch.from_numpy(mask), tr)
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    assert 0 < float(got)
    (grad,) = torch.autograd.grad(got, f)
    _close(grad, ref_grad, "d physics_loss_syn / d fake")


def test_precision_names_and_device_rules(monkeypatch):
    with pytest.raises(ValueError, match="precision"):
        Radon(16, precision="bf16", device="cpu")
    for name in ("highest", "high", "default"):
        assert Radon(16, np.linspace(0, np.pi, 4, endpoint=False), precision=name,
                     device="cpu").precision == name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Radon(16)
    before = torch.backends.cuda.matmul.allow_tf32
    Radon(16, np.linspace(0, np.pi, 4, endpoint=False), precision="default",
          device="cpu").forward(torch.zeros(1, 16, 16))
    assert torch.backends.cuda.matmul.allow_tf32 == before
    with pytest.raises(ValueError, match="was given a tensor on"):
        Radon(16, device="cpu").forward(torch.zeros(1, 16, 16, device="meta"))
