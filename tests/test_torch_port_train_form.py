"""The port's NGswin in its training form (``attn_backward="pallas"``: the
n-gram context on its composition path, attention and FFN through the fused
wrappers) against the flax NGswin, on the same seeded numpy input and the
same weights, at float32 on the CPU: the output, and the gradient of a
scalar loss in every parameter.

The flax model runs its XLA path, which computes the same function and the
same gradients as its Pallas kernels (tests/test_pallas_attention_bwd.py and
tests/test_pallas_ffn.py hold those together; tests/test_torch_port_attention.py
and test_torch_port_ffn.py hold the port's wrappers against the kernels).
Tolerance: output atol 5e-5, rtol 1e-4 (the JAX package's model-level
tolerance); gradients atol 2e-6 + rtol 2e-3 on values of order 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.nn import NGswin as FlaxNGswin
from tmar.ops.ngram import seq_refl_win_pad as jpad
from tmar.ops.ngram import sliding_patches as jpatches
from tmar_torch import NGswin, from_flax_params
from tmar_torch.ops.ngram import ngram_windows
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

TINY = dict(
    ngrams=(2, 2, 2, 2), embed_dim=32, depths=(2, 2, 2), num_heads=(2, 2, 2),
    dec_dim=32, dec_depths=2, dec_num_heads=2, window_size=8,
)


@pytest.fixture(scope="module")
def tiny():
    flax_model = FlaxNGswin(**TINY)
    params = jax.jit(flax_model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))["params"]
    # the initial relative-position tables and biases are tiny or zero:
    # perturb every leaf so that each gradient path carries signal
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(0.05 * rng.standard_normal(p.shape).astype(np.float32)), params
    )
    model = NGswin(**TINY, attn_backward="pallas", device="cpu")
    model.load_state_dict(from_flax_params(params))
    x = np.random.default_rng(0).uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((2, 64, 64, 1)).astype(np.float32)
    return flax_model, params, model, x, w


def test_training_form_output_matches_flax(tiny):
    flax_model, params, model, x, _ = tiny
    ref = np.asarray(jax.jit(flax_model.apply)({"params": params}, jnp.asarray(x)))
    got = model(torch.from_numpy(x))
    assert got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=5e-5, rtol=1e-4)


def test_training_form_parameter_gradients_match_flax(tiny):
    flax_model, params, model, x, w = tiny

    def loss(p):
        return jnp.mean(flax_model.apply({"params": p}, jnp.asarray(x)) * jnp.asarray(w))

    ref = from_flax_params(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params)))
    model.zero_grad()
    (model(torch.from_numpy(x)) * torch.from_numpy(w)).mean().backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(ref)
    for k in sorted(ref):
        assert got[k] is not None, k
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=2e-6, rtol=2e-3, err_msg=k)


def test_training_and_inference_forms_share_one_state_dict(tiny):
    _, _, model, x, _ = tiny
    served = NGswin(**TINY, device="cpu")
    assert set(served.state_dict()) == set(model.state_dict())
    served.load_state_dict(model.state_dict())
    with torch.no_grad():
        a = served(torch.from_numpy(x)).numpy()
        b = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("form", ["auto", "xla"])
def test_kernel_forms_under_autograd_match_the_training_form(tiny, form, monkeypatch):
    """``"auto"`` and ``"xla"`` under autograd give the ``"pallas"`` form's
    loss and every parameter gradient on the same weights, through the
    training form's path: the forward-only whole-block kernels (and their
    plain versions here) are never called."""
    from tmar_torch.nn import blocks

    _, _, model, x, w = tiny

    def forward_only(*_, **__):
        raise AssertionError("a forward-only whole-block kernel ran under autograd")

    monkeypatch.setattr(blocks, "fused_nstb_map", forward_only)
    monkeypatch.setattr(blocks, "fused_nstb", forward_only)
    other = NGswin(**TINY, attn_backward=form, device="cpu")
    other.load_state_dict(model.state_dict())
    losses, grads = [], []
    for net in (model, other):
        net.zero_grad()
        loss = (net(torch.from_numpy(x)) * torch.from_numpy(w)).mean()
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({k: p.grad for k, p in net.named_parameters()})
    np.testing.assert_allclose(losses[1], losses[0], atol=2e-6, rtol=2e-3)
    assert set(grads[1]) == set(grads[0])
    for k in sorted(grads[0]):
        assert grads[1][k] is not None, k
        np.testing.assert_allclose(grads[1][k].numpy(), grads[0][k].numpy(), atol=2e-6, rtol=2e-3,
                                   err_msg=k)


def test_unknown_attn_backward_is_refused():
    with pytest.raises(ValueError, match="attn_backward"):
        NGswin(**TINY, attn_backward="bogus", device="cpu")


@pytest.mark.parametrize("back", [False, True])
@pytest.mark.parametrize("wh,ww", [(2, 2), (3, 5), (16, 16)])
def test_ngram_windows_and_their_transpose_match_jax(wh, ww, back):
    """The composition path's one-gather windows against the JAX package's
    pad-and-slice construction, values exactly and the cotangent's way back
    (a deterministic gather-and-sum) at atol 1e-5."""
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, wh, ww, 6)).astype(np.float32)
    g = rng.standard_normal((2 * wh * ww, 4, 6)).astype(np.float32)
    ref, vjp = jax.vjp(
        lambda t: jpatches(jpad(t, 2, back=back), 2).reshape(2 * wh * ww, 4, 6), jnp.asarray(u))
    leaf = torch.from_numpy(u).requires_grad_()
    got = ngram_windows(leaf, 2, back=back)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    (du,) = torch.autograd.grad(got, leaf, torch.from_numpy(g))
    np.testing.assert_allclose(du.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-5)
