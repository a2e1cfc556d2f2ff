"""The port's NGswin (tmar_torch) against the flax NGswin (tmar) on the same
seeded numpy inputs and the same weights, at float32, on the CPU.

The flax model runs its XLA path, which computes the same function as its
fused kernels (tests/test_ngswin_pallas.py holds the two together).
Tolerance atol 5e-5, rtol 1e-4: the JAX package's model-level tolerance."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.checkpoint import import_ngswin_state_dict
from tmar.eval.inference import tiled_eval as jtiled_eval
from tmar.nn import NGswin as FlaxNGswin
from tmar_torch import NGswin, from_flax_params, load_pth, make_inference_fn, tiled_eval
from tmar_torch.checkpoint import to_flax_params

TOL = dict(atol=5e-5, rtol=1e-4)
FLAGSHIP = pathlib.Path(__file__).parents[1] / "reports" / "compare_r4" / "flagship.pth"
TINY = dict(
    ngrams=(2, 2, 2, 2), embed_dim=32, depths=(2, 2, 2), num_heads=(2, 2, 2),
    dec_dim=32, dec_depths=2, dec_num_heads=2, window_size=8,
)


@pytest.fixture(scope="module")
def tiny():
    x = jnp.zeros((1, 64, 64, 1), jnp.float32)
    flax_model = FlaxNGswin(**TINY)
    params = jax.jit(flax_model.init)(jax.random.PRNGKey(0), x)["params"]
    model = NGswin(**TINY, device="cpu")
    model.load_state_dict(from_flax_params(params))
    return flax_model, params, model


@pytest.mark.parametrize("hw", [(64, 64), (40, 72)])
def test_tiny_ngswin_matches_flax(tiny, hw):
    flax_model, params, model = tiny
    x = np.random.default_rng(0).uniform(-1, 1, (1, *hw, 1)).astype(np.float32)
    ref = np.asarray(jax.jit(flax_model.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.fixture(scope="module")
def flagship():
    sd = load_pth(FLAGSHIP)
    params = import_ngswin_state_dict({k: v.numpy() for k, v in sd.items()})
    return sd, params


def test_full_width_flagship_matches_flax(flagship):
    sd, params = flagship
    model = NGswin(device="cpu")
    model.load_state_dict(sd)
    assert sum(p.numel() for p in model.parameters()) == 990_811
    x = np.random.default_rng(1).uniform(-1, 1, (1, 64, 64, 1)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, v: FlaxNGswin().apply({"params": p}, v))(
        params, jnp.asarray(x)))
    got = make_inference_fn(model, device="cpu")(x)
    np.testing.assert_allclose(got, ref, **TOL)


def test_from_flax_params_is_the_reference_layout(flagship):
    sd, params = flagship
    converted = from_flax_params(params)
    assert set(converted) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(converted[k].numpy(), v.numpy(), err_msg=k)


def test_flops_match_flax():
    for res in ((512, 512), (416, 416), (64, 96)):
        assert NGswin(device="cpu").flops(res) == FlaxNGswin().flops(res)


@pytest.mark.parametrize("shape,tile_batch", [((1, 160, 96, 1), 4), ((2, 64, 100, 1), 64)])
def test_tiled_eval_matches_jax(shape, tile_batch):
    """Same forward, same tiles: the host-side assembly must agree exactly."""
    x = np.random.default_rng(2).uniform(-1, 1, shape).astype(np.float32)

    def forward(t):
        assert t.shape[0] == tile_batch
        return np.tanh(2.0 * t + np.arange(t.shape[0], dtype=np.float32)[:, None, None, None])

    np.testing.assert_array_equal(
        tiled_eval(forward, x, 64, 32, tile_batch), jtiled_eval(forward, x, 64, 32, tile_batch)
    )


# two encoder stages at embed 16: the SCDP bottleneck's depthwise conv takes
# the 16 + 4 = 20 concatenated channels in (1 + 4)·16/16 = 5 groups of 4
TWO_STAGES = dict(
    ngrams=(2, 2, 2), embed_dim=16, depths=(2, 2), num_heads=(2, 2),
    dec_dim=16, dec_depths=2, dec_num_heads=2, window_size=8,
)


@pytest.fixture(scope="module")
def two_stages():
    """The flax tree's shapes from ``jax.eval_shape`` (no init compile),
    filled with seeded normal weights, and the port's model holding them."""
    shapes = jax.eval_shape(FlaxNGswin(**TWO_STAGES).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 1)))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda s: (0.2 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    model = NGswin(**TWO_STAGES, device="cpu")
    model.load_state_dict(from_flax_params(params))
    return params, model


def test_two_stage_ngswin_matches_flax(two_stages):
    params, model = two_stages
    assert model.bottleneck.depthwise.weight.shape == (5, 4, 3, 3)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
    ref = np.asarray(jax.jit(FlaxNGswin(**TWO_STAGES).apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, ref, **TOL)


def test_to_flax_params_inverts_from_flax_params(two_stages):
    params, model = two_stages
    back = to_flax_params(model.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(flat) == set(flat_back)
    for k, v in flat.items():
        np.testing.assert_array_equal(flat_back[k], v, err_msg=jax.tree_util.keystr(k))


def test_four_stage_bottleneck_raises_in_both_packages():
    """At four stages of embed 64 the formula gives 340 groups for 85
    concatenated channels: flax's conv asserts, and so does the port's
    bottleneck, at the same point of the forward."""
    cfg = dict(ngrams=(2,) * 5, embed_dim=64, depths=(1,) * 4, num_heads=(2,) * 4,
               dec_dim=32, dec_depths=1, dec_num_heads=2, window_size=4)
    x = np.zeros((1, 64, 64, 1), np.float32)
    with pytest.raises(AssertionError):
        jax.eval_shape(FlaxNGswin(**cfg).init, jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(AssertionError, match="340 groups do not divide 85 input channels"), \
            torch.no_grad():
        NGswin(**cfg, device="cpu")(torch.from_numpy(x))
