"""The n-gram context for n other than 2 (``model.ngrams``) against the JAX
package, at float32 on the CPU.

With n != 2 the port takes the composition path whatever ``ngram_fused``
says (the fused kernels are built for n = 2, as the JAX package's are): both
directional n x n sliding attentions through ``ngram_attn`` at N = n² tokens,
their token means and the merge.  n = 1 reads the unpadded grid.

* A tiny NGswin with ``ngrams=(1, 3, 3, 1)``, its weights converted from
  flax by ``from_flax_params``, against the flax NGswin on a 48² input at
  window 4 (window grids 12, 6, 3 and 12): the output in the inference and the
  training form at atol 5e-5, rtol 1e-4 (the JAX package's model-level
  tolerance), and the gradient of a scalar loss in every parameter at
  atol 2e-6 + rtol 2e-3.
* The sliding windows of n = 1, 2, 3 against ``sliding_patches`` of
  ``seq_refl_win_pad`` exactly; the (2n-1)² relative-position tables; the
  too-small grid's message; a tiny ``Trainer`` taking steps with n = 1, 3;
  the window-attention kernels' geometry list (N = 1, 4, 9 among them)
  equal to the Python wrapper's.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.nn import NGswin as FlaxNGswin
from tmar.ops.ngram import seq_refl_win_pad as jpad
from tmar.ops.ngram import sliding_patches as jpatches
from tmar_torch import NGswin, from_flax_params
from tmar_torch.data import Loader
from tmar_torch.nn import ngram as tngram
from tmar_torch.nn.window_attention import WindowAttention
from tmar_torch.ops.cuda_attention import KERNEL_GEOMETRIES
from tmar_torch.ops.ngram import ngram_windows
from tmar_torch.train import Trainer, config, variants
from tmar_torch.train.trainer import build_dataset
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

TINY = dict(
    ngrams=(1, 3, 3, 1), embed_dim=32, depths=(2, 1, 1), num_heads=(2, 2, 2),
    dec_dim=32, dec_depths=2, dec_num_heads=2, window_size=4,
)


@pytest.fixture(scope="module")
def tiny():
    flax_model = FlaxNGswin(**TINY)
    params = jax.jit(flax_model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 48, 48, 1)))["params"]
    # the initial relative-position tables and biases are tiny or zero:
    # perturb every leaf so that each gradient path carries signal
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(0.05 * rng.standard_normal(p.shape).astype(np.float32)), params
    )
    x = np.random.default_rng(0).uniform(-1, 1, (2, 48, 48, 1)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((2, 48, 48, 1)).astype(np.float32)
    out = np.asarray(jax.jit(flax_model.apply)({"params": params}, jnp.asarray(x)))
    return flax_model, params, x, w, out


def _model(params, **kw):
    model = NGswin(**TINY, device="cpu", **kw)
    model.load_state_dict(from_flax_params(params))
    return model


def test_converted_tables_are_2n_minus_1_squared(tiny):
    params = tiny[1]
    sd = from_flax_params(params)
    model = NGswin(**TINY, device="cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    tables = {k: tuple(v.shape) for k, v in sd.items()
              if "ngram_attn.relative_position_bias_table" in k}
    sizes = {k.split(".")[0]: s for k, s in tables.items()}
    assert set(sizes.values()) == {(1, 2), (25, 2)}  # (2n-1)² rows at n = 1 and 3
    for n in (1, 2, 3):
        assert tuple(WindowAttention(16, 2, (n, n)).relative_position_bias_table.shape) == \
            ((2 * n - 1) ** 2, 2)


@pytest.mark.parametrize("form", ["auto", "pallas"], ids=["inference", "training"])
def test_tiny_ngswin_with_n_1_and_3_matches_flax(tiny, form):
    _, params, x, _, ref = tiny
    model = _model(params, attn_backward=form)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)


def test_tiny_ngswin_with_n_1_and_3_parameter_gradients_match_flax(tiny):
    flax_model, params, x, w, _ = tiny

    def loss(p):
        return jnp.mean(flax_model.apply({"params": p}, jnp.asarray(x)) * jnp.asarray(w))

    ref = from_flax_params(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params)))
    model = _model(params, attn_backward="pallas")
    (model(torch.from_numpy(x)) * torch.from_numpy(w)).mean().backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(ref)
    for k in sorted(ref):
        assert got[k] is not None, k
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=2e-6, rtol=2e-3, err_msg=k)


@pytest.mark.parametrize("back", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_ngram_windows_equal_the_jax_sliding_patches(n, back):
    u = np.random.default_rng(n).standard_normal((2, 5, 7, 3)).astype(np.float32)
    padded = jnp.asarray(u) if n == 1 else jpad(jnp.asarray(u), n, back=back)
    ref = np.asarray(jpatches(padded, n)).reshape(2 * 5 * 7, n * n, 3)
    got = ngram_windows(torch.from_numpy(u), n, back=back).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [1, 3])
def test_n_other_than_2_takes_the_composition_whatever_ngram_fused_says(monkeypatch, n):
    def refuse(*a, **k):
        raise AssertionError("the fused n-gram kernel is built for n = 2")

    monkeypatch.setattr(tngram, "fused_ngram_context", refuse)
    torch.manual_seed(0)
    fused = tngram.NGramContext(32, 8, n, 2, ngram_fused=True)
    composed = tngram.NGramContext(32, 8, n, 2, ngram_fused=False)
    composed.load_state_dict(fused.state_dict())
    x = torch.randn(2, 40, 32, 32)
    out = fused(x)
    assert out.shape == (2, 5, 4, 32)
    assert torch.equal(out, composed(x))


def test_kernel_geometries_are_the_list_both_attention_kernels_expand():
    import tmar_torch

    header = os.path.join(os.path.dirname(tmar_torch.__file__), "csrc",
                          "window_attention_geometries.cuh")
    with open(header) as f:
        text = f.read()
    listed = {tuple(int(v) for v in m) for m in
              re.findall(r"^\s*X\((\d+), (\d+), (\d+), (\d+)\)", text, re.M)}
    assert listed == KERNEL_GEOMETRIES
    assert {(n * n, 32) for n in (1, 2, 3)} <= {g[:2] for g in listed}
    for name in ("window_attention_fwd.cu", "window_attention_bwd.cu"):
        with open(os.path.join(os.path.dirname(header), name)) as f:
            src = f.read()
        assert '#include "window_attention_geometries.cuh"' in src
        # every dispatch names its cases through the list alone
        assert not re.search(r"N == (1|4|9|64) &&", src), name


def test_a_grid_smaller_than_n_keeps_its_message():
    ctx = tngram.NGramContext(32, 8, 3, 2)
    with pytest.raises(ValueError, match="window grid of at least 3x3 to reflect-pad, got 2x4"):
        ctx(torch.zeros(1, 16, 32, 32))


def test_trainer_trains_with_ngrams_1_and_3(tmp_path):
    cfg = config.load_config(config.config_path("train_syndeeplesion.yaml"), {
        "model.ngrams": [1, 3, 3, 1], "data.dataset": "synthetic", "data.batch_size": 2,
        "data.patch_size": 48, "data.samples_per_epoch": 2, "data.num_workers": 1,
        "model.embed_dim": 32, "model.depths": (2, 1, 1), "model.num_heads": (2, 2, 2),
        "model.dec_dim": 32, "model.dec_depths": 2, "model.dec_num_heads": 2,
        "model.window_size": 4, "disc.base_channels": 8, "disc.num_scales": 2,
        "disc.num_layers": 3, "radon.num_angles": 12, "bf16": False,
        "run_dir": str(tmp_path), "run_name": "n13",
    })
    trainer = Trainer(variants.resolve_variant(cfg, cfg.variant), device="cpu")
    ctx = trainer.generator.encoder_layer2.blocks[0].ngram_window_partition.ngram_context
    assert ctx.ngram == 3 and ctx.ngram_attn.window_size == (3, 3)
    batch = next(iter(Loader(build_dataset(trainer.cfg), batch_size=2, num_workers=1)))
    history = []
    for _ in range(3):
        trainer.state, m = trainer.train_step(trainer.state, batch)
        history.append({k: float(v) for k, v in m.items()})
    assert all(np.isfinite(v) for h in history for v in h.values())
    assert history[-1]["g_rec"] < history[0]["g_rec"]
