"""The port's plain ops (tmar_torch.ops) against their JAX counterparts
(tmar.ops) on the same seeded numpy inputs, at float32.

Layout ops must agree exactly; arithmetic ops within atol 1e-5, rtol 1e-5
(float32 summation order differs between XLA and PyTorch), and attention at a
saturated logit scale within atol 5e-5, rtol 1e-4 (scores are multiplied by
up to 100 before the softmax, which scales their rounding error alike)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmar.ops import attention as jattn
from tmar.ops import ngram as jngram
from tmar.ops import window as jwin
from tmar.ops.pallas_ffn import ffn_math as jffn_math
from tmar_torch.ops import attention as tattn
from tmar_torch.ops import ngram as tngram
from tmar_torch.ops import window as twin
from tmar_torch.ops.ffn import ffn_math as tffn_math
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape,ws", [((2, 16, 24, 5), 8), ((1, 8, 8, 3), 4)])
def test_window_partition_roundtrip(shape, ws):
    x = _np(shape)
    jw, jn = jwin.window_partition(jnp.asarray(x), ws)
    tw, tn = twin.window_partition(_t(x), ws)
    assert tn == jn
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(twin.window_unpartition(tw, tn).numpy(), x)


@pytest.mark.parametrize("shift", [0, 2, 4])
def test_cyclic_shift(shift):
    x = _np((2, 16, 24, 3))
    np.testing.assert_array_equal(
        twin.cyclic_shift(_t(x), shift).numpy(), np.asarray(jwin.cyclic_shift(jnp.asarray(x), shift))
    )
    np.testing.assert_array_equal(
        twin.reverse_cyclic_shift(_t(x), shift).numpy(),
        np.asarray(jwin.reverse_cyclic_shift(jnp.asarray(x), shift)),
    )


@pytest.mark.parametrize("hw", [(40, 72), (64, 64), (33, 1)])
def test_pad_to_multiple(hw):
    x = _np((1, *hw, 2))
    tp, tsize = twin.pad_to_multiple(_t(x), 32)
    jp, jsize = jwin.pad_to_multiple(jnp.asarray(x), 32)
    assert tsize == jsize
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("ws,shift", [(8, 4), (8, 2), (4, 2)])
def test_shift_mask_components(ws, shift):
    for t, j in zip(twin.shift_mask_components(ws, shift), jwin.shift_mask_components(ws, shift)):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("h,w", [(8, 8), (2, 2), (3, 5)])
def test_relative_position_bias(h, w):
    np.testing.assert_array_equal(
        tattn.relative_position_index(h, w), jattn.relative_position_index(h, w)
    )
    nh = 3
    table = _np(((2 * h - 1) * (2 * w - 1), nh))
    idx = jattn.relative_position_index(h, w)
    np.testing.assert_array_equal(
        tattn.gather_rel_pos_bias(_t(table), idx, nh).numpy(),
        np.asarray(jattn.gather_rel_pos_bias(jnp.asarray(table), idx, nh)),
    )


def test_split_merge_heads():
    x = _np((3, 64, 60))
    t = tattn.split_heads(_t(x), 6)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jattn.split_heads(jnp.asarray(x), 6)))
    np.testing.assert_array_equal(tattn.merge_heads(t).numpy(), x)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("logit", [0.5, 10.0])
def test_cosine_window_attention(masked, logit):
    wh, ww, nh, N, hd = 2, 3, 4, 64, 16
    B_ = 2 * wh * ww
    q, k, v = (_np((B_, nh, N, hd), seed=s) for s in (1, 2, 3))
    ls = np.full((nh, 1, 1), logit, np.float32)
    bias = _np((nh, N, N), seed=4, scale=0.5)
    mc = None
    if masked:
        m_row, m_col = jwin.shift_mask_components(8, 4)
        mc = (m_row, m_col, wh, ww)
    ref = jattn.cosine_window_attention(*map(jnp.asarray, (q, k, v, ls, bias)), mask_components=mc)
    got = tattn.cosine_window_attention(*map(_t, (q, k, v, ls, bias)), mask_components=mc)
    tol = TOL if logit < np.log(100.0) else dict(atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_math(masked):
    wh, ww, nh, N, D, A = 2, 2, 6, 64, 64, 60
    x = _np((wh * ww, N, D))
    params = [_np((D, 3 * A), 1, 0.2), _np((3 * A,), 2, 0.1), _np((nh, 1, 1), 3),
              _np((nh, N, N), 4, 0.5), _np((A, D), 5, 0.2), _np((D,), 6, 0.1)]
    mc = (*jwin.shift_mask_components(8, 4), wh, ww) if masked else None
    ref = jattn.window_attention_math(jnp.asarray(x), *map(jnp.asarray, params), nh,
                                      mask_components=mc)
    got = tattn.window_attention_math(_t(x), *map(_t, params), nh, mask_components=mc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("back", [False, True])
@pytest.mark.parametrize("shape", [(2, 4, 5, 3), (1, 2, 2, 4)])
def test_seq_refl_win_pad_and_sliding_patches(back, shape):
    x = _np(shape)
    tp = tngram.seq_refl_win_pad(_t(x), 2, back=back)
    jp = jngram.seq_refl_win_pad(jnp.asarray(x), 2, back=back)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(
        tngram.sliding_patches(tp, 2).numpy(), np.asarray(jngram.sliding_patches(jp, 2))
    )


def test_ffn_math():
    M, D, H = 96, 64, 128
    args = [_np((M, D), 1), _np((M, D), 2, 3.0), 1 + _np((D,), 3, 0.1), _np((D,), 4, 0.1),
            _np((D, H), 5, 0.2), _np((H,), 6, 0.1), _np((H, D), 7, 0.2), _np((D,), 8, 0.1),
            1 + _np((D,), 9, 0.1), _np((D,), 10, 0.1)]
    ref = jffn_math(*map(jnp.asarray, args))
    got = tffn_math(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
