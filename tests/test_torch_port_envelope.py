"""The widths the training-form kernels take (``tmar_torch.ops.envelope``),
on the CPU: the envelope functions are plain functions of the shapes, which
the CUDA wrappers call before they launch.

They must admit every geometry the port runs or tests (the
full-width NGswin's, the demo NGswin's of examples/demo_end_to_end.py, the
JAX package's own kernel tests', window 4, the envelope's top) and the
whole envelope (D <= 128, head_dim <= 32, hidden <= 4·D, n-gram C = D/2,
windows of 1, 4, 9, 16 and 64 tokens), and refuse past it with a
``NotImplementedError`` that names the limit."""

import itertools

import pytest

from tmar_torch.ops import envelope

# (N, D, heads, head_dim) of window attention (K3/K4)
ATTENTION = [
    (64, 64, 6, 10), (64, 64, 4, 16),                      # the full-width NGswin
    *[(n * n, 32, nh, hd) for n in (1, 2, 3) for nh, hd in ((6, 5), (4, 8))],
    (64, 32, 2, 16), *[(n * n, 16, 2, 8) for n in (1, 2, 3)],  # the demo width
    (64, 32, 3, 10), (64, 16, 2, 8),                       # the JAX kernel tests'
    (16, 32, 2, 16),                                       # window 4
    (64, 128, 4, 32),                                      # the envelope's top
]
FFN = [(64, 128), (32, 64), (128, 512)]                    # (D, hidden)
NGRAM = [(32, 64, 6, 5), (32, 64, 4, 8), (16, 32, 2, 8), (64, 128, 4, 16)]  # (C, D, heads, hd)


@pytest.mark.parametrize("N,D,nh,hd", ATTENTION)
def test_attention_envelope_admits_the_listed_geometries(N, D, nh, hd):
    hg_fwd, fwd, hg_bwd, bwd = envelope.attention_envelope(N, D, nh, hd)
    assert 1 <= hg_fwd <= nh and 1 <= hg_bwd <= nh
    assert 0 < fwd <= envelope.H100_SMEM_PER_BLOCK and 0 < bwd <= envelope.H100_SMEM_PER_BLOCK


@pytest.mark.parametrize("D,H", FFN)
def test_ffn_envelope_admits_the_listed_widths(D, H):
    fwd, rows, bwd = envelope.ffn_envelope(D, H)
    assert rows in (64, 32, 16)
    assert 0 < fwd <= envelope.H100_SMEM_PER_BLOCK and 0 < bwd <= envelope.H100_SMEM_PER_BLOCK


@pytest.mark.parametrize("C,D,nh,hd", NGRAM)
def test_ngram_envelope_admits_the_listed_widths(C, D, nh, hd):
    sizes = envelope.ngram_envelope(C, D, nh, hd)
    assert all(0 < s <= envelope.H100_SMEM_PER_BLOCK for s in sizes)


def test_the_whole_envelope_is_admitted():
    """Every width up to D = 128 with heads of up to 32 channels (A <= D),
    every window of the envelope, hidden up to 4·D, and the n-gram context
    at C = D/2 (A <= C)."""
    for D in range(8, 129, 8):
        for hd, nh in itertools.product((1, 5, 8, 10, 16, 31, 32), range(1, 17)):
            if nh * hd <= D:
                for N in (1, 4, 9, 16, 64):
                    envelope.attention_envelope(N, D, nh, hd)
            if nh * hd <= D // 2:
                envelope.ngram_envelope(D // 2, D, nh, hd)
        for H in range(D, 4 * D + 1, 8):
            envelope.ffn_envelope(D, H)


def test_past_the_envelope_the_limit_is_named():
    with pytest.raises(NotImplementedError, match="head_dim 40 is past the bound head_dim <= 32"):
        envelope.attention_envelope(64, 80, 2, 40)
    with pytest.raises(NotImplementedError, match="N=81 tokens is past the bound N <= 64"):
        envelope.attention_envelope(81, 32, 2, 16)
    with pytest.raises(NotImplementedError, match="head_dim 48"):
        envelope.ngram_envelope(96, 192, 2, 48)
    with pytest.raises(NotImplementedError,
                       match=r"needs \d+ bytes of shared memory, past the card's 232448"):
        envelope.ffn_envelope(512, 2048)
    with pytest.raises(NotImplementedError, match="bytes of shared memory"):
        envelope.ngram_envelope(512, 1024, 16, 32)
    # the message says what does run at other widths
    with pytest.raises(NotImplementedError, match="K2 and K8"):
        envelope.ffn_envelope(512, 2048)
