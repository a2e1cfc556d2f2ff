"""Differentiable parallel-beam Radon transform (the counterpart of
``tmar.ops.radon``), in plain PyTorch: matrix products and reshapes, no
kernel of its own.

A pixel at (row i, col j) projects onto detector coordinate
    p(i, j; θ) = (j - c)·cosθ + (i - c)·sinθ + c_det
and contributes its value under a linear (triangle) splat.  The offset is
separable, so the 2-D splat is two 1-D passes:

  pass A:  T[b, a, s, j] = Σ_i M[a, s, i] · I[b, i, j],
           M[a, s, i] = tri(s - (i - c)·sinθ_a - c_det), a constant [A, det, H];
  pass B:  the per-column fractional shift β_j(θ_a) = (j - c)·cosθ_a = k + f
           as a product with a constant shift-bin matrix G[a, j, m] (weight
           1 - f at bin k, f at bin k + 1), then the anti-diagonal sum
           Σ_m A2[s - κ_m, m] by pad -> reshape -> slice -> sum: flattening
           (m, s') row-major with row width S_pad and re-reshaping with row
           width S_pad - 1 turns every anti-diagonal into a column.  Detector
           bins out of range land in the zero padding.

The operator is linear.  The adjoint (backprojection) is written out as the
exact transpose of the two passes, and forward and adjoint are each other's
backward through two ``torch.autograd.Function``s, so neither direction
keeps the [B, A, det, W] intermediate for its backward.

``precision`` keeps the JAX package's names.  On an NVIDIA card they map to
the float32 matrix-product modes: ``"highest"`` is full float32 (TF32 off,
the default and what evaluation and FBP use), ``"high"`` and ``"default"``
allow TF32 in the tensor cores (about three decimal digits, as coarse as the
TPU's one-pass mode is allowed to be).  The mode is set around the products
and restored; the process default is never relied on.  On the CPU every mode
is full float32.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tmar_torch.device import resolve_device

PRECISIONS = ("highest", "high", "default")


def _triangle_matrix(offsets: np.ndarray, det_count: int) -> np.ndarray:
    """tri(s - offsets[...]) for s = 0..det-1 -> [..., det] splat weights."""
    s = np.arange(det_count, dtype=np.float64)
    d = np.abs(s[None, :] - offsets[..., None])
    return np.maximum(0.0, 1.0 - d)


@contextlib.contextmanager
def _matmul_precision(precision: str):
    """Set the float32 matrix-product mode of the CUDA backend for the block."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision != "highest"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class _Forward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, radon):
        ctx.radon = radon
        return radon._forward_impl(img)

    @staticmethod
    def backward(ctx, g):
        return _Adjoint.apply(g, ctx.radon), None


class _Adjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sino, radon):
        ctx.radon = radon
        return radon._adjoint_impl(sino)

    @staticmethod
    def backward(ctx, g):
        return _Forward.apply(g, ctx.radon), None


class Radon:
    """Batched parallel-beam Radon transform and FBP.

    Args:
        img_size: side length of the (square) input images.
        angles: projection angles in radians, shape [A].  Defaults to 180
            uniformly spaced angles over [0, π).
        det_count: number of detector bins (default ``img_size``).
        precision: ``"highest"`` | ``"high"`` | ``"default"`` (module docstring).
        device: where the constants live and the transform runs; ``"cuda"``
            by default, which raises without a card.
    """

    def __init__(
        self,
        img_size: int,
        angles: Optional[np.ndarray] = None,
        det_count: Optional[int] = None,
        precision: str = "highest",
        device="cuda",
    ):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.precision = precision
        self.device = resolve_device(device)
        if angles is None:
            angles = np.linspace(0.0, np.pi, 180, endpoint=False)
        angles = np.asarray(angles, dtype=np.float64)
        self.img_size = int(img_size)
        self.angles = angles.astype(np.float32)
        self.num_angles = angles.shape[0]
        self.det_count = int(det_count or img_size)

        H = self.img_size
        A = self.num_angles
        det = self.det_count
        c = (H - 1) / 2.0
        c_det = (det - 1) / 2.0

        cos = np.cos(angles)
        sin = np.sin(angles)
        rows = np.arange(H, dtype=np.float64) - c
        cols = np.arange(H, dtype=np.float64) - c

        # pass A constant: M[a, s, i] = tri(s - (i - c) sinθ_a - c_det) -> [A, det, H]
        alpha = sin[:, None] * rows[None, :] + c_det
        proj_mat = _triangle_matrix(alpha, det).transpose(0, 2, 1).astype(np.float32)

        # pass B constants: β_j(a) = (j - c) cosθ_a = k + f; taps at shifts k
        # (weight 1 - f) and k + 1 (weight f) are columns of G[a, j, m], m
        # indexing the shift values κ_m = k_min + m
        beta = cos[:, None] * cols[None, :]
        k = np.floor(beta).astype(np.int64)
        f = (beta - k).astype(np.float32)
        k_min = int(k.min())
        k_max = int(k.max()) + 1  # + 1: the fractional tap
        K = k_max - k_min + 1
        W = cols.shape[0]
        G = np.zeros((A, W, K), np.float32)
        a_idx = np.repeat(np.arange(A), W)
        j_idx = np.tile(np.arange(W), A)
        np.add.at(G, (a_idx, j_idx, (k - k_min).ravel()), (1.0 - f).ravel())
        np.add.at(G, (a_idx, j_idx, (k - k_min).ravel() + 1), f.ravel())
        self._proj_mat = torch.from_numpy(np.ascontiguousarray(proj_mat)).to(self.device)
        self._shift_bins = torch.from_numpy(G).to(self.device)
        self._k_min = k_min
        self._K = K
        # row width of the diagonal trick: every out-of-range (s - κ_m) read
        # lands in the zero padding
        self._s_pad = det + K

    # ------------------------------------------------------------------ fwd
    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """[B, H, W] (or [B, H, W, 1]) -> sinogram [B, A, det] (float32)."""
        if img.ndim == 4:
            img = img[..., 0]
        return _Forward.apply(img, self)

    __call__ = forward

    def _check(self, t: torch.Tensor) -> torch.Tensor:
        if t.device != self._proj_mat.device:
            raise ValueError(
                f"Radon on {self._proj_mat.device} was given a tensor on {t.device}"
            )
        return t.to(torch.float32)

    def _forward_impl(self, img: torch.Tensor) -> torch.Tensor:
        img = self._check(img)
        with _matmul_precision(self.precision):
            # pass A: [A, det, H] x [B, H, W] -> [B, A, det, W]
            t = torch.einsum("asi,biw->basw", self._proj_mat, img)
            # pass B: A2[b, a, m, s'] = Σ_j t[b, a, s', j] · G[a, j, m]
            a2 = torch.einsum("basw,awm->bams", t, self._shift_bins)
        return self._diag_sum(a2)

    def _diag_sum(self, a2: torch.Tensor) -> torch.Tensor:
        """Σ_m A2[.., m, σ - m] (σ = s - k_min): pad the rows to S_pad,
        flatten (m, s') row-major, re-reshape with row width S_pad - 1."""
        B, A = a2.shape[:2]
        det, K, S_pad = self.det_count, self._K, self._s_pad
        off = -self._k_min
        flat = F.pad(a2, (0, S_pad - det)).reshape(B, A, K * S_pad)
        c = flat[..., : K * (S_pad - 1)].reshape(B, A, K, S_pad - 1)
        return c[..., off : off + det].sum(dim=2)

    def _diag_spread(self, sino: torch.Tensor) -> torch.Tensor:
        """Exact transpose of ``_diag_sum``: [B, A, det] -> [B, A, K, det]."""
        B, A = sino.shape[:2]
        det, K, S_pad = self.det_count, self._K, self._s_pad
        off = -self._k_min
        c = sino.new_zeros((B, A, K, S_pad - 1))
        c[..., off : off + det] = sino[:, :, None, :]
        flat = F.pad(c.reshape(B, A, K * (S_pad - 1)), (0, K))
        return flat.reshape(B, A, K, S_pad)[..., :det]

    # --------------------------------------------------------------- adjoint
    def backward(self, sino: torch.Tensor) -> torch.Tensor:
        """Adjoint (unfiltered backprojection): [B, A, det] -> [B, H, W]."""
        return _Adjoint.apply(sino, self)

    def _adjoint_impl(self, sino: torch.Tensor) -> torch.Tensor:
        sino = self._check(sino)
        # transpose of pass B: spread the sinogram over the shift diagonals,
        # then contract the shift bins with Gᵀ
        da2 = self._diag_spread(sino)  # [B, A, K, det]
        with _matmul_precision(self.precision):
            u = torch.einsum("bams,awm->basw", da2, self._shift_bins)
            # transpose of pass A: img[b, i, w] = Σ_a Σ_s M[a, s, i] U[b, a, s, w]
            return torch.einsum("asi,basw->biw", self._proj_mat, u)

    # ------------------------------------------------------------------ fbp
    def filter_sinogram(self, sino: torch.Tensor) -> torch.Tensor:
        """Ramp (Ram-Lak) filter along the detector axis by a real FFT."""
        det = self.det_count
        n = max(64, int(2 ** np.ceil(np.log2(2 * det))))
        s = F.pad(sino.to(torch.float32), (0, n - det))
        ramp = torch.from_numpy((2.0 * np.abs(np.fft.rfftfreq(n))).astype(np.float32)).to(s.device)
        fs = torch.fft.rfft(s, dim=-1) * ramp
        return torch.fft.irfft(fs, n=n, dim=-1)[..., :det]

    def fbp(self, sino: torch.Tensor) -> torch.Tensor:
        """Filtered backprojection: [B, A, det] -> [B, H, W]."""
        img = self.backward(self.filter_sinogram(sino))
        return img * (np.pi / (2.0 * self.num_angles))
