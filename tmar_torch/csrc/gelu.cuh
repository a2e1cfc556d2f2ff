// The GELU of the FFN kernels (K5, K6, and K2/K8's FFN tail) and its
// derivative, with the erf the TPU kernels compute: Abramowitz & Stegun
// 7.1.26, |err| < 1.5e-7 (tmar/ops/pallas_ffn.py: _erf_approx, :334; Mosaic
// lowers no erf).  The plain versions compute the same formula exactly
// (tmar_torch/ops/ffn.py: erf_as_kernels); here its reciprocal and exp are
// the SFU's (__fdividef, __expf: a few float32 ulp, far below the formula's
// own error), and the derivative computes exp(-u²/2) once for Φ and φ.

#pragma once

#include <math.h>

namespace {
namespace act {

// 1 - erf(a) = poly(t) · exp(-a²), t = 1 / (1 + p a), for a >= 0
__device__ __forceinline__ float erfc_poly(float a) {
  const float t = __fdividef(1.f, fmaf(0.3275911f, a, 1.f));
  return ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
          0.254829592f) * t;
}

// erf(x) from exp(-x²)
__device__ __forceinline__ float erf_with(float x, float exp_neg_x2) {
  return copysignf(fmaf(-erfc_poly(fabsf(x)), exp_neg_x2, 1.f), x);
}

__device__ __forceinline__ float gelu(float v) {
  const float x = v * 0.70710678118654752f;
  return 0.5f * v * (1.f + erf_with(x, __expf(-x * x)));
}

// d GELU(u) / du = Φ(u) + u φ(u)
__device__ __forceinline__ float gelu_grad(float u) {
  const float e = __expf(-0.5f * u * u);  // exp(-x²) at x = u/√2, and φ(u)·√(2π)
  return 0.5f * (1.f + erf_with(u * 0.70710678118654752f, e)) + u * e * 0.3989422804014327f;
}

}  // namespace act
}  // namespace
