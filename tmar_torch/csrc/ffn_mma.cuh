// The bfloat16 post-norm residual FFN on Hopper's tensor cores, shared by the
// whole-NSTB body of K2/K8 (nstb_window_mma.cuh), whose tail it is, and by
// the residual FFN's forward and backward, K5 (residual_ffn_fwd.cu) and K6
// (residual_ffn_bwd.cu):
//
//   y = x + LN1(a)
//   z = y + LN2(fc2(bf16(GELU(fc1(bf16(y))))))
//
// on one warp's 16 rows of 64 channels, held in registers in the
// accumulator layout of mma.sync.m16n8k16 (mma.cuh): v[j] is the tile of
// columns [8j, 8j + 8), lane (g, t) holds rows g (v[j][0], v[j][1]) and
// g + 8 (v[j][2], v[j][3]) at columns 8j + 2t, 8j + 2t + 1.
//
// Rounding.  The products take bf16 operands and accumulate in float32, as
// the JAX kernels' dots do (tmar/ops/pallas_ffn.py:_ffn_kernel, and the FFN
// tail of pallas_nstb.py:_nstb_body): w1 and w2 are bf16, y is rounded before
// fc1 and the GELU output before fc2.  The biases, the LayerNorms, the GELU
// and the residual y are float32.
//
// The weights are staged once per block in bf16 as [out][in] (w1 as
// [HID][LW1], w2 as [D][LW2]), row strides padded by 16 bytes so that
// ldmatrix's eight rows fall on distinct banks.  One ldmatrix.x4 then loads
// the B fragments of two n-tiles of y·w1 and h·w2 (mma_pair), and, through
// .trans, of the backward's do·w2ᵀ and du·w1ᵀ (mma_pair_t).  fc1, the GELU
// and fc2 walk the hidden width in 16-column chunks, each chunk's GELU output
// re-packed as the A fragment of its share of fc2, so the hidden layer never
// leaves the registers.  K5 and K6 walk their rows as 16-row strips, one per
// warp, each strip's bf16 tile of [16][LDT] in shared memory (load_strip,
// read_strip, write_strip, store_strip).

#pragma once

#include <cuda_bf16.h>
#include <math.h>

#include "gelu.cuh"
#include "mma.cuh"

namespace {
namespace ffn {

constexpr int D = 64;          // channels
constexpr int HID = 128;       // hidden width
constexpr int LW1 = D + 8;     // w1 staged [HID][LW1]
constexpr int LW2 = HID + 8;   // w2 staged [D][LW2]
constexpr int WELEMS = HID * LW1 + D * LW2;

constexpr int LDT = D + 8;     // a strip: 16 rows x D channels in bf16, [16][LDT]
constexpr int STRIP = 16 * LDT;

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }

// Stage w1 [D, HID] and w2 [HID, D], read as w[k·w_k + n·w_n] (float32 or
// bf16), into s_w1 [HID][LW1] and s_w2 [D][LW2] in bf16 (rounded to nearest
// even), by `threads` threads of which this is `tid`.
template <typename T>
__device__ __forceinline__ void stage_weights(__nv_bfloat16* s_w1, __nv_bfloat16* s_w2,
                                              const T* w1, int w1_k, int w1_n, const T* w2,
                                              int w2_k, int w2_n, int tid, int threads) {
  for (int e = tid; e < D * HID; e += threads) {
    const int k = e / HID, n = e % HID;
    s_w1[n * LW1 + k] = to_bf16(w1[(size_t)k * w1_k + (size_t)n * w1_n]);
  }
  for (int e = tid; e < HID * D; e += threads) {
    const int k = e / D, n = e % D;
    s_w2[n * LW2 + k] = to_bf16(w2[(size_t)k * w2_k + (size_t)n * w2_n]);
  }
}

// In place, v <- (v - mean) · rsqrt(var + eps) · gain + bias per row (rows
// g, g + 8), t = lane % 4
__device__ __forceinline__ void layer_norm_rows(float (&v)[8][4], const float* gain,
                                                const float* bias, float eps, int t) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s0 += v[j][0] + v[j][1];
    s1 += v[j][2] + v[j][3];
  }
  const float mu0 = quad_sum(s0) * (1.f / D), mu1 = quad_sum(s1) * (1.f / D);
  float q0 = 0.f, q1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j][0] -= mu0, v[j][1] -= mu0, v[j][2] -= mu1, v[j][3] -= mu1;
    q0 += v[j][0] * v[j][0] + v[j][1] * v[j][1];
    q1 += v[j][2] * v[j][2] + v[j][3] * v[j][3];
  }
  const float i0 = rsqrtf(quad_sum(q0) * (1.f / D) + eps);
  const float i1 = rsqrtf(quad_sum(q1) * (1.f / D) + eps);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    v[j][0] = v[j][0] * i0 * gain[c] + bias[c];
    v[j][1] = v[j][1] * i0 * gain[c + 1] + bias[c + 1];
    v[j][2] = v[j][2] * i1 * gain[c] + bias[c];
    v[j][3] = v[j][3] * i1 * gain[c + 1] + bias[c + 1];
  }
}

// Start the copies of rows [row0, row0 + 16) of src [M, D] into the strip
// tile dst, 16 bytes a lane (rows past M are zeroed instead); commits nothing.
__device__ __forceinline__ void load_strip(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long row0, long M, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i, row = c >> 3, part = c & 7;
    __nv_bfloat16* d = dst + row * LDT + 8 * part;
    if (row0 + row < M)
      cp_async16(d, src + (size_t)(row0 + row) * D + 8 * part);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Rows [row0, row0 + 16) of dst [M, D], those below M, from the strip tile
// src, 16 bytes a lane
__device__ __forceinline__ void store_strip(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            long row0, long M, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i, row = c >> 3, part = c & 7;
    if (row0 + row < M)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + row) * D + 8 * part) =
          *reinterpret_cast<const uint4*>(src + row * LDT + 8 * part);
  }
}

// The strip tile's values in the accumulator layout
__device__ __forceinline__ void read_strip(const __nv_bfloat16* tile, float (&v)[8][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 a = unpack_bf16(tile + g * LDT + c), b = unpack_bf16(tile + (g + 8) * LDT + c);
    v[j][0] = a.x, v[j][1] = a.y, v[j][2] = b.x, v[j][3] = b.y;
  }
}

// v, rounded to bf16, into the strip tile
__device__ __forceinline__ void write_strip(__nv_bfloat16* tile, const float (&v)[8][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    sts32(tile + g * LDT + c, pack_bf16(v[j][0], v[j][1]));
    sts32(tile + (g + 8) * LDT + c, pack_bf16(v[j][2], v[j][3]));
  }
}

// Hands each hidden chunk's bf16 A fragment to nobody (K2, K5)
struct NoChunk {
  __device__ __forceinline__ void operator()(int, const uint32_t (&)[4]) const {}
};

// f = bf16(GELU(bf16(y)·w1 + bw1))·w2 + bw2, 16 hidden columns at a time;
// on_chunk(c, ha) sees the A fragment of chunk c's rounded GELU output
// (hidden columns [16c, 16c + 16)).
template <typename OnChunk = NoChunk>
__device__ __forceinline__ void fc(const float (&y)[8][4], float (&f)[8][4],
                                   const __nv_bfloat16* s_w1, const __nv_bfloat16* s_w2,
                                   const float* bw1, const float* bw2, int lane,
                                   OnChunk on_chunk = OnChunk()) {
  const int t = lane & 3;
  uint32_t ya[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) to_a(ya[kk], y[2 * kk], y[2 * kk + 1]);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    f[j][0] = f[j][2] = bw2[c];
    f[j][1] = f[j][3] = bw2[c + 1];
  }
#pragma unroll 2
  for (int hc = 0; hc < HID / 16; ++hc) {
    float hid[2][4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = 16 * hc + 8 * hf + 2 * t;
      hid[hf][0] = hid[hf][2] = bw1[c];
      hid[hf][1] = hid[hf][3] = bw1[c + 1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_pair(hid[0], hid[1], ya[kk], s_w1, LW1, 16 * hc, 16 * kk, lane);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) hid[hf][e] = act::gelu(hid[hf][e]);
    uint32_t ha[4];
    to_a(ha, hid[0], hid[1]);
    on_chunk(hc, ha);
#pragma unroll
    for (int j = 0; j < 8; j += 2) mma_pair(f[j], f[j + 1], ha, s_w2, LW2, 8 * j, 16 * hc, lane);
  }
}

}  // namespace ffn
}  // namespace
