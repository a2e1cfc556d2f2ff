// Device helpers of the tensor-core bodies (the whole NSTB of K2/K8 in
// nstb_window_mma.cuh, window attention forward and backward of K3/K4 in
// window_attention_mma.cuh, the residual FFN of K5/K6 in ffn_mma.cuh, the
// n-gram context of K1/K7 in ngram_mma.cuh): bf16 packing, mma.sync.m16n8k16 with its
// fragment loads, quad reductions, cp.async and the warpgroup barrier.
//
// Fragment layouts of mma.sync.m16n8k16 (bf16 in, f32 accumulate), for lane
// (g = lane / 4, t = lane % 4): A rows g and g + 8 at columns 2t, 2t + 1 (a0,
// a1) and 2t + 8, 2t + 9 (a2, a3); B column g at rows 2t, 2t + 1 (b0) and
// 2t + 8, 2t + 9 (b1); C rows g (c0, c1) and g + 8 (c2, c3) at columns 2t,
// 2t + 1.  An accumulator pair (columns 0-7 and 8-15) re-packs as the A
// fragment of the next product (to_a).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float exp2_approx(float v) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(v));
  return e;
}
__device__ __forceinline__ void sts32(__nv_bfloat16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// c += a · b for one m16n8k16 tile: a the 16x16 A fragment, (b0, b1) the
// 16x8 B fragment, c the 16x8 float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((unsigned)__cvta_generic_to_shared(row)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((unsigned)__cvta_generic_to_shared(row)));
}

// c0 += a · B[n0, n0 + 8) and c1 += a · B[n0 + 8, n0 + 16) at k-step k0 of a
// bf16 matrix B kept [n][k] with row stride ld: one ldmatrix.x4 loads both B
// fragments (lane l addresses row n0 + 8·(l / 16) + l % 8, columns
// k0 + 8·(l / 8 % 2) + [0, 8))
__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* m, int ld, int n0, int k0,
                                         int lane) {
  uint32_t b[4];
  ldmatrix_x4(b, m + (n0 + 8 * (lane >> 4) + (lane & 7)) * ld + k0 + 8 * ((lane >> 3) & 1));
  mma_bf16(c0, a, b[0], b[1]);
  mma_bf16(c1, a, b[2], b[3]);
}

// The same for B kept [k][n] (row-major K x N): ldmatrix.x4.trans, lane l
// addressing row k0 + 8·(l / 8 % 2) + l % 8, columns n0 + 8·(l / 16) + [0, 8)
__device__ __forceinline__ void mma_pair_t(float (&c0)[4], float (&c1)[4], const uint32_t (&a)[4],
                                           const __nv_bfloat16* m, int ld, int n0, int k0,
                                           int lane) {
  uint32_t b[4];
  ldmatrix_x4_trans(b, m + (k0 + 8 * ((lane >> 3) & 1) + (lane & 7)) * ld + n0 + 8 * (lane >> 4));
  mma_bf16(c0, a, b[0], b[1]);
  mma_bf16(c1, a, b[2], b[3]);
}

// The A fragment of rows [m0, m0 + 16) x columns [k0, k0 + 16) of a bf16
// matrix kept [m][k] (row stride ld)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* m, int ld, int m0,
                                       int k0, int lane) {
  ldmatrix_x4(a, m + (m0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + k0 + 8 * (lane >> 4));
}
// ... of a matrix kept transposed, [k][m]: the A fragment of its transpose
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const __nv_bfloat16* m, int ld, int m0,
                                         int k0, int lane) {
  ldmatrix_x4_trans(a, m + (k0 + (lane & 7) + 8 * (lane >> 4)) * ld + m0 + 8 * ((lane >> 3) & 1));
}

// The A fragment of a 16x16 block held as two accumulator tiles (columns
// 0-7 and 8-15), rounded to bf16
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&lo)[4], const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
// the sum over the eight row groups g of a warp (lanes with equal t)
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Sums v over the eight row groups g = lane / 4 of a warp (the lanes of
// equal lane % 4), v being eight blocks of K values: lane g is left with the
// sums of block g in out.  A reduce-scatter: 4K + 2K + K shuffles.
template <int K>
__device__ __forceinline__ void rows_reduce_scatter(const float (&v)[8 * K], float (&out)[K],
                                                    int g) {
  float a[4 * K], b[2 * K];
  const bool h2 = g & 4, h1 = g & 2, h0 = g & 1;
#pragma unroll
  for (int i = 0; i < 4 * K; ++i)
    a[i] = (h2 ? v[4 * K + i] : v[i]) + __shfl_xor_sync(0xffffffffu, h2 ? v[i] : v[4 * K + i], 16);
#pragma unroll
  for (int i = 0; i < 2 * K; ++i)
    b[i] = (h1 ? a[2 * K + i] : a[i]) + __shfl_xor_sync(0xffffffffu, h1 ? a[i] : a[2 * K + i], 8);
#pragma unroll
  for (int i = 0; i < K; ++i)
    out[i] = (h0 ? b[K + i] : b[i]) + __shfl_xor_sync(0xffffffffu, h0 ? b[i] : b[K + i], 4);
}

__device__ __forceinline__ void cp_async16(__nv_bfloat16* smem, const __nv_bfloat16* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// barrier of the 128 threads of one warpgroup (id 1 + warpgroup; 0 is
// __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

}  // namespace
