// Shared device helpers of the training kernels (window attention and
// residual FFN, forward and backward): type conversion and rounding, a warp
// sum, and the 256-thread tile matrix product their float32 bodies are built
// from.
//
// A block of THREADS = 256 threads works on a tile of ROWS = 64 token rows
// held in shared memory in float32.  The threads form a 16 x 16 grid; thread
// (rg, cg) owns the output elements (rg + 16 i, cg + 16 j).  Operands are
// addressed by (row stride, k stride) and (k stride, column stride), so the
// same routine computes X·W, X·Wᵀ and Xᵀ·Y; shared-memory rows are padded to
// an odd length so that both directions are free of bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace tmar {

constexpr int THREADS = 256;
constexpr int ROWS = 64;  // token rows per tile
constexpr size_t MAX_SMEM = 232448;  // dynamic shared memory of one sm_90 block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// v rounded to the I/O type T (bf16: to nearest even), back in float32
template <typename T>
__device__ __forceinline__ float round_as(float v) {
  return sizeof(T) == 2 ? __bfloat162float(__float2bfloat16(v)) : v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr int ceil16(int n) { return (n + 15) / 16; }

template <int M, int NN>
__device__ __forceinline__ void mm_zero(float (&acc)[ceil16(M)][ceil16(NN)]) {
#pragma unroll
  for (int i = 0; i < ceil16(M); ++i)
#pragma unroll
    for (int j = 0; j < ceil16(NN); ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_{k < K} a[m·a_m + k·a_k] · b[k·b_k + n·b_n]
// for m = rg + 16 i < M and n = cg + 16 j < NN.
template <int M, int K, int NN>
__device__ __forceinline__ void mm_acc(float (&acc)[ceil16(M)][ceil16(NN)],
                                       const float* a, int a_m, int a_k,
                                       const float* b, int b_k, int b_n) {
  constexpr int RI = ceil16(M), CN = ceil16(NN);
  const int cg = threadIdx.x & 15, rg = threadIdx.x >> 4;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float av[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int m = rg + 16 * i;
      av[i] = (M % 16 == 0 || m < M) ? a[m * a_m + k * a_k] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int n = cg + 16 * j;
      const float bv = (NN % 16 == 0 || n < NN) ? b[k * b_k + n * b_n] : 0.f;
#pragma unroll
      for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(av[i], bv, acc[i][j]);
    }
  }
}

// f(m, n, acc[i][j]) for every element this thread owns.
template <int M, int NN, typename F>
__device__ __forceinline__ void mm_each(const float (&acc)[ceil16(M)][ceil16(NN)], F f) {
  const int cg = threadIdx.x & 15, rg = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < ceil16(M); ++i) {
    const int m = rg + 16 * i;
    if (M % 16 == 0 || m < M) {
#pragma unroll
      for (int j = 0; j < ceil16(NN); ++j) {
        const int n = cg + 16 * j;
        if (NN % 16 == 0 || n < NN) f(m, n, acc[i][j]);
      }
    }
  }
}

// ---- the generic bodies: every dimension at run time ----------------------
//
// mm_rt calls f(m, n, Σ_{k < K} a(m, k) · b(k, n)) for every m < M, n < N,
// by a block of THREADS threads: the output is cut into 64 x 64 tiles and
// thread (rg, cg) owns the elements (rg + 16 i, cg + 16 j) of each, so an
// element has the same owner in every call with the same M and N (f may add
// into a per-block sum without atomics).  a and b are functors reading shared
// or device memory and rounding where the caller rounds.
template <typename FA, typename FB, typename F>
__device__ __forceinline__ void mm_rt(int M, int N, int K, FA a, FB b, F f) {
  const int cg = threadIdx.x & 15, rg = threadIdx.x >> 4;
  for (int m0 = 0; m0 < M; m0 += 64)
    for (int n0 = 0; n0 < N; n0 += 64) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
      for (int k = 0; k < K; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + rg + 16 * i;
          av[i] = m < M ? a(m, k) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + cg + 16 * j;
          bv[j] = n < N ? b(k, n) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + rg + 16 * i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + cg + 16 * j;
          if (n < N) f(m, n, acc[i][j]);
        }
      }
    }
}

// (mean, 1 / sqrt(var + eps)) of the n values v(c), c < n, of one row, by
// one warp (two passes, as the plain LayerNorm)
template <typename F>
__device__ __forceinline__ float2 row_stats(int n, float eps, F v) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane; c < n; c += 32) s += v(c);
  const float mu = warp_sum(s) / n;
  float q = 0.f;
  for (int c = lane; c < n; c += 32) {
    const float d = v(c) - mu;
    q = fmaf(d, d, q);
  }
  return make_float2(mu, rsqrtf(warp_sum(q) / n + eps));
}

// store(e, load(e)) for e = tid, tid + nthreads, ... < N, the loads of B
// iterations issued before their stores, so that they are in flight
// together (a block staging its weights from device memory would otherwise
// wait on each load in turn)
template <int B, typename L, typename S>
__device__ __forceinline__ void batched(int N, int tid, int nthreads, L load, S store) {
  for (int e0 = tid; e0 < N; e0 += B * nthreads) {
    float v[B];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const int e = e0 + k * nthreads;
      v[k] = e < N ? load(e) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const int e = e0 + k * nthreads;
      if (e < N) store(e, v[k]);
    }
  }
}

// The persistent grid of kernel `kern` at this shared memory and block
// size: the SMs times the blocks one holds, kept per device for the last
// (bytes, threads) asked (each kernel instantiation has its own `cache`).
template <typename K>
inline int persistent_grid(K kern, size_t bytes, int threads, int (&cache)[64][3], int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  int* c = cache[dev];
  if (c[0] != (int)bytes || c[1] != threads) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)bytes)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, bytes)) !=
            cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    c[0] = (int)bytes, c[1] = threads, c[2] = sms * per_sm;
  }
  *grid = c[2];
  return 0;
}

// out[e] = sum_b part[b][e], in block order, rounded to bf16 values for e
// in [lo1, hi1) or [lo2, hi2) when round_bf16: the reduce of the generic
// backward bodies, whose weight cotangents the JAX kernels cast after their
// sums over rows
__global__ void reduce_partials_rounded(const float* __restrict__ part, float* __restrict__ out,
                                        int nblocks, int size, int lo1, int hi1, int lo2,
                                        int hi2, int round_bf16) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += part[(size_t)b * size + e];
  if (round_bf16 && ((e >= lo1 && e < hi1) || (e >= lo2 && e < hi2))) s = round_as<__nv_bfloat16>(s);
  out[e] = s;
}

// out[e] = sum_b part[b][e], in block order: the second pass over the
// per-block partial sums of the parameter cotangents.  No float atomics, so
// two runs give the same bits.
__global__ void reduce_partials(const float* __restrict__ part, float* __restrict__ out,
                                int nblocks, int size) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += part[(size_t)b * size + e];
  out[e] = s;
}

}  // namespace tmar
