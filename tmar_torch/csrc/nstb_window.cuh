// The per-window body of a whole NSTB (N-gram Swin Transformer Block), shared
// by K2 (nstb_map.cu, windows gathered from the unrolled map with an in-kernel
// roll) and K8 (nstb_tokens.cu, windows already partitioned).  The two differ
// only in where a window's tokens are read and written: each supplies a
// `Windows` addressing type, and everything else is here and in
// nstb_window_mma.cuh.  This file holds the float32 body, the exactness path;
// bfloat16 I/O runs the tensor-core body of nstb_window_mma.cuh, which also
// holds the dispatch between the two.
//
// Per 8x8 window (N = 64 tokens), with its n-gram context per quadrant
// ctx_quads [windows, Q, 64] (Q = 1: the window's own context; Q = 4: the 2x2
// pre-shift neighbourhood, picked per token by its quadrant):
//   x_attn = x + ctx_tok
//   a      = proj(softmax(cos(q, k)·scale + rpb + shift mask)·v)
//   y      = x + LN1(a)                      (residual WITHOUT the context)
//   z      = y + LN2(fc2(GELU(fc1(y))))
// The SW-MSA mask is [row == wh-1]·m_row + [col == ww-1]·m_col with -100 per
// component, gated by the window's place w = window mod (wh·ww) in its image.
//
// What bounds it on an H100: operations.  Per token it does ~79 kFLOP (qkv
// 3·64·A, scores and AV 2·64·A, projection A·64, FFN 2·64·128 multiply-adds)
// against 256 bytes of input and output, far above the card's ~295 FLOP/byte
// balance point.  Design of the float32 body: one persistent block per SM
// walks over windows; every weight of the block (128 KB in float32) is staged
// in shared memory once per block, and the whole window lives in shared
// memory between the stages, so device memory sees each input and output
// element once.  The score matrix is never stored: each thread owns one
// (head, query) row and makes two passes over the 64 keys (row max, then
// exp/sum/AV), so the softmax keeps its max subtraction.  Matrix products run
// on the CUDA cores in float32 (4 rows x up to 12 columns per thread), as do
// statistics, softmax and GELU.
//
// A `Windows` type has
//   int count, wh, ww;                       windows to process; the grid of one image
//   struct Win;  __device__ Win at(int win)  per-window addressing state
//   __device__ size_t src(const Win&, int n) row of token n in x
//   __device__ size_t dst(const Win&, int n) row of token n in out

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gelu.cuh"

namespace {

constexpr int WS = 8;
constexpr int N = WS * WS;   // tokens per window
constexpr int D = 64;        // channels
constexpr int HID = 128;     // FFN hidden width
constexpr int THREADS = 256;
constexpr int LX = D + 1;    // padded rows keep column reads conflict-free
constexpr int LH = HID + 1;
constexpr int TABLE = (2 * WS - 1) * (2 * WS - 1);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int NH, int HD, typename T>
struct Layout {
  static constexpr int A = NH * HD;
  static constexpr int A3 = 3 * A;
  static constexpr int LQ = A3 + 1;
  static constexpr int LO = A + 1;
  static constexpr int R2 = N * LQ > N * LH ? N * LQ : N * LH;
  // float32 region
  static constexpr int X = 0;                 // [N][LX] x, then y
  static constexpr int R1 = X + N * LX;       // [N][LX] x_attn, attention out, fc2 out
  static constexpr int QKV = R1 + N * LX;     // [N][LQ] qkv, then proj out, then hidden
  static constexpr int BQKV = QKV + R2;
  static constexpr int BPROJ = BQKV + A3;
  static constexpr int G1 = BPROJ + D;
  static constexpr int B1 = G1 + D;
  static constexpr int G2 = B1 + D;
  static constexpr int B2 = G2 + D;
  static constexpr int BW1 = B2 + D;
  static constexpr int BW2 = BW1 + HID;
  static constexpr int SCALE = BW2 + D;
  static constexpr int TAB = SCALE + 8;
  static constexpr int FLOATS = TAB + TABLE * NH;
  // weight region, type T, [in, out] layout
  static constexpr int WQKV = 0;
  static constexpr int WPROJ = WQKV + D * A3;
  static constexpr int W1 = WPROJ + A * D;
  static constexpr int W2 = W1 + D * HID;
  static constexpr int WELEMS = W2 + HID * D;
  static constexpr size_t BYTES = FLOATS * sizeof(float) + WELEMS * sizeof(T);
};

struct Identity {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};
struct Gelu {
  __device__ __forceinline__ float operator()(float v) const { return act::gelu(v); }
};

// out[m][n] = epi(sum_k in[m][k] · w[k][n] + bias[n]) for m < 64, n < NN.
// 16 x 16 threads; a thread owns rows rg + 16i (i < 4) and columns cg + 16j.
template <int K, int NN, typename T, typename Epi>
__device__ __forceinline__ void block_mm(const float* in, int ld_in,
                                         const T* w, const float* bias,
                                         float* out, int ld_out, Epi epi) {
  constexpr int CN = (NN + 15) / 16;
  const int cg = threadIdx.x & 15, rg = threadIdx.x >> 4;
  float acc[4][CN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = in[(rg + 16 * i) * ld_in + k];
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int n = cg + 16 * j;
      const float wv = (NN % 16 == 0 || n < NN) ? to_f(w[k * NN + n]) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], wv, acc[i][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < CN; ++j) {
    const int n = cg + 16 * j;
    if (NN % 16 == 0 || n < NN) {
#pragma unroll
      for (int i = 0; i < 4; ++i) out[(rg + 16 * i) * ld_out + n] = epi(acc[i][j] + bias[n]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int NH, int HD, typename T, typename Windows>
__global__ void __launch_bounds__(THREADS, 1) nstb_kernel(
    const T* __restrict__ x, const T* __restrict__ cq,
    const T* __restrict__ wqkv, const float* __restrict__ bqkv,
    const float* __restrict__ scale, const float* __restrict__ table,
    const T* __restrict__ wproj, const float* __restrict__ bproj,
    const float* __restrict__ g1, const float* __restrict__ b1,
    const T* __restrict__ w1, const float* __restrict__ bw1,
    const T* __restrict__ w2, const float* __restrict__ bw2,
    const float* __restrict__ g2, const float* __restrict__ b2,
    T* __restrict__ out, Windows wins, int Q, int shift, float eps) {
  using L = Layout<NH, HD, T>;
  constexpr int A = L::A;
  constexpr int A3 = L::A3;
  constexpr int LQ = L::LQ;
  constexpr int LO = L::LO;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sX = smem + L::X;
  float* sR1 = smem + L::R1;
  float* sR2 = smem + L::QKV;
  float* s_bqkv = smem + L::BQKV;
  float* s_bproj = smem + L::BPROJ;
  float* s_g1 = smem + L::G1;
  float* s_b1 = smem + L::B1;
  float* s_g2 = smem + L::G2;
  float* s_b2 = smem + L::B2;
  float* s_bw1 = smem + L::BW1;
  float* s_bw2 = smem + L::BW2;
  float* s_scale = smem + L::SCALE;
  float* s_tab = smem + L::TAB;
  T* sW = reinterpret_cast<T*>(smem + L::FLOATS);
  T* s_wqkv = sW + L::WQKV;
  T* s_wproj = sW + L::WPROJ;
  T* s_w1 = sW + L::W1;
  T* s_w2 = sW + L::W2;

  const int tid = threadIdx.x;
  for (int e = tid; e < D * A3; e += THREADS) s_wqkv[e] = wqkv[e];
  for (int e = tid; e < A * D; e += THREADS) s_wproj[e] = wproj[e];
  for (int e = tid; e < D * HID; e += THREADS) s_w1[e] = w1[e];
  for (int e = tid; e < HID * D; e += THREADS) s_w2[e] = w2[e];
  for (int e = tid; e < A3; e += THREADS) s_bqkv[e] = bqkv[e];
  for (int e = tid; e < HID; e += THREADS) s_bw1[e] = bw1[e];
  for (int e = tid; e < D; e += THREADS) {
    s_bproj[e] = bproj[e];
    s_g1[e] = g1[e];
    s_b1[e] = b1[e];
    s_g2[e] = g2[e];
    s_b2[e] = b2[e];
    s_bw2[e] = bw2[e];
  }
  if (tid < NH) s_scale[tid] = scale[tid];
  for (int e = tid; e < TABLE * NH; e += THREADS) s_tab[e] = table[e];
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int edge = WS - shift;  // first in-window row/col of the second band

  for (int win = blockIdx.x; win < wins.count; win += gridDim.x) {
    const auto at = wins.at(win);

    // 1. gather the window, add the context of each token's quadrant
    for (int e = tid; e < N * D; e += THREADS) {
      const int n = e / D, d = e % D;
      const int r = n / WS, c = n % WS;
      const float xv = to_f(x[wins.src(at, n) * D + d]);
      const int quad = Q == 1 ? 0 : 2 * (shift > 0 && r >= edge) + (shift > 0 && c >= edge);
      sX[n * LX + d] = xv;
      sR1[n * LX + d] = xv + to_f(cq[((size_t)win * Q + quad) * D + d]);
    }
    __syncthreads();

    // 2. qkv = x_attn @ wqkv + bqkv
    block_mm<D, A3>(sR1, LX, s_wqkv, s_bqkv, sR2, LQ, Identity());
    __syncthreads();

    // 3. per-head L2 normalisation of q (heads 0..NH-1) and k (NH..2NH-1)
    for (int e = tid; e < N * 2 * NH; e += THREADS) {
      float* t = sR2 + (e / (2 * NH)) * LQ + (e % (2 * NH)) * HD;
      float ss = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) ss = fmaf(t[d], t[d], ss);
      const float inv = 1.f / (sqrtf(ss) + 1e-12f);
#pragma unroll
      for (int d = 0; d < HD; ++d) t[d] *= inv;
    }
    __syncthreads();

    // 4. attention, one (head, query) row per thread; out -> sR1 [N][LO]
    const int w = shift > 0 ? win % (wins.wh * wins.ww) : 0;  // place in its image
    const bool mrow = shift > 0 && w / wins.ww == wins.wh - 1;
    const bool mcol = shift > 0 && w % wins.ww == wins.ww - 1;
    for (int e = tid; e < NH * N; e += THREADS) {
      const int h = e / N, qi = e % N;
      const int ri = qi / WS, ci = qi % WS;
      const bool bri = ri >= edge, bci = ci >= edge;
      float q[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) q[d] = sR2[qi * LQ + h * HD + d];
      const float sc = s_scale[h];
      const float* kb = sR2 + A + h * HD;
      const float* tb = s_tab + h;
      float m = -INFINITY;
      for (int j = 0; j < N; ++j) {
        const int rj = j / WS, cj = j % WS;
        const float* kj = kb + j * LQ;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot = fmaf(q[d], kj[d], dot);
        float s = dot * sc + tb[((ri - rj + WS - 1) * (2 * WS - 1) + (ci - cj + WS - 1)) * NH];
        if (mrow && bri != (rj >= edge)) s -= 100.f;
        if (mcol && bci != (cj >= edge)) s -= 100.f;
        m = fmaxf(m, s);
      }
      float o[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) o[d] = 0.f;
      float z = 0.f;
      for (int j = 0; j < N; ++j) {
        const int rj = j / WS, cj = j % WS;
        const float* kj = kb + j * LQ;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot = fmaf(q[d], kj[d], dot);
        float s = dot * sc + tb[((ri - rj + WS - 1) * (2 * WS - 1) + (ci - cj + WS - 1)) * NH];
        if (mrow && bri != (rj >= edge)) s -= 100.f;
        if (mcol && bci != (cj >= edge)) s -= 100.f;
        const float p = expf(s - m);
        z += p;
        const float* vj = kj + A;
#pragma unroll
        for (int d = 0; d < HD; ++d) o[d] = fmaf(p, vj[d], o[d]);
      }
      const float iz = 1.f / z;
#pragma unroll
      for (int d = 0; d < HD; ++d) sR1[qi * LO + h * HD + d] = o[d] * iz;
    }
    __syncthreads();

    // 5. a = attn @ wproj + bproj -> sR2 [N][LX]
    block_mm<A, D>(sR1, LO, s_wproj, s_bproj, sR2, LX, Identity());
    __syncthreads();

    // 6. y = x + LN1(a) -> sX (one warp per row, two channels per lane)
    for (int n = warp; n < N; n += THREADS / 32) {
      const float a0 = sR2[n * LX + lane], a1 = sR2[n * LX + lane + 32];
      const float mu = warp_sum(a0 + a1) * (1.f / D);
      const float d0 = a0 - mu, d1 = a1 - mu;
      const float inv = rsqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.f / D) + eps);
      sX[n * LX + lane] += d0 * inv * s_g1[lane] + s_b1[lane];
      sX[n * LX + lane + 32] += d1 * inv * s_g1[lane + 32] + s_b1[lane + 32];
    }
    __syncthreads();

    // 7. hidden = GELU(y @ w1 + bw1) -> sR2 [N][LH]
    block_mm<D, HID>(sX, LX, s_w1, s_bw1, sR2, LH, Gelu());
    __syncthreads();

    // 8. f = hidden @ w2 + bw2 -> sR1 [N][LX]
    block_mm<HID, D>(sR2, LH, s_w2, s_bw2, sR1, LX, Identity());
    __syncthreads();

    // 9. z = y + LN2(f) -> the window's place in the output
    for (int n = warp; n < N; n += THREADS / 32) {
      const float f0 = sR1[n * LX + lane], f1 = sR1[n * LX + lane + 32];
      const float mu = warp_sum(f0 + f1) * (1.f / D);
      const float d0 = f0 - mu, d1 = f1 - mu;
      const float inv = rsqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.f / D) + eps);
      T* o = out + wins.dst(at, n) * D;
      store(o + lane, sX[n * LX + lane] + d0 * inv * s_g2[lane] + s_b2[lane]);
      store(o + lane + 32, sX[n * LX + lane + 32] + d1 * inv * s_g2[lane + 32] + s_b2[lane + 32]);
    }
    __syncthreads();
  }
}

constexpr int MAX_DEVICES = 64;

// The grid of a persistent launch of `kern` on the current device: its SMs
// times the blocks one SM holds.  The shared-memory attribute and the
// occupancy query run once per kernel and device; `cache` (one slot per
// device, 0 until then) belongs to the caller's instantiation.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kern, int threads, size_t bytes, int* cache, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)bytes)) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, bytes)) !=
        cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[dev] = sms * per_sm;
  }
  *grid = cache[dev];
  return cudaSuccess;
}

// One persistent block per SM (at most one per window), on `stream`.  p holds
// the 16 inputs in the kernel's order.  Returns a cudaError_t code.
template <int NH, int HD, typename T, typename Windows>
int launch_nstb(const void* const* p, void* out, const Windows& wins, int Q, int shift,
                float eps, cudaStream_t stream) {
  using L = Layout<NH, HD, T>;
  auto kern = nstb_kernel<NH, HD, T, Windows>;
  static int grid_cache[MAX_DEVICES] = {};
  int grid = 0;
  cudaError_t err = persistent_grid(kern, THREADS, L::BYTES, grid_cache, &grid);
  if (err != cudaSuccess) return (int)err;
  const int blocks = wins.count < grid ? wins.count : grid;
  kern<<<blocks, THREADS, L::BYTES, stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const float*)p[3],
      (const float*)p[4], (const float*)p[5], (const T*)p[6], (const float*)p[7],
      (const float*)p[8], (const float*)p[9], (const T*)p[10], (const float*)p[11],
      (const T*)p[12], (const float*)p[13], (const float*)p[14], (const float*)p[15],
      (T*)out, wins, Q, shift, eps);
  return (int)cudaGetLastError();
}

}  // namespace
