// Scaled-cosine window attention, forward, in one launch.
//
// Replaces the TPU kernels tmar/ops/pallas_attention.py:_attn_kernel_batched
// (:1143, the 64-token windows) and :_attn_kernel (:1175, the block-diagonal
// kernel of the n-gram windows: n² = 4 tokens at n = 2, 9 at n = 3, 1 at
// n = 1), both driven by _fused_forward (pallas_call at :357).  They compute
// one function at every window length.
// Plain version: tmar_torch/ops/cuda_attention.py:window_attention_kernel_math
// (at float32, tmar_torch/ops/attention.py:window_attention_math).
//
// Per window x [N, D]:
//   qkv = x @ wqkv + bqkv;  q, k L2-normalised per head
//   s   = q·kᵀ · scale[h] + bias[h] (+ the gated shift mask)
//   p   = softmax(s), with the row max subtracted
//   out = (p @ v, heads merged) @ wproj + bproj
// The shift mask of window (r, c) of a (wh, ww) grid is
// [r == wh-1]·m_row + [c == ww-1]·m_col; wh = 0 means no mask.  The kernel
// also writes lse[win, h, i] = max + log(sum), which the backward kernel
// reads in place of a second softmax pass.
//
// Six bodies, chosen by the I/O type and the geometry alone
// (window_attention_generic_mma.cuh: attn_mma::body, the rule of
// tmar_torch/ops/envelope.py: attention_body):
// * bfloat16 at the full-width NGswin's windows (N = 64, D = 64, heads 6 x 10
//   or 4 x 16: the training step's and the unfused serving form's): the
//   tensor-core body below (window_attention_mma.cuh), which rounds where
//   _attn_kernel_batched rounds: bf16 weights and x, q_n, k_n, v, P
//   normalised in float32 then rounded (:1133-1135), the merged head outputs
//   before the projection (:1170).
// * the full-width NGswin's other geometries (window_attention_geometries.cuh:
//   its windows at float32, its n-gram windows N = 1, 4, 9 at D = 32 at both
//   dtypes): the body templated on the geometry, which at bfloat16 rounds
//   where _attn_kernel rounds: its weights and the head outputs before the
//   projection (:1236), its scores and P·V float32.  At bfloat16 it
//   measured faster there than the short-window body (PERF.md §6).
// * bfloat16 windows of 1 to 31 tokens at every other geometry with a plan
//   (D a multiple of 8 up to 128, head_dim <= 32, the block fits): the
//   short-window body below (window_attention_fwd_smma), which rounds
//   where _attn_kernel rounds: the weights and x, and the head outputs
//   before the projection (:1236); q_n, k_n, the scores, P and P·V float32.
// * bfloat16 windows of 32 to 64 tokens at every other geometry with a plan
//   (D a multiple of 8 up to 128, head_dim <= 32): the tensor-core generic
//   body below (window_attention_fwd_gmma), rounding as the tensor-core body.
// * windows of more than 64 tokens (past 8x8) or heads wider than 32
//   channels, at either type: the long-window body
//   (window_attention_long.cuh: qkv, the attention and the projection as
//   three launches over a workspace in device memory), bounded only by
//   shared memory, rounding at bf16 as the CUDA-core generic body.
// * every other case (float32, and bfloat16 widths without a plan): the
//   CUDA-core generic body, which takes N (<= 64), D, the heads and head_dim
//   (<= 32) at run time.  At bfloat16 and N >= 32 it would round where the
//   tensor-core body does; below, where _attn_kernel rounds.
//
// What bounds it on an H100: about 45 kFLOP per token at N = 64 against 256
// to 512 bytes moved (x, the output, lse): operations on the CUDA cores in
// float32, bytes on the tensor cores in bfloat16 (the demo width's 512
// windows of 64 tokens at D 32: 0.00135 ms by bytes).
// CUDA-core generic body: a persistent block walks over tiles of whole windows (one
// 64-token window, four of 16, sixteen of 4, seven of 9 in 63 rows); the
// weights are read from device memory (L2) through their strides; heads are
// taken in groups that fit shared memory.  The score matrix is never
// stored: a thread owns one (head, query) row and passes over the keys of
// its window on the CUDA cores.
// Tensor-core body: every product is mma.sync.m16n8k16 (bf16 in, f32
// accumulate).  A persistent block of WG = 4 warpgroups stages the bf16
// weights and the float32 bias (times log2 e, XOR-swizzled so that a warp's
// float2 reads fall on distinct banks) once; each warpgroup takes one window
// at a time, each warp 16 query rows whose chain qkv -> q_n -> S -> P -> O ->
// projection stays in registers, x's A fragments read straight from device
// memory and the output written from the registers.  Only each head's k_n
// and v go through shared memory, double-buffered by head, so one warpgroup
// barrier per head suffices.  Keeping x out of shared memory is what makes
// room for four windows in flight per SM at 6 heads (two with x staged).

#include "window_attention_generic_mma.cuh"
#include "window_attention_geometries.cuh"
#include "window_attention_long.cuh"
#include "window_attention_mma.cuh"

namespace {

using namespace tmar;

// ---- the templated body: the full-width NGswin's geometries -----------------
template <int N, int D, int NH, int HD>
struct Geo {
  static constexpr int A = NH * HD;
  static constexpr int A3 = 3 * A;
  static constexpr int WPB = ROWS / N;  // windows per tile
  static constexpr int TR = WPB * N;    // a tile's rows that hold whole windows
  static constexpr int LX = D + 1;
  static constexpr int LQ = A3 + 1;
  static constexpr int LO = A + 1;
  static constexpr int LWQ = A3 + 1;    // wqkv  [D][LWQ]
  static constexpr int LWP = D + 1;     // wproj [A][LWP]
  static constexpr int X = 0;
  static constexpr int QKV = X + ROWS * LX;
  static constexpr int O = QKV + ROWS * LQ;
  static constexpr int WQKV = O + ROWS * LO;
  static constexpr int WPROJ = WQKV + D * LWQ;
  static constexpr int BQKV = WPROJ + A * LWP;
  static constexpr int BPROJ = BQKV + A3;
  static constexpr int SCALE = BPROJ + D;
  static constexpr int FLOATS = SCALE + 8;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
  static_assert(BYTES <= MAX_SMEM, "tile does not fit in shared memory");
};

template <int N, int D, int NH, int HD, typename T>
__global__ void __launch_bounds__(THREADS, 1) window_attention_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ wqkv, int wq_k, int wq_n,
    const float* __restrict__ bqkv, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ wproj, int wp_k, int wp_n,
    const float* __restrict__ bproj, const float* __restrict__ mrow,
    const float* __restrict__ mcol, T* __restrict__ out, float* __restrict__ lse,
    int nwin, int wh, int ww) {
  using G = Geo<N, D, NH, HD>;
  constexpr int A = G::A, A3 = G::A3, LX = G::LX, LQ = G::LQ, LO = G::LO;
  extern __shared__ float smem[];
  float* sX = smem + G::X;
  float* sQKV = smem + G::QKV;
  float* sO = smem + G::O;
  float* s_wqkv = smem + G::WQKV;
  float* s_wproj = smem + G::WPROJ;
  float* s_bqkv = smem + G::BQKV;
  float* s_bproj = smem + G::BPROJ;
  float* s_scale = smem + G::SCALE;

  // the matrices in the I/O type's values (bf16: as the JAX kernel packs them)
  const int tid = threadIdx.x;
  for (int e = tid; e < D * A3; e += THREADS) {
    const int k = e / A3, n = e % A3;
    s_wqkv[k * G::LWQ + n] = round_as<T>(wqkv[(size_t)k * wq_k + (size_t)n * wq_n]);
  }
  for (int e = tid; e < A * D; e += THREADS) {
    const int k = e / D, n = e % D;
    s_wproj[k * G::LWP + n] = round_as<T>(wproj[(size_t)k * wp_k + (size_t)n * wp_n]);
  }
  for (int e = tid; e < A3; e += THREADS) s_bqkv[e] = bqkv[e];
  for (int e = tid; e < D; e += THREADS) s_bproj[e] = bproj[e];
  if (tid < NH) s_scale[tid] = scale[tid];
  __syncthreads();

  const long total = (long)nwin * N;  // token rows
  const int tiles = (int)((total + G::TR - 1) / G::TR);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * G::TR;

    // 1. the tile's rows, zero past the end and past its last whole window
    // (TR < ROWS where N does not divide ROWS)
    for (int e = tid; e < ROWS * D; e += THREADS) {
      const int r = e / D, d = e % D;
      sX[r * LX + d] = r < G::TR && row0 + r < total ? to_f(x[(row0 + r) * D + d]) : 0.f;
    }
    __syncthreads();

    // 2. qkv = x @ wqkv + bqkv
    {
      float acc[ceil16(ROWS)][ceil16(A3)];
      mm_zero<ROWS, A3>(acc);
      mm_acc<ROWS, D, A3>(acc, sX, LX, 1, s_wqkv, G::LWQ, 1);
      mm_each<ROWS, A3>(acc, [&](int m, int n, float v) { sQKV[m * LQ + n] = v + s_bqkv[n]; });
    }
    __syncthreads();

    // 3. per-head L2 normalisation of q (heads 0..NH-1) and k (NH..2NH-1)
    for (int e = tid; e < ROWS * 2 * NH; e += THREADS) {
      float* t = sQKV + (e / (2 * NH)) * LQ + (e % (2 * NH)) * HD;
      float ss = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) ss = fmaf(t[d], t[d], ss);
      const float inv = 1.f / (sqrtf(ss) + 1e-12f);
#pragma unroll
      for (int d = 0; d < HD; ++d) t[d] *= inv;
    }
    __syncthreads();

    // 4. attention, one (head, query) row per thread
    for (int e = tid; e < NH * ROWS; e += THREADS) {
      const int h = e / ROWS, r = e % ROWS;
      const int w = r / N, i = r % N;
      const int win = tile * G::WPB + w;
      float o[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) o[d] = 0.f;
      if (r < G::TR && win < nwin) {
        const bool gr = wh > 0 && (win / ww) % wh == wh - 1;
        const bool gc = wh > 0 && win % ww == ww - 1;
        float q[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) q[d] = sQKV[r * LQ + h * HD + d];
        const float sc = s_scale[h];
        const float* kb = sQKV + (w * N) * LQ + A + h * HD;
        const float* bi = bias + ((size_t)h * N + i) * N;
        const float* mr = mrow + (size_t)i * N;
        const float* mc = mcol + (size_t)i * N;
        float m = -INFINITY;
        for (int j = 0; j < N; ++j) {
          const float* kj = kb + j * LQ;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) dot = fmaf(q[d], kj[d], dot);
          float s = dot * sc + bi[j];
          if (gr) s += mr[j];
          if (gc) s += mc[j];
          m = fmaxf(m, s);
        }
        float z = 0.f;
        for (int j = 0; j < N; ++j) {
          const float* kj = kb + j * LQ;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) dot = fmaf(q[d], kj[d], dot);
          float s = dot * sc + bi[j];
          if (gr) s += mr[j];
          if (gc) s += mc[j];
          const float p = expf(s - m);
          z += p;
          const float* vj = kj + A;
#pragma unroll
          for (int d = 0; d < HD; ++d) o[d] = fmaf(p, vj[d], o[d]);
        }
        const float iz = 1.f / z;
#pragma unroll
        for (int d = 0; d < HD; ++d) o[d] *= iz;
        lse[((size_t)win * NH + h) * N + i] = m + logf(z);
      }
#pragma unroll
      for (int d = 0; d < HD; ++d) sO[r * LO + h * HD + d] = round_as<T>(o[d]);
    }
    __syncthreads();

    // 5. out = o @ wproj + bproj
    {
      float acc[ceil16(ROWS)][ceil16(D)];
      mm_zero<ROWS, D>(acc);
      mm_acc<ROWS, A, D>(acc, sO, LO, 1, s_wproj, G::LWP, 1);
      mm_each<ROWS, D>(acc, [&](int m, int n, float v) {
        if (m < G::TR && row0 + m < total) store(out + (row0 + m) * D + n, v + s_bproj[n]);
      });
    }
    __syncthreads();
  }
}

template <int N, int D, int NH, int HD, typename T>
int launch(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* out,
           void* lse, int nwin, int wh, int ww, int blocks, cudaStream_t stream) {
  using G = Geo<N, D, NH, HD>;
  auto kern = window_attention_fwd_kernel<N, D, NH, HD, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::BYTES);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, THREADS, G::BYTES, stream>>>(
      (const T*)p[0], (const float*)p[1], wq_k, wq_n, (const float*)p[2],
      (const float*)p[3], (const float*)p[4], (const float*)p[5], wp_k, wp_n,
      (const float*)p[6], (const float*)p[7], (const float*)p[8], (T*)out,
      (float*)lse, nwin, wh, ww);
  return (int)cudaGetLastError();
}

// ---- the generic body: any (N <= 64, D, heads, head_dim <= HDM) -------------
// A persistent block walks over tiles of whole windows, 64 / N of them
// (WPB · N <= 64 rows); x, one group of hg heads' q/k/v and all heads'
// outputs of a tile sit in shared memory in float32, rows padded to an odd
// length, attn_mma::generic_fwd_bytes sized at launch
// (tmar_torch/ops/envelope.py: attention_fwd_bytes counts the same and picks
// hg, all heads where they fit).  The weights are read from device memory through their strides
// and rounded to T's values as they are read.  A thread owns one (head,
// query) row and passes three times over its window's keys: the row max, the
// softmax sum, then P·V with P normalised, so that P can be rounded where
// the 64-token JAX kernel rounds it.  With rk (bfloat16 at N >= 32, the
// windows _attn_kernel_batched takes) it rounds q_n, k_n, v and P as
// window_attention_kernel_math does; at N < 32 only the weights and the
// head outputs (_attn_kernel); at float32 nothing.

template <int HDM, typename T>
__global__ void __launch_bounds__(THREADS) window_attention_fwd_rt(
    const T* __restrict__ x, const float* __restrict__ wqkv, int wq_k, int wq_n,
    const float* __restrict__ bqkv, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ wproj, int wp_k, int wp_n,
    const float* __restrict__ bproj, const float* __restrict__ mrow,
    const float* __restrict__ mcol, T* __restrict__ out, float* __restrict__ lse, int nwin,
    int N, int D, int nh, int hd, int hg, int wh, int ww, int rk) {
  extern __shared__ float smem[];
  const int A = nh * hd, LX = D + 1, LQ = 3 * hg * hd + 1, LO = A + 1;
  float* sX = smem;
  float* sQ = sX + ROWS * LX;  // one group's q_n | k_n | v
  float* sO = sQ + ROWS * LQ;  // the head outputs, T's values
  const int tid = threadIdx.x;
  const int WPB = ROWS / N, TR = WPB * N;
  const long total = (long)nwin * N;
  const long tiles = (total + TR - 1) / TR;
  auto rkv = [&](float v) { return rk ? round_as<T>(v) : v; };

  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = tile * TR;
    const int rows = (int)(total - row0 < TR ? total - row0 : TR);  // whole windows
    for (int e = tid; e < rows * D; e += THREADS)
      sX[(e / D) * LX + e % D] = to_f(x[row0 * D + e]);
    __syncthreads();

    for (int h0 = 0; h0 < nh; h0 += hg) {
      const int hc = nh - h0 < hg ? nh - h0 : hg, G = hc * hd;
      // the group's column n of sQ is column col(n) of qkv
      auto col = [&](int n) { return (n / G) * A + h0 * hd + n % G; };

      // 1. q, k, v of the group's heads = x @ T(wqkv) + bqkv
      mm_rt(rows, 3 * G, D, [&](int m, int k) { return sX[m * LX + k]; },
            [&](int k, int n) {
              return round_as<T>(__ldg(wqkv + (size_t)k * wq_k + (size_t)col(n) * wq_n));
            },
            [&](int m, int n, float v) { sQ[m * LQ + n] = v + __ldg(bqkv + col(n)); });
      __syncthreads();

      // 2. q_n and k_n (rounded with rk), and v (rounded with rk)
      for (int e = tid; e < rows * 2 * hc; e += THREADS) {
        float* t = sQ + (e / (2 * hc)) * LQ + (e % (2 * hc)) * hd;
        float ss = 0.f;
        for (int d = 0; d < hd; ++d) ss = fmaf(t[d], t[d], ss);
        const float inv = 1.f / (sqrtf(ss) + 1e-12f);
        for (int d = 0; d < hd; ++d) t[d] = rkv(t[d] * inv);
      }
      for (int e = tid; e < rows * G; e += THREADS) {
        float* t = sQ + (e / G) * LQ + 2 * G + e % G;
        *t = rkv(*t);
      }
      __syncthreads();

      // 3. attention, one (head, query) row per thread
      for (int e = tid; e < hc * rows; e += THREADS) {
        const int hl = e / rows, r = e % rows, h = h0 + hl;
        const int w = r / N, i = r % N;
        const long win = tile * WPB + w;
        bool gr, gc;
        mask_gates((int)win, wh, ww, gr, gc);
        float q[HDM], o[HDM];
#pragma unroll
        for (int d = 0; d < HDM; ++d) {
          q[d] = d < hd ? sQ[r * LQ + hl * hd + d] : 0.f;
          o[d] = 0.f;
        }
        const float sc = scale[h];
        const float* kb = sQ + (w * N) * LQ + G + hl * hd;
        const float* bi = bias + ((size_t)h * N + i) * N;
        auto logit = [&](int j) {
          const float* kj = kb + j * LQ;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < HDM; ++d)
            if (d < hd) dot = fmaf(q[d], kj[d], dot);
          float s = dot * sc + bi[j];
          if (gr) s += mrow[i * N + j];
          if (gc) s += mcol[i * N + j];
          return s;
        };
        float m = -INFINITY;
        for (int j = 0; j < N; ++j) m = fmaxf(m, logit(j));
        float z = 0.f;
        for (int j = 0; j < N; ++j) z += expf(logit(j) - m);
        for (int j = 0; j < N; ++j) {
          const float p = rkv(expf(logit(j) - m) / z);
          const float* vj = kb + j * LQ + G;
#pragma unroll
          for (int d = 0; d < HDM; ++d)
            if (d < hd) o[d] = fmaf(p, vj[d], o[d]);
        }
        lse[((size_t)win * nh + h) * N + i] = m + logf(z);
#pragma unroll
        for (int d = 0; d < HDM; ++d)
          if (d < hd) sO[r * LO + h * hd + d] = round_as<T>(o[d]);
      }
      __syncthreads();
    }

    // 4. out = o @ T(wproj) + bproj
    mm_rt(rows, D, A, [&](int m, int k) { return sO[m * LO + k]; },
          [&](int k, int n) {
            return round_as<T>(__ldg(wproj + (size_t)k * wp_k + (size_t)n * wp_n));
          },
          [&](int m, int n, float v) { store(out + (row0 + m) * D + n, v + __ldg(bproj + n)); });
    __syncthreads();
  }
}

template <int HDM, typename T>
int launch_rt(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* out, void* lse,
              int nwin, int N, int D, int nh, int hd, int hg, int wh, int ww, int blocks,
              cudaStream_t stream) {
  const size_t bytes = attn_mma::generic_fwd_bytes(D, nh, hd, hg);
  auto kern = window_attention_fwd_rt<HDM, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, THREADS, bytes, stream>>>(
      (const T*)p[0], (const float*)p[1], wq_k, wq_n, (const float*)p[2], (const float*)p[3],
      (const float*)p[4], (const float*)p[5], wp_k, wp_n, (const float*)p[6],
      (const float*)p[7], (const float*)p[8], (T*)out, (float*)lse, nwin, N, D, nh, hd, hg, wh,
      ww, sizeof(T) == 2 && N >= 32);
  return (int)cudaGetLastError();
}

// ---- the bfloat16 tensor-core body, N = 64 ---------------------------------

template <int NH>
struct FwdMma {
  static constexpr int WG = 4;  // windows in flight per block
  static constexpr int AP = NH * HP;
  static constexpr int QKV = 3 * AP;
  // float32: bqkv [QKV], bproj [D], scale·log2e [8], bias·log2e [NH][64][64]
  static constexpr int BQKV = 0;
  static constexpr int BPROJ = BQKV + QKV;
  static constexpr int SCALE = BPROJ + WD;
  static constexpr int BIAS = SCALE + 8;
  static constexpr int FLOATS = BIAS + NH * WN * WN;
  // bf16: wqkv [QKV][LDX], wproj [AP][LDX]; per warpgroup two head slots,
  // each k_n and v [64][LDK]
  static constexpr int WQKV = 0;
  static constexpr int WPROJ = WQKV + QKV * LDX;
  static constexpr int WELEMS = WPROJ + AP * LDX;
  static constexpr int KV = 2 * WN * LDK;
  static constexpr int WGELEMS = 2 * KV;
  static constexpr size_t BYTES =
      FLOATS * sizeof(float) + (size_t)(WELEMS + WG * WGELEMS) * sizeof(__nv_bfloat16);
  static_assert(FLOATS % 4 == 0 && WELEMS % 8 == 0 && WGELEMS % 8 == 0, "16-byte regions");
  static_assert(BYTES <= MAX_SMEM, "does not fit in shared memory");
  static_assert(NH % 2 == 0, "head slots alternate: an even head count needs no barrier per window");
};

// bias element (h, r, c) of the staged [NH][64][64] bias: column XOR-swizzled
// by the row so that the float2 reads of a warp's eight rows spread over the
// banks
__device__ __forceinline__ int bias_at(int h, int r, int c) {
  return (h * WN + r) * WN + (c ^ ((r & 3) << 3));
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

template <int NH, int HD>
__global__ void __launch_bounds__(128 * FwdMma<NH>::WG, 1) window_attention_fwd_mma(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ wqkv, int wq_k, int wq_n,
    const float* __restrict__ bqkv, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ wproj, int wp_k, int wp_n,
    const float* __restrict__ bproj, const float* __restrict__ mrow,
    const float* __restrict__ mcol, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    int nwin, int wh, int ww) {
  using L = FwdMma<NH>;
  constexpr int WG = L::WG, THR = 128 * WG;
  extern __shared__ float4 smem4[];
  float* sf = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(sf + L::FLOATS);
  const int tid = threadIdx.x;

  // ---- once per block: weights in bf16, the rest float32 -------------------
  stage_attention_weights<NH, HD>(sw + L::WQKV, sw + L::WPROJ, sf + L::BQKV, wqkv, wq_k, wq_n,
                                  wproj, wp_k, wp_n, bqkv, tid, THR);
  for (int e = tid; e < WD; e += THR) sf[L::BPROJ + e] = bproj[e];
  if (tid < NH) sf[L::SCALE + tid] = scale[tid] * LOG2E;
  for (int e = tid; e < NH * WN * WN; e += THR)
    sf[L::BIAS + bias_at(e / (WN * WN), (e / WN) % WN, e % WN)] = bias[e] * LOG2E;
  __syncthreads();

  const __nv_bfloat16* s_wqkv = sw + L::WQKV;
  const __nv_bfloat16* s_wproj = sw + L::WPROJ;
  const int wg = tid >> 7, wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // this thread's rows in the window
  __nv_bfloat16* base = sw + L::WELEMS + wg * L::WGELEMS;

  for (int win = blockIdx.x * WG + wg; win < nwin; win += gridDim.x * WG) {
    // the warp's A fragments of x, straight from device memory
    const __nv_bfloat16* xw = x + (size_t)win * WN * WD;
    uint32_t xa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = 16 * kk + 2 * t;
      xa[kk][0] = ldg32(xw + r0 * WD + c), xa[kk][1] = ldg32(xw + r1 * WD + c);
      xa[kk][2] = ldg32(xw + r0 * WD + c + 8), xa[kk][3] = ldg32(xw + r1 * WD + c + 8);
    }
    bool gr, gc;
    mask_gates(win, wh, ww, gr, gc);

    float pj[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) pj[j][0] = pj[j][1] = pj[j][2] = pj[j][3] = 0.f;
#pragma unroll 1
    for (int h = 0; h < NH; ++h) {
      __nv_bfloat16* s_k = base + (h & 1) * L::KV;  // k_n [64][LDK]
      __nv_bfloat16* s_v = s_k + WN * LDK;          // v [64][LDK]
      uint32_t qa[4];
      {
        float acc[6][4], iq[2], ik[2];
        head_qkv<NH>(acc, xa, s_wqkv, sf + L::BQKV, h, lane);
        normalize_rows(acc[0], acc[1], iq);
        normalize_rows(acc[2], acc[3], ik);
        to_a(qa, acc[0], acc[1]);
        store_rows(s_k, acc[2], acc[3], r0, t);
        store_rows(s_v, acc[4], acc[5], r0, t);
      }
      // head h's k_n and v are in; head h - 2's (the same slot, the last
      // window's for h < 2) are read
      warpgroup_sync(wg);

      float s[8][4];
      cosines(s, qa, s_k, lane);
      const float* sb = sf + L::BIAS;
      to_logits2(s, sf[L::SCALE + h],
                 [&](int r, int c) {
                   return *reinterpret_cast<const float2*>(sb + bias_at(h, r, c));
                 },
                 mrow, mcol, gr, gc, r0, lane);
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
      m0 = quad_max(m0);
      m1 = quad_max(m1);
      float z0 = 0.f, z1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = exp2_approx(s[j][0] - m0), s[j][1] = exp2_approx(s[j][1] - m0);
        s[j][2] = exp2_approx(s[j][2] - m1), s[j][3] = exp2_approx(s[j][3] - m1);
        z0 += s[j][0] + s[j][1];
        z1 += s[j][2] + s[j][3];
      }
      z0 = quad_sum(z0);
      z1 = quad_sum(z1);
      if (t == 0) {  // natural-log lse, as the generic body writes it
        float* l = lse + ((size_t)win * NH + h) * WN;
        l[r0] = (m0 + log2f(z0)) * LN2;
        l[r1] = (m1 + log2f(z1)) * LN2;
      }
      const float iz0 = 1.f / z0, iz1 = 1.f / z1;
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] *= iz0, s[j][1] *= iz0, s[j][2] *= iz1, s[j][3] *= iz1;

      // O = bf16(P) · v, then bf16(O)'s share of the projection
      float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
        to_a(pa, s[2 * kk], s[2 * kk + 1]);
        mma_pair_t(o[0], o[1], pa, s_v, LDK, 0, 16 * kk, lane);
      }
      uint32_t oa[4];
      to_a(oa, o[0], o[1]);
#pragma unroll
      for (int j = 0; j < 8; j += 2) mma_pair_t(pj[j], pj[j + 1], oa, s_wproj, LDX, 8 * j, h * HP, lane);
    }

    // out = projection + bproj, bf16, from the registers
    __nv_bfloat16* ow = out + (size_t)win * WN * WD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float b0 = sf[L::BPROJ + c], b1 = sf[L::BPROJ + c + 1];
      sts32(ow + r0 * WD + c, pack_bf16(pj[j][0] + b0, pj[j][1] + b1));
      sts32(ow + r1 * WD + c, pack_bf16(pj[j][2] + b0, pj[j][3] + b1));
    }
  }
}

template <int NH, int HD>
int launch_mma(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* out,
               void* lse, int nwin, int wh, int ww, int blocks, cudaStream_t stream) {
  if (((uintptr_t)p[0] | (uintptr_t)out) & 3) return (int)cudaErrorMisalignedAddress;
  using L = FwdMma<NH>;
  auto kern = window_attention_fwd_mma<NH, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int grid = (nwin + L::WG - 1) / L::WG < blocks ? (nwin + L::WG - 1) / L::WG : blocks;
  kern<<<grid, 128 * L::WG, L::BYTES, stream>>>(
      (const __nv_bfloat16*)p[0], (const float*)p[1], wq_k, wq_n, (const float*)p[2],
      (const float*)p[3], (const float*)p[4], (const float*)p[5], wp_k, wp_n,
      (const float*)p[6], (const float*)p[7], (const float*)p[8], (__nv_bfloat16*)out,
      (float*)lse, nwin, wh, ww);
  return (int)cudaGetLastError();
}

// ---- the bfloat16 tensor-core generic body: 32 <= N <= 64 -------------------
// (window_attention_generic_mma.cuh: the plan, the rule, the layout.)  A
// warp owns 16 rows of a window; the chain x -> qkv -> q_n -> S -> P -> O
// -> projection stays in its registers, x's A fragments read straight from
// device memory, the output written from the registers.  Only each head's
// k_n and v go through shared memory (all the window's warps read them),
// double-buffered by head: one barrier of the window's warps per head.
// Rounding as the flagship body: bf16 x, weights, q_n, k_n, v, P (after its
// float32 normalisation) and the head outputs; float32 everything else.
template <int DM, int HPD>
__global__ void __launch_bounds__(attn_mma::WARPS * 32) window_attention_fwd_gmma(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ wqkv, int wq_k, int wq_n,
    const float* __restrict__ bqkv, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ wproj, int wp_k, int wp_n,
    const float* __restrict__ bproj, const float* __restrict__ mrow,
    const float* __restrict__ mcol, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    int nwin, int wh, int ww, attn_mma::FwdPlan P) {
  using namespace attn_mma;
  constexpr int DT = DM / 8, DK = DM / 16;     // accumulator tiles and k-steps of D
  constexpr int HT = HPD / 8, HK = HPD / 16;   // ... of a head
  extern __shared__ float4 smem4[];
  float* sf = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(sf + P.floats);
  const Geom& gm = P.g;
  const Weights& W = P.w;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int N = gm.N, D = gm.D, nh = gm.nh, NP = gm.NP, LDK = gm.LDK, AP = gm.AP;

  // ---- once per block: zeros (the weights' padding), the float32
  // parameters, resident weights
  for (int i = tid; i < (W.elems + P.G * P.gelems) / 8; i += nthreads)
    reinterpret_cast<uint4*>(sw)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int o = tid; o < 3 * AP; o += nthreads) {
    const int part = o / AP, h = (o % AP) / HPD, d = o % HPD;
    sf[P.f_bqkv + o] = d < gm.hd ? bqkv[part * gm.A + h * gm.hd + d] : 0.f;
  }
  for (int n = tid; n < gm.DP; n += nthreads) sf[P.f_bproj + n] = n < D ? bproj[n] : 0.f;
  for (int h = tid; h < nh; h += nthreads) sf[P.f_scale + h] = scale[h] * LOG2E;
  __syncthreads();  // the zeros are down before the weights go over them
  if (W.resident) stage_weights(sw, W, gm, 0, nh, wqkv, wq_k, wq_n, wproj, wp_k, wp_n, tid, nthreads);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int grp = warp / gm.WW, wig = warp % gm.WW;
  __nv_bfloat16* gbase = sw + W.elems + grp * P.gelems;
  const int r0 = 16 * wig + g, r1 = r0 + 8;  // this thread's rows in the window
  const int q0 = r0 < N ? r0 : 0, q1 = r1 < N ? r1 : 0;
  const int tiles = (nwin + P.G - 1) / P.G;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int win = tile * P.G + grp;
    const bool valid = win < nwin;
    // the warp's A fragments of x, straight from device memory (zero in the
    // padded rows and columns, and past the last window)
    uint32_t xa[DK][4];
    const __nv_bfloat16* xw = x + (size_t)(valid ? win : 0) * N * D;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = 16 * kk + 8 * hf + 2 * t;
        const bool in = valid && c < D;
        xa[kk][2 * hf] = in && r0 < N ? ldg32(xw + r0 * D + c) : 0u;
        xa[kk][2 * hf + 1] = in && r1 < N ? ldg32(xw + r1 * D + c) : 0u;
      }
    bool gr, gc;
    mask_gates(valid ? win : 0, wh, ww, gr, gc);

    float pj[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j) pj[j][0] = pj[j][1] = pj[j][2] = pj[j][3] = 0.f;
#pragma unroll 1
    for (int h = 0; h < nh; ++h) {
      if (!W.resident) {  // head h's weights, between two block barriers
        __syncthreads();
        stage_weights(sw, W, gm, h, h + 1, wqkv, wq_k, wq_n, wproj, wp_k, wp_n, tid, nthreads);
        __syncthreads();
      }
      __nv_bfloat16* s_k = gbase + (h & 1) * 2 * NP * LDK;  // k_n [NP][LDK]
      __nv_bfloat16* s_v = s_k + NP * LDK;                  // v [NP][LDK]
      uint32_t qa[HK][4];
      {
        // q, k, v of head h: part p's columns at qcol + p·pstride
        const int qcol = W.resident ? h * HPD : 0, pstride = W.resident ? AP : HPD;
        float acc[3][HT][4];
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int j = 0; j < HT; ++j) acc[p][j][0] = acc[p][j][1] = acc[p][j][2] = acc[p][j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          if (kk >= gm.dk) break;
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int n2 = 0; n2 < HK; ++n2)
              mma_pair_t(acc[p][2 * n2], acc[p][2 * n2 + 1], xa[kk], sw, W.ld_qkv,
                         qcol + p * pstride + 16 * n2, 16 * kk, lane);
        }
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int j = 0; j < HT; ++j) {
            const float* bq = sf + P.f_bqkv + p * AP + h * HPD + 8 * j + 2 * t;
            acc[p][j][0] += bq[0], acc[p][j][1] += bq[1], acc[p][j][2] += bq[0], acc[p][j][3] += bq[1];
          }
        // 1 / (|row| + 1e-12) of q (p = 0) and k (p = 1), over the quad
        float inv[2][2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int j = 0; j < HT; ++j) {
            s0 += acc[p][j][0] * acc[p][j][0] + acc[p][j][1] * acc[p][j][1];
            s1 += acc[p][j][2] * acc[p][j][2] + acc[p][j][3] * acc[p][j][3];
          }
          inv[p][0] = 1.f / (sqrtf(quad_sum(s0)) + 1e-12f);
          inv[p][1] = 1.f / (sqrtf(quad_sum(s1)) + 1e-12f);
        }
#pragma unroll
        for (int kk = 0; kk < HK; ++kk) {
          const float* lo = acc[0][2 * kk];
          const float* hi = acc[0][2 * kk + 1];
          qa[kk][0] = pack_bf16(lo[0] * inv[0][0], lo[1] * inv[0][0]);
          qa[kk][1] = pack_bf16(lo[2] * inv[0][1], lo[3] * inv[0][1]);
          qa[kk][2] = pack_bf16(hi[0] * inv[0][0], hi[1] * inv[0][0]);
          qa[kk][3] = pack_bf16(hi[2] * inv[0][1], hi[3] * inv[0][1]);
        }
#pragma unroll
        for (int j = 0; j < HT; ++j) {
          const int c = 8 * j + 2 * t;
          const float* kt = acc[1][j];
          const float* vt = acc[2][j];
          sts32(s_k + r0 * LDK + c, pack_bf16(kt[0] * inv[1][0], kt[1] * inv[1][0]));
          sts32(s_k + r1 * LDK + c, pack_bf16(kt[2] * inv[1][1], kt[3] * inv[1][1]));
          sts32(s_v + r0 * LDK + c, pack_bf16(vt[0], vt[1]));
          sts32(s_v + r1 * LDK + c, pack_bf16(vt[2], vt[3]));
        }
      }
      group_sync(grp, gm.WW);  // head h's k_n and v are in; head h - 2's are read

      // S = q_n · k_nᵀ (tile j: keys [8j, 8j + 8)), then the logits in log2
      // units, padded keys -inf
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (16 * jp >= NP) break;
#pragma unroll
        for (int kk = 0; kk < HK; ++kk)
          mma_pair(s[2 * jp], s[2 * jp + 1], qa[kk], s_k, LDK, 16 * jp, 16 * kk, lane);
      }
      const float sc2 = sf[P.f_scale + h];
      const float* bh = bias + (size_t)h * N * N;
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= NP) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          s[j][e] = logit2(s[j][e], sc2, bh, mrow, mcol, gr, gc, N, q0, c);
          s[j][2 + e] = logit2(s[j][2 + e], sc2, bh, mrow, mcol, gr, gc, N, q1, c);
          m0 = fmaxf(m0, s[j][e]), m1 = fmaxf(m1, s[j][2 + e]);
        }
      }
      m0 = quad_max(m0);
      m1 = quad_max(m1);
      float z0 = 0.f, z1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= NP) break;
        s[j][0] = exp2_approx(s[j][0] - m0), s[j][1] = exp2_approx(s[j][1] - m0);
        s[j][2] = exp2_approx(s[j][2] - m1), s[j][3] = exp2_approx(s[j][3] - m1);
        z0 += s[j][0] + s[j][1];
        z1 += s[j][2] + s[j][3];
      }
      z0 = quad_sum(z0);
      z1 = quad_sum(z1);
      if (t == 0 && valid) {  // natural-log lse, as every body writes it
        float* l = lse + ((size_t)win * nh + h) * N;
        if (r0 < N) l[r0] = (m0 + log2f(z0)) * LN2;
        if (r1 < N) l[r1] = (m1 + log2f(z1)) * LN2;
      }
      const float iz0 = 1.f / z0, iz1 = 1.f / z1;
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] *= iz0, s[j][1] *= iz0, s[j][2] *= iz1, s[j][3] *= iz1;

      // O = bf16(P) · v, then bf16(O) · the head's projection rows
      float o[HT][4];
#pragma unroll
      for (int j = 0; j < HT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk >= NP) break;
        uint32_t pa[4];
        to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int n2 = 0; n2 < HK; ++n2)
          mma_pair_t(o[2 * n2], o[2 * n2 + 1], pa, s_v, LDK, 16 * n2, 16 * kk, lane);
      }
      const int prow = W.resident ? h * HPD : 0;
#pragma unroll
      for (int kk = 0; kk < HK; ++kk) {
        uint32_t oa[4];
        to_a(oa, o[2 * kk], o[2 * kk + 1]);
#pragma unroll
        for (int n2 = 0; n2 < DK; ++n2) {
          if (n2 >= gm.dk) break;
          mma_pair_t(pj[2 * n2], pj[2 * n2 + 1], oa, sw + W.w_proj, W.ld_proj, 16 * n2,
                     prow + 16 * kk, lane);
        }
      }
    }

    // out = projection + bproj, bf16, from the registers (real rows and columns)
    if (valid) {
      __nv_bfloat16* ow = out + (size_t)win * N * D;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int c = 8 * j + 2 * t;
        if (c >= D) break;
        const float b0 = sf[P.f_bproj + c], b1 = sf[P.f_bproj + c + 1];
        if (r0 < N) sts32(ow + r0 * D + c, pack_bf16(pj[j][0] + b0, pj[j][1] + b1));
        if (r1 < N) sts32(ow + r1 * D + c, pack_bf16(pj[j][2] + b0, pj[j][3] + b1));
      }
    }
    group_sync(grp, gm.WW);  // the head buffers are free for the next window
  }
}

template <int DM, int HPD>
int launch_gmma_t(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* out,
                  void* lse, int nwin, int wh, int ww, const attn_mma::FwdPlan& P,
                  cudaStream_t stream) {
  auto kern = window_attention_fwd_gmma<DM, HPD>;
  static int cache[64][3] = {};
  int grid = 0;
  const int err = tmar::persistent_grid(kern, P.bytes, P.threads, cache, &grid);
  if (err) return err;
  const int tiles = (nwin + P.G - 1) / P.G;
  kern<<<tiles < grid ? tiles : grid, P.threads, P.bytes, stream>>>(
      (const __nv_bfloat16*)p[0], (const float*)p[1], wq_k, wq_n, (const float*)p[2],
      (const float*)p[3], (const float*)p[4], (const float*)p[5], wp_k, wp_n,
      (const float*)p[6], (const float*)p[7], (const float*)p[8], (__nv_bfloat16*)out,
      (float*)lse, nwin, wh, ww, P);
  return (int)cudaGetLastError();
}

// The tensor-core generic body on windows of N tokens (its plan must exist).
int launch_gmma(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* out,
                void* lse, int nwin, int N, int D, int nh, int hd, int wh, int ww,
                cudaStream_t s) {
  attn_mma::Plan plan;
  if (!attn_mma::plan(N, D, nh, hd, &plan)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)p[0] | (uintptr_t)out) & 3) return (int)cudaErrorMisalignedAddress;
  const attn_mma::FwdPlan& P = plan.f;
  if (P.g.HP == 16) {
    if (P.g.DP <= 32) return launch_gmma_t<32, 16>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, P, s);
    if (P.g.DP <= 64) return launch_gmma_t<64, 16>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, P, s);
    return launch_gmma_t<128, 16>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, P, s);
  }
  if (P.g.DP <= 32) return launch_gmma_t<32, 32>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, P, s);
  if (P.g.DP <= 64) return launch_gmma_t<64, 32>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, P, s);
  return launch_gmma_t<128, 32>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, P, s);
}

// ---- the bfloat16 tensor-core short-window body: 1 <= N <= 31 --------------
// (window_attention_generic_mma.cuh: the plan, the rule, the layout.)  A
// warp owns a unit of R = 16·F rows holding WPU whole windows:
//  1. q, k, v of its rows on mma.sync from x's A fragments (read straight
//     from device memory) and the staged bf16 wqkv, plus bqkv; q and k
//     normalised in float32 in the registers; q_n | k_n | v into the warp's
//     float32 slice;
//  2. the attention core in float32 on the CUDA cores, a lane to a (row,
//     head): the scores of the row's window from the slice, the softmax with
//     its row max subtracted, P·v, lse; the head output rounded to bf16 into
//     the warp's O tile (_attn_kernel rounds it there, :1236);
//  3. out = O · wproj on mma.sync (O by ldmatrix) plus bproj, bf16, from the
//     registers.
// Only __syncwarp separates the phases, so the warps of a block and the
// blocks of an SM (several fit: 4 warps and tens of KB a block) hide each
// other's latency.  Rounding as _attn_kernel: x, the weights and the head
// outputs bf16; every other value float32.  Bound: bytes (x, out, lse;
// 0.00038 ms at the n = 2 step's 2048 windows); at those sizes a block
// takes one unit a warp, so the launch is latency: the staging of the
// parameters (one cp.async round trip) and one unit's chain.
template <int HPD>
__global__ void __launch_bounds__(128) window_attention_fwd_smma(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ wqkv, int wq_k, int wq_n,
    const float* __restrict__ bqkv, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ wproj, int wp_k, int wp_n,
    const float* __restrict__ bproj, const float* __restrict__ mrow,
    const float* __restrict__ mcol, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    int nwin, int wh, int ww, attn_mma::ShortFwd P) {
  using namespace attn_mma;
  constexpr int CWD = HPD < 16 ? 16 : HPD, CT = CWD / 8, HC = CWD / HPD;
  extern __shared__ float4 smem4[];
  float* sf = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(sf + P.floats);
  const Short& S = P.s;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int N = S.N, D = S.D, nh = S.nh, APP = S.APP, R = S.R, LQ = P.LQ, LO = P.LO;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<char*>(sw + S.welems) + warp * P.warp_bytes);  // O [R][LO]
  __nv_bfloat16* sx = so + R * LO;                                     // x [R][LX]
  float* sq = reinterpret_cast<float*>(sx + R * P.LX);                 // q_n | k_n | v [R][LQ]

  // ---- once per block: zeros (the padding of the weights, bqkv and
  // bproj), every parameter (through the warps' regions), then zeros in the
  // O tiles (their padded columns)
  for (int i = tid; i < S.welems / 8; i += nthreads)
    reinterpret_cast<uint4*>(sw)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < P.f_scale; i += nthreads) sf[i] = 0.f;
  __syncthreads();
  stage_short({sw, sf + P.f_bqkv, sf + P.f_bproj, sf + P.f_scale, sf + P.f_bias, sf + P.f_mask},
              S, reinterpret_cast<float*>(sw + S.welems), wqkv, wq_k, wq_n, wproj, wp_k, wp_n,
              bqkv, bproj, scale, bias, mrow, mcol, wh, tid, nthreads);
  for (int i = lane; i < R * LO / 8; i += 32)
    reinterpret_cast<uint4*>(so)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();

  const float* sb = sf + P.f_bias;   // bias [nh][N][N]
  const float* smr = sf + P.f_mask;  // mask rows [N][N]
  const float* smc = smr + N * N;    // ... columns
  // the lane's row of a unit, its window and query (fixed for the kernel),
  // and its first head: a lane to a (row, head), 32 / R heads at a time
  const int r = lane & (R - 1), h0 = lane / R, hstep = 32 / R;
  const int w = r / N, i = r - w * N;
  const long total = (long)nwin * N;
  const int units = (nwin + S.WPU - 1) / S.WPU;

  for (int u = blockIdx.x * P.W + warp; u < units; u += gridDim.x * P.W) {
    const long row0 = (long)u * S.RU;

    // 1. the unit's x rows by cp.async; q_n, k_n, v into the slice
    load_rows(sx, P.LX, x, row0, (int)(total - row0 < S.RU ? total - row0 : S.RU), S, lane);
    for (int f = 0; f < S.F; ++f) {
      const int ra = 16 * f + g;
      for (int c0 = 0; c0 < APP; c0 += CWD) {
        float acc[3][CT][4], inv[2][HC][2];
        short_qkv<HPD, CWD>(acc, inv, sx, P.LX, 16 * f, sw, S, sf + P.f_bqkv, c0, lane);
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int j = 0; j < CT; ++j) store_tile_f32(sq, LQ, ra, p * APP + c0 + 8 * j + 2 * t, acc[p][j]);
      }
    }
    __syncwarp();

    // 2. the attention core, a lane to a (row, head): the row max, then
    // the softmax sum and P·v; the output rounded to bf16 into O
    const long win = (long)u * S.WPU + w;
    const bool real = r < S.RU && win < nwin;
    bool gr, gc;
    mask_gates(real ? (int)win : 0, wh, ww, gr, gc);
    const float* kb0 = sq + (w * N) * LQ + APP;  // k_n of the row's window's key 0
#pragma unroll 1
    for (int h = h0; h < nh; h += hstep) {
      float o[HPD];
#pragma unroll
      for (int d = 0; d < HPD; ++d) o[d] = 0.f;
      if (real) {
        float q[HPD];
#pragma unroll
        for (int d = 0; d < HPD; ++d) q[d] = sq[r * LQ + h * HPD + d];
        const float* kb = kb0 + h * HPD;
        const float sc = sf[P.f_scale + h];
        const float* bi = sb + (h * N + i) * N;
        auto logit = [&](int j) {
          const float* kj = kb + j * LQ;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < HPD; ++d) dot = fmaf(q[d], kj[d], dot);
          float v = dot * sc + bi[j];
          if (gr) v += smr[i * N + j];
          if (gc) v += smc[i * N + j];
          return v;
        };
        float m = -INFINITY, z = 0.f;
#pragma unroll 4
        for (int j = 0; j < N; ++j) m = fmaxf(m, logit(j));
#pragma unroll 4
        for (int j = 0; j < N; ++j) {
          const float pj = expf(logit(j) - m);
          z += pj;
          const float* vj = kb + j * LQ + APP;
#pragma unroll
          for (int d = 0; d < HPD; ++d) o[d] = fmaf(pj, vj[d], o[d]);
        }
        const float iz = 1.f / z;
#pragma unroll
        for (int d = 0; d < HPD; ++d) o[d] *= iz;
        lse[((size_t)win * nh + h) * N + i] = m + logf(z);
      }
      __nv_bfloat16* orow = so + r * LO + h * HPD;
#pragma unroll
      for (int d = 0; d < HPD; d += 2) sts32(orow + d, pack_bf16(o[d], o[d + 1]));
    }
    __syncwarp();

    // 3. out = O · wproj + bproj, bf16, from the registers (real rows and
    // columns), 16 output columns at a time
    __nv_bfloat16* ou = out + row0 * D;
    for (int f = 0; f < S.F; ++f) {
      const int ra = 16 * f + g, rb = ra + 8;
      const bool va = ra < S.RU && row0 + ra < total, vb = rb < S.RU && row0 + rb < total;
      for (int n2 = 0; n2 < S.dk; ++n2) {
        float pj[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int kk = 0; kk < APP / 16; ++kk) {
          uint32_t oa[4];
          load_a(oa, so, LO, 16 * f, 16 * kk, lane);
          mma_pair_t(pj[0], pj[1], oa, sw + S.w_proj, S.LPW, 16 * n2, 16 * kk, lane);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 16 * n2 + 8 * j + 2 * t;
          if (c >= D) break;
          const float b0 = sf[P.f_bproj + c], b1 = sf[P.f_bproj + c + 1];
          if (va) sts32(ou + ra * D + c, pack_bf16(pj[j][0] + b0, pj[j][1] + b1));
          if (vb) sts32(ou + rb * D + c, pack_bf16(pj[j][2] + b0, pj[j][3] + b1));
        }
      }
    }
    __syncwarp();  // the slice and O are free for the next unit
  }
}

template <int HPD>
int launch_smma_t(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* out,
                  void* lse, int nwin, int wh, int ww, const attn_mma::ShortFwd& P,
                  cudaStream_t stream) {
  auto kern = window_attention_fwd_smma<HPD>;
  static int cache[64][3] = {};
  int grid = 0;
  const int err = tmar::persistent_grid(kern, P.bytes, P.threads, cache, &grid);
  if (err) return err;
  const int units = (nwin + P.s.WPU - 1) / P.s.WPU, blocks = (units + P.W - 1) / P.W;
  kern<<<blocks < grid ? blocks : grid, P.threads, P.bytes, stream>>>(
      (const __nv_bfloat16*)p[0], (const float*)p[1], wq_k, wq_n, (const float*)p[2],
      (const float*)p[3], (const float*)p[4], (const float*)p[5], wp_k, wp_n,
      (const float*)p[6], (const float*)p[7], (const float*)p[8], (__nv_bfloat16*)out,
      (float*)lse, nwin, wh, ww, P);
  return (int)cudaGetLastError();
}

// The short-window body on windows of N tokens (its plan must exist).
int launch_smma(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* out,
                void* lse, int nwin, int N, int D, int nh, int hd, int wh, int ww,
                cudaStream_t s) {
  attn_mma::ShortFwd P;
  attn_mma::ShortBwd B;
  if (!attn_mma::short_plan(N, D, nh, hd, &P, &B)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)p[0] | (uintptr_t)out) & 3) return (int)cudaErrorMisalignedAddress;
#define TMAR_SMMA(HPV) \
  if (P.s.HP == HPV) return launch_smma_t<HPV>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, P, s);
  TMAR_SHORT_WIDTHS(TMAR_SMMA)
#undef TMAR_SMMA
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_generic(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* out,
                   void* lse, int nwin, int N, int D, int nh, int hd, int hg, int wh, int ww,
                   int blocks, cudaStream_t s) {
  if (hd <= 8)
    return launch_rt<8, T>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, N, D, nh, hd, hg, wh, ww,
                           blocks, s);
  if (hd <= 16)
    return launch_rt<16, T>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, N, D, nh, hd, hg, wh, ww,
                            blocks, s);
  return launch_rt<32, T>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, N, D, nh, hd, hg, wh, ww,
                          blocks, s);
}

}  // namespace

extern "C" {

// x [nwin, N, D] (float32 or bfloat16, per is_bf16) -> out of the same shape
// and type, and lse [nwin, nh, N] float32.  `workspace` (read by the
// long-window body alone, null elsewhere) holds the floats that
// tmar_window_attention_fwd_workspace gives.  All parameters are float32 (the
// bfloat16 bodies round the two matrices): wqkv [D, 3A] and wproj [A, D] are
// read as w[k·w_k + n·w_n]; bqkv [3A]; scale [nh] = exp(min(logit_scale,
// ln 100)); bias [nh, N, N]; bproj [D]; mrow, mcol [N, N] are read only when
// wh > 0.  `body` is the body the caller picked (attn_mma::body, the rule
// of tmar_torch/ops/envelope.py: attention_body); another than the rule's
// is refused.  The flagship body (`blocks` is then the most persistent
// blocks) and the tensor-core generic body size their own grids; the
// templated and CUDA-core generic bodies take hg heads at a time on
// `blocks` persistent blocks.  Returns a cudaError_t code.
int tmar_window_attention_fwd(const void* x, const void* wqkv, const void* bqkv,
                              const void* scale, const void* bias, const void* wproj,
                              const void* bproj, const void* mrow, const void* mcol,
                              void* out, void* lse, void* workspace, int nwin, int N, int D,
                              int num_heads, int head_dim, int hg, int wq_k, int wq_n, int wp_k,
                              int wp_n, int wh, int ww, int blocks, int is_bf16, int body,
                              void* stream) {
  if (nwin < 1 || blocks < 1 || N < 1 || D < 1 || num_heads < 1 || head_dim < 1 || hg < 1 ||
      (wh > 0 && (ww < 1 || nwin % (wh * ww))) ||
      body != attn_mma::body(N, D, num_heads, head_dim, is_bf16))
    return (int)cudaErrorInvalidValue;
  const void* p[9] = {x, wqkv, bqkv, scale, bias, wproj, bproj, mrow, mcol};
  cudaStream_t s = (cudaStream_t)stream;
  if (body == attn_mma::LONG_TC)
    return long_mma::fwd(p, wq_k, wq_n, wp_k, wp_n, out, lse, (float*)workspace, nwin, N, D,
                         num_heads, head_dim, wh, ww, s);
  if (body == attn_mma::LONG)
    return is_bf16 ? attn_long::fwd<__nv_bfloat16>(p, wq_k, wq_n, wp_k, wp_n, out, lse,
                                                   (float*)workspace, nwin, N, D, num_heads,
                                                   head_dim, wh, ww, s)
                   : attn_long::fwd<float>(p, wq_k, wq_n, wp_k, wp_n, out, lse, (float*)workspace,
                                           nwin, N, D, num_heads, head_dim, wh, ww, s);
  if (body == attn_mma::FLAGSHIP)
    return num_heads == 6
               ? launch_mma<6, 10>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, blocks, s)
               : launch_mma<4, 16>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, blocks, s);
  if (body == attn_mma::TENSOR_CORE)
    return launch_gmma(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, N, D, num_heads, head_dim, wh,
                       ww, s);
  if (body == attn_mma::SHORT)
    return launch_smma(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, N, D, num_heads, head_dim, wh,
                       ww, s);
  // the templated body at the full-width NGswin's other geometries: its
  // float32 windows, and its n-gram windows at both dtypes
#define TMAR_CASE(NN, DD, NH, HD, T)                                                   \
  if (N == NN && D == DD && num_heads == NH && head_dim == HD)                         \
    return launch<NN, DD, NH, HD, T>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, blocks, s);
#define TMAR_F32(NN, DD, NH, HD) TMAR_CASE(NN, DD, NH, HD, float)
#define TMAR_BF16(NN, DD, NH, HD) TMAR_CASE(NN, DD, NH, HD, __nv_bfloat16)
  if (is_bf16) {
    TMAR_ATTN_NGRAM_GEOMETRIES(TMAR_BF16)
    return launch_generic<__nv_bfloat16>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, N, D,
                                         num_heads, head_dim, hg, wh, ww, blocks, s);
  }
  TMAR_ATTN_WINDOW_GEOMETRIES(TMAR_F32)
  TMAR_ATTN_NGRAM_GEOMETRIES(TMAR_F32)
#undef TMAR_CASE
#undef TMAR_F32
#undef TMAR_BF16
  return launch_generic<float>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, N, D, num_heads,
                               head_dim, hg, wh, ww, blocks, s);
}

// The float32 workspace, in floats, of the body that runs these arguments:
// the long-window body's qkv and head outputs, 0 for the others.
long long tmar_window_attention_fwd_workspace(int nwin, int N, int D, int num_heads, int head_dim,
                                              int is_bf16) {
  if (nwin < 1 || N < 1 || D < 1 || num_heads < 1 || head_dim < 1) return -1;
  const attn_mma::Body b = attn_mma::body(N, D, num_heads, head_dim, is_bf16);
  if (b == attn_mma::LONG_TC) return long_mma::fwd_workspace(nwin, N, num_heads, head_dim);
  return b == attn_mma::LONG ? attn_long::fwd_workspace(nwin, N, num_heads, head_dim) : 0;
}

// The shared memory, in bytes, of the largest block of the long-window
// bodies' launches for windows of N tokens: the CUDA-core body's K3 (which
// 1) or K4 (2), the tensor-core body's K3 (3) or K4 (4); -1 where a launch
// fits no block (or the tensor-core body takes no plan).
long long tmar_window_attention_fwd_long_smem(int N, int D, int num_heads, int head_dim,
                                              int which) {
  if (which >= 3) {
    const size_t b = long_mma::attn_plan_bytes(N, D, num_heads, head_dim, which == 4);
    return b ? (long long)b : -1;
  }
  if (!attn_long::fits(N, D, num_heads, head_dim)) return -1;
  return (long long)attn_long::plan_bytes(N, D, num_heads, head_dim, which == 2);
}

// The shared memory, in bytes, of the generic body's launch with hg heads
// to a group.
long long tmar_window_attention_fwd_smem(int D, int num_heads, int head_dim, int hg) {
  return (long long)attn_mma::generic_fwd_bytes(D, num_heads, head_dim, hg);
}

// The tensor-core generic body at any bfloat16 geometry it has a plan for,
// the flagship's too, with tmar_window_attention_fwd's arguments (hg,
// blocks and body unread): chip_smoke.py's flagship-geometry line, never a
// dispatch.
int tmar_window_attention_fwd_gmma(const void* x, const void* wqkv, const void* bqkv,
                                   const void* scale, const void* bias, const void* wproj,
                                   const void* bproj, const void* mrow, const void* mcol,
                                   void* out, void* lse, void* workspace, int nwin, int N, int D,
                                   int num_heads, int head_dim, int hg, int wq_k, int wq_n,
                                   int wp_k, int wp_n, int wh, int ww, int blocks, int is_bf16,
                                   int body, void* stream) {
  (void)hg, (void)blocks, (void)body, (void)workspace;
  if (!is_bf16 || nwin < 1 || (wh > 0 && (ww < 1 || nwin % (wh * ww))))
    return (int)cudaErrorInvalidValue;
  const void* p[9] = {x, wqkv, bqkv, scale, bias, wproj, bproj, mrow, mcol};
  return launch_gmma(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, N, D, num_heads, head_dim, wh, ww,
                     (cudaStream_t)stream);
}

// The shared memory, in bytes, of the tensor-core generic body's launch
// for windows of N tokens (-1 where it has no plan).
long long tmar_window_attention_fwd_mma_smem(int N, int D, int num_heads, int head_dim) {
  attn_mma::Plan P;
  return attn_mma::plan(N, D, num_heads, head_dim, &P) ? (long long)P.f.bytes : -1;
}

// The short-window body at any bfloat16 geometry it has a plan for (the
// full-width NGswin's n-gram windows too, which the templated body runs),
// with tmar_window_attention_fwd's arguments (hg, blocks and body unread):
// chip_smoke.py's and the GPU tests' check of it there, never a dispatch.
int tmar_window_attention_fwd_smma(const void* x, const void* wqkv, const void* bqkv,
                                   const void* scale, const void* bias, const void* wproj,
                                   const void* bproj, const void* mrow, const void* mcol,
                                   void* out, void* lse, void* workspace, int nwin, int N, int D,
                                   int num_heads, int head_dim, int hg, int wq_k, int wq_n,
                                   int wp_k, int wp_n, int wh, int ww, int blocks, int is_bf16,
                                   int body, void* stream) {
  (void)hg, (void)blocks, (void)body, (void)workspace;
  if (!is_bf16 || nwin < 1 || (wh > 0 && (ww < 1 || nwin % (wh * ww))))
    return (int)cudaErrorInvalidValue;
  const void* p[9] = {x, wqkv, bqkv, scale, bias, wproj, bproj, mrow, mcol};
  return launch_smma(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, N, D, num_heads, head_dim, wh, ww,
                     (cudaStream_t)stream);
}

// The shared memory, in bytes, of the short-window body's launch for
// windows of N tokens (-1 where it has no plan).
long long tmar_window_attention_fwd_short_smem(int N, int D, int num_heads, int head_dim) {
  attn_mma::ShortFwd f;
  attn_mma::ShortBwd b;
  return attn_mma::short_plan(N, D, num_heads, head_dim, &f, &b) ? (long long)f.bytes : -1;
}

// The body this source runs for the geometry and I/O type (attn_mma::Body).
int tmar_window_attention_fwd_body(int N, int D, int num_heads, int head_dim, int is_bf16) {
  return (int)attn_mma::body(N, D, num_heads, head_dim, is_bf16);
}

const char* tmar_window_attention_fwd_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
