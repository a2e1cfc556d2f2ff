// N-gram context of one NSTB, in one launch.
//
// Replaces the TPU kernel tmar/ops/pallas_ngram.py:_ngram_stripe_kernel
// (driven by _forward, pallas_call at :306).  Plain version:
// tmar_torch/ops/cuda_ngram.py:ngram_context_math.
//
// Input is the unigram grid u [B, wh, ww, C=32]; output the context
// [B, wh, ww, D=64].  Per grid cell, for each of the two directions:
//   * the four tokens of the 2x2 sliding window over the sequence-reflect
//     padded grid: forward (self, right, down, down-right), where the last
//     row/column reflect to index wh-2 / ww-2; backward (up-left, up, left,
//     self), where row/column -1 reflects to index 1;
//   * per head: cosine scores x exp(min(logit_scale, ln 100)) + the 2x2
//     relative-position bias, a 4-way softmax with the row max subtracted,
//     AV, and the mean over the 4 query tokens (taken before the [A, C]
//     projection, with which it commutes);
// then ctx_f @ wm[:C] + ctx_b @ wm[C:] + b_merge.
//
// What bounds it on an H100: neither bytes nor operations.  At the 8x512²
// stage-1 shape it reads 8·64·64·32 inputs and writes twice as many outputs
// (a few MB, about 2 µs at 3.35 TB/s) and does ~0.4 GFLOP, so it is bound
// by launch and latency.  Design: a block owns a segment of TJ cells of one
// grid row and stages the three input rows it needs (own, up, down, each
// with one halo column on either side, reflect-mapped at the edges) in
// shared memory.  There is no sequential grid to carry halos from one step
// to the next as on the TPU, so each block recomputes the q/k/v of its halo
// (3·(TJ+2) positions for TJ outputs).  All weights sit in shared memory;
// everything is computed in float32, whatever the I/O type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int C = 32;        // unigram channels (D / 2)
constexpr int D = 64;        // context channels
constexpr int TJ = 32;       // grid cells per block
constexpr int NPOS = 3 * (TJ + 2);
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// sequence-reflect index map of the halo: -1 -> 1, n -> n-2; positions past
// n only feed cells outside the grid and are clamped to stay in bounds
__device__ __forceinline__ int reflect(int r, int n) {
  if (r < 0) return 1;
  if (r == n) return n - 2;
  return r < n ? r : n - 1;
}

template <int NH, int HD>
struct Layout {
  static constexpr int A = NH * HD;
  static constexpr int A3 = 3 * A;
  static constexpr int LQ = A3 + 1;  // padded qkv row
  static constexpr int WQKV = 0;
  static constexpr int BQKV = WQKV + C * A3;
  static constexpr int WPROJ = BQKV + A3;
  static constexpr int BPROJ = WPROJ + A * C;
  static constexpr int WM = BPROJ + C;
  static constexpr int BM = WM + 2 * C * D;
  static constexpr int SCALE = BM + D;
  static constexpr int BIAS = SCALE + 8;
  static constexpr int U = BIAS + NH * 16;
  static constexpr int QKV = U + NPOS * C;
  static constexpr int MEAN = QKV + NPOS * LQ;
  static constexpr int CTX = MEAN + TJ * 2 * A;
  static constexpr int FLOATS = CTX + TJ * 2 * C;
};

template <int NH, int HD, typename T>
__global__ void __launch_bounds__(THREADS) ngram_context_kernel(
    const T* __restrict__ u, const float* __restrict__ wqkv,
    const float* __restrict__ bqkv, const float* __restrict__ scale,
    const float* __restrict__ table, const float* __restrict__ wproj,
    const float* __restrict__ bproj, const float* __restrict__ wmerge,
    const float* __restrict__ bmerge, T* __restrict__ out, int wh, int ww) {
  using L = Layout<NH, HD>;
  constexpr int A = L::A;
  constexpr int A3 = L::A3;
  constexpr int LQ = L::LQ;
  extern __shared__ float smem[];
  float* s_wqkv = smem + L::WQKV;
  float* s_bqkv = smem + L::BQKV;
  float* s_wproj = smem + L::WPROJ;
  float* s_bproj = smem + L::BPROJ;
  float* s_wm = smem + L::WM;
  float* s_bm = smem + L::BM;
  float* s_scale = smem + L::SCALE;
  float* s_bias = smem + L::BIAS;
  float* s_u = smem + L::U;
  float* s_qkv = smem + L::QKV;
  float* s_mean = smem + L::MEAN;
  float* s_ctx = smem + L::CTX;

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * TJ;
  const int i = blockIdx.y;
  const int b = blockIdx.z;

  for (int e = tid; e < C * A3; e += THREADS) s_wqkv[e] = wqkv[e];
  for (int e = tid; e < A3; e += THREADS) s_bqkv[e] = bqkv[e];
  for (int e = tid; e < A * C; e += THREADS) s_wproj[e] = wproj[e];
  for (int e = tid; e < C; e += THREADS) s_bproj[e] = bproj[e];
  for (int e = tid; e < 2 * C * D; e += THREADS) s_wm[e] = wmerge[e];
  for (int e = tid; e < D; e += THREADS) s_bm[e] = bmerge[e];
  if (tid < NH) s_scale[tid] = scale[tid];
  // 2x2 relative-position bias: s_bias[h][p][q] = table[idx(p, q)][h]
  for (int e = tid; e < NH * 16; e += THREADS) {
    const int h = e / 16, p = (e / 4) % 4, q = e % 4;
    const int idx = ((p >> 1) - (q >> 1) + 1) * 3 + ((p & 1) - (q & 1) + 1);
    s_bias[e] = table[idx * NH + h];
  }
  // rows i-1, i, i+1 and columns j0-1 .. j0+TJ, reflect-mapped
  for (int e = tid; e < NPOS * C; e += THREADS) {
    const int pos = e / C, c = e % C;
    const int gr = reflect(i - 1 + pos / (TJ + 2), wh);
    const int gc = reflect(j0 - 1 + pos % (TJ + 2), ww);
    s_u[e] = to_f(u[(((size_t)b * wh + gr) * ww + gc) * C + c]);
  }
  __syncthreads();

  // q, k, v of every staged position
  for (int e = tid; e < NPOS * A3; e += THREADS) {
    const int pos = e / A3, o = e % A3;
    const float* ur = s_u + pos * C;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc = fmaf(ur[c], s_wqkv[c * A3 + o], acc);
    s_qkv[pos * LQ + o] = acc + s_bqkv[o];
  }
  __syncthreads();

  // per-head L2 normalisation of q (heads 0..NH-1) and k (NH..2NH-1)
  for (int e = tid; e < NPOS * 2 * NH; e += THREADS) {
    float* t = s_qkv + (e / (2 * NH)) * LQ + (e % (2 * NH)) * HD;
    float ss = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) ss = fmaf(t[d], t[d], ss);
    const float inv = 1.f / (sqrtf(ss) + 1e-12f);
#pragma unroll
    for (int d = 0; d < HD; ++d) t[d] *= inv;
  }
  __syncthreads();

  // one (cell, direction, head) per thread: 4x4 scores, softmax, AV, mean
  for (int e = tid; e < TJ * 2 * NH; e += THREADS) {
    const int jj = e / (2 * NH), dir = (e / NH) % 2, h = e % NH;
    if (j0 + jj >= ww) continue;
    const int lc = jj + 1;  // staged column of the cell itself
    const int W2 = TJ + 2;
    int tok[4];
    if (dir == 0) {
      tok[0] = W2 + lc;
      tok[1] = W2 + lc + 1;
      tok[2] = 2 * W2 + lc;
      tok[3] = 2 * W2 + lc + 1;
    } else {
      tok[0] = lc - 1;
      tok[1] = lc;
      tok[2] = W2 + lc - 1;
      tok[3] = W2 + lc;
    }
    const float sc = s_scale[h];
    float acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float* qp = s_qkv + tok[p] * LQ + h * HD;
      float s[4];
      float m = -INFINITY;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* kq = s_qkv + tok[q] * LQ + A + h * HD;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot = fmaf(qp[d], kq[d], dot);
        s[q] = dot * sc + s_bias[h * 16 + p * 4 + q];
        m = fmaxf(m, s[q]);
      }
      float z = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s[q] = expf(s[q] - m);
        z += s[q];
      }
      const float iz = 1.f / z;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* vq = s_qkv + tok[q] * LQ + 2 * A + h * HD;
        const float a = s[q] * iz;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(a, vq[d], acc[d]);
      }
    }
    float* mo = s_mean + (jj * 2 + dir) * A + h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) mo[d] = acc[d] * 0.25f;
  }
  __syncthreads();

  // output projection of each direction's mean token: [A] @ [A, C] + b
  for (int e = tid; e < TJ * 2 * C; e += THREADS) {
    const int jj = e / (2 * C), r = e % (2 * C), c = r % C;
    if (j0 + jj >= ww) continue;
    const float* mv = s_mean + (jj * 2 + r / C) * A;
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < A; ++a) acc = fmaf(mv[a], s_wproj[a * C + c], acc);
    s_ctx[jj * 2 * C + r] = acc + s_bproj[c];
  }
  __syncthreads();

  // merge: [ctx_f | ctx_b] @ [2C, D] + b_merge
  for (int e = tid; e < TJ * D; e += THREADS) {
    const int jj = e / D, d = e % D;
    if (j0 + jj >= ww) continue;
    const float* cx = s_ctx + jj * 2 * C;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < 2 * C; ++k) acc = fmaf(cx[k], s_wm[k * D + d], acc);
    store(out + (((size_t)b * wh + i) * ww + j0 + jj) * D + d, acc + s_bm[d]);
  }
}

template <int NH, int HD, typename T>
int launch(const void* u, const void* wqkv, const void* bqkv, const void* scale,
           const void* table, const void* wproj, const void* bproj,
           const void* wmerge, const void* bmerge, void* out, int B, int wh,
           int ww, cudaStream_t stream) {
  const size_t smem = Layout<NH, HD>::FLOATS * sizeof(float);
  auto kern = ngram_context_kernel<NH, HD, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((ww + TJ - 1) / TJ, wh, B);
  kern<<<grid, THREADS, smem, stream>>>(
      (const T*)u, (const float*)wqkv, (const float*)bqkv, (const float*)scale,
      (const float*)table, (const float*)wproj, (const float*)bproj,
      (const float*)wmerge, (const float*)bmerge, (T*)out, wh, ww);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int num_heads, int head_dim, const void* u, const void* wqkv,
             const void* bqkv, const void* scale, const void* table,
             const void* wproj, const void* bproj, const void* wmerge,
             const void* bmerge, void* out, int B, int wh, int ww,
             cudaStream_t stream) {
  if (num_heads == 6 && head_dim == 5)
    return launch<6, 5, T>(u, wqkv, bqkv, scale, table, wproj, bproj, wmerge,
                           bmerge, out, B, wh, ww, stream);
  if (num_heads == 4 && head_dim == 8)
    return launch<4, 8, T>(u, wqkv, bqkv, scale, table, wproj, bproj, wmerge,
                           bmerge, out, B, wh, ww, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// u [B, wh, ww, 32] (float32 or bfloat16, per is_bf16) -> out [B, wh, ww, 64]
// of the same type.  Weights are float32 in the [in, out] layout: wqkv
// [32, 3A], bqkv [3A], scale [nh] = exp(min(logit_scale, ln 100)), table
// [9, nh] (the 2x2 relative-position bias table), wproj [A, 32], bproj [32],
// wmerge [64, 64], bmerge [64].  Requires wh >= 2 and ww >= 2.
// Returns a cudaError_t code (0 on a clean launch).
int tmar_ngram_context(const void* u, const void* wqkv, const void* bqkv,
                       const void* scale, const void* table, const void* wproj,
                       const void* bproj, const void* wmerge,
                       const void* bmerge, void* out, int B, int wh, int ww,
                       int num_heads, int head_dim, int is_bf16,
                       void* stream) {
  if (wh < 2 || ww < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(num_heads, head_dim, u, wqkv, bqkv, scale,
                                   table, wproj, bproj, wmerge, bmerge, out, B,
                                   wh, ww, s);
  return dispatch<float>(num_heads, head_dim, u, wqkv, bqkv, scale, table,
                         wproj, bproj, wmerge, bmerge, out, B, wh, ww, s);
}

const char* tmar_ngram_context_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
