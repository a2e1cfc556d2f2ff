// Scaled-cosine window attention, forward, in one launch.
//
// Replaces the TPU kernels tmar/ops/pallas_attention.py:_attn_kernel_batched
// (:1143, the 64-token windows) and :_attn_kernel (:1175, the block-diagonal
// kernel of the 4-token n-gram windows), both driven by _fused_forward
// (pallas_call at :357).  They compute one function at two window lengths,
// so this is one kernel templated on (N, D, heads, head_dim).  Plain version:
// tmar_torch/ops/attention.py:window_attention_math.
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
// What bounds it on an H100: operations (about 45 kFLOP per token at N = 64
// against 256 to 512 bytes moved).  Design: a persistent block per SM walks
// over tiles of 64 token rows (one 64-token window, or sixteen 4-token
// windows); both weight matrices sit in shared memory in float32 for the
// whole launch, read through strides so that a transposed view needs no
// copy.  The score matrix is never stored: a thread owns one (head, query)
// row and passes twice over the keys of its window.  Products run on the CUDA
// cores in float32 whatever the I/O type; tensor cores are a later change.

#include "common.cuh"

namespace {

using namespace tmar;

template <int N, int D, int NH, int HD>
struct Geo {
  static constexpr int A = NH * HD;
  static constexpr int A3 = 3 * A;
  static constexpr int WPB = ROWS / N;  // windows per tile
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

  const int tid = threadIdx.x;
  for (int e = tid; e < D * A3; e += THREADS) {
    const int k = e / A3, n = e % A3;
    s_wqkv[k * G::LWQ + n] = wqkv[(size_t)k * wq_k + (size_t)n * wq_n];
  }
  for (int e = tid; e < A * D; e += THREADS) {
    const int k = e / D, n = e % D;
    s_wproj[k * G::LWP + n] = wproj[(size_t)k * wp_k + (size_t)n * wp_n];
  }
  for (int e = tid; e < A3; e += THREADS) s_bqkv[e] = bqkv[e];
  for (int e = tid; e < D; e += THREADS) s_bproj[e] = bproj[e];
  if (tid < NH) s_scale[tid] = scale[tid];
  __syncthreads();

  const long total = (long)nwin * N;  // token rows
  const int tiles = (int)((total + ROWS - 1) / ROWS);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * ROWS;

    // 1. the tile's rows, zero past the end
    for (int e = tid; e < ROWS * D; e += THREADS) {
      const int r = e / D, d = e % D;
      sX[r * LX + d] = row0 + r < total ? to_f(x[(row0 + r) * D + d]) : 0.f;
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
      if (win < nwin) {
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
      for (int d = 0; d < HD; ++d) sO[r * LO + h * HD + d] = o[d];
    }
    __syncthreads();

    // 5. out = o @ wproj + bproj
    {
      float acc[ceil16(ROWS)][ceil16(D)];
      mm_zero<ROWS, D>(acc);
      mm_acc<ROWS, A, D>(acc, sO, LO, 1, s_wproj, G::LWP, 1);
      mm_each<ROWS, D>(acc, [&](int m, int n, float v) {
        if (row0 + m < total) store(out + (row0 + m) * D + n, v + s_bproj[n]);
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

template <typename T>
int dispatch(int N, int nh, int hd, const void* const* p, int wq_k, int wq_n, int wp_k,
             int wp_n, void* out, void* lse, int nwin, int wh, int ww, int blocks,
             cudaStream_t s) {
  if (N == 64 && nh == 6 && hd == 10)
    return launch<64, 64, 6, 10, T>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, blocks, s);
  if (N == 64 && nh == 4 && hd == 16)
    return launch<64, 64, 4, 16, T>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, blocks, s);
  if (N == 4 && nh == 6 && hd == 5)
    return launch<4, 32, 6, 5, T>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, blocks, s);
  if (N == 4 && nh == 4 && hd == 8)
    return launch<4, 32, 4, 8, T>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, blocks, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x [nwin, N, D] (float32 or bfloat16, per is_bf16) -> out of the same shape
// and type, and lse [nwin, nh, N] float32.  (N, D, nh, hd) is one of
// (64, 64, 6, 10), (64, 64, 4, 16), (4, 32, 6, 5), (4, 32, 4, 8).  All
// parameters are float32: wqkv [D, 3A] and wproj [A, D] are read as
// w[k·w_k + n·w_n]; bqkv [3A]; scale [nh] = exp(min(logit_scale, ln 100));
// bias [nh, N, N]; bproj [D]; mrow, mcol [N, N] are read only when wh > 0.
// `blocks` is the number of persistent blocks.  Returns a cudaError_t code.
int tmar_window_attention_fwd(const void* x, const void* wqkv, const void* bqkv,
                              const void* scale, const void* bias, const void* wproj,
                              const void* bproj, const void* mrow, const void* mcol,
                              void* out, void* lse, int nwin, int N, int num_heads,
                              int head_dim, int wq_k, int wq_n, int wp_k, int wp_n,
                              int wh, int ww, int blocks, int is_bf16, void* stream) {
  if (nwin < 1 || blocks < 1 || (wh > 0 && (ww < 1 || nwin % (wh * ww))))
    return (int)cudaErrorInvalidValue;
  const void* p[9] = {x, wqkv, bqkv, scale, bias, wproj, bproj, mrow, mcol};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(N, num_heads, head_dim, p, wq_k, wq_n, wp_k, wp_n, out,
                                   lse, nwin, wh, ww, blocks, s);
  return dispatch<float>(N, num_heads, head_dim, p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin,
                         wh, ww, blocks, s);
}

const char* tmar_window_attention_fwd_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
