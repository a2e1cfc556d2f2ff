// The CUDA-core generic per-window body of a whole NSTB (N-gram Swin
// Transformer Block), shared by K2 (nstb_map.cu) and K8 (nstb_tokens.cu)
// beside the full-width NGswin's bodies (nstb_window.cuh in float32,
// nstb_window_mma.cuh in bfloat16 on the tensor cores) and the tensor-core
// generic body (nstb_generic_mma.cuh).  It runs float32 at every width but
// the flagship's (the exactness path), and bfloat16 where the tensor-core
// generic body takes no plan (nstb_generic_mma.cuh: `body`, the same rule as
// tmar_torch/ops/envelope.py:nstb_body; a width not a multiple of 8, past 128,
// or weights past the card's shared memory with head_dim or H not a multiple
// of 8).  It computes what those compute, and what the TPU kernels
// tmar/ops/pallas_nstb.py:_nstb_map_kernel and :_nstb_kernel compute at every
// width:
//   x_attn = x + ctx_tok                      (the context of the token's quadrant)
//   a      = proj(softmax(cos(q, k)·scale + rpb + shift mask)·v)
//   y      = x + LN1(a)                       (residual WITHOUT the context)
//   z      = y + LN2(fc2(GELU(fc1(y))))
// and takes the width D, the FFN's hidden width H, the head count, the window
// side ws (N = ws² <= 64 tokens), Q and the shift at run time; head_dim is a
// template on the buckets of the other generic bodies (<= 8, 16, 32: a head's
// query and output rows live in registers).
//
// Rounding.  With T = bfloat16 it rounds exactly where the JAX kernel and the
// plain version (tmar_torch/ops/cuda_nstb.py:nstb_math) round: the context
// quads and the four matrices come in as bf16; x_attn; q_n, k_n and v; P after
// its normalisation; the attention output before the projection; y before
// fc1; the GELU output before fc2; the output.  Biases, LayerNorms, the
// softmax and every statistic are float32.  At float32 nothing is rounded.
// The GELU is gelu.cuh's, the JAX kernels' A&S erf.
//
// Design: a persistent block of 256 threads walks over tiles of whole windows
// (64 / N of them, so one 64-token window, four of 16, seven of 9).  The tile
// lives in shared memory in float32 between the stages, in three regions of
// TR = (64 / N)·N rows padded to an odd length (smem_bytes, which
// tmar_torch/ops/envelope.py:nstb_bytes counts through tmar_nstb_*_smem):
// x then y [TR][D+1]; x_attn, the head outputs, fc2's output [TR][max(D,
// A)+1]; qkv, the projection, the hidden layer [TR][max(3A, H, D)+1].  The
// weights, biases and the relative-position table are read from device memory
// (L2 holds them) through their row strides, never staged.  The products are
// common.cuh's mm_rt on the CUDA cores; the score matrix is never stored: a
// thread owns one (head, query) row and passes three times over its window's
// keys (the row max, the softmax sum, then P·V with P normalised), so the
// softmax keeps its max subtraction.
//
// A `Windows` type for this body has
//   int count, wh, ww, ws;                   windows; the grid of one image; window side
//   __device__ size_t src(int win, int n)    row of token n of window win in x
//   __device__ size_t dst(int win, int n)    row of token n of window win in out

#pragma once

#include "common.cuh"
#include "gelu.cuh"

namespace {
namespace nstb_rt {

// rows of a tile: the whole windows of N tokens that fit in 64 rows (one
// window past 64 tokens, which this body does not take: its count then
// still names what a tile would need)
__host__ __device__ inline int tile_rows(int N) { return (tmar::ROWS / N > 1 ? tmar::ROWS / N : 1) * N; }

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The shared memory, in bytes, of one block at (N, D, A, H).
inline size_t smem_bytes(int N, int D, int A, int H) {
  return (size_t)4 * tile_rows(N) *
         ((D + 1) + (imax(D, A) + 1) + (imax(imax(3 * A, H), D) + 1));
}

template <int HDM, typename T, typename Windows>
__global__ void __launch_bounds__(tmar::THREADS) nstb_generic(
    const T* __restrict__ x, const T* __restrict__ cq,
    const T* __restrict__ wqkv, const float* __restrict__ bqkv,
    const float* __restrict__ scale, const float* __restrict__ table,
    const T* __restrict__ wproj, const float* __restrict__ bproj,
    const float* __restrict__ g1, const float* __restrict__ b1,
    const T* __restrict__ w1, const float* __restrict__ bw1,
    const T* __restrict__ w2, const float* __restrict__ bw2,
    const float* __restrict__ g2, const float* __restrict__ b2,
    T* __restrict__ out, Windows wins, int D, int H, int nh, int hd, int Q, int shift,
    float eps) {
  using tmar::round_as;
  using tmar::to_f;
  constexpr int NT = tmar::THREADS;
  extern __shared__ float smem[];
  const int ws = wins.ws, N = ws * ws, A = nh * hd, A3 = 3 * A, tw = 2 * ws - 1;
  const int LX = D + 1, L1 = imax(D, A) + 1, L2 = imax(imax(A3, H), D) + 1;
  const int WPB = tmar::ROWS / N, TR = WPB * N;
  float* sX = smem;        // x, then y
  float* s1 = sX + TR * LX;  // x_attn, then the head outputs, then fc2's output
  float* s2 = s1 + TR * L1;  // qkv, then the projection, then the hidden layer
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int edge = ws - shift;  // first in-window row/col of the second band
  const int tiles = (wins.count + WPB - 1) / WPB;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int win0 = tile * WPB;
    const int rows = (wins.count - win0 < WPB ? wins.count - win0 : WPB) * N;

    // 1. gather the windows, add the context of each token's quadrant
    for (int e = tid; e < rows * D; e += NT) {
      const int r = e / D, d = e % D, n = r % N, win = win0 + r / N;
      const int quad =
          Q == 1 ? 0 : 2 * (shift > 0 && n / ws >= edge) + (shift > 0 && n % ws >= edge);
      const float xv = to_f(x[wins.src(win, n) * D + d]);
      sX[r * LX + d] = xv;
      s1[r * L1 + d] = round_as<T>(xv + to_f(cq[((size_t)win * Q + quad) * D + d]));
    }
    __syncthreads();

    // 2. qkv = x_attn @ wqkv + bqkv
    tmar::mm_rt(rows, A3, D, [&](int m, int k) { return s1[m * L1 + k]; },
                [&](int k, int n) { return to_f(wqkv[(size_t)k * A3 + n]); },
                [&](int m, int n, float v) { s2[m * L2 + n] = v + __ldg(bqkv + n); });
    __syncthreads();

    // 3. q_n and k_n per head, and v, each rounded to T's values
    for (int e = tid; e < rows * 2 * nh; e += NT) {
      float* t = s2 + (e / (2 * nh)) * L2 + (e % (2 * nh)) * hd;
      float ss = 0.f;
      for (int d = 0; d < hd; ++d) ss = fmaf(t[d], t[d], ss);
      const float inv = 1.f / (sqrtf(ss) + 1e-12f);
      for (int d = 0; d < hd; ++d) t[d] = round_as<T>(t[d] * inv);
    }
    for (int e = tid; e < rows * A; e += NT) {
      float* t = s2 + (e / A) * L2 + 2 * A + e % A;
      *t = round_as<T>(*t);
    }
    __syncthreads();

    // 4. attention, one (head, query) row per thread -> s1 [rows][A], T's values
    for (int e = tid; e < nh * rows; e += NT) {
      const int h = e / rows, r = e % rows, i = r % N, win = win0 + r / N;
      const int place = shift > 0 ? win % (wins.wh * wins.ww) : 0;  // in its image
      const bool mrow = shift > 0 && place / wins.ww == wins.wh - 1;
      const bool mcol = shift > 0 && place % wins.ww == wins.ww - 1;
      const int ri = i / ws, ci = i % ws;
      const bool bri = ri >= edge, bci = ci >= edge;
      float q[HDM], o[HDM];
#pragma unroll
      for (int d = 0; d < HDM; ++d) {
        q[d] = d < hd ? s2[r * L2 + h * hd + d] : 0.f;
        o[d] = 0.f;
      }
      const float sc = __ldg(scale + h);
      const float* kb = s2 + (r - i) * L2 + A + h * hd;  // the window's first key
      auto logit = [&](int j) {
        const float* kj = kb + j * L2;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HDM; ++d)
          if (d < hd) dot = fmaf(q[d], kj[d], dot);
        const int rj = j / ws, cj = j % ws;
        float s = dot * sc + __ldg(table + ((ri - rj + ws - 1) * tw + (ci - cj + ws - 1)) * nh + h);
        if (mrow && bri != (rj >= edge)) s -= 100.f;
        if (mcol && bci != (cj >= edge)) s -= 100.f;
        return s;
      };
      float m = -INFINITY;
      for (int j = 0; j < N; ++j) m = fmaxf(m, logit(j));
      float z = 0.f;
      for (int j = 0; j < N; ++j) z += expf(logit(j) - m);
      for (int j = 0; j < N; ++j) {
        const float p = round_as<T>(expf(logit(j) - m) / z);
        const float* vj = kb + j * L2 + A;
#pragma unroll
        for (int d = 0; d < HDM; ++d)
          if (d < hd) o[d] = fmaf(p, vj[d], o[d]);
      }
#pragma unroll
      for (int d = 0; d < HDM; ++d)
        if (d < hd) s1[r * L1 + h * hd + d] = round_as<T>(o[d]);
    }
    __syncthreads();

    // 5. a = attention out @ wproj + bproj -> s2 [rows][D]
    tmar::mm_rt(rows, D, A, [&](int m, int k) { return s1[m * L1 + k]; },
                [&](int k, int n) { return to_f(wproj[(size_t)k * D + n]); },
                [&](int m, int n, float v) { s2[m * L2 + n] = v + __ldg(bproj + n); });
    __syncthreads();

    // 6. y = x + LN1(a) -> sX, one warp per row
    for (int r = warp; r < rows; r += NT / 32) {
      const float* a = s2 + r * L2;
      const float2 st = tmar::row_stats(D, eps, [&](int c) { return a[c]; });
      for (int c = lane; c < D; c += 32)
        sX[r * LX + c] += (a[c] - st.x) * st.y * __ldg(g1 + c) + __ldg(b1 + c);
    }
    __syncthreads();

    // 7. hidden = T(GELU(T(y) @ w1 + bw1)) -> s2 [rows][H]
    tmar::mm_rt(rows, H, D, [&](int m, int k) { return round_as<T>(sX[m * LX + k]); },
                [&](int k, int n) { return to_f(w1[(size_t)k * H + n]); },
                [&](int m, int n, float v) {
                  s2[m * L2 + n] = round_as<T>(act::gelu(v + __ldg(bw1 + n)));
                });
    __syncthreads();

    // 8. f = hidden @ w2 + bw2 -> s1 [rows][D]
    tmar::mm_rt(rows, D, H, [&](int m, int k) { return s2[m * L2 + k]; },
                [&](int k, int n) { return to_f(w2[(size_t)k * D + n]); },
                [&](int m, int n, float v) { s1[m * L1 + n] = v + __ldg(bw2 + n); });
    __syncthreads();

    // 9. z = y + LN2(f) -> the window's place in the output
    for (int r = warp; r < rows; r += NT / 32) {
      const float* f = s1 + r * L1;
      const float2 st = tmar::row_stats(D, eps, [&](int c) { return f[c]; });
      T* o = out + wins.dst(win0 + r / N, r % N) * D;
      for (int c = lane; c < D; c += 32)
        tmar::store(o + c, sX[r * LX + c] + (f[c] - st.x) * st.y * __ldg(g2 + c) + __ldg(b2 + c));
    }
    __syncthreads();
  }
}

template <int HDM, typename T, typename Windows>
int launch_hd(const void* const* p, void* out, const Windows& wins, int D, int H, int nh,
              int hd, int Q, int shift, float eps, int blocks, cudaStream_t stream) {
  const size_t bytes = smem_bytes(wins.ws * wins.ws, D, nh * hd, H);
  auto kern = nstb_generic<HDM, T, Windows>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, tmar::THREADS, bytes, stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const float*)p[3],
      (const float*)p[4], (const float*)p[5], (const T*)p[6], (const float*)p[7],
      (const float*)p[8], (const float*)p[9], (const T*)p[10], (const float*)p[11],
      (const T*)p[12], (const float*)p[13], (const float*)p[14], (const float*)p[15],
      (T*)out, wins, D, H, nh, hd, Q, shift, eps);
  return (int)cudaGetLastError();
}

// The generic body on `blocks` persistent blocks, on `stream`: head_dim picks
// the register bucket, is_bf16 the I/O type.  p holds the 16 inputs in the
// kernel's order.  Returns a cudaError_t code.
template <typename Windows>
int launch(const void* const* p, void* out, const Windows& wins, int D, int H, int nh, int hd,
           int Q, int shift, float eps, int is_bf16, int blocks, cudaStream_t s) {
  if (blocks < 1 || hd < 1 || hd > 32 || D < 1 || H < 1 || wins.ws < 1 ||
      wins.ws * wins.ws > tmar::ROWS || smem_bytes(wins.ws * wins.ws, D, nh * hd, H) > tmar::MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (hd <= 8) return launch_hd<8, __nv_bfloat16>(p, out, wins, D, H, nh, hd, Q, shift, eps, blocks, s);
    if (hd <= 16) return launch_hd<16, __nv_bfloat16>(p, out, wins, D, H, nh, hd, Q, shift, eps, blocks, s);
    return launch_hd<32, __nv_bfloat16>(p, out, wins, D, H, nh, hd, Q, shift, eps, blocks, s);
  }
  if (hd <= 8) return launch_hd<8, float>(p, out, wins, D, H, nh, hd, Q, shift, eps, blocks, s);
  if (hd <= 16) return launch_hd<16, float>(p, out, wins, D, H, nh, hd, Q, shift, eps, blocks, s);
  return launch_hd<32, float>(p, out, wins, D, H, nh, hd, Q, shift, eps, blocks, s);
}

}  // namespace nstb_rt
}  // namespace
