// The long-window body of a whole NSTB (N-gram Swin Transformer Block),
// shared by K2 (nstb_map.cu) and K8 (nstb_tokens.cu): windows of more than 64
// tokens (past 8x8: HAT's 16x16 is N = 256) and heads wider than 32 channels,
// at either I/O type, which the other bodies (nstb_window*.cuh,
// nstb_generic*.cuh) do not take.  It computes what they compute, and what
// the TPU kernels tmar/ops/pallas_nstb.py:_nstb_map_kernel (:640) and
// :_nstb_kernel (:334) compute at any window:
//   x_attn = x + ctx_tok                      (the context of the token's quadrant)
//   a      = proj(softmax(cos(q, k)·scale + rpb + shift mask)·v)
//   y      = x + LN1(a)                       (residual WITHOUT the context)
//   z      = y + LN2(fc2(GELU(fc1(y))))
// rounding at bf16 where they round (nstb_generic.cuh lists the points).
//
// A window's q/k/v alone is 196,608 bytes at N = 256, A = 64 in float32, so
// no block holds a window.  Four launches meet in a float32 workspace in
// device memory (workspace floats: qkv and the head outputs of every token):
//   1. qkv = x_attn·wqkv + bqkv (attn_long::rows_gemm; x_attn gathered per
//      token from the map or the windows, with its quadrant's context);
//   2. q and k normalised (attn_long::qk_norm);
//   3. the attention (attn_long::attn_fwd, key tiles streamed through shared
//      memory, the relative-position table and the band mask computed per
//      score);
//   4. the tail on tiles of token rows: the projection, y = x + LN1(a), the
//      FFN and LN2, z written to the token's place (nstb_tail below).
// All on the CUDA cores in float32, no atomics.

#pragma once

#include "gelu.cuh"
#include "window_attention_long.cuh"

namespace {
namespace nstb_long {

using attn_long::NT;
using attn_long::odd;

// token rows of a tail tile: the most of 32, 16, ..., 1 that fit a block
inline size_t tail_bytes(int D, int A, int H, int rows) {
  return (size_t)4 * rows * (odd(A) + 2 * odd(D) + odd(H));
}
inline int tail_rows(int D, int A, int H) {
  int r = 32;
  while (r > 1 && tail_bytes(D, A, H, r) > tmar::MAX_SMEM) r /= 2;
  return r;
}

// The largest block of the four launches (tmar_torch/ops/envelope.py:
// nstb_long_bytes counts the same).
inline size_t plan_bytes(int N, int D, int nh, int hd, int H) {
  const int A = nh * hd;
  size_t b = attn_long::gemm_bytes(D, attn_long::gemm_rows(D));
  const size_t f = attn_long::fwd_bytes(N, hd), t = tail_bytes(D, A, H, tail_rows(D, A, H));
  b = f > b ? f : b;
  return t > b ? t : b;
}
inline bool fits(int N, int D, int nh, int hd, int H) {
  return N >= 1 && D >= 1 && nh >= 1 && hd >= 1 && H >= 1 && plan_bytes(N, D, nh, hd, H) <= tmar::MAX_SMEM;
}
inline long long workspace(int nwin, int N, int nh, int hd) {
  return (long long)nwin * N * 4 * nh * hd;
}

// x_attn of token t = win·N + n: x at the token's place plus its quadrant's
// context, rounded to T's values.
template <typename T, typename Windows>
struct XAttn {
  const T* x;
  const T* cq;
  Windows wins;
  int D, Q, shift;
  __device__ __forceinline__ float operator()(long t, int k) const {
    const int ws = wins.ws, N = ws * ws, win = (int)(t / N), n = (int)(t % N), edge = ws - shift;
    const int quad = Q == 1 ? 0 : 2 * (shift > 0 && n / ws >= edge) + (shift > 0 && n % ws >= edge);
    return tmar::round_as<T>(tmar::to_f(x[wins.src(win, n) * D + k]) +
                             tmar::to_f(cq[((size_t)win * Q + quad) * D + k]));
  }
};

// a matrix [in, out] of the I/O type, read in place
template <typename T>
struct MatT {
  const T* w;
  int ld;
  __device__ __forceinline__ float operator()(int k, int n) const {
    return tmar::to_f(w[(size_t)k * ld + n]);
  }
};

// The tail on `rows` token rows a block: a = o·wproj + bproj; y = x + LN1(a);
// h = T(GELU(T(y)·w1 + bw1)); f = h·w2 + bw2; z = y + LN2(f) at the token's
// place in out.
template <typename T, typename Windows>
__global__ void __launch_bounds__(NT) nstb_tail(
    const float* __restrict__ o, const T* __restrict__ x, const T* __restrict__ wproj,
    const float* __restrict__ bproj, const float* __restrict__ g1, const float* __restrict__ b1,
    const T* __restrict__ w1, const float* __restrict__ bw1, const T* __restrict__ w2,
    const float* __restrict__ bw2, const float* __restrict__ g2, const float* __restrict__ b2,
    T* __restrict__ out, Windows wins, long T_, int D, int A, int H, int rows, float eps) {
  using tmar::round_as;
  using tmar::to_f;
  extern __shared__ float sm[];
  const int LA = odd(A), LD = odd(D), LH = odd(H), N = wins.ws * wins.ws;
  float* so = sm;               // the head outputs [rows][LA]
  float* sa = so + rows * LA;   // a, then f [rows][LD]
  float* sy = sa + rows * LD;   // y [rows][LD]
  float* sh = sy + rows * LD;   // the hidden layer [rows][LH]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long t0 = (long)blockIdx.x * rows;
  const int nr = T_ - t0 < rows ? (int)(T_ - t0) : rows;
  for (int e = threadIdx.x; e < nr * A; e += NT) so[(e / A) * LA + e % A] = o[(t0 + e / A) * A + e % A];
  __syncthreads();
  tmar::mm_rt(nr, D, A, [&](int m, int k) { return so[m * LA + k]; },
              [&](int k, int n) { return to_f(wproj[(size_t)k * D + n]); },
              [&](int m, int n, float v) { sa[m * LD + n] = v + __ldg(bproj + n); });
  __syncthreads();
  for (int r = warp; r < nr; r += NT / 32) {
    const float* a = sa + r * LD;
    const long t = t0 + r;
    const T* xr = x + wins.src((int)(t / N), (int)(t % N)) * D;
    const float2 st = tmar::row_stats(D, eps, [&](int c) { return a[c]; });
    for (int c = lane; c < D; c += 32)
      sy[r * LD + c] = to_f(xr[c]) + (a[c] - st.x) * st.y * __ldg(g1 + c) + __ldg(b1 + c);
  }
  __syncthreads();
  tmar::mm_rt(nr, H, D, [&](int m, int k) { return round_as<T>(sy[m * LD + k]); },
              [&](int k, int n) { return to_f(w1[(size_t)k * H + n]); },
              [&](int m, int n, float v) {
                sh[m * LH + n] = round_as<T>(act::gelu(v + __ldg(bw1 + n)));
              });
  __syncthreads();
  tmar::mm_rt(nr, D, H, [&](int m, int k) { return sh[m * LH + k]; },
              [&](int k, int n) { return to_f(w2[(size_t)k * D + n]); },
              [&](int m, int n, float v) { sa[m * LD + n] = v + __ldg(bw2 + n); });
  __syncthreads();
  for (int r = warp; r < nr; r += NT / 32) {
    const float* f = sa + r * LD;
    const long t = t0 + r;
    const float2 st = tmar::row_stats(D, eps, [&](int c) { return f[c]; });
    T* zr = out + wins.dst((int)(t / N), (int)(t % N)) * D;
    for (int c = lane; c < D; c += 32)
      tmar::store(zr + c, sy[r * LD + c] + (f[c] - st.x) * st.y * __ldg(g2 + c) + __ldg(b2 + c));
  }
}

template <typename T, typename Windows>
int launch_t(const void* const* p, void* out, float* ws, const Windows& wins, int D, int H, int nh,
             int hd, int Q, int shift, float eps, cudaStream_t s) {
  const int N = wins.ws * wins.ws, A = nh * hd, L3 = 3 * A;
  const long T_ = (long)wins.count * N;
  float* qkv = ws;
  float* o = ws + (size_t)T_ * L3;
  const XAttn<T, Windows> xa{(const T*)p[0], (const T*)p[1], wins, D, Q, shift};
  int err = attn_long::launch_gemm(T_, D, L3, xa, MatT<T>{(const T*)p[2], L3},
                                   attn_long::Out{qkv, L3, (const float*)p[3]}, s);
  if (!err) err = attn_long::launch_norm(qkv, nullptr, T_, nh, hd, s);
  if (err) return err;
  const attn_long::TableBias bias{(const float*)p[5], wins.ws, nh, shift, wins.wh, wins.ww, 0,
                                  false, false};
  err = attn_long::launch_attn_fwd(qkv, (const float*)p[4], bias, o, nullptr, wins.count, N, nh,
                                   hd, sizeof(T) == 2, sizeof(T) == 2, s);
  if (err) return err;
  const int rows = tail_rows(D, A, H);
  const size_t bytes = tail_bytes(D, A, H, rows);
  auto kern = nstb_tail<T, Windows>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)((T_ + rows - 1) / rows), NT, bytes, s>>>(
      o, (const T*)p[0], (const T*)p[6], (const float*)p[7], (const float*)p[8],
      (const float*)p[9], (const T*)p[10], (const float*)p[11], (const T*)p[12],
      (const float*)p[13], (const float*)p[14], (const float*)p[15], (T*)out, wins, T_, D, A, H,
      rows, eps);
  return (int)cudaGetLastError();
}

// The long-window body, on `stream`: p holds the 16 inputs in the kernels'
// order, the workspace `workspace` floats.  Returns a cudaError_t code.
template <typename Windows>
int launch(const void* const* p, void* out, void* ws, const Windows& wins, int D, int H, int nh,
           int hd, int Q, int shift, float eps, int is_bf16, cudaStream_t s) {
  if (!ws || !fits(wins.ws * wins.ws, D, nh, hd, H)) return (int)cudaErrorInvalidValue;
  return is_bf16 ? launch_t<__nv_bfloat16>(p, out, (float*)ws, wins, D, H, nh, hd, Q, shift, eps, s)
                 : launch_t<float>(p, out, (float*)ws, wins, D, H, nh, hd, Q, shift, eps, s);
}

}  // namespace nstb_long
}  // namespace
