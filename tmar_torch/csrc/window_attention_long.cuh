// The long-window bodies of window attention: K3's (window_attention_fwd.cu)
// and K4's (window_attention_bwd.cu), and the attention core that K2's and
// K8's long-window body shares (nstb_long.cuh).  They take windows of any
// length N and heads of any width, bounded only by the card's shared memory:
// what the other bodies leave out, windows of more than 64 tokens (8x8) and
// head_dim past 32.  They replace there the TPU kernels
// tmar/ops/pallas_attention.py:_attn_kernel_batched (:1143) and
// :_attn_bwd_kernel_batched (:568), which the JAX op runs for every window of
// 32 tokens or more (and :_attn_kernel, :_attn_bwd_kernel below), and the
// attention core of tmar/ops/pallas_nstb.py:_nstb_map_kernel (:640) and
// :_nstb_kernel (:334).
//
// The score matrix of a window does not fit a block (one head's at N = 256
// is 256 KB in float32), so nothing here holds a whole window.  Each body is
// a few launches that meet in a float32 workspace in device memory, which
// the caller allocates (fwd_workspace, bwd_workspace floats):
//   rows_gemm   token rows x a matrix read through its strides (qkv, the
//               projection, K4's g·wprojᵀ and dqkv·wqkvᵀ), a 256-thread block
//               on a tile of rows staged in shared memory;
//   qk_norm     q and k of every token and head L2-normalised in place (and
//               K4's reciprocal norms);
//   attn_fwd    a block per (window, head, 32 query rows): key tiles of 64
//               staged in shared memory; a warp holds 4 query rows and
//               their scores against all N keys in shared memory, so the
//               softmax takes the row max, the sum and P normalised before
//               its rounding, as the JAX kernel and the plain version do,
//               with one pass of dot products; then P·V over value tiles,
//               the lanes over head_dim;
//   K4          attn_bwd_rows: a block per (head, 8 query rows, group of
//               windows) walks its group's windows and owns its rows of
//               the group's dbias share (a fixed-order reduce adds the
//               groups): dq, the head outputs, delta = Σ_j dp·p and its
//               dscale share; attn_bwd_cols: a block per (window,
//               head, 8 key rows): dk and dv from the rows' lse and delta;
//               then dx, the token sums of dwqkv, dbqkv, dwproj and dbproj
//               per block of tokens, and one reduce in a fixed order.
// No atomics: two runs give the same bits.  Everything runs on the CUDA cores
// in float32: the exactness path.  It runs float32 and bf16 windows under 32
// tokens (where the JAX kernel keeps q_n, k_n and P float32); at bf16 from 32
// tokens up the tensor-core long-window bodies of long_mma.cuh run instead
// (attn_mma::body).  What bounds this body on an H100: its own float32
// arithmetic on the CUDA cores (~430x the operations bound at the window-16
// step's stage 1, PERF.md §6), not bytes.
//
// Rounding (T = bfloat16; at float32 every rounding is the identity), as
// tmar_torch/ops/cuda_attention.py:window_attention_kernel_math and
// window_attention_backward_math round: always the two matrices, x, g and
// the merged head outputs before the projection; from 32 tokens up (`rk`,
// _attn_kernel_batched's and _attn_bwd_kernel_batched's with cot_bf16) also
// q_n, k_n, v and P normalised, and every cotangent product's operands.
// The whole NSTB rounds q_n, k_n, v and P at bf16 at every length (rk on).

#pragma once

#include "common.cuh"

namespace {
namespace attn_long {

constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;  // threads of every block here
constexpr int RPW = 4;          // query rows a warp of attn_fwd holds
constexpr int QB = WARPS * RPW; // query rows of an attn_fwd block
constexpr int KT = 64;          // keys (or queries) of a staged tile
constexpr int GROWS = 32;       // token rows of a rows_gemm tile, at most
constexpr int GRB = 8;          // rows a thread of rows_gemm holds (the tile padded to them)
constexpr int SUM_ROWS = 32;    // token rows of a param_sums step, at most

__host__ __device__ inline int odd(int n) { return n | 1; }

// The shared memory, in bytes, of each launch (tmar_torch/ops/envelope.py:
// attention_long_bytes counts the same).
inline size_t gemm_bytes(int K, int rows) {
  return (size_t)4 * ((rows + GRB - 1) / GRB * GRB) * odd(K);
}
// the rows of a rows_gemm tile at inner width K: the most of 32, 16, ..., 1
// whose float32 rows fit 48 KB (so that several blocks share an SM)
inline int gemm_rows(int K) {
  int r = GROWS;
  while (r > 1 && (size_t)4 * r * odd(K) > 49152) r /= 2;
  return r;
}
inline size_t fwd_bytes(int N, int hd) {
  return (size_t)4 * (KT * odd(hd) + QB * (N + 2 * hd));
}
inline size_t rows_bytes(int N, int hd) {
  return (size_t)4 * (2 * KT * odd(hd) + WARPS * (4 * N + 4 * hd));
}
inline size_t cols_bytes(int hd) {
  return (size_t)4 * (2 * KT * odd(hd) + 2 * KT + WARPS * (4 * hd + 2 * KT));
}
inline size_t sums_bytes(int D, int A, int rows) {
  return (size_t)4 * rows * (2 * odd(D) + odd(3 * A) + odd(A));
}
// the token rows of a param_sums step at (D, A): the most of 32, 16, ..., 1
// that fit a block (envelope.py: long_sum_rows)
inline int sum_rows(int D, int A) {
  int r = SUM_ROWS;
  while (r > 1 && sums_bytes(D, A, r) > tmar::MAX_SMEM) r /= 2;
  return r;
}
// the largest block of K3's (bwd false) or K4's launches
inline size_t plan_bytes(int N, int D, int nh, int hd, bool bwd) {
  const int A = nh * hd;
  size_t b = fwd_bytes(N, hd);
  const int ks[2] = {D, A};
  for (int k : ks) b = gemm_bytes(k, gemm_rows(k)) > b ? gemm_bytes(k, gemm_rows(k)) : b;
  if (!bwd) return b;
  const size_t more[4] = {rows_bytes(N, hd), cols_bytes(hd), sums_bytes(D, A, sum_rows(D, A)),
                          gemm_bytes(3 * A, gemm_rows(3 * A))};
  for (size_t m : more) b = m > b ? m : b;
  return b;
}
// Whether the long-window bodies take (N, D, nh, hd): every launch fits a
// block.
inline bool fits(int N, int D, int nh, int hd) {
  return N >= 1 && D >= 1 && nh >= 1 && hd >= 1 && plan_bytes(N, D, nh, hd, true) <= tmar::MAX_SMEM;
}

// ---- the bias and the shift mask of a (window, head) -------------------------

// K3/K4: the gathered bias [nh, N, N] and the mask components m_row, m_col
// [N, N] on the last row / column of each (wh, ww) grid (wh = 0: no mask).
struct DenseBias {
  const float* bias;
  const float* mrow;
  const float* mcol;
  int N, wh, ww;
  const float* b;  // this (window, head)'s rows
  bool gr, gc;
  __device__ __forceinline__ void at(int win, int h) {
    b = bias + (size_t)h * N * N;
    const int place = wh > 0 ? win % (wh * ww) : 0;
    gr = wh > 0 && place / ww == wh - 1;
    gc = wh > 0 && place % ww == ww - 1;
  }
  __device__ __forceinline__ float operator()(int i, int j) const {
    float v = __ldg(b + (size_t)i * N + j);
    if (gr) v += __ldg(mrow + (size_t)i * N + j);
    if (gc) v += __ldg(mcol + (size_t)i * N + j);
    return v;
  }
};

// K2/K8: the relative-position table [(2ws-1)², nh] and the shift mask of
// the bands (ws - shift rows and columns in, -100 where two tokens' bands
// differ), on the last row / column of each (wh, ww) grid.
struct TableBias {
  const float* table;
  int ws, nh, shift, wh, ww;
  int h;
  bool gr, gc;
  __device__ __forceinline__ void at(int win, int head) {
    h = head;
    const int place = shift > 0 ? win % (wh * ww) : 0;
    gr = shift > 0 && place / ww == wh - 1;
    gc = shift > 0 && place % ww == ww - 1;
  }
  __device__ __forceinline__ float operator()(int i, int j) const {
    const int ri = i / ws, ci = i % ws, rj = j / ws, cj = j % ws, edge = ws - shift;
    float v = __ldg(table + ((ri - rj + ws - 1) * (2 * ws - 1) + (ci - cj + ws - 1)) * nh + h);
    if (gr && (ri >= edge) != (rj >= edge)) v -= 100.f;
    if (gc && (ci >= edge) != (cj >= edge)) v -= 100.f;
    return v;
  }
};

__device__ __forceinline__ float rnd(float v, bool on) {
  return on ? tmar::round_as<__nv_bfloat16>(v) : v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- rows x matrix -------------------------------------------------------------

// store(t, n, Σ_k a(t, k) · w(k, n)) for t < T, n < NO: a block of NT
// threads takes `rows` token rows, stages a(t, k) in shared memory (zeros
// past the last row, up to a multiple of GRB), and each thread computes an
// output column n for GRB rows at a time, so that it reads each w(k, n) once
// for them; n runs fastest across threads, so a warp's reads of w fall on
// consecutive n.
template <typename FA, typename FW, typename FS>
__global__ void __launch_bounds__(NT) rows_gemm(long T, int K, int NO, int rows, FA a, FW w,
                                                FS store) {
  extern __shared__ float sa[];
  const int LK = odd(K);
  const long t0 = (long)blockIdx.x * rows;
  const int nr = T - t0 < rows ? (int)(T - t0) : rows;
  const int groups = (nr + GRB - 1) / GRB;
  for (int e = threadIdx.x; e < groups * GRB * K; e += NT)
    sa[(e / K) * LK + e % K] = e / K < nr ? a(t0 + e / K, e % K) : 0.f;
  __syncthreads();
  for (int e = threadIdx.x; e < groups * NO; e += NT) {
    const int n = e % NO, r0 = (e / NO) * GRB;
    const float* ar = sa + r0 * LK;
    float acc[GRB];
#pragma unroll
    for (int i = 0; i < GRB; ++i) acc[i] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float wv = w(k, n);
#pragma unroll
      for (int i = 0; i < GRB; ++i) acc[i] = fmaf(ar[i * LK + k], wv, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < GRB; ++i)
      if (r0 + i < nr) store(t0 + r0 + i, n, acc[i]);
  }
}

template <typename FA, typename FW, typename FS>
int launch_gemm(long T, int K, int NO, FA a, FW w, FS store, cudaStream_t s) {
  const int rows = gemm_rows(K);
  const size_t bytes = gemm_bytes(K, rows);
  auto kern = rows_gemm<FA, FW, FS>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)((T + rows - 1) / rows), NT, bytes, s>>>(T, K, NO, rows, a, w, store);
  return (int)cudaGetLastError();
}

// The operands of rows_gemm.  Rows: p[t·ld + k] in float32, rounded to bf16
// values when rk.  Mat: a float32 matrix w[k·sk + n·sn] rounded to T's
// values (the bodies read the float32 parameters).  Out / OutT: out[t·ld +
// n] = v (+ bias[n]), in float32 or in T.
template <typename T>
struct Rows {
  const T* p;
  int ld;
  bool rk;
  __device__ __forceinline__ float operator()(long t, int k) const {
    return rnd(tmar::to_f(p[t * ld + k]), rk);
  }
};

template <typename T>
struct Mat {
  const float* w;
  long sk, sn;
  __device__ __forceinline__ float operator()(int k, int n) const {
    return tmar::round_as<T>(__ldg(w + k * sk + n * sn));
  }
};

struct Out {
  float* out;
  int ld;
  const float* bias;
  __device__ __forceinline__ void operator()(long t, int n, float v) const {
    out[t * ld + n] = bias ? v + __ldg(bias + n) : v;
  }
};

template <typename T>
struct OutT {
  T* out;
  int ld;
  const float* bias;
  __device__ __forceinline__ void operator()(long t, int n, float v) const {
    tmar::store(out + t * ld + n, bias ? v + __ldg(bias + n) : v);
  }
};

// q and k of token t, head h, normalised in place in qkv [T, 3A] (q at
// column h·hd, k at A + h·hd): x / (|x| + 1e-12); inv [T, 2·nh] (when not
// null) takes the two reciprocal norms.
__global__ void __launch_bounds__(NT) qk_norm(float* __restrict__ qkv, float* __restrict__ inv,
                                              long T, int nh, int hd) {
  const long e = (long)blockIdx.x * NT + threadIdx.x;
  if (e >= T * 2 * nh) return;
  const long t = e / (2 * nh);
  const int u = (int)(e % (2 * nh)), A = nh * hd;
  float* v = qkv + t * 3 * A + (u < nh ? u * hd : A + (u - nh) * hd);
  float ss = 0.f;
  for (int d = 0; d < hd; ++d) ss = fmaf(v[d], v[d], ss);
  const float iv = 1.f / (sqrtf(ss) + 1e-12f);
  for (int d = 0; d < hd; ++d) v[d] *= iv;
  if (inv) inv[t * 2 * nh + u] = iv;
}

inline int launch_norm(float* qkv, float* inv, long T, int nh, int hd, cudaStream_t s) {
  const long n = T * 2 * nh;
  qk_norm<<<(unsigned)((n + NT - 1) / NT), NT, 0, s>>>(qkv, inv, T, nh, hd);
  return (int)cudaGetLastError();
}

// ---- the forward's attention ---------------------------------------------------

// Block (query tile, head, window): qkv [nwin·N, 3A] holds the normalised q
// and k and v; writes o [nwin·N, A] (the head outputs, rounded to bf16
// values when `bf16`) and, when lse is not null, lse [nwin, nh, N] = max +
// log(sum).  P is normalised, then rounded when rk.
template <typename Bias>
__global__ void __launch_bounds__(NT) attn_fwd(const float* __restrict__ qkv,
                                               const float* __restrict__ scale, Bias bias,
                                               float* __restrict__ o, float* __restrict__ lse,
                                               int N, int nh, int hd, bool rk, bool bf16) {
  extern __shared__ float sm[];
  const int LH = odd(hd), A = nh * hd, L3 = 3 * A;
  const int win = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * QB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* st = sm;                                // a key or value tile [KT][LH]
  float* ss = st + KT * LH + warp * RPW * N;     // this warp's scores, then P [RPW][N]
  float* sq = sm + KT * LH + QB * N + warp * RPW * hd;  // its q rows [RPW][hd]
  float* so = sm + KT * LH + QB * N + QB * hd + warp * RPW * hd;  // its outputs [RPW][hd]
  const float* base = qkv + (size_t)win * N * L3;
  bias.at(win, h);
  const float sc = __ldg(scale + h);
  for (int e = lane; e < RPW * hd; e += 32) {
    const int r = e / hd, d = e % hd, i = i0 + warp * RPW + r;
    sq[e] = i < N ? rnd(base[(size_t)i * L3 + h * hd + d], rk) : 0.f;
    so[e] = 0.f;
  }
  // scores against every key tile
  for (int k0 = 0; k0 < N; k0 += KT) {
    const int kt = N - k0 < KT ? N - k0 : KT;
    __syncthreads();
    for (int e = threadIdx.x; e < kt * hd; e += NT)
      st[(e / hd) * LH + e % hd] = rnd(base[(size_t)(k0 + e / hd) * L3 + A + h * hd + e % hd], rk);
    __syncthreads();
    for (int j = lane; j < kt; j += 32) {
      float acc[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) acc[r] = 0.f;
      for (int d = 0; d < hd; ++d) {
        const float kv = st[j * LH + d];
#pragma unroll
        for (int r = 0; r < RPW; ++r) acc[r] = fmaf(sq[r * hd + d], kv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int i = i0 + warp * RPW + r;
        ss[r * N + k0 + j] = i < N ? acc[r] * sc + bias(i, k0 + j) : 0.f;
      }
    }
  }
  __syncwarp();
  // softmax per row: the max, the sum, P normalised (then rounded)
  for (int r = 0; r < RPW; ++r) {
    const int i = i0 + warp * RPW + r;
    float* sr = ss + r * N;
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, sr[j]);
    m = warp_max(m);
    float z = 0.f;
    for (int j = lane; j < N; j += 32) z += expf(sr[j] - m);
    z = tmar::warp_sum(z);
    const float iz = 1.f / z;
    for (int j = lane; j < N; j += 32) sr[j] = rnd(expf(sr[j] - m) * iz, rk);
    if (lse && lane == 0 && i < N) lse[((size_t)win * nh + h) * N + i] = m + logf(z);
  }
  // P·V over value tiles, the lanes over head_dim
  for (int k0 = 0; k0 < N; k0 += KT) {
    const int kt = N - k0 < KT ? N - k0 : KT;
    __syncthreads();
    for (int e = threadIdx.x; e < kt * hd; e += NT)
      st[(e / hd) * LH + e % hd] =
          rnd(base[(size_t)(k0 + e / hd) * L3 + 2 * A + h * hd + e % hd], rk);
    __syncthreads();
    for (int d = lane; d < hd; d += 32) {
      float acc[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) acc[r] = 0.f;
      for (int j = 0; j < kt; ++j) {
        const float vv = st[j * LH + d];
#pragma unroll
        for (int r = 0; r < RPW; ++r) acc[r] = fmaf(ss[r * N + k0 + j], vv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) so[r * hd + d] += acc[r];
    }
  }
  __syncwarp();
  for (int e = lane; e < RPW * hd; e += 32) {
    const int r = e / hd, d = e % hd, i = i0 + warp * RPW + r;
    if (i < N) o[((size_t)win * N + i) * A + h * hd + d] = rnd(so[e], bf16);
  }
}

template <typename Bias>
int launch_attn_fwd(const float* qkv, const float* scale, const Bias& bias, float* o, float* lse,
                    int nwin, int N, int nh, int hd, bool rk, bool bf16, cudaStream_t s) {
  const size_t bytes = fwd_bytes(N, hd);
  auto kern = attn_fwd<Bias>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + QB - 1) / QB, nh, nwin);
  kern<<<grid, NT, bytes, s>>>(qkv, scale, bias, o, lse, N, nh, hd, rk, bf16);
  return (int)cudaGetLastError();
}

// ---- K3 -----------------------------------------------------------------------------

// K3's workspace, in floats: qkv [nwin·N, 3A] and the head outputs [nwin·N, A].
inline long long fwd_workspace(int nwin, int N, int nh, int hd) {
  return (long long)nwin * N * 4 * nh * hd;
}

// K3's long-window body: qkv = x·wqkv + bqkv, q and k normalised, the
// attention, out = o·wproj + bproj.  p as tmar_window_attention_fwd takes
// them; the workspace holds fwd_workspace floats.
template <typename T>
int fwd(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* out, void* lse,
        float* ws, int nwin, int N, int D, int nh, int hd, int wh, int ww, cudaStream_t s) {
  if (!fits(N, D, nh, hd) || !ws) return (int)cudaErrorInvalidValue;
  const T* x = (const T*)p[0];
  const float *wqkv = (const float*)p[1], *bqkv = (const float*)p[2], *wproj = (const float*)p[5],
              *bproj = (const float*)p[6];
  const int A = nh * hd, L3 = 3 * A;
  const long T_ = (long)nwin * N;
  const bool rk = sizeof(T) == 2 && N >= 32;
  float* qkv = ws;
  float* o = ws + (size_t)T_ * L3;
  int err = launch_gemm(T_, D, L3, Rows<T>{x, D, false}, Mat<T>{wqkv, wq_k, wq_n},
                        Out{qkv, L3, bqkv}, s);
  if (!err) err = launch_norm(qkv, nullptr, T_, nh, hd, s);
  if (err) return err;
  const DenseBias bias{(const float*)p[4], (const float*)p[7], (const float*)p[8], N, wh, ww,
                       nullptr, false, false};
  err = launch_attn_fwd(qkv, (const float*)p[3], bias, o, (float*)lse, nwin, N, nh, hd, rk,
                        sizeof(T) == 2, s);
  if (err) return err;
  return launch_gemm(T_, A, D, Rows<float>{o, A, false}, Mat<T>{wproj, wp_k, wp_n},
                     OutT<T>{(T*)out, D, bproj}, s);
}

// ---- K4 -----------------------------------------------------------------------------

// K4's workspace layout, in floats (each region on 4 floats): qkv [T, 3A]
// (normalised q, k, then v), inv [T, 2nh], dacc [T, A], o [T, A], dqkv [T,
// 3A], delta [nwin, nh, N], the rows blocks' dscale shares [nh][RB][G] and
// dbias shares [G][nh][N][N] (G groups of windows), and the token-sum
// partials [P][SUMS] with SUMS = D·3A + 3A + A·D + D.
struct BwdLayout {
  long T;
  int A, RB, G, P, SR, SUMS;
  size_t qkv, inv, dacc, o, dqkv, delta, dsc, dbp, part, total;
};

constexpr int ROWS_BLOCKS = 1056;  // the rows pass's blocks to aim for (8 an SM of 132)

inline size_t up4(size_t n) { return (n + 3) / 4 * 4; }

inline BwdLayout bwd_layout(int nwin, int N, int D, int nh, int hd) {
  BwdLayout L;
  L.T = (long)nwin * N, L.A = nh * hd, L.RB = (N + WARPS - 1) / WARPS;
  const int g = (ROWS_BLOCKS + L.RB * nh - 1) / (L.RB * nh);
  L.G = g < nwin ? g : nwin;
  L.SR = sum_rows(D, L.A);
  const long steps = (L.T + L.SR - 1) / L.SR;
  L.P = (int)(steps < 264 ? steps : 264);
  L.SUMS = D * 3 * L.A + 3 * L.A + L.A * D + D;
  L.qkv = 0;
  L.inv = L.qkv + up4((size_t)L.T * 3 * L.A);
  L.dacc = L.inv + up4((size_t)L.T * 2 * nh);
  L.o = L.dacc + up4((size_t)L.T * L.A);
  L.dqkv = L.o + up4((size_t)L.T * L.A);
  L.delta = L.dqkv + up4((size_t)L.T * 3 * L.A);
  L.dsc = L.delta + up4((size_t)nwin * nh * N);
  L.dbp = L.dsc + up4((size_t)nh * L.RB * L.G);
  L.part = L.dbp + up4((size_t)L.G * nh * N * N);
  L.total = L.part + (size_t)L.P * L.SUMS;
  return L;
}

// Block (query rows [8·bx, 8·bx + 8), head h, window group g): a warp a
// row, over the group's windows.  Per window: the scores, P = exp(s - lse),
// dp = dacc·vᵀ, delta = Σ_j dp·p, ds = P·(dp - delta), dcos = ds·scale;
// into the block's own rows of the group's dbias share the sum of ds over
// its windows and into its dscale share Σ ds·cos; o = P·V, dq from dqn =
// dcos·k_n through the norm.  No other block writes those rows or shares.
template <typename Bias>
__global__ void __launch_bounds__(NT) attn_bwd_rows(
    const float* __restrict__ qkv, const float* __restrict__ inv, const float* __restrict__ dacc,
    const float* __restrict__ lse, const float* __restrict__ scale, Bias bias,
    float* __restrict__ o, float* __restrict__ dqkv, float* __restrict__ delta,
    float* __restrict__ dsc, float* __restrict__ dbp, int nwin, int N, int nh, int hd, bool rk) {
  extern __shared__ float sm[];
  const int LH = odd(hd), A = nh * hd, L3 = 3 * A;
  const int h = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + warp;
  const bool live = i < N;
  float* sk = sm;                    // k_n tile [KT][LH]
  float* sv = sk + KT * LH;          // v tile [KT][LH]
  float* w4 = sv + KT * LH + warp * (4 * N + 4 * hd);
  float* scos = w4;                  // this row's cos [N]
  float* sp = scos + N;              // P, then rk(dcos) [N]
  float* sdp = sp + N;               // dp [N]
  float* sdb = sdp + N;              // its dbias row, summed over windows [N]
  float* sq = sdb + N;               // rk(q_n) [hd]
  float* sda = sq + hd;              // rk(dacc) [hd]
  float* so = sda + hd;              // o [hd]
  float* sdq = so + hd;              // dqn [hd]
  const float sc = __ldg(scale + h);
  for (int j = lane; j < N; j += 32) sdb[j] = 0.f;
  float dscale = 0.f;
  const int per = (nwin + gridDim.z - 1) / gridDim.z, w0 = blockIdx.z * per;
  const int w1 = w0 + per < nwin ? w0 + per : nwin;
  for (int win = w0; win < w1; ++win) {
    const size_t t = (size_t)win * N + (live ? i : 0);
    const float* base = qkv + (size_t)win * N * L3;
    bias.at(win, h);
    const float l = live ? lse[((size_t)win * nh + h) * N + i] : 0.f;
    for (int d = lane; d < hd; d += 32) {
      sq[d] = rnd(qkv[t * L3 + h * hd + d], rk);
      sda[d] = rnd(dacc[t * A + h * hd + d], rk);
      so[d] = 0.f;
      sdq[d] = 0.f;
    }
    // pass 1: cos, P, dp; o += rk(P)·rk(V)
    for (int k0 = 0; k0 < N; k0 += KT) {
      const int kt = N - k0 < KT ? N - k0 : KT;
      __syncthreads();
      for (int e = threadIdx.x; e < kt * hd; e += NT) {
        const size_t r = (size_t)(k0 + e / hd) * L3 + h * hd + e % hd;
        sk[(e / hd) * LH + e % hd] = rnd(base[r + A], rk);
        sv[(e / hd) * LH + e % hd] = rnd(base[r + 2 * A], rk);
      }
      __syncthreads();
      for (int j = lane; j < kt; j += 32) {
        float c = 0.f, dp = 0.f;
        for (int d = 0; d < hd; ++d) {
          c = fmaf(sq[d], sk[j * LH + d], c);
          dp = fmaf(sda[d], sv[j * LH + d], dp);
        }
        scos[k0 + j] = c;
        sp[k0 + j] = live ? expf(c * sc + bias(i, k0 + j) - l) : 0.f;
        sdp[k0 + j] = dp;
      }
      __syncwarp();
      for (int d = lane; d < hd; d += 32) {
        float acc = 0.f;
        for (int j = 0; j < kt; ++j) acc = fmaf(rnd(sp[k0 + j], rk), sv[j * LH + d], acc);
        so[d] += acc;
      }
    }
    __syncwarp();
    float dl = 0.f;
    for (int j = lane; j < N; j += 32) dl = fmaf(sdp[j], sp[j], dl);
    dl = tmar::warp_sum(dl);
    for (int j = lane; j < N; j += 32) {
      const float ds = sp[j] * (sdp[j] - dl);
      sdb[j] += ds;
      dscale = fmaf(ds, scos[j], dscale);
      sp[j] = rnd(ds * sc, rk);
    }
    __syncwarp();
    // pass 2: dqn = rk(dcos)·rk(k_n)
    for (int k0 = 0; k0 < N; k0 += KT) {
      const int kt = N - k0 < KT ? N - k0 : KT;
      __syncthreads();
      for (int e = threadIdx.x; e < kt * hd; e += NT)
        sk[(e / hd) * LH + e % hd] = rnd(base[(size_t)(k0 + e / hd) * L3 + A + h * hd + e % hd], rk);
      __syncthreads();
      for (int d = lane; d < hd; d += 32) {
        float acc = 0.f;
        for (int j = 0; j < kt; ++j) acc = fmaf(sp[k0 + j], sk[j * LH + d], acc);
        sdq[d] += acc;
      }
    }
    __syncwarp();
    if (live) {
      // dq = iq·(dqn - q_n·(dqn·q_n)), q_n unrounded
      const float* qn = qkv + t * L3 + h * hd;
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) dot = fmaf(sdq[d], qn[d], dot);
      dot = tmar::warp_sum(dot);
      const float iq = inv[t * 2 * nh + h];
      for (int d = lane; d < hd; d += 32) {
        dqkv[t * L3 + h * hd + d] = iq * (sdq[d] - qn[d] * dot);
        o[t * A + h * hd + d] = so[d];
      }
      if (lane == 0) delta[((size_t)win * nh + h) * N + i] = dl;
    }
  }
  dscale = tmar::warp_sum(dscale);
  __syncthreads();
  float* red = sk;  // the warps' dscale shares, summed in warp order
  if (lane == 0) red[warp] = dscale;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w];
    dsc[((size_t)h * gridDim.x + blockIdx.x) * gridDim.z + blockIdx.z] = s;
  }
  if (live)
    for (int j = lane; j < N; j += 32) dbp[(((size_t)blockIdx.z * nh + h) * N + i) * N + j] = sdb[j];
}

// Block (key rows [8·bx, 8·bx + 8), head h, window): a warp a key row j;
// query tiles of 64 staged (rk(q_n), rk(dacc), lse, delta): P and ds
// recomputed, dv = Σ_i rk(P)·rk(dacc), dkn = Σ_i rk(dcos)·rk(q_n), dk
// through the norm.
template <typename Bias>
__global__ void __launch_bounds__(NT) attn_bwd_cols(
    const float* __restrict__ qkv, const float* __restrict__ inv, const float* __restrict__ dacc,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ scale, Bias bias, float* __restrict__ dqkv, int N, int nh, int hd,
    bool rk) {
  extern __shared__ float sm[];
  const int LH = odd(hd), A = nh * hd, L3 = 3 * A;
  const int win = blockIdx.z, h = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * WARPS + warp;
  const bool live = j < N;
  float* sq = sm;               // rk(q_n) tile [KT][LH]
  float* sda = sq + KT * LH;    // rk(dacc) tile [KT][LH]
  float* sl = sda + KT * LH;    // lse [KT]
  float* sdl = sl + KT;         // delta [KT]
  float* w4 = sdl + KT + warp * (4 * hd + 2 * KT);
  float* sk = w4;               // rk(k_n_j) [hd]
  float* sv = sk + hd;          // rk(v_j) [hd]
  float* sdk = sv + hd;         // dkn [hd]
  float* sdv = sdk + hd;        // dv [hd]
  float* sp = sdv + hd;         // rk(P) [KT]
  float* sdc = sp + KT;         // rk(dcos) [KT]
  const size_t tw = (size_t)win * N;
  const size_t tj = tw + (live ? j : 0);
  bias.at(win, h);
  const float sc = __ldg(scale + h);
  for (int d = lane; d < hd; d += 32) {
    sk[d] = rnd(qkv[tj * L3 + A + h * hd + d], rk);
    sv[d] = rnd(qkv[tj * L3 + 2 * A + h * hd + d], rk);
    sdk[d] = 0.f;
    sdv[d] = 0.f;
  }
  for (int q0 = 0; q0 < N; q0 += KT) {
    const int qt = N - q0 < KT ? N - q0 : KT;
    __syncthreads();
    for (int e = threadIdx.x; e < qt * hd; e += NT) {
      const size_t t = tw + q0 + e / hd;
      sq[(e / hd) * LH + e % hd] = rnd(qkv[t * L3 + h * hd + e % hd], rk);
      sda[(e / hd) * LH + e % hd] = rnd(dacc[t * A + h * hd + e % hd], rk);
    }
    for (int e = threadIdx.x; e < qt; e += NT) {
      sl[e] = lse[((size_t)win * nh + h) * N + q0 + e];
      sdl[e] = delta[((size_t)win * nh + h) * N + q0 + e];
    }
    __syncthreads();
    for (int ii = lane; ii < qt; ii += 32) {
      float c = 0.f, dp = 0.f;
      for (int d = 0; d < hd; ++d) {
        c = fmaf(sq[ii * LH + d], sk[d], c);
        dp = fmaf(sda[ii * LH + d], sv[d], dp);
      }
      const float p = live ? expf(c * sc + bias(q0 + ii, j) - sl[ii]) : 0.f;
      sp[ii] = rnd(p, rk);
      sdc[ii] = rnd(p * (dp - sdl[ii]) * sc, rk);
    }
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float av = 0.f, ak = 0.f;
      for (int ii = 0; ii < qt; ++ii) {
        av = fmaf(sp[ii], sda[ii * LH + d], av);
        ak = fmaf(sdc[ii], sq[ii * LH + d], ak);
      }
      sdv[d] += av;
      sdk[d] += ak;
    }
    __syncwarp();
  }
  if (!live) return;
  const float* kn = qkv + tj * L3 + A + h * hd;
  float dot = 0.f;
  for (int d = lane; d < hd; d += 32) dot = fmaf(sdk[d], kn[d], dot);
  dot = tmar::warp_sum(dot);
  const float ik = inv[tj * 2 * nh + nh + h];
  for (int d = lane; d < hd; d += 32) {
    dqkv[tj * L3 + A + h * hd + d] = ik * (sdk[d] - kn[d] * dot);
    dqkv[tj * L3 + 2 * A + h * hd + d] = sdv[d];
  }
}

// Block b of P: the token sums of its share of the rows, SR at a time, into
// its own slot part[b] = [dwqkv D·3A | dbqkv 3A | dwproj A·D | dbproj D]:
// dwqkv += rk(x)ᵀ·rk(dqkv), dbqkv += dqkv, dwproj += rk(o)ᵀ·rk(g), dbproj +=
// g.  An element has one owner thread, which adds the steps in order.
template <typename T>
__global__ void __launch_bounds__(NT) param_sums(const T* __restrict__ x, const T* __restrict__ g,
                                                 const float* __restrict__ dqkv,
                                                 const float* __restrict__ o,
                                                 float* __restrict__ part, long T_, int D, int A,
                                                 int SUMS, int SR, bool rk) {
  extern __shared__ float sm[];
  const int L3 = 3 * A, LD = odd(D), LQ = odd(L3), LA = odd(A);
  float* sx = sm;                // rk(x) [SR][LD]
  float* sg = sx + SR * LD;      // g [SR][LD]
  float* sdq = sg + SR * LD;     // dqkv [SR][LQ], unrounded
  float* so = sdq + SR * LQ;     // rk(o) [SR][LA]
  float* slot = part + (size_t)blockIdx.x * SUMS;
  const int E1 = D * L3, E2 = E1 + L3, E3 = E2 + A * D;
  for (int e = threadIdx.x; e < SUMS; e += NT) slot[e] = 0.f;
  const long steps = (T_ + SR - 1) / SR;
  for (long st = blockIdx.x; st < steps; st += gridDim.x) {
    const long t0 = st * SR;
    const int nr = T_ - t0 < SR ? (int)(T_ - t0) : SR;
    __syncthreads();
    for (int e = threadIdx.x; e < nr * D; e += NT) {
      const long t = t0 + e / D;
      sx[(e / D) * LD + e % D] = rnd(tmar::to_f(x[t * D + e % D]), rk);
      sg[(e / D) * LD + e % D] = tmar::to_f(g[t * D + e % D]);
    }
    for (int e = threadIdx.x; e < nr * L3; e += NT)
      sdq[(e / L3) * LQ + e % L3] = dqkv[(t0 + e / L3) * L3 + e % L3];
    for (int e = threadIdx.x; e < nr * A; e += NT)
      so[(e / A) * LA + e % A] = rnd(o[(t0 + e / A) * A + e % A], rk);
    __syncthreads();
    for (int e = threadIdx.x; e < SUMS; e += NT) {
      float acc = 0.f;
      if (e < E1) {
        const int k = e / L3, n = e % L3;
        for (int r = 0; r < nr; ++r) acc = fmaf(sx[r * LD + k], rnd(sdq[r * LQ + n], rk), acc);
      } else if (e < E2) {
        for (int r = 0; r < nr; ++r) acc += sdq[r * LQ + e - E1];
      } else if (e < E3) {
        const int a = (e - E2) / D, n = (e - E2) % D;
        for (int r = 0; r < nr; ++r) acc = fmaf(so[r * LA + a], rnd(sg[r * LD + n], rk), acc);
      } else {
        for (int r = 0; r < nr; ++r) acc += sg[r * LD + e - E3];
      }
      slot[e] += acc;
    }
  }
}

// dparams = [dwqkv | dbqkv | dscale | dbias | dwproj | dbproj]: the token
// sums from the P slots in block order, dscale from the rows blocks'
// shares and dbias from the window groups' shares, in order.
__global__ void __launch_bounds__(NT) bwd_reduce(const float* __restrict__ part,
                                                 const float* __restrict__ dsc,
                                                 const float* __restrict__ dbp,
                                                 float* __restrict__ dparams, int P, int SUMS,
                                                 int D, int A, int nh, int N, int RB, int G) {
  const long e = (long)blockIdx.x * NT + threadIdx.x;
  const long E2 = (long)D * 3 * A + 3 * A;  // dwqkv and dbqkv, then dscale and dbias in dparams
  const long NN = (long)nh * N * N;
  float s = 0.f;
  if (e < SUMS) {
    for (int b = 0; b < P; ++b) s += part[(size_t)b * SUMS + e];
    dparams[e < E2 ? e : e + nh + NN] = s;
  } else if (e < SUMS + nh) {
    const long h = e - SUMS;
    for (int b = 0; b < RB * G; ++b) s += dsc[h * RB * G + b];
    dparams[E2 + h] = s;
  } else if (e < SUMS + nh + NN) {
    const long k = e - SUMS - nh;
    for (int g = 0; g < G; ++g) s += dbp[g * NN + k];
    dparams[E2 + nh + k] = s;
  }
}

inline long long bwd_workspace(int nwin, int N, int D, int nh, int hd) {
  return (long long)bwd_layout(nwin, N, D, nh, hd).total;
}

// K4's long-window body on the forward's operands (p as
// tmar_window_attention_bwd takes them), its lse and g; the workspace holds
// bwd_workspace floats.
template <typename T>
int bwd(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* dx, float* ws,
        float* dparams, int nwin, int N, int D, int nh, int hd, int wh, int ww, cudaStream_t s) {
  if (!fits(N, D, nh, hd) || !ws) return (int)cudaErrorInvalidValue;
  const T *x = (const T*)p[0], *g = (const T*)p[1];
  const float *wqkv = (const float*)p[2], *bqkv = (const float*)p[3], *scale = (const float*)p[4],
              *wproj = (const float*)p[6], *lse = (const float*)p[9];
  const BwdLayout L = bwd_layout(nwin, N, D, nh, hd);
  const int A = L.A, L3 = 3 * A;
  const long T_ = L.T;
  const bool rk = sizeof(T) == 2 && N >= 32;
  float *qkv = ws + L.qkv, *inv = ws + L.inv, *dacc = ws + L.dacc, *o = ws + L.o,
        *dqkv = ws + L.dqkv, *delta = ws + L.delta, *dsc = ws + L.dsc, *dbp = ws + L.dbp,
        *part = ws + L.part;
  // the recompute: qkv, normalised, the reciprocal norms; dacc = g·wprojᵀ
  int err = launch_gemm(T_, D, L3, Rows<T>{x, D, false}, Mat<T>{wqkv, wq_k, wq_n},
                        Out{qkv, L3, bqkv}, s);
  if (!err) err = launch_norm(qkv, inv, T_, nh, hd, s);
  if (!err)
    err = launch_gemm(T_, D, A, Rows<T>{g, D, false}, Mat<T>{wproj, wp_n, wp_k},
                      Out{dacc, A, nullptr}, s);
  if (err) return err;
  const DenseBias bias{(const float*)p[5], (const float*)p[7], (const float*)p[8], N, wh, ww,
                       nullptr, false, false};
  {
    const size_t bytes = rows_bytes(N, hd);
    auto kern = attn_bwd_rows<DenseBias>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3(L.RB, nh, L.G), NT, bytes, s>>>(qkv, inv, dacc, lse, scale, bias, o, dqkv, delta,
                                                dsc, dbp, nwin, N, nh, hd, rk);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  {
    const size_t bytes = cols_bytes(hd);
    auto kern = attn_bwd_cols<DenseBias>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3(L.RB, nh, nwin), NT, bytes, s>>>(qkv, inv, dacc, lse, delta, scale, bias, dqkv, N,
                                                  nh, hd, rk);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  // dx = rk(dqkv)·rk(wqkv)ᵀ
  err = launch_gemm(T_, L3, D, Rows<float>{dqkv, L3, rk}, Mat<T>{wqkv, wq_n, wq_k},
                    OutT<T>{(T*)dx, D, nullptr}, s);
  if (err) return err;
  {
    const size_t bytes = sums_bytes(D, A, L.SR);
    auto kern = param_sums<T>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kern<<<L.P, NT, bytes, s>>>(x, g, dqkv, o, part, T_, D, A, L.SUMS, L.SR, rk);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const long n = L.SUMS + nh + (long)nh * N * N;
  bwd_reduce<<<(unsigned)((n + NT - 1) / NT), NT, 0, s>>>(part, dsc, dbp, dparams, L.P, L.SUMS, D,
                                                          A, nh, N, L.RB, L.G);
  return (int)cudaGetLastError();
}

}  // namespace attn_long
}  // namespace
