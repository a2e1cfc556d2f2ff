// N-gram context of one NSTB, in one launch.
//
// Replaces the TPU kernel tmar/ops/pallas_ngram.py:_ngram_stripe_kernel
// (:813, driven by _forward, pallas_call at :306).  Plain versions:
// tmar_torch/ops/cuda_ngram.py:ngram_context_kernel_math (at float32 the
// same function as ngram_context_math).
//
// Input is the unigram grid u [B, wh, ww, C]; output the context
// [B, wh, ww, D] (D = 2C in the model).  Per grid cell, for each of the two directions:
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
// by latency and instruction throughput.  There is no sequential grid to
// carry halos from one step to the next as on the TPU, so a block
// recomputes the q/k/v of its tile's halo.  Four bodies, picked by the I/O
// dtype and the geometry alone (ngram_g::body, the rule K7 follows too, and
// tmar_torch/ops/envelope.py:ngram_body):
//   * bfloat16 at the full-width NGswin's C = 32, D = 64, heads 6 x 5 or
//     4 x 8: the tensor-core body (ngram_mma.cuh).  A persistent block
//     stages the weights once, rounded to bf16 from the float32 parameters,
//     then walks tiles of S = 4 grid rows x TJ = 16 cells (2 x 8 on a grid
//     too small to fill the card that way): u of the 6 x 18 staged
//     positions by cp.async (1.7x recompute), q/k/v of them on
//     mma.sync with the per-head norms, the 4-token attention of each
//     (cell, direction, head) on the CUDA cores, then the projection of both
//     directions' mean tokens and the [64, 64] merge on mma.sync.  It rounds
//     where _ngram_stripe_kernel rounds at bf16 (ngram_mma.cuh lists where).
//   * float32 at the same widths and heads: a body templated on the heads
//     (below), one block per 32 cells of a grid row, weights staged in
//     shared memory;
//   * bfloat16 at every other geometry with a plan (C and D multiples of 8
//     up to 128, head_dim <= 32): the tensor-core generic body, the same
//     chain with the widths at run time, built from the steps K7's cells
//     pass recomputes (ngram_generic_mma.cuh: C, D and A padded to 16, the
//     weights rounded to bf16 in the kernel and staged once per persistent
//     block, u by cp.async, q/k/v, the projection and the merge on
//     mma.sync, the per-head norms and the 4-token attention on the CUDA
//     cores, a group of 8 or 4 lanes per (cell, direction, head)).  It
//     rounds where the flagship body rounds.  Its tile is sized to the grid
//     (ngram_g::fwd_tile): 4 x 16 cells where such tiles still give every SM
//     one, else 2 x 8, else 2 x 4, never wider than the grid, so the demo
//     width's 8 x 8 stage-1 grid stages 4 x 6 positions for 8 cells (3x)
//     where a 32-cell row segment staged 3 x 34 (12.75x).  Bound there by
//     the blocks' latency (the parameters' staging, five block barriers a
//     tile), like K7's cells pass;
//   * every other case (float32 at every other geometry, bfloat16 without
//     a plan): the CUDA-core generic body, which takes C, D, the heads and
//     head_dim (any) at run time: one 256-thread block per tj cells of a
//     grid row (tj the most of 32, 16, ..., 1 whose block fits: 32 up to
//     D = 128, 16 at C = 128 with 8 heads of 16, 8 at C = 256), staging
//     the three input rows it needs (3·(tj+2) positions for tj outputs),
//     weights read from device memory; every product in float32 on the
//     CUDA cores, rounding at bfloat16 where ngram_context_kernel_math
//     does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "common.cuh"
#include "ngram_generic_mma.cuh"
#include "ngram_mma.cuh"

namespace {

using namespace tmar;

constexpr int C = 32;        // the tensor-core body's unigram channels (D / 2)
constexpr int D = 64;        // and context channels
constexpr int TJ = 32;       // the templated body's grid cells per block, the generic one's most
constexpr int NPOS = 3 * (TJ + 2);

// sequence-reflect index map of the halo: -1 -> 1, n -> n-2; positions past
// n only feed cells outside the grid and are clamped to stay in bounds
__device__ __forceinline__ int reflect(int r, int n) {
  if (r < 0) return 1;
  if (r == n) return n - 2;
  return r < n ? r : n - 1;
}

// ---- the templated float32 body: the full-width NGswin's widths ------------
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
    const float* __restrict__ bqkv, const float* __restrict__ ls,
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
  if (tid < NH) s_scale[tid] = expf(fminf(ls[tid], ngram::LN100));
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

// ---- the CUDA-core generic body: any (C, D, heads, head_dim) ----------------
// One 256-thread block per tj cells of a grid row stages u of the three
// input rows it needs (3·(tj+2) positions for tj outputs), then q/k/v of
// them, the mean tokens and ctx of its cells in shared memory, sized at
// launch (tmar_torch/ops/envelope.py: ngram_fwd_bytes, ngram_tiles picks
// tj); the weights are read from device memory, rounded to T's values as
// they are read.  A thread of the attention holds a (cell, direction,
// head)'s 16 softmax weights in registers and walks the head's channels one
// at a time, so head_dim bounds no register array.  At bfloat16
// it rounds where ngram_context_kernel_math (and _ngram_stripe_kernel)
// round: v, each square before a head's sum, √n2 + 1e-12 and its
// reciprocal, q_n and k_n, each q·k product before its head's sum, the
// softmax weights, the token mean, ctx and the output; at float32 nowhere.
template <typename T>
__global__ void __launch_bounds__(THREADS) ngram_context_rt(
    const T* __restrict__ u, const float* __restrict__ wqkv, const float* __restrict__ bqkv,
    const float* __restrict__ ls, const float* __restrict__ table,
    const float* __restrict__ wproj, const float* __restrict__ bproj,
    const float* __restrict__ wmerge, const float* __restrict__ bmerge, T* __restrict__ out,
    int wh, int ww, int C, int D, int nh, int hd, int tj) {
  const int A = nh * hd, A3 = 3 * A, LQ = A3 + 1, W2 = tj + 2, NPOS = 3 * W2;
  extern __shared__ float smem[];
  float* s_u = smem;                  // [NPOS][C]
  float* s_qkv = s_u + NPOS * C;      // [NPOS][LQ]: q_n, k_n, v
  float* s_mean = s_qkv + NPOS * LQ;  // [tj][2][A]
  float* s_ctx = s_mean + tj * 2 * A;  // [tj][2][C]
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * tj;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  const int cells = ww - j0 < tj ? ww - j0 : tj;
  auto r = [](float v) { return round_as<T>(v); };

  // rows i-1, i, i+1 and columns j0-1 .. j0+tj, reflect-mapped
  for (int e = tid; e < NPOS * C; e += THREADS) {
    const int pos = e / C, c = e % C;
    const int gr = reflect(i - 1 + pos / W2, wh);
    const int gc = reflect(j0 - 1 + pos % W2, ww);
    s_u[e] = to_f(u[(((size_t)b * wh + gr) * ww + gc) * C + c]);
  }
  __syncthreads();

  // q, k, v of every staged position, v rounded
  mm_rt(NPOS, A3, C, [&](int m, int k) { return s_u[m * C + k]; },
        [&](int k, int n) { return r(__ldg(wqkv + (size_t)k * A3 + n)); },
        [&](int m, int n, float v) {
          v += r(__ldg(bqkv + n));
          s_qkv[m * LQ + n] = n >= 2 * A ? r(v) : v;
        });
  __syncthreads();

  // per-head L2 normalisation of q (heads 0..nh-1) and k (nh..2nh-1)
  for (int e = tid; e < NPOS * 2 * nh; e += THREADS) {
    float* t = s_qkv + (e / (2 * nh)) * LQ + (e % (2 * nh)) * hd;
    float n2 = 0.f;
    for (int d = 0; d < hd; ++d) n2 += r(t[d] * t[d]);
    const float inv = r(1.f / r(sqrtf(n2) + 1e-12f));
    for (int d = 0; d < hd; ++d) t[d] = r(t[d] * inv);
  }
  __syncthreads();

  // one (cell, direction, head) per thread: 4x4 scores, softmax, then the
  // mean token Σ_p Σ_q a_pq·v_q / 4 channel by channel
  for (int e = tid; e < tj * 2 * nh; e += THREADS) {
    const int jj = e / (2 * nh), dir = (e / nh) % 2, h = e % nh;
    float* mo = s_mean + (jj * 2 + dir) * A + h * hd;
    if (jj >= cells) {
      for (int d = 0; d < hd; ++d) mo[d] = 0.f;
      continue;
    }
    const int lc = jj + 1;  // staged column of the cell itself
    int tok[4];
    if (dir == 0) {
      tok[0] = W2 + lc, tok[1] = W2 + lc + 1, tok[2] = 2 * W2 + lc, tok[3] = 2 * W2 + lc + 1;
    } else {
      tok[0] = lc - 1, tok[1] = lc, tok[2] = W2 + lc - 1, tok[3] = W2 + lc;
    }
    const float sc = expf(fminf(__ldg(ls + h), ngram::LN100));
    float a[16];  // T(softmax weight) of query p, key q at a[4p + q]
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float* qp = s_qkv + tok[p] * LQ + h * hd;
      float s[4];
      float m = -INFINITY;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* kq = s_qkv + tok[q] * LQ + A + h * hd;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += r(qp[d] * kq[d]);
        // the 2x2 relative-position bias of (p, q), from the [9, nh] table
        const int idx = ((p >> 1) - (q >> 1) + 1) * 3 + ((p & 1) - (q & 1) + 1);
        s[q] = dot * sc + __ldg(table + idx * nh + h);
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
      for (int q = 0; q < 4; ++q) a[4 * p + q] = r(s[q] * iz);
    }
    const float* v = s_qkv + 2 * A + h * hd;
    for (int d = 0; d < hd; ++d) {
      float acc = 0.f;
#pragma unroll
      for (int pq = 0; pq < 16; ++pq) acc = fmaf(a[pq], v[tok[pq & 3] * LQ + d], acc);
      mo[d] = r(acc * 0.25f);
    }
  }
  __syncthreads();

  // ctx = T(mean @ T(wproj) + T(bproj)), each direction's mean token
  mm_rt(cells * 2, C, A, [&](int m, int k) { return s_mean[m * A + k]; },
        [&](int k, int n) { return r(__ldg(wproj + (size_t)k * C + n)); },
        [&](int m, int n, float v) { s_ctx[m * C + n] = r(v + r(__ldg(bproj + n))); });
  __syncthreads();

  // merge: [ctx_f | ctx_b] @ T(wmerge) + b_merge
  mm_rt(cells, D, 2 * C, [&](int m, int k) { return s_ctx[m * 2 * C + k]; },
        [&](int k, int n) { return r(__ldg(wmerge + (size_t)k * D + n)); },
        [&](int m, int n, float v) {
          store(out + (((size_t)b * wh + i) * ww + j0 + m) * D + n, v + __ldg(bmerge + n));
        });
}

// ---- the bfloat16 body: tensor cores (ngram_mma.cuh) -----------------------
template <int NH, int HD, int S, int TJ, int WARPS>
struct MmaTile {
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int CELLS = S * TJ;
  static constexpr int PROWS = ngram::ceil16((S + 2) * (TJ + 2));  // staged rows, whole m-tiles
  // byte offsets into shared memory, after the staged weights
  static constexpr int QKV = ngram::Weights<NH>::BYTES;         // bf16 [PROWS][LQKV]
  static constexpr int U = QKV + PROWS * ngram::LQKV * 2;       // bf16 [PROWS][LU]
  static constexpr int SCRATCH = U + PROWS * ngram::LU * 2;     // f32 [WARPS][16][LS]
  // once q/k/v are staged, u and the scratch strips are free: the mean
  // tokens and ctx take their place
  static constexpr int MEAN = U;                                // bf16 [2·CELLS][LU]
  static constexpr int CTX = MEAN + 2 * CELLS * ngram::LU * 2;  // bf16 [CELLS][LM]
  static constexpr int END1 = SCRATCH + WARPS * 16 * ngram::LS * 4;
  static constexpr int END2 = CTX + CELLS * ngram::LM * 2;
  static constexpr int BYTES = END1 > END2 ? END1 : END2;
  static_assert(CELLS % 16 == 0, "whole m-tiles of cells");
  static_assert(BYTES <= 232448, "tile does not fit in shared memory");
};

// out = bf16([ctx_f | ctx_b]·wmerge + bmerge) for the tile's cells
// [m0, m0 + 16), by one warp, stored for the cells inside the grid
template <int TJ>
__device__ __forceinline__ void merge_strip(const __nv_bfloat16* sctx, const ngram::Staged& W,
                                            __nv_bfloat16* __restrict__ out, int m0, int b,
                                            int i0, int j0, int wh, int ww, int lane) {
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < 2 * ngram::C; k0 += 16) {
    uint32_t a[4];
    load_a(a, sctx, ngram::LM, m0, k0, lane);
#pragma unroll
    for (int n = 0; n < 8; n += 2) mma_pair_t(acc[n], acc[n + 1], a, W.wm, ngram::LM, 8 * n, k0, lane);
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int cell = m0 + g + 8 * h;
    const int i = i0 + cell / TJ, j = j0 + cell % TJ;
    if (i >= wh || j >= ww) continue;
    __nv_bfloat16* o = out + (((size_t)b * wh + i) * ww + j) * ngram::D;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * t;
      sts32(o + col, pack_bf16(acc[n][2 * h] + W.bm[col], acc[n][2 * h + 1] + W.bm[col + 1]));
    }
  }
}

template <int NH, int HD, int S, int TJ, int WARPS>
__global__ void __launch_bounds__(32 * WARPS) ngram_context_mma(
    const __nv_bfloat16* __restrict__ u, const float* __restrict__ wqkv,
    const float* __restrict__ bqkv, const float* __restrict__ ls,
    const float* __restrict__ table, const float* __restrict__ wproj,
    const float* __restrict__ bproj, const float* __restrict__ wmerge,
    const float* __restrict__ bmerge, __nv_bfloat16* __restrict__ out, int B, int wh, int ww) {
  using L = MmaTile<NH, HD, S, TJ, WARPS>;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  ngram::stage_weights<NH, HD, L::THREADS>(smem, wqkv, bqkv, ls, table, wproj, bproj, wmerge,
                                           bmerge, tid);
  const ngram::Staged W = ngram::staged<NH>(smem);
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem + L::QKV);
  __nv_bfloat16* su = reinterpret_cast<__nv_bfloat16*>(smem + L::U);
  float* scratch = reinterpret_cast<float*>(smem + L::SCRATCH) + warp * 16 * ngram::LS;
  __nv_bfloat16* smean = reinterpret_cast<__nv_bfloat16*>(smem + L::MEAN);
  __nv_bfloat16* sctx = reinterpret_cast<__nv_bfloat16*>(smem + L::CTX);

  const int rowtiles = (wh + S - 1) / S, coltiles = (ww + TJ - 1) / TJ;
  const int tiles = B * rowtiles * coltiles;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int j0 = (tile % coltiles) * TJ;
    const int i0 = ((tile / coltiles) % rowtiles) * S;
    const int b = tile / (coltiles * rowtiles);
    __syncthreads();  // the weights are staged; the last tile is done with ctx
    ngram::stage_u<S, TJ>(su, u, b, i0, j0, wh, ww, tid, L::THREADS);
    cp_async_wait_all();
    __syncthreads();
    for (int mt = warp; mt < L::PROWS / 16; mt += WARPS)
      ngram::qkv_strip<NH, HD>(su, W, sq, scratch, 16 * mt, lane);
    __syncthreads();
    // one (cell, direction, head) per thread; cells outside the grid read
    // reflect-clamped positions and are computed but never stored
    for (int e = tid; e < L::CELLS * 2 * NH; e += L::THREADS) {
      const int cell = e / (2 * NH), dir = (e / NH) % 2, h = e % NH;
      int tok[4];
      ngram::window_tokens<TJ>(cell / TJ, cell % TJ, dir, tok);
      ngram::Head<NH, HD> head;
      head.run(sq, W, tok, h);
      ngram::store_mean<NH, HD>(smean + (2 * cell + dir) * ngram::LU, head.acc, h);
    }
    __syncthreads();
    for (int mt = warp; mt < 2 * L::CELLS / 16; mt += WARPS)
      ngram::project_strip(smean, W, sctx, 16 * mt, lane);
    __syncthreads();
    for (int mt = warp; mt < L::CELLS / 16; mt += WARPS)
      merge_strip<TJ>(sctx, W, out, 16 * mt, b, i0, j0, wh, ww, lane);
  }
}

template <int NH, int HD, int S, int TJ, int WARPS>
int launch_tile(const void* const* p, void* out, int B, int wh, int ww, int sms,
                cudaStream_t stream) {
  using L = MmaTile<NH, HD, S, TJ, WARPS>;
  auto kern = ngram_context_mma<NH, HD, S, TJ, WARPS>;
  static int per_sm = 0;  // resident blocks per SM, asked once
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           L::BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, L::THREADS, L::BYTES);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const long tiles = (long)B * ((wh + S - 1) / S) * ((ww + TJ - 1) / TJ);
  const int blocks = (int)(tiles < (long)per_sm * sms ? tiles : (long)per_sm * sms);
  kern<<<blocks, L::THREADS, L::BYTES, stream>>>(
      (const __nv_bfloat16*)p[0], (const float*)p[1], (const float*)p[2], (const float*)p[3],
      (const float*)p[4], (const float*)p[5], (const float*)p[6], (const float*)p[7],
      (const float*)p[8], (__nv_bfloat16*)out, B, wh, ww);
  return (int)cudaGetLastError();
}

// Tiles of S = 4 grid rows x TJ = 16 cells (1.7x recompute), 8 warps a
// block; a grid with fewer such tiles than SMs (the 8x128² train step's
// grids, 8x32² at 512²) takes tiles of 2 x 8 cells, four times as many, 4
// warps a block (the faster choices among 4 and 8 warps, 2 x 16, 4 x 16 and
// 4 x 32 cells at those grids on the H100)
template <int NH, int HD>
int launch_mma(const void* const* p, void* out, int B, int wh, int ww, int sms,
               cudaStream_t stream) {
  if (((uintptr_t)p[0] | (uintptr_t)out) & 15) return (int)cudaErrorMisalignedAddress;
  if ((long)B * ((wh + 3) / 4) * ((ww + 15) / 16) >= sms)
    return launch_tile<NH, HD, 4, 16, 8>(p, out, B, wh, ww, sms, stream);
  return launch_tile<NH, HD, 2, 8, 4>(p, out, B, wh, ww, sms, stream);
}

template <int NH, int HD>
int launch_f32(const void* const* p, void* out, int B, int wh, int ww, cudaStream_t stream) {
  const size_t smem = Layout<NH, HD>::FLOATS * sizeof(float);
  auto kern = ngram_context_kernel<NH, HD, float>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((ww + TJ - 1) / TJ, wh, B);
  kern<<<grid, THREADS, smem, stream>>>(
      (const float*)p[0], (const float*)p[1], (const float*)p[2], (const float*)p[3],
      (const float*)p[4], (const float*)p[5], (const float*)p[6], (const float*)p[7],
      (const float*)p[8], (float*)out, wh, ww);
  return (int)cudaGetLastError();
}

// ---- the tensor-core generic body (ngram_generic_mma.cuh) -------------------
// A persistent block of 8 warps walks tiles of F.S grid rows x F.TJ cells;
// the parameters come with its first tile.  Per tile: u of the staged
// positions by cp.async; q/k/v of them on mma.sync (16x16 jobs dealt to the
// warps); the per-head norms; one group of 8 or 4 lanes per (cell,
// direction, head): the softmax and the mean token; ctx = bf16(mean·wproj +
// bproj) and out = bf16([ctx_f | ctx_b]·wm + bmerge) on mma.sync, stored for
// the cells inside the grid (cells past it read reflect-clamped positions
// and are computed but never stored).
__global__ void __launch_bounds__(ngram_g::THREADS1) ngram_context_gmma(
    const __nv_bfloat16* __restrict__ u, const float* __restrict__ wqkv,
    const float* __restrict__ bqkv, const float* __restrict__ ls,
    const float* __restrict__ table, const float* __restrict__ wproj,
    const float* __restrict__ bproj, const float* __restrict__ wmerge,
    const float* __restrict__ bmerge, __nv_bfloat16* __restrict__ out, int B, int wh, int ww,
    ngram_g::FwdPlan F) {
  constexpr int NT = ngram_g::THREADS1, WARPS = ngram_g::WARPS1;
  const ngram_g::Plan& P = F.G;
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  auto bf16_at = [&](int off) { return reinterpret_cast<__nv_bfloat16*>(sm + off); };
  auto f32_at = [&](int off) { return reinterpret_cast<float*>(sm + off); };
  __nv_bfloat16 *s_wqkv = bf16_at(F.c_wqkv), *s_wproj = bf16_at(F.c_wproj), *s_wm = bf16_at(F.c_wm);
  float *s_bqkv = f32_at(F.c_bqkv), *s_bproj = f32_at(F.c_bproj), *s_scale = f32_at(F.c_scale);
  float *s_bias = f32_at(F.c_bias), *s_bm = f32_at(F.c_bm), *s_qk = f32_at(F.c_qk);
  __nv_bfloat16 *s_u = bf16_at(F.c_u), *s_q = bf16_at(F.c_q), *s_mean = bf16_at(F.c_mean);
  __nv_bfloat16* s_ctx = bf16_at(F.c_ctx);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
  const int C_ = P.C, D_ = P.D, nh = P.nh, hd = P.hd, AP = P.AP, TJ_ = F.TJ, W2 = F.W2;

  // once per block: zeros (every padding)
  for (int i = tid; i < (int)(F.bytes / 16); i += NT) ngram_g::zero16(sm + 16 * i);
  const int rowtiles = (wh + F.S - 1) / F.S, coltiles = (ww + TJ_ - 1) / TJ_;
  const int tiles = B * rowtiles * coltiles;
  const int nqc = 3 * AP / 16, ncc = P.CP / 16, ndc = P.DP / 16;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int j0 = (tile % coltiles) * TJ_;
    const int i0 = ((tile / coltiles) % rowtiles) * F.S;
    const int b = tile / (coltiles * rowtiles);
    __syncthreads();  // the zeros are down; the last tile is done with u and ctx
    // 1. u of the tile's positions, rows i0-1 .. i0+S and columns j0-1 ..
    //    j0+TJ, reflect-mapped
    ngram_g::copy_rows(s_u, P.LU, F.NPOS, C_, [&](int pos) -> const __nv_bfloat16* {
      const int gr = ngram::reflect(i0 - 1 + pos / W2, wh), gc = ngram::reflect(j0 - 1 + pos % W2, ww);
      return u + (((size_t)b * wh + gr) * ww + gc) * C_;
    }, tid, NT);
    cp_async_commit();
    if (tile == (int)blockIdx.x)  // the block's first tile: the parameters, while u lands
      ngram_g::stage_params(P, tid, NT, wqkv, bqkv, s_wqkv, s_bqkv, wproj, wmerge, bproj, ls,
                            table, s_wproj, s_wm, s_bproj, s_scale, s_bias, bmerge, s_bm);
    cp_async_wait_all();
    __syncthreads();

    // 2. q/k/v = u·wqkv + bqkv of the staged positions (q, k float32, v bf16)
    for (int job = warp; job < (F.PROWS / 16) * nqc; job += WARPS)
      ngram_g::qkv_job(P, s_u, s_wqkv, s_bqkv, s_q, s_qk, job / nqc, job % nqc, lane);
    __syncthreads();

    // 3. q_n, k_n
    ngram_g::norm_rows(P, s_qk, s_q, F.NPOS, tid, NT);
    __syncthreads();

    // 4. one group of G lanes per (cell, direction, head) (G = 8 where the
    //    tile's items fill the block so, else 4): the softmax, then the mean
    //    token bf16(0.25·Σ_p Σ_q bf16(a_pq)·v_q), the channels d = tg, tg + G,
    //    ... of the group's lane tg
    const int items = F.CELLS * 2 * nh, G = items * 8 <= NT ? 8 : 4, tg = tid & (G - 1);
    for (int base = 0; base < items; base += NT / G) {  // the same trip count in every lane
      const int e = base + tid / G, it = e < items ? e : 0;  // a spare group writes nothing
      const int cell = it / (2 * nh), dir = (it / nh) % 2, h = it % nh;
      const int self = (cell / TJ_ + 1) * W2 + cell % TJ_ + 1, o = dir == 0 ? 0 : -W2 - 1;
      const int tok[4] = {self + o, self + o + 1, self + o + W2, self + o + W2 + 1};
      const __nv_bfloat16* qh[4];  // + AP: k_n, + 2AP: v
#pragma unroll
      for (int p = 0; p < 4; ++p) qh[p] = s_q + tok[p] * P.LQKV + h * hd;
      float cs[16], a[16], ab[16];
      ngram_g::window_softmax(qh, AP, hd, tg, G, s_scale[h], s_bias + h * 16, cs, a, ab);
      for (int d = tg; d < hd; d += G) {
        float vv[4], acc = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) vv[q] = ngram::ld_bf(qh[q] + 2 * AP + d);
#pragma unroll
        for (int pq = 0; pq < 16; ++pq) acc = fmaf(ab[pq], vv[pq & 3], acc);
        if (e < items) s_mean[(2 * cell + dir) * P.LA + h * hd + d] = __float2bfloat16(acc * 0.25f);
      }
    }
    __syncthreads();

    // 5. ctx = bf16(mean·wproj + bproj), both directions of a cell in its row
    for (int job = warp; job < (F.ROWS / 16) * ncc; job += WARPS)
      ngram_g::project_job(P, s_mean, s_wproj, s_bproj, s_ctx, job / ncc, job % ncc, lane);
    __syncthreads();

    // 6. out = bf16([ctx_f | ctx_b]·wm + bmerge) of the cells inside the grid
    for (int job = warp; job < (F.CT / 16) * ndc; job += WARPS) {
      const int mt = job / ndc, nc = job % ndc;
      float acc[2][4] = {};
      for (int kk = 0; kk < 2 * ncc; ++kk) {
        uint32_t a[4];
        load_a(a, s_ctx, P.LCX, 16 * mt, 16 * kk, lane);
        mma_pair_t(acc[0], acc[1], a, s_wm, P.LM, 16 * nc, 16 * kk, lane);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int cell = 16 * mt + gq + 8 * hh;
        const int i = i0 + cell / TJ_, j = j0 + cell % TJ_;
        if (cell >= F.CELLS || i >= wh || j >= ww) continue;
        __nv_bfloat16* orow = out + (((size_t)b * wh + i) * ww + j) * D_;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = 16 * nc + 8 * n + 2 * tq;
          if (col < D_)
            sts32(orow + col, pack_bf16(acc[n][2 * hh] + s_bm[col], acc[n][2 * hh + 1] + s_bm[col + 1]));
        }
      }
    }
  }
}

int launch_gmma(const void* const* p, void* out, int B, int wh, int ww, int C_, int D_, int nh,
                int hd, int sms, cudaStream_t stream) {
  if (((uintptr_t)p[0] | (uintptr_t)out) & 15) return (int)cudaErrorMisalignedAddress;
  const ngram_g::FwdPlan F = ngram_g::fwd_tile(B, wh, ww, C_, D_, nh, hd, sms);
  static int cache[64][3] = {};
  int total = 0;
  const int err = tmar::persistent_grid(ngram_context_gmma, F.bytes, ngram_g::THREADS1, cache, &total);
  if (err != 0) return err;
  const long tiles = (long)B * ((wh + F.S - 1) / F.S) * ((ww + F.TJ - 1) / F.TJ);
  const int blocks = (int)(tiles < total ? tiles : total);
  ngram_context_gmma<<<blocks, ngram_g::THREADS1, F.bytes, stream>>>(
      (const __nv_bfloat16*)p[0], (const float*)p[1], (const float*)p[2], (const float*)p[3],
      (const float*)p[4], (const float*)p[5], (const float*)p[6], (const float*)p[7],
      (const float*)p[8], (__nv_bfloat16*)out, B, wh, ww, F);
  return (int)cudaGetLastError();
}

// ---- the CUDA-core generic body's launch -------------------------------------
// its shared memory on blocks of tj cells, and tj: the most of 32, 16, ..., 1
// whose block fits (tmar_torch/ops/envelope.py: ngram_fwd_bytes and
// ngram_tiles count and pick the same)
size_t rt_bytes(int C_, int nh, int hd, int tj) {
  const size_t A = (size_t)nh * hd, npos = 3 * (tj + 2);
  return 4 * (npos * C_ + npos * (3 * A + 1) + tj * 2 * A + tj * 2 * (size_t)C_);
}
int rt_cells(int C_, int nh, int hd) {
  int tj = TJ;
  while (tj > 1 && rt_bytes(C_, nh, hd, tj) > MAX_SMEM) tj /= 2;
  return tj;
}

template <typename T>
int launch_generic(const void* const* p, void* out, int B, int wh, int ww, int C_, int D_,
                   int nh, int hd, cudaStream_t stream) {
  const int tj = rt_cells(C_, nh, hd);
  const size_t bytes = rt_bytes(C_, nh, hd, tj);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = ngram_context_rt<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((ww + tj - 1) / tj, wh, B);
  kern<<<grid, THREADS, bytes, stream>>>(
      (const T*)p[0], (const float*)p[1], (const float*)p[2], (const float*)p[3],
      (const float*)p[4], (const float*)p[5], (const float*)p[6], (const float*)p[7],
      (const float*)p[8], (T*)out, wh, ww, C_, D_, nh, hd, tj);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// u [B, wh, ww, C] (float32 or bfloat16, per is_bf16) -> out [B, wh, ww, D]
// of the same type.  Weights are float32 in the [in, out] layout, contiguous:
// wqkv [C, 3A], bqkv [3A], logit_scale [nh] (raw: the kernel takes
// exp(min(logit_scale, ln 100))), table [9, nh] (the 2x2 relative-position
// bias table), wproj [A, C], bproj [C], wmerge [2C, D], bmerge [D].
// The body is ngram_g::body's (forward): bfloat16 at C = 32, D = 64 and
// heads 6 x 5 or 4 x 8 the tensor-core body, float32 there the templated
// one; bfloat16 elsewhere the tensor-core generic body wherever it has a
// plan (both tensor-core bodies with u and out 16-byte aligned, on a
// persistent grid of at most `sms` times the blocks an SM holds); every
// other case the CUDA-core generic body (any head_dim; its cells a block
// sized to the card's shared memory).  Requires wh >= 2 and ww >= 2.
// Returns a cudaError_t code (0 on a clean launch).
int tmar_ngram_context(const void* u, const void* wqkv, const void* bqkv,
                       const void* logit_scale, const void* table, const void* wproj,
                       const void* bproj, const void* wmerge, const void* bmerge, void* out,
                       int B, int wh, int ww, int C_, int D_, int num_heads, int head_dim,
                       int is_bf16, int sms, void* stream) {
  if (B < 1 || wh < 2 || ww < 2 || sms < 1 || C_ < 1 || D_ < 1 || num_heads < 1 || head_dim < 1)
    return (int)cudaErrorInvalidValue;
  const void* p[9] = {u, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge, bmerge};
  cudaStream_t s = (cudaStream_t)stream;
  const bool six = num_heads == 6;
  switch (ngram_g::body(C_, D_, num_heads, head_dim, is_bf16, true)) {
    case ngram_g::FLAGSHIP:
      return six ? launch_mma<6, 5>(p, out, B, wh, ww, sms, s)
                 : launch_mma<4, 8>(p, out, B, wh, ww, sms, s);
    case ngram_g::TEMPLATED:
      return six ? launch_f32<6, 5>(p, out, B, wh, ww, s) : launch_f32<4, 8>(p, out, B, wh, ww, s);
    case ngram_g::TENSOR_CORE:
      return launch_gmma(p, out, B, wh, ww, C_, D_, num_heads, head_dim, sms, s);
    default:
      break;
  }
  if (is_bf16)
    return launch_generic<__nv_bfloat16>(p, out, B, wh, ww, C_, D_, num_heads, head_dim, s);
  return launch_generic<float>(p, out, B, wh, ww, C_, D_, num_heads, head_dim, s);
}

// The body (ngram_g::Body, envelope.py: NGRAM_BODIES) that runs this
// geometry at this I/O type: K7's (tmar_ngram_context_bwd_body) but for the
// templated float32 body at the flagship's geometries, which K7 lacks.
int tmar_ngram_context_body(int C_, int D_, int num_heads, int head_dim, int is_bf16) {
  return ngram_g::body(C_, D_, num_heads, head_dim, is_bf16, true);
}

// The shared memory, in bytes, of the CUDA-core generic body's launch, on
// the cells a block it picks (rt_cells).
long long tmar_ngram_context_smem(int C_, int num_heads, int head_dim) {
  return (long long)rt_bytes(C_, num_heads, head_dim, rt_cells(C_, num_heads, head_dim));
}

// The shared memory, in bytes, of the tensor-core generic body on tiles of
// S grid rows x TJ cells (one of ngram_g::FWD_TILES); -1 where the geometry
// takes no plan.
long long tmar_ngram_context_mma_smem(int C_, int D_, int num_heads, int head_dim, int S,
                                      int TJ_) {
  ngram_g::Plan P;
  if (!ngram_g::plan(C_, D_, num_heads, head_dim, &P)) return -1;
  return (long long)ngram_g::make_fwd_plan(C_, D_, num_heads, head_dim, S, TJ_).bytes;
}

// The tile (S · 100 + TJ) the tensor-core generic body takes for this grid
// on `sms` SMs (ngram_g::fwd_tile; envelope.py: ngram_mma_fwd_tile).
int tmar_ngram_context_tile(int B, int wh, int ww, int C_, int D_, int num_heads, int head_dim,
                            int sms) {
  const ngram_g::FwdPlan F = ngram_g::fwd_tile(B, wh, ww, C_, D_, num_heads, head_dim, sms);
  return F.S * 100 + F.TJ;
}

const char* tmar_ngram_context_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
