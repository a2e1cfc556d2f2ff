// The bf16 tensor-core pieces of the n-gram context that its forward (K1,
// ngram_context.cu) and its backward's recompute (K7's cells pass,
// ngram_context_bwd.cu) share: the weights staged once per block, a tile's
// unigram rows staged by cp.async, q/k/v and their per-head norms on
// mma.sync, the 4-token attention of one (cell, direction, head) on the CUDA
// cores, and the projection of the mean tokens.  They compute what
// tmar/ops/pallas_ngram.py:_ngram_stripe_kernel computes at bf16 and round
// where it rounds: the parameters as tmar/nn/ngram.py:170-176 casts them
// (wqkv, bqkv, wproj, bproj, wmerge; logit_scale, the bias table and
// bmerge stay float32), v (:851), each square before its head's sum (:855),
// √n2 + 1e-12 and its reciprocal (:857), the normalised q and k (:859),
// each q·k product before its head's sum (:904), the softmax weights (:912),
// the token mean (:917) and ctx (:919).
//
// Layout.  A tile is S grid rows x TJ cells; it stages the (S+2) x (TJ+2)
// positions around them (reflect-mapped), row-major, position
// (1 + si + di) * (TJ+2) + 1 + jj + dj for cell (si, jj) and offset (di, dj).
// The attention width A (30 at 6 heads, 32 at 4) is zero-padded to AP = 32
// in every product, so a padded column adds exactly nothing.  bf16 rows are
// padded to a stride of 8 (mod 64) elements, so ldmatrix reads are free of
// bank conflicts.  Weights are kept [in][out] (row-major, as the parameters
// are): the forward products read them through ldmatrix.trans (mma_pair_t),
// the backward's transposed products through plain ldmatrix (mma_pair).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "mma.cuh"

namespace ngram {

constexpr int C = 32;      // unigram channels (D / 2)
constexpr int D = 64;      // context channels
constexpr int AP = 32;     // attention width, zero-padded
constexpr int LU = 40;     // bf16 row stride of u, wproj, mean and dctxc rows [.][32]
constexpr int LQKV = 104;  // bf16 row stride of wqkv and [q | k | v] rows [.][96]
constexpr int LM = 72;     // bf16 row stride of wmerge, g and ctx rows [.][64]
constexpr int LS = 68;     // float row stride of a warp's scratch strip [16][64]
constexpr float LN100 = 4.605170185988091f;  // the logit-scale clip, ln 100

// sequence-reflect index map of the halo: -1 -> 1, n -> n-2; positions past
// n only feed cells outside the grid and are clamped to stay in bounds
__device__ __forceinline__ int reflect(int r, int n) {
  if (r < 0) return 1;
  if (r == n) return n - 2;
  return r < n ? r : n - 1;
}

// v rounded to bf16, back in float32
__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ float ld_bf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

constexpr int ceil16(int n) { return (n + 15) / 16 * 16; }

// The staged weights, byte offsets into the block's shared memory
template <int NH>
struct Weights {
  static constexpr int WQKV = 0;                       // bf16 [C][LQKV]: column blk·AP + a
  static constexpr int WPROJ = WQKV + C * LQKV * 2;    // bf16 [AP][LU], rows >= A zero
  static constexpr int WM = WPROJ + AP * LU * 2;       // bf16 [2C][LM]
  static constexpr int BQKV = WM + 2 * C * LM * 2;     // f32 [3·AP], bf16 values
  static constexpr int BPROJ = BQKV + 3 * AP * 4;      // f32 [C], bf16 values
  static constexpr int BM = BPROJ + C * 4;             // f32 [D]
  static constexpr int SCALE = BM + D * 4;             // f32 [8]: exp(min(ls, ln 100))
  static constexpr int BIAS = SCALE + 8 * 4;           // f32 [NH][16]
  static constexpr int BYTES = BIAS + NH * 16 * 4;
  static_assert(BYTES % 16 == 0, "keep what follows 16-byte aligned");
};

struct Staged {
  const __nv_bfloat16* w;     // wqkv
  const __nv_bfloat16* wp;    // wproj
  const __nv_bfloat16* wm;    // wmerge
  const float* bqkv;
  const float* bproj;
  const float* bm;
  const float* scale;
  const float* bias;
};

template <int NH>
__device__ __forceinline__ Staged staged(unsigned char* smem) {
  using W = Weights<NH>;
  return {reinterpret_cast<const __nv_bfloat16*>(smem + W::WQKV),
          reinterpret_cast<const __nv_bfloat16*>(smem + W::WPROJ),
          reinterpret_cast<const __nv_bfloat16*>(smem + W::WM),
          reinterpret_cast<const float*>(smem + W::BQKV),
          reinterpret_cast<const float*>(smem + W::BPROJ),
          reinterpret_cast<const float*>(smem + W::BM),
          reinterpret_cast<const float*>(smem + W::SCALE),
          reinterpret_cast<const float*>(smem + W::BIAS)};
}

// f(e) for e = tid, tid + NT, ... < N, unrolled, so that the global loads
// of all iterations are in flight together (a block stages its weights
// once, and a loop that waits on each load in turn would take tens of µs)
template <int N, int NT, typename F>
__device__ __forceinline__ void unrolled(int tid, F&& f) {
#pragma unroll
  for (int k = 0; k < (N + NT - 1) / NT; ++k) {
    const int e = tid + k * NT;
    if (N % NT == 0 || e < N) f(e);
  }
}

// wqkv [C, 3A] and bqkv [3A] rounded to bf16 into w [C][LQKV] (column
// blk·AP + a) and b [3·AP] (float32 of the bf16 values), zero-padded
template <int NH, int HD, int NT>
__device__ __forceinline__ void stage_qkv_weights(__nv_bfloat16* w, float* b,
                                                  const float* __restrict__ wqkv,
                                                  const float* __restrict__ bqkv, int tid) {
  constexpr int A = NH * HD;
  unrolled<C * 3 * AP, NT>(tid, [&](int e) {
    const int c = e / (3 * AP), col = e % (3 * AP), a = col % AP;
    w[c * LQKV + col] = __float2bfloat16(a < A ? wqkv[c * 3 * A + (col / AP) * A + a] : 0.f);
  });
  unrolled<3 * AP, NT>(tid, [&](int e) {
    const int a = e % AP;
    b[e] = a < A ? bf(bqkv[(e / AP) * A + a]) : 0.f;
  });
}

// Round the float32 parameters into the block's shared memory (the model's
// casts; bmerge, the scale and the bias table stay float32).  ls is the raw
// logit scale [NH]; table the [9, NH] bias table.
template <int NH, int HD, int NT>
__device__ void stage_weights(unsigned char* smem, const float* __restrict__ wqkv,
                              const float* __restrict__ bqkv, const float* __restrict__ ls,
                              const float* __restrict__ table, const float* __restrict__ wproj,
                              const float* __restrict__ bproj, const float* __restrict__ wmerge,
                              const float* __restrict__ bmerge, int tid) {
  using W = Weights<NH>;
  constexpr int A = NH * HD;
  __nv_bfloat16* wp = reinterpret_cast<__nv_bfloat16*>(smem + W::WPROJ);
  __nv_bfloat16* wm = reinterpret_cast<__nv_bfloat16*>(smem + W::WM);
  float* bp = reinterpret_cast<float*>(smem + W::BPROJ);
  float* bm = reinterpret_cast<float*>(smem + W::BM);
  float* sc = reinterpret_cast<float*>(smem + W::SCALE);
  float* bias = reinterpret_cast<float*>(smem + W::BIAS);
  stage_qkv_weights<NH, HD, NT>(reinterpret_cast<__nv_bfloat16*>(smem + W::WQKV),
                                reinterpret_cast<float*>(smem + W::BQKV), wqkv, bqkv, tid);
  unrolled<AP * C, NT>(tid, [&](int e) {
    const int a = e / C;
    wp[a * LU + e % C] = __float2bfloat16(a < A ? wproj[e] : 0.f);
  });
  unrolled<2 * C * D, NT>(tid, [&](int e) { wm[(e / D) * LM + e % D] = __float2bfloat16(wmerge[e]); });
  unrolled<C, NT>(tid, [&](int e) { bp[e] = bf(bproj[e]); });
  if (bmerge != nullptr)  // the backward has no use for it
    unrolled<D, NT>(tid, [&](int e) { bm[e] = bmerge[e]; });
  if (tid < NH) sc[tid] = expf(fminf(ls[tid], LN100));
  // 2x2 relative-position bias: bias[h][p][q] = table[idx(p, q)][h]
  unrolled<NH * 16, NT>(tid, [&](int e) {
    const int h = e / 16, p = (e / 4) % 4, q = e % 4;
    const int idx = ((p >> 1) - (q >> 1) + 1) * 3 + ((p & 1) - (q & 1) + 1);
    bias[e] = table[idx * NH + h];
  });
}

// The (S+2) x (TJ+2) staged positions of the tile whose first cell is
// (b, i0, j0), by cp.async into su [.][LU] (16-byte chunks; u rows are 64
// bytes).  Commits the group; the caller waits.
template <int S, int TJ>
__device__ __forceinline__ void stage_u(__nv_bfloat16* su, const __nv_bfloat16* __restrict__ u,
                                        int b, int i0, int j0, int wh, int ww, int tid,
                                        int nthreads) {
  constexpr int W2 = TJ + 2;
  for (int e = tid; e < (S + 2) * W2 * 4; e += nthreads) {
    const int pos = e >> 2, ch = e & 3;
    const int gr = reflect(i0 - 1 + pos / W2, wh), gc = reflect(j0 - 1 + pos % W2, ww);
    cp_async16(su + pos * LU + ch * 8, u + (((size_t)b * wh + gr) * ww + gc) * C + ch * 8);
  }
  cp_async_commit();
}

// q, k, v of the 16 staged positions [m0, m0 + 16) on the tensor cores, by
// one warp: v = bf16(u·wv + bv) into sq; q and k (u·w + b in float32) pass
// through the warp's scratch strip and leave normalised per head,
// bf16(t · bf16(1 / bf16(√Σ bf16(t²) + 1e-12))).  sq rows are [q | k | v],
// each AP wide; the padded columns of q and k are not written.
template <int NH, int HD>
__device__ void qkv_strip(const __nv_bfloat16* su, const Staged& W, __nv_bfloat16* sq,
                          float* scratch, int m0, int lane) {
  float acc[12][4];
#pragma unroll
  for (int n = 0; n < 12; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < C; k0 += 16) {
    uint32_t a[4];
    load_a(a, su, LU, m0, k0, lane);
#pragma unroll
    for (int n = 0; n < 12; n += 2) mma_pair_t(acc[n], acc[n + 1], a, W.w, LQKV, 8 * n, k0, lane);
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 12; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h, col = 8 * n + 2 * t;
      const float lo = acc[n][2 * h] + W.bqkv[col], hi = acc[n][2 * h + 1] + W.bqkv[col + 1];
      if (n < 8) {
        scratch[r * LS + col] = lo;
        scratch[r * LS + col + 1] = hi;
      } else {
        sts32(sq + (m0 + r) * LQKV + col, pack_bf16(lo, hi));
      }
    }
  __syncwarp();
  for (int e = lane; e < 16 * 2 * NH; e += 32) {
    const int r = e / (2 * NH), blk = (e / NH) % 2, h = e % NH;
    const float* tv = scratch + r * LS + blk * AP + h * HD;
    float n2 = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) n2 += bf(tv[d] * tv[d]);
    const float inv = bf(1.f / bf(sqrtf(n2) + 1e-12f));
    __nv_bfloat16* o = sq + (m0 + r) * LQKV + blk * AP + h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = __float2bfloat16(tv[d] * inv);
  }
  __syncwarp();
}

// The staged positions of the four tokens p = 2·di + dj of cell (si, jj)'s
// window in direction dir: forward (self, right, down, down-right),
// backward (up-left, up, left, self)
template <int TJ>
__device__ __forceinline__ void window_tokens(int si, int jj, int dir, int (&tok)[4]) {
  constexpr int W2 = TJ + 2;
  const int self = (si + 1) * W2 + jj + 1;
  const int o = dir == 0 ? 0 : -W2 - 1;
  tok[0] = self + o;
  tok[1] = self + o + 1;
  tok[2] = self + o + W2;
  tok[3] = self + o + W2 + 1;
}

// One (cell, direction, head) of the attention, on the CUDA cores: q, k, v
// of the four tokens from sq, then for each query p the scores
// Σ_d bf16(qn_p·kn_q) · scale + bias, a softmax with the row max
// subtracted, a = e · (1 / z) in float32 (cos and a kept for the backward)
// and acc += bf16(a)·v_q.  Returns acc (before the 0.25 of the mean).
template <int NH, int HD>
struct Head {
  float qn[4][HD], kn[4][HD], v[4][HD];
  float cs[16], a[16];
  float acc[HD];

  __device__ __forceinline__ void run(const __nv_bfloat16* sq, const Staged& W, const int (&tok)[4],
                                      int h) {
    constexpr int A = NH * HD;
    (void)A;
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        const __nv_bfloat16* row = sq + tok[p] * LQKV + h * HD + d;
        qn[p][d] = ld_bf(row);
        kn[p][d] = ld_bf(row + AP);
        v[p][d] = ld_bf(row + 2 * AP);
      }
    const float sc = W.scale[h];
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float s[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot += bf(qn[p][d] * kn[q][d]);
        cs[p * 4 + q] = dot;
        s[q] = __fadd_rn(__fmul_rn(dot, sc), W.bias[h * 16 + p * 4 + q]);
      }
      const float m = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
      float e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) e[q] = expf(s[q] - m);
      const float iz = 1.f / (e[0] + e[1] + e[2] + e[3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[p * 4 + q] = e[q] * iz;
        const float ab = bf(a[p * 4 + q]);
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(ab, v[q][d], acc[d]);
      }
    }
  }
};

// Write bf16(0.25·acc) of head h into a mean row [LU]; the head that ends
// the attention width also zeroes the padded columns, which the projection
// reads (times zero rows of wproj)
template <int NH, int HD>
__device__ __forceinline__ void store_mean(__nv_bfloat16* row, const float (&acc)[HD], int h) {
#pragma unroll
  for (int d = 0; d < HD; ++d) row[h * HD + d] = __float2bfloat16(acc[d] * 0.25f);
  if (h == NH - 1)
    for (int a = NH * HD; a < AP; ++a) row[a] = __float2bfloat16(0.f);
}

// ctx = bf16(mean·wproj + bproj) for the 16 mean rows [m0, m0 + 16) (row
// 2·cell + dir), by one warp, into ctx rows [cell][dir·C + c] (stride LM)
__device__ __forceinline__ void project_strip(const __nv_bfloat16* smean, const Staged& W,
                                              __nv_bfloat16* sctx, int m0, int lane) {
  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < AP; k0 += 16) {
    uint32_t a[4];
    load_a(a, smean, LU, m0, k0, lane);
    mma_pair_t(acc[0], acc[1], a, W.wp, LU, 0, k0, lane);
    mma_pair_t(acc[2], acc[3], a, W.wp, LU, 16, k0, lane);
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + g + 8 * h, c = 8 * n + 2 * t;
      sts32(sctx + (row >> 1) * LM + (row & 1) * C + c,
            pack_bf16(acc[n][2 * h] + W.bproj[c], acc[n][2 * h + 1] + W.bproj[c + 1]));
    }
}

}  // namespace ngram
