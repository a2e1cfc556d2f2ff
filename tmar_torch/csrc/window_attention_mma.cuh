// Shared pieces of the bfloat16 window-attention bodies on Hopper's tensor
// cores: K3's forward (window_attention_fwd.cu) and K4's backward
// (window_attention_bwd.cu), for 64-token windows at D = 64 and the
// full-width NGswin's heads, 6 x 10 and 4 x 16.
//
// Rounding, as tmar/ops/pallas_attention.py rounds at bf16: the weights are
// bf16 (_pack_params :183), x and the qkv product too; the qkv bias, the L2
// norms, the scale, the relative-position bias, the shift mask and the
// softmax stay float32; q_n, k_n and v are rounded before the score and AV
// products (batched_attention_core :1052-1062).  The kernels read the
// float32 parameters and round the matrices while they stage them.
//
// Layout.  One warpgroup (four warps) takes a window; warp w owns token rows
// [16w, 16w + 16), both as queries and as keys.  Per head it computes its
// rows' q, k and v with mma.sync.m16n8k16 from x's A fragments and keeps
// them in registers; the tiles that all four warps read go through shared
// memory.  The weights are staged once per block as bf16, head dim padded to
// HP = 16 with zeros: wqkv as [out][in] = [3·AP][LDX] (B of x·wqkv by
// ldmatrix, of dqkv·wqkvᵀ by ldmatrix.trans), wproj as [a][c] = [AP][LDX]
// (B of o·wproj by ldmatrix.trans, of g·wprojᵀ by ldmatrix).  Scores are
// kept in log2 units (scale and bias times log2(e)) so that each logit costs
// one ex2.

#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int WN = 64;       // tokens per window
constexpr int WD = 64;       // channels
constexpr int HP = 16;       // head dim padded to one k-step
constexpr int LDX = WD + 8;  // bf16 row strides, padded by 16 bytes so that
constexpr int LDK = HP + 8;  // the eight rows of an ldmatrix fall on
constexpr int LDS = WN + 8;  // distinct banks

// Stage wqkv [D, 3A] and wproj [A, D] (float32, read as w[k·w_k + n·w_n])
// as bf16 [3·AP][LDX] and [AP][LDX], and bqkv as float32 [3·AP], zero in the
// head padding.
template <int NH, int HD>
__device__ void stage_attention_weights(__nv_bfloat16* s_wqkv, __nv_bfloat16* s_wproj,
                                        float* s_bqkv, const float* wqkv, int wq_k, int wq_n,
                                        const float* wproj, int wp_k, int wp_n,
                                        const float* bqkv, int tid, int nthreads) {
  constexpr int A = NH * HD, AP = NH * HP, QKV = 3 * AP;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int e = tid; e < QKV * WD; e += nthreads) {
    const int o = e / WD, c = e % WD;
    const int part = o / AP, h = (o % AP) / HP, d = o % HP;
    s_wqkv[o * LDX + c] =
        d < HD ? __float2bfloat16(wqkv[(size_t)c * wq_k + (size_t)(part * A + h * HD + d) * wq_n])
               : zero;
  }
  for (int e = tid; e < AP * WD; e += nthreads) {
    const int c = e / AP, a = e % AP, h = a / HP, d = a % HP;
    s_wproj[a * LDX + c] =
        d < HD ? __float2bfloat16(wproj[(size_t)(h * HD + d) * wp_k + (size_t)c * wp_n]) : zero;
  }
  for (int o = tid; o < QKV; o += nthreads) {
    const int part = o / AP, h = (o % AP) / HP, d = o % HP;
    s_bqkv[o] = d < HD ? bqkv[part * A + h * HD + d] : 0.f;
  }
}

// Start the copies of a contiguous [64, 64] bf16 tile into `slot` [64][LDX],
// 16 bytes a thread of the warpgroup (wtid), without committing them.
__device__ __forceinline__ void copy_tile(__nv_bfloat16* slot, const __nv_bfloat16* src,
                                          int wtid) {
  for (int c = wtid; c < WN * (WD / 8); c += 128) {
    const int n = c / (WD / 8), part = c % (WD / 8);
    cp_async16(slot + n * LDX + part * 8, src + (size_t)n * WD + part * 8);
  }
}

// The A fragments of the warp's 16 rows of a [64][LDX] tile, 4 k-steps.
__device__ __forceinline__ void rows_a(uint32_t (&a)[4][4], const __nv_bfloat16* tile, int warp,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) load_a(a[kk], tile, LDX, 16 * warp, 16 * kk, lane);
}

// q, k and v of head h for the warp's 16 rows, bias added: tile 2·part +
// half holds padded columns part·AP + h·HP + 8·half.
template <int NH>
__device__ __forceinline__ void head_qkv(float (&acc)[6][4], const uint32_t (&xa)[4][4],
                                         const __nv_bfloat16* s_wqkv, const float* s_bqkv, int h,
                                         int lane) {
  constexpr int AP = NH * HP;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 6; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int p = 0; p < 3; ++p)
      mma_pair(acc[2 * p], acc[2 * p + 1], xa[kk], s_wqkv, LDX, p * AP + h * HP, 16 * kk, lane);
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float* bq = s_bqkv + (j >> 1) * AP + h * HP + (j & 1) * 8 + 2 * t;
    acc[j][0] += bq[0], acc[j][1] += bq[1], acc[j][2] += bq[0], acc[j][3] += bq[1];
  }
}

// In place, the rows of the 16-column block (lo, hi) divided by their L2
// norm plus 1e-12; inv[0] and inv[1] receive 1 / (|row| + 1e-12) of rows g
// and g + 8.
__device__ __forceinline__ void normalize_rows(float (&lo)[4], float (&hi)[4], float (&inv)[2]) {
  const float s0 = lo[0] * lo[0] + lo[1] * lo[1] + hi[0] * hi[0] + hi[1] * hi[1];
  const float s1 = lo[2] * lo[2] + lo[3] * lo[3] + hi[2] * hi[2] + hi[3] * hi[3];
  inv[0] = 1.f / (sqrtf(quad_sum(s0)) + 1e-12f);
  inv[1] = 1.f / (sqrtf(quad_sum(s1)) + 1e-12f);
  lo[0] *= inv[0], lo[1] *= inv[0], hi[0] *= inv[0], hi[1] *= inv[0];
  lo[2] *= inv[1], lo[3] *= inv[1], hi[2] *= inv[1], hi[3] *= inv[1];
}

// Rows r0 = 16·warp + g and r0 + 8 of a 16-column block, as bf16, into a
// [64][LDK] tile.
__device__ __forceinline__ void store_rows(__nv_bfloat16* tile, const float (&lo)[4],
                                           const float (&hi)[4], int r0, int t) {
  sts32(tile + r0 * LDK + 2 * t, pack_bf16(lo[0], lo[1]));
  sts32(tile + (r0 + 8) * LDK + 2 * t, pack_bf16(lo[2], lo[3]));
  sts32(tile + r0 * LDK + 8 + 2 * t, pack_bf16(hi[0], hi[1]));
  sts32(tile + (r0 + 8) * LDK + 8 + 2 * t, pack_bf16(hi[2], hi[3]));
}

// The cosine block s = q_n·k_nᵀ of the warp's 16 query rows (A fragment qa)
// against all 64 keys (k_n [64][LDK]): tile j holds keys [8j, 8j + 8).
__device__ __forceinline__ void cosines(float (&s)[8][4], const uint32_t (&qa)[4],
                                        const __nv_bfloat16* s_k, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; j += 2) mma_pair(s[j], s[j + 1], qa, s_k, LDK, 8 * j, 0, lane);
}

// In place, cosines to logits in log2 units: s·sc2 + bias2(r, c) (+ the
// shift mask's row and column components, times log2(e), where the window's
// gates say).  bias2(r, c) returns the float2 at (r, c), (r, c + 1) in log2
// units; r0 = 16·warp + g.
template <typename Bias2>
__device__ __forceinline__ void to_logits2(float (&s)[8][4], float sc2, Bias2 bias2,
                                           const float* __restrict__ mrow,
                                           const float* __restrict__ mcol, bool gr, bool gc,
                                           int r0, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 b0 = bias2(r0, c), b1 = bias2(r0 + 8, c);
    s[j][0] = fmaf(s[j][0], sc2, b0.x), s[j][1] = fmaf(s[j][1], sc2, b0.y);
    s[j][2] = fmaf(s[j][2], sc2, b1.x), s[j][3] = fmaf(s[j][3], sc2, b1.y);
  }
  if (gr || gc) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      float2 m0 = make_float2(0.f, 0.f), m1 = m0;
      if (gr) {
        const float2 a0 = __ldg(reinterpret_cast<const float2*>(mrow + r0 * WN + c));
        const float2 a1 = __ldg(reinterpret_cast<const float2*>(mrow + (r0 + 8) * WN + c));
        m0.x += a0.x, m0.y += a0.y, m1.x += a1.x, m1.y += a1.y;
      }
      if (gc) {
        const float2 a0 = __ldg(reinterpret_cast<const float2*>(mcol + r0 * WN + c));
        const float2 a1 = __ldg(reinterpret_cast<const float2*>(mcol + (r0 + 8) * WN + c));
        m0.x += a0.x, m0.y += a0.y, m1.x += a1.x, m1.y += a1.y;
      }
      s[j][0] = fmaf(m0.x, LOG2E, s[j][0]), s[j][1] = fmaf(m0.y, LOG2E, s[j][1]);
      s[j][2] = fmaf(m1.x, LOG2E, s[j][2]), s[j][3] = fmaf(m1.y, LOG2E, s[j][3]);
    }
  }
}

// The window's place w = win mod (wh·ww) in its image gates the shift mask:
// its row component on the last window row, its column component on the
// last window column (wh = 0: no mask).
__device__ __forceinline__ void mask_gates(int win, int wh, int ww, bool& gr, bool& gc) {
  const int w = wh > 0 ? win % (wh * ww) : 0;
  gr = wh > 0 && w / ww == wh - 1;
  gc = wh > 0 && w % ww == ww - 1;
}

}  // namespace
