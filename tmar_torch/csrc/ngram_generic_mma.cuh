// The bf16 generic bodies of the n-gram context on Hopper's tensor cores:
// what the forward (K1, ngram_context.cu: ngram_context_gmma) and the
// backward (K7, ngram_context_bwd.cu: ngram_g's cells and positions passes)
// share.  Both run every bf16 geometry other than the full-width NGswin's
// where `ngram_g::plan` finds a layout (C and D multiples of 8 up to 128,
// head_dim <= 32, what fits a block); `ngram_g::body` is the one rule of both
// (tmar_torch/ops/envelope.py: ngram_body).  C, D and the attention width
// A = nh·hd are padded to 16 (CP, DP, AP) with zeros in the staged weights,
// so a padded row or column adds nothing; the per-head work reads its
// head's hd columns on the CUDA cores.  They round where the flagship
// bodies round (ngram_mma.cuh lists where).
//
// Shared here: K7's slot layout (Slots, which the plan sizes), the rule and
// the plan, the staging (copy_rows, stage_params), and the steps of the
// forward that K1 runs and K7's cells pass recomputes: q/k/v of 16 staged
// positions on mma.sync (qkv_job), the per-head norms (norm_rows), the 4x4
// softmax of one (cell, direction, head) by a group of lanes
// (window_softmax), the projection of the mean tokens (project_job); and
// K1's own tile plan (FwdPlan, fwd_tile).

#pragma once

#include <stdint.h>

#include "common.cuh"
#include "ngram_mma.cuh"

namespace {

// One block's slots of partial sums, the layout of the reduced result and
// its parts: pass 2's sums first, then pass 1's, at runtime widths (C, D,
// nh, hd); the tensor-core body's Geo below is this at C = 32, D = 64.
struct Slots {
  int A, A3, nh, C, D;
  int R_DBQKV, P2SIZE;                                            // pass 2: dwqkv [C][A3], dbqkv
  int Q_DBIAS, Q_DWPROJ, Q_DBPROJ, Q_DWM, Q_DBM, P1SIZE;          // pass 1: dscale [nh] first
  __host__ __device__ Slots(int C_, int D_, int nh_, int hd) : nh(nh_), C(C_), D(D_) {
    A = nh * hd;
    A3 = 3 * A;
    R_DBQKV = C * A3;
    P2SIZE = R_DBQKV + A3;
    Q_DBIAS = nh;                 // [16][nh]
    Q_DWPROJ = Q_DBIAS + 16 * nh;  // [A][C]
    Q_DBPROJ = Q_DWPROJ + A * C;
    Q_DWM = Q_DBPROJ + C;          // [2C][D]
    Q_DBM = Q_DWM + 2 * C * D;
    P1SIZE = Q_DBM + D;
  }
  // the reduced result: dwqkv, dbqkv, dlogit_scale, dtable [9][nh], dwproj,
  // dbproj, dwmerge, dbmerge
  __host__ __device__ int total() const { return P2SIZE + 10 * nh + A * C + C + 2 * C * D + D; }
};

namespace ngram_g {

using namespace tmar;


constexpr int S = 2, TJ = 4, CELLS = S * TJ, ROWS = 2 * CELLS;  // a pass-1 tile
constexpr int W2 = TJ + 2, NPOS = (S + 2) * W2, PROWS = 32;     // staged positions, 2 m-tiles
constexpr int THREADS1 = 256, WARPS1 = THREADS1 / 32;           // pass 1
constexpr int TP = 16, THREADS2 = 256, WARPS2 = THREADS2 / 32;  // pass 2: positions a tile
constexpr int MAXSLOT = 18;  // windows reading one position: 2 directions x 3 x 3
constexpr int GATHER = 4;    // pass 2: (position, column) items a thread gathers at a time
constexpr int MAX_W = 128;   // the widest C and D

// The bodies of K1 and K7 (envelope.py: NGRAM_BODIES, in this order); only
// K1 has a templated one (float32 at the flagship's geometries)
enum Body { FLAGSHIP = 0, TENSOR_CORE = 1, CUDA_CORE = 2, TEMPLATED = 3 };

inline int up(int n, int m) { return (n + m - 1) / m * m; }

// The layout of one call: strides in elements, byte offsets of each region
// (each 16-byte aligned) of the two passes' shared memory.
struct Plan {
  int C, D, nh, hd, A, A3, CP, DP, AP;
  int LU, LQKV, LM, LA, LCX, LQK, LD;
  // pass 1: bf16 wqkv [CP][LQKV] (column blk·AP + a), wproj [AP][LU], wm
  // [2CP][LM] (row dir·CP + c); f32 bqkv [3AP] (bf16 values), bproj [CP]
  // (bf16 values), scale [nh], bias [nh][16]; the tile's bf16 u [PROWS][LU],
  // q_n | k_n | v [PROWS][LQKV], f32 raw q | k [PROWS][LQK], bf16 g [16][LM],
  // f32 dctx [CELLS][2CP], bf16 dctxc [ROWS][LU], f32 dacc [ROWS][AP], bf16
  // mean [ROWS][LA] and ctx [16][LCX], f32 ds [ROWS][16][nh], dscale shares
  // [ROWS][nh]; f32 the block's sums [Slots::P1SIZE]
  int c_wqkv, c_wproj, c_wm, c_bqkv, c_bproj, c_scale, c_bias, c_u, c_q, c_qk, c_g, c_dctx,
      c_dctxc, c_dacc, c_mean, c_ctx, c_ds, c_dsc, c_acc;
  size_t bytes1;
  // pass 2: bf16 wqkv [CP][LQKV], f32 bqkv [3AP]; the tile's bf16 u [TP][LU],
  // f32 raw q | k [TP][LQK], f32 slot sums then dt [TP][LD], bf16 dc
  // [TP][LQKV]; f32 the block's sums [C·A3 + A3]; the slots' offsets
  // [TP][MAXSLOT] (NO_SLOT where a window does not read the position)
  int p_wqkv, p_bqkv, p_u, p_qk, p_d, p_dc, p_acc, p_slot;
  size_t bytes2;
};

inline Plan make_plan(int C, int D, int nh, int hd) {
  Plan P;
  P.C = C, P.D = D, P.nh = nh, P.hd = hd, P.A = nh * hd, P.A3 = 3 * P.A;
  P.CP = up(C, 16), P.DP = up(D, 16), P.AP = up(P.A, 16);
  P.LU = P.CP + 8, P.LQKV = 3 * P.AP + 8, P.LM = P.DP + 8, P.LA = P.AP + 8;
  P.LCX = 2 * P.CP + 8, P.LQK = 2 * P.AP + 4, P.LD = P.A3 + 4;
  const Slots sl(C, D, nh, hd);
  int at = 0;
  auto take = [&](int nbytes) {
    const int off = at;
    at += up(nbytes, 16);
    return off;
  };
  P.c_wqkv = take(2 * P.CP * P.LQKV), P.c_wproj = take(2 * P.AP * P.LU);
  P.c_wm = take(2 * 2 * P.CP * P.LM), P.c_bqkv = take(4 * 3 * P.AP), P.c_bproj = take(4 * P.CP);
  P.c_scale = take(4 * nh), P.c_bias = take(4 * 16 * nh), P.c_u = take(2 * PROWS * P.LU);
  P.c_q = take(2 * PROWS * P.LQKV), P.c_qk = take(4 * PROWS * P.LQK), P.c_g = take(2 * 16 * P.LM);
  P.c_dctx = take(4 * CELLS * 2 * P.CP), P.c_dctxc = take(2 * ROWS * P.LU);
  P.c_dacc = take(4 * ROWS * P.AP), P.c_mean = take(2 * ROWS * P.LA), P.c_ctx = take(2 * 16 * P.LCX);
  P.c_ds = take(4 * ROWS * 16 * nh), P.c_dsc = take(4 * ROWS * nh), P.c_acc = take(4 * sl.P1SIZE);
  P.bytes1 = at;
  at = 0;
  P.p_wqkv = take(2 * P.CP * P.LQKV), P.p_bqkv = take(4 * 3 * P.AP), P.p_u = take(2 * TP * P.LU);
  P.p_qk = take(4 * TP * P.LQK), P.p_d = take(4 * TP * P.LD), P.p_dc = take(2 * TP * P.LQKV);
  P.p_acc = take(4 * sl.P2SIZE), P.p_slot = take(4 * TP * MAXSLOT);
  P.bytes2 = at;
  return P;
}

// The plan at (C, D, heads, head_dim) (envelope.py: ngram_mma_plan counts the
// same), false where the body takes none: C or D not a multiple of 8 (16-byte
// rows for cp.async) or past 128, head_dim past 32, a pass whose shared
// memory fits no block.
inline bool plan(int C, int D, int nh, int hd, Plan* P) {
  if (C < 8 || C > MAX_W || C % 8 || D < 8 || D > MAX_W || D % 8 || nh < 1 || hd < 1 || hd > 32)
    return false;
  *P = make_plan(C, D, nh, hd);
  return P->bytes1 <= MAX_SMEM && P->bytes2 <= MAX_SMEM;
}

// Which body runs a geometry, by geometry and I/O type alone (envelope.py:
// ngram_body): bfloat16 at the full-width NGswin's (C 32, D 64, heads 6 x 5
// or 4 x 8) the flagship bodies, float32 there K1's body templated on the
// heads (`forward`; K7 has none); bfloat16 the tensor-core generic bodies
// wherever both have a plan (K1's smallest tile fits wherever K7's pass 1
// does; asked all the same); the rest (float32, the exactness path, and what
// these bodies do not take) the CUDA-core generic bodies.
inline Body body(int C, int D, int nh, int hd, int is_bf16, bool forward = false);

__device__ __forceinline__ void zero16(void* p) {
  *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
}

// Start the copies of `rows` rows of `cols` bf16 (a multiple of 8) from
// src(r) into dst [.][ld]; rows for which src(r) is null are zeroed.
template <typename F>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, int ld, int rows, int cols, F src,
                                          int tid, int nthreads) {
  const int c8 = cols / 8;
  for (int e = tid; e < rows * c8; e += nthreads) {
    const int r = e / c8, ch = e % c8;
    const __nv_bfloat16* s = src(r);
    if (s != nullptr)
      cp_async16(dst + r * ld + 8 * ch, s + 8 * ch);
    else
      zero16(dst + r * ld + 8 * ch);
  }
}

// Stage the parameters a pass reads, as one range of loads in flight
// together (batched): wqkv [C, 3A] and bqkv [3A] rounded to bf16 into w
// [CP][LQKV] (column blk·AP + a) and b [3AP] (float32 of the bf16 values);
// for pass 1 (wp non-null) also wproj [A, C] into wp [AP][LU], wmerge [2C, D]
// into wm [2CP][LM] (row dir·CP + c) and bproj into bp (bf16 values), the
// scale exp(min(ls, ln 100)) into sc and the bias table as bias[h][p][q] =
// table[idx(p, q)][h]; for the forward (bm non-null) also bmerge [D] into bm,
// float32.
__device__ __forceinline__ void stage_params(
    const Plan& P, int tid, int nthreads, const float* __restrict__ wqkv,
    const float* __restrict__ bqkv, __nv_bfloat16* w, float* b, const float* __restrict__ wproj,
    const float* __restrict__ wmerge, const float* __restrict__ bproj,
    const float* __restrict__ ls, const float* __restrict__ table, __nv_bfloat16* wp,
    __nv_bfloat16* wm, float* bp, float* sc, float* bias, const float* __restrict__ bmerge = nullptr,
    float* bm = nullptr) {
  const int C = P.C, D = P.D, A = P.A, A3 = P.A3, nh = P.nh;
  const int e1 = C * A3, e2 = e1 + A3, e3 = e2 + A * C, e4 = e3 + 2 * C * D, e5 = e4 + C;
  const int e6 = e5 + nh, e7 = e6 + 16 * nh;
  const int total = wp == nullptr ? e2 : bm == nullptr ? e7 : e7 + D;
  batched<4>(total, tid, nthreads, [&](int e) {
    // the address by selects, not branches, so that the loads go out together
    const int k = e - e6, h = k >> 4, p = (k >> 2) & 3, q = k & 3;
    const float* src =
        e < e1 ? wqkv + e : e < e2 ? bqkv + (e - e1) : e < e3 ? wproj + (e - e2)
        : e < e4 ? wmerge + (e - e3) : e < e5 ? bproj + (e - e4) : e < e6 ? ls + (e - e5)
        : e < e7 ? table + (((p >> 1) - (q >> 1) + 1) * 3 + ((p & 1) - (q & 1) + 1)) * nh + h
        : bmerge + (e - e7);
    return __ldg(src);
  }, [&](int e, float v) {
    // one division an element; the q | k | v block of a column by comparisons
    if (e < e2) {
      const int r = e < e1 ? e / A3 : 0, col = e < e1 ? e - r * A3 : e - e1;
      const int blk = (col >= A) + (col >= 2 * A), at = blk * P.AP + col - blk * A;
      if (e < e1)
        w[r * P.LQKV + at] = __float2bfloat16(v);
      else
        b[at] = ngram::bf(v);
    } else if (e < e3) {
      const int r = (e - e2) / C;
      wp[r * P.LU + e - e2 - r * C] = __float2bfloat16(v);
    } else if (e < e4) {
      const int r = (e - e3) / D, dir = r >= C;
      wm[(r + dir * (P.CP - C)) * P.LM + e - e3 - r * D] = __float2bfloat16(v);
    } else if (e < e5) {
      bp[e - e4] = ngram::bf(v);
    } else if (e < e6) {
      sc[e - e5] = expf(fminf(v, ngram::LN100));
    } else if (e < e7) {
      bias[e - e6] = v;
    } else {
      bm[e - e7] = v;
    }
  });
}


// ---- the forward's steps, K1's and K7's cells pass's -------------------------

// One 16x16 job of q/k/v = u·wqkv + bqkv of the staged positions: m-tile mt,
// column chunk nc of [q | k | v] (each AP wide).  q and k go to the float32
// raw rows qk [.][LQK], v rounded to bf16 to q [.][LQKV] (columns 2AP on).
__device__ __forceinline__ void qkv_job(const Plan& P, const __nv_bfloat16* s_u,
                                        const __nv_bfloat16* s_wqkv, const float* s_bqkv,
                                        __nv_bfloat16* s_q, float* s_qk, int mt, int nc, int lane) {
  const int gq = lane >> 2, tq = lane & 3, AP = P.AP;
  float acc[2][4] = {};
  for (int kk = 0; kk < P.CP / 16; ++kk) {
    uint32_t a[4];
    load_a(a, s_u, P.LU, 16 * mt, 16 * kk, lane);
    mma_pair_t(acc[0], acc[1], a, s_wqkv, P.LQKV, 16 * nc, 16 * kk, lane);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + gq + 8 * h, col = 16 * nc + 8 * n + 2 * tq;
      const float lo = acc[n][2 * h] + s_bqkv[col], hi = acc[n][2 * h + 1] + s_bqkv[col + 1];
      if (col >= 2 * AP) {
        sts32(s_q + r * P.LQKV + col, pack_bf16(lo, hi));
      } else {
        s_qk[r * P.LQK + col] = lo;
        s_qk[r * P.LQK + col + 1] = hi;
      }
    }
}

// q_n and k_n of staged rows [0, rows) as the forward rounds them,
// bf16(t · bf16(1 / bf16(√Σ bf16(t²) + 1e-12))), from the raw rows qk into
// q [.][LQKV] (q at column h·hd, k at AP + h·hd), by `nthreads` threads
__device__ __forceinline__ void norm_rows(const Plan& P, const float* s_qk, __nv_bfloat16* s_q,
                                          int rows, int tid, int nthreads) {
  const int nh = P.nh, hd = P.hd;
  for (int e = tid; e < rows * 2 * nh; e += nthreads) {
    const int r = e / (2 * nh), blk = (e / nh) % 2, h = e % nh;
    const float* tv = s_qk + r * P.LQK + blk * P.AP + h * hd;
    float n2 = 0.f;
    for (int d = 0; d < hd; ++d) n2 += ngram::bf(tv[d] * tv[d]);
    const float inv = ngram::bf(1.f / ngram::bf(sqrtf(n2) + 1e-12f));
    __nv_bfloat16* o = s_q + r * P.LQKV + blk * P.AP + h * hd;
    for (int d = 0; d < hd; ++d) o[d] = __float2bfloat16(tv[d] * inv);
  }
}

// v summed over a group of G consecutive lanes (G 4 or 8); every lane of
// the warp takes part
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int o = 1; o < G; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The 4x4 softmax of one (cell, direction, head) by a group of G lanes,
// lane tg of the group taking the head's channels d = tg, tg + G, ...: qh[p]
// is the head's q_n of token p (its k_n at + AP, v at + 2AP).  cs gets the
// cosines Σ_d bf16(q_n·k_n) (whole, after the group's sum), a the softmax
// weights of cs·sc + bias with the row max subtracted, ab = bf16(a).
__device__ __forceinline__ void window_softmax(const __nv_bfloat16* const (&qh)[4], int AP, int hd,
                                               int tg, int G, float sc, const float* bias,
                                               float (&cs)[16], float (&a)[16], float (&ab)[16]) {
#pragma unroll
  for (int pq = 0; pq < 16; ++pq) cs[pq] = 0.f;
  for (int d = tg; d < hd; d += G) {
    float qv[4], kv[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) qv[p] = ngram::ld_bf(qh[p] + d), kv[p] = ngram::ld_bf(qh[p] + AP + d);
#pragma unroll
    for (int pq = 0; pq < 16; ++pq) cs[pq] += ngram::bf(qv[pq >> 2] * kv[pq & 3]);
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float sv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cs[4 * p + q] = group_sum(cs[4 * p + q], G);
      sv[q] = __fadd_rn(__fmul_rn(cs[4 * p + q], sc), bias[p * 4 + q]);
    }
    const float m = fmaxf(fmaxf(sv[0], sv[1]), fmaxf(sv[2], sv[3]));
    float ex[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) ex[q] = expf(sv[q] - m);
    const float iz = 1.f / (ex[0] + ex[1] + ex[2] + ex[3]);
#pragma unroll
    for (int q = 0; q < 4; ++q) a[p * 4 + q] = ex[q] * iz, ab[p * 4 + q] = ngram::bf(a[p * 4 + q]);
  }
}

// One job of ctx = bf16(mean·wproj + bproj): m-tile mt of the mean rows
// (row 2·cell + dir, [.][LA]), column chunk nc of C, into ctx rows
// [cell][dir·CP + c] (stride LCX)
__device__ __forceinline__ void project_job(const Plan& P, const __nv_bfloat16* s_mean,
                                            const __nv_bfloat16* s_wproj, const float* s_bproj,
                                            __nv_bfloat16* s_ctx, int mt, int nc, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  float acc[2][4] = {};
  for (int kk = 0; kk < P.AP / 16; ++kk) {
    uint32_t a[4];
    load_a(a, s_mean, P.LA, 16 * mt, 16 * kk, lane);
    mma_pair_t(acc[0], acc[1], a, s_wproj, P.LU, 16 * nc, 16 * kk, lane);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * mt + gq + 8 * h, c = 16 * nc + 8 * n + 2 * tq;
      sts32(s_ctx + (row >> 1) * P.LCX + (row & 1) * P.CP + c,
            pack_bf16(acc[n][2 * h] + s_bproj[c], acc[n][2 * h + 1] + s_bproj[c + 1]));
    }
}

// ---- K1's tiles ---------------------------------------------------------------

// K1's layout on a tile of S grid rows x TJ cells (CELLS = S·TJ, a multiple
// of 8): pass 1's staged parameters (bf16 wqkv, wproj, wm; float32 bqkv,
// bproj, the scales and the bias table) and float32 bmerge [DP]; bf16 u
// [PROWS][LU] of the tile's (S + 2) x (TJ + 2) positions (PROWS = NPOS up to
// 16), q_n | k_n | v [PROWS][LQKV], float32 raw q | k [PROWS][LQK], bf16 mean
// tokens [ROWS][LA] (row 2·cell + dir) and ctx [CT][LCX] (CT = CELLS up to
// 16).  Byte offsets, each region 16-byte aligned; the strides are G's.
struct FwdPlan {
  Plan G;
  int S, TJ, W2, CELLS, ROWS, NPOS, PROWS, CT;
  int c_wqkv, c_wproj, c_wm, c_bqkv, c_bproj, c_scale, c_bias, c_bm, c_u, c_q, c_qk, c_mean, c_ctx;
  size_t bytes;
};

inline FwdPlan make_fwd_plan(int C, int D, int nh, int hd, int S_, int TJ_) {
  FwdPlan F;
  F.G = make_plan(C, D, nh, hd);
  const Plan& P = F.G;
  F.S = S_, F.TJ = TJ_, F.W2 = TJ_ + 2, F.CELLS = S_ * TJ_, F.ROWS = 2 * F.CELLS;
  F.NPOS = (S_ + 2) * F.W2, F.PROWS = up(F.NPOS, 16), F.CT = up(F.CELLS, 16);
  int at = 0;
  auto take = [&](int nbytes) {
    const int off = at;
    at += up(nbytes, 16);
    return off;
  };
  F.c_wqkv = take(2 * P.CP * P.LQKV), F.c_wproj = take(2 * P.AP * P.LU);
  F.c_wm = take(2 * 2 * P.CP * P.LM), F.c_bqkv = take(4 * 3 * P.AP), F.c_bproj = take(4 * P.CP);
  F.c_scale = take(4 * nh), F.c_bias = take(4 * 16 * nh), F.c_bm = take(4 * P.DP);
  F.c_u = take(2 * F.PROWS * P.LU), F.c_q = take(2 * F.PROWS * P.LQKV);
  F.c_qk = take(4 * F.PROWS * P.LQK), F.c_mean = take(2 * F.ROWS * P.LA);
  F.c_ctx = take(2 * F.CT * P.LCX);
  F.bytes = at;
  return F;
}

// K1's tiles (S grid rows x TJ cells), in order of preference: the largest
// recompute the least of their halo (1.7x at 4 x 16, 3x at 2 x 4)
constexpr int FWD_TILES[3][2] = {{4, 16}, {2, 8}, {2, 4}};

// K1's tile for a [B, wh, ww] grid on `sms` SMs (envelope.py:
// ngram_mma_fwd_tile): the first of FWD_TILES that fits a block, is no wider
// than the grid and still gives every SM a tile; else the smallest, 2 x 4,
// which fits wherever K7's plan does (its pass 1 stages the same tile and
// more)
inline FwdPlan fwd_tile(int B, int wh, int ww, int C, int D, int nh, int hd, int sms) {
  for (int i = 0; i < 2; ++i) {
    const int S_ = FWD_TILES[i][0], TJ_ = FWD_TILES[i][1];
    const long tiles = (long)B * ((wh + S_ - 1) / S_) * ((ww + TJ_ - 1) / TJ_);
    const FwdPlan F = make_fwd_plan(C, D, nh, hd, S_, TJ_);
    if (F.bytes <= MAX_SMEM && TJ_ <= ww && tiles >= sms) return F;
  }
  return make_fwd_plan(C, D, nh, hd, FWD_TILES[2][0], FWD_TILES[2][1]);
}

inline Body body(int C, int D, int nh, int hd, int is_bf16, bool forward) {
  if (C == 32 && D == 64 && ((nh == 6 && hd == 5) || (nh == 4 && hd == 8))) {
    if (is_bf16) return FLAGSHIP;
    if (forward) return TEMPLATED;
  }
  Plan P;
  return is_bf16 && plan(C, D, nh, hd, &P) &&
                 make_fwd_plan(C, D, nh, hd, FWD_TILES[2][0], FWD_TILES[2][1]).bytes <= MAX_SMEM
             ? TENSOR_CORE
             : CUDA_CORE;
}

}  // namespace ngram_g
}  // namespace
