// The long-window bodies on Hopper's tensor cores, at bfloat16: K3's and
// K4's (window_attention_fwd.cu, window_attention_bwd.cu) from 32 tokens a
// window up, and K2's and K8's (nstb_long.cuh: the whole NSTB, which rounds
// at every window length).  They take what the other tensor-core bodies
// leave out: windows of more than 64 tokens (HAT's 16x16 is N = 256) and
// heads of 33 to 64 channels.  They replace there the TPU kernels
// tmar/ops/pallas_attention.py:_attn_kernel_batched (:1143, pallas_call at
// :481) and :_attn_bwd_kernel_batched (:568, pallas_call at :357), and the
// attention core of tmar/ops/pallas_nstb.py:_nstb_map_kernel (:640,
// pallas_call at :592) and :_nstb_kernel (:334, pallas_call at :222).  The
// CUDA-core long-window bodies (window_attention_long.cuh, nstb_long.cuh)
// keep float32, the exactness path, and bf16 K3/K4 below 32 tokens, where
// the JAX kernel keeps q_n, k_n and P in float32.
//
// Why the tensor cores keep the results.  At bf16 the JAX kernels round
// every operand of every product here to bf16: x (x_attn), both weight
// matrices, q_n, k_n, v, P after its normalisation, the merged head outputs
// before the projection, y before fc1 and the GELU output before fc2, and
// (K4, cot_bf16) every cotangent product's operands.  mma.sync.m16n8k16
// with bf16 operands and float32 accumulation computes the same products;
// only the order of summation differs, as in the other tensor-core bodies.
// Norms, the softmax and its statistics, biases, LayerNorms and every sum
// into a parameter cotangent stay float32.
//
// What bounds them on an H100.  Not the products: the attention's two
// products of a 256-token window are 2·256²·hd per head against 3·256·hd
// bf16 of q_n, k_n and v, a few microseconds for a whole stage.  The
// softmax is: an exponential, a bias read and a handful of instructions a
// score, twice over, so the attention runs at tens of times its bound
// (PERF.md §6); the workspace's bytes come next.  Design:
// * a window does not fit a block in float32 (one head's scores at N = 256
//   are 256 KB), so each body is a few launches meeting in a workspace in
//   device memory, bf16 where the operands are bf16 (q_n, k_n and v
//   [T][3AP], the head outputs [T][AP], K4's dacc and dqkv copies): head_dim
//   is padded to HP = 16·ceil(hd / 16) with zeros, so that every row is
//   whole 16-byte chunks for cp.async and every head a whole mma k-step;
// * heads_gemm: token rows x a matrix whose columns are (part, head)
//   groups of HP, the rows of a 128-row tile staged in shared memory, the
//   matrix resident in the block (or one head's columns at a time where it
//   does not fit), a warp's 16 rows x one head's HP columns in registers,
//   so the q/k norms run in the epilogue (the qkv product; K4's dacc =
//   g·wprojᵀ with no norm);
// * attn_fwd_tc: a block of 8 warps per (window, head) holds the window's
//   q_n, k_n and v of that head in shared memory (110 KB at N = 256, HP =
//   64); a warp owns 16 query rows at a time.  The JAX kernel normalises P
//   before it rounds it, so a plain online softmax does not match: the
//   scores are computed twice, once for the row max and sum (online, per
//   thread, merged over the quad at the end), once for P = exp2(s - max) /
//   sum, rounded, then P·V (keeping a warp's scores in shared memory
//   between the sweeps measured slower: PERF.md §6).  Row max subtraction
//   and the decomposed shift mask (-100 per differing component, hazards
//   1-2) in log2 units, one ex2 a score; each tile's bias is read one tile
//   ahead (K2/K8: one table read a score, each key's offset and bands
//   staged once a block);
// * proj_gemm: rows x a matrix of at most 128 output columns (K3's
//   projection, K4's dx), K in stages of 64 staged by cp.async;
// * K4: rows_tc (a block of 8 warps per head, 64 query rows and group of
//   windows, the block's bias rows staged once where they fit; 4 row tiles
//   x 2 key halves: S, dP = dacc·vᵀ, P from K3's lse, delta = Σ dP·P and o
//   = bf16(P)·v in a first sweep over the keys, the halves added in a fixed
//   order; ds, its dbias rows (shared memory, one owner thread an element)
//   and dscale share and dq_n = bf16(dcos)·k_n in a second), cols_tc (a
//   block per window, head and 64 key rows: dk_n = bf16(dcos)ᵀ·q_n and dv =
//   bf16(P)ᵀ·dacc over query tiles of 16), the token sums sums_tc (16x16
//   tiles of dwqkv and dwproj, 8 a warp held in registers over the block's
//   rows) and one reduce in a fixed order.  No atomics: two runs give the
//   same bits.

#pragma once

#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {
namespace long_mma {

constexpr int MAX_HD = 64;   // the widest head its fragment arrays take
constexpr int MAX_D = 128;   // the widest D (a warp's 16 x D accumulator)
constexpr int MIN_N = 32;    // K3/K4: the JAX kernel rounds q_n, k_n, P from here
constexpr int GW = 8;        // warps of a row-tile block (heads_gemm, proj_gemm, sums)
constexpr int GR = 16 * GW;  // its token rows
constexpr int FW = 8;        // warps of a forward attention block
constexpr int RW = 8;        // warps of a K4 rows-pass block: 4 row tiles x 2 key halves
constexpr int AR = 64;       // its query rows
constexpr int CW = 4;        // warps of a K4 columns-pass block
constexpr int CR = 16 * CW;  // its key rows
constexpr int KC = 64;       // the inner width of a proj_gemm stage
constexpr int SR = 64;       // token rows of a token-sum step
constexpr int SUM_TILES = 8; // 16x16 cotangent tiles a token-sum warp holds over a round
constexpr int CHUNK = 64;    // hidden columns of a streamed NSTB tail stage
constexpr int ROWS_TARGET = 528;  // the rows pass's blocks to aim for (4 an SM)

__host__ __device__ inline int up(int n, int m) { return (n + m - 1) / m * m; }

// ---- geometry and shared memory (tmar_torch/ops/envelope.py: long_tc_*) ------

struct Geom {
  int N, D, nh, hd, A, HP, HK, AP, NP, DP, LDK;
};

inline Geom geom(int N, int D, int nh, int hd) {
  Geom g;
  g.N = N, g.D = D, g.nh = nh, g.hd = hd, g.A = nh * hd;
  g.HP = up(hd, 16), g.HK = g.HP / 16, g.AP = nh * g.HP;
  g.NP = up(N, 16), g.DP = up(D, 16), g.LDK = g.HP + 8;
  return g;
}

// heads_gemm with `parts` groups of heads: float32 biases [parts·AP]; the
// bf16 matrix [DP][cols + 8], all heads (resident) or one head's (streamed);
// the row tile [GR][DP + 8]
inline size_t gemm_bytes(const Geom& g, int parts, bool resident) {
  const int cols = resident ? parts * g.AP : parts * g.HP;
  return (size_t)4 * up(parts * g.AP, 4) + (size_t)2 * (g.DP * (cols + 8) + GR * (g.DP + 8));
}
// resident where it fits a block
inline bool gemm_resident(const Geom& g, int parts) {
  return gemm_bytes(g, parts, true) <= tmar::MAX_SMEM;
}
inline size_t gemm_plan_bytes(const Geom& g, int parts) {
  return gemm_bytes(g, parts, gemm_resident(g, parts));
}
// attn_fwd_tc: the bias's floats (K2/K8: the table (2ws - 1)² padded to 4,
// then an int a key [NP]; K3: 0), q_n, k_n and v of one (window, head)
// [NP][LDK]
inline size_t attn_bytes(const Geom& g, int table) {
  return (size_t)4 * up(table, 4) + (size_t)2 * 3 * g.NP * g.LDK;
}
// proj_gemm: a stage of the rows [GR][KC + 8] and of the matrix [KC][DP + 8]
inline size_t proj_bytes(const Geom& g) {
  return (size_t)2 * (GR * (KC + 8) + KC * (g.DP + 8));
}
// rows_tc: its rows of the bias [AR][N] float32 where `staged`, its rows'
// dbias [AR][N] and the two key halves' delta [2][AR]; k_n and v
// [NP][LDK], q_n and dacc of its rows [AR][LDK]
inline size_t rows_bytes(const Geom& g, bool staged) {
  return (size_t)4 * (AR * g.N * (staged ? 2 : 1) + 2 * AR) +
         (size_t)2 * (2 * g.NP * g.LDK + 2 * AR * g.LDK);
}
// the bias rows staged where they fit a block
inline bool rows_staged(const Geom& g) { return rows_bytes(g, true) <= tmar::MAX_SMEM; }
inline size_t rows_plan_bytes(const Geom& g) { return rows_bytes(g, rows_staged(g)); }
// cols_tc: lse and delta [NP]; q_n and dacc [NP][LDK], k_n and v of its keys [CR][LDK]
inline size_t cols_bytes(const Geom& g) {
  return (size_t)4 * 2 * g.NP + (size_t)2 * (2 * g.NP * g.LDK + 2 * CR * g.LDK);
}
// sums_tc: a step's x and g [SR][DP + 8], dqkv [SR][3AP + 8], o [SR][AP + 8]
inline size_t sums_bytes(const Geom& g) {
  return (size_t)2 * SR * (2 * (g.DP + 8) + (3 * g.AP + 8) + (g.AP + 8));
}
// the widths the fragment arrays take
inline bool widths(int D, int nh, int hd) {
  return D >= 8 && D <= MAX_D && D % 8 == 0 && hd >= 1 && hd <= MAX_HD && nh >= 1;
}

// K3's (bwd false) or K4's largest block on windows of N tokens, 0 where
// the bodies take no plan (widths, a window under 32 tokens, a launch past
// the card's shared memory).  K3's plan needs K4's to fit: one rule picks
// both kernels' body.
inline size_t attn_plan_bytes(int N, int D, int nh, int hd, bool bwd) {
  if (N < MIN_N || !widths(D, nh, hd)) return 0;
  const Geom g = geom(N, D, nh, hd);
  const size_t f[3] = {gemm_plan_bytes(g, 3), attn_bytes(g, 0), proj_bytes(g)};
  const size_t b[4] = {gemm_plan_bytes(g, 1), rows_plan_bytes(g), cols_bytes(g), sums_bytes(g)};
  size_t fwd = 0, all = 0;
  for (size_t v : f) fwd = v > fwd ? v : fwd;
  all = fwd;
  for (size_t v : b) all = v > all ? v : all;
  if (all > tmar::MAX_SMEM) return 0;
  return bwd ? all : fwd;
}

// K2's and K8's tail (nstb_long.cuh: nstb_tail_tc): float32 bproj, the
// LayerNorms' gains and biases, bw2 [DP] and bw1 [H padded to 64]; the
// bf16 wproj [AP][DP + 8], fc1's [DP][HC + 8] and fc2's [HC][DP + 8] (HC:
// all hidden columns resident, or CHUNK a streamed stage); per tile the
// head outputs [GR][AP + 8] and x [GR][DP + 8]
inline size_t tail_bytes(const Geom& g, int H, bool resident) {
  const int HC = resident ? up(H, 16) : CHUNK;
  return (size_t)4 * up(6 * g.DP + up(H, CHUNK), 4) +
         (size_t)2 * (g.AP * (g.DP + 8) + g.DP * (HC + 8) + HC * (g.DP + 8) +
                      GR * ((g.AP + 8) + (g.DP + 8)));
}
// 1: fc1 and fc2 resident, 2: streamed by CHUNK (16-byte rows: H a
// multiple of 8), 0: neither fits
inline int tail_mode(const Geom& g, int H) {
  if (tail_bytes(g, H, true) <= tmar::MAX_SMEM) return 1;
  if (H % 8 == 0 && tail_bytes(g, H, false) <= tmar::MAX_SMEM) return 2;
  return 0;
}
// K2's and K8's largest block for windows of side ws, 0 where the body
// takes no plan (widths, a launch past the card's shared memory)
inline size_t nstb_plan_bytes(int ws, int D, int nh, int hd, int H) {
  if (ws < 1 || H < 1 || !widths(D, nh, hd)) return 0;
  const Geom g = geom(ws * ws, D, nh, hd);
  const int mode = tail_mode(g, H);
  if (!mode) return 0;
  const size_t v[3] = {gemm_plan_bytes(g, 3), attn_bytes(g, up((2 * ws - 1) * (2 * ws - 1), 4) + g.NP),
                       tail_bytes(g, H, mode == 1)};
  size_t b = 0;
  for (size_t x : v) b = x > b ? x : b;
  return b <= tmar::MAX_SMEM ? b : 0;
}

// ---- the bias of a (window, head), in log2 units ---------------------------------
//
// Each bias reads a score's bias as bias(row(i), j): row(i) holds what
// depends on the query row alone, computed once a row tile; keys j past the
// window (its padding) read -inf.  tile(ra, rb, j0, t, v) reads the eight a
// thread of a 16x16 score tile holds (rows ra, rb; keys j0 + 8·hf + 2t and
// the next one), in the accumulators' layout, so that the sweeps can load a
// tile's bias one tile ahead.

// K3/K4: the gathered bias [nh, N, N] and the mask components m_row, m_col
// [N, N] on the last row / column of each (wh, ww) grid (wh = 0: no mask),
// read from device memory (L1)
struct DenseBias2 {
  const float* bias;
  const float* mrow;
  const float* mcol;
  int N, wh, ww;
  const float* b;
  bool gr, gc;
  // K4's rows pass: the head's rows [row0, row0 + 64) staged in shared memory
  const float* sb;
  int row0;
  struct Row {
    const float *b, *r, *c;
  };
  __host__ __device__ int floats(int) const { return 0; }
  __device__ __forceinline__ void at(int win, int h, float*) {
    b = bias + (size_t)h * N * N;
    const int place = wh > 0 ? win % (wh * ww) : 0;
    gr = wh > 0 && place / ww == wh - 1;
    gc = wh > 0 && place % ww == ww - 1;
  }
  __device__ __forceinline__ Row row(int i) const {
    const size_t o = (size_t)i * N;
    return {sb ? sb + (size_t)(i - row0) * N : b + o, gr ? mrow + o : nullptr,
            gc ? mcol + o : nullptr};
  }
  __device__ __forceinline__ float load(const float* p) const { return sb ? *p : __ldg(p); }
  __device__ __forceinline__ float2 load2(const float* p) const {
    return sb ? *reinterpret_cast<const float2*>(p) : __ldg(reinterpret_cast<const float2*>(p));
  }
  __device__ __forceinline__ float operator()(const Row& r, int j) const {
    if (j >= N) return -INFINITY;
    float v = load(r.b + j);
    if (r.r) v += __ldg(r.r + j);
    if (r.c) v += __ldg(r.c + j);
    return v * LOG2E;
  }
  // two neighbouring keys j, j + 1 (j even) of one row: one 8-byte load of
  // each array where N is even
  __device__ __forceinline__ float2 pair(const Row& r, int j) const {
    if ((N & 1) || j >= N) return make_float2((*this)(r, j), (*this)(r, j + 1));
    float2 v = load2(r.b + j);
    if (r.r) {
      const float2 m = __ldg(reinterpret_cast<const float2*>(r.r + j));
      v.x += m.x, v.y += m.y;
    }
    if (r.c) {
      const float2 m = __ldg(reinterpret_cast<const float2*>(r.c + j));
      v.x += m.x, v.y += m.y;
    }
    return make_float2(v.x * LOG2E, v.y * LOG2E);
  }
  __device__ __forceinline__ void tile(const Row& ra, const Row& rb, int j0, int t,
                                       float (&v)[2][4]) const {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = j0 + 8 * hf + 2 * t;
      const float2 a = pair(ra, j), b = pair(rb, j);
      v[hf][0] = a.x, v[hf][1] = a.y, v[hf][2] = b.x, v[hf][3] = b.y;
    }
  }
  // the same for a tile of Sᵀ (K4's columns pass): the accumulators' rows
  // are keys ja, jb (< N), their columns queries i0 + 8·hf + 2t (+ 1);
  // queries past the window read -inf
  __device__ __forceinline__ void tile_t(int ja, int jb, int i0, int t, float (&v)[2][4]) const {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * hf + 2 * t + (e & 1);
        v[hf][e] = i < N ? (*this)(row(i), e < 2 ? ja : jb) : -INFINITY;
      }
  }
};

// K2/K8: the relative-position table [(2ws-1)², nh], the head's column
// staged in shared memory in log2 units, and the shift mask of the bands
// (ws - shift rows and columns in) on the last row / column of each grid.
// Per key, staged once a block: its table offset rj·(2ws-1) + cj and its
// bands (bits 16, 17), padding bit 18; per row its offset (ri + ws - 1)·
// (2ws-1) + ci + ws - 1 and bands, so a score's bias is one table read.
struct TableBias2 {
  const float* table;
  int ws, nh, shift, wh, ww;
  const float* tab;
  const int* kinfo;
  bool gr, gc;
  struct Row {
    int q, rb, cb;
  };
  __host__ __device__ int floats(int NP) const {
    return up((2 * ws - 1) * (2 * ws - 1), 4) + NP;
  }
  __device__ __forceinline__ void at(int win, int h, float* sf) {
    const int tw = 2 * ws - 1, T2 = tw * tw, N = ws * ws, NP = up(N, 16), edge = ws - shift;
    int* ki = reinterpret_cast<int*>(sf + up(T2, 4));
    for (int e = threadIdx.x; e < T2; e += blockDim.x) sf[e] = __ldg(table + (size_t)e * nh + h) * LOG2E;
    for (int j = threadIdx.x; j < NP; j += blockDim.x) {
      const int rj = j / ws, cj = j - rj * ws;
      ki[j] = j < N ? (rj * tw + cj) | (int)(rj >= edge) << 16 | (int)(cj >= edge) << 17 : 1 << 18;
    }
    tab = sf, kinfo = ki;
    const int place = shift > 0 ? win % (wh * ww) : 0;
    gr = shift > 0 && place / ww == wh - 1;
    gc = shift > 0 && place % ww == ww - 1;
  }
  __device__ __forceinline__ Row row(int i) const {
    const int ri = i / ws, ci = i - ri * ws, edge = ws - shift;
    return {(ri + ws - 1) * (2 * ws - 1) + ci + ws - 1, ri >= edge, ci >= edge};
  }
  __device__ __forceinline__ float operator()(const Row& r, int j) const {
    const int k = kinfo[j];
    if (k >> 18) return -INFINITY;
    float v = tab[r.q - (k & 0xffff)];
    if (gr && r.rb != ((k >> 16) & 1)) v -= 100.f * LOG2E;
    if (gc && r.cb != ((k >> 17) & 1)) v -= 100.f * LOG2E;
    return v;
  }
  __device__ __forceinline__ void tile(const Row& ra, const Row& rb, int j0, int t,
                                       float (&v)[2][4]) const {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[hf][e] = (*this)(e < 2 ? ra : rb, j0 + 8 * hf + 2 * t + (e & 1));
  }
};

// ---- heads_gemm ------------------------------------------------------------------

// Row sources: 8 consecutive bf16 values of row t from column c (c a
// multiple of 8, c + 8 <= D), as a uint4.
struct RowsBf16 {
  const __nv_bfloat16* p;
  int ld;
  __device__ __forceinline__ uint4 operator()(long t, int c) const {
    return *reinterpret_cast<const uint4*>(p + (size_t)t * ld + c);
  }
};

// A matrix of float32 parameters w[k·sk + n·sn], read as its bf16 values.
struct MatF {
  const float* w;
  long sk, sn;
  __device__ __forceinline__ float operator()(int k, int n) const { return __ldg(w + k * sk + n * sn); }
};
// A bf16 matrix [K][ld], read in place.
struct MatB {
  const __nv_bfloat16* w;
  int ld;
  __device__ __forceinline__ float operator()(int k, int n) const {
    return __bfloat162float(w[(size_t)k * ld + n]);
  }
};

// out [T][parts·AP] bf16 = rows(t) · w, the column of (part, head h, d < hd)
// at part·AP + h·HP + d (zero for d >= hd), plus bias[part·A + h·hd + d]
// (when not null); the first `nnorm` parts L2-normalised per (row, head),
// x / (|x| + 1e-12).  When keep is not null (K4's recompute) it takes the
// normalised q and k unrounded [T][2A] and inv their reciprocal norms
// [T][2·nh].  A persistent block takes 128-row tiles; a warp owns 16 rows.
template <int HK, typename Src, typename W>
__global__ void __launch_bounds__(GW * 32) heads_gemm(Src src, W w, const float* __restrict__ bias,
                                                      __nv_bfloat16* __restrict__ out,
                                                      float* __restrict__ keep,
                                                      float* __restrict__ inv, long T, int D,
                                                      int nh, int hd, int parts, int nnorm,
                                                      int resident) {
  constexpr int HP = 16 * HK, HT = 2 * HK;
  extern __shared__ float4 smem4[];
  const int A = nh * hd, AP = nh * HP, DP = up(D, 16), dk = DP / 16, LDA = DP + 8;
  const int cols = resident ? parts * AP : parts * HP, LDW = cols + 8, WO = parts * AP;
  float* sb = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(sb + up(WO, 4));
  __nv_bfloat16* sa = sw + DP * LDW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  for (int o = tid; o < WO; o += blockDim.x) {
    const int part = o / AP, h = (o % AP) / HP, d = o % HP;
    sb[o] = bias && d < hd ? bias[part * A + h * hd + d] : 0.f;
  }
  // stage the columns of heads [h0, h0 + nh_s) (all resident, one streamed)
  auto stage = [&](int h0, int nh_s) {
    const int sc = parts * nh_s * HP;
    for (int e = tid; e < DP * sc; e += blockDim.x) {
      const int k = e / sc, c = e % sc, part = c / (nh_s * HP), h = h0 + (c % (nh_s * HP)) / HP,
                d = c % HP;
      const float v = k < D && d < hd ? w(k, part * A + h * hd + d) : 0.f;
      sw[k * LDW + c] = __float2bfloat16(v);
    }
  };
  if (resident) stage(0, nh);
  const long tiles = (T + GR - 1) / GR;
  const int c8 = DP / 8;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long t0 = tile * GR;
    __syncthreads();  // the last tile's reads are done
    for (int c = tid; c < GR * c8; c += blockDim.x) {
      const int r = c / c8, k = 8 * (c % c8);
      const uint4 v = t0 + r < T && k < D ? src(t0 + r, k) : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(sa + r * LDA + k) = v;
    }
    __syncthreads();
    uint32_t xa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk >= dk) break;
      load_a(xa[kk], sa, LDA, 16 * warp, 16 * kk, lane);
    }
    const long ta = t0 + 16 * warp + g, tb = ta + 8;
#pragma unroll 1
    for (int h = 0; h < nh; ++h) {
      if (!resident) {
        __syncthreads();
        stage(h, 1);
        __syncthreads();
      }
#pragma unroll 1
      for (int part = 0; part < parts; ++part) {
        const int c0 = resident ? part * AP + h * HP : part * HP;
        float acc[HT][4];
#pragma unroll
        for (int j = 0; j < HT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          if (kk >= dk) break;
#pragma unroll
          for (int n2 = 0; n2 < HK; ++n2)
            mma_pair_t(acc[2 * n2], acc[2 * n2 + 1], xa[kk], sw, LDW, c0 + 16 * n2, 16 * kk, lane);
        }
        const float* bb = sb + part * AP + h * HP;
#pragma unroll
        for (int j = 0; j < HT; ++j) {
          const int c = 8 * j + 2 * t;
          acc[j][0] += bb[c], acc[j][1] += bb[c + 1], acc[j][2] += bb[c], acc[j][3] += bb[c + 1];
        }
        float i0 = 1.f, i1 = 1.f;
        if (part < nnorm) {
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int j = 0; j < HT; ++j) {
            s0 += acc[j][0] * acc[j][0] + acc[j][1] * acc[j][1];
            s1 += acc[j][2] * acc[j][2] + acc[j][3] * acc[j][3];
          }
          i0 = 1.f / (sqrtf(quad_sum(s0)) + 1e-12f);
          i1 = 1.f / (sqrtf(quad_sum(s1)) + 1e-12f);
        }
        __nv_bfloat16* oa = out + (size_t)ta * WO + part * AP + h * HP;
        __nv_bfloat16* ob = out + (size_t)tb * WO + part * AP + h * HP;
#pragma unroll
        for (int j = 0; j < HT; ++j) {
          const int c = 8 * j + 2 * t;
          const float a0 = acc[j][0] * i0, a1 = acc[j][1] * i0, b0 = acc[j][2] * i1,
                      b1 = acc[j][3] * i1;
          if (ta < T) sts32(oa + c, pack_bf16(a0, a1));
          if (tb < T) sts32(ob + c, pack_bf16(b0, b1));
          if (keep && part < 2) {
            float* ka = keep + (size_t)ta * 2 * A + part * A + h * hd;
            float* kb = keep + (size_t)tb * 2 * A + part * A + h * hd;
            if (ta < T && c < hd) ka[c] = a0;
            if (ta < T && c + 1 < hd) ka[c + 1] = a1;
            if (tb < T && c < hd) kb[c] = b0;
            if (tb < T && c + 1 < hd) kb[c + 1] = b1;
          }
        }
        if (inv && part < 2 && t == 0) {
          if (ta < T) inv[ta * 2 * nh + part * nh + h] = i0;
          if (tb < T) inv[tb * 2 * nh + part * nh + h] = i1;
        }
      }
    }
  }
}

template <int HK, typename Src, typename W>
int launch_heads_t(Src src, W w, const float* bias, __nv_bfloat16* out, float* keep, float* inv,
                   long T, const Geom& g, int parts, int nnorm, cudaStream_t s) {
  auto kern = heads_gemm<HK, Src, W>;
  const bool res = gemm_resident(g, parts);
  const size_t bytes = gemm_bytes(g, parts, res);
  static int cache[64][3] = {};
  int grid = 0;
  int err = tmar::persistent_grid(kern, bytes, GW * 32, cache, &grid);
  if (err) return err;
  const long tiles = (T + GR - 1) / GR;
  if (tiles < grid) grid = (int)tiles;
  kern<<<grid, GW * 32, bytes, s>>>(src, w, bias, out, keep, inv, T, g.D, g.nh, g.hd, parts, nnorm,
                                    res);
  return (int)cudaGetLastError();
}

template <typename Src, typename W>
int launch_heads(Src src, W w, const float* bias, __nv_bfloat16* out, float* keep, float* inv,
                 long T, const Geom& g, int parts, int nnorm, cudaStream_t s) {
  switch (g.HK) {
    case 1: return launch_heads_t<1>(src, w, bias, out, keep, inv, T, g, parts, nnorm, s);
    case 2: return launch_heads_t<2>(src, w, bias, out, keep, inv, T, g, parts, nnorm, s);
    case 3: return launch_heads_t<3>(src, w, bias, out, keep, inv, T, g, parts, nnorm, s);
    default: return launch_heads_t<4>(src, w, bias, out, keep, inv, T, g, parts, nnorm, s);
  }
}

// ---- staging of a (window, head) -------------------------------------------------

// rows [r0, r0 + n) of a window's part (0 q_n, 1 k_n, 2 v; AP columns a
// part in a row of `ld`) for head h into s [rows][LDK] by cp.async, zeros
// for the rows of [0, rows) past n
__device__ __forceinline__ void stage_rows(__nv_bfloat16* s, const __nv_bfloat16* src, size_t ld,
                                           int r0, int n, int rows, int HP, int col, int LDK) {
  const int cpr = HP / 8;
  for (int c = threadIdx.x; c < rows * cpr; c += blockDim.x) {
    const int r = c / cpr, i = 8 * (c % cpr);
    if (r < n)
      cp_async16(s + r * LDK + i, src + (size_t)(r0 + r) * ld + col + i);
    else
      *reinterpret_cast<uint4*>(s + r * LDK + i) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The logits of one 16x16 score tile in place (a pair of accumulators:
// keys j0 + [0, 8) and j0 + [8, 16)): s·sc + the tile's bias b (Bias::tile)
// in log2 units, -inf past the window's N keys.
__device__ __forceinline__ void logits(float (&s)[2][4], const float (&b)[2][4], float sc) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[hf][e] = fmaf(s[hf][e], sc, b[hf][e]);
}

// The sweeps read a tile's bias one tile ahead (bias.tile into b1 while b
// serves this tile): cur takes next's values.
__device__ __forceinline__ void shift_in(float (&cur)[2][4], const float (&next)[2][4]) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int e = 0; e < 4; ++e) cur[hf][e] = next[hf][e];
}

// ---- the forward attention ---------------------------------------------------------

// Block (window, head) = (blockIdx.x / nh, blockIdx.x % nh): qkv [T][3AP]
// holds q_n, k_n and v in bf16; writes o [T][AP] (bf16(P)·v rounded to
// bf16) and, when lse is not null, lse [nwin, nh, N] = max + log(sum) in
// natural units.
template <int HK, typename Bias>
__global__ void __launch_bounds__(FW * 32) attn_fwd_tc(const __nv_bfloat16* __restrict__ qkv,
                                                       const float* __restrict__ scale, Bias bias,
                                                       __nv_bfloat16* __restrict__ o,
                                                       float* __restrict__ lse, int N, int nh) {
  constexpr int HP = 16 * HK, LDK = HP + 8;
  extern __shared__ float4 smem4[];
  const int NP = up(N, 16), AP = nh * HP;
  const int win = blockIdx.x / nh, h = blockIdx.x % nh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* sf = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(sf + up(bias.floats(NP), 4));
  __nv_bfloat16* sk = sq + NP * LDK;
  __nv_bfloat16* sv = sk + NP * LDK;
  const size_t tw = (size_t)win * N;
  const __nv_bfloat16* base = qkv + tw * 3 * AP;
  stage_rows(sq, base, 3 * AP, 0, N, NP, HP, h * HP, LDK);
  stage_rows(sk, base, 3 * AP, 0, N, NP, HP, AP + h * HP, LDK);
  stage_rows(sv, base, 3 * AP, 0, N, NP, HP, 2 * AP + h * HP, LDK);
  cp_async_commit();
  bias.at(win, h, sf);
  cp_async_wait_all();
  __syncthreads();
  const float sc = __ldg(scale + h) * LOG2E;
  for (int rt = warp; rt < NP / 16; rt += FW) {
    const int r0 = 16 * rt + g, r1 = r0 + 8;
    const typename Bias::Row ra = bias.row(r0 < N ? r0 : N - 1), rb = bias.row(r1 < N ? r1 : N - 1);
    uint32_t qa[HK][4];
#pragma unroll
    for (int kk = 0; kk < HK; ++kk) load_a(qa[kk], sq, LDK, 16 * rt, 16 * kk, lane);
    // sweep 1: the row max and sum, online per thread, merged over the quad
    float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
    float b[2][4], b1[2][4];
    bias.tile(ra, rb, 0, t, b1);
    for (int jp = 0; jp < NP / 16; ++jp) {
      shift_in(b, b1);
      if (16 * jp + 16 < NP) bias.tile(ra, rb, 16 * jp + 16, t, b1);
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < HK; ++kk) mma_pair(s[0], s[1], qa[kk], sk, LDK, 16 * jp, 16 * kk, lane);
      logits(s, b, sc);
      const float n0 = fmaxf(m0, fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1])));
      const float n1 = fmaxf(m1, fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3])));
      l0 = l0 * exp2_approx(m0 - n0) + exp2_approx(s[0][0] - n0) + exp2_approx(s[0][1] - n0) +
           exp2_approx(s[1][0] - n0) + exp2_approx(s[1][1] - n0);
      l1 = l1 * exp2_approx(m1 - n1) + exp2_approx(s[0][2] - n1) + exp2_approx(s[0][3] - n1) +
           exp2_approx(s[1][2] - n1) + exp2_approx(s[1][3] - n1);
      m0 = n0, m1 = n1;
    }
    const float M0 = quad_max(m0), M1 = quad_max(m1);
    const float L0 = quad_sum(l0 * exp2_approx(m0 - M0)), L1 = quad_sum(l1 * exp2_approx(m1 - M1));
    const float iz0 = 1.f / L0, iz1 = 1.f / L1;
    // sweep 2: P = exp2(s - max) / sum, rounded, then P·v
    float acc[2 * HK][4];
#pragma unroll
    for (int j = 0; j < 2 * HK; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    bias.tile(ra, rb, 0, t, b1);
    for (int jp = 0; jp < NP / 16; ++jp) {
      shift_in(b, b1);
      if (16 * jp + 16 < NP) bias.tile(ra, rb, 16 * jp + 16, t, b1);
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < HK; ++kk) mma_pair(s[0], s[1], qa[kk], sk, LDK, 16 * jp, 16 * kk, lane);
      logits(s, b, sc);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        s[hf][0] = exp2_approx(s[hf][0] - M0) * iz0, s[hf][1] = exp2_approx(s[hf][1] - M0) * iz0;
        s[hf][2] = exp2_approx(s[hf][2] - M1) * iz1, s[hf][3] = exp2_approx(s[hf][3] - M1) * iz1;
      }
      uint32_t pa[4];
      to_a(pa, s[0], s[1]);
#pragma unroll
      for (int n2 = 0; n2 < HK; ++n2)
        mma_pair_t(acc[2 * n2], acc[2 * n2 + 1], pa, sv, LDK, 16 * n2, 16 * jp, lane);
    }
#pragma unroll
    for (int j = 0; j < 2 * HK; ++j) {
      const int c = h * HP + 8 * j + 2 * t;
      if (r0 < N) sts32(o + (tw + r0) * AP + c, pack_bf16(acc[j][0], acc[j][1]));
      if (r1 < N) sts32(o + (tw + r1) * AP + c, pack_bf16(acc[j][2], acc[j][3]));
    }
    if (lse && t == 0) {
      float* l = lse + ((size_t)win * nh + h) * N;
      if (r0 < N) l[r0] = (M0 + log2f(L0)) * LN2;
      if (r1 < N) l[r1] = (M1 + log2f(L1)) * LN2;
    }
  }
}

template <typename Bias>
int launch_attn(const __nv_bfloat16* qkv, const float* scale, const Bias& bias, __nv_bfloat16* o,
                float* lse, int nwin, const Geom& g, cudaStream_t s) {
  const size_t bytes = attn_bytes(g, bias.floats(g.NP));
  const unsigned grid = (unsigned)nwin * g.nh;
#define TMAR_ATTN_HK(HKV)                                                                      \
  {                                                                                            \
    auto kern = attn_fwd_tc<HKV, Bias>;                                                        \
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                                         (int)bytes);                                          \
    if (e != cudaSuccess) return (int)e;                                                       \
    kern<<<grid, FW * 32, bytes, s>>>(qkv, scale, bias, o, lse, g.N, g.nh);                    \
    return (int)cudaGetLastError();                                                            \
  }
  switch (g.HK) {
    case 1: TMAR_ATTN_HK(1)
    case 2: TMAR_ATTN_HK(2)
    case 3: TMAR_ATTN_HK(3)
    default: TMAR_ATTN_HK(4)
  }
#undef TMAR_ATTN_HK
}

// ---- proj_gemm -----------------------------------------------------------------------

// out [T][D] bf16 = a · w (+ bias[n]), a [T][KP] bf16 (KP a multiple of 16),
// w(k, n) for k < KP, n < D read from the parameters (rounded to bf16 as
// it is staged); a block a 128-row tile, a warp 16 rows x DM columns, K in
// stages of KC.
template <int DM, typename W>
__global__ void __launch_bounds__(GW * 32) proj_gemm(const __nv_bfloat16* __restrict__ a, int KP,
                                                     W w, const float* __restrict__ bias,
                                                     __nv_bfloat16* __restrict__ out, long T,
                                                     int D) {
  constexpr int DT = DM / 8, DK = DM / 16;
  extern __shared__ float4 smem4[];
  const int DP = up(D, 16), dk = DP / 16, LDA = KC + 8, LDW = DP + 8;
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sw = sa + GR * LDA;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long t0 = (long)blockIdx.x * GR;
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k0 = 0; k0 < KP; k0 += KC) {
    const int kc = KP - k0 < KC ? KP - k0 : KC, c8 = kc / 8;
    __syncthreads();
    for (int c = tid; c < GR * c8; c += blockDim.x) {
      const int r = c / c8, i = 8 * (c % c8);
      if (t0 + r < T)
        cp_async16(sa + r * LDA + i, a + (size_t)(t0 + r) * KP + k0 + i);
      else
        *reinterpret_cast<uint4*>(sa + r * LDA + i) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
    for (int e = tid; e < kc * DP; e += blockDim.x) {
      const int k = e / DP, n = e % DP;
      sw[k * LDW + n] = __float2bfloat16(n < D ? w(k0 + k, n) : 0.f);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int kk = 0; kk < kc / 16; ++kk) {
      uint32_t xa[4];
      load_a(xa, sa, LDA, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int n2 = 0; n2 < DK; ++n2) {
        if (n2 >= dk) break;
        mma_pair_t(acc[2 * n2], acc[2 * n2 + 1], xa, sw, LDW, 16 * n2, 16 * kk, lane);
      }
    }
  }
  const long ta = t0 + 16 * warp + g, tb = ta + 8;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = 8 * j + 2 * t;
    if (c >= D) break;
    const float b0 = bias ? __ldg(bias + c) : 0.f, b1 = bias ? __ldg(bias + c + 1) : 0.f;
    if (ta < T) sts32(out + (size_t)ta * D + c, pack_bf16(acc[j][0] + b0, acc[j][1] + b1));
    if (tb < T) sts32(out + (size_t)tb * D + c, pack_bf16(acc[j][2] + b0, acc[j][3] + b1));
  }
}

template <typename W>
int launch_proj(const __nv_bfloat16* a, int KP, W w, const float* bias, __nv_bfloat16* out, long T,
                int D, cudaStream_t s) {
  const Geom g = geom(1, D, 1, 1);
  const size_t bytes = proj_bytes(g);
  const unsigned grid = (unsigned)((T + GR - 1) / GR);
  cudaError_t e;
#define TMAR_PROJ_DM(DMV)                                                                      \
  {                                                                                            \
    auto kern = proj_gemm<DMV, W>;                                                             \
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,           \
                                  (int)bytes)) != cudaSuccess)                                 \
      return (int)e;                                                                           \
    kern<<<grid, GW * 32, bytes, s>>>(a, KP, w, bias, out, T, D);                              \
    return (int)cudaGetLastError();                                                            \
  }
  if (g.DP <= 32) TMAR_PROJ_DM(32)
  if (g.DP <= 64) TMAR_PROJ_DM(64)
  TMAR_PROJ_DM(128)
#undef TMAR_PROJ_DM
}

// w(k, n) of the projection on the padded head outputs: k = h·HP + d
// -> wproj[(h·hd + d)·sk + n·sn], zero for d >= hd
struct ProjW {
  const float* w;
  long sk, sn;
  int hd, HP;
  __device__ __forceinline__ float operator()(int k, int n) const {
    const int h = k / HP, d = k % HP;
    return d < hd ? __ldg(w + (long)(h * hd + d) * sk + n * sn) : 0.f;
  }
};

// ---- K3 ------------------------------------------------------------------------------

// K3's workspace in floats: q_n, k_n and v [T][3AP] and the head outputs
// [T][AP], bf16.
inline long long fwd_workspace(int nwin, int N, int nh, int hd) {
  const Geom g = geom(N, 8, nh, hd);
  return ((long long)nwin * N * 4 * g.AP * 2 + 15) / 16 * 4;
}

// K3's tensor-core long-window body (p as tmar_window_attention_fwd takes
// them; the workspace holds fwd_workspace floats): qkv with the norms, the
// attention with lse for K4, the projection.  Three launches.
inline int fwd(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* out, void* lse,
               float* ws, int nwin, int N, int D, int nh, int hd, int wh, int ww, cudaStream_t s) {
  if (!attn_plan_bytes(N, D, nh, hd, false) || !ws ||
      (((uintptr_t)p[0] | (uintptr_t)out | (uintptr_t)ws) & 15))
    return (int)cudaErrorInvalidValue;
  const Geom g = geom(N, D, nh, hd);
  const long T = (long)nwin * N;
  __nv_bfloat16* qkv = reinterpret_cast<__nv_bfloat16*>(ws);
  __nv_bfloat16* o = qkv + (size_t)T * 3 * g.AP;
  int err = launch_heads(RowsBf16{(const __nv_bfloat16*)p[0], D},
                         MatF{(const float*)p[1], wq_k, wq_n}, (const float*)p[2], qkv, nullptr,
                         nullptr, T, g, 3, 2, s);
  if (err) return err;
  const DenseBias2 bias{(const float*)p[4], (const float*)p[7], (const float*)p[8], N, wh, ww,
                        nullptr, false, false};
  err = launch_attn(qkv, (const float*)p[3], bias, o, (float*)lse, nwin, g, s);
  if (err) return err;
  return launch_proj(o, g.AP, ProjW{(const float*)p[5], wp_k, wp_n, hd, g.HP}, (const float*)p[6],
                     (__nv_bfloat16*)out, T, D, s);
}

// ---- K4 ------------------------------------------------------------------------------

// The probabilities of one 16x16 score tile (rows valid per v0 / v1), P =
// exp2(s·sc + b - L) from K3's lse (log2 units) with the tile's bias b
// (DenseBias2::tile), 0 past the window.
__device__ __forceinline__ void probs(float (&p)[2][4], const float (&s)[2][4],
                                      const float (&b)[2][4], float sc, float L0, float L1,
                                      bool v0, bool v1) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool lo = e < 2;
      p[hf][e] = (lo ? v0 : v1) ? exp2_approx(fmaf(s[hf][e], sc, b[hf][e]) - (lo ? L0 : L1)) : 0.f;
    }
}

// K4's workspace layout, in bytes (each region on 16): q_n, k_n, v [T][3AP]
// bf16; q_n and k_n unrounded [T][2A] and their reciprocal norms [T][2nh];
// dacc = g·wprojᵀ [T][AP] bf16; the head outputs [T][AP] bf16; dqkv [T][3A]
// float32 and bf16 [T][3AP]; delta [nwin, nh, N]; the rows blocks' dscale
// shares [nh][RB][G] and dbias shares [G][nh][N][N]; the token-sum slots
// [P][SUMS] (dwqkv [DP][3AP], dwproj [AP][DP], dbqkv [3A], dbproj [D]).
struct BwdLayout {
  long T;
  int RB, CB, G, P;
  long SUMS, OW, OB;
  size_t qkv, qk32, inv, dacc, o, dqkv, dq16, delta, dsc, dbp, part, total;
};

inline size_t up16(size_t n) { return (n + 15) / 16 * 16; }

inline BwdLayout bwd_layout(int nwin, int N, int D, int nh, int hd) {
  const Geom g = geom(N, D, nh, hd);
  BwdLayout L;
  L.T = (long)nwin * N;
  L.RB = (g.NP + AR - 1) / AR;
  L.CB = (g.NP + CR - 1) / CR;
  const int gr = (ROWS_TARGET + L.RB * nh - 1) / (L.RB * nh);
  L.G = gr < nwin ? gr : nwin;
  const long steps = (L.T + SR - 1) / SR;
  L.P = (int)(steps < 264 ? steps : 264);
  L.OW = (long)g.DP * 3 * g.AP;
  L.OB = L.OW + (long)g.AP * g.DP;
  L.SUMS = (L.OB + 3 * g.A + D + 3) / 4 * 4;  // slots on 16 bytes: 8-byte stores
  const size_t T = (size_t)L.T;
  L.qkv = 0;
  L.qk32 = L.qkv + up16(T * 3 * g.AP * 2);
  L.inv = L.qk32 + up16(T * 2 * g.A * 4);
  L.dacc = L.inv + up16(T * 2 * nh * 4);
  L.o = L.dacc + up16(T * g.AP * 2);
  L.dqkv = L.o + up16(T * g.AP * 2);
  L.dq16 = L.dqkv + up16(T * 3 * g.A * 4);
  L.delta = L.dq16 + up16(T * 3 * g.AP * 2);
  L.dsc = L.delta + up16((size_t)nwin * nh * N * 4);
  L.dbp = L.dsc + up16((size_t)nh * L.RB * L.G * 4);
  L.part = L.dbp + up16((size_t)L.G * nh * N * N * 4);
  L.total = L.part + (size_t)L.P * L.SUMS * 4;
  return L;
}

inline long long bwd_workspace(int nwin, int N, int D, int nh, int hd) {
  return (long long)((bwd_layout(nwin, N, D, nh, hd).total + 3) / 4);
}

// One 16x16 score tile's sweep-1 work of K4's rows pass (keys 16·jt on):
// S, dP = bf16(dacc)·bf16(v)ᵀ, P from lse with the tile's bias b; delta +=
// Σ dP·P, o += bf16(P)·bf16(v).  Sweep 2 (ds, dbias, dscale, dq_n) is in
// rows_tc.
template <int HK>
__device__ __forceinline__ void rows_sweep1(const uint32_t (&qa)[HK][4], const uint32_t (&da)[HK][4],
                                            const __nv_bfloat16* sk, const __nv_bfloat16* sv,
                                            int LDK, int jt, const float (&b)[2][4], float sc2,
                                            float L0, float L1, bool v0, bool v1, float& dl0,
                                            float& dl1, float (&oacc)[2 * HK][4], int lane) {
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int kk = 0; kk < HK; ++kk) {
    mma_pair(s[0], s[1], qa[kk], sk, LDK, 16 * jt, 16 * kk, lane);
    mma_pair(dp[0], dp[1], da[kk], sv, LDK, 16 * jt, 16 * kk, lane);
  }
  float p[2][4];
  probs(p, s, b, sc2, L0, L1, v0, v1);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    dl0 = fmaf(p[hf][0], dp[hf][0], fmaf(p[hf][1], dp[hf][1], dl0));
    dl1 = fmaf(p[hf][2], dp[hf][2], fmaf(p[hf][3], dp[hf][3], dl1));
  }
  uint32_t pa[4];
  to_a(pa, p[0], p[1]);
#pragma unroll
  for (int n2 = 0; n2 < HK; ++n2)
    mma_pair_t(oacc[2 * n2], oacc[2 * n2 + 1], pa, sv, LDK, 16 * n2, 16 * jt, lane);
}

// Block (64 query rows from 64·bx, head h, window group bz), 8 warps: warp
// w takes row tile w % 4 against key half w / 4, over the group's windows.
// The block's rows of the bias are staged in shared memory once (where
// they fit; the shift mask stays in device memory).  Per window, sweep 1
// (rows_sweep1) over the warp's keys; the two halves' delta and o added in
// a fixed order through shared memory; sweep 2: ds = P·(dP - delta) into
// the block's own rows of the group's dbias share (shared memory, one owner
// thread an element) and its dscale share Σ ds·cos, dq_n +=
// bf16(ds·scale)·bf16(k_n); the halves' dq_n added, then dq = iq·(dq_n -
// q_n·(dq_n·q_n)) with q_n unrounded, written float32 and bf16.  No other
// block writes those rows or shares.
template <int HK>
__global__ void __launch_bounds__(RW * 32) rows_tc(
    const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ qk32,
    const float* __restrict__ inv, const __nv_bfloat16* __restrict__ dacc,
    const float* __restrict__ lse, const float* __restrict__ scale, DenseBias2 bias,
    __nv_bfloat16* __restrict__ o, float* __restrict__ dqkv, __nv_bfloat16* __restrict__ dq16,
    float* __restrict__ delta, float* __restrict__ dsc, float* __restrict__ dbp, int nwin, int N,
    int nh, int hd, int staged) {
  constexpr int HP = 16 * HK, LDK = HP + 8, HT = 2 * HK;
  extern __shared__ float4 smem4[];
  const int NP = up(N, 16), AP = nh * HP, A = nh * hd, NT = NP / 16, NT2 = (NT + 1) / 2;
  const int h = blockIdx.y, row0 = blockIdx.x * AR, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rt = warp & 3, kh = warp >> 2;
  const int jt0 = kh * NT2, jt1 = jt0 + NT2 < NT ? jt0 + NT2 : NT;  // the warp's key tiles
  float* sb = reinterpret_cast<float*>(smem4);  // the bias rows [AR][N], where staged
  float* sdb = sb + (staged ? AR * N : 0);      // dbias rows [AR][N]
  float* xdl = sdb + AR * N;                    // the key halves' delta [2][AR]
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(xdl + 2 * AR);  // [NP][LDK]
  __nv_bfloat16* sv = sk + NP * LDK;
  __nv_bfloat16* sq = sv + NP * LDK;  // [AR][LDK]
  __nv_bfloat16* sd = sq + AR * LDK;
  float* xf = reinterpret_cast<float*>(sq);  // [AR][HP]: a half's o or dq_n, once q_n and dacc are read
  const int nr = N - row0 < AR ? N - row0 : AR;
  if (staged) {
    const float* src = bias.bias + ((size_t)h * N + row0) * N;
    for (int e = tid; e < nr * N; e += blockDim.x) cp_async4(sb + e, src + e);
    cp_async_commit();
    bias.sb = sb, bias.row0 = row0;
  }
  for (int e = tid; e < AR * N; e += blockDim.x) sdb[e] = 0.f;
  const float sc = __ldg(scale + h), sc2 = sc * LOG2E;
  float dscale = 0.f;
  const int per = (nwin + gridDim.z - 1) / gridDim.z, w0 = blockIdx.z * per;
  const int w1 = w0 + per < nwin ? w0 + per : nwin;
  const int wr = row0 + 16 * rt, r0 = wr + g, r1 = r0 + 8;
  const int i0 = r0 < N ? r0 : N - 1, i1 = r1 < N ? r1 : N - 1;
  const bool v0 = r0 < N, v1 = r1 < N, live = wr < N && jt0 < jt1;
  float* db0 = sdb + (16 * rt + g) * N;
  float* db1 = db0 + 8 * N;
  float* xa = xf + (16 * rt + g) * HP;  // this thread's rows of the exchange
  float* xb = xa + 8 * HP;
  for (int win = w0; win < w1; ++win) {
    const size_t tw = (size_t)win * N;
    const __nv_bfloat16* base = qkv + tw * 3 * AP;
    __syncthreads();  // the last window's reads are done
    stage_rows(sk, base, 3 * AP, 0, N, NP, HP, AP + h * HP, LDK);
    stage_rows(sv, base, 3 * AP, 0, N, NP, HP, 2 * AP + h * HP, LDK);
    stage_rows(sq, base, 3 * AP, row0, nr, AR, HP, h * HP, LDK);
    stage_rows(sd, dacc + tw * AP, AP, row0, nr, AR, HP, h * HP, LDK);
    cp_async_commit();
    bias.at(win, h, nullptr);
    cp_async_wait_all();
    __syncthreads();
    uint32_t qa[HK][4], da[HK][4];
#pragma unroll
    for (int kk = 0; kk < HK; ++kk) {
      load_a(qa[kk], sq, LDK, 16 * rt, 16 * kk, lane);
      load_a(da[kk], sd, LDK, 16 * rt, 16 * kk, lane);
    }
    __syncthreads();  // q_n and dacc are in registers: sq / sd become xf
    const float* lw = lse + ((size_t)win * nh + h) * N;
    const float L0 = lw[i0] * LOG2E, L1 = lw[i1] * LOG2E;
    const DenseBias2::Row ra = bias.row(i0), rb = bias.row(i1);
    float dl0 = 0.f, dl1 = 0.f;
    float oacc[HT][4];
#pragma unroll
    for (int j = 0; j < HT; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
    float b[2][4], b1[2][4];
    if (live) {
      bias.tile(ra, rb, 16 * jt0, t, b1);
      for (int jt = jt0; jt < jt1; ++jt) {
        shift_in(b, b1);
        if (jt + 1 < jt1) bias.tile(ra, rb, 16 * jt + 16, t, b1);
        rows_sweep1(qa, da, sk, sv, LDK, jt, b, sc2, L0, L1, v0, v1, dl0, dl1, oacc, lane);
      }
    }
    dl0 = quad_sum(dl0), dl1 = quad_sum(dl1);
    if (t == 0) xdl[kh * AR + 16 * rt + g] = dl0, xdl[kh * AR + 16 * rt + g + 8] = dl1;
    if (kh == 1 && live)
#pragma unroll
      for (int j = 0; j < HT; ++j) {
        const int c = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(xa + c) = make_float2(oacc[j][0], oacc[j][1]);
        *reinterpret_cast<float2*>(xb + c) = make_float2(oacc[j][2], oacc[j][3]);
      }
    __syncthreads();
    dl0 = xdl[16 * rt + g] + xdl[AR + 16 * rt + g];
    dl1 = xdl[16 * rt + g + 8] + xdl[AR + 16 * rt + g + 8];
    const bool other = NT > NT2;  // key half 1 has tiles (and wrote xf)
    if (kh == 0 && wr < N) {
#pragma unroll
      for (int j = 0; j < HT; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 u = other ? *reinterpret_cast<const float2*>(xa + c) : make_float2(0.f, 0.f);
        const float2 w = other ? *reinterpret_cast<const float2*>(xb + c) : make_float2(0.f, 0.f);
        if (v0) sts32(o + (tw + r0) * AP + h * HP + c, pack_bf16(oacc[j][0] + u.x, oacc[j][1] + u.y));
        if (v1) sts32(o + (tw + r1) * AP + h * HP + c, pack_bf16(oacc[j][2] + w.x, oacc[j][3] + w.y));
      }
      if (t == 0) {
        float* dw = delta + ((size_t)win * nh + h) * N;
        if (v0) dw[r0] = dl0;
        if (v1) dw[r1] = dl1;
      }
    }
    __syncthreads();  // xf is free again
    float dqn[HT][4];
#pragma unroll
    for (int j = 0; j < HT; ++j) dqn[j][0] = dqn[j][1] = dqn[j][2] = dqn[j][3] = 0.f;
    if (live) {
      bias.tile(ra, rb, 16 * jt0, t, b1);
      for (int jt = jt0; jt < jt1; ++jt) {
        shift_in(b, b1);
        if (jt + 1 < jt1) bias.tile(ra, rb, 16 * jt + 16, t, b1);
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < HK; ++kk) {
          mma_pair(s[0], s[1], qa[kk], sk, LDK, 16 * jt, 16 * kk, lane);
          mma_pair(dp[0], dp[1], da[kk], sv, LDK, 16 * jt, 16 * kk, lane);
        }
        float p[2][4];
        probs(p, s, b, sc2, L0, L1, v0, v1);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 16 * jt + 8 * hf + 2 * t + (e & 1);
            const float ds = p[hf][e] * (dp[hf][e] - (e < 2 ? dl0 : dl1));
            if (j < N && (e < 2 ? v0 : v1)) {
              (e < 2 ? db0 : db1)[j] += ds;
              dscale = fmaf(ds, s[hf][e], dscale);
            }
            p[hf][e] = ds * sc;  // dcos
          }
        uint32_t ca[4];
        to_a(ca, p[0], p[1]);
#pragma unroll
        for (int n2 = 0; n2 < HK; ++n2)
          mma_pair_t(dqn[2 * n2], dqn[2 * n2 + 1], ca, sk, LDK, 16 * n2, 16 * jt, lane);
      }
    }
    if (kh == 1 && live)
#pragma unroll
      for (int j = 0; j < HT; ++j) {
        const int c = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(xa + c) = make_float2(dqn[j][0], dqn[j][1]);
        *reinterpret_cast<float2*>(xb + c) = make_float2(dqn[j][2], dqn[j][3]);
      }
    __syncthreads();
    if (kh != 0 || wr >= N) continue;
    // the halves' dq_n added; dq through the norm
#pragma unroll
    for (int j = 0; j < HT; ++j) {
      const int c = 8 * j + 2 * t;
      if (other) {
        const float2 u = *reinterpret_cast<const float2*>(xa + c);
        const float2 w = *reinterpret_cast<const float2*>(xb + c);
        dqn[j][0] += u.x, dqn[j][1] += u.y, dqn[j][2] += w.x, dqn[j][3] += w.y;
      }
    }
    const float* qa32 = qk32 + (tw + i0) * 2 * A + h * hd;
    const float* qb32 = qk32 + (tw + i1) * 2 * A + h * hd;
    float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
    for (int j = 0; j < HT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * t + e;
        if (d < hd) dot0 = fmaf(dqn[j][e], qa32[d], dot0), dot1 = fmaf(dqn[j][2 + e], qb32[d], dot1);
      }
    dot0 = quad_sum(dot0), dot1 = quad_sum(dot1);
    const float iq0 = inv[(tw + i0) * 2 * nh + h], iq1 = inv[(tw + i1) * 2 * nh + h];
#pragma unroll
    for (int j = 0; j < HT; ++j) {
      const int c = 8 * j + 2 * t;
      float q0[2], q1[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = c + e;
        q0[e] = d < hd ? iq0 * (dqn[j][e] - qa32[d] * dot0) : 0.f;
        q1[e] = d < hd ? iq1 * (dqn[j][2 + e] - qb32[d] * dot1) : 0.f;
        if (d < hd && v0) dqkv[(tw + r0) * 3 * A + h * hd + d] = q0[e];
        if (d < hd && v1) dqkv[(tw + r1) * 3 * A + h * hd + d] = q1[e];
      }
      if (v0) sts32(dq16 + (tw + r0) * 3 * AP + h * HP + c, pack_bf16(q0[0], q0[1]));
      if (v1) sts32(dq16 + (tw + r1) * 3 * AP + h * HP + c, pack_bf16(q1[0], q1[1]));
    }
  }
  dscale = tmar::warp_sum(dscale);
  __syncthreads();
  float* red = reinterpret_cast<float*>(sk);  // the warps' dscale shares, summed in warp order
  if (lane == 0) red[warp] = dscale;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int w = 0; w < RW; ++w) sum += red[w];
    dsc[((size_t)h * gridDim.x + blockIdx.x) * gridDim.z + blockIdx.z] = sum;
  }
  for (int e = tid; e < nr * N; e += blockDim.x)
    dbp[(((size_t)blockIdx.z * nh + h) * N + row0) * N + e] = sdb[e];
}

// Block (64 key rows from 64·bx, head h, window bz): a warp 16 keys;
// query tiles of 16: Sᵀ = k_n·q_nᵀ, dPᵀ = v·daccᵀ, P and ds from the rows'
// lse and delta (the bias a tile ahead); dv += bf16(P)ᵀ·bf16(dacc), dk_n +=
// bf16(ds·scale)ᵀ·bf16(q_n); then dk through the norm, k_n unrounded.
template <int HK>
__global__ void __launch_bounds__(CW * 32) cols_tc(
    const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ qk32,
    const float* __restrict__ inv, const __nv_bfloat16* __restrict__ dacc,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ scale, DenseBias2 bias, float* __restrict__ dqkv,
    __nv_bfloat16* __restrict__ dq16, int N, int nh, int hd) {
  constexpr int HP = 16 * HK, LDK = HP + 8, HT = 2 * HK;
  extern __shared__ float4 smem4[];
  const int NP = up(N, 16), AP = nh * HP, A = nh * hd;
  const int h = blockIdx.y, win = blockIdx.z, row0 = blockIdx.x * CR, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* sl = reinterpret_cast<float*>(smem4);  // lse in log2 units [NP]
  float* sdl = sl + NP;                         // delta [NP]
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(sdl + NP);  // [NP][LDK]
  __nv_bfloat16* sd = sq + NP * LDK;
  __nv_bfloat16* sk = sd + NP * LDK;  // [CR][LDK]
  __nv_bfloat16* sv = sk + CR * LDK;
  const size_t tw = (size_t)win * N;
  const __nv_bfloat16* base = qkv + tw * 3 * AP;
  const int nr = N - row0 < CR ? N - row0 : CR;
  stage_rows(sq, base, 3 * AP, 0, N, NP, HP, h * HP, LDK);
  stage_rows(sd, dacc + tw * AP, AP, 0, N, NP, HP, h * HP, LDK);
  stage_rows(sk, base, 3 * AP, row0, nr, CR, HP, AP + h * HP, LDK);
  stage_rows(sv, base, 3 * AP, row0, nr, CR, HP, 2 * AP + h * HP, LDK);
  cp_async_commit();
  const size_t wh_ = ((size_t)win * nh + h) * N;
  for (int e = tid; e < NP; e += blockDim.x) {
    sl[e] = e < N ? lse[wh_ + e] * LOG2E : 0.f;
    sdl[e] = e < N ? delta[wh_ + e] : 0.f;
  }
  bias.at(win, h, nullptr);
  cp_async_wait_all();
  __syncthreads();
  const int wr = row0 + 16 * warp;
  if (wr >= N) return;
  const int j0 = wr + g, j1 = j0 + 8;
  const int jc0 = j0 < N ? j0 : N - 1, jc1 = j1 < N ? j1 : N - 1;
  const bool v0 = j0 < N, v1 = j1 < N;
  const float sc = __ldg(scale + h), sc2 = sc * LOG2E;
  uint32_t ka[HK][4], va[HK][4];
#pragma unroll
  for (int kk = 0; kk < HK; ++kk) {
    load_a(ka[kk], sk, LDK, 16 * warp, 16 * kk, lane);
    load_a(va[kk], sv, LDK, 16 * warp, 16 * kk, lane);
  }
  float dk[HT][4], dv[HT][4];
#pragma unroll
  for (int j = 0; j < HT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  float b[2][4], b1[2][4];
  bias.tile_t(jc0, jc1, 0, t, b1);
  for (int ip = 0; ip < NP / 16; ++ip) {
    shift_in(b, b1);
    if (16 * ip + 16 < NP) bias.tile_t(jc0, jc1, 16 * ip + 16, t, b1);
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HK; ++kk) {
      mma_pair(s[0], s[1], ka[kk], sq, LDK, 16 * ip, 16 * kk, lane);
      mma_pair(dp[0], dp[1], va[kk], sd, LDK, 16 * ip, 16 * kk, lane);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * ip + 8 * hf + 2 * t + (e & 1);
        const bool lo = e < 2;
        const float p =
            i < N && (lo ? v0 : v1) ? exp2_approx(fmaf(s[hf][e], sc2, b[hf][e]) - sl[i]) : 0.f;
        s[hf][e] = p;
        dp[hf][e] = p * (dp[hf][e] - sdl[i]) * sc;  // dcos
      }
    uint32_t pa[4], ca[4];
    to_a(pa, s[0], s[1]);
    to_a(ca, dp[0], dp[1]);
#pragma unroll
    for (int n2 = 0; n2 < HK; ++n2) {
      mma_pair_t(dv[2 * n2], dv[2 * n2 + 1], pa, sd, LDK, 16 * n2, 16 * ip, lane);
      mma_pair_t(dk[2 * n2], dk[2 * n2 + 1], ca, sq, LDK, 16 * n2, 16 * ip, lane);
    }
  }
  const float* ka32 = qk32 + (tw + jc0) * 2 * A + A + h * hd;
  const float* kb32 = qk32 + (tw + jc1) * 2 * A + A + h * hd;
  float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
  for (int j = 0; j < HT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = 8 * j + 2 * t + e;
      if (d < hd) dot0 = fmaf(dk[j][e], ka32[d], dot0), dot1 = fmaf(dk[j][2 + e], kb32[d], dot1);
    }
  dot0 = quad_sum(dot0), dot1 = quad_sum(dot1);
  const float ik0 = inv[(tw + jc0) * 2 * nh + nh + h], ik1 = inv[(tw + jc1) * 2 * nh + nh + h];
#pragma unroll
  for (int j = 0; j < HT; ++j) {
    const int c = 8 * j + 2 * t;
    float k0[2], k1[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = c + e;
      k0[e] = d < hd ? ik0 * (dk[j][e] - ka32[d] * dot0) : 0.f;
      k1[e] = d < hd ? ik1 * (dk[j][2 + e] - kb32[d] * dot1) : 0.f;
      if (d < hd && v0) {
        dqkv[(tw + j0) * 3 * A + A + h * hd + d] = k0[e];
        dqkv[(tw + j0) * 3 * A + 2 * A + h * hd + d] = dv[j][e];
      }
      if (d < hd && v1) {
        dqkv[(tw + j1) * 3 * A + A + h * hd + d] = k1[e];
        dqkv[(tw + j1) * 3 * A + 2 * A + h * hd + d] = dv[j][2 + e];
      }
    }
    if (v0) {
      sts32(dq16 + (tw + j0) * 3 * AP + AP + h * HP + c, pack_bf16(k0[0], k0[1]));
      sts32(dq16 + (tw + j0) * 3 * AP + 2 * AP + h * HP + c, pack_bf16(dv[j][0], dv[j][1]));
    }
    if (v1) {
      sts32(dq16 + (tw + j1) * 3 * AP + AP + h * HP + c, pack_bf16(k1[0], k1[1]));
      sts32(dq16 + (tw + j1) * 3 * AP + 2 * AP + h * HP + c, pack_bf16(dv[j][2], dv[j][3]));
    }
  }
}

// rows [t0, t0 + nr) of src [T][w] bf16 (w a multiple of 8) into s
// [SR][w + 8] by cp.async, zeros for the rows past nr and the columns past w
__device__ __forceinline__ void stage_sums(__nv_bfloat16* s, const __nv_bfloat16* src, int w,
                                           int wp, long t0, int nr) {
  const int c8 = wp / 8;
  for (int c = threadIdx.x; c < SR * c8; c += blockDim.x) {
    const int r = c / c8, i = 8 * (c % c8);
    if (r < nr && i < w)
      cp_async16(s + r * (wp + 8) + i, src + (size_t)(t0 + r) * w + i);
    else
      *reinterpret_cast<uint4*>(s + r * (wp + 8) + i) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Block b of P: the token sums of its share of the rows, SR at a time, into
// its own slot part[b] (BwdLayout): dwqkv = Σ bf16(x)ᵀ·bf16(dqkv) and dwproj
// = Σ bf16(o)ᵀ·bf16(g) as 16x16 tiles dealt to the warps, SUM_TILES a warp
// held in registers over all the block's steps (a round; as many rounds as
// the tiles need), dbqkv += dqkv and dbproj += g a column a thread.  An
// element has one owner thread, which adds the steps in order.
__global__ void __launch_bounds__(GW * 32) sums_tc(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gg,
    const __nv_bfloat16* __restrict__ dq16, const __nv_bfloat16* __restrict__ o16,
    const float* __restrict__ dqkv, float* __restrict__ part, long T, int D, int nh, int hd,
    long OW, long OB, long SUMS) {
  extern __shared__ float4 smem4[];
  const int DP = up(D, 16), HP = up(hd, 16), AP = nh * HP, A = nh * hd;
  const int LDX = DP + 8, LDQ = 3 * AP + 8, LDO = AP + 8;
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sg = sx + SR * LDX;
  __nv_bfloat16* sq = sg + SR * LDX;
  __nv_bfloat16* so = sq + SR * LDQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* slot = part + (size_t)blockIdx.x * SUMS;
  for (int e = tid; e < 3 * A + D; e += blockDim.x) slot[OB + e] = 0.f;
  const int J1 = (DP / 16) * (3 * AP / 16), J = J1 + (AP / 16) * (DP / 16);
  const int per_round = SUM_TILES * GW, rounds = (J + per_round - 1) / per_round;
  const long steps = (T + SR - 1) / SR;
  for (int round = 0; round < rounds; ++round) {
    float acc[SUM_TILES][2][4];
#pragma unroll
    for (int q = 0; q < SUM_TILES; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][0][e] = acc[q][1][e] = 0.f;
    for (long st = blockIdx.x; st < steps; st += gridDim.x) {
      const long t0 = st * SR;
      const int nr = T - t0 < SR ? (int)(T - t0) : SR;
      __syncthreads();  // the last step's reads (and the slot's zeros) are done
      stage_sums(sx, x, D, DP, t0, nr);
      stage_sums(sg, gg, D, DP, t0, nr);
      stage_sums(sq, dq16, 3 * AP, 3 * AP, t0, nr);
      stage_sums(so, o16, AP, AP, t0, nr);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int q = 0; q < SUM_TILES; ++q) {
        const int job = round * per_round + q * GW + warp;
        if (job >= J) break;
        const bool w1 = job < J1;
        const int mi = w1 ? job / (3 * AP / 16) : (job - J1) / (DP / 16);
        const int ni = w1 ? job % (3 * AP / 16) : (job - J1) % (DP / 16);
#pragma unroll
        for (int ks = 0; ks < SR / 16; ++ks) {
          uint32_t a[4];
          load_a_t(a, w1 ? sx : so, w1 ? LDX : LDO, 16 * mi, 16 * ks, lane);
          mma_pair_t(acc[q][0], acc[q][1], a, w1 ? sq : sg, w1 ? LDQ : LDX, 16 * ni, 16 * ks,
                     lane);
        }
      }
      if (round == 0)
        for (int c = tid; c < 3 * A + D; c += blockDim.x) {
          float s = 0.f;
          if (c < 3 * A)
            for (int r = 0; r < nr; ++r) s += dqkv[(t0 + r) * 3 * A + c];
          else
            for (int r = 0; r < nr; ++r) s += __bfloat162float(gg[(t0 + r) * D + c - 3 * A]);
          slot[OB + c] += s;
        }
    }
#pragma unroll
    for (int q = 0; q < SUM_TILES; ++q) {
      const int job = round * per_round + q * GW + warp;
      if (job >= J) break;
      const bool w1 = job < J1;
      const int mi = w1 ? job / (3 * AP / 16) : (job - J1) / (DP / 16);
      const int ni = w1 ? job % (3 * AP / 16) : (job - J1) % (DP / 16);
      const long ld = w1 ? 3 * AP : DP;
      float* dst = slot + (w1 ? 0 : OW) + (long)16 * mi * ld + 16 * ni;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = 8 * hf + 2 * t;
        *reinterpret_cast<float2*>(dst + g * ld + c) = make_float2(acc[q][hf][0], acc[q][hf][1]);
        *reinterpret_cast<float2*>(dst + (g + 8) * ld + c) =
            make_float2(acc[q][hf][2], acc[q][hf][3]);
      }
    }
  }
}

// dparams = [dwqkv D·3A | dbqkv 3A | dscale nh | dbias nh·N·N | dwproj A·D |
// dbproj D]: the token sums from the P slots in block order (their padded
// layout read back to the parameters'), dscale from the rows blocks' shares
// and dbias from the window groups' shares, in order.
__global__ void __launch_bounds__(256) reduce_tc(const float* __restrict__ part,
                                                 const float* __restrict__ dsc,
                                                 const float* __restrict__ dbp,
                                                 float* __restrict__ dparams, int P, long SUMS,
                                                 long OW, long OB, int D, int nh, int hd, int N,
                                                 int RBG, int G) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int A = nh * hd, HP = up(hd, 16), AP = nh * HP, DP = up(D, 16);
  const long E1 = (long)D * 3 * A, E2 = E1 + 3 * A, E3 = E2 + nh, NN = (long)nh * N * N,
             E4 = E3 + NN, E5 = E4 + (long)A * D, E6 = E5 + D;
  if (e >= E6) return;
  float s = 0.f;
  long idx = -1;
  if (e < E1) {
    const int k = (int)(e / (3 * A)), c = (int)(e % (3 * A));
    const int pt = c / A, h = (c % A) / hd, d = c % hd;
    idx = (long)k * 3 * AP + pt * AP + h * HP + d;
  } else if (e < E2) {
    idx = OB + (e - E1);
  } else if (e < E3) {
    const long h = e - E2;
    for (int b = 0; b < RBG; ++b) s += dsc[h * RBG + b];
  } else if (e < E4) {
    const long k = e - E3;
    for (int b = 0; b < G; ++b) s += dbp[b * NN + k];
  } else if (e < E5) {
    const int a = (int)((e - E4) / D), n = (int)((e - E4) % D);
    idx = OW + (long)((a / hd) * HP + a % hd) * DP + n;
  } else {
    idx = OB + 3 * A + (e - E5);
  }
  if (idx >= 0)
    for (int b = 0; b < P; ++b) s += part[(size_t)b * SUMS + idx];
  dparams[e] = s;
}

// w(k, n) of dx = dqkv·wqkvᵀ on the padded dqkv: k = part·AP + h·HP + d ->
// wqkv[n·sk + (part·A + h·hd + d)·sn], zero for d >= hd
struct DxW {
  const float* w;
  long sk, sn;
  int A, AP, hd, HP;
  __device__ __forceinline__ float operator()(int k, int n) const {
    const int pt = k / AP, h = (k % AP) / HP, d = k % HP;
    return d < hd ? __ldg(w + n * sk + (long)(pt * A + h * hd + d) * sn) : 0.f;
  }
};

// K4's tensor-core long-window body on the forward's operands (p as
// tmar_window_attention_bwd takes them), its lse and g; the workspace
// holds bwd_workspace floats.  Seven launches: the recompute, dacc, the
// rows pass, the columns pass, dx, the token sums and the reduce.
inline int bwd(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* dx, float* ws,
               float* dparams, int nwin, int N, int D, int nh, int hd, int wh, int ww,
               cudaStream_t s) {
  if (!attn_plan_bytes(N, D, nh, hd, true) || !ws ||
      (((uintptr_t)p[0] | (uintptr_t)p[1] | (uintptr_t)dx | (uintptr_t)ws) & 15))
    return (int)cudaErrorInvalidValue;
  const Geom g = geom(N, D, nh, hd);
  const BwdLayout L = bwd_layout(nwin, N, D, nh, hd);
  char* base = reinterpret_cast<char*>(ws);
  __nv_bfloat16* qkv = reinterpret_cast<__nv_bfloat16*>(base + L.qkv);
  float* qk32 = reinterpret_cast<float*>(base + L.qk32);
  float* inv = reinterpret_cast<float*>(base + L.inv);
  __nv_bfloat16* dacc = reinterpret_cast<__nv_bfloat16*>(base + L.dacc);
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(base + L.o);
  float* dqkv = reinterpret_cast<float*>(base + L.dqkv);
  __nv_bfloat16* dq16 = reinterpret_cast<__nv_bfloat16*>(base + L.dq16);
  float* delta = reinterpret_cast<float*>(base + L.delta);
  float* dsc = reinterpret_cast<float*>(base + L.dsc);
  float* dbp = reinterpret_cast<float*>(base + L.dbp);
  float* part = reinterpret_cast<float*>(base + L.part);
  const __nv_bfloat16 *x = (const __nv_bfloat16*)p[0], *gg = (const __nv_bfloat16*)p[1];
  const float *wqkv = (const float*)p[2], *bqkv = (const float*)p[3], *scale = (const float*)p[4],
              *wproj = (const float*)p[6], *lse = (const float*)p[9];
  const long T = L.T;
  int err = launch_heads(RowsBf16{x, D}, MatF{wqkv, wq_k, wq_n}, bqkv, qkv, qk32, inv, T, g, 3, 2, s);
  if (!err)
    err = launch_heads(RowsBf16{gg, D}, MatF{wproj, wp_n, wp_k}, nullptr, dacc, nullptr, nullptr, T,
                       g, 1, 0, s);
  if (err) return err;
  const DenseBias2 bias{(const float*)p[5], (const float*)p[7], (const float*)p[8], N, wh, ww,
                        nullptr, false, false};
  const bool staged = rows_staged(g);
  const size_t rb = rows_bytes(g, staged), cb = cols_bytes(g);
  cudaError_t e = cudaSuccess;
#define TMAR_K4_HK(HKV)                                                                          \
  {                                                                                              \
    auto kr = rows_tc<HKV>;                                                                      \
    auto kc = cols_tc<HKV>;                                                                      \
    if ((e = cudaFuncSetAttribute(kr, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rb)) !=  \
            cudaSuccess ||                                                                       \
        (e = cudaFuncSetAttribute(kc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cb)) !=  \
            cudaSuccess)                                                                         \
      return (int)e;                                                                             \
    kr<<<dim3(L.RB, nh, L.G), RW * 32, rb, s>>>(qkv, qk32, inv, dacc, lse, scale, bias, o, dqkv,  \
                                                 dq16, delta, dsc, dbp, nwin, N, nh, hd, staged); \
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;                                  \
    kc<<<dim3(L.CB, nh, nwin), CW * 32, cb, s>>>(qkv, qk32, inv, dacc, lse, delta, scale, bias,  \
                                                  dqkv, dq16, N, nh, hd);                        \
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;                                  \
    break;                                                                                       \
  }
  switch (g.HK) {
    case 1: TMAR_K4_HK(1)
    case 2: TMAR_K4_HK(2)
    case 3: TMAR_K4_HK(3)
    default: TMAR_K4_HK(4)
  }
#undef TMAR_K4_HK
  err = launch_proj(dq16, 3 * g.AP, DxW{wqkv, wq_k, wq_n, g.A, g.AP, hd, g.HP}, nullptr,
                    (__nv_bfloat16*)dx, T, D, s);
  if (err) return err;
  const size_t sb = sums_bytes(g);
  if ((e = cudaFuncSetAttribute(sums_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sb)) !=
      cudaSuccess)
    return (int)e;
  sums_tc<<<L.P, GW * 32, sb, s>>>(x, gg, dq16, o, dqkv, part, T, D, nh, hd, L.OW, L.OB, L.SUMS);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long n = (long)D * 3 * g.A + 3 * g.A + nh + (long)nh * N * N + (long)g.A * D + D;
  reduce_tc<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, dsc, dbp, dparams, L.P, L.SUMS, L.OW,
                                                        L.OB, D, nh, hd, N, L.RB * L.G, L.G);
  return (int)cudaGetLastError();
}

}  // namespace long_mma
}  // namespace
