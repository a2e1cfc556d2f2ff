// The plan and the body rule of K3's and K4's bfloat16 generic bodies on
// Hopper's tensor cores (window_attention_fwd.cu: window_attention_fwd_gmma,
// window_attention_bwd.cu: window_attention_bwd_gmma and
// attention_param_sums_g), and the device pieces both take.
//
// Which geometries.  Windows of 32 to 64 tokens at bfloat16, where the JAX
// kernels (_attn_kernel_batched, _attn_bwd_kernel_batched with cot_bf16)
// round q_n, k_n, v, P and every cotangent product's operands to bf16, so
// that mma.sync.m16n8k16 (bf16 in, f32 accumulate) rounds where they do.
// Below 32 tokens (the n-gram windows) _attn_kernel keeps q_n, k_n and P
// in float32: those windows take the short-window bodies (below), float32
// everywhere stays on the CUDA-core generic bodies.  The full-width
// NGswin's geometries keep their own bodies (its n-gram windows too: the
// templated bodies measured faster there at bfloat16).
// `body` is the rule; tmar_torch/ops/envelope.py: attention_body is the
// same rule, and a query of each built source holds them equal.
//
// Layout.  Only what the fragment arrays need is fixed at compile time: D
// padded to 16 up to DM (32, 64 or 128) and head_dim padded to HP (16 or
// 32), with zeros in the staged weights and biases.  A window of N tokens
// is padded to NP = 16·ceil(N / 16) rows, taken by WW = NP / 16 warps (a
// warp owns 16 rows), and a block of 8 warps takes G = 8 / WW windows at a
// time.  Padded keys leave the softmax (-inf), padded rows are never stored.
// The weights are staged in bf16 from the float32 parameters, [in][out]
// with rows padded by 16 bytes: all heads at once ("resident") where they
// fit, else one head's q/k/v columns and projection rows at a time
// ("streamed"), between two block barriers.  The float32 relative-position
// bias [nh, N, N] and the shift mask are read from device memory (L1).

#pragma once

#include <stdint.h>

#include "long_mma.cuh"
#include "window_attention_geometries.cuh"
#include "window_attention_mma.cuh"

namespace {
namespace attn_mma {

constexpr int WARPS = 8;      // warps of a block
constexpr int MIN_N = 32;     // the shortest window the bodies take
constexpr int MAX_D = 128;    // the widest D their fragment arrays take
constexpr int SUMS_TILES = 4;  // 16x16 cotangent tiles a token-sum warp holds

// The bodies of K3 and K4 (envelope.py: ATTENTION_BODIES, in this order).
enum Body {
  FLAGSHIP = 0,
  TEMPLATED = 1,
  TENSOR_CORE = 2,
  CUDA_CORE = 3,
  SHORT = 4,
  LONG = 5,
  LONG_TC = 6
};

__host__ __device__ inline int up(int n, int m) { return (n + m - 1) / m * m; }

// The CUDA-core generic bodies' shared memory with heads taken hg at a time
// (window_attention_fwd.cu's and _bwd.cu's rt_bytes; envelope.py:
// attention_fwd_bytes, attention_bwd_bytes): K3's x, one group's q/k/v and
// all heads' outputs of a 64-row tile; K4's x, g and dx, one group's q/k/v
// and their cotangents, dacc and the outputs, five values per row and head,
// and with several windows to a tile the group's ds per window.
inline size_t generic_fwd_bytes(int D, int nh, int hd, int hg) {
  return (size_t)4 * tmar::ROWS * ((D + 1) + (3 * hg * hd + 1) + (nh * hd + 1));
}
inline size_t generic_bwd_bytes(int N, int D, int hd, int hg) {
  const int G = hg * hd, wpb = tmar::ROWS / N, R = tmar::ROWS;
  return 4 * ((size_t)3 * R * (D + 1) + (size_t)R * (2 * (3 * G + 1) + 2 * (G + 1)) +
              (size_t)R * 5 * hg + (wpb > 1 ? (size_t)hg * wpb * N * N : 0));
}
// Whether the CUDA-core generic bodies take windows of N <= 64 tokens at
// (D, heads of hd <= 32): one head's tile of K3 and of K4 fits a block
// (envelope.py: attention_generic_fits).
inline bool generic_fits(int N, int D, int nh, int hd) {
  return generic_fwd_bytes(D, nh, hd, 1) <= tmar::MAX_SMEM &&
         generic_bwd_bytes(N, D, hd, 1) <= tmar::MAX_SMEM;
}

// The padded geometry: D to DP, head_dim to HP, the heads to AP = nh·HP
// columns, the window to NP rows of WW warps.
struct Geom {
  int N, D, nh, hd, A, DP, dk, HP, AP, NP, WW, LDK;
};

inline Geom geom(int N, int D, int nh, int hd) {
  Geom g;
  g.N = N, g.D = D, g.nh = nh, g.hd = hd, g.A = nh * hd;
  g.DP = up(D, 16), g.dk = g.DP / 16;
  g.HP = hd <= 16 ? 16 : 32, g.AP = nh * g.HP;
  g.NP = up(N, 16), g.WW = g.NP / 16;
  g.LDK = g.HP + 8;
  return g;
}

// Weights staged in bf16, [in][out]: wqkv [DP][ld_qkv] (3·AP columns
// resident, one head's 3·HP streamed) and wproj [rows][ld_proj] (AP rows
// resident, HP streamed).
struct Weights {
  int resident, ld_qkv, ld_proj, w_proj, elems;
};

inline Weights weights(const Geom& g, bool resident) {
  Weights w;
  w.resident = resident;
  w.ld_qkv = (resident ? 3 * g.AP : 3 * g.HP) + 8;
  w.ld_proj = g.DP + 8;
  w.w_proj = g.DP * w.ld_qkv;
  w.elems = w.w_proj + (resident ? g.AP : g.HP) * w.ld_proj;
  return w;
}

// K3's launch: float32 bqkv [3AP], bproj [DP], scale·log2e [nh]; the
// weights; per window group two head buffers of k_n and v [NP][LDK].
struct FwdPlan {
  Geom g;
  Weights w;
  int G, threads;
  int f_bqkv, f_bproj, f_scale, floats, gelems;
  size_t bytes;
};

inline FwdPlan make_fwd(const Geom& g, bool resident) {
  FwdPlan P;
  P.g = g, P.w = weights(g, resident);
  P.G = WARPS / g.WW, P.threads = 32 * g.WW * P.G;
  P.f_bqkv = 0, P.f_bproj = 3 * g.AP, P.f_scale = P.f_bproj + g.DP;
  P.floats = up(P.f_scale + g.nh, 4);  // the bf16 region starts on 16 bytes
  P.gelems = 4 * g.NP * g.LDK;
  P.bytes = (size_t)4 * P.floats + (size_t)2 * (P.w.elems + P.G * P.gelems);
  return P;
}

// K4's per-window launch: float32 bqkv [3AP], the scale [nh], each warp's
// sums of dbqkv [3AP] and dscale [nh]; the weights; per window group its x
// and g tiles [NP][LDX] (two slots where `dbuf`), q_n and dacc [NP][LDK]
// double-buffered by head, k_n and v [NP][LDK], P and dcos [NP][LDS].
struct BwdPlan {
  Geom g;
  Weights w;
  int G, threads, dbuf, LDX, LDS;
  int f_bqkv, f_scale, f_dbq, f_dsc, floats;
  int o_qn, o_da, o_kn, o_v, o_p, o_dc, gelems;
  size_t bytes;
};

inline BwdPlan make_bwd(const Geom& g, int G, bool resident, bool dbuf) {
  BwdPlan P;
  P.g = g, P.w = weights(g, resident);
  P.G = G, P.threads = 32 * g.WW * G, P.dbuf = dbuf;
  P.LDX = g.DP + 8, P.LDS = g.NP + 8;
  const int warps = g.WW * G;
  P.f_bqkv = 0, P.f_scale = 3 * g.AP, P.f_dbq = P.f_scale + g.nh;
  P.f_dsc = P.f_dbq + warps * 3 * g.AP;
  P.floats = up(P.f_dsc + warps * g.nh, 4);
  const int T = g.NP * g.LDK;
  P.o_qn = (dbuf ? 2 : 1) * 2 * g.NP * P.LDX;
  P.o_da = P.o_qn + 2 * T, P.o_kn = P.o_da + 2 * T, P.o_v = P.o_kn + T;
  P.o_p = P.o_v + T, P.o_dc = P.o_p + g.NP * P.LDS;
  P.gelems = P.o_dc + g.NP * P.LDS;
  P.bytes = (size_t)4 * P.floats + (size_t)2 * (P.w.elems + G * P.gelems);
  return P;
}

// K4's token sums: one 64-row step of x and g [64][LDX], dqkv [64][LQ] and
// the attention output [64][LA], bf16, two steps where `dbuf`.
struct SumsPlan {
  int dbuf, LDX, LQ, LA, o_g, o_q, o_a, buf;
  size_t bytes;
};

inline SumsPlan make_sums(const Geom& g, bool dbuf) {
  SumsPlan S;
  S.dbuf = dbuf, S.LDX = g.DP + 8, S.LQ = 3 * g.AP + 8, S.LA = g.AP + 8;
  S.o_g = 64 * S.LDX, S.o_q = S.o_g + 64 * S.LDX, S.o_a = S.o_q + 64 * S.LQ;
  S.buf = S.o_a + 64 * S.LA;
  S.bytes = (size_t)(dbuf ? 2 : 1) * S.buf * 2;
  return S;
}

struct Plan {
  FwdPlan f;
  BwdPlan b;
  SumsPlan s;
};

// The plan of windows of N tokens at (D, heads, head_dim) (envelope.py:
// attention_mma_plan is the same search): false where the bodies take none
// (a window outside 32..64 tokens, D not a multiple of 8 or past 128,
// head_dim past 32, what fits no block).  K3: resident weights where they
// fit, else streamed.  K4: the most window groups that fit, at that count
// resident weights and double-buffered tiles where they fit, in that
// order.  The token sums: double-buffered where they fit.
inline bool plan(int N, int D, int nh, int hd, Plan* P) {
  if (N < MIN_N || N > tmar::ROWS || D < 8 || D > MAX_D || D % 8 || hd < 1 || hd > 32 || nh < 1)
    return false;
  const Geom g = geom(N, D, nh, hd);
  P->f = make_fwd(g, true);
  if (P->f.bytes > tmar::MAX_SMEM) {
    P->f = make_fwd(g, false);
    if (P->f.bytes > tmar::MAX_SMEM) return false;
  }
  bool found = false;
  for (int G = WARPS / g.WW; G >= 1 && !found; --G)
    for (int c = 0; c < 4 && !found; ++c) {
      P->b = make_bwd(g, G, c < 2, c % 2 == 0);
      found = P->b.bytes <= tmar::MAX_SMEM;
    }
  if (!found) return false;
  P->s = make_sums(g, true);
  if (P->s.bytes > tmar::MAX_SMEM) {
    P->s = make_sums(g, false);
    if (P->s.bytes > tmar::MAX_SMEM) return false;
  }
  return true;
}

// ---- the short-window body: bfloat16 windows of 1 to 31 tokens -------------
// (window_attention_fwd.cu: window_attention_fwd_smma; window_attention_bwd.cu:
// window_attention_bwd_smma.)  Below 32 tokens the JAX kernels (_attn_kernel,
// _attn_bwd_kernel) round only the projections' operands: x and wqkv in
// qkv = x·wqkv, the head outputs and wproj in the output projection; q_n,
// k_n, v, P, the scores and every cotangent stay float32.  So mma.sync takes
// those two products (exact bf16 operands, float32 accumulation) and the
// attention core runs in float32 on the CUDA cores, from a warp's own slice
// of shared memory.
//
// Layout.  A warp owns a unit of R = 16·F rows (F = 1 up to 16 tokens, 2
// above) holding WPU = R / N whole windows (rows WPU·N .. R - 1 padded), so
// that no window crosses a warp and the attention core needs no barrier
// wider than the warp.  D is padded to DP (16), head_dim to HP (8, 16 or
// 32), the heads' columns to APP = 16·ceil(nh·HP / 16); the weights are
// staged once per persistent block in bf16, wqkv [DP][3·APP + 8] (column
// part·APP + h·HP + d) and wproj [APP][DP + 8] (row h·HP + d), zero in the
// padding.  A warp's x rows come to shared memory by cp.async; q, k, v are
// computed max(16, HP) columns (one or two whole heads) at a time, so that
// a head's normalisation stays inside one chunk of registers.
// The short-window kernels' compile-time width: head_dim padded to 8, 16 or
// 32 (every other width is a run-time loop bound).
#define TMAR_SHORT_WIDTHS(X) X(8) X(16) X(32)

struct Short {
  int N, D, nh, hd, A, DP, dk, HP, AP, APP, F, R, WPU, RU;
  int LQW, LPW, w_proj, welems;  // bf16 weights: wqkv [DP][LQW], then wproj [APP][LPW]
  int raw;  // the float32 parameters as read, before staging (stage_short)
};

inline Short short_geom(int N, int D, int nh, int hd) {
  Short s;
  s.N = N, s.D = D, s.nh = nh, s.hd = hd, s.A = nh * hd;
  s.DP = up(D, 16), s.dk = s.DP / 16;
  s.HP = hd <= 8 ? 8 : hd <= 16 ? 16 : 32;
  s.AP = nh * s.HP, s.APP = up(s.AP, 16);
  s.F = N <= 16 ? 1 : 2, s.R = 16 * s.F, s.WPU = s.R / N, s.RU = s.WPU * N;
  s.LQW = 3 * s.APP + 8, s.LPW = s.DP + 8;
  s.w_proj = s.DP * s.LQW;
  s.welems = s.w_proj + s.APP * s.LPW;
  s.raw = D * 3 * s.A + s.A * D + 3 * s.A + D + nh + (nh + 2) * N * N;
  return s;
}

// K3's launch: W warps a block.  float32 bqkv [3·APP], bproj [DP], the
// scale [nh], the relative-position bias [nh][N][N] and the shift mask's
// rows and columns [2][N][N]; the bf16 weights; per warp the head outputs
// O in bf16 [R][APP + 8] (the projection's A operand, by ldmatrix), its x
// rows in bf16 [R][DP + 8] (cp.async), and q_n | k_n | v in float32
// [R][3·APP + 1].  The warps' regions first hold the raw parameters while
// the block stages them (at least s.raw floats).
struct ShortFwd {
  Short s;
  int W, threads, f_bqkv, f_bproj, f_scale, f_bias, f_mask, floats, LO, LX, LQ;
  size_t warp_bytes, bytes;
};

inline ShortFwd make_short_fwd(const Short& s, int W) {
  ShortFwd P;
  P.s = s, P.W = W, P.threads = 32 * W;
  const int NN = s.N * s.N;
  P.f_bqkv = 0, P.f_bproj = 3 * s.APP, P.f_scale = P.f_bproj + s.DP;
  P.f_bias = up(P.f_scale + s.nh, 4), P.f_mask = up(P.f_bias + s.nh * NN, 4);
  P.floats = up(P.f_mask + 2 * NN, 4);
  P.LO = s.APP + 8, P.LX = s.DP + 8, P.LQ = 3 * s.APP + 1;
  P.warp_bytes = (size_t)2 * s.R * (P.LO + P.LX) + (size_t)4 * s.R * P.LQ;
  const size_t warps = (size_t)W * P.warp_bytes, raw = (size_t)4 * up(s.raw, 4);
  P.bytes = (size_t)4 * P.floats + (size_t)2 * s.welems + (warps > raw ? warps : raw);
  return P;
}

// K4's launch: W warps a block take a tile of W units (BR = W·R rows).  In
// float32, each region on 16 bytes: bqkv [3·APP], the scale [nh], the bias
// [nh][N][N] and the shift mask [2][N][N]; the
// block's sums dwqkv [DP][3·APP], dwproj [APP][DP], dbqkv [3·APP], dbproj
// [DP], dscale [nh], dbias [nh·N·N]; the tile's dqkv [BR][LD3], attention
// output [BR][LDO], dscale shares [BR][nh] and ds per window
// [W·WPU][nh·N·N]; per warp q_n | k_n | v [R][3·APP + 1], dacc [R][APP + 1]
// and per row and head 1/|q|, 1/|k|, lse, delta [R][4·nh] (from the tile's
// dqkv on, the raw parameters while the block stages them: at least s.raw
// floats).  Then in bf16 the weights and the tile's x and g [BR][DP + 8].
struct ShortBwd {
  Short s;
  int W, threads, BR, LD3, LDO, LQ, LA, LX;
  int f_bqkv, f_scale, f_bias, f_mask, a_w, a_p, a_bq, a_bp, a_sc, a_bi, f_dq, f_o, f_dsc,
      f_dsb, f_warp;
  int w_dacc, w_stat, warp_floats, floats, b_x, b_g, belems;
  size_t bytes;
};

inline ShortBwd make_short_bwd(const Short& s, int W) {
  ShortBwd P;
  P.s = s, P.W = W, P.threads = 32 * W, P.BR = W * s.R;
  P.LD3 = 3 * s.APP + 1, P.LDO = s.APP + 1;  // odd: a lane a row, no bank conflicts
  P.LQ = 3 * s.APP + 1, P.LA = s.APP + 1, P.LX = s.DP + 8;
  const int NN = s.nh * s.N * s.N;
  int o = 0;
  auto take = [&o](int n) {
    const int at = o;
    o = up(o + n, 4);
    return at;
  };
  P.f_bqkv = take(3 * s.APP), P.f_scale = take(s.nh);
  P.f_bias = take(NN), P.f_mask = take(2 * s.N * s.N);
  P.a_w = take(s.DP * 3 * s.APP), P.a_p = take(s.APP * s.DP), P.a_bq = take(3 * s.APP);
  P.a_bp = take(s.DP), P.a_sc = take(s.nh), P.a_bi = take(NN);
  P.f_dq = take(P.BR * P.LD3), P.f_o = take(P.BR * P.LDO), P.f_dsc = take(P.BR * s.nh);
  P.f_dsb = take(W * s.WPU * NN);
  P.w_dacc = up(s.R * P.LQ, 4), P.w_stat = P.w_dacc + up(s.R * P.LA, 4);
  P.warp_floats = up(P.w_stat + s.R * 4 * s.nh, 4);
  P.f_warp = take(W * P.warp_floats);
  P.floats = o > P.f_dq + up(s.raw, 4) ? o : P.f_dq + up(s.raw, 4);
  P.b_x = s.welems, P.b_g = P.b_x + P.BR * P.LX, P.belems = P.b_g + P.BR * P.LX;
  P.bytes = (size_t)4 * P.floats + (size_t)2 * P.belems;
  return P;
}

// The short-window plan of windows of N tokens at (D, heads, head_dim)
// (envelope.py: attention_short_plan is the same search): false where the
// body takes none (N outside 1..31, D not a multiple of 8 or past 128,
// head_dim past 32, what fits no block).  Each launch takes the most warps
// of 4, 2, 1 whose block fits.
inline bool short_plan(int N, int D, int nh, int hd, ShortFwd* f, ShortBwd* b) {
  if (N < 1 || N >= MIN_N || D < 8 || D > MAX_D || D % 8 || hd < 1 || hd > 32 || nh < 1)
    return false;
  const Short s = short_geom(N, D, nh, hd);
  bool ok = false;
  for (int W = 4; W >= 1 && !ok; W /= 2) {
    *f = make_short_fwd(s, W);
    ok = f->bytes <= tmar::MAX_SMEM;
  }
  if (!ok) return false;
  ok = false;
  for (int W = 4; W >= 1 && !ok; W /= 2) {
    *b = make_short_bwd(s, W);
    ok = b->bytes <= tmar::MAX_SMEM;
  }
  return ok;
}

// Which body runs a window, by geometry and I/O type alone (envelope.py:
// attention_body): bfloat16 at the full-width NGswin's 64-token windows the
// flagship bodies; its other geometries (its windows at float32, its n-gram
// windows at both types: at bfloat16 the templated body measured faster
// there than the short-window body, PERF.md §6) the bodies templated on
// the geometry; bfloat16 windows shorter than 32 tokens the short-window
// bodies wherever they have a plan; bfloat16 windows of 32 to 64 tokens
// the tensor-core generic bodies wherever they have a plan; the rest the
// CUDA-core generic bodies.  Windows of more than 64 tokens and heads wider
// than 32 channels, which none of those take, the long-window bodies
// (window_attention_long.cuh) at either type: bfloat16 the tensor-core one
// wherever it has a plan; so too where the CUDA-core generic bodies would
// run but one head's tile fits no block (generic_fits).
inline Body body(int N, int D, int nh, int hd, int is_bf16) {
  const Body lng = is_bf16 && long_mma::attn_plan_bytes(N, D, nh, hd, true) ? LONG_TC : LONG;
  if (N > tmar::ROWS || hd > 32) return lng;
  if (is_bf16 && N == 64 && D == 64 && ((nh == 6 && hd == 10) || (nh == 4 && hd == 16)))
    return FLAGSHIP;
#define TMAR_TEMPLATED(NN, DD, NH, HD) \
  if (N == NN && D == DD && nh == NH && hd == HD) return TEMPLATED;
  TMAR_ATTN_WINDOW_GEOMETRIES(TMAR_TEMPLATED)
  TMAR_ATTN_NGRAM_GEOMETRIES(TMAR_TEMPLATED)
#undef TMAR_TEMPLATED
  if (is_bf16 && N < MIN_N) {
    ShortFwd f;
    ShortBwd b;
    if (short_plan(N, D, nh, hd, &f, &b)) return SHORT;
  }
  Plan P;
  if (is_bf16 && plan(N, D, nh, hd, &P)) return TENSOR_CORE;
  return generic_fits(N, D, nh, hd) ? CUDA_CORE : lng;
}

// The barrier of one window's warps (named barrier 1 + group).
__device__ __forceinline__ void group_sync(int grp, int WW) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "r"(32 * WW) : "memory");
}

// Stage the bf16 weights of heads [h0, h1) into the region `sw` as `w`
// lays it out (resident: each head at its own columns and rows; streamed:
// at the first), from the float32 parameters read as wqkv[k·wq_k + n·wq_n]
// and wproj[k·wp_k + n·wp_n].  The padding stays as it was (zero).
__device__ __forceinline__ void stage_weights(__nv_bfloat16* sw, const Weights& w, const Geom& g,
                                              int h0, int h1, const float* __restrict__ wqkv,
                                              int wq_k, int wq_n, const float* __restrict__ wproj,
                                              int wp_k, int wp_n, int tid, int nthreads) {
  const int hd = g.hd, nhs = h1 - h0, per = 3 * hd;
  for (int e = tid; e < g.D * nhs * per; e += nthreads) {
    const int k = e / (nhs * per), r = e % (nhs * per), h = h0 + r / per, o = r % per;
    const int part = o / hd, d = o % hd;
    const int col = w.resident ? part * g.AP + h * g.HP + d : part * g.HP + d;
    sw[k * w.ld_qkv + col] = __float2bfloat16(
        __ldg(wqkv + (size_t)k * wq_k + (size_t)(part * g.A + h * hd + d) * wq_n));
  }
  for (int e = tid; e < nhs * hd * g.D; e += nthreads) {
    const int i = e / g.D, c = e % g.D, h = h0 + i / hd, d = i % hd;
    const int row = w.resident ? h * g.HP + d : d;
    sw[w.w_proj + row * w.ld_proj + c] =
        __float2bfloat16(__ldg(wproj + (size_t)(h * hd + d) * wp_k + (size_t)c * wp_n));
  }
}

// The logit of the thread's key c (< N: in log2 units, cosine `cs` times
// sc2 plus the bias and the gated mask; past N: -inf) for query row q (a
// real row; a padded row reads row 0's and is never stored).
__device__ __forceinline__ float logit2(float cs, float sc2, const float* __restrict__ bias_h,
                                        const float* __restrict__ mrow,
                                        const float* __restrict__ mcol, bool gr, bool gc, int N,
                                        int q, int c) {
  if (c >= N) return -INFINITY;
  float v = fmaf(cs, sc2, __ldg(bias_h + q * N + c) * LOG2E);
  if (gr) v = fmaf(__ldg(mrow + q * N + c), LOG2E, v);
  if (gc) v = fmaf(__ldg(mcol + q * N + c), LOG2E, v);
  return v;
}

// (a, b) as three bf16 pairs whose sum is (a, b) to float32's precision:
// hi = bf16(a), mid = bf16(a - hi), lo = bf16(a - hi - mid), each packed as
// an mma.sync operand register (a in the low half).  Each part times an
// exact bf16 operand is exact in float32, so three mma.sync accumulate a
// float32 operand's product with a bf16 one.
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const float ra = a - hf.x, rb = b - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(ra - mf.x, rb - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Where the short-window bodies stage the parameters: the bf16 weights and
// float32 regions of shared memory for bqkv [3·APP] (the weights' column
// order, zero in the padding), bproj [DP] (K3 only: null in K4), the scale
// [nh], the bias [nh][N][N] and the shift mask's rows and columns [2][N][N]
// (read only with a mask).
struct ShortStage {
  __nv_bfloat16* w;
  float *bqkv, *bproj, *scale, *bias, *mask;
};

// Stage every parameter the short-window bodies read, from the float32
// parameters (wqkv[k·wq_k + n·wq_n], wproj[k·wp_k + n·wp_n]).  First every
// value as it is by 4-byte cp.async into `raw` (s.raw floats of shared
// memory the kernel uses later for other things), all in flight at once,
// so that the block waits for one round trip to device memory; then, from
// shared memory, each into its place (bf16 for the matrices).  The
// padding stays as it was (zero).  Rolled loops without division in their
// bodies: the code runs once per block, from a cold instruction cache.
// Ends with a block barrier.
__device__ __forceinline__ void stage_short(const ShortStage& st, const Short& s, float* raw,
                                            const float* __restrict__ wqkv, int wq_k, int wq_n,
                                            const float* __restrict__ wproj, int wp_k, int wp_n,
                                            const float* __restrict__ bqkv,
                                            const float* __restrict__ bproj,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ bias,
                                            const float* __restrict__ mrow,
                                            const float* __restrict__ mcol, int wh, int tid,
                                            int nthreads) {
  const int A = s.A, A3 = 3 * A, D = s.D, hd = s.hd, NN = s.N * s.N;
  float* r_p = raw + D * A3;      // wproj [A][D]
  float* r_b = r_p + A * D;       // bqkv [3A], bproj [D], scale [nh], bias, mask rows, columns
  const int nb = A3 + D + s.nh + s.nh * NN, nsmall = nb + (wh > 0 ? 2 * NN : 0);
#pragma unroll 1
  for (int n = tid; n < A3; n += nthreads)
#pragma unroll 1
    for (int k = 0; k < D; ++k) cp_async4(raw + k * A3 + n, wqkv + (size_t)k * wq_k + (size_t)n * wq_n);
#pragma unroll 1
  for (int c = tid; c < D; c += nthreads)
#pragma unroll 1
    for (int a = 0; a < A; ++a) cp_async4(r_p + a * D + c, wproj + (size_t)a * wp_k + (size_t)c * wp_n);
#pragma unroll 1
  for (int e = tid; e < nsmall; e += nthreads) {
    const float* src = e < A3                 ? bqkv + e
                       : e < A3 + D           ? (bproj ? bproj + e - A3 : bqkv)
                       : e < A3 + D + s.nh    ? scale + e - A3 - D
                       : e < nb               ? bias + e - A3 - D - s.nh
                       : e < nb + NN          ? mrow + e - nb
                                              : mcol + e - nb - NN;
    cp_async4(r_b + e, src);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
#pragma unroll 1
  for (int n = tid; n < A3; n += nthreads) {
    const int part = n / A, h = (n - part * A) / hd, col = part * s.APP + h * s.HP + n - part * A - h * hd;
#pragma unroll 1
    for (int k = 0; k < D; ++k) st.w[k * s.LQW + col] = __float2bfloat16(raw[k * A3 + n]);
    st.bqkv[col] = r_b[n];
  }
#pragma unroll 1
  for (int a = tid; a < A; a += nthreads) {
    const int h = a / hd;
    __nv_bfloat16* row = st.w + s.w_proj + (h * s.HP + a - h * hd) * s.LPW;
#pragma unroll 1
    for (int c = 0; c < D; ++c) row[c] = __float2bfloat16(r_p[a * D + c]);
  }
#pragma unroll 1
  for (int e = tid; e < nsmall - A3; e += nthreads) {
    const float v = r_b[A3 + e];
    if (e < D) {
      if (st.bproj) st.bproj[e] = v;
    } else if (e < D + s.nh) {
      st.scale[e - D] = v;
    } else if (e < nb - A3) {
      st.bias[e - D - s.nh] = v;
    } else {
      st.mask[e - (nb - A3)] = v;
    }
  }
  __syncthreads();
}

// A warp's `rows` real rows of a bf16 matrix with D columns (from row row0
// of src) into shared memory [R][ld] by cp.async, 16 bytes a copy; zero in
// the rows past `rows` and the columns [D, DP).  Waits for its copies.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* __restrict__ src, long row0,
                                          int rows, const Short& s, int lane) {
  const int C = s.DP / 8;
  for (int e = lane; e < s.R * C; e += 32) {
    const int r = e / C, c = 8 * (e - r * C);
    if (r < rows && c < s.D)
      cp_async16(dst + r * ld + c, src + (row0 + r) * s.D + c);
    else
      *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncwarp();
}

// q, k and v of one 16-row fragment (from row f0 of the warp's x rows xs,
// [R][ld] bf16) at the chunk of CWD columns from c0 of each part
// (acc[part][tile]) = x · wqkv + bqkv; q and k L2-normalised per head (HPD
// columns), their 1 / (|row| + 1e-12) in inv[part][head][row g, g + 8].
template <int HPD, int CWD>
__device__ __forceinline__ void short_qkv(float (&acc)[3][CWD / 8][4],
                                          float (&inv)[2][CWD / HPD][2],
                                          const __nv_bfloat16* xs, int ld, int f0,
                                          const __nv_bfloat16* sw, const Short& s,
                                          const float* sbq, int c0, int lane) {
  constexpr int CT = CWD / 8, HT = HPD / 8;
  const int t = lane & 3;
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[p][j][0] = acc[p][j][1] = acc[p][j][2] = acc[p][j][3] = 0.f;
  for (int kk = 0; kk < s.dk; ++kk) {
    uint32_t xa[4];
    load_a(xa, xs, ld, f0, 16 * kk, lane);
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int n2 = 0; n2 < CT / 2; ++n2)
        mma_pair_t(acc[p][2 * n2], acc[p][2 * n2 + 1], xa, sw, s.LQW, p * s.APP + c0 + 16 * n2,
                   16 * kk, lane);
  }
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const float* bq = sbq + p * s.APP + c0 + 8 * j + 2 * t;
      acc[p][j][0] += bq[0], acc[p][j][1] += bq[1], acc[p][j][2] += bq[0], acc[p][j][3] += bq[1];
    }
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int hh = 0; hh < CWD / HPD; ++hh) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = hh * HT; j < (hh + 1) * HT; ++j) {
        s0 += acc[p][j][0] * acc[p][j][0] + acc[p][j][1] * acc[p][j][1];
        s1 += acc[p][j][2] * acc[p][j][2] + acc[p][j][3] * acc[p][j][3];
      }
      const float i0 = 1.f / (sqrtf(quad_sum(s0)) + 1e-12f);
      const float i1 = 1.f / (sqrtf(quad_sum(s1)) + 1e-12f);
      inv[p][hh][0] = i0, inv[p][hh][1] = i1;
#pragma unroll
      for (int j = hh * HT; j < (hh + 1) * HT; ++j)
        acc[p][j][0] *= i0, acc[p][j][1] *= i0, acc[p][j][2] *= i1, acc[p][j][3] *= i1;
    }
}

// Rows ra and ra + 8 of accumulator tile v, columns col and col + 1, into a
// float32 array with row stride ld.
__device__ __forceinline__ void store_tile_f32(float* m, int ld, int ra, int col,
                                               const float (&v)[4]) {
  m[ra * ld + col] = v[0], m[ra * ld + col + 1] = v[1];
  m[(ra + 8) * ld + col] = v[2], m[(ra + 8) * ld + col + 1] = v[3];
}

}  // namespace attn_mma
}  // namespace
