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
// in float32: those, and float32 everywhere, stay on the CUDA-core generic
// bodies.  The full-width NGswin's geometries keep their own bodies.
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

#include "window_attention_geometries.cuh"
#include "window_attention_mma.cuh"

namespace {
namespace attn_mma {

constexpr int WARPS = 8;      // warps of a block
constexpr int MIN_N = 32;     // the shortest window the bodies take
constexpr int MAX_D = 128;    // the widest D their fragment arrays take
constexpr int SUMS_TILES = 4;  // 16x16 cotangent tiles a token-sum warp holds

// The bodies of K3 and K4 (envelope.py: ATTENTION_BODIES, in this order).
enum Body { FLAGSHIP = 0, TEMPLATED = 1, TENSOR_CORE = 2, CUDA_CORE = 3 };

__host__ __device__ inline int up(int n, int m) { return (n + m - 1) / m * m; }

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

// Which body runs a window, by geometry and I/O type alone (envelope.py:
// attention_body): bfloat16 at the full-width NGswin's 64-token windows the
// flagship bodies; its other geometries the bodies templated on the
// geometry; bfloat16 windows of 32 to 64 tokens these bodies wherever they
// have a plan; the rest the CUDA-core generic bodies.
inline Body body(int N, int D, int nh, int hd, int is_bf16) {
  if (is_bf16 && N == 64 && D == 64 && ((nh == 6 && hd == 10) || (nh == 4 && hd == 16)))
    return FLAGSHIP;
#define TMAR_TEMPLATED(NN, DD, NH, HD) \
  if (N == NN && D == DD && nh == NH && hd == HD) return TEMPLATED;
  TMAR_ATTN_WINDOW_GEOMETRIES(TMAR_TEMPLATED)
  TMAR_ATTN_NGRAM_GEOMETRIES(TMAR_TEMPLATED)
#undef TMAR_TEMPLATED
  Plan P;
  return is_bf16 && plan(N, D, nh, hd, &P) ? TENSOR_CORE : CUDA_CORE;
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

}  // namespace attn_mma
}  // namespace
