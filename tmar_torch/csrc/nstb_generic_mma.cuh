// The bfloat16 generic body of a whole NSTB (N-gram Swin Transformer Block)
// on Hopper's tensor cores, shared by K2 (nstb_map.cu) and K8
// (nstb_tokens.cu).  It stands for the TPU kernels
// tmar/ops/pallas_nstb.py:_nstb_map_kernel (driven by _forward_map,
// pallas_call at :592) and :_nstb_kernel (_forward, pallas_call at :222) at
// every width other than the full-width NGswin's, which keeps its own body
// (nstb_window_mma.cuh).  It computes what nstb_generic.cuh computes:
//   x_attn = x + ctx_tok                      (the context of the token's quadrant)
//   a      = proj(softmax(cos(q, k)·scale + rpb + shift mask)·v)
//   y      = x + LN1(a)                       (residual WITHOUT the context)
//   z      = y + LN2(fc2(GELU(fc1(y))))
// and takes the width D, the FFN's hidden width H, the head count, the window
// side ws (N = ws² <= 64 tokens), Q and the shift at run time.  Which
// geometries it takes, and which body runs each, is `body` below (the same
// rule as tmar_torch/ops/envelope.py:nstb_body).
//
// Rounding.  The products take bf16 operands and accumulate in float32, so
// the body rounds to bf16 exactly where the JAX kernel and the plain version
// (tmar_torch/ops/cuda_nstb.py:nstb_math) round: x_attn = bf16(x + ctx); q_n,
// k_n and v; P = bf16(e / sum(e)), normalised before the cast; the attention
// output before the projection; y before fc1; the GELU output before fc2; the
// output.  Biases, LayerNorms (over the true D), the softmax and every
// statistic are float32.  The GELU is gelu.cuh's, the JAX kernels' erf.
//
// What bounds it on an H100: bytes at the demo width (~10 kFLOP per token at
// D 32 against 128 bytes of I/O: the 8x256² stage-1 block's bound is 0.021 ms
// by bytes, 0.011 by bf16 operations), operations from D 64 up.  Design:
// * every product is mma.sync.m16n8k16 (mma.cuh).  A warp owns 16 rows of a
//   window; a window of N tokens is padded to NP = 16·ceil(N / 16) rows and
//   taken by NP / 16 warps (a 64-token window by four, ws <= 4 by one), and
//   a block of 8 warps takes 8·16 / NP windows at a time.  Padded keys are
//   masked out of the softmax (-inf), padded rows are never stored;
// * only what fragment arrays need is fixed at compile time: D padded to 16
//   up to DM (32, 64 or 128) and head_dim padded to HP (16 or 32), the
//   padding zero in the staged weights and biases, so it adds nothing;
// * the chain stays in the registers of the warp that owns the rows:
//   x_attn -> qkv -> q_n -> S -> P -> O -> projection -> LN1 -> y -> fc1 ->
//   GELU -> fc2 -> LN2 -> out, each accumulator re-packed as the next A
//   fragment.  Only each head's k_n and v go through shared memory (all the
//   window's warps read them), double-buffered by head: one barrier of the
//   window's warps per head.  The hidden layer is walked in 16-column chunks
//   that add into fc2's accumulator, so registers stay bounded at any H;
// * the softmax keeps its row max subtraction (ROADMAP hazard 1) and the
//   decomposed shift mask (-100 per differing component), all in log2 units
//   so that the exponential is one ex2;
// * the weights are staged in bf16, [in][out] rows padded by 16 bytes (B
//   fragments by ldmatrix.trans, free of bank conflicts), each head's
//   columns padded to HP.  Where they fit ("resident": the demo width's
//   four matrices are 19 KB) once per block; else ("streamed", the
//   envelope's top: D 128, hidden 512, 400 KB) each head's q/k/v columns
//   and projection rows, and each 64-column slice of fc1 / fc2, are copied
//   by cp.async into one region per stage, between two block barriers;
// * windows and their context quads arrive by cp.async, 16 bytes a thread,
//   double-buffered: the next tile's windows load while this one computes.
//   K2's wrap-around addressing is the `Windows` type's (nstb_generic.cuh).
//   The output goes back through the window's shared slot as 16-byte stores.

#pragma once

#include <stdint.h>

#include "common.cuh"
#include "gelu.cuh"
#include "long_mma.cuh"
#include "mma.cuh"
#include "nstb_generic.cuh"

namespace {
namespace nstb_mma {

constexpr int WARPS = 8;   // warps of a block
constexpr int CHUNK = 64;  // hidden columns of a streamed stage
constexpr int MAX_D = 128;

// The bodies K2 and K8 pick from (envelope.py: NSTB_BODIES, in this order).
enum Body { FLAGSHIP = 0, TENSOR_CORE = 1, CUDA_CORE = 2, LONG = 3, LONG_TC = 4 };

__host__ __device__ inline int up(int n, int m) { return (n + m - 1) / m * m; }

// Geometry, tiling and shared-memory layout of one launch: offsets in floats
// (f_*) from the start of shared memory, in bf16 elements (w_*, slots) from
// the end of the float region.
struct Plan {
  int N, D, H, nh, hd, ws, tw, T2;
  int dk, DP, HP, AP, NP, WW, G, threads, H16, H64, LDX, LDK, resident;
  int f_bqkv, f_bproj, f_g1, f_b1, f_g2, f_b2, f_bw2, f_bw1, f_scale, f_tab, floats;
  int w_qkv, ld_qkv, w_proj, ld_proj, w_1, ld_1, w_2, ld_2, welems, slot, gelems;
  size_t bytes;
};

inline Plan make_plan(int ws, int D, int nh, int hd, int H, bool resident) {
  Plan P;
  P.ws = ws, P.N = ws * ws, P.D = D, P.H = H, P.nh = nh, P.hd = hd;
  P.tw = 2 * ws - 1, P.T2 = P.tw * P.tw;
  P.DP = up(D, 16), P.dk = P.DP / 16;
  P.HP = hd <= 16 ? 16 : 32, P.AP = nh * P.HP;
  P.NP = up(P.N, 16), P.WW = P.NP / 16, P.G = WARPS / P.WW, P.threads = 32 * P.WW * P.G;
  P.H16 = up(H, 16), P.H64 = up(H, CHUNK);
  P.LDX = P.DP + 8, P.LDK = P.HP + 8, P.resident = resident;
  P.f_bqkv = 0;
  P.f_bproj = P.f_bqkv + 3 * P.AP;
  P.f_g1 = P.f_bproj + P.DP;
  P.f_b1 = P.f_g1 + P.DP;
  P.f_g2 = P.f_b1 + P.DP;
  P.f_b2 = P.f_g2 + P.DP;
  P.f_bw2 = P.f_b2 + P.DP;
  P.f_bw1 = P.f_bw2 + P.DP;
  P.f_scale = P.f_bw1 + P.H64;
  P.f_tab = P.f_scale + nh;
  P.floats = up(P.f_tab + nh * P.T2, 4);  // the bf16 region starts on 16 bytes
  // [in][out] weights: resident all of them, streamed one stage's slices
  const int qcols = resident ? 3 * P.AP : 3 * P.HP, prows = resident ? P.AP : P.HP;
  const int hcols = resident ? P.H16 : CHUNK;
  P.w_qkv = 0, P.ld_qkv = qcols + 8;
  P.w_proj = P.w_qkv + P.DP * P.ld_qkv, P.ld_proj = P.DP + 8;
  P.w_1 = P.w_proj + prows * P.ld_proj, P.ld_1 = hcols + 8;
  P.w_2 = P.w_1 + P.DP * P.ld_1, P.ld_2 = P.DP + 8;
  P.welems = P.w_2 + hcols * P.ld_2;
  // per window group: two slots of the tile [NP][LDX] and its four context
  // quads, two head buffers of k_n and v [NP][LDK] each
  P.slot = (P.NP + 4) * P.LDX;
  P.gelems = 2 * P.slot + 4 * P.NP * P.LDK;
  P.bytes = (size_t)4 * P.floats + (size_t)2 * (P.welems + P.G * P.gelems);
  return P;
}

// The plan this body launches (*P) for windows of side ws at (D, heads,
// head_dim, H): resident weights where they fit the card's shared memory,
// else streamed (16-byte copies: head_dim and H multiples of 8).  False
// where it takes no plan: D not a multiple of 8 (16-byte rows) or above
// MAX_D, head_dim past 32, a window past 64 tokens.
inline bool plan(int ws, int D, int nh, int hd, int H, Plan* P) {
  if (ws < 1 || ws * ws > tmar::ROWS || D < 8 || D > MAX_D || D % 8 || hd < 1 || hd > 32 ||
      nh < 1 || H < 1)
    return false;
  *P = make_plan(ws, D, nh, hd, H, true);
  if (P->bytes <= tmar::MAX_SMEM) return true;
  if (hd % 8 || H % 8) return false;
  *P = make_plan(ws, D, nh, hd, H, false);
  return P->bytes <= tmar::MAX_SMEM;
}

// The full-width NGswin's geometry, which its own bodies take
// (nstb_window_mma.cuh's dispatch_nstb): window 8, D 64, H 128, heads 6 x 10
// or 4 x 16.
inline bool flagship(int ws, int D, int H, int nh, int hd) {
  return ws == 8 && D == 64 && H == 128 && ((nh == 6 && hd == 10) || (nh == 4 && hd == 16));
}

// Which body runs a block, by geometry and I/O type alone: the flagship's
// geometry its own bodies; bfloat16 this body wherever it has a plan; the
// rest (float32, the exactness path, and what this body does not take) the
// CUDA-core body of nstb_generic.cuh; windows past 64 tokens and heads wider
// than 32 channels, which none of those take, the long-window bodies
// (nstb_long.cuh): bfloat16 the tensor-core one wherever it has a plan
// (long_mma.cuh: nstb_plan_bytes), the rest the CUDA-core one; so too where
// the CUDA-core body would run but its tile fits no block
// (nstb_rt::smem_bytes; envelope.py: nstb_bytes).
inline Body body(int ws, int D, int nh, int hd, int H, int is_bf16) {
  Plan P;
  const Body lng = is_bf16 && long_mma::nstb_plan_bytes(ws, D, nh, hd, H) ? LONG_TC : LONG;
  if (ws * ws > tmar::ROWS || hd > 32) return lng;
  if (flagship(ws, D, H, nh, hd)) return FLAGSHIP;
  if (is_bf16 && plan(ws, D, nh, hd, H, &P)) return TENSOR_CORE;
  return nstb_rt::smem_bytes(ws * ws, D, nh * hd, H) <= tmar::MAX_SMEM ? CUDA_CORE : lng;
}

// the window side ws of N = ws² tokens
inline int side(int N) {
  int ws = 1;
  while ((ws + 1) * (ws + 1) <= N) ++ws;
  return ws;
}

// The shared memory, in bytes, that generic body b (TENSOR_CORE or CUDA_CORE)
// launches with for windows of N tokens at (D, heads, head_dim, H); -1 where
// it takes no plan.  tmar_torch/ops/envelope.py counts the same.
inline long long generic_smem(int N, int D, int nh, int hd, int H, int b) {
  Plan P;
  if (b == CUDA_CORE) return (long long)nstb_rt::smem_bytes(N, D, nh * hd, H);
  if (b == TENSOR_CORE && plan(side(N), D, nh, hd, H, &P)) return (long long)P.bytes;
  return -1;
}

// the barrier of one window's warps (named barrier 1 + group)
__device__ __forceinline__ void group_sync(int grp, int WW) {
  if (WW == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "r"(32 * WW) : "memory");
}

// Start the copies of window `win` (its N tokens and Q context quads) into
// `slot`, by the window's `n` threads of which this is `i`; one commit group.
template <typename Windows>
__device__ __forceinline__ void load_window(__nv_bfloat16* slot, const __nv_bfloat16* x,
                                            const __nv_bfloat16* cq, const Windows& wins,
                                            int win, int Q, const Plan& P, int i, int n) {
  const int cpr = P.D / 8;
  for (int c = i; c < P.N * cpr; c += n) {
    const int tok = c / cpr, part = c % cpr;
    cp_async16(slot + tok * P.LDX + part * 8, x + wins.src(win, tok) * P.D + part * 8);
  }
  for (int c = i; c < Q * cpr; c += n)
    cp_async16(slot + (P.NP + c / cpr) * P.LDX + (c % cpr) * 8,
               cq + ((size_t)win * Q + c / cpr) * P.D + (c % cpr) * 8);
  cp_async_commit();
}

// In place, v <- (v - mean) · rsqrt(var + eps) · gain + bias over the first
// D8 tiles of each row (g, g + 8); the tiles past them become 0.
template <int DT>
__device__ __forceinline__ void layer_norm(float (&v)[DT][4], const float* gain,
                                           const float* bias, float eps, int t, int D8) {
  const float inv_d = 1.f / (8 * D8);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < DT; ++j)
    if (j < D8) s0 += v[j][0] + v[j][1], s1 += v[j][2] + v[j][3];
  const float mu0 = quad_sum(s0) * inv_d, mu1 = quad_sum(s1) * inv_d;
  float q0 = 0.f, q1 = 0.f;
#pragma unroll
  for (int j = 0; j < DT; ++j)
    if (j < D8) {
      v[j][0] -= mu0, v[j][1] -= mu0, v[j][2] -= mu1, v[j][3] -= mu1;
      q0 += v[j][0] * v[j][0] + v[j][1] * v[j][1];
      q1 += v[j][2] * v[j][2] + v[j][3] * v[j][3];
    }
  const float i0 = rsqrtf(quad_sum(q0) * inv_d + eps), i1 = rsqrtf(quad_sum(q1) * inv_d + eps);
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = 8 * j + 2 * t;
    if (j < D8) {
      v[j][0] = v[j][0] * i0 * gain[c] + bias[c];
      v[j][1] = v[j][1] * i0 * gain[c + 1] + bias[c + 1];
      v[j][2] = v[j][2] * i1 * gain[c] + bias[c];
      v[j][3] = v[j][3] * i1 * gain[c + 1] + bias[c + 1];
    } else {
      v[j][0] = v[j][1] = v[j][2] = v[j][3] = 0.f;
    }
  }
}

// The FFN tail's operands in shared memory, shared by this body and the
// tensor-core long-window body (nstb_long.cuh: nstb_tail_tc): the float32
// vectors, zero past D (bw1 past H, up to a multiple of CHUNK); fc1 [DP][ld1]
// and fc2 [rows][ld2] in bf16, all H16 hidden columns resident or CHUNK a
// stage, streamed from gw1 [D][H] and gw2 [H][D] in global memory.
struct Tail {
  const float *bproj, *g1, *b1, *bw1, *bw2, *g2, *b2;
  __nv_bfloat16 *w1, *w2;
  int ld1, ld2;
  const __nv_bfloat16 *gw1, *gw2;
  int D, DP, H, resident;
};

// A streamed stage: fc1's columns and fc2's rows [c0, c0 + CHUNK), zeros
// past H and D, between two block barriers.
__device__ __forceinline__ void stage_hidden(const Tail& T, int c0, int tid, int nthreads) {
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int c = tid; c < T.DP * (CHUNK / 8); c += nthreads) {
    const int k = c / (CHUNK / 8), col = c0 + 8 * (c % (CHUNK / 8));
    __nv_bfloat16* dst = T.w1 + k * T.ld1 + col - c0;
    if (k < T.D && col < T.H)
      cp_async16(dst, T.gw1 + (size_t)k * T.H + col);
    else
      *reinterpret_cast<uint4*>(dst) = zero4;
  }
  for (int c = tid; c < CHUNK * (T.DP / 8); c += nthreads) {
    const int r = c / (T.DP / 8), i = 8 * (c % (T.DP / 8));
    __nv_bfloat16* dst = T.w2 + r * T.ld2 + i;
    if (c0 + r < T.H && i < T.D)
      cp_async16(dst, T.gw2 + (size_t)(c0 + r) * T.D + i);
    else
      *reinterpret_cast<uint4*>(dst) = zero4;
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
}

// The tail on a warp's 16 rows (row0 + g and row0 + g + 8 of xs [.][ldx],
// the rows' bf16 inputs), from the projection's accumulator pj (bproj not
// yet added): y = x + LN1(pj + bproj); f = bf16(GELU(bf16(y)·w1 + bw1))·w2 +
// bw2, 16 hidden columns at a time adding into fc2's accumulator, fc1's
// columns and fc2's rows staged CHUNK at a time when streamed (block
// barriers: every thread of the block calls it); pj <- z = y + LN2(f) in
// float32, the tiles past D 0.
template <int DM>
__device__ __forceinline__ void ffn_tail(float (&pj)[DM / 8][4], const __nv_bfloat16* xs, int ldx,
                                         int row0, const Tail& T, float eps, int tid,
                                         int nthreads, int lane) {
  constexpr int DT = DM / 8, DK = DM / 16;
  const int g = lane >> 2, t = lane & 3, D8 = T.D / 8, dk = T.DP / 16, H16 = up(T.H, 16);
  const int r0 = row0 + g, r1 = r0 + 8;

  // y = x + LN1(a), a = projection + bproj (tiles past D stay 0)
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    if (j >= D8) break;
    const int c = 8 * j + 2 * t;
    pj[j][0] += T.bproj[c], pj[j][1] += T.bproj[c + 1];
    pj[j][2] += T.bproj[c], pj[j][3] += T.bproj[c + 1];
  }
  layer_norm(pj, T.g1, T.b1, eps, t, D8);
  float (&y)[DT][4] = pj;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    if (j >= D8) break;
    const int c = 8 * j + 2 * t;
    const float2 x0 = unpack_bf16(xs + r0 * ldx + c), x1 = unpack_bf16(xs + r1 * ldx + c);
    y[j][0] += x0.x, y[j][1] += x0.y, y[j][2] += x1.x, y[j][3] += x1.y;
  }

  // f = bf16(GELU(bf16(y) · w1 + bw1)) · w2 + bw2
  uint32_t ya[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) to_a(ya[kk], y[2 * kk], y[2 * kk + 1]);
  float f[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = 8 * j + 2 * t;
    const bool in = j < D8;
    f[j][0] = f[j][2] = in ? T.bw2[c] : 0.f;
    f[j][1] = f[j][3] = in ? T.bw2[c + 1] : 0.f;
  }
#pragma unroll 1
  for (int c0 = 0; c0 < H16; c0 += CHUNK) {
    if (!T.resident) stage_hidden(T, c0, tid, nthreads);
    const int hcol = T.resident ? c0 : 0;
#pragma unroll 1
    for (int sc = 0; sc < CHUNK / 16 && c0 + 16 * sc < H16; ++sc) {
      float hid[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = c0 + 16 * sc + 8 * hf + 2 * t;
        hid[hf][0] = hid[hf][2] = T.bw1[c];
        hid[hf][1] = hid[hf][3] = T.bw1[c + 1];
      }
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        if (kk >= dk) break;
        mma_pair_t(hid[0], hid[1], ya[kk], T.w1, T.ld1, hcol + 16 * sc, 16 * kk, lane);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 4; ++e) hid[hf][e] = act::gelu(hid[hf][e]);
      uint32_t ha[4];
      to_a(ha, hid[0], hid[1]);
#pragma unroll
      for (int n2 = 0; n2 < DK; ++n2) {
        if (n2 >= dk) break;
        mma_pair_t(f[2 * n2], f[2 * n2 + 1], ha, T.w2, T.ld2, 16 * n2, hcol + 16 * sc, lane);
      }
    }
  }

  // z = y + LN2(f)
  layer_norm(f, T.g2, T.b2, eps, t, D8);
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] += f[j][e];
}

template <int DM, int HP, typename Windows>
__global__ void __launch_bounds__(WARPS * 32, DM <= 64 ? 2 : 1) nstb_generic_mma(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ cq,
    const __nv_bfloat16* __restrict__ wqkv, const float* __restrict__ bqkv,
    const float* __restrict__ scale, const float* __restrict__ table,
    const __nv_bfloat16* __restrict__ wproj, const float* __restrict__ bproj,
    const float* __restrict__ g1, const float* __restrict__ b1,
    const __nv_bfloat16* __restrict__ w1, const float* __restrict__ bw1,
    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ bw2,
    const float* __restrict__ g2, const float* __restrict__ b2,
    __nv_bfloat16* __restrict__ out, Windows wins, Plan P, int Q, int shift, float eps) {
  constexpr int DT = DM / 8, DK = DM / 16;  // accumulator tiles and k-steps of D
  constexpr int HT = HP / 8, HK = HP / 16;  // ... of a head
  extern __shared__ float4 smem4[];
  float* sf = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(sf + P.floats);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int A = P.nh * P.hd, D8 = P.D / 8;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  // ---- once per block: zeros (the padding of weights, tiles and quads), the
  // float32 parameters (log2 units for the softmax), resident weights -------
  for (int i = tid; i < (P.welems + P.G * P.gelems) / 8; i += nthreads)
    reinterpret_cast<uint4*>(sw)[i] = zero4;
  for (int o = tid; o < 3 * P.AP; o += nthreads) {
    const int part = o / P.AP, h = (o % P.AP) / HP, d = o % HP;
    sf[P.f_bqkv + o] = d < P.hd ? bqkv[part * A + h * P.hd + d] : 0.f;
  }
  for (int n = tid; n < P.DP; n += nthreads) {
    const bool in = n < P.D;
    sf[P.f_bproj + n] = in ? bproj[n] : 0.f;
    sf[P.f_g1 + n] = in ? g1[n] : 0.f;
    sf[P.f_b1 + n] = in ? b1[n] : 0.f;
    sf[P.f_g2 + n] = in ? g2[n] : 0.f;
    sf[P.f_b2 + n] = in ? b2[n] : 0.f;
    sf[P.f_bw2 + n] = in ? bw2[n] : 0.f;
  }
  for (int n = tid; n < P.H64; n += nthreads) sf[P.f_bw1 + n] = n < P.H ? bw1[n] : 0.f;
  for (int h = tid; h < P.nh; h += nthreads) sf[P.f_scale + h] = scale[h] * LOG2E;
  for (int e = tid; e < P.T2 * P.nh; e += nthreads)
    sf[P.f_tab + (e % P.nh) * P.T2 + e / P.nh] = table[e] * LOG2E;
  __syncthreads();  // the zeros are down before the weights go over them
  if (P.resident) {
    for (int e = tid; e < P.D * 3 * A; e += nthreads) {
      const int k = e / (3 * A), o = e % (3 * A), part = o / A, h = (o % A) / P.hd;
      sw[P.w_qkv + k * P.ld_qkv + part * P.AP + h * HP + o % P.hd] = wqkv[e];
    }
    for (int e = tid; e < A * P.D; e += nthreads) {
      const int i = e / P.D;
      sw[P.w_proj + (i / P.hd * HP + i % P.hd) * P.ld_proj + e % P.D] = wproj[e];
    }
    for (int e = tid; e < P.D * P.H; e += nthreads)
      sw[P.w_1 + e / P.H * P.ld_1 + e % P.H] = w1[e];
    for (int e = tid; e < P.H * P.D; e += nthreads)
      sw[P.w_2 + e / P.D * P.ld_2 + e % P.D] = w2[e];
  }
  __syncthreads();

  // a streamed stage: head h's q/k/v columns and projection rows, between
  // two block barriers (fc1's and fc2's: stage_hidden)
  auto stage_head = [&](int h) {
    __syncthreads();
    const int hc = P.hd / 8;
    for (int c = tid; c < P.D * 3 * hc; c += nthreads) {
      const int k = c / (3 * hc), part = c % (3 * hc) / hc, i = c % hc;
      cp_async16(sw + P.w_qkv + k * P.ld_qkv + part * HP + 8 * i,
                 wqkv + (size_t)k * 3 * A + part * A + h * P.hd + 8 * i);
    }
    for (int c = tid; c < P.hd * D8; c += nthreads)
      cp_async16(sw + P.w_proj + c / D8 * P.ld_proj + 8 * (c % D8),
                 wproj + (size_t)(h * P.hd + c / D8) * P.D + 8 * (c % D8));
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  };

  const Tail tail{sf + P.f_bproj, sf + P.f_g1, sf + P.f_b1, sf + P.f_bw1, sf + P.f_bw2,
                  sf + P.f_g2, sf + P.f_b2, sw + P.w_1, sw + P.w_2, P.ld_1, P.ld_2, w1, w2,
                  P.D, P.DP, P.H, P.resident};

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int grp = warp / P.WW, wig = warp % P.WW, gn = 32 * P.WW, gi = tid - grp * gn;
  __nv_bfloat16* gbase = sw + P.welems + grp * P.gelems;
  const int ws = P.ws, tw = P.tw, N = P.N, NP = P.NP, LDX = P.LDX, LDK = P.LDK;
  const int edge = ws - shift;  // first in-window row/col of the second band
  const int r0 = 16 * wig + g, r1 = r0 + 8;  // this thread's rows in the window
  // positions of the rows (a padded row takes row 0's: it is never stored)
  const int q0 = r0 < N ? r0 : 0, q1 = r1 < N ? r1 : 0;
  const int qoff0 = (q0 / ws + ws - 1) * tw + q0 % ws + ws - 1;
  const int qoff1 = (q1 / ws + ws - 1) * tw + q1 % ws + ws - 1;
  const bool br0 = shift > 0 && q0 / ws >= edge, bc0 = shift > 0 && q0 % ws >= edge;
  const bool br1 = shift > 0 && q1 / ws >= edge, bc1 = shift > 0 && q1 % ws >= edge;
  const int quad0 = Q == 1 ? 0 : 2 * br0 + bc0, quad1 = Q == 1 ? 0 : 2 * br1 + bc1;
  // the thread's keys 8j + 2t + e: table offset, bands (bits 8, 9), padding (bit 10)
  int kinfo[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t + e, k = c < N ? c : 0;
      kinfo[j][e] = ((k / ws) * tw + k % ws) | (int)(shift > 0 && k / ws >= edge) << 8 |
                    (int)(shift > 0 && k % ws >= edge) << 9 | (int)(c >= N) << 10;
    }
  constexpr float MASK = -100.f * LOG2E;

  const int tiles = (wins.count + P.G - 1) / P.G, bx = blockIdx.x, gx = gridDim.x;
  if (bx * P.G + grp < wins.count) load_window(gbase, x, cq, wins, bx * P.G + grp, Q, P, gi, gn);
  for (int it = 0, tile = bx; tile < tiles; ++it, tile += gx) {
    const int win = tile * P.G + grp, next = (tile + gx) * P.G + grp;
    __nv_bfloat16* cur = gbase + (it & 1) * P.slot;
    if (tile + gx < tiles && next < wins.count)
      load_window(gbase + ((it + 1) & 1) * P.slot, x, cq, wins, next, Q, P, gi, gn);
    else
      cp_async_commit();  // an empty group keeps the wait below uniform
    cp_async_wait_prior();
    group_sync(grp, P.WW);  // the window's copies have landed (a window past the
                            // count computes on its slot's old values, never stored)

    // place of the window in its image: gates the shift mask
    const int place = shift > 0 ? win % (wins.wh * wins.ww) : 0;
    const bool mrow = shift > 0 && place / wins.ww == wins.wh - 1;
    const bool mcol = shift > 0 && place % wins.ww == wins.ww - 1;
    const __nv_bfloat16* ctx0 = cur + (NP + quad0) * LDX;
    const __nv_bfloat16* ctx1 = cur + (NP + quad1) * LDX;

    // 1. per head: qkv, cosine attention, and its share of the projection
    float pj[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j) pj[j][0] = pj[j][1] = pj[j][2] = pj[j][3] = 0.f;
#pragma unroll 1
    for (int h = 0; h < P.nh; ++h) {
      if (!P.resident) stage_head(h);
      __nv_bfloat16* s_k = gbase + 2 * P.slot + (h & 1) * 2 * NP * LDK;  // k_n [NP][LDK]
      __nv_bfloat16* s_v = s_k + NP * LDK;                                // v [NP][LDK]
      uint32_t qa[HK][4];
      {
        // q, k, v of head h: part p's columns at qcol + p·pstride
        const int qcol = P.resident ? h * HP : 0, pstride = P.resident ? P.AP : HP;
        float acc[3][HT][4];
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int j = 0; j < HT; ++j) acc[p][j][0] = acc[p][j][1] = acc[p][j][2] = acc[p][j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          if (kk >= P.dk) break;
          // x_attn = bf16(x + ctx of the row's quadrant), as an A fragment
          uint32_t xa[4];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int col = 16 * kk + 8 * hf + 2 * t;
            const float2 xv0 = unpack_bf16(cur + r0 * LDX + col), cv0 = unpack_bf16(ctx0 + col);
            const float2 xv1 = unpack_bf16(cur + r1 * LDX + col), cv1 = unpack_bf16(ctx1 + col);
            xa[2 * hf] = pack_bf16(xv0.x + cv0.x, xv0.y + cv0.y);
            xa[2 * hf + 1] = pack_bf16(xv1.x + cv1.x, xv1.y + cv1.y);
          }
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int n2 = 0; n2 < HK; ++n2)
              mma_pair_t(acc[p][2 * n2], acc[p][2 * n2 + 1], xa, sw + P.w_qkv, P.ld_qkv,
                         qcol + p * pstride + 16 * n2, 16 * kk, lane);
        }
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int j = 0; j < HT; ++j) {
            const float* bq = sf + P.f_bqkv + p * P.AP + h * HP + 8 * j + 2 * t;
            acc[p][j][0] += bq[0], acc[p][j][1] += bq[1], acc[p][j][2] += bq[0], acc[p][j][3] += bq[1];
          }
        // L2 norms of q (p = 0) and k (p = 1) per row, over the quad
        float inv[2][2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int j = 0; j < HT; ++j) {
            s0 += acc[p][j][0] * acc[p][j][0] + acc[p][j][1] * acc[p][j][1];
            s1 += acc[p][j][2] * acc[p][j][2] + acc[p][j][3] * acc[p][j][3];
          }
          inv[p][0] = 1.f / (sqrtf(quad_sum(s0)) + 1e-12f);
          inv[p][1] = 1.f / (sqrtf(quad_sum(s1)) + 1e-12f);
        }
#pragma unroll
        for (int kk = 0; kk < HK; ++kk) {
          const float* lo = acc[0][2 * kk];
          const float* hi = acc[0][2 * kk + 1];
          qa[kk][0] = pack_bf16(lo[0] * inv[0][0], lo[1] * inv[0][0]);
          qa[kk][1] = pack_bf16(lo[2] * inv[0][1], lo[3] * inv[0][1]);
          qa[kk][2] = pack_bf16(hi[0] * inv[0][0], hi[1] * inv[0][0]);
          qa[kk][3] = pack_bf16(hi[2] * inv[0][1], hi[3] * inv[0][1]);
        }
#pragma unroll
        for (int j = 0; j < HT; ++j) {
          const int c = 8 * j + 2 * t;
          const float* kt = acc[1][j];
          const float* vt = acc[2][j];
          sts32(s_k + r0 * LDK + c, pack_bf16(kt[0] * inv[1][0], kt[1] * inv[1][0]));
          sts32(s_k + r1 * LDK + c, pack_bf16(kt[2] * inv[1][1], kt[3] * inv[1][1]));
          sts32(s_v + r0 * LDK + c, pack_bf16(vt[0], vt[1]));
          sts32(s_v + r1 * LDK + c, pack_bf16(vt[2], vt[3]));
        }
      }
      group_sync(grp, P.WW);  // head h's k_n and v are in; head h - 2's are read

      // S = q_n · k_nᵀ, tile j = keys [8j, 8j + 8), then the logits in log2
      // units: · scale + relative-position bias + shift mask, padded keys -inf
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (16 * jp >= NP) break;
#pragma unroll
        for (int kk = 0; kk < HK; ++kk)
          mma_pair(s[2 * jp], s[2 * jp + 1], qa[kk], s_k, LDK, 16 * jp, 16 * kk, lane);
      }
      const float sc = sf[P.f_scale + h];
      const float* tab = sf + P.f_tab + h * P.T2;
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= NP) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ki = kinfo[j][e], ko = ki & 255;
          float v0 = s[j][e] * sc + tab[qoff0 - ko];
          float v1 = s[j][2 + e] * sc + tab[qoff1 - ko];
          if (mrow) {
            const bool kb = (ki >> 8) & 1;
            if (br0 != kb) v0 += MASK;
            if (br1 != kb) v1 += MASK;
          }
          if (mcol) {
            const bool kb = (ki >> 9) & 1;
            if (bc0 != kb) v0 += MASK;
            if (bc1 != kb) v1 += MASK;
          }
          if (ki >> 10) v0 = v1 = -INFINITY;
          s[j][e] = v0, s[j][2 + e] = v1;
          m0 = fmaxf(m0, v0), m1 = fmaxf(m1, v1);
        }
      }
      m0 = quad_max(m0);
      m1 = quad_max(m1);
      float z0 = 0.f, z1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= NP) break;
        s[j][0] = exp2_approx(s[j][0] - m0), s[j][1] = exp2_approx(s[j][1] - m0);
        s[j][2] = exp2_approx(s[j][2] - m1), s[j][3] = exp2_approx(s[j][3] - m1);
        z0 += s[j][0] + s[j][1];
        z1 += s[j][2] + s[j][3];
      }
      const float iz0 = 1.f / quad_sum(z0), iz1 = 1.f / quad_sum(z1);
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] *= iz0, s[j][1] *= iz0, s[j][2] *= iz1, s[j][3] *= iz1;

      // O = bf16(P) · v, then bf16(O) · the head's projection rows
      float o[HT][4];
#pragma unroll
      for (int j = 0; j < HT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk >= NP) break;
        uint32_t pa[4];
        to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int n2 = 0; n2 < HK; ++n2)
          mma_pair_t(o[2 * n2], o[2 * n2 + 1], pa, s_v, LDK, 16 * n2, 16 * kk, lane);
      }
      const int prow = P.resident ? h * HP : 0;
#pragma unroll
      for (int kk = 0; kk < HK; ++kk) {
        uint32_t oa[4];
        to_a(oa, o[2 * kk], o[2 * kk + 1]);
#pragma unroll
        for (int n2 = 0; n2 < DK; ++n2) {
          if (n2 >= P.dk) break;
          mma_pair_t(pj[2 * n2], pj[2 * n2 + 1], oa, sw + P.w_proj, P.ld_proj, 16 * n2,
                     prow + 16 * kk, lane);
        }
      }
    }

    // 2. y = x + LN1(a), the FFN, z = y + LN2(f) (ffn_tail); z -> bf16 in the
    // window's slot (own rows, those < N), then out, 16 bytes a lane
    ffn_tail<DM>(pj, cur, LDX, 16 * wig, tail, eps, tid, nthreads, lane);
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      if (j >= D8) break;
      const int c = 8 * j + 2 * t;
      if (r0 < N) sts32(cur + r0 * LDX + c, pack_bf16(pj[j][0], pj[j][1]));
      if (r1 < N) sts32(cur + r1 * LDX + c, pack_bf16(pj[j][2], pj[j][3]));
    }
    __syncwarp();
    if (win < wins.count)
      for (int c = lane; c < 16 * D8; c += 32) {
        const int row = 16 * wig + c / D8, part = c % D8;
        if (row < N)
          *reinterpret_cast<uint4*>(out + wins.dst(win, row) * P.D + part * 8) =
              *reinterpret_cast<const uint4*>(cur + row * LDX + part * 8);
      }
    group_sync(grp, P.WW);  // the slot and the head buffers are free
  }
}

template <int DM, int HP, typename Windows>
int launch_t(const void* const* p, void* out, const Windows& wins, const Plan& P, int Q,
             int shift, float eps, cudaStream_t stream) {
  auto kern = nstb_generic_mma<DM, HP, Windows>;
  // the persistent grid: SMs times the blocks one holds at this plan, kept
  // per device for the last plan's bytes and threads
  static int cached[64][3] = {};  // bytes, threads, grid
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  int* c = cached[dev];
  if (c[0] != (int)P.bytes || c[1] != P.threads) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)P.bytes)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, P.threads, P.bytes)) !=
            cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    c[0] = (int)P.bytes, c[1] = P.threads, c[2] = sms * per_sm;
  }
  const int tiles = (wins.count + P.G - 1) / P.G;
  const int blocks = tiles < c[2] ? tiles : c[2];
  kern<<<blocks, P.threads, P.bytes, stream>>>(
      (const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[1], (const __nv_bfloat16*)p[2],
      (const float*)p[3], (const float*)p[4], (const float*)p[5], (const __nv_bfloat16*)p[6],
      (const float*)p[7], (const float*)p[8], (const float*)p[9], (const __nv_bfloat16*)p[10],
      (const float*)p[11], (const __nv_bfloat16*)p[12], (const float*)p[13],
      (const float*)p[14], (const float*)p[15], (__nv_bfloat16*)out, wins, P, Q, shift, eps);
  return (int)cudaGetLastError();
}

// This body on bf16 operands, on `stream`: p holds the 16 inputs in the
// kernel's order; x, the context quads, the four matrices and out must be
// 16-byte aligned.  Returns a cudaError_t code (cudaErrorInvalidValue where
// `plan` takes no plan).
template <typename Windows>
int launch(const void* const* p, void* out, const Windows& wins, int D, int H, int nh, int hd,
           int Q, int shift, float eps, cudaStream_t s) {
  Plan P;
  if (!plan(wins.ws, D, nh, hd, H, &P)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)p[0] | (uintptr_t)p[1] | (uintptr_t)p[2] | (uintptr_t)p[6] |
       (uintptr_t)p[10] | (uintptr_t)p[12] | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (P.HP == 16) {
    if (P.DP <= 32) return launch_t<32, 16>(p, out, wins, P, Q, shift, eps, s);
    if (P.DP <= 64) return launch_t<64, 16>(p, out, wins, P, Q, shift, eps, s);
    return launch_t<128, 16>(p, out, wins, P, Q, shift, eps, s);
  }
  if (P.DP <= 32) return launch_t<32, 32>(p, out, wins, P, Q, shift, eps, s);
  if (P.DP <= 64) return launch_t<64, 32>(p, out, wins, P, Q, shift, eps, s);
  return launch_t<128, 32>(p, out, wins, P, Q, shift, eps, s);
}

}  // namespace nstb_mma
}  // namespace
