// The bfloat16 generic body of the residual FFN's backward (K6,
// residual_ffn_bwd.cu) on Hopper's tensor cores: every width other than the
// full-width NGswin's (D, H) = (64, 128), which keeps its own body.  It stands
// for the TPU kernel tmar/ops/pallas_ffn.py:_ffn_bwd_kernel (:249, driven by
// _backward, pallas_call at :180) and computes what the file's other bodies
// compute (residual_ffn_bwd.cu's header), rounding where _ffn_bwd_kernel
// rounds at bf16, as the flagship body does: yc = bf16(y), hc =
// bf16(GELU(u)), bf16 w1 and w2 (rounded here from the float32 parameters),
// doc = bf16(do) before dh = doc·w2ᵀ and dw2 = hcᵀ·doc, duc = bf16(du) before
// dy = dz + duc·w1ᵀ and dw1 = ycᵀ·duc, and dw1 and dw2 after their sums over
// rows, in the reduce.  The LayerNorms (over the true D), the GELU
// derivative and the vector sums stay float32.  Its plain version is
// tmar_torch/ops/cuda_ffn.py:ffn_backward_math.
//
// Which geometries.  bfloat16 with D a multiple of 8 up to 128 (16-byte rows
// for cp.async) wherever `plan` finds a layout that fits a block; `body` is
// the rule, and tmar_torch/ops/envelope.py:ffn_body the same rule (a query of
// the built source holds the two equal).  The rule is K5's too: its
// tensor-core generic forward (residual_ffn_fwd.cu) runs where this body
// runs, on the plan `fwd_plan` finds with the same padding and strip
// helpers (a plan exists at every width `plan` takes; `body` asks both).
//
// What bounds it on an H100: bytes at the demo width (D 32, hidden 64: 24.6
// kFLOP a row, 12·D·H, against 320 bytes of activations), operations at the
// envelope's top (D 128, hidden 512: 786 kFLOP against 1,280 bytes).  Design:
// * blocks of 8 warps walk tiles of 128 rows, a 16-row strip per warp, and
//   every product is mma.sync.m16n8k16 (mma.cuh).  Only the fragment arrays
//   are compile-time: D is padded to 16 (DP) up to DM (32, 64 or 128), the
//   hidden width to 16 (HP), with zeros in the staged weights and biases, so
//   the padding adds nothing; the LayerNorms run over the true D;
// * the chain stays in the warp's registers as the flagship body's: y -> yc
//   (into the x strip), then pass 1 over the hidden width in 16-column
//   chunks (u, hc = bf16(GELU(u)), o += hc·w2, hc kept for dw2), the LN2
//   backward (o -> do, doc into the dz strip), pass 2 over the chunks again
//   (u recomputed, dh = doc·w2ᵀ, du = dh·GELU'(u), duc kept for dw1, dy +=
//   duc·w1ᵀ), then the LN1 backward (n1 recomputed from attn_out).  The A
//   fragments of yc and doc are read back by ldmatrix, so registers stay
//   bounded at DM 128;
// * the weights are rounded to bf16 once per call, into scratch in the layout
//   a block stages them in (ffn_bwd_gmma_weights), and staged by cp.async:
//   once per block where they fit ("resident"), else ("streamed", the
//   envelope's top: D 128, hidden 512, 272 KB of bf16 weights) 64 hidden
//   columns of w1 and rows of w2 at a time between two block barriers.  The
//   activations arrive by cp.async;
// * dw1 [D, H] and dw2 [H, D] stay on chip across a block's tiles: each warp
//   keeps UNITS = units(DM) 16x16 tiles of each in registers (2 at DM 32,
//   else 4; ycᵀ·duc and hcᵀ·doc over the tile's eight strips, after a block
//   barrier), 8·UNITS·256 elements of each a block.  Where D·H is larger
//   (the envelope's top: 65,536 > 8,192) the hidden width is cut into S
//   slices of HS columns: block b takes slice b % S and the row tiles
//   b / S, b / S + R, ...; each slice's blocks
//   recompute pass 1 and the LN2 backward whole (o needs every hidden
//   column: S times the forward's FLOPs, far below the bound, and no extra
//   bytes from device memory but the activations' rereads, from L2), run
//   pass 2 on their slice only and write their share of dy - dz to
//   dyp[slice][M][D].  A second kernel (ffn_bwd_gmma_finish) adds dz and
//   the S shares in slice order, then runs the LN1 backward, dx and
//   d attn_out.  With S = 1 (every width with D·H <= 8·UNITS·256) the one
//   kernel finishes the rows itself.  The cost of a slice is a recompute of
//   the forward and 2·S·M·D·4 bytes of shares, against dw1 and dw2 kept in
//   device memory by every tile (the CUDA-core body's 1 MB per 64 rows);
// * the vector cotangents are per-warp partial sums in shared memory, each
//   column of a warp added by one lane (a reduce-scatter over the warp's
//   eight row groups), summed over the warps in order at the end;
// * no float atomics: each block writes its partial sums to its own slot,
//   and ffn_bwd_gmma_reduce adds the slots of each slice in block order (dw1
//   and dw2 rounded to bf16 as they are written).  Two runs give the same
//   bits.  Rows past M are zero, so they add nothing (dz = 0 makes do, du and
//   dy zero).

#pragma once

#include <stdint.h>

#include "common.cuh"
#include "gelu.cuh"
#include "mma.cuh"

namespace {
namespace ffn_g {

using namespace tmar;

constexpr int WARPS = 8, THREADS = 32 * WARPS, TILE = 16 * WARPS;
constexpr int CHUNK = 64;   // hidden columns of a streamed stage
constexpr int MAX_D = 128;  // the widest D the fragment arrays take

// The bodies of K5 and K6 (envelope.py: FFN_BODIES, in this order).
enum Body { FLAGSHIP = 0, TEMPLATED = 1, TENSOR_CORE = 2, CUDA_CORE = 3 };

__host__ __device__ inline int up(int n, int m) { return (n + m - 1) / m * m; }
// the fragment arrays' width for D padded to DP
__host__ __device__ constexpr int dm_of(int DP) { return DP <= 32 ? 32 : DP <= 64 ? 64 : 128; }
// 16x16 tiles of each of dw1 and dw2 a warp keeps (registers: 16·UNITS floats)
__host__ __device__ constexpr int units(int DM) { return DM == 32 ? 2 : 4; }

// The layout of one launch.  Shared memory: float32 g1, b1, g2, bw2 [DP] and
// bw1 [HP]; the bf16 weights, w1 as [h][ld1] (rows HP resident, CHUNK
// streamed; columns DP) and w2 as [d][ld2] (DP rows; columns HP or CHUNK),
// rows padded by 16 bytes; per warp its strips, [16][LDX] x, attn_out and dz
// (then yc and doc) and [16][LDS] hc and duc of its slice; per warp its
// vector partials, float32 dg2 db2 dbw2 dg1 db1 [DP] and dbw1 [HS].
struct Plan {
  int D, H, DP, HP, D8, dk, HS, S, resident;
  int LDX, LDS, ld1, ld2;
  int f_g1, f_b1, f_g2, f_bw2, f_bw1, floats;
  int w2off, welems, strip_elems, vec;
  size_t bytes;
  // one block's slot of partial sums: dw1 [D][HS], dw2 [HS][D], dbw1 [HS],
  // dg2 db2 dbw2 dg1 db1 [D]
  int p_dw2, p_dbw1, p_vec, psize;
};

inline Plan make_plan(int D, int H, int HS, bool resident) {
  Plan P;
  P.D = D, P.H = H, P.DP = up(D, 16), P.HP = up(H, 16), P.D8 = D / 8, P.dk = P.DP / 16;
  P.HS = HS, P.S = (P.HP + HS - 1) / HS, P.resident = resident;
  P.LDX = P.DP + 8, P.LDS = HS + 8, P.ld1 = P.DP + 8;
  const int cols = resident ? P.HP : CHUNK;
  P.ld2 = cols + 8;
  P.f_g1 = 0, P.f_b1 = P.DP, P.f_g2 = 2 * P.DP, P.f_bw2 = 3 * P.DP, P.f_bw1 = 4 * P.DP;
  P.floats = up(4 * P.DP + P.HP, 4);
  P.w2off = cols * P.ld1;
  P.welems = P.w2off + P.DP * P.ld2;
  P.strip_elems = 3 * 16 * P.LDX + 2 * 16 * P.LDS;
  P.vec = 5 * P.DP + HS;
  P.bytes = (size_t)4 * P.floats + (size_t)2 * (P.welems + WARPS * P.strip_elems) +
            (size_t)4 * WARPS * P.vec;
  P.p_dw2 = D * HS, P.p_dbw1 = 2 * D * HS, P.p_vec = P.p_dbw1 + HS, P.psize = P.p_vec + 5 * D;
  return P;
}

// The plan at (D, H) (envelope.py: ffn_mma_plan is the same search), false
// where the body takes none (D not a multiple of 8 or past 128, what fits no
// block): resident weights where they fit, else streamed; at that, the
// widest slice that fits, from min(HP, 8·UNITS·256 / DP) down by 16.
inline bool plan(int D, int H, Plan* P) {
  if (D < 8 || D > MAX_D || D % 8 || H < 1) return false;
  const int DP = up(D, 16), HP = up(H, 16);
  int hs0 = WARPS * units(dm_of(DP)) * 256 / DP / 16 * 16;
  if (hs0 > HP) hs0 = HP;
  for (int r = 1; r >= 0; --r)
    for (int hs = hs0; hs >= 16; hs -= 16) {
      *P = make_plan(D, H, hs, r == 1);
      if (P->bytes <= tmar::MAX_SMEM) return true;
    }
  return false;
}

// The layout of K5's forward body on the tensor cores (residual_ffn_fwd.cu:
// residual_ffn_fwd_gmma) at (D, H), with the backward's padding rules.
// Shared memory: float32 g1, b1, g2, b2, bw2 [DP] and bw1 [HP]; the bf16
// weights, w1 as [h][ld1] (rows HP resident, CHUNK streamed; columns DP) and
// w2 as [d][ld2] (DP rows; columns HP or CHUNK), rows padded by 16 bytes,
// one stage resident, two streamed (the next CHUNK hidden columns load while
// these compute); per warp its strips [16][LDX], x then attn_out: two such
// stages resident (the next strip loads while this one computes), one
// streamed.  There are no dw accumulators, so the forward needs no hidden
// slices.  Streamed, the weights come from a per-call weights kernel
// (round_weights), whose scratch is weights_floats(DP, HP) floats.
struct FwdPlan {
  int D, H, DP, HP, D8, dk, resident;
  int LDX, ld1, ld2, floats, w2off, stage_elems, welems, strip_elems;
  size_t bytes;
};

inline FwdPlan make_fwd_plan(int D, int H, bool resident) {
  FwdPlan F;
  F.D = D, F.H = H, F.DP = up(D, 16), F.HP = up(H, 16), F.D8 = D / 8, F.dk = F.DP / 16;
  F.resident = resident;
  const int cols = resident ? F.HP : CHUNK;
  F.LDX = F.DP + 8, F.ld1 = F.DP + 8, F.ld2 = cols + 8;
  F.floats = up(5 * F.DP + F.HP, 4);
  F.w2off = cols * F.ld1;
  F.stage_elems = F.w2off + F.DP * F.ld2;
  F.welems = (resident ? 1 : 2) * F.stage_elems;
  F.strip_elems = (resident ? 4 : 2) * 16 * F.LDX;
  F.bytes = (size_t)4 * F.floats + (size_t)2 * (F.welems + WARPS * F.strip_elems);
  return F;
}

// K5's plan at (D, H) (envelope.py: ffn_mma_fwd_plan is the same search),
// false where it takes none: resident weights where they fit, else streamed.
inline bool fwd_plan(int D, int H, FwdPlan* F) {
  if (D < 8 || D > MAX_D || D % 8 || H < 1) return false;
  for (int r = 1; r >= 0; --r) {
    *F = make_fwd_plan(D, H, r == 1);
    if (F->bytes <= tmar::MAX_SMEM) return true;
  }
  return false;
}

// Which body of K5 and K6 runs a width, by geometry and I/O type alone
// (envelope.py: ffn_body): the full-width NGswin's (64, 128) their own
// bodies, bfloat16 on the tensor cores, float32 the ones templated on the
// widths; bfloat16 the tensor-core generic bodies wherever both have a plan;
// the rest the CUDA-core generic bodies.
inline Body body(int D, int H, int is_bf16) {
  if (D == 64 && H == 128) return is_bf16 ? FLAGSHIP : TEMPLATED;
  Plan P;
  FwdPlan F;
  return is_bf16 && plan(D, H, &P) && fwd_plan(D, H, &F) ? TENSOR_CORE : CUDA_CORE;
}

// ---- strips: 16 rows at the padded width, bf16 [16][ld] -------------------

// Start the copies of rows [row0, row0 + 16) of src [M, D] into dst, 16 bytes
// a lane (rows past M are zeroed instead); commits nothing.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, long row0,
                                          long M, int D, int ld, int lane) {
  const int D8 = D / 8;
  for (int c = lane; c < 16 * D8; c += 32) {
    const int row = c / D8, part = c % D8;
    __nv_bfloat16* d = dst + row * ld + 8 * part;
    if (row0 + row < M)
      cp_async16(d, src + (size_t)(row0 + row) * D + 8 * part);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Rows [row0, row0 + 16) of dst [M, D], those below M, from the strip src
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, long row0,
                                           long M, int D, int ld, int lane) {
  const int D8 = D / 8;
  for (int c = lane; c < 16 * D8; c += 32) {
    const int row = c / D8, part = c % D8;
    if (row0 + row < M)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + row) * D + 8 * part) =
          *reinterpret_cast<const uint4*>(src + row * ld + 8 * part);
  }
}

// The strip's values in the accumulator layout; the tiles past D8 are 0
template <int DT>
__device__ __forceinline__ void read_strip(const __nv_bfloat16* tile, int ld, float (&v)[DT][4],
                                           int D8, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    if (j < D8) {
      const float2 a = unpack_bf16(tile + g * ld + 8 * j + 2 * t);
      const float2 b = unpack_bf16(tile + (g + 8) * ld + 8 * j + 2 * t);
      v[j][0] = a.x, v[j][1] = a.y, v[j][2] = b.x, v[j][3] = b.y;
    } else {
      v[j][0] = v[j][1] = v[j][2] = v[j][3] = 0.f;
    }
  }
}

// v's first D8 tiles, rounded to bf16, into the strip
template <int DT>
__device__ __forceinline__ void write_strip(__nv_bfloat16* tile, int ld, const float (&v)[DT][4],
                                            int D8, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < DT; ++j)
    if (j < D8) {
      sts32(tile + g * ld + 8 * j + 2 * t, pack_bf16(v[j][0], v[j][1]));
      sts32(tile + (g + 8) * ld + 8 * j + 2 * t, pack_bf16(v[j][2], v[j][3]));
    }
}

// The A fragment a of 16 hidden columns into a strip at column c
__device__ __forceinline__ void store_a(__nv_bfloat16* strip, int ld, int c, const uint32_t (&a)[4],
                                        int lane) {
  __nv_bfloat16* p = strip + (lane >> 2) * ld + c + 2 * (lane & 3);
  sts32(p, a[0]);
  sts32(p + 8 * ld, a[1]);
  sts32(p + 8, a[2]);
  sts32(p + 8 * ld + 8, a[3]);
}

// acc[col] += the sums over the strip's 16 rows of s, s[2j + e] being the
// sum of this lane's two rows at column 8j + 2t + e: a reduce-scatter over
// the eight row groups, after which lane (g, t) adds K = DT / 4 columns
template <int DT>
__device__ __forceinline__ void add_col_sums(const float (&s)[2 * DT], float* acc, int lane) {
  constexpr int K = DT / 4;
  const int g = lane >> 2, t = lane & 3;
  float r[K];
  rows_reduce_scatter<K>(s, r, g);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int f = g * K + i;
    acc[8 * (f >> 1) + 2 * t + (f & 1)] += r[i];
  }
}

template <int DT>
__device__ __forceinline__ void add_col_sums(const float (&v)[DT][4], float* acc, int lane) {
  float s[2 * DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) s[2 * j] = v[j][0] + v[j][2], s[2 * j + 1] = v[j][1] + v[j][3];
  add_col_sums<DT>(s, acc, lane);
}

// In place, v <- (v - mean) · rsqrt(var + eps) per row over the true D (the
// first D8 tiles; the others become 0); inv gets the two rows' rsqrt(var + eps)
template <int DT>
__device__ __forceinline__ void normalize_rows(float (&v)[DT][4], float eps, float (&inv)[2],
                                               int D8) {
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
  inv[0] = rsqrtf(quad_sum(q0) * inv_d + eps);
  inv[1] = rsqrtf(quad_sum(q1) * inv_d + eps);
#pragma unroll
  for (int j = 0; j < DT; ++j)
    if (j < D8) {
      v[j][0] *= inv[0], v[j][1] *= inv[0], v[j][2] *= inv[1], v[j][3] *= inv[1];
    } else {
      v[j][0] = v[j][1] = v[j][2] = v[j][3] = 0.f;
    }
}

// The LayerNorm backward per row, in place: n (the normalised rows) <-
// inv · (dn - mean(dn) - n · mean(dn · n)), dn = dout · gain, over the true
// D; where dg is given, dg and db get the strip's column sums of dout · n and
// dout
template <int DT>
__device__ __forceinline__ void ln_backward(const float (&dout)[DT][4], float (&n)[DT][4],
                                            const float* gain, const float (&inv)[2], float* dg,
                                            float* db, int D8, int lane) {
  const int t = lane & 3;
  const float inv_d = 1.f / (8 * D8);
  float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DT; ++j)
    if (j < D8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dn = dout[j][e] * gain[8 * j + 2 * t + (e & 1)];
        m1[e >> 1] += dn;
        m2[e >> 1] += dn * n[j][e];
      }
  if (dg != nullptr) {
    float s[2 * DT];
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) s[2 * j + e] = dout[j][e] * n[j][e] + dout[j][e + 2] * n[j][e + 2];
    add_col_sums<DT>(s, dg, lane);
    add_col_sums<DT>(dout, db, lane);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) m1[r] = quad_sum(m1[r]) * inv_d, m2[r] = quad_sum(m2[r]) * inv_d;
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float dn = j < D8 ? dout[j][e] * gain[8 * j + 2 * t + (e & 1)] : 0.f;
      n[j][e] = j < D8 ? inv[e >> 1] * (dn - m1[e >> 1] - n[j][e] * m2[e >> 1]) : 0.f;
    }
}

enum { V_DG2 = 0, V_DB2 = 1, V_DBW2 = 2, V_DG1 = 3, V_DB1 = 4 };  // the vectors, DP apart

// The floats of scratch that hold the bf16 weights of one call in the layout
// round_weights writes (gw1 [HP][DP + 8], then gw2 [DP][HP + 8])
__host__ __device__ inline size_t weights_floats(int DP, int HP) {
  return (size_t)up(HP * (DP + 8) + DP * (HP + 8), 8) / 2;
}

// w1 [D, H] and w2 [H, D] (read as w[k·w_k + n·w_n]) rounded to bf16 and laid
// out as the main kernels stage them, zeros in the padding: gw1 [HP][DP + 8]
// (w1 transposed) and gw2 [DP][HP + 8] (w2 transposed), by a grid-stride
// loop: the body of each tensor-core generic body's per-call weights kernel
// (K6's ffn_bwd_gmma_weights, K5's residual_ffn_fwd_gmma_weights), so that
// a block stages them by cp.async
__device__ __forceinline__ void round_weights(const float* __restrict__ w1, int w1_k, int w1_n,
                                              const float* __restrict__ w2, int w2_k, int w2_n,
                                              __nv_bfloat16* __restrict__ gw1,
                                              __nv_bfloat16* __restrict__ gw2, int D, int H,
                                              int DP, int HP) {
  const int ld1 = DP + 8, ld2 = HP + 8, n1 = HP * ld1, n2 = DP * ld2;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n1 + n2; e += gridDim.x * blockDim.x) {
    if (e < n1) {
      const int h = e / ld1, k = e % ld1;
      gw1[e] = __float2bfloat16(h < H && k < D ? w1[(size_t)k * w1_k + (size_t)h * w1_n] : 0.f);
    } else {
      const int d = (e - n1) / ld2, h = (e - n1) % ld2;
      gw2[e - n1] = __float2bfloat16(d < D && h < H ? w2[(size_t)h * w2_k + (size_t)d * w2_n] : 0.f);
    }
  }
}

// Blocks of 256 threads for round_weights at (DP, HP): one element a thread,
// at most 1024 blocks
inline int weights_blocks(int DP, int HP) {
  const int n = HP * (DP + 8) + DP * (HP + 8), b = (n + 255) / 256;
  return b < 1024 ? b : 1024;
}

__global__ void ffn_bwd_gmma_weights(const float* __restrict__ w1, int w1_k, int w1_n,
                                     const float* __restrict__ w2, int w2_k, int w2_n,
                                     __nv_bfloat16* __restrict__ gw1,
                                     __nv_bfloat16* __restrict__ gw2, Plan P) {
  round_weights(w1, w1_k, w1_n, w2, w2_k, w2_n, gw1, gw2, P.D, P.H, P.DP, P.HP);
}

template <int DM>
__global__ void __launch_bounds__(THREADS, DM == 32 ? 2 : 1) ffn_bwd_gmma(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ ao,
    const __nv_bfloat16* __restrict__ dz, const float* __restrict__ g1,
    const float* __restrict__ b1, const __nv_bfloat16* __restrict__ gw1,
    const float* __restrict__ bw1, const __nv_bfloat16* __restrict__ gw2,
    const float* __restrict__ bw2, const float* __restrict__ g2, __nv_bfloat16* __restrict__ dx,
    __nv_bfloat16* __restrict__ dao, float* __restrict__ dyp, float* __restrict__ part, long M,
    Plan P, float eps) {
  constexpr int DT = DM / 8, DK = DM / 16, U = units(DM);
  extern __shared__ float4 smem4[];
  float* sf = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(sf + P.floats);
  __nv_bfloat16* s_w1 = sw;
  __nv_bfloat16* s_w2 = sw + P.w2off;
  __nv_bfloat16* strips = sw + P.welems;
  float* vecs = reinterpret_cast<float*>(strips + WARPS * P.strip_elems);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int S = P.S, slice = blockIdx.x % S, R = gridDim.x / S;
  const int h0 = slice * P.HS, hse = min(P.HS, P.HP - h0);  // this block's hidden columns
  const int D = P.D, H = P.H, D8 = P.D8, dk = P.dk, LDX = P.LDX, LDS = P.LDS;

  // ---- once per block: zeros (the strips' padding), the float32 vectors,
  // resident weights
  for (int i = tid; i < (P.welems + WARPS * P.strip_elems) / 8; i += THREADS)
    reinterpret_cast<uint4*>(sw)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < WARPS * P.vec; i += THREADS) vecs[i] = 0.f;
  for (int n = tid; n < P.DP; n += THREADS) {
    const bool in = n < D;
    sf[P.f_g1 + n] = in ? g1[n] : 0.f;
    sf[P.f_b1 + n] = in ? b1[n] : 0.f;
    sf[P.f_g2 + n] = in ? g2[n] : 0.f;
    sf[P.f_bw2 + n] = in ? bw2[n] : 0.f;
  }
  for (int n = tid; n < P.HP; n += THREADS) sf[P.f_bw1 + n] = n < H ? bw1[n] : 0.f;
  __syncthreads();  // the zeros are down before the weights go over them
  // hidden columns [c0, c0 + n) of the bf16 weights ffn_bwd_gmma_weights laid
  // out, w1 as [HP][ld1] and w2 as [DP][HP + 8], by cp.async
  auto stage = [&](int c0, int n) {
    const int r1 = P.ld1 / 8, r2 = n / 8;
    for (int c = tid; c < n * r1; c += THREADS)
      cp_async16(s_w1 + (c / r1) * P.ld1 + 8 * (c % r1), gw1 + (size_t)(c0 + c / r1) * P.ld1 + 8 * (c % r1));
    for (int c = tid; c < P.DP * r2; c += THREADS)
      cp_async16(s_w2 + (c / r2) * P.ld2 + 8 * (c % r2),
                 gw2 + (size_t)(c / r2) * (P.HP + 8) + c0 + 8 * (c % r2));
    cp_async_commit();
    cp_async_wait_all();
  };
  if (P.resident) stage(0, P.HP);
  __syncthreads();
  auto stream = [&](int c0, int n) {  // a streamed stage, between two block barriers
    __syncthreads();
    stage(c0, n);
    __syncthreads();
  };

  __nv_bfloat16* mine = strips + warp * P.strip_elems;
  __nv_bfloat16* s_x = mine;  // x, then yc
  __nv_bfloat16* s_ao = s_x + 16 * LDX;
  __nv_bfloat16* s_dz = s_ao + 16 * LDX;  // dz, then doc
  __nv_bfloat16* s_hc = s_dz + 16 * LDX;  // hc of the slice
  __nv_bfloat16* s_du = s_hc + 16 * LDS;  // duc of the slice
  float* vec = vecs + warp * P.vec;       // dg2 db2 dbw2 dg1 db1 [DP], dbw1 [HS]
  float* vbw1 = vec + 5 * P.DP;
  // this warp's units of the block's dw1 [DP][hse] (rows 16·(u / hcs), columns
  // 16·(u % hcs)) and dw2 [hse][DP] (rows 16·(u / dk), columns 16·(u % dk)),
  // u = warp + WARPS·i, summed over all the block's tiles
  const int hcs = hse / 16, units_used = dk * hcs;
  float cw1[U][2][4], cw2[U][2][4];
#pragma unroll
  for (int i = 0; i < U; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) cw1[i][0][e] = cw1[i][1][e] = cw2[i][0][e] = cw2[i][1][e] = 0.f;
  const int step = P.resident ? P.HP : CHUNK;

  const long tiles = (M + TILE - 1) / TILE;
  for (long tile = blockIdx.x / S; tile < tiles; tile += R) {
    const long row0 = tile * TILE + 16 * warp;
    load_rows(s_x, x, row0, M, D, LDX, lane);
    load_rows(s_ao, ao, row0, M, D, LDX, lane);
    load_rows(s_dz, dz, row0, M, D, LDX, lane);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();

    // 1. y = x + (n1·g1 + b1), n1 = LN1's normalised attn_out;  yc -> the x strip
    {
      float y[DT][4], xv[DT][4], inv1[2];
      read_strip(s_ao, LDX, y, D8, lane);
      normalize_rows(y, eps, inv1, D8);
      read_strip(s_x, LDX, xv, D8, lane);
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          y[j][e] = xv[j][e] + (y[j][e] * sf[P.f_g1 + c] + sf[P.f_b1 + c]);
        }
      __syncwarp();
      write_strip(s_x, LDX, y, D8, lane);
      __syncwarp();
    }

    // 2. pass 1: o = hc · w2 + bw2, hc = bf16(GELU(yc · w1 + bw1)); the
    //    slice's hc -> the hc strip
    float o[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int c = 8 * j + 2 * t;
      o[j][0] = o[j][2] = sf[P.f_bw2 + c];
      o[j][1] = o[j][3] = sf[P.f_bw2 + c + 1];
    }
#pragma unroll 1
    for (int c0 = 0; c0 < P.HP; c0 += step) {
      const int n = min(step, P.HP - c0), base = P.resident ? 0 : c0;
      if (!P.resident) stream(c0, n);
#pragma unroll 1
      for (int h = c0; h < c0 + n; h += 16) {
        float hid[2][4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int c = h + 8 * hf + 2 * t;
          hid[hf][0] = hid[hf][2] = sf[P.f_bw1 + c];
          hid[hf][1] = hid[hf][3] = sf[P.f_bw1 + c + 1];
        }
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          if (kk >= dk) break;
          uint32_t a[4];
          load_a(a, s_x, LDX, 0, 16 * kk, lane);
          mma_pair(hid[0], hid[1], a, s_w1, P.ld1, h - base, 16 * kk, lane);
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 4; ++e) hid[hf][e] = act::gelu(hid[hf][e]);
        uint32_t ha[4];
        to_a(ha, hid[0], hid[1]);
        if (h >= h0 && h < h0 + hse) store_a(s_hc, LDS, h - h0, ha, lane);
#pragma unroll
        for (int n2 = 0; n2 < DK; ++n2) {
          if (n2 >= dk) break;
          mma_pair(o[2 * n2], o[2 * n2 + 1], ha, s_w2, P.ld2, 16 * n2, h - base, lane);
        }
      }
    }

    // 3. LN2 backward: o -> n2 -> do (the vector sums by slice 0's blocks);
    //    dy = dz (a slice's share of dy - dz starts from 0);  doc -> the dz strip
    float dy[DT][4];
    {
      float inv2[2];
      normalize_rows(o, eps, inv2, D8);
      read_strip(s_dz, LDX, dy, D8, lane);
      const bool first = slice == 0;
      ln_backward(dy, o, sf + P.f_g2, inv2, first ? vec + V_DG2 * P.DP : nullptr,
                  vec + V_DB2 * P.DP, D8, lane);
      if (first) add_col_sums(o, vec + V_DBW2 * P.DP, lane);
      if (S > 1)
#pragma unroll
        for (int j = 0; j < DT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dy[j][e] = 0.f;
      __syncwarp();  // every lane has read dz
      write_strip(s_dz, LDX, o, D8, lane);
      __syncwarp();
    }

    // 4. pass 2 over the slice, per hidden chunk: u again, dh = doc · w2ᵀ,
    //    du = dh · GELU'(u) (dbw1 += Σ du), duc -> the du strip, dy += duc · w1ᵀ
#pragma unroll 1
    for (int c0 = h0; c0 < h0 + hse; c0 += step) {
      const int n = min(step, h0 + hse - c0), base = P.resident ? 0 : c0;
      if (!P.resident) stream(c0, n);
#pragma unroll 1
      for (int h = c0; h < c0 + n; h += 16) {
        float u[2][4], dh[2][4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int c = h + 8 * hf + 2 * t;
          u[hf][0] = u[hf][2] = sf[P.f_bw1 + c];
          u[hf][1] = u[hf][3] = sf[P.f_bw1 + c + 1];
#pragma unroll
          for (int e = 0; e < 4; ++e) dh[hf][e] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          if (kk >= dk) break;
          uint32_t a[4];
          load_a(a, s_x, LDX, 0, 16 * kk, lane);
          mma_pair(u[0], u[1], a, s_w1, P.ld1, h - base, 16 * kk, lane);
          load_a(a, s_dz, LDX, 0, 16 * kk, lane);
          mma_pair_t(dh[0], dh[1], a, s_w2, P.ld2, h - base, 16 * kk, lane);
        }
        float s4[4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dh[hf][e] *= act::gelu_grad(u[hf][e]);
          s4[2 * hf] = dh[hf][0] + dh[hf][2];
          s4[2 * hf + 1] = dh[hf][1] + dh[hf][3];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) s4[i] = column_sum(s4[i]);
        if (g == 0)
#pragma unroll
          for (int i = 0; i < 4; ++i) vbw1[h - h0 + 8 * (i >> 1) + 2 * t + (i & 1)] += s4[i];
        uint32_t dua[4];
        to_a(dua, dh[0], dh[1]);
        store_a(s_du, LDS, h - h0, dua, lane);
#pragma unroll
        for (int n2 = 0; n2 < DK; ++n2) {
          if (n2 >= dk) break;
          mma_pair_t(dy[2 * n2], dy[2 * n2 + 1], dua, s_w1, P.ld1, 16 * n2, h - base, lane);
        }
      }
    }

    // 5. one slice: dx = bf16(dy), LN1 backward (n1 again) -> d attn_out, out
    //    through the attn_out strip;  several: this slice's share of dy - dz
    if (S == 1) {
      float n1[DT][4], inv1[2];
      read_strip(s_ao, LDX, n1, D8, lane);
      normalize_rows(n1, eps, inv1, D8);
      ln_backward(dy, n1, sf + P.f_g1, inv1, vec + V_DG1 * P.DP, vec + V_DB1 * P.DP, D8, lane);
      __syncwarp();  // every lane has read attn_out
      write_strip(s_ao, LDX, dy, D8, lane);
      __syncwarp();
      store_rows(dx, s_ao, row0, M, D, LDX, lane);
      __syncwarp();
      write_strip(s_ao, LDX, n1, D8, lane);
      __syncwarp();
      store_rows(dao, s_ao, row0, M, D, LDX, lane);
    } else {
      float* share = dyp + (size_t)slice * M * D;
#pragma unroll
      for (int j = 0; j < DT; ++j)
        if (j < D8)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const long row = row0 + g + 8 * r;
            if (row < M)
              *reinterpret_cast<float2*>(share + row * D + 8 * j + 2 * t) =
                  make_float2(dy[j][2 * r], dy[j][2 * r + 1]);
          }
    }
    __syncthreads();  // every warp's yc, hc, doc and duc strips are in

    // 6. this warp's units of dw1 += ycᵀ·duc and dw2 += hcᵀ·doc over the
    //    tile's rows, one 16-row k-step per strip
#pragma unroll 1
    for (int w = 0; w < WARPS; ++w) {
      const __nv_bfloat16* yc = strips + w * P.strip_elems;
      const __nv_bfloat16* doc = yc + 32 * LDX;
      const __nv_bfloat16* hc = yc + 48 * LDX;
      const __nv_bfloat16* duc = hc + 16 * LDS;
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int u = warp + WARPS * i;
        if (u >= units_used) break;
        uint32_t a[4];
        load_a_t(a, yc, LDX, 16 * (u / hcs), 0, lane);
        mma_pair_t(cw1[i][0], cw1[i][1], a, duc, LDS, 16 * (u % hcs), 0, lane);
        load_a_t(a, hc, LDS, 16 * (u / dk), 0, lane);
        mma_pair_t(cw2[i][0], cw2[i][1], a, doc, LDX, 16 * (u % dk), 0, lane);
      }
    }
    __syncthreads();  // the strips are free for the next tile
  }

  // the block's slot: dw1 and dw2 from the warps' units (the real rows and
  // columns), the vectors summed over the warps in order
  float* my = part + (size_t)blockIdx.x * P.psize;
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int u = warp + WARPS * i;
    if (u >= units_used) break;
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), c = 8 * nn + 2 * t + (e & 1);
        const int d1 = 16 * (u / hcs) + r, hh1 = 16 * (u % hcs) + c;
        if (d1 < D && h0 + hh1 < H) my[d1 * P.HS + hh1] = cw1[i][nn][e];
        const int hh2 = 16 * (u / dk) + r, d2 = 16 * (u % dk) + c;
        if (h0 + hh2 < H && d2 < D) my[P.p_dw2 + hh2 * D + d2] = cw2[i][nn][e];
      }
  }
  __syncthreads();
  for (int e = tid; e < hse; e += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += vecs[w * P.vec + 5 * P.DP + e];
    if (h0 + e < H) my[P.p_dbw1 + e] = s;
  }
  if (slice == 0)
    for (int e = tid; e < 5 * D; e += THREADS) {
      const int v = e / D, c = e % D;
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += vecs[w * P.vec + v * P.DP + c];
      my[P.p_vec + e] = s;
    }
}

// Several slices: dy = dz + the slices' shares in slice order, dx = bf16(dy),
// d attn_out by the LN1 backward, one warp per row (a block's step: a row a
// warp) (n1 recomputed from
// attn_out); the block's sums of dg1 and db1 (per warp, then over the warps
// in order) into its slot of part2 [blocks][2D].
__global__ void __launch_bounds__(THREADS) ffn_bwd_gmma_finish(
    const __nv_bfloat16* __restrict__ ao, const __nv_bfloat16* __restrict__ dz,
    const float* __restrict__ dyp, const float* __restrict__ g1, __nv_bfloat16* __restrict__ dx,
    __nv_bfloat16* __restrict__ dao, float* __restrict__ part2, long M, int D, int S, float eps) {
  __shared__ float sums[WARPS][2][MAX_D];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int CPL = MAX_D / 32;  // columns a lane holds
  float pg[CPL] = {}, pb[CPL] = {};
  for (long row = (long)blockIdx.x * WARPS + warp; row < M; row += (long)gridDim.x * WARPS) {
    const size_t base = (size_t)row * D;
    float a[CPL], dy[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      a[i] = c < D ? __bfloat162float(ao[base + c]) : 0.f;
      float s = 0.f;
      if (c < D) {
        s = __bfloat162float(dz[base + c]);
        for (int sl = 0; sl < S; ++sl) s += dyp[(size_t)sl * M * D + base + c];
      }
      dy[i] = s;
    }
    float s1 = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) s1 += a[i];
    const float mu = warp_sum(s1) / D;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      a[i] = lane + 32 * i < D ? a[i] - mu : 0.f;
      q += a[i] * a[i];
    }
    const float inv = rsqrtf(warp_sum(q) / D + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      const float n = a[i] * inv, dn = c < D ? dy[i] * g1[c] : 0.f;
      a[i] = n;
      m1 += dn, m2 += dn * n;
      pg[i] = fmaf(dy[i], n, pg[i]);
      pb[i] += dy[i];
    }
    m1 = warp_sum(m1) / D, m2 = warp_sum(m2) / D;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < D) {
        store(dx + base + c, dy[i]);
        store(dao + base + c, inv * (dy[i] * g1[c] - m1 - a[i] * m2));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i) sums[warp][0][lane + 32 * i] = pg[i], sums[warp][1][lane + 32 * i] = pb[i];
  __syncthreads();
  for (int e = tid; e < 2 * D; e += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += sums[w][e / D][e % D];
    part2[(size_t)blockIdx.x * 2 * D + e] = s;
  }
}

// The cotangents out of the blocks' slots, in residual_ffn_bwd.cu's layout
// (dg1, db1 [D], dw1 [D, H], dbw1 [H], dw2 [H, D], dbw2, dg2, db2 [D]): each
// element the sum, in a fixed order, of the slots of the blocks that hold it
// (those of its slice; the vectors slice 0's; dg1 and db1 the finishing
// blocks' where there are several slices), dw1 and dw2 rounded to bf16.  A
// block of 8 warps owns 32 consecutive outputs: warp w adds the slots of the
// holding blocks w, w + 8, ... (coalesced across the lanes), then the eight
// warps' sums are added in warp order.
__global__ void __launch_bounds__(256) ffn_bwd_gmma_reduce(const float* __restrict__ part,
                                                           int blocks,
                                                           const float* __restrict__ part2,
                                                           int blocks2, float* __restrict__ out,
                                                           Plan P) {
  __shared__ float sums[8][32];
  const int D = P.D, H = P.H, HS = P.HS, S = P.S;
  const int o_dw1 = 2 * D, o_dbw1 = o_dw1 + D * H, o_dw2 = o_dbw1 + H, o_dbw2 = o_dw2 + H * D;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane, total = o_dbw2 + 3 * D;
  const float* src = part;  // the holding blocks' slots: src[(first + S·k)·stride + off]
  int first = 0, off = 0, stride = P.psize, step = S, count = blocks;
  bool weight = false;
  if (e >= total) {
    count = 0;
  } else if (e < o_dw1) {
    if (S > 1)
      src = part2, stride = 2 * D, step = 1, count = blocks2, off = e;
    else
      off = P.p_vec + (e < D ? V_DG1 : V_DB1) * D + e % D;
  } else if (e < o_dbw1) {
    const int k = (e - o_dw1) / H, n = (e - o_dw1) % H;
    first = n / HS, off = k * HS + n % HS, weight = true;
  } else if (e < o_dw2) {
    const int n = e - o_dbw1;
    first = n / HS, off = P.p_dbw1 + n % HS;
  } else if (e < o_dbw2) {
    const int h = (e - o_dw2) / D, d = (e - o_dw2) % D;
    first = h / HS, off = P.p_dw2 + (h % HS) * D + d, weight = true;
  } else {
    const int v = (e - o_dbw2) / D;  // dbw2, dg2, db2
    off = P.p_vec + (v == 0 ? V_DBW2 : v == 1 ? V_DG2 : V_DB2) * D + (e - o_dbw2) % D;
  }
  float s = 0.f;
#pragma unroll 8
  for (int b = first + step * w; b < count; b += 8 * step) s += src[(size_t)b * stride + off];
  sums[w][lane] = s;
  __syncthreads();
  if (w != 0 || e >= total) return;
  s = sums[0][lane];
#pragma unroll
  for (int k = 1; k < 8; ++k) s += sums[k][lane];
  out[e] = weight ? round_as<__nv_bfloat16>(s) : s;
}

// Grid and scratch of one call: blocks R·S of the main kernel, of the
// finishing kernel (0 with one slice), and the floats of scratch (the
// slices' shares of dy, the main kernel's slots, the finishing kernel's).
struct Launch {
  int blocks, fin_blocks;
  size_t wts, dyp, part, floats;  // wts: the bf16 weights, in floats
};

template <int DM>
int grid(const Plan& P, long M, Launch* L) {
  static int cache[64][3] = {};
  int total = 0;
  const int err = tmar::persistent_grid(ffn_bwd_gmma<DM>, P.bytes, THREADS, cache, &total);
  if (err != 0) return err;
  const long tiles = (M + TILE - 1) / TILE;
  long R = total / P.S;
  if (R > tiles) R = tiles;
  if (R < 1) R = 1;
  L->blocks = (int)R * P.S;
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long fin = (M + WARPS - 1) / WARPS;  // a finishing block takes a row a warp
  L->fin_blocks = P.S > 1 ? (int)(fin < 4L * sms ? fin : 4L * sms) : 0;
  L->wts = weights_floats(P.DP, P.HP);
  L->dyp = P.S > 1 ? (size_t)P.S * M * P.D : 0;
  L->part = (size_t)L->blocks * P.psize;
  L->floats = L->wts + L->dyp + L->part + (size_t)L->fin_blocks * 2 * P.D;
  return 0;
}

inline int grid_for(const Plan& P, long M, Launch* L) {
  const int DM = dm_of(P.DP);
  return DM == 32 ? grid<32>(P, M, L) : DM == 64 ? grid<64>(P, M, L) : grid<128>(P, M, L);
}

template <int DM>
int launch_t(const void* const* p, int w1_k, int w1_n, int w2_k, int w2_n, void* dx, void* dao,
             float* scratch, void* dparams, long M, const Plan& P, const Launch& L, float eps,
             cudaStream_t stream) {
  __nv_bfloat16* gw1 = reinterpret_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* gw2 = gw1 + P.HP * P.ld1;
  float* dyp = scratch + L.wts;
  float* part = dyp + L.dyp;
  float* part2 = part + L.part;
  ffn_bwd_gmma_weights<<<weights_blocks(P.DP, P.HP), 256, 0, stream>>>(
      (const float*)p[5], w1_k, w1_n, (const float*)p[7], w2_k, w2_n, gw1, gw2, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ffn_bwd_gmma<DM><<<L.blocks, THREADS, P.bytes, stream>>>(
      (const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[1], (const __nv_bfloat16*)p[2],
      (const float*)p[3], (const float*)p[4], gw1, (const float*)p[6], gw2, (const float*)p[8],
      (const float*)p[9], (__nv_bfloat16*)dx, (__nv_bfloat16*)dao, dyp, part, M, P, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (P.S > 1) {
    ffn_bwd_gmma_finish<<<L.fin_blocks, THREADS, 0, stream>>>(
        (const __nv_bfloat16*)p[1], (const __nv_bfloat16*)p[2], dyp, (const float*)p[3],
        (__nv_bfloat16*)dx, (__nv_bfloat16*)dao, part2, M, P.D, P.S, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int size = 5 * P.D + 2 * P.D * P.H + P.H;
  ffn_bwd_gmma_reduce<<<(size + 31) / 32, 256, 0, stream>>>(part, L.blocks, part2, L.fin_blocks,
                                                             (float*)dparams, P);
  return (int)cudaGetLastError();
}

// This body on bf16 activations (x, attn_out, dz, dx, d attn_out 16-byte
// aligned), on `stream`: p holds x, attn_out, dz, g1, b1, w1, bw1, w2, bw2,
// g2; scratch holds `workspace`'s floats.  Returns a cudaError_t code
// (cudaErrorInvalidValue where `plan` takes no plan).
inline int launch(const void* const* p, int w1_k, int w1_n, int w2_k, int w2_n, void* dx,
                  void* dao, void* scratch, void* dparams, long M, int D, int H, float eps,
                  cudaStream_t s) {
  Plan P;
  if (!plan(D, H, &P)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)p[0] | (uintptr_t)p[1] | (uintptr_t)p[2] | (uintptr_t)dx | (uintptr_t)dao) & 15)
    return (int)cudaErrorMisalignedAddress;
  Launch L;
  const int err = grid_for(P, M, &L);
  if (err != 0) return err;
  float* ws = (float*)scratch;
  const int DM = dm_of(P.DP);
  if (DM == 32) return launch_t<32>(p, w1_k, w1_n, w2_k, w2_n, dx, dao, ws, dparams, M, P, L, eps, s);
  if (DM == 64) return launch_t<64>(p, w1_k, w1_n, w2_k, w2_n, dx, dao, ws, dparams, M, P, L, eps, s);
  return launch_t<128>(p, w1_k, w1_n, w2_k, w2_n, dx, dao, ws, dparams, M, P, L, eps, s);
}

}  // namespace ffn_g
}  // namespace
