// The bfloat16 per-window body of a whole NSTB on Hopper's tensor cores,
// shared by K2 (nstb_map.cu) and K8 (nstb_tokens.cu) beside the float32 body
// of nstb_window.cuh, and the dispatch between the two: bfloat16 I/O takes
// this body, float32 I/O the float32 one.  The block's function, the
// `Windows` addressing types and the shift-mask gate are those of
// nstb_window.cuh.
//
// Rounding.  The products take bf16 operands and accumulate in float32, as
// the JAX kernel's dots do (tmar/ops/pallas_nstb.py:_nstb_body and
// pallas_attention.py:batched_attention_core), so the body rounds to bf16
// exactly where that kernel casts: x_attn = bf16(x + ctx); q_n, k_n and v;
// P = bf16(e / sum(e)), normalised before the cast; the attention output
// before the projection; y before fc1; the GELU output before fc2; the
// output.  Biases, LayerNorms, the softmax and every statistic are float32.
// Plain version: tmar_torch/ops/cuda_nstb.py:nstb_math at bfloat16.  The
// mma.sync, ldmatrix, cp.async and reduction helpers are mma.cuh's, shared
// with the window-attention bodies of K3 and K4; the FFN tail (LN1 onwards:
// the weights' staging, fc1, GELU, fc2 and the LayerNorms) is ffn_mma.cuh's,
// shared with the residual FFN's bodies of K5 and K6.
//
// What bounds it on an H100: operations (~79 kFLOP per token against 256
// bytes of I/O; the bf16 tensor-core bound of a 8x512² stage-1 block is
// 0.167 ms).  Design:
// * every product is mma.sync.m16n8k16 (bf16 in, f32 accumulate).  One
//   warpgroup (four warps) takes a window of 64 tokens, each warp 16 rows;
//   WG warpgroups per block share one staged copy of the weights, so WG
//   windows are in flight on each SM;
// * the weights are staged once per block in bf16, transposed to [out][in]
//   so that one ldmatrix.x4 loads the B fragments of two n-tiles, each
//   head's q/k/v columns and the matching rows of wproj padded from head_dim
//   to 16 with zeros, every row stride padded so that ldmatrix's rows and
//   the 32-bit A-fragment loads of a window fall on distinct banks;
// * the chain stays in the registers of the warp that owns the rows: each
//   accumulator fragment is re-packed as the next product's A fragment
//   (x_attn -> qkv -> q_n -> S -> P -> O -> projection -> LN1 -> y -> fc1 ->
//   GELU -> fc2 -> LN2 -> out).  Only each head's k_n and v^T go through
//   shared memory, since all four warps read them; they are double-buffered
//   by head, so one warpgroup barrier per head suffices;
// * the softmax keeps its row max subtraction (a saturated logit scale
//   reaches logits of ~100);
// * windows arrive by cp.async, 16 bytes a thread, double-buffered: the next
//   window and its context quads load while the current one computes.  A
//   16-byte chunk is 8 channels of one token, so K2's wrap-around address is
//   computed once per chunk.  The output goes back through the window's
//   shared slot as 16-byte stores.

#pragma once

#include <stdint.h>

#include "ffn_mma.cuh"
#include "mma.cuh"
#include "nstb_window.cuh"

namespace {

constexpr int HP = 16;              // head dim padded to one m16n8k16 k-step
constexpr int WG = 4;               // warpgroups (windows in flight) per block:
                                    // at 6 heads they fill 220 KB of shared memory
constexpr int MMA_THREADS = 128 * WG;
constexpr int LDX = D + 8;          // bf16 row strides, padded by 16 bytes:
constexpr int LDK = HP + 8;         // fragment loads then fall on distinct
constexpr int LDV = N + 8;          // banks
static_assert(ffn::D == D && ffn::HID == HID, "the FFN tail's widths");

template <int NH>
struct MmaLayout {
  static constexpr int AP = NH * HP;   // padded attention width
  static constexpr int QKV = 3 * AP;
  static constexpr int LDP = AP + 8;
  // float32 region
  static constexpr int BQKV = 0;       // [QKV], zero in the padding
  static constexpr int BPROJ = BQKV + QKV;
  static constexpr int G1 = BPROJ + D;
  static constexpr int B1 = G1 + D;
  static constexpr int G2 = B1 + D;
  static constexpr int B2 = G2 + D;
  static constexpr int BW1 = B2 + D;
  static constexpr int BW2 = BW1 + HID;
  static constexpr int SCALE = BW2 + D;
  static constexpr int TAB = SCALE + 8;                         // [NH][TABLE]
  static constexpr int FLOATS = (TAB + NH * TABLE + 3) / 4 * 4;  // 16-byte multiple
  // bf16 weights, [out][in]
  static constexpr int WQKV = 0;                    // [QKV][LDX]
  static constexpr int WPROJ = WQKV + QKV * LDX;    // [D][LDP]
  static constexpr int W1 = WPROJ + D * LDP;        // [HID][ffn::LW1]
  static constexpr int WELEMS = W1 + ffn::WELEMS;   // then w2 [D][ffn::LW2]
  // bf16, per warpgroup: two window slots, each the tile [N][LDX] and up to
  // four context quads [4][D]; two head slots, each k_n [N][LDK], v^T [HP][LDV]
  static constexpr int CQ = N * LDX;
  static constexpr int SLOT = CQ + 4 * D;
  static constexpr int VT = N * LDK;
  static constexpr int KV = VT + HP * LDV;
  static constexpr int WGELEMS = 2 * SLOT + 2 * KV;
  static constexpr size_t BYTES = FLOATS * sizeof(float) +
                                  (size_t)(WELEMS + WG * WGELEMS) * sizeof(__nv_bfloat16);
  static_assert(WELEMS % 8 == 0 && SLOT % 8 == 0 && KV % 8 == 0, "16-byte aligned regions");
};

// Start the copies of window `win` (its 64 tokens and Q context quads) into
// `slot`, one commit group per thread.
template <typename Windows>
__device__ __forceinline__ void load_window(__nv_bfloat16* slot, const __nv_bfloat16* x,
                                            const __nv_bfloat16* cq, const Windows& wins,
                                            int win, int Q, int wtid) {
  const auto at = wins.at(win);
  for (int c = wtid; c < N * (D / 8); c += 128) {
    const int n = c / (D / 8), part = c % (D / 8);
    cp_async16(slot + n * LDX + part * 8, x + wins.src(at, n) * D + part * 8);
  }
  for (int c = wtid; c < Q * (D / 8); c += 128)
    cp_async16(slot + N * LDX + c * 8, cq + (size_t)win * Q * D + c * 8);
  cp_async_commit();
}

template <int NH, int HD, typename Windows>
__global__ void __launch_bounds__(MMA_THREADS, 1) nstb_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ cq,
    const __nv_bfloat16* __restrict__ wqkv, const float* __restrict__ bqkv,
    const float* __restrict__ scale, const float* __restrict__ table,
    const __nv_bfloat16* __restrict__ wproj, const float* __restrict__ bproj,
    const float* __restrict__ g1, const float* __restrict__ b1,
    const __nv_bfloat16* __restrict__ w1, const float* __restrict__ bw1,
    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ bw2,
    const float* __restrict__ g2, const float* __restrict__ b2,
    __nv_bfloat16* __restrict__ out, Windows wins, int Q, int shift, float eps) {
  static_assert(HD <= HP, "head_dim above one k-step");
  using L = MmaLayout<NH>;
  constexpr int A = NH * HD;
  constexpr int AP = L::AP;
  extern __shared__ float4 smem4[];
  float* sf = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(sf + L::FLOATS);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int tid = threadIdx.x;

  // ---- the weights, once per block: [out][in], heads padded to HP --------
  for (int e = tid; e < D * L::QKV; e += MMA_THREADS) {
    const int i = e / L::QKV, o = e % L::QKV;
    const int part = o / AP, h = (o % AP) / HP, d = o % HP;
    sw[L::WQKV + o * LDX + i] = d < HD ? wqkv[i * 3 * A + part * A + h * HD + d] : zero;
  }
  for (int e = tid; e < AP * D; e += MMA_THREADS) {
    const int i = e / D, o = e % D, h = i / HP, d = i % HP;
    sw[L::WPROJ + o * L::LDP + i] = d < HD ? wproj[(h * HD + d) * D + o] : zero;
  }
  ffn::stage_weights(sw + L::W1, sw + L::W1 + HID * ffn::LW1, w1, HID, 1, w2, D, 1, tid,
                     MMA_THREADS);
  for (int o = tid; o < L::QKV; o += MMA_THREADS) {
    const int part = o / AP, h = (o % AP) / HP, d = o % HP;
    sf[L::BQKV + o] = d < HD ? bqkv[part * A + h * HD + d] : 0.f;
  }
  for (int e = tid; e < D; e += MMA_THREADS) {
    sf[L::BPROJ + e] = bproj[e];
    sf[L::G1 + e] = g1[e];
    sf[L::B1 + e] = b1[e];
    sf[L::G2 + e] = g2[e];
    sf[L::B2 + e] = b2[e];
    sf[L::BW2 + e] = bw2[e];
  }
  for (int e = tid; e < HID; e += MMA_THREADS) sf[L::BW1 + e] = bw1[e];
  if (tid < NH) sf[L::SCALE + tid] = scale[tid] * LOG2E;
  for (int e = tid; e < TABLE * NH; e += MMA_THREADS)
    sf[L::TAB + (e % NH) * TABLE + e / NH] = table[e] * LOG2E;
  __syncthreads();

  const __nv_bfloat16* s_wqkv = sw + L::WQKV;
  const __nv_bfloat16* s_wproj = sw + L::WPROJ;
  const __nv_bfloat16* s_w1 = sw + L::W1;
  const __nv_bfloat16* s_w2 = s_w1 + HID * ffn::LW1;
  const float* s_bqkv = sf + L::BQKV;

  const int wg = tid >> 7, wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // this thread's rows in the window
  __nv_bfloat16* base = sw + L::WELEMS + wg * L::WGELEMS;
  const int edge = WS - shift;  // first in-window row/col of the second band
  const int stride = gridDim.x * WG;

  // Context quadrant of each of the thread's rows (0 when Q = 1 or unshifted)
  const bool band_c = shift > 0 && g >= edge;
  const bool band_r0 = shift > 0 && 2 * warp >= edge, band_r1 = shift > 0 && 2 * warp + 1 >= edge;
  const int quad0 = Q == 1 ? 0 : 2 * band_r0 + band_c;
  const int quad1 = Q == 1 ? 0 : 2 * band_r1 + band_c;

  int win = blockIdx.x * WG + wg;
  if (win < wins.count) load_window(base, x, cq, wins, win, Q, wtid);
  for (int it = 0; win < wins.count; ++it, win += stride) {
    __nv_bfloat16* cur = base + (it & 1) * L::SLOT;
    if (win + stride < wins.count)
      load_window(base + ((it + 1) & 1) * L::SLOT, x, cq, wins, win + stride, Q, wtid);
    else
      cp_async_commit();  // an empty group keeps the wait below uniform
    cp_async_wait_prior();
    warpgroup_sync(wg);   // every thread's copies of this window have landed

    // 1. x_attn = bf16(x + ctx of the row's quadrant), as A fragments
    uint32_t xa[4][4];
    {
      const __nv_bfloat16* c0 = cur + L::CQ + quad0 * D;
      const __nv_bfloat16* c1 = cur + L::CQ + quad1 * D;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int col = 16 * kk + 8 * hf + 2 * t;
          const float2 xv0 = unpack_bf16(cur + r0 * LDX + col), cv0 = unpack_bf16(c0 + col);
          const float2 xv1 = unpack_bf16(cur + r1 * LDX + col), cv1 = unpack_bf16(c1 + col);
          xa[kk][2 * hf] = pack_bf16(xv0.x + cv0.x, xv0.y + cv0.y);
          xa[kk][2 * hf + 1] = pack_bf16(xv1.x + cv1.x, xv1.y + cv1.y);
        }
      }
    }

    // place of the window in its image: gates the shift mask
    const int w = shift > 0 ? win % (wins.wh * wins.ww) : 0;
    const bool mrow = shift > 0 && w / wins.ww == wins.wh - 1;
    const bool mcol = shift > 0 && w % wins.ww == wins.ww - 1;

    // 2. per head: qkv, cosine attention, and its share of the projection
    float pj[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) pj[j][0] = pj[j][1] = pj[j][2] = pj[j][3] = 0.f;
#pragma unroll 1
    for (int h = 0; h < NH; ++h) {
      __nv_bfloat16* s_k = base + 2 * L::SLOT + (h & 1) * L::KV;  // k_n [N][LDK]
      __nv_bfloat16* s_vt = s_k + L::VT;                            // v^T [HP][LDV]
      uint32_t qa[4];
      {
        // q, k, v of head h: tiles j = 2·part + half, columns part·AP + h·HP + 8·half
        float acc[6][4];
#pragma unroll
        for (int j = 0; j < 6; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int p = 0; p < 3; ++p)
            mma_pair(acc[2 * p], acc[2 * p + 1], xa[kk], s_wqkv, LDX, p * AP + h * HP, 16 * kk,
                     lane);
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float* bq = s_bqkv + (j >> 1) * AP + h * HP + (j & 1) * 8 + 2 * t;
          acc[j][0] += bq[0], acc[j][1] += bq[1], acc[j][2] += bq[0], acc[j][3] += bq[1];
        }
        // L2 norms of q (tiles 0, 1) and k (tiles 2, 3) per row, over the quad
        float inv[2][2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float* lo = acc[2 * p];
          const float* hi = acc[2 * p + 1];
          const float s0 = lo[0] * lo[0] + lo[1] * lo[1] + hi[0] * hi[0] + hi[1] * hi[1];
          const float s1 = lo[2] * lo[2] + lo[3] * lo[3] + hi[2] * hi[2] + hi[3] * hi[3];
          inv[p][0] = 1.f / (sqrtf(quad_sum(s0)) + 1e-12f);
          inv[p][1] = 1.f / (sqrtf(quad_sum(s1)) + 1e-12f);
        }
        qa[0] = pack_bf16(acc[0][0] * inv[0][0], acc[0][1] * inv[0][0]);
        qa[1] = pack_bf16(acc[0][2] * inv[0][1], acc[0][3] * inv[0][1]);
        qa[2] = pack_bf16(acc[1][0] * inv[0][0], acc[1][1] * inv[0][0]);
        qa[3] = pack_bf16(acc[1][2] * inv[0][1], acc[1][3] * inv[0][1]);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float* kt = acc[2 + hf];
          sts32(s_k + r0 * LDK + 8 * hf + 2 * t, pack_bf16(kt[0] * inv[1][0], kt[1] * inv[1][0]));
          sts32(s_k + r1 * LDK + 8 * hf + 2 * t, pack_bf16(kt[2] * inv[1][1], kt[3] * inv[1][1]));
          const float* vt = acc[4 + hf];
          const int d = 8 * hf + 2 * t;
          s_vt[d * LDV + r0] = __float2bfloat16(vt[0]);
          s_vt[(d + 1) * LDV + r0] = __float2bfloat16(vt[1]);
          s_vt[d * LDV + r1] = __float2bfloat16(vt[2]);
          s_vt[(d + 1) * LDV + r1] = __float2bfloat16(vt[3]);
        }
      }
      warpgroup_sync(wg);  // head h's k_n and v^T are in; head h - 2's are read

      // S = q_n · k_nᵀ, tile j = keys [8j, 8j + 8): key row j, key columns 2t, 2t + 1
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; j += 2) mma_pair(s[j], s[j + 1], qa, s_k, LDK, 8 * j, 0, lane);
      // · scale + relative-position bias + shift mask, all staged times
      // log2(e) so that the exponential is one ex2; the row max
      const float sc = sf[L::SCALE + h];
      constexpr float MASK = -100.f * LOG2E;
      const float* tab = sf + L::TAB + h * TABLE;
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // query (2·warp, g) / (2·warp + 1, g) against key (j, 2t) / (j, 2t + 1)
        const int bi = (2 * warp - j + WS - 1) * (2 * WS - 1) + (g - 2 * t + WS - 1);
        s[j][0] = s[j][0] * sc + tab[bi];
        s[j][1] = s[j][1] * sc + tab[bi - 1];
        s[j][2] = s[j][2] * sc + tab[bi + 2 * WS - 1];
        s[j][3] = s[j][3] * sc + tab[bi + 2 * WS - 2];
        if (mrow) {
          const bool kb = j >= edge;
          if (band_r0 != kb) s[j][0] += MASK, s[j][1] += MASK;
          if (band_r1 != kb) s[j][2] += MASK, s[j][3] += MASK;
        }
        if (mcol) {
          if (band_c != (2 * t >= edge)) s[j][0] += MASK, s[j][2] += MASK;
          if (band_c != (2 * t + 1 >= edge)) s[j][1] += MASK, s[j][3] += MASK;
        }
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
      m0 = quad_max(m0);
      m1 = quad_max(m1);
      float z0 = 0.f, z1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = exp2_approx(s[j][0] - m0), s[j][1] = exp2_approx(s[j][1] - m0);
        s[j][2] = exp2_approx(s[j][2] - m1), s[j][3] = exp2_approx(s[j][3] - m1);
        z0 += s[j][0] + s[j][1];
        z1 += s[j][2] + s[j][3];
      }
      const float iz0 = 1.f / quad_sum(z0), iz1 = 1.f / quad_sum(z1);
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] *= iz0, s[j][1] *= iz0, s[j][2] *= iz1, s[j][3] *= iz1;

      // O = bf16(P) · v, then its share of the projection
      float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
        to_a(pa, s[2 * kk], s[2 * kk + 1]);
        mma_pair(o[0], o[1], pa, s_vt, LDV, 0, 16 * kk, lane);
      }
      uint32_t oa[4];
      to_a(oa, o[0], o[1]);
#pragma unroll
      for (int j = 0; j < 8; j += 2) mma_pair(pj[j], pj[j + 1], oa, s_wproj, L::LDP, 8 * j, h * HP, lane);
    }

    // 3. y = x + LN1(a), a = projection + bproj
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      pj[j][0] += sf[L::BPROJ + c], pj[j][1] += sf[L::BPROJ + c + 1];
      pj[j][2] += sf[L::BPROJ + c], pj[j][3] += sf[L::BPROJ + c + 1];
    }
    ffn::layer_norm_rows(pj, sf + L::G1, sf + L::B1, eps, t);
    float (&y)[8][4] = pj;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 x0 = unpack_bf16(cur + r0 * LDX + c), x1 = unpack_bf16(cur + r1 * LDX + c);
      y[j][0] += x0.x, y[j][1] += x0.y, y[j][2] += x1.x, y[j][3] += x1.y;
    }

    // 4. f = bf16(GELU(bf16(y) · w1 + bw1)) · w2 + bw2, 16 hidden columns at a time
    float f[8][4];
    ffn::fc(y, f, s_w1, s_w2, sf + L::BW1, sf + L::BW2, lane);

    // 5. z = y + LN2(f) -> bf16 in the window's slot (own rows), then out
    ffn::layer_norm_rows(f, sf + L::G2, sf + L::B2, eps, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      sts32(cur + r0 * LDX + c, pack_bf16(y[j][0] + f[j][0], y[j][1] + f[j][1]));
      sts32(cur + r1 * LDX + c, pack_bf16(y[j][2] + f[j][2], y[j][3] + f[j][3]));
    }
    __syncwarp();
    {
      const auto at = wins.at(win);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane + 32 * i, row = 16 * warp + c / 8, part = c % 8;
        *reinterpret_cast<uint4*>(out + wins.dst(at, row) * D + part * 8) =
            *reinterpret_cast<const uint4*>(cur + row * LDX + part * 8);
      }
    }
    warpgroup_sync(wg);  // the slot is free for the window after next
  }
}

// The bf16 body: persistent blocks of WG warpgroups, on `stream`.  p holds
// the 16 inputs in the kernel's order; x, the context quads and out must be
// 16-byte aligned.  Returns a cudaError_t code.
template <int NH, int HD, typename Windows>
int launch_nstb_mma(const void* const* p, void* out, const Windows& wins, int Q, int shift,
                    float eps, cudaStream_t stream) {
  if (((uintptr_t)p[0] | (uintptr_t)p[1] | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  using L = MmaLayout<NH>;
  auto kern = nstb_mma_kernel<NH, HD, Windows>;
  static int grid_cache[MAX_DEVICES] = {};
  int grid = 0;
  cudaError_t err = persistent_grid(kern, MMA_THREADS, L::BYTES, grid_cache, &grid);
  if (err != cudaSuccess) return (int)err;
  const int windows_per_wave = grid * WG;
  const int blocks = wins.count < windows_per_wave ? (wins.count + WG - 1) / WG : grid;
  kern<<<blocks, MMA_THREADS, L::BYTES, stream>>>(
      (const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[1], (const __nv_bfloat16*)p[2],
      (const float*)p[3], (const float*)p[4], (const float*)p[5], (const __nv_bfloat16*)p[6],
      (const float*)p[7], (const float*)p[8], (const float*)p[9], (const __nv_bfloat16*)p[10],
      (const float*)p[11], (const __nv_bfloat16*)p[12], (const float*)p[13],
      (const float*)p[14], (const float*)p[15], (__nv_bfloat16*)out, wins, Q, shift, eps);
  return (int)cudaGetLastError();
}

// The full-width NGswin's heads, 6 x 10 and 4 x 16 at D = 64: bfloat16 I/O
// runs the tensor-core body above, float32 the float32 body of
// nstb_window.cuh.
template <typename Windows>
int dispatch_nstb(int num_heads, int head_dim, int is_bf16, const void* const* p, void* out,
                  const Windows& wins, int Q, int shift, float eps, cudaStream_t stream) {
  if (num_heads == 6 && head_dim == 10)
    return is_bf16 ? launch_nstb_mma<6, 10>(p, out, wins, Q, shift, eps, stream)
                   : launch_nstb<6, 10, float>(p, out, wins, Q, shift, eps, stream);
  if (num_heads == 4 && head_dim == 16)
    return is_bf16 ? launch_nstb_mma<4, 16>(p, out, wins, Q, shift, eps, stream)
                   : launch_nstb<4, 16, float>(p, out, wins, Q, shift, eps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
