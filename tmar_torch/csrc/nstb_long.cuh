// The long-window body of a whole NSTB (N-gram Swin Transformer Block),
// shared by K2 (nstb_map.cu) and K8 (nstb_tokens.cu): windows of more than 64
// tokens (past 8x8: HAT's 16x16 is N = 256) and heads wider than 32 channels,
// at either I/O type, which the other bodies (nstb_window*.cuh,
// nstb_generic*.cuh) do not take.  It computes what they compute, and what
// the TPU kernels tmar/ops/pallas_nstb.py:_nstb_map_kernel (:640) and
// :_nstb_kernel (:334) compute at any window:
//   x_attn = x + ctx_tok                      (the context of the token's quadrant)
//   a      = proj(softmax(cos(q, k)·scale + rpb + shift mask)·v)
//   y      = x + LN1(a)                       (residual WITHOUT the context)
//   z      = y + LN2(fc2(GELU(fc1(y))))
// rounding at bf16 where they round (nstb_generic.cuh lists the points).
//
// A window's q/k/v alone is 196,608 bytes at N = 256, A = 64 in float32, so
// no block holds a window.  Four launches meet in a float32 workspace in
// device memory (workspace floats: qkv and the head outputs of every token):
//   1. qkv = x_attn·wqkv + bqkv (attn_long::rows_gemm; x_attn gathered per
//      token from the map or the windows, with its quadrant's context);
//   2. q and k normalised (attn_long::qk_norm);
//   3. the attention (attn_long::attn_fwd, key tiles streamed through shared
//      memory, the relative-position table and the band mask computed per
//      score);
//   4. the tail on tiles of token rows: the projection, y = x + LN1(a), the
//      FFN and LN2, z written to the token's place (nstb_tail below).
// All on the CUDA cores in float32, no atomics: the body of float32 (the
// exactness path) and of bf16 geometries the tensor-core body below has no
// plan for; ~215x its operations bound at the window-16 request's stage 1
// (PERF.md §6).
//
// At bf16 the tensor-core long-window body (launch_tc) runs wherever
// long_mma::nstb_plan_bytes has a plan (nstb_mma::body): three launches over
// a bf16 workspace (long_mma::fwd_workspace): long_mma::heads_gemm (the qkv
// product of x_attn gathered per token, q/k norms in its epilogue, q_n, k_n,
// v stored as the bf16 values the JAX kernel rounds them to), long_mma::
// attn_fwd_tc (a block per window and head, the table bias and band mask per
// score, P normalised before its rounding) and nstb_tail_tc (projection, LN1,
// the FFN in 16-column hidden chunks adding into fc2's accumulator, LN2, all
// on mma.sync; fc1 / fc2 resident in the block or streamed by 64 hidden
// columns).  From the projection on, the tail is the generic tensor-core
// body's own (nstb_mma::ffn_tail), so it rounds where nstb_generic_mma.cuh
// does; the attention's
// softmax bounds it (an exponential and a table read per score: the
// products of a 256-token window at head_dim 10 are a few percent of its
// instructions).

#pragma once

#include "gelu.cuh"
#include "long_mma.cuh"
#include "nstb_generic_mma.cuh"
#include "window_attention_long.cuh"

namespace {
namespace nstb_long {

using attn_long::NT;
using attn_long::odd;

// token rows of a tail tile: the most of 32, 16, ..., 1 that fit a block
inline size_t tail_bytes(int D, int A, int H, int rows) {
  return (size_t)4 * rows * (odd(A) + 2 * odd(D) + odd(H));
}
inline int tail_rows(int D, int A, int H) {
  int r = 32;
  while (r > 1 && tail_bytes(D, A, H, r) > tmar::MAX_SMEM) r /= 2;
  return r;
}

// The largest block of the four launches (tmar_torch/ops/envelope.py:
// nstb_long_bytes counts the same).
inline size_t plan_bytes(int N, int D, int nh, int hd, int H) {
  const int A = nh * hd;
  size_t b = attn_long::gemm_bytes(D, attn_long::gemm_rows(D));
  const size_t f = attn_long::fwd_bytes(N, hd), t = tail_bytes(D, A, H, tail_rows(D, A, H));
  b = f > b ? f : b;
  return t > b ? t : b;
}
inline bool fits(int N, int D, int nh, int hd, int H) {
  return N >= 1 && D >= 1 && nh >= 1 && hd >= 1 && H >= 1 && plan_bytes(N, D, nh, hd, H) <= tmar::MAX_SMEM;
}
inline long long workspace(int nwin, int N, int nh, int hd) {
  return (long long)nwin * N * 4 * nh * hd;
}

// x_attn of token t = win·N + n: x at the token's place plus its quadrant's
// context, rounded to T's values.
template <typename T, typename Windows>
struct XAttn {
  const T* x;
  const T* cq;
  Windows wins;
  int D, Q, shift;
  __device__ __forceinline__ float operator()(long t, int k) const {
    const int ws = wins.ws, N = ws * ws, win = (int)(t / N), n = (int)(t % N), edge = ws - shift;
    const int quad = Q == 1 ? 0 : 2 * (shift > 0 && n / ws >= edge) + (shift > 0 && n % ws >= edge);
    return tmar::round_as<T>(tmar::to_f(x[wins.src(win, n) * D + k]) +
                             tmar::to_f(cq[((size_t)win * Q + quad) * D + k]));
  }
};

// a matrix [in, out] of the I/O type, read in place
template <typename T>
struct MatT {
  const T* w;
  int ld;
  __device__ __forceinline__ float operator()(int k, int n) const {
    return tmar::to_f(w[(size_t)k * ld + n]);
  }
};

// The tail on `rows` token rows a block: a = o·wproj + bproj; y = x + LN1(a);
// h = T(GELU(T(y)·w1 + bw1)); f = h·w2 + bw2; z = y + LN2(f) at the token's
// place in out.
template <typename T, typename Windows>
__global__ void __launch_bounds__(NT) nstb_tail(
    const float* __restrict__ o, const T* __restrict__ x, const T* __restrict__ wproj,
    const float* __restrict__ bproj, const float* __restrict__ g1, const float* __restrict__ b1,
    const T* __restrict__ w1, const float* __restrict__ bw1, const T* __restrict__ w2,
    const float* __restrict__ bw2, const float* __restrict__ g2, const float* __restrict__ b2,
    T* __restrict__ out, Windows wins, long T_, int D, int A, int H, int rows, float eps) {
  using tmar::round_as;
  using tmar::to_f;
  extern __shared__ float sm[];
  const int LA = odd(A), LD = odd(D), LH = odd(H), N = wins.ws * wins.ws;
  float* so = sm;               // the head outputs [rows][LA]
  float* sa = so + rows * LA;   // a, then f [rows][LD]
  float* sy = sa + rows * LD;   // y [rows][LD]
  float* sh = sy + rows * LD;   // the hidden layer [rows][LH]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long t0 = (long)blockIdx.x * rows;
  const int nr = T_ - t0 < rows ? (int)(T_ - t0) : rows;
  for (int e = threadIdx.x; e < nr * A; e += NT) so[(e / A) * LA + e % A] = o[(t0 + e / A) * A + e % A];
  __syncthreads();
  tmar::mm_rt(nr, D, A, [&](int m, int k) { return so[m * LA + k]; },
              [&](int k, int n) { return to_f(wproj[(size_t)k * D + n]); },
              [&](int m, int n, float v) { sa[m * LD + n] = v + __ldg(bproj + n); });
  __syncthreads();
  for (int r = warp; r < nr; r += NT / 32) {
    const float* a = sa + r * LD;
    const long t = t0 + r;
    const T* xr = x + wins.src((int)(t / N), (int)(t % N)) * D;
    const float2 st = tmar::row_stats(D, eps, [&](int c) { return a[c]; });
    for (int c = lane; c < D; c += 32)
      sy[r * LD + c] = to_f(xr[c]) + (a[c] - st.x) * st.y * __ldg(g1 + c) + __ldg(b1 + c);
  }
  __syncthreads();
  tmar::mm_rt(nr, H, D, [&](int m, int k) { return round_as<T>(sy[m * LD + k]); },
              [&](int k, int n) { return to_f(w1[(size_t)k * H + n]); },
              [&](int m, int n, float v) {
                sh[m * LH + n] = round_as<T>(act::gelu(v + __ldg(bw1 + n)));
              });
  __syncthreads();
  tmar::mm_rt(nr, D, H, [&](int m, int k) { return sh[m * LH + k]; },
              [&](int k, int n) { return to_f(w2[(size_t)k * D + n]); },
              [&](int m, int n, float v) { sa[m * LD + n] = v + __ldg(bw2 + n); });
  __syncthreads();
  for (int r = warp; r < nr; r += NT / 32) {
    const float* f = sa + r * LD;
    const long t = t0 + r;
    const float2 st = tmar::row_stats(D, eps, [&](int c) { return f[c]; });
    T* zr = out + wins.dst((int)(t / N), (int)(t % N)) * D;
    for (int c = lane; c < D; c += 32)
      tmar::store(zr + c, sy[r * LD + c] + (f[c] - st.x) * st.y * __ldg(g2 + c) + __ldg(b2 + c));
  }
}

template <typename T, typename Windows>
int launch_t(const void* const* p, void* out, float* ws, const Windows& wins, int D, int H, int nh,
             int hd, int Q, int shift, float eps, cudaStream_t s) {
  const int N = wins.ws * wins.ws, A = nh * hd, L3 = 3 * A;
  const long T_ = (long)wins.count * N;
  float* qkv = ws;
  float* o = ws + (size_t)T_ * L3;
  const XAttn<T, Windows> xa{(const T*)p[0], (const T*)p[1], wins, D, Q, shift};
  int err = attn_long::launch_gemm(T_, D, L3, xa, MatT<T>{(const T*)p[2], L3},
                                   attn_long::Out{qkv, L3, (const float*)p[3]}, s);
  if (!err) err = attn_long::launch_norm(qkv, nullptr, T_, nh, hd, s);
  if (err) return err;
  const attn_long::TableBias bias{(const float*)p[5], wins.ws, nh, shift, wins.wh, wins.ww, 0,
                                  false, false};
  err = attn_long::launch_attn_fwd(qkv, (const float*)p[4], bias, o, nullptr, wins.count, N, nh,
                                   hd, sizeof(T) == 2, sizeof(T) == 2, s);
  if (err) return err;
  const int rows = tail_rows(D, A, H);
  const size_t bytes = tail_bytes(D, A, H, rows);
  auto kern = nstb_tail<T, Windows>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)((T_ + rows - 1) / rows), NT, bytes, s>>>(
      o, (const T*)p[0], (const T*)p[6], (const float*)p[7], (const float*)p[8],
      (const float*)p[9], (const T*)p[10], (const float*)p[11], (const T*)p[12],
      (const float*)p[13], (const float*)p[14], (const float*)p[15], (T*)out, wins, T_, D, A, H,
      rows, eps);
  return (int)cudaGetLastError();
}

// The long-window body, on `stream`: p holds the 16 inputs in the kernels'
// order, the workspace `workspace` floats.  Returns a cudaError_t code.
template <typename Windows>
int launch(const void* const* p, void* out, void* ws, const Windows& wins, int D, int H, int nh,
           int hd, int Q, int shift, float eps, int is_bf16, cudaStream_t s) {
  if (!ws || !fits(wins.ws * wins.ws, D, nh, hd, H)) return (int)cudaErrorInvalidValue;
  return is_bf16 ? launch_t<__nv_bfloat16>(p, out, (float*)ws, wins, D, H, nh, hd, Q, shift, eps, s)
                 : launch_t<float>(p, out, (float*)ws, wins, D, H, nh, hd, Q, shift, eps, s);
}

// ---- the tensor-core long-window body (bf16; long_mma.cuh) ----------------------

// 8 bf16 values of x_attn at token t = win·N + n, columns [c, c + 8): x at
// the token's place plus its quadrant's context, rounded to bf16
template <typename Windows>
struct XAttn8 {
  const __nv_bfloat16* x;
  const __nv_bfloat16* cq;
  Windows wins;
  int D, Q, shift;
  __device__ __forceinline__ uint4 operator()(long t, int c) const {
    const int ws = wins.ws, N = ws * ws, win = (int)(t / N), n = (int)(t % N), edge = ws - shift;
    const int quad = Q == 1 ? 0 : 2 * (shift > 0 && n / ws >= edge) + (shift > 0 && n % ws >= edge);
    const uint4 a = *reinterpret_cast<const uint4*>(x + wins.src(win, n) * D + c);
    const uint4 b = *reinterpret_cast<const uint4*>(cq + ((size_t)win * Q + quad) * D + c);
    const uint32_t* pa = reinterpret_cast<const uint32_t*>(&a);
    const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
    uint4 r;
    uint32_t* pr = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pa + i));
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pb + i));
      pr[i] = pack_bf16(u.x + v.x, u.y + v.y);
    }
    return r;
  }
};

// The tail on 128-row tiles of tokens, a warp 16 rows, a persistent block:
// the projection bf16(o)·wproj gathered by token, then nstb_mma::ffn_tail
// (y = x + LN1(a), the FFN, z = y + LN2(f)) and z at the token's place.
// The weights resident in the block, fc1's columns and fc2's rows staged
// CHUNK at a time where they do not fit (long_mma::tail_mode).
static_assert(long_mma::CHUNK == nstb_mma::CHUNK, "one streamed stage for both tails");
template <int DM, typename Windows>
__global__ void __launch_bounds__(long_mma::GW * 32) nstb_tail_tc(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ wproj, const float* __restrict__ bproj,
    const float* __restrict__ g1, const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w1,
    const float* __restrict__ bw1, const __nv_bfloat16* __restrict__ w2,
    const float* __restrict__ bw2, const float* __restrict__ g2, const float* __restrict__ b2,
    __nv_bfloat16* __restrict__ out, Windows wins, long T, int D, int nh, int hd, int H,
    int resident, float eps) {
  using long_mma::CHUNK;
  using long_mma::GR;
  using long_mma::up;
  constexpr int DT = DM / 8, DK = DM / 16;
  extern __shared__ float4 smem4[];
  const int DP = up(D, 16), dk = DP / 16, D8 = D / 8, HP = up(hd, 16), AP = nh * HP;
  const int H16 = up(H, 16), H64 = up(H, CHUNK), HC = resident ? H16 : CHUNK;
  const int LDW = DP + 8, LD1 = HC + 8, LDO = AP + 8, LDX = DP + 8, N = wins.ws * wins.ws;
  float* sf = reinterpret_cast<float*>(smem4);
  float *s_bproj = sf, *s_g1 = sf + DP, *s_b1 = sf + 2 * DP, *s_g2 = sf + 3 * DP,
        *s_b2 = sf + 4 * DP, *s_bw2 = sf + 5 * DP, *s_bw1 = sf + 6 * DP;
  __nv_bfloat16* swp = reinterpret_cast<__nv_bfloat16*>(sf + up(6 * DP + H64, 4));
  __nv_bfloat16* sw1 = swp + AP * LDW;
  __nv_bfloat16* sw2 = sw1 + DP * LD1;
  __nv_bfloat16* so = sw2 + HC * LDW;
  __nv_bfloat16* sx = so + GR * LDO;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int n = tid; n < DP; n += nthreads) {
    const bool in = n < D;
    s_bproj[n] = in ? bproj[n] : 0.f;
    s_g1[n] = in ? g1[n] : 0.f;
    s_b1[n] = in ? b1[n] : 0.f;
    s_g2[n] = in ? g2[n] : 0.f;
    s_b2[n] = in ? b2[n] : 0.f;
    s_bw2[n] = in ? bw2[n] : 0.f;
  }
  for (int n = tid; n < H64; n += nthreads) s_bw1[n] = n < H ? bw1[n] : 0.f;
  const __nv_bfloat16 bz = __float2bfloat16(0.f);
  for (int e = tid; e < AP * DP; e += nthreads) {
    const int r = e / DP, n = e % DP, h = r / HP, d = r % HP;
    swp[r * LDW + n] = d < hd && n < D ? wproj[(size_t)(h * hd + d) * D + n] : bz;
  }
  if (resident) {
    for (int e = tid; e < DP * H16; e += nthreads) {
      const int k = e / H16, c = e % H16;
      sw1[k * LD1 + c] = k < D && c < H ? w1[(size_t)k * H + c] : bz;
    }
    for (int e = tid; e < H16 * DP; e += nthreads) {
      const int r = e / DP, n = e % DP;
      sw2[r * LDW + n] = r < H && n < D ? w2[(size_t)r * D + n] : bz;
    }
  }
  const nstb_mma::Tail tail{s_bproj, s_g1, s_b1, s_bw1, s_bw2, s_g2, s_b2, sw1, sw2, LD1, LDW,
                            w1, w2, D, DP, H, resident};
  const long tiles = (T + GR - 1) / GR;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long t0 = tile * GR;
    __syncthreads();  // the last tile's reads are done
    for (int c = tid; c < GR * (AP / 8); c += nthreads) {
      const int r = c / (AP / 8), i = 8 * (c % (AP / 8));
      if (t0 + r < T)
        cp_async16(so + r * LDO + i, o + (size_t)(t0 + r) * AP + i);
      else
        *reinterpret_cast<uint4*>(so + r * LDO + i) = zero4;
    }
    for (int c = tid; c < GR * (DP / 8); c += nthreads) {
      const int r = c / (DP / 8), i = 8 * (c % (DP / 8));
      const long tt = t0 + r;
      if (tt < T && i < D)
        cp_async16(sx + r * LDX + i, x + wins.src((int)(tt / N), (int)(tt % N)) * D + i);
      else
        *reinterpret_cast<uint4*>(sx + r * LDX + i) = zero4;
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // 1. the projection
    float pj[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j) pj[j][0] = pj[j][1] = pj[j][2] = pj[j][3] = 0.f;
    for (int kk = 0; kk < AP / 16; ++kk) {
      uint32_t oa[4];
      load_a(oa, so, LDO, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int n2 = 0; n2 < DK; ++n2) {
        if (n2 >= dk) break;
        mma_pair_t(pj[2 * n2], pj[2 * n2 + 1], oa, swp, LDW, 16 * n2, 16 * kk, lane);
      }
    }

    // 2. y = x + LN1(a), the FFN, z = y + LN2(f) (nstb_mma::ffn_tail), z at
    // the token's place
    nstb_mma::ffn_tail<DM>(pj, sx, LDX, 16 * warp, tail, eps, tid, nthreads, lane);
    const int r0 = 16 * warp + g, r1 = r0 + 8;
    const long ta = t0 + r0, tb = t0 + r1;
    __nv_bfloat16* za = ta < T ? out + wins.dst((int)(ta / N), (int)(ta % N)) * D : nullptr;
    __nv_bfloat16* zb = tb < T ? out + wins.dst((int)(tb / N), (int)(tb % N)) * D : nullptr;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      if (j >= D8) break;
      const int c = 8 * j + 2 * t;
      if (za) sts32(za + c, pack_bf16(pj[j][0], pj[j][1]));
      if (zb) sts32(zb + c, pack_bf16(pj[j][2], pj[j][3]));
    }
  }
}

template <int DM, typename Windows>
int launch_tail_tc(const void* const* p, const __nv_bfloat16* o, void* out, const Windows& wins,
                   long T, int D, int nh, int hd, int H, int resident, size_t bytes, float eps,
                   cudaStream_t s) {
  auto kern = nstb_tail_tc<DM, Windows>;
  static int cache[64][3] = {};
  int grid = 0;
  int err = tmar::persistent_grid(kern, bytes, long_mma::GW * 32, cache, &grid);
  if (err) return err;
  const long tiles = (T + long_mma::GR - 1) / long_mma::GR;
  if (tiles < grid) grid = (int)tiles;
  kern<<<grid, long_mma::GW * 32, bytes, s>>>(
      o, (const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[6], (const float*)p[7],
      (const float*)p[8], (const float*)p[9], (const __nv_bfloat16*)p[10], (const float*)p[11],
      (const __nv_bfloat16*)p[12], (const float*)p[13], (const float*)p[14], (const float*)p[15],
      (__nv_bfloat16*)out, wins, T, D, nh, hd, H, resident, eps);
  return (int)cudaGetLastError();
}

// The tensor-core long-window body on bf16 operands, on `stream`: the qkv
// product with x_attn gathered per token and the q/k norms in its epilogue,
// the attention with the table bias, the tail; three launches over the
// workspace (long_mma::fwd_workspace floats).  x, the context quads, the
// four matrices, out and the workspace must be 16-byte aligned.
template <typename Windows>
int launch_tc(const void* const* p, void* out, void* ws, const Windows& wins, int D, int H, int nh,
              int hd, int Q, int shift, float eps, cudaStream_t s) {
  const int N = wins.ws * wins.ws;
  if (!ws || !long_mma::nstb_plan_bytes(wins.ws, D, nh, hd, H)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)p[0] | (uintptr_t)p[1] | (uintptr_t)p[2] | (uintptr_t)p[6] | (uintptr_t)p[10] |
       (uintptr_t)p[12] | (uintptr_t)out | (uintptr_t)ws) & 15)
    return (int)cudaErrorMisalignedAddress;
  const long_mma::Geom g = long_mma::geom(N, D, nh, hd);
  const long T = (long)wins.count * N;
  __nv_bfloat16* qkv = reinterpret_cast<__nv_bfloat16*>(ws);
  __nv_bfloat16* o = qkv + (size_t)T * 3 * g.AP;
  const XAttn8<Windows> xa{(const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[1], wins, D, Q,
                           shift};
  int err = long_mma::launch_heads(xa, long_mma::MatB{(const __nv_bfloat16*)p[2], 3 * g.A},
                                   (const float*)p[3], qkv, nullptr, nullptr, T, g, 3, 2, s);
  if (err) return err;
  const long_mma::TableBias2 bias{(const float*)p[5], wins.ws, nh, shift, wins.wh, wins.ww,
                                  nullptr, nullptr, false, false};
  err = long_mma::launch_attn(qkv, (const float*)p[4], bias, o, nullptr, wins.count, g, s);
  if (err) return err;
  const int mode = long_mma::tail_mode(g, H);
  const size_t bytes = long_mma::tail_bytes(g, H, mode == 1);
  if (g.DP <= 32) return launch_tail_tc<32>(p, o, out, wins, T, D, nh, hd, H, mode == 1, bytes, eps, s);
  if (g.DP <= 64) return launch_tail_tc<64>(p, o, out, wins, T, D, nh, hd, H, mode == 1, bytes, eps, s);
  return launch_tail_tc<128>(p, o, out, wins, T, D, nh, hd, H, mode == 1, bytes, eps, s);
}

}  // namespace nstb_long
}  // namespace
