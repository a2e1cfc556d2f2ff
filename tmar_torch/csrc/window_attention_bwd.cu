// Scaled-cosine window attention, backward: all seven cotangents.
//
// Replaces the TPU kernels tmar/ops/pallas_attention.py:
// _attn_bwd_kernel_batched (:568, 64-token windows) and :_attn_bwd_kernel
// (:704, the block-diagonal kernel of the n-gram windows: 4 tokens at n = 2,
// 9 at n = 3, 1 at n = 1), both driven by _fused_backward (pallas_call at
// :481).  Plain version:
// tmar_torch/ops/cuda_attention.py:window_attention_backward_math (at
// float32, autograd of tmar_torch/ops/attention.py:window_attention_math).
//
// Given x, the output cotangent g and the forward's lse, it recomputes q, k,
// v and the probabilities p = exp(s - lse) per window and emits
//   dx [nwin, N, D], and summed over all windows:
//   dwqkv [D, 3A], dbqkv [3A], dscale [nh] (on the EFFECTIVE scale: the
//   wrapper routes it through exp∘clip), dbias [nh, N, N], dwproj [A, D],
//   dbproj [D].
// With dacc = g @ wprojᵀ, dp = dacc·vᵀ and delta_i = Σ_j dp_ij p_ij:
//   ds_ij = p_ij (dp_ij - delta_i);  dbias += ds;  dscale += ds·cos
//   dqn_i = scale Σ_j ds_ij kn_j;  dkn_j = scale Σ_i ds_ij qn_i
//   dv_j  = Σ_i p_ij dacc_i;  dq = (dqn - qn (dqn·qn)) / |q|, the same for k
//   dx = dqkv @ wqkvᵀ;  dwqkv += xᵀ dqkv;  dwproj += oᵀ g
//
// Five bodies, chosen by the I/O type and the geometry alone, as the
// forward's (window_attention_fwd.cu; attn_mma::body):
// * bfloat16 at the full-width NGswin's windows (N = 64, D = 64, heads 6 x 10
//   or 4 x 16): the tensor-core body below, rounding as
//   _attn_bwd_kernel_batched does with cot_bf16 on (the JAX default for
//   bf16 inputs, :474-477): the recompute's products take bf16 operands
//   (:629-642), and so does every cotangent product: g, wp_h, dacc, v, P,
//   dcos, k_n, q_n, the attention output, dqkv, x and wqkv (:645-697).  ds,
//   delta (from the bf16-operand dp, :658), the softmax statistics, the
//   L2-norm backward and the sums into dbias, dscale, dbqkv and dbproj stay
//   float32.
// * the full-width NGswin's other geometries (its windows at float32, its
//   n-gram windows at both dtypes): the body templated on the geometry,
//   which at bfloat16 rounds where _attn_bwd_kernel rounds (below); at
//   bfloat16 it measured faster there than the short-window body.
// * bfloat16 windows of 1 to 31 tokens at every other geometry with a plan:
//   the short-window body below (window_attention_bwd_smma and its
//   reduce), rounding where _attn_bwd_kernel rounds: the qkv recompute
//   takes bf16 operands (:728); everything else is float32 (:767,
//   :802-807), its float32 operands split into three bf16 parts where the
//   products run on mma.sync.
// * bfloat16 windows of 32 to 64 tokens at every other geometry with a plan:
//   the tensor-core generic body (window_attention_bwd_gmma and its token
//   sums, below), rounding as the tensor-core body.
// * every other case (float32, and bfloat16 widths without a plan): the
//   CUDA-core generic body, which takes N (<= 64), D, the heads and head_dim
//   (<= 32) at run time.  At bfloat16 and N >= 32 it would round where the
//   tensor-core body does; below, where _attn_bwd_kernel rounds: the two
//   matrices (:728, :767, :802-807); everything else is float32 there.
//
// What bounds it on an H100: operations, about three times the forward's
// (bytes at the demo width: 0.00199 ms for its 512 windows of 64 tokens).
// CUDA-core generic body: the forward's tiling (a persistent block, whole windows to
// a 64-row tile), heads in groups that fit shared memory, weights read from
// device memory.  Nothing of size [N, N] goes to device memory.
// Tensor-core body, three launches:
//  1. per window (window_attention_bwd_mma): one warpgroup takes a window,
//     each warp 16 token rows as queries and then as keys.  Per head: q, k, v
//     and dacc = g·wp_hᵀ for its rows (mma.sync), p from the forward's lse;
//     O = P·v, dp = dacc·vᵀ, ds, dq_n = dcos·k_n for its query rows; then,
//     with q_n, dacc, P and dcos of all rows in shared memory, dk_n = dcosᵀ·q_n
//     and dv = Pᵀ·dacc for its key rows (the transposed operands by
//     ldmatrix.trans); the L2-norm backward; dx += dqkv·wqkv_hᵀ.  dqkv and
//     the attention output leave as bf16 tiles, rounded as the JAX kernel
//     rounds them for its token sums;
//  2. the token sums (attention_param_sums): dwqkv = xᵀ·dqkv and
//     dwproj = accᵀ·g on mma.sync, and dbproj = Σ g in float32, each block
//     over its own contiguous range of tokens;
//  3. a reduce that adds the per-block partial sums of both in block order.
// The TPU grid is sequential and accumulates the parameter cotangents in
// place; CUDA blocks run in no order, so every sum is a per-block (or, for
// dbias, dbqkv and dscale in the tensor-core body, per-warpgroup) partial
// written to its own slot and added by a second pass in slot order.  No
// float atomics: two runs give the same bits.

#include "window_attention_generic_mma.cuh"
#include "window_attention_geometries.cuh"
#include "window_attention_mma.cuh"

namespace {

using namespace tmar;

// ---- the templated body: the full-width NGswin's geometries -----------------
template <int N, int D, int NH, int HD>
struct Geo {
  static constexpr int A = NH * HD;
  static constexpr int A3 = 3 * A;
  static constexpr int WPB = ROWS / N;  // windows per tile
  static constexpr int TR = WPB * N;    // a tile's rows that hold whole windows
  // several windows to a tile: dbias is summed over them in shared memory
  // first (one window: each thread owns its (h, i, j) and adds in place)
  static constexpr bool MULTI = WPB > 1;
  static constexpr int LX = D + 1;
  static constexpr int LQ = A3 + 1;
  static constexpr int LA = (D > A ? D : A) + 1;
  static constexpr int LWQ = A3 + 1;    // wqkv  [D][LWQ]
  static constexpr int LWP = D + 1;     // wproj [A][LWP]
  static constexpr int NB = NH * N * N;  // dbias elements
  // shared memory, in floats
  static constexpr int X = 0;
  static constexpr int QKV = X + ROWS * LX;       // qn, kn, v
  static constexpr int DQKV = QKV + ROWS * LQ;    // dqn, dkn, dv, then dq, dk, dv
  static constexpr int BA = DQKV + ROWS * LQ;     // g, then o
  static constexpr int BB = BA + ROWS * LA;       // dacc, then g
  static constexpr int WQKV = BB + ROWS * LA;
  static constexpr int WPROJ = WQKV + D * LWQ;
  static constexpr int BQKV = WPROJ + A * LWP;
  static constexpr int SCALE = BQKV + A3;
  static constexpr int INV = SCALE + 8;           // [ROWS][2NH] 1 / |q|, 1 / |k|
  static constexpr int LSE = INV + ROWS * 2 * NH;  // [NH][ROWS]
  static constexpr int DELTA = LSE + NH * ROWS;
  static constexpr int RED = DELTA + NH * ROWS;   // per-row shares of dscale
  static constexpr int DBQKV = RED + NH * ROWS;   // the block's running sums
  static constexpr int DBPROJ = DBQKV + A3;
  static constexpr int DSCALE = DBPROJ + D;
  static constexpr int DBIAS = DSCALE + 8;        // MULTI only: [NH][N][N]
  static constexpr int DS = DBIAS + (MULTI ? NB : 0);  // MULTI only: [NH][WPB][N][N]
  static constexpr int FLOATS = DS + (MULTI ? NB * WPB : 0);
  static constexpr size_t BYTES = FLOATS * sizeof(float);
  static_assert(BYTES <= MAX_SMEM, "tile does not fit in shared memory");
  // one block's slot of partial sums, and the layout of the reduced result
  static constexpr int P_DWQKV = 0;
  static constexpr int P_DBQKV = P_DWQKV + D * A3;
  static constexpr int P_DSCALE = P_DBQKV + A3;
  static constexpr int P_DBIAS = P_DSCALE + NH;
  static constexpr int P_DWPROJ = P_DBIAS + NB;
  static constexpr int P_DBPROJ = P_DWPROJ + A * D;
  static constexpr int PSIZE = P_DBPROJ + D;
};

template <int N, int D, int NH, int HD, typename T>
__global__ void __launch_bounds__(THREADS, 1) window_attention_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ wqkv,
    int wq_k, int wq_n, const float* __restrict__ bqkv, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ wproj, int wp_k, int wp_n,
    const float* __restrict__ mrow, const float* __restrict__ mcol,
    const float* __restrict__ lse, T* __restrict__ dx, float* __restrict__ part,
    int nwin, int wh, int ww) {
  using G = Geo<N, D, NH, HD>;
  constexpr int A = G::A, A3 = G::A3, LX = G::LX, LQ = G::LQ, LA = G::LA;
  constexpr int WPB = G::WPB, TR = G::TR;
  extern __shared__ float smem[];
  float* sX = smem + G::X;
  float* sQKV = smem + G::QKV;
  float* sDQKV = smem + G::DQKV;
  float* sA = smem + G::BA;
  float* sB = smem + G::BB;
  float* s_wqkv = smem + G::WQKV;
  float* s_wproj = smem + G::WPROJ;
  float* s_bqkv = smem + G::BQKV;
  float* s_scale = smem + G::SCALE;
  float* sInv = smem + G::INV;
  float* sLse = smem + G::LSE;
  float* sDelta = smem + G::DELTA;
  float* sRed = smem + G::RED;
  float* s_dbqkv = smem + G::DBQKV;
  float* s_dbproj = smem + G::DBPROJ;
  float* s_dscale = smem + G::DSCALE;
  float* s_dbias = smem + G::DBIAS;
  float* sDS = smem + G::DS;

  const int tid = threadIdx.x;
  float* my = part + (size_t)blockIdx.x * G::PSIZE;

  // the matrices in the I/O type's values (bf16: as the JAX kernel packs them)
  for (int e = tid; e < D * A3; e += THREADS) {
    const int k = e / A3, n = e % A3;
    s_wqkv[k * G::LWQ + n] = round_as<T>(wqkv[(size_t)k * wq_k + (size_t)n * wq_n]);
  }
  for (int e = tid; e < A * D; e += THREADS) {
    const int k = e / D, n = e % D;
    s_wproj[k * G::LWP + n] = round_as<T>(wproj[(size_t)k * wp_k + (size_t)n * wp_n]);
  }
  for (int e = tid; e < A3; e += THREADS) {
    s_bqkv[e] = bqkv[e];
    s_dbqkv[e] = 0.f;
  }
  for (int e = tid; e < D; e += THREADS) s_dbproj[e] = 0.f;
  if (tid < 8) s_dscale[tid] = 0.f;
  if (tid < NH) s_scale[tid] = scale[tid];
  if constexpr (G::MULTI) {
    for (int e = tid; e < G::NB; e += THREADS) s_dbias[e] = 0.f;
  } else {
    for (int e = tid; e < G::NB; e += THREADS) my[G::P_DBIAS + e] = 0.f;
  }
  // the block's sums of dwqkv [D][A3] and dwproj [A][D], over all its tiles
  float accW[ceil16(D)][ceil16(A3)];
  float accP[ceil16(A)][ceil16(D)];
  mm_zero<D, A3>(accW);
  mm_zero<A, D>(accP);
  __syncthreads();

  const long total = (long)nwin * N;  // token rows
  const int tiles = (int)((total + TR - 1) / TR);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * TR;

    // 1. x and g of the tile, zero past the end and past its last whole
    // window (as in the forward); the forward's lse
    for (int e = tid; e < ROWS * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const bool ok = r < TR && row0 + r < total;
      sX[r * LX + d] = ok ? to_f(x[(row0 + r) * D + d]) : 0.f;
      sA[r * LA + d] = ok ? to_f(g[(row0 + r) * D + d]) : 0.f;
    }
    for (int e = tid; e < NH * ROWS; e += THREADS) {
      const int h = e / ROWS, r = e % ROWS;
      const int win = tile * WPB + r / N;
      sLse[e] = r < TR && win < nwin ? lse[((size_t)win * NH + h) * N + r % N] : 0.f;
    }
    __syncthreads();

    // 2. qkv = x @ wqkv + bqkv;  dacc = g @ wprojᵀ
    {
      float acc[ceil16(ROWS)][ceil16(A3)];
      mm_zero<ROWS, A3>(acc);
      mm_acc<ROWS, D, A3>(acc, sX, LX, 1, s_wqkv, G::LWQ, 1);
      mm_each<ROWS, A3>(acc, [&](int m, int n, float v) { sQKV[m * LQ + n] = v + s_bqkv[n]; });
    }
    {
      float acc[ceil16(ROWS)][ceil16(A)];
      mm_zero<ROWS, A>(acc);
      mm_acc<ROWS, D, A>(acc, sA, LA, 1, s_wproj, 1, G::LWP);
      mm_each<ROWS, A>(acc, [&](int m, int n, float v) { sB[m * LA + n] = v; });
    }
    __syncthreads();

    // 3. per-head L2 normalisation of q and k, keeping 1 / norm
    for (int e = tid; e < ROWS * 2 * NH; e += THREADS) {
      float* t = sQKV + (e / (2 * NH)) * LQ + (e % (2 * NH)) * HD;
      float ss = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) ss = fmaf(t[d], t[d], ss);
      const float inv = 1.f / (sqrtf(ss) + 1e-12f);
#pragma unroll
      for (int d = 0; d < HD; ++d) t[d] *= inv;
      sInv[e] = inv;
    }
    __syncthreads();

    // 4. a thread owns a (head, query) row: o, delta, dqn, its share of dscale
    for (int e = tid; e < NH * ROWS; e += THREADS) {
      const int h = e / ROWS, r = e % ROWS;
      const int w = r / N, i = r % N;
      const int win = tile * WPB + w;
      float o[HD], dq[HD];
      float delta = 0.f, dsc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) o[d] = dq[d] = 0.f;
      if (r < TR && win < nwin) {
        const bool gr = wh > 0 && (win / ww) % wh == wh - 1;
        const bool gc = wh > 0 && win % ww == ww - 1;
        float q[HD], da[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          q[d] = sQKV[r * LQ + h * HD + d];
          da[d] = sB[r * LA + h * HD + d];
        }
        const float sc = s_scale[h];
        const float l = sLse[e];
        const float* kb = sQKV + (w * N) * LQ + A + h * HD;
        const float* bi = bias + ((size_t)h * N + i) * N;
        const float* mr = mrow + (size_t)i * N;
        const float* mc = mcol + (size_t)i * N;
        for (int j = 0; j < N; ++j) {
          const float* kj = kb + j * LQ;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) dot = fmaf(q[d], kj[d], dot);
          float s = dot * sc + bi[j];
          if (gr) s += mr[j];
          if (gc) s += mc[j];
          const float p = expf(s - l);
          const float* vj = kj + A;
#pragma unroll
          for (int d = 0; d < HD; ++d) o[d] = fmaf(p, vj[d], o[d]);
        }
#pragma unroll
        for (int d = 0; d < HD; ++d) delta = fmaf(da[d], o[d], delta);
        for (int j = 0; j < N; ++j) {
          const float* kj = kb + j * LQ;
          const float* vj = kj + A;
          float dot = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) {
            dot = fmaf(q[d], kj[d], dot);
            dp = fmaf(da[d], vj[d], dp);
          }
          float s = dot * sc + bi[j];
          if (gr) s += mr[j];
          if (gc) s += mc[j];
          const float ds = expf(s - l) * (dp - delta);
          dsc = fmaf(ds, dot, dsc);
          const float dc = ds * sc;
#pragma unroll
          for (int d = 0; d < HD; ++d) dq[d] = fmaf(dc, kj[d], dq[d]);
        }
      }
      sDelta[e] = delta;
      sRed[e] = dsc;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        sA[r * LA + h * HD + d] = o[d];
        sDQKV[r * LQ + h * HD + d] = dq[d];
      }
    }
    __syncthreads();

    // 5. a thread owns a (head, key) row: dkn, dv, dbias
    for (int e = tid; e < NH * ROWS; e += THREADS) {
      const int h = e / ROWS, r = e % ROWS;
      const int w = r / N, j = r % N;
      const int win = tile * WPB + w;
      float dk[HD], dv[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) dk[d] = dv[d] = 0.f;
      if (r < TR && win < nwin) {
        const bool gr = wh > 0 && (win / ww) % wh == wh - 1;
        const bool gc = wh > 0 && win % ww == ww - 1;
        float k[HD], v[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          k[d] = sQKV[r * LQ + A + h * HD + d];
          v[d] = sQKV[r * LQ + 2 * A + h * HD + d];
        }
        const float sc = s_scale[h];
        for (int i = 0; i < N; ++i) {
          const int ri = w * N + i;
          const float* qi = sQKV + ri * LQ + h * HD;
          const float* di = sB + ri * LA + h * HD;
          float dot = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) {
            dot = fmaf(qi[d], k[d], dot);
            dp = fmaf(di[d], v[d], dp);
          }
          const size_t ij = ((size_t)h * N + i) * N + j;
          float s = dot * sc + bias[ij];
          if (gr) s += mrow[i * N + j];
          if (gc) s += mcol[i * N + j];
          const float p = expf(s - sLse[h * ROWS + ri]);
          const float ds = p * (dp - sDelta[h * ROWS + ri]);
          const float dc = ds * sc;
#pragma unroll
          for (int d = 0; d < HD; ++d) {
            dv[d] = fmaf(p, di[d], dv[d]);
            dk[d] = fmaf(dc, qi[d], dk[d]);
          }
          if constexpr (G::MULTI) {
            sDS[((h * WPB + w) * N + i) * N + j] = ds;
          } else {
            my[G::P_DBIAS + ij] += ds;  // this thread alone owns (block, h, i, j)
          }
        }
      } else if constexpr (G::MULTI) {
        if (r < TR)
          for (int i = 0; i < N; ++i) sDS[((h * WPB + w) * N + i) * N + j] = 0.f;
      }
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        sDQKV[r * LQ + A + h * HD + d] = dk[d];
        sDQKV[r * LQ + 2 * A + h * HD + d] = dv[d];
      }
    }
    __syncthreads();

    // 6. the small sums; the L2-norm backward in place; g again (dacc is done)
    if (tid < NH) {
      float s = 0.f;
      for (int r = 0; r < ROWS; ++r) s += sRed[tid * ROWS + r];
      s_dscale[tid] += s;
    }
    if constexpr (G::MULTI) {
      for (int e = tid; e < G::NB; e += THREADS) {
        const int h = e / (N * N), ij = e % (N * N);
        float s = 0.f;
        for (int w = 0; w < WPB; ++w) s += sDS[(h * WPB + w) * (N * N) + ij];
        s_dbias[e] += s;
      }
    }
    for (int e = tid; e < ROWS * 2 * NH; e += THREADS) {
      const int off = (e / (2 * NH)) * LQ + (e % (2 * NH)) * HD;
      const float* t = sQKV + off;
      float* dt = sDQKV + off;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(dt[d], t[d], dot);
      const float inv = sInv[e];
#pragma unroll
      for (int d = 0; d < HD; ++d) dt[d] = inv * (dt[d] - t[d] * dot);
    }
    for (int e = tid; e < ROWS * D; e += THREADS) {
      const int r = e / D, d = e % D;
      sB[r * LA + d] = r < TR && row0 + r < total ? to_f(g[(row0 + r) * D + d]) : 0.f;
    }
    __syncthreads();

    // 7. dwproj += oᵀ g;  dwqkv += xᵀ dqkv;  the bias sums;  dx = dqkv @ wqkvᵀ
    mm_acc<A, ROWS, D>(accP, sA, 1, LA, sB, LA, 1);
    mm_acc<D, ROWS, A3>(accW, sX, 1, LX, sDQKV, LQ, 1);
    for (int e = tid; e < D; e += THREADS) {
      float s = 0.f;
      for (int r = 0; r < ROWS; ++r) s += sB[r * LA + e];
      s_dbproj[e] += s;
    }
    for (int e = tid; e < A3; e += THREADS) {
      float s = 0.f;
      for (int r = 0; r < ROWS; ++r) s += sDQKV[r * LQ + e];
      s_dbqkv[e] += s;
    }
    {
      float acc[ceil16(ROWS)][ceil16(D)];
      mm_zero<ROWS, D>(acc);
      mm_acc<ROWS, A3, D>(acc, sDQKV, LQ, 1, s_wqkv, 1, G::LWQ);
      mm_each<ROWS, D>(acc, [&](int m, int n, float v) {
        if (m < TR && row0 + m < total) store(dx + (row0 + m) * D + n, v);
      });
    }
    __syncthreads();
  }

  // the block's slot of partial sums
  mm_each<D, A3>(accW, [&](int m, int n, float v) { my[G::P_DWQKV + m * A3 + n] = v; });
  mm_each<A, D>(accP, [&](int m, int n, float v) { my[G::P_DWPROJ + m * D + n] = v; });
  for (int e = tid; e < A3; e += THREADS) my[G::P_DBQKV + e] = s_dbqkv[e];
  for (int e = tid; e < D; e += THREADS) my[G::P_DBPROJ + e] = s_dbproj[e];
  if (tid < NH) my[G::P_DSCALE + tid] = s_dscale[tid];
  if constexpr (G::MULTI) {
    for (int e = tid; e < G::NB; e += THREADS) my[G::P_DBIAS + e] = s_dbias[e];
  }
}


template <int N, int D, int NH, int HD, typename T>
int launch(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* dx,
           void* part, void* dparams, int nwin, int wh, int ww, int blocks,
           cudaStream_t stream) {
  using G = Geo<N, D, NH, HD>;
  auto kern = window_attention_bwd_kernel<N, D, NH, HD, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::BYTES);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, THREADS, G::BYTES, stream>>>(
      (const T*)p[0], (const T*)p[1], (const float*)p[2], wq_k, wq_n, (const float*)p[3],
      (const float*)p[4], (const float*)p[5], (const float*)p[6], wp_k, wp_n,
      (const float*)p[7], (const float*)p[8], (const float*)p[9], (T*)dx, (float*)part,
      nwin, wh, ww);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_partials<<<(G::PSIZE + 255) / 256, 256, 0, stream>>>(
      (const float*)part, (float*)dparams, blocks, G::PSIZE);
  return (int)cudaGetLastError();
}

// ---- the generic body: any (N <= 64, D, heads, head_dim <= HDM) -------------
// The forward's tiling (window_attention_fwd.cu): a persistent block walks
// over tiles of whole windows; x, g and dx of a tile stay in shared memory,
// and heads are taken hg at a time (rt_bytes; tmar_torch/ops/envelope.py:
// attention_bwd_bytes counts the same, all heads where they fit): per group q/k/v and their
// cotangents, rk(dacc), the head outputs, and per (head, row) the two
// reciprocal norms, lse, delta and the dscale share, in float32.  The weights
// are read from device memory, rounded to T's values as they are read.  Per
// group the attention takes two passes so that no thread adds into another's
// data: a thread owns a (head, query) row and produces o, delta = Σ_j dp·p
// (dp from rk's operands), dq_n and its share of dscale; then a (head, key)
// row and produces dk_n, dv and dbias.  Then the L2-norm backward, the
// group's columns of dwqkv and rows of dwproj, and its share of dx.  With rk
// (bfloat16 at N >= 32) it rounds as window_attention_backward_math does at
// N = 64 (every cotangent product's operands); at N < 32 only the two
// matrices; at float32 nothing.  Every sum goes into the block's own slot of
// `part` (zeroed first) by one owner thread, and a reduce adds the slots in
// block order: no atomics, two runs give the same bits.
template <int HDM, typename T>
__global__ void __launch_bounds__(THREADS) window_attention_bwd_rt(
    const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ wqkv,
    int wq_k, int wq_n, const float* __restrict__ bqkv, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ wproj, int wp_k, int wp_n,
    const float* __restrict__ mrow, const float* __restrict__ mcol,
    const float* __restrict__ lse, T* __restrict__ dx, float* __restrict__ part, int nwin,
    int N, int D, int nh, int hd, int hg, int wh, int ww, int rk) {
  extern __shared__ float smem[];
  const int A = nh * hd, A3 = 3 * A, LX = D + 1, GM = hg * hd;
  const int LQ = 3 * GM + 1, LA = GM + 1;
  const int WPB = ROWS / N, TR = WPB * N;
  float* sX = smem;                 // x
  float* sG = sX + ROWS * LX;       // g
  float* sDX = sG + ROWS * LX;      // dx
  float* sQ = sDX + ROWS * LX;      // the group's q_n | k_n | v (q_n, k_n unrounded)
  float* sD = sQ + ROWS * LQ;       // dq_n | dk_n | dv, then dq | dk | dv
  float* sDA = sD + ROWS * LQ;      // rk(dacc)
  float* sO = sDA + ROWS * LA;      // the head outputs
  float* sInv = sO + ROWS * LA;     // [ROWS][2hg] 1 / (|q| + eps), 1 / (|k| + eps)
  float* sLse = sInv + ROWS * 2 * hg;  // [hg][ROWS]
  float* sDelta = sLse + ROWS * hg;
  float* sDsc = sDelta + ROWS * hg;
  float* sDS = sDsc + ROWS * hg;    // several windows to a tile: [hg][WPB][N][N]
  const int tid = threadIdx.x;
  // one block's slot of partial sums, and the layout of the reduced result
  const int pDBQKV = D * A3, pDSCALE = pDBQKV + A3, pDBIAS = pDSCALE + nh;
  const int pDWPROJ = pDBIAS + nh * N * N, pDBPROJ = pDWPROJ + A * D, psize = pDBPROJ + D;
  float* my = part + (size_t)blockIdx.x * psize;
  for (int e = tid; e < psize; e += THREADS) my[e] = 0.f;
  __syncthreads();
  auto rkv = [&](float v) { return rk ? round_as<T>(v) : v; };
  const long total = (long)nwin * N;
  const long tiles = (total + TR - 1) / TR;

  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = tile * TR;
    const int rows = (int)(total - row0 < TR ? total - row0 : TR);  // whole windows
    const int nw = rows / N;

    // 1. x, g (T's values), dx = 0;  dbproj += Σ g
    for (int e = tid; e < rows * D; e += THREADS) {
      const int r = e / D, c = e % D;
      sX[r * LX + c] = to_f(x[row0 * D + e]);
      sG[r * LX + c] = to_f(g[row0 * D + e]);
      sDX[r * LX + c] = 0.f;
    }
    __syncthreads();
    for (int c = tid; c < D; c += THREADS) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += sG[r * LX + c];
      my[pDBPROJ + c] += s;
    }

    for (int h0 = 0; h0 < nh; h0 += hg) {
      const int hc = nh - h0 < hg ? nh - h0 : hg, G = hc * hd;
      auto col = [&](int n) { return (n / G) * A + h0 * hd + n % G; };

      // 2. q, k, v = x @ T(wqkv) + bqkv;  rk(dacc) = rk(g @ T(wproj)ᵀ);  lse
      mm_rt(rows, 3 * G, D, [&](int m, int k) { return sX[m * LX + k]; },
            [&](int k, int n) {
              return round_as<T>(__ldg(wqkv + (size_t)k * wq_k + (size_t)col(n) * wq_n));
            },
            [&](int m, int n, float v) { sQ[m * LQ + n] = v + __ldg(bqkv + col(n)); });
      mm_rt(rows, G, D, [&](int m, int k) { return sG[m * LX + k]; },
            [&](int k, int n) {
              return round_as<T>(
                  __ldg(wproj + (size_t)(h0 * hd + n) * wp_k + (size_t)k * wp_n));
            },
            [&](int m, int n, float v) { sDA[m * LA + n] = rkv(v); });
      for (int e = tid; e < hc * rows; e += THREADS) {
        const int hl = e / rows, r = e % rows;
        sLse[hl * ROWS + r] = lse[((row0 + r) / N * nh + h0 + hl) * N + (row0 + r) % N];
      }
      __syncthreads();

      // 3. q_n, k_n in place (unrounded), keeping 1 / (|t| + eps)
      for (int e = tid; e < rows * 2 * hc; e += THREADS) {
        const int r = e / (2 * hc), j = e % (2 * hc);
        float* t = sQ + r * LQ + (j / hc) * G + (j % hc) * hd;
        float ss = 0.f;
        for (int d = 0; d < hd; ++d) ss = fmaf(t[d], t[d], ss);
        const float inv = 1.f / (sqrtf(ss) + 1e-12f);
        for (int d = 0; d < hd; ++d) t[d] *= inv;
        sInv[r * 2 * hg + j] = inv;
      }
      __syncthreads();

      // 4. a thread owns a (head, query) row i: o, delta, dq_n, its dscale share
      for (int e = tid; e < hc * rows; e += THREADS) {
        const int hl = e / rows, r = e % rows, h = h0 + hl;
        const int w = r / N, i = r % N;
        bool gr, gc;
        mask_gates((int)((row0 + r) / N), wh, ww, gr, gc);
        float q[HDM], da[HDM], o[HDM], dq[HDM];
#pragma unroll
        for (int d = 0; d < HDM; ++d) {
          q[d] = d < hd ? rkv(sQ[r * LQ + hl * hd + d]) : 0.f;
          da[d] = d < hd ? sDA[r * LA + hl * hd + d] : 0.f;
          o[d] = dq[d] = 0.f;
        }
        const float sc = scale[h], l = sLse[hl * ROWS + r];
        const float* kb = sQ + (w * N) * LQ + G + hl * hd;
        const float* bi = bias + ((size_t)h * N + i) * N;
        // (cos, p, dp) of key j
        auto key = [&](int j, float& cs, float& p, float& dp) {
          const float* kj = kb + j * LQ;
          const float* vj = kj + G;
          cs = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < HDM; ++d)
            if (d < hd) {
              cs = fmaf(q[d], rkv(kj[d]), cs);
              dp = fmaf(da[d], rkv(vj[d]), dp);
            }
          float s = cs * sc + bi[j];
          if (gr) s += mrow[i * N + j];
          if (gc) s += mcol[i * N + j];
          p = expf(s - l);
        };
        float delta = 0.f, dsc = 0.f;
        for (int j = 0; j < N; ++j) {
          float cs, p, dp;
          key(j, cs, p, dp);
          const float pr = rkv(p);
          const float* vj = kb + j * LQ + G;
#pragma unroll
          for (int d = 0; d < HDM; ++d)
            if (d < hd) o[d] = fmaf(pr, rkv(vj[d]), o[d]);
          delta = fmaf(dp, p, delta);
        }
        for (int j = 0; j < N; ++j) {
          float cs, p, dp;
          key(j, cs, p, dp);
          const float ds = p * (dp - delta);
          dsc = fmaf(ds, cs, dsc);
          const float dc = rkv(ds * sc);
          const float* kj = kb + j * LQ;
#pragma unroll
          for (int d = 0; d < HDM; ++d)
            if (d < hd) dq[d] = fmaf(dc, rkv(kj[d]), dq[d]);
        }
        sDelta[hl * ROWS + r] = delta;
        sDsc[hl * ROWS + r] = dsc;
#pragma unroll
        for (int d = 0; d < HDM; ++d)
          if (d < hd) {
            sO[r * LA + hl * hd + d] = o[d];
            sD[r * LQ + hl * hd + d] = dq[d];
          }
      }
      __syncthreads();

      // 5. a thread owns a (head, key) row j: dk_n, dv, dbias
      for (int e = tid; e < hc * rows; e += THREADS) {
        const int hl = e / rows, r = e % rows, h = h0 + hl;
        const int w = r / N, j = r % N;
        bool gr, gc;
        mask_gates((int)((row0 + r) / N), wh, ww, gr, gc);
        float k[HDM], v[HDM], dk[HDM], dv[HDM];
#pragma unroll
        for (int d = 0; d < HDM; ++d) {
          k[d] = d < hd ? rkv(sQ[r * LQ + G + hl * hd + d]) : 0.f;
          v[d] = d < hd ? rkv(sQ[r * LQ + 2 * G + hl * hd + d]) : 0.f;
          dk[d] = dv[d] = 0.f;
        }
        const float sc = scale[h];
        for (int i = 0; i < N; ++i) {
          const int ri = w * N + i;
          const float* qi = sQ + ri * LQ + hl * hd;
          const float* di = sDA + ri * LA + hl * hd;
          float cs = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < HDM; ++d)
            if (d < hd) {
              cs = fmaf(rkv(qi[d]), k[d], cs);
              dp = fmaf(di[d], v[d], dp);
            }
          float s = cs * sc + bias[((size_t)h * N + i) * N + j];
          if (gr) s += mrow[i * N + j];
          if (gc) s += mcol[i * N + j];
          const float p = expf(s - sLse[hl * ROWS + ri]);
          const float ds = p * (dp - sDelta[hl * ROWS + ri]);
          const float pr = rkv(p), dc = rkv(ds * sc);
#pragma unroll
          for (int d = 0; d < HDM; ++d)
            if (d < hd) {
              dv[d] = fmaf(pr, di[d], dv[d]);
              dk[d] = fmaf(dc, rkv(qi[d]), dk[d]);
            }
          if (WPB > 1)
            sDS[((hl * WPB + w) * N + i) * N + j] = ds;
          else
            my[pDBIAS + (h * N + i) * N + j] += ds;  // this thread alone owns (h, i, j)
        }
#pragma unroll
        for (int d = 0; d < HDM; ++d)
          if (d < hd) {
            sD[r * LQ + G + hl * hd + d] = dk[d];
            sD[r * LQ + 2 * G + hl * hd + d] = dv[d];
          }
      }
      __syncthreads();

      // 6. dscale, dbias (several windows: summed here in window order);
      //    the L2-norm backward in place: dt = inv (dt_n - t_n (dt_n · t_n))
      for (int hl = tid; hl < hc; hl += THREADS) {
        float s = 0.f;
        for (int r = 0; r < rows; ++r) s += sDsc[hl * ROWS + r];
        my[pDSCALE + h0 + hl] += s;
      }
      if (WPB > 1)
        for (int e = tid; e < hc * N * N; e += THREADS) {
          const int hl = e / (N * N), ij = e % (N * N);
          float s = 0.f;
          for (int w = 0; w < nw; ++w) s += sDS[(hl * WPB + w) * N * N + ij];
          my[pDBIAS + (h0 + hl) * N * N + ij] += s;
        }
      for (int e = tid; e < rows * 2 * hc; e += THREADS) {
        const int r = e / (2 * hc), j = e % (2 * hc);
        const int off = r * LQ + (j / hc) * G + (j % hc) * hd;
        const float* t = sQ + off;
        float* dt = sD + off;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(dt[d], t[d], dot);
        const float inv = sInv[r * 2 * hg + j];
        for (int d = 0; d < hd; ++d) dt[d] = inv * (dt[d] - t[d] * dot);
      }
      __syncthreads();

      // 7. the group's rows of dwproj += rk(o)ᵀ rk(g), columns of
      //    dwqkv += rk(x)ᵀ rk(dqkv) and of dbqkv += Σ dqkv;
      //    dx += rk(dqkv) @ rk(T(wqkv))ᵀ
      mm_rt(G, D, rows, [&](int m, int k) { return rkv(sO[k * LA + m]); },
            [&](int k, int n) { return rkv(sG[k * LX + n]); },
            [&](int m, int n, float v) { my[pDWPROJ + (h0 * hd + m) * D + n] += v; });
      mm_rt(D, 3 * G, rows, [&](int m, int k) { return rkv(sX[k * LX + m]); },
            [&](int k, int n) { return rkv(sD[k * LQ + n]); },
            [&](int m, int n, float v) { my[m * A3 + col(n)] += v; });
      for (int n = tid; n < 3 * G; n += THREADS) {
        float s = 0.f;
        for (int r = 0; r < rows; ++r) s += sD[r * LQ + n];
        my[pDBQKV + col(n)] += s;
      }
      mm_rt(rows, D, 3 * G, [&](int m, int k) { return rkv(sD[m * LQ + k]); },
            [&](int k, int n) {
              return rkv(round_as<T>(__ldg(wqkv + (size_t)n * wq_k + (size_t)col(k) * wq_n)));
            },
            [&](int m, int n, float v) { sDX[m * LX + n] += v; });
      __syncthreads();
    }

    // 8. dx
    for (int e = tid; e < rows * D; e += THREADS) store(dx + row0 * D + e, sDX[(e / D) * LX + e % D]);
    __syncthreads();
  }
}

size_t rt_bytes(int N, int D, int hd, int hg) {
  const int G = hg * hd, wpb = ROWS / N;
  return 4 * ((size_t)3 * ROWS * (D + 1) + (size_t)ROWS * (2 * (3 * G + 1) + 2 * (G + 1)) +
              (size_t)ROWS * 5 * hg + (wpb > 1 ? (size_t)hg * wpb * N * N : 0));
}

template <int HDM, typename T>
int launch_rt(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* dx, void* part,
              void* dparams, int nwin, int N, int D, int nh, int hd, int hg, int wh, int ww,
              int blocks, cudaStream_t stream) {
  const size_t bytes = rt_bytes(N, D, hd, hg);
  auto kern = window_attention_bwd_rt<HDM, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, THREADS, bytes, stream>>>(
      (const T*)p[0], (const T*)p[1], (const float*)p[2], wq_k, wq_n, (const float*)p[3],
      (const float*)p[4], (const float*)p[5], (const float*)p[6], wp_k, wp_n,
      (const float*)p[7], (const float*)p[8], (const float*)p[9], (T*)dx, (float*)part, nwin,
      N, D, nh, hd, hg, wh, ww, sizeof(T) == 2 && N >= 32);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int A = nh * hd, size = D * 3 * A + 3 * A + nh + nh * N * N + A * D + D;
  reduce_partials<<<(size + 255) / 256, 256, 0, stream>>>((const float*)part, (float*)dparams,
                                                          blocks, size);
  return (int)cudaGetLastError();
}

// the generic body's floats of workspace: one slot of partial sums a block
long long generic_workspace(int N, int D, int nh, int hd, int blocks) {
  const long long A = (long long)nh * hd;
  return (long long)blocks * (D * 3 * A + 3 * A + nh + (long long)nh * N * N + A * D + D);
}

// ---- the bfloat16 tensor-core body, N = 64 ---------------------------------

__host__ __device__ constexpr size_t round4(size_t n) { return (n + 3) / 4 * 4; }

template <int NH, int HD>
struct BwdMma {
  static constexpr int WG = 2;  // windows in flight per block
  static constexpr int WARPS = 4 * WG;
  static constexpr int A = NH * HD;
  static constexpr int AP = NH * HP;
  static constexpr int QKV = 3 * AP;
  // float32: bqkv [QKV], scale [8], per-warp sums of dbqkv [WARPS][QKV] and
  // of dscale [WARPS][8]
  static constexpr int BQKV = 0;
  static constexpr int SCALE = BQKV + QKV;
  static constexpr int DBQ = SCALE + 8;
  static constexpr int DSC = DBQ + WARPS * QKV;
  static constexpr int FLOATS = DSC + WARPS * 8;
  // bf16: wqkv [QKV][LDX], wproj [AP][LDX]; per warpgroup two slots, each x
  // then g [64][LDX]; q_n and dacc [64][LDK] double-buffered by head; k_n
  // and v [64][LDK]; P and dcos [64][LDS]
  static constexpr int WQKV = 0;
  static constexpr int WPROJ = WQKV + QKV * LDX;
  static constexpr int WELEMS = WPROJ + AP * LDX;
  static constexpr int SLOT = 2 * WN * LDX;
  static constexpr int T16 = WN * LDK;
  static constexpr int QN = 2 * SLOT;
  static constexpr int DA = QN + 2 * T16;
  static constexpr int KN = DA + 2 * T16;
  static constexpr int VV = KN + T16;
  static constexpr int PP = VV + T16;
  static constexpr int DC = PP + WN * LDS;
  static constexpr int WGELEMS = DC + WN * LDS;
  static constexpr size_t BYTES =
      FLOATS * sizeof(float) + (size_t)(WELEMS + WG * WGELEMS) * sizeof(__nv_bfloat16);
  static_assert(FLOATS % 4 == 0 && WELEMS % 8 == 0 && WGELEMS % 8 == 0, "16-byte regions");
  static_assert(BYTES <= MAX_SMEM, "does not fit in shared memory");
  // one warpgroup's slot of partial sums: dbqkv [3A], dscale [NH],
  // dbias [NH][64][64] (the order of dparams)
  static constexpr int SIZE1 = 3 * A + NH + NH * WN * WN;
  // one token-sum block's: dwqkv [D][3A], dwproj [A][D], dbproj [D]
  static constexpr int SIZE2 = WD * 3 * A + A * WD + WD;
};

// The launches' shapes and the workspace's layout (in floats): the
// per-warpgroup partials, the token-sum partials, then dqkv [nwin·64][QKV]
// and the attention output [nwin·64][AP] as bf16.
template <int NH, int HD>
struct BwdPlan {
  using L = BwdMma<NH, HD>;
  int g1, n1, g2, rpb;
  size_t off2, off3, off4, total;
  BwdPlan(int nwin, int blocks) {
    g1 = (nwin + L::WG - 1) / L::WG < blocks ? (nwin + L::WG - 1) / L::WG : blocks;
    n1 = g1 * L::WG;
    // token sums: at least 8 windows a block, at most one block per SM
    int want = (nwin + 7) / 8 < blocks ? (nwin + 7) / 8 : blocks;
    want = want < 1 ? 1 : want;
    const int wpb = (nwin + want - 1) / want;
    g2 = (nwin + wpb - 1) / wpb;
    rpb = wpb * WN;
    off2 = round4((size_t)n1 * L::SIZE1);
    off3 = round4(off2 + (size_t)g2 * L::SIZE2);
    off4 = off3 + (size_t)nwin * WN * L::QKV / 2;
    total = off4 + (size_t)nwin * WN * L::AP / 2;
  }
};

// In place, the L2-norm backward of rows held as two tiles: d <- inv·(d −
// n·(d·n)) per row, n the normalised rows, inv[0] / inv[1] of rows g / g + 8.
__device__ __forceinline__ void norm_backward(float (&d)[2][4], const float (&n)[2][4],
                                              const float (&inv)[2]) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s0 += d[i][0] * n[i][0] + d[i][1] * n[i][1];
    s1 += d[i][2] * n[i][2] + d[i][3] * n[i][3];
  }
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    d[i][0] = inv[0] * (d[i][0] - n[i][0] * s0), d[i][1] = inv[0] * (d[i][1] - n[i][1] * s0);
    d[i][2] = inv[1] * (d[i][2] - n[i][2] * s1), d[i][3] = inv[1] * (d[i][3] - n[i][3] * s1);
  }
}

// Rows r0 and r0 + 8 of a 16-column block, as bf16, into row-major global
// memory of row stride ld, at column c0.
__device__ __forceinline__ void store_rows_global(__nv_bfloat16* m, size_t ld, const float (&lo)[4],
                                                  const float (&hi)[4], size_t r0, int c0, int t) {
  sts32(m + r0 * ld + c0 + 2 * t, pack_bf16(lo[0], lo[1]));
  sts32(m + (r0 + 8) * ld + c0 + 2 * t, pack_bf16(lo[2], lo[3]));
  sts32(m + r0 * ld + c0 + 8 + 2 * t, pack_bf16(hi[0], hi[1]));
  sts32(m + (r0 + 8) * ld + c0 + 8 + 2 * t, pack_bf16(hi[2], hi[3]));
}

template <int NH, int HD>
__global__ void __launch_bounds__(128 * BwdMma<NH, HD>::WG, 1) window_attention_bwd_mma(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ wqkv, int wq_k, int wq_n, const float* __restrict__ bqkv,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ wproj, int wp_k, int wp_n, const float* __restrict__ mrow,
    const float* __restrict__ mcol, const float* __restrict__ lse,
    __nv_bfloat16* __restrict__ dx, float* __restrict__ part,
    __nv_bfloat16* __restrict__ dqkv_out, __nv_bfloat16* __restrict__ acc_out, int nwin,
    int wh, int ww) {
  using L = BwdMma<NH, HD>;
  constexpr int WG = L::WG, THR = 128 * WG, AP = L::AP, QKV = L::QKV, A = L::A;
  extern __shared__ float4 smem4[];
  float* sf = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(sf + L::FLOATS);
  const int tid = threadIdx.x;
  const int wg = tid >> 7, wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const int gw = tid >> 5;  // warp within the block
  const int g8 = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g8, r1 = r0 + 8;

  // ---- once per block ------------------------------------------------------
  stage_attention_weights<NH, HD>(sw + L::WQKV, sw + L::WPROJ, sf + L::BQKV, wqkv, wq_k, wq_n,
                                  wproj, wp_k, wp_n, bqkv, tid, THR);
  if (tid < NH) sf[L::SCALE + tid] = scale[tid];
  for (int e = tid; e < L::WARPS * (QKV + 8); e += THR) sf[L::DBQ + e] = 0.f;
  float* my = part + (size_t)(blockIdx.x * WG + wg) * L::SIZE1;  // this warpgroup's slot
  float* my_dbias = my + 3 * A + NH;
  for (int e = wtid; e < NH * WN * WN; e += 128) my_dbias[e] = 0.f;
  __syncthreads();

  const __nv_bfloat16* s_wqkv = sw + L::WQKV;
  const __nv_bfloat16* s_wproj = sw + L::WPROJ;
  __nv_bfloat16* base = sw + L::WELEMS + wg * L::WGELEMS;
  const int stride = gridDim.x * WG;

  int win = blockIdx.x * WG + wg;
  if (win < nwin) {
    copy_tile(base, x + (size_t)win * WN * WD, wtid);
    copy_tile(base + WN * LDX, g + (size_t)win * WN * WD, wtid);
  }
  cp_async_commit();
  for (int it = 0; win < nwin; ++it, win += stride) {
    __nv_bfloat16* cur = base + (it & 1) * L::SLOT;
    if (win + stride < nwin) {
      __nv_bfloat16* nxt = base + ((it + 1) & 1) * L::SLOT;
      copy_tile(nxt, x + (size_t)(win + stride) * WN * WD, wtid);
      copy_tile(nxt + WN * LDX, g + (size_t)(win + stride) * WN * WD, wtid);
    }
    cp_async_commit();
    cp_async_wait_prior();
    warpgroup_sync(wg);  // this window's x and g have landed

    uint32_t xa[4][4], ga[4][4];
    rows_a(xa, cur, warp, lane);
    rows_a(ga, cur + WN * LDX, warp, lane);
    bool gr, gc;
    mask_gates(win, wh, ww, gr, gc);
    const float* lw = lse + (size_t)win * NH * WN;
    const size_t row0 = (size_t)win * WN + r0;  // global row of r0

    float dxa[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) dxa[j][0] = dxa[j][1] = dxa[j][2] = dxa[j][3] = 0.f;
#pragma unroll 1
    for (int h = 0; h < NH; ++h) {
      __nv_bfloat16* s_q = base + L::QN + (h & 1) * L::T16;   // q_n [64][LDK]
      __nv_bfloat16* s_da = base + L::DA + (h & 1) * L::T16;  // dacc [64][LDK]
      __nv_bfloat16* s_k = base + L::KN;                      // k_n [64][LDK]
      __nv_bfloat16* s_v = base + L::VV;                      // v [64][LDK]
      __nv_bfloat16* s_p = base + L::PP;                      // P [64][LDS]
      __nv_bfloat16* s_dc = base + L::DC;                     // dcos [64][LDS]
      const float l0 = lw[h * WN + r0] * LOG2E, l1 = lw[h * WN + r1] * LOG2E;  // used below

      // recompute q_n, k_n, v of the warp's rows; dacc = bf16(g)·bf16(wp_h)ᵀ
      float qn[2][4], kn[2][4], iq[2], ik[2];
      uint32_t qa[4], daa[4];
      {
        float acc[6][4];
        head_qkv<NH>(acc, xa, s_wqkv, sf + L::BQKV, h, lane);
        normalize_rows(acc[0], acc[1], iq);
        normalize_rows(acc[2], acc[3], ik);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qn[0][e] = acc[0][e], qn[1][e] = acc[1][e];
          kn[0][e] = acc[2][e], kn[1][e] = acc[3][e];
        }
        to_a(qa, acc[0], acc[1]);
        store_rows(s_q, acc[0], acc[1], r0, t);
        store_rows(s_k, acc[2], acc[3], r0, t);
        store_rows(s_v, acc[4], acc[5], r0, t);
        float da[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_pair(da[0], da[1], ga[kk], s_wproj, LDX, h * HP, 16 * kk, lane);
        to_a(daa, da[0], da[1]);
        store_rows(s_da, da[0], da[1], r0, t);
      }
      warpgroup_sync(wg);  // q_n, k_n, v and dacc of all rows are in

      // the query side: cos, p = exp(s - lse), O, dp, ds, dq_n
      float cs[8][4], p[8][4];
      cosines(cs, qa, s_k, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = cs[j][e];
      const float* bh = bias + (size_t)h * WN * WN;
      to_logits2(p, sf[L::SCALE + h] * LOG2E,
                 [&](int r, int c) {
                   const float2 b = __ldg(reinterpret_cast<const float2*>(bh + r * WN + c));
                   return make_float2(b.x * LOG2E, b.y * LOG2E);
                 },
                 mrow, mcol, gr, gc, r0, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        p[j][0] = exp2_approx(p[j][0] - l0), p[j][1] = exp2_approx(p[j][1] - l0);
        p[j][2] = exp2_approx(p[j][2] - l1), p[j][3] = exp2_approx(p[j][3] - l1);
      }
      {
        // O = bf16(P)·v: the attention output of the warp's rows, for dwproj
        float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t pa[4];
          to_a(pa, p[2 * kk], p[2 * kk + 1]);
          sts32(s_p + r0 * LDS + 16 * kk + 2 * t, pa[0]);
          sts32(s_p + r1 * LDS + 16 * kk + 2 * t, pa[1]);
          sts32(s_p + r0 * LDS + 16 * kk + 8 + 2 * t, pa[2]);
          sts32(s_p + r1 * LDS + 16 * kk + 8 + 2 * t, pa[3]);
          mma_pair_t(o[0], o[1], pa, s_v, LDK, 0, 16 * kk, lane);
        }
        store_rows_global(acc_out, AP, o[0], o[1], row0, h * HP, t);
      }
      // dp = bf16(dacc)·bf16(v)ᵀ; delta = Σ_j dp·p (float32)
      float dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; j += 2) mma_pair(dp[j], dp[j + 1], daa, s_v, LDK, 8 * j, 0, lane);
      float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dl0 += dp[j][0] * p[j][0] + dp[j][1] * p[j][1];
        dl1 += dp[j][2] * p[j][2] + dp[j][3] * p[j][3];
      }
      dl0 = quad_sum(dl0);
      dl1 = quad_sum(dl1);
      // ds = p (dp - delta): into dbias (this warpgroup's slot, the thread's
      // own elements, eight at a time with their loads issued together),
      // dscale; dcos = ds·scale, in place of dp
      const float sc = sf[L::SCALE + h];
      float dsc = 0.f;
      float* db0 = my_dbias + (h * WN + r0) * WN + 2 * t;
      float* db1 = my_dbias + (h * WN + r1) * WN + 2 * t;
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += 4) {
        float2 b0[4], b1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b0[j] = *reinterpret_cast<const float2*>(db0 + 8 * (j0 + j));
          b1[j] = *reinterpret_cast<const float2*>(db1 + 8 * (j0 + j));
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j0 + jj;
          const float d0 = p[j][0] * (dp[j][0] - dl0), d1 = p[j][1] * (dp[j][1] - dl0);
          const float d2 = p[j][2] * (dp[j][2] - dl1), d3 = p[j][3] * (dp[j][3] - dl1);
          dsc += d0 * cs[j][0] + d1 * cs[j][1] + d2 * cs[j][2] + d3 * cs[j][3];
          b0[jj].x += d0, b0[jj].y += d1, b1[jj].x += d2, b1[jj].y += d3;
          dp[j][0] = d0 * sc, dp[j][1] = d1 * sc, dp[j][2] = d2 * sc, dp[j][3] = d3 * sc;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          *reinterpret_cast<float2*>(db0 + 8 * (j0 + j)) = b0[j];
          *reinterpret_cast<float2*>(db1 + 8 * (j0 + j)) = b1[j];
        }
      }
      dsc = warp_sum(dsc);
      if (lane == 0) sf[L::DSC + gw * 8 + h] += dsc;
      // dq_n = bf16(dcos)·bf16(k_n); dcos of the warp's rows to shared memory
      float dq[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ca[4];
        to_a(ca, dp[2 * kk], dp[2 * kk + 1]);
        sts32(s_dc + r0 * LDS + 16 * kk + 2 * t, ca[0]);
        sts32(s_dc + r1 * LDS + 16 * kk + 2 * t, ca[1]);
        sts32(s_dc + r0 * LDS + 16 * kk + 8 + 2 * t, ca[2]);
        sts32(s_dc + r1 * LDS + 16 * kk + 8 + 2 * t, ca[3]);
        mma_pair_t(dq[0], dq[1], ca, s_k, LDK, 0, 16 * kk, lane);
      }
      warpgroup_sync(wg);  // P and dcos of all rows are in

      // the key side: dk_n = bf16(dcos)ᵀ·bf16(q_n), dv = bf16(P)ᵀ·bf16(dacc)
      float dk[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        load_a_t(a, s_dc, LDS, 16 * warp, 16 * kk, lane);
        mma_pair_t(dk[0], dk[1], a, s_q, LDK, 0, 16 * kk, lane);
        load_a_t(a, s_p, LDS, 16 * warp, 16 * kk, lane);
        mma_pair_t(dv[0], dv[1], a, s_da, LDK, 0, 16 * kk, lane);
      }
      norm_backward(dq, qn, iq);
      norm_backward(dk, kn, ik);

      // dqkv of head h (float32): its column sums into dbqkv, bf16 to the
      // token sums, and dx += bf16(dqkv_h)·bf16(wqkv_h)ᵀ
      auto emit = [&](int pt, const float(&d)[2][4]) {
        const int col = pt * AP + h * HP;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float c0 = column_sum(d[hf][0] + d[hf][2]);
          const float c1 = column_sum(d[hf][1] + d[hf][3]);
          if (g8 == 0) {
            float* sb = sf + L::DBQ + gw * QKV + col + 8 * hf + 2 * t;
            sb[0] += c0;
            sb[1] += c1;
          }
        }
        store_rows_global(dqkv_out, QKV, d[0], d[1], row0, col, t);
        uint32_t a[4];
        to_a(a, d[0], d[1]);
#pragma unroll
        for (int j = 0; j < 8; j += 2) mma_pair_t(dxa[j], dxa[j + 1], a, s_wqkv, LDX, 8 * j, col, lane);
      };
      emit(0, dq);
      emit(1, dk);
      emit(2, dv);
    }

    // dx -> bf16 in the window's x tile (own rows), then out
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      sts32(cur + r0 * LDX + c, pack_bf16(dxa[j][0], dxa[j][1]));
      sts32(cur + r1 * LDX + c, pack_bf16(dxa[j][2], dxa[j][3]));
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i, row = 16 * warp + c / 8, part8 = c % 8;
      *reinterpret_cast<uint4*>(dx + ((size_t)win * WN + row) * WD + part8 * 8) =
          *reinterpret_cast<const uint4*>(cur + row * LDX + part8 * 8);
    }
    warpgroup_sync(wg);  // the slot is free for the window after next
  }

  // the warpgroup's slot: its four warps' sums of dbqkv and dscale, in order
  __syncthreads();
  for (int o = wtid; o < QKV; o += 128) {
    const int pt = o / AP, h = (o % AP) / HP, d = o % HP;
    if (d >= HD) continue;
    float s = 0.f;
    for (int w = 0; w < 4; ++w) s += sf[L::DBQ + (4 * wg + w) * QKV + o];
    my[pt * A + h * HD + d] = s;
  }
  if (wtid < NH) {
    float s = 0.f;
    for (int w = 0; w < 4; ++w) s += sf[L::DSC + (4 * wg + w) * 8 + wtid];
    my[3 * A + wtid] = s;
  }
}

// The token sums of the parameter cotangents the TPU kernel accumulates in
// place (:685-700): dwqkv = xᵀ·dqkv [D][3·AP] and dwproj = accᵀ·g [AP][D] on
// mma.sync (bf16 operands, as cot_bf16 rounds them; float32 accumulation),
// dbproj = Σ g in float32.  Block b takes rows [b·rpb, (b + 1)·rpb), 64 at a
// time, double-buffered by cp.async, and writes its unpadded partial sums to
// part[b].  Warp w owns the dwqkv tiles of channels [16·(w / 2), +16) and
// half of the output columns, and JP of the dwproj tiles.
template <int NH, int HD>
struct Sums {
  static constexpr int A = NH * HD;
  static constexpr int AP = NH * HP;
  static constexpr int QKV = 3 * AP;
  static constexpr int LQ = QKV + 8;
  static constexpr int LA = AP + 8;
  static constexpr int X = 0;
  static constexpr int G = X + WN * LDX;
  static constexpr int Q = G + WN * LDX;
  static constexpr int AC = Q + WN * LQ;
  static constexpr int BUF = AC + WN * LA;
  static constexpr size_t BYTES = 2 * (size_t)BUF * sizeof(__nv_bfloat16);
  static constexpr int JW = QKV / 32;         // dwqkv column pairs per warp
  static constexpr int JP = (AP / 16) * 4 / 8;  // dwproj tiles per warp
  static_assert(BUF % 8 == 0 && QKV % 32 == 0 && (AP / 16) * 4 % 8 == 0, "tiling");
  static_assert(BYTES <= MAX_SMEM, "does not fit in shared memory");
};

template <int NH, int HD>
__global__ void __launch_bounds__(256, 1) attention_param_sums(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    const __nv_bfloat16* __restrict__ dqkv, const __nv_bfloat16* __restrict__ acc,
    float* __restrict__ part, int rows, int rpb) {
  using S = Sums<NH, HD>;
  constexpr int A = S::A, AP = S::AP, QKV = S::QKV, JW = S::JW, JP = S::JP;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t = lane & 3;
  const int begin = blockIdx.x * rpb;
  const int end = begin + rpb < rows ? begin + rpb : rows;
  const int steps = end > begin ? (end - begin) / WN : 0;

  auto load = [&](int step, __nv_bfloat16* buf) {
    const size_t r = (size_t)begin + (size_t)step * WN;
    for (int c = tid; c < WN * (WD / 8); c += 256) {
      const int n = c / (WD / 8), k = c % (WD / 8);
      cp_async16(buf + S::X + n * LDX + 8 * k, x + (r + n) * WD + 8 * k);
      cp_async16(buf + S::G + n * LDX + 8 * k, g + (r + n) * WD + 8 * k);
    }
    for (int c = tid; c < WN * (QKV / 8); c += 256) {
      const int n = c / (QKV / 8), k = c % (QKV / 8);
      cp_async16(buf + S::Q + n * S::LQ + 8 * k, dqkv + (r + n) * QKV + 8 * k);
    }
    for (int c = tid; c < WN * (AP / 8); c += 256) {
      const int n = c / (AP / 8), k = c % (AP / 8);
      cp_async16(buf + S::AC + n * S::LA + 8 * k, acc + (r + n) * AP + 8 * k);
    }
  };

  float cw[JW][2][4], cp[JP][2][4];
#pragma unroll
  for (int j = 0; j < JW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cw[j][0][e] = cw[j][1][e] = 0.f;
#pragma unroll
  for (int j = 0; j < JP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cp[j][0][e] = cp[j][1][e] = 0.f;
  float bsum = 0.f;
  const int mw = 16 * (warp >> 1);        // dwqkv: the warp's 16 channels
  const int nw = 16 * JW * (warp & 1);    // and its first output column

  if (steps > 0) load(0, sm);
  cp_async_commit();
  for (int st = 0; st < steps; ++st) {
    const __nv_bfloat16* buf = sm + (st & 1) * S::BUF;
    if (st + 1 < steps) load(st + 1, sm + ((st + 1) & 1) * S::BUF);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      load_a_t(a, buf + S::X, LDX, mw, 16 * kk, lane);
#pragma unroll
      for (int j = 0; j < JW; ++j)
        mma_pair_t(cw[j][0], cw[j][1], a, buf + S::Q, S::LQ, nw + 16 * j, 16 * kk, lane);
#pragma unroll
      for (int j = 0; j < JP; ++j) {
        const int id = warp * JP + j;
        load_a_t(a, buf + S::AC, S::LA, 16 * (id / 4), 16 * kk, lane);
        mma_pair_t(cp[j][0], cp[j][1], a, buf + S::G, LDX, 16 * (id % 4), 16 * kk, lane);
      }
    }
    if (tid < WD)
      for (int r = 0; r < WN; ++r) bsum += __bfloat162float(buf[S::G + r * LDX + tid]);
    __syncthreads();  // the buffer is free to be refilled
  }

  // the block's partial sums, without the head padding
  float* my = part + (size_t)blockIdx.x * BwdMma<NH, HD>::SIZE2;
#pragma unroll
  for (int j = 0; j < JW; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = mw + g8 + 8 * (e >> 1), o = nw + 16 * j + 8 * hf + 2 * t + (e & 1);
        const int pt = o / AP, h = (o % AP) / HP, d = o % HP;
        if (d < HD) my[c * 3 * A + pt * A + h * HD + d] = cw[j][hf][e];
      }
#pragma unroll
  for (int j = 0; j < JP; ++j) {
    const int id = warp * JP + j;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int a = 16 * (id / 4) + g8 + 8 * (e >> 1), c = 16 * (id % 4) + 8 * hf + 2 * t + (e & 1);
        const int h = a / HP, d = a % HP;
        if (d < HD) my[WD * 3 * A + (h * HD + d) * WD + c] = cp[j][hf][e];
      }
  }
  if (tid < WD) my[WD * 3 * A + A * WD + tid] = bsum;
}

// dparams = [dwqkv | dbqkv, dscale, dbias | dwproj, dbproj]: the middle from
// the n1 per-warpgroup slots of part1, the rest from the n2 slots of part2,
// each added in slot order.
__global__ void reduce_backward_partials(const float* __restrict__ part1, int n1, int size1,
                                         const float* __restrict__ part2, int n2, int size2,
                                         int head2, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= size1 + size2) return;
  float s = 0.f;
  if (e >= head2 && e < head2 + size1) {
    for (int b = 0; b < n1; ++b) s += part1[(size_t)b * size1 + e - head2];
  } else {
    const int k = e < head2 ? e : e - size1;
    for (int b = 0; b < n2; ++b) s += part2[(size_t)b * size2 + k];
  }
  out[e] = s;
}

template <int NH, int HD>
int launch_mma(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* dx,
               void* workspace, void* dparams, int nwin, int wh, int ww, int blocks,
               cudaStream_t stream) {
  if (((uintptr_t)p[0] | (uintptr_t)p[1] | (uintptr_t)dx | (uintptr_t)workspace) & 15)
    return (int)cudaErrorMisalignedAddress;
  using L = BwdMma<NH, HD>;
  using S = Sums<NH, HD>;
  const BwdPlan<NH, HD> plan(nwin, blocks);
  float* ws = (float*)workspace;
  float* part1 = ws;
  float* part2 = ws + plan.off2;
  auto* dq = reinterpret_cast<__nv_bfloat16*>(ws + plan.off3);
  auto* ac = reinterpret_cast<__nv_bfloat16*>(ws + plan.off4);
  auto kern = window_attention_bwd_mma<NH, HD>;
  auto sums = attention_param_sums<NH, HD>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)L::BYTES)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(sums, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)S::BYTES)) != cudaSuccess)
    return (int)err;
  kern<<<plan.g1, 128 * L::WG, L::BYTES, stream>>>(
      (const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[1], (const float*)p[2], wq_k, wq_n,
      (const float*)p[3], (const float*)p[4], (const float*)p[5], (const float*)p[6], wp_k,
      wp_n, (const float*)p[7], (const float*)p[8], (const float*)p[9], (__nv_bfloat16*)dx,
      part1, dq, ac, nwin, wh, ww);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sums<<<plan.g2, 256, S::BYTES, stream>>>((const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[1],
                                           dq, ac, part2, nwin * WN, plan.rpb);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int size = L::SIZE1 + L::SIZE2;
  reduce_backward_partials<<<(size + 255) / 256, 256, 0, stream>>>(
      part1, plan.n1, L::SIZE1, part2, plan.g2, L::SIZE2, WD * 3 * L::A, (float*)dparams);
  return (int)cudaGetLastError();
}

// ---- the bfloat16 tensor-core generic body: 32 <= N <= 64 -------------------
// (window_attention_generic_mma.cuh: the plan, the rule, the layout.)  The
// flagship body's three launches at run-time widths:
//  1. per window (window_attention_bwd_gmma): a window's WW warps, each 16
//     rows as queries and then as keys, the window's x and g tiles by
//     cp.async (the next window's while this one computes, where the plan
//     double-buffers).  Per head: q, k, v and dacc = g·wp_hᵀ of the warp's
//     rows, P from the forward's lse; O, dp, ds, dq_n for its query rows;
//     then, from q_n, dacc, P and dcos of all rows in shared memory, dk_n
//     and dv for its key rows (ldmatrix.trans); the L2-norm backward;
//     dx += dqkv_h·wqkv_hᵀ in registers.  dqkv and the attention output
//     leave as bf16 rows for the token sums.  Padded query rows get P = 0
//     and padded g rows are zero, so they add nothing;
//  2. the token sums (attention_param_sums_g): dwqkv = xᵀ·dqkv and
//     dwproj = accᵀ·g on mma.sync, dbproj = Σ g in float32; a block takes
//     a contiguous range of token rows and, where the cotangents hold more
//     than 8·SUMS_TILES tiles of 16x16, a chunk of them (blockIdx.y);
//  3. the reduce of both kinds of partial sums in slot order
//     (reduce_backward_partials).
// Rounding as the flagship body (cot_bf16): every product's operands bf16,
// ds, delta, the softmax statistics, the L2-norm backward and the sums into
// dbias, dscale, dbqkv and dbproj float32.
// 1 / (|row| + 1e-12) of rows g and g + 8 of HT accumulator tiles.
template <int HT>
__device__ __forceinline__ void row_inv(const float (&a)[HT][4], float (&inv)[2]) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < HT; ++j) {
    s0 += a[j][0] * a[j][0] + a[j][1] * a[j][1];
    s1 += a[j][2] * a[j][2] + a[j][3] * a[j][3];
  }
  inv[0] = 1.f / (sqrtf(quad_sum(s0)) + 1e-12f);
  inv[1] = 1.f / (sqrtf(quad_sum(s1)) + 1e-12f);
}

// In place, the L2-norm backward of rows held as HT tiles: d <- inv·(d −
// n·(d·n)) per row, n the normalised rows, inv[0] / inv[1] of rows g / g + 8.
template <int HT>
__device__ __forceinline__ void norm_backward_rows(float (&d)[HT][4], const float (&n)[HT][4],
                                                   const float (&inv)[2]) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < HT; ++j) {
    s0 += d[j][0] * n[j][0] + d[j][1] * n[j][1];
    s1 += d[j][2] * n[j][2] + d[j][3] * n[j][3];
  }
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
#pragma unroll
  for (int j = 0; j < HT; ++j) {
    d[j][0] = inv[0] * (d[j][0] - n[j][0] * s0), d[j][1] = inv[0] * (d[j][1] - n[j][1] * s0);
    d[j][2] = inv[1] * (d[j][2] - n[j][2] * s1), d[j][3] = inv[1] * (d[j][3] - n[j][3] * s1);
  }
}

template <int DM, int HPD>
__global__ void __launch_bounds__(attn_mma::WARPS * 32) window_attention_bwd_gmma(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ wqkv, int wq_k, int wq_n, const float* __restrict__ bqkv,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ wproj, int wp_k, int wp_n, const float* __restrict__ mrow,
    const float* __restrict__ mcol, const float* __restrict__ lse,
    __nv_bfloat16* __restrict__ dx, float* __restrict__ part,
    __nv_bfloat16* __restrict__ dqkv_out, __nv_bfloat16* __restrict__ acc_out, int nwin,
    int wh, int ww, attn_mma::BwdPlan P) {
  using namespace attn_mma;
  constexpr int DT = DM / 8, DK = DM / 16;
  constexpr int HT = HPD / 8, HK = HPD / 16;
  extern __shared__ float4 smem4[];
  float* sf = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(sf + P.floats);
  const Geom& gm = P.g;
  const Weights& W = P.w;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int N = gm.N, D = gm.D, nh = gm.nh, NP = gm.NP, LDK = gm.LDK, AP = gm.AP, A = gm.A;
  const int LDX = P.LDX, LDS = P.LDS, QKV = 3 * AP;
  const int warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t = lane & 3;
  const int grp = warp / gm.WW, wig = warp % gm.WW, gn = 32 * gm.WW, gi = tid - grp * gn;
  const int size1 = 3 * A + nh + nh * N * N;  // a group's slot of partial sums
  float* my = part + (size_t)(blockIdx.x * P.G + grp) * size1;
  float* my_dbias = my + 3 * A + nh;

  // ---- once per block: zeros (padding, the warps' sums, the group's dbias
  // slot), the float32 parameters, resident weights
  for (int i = tid; i < (W.elems + P.G * P.gelems) / 8; i += nthreads)
    reinterpret_cast<uint4*>(sw)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int o = tid; o < QKV; o += nthreads) {
    const int pt = o / AP, h = (o % AP) / HPD, d = o % HPD;
    sf[P.f_bqkv + o] = d < gm.hd ? bqkv[pt * A + h * gm.hd + d] : 0.f;
  }
  for (int h = tid; h < nh; h += nthreads) sf[P.f_scale + h] = scale[h];
  for (int e = tid; e < P.floats - P.f_dbq; e += nthreads) sf[P.f_dbq + e] = 0.f;
  for (int e = gi; e < nh * N * N; e += gn) my_dbias[e] = 0.f;
  __syncthreads();
  if (W.resident) stage_weights(sw, W, gm, 0, nh, wqkv, wq_k, wq_n, wproj, wp_k, wp_n, tid, nthreads);
  __syncthreads();

  __nv_bfloat16* gbase = sw + W.elems + grp * P.gelems;
  const int r0 = 16 * wig + g8, r1 = r0 + 8;
  const bool in0 = r0 < N, in1 = r1 < N;
  const int q0 = in0 ? r0 : 0, q1 = in1 ? r1 : 0;
  const int tiles = (nwin + P.G - 1) / P.G, bx = blockIdx.x, gx = gridDim.x;
  const int cpr = D / 8;  // 16-byte chunks of a row

  // the copies of window w's x and g into `slot`, by the group's threads
  auto load = [&](__nv_bfloat16* slot, int w) {
    const __nv_bfloat16* xs = x + (size_t)w * N * D;
    const __nv_bfloat16* gs = g + (size_t)w * N * D;
    for (int c = gi; c < N * cpr; c += gn) {
      const int r = c / cpr, k = 8 * (c % cpr);
      cp_async16(slot + r * LDX + k, xs + r * D + k);
      cp_async16(slot + (NP + r) * LDX + k, gs + r * D + k);
    }
  };
  if (P.dbuf && bx * P.G + grp < nwin) load(gbase, bx * P.G + grp);
  cp_async_commit();

  for (int it = 0, tile = bx; tile < tiles; ++it, tile += gx) {
    const int win = tile * P.G + grp, next = (tile + gx) * P.G + grp;
    const bool valid = win < nwin;
    __nv_bfloat16* cur = gbase + (P.dbuf ? (it & 1) * 2 * NP * LDX : 0);
    if (P.dbuf) {
      if (tile + gx < tiles && next < nwin) load(gbase + ((it + 1) & 1) * 2 * NP * LDX, next);
      cp_async_commit();
      cp_async_wait_prior();
    } else {
      if (valid) load(cur, win);
      cp_async_commit();
      cp_async_wait_all();
    }
    group_sync(grp, gm.WW);  // the window's x and g have landed
    bool gr, gc;
    mask_gates(valid ? win : 0, wh, ww, gr, gc);
    const __nv_bfloat16* gt = cur + NP * LDX;
    const size_t grow = (size_t)(valid ? win : 0) * N;  // the window's first token row

    float dxa[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j) dxa[j][0] = dxa[j][1] = dxa[j][2] = dxa[j][3] = 0.f;
#pragma unroll 1
    for (int h = 0; h < nh; ++h) {
      if (!W.resident) {  // head h's weights, between two block barriers
        __syncthreads();
        stage_weights(sw, W, gm, h, h + 1, wqkv, wq_k, wq_n, wproj, wp_k, wp_n, tid, nthreads);
        __syncthreads();
      }
      if (!valid) continue;
      __nv_bfloat16* s_q = gbase + P.o_qn + (h & 1) * NP * LDK;   // q_n [NP][LDK]
      __nv_bfloat16* s_da = gbase + P.o_da + (h & 1) * NP * LDK;  // dacc [NP][LDK]
      __nv_bfloat16* s_k = gbase + P.o_kn;                        // k_n [NP][LDK]
      __nv_bfloat16* s_v = gbase + P.o_v;                         // v [NP][LDK]
      __nv_bfloat16* s_p = gbase + P.o_p;                         // P [NP][LDS]
      __nv_bfloat16* s_dc = gbase + P.o_dc;                       // dcos [NP][LDS]
      const int qcol = W.resident ? h * HPD : 0, pstride = W.resident ? AP : HPD;
      const int prow = W.resident ? h * HPD : 0;
      const float* lh = lse + ((size_t)(valid ? win : 0) * nh + h) * N;
      const float l0 = lh[q0] * LOG2E, l1 = lh[q1] * LOG2E;

      // recompute q_n, k_n, v of the warp's rows; dacc = bf16(g)·bf16(wp_h)ᵀ
      float qn[HT][4], kn[HT][4], iq[2], ik[2];
      uint32_t qa[HK][4], daa[HK][4];
      {
        float acc[3][HT][4], da[HT][4];
#pragma unroll
        for (int j = 0; j < HT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[0][j][e] = acc[1][j][e] = acc[2][j][e] = da[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          if (kk >= gm.dk) break;
          uint32_t a[4];
          load_a(a, cur, LDX, 16 * wig, 16 * kk, lane);
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int n2 = 0; n2 < HK; ++n2)
              mma_pair_t(acc[p][2 * n2], acc[p][2 * n2 + 1], a, sw, W.ld_qkv,
                         qcol + p * pstride + 16 * n2, 16 * kk, lane);
          load_a(a, gt, LDX, 16 * wig, 16 * kk, lane);
#pragma unroll
          for (int n2 = 0; n2 < HK; ++n2)
            mma_pair(da[2 * n2], da[2 * n2 + 1], a, sw + W.w_proj, W.ld_proj, prow + 16 * n2,
                     16 * kk, lane);
        }
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int j = 0; j < HT; ++j) {
            const float* bq = sf + P.f_bqkv + p * AP + h * HPD + 8 * j + 2 * t;
            acc[p][j][0] += bq[0], acc[p][j][1] += bq[1], acc[p][j][2] += bq[0], acc[p][j][3] += bq[1];
          }
        row_inv(acc[0], iq);
        row_inv(acc[1], ik);
#pragma unroll
        for (int j = 0; j < HT; ++j) {
          qn[j][0] = acc[0][j][0] * iq[0], qn[j][1] = acc[0][j][1] * iq[0];
          qn[j][2] = acc[0][j][2] * iq[1], qn[j][3] = acc[0][j][3] * iq[1];
          kn[j][0] = acc[1][j][0] * ik[0], kn[j][1] = acc[1][j][1] * ik[0];
          kn[j][2] = acc[1][j][2] * ik[1], kn[j][3] = acc[1][j][3] * ik[1];
          const int c = 8 * j + 2 * t;
          sts32(s_q + r0 * LDK + c, pack_bf16(qn[j][0], qn[j][1]));
          sts32(s_q + r1 * LDK + c, pack_bf16(qn[j][2], qn[j][3]));
          sts32(s_k + r0 * LDK + c, pack_bf16(kn[j][0], kn[j][1]));
          sts32(s_k + r1 * LDK + c, pack_bf16(kn[j][2], kn[j][3]));
          sts32(s_v + r0 * LDK + c, pack_bf16(acc[2][j][0], acc[2][j][1]));
          sts32(s_v + r1 * LDK + c, pack_bf16(acc[2][j][2], acc[2][j][3]));
          sts32(s_da + r0 * LDK + c, pack_bf16(da[j][0], da[j][1]));
          sts32(s_da + r1 * LDK + c, pack_bf16(da[j][2], da[j][3]));
        }
#pragma unroll
        for (int kk = 0; kk < HK; ++kk) {
          to_a(qa[kk], qn[2 * kk], qn[2 * kk + 1]);
          to_a(daa[kk], da[2 * kk], da[2 * kk + 1]);
        }
      }
      group_sync(grp, gm.WW);  // q_n, k_n, v and dacc of all rows are in

      // the query side: cos, p = exp(s - lse) (0 on padded rows and keys), O
      float cs[8][4], p[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) cs[j][e] = p[j][e] = 0.f;
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (16 * jp >= NP) break;
#pragma unroll
        for (int kk = 0; kk < HK; ++kk)
          mma_pair(cs[2 * jp], cs[2 * jp + 1], qa[kk], s_k, LDK, 16 * jp, 16 * kk, lane);
      }
      const float sc = sf[P.f_scale + h], sc2 = sc * LOG2E;
      const float* bh = bias + (size_t)h * N * N;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= NP) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          p[j][e] = in0 ? exp2_approx(logit2(cs[j][e], sc2, bh, mrow, mcol, gr, gc, N, q0, c) - l0)
                        : 0.f;
          p[j][2 + e] =
              in1 ? exp2_approx(logit2(cs[j][2 + e], sc2, bh, mrow, mcol, gr, gc, N, q1, c) - l1)
                  : 0.f;
        }
      }
      {
        // O = bf16(P)·v: the attention output of the warp's rows, for dwproj
        float o[HT][4];
#pragma unroll
        for (int j = 0; j < HT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (16 * kk >= NP) break;
          uint32_t pa[4];
          to_a(pa, p[2 * kk], p[2 * kk + 1]);
          sts32(s_p + r0 * LDS + 16 * kk + 2 * t, pa[0]);
          sts32(s_p + r1 * LDS + 16 * kk + 2 * t, pa[1]);
          sts32(s_p + r0 * LDS + 16 * kk + 8 + 2 * t, pa[2]);
          sts32(s_p + r1 * LDS + 16 * kk + 8 + 2 * t, pa[3]);
#pragma unroll
          for (int n2 = 0; n2 < HK; ++n2)
            mma_pair_t(o[2 * n2], o[2 * n2 + 1], pa, s_v, LDK, 16 * n2, 16 * kk, lane);
        }
#pragma unroll
        for (int j = 0; j < HT; ++j) {
          const int c = h * HPD + 8 * j + 2 * t;
          if (in0) sts32(acc_out + (grow + r0) * AP + c, pack_bf16(o[j][0], o[j][1]));
          if (in1) sts32(acc_out + (grow + r1) * AP + c, pack_bf16(o[j][2], o[j][3]));
        }
      }
      // dp = bf16(dacc)·bf16(v)ᵀ; delta = Σ_j dp·p (float32)
      float dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (16 * jp >= NP) break;
#pragma unroll
        for (int kk = 0; kk < HK; ++kk)
          mma_pair(dp[2 * jp], dp[2 * jp + 1], daa[kk], s_v, LDK, 16 * jp, 16 * kk, lane);
      }
      float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dl0 += dp[j][0] * p[j][0] + dp[j][1] * p[j][1];
        dl1 += dp[j][2] * p[j][2] + dp[j][3] * p[j][3];
      }
      dl0 = quad_sum(dl0);
      dl1 = quad_sum(dl1);
      // ds = p (dp - delta): into dbias (the group's slot, the thread's own
      // elements, 16 at a time with their loads issued together, so that one
      // memory latency covers them) and dscale; dcos = ds·scale in place of dp
      float dsc = 0.f;
      float* db0 = my_dbias + (h * N + q0) * N;
      float* db1 = my_dbias + (h * N + q1) * N;
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += 4) {
        if (8 * j0 >= NP) break;
        float b[4][2][2];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * (j0 + jj) + 2 * t + e;
            b[jj][e][0] = in0 && c < N ? db0[c] : 0.f;
            b[jj][e][1] = in1 && c < N ? db1[c] : 0.f;
          }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + jj, c = 8 * j + 2 * t + e;
            const float d0 = p[j][e] * (dp[j][e] - dl0), d1 = p[j][2 + e] * (dp[j][2 + e] - dl1);
            dsc += d0 * cs[j][e] + d1 * cs[j][2 + e];
            if (c < N) {
              if (in0) db0[c] = b[jj][e][0] + d0;
              if (in1) db1[c] = b[jj][e][1] + d1;
            }
            dp[j][e] = d0 * sc, dp[j][2 + e] = d1 * sc;
          }
      }
      dsc = warp_sum(dsc);
      if (lane == 0) sf[P.f_dsc + warp * nh + h] += dsc;
      // dq_n = bf16(dcos)·bf16(k_n); dcos of the warp's rows to shared memory
      float dq[HT][4];
#pragma unroll
      for (int j = 0; j < HT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk >= NP) break;
        uint32_t ca[4];
        to_a(ca, dp[2 * kk], dp[2 * kk + 1]);
        sts32(s_dc + r0 * LDS + 16 * kk + 2 * t, ca[0]);
        sts32(s_dc + r1 * LDS + 16 * kk + 2 * t, ca[1]);
        sts32(s_dc + r0 * LDS + 16 * kk + 8 + 2 * t, ca[2]);
        sts32(s_dc + r1 * LDS + 16 * kk + 8 + 2 * t, ca[3]);
#pragma unroll
        for (int n2 = 0; n2 < HK; ++n2)
          mma_pair_t(dq[2 * n2], dq[2 * n2 + 1], ca, s_k, LDK, 16 * n2, 16 * kk, lane);
      }
      group_sync(grp, gm.WW);  // P and dcos of all rows are in

      // the key side: dk_n = bf16(dcos)ᵀ·bf16(q_n), dv = bf16(P)ᵀ·bf16(dacc)
      float dk[HT][4], dv[HT][4];
#pragma unroll
      for (int j = 0; j < HT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk >= NP) break;
        uint32_t a[4];
        load_a_t(a, s_dc, LDS, 16 * wig, 16 * kk, lane);
#pragma unroll
        for (int n2 = 0; n2 < HK; ++n2)
          mma_pair_t(dk[2 * n2], dk[2 * n2 + 1], a, s_q, LDK, 16 * n2, 16 * kk, lane);
        load_a_t(a, s_p, LDS, 16 * wig, 16 * kk, lane);
#pragma unroll
        for (int n2 = 0; n2 < HK; ++n2)
          mma_pair_t(dv[2 * n2], dv[2 * n2 + 1], a, s_da, LDK, 16 * n2, 16 * kk, lane);
      }
      norm_backward_rows(dq, qn, iq);
      norm_backward_rows(dk, kn, ik);

      // dqkv of head h (float32): its column sums into dbqkv, bf16 to the
      // token sums, and dx += bf16(dqkv_h)·bf16(wqkv_h)ᵀ
      float* dbq = sf + P.f_dbq + warp * QKV;
      auto emit = [&](int pt, float(&d)[HT][4]) {
#pragma unroll
        for (int j = 0; j < HT; ++j) {
          const int col = pt * AP + h * HPD + 8 * j + 2 * t;
          const float c0 = column_sum(d[j][0] + d[j][2]);
          const float c1 = column_sum(d[j][1] + d[j][3]);
          if (g8 == 0) dbq[col] += c0, dbq[col + 1] += c1;
          if (in0) sts32(dqkv_out + (grow + r0) * QKV + col, pack_bf16(d[j][0], d[j][1]));
          if (in1) sts32(dqkv_out + (grow + r1) * QKV + col, pack_bf16(d[j][2], d[j][3]));
        }
#pragma unroll
        for (int kk = 0; kk < HK; ++kk) {
          uint32_t a[4];
          to_a(a, d[2 * kk], d[2 * kk + 1]);
#pragma unroll
          for (int n2 = 0; n2 < DK; ++n2) {
            if (n2 >= gm.dk) break;
            mma_pair(dxa[2 * n2], dxa[2 * n2 + 1], a, sw, W.ld_qkv, 16 * n2,
                     qcol + pt * pstride + 16 * kk, lane);
          }
        }
      };
      emit(0, dq);
      emit(1, dk);
      emit(2, dv);
    }

    // dx, bf16, from the registers (real rows and columns)
    if (valid) {
      __nv_bfloat16* dw = dx + grow * D;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int c = 8 * j + 2 * t;
        if (c >= D) break;
        if (in0) sts32(dw + r0 * D + c, pack_bf16(dxa[j][0], dxa[j][1]));
        if (in1) sts32(dw + r1 * D + c, pack_bf16(dxa[j][2], dxa[j][3]));
      }
    }
    group_sync(grp, gm.WW);  // the slot and the buffers are free
  }
  cp_async_wait_all();

  // the group's slot: its warps' sums of dbqkv and dscale, in warp order
  __syncthreads();
  for (int o = gi; o < QKV; o += gn) {
    const int pt = o / AP, h = (o % AP) / HPD, d = o % HPD;
    if (d >= gm.hd) continue;
    float s = 0.f;
    for (int w = 0; w < gm.WW; ++w) s += sf[P.f_dbq + (grp * gm.WW + w) * QKV + o];
    my[pt * A + h * gm.hd + d] = s;
  }
  for (int h = gi; h < nh; h += gn) {
    float s = 0.f;
    for (int w = 0; w < gm.WW; ++w) s += sf[P.f_dsc + (grp * gm.WW + w) * nh + h];
    my[3 * A + h] = s;
  }
}

// The token sums at run-time widths: block (c, b) takes rows [b·rpb,
// (b + 1)·rpb) of the nwin·N token rows, 64 at a time by cp.async (rows
// past the end zero), and the cotangent tiles [c·8·SUMS_TILES, +8·SUMS_TILES)
// of dwqkv (DP/16 x 3AP/16 tiles, row-major) then dwproj (AP/16 x DP/16);
// warp w holds SUMS_TILES of them, every eighth.  It writes its unpadded
// partial sums to part[b] (block c = 0 also dbproj = Σ g).  The chunks of
// one row range are neighbours in the grid, so they run together and read
// their rows from L2 once they are in.
__global__ void __launch_bounds__(256) attention_param_sums_g(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    const __nv_bfloat16* __restrict__ dqkv, const __nv_bfloat16* __restrict__ acc,
    float* __restrict__ part, int rows, int rpb, attn_mma::Geom gm, attn_mma::SumsPlan S) {
  using namespace attn_mma;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t = lane & 3;
  const int D = gm.D, A = gm.A, AP = gm.AP, QKV = 3 * AP, DP = gm.DP, HPD = gm.HP;
  const int begin = blockIdx.y * rpb;
  const int end = begin + rpb < rows ? begin + rpb : rows;
  const int steps = end > begin ? (end - begin + 63) / 64 : 0;
  const int n1 = (DP / 16) * (QKV / 16), ntiles = n1 + (AP / 16) * (DP / 16);
  // the warp's tiles: first + 8·j, so that a chunk of fewer tiles than
  // 8·SUMS_TILES keeps every warp busy
  const int first = blockIdx.x * 8 * SUMS_TILES + warp;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  auto load = [&](int step, __nv_bfloat16* buf) {
    const int r = begin + 64 * step;
    const int cd = D / 8, cq = QKV / 8, ca = AP / 8;
    for (int c = tid; c < 64 * (2 * cd + cq + ca); c += 256) {
      const int n = c / (2 * cd + cq + ca), k = c % (2 * cd + cq + ca);
      const bool in = r + n < end;
      __nv_bfloat16* dst;
      const __nv_bfloat16* src;
      if (k < cd)
        dst = buf + n * S.LDX + 8 * k, src = x + (size_t)(r + n) * D + 8 * k;
      else if (k < 2 * cd)
        dst = buf + S.o_g + n * S.LDX + 8 * (k - cd), src = g + (size_t)(r + n) * D + 8 * (k - cd);
      else if (k < 2 * cd + cq)
        dst = buf + S.o_q + n * S.LQ + 8 * (k - 2 * cd),
        src = dqkv + (size_t)(r + n) * QKV + 8 * (k - 2 * cd);
      else
        dst = buf + S.o_a + n * S.LA + 8 * (k - 2 * cd - cq),
        src = acc + (size_t)(r + n) * AP + 8 * (k - 2 * cd - cq);
      if (in)
        cp_async16(dst, src);
      else
        *reinterpret_cast<uint4*>(dst) = zero4;
    }
  };
  // the padded columns of x and g (D..DP) stay zero in both buffers
  for (int i = tid; i < (S.dbuf ? 2 : 1) * S.buf / 8; i += 256)
    reinterpret_cast<uint4*>(sm)[i] = zero4;
  __syncthreads();

  float cw[SUMS_TILES][2][4];
#pragma unroll
  for (int j = 0; j < SUMS_TILES; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cw[j][0][e] = cw[j][1][e] = 0.f;
  float bsum = 0.f;
  if (steps > 0) load(0, sm);
  cp_async_commit();
  for (int st = 0; st < steps; ++st) {
    const __nv_bfloat16* buf = sm + (S.dbuf ? (st & 1) * S.buf : 0);
    if (S.dbuf) {
      if (st + 1 < steps) load(st + 1, sm + ((st + 1) & 1) * S.buf);
      cp_async_commit();
      cp_async_wait_prior();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SUMS_TILES; ++j) {
      const int id = first + 8 * j;
      if (id >= ntiles) break;
      // dwqkv tile (m: x channels, n: dqkv columns) or dwproj tile (m:
      // attention-output columns, n: g channels)
      const bool w1 = id < n1;
      const int m0 = 16 * (w1 ? id / (QKV / 16) : (id - n1) / (DP / 16));
      const int n0 = 16 * (w1 ? id % (QKV / 16) : (id - n1) % (DP / 16));
      const __nv_bfloat16* am = w1 ? buf : buf + S.o_a;
      const __nv_bfloat16* bm = w1 ? buf + S.o_q : buf + S.o_g;
      const int lda = w1 ? S.LDX : S.LA, ldb = w1 ? S.LQ : S.LDX;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        load_a_t(a, am, lda, m0, 16 * kk, lane);
        mma_pair_t(cw[j][0], cw[j][1], a, bm, ldb, n0, 16 * kk, lane);
      }
    }
    if (blockIdx.x == 0 && tid < D)
      for (int r = 0; r < 64; ++r) bsum += __bfloat162float(buf[S.o_g + r * S.LDX + tid]);
    __syncthreads();  // the buffer is free to be refilled
    if (!S.dbuf && st + 1 < steps) {
      load(st + 1, sm);
      cp_async_commit();
    }
  }

  // the block's partial sums, without the padding
  float* my = part + (size_t)blockIdx.y * (D * 3 * A + A * D + D);
#pragma unroll
  for (int j = 0; j < SUMS_TILES; ++j) {
    const int id = first + 8 * j;
    if (id >= ntiles) break;
    const bool w1 = id < n1;
    const int m0 = 16 * (w1 ? id / (QKV / 16) : (id - n1) / (DP / 16));
    const int n0 = 16 * (w1 ? id % (QKV / 16) : (id - n1) % (DP / 16));
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + g8 + 8 * (e >> 1), n = n0 + 8 * hf + 2 * t + (e & 1);
        if (w1) {  // m: channel, n: padded dqkv column
          const int pt = n / AP, h = (n % AP) / HPD, d = n % HPD;
          if (m < D && d < gm.hd) my[m * 3 * A + pt * A + h * gm.hd + d] = cw[j][hf][e];
        } else {   // m: padded attention-output column, n: channel
          const int h = m / HPD, d = m % HPD;
          if (n < D && d < gm.hd) my[D * 3 * A + (h * gm.hd + d) * D + n] = cw[j][hf][e];
        }
      }
  }
  if (blockIdx.x == 0 && tid < D) my[D * 3 * A + A * D + tid] = bsum;
}

// The three launches' shapes and the workspace's layout (in floats): the
// per-group partials, the token-sum partials, then dqkv [nwin·N][3AP] and
// the attention output [nwin·N][AP] as bf16.
struct GmmaLayout {
  int grid1, n1, g2, rpb, chunks;
  size_t off2, off3, off4, total;
};

template <int DM, int HPD>
int gmma_layout_t(const attn_mma::Plan& plan, int nwin, GmmaLayout* L) {
  static int cache[64][3] = {};
  const attn_mma::BwdPlan& P = plan.b;
  int grid = 0;
  const int err = tmar::persistent_grid(window_attention_bwd_gmma<DM, HPD>, P.bytes,
                                            P.threads, cache, &grid);
  if (err) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const attn_mma::Geom& gm = P.g;
  const int tiles = (nwin + P.G - 1) / P.G;
  L->grid1 = tiles < grid ? tiles : grid;
  L->n1 = L->grid1 * P.G;
  // token sums: chunks of the cotangent tiles, and row ranges of at least
  // 256 rows, about two blocks an SM in all
  const long rows = (long)nwin * gm.N;
  const int ntiles = (gm.DP / 16) * (3 * gm.AP / 16) + (gm.AP / 16) * (gm.DP / 16);
  L->chunks = (ntiles + 8 * attn_mma::SUMS_TILES - 1) / (8 * attn_mma::SUMS_TILES);
  int want = (int)((rows + 255) / 256);
  const int room = 2 * sms / L->chunks;
  want = want < room ? want : room;
  want = want < 1 ? 1 : want;
  L->rpb = (int)((rows + want - 1) / want + 63) / 64 * 64;
  L->g2 = (int)((rows + L->rpb - 1) / L->rpb);
  const size_t size1 = 3 * gm.A + gm.nh + (size_t)gm.nh * gm.N * gm.N;
  const size_t size2 = (size_t)gm.D * 3 * gm.A + (size_t)gm.A * gm.D + gm.D;
  L->off2 = round4((size_t)L->n1 * size1);
  L->off3 = round4(L->off2 + (size_t)L->g2 * size2);
  L->off4 = L->off3 + (size_t)rows * 3 * gm.AP / 2;
  L->total = L->off4 + (size_t)rows * gm.AP / 2;
  return 0;
}

int gmma_layout(const attn_mma::Plan& plan, int nwin, GmmaLayout* L) {
  const attn_mma::Geom& gm = plan.b.g;
  if (gm.HP == 16) {
    if (gm.DP <= 32) return gmma_layout_t<32, 16>(plan, nwin, L);
    if (gm.DP <= 64) return gmma_layout_t<64, 16>(plan, nwin, L);
    return gmma_layout_t<128, 16>(plan, nwin, L);
  }
  if (gm.DP <= 32) return gmma_layout_t<32, 32>(plan, nwin, L);
  if (gm.DP <= 64) return gmma_layout_t<64, 32>(plan, nwin, L);
  return gmma_layout_t<128, 32>(plan, nwin, L);
}

template <int DM, int HPD>
int launch_gmma_t(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* dx,
                  void* workspace, void* dparams, int nwin, int wh, int ww,
                  const attn_mma::Plan& plan, const GmmaLayout& L, cudaStream_t stream) {
  const attn_mma::BwdPlan& P = plan.b;
  const attn_mma::Geom& gm = P.g;
  float* ws = (float*)workspace;
  auto* dq = reinterpret_cast<__nv_bfloat16*>(ws + L.off3);
  auto* ac = reinterpret_cast<__nv_bfloat16*>(ws + L.off4);
  cudaError_t err;
  window_attention_bwd_gmma<DM, HPD><<<L.grid1, P.threads, P.bytes, stream>>>(
      (const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[1], (const float*)p[2], wq_k, wq_n,
      (const float*)p[3], (const float*)p[4], (const float*)p[5], (const float*)p[6], wp_k,
      wp_n, (const float*)p[7], (const float*)p[8], (const float*)p[9], (__nv_bfloat16*)dx, ws,
      dq, ac, nwin, wh, ww, P);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = cudaFuncSetAttribute(attention_param_sums_g,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)plan.s.bytes)) != cudaSuccess)
    return (int)err;
  attention_param_sums_g<<<dim3(L.chunks, L.g2), 256, plan.s.bytes, stream>>>(
      (const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[1], dq, ac, ws + L.off2,
      nwin * gm.N, L.rpb, gm, plan.s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int size1 = 3 * gm.A + gm.nh + gm.nh * gm.N * gm.N;
  const int size2 = gm.D * 3 * gm.A + gm.A * gm.D + gm.D;
  reduce_backward_partials<<<(size1 + size2 + 255) / 256, 256, 0, stream>>>(
      ws, L.n1, size1, ws + L.off2, L.g2, size2, gm.D * 3 * gm.A, (float*)dparams);
  return (int)cudaGetLastError();
}

// The tensor-core generic body on windows of N tokens (its plan must exist).
int launch_gmma(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* dx,
                void* workspace, void* dparams, int nwin, int N, int D, int nh, int hd, int wh,
                int ww, cudaStream_t s) {
  attn_mma::Plan plan;
  if (!attn_mma::plan(N, D, nh, hd, &plan)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)p[0] | (uintptr_t)p[1] | (uintptr_t)dx | (uintptr_t)workspace) & 15)
    return (int)cudaErrorMisalignedAddress;
  GmmaLayout L;
  const int err = gmma_layout(plan, nwin, &L);
  if (err) return err;
  const attn_mma::Geom& gm = plan.b.g;
  if (gm.HP == 16) {
    if (gm.DP <= 32)
      return launch_gmma_t<32, 16>(p, wq_k, wq_n, wp_k, wp_n, dx, workspace, dparams, nwin, wh, ww, plan, L, s);
    if (gm.DP <= 64)
      return launch_gmma_t<64, 16>(p, wq_k, wq_n, wp_k, wp_n, dx, workspace, dparams, nwin, wh, ww, plan, L, s);
    return launch_gmma_t<128, 16>(p, wq_k, wq_n, wp_k, wp_n, dx, workspace, dparams, nwin, wh, ww, plan, L, s);
  }
  if (gm.DP <= 32)
    return launch_gmma_t<32, 32>(p, wq_k, wq_n, wp_k, wp_n, dx, workspace, dparams, nwin, wh, ww, plan, L, s);
  if (gm.DP <= 64)
    return launch_gmma_t<64, 32>(p, wq_k, wq_n, wp_k, wp_n, dx, workspace, dparams, nwin, wh, ww, plan, L, s);
  return launch_gmma_t<128, 32>(p, wq_k, wq_n, wp_k, wp_n, dx, workspace, dparams, nwin, wh, ww, plan, L, s);
}

// ---- the bfloat16 tensor-core short-window body: 1 <= N <= 31 --------------
// (window_attention_generic_mma.cuh: the plan, the rule, the layout.)  Two
// launches: the per-tile kernel below, then window_attention_bwd_smma_reduce
// over its per-block slots in block order.  A block of W warps takes a tile of W
// units (a warp a unit, as in K3's short-window body); per tile:
//  1. per warp: q, k, v (mma.sync on x's A fragments and the bf16 wqkv)
//     and dacc = g·wprojᵀ (mma.sync on g's A fragments: both operands are
//     bf16 values, as _attn_bwd_kernel has them, :767, so the products are
//     exact); q_n, k_n, v, dacc, 1/|q|, 1/|k| and lse into the warp's
//     float32 slice; x and g into the tile's bf16 rows;
//  2. per warp, in float32 on the CUDA cores, a lane to a (row, head): as a
//     query o, delta, ds, the dscale share and dq_n; then as a key dk_n, dv
//     and the row's ds per (query, key) of its window; the L2-norm
//     backward; all into the tile's float32 dqkv and attention output;
//  3. per warp: dx = dqkv·wqkvᵀ on mma.sync, dqkv split into three bf16
//     parts (split3) against the exact bf16 wqkv (:802-805), bf16 rows out;
//  4. one block barrier, then the tile's shares of dwqkv = xᵀ·dqkv and
//     dwproj = oᵀ·g (:806-807, :794-796) on mma.sync with the float32
//     operand split in three, each 16x16 output tile owned by one warp, and
//     the sums of dbqkv, dbproj, dscale and dbias each owned by one thread,
//     rows and windows in order, into the block's float32 sums in shared
//     memory; a second barrier frees the tile.
// At the end each block writes its sums to its own slot.  No atomics: two
// runs give the same bits.  Bound: bytes (x, g, lse, dx; 0.00054 ms at the
// n = 2 step's 2048 windows); there a block takes one tile, so the launch
// is latency: staging, one tile's chain and its block-wide sums.  Why the split: each float32 cotangent product
// here has one exactly-bf16 operand (x, g, wqkv) and one float32 operand
// (dqkv, the attention output), and _attn_bwd_kernel takes them in
// float32; three bf16 parts carry the float32 operand to about 2^-24 of
// itself, so three mma.sync keep float32's accuracy (F32_TOL on the
// parameter cotangents) where one would round it to bf16.  The split was
// kept over a CUDA-core loop for these three products, which was not
// built or measured; the whole CUDA-core generic body is 3.9x slower at
// window 4 (PERF.md §6).
template <int HPD>
__global__ void __launch_bounds__(128) window_attention_bwd_smma(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ wqkv, int wq_k, int wq_n, const float* __restrict__ bqkv,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ wproj, int wp_k, int wp_n, const float* __restrict__ mrow,
    const float* __restrict__ mcol, const float* __restrict__ lse, __nv_bfloat16* __restrict__ dx,
    float* __restrict__ part, int nwin, int wh, int ww, attn_mma::ShortBwd P) {
  using namespace attn_mma;
  constexpr int CWD = HPD < 16 ? 16 : HPD, CT = CWD / 8, HC = CWD / HPD;
  extern __shared__ float4 smem4[];
  float* sf = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(sf + P.floats);
  __nv_bfloat16* sx = sw + P.b_x;  // the tile's x [BR][LX]
  __nv_bfloat16* sg = sw + P.b_g;  // ... and g
  const Short& S = P.s;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int N = S.N, D = S.D, nh = S.nh, APP = S.APP, W = P.W, R = S.R;
  const int LQ = P.LQ, LA = P.LA, LX = P.LX, LD3 = P.LD3, LDO = P.LDO, ST = 4 * nh;
  const int NN = nh * N * N;

  // ---- once per block: zeros (sums, padding), the float32 parameters, the
  // bf16 weights
  for (int i = tid; i < P.f_dq / 4; i += nthreads)
    reinterpret_cast<float4*>(sf)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < P.belems / 8; i += nthreads)
    reinterpret_cast<uint4*>(sw)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  stage_short({sw, sf + P.f_bqkv, nullptr, sf + P.f_scale, sf + P.f_bias, sf + P.f_mask}, S,
              sf + P.f_dq, wqkv, wq_k, wq_n, wproj, wp_k, wp_n, bqkv, nullptr, scale, bias, mrow,
              mcol, wh, tid, nthreads);
  // the tile's regions held the raw parameters: zeros (the padded columns
  // of dqkv and of the attention output stay zero)
  for (int i = P.f_dq / 4 + tid; i < P.floats / 4; i += nthreads)
    reinterpret_cast<float4*>(sf)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const float* sb = sf + P.f_bias;   // bias [nh][N][N]
  const float* smr = sf + P.f_mask;  // mask rows [N][N]
  const float* smc = smr + N * N;    // ... columns

  const int warp = tid >> 5, lane = tid & 31, lg = lane >> 2, t = lane & 3;
  float* sdq = sf + P.f_dq;    // the tile's dqkv [BR][LD3]
  float* so = sf + P.f_o;      // ... attention output [BR][LDO]
  float* sdsc = sf + P.f_dsc;  // ... dscale shares [BR][nh]
  float* sdsb = sf + P.f_dsb;  // ... ds per window [W·WPU][nh·N·N]
  float* wq = sf + P.f_warp + warp * P.warp_floats;  // q_n | k_n | v [R][LQ]
  float* wa = wq + P.w_dacc;                           // dacc [R][LA]
  float* wst = wq + P.w_stat;  // [R][4nh]: 1/|q|, 1/|k|, lse, delta by head
  const long total = (long)nwin * N;
  const int units = (nwin + S.WPU - 1) / S.WPU, tiles = (units + W - 1) / W;
  const int br0 = warp * R;  // the warp's first row in the tile
  // the lane's row of a unit, its window and its position there (fixed for
  // the kernel), and its first head: a lane to a (row, head), 32 / R heads
  // at a time
  const int r = lane & (R - 1), h0 = lane / R, hstep = 32 / R;
  const int w = r / N, rw = r - w * N;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int u = tile * W + warp;
    const long row0 = (long)u * S.RU;

    // 1. x and g into the tile by cp.async; q_n, k_n, v and dacc of the
    // unit's rows
    {
      const int rows = row0 >= total ? 0 : (int)(total - row0 < S.RU ? total - row0 : S.RU);
      load_rows(sx + br0 * LX, LX, x, row0, rows, S, lane);
      load_rows(sg + br0 * LX, LX, g, row0, rows, S, lane);
    }
    for (int f = 0; f < S.F; ++f) {
      const int ra = 16 * f + lg, rb = ra + 8;
      for (int c0 = 0; c0 < APP; c0 += CWD) {
        float acc[3][CT][4], inv[2][HC][2];
        short_qkv<HPD, CWD>(acc, inv, sx + br0 * LX, LX, 16 * f, sw, S, sf + P.f_bqkv, c0, lane);
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int j = 0; j < CT; ++j) store_tile_f32(wq, LQ, ra, p * APP + c0 + 8 * j + 2 * t, acc[p][j]);
        if (t == 0)
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int hh = 0; hh < HC; ++hh) {
              const int h = c0 / HPD + hh;
              if (h < nh) {
                wst[ra * ST + p * nh + h] = inv[p][hh][0];
                wst[rb * ST + p * nh + h] = inv[p][hh][1];
              }
            }
        // dacc = g · wprojᵀ over the chunk's columns (wproj kept [a][d])
        float da[CT][4];
#pragma unroll
        for (int j = 0; j < CT; ++j) da[j][0] = da[j][1] = da[j][2] = da[j][3] = 0.f;
        for (int kk = 0; kk < S.dk; ++kk) {
          uint32_t ga[4];
          load_a(ga, sg + br0 * LX, LX, 16 * f, 16 * kk, lane);
#pragma unroll
          for (int n2 = 0; n2 < CT / 2; ++n2)
            mma_pair(da[2 * n2], da[2 * n2 + 1], ga, sw + S.w_proj, S.LPW, c0 + 16 * n2, 16 * kk,
                     lane);
        }
#pragma unroll
        for (int j = 0; j < CT; ++j) store_tile_f32(wa, LA, ra, c0 + 8 * j + 2 * t, da[j]);
      }
    }
    const long win = (long)u * S.WPU + w;
    const bool real = r < S.RU && win < nwin;
    bool gr, gc;
    mask_gates(real ? (int)win : 0, wh, ww, gr, gc);
#pragma unroll 1
    for (int h = h0; h < nh; h += hstep)  // lse (each load's latency overlaps the next)
      wst[r * ST + 2 * nh + h] = real ? __ldg(lse + ((size_t)win * nh + h) * N + rw) : 0.f;
    __syncwarp();

    // 2a. a lane to a (query row, head): o, delta, ds, the dscale share, dq_n
#pragma unroll 1
    for (int h = h0; h < nh; h += hstep) {
      const int i = rw;
      float o[HPD], dq[HPD];
#pragma unroll
      for (int d = 0; d < HPD; ++d) o[d] = dq[d] = 0.f;
      float delta = 0.f, dsc = 0.f;
      if (real) {
        float q[HPD], da[HPD];
#pragma unroll
        for (int d = 0; d < HPD; ++d) q[d] = wq[r * LQ + h * HPD + d], da[d] = wa[r * LA + h * HPD + d];
        const float* kb = wq + (w * N) * LQ + APP + h * HPD;  // k_n of the window's key 0
        const float sc = sf[P.f_scale + h], l = wst[r * ST + 2 * nh + h];
        const float* bi = sb + (h * N + i) * N;
        // (cos, p, dp) of key j
        auto key = [&](int j, float& cs, float& p, float& dp) {
          const float* kj = kb + j * LQ;
          const float* vj = kj + APP;
          cs = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < HPD; ++d) cs = fmaf(q[d], kj[d], cs), dp = fmaf(da[d], vj[d], dp);
          float sv = cs * sc + bi[j];
          if (gr) sv += smr[i * N + j];
          if (gc) sv += smc[i * N + j];
          p = expf(sv - l);
        };
#pragma unroll 4
        for (int j = 0; j < N; ++j) {
          float cs, p, dp;
          key(j, cs, p, dp);
          const float* vj = kb + j * LQ + APP;
#pragma unroll
          for (int d = 0; d < HPD; ++d) o[d] = fmaf(p, vj[d], o[d]);
          delta = fmaf(dp, p, delta);
        }
#pragma unroll 4
        for (int j = 0; j < N; ++j) {
          float cs, p, dp;
          key(j, cs, p, dp);
          const float ds = p * (dp - delta);
          dsc = fmaf(ds, cs, dsc);
          const float dc = ds * sc;
          const float* kj = kb + j * LQ;
#pragma unroll
          for (int d = 0; d < HPD; ++d) dq[d] = fmaf(dc, kj[d], dq[d]);
        }
      }
      float* orow = so + (br0 + r) * LDO + h * HPD;
      float* qrow = sdq + (br0 + r) * LD3 + h * HPD;
#pragma unroll
      for (int d = 0; d < HPD; ++d) orow[d] = o[d], qrow[d] = dq[d];
      wst[r * ST + 3 * nh + h] = delta;
      sdsc[(br0 + r) * nh + h] = dsc;
    }
    __syncwarp();

    // 2b. a lane to a (key row, head): dk_n, dv, ds of its window's queries
#pragma unroll 1
    for (int h = h0; h < nh; h += hstep) {
      const int j = rw;
      float dk[HPD], dv[HPD];
#pragma unroll
      for (int d = 0; d < HPD; ++d) dk[d] = dv[d] = 0.f;
      if (real) {
        float k[HPD], v[HPD];
#pragma unroll
        for (int d = 0; d < HPD; ++d)
          k[d] = wq[r * LQ + APP + h * HPD + d], v[d] = wq[r * LQ + 2 * APP + h * HPD + d];
        const float sc = sf[P.f_scale + h];
        float* dsw = sdsb + (size_t)(warp * S.WPU + w) * NN + (size_t)h * N * N + j;
#pragma unroll 4
        for (int i = 0; i < N; ++i) {
          const int ri = w * N + i;
          const float* qi = wq + ri * LQ + h * HPD;
          const float* di = wa + ri * LA + h * HPD;
          float cs = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < HPD; ++d) cs = fmaf(qi[d], k[d], cs), dp = fmaf(di[d], v[d], dp);
          float sv = cs * sc + sb[(h * N + i) * N + j];
          if (gr) sv += smr[i * N + j];
          if (gc) sv += smc[i * N + j];
          const float p = expf(sv - wst[ri * ST + 2 * nh + h]);
          const float ds = p * (dp - wst[ri * ST + 3 * nh + h]);
          const float dc = ds * sc;
#pragma unroll
          for (int d = 0; d < HPD; ++d) dv[d] = fmaf(p, di[d], dv[d]), dk[d] = fmaf(dc, qi[d], dk[d]);
          dsw[i * N] = ds;
        }
      }
      float* krow = sdq + (br0 + r) * LD3 + APP + h * HPD;
#pragma unroll
      for (int d = 0; d < HPD; ++d) krow[d] = dk[d], krow[APP + d] = dv[d];
    }
    __syncwarp();

    // 2c. the L2-norm backward in place: dt = inv·(dt_n - t_n (dt_n · t_n))
#pragma unroll 1
    for (int ph = h0; ph < 2 * nh; ph += hstep) {
      const int p = ph >= nh, h = ph - p * nh;
      float* dt = sdq + (br0 + r) * LD3 + p * APP + h * HPD;
      const float* tn = wq + r * LQ + p * APP + h * HPD;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HPD; ++d) dot = fmaf(dt[d], tn[d], dot);
      const float inv = wst[r * ST + p * nh + h];
#pragma unroll
      for (int d = 0; d < HPD; ++d) dt[d] = inv * (dt[d] - tn[d] * dot);
    }
    __syncwarp();

    // 3. dx = dqkv · wqkvᵀ, dqkv in three bf16 parts; bf16 rows out, 16
    // columns at a time
    for (int f = 0; f < S.F; ++f) {
      const int ra = 16 * f + lg, rb = ra + 8;
      const bool va = ra < S.RU && row0 + ra < total, vb = rb < S.RU && row0 + rb < total;
      for (int n2 = 0; n2 < S.dk; ++n2) {
        // (the three parts' products in accumulators of their own, added
        // at the end: three independent mma chains)
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float am[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float al[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int kk = 0; kk < 3 * APP / 16; ++kk) {
          const float* ar = sdq + (br0 + ra) * LD3 + 16 * kk + 2 * t;
          uint32_t hi[4], mid[4], lo[4], b[4];
          split3(ar[0], ar[1], hi[0], mid[0], lo[0]);
          split3(ar[8 * LD3], ar[8 * LD3 + 1], hi[1], mid[1], lo[1]);
          split3(ar[8], ar[9], hi[2], mid[2], lo[2]);
          split3(ar[8 * LD3 + 8], ar[8 * LD3 + 9], hi[3], mid[3], lo[3]);
          ldmatrix_x4(b, sw + (16 * n2 + 8 * (lane >> 4) + (lane & 7)) * S.LQW + 16 * kk +
                             8 * ((lane >> 3) & 1));
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma_bf16(al[j], lo, b[2 * j], b[2 * j + 1]);
            mma_bf16(am[j], mid, b[2 * j], b[2 * j + 1]);
            mma_bf16(acc[j], hi, b[2 * j], b[2 * j + 1]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][q] += am[j][q] + al[j][q];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 16 * n2 + 8 * j + 2 * t;
          if (c >= D) break;
          if (va) sts32(dx + (row0 + ra) * D + c, pack_bf16(acc[j][0], acc[j][1]));
          if (vb) sts32(dx + (row0 + rb) * D + c, pack_bf16(acc[j][2], acc[j][3]));
        }
      }
    }
    __syncthreads();

    // 4. the tile's shares of the parameter cotangents, each output element
    // owned by one warp (the products) or one thread (the sums)
    const int KS = P.BR / 16, C3 = 3 * APP;
    // dwqkv [DP][3·APP] += xᵀ · dqkv, dqkv in three parts: a warp's 16x16
    // output tiles four at a time, their k-steps interleaved
    {
      const int J = (S.DP / 16) * (C3 / 16);
      for (int j0 = warp; j0 < J; j0 += 4 * W) {
        float c[4][2][4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) c[b][nt][0] = c[b][nt][1] = c[b][nt][2] = c[b][nt][3] = 0.f;
        // (a job past J repeats the last one, and is not added below: no
        // branch in the loop, so the four tiles' products interleave)
        int m0s[4], n0s[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int job = j0 + b * W < J ? j0 + b * W : J - 1;
          m0s[b] = job / (C3 / 16) * 16, n0s[b] = job % (C3 / 16) * 16;
        }
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int m0 = m0s[b], n0 = n0s[b];
            uint32_t a[4];
            load_a_t(a, sx, LX, m0, 16 * ks, lane);
            const float* br = sdq + (16 * ks + 2 * t) * LD3 + n0 + lg;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              uint32_t h0, m0b, l0, h1, m1b, l1;
              split3(br[8 * nt], br[LD3 + 8 * nt], h0, m0b, l0);
              split3(br[8 * LD3 + 8 * nt], br[9 * LD3 + 8 * nt], h1, m1b, l1);
              mma_bf16(c[b][nt], a, l0, l1);
              mma_bf16(c[b][nt], a, m0b, m1b);
              mma_bf16(c[b][nt], a, h0, h1);
            }
          }
        float* acc = sf + P.a_w;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (j0 + b * W >= J) break;
          const int m0 = m0s[b], n0 = n0s[b];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float* at = acc + (m0 + lg) * C3 + n0 + 8 * nt + 2 * t;
            at[0] += c[b][nt][0], at[1] += c[b][nt][1];
            at[8 * C3] += c[b][nt][2], at[8 * C3 + 1] += c[b][nt][3];
          }
        }
      }
    }
    // dwproj [APP][DP] += oᵀ · g, o in three parts, four tiles at a time
    {
      const int J = (APP / 16) * (S.DP / 16);
      for (int j0 = warp; j0 < J; j0 += 4 * W) {
        float c[4][2][4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) c[b][nt][0] = c[b][nt][1] = c[b][nt][2] = c[b][nt][3] = 0.f;
        int m0s[4], n0s[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int job = j0 + b * W < J ? j0 + b * W : J - 1;
          m0s[b] = job / (S.DP / 16) * 16, n0s[b] = job % (S.DP / 16) * 16;
        }
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int m0 = m0s[b], n0 = n0s[b];
            const float* orow = so + (16 * ks + 2 * t) * LDO + m0 + lg;
            uint32_t hi[4], mid[4], lo[4], bb[4];
            split3(orow[0], orow[LDO], hi[0], mid[0], lo[0]);
            split3(orow[8], orow[LDO + 8], hi[1], mid[1], lo[1]);
            split3(orow[8 * LDO], orow[9 * LDO], hi[2], mid[2], lo[2]);
            split3(orow[8 * LDO + 8], orow[9 * LDO + 8], hi[3], mid[3], lo[3]);
            ldmatrix_x4_trans(bb, sg + (16 * ks + 8 * ((lane >> 3) & 1) + (lane & 7)) * LX + n0 +
                                      8 * (lane >> 4));
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              mma_bf16(c[b][nt], lo, bb[2 * nt], bb[2 * nt + 1]);
              mma_bf16(c[b][nt], mid, bb[2 * nt], bb[2 * nt + 1]);
              mma_bf16(c[b][nt], hi, bb[2 * nt], bb[2 * nt + 1]);
            }
          }
        float* acc = sf + P.a_p;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (j0 + b * W >= J) break;
          const int m0 = m0s[b], n0 = n0s[b];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float* at = acc + (m0 + lg) * S.DP + n0 + 8 * nt + 2 * t;
            at[0] += c[b][nt][0], at[1] += c[b][nt][1];
            at[8 * S.DP] += c[b][nt][2], at[8 * S.DP + 1] += c[b][nt][3];
          }
        }
      }
    }
    // (four partial sums over rows r mod 4, added in that order: the
    // tile's BR rows are a multiple of 16)
    auto rows_sum = [&](auto at) {
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
      for (int r = 0; r < P.BR; r += 4)
#pragma unroll
        for (int q = 0; q < 4; ++q) s4[q] += at(r + q);
      return (s4[0] + s4[1]) + (s4[2] + s4[3]);
    };
    for (int n = tid; n < C3; n += nthreads)
      sf[P.a_bq + n] += rows_sum([&](int r) { return sdq[r * LD3 + n]; });
    for (int c = tid; c < D; c += nthreads)
      sf[P.a_bp + c] += rows_sum([&](int r) { return __bfloat162float(sg[r * LX + c]); });
    for (int h = tid; h < nh; h += nthreads)
      sf[P.a_sc + h] += rows_sum([&](int r) { return sdsc[r * nh + h]; });
    {
      const long win0 = (long)tile * W * S.WPU;
      const int nw = (int)(nwin - win0 < W * S.WPU ? nwin - win0 : W * S.WPU);
      for (int e = tid; e < NN; e += nthreads) {
        float sum = 0.f;
        for (int wl = 0; wl < nw; ++wl) sum += sdsb[(size_t)wl * NN + e];
        sf[P.a_bi + e] += sum;
      }
    }
    __syncthreads();
  }

  // the block's slot: [dwqkv D x 3A | dbqkv 3A | dscale nh | dbias | dwproj A x D | dbproj D]
  // (a thread a column of dwqkv and a row of dwproj: no division per value)
  const int A = S.A, A3 = 3 * A, hd = S.hd;
  float* my = part + (size_t)blockIdx.x * ((size_t)D * A3 + A3 + nh + NN + (size_t)A * D + D);
  float* m2 = my + (size_t)D * A3;
  float* m3 = m2 + A3 + nh + NN;
#pragma unroll 1
  for (int n = tid; n < A3; n += nthreads) {
    const int part = n / A, h = (n - part * A) / hd, col = part * APP + h * S.HP + n - part * A - h * hd;
#pragma unroll 4
    for (int k = 0; k < D; ++k) my[(size_t)k * A3 + n] = sf[P.a_w + k * 3 * APP + col];
    m2[n] = sf[P.a_bq + col];
  }
  for (int h = tid; h < nh; h += nthreads) m2[A3 + h] = sf[P.a_sc + h];
  for (int e = tid; e < NN; e += nthreads) m2[A3 + nh + e] = sf[P.a_bi + e];
#pragma unroll 1
  for (int a = tid; a < A; a += nthreads) {
    const float* row = sf + P.a_p + (a / hd * S.HP + a % hd) * S.DP;
#pragma unroll 4
    for (int c = 0; c < D; ++c) m3[(size_t)a * D + c] = row[c];
  }
  for (int c = tid; c < D; c += nthreads) m3[A * D + c] = sf[P.a_bp + c];
}

// The grid of the short-window body's per-tile launch (persistent blocks,
// at most one a tile).
template <int HPD>
int short_grid_t(const attn_mma::ShortBwd& P, int nwin, int* grid) {
  static int cache[64][3] = {};
  const int err = tmar::persistent_grid(window_attention_bwd_smma<HPD>, P.bytes, P.threads,
                                        cache, grid);
  if (err) return err;
  const int units = (nwin + P.s.WPU - 1) / P.s.WPU, tiles = (units + P.W - 1) / P.W;
  *grid = tiles < *grid ? tiles : *grid;
  return 0;
}

int short_grid(const attn_mma::ShortBwd& P, int nwin, int* grid) {
#define TMAR_SGRID(HPV) \
  if (P.s.HP == HPV) return short_grid_t<HPV>(P, nwin, grid);
  TMAR_SHORT_WIDTHS(TMAR_SGRID)
#undef TMAR_SGRID
  return (int)cudaErrorInvalidValue;
}

// The sum of the per-block slots in block order (reduce_partials under a
// name of its own, so that a profile tells K4's short-window launches
// apart).
// A block of 256 threads takes 32 outputs: thread (q, o) sums the slots b
// with b mod 8 = q in order, eight loads in flight, and thread (0, o) adds
// the eight partial sums in order of q, so that the order is fixed and no
// thread waits on one load per slot.
__global__ void __launch_bounds__(256) window_attention_bwd_smma_reduce(
    const float* __restrict__ part, float* __restrict__ out, int nblocks, int size) {
  __shared__ float red[8][33];
  const int o = threadIdx.x & 31, q = threadIdx.x >> 5, e = blockIdx.x * 32 + o;
  float s = 0.f;
  if (e < size)
    for (int b0 = q; b0 < nblocks; b0 += 64) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int b = b0 + 8 * k;
        v[k] = b < nblocks ? __ldg(part + (size_t)b * size + e) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) s += v[k];
    }
  red[q][o] = s;
  __syncthreads();
  if (q == 0 && e < size) {
    float t = red[0][o];
#pragma unroll
    for (int k = 1; k < 8; ++k) t += red[k][o];
    out[e] = t;
  }
}

// one block's slot of sums, in floats
long long short_slot(const attn_mma::Short& s) {
  const long long A = s.A, NN = (long long)s.nh * s.N * s.N;
  return (long long)s.D * 3 * A + 3 * A + s.nh + NN + A * s.D + s.D;
}

template <int HPD>
int launch_smma_t(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* dx,
                  void* workspace, void* dparams, int nwin, int wh, int ww,
                  const attn_mma::ShortBwd& P, int grid, cudaStream_t stream) {
  window_attention_bwd_smma<HPD><<<grid, P.threads, P.bytes, stream>>>(
      (const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[1], (const float*)p[2], wq_k, wq_n,
      (const float*)p[3], (const float*)p[4], (const float*)p[5], (const float*)p[6], wp_k,
      wp_n, (const float*)p[7], (const float*)p[8], (const float*)p[9], (__nv_bfloat16*)dx,
      (float*)workspace, nwin, wh, ww, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int size = (int)short_slot(P.s);
  window_attention_bwd_smma_reduce<<<(size + 31) / 32, 256, 0, stream>>>(
      (const float*)workspace, (float*)dparams, grid, size);
  return (int)cudaGetLastError();
}

// The short-window body on windows of N tokens (its plan must exist); the
// workspace holds short_workspace floats.
int launch_smma(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* dx,
                void* workspace, void* dparams, int nwin, int N, int D, int nh, int hd, int wh,
                int ww, cudaStream_t s) {
  attn_mma::ShortFwd F_;
  attn_mma::ShortBwd P;
  if (!attn_mma::short_plan(N, D, nh, hd, &F_, &P)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)p[0] | (uintptr_t)p[1] | (uintptr_t)dx | (uintptr_t)workspace) & 15)
    return (int)cudaErrorMisalignedAddress;
  int grid = 0;
  const int err = short_grid(P, nwin, &grid);
  if (err) return err;
#define TMAR_SMMA(HPV)                                                                       \
  if (P.s.HP == HPV)                                                                         \
    return launch_smma_t<HPV>(p, wq_k, wq_n, wp_k, wp_n, dx, workspace, dparams, nwin, wh, ww, \
                              P, grid, s);
  TMAR_SHORT_WIDTHS(TMAR_SMMA)
#undef TMAR_SMMA
  return (int)cudaErrorInvalidValue;
}

// The short-window body's workspace in floats: one slot of sums a block
// (-1 without a plan).
long long short_workspace(int nwin, int N, int D, int nh, int hd) {
  attn_mma::ShortFwd F_;
  attn_mma::ShortBwd P;
  int grid = 0;
  if (!attn_mma::short_plan(N, D, nh, hd, &F_, &P) || short_grid(P, nwin, &grid)) return -1;
  return (long long)grid * short_slot(P.s);
}

template <typename T>
int launch_generic(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* dx,
                   void* part, void* dparams, int nwin, int N, int D, int nh, int hd, int hg,
                   int wh, int ww, int blocks, cudaStream_t s) {
  if (hd <= 8)
    return launch_rt<8, T>(p, wq_k, wq_n, wp_k, wp_n, dx, part, dparams, nwin, N, D, nh, hd, hg,
                           wh, ww, blocks, s);
  if (hd <= 16)
    return launch_rt<16, T>(p, wq_k, wq_n, wp_k, wp_n, dx, part, dparams, nwin, N, D, nh, hd, hg,
                            wh, ww, blocks, s);
  return launch_rt<32, T>(p, wq_k, wq_n, wp_k, wp_n, dx, part, dparams, nwin, N, D, nh, hd, hg,
                          wh, ww, blocks, s);
}

}  // namespace

extern "C" {

// The float32 workspace the backward needs for these arguments (the
// per-block partial sums, and for the tensor-core body also its bf16 dqkv
// and attention-output tiles), in floats; -1 for arguments it does not take.
long long tmar_window_attention_bwd_workspace(int nwin, int N, int D, int num_heads,
                                              int head_dim, int blocks, int is_bf16) {
  if (nwin < 1 || blocks < 1 || N < 1 || N > ROWS || D < 1 || num_heads < 1 || head_dim < 1 ||
      head_dim > 32)
    return -1;
  const attn_mma::Body body = attn_mma::body(N, D, num_heads, head_dim, is_bf16);
  if (body == attn_mma::FLAGSHIP)
    return num_heads == 6 ? (long long)BwdPlan<6, 10>(nwin, blocks).total
                          : (long long)BwdPlan<4, 16>(nwin, blocks).total;
  if (body == attn_mma::TENSOR_CORE) {
    attn_mma::Plan plan;
    GmmaLayout L;
    if (!attn_mma::plan(N, D, num_heads, head_dim, &plan) || gmma_layout(plan, nwin, &L))
      return -1;
    return (long long)L.total;
  }
  if (body == attn_mma::SHORT) return short_workspace(nwin, N, D, num_heads, head_dim);
#define TMAR_WS(NN, DD, NH, HD)                                                       \
  if (N == NN && D == DD && num_heads == NH && head_dim == HD)                         \
    return (long long)blocks * Geo<NN, DD, NH, HD>::PSIZE;
  if (!is_bf16) {
    TMAR_ATTN_WINDOW_GEOMETRIES(TMAR_WS)
  }
  TMAR_ATTN_NGRAM_GEOMETRIES(TMAR_WS)
#undef TMAR_WS
  return generic_workspace(N, D, num_heads, head_dim, blocks);
}

// x, g [nwin, N, D] (float32 or bfloat16, per is_bf16) and lse [nwin, nh, N]
// from the forward -> dx of x's shape and type, and dparams, float32, the
// concatenation of dwqkv [D, 3A], dbqkv [3A], dscale [nh], dbias [nh, N, N],
// dwproj [A, D], dbproj [D].  `workspace` holds the floats that
// tmar_window_attention_bwd_workspace gives for the same arguments, 16-byte
// aligned.  The other arguments are the forward's, `body` too (another
// than the rule's is refused): the flagship and tensor-core generic bodies
// size their own launches, the others take hg heads at a time on `blocks`
// persistent blocks.  Returns a cudaError_t code.
int tmar_window_attention_bwd(const void* x, const void* g, const void* wqkv,
                              const void* bqkv, const void* scale, const void* bias,
                              const void* wproj, const void* mrow, const void* mcol,
                              const void* lse, void* dx, void* workspace, void* dparams,
                              int nwin, int N, int D, int num_heads, int head_dim, int hg,
                              int wq_k, int wq_n, int wp_k, int wp_n, int wh, int ww, int blocks,
                              int is_bf16, int body, void* stream) {
  if (nwin < 1 || blocks < 1 || N < 1 || N > ROWS || D < 1 || num_heads < 1 ||
      head_dim < 1 || head_dim > 32 || hg < 1 || (wh > 0 && (ww < 1 || nwin % (wh * ww))) ||
      body != attn_mma::body(N, D, num_heads, head_dim, is_bf16))
    return (int)cudaErrorInvalidValue;
  const void* p[10] = {x, g, wqkv, bqkv, scale, bias, wproj, mrow, mcol, lse};
  cudaStream_t s = (cudaStream_t)stream;
  if (body == attn_mma::TENSOR_CORE)
    return launch_gmma(p, wq_k, wq_n, wp_k, wp_n, dx, workspace, dparams, nwin, N, D, num_heads,
                       head_dim, wh, ww, s);
  if (body == attn_mma::SHORT)
    return launch_smma(p, wq_k, wq_n, wp_k, wp_n, dx, workspace, dparams, nwin, N, D, num_heads,
                       head_dim, wh, ww, s);
  if (body == attn_mma::FLAGSHIP)
    return num_heads == 6
               ? launch_mma<6, 10>(p, wq_k, wq_n, wp_k, wp_n, dx, workspace, dparams, nwin, wh,
                                   ww, blocks, s)
               : launch_mma<4, 16>(p, wq_k, wq_n, wp_k, wp_n, dx, workspace, dparams, nwin, wh,
                                   ww, blocks, s);
  // the templated body at the full-width NGswin's other geometries: its
  // float32 windows, and its n-gram windows at both dtypes
#define TMAR_CASE(NN, DD, NH, HD, T)                                                   \
  if (N == NN && D == DD && num_heads == NH && head_dim == HD)                         \
    return launch<NN, DD, NH, HD, T>(p, wq_k, wq_n, wp_k, wp_n, dx, workspace, dparams, nwin, \
                                     wh, ww, blocks, s);
#define TMAR_F32(NN, DD, NH, HD) TMAR_CASE(NN, DD, NH, HD, float)
#define TMAR_BF16(NN, DD, NH, HD) TMAR_CASE(NN, DD, NH, HD, __nv_bfloat16)
  if (is_bf16) {
    TMAR_ATTN_NGRAM_GEOMETRIES(TMAR_BF16)
    return launch_generic<__nv_bfloat16>(p, wq_k, wq_n, wp_k, wp_n, dx, workspace, dparams,
                                         nwin, N, D, num_heads, head_dim, hg, wh, ww, blocks, s);
  }
  TMAR_ATTN_WINDOW_GEOMETRIES(TMAR_F32)
  TMAR_ATTN_NGRAM_GEOMETRIES(TMAR_F32)
#undef TMAR_CASE
#undef TMAR_F32
#undef TMAR_BF16
  return launch_generic<float>(p, wq_k, wq_n, wp_k, wp_n, dx, workspace, dparams, nwin, N, D,
                               num_heads, head_dim, hg, wh, ww, blocks, s);
}

// The shared memory, in bytes, of the generic body's launch with hg heads
// to a group.
long long tmar_window_attention_bwd_smem(int N, int D, int head_dim, int hg) {
  return (long long)rt_bytes(N, D, head_dim, hg);
}

// The tensor-core generic body at any bfloat16 geometry it has a plan for,
// the flagship's too, with tmar_window_attention_bwd's arguments (hg,
// blocks and body unread) and a workspace of
// tmar_window_attention_bwd_gmma_workspace floats: chip_smoke.py's
// flagship-geometry line, never a dispatch.
int tmar_window_attention_bwd_gmma(const void* x, const void* g, const void* wqkv,
                                   const void* bqkv, const void* scale, const void* bias,
                                   const void* wproj, const void* mrow, const void* mcol,
                                   const void* lse, void* dx, void* workspace, void* dparams,
                                   int nwin, int N, int D, int num_heads, int head_dim, int hg,
                                   int wq_k, int wq_n, int wp_k, int wp_n, int wh, int ww,
                                   int blocks, int is_bf16, int body, void* stream) {
  (void)hg, (void)blocks, (void)body;
  if (!is_bf16 || nwin < 1 || (wh > 0 && (ww < 1 || nwin % (wh * ww))))
    return (int)cudaErrorInvalidValue;
  const void* p[10] = {x, g, wqkv, bqkv, scale, bias, wproj, mrow, mcol, lse};
  return launch_gmma(p, wq_k, wq_n, wp_k, wp_n, dx, workspace, dparams, nwin, N, D, num_heads,
                     head_dim, wh, ww, (cudaStream_t)stream);
}

long long tmar_window_attention_bwd_gmma_workspace(int nwin, int N, int D, int num_heads,
                                                   int head_dim) {
  attn_mma::Plan plan;
  GmmaLayout L;
  if (nwin < 1 || !attn_mma::plan(N, D, num_heads, head_dim, &plan) || gmma_layout(plan, nwin, &L))
    return -1;
  return (long long)L.total;
}

// The shared memory, in bytes, of the tensor-core generic body's launch
// `which` (1: per window, 2: the token sums) for windows of N tokens (-1
// where it has no plan).
long long tmar_window_attention_bwd_mma_smem(int N, int D, int num_heads, int head_dim,
                                             int which) {
  attn_mma::Plan P;
  if (!attn_mma::plan(N, D, num_heads, head_dim, &P)) return -1;
  return which == 1 ? (long long)P.b.bytes : (long long)P.s.bytes;
}

// The short-window body at any bfloat16 geometry it has a plan for (the
// full-width NGswin's n-gram windows too, which the templated body runs),
// with tmar_window_attention_bwd's arguments (hg, blocks and body unread)
// and a workspace of tmar_window_attention_bwd_smma_workspace floats:
// chip_smoke.py's and the GPU tests' check of it there, never a dispatch.
int tmar_window_attention_bwd_smma(const void* x, const void* g, const void* wqkv,
                                   const void* bqkv, const void* scale, const void* bias,
                                   const void* wproj, const void* mrow, const void* mcol,
                                   const void* lse, void* dx, void* workspace, void* dparams,
                                   int nwin, int N, int D, int num_heads, int head_dim, int hg,
                                   int wq_k, int wq_n, int wp_k, int wp_n, int wh, int ww,
                                   int blocks, int is_bf16, int body, void* stream) {
  (void)hg, (void)blocks, (void)body;
  if (!is_bf16 || nwin < 1 || (wh > 0 && (ww < 1 || nwin % (wh * ww))))
    return (int)cudaErrorInvalidValue;
  const void* p[10] = {x, g, wqkv, bqkv, scale, bias, wproj, mrow, mcol, lse};
  return launch_smma(p, wq_k, wq_n, wp_k, wp_n, dx, workspace, dparams, nwin, N, D, num_heads,
                     head_dim, wh, ww, (cudaStream_t)stream);
}

long long tmar_window_attention_bwd_smma_workspace(int nwin, int N, int D, int num_heads,
                                                   int head_dim) {
  return nwin < 1 ? -1 : short_workspace(nwin, N, D, num_heads, head_dim);
}

// The shared memory, in bytes, of the short-window body's per-tile launch
// for windows of N tokens (-1 where it has no plan).
long long tmar_window_attention_bwd_short_smem(int N, int D, int num_heads, int head_dim) {
  attn_mma::ShortFwd f;
  attn_mma::ShortBwd b;
  return attn_mma::short_plan(N, D, num_heads, head_dim, &f, &b) ? (long long)b.bytes : -1;
}

// The body this source runs for the geometry and I/O type (attn_mma::Body).
int tmar_window_attention_bwd_body(int N, int D, int num_heads, int head_dim, int is_bf16) {
  return (int)attn_mma::body(N, D, num_heads, head_dim, is_bf16);
}

const char* tmar_window_attention_bwd_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
