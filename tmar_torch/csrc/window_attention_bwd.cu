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
// Two bodies, chosen by the I/O type and the window length, as the forward's
// (window_attention_fwd.cu):
// * bfloat16 at N = 64: the tensor-core body below, rounding as
//   _attn_bwd_kernel_batched does with cot_bf16 on (the JAX default for
//   bf16 inputs, :474-477): the recompute's products take bf16 operands
//   (:629-642), and so does every cotangent product: g, wp_h, dacc, v, P,
//   dcos, k_n, q_n, the attention output, dqkv, x and wqkv (:645-697).  ds,
//   delta (from the bf16-operand dp, :658), the softmax statistics, the
//   L2-norm backward and the sums into dbias, dscale, dbqkv and dbproj stay
//   float32.
// * float32 at every length, and bfloat16 at N = 1, 4, 9: the float32 body,
//   which at bfloat16 rounds where _attn_bwd_kernel rounds: the two matrices
//   (:728, :767, :802-807); everything else is float32 there.
//
// What bounds it on an H100: operations, about three times the forward's.
// Float32 body: the forward's tiling (a persistent block per SM, 64 token
// rows per tile, weights in shared memory).  Nothing of size [N, N] goes to
// device memory.  The attention part takes two passes so that no thread adds
// into another's data: first a thread owns a (head, query) row and produces
// o, delta (as dacc·o, equal to Σ dp·p in float32), dqn and its share of
// dscale; then it owns a (head, key) row and produces dkn, dv and dbias.
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

#include "window_attention_geometries.cuh"
#include "window_attention_mma.cuh"

namespace {

using namespace tmar;

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

template <typename T>
int dispatch(int N, int nh, int hd, const void* const* p, int wq_k, int wq_n, int wp_k,
             int wp_n, void* dx, void* part, void* dparams, int nwin, int wh, int ww,
             int blocks, cudaStream_t s) {
#define TMAR_MMA_CASE(NN, DD, NH, HD)                                                 \
  if (N == NN && nh == NH && hd == HD)                                                \
    return launch_mma<NH, HD>(p, wq_k, wq_n, wp_k, wp_n, dx, part, dparams, nwin, wh, ww, \
                              blocks, s);
#define TMAR_CASE(NN, DD, NH, HD)                                                     \
  if (N == NN && nh == NH && hd == HD)                                                \
    return launch<NN, DD, NH, HD, T>(p, wq_k, wq_n, wp_k, wp_n, dx, part, dparams, nwin, wh, \
                                     ww, blocks, s);
  if constexpr (sizeof(T) == 2) {
    TMAR_ATTN_WINDOW_GEOMETRIES(TMAR_MMA_CASE)
  } else {
    TMAR_ATTN_WINDOW_GEOMETRIES(TMAR_CASE)
  }
  TMAR_ATTN_NGRAM_GEOMETRIES(TMAR_CASE)
#undef TMAR_MMA_CASE
#undef TMAR_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The float32 workspace the backward needs for these arguments (the
// per-block partial sums, and for the bfloat16 body at N = 64 also its bf16
// dqkv and attention-output tiles), in floats; -1 for an unknown geometry.
long long tmar_window_attention_bwd_workspace(int nwin, int N, int num_heads, int head_dim,
                                              int blocks, int is_bf16) {
  if (nwin < 1 || blocks < 1) return -1;
#define TMAR_MMA_WS(NN, DD, NH, HD)                                                   \
  if (N == NN && num_heads == NH && head_dim == HD)                                   \
    return (long long)BwdPlan<NH, HD>(nwin, blocks).total;
#define TMAR_WS(NN, DD, NH, HD)                                                       \
  if (N == NN && num_heads == NH && head_dim == HD)                                   \
    return (long long)blocks * Geo<NN, DD, NH, HD>::PSIZE;
  if (is_bf16) {
    TMAR_ATTN_WINDOW_GEOMETRIES(TMAR_MMA_WS)
  }
  TMAR_ATTN_WINDOW_GEOMETRIES(TMAR_WS)
  TMAR_ATTN_NGRAM_GEOMETRIES(TMAR_WS)
#undef TMAR_MMA_WS
#undef TMAR_WS
  return -1;
}

// x, g [nwin, N, D] (float32 or bfloat16, per is_bf16) and lse [nwin, nh, N]
// from the forward -> dx of x's shape and type, and dparams, float32, the
// concatenation of dwqkv [D, 3A], dbqkv [3A], dscale [nh], dbias [nh, N, N],
// dwproj [A, D], dbproj [D].  `workspace` holds the floats that
// tmar_window_attention_bwd_workspace gives for the same arguments, 16-byte
// aligned.  The other arguments are the forward's.  Returns a cudaError_t
// code.
int tmar_window_attention_bwd(const void* x, const void* g, const void* wqkv,
                              const void* bqkv, const void* scale, const void* bias,
                              const void* wproj, const void* mrow, const void* mcol,
                              const void* lse, void* dx, void* workspace, void* dparams,
                              int nwin, int N, int num_heads, int head_dim, int wq_k,
                              int wq_n, int wp_k, int wp_n, int wh, int ww, int blocks,
                              int is_bf16, void* stream) {
  if (nwin < 1 || blocks < 1 || (wh > 0 && (ww < 1 || nwin % (wh * ww))))
    return (int)cudaErrorInvalidValue;
  const void* p[10] = {x, g, wqkv, bqkv, scale, bias, wproj, mrow, mcol, lse};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(N, num_heads, head_dim, p, wq_k, wq_n, wp_k, wp_n, dx,
                                   workspace, dparams, nwin, wh, ww, blocks, s);
  return dispatch<float>(N, num_heads, head_dim, p, wq_k, wq_n, wp_k, wp_n, dx, workspace,
                         dparams, nwin, wh, ww, blocks, s);
}

const char* tmar_window_attention_bwd_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
