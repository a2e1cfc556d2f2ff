// Scaled-cosine window attention, backward: all seven cotangents.
//
// Replaces the TPU kernels tmar/ops/pallas_attention.py:
// _attn_bwd_kernel_batched (:568, 64-token windows) and :_attn_bwd_kernel
// (:704, the block-diagonal kernel of the 4-token n-gram windows), both
// driven by _fused_backward (pallas_call at :481).  One kernel templated on
// (N, D, heads, head_dim), as the forward (window_attention_fwd.cu).  Plain
// version: autograd of tmar_torch/ops/attention.py:window_attention_math.
//
// Given x, the output cotangent g and the forward's lse, it recomputes q, k,
// v and the probabilities p = exp(s - lse) per tile and emits
//   dx [nwin, N, D], and summed over all windows:
//   dwqkv [D, 3A], dbqkv [3A], dscale [nh] (on the EFFECTIVE scale: the
//   wrapper routes it through exp∘clip), dbias [nh, N, N], dwproj [A, D],
//   dbproj [D].
// With dacc = g @ wprojᵀ and delta_i = dacc_i · o_i:
//   ds_ij = p_ij (dacc_i·v_j - delta_i);  dbias += ds;  dscale += ds·cos
//   dqn_i = scale Σ_j ds_ij kn_j;  dkn_j = scale Σ_i ds_ij qn_i
//   dv_j  = Σ_i p_ij dacc_i;  dq = (dqn - qn (dqn·qn)) / |q|, the same for k
//   dx = dqkv @ wqkvᵀ;  dwqkv += xᵀ dqkv;  dwproj += oᵀ g
//
// What bounds it on an H100: operations, about three times the forward's.
// Design: the forward's tiling (a persistent block per SM, 64 token rows per
// tile, weights in shared memory).  Nothing of size [N, N] goes to device
// memory.  The attention part takes two passes so that no thread adds into
// another's data: first a thread owns a (head, query) row and produces o,
// delta, dqn and its share of dscale; then it owns a (head, key) row and
// produces dkn, dv and dbias.  The TPU grid is sequential and accumulates
// the parameter cotangents in place; CUDA blocks run in no order, so each
// block keeps its own sums (dwqkv and dwproj in registers across its tiles,
// the vectors in shared memory, the 64-token dbias in its slot of device
// memory), writes them to part[block], and a second kernel adds the slots in
// block order.  No float atomics: two runs give the same bits.

#include "common.cuh"

namespace {

using namespace tmar;

template <int N, int D, int NH, int HD>
struct Geo {
  static constexpr int A = NH * HD;
  static constexpr int A3 = 3 * A;
  static constexpr int WPB = ROWS / N;  // windows per tile
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
  static constexpr int DBIAS = DSCALE + 8;        // N = 4 only: [NH][4][4]
  static constexpr int DS = DBIAS + (N == 4 ? NB : 0);  // N = 4 only: [NH][WPB][4][4]
  static constexpr int FLOATS = DS + (N == 4 ? NH * ROWS * 4 : 0);
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
  constexpr int WPB = G::WPB;
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

  for (int e = tid; e < D * A3; e += THREADS) {
    const int k = e / A3, n = e % A3;
    s_wqkv[k * G::LWQ + n] = wqkv[(size_t)k * wq_k + (size_t)n * wq_n];
  }
  for (int e = tid; e < A * D; e += THREADS) {
    const int k = e / D, n = e % D;
    s_wproj[k * G::LWP + n] = wproj[(size_t)k * wp_k + (size_t)n * wp_n];
  }
  for (int e = tid; e < A3; e += THREADS) {
    s_bqkv[e] = bqkv[e];
    s_dbqkv[e] = 0.f;
  }
  for (int e = tid; e < D; e += THREADS) s_dbproj[e] = 0.f;
  if (tid < 8) s_dscale[tid] = 0.f;
  if (tid < NH) s_scale[tid] = scale[tid];
  if constexpr (N == 4) {
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
  const int tiles = (int)((total + ROWS - 1) / ROWS);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * ROWS;

    // 1. x and g of the tile, zero past the end; the forward's lse
    for (int e = tid; e < ROWS * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const bool ok = row0 + r < total;
      sX[r * LX + d] = ok ? to_f(x[(row0 + r) * D + d]) : 0.f;
      sA[r * LA + d] = ok ? to_f(g[(row0 + r) * D + d]) : 0.f;
    }
    for (int e = tid; e < NH * ROWS; e += THREADS) {
      const int h = e / ROWS, r = e % ROWS;
      const int win = tile * WPB + r / N;
      sLse[e] = win < nwin ? lse[((size_t)win * NH + h) * N + r % N] : 0.f;
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
      if (win < nwin) {
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
      if (win < nwin) {
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
          if constexpr (N == 4) {
            sDS[((h * WPB + w) * 4 + i) * 4 + j] = ds;
          } else {
            my[G::P_DBIAS + ij] += ds;  // this thread alone owns (block, h, i, j)
          }
        }
      } else if constexpr (N == 4) {
        for (int i = 0; i < 4; ++i) sDS[((h * WPB + w) * 4 + i) * 4 + j] = 0.f;
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
    if constexpr (N == 4) {
      for (int e = tid; e < G::NB; e += THREADS) {
        const int h = e / 16, ij = e % 16;
        float s = 0.f;
        for (int w = 0; w < WPB; ++w) s += sDS[(h * WPB + w) * 16 + ij];
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
      sB[r * LA + d] = row0 + r < total ? to_f(g[(row0 + r) * D + d]) : 0.f;
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
        if (row0 + m < total) store(dx + (row0 + m) * D + n, v);
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
  if constexpr (N == 4) {
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

template <typename T>
int dispatch(int N, int nh, int hd, const void* const* p, int wq_k, int wq_n, int wp_k,
             int wp_n, void* dx, void* part, void* dparams, int nwin, int wh, int ww,
             int blocks, cudaStream_t s) {
  if (N == 64 && nh == 6 && hd == 10)
    return launch<64, 64, 6, 10, T>(p, wq_k, wq_n, wp_k, wp_n, dx, part, dparams, nwin, wh, ww, blocks, s);
  if (N == 64 && nh == 4 && hd == 16)
    return launch<64, 64, 4, 16, T>(p, wq_k, wq_n, wp_k, wp_n, dx, part, dparams, nwin, wh, ww, blocks, s);
  if (N == 4 && nh == 6 && hd == 5)
    return launch<4, 32, 6, 5, T>(p, wq_k, wq_n, wp_k, wp_n, dx, part, dparams, nwin, wh, ww, blocks, s);
  if (N == 4 && nh == 4 && hd == 8)
    return launch<4, 32, 4, 8, T>(p, wq_k, wq_n, wp_k, wp_n, dx, part, dparams, nwin, wh, ww, blocks, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, g [nwin, N, D] (float32 or bfloat16, per is_bf16) and lse [nwin, nh, N]
// from the forward -> dx of x's shape and type, and dparams, float32, the
// concatenation of dwqkv [D, 3A], dbqkv [3A], dscale [nh], dbias [nh, N, N],
// dwproj [A, D], dbproj [D].  `part` is scratch of `blocks` times that size.
// The other arguments are the forward's.  Returns a cudaError_t code.
int tmar_window_attention_bwd(const void* x, const void* g, const void* wqkv,
                              const void* bqkv, const void* scale, const void* bias,
                              const void* wproj, const void* mrow, const void* mcol,
                              const void* lse, void* dx, void* part, void* dparams,
                              int nwin, int N, int num_heads, int head_dim, int wq_k,
                              int wq_n, int wp_k, int wp_n, int wh, int ww, int blocks,
                              int is_bf16, void* stream) {
  if (nwin < 1 || blocks < 1 || (wh > 0 && (ww < 1 || nwin % (wh * ww))))
    return (int)cudaErrorInvalidValue;
  const void* p[10] = {x, g, wqkv, bqkv, scale, bias, wproj, mrow, mcol, lse};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(N, num_heads, head_dim, p, wq_k, wq_n, wp_k, wp_n, dx,
                                   part, dparams, nwin, wh, ww, blocks, s);
  return dispatch<float>(N, num_heads, head_dim, p, wq_k, wq_n, wp_k, wp_n, dx, part,
                         dparams, nwin, wh, ww, blocks, s);
}

const char* tmar_window_attention_bwd_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
