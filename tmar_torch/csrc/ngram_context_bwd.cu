// N-gram context of one NSTB, backward: du and every parameter cotangent.
//
// Replaces the TPU kernel tmar/ops/pallas_ngram.py:_ngram_bwd_stripe_kernel
// (:520, driven by _backward, pallas_call at :410).  The forward is
// ngram_context.cu; the plain version is autograd through
// tmar_torch/ops/cuda_ngram.py:ngram_context_math
// (ngram_context_backward_math).
//
// Given the unigram grid u [B, wh, ww, C=32], the context's cotangent
// g [B, wh, ww, D=64] and the forward's parameters, it recomputes q, k, v,
// the per-head L2 norms and both directions' 4x4 softmaxes, and emits
//   du [B, wh, ww, C] in u's type, and in float32, summed over the grid:
//   dwqkv [C, 3A], dbqkv [3A], dscale [nh] (on the EFFECTIVE scale
//   exp(min(logit_scale, ln 100)): the wrapper routes it through exp∘clip),
//   dbias [16, nh] (one row per (query, key) pair of the 2x2 window: the
//   wrapper folds it into the [9, nh] table), dwproj [A, C], dbproj [C],
//   dwmerge [2C, D], dbmerge [D].
// Per cell and direction, with a = softmax, mean = 0.25 Σ_p Σ_q a_pq v_q,
// ctx = mean @ wproj + bproj, out = [ctx_f | ctx_b] @ wmerge + bmerge:
//   dctx = g @ wmerge_dirᵀ;  dacc = 0.25 dctx @ wprojᵀ (the token mean
//   commutes with the projection);  da_q = dacc · v_q (the same for every
//   query p);  ds_pq = a_pq (da_q - Σ_q' a_pq' da_q');
//   dqn_p = scale Σ_q ds_pq kn_q;  dkn_q = scale Σ_p ds_pq qn_p;
//   dv_q = (Σ_p a_pq) dacc.
// Per grid position, after summing what every window sent to it:
//   dq = dqn / (r + eps) - q (dqn · q) / ((r + eps)² r),  r = |q| per head
//   (the same for k);  du = [dq | dk | dv] @ wqkvᵀ.
// A zero q or k head gives 0 / 0 = NaN there, as autograd through the plain
// version's sqrt does (the forward divides by r + 1e-12, the backward by r):
// the kernel does not hide it.
//
// What bounds it on an H100: neither bytes nor operations.  At the 8x128²
// train step's stage-1 grid (8 x 16 x 16 cells) it moves under 1 MB and does
// about 0.1 GFLOP: it is bound by launch and latency, like the forward.
//
// Design.  The TPU kernel pushes the window cotangents back to the grid
// with shift transposes (a scatter) and carries the parameter sums over a
// sequential grid.  CUDA blocks run in no order and float atomics would
// make two runs differ, so the scatter is turned into a gather over two
// passes:
//   pass 1 (cells): a block owns tiles of TJ cells of one grid row, stages
//     the three input rows they read (reflect-mapped), recomputes the
//     forward and writes each window's d(qn), d(kn), d(v) into its own slot
//     of a workspace [B, wh, ww, 2 directions, 4 tokens, 3A]: one owner per
//     slot.  It keeps its sums of dscale, dbias, dwproj, dbproj, dwmerge and
//     dbmerge in shared memory across its tiles.
//   pass 2 (positions): a block owns tiles of TP grid positions; for each it
//     adds, in a fixed order, the slots of the up to 18 windows that read
//     that position (an edge position is read twice by the windows whose
//     sequence-reflect padding maps onto it), then does the norm and qkv
//     backward there, and keeps its sums of dwqkv and dbqkv.
//   Each block writes its sums to its own slot of `part`, and
//   reduce_partials adds the slots in block order.  Two runs give the same
//   bits.  All arithmetic is float32, whatever the I/O type.

#include "common.cuh"

namespace {

using namespace tmar;

constexpr int C = 32;   // unigram channels (D / 2)
constexpr int D = 64;   // context channels
constexpr int TJ = 16;  // pass 1: cells per tile
constexpr int W2 = TJ + 2;
constexpr int NPOS = 3 * W2;
constexpr int TP = 32;  // pass 2: positions per tile

// sequence-reflect index map of the halo: -1 -> 1, n -> n-2; positions past
// n only feed cells outside the grid and are clamped to stay in bounds
__device__ __forceinline__ int reflect(int r, int n) {
  if (r < 0) return 1;
  if (r == n) return n - 2;
  return r < n ? r : n - 1;
}

template <int NH, int HD>
struct Geo {
  static constexpr int A = NH * HD;
  static constexpr int A3 = 3 * A;
  // shared-memory rows are padded to an odd length so that reads along
  // either index are free of bank conflicts
  static constexpr int LQ = A3 + 1;  // q/k/v rows, and wqkv [C][LQ]
  static constexpr int LP = C + 1;   // wproj [A][LP]
  static constexpr int LM = D + 1;   // wmerge [2C][LM]
  // the reduced result: pass 2's sums first, then pass 1's
  static constexpr int R_DWQKV = 0;  // [C][A3]
  static constexpr int R_DBQKV = R_DWQKV + C * A3;
  static constexpr int P2SIZE = R_DBQKV + A3;
  static constexpr int Q_DSCALE = 0;
  static constexpr int Q_DBIAS = Q_DSCALE + NH;        // [16][NH]
  static constexpr int Q_DWPROJ = Q_DBIAS + 16 * NH;   // [A][C]
  static constexpr int Q_DBPROJ = Q_DWPROJ + A * C;
  static constexpr int Q_DWM = Q_DBPROJ + C;           // [2C][D]
  static constexpr int Q_DBM = Q_DWM + 2 * C * D;
  static constexpr int P1SIZE = Q_DBM + D;
  // pass 1 shared memory, in floats
  static constexpr int WQKV = 0;
  static constexpr int BQKV = WQKV + C * LQ;
  static constexpr int WPROJ = BQKV + A3;
  static constexpr int BPROJ = WPROJ + A * LP;
  static constexpr int WM = BPROJ + C;
  static constexpr int SCALE = WM + 2 * C * LM;
  static constexpr int BIAS = SCALE + 8;               // [NH][16]
  static constexpr int U = BIAS + NH * 16;
  static constexpr int QKV = U + NPOS * C;
  static constexpr int G = QKV + NPOS * LQ;            // [TJ][D]
  static constexpr int DCTX = G + TJ * D;              // [TJ][2][C]
  static constexpr int DACC = DCTX + TJ * 2 * C;       // [TJ][2][A]
  static constexpr int MEAN = DACC + TJ * 2 * A;       // [TJ][2][A]
  static constexpr int CTX = MEAN + TJ * 2 * A;        // [TJ][2][C]
  static constexpr int DS = CTX + TJ * 2 * C;          // [TJ][2][16][NH]
  static constexpr int DSC = DS + TJ * 2 * 16 * NH;    // [TJ][2][NH]
  static constexpr int ACC1 = DSC + TJ * 2 * NH;       // the block's sums
  static constexpr int FLOATS1 = ACC1 + P1SIZE;
  static constexpr size_t BYTES1 = FLOATS1 * sizeof(float);
  // pass 2 shared memory, in floats
  static constexpr int T_WQKV = 0;                     // [C][LQ]
  static constexpr int T_BQKV = T_WQKV + C * LQ;
  static constexpr int T_U = T_BQKV + A3;              // [TP][LP]
  static constexpr int T_QK = T_U + TP * LP;           // [TP][LQ]: raw q, k
  static constexpr int T_DQKV = T_QK + TP * LQ;        // [TP][LQ]
  static constexpr int ACC2 = T_DQKV + TP * LQ;
  static constexpr int FLOATS2 = ACC2 + P2SIZE;
  static constexpr size_t BYTES2 = FLOATS2 * sizeof(float);
  static_assert(BYTES1 <= MAX_SMEM && BYTES2 <= MAX_SMEM, "tile does not fit in shared memory");
};

// ---- pass 1: one owner per (cell, direction, token) slot -------------------
template <int NH, int HD, typename T>
__global__ void __launch_bounds__(THREADS, 1) ngram_bwd_cells_kernel(
    const T* __restrict__ u, const T* __restrict__ g, const float* __restrict__ wqkv,
    const float* __restrict__ bqkv, const float* __restrict__ scale,
    const float* __restrict__ table, const float* __restrict__ wproj,
    const float* __restrict__ bproj, const float* __restrict__ wmerge,
    float* __restrict__ ws, float* __restrict__ part, int B, int wh, int ww) {
  using L = Geo<NH, HD>;
  constexpr int A = L::A, A3 = L::A3, LQ = L::LQ, LP = L::LP, LM = L::LM;
  extern __shared__ float smem[];
  float* s_wqkv = smem + L::WQKV;
  float* s_bqkv = smem + L::BQKV;
  float* s_wproj = smem + L::WPROJ;
  float* s_bproj = smem + L::BPROJ;
  float* s_wm = smem + L::WM;
  float* s_scale = smem + L::SCALE;
  float* s_bias = smem + L::BIAS;
  float* s_u = smem + L::U;
  float* s_qkv = smem + L::QKV;
  float* sG = smem + L::G;
  float* sDctx = smem + L::DCTX;
  float* sDacc = smem + L::DACC;
  float* sMean = smem + L::MEAN;
  float* sCtx = smem + L::CTX;
  float* sDS = smem + L::DS;
  float* sDSC = smem + L::DSC;
  float* sAcc = smem + L::ACC1;

  const int tid = threadIdx.x;
  for (int e = tid; e < C * A3; e += THREADS) s_wqkv[(e / A3) * LQ + e % A3] = wqkv[e];
  for (int e = tid; e < A3; e += THREADS) s_bqkv[e] = bqkv[e];
  for (int e = tid; e < A * C; e += THREADS) s_wproj[(e / C) * LP + e % C] = wproj[e];
  for (int e = tid; e < C; e += THREADS) s_bproj[e] = bproj[e];
  for (int e = tid; e < 2 * C * D; e += THREADS) s_wm[(e / D) * LM + e % D] = wmerge[e];
  if (tid < NH) s_scale[tid] = scale[tid];
  // 2x2 relative-position bias: s_bias[h][p][q] = table[idx(p, q)][h]
  for (int e = tid; e < NH * 16; e += THREADS) {
    const int h = e / 16, p = (e / 4) % 4, q = e % 4;
    const int idx = ((p >> 1) - (q >> 1) + 1) * 3 + ((p & 1) - (q & 1) + 1);
    s_bias[e] = table[idx * NH + h];
  }
  for (int e = tid; e < L::P1SIZE; e += THREADS) sAcc[e] = 0.f;
  __syncthreads();

  const int segs = (ww + TJ - 1) / TJ;
  const int tiles = B * wh * segs;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int j0 = (tile % segs) * TJ;
    const int i = (tile / segs) % wh;
    const int b = tile / (segs * wh);
    const size_t row = ((size_t)b * wh + i) * ww;  // first cell of the grid row

    // 1. rows i-1, i, i+1 and columns j0-1 .. j0+TJ of u, reflect-mapped;
    //    g of the tile's cells, zero past the row's end
    for (int e = tid; e < NPOS * C; e += THREADS) {
      const int pos = e / C, c = e % C;
      const int gr = reflect(i - 1 + pos / W2, wh);
      const int gc = reflect(j0 - 1 + pos % W2, ww);
      s_u[e] = to_f(u[(((size_t)b * wh + gr) * ww + gc) * C + c]);
    }
    for (int e = tid; e < TJ * D; e += THREADS) {
      const int jj = e / D;
      sG[e] = j0 + jj < ww ? to_f(g[(row + j0 + jj) * D + e % D]) : 0.f;
    }
    __syncthreads();

    // 2. q, k, v of every staged position;  dctx = g @ wmerge_dirᵀ
    for (int e = tid; e < NPOS * A3; e += THREADS) {
      const int pos = e / A3, o = e % A3;
      const float* ur = s_u + pos * C;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) acc = fmaf(ur[c], s_wqkv[c * LQ + o], acc);
      s_qkv[pos * LQ + o] = acc + s_bqkv[o];
    }
    for (int e = tid; e < TJ * 2 * C; e += THREADS) {
      const float* gr = sG + (e / (2 * C)) * D;
      const float* wr = s_wm + (e % (2 * C)) * LM;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(gr[d], wr[d], acc);
      sDctx[e] = acc;
    }
    __syncthreads();

    // 3. per-head L2 normalisation of q and k;  dacc = 0.25 dctx @ wprojᵀ
    for (int e = tid; e < NPOS * 2 * NH; e += THREADS) {
      float* t = s_qkv + (e / (2 * NH)) * LQ + (e % (2 * NH)) * HD;
      float ss = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) ss = fmaf(t[d], t[d], ss);
      const float inv = 1.f / (sqrtf(ss) + 1e-12f);
#pragma unroll
      for (int d = 0; d < HD; ++d) t[d] *= inv;
    }
    for (int e = tid; e < TJ * 2 * A; e += THREADS) {
      const float* dc = sDctx + (e / A) * C;
      const float* wr = s_wproj + (e % A) * LP;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) acc = fmaf(dc[c], wr[c], acc);
      sDacc[e] = 0.25f * acc;
    }
    __syncthreads();

    // 4. one (cell, direction, head) per thread: the softmax again, the mean
    //    token, then the window's cotangents into its workspace slots
    for (int e = tid; e < TJ * 2 * NH; e += THREADS) {
      const int jj = e / (2 * NH), dir = (e / NH) % 2, h = e % NH;
      const int jd = jj * 2 + dir;
      float* mo = sMean + jd * A + h * HD;
      float* dso = sDS + jd * 16 * NH + h;
      if (j0 + jj >= ww) {
#pragma unroll
        for (int d = 0; d < HD; ++d) mo[d] = 0.f;
#pragma unroll
        for (int pq = 0; pq < 16; ++pq) dso[pq * NH] = 0.f;
        sDSC[e] = 0.f;
        continue;
      }
      const int lc = jj + 1;  // staged column of the cell itself
      int tok[4];
      if (dir == 0) {
        tok[0] = W2 + lc;
        tok[1] = W2 + lc + 1;
        tok[2] = 2 * W2 + lc;
        tok[3] = 2 * W2 + lc + 1;
      } else {
        tok[0] = lc - 1;
        tok[1] = lc;
        tok[2] = W2 + lc - 1;
        tok[3] = W2 + lc;
      }
      const float sc = s_scale[h];
      float a[16], cs[16];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float* qp = s_qkv + tok[p] * LQ + h * HD;
        float m = -INFINITY;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* kq = s_qkv + tok[q] * LQ + A + h * HD;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) dot = fmaf(qp[d], kq[d], dot);
          cs[p * 4 + q] = dot;
          a[p * 4 + q] = dot * sc + s_bias[h * 16 + p * 4 + q];
          m = fmaxf(m, a[p * 4 + q]);
        }
        float z = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[p * 4 + q] = expf(a[p * 4 + q] - m);
          z += a[p * 4 + q];
        }
        const float iz = 1.f / z;
#pragma unroll
        for (int q = 0; q < 4; ++q) a[p * 4 + q] *= iz;
      }
      const float* dac = sDacc + jd * A + h * HD;
      float colsum[4], da[4];
      float acc[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* vq = s_qkv + tok[q] * LQ + 2 * A + h * HD;
        colsum[q] = a[q] + a[4 + q] + a[8 + q] + a[12 + q];
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          acc[d] = fmaf(colsum[q], vq[d], acc[d]);
          dot = fmaf(dac[d], vq[d], dot);
        }
        da[q] = dot;
      }
#pragma unroll
      for (int d = 0; d < HD; ++d) mo[d] = acc[d] * 0.25f;
      float dsc = 0.f;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float inner = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) inner = fmaf(a[p * 4 + q], da[q], inner);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float ds = a[p * 4 + q] * (da[q] - inner);
          dso[(p * 4 + q) * NH] = ds;
          dsc = fmaf(ds, cs[p * 4 + q], dsc);
          a[p * 4 + q] = ds * sc;  // from here on a holds scale * ds
        }
      }
      sDSC[e] = dsc;
      float* slot = ws + ((row + j0 + jj) * 2 + dir) * 4 * A3 + h * HD;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float dq[HD], dk[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) dq[d] = dk[d] = 0.f;
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          const float* ko = s_qkv + tok[o] * LQ + A + h * HD;
          const float* qo = s_qkv + tok[o] * LQ + h * HD;
#pragma unroll
          for (int d = 0; d < HD; ++d) {
            dq[d] = fmaf(a[t * 4 + o], ko[d], dq[d]);
            dk[d] = fmaf(a[o * 4 + t], qo[d], dk[d]);
          }
        }
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          slot[t * A3 + d] = dq[d];
          slot[t * A3 + A + d] = dk[d];
          slot[t * A3 + 2 * A + d] = colsum[t] * dac[d];
        }
      }
    }
    __syncthreads();

    // 5. ctx = mean @ wproj + bproj, each direction's mean token
    for (int e = tid; e < TJ * 2 * C; e += THREADS) {
      const float* mv = sMean + (e / C) * A;
      const int c = e % C;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < A; ++k) acc = fmaf(mv[k], s_wproj[k * LP + c], acc);
      sCtx[e] = acc + s_bproj[c];
    }
    __syncthreads();

    // 6. the block's running sums; every element has one owner thread
    for (int e = tid; e < L::P1SIZE; e += THREADS) {
      float s = 0.f;
      if (e < L::Q_DBIAS) {  // dscale[h]
        for (int jd = 0; jd < TJ * 2; ++jd) s += sDSC[jd * NH + e];
      } else if (e < L::Q_DWPROJ) {  // dbias[pq][h]
        for (int jd = 0; jd < TJ * 2; ++jd) s += sDS[jd * 16 * NH + (e - L::Q_DBIAS)];
      } else if (e < L::Q_DBPROJ) {  // dwproj[a][c] = Σ mean[a] dctx[c]
        const int k = (e - L::Q_DWPROJ) / C, c = (e - L::Q_DWPROJ) % C;
        for (int jd = 0; jd < TJ * 2; ++jd) s = fmaf(sMean[jd * A + k], sDctx[jd * C + c], s);
      } else if (e < L::Q_DWM) {  // dbproj[c]
        for (int jd = 0; jd < TJ * 2; ++jd) s += sDctx[jd * C + (e - L::Q_DBPROJ)];
      } else if (e < L::Q_DBM) {  // dwmerge[dir * C + c][d] = Σ ctx_dir[c] g[d]
        const int k = (e - L::Q_DWM) / D, d = (e - L::Q_DWM) % D;
        for (int jj = 0; jj < TJ; ++jj) s = fmaf(sCtx[jj * 2 * C + k], sG[jj * D + d], s);
      } else {  // dbmerge[d]
        for (int jj = 0; jj < TJ; ++jj) s += sG[jj * D + (e - L::Q_DBM)];
      }
      sAcc[e] += s;
    }
    __syncthreads();
  }
  float* my = part + (size_t)blockIdx.x * L::P1SIZE;
  for (int e = tid; e < L::P1SIZE; e += THREADS) my[e] = sAcc[e];
}

// The windows of one direction that read grid index `i` along one axis of
// length n, as (cell index, offset in the window) pairs in a fixed order.
// Forward windows read (c, c + 1) with n reflected to n - 2; backward
// windows read (c - 1, c) with -1 reflected to 1.
__device__ __forceinline__ int readers(int i, int n, int dir, int (&cell)[3], int (&off)[3]) {
  int count = 0;
  for (int c = i - 1; c <= i + 1; ++c) {
    if (c < 0 || c >= n) continue;
    for (int o = 0; o < 2; ++o) {
      int r = dir == 0 ? c + o : c - 1 + o;
      if (r == n) r = n - 2;
      if (r < 0) r = 1;
      if (r == i) {
        cell[count] = c;
        off[count] = o;
        ++count;
      }
    }
  }
  return count;
}

// ---- pass 2: one owner per grid position ----------------------------------
template <int NH, int HD, typename T>
__global__ void __launch_bounds__(THREADS) ngram_bwd_positions_kernel(
    const T* __restrict__ u, const float* __restrict__ wqkv, const float* __restrict__ bqkv,
    const float* __restrict__ ws, T* __restrict__ du, float* __restrict__ part, int B,
    int wh, int ww) {
  using L = Geo<NH, HD>;
  constexpr int A = L::A, A3 = L::A3, LQ = L::LQ, LP = L::LP;
  extern __shared__ float smem[];
  float* s_wqkv = smem + L::T_WQKV;
  float* s_bqkv = smem + L::T_BQKV;
  float* sU = smem + L::T_U;
  float* sQK = smem + L::T_QK;
  float* sDQ = smem + L::T_DQKV;
  float* sAcc = smem + L::ACC2;

  const int tid = threadIdx.x;
  for (int e = tid; e < C * A3; e += THREADS) s_wqkv[(e / A3) * LQ + e % A3] = wqkv[e];
  for (int e = tid; e < A3; e += THREADS) s_bqkv[e] = bqkv[e];
  for (int e = tid; e < L::P2SIZE; e += THREADS) sAcc[e] = 0.f;
  __syncthreads();

  const long total = (long)B * wh * ww;
  const int tiles = (int)((total + TP - 1) / TP);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long pos0 = (long)tile * TP;

    // 1. u of the tile's positions, zero past the end
    for (int e = tid; e < TP * C; e += THREADS) {
      const int r = e / C, c = e % C;
      sU[r * LP + c] = pos0 + r < total ? to_f(u[(pos0 + r) * C + c]) : 0.f;
    }
    __syncthreads();

    // 2. raw q and k;  the sum of the slots that read each position
    for (int e = tid; e < TP * 2 * A; e += THREADS) {
      const int r = e / (2 * A), o = e % (2 * A);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) acc = fmaf(sU[r * LP + c], s_wqkv[c * LQ + o], acc);
      sQK[r * LQ + o] = acc + s_bqkv[o];
    }
    for (int e = tid; e < TP * A3; e += THREADS) {
      const int r = e / A3, o = e % A3;
      float s = 0.f;
      if (pos0 + r < total) {
        const long pos = pos0 + r;
        const int j = (int)(pos % ww), i = (int)((pos / ww) % wh);
        const size_t img = (size_t)(pos / ((long)wh * ww)) * wh * ww;
        for (int dir = 0; dir < 2; ++dir) {
          int ci[3], di[3], cj[3], dj[3];
          const int nr = readers(i, wh, dir, ci, di);
          const int nc = readers(j, ww, dir, cj, dj);
          for (int y = 0; y < nr; ++y)
            for (int x = 0; x < nc; ++x)
              s += ws[(((img + (size_t)ci[y] * ww + cj[x]) * 2 + dir) * 4 + di[y] * 2 + dj[x]) * A3 + o];
        }
      }
      sDQ[r * LQ + o] = s;
    }
    __syncthreads();

    // 3. the L2-norm backward in place: dt = dn / (r + eps) - t (dn·t) / ((r + eps)² r)
    for (int e = tid; e < TP * 2 * NH; e += THREADS) {
      const int r = e / (2 * NH);
      if (pos0 + r >= total) continue;  // zero rows stay zero
      const int off = r * LQ + (e % (2 * NH)) * HD;
      const float* t = sQK + off;
      float* dt = sDQ + off;
      float ss = 0.f, dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        ss = fmaf(t[d], t[d], ss);
        dot = fmaf(dt[d], t[d], dot);
      }
      const float rr = sqrtf(ss);
      const float inv = 1.f / (rr + 1e-12f);
      const float factor = dot * inv * inv / rr;
#pragma unroll
      for (int d = 0; d < HD; ++d) dt[d] = dt[d] * inv - t[d] * factor;
    }
    __syncthreads();

    // 4. du = dqkv @ wqkvᵀ;  dwqkv += uᵀ dqkv;  dbqkv += Σ dqkv
    for (int e = tid; e < TP * C; e += THREADS) {
      const int r = e / C, c = e % C;
      if (pos0 + r >= total) continue;
      const float* dq = sDQ + r * LQ;
      const float* wr = s_wqkv + c * LQ;
      float acc = 0.f;
#pragma unroll 6
      for (int o = 0; o < A3; ++o) acc = fmaf(dq[o], wr[o], acc);
      store(du + (pos0 + r) * C + c, acc);
    }
    for (int e = tid; e < L::P2SIZE; e += THREADS) {
      float s = 0.f;
      if (e < L::R_DBQKV) {
        const int c = e / A3, o = e % A3;
        for (int r = 0; r < TP; ++r) s = fmaf(sU[r * LP + c], sDQ[r * LQ + o], s);
      } else {
        for (int r = 0; r < TP; ++r) s += sDQ[r * LQ + (e - L::R_DBQKV)];
      }
      sAcc[e] += s;
    }
    __syncthreads();
  }
  float* my = part + (size_t)blockIdx.x * L::P2SIZE;
  for (int e = tid; e < L::P2SIZE; e += THREADS) my[e] = sAcc[e];
}

template <int NH, int HD, typename T>
int launch(const void* const* p, void* du, void* ws, void* part, void* dparams, int B,
           int wh, int ww, int blocks1, int blocks2, cudaStream_t stream) {
  using L = Geo<NH, HD>;
  auto cells = ngram_bwd_cells_kernel<NH, HD, T>;
  auto positions = ngram_bwd_positions_kernel<NH, HD, T>;
  cudaError_t err = cudaFuncSetAttribute(
      cells, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      positions, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES2);
  if (err != cudaSuccess) return (int)err;
  float* part1 = (float*)part;
  float* part2 = part1 + (size_t)blocks1 * L::P1SIZE;
  float* out = (float*)dparams;
  cells<<<blocks1, THREADS, L::BYTES1, stream>>>(
      (const T*)p[0], (const T*)p[1], (const float*)p[2], (const float*)p[3],
      (const float*)p[4], (const float*)p[5], (const float*)p[6], (const float*)p[7],
      (const float*)p[8], (float*)ws, part1, B, wh, ww);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  positions<<<blocks2, THREADS, L::BYTES2, stream>>>(
      (const T*)p[0], (const float*)p[2], (const float*)p[3], (const float*)ws, (T*)du,
      part2, B, wh, ww);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_partials<<<(L::P2SIZE + 255) / 256, 256, 0, stream>>>(part2, out, blocks2, L::P2SIZE);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_partials<<<(L::P1SIZE + 255) / 256, 256, 0, stream>>>(
      part1, out + L::P2SIZE, blocks1, L::P1SIZE);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int nh, int hd, const void* const* p, void* du, void* ws, void* part,
             void* dparams, int B, int wh, int ww, int blocks1, int blocks2, cudaStream_t s) {
  if (nh == 6 && hd == 5)
    return launch<6, 5, T>(p, du, ws, part, dparams, B, wh, ww, blocks1, blocks2, s);
  if (nh == 4 && hd == 8)
    return launch<4, 8, T>(p, du, ws, part, dparams, B, wh, ww, blocks1, blocks2, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// u [B, wh, ww, 32] and g [B, wh, ww, 64] (float32 or bfloat16, per is_bf16)
// -> du of u's shape and type, and dparams, float32, the concatenation of
// dwqkv [32, 3A], dbqkv [3A], dscale [nh], dbias [16, nh], dwproj [A, 32],
// dbproj [32], dwmerge [64, 64], dbmerge [64].  The weights are the forward's
// (tmar_ngram_context), float32 and contiguous.  `ws` is scratch of
// B·wh·ww·2·4·3A floats; `part` is scratch of blocks1 times the size of
// dparams from dscale on, plus blocks2 times the size of dwqkv and dbqkv.
// Requires wh >= 2 and ww >= 2.  Returns a cudaError_t code.
int tmar_ngram_context_bwd(const void* u, const void* g, const void* wqkv, const void* bqkv,
                           const void* scale, const void* table, const void* wproj,
                           const void* bproj, const void* wmerge, void* du, void* ws,
                           void* part, void* dparams, int B, int wh, int ww, int num_heads,
                           int head_dim, int blocks1, int blocks2, int is_bf16, void* stream) {
  if (B < 1 || wh < 2 || ww < 2 || blocks1 < 1 || blocks2 < 1) return (int)cudaErrorInvalidValue;
  const void* p[9] = {u, g, wqkv, bqkv, scale, table, wproj, bproj, wmerge};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(num_heads, head_dim, p, du, ws, part, dparams, B, wh, ww,
                                   blocks1, blocks2, s);
  return dispatch<float>(num_heads, head_dim, p, du, ws, part, dparams, B, wh, ww, blocks1,
                         blocks2, s);
}

const char* tmar_ngram_context_bwd_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
