// N-gram context of one NSTB, backward: du and every parameter cotangent.
//
// Replaces the TPU kernel tmar/ops/pallas_ngram.py:_ngram_bwd_stripe_kernel
// (:520, driven by _backward, pallas_call at :410).  The forward is
// ngram_context.cu; the plain versions are
// tmar_torch/ops/cuda_ngram.py:ngram_context_kernel_backward_math (at float32
// the same function as ngram_context_backward_math, autograd through
// ngram_context_math).
//
// Given the unigram grid u [B, wh, ww, C=32], the context's cotangent
// g [B, wh, ww, D=64] and the forward's parameters, it recomputes q, k, v,
// the per-head L2 norms and both directions' 4x4 softmaxes, and emits
//   du [B, wh, ww, C] in u's type, and in float32, summed over the grid:
//   dwqkv [C, 3A], dbqkv [3A], dlogit_scale [nh] (the cotangent of the
//   effective scale exp(min(logit_scale, ln 100)) taken through exp∘clip),
//   dtable [9, nh] (the cotangents of the 16 (query, key) pairs of the 2x2
//   window folded into the bias table), dwproj [A, C], dbproj [C],
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
//   pass 1 (cells): a block owns tiles of cells, stages the positions they
//     read (reflect-mapped), recomputes the forward and writes each
//     window's d(qn), d(kn), d(v) into its own slot of a workspace
//     [B, wh, ww, 2 directions, 4 tokens, 3A]: one owner per slot.  It
//     keeps its sums of dscale, dbias, dwproj, dbproj, dwmerge and dbmerge
//     across its tiles.
//   pass 2 (positions): a block owns tiles of grid positions; for each it
//     adds, in a fixed order, the slots of the up to 18 windows that read
//     that position (an edge position is read twice by the windows whose
//     sequence-reflect padding maps onto it), then does the norm and qkv
//     backward there, and keeps its sums of dwqkv and dbqkv.
//   Each block writes its sums to its own slot of the partials, and one
//   reduce (ngram_bwd_reduce) adds both passes' slots in block order: three
//   launches.  Two runs give the same bits.  Two bodies, picked by the I/O
//   dtype: float32 computes in float32 on the CUDA cores (pass 1 over tiles
//   of 16 cells of a grid row, pass 2 over 32 positions); bfloat16 puts the
//   products on the tensor cores and rounds where _ngram_bwd_stripe_kernel
//   rounds at bf16 (below, "the bfloat16 body").

#include "common.cuh"
#include "ngram_mma.cuh"

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
    const float* __restrict__ bqkv, const float* __restrict__ ls,
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
  if (tid < NH) s_scale[tid] = expf(fminf(ls[tid], ngram::LN100));
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

// ---- the bfloat16 body: tensor cores (ngram_mma.cuh) -----------------------
//
// Pass 1 walks tiles of S = 2 grid rows x TJ = 4 cells (8 cells, 16
// (cell, direction) rows: one m-tile; 4 x 6 staged positions), so that the
// 8x128² step's stage-1 grid (2048 cells) gives 256 tiles.  Per tile:
//   1. u of the staged positions and g of the cells by cp.async;
//   2. q/k/v and their norms (ngram_mma.cuh) on two warps, and on the other
//      two dctx = g·wmᵀ (f32, kept for dbproj) and dctxc = bf16(dctx);
//   3. dacc = 0.25·dctxc·wprojᵀ on one warp, while the others add dbproj
//      and dbmerge;
//   4. one (cell, direction, head) per thread: the forward's softmax, the
//      mean token, then da_q = Σ bf16(bf16(dacc)·v_q) per head,
//      ds = a (da - Σ a·da), and the window's slots: dqn_p = Σ_q
//      bf16(ds·scale)·kn_q, dkn_q = Σ_p bf16(ds·scale)·qn_p, dv_q = Σ_p
//      bf16(a_pq)·dacc (_ngram_bwd_stripe_kernel, :735-770);
//   5. ctx = bf16(mean·wproj + bproj) on one warp, while the others add
//      dbias and dscale;
//   6. dwproj += meanᵀ·dctxc and dwmerge += ctxᵀ·g, the transposed operands
//      read by ldmatrix.trans, into shares that stay in registers across
//      the block's tiles.
// Pass 2 walks tiles of 16 grid positions: the slots' sums (a gather, as in
// the float32 body), raw q and k again on one warp, the norm backward on the
// CUDA cores (g_h = Σ bf16(dn·t), dt = dn·inv - t·bf16(g_h·inv²/r), :780-
// 790), dc = bf16(dt), then du = dc·wqkvᵀ and dwqkv += uᵀ·dc on mma.sync.
template <int NH, int HD>
struct CellsMma {
  static constexpr int S = 2, TJ = 4, WARPS = 4, THREADS = 32 * WARPS;
  static constexpr int CELLS = S * TJ;
  static constexpr int ROWS = 2 * CELLS;                          // (cell, direction) rows
  static constexpr int PROWS = ngram::ceil16((S + 2) * (TJ + 2));  // staged positions
  static constexpr int MROWS = ngram::ceil16(CELLS);              // cell rows, zero past CELLS
  static constexpr int NACC = 17 * NH + C + D;  // the block's dscale, dbias, dbproj, dbmerge
  // byte offsets into shared memory, after the staged weights
  static constexpr int QKV = ngram::Weights<NH>::BYTES;        // bf16 [PROWS][LQKV]
  static constexpr int U = QKV + PROWS * ngram::LQKV * 2;      // bf16 [PROWS][LU]
  static constexpr int SCRATCH = U + PROWS * ngram::LU * 2;    // f32 [WARPS][16][LS]
  static constexpr int G = SCRATCH + WARPS * 16 * ngram::LS * 4;  // bf16 [MROWS][LM]
  static constexpr int DCTX = G + MROWS * ngram::LM * 2;       // f32 [CELLS][2C]
  static constexpr int DCTXC = DCTX + CELLS * 2 * C * 4;       // bf16 [ROWS][LU]
  static constexpr int DACC = DCTXC + ROWS * ngram::LU * 2;    // f32 [ROWS][AP]
  static constexpr int MEAN = DACC + ROWS * ngram::AP * 4;     // bf16 [ROWS][LU]
  static constexpr int CTX = MEAN + ROWS * ngram::LU * 2;      // bf16 [MROWS][LM]
  static constexpr int DS = CTX + MROWS * ngram::LM * 2;       // f32 [ROWS][16][NH]
  static constexpr int DSC = DS + ROWS * 16 * NH * 4;          // f32 [ROWS][NH]
  static constexpr int ACC = DSC + ROWS * NH * 4;              // f32 [NACC]
  static constexpr int BYTES = ACC + NACC * 4;
  static_assert(ROWS == 16 && WARPS == 4, "the products below assume one m-tile of rows");
  static_assert(PROWS / 16 + 2 == WARPS, "step 2 gives each warp one job");
};

template <int NH, int HD>
__global__ void __launch_bounds__(128) ngram_bwd_cells_mma(
    const __nv_bfloat16* __restrict__ u, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ wqkv, const float* __restrict__ bqkv, const float* __restrict__ ls,
    const float* __restrict__ table, const float* __restrict__ wproj,
    const float* __restrict__ bproj, const float* __restrict__ wmerge, float* __restrict__ ws,
    float* __restrict__ part, int B, int wh, int ww) {
  using L = CellsMma<NH, HD>;
  using G1 = Geo<NH, HD>;
  constexpr int A = NH * HD, A3 = 3 * A, S = L::S, TJ = L::TJ, CELLS = L::CELLS;
  constexpr int LU = ngram::LU, LM = ngram::LM, AP = ngram::AP;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  ngram::stage_weights<NH, HD, L::THREADS>(smem, wqkv, bqkv, ls, table, wproj, bproj, wmerge,
                                           nullptr, tid);
  const ngram::Staged W = ngram::staged<NH>(smem);
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem + L::QKV);
  __nv_bfloat16* su = reinterpret_cast<__nv_bfloat16*>(smem + L::U);
  float* scratch = reinterpret_cast<float*>(smem + L::SCRATCH) + warp * 16 * ngram::LS;
  __nv_bfloat16* sg = reinterpret_cast<__nv_bfloat16*>(smem + L::G);
  float* sdctx = reinterpret_cast<float*>(smem + L::DCTX);
  __nv_bfloat16* sdctxc = reinterpret_cast<__nv_bfloat16*>(smem + L::DCTXC);
  float* sdacc = reinterpret_cast<float*>(smem + L::DACC);
  __nv_bfloat16* smean = reinterpret_cast<__nv_bfloat16*>(smem + L::MEAN);
  __nv_bfloat16* sctx = reinterpret_cast<__nv_bfloat16*>(smem + L::CTX);
  float* sds = reinterpret_cast<float*>(smem + L::DS);
  float* sdsc = reinterpret_cast<float*>(smem + L::DSC);
  float* sacc = reinterpret_cast<float*>(smem + L::ACC);
  // the cell rows past CELLS of g and ctx stay zero: they pad the
  // contractions over cells to a whole k-step
  for (int e = tid; e < (L::MROWS - CELLS) * LM; e += L::THREADS) {
    sg[CELLS * LM + e] = __float2bfloat16(0.f);
    sctx[CELLS * LM + e] = __float2bfloat16(0.f);
  }
  for (int e = tid; e < L::NACC; e += L::THREADS) sacc[e] = 0.f;
  // this warp's shares: dwproj rows 16·(warp / 2).., columns 16·(warp % 2)..;
  // dwmerge rows 16·warp.., all 64 columns
  float cwp[2][4], cwm[8][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    cwp[0][e] = cwp[1][e] = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) cwm[n][e] = 0.f;
  }

  const int rowtiles = (wh + S - 1) / S, coltiles = (ww + TJ - 1) / TJ;
  const int tiles = B * rowtiles * coltiles;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int j0 = (tile % coltiles) * TJ;
    const int i0 = ((tile / coltiles) % rowtiles) * S;
    const int b = tile / (coltiles * rowtiles);
    __syncthreads();  // the weights are staged; the last tile's step 6 is done
    // 1. g of the tile's cells (zero outside the grid), u of its positions
    for (int e = tid; e < CELLS * 8; e += L::THREADS) {
      const int cell = e >> 3, ch = e & 7;
      const int i = i0 + cell / TJ, j = j0 + cell % TJ;
      __nv_bfloat16* dst = sg + cell * LM + ch * 8;
      if (i < wh && j < ww)
        cp_async16(dst, g + (((size_t)b * wh + i) * ww + j) * D + ch * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    ngram::stage_u<S, TJ>(su, u, b, i0, j0, wh, ww, tid, L::THREADS);
    cp_async_wait_all();
    __syncthreads();

    // 2. q/k/v of the staged positions;  dctx = g·wm_dirᵀ, one warp a direction
    if (warp < L::PROWS / 16) {
      ngram::qkv_strip<NH, HD>(su, W, sq, scratch, 16 * warp, lane);
    } else {
      const int dir = warp - L::PROWS / 16;
      float acc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 16) {
        uint32_t a[4];
        load_a(a, sg, LM, 0, k0, lane);
        mma_pair(acc[0], acc[1], a, W.wm, LM, dir * C, k0, lane);
        mma_pair(acc[2], acc[3], a, W.wm, LM, dir * C + 16, k0, lane);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cell = gq + 8 * h;
        if (cell >= CELLS) continue;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = 8 * n + 2 * tq;
          sdctx[cell * 2 * C + dir * C + c] = acc[n][2 * h];
          sdctx[cell * 2 * C + dir * C + c + 1] = acc[n][2 * h + 1];
          sts32(sdctxc + (2 * cell + dir) * LU + c, pack_bf16(acc[n][2 * h], acc[n][2 * h + 1]));
        }
      }
    }
    __syncthreads();

    // 3. dacc = 0.25·dctxc·wprojᵀ;  the block's dbproj and dbmerge
    if (warp == 0) {
      float acc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t a[4];
        load_a(a, sdctxc, LU, 0, k0, lane);
        mma_pair(acc[0], acc[1], a, W.wp, LU, 0, k0, lane);
        mma_pair(acc[2], acc[3], a, W.wp, LU, 16, k0, lane);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sdacc[(gq + 8 * (e >> 1)) * AP + 8 * n + 2 * tq + (e & 1)] = acc[n][e] * 0.25f;
    } else {
      for (int e = tid - 32; e < C + D; e += L::THREADS - 32) {
        float s = 0.f;
        if (e < C) {  // dbproj[c]: each direction's sum over the cells
          float s2 = 0.f;
          for (int cell = 0; cell < CELLS; ++cell) {
            s += sdctx[cell * 2 * C + e];
            s2 += sdctx[cell * 2 * C + C + e];
          }
          s += s2;
        } else {  // dbmerge[d]
          for (int cell = 0; cell < CELLS; ++cell) s += __bfloat162float(sg[cell * LM + e - C]);
        }
        sacc[17 * NH + e] += s;
      }
    }
    __syncthreads();

    // 4. one (cell, direction, head) per thread: the softmax again, the mean
    //    token, then the window's cotangents into its workspace slots
    for (int e = tid; e < CELLS * 2 * NH; e += L::THREADS) {
      const int cell = e / (2 * NH), dir = (e / NH) % 2, h = e % NH;
      const int row = 2 * cell + dir;
      int tok[4];
      ngram::window_tokens<TJ>(cell / TJ, cell % TJ, dir, tok);
      ngram::Head<NH, HD> hd;
      hd.run(sq, W, tok, h);
      ngram::store_mean<NH, HD>(smean + row * LU, hd.acc, h);
      float dacc[HD], da[4];
#pragma unroll
      for (int d = 0; d < HD; ++d) dacc[d] = sdacc[row * AP + h * HD + d];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) s += ngram::bf(ngram::bf(dacc[d]) * hd.v[q][d]);
        da[q] = s;
      }
      const float sc = W.scale[h];
      float dp[16], dsc = 0.f;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float* ap = hd.a + 4 * p;
        const float inner = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(ap[0], da[0]),
                                                          __fmul_rn(ap[1], da[1])),
                                                __fmul_rn(ap[2], da[2])),
                                      __fmul_rn(ap[3], da[3]));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float ds = ap[q] * (da[q] - inner);
          sds[(row * 16 + 4 * p + q) * NH + h] = ds;
          dsc = fmaf(ds, hd.cs[4 * p + q], dsc);
          dp[4 * p + q] = ngram::bf(ds * sc);
        }
      }
      sdsc[row * NH + h] = dsc;
      const int i = i0 + cell / TJ, j = j0 + cell % TJ;
      if (i >= wh || j >= ww) continue;
      float* slot = ws + ((((size_t)b * wh + i) * ww + j) * 2 + dir) * 4 * A3 + h * HD;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float dq[HD], dk[HD], dv[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) dq[d] = dk[d] = dv[d] = 0.f;
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          const float ra = ngram::bf(hd.a[4 * o + t]);
#pragma unroll
          for (int d = 0; d < HD; ++d) {
            dq[d] = fmaf(dp[4 * t + o], hd.kn[o][d], dq[d]);
            dk[d] = fmaf(dp[4 * o + t], hd.qn[o][d], dk[d]);
            dv[d] = __fadd_rn(dv[d], __fmul_rn(ra, dacc[d]));
          }
        }
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          slot[t * A3 + d] = dq[d];
          slot[t * A3 + A + d] = dk[d];
          slot[t * A3 + 2 * A + d] = dv[d];
        }
      }
    }
    __syncthreads();

    // 5. ctx = bf16(mean·wproj + bproj);  the block's dscale and dbias
    if (warp == 0) {
      ngram::project_strip(smean, W, sctx, 0, lane);
    } else {
      for (int e = tid - 32; e < 17 * NH; e += L::THREADS - 32) {
        float s = 0.f;
        if (e < NH) {
          for (int row = 0; row < L::ROWS; ++row) s += sdsc[row * NH + e];
        } else {
          for (int row = 0; row < L::ROWS; ++row) s += sds[row * 16 * NH + e - NH];
        }
        sacc[e] += s;
      }
    }
    __syncthreads();

    // 6. dwproj += meanᵀ·dctxc (K = the 16 rows);  dwmerge += ctxᵀ·g (K = the
    //    cells, zero rows past CELLS)
    {
      uint32_t a[4];
      load_a_t(a, smean, LU, 16 * (warp >> 1), 0, lane);
      mma_pair_t(cwp[0], cwp[1], a, sdctxc, LU, 16 * (warp & 1), 0, lane);
      load_a_t(a, sctx, LM, 16 * warp, 0, lane);
#pragma unroll
      for (int n = 0; n < 8; n += 2) mma_pair_t(cwm[n], cwm[n + 1], a, sg, LM, 8 * n, 0, lane);
    }
  }
  __syncthreads();
  // the block's slot of partial sums, in the float32 body's layout
  float* my = part + (size_t)blockIdx.x * G1::P1SIZE;
  for (int e = tid; e < NH; e += L::THREADS) my[G1::Q_DSCALE + e] = sacc[e];
  for (int e = tid; e < 16 * NH; e += L::THREADS) my[G1::Q_DBIAS + e] = sacc[NH + e];
  for (int e = tid; e < C; e += L::THREADS) my[G1::Q_DBPROJ + e] = sacc[17 * NH + e];
  for (int e = tid; e < D; e += L::THREADS) my[G1::Q_DBM + e] = sacc[17 * NH + C + e];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = gq + 8 * (e >> 1), c = 2 * tq + (e & 1);
    const int a = 16 * (warp >> 1) + r;
    if (a < A) {
      my[G1::Q_DWPROJ + a * C + 16 * (warp & 1) + c] = cwp[0][e];
      my[G1::Q_DWPROJ + a * C + 16 * (warp & 1) + 8 + c] = cwp[1][e];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) my[G1::Q_DWM + (16 * warp + r) * D + 8 * n + c] = cwm[n][e];
  }
}

template <int NH, int HD>
struct PositionsMma {
  static constexpr int TP = 16, THREADS = 256;
  static constexpr int A3 = 3 * NH * HD;
  static constexpr int LD = 100;     // float row stride of the slot sums and dt
  static constexpr int MAXSLOT = 18;  // windows reading one position: 2 directions x 3 x 3
  // byte offsets into shared memory
  static constexpr int WQKV = 0;                                // bf16 [C][LQKV]
  static constexpr int BQKV = WQKV + C * ngram::LQKV * 2;       // f32 [3·AP], bf16 values
  static constexpr int U = BQKV + 3 * ngram::AP * 4;            // bf16 [TP][LU]
  static constexpr int QK = U + TP * ngram::LU * 2;             // f32 [TP][LS]: raw q | k
  static constexpr int DSUM = QK + TP * ngram::LS * 4;          // f32 [TP][LD]: dn, then dt
  static constexpr int DC = DSUM + TP * LD * 4;                 // bf16 [TP][LQKV]
  static constexpr int ACC = DC + TP * ngram::LQKV * 2;         // f32 [A3]: the block's dbqkv
  static constexpr int SLOTS = ACC + A3 * 4;                    // u32 [TP][MAXSLOT]: slot offsets
  static constexpr int NSLOT = SLOTS + TP * MAXSLOT * 4;        // int [TP]: their count
  static constexpr int BYTES = NSLOT + TP * 4;
};

template <int NH, int HD>
__global__ void __launch_bounds__(256) ngram_bwd_positions_mma(
    const __nv_bfloat16* __restrict__ u, const float* __restrict__ wqkv,
    const float* __restrict__ bqkv, const float* __restrict__ ws,
    __nv_bfloat16* __restrict__ du, float* __restrict__ part, int B, int wh, int ww) {
  using L = PositionsMma<NH, HD>;
  constexpr int A = NH * HD, A3 = 3 * A, TP = L::TP, LD = L::LD;
  constexpr int LU = ngram::LU, LQKV = ngram::LQKV, LS = ngram::LS, AP = ngram::AP;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem + L::WQKV);
  float* sb = reinterpret_cast<float*>(smem + L::BQKV);
  __nv_bfloat16* su = reinterpret_cast<__nv_bfloat16*>(smem + L::U);
  float* sqk = reinterpret_cast<float*>(smem + L::QK);
  float* sd = reinterpret_cast<float*>(smem + L::DSUM);
  __nv_bfloat16* sdc = reinterpret_cast<__nv_bfloat16*>(smem + L::DC);
  float* sacc = reinterpret_cast<float*>(smem + L::ACC);
  unsigned* sslot = reinterpret_cast<unsigned*>(smem + L::SLOTS);
  int* snslot = reinterpret_cast<int*>(smem + L::NSLOT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  ngram::stage_qkv_weights<NH, HD, L::THREADS>(sw, sb, wqkv, bqkv, tid);
  // the padded columns of dc stay zero
  for (int e = tid; e < TP * 3 * AP; e += L::THREADS)
    if (e % AP >= A) sdc[(e / (3 * AP)) * LQKV + e % (3 * AP)] = __float2bfloat16(0.f);
  for (int e = tid; e < A3; e += L::THREADS) sacc[e] = 0.f;
  // warps 0-3 hold a share of dwqkv: rows 16·(warp % 2).., columns
  // 48·(warp / 2)..
  float cw[6][4];
#pragma unroll
  for (int n = 0; n < 6; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) cw[n][e] = 0.f;

  const long total = (long)B * wh * ww;
  const int tiles = (int)((total + TP - 1) / TP);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long pos0 = (long)tile * TP;
    // 1. the offsets of the slots that read each position, in a fixed order
    //    (direction, row reader, column reader), then u of the tile's
    //    positions (zero past the end) and the sums of those slots
    if (tid < TP) {
      int n = 0;
      const long pos = pos0 + tid;
      if (pos < total) {
        const int j = (int)(pos % ww), i = (int)((pos / ww) % wh);
        const size_t img = (size_t)(pos / ((long)wh * ww)) * wh * ww;
        for (int dir = 0; dir < 2; ++dir) {
          int ci[3], di[3], cj[3], dj[3];
          const int nr = readers(i, wh, dir, ci, di);
          const int nc = readers(j, ww, dir, cj, dj);
          for (int y = 0; y < nr; ++y)
            for (int x = 0; x < nc; ++x)
              sslot[tid * L::MAXSLOT + n++] = (unsigned)(
                  (((img + (size_t)ci[y] * ww + cj[x]) * 2 + dir) * 4 + di[y] * 2 + dj[x]) * A3);
        }
      }
      snslot[tid] = n;
    }
    __syncthreads();  // the offsets are set; the last tile is done
    for (int e = tid; e < TP * 4; e += L::THREADS) {
      const int r = e >> 2, ch = e & 3;
      __nv_bfloat16* dst = su + r * LU + ch * 8;
      if (pos0 + r < total)
        cp_async16(dst, u + (pos0 + r) * C + ch * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
    for (int e = tid; e < TP * A3; e += L::THREADS) {
      const int r = e / A3, o = e % A3;
      const unsigned* off = sslot + r * L::MAXSLOT;
      const int n = snslot[r];
      float s = 0.f;
#pragma unroll 4
      for (int k = 0; k < n; ++k) s += ws[off[k] + o];
      sd[r * LD + o] = s;
    }
    cp_async_wait_all();
    __syncthreads();

    // 2. raw q and k again (one warp);  dc of v = bf16(dv)
    if (warp == 0) {
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t a[4];
        load_a(a, su, LU, 0, k0, lane);
#pragma unroll
        for (int n = 0; n < 8; n += 2) mma_pair_t(acc[n], acc[n + 1], a, sw, LQKV, 8 * n, k0, lane);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * tq + (e & 1);
          sqk[(gq + 8 * (e >> 1)) * LS + col] = acc[n][e] + sb[col];
        }
    } else {
      for (int e = tid - 32; e < TP * A; e += L::THREADS - 32) {
        const int r = e / A, a = e % A;
        sdc[r * LQKV + 2 * AP + a] = __float2bfloat16(sd[r * LD + 2 * A + a]);
      }
    }
    __syncthreads();

    // 3. the L2-norm backward in place, one (position, q|k, head) per thread:
    //    dt = dn·inv - t·bf16(Σ bf16(dn·t) · inv² / r)
    for (int e = tid; e < TP * 2 * NH; e += L::THREADS) {
      const int r = e / (2 * NH), blk = (e / NH) % 2, h = e % NH;
      float* dn = sd + r * LD + blk * A + h * HD;
      __nv_bfloat16* dc = sdc + r * LQKV + blk * AP + h * HD;
      if (pos0 + r >= total) {  // rows past the end add nothing
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          dn[d] = 0.f;
          dc[d] = __float2bfloat16(0.f);
        }
        continue;
      }
      const float* t = sqk + r * LS + blk * AP + h * HD;
      float n2 = 0.f, gh = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        n2 += ngram::bf(t[d] * t[d]);
        gh += ngram::bf(dn[d] * t[d]);
      }
      const float rr = sqrtf(n2);
      const float inv = ngram::bf(1.f / ngram::bf(rr + 1e-12f));
      const float fb = ngram::bf(gh * inv * inv / rr);
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        const float dt = __fsub_rn(__fmul_rn(dn[d], inv), __fmul_rn(t[d], fb));
        dn[d] = dt;
        dc[d] = __float2bfloat16(dt);
      }
    }
    __syncthreads();

    // 4. dwqkv += uᵀ·dc (warps 0-3);  du = dc·wqkvᵀ (warps 4-5);  dbqkv
    //    (warps 6-7)
    if (warp < 4) {
      uint32_t a[4];
      load_a_t(a, su, LU, 16 * (warp & 1), 0, lane);
#pragma unroll
      for (int n = 0; n < 6; n += 2)
        mma_pair_t(cw[n], cw[n + 1], a, sdc, LQKV, 48 * (warp >> 1) + 8 * n, 0, lane);
    } else if (warp < 6) {
      const int half = warp - 4;
      float acc[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][e] = acc[1][e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < 3 * AP; k0 += 16) {
        uint32_t a[4];
        load_a(a, sdc, LQKV, 0, k0, lane);
        mma_pair(acc[0], acc[1], a, sw, LQKV, 16 * half, k0, lane);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long pos = pos0 + gq + 8 * h;
        if (pos >= total) continue;
#pragma unroll
        for (int n = 0; n < 2; ++n)
          sts32(du + pos * C + 16 * half + 8 * n + 2 * tq,
                pack_bf16(acc[n][2 * h], acc[n][2 * h + 1]));
      }
    } else {
      for (int e = tid - 192; e < A3; e += 64) {
        float s = 0.f;
        for (int r = 0; r < TP; ++r) s += sd[r * LD + e];
        sacc[e] += s;
      }
    }
    __syncthreads();  // step 4 is done with u, dc and dt
  }
  __syncthreads();
  // the block's slot of partial sums: dwqkv [C][3A] and dbqkv [3A], unpadded
  float* my = part + (size_t)blockIdx.x * (C * A3 + A3);
  if (warp < 4) {
#pragma unroll
    for (int n = 0; n < 6; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 16 * (warp & 1) + gq + 8 * (e >> 1);
        const int col = 48 * (warp >> 1) + 8 * n + 2 * tq + (e & 1), a = col % AP;
        if (a < A) my[c * A3 + (col / AP) * A + a] = cw[n][e];
      }
  }
  for (int e = tid; e < A3; e += L::THREADS) my[C * A3 + e] = sacc[e];
}

// The reduce of both passes' partial sums into the cotangents as the
// wrapper returns them: dwqkv [32, 3A], dbqkv [3A], dlogit_scale [nh]
// (dscale · exp(min(ls, ln 100)), zero above the clip), dtable [9, nh]
// (dbias folded by the transpose of the 2x2 gather), dwproj [A, 32], dbproj
// [32], dwmerge [64, 64], dbmerge [64].  With round_bf16 it rounds dwqkv,
// dbqkv, dwproj, dbproj and dwmerge to bf16 values as it writes them (the
// JAX backward's casts to the parameters' dtype, pallas_ngram.py:446-467).
// A block of 8 warps owns 32 consecutive outputs: warp w adds the partials
// of blocks w, w + 8, ... (coalesced across the lanes), then the eight
// warps' sums are added in warp order.  No atomics: two runs give the same
// bits.
template <int NH, int HD>
__global__ void __launch_bounds__(256) ngram_bwd_reduce(const float* __restrict__ part1,
                                                        int blocks1,
                                                        const float* __restrict__ part2,
                                                        int blocks2, const float* __restrict__ ls,
                                                        float* __restrict__ out, int round_bf16) {
  using G1 = Geo<NH, HD>;
  constexpr int A = NH * HD;
  constexpr int O_DLS = G1::P2SIZE, O_DTABLE = O_DLS + NH, O_DWPROJ = O_DTABLE + 9 * NH;
  constexpr int O_DBM = O_DWPROJ + A * C + C + 2 * C * D, TOTAL = O_DBM + D;
  __shared__ float sums[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.f;
  auto add = [&](const float* __restrict__ part, int stride, int blocks, int k) {
#pragma unroll 8
    for (int b = w; b < blocks; b += 8) s += part[(size_t)b * stride + k];
  };
  if (e < O_DLS) {
    add(part2, G1::P2SIZE, blocks2, e);
  } else if (e < O_DTABLE) {
    add(part1, G1::P1SIZE, blocks1, G1::Q_DSCALE + e - O_DLS);
  } else if (e < O_DWPROJ) {
    const int t = (e - O_DTABLE) / NH, h = (e - O_DTABLE) % NH;
    for (int pq = 0; pq < 16; ++pq) {
      const int p = pq >> 2, q = pq & 3;
      if (((p >> 1) - (q >> 1) + 1) * 3 + ((p & 1) - (q & 1) + 1) == t)
        add(part1, G1::P1SIZE, blocks1, G1::Q_DBIAS + pq * NH + h);
    }
  } else if (e < TOTAL) {
    add(part1, G1::P1SIZE, blocks1, G1::Q_DWPROJ + e - O_DWPROJ);
  }
  sums[w][lane] = s;
  __syncthreads();
  if (w != 0 || e >= TOTAL) return;
  s = sums[0][lane];
#pragma unroll
  for (int k = 1; k < 8; ++k) s += sums[k][lane];
  if (e >= O_DLS && e < O_DTABLE) {
    const float l = ls[e - O_DLS];
    s = s * expf(fminf(l, ngram::LN100)) * (l <= ngram::LN100 ? 1.f : 0.f);
  } else if (round_bf16 && (e < O_DLS || (e >= O_DWPROJ && e < O_DBM))) {
    s = ngram::bf(s);
  }
  out[e] = s;
}

// Grid sizes and scratch of one backward call: blocks of the cells and
// positions passes, and the floats of the scratch (the workspace of slots,
// then pass 1's and pass 2's partial sums).
struct Plan {
  int blocks1, blocks2;
  size_t ws, part1, floats;
};

template <int NH, int HD>
int plan(int B, int wh, int ww, int is_bf16, int sms, Plan* out) {
  using G1 = Geo<NH, HD>;
  const long cells = (long)B * wh * ww;
  long tiles1, tiles2, per1, per2;
  if (is_bf16) {
    using L1 = CellsMma<NH, HD>;
    using L2 = PositionsMma<NH, HD>;
    static int occ[2] = {0, 0};  // resident blocks per SM of the two passes, asked once
    if (occ[0] == 0) {
      auto k1 = ngram_bwd_cells_mma<NH, HD>;
      auto k2 = ngram_bwd_positions_mma<NH, HD>;
      cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             L1::BYTES);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[0], k1, L1::THREADS, L1::BYTES);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[1], k2, L2::THREADS, L2::BYTES);
      if (err != cudaSuccess) return (int)err;
      if (occ[0] < 1 || occ[1] < 1) return (int)cudaErrorInvalidConfiguration;
    }
    tiles1 = (long)B * ((wh + L1::S - 1) / L1::S) * ((ww + L1::TJ - 1) / L1::TJ);
    tiles2 = (cells + L2::TP - 1) / L2::TP;
    per1 = occ[0];
    per2 = occ[1];
  } else {
    // pass 1 one block per SM over tiles of TJ cells of a grid row, pass 2
    // up to two per SM over tiles of TP positions
    tiles1 = (long)B * wh * ((ww + TJ - 1) / TJ);
    tiles2 = (cells + TP - 1) / TP;
    per1 = 1;
    per2 = 2;
  }
  out->blocks1 = (int)(tiles1 < per1 * sms ? tiles1 : per1 * sms);
  out->blocks2 = (int)(tiles2 < per2 * sms ? tiles2 : per2 * sms);
  out->ws = (size_t)cells * 2 * 4 * 3 * NH * HD;
  out->part1 = (size_t)out->blocks1 * G1::P1SIZE;
  out->floats = out->ws + out->part1 + (size_t)out->blocks2 * G1::P2SIZE;
  return 0;
}

template <int NH, int HD>
int launch(const void* const* p, void* du, void* scratch, void* dparams, int B, int wh, int ww,
           int is_bf16, int sms, cudaStream_t stream) {
  using G1 = Geo<NH, HD>;
  Plan pl;
  int rc = plan<NH, HD>(B, wh, ww, is_bf16, sms, &pl);
  if (rc != 0) return rc;
  float* ws = (float*)scratch;
  float* part1 = ws + pl.ws;
  float* part2 = part1 + pl.part1;
  cudaError_t err;
  if (is_bf16) {
    if (((uintptr_t)p[0] | (uintptr_t)p[1] | (uintptr_t)du) & 15) return (int)cudaErrorMisalignedAddress;
    using L1 = CellsMma<NH, HD>;
    using L2 = PositionsMma<NH, HD>;
    ngram_bwd_cells_mma<NH, HD><<<pl.blocks1, L1::THREADS, L1::BYTES, stream>>>(
        (const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[1], (const float*)p[2],
        (const float*)p[3], (const float*)p[4], (const float*)p[5], (const float*)p[6],
        (const float*)p[7], (const float*)p[8], ws, part1, B, wh, ww);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ngram_bwd_positions_mma<NH, HD><<<pl.blocks2, L2::THREADS, L2::BYTES, stream>>>(
        (const __nv_bfloat16*)p[0], (const float*)p[2], (const float*)p[3], ws,
        (__nv_bfloat16*)du, part2, B, wh, ww);
  } else {
    auto cells = ngram_bwd_cells_kernel<NH, HD, float>;
    auto positions = ngram_bwd_positions_kernel<NH, HD, float>;
    err = cudaFuncSetAttribute(cells, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)G1::BYTES1);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(positions, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)G1::BYTES2);
    if (err != cudaSuccess) return (int)err;
    cells<<<pl.blocks1, THREADS, G1::BYTES1, stream>>>(
        (const float*)p[0], (const float*)p[1], (const float*)p[2], (const float*)p[3],
        (const float*)p[4], (const float*)p[5], (const float*)p[6], (const float*)p[7],
        (const float*)p[8], ws, part1, B, wh, ww);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    positions<<<pl.blocks2, THREADS, G1::BYTES2, stream>>>(
        (const float*)p[0], (const float*)p[2], (const float*)p[3], ws, (float*)du, part2, B,
        wh, ww);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  constexpr int TOTAL = G1::P2SIZE + 10 * NH + NH * HD * C + C + 2 * C * D + D;
  ngram_bwd_reduce<NH, HD><<<(TOTAL + 31) / 32, 256, 0, stream>>>(
      part1, pl.blocks1, part2, pl.blocks2, (const float*)p[4], (float*)dparams, is_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// u [B, wh, ww, 32] and g [B, wh, ww, 64] (float32 or bfloat16, per is_bf16)
// -> du of u's shape and type, and dparams, float32, the concatenation of
// dwqkv [32, 3A], dbqkv [3A], dlogit_scale [nh], dtable [9, nh], dwproj
// [A, 32], dbproj [32], dwmerge [64, 64], dbmerge [64] (at bfloat16 dwqkv,
// dbqkv, dwproj, dbproj and dwmerge are bf16 values).  The weights are the
// forward's (tmar_ngram_context): float32, contiguous, logit_scale raw.
// bfloat16 runs the tensor-core body (u, g and du 16-byte aligned), float32
// the float32 body; each is three launches (cells pass, positions pass, one
// reduce).  `scratch` holds tmar_ngram_context_bwd_workspace's count of
// floats.  Requires wh >= 2 and ww >= 2.  Returns a cudaError_t code.
int tmar_ngram_context_bwd(const void* u, const void* g, const void* wqkv, const void* bqkv,
                           const void* logit_scale, const void* table, const void* wproj,
                           const void* bproj, const void* wmerge, void* du, void* scratch,
                           void* dparams, int B, int wh, int ww, int num_heads, int head_dim,
                           int is_bf16, int sms, void* stream) {
  if (B < 1 || wh < 2 || ww < 2 || sms < 1) return (int)cudaErrorInvalidValue;
  const void* p[9] = {u, g, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge};
  cudaStream_t s = (cudaStream_t)stream;
  if (num_heads == 6 && head_dim == 5)
    return launch<6, 5>(p, du, scratch, dparams, B, wh, ww, is_bf16, sms, s);
  if (num_heads == 4 && head_dim == 8)
    return launch<4, 8>(p, du, scratch, dparams, B, wh, ww, is_bf16, sms, s);
  return (int)cudaErrorInvalidValue;
}

// The floats of scratch tmar_ngram_context_bwd needs for this call, into
// *floats.  Returns a cudaError_t code.
int tmar_ngram_context_bwd_workspace(int B, int wh, int ww, int num_heads, int head_dim,
                                     int is_bf16, int sms, long long* floats) {
  Plan pl;
  int rc = (int)cudaErrorInvalidValue;
  if (num_heads == 6 && head_dim == 5) rc = plan<6, 5>(B, wh, ww, is_bf16, sms, &pl);
  if (num_heads == 4 && head_dim == 8) rc = plan<4, 8>(B, wh, ww, is_bf16, sms, &pl);
  if (rc == 0) *floats = (long long)pl.floats;
  return rc;
}

const char* tmar_ngram_context_bwd_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
