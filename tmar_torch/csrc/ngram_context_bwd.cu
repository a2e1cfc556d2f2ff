// N-gram context of one NSTB, backward: du and every parameter cotangent.
//
// Replaces the TPU kernel tmar/ops/pallas_ngram.py:_ngram_bwd_stripe_kernel
// (:520, driven by _backward, pallas_call at :410).  The forward is
// ngram_context.cu; the plain versions are
// tmar_torch/ops/cuda_ngram.py:ngram_context_kernel_backward_math (at float32
// the same function as ngram_context_backward_math, autograd through
// ngram_context_math).
//
// Given the unigram grid u [B, wh, ww, C], the context's cotangent
// g [B, wh, ww, D] and the forward's parameters, it recomputes q, k, v,
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
//   launches.  Two runs give the same bits.  Three bodies, picked by the
//   I/O dtype and the widths (ngram_g::body, the rule of
//   tmar_torch/ops/envelope.py:ngram_body): bfloat16 at the full-width
//   NGswin's (C = 32, D = 64, heads 6 x 5 or 4 x 8) puts the products on the
//   tensor cores and rounds where _ngram_bwd_stripe_kernel rounds at bf16
//   (below, "the bfloat16 body"); bfloat16 at every other width with a plan
//   (C and D multiples of 8 up to 128) runs the tensor-core generic body
//   (ngram_g, below), the same design with the widths at run time; every
//   other case runs the CUDA-core generic body, which takes C, D, the heads
//   and head_dim (any) at run time (pass 1 over tiles of 16 cells of a
//   grid row, pass 2 over 32 positions, each fewer where its block would
//   not fit: 8 and 32 at C = 256; weights read from device memory),
//   products on the CUDA cores in float32, rounding at bfloat16 where
//   ngram_context_kernel_backward_math does.

#include "common.cuh"
#include "ngram_generic_mma.cuh"
#include "ngram_mma.cuh"

namespace {

using namespace tmar;

constexpr int C = 32;   // the tensor-core body's unigram channels (D / 2)
constexpr int D = 64;   // and context channels
constexpr int TJ = 16;  // the generic body's pass 1: cells per tile, at most
constexpr int TP = 32;  // the generic body's pass 2: positions per tile, at most

// sequence-reflect index map of the halo: -1 -> 1, n -> n-2; positions past
// n only feed cells outside the grid and are clamped to stay in bounds
__device__ __forceinline__ int reflect(int r, int n) {
  if (r < 0) return 1;
  if (r == n) return n - 2;
  return r < n ? r : n - 1;
}


// The tensor-core body's pass-1 slots: Slots' at C = 32, D = 64, as constants.
template <int NH, int HD>
struct Geo {
  static constexpr int A = NH * HD;
  static constexpr int Q_DSCALE = 0;
  static constexpr int Q_DBIAS = Q_DSCALE + NH;        // [16][NH]
  static constexpr int Q_DWPROJ = Q_DBIAS + 16 * NH;   // [A][C]
  static constexpr int Q_DBPROJ = Q_DWPROJ + A * C;
  static constexpr int Q_DWM = Q_DBPROJ + C;           // [2C][D]
  static constexpr int Q_DBM = Q_DWM + 2 * C * D;
  static constexpr int P1SIZE = Q_DBM + D;
};

// the 2x2 relative-position bias of (query p, key q) of head h, from the
// [9, nh] table
__device__ __forceinline__ float pair_bias(const float* table, int p, int q, int h, int nh) {
  return __ldg(table + (((p >> 1) - (q >> 1) + 1) * 3 + ((p & 1) - (q & 1) + 1)) * nh + h);
}

// ---- the CUDA-core generic body, pass 1: one owner per (cell, direction, token) slot
// A block owns tiles of tj cells of a grid row; it stages u of the 3 x (tj+2)
// positions they read (reflect-mapped) and g of its cells, recomputes the
// forward as ngram_context.cu's generic body does (a thread's 16 softmax
// weights in registers, the head's channels walked one at a time, so
// head_dim bounds no register array), and writes each window's
// d(qn), d(kn), d(v) into its own slot of ws.  Its sums of dscale, dbias,
// dwproj, dbproj, dwmerge and dbmerge go into its slot of part (zeroed
// first), each element by one owner thread.  Weights are read from device
// memory, rounded to T's values.  At bfloat16 it rounds where
// ngram_context_kernel_backward_math does; at float32 nowhere.
template <typename T>
__global__ void __launch_bounds__(THREADS) ngram_bwd_cells_rt(
    const T* __restrict__ u, const T* __restrict__ g, const float* __restrict__ wqkv,
    const float* __restrict__ bqkv, const float* __restrict__ ls,
    const float* __restrict__ table, const float* __restrict__ wproj,
    const float* __restrict__ bproj, const float* __restrict__ wmerge,
    float* __restrict__ ws, float* __restrict__ part, int B, int wh, int ww, int C, int D,
    int nh, int hd, int TJ) {
  const Slots P(C, D, nh, hd);
  const int A = P.A, A3 = P.A3, LQ = A3 + 1, W2 = TJ + 2, NPOS = 3 * W2;
  extern __shared__ float smem[];
  float* s_u = smem;                      // [NPOS][C]
  float* s_qkv = s_u + NPOS * C;          // [NPOS][LQ]: q_n, k_n, v (T's values)
  float* sG = s_qkv + NPOS * LQ;          // [TJ][D]
  float* sDctx = sG + TJ * D;             // [TJ][2][C]
  float* sDacc = sDctx + TJ * 2 * C;      // [TJ][2][A]
  float* sMean = sDacc + TJ * 2 * A;      // [TJ][2][A]
  float* sCtx = sMean + TJ * 2 * A;       // [TJ][2][C]
  float* sDS = sCtx + TJ * 2 * C;         // [TJ][2][16][nh]
  float* sDSC = sDS + TJ * 2 * 16 * nh;   // [TJ][2][nh]
  const int tid = threadIdx.x;
  float* my = part + (size_t)blockIdx.x * P.P1SIZE;
  for (int e = tid; e < P.P1SIZE; e += THREADS) my[e] = 0.f;
  __syncthreads();
  auto r = [](float v) { return round_as<T>(v); };

  const int segs = (ww + TJ - 1) / TJ;
  const long tiles = (long)B * wh * segs;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int j0 = (int)(tile % segs) * TJ;
    const int i = (int)((tile / segs) % wh);
    const int b = (int)(tile / ((long)segs * wh));
    const size_t row = ((size_t)b * wh + i) * ww;  // first cell of the grid row

    // 1. u of rows i-1, i, i+1 and columns j0-1 .. j0+TJ, reflect-mapped;
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

    // 2. q, k, v = u @ T(wqkv) + T(bqkv), v rounded;  dctx = g @ T(wmerge_dir)ᵀ
    mm_rt(NPOS, A3, C, [&](int m, int k) { return s_u[m * C + k]; },
          [&](int k, int n) { return r(__ldg(wqkv + (size_t)k * A3 + n)); },
          [&](int m, int n, float v) {
            v += r(__ldg(bqkv + n));
            s_qkv[m * LQ + n] = n >= 2 * A ? r(v) : v;
          });
    mm_rt(TJ, 2 * C, D, [&](int m, int k) { return sG[m * D + k]; },
          [&](int k, int n) { return r(__ldg(wmerge + (size_t)n * D + k)); },
          [&](int m, int n, float v) { sDctx[m * 2 * C + n] = v; });
    __syncthreads();

    // 3. q_n, k_n as the forward rounds them;  dacc = 0.25 T(dctx) @ T(wproj)ᵀ
    for (int e = tid; e < NPOS * 2 * nh; e += THREADS) {
      float* t = s_qkv + (e / (2 * nh)) * LQ + (e % (2 * nh)) * hd;
      float n2 = 0.f;
      for (int d = 0; d < hd; ++d) n2 += r(t[d] * t[d]);
      const float inv = r(1.f / r(sqrtf(n2) + 1e-12f));
      for (int d = 0; d < hd; ++d) t[d] = r(t[d] * inv);
    }
    mm_rt(TJ * 2, A, C, [&](int m, int k) { return r(sDctx[m * C + k]); },
          [&](int k, int n) { return r(__ldg(wproj + (size_t)n * C + k)); },
          [&](int m, int n, float v) { sDacc[m * A + n] = 0.25f * v; });
    __syncthreads();

    // 4. one (cell, direction, head) per thread: the softmax again, the mean
    //    token, then the window's cotangents into its workspace slots
    for (int e = tid; e < TJ * 2 * nh; e += THREADS) {
      const int jj = e / (2 * nh), dir = (e / nh) % 2, h = e % nh;
      const int jd = jj * 2 + dir;
      float* mo = sMean + jd * A + h * hd;
      float* dso = sDS + jd * 16 * nh + h;
      if (j0 + jj >= ww) {
        for (int d = 0; d < hd; ++d) mo[d] = 0.f;
        for (int pq = 0; pq < 16; ++pq) dso[pq * nh] = 0.f;
        sDSC[e] = 0.f;
        continue;
      }
      const int lc = jj + 1;  // staged column of the cell itself
      int tok[4];
      if (dir == 0) {
        tok[0] = W2 + lc, tok[1] = W2 + lc + 1, tok[2] = 2 * W2 + lc, tok[3] = 2 * W2 + lc + 1;
      } else {
        tok[0] = lc - 1, tok[1] = lc, tok[2] = W2 + lc - 1, tok[3] = W2 + lc;
      }
      const float sc = expf(fminf(__ldg(ls + h), ngram::LN100));
      float a[16], cs[16];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float* qp = s_qkv + tok[p] * LQ + h * hd;
        float m = -INFINITY;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* kq = s_qkv + tok[q] * LQ + A + h * hd;
          float dot = 0.f;
          for (int d = 0; d < hd; ++d) dot += r(qp[d] * kq[d]);
          cs[p * 4 + q] = dot;
          a[p * 4 + q] = dot * sc + pair_bias(table, p, q, h, nh);
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
      const float* dac = sDacc + jd * A + h * hd;
      const float* v = s_qkv + 2 * A + h * hd;
      float colsum[4], da[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* vq = v + tok[q] * LQ;
        colsum[q] = r(a[q]) + r(a[4 + q]) + r(a[8 + q]) + r(a[12 + q]);
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += r(r(dac[d]) * vq[d]);
        da[q] = dot;
      }
      for (int d = 0; d < hd; ++d) {
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc = fmaf(colsum[q], v[tok[q] * LQ + d], acc);
        mo[d] = r(acc * 0.25f);
      }
      float dsc = 0.f;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float inner = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) inner = fmaf(a[p * 4 + q], da[q], inner);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float ds = a[p * 4 + q] * (da[q] - inner);
          dso[(p * 4 + q) * nh] = ds;
          dsc = fmaf(ds, cs[p * 4 + q], dsc);
          a[p * 4 + q] = r(ds * sc);  // from here on a holds T(scale · ds)
        }
      }
      sDSC[e] = dsc;
      float* slot = ws + ((row + j0 + jj) * 2 + dir) * 4 * A3 + h * hd;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        for (int d = 0; d < hd; ++d) {
          float dq = 0.f, dk = 0.f;
#pragma unroll
          for (int o = 0; o < 4; ++o) {
            const float* qo = s_qkv + tok[o] * LQ + h * hd;
            dq = fmaf(a[t * 4 + o], qo[A + d], dq);
            dk = fmaf(a[o * 4 + t], qo[d], dk);
          }
          slot[t * A3 + d] = dq;
          slot[t * A3 + A + d] = dk;
          slot[t * A3 + 2 * A + d] = colsum[t] * dac[d];
        }
    }
    __syncthreads();

    // 5. ctx = T(mean @ T(wproj) + T(bproj)), each direction's mean token
    mm_rt(TJ * 2, C, A, [&](int m, int k) { return sMean[m * A + k]; },
          [&](int k, int n) { return r(__ldg(wproj + (size_t)k * C + n)); },
          [&](int m, int n, float v) { sCtx[m * C + n] = r(v + r(__ldg(bproj + n))); });
    __syncthreads();

    // 6. the block's sums; every element has one owner thread
    for (int e = tid; e < P.Q_DWPROJ; e += THREADS) {
      float s = 0.f;
      if (e < P.Q_DBIAS) {  // dscale[h]
        for (int jd = 0; jd < TJ * 2; ++jd) s += sDSC[jd * nh + e];
      } else {  // dbias[pq][h]
        for (int jd = 0; jd < TJ * 2; ++jd) s += sDS[jd * 16 * nh + (e - P.Q_DBIAS)];
      }
      my[e] += s;
    }
    for (int c = tid; c < C; c += THREADS) {  // dbproj[c]
      float s = 0.f;
      for (int jd = 0; jd < TJ * 2; ++jd) s += sDctx[jd * C + c];
      my[P.Q_DBPROJ + c] += s;
    }
    for (int d = tid; d < D; d += THREADS) {  // dbmerge[d]
      float s = 0.f;
      for (int jj = 0; jj < TJ; ++jj) s += sG[jj * D + d];
      my[P.Q_DBM + d] += s;
    }
    // dwproj[a][c] += Σ mean[a]·T(dctx[c]);  dwmerge[dir·C + c][d] += Σ ctx_dir[c]·g[d]
    mm_rt(A, C, TJ * 2, [&](int m, int k) { return sMean[k * A + m]; },
          [&](int k, int n) { return r(sDctx[k * C + n]); },
          [&](int m, int n, float v) { my[P.Q_DWPROJ + m * C + n] += v; });
    mm_rt(2 * C, D, TJ, [&](int m, int k) { return sCtx[k * 2 * C + m]; },
          [&](int k, int n) { return sG[k * D + n]; },
          [&](int m, int n, float v) { my[P.Q_DWM + m * D + n] += v; });
    __syncthreads();
  }
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

// ---- the CUDA-core generic body, pass 2: one owner per grid position -----
// A block owns tiles of tp grid positions; for each it adds, in a fixed
// order, the slots of the windows that read it, then does the norm and qkv
// backward there (rounding as ngram_context_kernel_backward_math), and adds
// dwqkv and dbqkv into its slot of part.
template <typename T>
__global__ void __launch_bounds__(THREADS) ngram_bwd_positions_rt(
    const T* __restrict__ u, const float* __restrict__ wqkv, const float* __restrict__ bqkv,
    const float* __restrict__ ws, T* __restrict__ du, float* __restrict__ part, int B, int wh,
    int ww, int C, int D, int nh, int hd, int TP) {
  const Slots P(C, D, nh, hd);
  const int A = P.A, A3 = P.A3, LQ = A3 + 1, LP = C + 1;
  extern __shared__ float smem[];
  float* sU = smem;                // [TP][LP]
  float* sQK = sU + TP * LP;       // [TP][LQ]: raw q, k
  float* sDQ = sQK + TP * LQ;      // [TP][LQ]
  const int tid = threadIdx.x;
  float* my = part + (size_t)blockIdx.x * P.P2SIZE;
  for (int e = tid; e < P.P2SIZE; e += THREADS) my[e] = 0.f;
  __syncthreads();
  auto r = [](float v) { return round_as<T>(v); };

  const long total = (long)B * wh * ww;
  const long tiles = (total + TP - 1) / TP;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long pos0 = tile * TP;
    const int rows = (int)(total - pos0 < TP ? total - pos0 : TP);

    // 1. u of the tile's positions
    for (int e = tid; e < rows * C; e += THREADS) sU[(e / C) * LP + e % C] = to_f(u[pos0 * C + e]);
    __syncthreads();

    // 2. raw q and k;  the sum of the slots that read each position
    mm_rt(rows, 2 * A, C, [&](int m, int k) { return sU[m * LP + k]; },
          [&](int k, int n) { return r(__ldg(wqkv + (size_t)k * A3 + n)); },
          [&](int m, int n, float v) { sQK[m * LQ + n] = v + r(__ldg(bqkv + n)); });
    for (int e = tid; e < rows * A3; e += THREADS) {
      const int rr = e / A3, o = e % A3;
      const long pos = pos0 + rr;
      const int j = (int)(pos % ww), i = (int)((pos / ww) % wh);
      const size_t img = (size_t)(pos / ((long)wh * ww)) * wh * ww;
      float s = 0.f;
      for (int dir = 0; dir < 2; ++dir) {
        int ci[3], di[3], cj[3], dj[3];
        const int nr = readers(i, wh, dir, ci, di);
        const int nc = readers(j, ww, dir, cj, dj);
        for (int y = 0; y < nr; ++y)
          for (int x = 0; x < nc; ++x)
            s += ws[(((img + (size_t)ci[y] * ww + cj[x]) * 2 + dir) * 4 + di[y] * 2 + dj[x]) * A3 + o];
      }
      sDQ[rr * LQ + o] = s;
    }
    __syncthreads();

    // 3. the L2-norm backward in place: dt = dn·inv - t·T(Σ T(dn·t)·inv²/r)
    for (int e = tid; e < rows * 2 * nh; e += THREADS) {
      const int off = (e / (2 * nh)) * LQ + (e % (2 * nh)) * hd;
      const float* t = sQK + off;
      float* dt = sDQ + off;
      float n2 = 0.f, dot = 0.f;
      for (int d = 0; d < hd; ++d) {
        n2 += r(t[d] * t[d]);
        dot += r(dt[d] * t[d]);
      }
      const float rr = sqrtf(n2);
      const float inv = r(1.f / r(rr + 1e-12f));
      const float factor = r(dot * inv * inv / rr);
      for (int d = 0; d < hd; ++d) dt[d] = dt[d] * inv - t[d] * factor;
    }
    __syncthreads();

    // 4. du = T(dqkv) @ T(wqkv)ᵀ;  dwqkv += uᵀ T(dqkv);  dbqkv += Σ dqkv
    mm_rt(rows, C, A3, [&](int m, int k) { return r(sDQ[m * LQ + k]); },
          [&](int k, int n) { return r(__ldg(wqkv + (size_t)n * A3 + k)); },
          [&](int m, int n, float v) { store(du + (pos0 + m) * C + n, v); });
    mm_rt(C, A3, rows, [&](int m, int k) { return sU[k * LP + m]; },
          [&](int k, int n) { return r(sDQ[k * LQ + n]); },
          [&](int m, int n, float v) { my[m * A3 + n] += v; });
    for (int o = tid; o < A3; o += THREADS) {
      float s = 0.f;
      for (int rr = 0; rr < rows; ++rr) s += sDQ[rr * LQ + o];
      my[P.R_DBQKV + o] += s;
    }
    __syncthreads();
  }
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
    // 1. the offsets of the slots that read each position, at fixed places
    //    (direction, row reader, column reader), then u of the tile's
    //    positions (zero past the end) and the sums of those slots in that
    //    order
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

// ---- the bfloat16 generic body: tensor cores at any width ------------------
//
// Every bf16 geometry other than the flagship's where `ngram_g::plan` finds a
// layout (C and D multiples of 8 up to 128, head_dim <= 32, both passes'
// shared memory within a block).  It computes what the bodies above compute
// and rounds where the flagship body rounds (ngram_context_kernel_backward_math
// is its plain version too), with the widths at run time: C, D and the
// attention width A = nh·hd padded to 16 (CP, DP, AP), zeros in the staged
// weights, so a padded row or column adds nothing.  The heads need no
// padding of their own: only the products are on the tensor cores, each
// over whole 16-column chunks of the padded widths, and the per-head work
// (4x4 softmaxes, L2 norms and their backward) reads its head's hd columns
// on the CUDA cores.  Every product runs as a list of 16x16 jobs (or units
// of a parameter cotangent) dealt to the warps in a fixed order, so that
// registers stay bounded at any width and each element of a block's sums has
// one owner.
//   Pass 1 (ngram_bwd_cells_gmma, 8 warps) walks the flagship's tiles, 2
//   grid rows x 4 cells (16 (cell, direction) rows, one m-tile; 4 x 6
//   staged positions): u and g by cp.async; q/k/v of the staged positions
//   and dctx = g·wm_dirᵀ; the norms of q and k, dacc = 0.25·dctxc·wprojᵀ,
//   dbproj and dbmerge; the flagship body's step 4 with a group of 8 or 4
//   lanes per (cell, direction, head), its head's channels split over the
//   group; ctx = bf16(mean·wproj + bproj), dscale and dbias; dwproj +=
//   meanᵀ·dctxc and dwmerge += ctxᵀ·g.  The demo stage-1 grid (u [8, 8, 8,
//   16]) gives 64 tiles, one a block: a smaller tile would shorten no
//   block's chain (its phases are one m-tile and one group of lanes per
//   (cell, direction, head) deep at any tile of 16 rows or fewer), and the
//   time there is the blocks' fixed latency (parameter staging, barriers)
//   and the launches, not bytes or operations.
//   Pass 2 (ngram_bwd_positions_gmma, 8 warps) walks tiles of 16 grid
//   positions: the gather of the slots (one owner per slot, as the bodies
//   above), raw q and k again, the L2-norm backward, then du = dc·wqkvᵀ and
//   dwqkv += uᵀ·dc.
// The block's sums of dscale, dbias, dwproj, dbproj, dwmerge and dbmerge
// (pass 1) and of dwqkv and dbqkv (pass 2) are float32 in shared memory in
// Slots' layout, added to by their owners tile after tile, and written to
// the block's slot at the end; ngram_bwd_reduce adds the slots.
namespace ngram_g {

constexpr unsigned NO_SLOT = 0xffffffffu;  // pass 2: a (direction, reader, reader) with no window

// The offset (0 or 1) in its window, along one axis of length n, at which
// the window of cell c in direction dir reads grid index i (the readers'
// rule above), or -1 where it does not read i (or c is outside the grid)
__device__ __forceinline__ int reader_offset(int i, int c, int n, int dir) {
  if (c < 0 || c >= n) return -1;
  for (int o = 0; o < 2; ++o) {
    int r = dir == 0 ? c + o : c - 1 + o;
    if (r == n) r = n - 2;
    if (r < 0) r = 1;
    if (r == i) return o;
  }
  return -1;
}

__global__ void __launch_bounds__(THREADS1) ngram_bwd_cells_gmma(
    const __nv_bfloat16* __restrict__ u, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ wqkv, const float* __restrict__ bqkv, const float* __restrict__ ls,
    const float* __restrict__ table, const float* __restrict__ wproj,
    const float* __restrict__ bproj, const float* __restrict__ wmerge, float* __restrict__ ws,
    float* __restrict__ part, int B, int wh, int ww, Plan P) {
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  auto bf16_at = [&](int off) { return reinterpret_cast<__nv_bfloat16*>(sm + off); };
  auto f32_at = [&](int off) { return reinterpret_cast<float*>(sm + off); };
  __nv_bfloat16 *s_wqkv = bf16_at(P.c_wqkv), *s_wproj = bf16_at(P.c_wproj), *s_wm = bf16_at(P.c_wm);
  float *s_bqkv = f32_at(P.c_bqkv), *s_bproj = f32_at(P.c_bproj), *s_scale = f32_at(P.c_scale);
  float* s_bias = f32_at(P.c_bias);
  __nv_bfloat16 *s_u = bf16_at(P.c_u), *s_q = bf16_at(P.c_q), *s_g = bf16_at(P.c_g);
  __nv_bfloat16 *s_dctxc = bf16_at(P.c_dctxc), *s_mean = bf16_at(P.c_mean), *s_ctx = bf16_at(P.c_ctx);
  float *s_qk = f32_at(P.c_qk), *s_dctx = f32_at(P.c_dctx), *s_dacc = f32_at(P.c_dacc);
  float *s_ds = f32_at(P.c_ds), *s_dsc = f32_at(P.c_dsc), *s_acc = f32_at(P.c_acc);
  const Slots sl(P.C, P.D, P.nh, P.hd);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
  const int C = P.C, D = P.D, nh = P.nh, hd = P.hd, A = P.A, A3 = P.A3;
  const int CP = P.CP, DP = P.DP, AP = P.AP, LU = P.LU, LQKV = P.LQKV, LM = P.LM, LA = P.LA;

  // once per block: zeros (every padding, the sums); the parameters come
  // with the first tile
  for (int i = tid; i < (int)(P.bytes1 / 16); i += THREADS1) zero16(sm + 16 * i);
  const int rowtiles = (wh + S - 1) / S, coltiles = (ww + TJ - 1) / TJ;
  const int tiles = B * rowtiles * coltiles;
  const int nqc = 3 * AP / 16, ncc = CP / 16, nac = AP / 16, ndk = DP / 16;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int j0 = (tile % coltiles) * TJ;
    const int i0 = ((tile / coltiles) % rowtiles) * S;
    const int b = tile / (coltiles * rowtiles);
    __syncthreads();  // the zeros are down; the last tile's step 6 is done
    // 1. g of the tile's cells (zero outside the grid), u of its positions
    copy_rows(s_g, LM, CELLS, D, [&](int cell) -> const __nv_bfloat16* {
      const int i = i0 + cell / TJ, j = j0 + cell % TJ;
      return i < wh && j < ww ? g + (((size_t)b * wh + i) * ww + j) * D : nullptr;
    }, tid, THREADS1);
    copy_rows(s_u, LU, NPOS, C, [&](int pos) -> const __nv_bfloat16* {
      const int gr = ngram::reflect(i0 - 1 + pos / W2, wh), gc = ngram::reflect(j0 - 1 + pos % W2, ww);
      return u + (((size_t)b * wh + gr) * ww + gc) * C;
    }, tid, THREADS1);
    cp_async_commit();
    if (tile == (int)blockIdx.x) {  // the block's first tile: the parameters, while u and g land
      stage_params(P, tid, THREADS1, wqkv, bqkv, s_wqkv, s_bqkv, wproj, wmerge, bproj, ls, table,
                   s_wproj, s_wm, s_bproj, s_scale, s_bias);
    }
    cp_async_wait_all();
    __syncthreads();

    // 2. q/k/v = u·wqkv + bqkv of the staged positions (q, k float32, v
    //    bf16);  dctx = g·wm_dirᵀ (float32, and bf16 as dctxc)
    for (int job = warp; job < 2 * nqc + 2 * ncc; job += WARPS1) {
      if (job < 2 * nqc) {
        qkv_job(P, s_u, s_wqkv, s_bqkv, s_q, s_qk, job / nqc, job % nqc, lane);
      } else {
        float acc[2][4] = {};
        const int dir = (job - 2 * nqc) / ncc, nc = (job - 2 * nqc) % ncc;
        for (int kk = 0; kk < ndk; ++kk) {
          uint32_t a[4];
          load_a(a, s_g, LM, 0, 16 * kk, lane);
          mma_pair(acc[0], acc[1], a, s_wm, LM, dir * CP + 16 * nc, 16 * kk, lane);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int cell = gq, c = 16 * nc + 8 * n + 2 * tq;  // rows 8..15 are past CELLS
          s_dctx[cell * 2 * CP + dir * CP + c] = acc[n][0];
          s_dctx[cell * 2 * CP + dir * CP + c + 1] = acc[n][1];
          sts32(s_dctxc + (2 * cell + dir) * LU + c, pack_bf16(acc[n][0], acc[n][1]));
        }
      }
    }
    __syncthreads();

    // 3. dacc = 0.25·dctxc·wprojᵀ;  q_n, k_n as the forward rounds them;
    //    the block's dbproj and dbmerge
    for (int nc = warp; nc < nac; nc += WARPS1) {
      float acc[2][4] = {};
      for (int kk = 0; kk < ncc; ++kk) {
        uint32_t a[4];
        load_a(a, s_dctxc, LU, 0, 16 * kk, lane);
        mma_pair(acc[0], acc[1], a, s_wproj, LU, 16 * nc, 16 * kk, lane);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s_dacc[(gq + 8 * (e >> 1)) * AP + 16 * nc + 8 * n + 2 * tq + (e & 1)] = acc[n][e] * 0.25f;
    }
    norm_rows(P, s_qk, s_q, NPOS, tid, THREADS1);
    for (int e = tid; e < C + D; e += THREADS1) {
      float s = 0.f;
      if (e < C) {  // dbproj[c]: each direction's sum over the cells
        float s2 = 0.f;
        for (int cell = 0; cell < CELLS; ++cell) {
          s += s_dctx[cell * 2 * CP + e];
          s2 += s_dctx[cell * 2 * CP + CP + e];
        }
        s += s2;
        s_acc[sl.Q_DBPROJ + e] += s;
      } else {  // dbmerge[d]
        for (int cell = 0; cell < CELLS; ++cell) s += __bfloat162float(s_g[cell * LM + e - C]);
        s_acc[sl.Q_DBM + e - C] += s;
      }
    }
    __syncthreads();

    // 4. one group of G lanes per (cell, direction, head) (G = 8 where the
    //    tile's items fill the block so, else 4), lane t of the group taking
    //    the head's channels d = t, t + G, ... and the sums over d added
    //    across the group: the softmax again, the mean token, then the
    //    window's cotangents into its workspace slots
    const int items = CELLS * 2 * nh, G = items * 8 <= THREADS1 ? 8 : 4, tg = tid & (G - 1);
    for (int base = 0; base < items; base += THREADS1 / G) {  // the same trip count in every lane
      const int e = base + tid / G, it = e < items ? e : 0;    // a spare group writes nothing
      const bool live = e < items;
      const int cell = it / (2 * nh), dir = (it / nh) % 2, h = it % nh;
      const int row = 2 * cell + dir;
      int tok[4];
      ngram::window_tokens<TJ>(cell / TJ, cell % TJ, dir, tok);
      const __nv_bfloat16* qh[4];  // + AP: k_n, + 2AP: v
#pragma unroll
      for (int p = 0; p < 4; ++p) qh[p] = s_q + tok[p] * LQKV + h * hd;
      float cs[16], a[16], ab[16];  // ab: the softmax weights in bf16
      const float sc = s_scale[h];
      window_softmax(qh, AP, hd, tg, G, sc, s_bias + h * 16, cs, a, ab);
      const float* dacc = s_dacc + row * AP + h * hd;
      float da[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = tg; d < hd; d += G) {
        float vv[4], acc = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) vv[q] = ngram::ld_bf(qh[q] + 2 * AP + d);
#pragma unroll
        for (int pq = 0; pq < 16; ++pq) acc = fmaf(ab[pq], vv[pq & 3], acc);
        if (live) s_mean[row * LA + h * hd + d] = __float2bfloat16(acc * 0.25f);
        const float dc = ngram::bf(dacc[d]);
#pragma unroll
        for (int q = 0; q < 4; ++q) da[q] += ngram::bf(dc * vv[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) da[q] = group_sum(da[q], G);
      float dp[16], dsc = 0.f;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float* ap = a + 4 * p;
        const float inner = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(ap[0], da[0]),
                                                          __fmul_rn(ap[1], da[1])),
                                                __fmul_rn(ap[2], da[2])),
                                      __fmul_rn(ap[3], da[3]));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float ds = ap[q] * (da[q] - inner);
          if (live && tg == 0) s_ds[(row * 16 + 4 * p + q) * nh + h] = ds;
          dsc = fmaf(ds, cs[4 * p + q], dsc);
          dp[4 * p + q] = ngram::bf(ds * sc);
        }
      }
      if (live && tg == 0) s_dsc[row * nh + h] = dsc;
      const int i = i0 + cell / TJ, j = j0 + cell % TJ;
      if (!live || i >= wh || j >= ww) continue;
      float* slot = ws + ((((size_t)b * wh + i) * ww + j) * 2 + dir) * 4 * A3 + h * hd;
      for (int d = tg; d < hd; d += G) {
        float qv[4], kv[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) qv[p] = ngram::ld_bf(qh[p] + d), kv[p] = ngram::ld_bf(qh[p] + AP + d);
        const float dac = dacc[d];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float dq = 0.f, dk = 0.f, dv = 0.f;
#pragma unroll
          for (int o = 0; o < 4; ++o) {
            dq = fmaf(dp[4 * t + o], kv[o], dq);
            dk = fmaf(dp[4 * o + t], qv[o], dk);
            dv = __fadd_rn(dv, __fmul_rn(ab[4 * o + t], dac));
          }
          slot[t * A3 + d] = dq;
          slot[t * A3 + A + d] = dk;
          slot[t * A3 + 2 * A + d] = dv;
        }
      }
    }
    __syncthreads();

    // 5. ctx = bf16(mean·wproj + bproj);  the block's dscale and dbias
    for (int nc = warp; nc < ncc; nc += WARPS1)
      project_job(P, s_mean, s_wproj, s_bproj, s_ctx, 0, nc, lane);
    for (int e = tid; e < 17 * nh; e += THREADS1) {
      float s = 0.f;
      if (e < nh) {
        for (int row = 0; row < ROWS; ++row) s += s_dsc[row * nh + e];
      } else {
        for (int row = 0; row < ROWS; ++row) s += s_ds[row * 16 * nh + e - nh];
      }
      s_acc[e] += s;
    }
    __syncthreads();

    // 6. dwproj += meanᵀ·dctxc (K = the 16 rows);  dwmerge += ctxᵀ·g (K = the
    //    cells, zero rows past CELLS); each unit's elements owned by one lane
    const int nwp = nac * ncc, nwm = 2 * ncc * ndk;
    for (int unit = warp; unit < nwp + nwm; unit += WARPS1) {
      float acc[2][4] = {};
      uint32_t a[4];
      if (unit < nwp) {
        const int ra = unit / ncc, rc = unit % ncc;
        load_a_t(a, s_mean, LA, 16 * ra, 0, lane);
        mma_pair_t(acc[0], acc[1], a, s_dctxc, LU, 16 * rc, 0, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * ra + gq + 8 * (e >> 1), c = 16 * rc + 8 * n + 2 * tq + (e & 1);
            if (r < A && c < C) s_acc[sl.Q_DWPROJ + r * C + c] += acc[n][e];
          }
      } else {
        const int ra = (unit - nwp) / ndk, rc = (unit - nwp) % ndk;
        load_a_t(a, s_ctx, P.LCX, 16 * ra, 0, lane);
        mma_pair_t(acc[0], acc[1], a, s_g, LM, 16 * rc, 0, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * ra + gq + 8 * (e >> 1), d = 16 * rc + 8 * n + 2 * tq + (e & 1);
            const int dir = r / CP, c = r % CP;
            if (c < C && d < D) s_acc[sl.Q_DWM + (dir * C + c) * D + d] += acc[n][e];
          }
      }
    }
  }
  __syncthreads();
  float* my = part + (size_t)blockIdx.x * sl.P1SIZE;
  for (int e = tid; e < sl.P1SIZE; e += THREADS1) my[e] = s_acc[e];
}

__global__ void __launch_bounds__(THREADS2) ngram_bwd_positions_gmma(
    const __nv_bfloat16* __restrict__ u, const float* __restrict__ wqkv,
    const float* __restrict__ bqkv, const float* __restrict__ ws, __nv_bfloat16* __restrict__ du,
    float* __restrict__ part, int B, int wh, int ww, Plan P) {
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(sm + P.p_wqkv);
  float* s_b = reinterpret_cast<float*>(sm + P.p_bqkv);
  __nv_bfloat16* s_u = reinterpret_cast<__nv_bfloat16*>(sm + P.p_u);
  float* s_qk = reinterpret_cast<float*>(sm + P.p_qk);
  float* s_d = reinterpret_cast<float*>(sm + P.p_d);
  __nv_bfloat16* s_dc = reinterpret_cast<__nv_bfloat16*>(sm + P.p_dc);
  float* s_acc = reinterpret_cast<float*>(sm + P.p_acc);  // dwqkv [C][A3], dbqkv [A3]
  unsigned* s_slot = reinterpret_cast<unsigned*>(sm + P.p_slot);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
  const int C = P.C, nh = P.nh, hd = P.hd, A = P.A, A3 = P.A3, AP = P.AP, LU = P.LU;
  const int LQKV = P.LQKV, LQK = P.LQK, LD = P.LD;
  for (int i = tid; i < (int)(P.bytes2 / 16); i += THREADS2) zero16(sm + 16 * i);
  __syncthreads();

  const long total = (long)B * wh * ww;
  const int tiles = (int)((total + TP - 1) / TP);
  const int ncc = P.CP / 16, nqk = 2 * AP / 16, nq3 = 3 * AP / 16;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long pos0 = (long)tile * TP;
    // 1. the offsets of the slots that read each position, at fixed places
    //    (direction, row reader, column reader), then u of the tile's
    //    positions (zero past the end) and the sums of those slots in that
    //    order
    for (int e = tid; e < TP * MAXSLOT; e += THREADS2) {
      const int r = e / MAXSLOT, k = e % MAXSLOT, dir = k / 9, y = k / 3 % 3, x = k % 3;
      const int pos = (int)pos0 + r;  // 32-bit arithmetic, as the flagship body's offsets
      const int j = pos % ww, i = pos / ww % wh, ci = i - 1 + y, cj = j - 1 + x;
      const int di = reader_offset(i, ci, wh, dir), dj = reader_offset(j, cj, ww, dir);
      s_slot[e] = pos < total && di >= 0 && dj >= 0
                      ? ((((unsigned)(pos / (wh * ww)) * wh + ci) * ww + cj) * 2 + dir) * 4 * A3 +
                            (di * 2 + dj) * A3
                      : NO_SLOT;
    }
    __syncthreads();  // the offsets are set; the last tile is done
    copy_rows(s_u, LU, TP, C, [&](int r) -> const __nv_bfloat16* {
      return pos0 + r < total ? u + (pos0 + r) * C : nullptr;
    }, tid, THREADS2);
    cp_async_commit();
    // the slots of GATHER items a thread at a time, their loads in flight
    // together, each item's then added in order
    for (int e0 = tid; e0 < TP * A3; e0 += GATHER * THREADS2) {
      float v[GATHER][MAXSLOT];
#pragma unroll
      for (int j = 0; j < GATHER; ++j) {
        const int e = e0 + j * THREADS2, r = e < TP * A3 ? e / A3 : 0, o = e % A3;
        const unsigned* off = s_slot + r * MAXSLOT;
        const bool in = e < TP * A3;
#pragma unroll
        for (int k = 0; k < MAXSLOT; ++k) v[j][k] = in && off[k] != NO_SLOT ? __ldg(ws + off[k] + o) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < GATHER; ++j) {
        const int e = e0 + j * THREADS2;
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < MAXSLOT; ++k) s += v[j][k];
        if (e < TP * A3) s_d[(e / A3) * LD + e % A3] = s;
      }
    }
    if (tile == (int)blockIdx.x)  // the block's first tile: the parameters, with the loads above
      stage_params(P, tid, THREADS2, wqkv, bqkv, s_w, s_b, nullptr, nullptr, nullptr, nullptr,
                   nullptr, nullptr, nullptr, nullptr, nullptr, nullptr);
    cp_async_wait_all();
    __syncthreads();

    // 2. raw q and k again;  dc of v = bf16(dv)
    for (int nc = warp; nc < nqk; nc += WARPS2) {
      float acc[2][4] = {};
      for (int kk = 0; kk < ncc; ++kk) {
        uint32_t a[4];
        load_a(a, s_u, LU, 0, 16 * kk, lane);
        mma_pair_t(acc[0], acc[1], a, s_w, LQKV, 16 * nc, 16 * kk, lane);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 16 * nc + 8 * n + 2 * tq + (e & 1);
          s_qk[(gq + 8 * (e >> 1)) * LQK + col] = acc[n][e] + s_b[col];
        }
    }
    for (int e = tid; e < TP * A; e += THREADS2) {
      const int r = e / A, a = e % A;
      s_dc[r * LQKV + 2 * AP + a] = __float2bfloat16(s_d[r * LD + 2 * A + a]);
    }
    __syncthreads();

    // 3. the L2-norm backward in place, one (position, q|k, head) per thread:
    //    dt = dn·inv - t·bf16(Σ bf16(dn·t) · inv² / r)
    for (int e = tid; e < TP * 2 * nh; e += THREADS2) {
      const int r = e / (2 * nh), blk = (e / nh) % 2, h = e % nh;
      float* dn = s_d + r * LD + blk * A + h * hd;
      __nv_bfloat16* dc = s_dc + r * LQKV + blk * AP + h * hd;
      if (pos0 + r >= total) {  // rows past the end add nothing
        for (int d = 0; d < hd; ++d) {
          dn[d] = 0.f;
          dc[d] = __float2bfloat16(0.f);
        }
        continue;
      }
      const float* t = s_qk + r * LQK + blk * AP + h * hd;
      float n2 = 0.f, gh = 0.f;
      for (int d = 0; d < hd; ++d) {
        n2 += ngram::bf(t[d] * t[d]);
        gh += ngram::bf(dn[d] * t[d]);
      }
      const float rr = sqrtf(n2);
      const float inv = ngram::bf(1.f / ngram::bf(rr + 1e-12f));
      const float fb = ngram::bf(gh * inv * inv / rr);
      for (int d = 0; d < hd; ++d) {
        const float dt = __fsub_rn(__fmul_rn(dn[d], inv), __fmul_rn(t[d], fb));
        dn[d] = dt;
        dc[d] = __float2bfloat16(dt);
      }
    }
    __syncthreads();

    // 4. dwqkv += uᵀ·dc (units), du = dc·wqkvᵀ (chunks of 16 channels), dealt
    //    to the warps in a fixed order;  dbqkv += Σ dt
    const int nun = ncc * nq3;
    for (int job = warp; job < nun + ncc; job += WARPS2) {
      float acc[2][4] = {};
      if (job < nun) {
        const int rc = job / nq3, rq = job % nq3;
        uint32_t a[4];
        load_a_t(a, s_u, LU, 16 * rc, 0, lane);
        mma_pair_t(acc[0], acc[1], a, s_dc, LQKV, 16 * rq, 0, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 16 * rc + gq + 8 * (e >> 1), col = 16 * rq + 8 * n + 2 * tq + (e & 1);
            const int a2 = col % AP;
            if (c < C && a2 < A) s_acc[c * A3 + (col / AP) * A + a2] += acc[n][e];
          }
      } else {
        const int nc = job - nun;
        for (int kk = 0; kk < nq3; ++kk) {
          uint32_t a[4];
          load_a(a, s_dc, LQKV, 0, 16 * kk, lane);
          mma_pair(acc[0], acc[1], a, s_w, LQKV, 16 * nc, 16 * kk, lane);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long pos = pos0 + gq + 8 * h;
          if (pos >= total) continue;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int c = 16 * nc + 8 * n + 2 * tq;
            if (c < C) sts32(du + pos * C + c, pack_bf16(acc[n][2 * h], acc[n][2 * h + 1]));
          }
        }
      }
    }
    for (int e = tid; e < A3; e += THREADS2) {
      float s = 0.f;
      for (int r = 0; r < TP; ++r) s += s_d[r * LD + e];
      s_acc[C * A3 + e] += s;
    }
    __syncthreads();  // step 4 is done with u, dc and dt
  }
  float* my = part + (size_t)blockIdx.x * (C * A3 + A3);
  for (int e = tid; e < C * A3 + A3; e += THREADS2) my[e] = s_acc[e];
}

// the two passes' persistent grids at this plan (the SMs times the blocks
// one holds, as the card reports them), asked once per device and plan
inline int grids(const Plan& P, long* grid1, long* grid2) {
  static int cache1[64][3] = {}, cache2[64][3] = {};
  int g1 = 0, g2 = 0;
  int err = tmar::persistent_grid(ngram_bwd_cells_gmma, P.bytes1, THREADS1, cache1, &g1);
  if (err == 0) err = tmar::persistent_grid(ngram_bwd_positions_gmma, P.bytes2, THREADS2, cache2, &g2);
  *grid1 = g1, *grid2 = g2;
  return err;
}

}  // namespace ngram_g

// The reduce of both passes' partial sums into the cotangents as the
// wrapper returns them: dwqkv [C, 3A], dbqkv [3A], dlogit_scale [nh]
// (dscale · exp(min(ls, ln 100)), zero above the clip), dtable [9, nh]
// (dbias folded by the transpose of the 2x2 gather), dwproj [A, C], dbproj
// [C], dwmerge [2C, D], dbmerge [D].  With round_bf16 it rounds dwqkv,
// dbqkv, dwproj, dbproj and dwmerge to bf16 values as it writes them (the
// JAX backward's casts to the parameters' dtype, pallas_ngram.py:446-467).
// A block of 8 warps owns 32 consecutive outputs: warp w adds the partials
// of blocks w, w + 8, ... (coalesced across the lanes), then the eight
// warps' sums are added in warp order.  No atomics: two runs give the same
// bits.  Every body's slots have the layout of Slots.  NH, HD > 0 fix the
// tensor-core body's widths at compile time (its offsets folded into
// constants); NH = 0 reads the widths from the arguments.
template <int NH, int HD>
__global__ void __launch_bounds__(256) ngram_bwd_reduce(const float* __restrict__ part1,
                                                        int blocks1,
                                                        const float* __restrict__ part2,
                                                        int blocks2, const float* __restrict__ ls,
                                                        float* __restrict__ out, int C_, int D_,
                                                        int nh_, int hd_, int round_bf16) {
  const int nh = NH ? NH : nh_;
  const Slots P(NH ? C : C_, NH ? D : D_, nh, NH ? HD : hd_);
  const int O_DLS = P.P2SIZE, O_DTABLE = O_DLS + nh, O_DWPROJ = O_DTABLE + 9 * nh;
  const int O_DBM = O_DWPROJ + P.A * P.C + P.C + 2 * P.C * P.D, TOTAL = P.total();
  __shared__ float sums[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  float s = 0.f;
  auto add = [&](const float* __restrict__ part, int stride, int blocks, int k) {
#pragma unroll 8
    for (int b = w; b < blocks; b += 8) s += part[(size_t)b * stride + k];
  };
  if (e < O_DLS) {
    add(part2, P.P2SIZE, blocks2, e);
  } else if (e < O_DTABLE) {
    add(part1, P.P1SIZE, blocks1, e - O_DLS);
  } else if (e < O_DWPROJ) {
    const int t = (e - O_DTABLE) / nh, h = (e - O_DTABLE) % nh;
    for (int pq = 0; pq < 16; ++pq) {
      const int p = pq >> 2, q = pq & 3;
      if (((p >> 1) - (q >> 1) + 1) * 3 + ((p & 1) - (q & 1) + 1) == t)
        add(part1, P.P1SIZE, blocks1, P.Q_DBIAS + pq * nh + h);
    }
  } else if (e < TOTAL) {
    add(part1, P.P1SIZE, blocks1, P.Q_DWPROJ + e - O_DWPROJ);
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
int occupancy(long* per1, long* per2) {
  using L1 = CellsMma<NH, HD>;
  using L2 = PositionsMma<NH, HD>;
  static int occ[2] = {0, 0};  // resident blocks per SM of the two passes, asked once
  if (occ[0] == 0) {
    auto k1 = ngram_bwd_cells_mma<NH, HD>;
    auto k2 = ngram_bwd_positions_mma<NH, HD>;
    cudaError_t err =
        cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, L1::BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[0], k1, L1::THREADS, L1::BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[1], k2, L2::THREADS, L2::BYTES);
    if (err != cudaSuccess) return (int)err;
    if (occ[0] < 1 || occ[1] < 1) return (int)cudaErrorInvalidConfiguration;
  }
  *per1 = occ[0];
  *per2 = occ[1];
  return 0;
}

// the generic body's shared memory of its two passes on tiles of tj cells
// and tp positions, and those tiles: each the most of TJ (TP), half that,
// ..., 1 whose block fits (tmar_torch/ops/envelope.py: ngram_bwd_bytes and
// ngram_tiles count and pick the same)
size_t cells_bytes(int C_, int D_, int nh, int hd, int tj) {
  const size_t A = (size_t)nh * hd, npos = 3 * (tj + 2);
  return 4 * (npos * C_ + npos * (3 * A + 1) + tj * ((size_t)D_ + 2 * C_ + 2 * A + 2 * A +
                                                    2 * C_ + 2 * 16 * nh + 2 * nh));
}
size_t positions_bytes(int C_, int nh, int hd, int tp) {
  return 4 * (size_t)tp * ((C_ + 1) + 2 * (3 * nh * hd + 1));
}
int rt_cells(int C_, int D_, int nh, int hd) {
  int tj = TJ;
  while (tj > 1 && cells_bytes(C_, D_, nh, hd, tj) > MAX_SMEM) tj /= 2;
  return tj;
}
int rt_positions(int C_, int nh, int hd) {
  int tp = TP;
  while (tp > 1 && positions_bytes(C_, nh, hd, tp) > MAX_SMEM) tp /= 2;
  return tp;
}

// the generic body's resident blocks per SM of its two passes (at most 8),
// as the card reports them for this shared memory
template <typename T>
int rt_occupancy(size_t b1, size_t b2, long* per1, long* per2) {
  auto cells = ngram_bwd_cells_rt<T>;
  auto positions = ngram_bwd_positions_rt<T>;
  int n1 = 0, n2 = 0;
  cudaError_t err = cudaFuncSetAttribute(cells, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(positions, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b2);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n1, cells, THREADS, b1);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n2, positions, THREADS, b2);
  if (err != cudaSuccess) return (int)err;
  if (n1 < 1 || n2 < 1) return (int)cudaErrorInvalidConfiguration;
  *per1 = n1 < 8 ? n1 : 8;
  *per2 = n2 < 8 ? n2 : 8;
  return 0;
}

template <typename T>
int generic_occupancy(int C_, int D_, int nh, int hd, long* per1, long* per2) {
  const size_t b1 = cells_bytes(C_, D_, nh, hd, rt_cells(C_, D_, nh, hd));
  const size_t b2 = positions_bytes(C_, nh, hd, rt_positions(C_, nh, hd));
  if (b1 > MAX_SMEM || b2 > MAX_SMEM) return (int)cudaErrorInvalidValue;
  return rt_occupancy<T>(b1, b2, per1, per2);
}

int plan(int B, int wh, int ww, int C_, int D_, int nh, int hd, int is_bf16, int sms,
         Plan* out) {
  const Slots P(C_, D_, nh, hd);
  const long cells = (long)B * wh * ww;
  long tiles1, tiles2, per1, per2;
  const ngram_g::Body body = ngram_g::body(C_, D_, nh, hd, is_bf16);
  if (body == ngram_g::TENSOR_CORE) {
    long grid1, grid2;
    const int rc = ngram_g::grids(ngram_g::make_plan(C_, D_, nh, hd), &grid1, &grid2);
    if (rc != 0) return rc;
    per1 = (grid1 + sms - 1) / sms, per2 = (grid2 + sms - 1) / sms;
    tiles1 = (long)B * ((wh + ngram_g::S - 1) / ngram_g::S) * ((ww + ngram_g::TJ - 1) / ngram_g::TJ);
    tiles2 = (cells + ngram_g::TP - 1) / ngram_g::TP;
  } else if (body == ngram_g::FLAGSHIP) {
    const int rc = nh == 6 ? occupancy<6, 5>(&per1, &per2) : occupancy<4, 8>(&per1, &per2);
    if (rc != 0) return rc;
    using L1 = CellsMma<6, 5>;  // the tiles are the same at both head counts
    using L2 = PositionsMma<6, 5>;
    tiles1 = (long)B * ((wh + L1::S - 1) / L1::S) * ((ww + L1::TJ - 1) / L1::TJ);
    tiles2 = (cells + L2::TP - 1) / L2::TP;
  } else {
    const int tj = rt_cells(C_, D_, nh, hd), tp = rt_positions(C_, nh, hd);
    tiles1 = (long)B * wh * ((ww + tj - 1) / tj);
    tiles2 = (cells + tp - 1) / tp;
    const int rc = is_bf16 ? generic_occupancy<__nv_bfloat16>(C_, D_, nh, hd, &per1, &per2)
                           : generic_occupancy<float>(C_, D_, nh, hd, &per1, &per2);
    if (rc != 0) return rc;
  }
  out->blocks1 = (int)(tiles1 < per1 * sms ? tiles1 : per1 * sms);
  out->blocks2 = (int)(tiles2 < per2 * sms ? tiles2 : per2 * sms);
  out->ws = (size_t)cells * 2 * 4 * P.A3;
  out->part1 = (size_t)out->blocks1 * P.P1SIZE;
  out->floats = out->ws + out->part1 + (size_t)out->blocks2 * P.P2SIZE;
  return 0;
}

template <int NH, int HD>
int launch_mma(const void* const* p, void* du, float* ws, float* part1, float* part2,
               const Plan& pl, int B, int wh, int ww, cudaStream_t stream) {
  if (((uintptr_t)p[0] | (uintptr_t)p[1] | (uintptr_t)du) & 15) return (int)cudaErrorMisalignedAddress;
  using L1 = CellsMma<NH, HD>;
  using L2 = PositionsMma<NH, HD>;
  ngram_bwd_cells_mma<NH, HD><<<pl.blocks1, L1::THREADS, L1::BYTES, stream>>>(
      (const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[1], (const float*)p[2],
      (const float*)p[3], (const float*)p[4], (const float*)p[5], (const float*)p[6],
      (const float*)p[7], (const float*)p[8], ws, part1, B, wh, ww);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ngram_bwd_positions_mma<NH, HD><<<pl.blocks2, L2::THREADS, L2::BYTES, stream>>>(
      (const __nv_bfloat16*)p[0], (const float*)p[2], (const float*)p[3], ws,
      (__nv_bfloat16*)du, part2, B, wh, ww);
  return (int)cudaGetLastError();
}

int launch_gmma(const void* const* p, void* du, float* ws, float* part1, float* part2,
                const Plan& pl, int B, int wh, int ww, int C_, int D_, int nh, int hd,
                cudaStream_t stream) {
  if (((uintptr_t)p[0] | (uintptr_t)p[1] | (uintptr_t)du) & 15) return (int)cudaErrorMisalignedAddress;
  const ngram_g::Plan G = ngram_g::make_plan(C_, D_, nh, hd);
  ngram_g::ngram_bwd_cells_gmma<<<pl.blocks1, ngram_g::THREADS1, G.bytes1, stream>>>(
      (const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[1], (const float*)p[2],
      (const float*)p[3], (const float*)p[4], (const float*)p[5], (const float*)p[6],
      (const float*)p[7], (const float*)p[8], ws, part1, B, wh, ww, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ngram_g::ngram_bwd_positions_gmma<<<pl.blocks2, ngram_g::THREADS2, G.bytes2, stream>>>(
      (const __nv_bfloat16*)p[0], (const float*)p[2], (const float*)p[3], ws,
      (__nv_bfloat16*)du, part2, B, wh, ww, G);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_generic(const void* const* p, void* du, float* ws, float* part1, float* part2,
                   const Plan& pl, int B, int wh, int ww, int C_, int D_, int nh, int hd,
                   cudaStream_t stream) {
  auto cells = ngram_bwd_cells_rt<T>;
  auto positions = ngram_bwd_positions_rt<T>;
  const int tj = rt_cells(C_, D_, nh, hd), tp = rt_positions(C_, nh, hd);
  const size_t b1 = cells_bytes(C_, D_, nh, hd, tj), b2 = positions_bytes(C_, nh, hd, tp);
  cudaError_t err = cudaFuncSetAttribute(cells, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(positions, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b2);
  if (err != cudaSuccess) return (int)err;
  cells<<<pl.blocks1, THREADS, b1, stream>>>(
      (const T*)p[0], (const T*)p[1], (const float*)p[2], (const float*)p[3],
      (const float*)p[4], (const float*)p[5], (const float*)p[6], (const float*)p[7],
      (const float*)p[8], ws, part1, B, wh, ww, C_, D_, nh, hd, tj);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  positions<<<pl.blocks2, THREADS, b2, stream>>>(
      (const T*)p[0], (const float*)p[2], (const float*)p[3], ws, (T*)du, part2, B, wh, ww, C_,
      D_, nh, hd, tp);
  return (int)cudaGetLastError();
}

int launch(const void* const* p, void* du, void* scratch, void* dparams, int B, int wh, int ww,
           int C_, int D_, int nh, int hd, int is_bf16, int sms, cudaStream_t stream) {
  Plan pl;
  int rc = plan(B, wh, ww, C_, D_, nh, hd, is_bf16, sms, &pl);
  if (rc != 0) return rc;
  float* ws = (float*)scratch;
  float* part1 = ws + pl.ws;
  float* part2 = part1 + pl.part1;
  const ngram_g::Body body = ngram_g::body(C_, D_, nh, hd, is_bf16);
  if (body == ngram_g::FLAGSHIP)
    rc = nh == 6 ? launch_mma<6, 5>(p, du, ws, part1, part2, pl, B, wh, ww, stream)
                 : launch_mma<4, 8>(p, du, ws, part1, part2, pl, B, wh, ww, stream);
  else if (body == ngram_g::TENSOR_CORE)
    rc = launch_gmma(p, du, ws, part1, part2, pl, B, wh, ww, C_, D_, nh, hd, stream);
  else if (is_bf16)
    rc = launch_generic<__nv_bfloat16>(p, du, ws, part1, part2, pl, B, wh, ww, C_, D_, nh, hd,
                                       stream);
  else
    rc = launch_generic<float>(p, du, ws, part1, part2, pl, B, wh, ww, C_, D_, nh, hd, stream);
  if (rc != 0) return rc;
  const int total = Slots(C_, D_, nh, hd).total();
  auto reduce = body != ngram_g::FLAGSHIP ? ngram_bwd_reduce<0, 0>
                : nh == 6 ? ngram_bwd_reduce<6, 5>
                          : ngram_bwd_reduce<4, 8>;
  reduce<<<(total + 31) / 32, 256, 0, stream>>>(part1, pl.blocks1, part2, pl.blocks2,
                                                (const float*)p[4], (float*)dparams, C_, D_, nh,
                                                hd, is_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// u [B, wh, ww, C] and g [B, wh, ww, D] (float32 or bfloat16, per is_bf16)
// -> du of u's shape and type, and dparams, float32, the concatenation of
// dwqkv [C, 3A], dbqkv [3A], dlogit_scale [nh], dtable [9, nh], dwproj
// [A, C], dbproj [C], dwmerge [2C, D], dbmerge [D] (at bfloat16 dwqkv,
// dbqkv, dwproj, dbproj and dwmerge are bf16 values).  The weights are the
// forward's (tmar_ngram_context): float32, contiguous, logit_scale raw.
// The body is ngram_g::body's: bfloat16 at C = 32, D = 64 and heads 6 x 5
// or 4 x 8 the tensor-core body, bfloat16 elsewhere the tensor-core generic
// body wherever it has a plan (both with u, g and du 16-byte aligned), every
// other case the CUDA-core generic body (any head_dim); each is three
// launches (cells pass, positions pass, one reduce).  `scratch` holds tmar_ngram_context_bwd_workspace's count of
// floats.  Requires wh >= 2 and ww >= 2.  Returns a cudaError_t code.
int tmar_ngram_context_bwd(const void* u, const void* g, const void* wqkv, const void* bqkv,
                           const void* logit_scale, const void* table, const void* wproj,
                           const void* bproj, const void* wmerge, void* du, void* scratch,
                           void* dparams, int B, int wh, int ww, int C_, int D_, int num_heads,
                           int head_dim, int is_bf16, int sms, void* stream) {
  if (B < 1 || wh < 2 || ww < 2 || sms < 1 || C_ < 1 || D_ < 1 || num_heads < 1 || head_dim < 1)
    return (int)cudaErrorInvalidValue;
  const void* p[9] = {u, g, wqkv, bqkv, logit_scale, table, wproj, bproj, wmerge};
  return launch(p, du, scratch, dparams, B, wh, ww, C_, D_, num_heads, head_dim, is_bf16, sms,
                (cudaStream_t)stream);
}

// The floats of scratch tmar_ngram_context_bwd needs for this call, into
// *floats.  Returns a cudaError_t code.
int tmar_ngram_context_bwd_workspace(int B, int wh, int ww, int C_, int D_, int num_heads,
                                     int head_dim, int is_bf16, int sms, long long* floats) {
  if (B < 1 || wh < 2 || ww < 2 || sms < 1 || C_ < 1 || D_ < 1 || num_heads < 1 || head_dim < 1)
    return (int)cudaErrorInvalidValue;
  Plan pl;
  const int rc = plan(B, wh, ww, C_, D_, num_heads, head_dim, is_bf16, sms, &pl);
  if (rc == 0) *floats = (long long)pl.floats;
  return rc;
}

// The shared memory, in bytes, of the CUDA-core generic body's cells pass
// (pass 1) or positions pass (pass 2), on the tiles it picks.
long long tmar_ngram_context_bwd_smem(int C_, int D_, int num_heads, int head_dim, int pass) {
  return (long long)(pass == 1 ? cells_bytes(C_, D_, num_heads, head_dim,
                                             rt_cells(C_, D_, num_heads, head_dim))
                               : positions_bytes(C_, num_heads, head_dim,
                                                 rt_positions(C_, num_heads, head_dim)));
}

// The shared memory, in bytes, of the tensor-core generic body's cells pass
// (pass 1) or positions pass (pass 2); -1 where it takes no plan.
long long tmar_ngram_context_bwd_mma_smem(int C_, int D_, int num_heads, int head_dim, int pass) {
  ngram_g::Plan G;
  if (!ngram_g::plan(C_, D_, num_heads, head_dim, &G)) return -1;
  return (long long)(pass == 1 ? G.bytes1 : G.bytes2);
}

// The body (ngram_g::Body, envelope.py: NGRAM_BODIES) that runs this
// geometry at this I/O type.
int tmar_ngram_context_bwd_body(int C_, int D_, int num_heads, int head_dim, int is_bf16) {
  return ngram_g::body(C_, D_, num_heads, head_dim, is_bf16);
}

const char* tmar_ngram_context_bwd_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
