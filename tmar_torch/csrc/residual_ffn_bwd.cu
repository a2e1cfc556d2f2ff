// Post-norm residual FFN, backward: all ten cotangents (K6).
//
// Replaces the TPU kernel tmar/ops/pallas_ffn.py:_ffn_bwd_kernel (:249,
// driven by _backward, pallas_call at :180).  Plain versions: autograd of
// tmar_torch/ops/ffn.py:ffn_math (float32) and
// tmar_torch/ops/cuda_ffn.py:ffn_backward_math (bfloat16).  Forward:
// residual_ffn_fwd.cu.
//
// It recomputes the forward per tile of 64 rows
//   n1, r1 = LN1 statistics of attn_out;  y = x + n1·g1 + b1
//   u = y @ w1 + bw1;  h = GELU(u);  o = h @ w2 + bw2;  n2, r2 of o
// and walks back from the output cotangent dz:
//   do = LN2ᵀ(dz);  dg2 += Σ dz·n2;  db2 += Σ dz;  dbw2 += Σ do
//   dw2 += hᵀ do;  dh = do @ w2ᵀ;  du = dh · (Φ(u) + u φ(u));  dbw1 += Σ du
//   dw1 += yᵀ du;  dy = dz + du @ w1ᵀ;  dx = dy
//   d attn_out = LN1ᵀ(dy);  dg1 += Σ dy·n1;  db1 += Σ dy
// for any M (the last tile is ragged; rows past the end are zero and add
// nothing).
//
// The I/O type and the widths pick one of four bodies.  The TPU grid is
// sequential and accumulates the eight parameter cotangents in place; CUDA
// blocks run in no order, so in every body each block keeps its own sums
// across its tiles, writes them to part[block], and a second kernel adds the
// slots in block order.  No float atomics: two runs give the same bits.
//
// The body templated on (D, H) = (64, 128) runs float32 there: a 64-row
// tile and both weights in shared memory.
//
// The tensor-core generic body (ffn_generic_mma.cuh) takes bfloat16 at every
// other width it has a plan for (D a multiple of 8 up to 128): the chain of
// the tensor-core body below on mma.sync with D padded to 16 and the hidden
// width walked in chunks, dw1 and dw2 kept on chip (cut into hidden slices
// where they pass 8·UNITS·256 elements a block).  `ffn_g::body` is the rule.
//
// The CUDA-core generic body takes D and H at run time (float32 at every
// other width, and bfloat16 where the tensor-core generic body takes no
// plan): tiles of R rows (the most of 64, 32, ..., 1 that fit a block:
// 16 at D = 256 and hidden 1024, 8 at D = 512 and hidden 2048; where one
// row's hidden width alone does not fit, the hidden layer in chunks of HC
// columns, recomputed for the backward) in shared memory, weights read from device memory (L2), the
// block's sums in its slot of part, products on the CUDA cores in float32;
// at bfloat16 it rounds where ffn_backward_math does.
//
// The tensor-core body (bfloat16 at D = 64, H = 128) rounds where _ffn_bwd_kernel
// rounds at bf16: the recompute as the forward (yc = bf16(y), hc =
// bf16(GELU(u)), bf16 w1 and w2), the output cotangent (:170), doc = bf16(do)
// before dh = doc·w2ᵀ and dw2 = hcᵀ·doc (:305), duc = bf16(du) before
// dy = dz + duc·w1ᵀ and dw1 = ycᵀ·duc (:319), and dw1 and dw2 after their
// sums over rows (:240, :242), in the reduce.  The LayerNorm backwards, the
// GELU derivative and the vector sums stay float32.  What bounds it on an
// H100: bytes (98 kFLOP per row, 115 k with the recompute, against 640 bytes
// moved).  Design:
// * one persistent block of 8 warps per SM over tiles of 128 rows, a 16-row
//   strip per warp; x, attn_out and dz arrive by cp.async, double-buffered;
//   w1 and w2 are rounded to bf16 in the kernel and staged once per block in
//   one layout each (ffn_mma.cuh), read by ldmatrix for y·w1 and h·w2 and by
//   ldmatrix.trans for do·w2ᵀ and du·w1ᵀ;
// * the chain runs in the warp's registers on mma.sync.  Hidden width 128
//   does not fit u, h and dh of a strip in registers, so it walks the hidden
//   dim in 16-column chunks twice: pass 1 computes u, hc and o (ffn_mma.cuh's
//   fc, the forward's code); after the LN2 backward, pass 2 recomputes u on
//   the tensor cores, then dh, du and dy += duc·w1ᵀ chunk by chunk.  The
//   recompute costs FLOPs, which are far below the bound, and no bytes;
// * yc, hc, doc and duc of every strip are kept in shared memory as bf16
//   (yc over x, doc over dz); after a block barrier each warp adds its share
//   of dw1 = ycᵀ·duc and dw2 = hcᵀ·doc over the tile's 128 rows (ldmatrix.trans
//   for the transposed operands) to accumulators that stay in its registers
//   across all the block's tiles, never in device memory;
// * the vector cotangents are per-lane partials: each strip's two rows per
//   lane are added, then summed over the warp's eight row groups by a
//   reduce-scatter (14 shuffles for 16 values), leaving each lane two columns
//   of each vector; the block sums its warps in order at the end;
// * rows past M are zero, so they add exactly nothing (dz = 0 makes do, du
//   and dy zero);
// * one kernel and one reduce per call, as the generic body: the reduce is
//   this file's, which rounds dw1 and dw2 to bf16 as it writes them.

#include "common.cuh"
#include "ffn_generic_mma.cuh"
#include "ffn_mma.cuh"

namespace {

using namespace tmar;

constexpr int D = 64;    // the templated float32 body's and the tensor-core body's widths
constexpr int HID = 128;
constexpr int LX = D + 1;
constexpr int LH = HID + 1;
constexpr int LW1 = HID + 1;  // w1 [D][LW1]
constexpr int LW2 = D + 1;    // w2 [HID][LW2]
constexpr int WARPS = THREADS / 32;

// shared memory, in floats
constexpr int S_N1 = 0;                      // n1
constexpr int S_Y = S_N1 + ROWS * LX;        // y
constexpr int S_U = S_Y + ROWS * LX;         // u, then du
constexpr int S_H = S_U + ROWS * LH;         // h
constexpr int S_O = S_H + ROWS * LH;         // o, then do
constexpr int S_G = S_O + ROWS * LX;         // dz, then dy
constexpr int S_W1 = S_G + ROWS * LX;
constexpr int S_W2 = S_W1 + D * LW1;
constexpr int S_R = S_W2 + HID * LW2;        // r1 [ROWS]: 1 / std of attn_out's rows
constexpr int S_WP = S_R + ROWS;             // [2][WARPS][D] per-warp column sums
constexpr int S_VEC = S_WP + 2 * WARPS * D;  // g1 b1 bw2 g2 [D] each, bw1 [HID]
constexpr int S_ACC = S_VEC + 4 * D + HID;   // dg1 db1 dbw2 dg2 db2 [D] each, dbw1 [HID]
constexpr int FLOATS = S_ACC + 5 * D + HID;
constexpr size_t BYTES = FLOATS * sizeof(float);
static_assert(BYTES <= MAX_SMEM, "tile does not fit in shared memory");

// one block's slot of partial sums, and the layout of the reduced result
constexpr int P_DG1 = 0;
constexpr int P_DB1 = P_DG1 + D;
constexpr int P_DW1 = P_DB1 + D;
constexpr int P_DBW1 = P_DW1 + D * HID;
constexpr int P_DW2 = P_DBW1 + HID;
constexpr int P_DBW2 = P_DW2 + HID * D;
constexpr int P_DG2 = P_DBW2 + D;
constexpr int P_DB2 = P_DG2 + D;
constexpr int PSIZE = P_DB2 + D;

// Adds the per-warp column sums in sWp [2][WARPS][D] to two [D] accumulators.
__device__ __forceinline__ void add_warp_sums(const float* sWp, float* acc0, float* acc1) {
  const int tid = threadIdx.x;
  if (tid < 2 * D) {
    const int q = tid / D, c = tid % D;
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += sWp[(q * WARPS + w) * D + c];
    (q == 0 ? acc0 : acc1)[c] += s;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) residual_ffn_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ ao, const T* __restrict__ dz,
    const float* __restrict__ g1, const float* __restrict__ b1,
    const float* __restrict__ w1, int w1_k, int w1_n, const float* __restrict__ bw1,
    const float* __restrict__ w2, int w2_k, int w2_n, const float* __restrict__ bw2,
    const float* __restrict__ g2, T* __restrict__ dx, T* __restrict__ dao,
    float* __restrict__ part, long M, float eps) {
  extern __shared__ float smem[];
  float* sN1 = smem + S_N1;
  float* sY = smem + S_Y;
  float* sU = smem + S_U;
  float* sH = smem + S_H;
  float* sO = smem + S_O;
  float* sG = smem + S_G;
  float* s_w1 = smem + S_W1;
  float* s_w2 = smem + S_W2;
  float* s_r1 = smem + S_R;
  float* sWp = smem + S_WP;
  float* s_g1 = smem + S_VEC;
  float* s_b1 = s_g1 + D;
  float* s_bw2 = s_b1 + D;
  float* s_g2 = s_bw2 + D;
  float* s_bw1 = s_g2 + D;
  float* a_dg1 = smem + S_ACC;
  float* a_db1 = a_dg1 + D;
  float* a_dbw2 = a_db1 + D;
  float* a_dg2 = a_dbw2 + D;
  float* a_db2 = a_dg2 + D;
  float* a_dbw1 = a_db2 + D;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < D * HID; e += THREADS) {
    const int k = e / HID, n = e % HID;
    s_w1[k * LW1 + n] = w1[(size_t)k * w1_k + (size_t)n * w1_n];
  }
  for (int e = tid; e < HID * D; e += THREADS) {
    const int k = e / D, n = e % D;
    s_w2[k * LW2 + n] = w2[(size_t)k * w2_k + (size_t)n * w2_n];
  }
  for (int e = tid; e < D; e += THREADS) {
    s_g1[e] = g1[e];
    s_b1[e] = b1[e];
    s_bw2[e] = bw2[e];
    s_g2[e] = g2[e];
  }
  for (int e = tid; e < HID; e += THREADS) s_bw1[e] = bw1[e];
  for (int e = tid; e < 5 * D + HID; e += THREADS) a_dg1[e] = 0.f;
  // the block's sums of dw1 [D][HID] and dw2 [HID][D], over all its tiles
  float accW1[ceil16(D)][ceil16(HID)];
  float accW2[ceil16(HID)][ceil16(D)];
  mm_zero<D, HID>(accW1);
  mm_zero<HID, D>(accW2);
  __syncthreads();

  const int tiles = (int)((M + ROWS - 1) / ROWS);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * ROWS;

    // 1. n1, r1, y = x + LN1(attn_out), and dz; one warp per row
    for (int r = warp; r < ROWS; r += WARPS) {
      const bool ok = row0 + r < M;
      const size_t base = (size_t)(row0 + r) * D;
      const float a0 = ok ? to_f(ao[base + lane]) : 0.f;
      const float a1 = ok ? to_f(ao[base + lane + 32]) : 0.f;
      const float mu = warp_sum(a0 + a1) * (1.f / D);
      const float d0 = a0 - mu, d1 = a1 - mu;
      const float inv = rsqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.f / D) + eps);
      const float n0 = d0 * inv, n1 = d1 * inv;
      sN1[r * LX + lane] = n0;
      sN1[r * LX + lane + 32] = n1;
      if (lane == 0) s_r1[r] = inv;
      sY[r * LX + lane] = (ok ? to_f(x[base + lane]) : 0.f) + n0 * s_g1[lane] + s_b1[lane];
      sY[r * LX + lane + 32] =
          (ok ? to_f(x[base + lane + 32]) : 0.f) + n1 * s_g1[lane + 32] + s_b1[lane + 32];
      sG[r * LX + lane] = ok ? to_f(dz[base + lane]) : 0.f;
      sG[r * LX + lane + 32] = ok ? to_f(dz[base + lane + 32]) : 0.f;
    }
    __syncthreads();

    // 2. u = y @ w1 + bw1;  h = GELU(u)
    {
      float acc[ceil16(ROWS)][ceil16(HID)];
      mm_zero<ROWS, HID>(acc);
      mm_acc<ROWS, D, HID>(acc, sY, LX, 1, s_w1, LW1, 1);
      mm_each<ROWS, HID>(acc, [&](int m, int n, float v) {
        const float u = v + s_bw1[n];
        sU[m * LH + n] = u;
        sH[m * LH + n] = act::gelu(u);
      });
    }
    __syncthreads();

    // 3. o = h @ w2 + bw2
    {
      float acc[ceil16(ROWS)][ceil16(D)];
      mm_zero<ROWS, D>(acc);
      mm_acc<ROWS, HID, D>(acc, sH, LH, 1, s_w2, LW2, 1);
      mm_each<ROWS, D>(acc, [&](int m, int n, float v) { sO[m * LX + n] = v + s_bw2[n]; });
    }
    __syncthreads();

    // 4. LN2 backward, in place: o -> do; per-warp shares of dg2 and db2
    {
      float pg0 = 0.f, pg1 = 0.f, pb0 = 0.f, pb1 = 0.f;
      for (int r = warp; r < ROWS; r += WARPS) {
        const float o0 = sO[r * LX + lane], o1 = sO[r * LX + lane + 32];
        const float mu = warp_sum(o0 + o1) * (1.f / D);
        const float d0 = o0 - mu, d1 = o1 - mu;
        const float inv = rsqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.f / D) + eps);
        const float n0 = d0 * inv, n1 = d1 * inv;
        const float z0 = sG[r * LX + lane], z1 = sG[r * LX + lane + 32];
        pg0 = fmaf(z0, n0, pg0);
        pg1 = fmaf(z1, n1, pg1);
        pb0 += z0;
        pb1 += z1;
        const float dn0 = z0 * s_g2[lane], dn1 = z1 * s_g2[lane + 32];
        const float m1 = warp_sum(dn0 + dn1) * (1.f / D);
        const float m2 = warp_sum(dn0 * n0 + dn1 * n1) * (1.f / D);
        sO[r * LX + lane] = inv * (dn0 - m1 - n0 * m2);
        sO[r * LX + lane + 32] = inv * (dn1 - m1 - n1 * m2);
      }
      sWp[(0 * WARPS + warp) * D + lane] = pg0;
      sWp[(0 * WARPS + warp) * D + lane + 32] = pg1;
      sWp[(1 * WARPS + warp) * D + lane] = pb0;
      sWp[(1 * WARPS + warp) * D + lane + 32] = pb1;
    }
    __syncthreads();

    // 5. dg2, db2, dbw2 sums;  dw2 += hᵀ do
    add_warp_sums(sWp, a_dg2, a_db2);
    if (tid >= 2 * D && tid < 3 * D) {
      const int c = tid - 2 * D;
      float s = 0.f;
      for (int r = 0; r < ROWS; ++r) s += sO[r * LX + c];
      a_dbw2[c] += s;
    }
    mm_acc<HID, ROWS, D>(accW2, sH, 1, LH, sO, LX, 1);
    __syncthreads();

    // 6. dh = do @ w2ᵀ (over h);  du = dh · GELU'(u) (over u)
    {
      float acc[ceil16(ROWS)][ceil16(HID)];
      mm_zero<ROWS, HID>(acc);
      mm_acc<ROWS, D, HID>(acc, sO, LX, 1, s_w2, 1, LW2);
      mm_each<ROWS, HID>(acc, [&](int m, int n, float v) {
        sU[m * LH + n] = v * act::gelu_grad(sU[m * LH + n]);
      });
    }
    __syncthreads();

    // 7. dbw1 sum;  dw1 += yᵀ du;  dy = dz + du @ w1ᵀ (over dz)
    if (tid < HID) {
      float s = 0.f;
      for (int r = 0; r < ROWS; ++r) s += sU[r * LH + tid];
      a_dbw1[tid] += s;
    }
    mm_acc<D, ROWS, HID>(accW1, sY, 1, LX, sU, LH, 1);
    {
      float acc[ceil16(ROWS)][ceil16(D)];
      mm_zero<ROWS, D>(acc);
      mm_acc<ROWS, HID, D>(acc, sU, LH, 1, s_w1, 1, LW1);
      mm_each<ROWS, D>(acc, [&](int m, int n, float v) { sG[m * LX + n] += v; });
    }
    __syncthreads();

    // 8. dx = dy;  d attn_out = LN1 backward;  per-warp shares of dg1 and db1
    {
      float pg0 = 0.f, pg1 = 0.f, pb0 = 0.f, pb1 = 0.f;
      for (int r = warp; r < ROWS; r += WARPS) {
        const float y0 = sG[r * LX + lane], y1 = sG[r * LX + lane + 32];
        const float n0 = sN1[r * LX + lane], n1 = sN1[r * LX + lane + 32];
        pg0 = fmaf(y0, n0, pg0);
        pg1 = fmaf(y1, n1, pg1);
        pb0 += y0;
        pb1 += y1;
        const float dn0 = y0 * s_g1[lane], dn1 = y1 * s_g1[lane + 32];
        const float m1 = warp_sum(dn0 + dn1) * (1.f / D);
        const float m2 = warp_sum(dn0 * n0 + dn1 * n1) * (1.f / D);
        if (row0 + r < M) {
          const size_t base = (size_t)(row0 + r) * D;
          const float inv = s_r1[r];
          store(dx + base + lane, y0);
          store(dx + base + lane + 32, y1);
          store(dao + base + lane, inv * (dn0 - m1 - n0 * m2));
          store(dao + base + lane + 32, inv * (dn1 - m1 - n1 * m2));
        }
      }
      sWp[(0 * WARPS + warp) * D + lane] = pg0;
      sWp[(0 * WARPS + warp) * D + lane + 32] = pg1;
      sWp[(1 * WARPS + warp) * D + lane] = pb0;
      sWp[(1 * WARPS + warp) * D + lane + 32] = pb1;
    }
    __syncthreads();
    add_warp_sums(sWp, a_dg1, a_db1);
    __syncthreads();
  }

  // the block's slot of partial sums
  float* my = part + (size_t)blockIdx.x * PSIZE;
  mm_each<D, HID>(accW1, [&](int m, int n, float v) { my[P_DW1 + m * HID + n] = v; });
  mm_each<HID, D>(accW2, [&](int m, int n, float v) { my[P_DW2 + m * D + n] = v; });
  for (int e = tid; e < D; e += THREADS) {
    my[P_DG1 + e] = a_dg1[e];
    my[P_DB1 + e] = a_db1[e];
    my[P_DBW2 + e] = a_dbw2[e];
    my[P_DG2 + e] = a_dg2[e];
    my[P_DB2 + e] = a_db2[e];
  }
  for (int e = tid; e < HID; e += THREADS) my[P_DBW1 + e] = a_dbw1[e];
}

// ---- the CUDA-core generic body: any (D, hidden) --------------------------
// A persistent block walks over tiles of R rows (64, or the most of 32, 16,
// ..., 1 where a wide model's tile would not fit: tmar_torch/ops/envelope.py,
// ffn_envelope and ffn_bwd_bytes); n1, y, o then do, dz then dy (width D) and u then du, hc
// (HC columns of the hidden layer, all H where they fit) of a tile sit in
// shared memory in float32, rows padded to an odd length.  With HC < H the
// forward adds o chunk by chunk, and the backward recomputes each chunk's u
// and hc before its cotangents.  The weights are read from device memory through their strides,
// rounded to T's values as they are read.  The block's partial sums live in
// its own slot of `part` (zeroed first): every element has one owner thread
// (a column pass, or mm_rt's fixed mapping), which adds each tile's share in
// place, so neither atomics nor a second owner ever touch it.  At bfloat16 it
// rounds where ffn_backward_math does (above); at float32 it is the float32
// backward.
size_t rt_bytes(int D, int HC, int R) {
  return (size_t)4 * R * (4 * (D + 1) + 2 * (HC + 1) + 2);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) residual_ffn_bwd_rt(
    const T* __restrict__ x, const T* __restrict__ ao, const T* __restrict__ dz,
    const float* __restrict__ g1, const float* __restrict__ b1,
    const float* __restrict__ w1, int w1_k, int w1_n, const float* __restrict__ bw1,
    const float* __restrict__ w2, int w2_k, int w2_n, const float* __restrict__ bw2,
    const float* __restrict__ g2, T* __restrict__ dx, T* __restrict__ dao,
    float* __restrict__ part, long M, int D, int H, int R, int HC, float eps) {
  extern __shared__ float smem[];
  const int LX = D + 1, LH = HC + 1;
  float* sN1 = smem;           // n1
  float* sY = sN1 + R * LX;    // y
  float* sO = sY + R * LX;     // o, n2, then do
  float* sG = sO + R * LX;     // dz, then dy
  float* sU = sG + R * LX;     // u, then du
  float* sH = sU + R * LH;     // hc
  float* sR1 = sH + R * LH;    // 1 / std of attn_out's rows
  float* sR2 = sR1 + R;        // 1 / std of o's rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pDB1 = D, pDW1 = 2 * D, pDBW1 = pDW1 + D * H, pDW2 = pDBW1 + H;
  const int pDBW2 = pDW2 + H * D, pDG2 = pDBW2 + D, pDB2 = pDG2 + D, psize = pDB2 + D;
  float* my = part + (size_t)blockIdx.x * psize;
  for (int e = tid; e < psize; e += THREADS) my[e] = 0.f;
  __syncthreads();
  auto w1c = [&](int k, int n) { return round_as<T>(__ldg(w1 + (size_t)k * w1_k + (size_t)n * w1_n)); };
  auto w2c = [&](int k, int n) { return round_as<T>(__ldg(w2 + (size_t)k * w2_k + (size_t)n * w2_n)); };

  const long tiles = (M + R - 1) / R;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = tile * R;
    const int rows = (int)(M - row0 < R ? M - row0 : R);

    // 1. n1, r1, y = x + n1·g1 + b1, dz; one warp per row
    for (int r = warp; r < rows; r += THREADS / 32) {
      const size_t base = (size_t)(row0 + r) * D;
      const float2 st = row_stats(D, eps, [&](int c) { return to_f(ao[base + c]); });
      for (int c = lane; c < D; c += 32) {
        const float n = (to_f(ao[base + c]) - st.x) * st.y;
        sN1[r * LX + c] = n;
        sY[r * LX + c] = to_f(x[base + c]) + n * g1[c] + b1[c];
        sG[r * LX + c] = to_f(dz[base + c]);
      }
      if (lane == 0) sR1[r] = st.y;
    }
    __syncthreads();

    // 2. u = T(y) @ T(w1) + bw1;  hc = T(GELU(u)) of hidden columns [c0, c0 + HC)
    auto hidden = [&](int c0, int hc) {
      mm_rt(rows, hc, D, [&](int m, int k) { return round_as<T>(sY[m * LX + k]); },
            [&](int k, int n) { return w1c(k, c0 + n); },
            [&](int m, int n, float v) {
              const float u = v + __ldg(bw1 + c0 + n);
              sU[m * LH + n] = u;
              sH[m * LH + n] = round_as<T>(act::gelu(u));
            });
      __syncthreads();
    };
    // 3. o = hc @ T(w2) + bw2, the chunks' products added in place
    for (int c0 = 0; c0 < H; c0 += HC) {
      const int hc = H - c0 < HC ? H - c0 : HC;
      hidden(c0, hc);
      mm_rt(rows, D, hc, [&](int m, int k) { return sH[m * LH + k]; },
            [&](int k, int n) { return w2c(c0 + k, n); },
            [&](int m, int n, float v) {
              sO[m * LX + n] = c0 == 0 ? v + __ldg(bw2 + n) : sO[m * LX + n] + v;
            });
      __syncthreads();
    }

    // 4. LN2 backward: o -> n2 (rows), dg2 and db2 (columns), n2 -> do (rows)
    for (int r = warp; r < rows; r += THREADS / 32) {
      float* o = sO + r * LX;
      const float2 st = row_stats(D, eps, [&](int c) { return o[c]; });
      __syncwarp();
      for (int c = lane; c < D; c += 32) o[c] = (o[c] - st.x) * st.y;
      if (lane == 0) sR2[r] = st.y;
    }
    __syncthreads();
    for (int c = tid; c < D; c += THREADS) {
      float sg = 0.f, sb = 0.f;
      for (int r = 0; r < rows; ++r) {
        sg = fmaf(sG[r * LX + c], sO[r * LX + c], sg);
        sb += sG[r * LX + c];
      }
      my[pDG2 + c] += sg;
      my[pDB2 + c] += sb;
    }
    __syncthreads();
    for (int r = warp; r < rows; r += THREADS / 32) {
      float* n = sO + r * LX;
      const float* gz = sG + r * LX;
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float dn = gz[c] * g2[c];
        s1 += dn;
        s2 = fmaf(dn, n[c], s2);
      }
      const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D, inv = sR2[r];
      for (int c = lane; c < D; c += 32) n[c] = inv * (gz[c] * g2[c] - m1 - n[c] * m2);
    }
    __syncthreads();

    // 5. dbw2 += Σ do;  then per hidden chunk (u and hc recomputed where
    //    the chunks are several): dw2 += hcᵀ T(do);  du = T(do) @ T(w2)ᵀ ·
    //    GELU'(u) (over u);  6. dbw1 += Σ du;  dw1 += T(y)ᵀ T(du);
    //    dy = dz + T(du) @ T(w1)ᵀ (over dz)
    for (int c = tid; c < D; c += THREADS) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += sO[r * LX + c];
      my[pDBW2 + c] += s;
    }
    for (int c0 = 0; c0 < H; c0 += HC) {
      const int hc = H - c0 < HC ? H - c0 : HC;
      if (HC < H) hidden(c0, hc);
      mm_rt(hc, D, rows, [&](int m, int k) { return sH[k * LH + m]; },
            [&](int k, int n) { return round_as<T>(sO[k * LX + n]); },
            [&](int m, int n, float v) { my[pDW2 + (c0 + m) * D + n] += v; });
      mm_rt(rows, hc, D, [&](int m, int k) { return round_as<T>(sO[m * LX + k]); },
            [&](int k, int n) { return w2c(c0 + n, k); },
            [&](int m, int n, float v) { sU[m * LH + n] = v * act::gelu_grad(sU[m * LH + n]); });
      __syncthreads();
      for (int c = tid; c < hc; c += THREADS) {
        float s = 0.f;
        for (int r = 0; r < rows; ++r) s += sU[r * LH + c];
        my[pDBW1 + c0 + c] += s;
      }
      mm_rt(D, hc, rows, [&](int m, int k) { return round_as<T>(sY[k * LX + m]); },
            [&](int k, int n) { return round_as<T>(sU[k * LH + n]); },
            [&](int m, int n, float v) { my[pDW1 + m * H + c0 + n] += v; });
      mm_rt(rows, D, hc, [&](int m, int k) { return round_as<T>(sU[m * LH + k]); },
            [&](int k, int n) { return w1c(n, c0 + k); },
            [&](int m, int n, float v) { sG[m * LX + n] += v; });
      __syncthreads();
    }

    // 7. dg1, db1 (columns);  dx = dy, d attn_out = LN1 backward (rows)
    for (int c = tid; c < D; c += THREADS) {
      float sg = 0.f, sb = 0.f;
      for (int r = 0; r < rows; ++r) {
        sg = fmaf(sG[r * LX + c], sN1[r * LX + c], sg);
        sb += sG[r * LX + c];
      }
      my[c] += sg;
      my[pDB1 + c] += sb;
    }
    for (int r = warp; r < rows; r += THREADS / 32) {
      const float* dy = sG + r * LX;
      const float* n = sN1 + r * LX;
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float dn = dy[c] * g1[c];
        s1 += dn;
        s2 = fmaf(dn, n[c], s2);
      }
      const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D, inv = sR1[r];
      const size_t base = (size_t)(row0 + r) * D;
      for (int c = lane; c < D; c += 32) {
        store(dx + base + c, dy[c]);
        store(dao + base + c, inv * (dy[c] * g1[c] - m1 - n[c] * m2));
      }
    }
    __syncthreads();
  }
}

// ---- the bfloat16 body: tensor cores --------------------------------------
constexpr int MMA_WARPS = 8;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int TILE = 16 * MMA_WARPS;        // rows per block step
constexpr int LDH = HID + 8;                // a hidden-width strip: [16][LDH]
constexpr int HSTRIP = 16 * LDH;
// per warp, bf16: two stages of (x then yc, attn_out, dz then doc) strips,
// then the hc and duc strips
constexpr int WARP_ELEMS = 2 * 3 * ffn::STRIP + 2 * HSTRIP;
// float32 g1 b1 g2 bw2 [D] each and bw1 [HID], then bf16 the staged weights
// and the warps' strips
constexpr int M_FLOATS = 4 * D + HID;
constexpr size_t MMA_BYTES =
    M_FLOATS * sizeof(float) +
    (size_t)(ffn::WELEMS + MMA_WARPS * WARP_ELEMS) * sizeof(__nv_bfloat16);
constexpr int VEC = 5 * D + HID;  // the vector cotangents: dg1 db1 dbw2 dg2 db2, dbw1
static_assert(ffn::D == D && ffn::HID == HID, "the FFN widths");
static_assert(M_FLOATS % 4 == 0 && ffn::WELEMS % 8 == 0 && WARP_ELEMS % 8 == 0,
              "16-byte aligned regions");
static_assert(MMA_BYTES <= MAX_SMEM, "strips do not fit in shared memory");
static_assert(VEC * sizeof(float) <= WARP_ELEMS * sizeof(__nv_bfloat16),
              "a warp's vector partials fit in its strips");

// acc += the sums over a strip's 16 rows at this lane's columns 8g + 2t + e,
// from s[2j + e], the sums of this lane's two rows (g, g + 8) at column
// 8j + 2t + e
__device__ __forceinline__ void add_column_sums(const float (&s)[16], float (&acc)[2], int g) {
  float r[2];
  rows_reduce_scatter<2>(s, r, g);
  acc[0] += r[0], acc[1] += r[1];
}

// acc += the sums of v's 16 rows at this lane's columns 8g + 2t + e
__device__ __forceinline__ void add_column_sums(const float (&v)[8][4], float (&acc)[2], int g) {
  float s[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[2 * j] = v[j][0] + v[j][2], s[2 * j + 1] = v[j][1] + v[j][3];
  add_column_sums(s, acc, g);
}


// The LayerNorm backward per row, in place: n (the normalised rows) <-
// inv · (dn - mean(dn) - n · mean(dn · n)), dn = dout · gain; dg and db get
// this lane's columns of the strip's sums of dout · n and dout
__device__ __forceinline__ void layer_norm_backward(const float (&dout)[8][4], float (&n)[8][4],
                                                    const float* gain, const float (&inv)[2],
                                                    float (&dg)[2], float (&db)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
  float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f}, s[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float dn = dout[j][e] * gain[8 * j + 2 * t + (e & 1)];
      m1[e >> 1] += dn;
      m2[e >> 1] += dn * n[j][e];
    }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) s[2 * j + e] = dout[j][e] * n[j][e] + dout[j][e + 2] * n[j][e + 2];
  add_column_sums(s, dg, g);
  add_column_sums(dout, db, g);
#pragma unroll
  for (int r = 0; r < 2; ++r) m1[r] = quad_sum(m1[r]) * (1.f / D), m2[r] = quad_sum(m2[r]) * (1.f / D);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float dn = dout[j][e] * gain[8 * j + 2 * t + (e & 1)];
      n[j][e] = inv[e >> 1] * (dn - m1[e >> 1] - n[j][e] * m2[e >> 1]);
    }
}


__global__ void __launch_bounds__(MMA_THREADS, 1) residual_ffn_bwd_mma(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ ao,
    const __nv_bfloat16* __restrict__ dz, const float* __restrict__ g1,
    const float* __restrict__ b1, const float* __restrict__ w1, int w1_k, int w1_n,
    const float* __restrict__ bw1, const float* __restrict__ w2, int w2_k, int w2_n,
    const float* __restrict__ bw2, const float* __restrict__ g2, __nv_bfloat16* __restrict__ dx,
    __nv_bfloat16* __restrict__ dao, float* __restrict__ part, long M, float eps) {
  extern __shared__ float4 smem4[];
  float* s_g1 = reinterpret_cast<float*>(smem4);
  float* s_b1 = s_g1 + D;
  float* s_g2 = s_b1 + D;
  float* s_bw2 = s_g2 + D;
  float* s_bw1 = s_bw2 + D;
  __nv_bfloat16* s_w1 = reinterpret_cast<__nv_bfloat16*>(s_g1 + M_FLOATS);
  __nv_bfloat16* s_w2 = s_w1 + HID * ffn::LW1;
  __nv_bfloat16* strips = s_w1 + ffn::WELEMS;  // [MMA_WARPS][WARP_ELEMS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  ffn::stage_weights(s_w1, s_w2, w1, w1_k, w1_n, w2, w2_k, w2_n, tid, MMA_THREADS);
  for (int e = tid; e < D; e += MMA_THREADS) {
    s_g1[e] = g1[e];
    s_b1[e] = b1[e];
    s_g2[e] = g2[e];
    s_bw2[e] = bw2[e];
  }
  for (int e = tid; e < HID; e += MMA_THREADS) s_bw1[e] = bw1[e];
  __syncthreads();

  __nv_bfloat16* mine = strips + warp * WARP_ELEMS;
  __nv_bfloat16* s_hc = mine + 6 * ffn::STRIP;
  __nv_bfloat16* s_du = s_hc + HSTRIP;
  // The block's sums over its tiles.  dw1 [D][HID]: this warp's 16 rows
  // 16·(warp / 2) and 64 columns from 64·(warp % 2); dw2 [HID][D]: its rows
  // 16·warp, all 64 columns.  The vectors: this lane's columns 8g + 2t + e of
  // dg1 db1 dbw2 dg2 db2, and of dbw1 the columns 32p + 16(g / 4) +
  // 8(g / 2 % 2) + 2t + g % 2 (p < 4).
  float cw1[8][4], cw2[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cw1[j][e] = cw2[j][e] = 0.f;
  float pv[5][2] = {}, pbw1[4] = {};
  enum { DG1, DB1, DBW2, DG2, DB2 };

  auto load = [&](int tile, __nv_bfloat16* stage) {
    const long row0 = (long)tile * TILE + 16 * warp;
    ffn::load_strip(stage, x, row0, M, lane);
    ffn::load_strip(stage + ffn::STRIP, ao, row0, M, lane);
    ffn::load_strip(stage + 2 * ffn::STRIP, dz, row0, M, lane);
    cp_async_commit();
  };
  const int tiles = (int)((M + TILE - 1) / TILE);
  if ((int)blockIdx.x < tiles) load(blockIdx.x, mine);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    __nv_bfloat16* s_x = mine + (it & 1) * 3 * ffn::STRIP;  // x, then yc
    __nv_bfloat16* s_ao = s_x + ffn::STRIP;
    __nv_bfloat16* s_dz = s_ao + ffn::STRIP;                // dz, then doc
    if (tile + (int)gridDim.x < tiles)
      load(tile + gridDim.x, mine + ((it + 1) & 1) * 3 * ffn::STRIP);
    else
      cp_async_commit();  // an empty group keeps the wait below uniform
    cp_async_wait_prior();
    __syncwarp();  // every lane's copies of this strip have landed
    const long row0 = (long)tile * TILE + 16 * warp;

    // 1. y = x + (n1·g1 + b1), n1 = LN1's normalised attn_out;  yc -> the x strip
    float y[8][4], inv1[2];
    ffn::read_strip(s_ao, y, lane);
    ffn_g::normalize_rows(y, eps, inv1, D / 8);
    {
      float xv[8][4];
      ffn::read_strip(s_x, xv, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          y[j][e] = xv[j][e] + (y[j][e] * s_g1[c] + s_b1[c]);
        }
    }
    ffn::write_strip(s_x, y, lane);

    // 2. pass 1: o = hc · w2 + bw2, hc = bf16(GELU(yc · w1 + bw1)) -> the hc strip
    float o[8][4];
    ffn::fc(y, o, s_w1, s_w2, s_bw1, s_bw2, lane,
            [&](int c, const uint32_t (&ha)[4]) {
              ffn_g::store_a(s_hc, LDH, 16 * c, ha, lane);
            });

    // 3. LN2 backward: o -> n2 -> do;  dy = dz;  doc -> the dz strip
    float inv2[2], dy[8][4];
    ffn_g::normalize_rows(o, eps, inv2, D / 8);
    ffn::read_strip(s_dz, dy, lane);
    layer_norm_backward(dy, o, s_g2, inv2, pv[DG2], pv[DB2], lane);
    add_column_sums(o, pv[DBW2], g);
    __syncwarp();  // every lane has read dz
    ffn::write_strip(s_dz, o, lane);
    __syncwarp();  // yc and doc are in

    // 4. pass 2, per hidden chunk: u again, dh = doc · w2ᵀ, du = dh · GELU'(u),
    //    duc -> the du strip, dy += duc · w1ᵀ
    {
      uint32_t ya[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        load_a(ya[kk], s_x, ffn::LDT, 0, 16 * kk, lane);
        load_a(da[kk], s_dz, ffn::LDT, 0, 16 * kk, lane);
      }
      float sums[8];  // a chunk pair's row sums of du
#pragma unroll
      for (int hc = 0; hc < HID / 16; ++hc) {
        float u[2][4], dh[2][4] = {};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int c = 16 * hc + 8 * hf + 2 * t;
          u[hf][0] = u[hf][2] = s_bw1[c];
          u[hf][1] = u[hf][3] = s_bw1[c + 1];
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          mma_pair(u[0], u[1], ya[kk], s_w1, ffn::LW1, 16 * hc, 16 * kk, lane);
          mma_pair_t(dh[0], dh[1], da[kk], s_w2, ffn::LW2, 16 * hc, 16 * kk, lane);
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dh[hf][e] *= act::gelu_grad(u[hf][e]);
          sums[4 * (hc & 1) + 2 * hf] = dh[hf][0] + dh[hf][2];
          sums[4 * (hc & 1) + 2 * hf + 1] = dh[hf][1] + dh[hf][3];
        }
        if (hc & 1) {
          float r[1];
          rows_reduce_scatter<1>(sums, r, g);
          pbw1[hc >> 1] += r[0];
        }
        uint32_t dua[4];
        to_a(dua, dh[0], dh[1]);
        ffn_g::store_a(s_du, LDH, 16 * hc, dua, lane);
#pragma unroll
        for (int j = 0; j < 8; j += 2) mma_pair_t(dy[j], dy[j + 1], dua, s_w1, ffn::LW1, 8 * j, 16 * hc, lane);
      }
    }

    // 5. dx = bf16(dy);  LN1 backward: n1 again -> d attn_out;  out through
    //    the attn_out strip
    {
      float n1[8][4];
      ffn::read_strip(s_ao, n1, lane);
      ffn_g::normalize_rows(n1, eps, inv1, D / 8);
      layer_norm_backward(dy, n1, s_g1, inv1, pv[DG1], pv[DB1], lane);
      __syncwarp();  // every lane has read attn_out
      ffn::write_strip(s_ao, dy, lane);
      __syncwarp();
      ffn::store_strip(dx, s_ao, row0, M, lane);
      __syncwarp();
      ffn::write_strip(s_ao, n1, lane);
      __syncwarp();
      ffn::store_strip(dao, s_ao, row0, M, lane);
    }
    __syncthreads();  // every warp's yc, hc, doc and duc strips are in

    // 6. this warp's shares of dw1 += ycᵀ·duc and dw2 += hcᵀ·doc over the
    //    tile's rows, one 16-row k-step per strip
#pragma unroll 1
    for (int w = 0; w < MMA_WARPS; ++w) {
      const __nv_bfloat16* other = strips + w * WARP_ELEMS;
      const __nv_bfloat16* yc = other + (it & 1) * 3 * ffn::STRIP;
      const __nv_bfloat16* doc = yc + 2 * ffn::STRIP;
      const __nv_bfloat16* hc = other + 6 * ffn::STRIP;
      const __nv_bfloat16* duc = hc + HSTRIP;
      uint32_t a[4];
      load_a_t(a, yc, ffn::LDT, 16 * (warp >> 1), 0, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma_pair_t(cw1[2 * i], cw1[2 * i + 1], a, duc, LDH, 64 * (warp & 1) + 16 * i, 0, lane);
      load_a_t(a, hc, LDH, 16 * warp, 0, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mma_pair_t(cw2[2 * i], cw2[2 * i + 1], a, doc, ffn::LDT, 16 * i, 0, lane);
    }
    __syncthreads();  // the strips are free for the next tile
  }

  // the block's slot of partial sums: dw1 and dw2 from the warps' shares,
  // the vectors summed over the warps in order
  float* my = part + (size_t)blockIdx.x * PSIZE;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1), c = 8 * n + 2 * t + (e & 1);
      my[P_DW1 + (16 * (warp >> 1) + r) * HID + 64 * (warp & 1) + c] = cw1[n][e];
      my[P_DW2 + (16 * warp + r) * D + c] = cw2[n][e];
    }
  float* vec = reinterpret_cast<float*>(mine);  // [VEC], the strips are free
#pragma unroll
  for (int v = 0; v < 5; ++v)
#pragma unroll
    for (int e = 0; e < 2; ++e) vec[v * D + 8 * g + 2 * t + e] = pv[v][e];
#pragma unroll
  for (int p = 0; p < 4; ++p)
    vec[5 * D + 32 * p + 16 * (g >> 2) + 8 * ((g >> 1) & 1) + 2 * t + (g & 1)] = pbw1[p];
  __syncthreads();
  for (int e = tid; e < VEC; e += MMA_THREADS) {
    float s = 0.f;
    for (int w = 0; w < MMA_WARPS; ++w) s += reinterpret_cast<const float*>(strips + w * WARP_ELEMS)[e];
    const int v = e / D;
    const int at = v == DG1 ? P_DG1 : v == DB1 ? P_DB1 : v == DBW2 ? P_DBW2 : v == DG2 ? P_DG2
                 : v == DB2 ? P_DB2 : P_DBW1 - 5 * D;
    my[at + (v < 5 ? e % D : e)] = s;
  }
}

// out[e] = sum_b part[b][e] in block order, as reduce_partials, with dw1 and
// dw2 rounded to bf16 as they are written (_ffn_bwd_kernel's dw1.astype(w1's
// dtype), :240, :242)
__global__ void reduce_partials_bf16_weights(const float* __restrict__ part,
                                             float* __restrict__ out, int nblocks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= PSIZE) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += part[(size_t)b * PSIZE + e];
  const bool w = (e >= P_DW1 && e < P_DW1 + D * HID) || (e >= P_DW2 && e < P_DW2 + HID * D);
  out[e] = w ? round_as<__nv_bfloat16>(s) : s;
}

int launch_mma(const void* const* p, int w1_k, int w1_n, int w2_k, int w2_n, void* dx, void* dao,
               void* part, void* dparams, long M, float eps, int blocks, cudaStream_t stream) {
  if (((uintptr_t)p[0] | (uintptr_t)p[1] | (uintptr_t)p[2] | (uintptr_t)dx | (uintptr_t)dao) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(
      residual_ffn_bwd_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MMA_BYTES);
  if (err != cudaSuccess) return (int)err;
  residual_ffn_bwd_mma<<<blocks, MMA_THREADS, MMA_BYTES, stream>>>(
      (const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[1], (const __nv_bfloat16*)p[2],
      (const float*)p[3], (const float*)p[4], (const float*)p[5], w1_k, w1_n,
      (const float*)p[6], (const float*)p[7], w2_k, w2_n, (const float*)p[8],
      (const float*)p[9], (__nv_bfloat16*)dx, (__nv_bfloat16*)dao, (float*)part, M, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_partials_bf16_weights<<<(PSIZE + 255) / 256, 256, 0, stream>>>(
      (const float*)part, (float*)dparams, blocks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* const* p, int w1_k, int w1_n, int w2_k, int w2_n, void* dx, void* dao,
           void* part, void* dparams, long M, float eps, int blocks, cudaStream_t stream) {
  auto kern = residual_ffn_bwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BYTES);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, THREADS, BYTES, stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const float*)p[3],
      (const float*)p[4], (const float*)p[5], w1_k, w1_n, (const float*)p[6],
      (const float*)p[7], w2_k, w2_n, (const float*)p[8], (const float*)p[9], (T*)dx,
      (T*)dao, (float*)part, M, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce_partials<<<(PSIZE + 255) / 256, 256, 0, stream>>>(
      (const float*)part, (float*)dparams, blocks, PSIZE);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rt(const void* const* p, int w1_k, int w1_n, int w2_k, int w2_n, void* dx, void* dao,
              void* part, void* dparams, long M, int D, int H, int R, int HC, float eps,
              int blocks, cudaStream_t stream) {
  const size_t bytes = rt_bytes(D, HC, R);
  auto kern = residual_ffn_bwd_rt<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, THREADS, bytes, stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const float*)p[3],
      (const float*)p[4], (const float*)p[5], w1_k, w1_n, (const float*)p[6],
      (const float*)p[7], w2_k, w2_n, (const float*)p[8], (const float*)p[9], (T*)dx,
      (T*)dao, (float*)part, M, D, H, R, HC, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int size = 5 * D + 2 * D * H + H, dw1 = 2 * D, dw2 = 2 * D + D * H + H;
  reduce_partials_rounded<<<(size + 255) / 256, 256, 0, stream>>>(
      (const float*)part, (float*)dparams, blocks, size, dw1, dw1 + D * H, dw2, dw2 + H * D,
      sizeof(T) == 2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, attn_out, dz [M, D] (float32 or bfloat16, per is_bf16) -> dx and
// d attn_out of the same shape and type, and dparams, float32, the
// concatenation of dg1 [D], db1 [D], dw1 [D, H], dbw1 [H], dw2 [H, D],
// dbw2 [D], dg2 [D], db2 [D] (at bfloat16 dw1 and dw2 are bf16 values).
// The body is ffn_g::body's: at (D, H) = (64, 128) the tensor-core body
// (bfloat16; the five activations 16-byte aligned) or the templated one;
// bfloat16 wherever it has a plan the tensor-core generic body; else the
// CUDA-core generic body, in tiles of R rows (R <= 64) with the hidden layer
// in chunks of HC columns (HC <= H) on `blocks` blocks.
// `part` is scratch of tmar_residual_ffn_bwd_workspace's floats.  The
// parameters are the forward's (b2 is not needed).  Returns a cudaError_t
// code (0 on a clean launch).
int tmar_residual_ffn_bwd(const void* x, const void* ao, const void* dz, const void* g1,
                          const void* b1, const void* w1, const void* bw1, const void* w2,
                          const void* bw2, const void* g2, void* dx, void* dao, void* part,
                          void* dparams, long long M, int D, int H, int R, int HC, int w1_k,
                          int w1_n, int w2_k, int w2_n, float eps, int blocks, int is_bf16,
                          void* stream) {
  if (M < 1 || D < 1 || H < 1 || R < 1 || R > ROWS || HC < 1 || HC > H || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const void* p[10] = {x, ao, dz, g1, b1, w1, bw1, w2, bw2, g2};
  cudaStream_t s = (cudaStream_t)stream;
  switch (ffn_g::body(D, H, is_bf16)) {
    case ffn_g::FLAGSHIP:
      return launch_mma(p, w1_k, w1_n, w2_k, w2_n, dx, dao, part, dparams, (long)M, eps, blocks, s);
    case ffn_g::TEMPLATED:
      return launch<float>(p, w1_k, w1_n, w2_k, w2_n, dx, dao, part, dparams, (long)M, eps,
                           blocks, s);
    case ffn_g::TENSOR_CORE:
      return ffn_g::launch(p, w1_k, w1_n, w2_k, w2_n, dx, dao, part, dparams, (long)M, D, H, eps,
                           s);
    default:
      break;
  }
  if (rt_bytes(D, HC, R) > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_rt<__nv_bfloat16>(p, w1_k, w1_n, w2_k, w2_n, dx, dao, part, dparams, (long)M,
                                    D, H, R, HC, eps, blocks, s);
  return launch_rt<float>(p, w1_k, w1_n, w2_k, w2_n, dx, dao, part, dparams, (long)M, D, H, R,
                          HC, eps, blocks, s);
}

// The floats of scratch (`part`) tmar_residual_ffn_bwd needs for this call
// on `blocks` blocks, into *floats: the tensor-core generic body's own grid
// and slots, every other body's `blocks` slots of dparams' size.  Returns a
// cudaError_t code.
int tmar_residual_ffn_bwd_workspace(long long M, int D, int H, int blocks, int is_bf16,
                                    long long* floats) {
  if (M < 1 || D < 1 || H < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  if (ffn_g::body(D, H, is_bf16) == ffn_g::TENSOR_CORE) {
    ffn_g::Plan P;
    ffn_g::plan(D, H, &P);
    ffn_g::Launch L;
    const int err = ffn_g::grid_for(P, (long)M, &L);
    if (err != 0) return err;
    *floats = (long long)L.floats;
    return 0;
  }
  *floats = (long long)blocks * (5LL * D + 2LL * D * H + H);
  return 0;
}

// The body (ffn_g::Body, envelope.py: FFN_BODIES) that runs (D, H) at this
// I/O type.
int tmar_residual_ffn_bwd_body(int D, int H, int is_bf16) { return ffn_g::body(D, H, is_bf16); }

// The shared memory, in bytes, of the CUDA-core generic body's launch at
// width D in tiles of R rows with hidden chunks of HC columns.
long long tmar_residual_ffn_bwd_smem(int D, int HC, int R) { return (long long)rt_bytes(D, HC, R); }

// The shared memory, in bytes, of the tensor-core generic body's plan at
// (D, H); -1 where it takes none.
long long tmar_residual_ffn_bwd_mma_smem(int D, int H) {
  ffn_g::Plan P;
  return ffn_g::plan(D, H, &P) ? (long long)P.bytes : -1;
}

const char* tmar_residual_ffn_bwd_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
