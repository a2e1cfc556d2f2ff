// Post-norm residual FFN, backward: all ten cotangents.
//
// Replaces the TPU kernel tmar/ops/pallas_ffn.py:_ffn_bwd_kernel (:249,
// driven by _backward, pallas_call at :180).  Plain version: autograd of
// tmar_torch/ops/ffn.py:ffn_math.  Forward: residual_ffn_fwd.cu.
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
// What bounds it on an H100: operations, about three times the forward's.
// Design: the forward's tiling.  The TPU grid is sequential and accumulates
// the eight parameter cotangents in place; CUDA blocks run in no order, so
// each block keeps its own sums (dw1 and dw2 in registers across its tiles,
// the vectors in shared memory), writes them to part[block], and a second
// kernel adds the slots in block order.  No float atomics: two runs give the
// same bits.

#include "common.cuh"

namespace {

using namespace tmar;

constexpr int D = 64;
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

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// d GELU(u) / du = Φ(u) + u φ(u)
__device__ __forceinline__ float gelu_grad(float u) {
  const float cdf = 0.5f * (1.f + erff(u * 0.70710678118654752f));
  const float pdf = expf(-0.5f * u * u) * 0.3989422804014327f;
  return cdf + u * pdf;
}

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
        sH[m * LH + n] = gelu(u);
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
        sU[m * LH + n] = v * gelu_grad(sU[m * LH + n]);
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

}  // namespace

extern "C" {

// x, attn_out, dz [M, 64] (float32 or bfloat16, per is_bf16) -> dx and
// d attn_out of the same shape and type, and dparams, float32, the
// concatenation of dg1 [64], db1 [64], dw1 [64, 128], dbw1 [128],
// dw2 [128, 64], dbw2 [64], dg2 [64], db2 [64].  `part` is scratch of
// `blocks` times that size.  The parameters are the forward's (b2 is not
// needed).  Returns a cudaError_t code (0 on a clean launch).
int tmar_residual_ffn_bwd(const void* x, const void* ao, const void* dz, const void* g1,
                          const void* b1, const void* w1, const void* bw1, const void* w2,
                          const void* bw2, const void* g2, void* dx, void* dao, void* part,
                          void* dparams, long long M, int w1_k, int w1_n, int w2_k, int w2_n,
                          float eps, int blocks, int is_bf16, void* stream) {
  if (M < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const void* p[10] = {x, ao, dz, g1, b1, w1, bw1, w2, bw2, g2};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(p, w1_k, w1_n, w2_k, w2_n, dx, dao, part, dparams, (long)M,
                                 eps, blocks, s);
  return launch<float>(p, w1_k, w1_n, w2_k, w2_n, dx, dao, part, dparams, (long)M, eps,
                       blocks, s);
}

const char* tmar_residual_ffn_bwd_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
