// Post-norm residual FFN (the tail of an NSTB), forward, in one launch (K5).
//
// Replaces the TPU kernel tmar/ops/pallas_ffn.py:_ffn_kernel (:352, driven
// by _forward, pallas_call at :124).  Plain versions:
// tmar_torch/ops/ffn.py:ffn_math (float32) and
// tmar_torch/ops/cuda_ffn.py:ffn_kernel_math (bfloat16).
//
//   y = x + LN1(attn_out)              (LN1 is applied to attn_out, not x)
//   z = y + LN2(fc2(GELU(fc1(y))))     GELU with the TPU kernel's erf (gelu.cuh)
// on [M, D] token rows with an H-wide hidden layer, for any M: the last
// tile is ragged, nothing is padded.  LayerNorm statistics and the GELU are
// float32 whatever the I/O type.  Four bodies, picked by the widths and the
// I/O type alone (ffn_g::body, the rule K6 follows too, and
// tmar_torch/ops/envelope.py:ffn_body):
//
// The body templated on the full-width NGswin's (D, H) = (64, 128) runs
// float32 there: a 64-row tile and both weights in shared memory.
//
// The tensor-core body (bfloat16 at D = 64, H = 128) rounds where _ffn_kernel rounds
// when the block feeds it bf16 (tmar/nn/blocks.py:148-155): w1 and w2, y
// before fc1, the GELU output before fc2, the output.  What bounds it on an
// H100: bytes (33 kFLOP per row against 384 bytes moved, far below the
// ~295 FLOP/byte at which the bf16 tensor cores would be the limit).
// Design: one persistent block of 16 warps per SM; w1 and w2 are rounded to
// bf16 from the float32 parameters, through their strides, and staged once
// per block (ffn_mma.cuh); each warp walks over 16-row strips, its x and
// attn_out strips arriving by cp.async, 16 bytes a lane, double-buffered so
// that the next strip loads while this one computes; LN1, fc1, GELU, fc2 and
// LN2 run in the warp's registers on mma.sync (ffn_mma.cuh, the same code as
// K2/K8's FFN tail), and z goes back through the x strip as 16-byte stores.
//
// The tensor-core generic body (bfloat16 at every other width with a plan:
// D a multiple of 8 up to 128) is the same chain with the widths at run
// time, on K6's generic plan rules (ffn_generic_mma.cuh: FwdPlan, the strip
// helpers, D padded to 16 up to the fragment width DM of 32, 64 or 128 and
// the hidden width to 16, zeros in the padding, the LayerNorms over the true
// D).  It rounds where the flagship body rounds.  What bounds it on an H100:
// bytes at the demo width (D 32, hidden 64: 8.2 kFLOP a row against 192
// bytes), operations at the envelope's top (D 128, hidden 512: 262 kFLOP a
// row against 768 bytes, about 341 FLOP/byte).  Design: blocks of 8 warps;
// each warp keeps y, its bf16 A fragments and fc2's accumulators of a 16-row
// strip in registers and walks the hidden width in 16-column chunks (fc1 on
// mma.sync, the GELU, the chunk re-packed as fc2's A fragment).  The weights
// are rounded to bf16 from the float32 parameters in the kernel: where both
// fit a block ("resident") once per persistent block, and then each warp
// walks its own strips, x and attn_out arriving by cp.async double-buffered,
// with no block barrier, one launch; else ("streamed", the envelope's top:
// 272 KB of bf16 weights at D 128, hidden 512) a weights kernel first rounds
// them once per call into scratch in the staged layout (K6's, ffn_g::
// round_weights), and the block walks tiles of 128 rows, staging 64 hidden
// columns of w1 and rows of w2 at a time by cp.async, two stages in turn so
// that the next loads while this one computes: two launches.
//
// The CUDA-core generic body takes D and H at run time (float32 at every
// other width, and bfloat16 where the tensor-core generic body takes no
// plan): a persistent block walks over tiles of R rows held in shared
// memory, sized at launch (R the most of 64, 32, ..., 1 that fit a block:
// 64 up to the widths of the tensor-core bodies, 32 at D = 256 and hidden
// 1024, 16 at D = 512 and hidden 2048; where one row's hidden width alone
// does not fit, the hidden layer in chunks of HC columns); the weights are
// read from device memory (L2) through their strides, so no width is
// refused for its weights.  Products
// on the CUDA cores in float32; at bfloat16 it rounds where ffn_kernel_math
// does.

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

// shared memory, in floats
constexpr int S_Y = 0;                     // attn_out, then y
constexpr int S_H = S_Y + ROWS * LX;       // hidden
constexpr int S_F = S_H + ROWS * LH;       // fc2 out
constexpr int S_W1 = S_F + ROWS * LX;
constexpr int S_W2 = S_W1 + D * LW1;
constexpr int S_VEC = S_W2 + HID * LW2;    // g1 b1 bw2 g2 b2 [D] each, then bw1 [HID]
constexpr int FLOATS = S_VEC + 5 * D + HID;
constexpr size_t BYTES = FLOATS * sizeof(float);
static_assert(BYTES <= MAX_SMEM, "tile does not fit in shared memory");

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) residual_ffn_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ ao, const float* __restrict__ g1,
    const float* __restrict__ b1, const float* __restrict__ w1, int w1_k, int w1_n,
    const float* __restrict__ bw1, const float* __restrict__ w2, int w2_k, int w2_n,
    const float* __restrict__ bw2, const float* __restrict__ g2,
    const float* __restrict__ b2, T* __restrict__ out, long M, float eps) {
  extern __shared__ float smem[];
  float* sY = smem + S_Y;
  float* sH = smem + S_H;
  float* sF = smem + S_F;
  float* s_w1 = smem + S_W1;
  float* s_w2 = smem + S_W2;
  float* s_g1 = smem + S_VEC;
  float* s_b1 = s_g1 + D;
  float* s_bw2 = s_b1 + D;
  float* s_g2 = s_bw2 + D;
  float* s_b2 = s_g2 + D;
  float* s_bw1 = s_b2 + D;

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
    s_b2[e] = b2[e];
  }
  for (int e = tid; e < HID; e += THREADS) s_bw1[e] = bw1[e];
  __syncthreads();

  const int tiles = (int)((M + ROWS - 1) / ROWS);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * ROWS;

    // 1. y = x + LN1(attn_out), one warp per row, two channels per lane
    for (int r = warp; r < ROWS; r += THREADS / 32) {
      const bool ok = row0 + r < M;
      const size_t base = (size_t)(row0 + r) * D;
      const float a0 = ok ? to_f(ao[base + lane]) : 0.f;
      const float a1 = ok ? to_f(ao[base + lane + 32]) : 0.f;
      const float mu = warp_sum(a0 + a1) * (1.f / D);
      const float d0 = a0 - mu, d1 = a1 - mu;
      const float inv = rsqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.f / D) + eps);
      const float x0 = ok ? to_f(x[base + lane]) : 0.f;
      const float x1 = ok ? to_f(x[base + lane + 32]) : 0.f;
      sY[r * LX + lane] = x0 + d0 * inv * s_g1[lane] + s_b1[lane];
      sY[r * LX + lane + 32] = x1 + d1 * inv * s_g1[lane + 32] + s_b1[lane + 32];
    }
    __syncthreads();

    // 2. hidden = GELU(y @ w1 + bw1)
    {
      float acc[ceil16(ROWS)][ceil16(HID)];
      mm_zero<ROWS, HID>(acc);
      mm_acc<ROWS, D, HID>(acc, sY, LX, 1, s_w1, LW1, 1);
      mm_each<ROWS, HID>(acc, [&](int m, int n, float v) { sH[m * LH + n] = act::gelu(v + s_bw1[n]); });
    }
    __syncthreads();

    // 3. f = hidden @ w2 + bw2
    {
      float acc[ceil16(ROWS)][ceil16(D)];
      mm_zero<ROWS, D>(acc);
      mm_acc<ROWS, HID, D>(acc, sH, LH, 1, s_w2, LW2, 1);
      mm_each<ROWS, D>(acc, [&](int m, int n, float v) { sF[m * LX + n] = v + s_bw2[n]; });
    }
    __syncthreads();

    // 4. z = y + LN2(f)
    for (int r = warp; r < ROWS; r += THREADS / 32) {
      if (row0 + r >= M) continue;
      const float f0 = sF[r * LX + lane], f1 = sF[r * LX + lane + 32];
      const float mu = warp_sum(f0 + f1) * (1.f / D);
      const float d0 = f0 - mu, d1 = f1 - mu;
      const float inv = rsqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.f / D) + eps);
      T* o = out + (size_t)(row0 + r) * D;
      store(o + lane, sY[r * LX + lane] + d0 * inv * s_g2[lane] + s_b2[lane]);
      store(o + lane + 32, sY[r * LX + lane + 32] + d1 * inv * s_g2[lane + 32] + s_b2[lane + 32]);
    }
    __syncthreads();
  }
}

// ---- the generic body: any (D, hidden) ------------------------------------
// A persistent block walks over tiles of R rows; y, HC columns of the hidden
// layer and fc2's output of a tile sit in shared memory in float32 (rows
// padded to an odd length), rt_bytes at launch (tmar_torch/ops/envelope.py:
// ffn_fwd_bytes counts the same, ffn_tiles picks R and HC).  fc2's output
// sums the chunks' products in place, each element by its one owner.  The weights are read from device memory
// through their strides (L2 holds them), rounded to T's values as they are
// read.  At bfloat16 it rounds where ffn_kernel_math
// does: y before fc1, the GELU output before fc2, the output.
size_t rt_bytes(int D, int HC, int R) { return (size_t)4 * R * (2 * (D + 1) + HC + 1); }

template <typename T>
__global__ void __launch_bounds__(THREADS) residual_ffn_fwd_rt(
    const T* __restrict__ x, const T* __restrict__ ao, const float* __restrict__ g1,
    const float* __restrict__ b1, const float* __restrict__ w1, int w1_k, int w1_n,
    const float* __restrict__ bw1, const float* __restrict__ w2, int w2_k, int w2_n,
    const float* __restrict__ bw2, const float* __restrict__ g2,
    const float* __restrict__ b2, T* __restrict__ out, long M, int D, int H, int R, int HC,
    float eps) {
  extern __shared__ float smem[];
  const int LX = D + 1, LH = HC + 1;
  float* sY = smem;
  float* sH = sY + R * LX;
  float* sF = sH + R * LH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const long tiles = (M + R - 1) / R;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = tile * R;
    const int rows = (int)(M - row0 < R ? M - row0 : R);

    // 1. y = x + LN1(attn_out), one warp per row
    for (int r = warp; r < rows; r += THREADS / 32) {
      const T* a = ao + (size_t)(row0 + r) * D;
      const T* xr = x + (size_t)(row0 + r) * D;
      const float2 st = row_stats(D, eps, [&](int c) { return to_f(a[c]); });
      for (int c = lane; c < D; c += 32)
        sY[r * LX + c] = to_f(xr[c]) + (to_f(a[c]) - st.x) * st.y * g1[c] + b1[c];
    }
    __syncthreads();

    // 2. hidden = T(GELU(T(y) @ T(w1) + bw1)), HC columns at a time;
    // 3. f = hidden @ T(w2) + bw2, the chunks' products added in place
    for (int c0 = 0; c0 < H; c0 += HC) {
      const int hc = H - c0 < HC ? H - c0 : HC;
      mm_rt(rows, hc, D, [&](int m, int k) { return round_as<T>(sY[m * LX + k]); },
            [&](int k, int n) {
              return round_as<T>(__ldg(w1 + (size_t)k * w1_k + (size_t)(c0 + n) * w1_n));
            },
            [&](int m, int n, float v) {
              sH[m * LH + n] = round_as<T>(act::gelu(v + __ldg(bw1 + c0 + n)));
            });
      __syncthreads();
      mm_rt(rows, D, hc, [&](int m, int k) { return sH[m * LH + k]; },
            [&](int k, int n) {
              return round_as<T>(__ldg(w2 + (size_t)(c0 + k) * w2_k + (size_t)n * w2_n));
            },
            [&](int m, int n, float v) {
              sF[m * LX + n] = c0 == 0 ? v + __ldg(bw2 + n) : sF[m * LX + n] + v;
            });
      __syncthreads();
    }

    // 4. z = y + LN2(f)
    for (int r = warp; r < rows; r += THREADS / 32) {
      const float* f = sF + r * LX;
      const float2 st = row_stats(D, eps, [&](int c) { return f[c]; });
      T* o = out + (size_t)(row0 + r) * D;
      for (int c = lane; c < D; c += 32)
        store(o + c, sY[r * LX + c] + (f[c] - st.x) * st.y * g2[c] + b2[c]);
    }
    __syncthreads();
  }
}

// ---- the bfloat16 body: tensor cores --------------------------------------
constexpr int MMA_WARPS = 16;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
// shared memory: float32 g1 b1 g2 b2 bw2 [D] each and bw1 [HID]; then bf16:
// the staged weights, and per warp two stages of (x, attn_out) strips
constexpr int M_FLOATS = 5 * D + HID;
constexpr size_t MMA_BYTES =
    M_FLOATS * sizeof(float) +
    (size_t)(ffn::WELEMS + MMA_WARPS * 4 * ffn::STRIP) * sizeof(__nv_bfloat16);
static_assert(ffn::D == D && ffn::HID == HID, "the FFN widths");
static_assert(M_FLOATS % 4 == 0 && ffn::WELEMS % 8 == 0 && ffn::STRIP % 8 == 0,
              "16-byte aligned regions");
static_assert(MMA_BYTES <= MAX_SMEM, "strips do not fit in shared memory");

__global__ void __launch_bounds__(MMA_THREADS, 1) residual_ffn_fwd_mma(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ ao,
    const float* __restrict__ g1, const float* __restrict__ b1, const float* __restrict__ w1,
    int w1_k, int w1_n, const float* __restrict__ bw1, const float* __restrict__ w2, int w2_k,
    int w2_n, const float* __restrict__ bw2, const float* __restrict__ g2,
    const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, long M, float eps) {
  extern __shared__ float4 smem4[];
  float* s_g1 = reinterpret_cast<float*>(smem4);
  float* s_b1 = s_g1 + D;
  float* s_g2 = s_b1 + D;
  float* s_b2 = s_g2 + D;
  float* s_bw2 = s_b2 + D;
  float* s_bw1 = s_bw2 + D;
  __nv_bfloat16* s_w1 = reinterpret_cast<__nv_bfloat16*>(s_g1 + M_FLOATS);
  __nv_bfloat16* s_w2 = s_w1 + HID * ffn::LW1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  ffn::stage_weights(s_w1, s_w2, w1, w1_k, w1_n, w2, w2_k, w2_n, tid, MMA_THREADS);
  for (int e = tid; e < D; e += MMA_THREADS) {
    s_g1[e] = g1[e];
    s_b1[e] = b1[e];
    s_g2[e] = g2[e];
    s_b2[e] = b2[e];
    s_bw2[e] = bw2[e];
  }
  for (int e = tid; e < HID; e += MMA_THREADS) s_bw1[e] = bw1[e];
  __syncthreads();

  // the warp's two stages, each an x strip then an attn_out strip
  __nv_bfloat16* base = s_w1 + ffn::WELEMS + warp * 4 * ffn::STRIP;
  auto load = [&](long strip, __nv_bfloat16* stage) {
    ffn::load_strip(stage, x, 16 * strip, M, lane);
    ffn::load_strip(stage + ffn::STRIP, ao, 16 * strip, M, lane);
    cp_async_commit();
  };
  const long strips = (M + 15) / 16, stride = (long)gridDim.x * MMA_WARPS;
  long strip = (long)blockIdx.x * MMA_WARPS + warp;
  if (strip < strips) load(strip, base);
  for (int it = 0; strip < strips; ++it, strip += stride) {
    __nv_bfloat16* cur = base + (it & 1) * 2 * ffn::STRIP;
    if (strip + stride < strips)
      load(strip + stride, base + ((it + 1) & 1) * 2 * ffn::STRIP);
    else
      cp_async_commit();  // an empty group keeps the wait below uniform
    cp_async_wait_prior();
    __syncwarp();  // every lane's copies of this strip have landed

    // 1. y = x + LN1(attn_out)
    float y[8][4];
    ffn::read_strip(cur + ffn::STRIP, y, lane);
    ffn::layer_norm_rows(y, s_g1, s_b1, eps, t);
    {
      float xv[8][4];
      ffn::read_strip(cur, xv, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[j][e] += xv[j][e];
    }

    // 2. f = LN2(bf16(GELU(bf16(y) · w1 + bw1)) · w2 + bw2);  z = y + f
    float f[8][4];
    ffn::fc(y, f, s_w1, s_w2, s_bw1, s_bw2, lane);
    ffn::layer_norm_rows(f, s_g2, s_b2, eps, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[j][e] += y[j][e];

    // 3. z -> bf16 in the x strip (own rows), then out as 16-byte stores
    ffn::write_strip(cur, f, lane);
    __syncwarp();
    ffn::store_strip(out, cur, 16 * strip, M, lane);
    __syncwarp();  // the strip is read before the load after next refills it
  }
}

int launch_mma(const void* const* p, int w1_k, int w1_n, int w2_k, int w2_n, void* out, long M,
               float eps, int blocks, cudaStream_t stream) {
  if (((uintptr_t)p[0] | (uintptr_t)p[1] | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = cudaFuncSetAttribute(
      residual_ffn_fwd_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MMA_BYTES);
  if (err != cudaSuccess) return (int)err;
  residual_ffn_fwd_mma<<<blocks, MMA_THREADS, MMA_BYTES, stream>>>(
      (const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[1], (const float*)p[2],
      (const float*)p[3], (const float*)p[4], w1_k, w1_n, (const float*)p[5],
      (const float*)p[6], w2_k, w2_n, (const float*)p[7], (const float*)p[8],
      (const float*)p[9], (__nv_bfloat16*)out, M, eps);
  return (int)cudaGetLastError();
}

// ---- the tensor-core generic body: bfloat16 at any planned (D, H) -----------
namespace fwd_g {

using ffn_g::FwdPlan;

// w1 [D, H] and w2 [H, D] (read as w[k·w_k + n·w_n]) rounded to bf16 into
// s_w1 [HP][ld1] (w1 transposed) and s_w2 [DP][ld2] (w2 transposed), columns
// past H as zeros, by the block (the resident weights, once per block); each
// weight is walked along its unit stride where it has one, its loads eight a
// thread in flight together
__device__ __forceinline__ void stage_weights(__nv_bfloat16* s_w1, __nv_bfloat16* s_w2,
                                              const FwdPlan& F, const float* __restrict__ w1,
                                              int w1_k, int w1_n, const float* __restrict__ w2,
                                              int w2_k, int w2_n, int tid) {
  const int D = F.D, H = F.H, n = F.HP, n1 = n * D;
  const bool h1 = w1_n == 1, h2 = w2_k == 1;  // the hidden index along the unit stride
  auto at = [&](int e, int& h, int& d) {
    const bool second = e >= n1, hf = second ? h2 : h1;
    const int i = second ? e - n1 : e;
    h = hf ? i % n : i / D;
    d = hf ? i / n : i % D;
  };
  batched<8>(2 * n1, tid, ffn_g::THREADS, [&](int e) {
    int h, d;
    at(e, h, d);
    if (h >= H) return 0.f;
    return __ldg(e >= n1 ? w2 + (size_t)h * w2_k + (size_t)d * w2_n
                         : w1 + (size_t)d * w1_k + (size_t)h * w1_n);
  }, [&](int e, float v) {
    int h, d;
    at(e, h, d);
    if (e >= n1)
      s_w2[d * F.ld2 + h] = __float2bfloat16(v);
    else
      s_w1[h * F.ld1 + d] = __float2bfloat16(v);
  });
}

// y = x + (LN1(attn_out)·g1 + b1) of the strip st (x rows, then attn_out
// rows at st + 16·LDX), over the true D, and its bf16 A fragments ya
template <int DM>
__device__ __forceinline__ void residual_ln1(const __nv_bfloat16* st, const FwdPlan& F,
                                             const float* g1, const float* b1, float eps,
                                             float (&y)[DM / 8][4], uint32_t (&ya)[DM / 16][4],
                                             int lane) {
  constexpr int DT = DM / 8;
  const int t = lane & 3;
  float xv[DT][4], inv[2];
  ffn_g::read_strip(st + 16 * F.LDX, F.LDX, y, F.D8, lane);
  ffn_g::normalize_rows(y, eps, inv, F.D8);
  ffn_g::read_strip(st, F.LDX, xv, F.D8, lane);
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);
      y[j][e] = xv[j][e] + (y[j][e] * g1[c] + b1[c]);
    }
#pragma unroll
  for (int kk = 0; kk < DM / 16; ++kk) to_a(ya[kk], y[2 * kk], y[2 * kk + 1]);
}

// o += bf16(GELU(yc·w1 + bw1))·w2 over hidden columns [h0, h0 + n), the
// weights staged from hidden column `base` (s_w1 [h - base][ld1], s_w2
// [d][ld2] at column h - base)
template <int DM>
__device__ __forceinline__ void hidden_chunks(const uint32_t (&ya)[DM / 16][4], float (&o)[DM / 8][4],
                                              const __nv_bfloat16* s_w1,
                                              const __nv_bfloat16* s_w2, const float* bw1,
                                              const FwdPlan& F, int h0, int n, int base,
                                              int lane) {
  constexpr int DK = DM / 16;
  const int t = lane & 3, dk = F.dk;
#pragma unroll 1
  for (int h = h0; h < h0 + n; h += 16) {
    float hid[2][4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = h + 8 * hf + 2 * t;
      hid[hf][0] = hid[hf][2] = bw1[c];
      hid[hf][1] = hid[hf][3] = bw1[c + 1];
    }
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      if (kk >= dk) break;
      mma_pair(hid[0], hid[1], ya[kk], s_w1, F.ld1, h - base, 16 * kk, lane);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) hid[hf][e] = act::gelu(hid[hf][e]);
    uint32_t ha[4];
    to_a(ha, hid[0], hid[1]);
#pragma unroll
    for (int n2 = 0; n2 < DK; ++n2) {
      if (n2 >= dk) break;
      mma_pair(o[2 * n2], o[2 * n2 + 1], ha, s_w2, F.ld2, 16 * n2, h - base, lane);
    }
  }
}

// z = y + (LN2(o)·g2 + b2) -> bf16 into the x rows of the strip, then rows
// [row0, row0 + 16) of out, those below M
template <int DM>
__device__ __forceinline__ void finish(float (&o)[DM / 8][4], const float (&y)[DM / 8][4],
                                       __nv_bfloat16* st, const FwdPlan& F, const float* g2,
                                       const float* b2, float eps, __nv_bfloat16* out,
                                       long row0, long M, int lane) {
  const int t = lane & 3;
  float inv[2];
  ffn_g::normalize_rows(o, eps, inv, F.D8);
#pragma unroll
  for (int j = 0; j < DM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);
      o[j][e] = (o[j][e] * g2[c] + b2[c]) + y[j][e];
    }
  ffn_g::write_strip(st, F.LDX, o, F.D8, lane);
  __syncwarp();
  ffn_g::store_rows(out, st, row0, M, F.D, F.LDX, lane);
  __syncwarp();  // the strip is read before it is refilled
}

template <int DM>
__global__ void __launch_bounds__(ffn_g::THREADS, DM == 128 ? 1 : 2) residual_ffn_fwd_gmma(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ ao,
    const float* __restrict__ g1, const float* __restrict__ b1, const float* __restrict__ w1,
    int w1_k, int w1_n, const float* __restrict__ bw1, const float* __restrict__ w2, int w2_k,
    int w2_n, const float* __restrict__ bw2, const float* __restrict__ g2,
    const float* __restrict__ b2, const __nv_bfloat16* __restrict__ gw1,
    const __nv_bfloat16* __restrict__ gw2, __nv_bfloat16* __restrict__ out, long M, FwdPlan F,
    float eps) {
  constexpr int DT = DM / 8, DK = DM / 16, WARPS = ffn_g::WARPS, NT = ffn_g::THREADS;
  extern __shared__ float4 smem4[];
  float* sf = reinterpret_cast<float*>(smem4);
  float *s_g1 = sf, *s_b1 = sf + F.DP, *s_g2 = sf + 2 * F.DP, *s_b2 = sf + 3 * F.DP;
  float *s_bw2 = sf + 4 * F.DP, *s_bw1 = sf + 5 * F.DP;
  __nv_bfloat16* s_w1 = reinterpret_cast<__nv_bfloat16*>(sf + F.floats);
  __nv_bfloat16* s_w2 = s_w1 + F.w2off;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int D = F.D, LDX = F.LDX;
  __nv_bfloat16* mine = s_w1 + F.welems + warp * F.strip_elems;

  // once per block: zeros (the padding of the weights and strips), the
  // float32 vectors, resident weights
  for (int i = tid; i < (F.welems + WARPS * F.strip_elems) / 8; i += NT)
    reinterpret_cast<uint4*>(s_w1)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int n = tid; n < F.DP; n += NT) {
    const bool in = n < D;
    s_g1[n] = in ? g1[n] : 0.f;
    s_b1[n] = in ? b1[n] : 0.f;
    s_g2[n] = in ? g2[n] : 0.f;
    s_b2[n] = in ? b2[n] : 0.f;
    s_bw2[n] = in ? bw2[n] : 0.f;
  }
  for (int n = tid; n < F.HP; n += NT) s_bw1[n] = n < F.H ? bw1[n] : 0.f;
  __syncthreads();  // the zeros are down before the weights go over them
  if (F.resident) stage_weights(s_w1, s_w2, F, w1, w1_k, w1_n, w2, w2_k, w2_n, tid);
  __syncthreads();

  auto load = [&](long row0, __nv_bfloat16* st) {
    ffn_g::load_rows(st, x, row0, M, D, LDX, lane);
    ffn_g::load_rows(st + 16 * LDX, ao, row0, M, D, LDX, lane);
    cp_async_commit();
  };
  auto init = [&](float (&o)[DT][4]) {
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int c = 8 * j + 2 * t;
      o[j][0] = o[j][2] = s_bw2[c];
      o[j][1] = o[j][3] = s_bw2[c + 1];
    }
  };

  if (F.resident) {
    // each warp walks its strips, the next one loading while this one computes
    const long strips = (M + 15) / 16, stride = (long)gridDim.x * WARPS;
    long strip = (long)blockIdx.x * WARPS + warp;
    if (strip < strips) load(16 * strip, mine);
    for (int it = 0; strip < strips; ++it, strip += stride) {
      __nv_bfloat16* cur = mine + (it & 1) * 2 * 16 * LDX;
      if (strip + stride < strips)
        load(16 * (strip + stride), mine + ((it + 1) & 1) * 2 * 16 * LDX);
      else
        cp_async_commit();  // an empty group keeps the wait below uniform
      cp_async_wait_prior();
      __syncwarp();  // every lane's copies of this strip have landed
      float y[DT][4], o[DT][4];
      uint32_t ya[DK][4];
      residual_ln1<DM>(cur, F, s_g1, s_b1, eps, y, ya, lane);
      init(o);
      hidden_chunks<DM>(ya, o, s_w1, s_w2, s_bw1, F, 0, F.HP, 0, lane);
      finish<DM>(o, y, cur, F, s_g2, s_b2, eps, out, 16 * strip, M, lane);
    }
    return;
  }
  // streamed: the block walks tiles of 128 rows, a strip a warp; the bf16
  // weights of round_weights' layout (gw1 [HP][ld1], gw2 [DP][HP + 8]) come
  // CHUNK hidden columns a stage by cp.async, two stages in turn, the next
  // one loading while this one computes
  const int chunks = (F.HP + ffn_g::CHUNK - 1) / ffn_g::CHUNK, gld2 = F.HP + 8;
  auto stage = [&](int k) {
    const int c0 = k * ffn_g::CHUNK, n = min(ffn_g::CHUNK, F.HP - c0), r1 = F.ld1 / 8, r2 = n / 8;
    __nv_bfloat16* b1w = s_w1 + (k & 1) * F.stage_elems;
    __nv_bfloat16* b2w = b1w + F.w2off;
    for (int c = tid; c < n * r1; c += NT)
      cp_async16(b1w + (c / r1) * F.ld1 + 8 * (c % r1), gw1 + (size_t)(c0 + c / r1) * F.ld1 + 8 * (c % r1));
    for (int c = tid; c < F.DP * r2; c += NT)
      cp_async16(b2w + (c / r2) * F.ld2 + 8 * (c % r2), gw2 + (size_t)(c / r2) * gld2 + c0 + 8 * (c % r2));
    cp_async_commit();
  };
  const long tiles = (M + ffn_g::TILE - 1) / ffn_g::TILE;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = tile * ffn_g::TILE + 16 * warp;
    load(row0, mine);
    stage(0);
    cp_async_wait_all();
    __syncthreads();  // every thread's copies of the strips and stage 0 have landed
    float y[DT][4], o[DT][4];
    uint32_t ya[DK][4];
    residual_ln1<DM>(mine, F, s_g1, s_b1, eps, y, ya, lane);
    init(o);
#pragma unroll 1
    for (int k = 0; k < chunks; ++k) {
      if (k + 1 < chunks) stage(k + 1);
      const int c0 = k * ffn_g::CHUNK;
      const __nv_bfloat16* b1w = s_w1 + (k & 1) * F.stage_elems;
      hidden_chunks<DM>(ya, o, b1w, b1w + F.w2off, s_bw1, F, c0, min(ffn_g::CHUNK, F.HP - c0), c0,
                        lane);
      cp_async_wait_all();
      __syncthreads();  // the next stage has landed; every warp is done with this one
    }
    finish<DM>(o, y, mine, F, s_g2, s_b2, eps, out, row0, M, lane);
  }
}

// The streamed body's weights, rounded to bf16 once per call into scratch
// (ffn_g::round_weights, the layout K6's weights kernel writes)
__global__ void residual_ffn_fwd_gmma_weights(const float* __restrict__ w1, int w1_k, int w1_n,
                                              const float* __restrict__ w2, int w2_k, int w2_n,
                                              __nv_bfloat16* __restrict__ gw1,
                                              __nv_bfloat16* __restrict__ gw2, int D, int H,
                                              int DP, int HP) {
  ffn_g::round_weights(w1, w1_k, w1_n, w2, w2_k, w2_n, gw1, gw2, D, H, DP, HP);
}

// The floats of scratch this body needs at (D, H): the streamed weights', 0
// where they are resident
size_t workspace(const FwdPlan& F) { return F.resident ? 0 : ffn_g::weights_floats(F.DP, F.HP); }

template <int DM>
int launch_t(const void* const* p, int w1_k, int w1_n, int w2_k, int w2_n, void* out,
             void* scratch, long M, const FwdPlan& F, float eps, cudaStream_t stream) {
  __nv_bfloat16* gw1 = reinterpret_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* gw2 = gw1 == nullptr ? nullptr : gw1 + F.HP * F.ld1;
  if (!F.resident) {
    if (gw1 == nullptr) return (int)cudaErrorInvalidValue;
    residual_ffn_fwd_gmma_weights<<<ffn_g::weights_blocks(F.DP, F.HP), 256, 0, stream>>>(
        (const float*)p[4], w1_k, w1_n, (const float*)p[6], w2_k, w2_n, gw1, gw2, F.D, F.H, F.DP,
        F.HP);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  static int cache[64][3] = {};
  int total = 0;
  const int err = tmar::persistent_grid(residual_ffn_fwd_gmma<DM>, F.bytes, ffn_g::THREADS, cache,
                                        &total);
  if (err != 0) return err;
  // work units: a warp's strips resident, a block's tiles streamed
  const long units = F.resident ? ((M + 15) / 16 + ffn_g::WARPS - 1) / ffn_g::WARPS
                                : (M + ffn_g::TILE - 1) / ffn_g::TILE;
  const int blocks = (int)(units < total ? units : total);
  residual_ffn_fwd_gmma<DM><<<blocks, ffn_g::THREADS, F.bytes, stream>>>(
      (const __nv_bfloat16*)p[0], (const __nv_bfloat16*)p[1], (const float*)p[2],
      (const float*)p[3], (const float*)p[4], w1_k, w1_n, (const float*)p[5], (const float*)p[6],
      w2_k, w2_n, (const float*)p[7], (const float*)p[8], (const float*)p[9], gw1, gw2,
      (__nv_bfloat16*)out, M, F, eps);
  return (int)cudaGetLastError();
}

// This body on bf16 x, attn_out and out (16-byte aligned); p as
// tmar_residual_ffn_fwd's, scratch of workspace(F) floats (16-byte
// aligned).  One launch with resident weights, two streamed (the weights
// kernel first).  cudaErrorInvalidValue where it takes no plan.
int launch(const void* const* p, int w1_k, int w1_n, int w2_k, int w2_n, void* out,
           void* scratch, long M, int D, int H, float eps, cudaStream_t s) {
  FwdPlan F;
  if (!ffn_g::fwd_plan(D, H, &F)) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)p[0] | (uintptr_t)p[1] | (uintptr_t)out | (uintptr_t)scratch) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int DM = ffn_g::dm_of(F.DP);
  if (DM == 32) return launch_t<32>(p, w1_k, w1_n, w2_k, w2_n, out, scratch, M, F, eps, s);
  if (DM == 64) return launch_t<64>(p, w1_k, w1_n, w2_k, w2_n, out, scratch, M, F, eps, s);
  return launch_t<128>(p, w1_k, w1_n, w2_k, w2_n, out, scratch, M, F, eps, s);
}

}  // namespace fwd_g

template <typename T>
int launch(const void* const* p, int w1_k, int w1_n, int w2_k, int w2_n, void* out, long M,
           float eps, int blocks, cudaStream_t stream) {
  auto kern = residual_ffn_fwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BYTES);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, THREADS, BYTES, stream>>>(
      (const T*)p[0], (const T*)p[1], (const float*)p[2], (const float*)p[3],
      (const float*)p[4], w1_k, w1_n, (const float*)p[5], (const float*)p[6], w2_k, w2_n,
      (const float*)p[7], (const float*)p[8], (const float*)p[9], (T*)out, M, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rt(const void* const* p, int w1_k, int w1_n, int w2_k, int w2_n, void* out, long M,
              int D, int H, int R, int HC, float eps, int blocks, cudaStream_t stream) {
  const size_t bytes = rt_bytes(D, HC, R);
  auto kern = residual_ffn_fwd_rt<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, THREADS, bytes, stream>>>(
      (const T*)p[0], (const T*)p[1], (const float*)p[2], (const float*)p[3],
      (const float*)p[4], w1_k, w1_n, (const float*)p[5], (const float*)p[6], w2_k, w2_n,
      (const float*)p[7], (const float*)p[8], (const float*)p[9], (T*)out, M, D, H, R, HC, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, attn_out [M, D] (float32 or bfloat16, per is_bf16) -> out of the same
// shape and type.  All parameters are float32: LN gains and biases g1, b1,
// g2, b2 [D]; w1 [D, H] and w2 [H, D] are read as w[k·w_k + n·w_n]; bw1 [H],
// bw2 [D].  The body is ffn_g::body's: at (D, H) = (64, 128) the tensor-core
// body (bfloat16) or the templated one (float32); bfloat16 wherever it has a
// plan the tensor-core generic body (both with x, attn_out and out 16-byte
// aligned, each on its own persistent grid; the generic one reads `scratch`,
// tmar_residual_ffn_fwd_workspace's floats, null where that is 0); else the
// CUDA-core generic body, in tiles of R rows (R <= 64) with the hidden layer
// in chunks of HC columns (HC <= H), its tile within the card's shared memory.  `blocks` is the number of persistent blocks of
// the templated and CUDA-core bodies.  Returns a cudaError_t code (0 on a
// clean launch).
int tmar_residual_ffn_fwd(const void* x, const void* ao, const void* g1, const void* b1,
                          const void* w1, const void* bw1, const void* w2, const void* bw2,
                          const void* g2, const void* b2, void* out, void* scratch, long long M,
                          int D, int H, int R, int HC, int w1_k, int w1_n, int w2_k, int w2_n,
                          float eps, int blocks, int is_bf16, void* stream) {
  if (M < 1 || D < 1 || H < 1 || R < 1 || R > ROWS || HC < 1 || HC > H || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const void* p[10] = {x, ao, g1, b1, w1, bw1, w2, bw2, g2, b2};
  cudaStream_t s = (cudaStream_t)stream;
  switch (ffn_g::body(D, H, is_bf16)) {
    case ffn_g::FLAGSHIP:
      return launch_mma(p, w1_k, w1_n, w2_k, w2_n, out, (long)M, eps, blocks, s);
    case ffn_g::TEMPLATED:
      return launch<float>(p, w1_k, w1_n, w2_k, w2_n, out, (long)M, eps, blocks, s);
    case ffn_g::TENSOR_CORE:
      return fwd_g::launch(p, w1_k, w1_n, w2_k, w2_n, out, scratch, (long)M, D, H, eps, s);
    default:
      break;
  }
  if (rt_bytes(D, HC, R) > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_rt<__nv_bfloat16>(p, w1_k, w1_n, w2_k, w2_n, out, (long)M, D, H, R, HC, eps,
                                    blocks, s);
  return launch_rt<float>(p, w1_k, w1_n, w2_k, w2_n, out, (long)M, D, H, R, HC, eps, blocks, s);
}

// The body (ffn_g::Body, envelope.py: FFN_BODIES) that runs (D, H) at this
// I/O type: K6's (tmar_residual_ffn_bwd_body), by the same rule.
int tmar_residual_ffn_fwd_body(int D, int H, int is_bf16) { return ffn_g::body(D, H, is_bf16); }

// The floats of scratch tmar_residual_ffn_fwd needs at (D, H) and this I/O
// type, into *floats: the tensor-core generic body's streamed weights, else
// 0.  Returns a cudaError_t code.
int tmar_residual_ffn_fwd_workspace(int D, int H, int is_bf16, long long* floats) {
  if (D < 1 || H < 1) return (int)cudaErrorInvalidValue;
  ffn_g::FwdPlan F;
  *floats = ffn_g::body(D, H, is_bf16) == ffn_g::TENSOR_CORE && ffn_g::fwd_plan(D, H, &F)
                ? (long long)fwd_g::workspace(F)
                : 0;
  return 0;
}

// The shared memory, in bytes, of the tensor-core generic body's plan at
// (D, H); -1 where it takes none.
long long tmar_residual_ffn_fwd_mma_smem(int D, int H) {
  ffn_g::FwdPlan F;
  return ffn_g::fwd_plan(D, H, &F) ? (long long)F.bytes : -1;
}

// The shared memory, in bytes, of the CUDA-core generic body's launch at
// width D in tiles of R rows with hidden chunks of HC columns.
long long tmar_residual_ffn_fwd_smem(int D, int HC, int R) { return (long long)rt_bytes(D, HC, R); }

const char* tmar_residual_ffn_fwd_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
