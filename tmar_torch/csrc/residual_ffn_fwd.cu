// Post-norm residual FFN (the tail of an NSTB), forward, in one launch (K5).
//
// Replaces the TPU kernel tmar/ops/pallas_ffn.py:_ffn_kernel (:352, driven
// by _forward, pallas_call at :124).  Plain versions:
// tmar_torch/ops/ffn.py:ffn_math (float32) and
// tmar_torch/ops/cuda_ffn.py:ffn_kernel_math (bfloat16).
//
//   y = x + LN1(attn_out)              (LN1 is applied to attn_out, not x)
//   z = y + LN2(fc2(GELU(fc1(y))))     exact (erf) GELU
// on [M, 64] token rows with a 128-wide hidden layer, for any M: the last
// tile is ragged, nothing is padded.  LayerNorm statistics and the GELU are
// float32 whatever the I/O type.  The I/O type picks one of two bodies.
//
// The float32 body, the exactness path.  A persistent block per SM walks
// over tiles of 64 rows; both weight matrices sit in shared memory in float32
// for the whole launch, read through strides so that a transposed view needs
// no copy; the tile stays in shared memory between the stages, so device
// memory sees each input and output element once.  Products run on the CUDA
// cores in float32.
//
// The bfloat16 body, on the tensor cores, rounds where _ffn_kernel rounds
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

#include "common.cuh"
#include "ffn_mma.cuh"

namespace {

using namespace tmar;

constexpr int D = 64;
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

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

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
      mm_each<ROWS, HID>(acc, [&](int m, int n, float v) { sH[m * LH + n] = gelu(v + s_bw1[n]); });
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

}  // namespace

extern "C" {

// x, attn_out [M, 64] (float32 or bfloat16, per is_bf16) -> out of the same
// shape and type: bfloat16 runs the tensor-core body (x, attn_out and out
// 16-byte aligned), float32 the float32 body.  All parameters are float32:
// LN gains and biases g1, b1, g2, b2 [64]; w1 [64, 128] and w2 [128, 64] are
// read as w[k·w_k + n·w_n]; bw1 [128], bw2 [64].  `blocks` is the number of
// persistent blocks, at most one per SM.  Returns a cudaError_t code (0 on a
// clean launch).
int tmar_residual_ffn_fwd(const void* x, const void* ao, const void* g1, const void* b1,
                          const void* w1, const void* bw1, const void* w2, const void* bw2,
                          const void* g2, const void* b2, void* out, long long M, int w1_k,
                          int w1_n, int w2_k, int w2_n, float eps, int blocks, int is_bf16,
                          void* stream) {
  if (M < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const void* p[10] = {x, ao, g1, b1, w1, bw1, w2, bw2, g2, b2};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return launch_mma(p, w1_k, w1_n, w2_k, w2_n, out, (long)M, eps, blocks, s);
  return launch<float>(p, w1_k, w1_n, w2_k, w2_n, out, (long)M, eps, blocks, s);
}

const char* tmar_residual_ffn_fwd_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
