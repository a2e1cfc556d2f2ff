// Scaled-cosine window attention, forward, in one launch.
//
// Replaces the TPU kernels tmar/ops/pallas_attention.py:_attn_kernel_batched
// (:1143, the 64-token windows) and :_attn_kernel (:1175, the block-diagonal
// kernel of the 4-token n-gram windows), both driven by _fused_forward
// (pallas_call at :357).  They compute one function at two window lengths.
// Plain version: tmar_torch/ops/cuda_attention.py:window_attention_kernel_math
// (at float32, tmar_torch/ops/attention.py:window_attention_math).
//
// Per window x [N, D]:
//   qkv = x @ wqkv + bqkv;  q, k L2-normalised per head
//   s   = q·kᵀ · scale[h] + bias[h] (+ the gated shift mask)
//   p   = softmax(s), with the row max subtracted
//   out = (p @ v, heads merged) @ wproj + bproj
// The shift mask of window (r, c) of a (wh, ww) grid is
// [r == wh-1]·m_row + [c == ww-1]·m_col; wh = 0 means no mask.  The kernel
// also writes lse[win, h, i] = max + log(sum), which the backward kernel
// reads in place of a second softmax pass.
//
// Two bodies, chosen by the I/O type and the window length:
// * bfloat16 at N = 64 (the training step's and the unfused serving form's
//   windows): the tensor-core body below (window_attention_mma.cuh), which
//   rounds where _attn_kernel_batched rounds: bf16 weights and x, q_n, k_n,
//   v, P normalised in float32 then rounded (:1133-1135), the merged head
//   outputs before the projection (:1170).
// * float32 at either length, and bfloat16 at N = 4: the float32 body, which
//   at bfloat16 rounds where _attn_kernel rounds at N = 4, its weights and
//   the head outputs before the projection (:1236); its scores and P·V stay
//   float32 there (v is a float32 slice, so p.astype(v.dtype) is exact).
//
// What bounds it on an H100: about 45 kFLOP per token at N = 64 against 256
// to 512 bytes moved (x, the output, lse): operations on the CUDA cores in
// float32, bytes on the tensor cores in bfloat16.
// Float32 body: a persistent block per SM walks over tiles of 64 token rows
// (one 64-token window, or sixteen 4-token windows); both weight matrices sit
// in shared memory in float32 for the whole launch, read through strides so
// that a transposed view needs no copy.  The score matrix is never stored: a
// thread owns one (head, query) row and passes twice over the keys of its
// window, on the CUDA cores.
// Tensor-core body: every product is mma.sync.m16n8k16 (bf16 in, f32
// accumulate).  A persistent block of WG = 4 warpgroups stages the bf16
// weights and the float32 bias (times log2 e, XOR-swizzled so that a warp's
// float2 reads fall on distinct banks) once; each warpgroup takes one window
// at a time, each warp 16 query rows whose chain qkv -> q_n -> S -> P -> O ->
// projection stays in registers, x's A fragments read straight from device
// memory and the output written from the registers.  Only each head's k_n
// and v go through shared memory, double-buffered by head, so one warpgroup
// barrier per head suffices.  Keeping x out of shared memory is what makes
// room for four windows in flight per SM at 6 heads (two with x staged).

#include "window_attention_mma.cuh"

namespace {

using namespace tmar;

template <int N, int D, int NH, int HD>
struct Geo {
  static constexpr int A = NH * HD;
  static constexpr int A3 = 3 * A;
  static constexpr int WPB = ROWS / N;  // windows per tile
  static constexpr int LX = D + 1;
  static constexpr int LQ = A3 + 1;
  static constexpr int LO = A + 1;
  static constexpr int LWQ = A3 + 1;    // wqkv  [D][LWQ]
  static constexpr int LWP = D + 1;     // wproj [A][LWP]
  static constexpr int X = 0;
  static constexpr int QKV = X + ROWS * LX;
  static constexpr int O = QKV + ROWS * LQ;
  static constexpr int WQKV = O + ROWS * LO;
  static constexpr int WPROJ = WQKV + D * LWQ;
  static constexpr int BQKV = WPROJ + A * LWP;
  static constexpr int BPROJ = BQKV + A3;
  static constexpr int SCALE = BPROJ + D;
  static constexpr int FLOATS = SCALE + 8;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
  static_assert(BYTES <= MAX_SMEM, "tile does not fit in shared memory");
};

template <int N, int D, int NH, int HD, typename T>
__global__ void __launch_bounds__(THREADS, 1) window_attention_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ wqkv, int wq_k, int wq_n,
    const float* __restrict__ bqkv, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ wproj, int wp_k, int wp_n,
    const float* __restrict__ bproj, const float* __restrict__ mrow,
    const float* __restrict__ mcol, T* __restrict__ out, float* __restrict__ lse,
    int nwin, int wh, int ww) {
  using G = Geo<N, D, NH, HD>;
  constexpr int A = G::A, A3 = G::A3, LX = G::LX, LQ = G::LQ, LO = G::LO;
  extern __shared__ float smem[];
  float* sX = smem + G::X;
  float* sQKV = smem + G::QKV;
  float* sO = smem + G::O;
  float* s_wqkv = smem + G::WQKV;
  float* s_wproj = smem + G::WPROJ;
  float* s_bqkv = smem + G::BQKV;
  float* s_bproj = smem + G::BPROJ;
  float* s_scale = smem + G::SCALE;

  // the matrices in the I/O type's values (bf16: as the JAX kernel packs them)
  const int tid = threadIdx.x;
  for (int e = tid; e < D * A3; e += THREADS) {
    const int k = e / A3, n = e % A3;
    s_wqkv[k * G::LWQ + n] = round_as<T>(wqkv[(size_t)k * wq_k + (size_t)n * wq_n]);
  }
  for (int e = tid; e < A * D; e += THREADS) {
    const int k = e / D, n = e % D;
    s_wproj[k * G::LWP + n] = round_as<T>(wproj[(size_t)k * wp_k + (size_t)n * wp_n]);
  }
  for (int e = tid; e < A3; e += THREADS) s_bqkv[e] = bqkv[e];
  for (int e = tid; e < D; e += THREADS) s_bproj[e] = bproj[e];
  if (tid < NH) s_scale[tid] = scale[tid];
  __syncthreads();

  const long total = (long)nwin * N;  // token rows
  const int tiles = (int)((total + ROWS - 1) / ROWS);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long row0 = (long)tile * ROWS;

    // 1. the tile's rows, zero past the end
    for (int e = tid; e < ROWS * D; e += THREADS) {
      const int r = e / D, d = e % D;
      sX[r * LX + d] = row0 + r < total ? to_f(x[(row0 + r) * D + d]) : 0.f;
    }
    __syncthreads();

    // 2. qkv = x @ wqkv + bqkv
    {
      float acc[ceil16(ROWS)][ceil16(A3)];
      mm_zero<ROWS, A3>(acc);
      mm_acc<ROWS, D, A3>(acc, sX, LX, 1, s_wqkv, G::LWQ, 1);
      mm_each<ROWS, A3>(acc, [&](int m, int n, float v) { sQKV[m * LQ + n] = v + s_bqkv[n]; });
    }
    __syncthreads();

    // 3. per-head L2 normalisation of q (heads 0..NH-1) and k (NH..2NH-1)
    for (int e = tid; e < ROWS * 2 * NH; e += THREADS) {
      float* t = sQKV + (e / (2 * NH)) * LQ + (e % (2 * NH)) * HD;
      float ss = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) ss = fmaf(t[d], t[d], ss);
      const float inv = 1.f / (sqrtf(ss) + 1e-12f);
#pragma unroll
      for (int d = 0; d < HD; ++d) t[d] *= inv;
    }
    __syncthreads();

    // 4. attention, one (head, query) row per thread
    for (int e = tid; e < NH * ROWS; e += THREADS) {
      const int h = e / ROWS, r = e % ROWS;
      const int w = r / N, i = r % N;
      const int win = tile * G::WPB + w;
      float o[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) o[d] = 0.f;
      if (win < nwin) {
        const bool gr = wh > 0 && (win / ww) % wh == wh - 1;
        const bool gc = wh > 0 && win % ww == ww - 1;
        float q[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) q[d] = sQKV[r * LQ + h * HD + d];
        const float sc = s_scale[h];
        const float* kb = sQKV + (w * N) * LQ + A + h * HD;
        const float* bi = bias + ((size_t)h * N + i) * N;
        const float* mr = mrow + (size_t)i * N;
        const float* mc = mcol + (size_t)i * N;
        float m = -INFINITY;
        for (int j = 0; j < N; ++j) {
          const float* kj = kb + j * LQ;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) dot = fmaf(q[d], kj[d], dot);
          float s = dot * sc + bi[j];
          if (gr) s += mr[j];
          if (gc) s += mc[j];
          m = fmaxf(m, s);
        }
        float z = 0.f;
        for (int j = 0; j < N; ++j) {
          const float* kj = kb + j * LQ;
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) dot = fmaf(q[d], kj[d], dot);
          float s = dot * sc + bi[j];
          if (gr) s += mr[j];
          if (gc) s += mc[j];
          const float p = expf(s - m);
          z += p;
          const float* vj = kj + A;
#pragma unroll
          for (int d = 0; d < HD; ++d) o[d] = fmaf(p, vj[d], o[d]);
        }
        const float iz = 1.f / z;
#pragma unroll
        for (int d = 0; d < HD; ++d) o[d] *= iz;
        lse[((size_t)win * NH + h) * N + i] = m + logf(z);
      }
#pragma unroll
      for (int d = 0; d < HD; ++d) sO[r * LO + h * HD + d] = round_as<T>(o[d]);
    }
    __syncthreads();

    // 5. out = o @ wproj + bproj
    {
      float acc[ceil16(ROWS)][ceil16(D)];
      mm_zero<ROWS, D>(acc);
      mm_acc<ROWS, A, D>(acc, sO, LO, 1, s_wproj, G::LWP, 1);
      mm_each<ROWS, D>(acc, [&](int m, int n, float v) {
        if (row0 + m < total) store(out + (row0 + m) * D + n, v + s_bproj[n]);
      });
    }
    __syncthreads();
  }
}

template <int N, int D, int NH, int HD, typename T>
int launch(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* out,
           void* lse, int nwin, int wh, int ww, int blocks, cudaStream_t stream) {
  using G = Geo<N, D, NH, HD>;
  auto kern = window_attention_fwd_kernel<N, D, NH, HD, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::BYTES);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, THREADS, G::BYTES, stream>>>(
      (const T*)p[0], (const float*)p[1], wq_k, wq_n, (const float*)p[2],
      (const float*)p[3], (const float*)p[4], (const float*)p[5], wp_k, wp_n,
      (const float*)p[6], (const float*)p[7], (const float*)p[8], (T*)out,
      (float*)lse, nwin, wh, ww);
  return (int)cudaGetLastError();
}

// ---- the bfloat16 tensor-core body, N = 64 ---------------------------------

template <int NH>
struct FwdMma {
  static constexpr int WG = 4;  // windows in flight per block
  static constexpr int AP = NH * HP;
  static constexpr int QKV = 3 * AP;
  // float32: bqkv [QKV], bproj [D], scale·log2e [8], bias·log2e [NH][64][64]
  static constexpr int BQKV = 0;
  static constexpr int BPROJ = BQKV + QKV;
  static constexpr int SCALE = BPROJ + WD;
  static constexpr int BIAS = SCALE + 8;
  static constexpr int FLOATS = BIAS + NH * WN * WN;
  // bf16: wqkv [QKV][LDX], wproj [AP][LDX]; per warpgroup two head slots,
  // each k_n and v [64][LDK]
  static constexpr int WQKV = 0;
  static constexpr int WPROJ = WQKV + QKV * LDX;
  static constexpr int WELEMS = WPROJ + AP * LDX;
  static constexpr int KV = 2 * WN * LDK;
  static constexpr int WGELEMS = 2 * KV;
  static constexpr size_t BYTES =
      FLOATS * sizeof(float) + (size_t)(WELEMS + WG * WGELEMS) * sizeof(__nv_bfloat16);
  static_assert(FLOATS % 4 == 0 && WELEMS % 8 == 0 && WGELEMS % 8 == 0, "16-byte regions");
  static_assert(BYTES <= MAX_SMEM, "does not fit in shared memory");
  static_assert(NH % 2 == 0, "head slots alternate: an even head count needs no barrier per window");
};

// bias element (h, r, c) of the staged [NH][64][64] bias: column XOR-swizzled
// by the row so that the float2 reads of a warp's eight rows spread over the
// banks
__device__ __forceinline__ int bias_at(int h, int r, int c) {
  return (h * WN + r) * WN + (c ^ ((r & 3) << 3));
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

template <int NH, int HD>
__global__ void __launch_bounds__(128 * FwdMma<NH>::WG, 1) window_attention_fwd_mma(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ wqkv, int wq_k, int wq_n,
    const float* __restrict__ bqkv, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ wproj, int wp_k, int wp_n,
    const float* __restrict__ bproj, const float* __restrict__ mrow,
    const float* __restrict__ mcol, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    int nwin, int wh, int ww) {
  using L = FwdMma<NH>;
  constexpr int WG = L::WG, THR = 128 * WG;
  extern __shared__ float4 smem4[];
  float* sf = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(sf + L::FLOATS);
  const int tid = threadIdx.x;

  // ---- once per block: weights in bf16, the rest float32 -------------------
  stage_attention_weights<NH, HD>(sw + L::WQKV, sw + L::WPROJ, sf + L::BQKV, wqkv, wq_k, wq_n,
                                  wproj, wp_k, wp_n, bqkv, tid, THR);
  for (int e = tid; e < WD; e += THR) sf[L::BPROJ + e] = bproj[e];
  if (tid < NH) sf[L::SCALE + tid] = scale[tid] * LOG2E;
  for (int e = tid; e < NH * WN * WN; e += THR)
    sf[L::BIAS + bias_at(e / (WN * WN), (e / WN) % WN, e % WN)] = bias[e] * LOG2E;
  __syncthreads();

  const __nv_bfloat16* s_wqkv = sw + L::WQKV;
  const __nv_bfloat16* s_wproj = sw + L::WPROJ;
  const int wg = tid >> 7, wtid = tid & 127, warp = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // this thread's rows in the window
  __nv_bfloat16* base = sw + L::WELEMS + wg * L::WGELEMS;

  for (int win = blockIdx.x * WG + wg; win < nwin; win += gridDim.x * WG) {
    // the warp's A fragments of x, straight from device memory
    const __nv_bfloat16* xw = x + (size_t)win * WN * WD;
    uint32_t xa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = 16 * kk + 2 * t;
      xa[kk][0] = ldg32(xw + r0 * WD + c), xa[kk][1] = ldg32(xw + r1 * WD + c);
      xa[kk][2] = ldg32(xw + r0 * WD + c + 8), xa[kk][3] = ldg32(xw + r1 * WD + c + 8);
    }
    bool gr, gc;
    mask_gates(win, wh, ww, gr, gc);

    float pj[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) pj[j][0] = pj[j][1] = pj[j][2] = pj[j][3] = 0.f;
#pragma unroll 1
    for (int h = 0; h < NH; ++h) {
      __nv_bfloat16* s_k = base + (h & 1) * L::KV;  // k_n [64][LDK]
      __nv_bfloat16* s_v = s_k + WN * LDK;          // v [64][LDK]
      uint32_t qa[4];
      {
        float acc[6][4], iq[2], ik[2];
        head_qkv<NH>(acc, xa, s_wqkv, sf + L::BQKV, h, lane);
        normalize_rows(acc[0], acc[1], iq);
        normalize_rows(acc[2], acc[3], ik);
        to_a(qa, acc[0], acc[1]);
        store_rows(s_k, acc[2], acc[3], r0, t);
        store_rows(s_v, acc[4], acc[5], r0, t);
      }
      // head h's k_n and v are in; head h - 2's (the same slot, the last
      // window's for h < 2) are read
      warpgroup_sync(wg);

      float s[8][4];
      cosines(s, qa, s_k, lane);
      const float* sb = sf + L::BIAS;
      to_logits2(s, sf[L::SCALE + h],
                 [&](int r, int c) {
                   return *reinterpret_cast<const float2*>(sb + bias_at(h, r, c));
                 },
                 mrow, mcol, gr, gc, r0, lane);
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
      m0 = quad_max(m0);
      m1 = quad_max(m1);
      float z0 = 0.f, z1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = exp2_approx(s[j][0] - m0), s[j][1] = exp2_approx(s[j][1] - m0);
        s[j][2] = exp2_approx(s[j][2] - m1), s[j][3] = exp2_approx(s[j][3] - m1);
        z0 += s[j][0] + s[j][1];
        z1 += s[j][2] + s[j][3];
      }
      z0 = quad_sum(z0);
      z1 = quad_sum(z1);
      if (t == 0) {  // natural-log lse, as the float32 body writes it
        float* l = lse + ((size_t)win * NH + h) * WN;
        l[r0] = (m0 + log2f(z0)) * LN2;
        l[r1] = (m1 + log2f(z1)) * LN2;
      }
      const float iz0 = 1.f / z0, iz1 = 1.f / z1;
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] *= iz0, s[j][1] *= iz0, s[j][2] *= iz1, s[j][3] *= iz1;

      // O = bf16(P) · v, then bf16(O)'s share of the projection
      float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
        to_a(pa, s[2 * kk], s[2 * kk + 1]);
        mma_pair_t(o[0], o[1], pa, s_v, LDK, 0, 16 * kk, lane);
      }
      uint32_t oa[4];
      to_a(oa, o[0], o[1]);
#pragma unroll
      for (int j = 0; j < 8; j += 2) mma_pair_t(pj[j], pj[j + 1], oa, s_wproj, LDX, 8 * j, h * HP, lane);
    }

    // out = projection + bproj, bf16, from the registers
    __nv_bfloat16* ow = out + (size_t)win * WN * WD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float b0 = sf[L::BPROJ + c], b1 = sf[L::BPROJ + c + 1];
      sts32(ow + r0 * WD + c, pack_bf16(pj[j][0] + b0, pj[j][1] + b1));
      sts32(ow + r1 * WD + c, pack_bf16(pj[j][2] + b0, pj[j][3] + b1));
    }
  }
}

template <int NH, int HD>
int launch_mma(const void* const* p, int wq_k, int wq_n, int wp_k, int wp_n, void* out,
               void* lse, int nwin, int wh, int ww, int blocks, cudaStream_t stream) {
  if (((uintptr_t)p[0] | (uintptr_t)out) & 3) return (int)cudaErrorMisalignedAddress;
  using L = FwdMma<NH>;
  auto kern = window_attention_fwd_mma<NH, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int grid = (nwin + L::WG - 1) / L::WG < blocks ? (nwin + L::WG - 1) / L::WG : blocks;
  kern<<<grid, 128 * L::WG, L::BYTES, stream>>>(
      (const __nv_bfloat16*)p[0], (const float*)p[1], wq_k, wq_n, (const float*)p[2],
      (const float*)p[3], (const float*)p[4], (const float*)p[5], wp_k, wp_n,
      (const float*)p[6], (const float*)p[7], (const float*)p[8], (__nv_bfloat16*)out,
      (float*)lse, nwin, wh, ww);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int N, int nh, int hd, const void* const* p, int wq_k, int wq_n, int wp_k,
             int wp_n, void* out, void* lse, int nwin, int wh, int ww, int blocks,
             cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    if (N == 64 && nh == 6 && hd == 10)
      return launch_mma<6, 10>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, blocks, s);
    if (N == 64 && nh == 4 && hd == 16)
      return launch_mma<4, 16>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, blocks, s);
  } else {
    if (N == 64 && nh == 6 && hd == 10)
      return launch<64, 64, 6, 10, T>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, blocks, s);
    if (N == 64 && nh == 4 && hd == 16)
      return launch<64, 64, 4, 16, T>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, blocks, s);
  }
  if (N == 4 && nh == 6 && hd == 5)
    return launch<4, 32, 6, 5, T>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, blocks, s);
  if (N == 4 && nh == 4 && hd == 8)
    return launch<4, 32, 4, 8, T>(p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin, wh, ww, blocks, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x [nwin, N, D] (float32 or bfloat16, per is_bf16) -> out of the same shape
// and type, and lse [nwin, nh, N] float32.  (N, D, nh, hd) is one of
// (64, 64, 6, 10), (64, 64, 4, 16), (4, 32, 6, 5), (4, 32, 4, 8).  All
// parameters are float32 (the bfloat16 bodies round the two matrices):
// wqkv [D, 3A] and wproj [A, D] are read as w[k·w_k + n·w_n]; bqkv [3A];
// scale [nh] = exp(min(logit_scale, ln 100)); bias [nh, N, N]; bproj [D];
// mrow, mcol [N, N] are read only when wh > 0.  `blocks` is the most
// persistent blocks to launch (one per SM).  Returns a cudaError_t code.
int tmar_window_attention_fwd(const void* x, const void* wqkv, const void* bqkv,
                              const void* scale, const void* bias, const void* wproj,
                              const void* bproj, const void* mrow, const void* mcol,
                              void* out, void* lse, int nwin, int N, int num_heads,
                              int head_dim, int wq_k, int wq_n, int wp_k, int wp_n,
                              int wh, int ww, int blocks, int is_bf16, void* stream) {
  if (nwin < 1 || blocks < 1 || (wh > 0 && (ww < 1 || nwin % (wh * ww))))
    return (int)cudaErrorInvalidValue;
  const void* p[9] = {x, wqkv, bqkv, scale, bias, wproj, bproj, mrow, mcol};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(N, num_heads, head_dim, p, wq_k, wq_n, wp_k, wp_n, out,
                                   lse, nwin, wh, ww, blocks, s);
  return dispatch<float>(N, num_heads, head_dim, p, wq_k, wq_n, wp_k, wp_n, out, lse, nwin,
                         wh, ww, blocks, s);
}

const char* tmar_window_attention_fwd_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
