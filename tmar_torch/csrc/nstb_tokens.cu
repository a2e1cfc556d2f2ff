// K8: a whole NSTB (N-gram Swin Transformer Block) on windows that are
// already partitioned, in one launch.
//
// Replaces the TPU kernel tmar/ops/pallas_nstb.py:_nstb_kernel (driven by
// _forward, pallas_call at :222; entered through fused_nstb, the JAX
// package's TMAR_NSTB_MAP=0 form).  Plain version:
// tmar_torch/ops/cuda_nstb.py:nstb_tokens_math (over nstb_math).
//
// Input is x [B_, N, D], the context-free windows of the ROLLED map (window
// b's N tokens contiguous), and ctx_quads [B_, Q, D]; the output z
// [B_, N, D] is in the same rolled window space.  Window b's place in its
// image is w = b mod (wh·ww), which gates the shift mask as
// batched_window_gates(..., wrap=True) does (pallas_attention.py:887-897).
// The TPU kernel pads B_ to a multiple of its grid step with zero windows;
// here a persistent block walks the windows and needs the modulo alone.  The
// per-window bodies, what bounds them and their designs are in
// nstb_window.cuh (float32) and nstb_window_mma.cuh (bfloat16, tensor cores)
// at the full-width NGswin's geometry, and nstb_generic.cuh at every other
// width, shared with K2 (nstb_map.cu): the two differ only in token
// addressing.

#include "nstb_generic.cuh"
#include "nstb_window_mma.cuh"

namespace {

// Window b at rows [64·b, 64·b + 64) of x and of out.
struct Tokens {
  int count, wh, ww;
  struct Win {
    size_t base;
  };
  __device__ __forceinline__ Win at(int win) const { return {(size_t)win * N}; }
  __device__ __forceinline__ size_t src(const Win& w, int n) const { return w.base + n; }
  __device__ __forceinline__ size_t dst(const Win& w, int n) const { return w.base + n; }
};

// Window b at rows [N·b, N·b + N), N = ws², for the generic body.
struct TokensRt {
  int count, wh, ww, ws;
  __device__ __forceinline__ size_t src(int win, int n) const {
    return (size_t)win * ws * ws + n;
  }
  __device__ __forceinline__ size_t dst(int win, int n) const { return src(win, n); }
};

}  // namespace

extern "C" {

// x [nwin, N, D] and ctx_quads [nwin, Q, D] (float32 or bfloat16, per
// is_bf16) -> out [nwin, N, D] of the same type, N = ws².  Weights, the
// bodies and `blocks` as tmar_nstb_map takes them.  (wh, ww) is the window
// grid of one image: with shift > 0 it gates the mask and nwin must be a
// multiple of wh·ww; with shift 0 it is not read.  Requires ws² <= 64, Q in
// {1, 4} (Q = 4 at shift 0 reads slot 0 only), 0 <= shift < ws and head_dim
// <= 32.  Returns a cudaError_t code (0 on a clean launch).
int tmar_nstb_tokens(const void* x, const void* cq, const void* wqkv,
                     const void* bqkv, const void* scale, const void* table,
                     const void* wproj, const void* bproj, const void* g1,
                     const void* b1, const void* w1, const void* bw1,
                     const void* w2, const void* bw2, const void* g2,
                     const void* b2, void* out, int nwin, int wh, int ww, int D, int H,
                     int ws, int Q, int shift, int num_heads, int head_dim, int is_bf16,
                     int blocks, float eps, void* stream) {
  if (nwin < 1 || ws < 1 || (Q != 1 && Q != 4) || shift < 0 || shift >= ws || num_heads < 1)
    return (int)cudaErrorInvalidValue;
  if (shift > 0 && (wh < 1 || ww < 1 || nwin % (wh * ww)))
    return (int)cudaErrorInvalidValue;
  const void* p[16] = {x,  cq, wqkv, bqkv, scale, table, wproj, bproj,
                       g1, b1, w1,   bw1,  w2,    bw2,   g2,    b2};
  cudaStream_t s = (cudaStream_t)stream;
  if (nstb_rt::flagship(ws, D, H, num_heads, head_dim)) {
    const Tokens wins{nwin, wh, ww};
    return dispatch_nstb(num_heads, head_dim, is_bf16, p, out, wins, Q, shift, eps, s);
  }
  const TokensRt wins{nwin, wh, ww, ws};
  return nstb_rt::launch(p, out, wins, D, H, num_heads, head_dim, Q, shift, eps, is_bf16,
                         blocks, s);
}

// The shared memory, in bytes, of the generic body's launch at (N, D, heads,
// head_dim, H).
long long tmar_nstb_tokens_smem(int N, int D, int num_heads, int head_dim, int H) {
  return (long long)nstb_rt::smem_bytes(N, D, num_heads * head_dim, H);
}

const char* tmar_nstb_tokens_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
