// K8: a whole NSTB (N-gram Swin Transformer Block) on windows that are
// already partitioned, in one launch.
//
// Replaces the TPU kernel tmar/ops/pallas_nstb.py:_nstb_kernel (driven by
// _forward, pallas_call at :222; entered through fused_nstb, the JAX
// package's TMAR_NSTB_MAP=0 form).  Plain version:
// tmar_torch/ops/cuda_nstb.py:nstb_tokens_math (over nstb_math).
//
// Input is x [B_, 64, 64], the context-free windows of the ROLLED map (window
// b's 64 tokens contiguous), and ctx_quads [B_, Q, 64]; the output z
// [B_, 64, 64] is in the same rolled window space.  Window b's place in its
// image is w = b mod (wh·ww), which gates the shift mask as
// batched_window_gates(..., wrap=True) does (pallas_attention.py:887-897).
// The TPU kernel pads B_ to a multiple of its grid step with zero windows;
// here a persistent block walks the windows and needs the modulo alone.  The
// per-window bodies, what bounds them and their designs are in
// nstb_window.cuh (float32) and nstb_window_mma.cuh (bfloat16, tensor cores),
// shared with K2 (nstb_map.cu): the two differ only in token addressing.

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

}  // namespace

extern "C" {

// x [nwin, 64, 64] and ctx_quads [nwin, Q, 64] (float32 or bfloat16, per
// is_bf16) -> out [nwin, 64, 64] of the same type.  Weights as
// tmar_nstb_map takes them.  (wh, ww) is the window grid of one image: with
// shift > 0 it gates the mask and nwin must be a multiple of wh·ww; with
// shift 0 it is not read.  Requires Q in {1, 4} (Q = 4 at shift 0 reads slot
// 0 only) and 0 <= shift < 8.  Returns a cudaError_t code (0 on a clean
// launch).
int tmar_nstb_tokens(const void* x, const void* cq, const void* wqkv,
                     const void* bqkv, const void* scale, const void* table,
                     const void* wproj, const void* bproj, const void* g1,
                     const void* b1, const void* w1, const void* bw1,
                     const void* w2, const void* bw2, const void* g2,
                     const void* b2, void* out, int nwin, int wh, int ww, int Q,
                     int shift, int num_heads, int head_dim, int is_bf16,
                     float eps, void* stream) {
  if (nwin < 1 || (Q != 1 && Q != 4) || shift < 0 || shift >= WS)
    return (int)cudaErrorInvalidValue;
  if (shift > 0 && (wh < 1 || ww < 1 || nwin % (wh * ww)))
    return (int)cudaErrorInvalidValue;
  const void* p[16] = {x,  cq, wqkv, bqkv, scale, table, wproj, bproj,
                       g1, b1, w1,   bw1,  w2,    bw2,   g2,    b2};
  const Tokens wins{nwin, wh, ww};
  return dispatch_nstb(num_heads, head_dim, is_bf16, p, out, wins, Q, shift, eps,
                       (cudaStream_t)stream);
}

const char* tmar_nstb_tokens_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
