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
// at the full-width NGswin's geometry, nstb_generic_mma.cuh (bfloat16,
// tensor cores) and nstb_generic.cuh (CUDA cores) at every other width,
// and nstb_long.cuh past 64 tokens a window or 32 channels a head, all
// shared with K2 (nstb_map.cu): the two differ only in token addressing, and
// nstb_generic_mma.cuh's `body` picks the body for both.

#include "nstb_generic.cuh"
#include "nstb_generic_mma.cuh"
#include "nstb_long.cuh"
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
// multiple of wh·ww; with shift 0 it is not read.  Requires Q in {1, 4} (Q
// = 4 at shift 0 reads slot 0 only) and 0 <= shift < ws.  nstb_mma::body
// picks the body, as tmar_nstb_map's; `workspace` as tmar_nstb_map takes it
// (tmar_nstb_tokens_workspace floats).  Returns a
// cudaError_t code (0 on a clean launch).
int tmar_nstb_tokens(const void* x, const void* cq, const void* wqkv,
                     const void* bqkv, const void* scale, const void* table,
                     const void* wproj, const void* bproj, const void* g1,
                     const void* b1, const void* w1, const void* bw1,
                     const void* w2, const void* bw2, const void* g2,
                     const void* b2, void* out, void* workspace, int nwin, int wh, int ww, int D, int H,
                     int ws, int Q, int shift, int num_heads, int head_dim, int is_bf16,
                     int blocks, float eps, void* stream) {
  if (nwin < 1 || ws < 1 || (Q != 1 && Q != 4) || shift < 0 || shift >= ws || num_heads < 1)
    return (int)cudaErrorInvalidValue;
  if (shift > 0 && (wh < 1 || ww < 1 || nwin % (wh * ww)))
    return (int)cudaErrorInvalidValue;
  const void* p[16] = {x,  cq, wqkv, bqkv, scale, table, wproj, bproj,
                       g1, b1, w1,   bw1,  w2,    bw2,   g2,    b2};
  cudaStream_t s = (cudaStream_t)stream;
  const nstb_mma::Body body = nstb_mma::body(ws, D, num_heads, head_dim, H, is_bf16);
  if (body == nstb_mma::FLAGSHIP) {
    const Tokens wins{nwin, wh, ww};
    return dispatch_nstb(num_heads, head_dim, is_bf16, p, out, wins, Q, shift, eps, s);
  }
  const TokensRt wins{nwin, wh, ww, ws};
  if (body == nstb_mma::LONG_TC)
    return nstb_long::launch_tc(p, out, workspace, wins, D, H, num_heads, head_dim, Q, shift, eps,
                                s);
  if (body == nstb_mma::LONG)
    return nstb_long::launch(p, out, workspace, wins, D, H, num_heads, head_dim, Q, shift, eps,
                             is_bf16, s);
  if (body == nstb_mma::TENSOR_CORE)
    return nstb_mma::launch(p, out, wins, D, H, num_heads, head_dim, Q, shift, eps, s);
  return nstb_rt::launch(p, out, wins, D, H, num_heads, head_dim, Q, shift, eps, is_bf16,
                         blocks, s);
}

// The body (nstb_mma::Body) that runs windows of N = ws² tokens at (D, heads,
// head_dim, H) and this I/O type.
int tmar_nstb_tokens_body(int N, int D, int num_heads, int head_dim, int H, int is_bf16) {
  return (int)nstb_mma::body(nstb_mma::side(N), D, num_heads, head_dim, H, is_bf16);
}

// The shared memory, in bytes, that generic body `body` (TENSOR_CORE or
// CUDA_CORE) launches with at (N, D, heads, head_dim, H), or for LONG the
// largest block of the long-window body's launches; -1 where the tensor-core
// body has no plan or a long-window launch fits no block.
long long tmar_nstb_tokens_smem(int N, int D, int num_heads, int head_dim, int H, int body) {
  if (body == nstb_mma::LONG_TC) {
    const int ws = nstb_mma::side(N);
    const size_t b = ws * ws == N ? long_mma::nstb_plan_bytes(ws, D, num_heads, head_dim, H) : 0;
    return b ? (long long)b : -1;
  }
  if (body == nstb_mma::LONG)
    return nstb_long::fits(N, D, num_heads, head_dim, H)
               ? (long long)nstb_long::plan_bytes(N, D, num_heads, head_dim, H)
               : -1;
  return nstb_mma::generic_smem(N, D, num_heads, head_dim, H, body);
}

// The float32 workspace, in floats, of the body that runs nwin windows of
// N = ws² tokens at (D, heads, head_dim, H): the long-window body's qkv and
// head outputs, 0 for the others.
long long tmar_nstb_tokens_workspace(int nwin, int N, int D, int num_heads, int head_dim, int H,
                                     int is_bf16) {
  if (nwin < 1 || N < 1) return -1;
  const nstb_mma::Body b = nstb_mma::body(nstb_mma::side(N), D, num_heads, head_dim, H, is_bf16);
  if (b == nstb_mma::LONG_TC) return long_mma::fwd_workspace(nwin, N, num_heads, head_dim);
  return b == nstb_mma::LONG ? nstb_long::workspace(nwin, N, num_heads, head_dim) : 0;
}

const char* tmar_nstb_tokens_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
