// K2: a whole NSTB (N-gram Swin Transformer Block) on the feature map, in one
// launch.
//
// Replaces the TPU kernel tmar/ops/pallas_nstb.py:_nstb_map_kernel (driven by
// _forward_map, pallas_call at :592; its attention core is
// tmar/ops/pallas_attention.py:batched_attention_core).  Plain version:
// tmar_torch/ops/cuda_nstb.py:nstb_map_math.
//
// Input is the UNROLLED, context-free map x [B, ph, pw, 64] and the n-gram
// context per window ctx_quads [B·wh·ww, Q, 64], windows in row-major order.
// Window (b, wi, wj) reads the tokens at the cyclic offset (+shift, +shift) of
// the map, with a modulo in place of a halo operand, and its block output z is
// written to the window's position in the ROLLED map; the caller applies the
// reverse cyclic shift.  The per-window bodies, what bounds them and their
// designs are in nstb_window.cuh (float32) and nstb_window_mma.cuh (bfloat16,
// tensor cores), shared with K8 (nstb_tokens.cu).

#include "nstb_window_mma.cuh"

namespace {

// Windows of the map rolled by (shift, shift), gathered in place.
struct RolledMap {
  int count, wh, ww;
  int ph, pw, shift;
  struct Win {
    int b, wi, wj;
  };
  __device__ __forceinline__ Win at(int win) const {
    return {win / (wh * ww), (win / ww) % wh, win % ww};
  }
  __device__ __forceinline__ size_t src(const Win& w, int n) const {
    int gy = w.wi * WS + n / WS + shift;
    if (gy >= ph) gy -= ph;
    int gx = w.wj * WS + n % WS + shift;
    if (gx >= pw) gx -= pw;
    return ((size_t)w.b * ph + gy) * pw + gx;
  }
  __device__ __forceinline__ size_t dst(const Win& w, int n) const {
    return ((size_t)w.b * ph + w.wi * WS + n / WS) * pw + w.wj * WS + n % WS;
  }
};

}  // namespace

extern "C" {

// x [B, ph, pw, 64] and ctx_quads [B·wh·ww, Q, 64] (float32 or bfloat16, per
// is_bf16) -> out [B, ph, pw, 64] of the same type, in rolled space.  The
// matrices wqkv [64, 3A], wproj [A, 64], w1 [64, 128] and w2 [128, 64] share
// the I/O type and the [in, out] layout; bqkv [3A], scale [nh] =
// exp(min(logit_scale, ln 100)), table [225, nh], bproj, LN gains/biases and
// FFN biases are float32.  Requires ph, pw multiples of 8, Q in {1, 4} and
// 0 <= shift < 8.  Returns a cudaError_t code (0 on a clean launch).
int tmar_nstb_map(const void* x, const void* cq, const void* wqkv,
                  const void* bqkv, const void* scale, const void* table,
                  const void* wproj, const void* bproj, const void* g1,
                  const void* b1, const void* w1, const void* bw1,
                  const void* w2, const void* bw2, const void* g2,
                  const void* b2, void* out, int B, int ph, int pw, int Q,
                  int shift, int num_heads, int head_dim, int is_bf16,
                  float eps, void* stream) {
  if (B < 1 || ph < WS || pw < WS || ph % WS || pw % WS || (Q != 1 && Q != 4) || shift < 0 ||
      shift >= WS)
    return (int)cudaErrorInvalidValue;
  const void* p[16] = {x,  cq, wqkv, bqkv, scale, table, wproj, bproj,
                       g1, b1, w1,   bw1,  w2,    bw2,   g2,    b2};
  const int wh = ph / WS, ww = pw / WS;
  const RolledMap wins{B * wh * ww, wh, ww, ph, pw, shift};
  return dispatch_nstb(num_heads, head_dim, is_bf16, p, out, wins, Q, shift, eps,
                       (cudaStream_t)stream);
}

const char* tmar_nstb_map_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
