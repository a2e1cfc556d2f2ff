// K2: a whole NSTB (N-gram Swin Transformer Block) on the feature map, in one
// launch.
//
// Replaces the TPU kernel tmar/ops/pallas_nstb.py:_nstb_map_kernel (driven by
// _forward_map, pallas_call at :592; its attention core is
// tmar/ops/pallas_attention.py:batched_attention_core).  Plain version:
// tmar_torch/ops/cuda_nstb.py:nstb_map_math.
//
// Input is the UNROLLED, context-free map x [B, ph, pw, D] and the n-gram
// context per window ctx_quads [B·wh·ww, Q, D], windows in row-major order.
// Window (b, wi, wj) reads the tokens at the cyclic offset (+shift, +shift) of
// the map, with a modulo in place of a halo operand, and its block output z is
// written to the window's position in the ROLLED map; the caller applies the
// reverse cyclic shift.  Any windows-per-stripe is taken, odd ones too (the
// TPU kernel pads them, pallas_nstb.py:514-526): a block walks windows, not
// stripes.  The per-window bodies, what bounds them and their designs are in
// nstb_window.cuh (float32) and nstb_window_mma.cuh (bfloat16, tensor cores)
// at the full-width NGswin's geometry, nstb_generic_mma.cuh (bfloat16,
// tensor cores) and nstb_generic.cuh (CUDA cores) at every other width, and
// nstb_long.cuh (CUDA cores, on a workspace in device memory) past 64 tokens
// a window or 32 channels a head; all are shared with K8 (nstb_tokens.cu),
// and nstb_generic_mma.cuh's `body` picks one by geometry and I/O type.

#include "nstb_generic.cuh"
#include "nstb_generic_mma.cuh"
#include "nstb_long.cuh"
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

// The same addressing at a window side ws given at run time, for the generic
// body.
struct RolledMapRt {
  int count, wh, ww, ws;
  int ph, pw, shift;
  __device__ __forceinline__ size_t src(int win, int n) const {
    const int b = win / (wh * ww), wi = (win / ww) % wh, wj = win % ww;
    int gy = wi * ws + n / ws + shift;
    if (gy >= ph) gy -= ph;
    int gx = wj * ws + n % ws + shift;
    if (gx >= pw) gx -= pw;
    return ((size_t)b * ph + gy) * pw + gx;
  }
  __device__ __forceinline__ size_t dst(int win, int n) const {
    const int b = win / (wh * ww), wi = (win / ww) % wh, wj = win % ww;
    return ((size_t)b * ph + wi * ws + n / ws) * pw + wj * ws + n % ws;
  }
};

}  // namespace

extern "C" {

// x [B, ph, pw, D] and ctx_quads [B·wh·ww, Q, D] (float32 or bfloat16, per
// is_bf16) -> out [B, ph, pw, D] of the same type, in rolled space.  The
// matrices wqkv [D, 3A], wproj [A, D], w1 [D, H] and w2 [H, D] share the I/O
// type and the [in, out] layout; bqkv [3A], scale [nh] = exp(min(logit_scale,
// ln 100)), table [(2ws-1)², nh], bproj, LN gains/biases and FFN biases are
// float32.  Requires ph, pw multiples of the window side ws, ws² <= 64,
// Q in {1, 4} and 0 <= shift < ws.  nstb_mma::body picks the body: windows
// past 64 tokens and head_dim past 32 the long-window body (nstb_long.cuh,
// on `workspace`, which holds the floats tmar_nstb_map_workspace gives; null
// for the other bodies); the full-width NGswin's geometry (ws 8, D 64, H 128,
// heads 6 x 10 or 4 x 16) its own bodies, bfloat16 at every other width the
// tensor-core generic body where it has a plan (each on as many persistent
// blocks as the card holds), the rest the CUDA-core generic body on `blocks`
// persistent blocks.  Returns a cudaError_t code (0 on a clean launch).
int tmar_nstb_map(const void* x, const void* cq, const void* wqkv,
                  const void* bqkv, const void* scale, const void* table,
                  const void* wproj, const void* bproj, const void* g1,
                  const void* b1, const void* w1, const void* bw1,
                  const void* w2, const void* bw2, const void* g2,
                  const void* b2, void* out, void* workspace, int B, int ph, int pw, int D, int H, int ws,
                  int Q, int shift, int num_heads, int head_dim, int is_bf16, int blocks,
                  float eps, void* stream) {
  if (B < 1 || ws < 1 || ph < ws || pw < ws || ph % ws || pw % ws || (Q != 1 && Q != 4) ||
      shift < 0 || shift >= ws || num_heads < 1)
    return (int)cudaErrorInvalidValue;
  const void* p[16] = {x,  cq, wqkv, bqkv, scale, table, wproj, bproj,
                       g1, b1, w1,   bw1,  w2,    bw2,   g2,    b2};
  const int wh = ph / ws, ww = pw / ws;
  cudaStream_t s = (cudaStream_t)stream;
  const nstb_mma::Body body = nstb_mma::body(ws, D, num_heads, head_dim, H, is_bf16);
  if (body == nstb_mma::FLAGSHIP) {
    const RolledMap wins{B * wh * ww, wh, ww, ph, pw, shift};
    return dispatch_nstb(num_heads, head_dim, is_bf16, p, out, wins, Q, shift, eps, s);
  }
  const RolledMapRt wins{B * wh * ww, wh, ww, ws, ph, pw, shift};
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

// The tensor-core generic body alone, at any geometry it has a plan for (the
// full-width NGswin's too), bfloat16 only; arguments as tmar_nstb_map's
// (`blocks` unread).  Not a dispatch: it times that body where the rule
// sends another.
int tmar_nstb_map_mma(const void* x, const void* cq, const void* wqkv,
                      const void* bqkv, const void* scale, const void* table,
                      const void* wproj, const void* bproj, const void* g1,
                      const void* b1, const void* w1, const void* bw1,
                      const void* w2, const void* bw2, const void* g2,
                      const void* b2, void* out, void* workspace, int B, int ph, int pw, int D, int H, int ws,
                      int Q, int shift, int num_heads, int head_dim, int is_bf16, int blocks,
                      float eps, void* stream) {
  (void)blocks, (void)workspace;
  if (!is_bf16 || B < 1 || ws < 1 || ph < ws || pw < ws || ph % ws || pw % ws ||
      (Q != 1 && Q != 4) || shift < 0 || shift >= ws)
    return (int)cudaErrorInvalidValue;
  const void* p[16] = {x,  cq, wqkv, bqkv, scale, table, wproj, bproj,
                       g1, b1, w1,   bw1,  w2,    bw2,   g2,    b2};
  const int wh = ph / ws, ww = pw / ws;
  const RolledMapRt wins{B * wh * ww, wh, ww, ws, ph, pw, shift};
  return nstb_mma::launch(p, out, wins, D, H, num_heads, head_dim, Q, shift, eps,
                          (cudaStream_t)stream);
}

// The body (nstb_mma::Body) that runs windows of N = ws² tokens at (D, heads,
// head_dim, H) and this I/O type.
int tmar_nstb_map_body(int N, int D, int num_heads, int head_dim, int H, int is_bf16) {
  return (int)nstb_mma::body(nstb_mma::side(N), D, num_heads, head_dim, H, is_bf16);
}

// The shared memory, in bytes, that generic body `body` (TENSOR_CORE or
// CUDA_CORE) launches with at (N, D, heads, head_dim, H), or for LONG the
// largest block of the long-window body's launches; -1 where the tensor-core
// body has no plan or a long-window launch fits no block.
long long tmar_nstb_map_smem(int N, int D, int num_heads, int head_dim, int H, int body) {
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
long long tmar_nstb_map_workspace(int nwin, int N, int D, int num_heads, int head_dim, int H,
                                     int is_bf16) {
  if (nwin < 1 || N < 1) return -1;
  const nstb_mma::Body b = nstb_mma::body(nstb_mma::side(N), D, num_heads, head_dim, H, is_bf16);
  if (b == nstb_mma::LONG_TC) return long_mma::fwd_workspace(nwin, N, num_heads, head_dim);
  return b == nstb_mma::LONG ? nstb_long::workspace(nwin, N, num_heads, head_dim) : 0;
}

const char* tmar_nstb_map_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
