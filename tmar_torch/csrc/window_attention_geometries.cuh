// The (N, D, num_heads, head_dim) geometries that K3 (window_attention_fwd.cu)
// and K4 (window_attention_bwd.cu) are compiled for, in one list that the
// forward and backward dispatches and the backward's workspace query all
// expand.  tmar_torch/ops/cuda_attention.py: KERNEL_GEOMETRIES is the same
// set (a test reads this file and checks it).
//
// Each X(N, D, NH, HD) is one geometry:
// * TMAR_ATTN_WINDOW_GEOMETRIES: the full-width NGswin's 8x8 windows at
//   D = 64.  bfloat16 runs the tensor-core body there, float32 the SIMT body.
// * TMAR_ATTN_NGRAM_GEOMETRIES: its n x n n-gram windows (n = 1, 2, 3) on
//   the D/2 = 32-channel unigram grid, at both heads splits.  Both dtypes
//   run the SIMT body.
#pragma once

#define TMAR_ATTN_WINDOW_GEOMETRIES(X) \
  X(64, 64, 6, 10)                     \
  X(64, 64, 4, 16)

#define TMAR_ATTN_NGRAM_GEOMETRIES(X) \
  X(1, 32, 6, 5)                      \
  X(1, 32, 4, 8)                      \
  X(4, 32, 6, 5)                      \
  X(4, 32, 4, 8)                      \
  X(9, 32, 6, 5)                      \
  X(9, 32, 4, 8)
