// tmar_host — native host-side data-path kernels.
//
// The reference's data path rides on native code it doesn't own: torch's
// C++ DataLoader workers and the external torch-radon CUDA library
// (SURVEY.md §2.11).  This library is the framework-owned equivalent for
// the HOST side of the TPU pipeline: batch assembly (normalize + crop +
// flip fused in one pass), HU windowing, metal-mask extraction with
// dilation, and the SpineWeb pseudo-clean construction (row/column masked
// linear interpolation, reference scripts/prepare_spineweb_data.py:36-131)
// — the per-sample CPU work that must keep 8 TPU chips fed.
//
// Exposed as a plain C ABI consumed via ctypes (tmar/data/native.py).
// Build: make -C native   (produces libtmar_host.so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// clip [0,1] -> [-1,1]
void tmar_normalize01_pm1(const float* src, float* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float v = src[i];
    v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
    dst[i] = v * 2.f - 1.f;
  }
}

// HU window -> [-1,1]
void tmar_hu_window(const float* src, float* dst, int64_t n, float hu_min,
                    float hu_max) {
  const float scale = 2.f / (hu_max - hu_min);
  for (int64_t i = 0; i < n; ++i) {
    float v = src[i];
    v = v < hu_min ? hu_min : (v > hu_max ? hu_max : v);
    dst[i] = (v - hu_min) * scale - 1.f;
  }
}

// Fused batch assembly: for each of B samples (each K planes of HxW laid
// out contiguously per sample), crop to (ph, pw) at (row, col), apply
// optional h/v flips, write NHWC-with-C=1-per-plane output
// [B, K, ph, pw] contiguous.  One pass, no intermediates.
void tmar_assemble_batch(const float* src, float* dst, int64_t B, int64_t K,
                         int64_t H, int64_t W, int64_t ph, int64_t pw,
                         const int32_t* rows, const int32_t* cols,
                         const uint8_t* hflip, const uint8_t* vflip) {
  for (int64_t b = 0; b < B; ++b) {
    const float* sample = src + b * K * H * W;
    const int64_t r0 = rows[b], c0 = cols[b];
    const bool hf = hflip[b] != 0, vf = vflip[b] != 0;
    for (int64_t k = 0; k < K; ++k) {
      const float* plane = sample + k * H * W;
      float* out = dst + (b * K + k) * ph * pw;
      for (int64_t i = 0; i < ph; ++i) {
        const int64_t si = vf ? (r0 + ph - 1 - i) : (r0 + i);
        const float* srow = plane + si * W + c0;
        float* drow = out + i * pw;
        if (!hf) {
          std::memcpy(drow, srow, sizeof(float) * pw);
        } else {
          for (int64_t j = 0; j < pw; ++j) drow[j] = srow[pw - 1 - j];
        }
      }
    }
  }
}

// Metal mask by threshold + square dilation (separable max filter),
// equivalent to max_pool2d(kernel 2r+1, stride 1, pad r)
// (reference losses/gan_losses.py:67-84).
void tmar_metal_mask_dilate(const float* img, float* mask, int64_t H,
                            int64_t W, float threshold, int radius) {
  std::vector<float> tmp(H * W);
  // threshold
  for (int64_t i = 0; i < H * W; ++i) tmp[i] = img[i] > threshold ? 1.f : 0.f;
  if (radius <= 0) {
    std::memcpy(mask, tmp.data(), sizeof(float) * H * W);
    return;
  }
  std::vector<float> rowmax(H * W);
  // horizontal pass
  for (int64_t i = 0; i < H; ++i) {
    const float* in = tmp.data() + i * W;
    float* out = rowmax.data() + i * W;
    for (int64_t j = 0; j < W; ++j) {
      const int64_t j0 = std::max<int64_t>(0, j - radius);
      const int64_t j1 = std::min<int64_t>(W - 1, j + radius);
      float m = 0.f;
      for (int64_t t = j0; t <= j1; ++t) m = std::max(m, in[t]);
      out[j] = m;
    }
  }
  // vertical pass
  for (int64_t j = 0; j < W; ++j) {
    for (int64_t i = 0; i < H; ++i) {
      const int64_t i0 = std::max<int64_t>(0, i - radius);
      const int64_t i1 = std::min<int64_t>(H - 1, i + radius);
      float m = 0.f;
      for (int64_t t = i0; t <= i1; ++t) m = std::max(m, rowmax[t * W + j]);
      mask[i * W + j] = m;
    }
  }
}

// Row-wise masked linear interpolation (pseudo-clean LI construction,
// reference prepare_spineweb_data.py:36-53): masked pixels replaced by
// linear interpolation between the nearest unmasked pixels in the row;
// edges extend the nearest known value.  Returns count of rows that were
// fully masked (untouched).
int64_t tmar_li_rowwise(const float* img, const uint8_t* mask, float* out,
                        int64_t H, int64_t W) {
  int64_t untouched = 0;
  std::memcpy(out, img, sizeof(float) * H * W);
  for (int64_t i = 0; i < H; ++i) {
    const uint8_t* m = mask + i * W;
    float* row = out + i * W;
    // collect known positions
    int64_t nknown = 0;
    for (int64_t j = 0; j < W; ++j) nknown += (m[j] == 0);
    if (nknown == W) continue;
    if (nknown < 2) {
      ++untouched;
      continue;
    }
    int64_t prev = -1;
    for (int64_t j = 0; j <= W; ++j) {
      const bool known = (j < W) && (m[j] == 0);
      if (known) {
        if (prev >= 0 && j - prev > 1) {
          const float a = row[prev], b = row[j];
          for (int64_t t = prev + 1; t < j; ++t) {
            const float f = float(t - prev) / float(j - prev);
            row[t] = a + (b - a) * f;
          }
        } else if (prev < 0) {
          for (int64_t t = 0; t < j; ++t) row[t] = row[j];  // extend left
        }
        prev = j;
      } else if (j == W && prev >= 0) {
        for (int64_t t = prev + 1; t < W; ++t) row[t] = row[prev];  // extend right
      }
    }
  }
  return untouched;
}

// Column-wise variant.
int64_t tmar_li_colwise(const float* img, const uint8_t* mask, float* out,
                        int64_t H, int64_t W) {
  int64_t untouched = 0;
  std::memcpy(out, img, sizeof(float) * H * W);
  for (int64_t j = 0; j < W; ++j) {
    int64_t nknown = 0;
    for (int64_t i = 0; i < H; ++i) nknown += (mask[i * W + j] == 0);
    if (nknown == H) continue;
    if (nknown < 2) {
      ++untouched;
      continue;
    }
    int64_t prev = -1;
    for (int64_t i = 0; i <= H; ++i) {
      const bool known = (i < H) && (mask[i * W + j] == 0);
      if (known) {
        if (prev >= 0 && i - prev > 1) {
          const float a = out[prev * W + j], b = out[i * W + j];
          for (int64_t t = prev + 1; t < i; ++t) {
            const float f = float(t - prev) / float(i - prev);
            out[t * W + j] = a + (b - a) * f;
          }
        } else if (prev < 0) {
          for (int64_t t = 0; t < i; ++t) out[t * W + j] = out[i * W + j];
        }
        prev = i;
      } else if (i == H && prev >= 0) {
        for (int64_t t = prev + 1; t < H; ++t) out[t * W + j] = out[prev * W + j];
      }
    }
  }
  return untouched;
}

}  // extern "C"
