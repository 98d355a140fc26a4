// How the MoDL kernels walk their operands: one thread per (k, b, h, w) pixel
// in a grid-stride loop, 256 threads a block, every operand addressed through
// its own element strides. Shared by mdl_log_prob.cu and by the null-body
// kernels of io_probe.cu, which have the MoDL kernels' launch shape and
// addressing and none of their math.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mdla {

constexpr int kThreads = 256;

inline dim3 grid_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return dim3(static_cast<unsigned>(blocks < (1LL << 30) ? blocks : (1LL << 30)));
}

// The pixel of linear index i over [K, B, H, W], W fastest.
struct Pixel {
  int64_t k, b, h, w;
};

__device__ __forceinline__ Pixel pixel_of(int64_t i, int64_t B, int64_t H, int64_t W) {
  Pixel px;
  px.w = i % W;
  i /= W;
  px.h = i % H;
  i /= H;
  px.b = i % B;
  px.k = i / B;
  return px;
}

// Element offsets of a pixel: in x [B, H, W, 3] (broadcast over k) and in a
// [K, B, H, W, ...] operand.
__device__ __forceinline__ int64_t image_offset(const Pixel& px, int64_t s_b, int64_t s_h,
                                                int64_t s_w) {
  return px.b * s_b + px.h * s_h + px.w * s_w;
}

__device__ __forceinline__ int64_t sample_offset(const Pixel& px, int64_t s_k, int64_t s_b,
                                                 int64_t s_h, int64_t s_w) {
  return px.k * s_k + px.b * s_b + px.h * s_h + px.w * s_w;
}

}  // namespace mdla
