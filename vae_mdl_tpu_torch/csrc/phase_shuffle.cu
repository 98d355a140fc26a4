// The depth-to-space epilogue of the phase-stacked transposed conv, CUDA C++
// for sm_90a.
//
// It replaces no TPU kernel: the JAX package leaves its transposed convs to
// XLA. It was added for the port's cuDNN path. nn/encoders.py computes a
// forward-only float32 kernel-4 stride-2 SAME transposed conv of C output
// channels as one stride-1 2x2 conv (padding 1) with 4C output channels on
// the (H+1) x (W+1) grid, NCHW: output channel o at phase (r, c) is grid
// channel (2r + c) * C + o, and phase (r, c) is the H x W window of the grid
// at offset (r, c). This kernel reads each output pixel's phase from its
// window, adds the bias, applies the layer's activation and writes the NCHW
// output [N, C, 2H, 2W]:
//   out[n, o, 2i + r, 2j + c] = act(grid[n, (2r + c) C + o, i + r, j + c] + bias[o])
//
// What bounds it on an H100: bytes. It reads each grid element a window
// holds once (the output's size; the grid's unused border is skipped) and
// writes each output element once, with an add and the activation between:
// 8 bytes an output element. model05's three layers at a 12,800-sample
// chunk write 2.94 GB, at least 1.76 ms at 3.35 TB/s.
//
// Design. One pass replaces the library path's bias add and activation
// after cuDNN, and the interleave no library call does: the output is
// written once and read by nothing but the next layer, NCHW, the format
// cuDNN's float32 convs wrote the grid in and read without a conversion. A
// thread writes an output row's pair (2j, 2j+1), read from column j of
// phase (r, 0)'s plane and column j + 1 of phase (r, 1)'s, so a warp reads
// two runs of neighbouring addresses and writes one 8-byte store a thread.
// It indexes within one sample in 32 bits (a block row's threads) and walks
// the samples over the launch grid's second dimension, so the index
// arithmetic is two 32-bit divisions a thread. No fast math: the add and
// the activation round as PyTorch's elementwise kernels do (erff for the
// exact gelu).
//
// The C entry point returns cudaGetLastError() after the launch, and
// cudaErrorInvalidValue, with no launch, for sizes it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;

enum Activation { kNone = 0, kRelu = 1, kGelu = 2 };  // ops/cuda/phase_shuffle.py ACTIVATIONS

template <int Act>
__device__ __forceinline__ float activate(float v) {
  if (Act == kRelu) return v < 0.0f ? 0.0f : v;  // NaN passes, as torch.relu's
  if (Act == kGelu) return v * 0.5f * (1.0f + erff(v * 0.70710678118654752440f));
  return v;
}

// grid [N, 4C, H+1, W+1] and out [N, C, 2H, 2W], both dense NCHW float32
// (out's base from the caching allocator, so 8-byte aligned).
template <int Act>
__global__ void phase_shuffle_kernel(const float* __restrict__ grid,
                                     const float* __restrict__ bias, float* __restrict__ out,
                                     int64_t N, int C, int H, int W) {
  const int per_sample = 2 * H * C * W;  // pairs of one sample's output
  const int item = blockIdx.x * kThreads + threadIdx.x;
  if (item >= per_sample) return;
  const int j = item % W;
  const int row = item / W;  // o * 2H + y
  const int y = row % (2 * H), o = row / (2 * H);
  const int r = y & 1;
  const int64_t plane = static_cast<int64_t>(H + 1) * (W + 1);
  const int64_t g0 = (2 * r * C + o) * plane + ((y >> 1) + r) * (W + 1) + j;
  const int64_t g1 = g0 + C * plane + 1;  // phase (r, 1): the plane C further, one column on
  const int64_t g_n = 4 * C * plane, o_n = 2LL * per_sample;
  const float b = bias[o];
  for (int64_t n = blockIdx.y; n < N; n += gridDim.y) {
    const float2 p = make_float2(activate<Act>(grid[n * g_n + g0] + b),
                                 activate<Act>(grid[n * g_n + g1] + b));
    reinterpret_cast<float2*>(out + n * o_n)[item] = p;
  }
}

}  // namespace

// grid [N, 4C, H+1, W+1], bias [C] and out [N, C, 2H, 2W], all dense
// float32 (NCHW); activation 0 none, 1 relu, 2 gelu (exact).
extern "C" int phase_shuffle(const float* grid, const float* bias, float* out, int activation,
                             int64_t N, int64_t C, int64_t H, int64_t W, void* stream) {
  if (activation < kNone || activation > kGelu || C < 1 || H < 1 || W < 1 || N < 0 ||
      4 * H * W * C > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const int c = static_cast<int>(C), h = static_cast<int>(H), w = static_cast<int>(W);
  const dim3 blocks(static_cast<unsigned>((2LL * H * W * C + kThreads - 1) / kThreads),
                    static_cast<unsigned>(N < kMaxGridY ? N : kMaxGridY));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (activation == kRelu)
    phase_shuffle_kernel<kRelu><<<blocks, kThreads, 0, s>>>(grid, bias, out, N, c, h, w);
  else if (activation == kGelu)
    phase_shuffle_kernel<kGelu><<<blocks, kThreads, 0, s>>>(grid, bias, out, N, c, h, w);
  else
    phase_shuffle_kernel<kNone><<<blocks, kThreads, 0, s>>>(grid, bias, out, N, c, h, w);
  return cudaGetLastError();
}
