// The ladder residual block's pointwise epilogues, forward and backward, CUDA
// C++ for sm_90a.
//
// It replaces no TPU kernel: the JAX package leaves these to XLA, which
// fuses a conv's bias and activation, the rezero gate and the residual sum
// into the conv's epilogue. It was added for the port's cuDNN path, where
// each of those is a pass over memory of its own. nn/blocks.py's
// ResidualBlock (1x1 -> 3x3 -> 3x3 -> 1x1 convs, each run by cuDNN with no
// bias) hands each raw conv output c, [N, C, H, W] dense channels-last
// (a row of C channels a pixel), to one of these:
//   inner conv:    a   = act(c + b)
//   last conv:     out = (s + sb) + g * act(c + b)
// where b is the conv's float32 bias, s the block's input or its shortcut
// conv's raw output, sb the shortcut's float32 bias (0 without one) and g
// the float32 rezero gate (1 without one). The backward recomputes
// act(c + b) from the saved raw c and writes, in one pass,
//   grad_c = (grad * g) * act'(c + b)
// with the per-channel bias gradient sum(grad_c), and for the last conv the
// shortcut bias's sum(grad) and the gate's sum(grad * act(c + b)), over the
// N * H * W pixels. s's gradient is grad itself: no kernel.
//
// What bounds them on an H100: bytes. A forward reads c (and s) and writes
// the output, a backward reads grad and c and writes grad_c: 2 or 3 passes
// of the activation, about 1 GB a step over biladder_celeba's 13 blocks in
// bf16, 0.3 ms a pass at 3.35 TB/s. The activations' tanh or erf and exp
// are a few special-function operations an element, which the SFUs take in
// a fraction of that time.
//
// Design. One pass where the library path makes two to five (the bias add,
// the activation, the gate product, the residual add; and backward the
// activation's gradient, the bias gradient's reduction, the gate's product
// and reduction). A thread moves 16 bytes of one pixel's row at a time (8
// bf16 or 4 float32 channels), a block's threads tile consecutive pixels,
// so a warp's loads are one contiguous run; each thread's channels are
// fixed, so its biases sit in registers, loaded once. The math is float32
// with one rounding to the output dtype. The sums are deterministic and use
// no atomics: each block walks its pixels in a fixed order, adds its
// threads' float32 sums in shared memory in a fixed order and writes one
// row of partials [blocks, K]; a second small kernel adds each column's
// partials in a fixed order. The grid is kBlocksPerSm blocks an SM (fewer
// where the pixels run out), which __launch_bounds__ keeps resident at
// once, so the same shape on the same card gives the same bits, eager or
// captured. No fast
// math and no mul+add contraction: the formulas are PyTorch's elementwise
// gelu and gelu_backward (tanh and exact forms), term for term.
//
// The C entry points return cudaGetLastError() after the launch, and
// cudaErrorInvalidValue, with no launch, for sizes they do not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// blocks an SM holds at once (the wrapper's BLOCKS_PER_SM): the registers a
// thread may use are capped to fit them
constexpr int kBlocksPerSm = 4;
constexpr int kMaxVec = 8;  // channels a thread moves at bf16

enum Activation { kGeluTanh = 0, kGelu = 1 };  // ops/cuda/block_epilogue.py ACTIVATIONS
enum Dtype { kFloat32 = 0, kBfloat16 = 1 };    // the same module's DTYPES

// 16 bytes of T <-> kN floats
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[kN]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&v)[kN]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[kN]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&v)[kN]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

// sqrt(2 / pi), 1 / sqrt(2 pi), 1 / sqrt(2): PyTorch's kBeta (tanh form),
// kBeta (exact form) and kAlpha, rounded to float as its opmath_t constants
constexpr float kTanhBeta = 0.7978845608028654f;
constexpr float kKappa = 0.044715f;
constexpr float kPdfBeta = 0.3989422804014327f;
constexpr float kAlpha = 0.7071067811865476f;

// act(x), as PyTorch's GeluCUDAKernelImpl
template <int Act>
__device__ __forceinline__ float act_forward(float x) {
  if (Act == kGeluTanh) {
    const float x_cube = x * x * x;
    const float inner = kTanhBeta * (x + kKappa * x_cube);
    return 0.5f * x * (1.0f + tanhf(inner));
  }
  return x * 0.5f * (1.0f + erff(x * kAlpha));
}

// act(x) and act'(x), the latter as PyTorch's GeluBackwardCUDAKernelImpl
template <int Act>
__device__ __forceinline__ void act_both(float x, float& a, float& da) {
  if (Act == kGeluTanh) {
    const float x_sq = x * x;
    const float x_cube = x_sq * x;
    const float inner = kTanhBeta * (x + kKappa * x_cube);
    const float t = tanhf(inner);
    const float left = 0.5f * x;
    const float right = 1.0f + t;
    const float left_derivative = 0.5f * right;
    const float tanh_derivative = 1.0f - t * t;
    const float inner_derivative = kTanhBeta * (1.0f + (3.0f * kKappa) * x_sq);
    a = left * right;
    da = left_derivative + left * tanh_derivative * inner_derivative;
  } else {
    const float e = erff(x * kAlpha);
    const float cdf = 0.5f * (1.0f + e);
    const float pdf = expf(-0.5f * x * x) * kPdfBeta;
    a = x * 0.5f * (1.0f + e);
    da = cdf + x * pdf;
  }
}

// A block's threads as rows of lanes: lane l of a row moves channels
// [l kN, (l + 1) kN) of one pixel; the rows take consecutive pixels.
struct Tiling {
  int lanes, rows, lane, row;
  __device__ __forceinline__ Tiling(int C, int vec) {
    lanes = C / vec;
    rows = kThreads / lanes;
    lane = threadIdx.x % lanes;
    row = threadIdx.x / lanes;
  }
};

// c, s, out: [M, C] dense (M = N H W pixels); bias, s_bias [C] float32
// (s_bias null: 0), gate a float32 scalar (null: 1); s null: no residual.
template <typename T, int Act, bool Residual>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    block_epilogue_forward_kernel(const T* __restrict__ c, const float* __restrict__ bias,
                                  const T* __restrict__ s, const float* __restrict__ s_bias,
                                  const float* __restrict__ gate, T* __restrict__ out, int64_t M,
                                  int C) {
  constexpr int kN = Pack<T>::kN;
  const Tiling t(C, kN);
  if (t.row >= t.rows) return;
  const int ch = t.lane * kN;
  float b[kN], sb[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    b[i] = bias[ch + i];
    sb[i] = (Residual && s_bias != nullptr) ? s_bias[ch + i] : 0.0f;
  }
  const float g = (Residual && gate != nullptr) ? *gate : 1.0f;
  const int64_t step = static_cast<int64_t>(gridDim.x) * t.rows;
  for (int64_t m = static_cast<int64_t>(blockIdx.x) * t.rows + t.row; m < M; m += step) {
    const int64_t off = m * C + ch;
    float v[kN];
    Pack<T>::load(c + off, v);
    if (Residual) {
      float r[kN];
      Pack<T>::load(s + off, r);
#pragma unroll
      for (int i = 0; i < kN; ++i) v[i] = (r[i] + sb[i]) + g * act_forward<Act>(v[i] + b[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) v[i] = act_forward<Act>(v[i] + b[i]);
    }
    Pack<T>::store(out + off, v);
  }
}

// Adds each channel's float32 sums over the block's rows in row order into
// partials[col0 + channel]; sums [kN] is this thread's, red the block's
// shared buffer of kThreads * kMaxVec floats.
template <int kN>
__device__ __forceinline__ void block_channel_sums(const Tiling& t, int C, const float (&sums)[kN],
                                                   float* red, float* partials) {
  if (t.row < t.rows) {
#pragma unroll
    for (int i = 0; i < kN; ++i) red[t.row * C + t.lane * kN + i] = sums[i];
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < C; ch += kThreads) {
    float acc = 0.0f;
    for (int r = 0; r < t.rows; ++r) acc += red[r * C + ch];
    partials[ch] = acc;
  }
  __syncthreads();
}

// grad, c, grad_c: [M, C] dense; bias [C] float32, gate as the forward's.
// partials [gridDim.x, K]: per block the bias gradient's sums [C], and with
// Residual the shortcut bias's [C] and the gate's [1] (K = 2C + 1).
template <typename T, int Act, bool Residual>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    block_epilogue_backward_kernel(const T* __restrict__ grad, const T* __restrict__ c,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ gate, T* __restrict__ grad_c,
                                   float* __restrict__ partials, int64_t M, int C) {
  constexpr int kN = Pack<T>::kN;
  __shared__ float red[kThreads * kMaxVec];
  const Tiling t(C, kN);
  const int ch = t.lane * kN;
  float b[kN], sum_b[kN], sum_s[kN], sum_g = 0.0f;
  const float g = (Residual && gate != nullptr) ? *gate : 1.0f;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    b[i] = bias[ch + i];
    sum_b[i] = sum_s[i] = 0.0f;
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * t.rows;
  const int64_t first = t.row < t.rows ? static_cast<int64_t>(blockIdx.x) * t.rows + t.row : M;
  for (int64_t m = first; m < M; m += step) {
    const int64_t off = m * C + ch;
    float dy[kN], v[kN];
    Pack<T>::load(grad + off, dy);
    Pack<T>::load(c + off, v);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      float a, da;
      act_both<Act>(v[i] + b[i], a, da);
      const float gc = (dy[i] * g) * da;
      sum_b[i] += gc;
      if (Residual) {
        sum_s[i] += dy[i];
        sum_g += dy[i] * a;
      }
      v[i] = gc;
    }
    Pack<T>::store(grad_c + off, v);
  }
  const int K = Residual ? 2 * C + 1 : C;
  float* row = partials + static_cast<int64_t>(blockIdx.x) * K;
  block_channel_sums<kN>(t, C, sum_b, red, row);
  if (Residual) {
    block_channel_sums<kN>(t, C, sum_s, red, row + C);
    red[threadIdx.x] = sum_g;  // 0 in the threads past the last row
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half >>= 1) {
      if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
      __syncthreads();
    }
    if (threadIdx.x == 0) row[2 * C] = red[0];
  }
}

// out[k] = the sum over the G rows of partials [G, K], column k, in a fixed
// order: a block a column, each thread a strided run of rows, then a tree.
__global__ void __launch_bounds__(kThreads)
    block_epilogue_sum_kernel(const float* __restrict__ partials, float* __restrict__ out, int G,
                              int K) {
  __shared__ float red[kThreads];
  const int k = blockIdx.x;
  float acc = 0.0f;
  for (int r = threadIdx.x; r < G; r += kThreads) acc += partials[static_cast<int64_t>(r) * K + k];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k] = red[0];
}

bool takes(int dtype, int activation, int64_t M, int64_t C) {
  const int vec = dtype == kBfloat16 ? Pack<__nv_bfloat16>::kN : Pack<float>::kN;
  return (dtype == kFloat32 || dtype == kBfloat16) &&
         (activation == kGeluTanh || activation == kGelu) && M >= 0 && C >= vec &&
         C % vec == 0 && C / vec <= kThreads && M * C < (int64_t(1) << 62);
}

// The launches of one (T, Act) instantiation; Residual at run time.
template <typename T, int Act>
struct Launch {
  static void forward(const void* c, const float* bias, const void* s, const float* s_bias,
                      const float* gate, void* out, int64_t M, int C, unsigned grid,
                      cudaStream_t st) {
    if (s != nullptr)
      block_epilogue_forward_kernel<T, Act, true><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(c), bias, static_cast<const T*>(s), s_bias, gate,
          static_cast<T*>(out), M, C);
    else
      block_epilogue_forward_kernel<T, Act, false><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(c), bias, nullptr, nullptr, nullptr, static_cast<T*>(out), M, C);
  }
  static void backward(const void* grad, const void* c, const float* bias, const float* gate,
                       void* grad_c, float* partials, bool residual, int64_t M, int C,
                       unsigned grid, cudaStream_t st) {
    if (residual)
      block_epilogue_backward_kernel<T, Act, true><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(grad), static_cast<const T*>(c), bias, gate,
          static_cast<T*>(grad_c), partials, M, C);
    else
      block_epilogue_backward_kernel<T, Act, false><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(grad), static_cast<const T*>(c), bias, nullptr,
          static_cast<T*>(grad_c), partials, M, C);
  }
};

// Launch<T, Act> of (dtype, activation), which takes() has checked.
template <typename F>
void dispatch(int dtype, int activation, F&& f) {
  if (dtype == kBfloat16) {
    if (activation == kGeluTanh)
      f(Launch<__nv_bfloat16, kGeluTanh>{});
    else
      f(Launch<__nv_bfloat16, kGelu>{});
  } else {
    if (activation == kGeluTanh)
      f(Launch<float, kGeluTanh>{});
    else
      f(Launch<float, kGelu>{});
  }
}

bool takes_grid(int64_t grid) { return grid >= 1 && grid <= 0x7fffffffLL; }

}  // namespace

// out = act(c + bias), or with s non-null (s + s_bias) + gate * act(c + bias);
// c, s, out [M, C] dense, dtype 0 float32, 1 bfloat16; bias, s_bias [C] and
// gate [] float32 (s_bias, gate null: 0 and 1); activation 0 gelu_tanh,
// 1 gelu; grid blocks walk the M pixels (the wrapper's: as many as the card
// holds at once, fewer where M is smaller).
extern "C" int block_epilogue_forward(const void* c, const float* bias, const void* s,
                                      const float* s_bias, const float* gate, void* out,
                                      int dtype, int activation, int64_t M, int64_t C, int64_t grid,
                                      void* stream) {
  if (!takes(dtype, activation, M, C) || !takes_grid(grid)) return cudaErrorInvalidValue;
  dispatch(dtype, activation, [&](auto launch) {
    launch.forward(c, bias, s, s_bias, gate, out, M, static_cast<int>(C),
                   static_cast<unsigned>(grid), static_cast<cudaStream_t>(stream));
  });
  return cudaGetLastError();
}

// grad_c = (grad * gate) * act'(c + bias) and the sums: sums [K] receives the
// bias gradient [C], and with residual the shortcut bias's [C] and the
// gate's [1] (K = 2C + 1); partials [grid, K] is the wrapper's scratch.
// Two launches: the pass, then the partials' column sums.
extern "C" int block_epilogue_backward(const void* grad, const void* c, const float* bias,
                                       const float* gate, void* grad_c, float* partials,
                                       float* sums, int residual, int dtype, int activation,
                                       int64_t M, int64_t C, int64_t grid, void* stream) {
  if (!takes(dtype, activation, M, C) || !takes_grid(grid)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ci = static_cast<int>(C);
  dispatch(dtype, activation, [&](auto launch) {
    launch.backward(grad, c, bias, gate, grad_c, partials, residual != 0, M, ci,
                    static_cast<unsigned>(grid), st);
  });
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int K = residual ? 2 * ci + 1 : ci;
  block_epilogue_sum_kernel<<<K, kThreads, 0, st>>>(partials, sums, static_cast<int>(grid), K);
  return cudaGetLastError();
}
