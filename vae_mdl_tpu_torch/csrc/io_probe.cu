// Memory-path probes and null-body MoDL kernels, CUDA C++ for sm_90a.
//
// channel_sum replaces the Pallas probes of scripts/kernel_isolate.py (make,
// bodies dma_only and transpose_sum: a per-pixel sum over the channels of a
// channel-minor [K, P, C] tensor) and of scripts/kernel_isolate2.py (main: the
// same sum from a channel-first [K, C, P] tensor). mdl_null_forward and
// mdl_null_backward replace scripts/kernel_structure_probe.py make_variant
// (bodies fwd_dma/bwd_dma and fwd_tr/bwd_tr): kernels with the arguments,
// strides, dtypes, launch shape and addressing (mdl_addressing.cuh) of
// mdl_log_prob_forward and mdl_log_prob_backward that read every input
// element, write every output element and do no likelihood math:
//   forward   out = sum_c params + sum_c x        per pixel
//   backward  dparams = 0.5 * params + g          per element
//
// What bounds them on an H100: bytes. At K = 100, P = 102400, C = 50 the sum
// reads 2.05 GB and writes 41 MB, 0.62 ms at 3.35 TB/s; the null backward at
// the train shape (k = 5, B = 128, 32 x 32, 50 channels, f32) moves 265 MB,
// 0.08 ms. What they measure is how much of that rate each memory path
// reaches.
//
// Design. The TPU probes compare a tile read as it lies with a tile
// transposed in fast memory; the block sizes they sweep are that memory's
// tiling. Here the two bodies are two memory paths:
// - direct: a thread walks its pixel's channels straight from device memory
//   through the channel stride, as the MoDL kernels do. On a channel-minor
//   layout neighbouring threads are C elements apart (uncoalesced, saved by
//   the caches as far as they reach); on a channel-first layout they are
//   neighbours (coalesced);
// - staged: a block's tile of pixels goes through shared memory. Threads
//   load it in the order the memory lies (coalesced in either layout), each
//   pixel's row padded to an odd length so that a thread reading its own row
//   meets no bank conflict, and a thread then sums or rewrites its row there;
//   the null backward writes its tile back the same way.
// The null kernels take the MoDL kernels' grid (one thread per pixel, 256 a
// block); x is read in both, in the backward through a predicate that is
// never true for x in [0, 1], so the read stays and the result is exact.
//
// Each C entry point returns cudaGetLastError() after the launch.

#include "dl_cascade.cuh"
#include "mdl_addressing.cuh"

namespace {

using dlc::load;
using dlc::store;
using mdla::kThreads;

constexpr int kMaxMix = 10;

// A pixel's row in shared memory: C values, padded to an odd length.
__host__ __device__ __forceinline__ int padded(int C) { return C | 1; }

// -- channel sum --------------------------------------------------------------

__global__ void channel_sum_direct_kernel(const float* __restrict__ p, float* __restrict__ out,
                                          int64_t K, int64_t P, int C, int64_t s_k, int64_t s_p,
                                          int64_t s_c) {
  const int64_t total = K * P;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t k = i / P;
    const float* pp = p + k * s_k + (i - k * P) * s_p;
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) acc += pp[c * s_c];
    out[i] = acc;
  }
}

// Contiguous channel-minor [rows, C]: a block stages blockDim.x rows.
__global__ void channel_sum_staged_kernel(const float* __restrict__ p, float* __restrict__ out,
                                          int64_t rows, int C) {
  extern __shared__ float tile[];
  const int CP = padded(C);
  const int T = blockDim.x;
  for (int64_t row0 = blockIdx.x * (int64_t)T; row0 < rows; row0 += (int64_t)gridDim.x * T) {
    const int n = static_cast<int>(rows - row0 < T ? rows - row0 : T);
    const float* src = p + row0 * C;
    for (int e = threadIdx.x; e < n * C; e += T) {
      const int r = e / C;
      tile[r * CP + (e - r * C)] = src[e];
    }
    __syncthreads();
    if (threadIdx.x < n) {
      const float* row = tile + threadIdx.x * CP;
      float acc = 0.0f;
      for (int c = 0; c < C; ++c) acc += row[c];
      out[row0 + threadIdx.x] = acc;
    }
    __syncthreads();
  }
}

// -- null-body MoDL kernels, direct -------------------------------------------

template <typename T>
__global__ void mdl_null_forward_kernel(
    const float* __restrict__ x, const T* __restrict__ p, float* __restrict__ out, int C,
    int64_t K, int64_t B, int64_t H, int64_t W,
    int64_t xs_b, int64_t xs_h, int64_t xs_w, int64_t xs_c,
    int64_t ps_k, int64_t ps_b, int64_t ps_h, int64_t ps_w, int64_t ps_c) {
  const int64_t total = K * B * H * W;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const mdla::Pixel px = mdla::pixel_of(i, B, H, W);
    const float* xp = x + mdla::image_offset(px, xs_b, xs_h, xs_w);
    const float xsum = xp[0] + xp[xs_c] + xp[2 * xs_c];
    const T* pp = p + mdla::sample_offset(px, ps_k, ps_b, ps_h, ps_w);
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) acc += load(pp + c * ps_c);
    out[i] = acc + xsum;
  }
}

template <typename T>
__global__ void mdl_null_backward_kernel(
    const float* __restrict__ x, const T* __restrict__ p, const float* __restrict__ g,
    T* __restrict__ dp, int C, int64_t K, int64_t B, int64_t H, int64_t W,
    int64_t xs_b, int64_t xs_h, int64_t xs_w, int64_t xs_c,
    int64_t ps_k, int64_t ps_b, int64_t ps_h, int64_t ps_w, int64_t ps_c,
    int64_t gs_k, int64_t gs_b, int64_t gs_h, int64_t gs_w,
    int64_t ds_k, int64_t ds_b, int64_t ds_h, int64_t ds_w, int64_t ds_c) {
  const int64_t total = K * B * H * W;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const mdla::Pixel px = mdla::pixel_of(i, B, H, W);
    const float* xp = x + mdla::image_offset(px, xs_b, xs_h, xs_w);
    const float xsum = xp[0] + xp[xs_c] + xp[2 * xs_c];
    const T* pp = p + mdla::sample_offset(px, ps_k, ps_b, ps_h, ps_w);
    T* dpp = dp + mdla::sample_offset(px, ds_k, ds_b, ds_h, ds_w);
    float gv = g[mdla::sample_offset(px, gs_k, gs_b, gs_h, gs_w)];
    if (xsum < 0.0f) gv = 0.0f;  // never for x in [0, 1]: keeps the read of x
    for (int c = 0; c < C; ++c) store(dpp + c * ds_c, load(pp + c * ps_c) * 0.5f + gv);
  }
}

// -- null-body MoDL kernels, staged through shared memory ------------------------

// Shared memory of a staged block: the element offsets of its kThreads pixels
// in the parameters and in the gradient, then the tile [kThreads, padded(C)].
template <typename T>
struct Staging {
  int64_t* p_base;
  int64_t* d_base;
  T* tile;
  __device__ explicit Staging(unsigned char* smem)
      : p_base(reinterpret_cast<int64_t*>(smem)),
        d_base(p_base + kThreads),
        tile(reinterpret_cast<T*>(d_base + kThreads)) {}
};

size_t staging_bytes(int C, size_t element) {
  return 2 * kThreads * sizeof(int64_t) + static_cast<size_t>(kThreads) * padded(C) * element;
}

// Move n pixels' C channels between device memory (element offset base[r] +
// c * s_c) and the tile, walking device memory in the order it lies:
// channels fastest where the channel stride is the smaller, pixels fastest
// otherwise.
template <typename T, bool kToTile>
__device__ __forceinline__ void move_tile(T* mem, const int64_t* base, int64_t s_c,
                                          bool channel_minor, T* tile, int n, int C) {
  const int CP = padded(C);
  for (int e = threadIdx.x; e < n * C; e += kThreads) {
    int r, c;
    if (channel_minor) {
      r = e / C;
      c = e - r * C;
    } else {
      c = e / n;
      r = e - c * n;
    }
    if (kToTile) {
      tile[r * CP + c] = mem[base[r] + c * s_c];
    } else {
      mem[base[r] + c * s_c] = tile[r * CP + c];
    }
  }
}

template <typename T>
__global__ void mdl_null_forward_staged_kernel(
    const float* __restrict__ x, const T* __restrict__ p, float* __restrict__ out, int C,
    int64_t K, int64_t B, int64_t H, int64_t W,
    int64_t xs_b, int64_t xs_h, int64_t xs_w, int64_t xs_c,
    int64_t ps_k, int64_t ps_b, int64_t ps_h, int64_t ps_w, int64_t ps_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Staging<T> st(smem);
  const int CP = padded(C);
  const int64_t total = K * B * H * W;
  for (int64_t i0 = blockIdx.x * (int64_t)kThreads; i0 < total;
       i0 += (int64_t)gridDim.x * kThreads) {
    const int n = static_cast<int>(total - i0 < kThreads ? total - i0 : kThreads);
    const bool mine = threadIdx.x < n;
    mdla::Pixel px{0, 0, 0, 0};
    if (mine) {
      px = mdla::pixel_of(i0 + threadIdx.x, B, H, W);
      st.p_base[threadIdx.x] = mdla::sample_offset(px, ps_k, ps_b, ps_h, ps_w);
    }
    __syncthreads();
    move_tile<T, true>(const_cast<T*>(p), st.p_base, ps_c, ps_c < ps_w, st.tile, n, C);
    __syncthreads();
    if (mine) {
      const float* xp = x + mdla::image_offset(px, xs_b, xs_h, xs_w);
      const float xsum = xp[0] + xp[xs_c] + xp[2 * xs_c];
      const T* row = st.tile + threadIdx.x * CP;
      float acc = 0.0f;
      for (int c = 0; c < C; ++c) acc += load(row + c);
      out[i0 + threadIdx.x] = acc + xsum;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void mdl_null_backward_staged_kernel(
    const float* __restrict__ x, const T* __restrict__ p, const float* __restrict__ g,
    T* __restrict__ dp, int C, int64_t K, int64_t B, int64_t H, int64_t W,
    int64_t xs_b, int64_t xs_h, int64_t xs_w, int64_t xs_c,
    int64_t ps_k, int64_t ps_b, int64_t ps_h, int64_t ps_w, int64_t ps_c,
    int64_t gs_k, int64_t gs_b, int64_t gs_h, int64_t gs_w,
    int64_t ds_k, int64_t ds_b, int64_t ds_h, int64_t ds_w, int64_t ds_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Staging<T> st(smem);
  const int CP = padded(C);
  const int64_t total = K * B * H * W;
  for (int64_t i0 = blockIdx.x * (int64_t)kThreads; i0 < total;
       i0 += (int64_t)gridDim.x * kThreads) {
    const int n = static_cast<int>(total - i0 < kThreads ? total - i0 : kThreads);
    const bool mine = threadIdx.x < n;
    mdla::Pixel px{0, 0, 0, 0};
    if (mine) {
      px = mdla::pixel_of(i0 + threadIdx.x, B, H, W);
      st.p_base[threadIdx.x] = mdla::sample_offset(px, ps_k, ps_b, ps_h, ps_w);
      st.d_base[threadIdx.x] = mdla::sample_offset(px, ds_k, ds_b, ds_h, ds_w);
    }
    __syncthreads();
    move_tile<T, true>(const_cast<T*>(p), st.p_base, ps_c, ps_c < ps_w, st.tile, n, C);
    __syncthreads();
    if (mine) {
      const float* xp = x + mdla::image_offset(px, xs_b, xs_h, xs_w);
      const float xsum = xp[0] + xp[xs_c] + xp[2 * xs_c];
      float gv = g[mdla::sample_offset(px, gs_k, gs_b, gs_h, gs_w)];
      if (xsum < 0.0f) gv = 0.0f;  // never for x in [0, 1]: keeps the read of x
      T* row = st.tile + threadIdx.x * CP;
      for (int c = 0; c < C; ++c) store(row + c, load(row + c) * 0.5f + gv);
    }
    __syncthreads();
    move_tile<T, false>(dp, st.d_base, ds_c, ds_c < ds_w, st.tile, n, C);
    __syncthreads();
  }
}

// Opt the kernel in to `bytes` of dynamic shared memory (above 48 KB a kernel
// must ask). A refusal is returned and taken off the runtime's last-error
// state, so that it is not reported again by the next launch's check.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

template <typename T>
cudaError_t launch_null_forward(int staged, int C, dim3 grid, cudaStream_t s, const float* x,
                                const T* p, float* out, int64_t K, int64_t B, int64_t H,
                                int64_t W, int64_t xs_b, int64_t xs_h, int64_t xs_w,
                                int64_t xs_c, int64_t ps_k, int64_t ps_b, int64_t ps_h,
                                int64_t ps_w, int64_t ps_c) {
  const dim3 block(kThreads);
  if (staged) {
    const size_t bytes = staging_bytes(C, sizeof(T));
    const cudaError_t err = allow_shared(mdl_null_forward_staged_kernel<T>, bytes);
    if (err != cudaSuccess) return err;
    mdl_null_forward_staged_kernel<T><<<grid, block, bytes, s>>>(
        x, p, out, C, K, B, H, W, xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c);
  } else {
    mdl_null_forward_kernel<T><<<grid, block, 0, s>>>(
        x, p, out, C, K, B, H, W, xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_null_backward(int staged, int C, dim3 grid, cudaStream_t s, const float* x,
                                 const T* p, const float* g, T* dp, int64_t K, int64_t B,
                                 int64_t H, int64_t W, int64_t xs_b, int64_t xs_h,
                                 int64_t xs_w, int64_t xs_c, int64_t ps_k, int64_t ps_b,
                                 int64_t ps_h, int64_t ps_w, int64_t ps_c, int64_t gs_k,
                                 int64_t gs_b, int64_t gs_h, int64_t gs_w, int64_t ds_k,
                                 int64_t ds_b, int64_t ds_h, int64_t ds_w, int64_t ds_c) {
  const dim3 block(kThreads);
  if (staged) {
    const size_t bytes = staging_bytes(C, sizeof(T));
    const cudaError_t err = allow_shared(mdl_null_backward_staged_kernel<T>, bytes);
    if (err != cudaSuccess) return err;
    mdl_null_backward_staged_kernel<T><<<grid, block, bytes, s>>>(
        x, p, g, dp, C, K, B, H, W, xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c,
        gs_k, gs_b, gs_h, gs_w, ds_k, ds_b, ds_h, ds_w, ds_c);
  } else {
    mdl_null_backward_kernel<T><<<grid, block, 0, s>>>(
        x, p, g, dp, C, K, B, H, W, xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c,
        gs_k, gs_b, gs_h, gs_w, ds_k, ds_b, ds_h, ds_w, ds_c);
  }
  return cudaGetLastError();
}

}  // namespace

// params: float32 [K, P, C] read through element strides (s_k, s_p, s_c), so
// a channel-first [K, C, P] tensor is the same call with its strides; out:
// contiguous float32 [K, P]. staged = 1 needs the contiguous channel-minor
// layout and stages `tile` pixels (the block size: 32..1024, a multiple of
// 32) through shared memory. Returns a cudaError_t (0 = launched).
extern "C" int channel_sum(const void* params, void* out, int staged, int tile, int64_t K,
                           int64_t P, int64_t C, int64_t s_k, int64_t s_p, int64_t s_c,
                           void* stream) {
  const int64_t total = K * P;
  if (total <= 0) return cudaSuccess;
  if (C < 1 || C > (1 << 20)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(params);
  float* o = static_cast<float*>(out);
  if (!staged) {
    channel_sum_direct_kernel<<<mdla::grid_for(total), dim3(kThreads), 0, s>>>(
        p, o, K, P, static_cast<int>(C), s_k, s_p, s_c);
    return cudaGetLastError();
  }
  if (s_c != 1 || s_p != C || s_k != P * C) return cudaErrorInvalidValue;
  if (tile < 32 || tile > 1024 || tile % 32) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(tile) * padded(static_cast<int>(C)) * sizeof(float);
  const cudaError_t err = allow_shared(channel_sum_staged_kernel, bytes);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (total + tile - 1) / tile;
  const dim3 grid(static_cast<unsigned>(blocks < (1LL << 30) ? blocks : (1LL << 30)));
  channel_sum_staged_kernel<<<grid, dim3(tile), bytes, s>>>(p, o, total, static_cast<int>(C));
  return cudaGetLastError();
}

// The arguments of mdl_log_prob_forward plus `staged` (0 = direct reads, 1 =
// through shared memory): x float32 [B, H, W, 3] view, params float32 or
// bf16 [K, B, H, W, 10 * n_mix] view, out contiguous float32 [K, B, H, W].
extern "C" int mdl_null_forward(
    const void* x, const void* params, void* out, int params_bf16, int n_mix, int staged,
    int64_t K, int64_t B, int64_t H, int64_t W,
    int64_t xs_b, int64_t xs_h, int64_t xs_w, int64_t xs_c,
    int64_t ps_k, int64_t ps_b, int64_t ps_h, int64_t ps_w, int64_t ps_c,
    void* stream) {
  if (n_mix < 1 || n_mix > kMaxMix) return cudaErrorInvalidValue;
  const int64_t total = K * B * H * W;
  if (total <= 0) return cudaSuccess;
  const dim3 grid = mdla::grid_for(total);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (params_bf16) {
    return launch_null_forward(staged, 10 * n_mix, grid, s, xf,
                               static_cast<const __nv_bfloat16*>(params), o, K, B, H, W,
                               xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c);
  }
  return launch_null_forward(staged, 10 * n_mix, grid, s, xf, static_cast<const float*>(params),
                             o, K, B, H, W, xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w,
                             ps_c);
}

// The arguments of mdl_log_prob_backward plus `staged`: g float32
// [K, B, H, W] view (zero strides allowed), dparams in the params' dtype,
// written through its own strides.
extern "C" int mdl_null_backward(
    const void* x, const void* params, const void* g, void* dparams, int params_bf16,
    int n_mix, int staged, int64_t K, int64_t B, int64_t H, int64_t W,
    int64_t xs_b, int64_t xs_h, int64_t xs_w, int64_t xs_c,
    int64_t ps_k, int64_t ps_b, int64_t ps_h, int64_t ps_w, int64_t ps_c,
    int64_t gs_k, int64_t gs_b, int64_t gs_h, int64_t gs_w,
    int64_t ds_k, int64_t ds_b, int64_t ds_h, int64_t ds_w, int64_t ds_c,
    void* stream) {
  if (n_mix < 1 || n_mix > kMaxMix) return cudaErrorInvalidValue;
  const int64_t total = K * B * H * W;
  if (total <= 0) return cudaSuccess;
  const dim3 grid = mdla::grid_for(total);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  if (params_bf16) {
    return launch_null_backward(staged, 10 * n_mix, grid, s, xf,
                                static_cast<const __nv_bfloat16*>(params), gf,
                                static_cast<__nv_bfloat16*>(dparams), K, B, H, W,
                                xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c,
                                gs_k, gs_b, gs_h, gs_w, ds_k, ds_b, ds_h, ds_w, ds_c);
  }
  return launch_null_backward(staged, 10 * n_mix, grid, s, xf,
                              static_cast<const float*>(params), gf,
                              static_cast<float*>(dparams), K, B, H, W,
                              xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c,
                              gs_k, gs_b, gs_h, gs_w, ds_k, ds_b, ds_h, ds_w, ds_c);
}
