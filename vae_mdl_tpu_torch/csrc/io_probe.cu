// Memory-path probes and null-body MoDL kernels, CUDA C++ for sm_90a.
//
// channel_sum replaces the Pallas probes of scripts/kernel_isolate.py (make,
// bodies dma_only and transpose_sum: a per-pixel sum over the channels of a
// channel-minor [K, P, C] tensor) and of scripts/kernel_isolate2.py (main: the
// same sum from a channel-first [K, C, P] tensor, which takes the vec4
// kernel: 16-byte loads, a warp walking 2 KB of each row, many in flight). mdl_null_forward and
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
// tiling. Here the bodies are memory paths:
// - direct: a thread walks its pixel's channels straight from device memory
//   through the channel stride, as the MoDL kernels' direct paths do. On a
//   channel-minor layout neighbouring threads are C elements apart
//   (uncoalesced: the caches save a read as far as they reach, a write they
//   do not, so the direct null backward is slow there by construction; it is
//   the control whose distance from the staged one is the staging term); on
//   a channel-first layout they are neighbours (coalesced);
// - staged: the shipped kernels' own memory path and dispatch, the read walk
//   of mdl_tile.cuh for the channel sum and the null forward (persistent
//   blocks, the tile in by a bulk asynchronous copy on an mbarrier, a thread
//   summing its row there), for_each_tile for the null backward (the result
//   written over the tile and out by one bulk store). The null kernels take
//   it for dense channel-minor operands on 16-byte aligned addresses and the
//   direct path for any other layout, as the MoDL kernels do; the channel sum
//   takes only the contiguous channel-minor layout on a 16-byte aligned base,
//   kSumPixels pixels a thread, and reads no image. The header is shared, so
//   a twin cannot drift from the kernel it mirrors, and the sum measures the
//   read walk's own rate with no math.
// The null kernels off the tile path take the MoDL kernels' grid (one thread
// per pixel, 256 a block); x is read in all of them, in the backward through
// a predicate that is never true for x in [0, 1], so the read stays and the
// result is exact. Every sum adds a pixel's channels in order, c = 0 .. C-1,
// on every path, so the paths give the same bits.
//
// Each C entry point returns cudaGetLastError() after the launch.

#include "dl_cascade.cuh"
#include "mdl_addressing.cuh"
#include "mdl_tile.cuh"

namespace {

using dlc::load;
using dlc::store;
using mdla::kThreads;

constexpr int kMaxMix = 10;
constexpr size_t kMaxSharedBytes = 232448;  // a block's dynamic shared memory on Hopper

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

// Channel-first [K, C, P] with pixel stride 1 (P a multiple of 512, the
// channel and sample strides multiples of 4, a 16-byte aligned base, every
// offset below 2^31): 16-byte loads of four pixels, 32-bit index arithmetic. A
// warp sums 512 consecutive pixels of a row, a thread kSumGroups groups of
// four 32 groups apart, so that each of the warp's loads is 512 consecutive
// bytes and it walks 2 KB of each channel's row; the channel loop is unrolled
// so that 20 independent loads are in flight. The grid covers K * P / 4
// groups once. Each pixel's channels add in the order the strided kernel adds
// them, so the two give the same bits.
constexpr int kSumGroups = 4;
constexpr int kSumWarpPixels = 32 * kSumGroups * 4;

__global__ void channel_sum_vec4_kernel(const float* __restrict__ p, float* __restrict__ out,
                                        int P4, int n4, int C, int s_k4, int s_c4) {
  // the warp's first group; a row holds whole warps' worth of groups
  const int base = (blockIdx.x * blockDim.x + threadIdx.x) / 32 * (32 * kSumGroups);
  if (base >= n4) return;
  const int lane = threadIdx.x % 32;
  const int k = base / P4;
  const float4* src = reinterpret_cast<const float4*>(p) + k * s_k4 + (base - k * P4) + lane;
  float4 acc[kSumGroups];
#pragma unroll
  for (int g = 0; g < kSumGroups; ++g) acc[g] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 5
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int g = 0; g < kSumGroups; ++g) {
      const float4 v = __ldg(src + c * s_c4 + 32 * g);
      acc[g].x += v.x;
      acc[g].y += v.y;
      acc[g].z += v.z;
      acc[g].w += v.w;
    }
  }
#pragma unroll
  for (int g = 0; g < kSumGroups; ++g)
    reinterpret_cast<float4*>(out)[base + lane + 32 * g] = acc[g];
}

// Contiguous channel-minor [K * P, C] on the read walk: a thread sums its
// row in shared memory in channel order, as the strided kernel does. Tiles
// of kTilePixels * kSumPixels pixels (51,200 B at C = 50, four blocks an
// SM). One, two and four pixels a thread came within 0.5% of each other on
// the H100, two and four level; two takes rows of up to 226 channels, four
// only up to 113.
constexpr int kSumPixels = 2;

struct RowSum {
  int C;
  __device__ __forceinline__ void operator()(const float* row, float, float, float,
                                             float* out) const {
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) acc += row[c];
    *out = acc;
  }
};

__global__ void __launch_bounds__(mdlt::kTilePixels)
    channel_sum_tiled_kernel(const mdlt::ReadOperands<float> a) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  mdlt::for_each_tile_read<float, 1, kSumPixels, false>(a, tile_smem, RowSum{a.C});
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

// -- null-body MoDL forward on the read walk ------------------------------------------

// The body in place of the likelihood: the row's sum plus the image's, in the
// direct kernel's order.
template <typename T>
struct NullForward {
  int C;
  __device__ __forceinline__ void operator()(const T* row, float x0, float x1, float x2,
                                             float* out) const {
    const float xsum = x0 + x1 + x2;
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) acc += load(row + c);
    *out = acc + xsum;
  }
};

template <typename T>
__global__ void __launch_bounds__(mdlt::kTilePixels)
    mdl_null_forward_tiled_kernel(const mdlt::ReadOperands<T> a) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  mdlt::for_each_tile_read<T>(a, tile_smem, NullForward<T>{a.C});
}

// -- null-body MoDL backward on the tile path ---------------------------------------

// The body in place of the gradient math: 0.5 p + g over the pixel's row.
template <typename T>
struct NullBackward {
  int C;
  __device__ __forceinline__ void operator()(T* row, float*, float x0, float x1, float x2,
                                             float gv) const {
    if (x0 + x1 + x2 < 0.0f) gv = 0.0f;  // never for x in [0, 1]: keeps the read of x
    for (int c = 0; c < C; ++c) store(row + c, load(row + c) * 0.5f + gv);
  }
};

template <typename T>
__global__ void __launch_bounds__(mdlt::kTilePixels)
    mdl_null_backward_tiled_kernel(const mdlt::Operands<T> a) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  mdlt::for_each_tile<T, false>(a, tile_smem, NullBackward<T>{a.C});
}

template <typename T>
cudaError_t launch_null_forward(int tiled, int C, cudaStream_t s, const float* x, const T* p,
                                float* out, int64_t K, int64_t B, int64_t H, int64_t W,
                                int64_t xs_b, int64_t xs_h, int64_t xs_w, int64_t xs_c,
                                int64_t ps_k, int64_t ps_b, int64_t ps_h, int64_t ps_w,
                                int64_t ps_c) {
  if (tiled) {
    if (!mdlt::channel_minor_dense(K, B, H, W, C, ps_k, ps_b, ps_h, ps_w, ps_c) ||
        !mdlt::aligned16(p))
      return cudaErrorInvalidValue;
    return mdlt::launch<T>(mdl_null_forward_tiled_kernel<T>, s,
                        {x, p, out, C, K, B, H, W, xs_b, xs_h, xs_w, xs_c});
  }
  mdl_null_forward_kernel<T><<<mdla::grid_for(K * B * H * W), dim3(kThreads), 0, s>>>(
      x, p, out, C, K, B, H, W, xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_null_backward(dim3 grid, cudaStream_t s, const float* x, const T* p,
                                 const float* g, T* dp, int C, int64_t K, int64_t B, int64_t H,
                                 int64_t W, int64_t xs_b, int64_t xs_h, int64_t xs_w,
                                 int64_t xs_c, int64_t ps_k, int64_t ps_b, int64_t ps_h,
                                 int64_t ps_w, int64_t ps_c, int64_t gs_k, int64_t gs_b,
                                 int64_t gs_h, int64_t gs_w, int64_t ds_k, int64_t ds_b,
                                 int64_t ds_h, int64_t ds_w, int64_t ds_c) {
  mdl_null_backward_kernel<T><<<grid, dim3(kThreads), 0, s>>>(
      x, p, g, dp, C, K, B, H, W, xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c,
      gs_k, gs_b, gs_h, gs_w, ds_k, ds_b, ds_h, ds_w, ds_c);
  return cudaGetLastError();
}

}  // namespace

// params: float32 [K, P, C] read through element strides (s_k, s_p, s_c), so
// a channel-first [K, C, P] tensor is the same call with its strides; out:
// contiguous float32 [K, P]. The caller names the kernel: 0 strided (any
// strides, one thread a pixel); 1 tiled (the read walk: the contiguous
// channel-minor layout on a 16-byte aligned base); 2 vec4 (channel-first
// with pixel stride 1 and rows of a multiple of 512 pixels, 16-byte loads,
// see channel_sum_vec4_kernel). Asked for a kernel the operands do not fit,
// it returns cudaErrorInvalidValue. Returns a cudaError_t (0 = launched).
extern "C" int channel_sum(const void* params, void* out, int kernel, int64_t K, int64_t P,
                           int64_t C, int64_t s_k, int64_t s_p, int64_t s_c, void* stream) {
  const int64_t total = K * P;
  if (total <= 0) return cudaSuccess;
  if (C < 1 || C > (1 << 20) || kernel < 0 || kernel > 2) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(params);
  float* o = static_cast<float*>(out);
  if (kernel == 0) {
    channel_sum_direct_kernel<<<mdla::grid_for(total), dim3(kThreads), 0, s>>>(
        p, o, K, P, static_cast<int>(C), s_k, s_p, s_c);
    return cudaGetLastError();
  }
  if (kernel == 2) {
    const int64_t span = (K - 1) * s_k + (C - 1) * s_c + P;
    if (s_p != 1 || P % kSumWarpPixels || s_c % 4 || s_k % 4 || s_c < 0 || s_k < 0 ||
        span > 0x7fffffffLL || !mdlt::aligned16(params) || !mdlt::aligned16(out))
      return cudaErrorInvalidValue;
    const int64_t n4 = total / 4;
    const int64_t per_block = static_cast<int64_t>(kThreads) * kSumGroups;  // groups
    const dim3 grid(static_cast<unsigned>((n4 + per_block - 1) / per_block));
    channel_sum_vec4_kernel<<<grid, dim3(kThreads), 0, s>>>(
        p, o, static_cast<int>(P / 4), static_cast<int>(n4), static_cast<int>(C),
        static_cast<int>(s_k / 4), static_cast<int>(s_c / 4));
    return cudaGetLastError();
  }
  const size_t bytes = mdlt::read_smem_bytes(static_cast<int>(C), sizeof(float), kSumPixels);
  if (!mdlt::channel_minor_dense(K, 1, 1, P, C, s_k, 0, 0, s_p, s_c) ||
      !mdlt::aligned16(params) || bytes > kMaxSharedBytes)
    return cudaErrorInvalidValue;
  // the walk reads no image: its pixels are the rows, [K, 1, 1, P]
  return mdlt::launch_persistent(channel_sum_tiled_kernel, bytes, total,
                                 mdlt::kTilePixels * kSumPixels, s,
                                 mdlt::ReadOperands<float>{nullptr, p, o, static_cast<int>(C), K,
                                                           1, 1, P, 0, 0, 0, 0});
}

// The arguments of mdl_log_prob_forward, `tiled` among them (1 = the read
// walk, for dense channel-minor params on a 16-byte aligned address,
// cudaErrorInvalidValue for any other; 0 = the direct path): x float32
// [B, H, W, 3] view, params float32 or bf16 [K, B, H, W, 10 * n_mix] view,
// out contiguous float32 [K, B, H, W].
extern "C" int mdl_null_forward(
    const void* x, const void* params, void* out, int params_bf16, int n_mix, int tiled,
    int64_t K, int64_t B, int64_t H, int64_t W,
    int64_t xs_b, int64_t xs_h, int64_t xs_w, int64_t xs_c,
    int64_t ps_k, int64_t ps_b, int64_t ps_h, int64_t ps_w, int64_t ps_c,
    void* stream) {
  if (n_mix < 1 || n_mix > kMaxMix) return cudaErrorInvalidValue;
  if (K * B * H * W <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (params_bf16) {
    return launch_null_forward(tiled, 10 * n_mix, s, xf,
                               static_cast<const __nv_bfloat16*>(params), o, K, B, H, W,
                               xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c);
  }
  return launch_null_forward(tiled, 10 * n_mix, s, xf, static_cast<const float*>(params), o,
                             K, B, H, W, xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c);
}

// The arguments of mdl_log_prob_backward, `tiled` among them (1 = the tile
// path, for dense channel-minor params and dparams on 16-byte aligned
// addresses, cudaErrorInvalidValue for any other; 0 = the direct path): g
// float32 [K, B, H, W] view (zero strides allowed), dparams in the params'
// dtype, written through its own strides.
extern "C" int mdl_null_backward(
    const void* x, const void* params, const void* g, void* dparams, int params_bf16,
    int n_mix, int tiled, int64_t K, int64_t B, int64_t H, int64_t W,
    int64_t xs_b, int64_t xs_h, int64_t xs_w, int64_t xs_c,
    int64_t ps_k, int64_t ps_b, int64_t ps_h, int64_t ps_w, int64_t ps_c,
    int64_t gs_k, int64_t gs_b, int64_t gs_h, int64_t gs_w,
    int64_t ds_k, int64_t ds_b, int64_t ds_h, int64_t ds_w, int64_t ds_c,
    void* stream) {
  if (n_mix < 1 || n_mix > kMaxMix) return cudaErrorInvalidValue;
  const int64_t total = K * B * H * W;
  if (total <= 0) return cudaSuccess;
  const int C = 10 * n_mix;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  if (tiled) {
    if (!mdlt::channel_minor_dense(K, B, H, W, C, ps_k, ps_b, ps_h, ps_w, ps_c) ||
        !mdlt::channel_minor_dense(K, B, H, W, C, ds_k, ds_b, ds_h, ds_w, ds_c) ||
        !mdlt::aligned16(params) || !mdlt::aligned16(dparams))
      return cudaErrorInvalidValue;
    if (params_bf16) {
      return mdlt::launch<__nv_bfloat16>(
          mdl_null_backward_tiled_kernel<__nv_bfloat16>, false, s,
          {xf, static_cast<const __nv_bfloat16*>(params), gf,
           static_cast<__nv_bfloat16*>(dparams), C, K, B, H, W, xs_b, xs_h, xs_w, xs_c,
           gs_k, gs_b, gs_h, gs_w});
    }
    return mdlt::launch<float>(
        mdl_null_backward_tiled_kernel<float>, false, s,
        {xf, static_cast<const float*>(params), gf, static_cast<float*>(dparams), C, K, B, H, W,
         xs_b, xs_h, xs_w, xs_c, gs_k, gs_b, gs_h, gs_w});
  }
  const dim3 grid = mdla::grid_for(total);
  if (params_bf16) {
    return launch_null_backward(grid, s, xf, static_cast<const __nv_bfloat16*>(params), gf,
                                static_cast<__nv_bfloat16*>(dparams), C, K, B, H, W,
                                xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c,
                                gs_k, gs_b, gs_h, gs_w, ds_k, ds_b, ds_h, ds_w, ds_c);
  }
  return launch_null_backward(grid, s, xf, static_cast<const float*>(params), gf,
                              static_cast<float*>(dparams), C, K, B, H, W,
                              xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c,
                              gs_k, gs_b, gs_h, gs_w, ds_k, ds_b, ds_h, ds_w, ds_c);
}

// Blocks an SM of the current device holds of mdl_null_forward's (backward =
// 0) or mdl_null_backward's tile path for this dtype and mixture count (what
// sizes its grid); 0 for a count out of range.
extern "C" int mdl_null_tile_blocks_per_sm(int params_bf16, int n_mix, int backward) {
  if (n_mix < 1 || n_mix > kMaxMix) return 0;
  const int C = 10 * n_mix;
  if (backward) {
    return params_bf16
               ? mdlt::blocks_per_sm(mdl_null_backward_tiled_kernel<__nv_bfloat16>, C, false)
               : mdlt::blocks_per_sm(mdl_null_backward_tiled_kernel<float>, C, false);
  }
  return params_bf16 ? mdlt::blocks_per_sm(mdl_null_forward_tiled_kernel<__nv_bfloat16>, C)
                     : mdlt::blocks_per_sm(mdl_null_forward_tiled_kernel<float>, C);
}

// Blocks an SM of the current device holds of channel_sum's read walk at C
// channels, as the occupancy query sizes its grid; 0 where it is refused.
extern "C" int channel_sum_tile_blocks_per_sm(int C) {
  if (C < 1) return 0;
  return mdlt::blocks_per_sm(reinterpret_cast<const void*>(channel_sum_tiled_kernel),
                             mdlt::read_smem_bytes(C, sizeof(float), kSumPixels));
}
