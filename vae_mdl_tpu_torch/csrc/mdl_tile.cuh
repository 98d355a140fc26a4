// The tile path of the likelihood kernels (the MoDL pair, the discretized-
// logistic pair), of the null-body twins of the MoDL pair and of the channel
// sum: a block's tile of pixels travels device memory -> shared memory (->
// device memory, for a gradient) as whole runs of bytes, moved by Hopper's
// bulk asynchronous copies. Shared by mdl_log_prob.cu and dl_log_prob.cu
// (their forward and gradient math as bodies) and io_probe.cu (the null
// bodies and the channel sum's), so they have one memory path by
// construction: for_each_tile, which writes the body's result over the tile
// and stores it, and for_each_tile_read, its read-only sibling for the
// forwards and the sum, which stores kOut floats a pixel (1 for the MoDL,
// whose value is the pixel's, and for the sums; 3 for the discretized
// logistic, one a channel). With kImage false the read walk reads rows
// alone: no image, no pixel coordinates (the channel sum).
//
// When it applies. Parameters (and the gradient) are dense and channel-minor
// over [K, B, H, W, C] (s_c = 1, s_w = C, s_h = W C, s_b = H W C,
// s_k = B H W C; a dimension of one element may have any stride) and both
// base pointers are 16-byte aligned: a tile's consecutive pixels are then
// one run of bytes (128 pixels: 25,600 B at C = 50 in f32, 12,800 B in bf16;
// 3,072 B for the discretized logistic's 6-channel row). `channel_minor_dense`
// and `aligned16` are that test; the wrappers make the same one in Python
// (ops/cuda/mdl_kernel.py and ops/cuda/dl_kernel.py forward_path,
// backward_path) and pass their choice in, and a C entry point asked for the
// tile path on operands that do not fit returns cudaErrorInvalidValue. Every
// other layout takes the direct path.
//
// Design.
// - Persistent blocks: as many as the card holds at once (what
//   cudaOccupancyMaxActiveBlocksPerMultiprocessor allows on each SM, times
//   the SMs; at most one a tile), block b taking tiles b, b + blocks, ...
// - One thread a pixel, kTilePixels = 128 threads a block: a thread works
//   out its pixel's index once, reads its image values once, and walks its
//   pixel's row of C values in shared memory; for_each_tile writes the
//   gradient over the parameters it has consumed, so one buffer is input and
//   output tile (25,600 B at C = 50 in f32). A bulk copy cannot pad rows, so
//   in f32 the row stride is C words: 50 words give a two-way bank conflict,
//   bf16's 25 none. The read-only walk may give a thread kPixels pixels of a
//   tile of 128 kPixels (pixel j 128 + thread, j < kPixels): the
//   discretized logistic's rows are so short (24 B) that its forward takes
//   two (dl_log_prob.cu); so does the channel sum (io_probe.cu, where one,
//   two and four measured within 0.5% of each other).
// - Loads: thread 0 starts cp.async.bulk (global -> shared, no tensor map)
//   for the whole tile, completing on the block's mbarrier. x and the
//   cotangent are small and read straight from device memory through their
//   strides (the cotangent may be expanded with zero strides; one value a
//   pixel, or with kChannelCotangent one a channel at stride gs_c) before
//   the wait.
// - Stores: every thread fences its shared-memory writes towards the async
//   proxy, the block synchronises, thread 0 starts one cp.async.bulk
//   (shared -> global) for the tile and commits it; before the next load it
//   waits until that store has read the buffer
//   (cp.async.bulk.wait_group.read).
// - One buffer a block: it loads, computes (and stores) a tile at a time,
//   and the SM's other blocks fill the gaps. That is the least shared memory
//   a block, so the most blocks an SM (eight in f32 at C = 50). A second and
//   a third buffer, with the next tile arriving while this one is computed,
//   were measured and lost in every case, for the MoDL backward and for the
//   forwards (MoDL and discretized logistic), which have no store to wait
//   for (PERF.md): the math is bound by latency and gains more from resident
//   warps than from overlap inside a block, and the null body does not care.
//   A tile a warp, each warp with its own buffer and barrier and no
//   block-wide synchronisation, lost to the block's tile in the forward too.
// - The read-only walk (the forwards, the null forward, the channel sum):
//   the same grid, residency, barrier and bulk load; no store to wait for. A thread computes its pixel's kOut
//   values from its row and writes them to out[pixel kOut ...] (consecutive
//   threads, consecutive runs of kOut floats); the block synchronises once
//   every thread has read its row, and the buffer takes the next tile.
// - The ragged last tile (fewer pixels than a tile, a run that need not be
//   a multiple of 16 bytes) is moved by the block's threads element by
//   element, in the order memory lies; threads past its end do nothing.
// - `kScratch` adds a float32 row a thread (odd stride: no bank conflict)
//   for a body that must hold float32 intermediates while its rows are bf16.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "mdl_addressing.cuh"

namespace mdlt {

constexpr int kTilePixels = 128;  // threads a block = pixels a tile at one pixel a thread

// Everything a tile-path kernel is given. Parameters and gradient need no
// strides here: they are dense and channel-minor.
template <typename T>
struct Operands {
  const float* x;
  const T* p;
  const float* g;
  T* dp;
  int C;
  int64_t K, B, H, W;
  int64_t xs_b, xs_h, xs_w, xs_c;
  int64_t gs_k, gs_b, gs_h, gs_w;
  int64_t gs_c;  // between a pixel's cotangents, where the body takes one a channel
};

// The same for the read-only walk: out is contiguous float32 [K, B, H, W, kOut].
template <typename T>
struct ReadOperands {
  const float* x;
  const T* p;
  float* out;
  int C;
  int64_t K, B, H, W;
  int64_t xs_b, xs_h, xs_w, xs_c;
};

// Whether [K, B, H, W, C] with these element strides is dense channel-minor.
inline bool channel_minor_dense(int64_t K, int64_t B, int64_t H, int64_t W, int64_t C,
                                int64_t s_k, int64_t s_b, int64_t s_h, int64_t s_w,
                                int64_t s_c) {
  return (C == 1 || s_c == 1) && (W == 1 || s_w == C) && (H == 1 || s_h == W * C) &&
         (B == 1 || s_b == H * W * C) && (K == 1 || s_k == B * H * W * C);
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// A scratch row's length in floats: C, made odd.
__host__ __device__ __forceinline__ int scratch_row(int C) { return C | 1; }

// Shared memory of a block: the tile (a multiple of 16 bytes), the float32
// scratch rows where the body asks for them (a multiple of 8), an 8-byte
// mbarrier.
inline size_t smem_bytes(int C, size_t element, bool scratch) {
  return kTilePixels * static_cast<size_t>(C) * element +
         (scratch ? kTilePixels * scratch_row(C) * sizeof(float) : 0) + 8;
}

// The read-only walk's: the tile of kTilePixels * pixels pixels and its
// mbarrier.
inline size_t read_smem_bytes(int C, size_t element, int pixels = 1) {
  return kTilePixels * static_cast<size_t>(pixels) * C * element + 8;
}

// What the current device holds of a kernel at once.
struct Residency {
  int blocks_per_sm;
  int sms;
};

// Opt `kernel` in to `smem` bytes of dynamic shared memory and the largest
// shared-memory carve-out, and ask how many of its blocks an SM holds. Asked
// once for each (kernel, shared memory, device) and kept, so that a launch
// costs one cudaGetDevice beside it. A refusal is returned, not kept, and
// taken off the runtime's last-error state.
inline cudaError_t residency(const void* kernel, size_t smem, Residency* out) {
  static std::mutex mutex;
  static std::map<std::tuple<const void*, size_t, int>, Residency> known;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    const std::lock_guard<std::mutex> lock(mutex);
    const auto key = std::make_tuple(kernel, smem, device);
    const auto found = known.find(key);
    if (found != known.end()) {
      *out = found->second;
      return cudaSuccess;
    }
    Residency r{0, 0};
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r.blocks_per_sm, kernel, kTilePixels,
                                                          smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess && r.blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
    if (err == cudaSuccess) {
      known.emplace(key, r);
      *out = r;
      return cudaSuccess;
    }
  }
  cudaGetLastError();
  return err;
}

// Launch a tile-path kernel with `smem` bytes of dynamic shared memory on
// its persistent grid, for `total` pixels in tiles of `tile`: the blocks the
// card holds at once, at most one a tile. `args` are the kernel's (one
// Operands<T> or ReadOperands<T>, and whatever its body needs beside).
template <typename... P, typename... A>
cudaError_t launch_persistent(void (*kernel)(P...), size_t smem, int64_t total, int tile,
                              cudaStream_t stream, const A&... args) {
  const int64_t n_tiles = (total + tile - 1) / tile;
  Residency r;
  const cudaError_t err = residency(reinterpret_cast<const void*>(kernel), smem, &r);
  if (err != cudaSuccess) return err;
  const int64_t resident = static_cast<int64_t>(r.blocks_per_sm) * r.sms;
  const unsigned blocks = static_cast<unsigned>(n_tiles < resident ? n_tiles : resident);
  kernel<<<dim3(blocks), dim3(kTilePixels), smem, stream>>>(args...);
  return cudaGetLastError();
}

// A kernel built on for_each_tile with this use of scratch rows, one pixel a
// thread.
template <typename T>
cudaError_t launch(void (*kernel)(Operands<T>), bool scratch, cudaStream_t stream,
                   const Operands<T>& a) {
  return launch_persistent(kernel, smem_bytes(a.C, sizeof(T), scratch), a.K * a.B * a.H * a.W,
                           kTilePixels, stream, a);
}

// A kernel built on for_each_tile_read, one pixel a thread.
template <typename T>
cudaError_t launch(void (*kernel)(ReadOperands<T>), cudaStream_t stream,
                   const ReadOperands<T>& a) {
  return launch_persistent(kernel, read_smem_bytes(a.C, sizeof(T)), a.K * a.B * a.H * a.W,
                           kTilePixels, stream, a);
}

// Blocks an SM of the current device holds of a tile-path kernel with `smem`
// bytes of dynamic shared memory, as its launches size their grid; 0 where
// the query is refused.
inline int blocks_per_sm(const void* kernel, size_t smem) {
  Residency r;
  return residency(kernel, smem, &r) == cudaSuccess ? r.blocks_per_sm : 0;
}

// The same for a for_each_tile kernel at width C ...
template <typename T>
int blocks_per_sm(void (*kernel)(Operands<T>), int C, bool scratch) {
  return blocks_per_sm(reinterpret_cast<const void*>(kernel), smem_bytes(C, sizeof(T), scratch));
}

// ... and for a for_each_tile_read one.
template <typename T>
int blocks_per_sm(void (*kernel)(ReadOperands<T>), int C) {
  return blocks_per_sm(reinterpret_cast<const void*>(kernel), read_smem_bytes(C, sizeof(T)));
}

// -- PTX: mbarrier and bulk asynchronous copies -----------------------------------

__device__ __forceinline__ uint32_t shared_address(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_address(bar)),
               "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of copy to come.
__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t address = shared_address(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(address), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device to
// shared memory; completes on the mbarrier.
__device__ __forceinline__ void bulk_load(void* dst_shared, const void* src_global,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(shared_address(dst_shared)),
      "l"(src_global), "r"(bytes), "r"(shared_address(bar))
      : "memory");
}

// The same from shared to device memory, as part of the thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst_global, const void* src_shared,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst_global),
               "r"(shared_address(src_shared)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until every committed store of this thread has read its shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before a later bulk store.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mdla::pixel_of with 32-bit divisions where the pixel count allows them.
__device__ __forceinline__ mdla::Pixel pixel_of(int64_t i, int64_t total, int64_t B, int64_t H,
                                                int64_t W) {
  if (total > 0x7fffffffLL) return mdla::pixel_of(i, B, H, W);
  uint32_t j = static_cast<uint32_t>(i);
  const uint32_t w = static_cast<uint32_t>(W), h = static_cast<uint32_t>(H),
                 b = static_cast<uint32_t>(B);
  mdla::Pixel px;
  px.w = j % w;
  j /= w;
  px.h = j % h;
  j /= h;
  px.b = j % b;
  px.k = j / b;
  return px;
}

// The block's loop over its tiles. For each pixel of a tile, its thread calls
//   body(row, scratch, x0, x1, x2, gv)             (one cotangent a pixel)
//   body(row, scratch, x0, x1, x2, g0, g1, g2)     (kChannelCotangent)
// with `row` the pixel's C parameters in shared memory, to be overwritten
// with its C gradients; `scratch` its float32 row (nullptr without
// kScratch); x0..x2 the pixel's image values as stored; gv or g0..g2 its
// cotangent, the latter at stride gs_c. `smem` is the kernel's dynamic
// shared memory, smem_bytes() long and 128-byte aligned.
template <typename T, bool kScratch, bool kChannelCotangent = false, typename Body>
__device__ __forceinline__ void for_each_tile(const Operands<T>& a, unsigned char* smem,
                                              Body body) {
  constexpr int kG = kChannelCotangent ? 3 : 1;
  const int C = a.C;
  const int tile_elements = kTilePixels * C;
  const uint32_t tile_bytes = static_cast<uint32_t>(tile_elements * sizeof(T));
  T* buffer = reinterpret_cast<T*>(smem);
  unsigned char* after = smem + tile_bytes;
  float* scratch = reinterpret_cast<float*>(after);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      after + (kScratch ? kTilePixels * scratch_row(C) * sizeof(float) : 0));

  const int64_t total = a.K * a.B * a.H * a.W;
  const int64_t n_tiles = (total + kTilePixels - 1) / kTilePixels;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbarrier_init(full, 1);
    fence_mbarrier_init();
  }
  __syncthreads();

  int it = 0;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int64_t first = tile * kTilePixels;
    const int n = static_cast<int>(total - first < kTilePixels ? total - first : kTilePixels);
    if (tid == 0) {
      // the last tile's store must have read the buffer
      bulk_wait_read();
      if (n == kTilePixels) {
        mbarrier_arrive_expect_tx(full, tile_bytes);
        bulk_load(buffer, a.p + first * C, tile_bytes, full);
      }
    }
    const bool mine = tid < n;
    float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f, g[kG];
#pragma unroll
    for (int c = 0; c < kG; ++c) g[c] = 0.0f;
    if (mine) {
      const mdla::Pixel px = pixel_of(first + tid, total, a.B, a.H, a.W);
      const float* xp = a.x + mdla::image_offset(px, a.xs_b, a.xs_h, a.xs_w);
      x0 = xp[0];
      x1 = xp[a.xs_c];
      x2 = xp[2 * a.xs_c];
      const float* gp = a.g + mdla::sample_offset(px, a.gs_k, a.gs_b, a.gs_h, a.gs_w);
#pragma unroll
      for (int c = 0; c < kG; ++c) g[c] = gp[c * a.gs_c];
    }
    if (n == kTilePixels) {
      mbarrier_wait(full, it & 1);
    } else {
      // the ragged tile, the last of all: thread 0 has waited for the store
      __syncthreads();
      const T* src = a.p + first * C;
      for (int e = tid; e < n * C; e += kTilePixels) buffer[e] = src[e];
      __syncthreads();
    }
    if (mine) {
      float* scr = kScratch ? scratch + tid * scratch_row(C) : nullptr;
      if constexpr (kChannelCotangent) {
        body(buffer + tid * C, scr, x0, x1, x2, g[0], g[1], g[2]);
      } else {
        body(buffer + tid * C, scr, x0, x1, x2, g[0]);
      }
    }
    fence_async_shared();
    __syncthreads();
    if (n == kTilePixels) {
      if (tid == 0) {
        bulk_store(a.dp + first * C, buffer, tile_bytes);
        bulk_commit();
      }
    } else {
      T* dst = a.dp + first * C;
      for (int e = tid; e < n * C; e += kTilePixels) dst[e] = buffer[e];
    }
  }
  if (tid == 0) bulk_wait_read();
}

// The read-only walk, over tiles of kTilePixels * kPixels pixels. For each
// pixel of a tile, its thread calls
//   body(row, x0, x1, x2, out)
// with `row` the pixel's C parameters in shared memory, x0..x2 its image
// values as stored (0 without kImage: a walk over rows alone reads no image
// and works out no pixel's coordinates) and `out` its kOut values' place in
// the dense output, which the body fills. `smem` is the kernel's dynamic
// shared memory, read_smem_bytes() long and 128-byte aligned.
template <typename T, int kOut = 1, int kPixels = 1, bool kImage = true, typename Body>
__device__ __forceinline__ void for_each_tile_read(const ReadOperands<T>& a, unsigned char* smem,
                                                   Body body) {
  constexpr int kTile = kTilePixels * kPixels;
  const int C = a.C;
  const uint32_t tile_bytes = static_cast<uint32_t>(kTile * C * sizeof(T));
  T* buffer = reinterpret_cast<T*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + tile_bytes);

  const int64_t total = a.K * a.B * a.H * a.W;
  const int64_t n_tiles = (total + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbarrier_init(full, 1);
    fence_mbarrier_init();
  }
  __syncthreads();

  int it = 0;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int64_t first = tile * kTile;
    const int n = static_cast<int>(total - first < kTile ? total - first : kTile);
    if (tid == 0 && n == kTile) {
      mbarrier_arrive_expect_tx(full, tile_bytes);
      bulk_load(buffer, a.p + first * C, tile_bytes, full);
    }
    float x[kPixels][3];
#pragma unroll
    for (int j = 0; j < kPixels; ++j) {
      const int i = j * kTilePixels + tid;
      x[j][0] = x[j][1] = x[j][2] = 0.0f;
      if (kImage && i < n) {
        const mdla::Pixel px = pixel_of(first + i, total, a.B, a.H, a.W);
        const float* xp = a.x + mdla::image_offset(px, a.xs_b, a.xs_h, a.xs_w);
        x[j][0] = xp[0];
        x[j][1] = xp[a.xs_c];
        x[j][2] = xp[2 * a.xs_c];
      }
    }
    if (n == kTile) {
      mbarrier_wait(full, it & 1);
    } else {
      // the ragged tile, the last of all: no copy is in flight into the buffer
      const T* src = a.p + first * C;
      for (int e = tid; e < n * C; e += kTilePixels) buffer[e] = src[e];
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kPixels; ++j) {
      const int i = j * kTilePixels + tid;
      if (i < n) body(buffer + i * C, x[j][0], x[j][1], x[j][2], a.out + (first + i) * kOut);
    }
    // every row read before the buffer takes another tile
    __syncthreads();
  }
}

}  // namespace mdlt
