// Mixture-of-discretized-logistics (MoDL) log-prob, forward and backward,
// CUDA C++ for sm_90a.
//
// mdl_log_prob_forward replaces the four forward layouts of the Pallas kernel
// in vae_mdl_tpu/ops/pallas/mdl_kernel.py: _forward (standard), _forward_bl
// (batch lanes, bf16), _forward_bl_split (f32 as two u16 halves) and
// _forward_bl_kgrid (lane-tiled eval). mdl_log_prob_backward replaces their
// four backwards: _backward_params, _backward_params_bl,
// _backward_params_bl_split and _backward_params_bl_kgrid. Those layouts
// answer the TPU's custom-call and 128-lane constraints; here one kernel of
// each direction reads the head conv's output where it lies, through the
// strides it is given, in f32 or bf16.
//
// What bounds them on an H100 (numbers from chip_smoke.py's runs, PERF.md):
// per pixel the forward runs 3 * n_mix discretized-logistic cascades (15 at
// n_mix = 5), each an exp, two sigmoids and a log or a softplus, plus
// 3 * n_mix tanh and two logsumexps: about 90 accurate transcendentals on 10 *
// n_mix parameters. By the card's published peaks both kernels are bound by
// their bytes (at k = 5, B = 128, 32 x 32, f32 the backward moves 265 MB,
// 0.08 ms at 3.35 TB/s; the special-function units need a third of that),
// but the first versions were far from it: the backward took 0.6 ms, for it
// evaluated every cascade twice, held 130 registers a thread, and in the
// channel-minor layout the model hands on, a thread stored its pixel's 50
// gradients 200 bytes from its neighbour's; the forward read its row the same
// way and reached 38% of its bound at the eval chunk, its memory and math
// adding up instead of overlapping.
//
// Design.
// - Two memory paths for each direction, chosen by the caller (0 direct, 1
//   tiled); asked for the tile path on operands that do not fit it, an entry
//   point returns cudaErrorInvalidValue. Nothing tries one path after the
//   other, and both paths of a direction run one body, so they give the same
//   bits.
// - The direct path: one thread per (k, b, h, w) pixel, a grid-stride loop
//   over all of them (mdl_addressing.cuh, which the null-body probes of
//   io_probe.cu share). Parameters, the cotangent and the gradient are read
//   and written through their own element strides, so any view needs no
//   copy; in the NCHW layout (channel stride H*W) neighbouring threads are on
//   neighbouring addresses. It is the path of NCHW, sliced and misaligned
//   views.
// - The tile path (mdl_tile.cuh; dense channel-minor parameters, and
//   gradient, 16-byte aligned: what the model's head hands on): 128 pixels a
//   tile, persistent blocks, the tile brought into shared memory by one bulk
//   asynchronous copy on an mbarrier. The forward reads its row there and
//   stores one float a pixel; the backward writes the gradient over the
//   consumed parameters and sends the tile back by one bulk store. Every
//   byte of the parameters moves in whole lines, where the direct path's
//   threads read their rows 200 bytes apart in this layout. A block holds
//   one buffer: the math is bound by latency, and eight blocks of four warps
//   an SM (25,600 B a block in f32, at most 64 registers a thread; the bf16
//   forward twelve) hide more of it than more buffers a block did, each of
//   which halves the blocks an SM, or than a tile a warp (measured,
//   PERF.md). Where the data sends a warp's cascades down different branches
//   the forward is held by its math on either path; on the model's own head
//   output the tile path takes a fifth off the f32 forward.
// - The forward's body (pixel_log_prob) is the mixture weights and the outer
//   logsumexp, read through a channel stride: the tile path calls it on its
//   shared-memory row at stride 1, the direct path through the parameters'
//   strides.
// - The backward's body (fused_backward) is one sweep over the mixtures that
//   evaluates each cascade once for its value and both derivatives
//   (dl_cascade.cuh dl_value_and_grads), keeps the mixture's log weight in a
//   register and parks its nine unscaled terms (three d loc, three d
//   logscale, three 1 - tanh^2) and exp(logit - max) in the ten slots the
//   mixture's gradient will take; then the weights' softmax (n_mix exp, the
//   only transcendentals left) and a second sweep that scales the parked
//   terms by g * softmax(w). Where the park lies: a float32 row parks in
//   place (the tile in shared memory; on the direct path the gradient row
//   itself, through its strides); a bf16 row would round an unscaled term,
//   so bf16 parks in a float32 scratch row beside the tile, or in registers
//   on the direct path, and rounds once. The clamp masks (ls_raw > -7) ride
//   in one register as bits.
// - x is broadcast over k by indexing with b only, never materialised; a
//   cotangent expanded with zero strides is read as it is.
// - All math in f32 for both input types, following the plain versions
//   (distributions/mixture.py mixture_log_prob for the forward,
//   ops/cuda/mdl_kernel.py mdl_backward_plain for the backward) branch for
//   branch, built without fast math and with -fmad=false so every multiply
//   and add rounds as the plain versions' elementwise ops do; the 1e-5 and
//   1e-12 thresholds then see the same values. The fused backward keeps every
//   product and sum in the order of the first version's two passes (value,
//   then derivatives), so it gives that version's bits.
// - The backward takes the Pallas kernel's tie rules: the logscale gradient
//   is masked by ls_raw > -7 (0 at the tie) and the CDF-difference floor
//   passes no gradient at diff <= 1e-12.
// - The mixture count is a template parameter (1..10), so the per-mix
//   weights live in registers.
//
// Each C entry point returns cudaGetLastError() after the launch.

#include "dl_cascade.cuh"
#include "mdl_addressing.cuh"
#include "mdl_tile.cuh"

namespace {

using dlc::load;
using dlc::store;
using mdla::grid_for;
using mdla::kThreads;

constexpr int kMaxMix = 10;
constexpr float kHalfBin = 0.003921568859368563f;   // float32(1/255): half of the 2/255 bin
constexpr float kLogBinWidth = -4.848116364598481f;  // log(2/255)

// The MoDL's bins: 256 levels on [-1, 1]. The cascade and its derivative are
// the shared device functions of dl_cascade.cuh with these constants.
__device__ __forceinline__ dlc::Bin modl_bin() { return {-1.0f, 1.0f, kHalfBin, kLogBinWidth}; }

__device__ __forceinline__ float dl_log_prob(float x, float loc, float logscale) {
  return dlc::dl_log_prob(x, loc, logscale, modl_bin());
}

// One pixel's log-prob, log sum_m exp(w[m]) with w[m] = log softmax(logits)[m]
// + the three sub-pixel log-probs of mixture m. pp: its first parameter,
// ps_c: the channel stride, channel layout
// [logits 0:N | R loc,ls,cf N:4N | G 4N:7N | B 7N:10N]; x on [-1, 1].
template <typename T, int N>
__device__ __forceinline__ float pixel_log_prob(const T* pp, int64_t ps_c, float xr, float xg,
                                                float xb) {
  float logit[N], wt[N];
  float lmax = -CUDART_INF_F;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    logit[m] = load(pp + m * ps_c);
    lmax = fmaxf(lmax, logit[m]);
  }
  float lsum = 0.0f;
#pragma unroll
  for (int m = 0; m < N; ++m) lsum += expf(logit[m] - lmax);
  const float log_norm = logf(lsum) + lmax;

  float wmax = -CUDART_INF_F;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const float loc_r = load(pp + (N + m) * ps_c);
    const float ls_r = fmaxf(load(pp + (2 * N + m) * ps_c), -7.0f);
    const float cf_r = tanhf(load(pp + (3 * N + m) * ps_c));
    const float ls_g = fmaxf(load(pp + (5 * N + m) * ps_c), -7.0f);
    const float cf_g = tanhf(load(pp + (6 * N + m) * ps_c));
    const float ls_b = fmaxf(load(pp + (8 * N + m) * ps_c), -7.0f);
    const float cf_b = tanhf(load(pp + (9 * N + m) * ps_c));
    // channel autoregression on the observed red and green values
    const float loc_g = load(pp + (4 * N + m) * ps_c) + cf_r * xr;
    const float loc_b = load(pp + (7 * N + m) * ps_c) + cf_g * xr + cf_b * xg;
    const float lp = dl_log_prob(xr, loc_r, ls_r) + dl_log_prob(xg, loc_g, ls_g) +
                     dl_log_prob(xb, loc_b, ls_b);
    wt[m] = lp + (logit[m] - log_norm);
    wmax = fmaxf(wmax, wt[m]);
  }
  float wsum = 0.0f;
#pragma unroll
  for (int m = 0; m < N; ++m) wsum += expf(wt[m] - wmax);
  return logf(wsum) + wmax;
}

template <typename T, int N>
__global__ void mdl_log_prob_kernel(
    const float* __restrict__ x, const T* __restrict__ p, float* __restrict__ out,
    int64_t K, int64_t B, int64_t H, int64_t W,
    int64_t xs_b, int64_t xs_h, int64_t xs_w, int64_t xs_c,
    int64_t ps_k, int64_t ps_b, int64_t ps_h, int64_t ps_w, int64_t ps_c) {
  const int64_t total = K * B * H * W;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const mdla::Pixel px = mdla::pixel_of(i, B, H, W);
    const float* xp = x + mdla::image_offset(px, xs_b, xs_h, xs_w);
    const float xr = xp[0] * 2.0f - 1.0f;
    const float xg = xp[xs_c] * 2.0f - 1.0f;
    const float xb = xp[2 * xs_c] * 2.0f - 1.0f;
    out[i] = pixel_log_prob<T, N>(p + mdla::sample_offset(px, ps_k, ps_b, ps_h, ps_w), ps_c,
                                  xr, xg, xb);
  }
}

// The forward's tile-path body: the pixel's row in shared memory, x as
// stored, its one value stored at `out`.
template <typename T, int N>
struct TileForward {
  __device__ __forceinline__ void operator()(const T* row, float x0, float x1, float x2,
                                             float* out) const {
    *out = pixel_log_prob<T, N>(row, 1, x0 * 2.0f - 1.0f, x1 * 2.0f - 1.0f, x2 * 2.0f - 1.0f);
  }
};

// Blocks of 128 threads an SM is to hold: in f32 at n_mix = 5 its shared
// memory fits eight (at most 64 registers a thread); a bf16 tile is half the
// size, and twelve blocks (at most 42 registers) hid more of the math's
// latency than ten (measured, PERF.md).
template <typename T>
constexpr int kForwardBlocks = sizeof(T) < sizeof(float) ? 12 : 8;

template <typename T, int N>
__global__ void __launch_bounds__(mdlt::kTilePixels, kForwardBlocks<T>)
    mdl_log_prob_kernel_tiled(const mdlt::ReadOperands<T> a) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  mdlt::for_each_tile_read<T>(a, tile_smem, TileForward<T, N>());
}

// A float32 park through a channel stride: the tile's row or scratch row
// (stride 1), or the direct path's gradient row.
struct StridedPark {
  float* p;
  int64_t s;
  __device__ __forceinline__ float& operator[](int c) const { return p[c * s]; }
};

// One pixel's gradient, scaled by its cotangent gv, with s = softmax(w) over
// mixtures and gw = g * s (the logsumexp pullback):
//   d logits = g * (s - softmax(logits))
//   d loc_c  = gw * dL_c                 (the autoregression is additive)
//   d ls_c   = gw * dS_c * [ls_raw > -7] (clamp mask)
//   d cf_r   = gw * dL_g * x_r * (1 - tanh(cf_r)^2)
//   d cf_g   = gw * dL_b * x_r * (1 - tanh(cf_g)^2)
//   d cf_b   = gw * dL_b * x_g * (1 - tanh(cf_b)^2)
// Parameters are read from pp at channel stride ps_c, the gradient written to
// dpp at ds_c (on the tile path the same row), float32 intermediates parked
// in `park` by channel index; x on [-1, 1].
template <typename T, int N, typename Park>
__device__ __forceinline__ void fused_backward(const T* pp, int64_t ps_c, T* dpp, int64_t ds_c,
                                               Park& park, float xr, float xg, float xb,
                                               float gv) {
  float logit[N], wt[N];
  float lmax = -CUDART_INF_F;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    logit[m] = load(pp + m * ps_c);
    lmax = fmaxf(lmax, logit[m]);
  }
  float lsum = 0.0f;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const float e = expf(logit[m] - lmax);
    lsum += e;
    park[m] = e;
  }
  const float log_norm = logf(lsum) + lmax;

  // sweep 1: each mixture's three cascades once, value and derivatives
  float wmax = -CUDART_INF_F;
  uint32_t unclamped = 0;  // bit 3 m + c: raw logscale of mixture m, channel c above -7
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const float loc_r = load(pp + (N + m) * ps_c);
    const float ls_r_raw = load(pp + (2 * N + m) * ps_c);
    const float cf_r = tanhf(load(pp + (3 * N + m) * ps_c));
    const float ls_g_raw = load(pp + (5 * N + m) * ps_c);
    const float cf_g = tanhf(load(pp + (6 * N + m) * ps_c));
    const float ls_b_raw = load(pp + (8 * N + m) * ps_c);
    const float cf_b = tanhf(load(pp + (9 * N + m) * ps_c));
    // channel autoregression on the observed red and green values
    const float loc_g = load(pp + (4 * N + m) * ps_c) + cf_r * xr;
    const float loc_b = load(pp + (7 * N + m) * ps_c) + cf_g * xr + cf_b * xg;
    const dlc::DLValueGrad r =
        dlc::dl_value_and_grads(xr, loc_r, fmaxf(ls_r_raw, -7.0f), modl_bin());
    const dlc::DLValueGrad g =
        dlc::dl_value_and_grads(xg, loc_g, fmaxf(ls_g_raw, -7.0f), modl_bin());
    const dlc::DLValueGrad b =
        dlc::dl_value_and_grads(xb, loc_b, fmaxf(ls_b_raw, -7.0f), modl_bin());
    const float lp = r.lp + g.lp + b.lp;
    wt[m] = lp + (logit[m] - log_norm);
    wmax = fmaxf(wmax, wt[m]);
    unclamped |= (ls_r_raw > -7.0f ? 1u : 0u) << (3 * m);
    unclamped |= (ls_g_raw > -7.0f ? 1u : 0u) << (3 * m + 1);
    unclamped |= (ls_b_raw > -7.0f ? 1u : 0u) << (3 * m + 2);
    park[N + m] = r.d_loc;
    park[2 * N + m] = r.d_ls;
    park[3 * N + m] = 1.0f - cf_r * cf_r;
    park[4 * N + m] = g.d_loc;
    park[5 * N + m] = g.d_ls;
    park[6 * N + m] = 1.0f - cf_g * cf_g;
    park[7 * N + m] = b.d_loc;
    park[8 * N + m] = b.d_ls;
    park[9 * N + m] = 1.0f - cf_b * cf_b;
  }
  // a park in memory is read back from there, not kept in registers
  asm volatile("" ::: "memory");

  float wsum = 0.0f;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    wt[m] = expf(wt[m] - wmax);
    wsum += wt[m];
  }

  // sweep 2: scale by the logsumexp's pullback; no transcendental left
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const float s = wt[m] / wsum;
    const float gw = gv * s;
    const float gl_r = gw * park[N + m];
    const float gl_g = gw * park[4 * N + m];
    const float gl_b = gw * park[7 * N + m];
    const float d_logit = gv * (s - park[m] / lsum);
    const float ds_r = (unclamped >> (3 * m)) & 1u ? gw * park[2 * N + m] : 0.0f;
    const float ds_g = (unclamped >> (3 * m + 1)) & 1u ? gw * park[5 * N + m] : 0.0f;
    const float ds_b = (unclamped >> (3 * m + 2)) & 1u ? gw * park[8 * N + m] : 0.0f;
    const float dc_r = gl_g * xr * park[3 * N + m];
    const float dc_g = gl_b * xr * park[6 * N + m];
    const float dc_b = gl_b * xg * park[9 * N + m];
    store(dpp + m * ds_c, d_logit);
    store(dpp + (N + m) * ds_c, gl_r);
    store(dpp + (2 * N + m) * ds_c, ds_r);
    store(dpp + (3 * N + m) * ds_c, dc_r);
    store(dpp + (4 * N + m) * ds_c, gl_g);
    store(dpp + (5 * N + m) * ds_c, ds_g);
    store(dpp + (6 * N + m) * ds_c, dc_g);
    store(dpp + (7 * N + m) * ds_c, gl_b);
    store(dpp + (8 * N + m) * ds_c, ds_b);
    store(dpp + (9 * N + m) * ds_c, dc_b);
  }
}

// bf16 rows park their float32 terms apart: in a scratch row beside the
// tile, in registers on the direct path
template <typename T>
constexpr bool kNeedsScratch = sizeof(T) < sizeof(float);

template <typename T, int N>
__global__ void mdl_log_prob_backward_kernel(
    const float* __restrict__ x, const T* __restrict__ p, const float* __restrict__ g,
    T* __restrict__ dp, int64_t K, int64_t B, int64_t H, int64_t W,
    int64_t xs_b, int64_t xs_h, int64_t xs_w, int64_t xs_c,
    int64_t ps_k, int64_t ps_b, int64_t ps_h, int64_t ps_w, int64_t ps_c,
    int64_t gs_k, int64_t gs_b, int64_t gs_h, int64_t gs_w,
    int64_t ds_k, int64_t ds_b, int64_t ds_h, int64_t ds_w, int64_t ds_c) {
  const int64_t total = K * B * H * W;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const mdla::Pixel px = mdla::pixel_of(i, B, H, W);
    const float* xp = x + mdla::image_offset(px, xs_b, xs_h, xs_w);
    const float xr = xp[0] * 2.0f - 1.0f;
    const float xg = xp[xs_c] * 2.0f - 1.0f;
    const float xb = xp[2 * xs_c] * 2.0f - 1.0f;
    const T* pp = p + mdla::sample_offset(px, ps_k, ps_b, ps_h, ps_w);
    T* dpp = dp + mdla::sample_offset(px, ds_k, ds_b, ds_h, ds_w);
    const float gv = g[mdla::sample_offset(px, gs_k, gs_b, gs_h, gs_w)];
    if constexpr (kNeedsScratch<T>) {
      float park[10 * N];
      fused_backward<T, N>(pp, ps_c, dpp, ds_c, park, xr, xg, xb, gv);
    } else {
      StridedPark park{dpp, ds_c};
      fused_backward<T, N>(pp, ps_c, dpp, ds_c, park, xr, xg, xb, gv);
    }
  }
}

// The backward's tile-path body: the gradient written over the pixel's
// parameters in its shared-memory row; a float32 row parks in place, a bf16
// one in its scratch row.
template <typename T, int N>
struct TileBackward {
  __device__ __forceinline__ void operator()(T* row, float* scratch, float x0, float x1,
                                             float x2, float gv) const {
    StridedPark park{park_of(row, scratch), 1};
    fused_backward<T, N>(row, 1, row, 1, park, x0 * 2.0f - 1.0f, x1 * 2.0f - 1.0f,
                         x2 * 2.0f - 1.0f, gv);
  }

  static __device__ __forceinline__ float* park_of(float* row, float*) { return row; }
  static __device__ __forceinline__ float* park_of(__nv_bfloat16*, float* scratch) {
    return scratch;
  }
};

// Eight blocks of 128 threads fit an SM's shared memory in f32 at n_mix = 5:
// at most 64 registers a thread.
template <typename T, int N>
__global__ void __launch_bounds__(mdlt::kTilePixels, 8)
    mdl_log_prob_backward_kernel_tiled(const mdlt::Operands<T> a) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  mdlt::for_each_tile<T, kNeedsScratch<T>>(a, tile_smem, TileBackward<T, N>());
}

#define MDL_SWITCH(CASE)                                      \
  switch (n_mix) {                                            \
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5)                   \
    CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)                  \
    default:                                                  \
      return cudaErrorInvalidValue;                           \
  }

template <typename T>
cudaError_t launch(int n_mix, dim3 grid, dim3 block, cudaStream_t stream,
                   const float* x, const T* p, float* out,
                   int64_t K, int64_t B, int64_t H, int64_t W,
                   int64_t xs_b, int64_t xs_h, int64_t xs_w, int64_t xs_c,
                   int64_t ps_k, int64_t ps_b, int64_t ps_h, int64_t ps_w, int64_t ps_c) {
#define MDL_CASE(NN)                                                              \
  case NN:                                                                        \
    mdl_log_prob_kernel<T, NN><<<grid, block, 0, stream>>>(                       \
        x, p, out, K, B, H, W, xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c); \
    break;
  MDL_SWITCH(MDL_CASE)
#undef MDL_CASE
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tiled(int n_mix, cudaStream_t stream, const mdlt::ReadOperands<T>& a) {
#define MDL_CASE(NN) \
  case NN:           \
    return mdlt::launch(mdl_log_prob_kernel_tiled<T, NN>, stream, a);
  MDL_SWITCH(MDL_CASE)
#undef MDL_CASE
}

template <typename T>
cudaError_t launch_backward(int n_mix, dim3 grid, dim3 block, cudaStream_t stream,
                            const float* x, const T* p, const float* g, T* dp,
                            int64_t K, int64_t B, int64_t H, int64_t W,
                            int64_t xs_b, int64_t xs_h, int64_t xs_w, int64_t xs_c,
                            int64_t ps_k, int64_t ps_b, int64_t ps_h, int64_t ps_w,
                            int64_t ps_c, int64_t gs_k, int64_t gs_b, int64_t gs_h,
                            int64_t gs_w, int64_t ds_k, int64_t ds_b, int64_t ds_h,
                            int64_t ds_w, int64_t ds_c) {
#define MDL_CASE(NN)                                                                  \
  case NN:                                                                            \
    mdl_log_prob_backward_kernel<T, NN><<<grid, block, 0, stream>>>(                  \
        x, p, g, dp, K, B, H, W, xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c, \
        gs_k, gs_b, gs_h, gs_w, ds_k, ds_b, ds_h, ds_w, ds_c);                        \
    break;
  MDL_SWITCH(MDL_CASE)
#undef MDL_CASE
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward_tiled(int n_mix, cudaStream_t stream, const mdlt::Operands<T>& a) {
#define MDL_CASE(NN) \
  case NN:           \
    return mdlt::launch(mdl_log_prob_backward_kernel_tiled<T, NN>, kNeedsScratch<T>, stream, a);
  MDL_SWITCH(MDL_CASE)
#undef MDL_CASE
}

// n_mix in 1..kMaxMix
template <typename T>
int tiled_blocks_per_sm(int n_mix) {
#define MDL_CASE(NN) \
  case NN:           \
    return mdlt::blocks_per_sm(mdl_log_prob_kernel_tiled<T, NN>, 10 * NN);
  MDL_SWITCH(MDL_CASE)
#undef MDL_CASE
}

// n_mix in 1..kMaxMix
template <typename T>
int backward_tiled_blocks_per_sm(int n_mix) {
#define MDL_CASE(NN)                                                               \
  case NN:                                                                         \
    return mdlt::blocks_per_sm(mdl_log_prob_backward_kernel_tiled<T, NN>, 10 * NN, \
                               kNeedsScratch<T>);
  MDL_SWITCH(MDL_CASE)
#undef MDL_CASE
}

#undef MDL_SWITCH

}  // namespace

// x: float32 [B, H, W, 3] view; params: float32 (params_bf16 == 0) or bf16
// [K, B, H, W, 10 * n_mix] view; out: contiguous float32 [K, B, H, W].
// Strides are in elements. tiled = 1 asks for the tile path (mdl_tile.cuh),
// which takes dense channel-minor params on a 16-byte aligned address and
// returns cudaErrorInvalidValue for any other; tiled = 0 is the direct path,
// for any strides. Returns a cudaError_t (0 = launched).
extern "C" int mdl_log_prob_forward(
    const void* x, const void* params, void* out, int params_bf16, int n_mix, int tiled,
    int64_t K, int64_t B, int64_t H, int64_t W,
    int64_t xs_b, int64_t xs_h, int64_t xs_w, int64_t xs_c,
    int64_t ps_k, int64_t ps_b, int64_t ps_h, int64_t ps_w, int64_t ps_c,
    void* stream) {
  if (n_mix < 1 || n_mix > kMaxMix) return cudaErrorInvalidValue;
  const int64_t total = K * B * H * W;
  if (total <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (tiled) {
    const int64_t C = 10 * n_mix;
    if (!mdlt::channel_minor_dense(K, B, H, W, C, ps_k, ps_b, ps_h, ps_w, ps_c) ||
        !mdlt::aligned16(params))
      return cudaErrorInvalidValue;
    if (params_bf16) {
      return launch_tiled<__nv_bfloat16>(
          n_mix, s,
          {xf, static_cast<const __nv_bfloat16*>(params), o, static_cast<int>(C), K, B, H, W,
           xs_b, xs_h, xs_w, xs_c});
    }
    return launch_tiled<float>(
        n_mix, s,
        {xf, static_cast<const float*>(params), o, static_cast<int>(C), K, B, H, W,
         xs_b, xs_h, xs_w, xs_c});
  }
  const dim3 grid = grid_for(total);
  const dim3 block(kThreads);
  if (params_bf16) {
    return launch(n_mix, grid, block, s, xf, static_cast<const __nv_bfloat16*>(params), o,
                  K, B, H, W, xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c);
  }
  return launch(n_mix, grid, block, s, xf, static_cast<const float*>(params), o,
                K, B, H, W, xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c);
}

// Blocks an SM of the current device holds of mdl_log_prob_forward's tile
// path for this dtype and mixture count (what sizes its grid); 0 for a count
// out of range.
extern "C" int mdl_log_prob_forward_tile_blocks_per_sm(int params_bf16, int n_mix) {
  if (n_mix < 1 || n_mix > kMaxMix) return 0;
  return params_bf16 ? tiled_blocks_per_sm<__nv_bfloat16>(n_mix)
                     : tiled_blocks_per_sm<float>(n_mix);
}

// The same for mdl_log_prob_backward's tile path.
extern "C" int mdl_log_prob_backward_tile_blocks_per_sm(int params_bf16, int n_mix) {
  if (n_mix < 1 || n_mix > kMaxMix) return 0;
  return params_bf16 ? backward_tiled_blocks_per_sm<__nv_bfloat16>(n_mix)
                     : backward_tiled_blocks_per_sm<float>(n_mix);
}

// d out / d params, scaled by the cotangent g: x and params as for the
// forward; g: float32 [K, B, H, W] view (zero strides allowed); dparams: the
// params' dtype, [K, B, H, W, 10 * n_mix] view, written through its own
// strides. tiled = 1 asks for the tile path (mdl_tile.cuh), which takes dense
// channel-minor params and dparams on 16-byte aligned addresses and returns
// cudaErrorInvalidValue for any other; tiled = 0 is the direct path, for any
// strides. Returns a cudaError_t (0 = launched).
extern "C" int mdl_log_prob_backward(
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
  const dim3 grid = grid_for(total);
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  if (tiled) {
    const int64_t C = 10 * n_mix;
    if (!mdlt::channel_minor_dense(K, B, H, W, C, ps_k, ps_b, ps_h, ps_w, ps_c) ||
        !mdlt::channel_minor_dense(K, B, H, W, C, ds_k, ds_b, ds_h, ds_w, ds_c) ||
        !mdlt::aligned16(params) || !mdlt::aligned16(dparams))
      return cudaErrorInvalidValue;
    if (params_bf16) {
      return launch_backward_tiled<__nv_bfloat16>(
          n_mix, s,
          {xf, static_cast<const __nv_bfloat16*>(params), gf,
           static_cast<__nv_bfloat16*>(dparams), static_cast<int>(C), K, B, H, W,
           xs_b, xs_h, xs_w, xs_c, gs_k, gs_b, gs_h, gs_w});
    }
    return launch_backward_tiled<float>(
        n_mix, s,
        {xf, static_cast<const float*>(params), gf, static_cast<float*>(dparams),
         static_cast<int>(C), K, B, H, W, xs_b, xs_h, xs_w, xs_c, gs_k, gs_b, gs_h, gs_w});
  }
  if (params_bf16) {
    return launch_backward(n_mix, grid, block, s, xf,
                           static_cast<const __nv_bfloat16*>(params), gf,
                           static_cast<__nv_bfloat16*>(dparams), K, B, H, W,
                           xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c,
                           gs_k, gs_b, gs_h, gs_w, ds_k, ds_b, ds_h, ds_w, ds_c);
  }
  return launch_backward(n_mix, grid, block, s, xf, static_cast<const float*>(params), gf,
                         static_cast<float*>(dparams), K, B, H, W,
                         xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c,
                         gs_k, gs_b, gs_h, gs_w, ds_k, ds_b, ds_h, ds_w, ds_c);
}
