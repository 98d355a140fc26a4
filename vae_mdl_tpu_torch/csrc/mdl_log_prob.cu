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
// but the first version of the backward took 0.6 ms: it evaluated every
// cascade twice (once for the mixture weights, once for the derivatives), held
// 130 registers a thread (one block of 8 warps an SM to hide long chains of
// expf, divide and logf behind), and in the channel-minor layout the model
// hands on, a thread stored its pixel's 50 gradients 200 bytes from its
// neighbour's, 32 sectors a warp store for 128 useful bytes.
//
// Design.
// - Forward, and the backward's direct path: one thread per (k, b, h, w)
//   pixel, a grid-stride loop over all of them (mdl_addressing.cuh, which the
//   null-body probes of io_probe.cu share). Parameters, the cotangent and
//   the gradient are read and written through their own element strides, so
//   any view needs no copy; in the NCHW layout (channel stride H*W)
//   neighbouring threads are on neighbouring addresses. The direct backward
//   is the first version: the forward's weights, then every cascade again
//   for its derivative.
// - The backward's tile path (mdl_tile.cuh; dense channel-minor parameters
//   and gradient, 16-byte aligned: what the model's head hands on): 128
//   pixels a tile, persistent blocks, the tile brought into shared memory by
//   one bulk asynchronous copy on an mbarrier, the gradient written over the
//   consumed parameters there and sent back by one bulk store. Every byte of
//   device memory moves in whole lines. A block holds one buffer (load,
//   compute, store a tile at a time): the math is bound by latency, and
//   eight blocks of four warps an SM (25,600 B a block in f32, 59 registers
//   a thread) hide more of it than a second or third buffer did, which
//   halve the blocks an SM each (measured and dropped, PERF.md).
// - The tile path's math is fused: one sweep over the mixtures evaluates each
//   cascade once for its value and both derivatives (dl_cascade.cuh
//   dl_value_and_grads), keeps the mixture's log weight in a register and
//   parks its nine unscaled terms (three d loc, three d logscale, three
//   1 - tanh^2) and exp(logit - max) in the mixture's own ten slots of the
//   row; then the weights' softmax (n_mix exp, the only transcendentals left)
//   and a second sweep that scales the parked terms by g * softmax(w). A
//   float32 row parks in place; a bf16 row would round an unscaled term, so
//   bf16 parks in a float32 scratch row beside the tile and rounds once, as
//   the direct path does. The clamp masks (ls_raw > -7) ride in one register
//   as bits. Every product and sum keeps the direct path's order, so the two
//   paths give the same bits.
// - x is broadcast over k by indexing with b only, never materialised; a
//   cotangent expanded with zero strides is read as it is.
// - All math in f32 for both input types, following the plain versions
//   (distributions/mixture.py mixture_log_prob for the forward,
//   ops/cuda/mdl_kernel.py mdl_backward_plain for the backward) branch for
//   branch, built without fast math and with -fmad=false so every multiply
//   and add rounds as the plain versions' elementwise ops do; the 1e-5 and
//   1e-12 thresholds then see the same values.
// - The backward takes the Pallas kernel's tie rules: the logscale gradient
//   is masked by ls_raw > -7 (0 at the tie) and the CDF-difference floor
//   passes no gradient at diff <= 1e-12.
// - The mixture count is a template parameter (1..10), so the per-mix
//   weights live in registers.
// - The caller names the backward's path (0 direct, 1 tiled); asked for the
//   tile path on operands that do not fit it, the entry point returns
//   cudaErrorInvalidValue. Nothing tries one path after the other.
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

__device__ __forceinline__ dlc::DLGrad dl_grads(float x, float loc, float logscale) {
  return dlc::dl_grads(x, loc, logscale, modl_bin());
}

// The n_mix log weights of one pixel, w[m] = log softmax(logits)[m] + the
// three sub-pixel log-probs of mixture m, and the logits' max and
// sum of exp(logit - max). Channel layout of pp:
// [logits 0:N | R loc,ls,cf N:4N | G 4N:7N | B 7N:10N].
template <typename T, int N>
__device__ __forceinline__ void mix_weights(const T* pp, int64_t ps_c, float xr, float xg,
                                            float xb, float (&logit)[N], float& lmax,
                                            float& lsum, float (&wt)[N], float& wmax) {
  lmax = -CUDART_INF_F;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    logit[m] = load(pp + m * ps_c);
    lmax = fmaxf(lmax, logit[m]);
  }
  lsum = 0.0f;
#pragma unroll
  for (int m = 0; m < N; ++m) lsum += expf(logit[m] - lmax);
  const float log_norm = logf(lsum) + lmax;

  wmax = -CUDART_INF_F;
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

    const T* pp = p + mdla::sample_offset(px, ps_k, ps_b, ps_h, ps_w);
    float logit[N], wt[N];
    float lmax, lsum, wmax;
    mix_weights<T, N>(pp, ps_c, xr, xg, xb, logit, lmax, lsum, wt, wmax);
    float wsum = 0.0f;
#pragma unroll
    for (int m = 0; m < N; ++m) wsum += expf(wt[m] - wmax);
    out[i] = logf(wsum) + wmax;
  }
}

// With s = softmax(w) over mixtures and gw = g * s (the logsumexp pullback):
//   d logits = g * (s - softmax(logits))
//   d loc_c  = gw * dL_c                 (the autoregression is additive)
//   d ls_c   = gw * dS_c * [ls_raw > -7] (clamp mask)
//   d cf_r   = gw * dL_g * x_r * (1 - tanh(cf_r)^2)
//   d cf_g   = gw * dL_b * x_r * (1 - tanh(cf_g)^2)
//   d cf_b   = gw * dL_b * x_g * (1 - tanh(cf_b)^2)
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

    // pass 1: the forward's weights
    float logit[N], wt[N];
    float lmax, lsum, wmax;
    mix_weights<T, N>(pp, ps_c, xr, xg, xb, logit, lmax, lsum, wt, wmax);
    float wsum = 0.0f;
#pragma unroll
    for (int m = 0; m < N; ++m) wsum += expf(wt[m] - wmax);

    // pass 2: each mixture's cascades again, now with their derivatives
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const float s = expf(wt[m] - wmax) / wsum;
      const float gw = gv * s;
      store(dpp + m * ds_c, gv * (s - expf(logit[m] - lmax) / lsum));

      const float ls_r_raw = load(pp + (2 * N + m) * ps_c);
      const float ls_g_raw = load(pp + (5 * N + m) * ps_c);
      const float ls_b_raw = load(pp + (8 * N + m) * ps_c);
      const float cf_r = tanhf(load(pp + (3 * N + m) * ps_c));
      const float cf_g = tanhf(load(pp + (6 * N + m) * ps_c));
      const float cf_b = tanhf(load(pp + (9 * N + m) * ps_c));
      const float loc_r = load(pp + (N + m) * ps_c);
      const float loc_g = load(pp + (4 * N + m) * ps_c) + cf_r * xr;
      const float loc_b = load(pp + (7 * N + m) * ps_c) + cf_g * xr + cf_b * xg;
      const dlc::DLGrad dr = dl_grads(xr, loc_r, fmaxf(ls_r_raw, -7.0f));
      const dlc::DLGrad dg = dl_grads(xg, loc_g, fmaxf(ls_g_raw, -7.0f));
      const dlc::DLGrad db = dl_grads(xb, loc_b, fmaxf(ls_b_raw, -7.0f));
      const float gl_r = gw * dr.d_loc;
      const float gl_g = gw * dg.d_loc;
      const float gl_b = gw * db.d_loc;

      store(dpp + (N + m) * ds_c, gl_r);
      store(dpp + (2 * N + m) * ds_c, ls_r_raw > -7.0f ? gw * dr.d_ls : 0.0f);
      store(dpp + (3 * N + m) * ds_c, gl_g * xr * (1.0f - cf_r * cf_r));
      store(dpp + (4 * N + m) * ds_c, gl_g);
      store(dpp + (5 * N + m) * ds_c, ls_g_raw > -7.0f ? gw * dg.d_ls : 0.0f);
      store(dpp + (6 * N + m) * ds_c, gl_b * xr * (1.0f - cf_g * cf_g));
      store(dpp + (7 * N + m) * ds_c, gl_b);
      store(dpp + (8 * N + m) * ds_c, ls_b_raw > -7.0f ? gw * db.d_ls : 0.0f);
      store(dpp + (9 * N + m) * ds_c, gl_b * xg * (1.0f - cf_b * cf_b));
    }
  }
}

// The tile path's body: one pixel's gradient, written over its parameters
// in the shared-memory row. `park` holds float32 intermediates by channel
// index: the row itself where it is float32, a scratch row where it is bf16.
template <typename T, int N>
struct FusedBackward {
  __device__ __forceinline__ void operator()(T* row, float* scratch, float x0, float x1,
                                             float x2, float gv) const {
    const float xr = x0 * 2.0f - 1.0f;
    const float xg = x1 * 2.0f - 1.0f;
    const float xb = x2 * 2.0f - 1.0f;
    float* park = park_of(row, scratch);

    float logit[N], wt[N];
    float lmax = -CUDART_INF_F;
#pragma unroll
    for (int m = 0; m < N; ++m) {
      logit[m] = load(row + m);
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
      const float loc_r = load(row + (N + m));
      const float ls_r_raw = load(row + (2 * N + m));
      const float cf_r = tanhf(load(row + (3 * N + m)));
      const float ls_g_raw = load(row + (5 * N + m));
      const float cf_g = tanhf(load(row + (6 * N + m)));
      const float ls_b_raw = load(row + (8 * N + m));
      const float cf_b = tanhf(load(row + (9 * N + m)));
      // channel autoregression on the observed red and green values
      const float loc_g = load(row + (4 * N + m)) + cf_r * xr;
      const float loc_b = load(row + (7 * N + m)) + cf_g * xr + cf_b * xg;
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
    // the parked terms are read back from shared memory, not kept in registers
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
      store(row + m, d_logit);
      store(row + (N + m), gl_r);
      store(row + (2 * N + m), ds_r);
      store(row + (3 * N + m), dc_r);
      store(row + (4 * N + m), gl_g);
      store(row + (5 * N + m), ds_g);
      store(row + (6 * N + m), dc_g);
      store(row + (7 * N + m), gl_b);
      store(row + (8 * N + m), ds_b);
      store(row + (9 * N + m), dc_b);
    }
  }

  static __device__ __forceinline__ float* park_of(float* row, float*) { return row; }
  static __device__ __forceinline__ float* park_of(__nv_bfloat16*, float* scratch) {
    return scratch;
  }
};

// bf16 rows park their float32 terms in a scratch row
template <typename T>
constexpr bool kNeedsScratch = sizeof(T) < sizeof(float);

// Eight blocks of 128 threads fit an SM's shared memory in f32 at n_mix = 5:
// at most 64 registers a thread.
template <typename T, int N>
__global__ void __launch_bounds__(mdlt::kTilePixels, 8)
    mdl_log_prob_backward_kernel_tiled(const mdlt::Operands<T> a) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  mdlt::for_each_tile<T, kNeedsScratch<T>>(a, tile_smem, FusedBackward<T, N>());
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
// Strides are in elements. Returns a cudaError_t (0 = launched).
extern "C" int mdl_log_prob_forward(
    const void* x, const void* params, void* out, int params_bf16, int n_mix,
    int64_t K, int64_t B, int64_t H, int64_t W,
    int64_t xs_b, int64_t xs_h, int64_t xs_w, int64_t xs_c,
    int64_t ps_k, int64_t ps_b, int64_t ps_h, int64_t ps_w, int64_t ps_c,
    void* stream) {
  if (n_mix < 1 || n_mix > kMaxMix) return cudaErrorInvalidValue;
  const int64_t total = K * B * H * W;
  if (total <= 0) return cudaSuccess;
  const dim3 grid = grid_for(total);
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (params_bf16) {
    return launch(n_mix, grid, block, s, xf, static_cast<const __nv_bfloat16*>(params), o,
                  K, B, H, W, xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c);
  }
  return launch(n_mix, grid, block, s, xf, static_cast<const float*>(params), o,
                K, B, H, W, xs_b, xs_h, xs_w, xs_c, ps_k, ps_b, ps_h, ps_w, ps_c);
}

// Blocks an SM of the current device holds of mdl_log_prob_backward's tile
// path for this dtype and mixture count (what sizes its grid); 0 for a count
// out of range.
extern "C" int mdl_log_prob_backward_tile_blocks_per_sm(int params_bf16, int n_mix) {
  if (n_mix < 1 || n_mix > kMaxMix) return 0;
  return params_bf16 ? tiled_blocks_per_sm<__nv_bfloat16>(n_mix)
                     : tiled_blocks_per_sm<float>(n_mix);
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
