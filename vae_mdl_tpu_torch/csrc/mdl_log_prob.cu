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
// What bounds them on an H100: per pixel the forward runs 3 * n_mix
// discretized-logistic cascades (15 at n_mix = 5), each an exp, two sigmoids
// and a log or a softplus, plus 3 * n_mix tanh and two logsumexps: about 90
// accurate transcendentals. It reads 10 * n_mix parameters per pixel: at the
// 5000-IS eval size (a k-chunk of 100 samples x 128 images of 32x32) that is
// 2.6 GB in f32 per chunk (1.3 GB in bf16). On an H100 SXM at 700 W, f32 and
// bf16 parameters take the same ~2.1 ms per such chunk (1.25 TB/s in f32,
// well under the 3.35 TB/s peak), so the transcendental math bounds it, not
// the read. The backward recomputes the forward's weights, then every
// cascade's derivative (the same transcendentals again), reads the
// parameters twice (the second time mostly from L1/L2) and writes as many
// gradients: about twice the forward's math and, in f32, 131 MB of
// gradients per train step at k = 5, B = 128.
//
// Design, first version (right before fast):
// - one thread per (k, b, h, w) pixel, a grid-stride loop over all of them
//   (mdl_addressing.cuh, which the null-body probes of io_probe.cu share);
// - x is broadcast over k by indexing with b only, never materialised;
// - parameters, the cotangent and the gradient are read and written through
//   their own element strides, so the NHWC-contiguous view and the NCHW conv
//   output (channel stride H*W, neighbouring threads on neighbouring
//   addresses) both need no copy, and a cotangent expanded with zero strides
//   is read as it is;
// - all math in f32 for both input types, following the plain versions
//   (distributions/mixture.py mixture_log_prob for the forward,
//   ops/cuda/mdl_kernel.py mdl_backward_plain for the backward) branch for
//   branch, built without fast math and with -fmad=false so every multiply
//   and add rounds as the plain versions' elementwise ops do; the 1e-5 and
//   1e-12 thresholds then see the same values;
// - the backward takes the Pallas kernel's tie rules: the logscale gradient
//   is masked by ls_raw > -7 (0 at the tie) and the CDF-difference floor
//   passes no gradient at diff <= 1e-12;
// - the mixture count is a template parameter (1..10), so the per-mix
//   weights live in registers; the backward's second pass reloads each
//   mixture's parameters instead of keeping all 10 * n_mix live.
//
// Each C entry point returns cudaGetLastError() after the launch.

#include "dl_cascade.cuh"
#include "mdl_addressing.cuh"

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

// d out / d params, scaled by the cotangent g: x and params as for the
// forward; g: float32 [K, B, H, W] view (zero strides allowed); dparams: the
// params' dtype, [K, B, H, W, 10 * n_mix] view, written through its own
// strides. Returns a cudaError_t (0 = launched).
extern "C" int mdl_log_prob_backward(
    const void* x, const void* params, const void* g, void* dparams, int params_bf16,
    int n_mix, int64_t K, int64_t B, int64_t H, int64_t W,
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
