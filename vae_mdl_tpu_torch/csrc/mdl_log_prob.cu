// Mixture-of-discretized-logistics (MoDL) log-prob forward, CUDA C++ for sm_90a.
//
// Replaces the four forward layouts of the Pallas kernel in
// vae_mdl_tpu/ops/pallas/mdl_kernel.py: _forward (standard), _forward_bl
// (batch lanes, bf16), _forward_bl_split (f32 as two u16 halves) and
// _forward_bl_kgrid (lane-tiled eval). Those layouts answer the TPU's
// custom-call and 128-lane constraints; here one kernel reads the head
// conv's output where it lies, through the strides it is given, in f32 or
// bf16.
//
// What bounds it on an H100: per pixel it runs 3 * n_mix discretized-
// logistic cascades (15 at n_mix = 5), each an exp, two sigmoids and a log
// or a softplus, plus 3 * n_mix tanh and two logsumexps: about 90 accurate
// transcendentals. It reads 10 * n_mix parameters per pixel: at the 5000-IS
// eval size (a k-chunk of 100 samples x 128 images of 32x32) that is 2.6 GB
// in f32 per chunk (1.3 GB in bf16). On an H100 SXM at 700 W, f32 and bf16
// parameters take the same ~2.1 ms per such chunk (1.25 TB/s in f32, well
// under the 3.35 TB/s peak), so the transcendental math bounds it, not the
// read.
//
// Design, first version (right before fast):
// - one thread per (k, b, h, w) pixel, a grid-stride loop over all of them;
// - x is broadcast over k by indexing with b only, never materialised;
// - parameters are read through five element strides, so the NHWC-contiguous
//   view and the NCHW conv output (channel stride H*W, neighbouring threads on
//   neighbouring addresses) both need no copy;
// - all math in f32 for both input types, following the plain version
//   (distributions/mixture.py mixture_log_prob) branch for branch, built
//   without fast math and with -fmad=false so every multiply and add rounds
//   as the plain version's elementwise ops do; the 1e-5 and 1e-12
//   thresholds then see the same values;
// - the mixture count is a template parameter (1..10), so the per-mix
//   weights live in registers.
//
// The C entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxMix = 10;
constexpr float kHalfBin = 0.003921568859368563f;   // float32(1/255): half of the 2/255 bin
constexpr float kLogBinWidth = -4.848116364598481f;  // log(2/255)

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// jax.nn.softplus's form: max(v, 0) + log1p(exp(-|v|))
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// log P(bin of x) under a logistic with this loc and (clamped) logscale, on
// [-1, 1] with 256 bins: distributions/discretized.py, branch for branch.
__device__ __forceinline__ float dl_log_prob(float x, float loc, float logscale) {
  const float centered = x - loc;
  const float inv_std = expf(-logscale);
  const float start = (centered - kHalfBin) * inv_std;
  const float stop = (centered + kHalfBin) * inv_std;
  if (x >= 1.0f) return -softplus(start);         // right edge bin
  if (x <= -1.0f) return stop - softplus(stop);   // left edge bin
  const float prob = fmaxf(sigmoid(stop) - sigmoid(start), 1e-12f);
  if (prob > 1e-5f) return logf(prob);
  // the CDF difference underflows: PDF * bin width
  const float a = centered * inv_std;
  return -a - logscale - 2.0f * softplus(-a) + kLogBinWidth;
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
    int64_t r = i;
    const int64_t w = r % W;
    r /= W;
    const int64_t h = r % H;
    r /= H;
    const int64_t b = r % B;
    const int64_t k = r / B;

    const float* xp = x + b * xs_b + h * xs_h + w * xs_w;
    const float xr = xp[0] * 2.0f - 1.0f;
    const float xg = xp[xs_c] * 2.0f - 1.0f;
    const float xb = xp[2 * xs_c] * 2.0f - 1.0f;

    // channel layout: [logits 0:N | R loc,ls,cf N:4N | G 4N:7N | B 7N:10N]
    const T* pp = p + k * ps_k + b * ps_b + h * ps_h + w * ps_w;
    float logit[N];
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

    float wt[N];
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
    out[i] = logf(wsum) + wmax;
  }
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
  switch (n_mix) {
    MDL_CASE(1) MDL_CASE(2) MDL_CASE(3) MDL_CASE(4) MDL_CASE(5)
    MDL_CASE(6) MDL_CASE(7) MDL_CASE(8) MDL_CASE(9) MDL_CASE(10)
    default:
      return cudaErrorInvalidValue;
  }
#undef MDL_CASE
  return cudaGetLastError();
}

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
  constexpr int kThreads = 256;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(blocks < (1LL << 30) ? blocks : (1LL << 30)));
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
