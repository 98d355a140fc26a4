// The discretized-logistic cascade and its derivative as device functions,
// shared by the MoDL kernels (mdl_log_prob.cu: bins of 2/255 on [-1, 1]) and
// the discretized-logistic kernels (dl_log_prob.cu: the bin is an argument).
//
// Both follow distributions/discretized.py discretized_logistic_log_prob
// branch for branch in f32. Every source that includes this is built without
// fast math and with -fmad=false, so each multiply and add rounds as the
// plain version's elementwise ops do and the 1e-5 and 1e-12 thresholds see
// the values the plain version sees.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace dlc {

// The bins: [low, high] cut into intervals of width 2 * half_bin, the edge
// bins x <= low and x >= high taking the tails; log_width = log(2 * half_bin).
// The plain version rounds its Python constants to f32 where they meet a
// tensor; the callers hand in those f32 values.
struct Bin {
  float low, high, half_bin, log_width;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// jax.nn.softplus's form: max(v, 0) + log1p(exp(-|v|))
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// log P(bin of x) under a logistic with this loc and logscale.
__device__ __forceinline__ float dl_log_prob(float x, float loc, float logscale, const Bin bin) {
  const float centered = x - loc;
  const float inv_std = expf(-logscale);
  const float start = (centered - bin.half_bin) * inv_std;
  const float stop = (centered + bin.half_bin) * inv_std;
  if (x >= bin.high) return -softplus(start);        // right edge bin
  if (x <= bin.low) return stop - softplus(stop);    // left edge bin
  const float prob = fmaxf(sigmoid(stop) - sigmoid(start), 1e-12f);
  if (prob > 1e-5f) return logf(prob);
  // the CDF difference underflows: PDF * bin width
  const float a = centered * inv_std;
  return -a - logscale - 2.0f * softplus(-a) + bin.log_width;
}

// d dl_log_prob / d (loc, logscale): _dl_grads of the Pallas MoDL kernel,
// branch for branch. The edge conditions compare x only, so they select but
// never differentiate; in the CDF-difference branch prob > 1e-5 implies the
// floor is not active.
struct DLGrad {
  float d_loc, d_ls;
};

__device__ __forceinline__ DLGrad dl_grads(float x, float loc, float logscale, const Bin bin) {
  const float inv_std = expf(-logscale);
  const float centered = x - loc;
  const float start = (centered - bin.half_bin) * inv_std;
  const float stop = (centered + bin.half_bin) * inv_std;
  if (x >= bin.high) {  // right edge bin: -softplus(start)
    const float ri = sigmoid(start);
    return {ri * inv_std, ri * start};
  }
  if (x <= bin.low) {  // left edge bin: stop - softplus(stop)
    const float le = sigmoid(-stop);
    return {-le * inv_std, -le * stop};
  }
  const float sg_stop = sigmoid(stop);
  const float sg_start = sigmoid(start);
  const float prob = fmaxf(sg_stop - sg_start, 1e-12f);
  if (prob > 1e-5f) {  // log(prob)
    const float ds = sg_stop * (1.0f - sg_stop) / prob;
    const float da = sg_start * (1.0f - sg_start) / prob;
    return {inv_std * (da - ds), da * start - ds * stop};
  }
  // PDF * bin width: -a - logscale - 2 softplus(-a) + log(width)
  const float a = centered * inv_std;
  const float c_ap = 2.0f * sigmoid(-a) - 1.0f;
  return {-c_ap * inv_std, -c_ap * a - 1.0f};
}

// dl_log_prob and dl_grads in one sweep: the value and both derivatives from
// the sub-expressions the two share (inv_std, start, stop, the two sigmoids,
// prob, a), each product and sum in the order the two functions above take
// it, so every field equals what they return, bit for bit. An edge bin costs
// an exp, a softplus and a sigmoid; the CDF-difference branch an exp, two
// sigmoids and a log; the PDF branch an exp, three sigmoids and a softplus.
struct DLValueGrad {
  float lp, d_loc, d_ls;
};

__device__ __forceinline__ DLValueGrad dl_value_and_grads(float x, float loc, float logscale,
                                                          const Bin bin) {
  const float centered = x - loc;
  const float inv_std = expf(-logscale);
  const float start = (centered - bin.half_bin) * inv_std;
  const float stop = (centered + bin.half_bin) * inv_std;
  if (x >= bin.high) {  // right edge bin
    const float ri = sigmoid(start);
    return {-softplus(start), ri * inv_std, ri * start};
  }
  if (x <= bin.low) {  // left edge bin
    const float le = sigmoid(-stop);
    return {stop - softplus(stop), -le * inv_std, -le * stop};
  }
  const float sg_stop = sigmoid(stop);
  const float sg_start = sigmoid(start);
  const float prob = fmaxf(sg_stop - sg_start, 1e-12f);
  if (prob > 1e-5f) {  // log(prob)
    const float ds = sg_stop * (1.0f - sg_stop) / prob;
    const float da = sg_start * (1.0f - sg_start) / prob;
    return {logf(prob), inv_std * (da - ds), da * start - ds * stop};
  }
  // the CDF difference underflows: PDF * bin width
  const float a = centered * inv_std;
  const float c_ap = 2.0f * sigmoid(-a) - 1.0f;
  return {-a - logscale - 2.0f * softplus(-a) + bin.log_width, -c_ap * inv_std,
          -c_ap * a - 1.0f};
}

}  // namespace dlc
