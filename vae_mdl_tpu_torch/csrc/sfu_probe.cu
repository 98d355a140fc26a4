// Special-function throughput probe, CUDA C++ for sm_90a.
//
// sfu_probe replaces the Pallas loop kernel _loop_probe of
// vae_mdl_tpu/ops/pallas/vpu_probe.py: one op applied `iters` times to every
// element in a loop-carried chain, the result written out so the chain is
// live. The ops are the very device functions the MoDL and the
// discretized-logistic kernels call, built with their flags (no fast math,
// -fmad=false): expf, logf, tanhf, dl_cascade.cuh's sigmoid and softplus, and
// the whole cascade dlc::dl_log_prob(v, 0.9 v, 0.1 v) on the MoDL's bins as
// one op. Two launches at two loop depths give a rate, extra evaluations over
// extra time, in which the launch and the reads and writes cancel.
//
// What bounds it on an H100: nothing but the math. A launch reads and writes
// 4 bytes per element once and evaluates the op `iters` times in registers.
// The special-function units give 16 results per clock per SM (compute
// capability 9.0), the float32 pipes 128; an accurate expf is one MUFU.EX2 and
// a handful of float32 instructions, a sigmoid or a tanhf two MUFUs and an
// accurate division.
//
// Design. The TPU probe's resident (16, 2048) tile has no meaning here; the
// geometry is the MoDL kernels': 256 threads a block, values in registers,
// and as many blocks as the caller asks for (the k = 5, B = 128 launch has
// 2560). One dependent chain a thread would measure the op's latency, so a
// thread carries CHAINS independent chains (a template parameter, 1..16,
// unrolled): element j of thread t is in[t + j * threads], so loads and
// stores coalesce. After each op the value goes through v * scale + shift
// (a multiply and an add, not fused), both kernel arguments: with 1 and 0
// the launch computes op^iters exactly, as the TPU kernel does; other values
// keep the operand in the normal range, where exp -> inf and log -> nan
// would take the accurate functions' slow paths. The op `none` is that
// multiply and add alone: the time to subtract. The loop over iters is not
// unrolled, so the SASS of one kernel shows the instructions of CHAINS
// evaluations once.
//
// The C entry point returns cudaGetLastError() after the launch.

#include "dl_cascade.cuh"
#include "mdl_addressing.cuh"

namespace {

enum Op { kNone = 0, kExp, kLog, kTanh, kSigmoid, kSoftplus, kCascade, kOpCount };

constexpr float kHalfBin = 0.003921568859368563f;   // float32(1/255), as mdl_log_prob.cu
constexpr float kLogBinWidth = -4.848116364598481f;  // log(2/255)

template <int OP>
__device__ __forceinline__ float apply(float v) {
  if (OP == kExp) return expf(v);
  if (OP == kLog) return logf(v);
  if (OP == kTanh) return tanhf(v);
  if (OP == kSigmoid) return dlc::sigmoid(v);
  if (OP == kSoftplus) return dlc::softplus(v);
  if (OP == kCascade) {
    const dlc::Bin bin{-1.0f, 1.0f, kHalfBin, kLogBinWidth};
    return dlc::dl_log_prob(v, 0.9f * v, 0.1f * v, bin);
  }
  return v;
}

template <int OP, int CHAINS>
__global__ void sfu_probe_kernel(const float* __restrict__ in, float* __restrict__ out,
                                 int iters, float scale, float shift) {
  const int64_t threads = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  float v[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) v[j] = in[t + j * threads];
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) v[j] = apply<OP>(v[j]) * scale + shift;
  }
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) out[t + j * threads] = v[j];
}

template <int OP>
cudaError_t launch_chains(int chains, dim3 grid, cudaStream_t s, const float* in, float* out,
                          int iters, float scale, float shift) {
  const dim3 block(mdla::kThreads);
#define SFU_CASE(CC)                                                                    \
  case CC:                                                                              \
    sfu_probe_kernel<OP, CC><<<grid, block, 0, s>>>(in, out, iters, scale, shift);      \
    break;
  switch (chains) {
    SFU_CASE(1) SFU_CASE(2) SFU_CASE(4) SFU_CASE(8) SFU_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef SFU_CASE
  return cudaGetLastError();
}

}  // namespace

// in, out: contiguous float32 of blocks * 256 * chains elements. op: 0 none,
// 1 exp, 2 log, 3 tanh, 4 sigmoid, 5 softplus, 6 the discretized-logistic
// cascade; chains: 1, 2, 4, 8 or 16. Returns a cudaError_t (0 = launched).
extern "C" int sfu_probe(const void* in, void* out, int op, int chains, int blocks, int iters,
                         float scale, float shift, void* stream) {
  if (blocks <= 0 || iters < 0) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* i = static_cast<const float*>(in);
  float* o = static_cast<float*>(out);
  switch (op) {
    case kNone: return launch_chains<kNone>(chains, grid, s, i, o, iters, scale, shift);
    case kExp: return launch_chains<kExp>(chains, grid, s, i, o, iters, scale, shift);
    case kLog: return launch_chains<kLog>(chains, grid, s, i, o, iters, scale, shift);
    case kTanh: return launch_chains<kTanh>(chains, grid, s, i, o, iters, scale, shift);
    case kSigmoid: return launch_chains<kSigmoid>(chains, grid, s, i, o, iters, scale, shift);
    case kSoftplus: return launch_chains<kSoftplus>(chains, grid, s, i, o, iters, scale, shift);
    case kCascade: return launch_chains<kCascade>(chains, grid, s, i, o, iters, scale, shift);
    default: return cudaErrorInvalidValue;
  }
}
