// Discretized-logistic log-prob, forward and backward, CUDA C++ for sm_90a.
//
// dl_log_prob_forward replaces the Pallas kernel _forward (body _kernel) of
// vae_mdl_tpu/ops/pallas/dl_kernel.py: elementwise log P(bin(x)) over the
// broadcast of x, loc and logscale. dl_log_prob_backward replaces its _bwd,
// which is no kernel there: XLA fuses the jnp vjp into one pass, and eager
// PyTorch's autograd of the plain version is some forty launches, so here the
// cotangent times d/d(loc, logscale) is one launch too.
//
// What bounds them on an H100: the forward reads 8 bytes and writes 4 per
// element when x is broadcast over the samples (12 read when it is not), the
// backward reads the same plus the cotangent and writes 8; at the model's
// eval chunk (100 samples x 128 images of 32 x 32 x 3 = 39.3 M elements) that
// is 472 MB, 0.14 ms at 3.35 TB/s. Per element they run one exp, two
// sigmoids and a log or a softplus in accurate f32, about 6 transcendentals:
// at that size the math takes longer than the bytes.
//
// Design, first version (right before fast). The TPU kernel flattens, pads
// to (rows, 128) tiles and materialises every broadcast; none of that is
// carried over:
// - one thread per element of the broadcast shape, a grid-stride loop;
// - each input is read through its own element strides: x with stride 0
//   over the samples, loc and logscale as channel slices of the head conv's
//   NCHW output, the cotangent as the sum's backward expands it;
// - the wrapper orders the dimensions so that neighbouring threads walk
//   loc's smallest stride (W of the NCHW head, not C), merges dimensions
//   that all operands step through alike, and allocates the outputs dense in
//   that order, so a thread's linear index is its output offset;
// - the dimension count is a template parameter (1..6), so the index
//   arithmetic unrolls, and runs in 32 bits when every offset fits;
// - the cascade and its derivative are dl_cascade.cuh's device functions,
//   with the bin's low, high, half width and log width as arguments.
//
// Each C entry point returns cudaGetLastError() after the launch.

#include "dl_cascade.cuh"

namespace {

constexpr int kMaxDims = 6;
constexpr int kThreads = 256;

// Shape and element strides of the operands over the ordered, merged
// dimensions; the last dimension is the one neighbouring threads walk.
template <typename I>
struct Layout {
  I shape[kMaxDims];
  I x[kMaxDims], loc[kMaxDims], ls[kMaxDims], g[kMaxDims];
};

template <typename I>
struct Offsets {
  I x, loc, ls, g;
};

template <typename I, int NDIM>
__device__ __forceinline__ Offsets<I> offsets_of(I i, const Layout<I>& lay) {
  Offsets<I> o{0, 0, 0, 0};
#pragma unroll
  for (int d = NDIM - 1; d > 0; --d) {
    const I q = i / lay.shape[d];
    const I idx = i - q * lay.shape[d];
    i = q;
    o.x += idx * lay.x[d];
    o.loc += idx * lay.loc[d];
    o.ls += idx * lay.ls[d];
    o.g += idx * lay.g[d];
  }
  o.x += i * lay.x[0];
  o.loc += i * lay.loc[0];
  o.ls += i * lay.ls[0];
  o.g += i * lay.g[0];
  return o;
}

template <typename I, int NDIM>
__global__ void dl_log_prob_kernel(const float* __restrict__ x, const float* __restrict__ loc,
                                   const float* __restrict__ ls, float* __restrict__ out,
                                   I total, const Layout<I> lay, const dlc::Bin bin) {
  for (I i = blockIdx.x * (I)blockDim.x + threadIdx.x; i < total;
       i += (I)gridDim.x * blockDim.x) {
    const Offsets<I> o = offsets_of<I, NDIM>(i, lay);
    out[i] = dlc::dl_log_prob(x[o.x], loc[o.loc], ls[o.ls], bin);
  }
}

template <typename I, int NDIM>
__global__ void dl_log_prob_backward_kernel(
    const float* __restrict__ x, const float* __restrict__ loc, const float* __restrict__ ls,
    const float* __restrict__ g, float* __restrict__ d_loc, float* __restrict__ d_ls,
    I total, const Layout<I> lay, const dlc::Bin bin) {
  for (I i = blockIdx.x * (I)blockDim.x + threadIdx.x; i < total;
       i += (I)gridDim.x * blockDim.x) {
    const Offsets<I> o = offsets_of<I, NDIM>(i, lay);
    const float gv = g[o.g];
    const dlc::DLGrad d = dlc::dl_grads(x[o.x], loc[o.loc], ls[o.ls], bin);
    d_loc[i] = gv * d.d_loc;
    d_ls[i] = gv * d.d_ls;
  }
}

dim3 grid_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return dim3(static_cast<unsigned>(blocks < (1LL << 22) ? blocks : (1LL << 22)));
}

// Host-side description of one call; g_strides is null for the forward.
struct Call {
  int ndim;
  const int64_t *shape, *x_strides, *loc_strides, *ls_strides, *g_strides;
  int64_t total;
};

template <typename I>
Layout<I> layout_of(const Call& c) {
  Layout<I> lay{};
  for (int d = 0; d < c.ndim; ++d) {
    lay.shape[d] = static_cast<I>(c.shape[d]);
    lay.x[d] = static_cast<I>(c.x_strides[d]);
    lay.loc[d] = static_cast<I>(c.loc_strides[d]);
    lay.ls[d] = static_cast<I>(c.ls_strides[d]);
    lay.g[d] = c.g_strides ? static_cast<I>(c.g_strides[d]) : 0;
  }
  return lay;
}

// The farthest element offset an operand is read at.
int64_t reach(const Call& c, const int64_t* strides) {
  int64_t r = 0;
  if (strides) {
    for (int d = 0; d < c.ndim; ++d) r += (c.shape[d] - 1) * strides[d];
  }
  return r;
}

// All strides are non-negative (the wrapper checks); 32-bit indices when the
// element count and every operand's reach stay below 2^31.
bool fits_32(const Call& c) {
  const int64_t limit = 1LL << 31;
  return c.total < limit && reach(c, c.x_strides) < limit && reach(c, c.loc_strides) < limit &&
         reach(c, c.ls_strides) < limit && reach(c, c.g_strides) < limit;
}

bool valid(Call& c) {
  if (c.ndim < 1 || c.ndim > kMaxDims) return false;
  c.total = 1;
  for (int d = 0; d < c.ndim; ++d) {
    if (c.shape[d] < 0) return false;
    c.total *= c.shape[d];
  }
  return true;
}

#define DL_SWITCH(CASE)                              \
  switch (c.ndim) {                                  \
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6)  \
    default:                                         \
      return cudaErrorInvalidValue;                  \
  }

template <typename I>
cudaError_t launch(const Call& c, cudaStream_t stream, const float* x, const float* loc,
                   const float* ls, float* out, const dlc::Bin bin) {
  const Layout<I> lay = layout_of<I>(c);
  const dim3 grid = grid_for(c.total);
#define DL_CASE(ND)                                                                   \
  case ND:                                                                            \
    dl_log_prob_kernel<I, ND><<<grid, dim3(kThreads), 0, stream>>>(                   \
        x, loc, ls, out, static_cast<I>(c.total), lay, bin);                          \
    break;
  DL_SWITCH(DL_CASE)
#undef DL_CASE
  return cudaGetLastError();
}

template <typename I>
cudaError_t launch_backward(const Call& c, cudaStream_t stream, const float* x,
                            const float* loc, const float* ls, const float* g, float* d_loc,
                            float* d_ls, const dlc::Bin bin) {
  const Layout<I> lay = layout_of<I>(c);
  const dim3 grid = grid_for(c.total);
#define DL_CASE(ND)                                                                   \
  case ND:                                                                            \
    dl_log_prob_backward_kernel<I, ND><<<grid, dim3(kThreads), 0, stream>>>(          \
        x, loc, ls, g, d_loc, d_ls, static_cast<I>(c.total), lay, bin);               \
    break;
  DL_SWITCH(DL_CASE)
#undef DL_CASE
  return cudaGetLastError();
}

#undef DL_SWITCH

}  // namespace

// x, loc, logscale: float32, read at the element strides given for each of
// the ndim (1..6) dimensions of shape (host arrays; 0 strides broadcast);
// out: float32, dense over shape in the order given. half_bin and log_width
// are the f32 values of interval_width / 2 and log(interval_width). Returns
// a cudaError_t (0 = launched).
extern "C" int dl_log_prob_forward(
    const void* x, const void* loc, const void* logscale, void* out, int ndim,
    const int64_t* shape, const int64_t* x_strides, const int64_t* loc_strides,
    const int64_t* ls_strides, float low, float high, float half_bin, float log_width,
    void* stream) {
  Call c{ndim, shape, x_strides, loc_strides, ls_strides, nullptr, 0};
  if (!valid(c)) return cudaErrorInvalidValue;
  if (c.total == 0) return cudaSuccess;
  const dlc::Bin bin{low, high, half_bin, log_width};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* lf = static_cast<const float*>(loc);
  const float* sf = static_cast<const float*>(logscale);
  float* o = static_cast<float*>(out);
  if (fits_32(c)) return launch<uint32_t>(c, s, xf, lf, sf, o, bin);
  return launch<int64_t>(c, s, xf, lf, sf, o, bin);
}

// g * d out / d (loc, logscale) at every element of shape: inputs as for the
// forward, g the float32 cotangent read through g_strides; d_loc and d_ls
// float32, dense over shape in the order given. Returns a cudaError_t.
extern "C" int dl_log_prob_backward(
    const void* x, const void* loc, const void* logscale, const void* g, void* d_loc,
    void* d_ls, int ndim, const int64_t* shape, const int64_t* x_strides,
    const int64_t* loc_strides, const int64_t* ls_strides, const int64_t* g_strides,
    float low, float high, float half_bin, float log_width, void* stream) {
  Call c{ndim, shape, x_strides, loc_strides, ls_strides, g_strides, 0};
  if (!valid(c)) return cudaErrorInvalidValue;
  if (c.total == 0) return cudaSuccess;
  const dlc::Bin bin{low, high, half_bin, log_width};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* lf = static_cast<const float*>(loc);
  const float* sf = static_cast<const float*>(logscale);
  const float* gf = static_cast<const float*>(g);
  float* dl = static_cast<float*>(d_loc);
  float* ds = static_cast<float*>(d_ls);
  if (fits_32(c)) return launch_backward<uint32_t>(c, s, xf, lf, sf, gf, dl, ds, bin);
  return launch_backward<int64_t>(c, s, xf, lf, sf, gf, dl, ds, bin);
}
