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
// sigmoids and a log or a softplus in accurate f32, about 6 transcendentals,
// which the special-function units take in a third of that time: the bytes
// bound them.
//
// Where the operands lie. The model's head is a channels-last conv output,
// [K, B, H, W, 6] dense with the channel fastest; loc and logscale are its
// two halves (channels 0-2 and 3-5), views with strides [.., 6, 1], and x is
// [B, H, W, 3], broadcast over K. Each direction has two memory paths, chosen
// by the caller (ops/cuda/dl_kernel.py forward_path, backward_path) and
// passed in: no entry point tries one after the other.
// - The tile path (mdl_tile.cuh, the walk the MoDL kernels take) for
//   exactly that layout: loc and logscale the two halves of one dense
//   channel-minor float32 head with C = 3 (logscale 3 floats after loc), on
//   a 16-byte aligned address, x broadcast over K. A tile of the head's rows
//   (24 bytes a pixel) comes into shared memory by one bulk asynchronous
//   copy; a thread works out each of its pixels' index once, reads the
//   pixel's three x values once, and runs the three channels' cascades on
//   its row. The forward stores the pixel's three values into the dense
//   output [K, B, H, W, 3] (consecutive threads, consecutive 12-byte runs);
//   the backward writes (g d_loc, g d_ls) over the row it has consumed,
//   which is the head's own gradient [K, B, H, W, 6], and one bulk store
//   puts the tile into device memory: the caller gets the head's gradient
//   in one piece, with no concatenation of two halves after it. The cotangent is read
//   through its own strides, one value a channel (in the model the event
//   sum's expansion of [K, B, 1, 1, 1]). The rows are short (128 pixels are
//   3 KB), so the forward's threads walk two pixels each, a tile of 256
//   pixels a block; the backward walks one. Both run at the occupancy the
//   card reports (16 and 12 blocks of 128 threads an SM). Of the tiles timed
//   in turns on model03's own head (1, 2, 4 and 8 pixels a thread; one or
//   two buffers a block for the forward; the backward at 32 registers for
//   16 blocks), these won; PERF.md keeps the losers' times. More pixels a
//   thread hold more registers, and a second buffer hid the copies no
//   better than the SM's other blocks do. Asked for the tile path on
//   operands that do not fit, an entry point returns cudaErrorInvalidValue.
// - The direct path for any other layout (contiguous operands, NCHW halves,
//   a sliced or misaligned head, a logscale that went through tanh, x not
//   broadcast over K, any rank): one thread per element of the broadcast
//   shape, a grid-stride loop, each input read through its own element
//   strides; the wrapper orders the dimensions so that neighbouring threads
//   walk loc's smallest stride (the channel of a channels-last head, W of an
//   NCHW one), merges dimensions that all operands step through alike, and
//   allocates the outputs dense in that order, so a thread's linear index is
//   its output offset; the dimension count is a template parameter (1..6),
//   so the index arithmetic unrolls, and runs in 32 bits when every offset
//   fits. On the channels-last halves that costs two runtime div/mod pairs
//   an element, each pixel's x read once a channel, and each sector of the
//   head fetched by two load instructions (loc's half, then logscale's).
// - Both paths call the same device functions of dl_cascade.cuh, with the
//   bin's low, high, half width and log width as arguments, built without
//   fast math and with -fmad=false: they give the same bits.
//
// Each C entry point returns cudaGetLastError() after the launch.

#include "dl_cascade.cuh"
#include "mdl_tile.cuh"

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

// -- the tile path -------------------------------------------------------------

constexpr int kChannels = 3;            // loc's and logscale's channels
constexpr int kRow = 2 * kChannels;     // the head's row: loc, then logscale
constexpr int kForwardPixels = 2;       // the forward's pixels a thread

// The forward's body: the pixel's three values from its row.
struct TileForward {
  dlc::Bin bin;
  __device__ __forceinline__ void operator()(const float* row, float x0, float x1, float x2,
                                             float* out) const {
    out[0] = dlc::dl_log_prob(x0, row[0], row[kChannels], bin);
    out[1] = dlc::dl_log_prob(x1, row[1], row[kChannels + 1], bin);
    out[2] = dlc::dl_log_prob(x2, row[2], row[kChannels + 2], bin);
  }
};

__global__ void __launch_bounds__(mdlt::kTilePixels)
    dl_log_prob_kernel_tiled(const mdlt::ReadOperands<float> a, const dlc::Bin bin) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  mdlt::for_each_tile_read<float, kChannels, kForwardPixels>(a, tile_smem, TileForward{bin});
}

// The backward's body: the head's gradient over the row it has read.
struct TileBackward {
  dlc::Bin bin;
  __device__ __forceinline__ void channel(float* row, int c, float x, float gv) const {
    const dlc::DLGrad d = dlc::dl_grads(x, row[c], row[kChannels + c], bin);
    row[c] = gv * d.d_loc;
    row[kChannels + c] = gv * d.d_ls;
  }
  __device__ __forceinline__ void operator()(float* row, float*, float x0, float x1, float x2,
                                             float g0, float g1, float g2) const {
    channel(row, 0, x0, g0);
    channel(row, 1, x1, g1);
    channel(row, 2, x2, g2);
  }
};

__global__ void __launch_bounds__(mdlt::kTilePixels)
    dl_log_prob_backward_kernel_tiled(const mdlt::Operands<float> a, const dlc::Bin bin) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  mdlt::for_each_tile<float, false, true>(a, tile_smem, TileBackward{bin});
}

const size_t kForwardSmem = mdlt::read_smem_bytes(kRow, sizeof(float), kForwardPixels);
const size_t kBackwardSmem = mdlt::smem_bytes(kRow, sizeof(float), false);

// Whether loc and logscale ([K, B, H, W, 3], element strides given) are the
// two halves of one dense channel-minor float32 head [K, B, H, W, 6] on a
// 16-byte aligned address, and x (strides over the same shape) is broadcast
// over K: what the tile path takes.
bool tile_fits(const float* loc, const float* logscale, int64_t K, int64_t B, int64_t H,
               int64_t W, int64_t xs_k, int64_t ls_k, int64_t ls_b, int64_t ls_h, int64_t ls_w,
               int64_t ls_c, int64_t ss_k, int64_t ss_b, int64_t ss_h, int64_t ss_w,
               int64_t ss_c) {
  return mdlt::channel_minor_dense(K, B, H, W, kRow, ls_k, ls_b, ls_h, ls_w, ls_c) &&
         mdlt::channel_minor_dense(K, B, H, W, kRow, ss_k, ss_b, ss_h, ss_w, ss_c) &&
         logscale == loc + kChannels && mdlt::aligned16(loc) && (K == 1 || xs_k == 0);
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

// The tile path of the forward. loc, logscale: float32 [K, B, H, W, 3] views
// at the element strides given (ls_*: loc's, ss_*: logscale's), which must be
// the two halves of one dense channel-minor head [K, B, H, W, 6] on a 16-byte
// aligned address; x: float32 read at the strides given over the same shape,
// 0 over K (or K = 1); out: contiguous float32 [K, B, H, W, 3]. Returns
// cudaErrorInvalidValue for operands that do not fit, else a cudaError_t.
extern "C" int dl_log_prob_forward_tiled(
    const void* x, const void* loc, const void* logscale, void* out, int64_t K, int64_t B,
    int64_t H, int64_t W, int64_t xs_k, int64_t xs_b, int64_t xs_h, int64_t xs_w,
    int64_t xs_c, int64_t ls_k, int64_t ls_b, int64_t ls_h, int64_t ls_w, int64_t ls_c,
    int64_t ss_k, int64_t ss_b, int64_t ss_h, int64_t ss_w, int64_t ss_c, float low,
    float high, float half_bin, float log_width, void* stream) {
  const float* lf = static_cast<const float*>(loc);
  if (K < 0 || B < 0 || H < 0 || W < 0 ||
      !tile_fits(lf, static_cast<const float*>(logscale), K, B, H, W, xs_k, ls_k, ls_b, ls_h,
                 ls_w, ls_c, ss_k, ss_b, ss_h, ss_w, ss_c))
    return cudaErrorInvalidValue;
  if (K * B * H * W == 0) return cudaSuccess;
  const mdlt::ReadOperands<float> a{static_cast<const float*>(x), lf, static_cast<float*>(out),
                                    kRow, K, B, H, W, xs_b, xs_h, xs_w, xs_c};
  return mdlt::launch_persistent(dl_log_prob_kernel_tiled, kForwardSmem, K * B * H * W,
                                 mdlt::kTilePixels * kForwardPixels,
                                 static_cast<cudaStream_t>(stream), a,
                                 dlc::Bin{low, high, half_bin, log_width});
}

// The tile path of the backward: operands as for the forward's, g the
// float32 cotangent [K, B, H, W, 3] read at its strides (zero strides
// allowed), d_head a contiguous float32 [K, B, H, W, 6] on a 16-byte aligned
// address: g d/d loc in channels 0-2, g d/d logscale in 3-5, the gradient of
// the head loc and logscale are the halves of. Returns cudaErrorInvalidValue
// for operands that do not fit, else a cudaError_t.
extern "C" int dl_log_prob_backward_tiled(
    const void* x, const void* loc, const void* logscale, const void* g, void* d_head,
    int64_t K, int64_t B, int64_t H, int64_t W, int64_t xs_k, int64_t xs_b, int64_t xs_h,
    int64_t xs_w, int64_t xs_c, int64_t ls_k, int64_t ls_b, int64_t ls_h, int64_t ls_w,
    int64_t ls_c, int64_t ss_k, int64_t ss_b, int64_t ss_h, int64_t ss_w, int64_t ss_c,
    int64_t gs_k, int64_t gs_b, int64_t gs_h, int64_t gs_w, int64_t gs_c, float low,
    float high, float half_bin, float log_width, void* stream) {
  const float* lf = static_cast<const float*>(loc);
  if (K < 0 || B < 0 || H < 0 || W < 0 ||
      !tile_fits(lf, static_cast<const float*>(logscale), K, B, H, W, xs_k, ls_k, ls_b, ls_h,
                 ls_w, ls_c, ss_k, ss_b, ss_h, ss_w, ss_c) ||
      !mdlt::aligned16(d_head))
    return cudaErrorInvalidValue;
  if (K * B * H * W == 0) return cudaSuccess;
  mdlt::Operands<float> a{static_cast<const float*>(x), lf, static_cast<const float*>(g),
                          static_cast<float*>(d_head), kRow, K, B, H, W, xs_b, xs_h, xs_w, xs_c,
                          gs_k, gs_b, gs_h, gs_w, gs_c};
  return mdlt::launch_persistent(dl_log_prob_backward_kernel_tiled, kBackwardSmem,
                                 K * B * H * W, mdlt::kTilePixels,
                                 static_cast<cudaStream_t>(stream), a,
                                 dlc::Bin{low, high, half_bin, log_width});
}

// Blocks an SM of the current device holds of the forward's (backward = 0)
// or the backward's tile path, as the occupancy query sizes its grid.
extern "C" int dl_log_prob_tile_blocks_per_sm(int backward) {
  return backward ? mdlt::blocks_per_sm(
                        reinterpret_cast<const void*>(dl_log_prob_backward_kernel_tiled),
                        kBackwardSmem)
                  : mdlt::blocks_per_sm(reinterpret_cast<const void*>(dl_log_prob_kernel_tiled),
                                        kForwardSmem);
}
