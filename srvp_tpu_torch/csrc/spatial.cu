// 2x2/stride-2 max pool and 2x nearest upsample, forward and backward, for
// Hopper (sm_90a), fp32, NCHW.
//
// Replace the Pallas TPU kernels of srvp_tpu/ops/pallas/spatial.py:
//   srvp_maxpool2x2_fwd   <- `_maxpool_fwd_kernel`  (via `max_pool2x2`)
//   srvp_maxpool2x2_bwd   <- `_maxpool_bwd_kernel`  (`_max_pool2x2_bwd`)
//   srvp_upsample2x_fwd   <- `_upsample_fwd_kernel` (via `upsample2x`)
//   srvp_upsample2x_bwd   <- `_upsample_bwd_kernel` (`_upsample2x_bwd`)
// The vgg encoder pools after each stage and the vgg decoder upsamples
// after each stage (srvp_tpu/models/conv.py encoder_spec / decoder_spec).
//
// What they compute, bit for bit as the TPU kernels and the plain versions
// in kernels/spatial.py:
//   pool fwd:  m = max(max(x[2i,2j], x[2i+1,2j]), max(x[2i,2j+1], x[2i+1,2j+1]))
//              with NaN propagated (as jnp.max and torch.amax; fmaxf would
//              drop a NaN);
//   pool bwd:  mask = (x == up(m)), cnt = the window's sum of mask,
//              gx = mask * up(g / cnt): tied maxima share the gradient
//              equally, as the reshape-and-max path of the JAX package does
//              under autodiff (F.max_pool2d gives it all to one winner);
//   up fwd:    y[2i+a, 2j+b] = x[i, j];
//   up bwd:    gx = (g[2i,2j] + g[2i+1,2j]) + (g[2i,2j+1] + g[2i+1,2j+1]),
//              the TPU kernel's order of the fp32 sums.
//
// What bounds them on the H100: bytes. Each does a few operations per
// element, so each element is read once and each result written once, at
// the card's 3.35 TB/s. At the largest KTH training site, (2000, 64, 64, 64)
// fp32, that is 2.62 GB for the pool forward (0.78 ms), 5.24 GB for its
// backward, and 2.62 GB for either upsample pass.
//
// Design (simple and exact first): one thread per 2x2 window, a grid-stride
// loop over the windows with 64-bit indices (the evaluation decoder's and
// the tests' largest tensors pass 2^31 elements). A window's two rows are
// read, or written, as two 8-byte float2 accesses (W is even, so each
// window starts on an even float); neighbouring threads take neighbouring
// windows, so a warp's accesses are contiguous. The TPU kernels regroup a
// batch-minor (H, W, C, N) view to keep the pooled axes off the vector
// lanes; NCHW needs no regrouping: the window of output (n, c, i, j) is
// rows 2 * (n * C * H/2 + c * H/2 + i) and the next of the flat
// (N * C * H, W) matrix, columns 2j and 2j + 1. Nothing is kept on chip
// between windows, so there is no shared memory and no synchronisation.
// The kernels launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

// The larger of a and b, NaN if either is a NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ int64_t first_index() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}

// rows: N * C * H/2 output rows; wo: W/2 output columns.
__global__ void __launch_bounds__(kThreads)
    maxpool_fwd_kernel(const float* __restrict__ x, float* __restrict__ m,
                       int64_t rows, int64_t wo) {
  const int64_t n = rows * wo, w = 2 * wo;
  for (int64_t o = first_index(); o < n; o += stride()) {
    const int64_t row = o / wo, j = o - row * wo;
    const float* top = x + 2 * row * w + 2 * j;
    const float2 a = *reinterpret_cast<const float2*>(top);
    const float2 b = *reinterpret_cast<const float2*>(top + w);
    m[o] = max_nan(max_nan(a.x, b.x), max_nan(a.y, b.y));
  }
}

__global__ void __launch_bounds__(kThreads)
    maxpool_bwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ m,
                       const float* __restrict__ g, float* __restrict__ gx,
                       int64_t rows, int64_t wo) {
  const int64_t n = rows * wo, w = 2 * wo;
  for (int64_t o = first_index(); o < n; o += stride()) {
    const int64_t row = o / wo, j = o - row * wo;
    const int64_t off = 2 * row * w + 2 * j;
    const float2 a = *reinterpret_cast<const float2*>(x + off);
    const float2 b = *reinterpret_cast<const float2*>(x + off + w);
    const float mv = m[o];
    const float m00 = a.x == mv, m01 = a.y == mv;
    const float m10 = b.x == mv, m11 = b.y == mv;
    // a window holding a NaN has no match: cnt 0, and 0 * (g / 0) is NaN,
    // as in the TPU kernel and the plain version
    const float s = g[o] / ((m00 + m10) + (m01 + m11));
    *reinterpret_cast<float2*>(gx + off) = make_float2(m00 * s, m01 * s);
    *reinterpret_cast<float2*>(gx + off + w) = make_float2(m10 * s, m11 * s);
  }
}

// rows: N * C * H input rows; w: W input columns.
__global__ void __launch_bounds__(kThreads)
    upsample_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                        int64_t rows, int64_t w) {
  const int64_t n = rows * w, wy = 2 * w;
  for (int64_t o = first_index(); o < n; o += stride()) {
    const int64_t row = o / w, j = o - row * w;
    const float v = x[o];
    float* top = y + 2 * row * wy + 2 * j;
    *reinterpret_cast<float2*>(top) = make_float2(v, v);
    *reinterpret_cast<float2*>(top + wy) = make_float2(v, v);
  }
}

// rows: N * C * H/2 output rows; wo: W/2 output columns.
__global__ void __launch_bounds__(kThreads)
    upsample_bwd_kernel(const float* __restrict__ g, float* __restrict__ gx,
                        int64_t rows, int64_t wo) {
  const int64_t n = rows * wo, w = 2 * wo;
  for (int64_t o = first_index(); o < n; o += stride()) {
    const int64_t row = o / wo, j = o - row * wo;
    const float* top = g + 2 * row * w + 2 * j;
    const float2 a = *reinterpret_cast<const float2*>(top);
    const float2 b = *reinterpret_cast<const float2*>(top + w);
    gx[o] = (a.x + b.x) + (a.y + b.y);
  }
}

int blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// Each returns the launch's cudaError_t (0 on success). Pointers are
// device pointers to contiguous fp32 tensors, 8-byte aligned; `stream` is
// a cudaStream_t. Nothing is launched for an empty tensor.

extern "C" int srvp_maxpool2x2_fwd(const void* x, void* m, long long rows,
                                   long long wo, void* stream) {
  if (rows * wo == 0) return 0;
  maxpool_fwd_kernel<<<blocks(rows * wo), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(m), rows, wo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srvp_maxpool2x2_bwd(const void* x, const void* m,
                                   const void* g, void* gx, long long rows,
                                   long long wo, void* stream) {
  if (rows * wo == 0) return 0;
  maxpool_bwd_kernel<<<blocks(rows * wo), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(m),
      static_cast<const float*>(g), static_cast<float*>(gx), rows, wo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srvp_upsample2x_fwd(const void* x, void* y, long long rows,
                                   long long w, void* stream) {
  if (rows * w == 0) return 0;
  upsample_fwd_kernel<<<blocks(rows * w), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), rows, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srvp_upsample2x_bwd(const void* g, void* gx, long long rows,
                                   long long wo, void* stream) {
  if (rows * wo == 0) return 0;
  upsample_bwd_kernel<<<blocks(rows * wo), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<float*>(gx), rows, wo);
  return static_cast<int>(cudaGetLastError());
}
