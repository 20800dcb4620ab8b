// 2x2/stride-2 max pool and 2x nearest upsample, forward and backward, for
// Hopper (sm_90a), fp32 and bf16, NCHW.
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
// One template over the element type T (float, __nv_bfloat16) serves both
// types; each has its own entry point (`_bf16` for bf16). In bf16 every
// value is widened to fp32 on the load, and the arithmetic is the fp32
// kernel's: the max is exact, the pool backward's mask, count and g / cnt
// and the upsample backward's sums are fp32 with one rounding to bf16 (to
// nearest even) at the store, as in the TPU kernels
// (`_maxpool_bwd_kernel`, `_upsample_bwd_kernel`) and the plain versions.
//
// What bounds them on the H100: bytes. Each does a few operations per
// element, so each element is read once and each result written once, at
// the card's 3.35 TB/s. At the largest KTH training site, (2000, 64, 64, 64)
// fp32, that is 2.62 GB for the pool forward (0.78 ms), 5.24 GB for its
// backward, and 2.62 GB for either upsample pass; half of each in bf16.
//
// Design (simple and exact first): one thread per 2x2 window, a grid-stride
// loop over the windows with 64-bit indices (the evaluation decoder's and
// the tests' largest tensors pass 2^31 elements). A window's two rows are
// read, or written, as two pair accesses, 8-byte float2s or 4-byte
// __nv_bfloat162s (W is even, so each window starts on an even element);
// neighbouring threads take neighbouring windows, so a warp's accesses
// are contiguous. The TPU kernels regroup a
// batch-minor (H, W, C, N) view to keep the pooled axes off the vector
// lanes; NCHW needs no regrouping: the window of output (n, c, i, j) is
// rows 2 * (n * C * H/2 + c * H/2 + i) and the next of the flat
// (N * C * H, W) matrix, columns 2j and 2j + 1. Nothing is kept on chip
// between windows, so there is no shared memory and no synchronisation.
// The kernels launch on the caller's stream and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

using bf16 = __nv_bfloat16;

// A window's pair of columns: T2<float> is float2, T2<bf16> __nv_bfloat162.
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<bf16> { using type = __nv_bfloat162; };
template <typename T> using T2 = typename Pair<T>::type;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float2 widen2(float2 v) { return v; }
__device__ __forceinline__ float2 widen2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

// fp32 -> T, rounding to nearest even for bf16 (exact for fp32).
template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 narrow<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ T2<T> narrow2(float a,
                                                              float b);
template <> __device__ __forceinline__ float2 narrow2<float>(float a,
                                                             float b) {
  return make_float2(a, b);
}
template <> __device__ __forceinline__ __nv_bfloat162 narrow2<bf16>(float a,
                                                                    float b) {
  return __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float2 dup(float v) { return make_float2(v, v); }
__device__ __forceinline__ __nv_bfloat162 dup(bf16 v) {
  return __halves2bfloat162(v, v);
}

template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  return widen2(*reinterpret_cast<const T2<T>*>(p));
}

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
template <typename T>
__global__ void __launch_bounds__(kThreads)
    maxpool_fwd_kernel(const T* __restrict__ x, T* __restrict__ m,
                       int64_t rows, int64_t wo) {
  const int64_t n = rows * wo, w = 2 * wo;
  for (int64_t o = first_index(); o < n; o += stride()) {
    const int64_t row = o / wo, j = o - row * wo;
    const T* top = x + 2 * row * w + 2 * j;
    const float2 a = load2(top);
    const float2 b = load2(top + w);
    m[o] = narrow<T>(max_nan(max_nan(a.x, b.x), max_nan(a.y, b.y)));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    maxpool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ m,
                       const T* __restrict__ g, T* __restrict__ gx,
                       int64_t rows, int64_t wo) {
  const int64_t n = rows * wo, w = 2 * wo;
  for (int64_t o = first_index(); o < n; o += stride()) {
    const int64_t row = o / wo, j = o - row * wo;
    const int64_t off = 2 * row * w + 2 * j;
    const float2 a = load2(x + off);
    const float2 b = load2(x + off + w);
    const float mv = widen(m[o]);
    const float m00 = a.x == mv, m01 = a.y == mv;
    const float m10 = b.x == mv, m11 = b.y == mv;
    // a window holding a NaN has no match: cnt 0, and 0 * (g / 0) is NaN,
    // as in the TPU kernel and the plain version
    const float s = widen(g[o]) / ((m00 + m10) + (m01 + m11));
    *reinterpret_cast<T2<T>*>(gx + off) = narrow2<T>(m00 * s, m01 * s);
    *reinterpret_cast<T2<T>*>(gx + off + w) = narrow2<T>(m10 * s, m11 * s);
  }
}

// rows: N * C * H input rows; w: W input columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    upsample_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                        int64_t rows, int64_t w) {
  const int64_t n = rows * w, wy = 2 * w;
  for (int64_t o = first_index(); o < n; o += stride()) {
    const int64_t row = o / w, j = o - row * w;
    const T2<T> v = dup(x[o]);
    T* top = y + 2 * row * wy + 2 * j;
    *reinterpret_cast<T2<T>*>(top) = v;
    *reinterpret_cast<T2<T>*>(top + wy) = v;
  }
}

// rows: N * C * H/2 output rows; wo: W/2 output columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    upsample_bwd_kernel(const T* __restrict__ g, T* __restrict__ gx,
                        int64_t rows, int64_t wo) {
  const int64_t n = rows * wo, w = 2 * wo;
  for (int64_t o = first_index(); o < n; o += stride()) {
    const int64_t row = o / wo, j = o - row * wo;
    const T* top = g + 2 * row * w + 2 * j;
    const float2 a = load2(top);
    const float2 b = load2(top + w);
    gx[o] = narrow<T>((a.x + b.x) + (a.y + b.y));
  }
}

int blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename T>
int maxpool_fwd(const void* x, void* m, long long rows, long long wo,
                void* stream) {
  if (rows * wo == 0) return 0;
  maxpool_fwd_kernel<T><<<blocks(rows * wo), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(m), rows, wo);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int maxpool_bwd(const void* x, const void* m, const void* g, void* gx,
                long long rows, long long wo, void* stream) {
  if (rows * wo == 0) return 0;
  maxpool_bwd_kernel<T><<<blocks(rows * wo), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(m),
      static_cast<const T*>(g), static_cast<T*>(gx), rows, wo);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int upsample_fwd(const void* x, void* y, long long rows, long long w,
                 void* stream) {
  if (rows * w == 0) return 0;
  upsample_fwd_kernel<T><<<blocks(rows * w), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), rows, w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int upsample_bwd(const void* g, void* gx, long long rows, long long wo,
                 void* stream) {
  if (rows * wo == 0) return 0;
  upsample_bwd_kernel<T><<<blocks(rows * wo), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<T*>(gx), rows, wo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each returns the launch's cudaError_t (0 on success). Pointers are
// device pointers to contiguous tensors of the entry point's type (fp32,
// or bf16 for `_bf16`), aligned to two elements; `stream` is a
// cudaStream_t. Nothing is launched for an empty tensor.

extern "C" int srvp_maxpool2x2_fwd(const void* x, void* m, long long rows,
                                   long long wo, void* stream) {
  return maxpool_fwd<float>(x, m, rows, wo, stream);
}

extern "C" int srvp_maxpool2x2_fwd_bf16(const void* x, void* m,
                                        long long rows, long long wo,
                                        void* stream) {
  return maxpool_fwd<bf16>(x, m, rows, wo, stream);
}

extern "C" int srvp_maxpool2x2_bwd(const void* x, const void* m,
                                   const void* g, void* gx, long long rows,
                                   long long wo, void* stream) {
  return maxpool_bwd<float>(x, m, g, gx, rows, wo, stream);
}

extern "C" int srvp_maxpool2x2_bwd_bf16(const void* x, const void* m,
                                        const void* g, void* gx,
                                        long long rows, long long wo,
                                        void* stream) {
  return maxpool_bwd<bf16>(x, m, g, gx, rows, wo, stream);
}

extern "C" int srvp_upsample2x_fwd(const void* x, void* y, long long rows,
                                   long long w, void* stream) {
  return upsample_fwd<float>(x, y, rows, w, stream);
}

extern "C" int srvp_upsample2x_fwd_bf16(const void* x, void* y,
                                        long long rows, long long w,
                                        void* stream) {
  return upsample_fwd<bf16>(x, y, rows, w, stream);
}

extern "C" int srvp_upsample2x_bwd(const void* g, void* gx, long long rows,
                                   long long wo, void* stream) {
  return upsample_bwd<float>(g, gx, rows, wo, stream);
}

extern "C" int srvp_upsample2x_bwd_bf16(const void* g, void* gx,
                                        long long rows, long long wo,
                                        void* stream) {
  return upsample_bwd<bf16>(g, gx, rows, wo, stream);
}
