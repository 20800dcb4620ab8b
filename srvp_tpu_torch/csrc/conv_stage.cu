// Fused conv stage for Hopper (sm_90a): y = conv3x3(act(x * scale + shift)),
// padding 1, no bias, with the per-channel batch statistics of y, NCHW,
// fp32 or bf16 storage and fp32 accumulation.
//
// Replaces two Pallas TPU kernels:
//   srvp_conv3x3_block_fwd   <- srvp_tpu/ops/pallas/conv_stage.py `_fwd_kernel`
//                               (via `conv3x3_block_fwd`): exact zero padding;
//   srvp_conv3x3_clamped_fwd <- scripts/microbench_conv.py `conv_bn_kernel`
//                               (via `fused_conv_bn`): no transform, no
//                               activation, every frame in the statistics,
//                               and the halo rows of each block of bh output
//                               rows clamped into the image.
// One kernel serves both: only the input row that an output row's taps
// centre on differs. Exact: row r reads rows r-1..r+1, zero outside the
// image. Clamped: row r of row block b = r / bh reads rows c-1..c+1 with
// c = clamp(b*bh - 1, 0, H - bh - 2) + (r - b*bh) + 1, always inside the
// image (the TPU prototype's one clamped (bh+2)-row DMA). Columns are zero
// padded in both.
//
// What it computes, as the plain versions in kernels/conv_stage.py:
//   a = act(x * scale + shift) in fp32 (a multiply, then an add, each
//       rounded; act: none, leaky_relu max(v, 0.2 v), tanh), rounded to the
//       storage type (a no-op for fp32); taps outside the image read 0, not
//       act(shift);
//   acc[n, co, p] = sum over ci, dy, dx of a[n, ci, p + (dy-1, dx-1)]
//                   * w[co, ci, dy, dx], fp32;
//   y = acc rounded to the storage type;
//   stats[co] = [sum acc, sum acc^2] over the frames n < n_valid, from the
//               fp32 accumulator before that rounding.
//
// What bounds it on the H100: operations. At the KTH vgg workhorse site
// (64 -> 64 channels, 64 x 64, N = 2000 frames) it does 604 GFLOP against
// 4.19 GB of input and output in fp32: 9.01 ms at the 67 TFLOP/s of fp32
// FMA, 1.25 ms at 3.35 TB/s. (In bf16 on the tensor cores the same work
// would be bound by bytes, 0.63 ms; this kernel does not use them.)
//
// Design (right and simple first; wgmma, TMA and tensor cores are later
// work): an implicit GEMM. M = N*H*W output pixels, cout columns,
// K = 9*cin in the order k = ci*9 + dy*3 + dx, which is torch's
// (cout, cin, 3, 3) weight layout read as (cout, K). A block of 256 threads
// owns 128 pixels x 128 output channels (cout a multiple of 128) or 256
// pixels x 64 channels (any other cout), the pixels in flat NCHW order
// (rows of one frame or of several); it walks K in steps of 8 with two
// shared-memory stages, fetching the next step's input taps and weights
// into registers while it multiplies the current one. The input is gathered
// tap by tap (im2col on the fly, neighbouring threads on neighbouring
// pixels, so loads coalesce; the 9 reads of each input value mostly hit
// L1), each thread keeping a mask of its pixel's taps that fall in the image
// and stepping (ci, tap) along K without divisions; the transform, the
// activation, the edge zeros and the bf16 rounding are applied as the tile
// is stored to shared memory. Each thread accumulates an 8 x 8 fp32 register
// tile (8 pixels, 8 channels) with FMAs, within 128 registers so that two
// blocks share an SM, and every 256 products adds it into fp32 totals in
// shared memory (a two-level sum, see kFlushStages).
//
// The statistics need no atomics and give the same bits on every run: each
// block sums its tile per channel in a fixed order (within a thread, then a
// fixed butterfly over the threads that share the channels) into a
// partials buffer (cout, tiles) of float2, and a second launch sums each
// channel's partials in fp64 in a fixed order. A flat fp32 atomicAdd over
// the 8.2 M values per channel of the workhorse site would lose the 1e-5
// relative accuracy the statistics are held to.
//
// Indices are 64-bit: the 1024 -> 512 site's input alone is 2000*1024*64
// values. N, H, W, cin and cout need not be multiples of any tile. Kernels
// launch on the caller's stream and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMinBM = 128;  // the fewest output pixels a block takes
constexpr int kBK = 8;    // K per shared-memory stage
constexpr int kStatsThreads = 256;
constexpr float kLeakySlope = 0.2f;  // module/conv.py make_conv_block

enum Act { kNone = 0, kLeaky = 1, kTanh = 2 };

// Storage type traits: load as fp32, round to storage, store.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store1(float* p, float v) { *p = v; }
  // p is 16-byte aligned
  static __device__ __forceinline__ void store4(float* p, float a, float b,
                                                float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  // p is 8-byte aligned
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float a,
                                                float b, float c, float d) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
    __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&lo);
    u.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kLeaky) return fmaxf(v, __fmul_rn(kLeakySlope, v));
  if (act == kTanh) return tanhf(v);
  return v;
}

struct Params {
  const void* x;        // (n, cin, h, w) storage type
  const void* wgt;      // (cout, cin, 3, 3) storage type
  const float* scale;   // (cin,) or null: no transform
  const float* shift;   // (cin,)
  void* y;              // (n, cout, h, w) storage type
  float2* partials;     // (cout, n_tiles): per block [sum, sum of squares]
  int64_t n, n_valid;
  int cin, h, w, cout;
  int act;
  int bh;               // 0: exact edges; else clamped blocks of bh rows
};

// Block tiles: BM pixels x BN channels, kThreads threads, each an 8 x 8
// register tile of pixels tm*4 + [0, 4) and BM/2 + tm*4 + [0, 4) by channels
// tn*4 + [0, 4) and BN/2 + tn*4 + [0, 4). 128 x 128 serves cout a multiple
// of 128, 256 x 64 every other cout. The register budget is set for two
// blocks an SM (at most 128 a thread; without it ptxas takes 149-167 and
// fits one 256-thread block).
constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;
// Two-level sums: each thread's register tile sums kFlushStages * kBK
// products, then is added into its fp32 total in shared memory (64 values a
// thread, 64 KB a block) and cleared. One FMA chain over K = 9 * 1024
// terms errs about 5x more (its running sum is larger at every step) and
// missed the plain version's accuracy at the 1024-channel vgg site.
constexpr int kFlushStages = 32;
constexpr int kTotalsBytes = 64 * kThreads * sizeof(float);

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    conv3x3_kernel(const Params p) {
  static_assert(BM * BN == 64 * kThreads, "8 x 8 per thread");
  constexpr int kTm = BM / 8;                   // threads along the pixels
  constexpr int kAPer = kBK * BM / kThreads;    // A values a thread stages
  constexpr int kAStep = kThreads / BM;         // its k stride
  constexpr int kBPer = kBK * BN / kThreads;    // B values a thread stages
  constexpr int kBStep = kThreads / kBK;        // its channel stride
  constexpr int kBPad = BN + 4;                 // spreads B's stores on banks

  __shared__ __align__(16) float a_s[2][kBK][BM];
  __shared__ __align__(16) float b_s[2][kBK][kBPad];
  extern __shared__ float totals[];   // [64][kThreads]: thread-private

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ wt = static_cast<const T*>(p.wgt);
  const int tid = threadIdx.x;
  const int tm = tid % kTm;
  const int tn = tid / kTm;
  const int64_t hw = static_cast<int64_t>(p.h) * p.w;
  const int64_t m_total = p.n * hw;
  const int k_total = 9 * p.cin;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int co0 = blockIdx.y * BN;

  // The one pixel this thread gathers the input of: which of its 9 taps
  // fall in the image (bit dy*3 + dx) and the address of its tap centre.
  const int a_m = tid % BM;
  const int a_k = tid / BM;
  const int64_t am = m0 + a_m;
  unsigned a_taps = 0;
  int64_t a_centre = 0;
  if (am < m_total) {
    const int64_t img = am / hw;
    const int pix = static_cast<int>(am - img * hw);
    const int oh = pix / p.w;
    const int ow = pix - oh * p.w;
    int crow = oh;
    if (p.bh > 0) {
      const int b = oh / p.bh;
      const int row0 = min(max(b * p.bh - 1, 0), p.h - p.bh - 2);
      crow = row0 + (oh - b * p.bh) + 1;
    }
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        if (crow + dy >= 1 && crow + dy <= p.h && ow + dx >= 1 &&
            ow + dx <= p.w)
          a_taps |= 1u << (dy * 3 + dx);
    a_centre = img * p.cin * hw + static_cast<int64_t>(crow) * p.w + ow;
  }
  // k = ci * 9 + tap of this thread's first A value in the next stage;
  // a stage advances k by kBK < 9, so tap wraps at most once.
  int a_ci = 0, a_tap = a_k, k0 = 0;
  const int b_k = tid % kBK;
  const int b_co = tid / kBK;

  float a_raw[kAPer];
  int a_cj[kAPer];  // the channel of each A value, -1 where it reads 0
  float b_reg[kBPer];

  // Global -> registers for the next stage.
  auto fetch = [&]() {
#pragma unroll
    for (int j = 0; j < kAPer; ++j) {
      int tap = a_tap + kAStep * j, ci = a_ci;
      if (tap >= 9) {
        tap -= 9;
        ++ci;
      }
      a_cj[j] = -1;
      a_raw[j] = 0.f;
      if (ci < p.cin && ((a_taps >> tap) & 1u)) {
        const int dy = (tap * 11) >> 5;  // tap / 3 for tap < 9
        const int dx = tap - 3 * dy;
        a_cj[j] = ci;
        a_raw[j] = Io<T>::load(x + a_centre + ci * hw + (dy - 1) * p.w +
                               (dx - 1));
      }
    }
#pragma unroll
    for (int j = 0; j < kBPer; ++j) {
      const int co = co0 + b_co + kBStep * j;
      const int kk = k0 + b_k;
      b_reg[j] = (co < p.cout && kk < k_total)
                     ? Io<T>::load(wt + static_cast<int64_t>(co) * k_total + kk)
                     : 0.f;
    }
    k0 += kBK;
    a_tap += kBK;
    if (a_tap >= 9) {
      a_tap -= 9;
      ++a_ci;
    }
  };

  // Registers -> shared stage `buf`, transformed, activated and rounded.
  auto stage = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kAPer; ++j) {
      float v = 0.f;
      const int ci = a_cj[j];
      if (ci >= 0) {
        v = a_raw[j];
        if (p.scale != nullptr)
          v = __fadd_rn(__fmul_rn(v, __ldg(p.scale + ci)),
                        __ldg(p.shift + ci));
        v = Io<T>::round(activate(v, p.act));
      }
      a_s[buf][a_k + kAStep * j][a_m] = v;
    }
#pragma unroll
    for (int j = 0; j < kBPer; ++j) b_s[buf][b_k][b_co + kBStep * j] = b_reg[j];
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_stages = (k_total + kBK - 1) / kBK;
  fetch();
  stage(0);
  __syncthreads();
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < n_stages;
    if (more) fetch();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[buf][k][tm * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[buf][k][BM / 2 + tm * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[buf][k][tn * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&b_s[buf][k][BN / 2 + tn * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (!more || (s + 1) % kFlushStages == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float& t = totals[(i * 8 + j) * kThreads + tid];
          t = s < kFlushStages ? acc[i][j] : t + acc[i][j];
          acc[i][j] = 0.f;
        }
    }
    // the other stage was last read before the previous barrier
    if (more) stage(buf ^ 1);
    __syncthreads();
  }
  if (n_stages > 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = totals[(i * 8 + j) * kThreads + tid];
  }

  // Epilogue: y, and this thread's per-channel sums over counted pixels.
  T* __restrict__ y = static_cast<T*>(p.y);
  const bool vec = (hw % 4) == 0;  // 4 pixels of a group share one frame
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int64_t mg = m0 + g * (BM / 2) + tm * 4;
    int64_t ybase[4];
    bool valid[4], counted[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t m = mg + i;
      valid[i] = m < m_total;
      const int64_t img = valid[i] ? m / hw : 0;
      ybase[i] = img * p.cout * hw + (m - img * hw);
      counted[i] = valid[i] && img < p.n_valid;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = co0 + (j / 4) * (BN / 2) + tn * 4 + (j % 4);
      if (co >= p.cout) continue;
      float vals[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) vals[i] = acc[g * 4 + i][j];
      const int64_t off = static_cast<int64_t>(co) * hw;
      if (vec && valid[0]) {
        Io<T>::store4(y + ybase[0] + off, vals[0], vals[1], vals[2], vals[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (valid[i]) Io<T>::store1(y + ybase[i] + off, vals[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (counted[i]) {
          s1[j] += vals[i];
          s2[j] = fmaf(vals[i], vals[i], s2[j]);
        }
      }
    }
  }
  // A fixed butterfly over the kTm consecutive lanes that share tn.
#pragma unroll
  for (int off = kTm / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], off);
      s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], off);
    }
  }
  if (tm == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = co0 + (j / 4) * (BN / 2) + tn * 4 + (j % 4);
      if (co < p.cout)
        p.partials[static_cast<int64_t>(co) * gridDim.x + blockIdx.x] =
            make_float2(s1[j], s2[j]);
    }
  }
}

// One block per channel: its partials summed in fp64, in a fixed order.
__global__ void __launch_bounds__(kStatsThreads)
    stats_kernel(const float2* __restrict__ partials,
                 float* __restrict__ stats, int64_t n_tiles) {
  __shared__ double r1[kStatsThreads], r2[kStatsThreads];
  const int co = blockIdx.x;
  const int tid = threadIdx.x;
  const float2* row = partials + static_cast<int64_t>(co) * n_tiles;
  double s1 = 0.0, s2 = 0.0;
  for (int64_t t = tid; t < n_tiles; t += kStatsThreads) {
    const float2 v = row[t];
    s1 += v.x;
    s2 += v.y;
  }
  r1[tid] = s1;
  r2[tid] = s2;
  __syncthreads();
  for (int s = kStatsThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      r1[tid] += r1[tid + s];
      r2[tid] += r2[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    stats[2 * co] = static_cast<float>(r1[0]);
    stats[2 * co + 1] = static_cast<float>(r2[0]);
  }
}

template <typename T, int BM, int BN>
cudaError_t launch_tile(const Params& p, dim3 grid, cudaStream_t stream) {
  // the totals take the block past the 48 KB of static shared memory
  const cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<T, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTotalsBytes);
  if (err != cudaSuccess) return err;
  conv3x3_kernel<T, BM, BN><<<grid, kThreads, kTotalsBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int launch(const Params& p, float* stats, int64_t n_tiles,
           cudaStream_t stream) {
  const int64_t m_total = p.n * p.h * p.w;
  if (m_total == 0 || p.cout == 0) return 0;
  // the partials hold ceil(m_total / kMinBM) tiles, enough for either
  if (n_tiles != (m_total + kMinBM - 1) / kMinBM || n_tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t tiles;
  cudaError_t err;
  if (p.cout % 128 == 0) {
    tiles = (m_total + 127) / 128;
    const dim3 grid(static_cast<unsigned>(tiles), p.cout / 128);
    err = launch_tile<T, 128, 128>(p, grid, stream);
  } else {
    tiles = (m_total + 255) / 256;
    const dim3 grid(static_cast<unsigned>(tiles), (p.cout + 63) / 64);
    err = launch_tile<T, 256, 64>(p, grid, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_kernel<<<p.cout, kStatsThreads, 0, stream>>>(p.partials, stats,
                                                     tiles);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Params& p, int bf16, void* stats, long long n_tiles,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto st = static_cast<float*>(stats);
  return bf16 ? launch<__nv_bfloat16>(p, st, n_tiles, s)
              : launch<float>(p, st, n_tiles, s);
}

}  // namespace

// Each returns the launches' cudaError_t (0 on success). Pointers are
// device pointers to contiguous tensors: x, w and y in the storage type
// (fp32, or bf16 when `bf16` is set), y 16-byte aligned; scale, shift,
// stats (cout, 2) fp32; partials fp32 scratch of 2 * cout * n_tiles values,
// n_tiles = ceil(n * h * w / 128). `stream` is a cudaStream_t. Nothing is
// launched when there is no output.

// Kernel 8: exact edges; act 0 none, 1 leaky_relu, 2 tanh; scale and
// shift both null for no transform; frames >= n_valid left out of stats.
extern "C" int srvp_conv3x3_block_fwd(const void* x, const void* w,
                                      const void* scale, const void* shift,
                                      void* y, void* partials, void* stats,
                                      int bf16, long long n, int cin, int h,
                                      int wd, int cout, long long n_valid,
                                      int act, long long n_tiles,
                                      void* stream) {
  if ((scale == nullptr) != (shift == nullptr) || act < 0 || act > 2 ||
      n_valid < 0 || n_valid > n)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, w, static_cast<const float*>(scale),
           static_cast<const float*>(shift), y,
           static_cast<float2*>(partials), n, n_valid, cin, h, wd, cout, act,
           0};
  return dispatch(p, bf16, stats, n_tiles, stream);
}

// Kernel 9: clamped halo rows for blocks of bh rows (h % bh == 0,
// h >= 2 bh and h >= bh + 2), no transform, no activation, every frame in
// the statistics.
extern "C" int srvp_conv3x3_clamped_fwd(const void* x, const void* w,
                                        void* y, void* partials, void* stats,
                                        int bf16, long long n, int cin,
                                        int h, int wd, int cout, int bh,
                                        long long n_tiles, void* stream) {
  if (bh < 1 || h % bh != 0 || h < 2 * bh || h < bh + 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, w, nullptr, nullptr, y, static_cast<float2*>(partials), n, n,
           cin, h, wd, cout, kNone, bh};
  return dispatch(p, bf16, stats, n_tiles, stream);
}
