// Dense layers of a tile of R batch rows, shared by the rollout kernels
// (rollout.cu, rollout_train.cu). fp32 on CUDA cores.
//
// A block of kThreads threads holds the tile's activations in shared memory,
// laid out [feature][R], so one thread reads RW rows of a feature with
// 16-byte broadcast loads. Each weight is read once per tile from a
// row-major (din, width) matrix in device memory (L2): a thread takes CW
// adjacent output columns of RW rows (all R, or 4) with one CW-wide load
// per input, neighbouring threads neighbouring columns, and does CW*RW FMAs
// with it. Every layer also splits its input dimension into slices over
// the threads that its columns leave idle and reduces the partial sums
// through shared memory, so narrow layers (20 or 40 outputs) keep all
// threads busy. Accumulation is plain fp32 FMA (no TF32).
//
// Column split across a thread-block cluster. In a cluster of C blocks
// sharing one tile, a block computes the columns [c0, c0 + width) of a
// layer that its rank owns (`dense_slice`; C = 1: the whole layer). The
// wrappers pack each rank's slice of W as its own (din, width) row-major
// matrix, so a rank reads only 1/C of the weights. What a block does with
// its outputs is the epilogue's call: write them into the shared memory of
// every rank of the cluster through distributed shared memory (`PushAll`),
// or store them to device memory as well or instead (the training
// kernels). The epilogue gets 4 rows of one column at a time, a float4 of
// the [feature][R] layout.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
// slices of at least kMinChunk inputs keep the partial-sum reduction short
constexpr int kMinChunk = 8;
// the int32 row of one layer's slice of one rank (see dense_slice)
constexpr int kMeta = 6;
// rows of a thread's register tile in the cluster kernels' split layers
// (row_tile), and the unrolling of their input loop
constexpr int kRowTile = 4;
constexpr int kUnroll = 8;
// Shared memory the cluster kernels ask for at least: more than half of an
// SM's 228 KB, so that the scheduler never puts two of their blocks on one
// SM (each block is planned to have an SM's L2 intake and FMA pipes to
// itself; two on one SM ran up to twice as long).
constexpr size_t kOneBlockSmem = 116 * 1024;

// softplus(x) = max(x, 0) + log1p(exp(-|x|)), as jax.nn.softplus
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(fmaxf(v.x, 0.0f), fmaxf(v.y, 0.0f), fmaxf(v.z, 0.0f),
                     fmaxf(v.w, 0.0f));
}

// v[0..n) = rows [0, n) of feature row p (a 16-byte aligned run of n
// floats of the [feature][R] layout)
template <int n>
__device__ __forceinline__ void load_rows(const float* p, float* v) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int q = 0; q < n / 4; ++q) {
    const float4 f = p4[q];
    v[4 * q + 0] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

template <int CW>
__device__ __forceinline__ void load_cols(const float* __restrict__ w,
                                          float* v) {
  if constexpr (CW == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(w));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    v[0] = __ldg(w);
  }
}

// For every output column j < width of W ((din, width) row-major) and every
// group of 4 rows r0: epi(j, r0, b[j] + sum_k hin[k][r0..r0+3] W[k][j]),
// b = 0 when bias is null. A work item is a register tile of CW adjacent
// output columns by RW adjacent rows (all R rows when RW == R) over one
// contiguous slice of the input dim; the slices' partial sums are added in
// a fixed order through `red` (S * width * R floats, at most
// kThreads * CW * RW). The row groups of a column group sit in neighbouring
// lanes, so a warp's weight load is one run of whole 16-byte pieces. Does
// not synchronise at the end: the caller's barrier (the block's or the
// cluster's) must come before `red` is written again or the epilogue's
// output is read.
template <int R, int RW, int CW, class Epi>
__device__ void dense_cols(const float* __restrict__ W,
                           const float* __restrict__ bias, int din, int width,
                           const float* hin, float* red, Epi epi) {
  static_assert(RW % 4 == 0 && R % RW == 0, "rows come in float4 groups");
  constexpr int NQ = R / RW;  // row groups
  // (the whole-tile mapping keeps the unrolling it was measured with)
  constexpr int kLoopUnroll = NQ > 1 ? kUnroll : 4;
  constexpr int kSumUnroll = NQ > 1 ? 4 : 1;
  const int tid = threadIdx.x;
  const int G = width / CW;   // column groups
  const int items = G * NQ;
  int S = items >= kThreads ? 1 : kThreads / items;
  S = max(1, min(S, din / kMinChunk));
  const int kc = (din + S - 1) / S;
  for (int item = tid; item < items * S; item += kThreads) {
    const int gq = item % items, s = item / items;
    const int g = gq / NQ, r0 = (gq % NQ) * RW;
    const int k0 = s * kc, k1 = min(din, k0 + kc);
    float acc[RW][CW];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[r][c] = 0.0f;
#pragma unroll kLoopUnroll
    for (int k = k0; k < k1; ++k) {
      float w[CW], v[RW];
      load_cols<CW>(W + (size_t)k * width + g * CW, w);
      load_rows<RW>(hin + k * R + r0, v);
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[r][c] = fmaf(v[r], w[c], acc[r][c]);
    }
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int j = g * CW + c;
      if (S == 1) {
        const float bj = bias ? __ldg(bias + j) : 0.0f;
#pragma unroll
        for (int q = 0; q < RW / 4; ++q)
          epi(j, r0 + 4 * q,
              make_float4(acc[4 * q][c] + bj, acc[4 * q + 1][c] + bj,
                          acc[4 * q + 2][c] + bj, acc[4 * q + 3][c] + bj));
      } else {
        float4* red4 =
            reinterpret_cast<float4*>(red + (s * width + j) * R + r0);
#pragma unroll
        for (int q = 0; q < RW / 4; ++q)
          red4[q] = make_float4(acc[4 * q][c], acc[4 * q + 1][c],
                                acc[4 * q + 2][c], acc[4 * q + 3][c]);
      }
    }
  }
  if (S > 1) {
    __syncthreads();
    const float4* red4 = reinterpret_cast<const float4*>(red);
    for (int idx = tid; idx < width * (R / 4); idx += kThreads) {
      const int j = idx / (R / 4);
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll kSumUnroll
      for (int q = 0; q < S; ++q) {
        const float4 p = red4[q * width * (R / 4) + idx];
        a.x += p.x;
        a.y += p.y;
        a.z += p.z;
        a.w += p.w;
      }
      if (bias) {
        const float bj = __ldg(bias + j);
        a.x += bj;
        a.y += bj;
        a.z += bj;
        a.w += bj;
      }
      epi(j, 4 * (idx % (R / 4)), a);
    }
  }
}

// Writes a layer's output columns [c0, c0 + width) into the same
// [feature][R] buffer of every block of the cluster (distributed shared
// memory), ReLU first when relu. The writes are visible to the other ranks
// after the next cluster barrier.
template <int R>
struct PushAll {
  float* dst;
  int c0;
  bool relu;
  __device__ void operator()(int j, int r0, float4 v) const {
    if (relu) v = relu4(v);
    float* p = dst + (c0 + j) * R + r0;
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned n = cluster.num_blocks();
    if (n == 1) {
      *reinterpret_cast<float4*>(p) = v;
      return;
    }
    for (unsigned q = 0; q < n; ++q)
      *reinterpret_cast<float4*>(cluster.map_shared_rank(p, q)) = v;
  }
};

// One rank's slice of a layer. m = {din, width, w_off, b_off, c0, dout}:
// the slice is the output columns [c0, c0 + width) of a layer of dout
// columns, its (din, width) weights at params + w_off and its bias at
// params + b_off (b_off < 0: no bias). The wrappers align every offset to
// 4 floats, so 16-byte weight loads are legal whenever width % 4 == 0. A
// rank with no columns (width 0) does nothing. Register tiles of RW rows;
// `red` holds 4 * kThreads * RW floats. Does not synchronise at the end
// (see dense_cols).
template <int R, int RW, class Epi>
__device__ void dense_slice(const float* __restrict__ params, const int* m,
                            const float* hin, float* red, Epi epi) {
  const int din = m[0], width = m[1];
  if (width == 0) return;
  const float* W = params + m[2];
  const float* bias = m[3] >= 0 ? params + m[3] : nullptr;
  if ((width & 3) == 0)
    dense_cols<R, RW, 4>(W, bias, din, width, hin, red, epi);
  else
    dense_cols<R, RW, 1>(W, bias, din, width, hin, red, epi);
}

// The register tile of the cluster kernels' layers, chosen at launch by
// the cluster size C: tiles of kRowTile rows when the columns are split,
// so that a narrow slice still gives every thread work with short
// partial-sum chains; of all R rows (the first design's tiles) when the
// cluster is one block, whose whole-width layers are bound by the FMAs and
// want the fewest loads a multiply-add. One instance a mapping keeps each
// kernel's registers to what that mapping needs; the kernels declare one
// block an SM (__launch_bounds__(kThreads, 1)), or ptxas gives the 4-row
// instances 64 registers, and they ran 20% longer (PERF.md).
template <int R>
constexpr int row_tile(bool split) {
  return split ? kRowTile : R;
}

// Barrier of the blocks that share a tile: the cluster's, or the block's
// own when the cluster is one block.
__device__ __forceinline__ void tile_barrier() {
  cg::cluster_group cluster = cg::this_cluster();
  if (cluster.num_blocks() > 1)
    cluster.sync();
  else
    __syncthreads();
}

// The rank of this block in its cluster, and the cluster's size.
__device__ __forceinline__ int cluster_rank() {
  return (int)cg::this_cluster().block_rank();
}
__device__ __forceinline__ int cluster_size() {
  return (int)cg::this_cluster().num_blocks();
}

}  // namespace

// Host side: launching a kernel of `threads`-thread blocks (kThreads unless
// named) in clusters of C blocks along x (C = 1: a plain launch), and asking
// how many such clusters the card can hold at once.
namespace {

template <class... Args>
cudaError_t prepare_cluster_kernel(void (*kernel)(Args...), size_t smem,
                                   int C) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

inline cudaLaunchConfig_t cluster_config(int grid, int C, size_t smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr,
                                         int threads = kThreads) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// grid blocks of `threads` threads, C to a cluster, after
// prepare_cluster_kernel.
template <class... Args, class... Act>
cudaError_t launch_cluster_of(void (*kernel)(Args...), int grid, int threads,
                              int C, size_t smem, cudaStream_t stream,
                              Act... args) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(grid, C, smem, stream, &attr, threads);
  if (C == 1) cfg.numAttrs = 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// launch_cluster_of with blocks of kThreads threads
template <class... Args, class... Act>
cudaError_t launch_cluster(void (*kernel)(Args...), int grid, int C,
                           size_t smem, cudaStream_t stream, Act... args) {
  return launch_cluster_of(kernel, grid, kThreads, C, smem, stream, args...);
}

// Clusters of C blocks (smem bytes and `threads` threads each) of `kernel`
// that the card can hold at once, in *n; 0 if such a cluster cannot be
// scheduled at all.
template <class... Args>
cudaError_t max_active_clusters(void (*kernel)(Args...), int C, size_t smem,
                                int* n, int threads = kThreads) {
  *n = 0;
  cudaError_t err = prepare_cluster_kernel(kernel, smem, C);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(C, C, smem, nullptr, &attr, threads);
  return cudaOccupancyMaxActiveClusters(n, (void*)kernel, &cfg);
}

}  // namespace
