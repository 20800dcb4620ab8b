// Dense layers of a tile of R batch rows, shared by the rollout kernels
// (rollout.cu, rollout_train.cu). fp32 on CUDA cores.
//
// A block of kThreads threads holds the tile's activations in shared memory,
// laid out [feature][R], so one thread reads all R rows of a feature with a
// 16-byte broadcast load. Each weight is read once per tile from a row-major
// (din, dout) matrix in device memory (L2): a thread takes CW adjacent output
// columns with one CW-wide load per input, neighbouring threads neighbouring
// columns, and does CW*R FMAs with it. Every layer also splits its input
// dimension into slices over the threads that its columns leave idle and
// reduces the partial sums through shared memory, so narrow layers (20 or 40
// outputs) keep all threads busy. Accumulation is plain fp32 FMA (no TF32).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
// slices of at least kMinChunk inputs keep the partial-sum reduction short
constexpr int kMinChunk = 8;

// softplus(x) = max(x, 0) + log1p(exp(-|x|)), as jax.nn.softplus
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

template <int R>
__device__ __forceinline__ void load_rows(const float* h, int k, float* v) {
  const float4* p = reinterpret_cast<const float4*>(h + k * R);
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const float4 f = p[q];
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

// hout[j][r] = b[j] + sum_k hin[k][r] W[k][j] (b = 0 when bias is null),
// then ReLU when relu_out. W is (din, dout) row-major. A work item is CW
// adjacent output columns over one contiguous slice of the input dim.
template <int R, int CW>
__device__ void dense_cols(const float* __restrict__ W,
                           const float* __restrict__ bias, int din, int dout,
                           const float* hin, float* hout, bool relu_out,
                           float* red) {
  const int tid = threadIdx.x;
  const int C = dout / CW;
  int S = C >= kThreads ? 1 : kThreads / C;
  S = max(1, min(S, din / kMinChunk));
  const int kc = (din + S - 1) / S;
  for (int item = tid; item < C * S; item += kThreads) {
    const int g = item % C, s = item / C;
    const int k0 = s * kc, k1 = min(din, k0 + kc);
    float acc[R][CW];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      float w[CW], v[R];
      load_cols<CW>(W + (size_t)k * dout + g * CW, w);
      load_rows<R>(hin, k, v);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[r][c] = fmaf(v[r], w[c], acc[r][c]);
    }
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int j = g * CW + c;
      if (S == 1) {
        const float bj = bias ? __ldg(bias + j) : 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float a = acc[r][c] + bj;
          hout[j * R + r] = relu_out ? fmaxf(a, 0.0f) : a;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) red[(s * dout + j) * R + r] = acc[r][c];
      }
    }
  }
  if (S > 1) {
    __syncthreads();
    for (int idx = tid; idx < dout * R; idx += kThreads) {
      const int j = idx / R, r = idx % R;
      float a = 0.0f;
      for (int q = 0; q < S; ++q) a += red[(q * dout + j) * R + r];
      if (bias) a += __ldg(bias + j);
      hout[idx] = relu_out ? fmaxf(a, 0.0f) : a;
    }
  }
  __syncthreads();
}

// meta = {din, dout, w_off, b_off}; b_off < 0 means no bias. The wrappers
// align every offset to 4 floats, so 16-byte weight loads are legal
// whenever dout % 4 == 0. `red` holds 4 * kThreads * R floats.
template <int R>
__device__ void dense(const float* __restrict__ params,
                      const int* __restrict__ meta, const float* hin,
                      float* hout, bool relu_out, float* red) {
  const int din = meta[0], dout = meta[1];
  const float* W = params + meta[2];
  const float* bias = meta[3] >= 0 ? params + meta[3] : nullptr;
  if ((dout & 3) == 0)
    dense_cols<R, 4>(W, bias, din, dout, hin, hout, relu_out, red);
  else
    dense_cols<R, 1>(W, bias, din, dout, hin, hout, relu_out, red);
}

}  // namespace
