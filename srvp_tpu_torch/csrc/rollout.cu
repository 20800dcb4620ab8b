// Pure-prior latent Euler rollout for Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces the Pallas TPU kernel srvp_tpu/ops/pallas/rollout.py
// `_rollout_kernel` (called by `prior_rollout_fused`). Per substep t of
// n_steps, for each batch row independently:
//     if t % oversampling == 0:                       (first substep of a frame)
//         p = p_z(y);  z = p[:nz] + eps[t] * (softplus(p[nz:]) + 1e-8)
//     y += dt * dynamics([y, z]);  out[t] = y
// p_z and dynamics are pre-activation ReLU MLPs (ReLU before every linear
// but the first). Only the first-substep eps of each frame is read.
//
// What bounds it on the H100: arithmetic. At the flagship widths a row does
// 1,110,016 multiply-adds per substep (p_z 20->512->512->512->40, dynamics
// 40->512->512->512->20), so B=1600 x 20 substeps is 71 GFLOP, about 1.06 ms
// at the card's 67 TFLOP/s of fp32 FMA; device-memory traffic is only the
// 4.44 MB of weights plus y0, eps and out. The TPU kernel pins every weight
// in VMEM; 4.44 MB does not fit in a block's 227 KB of shared memory, but it
// does fit in the 50 MB L2, so the weights are streamed from L2 and the L2
// traffic is n_blocks x n_steps x 4.44 MB.
//
// Design (simple and exact first): one launch for the whole rollout; one
// block of 512 threads per tile of R batch rows (rows are independent, so
// blocks never synchronise with each other); the substep loop runs inside
// the block in place of the TPU's sequential grid axis. The tile's y, z and
// hidden activations live in shared memory, laid out [feature][R] so one
// thread reads all R rows of a feature with a 16-byte broadcast load. Each
// weight is read once per tile and substep from the (in, out) row-major
// layout: a thread takes 4 adjacent output columns with one 16-byte load
// per input, neighbouring threads neighbouring columns, and does 4*R FMAs
// with it; larger R means less L2 traffic per FLOP but fewer blocks. Every
// layer also splits its input dimension into slices over the threads that
// its columns leave idle, and reduces the partial sums through shared
// memory, so narrow layers (40 or 20 outputs) keep all 512 threads busy and
// every warp has many loads in flight. Accumulation is plain fp32 FMA (no
// TF32, no bf16): the rollout is held to rtol 1e-4 against the float32
// reference.
//
// Measured on an H100 (PERF.md), this design is not limited by arithmetic but
// by each SM taking all 4.44 MB of weights from L2 every substep (about 24
// bytes per cycle per SM): ~2.1 ms at B=160 whatever R is. Sharing the
// weights across SMs (clusters with TMA multicast or distributed shared
// memory) is the way past it.

#include "tile_mlp.cuh"

namespace {

// Runs an MLP of n layers (meta rows) on hin; returns the buffer holding
// the output, which is one of buf0/buf1.
template <int R>
__device__ const float* mlp(const float* __restrict__ params,
                            const int* __restrict__ meta, int n,
                            const float* hin, float* buf0, float* buf1,
                            float* red) {
  const float* h = hin;
  float* o = buf0;
  for (int l = 0; l < n; ++l) {
    dense<R>(params, meta + 4 * l, h, o, l < n - 1, red);
    h = o;
    o = (o == buf0) ? buf1 : buf0;
  }
  return h;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
prior_rollout_kernel(const float* __restrict__ params,
                     const int* __restrict__ meta, int n_pz, int n_dyn,
                     const float* __restrict__ y0,
                     const float* __restrict__ eps, float* __restrict__ out,
                     int B, int ny, int nz, int n_steps, int oversampling,
                     float dt, int hmax) {
  extern __shared__ float4 smem4[];
  float* yz = reinterpret_cast<float*>(smem4);  // [ny + nz][R]: y then z
  float* buf0 = yz + (ny + nz) * R;             // [hmax][R]
  float* buf1 = buf0 + hmax * R;                // [hmax][R]
  float* red = buf1 + hmax * R;                 // [4 * kThreads][R]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;

  // rows are walked row-major over the global arrays so that neighbouring
  // threads touch neighbouring addresses
  for (int idx = tid; idx < R * (ny + nz); idx += kThreads) {
    const int r = idx / (ny + nz), k = idx % (ny + nz);
    const int row = row0 + r;
    yz[k * R + r] = (k < ny && row < B) ? y0[(size_t)row * ny + k] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < n_steps; ++t) {
    if (t % oversampling == 0) {
      const float* p = mlp<R>(params, meta, n_pz, yz, buf0, buf1, red);
      for (int idx = tid; idx < R * nz; idx += kThreads) {
        const int r = idx / nz, k = idx % nz;
        const int row = row0 + r;
        const float e =
            row < B ? eps[((size_t)t * B + row) * nz + k] : 0.0f;
        yz[(ny + k) * R + r] =
            p[k * R + r] + e * (softplus(p[(nz + k) * R + r]) + 1e-8f);
      }
      __syncthreads();
    }
    const float* res =
        mlp<R>(params, meta + 4 * n_pz, n_dyn, yz, buf0, buf1, red);
    for (int idx = tid; idx < R * ny; idx += kThreads) {
      const int r = idx / ny, k = idx % ny;
      const int row = row0 + r;
      const float y = yz[k * R + r] + dt * res[k * R + r];
      yz[k * R + r] = y;
      if (row < B) out[((size_t)t * B + row) * ny + k] = y;
    }
    __syncthreads();
  }
}

template <int R>
cudaError_t launch(const float* params, const int* meta, int n_pz, int n_dyn,
                   const float* y0, const float* eps, float* out, int B,
                   int ny, int nz, int n_steps, int oversampling, int hmax,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * R * (ny + nz + 2 * hmax + 4 * kThreads);
  cudaError_t err = cudaFuncSetAttribute(
      prior_rollout_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + R - 1) / R;
  prior_rollout_kernel<R><<<grid, kThreads, smem, stream>>>(
      params, meta, n_pz, n_dyn, y0, eps, out, B, ny, nz, n_steps,
      oversampling, 1.0f / (float)oversampling, hmax);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. params: every layer's W (in, out)
// row-major and bias, packed; meta: int32 {din, dout, w_off, b_off} per layer,
// p_z layers first. y0 (B, ny), eps (n_steps, B, nz), out (n_steps, B, ny),
// all fp32 and contiguous on the device. rows_per_block is 4, 8 or 16.
// Returns the launch's cudaError_t (0 on success).
extern "C" int srvp_prior_rollout(const void* params, const void* meta,
                                  int n_pz, int n_dyn, const void* y0,
                                  const void* eps, void* out, int B, int ny,
                                  int nz, int n_steps, int oversampling,
                                  int hmax, int rows_per_block,
                                  void* stream) {
  const float* p = static_cast<const float*>(params);
  const int* m = static_cast<const int*>(meta);
  const float* y = static_cast<const float*>(y0);
  const float* e = static_cast<const float*>(eps);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_block) {
    case 4:
      return launch<4>(p, m, n_pz, n_dyn, y, e, o, B, ny, nz, n_steps,
                       oversampling, hmax, s);
    case 8:
      return launch<8>(p, m, n_pz, n_dyn, y, e, o, B, ny, nz, n_steps,
                       oversampling, hmax, s);
    case 16:
      return launch<16>(p, m, n_pz, n_dyn, y, e, o, B, ny, nz, n_steps,
                        oversampling, hmax, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
