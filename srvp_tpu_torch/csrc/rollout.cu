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
// in VMEM; 4.44 MB does not fit in a block's 227 KB of shared memory, nor in
// a 16-block cluster's in fp32, so the weights are streamed from the 50 MB
// L2.
//
// What held the first design back: one block per tile of R batch rows took
// all 4.44 MB from L2 every substep, and one SM takes in about 24 bytes a
// cycle, so a substep cost ~107 us whatever R was; at the main path's B = 160
// that was 40 busy SMs of 132 (PERF.md).
//
// Design. One launch for the whole rollout; the substep loop runs inside
// the block in place of the TPU's sequential grid axis. A thread-block
// cluster of C blocks (kernels/rollout.py `cluster_plan`) shares one tile of
// R rows: every layer's output columns are split across the C ranks, each
// rank reads only its slice of W (packed contiguously by the wrapper) and
// writes its output slice into the activation buffer of every rank through
// distributed shared memory, then one cluster barrier. So each SM takes in
// 1/C of the weights a substep, and C times as many SMs work. The two
// activation buffers alternate from layer to layer (and on across the MLPs),
// so one barrier a layer is enough: a rank writes a buffer only after every
// rank has passed the barrier that ends the last reads of it. y, z and the
// Euler update are computed by every rank on its own copy of the tile (the
// same bits everywhere); rank 0 alone writes `out`. C = 1 is the first
// design (its register tiles too, tile_mlp.cuh row_tile). Each block keeps
// an SM to itself (tile_mlp.cuh kOneBlockSmem). Measured on an H100
// (PERF.md), what a tile row costs an SM (its products, partial sums
// and the exchange of every layer, which each rank receives whole) and the
// weights' L2 intake (1/C of 4.44 MB a substep) are of the same order:
// cluster_plan weighs the two. The tile's activations live in shared memory as
// [feature][R] (tile_mlp.cuh); accumulation is plain fp32 FMA in a fixed
// order (no TF32, no atomics), so a plan gives the same bits on every launch:
// the rollout is held to rtol 1e-4 against the float32 reference.

#include "tile_mlp.cuh"

namespace {

// Runs an MLP of n layers on hin (this block's full-width input): each rank
// computes its slice of every layer (meta rows kMeta * (l * C + rank)) and
// writes it into buf[nxt] of every rank, then the cluster barrier; nxt
// alternates. Returns the buffer that holds the output.
template <int R, int RW>
__device__ const float* mlp(const float* __restrict__ params,
                            const int* __restrict__ meta, int n,
                            const float* hin, float* const* buf, int& nxt,
                            float* red, int rank, int C) {
  const float* h = hin;
  for (int l = 0; l < n; ++l) {
    const int* m = meta + kMeta * (l * C + rank);
    dense_slice<R, RW>(params, m, h, red,
                       PushAll<R>{buf[nxt], m[4], l < n - 1});
    tile_barrier();
    h = buf[nxt];
    nxt ^= 1;
  }
  return h;
}

template <int R, int RW>
__global__ void __launch_bounds__(kThreads, 1)
prior_rollout_kernel(const float* __restrict__ params,
                     const int* __restrict__ meta, int n_pz, int n_dyn,
                     const float* __restrict__ y0,
                     const float* __restrict__ eps, float* __restrict__ out,
                     int B, int ny, int nz, int n_steps, int oversampling,
                     float dt, int hmax) {
  extern __shared__ float4 smem4[];
  float* yz = reinterpret_cast<float*>(smem4);  // [ny + nz][R]: y then z
  float* buf[2] = {yz + (ny + nz) * R,          // [hmax][R] each
                   yz + (ny + nz + hmax) * R};
  float* red = buf[1] + hmax * R;               // [4 * kThreads][R]
  const int tid = threadIdx.x;
  const int C = cluster_size(), rank = cluster_rank();
  const int row0 = (blockIdx.x / C) * R;
  const int* meta_dyn = meta + kMeta * C * n_pz;

  // rows are walked row-major over the global arrays so that neighbouring
  // threads touch neighbouring addresses
  for (int idx = tid; idx < R * (ny + nz); idx += kThreads) {
    const int r = idx / (ny + nz), k = idx % (ny + nz);
    const int row = row0 + r;
    yz[k * R + r] = (k < ny && row < B) ? y0[(size_t)row * ny + k] : 0.0f;
  }
  // every rank has started (its shared memory exists) before any rank
  // writes into it
  tile_barrier();

  int nxt = 0;
  for (int t = 0; t < n_steps; ++t) {
    if (t % oversampling == 0) {
      const float* p =
          mlp<R, RW>(params, meta, n_pz, yz, buf, nxt, red, rank, C);
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
        mlp<R, RW>(params, meta_dyn, n_dyn, yz, buf, nxt, red, rank, C);
    for (int idx = tid; idx < R * ny; idx += kThreads) {
      const int r = idx / ny, k = idx % ny;
      const int row = row0 + r;
      const float y = yz[k * R + r] + dt * res[k * R + r];
      yz[k * R + r] = y;
      if (rank == 0 && row < B) out[((size_t)t * B + row) * ny + k] = y;
    }
    __syncthreads();
  }
  // the last write into another rank's shared memory came before the last
  // cluster barrier, so every rank may exit now
}

template <int R>
size_t smem_bytes(int ny, int nz, int hmax) {
  const size_t need = sizeof(float) * R * (ny + nz + 2 * hmax + 4 * kThreads);
  return need > kOneBlockSmem ? need : kOneBlockSmem;
}

// the kernel's instance for clusters of C blocks (tile_mlp.cuh row_tile)
template <int R>
auto kernel_for(int C) {
  return C > 1 ? prior_rollout_kernel<R, row_tile<R>(true)>
               : prior_rollout_kernel<R, row_tile<R>(false)>;
}

template <int R>
cudaError_t launch(const float* params, const int* meta, int n_pz, int n_dyn,
                   const float* y0, const float* eps, float* out, int B,
                   int ny, int nz, int n_steps, int oversampling, int hmax,
                   int C, cudaStream_t stream) {
  const size_t smem = smem_bytes<R>(ny, nz, hmax);
  cudaError_t err = prepare_cluster_kernel(kernel_for<R>(C), smem, C);
  if (err != cudaSuccess) return err;
  return launch_cluster(kernel_for<R>(C), (B + R - 1) / R * C, C, smem,
                        stream, params, meta, n_pz, n_dyn, y0, eps, out, B, ny,
                        nz, n_steps, oversampling,
                        1.0f / (float)oversampling, hmax);
}

template <int R>
cudaError_t clusters(int ny, int nz, int hmax, int C, int* n) {
  return max_active_clusters(kernel_for<R>(C), C, smem_bytes<R>(ny, nz, hmax),
                             n);
}

}  // namespace

// C entry points, bound with ctypes. params: every rank's slice of every
// layer's W (in, out) and bias, packed by kernels/rollout.py; meta: int32
// {din, width, w_off, b_off, c0, dout} per (layer, rank), p_z layers first.
// y0 (B, ny), eps (n_steps, B, nz), out (n_steps, B, ny), all fp32 and
// contiguous on the device. rows (R) is 4, 8, 12 or 16; C (blocks a
// cluster) 1, 2, 4, 8 or 16. Returns the launch's cudaError_t (0 on
// success).
extern "C" int srvp_prior_rollout(const void* params, const void* meta,
                                  int n_pz, int n_dyn, const void* y0,
                                  const void* eps, void* out, int B, int ny,
                                  int nz, int n_steps, int oversampling,
                                  int hmax, int rows, int C, void* stream) {
  const float* p = static_cast<const float*>(params);
  const int* m = static_cast<const int*>(meta);
  const float* y = static_cast<const float*>(y0);
  const float* e = static_cast<const float*>(eps);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(R) \
  launch<R>(p, m, n_pz, n_dyn, y, e, o, B, ny, nz, n_steps, oversampling, \
            hmax, C, s)
  switch (rows) {
    case 4: return LAUNCH(4);
    case 8: return LAUNCH(8);
    case 12: return LAUNCH(12);
    case 16: return LAUNCH(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
}

// Clusters of C blocks of `rows` rows (shared memory for ny, nz and the
// widest layer hmax) that the card holds at once, in *n; 0 if they cannot
// be scheduled. Returns a cudaError_t.
extern "C" int srvp_prior_rollout_clusters(int ny, int nz, int hmax, int rows,
                                           int C, int* n) {
  switch (rows) {
    case 4: return clusters<4>(ny, nz, hmax, C, n);
    case 8: return clusters<8>(ny, nz, hmax, C, n);
    case 12: return clusters<12>(ny, nz, hmax, C, n);
    case 16: return clusters<16>(ny, nz, hmax, C, n);
    default: return (int)cudaErrorInvalidValue;
  }
}
