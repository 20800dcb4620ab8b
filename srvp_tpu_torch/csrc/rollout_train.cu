// Training-mode latent rollout for Hopper (sm_90a): forward and backward,
// fp32 on CUDA cores.
//
// Replaces the Pallas TPU kernels of srvp_tpu/ops/pallas/rollout_train.py:
// `_fwd_kernel` (called by `fwd_impl`) and `_bwd_kernel` (`bwd_impl`), tied
// there by jax.custom_vjp and here by kernels/rollout_train.py's
// torch.autograd.Function. Per substep k of K, for each batch row:
//     q_k = hxz_k W_q + b_q
//     z_k = k % o == 0 ? q_k[:nz] + eps_k * (softplus(q_k[nz:]) + 1e-8) : z_{k-1}
//     p_k = p_z(y_k);   r_k = dt * dynamics([y_k, z_k]);   y_{k+1} = y_k + r_k
// p_z and dynamics are pre-activation ReLU MLPs. The forward writes ys, res,
// q, p and z per substep and stashes the hidden pre-activations of both
// MLPs. The backward runs in reverse time, carries dL/dy and the gradient of
// a z reused over the o substeps of a frame, and produces dL/dy_0, dL/dhxz
// and every weight and bias gradient; eps is noise and gets none.
//
// What bounds it on the H100: arithmetic. At the flagship widths a row does
// 1,120,256 multiply-adds per substep (q 256->40, p_z 20->512->512->512->40,
// dynamics 40->512->512->512->20): 4.0 GFLOP forward at B=128, K=14, and
// twice that backward (the input gradients and the weight gradients). What
// held the forward's first design back (one block a tile of R rows, 32
// blocks at B = 128): each block took in all 4.48 MB of weights from L2 on
// every substep, about 90 us a substep at any R (PERF.md).
//
// Design. The TPU kernels pin the weights in VMEM and run the substeps as a
// sequential grid axis with the state in scratch. Here both the forward and
// the carry pass run on rollout.cu's cluster design: one launch, the substep
// loop inside the block, and a thread-block cluster of C blocks sharing a
// tile of R rows (kernels/rollout.py `cluster_plan`; the forward's plan is
// kernels/rollout_train.py `fwd_plan`). Each rank computes its slice of every
// layer's columns from its own packed slice of W and writes it into every
// rank's shared memory, one cluster barrier a layer, so each SM takes in 1/C
// of the weights (4.48 MB at the flagship widths) from L2 a substep.
//  * forward: each rank loads the tile's hxz_k, computes its columns of q
//    (stored to qpar by their owner, pushed to every rank on the substeps
//    that draw z), then p_z and the dynamics: a hidden layer's owner stores
//    the pre-activation of its columns to the stash and pushes their ReLU;
//    p_z's last layer is stored (ppar) and not pushed, the dynamics' last is
//    pushed. Every element of qpar, ppar and the stashes is stored once, by
//    the rank that owns its column. z, the Euler update and y are computed
//    by every rank on the same values; rank 0 stores zs, ys and res;
//  * backward, carry pass: one launch walking the substeps backwards; each
//    rank computes its slice of the columns of every product g W^T (W read in
//    its (out, in) layout, each rank's slice packed contiguously) and writes
//    it into every rank's shared memory, one cluster barrier a layer. A rank
//    reads only its columns of each stashed pre-activation for the ReLU mask
//    and stores only its columns of every layer's output cotangent g_l to
//    device memory (G buffers); dL/dhxz likewise, by columns. The z carry
//    and the reparameterisation gradient are computed per row by every rank
//    on the same values; rank 0 stores g_q, the top layers' cotangents and
//    dL/dy_0. Each SM so takes in 1/C of the weights a substep;
//  * backward, weight-gradient pass: dW_l = sum over the K*B (substep, row)
//    pairs of g_l^T a_{l-1}, db_l = sum g_l. The TPU kernel accumulates dW in
//    VMEM across its sequential grid; on the GPU each tile of a dW is owned
//    by a thread-block cluster whose ranks split its row sum and combine
//    their partials through distributed shared memory in a fixed order:
//    deterministic, no atomics (see train_rollout_wgrad_kernel). a_{l-1} is
//    the layer's input: hxz, [y_k, z_k], or the ReLU of a stashed
//    pre-activation.
// There is no 128-lane padding and no loc/raw repacking of the q head: the
// kernels work on the true widths.

#include <cstdint>

#include "tile_mlp.cuh"

namespace {

// Sum of meta[col] over layers [0, n), a layer's rows `stride` ints apart:
// a width sum of an MLP's layers.
__device__ __forceinline__ int width_sum(const int* meta, int n, int stride,
                                         int col) {
  int s = 0;
  for (int l = 0; l < n; ++l) s += meta[stride * l + col];
  return s;
}

// Writes the tile's [n][R] shared buffer to rows of a (B, ld) slab at column
// offset `off`.
template <int R>
__device__ void store_tile(const float* s, int n, float* dst, int ld, int off,
                           int row0, int B) {
  for (int idx = threadIdx.x; idx < R * n; idx += kThreads) {
    const int r = idx / n, j = idx % n;
    const int row = row0 + r;
    if (row < B) dst[(size_t)row * ld + off + j] = s[j * R + r];
  }
}

// Reads rows of a (B, ld) slab at column offset `off` into an [n][R] shared
// buffer; rows past B read as 0.
template <int R>
__device__ void load_tile(const float* src, int n, int ld, int off, float* s,
                          int row0, int B) {
  for (int idx = threadIdx.x; idx < R * n; idx += kThreads) {
    const int r = idx / n, j = idx % n;
    const int row = row0 + r;
    s[j * R + r] = row < B ? src[(size_t)row * ld + off + j] : 0.0f;
  }
}

// Epilogue that stores 4 rows of column c0 + j to a (B, ld) slab in device
// memory only (rows past B are not stored): the carry pass's dL/dhxz, which
// no later layer reads, and the forward's stores (StorePush).
struct StoreRows {
  float* dst;
  int ld, c0, row0, B;
  __device__ void operator()(int j, int r0, float4 v) const {
    const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + r0 + i;
      if (row < B) dst[(size_t)row * ld + c0 + j] = a[i];
    }
  }
};

// Epilogue of the forward's layers: 4 rows of column c0 + j are stored to a
// (B, ld) slab in device memory (`dst`; null: not stored) as computed, and
// written into `buf` of every rank (null: not pushed), ReLU first when relu.
// So a hidden layer's owner stashes its pre-activation and hands its
// activation on.
template <int R>
struct StorePush {
  float* dst;
  int ld, row0, B;
  float* buf;
  int c0;
  bool relu;
  __device__ void operator()(int j, int r0, float4 v) const {
    if (dst) StoreRows{dst, ld, c0, row0, B}(j, r0, v);
    if (buf) PushAll<R>{buf, c0, relu}(j, r0, v);
  }
};

// Forward MLP over the tile in a cluster of C blocks (meta rows kMeta *
// (l * C + rank)): each rank computes its slice of every layer's columns. A
// hidden layer's epilogue stores the pre-activation of the rank's columns
// to `stash` (row stride s_ld, the layers one after the other) and writes
// their ReLU into buf[nxt] of every rank; then the cluster barrier, and nxt
// alternates, as rollout.cu's mlp. The last layer stores its columns to
// `out` (row stride out_ld) and pushes nothing when out is not null:
// nothing else in the substep reads it, so only the block's barrier follows
// (before `red` is written again) and nxt stays, which keeps the
// alternation sound (the next layer writes the buffer that this MLP's
// second-to-last layer read, before the last barrier). Otherwise the last
// layer is pushed, without ReLU, and the function returns the buffer that
// holds it.
template <int R, int RW>
__device__ const float* mlp_fwd(const float* __restrict__ params,
                                const int* __restrict__ meta, int n,
                                const float* hin, float* const* buf, int& nxt,
                                float* red, float* stash, int s_ld,
                                float* out, int out_ld, int row0, int B,
                                int rank, int C) {
  const float* h = hin;
  int off = 0;
  for (int l = 0; l < n; ++l) {
    const int* m = meta + kMeta * (l * C + rank);
    if (l < n - 1) {
      dense_slice<R, RW>(params, m, h, red,
                         StorePush<R>{stash + off, s_ld, row0, B, buf[nxt],
                                      m[4], true});
      off += m[5];
    } else if (out) {
      dense_slice<R, RW>(params, m, h, red,
                         StorePush<R>{out, out_ld, row0, B, nullptr, m[4],
                                      false});
      __syncthreads();
      return nullptr;
    } else {
      dense_slice<R, RW>(params, m, h, red, PushAll<R>{buf[nxt], m[4], false});
    }
    tile_barrier();
    h = buf[nxt];
    nxt ^= 1;
  }
  return h;
}

template <int R, int RW>
__global__ void __launch_bounds__(kThreads, 1)
train_rollout_fwd_kernel(const float* __restrict__ params,
                         const int* __restrict__ meta, int n_pz, int n_dyn,
                         const float* __restrict__ y0,
                         const float* __restrict__ hxz,
                         const float* __restrict__ eps, float* __restrict__ ys,
                         float* __restrict__ res, float* __restrict__ qpar,
                         float* __restrict__ ppar, float* __restrict__ zs,
                         float* __restrict__ stash_p,
                         float* __restrict__ stash_d, int B, int ny, int nz,
                         int nh_inf, int K, int o, float dt, int hmax) {
  extern __shared__ float4 smem4[];
  float* yz = reinterpret_cast<float*>(smem4);  // [ny + nz][R]: y then z
  float* hx = yz + (ny + nz) * R;               // [nh_inf][R]
  float* q = hx + nh_inf * R;                   // [2 nz][R]
  float* buf[2] = {q + 2 * nz * R,              // [hmax][R] each
                   q + (2 * nz + hmax) * R};
  float* red = buf[1] + hmax * R;               // [4 kThreads][R]
  const int tid = threadIdx.x;
  const int C = cluster_size(), rank = cluster_rank();
  const int row0 = (blockIdx.x / C) * R;
  const int stride = kMeta * C;  // meta rows of one layer
  const int* mq = meta + kMeta * rank;
  const int* meta_p = meta + stride;
  const int* meta_d = meta + stride * (1 + n_pz);
  // stash row widths: every layer's output but the last
  const int sw_p = width_sum(meta_p, n_pz - 1, stride, 5);
  const int sw_d = width_sum(meta_d, n_dyn - 1, stride, 5);
  const int nq = 2 * nz;

  for (int idx = tid; idx < R * (ny + nz); idx += kThreads) {
    const int r = idx / (ny + nz), k = idx % (ny + nz);
    const int row = row0 + r;
    yz[k * R + r] = (k < ny && row < B) ? y0[(size_t)row * ny + k] : 0.0f;
  }
  // every rank has started (its shared memory exists) before any rank
  // writes into it
  tile_barrier();

  int nxt = 0;
  for (int t = 0; t < K; ++t) {
    const size_t step = (size_t)t * B;
    const bool draw = t % o == 0;
    // q head: the rank's columns of q_t, stored; pushed to every rank only
    // when z is drawn from them (the cluster barrier then follows)
    if (mq[1] > 0) {
      load_tile<R>(hxz + step * nh_inf, nh_inf, nh_inf, 0, hx, row0, B);
      __syncthreads();
    }
    dense_slice<R, RW>(params, mq, hx, red,
                       StorePush<R>{qpar + step * nq, nq, row0, B,
                                    draw ? q : nullptr, mq[4], false});
    if (draw) {
      tile_barrier();
      // every rank draws z for the whole tile, on the same values
      for (int idx = tid; idx < R * nz; idx += kThreads) {
        const int r = idx / nz, k = idx % nz;
        const int row = row0 + r;
        const float e = row < B ? eps[(step + row) * nz + k] : 0.0f;
        yz[(ny + k) * R + r] =
            q[k * R + r] + e * (softplus(q[(nz + k) * R + r]) + 1e-8f);
      }
    }
    __syncthreads();
    if (rank == 0)
      store_tile<R>(yz + ny * R, nz, zs + step * nz, nz, 0, row0, B);

    mlp_fwd<R, RW>(params, meta_p, n_pz, yz, buf, nxt, red,
                   stash_p + step * sw_p, sw_p, ppar + step * nq, nq, row0,
                   B, rank, C);
    const float* rr = mlp_fwd<R, RW>(params, meta_d, n_dyn, yz, buf, nxt,
                                     red, stash_d + step * sw_d, sw_d,
                                     nullptr, 0, row0, B, rank, C);
    for (int idx = tid; idx < R * ny; idx += kThreads) {
      const int r = idx / ny, k = idx % ny;
      const int row = row0 + r;
      const float rv = dt * rr[k * R + r];
      const float y = yz[k * R + r] + rv;
      yz[k * R + r] = y;
      if (rank == 0 && row < B) {
        ys[(step + row) * ny + k] = y;
        res[(step + row) * ny + k] = rv;
      }
    }
    __syncthreads();
  }
  // the last write into another rank's shared memory (the dynamics' last
  // layer) came before the last cluster barrier, so every rank may exit now
}

// Epilogue of a hidden layer's backward product in the carry pass: 4 rows of
// column c0 + j of the input cotangent are masked by ReLU' of the stashed
// pre-activation of the layer below (this rank's columns only), stored to G
// as that layer's output cotangent, and written into `dst` of every rank.
template <int R>
struct MaskStorePush {
  float* dst;
  int c0;
  const float* stash;  // the layer below's pre-activation column 0
  int s_ld;
  float* G;            // its output cotangent's column 0
  int g_ld, row0, B;
  __device__ void operator()(int j, int r0, float4 v) const {
    const int col = c0 + j;
    float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + r0 + i;
      const float h = row < B ? stash[(size_t)row * s_ld + col] : 0.0f;
      if (!(h > 0.0f)) a[i] = 0.0f;
      if (row < B) G[(size_t)row * g_ld + col] = a[i];
    }
    PushAll<R>{dst, c0, false}(j, r0, make_float4(a[0], a[1], a[2], a[3]));
  }
};

// Backward through an MLP over the tile, in a cluster of C blocks. `meta`
// rows (kMeta per layer and rank) are the backward ones: layer l's product
// is g W_l with W_l in its (out, in) layout, so din = the layer's output
// width and the rank's slice is of its input columns. On entry `g` holds
// the top layer's output cotangent in every rank (stored to G by the
// caller). Each rank computes its slice of every layer's input cotangent;
// for l > 0 the epilogue masks it with ReLU' of the stashed pre-activation,
// stores it to G (row stride g_ld, layers one after the other) and writes it
// into the other buffer of every rank; layer 0's lands in `gin` of every
// rank. One cluster barrier a layer; the buffers alternate, so no rank
// writes a buffer a peer is still reading. `g` and `other` are clobbered.
template <int R, int RW>
__device__ void mlp_bwd(const float* __restrict__ params,
                        const int* __restrict__ meta, int n, float* g,
                        float* other, float* gin, float* red,
                        const float* __restrict__ stash, int s_ld, float* G,
                        int g_ld, int row0, int B, int rank, int C) {
  float* cur = g;
  for (int l = n - 1; l >= 0; --l) {
    const int* m = meta + kMeta * (l * C + rank);
    if (l > 0) {
      // layer l - 1's output is stashed and stored at this column
      const int off = width_sum(meta, l, kMeta * C, 0) - m[5];
      dense_slice<R, RW>(params, m, cur, red,
                         MaskStorePush<R>{other, m[4], stash + off, s_ld,
                                          G + off, g_ld, row0, B});
      tile_barrier();
      float* t = cur;
      cur = other;
      other = t;
    } else {
      dense_slice<R, RW>(params, m, cur, red, PushAll<R>{gin, m[4], false});
      tile_barrier();
    }
  }
}

template <int R, int RW>
__global__ void __launch_bounds__(kThreads, 1)
train_rollout_bwd_carry_kernel(
    const float* __restrict__ params, const int* __restrict__ meta, int n_pz,
    int n_dyn, const float* __restrict__ eps, const float* __restrict__ qpar,
    const float* __restrict__ stash_p, const float* __restrict__ stash_d,
    const float* __restrict__ cot_ys, const float* __restrict__ cot_res,
    const float* __restrict__ cot_qpar, const float* __restrict__ cot_ppar,
    const float* __restrict__ cot_zs, float* __restrict__ g_q,
    float* __restrict__ g_pz, float* __restrict__ g_dyn,
    float* __restrict__ g_y0, float* __restrict__ g_hxz, int B, int ny,
    int nz, int nh_inf, int K, int o, float dt, int hmax) {
  extern __shared__ float4 smem4[];
  float* gy = reinterpret_cast<float*>(smem4);  // [ny][R] dL/dy carried
  float* gz = gy + ny * R;                      // [nz][R] reused-z carry
  float* gyz = gz + nz * R;                     // [ny + nz][R]
  float* gyp = gyz + (ny + nz) * R;             // [ny][R]
  float* gq = gyp + ny * R;                     // [2 nz][R]
  float* bufA = gq + 2 * nz * R;                // [hmax][R]
  float* bufB = bufA + hmax * R;                // [hmax][R]
  float* red = bufB + hmax * R;                 // [4 kThreads][R]
  const int tid = threadIdx.x;
  const int C = cluster_size(), rank = cluster_rank();
  const int row0 = (blockIdx.x / C) * R;
  const int stride = kMeta * C;  // meta rows of one layer
  const int* meta_p = meta + stride;
  const int* meta_d = meta + stride * (1 + n_pz);
  const int sw_p = width_sum(meta_p, n_pz - 1, stride, 0);
  const int sw_d = width_sum(meta_d, n_dyn - 1, stride, 0);
  const int gw_p = width_sum(meta_p, n_pz, stride, 0);
  const int gw_d = width_sum(meta_d, n_dyn, stride, 0);
  const int nq = 2 * nz;

  for (int idx = tid; idx < R * (ny + nz); idx += kThreads) gy[idx] = 0.0f;
  // every rank has started (its shared memory exists) before any rank
  // writes into it
  tile_barrier();

  for (int k = K - 1; k >= 0; --k) {
    const size_t step = (size_t)k * B;
    __syncthreads();
    // y_{k+1} = y_k + res_k and res_k = dt * dynamics(...): the dynamics
    // output cotangent is dt * (dL/dres_k + dL/dy_{k+1})
    for (int idx = tid; idx < R * ny; idx += kThreads) {
      const int r = idx / ny, j = idx % ny;
      const int row = row0 + r;
      float c_ys = 0.0f, c_res = 0.0f;
      if (row < B) {
        c_ys = cot_ys[(step + row) * ny + j];
        c_res = cot_res[(step + row) * ny + j];
      }
      const float g1 = gy[j * R + r] + c_ys;
      gy[j * R + r] = g1;
      bufA[j * R + r] = dt * (c_res + g1);
    }
    __syncthreads();
    if (rank == 0)
      store_tile<R>(bufA, ny, g_dyn + step * gw_d, gw_d, gw_d - ny, row0, B);
    mlp_bwd<R, RW>(params, meta_d, n_dyn, bufA, bufB, gyz, red,
               stash_d + step * sw_d, sw_d, g_dyn + step * gw_d, gw_d, row0,
               B, rank, C);

    // z_k: its gradient from the dynamics, from the returned zs, and the one
    // carried from later substeps that reused it. A substep that drew z
    // passes it to q through the reparameterisation; one that reused z
    // carries it to the substep before. Every rank does this for the whole
    // tile, on the same values.
    const bool is_new = k % o == 0;
    for (int idx = tid; idx < R * nz; idx += kThreads) {
      const int r = idx / nz, j = idx % nz;
      const int row = row0 + r;
      float gl = 0.0f, gr = 0.0f, carry = 0.0f;
      if (row < B) {
        const size_t iz = (step + row) * nz + j;
        const size_t iq = (step + row) * nq + j;
        const float gzt = gyz[(ny + j) * R + r] + gz[j * R + r] + cot_zs[iz];
        if (is_new) {
          const float raw = qpar[iq + nz];
          gl = gzt;
          gr = gzt * eps[iz] * (1.0f / (1.0f + expf(-raw)));
        } else {
          carry = gzt;
        }
        gl += cot_qpar[iq];
        gr += cot_qpar[iq + nz];
      }
      gq[j * R + r] = gl;
      gq[(nz + j) * R + r] = gr;
      gz[j * R + r] = carry;
    }
    __syncthreads();
    if (rank == 0) store_tile<R>(gq, nq, g_q + step * nq, nq, 0, row0, B);
    // dL/dhxz: each rank its columns, straight to device memory
    const int* mq = meta + kMeta * rank;
    dense_slice<R, RW>(params, mq, gq, red,
                       StoreRows{g_hxz + step * nh_inf, nh_inf, mq[4], row0,
                                 B});
    __syncthreads();

    load_tile<R>(cot_ppar + step * nq, nq, nq, 0, bufA, row0, B);
    __syncthreads();
    if (rank == 0)
      store_tile<R>(bufA, nq, g_pz + step * gw_p, gw_p, gw_p - nq, row0, B);
    mlp_bwd<R, RW>(params, meta_p, n_pz, bufA, bufB, gyp, red,
               stash_p + step * sw_p, sw_p, g_pz + step * gw_p, gw_p, row0,
               B, rank, C);
    for (int idx = tid; idx < R * ny; idx += kThreads)
      gy[idx] = (gy[idx] + gyz[idx]) + gyp[idx];
  }
  __syncthreads();
  if (rank == 0) store_tile<R>(gy, ny, g_y0, ny, 0, row0, B);
  // the last write into another rank's shared memory came before the last
  // cluster barrier, so every rank may exit now
}

// Weight-gradient pass: the `dW += a^T g`, `db += sum g` of `_bwd_kernel`
// (srvp_tpu/ops/pallas/rollout_train.py:71-72, :226-228), which sums every
// dW in VMEM across its sequential grid. Job j (int32 row of kJobW) is one
// linear layer:
//   {a_src, a_ld, a_off, a_relu, g_src, g_ld, g_off, w_off, b_off, din,
//    dout, tile0, TO, TI}
// dW (dout, din) row-major at grads + w_off, db (dout) at grads + b_off,
// dW[o][i] = sum_n G[n][g_off + o] * act(A[n][a_off + i]), db[o] = sum_n
// G[n][g_off + o], over the N = K*B (substep, row) pairs; act is the ReLU
// when a_relu (a stashed pre-activation), else the identity. The job's
// tiles are TO x TI, numbered from tile0, row-major over (o, i).
//
// What bounds it on the H100: operations, 2 N x (the layers' MACs) fp32
// FLOPs over the CUDA cores' 67 TFLOP/s: 4.0 GFLOP, 0.060 ms at dcgan's
// B = 128, K = 14, and 9.3 GFLOP, 0.139 ms at KTH's B = 100, K = 38; the
// bytes (each input read once) take a quarter of that. The first design
// (a block a 64 x 64 tile summing all N rows, one stage prefetched through
// registers) ran at a fifth of that rate: 292 small tiles for 132 SMs (a
// short tail wave, the thin layers' tiles mostly padding), 2 shared loads
// for every 16 FMAs, one stage in flight and two barriers a stage.
//
// Design.
//  * Tiles of kWgArea = 8192 outputs, 8 (o) x 4 (i) a thread: 128 x 64 on
//    the wide layers (3 16-byte shared loads for 32 FMAs a row), and
//    256 x 32, 64 x 128 or 32 x 256 where a layer is thin, the shape of
//    fewest tiles (kernels/rollout_train.py `wgrad_tiles`), so that no thin
//    layer's block is more than half padding. A thread keeps its 32 sums
//    and a chunk's 32 partial sums in registers and the sums' Kahan
//    compensations in shared memory: two blocks an SM at 128 registers,
//    4 bytes spilled (with the compensations in registers, far more).
//  * A thread-block cluster of S blocks shares a tile and splits its row
//    sum: rank s sums chunks [s NC / S, (s + 1) NC / S) of the NC =
//    ceil(N / kTK) chunks of kTK rows, in order: FMAs within a chunk, the
//    chunks Kahan-summed, so that a 3,800-term sum that cancels keeps the
//    accuracy of a library GEMM's blocked sums. Each rank leaves its
//    partial tile (sum and compensation) in shared memory; after the
//    cluster barrier each rank combines its 1/S of the tile from the S
//    partials, read through distributed shared memory in rank order
//    0..S-1, and writes that part of dW and db. No second launch, no
//    workspace, no atomics: the same bits every launch. S is the plan's
//    (`wgrad_plan`, from the card's cluster occupancy).
//  * The rows reach shared memory through a ring of kWgStages stages of kTK
//    rows of G and A by cp.async (16 bytes a copy where the source's rows
//    are 16-byte aligned, else 4), one block barrier a stage; rows past N
//    and columns past the layer's width are filled with 0, and no chunk
//    starts past N. Each thread applies the ReLU to the stash values it
//    copied once they land, before the barrier.
//  * db is summed on the tiles at i0 = 0, from the staged G: each column
//    by 256 / TO threads, each taking every (256 / TO)-th row of a chunk.
// (A 3xTF32 version on the tensor cores ran 2.3x faster and missed the
// gradients' tolerance on KTH's q head: PERF.md.)
constexpr int kJobW = 14;

// sum += x with Kahan's compensation c: the error of a long fp32 sum stays
// near one rounding instead of growing with its length (nvcc keeps the
// order: no fast-math flags).
__device__ __forceinline__ void kahan_add(float& sum, float& c, float x) {
  const float y = x - c;
  const float t = sum + y;
  c = (t - sum) - y;
  sum = t;
}

constexpr int kWgThreads = 256;
// blocks an SM that the register budget is set for (ptxas: at most
// 65536 / (256 * 2) = 128 registers a thread)
constexpr int kWgMinBlocks = 2;
constexpr int kTK = 16;                       // rows a chunk and a stage
constexpr int kWgStages = 4;
constexpr int kWgArea = kWgThreads * 8 * 4;   // outputs a tile
constexpr int kWgRowMax = 288;                // TO + TI of the thin shapes
constexpr int kWgRing = kWgStages * kTK * kWgRowMax;  // floats
// the ring, the bias partials (sums and compensations), and the Kahan
// compensations of every thread's 32 sums (in shared memory, so that the
// sums, the chunk's partial sums and a row's operands fit 128 registers)
constexpr size_t kWgSmem =
    sizeof(float) * (kWgRing + 2 * kWgThreads + 32 * kWgThreads);
static_assert(2 * kWgArea <= kWgRing, "the partial tiles reuse the ring");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// (the memory clobber keeps the reads of the landed copies after the wait)
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Copies rows [n, n + kTK) of the W columns [c0, c0 + W) of `src` (row
// stride ld) into dst ([kTK][W]), V floats a copy (V = 4: 16-byte copies,
// every row of src 16-byte aligned); columns at or past `width` and rows at
// or past N are filled with 0. W / V divides kWgThreads, so a thread copies
// the same columns of every row it copies (see relu_own).
template <int W, int V>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int ld, int c0, int width, int n,
                                           int N) {
  constexpr int kPerRow = W / V;
  constexpr int kCopies = kTK * kPerRow;
  const int tid = threadIdx.x;
  const int c = (tid % kPerRow) * V;
  const int cols = min(max(width - (c0 + c), 0), V);
#pragma unroll
  for (int q = 0; q < (kCopies + kWgThreads - 1) / kWgThreads; ++q) {
    const int e = tid + q * kWgThreads;
    if (kCopies % kWgThreads != 0 && e >= kCopies) break;
    const int r = e / kPerRow;
    const int row = n + r;
    const int bytes = row < N ? 4 * cols : 0;
    const float* s = bytes ? src + (size_t)row * ld + c0 + c : src;
    if constexpr (V == 4)
      cp_async16(dst + r * W + c, s, bytes);
    else
      cp_async4(dst + r * W + c, s, bytes);
  }
}

// ReLU, in place, of the values this thread copied into dst by
// stage_rows<W, V> (visible to it once its copies have landed).
template <int W, int V>
__device__ __forceinline__ void relu_own(float* dst) {
  constexpr int kPerRow = W / V;
  constexpr int kCopies = kTK * kPerRow;
  const int tid = threadIdx.x;
  const int c = (tid % kPerRow) * V;
#pragma unroll
  for (int q = 0; q < (kCopies + kWgThreads - 1) / kWgThreads; ++q) {
    const int e = tid + q * kWgThreads;
    if (kCopies % kWgThreads != 0 && e >= kCopies) break;
    float* p = dst + (e / kPerRow) * W + c;
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(p) = relu4(*reinterpret_cast<float4*>(p));
    else
      *p = fmaxf(*p, 0.0f);
  }
}

// One job's sources and outputs: A and G at the job's column offsets.
struct WgJob {
  const float* A;
  const float* G;
  int a_ld, g_ld, din, dout, relu;
  float* dW;
  float* db;
};

// The rank's part of the TO x TI tile at (o0, i0) of job jb: its row sum,
// then, after the cluster barrier, its 1/S of the tile combined from every
// rank's partial.
template <int TO, int TI>
__device__ void wgrad_tile(const WgJob& jb, float* smem, int o0, int i0,
                           int N, int rank, int S) {
  constexpr int kRow = TO + TI;
  constexpr int TX = TI / 4;           // threads along i
  constexpr int P = kWgThreads / TO;   // threads summing a column of db
  static_assert((TO / 8) * TX == kWgThreads, "8 x 4 outputs a thread");
  static_assert(kRow <= kWgRowMax && TO * TI == kWgArea, "tile shape");
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const bool g_vec =
      ((reinterpret_cast<uintptr_t>(jb.G) & 15) | (jb.g_ld & 3)) == 0;
  const bool a_vec =
      ((reinterpret_cast<uintptr_t>(jb.A) & 15) | (jb.a_ld & 3)) == 0;
  const bool bias = i0 == 0;
  const int n_chunks = (N + kTK - 1) / kTK;
  const int c_begin = (int)((long long)n_chunks * rank / S);
  const int n_mine = (int)((long long)n_chunks * (rank + 1) / S) - c_begin;

  auto stage = [&](int k) { return smem + (k % kWgStages) * (kTK * kRow); };
  auto load = [&](int k) {
    float* st = stage(k);
    const int n = (c_begin + k) * kTK;
    if (g_vec)
      stage_rows<TO, 4>(st, jb.G, jb.g_ld, o0, jb.dout, n, N);
    else
      stage_rows<TO, 1>(st, jb.G, jb.g_ld, o0, jb.dout, n, N);
    if (a_vec)
      stage_rows<TI, 4>(st + kTK * TO, jb.A, jb.a_ld, i0, jb.din, n, N);
    else
      stage_rows<TI, 1>(st + kTK * TO, jb.A, jb.a_ld, i0, jb.din, n, N);
  };

  // the sums in registers, their compensations in shared memory: a float4
  // a row of 4 outputs, [8][kWgThreads]
  float acc[8][4];
  float4* comp = reinterpret_cast<float4*>(smem + kWgRing + 2 * kWgThreads);
#pragma unroll
  for (int x = 0; x < 8; ++x) {
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = 0.0f;
    comp[x * kWgThreads + tid] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float db = 0.0f, db_comp = 0.0f;
  const int ob = tid % TO, pb = tid / TO;   // this thread's db column, rows

  // a group a stage, empty ones too, so that the wait below counts stages
#pragma unroll
  for (int k = 0; k < kWgStages - 1; ++k) {
    if (k < n_mine) load(k);
    cp_async_commit();
  }
  for (int k = 0; k < n_mine; ++k) {
    cp_async_wait<kWgStages - 2>();     // this thread's copies of chunk k
    const float* gs = stage(k);
    const float* as = gs + kTK * TO;
    if (jb.relu) {
      if (a_vec)
        relu_own<TI, 4>(stage(k) + kTK * TO);
      else
        relu_own<TI, 1>(stage(k) + kTK * TO);
    }
    __syncthreads();
    // the slot of chunk k - 1, which every thread has finished
    if (k + kWgStages - 1 < n_mine) load(k + kWgStages - 1);
    cp_async_commit();
    // row kk's 8 G and 4 A values into part: a product on the chunk's
    // first row, FMAs on the others
    float part[8][4];
    auto row = [&](int kk, bool first) {
      const float4 g0 =
          *reinterpret_cast<const float4*>(gs + kk * TO + ty * 8);
      const float4 g1 =
          *reinterpret_cast<const float4*>(gs + kk * TO + ty * 8 + 4);
      const float4 av =
          *reinterpret_cast<const float4*>(as + kk * TI + tx * 4);
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float a[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y)
          part[x][y] = first ? g[x] * a[y] : fmaf(g[x], a[y], part[x][y]);
    };
    row(0, true);
#pragma unroll
    for (int kk = 1; kk < kTK; ++kk) row(kk, false);
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      float4 c = comp[x * kWgThreads + tid];
      kahan_add(acc[x][0], c.x, part[x][0]);
      kahan_add(acc[x][1], c.y, part[x][1]);
      kahan_add(acc[x][2], c.z, part[x][2]);
      kahan_add(acc[x][3], c.w, part[x][3]);
      comp[x * kWgThreads + tid] = c;
    }
    if (bias) {
      float dpart = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kTK / P; ++kk) dpart += gs[(pb + kk * P) * TO + ob];
      kahan_add(db, db_comp, dpart);
    }
  }
  cp_async_wait<0>();   // (only empty groups can be left)
  __syncthreads();      // every thread is done with the ring

  // the partial tile: [TO][TI] sums, then [TO][TI] compensations; the bias
  // partials [P][TO] likewise, after the ring
  float* red = smem;
  float* bred = smem + kWgRing;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    float* p = red + (ty * 8 + x) * TI + tx * 4;
    *reinterpret_cast<float4*>(p) =
        make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
    *reinterpret_cast<float4*>(p + kWgArea) = comp[x * kWgThreads + tid];
  }
  if (bias) {
    bred[pb * TO + ob] = db;
    bred[kWgThreads + pb * TO + ob] = db_comp;
  }
  tile_barrier();

  cg::cluster_group cluster = cg::this_cluster();
  auto peer = [&](const float* p, int s) {
    return S == 1 ? p : static_cast<const float*>(cluster.map_shared_rank(
                            const_cast<float*>(p), s));
  };
  // this rank's groups of 4 outputs, [rank * per, (rank + 1) * per): the
  // compensations summed first, then the sums Kahan-added, rank by rank
  const int per = kWgArea / 4 / S;
  for (int e4 = tid; e4 < per; e4 += kWgThreads) {
    const int e = (rank * per + e4) * 4;
    const int o = o0 + e / TI, i = i0 + e % TI;
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = 0; s < S; ++s) {
      const float4 v =
          *reinterpret_cast<const float4*>(peer(red + kWgArea + e, s));
      c[0] += v.x;
      c[1] += v.y;
      c[2] += v.z;
      c[3] += v.w;
    }
    for (int s = 0; s < S; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(peer(red + e, s));
      kahan_add(sum[0], c[0], v.x);
      kahan_add(sum[1], c[1], v.y);
      kahan_add(sum[2], c[2], v.z);
      kahan_add(sum[3], c[3], v.w);
    }
    if (o < jb.dout) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (i + b < jb.din) jb.dW[(size_t)o * jb.din + i + b] = sum[b];
    }
  }
  if (bias) {
    const int per_o = TO / S;
    for (int t = tid; t < per_o; t += kWgThreads) {
      const int o = rank * per_o + t;
      float c = 0.0f, sum = 0.0f;
      for (int s = 0; s < S; ++s)
        for (int q = 0; q < P; ++q)
          c += peer(bred + kWgThreads + q * TO + o, s)[0];
      for (int s = 0; s < S; ++s)
        for (int q = 0; q < P; ++q)
          kahan_add(sum, c, peer(bred + q * TO + o, s)[0]);
      if (o0 + o < jb.dout) jb.db[o0 + o] = sum;
    }
  }
  // no rank exits while a peer may still read its shared memory
  tile_barrier();
}

__global__ void __launch_bounds__(kWgThreads, kWgMinBlocks)
train_rollout_wgrad_kernel(const int* __restrict__ jobs, int n_jobs,
                           const float* __restrict__ a0,
                           const float* __restrict__ a1,
                           const float* __restrict__ a2,
                           const float* __restrict__ a3,
                           const float* __restrict__ g0,
                           const float* __restrict__ g1,
                           const float* __restrict__ g2,
                           float* __restrict__ grads, int N) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int S = cluster_size(), rank = cluster_rank();
  const int tile = blockIdx.x / S;
  int j = 0;
  while (j + 1 < n_jobs && tile >= jobs[(j + 1) * kJobW + 11]) ++j;
  const int* job = jobs + j * kJobW;
  const float* A = job[0] == 0 ? a0 : job[0] == 1 ? a1 : job[0] == 2 ? a2 : a3;
  const float* G = job[4] == 0 ? g0 : job[4] == 1 ? g1 : g2;
  const WgJob jb{A + job[2], G + job[6], job[1],        job[5],
                 job[9],     job[10],    job[3],        grads + job[7],
                 grads + job[8]};
  const int TO = job[12], TI = job[13];
  const int tiles_i = (jb.din + TI - 1) / TI;
  const int t = tile - job[11];
  const int o0 = (t / tiles_i) * TO, i0 = (t % tiles_i) * TI;
  switch (TO) {
    case 256: wgrad_tile<256, 32>(jb, smem, o0, i0, N, rank, S); break;
    case 128: wgrad_tile<128, 64>(jb, smem, o0, i0, N, rank, S); break;
    case 64: wgrad_tile<64, 128>(jb, smem, o0, i0, N, rank, S); break;
    default: wgrad_tile<32, 256>(jb, smem, o0, i0, N, rank, S); break;
  }
}

// the cluster sizes the weight-gradient pass takes: S divides the tile's
// kWgArea / 4 groups of outputs, and at most 16 blocks (non-portable)
inline bool wgrad_split_ok(int S) {
  return S >= 1 && S <= 16 && (kWgArea / 4) % S == 0;
}

template <int R>
size_t fwd_smem(int ny, int nz, int nh_inf, int hmax) {
  const size_t need = sizeof(float) * R *
                      (ny + nz + nh_inf + 2 * nz + 2 * hmax + 4 * kThreads);
  return need > kOneBlockSmem ? need : kOneBlockSmem;
}

template <int R>
size_t bwd_smem(int ny, int nz, int hmax) {
  const size_t need = sizeof(float) * R *
                      (ny + nz + (ny + nz) + ny + 2 * nz + 2 * hmax +
                       4 * kThreads);
  return need > kOneBlockSmem ? need : kOneBlockSmem;
}

// the forward's instance for clusters of C blocks (tile_mlp.cuh row_tile)
template <int R>
auto fwd_kernel_for(int C) {
  return C > 1 ? train_rollout_fwd_kernel<R, row_tile<R>(true)>
               : train_rollout_fwd_kernel<R, row_tile<R>(false)>;
}

template <int R>
cudaError_t launch_fwd(const float* params, const int* meta, int n_pz,
                       int n_dyn, const float* y0, const float* hxz,
                       const float* eps, float* ys, float* res, float* qpar,
                       float* ppar, float* zs, float* stash_p, float* stash_d,
                       int B, int ny, int nz, int nh_inf, int K, int o,
                       int hmax, int C, cudaStream_t stream) {
  const size_t smem = fwd_smem<R>(ny, nz, nh_inf, hmax);
  cudaError_t err = prepare_cluster_kernel(fwd_kernel_for<R>(C), smem, C);
  if (err != cudaSuccess) return err;
  return launch_cluster(fwd_kernel_for<R>(C), (B + R - 1) / R * C, C, smem,
                        stream, params, meta, n_pz, n_dyn, y0, hxz, eps, ys,
                        res, qpar, ppar, zs, stash_p, stash_d, B, ny, nz,
                        nh_inf, K, o, 1.0f / (float)o, hmax);
}

template <int R>
cudaError_t fwd_clusters(int ny, int nz, int nh_inf, int hmax, int C,
                         int* n) {
  return max_active_clusters(fwd_kernel_for<R>(C), C,
                             fwd_smem<R>(ny, nz, nh_inf, hmax), n);
}

// the carry pass's instance for clusters of C blocks (tile_mlp.cuh
// row_tile)
template <int R>
auto carry_kernel_for(int C) {
  return C > 1 ? train_rollout_bwd_carry_kernel<R, row_tile<R>(true)>
               : train_rollout_bwd_carry_kernel<R, row_tile<R>(false)>;
}

template <int R>
cudaError_t launch_bwd(const float* params, const int* meta, int n_pz,
                       int n_dyn, const float* eps, const float* qpar,
                       const float* stash_p, const float* stash_d,
                       const float* cot_ys, const float* cot_res,
                       const float* cot_qpar, const float* cot_ppar,
                       const float* cot_zs, float* g_q, float* g_pz,
                       float* g_dyn, float* g_y0, float* g_hxz, int B, int ny,
                       int nz, int nh_inf, int K, int o, int hmax, int C,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem<R>(ny, nz, hmax);
  cudaError_t err = prepare_cluster_kernel(carry_kernel_for<R>(C), smem, C);
  if (err != cudaSuccess) return err;
  return launch_cluster(carry_kernel_for<R>(C), (B + R - 1) / R * C,
                        C, smem, stream, params, meta, n_pz, n_dyn, eps, qpar,
                        stash_p, stash_d, cot_ys, cot_res, cot_qpar, cot_ppar,
                        cot_zs, g_q, g_pz, g_dyn, g_y0, g_hxz, B, ny, nz,
                        nh_inf, K, o, 1.0f / (float)o, hmax);
}

template <int R>
cudaError_t bwd_clusters(int ny, int nz, int hmax, int C, int* n) {
  return max_active_clusters(carry_kernel_for<R>(C), C,
                             bwd_smem<R>(ny, nz, hmax), n);
}

}  // namespace

#define F(x) static_cast<float*>(x)
#define CF(x) static_cast<const float*>(x)

// C entry points, bound with ctypes. Every tensor is fp32 (int32 for meta and
// jobs), contiguous and on the device. The launches run on `stream`.
//
// Forward. params: every rank's slice of every layer's W^T (in, out) and
// bias, q first, then p_z, then dynamics, packed by kernels/rollout.py;
// meta: int32 {din, width, w_off, b_off, c0, dout} per (layer, rank) in that
// order. y0 (B, ny), hxz (K, B, nh_inf), eps (K, B, nz); outputs ys, res
// (K, B, ny), qpar, ppar (K, B, 2 nz), zs (K, B, nz), stash_p / stash_d (K,
// B, sum of the hidden widths). hmax is the widest layer output; rows (R)
// is 4, 8, 12 or 16; C (blocks a cluster) 1, 2, 4, 8 or 16. Returns the
// launch's cudaError_t (0 on success).
extern "C" int srvp_train_rollout_fwd(
    const void* params, const void* meta, int n_pz, int n_dyn,
    const void* y0, const void* hxz, const void* eps, void* ys, void* res,
    void* qpar, void* ppar, void* zs, void* stash_p, void* stash_d, int B,
    int ny, int nz, int nh_inf, int K, int o, int hmax, int rows, int C,
    void* stream) {
  const float* p = CF(params);
  const int* m = static_cast<const int*>(meta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_FWD(R)                                                        \
  launch_fwd<R>(p, m, n_pz, n_dyn, CF(y0), CF(hxz), CF(eps), F(ys), F(res), \
                F(qpar), F(ppar), F(zs), F(stash_p), F(stash_d), B, ny, nz, \
                nh_inf, K, o, hmax, C, s)
  switch (rows) {
    case 4: return LAUNCH_FWD(4);
    case 8: return LAUNCH_FWD(8);
    case 12: return LAUNCH_FWD(12);
    case 16: return LAUNCH_FWD(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH_FWD
}

// Clusters of the forward (C blocks of `rows` rows, shared memory for ny,
// nz, nh_inf and hmax) that the card holds at once, in *n; 0 if they cannot
// be scheduled. Returns a cudaError_t.
extern "C" int srvp_train_rollout_fwd_clusters(int ny, int nz, int nh_inf,
                                               int hmax, int rows, int C,
                                               int* n) {
  switch (rows) {
    case 4: return fwd_clusters<4>(ny, nz, nh_inf, hmax, C, n);
    case 8: return fwd_clusters<8>(ny, nz, nh_inf, hmax, C, n);
    case 12: return fwd_clusters<12>(ny, nz, nh_inf, hmax, C, n);
    case 16: return fwd_clusters<16>(ny, nz, nh_inf, hmax, C, n);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Backward carry pass. params: every rank's slice of the same layers with
// W in (out, in) layout and no bias, packed by kernels/rollout.py; meta:
// {din, width, w_off, -1, c0, dout} per (layer, rank) of the products g W.
// Inputs: the forward's eps, qpar and stashes, and the cotangents of its
// five outputs. Outputs: g_q (K, B, 2 nz), g_pz / g_dyn (K, B, sum of the
// layer widths): every layer's output cotangent; g_y0 (B, ny); g_hxz (K, B,
// nh_inf). hmax is the widest layer input or output; rows (R) is 4, 8, 12
// or 16; C (blocks a cluster) 1, 2, 4, 8 or 16.
extern "C" int srvp_train_rollout_bwd(
    const void* params, const void* meta, int n_pz, int n_dyn,
    const void* eps, const void* qpar, const void* stash_p,
    const void* stash_d, const void* cot_ys, const void* cot_res,
    const void* cot_qpar, const void* cot_ppar, const void* cot_zs,
    void* g_q, void* g_pz, void* g_dyn, void* g_y0, void* g_hxz, int B,
    int ny, int nz, int nh_inf, int K, int o, int hmax, int rows, int C,
    void* stream) {
  const float* p = CF(params);
  const int* m = static_cast<const int*>(meta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_BWD(R)                                                          \
  launch_bwd<R>(p, m, n_pz, n_dyn, CF(eps), CF(qpar), CF(stash_p),            \
                CF(stash_d), CF(cot_ys), CF(cot_res), CF(cot_qpar),           \
                CF(cot_ppar), CF(cot_zs), F(g_q), F(g_pz), F(g_dyn), F(g_y0), \
                F(g_hxz), B, ny, nz, nh_inf, K, o, hmax, C, s)
  switch (rows) {
    case 4: return LAUNCH_BWD(4);
    case 8: return LAUNCH_BWD(8);
    case 12: return LAUNCH_BWD(12);
    case 16: return LAUNCH_BWD(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH_BWD
}

// Clusters of the carry pass (C blocks of `rows` rows, shared memory for
// ny, nz and hmax) that the card holds at once, in *n; 0 if they cannot be
// scheduled. Returns a cudaError_t.
extern "C" int srvp_train_rollout_bwd_clusters(int ny, int nz, int hmax,
                                               int rows, int C, int* n) {
  switch (rows) {
    case 4: return bwd_clusters<4>(ny, nz, hmax, C, n);
    case 8: return bwd_clusters<8>(ny, nz, hmax, C, n);
    case 12: return bwd_clusters<12>(ny, nz, hmax, C, n);
    case 16: return bwd_clusters<16>(ny, nz, hmax, C, n);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Backward weight-gradient pass: n_jobs rows of jobs (see the kernel),
// n_tiles tiles in all, each summed by a cluster of S blocks (1, 2, 4, 8 or
// 16); A sources a0..a3 and G sources g0..g2 (K*B = N rows each); grads
// receives every dW and db.
extern "C" int srvp_train_rollout_wgrad(
    const void* jobs, int n_jobs, int n_tiles, const void* a0,
    const void* a1, const void* a2, const void* a3, const void* g0,
    const void* g1, const void* g2, void* grads, int N, int S,
    void* stream) {
  if (!wgrad_split_ok(S)) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      prepare_cluster_kernel(train_rollout_wgrad_kernel, kWgSmem, S);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_cluster_of(
      train_rollout_wgrad_kernel, n_tiles * S, kWgThreads, S, kWgSmem,
      static_cast<cudaStream_t>(stream), static_cast<const int*>(jobs),
      n_jobs, CF(a0), CF(a1), CF(a2), CF(a3), CF(g0), CF(g1), CF(g2),
      F(grads), N);
}

// The weight-gradient pass's occupancy: clusters of S blocks that the card
// holds at once in *clusters (0 for an S the kernel does not take), and its
// blocks an SM in *blocks_per_sm. Returns a cudaError_t.
extern "C" int srvp_train_rollout_wgrad_occupancy(int S, int* clusters,
                                                  int* blocks_per_sm) {
  *clusters = 0;
  *blocks_per_sm = 0;
  if (!wgrad_split_ok(S)) return (int)cudaSuccess;
  cudaError_t err = max_active_clusters(train_rollout_wgrad_kernel, S,
                                        kWgSmem, clusters, kWgThreads);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, train_rollout_wgrad_kernel, kWgThreads, kWgSmem);
}

#undef F
#undef CF
