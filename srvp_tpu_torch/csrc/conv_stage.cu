// Fused conv stage for Hopper (sm_90a): y = conv3x3(act(x * scale + shift)),
// padding 1, no bias, with the per-channel batch statistics of y, NCHW,
// fp32 or bf16 storage and fp32 accumulation, on the tensor cores.
//
// Replaces two Pallas TPU kernels:
//   srvp_conv3x3_block_fwd   <- srvp_tpu/ops/pallas/conv_stage.py `_fwd_kernel`
//                               (via `conv3x3_block_fwd`): exact zero padding;
//   srvp_conv3x3_clamped_fwd <- scripts/microbench_conv.py `conv_bn_kernel`
//                               (via `fused_conv_bn`): no transform, no
//                               activation, every frame in the statistics,
//                               and the halo rows of each block of bh output
//                               rows clamped into the image.
// One kernel serves both: only the input rows a tile stages differ. Exact:
// output row r reads rows r-1..r+1, zero outside the image. Clamped: row r
// of row block b = r / bh reads rows c-1..c+1 with
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
// 4.19 GB of input and output in fp32. An fp32-accurate product on the
// tensor cores takes three TF32 products (3xTF32): 3 x 604 GFLOP at the
// 495 TFLOP/s of TF32 is 3.66 ms, against 1.25 ms for the bytes at 3.35 TB/s
// (and 9.01 ms for plain fp32 FMA at 67 TFLOP/s, the CUDA cores' rate). In
// bf16 the bound is the bytes, 0.63 ms; this design, one TF32 product per
// term, is bound at 1.22 ms by the TF32 rate.
//
// Design: an implicit GEMM on warp-level mma.sync.m16n8k8 TF32 products.
// M = N*H*W output pixels, cout columns, K = 9*cin walked as chunks of
// kCK = 8 input channels x 9 taps.
//   * A block of 256 threads (8 warps, 4 along M x 2 along N, each a
//     32 x 32 warp tile of 2 x 4 m16n8 products) owns kBM = 128 output
//     pixels x kBN = 64 output channels. Its pixels are whole tiles of the
//     frame: F frames x R rows x WT columns, F*R*WT <= 128, chosen by the
//     wrapper (kernels/conv_stage.tile_plan): R = 128 / W rows of one frame
//     (2 rows at W = 64, 4 at 32, 8 at 16), whole frames when one fits
//     twice (2 frames of 8 x 8), WT = min(W, 128) columns; for kernel 9 R
//     divides bh, so that a tile never crosses a block of bh rows.
//   * Staging, once per cin chunk: cp.async copies the raw halo tile,
//     [kCK][F][R + 2 rows][WT + 2 columns] in the storage type, into one of
//     kRawSlots = 2 shared-memory slots, 16 bytes a copy where the rows
//     allow it (W a multiple of 4 fp32 or 8 bf16 values), 4 bytes (fp32)
//     or a plain load (bf16) a value elsewhere; and the weights' slice
//     [9][kCK][kBN] from the wrapper's (cin, 3, 3, cout) fp32 copy,
//     zero-filled past cin and cout, into one of kStages = 3 slots. Two
//     chunks' copies fly while this chunk multiplies (the raw input needs
//     one slot fewer: the transform pass has consumed it before the next
//     copies are issued).
//   * A transform pass, once a stage has landed, writes the A operand: each
//     staged value transformed, activated and rounded to the storage type,
//     zero (after the activation) where the tap lies outside the image or
//     past cin or N. For fp32 it writes two planes, big = tf32(v) and
//     small = tf32(v - big) (2 x 4 bytes a value of shared memory; the
//     split is done once a block instead of once for each warp that reads
//     the value); bf16 values are exact in TF32 (8 significant bits of 11)
//     and need one plane. The weights are split
//     at the fragment load (each warp splits its own B fragments: 3
//     operations a value).
//   * Products: for each tap (dy, dx) the A fragment is the staged tile read
//     at the pixel's offset shifted by (dy, dx); fp32 takes
//     acc += a_small*w_big + a_big*w_small + a_big*w_big (the small terms
//     first, as CUTLASS's 3xTF32), bf16 acc += a*w once.
//   * The channel pitch of the planes is 8 modulo 32 words, so a warp's
//     fragment load (8 pixels x 4 channels) meets 32 different banks; the
//     weights' row pitch (kBN + 8) likewise for B.
//   * A two-level sum: every chunk (72 terms of K) is multiplied into fresh
//     accumulators and added into fp32 running totals in registers. One
//     chain over K = 9 * 1024 missed the plain version's accuracy at the
//     1024-channel vgg site.
//   * Registers: 128 a thread, for two blocks an SM. The fp32 instance
//     multiplies A's small terms in a pass of their own, so that one set
//     of A fragments is live at a time; ptxas still reports 272 bytes of
//     spill stores for it (the bf16 instance none). Where they fall in the
//     SASS was not examined.
//
// The statistics need no atomics and give the same bits on every run: each
// thread sums its pixels per channel, a fixed butterfly of shuffles sums
// the 8 lanes that share a channel, the 4 warps along M are added in a
// fixed order through shared memory into a partials buffer (cout, tiles)
// of float2, and a second launch sums each channel's partials in fp64 in a
// fixed order.
//
// Indices are 64-bit: the 1024 -> 512 site's input alone is 2000*1024*64
// values. N, H, W, cin and cout need not be multiples of any tile. Kernels
// launch on the caller's stream and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kBM = 128;      // output pixels a block
constexpr int kBN = 64;       // output channels a block
constexpr int kCK = 8;        // input channels a chunk (one k8 step a tap)
constexpr int kThreads = 256;
constexpr int kStages = 3;    // chunks in flight: the weights' slots
constexpr int kRawSlots = 2;  // the raw input's: the transform frees one
constexpr int kBNP = kBN + 8;  // weight row pitch: 8 modulo 32 words
constexpr int kStatsThreads = 256;
constexpr float kLeakySlope = 0.2f;  // module/conv.py make_conv_block

enum Act { kNone = 0, kLeaky = 1, kTanh = 2 };

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kTerms = 3;  // 3xTF32
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kTerms = 1;  // bf16 is exact in TF32
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kLeaky) return fmaxf(v, __fmul_rn(kLeakySlope, v));
  if (act == kTanh) return tanhf(v);
  return v;
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One value from global to shared: cp.async for fp32, a plain load for bf16
// (2 bytes, below cp.async's smallest copy).
__device__ __forceinline__ void copy1(float* dst, const float* src) {
  cp_async4(dst, src, 4);
}

__device__ __forceinline__ void copy1(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src) {
  *dst = src[0];
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Params {
  const void* x;        // (n, cin, h, w) storage type
  const float* wt;      // (cin, 3, 3, cout) fp32
  const float* scale;   // (cin,) or null: no transform
  const float* shift;   // (cin,)
  void* y;              // (n, cout, h, w) storage type
  float2* partials;     // (cout, n_tiles): per block [sum, sum of squares]
  int64_t n, n_valid;
  int cin, h, w, cout;
  int act;
  int bh;               // 0: exact edges; else clamped blocks of bh rows
  // the tile: F frames x R rows x WT columns, and its grid
  int rows, frames, cols;
  int row_blocks, col_blocks;
  // shared-memory geometry, in values: row pitch, frame pitch, channel
  // pitch (8 modulo 32), left pad (16 bytes: interior columns start
  // aligned)
  int wp, fp, chp, padl;
  bool vec;             // rows of 16-byte copies
};

// A staged row of the halo tile, the same in every chunk: where it comes
// from for channel k of the chunk (add ci0 * h * w), where it goes, and k,
// or -1 where the row lies outside the image or past N.
struct Line {
  int64_t src;
  int dst;
  int k;
};

// A walk over (row, item) pairs, n items a row, kThreads items a step,
// without a division a step.
struct Walk {
  int line, at, dl, da, n;
  __device__ Walk(int start, int n_) : n(n_) {
    line = start / n;
    at = start - line * n;
    dl = kThreads / n;
    da = kThreads - dl * n;
  }
  __device__ __forceinline__ void step() {
    line += dl;
    at += da;
    if (at >= n) {
      at -= n;
      ++line;
    }
  }
};

// The shared-memory layout of a block, in bytes from the dynamic base.
template <typename T>
struct Layout {
  int raw, plane, wgt, red, line, total;
  __host__ __device__ Layout(const Params& p) {
    const int tile = kCK * p.chp;
    raw = 0;
    plane = raw + kRawSlots * tile * static_cast<int>(sizeof(T));
    plane = (plane + 15) & ~15;
    wgt = plane + (Io<T>::kTerms == 3 ? 2 : 1) * tile * 4;
    red = wgt + kStages * 9 * kCK * kBNP * 4;
    line = red + 4 * kBN * static_cast<int>(sizeof(float2));
    total = line + kCK * p.frames * (p.rows + 2) *
                       static_cast<int>(sizeof(Line));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_kernel(const Params p) {
  constexpr bool kSplit = Io<T>::kTerms == 3;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<T> lay(p);
  T* raw = reinterpret_cast<T*>(smem + lay.raw);
  // the A operand: one plane (bf16), or big and small planes (fp32)
  float* big = reinterpret_cast<float*>(smem + lay.plane);
  float* small = big + kCK * p.chp;
  float* wgt = reinterpret_cast<float*>(smem + lay.wgt);
  float2* red = reinterpret_cast<float2*>(smem + lay.red);
  Line* line_of = reinterpret_cast<Line*>(smem + lay.line);

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp & 3, warp_n = warp >> 2;

  // which tile: frame group, row block, column block
  const int64_t tile = blockIdx.x;
  const int cb = static_cast<int>(tile % p.col_blocks);
  const int rb = static_cast<int>((tile / p.col_blocks) % p.row_blocks);
  const int64_t f0 = tile / (static_cast<int64_t>(p.col_blocks) *
                             p.row_blocks) * p.frames;
  const int r0 = rb * p.rows;
  const int c0 = cb * p.cols;
  const int co0 = blockIdx.y * kBN;
  // the first input row the tile stages
  int in_row0 = r0 - 1;
  if (p.bh > 0) {
    const int b = r0 / p.bh;
    in_row0 = min(max(b * p.bh - 1, 0), p.h - p.bh - 2) + (r0 - b * p.bh);
  }
  const int srows = p.rows + 2, scols = p.cols + 2;
  const int lines = kCK * p.frames * srows;  // staged rows of a chunk
  const int64_t hw = static_cast<int64_t>(p.h) * p.w;
  for (int i = tid; i < lines; i += kThreads) {
    const int k = i / (p.frames * srows);
    const int rem = i - k * (p.frames * srows);
    const int f = rem / srows;
    const int rr = rem - f * srows;
    const int64_t frame = f0 + f;
    const int row = in_row0 + rr;
    const bool ok = frame < p.n && row >= 0 && row < p.h;
    line_of[i] = Line{ok ? ((frame * p.cin + k) * p.h + row) * p.w : 0,
                      k * p.chp + f * p.fp + rr * p.wp + p.padl - 1,
                      ok ? k : -1};
  }
  __syncthreads();

  // The plane offsets of this thread's 4 A pixels (rows g, g + 8 of its 2
  // m16 tiles), channel t included; 0 for a pixel outside the tile.
  int off[2][2];
  const int tile_px = p.frames * p.rows * p.cols;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = warp_m * 32 + mt * 16 + hh * 8 + g;
      int o = 0;
      if (m < tile_px) {
        const int c = m % p.cols;
        const int r = (m / p.cols) % p.rows;
        const int f = m / (p.cols * p.rows);
        o = f * p.fp + r * p.wp + p.padl - 1 + c;
      }
      off[mt][hh] = o + t * p.chp;
    }

  // The staging and the transform pass walk over (staged row, piece),
  // kThreads items a step.
  constexpr int kVec = 16 / sizeof(T);
  const int nv = p.cols / kVec;
  const int pieces = p.vec ? nv + 2 : scols;

  // Issues the copies of chunk `chunk`: its input into raw slot
  // chunk % kRawSlots, its weights into slot chunk % kStages.
  auto load = [&](int chunk) {
    const int ci0 = chunk * kCK;
    T* rs = raw + (chunk % kRawSlots) * kCK * p.chp;
    // the input: the pieces of every staged row, spread over the threads
    // (vec: nv 16-byte pieces, then the two halo columns; else a value a
    // piece from column c0 - 1)
    const int64_t ci_off = ci0 * hw;
    Walk wk(tid, pieces);
    for (int i = tid; i < lines * pieces; i += kThreads, wk.step()) {
      const Line ln = line_of[wk.line];
      if (ln.k < 0 || ci0 + ln.k >= p.cin) continue;
      const T* src = x + ln.src + ci_off;
      T* dst = rs + ln.dst;  // column c0 - 1
      if (p.vec && wk.at < nv) {
        cp_async16(dst + 1 + wk.at * kVec, src + c0 + wk.at * kVec, 16);
      } else {
        const int cc = !p.vec ? wk.at : wk.at == nv ? 0 : scols - 1;
        const int col = c0 - 1 + cc;
        if (col >= 0 && col < p.w) copy1(dst + cc, src + col);
      }
    }
    // the weights: [tap][k][kBN] rows of kBN / 4 16-byte pieces
    float* ws = wgt + (chunk % kStages) * 9 * kCK * kBNP;
    const bool wvec = (p.cout & 3) == 0;
    for (int i = tid; i < 9 * kCK * (kBN / 4); i += kThreads) {
      const int q = i % (kBN / 4);
      const int tk = i / (kBN / 4);  // tap * kCK + k
      const int tap = tk / kCK, k = tk - tap * kCK;
      const int ci = ci0 + k;
      const int co = co0 + q * 4;
      float* dst = ws + tk * kBNP + q * 4;
      const bool row_ok = ci < p.cin;
      const float* src =
          p.wt + (static_cast<int64_t>(row_ok ? ci : 0) * 9 + tap) * p.cout;
      if (wvec) {
        const bool ok = row_ok && co < p.cout;
        cp_async16(dst, ok ? src + co : p.wt, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = row_ok && co + j < p.cout;
          cp_async4(dst + j, ok ? src + co + j : p.wt, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  // The transform pass over chunk `chunk`'s raw slot into the A plane(s).
  auto transform = [&](int chunk) {
    const int ci0 = chunk * kCK;
    const T* rs = raw + (chunk % kRawSlots) * kCK * p.chp;
    Walk wk(tid, scols);
    for (int i = tid; i < lines * scols; i += kThreads, wk.step()) {
      const Line ln = line_of[wk.line];
      const int ci = ci0 + ln.k;
      const int col = c0 - 1 + wk.at;
      const int at = ln.dst + wk.at;
      float v = 0.f;
      if (ln.k >= 0 && ci < p.cin && col >= 0 && col < p.w) {
        v = Io<T>::to_float(rs[at]);
        if (p.scale != nullptr)
          v = __fadd_rn(__fmul_rn(v, __ldg(p.scale + ci)),
                        __ldg(p.shift + ci));
        v = Io<T>::round(activate(v, p.act));
      }
      if (kSplit) {
        const uint32_t b = to_tf32(v);
        big[at] = __uint_as_float(b);
        small[at] = __uint_as_float(to_tf32(v - __uint_as_float(b)));
      } else {
        big[at] = v;
      }
    }
  };

  float tot[2][4][4], acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) tot[mt][nt][j] = 0.f;

  const int n_chunks = (p.cin + kCK - 1) / kCK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load(s);
    else cp_async_commit();
  }
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int st = chunk % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();  // the chunk landed; the planes were last read before
    transform(chunk);
    __syncthreads();  // the raw slot is free, the planes written
    const int next = chunk + kStages - 1;
    if (next < n_chunks) load(next);
    else cp_async_commit();

#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
    const float* wb = wgt + st * 9 * kCK * kBNP + t * kBNP + warp_n * 32 + g;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * p.wp + (tap % 3);
      const float* wt = wb + tap * kCK * kBNP;
      // The A fragments of both m16 tiles from plane `pl`.
      auto fragments = [&](const float* pl, uint32_t (&a)[2][4]) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int i0 = off[mt][0] + shift, i1 = off[mt][1] + shift;
          const int k4 = 4 * p.chp;
          a[mt][0] = __float_as_uint(pl[i0]);
          a[mt][1] = __float_as_uint(pl[i1]);
          a[mt][2] = __float_as_uint(pl[i0 + k4]);
          a[mt][3] = __float_as_uint(pl[i1 + k4]);
        }
      };
      uint32_t a[2][4];
      if (kSplit) {
        // first the small terms of A against the big ones of w, then A's
        // big terms against w's small and big ones: one set of A
        // fragments in registers at a time
        fragments(small, a);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t b0 = to_tf32(wt[nt * 8]);
          const uint32_t b1 = to_tf32(wt[4 * kBNP + nt * 8]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[mt][nt], a[mt], b0, b1);
        }
      }
      fragments(big, a);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float w0 = wt[nt * 8], w1 = wt[4 * kBNP + nt * 8];
        if (kSplit) {
          const uint32_t b0 = to_tf32(w0), b1 = to_tf32(w1);
          const uint32_t s0 = to_tf32(w0 - __uint_as_float(b0));
          const uint32_t s1 = to_tf32(w1 - __uint_as_float(b1));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_tf32(acc[mt][nt], a[mt], s0, s1);
            mma_tf32(acc[mt][nt], a[mt], b0, b1);
          }
        } else {
          // bf16 weights and values are exact in TF32
          const uint32_t b0 = __float_as_uint(w0), b1 = __float_as_uint(w1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[mt][nt], a[mt], b0, b1);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) tot[mt][nt][j] += acc[mt][nt][j];
  }
  cp_async_wait<0>();

  // Epilogue: y, and this thread's per-channel sums over counted pixels.
  T* __restrict__ y = static_cast<T*>(p.y);
  float s1[4][2], s2[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) s1[nt][j] = s2[nt][j] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = warp_m * 32 + mt * 16 + hh * 8 + g;
      if (m >= tile_px) continue;
      const int c = m % p.cols;
      const int r = (m / p.cols) % p.rows;
      const int64_t frame = f0 + m / (p.cols * p.rows);
      const int row = r0 + r, col = c0 + c;
      if (frame >= p.n || row >= p.h || col >= p.w) continue;
      const bool counted = frame < p.n_valid;
      const int64_t ybase =
          frame * p.cout * hw + static_cast<int64_t>(row) * p.w + col;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = co0 + warp_n * 32 + nt * 8 + 2 * t + j;
          if (co >= p.cout) continue;
          const float v = tot[mt][nt][2 * hh + j];
          Io<T>::store(y + ybase + co * hw, v);
          if (counted) {
            s1[nt][j] += v;
            s2[nt][j] = fmaf(v, v, s2[nt][j]);
          }
        }
    }
  // a fixed butterfly over the 8 lanes (g) that share the channels
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s1[nt][j] += __shfl_xor_sync(0xffffffffu, s1[nt][j], o);
        s2[nt][j] += __shfl_xor_sync(0xffffffffu, s2[nt][j], o);
      }
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        red[warp_m * kBN + warp_n * 32 + nt * 8 + 2 * t + j] =
            make_float2(s1[nt][j], s2[nt][j]);
  }
  __syncthreads();
  if (tid < kBN && co0 + tid < p.cout) {
    float2 s = red[tid];
#pragma unroll
    for (int wm = 1; wm < 4; ++wm) {
      const float2 v = red[wm * kBN + tid];
      s.x += v.x;
      s.y += v.y;
    }
    p.partials[static_cast<int64_t>(co0 + tid) * gridDim.x + blockIdx.x] = s;
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

template <typename T>
int launch(Params& p, float* stats, int64_t n_tiles, cudaStream_t stream) {
  // the tile: at most kBM pixels; several frames only as whole frames; for
  // kernel 9 rows that divide bh
  if (p.rows < 1 || p.frames < 1 || p.cols < 1 || p.rows > p.h ||
      p.cols > p.w ||
      static_cast<int64_t>(p.rows) * p.frames * p.cols > kBM ||
      (p.frames > 1 && p.rows != p.h) || (p.bh > 0 && p.bh % p.rows != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t frame_groups = (p.n + p.frames - 1) / p.frames;
  p.row_blocks = (p.h + p.rows - 1) / p.rows;
  p.col_blocks = (p.w + p.cols - 1) / p.cols;
  const int64_t tiles = frame_groups * p.row_blocks * p.col_blocks;
  if (tiles != n_tiles || tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0 || p.cout == 0) return 0;
  constexpr int kVec = 16 / sizeof(T);
  p.padl = kVec;
  p.wp = (p.padl + p.cols + 1 + kVec - 1) / kVec * kVec;
  p.fp = (p.rows + 2) * p.wp;
  // the channel pitch, 8 modulo 32: a fragment load's 8 pixels x 4
  // channels meet 32 banks (a multiple of kVec)
  p.chp = p.frames * p.fp;
  p.chp += (8 - p.chp % 32 + 32) % 32;
  p.vec = p.w % kVec == 0 && p.cols % kVec == 0 &&
          reinterpret_cast<uintptr_t>(p.x) % 16 == 0;
  if (reinterpret_cast<uintptr_t>(p.wt) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout<T> lay(p);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles), (p.cout + kBN - 1) / kBN);
  conv3x3_kernel<T><<<grid, kThreads, lay.total, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_kernel<<<p.cout, kStatsThreads, 0, stream>>>(p.partials, stats,
                                                     tiles);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(Params& p, int bf16, void* stats, long long n_tiles,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto st = static_cast<float*>(stats);
  return bf16 ? launch<__nv_bfloat16>(p, st, n_tiles, s)
              : launch<float>(p, st, n_tiles, s);
}

}  // namespace

// Each returns the launches' cudaError_t (0 on success). Pointers are
// device pointers to contiguous tensors: x and y in the storage type (fp32,
// or bf16 when `bf16` is set); wt the weights as (cin, 3, 3, cout) fp32,
// 16-byte aligned; scale, shift, stats (cout, 2) fp32; partials fp32 scratch
// of 2 * cout * n_tiles values. The tile is `frames` frames x `rows` rows x
// `cols` columns (at most 128 pixels; several frames only with rows = h;
// for kernel 9 rows divides bh) and n_tiles = ceil(n / frames) *
// ceil(h / rows) * ceil(w / cols). `stream` is a cudaStream_t. Nothing is
// launched when there is no output.

// Kernel 8: exact edges; act 0 none, 1 leaky_relu, 2 tanh; scale and
// shift both null for no transform; frames >= n_valid left out of stats.
extern "C" int srvp_conv3x3_block_fwd(const void* x, const void* wt,
                                      const void* scale, const void* shift,
                                      void* y, void* partials, void* stats,
                                      int bf16, long long n, int cin, int h,
                                      int wd, int cout, long long n_valid,
                                      int act, int rows, int frames, int cols,
                                      long long n_tiles, void* stream) {
  if ((scale == nullptr) != (shift == nullptr) || act < 0 || act > 2 ||
      n_valid < 0 || n_valid > n)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = x;
  p.wt = static_cast<const float*>(wt);
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  p.y = y;
  p.partials = static_cast<float2*>(partials);
  p.n = n;
  p.n_valid = n_valid;
  p.cin = cin;
  p.h = h;
  p.w = wd;
  p.cout = cout;
  p.act = act;
  p.bh = 0;
  p.rows = rows;
  p.frames = frames;
  p.cols = cols;
  return dispatch(p, bf16, stats, n_tiles, stream);
}

// Kernel 9: clamped halo rows for blocks of bh rows (h % bh == 0,
// h >= 2 bh and h >= bh + 2), no transform, no activation, every frame in
// the statistics.
extern "C" int srvp_conv3x3_clamped_fwd(const void* x, const void* wt,
                                        void* y, void* partials, void* stats,
                                        int bf16, long long n, int cin,
                                        int h, int wd, int cout, int bh,
                                        int rows, int cols,
                                        long long n_tiles, void* stream) {
  if (bh < 1 || h % bh != 0 || h < 2 * bh || h < bh + 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = x;
  p.wt = static_cast<const float*>(wt);
  p.y = y;
  p.partials = static_cast<float2*>(partials);
  p.n = n;
  p.n_valid = n;
  p.cin = cin;
  p.h = h;
  p.w = wd;
  p.cout = cout;
  p.act = kNone;
  p.bh = bh;
  p.rows = rows;
  p.frames = 1;
  p.cols = cols;
  return dispatch(p, bf16, stats, n_tiles, stream);
}
