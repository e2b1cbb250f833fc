// Causal / sliding-window GQA flash attention, forward, CUDA C++ for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of the JAX package,
// src/repro/kernels/flash_attention/kernel.py:110 flash_attention_pallas
// (body _flash_kernel). The port's wrapper is flash_attention_cuda in
// kernels/flash_attention/kernel.py; its plain version, and oracle, is
// flash_attention_ref in kernels/flash_attention/ref.py.
//
// What it computes, as _flash_kernel does: for q (B, Hq, Sq, D) and k, v
// (B, Hkv, Sk, D), query head h reads KV head h / (Hq / Hkv) by index (K and
// V are never repeated); query i sits at position i + Sk - Sq (right
// aligned); key j is visible from position t when j < Sk, j <= t (causal)
// and j > t - window (sliding window). out = softmax(scale * q k^T) v over the
// visible keys, with an online softmax in float32 (running max m, running
// sum l, accumulator in registers); a row that sees no key is 0 (the l == 0
// guard). Scale is D^-0.5 unless one is given. The exponentials run as
// exp2 of scores pre-multiplied by scale * log2(e).
//
// Routes, chosen by the wrapper from the dtype and D alone (flash_route):
//   wgmma  bf16 / fp16, D from 64 to 192 and a multiple of 8 (every config's
//          serving path): flash_wgmma_kernel
//   mma    bf16 / fp16, any other D from 1 to 256: flash_mma_kernel
//   ffma   float32, D from 1 to 256: flash_f32_kernel
// The wgmma kernel is instantiated at padded widths DP = 64, 128 and 192
// (wgmma_instance: 64 for d = 64, 128 for d = 72 ... 128, 192 above), the mma
// and ffma kernels at D = 16, 32, 64, 96, 128, 160, 192 and 256 (kHeadDims);
// a head dimension d between two of them runs the next one up. Its columns
// past d are loaded as zeros (TMA's zero fill on the wgmma route) and never
// stored: zeros change neither q . k nor the kept columns of P V, so the
// result is the function's own. Where d is a whole number of 16-byte
// vectors and every row is 16-byte aligned (Params::vec), tiles move as
// 16-byte vectors; otherwise element by element (the wgmma route takes only
// the former). The mma and ffma kernels' K and V tiles sit in dynamic shared
// memory, opted in above 48 KB (D >= 192).
//
// Layout. Every tensor is read through its own (batch, head, sequence)
// strides with the last axis contiguous, so the (B, H, S, D) views that the
// layer makes with transpose(1, 2) of (B, S, H, D) projections go in without
// a copy; the output is written in the layout of q. Ragged Sq and Sk are
// handled inside the kernels: rows past Sq are not stored, keys past Sk are
// zero-filled and masked. Nothing is padded by the wrapper.
//
// Work skipped (all routes). A block's loop over key tiles runs only from
// the window's first key tile to the causal diagonal's last one (the TPU
// kernel's `run` test and pl.when); a tile that every row of the block (of
// the warpgroup, on the wgmma route) sees skips the per-element mask. Work
// starts with the last query tiles, so the longest causal rows come first.
//
// Bound on the H100. At the serving path's prefill shape, q (4, 16, 2048,
// 128) against k, v (4, 8, 2048, 128) in bf16, causal, the function does
// 4 * D flops on each of 2 098 176 visible (query, key) pairs of each of the
// 64 (batch, head) pairs: 68.7 GFLOP, 0.0695 ms at 989 TFLOP/s dense bf16,
// against 100.7 MB moved, 0.030 ms at 3.35 TB/s. The tensor cores bound it,
// and on Hopper only wgmma reaches their dense rate.
//
// wgmma route, what the design does about that bound. A persistent grid,
// one block a streaming multiprocessor, walks work items of 128 query rows
// of one (batch, query head), longest first within chunks of (batch, head)
// pairs whose K and V fit in 32 MB of the L2 (all 64 pairs of the prefill
// above; 36 of zamba2's 128, whose K and V take 117 MB, else re-read from
// device memory by each query tile). A block has three warpgroups.
// The producer (registers lowered to 24 with setmaxnreg) has one thread
// load each item's Q into one of two Q buffers, then K and V tiles of 128
// keys of KV head h / group into a two-stage ring (192 KB of dynamic shared
// memory at D = 128), through TMA: cp.async.bulk.tensor on 4-D tensor maps
// (D, S, H, B) built from the tensors' own strides, passed as
// __grid_constant__ parameters; keys past Sk and rows past Sq arrive as
// TMA's zero fill. Every Q buffer and ring stage has a full mbarrier that
// the TMA's byte count completes and a free mbarrier that the 8 consumer
// warps arrive on once done with it; the ring and the Q buffers run on from
// one item to the next, so the next item's loads overlap the current one's
// last tiles and its epilogue. The two consumer warpgroups (registers raised
// to 240) own 64 rows each. Per key tile: S = Q K^T on wgmma.mma_async
// m64n128k16 with Q and K read from shared memory (K-major, 128-byte
// swizzle: at D = 128 a row is two 64-column boxes), issued in one batch
// with the previous tile's O += P V (wgmma m64nDk16, P the A operand from
// registers, V an MN-major B operand, so V needs no transpose); the online
// softmax starts as soon as S is done (wait_group 1) while P V still runs.
// The two warpgroups take turns to issue their batches (named barriers), so
// one's softmax also runs under the other's products. The softmax works on
// the accumulator's registers: exponents exp2(c s - m) as one FFMA each
// (c = scale log2(e) > 0), row maxima and sums in four partial chains and
// across the 4 lanes of a row, and a mask pass only on tiles that a row sees
// in part (keys it does not see become -inf). Tile 0 is peeled off the loop,
// so that no branch in it decides whether a P V is in flight: with such a
// branch, ptxas cannot prove the accumulators idle and serialises every
// wgmma of the kernel (its warning C7514).
// The epilogue scales by 1 / l and writes the tile through the warpgroup's
// rows of its Q buffer, in Q's swizzled layout, as 16-byte row stores of
// the first d columns.
// P's rounding to the input type moves each output by at most
// 2^-9 * sum_j p_j |v_j| / l <= 2^-9 max|v| (about 2^-8 max|v| with the
// output's own rounding to bf16), row by row, against flash_attention_ref;
// the TPU kernel keeps P in float32.
//
// Widths that are not whole boxes (d = 96, 112: phi-3-vision, zamba2). The
// kernel runs at DP = 128 with the tensor maps' extent d, so box columns d
// ... 127 arrive as TMA's zero fill, and both products run at the padded
// width: 128 / d of the tensor cores' work, 1.33 at d = 96 and 1.14 at
// d = 112 (zamba2's prefill, q (4, 32, 2048, 112) over 32 KV heads: bound
// 0.1217 ms at d, 0.1391 ms at DP). Skipping the padding's k-steps of S
// under a guard predicate (6 of 8 at d = 96) left phi-3-vision's time as it
// was (0.2993 against 0.29-0.32 ms, tools/kernel_ab.py on the H100): S's
// width is not what sets the pace at that shape.
//
// d = 136 ... 192 (nemotron-4, 96 heads of 192): DP = 192, three boxes a
// row. Two Q buffers and a two-stage ring of 128-key tiles would take 6 x 48
// KB, above the 227 KB (232 448 bytes) a block may opt into, so the K / V
// tiles are 64 keys there: S on m64n64k16 (32 floats a thread), O += P V on
// m64n192k16 (96 floats), four k16 steps of P a tile. 2 x 48 + 2 x (24 + 24)
// KB: 197 728 bytes with the barriers and alignment, as at DP = 128; O and S
// take 128 of the consumers' 240 registers. A row meets twice as many tiles,
// so twice the barrier waits and row reductions per key.
//
// mma route (16-bit, a D the wgmma route does not take): four warps of 16
// query rows; each 64-key tile of K and V is loaded synchronously into
// shared memory (rows padded by 16 bytes), S and O on mma.sync.m16n8k16, V's
// fragments from ldmatrix.trans. The same P rounding and bound. A thread
// holds D / 2 floats of O and D / 4 words of Q, so at D = 256 ptxas spills
// some of them.
//
// ffma route (float32): the same loop on FFMA in true float32 (no TF32
// anywhere): a pair of lanes owns one query row, each holding half of q and
// of the accumulator; the two halves of each dot product meet through one
// shuffle. Key tiles are 32 wide, and the second half of each row sits 4
// words further in shared memory, so the pair's two reads hit different
// banks.

#include <cuda.h>   // CUtensorMap and its enums only: no driver call is linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;          // query rows a block
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;          // keys a tile, bf16 / fp16
constexpr int kBKF = 32;         // keys a tile, float32
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRouteFfma = 0, kRouteMma = 1, kRouteWgmma = 2;
constexpr int kDefaultSmem = 48 * 1024;   // a block's shared memory without opting in

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int sq, sk, group;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int causal;
  int window;                    // < 0: no window
  float scale_log2;              // scale * log2(e)
  int heads, batch, q_tiles;     // the wgmma route's work items: q_tiles x heads x batch
  int pairs;                     // ... taken (batch, head) pairs by chunks of this many
  int d;                         // the head dimension; the instantiation's D >= d
  int vec;                       // d a whole number of 16-byte vectors, rows aligned
};

__device__ __forceinline__ bool visible(const Params& p, int pos, int key) {
  return key < p.sk && (!p.causal || key <= pos) &&
         (p.window < 0 || key > pos - p.window);
}

// The query positions [pos_lo, pos_hi] of `rows` rows from q0 and the
// tile-aligned key range [k_begin, k_end) that holds every key one of them sees.
struct Range {
  int pos_lo, pos_hi, k_begin, k_end;
};

__device__ __forceinline__ Range block_range(const Params& p, int q0, int rows, int tile) {
  Range r;
  const int off = p.sk - p.sq;
  r.pos_lo = q0 + off;
  r.pos_hi = min(q0 + rows, p.sq) - 1 + off;
  r.k_end = p.causal ? min(p.sk, r.pos_hi + 1) : p.sk;
  r.k_begin = p.window >= 0 ? max(0, r.pos_lo - p.window + 1) : 0;
  r.k_begin = r.k_begin / tile * tile;
  return r;
}

__device__ __forceinline__ bool tile_full(const Params& p, const Range& r, int k0,
                                          int tile) {
  return k0 + tile <= p.sk && (!p.causal || k0 + tile - 1 <= r.pos_lo) &&
         (p.window < 0 || k0 > r.pos_hi - p.window);
}

// ---------------------------------------------------------------------------
// bf16 / fp16 at a D the wgmma route does not take, on mma.sync
// ---------------------------------------------------------------------------

// Eight 16-bit elements from column c of a row (c < d), zero past d: one
// 16-byte load when vec (then c + 8 <= d), else element by element.
__device__ __forceinline__ uint4 load8_b16(const void* row, int c, int d, int vec) {
  const uint16_t* r = static_cast<const uint16_t*>(row) + c;
  if (vec) return *reinterpret_cast<const uint4*>(r);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = c + 2 * i < d ? r[2 * i] : 0u;
    const uint32_t hi = c + 2 * i + 1 < d ? r[2 * i + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Columns c and c + 1 (c even) of a row as one word, zero past d.
__device__ __forceinline__ uint32_t load2_b16(const void* row, int c, int d, int vec) {
  if (c >= d) return 0u;
  const uint16_t* r = static_cast<const uint16_t*>(row) + c;
  if (vec) return *reinterpret_cast<const uint32_t*>(r);
  return (uint32_t)r[0] | (c + 1 < d ? (uint32_t)r[1] << 16 : 0u);
}

// Stores the word w as columns c and c + 1 of a row, what of them is below d.
__device__ __forceinline__ void store2_b16(void* row, int c, int d, int vec, uint32_t w) {
  if (c >= d) return;
  uint16_t* r = static_cast<uint16_t*>(row) + c;
  if (vec) {
    *reinterpret_cast<uint32_t*>(r) = w;
    return;
  }
  r[0] = (uint16_t)(w & 0xFFFFu);
  if (c + 1 < d) r[1] = (uint16_t)(w >> 16);
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

// Four 8x8 b16 matrices, transposed: lane l gives the row address of matrix
// l / 8; register i of lane t holds rows 2 (t % 4) and 2 (t % 4) + 1 of
// column t / 4 of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(Params p) {
  constexpr int kStride = D + 8;   // shared row stride in elements (+16 bytes)
  constexpr int kKS = D / 16;      // k-steps of S = Q K^T
  constexpr int kNT = D / 8;       // n-tiles of O
  constexpr int kVec = D / 8;      // 16-byte vectors a row
  extern __shared__ __align__(16) uint8_t tile_smem[];   // K, V tiles: launch_mma's kSmem
  T* ks = reinterpret_cast<T*>(tile_smem);
  T* vs = ks + kBK * kStride;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int off = p.sk - p.sq;
  const int row0 = q0 + warp * 16 + g;   // this lane's two rows: row0, row0 + 8
  const int row1 = row0 + 8;

  // Q as A fragments: a0 (row0, c..c+1), a1 (row1, c..c+1), a2 (row0, c+8..),
  // a3 (row1, c+8..), c = 16 kk + 2 t4; rows past Sq and columns past d are zero.
  uint32_t qf[kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    const int c = kk * 16 + t4 * 2;
    const T* r0p = qg + row0 * p.q_ss;
    const T* r1p = qg + row1 * p.q_ss;
    qf[kk][0] = row0 < p.sq ? load2_b16(r0p, c, p.d, p.vec) : 0u;
    qf[kk][1] = row1 < p.sq ? load2_b16(r1p, c, p.d, p.vec) : 0u;
    qf[kk][2] = row0 < p.sq ? load2_b16(r0p, c + 8, p.d, p.vec) : 0u;
    qf[kk][3] = row1 < p.sq ? load2_b16(r1p, c + 8, p.d, p.vec) : 0u;
  }

  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};       // this lane's part of the row sums

  const Range r = block_range(p, q0, kBQ, kBK);
  for (int k0 = r.k_begin; k0 < r.k_end; k0 += kBK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kBK * kVec; e += kThreads) {
      const int row = e / kVec, c = (e % kVec) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + row < p.sk && c < p.d) {
        kv = load8_b16(kg + (k0 + row) * p.k_ss, c, p.d, p.vec);
        vv = load8_b16(vg + (k0 + row) * p.v_ss, c, p.d, p.vec);
      }
      *reinterpret_cast<uint4*>(ks + row * kStride + c) = kv;
      *reinterpret_cast<uint4*>(vs + row * kStride + c) = vv;
    }
    __syncthreads();

    // S = Q K^T on 8 n-tiles of 8 keys: b0 = K[key][c..c+1], b1 = K[key][c+8..]
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const T* kp = ks + (n * 8 + g) * kStride + kk * 16 + t4 * 2;
        Mma<T>::run(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                    *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // online softmax; element i of n-tile n is (row0 or row1, key k0 + 8 n +
    // 2 t4 + (i & 1))
    const bool full = tile_full(p, r, k0, kBK);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[n][i] * p.scale_log2;
        if (!full && !visible(p, (i < 2 ? row0 : row1) + off, k0 + n * 8 + t4 * 2 + (i & 1)))
          x = kNeg;
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      alpha[j] = exp2f(m[j] - mx[j]);
      m[j] = mx[j];
      l[j] *= alpha[j];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float e = exp2f(s[n][i] - m[i >> 1]);
        if (!full && !visible(p, (i < 2 ? row0 : row1) + off, k0 + n * 8 + t4 * 2 + (i & 1)))
          e = 0.f;
        s[n][i] = e;
        l[i >> 1] += e;
      }
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: the S accumulators of n-tiles 2 j and 2 j + 1 are the A
    // fragment of k-step j; V's B fragments come from ldmatrix.trans.
    const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t a[4];
      a[0] = Mma<T>::pack(s[2 * j][0], s[2 * j][1]);
      a[1] = Mma<T>::pack(s[2 * j][2], s[2 * j][3]);
      a[2] = Mma<T>::pack(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = Mma<T>::pack(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int n2 = 0; n2 < kNT / 2; ++n2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vs + (j * 16 + (mat & 1) * 8 + mrow) * kStride +
                                  n2 * 16 + (mat >> 1) * 8);
        Mma<T>::run(acc[2 * n2], a, bf[0], bf[1]);
        Mma<T>::run(acc[2 * n2 + 1], a, bf[2], bf[3]);
      }
    }
  }

  // row sums across the four lanes of a row; a row that saw no key is 0
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    if (l[j] == 0.f) l[j] = 1.f;
  }
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int c = n * 8 + t4 * 2;
    if (row0 < p.sq)
      store2_b16(og + row0 * p.o_ss, c, p.d, p.vec,
                 Mma<T>::pack(acc[n][0] / l[0], acc[n][1] / l[0]));
    if (row1 < p.sq)
      store2_b16(og + row1 * p.o_ss, c, p.d, p.vec,
                 Mma<T>::pack(acc[n][2] / l[1], acc[n][3] / l[1]));
  }
}

// ---------------------------------------------------------------------------
// float32 on FFMA
// ---------------------------------------------------------------------------

// Four floats from column c of a row (c < d), zero past d: one 16-byte load
// when vec (then c + 4 <= d), else element by element.
__device__ __forceinline__ float4 load4_f32(const float* row, int c, int d, int vec) {
  if (vec) return *reinterpret_cast<const float4*>(row + c);
  return make_float4(row[c], c + 1 < d ? row[c + 1] : 0.f, c + 2 < d ? row[c + 2] : 0.f,
                     c + 3 < d ? row[c + 3] : 0.f);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(Params p) {
  constexpr int kH = D / 2;            // a lane's half of a row
  constexpr int kStride = D + 8;       // words; the second half starts 4 later
  extern __shared__ __align__(16) uint8_t tile_smem[];   // K, V tiles: launch_ffma's kSmem
  float* ks = reinterpret_cast<float*>(tile_smem);
  float* vs = ks + kBKF * kStride;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane & 1;
  const int row = q0 + warp * 16 + (lane >> 1);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int pos = row + p.sk - p.sq;
  const int soff = half * (kH + 4);    // this lane's half in a shared row

  float q[kH], acc[kH];
#pragma unroll
  for (int d = 0; d < kH; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < p.sq && half * kH + d < p.d) x = load4_f32(qg + row * p.q_ss, half * kH + d, p.d, p.vec);
    q[d] = x.x; q[d + 1] = x.y; q[d + 2] = x.z; q[d + 3] = x.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m = kNeg, l = 0.f;

  const Range r = block_range(p, q0, kBQ, kBKF);
  for (int k0 = r.k_begin; k0 < r.k_end; k0 += kBKF) {
    __syncthreads();
    for (int e = threadIdx.x; e < kBKF * (D / 4); e += kThreads) {
      const int kr = e / (D / 4), c = (e % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + kr < p.sk && c < p.d) {
        kv = load4_f32(kg + (k0 + kr) * p.k_ss, c, p.d, p.vec);
        vv = load4_f32(vg + (k0 + kr) * p.v_ss, c, p.d, p.vec);
      }
      const int at = kr * kStride + c + (c >= kH ? 4 : 0);
      *reinterpret_cast<float4*>(ks + at) = kv;
      *reinterpret_cast<float4*>(vs + at) = vv;
    }
    __syncthreads();

    const bool full = tile_full(p, r, k0, kBKF);
    float s[kBKF];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kBKF; ++j) {
      const float* kp = ks + j * kStride + soff;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kH; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kp + d);
        dot = fmaf(q[d], kv.x, dot);
        dot = fmaf(q[d + 1], kv.y, dot);
        dot = fmaf(q[d + 2], kv.z, dot);
        dot = fmaf(q[d + 3], kv.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      float x = dot * p.scale_log2;
      if (!full && !visible(p, pos, k0 + j)) x = kNeg;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float alpha = exp2f(m - mx);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBKF; ++j) {
      float e = exp2f(s[j] - m);
      if (!full && !visible(p, pos, k0 + j)) e = 0.f;
      s[j] = e;
      sum += e;
    }
    l = l * alpha + sum;
#pragma unroll
    for (int d = 0; d < kH; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBKF; ++j) {
      const float* vp = vs + j * kStride + soff;
#pragma unroll
      for (int d = 0; d < kH; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vp + d);
        acc[d] = fmaf(s[j], vv.x, acc[d]);
        acc[d + 1] = fmaf(s[j], vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(s[j], vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(s[j], vv.w, acc[d + 3]);
      }
    }
  }

  if (row < p.sq) {
    const float den = l == 0.f ? 1.f : l;
    float* orow = og + row * p.o_ss;
#pragma unroll
    for (int d = 0; d < kH; d += 4) {
      const int c = half * kH + d;
      if (c >= p.d) continue;
      if (p.vec) {
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(acc[d] / den, acc[d + 1] / den, acc[d + 2] / den, acc[d + 3] / den);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (c + i < p.d) orow[c + i] = acc[d + i] / den;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16 at D = 64 ... 192 on Hopper: a TMA ring, wgmma, warp specialised
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;          // query rows a block: two consumers of 64
constexpr int kStages = 2;            // depth of the K / V ring
constexpr int kWgThreads = 384;       // a producer warpgroup and two consumers
constexpr int kConsumerWarps = 8;
constexpr int kBoxCols = 64;          // 128-byte swizzle: 64 16-bit values a box row
constexpr int kRowBytes = 128;        // one box row
constexpr int kProducerRegs = 24;     // setmaxnreg: 128 x (24 + 2 x 240) <= 65 536
constexpr int kConsumerRegs = 240;
// K and V bytes of the (batch, head) pairs that the persistent grid works on
// at once (work_item): about two thirds of the H100's 50 MB L2, so that a
// pair's K and V stay there from its first query tile to its last.
constexpr long long kL2Chunk = 32LL << 20;

// The wgmma kernel at padded width DP (64, 128 or 192: whole boxes): keys a
// K / V tile, and the dynamic shared memory of a block, from a 1 KB aligned
// base: two Q buffers, the K ring, the V ring (each tile DP / 64 boxes of
// its rows), then the mbarriers. Tiles of 128 keys at DP <= 128, of 64 at
// DP = 192, where 128 would need 6 x 48 KB > the 227 KB a block may have.
template <int DP>
struct WgSmem {
  static constexpr int kKeys = DP > 128 ? 64 : 128;
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kQBox = kWgRows * kRowBytes;   // one (128 rows x 64 columns) box
  static constexpr int kKVBox = kKeys * kRowBytes;
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kKVTile = kBoxes * kKVBox;
  static constexpr int kQ = 0;                        // buffer i at kQ + i kQTile
  static constexpr int kK = 2 * kQTile;               // stage s at kK + s kKVTile
  static constexpr int kV = kK + kStages * kKVTile;
  static constexpr int kBar = kV + kStages * kKVTile;   // full, free of Q[i]; of K[s], V[s]
  static constexpr int kBytes = kBar + 8 * (4 + 4 * kStages) + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of a 4-D tensor map (D, S, H, B) at the given coordinates, into
// shared memory at dst; completion is counted on the mbarrier in bytes.
// Coordinates past an extent read as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
        "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (stored in 16-byte units), layout
// type 1 (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from touching accumulators across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Named barriers 1 and 2 order the consumer warpgroups' turns: 256 threads
// each, the waiting warpgroup's sync and the other's arrive.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Named barriers 3 and 4: one consumer warpgroup's 128 threads.
__device__ __forceinline__ void named_sync_wg(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The accumulator operands of a wgmma: "+f" of d[i] .. d[i + 7], and the
// register lists "{%0, ..., %N-1}" that name them in the instruction.
#define WG_ACC8(i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_ACC32 WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24)
#define WG_ACC64 WG_ACC32, WG_ACC8(32), WG_ACC8(40), WG_ACC8(48), WG_ACC8(56)
#define WG_ACC96 WG_ACC64, WG_ACC8(64), WG_ACC8(72), WG_ACC8(80), WG_ACC8(88)
#define WG_D32 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" "}"
#define WG_D64 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" "}"
#define WG_D96 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95" "}"

// Accumulator layout of m64nNk16 (float32), thread t of the warpgroup: warp
// w = t / 32 owns rows 16 w + (t % 32) / 4 and that + 8; register 4 j + i is
// (row + 8 (i / 2), column 8 j + 2 (t % 4) + i % 2). The A operand from
// registers (m64k16) has the mma.sync m16n8k16 fragment layout per warp.
// ss: S (64 x N) = A (64 x 16, shared, K-major) B^T (N x 16, shared,
// K-major), N = 128 or 64; rs: O (64 x N) += A (64 x 16, registers) B (16 x
// N, shared, MN-major), N = 64, 128 or 192. N is twice the registers of d.
template <typename T>
struct Wgmma;

template <>
struct Wgmma<__nv_bfloat16> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC32
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC64
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_ACC32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_ACC64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(float (&d)[96], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " WG_D96
        ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : WG_ACC96
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};


template <>
struct Wgmma<__half> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " WG_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC32
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " WG_D64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC64
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_ACC32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " WG_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_ACC64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(float (&d)[96], const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.f16.f16 " WG_D96
        ", {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : WG_ACC96
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// One work item: 128 query rows of one (batch, query head), and the key
// tiles of `keys` keys they need.
struct Item {
  int q0, h, b, hk, n_tiles;
  Range r;
};

// Item w: the (batch, head) pairs go by chunks of p.pairs, and within a
// chunk in longest-first order: the query tiles from the last one down are
// the slowest index, so the longest causal rows come first.
__device__ __forceinline__ Item work_item(const Params& p, int w, int keys) {
  Item t;
  const int per = p.q_tiles * p.pairs;              // the items of a whole chunk
  const int c = w / per;
  const int first = c * p.pairs;                    // the chunk's first pair
  const int size = min(p.pairs, p.heads * p.batch - first);
  const int rest = w - c * per;
  const int z = rest / size, pair = first + rest % size;
  t.q0 = (p.q_tiles - 1 - z) * kWgRows;
  t.h = pair % p.heads;
  t.b = pair / p.heads;
  t.hk = t.h / p.group;
  t.r = block_range(p, t.q0, kWgRows, keys);
  t.n_tiles = t.r.k_end > t.r.k_begin ? (t.r.k_end - t.r.k_begin + keys - 1) / keys : 0;
  return t;
}

// Persistent: one block a streaming multiprocessor takes the work items
// blockIdx.x, blockIdx.x + gridDim.x, ... The K / V ring and the two Q
// buffers run on from one item to the next, so the producer loads the next
// item's Q and first tiles while the consumers finish the current one.
template <typename T, int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = WgSmem<DP>;
  constexpr int KT = L::kKeys;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms are 1 KB
  const uint32_t q_full = base + L::kBar;           // Q of buffer i arrived
  const uint32_t q_free = q_full + 16;              // every consumer warp is done with Q of i
  const uint32_t k_full = q_free + 16;              // K of stage s arrived
  const uint32_t v_full = k_full + 8 * kStages;     // V of stage s arrived
  const uint32_t k_free = v_full + 8 * kStages;     // every consumer warp is done with K of s
  const uint32_t v_free = k_free + 8 * kStages;     // ... and with V of s
  const int n_items = p.q_tiles * p.heads * p.batch;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_free + 8 * i, kConsumerWarps);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_free + 8 * s, kConsumerWarps);
      mbar_init(v_free + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full with K and V of KV head
    // h / group, in the order the consumers take them: K of tile it + 1
    // before V of tile it, since a consumer multiplies by V one tile late.
    // kv counts the tiles of K (and of V) loaded so far: the ring position.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      int kv = 0, n = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
        const Item t = work_item(p, w, KT);
        auto load = [&](const CUtensorMap* map, uint32_t full, uint32_t free, uint32_t at,
                        int it) {
          const int s = (kv + it) % kStages;
          mbar_wait(free + 8 * s, (((kv + it) / kStages) & 1) ^ 1);   // first pass: free
          mbar_expect_tx(full + 8 * s, L::kKVTile);
#pragma unroll
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load(at + s * L::kKVTile + x * L::kKVBox, map, full + 8 * s, x * kBoxCols,
                     t.r.k_begin + it * KT, t.hk, t.b);
        };
        const int qb = n & 1;
        mbar_wait(q_free + 8 * qb, ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qb, L::kQTile);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load(base + L::kQ + qb * L::kQTile + x * L::kQBox, &tm_q, q_full + 8 * qb,
                   x * kBoxCols, t.q0, t.h, t.b);
        if (t.n_tiles > 0) load(&tm_k, k_full, k_free, base + L::kK, 0);
        for (int it = 0; it < t.n_tiles; ++it) {
          if (it + 1 < t.n_tiles) load(&tm_k, k_full, k_free, base + L::kK, it + 1);
          load(&tm_v, v_full, v_free, base + L::kV, it);
        }
        kv += t.n_tiles;
      }
    }
  } else {
    // Consumers: warpgroup cw owns rows q0 + 64 cw .. + 63 of each item.
    // Tile it issues S = Q K^T and the previous tile's O += P V as one batch
    // and runs its softmax as soon as S is done, while P V is still on the
    // tensor cores. The two warpgroups take turns to issue their batches
    // (named barriers 1 and 2), so one's softmax also overlaps the other's
    // products. Tile 0 (S alone) is peeled off the loop, so that no branch
    // of the loop decides whether a P V is in flight.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int off = p.sk - p.sq;
    float o[DP / 2], sc[KT / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) sc[i] = 0.f;
    uint32_t pa[KT / 16][4];       // P of the previous tile, the A operand of P V
    float m[2], l[2], alpha[2];
    int kv = 0, n = 0;

    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
      const Item t = work_item(p, w, KT);
      const int qb = n & 1;
      const int rows0 = t.q0 + cw * 64;
      const int row0 = rows0 + warp * 16 + g, row1 = row0 + 8;
      const Range rc = block_range(p, rows0, 64, KT);          // this warpgroup's rows
      const uint32_t q_at = base + L::kQ + qb * L::kQTile + cw * 64 * kRowBytes;  // its rows
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;           // this lane's part of the row sums

      // S = Q K^T for tile it in DP / 16 steps: step kk's 32 bytes sit at
      // (kk % 4) * 32 in the swizzled 128-byte rows of box kk / 4; 8-row
      // groups 1 KB apart.
      auto issue_s = [&](int it) {
        const uint32_t k_at = base + L::kK + ((kv + it) % kStages) * L::kKVTile;
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t at = (kk % 4) * 32;
          Wgmma<T>::ss(sc, wg_desc(q_at + (kk / 4) * L::kQBox + at, 16, 1024),
                       wg_desc(k_at + (kk / 4) * L::kKVBox + at, 16, 1024), kk > 0);
        }
      };
      // O += P V for tile it: P (rounded to T) is the A operand from
      // registers, the S accumulators of n-tiles 2 j and 2 j + 1 making
      // k-step j; V is the MN-major B operand: 16 keys (two 8-row groups,
      // 1 KB apart) a step, its 64-column boxes L::kKVBox apart.
      auto issue_pv = [&](int it) {
        const uint32_t v_at = base + L::kV + ((kv + it) % kStages) * L::kKVTile;
#pragma unroll
        for (int j = 0; j < KT / 16; ++j)
          Wgmma<T>::rs(o, pa[j], wg_desc(v_at + j * 16 * kRowBytes, L::kKVBox, 1024));
      };
      auto wait_full = [&](uint32_t full, int it) {
        mbar_wait(full + 8 * ((kv + it) % kStages), ((kv + it) / kStages) & 1);
      };
      auto release = [&](uint32_t free, int it) {
        if (lane == 0) mbar_arrive(free + 8 * ((kv + it) % kStages));
      };

      // Online softmax of tile it's scores, in place: element e = 4 j + i is
      // (row0 if i < 2 else row1, key k0 + 8 j + 2 t4 + i % 2). With a
      // positive scale c (log2 units) the row maxima are taken on the raw
      // scores and each exponent is one fma, exp2(c s - m); a non-positive
      // scale is applied first. On a tile that a row sees only in part (the
      // causal diagonal, the window's edge, keys past Sk) a key the row does
      // not see becomes -inf, in one pass of its own so that the other tiles
      // run no mask. Row maxima and sums run as four partial chains a row.
      auto softmax = [&](int it) {
        const int k0 = t.r.k_begin + it * KT;
        float c = p.scale_log2;
        if (!(c > 0.f)) {
#pragma unroll
          for (int e = 0; e < KT / 2; ++e) sc[e] *= c;
          c = 1.f;
        }
        if (!tile_full(p, rc, k0, KT)) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int pos = (half ? row1 : row0) + off;
            const int lo = p.window >= 0 ? pos - p.window + 1 : 0;    // visible keys: [lo, hi]
            const int hi = p.causal ? min(pos, p.sk - 1) : p.sk - 1;
#pragma unroll
            for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
              for (int i = 2 * half; i < 2 * half + 2; ++i) {
                const int key = k0 + 8 * j + 2 * t4 + (i & 1);
                if (key < lo || key > hi) sc[4 * j + i] = -INFINITY;
              }
            }
          }
        }
        float part[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[j][q] = -INFINITY;
#pragma unroll
        for (int e = 0; e < KT / 2; ++e)
          part[(e >> 1) & 1][(e >> 2) & 3] = fmaxf(part[(e >> 1) & 1][(e >> 2) & 3], sc[e]);
        float neg_base[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float mx = fmaxf(fmaxf(part[j][0], part[j][1]), fmaxf(part[j][2], part[j][3]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[j], c * mx);          // c * -inf = -inf: no key yet
          const float base_m = m_new == -INFINITY ? 0.f : m_new;
          alpha[j] = fast_exp2(m[j] - base_m);
          m[j] = m_new;
          neg_base[j] = -base_m;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[j][q] = 0.f;
#pragma unroll
        for (int e = 0; e < KT / 2; ++e) {
          sc[e] = fast_exp2(fmaf(sc[e], c, neg_base[(e >> 1) & 1]));
          part[(e >> 1) & 1][(e >> 2) & 3] += sc[e];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
          l[j] = l[j] * alpha[j] + ((part[j][0] + part[j][1]) + (part[j][2] + part[j][3]));
      };
      auto rescale_and_pack = [&]() {
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
#pragma unroll
        for (int j = 0; j < KT / 16; ++j) {
          pa[j][0] = Mma<T>::pack(sc[8 * j], sc[8 * j + 1]);
          pa[j][1] = Mma<T>::pack(sc[8 * j + 2], sc[8 * j + 3]);
          pa[j][2] = Mma<T>::pack(sc[8 * j + 4], sc[8 * j + 5]);
          pa[j][3] = Mma<T>::pack(sc[8 * j + 6], sc[8 * j + 7]);
        }
      };

      mbar_wait(q_full + 8 * qb, (n >> 1) & 1);
      if (t.n_tiles > 0) {
        if (cw == 0) named_arrive(1);   // the first warpgroup issues first
        wait_full(k_full, 0);
        named_sync(1 + cw);
        wg_fence();
        issue_s(0);
        wg_commit();
        named_arrive(2 - cw);
        wg_wait<0>();
        fence_regs(sc);
        release(k_free, 0);
        softmax(0);
        rescale_and_pack();
      }
      for (int it = 1; it < t.n_tiles; ++it) {
        wait_full(k_full, it);
        wait_full(v_full, it - 1);
        named_sync(1 + cw);
        wg_fence();
        issue_s(it);
        wg_commit();
        issue_pv(it - 1);
        wg_commit();
        named_arrive(2 - cw);
        wg_wait<1>();                  // S of tile it is done; P V may still run
        fence_regs(sc);
        release(k_free, it);
        softmax(it);
        wg_wait<0>();
        fence_regs(o);
        release(v_free, it - 1);
        rescale_and_pack();
      }
      if (t.n_tiles > 0) {             // the last tile's P V
        wait_full(v_full, t.n_tiles - 1);
        if (cw == 0) named_sync(1);    // takes the second warpgroup's last turn signal
        wg_fence();
        issue_pv(t.n_tiles - 1);
        wg_commit();
        wg_wait<0>();
        fence_regs(o);
        release(v_free, t.n_tiles - 1);
      }
      kv += t.n_tiles;

      // Row sums across the four lanes of a row; a row that saw no key is
      // 0. The normalised tile goes through this warpgroup's rows of the Q
      // buffer (done with once its last S is), in Q's own 128-byte-swizzled
      // layout, so the 4-byte writes and the 16-byte reads hit distinct
      // banks, and leaves as 16-byte stores of the first d columns (the
      // padding's are zeros, never stored), rows past Sq skipped. Then the
      // Q buffer is free for the item after next.
      float inv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
        l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
        inv[j] = l[j] == 0.f ? 1.f : 1.f / l[j];
      }
      uint8_t* stage = smem_raw + (q_at - smem_u32(smem_raw));
      auto chunk_at = [&](int row, int chunk) {    // row of this warpgroup, 16-byte chunk
        return (chunk / 8) * L::kQBox + row * kRowBytes + (((chunk % 8) ^ (row % 8)) << 4);
      };
      const int r0 = warp * 16 + g;
      named_sync_wg(3 + cw);           // the warpgroup's products are done with Q
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        *reinterpret_cast<uint32_t*>(stage + chunk_at(r0, j) + 4 * t4) =
            Mma<T>::pack(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
        *reinterpret_cast<uint32_t*>(stage + chunk_at(r0 + 8, j) + 4 * t4) =
            Mma<T>::pack(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
      }
      named_sync_wg(3 + cw);
      T* og = static_cast<T*>(p.o) + t.b * p.o_sb + t.h * p.o_sh;
      const int chunks = p.d / 8;
#pragma unroll
      for (int i = 0; i < DP / 16; ++i) {          // 64 rows x DP / 8 chunks, 128 threads
        const int q = tid + 128 * i;
        const int row = q / (DP / 8), chunk = q % (DP / 8);
        if (rows0 + row < p.sq && chunk < chunks)
          *reinterpret_cast<uint4*>(og + (rows0 + row) * p.o_ss + chunk * 8) =
              *reinterpret_cast<const uint4*>(stage + chunk_at(row, chunk));
      }
      if (lane == 0) mbar_arrive(q_free + 8 * qb);
    }
  }
}

// cuTensorMapEncodeTiled is a driver-API function; it is reached through the
// runtime's driver entry point, so the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kErrNoEncode = -1;     // the driver offers no cuTensorMapEncodeTiled
constexpr int kErrMapRefused = -2;   // cuTensorMapEncodeTiled refused a map
constexpr int kMaxDevices = 64;

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// geom (9 values, from tma_geometry in kernels/flash_attention/kernel.py):
// the extents (D, S, H, B) innermost first, the byte strides of S, H and B,
// and the box (columns, rows).
int encode_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
               const unsigned long long* geom) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t dims[4] = {geom[0], geom[1], geom[2], geom[3]};
  const cuuint64_t strides[3] = {geom[4], geom[5], geom[6]};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(geom[7]), static_cast<cuuint32_t>(geom[8]),
                             1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrMapRefused;
}

// The wgmma route's instantiation (padded width) that runs head dimension d:
// 64 at d = 64, 128 at d = 72 ... 128, 192 at d = 136 ... 192, d a multiple
// of 8 (whole 16-byte rows, TMA's unit); 0 for any other d.
int wgmma_instance(int d) {
  if (d % 8 != 0 || d < 64 || d > 192) return 0;
  return d == 64 ? 64 : d <= 128 ? 128 : 192;
}

template <typename T, int DP>
int launch_wgmma(const Params& p, const unsigned long long* geom, int b, int hq,
                 cudaStream_t stream) {
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const void* ptrs[3] = {p.q, p.k, p.v};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {   // q in boxes of 128 rows, k and v of a key tile's
    const unsigned long long* g = geom + 9 * i;
    const unsigned long long rows = i == 0 ? kWgRows : WgSmem<DP>::kKeys;
    if (g[0] != (unsigned long long)p.d || g[7] != kBoxCols || g[8] != rows)
      return (int)cudaErrorInvalidValue;
    const int err = encode_map(&maps[i], ptrs[i], type, g);
    if (err != 0) return err;
  }
  constexpr int kSmem = WgSmem<DP>::kBytes;
  static bool attribute_set[kMaxDevices] = {};   // before an instance's first launch
  int device = 0;
  const cudaError_t got = cudaGetDevice(&device);
  if (got != cudaSuccess) return (int)got;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!attribute_set[device]) {
    const cudaError_t set = cudaFuncSetAttribute(
        flash_wgmma_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (set != cudaSuccess) return (int)set;
    attribute_set[device] = true;
  }
  static int sms[kMaxDevices] = {};
  if (sms[device] == 0) {
    const cudaError_t got_sms =
        cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (got_sms != cudaSuccess) return (int)got_sms;
  }
  const long long items = (long long)p.q_tiles * hq * b;
  if (items > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(items < sms[device] ? items : sms[device]));
  flash_wgmma_kernel<T, DP><<<grid, kWgThreads, kSmem, stream>>>(maps[0], maps[1], maps[2], p);
  return (int)cudaGetLastError();
}

// The head dimensions the mma and ffma kernels are instantiated at.
constexpr int kHeadDims[] = {16, 32, 64, 96, 128, 160, 192, 256};

// The instantiation that runs head dimension d: the next one up (0: none).
int head_dim_instance(int d) {
  if (d < 1) return 0;
  for (int D : kHeadDims)
    if (d <= D) return D;
  return 0;
}

// A grid of 64-row query tiles x heads x batch; `set` holds, per device,
// whether the kernel's opt-in to `smem` bytes is made.
template <typename K>
int launch(K kernel, int smem, bool* set, const Params& p, int b, int hq,
           cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    int device = 0;
    const cudaError_t got = cudaGetDevice(&device);
    if (got != cudaSuccess) return (int)got;
    if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!set[device]) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      set[device] = true;
    }
  }
  const dim3 grid((unsigned)((p.sq + kBQ - 1) / kBQ), (unsigned)hq, (unsigned)b);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_mma(const Params& p, int b, int hq, cudaStream_t stream) {
  static bool set[kMaxDevices] = {};
  constexpr int kSmem = 2 * kBK * (D + 8) * (int)sizeof(T);   // K and V tiles
  return launch(flash_mma_kernel<T, D>, kSmem, set, p, b, hq, stream);
}

template <int D>
int launch_ffma(const Params& p, int b, int hq, cudaStream_t stream) {
  static bool set[kMaxDevices] = {};
  constexpr int kSmem = 2 * kBKF * (D + 8) * (int)sizeof(float);
  return launch(flash_f32_kernel<D>, kSmem, set, p, b, hq, stream);
}

template <typename T>
int launch_16bit(const Params& p, int route, const unsigned long long* geom, int b, int hq,
                 int d, cudaStream_t stream) {
  if (route == kRouteWgmma && geom != nullptr) {
    switch (wgmma_instance(d)) {
      case 64: return launch_wgmma<T, 64>(p, geom, b, hq, stream);
      case 128: return launch_wgmma<T, 128>(p, geom, b, hq, stream);
      case 192: return launch_wgmma<T, 192>(p, geom, b, hq, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (route != kRouteMma) return (int)cudaErrorInvalidValue;
  switch (head_dim_instance(d)) {
    case 16: return launch_mma<T, 16>(p, b, hq, stream);
    case 32: return launch_mma<T, 32>(p, b, hq, stream);
    case 64: return launch_mma<T, 64>(p, b, hq, stream);
    case 96: return launch_mma<T, 96>(p, b, hq, stream);
    case 128: return launch_mma<T, 128>(p, b, hq, stream);
    case 160: return launch_mma<T, 160>(p, b, hq, stream);
    case 192: return launch_mma<T, 192>(p, b, hq, stream);
    case 256: return launch_mma<T, 256>(p, b, hq, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_f32(const Params& p, int b, int hq, int d, cudaStream_t stream) {
  switch (head_dim_instance(d)) {
    case 16: return launch_ffma<16>(p, b, hq, stream);
    case 32: return launch_ffma<32>(p, b, hq, stream);
    case 64: return launch_ffma<64>(p, b, hq, stream);
    case 96: return launch_ffma<96>(p, b, hq, stream);
    case 128: return launch_ffma<128>(p, b, hq, stream);
    case 160: return launch_ffma<160>(p, b, hq, stream);
    case 192: return launch_ffma<192>(p, b, hq, stream);
    case 256: return launch_ffma<256>(p, b, hq, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// out = attention(q, k, v) on `stream`. dtype: 0 float32, 1 bfloat16,
// 2 float16; route: 0 ffma, 1 mma, 2 wgmma (it must be the one flash_route
// gives for dtype and d); strides in elements (batch, head, sequence; the
// head dimension is contiguous); vec: nonzero when d is a whole number of
// 16-byte vectors and every row of the four tensors is 16-byte aligned (it
// must be on the wgmma route); tma: the three tensor maps' geometry (27
// values, q, k, v) on the wgmma route, else null; window < 0 means none.
// Returns the cudaError_t of the launch (0 = success), -1 when the driver
// offers no cuTensorMapEncodeTiled, -2 when it refuses a tensor map.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int route, int b,
    int hq, int hkv, int sq, int sk, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int vec,
    const unsigned long long* tma, int causal, int window, float scale, void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || sk < 0 || hq > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.sq = sq; p.sk = sk; p.group = hq / hkv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.causal = causal ? 1 : 0;
  p.window = window;
  p.scale_log2 = scale * kLog2e;
  p.heads = hq;
  p.batch = b;
  p.q_tiles = (sq + kWgRows - 1) / kWgRows;
  {   // the wgmma route's chunks of (batch, head) pairs whose K and V fit kL2Chunk
    const long long pair_bytes = 4LL * sk * d / p.group;   // a pair's share of K and V
    const long long pairs = (long long)hq * b;
    const long long g = pair_bytes > 0 ? kL2Chunk / pair_bytes : pairs;
    p.pairs = (int)(g < 1 ? 1 : g > pairs ? pairs : g);
  }
  p.d = d;
  p.vec = vec ? 1 : 0;
  if (route == kRouteWgmma && !p.vec) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && route == kRouteFfma) return launch_f32(p, b, hq, d, st);
  if (dtype == 1) return launch_16bit<__nv_bfloat16>(p, route, tma, b, hq, d, st);
  if (dtype == 2) return launch_16bit<__half>(p, route, tma, b, hq, d, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the wgmma route at head dimension d
// (0 for a d it does not take).
extern "C" int flash_attention_wgmma_smem_bytes(int d) {
  switch (wgmma_instance(d)) {
    case 64: return WgSmem<64>::kBytes;
    case 128: return WgSmem<128>::kBytes;
    case 192: return WgSmem<192>::kBytes;
  }
  return 0;
}

// The head dimension of the mma / ffma instantiation that runs d (0: none).
extern "C" int flash_attention_head_dim_instance(int d) { return head_dim_instance(d); }
