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
// Layout. Every tensor is read and written through its own (batch, head,
// sequence) strides in elements, with the last axis contiguous, so the
// (B, H, S, D) views that the layer makes with transpose(1, 2) of
// (B, S, H, D) projections go in without a copy, and the output is written
// in the layout of q. Ragged Sq and Sk are masked inside the kernel: rows
// past Sq are not stored, keys past Sk are zero-filled in shared memory and
// masked. Nothing is padded by the wrapper.
//
// Work skipped. A block owns 64 query rows of one (batch, head). Its loop
// over key tiles runs only from the window's first key tile to the causal
// diagonal's last one (the TPU kernel's `run` test and pl.when); a tile that
// is visible for every row of the block skips the per-element mask. Blocks
// take the query tiles from the last one down, so the longest causal rows
// start first.
//
// bf16 / fp16: four warps of 16 query rows each. Q's fragments are loaded
// from global memory into registers once; each 64-key tile of K and V is
// staged in shared memory (rows padded by 16 bytes: 34 KB at D = 128). S =
// Q K^T and O += P V run on mma.sync.m16n8k16 with float32 accumulators; V's
// fragments come from ldmatrix.trans. P is rounded to the input type for the
// P V product, as FlashAttention and the model's own _gqa_combine do; the TPU
// kernel keeps P in float32. That rounding moves each output by at most
// 2^-9 * sum_j p_j |v_j| / l <= 2^-9 max|v| (about 2^-8 max|v| with the
// output's own rounding to bf16), row by row, against flash_attention_ref.
//
// float32: the same loop on FFMA in true float32 (no TF32 anywhere): a pair
// of lanes owns one query row, each holding half of q and of the
// accumulator; the two halves of each dot product meet through one shuffle.
// Key tiles are 32 wide, and the second half of each row sits 4 words
// further in shared memory, so the pair's two reads hit different banks.
//
// Bound on the H100. At the serving path's prefill shape, q (4, 16, 2048,
// 128) against k, v (4, 8, 2048, 128) in bf16, causal, the function does
// 4 * D flops on each of 2 098 176 visible (query, key) pairs of each of the
// 64 (batch, head) pairs: 68.7 GFLOP, 0.0695 ms at 989 TFLOP/s dense bf16,
// against 100.7 MB moved, 0.030 ms at 3.35 TB/s. The tensor cores, not the
// bytes, bound it; this first kernel (synchronous tile loads, mma.sync
// rather than wgmma) is written to be right, and making it reach that bound
// is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows a block
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;          // keys a tile, bf16 / fp16
constexpr int kBKF = 32;         // keys a tile, float32
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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
};

__device__ __forceinline__ bool visible(const Params& p, int pos, int key) {
  return key < p.sk && (!p.causal || key <= pos) &&
         (p.window < 0 || key > pos - p.window);
}

// The block's query positions [pos_lo, pos_hi] and the tile-aligned key range
// [k_begin, k_end) that holds every key one of them sees.
struct Range {
  int pos_lo, pos_hi, k_begin, k_end;
};

__device__ __forceinline__ Range block_range(const Params& p, int q0, int tile) {
  Range r;
  const int off = p.sk - p.sq;
  r.pos_lo = q0 + off;
  r.pos_hi = min(q0 + kBQ, p.sq) - 1 + off;
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
// bf16 / fp16 on the tensor cores
// ---------------------------------------------------------------------------

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
  __shared__ __align__(16) T ks[kBK * kStride];
  __shared__ __align__(16) T vs[kBK * kStride];

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
  // a3 (row1, c+8..), c = 16 kk + 2 t4; rows past Sq are zero.
  uint32_t qf[kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    const int c = kk * 16 + t4 * 2;
    const T* r0p = qg + row0 * p.q_ss + c;
    const T* r1p = qg + row1 * p.q_ss + c;
    qf[kk][0] = row0 < p.sq ? *reinterpret_cast<const uint32_t*>(r0p) : 0u;
    qf[kk][1] = row1 < p.sq ? *reinterpret_cast<const uint32_t*>(r1p) : 0u;
    qf[kk][2] = row0 < p.sq ? *reinterpret_cast<const uint32_t*>(r0p + 8) : 0u;
    qf[kk][3] = row1 < p.sq ? *reinterpret_cast<const uint32_t*>(r1p + 8) : 0u;
  }

  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};       // this lane's part of the row sums

  const Range r = block_range(p, q0, kBK);
  for (int k0 = r.k_begin; k0 < r.k_end; k0 += kBK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kBK * kVec; e += kThreads) {
      const int row = e / kVec, c = (e % kVec) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + row < p.sk) {
        kv = *reinterpret_cast<const uint4*>(kg + (k0 + row) * p.k_ss + c);
        vv = *reinterpret_cast<const uint4*>(vg + (k0 + row) * p.v_ss + c);
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
      *reinterpret_cast<uint32_t*>(og + row0 * p.o_ss + c) =
          Mma<T>::pack(acc[n][0] / l[0], acc[n][1] / l[0]);
    if (row1 < p.sq)
      *reinterpret_cast<uint32_t*>(og + row1 * p.o_ss + c) =
          Mma<T>::pack(acc[n][2] / l[1], acc[n][3] / l[1]);
  }
}

// ---------------------------------------------------------------------------
// float32 on FFMA
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(Params p) {
  constexpr int kH = D / 2;            // a lane's half of a row
  constexpr int kStride = D + 8;       // words; the second half starts 4 later
  __shared__ __align__(16) float ks[kBKF * kStride];
  __shared__ __align__(16) float vs[kBKF * kStride];

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
    if (row < p.sq) x = *reinterpret_cast<const float4*>(qg + row * p.q_ss + half * kH + d);
    q[d] = x.x; q[d + 1] = x.y; q[d + 2] = x.z; q[d + 3] = x.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m = kNeg, l = 0.f;

  const Range r = block_range(p, q0, kBKF);
  for (int k0 = r.k_begin; k0 < r.k_end; k0 += kBKF) {
    __syncthreads();
    for (int e = threadIdx.x; e < kBKF * (D / 4); e += kThreads) {
      const int kr = e / (D / 4), c = (e % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + kr < p.sk) {
        kv = *reinterpret_cast<const float4*>(kg + (k0 + kr) * p.k_ss + c);
        vv = *reinterpret_cast<const float4*>(vg + (k0 + kr) * p.v_ss + c);
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
#pragma unroll
    for (int d = 0; d < kH; d += 4) {
      *reinterpret_cast<float4*>(og + row * p.o_ss + half * kH + d) =
          make_float4(acc[d] / den, acc[d + 1] / den, acc[d + 2] / den, acc[d + 3] / den);
    }
  }
}

template <typename K>
int launch(K kernel, const Params& p, int b, int hq, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.sq + kBQ - 1) / kBQ), (unsigned)hq, (unsigned)b);
  kernel<<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mma(const Params& p, int b, int hq, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch(flash_mma_kernel<T, 16>, p, b, hq, stream);
    case 32: return launch(flash_mma_kernel<T, 32>, p, b, hq, stream);
    case 64: return launch(flash_mma_kernel<T, 64>, p, b, hq, stream);
    case 128: return launch(flash_mma_kernel<T, 128>, p, b, hq, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_f32(const Params& p, int b, int hq, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch(flash_f32_kernel<16>, p, b, hq, stream);
    case 32: return launch(flash_f32_kernel<32>, p, b, hq, stream);
    case 64: return launch(flash_f32_kernel<64>, p, b, hq, stream);
    case 128: return launch(flash_f32_kernel<128>, p, b, hq, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// out = attention(q, k, v) on `stream`. dtype: 0 float32, 1 bfloat16,
// 2 float16; strides in elements (batch, head, sequence; the head dimension
// is contiguous); window < 0 means none. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int b,
    int hq, int hkv, int sq, int sk, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, float scale, void* stream) {
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_f32(p, b, hq, d, st);
    case 1: return launch_mma<__nv_bfloat16>(p, b, hq, d, st);
    case 2: return launch_mma<__half>(p, b, hq, d, st);
  }
  return (int)cudaErrorInvalidValue;
}
