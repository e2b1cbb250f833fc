// Lagrange encode as a float32 GEMM, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package,
// src/repro/kernels/lagrange_encode/kernel.py:36 encode_matrix_pallas (body
// _encode_kernel). The port's wrapper is encode_matrix_cuda in
// kernels/lagrange_encode/kernel.py.
//
// What it computes: out = g @ x, g (nr, k), x (k, cols), out (nr, cols),
// float32, row-major and contiguous, every product accumulated with a fused
// multiply-add in float32 in ascending k (FFMA; no TF32, no tensor cores).
//
// Bound on the H100. At the coded regression's shape, (150, 8) @ (8, 180 000),
// the function reads 5.8 MB of x and writes 108 MB of out, 114 MB in all:
// 0.034 ms at 3.35 TB/s. Its 0.43 GFLOP take 0.0064 ms at 67 TFLOP/s FP32, so
// the output write bounds it.
//
// Routes, chosen by the wrapper from k, cols and x's alignment (encode_route):
//
//   stream (1 <= k <= 16, cols % 4 == 0, x 16-byte aligned): a streaming
//     write. A thread owns 4 consecutive columns: it loads its (k x 4) strip
//     of x once, with 16-byte loads, into registers, then walks its block's
//     rows of g, kept in shared memory (every thread reads the same element:
//     a broadcast), and stores each row's float4 with a streaming 16-byte
//     store (st.global.cs), so a warp writes 512 contiguous bytes of a row
//     and the 108 MB of output do not evict x from L2. x is read once from
//     memory; rows are split over gridDim.y so the card has enough blocks in
//     flight, each block re-reading its x strip from L2.
//   stream_scalar (1 <= k <= 16, ragged cols): the same with 4-byte loads
//     and stores, for rows that are not 16-byte aligned.
//   tiled (k = 0 or k > 16, the wrapper takes any k; the JAX docstring
//     promises k <= 512): a block owns a 64 x 128 output tile and loops over
//     k in steps of 16 through shared memory, 8 x 4 outputs a thread; every
//     load of x and store of out is one contiguous 128-byte line.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- tiled route -------------------------------------------------------------
constexpr int kTM = 64, kTN = 128, kTK = 16;
constexpr int kRM = 8, kRN = 4;
constexpr int kTX = kTN / kRN;   // 32: one warp spans a row of the tile
constexpr int kTY = kTM / kRM;   // 8
constexpr int kThreads = kTX * kTY;

__global__ void __launch_bounds__(kThreads)
encode_kernel(const float* __restrict__ g, const float* __restrict__ x,
              float* __restrict__ out, int nr, int k, int cols) {
  __shared__ float gs[kTK][kTM + 1];   // g tile, transposed: gs[kk][row]
  __shared__ float xs[kTK][kTN];

  const int row0 = blockIdx.y * kTM;
  const int col0 = blockIdx.x * kTN;
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;

  float acc[kRM][kRN];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kTK) {
    for (int e = tid; e < kTM * kTK; e += kThreads) {
      const int r = e / kTK, kk = e % kTK;
      const int gr = row0 + r, gk = k0 + kk;
      gs[kk][r] = (gr < nr && gk < k) ? g[(long long)gr * k + gk] : 0.f;
    }
    for (int e = tid; e < kTK * kTN; e += kThreads) {
      const int kk = e / kTN, c = e % kTN;
      const int gk = k0 + kk, gc = col0 + c;
      xs[kk][c] = (gk < k && gc < cols) ? x[(long long)gk * cols + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float gv[kRM], xv[kRN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) gv[i] = gs[kk][ty + i * kTY];
#pragma unroll
      for (int j = 0; j < kRN; ++j) xv[j] = xs[kk][tx + j * kTX];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) acc[i][j] = __fmaf_rn(gv[i], xv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int gr = row0 + ty + i * kTY;
    if (gr >= nr) continue;
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int gc = col0 + tx + j * kTX;
      if (gc < cols) out[(long long)gr * cols + gc] = acc[i][j];
    }
  }
}

// -- stream routes -----------------------------------------------------------

constexpr int kStreamMaxK = 16;       // the most k the stream route keeps in registers
constexpr int kStreamThreads = 128;
constexpr int kStreamMaxRows = 512;   // rows of g a block stages: 32 KB at k = 16
constexpr int kStreamBlocksPerSm = 8;    // blocks to aim for on each streaming multiprocessor
constexpr int kMaxDevices = 64;
constexpr int kRouteTiled = 0, kRouteStream = 1, kRouteStreamScalar = 2;

template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p, long long left) {
  if constexpr (kVec) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(__ldg(p), 0.f, 0.f, 0.f);
  if (left > 1) v.y = __ldg(p + 1);
  if (left > 2) v.z = __ldg(p + 2);
  if (left > 3) v.w = __ldg(p + 3);
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store4(float* p, float4 v, long long left) {
  if constexpr (kVec) {
    __stcs(reinterpret_cast<float4*>(p), v);
    return;
  }
  __stcs(p, v.x);
  if (left > 1) __stcs(p + 1, v.y);
  if (left > 2) __stcs(p + 2, v.z);
  if (left > 3) __stcs(p + 3, v.w);
}

template <int K, bool kVec>
__global__ void __launch_bounds__(kStreamThreads)
encode_stream_kernel(const float* __restrict__ g, const float* __restrict__ x,
                     float* __restrict__ out, int nr, int cols, int rows_per_block) {
  extern __shared__ float gs[];        // this block's rows of g, (rows, K)
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(nr, r0 + rows_per_block);
  for (int e = threadIdx.x; e < (r1 - r0) * K; e += kStreamThreads)
    gs[e] = g[(long long)r0 * K + e];
  __syncthreads();
  const long long c = 4ll * ((long long)blockIdx.x * kStreamThreads + threadIdx.x);
  if (c >= cols) return;
  float4 xv[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) xv[kk] = load4<kVec>(x + kk * (long long)cols + c, cols - c);
  for (int row = r0; row < r1; ++row) {
    const float* gr = gs + (row - r0) * K;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const float gv = gr[kk];
      acc.x = __fmaf_rn(gv, xv[kk].x, acc.x);
      acc.y = __fmaf_rn(gv, xv[kk].y, acc.y);
      acc.z = __fmaf_rn(gv, xv[kk].z, acc.z);
      acc.w = __fmaf_rn(gv, xv[kk].w, acc.w);
    }
    store4<kVec>(out + row * (long long)cols + c, acc, cols - c);
  }
}

// Rows a block walks: as many as keep kStreamBlocksPerSm blocks in flight on
// each of the card's `sms` multiprocessors, at most kStreamMaxRows.
int stream_rows(int nr, int cols, int sms) {
  const long long col_blocks = ((cols + 3ll) / 4 + kStreamThreads - 1) / kStreamThreads;
  const long long want = (long long)kStreamBlocksPerSm * sms;
  long long splits = (want + col_blocks - 1) / col_blocks;
  splits = splits < 1 ? 1 : (splits > nr ? nr : splits);
  long long rows = (nr + splits - 1) / splits;
  return (int)(rows > kStreamMaxRows ? kStreamMaxRows : rows);
}

template <int K, bool kVec>
int launch_stream(const float* g, const float* x, float* out, int nr, int cols,
                  int rows_per_block, cudaStream_t stream) {
  const long long col_blocks = ((cols + 3ll) / 4 + kStreamThreads - 1) / kStreamThreads;
  const long long row_blocks = (nr + rows_per_block - 1) / rows_per_block;
  if (col_blocks > 0x7fffffffll || row_blocks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)col_blocks, (unsigned)row_blocks);
  const size_t smem = sizeof(float) * K * rows_per_block;
  encode_stream_kernel<K, kVec><<<grid, kStreamThreads, smem, stream>>>(g, x, out, nr, cols,
                                                                        rows_per_block);
  return (int)cudaGetLastError();
}

template <bool kVec>
int launch_stream_k(const float* g, const float* x, float* out, int nr, int k, int cols,
                    int rows_per_block, cudaStream_t stream) {
  switch (k) {
#define ENCODE_STREAM_CASE(K) \
  case K: return launch_stream<K, kVec>(g, x, out, nr, cols, rows_per_block, stream);
    ENCODE_STREAM_CASE(1) ENCODE_STREAM_CASE(2) ENCODE_STREAM_CASE(3) ENCODE_STREAM_CASE(4)
    ENCODE_STREAM_CASE(5) ENCODE_STREAM_CASE(6) ENCODE_STREAM_CASE(7) ENCODE_STREAM_CASE(8)
    ENCODE_STREAM_CASE(9) ENCODE_STREAM_CASE(10) ENCODE_STREAM_CASE(11) ENCODE_STREAM_CASE(12)
    ENCODE_STREAM_CASE(13) ENCODE_STREAM_CASE(14) ENCODE_STREAM_CASE(15) ENCODE_STREAM_CASE(16)
#undef ENCODE_STREAM_CASE
  }
  return (int)cudaErrorInvalidValue;
}

int launch_tiled(const float* g, const float* x, float* out, int nr, int k, int cols,
                 cudaStream_t stream) {
  const long long tiles_m = (nr + kTM - 1) / kTM;
  const long long tiles_n = (cols + kTN - 1) / kTN;
  if (tiles_m > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles_n, (unsigned)tiles_m);
  encode_kernel<<<grid, kThreads, 0, stream>>>(g, x, out, nr, k, cols);
  return (int)cudaGetLastError();
}

}  // namespace

// out = g @ x on `stream` by `route` (0 tiled, 1 stream, 2 stream_scalar: the
// one encode_route gives). Returns the cudaError_t of the launch (0 = success).
extern "C" int lagrange_encode(const float* g, const float* x, float* out,
                               int nr, int k, int cols, int route, void* stream) {
  if (nr <= 0 || cols <= 0) return 0;
  if (k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteTiled) return launch_tiled(g, x, out, nr, k, cols, st);
  if (k < 1 || k > kStreamMaxK) return (int)cudaErrorInvalidValue;
  static int sms[kMaxDevices] = {};    // multiprocessors of each device, read once
  int device = 0;
  const cudaError_t got = cudaGetDevice(&device);
  if (got != cudaSuccess) return (int)got;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    const cudaError_t got_sms =
        cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (got_sms != cudaSuccess) return (int)got_sms;
  }
  const int rows = stream_rows(nr, cols, sms[device]);
  if (route == kRouteStream) {
    if (cols % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return launch_stream_k<true>(g, x, out, nr, k, cols, rows, st);
  }
  if (route == kRouteStreamScalar) return launch_stream_k<false>(g, x, out, nr, k, cols, rows, st);
  return (int)cudaErrorInvalidValue;
}
