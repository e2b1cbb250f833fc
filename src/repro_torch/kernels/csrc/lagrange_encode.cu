// Lagrange encode as a float32 GEMM, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package,
// src/repro/kernels/lagrange_encode/kernel.py:36 encode_matrix_pallas (body
// _encode_kernel). The port's wrapper is encode_matrix_cuda in
// kernels/lagrange_encode/kernel.py.
//
// What it computes: out = g @ x, g (nr, k), x (k, cols), out (nr, cols),
// float32, row-major and contiguous, every product accumulated with a fused
// multiply-add in float32 (FFMA; no TF32, no tensor cores).
//
// Design. The generator g is small (nr <= a few hundred, k <= 512) and x is
// wide (cols = rows * columns of a chunk, 1e5..1e7). As in the TPU kernel a
// block owns one output tile and the whole contraction axis k: it loops over
// k in steps of 16, staging a (64 x 16) tile of g and a (16 x 128) tile of x
// through shared memory, and keeps its 64 x 128 outputs in registers (8 x 4
// per thread). A warp's 32 threads own 32 consecutive columns of a row, so
// every load of x and every store of out is one contiguous 128-byte line.
// Ragged edges load zeros and are masked on the store.
//
// Bound on the H100. At the coded regression's shape, (150, 8) @ (8, 180 000),
// the kernel reads 5.8 MB of x and writes 108 MB of out, 114 MB in all:
// 0.034 ms at 3.35 TB/s. Its 0.43 GFLOP take 0.0064 ms at 67 TFLOP/s FP32, so
// the output write bounds it; the design makes that write coalesced and
// writes each output once. The 64-row tile over nr = 150 reads x three times,
// which the 50 MB L2 mostly serves.

#include <cuda_runtime.h>

namespace {

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

}  // namespace

// out = g @ x on `stream`. Returns the cudaError_t of the launch (0 = success).
extern "C" int lagrange_encode(const float* g, const float* x, float* out,
                               int nr, int k, int cols, void* stream) {
  if (nr <= 0 || cols <= 0) return 0;
  if (k < 0) return (int)cudaErrorInvalidValue;
  const long long tiles_m = (nr + kTM - 1) / kTM;
  const long long tiles_n = (cols + kTN - 1) / kTN;
  if (tiles_m > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles_n, (unsigned)tiles_m);
  encode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, x, out, nr, k, cols);
  return (int)cudaGetLastError();
}
