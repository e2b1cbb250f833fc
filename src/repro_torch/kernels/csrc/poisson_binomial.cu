// Batched Poisson-binomial prefix tails for the LEA allocator, CUDA C++ for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package,
// src/repro/kernels/poisson_binomial/kernel.py:
//   success_tails_pallas   (line 117, body _pb_kernel)   - one static threshold
//                                                          tuple for all rows
//   success_tails_pallas_w (line 147, body _pb_kernel_w) - per-row thresholds
// Both entry points of the port (success_tails_cuda, success_tails_cuda_w in
// kernel.py beside this file) launch the kernels below; the thresholds come as
// a device int32 array with a row stride: 0 for the shared (n,) tuple, n for
// per-row (B, n) thresholds.
//
// What it computes, per row b of a (B, n) float32 array of probabilities
// sorted descending, and int32 thresholds w:
//   out[b, i] = P[ Poisson-binomial(p[b, 0..i]) >= max(w[b, i], 0) ]
//   out[b, i] = 0 where w[b, i] > i + 1 (an infeasible prefix).
//
// Design. The TPU kernel keeps a (rows, 128-lane) pmf tile in VMEM and
// unrolls the worker loop at trace time. Here one thread owns one row and
// keeps its pmf over counts 0..n in registers: the template NMAX in
// {16, 32, 64} is picked from n, every loop is unrolled with an `i < n`
// guard, so every pmf index is a compile-time constant and nothing spills.
// Step i convolves one Bernoulli in place, from the high count down:
//   pmf[c] = fma(pmf[c-1], p, pmf[c] * (1 - p))
// then sums the tail over ascending counts. The intrinsics (__fmaf_rn,
// __fmul_rn, __fadd_rn) pin that exact sequence of roundings, which is the
// one XLA produces for the JAX package's reference DP on the CPU and the one
// the port's plain PyTorch version (ref.py) repeats, so kernel and plain
// version agree to the bit. For n > 64 a second kernel keeps each thread's
// pmf in shared memory (strided by the block size to avoid bank conflicts)
// with the same arithmetic; it serves any n whose pmf fits in 48 KB for one
// thread.
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s FP32 without tensor cores).
// Per-row thresholds: the kernel reads B*n*(4 + 4) bytes and writes B*n*4:
// at B = 1e6, n = 15 that is 180 MB, about 54 us. The arithmetic is about
// n^2 fused multiply-adds plus ~n^2/2 tail adds a row (~2n^2 flop), so the
// kernel is memory-bound at the paper's n = 15 and near the FP32 ridge at
// n = 64. Known limit of this first version: a thread reads its own row of a
// row-major (B, n) array, so a warp's loads are strided by n*4 bytes and not
// coalesced; staging row tiles through shared memory is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int NMAX>
__global__ void __launch_bounds__(kThreads)
pb_tails_regs(const float* __restrict__ probs, const int* __restrict__ w,
              float* __restrict__ out, long long rows, int n,
              long long w_stride) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const float* p_row = probs + row * n;
  const int* w_row = w + row * w_stride;
  float* o_row = out + row * n;

  float pmf[NMAX + 1];
#pragma unroll
  for (int c = 0; c <= NMAX; ++c) pmf[c] = 0.f;
  pmf[0] = 1.f;

#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    if (i < n) {
      const float p = p_row[i];
      const float q = __fsub_rn(1.f, p);
#pragma unroll
      for (int c = i + 1; c >= 1; --c) {
        pmf[c] = __fmaf_rn(pmf[c - 1], p, __fmul_rn(pmf[c], q));
      }
      pmf[0] = __fmul_rn(pmf[0], q);
      const int wi = w_row[i];
      const int lo = wi > 0 ? wi : 0;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c <= i + 1; ++c) {
        if (c >= lo) acc = __fadd_rn(acc, pmf[c]);
      }
      o_row[i] = (wi > i + 1) ? 0.f : acc;
    }
  }
}

// n > 64: the same DP with the pmf of thread t at smem[c * blockDim.x + t].
__global__ void pb_tails_smem(const float* __restrict__ probs,
                              const int* __restrict__ w,
                              float* __restrict__ out, long long rows, int n,
                              long long w_stride) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int stride = blockDim.x;
  const long long row = (long long)blockIdx.x * blockDim.x + t;
  if (row >= rows) return;
  const float* p_row = probs + row * n;
  const int* w_row = w + row * w_stride;
  float* o_row = out + row * n;
  float* pmf = smem + t;

  for (int c = 0; c <= n; ++c) pmf[c * stride] = 0.f;
  pmf[0] = 1.f;
  for (int i = 0; i < n; ++i) {
    const float p = p_row[i];
    const float q = __fsub_rn(1.f, p);
    for (int c = i + 1; c >= 1; --c) {
      pmf[c * stride] =
          __fmaf_rn(pmf[(c - 1) * stride], p, __fmul_rn(pmf[c * stride], q));
    }
    pmf[0] = __fmul_rn(pmf[0], q);
    const int wi = w_row[i];
    float acc = 0.f;
    for (int c = wi > 0 ? wi : 0; c <= i + 1; ++c) {
      acc = __fadd_rn(acc, pmf[c * stride]);
    }
    o_row[i] = (wi > i + 1) ? 0.f : acc;
  }
}

template <int NMAX>
void launch_regs(const float* probs, const int* w, float* out, long long rows,
                 int n, long long w_stride, cudaStream_t stream) {
  const long long blocks = (rows + kThreads - 1) / kThreads;
  pb_tails_regs<NMAX><<<(unsigned)blocks, kThreads, 0, stream>>>(
      probs, w, out, rows, n, w_stride);
}

}  // namespace

// Largest n the shared-memory kernel takes: one thread's pmf in 48 KB.
extern "C" int pb_max_n() { return (48 * 1024) / 4 - 1; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int pb_success_tails(const float* probs, const int* w, float* out,
                                long long rows, int n, long long w_stride,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return 0;
  if (n > pb_max_n()) return (int)cudaErrorInvalidValue;
  if (n <= 16) {
    launch_regs<16>(probs, w, out, rows, n, w_stride, s);
  } else if (n <= 32) {
    launch_regs<32>(probs, w, out, rows, n, w_stride, s);
  } else if (n <= 64) {
    launch_regs<64>(probs, w, out, rows, n, w_stride, s);
  } else {
    const size_t per_thread = (size_t)(n + 1) * sizeof(float);
    int threads = (int)((48 * 1024) / per_thread);
    if (threads > kThreads) threads = kThreads;
    if (threads >= 32) threads -= threads % 32;
    const long long blocks = (rows + threads - 1) / threads;
    pb_tails_smem<<<(unsigned)blocks, threads, per_thread * threads, s>>>(
        probs, w, out, rows, n, w_stride);
  }
  return (int)cudaGetLastError();
}
