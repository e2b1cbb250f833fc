// Fused worker-side degree-2 gradient X~_v^T (X~_v W - Y_v), CUDA C++ for
// Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package,
// src/repro/kernels/coded_gradient/kernel.py:40 coded_gradient_pallas (body
// _coded_grad_kernel). The port's wrapper is coded_gradient_cuda in
// kernels/coded_gradient/kernel.py.
//
// What it computes, for every encoded chunk v < nr:
//   resid   = x[v] @ w - y[v]        x (nr, R, C), w (C, P), y (nr, R, P)
//   out[v]  = x[v]^T @ resid         out (nr, C, P)
// in float32 with fused multiply-adds, all arrays row-major and contiguous.
//
// Design. The TPU kernel's point is that the (R, P) residual never goes to
// HBM. Here one block owns one chunk v (grid = nr):
//   1. each warp takes (r, p) pairs of the residual; its lanes stride over C,
//      reading the row x[v, r, :] coalesced, and a shuffle tree sums the
//      lanes;
//   2. each thread takes columns c (stride blockDim) and sums
//      x[v, r, c] * resid[r, p] over r: a warp reads 32 consecutive floats of
//      each row, and resid is a broadcast.
// Where the residual lives is the kernel's one template flag:
//   shared  the (R, P) residual sits in dynamic shared memory and never
//           leaves the SM. A block takes 48 KB without asking; above that
//           coded_gradient opts in (cudaFuncAttributeMaxDynamicSharedMemorySize)
//           up to what the device offers a block
//           (cudaDevAttrMaxSharedMemoryPerBlockOptin, read at run time: 227 KB
//           on the H100, so R * P <= 58 112 there);
//   global  a larger residual goes to a scratch of nr * R * P floats that the
//           caller allocates: step 1 writes chunk v's residual there and step 2
//           reads it back, mostly from L2 (__syncthreads orders the block's
//           global writes before its reads).
// The only refusal left is the JAX wrapper's own working-set check, which the
// Python wrapper repeats.
//
// Bound on the H100. A chunk at the coded regression's shape (R = 60,
// C = 3000) is 720 KB, more than the 227 KB of shared memory a block can
// have, so x[v] is streamed from device memory in step 1 and read again in
// step 2, mostly from the 50 MB L2. At nr = 150, P = 1 the kernel must read
// x (108 MB), y and w and write out (1.8 MB): 110 MB, 0.033 ms at 3.35 TB/s
// (the bound counts x once). Its 0.11 GFLOP take 0.0016 ms at 67 TFLOP/s, so
// it is bound by bytes. This first version runs one block per chunk: 150
// blocks of 1024 threads, about one per SM, so each SM has half its 2048
// threads' worth of loads in flight; how much of the memory rate that
// reaches is measured, not assumed. Splitting C across
// blocks (the residual recomputed or shared through a cluster) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kDefaultSmem = 48 * 1024;   // a block's shared memory without opting in
constexpr int kMaxDevices = 64;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
coded_gradient_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ w, float* __restrict__ out,
                      float* __restrict__ scratch, int R, int C, int P) {
  extern __shared__ float smem_resid[];
  const long long v = blockIdx.x;
  // (R, P): in shared memory, or chunk v's part of the global scratch
  float* resid = kShared ? smem_resid : scratch + v * R * (long long)P;
  const float* xv = x + v * R * (long long)C;
  const float* yv = y + v * R * (long long)P;
  float* ov = out + v * C * (long long)P;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  // 1. resid[r, p] = sum_c x[v, r, c] * w[c, p] - y[v, r, p]
  for (int idx = warp; idx < R * P; idx += kWarps) {
    const int r = idx / P, p = idx % P;
    const float* row = xv + (long long)r * C;
    float s = 0.f;
#pragma unroll 4
    for (int c = lane; c < C; c += 32) s = __fmaf_rn(row[c], w[(long long)c * P + p], s);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
    if (lane == 0) resid[idx] = s - yv[idx];
  }
  __syncthreads();   // orders the residual's shared or global writes before step 2

  // 2. out[v, c, p] = sum_r x[v, r, c] * resid[r, p]
  for (int p = 0; p < P; ++p) {
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float s = 0.f;
#pragma unroll 4
      for (int r = 0; r < R; ++r)
        s = __fmaf_rn(xv[(long long)r * C + c], resid[(long long)r * P + p], s);
      ov[(long long)c * P + p] = s;
    }
  }
}

// Bytes of shared memory a block of this device may opt in to (0 on error).
int optin_bytes(int device) {
  static int bytes[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return 0;
  if (bytes[device] == 0 &&
      cudaDeviceGetAttribute(&bytes[device], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    bytes[device] = 0;
  return bytes[device];
}

}  // namespace

// The largest R * P whose residual the shared-memory path keeps on the
// current device; a larger one needs coded_gradient's global scratch.
extern "C" long long coded_gradient_shared_limit() {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  const int bytes = optin_bytes(device);
  return (bytes > kDefaultSmem ? bytes : kDefaultSmem) / (long long)sizeof(float);
}

// out[v] = x[v]^T (x[v] w - y[v]) for v < nr on `stream`. scratch: nr * R * P
// floats when R * P exceeds coded_gradient_shared_limit(), else unused (may
// be null). Returns the cudaError_t of the launch (0 = success).
extern "C" int coded_gradient(const float* x, const float* y, const float* w,
                              float* out, float* scratch, int nr, int R, int C,
                              int P, void* stream) {
  if (nr <= 0 || C <= 0 || P <= 0) return 0;
  if (R < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device = 0;
  const cudaError_t got = cudaGetDevice(&device);
  if (got != cudaSuccess) return (int)got;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const long long elems = (long long)R * P;
  const long long smem = elems * (long long)sizeof(float);
  if (smem <= kDefaultSmem || smem <= optin_bytes(device)) {
    static int opted[kMaxDevices] = {};   // the largest opt-in set so far
    if (smem > kDefaultSmem && smem > opted[device]) {
      const cudaError_t set = cudaFuncSetAttribute(
          coded_gradient_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (set != cudaSuccess) return (int)set;
      opted[device] = (int)smem;
    }
    coded_gradient_kernel<true><<<nr, kThreads, (size_t)smem, s>>>(x, y, w, out, nullptr,
                                                                  R, C, P);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    coded_gradient_kernel<false><<<nr, kThreads, 0, s>>>(x, y, w, out, scratch, R, C, P);
  }
  return (int)cudaGetLastError();
}
