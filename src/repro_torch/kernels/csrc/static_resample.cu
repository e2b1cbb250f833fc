// One try of the static strategies' rejection resampler, CUDA C++ for Hopper
// (sm_90a).
//
// Replaces no TPU kernel. The JAX package resamples inside its jitted engine
// with a lax.while_loop of whole-batch jnp.where passes
// (src/repro/core/throughput.py:178 _static_loads_batch); the port's plain
// version (kernels/static_resample/ref.py) repeats those passes a try at a
// time on the host's loop. This kernel is one try of that loop for a CUDA
// block of rounds; the wrapper is StaticResampleCuda in
// kernels/static_resample/kernel.py.
//
// What it computes. Rounds g = 0 .. rows*m - 1 of a block of m rounds (row
// b = g / m), strategies j = 0 .. s-1, workers w = 0 .. n-1, with u the try's
// uniforms (rows, m, n) float32, pis (s, rows, n) float32, kstar / ell_g /
// ell_b (rows,) int32, mask (rows, n) bool or none, loads (s, rows, m, n)
// int32 and done (s, rows, m) bool. For every (j, g) whose done flag is 0:
//   load[w] = mask[b, w] ? (u[g, w] < pis[j, b, w] ? ell_g[b] : ell_b[b]) : 0
//   loads[j, g, :] = load;  done[j, g] = (sum_w load[w] >= kstar[b])
// with the sum in 64-bit integers, so the loads and flags are those of the
// plain version's float32 comparison and int32 loads, to the bit. Pairs whose
// flag is already 1 are not touched: their uniforms are not read and their
// loads not written.
//
// The count the host reads. counts[2] holds (unfinished pairs) for the host's
// read before a try: try t's pairs still unfinished go into counts[(t+1) % 2],
// and try t sets counts[t % 2], which the host read before launching it, to 0
// for try t + 1 to add into.
//
// Design: one thread a round, over a grid-stride loop of as many blocks as
// the card holds at once; a thread whose round is finished for every
// strategy reads s bytes and moves on. Each block adds its pairs still
// unfinished to the count with one atomic.
//
// Bound on the H100 (3.35 TB/s). A try reads the done flags (s bytes a
// round) and, for its unfinished rounds, the uniforms and writes the loads
// (4n bytes each). At the fig3 sweep's block (1 024 rows x 2 330 rounds x 15
// workers, s = 1) the first try reads 143 MB and writes 143 MB, 0.085 ms; a
// later try moves 2.4 MB of flags and 8n + 1 bytes a round left. There is
// no arithmetic to speak of.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxS = 2;              // strategies (static, static_equal): a bit each
constexpr unsigned int kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
resample_kernel(const float* __restrict__ u, const float* __restrict__ pis,
                const int* __restrict__ kstar, const int* __restrict__ ell_g,
                const int* __restrict__ ell_b, const unsigned char* __restrict__ mask,
                int* __restrict__ loads, unsigned char* __restrict__ done,
                unsigned long long* __restrict__ counts, int slot, long long rows,
                long long m, int n, int s) {
  __shared__ unsigned long long warp_left[kThreads / 32];
  const long long total = rows * m;
  if (blockIdx.x == 0 && threadIdx.x == 0) counts[slot] = 0ull;
  unsigned long long left = 0;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < total;
       g += (long long)gridDim.x * kThreads) {
    unsigned int redo = 0;
    for (int j = 0; j < s; ++j)
      if (!done[j * total + g]) redo |= 1u << j;
    if (!redo) continue;
    const long long b = g / m;
    const long long kb = kstar[b];
    const int eg = ell_g[b], eb = ell_b[b];
    long long sum[kMaxS] = {};
    for (int w = 0; w < n; ++w) {
      const float x = u[g * n + w];
      const bool real = !mask || mask[b * n + w];
#pragma unroll
      for (int j = 0; j < kMaxS; ++j) {
        if (j < s && (redo >> j & 1u)) {
          const int load = real ? (x < pis[(j * rows + b) * n + w] ? eg : eb) : 0;
          loads[(j * total + g) * n + w] = load;
          sum[j] += load;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxS; ++j) {
      if (j < s && (redo >> j & 1u)) {
        if (sum[j] >= kb) done[j * total + g] = 1;
        else ++left;
      }
    }
  }
  for (int d = 16; d > 0; d >>= 1) left += __shfl_down_sync(kFull, left, d);
  if ((threadIdx.x & 31) == 0) warp_left[threadIdx.x >> 5] = left;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long block_left = 0;
    for (int k = 0; k < kThreads / 32; ++k) block_left += warp_left[k];
    if (block_left) atomicAdd(counts + (slot ^ 1), block_left);
  }
}

}  // namespace

extern "C" int static_resample_max_s() { return kMaxS; }

// One try on `stream`: redraw every unfinished pair from `u`, add the pairs
// still unfinished into counts[slot ^ 1] and set counts[slot] to 0. Returns
// the cudaError_t of the launch (0 = success).
extern "C" int static_resample_try(const float* u, const float* pis, const int* kstar,
                                   const int* ell_g, const int* ell_b,
                                   const unsigned char* mask, int* loads,
                                   unsigned char* done, unsigned long long* counts,
                                   int slot, long long rows, long long m, int n, int s,
                                   void* stream) {
  if (rows < 0 || m < 0 || n < 1 || s < 1 || s > kMaxS || slot < 0 || slot > 1)
    return (int)cudaErrorInvalidValue;
  if (rows * m == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long need = (rows * m + kThreads - 1) / kThreads;
  const long long fit = (long long)sms * (2048 / kThreads);   // resident at once
  const unsigned blocks = (unsigned)(need < fit ? need : fit);
  resample_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, pis, kstar, ell_g, ell_b, mask, loads, done, counts, slot, rows, m, n, s);
  return (int)cudaGetLastError();
}
