// Batched Poisson-binomial prefix tails for the LEA allocator, CUDA C++ for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package,
// src/repro/kernels/poisson_binomial/kernel.py:
//   success_tails_pallas   (line 117, body _pb_kernel)   - one static threshold
//                                                          tuple for all rows
//   success_tails_pallas_w (line 147, body _pb_kernel_w) - per-row thresholds
// Both entry points of the port (success_tails_cuda, success_tails_cuda_w in
// kernel.py beside this file) launch the kernels below. The thresholds come
// as the int32 view the caller holds, read as it lies: a ThresholdView (the
// wrapper's threshold_geometry) maps a row of probs to its threshold row
// through up to four leading axes with their strides, stride 0 on broadcast
// axes. A static tuple is the all-broadcast case (one device row, uploaded
// once by the wrapper); the sweep engine's (1, B, 1, n) over (S, B, m, n) is
// `rep` = m rows a threshold row.
//
// What it computes, per row b of probabilities sorted descending (rows of n
// float32, contiguous), and int32 thresholds w:
//   out[b, i] = P[ Poisson-binomial(p[b, 0..i]) >= max(w[b, i], 0) ]
//   out[b, i] = 0 where w[b, i] > i + 1 (an infeasible prefix).
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s FP32 without tensor cores).
// The function reads probs and writes out, 8 bytes an element, and reads
// each distinct threshold row once: on the fig3 sweep's layout, probs
// (2, 256, 20 000, 15) with thresholds (1, 256, 1, 15), that is 1.229 GB,
// 0.367 ms. The DP is about n^2 fused multiply-adds plus ~n^2/2 tail adds a
// row (~2n^2 flop), so bytes bound it at the paper's n = 15 and the FP32
// rate comes near at n = 64.
//
// Design. The TPU kernel keeps a (rows, 128-lane) pmf tile in VMEM and
// unrolls the worker loop at trace time. Here a block owns THREADS
// consecutive rows, one a thread:
//   1. the block's rows are one contiguous range of THREADS * n floats: the
//      block loads it with 16-byte vector loads (4-byte loads where the
//      pointer is not 16-byte aligned, and for the ragged tail) into shared
//      memory, each row at an odd stride ns = n | 1, so that the DP's reads,
//      a row a thread, hit 32 different banks;
//   2. the block's distinct threshold rows (row / rep, at most THREADS of
//      them) are loaded into shared memory once;
//   3. each thread runs its row's DP with the pmf over counts 0..n in
//      registers: the template NMAX in {16, 32, 64} is picked from n, every
//      loop is unrolled with an `i < n` guard, so every pmf index is a
//      compile-time constant and nothing spills. Step i convolves one
//      Bernoulli in place, from the high count down:
//        pmf[c] = fma(pmf[c-1], p, pmf[c] * (1 - p))
//      then sums the tail over ascending counts, and writes the tail over
//      p[i] in shared memory;
//   4. the block stores its tails with 16-byte vector stores.
// The intrinsics (__fmaf_rn, __fmul_rn, __fadd_rn) pin the exact sequence of
// roundings that XLA produces for the JAX package's reference DP on the CPU
// and that the port's plain PyTorch version (ref.py) repeats, so kernel and
// plain version agree to the bit; only the data movement is this kernel's
// own. For n > 64 a second kernel keeps each thread's pmf in shared memory
// (strided by the block size to avoid bank conflicts) with the same
// arithmetic and the same threshold view, reading its row directly; it
// serves any n whose pmf fits in 48 KB for one thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLead = 4;      // leading axes of a threshold view with a stride

// Where row b's thresholds lie: element i at
//   sum_d ((b / div[d]) % size[d]) * stride[d] + i * last_stride,
// and rows b, b' with b / rep == b' / rep share one threshold row.
struct ThresholdView {
  long long rep;
  long long div[kMaxLead];
  long long size[kMaxLead];
  long long stride[kMaxLead];
  long long last_stride;
  int dims;
};

__device__ __forceinline__ long long row_offset(const ThresholdView& g, long long row) {
  long long off = 0;
#pragma unroll
  for (int d = 0; d < kMaxLead; ++d)
    if (d < g.dims) off += ((row / g.div[d]) % g.size[d]) * g.stride[d];
  return off;
}

// elems floats from src (a block's rows, contiguous) into dst, element e at
// dst[(e / n) * ns + e % n]; 16-byte loads where `vec`.
template <int THREADS>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, int elems,
                                          float* dst, int n, int ns, bool vec) {
  const int t = threadIdx.x;
  int done = 0;
  if (vec) {
    const int quads = elems / 4;
    const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int f = t; f < quads; f += THREADS) {
      const float4 v = src4[f];
      int row = (4 * f) / n, col = 4 * f - row * n;
      const float parts[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        dst[row * ns + col] = parts[u];
        if (++col == n) { col = 0; ++row; }
      }
    }
    done = 4 * quads;
  }
  for (int e = done + t; e < elems; e += THREADS) {
    const int row = e / n;
    dst[row * ns + e - row * n] = src[e];
  }
}

// The inverse of load_rows: elems floats of src (rows at stride ns) to dst.
template <int THREADS>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int elems,
                                           const float* src, int n, int ns, bool vec) {
  const int t = threadIdx.x;
  int done = 0;
  if (vec) {
    const int quads = elems / 4;
    float4* dst4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
    for (int f = t; f < quads; f += THREADS) {
      int row = (4 * f) / n, col = 4 * f - row * n;
      float parts[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        parts[u] = src[row * ns + col];
        if (++col == n) { col = 0; ++row; }
      }
      dst4[f] = make_float4(parts[0], parts[1], parts[2], parts[3]);
    }
    done = 4 * quads;
  }
  for (int e = done + t; e < elems; e += THREADS) {
    const int row = e / n;
    dst[e] = src[row * ns + e - row * n];
  }
}

template <int NMAX>
__host__ __device__ constexpr int threads_for() { return NMAX <= 32 ? 128 : 64; }

// Shared memory of pb_tails_regs<NMAX>: the rows, their threshold rows and
// the threshold rows' offsets.
template <int NMAX>
size_t regs_smem_bytes(int n) {
  const int ns = n | 1;
  return (size_t)threads_for<NMAX>() * ns * (sizeof(float) + sizeof(int)) +
         (size_t)threads_for<NMAX>() * sizeof(long long);
}

template <int NMAX>
__global__ void __launch_bounds__(threads_for<NMAX>())
pb_tails_regs(const float* __restrict__ probs, const int* __restrict__ w,
              float* __restrict__ out, long long rows, int n, ThresholdView g,
              bool vec) {
  constexpr int THREADS = threads_for<NMAX>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* w_off = reinterpret_cast<long long*>(smem_raw);   // [THREADS]
  const int ns = n | 1;
  float* sp = reinterpret_cast<float*>(w_off + THREADS);       // [THREADS][ns]
  int* sw = reinterpret_cast<int*>(sp + THREADS * ns);         // [<= THREADS][ns]
  const int t = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * THREADS;
  const long long left = rows - row0;
  const int nrows = left < THREADS ? (int)left : THREADS;
  const int elems = nrows * n;

  // 1. the block's probabilities
  load_rows<THREADS>(probs + row0 * n, elems, sp, n, ns, vec);
  // 2. its distinct threshold rows, once each
  const long long u0 = row0 / g.rep;
  const int n_u = (int)((row0 + nrows - 1) / g.rep - u0 + 1);
  if (t < n_u) w_off[t] = row_offset(g, (u0 + t) * g.rep);
  __syncthreads();
#pragma unroll 4
  for (int idx = t; idx < n_u * n; idx += THREADS) {
    const int j = idx / n, i = idx - j * n;
    sw[j * ns + i] = w[w_off[j] + i * g.last_stride];
  }
  __syncthreads();

  // 3. one row a thread
  if (t < nrows) {
    float* p_row = sp + t * ns;
    const int* w_row = sw + (int)((row0 + t) / g.rep - u0) * ns;
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
        p_row[i] = (wi > i + 1) ? 0.f : acc;   // p[i] is read: its slot takes the tail
      }
    }
  }
  __syncthreads();
  // 4. the block's tails
  store_rows<THREADS>(out + row0 * n, elems, sp, n, ns, vec);
}

// n > 64: the same DP with the pmf of thread t at smem[c * blockDim.x + t].
__global__ void pb_tails_smem(const float* __restrict__ probs,
                              const int* __restrict__ w,
                              float* __restrict__ out, long long rows, int n,
                              ThresholdView g) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int stride = blockDim.x;
  const long long row = (long long)blockIdx.x * blockDim.x + t;
  if (row >= rows) return;
  const float* p_row = probs + row * n;
  const int* w_row = w + row_offset(g, row);
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
    const int wi = w_row[i * g.last_stride];
    float acc = 0.f;
    for (int c = wi > 0 ? wi : 0; c <= i + 1; ++c) {
      acc = __fadd_rn(acc, pmf[c * stride]);
    }
    o_row[i] = (wi > i + 1) ? 0.f : acc;
  }
}

template <int NMAX>
void launch_regs(const float* probs, const int* w, float* out, long long rows,
                 int n, const ThresholdView& g, bool vec, cudaStream_t stream) {
  constexpr int THREADS = threads_for<NMAX>();
  const long long blocks = (rows + THREADS - 1) / THREADS;
  pb_tails_regs<NMAX><<<(unsigned)blocks, THREADS, regs_smem_bytes<NMAX>(n), stream>>>(
      probs, w, out, rows, n, g, vec);
}

}  // namespace

// Largest n the shared-memory kernel takes: one thread's pmf in 48 KB.
extern "C" int pb_max_n() { return (48 * 1024) / 4 - 1; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// view: rep, dims, then div, size and stride of each of the dims leading axes
// (outermost first), then last_stride: 3 + 3 * dims int64 values; more than
// kMaxLead (4) axes is cudaErrorInvalidValue.
extern "C" int pb_success_tails(const float* probs, const int* w, float* out,
                                long long rows, int n, const long long* view,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return 0;
  if (n > pb_max_n()) return (int)cudaErrorInvalidValue;
  ThresholdView g = {};
  g.rep = view[0];
  g.dims = (int)view[1];
  if (g.rep < 1 || g.dims < 0 || g.dims > kMaxLead) return (int)cudaErrorInvalidValue;
  for (int d = 0; d < g.dims; ++d) {
    g.div[d] = view[2 + 3 * d];
    g.size[d] = view[3 + 3 * d];
    g.stride[d] = view[4 + 3 * d];
    if (g.div[d] < 1 || g.size[d] < 1) return (int)cudaErrorInvalidValue;
  }
  g.last_stride = view[2 + 3 * g.dims];
  const bool vec = ((uintptr_t)probs % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (n <= 16) {
    launch_regs<16>(probs, w, out, rows, n, g, vec, s);
  } else if (n <= 32) {
    launch_regs<32>(probs, w, out, rows, n, g, vec, s);
  } else if (n <= 64) {
    launch_regs<64>(probs, w, out, rows, n, g, vec, s);
  } else {
    const size_t per_thread = (size_t)(n + 1) * sizeof(float);
    int threads = (int)((48 * 1024) / per_thread);
    if (threads > 128) threads = 128;
    if (threads >= 32) threads -= threads % 32;
    const long long blocks = (rows + threads - 1) / threads;
    pb_tails_smem<<<(unsigned)blocks, threads, per_thread * threads, s>>>(
        probs, w, out, rows, n, g);
  }
  return (int)cudaGetLastError();
}
