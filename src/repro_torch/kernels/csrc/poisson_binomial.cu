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
//      block loads it with 16-byte vector loads (4-byte loads up to the first
//      16-byte boundary and for the ragged tail) into shared memory, each
//      row at an odd stride ns = n | 1, so that the DP's reads, a row a
//      thread, hit 32 different banks;
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
//   4. the block stores its tails with 16-byte vector stores (row_tails is
//      step 3's DP, shared with the allocation kernel below).
// The intrinsics (__fmaf_rn, __fmul_rn, __fadd_rn) pin the exact sequence of
// roundings that XLA produces for the JAX package's reference DP on the CPU
// and that the port's plain PyTorch version (ref.py) repeats, so kernel and
// plain version agree to the bit; only the data movement is this kernel's
// own. For n > 64 a second kernel keeps each thread's pmf in shared memory
// (strided by the block size to avoid bank conflicts) with the same
// arithmetic and the same threshold view, reading its row directly; it
// serves any n whose pmf fits in 48 KB for one thread.
//
// The allocation kernel, pb_tails_allocate<NMAX> (entry pb_allocate, wrapper
// allocate_masked_cuda), is the whole of the port's allocate_masked
// (src/repro_torch/core/lea.py) for n <= 64 in one launch. It replaces no TPU
// kernel: the JAX package composes the pairwise rank, B1 and argmax in XLA
// (src/repro/core/lea.py, allocate_masked). Per row of n float32 p (any
// order) and its pool row [w_0..w_{n-1}, mask_0..mask_{n-1}, ell_g, ell_b]
// (int32; w the prefix thresholds of the valid pool):
//   p'      = mask ? p : -1                   (masked workers last)
//   rank_i  = #{j : p'_j > p'_i} + #{j < i : p'_j == p'_i}
//   s[r]    = p' of rank r, 0 for r >= n_valid (= sum of mask)
//   i*      = 1 + the first maximum of B1's tails of s under w
//   loads_i = mask_i ? (rank_i < i* ? ell_g : ell_b) : 0
// which equals the composition (stable descending sort, gather, B1, argmax)
// to the bit on any non-NaN p: the rank is the sorted order, and the DP is
// row_tails, B1's own code. Bound: it reads p and writes the loads (8 bytes
// an element) and writes i* (8 bytes a row); the pool rows are a few per
// block. On the fig3 sweep, 2 x 1 024 x 20 000 rows of 15, that is 5.24 GB,
// 1.56 ms; the ranks (n(n-1)/2 compares a row) and the DP (~2n^2 flop) stay
// under it at n = 15. Design: B1's blocks of THREADS rows, one a thread.
//   (a) the rows' offsets through a second view, so a slice of a larger
//       tensor (the engine's round block) or a broadcast is read as it lies;
//       a block whose rows are one contiguous range takes load_rows (16-byte
//       loads), else 4-byte loads row by row;
//   (b) the block's distinct pool rows, once each, into shared memory (at
//       most (THREADS - 1) / rep + 2 of them, which sizes the allocation);
//   (c) each thread demotes and ranks its row in registers (pe, rank: every
//       index a compile-time constant), scatters it into rank order in
//       shared memory, runs row_tails with an emit that keeps the first
//       maximum (strict >, as torch.argmax), and writes its loads over its
//       p in shared memory from the ranks it kept;
//   (d) the block stores the int32 loads with 16-byte stores, and each
//       thread its int64 i*.
// Nothing of p's size is written but the loads.

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

// elems values from src (a block's rows, contiguous) into dst, element e at
// dst[(e / n) * ns + e % n]: 4-byte accesses up to the first 16-byte
// boundary of src, 16-byte loads from there, 4-byte accesses for the rest.
template <int THREADS, typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int elems, T* dst,
                                          int n, int ns) {
  static_assert(sizeof(T) == 4, "rows of 4-byte values");
  const int t = threadIdx.x;
  int head = (int)(((16 - ((uintptr_t)src & 15)) & 15) / 4);
  if (head > elems) head = elems;
  for (int e = t; e < head; e += THREADS) {
    const int row = e / n;
    dst[row * ns + e - row * n] = src[e];
  }
  const int quads = (elems - head) / 4;
  const float4* src4 = reinterpret_cast<const float4*>(src + head);
#pragma unroll 4
  for (int f = t; f < quads; f += THREADS) {
    const float4 v = src4[f];
    const int e = head + 4 * f;
    int row = e / n, col = e - row * n;
    const float parts[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      reinterpret_cast<float*>(dst)[row * ns + col] = parts[u];
      if (++col == n) { col = 0; ++row; }
    }
  }
  for (int e = head + 4 * quads + t; e < elems; e += THREADS) {
    const int row = e / n;
    dst[row * ns + e - row * n] = src[e];
  }
}

// The inverse of load_rows: elems values of src (rows at stride ns) to dst.
template <int THREADS, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, int elems, const T* src,
                                           int n, int ns) {
  static_assert(sizeof(T) == 4, "rows of 4-byte values");
  const int t = threadIdx.x;
  int head = (int)(((16 - ((uintptr_t)dst & 15)) & 15) / 4);
  if (head > elems) head = elems;
  for (int e = t; e < head; e += THREADS) {
    const int row = e / n;
    dst[e] = src[row * ns + e - row * n];
  }
  const int quads = (elems - head) / 4;
  float4* dst4 = reinterpret_cast<float4*>(dst + head);
#pragma unroll 4
  for (int f = t; f < quads; f += THREADS) {
    const int e = head + 4 * f;
    int row = e / n, col = e - row * n;
    float parts[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      parts[u] = reinterpret_cast<const float*>(src)[row * ns + col];
      if (++col == n) { col = 0; ++row; }
    }
    dst4[f] = make_float4(parts[0], parts[1], parts[2], parts[3]);
  }
  for (int e = head + 4 * quads + t; e < elems; e += THREADS) {
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

// One row's DP, B1's arithmetic: p_row[0..n) sorted descending, w_row[0..n)
// its thresholds; emit(i, tail) receives the tail of prefix i + 1 after step
// i, which has read p_row[i] and w_row[i] and nothing after them.
template <int NMAX, typename Emit>
__device__ __forceinline__ void row_tails(const float* p_row, const int* w_row, int n,
                                          Emit emit) {
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
      emit(i, (wi > i + 1) ? 0.f : acc);
    }
  }
}

template <int NMAX>
__global__ void __launch_bounds__(threads_for<NMAX>())
pb_tails_regs(const float* __restrict__ probs, const int* __restrict__ w,
              float* __restrict__ out, long long rows, int n, ThresholdView g) {
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
  load_rows<THREADS>(probs + row0 * n, elems, sp, n, ns);
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

  // 3. one row a thread; p[i] is read before its slot takes the tail
  if (t < nrows) {
    float* p_row = sp + t * ns;
    row_tails<NMAX>(p_row, sw + (int)((row0 + t) / g.rep - u0) * ns, n,
                    [&](int i, float tail) { p_row[i] = tail; });
  }
  __syncthreads();
  // 4. the block's tails
  store_rows<THREADS>(out + row0 * n, elems, sp, n, ns);
}

// Shared memory of pb_tails_allocate<NMAX>: the rows' offsets, the pool
// rows' offsets, the rows (p, then the loads), the rows in rank order and
// the at most n_u pool rows of 2n + 2 values.
template <int NMAX>
size_t allocate_smem_bytes(int n, int n_u) {
  constexpr int THREADS = threads_for<NMAX>();
  const int ns = n | 1, ks = (2 * n + 2) | 1;
  return (size_t)2 * THREADS * sizeof(long long) +
         (size_t)2 * THREADS * ns * sizeof(float) + (size_t)n_u * ks * sizeof(int);
}

// The whole of allocate_masked for THREADS consecutive rows, one a thread.
// pool: the pool rows, each [w_0 .. w_{n-1}, mask_0 .. mask_{n-1}, ell_g,
// ell_b], read through pv; probs: row r's n values at row_offset(pg, r).
template <int NMAX>
__global__ void __launch_bounds__(threads_for<NMAX>())
pb_tails_allocate(const float* __restrict__ probs, const int* __restrict__ pool,
                  int* __restrict__ loads, long long* __restrict__ i_star,
                  long long rows, int n, ThresholdView pg, ThresholdView pv) {
  constexpr int THREADS = threads_for<NMAX>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* p_off = reinterpret_cast<long long*>(smem_raw);   // [THREADS]
  long long* v_off = p_off + THREADS;                          // [THREADS]
  const int ns = n | 1, k = 2 * n + 2, ks = k | 1;
  float* sp = reinterpret_cast<float*>(v_off + THREADS);       // [THREADS][ns]
  float* ss = sp + THREADS * ns;                               // [THREADS][ns]
  int* sv = reinterpret_cast<int*>(ss + THREADS * ns);         // [n_u][ks]
  const int t = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * THREADS;
  const long long left = rows - row0;
  const int nrows = left < THREADS ? (int)left : THREADS;
  const int elems = nrows * n;
  const long long u0 = row0 / pv.rep;
  const int n_u = (int)((row0 + nrows - 1) / pv.rep - u0 + 1);

  // (a) where the rows and the distinct pool rows lie
  if (t < nrows) p_off[t] = row_offset(pg, row0 + t);
  if (t < n_u) v_off[t] = row_offset(pv, (u0 + t) * pv.rep);
  __syncthreads();
  // the block's rows: one contiguous range (16-byte loads), else by row
  if (__syncthreads_and(t >= nrows || p_off[t] == p_off[0] + (long long)t * n)) {
    load_rows<THREADS>(probs + p_off[0], elems, sp, n, ns);
  } else {
    for (int e = t; e < elems; e += THREADS) {
      const int row = e / n, col = e - row * n;
      sp[row * ns + col] = probs[p_off[row] + col];
    }
  }
  // (b) the pool rows, once each
  for (int idx = t; idx < n_u * k; idx += THREADS) {
    const int j = idx / k, i = idx - j * k;
    sv[j * ks + i] = pool[v_off[j] + i * pv.last_stride];
  }
  __syncthreads();

  // (c) one row a thread
  if (t < nrows) {
    float* p_row = sp + t * ns;
    float* s_row = ss + t * ns;
    const int* v_row = sv + (int)((row0 + t) / pv.rep - u0) * ks;
    const int* m_row = v_row + n;
    // masked workers demoted below every probability, then ranked by the
    // pairwise count: rank_i = #{j : p_j > p_i} + #{j < i : p_j == p_i},
    // a stable descending sort's order (ties to the lower index)
    float pe[NMAX];
    int rank[NMAX];
    int n_valid = 0;
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
      pe[i] = 0.f;
      rank[i] = 0;
      if (i < n) {
        const bool on = m_row[i] != 0;
        pe[i] = on ? p_row[i] : -1.f;
        n_valid += on;
      }
    }
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
#pragma unroll
      for (int j = i + 1; j < NMAX; ++j) {
        if (j < n) {
          const bool after = pe[j] > pe[i];   // j before i; else i before j
          rank[i] += after;
          rank[j] += !after;
        }
      }
    }
    // the values in rank order, the slots past the valid pool p = 0
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
      if (i < n) s_row[rank[i]] = rank[i] < n_valid ? pe[i] : 0.f;
    }
    // B1's DP; i* - 1 the first maximum over ascending prefixes
    float best = 0.f;
    int arg = 0;
    row_tails<NMAX>(s_row, v_row, n, [&](int i, float tail) {
      if (i == 0 || tail > best) {
        best = tail;
        arg = i;
      }
    });
    const int ell_g = v_row[2 * n], ell_b = v_row[2 * n + 1];
    int* l_row = reinterpret_cast<int*>(p_row);
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
      if (i < n) l_row[i] = m_row[i] == 0 ? 0 : (rank[i] <= arg ? ell_g : ell_b);
    }
    i_star[row0 + t] = arg + 1;
  }
  __syncthreads();
  // (d) the block's loads
  store_rows<THREADS>(loads + row0 * n, elems, reinterpret_cast<const int*>(sp), n, ns);
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
                 int n, const ThresholdView& g, cudaStream_t stream) {
  constexpr int THREADS = threads_for<NMAX>();
  const long long blocks = (rows + THREADS - 1) / THREADS;
  pb_tails_regs<NMAX><<<(unsigned)blocks, THREADS, regs_smem_bytes<NMAX>(n), stream>>>(
      probs, w, out, rows, n, g);
}

template <int NMAX>
int launch_allocate(const float* probs, const int* pool, int* loads, long long* i_star,
                    long long rows, int n, const ThresholdView& pg,
                    const ThresholdView& pv, cudaStream_t stream) {
  constexpr int THREADS = threads_for<NMAX>();
  // the most pool rows a block of THREADS consecutive rows touches
  const long long most = (THREADS - 1) / pv.rep + 2;
  const size_t smem = allocate_smem_bytes<NMAX>(n, most < THREADS ? (int)most : THREADS);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pb_tails_allocate<NMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (rows + THREADS - 1) / THREADS;
  pb_tails_allocate<NMAX><<<(unsigned)blocks, THREADS, smem, stream>>>(
      probs, pool, loads, i_star, rows, n, pg, pv);
  return 0;
}

// A ThresholdView from its int64 words (see pb_success_tails); false if they
// are not one.
bool read_view(const long long* view, ThresholdView* g) {
  *g = ThresholdView{};
  g->rep = view[0];
  g->dims = (int)view[1];
  if (g->rep < 1 || g->dims < 0 || g->dims > kMaxLead) return false;
  for (int d = 0; d < g->dims; ++d) {
    g->div[d] = view[2 + 3 * d];
    g->size[d] = view[3 + 3 * d];
    g->stride[d] = view[4 + 3 * d];
    if (g->div[d] < 1 || g->size[d] < 1) return false;
  }
  g->last_stride = view[2 + 3 * g->dims];
  return true;
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
  ThresholdView g;
  if (!read_view(view, &g)) return (int)cudaErrorInvalidValue;
  if (n <= 16) {
    launch_regs<16>(probs, w, out, rows, n, g, s);
  } else if (n <= 32) {
    launch_regs<32>(probs, w, out, rows, n, g, s);
  } else if (n <= 64) {
    launch_regs<64>(probs, w, out, rows, n, g, s);
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

// The fused allocation: loads (rows, n) int32 and i_star (rows,) int64, both
// contiguous; probs' rows through probs_view (last_stride 1 where n > 1),
// the pool rows of 2n + 2 int32 values through pool_view, both in
// pb_success_tails' words.
extern "C" int pb_allocate(const float* probs, const int* pool, int* loads,
                           long long* i_star, long long rows, int n,
                           const long long* probs_view, const long long* pool_view,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0) return 0;
  if (n > 64) return (int)cudaErrorInvalidValue;   // the widest instance
  ThresholdView pg, pv;
  if (!read_view(probs_view, &pg) || !read_view(pool_view, &pv) ||
      (n > 1 && pg.last_stride != 1))
    return (int)cudaErrorInvalidValue;
  int err;
  if (n <= 16) {
    err = launch_allocate<16>(probs, pool, loads, i_star, rows, n, pg, pv, s);
  } else if (n <= 32) {
    err = launch_allocate<32>(probs, pool, loads, i_star, rows, n, pg, pv, s);
  } else {
    err = launch_allocate<64>(probs, pool, loads, i_star, rows, n, pg, pv, s);
  }
  return err ? err : (int)cudaGetLastError();
}
