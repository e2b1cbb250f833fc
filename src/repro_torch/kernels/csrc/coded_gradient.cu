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
// The TPU kernel's point, kept here: x~ is read from device memory once, and
// the (R, P) residual never goes there.
//
// Bound on the H100. At the coded regression's shape (nr = 150, R = 60,
// C = 3000, P = 1) the function must read x (108 MB), y and w and write out
// (1.8 MB): 110 MB, 0.0328 ms at 3.35 TB/s. Its 0.11 GFLOP take 0.0016 ms at
// 67 TFLOP/s FP32, so bytes bound it, and x is nearly all of them.
//
// Routes, chosen by the wrapper from (R, C, P) alone (gradient_route):
//
//   rows (P <= 8 and C * next_pow2(P) <= 4096). Residual row r needs only x
//     row r (a dot over C), and the update out[v] += x[v, r, :]^T resid[r, :]
//     needs only row r and that residual row. So a block streams rows through
//     a ring of kStages steps in shared memory and does both products from
//     that one copy: x is read once, whatever R is, and no chunk has to fit
//     on the SM. A block of 256 threads is TR row groups of TC threads; each
//     thread owns k pieces of VEC columns of a row (VEC = 4 when C % 4 == 0,
//     x is 16-byte aligned and P <= 4, else 1), copies exactly those pieces with
//     cp.async (cg, 16 bytes; ca, 4 bytes), and
//     reads back only its own pieces, so the ring needs no barrier. w's
//     pieces and the (C, P) partial sums live in registers (k VEC P <= 16).
//     A residual row is a shuffle sum over the TC threads and, for TC > 32,
//     a sum over the row's warps in a double-buffered shared array (one
//     __syncthreads a step). The rows of a chunk are split over a thread
//     block cluster of 1-8 blocks (the wrapper's row_plan: enough blocks for
//     four per SM at nr = 150, and 16 blocks on 16 SMs at nr = 2, where one
//     block a chunk had 2 SMs busy). The blocks' (C, P) partials are added
//     in a fixed order through distributed shared memory: each block sums
//     its rows' partials in its own shared memory, then block q of the
//     cluster adds the cluster's partials of its share of the outputs in
//     rank order. No float atomics and no scratch: two calls give the same
//     bits, and the partials cost no device-memory traffic or second launch.
//   chunk (any other shape the JAX wrapper accepts). One block of 1024
//     threads per chunk: each warp takes (r, p) pairs of the residual, its
//     lanes striding over C, then each thread takes columns c and sums
//     x[v, r, c] * resid[r, p] over r. The residual sits in dynamic shared
//     memory (opted in up to cudaDevAttrMaxSharedMemoryPerBlockOptin, read
//     at run time: R * P <= 58 112 on the H100) or, past that, in a global
//     scratch of nr * R * P floats from the caller (__syncthreads orders
//     the block's writes before its reads). x is read twice, the second
//     time mostly from L2.
// The only refusal left is the JAX wrapper's own working-set check, which the
// Python wrapper repeats.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cgrp = cooperative_groups;

namespace {

constexpr int kMaxDevices = 64;
constexpr int kDefaultSmem = 48 * 1024;   // a block's shared memory without opting in

// -- rows route --------------------------------------------------------------
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kStages = 4;          // ring depth: a thread has 3 steps in flight
constexpr int kRegFloats = 16;      // k * VEC * PT: a thread's w pieces, partials, row
constexpr int kRowBlocksPerSM = 3;  // registers for three blocks an SM
constexpr int kMaxCluster = 8;      // the portable cluster size

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy VEC floats to shared memory (address dst), asynchronously.
template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src) {
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One cluster of `cluster` blocks per chunk v; block q of it takes rows
// [q * rows_per_block, (q + 1) * rows_per_block) of the chunk.
template <int VEC, int PT>
__global__ void __launch_bounds__(kRowThreads, kRowBlocksPerSM)
coded_gradient_rows_kernel(const float* __restrict__ x, const float* __restrict__ y,
                           const float* __restrict__ w, float* __restrict__ out,
                           int R, int C, int P, int tc_n, int k_n, int rows_per_block) {
  constexpr int KMAX = kRegFloats / (VEC * PT);
  extern __shared__ __align__(16) float smem[];
  float* red = smem;                             // [2][kRowWarps][PT]
  // kStages stages, each x pieces [k_n][kRowThreads][VEC] then y [PT][kRowThreads]
  float* ring = smem + 2 * kRowWarps * PT;
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const long long v = blockIdx.x / S;
  const int t = threadIdx.x;
  const int TC = tc_n, TR = kRowThreads / tc_n;
  const int tc = t % TC, tr = t / TC;
  const int Cv = C / VEC;                        // VEC = 4 only where C % 4 == 0
  // this thread's pieces j = tc + TC k are valid for k < kv (a prefix)
  const int kv = tc < Cv ? min(k_n, (Cv - tc + TC - 1) / TC) : 0;
  const int r_begin = min(R, q * rows_per_block);
  const int r_end = min(R, r_begin + rows_per_block);
  const int n_steps = (r_end - r_begin + TR - 1) / TR;
  const int x_floats = k_n * kRowThreads * VEC;
  const int stage_floats = x_floats + PT * kRowThreads;
  // piece k of this thread's row at step s: x_first + s TR C + k TC VEC
  const float* x_first = x + (v * R + r_begin + tr) * (long long)C + tc * VEC;
  const float* y_first = y + (v * R + r_begin + tr) * (long long)P;
  const long long x_step = (long long)TR * C, y_step = (long long)TR * P;
  const uint32_t ring_u32 = smem_u32(ring) + t * VEC * 4;

  float wr[KMAX][VEC][PT], acc[KMAX][VEC][PT];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int j = tc + TC * k;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
#pragma unroll
      for (int p = 0; p < PT; ++p) {
        wr[k][e][p] = (k < kv && p < P) ? w[(long long)(j * VEC + e) * P + p] : 0.f;
        acc[k][e][p] = 0.f;
      }
    }
  }

  // step s's row (r_begin + s TR + tr) into stage s % kStages: this thread's
  // valid pieces of it, and a copy of its P targets for each of its threads,
  // so that no thread waits on another's copy
  auto issue = [&](int s) {
    const int row = r_begin + s * TR + tr;
    if (s < n_steps && row < r_end) {
      const uint32_t stage = ring_u32 + (uint32_t)((s % kStages) * stage_floats * 4);
      const float* xs = x_first + s * x_step;
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < kv) cp_async<VEC>(stage + k * kRowThreads * VEC * 4, xs + k * TC * VEC);
      const uint32_t ys = stage + (uint32_t)(x_floats - t * VEC + t) * 4;
      const float* yp = y_first + s * y_step;
#pragma unroll
      for (int p = 0; p < PT; ++p)
        if (p < P) cp_async<1>(ys + p * kRowThreads * 4, yp + p);
    }
    cp_async_commit();   // an empty group past the last row keeps the count
  };

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) issue(s);

#pragma unroll 1
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kStages - 2>();                // this thread's copies of step s landed
    const bool row_ok = r_begin + s * TR + tr < r_end;
    const float* stage = ring + (s % kStages) * stage_floats;
    float xr[KMAX][VEC], yr[PT];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (row_ok && k < kv) {
        if constexpr (VEC == 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(stage + (k * kRowThreads + t) * 4);
          xr[k][0] = q4.x;
          xr[k][1] = q4.y;
          xr[k][2] = q4.z;
          xr[k][3] = q4.w;
        } else {
          xr[k][0] = stage[k * kRowThreads + t];
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) xr[k][e] = 0.f;
      }
    }
#pragma unroll
    for (int p = 0; p < PT; ++p)
      yr[p] = (row_ok && p < P) ? stage[x_floats + p * kRowThreads + t] : 0.f;
    // into the stage of step s - 1, which this thread read in the last pass
    issue(s + kStages - 1);

    float d[PT];
#pragma unroll
    for (int p = 0; p < PT; ++p) d[p] = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int p = 0; p < PT; ++p) d[p] = __fmaf_rn(xr[k][e], wr[k][e][p], d[p]);
    // the residual row: a sum over the row's TC threads, first within a warp ...
    const int span = TC < 32 ? TC : 32;
    for (int off = span / 2; off > 0; off /= 2) {
#pragma unroll
      for (int p = 0; p < PT; ++p) d[p] += __shfl_xor_sync(0xFFFFFFFFu, d[p], off);
    }
    if (TC > 32) {   // ... then over the row's warps, in warp order
      float* rb = red + (s & 1) * kRowWarps * PT;
      if (t % 32 == 0) {
#pragma unroll
        for (int p = 0; p < PT; ++p) rb[(t / 32) * PT + p] = d[p];
      }
      __syncthreads();
      const int w0 = tr * (TC / 32);
#pragma unroll
      for (int p = 0; p < PT; ++p) {
        float sum = rb[w0 * PT + p];
        for (int i = 1; i < TC / 32; ++i) sum += rb[(w0 + i) * PT + p];
        d[p] = sum;
      }
    }
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      const float resid = row_ok ? d[p] - yr[p] : 0.f;
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[k][e][p] = __fmaf_rn(xr[k][e], resid, acc[k][e][p]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it holds the row groups' partials now

  const int CP = C * P;
  float* part = ring;                            // [TR][C][P]
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int j = tc + TC * k;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
#pragma unroll
      for (int p = 0; p < PT; ++p)
        if (k < kv && p < P) part[tr * CP + (j * VEC + e) * P + p] = acc[k][e][p];
  }
  __syncthreads();
  if (TR > 1) {      // the block's partial, row groups added in order
    for (int i = t; i < CP; i += kRowThreads) {
      float sum = part[i];
      for (int g = 1; g < TR; ++g) sum += part[g * CP + i];
      part[i] = sum;
    }
  }
  cluster.sync();    // every block's partial is complete and visible to the cluster
  const int share = (CP + S - 1) / S;
  const int lo = q * share, hi = min(CP, lo + share);
  float* ov = out + v * (long long)CP;
  for (int i = lo + t; i < hi; i += kRowThreads) {
    float sum = *cluster.map_shared_rank(part + i, 0);
    for (int b = 1; b < S; ++b) sum += *cluster.map_shared_rank(part + i, b);
    ov[i] = sum;
  }
  cluster.sync();    // no block leaves while another still reads its partial
}

template <int VEC, int PT>
cudaError_t launch_rows(const float* x, const float* y, const float* w, float* out, int nr,
                        int R, int C, int P, int tc, int k, int cluster, int rows_per_block,
                        cudaStream_t stream, int device) {
  auto kernel = coded_gradient_rows_kernel<VEC, PT>;
  const long long ring = (long long)kStages * (k * VEC + PT) * kRowThreads;
  const long long part = (long long)(kRowThreads / tc) * C * P;
  const long long smem = (2LL * kRowWarps * PT + (ring > part ? ring : part)) * sizeof(float);
  static int opted[kMaxDevices] = {};   // the largest opt-in set so far, per device
  if (smem > kDefaultSmem && smem > opted[device]) {
    const cudaError_t set =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (set != cudaSuccess) return set;
    opted[device] = (int)smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nr * (unsigned)cluster, 1, 1);
  cfg.blockDim = dim3(kRowThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, y, w, out, R, C, P, tc, k, rows_per_block);
}

// -- chunk route -------------------------------------------------------------
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

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

int current_device(int* device) {
  const cudaError_t got = cudaGetDevice(device);
  if (got != cudaSuccess) return (int)got;
  return *device >= kMaxDevices ? (int)cudaErrorInvalidDevice : 0;
}

}  // namespace

// The largest R * P whose residual the chunk route keeps in shared memory on
// the current device; a larger one needs coded_gradient's global scratch.
extern "C" long long coded_gradient_shared_limit() {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  const int bytes = optin_bytes(device);
  return (bytes > kDefaultSmem ? bytes : kDefaultSmem) / (long long)sizeof(float);
}

// The rows route on `stream`, with the wrapper's row_plan: vec (4 or 1), tc
// threads a row (a power of two <= 256), k pieces a thread, `cluster` blocks
// a chunk, rows_per_block rows each. Returns the cudaError_t of the launch
// (0 = success); a plan the kernel cannot take is cudaErrorInvalidValue.
extern "C" int coded_gradient_rows(const float* x, const float* y, const float* w,
                                   float* out, int nr, int R, int C, int P, int vec,
                                   int tc, int k, int cluster, int rows_per_block,
                                   void* stream) {
  if (nr <= 0 || C <= 0 || P <= 0) return 0;
  const int pt = P <= 1 ? 1 : P <= 2 ? 2 : P <= 4 ? 4 : 8;
  const bool vec_ok =
      vec == 1 || (vec == 4 && pt <= 4 && C % 4 == 0 && (uintptr_t)x % 16 == 0);
  if (R < 0 || P > 8 || !vec_ok || tc < 1 || tc > kRowThreads || (tc & (tc - 1)) != 0 ||
      k < 1 || k * vec * pt > kRegFloats || (long long)tc * k * vec < C || cluster < 1 ||
      cluster > kMaxCluster || rows_per_block < 1 ||
      (long long)rows_per_block * cluster < R || (long long)nr * cluster > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  int device = 0;
  const int bad = current_device(&device);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define CG_ROWS(V, T) \
  err = launch_rows<V, T>(x, y, w, out, nr, R, C, P, tc, k, cluster, rows_per_block, s, device)
  if (vec == 4) {
    if (pt == 1) CG_ROWS(4, 1); else if (pt == 2) CG_ROWS(4, 2); else CG_ROWS(4, 4);
  } else {
    if (pt == 1) CG_ROWS(1, 1); else if (pt == 2) CG_ROWS(1, 2);
    else if (pt == 4) CG_ROWS(1, 4); else CG_ROWS(1, 8);
  }
#undef CG_ROWS
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The chunk route: out[v] = x[v]^T (x[v] w - y[v]) for v < nr on `stream`.
// scratch: nr * R * P floats when R * P exceeds coded_gradient_shared_limit(),
// else unused (may be null). Returns the cudaError_t of the launch (0 = success).
extern "C" int coded_gradient(const float* x, const float* y, const float* w,
                              float* out, float* scratch, int nr, int R, int C,
                              int P, void* stream) {
  if (nr <= 0 || C <= 0 || P <= 0) return 0;
  if (R < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device = 0;
  const int bad = current_device(&device);
  if (bad) return bad;
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
