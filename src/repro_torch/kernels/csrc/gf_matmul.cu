// Exact matrix product over GF(p), p = 2^31 - 1, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package,
// src/repro/kernels/gf/kernel.py:62 matmul_gf_pallas (body _gf_matmul_kernel).
// Both wrappers of the port (matmul_gf_cuda and bmm_gf_cuda in
// kernels/gf/kernel.py) launch gf_matmul below; a 2-D product is a batch of 1.
//
// What it computes, for each batch index z:
//   out[z] = (a[z] mod p) @ (b[z] mod p) mod p,  a[z] (m, c), b[z] (c, n),
// out[z] (m, n) canonical int32 residues in [0, p), row-major and contiguous.
// a and b are any int32 values, read as they lie through their element
// strides (batch, row, column): one of the two inner axes of each must have
// unit stride for the loads to coalesce (the wrapper copies other layouts).
//
// Operands as they lie. The exact coded round hands the kernel x~, already
// canonical, and x~^T, a transposed view of it. Reducing them first (to_gf:
// three full passes) and copying x~^T contiguous cost more than the products
// themselves, so the kernel does both on the fly:
//   * loaders: each operand's tile loader walks its unit-stride axis across
//     consecutive threads, in one of two orders chosen by layout (the
//     template flags kAK, a's k axis unit, and kBN, b's n axis unit; the
//     walk is TileWalk). For x~^T (150, 3000, 60), strides (180 000, 1,
//     3000), a k-row of a 512-row tile is then 2 KB contiguous. A thread
//     steps through its share of a tile by pointer increments and holds it
//     in registers: the next k-tile's loads are all issued before the
//     current tile is multiplied. The narrow products of the round do one
//     term per element of a, so they are bound by how many loads are in
//     flight, not by the products;
//   * canonicalising: every loaded v becomes v mod p in [0, p), the Python-
//     sign remainder of to_gf (canonical below; its plain mirror is
//     canonical_i32 in kernels/gf/ref.py).
//
// Design. The TPU has no 64-bit integer product, so the Pallas kernel builds
// each product from four 16-bit limbs. Hopper multiplies two 32-bit integers
// into 64 bits natively: each term is one 32 x 32 -> 64-bit multiply-add,
//     acc += (uint64_t)a * b;                    // a, b < p: < 2^62
// into a uint64_t accumulator, and once every four terms the accumulator is
// folded, acc = (acc & p) + (acc >> 31) (the same residue, 2^31 = 1 mod p,
// below 2^31 + 2^33), which leaves room for the next four products: 4 (p - 1)^2
// = 2^64 - 2^35 + 16. At the end the accumulator is folded twice and
// normalised once. The TPU kernel's output tile stays in VMEM across its K
// visits; here a block owns an output tile in registers (RM x RN values per
// thread) and loops over K itself, staging (TM x TK) tiles of a and (TK x TN)
// tiles of b through shared memory. Ragged edges load zeros (0 is the
// additive identity) and are masked on the store. The batch is grid.z, so
// bmm_gf is one launch.
//
// Split K. A narrow product with a long contraction, like the worker shards
// (3750, 3000) @ (3000, 8), has too few output tiles to fill 132 SMs (15
// blocks of 256 x 8). gf_matmul_splits picks S so that about two blocks
// per SM run: grid.z then holds batch x S, block s sums its K slice, reduces
// it to a residue and adds it to a uint64 scratch with atomicAdd (exact and
// order-free: S residues < 2^31 cannot overflow), and gf_finalize folds the
// scratch into the output. With S = 1 the block writes its residues directly.
//
// Tile shapes. Wide n uses 64 x 64 output tiles. The worker-shard product of
// the coded round has n = d = 8 columns, for which a 64-wide tile would
// compute 56 wasted columns: n <= 8 takes 256 x 8 tiles, and n == 1 (the
// degree-2 gradient with a vector w) 512 x 1 tiles.
//
// Bound on the H100. The work is m*c*n terms. The fewest integer
// instructions a term needs on sm_90 are about 2.25: one IMAD.WIDE.U32
// (acc += (uint64)a * b; four products below 2^62 fit a uint64, so a fold
// can wait four terms) and, per four terms, a fold of five instructions
// (LOP3, two SHF, a 64-bit add). Shared between the FMA and ALU pipes they
// issue at 128 a clock per SM: 132 x 128 x 1.98 GHz = 33.4e12 a second. The
// encode of the EC2 round, (150, 120) @ (120, 75 000), is 1.35e9 terms,
// about 0.091 ms, while its 81 MB of bytes take 0.024 ms, so the product is
// bound by integer instructions, not memory. This kernel issues that
// sequence: the loop over a k-tile is a fold of every accumulator, then four
// multiply-adds, with each operand kept in a register for RM or RN terms so
// that the shared-memory loads stay a small share of the instruction stream.
// On an H100 SXM at 700 W this version takes 0.38 ms back to back at that
// shape, 4.2x the bound (the first version, which folded every term before
// adding it, about six instructions a term, took 0.56 ms); the issue rate of
// IMAD.WIDE.U32 there is not measured. Tensor cores (8-bit limbs on the
// int8 MMA) are the next step. The narrow products of the exact round
// ((9000, 3000) @ (3000, 1), x~^T @ r) do one term per element of a: there
// the bound is the bytes of a and b read once, and what counts is reading
// x~ as it lies with enough loads in flight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kP = 0x7FFFFFFFu;
constexpr int kTK = 16;

// One Mersenne fold of the accumulator: x = hi * 2^31 + lo -> lo + hi, the
// same residue, below 2^31 + 2^33. Four products of canonical residues then
// fit on top of it: 4 (p - 1)^2 = 2^64 - 2^35 + 16, and 2^31 + 2^33 < 2^35.
__device__ __forceinline__ uint64_t fold(uint64_t x) { return (x & kP) + (x >> 31); }

// v mod p in [0, p) for any int32 v, the Python-sign remainder of to_gf.
// v = hi * 2^31 + lo with lo = v & p and hi = v >> 31 (arithmetic: 0 or -1);
// 2^31 = 1 (mod p), so v = lo + hi (mod p), a value in [-1, p]. Only
// v = -2^31 gives -1 (add p: p - 1) and only v = p gives p (subtract p: 0);
// v = -1 gives lo = p, hi = -1: p - 1. No uint32 reinterpretation enters,
// which would be off by 2^32 = 2 (mod p) for a negative v.
__device__ __forceinline__ uint32_t canonical(int32_t v) {
  int32_t x = (v & (int32_t)kP) + (v >> 31);
  x = x < 0 ? x + (int32_t)kP : x;
  x = x >= (int32_t)kP ? x - (int32_t)kP : x;
  return (uint32_t)x;
}

// One operand: base pointer and element strides of its batch, row and
// column axes.
struct Operand {
  const int32_t* p;
  long long sb, sr, sc;
};

// How THREADS threads share the loads of a tile whose unit-stride axis u
// has NU elements and whose other axis v has NV. Consecutive threads take
// consecutive u. Wide (NU >= THREADS): thread tid takes u = tid + i THREADS
// for every v. Narrow: u = tid % NU and v = tid / NU + j (THREADS / NU).
template <int NU, int NV, int THREADS>
struct TileWalk {
  static constexpr bool kWide = NU >= THREADS;
  static constexpr int kPerU = kWide ? NU / THREADS : 1;
  static constexpr int kVStep = kWide ? 1 : THREADS / NU;
  static constexpr int kPerV = (NV + kVStep - 1) / kVStep;
  static constexpr int kLoads = kPerU * kPerV;
  static_assert(kWide ? NU % THREADS == 0 : THREADS % NU == 0, "tile and block mismatch");

  __device__ __forceinline__ static int u0(int tid) { return kWide ? tid : tid % NU; }
  __device__ __forceinline__ static int v0(int tid) { return kWide ? 0 : tid / NU; }

  // The tile position (u, v) of this thread's element t; false past NV.
  __device__ __forceinline__ static bool element(int t, int tid, int* u, int* v) {
    *u = u0(tid) + (t % kPerU) * THREADS;
    *v = v0(tid) + (t / kPerU) * kVStep;
    return *v < NV;
  }

  // This thread's elements of the tile at `corner` (element strides su
  // along u, sv along v) into regs, as they lie; 0 where u >= nu or v >= nv
  // (the operand's ragged edge). All loads are issued before any is used.
  __device__ __forceinline__ static void load(int32_t* regs, const int32_t* corner,
                                              long long su, long long sv, int nu, int nv,
                                              int tid) {
    const int u = u0(tid), v = v0(tid);
    const int32_t* pv = corner + u * su + v * sv;
#pragma unroll
    for (int j = 0; j < kPerV; ++j) {
      const int32_t* pu = pv;
#pragma unroll
      for (int i = 0; i < kPerU; ++i) {
        const bool in = u + i * THREADS < nu && v + j * kVStep < nv && v + j * kVStep < NV;
        regs[j * kPerU + i] = in ? *pu : 0;
        pu += THREADS * su;
      }
      pv += kVStep * sv;
    }
  }
};

__device__ __forceinline__ uint32_t reduce_acc(uint64_t acc) {
  uint64_t x = (acc & kP) + (acc >> 31);      // < 2^31 + 2^33
  x = (x & kP) + (x >> 31);                   // < 2^31 + 8 < 2p
  uint32_t r = (uint32_t)x;
  return r >= kP ? r - kP : r;
}

// Block of (TM / RM) x (TN / RN) threads; thread (ty, tx) owns rows
// ty + i * (TM / RM) and columns tx + j * (TN / RN) of the output tile, so a
// warp's stores to one row are contiguous. kAK: a's k axis has unit stride
// (else its m axis); kBN: b's n axis has unit stride (else its k axis).
template <int TM, int TN, int RM, int RN, bool kAK, bool kBN>
__global__ void __launch_bounds__((TM / RM) * (TN / RN))
gf_matmul_kernel(Operand a, Operand b, uint32_t* __restrict__ out,
                 unsigned long long* __restrict__ scratch, int m, int c, int n,
                 int splits, int k_slice) {
  constexpr int TX = TN / RN;
  constexpr int TY = TM / RM;
  constexpr int THREADS = TX * TY;
  // tiles, a's transposed: as[k][row], bs[k][col]; the +1 pads spread a
  // loader's k-walk over the banks when it stores
  __shared__ uint32_t as[kTK][TM + 1];
  __shared__ uint32_t bs[kTK][TN + 1];

  const long long z = blockIdx.z / splits;
  const int k_begin = (blockIdx.z % splits) * k_slice;
  const int k_end = min(c, k_begin + k_slice);
  const int32_t* __restrict__ ap = a.p + z * a.sb;
  const int32_t* __restrict__ bp = b.p + z * b.sb;
  out += z * (long long)m * n;
  if (scratch != nullptr) scratch += z * (long long)m * n;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  uint64_t acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0;

  // Loads. Each thread holds its share of the next k-tile of a and b in
  // registers, read as they lie: the loads of tile k0 + kTK are issued
  // before tile k0 is multiplied, so they wait under its products; stored
  // to shared memory they are reduced mod p (canonical). a's unit-stride
  // axis is k (kAK) or m; b's is n (kBN) or k.
  using AWalk = TileWalk<kAK ? kTK : TM, kAK ? TM : kTK, THREADS>;
  using BWalk = TileWalk<kBN ? TN : kTK, kBN ? kTK : TN, THREADS>;
  const long long a_su = kAK ? a.sc : a.sr, a_sv = kAK ? a.sr : a.sc;
  const long long b_su = kBN ? b.sc : b.sr, b_sv = kBN ? b.sr : b.sc;
  const int32_t* a_corner = ap + row0 * a.sr + k_begin * a.sc;
  const int32_t* b_corner = bp + k_begin * b.sr + col0 * b.sc;
  const int rows_left = m - row0, cols_left = n - col0;
  int32_t la[AWalk::kLoads], lb[BWalk::kLoads];
  if (k_begin < k_end) {
    const int k_left = k_end - k_begin;
    AWalk::load(la, a_corner, a_su, a_sv, kAK ? k_left : rows_left, kAK ? rows_left : k_left, tid);
    BWalk::load(lb, b_corner, b_su, b_sv, kBN ? cols_left : k_left, kBN ? k_left : cols_left, tid);
  }
  for (int k0 = k_begin; k0 < k_end; k0 += kTK) {
#pragma unroll
    for (int t = 0; t < AWalk::kLoads; ++t) {
      int u, v;
      if (AWalk::element(t, tid, &u, &v)) {
        if (kAK) as[u][v] = canonical(la[t]);
        else as[v][u] = canonical(la[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < BWalk::kLoads; ++t) {
      int u, v;
      if (BWalk::element(t, tid, &u, &v)) {
        if (kBN) bs[v][u] = canonical(lb[t]);
        else bs[u][v] = canonical(lb[t]);
      }
    }
    __syncthreads();
    if (k0 + kTK < k_end) {   // the next tile's loads, in flight under this tile's products
      const int k_left = k_end - (k0 + kTK);
      a_corner += kTK * a.sc;
      b_corner += kTK * b.sr;
      AWalk::load(la, a_corner, a_su, a_sv, kAK ? k_left : rows_left, kAK ? rows_left : k_left,
                  tid);
      BWalk::load(lb, b_corner, b_su, b_sv, kBN ? cols_left : k_left, kBN ? k_left : cols_left,
                  tid);
    }
    // a fold, then four raw products: one IMAD.WIDE.U32 a term
#pragma unroll
    for (int k4 = 0; k4 < kTK; k4 += 4) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fold(acc[i][j]);
#pragma unroll
      for (int k = k4; k < k4 + 4; ++k) {
        uint32_t av[RM], bv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = as[k][ty + i * TY];
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = bs[k][tx + j * TX];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] += (uint64_t)av[i] * bv[j];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gr = row0 + ty + i * TY;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gc = col0 + tx + j * TX;
      if (gc >= n) continue;
      const long long o = (long long)gr * n + gc;
      if (scratch == nullptr) {
        out[o] = reduce_acc(acc[i][j]);
      } else {
        atomicAdd(scratch + o, (unsigned long long)reduce_acc(acc[i][j]));
      }
    }
  }
}

// out[i] = scratch[i] mod p, for the split-K path.
__global__ void gf_finalize(const unsigned long long* __restrict__ scratch,
                            uint32_t* __restrict__ out, long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = reduce_acc(scratch[i]);
}

constexpr int kTargetBlocks = 264;   // two per SM on the H100's 132
constexpr int kMinSlice = 256;       // a K slice keeps at least 16 tiles

// Output tile of the launch configuration chosen for n.
void tile_shape(int n, int* tm, int* tn) {
  if (n == 1) { *tm = 512; *tn = 1; }
  else if (n <= 8) { *tm = 256; *tn = 8; }
  else { *tm = 64; *tn = 64; }
}

int choose_splits(int batch, int m, int c, int n) {
  int tm, tn;
  tile_shape(n, &tm, &tn);
  const long long tiles = (long long)batch * ((m + tm - 1) / tm) * ((n + tn - 1) / tn);
  long long s = (kTargetBlocks + tiles - 1) / tiles;
  const long long most = (c + kMinSlice - 1) / kMinSlice;
  if (s > most) s = most;
  if (s < 1) s = 1;
  return (int)s;
}

template <int TM, int TN, int RM, int RN, bool kAK, bool kBN>
int launch(const Operand& a, const Operand& b, uint32_t* out,
           unsigned long long* scratch, int batch, int m, int c, int n,
           int splits, cudaStream_t s) {
  const long long tiles_m = (m + TM - 1) / TM;
  const long long tiles_n = (n + TN - 1) / TN;
  if (tiles_m > 65535 || (long long)batch * splits > 65535)
    return (int)cudaErrorInvalidValue;
  // a slice of whole kTK tiles
  const int k_slice = (int)(((long long)(c + splits - 1) / splits + kTK - 1) / kTK * kTK);
  dim3 grid((unsigned)tiles_n, (unsigned)tiles_m, (unsigned)(batch * splits));
  gf_matmul_kernel<TM, TN, RM, RN, kAK, kBN><<<grid, (TM / RM) * (TN / RN), 0, s>>>(
      a, b, out, splits > 1 ? scratch : nullptr, m, c, n, splits, k_slice);
  return 0;
}

// The loader orders of one tile shape, chosen by the operands' layouts.
template <int TM, int TN, int RM, int RN>
int launch_tile(const Operand& a, const Operand& b, uint32_t* out,
                unsigned long long* scratch, int batch, int m, int c, int n,
                int splits, cudaStream_t s) {
  // walk a's m axis only where it, not k, has unit stride; likewise b's k
  const bool a_k = !(a.sr == 1 && a.sc != 1);
  const bool b_n = !(b.sr == 1 && b.sc != 1);
  if (a_k && b_n)
    return launch<TM, TN, RM, RN, true, true>(a, b, out, scratch, batch, m, c, n, splits, s);
  if (a_k)
    return launch<TM, TN, RM, RN, true, false>(a, b, out, scratch, batch, m, c, n, splits, s);
  if (b_n)
    return launch<TM, TN, RM, RN, false, true>(a, b, out, scratch, batch, m, c, n, splits, s);
  return launch<TM, TN, RM, RN, false, false>(a, b, out, scratch, batch, m, c, n, splits, s);
}

}  // namespace

// How many K slices gf_matmul splits a product into; above 1 the caller
// passes a zeroed scratch of batch * m * n uint64 values.
extern "C" int gf_matmul_splits(int batch, int m, int c, int n) {
  if (batch <= 0 || m <= 0 || n <= 0 || c <= 0) return 1;
  return choose_splits(batch, m, c, n);
}

// out[z] = (a[z] mod p) @ (b[z] mod p) mod p for z < batch, on `stream`, in
// gf_matmul_splits K slices (scratch: zeroed, batch * m * n uint64 values
// when that is above 1, else unused). a and b are int32 of any value, read
// through their element strides (batch, row, column); out is contiguous.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int gf_matmul(const int* a, const int* b, int* out, void* scratch,
                         int batch, int m, int c, int n,
                         long long a_sb, long long a_sr, long long a_sc,
                         long long b_sb, long long b_sr, long long b_sc, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  if (c < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operand ua{reinterpret_cast<const int32_t*>(a), a_sb, a_sr, a_sc};
  const Operand ub{reinterpret_cast<const int32_t*>(b), b_sb, b_sr, b_sc};
  uint32_t* uo = reinterpret_cast<uint32_t*>(out);
  unsigned long long* us = static_cast<unsigned long long*>(scratch);
  const int splits = gf_matmul_splits(batch, m, c, n);
  if (splits > 1 && us == nullptr) return (int)cudaErrorInvalidValue;
  int err;
  if (n == 1) {
    err = launch_tile<512, 1, 2, 1>(ua, ub, uo, us, batch, m, c, n, splits, s);
  } else if (n <= 8) {
    err = launch_tile<256, 8, 4, 2>(ua, ub, uo, us, batch, m, c, n, splits, s);
  } else {
    err = launch_tile<64, 64, 4, 4>(ua, ub, uo, us, batch, m, c, n, splits, s);
  }
  if (err != 0) return err;
  if (splits > 1) {
    const long long count = (long long)batch * m * n;
    gf_finalize<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(us, uo, count);
  }
  return (int)cudaGetLastError();
}
