// Exact matrix product over GF(p), p = 2^31 - 1, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel of the JAX package,
// src/repro/kernels/gf/kernel.py:62 matmul_gf_pallas (body _gf_matmul_kernel).
// Both wrappers of the port (matmul_gf_cuda and bmm_gf_cuda in
// kernels/gf/kernel.py) launch gf_matmul below; a 2-D product is a batch of 1.
//
// What it computes, for each batch index z:
//   out[z] = a[z] @ b[z] mod p,  a[z] (m, c), b[z] (c, n), out[z] (m, n),
// on int32 canonical residues in [0, p), row-major and contiguous.
//
// Design. The TPU has no 64-bit integer product, so the Pallas kernel builds
// each product from four 16-bit limbs. Hopper multiplies two 32-bit integers
// into 64 bits natively, so each term is
//     uint64_t z = (uint64_t)a * b;              // < 2^62
//     uint32_t t = (z & p) + (z >> 31);          // one Mersenne fold, < 2^32
// and the folded terms are summed in a uint64_t accumulator, exact for
// fewer than 2^32 terms. At the end the accumulator is folded twice and
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
// bound by integer instructions, not memory. This kernel folds every term
// before adding it: about six instructions a term by the source (a 32x32->64
// multiply, an AND, a funnel shift, a 32-bit add and a 64-bit add, which is
// two), most of them on the ALU pipe's 64 lanes a clock, so it cannot come
// nearer than about 0.48 ms, five times the bound. The design keeps each
// operand in a register for RM or RN terms so that the loads stay a small
// share of the instruction stream. Folding once per four terms is the first
// speed step; tensor cores (8-bit limbs on the int8 MMA) the next.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kP = 0x7FFFFFFFu;
constexpr int kTK = 16;

__device__ __forceinline__ uint32_t fold_term(uint32_t a, uint32_t b) {
  const uint64_t z = (uint64_t)a * (uint64_t)b;
  return ((uint32_t)z & kP) + (uint32_t)(z >> 31);
}

__device__ __forceinline__ uint32_t reduce_acc(uint64_t acc) {
  uint64_t x = (acc & kP) + (acc >> 31);      // < 2^31 + 2^33
  x = (x & kP) + (x >> 31);                   // < 2^31 + 8 < 2p
  uint32_t r = (uint32_t)x;
  return r >= kP ? r - kP : r;
}

// Block of (TM / RM) x (TN / RN) threads; thread (ty, tx) owns rows
// ty + i * (TM / RM) and columns tx + j * (TN / RN) of the output tile, so a
// warp's stores to one row are contiguous.
template <int TM, int TN, int RM, int RN>
__global__ void __launch_bounds__((TM / RM) * (TN / RN))
gf_matmul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                 uint32_t* __restrict__ out,
                 unsigned long long* __restrict__ scratch, int m, int c, int n,
                 int splits, int k_slice) {
  constexpr int TX = TN / RN;
  constexpr int TY = TM / RM;
  constexpr int THREADS = TX * TY;
  // a tile, transposed: as[k][row]; the +1 pad spreads a row's 16 k values
  // over 16 banks when it is stored
  __shared__ uint32_t as[kTK][TM + 1];
  __shared__ uint32_t bs[kTK][TN];

  const long long z = blockIdx.z / splits;
  const int k_begin = (blockIdx.z % splits) * k_slice;
  const int k_end = min(c, k_begin + k_slice);
  a += z * (long long)m * c;
  b += z * (long long)c * n;
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

  for (int k0 = k_begin; k0 < k_end; k0 += kTK) {
    for (int e = tid; e < TM * kTK; e += THREADS) {
      const int r = e / kTK, k = e % kTK;     // consecutive threads walk k
      const int gr = row0 + r, gk = k0 + k;
      as[k][r] = (gr < m && gk < k_end) ? a[(long long)gr * c + gk] : 0u;
    }
    for (int e = tid; e < kTK * TN; e += THREADS) {
      const int k = e / TN, col = e % TN;     // consecutive threads walk n
      const int gk = k0 + k, gc = col0 + col;
      bs[k][col] = (gk < k_end && gc < n) ? b[(long long)gk * n + gc] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTK; ++k) {
      uint32_t av[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = as[k][ty + i * TY];
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = bs[k][tx + j * TX];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] += fold_term(av[i], bv[j]);
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

template <int TM, int TN, int RM, int RN>
int launch(const uint32_t* a, const uint32_t* b, uint32_t* out,
           unsigned long long* scratch, int batch, int m, int c, int n,
           int splits, cudaStream_t s) {
  const long long tiles_m = (m + TM - 1) / TM;
  const long long tiles_n = (n + TN - 1) / TN;
  if (tiles_m > 65535 || (long long)batch * splits > 65535)
    return (int)cudaErrorInvalidValue;
  // a slice of whole kTK tiles
  const int k_slice = (int)(((long long)(c + splits - 1) / splits + kTK - 1) / kTK * kTK);
  dim3 grid((unsigned)tiles_n, (unsigned)tiles_m, (unsigned)(batch * splits));
  gf_matmul_kernel<TM, TN, RM, RN><<<grid, (TM / RM) * (TN / RN), 0, s>>>(
      a, b, out, splits > 1 ? scratch : nullptr, m, c, n, splits, k_slice);
  return 0;
}

}  // namespace

// How many K slices gf_matmul splits a product into; above 1 the caller
// passes a zeroed scratch of batch * m * n uint64 values.
extern "C" int gf_matmul_splits(int batch, int m, int c, int n) {
  if (batch <= 0 || m <= 0 || n <= 0 || c <= 0) return 1;
  return choose_splits(batch, m, c, n);
}

// out[z] = a[z] @ b[z] mod p for z < batch, on `stream`, in gf_matmul_splits
// K slices (scratch: zeroed, batch * m * n uint64 values when that is above
// 1, else unused). Returns the cudaError_t of the launches (0 = success).
extern "C" int gf_matmul(const int* a, const int* b, int* out, void* scratch,
                         int batch, int m, int c, int n, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  if (c < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* ua = reinterpret_cast<const uint32_t*>(a);
  const uint32_t* ub = reinterpret_cast<const uint32_t*>(b);
  uint32_t* uo = reinterpret_cast<uint32_t*>(out);
  unsigned long long* us = static_cast<unsigned long long*>(scratch);
  const int splits = gf_matmul_splits(batch, m, c, n);
  if (splits > 1 && us == nullptr) return (int)cudaErrorInvalidValue;
  int err;
  if (n == 1) {
    err = launch<512, 1, 2, 1>(ua, ub, uo, us, batch, m, c, n, splits, s);
  } else if (n <= 8) {
    err = launch<256, 8, 4, 2>(ua, ub, uo, us, batch, m, c, n, splits, s);
  } else {
    err = launch<64, 64, 4, 4>(ua, ub, uo, us, batch, m, c, n, splits, s);
  }
  if (err != 0) return err;
  if (splits > 1) {
    const long long count = (long long)batch * m * n;
    gf_finalize<<<(unsigned)((count + 255) / 256), 256, 0, s>>>(us, uo, count);
  }
  return (int)cudaGetLastError();
}
