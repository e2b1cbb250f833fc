// The fault engine's per-packet counts of both decode modes, CUDA C++ for
// Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package composes this in XLA
// (src/repro/faults/packets.py: packet_on_time, then packet_counts, once a
// decode mode); the port's plain version (kernels/packet_counts/ref.py) is
// that composition, which builds (S, B, M, n, r, P) masks and sums them.
// This kernel builds no mask. The wrapper is packet_counts_cuda in
// kernels/packet_counts/kernel.py.
//
// What it computes. Rounds g = 0 .. rounds-1 (row b = g / m), workers
// i < n, strategies s < S, chunks j < r, packets q < P, with states
// (rounds, n) int32, loads (S, rounds, n) int32, t_cut (rounds, n) float32
// or none, keep (rounds, n, r, P) bool or none (none: every packet kept),
// mu_g, mu_b, deadline (rows,) float32:
//   speed = states == 1 ? mu_g[b] : mu_b[b]
//   tc    = t_cut ? min(t_cut, deadline[b]) : deadline[b]   (NaN if either is)
//   thr   = tc + 1e-9f
//   conserve: (j, q) done iff ((float)j + ((float)q + 1) / P) / speed <= thr
//   AON:      (j, q) done iff (float)loads[s] / speed <= thr
//   aon[s, g, q] / con[s, g, q] = #{(i, j): done, j < loads[s], keep[i, j, q]}
// Every division is IEEE round-to-nearest (no fast-math), so the counts are
// those of the composition's float32 ops, to the bit.
//
// The cut. With k = j * P + q, the conserving numerator never falls as k
// rises, and dividing by a speed > 0 keeps that order, so a worker's done
// packets are the prefix k < c. c is guessed from thr * speed * P and then
// settled by the division itself, one k at a time (one or two packets a
// worker, two divisions each). A speed that is not > 0 (zero, negative, NaN) takes every
// packet's division instead. j < loads[s] is the prefix k < clamp(L, 0, r) * P.
// So a worker's counted packets under each (mode, s) are its kept packets
// below one limit.
//
// Bound on the H100 (3.35 TB/s). At fault_grid's shapes (S = 2, rows 288,
// M = 20 000, n = 15, r = 10, P = 4) the least traffic reads keep (3.456 GB),
// loads (0.691 GB), states and t_cut (0.346 GB each) once and writes both
// count tensors (0.369 GB): 5.21 GB, 1.55 ms. The composition it replaces
// moves about 90 GB.
//
// Design. The kernel is bound by bytes, and keep is two thirds of them. A
// warp takes an item of 32 / w rounds, w the power of two >= n (at most 32;
// past 32 workers a round is taken 32 workers at a time), so its workers'
// keep bytes lie back to back (1 200 bytes at fault_grid). The warp reads
// them with coalesced vector loads of V bytes, the widest of 16, 8, 4, 2
// and 1 that divides keep's address and every item's offset (16 at
// fault_grid, whose items are 2 x 600 bytes), and packs them into a bit
// string in shared memory (bytes are 0 or 1, as a torch.bool holds them:
// one multiply packs four). Lane (round, worker) then reads its state,
// cutoff and S loads once, finds its cut, and takes its r * P bits as
// 64-bit words; per (mode, s) its counted packets are keep & below(limit).
// Those masks go to shared memory, and lane t of the round sums output
// (mode, s, q) = t, t + w, ... over the round's workers with popcounts of
// mask & residue q (the bits k = q mod P); the outputs of a round are
// written once, q-contiguous. No mask of the composition's size is built.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 4;              // strategies whose masks a lane holds at once
constexpr int kMaxRP = 4096;          // r * P: a warp's keep bits fit shared memory

// 4 bytes, each 0 or 1 (a torch.bool), to 4 bits (bit p from byte p).
__device__ __forceinline__ unsigned int bits4(unsigned int x) {
  return (x * 0x01020408u) >> 24;
}

template <int V>
__device__ __forceinline__ unsigned int load_bits(const uint8_t* p);

template <>
__device__ __forceinline__ unsigned int load_bits<16>(const uint8_t* p) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  return bits4(v.x) | bits4(v.y) << 4 | bits4(v.z) << 8 | bits4(v.w) << 12;
}

template <>
__device__ __forceinline__ unsigned int load_bits<8>(const uint8_t* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return bits4(v.x) | bits4(v.y) << 4;
}

template <>
__device__ __forceinline__ unsigned int load_bits<4>(const uint8_t* p) {
  return bits4(__ldg(reinterpret_cast<const unsigned int*>(p)));
}

template <>
__device__ __forceinline__ unsigned int load_bits<2>(const uint8_t* p) {
  return bits4(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

template <>
__device__ __forceinline__ unsigned int load_bits<1>(const uint8_t* p) {
  return __ldg(p);
}

// Bits [0, x) of a word, for any x.
__device__ __forceinline__ unsigned long long below(int x) {
  return x <= 0 ? 0ull : x >= 64 ? ~0ull : (1ull << x) - 1ull;
}

// The conserving rule for packet (j, q), as the composition rounds it.
__device__ __forceinline__ bool packet_done(int j, int q, int P, float speed, float thr) {
  const float num = (float)j + ((float)q + 1.0f) / (float)P;
  return num / speed <= thr;
}

// The done prefix of a worker whose speed is > 0: packets k < c are done.
__device__ int done_prefix(float speed, float thr, int rp, int P) {
  const float guess = thr * speed * (float)P;
  int c = guess >= (float)rp ? rp : guess > 0.0f ? (int)guess : 0;
  const int c0 = c;
  int j = c / P, q = c - j * P;              // packet c
  while (c < rp && packet_done(j, q, P, speed, thr)) {
    ++c;
    if (++q == P) q = 0, ++j;
  }
  if (c > c0) return c;
  while (c > 0) {                            // packet c - 1
    if (--q < 0) q = P - 1, --j;
    if (packet_done(j, q, P, speed, thr)) break;
    --c;
  }
  return c;
}

// Done bits of packets lo .. lo + nb - 1, each by its own division.
__device__ unsigned long long done_bits(int lo, int nb, int P, float speed, float thr) {
  unsigned long long b = 0;
  for (int t = 0; t < nb; ++t) {
    const int k = lo + t, j = k / P;
    if (packet_done(j, k - j * P, P, speed, thr)) b |= 1ull << t;
  }
  return b;
}

constexpr int kRow = 2 * kMaxS + 1;   // a lane's row of counted packets (odd: no bank conflict)

// Shared memory a warp takes: its lanes' counted packets (32 rows) and the
// keep bits of its 32 workers (32 r P bits, one word spare).
__host__ __device__ inline int warp_words(int rp) { return 32 * kRow + (32 * rp + 63) / 64 + 1; }

template <int V>
__global__ void __launch_bounds__(kThreads)
counts_kernel(const int* __restrict__ states, const int* __restrict__ loads,
              const float* __restrict__ t_cut, const uint8_t* __restrict__ keep,
              const float* __restrict__ mu_g, const float* __restrict__ mu_b,
              const float* __restrict__ deadline, int* __restrict__ out_aon,
              int* __restrict__ out_con, long long rounds, long long m, int n, int r,
              int P, int S, int tile_log2) {
  extern __shared__ unsigned long long smem[];
  const int rp = r * P;
  unsigned long long* const warp_smem = smem + (threadIdx.x >> 5) * warp_words(rp);
  // [lane][mode * kMaxS + s]: a lane's counted packets, mode 0 AON, 1 conserve
  unsigned long long (*const counted)[kRow] =
      reinterpret_cast<unsigned long long (*)[kRow]>(warp_smem);
  unsigned long long* const bitstream = warp_smem + 32 * kRow;
  constexpr int U = V < 8 ? 8 : V;           // keep bytes a lane packs at once
  const int lane = threadIdx.x & 31;
  const int width = 1 << tile_log2;
  const int tl = lane & (width - 1);
  const int tile0 = lane - tl;
  const int per_warp = 32 >> tile_log2;
  const int words = (rp + 63) / 64;
  const bool narrow = rounds <= 0x7fffffffll;
  unsigned long long residue = 0;          // bits 0, P, 2P, ... of a word
  for (int t = 0; t < 64; t += P) residue |= 1ull << t;
  const int step = 64 % P;                 // residue shift from a word to the next
  const long long items = (rounds + per_warp - 1) / per_warp;
  for (long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); item < items;
       item += (long long)gridDim.x * kWarps) {
    const long long g0 = item * per_warp;
    const long long g = g0 + (lane >> tile_log2);
    const bool round_ok = g < rounds;
    long long b = 0;
    if (round_ok) b = narrow ? (long long)((unsigned)g / (unsigned)m) : g / m;
    for (int i0 = 0; i0 < n; i0 += width) {
      const int i = i0 + tl;
      const bool on = round_ok && i < n;
      const int workers = min(width, n - i0);
      const long long wi = g * n + i;
      // the batch's workers lie back to back in keep: the rounds of the item
      // (n <= 32) or workers i0 .. i0 + 31 of one round
      if (keep) {
        const long long first = g0 * n + i0;
        const long long count =
            n <= 32 ? (rounds - g0 < per_warp ? rounds - g0 : per_warp) * n : workers;
        const long long len = count * rp;
        const uint8_t* src = keep + first * rp;
        for (long long off = (long long)lane * U; off < len; off += 32 * U) {
          unsigned int bits = 0;
          if (off + U <= len) {
#pragma unroll
            for (int v = 0; v < U / V; ++v) bits |= load_bits<V>(src + off + v * V) << (v * V);
          } else {
            for (int j = 0; j < len - off; ++j) bits |= (unsigned)(src[off + j] != 0) << j;
          }
          if (U == 16)
            reinterpret_cast<unsigned short*>(bitstream)[off / 16] = (unsigned short)bits;
          else
            reinterpret_cast<uint8_t*>(bitstream)[off / 8] = (uint8_t)bits;
        }
        __syncwarp();
      }
      float speed = 1.0f, thr = 0.0f;
      bool prefix = true;
      int c = 0;
      if (on) {
        const float good = mu_g[b], bad = mu_b[b];
        speed = states[wi] == 1 ? good : bad;
        const float dl = deadline[b];
        float tc = dl;
        if (t_cut) {
          const float t = t_cut[wi];
          tc = (isnan(t) || isnan(dl)) ? NAN : fminf(t, dl);
        }
        thr = tc + 1e-9f;
        prefix = speed > 0.0f;
        if (prefix) c = done_prefix(speed, thr, rp, P);
      }
      const int seg = (n <= 32 ? (lane >> tile_log2) * n + tl : tl) * rp;
      int o = 0;                           // residue of the word's first packet
      for (int w = 0; w < words; ++w, o = o + step >= P ? o + step - P : o + step) {
        const int lo = 64 * w, nb = min(64, rp - lo);
        unsigned long long kept = 0, cdone = 0;
        if (on) {
          if (keep) {
            const int at = seg + lo, sh = at & 63;
            const unsigned long long x = bitstream[at >> 6];
            kept = (sh ? x >> sh | bitstream[(at >> 6) + 1] << (64 - sh) : x) & below(nb);
          } else {
            kept = below(nb);
          }
          cdone = prefix ? below(c - lo) : done_bits(lo, nb, P, speed, thr);
        }
        const bool first = i0 == 0 && w == 0;
        for (int s0 = 0; s0 < S; s0 += kMaxS) {
          const int sc = min(kMaxS, S - s0);
          // each lane: its worker's counted packets under both modes
          for (int k = 0; k < sc; ++k) {
            unsigned long long con = 0, aon = 0;
            if (on) {
              const int L = loads[(s0 + k) * rounds * n + wi];
              const unsigned long long assigned =
                  kept & below((L < 0 ? 0 : L > r ? r : L) * P - lo);
              con = assigned & cdone;
              aon = (float)L / speed <= thr ? assigned : 0ull;
            }
            counted[lane][k] = aon;
            counted[lane][kMaxS + k] = con;
          }
          __syncwarp();
          // each lane: outputs (mode, s, q) = t, t + width, ... of its round,
          // summed over the round's workers
          for (int t = tl; t < 2 * sc * P; t += width) {
            const int ms = t / P, q = t - ms * P;
            const int col = ms >= sc ? kMaxS + ms - sc : ms;
            const int shift = q >= o ? q - o : q - o + P;
            const unsigned long long res = shift < 64 ? residue << shift : 0ull;
            int sum = 0;       // no unroll pragma: nvcc 12.8 ran an unrolled copy past `workers`
            for (int x = 0; x < workers; ++x) sum += __popcll(counted[tile0 + x][col] & res);
            if (round_ok) {
              int* out = ms >= sc ? out_con : out_aon;
              const long long at = ((long long)(s0 + col % kMaxS) * rounds + g) * P + q;
              out[at] = first ? sum : out[at] + sum;
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

template <int V>
int launch(const int* states, const int* loads, const float* t_cut, const uint8_t* keep,
           const float* mu_g, const float* mu_b, const float* deadline, int* out_aon,
           int* out_con, long long rounds, long long m, int n, int r, int P, int S,
           int tile_log2, cudaStream_t stream) {
  const int smem = kWarps * warp_words(r * P) * 8;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(counts_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, counts_kernel<V>, kThreads,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  const long long per_warp = 32 >> tile_log2;
  const long long items = (rounds + per_warp - 1) / per_warp;
  const long long need = (items + kWarps - 1) / kWarps;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(need < fit ? need : fit);
  counts_kernel<V><<<blocks, kThreads, smem, stream>>>(states, loads, t_cut, keep, mu_g,
                                                       mu_b, deadline, out_aon, out_con,
                                                       rounds, m, n, r, P, S, tile_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// Both modes' counts on `stream`: out_aon, out_con (S, rounds, P) int32,
// every element written. `vec` is the keep load's width in bytes (16, 8, 4,
// 2 or 1), which must divide keep's address and the byte offset of every
// warp's batch. Returns the cudaError_t of the launch (0 = success).
extern "C" int packet_counts_launch(const int* states, const int* loads, const float* t_cut,
                                    const uint8_t* keep, const float* mu_g, const float* mu_b,
                                    const float* deadline, int* out_aon, int* out_con,
                                    long long rounds, long long m, int n, int r, int P, int S,
                                    int vec, void* stream) {
  if (rounds < 1 || m < 1 || rounds % m != 0 || n < 1 || r < 1 || P < 1 || S < 1 ||
      (long long)r * P > kMaxRP || (t_cut == nullptr) != (keep == nullptr))
    return (int)cudaErrorInvalidValue;
  int tile_log2 = 0;
  while ((1 << tile_log2) < n && tile_log2 < 5) ++tile_log2;
  // every batch of a warp starts at a multiple of `unit` bytes of keep
  int common = n, rest = 32;                // gcd(n, 32)
  while (rest) {
    const int t = common % rest;
    common = rest;
    rest = t;
  }
  const long long unit = n <= 32 ? (long long)(32 >> tile_log2) * n * r * P
                                 : (long long)r * P * common;
  if (keep && (unit % vec || reinterpret_cast<uintptr_t>(keep) % vec))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16: return launch<16>(states, loads, t_cut, keep, mu_g, mu_b, deadline, out_aon,
                               out_con, rounds, m, n, r, P, S, tile_log2, st);
    case 8: return launch<8>(states, loads, t_cut, keep, mu_g, mu_b, deadline, out_aon,
                             out_con, rounds, m, n, r, P, S, tile_log2, st);
    case 4: return launch<4>(states, loads, t_cut, keep, mu_g, mu_b, deadline, out_aon,
                             out_con, rounds, m, n, r, P, S, tile_log2, st);
    case 2: return launch<2>(states, loads, t_cut, keep, mu_g, mu_b, deadline, out_aon,
                             out_con, rounds, m, n, r, P, S, tile_log2, st);
    case 1: return launch<1>(states, loads, t_cut, keep, mu_g, mu_b, deadline, out_aon,
                             out_con, rounds, m, n, r, P, S, tile_log2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
