// Kernel K1: batched Ethereum Keccak-256 (legacy 0x01 ... 0x80 padding).
// Kernel K3, the same digests from raw little-endian words, is at the end,
// on K1's warp sponge.
//
// Replaces zk_state_proofs_tpu/ops/keccak_pallas.py::_keccak_kernel, which
// hashes (8, 128) lane tiles of pre-padded, pre-assembled u32 hi/lo lane
// words and skips the rate blocks a whole tile has finished.
//
// Design: a sponge spread over a warp (keccak256_rows_warp_kernel,
// zkp_keccak256_rows), so that a pool of a few hundred messages still
// fills the card: one message a warp, kMsgWarps = 2 warps a block. Lane
// t = x + 5y (t < 25) holds Keccak lane A[x][y] as one 64-bit register;
// lanes 25..31 carry nothing. A round: theta's column parity from four
// shuffles of the column's other lanes, D from two shuffles of the
// neighbouring columns' parities, rho as a per-lane rotate (a funnel-shift
// pair by the lane's own offset), pi as one shuffle from the lane pi maps
// here, chi from two shuffles of the row neighbours, iota on lane 0: nine
// 64-bit (eighteen 32-bit) shuffles a round. Lanes 0..16 load the 17
// eight-byte words of a rate block as one coalesced access, issued before
// the permutation of the block before it so that the load overlaps it;
// rows are 576 or 2092 bytes apart and not 8-byte aligned in general, so a
// word is one 8-byte load, two 4-byte loads or eight byte loads, as the
// row's address allows. The padding bytes are xored in by masks (as K3
// does). Lanes 0..3 write the digest.
//
// What bounds it on the H100: operations. A rate block costs the shuffle
// issue (about 430 warp-shuffles a block, one warp instruction a cycle on
// each SM) and, for few long messages, the latency of a round's dependent
// shuffles (about 150 cycles). Every message has a warp, and with it a
// scheduler slot of its own, so a pool of 1,024 or 384 rows still fills
// the card. No shared memory.
//
// A thread-per-message form of K1 and of K3 was measured against this
// design on the H100 and retired (PERF.md section 6 keeps the figures).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRate = 136;

__constant__ uint64_t kRoundConstants[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Kernel K3's padding masks (keccak_pallas.py:234-261), shared with K1:
// the low nb bytes of a word, and byte b at byte e of a word (0 outside it).
__device__ __forceinline__ uint64_t byte_mask(long long nb) {
  return nb <= 0 ? 0ULL : (nb >= 8 ? ~0ULL : (1ULL << (8 * nb)) - 1);
}

__device__ __forceinline__ uint64_t byte_at_lane(long long e, uint64_t b) {
  return (e >= 0 && e < 8) ? b << (8 * e) : 0ULL;
}

// ---------------------------------------------------------------------------
// K1: the warp sponge.

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMsgWarps = 2;  // warps (messages) per block

// rho's rotation of lane x + 5y
__constant__ int kRho[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                             25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};

// x rotated left by n (0 <= n < 32) after the halves are swapped when
// swap: a rotate by n + 32 * swap, as two funnel shifts
__device__ __forceinline__ uint64_t rotl_lane(uint64_t x, int n, bool swap) {
  uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  if (swap) {
    const uint32_t t = lo;
    lo = hi;
    hi = t;
  }
  const uint32_t nhi = __funnelshift_l(lo, hi, n);
  const uint32_t nlo = __funnelshift_l(hi, lo, n);
  return ((uint64_t)nhi << 32) | nlo;
}

__device__ __forceinline__ uint64_t shfl64(uint64_t v, int src) {
  return (uint64_t)__shfl_sync(kFull, (unsigned long long)v, src);
}

// What each lane reads from which lane in a round (lanes 25..31 read
// themselves; no lane below 25 reads them).
struct SpongeLanes {
  int col[4];     // theta: the other four lanes of this lane's column
  int cm1, cp1;   // theta: this row's lanes of columns x - 1 and x + 1
  int pi;         // pi: the lane whose rotated word lands here
  int chi1, chi2; // chi: this row's lanes of columns x + 1 and x + 2
  int rho;        // rho: this lane's rotation mod 32
  bool swap;      // and whether it is 32 or more
};

__device__ __forceinline__ SpongeLanes sponge_lanes(int lane) {
  SpongeLanes s;
  if (lane >= 25) {
    for (int k = 0; k < 4; ++k) s.col[k] = lane;
    s.cm1 = s.cp1 = s.pi = s.chi1 = s.chi2 = lane;
    s.rho = 0;
    s.swap = false;
    return s;
  }
  const int x = lane % 5, y = lane / 5;
  for (int k = 0; k < 4; ++k) s.col[k] = x + 5 * ((y + 1 + k) % 5);
  s.cm1 = (x + 4) % 5 + 5 * y;
  s.cp1 = (x + 1) % 5 + 5 * y;
  // pi: A[x'][y'] lands at (y', 2x' + 3y'); here (x, y) came from
  // x' = 3 (y - 3x) mod 5, y' = x
  s.pi = (3 * (y - 3 * x + 15)) % 5 + 5 * x;
  s.chi1 = (x + 1) % 5 + 5 * y;
  s.chi2 = (x + 2) % 5 + 5 * y;
  const int r = kRho[lane];
  s.rho = r & 31;
  s.swap = r >= 32;
  return s;
}

// Keccak-f[1600] on the warp's state (this lane's word of it)
__device__ __forceinline__ uint64_t keccak_f1600(uint64_t a,
                                                 const SpongeLanes& s,
                                                 int lane) {
#pragma unroll 1
  for (int r = 0; r < 24; ++r) {
    const uint64_t c = a ^ shfl64(a, s.col[0]) ^ shfl64(a, s.col[1]) ^
                       shfl64(a, s.col[2]) ^ shfl64(a, s.col[3]);
    const uint64_t cp = shfl64(c, s.cp1);
    a ^= shfl64(c, s.cm1) ^ ((cp << 1) | (cp >> 63));
    const uint64_t b = shfl64(rotl_lane(a, s.rho, s.swap), s.pi);
    a = b ^ (~shfl64(b, s.chi1) & shfl64(b, s.chi2));
    if (lane == 0) a ^= kRoundConstants[r];
  }
  return a;
}

// bytes [q, q + 8) of a row as a little-endian word: the bytes below
// `readable` from the row, the rest 0. al: the row address's alignment
// (8, 4 or 1); q is a multiple of 8.
__device__ __forceinline__ uint64_t row_lane(const uint8_t* row, long long q,
                                             int readable, int al) {
  const long long m = readable - q;
  if (m <= 0) return 0ULL;
  const uint8_t* p = row + q;
  if (m >= 8 && al == 8) return *reinterpret_cast<const uint64_t*>(p);
  if (m >= 8 && al == 4) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
    return (uint64_t)w[0] | ((uint64_t)w[1] << 32);
  }
  uint64_t x = 0;
  for (int k = 0; k < 8 && k < m; ++k) x |= (uint64_t)p[k] << (8 * k);
  return x;
}

// rows, lens and width as zkp_keccak256_rows takes them: message i is the
// first lens[i] bytes of row i (rows + i * row_stride), bytes at or past
// `width` read 0; absorbs min(len / 136 + 1, width / 136 + 1) blocks, the
// block count of zk_state_proofs_tpu.ops.keccak.keccak256 on a [.., width]
// buffer
__global__ void __launch_bounds__(kMsgWarps * 32)
    keccak256_rows_warp_kernel(const uint8_t* __restrict__ rows,
                               long long row_stride, int width,
                               const int32_t* __restrict__ lens, int n,
                               uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kMsgWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp
  const uint8_t* row = rows + (long long)i * row_stride;
  const int len = lens[i];
  const int nb_len = floor_div(len, kRate) + 1;
  const int nb = min(nb_len, width / kRate + 1);
  const long long last = (long long)nb_len * kRate - 1;  // 0x80 position
  const int readable = min(len, width);
  const uintptr_t ra = (uintptr_t)row;
  const int al = (ra & 7) == 0 ? 8 : ((ra & 3) == 0 ? 4 : 1);
  const SpongeLanes s = sponge_lanes(lane);

  // lane t < 17 absorbs word t of each rate block, padding xored in
  auto absorb_word = [&](int blk) -> uint64_t {
    if (lane >= 17 || blk >= nb) return 0ULL;
    const long long q = (long long)blk * kRate + 8 * lane;
    return row_lane(row, q, readable, al) ^ byte_at_lane(len - q, 0x01ULL) ^
           byte_at_lane(last - q, 0x80ULL);
  };
  uint64_t a = 0, next = absorb_word(0);
  for (int blk = 0; blk < nb; ++blk) {
    a ^= next;
    next = absorb_word(blk + 1);  // in flight during the permutation
    a = keccak_f1600(a, s, lane);
  }
  if (lane < 4) reinterpret_cast<uint64_t*>(out + (long long)i * 32)[lane] = a;
}

// ---------------------------------------------------------------------------
// Kernel K3: the same digests from raw little-endian row words, on K1's
// warp sponge. Replaces zk_state_proofs_tpu/ops/keccak_pallas.py::
// _keccak_kernel_raw (entered through keccak256_tpu_raw), which hashes
// (8, 128) lane tiles of pre-split u32 word pairs.
//
// Design: one message a warp, the lane map and the permutation of K1
// (sponge_lanes, keccak_f1600). K3's contract is what K1 cannot
// assume: row i is n_words u32 words (n_words even) at an 8-byte aligned
// address, zero-padded past its data. So lane t < 17 fetches rate word t
// of block ib, row words 34*ib + 2t and 34*ib + 2t + 1, as one aligned
// 8-byte load, with no alignment branch and no byte loop; the bytes at or
// past the length are masked off and the 0x01 and 0x80 pad bytes xored in
// by masks (byte_mask, byte_at_lane). As in K1, the next block's load is
// issued before the permutation of the current one. Absorbs block 0
// always and block ib > 0 while len / 136 + 1 > ib, for ib < num_blocks
// (the Pallas kernel's block count). Bound, like K1, by the shuffle issue
// and latency of the permutation; its loads are one coalesced 136-byte
// access a block. One warp a block, where K1 has two: on the headline
// pool the kernel was faster so (PERF.md), likely because fewer warps
// resident on an SM leave the long messages, which come first in a pool
// sorted by block count, fewer short ones to share the shuffle pipe with.
constexpr int kRawWarps = 1;  // warps (messages) a block

__global__ void __launch_bounds__(kRawWarps * 32)
    keccak256_raw_warp_kernel(const uint64_t* __restrict__ rows, int n_words,
                              int num_blocks, const int32_t* __restrict__ lens,
                              int n, uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRawWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp
  const int n_lanes = n_words / 2;
  const uint64_t* row = rows + (long long)i * n_lanes;
  const long long len = lens[i];
  const int nblk = floor_div((int)len, kRate) + 1;
  const int nb = max(1, min(nblk, num_blocks));
  const long long q80 = (long long)nblk * kRate - 1;  // 0x80 position
  const SpongeLanes s = sponge_lanes(lane);

  // lane t < 17 absorbs word t of each rate block, padding by masks
  auto absorb_word = [&](int ib) -> uint64_t {
    if (lane >= 17 || ib >= nb) return 0ULL;
    const int w = 17 * ib + lane;
    const long long q = (long long)kRate * ib + 8 * lane;  // its first byte
    const uint64_t x = w < n_lanes ? row[w] : 0ULL;
    return (x & byte_mask(len - q)) ^ byte_at_lane(len - q, 0x01ULL) ^
           byte_at_lane(q80 - q, 0x80ULL);
  };
  uint64_t a = 0, next = absorb_word(0);
  for (int ib = 0; ib < nb; ++ib) {
    a ^= next;
    next = absorb_word(ib + 1);  // in flight during the permutation
    a = keccak_f1600(a, s, lane);
  }
  if (lane < 4) reinterpret_cast<uint64_t*>(out + (long long)i * 32)[lane] = a;
}

}  // namespace

// the warp sponge (the hash of every path)
extern "C" int zkp_keccak256_rows(const void* rows, long long row_stride,
                                  int width, const void* lens, int n, void* out,
                                  void* stream) {
  if (n > 0) {
    const int blocks = (n + kMsgWarps - 1) / kMsgWarps;
    keccak256_rows_warp_kernel<<<blocks, kMsgWarps * 32, 0,
                                 (cudaStream_t)stream>>>(
        (const uint8_t*)rows, row_stride, width, (const int32_t*)lens, n,
        (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}

// K3 on the warp sponge (the raw-word hash)
extern "C" int zkp_keccak256_raw(const void* words, int n_words,
                                 int num_blocks, const void* lens, int n,
                                 void* out, void* stream) {
  if (n > 0) {
    const int blocks = (n + kRawWarps - 1) / kRawWarps;
    keccak256_raw_warp_kernel<<<blocks, kRawWarps * 32, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)words, n_words, num_blocks, (const int32_t*)lens, n,
        (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}
