// Kernel K1: batched Ethereum Keccak-256 (legacy 0x01 ... 0x80 padding).
//
// Replaces zk_state_proofs_tpu/ops/keccak_pallas.py::_keccak_kernel, which
// hashes (8, 128) lane tiles of pre-padded, pre-assembled u32 hi/lo lane
// words and skips the rate blocks a whole tile has finished. Here one
// thread hashes one message: it reads the raw row bytes and the length,
// pads inside the kernel, absorbs its own len / 136 + 1 blocks (no tile
// skipping is needed: threads of one warp simply diverge on the block
// count), and keeps the 25 u64 lanes in registers. The 24 round constants
// sit in __constant__ memory.
//
// What bounds it on the H100: integer ALU work, about 24 x ~100 u64
// operations per rate block, against a few hundred bytes read per
// message. The design keeps all state in registers and launches enough
// threads to spread one pool (a few thousand messages) over every SM.
// Byte loads are per byte and uncoalesced across a warp (rows are 576 B
// apart); that is the first thing to change when this kernel is tuned.

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

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) {
  return n == 0 ? x : (x << n) | (x >> (64 - n));
}

__device__ __forceinline__ void keccak_f1600(uint64_t a[25]) {
#pragma unroll 1
  for (int r = 0; r < 24; ++r) {
    uint64_t c[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    }
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 25; y += 5) a[x + y] ^= d;
    }
    // rho and pi: b[y + 5*((2x + 3y) % 5)] = rotl(a[x + 5y], rho[x + 5y])
    b[0] = rotl64(a[0], 0);
    b[16] = rotl64(a[5], 36);
    b[7] = rotl64(a[10], 3);
    b[23] = rotl64(a[15], 41);
    b[14] = rotl64(a[20], 18);
    b[10] = rotl64(a[1], 1);
    b[1] = rotl64(a[6], 44);
    b[17] = rotl64(a[11], 10);
    b[8] = rotl64(a[16], 45);
    b[24] = rotl64(a[21], 2);
    b[20] = rotl64(a[2], 62);
    b[11] = rotl64(a[7], 6);
    b[2] = rotl64(a[12], 43);
    b[18] = rotl64(a[17], 15);
    b[9] = rotl64(a[22], 61);
    b[5] = rotl64(a[3], 28);
    b[21] = rotl64(a[8], 55);
    b[12] = rotl64(a[13], 25);
    b[3] = rotl64(a[18], 21);
    b[19] = rotl64(a[23], 56);
    b[15] = rotl64(a[4], 27);
    b[6] = rotl64(a[9], 20);
    b[22] = rotl64(a[14], 39);
    b[13] = rotl64(a[19], 8);
    b[4] = rotl64(a[24], 14);
    // chi
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
#pragma unroll
      for (int x = 0; x < 5; ++x) {
        a[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
      }
    }
    // iota
    a[0] ^= kRoundConstants[r];
  }
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// rows: u8, row i at rows + i * row_stride, `width` bytes readable.
// Message i is its first lens[i] bytes; bytes at or past `width` read 0.
// Absorbs min(len / 136 + 1, width / 136 + 1) blocks, the block count of
// zk_state_proofs_tpu.ops.keccak.keccak256 on a [.., width] buffer.
__global__ void keccak256_rows_kernel(const uint8_t* __restrict__ rows,
                                      long long row_stride, int width,
                                      const int32_t* __restrict__ lens, int n,
                                      uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* row = rows + (long long)i * row_stride;
  const int len = lens[i];
  const int nb_len = floor_div(len, kRate) + 1;
  const int nb = min(nb_len, width / kRate + 1);
  const long long last = (long long)nb_len * kRate - 1;  // 0x80 position
  const int readable = min(len, width);

  uint64_t a[25];
#pragma unroll
  for (int w = 0; w < 25; ++w) a[w] = 0;

  for (int blk = 0; blk < nb; ++blk) {
    const int base = blk * kRate;
#pragma unroll
    for (int w = 0; w < 17; ++w) {
      uint64_t lane = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int p = base + w * 8 + k;
        uint32_t byte = p < readable ? row[p] : 0u;
        if (p == len) byte ^= 0x01u;
        if (p == last) byte ^= 0x80u;
        lane |= (uint64_t)byte << (8 * k);
      }
      a[w] ^= lane;
    }
    keccak_f1600(a);
  }

  uint8_t* o = out + (long long)i * 32;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
#pragma unroll
    for (int k = 0; k < 8; ++k) o[8 * w + k] = (uint8_t)(a[w] >> (8 * k));
  }
}

}  // namespace

extern "C" int zkp_keccak256_rows(const void* rows, long long row_stride,
                                  int width, const void* lens, int n, void* out,
                                  void* stream) {
  if (n > 0) {
    const int threads = 64;
    const int blocks = (n + threads - 1) / threads;
    keccak256_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)rows, row_stride, width, (const int32_t*)lens, n,
        (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}
