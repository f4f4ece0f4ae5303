// Pool-first packing for the serving layer (models/service.py): a batch of
// raw proofs straight to its unique-node pool, with no dense per-proof
// node table on the host. The card gathers the per-proof table from the
// pool by index.
//
// Compiled by native.py into the same library as native/zkp_host.cpp (it
// calls that file's zkp_item_offsets for the pool's hints). C ABI, for
// ctypes; single-threaded.

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <vector>

extern "C" void zkp_item_offsets(const uint8_t* rows, int n, int row_len,
                                 uint8_t* out);

namespace {

// FNV-style mix of a node's live bytes, four 8-byte lanes at a time: the
// dedup table's key (not a digest; a collision falls through to a byte
// compare).
inline uint64_t mix64(const uint8_t* p, size_t n) {
  constexpr uint64_t kMul = 1099511628211ULL;
  uint64_t h0 = 1469598103934665603ULL ^ (n * kMul), h1 = 0x9e3779b97f4a7c15ULL,
           h2 = 0xc2b2ae3d27d4eb4fULL, h3 = 0x165667b19e3779f9ULL;
  size_t i = 0;
  for (; i + 32 <= n; i += 32) {
    uint64_t w[4];
    std::memcpy(w, p + i, 32);
    h0 = (h0 ^ w[0]) * kMul; h0 ^= h0 >> 29;
    h1 = (h1 ^ w[1]) * kMul; h1 ^= h1 >> 29;
    h2 = (h2 ^ w[2]) * kMul; h2 ^= h2 >> 29;
    h3 = (h3 ^ w[3]) * kMul; h3 ^= h3 >> 29;
  }
  for (; i + 8 <= n; i += 8) {
    uint64_t w;
    std::memcpy(&w, p + i, 8);
    h0 = (h0 ^ w) * kMul; h0 ^= h0 >> 29;
  }
  uint64_t tail = 0;
  if (i < n) std::memcpy(&tail, p + i, n - i);
  uint64_t h = h0 ^ ((h1 << 17) | (h1 >> 47)) ^ ((h2 << 31) | (h2 >> 33)) ^
               ((h3 << 47) | (h3 >> 17)) ^ tail;
  h *= kMul;
  h ^= h >> 32;
  return h;
}

}  // namespace

extern "C" {

// Pack b proofs into a unique-node pool of pool_rows rows. Inputs are
// those of zkp_pack_proofs (node_blob / node_offsets[total_nodes + 1],
// proof_counts[b], roots b*32 bytes, key_blob / key_offsets[b + 1]).
//
// Outputs (caller-allocated, any prior contents; every byte is written):
//   pool_nodes u8 [pool_rows, node_len]: row 0 the zero row, then each
//     distinct node once, by descending length, stable by first encounter
//     in (proof, node) order; rows past the last distinct node are zero
//   pool_lens i32 [pool_rows]; pool_hints u8 [pool_rows, 36]
//     (zkp_item_offsets of each row)
//   pool_idx i32 [b, max_nodes]: each node's pool row, 0 past num_nodes
//   num_nodes i32 [b]; out_roots u8 [b, 32]
//   key_nibbles u8 [b, key_nib]; key_lens i32 [b]
// These are byte for byte witness.pack_proofs(...).pool(min_rows=pool_rows)
// and its pool_hints() for the same batch.
//
// Returns 0; or the 1-based index of the first proof that breaks the
// bucket (more than max_nodes nodes, a node over node_len bytes, a key
// over key_nib nibbles; checked in that order, proof by proof, as
// zkp_pack_proofs does); or -1 where the pool, padded to a multiple of
// 128 rows, needs more than pool_rows rows (*used_out: its rows, the zero
// row included). *used_out is the rows used on success too.
int zkp_pack_pool(const uint8_t* node_blob, const int64_t* node_offsets,
                  const int32_t* proof_counts, const uint8_t* roots,
                  const uint8_t* key_blob, const int64_t* key_offsets, int b,
                  int max_nodes, int node_len, int key_nib, int pool_rows,
                  uint8_t* pool_nodes, int32_t* pool_lens, uint8_t* pool_hints,
                  int32_t* pool_idx, int32_t* num_nodes, uint8_t* out_roots,
                  uint8_t* key_nibbles, int32_t* key_lens, int32_t* used_out) {
  int64_t total = 0;
  for (int i = 0; i < b; ++i) total += proof_counts[i];
  // open-addressing table of distinct-node ids (0 = empty slot); ids
  // count from 1 in first-encounter order, 0 being the zero row
  uint64_t tsize = 1;
  while (tsize < 2ULL * static_cast<uint64_t>(total + 2)) tsize <<= 1;
  const uint64_t tmask = tsize - 1;
  std::vector<int32_t> table(tsize, 0);
  std::vector<int64_t> ustart(1, 0);  // blob offset of each distinct node
  std::vector<int32_t> ulen(1, 0);
  ustart.reserve(static_cast<size_t>(total) + 1);
  ulen.reserve(static_cast<size_t>(total) + 1);

  std::memset(key_nibbles, 0, static_cast<size_t>(b) * key_nib);
  int64_t node_idx = 0;
  for (int i = 0; i < b; ++i) {
    const int cnt = proof_counts[i];
    if (cnt > max_nodes) return i + 1;
    num_nodes[i] = cnt;
    int32_t* idx = pool_idx + static_cast<size_t>(i) * max_nodes;
    for (int j = 0; j < cnt; ++j, ++node_idx) {
      const int64_t start = node_offsets[node_idx];
      const int64_t len = node_offsets[node_idx + 1] - start;
      if (len > node_len) return i + 1;
      if (len == 0) {
        idx[j] = 0;  // an empty node is the zero row
        continue;
      }
      const uint8_t* row = node_blob + start;
      uint64_t slot = mix64(row, static_cast<size_t>(len)) & tmask;
      int32_t at = 0;
      for (;;) {
        const int32_t entry = table[slot];
        if (entry == 0) break;
        if (ulen[entry] == len &&
            std::memcmp(node_blob + ustart[entry], row, static_cast<size_t>(len)) == 0) {
          at = entry;
          break;
        }
        slot = (slot + 1) & tmask;
      }
      if (at == 0) {
        at = static_cast<int32_t>(ulen.size());
        ustart.push_back(start);
        ulen.push_back(static_cast<int32_t>(len));
        table[slot] = at;
      }
      idx[j] = at;
    }
    for (int j = cnt; j < max_nodes; ++j) idx[j] = 0;
    std::memcpy(out_roots + 32 * static_cast<size_t>(i), roots + 32 * static_cast<size_t>(i), 32);
    const int64_t kstart = key_offsets[i];
    const int64_t klen = key_offsets[i + 1] - kstart;
    if (2 * klen > key_nib) return i + 1;
    uint8_t* knib = key_nibbles + static_cast<size_t>(i) * key_nib;
    for (int64_t k = 0; k < klen; ++k) {
      const uint8_t byte = key_blob[kstart + k];
      knib[2 * k] = byte >> 4;
      knib[2 * k + 1] = byte & 0x0f;
    }
    key_lens[i] = static_cast<int32_t>(2 * klen);
  }

  const int32_t used = static_cast<int32_t>(ulen.size());
  *used_out = used;
  if ((static_cast<int64_t>(used) + 127) / 128 * 128 > pool_rows) return -1;

  // each distinct node's row: descending length, stable (a counting sort
  // over the lengths 1..node_len)
  std::vector<int32_t> next_row(static_cast<size_t>(node_len) + 1, 0);
  for (int32_t u = 1; u < used; ++u) ++next_row[ulen[u]];
  int32_t at = 1;
  for (int len = node_len; len >= 1; --len) {
    const int32_t c = next_row[len];
    next_row[len] = at;
    at += c;
  }
  std::vector<int32_t> row_of(used, 0);
  for (int32_t u = 1; u < used; ++u) row_of[u] = next_row[ulen[u]]++;

  std::memset(pool_nodes, 0, static_cast<size_t>(node_len));
  pool_lens[0] = 0;
  for (int32_t u = 1; u < used; ++u) {
    uint8_t* dst = pool_nodes + static_cast<size_t>(row_of[u]) * node_len;
    const size_t len = static_cast<size_t>(ulen[u]);
    std::memcpy(dst, node_blob + ustart[u], len);
    std::memset(dst + len, 0, static_cast<size_t>(node_len) - len);
    pool_lens[row_of[u]] = ulen[u];
  }
  std::memset(pool_nodes + static_cast<size_t>(used) * node_len, 0,
              static_cast<size_t>(pool_rows - used) * node_len);
  std::memset(pool_lens + used, 0, static_cast<size_t>(pool_rows - used) * 4);
  const size_t cells = static_cast<size_t>(b) * max_nodes;
  for (size_t k = 0; k < cells; ++k) pool_idx[k] = row_of[pool_idx[k]];

  // hints: each used row's scan; the zero rows past it share row 0's
  zkp_item_offsets(pool_nodes, used, node_len, pool_hints);
  for (int32_t r = used; r < pool_rows; ++r)
    std::memcpy(pool_hints + static_cast<size_t>(r) * 36, pool_hints, 36);
  return 0;
}

}  // extern "C"
