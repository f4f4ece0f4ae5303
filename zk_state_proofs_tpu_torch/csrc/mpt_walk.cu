// Kernel K2: the fused MPT proof walk, in the seven modes of the TPU kernel:
// `exact`, `bounded`, `hinted` and its variants `hinted4`, `hinted1`,
// `ordered` and `pairskip`.
//
// Replaces zk_state_proofs_tpu/ops/mpt_pallas.py::_walk_kernel (every
// mode). The TPU kernel holds every per-proof scalar as an (8, 128) lane
// tile and, lacking a vector gather, reads node bytes through masked
// reduces over the node's word axis and binary shift cascades.
//
// Design: a group of lanes per proof over a shared-memory slab
// (mpt_walk_warp_kernel<G>, zkp_mpt_walk), in blocks of kWarps = 4 warps.
// In the hinted modes the group is a warp (G = 32: item i is decoded on
// lane i), so the headline's depth segments of 1024, 2048 and 1024 proofs
// launch as many warps, and a 4096-proof batch at transaction geometry as
// 4096. In `exact` and `bounded` it is 8 lanes (four proofs a warp; see
// the serial decode below).
//  - Staging: the group first copies the proof's live node rows (the full
//    N bytes of each row, zero-filled to a 16-byte stride S), their
//    digests, node lengths, hints (hinted modes), key nibbles and root into
//    its own region of shared memory, lanes on consecutive chunks:
//    cp.async of 16 bytes where source and destination addresses and
//    strides are 16-byte aligned (576-byte account rows), of 4 bytes where
//    they are 4-byte aligned (2092-byte transaction rows), single bytes
//    otherwise (block buckets take any N). Every byte the walk consults
//    then comes from shared memory, and each byte of device memory is
//    read once.
//  - Reads: every RLP header (four bytes at a clamped position) is two
//    aligned 32-bit shared loads and a funnel shift (RowFetch); rows read
//    from device memory (below) take four byte loads. So every hinted
//    mode reads its headers as the aligned words `hinted1` asks for.
//  - Digest search: lane dd compares digest row dd with the 32 expected
//    bytes; __ballot_sync and __ffs give the FIRST matching row.
//  - Hinted decode (hinted, hinted4, hinted1, ordered, pairskip): lane i
//    (0..16) decodes item i at its hint; the chain law, the counts and the
//    latches are ballots, the selected items' fields shuffles from their
//    lanes.
//  - Serial decode (exact, bounded): the latch rules are a serial chain of
//    18 header reads; every lane of the group runs it on the same shared
//    words. With a warp a proof the chain is issued once for one proof,
//    and the 4096-slot batch is then bound by instruction issue; with 8
//    lanes a proof one issued chain serves four proofs, and 8 lanes still
//    stage a row, search up to 8 digests a ballot and copy a value in few
//    steps.
//  - Merge and step_pair: group-uniform. Every lane computes the same
//    merge from the same shared bytes (SIMT issues it once for the group's
//    lanes, so this costs what one lane would and needs no broadcast);
//    step_pair's nibble compare is split over the lanes and joined by a
//    vote.
//  - Value copy: the group writes the value row with 16-byte stores where
//    the output row's address allows (a head and a tail of single bytes
//    around them; max_value_len is the row stride and need not be a
//    multiple of 16), each 16 bytes assembled from aligned shared words
//    with funnel shifts.
//
// What bounds it on the H100: latency, not bytes. The bytes bound is small
// (the headline's live nodes, digests and hints are about 9 MB read and
// written, 2.7 us at 3.35 TB/s), while each step of a walk is a chain of
// dependent reads. The design puts one proof on each warp or group
// (thousands of warps), turns the device traffic into one coalesced copy
// per proof, and leaves the dependent chain in shared memory (about 30
// cycles a link instead of the hundreds of an uncoalesced device load).
//
// Shared-memory budget: kSlabBudget = 24 KB a warp (96 KB a block at most,
// two blocks or more an SM), so 24 KB a proof in the hinted modes and 6 KB
// in `exact` and `bounded`. The headline slab (7 x 576 B rows plus tables)
// takes about 4.7 KB, the slot batch's (6 x 544 B) 3.6 KB, the transaction
// geometry's (5 x 2096 B) about 11 KB. Where d x S and the tables exceed
// the budget, the same kernel stages one row at a time (STAGE_ROW: the row
// the step reads, reloaded when the step moves to another row). Where one
// row alone exceeds it (a block with a 100 KB transaction), the group
// reads node rows from device memory (STAGE_NONE; the tables stay in
// shared memory). `ordered` may read a row
// at or past num_nodes: that row is never staged and is read from device
// memory as well. The tables need up to 72 + 4 bytes a node row, for each
// of a block's 4 hinted or 16 serial proofs: past about 700 (hinted) or
// 190 (serial) rows the block's shared memory exceeds the card's and the
// launch fails (the wrapper raises).
//
// A thread-per-proof kernel and a one-block guard kernel for the re-run
// flag were measured against this design on the H100 and retired (PERF.md
// section 6 keeps their figures).
//
// Semantics follow the TPU kernel bit for bit:
//  - byte positions clamp to [0, N4 - 1] (N4 = N rounded up to a multiple
//    of 4) and bytes past the node buffer read 0 (`_fetch4`, `_to_words`);
//  - the root and every hash child are the FIRST digest row dd < num_nodes
//    that matches; an empty proof under the empty root is EXCLUDED,
//    otherwise a missing root is INVALID / R_ROOT_MISSING;
//  - reasons latch MALFORMED > BAD_CHILD_REF > HASH_MISMATCH, and
//    R_TRUNCATED when the steps run out;
//  - `hinted` decodes every item at its hint, checks the chain law
//    h[i+1] == h[i] + head_i + payload_i, and latches the overflow flag on
//    a chain break, on a present item past the bound 10 + 35*i, on a
//    long-form header in branch slots 2..15, and on an inline step
//    (off != 0). The caller re-runs the batch in `exact` when any flag is
//    set. Where the TPU kernel reads a latched proof's windows through
//    truncated prefixes, this kernel reads them in full: the flag agrees
//    with the TPU kernel on every proof, the other words wherever it is 0;
//  - `bounded` decodes serially like `exact`, but reads the node through
//    the TPU kernel's windows (mpt_pallas.py:540-636): min(N4/4, 147)
//    words from base = (clip(off) >> 2) * 4, the header through the first
//    3 words, item i through the first (10 + 35*i + 8) / 4 + 2, the word
//    index clamped to [0, N4/4 - 1] but not the byte offset (rel & 3). It
//    latches the overflow flag where the TPU kernel does (a present item
//    more than 10 + 35*i bytes past base) and also on a present item past
//    byte N4 - 1 of a node whose list end fits its length (only possible
//    with node_lens > N), where the TPU kernel's unlatched result can
//    differ from `exact`;
//  - `hinted4` is `hinted` with every item header decoded from four bytes,
//    so branch slots 2..15 take no long-form latch; its flag differs from
//    `hinted`'s only on a present long-form item there;
//  - `hinted1` is `hinted` with the node read as aligned 32-bit words,
//    each header from one or two words: the kernel reads every mode's
//    headers so, from its shared slab (rows at a 16-byte stride, zero past
//    N), so it walks `hinted1` as `hinted`. Same flag and words as
//    `hinted`;
//  - `ordered` reads, at step s, the node at row min(s, d - 1) and latches
//    the flag on a live proof whose node_idx differs (an unordered pack, a
//    root not at row 0, a step after an inline child); the rest is
//    `hinted`'s decode and merge, the digest search included;
//  - `pairskip` gates the extension/leaf block on a vote over the proofs
//    walked together (the TPU's tile-wide pl.when(any_pair)). A warp walks
//    one hinted proof, so the vote is the proof's own is_pair: same flag
//    and words as `hinted`;
//  - the value is copied out at the end, byte-aligned: value[j] =
//    node[vnode][clip(vstart) + j] for j < vlen (0 past the buffer).
//
// The `exact` re-run is decided on the card, as the TPU path decides it
// with a jax.lax.cond (mpt_pallas.py:981), and costs no launch of its own.
// The first (hinted or bounded) walk of a batch carries a tag, unique to
// that launch, and a pointer to a slot of the device's flag ring
// (WalkArgs.flag; the slot is the tag modulo the ring's size): the lane
// that writes a latched proof's overflow word stores the tag there. The
// lanes of a warp that store do so in one instruction to one address, so
// a warp makes one store at most, and every writer stores the same value,
// so no atomic is needed. (A block-wide __syncthreads_or before one store
// a block made the walk slower on the headline, with or without a flag:
// the barrier cost more than the stores it saves, which happen only where
// proofs latch and the batch is walked again anyway.) The guarded `exact`
// launch that follows carries the same tag and slot: every block returns
// at once unless the slot holds the tag, and otherwise overwrites the
// batch's outputs in place. A slot not written for this tag holds an
// older tag or 0 (tags start at 1), so nothing is ever zeroed, and
// batches whose first walks are queued ahead of their guarded launches
// (up to the ring's size) keep their own flags. The host reads no flag,
// so a stream of batches queues with no sync between them. A guarded
// launch that walks adds one to a device tally (WalkArgs.tally, from its
// first block), the count of guarded launches that walked.
//
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RUNNING = 0, FOUND = 1, EXCLUDED = 2, INVALID = 3;
constexpr int R_NONE = 0, R_MALFORMED = 1, R_BAD_CHILD_REF = 2,
              R_HASH_MISMATCH = 3, R_ROOT_MISSING = 4, R_TRUNCATED = 5;

__constant__ uint8_t kEmptyRoot[32] = {
    0x56, 0xe8, 0x1f, 0x17, 0x1b, 0xcc, 0x55, 0xa6, 0xff, 0x83, 0x45,
    0xe6, 0x92, 0xc0, 0xf8, 0x6e, 0x5b, 0x48, 0xe0, 0x1b, 0x99, 0x6c,
    0xad, 0xc0, 0x01, 0x62, 0x2f, 0xb5, 0xe3, 0x63, 0xb4, 0x21};

}  // namespace

// Must match WalkArgs in ops/mpt_cuda.py field for field.
struct WalkArgs {
  const uint8_t* nodes;  // [B, >=d, N], last dim contiguous
  long long nodes_s0, nodes_s1;
  const int32_t* node_lens;  // [B, >=d]
  long long lens_s0, lens_s1;
  const int32_t* num_nodes;  // [B]
  const uint8_t* digests;    // [B, >=d, 32]
  long long dig_s0, dig_s1;
  const uint8_t* roots;  // [B, 32]
  long long roots_s0;
  const uint8_t* knib;  // [B, KN]
  long long knib_s0;
  const int32_t* key_lens;  // [B]
  const uint8_t* hints;     // [B, >=d, 36] (hinted mode)
  long long hints_s0, hints_s1;
  int32_t* out;     // [B, 6]
  uint8_t* values;  // [B, max_value_len]
  int batch, d, n, kn, max_steps, max_value_len;
  int mode;  // a Mode
  // a launch that walks adds one here (nullptr: no tally)
  unsigned long long* tally;
  // the re-run flag, a slot of the device's flag ring (nullptr: none): a
  // first (hinted or bounded) walk stores `tag` there where any of its
  // proofs latched; an `exact` launch walks only where it holds `tag`
  unsigned long long* flag;
  unsigned long long tag;
};

namespace {

// WalkArgs.mode; must match _MODE_CODE in ops/mpt_cuda.py
enum Mode {
  EXACT = 0, HINTED = 1, BOUNDED = 2, HINTED4 = 3, HINTED1 = 4, ORDERED = 5,
  PAIRSKIP = 6
};

struct Head {
  int off, len;
  bool list, ok;
};

struct Sel {
  int i0_pay, i0_len;
  bool i0_list;
  int i1_start, i1_pay, i1_len;
  bool i1_list;
  int i16_pay, i16_len;
  int c_start, c_pay, c_len;
  bool c_list;
  int count;
  bool well_formed;
};

struct Pair {
  bool is_leaf, hp_ok, match;
  int n_path;
};

// whether a guarded `exact` launch leaves the batch as it is (every block
// returns at once): its flag slot does not hold its tag
__device__ __forceinline__ bool skip_batch(const WalkArgs& a) {
  return a.mode == EXACT && a.flag != nullptr && *a.flag != a.tag;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// byte x of a node buffer of n bytes, 0 outside it
__device__ __forceinline__ int byte_at(const uint8_t* row, int n, int x) {
  return (x >= 0 && x < n) ? (int)row[x] : 0;
}

// RLP item header from its first four bytes (rlp.item_head_window)
__device__ __forceinline__ Head head_fields(int b0, int b1, int b2, int b3) {
  const bool single = b0 < 0x80;
  const bool long_str = b0 >= 0xB8 && b0 <= 0xBF;
  const bool long_list = b0 >= 0xF8;
  const bool is_list = b0 >= 0xC0;
  const int lol = long_str ? b0 - 0xB7 : (long_list ? b0 - 0xF7 : 0);
  const int long_len = lol == 1 ? b1
                       : lol == 2 ? ((b1 << 8) | b2)
                                  : ((b1 << 16) | (b2 << 8) | b3);
  Head h;
  h.len = single ? 1
          : (long_str || long_list) ? long_len
          : is_list ? b0 - 0xC0
                    : b0 - 0x80;
  h.off = single ? 0 : 1 + lol;
  h.list = is_list;
  h.ok = lol <= 3;
  return h;
}

__device__ __forceinline__ void take_item(Sel& s, int i, bool present,
                                          int child, int cursor, int ips,
                                          int ipl, bool ilist) {
  if (i == 0) {
    s.i0_pay = ips;
    s.i0_len = ipl;
    s.i0_list = ilist;
  }
  if (i == 1) {
    s.i1_start = cursor;
    s.i1_pay = ips;
    s.i1_len = ipl;
    s.i1_list = ilist;
  }
  if (i == 16) {
    s.i16_pay = ips;
    s.i16_len = ipl;
  }
  if (i < 16 && present && child == i) {
    s.c_start = cursor;
    s.c_pay = ips;
    s.c_len = ipl;
    s.c_list = ilist;
  }
}

// ---------------------------------------------------------------------------
// The kernel: a group of lanes per proof over a shared-memory slab.

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 4;               // warps per block
constexpr int kSlabBudget = 24 * 1024;  // shared bytes one warp may hold
constexpr int kSerialLanes = 8;         // lanes a proof in `exact`, `bounded`

// how a group holds its proof's node rows (WarpLayout.staging)
enum Staging { STAGE_ALL = 0, STAGE_ROW = 1, STAGE_NONE = 2 };

// the low g bits set (g <= 32)
__host__ __device__ constexpr unsigned low_bits(int g) {
  return g >= 32 ? kFull : (1u << g) - 1u;
}

// The G lanes of a warp that walk one proof (G = 32 or 8), and their
// collectives: a ballot as a G-bit mask of the group's own lanes.
template <int G>
struct Group {
  int lane;       // lane within the group
  int base;       // the group's first lane in the warp
  unsigned mask;  // the group's lanes in the warp
  __device__ unsigned ballot(bool p) const {
    return (__ballot_sync(mask, p) >> base) & low_bits(G);
  }
  __device__ bool any(bool p) const { return __any_sync(mask, p); }
  __device__ void sync() const { __syncwarp(mask); }
};

// One proof's region of shared memory, as byte offsets from its start; the
// same for every proof of a launch.
struct WarpLayout {
  int s;        // slab row stride: N rounded up to 16
  int staging;  // a Staging
  int dig, hint, lens, knib, root, expect;
  int bytes;  // the whole region, a multiple of 16
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy nrows rows of rowbytes bytes (row r at src + r * src_stride) to
// shared memory at dst + r * dst_stride, and zero bytes [rowbytes,
// dst_stride) of each row. The group's G lanes take consecutive chunks:
// 16-byte cp.async where both addresses and strides are 16-byte aligned,
// 4-byte where they are 4-byte aligned, single bytes otherwise. The caller
// waits (cp_async_wait_all) and syncs the group before reading.
template <int G>
__device__ void stage_rows(uint8_t* dst, int dst_stride, const uint8_t* src,
                           long long src_stride, int nrows, int rowbytes,
                           int lane) {
  if (nrows <= 0) return;
  const unsigned long long al =
      (unsigned long long)(uintptr_t)src | (unsigned long long)src_stride |
      (unsigned long long)(uintptr_t)dst | (unsigned long long)dst_stride;
  const int w = (al & 15) == 0 ? 16 : ((al & 3) == 0 ? 4 : 1);
  const int chunks = w > 1 ? rowbytes / w : 0;  // whole chunks a row
  const int done = chunks * w;
  for (int k = lane; k < nrows * chunks; k += G) {
    const int r = k / chunks, c = (k - r * chunks) * w;
    if (w == 16) {
      cp_async16(dst + r * dst_stride + c, src + r * src_stride + c);
    } else {
      cp_async4(dst + r * dst_stride + c, src + r * src_stride + c);
    }
  }
  const int rest = dst_stride - done;  // tail bytes, then zeros
  if (rest <= 0) return;
  for (int k = lane; k < nrows * rest; k += G) {
    const int r = k / rest, p = done + (k - r * rest);
    dst[r * dst_stride + p] = p < rowbytes ? src[r * src_stride + p] : 0;
  }
}

// the first digest row dd < dlim equal to the 32 bytes at `expect` (both in
// shared memory, 16-byte aligned): lane dd % G compares row dd, the lowest
// matching row wins. The same result on every lane of the group.
template <int G>
__device__ __forceinline__ bool digest_find(const uint8_t* dig, int dlim,
                                          const uint8_t* expect, int& idx,
                                          const Group<G>& g) {
  const uint4 e0 = reinterpret_cast<const uint4*>(expect)[0];
  const uint4 e1 = reinterpret_cast<const uint4*>(expect)[1];
  for (int base = 0; base < dlim; base += G) {
    const int dd = base + g.lane;
    bool eq = false;
    if (dd < dlim) {
      const uint4* r = reinterpret_cast<const uint4*>(dig + dd * 32);
      const uint4 r0 = r[0], r1 = r[1];
      eq = r0.x == e0.x && r0.y == e0.y && r0.z == e0.z && r0.w == e0.w &&
           r1.x == e1.x && r1.y == e1.y && r1.z == e1.z && r1.w == e1.w;
    }
    const unsigned m = g.ballot(eq);
    if (m) {
      idx = base + __ffs(m) - 1;
      return true;
    }
  }
  return false;
}

// bytes pos..pos+3 of a node row (0 at or past byte n), little-endian.
// sh: a shared slab row of s bytes (16-byte aligned, zero from n on).
__device__ __forceinline__ uint32_t row_word(const uint8_t* row, bool sh,
                                             int s, int n, int pos) {
  if (sh) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
    const int j = pos >> 2, r = pos & 3;
    const uint32_t lo = 4 * j < s ? w[j] : 0u;
    const uint32_t hi = (r && 4 * (j + 1) < s) ? w[j + 1] : 0u;
    return __funnelshift_r(lo, hi, 8 * r);
  }
  return (uint32_t)byte_at(row, n, pos) |
         ((uint32_t)byte_at(row, n, pos + 1) << 8) |
         ((uint32_t)byte_at(row, n, pos + 2) << 16) |
         ((uint32_t)byte_at(row, n, pos + 3) << 24);
}

// the kernel's reads of a node row: a shared slab row (aligned words,
// zero from byte n to the stride s) or a row in device memory (bytes)
struct RowFetch {
  const uint8_t* row;
  bool sh;
  int s, n, n4;
  __device__ uint32_t bytes4(int pos) const {  // pos >= 0
    return row_word(row, sh, s, n, pos);
  }
  // RLP header at pos clamped to [0, n4 - 1] (rlp.item_head_window)
  __device__ Head head(int pos) const {
    const uint32_t x = bytes4(clampi(pos, 0, n4 - 1));
    return head_fields(x & 0xFF, (x >> 8) & 0xFF, (x >> 16) & 0xFF, x >> 24);
  }
  __device__ int first(int pos) const {
    return (int)(bytes4(clampi(pos, 0, n4 - 1)) & 0xFF);
  }
};

// `exact`: serial decode of the node at byte offset `start`
__device__ Sel decode_exact(const RowFetch& f, int start, int blen,
                            int child) {
  Sel s = {};
  const Head hd = f.head(start);
  const int ps = start + hd.off;
  const int end = ps + hd.len;
  int cursor = ps;
  bool all_ok = true;
#pragma unroll 1
  for (int i = 0; i < 17; ++i) {
    const Head it = f.head(cursor);
    const int ips = cursor + it.off;
    const bool present = cursor < end;
    take_item(s, i, present, child, cursor, ips, it.len, it.list);
    s.count += present;
    all_ok = all_ok && (!present || it.ok);
    if (present) cursor = ips + it.len;
  }
  s.well_formed = hd.list && hd.ok && cursor == end && end <= blen && all_ok;
  return s;
}

// `bounded`: the header at window offset `rel`, through the first hi_rows
// of the sh_rows words of the window that starts at `base` (the window's
// bytes as one word, the bytes at or past the window's end masked off)
__device__ __forceinline__ Head head_win(const RowFetch& f, int base,
                                         int sh_rows, int rel, int hi_rows) {
  const int wp = clampi(rel, 0, f.n4 - 1) >> 2;
  if (wp >= min(sh_rows, hi_rows)) return head_fields(0, 0, 0, 0);
  const int k = 4 * wp + (rel & 3);
  uint32_t x = f.bytes4(base + k);
  const int left = 4 * sh_rows - k;  // window bytes from k on, at least 1
  if (left < 4) x &= (1u << (8 * left)) - 1u;
  return head_fields(x & 0xFF, (x >> 8) & 0xFF, (x >> 16) & 0xFF, x >> 24);
}

// `bounded`: serial decode of the node at byte offset `start` through
// bounded windows; sets ovf where an item lies past its window
__device__ Sel decode_bounded(const RowFetch& f, int start, int blen,
                              int child, bool& ovf) {
  Sel s = {};
  const int n4 = f.n4;
  const int sh_rows = min(n4 / 4, (10 + 35 * 16 + 8) / 4 + 3);
  const int head_pos = clampi(start, 0, n4 - 1);
  const int base = (head_pos >> 2) * 4;
  const Head hd = head_win(f, base, sh_rows, head_pos - base, 3);
  const int ps = start + hd.off;
  const int end = ps + hd.len;
  int cursor = ps;
  bool all_ok = true, latch = false, past = false;
#pragma unroll 1
  for (int i = 0; i < 17; ++i) {
    const bool present = cursor < end;
    if (present && cursor - base > 10 + 35 * i) latch = true;
    if (present && cursor > n4 - 1) past = true;
    const Head it = head_win(f, base, sh_rows, cursor - base,
                             (10 + 35 * i + 8) / 4 + 2);
    const int ips = cursor + it.off;
    take_item(s, i, present, child, cursor, ips, it.len, it.list);
    s.count += present;
    all_ok = all_ok && (!present || it.ok);
    if (present) cursor = ips + it.len;
  }
  ovf = ovf || latch || (past && end <= blen);
  s.well_formed = hd.list && hd.ok && cursor == end && end <= blen && all_ok;
  return s;
}

// `hinted` and its variants, a warp per node: lane i (0..16) decodes item i
// at its hint, and ballots check the chain law for all. short_slots: branch
// slots 2..15 decoded from their first byte, with the long-form latch
// (`hinted4` clears it).
__device__ Sel decode_hinted(const RowFetch& f, const uint8_t* hrow, int blen,
                             int child, bool short_slots, bool& ovf,
                             int lane) {
  const Head hd = f.head(0);
  const int ps = hd.off;
  const int end = ps + hd.len;
  const int h0 = (hrow[0] << 8) | hrow[1];
  const int h17 = (hrow[34] << 8) | hrow[35];
  const bool item = lane < 17;
  const int i = item ? lane : 16;
  const int hi = (hrow[2 * i] << 8) | hrow[2 * i + 1];
  const int hn = (hrow[2 * i + 2] << 8) | hrow[2 * i + 3];  // h[i + 1]
  const bool present = item && hi < end;
  bool latch = present && hi > 10 + 35 * i;
  int ipo, ipl;
  bool ilist, ok;
  if (short_slots && i >= 2 && i <= 15) {
    // branch slots 2..15: the first byte decides a short-form header
    const int b0 = f.first(hi);
    const bool single = b0 < 0x80;
    const bool short_str = b0 >= 0x80 && b0 <= 0xB7;
    const bool short_list = b0 >= 0xC0 && b0 <= 0xF7;
    const bool longf = !single && !short_str && !short_list;
    latch = latch || (present && longf);
    ipo = single ? 0 : 1;
    ipl = single ? 1 : (short_str ? b0 - 0x80 : b0 - 0xC0);
    ilist = b0 >= 0xC0;
    ok = !longf;
  } else {
    const Head it = f.head(hi);
    ipo = it.off;
    ipl = it.len;
    ilist = it.list;
    ok = it.ok;
  }
  const int ips = hi + ipo;
  const bool chain = present ? hn == ips + ipl : hn == hi;
  const bool chain_ok = h0 == ps && __ballot_sync(kFull, item && !chain) == 0;
  const bool all_ok = __ballot_sync(kFull, present && !ok) == 0;
  const bool any_latch = __ballot_sync(kFull, latch) != 0;

  Sel s = {};
  s.count = __popc(__ballot_sync(kFull, present));
  s.i0_pay = __shfl_sync(kFull, ips, 0);
  s.i0_len = __shfl_sync(kFull, ipl, 0);
  s.i0_list = __shfl_sync(kFull, (int)ilist, 0);
  s.i1_start = __shfl_sync(kFull, hi, 1);
  s.i1_pay = __shfl_sync(kFull, ips, 1);
  s.i1_len = __shfl_sync(kFull, ipl, 1);
  s.i1_list = __shfl_sync(kFull, (int)ilist, 1);
  s.i16_pay = __shfl_sync(kFull, ips, 16);
  s.i16_len = __shfl_sync(kFull, ipl, 16);
  const bool cin = child >= 0 && child < 16;
  const int cl = cin ? child : 0;
  const bool ctake = cin && __shfl_sync(kFull, (int)present, cl);
  const int c_start = __shfl_sync(kFull, hi, cl);
  const int c_pay = __shfl_sync(kFull, ips, cl);
  const int c_len = __shfl_sync(kFull, ipl, cl);
  const bool c_list = __shfl_sync(kFull, (int)ilist, cl);
  if (ctake) {
    s.c_start = c_start;
    s.c_pay = c_pay;
    s.c_len = c_len;
    s.c_list = c_list;
  }
  ovf = ovf || any_latch || !chain_ok;
  s.well_formed = hd.list && hd.ok && h17 == end && end <= blen && all_ok;
  return s;
}

// extension/leaf: hex-prefix decode and nibble compare against the key,
// the compare split over the group's lanes (the same result on every lane
// of the group); key nibbles past KN read 0
template <int G>
__device__ Pair step_pair(const uint8_t* row, int n, int n4,
                          const uint8_t* knib, int kn, int klen, int key_pos,
                          int p0s, int p0l, bool p0list, const Group<G>& g) {
  Pair p;
  const int pc = clampi(p0s, 0, n4 - 1);
  const int b0 = byte_at(row, n, pc);
  const int flag = b0 >> 4;
  const int odd = flag & 1;
  p.is_leaf = flag >= 2;
  p.hp_ok = !p0list && p0l >= 1 && flag <= 3 && (odd == 1 || (b0 & 0x0F) == 0);
  p.n_path = 2 * (p0l - 1) + odd;
  const int kn4 = (kn + 3) / 4 * 4;
  const int kp = clampi(key_pos, 0, kn4 - 1);
  const int lim = min(kn, p.n_path);
  bool differs = false;
  for (int j = g.lane; j < lim; j += G) {
    const int k = j + 2 - odd;  // nibble index inside the path window
    const int by = byte_at(row, n, pc + (k >> 1));
    const int pn = (k & 1) ? (by & 0x0F) : (by >> 4);
    const int kx = kp + j;
    const int kv = kx < kn ? (int)knib[kx] : 0;
    differs = differs || pn != kv;
  }
  p.match = !g.any(differs) && key_pos + p.n_path <= klen;
  return p;
}

// value bytes j..j+3 (value[j] = row[vc + j] for j < vlen, else 0)
__device__ __forceinline__ uint32_t value_word(const uint8_t* row, bool sh,
                                               int s, int n, int vc, int vlen,
                                               int j) {
  const int m = vlen - j;  // value bytes in this word
  if (m <= 0) return 0u;
  const uint32_t w = row_word(row, sh, s, n, vc + j);
  return m >= 4 ? w : w & ((1u << (8 * m)) - 1u);
}

// the group writes the value row v[0..mvl): 16-byte stores from the first
// 16-byte aligned address of the row on, single bytes before and after
template <int G>
__device__ void copy_value(uint8_t* v, int mvl, const uint8_t* row, bool sh,
                           int s, int n, int vc, int vlen, int lane) {
  const int head = min(mvl, (int)((16 - ((uintptr_t)v & 15)) & 15));
  const int body = (mvl - head) >> 4;
  const int tail = head + 16 * body;
  const int loose = head + (mvl - tail);
  for (int k = lane; k < loose; k += G) {
    const int j = k < head ? k : tail + (k - head);
    v[j] = (uint8_t)(j < vlen ? byte_at(row, n, vc + j) : 0);
  }
  for (int k = lane; k < body; k += G) {
    const int j = head + 16 * k;
    uint4 o;
    o.x = value_word(row, sh, s, n, vc, vlen, j);
    o.y = value_word(row, sh, s, n, vc, vlen, j + 4);
    o.z = value_word(row, sh, s, n, vc, vlen, j + 8);
    o.w = value_word(row, sh, s, n, vc, vlen, j + 12);
    *reinterpret_cast<uint4*>(v + j) = o;
  }
}

// G lanes walk one proof: G = 32 in the hinted modes (lane i decodes item
// i), G = kSerialLanes in `exact` and `bounded` (mpt_walk_lanes_for)
template <int G>
__global__ void __launch_bounds__(kWarps * 32)
    mpt_walk_warp_kernel(const WalkArgs a, const WarpLayout L) {
  extern __shared__ __align__(16) uint8_t smem[];
  if (skip_batch(a)) return;  // the whole block
  if (a.tally != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(a.tally, 1ULL);
  const int gi = threadIdx.x / G;  // the group's proof slot in the block
  const int b = blockIdx.x * (kWarps * 32 / G) + gi;
  if (b >= a.batch) return;  // the whole group
  Group<G> g;
  g.lane = threadIdx.x % G;
  g.base = (threadIdx.x & 31) - g.lane;
  g.mask = low_bits(G) << g.base;
  const int lane = g.lane;
  uint8_t* sm = smem + gi * L.bytes;
  uint8_t* slab = sm;
  const uint8_t* s_dig = sm + L.dig;
  const uint8_t* s_hint = sm + L.hint;
  const int32_t* s_lens = reinterpret_cast<const int32_t*>(sm + L.lens);
  const uint8_t* s_knib = sm + L.knib;
  const uint8_t* s_root = sm + L.root;
  uint8_t* s_expect = sm + L.expect;

  const int n = a.n;
  const int n4 = (n + 3) / 4 * 4;
  const uint8_t* nodes = a.nodes + b * a.nodes_s0;
  const int32_t* lens = a.node_lens + b * a.lens_s0;
  const bool hinted = a.mode == HINTED || a.mode >= HINTED4;
  const uint8_t* hints = hinted ? a.hints + b * a.hints_s0 : nullptr;
  const int nnum = a.num_nodes[b];
  const int klen = a.key_lens[b];
  const int dlim = min(a.d, max(nnum, 0));

  // ---- stage the proof: rows < dlim (the rows a walk can select) ----
  stage_rows<G>(sm + L.dig, 32, a.digests + b * a.dig_s0, a.dig_s1, dlim, 32, lane);
  if (hinted) stage_rows<G>(sm + L.hint, 36, hints, a.hints_s1, dlim, 36, lane);
  stage_rows<G>(sm + L.lens, 4, reinterpret_cast<const uint8_t*>(lens),
                4 * a.lens_s1, dlim, 4, lane);
  stage_rows<G>(sm + L.knib, L.root - L.knib, a.knib + b * a.knib_s0, 0, 1,
                a.kn, lane);
  stage_rows<G>(sm + L.root, 32, a.roots + b * a.roots_s0, 0, 1, 32, lane);
  if (L.staging == STAGE_ALL) {
    stage_rows<G>(slab, L.s, nodes, a.nodes_s1, dlim, n, lane);
  }
  cp_async_wait_all();
  g.sync();

  // ---- init: locate the root node by digest ----
  int node_idx = 0;
  const bool root_ok = digest_find(s_dig, dlim, s_root, node_idx, g);
  bool root_is_empty = true;
  for (int j = 0; j < 32; ++j) root_is_empty = root_is_empty && s_root[j] == kEmptyRoot[j];
  int status = nnum == 0 ? (root_is_empty ? EXCLUDED : INVALID)
                         : (root_ok ? RUNNING : INVALID);
  int reason = status == INVALID ? R_ROOT_MISSING : R_NONE;
  int off = 0, key_pos = 0, vnode = 0, vstart = 0, vlen = 0;
  bool ovf = false;
  int staged = -1;  // STAGE_ROW: the node row the slab holds

  for (int step = 0; step < a.max_steps && status == RUNNING; ++step) {
    // the node row this step reads: node_idx, or in `ordered` the step's
    // own row, with a latch where the two differ
    int ri = node_idx;
    if (a.mode == ORDERED) {
      ri = min(step, a.d - 1);
      if (node_idx != ri) ovf = true;
    }
    const bool row_sh = ri < dlim && L.staging != STAGE_NONE;
    if (row_sh && L.staging == STAGE_ROW && staged != ri) {
      g.sync();  // every lane is done with the slab's last row
      stage_rows<G>(slab, L.s, nodes + ri * a.nodes_s1, 0, 1, n, lane);
      cp_async_wait_all();
      g.sync();
      staged = ri;
    }
    const uint8_t* row = !row_sh ? nodes + ri * a.nodes_s1
                         : L.staging == STAGE_ALL ? slab + ri * L.s
                                                  : slab;
    const int blen = ri < dlim ? s_lens[ri] : lens[ri * a.lens_s1];
    const int c_nib = (key_pos >= 0 && key_pos < a.kn) ? (int)s_knib[key_pos] : 0;

    const RowFetch f = {row, row_sh, L.s, n, n4};
    Sel s = {};
    if (hinted) {
      if (off != 0) ovf = true;  // an inline child: node-level hints cannot describe it
      const uint8_t* hrow = ri < dlim ? s_hint + ri * 36 : hints + ri * a.hints_s1;
      if constexpr (G == 32) {  // the host launches hinted modes with G = 32
        s = decode_hinted(f, hrow, blen, c_nib, a.mode != HINTED4, ovf, lane);
      }
    } else if (a.mode == BOUNDED) {
      s = decode_bounded(f, off, blen, c_nib, ovf);
    } else {
      s = decode_exact(f, off, blen, c_nib);
    }

    // ---- merge (mirrors ops/mpt._step_merge), warp-uniform ----
    const bool is_branch = s.count == 17;
    const bool is_pair = s.count == 2;
    bool bad_node = !s.well_formed || (!is_branch && !is_pair);
    const bool key_exhausted = key_pos >= klen;
    const bool branch_found = is_branch && key_exhausted && s.i16_len > 0;
    const bool branch_excl = is_branch && key_exhausted && s.i16_len == 0;
    const bool take_child = is_branch && !key_exhausted;
    const bool child_empty = take_child && !s.c_list && s.c_len == 0;

    // read only where is_pair; with one proof per group, `pairskip`'s vote
    // over the proofs walked together is this proof's own is_pair
    Pair p = {false, true, false, 0};
    if (is_pair) {
      p = step_pair(row, n, n4, s_knib, a.kn, klen, key_pos, s.i0_pay,
                    s.i0_len, s.i0_list, g);
    }
    const bool leaf_found =
        is_pair && p.is_leaf && p.match && key_pos + p.n_path == klen;
    const bool leaf_excl = is_pair && p.is_leaf && !leaf_found;
    const bool ext_bad = is_pair && !p.is_leaf && p.n_path == 0;
    const bool ext_excl = is_pair && !p.is_leaf && !p.match;
    const bool ext_child = is_pair && !p.is_leaf && p.match && !ext_bad;
    bad_node = bad_node || (is_pair && !p.hp_ok) || ext_bad;

    const bool has_child = (take_child && !child_empty) || ext_child;
    const int cstart = take_child ? s.c_start : s.i1_start;
    const int cpay = take_child ? s.c_pay : s.i1_pay;
    const int cplen = take_child ? s.c_len : s.i1_len;
    const bool clist = take_child ? s.c_list : s.i1_list;
    const bool child_hash = has_child && !clist && cplen == 32;
    const bool child_inline = has_child && clist;
    const bool child_bad = has_child && !clist && cplen != 32;

    int nxt = 0;
    bool have_next = false;
    if (child_hash) {
      const int cp = clampi(cpay, 0, n4 - 1);
      g.sync();
      for (int j = lane; j < 32; j += G) s_expect[j] = (uint8_t)byte_at(row, n, cp + j);
      g.sync();
      have_next = digest_find(s_dig, dlim, s_expect, nxt, g);
    }
    const bool hash_fail = child_hash && !have_next;

    const int new_status =
        (bad_node || child_bad || hash_fail) ? INVALID
        : (branch_found || leaf_found)       ? FOUND
        : (branch_excl || child_empty || leaf_excl || ext_excl) ? EXCLUDED
                                                                : RUNNING;
    if (new_status == FOUND) {
      vnode = node_idx;
      vstart = leaf_found ? s.i1_pay : s.i16_pay;
      vlen = leaf_found ? s.i1_len : s.i16_len;
    }
    key_pos = take_child ? key_pos + 1 : (ext_child ? key_pos + p.n_path : key_pos);
    off = child_hash ? 0 : (child_inline ? cstart : off);
    node_idx = child_hash ? nxt : node_idx;
    reason = bad_node    ? R_MALFORMED
             : child_bad ? R_BAD_CHILD_REF
             : hash_fail ? R_HASH_MISMATCH
                         : reason;
    status = new_status;
  }

  if (lane < 6) {
    const int word = lane == 0   ? (status == RUNNING ? INVALID : status)
                     : lane == 1 ? vnode
                     : lane == 2 ? vstart
                     : lane == 3 ? vlen
                     : lane == 4 ? (ovf ? 1 : 0)
                                 : (status == RUNNING ? R_TRUNCATED : reason);
    a.out[(long long)b * 6 + lane] = word;
  }
  // a first walk records the batch's re-run flag: the lane that wrote a
  // latched overflow word stores the tag
  if (lane == 4 && ovf && a.flag != nullptr && a.mode != EXACT) *a.flag = a.tag;

  // ---- the value, out of the terminal row ----
  if (a.max_value_len > 0) {
    const bool vsh = vnode < dlim && (L.staging == STAGE_ALL ||
                                      (L.staging == STAGE_ROW && staged == vnode));
    const uint8_t* vrow = !vsh ? nodes + vnode * a.nodes_s1
                          : L.staging == STAGE_ALL ? slab + vnode * L.s
                                                   : slab;
    copy_value<G>(a.values + (long long)b * a.max_value_len, a.max_value_len, vrow,
               vsh, L.s, n, clampi(vstart, 0, n4 - 1), vlen, lane);
  }
}

int round16(long long x) { return (int)((x + 15) / 16 * 16); }

// lanes a proof: a warp for the hinted modes' parallel decode, a smaller
// group for the serial decodes, whose chain then serves 32 / G proofs an
// issued instruction
int mpt_walk_lanes_for(int mode) {
  return (mode == HINTED || mode >= HINTED4) ? 32 : kSerialLanes;
}

// one proof's region; a group of G lanes may hold G / 32 of a warp's budget
WarpLayout warp_layout(const WalkArgs& a) {
  const bool hinted = a.mode == HINTED || a.mode >= HINTED4;
  const int budget = kSlabBudget / (32 / mpt_walk_lanes_for(a.mode));
  WarpLayout L = {};
  L.s = round16(a.n);
  const int tables = round16(32LL * a.d) + (hinted ? round16(36LL * a.d) : 0) +
                     round16(4LL * a.d) + round16(a.kn) + 64;
  const long long all = (long long)a.d * L.s;
  long long slab = 0;
  if (all + tables <= budget) {
    L.staging = STAGE_ALL;
    slab = all;
  } else if ((long long)L.s + tables <= budget) {
    L.staging = STAGE_ROW;
    slab = L.s;
  } else {
    L.staging = STAGE_NONE;
  }
  L.dig = (int)slab;
  L.hint = L.dig + round16(32LL * a.d);
  L.lens = L.hint + (hinted ? round16(36LL * a.d) : 0);
  L.knib = L.lens + round16(4LL * a.d);
  L.root = L.knib + round16(a.kn);
  L.expect = L.root + 32;
  L.bytes = L.expect + 32;
  return L;
}

}  // namespace

// one launch of the kernel on these arguments
extern "C" int zkp_mpt_walk(const WalkArgs* args, void* stream) {
  if (args->batch > 0) {
    const WarpLayout L = warp_layout(*args);
    const int lanes = mpt_walk_lanes_for(args->mode);
    const int proofs = kWarps * 32 / lanes;  // a block
    const size_t smem = (size_t)proofs * L.bytes;
    const int blocks = (args->batch + proofs - 1) / proofs;
    const cudaStream_t st = (cudaStream_t)stream;
    if (lanes == 32) {
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            mpt_walk_warp_kernel<32>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
      }
      mpt_walk_warp_kernel<32><<<blocks, kWarps * 32, smem, st>>>(*args, L);
    } else {
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            mpt_walk_warp_kernel<kSerialLanes>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
      }
      mpt_walk_warp_kernel<kSerialLanes><<<blocks, kWarps * 32, smem, st>>>(*args, L);
    }
  }
  return (int)cudaGetLastError();
}

// the kernel's shared memory for these arguments: out[0] the staging
// (0 all rows, 1 one row at a time, 2 rows read from device memory),
// out[1] lanes a proof, out[2] bytes a proof, out[3] bytes a block
extern "C" void zkp_walk_layout(const WalkArgs* args, int* out) {
  const WarpLayout L = warp_layout(*args);
  out[0] = L.staging;
  out[1] = mpt_walk_lanes_for(args->mode);
  out[2] = L.bytes;
  out[3] = kWarps * 32 / out[1] * L.bytes;
}

extern "C" int zkp_walk_args_size() { return (int)sizeof(WalkArgs); }
