// Kernel K2: the fused MPT proof walk, in the seven modes of the TPU kernel:
// `exact`, `bounded`, `hinted` and its variants `hinted4`, `hinted1`,
// `ordered` and `pairskip`.
//
// Replaces zk_state_proofs_tpu/ops/mpt_pallas.py::_walk_kernel (every
// mode). The TPU kernel holds every per-proof scalar as an
// (8, 128) lane tile and, lacking a vector gather, reads node bytes through
// masked reduces over the node's word axis and binary shift cascades. Here
// one thread walks one proof and reads its bytes with plain indexed loads
// straight from global memory: the proof's [D, N] node slab (about 4 KB at
// the account bucket), its digests and its hints. A thread leaves its loop
// as soon as its proof resolves (every latch of the TPU kernel is gated on
// the proof being live, so the early exit changes nothing).
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
//  - `hinted4` is `hinted` with every item header decoded from four bytes
//    (head_at), so branch slots 2..15 take no long-form latch; its flag
//    differs from `hinted`'s only on a present long-form item there;
//  - `hinted1` is `hinted` with the node read as aligned 32-bit words
//    (N % 4 == 0, rows 4-byte aligned: the wrapper pads): each item's
//    header comes from one or two words through a two-word cache, so on a
//    monotonic hint chain every consulted word is loaded once (the TPU's
//    single pass over the node's words feeding all 17 headers). Same flag
//    and words as `hinted`;
//  - `ordered` reads, at step s, the node at row min(s, d - 1) and latches
//    the flag on a live proof whose node_idx differs (an unordered pack, a
//    root not at row 0, a step after an inline child); the rest is
//    `hinted`'s decode and merge, the digest search included;
//  - `pairskip` gates the extension/leaf block on a warp vote: it runs for
//    every thread of the warp's live threads when any of them sits on a
//    2-item node (the TPU's tile-wide pl.when(any_pair)). Same flag and
//    words as `hinted`: a thread's own vote is in the vote;
//  - the value is copied out at the end, byte-aligned: value[j] =
//    node[vnode][clip(vstart) + j] for j < vlen (0 past the buffer).
//
// What bounds it on the H100: latency of dependent byte loads. Each step
// of the exact and bounded decodes is a chain of 18 dependent header
// fetches, and the loads of one warp fall on 32 different proofs
// (uncoalesced). The hinted mode breaks the chain: its 17 header fetches
// are independent. The bounded mode's windows, which cut the TPU's masked
// reduces, buy nothing here (a load costs the same at any offset); it is
// kept for its latch, which must equal the TPU kernel's. The value copy is
// a per-thread byte loop, uncoalesced too: at transaction and receipt
// geometry (about 2 KB leaves) it moves up to max_value_len bytes a proof.
// The first version keeps that simple design (no shared-memory staging, no
// cooperative warps); a later tuning pass can stage the slab in shared
// memory or give a proof to a group of threads.

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

// header at byte position pos, clamped like _fetch4 / fetch_packed
__device__ __forceinline__ Head head_at(const uint8_t* row, int n, int n4,
                                        int pos) {
  const int p = clampi(pos, 0, n4 - 1);
  return head_fields(byte_at(row, n, p), byte_at(row, n, p + 1),
                     byte_at(row, n, p + 2), byte_at(row, n, p + 3));
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

// `exact`: serial decode of the node at byte offset `start`
__device__ Sel decode_exact(const uint8_t* row, int n, int n4, int start,
                            int blen, int child) {
  Sel s = {};
  const Head hd = head_at(row, n, n4, start);
  const int ps = start + hd.off;
  const int end = ps + hd.len;
  int cursor = ps;
  bool all_ok = true;
#pragma unroll 1
  for (int i = 0; i < 17; ++i) {
    const Head it = head_at(row, n, n4, cursor);
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

// `bounded`: byte k of the window of `sh_rows` words that starts at `base`
__device__ __forceinline__ int win_byte(const uint8_t* row, int n, int base,
                                        int sh_rows, int k) {
  return k < 4 * sh_rows ? byte_at(row, n, base + k) : 0;
}

// `bounded`: header at window offset `rel`, through the first hi_rows words
__device__ __forceinline__ Head head_win(const uint8_t* row, int n, int n4,
                                         int base, int sh_rows, int rel,
                                         int hi_rows) {
  const int wp = clampi(rel, 0, n4 - 1) >> 2;
  if (wp >= min(sh_rows, hi_rows)) return head_fields(0, 0, 0, 0);
  const int k = 4 * wp + (rel & 3);
  return head_fields(win_byte(row, n, base, sh_rows, k),
                     win_byte(row, n, base, sh_rows, k + 1),
                     win_byte(row, n, base, sh_rows, k + 2),
                     win_byte(row, n, base, sh_rows, k + 3));
}

// `bounded`: serial decode of the node at byte offset `start` through
// bounded windows; sets ovf where an item lies past its window
__device__ Sel decode_bounded(const uint8_t* row, int n, int n4, int start,
                              int blen, int child, bool& ovf) {
  Sel s = {};
  const int sh_rows = min(n4 / 4, (10 + 35 * 16 + 8) / 4 + 3);
  const int head_pos = clampi(start, 0, n4 - 1);
  const int base = (head_pos >> 2) * 4;
  const Head hd = head_win(row, n, n4, base, sh_rows, head_pos - base, 3);
  const int ps = start + hd.off;
  const int end = ps + hd.len;
  int cursor = ps;
  bool all_ok = true, latch = false, past = false;
#pragma unroll 1
  for (int i = 0; i < 17; ++i) {
    const bool present = cursor < end;
    if (present && cursor - base > 10 + 35 * i) latch = true;
    if (present && cursor > n4 - 1) past = true;
    const Head it = head_win(row, n, n4, base, sh_rows, cursor - base,
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

// byte fetches of a node buffer (every mode but `hinted1`)
struct ByteFetch {
  const uint8_t* row;
  int n, n4;
  __device__ Head head(int pos) const { return head_at(row, n, n4, pos); }
  __device__ int first(int pos) const {
    return byte_at(row, n, clampi(pos, 0, n4 - 1));
  }
};

// `hinted1`: aligned 32-bit word loads of a node buffer of nw words
// (n4 = 4 * nw bytes). The last two words loaded are kept, so fetches at
// non-decreasing positions load each word once.
struct WordFetch {
  const uint32_t* w;
  int nw;
  int i0, i1;
  uint32_t v0, v1;
  __device__ uint32_t word(int j) {
    if (j == i1) return v1;
    if (j == i0) return v0;
    const uint32_t v = j < nw ? w[j] : 0u;
    i0 = i1;
    v0 = v1;
    i1 = j;
    v1 = v;
    return v;
  }
  __device__ Head head(int pos) {
    const int pc = clampi(pos, 0, 4 * nw - 1);
    const int r = pc & 3;
    const uint32_t lo = word(pc >> 2);
    const uint32_t hi = r ? word((pc >> 2) + 1) : 0u;
    // bytes r..r+3 of the two little-endian words, in memory order
    const uint32_t x = (uint32_t)((((uint64_t)hi << 32) | lo) >> (8 * r));
    return head_fields(x & 0xFF, (x >> 8) & 0xFF, (x >> 16) & 0xFF, x >> 24);
  }
  __device__ int first(int pos) {
    const int pc = clampi(pos, 0, 4 * nw - 1);
    return (word(pc >> 2) >> (8 * (pc & 3))) & 0xFF;
  }
};

// `hinted` and its variants: every item fetched at its hint, the chain law
// checked for all. short_slots: branch slots 2..15 decoded from their
// first byte, with the long-form latch (`hinted4` clears it).
template <class Fetch>
__device__ Sel decode_hinted(Fetch& f, const uint8_t* hrow, int blen,
                             int child, bool short_slots, bool& ovf) {
  Sel s = {};
  int h[18];
#pragma unroll
  for (int i = 0; i < 18; ++i) h[i] = (hrow[2 * i] << 8) | hrow[2 * i + 1];
  const Head hd = f.head(0);
  const int ps = hd.off;
  const int end = ps + hd.len;
  bool chain_ok = h[0] == ps;
  bool all_ok = true;
  bool latch = false;
#pragma unroll
  for (int i = 0; i < 17; ++i) {
    const int hi = h[i];
    const bool present = hi < end;
    if (present && hi > 10 + 35 * i) latch = true;
    int ipo, ipl;
    bool ilist, ok;
    if (short_slots && i >= 2 && i <= 15) {
      // branch slots 2..15: the first byte decides a short-form header
      const int b0 = f.first(hi);
      const bool single = b0 < 0x80;
      const bool short_str = b0 >= 0x80 && b0 <= 0xB7;
      const bool short_list = b0 >= 0xC0 && b0 <= 0xF7;
      const bool longf = !single && !short_str && !short_list;
      if (present && longf) latch = true;
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
    chain_ok = chain_ok && (present ? h[i + 1] == ips + ipl : h[i + 1] == hi);
    take_item(s, i, present, child, hi, ips, ipl, ilist);
    s.count += present;
    all_ok = all_ok && (!present || ok);
  }
  if (!chain_ok) latch = true;
  ovf = ovf || latch;
  s.well_formed = hd.list && hd.ok && h[17] == end && end <= blen && all_ok;
  return s;
}

// extension/leaf: hex-prefix decode and nibble compare against the key
__device__ Pair step_pair(const uint8_t* row, int n, int n4,
                          const uint8_t* knib, int kn, int klen, int key_pos,
                          int p0s, int p0l, bool p0list) {
  Pair p;
  const int pc = clampi(p0s, 0, n4 - 1);
  const int b0 = byte_at(row, n, pc);
  const int flag = b0 >> 4;
  const int odd = flag & 1;
  p.is_leaf = flag >= 2;
  p.hp_ok = !p0list && p0l >= 1 && flag <= 3 && (odd == 1 || (b0 & 0x0F) == 0);
  p.n_path = 2 * (p0l - 1) + odd;
  // key window: positions clamp like the path window, nibbles past KN read 0
  const int kn4 = (kn + 3) / 4 * 4;
  const int kp = clampi(key_pos, 0, kn4 - 1);
  bool match = true;
  for (int j = 0; j < kn && j < p.n_path; ++j) {
    const int k = j + 2 - odd;  // nibble index inside the path window
    const int by = byte_at(row, n, pc + (k >> 1));
    const int pn = (k & 1) ? (by & 0x0F) : (by >> 4);
    const int kx = kp + j;
    const int kv = kx < kn ? (int)knib[kx] : 0;
    if (pn != kv) {
      match = false;
      break;
    }
  }
  p.match = match && key_pos + p.n_path <= klen;
  return p;
}

// first digest row dd < dlim equal to the 32 bytes at `expect`
__device__ __forceinline__ bool digest_find(const uint8_t* dig, long long s1,
                                            int dlim, const uint8_t* expect,
                                            int& idx) {
  for (int dd = 0; dd < dlim; ++dd) {
    const uint8_t* r = dig + dd * s1;
    bool eq = true;
    for (int j = 0; j < 32 && eq; ++j) eq = r[j] == expect[j];
    if (eq) {
      idx = dd;
      return true;
    }
  }
  return false;
}

__global__ void mpt_walk_kernel(const WalkArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.batch) return;
  const int n = a.n;
  const int n4 = (n + 3) / 4 * 4;
  const uint8_t* nodes = a.nodes + b * a.nodes_s0;
  const int32_t* lens = a.node_lens + b * a.lens_s0;
  const uint8_t* dig = a.digests + b * a.dig_s0;
  const uint8_t* root = a.roots + b * a.roots_s0;
  const uint8_t* knib = a.knib + b * a.knib_s0;
  const bool hinted = a.mode == HINTED || a.mode >= HINTED4;
  const uint8_t* hints = hinted ? a.hints + b * a.hints_s0 : nullptr;
  const int nnum = a.num_nodes[b];
  const int klen = a.key_lens[b];
  const int dlim = min(a.d, max(nnum, 0));

  // ---- init: locate the root node by digest ----
  int node_idx = 0;
  const bool root_ok = digest_find(dig, a.dig_s1, dlim, root, node_idx);
  bool root_is_empty = true;
  for (int j = 0; j < 32; ++j) root_is_empty = root_is_empty && root[j] == kEmptyRoot[j];
  int status = nnum == 0 ? (root_is_empty ? EXCLUDED : INVALID)
                         : (root_ok ? RUNNING : INVALID);
  int reason = status == INVALID ? R_ROOT_MISSING : R_NONE;
  int off = 0, key_pos = 0, vnode = 0, vstart = 0, vlen = 0;
  bool ovf = false;

  for (int step = 0; step < a.max_steps && status == RUNNING; ++step) {
    // the node row this step reads: node_idx, or in `ordered` the step's
    // own row, with a latch where the two differ
    int ri = node_idx;
    if (a.mode == ORDERED) {
      ri = min(step, a.d - 1);
      if (node_idx != ri) ovf = true;
    }
    const uint8_t* row = nodes + ri * a.nodes_s1;
    const int blen = lens[ri * a.lens_s1];
    const int c_nib = (key_pos >= 0 && key_pos < a.kn) ? (int)knib[key_pos] : 0;

    Sel s;
    if (hinted) {
      if (off != 0) ovf = true;  // an inline child: node-level hints cannot describe it
      const uint8_t* hrow = hints + ri * a.hints_s1;
      if (a.mode == HINTED1) {
        WordFetch f = {reinterpret_cast<const uint32_t*>(row), n4 / 4, -1, -1, 0u, 0u};
        s = decode_hinted(f, hrow, blen, c_nib, true, ovf);
      } else {
        ByteFetch f = {row, n, n4};
        s = decode_hinted(f, hrow, blen, c_nib, a.mode != HINTED4, ovf);
      }
    } else if (a.mode == BOUNDED) {
      s = decode_bounded(row, n, n4, off, blen, c_nib, ovf);
    } else {
      s = decode_exact(row, n, n4, off, blen, c_nib);
    }

    // ---- merge (mirrors ops/mpt._step_merge) ----
    const bool is_branch = s.count == 17;
    const bool is_pair = s.count == 2;
    bool bad_node = !s.well_formed || (!is_branch && !is_pair);
    const bool key_exhausted = key_pos >= klen;
    const bool branch_found = is_branch && key_exhausted && s.i16_len > 0;
    const bool branch_excl = is_branch && key_exhausted && s.i16_len == 0;
    const bool take_child = is_branch && !key_exhausted;
    const bool child_empty = take_child && !s.c_list && s.c_len == 0;

    Pair p = {false, true, false, 0};  // read only where is_pair
    // `pairskip`: the pair block runs for all of the warp's live threads
    // when any of them is on a pair node (threads that have left the step
    // loop are out of the vote)
    const bool run_pair = a.mode == PAIRSKIP ? __any_sync(__activemask(), is_pair)
                                             : is_pair;
    if (run_pair) {
      p = step_pair(row, n, n4, knib, a.kn, klen, key_pos, s.i0_pay, s.i0_len,
                    s.i0_list);
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
      uint8_t expect[32];
      const int cp = clampi(cpay, 0, n4 - 1);
      for (int j = 0; j < 32; ++j) expect[j] = (uint8_t)byte_at(row, n, cp + j);
      have_next = digest_find(dig, a.dig_s1, dlim, expect, nxt);
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

  int32_t* o = a.out + (long long)b * 6;
  o[0] = status == RUNNING ? INVALID : status;
  o[1] = vnode;
  o[2] = vstart;
  o[3] = vlen;
  o[4] = ovf ? 1 : 0;
  o[5] = status == RUNNING ? R_TRUNCATED : reason;

  // value bytes, byte-aligned and masked by vlen
  if (a.max_value_len > 0) {
    uint8_t* v = a.values + (long long)b * a.max_value_len;
    const uint8_t* vrow = nodes + vnode * a.nodes_s1;
    const int vc = clampi(vstart, 0, n4 - 1);
    for (int j = 0; j < a.max_value_len; ++j) {
      v[j] = (uint8_t)(j < vlen ? byte_at(vrow, n, vc + j) : 0);
    }
  }
}

}  // namespace

extern "C" int zkp_mpt_walk(const WalkArgs* args, void* stream) {
  if (args->batch > 0) {
    const int threads = 32;
    const int blocks = (args->batch + threads - 1) / threads;
    mpt_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

extern "C" int zkp_walk_args_size() { return (int)sizeof(WalkArgs); }
