"""Host-side witness packing: proofs -> padded device tensor bundles.

The port's own copy of `zk_state_proofs_tpu.witness.pack`, its disk cache
included, over the port's `oracle` and `native`. The equivalent of the
reference's `MerkleProofInput` wire struct
(reference: crypto-ops/src/types.rs:5-9 — `proof: Vec<Vec<u8>>, root_hash,
key`): variable-length proof-node lists become zero-padded fixed-shape
arrays bucketed by (max_nodes, node_len), plus explicit lengths, ready for
`ops.mpt.verify_proofs`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..oracle.trie import bytes_to_nibbles

DEFAULT_KEY_NIBBLES = 64  # 32-byte keys (account/storage tries)


class PackingError(ValueError):
    """Batch does not fit its padding bucket, or a packed/deserialized
    witness bundle fails integrity validation. Part of the structured
    error taxonomy (the reference's equivalent failures are panics,
    reference: crypto-ops/src/lib.rs:14,22)."""


@dataclass
class PackedProofs:
    """A batch of padded MPT proofs (numpy, ready for device put).

    The optional node POOL deduplicates hashing: proofs in one batch share
    trie nodes (every account proof repeats the same root/branch prefix —
    a 4096-proof batch over a 512-account trie has ~45x fewer unique nodes
    than proof rows), so the device hashes `pool_nodes` once and scatters
    digests back to the [B, D] per-proof table. The reference re-hashes
    every node per proof (crypto-ops/src/lib.rs:10-13); the walk itself
    still checks every per-proof hash link, so verification strength is
    unchanged.
    """

    nodes: np.ndarray       # u8  [B, D, N]
    node_lens: np.ndarray   # i32 [B, D]
    num_nodes: np.ndarray   # i32 [B]
    roots: np.ndarray       # u8  [B, 32]
    key_nibbles: np.ndarray  # u8 [B, K]
    key_lens: np.ndarray    # i32 [B]
    pool_nodes: np.ndarray | None = None  # u8  [U, N] unique node bytes
    pool_lens: np.ndarray | None = None   # i32 [U]
    pool_idx: np.ndarray | None = None    # i32 [B, D] row -> pool row
    _pool_hints: np.ndarray | None = None  # u8 [U, 36] RLP offset hints

    @property
    def batch(self) -> int:
        return self.nodes.shape[0]

    def astuple(self):
        return (
            self.nodes,
            self.node_lens,
            self.num_nodes,
            self.roots,
            self.key_nibbles,
            self.key_lens,
        )

    def pool(self, min_rows: int = 0):
        """(pool_nodes, pool_lens, pool_idx), building them on first use.

        min_rows pads the pool to a fixed row bucket so streamed batches
        keep one jit shape (a varying pool size would retrace the
        verifier per batch)."""
        if self.pool_nodes is None:
            self.pool_nodes, self.pool_lens, self.pool_idx = build_node_pool(
                self.nodes, self.node_lens, self.num_nodes, min_rows=min_rows
            )
        if min_rows and self.pool_nodes.shape[0] > min_rows:
            raise PackingError(
                f"node pool needs {self.pool_nodes.shape[0]} rows > bucket "
                f"pool_rows={min_rows}"
            )
        return self.pool_nodes, self.pool_lens, self.pool_idx

    def pool_hints(self, min_rows: int = 0) -> np.ndarray:
        """Per-pool-row RLP item-offset hints (u8 [U, 36]) for the fused
        walk kernel's parallel-decode mode, computed ON THE HOST at pack
        time (native C++ scan; numpy fallback). The device alternative
        (ops.rlp.item_offsets) costs ~0.34 ms per 5.6k-row pool on v5e —
        18 sequential tiny one-hot fetches, kernel-launch-bound — while
        the host scan rides the packer for ~free and the existing digest
        scatter carries the 36 bytes to the per-proof table. Hints are
        UNTRUSTED either way: the kernel re-verifies the offset chain in
        parallel and falls back to its exact serial decode on any
        mismatch, so a stale or hostile hint costs speed, never
        soundness."""
        pool_nodes, _, _ = self.pool(min_rows)
        if (self._pool_hints is None
                or self._pool_hints.shape[0] != pool_nodes.shape[0]):
            self._pool_hints = host_item_offsets(pool_nodes)
        return self._pool_hints

    def depth_segments(self, tile: int = 1024) -> tuple:
        """Static contiguous depth segments ((count, d), ...) at kernel-tile
        granularity, for the depth-bucketed walk dispatch
        (ops.mpt.verify_proofs_pooled(depth_segments=...)).

        Each tile's d is the max num_nodes within it; adjacent equal-d
        tiles merge. On a depth-sorted batch (descending — the bench/
        serving batch-formation order) segments are depth-homogeneous, so
        shallow tiles walk with a smaller static node axis: the fused
        kernel's per-step node materialization and double-buffered input
        streaming both scale with d, and measured A/Bs show that term —
        not decode ops or fetch traffic — sets the walk's pace. Works
        (correctly, just with less win) on unsorted batches too."""
        nn = self.num_nodes
        segs: list[tuple[int, int]] = []
        for off in range(0, len(nn), tile):
            cnt = min(tile, len(nn) - off)
            d = max(int(nn[off:off + cnt].max()), 1)
            if segs and segs[-1][1] == d:
                segs[-1] = (segs[-1][0] + cnt, d)
            else:
                segs.append((cnt, d))
        return tuple(segs)

    def pool_block_segments(self, tile: int = 1024) -> tuple:
        """Static contiguous ((row_count, width_bytes), ...) segments of
        the unique-node pool at kernel-tile granularity, for segmented
        pool hashing (ops.mpt.hash_nodes_pooled(pool_segments=...)).

        The pool is length-sorted descending, so slicing it by sponge
        block count gives contiguous runs; each segment hashes at its own
        trimmed static width. The win is in the XLA prep passes
        (pad_messages / bytes_to_lanes / transposes), which scale with
        the STATIC block bucket: an unsegmented 576-B pool preps 5 rate
        blocks for every row although the sorted pool is mostly 1-block
        leaves (two-point device A/B at the headline pool: ~0.08 ->
        ~0.03 ms/batch). Zero-length rows (reserved row 0 + tail padding)
        fold into the adjacent run — hashing them at any width is exact
        (length-masked sponge). Segment boundaries round UP to `tile` so
        each pallas dispatch stays tile-aligned; widths round to 8."""
        _, lens, _ = self.pool()
        lens = np.asarray(lens)
        rate = 136
        nblk = np.where(lens > 0, lens // rate + 1, 0)
        real = np.nonzero(nblk)[0]
        if len(real) == 0:
            return ((len(lens), 8),)
        filled = nblk.copy()
        last = nblk[real[0]]
        for i in range(len(filled)):
            if filled[i] == 0:
                filled[i] = last
            else:
                last = filled[i]
        segs: list[tuple[int, int]] = []
        off = 0
        n = len(lens)
        while off < n:
            nb = filled[off]
            end = off
            while end < n and filled[end] == nb:
                end += 1
            # round the boundary up to tile alignment (rows absorbed from
            # the next run have <= nb blocks: exact, just less trimming)
            end = min(n, off + -(-(end - off) // tile) * tile)
            w = int(lens[off:end].max())
            seg = (end - off, max(-(-w // 8) * 8, 8))
            if segs and segs[-1][1] == seg[1]:
                segs[-1] = (segs[-1][0] + seg[0], seg[1])
            else:
                segs.append(seg)
            off = end
        return tuple(segs)

    # -- disk cache: a packed witness persists, so that a sweep resumes
    # without fetching and packing again; the same .npz keys as the JAX
    # package's, so a cache written by either loads in the other. Pool
    # hints are not saved (pool_hints() recomputes them). --
    def save(self, path) -> None:
        extra = {}
        if self.pool_nodes is not None:
            extra = {"pool_nodes": self.pool_nodes, "pool_lens": self.pool_lens,
                     "pool_idx": self.pool_idx}
        np.savez_compressed(
            path,
            nodes=self.nodes, node_lens=self.node_lens, num_nodes=self.num_nodes,
            roots=self.roots, key_nibbles=self.key_nibbles, key_lens=self.key_lens,
            **extra,
        )

    @classmethod
    def load(cls, path) -> "PackedProofs":
        with np.load(path) as z:
            packed = cls(
                nodes=z["nodes"], node_lens=z["node_lens"], num_nodes=z["num_nodes"],
                roots=z["roots"], key_nibbles=z["key_nibbles"], key_lens=z["key_lens"],
                pool_nodes=z["pool_nodes"] if "pool_nodes" in z else None,
                pool_lens=z["pool_lens"] if "pool_lens" in z else None,
                pool_idx=z["pool_idx"] if "pool_idx" in z else None,
            )
        # A deserialized pool is untrusted until validated: the pooled
        # verifier hashes pool_nodes but walks nodes[i, j], so a stale or
        # tampered cache could otherwise make invalid proofs verify.
        if packed.pool_nodes is not None:
            validate_node_pool(
                packed.nodes, packed.node_lens, packed.num_nodes,
                packed.pool_nodes, packed.pool_lens, packed.pool_idx,
            )
        return packed


def validate_node_pool(nodes, node_lens, num_nodes, pool_nodes, pool_lens,
                       pool_idx) -> None:
    """Check nodes[i, j] == pool_nodes[pool_idx[i, j]] for every real row.

    The invariant the pooled verifier trusts (ops.mpt.verify_proofs_pooled
    hashes the pool, the walk reads nodes[i, j] bytes); raises PackingError
    on any mismatch, with the JAX package's messages. Vectorized (one
    gather and masked compares), cheap enough to run on every load."""
    b, d, n = nodes.shape
    u = pool_nodes.shape[0]
    if pool_idx.shape != (b, d):
        raise PackingError(f"pool_idx shape {pool_idx.shape} != {(b, d)}")
    real = np.arange(d)[None, :] < np.asarray(num_nodes)[:, None]  # [B, D]
    idx = np.asarray(pool_idx)
    if (idx < 0).any() or (idx >= u).any():
        raise PackingError("pool_idx out of range")
    if not (np.asarray(pool_lens)[idx] == np.asarray(node_lens))[real].all():
        raise PackingError("pool_lens disagree with node_lens")
    gathered = np.asarray(pool_nodes)[idx]           # u8 [B, D, N]
    byte_live = np.arange(n)[None, None, :] < np.asarray(node_lens)[:, :, None]
    mismatch = (gathered != np.asarray(nodes)) & byte_live & real[:, :, None]
    if mismatch.any():
        i, j, _ = np.argwhere(mismatch)[0]
        raise PackingError(
            f"pool integrity violation: nodes[{i},{j}] != pool_nodes[pool_idx[{i},{j}]]"
        )


def _rlp_head_vec(rows, pos, n4):
    """Vectorized RLP header parse at per-row positions `pos` (numpy
    mirror of ops/rlp.item_head_window + its clamped 4-byte fetch).
    rows u8 [R, L]; pos i64 [R]. Returns (payload_off, payload_len)."""
    r, l = rows.shape
    pc = np.clip(pos, 0, n4 - 1)
    idx = pc[:, None] + np.arange(4)[None, :]
    b = np.where(idx < l, rows[np.arange(r)[:, None], np.minimum(idx, l - 1)],
                 0).astype(np.int64)
    b0 = b[:, 0]
    lol = np.where((b0 >= 0xB8) & (b0 <= 0xBF), b0 - 0xB7,
                   np.where(b0 >= 0xF8, b0 - 0xF7, 0))
    long_len = np.where(lol == 1, b[:, 1],
                        np.where(lol == 2, (b[:, 1] << 8) | b[:, 2],
                                 (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]))
    single = b0 < 0x80
    po = np.where(single, 0, 1 + lol)
    pl = np.where(single, 1,
                  np.where(lol > 0, long_len,
                           np.where(b0 >= 0xC0, b0 - 0xC0, b0 - 0x80)))
    return po, pl


def host_item_offsets(rows) -> np.ndarray:
    """Host-side mirror of ops/rlp.item_offsets: u8 [R, L] -> u8 [R, 36]
    (18 big-endian u16 decode-chain cursors per node). Native C++ scan
    when available; vectorized-numpy serial chain otherwise. Bit-identical
    to the device pass (tests/test_mpt_pallas.py asserts it), so
    pack-time hints never trip the kernel's parallel chain check on
    honest nodes."""
    from .. import native as _native

    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    out = _native.item_offsets_native(rows)
    if out is not None:
        return out
    r, l = rows.shape
    n4 = -(-l // 4) * 4
    po, pl = _rlp_head_vec(rows, np.zeros(r, np.int64), n4)
    end = po + pl
    cursor = po
    hs = [cursor]
    for _ in range(17):
        ipo, ipl = _rlp_head_vec(rows, cursor, n4)
        present = cursor < end
        cursor = np.where(present, cursor + ipo + ipl, cursor)
        hs.append(cursor)
    h = np.clip(np.stack(hs, axis=1), 0, 0xFFFF)
    return np.stack([h >> 8, h & 0xFF], axis=-1).reshape(r, 36).astype(np.uint8)


def build_node_pool(nodes, node_lens, num_nodes, pad_multiple: int = 128,
                    min_rows: int = 0):
    """Deduplicate proof-node rows into a pool for single-pass hashing.

    Returns (pool_nodes u8 [U, N], pool_lens i32 [U], pool_idx i32 [B, D])
    with U padded to `pad_multiple` (pool row 0 is always the zero row, so
    padding rows and rows past num_nodes scatter a harmless digest).

    Rows 1.. are ordered by DESCENDING byte length (stable within equal
    lengths): the Pallas keccak kernel's sponge-block skip is per
    1024-row tile (keccak_pallas._keccak_kernel), so grouping multi-block
    branch nodes together lets leaf-only tiles run one permutation
    instead of node_len//136+1.

    Uses the native C++ dedup (hash-table pass over the packed rows) when
    available — the Python per-row dict loop below is the fallback and the
    parity reference (tests/test_native.py asserts byte-identical output).
    """
    from .. import native as _native

    if _native.available():
        out = _native.build_node_pool_native(nodes, node_lens, num_nodes,
                                             pad_multiple, min_rows)
        if out is not None:
            return out

    b, d, n = nodes.shape
    seen = {b"": 0}
    pool = [np.zeros(n, np.uint8)]
    lens = [0]
    idx = np.zeros((b, d), np.int32)
    for i in range(b):
        for j in range(int(num_nodes[i])):
            key = nodes[i, j, : node_lens[i, j]].tobytes()
            at = seen.get(key)
            if at is None:
                at = len(pool)
                seen[key] = at
                pool.append(nodes[i, j])
                lens.append(int(node_lens[i, j]))
            idx[i, j] = at
    # reorder rows 1.. by descending length (stable), remap idx (padding
    # rows and empty rows keep pointing at the zero row 0)
    order = np.argsort(-np.asarray(lens[1:], np.int64), kind="stable") + 1
    inv = np.zeros(len(pool), np.int32)
    inv[order] = np.arange(1, len(pool), dtype=np.int32)
    idx = inv[idx]
    pool = [pool[0]] + [pool[i] for i in order]
    lens = [0] + [int(lens[i]) for i in order]
    u = max(-(-len(pool) // pad_multiple) * pad_multiple, min_rows)
    pool_nodes = np.zeros((u, n), np.uint8)
    pool_nodes[: len(pool)] = np.stack(pool)
    pool_lens = np.zeros(u, np.int32)
    pool_lens[: len(lens)] = lens
    return pool_nodes, pool_lens, idx


def pack_proofs(
    entries,
    max_nodes: int | None = None,
    node_len: int | None = None,
    key_nibbles: int = DEFAULT_KEY_NIBBLES,
) -> PackedProofs:
    """Pack `entries` = iterable of (root: bytes32, proof: list[bytes],
    key: bytes) into a PackedProofs bundle.

    `max_nodes` / `node_len` default to the batch maxima; pass explicit
    bucket sizes for stable jit shapes across batches.
    """
    entries = list(entries)
    b = len(entries)
    if b == 0:
        raise ValueError("empty proof batch")

    from .. import native as _native

    if max_nodes is not None and node_len is not None and _native.available():
        # native packer (C++) validates the bucket per proof itself —
        # skip the Python maxima scan (it costs as much as the packing
        # on large streamed batches)
        packed = _native.pack_proofs_native(entries, max_nodes, node_len,
                                            key_nibbles)
        if packed is not None:
            return PackedProofs(*packed)

    need_nodes = max((len(p) for _, p, _ in entries), default=1)
    need_len = max((len(n) for _, p, _ in entries for n in p), default=1)
    d = max_nodes if max_nodes is not None else max(need_nodes, 1)
    n = node_len if node_len is not None else max(need_len, 4)
    if need_nodes > d:
        raise PackingError(f"proof with {need_nodes} nodes exceeds bucket max_nodes={d}")
    if need_len > n:
        raise PackingError(f"node of {need_len} bytes exceeds bucket node_len={n}")

    # native packer (C++) when available — same layout, one ctypes call
    if _native.available():
        packed = _native.pack_proofs_native(entries, d, n, key_nibbles)
        if packed is not None:
            return PackedProofs(*packed)

    nodes = np.zeros((b, d, n), dtype=np.uint8)
    node_lens = np.zeros((b, d), dtype=np.int32)
    num_nodes = np.zeros(b, dtype=np.int32)
    roots = np.zeros((b, 32), dtype=np.uint8)
    knib = np.zeros((b, key_nibbles), dtype=np.uint8)
    key_lens = np.zeros(b, dtype=np.int32)

    for i, (root, proof, key) in enumerate(entries):
        if len(root) != 32:
            raise PackingError("root must be 32 bytes")
        roots[i] = np.frombuffer(root, dtype=np.uint8)
        num_nodes[i] = len(proof)
        for j, node in enumerate(proof):
            nodes[i, j, : len(node)] = np.frombuffer(node, dtype=np.uint8)
            node_lens[i, j] = len(node)
        nibs = bytes_to_nibbles(key)
        if len(nibs) > key_nibbles:
            raise PackingError(f"key has {len(nibs)} nibbles > bucket {key_nibbles}")
        knib[i, : len(nibs)] = nibs
        key_lens[i] = len(nibs)
    return PackedProofs(nodes, node_lens, num_nodes, roots, knib, key_lens)
