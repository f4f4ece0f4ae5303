"""Serving layer: a warm, bucket-pinned batch verifier (port of
`zk_state_proofs_tpu.models.service`).

Requests arrive as raw (root, proof, key) entries; each batch is packed into
one pinned padding bucket and verified through the pooled main path on the
service's device. Pinned depth and pool segment schedules route a batch
through the segmented walk / segmented pool hash only when the batch fits
them; any other batch takes the unsegmented route, with identical results.

Pool-first packing: where the native library loads, a warm service with
no mesh and with dedup packs a batch by one native pass straight from its
entries into its unique-node pool (`native.pack_pool_native`), written
into one host block, page-locked on a card. The pass reads the entries as
one native walk (`native.walk_entries`) wrote them into host staging the
service allocates once, at warm-up; where the walk does not load or
cannot read a request's objects in place, as `native.encode_entries`
joins them. A request copies that block to the device in one copy; the
device gathers the per-proof node table from the pool. No dense
[B, D, N] table is built on the host or copied. Any other service packs
the dense table and copies it with `packed_to_tensors`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from .. import native
from ..ops import mpt
from ..oracle import EthTrie, keccak256
from ..utils.config import BucketConfig
from ..utils.device import resolve_device
from ..utils.profiling import span
from ..witness.pack import PackedProofs, PackingError, pack_proofs
from ..witness_bridge import BATCH_FIELDS, POOL_FIELDS, packed_to_tensors
from .verifier import VerifyResult


@dataclass
class ServiceStats:
    """Cumulative serving counters."""

    batches: int = 0
    proofs: int = 0
    found: int = 0
    excluded: int = 0
    invalid: int = 0
    seconds: float = 0.0
    staged_batches: int = 0  # requests served by the pool-first route
    walked_batches: int = 0  # of those, requests encoded by the native walk

    @property
    def proofs_per_sec(self) -> float:
        return self.proofs / max(self.seconds, 1e-9)


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32}


def _pool_first_layout(batch: int, bucket: BucketConfig, pool_rows: int) -> tuple:
    """([(name, dtype, shape, offset, size), ...], bytes) of one block
    holding the arrays of native.pool_pass_layout, each 256-byte aligned."""
    layout, offs = [], 0
    for name, dtype, shape in native.pool_pass_layout(
            batch, bucket.max_nodes, bucket.node_len, bucket.key_nibbles, pool_rows):
        size = int(np.prod(shape)) * dtype.itemsize
        layout.append((name, dtype, shape, offs, size))
        offs += -(-size // 256) * 256
    return layout, offs


class _PoolFirstProofs(PackedProofs):
    """A batch packed pool first (native.pack_pool_native) into `block`, a
    uint8 tensor of its own laid out by _pool_first_layout: `arrays`, its
    NumPy views by name, are the pool, hints and per-proof scalars as the
    pass wrote them. The dense node table and its lengths, which the
    pool-first route never reads, are gathered from the pool by pool_idx
    on first read; they equal pack_proofs's byte for byte.

    For a CUDA device the block is page-locked, from PyTorch's caching
    host allocator, which hands a block out again only once the copies
    recorded on it have ended: one request's block is the next one's,
    allocated at warm-up, and is never rewritten under a copy in flight.
    `walked`: the entries were encoded by the native walk."""

    walked = False

    def __init__(self, block: torch.Tensor, layout):
        self.block, self.layout = block, layout
        host = block.numpy()
        self.arrays = {name: host[off:off + size].view(dtype).reshape(shape)
                       for name, dtype, shape, off, size in layout}
        for name in ("num_nodes", "roots", "key_nibbles", "key_lens", *POOL_FIELDS):
            setattr(self, name, self.arrays[name])
        self._pool_hints = self.arrays["pool_hints"]

    @property
    def batch(self) -> int:
        return self.num_nodes.shape[0]

    @cached_property
    def nodes(self) -> np.ndarray:
        return self.pool_nodes[self.pool_idx]

    @cached_property
    def node_lens(self) -> np.ndarray:
        return self.pool_lens[self.pool_idx]

    def to_device(self, device) -> dict:
        """The block on `device`, one non-blocking copy; its tensors by name."""
        on = self.block.to(device, non_blocking=True)
        return {name: on[off:off + size].view(_TORCH_DTYPES[dtype]).view(shape)
                for name, dtype, shape, off, size in self.layout}


class BatchVerifier:
    """Warm batched MPT verification service with a pinned bucket.

    bucket:     padding geometry every batch is packed into (requests
                smaller than `batch_size` are padded with empty proofs,
                which verify INVALID and are sliced off).
    batch_size: the pinned batch dimension.
    pool_rows:  fixed unique-node-pool bucket (0 = derive from the warmup
                batch with 25% headroom).
    dedup:      hash each batch's unique-node pool once (default).
    depth_segments: optional pinned depth schedule ((count, d), ...;
                PackedProofs.depth_segments). Requests are depth-sorted at
                pack time (results restored to request order); a batch
                takes the segmented walk only when every segment's proofs
                fit its d.
    pool_segments: optional pinned pool-hash schedule ((row_count, width),
                ...; PackedProofs.pool_block_segments); a batch takes it
                only when every pool row's length fits its segment width.
    device:     "cuda" (kernels K1 and K2; the default, raises without a
                card) or "cpu" (their plain versions).
    mesh:       optional parallel.make_mesh mesh: every rank serves the
                same requests, each batch sharded over the ranks (the pool
                replicated, walked with the device hint pass) and the
                results all-gathered; `device` must name the type of the
                mesh's device, which serves. Requests are not depth-sorted
                and the pinned schedules are not used, as in the JAX
                service. batch_size must divide by the mesh size.

    Once warm, without a mesh, with dedup and with the native library,
    `pack` packs pool first and `verify` copies only the pool (the
    module's docstring; `stats.staged_batches` counts those requests,
    `stats.walked_batches` those of them the native walk encoded).
    """

    def __init__(self, bucket: BucketConfig, batch_size: int = 4096,
                 dedup: bool = True, pool_rows: int = 0, mesh=None,
                 depth_segments: tuple | None = None,
                 pool_segments: tuple | None = None, device="cuda"):
        self.device = resolve_device(device, mesh)
        if mesh is not None and batch_size % mesh.size:
            raise ValueError(f"batch_size {batch_size} does not divide over "
                             f"{mesh.size} ranks")
        self.mesh = mesh
        self.bucket = bucket
        self.batch_size = int(batch_size)
        self.dedup = dedup
        self.pool_rows = int(pool_rows)
        self.depth_segments = depth_segments
        self.pool_segments = pool_segments
        self.stats = ServiceStats()
        self._warm = False
        self._pool_first = None  # (layout, bytes) of its blocks, set by warmup
        self._staging = None  # native.EntryStaging of the walk, set by warmup
        self._staging_lock = threading.Lock()  # one walk and pass at a time

    # -- packing ---------------------------------------------------------
    def _padded(self, entries) -> list:
        """entries padded to `batch_size` rows; PackingError past it."""
        entries = list(entries)
        if len(entries) > self.batch_size:
            raise PackingError(
                f"batch of {len(entries)} exceeds pinned batch_size="
                f"{self.batch_size}")
        n_pad = self.batch_size - len(entries)
        if n_pad:
            # empty proof + non-empty root rows verify INVALID (root
            # unfindable) and are sliced off in verify()
            entries = entries + [(b"\x00" * 31 + b"\x01", [], b"\x00")] * n_pad
        return entries

    def pack(self, entries) -> PackedProofs:
        """Pack raw (root, proof, key) entries into the pinned bucket,
        padding the batch dimension to `batch_size`. Raises PackingError
        if any proof exceeds the bucket."""
        entries = self._padded(entries)
        with span("zkp.pack"):
            if self._pool_first is not None:
                return self._pack_pool_first(entries)
            with span("zkp.pack.proofs"):
                packed = pack_proofs(
                    entries, max_nodes=self.bucket.max_nodes,
                    node_len=self.bucket.node_len,
                    key_nibbles=self.bucket.key_nibbles,
                )
            if self.dedup:
                with span("zkp.pack.pool"):
                    packed.pool(min_rows=self.pool_rows)
            return packed

    def _pack_pool_first(self, entries) -> _PoolFirstProofs:
        """Padded entries packed pool first: the pool, hints and scalars
        of `pack_proofs(entries).pool(min_rows=pool_rows)` and its
        `pool_hints()`, with the same PackingErrors."""
        (layout, nbytes), bk = self._pool_first, self.bucket
        with self._staging_lock:
            with span("zkp.pack.proofs"):
                encoded = (native.walk_entries(entries, self._staging)
                           if self._staging is not None else None)
                walked = encoded is not None
                if not walked:
                    encoded = native.encode_entries(entries)
            with span("zkp.pack.pool"):
                block = torch.empty(nbytes, dtype=torch.uint8,
                                    pin_memory=self.device.type == "cuda")
                packed = _PoolFirstProofs(block, layout)
                native.pack_pool_native(encoded, bk.max_nodes, bk.node_len,
                                        bk.key_nibbles, packed.arrays)
        packed.walked = walked
        return packed

    # -- lifecycle -------------------------------------------------------
    def warmup(self, example_entries=None) -> float:
        """Run every route a request can take once (segmented and
        unsegmented walk, segmented and unsegmented pool hash), which
        builds the kernels on first use; derives pool_rows if unset.
        Returns the seconds taken."""
        if example_entries is None:
            t = EthTrie()
            n = min(64, self.batch_size)
            keys = [keccak256(b"warmup-%d" % i) for i in range(n)]
            for i, k in enumerate(keys):
                t.insert(k, b"\x01" + bytes([i % 251]) * 40)
            root = t.root_hash()
            example_entries = [(root, t.get_proof(k), k) for k in keys]
        if self.dedup and not self.pool_rows:
            probe = self.pack(example_entries)
            rows = int(probe.pool()[0].shape[0])
            self.pool_rows = -(-int(rows * 1.25) // 128) * 128
        if self.pool_segments is not None and self.dedup:
            want = sum(c for c, _ in self.pool_segments)
            if want != self.pool_rows:
                raise ValueError(
                    f"pinned pool_segments cover {want} rows but the "
                    f"pinned pool bucket is {self.pool_rows} — derive the schedule "
                    f"from a batch packed into THIS service's bucket "
                    f"(PackedProofs.pool_block_segments on svc.pack(...))")
        t0 = time.perf_counter()
        if (self._pool_first is None and self.mesh is None and self.dedup
                and native.available()):
            self._pool_first = _pool_first_layout(self.batch_size, self.bucket,
                                                  self.pool_rows)
            if native.walk_available():
                bk = self.bucket
                self._staging = native.EntryStaging(self.batch_size, bk.max_nodes,
                                                    bk.node_len, bk.key_nibbles)
        packed = self.pack(example_entries)
        verify = self._verify_pool_first if self._pool_first is not None else self._verify_packed
        verify(packed)
        if self.dedup and self.mesh is None:
            seg_opts = ({None} if self.depth_segments is None
                        else {None, self.depth_segments})
            ps_opts = ({None} if self.pool_segments is None
                       else {None, self.pool_segments})
            done = {(self._compatible_segments(packed),
                     self._compatible_pool_segments(packed))}
            for so in seg_opts:
                for po in ps_opts:
                    if (so, po) not in done:
                        verify(packed, force_segments=so, force_pool_segments=po)
                        done.add((so, po))
        self._warm = True
        return time.perf_counter() - t0

    # -- serving ---------------------------------------------------------
    _UNSET = object()

    def _verify_packed(self, packed: PackedProofs, force_segments=_UNSET,
                       force_pool_segments=_UNSET):
        """Device tensors (status, values, value_lens) of a packed batch."""
        mvl = self.bucket.max_value_len
        if self.mesh is not None:
            from ..parallel.mesh import make_sharded_verifier

            fn = make_sharded_verifier(self.mesh, max_value_len=mvl, pooled=self.dedup)
            active = np.ones(packed.batch, dtype=np.int32)
            pool = packed.pool() if self.dedup else ()
            return fn(*(packed.astuple() + (active,) + pool))[:3]
        with span("zkp.copy_in"):
            t = packed_to_tensors(packed, self.device, pool=self.dedup)
        batch = [t[k] for k in BATCH_FIELDS]
        if not self.dedup:
            return mpt.verify_proofs(*batch, max_value_len=mvl)
        return self._verify_pooled(batch, t, packed, force_segments, force_pool_segments)

    def _verify_pool_first(self, packed: _PoolFirstProofs, force_segments=_UNSET,
                       force_pool_segments=_UNSET):
        """Device tensors (status, values, value_lens) of a batch packed
        pool first: its block copied in, then the per-proof node rows and
        lengths gathered on the device from the pool by the pool index
        (padding rows and rows past num_nodes take the zero row 0)."""
        with span("zkp.copy_in"):
            t = packed.to_device(self.device)
            b, d = t["pool_idx"].shape
            flat = t["pool_idx"].view(b * d)
            nodes = torch.index_select(t["pool_nodes"], 0, flat).view(b, d, -1)
            node_lens = torch.index_select(t["pool_lens"], 0, flat).view(b, d)
        batch = [nodes, node_lens, *(t[k] for k in BATCH_FIELDS[2:])]
        return self._verify_pooled(batch, t, packed, force_segments, force_pool_segments)

    def _verify_pooled(self, batch, t, packed, force_segments, force_pool_segments):
        """verify_proofs_pooled on the batch tensors and the pool tensors
        of `t`, with the pinned schedules the packed batch fits (or those
        forced)."""
        segs = (self._compatible_segments(packed)
                if force_segments is BatchVerifier._UNSET else force_segments)
        psegs = (self._compatible_pool_segments(packed)
                 if force_pool_segments is BatchVerifier._UNSET
                 else force_pool_segments)
        return mpt.verify_proofs_pooled(
            *batch, *(t[k] for k in POOL_FIELDS), t["pool_hints"],
            max_value_len=self.bucket.max_value_len, depth_segments=segs,
            pool_segments=psegs)

    def _compatible_segments(self, packed: PackedProofs):
        """The pinned segment schedule iff this (depth-sorted) batch fits
        it — every segment's max num_nodes <= its d; else None."""
        if self.depth_segments is None:
            return None
        if sum(c for c, _ in self.depth_segments) != packed.batch:
            return None
        off = 0
        for cnt, dseg in self.depth_segments:
            seg = packed.num_nodes[off:off + cnt]
            if len(seg) and int(seg.max()) > dseg:
                return None
            off += cnt
        return self.depth_segments

    def _compatible_pool_segments(self, packed: PackedProofs):
        """The pinned pool-hash schedule iff this batch's pool fits it —
        counts sum to the pool rows and every row's length fits its
        segment width; else None."""
        if self.pool_segments is None:
            return None
        lens = packed.pool()[1]
        if sum(c for c, _ in self.pool_segments) != len(lens):
            return None
        off = 0
        for cnt, w in self.pool_segments:
            seg = lens[off:off + cnt]
            if len(seg) and int(seg.max()) > w:
                return None
            off += cnt
        return self.pool_segments

    def verify(self, entries) -> VerifyResult:
        """Pack + verify one request batch; returns per-proof results
        (padding rows sliced off) and updates serving stats."""
        entries = list(entries)
        if not entries:
            raise ValueError("empty request batch")
        if not self._warm:
            self.warmup()
        with span("zkp.service.verify"):
            t0 = time.perf_counter()
            n = len(entries)
            order = None
            if self.depth_segments is not None and self.dedup and self.mesh is None:
                # depth-sort for the pinned segment schedule; results are
                # restored to request order below (padding rows, appended by
                # pack(), carry zero nodes and land after every real entry)
                with span("zkp.service.sort"):
                    order = sorted(range(n), key=lambda i: -len(entries[i][1]))
                    entries = [entries[i] for i in order]
            packed = self.pack(entries)
            out = (self._verify_pool_first(packed) if self._pool_first is not None
                   else self._verify_packed(packed))
            with span("zkp.to_host"):
                status, values, vlens = (x.cpu().numpy()[:n] for x in out)
            if order is not None:
                with span("zkp.service.sort"):
                    inv = np.empty(n, dtype=np.int64)
                    inv[np.asarray(order)] = np.arange(n)
                    status, values, vlens = status[inv], values[inv], vlens[inv]
            res = VerifyResult(status, values, vlens)
            dt = time.perf_counter() - t0
        c = res.counts()
        s = self.stats
        s.batches += 1
        s.proofs += n
        s.found += c["found"]
        s.excluded += c["excluded"]
        s.invalid += c["invalid"]
        s.seconds += dt
        if self._pool_first is not None:
            s.staged_batches += 1
            s.walked_batches += packed.walked
        return res
