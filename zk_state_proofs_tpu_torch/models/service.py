"""Serving layer: a warm, bucket-pinned batch verifier (port of
`zk_state_proofs_tpu.models.service`).

Requests arrive as raw (root, proof, key) entries; each batch is packed into
one pinned padding bucket and verified through the pooled main path on the
service's device. Pinned depth and pool segment schedules route a batch
through the segmented walk / segmented pool hash only when the batch fits
them; any other batch takes the unsegmented route, with identical results.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from zk_state_proofs_tpu.witness.pack import PackedProofs, PackingError, pack_proofs

from ..ops import mpt
from ..utils.config import BucketConfig
from ..utils.profiling import Meter
from ..witness_bridge import BATCH_FIELDS, POOL_FIELDS, packed_to_tensors, resolve_device
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
    meter: Meter = field(default_factory=Meter)

    @property
    def proofs_per_sec(self) -> float:
        return self.proofs / max(self.seconds, 1e-9)


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
    device:     "cuda" (kernels K1 and K2) or "cpu" (their plain versions).
    mesh:       not supported by this port yet; raises if given.
    """

    def __init__(self, bucket: BucketConfig, batch_size: int = 4096,
                 dedup: bool = True, pool_rows: int = 0, mesh=None,
                 depth_segments: tuple | None = None,
                 pool_segments: tuple | None = None, device="cpu"):
        if mesh is not None:
            raise NotImplementedError("the sharded (mesh) service is not ported yet")
        self.bucket = bucket
        self.batch_size = int(batch_size)
        self.dedup = dedup
        self.pool_rows = int(pool_rows)
        self.depth_segments = depth_segments
        self.pool_segments = pool_segments
        self.device = resolve_device(device)
        self.stats = ServiceStats()
        self._warm = False

    # -- packing ---------------------------------------------------------
    def pack(self, entries) -> PackedProofs:
        """Pack raw (root, proof, key) entries into the pinned bucket,
        padding the batch dimension to `batch_size`. Raises PackingError
        if any proof exceeds the bucket."""
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
        packed = pack_proofs(
            entries, max_nodes=self.bucket.max_nodes,
            node_len=self.bucket.node_len,
            key_nibbles=self.bucket.key_nibbles,
        )
        if self.dedup:
            packed.pool(min_rows=self.pool_rows)
        return packed

    # -- lifecycle -------------------------------------------------------
    def warmup(self, example_entries=None) -> float:
        """Run every route a request can take once (segmented and
        unsegmented walk, segmented and unsegmented pool hash), which
        builds the kernels on first use; derives pool_rows if unset.
        Returns the seconds taken."""
        if example_entries is None:
            from zk_state_proofs_tpu.oracle import EthTrie, keccak256

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
        t0 = time.time()
        packed = self.pack(example_entries)
        if self.pool_segments is not None and self.dedup:
            rows = int(packed.pool()[0].shape[0])
            want = sum(c for c, _ in self.pool_segments)
            if want != rows:
                raise ValueError(
                    f"pinned pool_segments cover {want} rows but the "
                    f"pinned pool bucket is {rows} — derive the schedule "
                    f"from a batch packed into THIS service's bucket "
                    f"(PackedProofs.pool_block_segments on svc.pack(...))")
        self._verify_packed(packed)
        if self.dedup:
            seg_opts = ({None} if self.depth_segments is None
                        else {None, self.depth_segments})
            ps_opts = ({None} if self.pool_segments is None
                       else {None, self.pool_segments})
            done = {(self._compatible_segments(packed),
                     self._compatible_pool_segments(packed))}
            for so in seg_opts:
                for po in ps_opts:
                    if (so, po) not in done:
                        self._verify_packed(packed, force_segments=so,
                                            force_pool_segments=po)
                        done.add((so, po))
        self._warm = True
        return time.time() - t0

    # -- serving ---------------------------------------------------------
    _UNSET = object()

    def _verify_packed(self, packed: PackedProofs, force_segments=_UNSET,
                       force_pool_segments=_UNSET):
        """Device tensors (status, values, value_lens) of a packed batch."""
        mvl = self.bucket.max_value_len
        t = packed_to_tensors(packed, self.device, pool=self.dedup)
        batch = [t[k] for k in BATCH_FIELDS]
        if not self.dedup:
            return mpt.verify_proofs(*batch, max_value_len=mvl)
        segs = (self._compatible_segments(packed)
                if force_segments is BatchVerifier._UNSET else force_segments)
        psegs = (self._compatible_pool_segments(packed)
                 if force_pool_segments is BatchVerifier._UNSET
                 else force_pool_segments)
        return mpt.verify_proofs_pooled(
            *batch, *(t[k] for k in POOL_FIELDS), t["pool_hints"],
            max_value_len=mvl, depth_segments=segs, pool_segments=psegs)

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
        t0 = time.time()
        n = len(entries)
        order = None
        if self.depth_segments is not None and self.dedup:
            # depth-sort for the pinned segment schedule; results are
            # restored to request order below (padding rows, appended by
            # pack(), carry zero nodes and land after every real entry)
            order = sorted(range(n), key=lambda i: -len(entries[i][1]))
            entries = [entries[i] for i in order]
        packed = self.pack(entries)
        status, values, vlens = (x.cpu().numpy()[:n]
                                 for x in self._verify_packed(packed))
        if order is not None:
            inv = np.empty(n, dtype=np.int64)
            inv[np.asarray(order)] = np.arange(n)
            status, values, vlens = status[inv], values[inv], vlens[inv]
        res = VerifyResult(status, values, vlens)
        dt = time.time() - t0
        c = res.counts()
        s = self.stats
        s.batches += 1
        s.proofs += n
        s.found += c["found"]
        s.excluded += c["excluded"]
        s.invalid += c["invalid"]
        s.seconds += dt
        s.meter.record(n, 0, 0, dt)
        return res
