"""Driver `service`: each request hands the next of `rotation` batches of
raw (root, proof, key) entries to the port's serving layer
(`models.service.BatchVerifier.verify`: depth sort, pack into the pinned
bucket, pool, copy to the card, verify, back as NumPy). In a traced run
the harness times `BatchVerifier.pack` on the host (`pack_ms`)."""

from __future__ import annotations

import time

from proofbench.drivers._common import Batches, compare

ENTRY = "verify_proofs_pooled"


class Driver:
    keep_all = False

    def __init__(self, cell: dict, pop, device):
        self.cfg, self.mix = cell["config"], cell["mix"]
        self.bucket = self.cfg["bucket"]
        self.dev = device
        self.batches = Batches(pop, self.cfg["batch"], self.mix["rotation"])
        self.entries = []
        self.pack_ms = []
        self.svc = None

    def setup(self) -> None:
        from zk_state_proofs_tpu_torch.models.service import BatchVerifier
        from zk_state_proofs_tpu_torch.utils.config import BucketConfig

        b = self.bucket
        self.entries = [self.batches.entries(self.batches.rows(k))
                        for k in range(self.batches.rotation)]
        self.svc = BatchVerifier(
            BucketConfig(max_nodes=b["max_nodes"], node_len=b["node_len"],
                         key_nibbles=b["key_nibbles"], max_value_len=b["max_value_len"]),
            batch_size=self.batches.size, depth_segments=self.batches.depth_schedule(),
            device=self.dev)
        self.svc.warmup(self.entries[0])
        self.request(0)

    def time_packing(self) -> None:
        """Wrap this service's `pack` in a host clock (traced runs only)."""
        inner = self.svc.pack

        def pack(entries):
            t0 = time.perf_counter()
            try:
                return inner(entries)
            finally:
                self.pack_ms.append((time.perf_counter() - t0) * 1e3)

        self.svc.pack = pack

    def request(self, i: int):
        res = self.svc.verify(self.entries[i % len(self.entries)])
        return len(res.status), (res.status, res.values, res.value_lens)

    def check(self, kept, ref_device) -> dict:
        ref = self.batches.reference(ref_device, self.bucket["max_value_len"])
        bad = 0
        for i, res in kept:
            rows = self.batches.rows(i % self.batches.rotation)
            bad += compare(res, tuple(x[rows] for x in ref))
        return {"mismatched_proofs": (bad, 0)}

    def work(self, i: int) -> dict:
        rows = self.batches.rows(i % self.batches.rotation)
        return self.batches.work(rows, self.bucket["key_nibbles"], self.bucket["max_value_len"],
                                 hint_pass=False)

    def spans(self) -> dict:
        return {"pack_ms": self.pack_ms}

    def close(self) -> None:
        self.svc = None
        self.entries = []
