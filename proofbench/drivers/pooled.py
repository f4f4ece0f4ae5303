"""Driver `pooled`: each request verifies the next of `rotation` batches
packed and uploaded at set-up, through the port's pooled main path
(`ops.mpt.verify_proofs_pooled`), and ends when status, values and value
lengths are on the host. Mix keys: `hints` ("pack": the packer's pool
hints; "device": none, so the port's device hint pass makes them),
`segments` (the batch's depth and pool-hash segment schedules, or one
unsegmented walk and hash)."""

from __future__ import annotations

import torch

from proofbench.drivers._common import Batches, compare

ENTRY = "verify_proofs_pooled"


class Driver:
    keep_all = False

    def __init__(self, cell: dict, pop, device):
        self.cfg, self.mix = cell["config"], cell["mix"]
        bucket = self.cfg["bucket"]
        self.bucket = bucket
        self.dev = device
        self.batches = Batches(pop, self.cfg["batch"], self.mix["rotation"])
        self.calls = []
        self.rows = []

    def setup(self) -> None:
        from zk_state_proofs_tpu_torch.witness.pack import pack_proofs
        from zk_state_proofs_tpu_torch.witness_bridge import (BATCH_FIELDS, POOL_FIELDS,
                                                              packed_to_tensors)

        b = self.bucket
        pack_hints = self.mix["hints"] == "pack"
        for k in range(self.batches.rotation):
            rows = self.batches.rows(k, depth_sorted=self.mix["segments"])
            packed = pack_proofs(self.batches.entries(rows), max_nodes=b["max_nodes"],
                                 node_len=b["node_len"], key_nibbles=b["key_nibbles"])
            t = packed_to_tensors(packed, self.dev, pool=True, hints=pack_hints)
            args = [t[f] for f in BATCH_FIELDS + POOL_FIELDS]
            kw = {"pool_hints": t.get("pool_hints"), "max_value_len": b["max_value_len"]}
            if self.mix["segments"]:
                kw["depth_segments"] = packed.depth_segments()
                kw["pool_segments"] = packed.pool_block_segments()
            self.rows.append(rows)
            self.calls.append((args, kw))
        for k in range(self.batches.rotation):  # every batch's shapes, once
            self.request(k)

    def request(self, i: int):
        from zk_state_proofs_tpu_torch.ops import mpt

        args, kw = self.calls[i % len(self.calls)]
        with torch.profiler.record_function("pb.verify"):
            out = mpt.verify_proofs_pooled(*args, **kw)
        with torch.profiler.record_function("pb.to_host"):
            res = tuple(x.cpu().numpy() for x in out)
        return len(res[0]), res

    def check(self, kept, ref_device) -> dict:
        ref = self.batches.reference(ref_device, self.bucket["max_value_len"])
        bad = 0
        for i, res in kept:
            rows = self.rows[i % len(self.rows)]
            bad += compare(res, tuple(x[rows] for x in ref))
        return {"mismatched_proofs": (bad, 0)}

    def work(self, i: int) -> dict:
        rows = self.rows[i % len(self.rows)]
        return self.batches.work(rows, self.bucket["key_nibbles"], self.bucket["max_value_len"],
                                 hint_pass=self.mix["hints"] == "device")

    def spans(self) -> dict:
        return {}

    def close(self) -> None:
        self.calls.clear()
