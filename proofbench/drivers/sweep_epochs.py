"""Driver `sweep_epochs`: the whole request set is one witness, packed
once at set-up, deepest proof first; each request is one call of the
port's `models.sweep.sweep_resident_epochs` (`epochs` passes in windows of
the configuration's batch, the tables uploaded, hashed and expanded anew
by the call) and ends when its counts are back. What the call returns is
the counts: each is held against the reference's counts over the
witness, times the epochs."""

from __future__ import annotations

import numpy as np

from proofbench.drivers._common import Batches

ENTRY = "verify_proofs_prehashed"
CODES = (1, 2, 3)  # FOUND, EXCLUDED, INVALID


class Driver:
    keep_all = True

    def __init__(self, cell: dict, pop, device):
        self.cfg, self.mix = cell["config"], cell["mix"]
        self.bucket = self.cfg["bucket"]
        self.dev = device
        self.epochs = self.mix["epochs"]
        self.batches = Batches(pop, pop.size, 1)  # the whole witness
        self.table_ms = []
        self.witness = None

    def setup(self) -> None:
        from zk_state_proofs_tpu_torch.witness.pack import pack_proofs

        b = self.bucket
        rows = self.batches.rows(0, depth_sorted=True)
        self.witness = pack_proofs(self.batches.entries(rows), max_nodes=b["max_nodes"],
                                   node_len=b["node_len"], key_nibbles=b["key_nibbles"])
        self.witness.pool()
        self.request(0)
        self.table_ms.clear()

    def request(self, i: int):
        from zk_state_proofs_tpu_torch.models.sweep import sweep_resident_epochs

        r = sweep_resident_epochs(self.witness, epochs=self.epochs, batch=self.cfg["batch"],
                                  max_value_len=self.bucket["max_value_len"],
                                  salt=(i * self.epochs) & 0xFF, device=self.dev)
        self.table_ms.append(r.pack_seconds * 1e3)
        return r.total, (r.found, r.excluded, r.invalid, r.total)

    def expected(self, ref_device) -> np.ndarray:
        status = self.batches.reference(ref_device, self.bucket["max_value_len"])[0]
        return np.array([int((status == c).sum()) for c in CODES]) * self.epochs

    def check(self, kept, ref_device) -> dict:
        want = self.expected(ref_device)
        off = sum(int(np.abs(np.array(res[:3]) - want).sum()) for _, res in kept)
        return {"mismatched_counts": (off, 0)}

    def work(self, i: int) -> dict:
        rows = self.batches.rows(0)
        w = self.batches.work(rows, self.bucket["key_nibbles"], self.bucket["max_value_len"],
                              hint_pass=True)
        w["k2"] *= self.epochs
        return w

    def spans(self) -> dict:
        return {"table_build_ms": self.table_ms}

    def close(self) -> None:
        self.witness = None
