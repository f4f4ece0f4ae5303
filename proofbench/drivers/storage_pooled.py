"""Driver `storage_pooled`: one token's holder balances proven against one
state root. The set-up builds the token's storage trie and account path
(`traffic/_storage.py`) from a seed that the harness's population fixes
(the first bytes of its root, itself made from `--seed`), packs the one
account proof and every one of `rotation` batches of slot proofs, and
uploads them. Each request is one call of the port's two-level entry
(`models.verifier.verify_storage_pooled`) on the next batch: the account
proof pooled and `hinted` with pack-time hints, its value decoded (K5),
the batch's raw slots hashed on the card, the slot proofs walked pooled
(`bounded`) against the decoded storage root. It ends when the slots'
status, values and lengths and the account's fields are on the host, and
counts the slots' proofs.

The port calls `ops.mpt.verify_proofs_pooled` for each level, so the
control's stand-in there (ENTRY) replaces both walks. A CUDA run reports
the slot level's guarded `exact` re-runs that walked, a request, from the
port's device tally, read after the window."""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from proofbench.drivers._common import REF_BLOCK, Batches, compare
from proofbench.reference import bounds
from proofbench.reference import storage as reference
from proofbench.traffic._storage import make_storage_world

ENTRY = "verify_proofs_pooled"
ACCOUNT_FIELDS = ("nonce", "balance", "storage_root", "code_hash")


def _table(pop, rows, device):
    """The proofs of `rows` as the reference takes them: nodes u8 [R, D, W],
    node_lens, num_nodes, on `device`."""
    pn = pop.proof_nodes[torch.as_tensor(rows)]
    ids = pn.clamp(min=0)
    return (pop.nodes[ids].to(device), torch.where(pn >= 0, pop.node_lens[ids], 0).to(device),
            pop.proof_lens[torch.as_tensor(rows)].to(device))


class Driver:
    keep_all = False

    def __init__(self, cell: dict, pop, device):
        self.cfg, self.mix = cell["config"], cell["mix"]
        self.dev = device
        self.seed = int.from_bytes(bytes(pop.root[:8].tolist()), "big")
        self.world = None
        self.batches = None
        self.calls = []
        self.requests = 0
        self.walked0 = 0        # the device tally at the end of the set-up
        self.account_walked = 0  # guarded `exact` launches of the account level alone

    def setup(self) -> None:
        from zk_state_proofs_tpu_torch.models.verifier import verify_storage_pooled  # noqa: F401
        from zk_state_proofs_tpu_torch.witness.pack import pack_proofs
        from zk_state_proofs_tpu_torch.witness_bridge import (BATCH_FIELDS, POOL_FIELDS,
                                                              packed_to_tensors)

        cfg, ab, sb = self.cfg, self.cfg["bucket"], self.cfg["slot_bucket"]
        n = cfg["accounts"]
        w = make_storage_world(self.seed, holders=n, virtual_slots=cfg["virtual_slots"],
                               max_nodes=sb["max_nodes"],
                               virtual_accounts=cfg["virtual_accounts"],
                               account_max_nodes=ab["max_nodes"], node_len=sb["node_len"],
                               position=cfg["mapping_position"],
                               tampered=math.ceil(self.mix["tampered_share"] * n),
                               device=self.dev).to("cpu")
        self.world = w
        print(f"storage trie: {w.slots.size} slot proofs, {w.slots.nodes.shape[0]} nodes, "
              f"proof lengths {w.slots.depth_hist}, {int(w.inline.sum())} inline leaves; "
              f"the account proof {w.account.depth_hist}", file=sys.stderr, flush=True)
        self.batches = Batches(w.slots, cfg["batch"], self.mix["rotation"])
        a_packed = pack_proofs(Batches(w.account, 1, 1).entries([0]),
                               max_nodes=ab["max_nodes"], node_len=ab["node_len"],
                               key_nibbles=ab["key_nibbles"])
        at = packed_to_tensors(a_packed, self.dev, pool=True, hints=True)
        account = ([at[f] for f in BATCH_FIELDS], [at[f] for f in POOL_FIELDS],
                   at["pool_hints"])
        for k in range(self.batches.rotation):
            rows = self.batches.rows(k)
            packed = pack_proofs(self.batches.entries(rows), max_nodes=sb["max_nodes"],
                                 node_len=sb["node_len"], key_nibbles=sb["key_nibbles"])
            st = packed_to_tensors(packed, self.dev, pool=True, hints=False)
            self.calls.append((*account, st["nodes"], st["node_lens"], st["num_nodes"],
                               [st[f] for f in POOL_FIELDS], w.raw_slots[rows].to(self.dev),
                               torch.zeros(len(rows), dtype=torch.int32, device=self.dev)))
        for k in range(self.batches.rotation):  # every batch's shapes, once
            self.request(k)
        if self.dev.type == "cuda":
            from zk_state_proofs_tpu_torch.ops import mpt, mpt_cuda

            before = mpt_cuda.exact_walked(self.dev)
            mpt.verify_proofs_pooled(*account[0], *account[1], account[2], max_value_len=128)
            self.account_walked = mpt_cuda.exact_walked(self.dev) - before
            self.walked0 = mpt_cuda.exact_walked(self.dev)
            print(f"the account level alone: {self.account_walked} guarded exact launch(es) "
                  f"walked", file=sys.stderr, flush=True)
        self.requests = 0

    def request(self, i: int):
        from zk_state_proofs_tpu_torch.models import verifier

        a_status, acct, s_status, s_values, s_vlens = verifier.verify_storage_pooled(
            *self.calls[i % len(self.calls)])
        res = tuple(x.cpu().numpy() for x in (s_status, s_values, s_vlens, a_status, acct["ok"],
                                              *(acct[f] for f in ACCOUNT_FIELDS)))
        self.requests += 1
        return len(res[0]), res

    def reference(self, device):
        """The reference's slot answers over the request set (numpy, in its
        order, walked in blocks on `device`) and the account's (status,
        ok, fields), numpy."""
        w = self.world
        a = w.account
        a_status, acct = reference.verify_accounts(
            *_table(a, [0], device), a.root.to(device).expand(1, 32), a.keys.to(device))
        ok = (a_status == reference.FOUND) & acct["ok"]
        q = self.batches.size * self.batches.rotation
        out = []
        for o in range(0, q, REF_BLOCK):
            rows = np.arange(o, min(q, o + REF_BLOCK))
            slots = w.raw_slots[rows].to(device)
            res = reference.verify_slots(*_table(w.slots, rows, device),
                                         acct["storage_root"].expand(len(rows), 32), slots)
            res = reference.override(*res, ok.expand(len(rows)))
            out.append([x.cpu().numpy() for x in res])
        slots = tuple(np.concatenate(parts) for parts in zip(*out))
        account = (a_status.cpu().numpy(), acct["ok"].cpu().numpy(),
                   *(acct[f].cpu().numpy() for f in ACCOUNT_FIELDS))
        return slots, account

    def check(self, kept, ref_device) -> dict:
        slots, (a_status, a_ok, *fields) = self.reference(ref_device)
        bad_slots = bad_accounts = 0
        for i, res in kept:
            rows = self.batches.rows(i % self.batches.rotation)
            bad_slots += compare(res[:3], tuple(x[rows] for x in slots))
            got_status, got_ok, *got = res[3:]
            same = (got_status == a_status) & (got_ok == a_ok)
            found = (a_status == reference.FOUND) & a_ok
            for g, f in zip(got, fields):
                same &= ~found | (g == f).all(1)
            bad_accounts += int((~same).sum())
        return {"mismatched_slots": (bad_slots, 0), "mismatched_accounts": (bad_accounts, 0)}

    def work(self, i: int) -> dict:
        """K1: the distinct nodes of both levels and the batch's 32-byte
        slots; K2: the account level's walk (hinted) and the slot level's
        (bounded)."""
        rows = self.batches.rows(i % self.batches.rotation)
        s, a = self.world.slots, self.world.account
        ids = self.batches.unique_nodes(rows)
        a_ids = torch.unique(a.proof_nodes[a.proof_nodes >= 0])
        lens = torch.cat([s.node_lens[ids], a.node_lens[a_ids],
                          torch.full((len(rows),), 32, dtype=torch.int64)])
        a_lens = _table(a, [0], "cpu")[1]
        s_lens = _table(s, rows, "cpu")[1]
        k2 = (bounds.walk_bound(a_lens, a.proof_lens, self.cfg["bucket"]["key_nibbles"],
                                self.cfg["bucket"]["max_value_len"], hinted=True)
              + bounds.walk_bound(s_lens, s.proof_lens[torch.as_tensor(rows)],
                                  self.cfg["slot_bucket"]["key_nibbles"],
                                  self.cfg["slot_bucket"]["max_value_len"], hinted=False))
        return {"k1": bounds.keccak_bound(lens), "k2": k2}

    def spans(self) -> dict:
        """On a card: the slot level's guarded `exact` launches that walked,
        a request, since the set-up (one read of the device tally)."""
        if self.dev.type != "cuda" or not self.requests:
            return {}
        from zk_state_proofs_tpu_torch.ops import mpt_cuda

        walked = mpt_cuda.exact_walked(self.dev) - self.walked0
        return {"exact_reruns_per_request":
                [walked / self.requests - self.account_walked]}

    def close(self) -> None:
        self.calls.clear()
