"""What the drivers share: the request set cut into batches, the raw
(root, proof, key) entries a caller hands the system, the reference's
answers, the comparison, and the work a request asks of each kernel."""

from __future__ import annotations

import numpy as np
import torch

from proofbench.reference import bounds
from proofbench.reference.mpt import verify

REF_BLOCK = 8192  # proofs the reference walks at once


class Batches:
    """The request set (a Population on the host) cut into `rotation`
    batches of `size` proofs, in the order the traffic drew."""

    def __init__(self, pop, size: int, rotation: int):
        if size * rotation > pop.size:
            raise ValueError(f"{rotation} batches of {size} need {size * rotation} proofs, "
                             f"the population has {pop.size}")
        self.pop, self.size, self.rotation = pop, size, rotation
        self._node_bytes = None
        self._ref = None

    def rows(self, b: int, depth_sorted: bool = False) -> np.ndarray:
        """The request set's rows of batch b; depth_sorted: deepest first
        (stable), as a caller orders a batch for depth segments."""
        rows = np.arange(b * self.size, (b + 1) * self.size)
        if depth_sorted:
            lens = self.pop.proof_lens.numpy()[rows]
            rows = rows[np.argsort(-lens, kind="stable")]
        return rows

    def entries(self, rows) -> list:
        """(root, proof nodes, key) of each row: bytes, as an RPC client
        hands them over."""
        pop = self.pop
        if self._node_bytes is None:
            nodes = pop.nodes.numpy()
            lens = pop.node_lens.numpy()
            self._node_bytes = [nodes[i, :lens[i]].tobytes() for i in range(nodes.shape[0])]
        nb = self._node_bytes
        root = bytes(pop.root.numpy())
        pn = pop.proof_nodes.numpy()
        pl = pop.proof_lens.numpy()
        keys = pop.keys.numpy()
        return [(root, [nb[k] for k in pn[r, :pl[r]]], keys[r].tobytes()) for r in rows]

    def depth_schedule(self, tile: int = 1024) -> tuple:
        """((count, d), ...): for each tile of a deepest-first batch, the
        deepest proof any batch puts there; equal neighbours merged."""
        pl = self.pop.proof_lens.numpy()
        deepest = None
        for b in range(self.rotation):
            lens = np.sort(pl[self.rows(b)])[::-1]
            per_tile = [int(lens[o:o + tile].max()) for o in range(0, len(lens), tile)]
            deepest = per_tile if deepest is None else list(map(max, deepest, per_tile))
        segs: list = []
        for o, d in zip(range(0, self.size, tile), deepest):
            cnt = min(tile, self.size - o)
            if segs and segs[-1][1] == d:
                segs[-1] = (segs[-1][0] + cnt, d)
            else:
                segs.append((cnt, d))
        return tuple(segs)

    def reference(self, device, max_value_len: int):
        """The reference's (status, values, value_lens) of every proof of
        the request set, numpy, walked in blocks on `device`."""
        if self._ref is not None:
            return self._ref
        pop = self.pop
        q = self.size * self.rotation
        out = []
        table, table_lens = pop.nodes.to(device), pop.node_lens.to(device)
        for o in range(0, q, REF_BLOCK):
            sl = slice(o, min(q, o + REF_BLOCK))
            pn = pop.proof_nodes[sl].to(device)
            ids = pn.clamp(min=0)
            n = pn.shape[0]
            res = verify(table[ids], torch.where(pn >= 0, table_lens[ids], 0),
                         pop.proof_lens[sl].to(device), pop.root.to(device).expand(n, 32),
                         pop.keys[sl].to(device), max_value_len)
            out.append([x.cpu().numpy() for x in res])
        del table, table_lens
        self._ref = tuple(np.concatenate(parts) for parts in zip(*out))
        return self._ref

    def unique_nodes(self, rows) -> torch.Tensor:
        """The distinct node ids the proofs of `rows` hold."""
        pn = self.pop.proof_nodes[torch.as_tensor(rows)]
        return torch.unique(pn[pn >= 0])

    def work(self, rows, key_nibbles: int, max_value_len: int, hint_pass: bool) -> dict:
        """The least ms of each kernel's share of verifying `rows` once: K1
        hashes their distinct nodes, K2 walks their proofs, K4 (hint_pass)
        decodes their distinct nodes' heads."""
        pop = self.pop
        ids = self.unique_nodes(rows)
        pn = pop.proof_nodes[torch.as_tensor(rows)]
        nl = torch.where(pn >= 0, pop.node_lens[pn.clamp(min=0)], 0)
        out = {"k1": bounds.keccak_bound(pop.node_lens[ids]),
               "k2": bounds.walk_bound(nl, pop.proof_lens[torch.as_tensor(rows)],
                                       key_nibbles, max_value_len, hinted=True)}
        if hint_pass:
            out["k4"] = bounds.hint_pass_bound(pop.nodes[ids], pop.node_lens[ids])
        return out


def compare(got, want) -> int:
    """Proofs whose status, value length or value bytes (up to the
    reference's length) differ: got and want are (status, values,
    value_lens) numpy, in the same row order."""
    gs, gv, gl = (np.asarray(x) for x in got)
    ws, wv, wl = want
    if gs.shape != ws.shape:
        return int(max(len(ws), len(gs)))
    mask = np.arange(wv.shape[1])[None, :] < wl[:, None]
    bad = (gs != ws) | (gl != wl)
    width = min(gv.shape[1], wv.shape[1])
    bad |= ((gv[:, :width] != wv[:, :width]) & mask[:, :width]).any(1)
    bad |= (wl > width)
    return int(bad.sum())


def keys_from_nibbles(key_nibbles: torch.Tensor) -> torch.Tensor:
    """u8 [B, 64] nibbles -> u8 [B, 32] key bytes."""
    k = key_nibbles.to(torch.int64)
    return ((k[:, 0::2] << 4) | k[:, 1::2]).to(torch.uint8)
