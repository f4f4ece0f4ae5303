"""Account proofs at mainnet depth, made from a seed (plain PyTorch).

`make_population` materialises P accounts of a virtual state trie of V
uniformly keyed accounts (Ethereum's state trie: key keccak(address), leaf
the Yellow Paper account [nonce, balance, storageRoot, codeHash]), the
nodes on their paths, and one proof per account against the one root:

- Depth. An account's branch nodes sit at nibble depths 0..L, its leaf at
  L + 1, so its proof has L + 2 nodes. L is drawn as its longest common key
  prefix with V - 1 other uniform keys, P(L >= j) = 1 - (1 - 16^-j)^(V-1),
  and is never less than its common prefix with the other sampled keys.
- Fan-out. A branch at depth j holds the children of the sampled keys
  under it and, in every other slot, a child with the chance that one of
  the (V - 1) 16^-(j+1) keys expected there exists: full branches (532 B)
  down to depth 5, about 10 children at 6, two or three below. A random 32-byte hash
  stands for each child off the sampled paths. A branch on a sampled path
  always has a second child (no extension nodes), so a proof is L + 1
  branches and a leaf.
- Leaf. Every account is an externally owned one, as most of mainnet's
  are: the empty storage root and code hash (a contract's own hashes have
  the same length, so the nodes and the work would be the same).
- Sharing. Paths that share a prefix share its nodes, as in the trie.

Then the request set: the P proofs in an order drawn from the seed, of
which an exact number carry a leaf with one byte of its code hash changed
(its parent's hash no longer matches: INVALID, found only at the leaf, so
walked to full depth like the rest). Every seed gives the same count.

Everything is made on the device it is given, in whole-tensor operations,
from one torch.Generator on that device; the Keccak is the reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..reference.keccak import keccak256_rows

FOUND, INVALID = 1, 3
EMPTY_ROOT = bytes.fromhex("56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421")
EMPTY_CODE = bytes.fromhex("c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")


@dataclass
class Population:
    """Materialised nodes and the request set's proofs, on one device.

    nodes u8 [M, W] and node_lens i64 [M]: every node (leaves, branches,
    tampered leaves); proof_nodes i64 [Q, D]: each proof's node ids, root
    first, -1 past its proof_lens i64 [Q]; keys u8 [Q, 32]: the key each
    proof is asked for; root u8 [32]; intent i64 [Q]: the status the proof
    was built to have; value_start, value_lens i64 [Q]: where the leaf's
    value (the account's RLP) lies in its leaf node (lens 0 unless FOUND)."""

    nodes: torch.Tensor
    node_lens: torch.Tensor
    proof_nodes: torch.Tensor
    proof_lens: torch.Tensor
    keys: torch.Tensor
    root: torch.Tensor
    intent: torch.Tensor
    value_start: torch.Tensor
    value_lens: torch.Tensor
    depth_hist: dict

    @property
    def size(self) -> int:
        return int(self.proof_lens.shape[0])


def depth_tail(j: int, virtual: int) -> float:
    """P(L >= j): the chance that one of virtual - 1 uniform keys shares
    the first j nibbles."""
    return -math.expm1((virtual - 1) * math.log1p(-16.0 ** -j)) if j > 0 else 1.0


def slot_chance(j: int, virtual: int) -> float:
    """The chance that a slot of a branch at depth j holds a child of the
    keys off the sampled paths."""
    return -math.expm1(-(virtual - 1) / 16.0 ** (j + 1))


class _Writer:
    """Variable-length rows written left to right, one cursor a row."""

    def __init__(self, n: int, width: int, dev):
        self.out = torch.zeros((n, width + 1), dtype=torch.uint8, device=dev)
        self.pos = torch.zeros(n, dtype=torch.int64, device=dev)
        self.width = width
        self.ar = torch.arange(n, device=dev)

    def byte(self, value, where=None):
        value = torch.as_tensor(value, device=self.out.device).to(torch.int64)
        value = value.expand(self.pos.shape)
        where = torch.ones_like(self.pos, dtype=torch.bool) if where is None else where
        at = torch.where(where, self.pos, self.width)
        self.out[self.ar, at] = torch.where(where, value, 0).to(torch.uint8)
        self.pos = self.pos + where.to(torch.int64)

    def span(self, src, count):
        """The first count[i] bytes of src[i] (u8 [N, S])."""
        s = src.shape[1]
        j = torch.arange(s, device=src.device)[None, :]
        at = torch.where(j < count[:, None], self.pos[:, None] + j, self.width)
        self.out.scatter_(1, at, src)
        self.out[:, self.width] = 0
        self.pos = self.pos + count

    def rows(self):
        return self.out[:, :self.width], self.pos


def _rand_bytes(shape, g, dev):
    return torch.randint(0, 256, shape, dtype=torch.uint8, generator=g, device=dev)


def _int_items(nbytes, g, dev):
    """Random unsigned integers of nbytes[i] bytes (top byte non-zero), as
    big-endian bytes u8 [N, 16] left-aligned, and their RLP item length."""
    n = nbytes.shape[0]
    raw = _rand_bytes((n, 16), g, dev)
    raw[:, 0] = torch.where(raw[:, 0] == 0, 1, raw[:, 0]).to(torch.uint8)
    single = (nbytes == 1) & (raw[:, 0] < 0x80)
    item_len = torch.where(nbytes == 0, 1, torch.where(single, 1, 1 + nbytes))
    return raw, single, item_len


def _write_int(w: _Writer, raw, nbytes, single):
    w.byte(0x80, nbytes == 0)
    w.byte(raw[:, 0], single)
    long_ = (nbytes > 0) & ~single
    w.byte(0x80 + nbytes, long_)
    w.span(raw, torch.where(long_, nbytes, 0))


def _leaves(nib, depth, width, g, dev):
    """The leaf node of each key: [hex-prefix path after depth + 1, the
    account's RLP]. Returns rows u8 [P, W], lens, value start, value lens."""
    p = nib.shape[0]
    nonce_n = torch.randint(0, 4, (p,), generator=g, device=dev)
    bal_n = torch.randint(0, 13, (p,), generator=g, device=dev)
    nonce, nonce_1, nonce_len = _int_items(nonce_n, g, dev)
    bal, bal_1, bal_len = _int_items(bal_n, g, dev)
    sroot = torch.tensor(list(EMPTY_ROOT), dtype=torch.uint8, device=dev).expand(p, 32)
    chash = torch.tensor(list(EMPTY_CODE), dtype=torch.uint8, device=dev).expand(p, 32)
    acct_payload = nonce_len + bal_len + 66
    acct_len = 2 + acct_payload            # 0xf8 <len>: the payload is 66..81
    rest = 63 - depth                      # path nibbles after the branch slot
    odd = rest % 2
    hp_len = rest // 2 + 1
    # the path's nibbles, padded so that pairs start at an even index
    j = torch.arange(64, device=dev)[None, :]
    src = (depth + 1 + odd)[:, None] + 2 * j[:, :32]
    hi = torch.gather(nib, 1, src.clamp(max=63))
    lo = torch.gather(nib, 1, (src + 1).clamp(max=63))
    pairs = ((hi << 4) | lo).to(torch.uint8)
    first = torch.where(odd == 1, 0x30 | nib[torch.arange(p, device=dev), depth + 1], 0x20)
    payload = 1 + hp_len + 2 + acct_len
    w = _Writer(p, width, dev)
    w.byte(0xF8)
    w.byte(payload)
    w.byte(0x80 + hp_len)
    w.byte(first)
    w.span(pairs, hp_len - 1)
    w.byte(0xB8)
    w.byte(acct_len)
    vstart = w.pos.clone()
    w.byte(0xF8)
    w.byte(acct_payload)
    _write_int(w, nonce, nonce_n, nonce_1)
    _write_int(w, bal, bal_n, bal_1)
    w.byte(0xA0)
    w.span(sroot, torch.full_like(w.pos, 32))
    w.byte(0xA0)
    w.span(chash, torch.full_like(w.pos, 32))
    rows, lens = w.rows()
    return rows, lens, vstart, acct_len


def _branches(occ, slot_hash, width):
    """Branch nodes from their occupied slots (bool [G, 16]) and the child
    hashes (u8 [G, 16, 32]); the value slot empty."""
    g_n = occ.shape[0]
    dev = occ.device
    c = occ.sum(1)
    payload = 32 * c + 17
    w = _Writer(g_n, width, dev)
    w.byte(0xF9, payload >= 256)
    w.byte(payload >> 8, payload >= 256)
    w.byte(0xF8, payload < 256)
    w.byte(payload & 0xFF)
    full32 = torch.full((g_n,), 32, dtype=torch.int64, device=dev)
    for s in range(16):
        on = occ[:, s]
        w.byte(torch.where(on, 0xA0, 0x80))
        w.span(slot_hash[:, s], torch.where(on, full32, 0))
    w.byte(0x80)
    return w.rows()


def _nibbles(keys):
    k = keys.to(torch.int64)
    return torch.stack([k >> 4, k & 15], dim=2).reshape(keys.shape[0], 64)


def _sorted_keys(accounts, max_depth, g, dev):
    """Uniform keys keccak(address), sorted, with each key's longest common
    prefix with the other sampled keys; keys whose prefix with another
    exceeds max_depth are drawn again."""
    addr = _rand_bytes((accounts, 20), g, dev)
    for _ in range(16):
        keys = keccak256_rows(addr, torch.full((accounts,), 20, device=dev))
        nib = _nibbles(keys)
        code = (nib[:, :15] << (4 * torch.arange(14, -1, -1, device=dev))).sum(1)
        order = torch.argsort(code)
        nib_s = nib[order]
        eq = (nib_s[1:, :16] == nib_s[:-1, :16]).to(torch.int64).cumprod(1).sum(1)
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        lcp = torch.maximum(torch.cat([zero, eq]), torch.cat([eq, zero]))
        bad = lcp > max_depth
        if not bool(bad.any()):
            return keys[order], nib_s, code[order], lcp
        redo = order[bad]
        addr[redo] = _rand_bytes((redo.shape[0], 20), g, dev)
    raise RuntimeError("could not draw keys within the depth cap")


def make_population(seed: int, accounts: int, virtual: int, max_nodes: int,
                    node_len: int, tampered: int, device="cpu") -> Population:
    """The accounts, their nodes and the request set (see the module)."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    cap = max_nodes - 2                    # the deepest branch a proof may hold
    keys, nib, code, lcp = _sorted_keys(accounts, cap, g, dev)
    p = accounts
    tail = torch.tensor([depth_tail(j, virtual) for j in range(1, cap + 1)],
                        dtype=torch.float64, device=dev)
    u = torch.rand(p, dtype=torch.float64, generator=g, device=dev)
    depth = torch.maximum((u[:, None] < tail[None, :]).sum(1), lcp)

    leaf_rows, leaf_lens, vstart, vlen = _leaves(nib, depth, node_len, g, dev)
    leaf_hash = keccak256_rows(leaf_rows, leaf_lens)

    rows, lens = [leaf_rows], [leaf_lens]
    base = p
    proof = torch.full((p, max_nodes), -1, dtype=torch.int64, device=dev)
    ar = torch.arange(p, device=dev)
    proof[ar, depth + 1] = ar
    below = torch.zeros((p, 32), dtype=torch.uint8, device=dev)
    for j in range(cap, -1, -1):
        act = torch.nonzero(depth >= j).squeeze(1)
        if act.numel() == 0:
            continue
        pj = code[act] >> (4 * (15 - j))
        gid = torch.cumsum(torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                                      (pj[1:] != pj[:-1]).to(torch.int64)]), 0)
        n_g = int(gid[-1]) + 1
        child = torch.where((depth[act] == j)[:, None], leaf_hash[act], below[act])
        occ = torch.rand((n_g, 16), generator=g, device=dev) < slot_chance(j, virtual)
        slot_hash = _rand_bytes((n_g, 16, 32), g, dev)
        c = nib[act, j]
        occ[gid, c] = False
        sampled = torch.zeros_like(occ)
        sampled[gid, c] = True
        occ |= sampled
        slot_hash[gid, c] = child
        # a branch holds at least two children
        need = occ.sum(1) < 2
        score = torch.rand((n_g, 16), generator=g, device=dev).masked_fill(occ, -1.0)
        occ[torch.arange(n_g, device=dev), score.argmax(1)] |= need
        b_rows, b_lens = _branches(occ, slot_hash, node_len)
        b_hash = keccak256_rows(b_rows, b_lens)
        below[act] = b_hash[gid]
        proof[act, j] = base + gid
        rows.append(b_rows)
        lens.append(b_lens)
        base += n_g
    root = below[0].clone()

    # the request set: an order from the seed, then the tampered leaves,
    # an exact count
    order = torch.randperm(p, generator=g, device=dev)
    keys = keys[order].clone()
    proof = proof[order]
    depth = depth[order]
    vstart, vlen = vstart[order], vlen[order]
    tamp = torch.randperm(p, generator=g, device=dev)[:tampered]
    intent = torch.full((p,), FOUND, dtype=torch.int64, device=dev)
    intent[tamp] = INVALID
    leaf_ids = proof[tamp, depth[tamp] + 1]
    t_rows = leaf_rows[leaf_ids].clone()
    t_lens = leaf_lens[leaf_ids]
    at = t_lens - 1 - torch.randint(0, 32, (tampered,), generator=g, device=dev)
    flip = torch.randint(1, 256, (tampered,), generator=g, device=dev).to(torch.uint8)
    t_rows[torch.arange(tampered, device=dev), at] ^= flip
    proof[tamp, depth[tamp] + 1] = base + torch.arange(tampered, device=dev)
    rows.append(t_rows)
    lens.append(t_lens)
    vlen = torch.where(intent == FOUND, vlen, 0)
    hist = {int(k): int(v) for k, v in zip(*np.unique((depth + 2).cpu().numpy(),
                                                      return_counts=True))}
    return Population(nodes=torch.cat(rows), node_lens=torch.cat(lens), proof_nodes=proof,
                      proof_lens=depth + 2, keys=keys, root=root, intent=intent,
                      value_start=vstart, value_lens=vlen, depth_hist=hist)
