"""One token's holder balances at ERC-20 scale, made from a seed (plain
PyTorch): a storage trie under the token's account, and one slot proof per
holder against it.

`make_storage_world` materialises H holder slots of a virtual storage trie
of V_s uniformly keyed slots, the nodes on their paths, and the token's
account path in a virtual state trie of V_a accounts:

- Keys. A holder's balance slot is keccak(pad32(holder) || pad32(p)), the
  slot of a Solidity mapping at position p, and its trie key keccak(slot):
  uniform.
- Depth and fan-out, as `_population.make_population` draws them
  (`depth_tail`, `slot_chance`) for V_s keys: at 2^24 slots, proofs of 7
  (37%), 8 (57%) and 9 (6%) nodes; branches full down to nibble depth 4,
  about 10 children at 5, two or three below; no extension nodes on the
  sampled paths; a drawn depth capped at `max_nodes - 2` branches.
- Leaf. [hex-prefix path, RLP(balance)] (the value `eth_getProof`
  returns), the balance big-endian without leading zeros, its bit length
  uniform over 1..56 and the bits below the top one uniform: 1-7 bytes. A
  leaf whose RLP is under 32 bytes (deep in the trie, with a balance under
  128) is inline, as in Ethereum's trie: its parent branch holds its bytes
  in the key's slot, and the proof ends at that branch.
- The token's account: RLP [1, 0, storage root, a random code hash] under
  keccak(a random address), at a depth drawn for V_a accounts (capped at
  `account_max_nodes - 2` branches), its branches drawn as the storage
  trie's.

Then the request set: the H slots in an order drawn from the seed, of
which an exact number of hashed leaves carry a value with one byte changed
(the parent's hash no longer matches: INVALID, found only at the leaf, so
walked to full depth like the rest). Every seed gives the same count.

Everything is made on the device it is given, in whole-tensor operations,
from one torch.Generator on that device; the Keccak is the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..reference.keccak import keccak256_rows
from ._population import (FOUND, INVALID, Population, _nibbles, _rand_bytes, _sorted_keys,
                          _Writer, depth_tail, slot_chance)

INLINE = 32  # a node whose RLP is shorter lies inside its parent
BALANCE_BITS = 56


@dataclass
class StorageWorld:
    """The token's two levels, on one device.

    slots: the slot level's nodes and request set (root: the storage root;
    keys: keccak(slot)); raw_slots u8 [Q, 32]: each request's slot, in the
    request set's order; inline bool [Q]: the slot's leaf lies inside its
    last branch; balances i64 [Q]: the balance each slot's leaf holds
    (before any tampering); account: the token's account proof (one; root:
    the state root, keys: keccak(address))."""

    slots: Population
    raw_slots: torch.Tensor
    inline: torch.Tensor
    balances: torch.Tensor
    account: Population

    def to(self, device) -> "StorageWorld":
        """The same world on `device`."""
        def moved(obj):
            return type(obj)(**{k: (v.to(device) if isinstance(v, torch.Tensor) else v)
                                for k, v in vars(obj).items()})

        return StorageWorld(slots=moved(self.slots), raw_slots=self.raw_slots.to(device),
                            inline=self.inline.to(device), balances=self.balances.to(device),
                            account=moved(self.account))


def _hp_path(nib, depth):
    """Hex-prefix leaf paths of the nibbles after depth + 1: (first byte
    i64 [P], the rest's bytes u8 [P, 32] of which hp_len - 1 count,
    hp_len i64 [P])."""
    p = nib.shape[0]
    dev = nib.device
    rest = 63 - depth
    odd = rest % 2
    hp_len = rest // 2 + 1
    j = torch.arange(32, device=dev)[None, :]
    src = (depth + 1 + odd)[:, None] + 2 * j
    hi = torch.gather(nib, 1, src.clamp(max=63))
    lo = torch.gather(nib, 1, (src + 1).clamp(max=63))
    pairs = ((hi << 4) | lo).to(torch.uint8)
    first = torch.where(odd == 1, 0x30 | nib[torch.arange(p, device=dev), depth + 1], 0x20)
    return first, pairs, hp_len


def _balance_leaves(nib, depth, width, g, dev):
    """Each key's leaf [hp path, RLP(balance)]: rows u8 [P, W], lens, the
    value's (RLP(balance)'s) start and length in its row, the balances."""
    p = nib.shape[0]
    bits = torch.randint(1, BALANCE_BITS + 1, (p,), generator=g, device=dev)
    low = torch.randint(0, 1 << 62, (p,), generator=g, device=dev)
    top = torch.bitwise_left_shift(torch.ones_like(bits), bits - 1)
    bal = top | (low & (top - 1))
    nbytes = (bits + 7) // 8
    k = torch.arange(8, device=dev)[None, :]
    shift = (8 * (nbytes[:, None] - 1 - k)).clamp(min=0)
    raw = (torch.bitwise_right_shift(bal[:, None], shift) & 0xFF).to(torch.uint8)
    single = bal < 0x80                       # RLP(balance) is the byte itself
    rlp_len = torch.where(single, 1, 1 + nbytes)
    item_len = torch.where(single, 1, 1 + rlp_len)
    first, pairs, hp_len = _hp_path(nib, depth)
    w = _Writer(p, width, dev)
    w.byte(0xC0 + 1 + hp_len + item_len)     # the payload is at most 42 bytes
    w.byte(0x80 + hp_len)
    w.byte(first)
    w.span(pairs, hp_len - 1)
    w.byte(0x80 + rlp_len, ~single)
    vstart = w.pos.clone()
    w.byte(bal, single)
    w.byte(0x80 + nbytes, ~single)
    w.span(raw, torch.where(single, 0, nbytes))
    rows, lens = w.rows()
    return rows, lens, vstart, rlp_len, bal


def _contract_leaf(nib, depth, storage_root, code_hash, width):
    """The token's account leaf [hp path, RLP([1, 0, storage_root,
    code_hash])]: row u8 [1, W], len, the value's start and length."""
    dev = nib.device
    one = torch.ones(1, dtype=torch.int64, device=dev)
    acct = torch.cat([torch.tensor([0xF8, 0x44, 0x01, 0x80, 0xA0], dtype=torch.uint8,
                                   device=dev), storage_root,
                      torch.tensor([0xA0], dtype=torch.uint8, device=dev), code_hash[0]])
    first, pairs, hp_len = _hp_path(nib, depth)
    w = _Writer(1, width, dev)
    w.byte(0xF8)
    w.byte(1 + hp_len + 2 + acct.numel())
    w.byte(0x80 + hp_len)
    w.byte(first)
    w.span(pairs, hp_len - 1)
    w.byte(0xB8)
    w.byte(acct.numel())
    vstart = w.pos.clone()
    w.span(acct[None], one * acct.numel())
    rows, lens = w.rows()
    return rows, lens, vstart, one * acct.numel()


def _branch_rows(occ, ref, ref_len, width):
    """Branch nodes from their occupied slots (bool [G, 16]) and each
    slot's child reference, the first ref_len [G, 16] bytes of ref u8
    [G, 16, 33]: 0xa0 and a 32-byte hash, or an inline node's own bytes;
    the value slot empty. A branch holds at least two children, so its
    payload is at least 56 bytes."""
    g_n = occ.shape[0]
    payload = torch.where(occ, ref_len, 1).sum(1) + 1
    w = _Writer(g_n, width, occ.device)
    w.byte(0xF9, payload >= 256)
    w.byte(payload >> 8, payload >= 256)
    w.byte(0xF8, payload < 256)
    w.byte(payload & 0xFF)
    for s in range(16):
        on = occ[:, s]
        w.byte(0x80, ~on)
        w.span(ref[:, s], torch.where(on, ref_len[:, s], 0))
    w.byte(0x80)
    return w.rows()


def _hash_ref(digests):
    """0xa0 and each digest: u8 [N, 33], a hashed child's reference."""
    head = torch.full((digests.shape[0], 1), 0xA0, dtype=torch.uint8, device=digests.device)
    return torch.cat([head, digests], 1)


def _trie(nib, code, depth, leaf_rows, leaf_lens, cap, virtual, width, g):
    """The branches on the paths of sorted keys whose leaves hang at
    nibble depth + 1 (see the module). Returns the node rows and lengths
    (the leaves, then the branches, level by level up), each key's proof
    node ids i64 [P, cap + 2] (root first, -1 past its end), its proof
    length and the root u8 [32]."""
    dev = nib.device
    p = nib.shape[0]
    inline = leaf_lens < INLINE
    ref = torch.where(inline[:, None], leaf_rows[:, :33],
                      _hash_ref(keccak256_rows(leaf_rows, leaf_lens)))
    ref_len = torch.where(inline, leaf_lens, 33)
    rows, lens = [leaf_rows], [leaf_lens]
    base = p
    proof = torch.full((p, cap + 2), -1, dtype=torch.int64, device=dev)
    hashed = torch.nonzero(~inline).squeeze(1)
    proof[hashed, depth[hashed] + 1] = hashed
    below = torch.zeros((p, 33), dtype=torch.uint8, device=dev)
    for j in range(cap, -1, -1):
        act = torch.nonzero(depth >= j).squeeze(1)
        if act.numel() == 0:
            continue
        pj = code[act] >> (4 * (15 - j))
        gid = torch.cumsum(torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                                      (pj[1:] != pj[:-1]).to(torch.int64)]), 0)
        n_g = int(gid[-1]) + 1
        here = depth[act] == j
        child = torch.where(here[:, None], ref[act], below[act])
        child_len = torch.where(here, ref_len[act], 33)
        occ = torch.rand((n_g, 16), generator=g, device=dev) < slot_chance(j, virtual)
        slot_ref = _hash_ref(_rand_bytes((n_g * 16, 32), g, dev)).view(n_g, 16, 33)
        slot_len = torch.full((n_g, 16), 33, dtype=torch.int64, device=dev)
        c = nib[act, j]
        occ[gid, c] = False
        sampled = torch.zeros_like(occ)
        sampled[gid, c] = True
        occ |= sampled
        slot_ref[gid, c] = child
        slot_len[gid, c] = child_len
        # a branch holds at least two children
        need = occ.sum(1) < 2
        score = torch.rand((n_g, 16), generator=g, device=dev).masked_fill(occ, -1.0)
        occ[torch.arange(n_g, device=dev), score.argmax(1)] |= need
        b_rows, b_lens = _branch_rows(occ, slot_ref, slot_len, width)
        below[act] = _hash_ref(keccak256_rows(b_rows, b_lens))[gid]
        proof[act, j] = base + gid
        rows.append(b_rows)
        lens.append(b_lens)
        base += n_g
    return rows, lens, proof, depth + 2 - inline.to(torch.int64), below[0, 1:].clone()


def _sorted_slot_keys(holders, max_depth, position, g, dev):
    """Balance slots of random holders and their trie keys keccak(slot),
    sorted by key, with each key's longest common prefix with the other
    sampled keys; holders whose key shares more than max_depth nibbles with
    another are drawn again. Returns (slots, keys, nibbles, the first 15
    nibbles packed, prefix lengths)."""
    pre = torch.zeros((holders, 64), dtype=torch.uint8, device=dev)
    pre[:, 12:32] = _rand_bytes((holders, 20), g, dev)
    pre[:, 56:] = torch.tensor(list(int(position).to_bytes(8, "big")), dtype=torch.uint8,
                               device=dev)
    for _ in range(16):
        slots = keccak256_rows(pre, torch.full((holders,), 64, device=dev))
        keys = keccak256_rows(slots, torch.full((holders,), 32, device=dev))
        nib = _nibbles(keys)
        code = (nib[:, :15] << (4 * torch.arange(14, -1, -1, device=dev))).sum(1)
        order = torch.argsort(code)
        nib_s = nib[order]
        eq = (nib_s[1:, :16] == nib_s[:-1, :16]).to(torch.int64).cumprod(1).sum(1)
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        lcp = torch.maximum(torch.cat([zero, eq]), torch.cat([eq, zero]))
        bad = lcp > max_depth
        if not bool(bad.any()):
            return slots[order], keys[order], nib_s, code[order], lcp
        redo = order[bad]
        pre[redo, 12:32] = _rand_bytes((redo.shape[0], 20), g, dev)
    raise RuntimeError("could not draw holders within the depth cap")


def _depths(u, lcp, cap, virtual):
    tail = torch.tensor([depth_tail(j, virtual) for j in range(1, cap + 1)],
                        dtype=torch.float64, device=u.device)
    return torch.maximum((u[:, None] < tail[None, :]).sum(1), lcp)


def _hist(lens):
    return {int(k): int(v) for k, v in zip(*np.unique(lens.cpu().numpy(), return_counts=True))}


def make_storage_world(seed: int, holders: int, virtual_slots: int, max_nodes: int,
                       virtual_accounts: int, account_max_nodes: int, node_len: int,
                       position: int, tampered: int, device="cpu") -> StorageWorld:
    """The token's storage trie, its account path and the request set (see
    the module)."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    cap = max_nodes - 2
    raw, keys, nib, code, lcp = _sorted_slot_keys(holders, cap, position, g, dev)
    depth = _depths(torch.rand(holders, dtype=torch.float64, generator=g, device=dev), lcp,
                    cap, virtual_slots)
    leaf_rows, leaf_lens, vstart, vlen, bal = _balance_leaves(nib, depth, node_len, g, dev)
    rows, lens, proof, plen, storage_root = _trie(nib, code, depth, leaf_rows, leaf_lens, cap,
                                                  virtual_slots, node_len, g)
    inline = leaf_lens < INLINE

    # the token's account, committing to the storage root
    a_cap = account_max_nodes - 2
    a_keys, a_nib, a_code, a_lcp = _sorted_keys(1, a_cap, g, dev)
    a_depth = _depths(torch.rand(1, dtype=torch.float64, generator=g, device=dev), a_lcp,
                      a_cap, virtual_accounts)
    a_leaf, a_leaf_len, a_vstart, a_vlen = _contract_leaf(
        a_nib, a_depth, storage_root, _rand_bytes((1, 32), g, dev), node_len)
    a_rows, a_lens, a_proof, a_plen, state_root = _trie(a_nib, a_code, a_depth, a_leaf,
                                                        a_leaf_len, a_cap, virtual_accounts,
                                                        node_len, g)

    # the request set: an order from the seed, then the tampered leaves
    # among the hashed ones, an exact count
    order = torch.randperm(holders, generator=g, device=dev)
    raw, keys, proof, plen = raw[order], keys[order], proof[order], plen[order]
    inline, vstart, vlen, bal = inline[order], vstart[order], vlen[order], bal[order]
    leaf = order  # each request's leaf row
    hashed = torch.nonzero(~inline).squeeze(1)
    if tampered > hashed.numel():
        raise ValueError(f"{tampered} tampered leaves asked, {hashed.numel()} are hashed")
    tamp = hashed[torch.randperm(hashed.numel(), generator=g, device=dev)[:tampered]]
    intent = torch.full((holders,), FOUND, dtype=torch.int64, device=dev)
    intent[tamp] = INVALID
    t_rows = leaf_rows[leaf[tamp]].clone()
    pick = (torch.rand(tampered, generator=g, device=dev) * vlen[tamp]).to(torch.int64)
    flip = torch.randint(1, 256, (tampered,), generator=g, device=dev).to(torch.uint8)
    t_rows[torch.arange(tampered, device=dev), vstart[tamp] + pick] ^= flip
    proof[tamp, plen[tamp] - 1] = sum(r.shape[0] for r in rows) + torch.arange(tampered,
                                                                               device=dev)
    rows.append(t_rows)
    lens.append(leaf_lens[leaf[tamp]])
    slots = Population(nodes=torch.cat(rows), node_lens=torch.cat(lens), proof_nodes=proof,
                       proof_lens=plen, keys=keys.clone(), root=storage_root, intent=intent,
                       value_start=vstart, value_lens=torch.where(intent == FOUND, vlen, 0),
                       depth_hist=_hist(plen))
    account = Population(nodes=torch.cat(a_rows), node_lens=torch.cat(a_lens),
                         proof_nodes=a_proof, proof_lens=a_plen, keys=a_keys, root=state_root,
                         intent=torch.full((1,), FOUND, dtype=torch.int64, device=dev),
                         value_start=a_vstart, value_lens=a_vlen, depth_hist=_hist(a_plen))
    return StorageWorld(slots=slots, raw_slots=raw.clone(), inline=inline, balances=bal,
                        account=account)
