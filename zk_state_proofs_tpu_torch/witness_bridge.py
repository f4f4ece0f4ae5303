"""PackedProofs -> torch tensors, with the JAX arrays' dtypes and layouts,
and the witness recipes the port is driven with (the headline accounts,
the grouped-storage world, the transaction-trie geometry batch, config
4's mixed batch, config 5's sweep world and config 6's distinct world).

The port's state is the packed witness. `packed_to_tensors` moves the numpy
arrays of a `witness.PackedProofs` onto `device` without changing dtype or
shape; the port's packer gives the same arrays as the JAX package's, so both
packages compute on the same bytes.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np
import torch

from . import native
from .oracle import EthTrie, keccak256, rlp
from .utils.device import resolve_device
from .witness.builders import build_transaction_trie, get_all_transaction_proof_inputs
from .witness.encoding import encode_transaction
from .witness.fixtures import synthetic_block
from .witness.pack import PackedProofs, pack_proofs


def _t(a, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def packed_to_tensors(packed: PackedProofs, device, pool: bool = True,
                      hints: bool = True) -> dict:
    """Tensors of a packed batch on `device`:
      nodes u8 [B, D, N], node_lens i32 [B, D], num_nodes i32 [B],
      roots u8 [B, 32], key_nibbles u8 [B, K], key_lens i32 [B]
    and with pool=True also pool_nodes u8 [U, N], pool_lens i32 [U],
    pool_idx i32 [B, D] (packed.pool()) and, unless hints=False,
    pool_hints u8 [U, 36] (packed.pool_hints())."""
    dev = resolve_device(device)
    out = {
        "nodes": _t(packed.nodes, np.uint8, dev),
        "node_lens": _t(packed.node_lens, np.int32, dev),
        "num_nodes": _t(packed.num_nodes, np.int32, dev),
        "roots": _t(packed.roots, np.uint8, dev),
        "key_nibbles": _t(packed.key_nibbles, np.uint8, dev),
        "key_lens": _t(packed.key_lens, np.int32, dev),
    }
    if pool:
        pn, pl, pi = packed.pool()
        out["pool_nodes"] = _t(pn, np.uint8, dev)
        out["pool_lens"] = _t(pl, np.int32, dev)
        out["pool_idx"] = _t(pi, np.int32, dev)
        if hints:
            out["pool_hints"] = _t(packed.pool_hints(), np.uint8, dev)
    return out


BATCH_FIELDS = ("nodes", "node_lens", "num_nodes", "roots", "key_nibbles",
                "key_lens")
POOL_FIELDS = ("pool_nodes", "pool_lens", "pool_idx")


def account_entries(n_accounts: int, hasher=None):
    """(entries, leaves): (root, proof, key) entries for every account of an
    n_accounts-account oracle trie, depth-sorted (deepest first), and the
    leaf value of each key — the headline witness recipe
    of the JAX package's bench.py (`build_witness_batch`): key =
    keccak("bench-account-%d"), leaf = RLP [nonce, balance, storage_root,
    code_hash]. `hasher` defaults to the native keccak when it loads, the
    oracle's otherwise (bit-identical, slower)."""
    hasher = hasher or default_hasher()
    t = EthTrie(hasher=hasher)
    leaves = {}
    for i in range(n_accounts):
        k = hasher(b"bench-account-%d" % i)
        leaves[k] = rlp.encode([rlp.int_to_min_bytes(i),
                                rlp.int_to_min_bytes(10**18 + i),
                                hasher(b"sroot%d" % i), hasher(b"code%d" % i)])
        t.insert(k, leaves[k])
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in leaves]
    entries.sort(key=lambda e: -len(e[1]))
    return entries, leaves


def default_hasher():
    """The native keccak when the host library loads, the oracle's
    otherwise (bit-identical, slower)."""
    return native.keccak256 if native.available() else keccak256


def _bucket_len(entries) -> int:
    """node_len of a witness batch: its largest node + 4, rounded up to 4."""
    return -(-(max(len(n) for _, p, _ in entries for n in p) + 4) // 4) * 4


@dataclass
class StorageWorld:
    """A two-level witness: A account proofs against one state root, and B
    slot proofs, each against its account's storage root."""

    account_entries: list    # A (state_root, proof, keccak(address))
    storage_entries: list    # B (storage_root, proof, keccak(slot))
    slots: np.ndarray        # u8 [B, 32] raw slot keys
    slot_accounts: np.ndarray  # i32 [B] owning account row of each slot
    slot_values: list        # B oracle values (the RLP-encoded slot value)
    account_leaves: list     # A oracle account leaves

    def pack(self):
        """(account PackedProofs, storage PackedProofs), each at node_len =
        its largest node + 4, rounded up to 4."""
        return (pack_proofs(self.account_entries,
                            node_len=_bucket_len(self.account_entries)),
                pack_proofs(self.storage_entries,
                            node_len=_bucket_len(self.storage_entries)))


def storage_world(n_accounts: int = 512, slots_per: int = 8,
                  slots_in_trie: int = 256, hasher=None) -> StorageWorld:
    """The grouped-storage witness of the JAX package's bench_configs.py
    (`_grouped_storage_batch`; quick=False is 512 x 8 x 256).

    Account a owns a storage trie of `slots_in_trie` slots: raw slot i is
    a.to_bytes(16) + i.to_bytes(16), its trie key keccak(raw slot), its
    value rlp.encode_int((a << 20) + i + 1). Every (slots_in_trie //
    slots_per)-th slot is proven, `slots_per` per account. The account
    trie holds keccak("gs-acct-%d") -> RLP [a + 1, 10**18 + a,
    storage_root, keccak("code%d")]."""
    nk = hasher or default_hasher()
    world = EthTrie(hasher=nk)
    sroots, s_entries, slots, slot_accounts, values = [], [], [], [], []
    for a in range(n_accounts):
        st = EthTrie(hasher=nk)
        raw = [a.to_bytes(16, "big") + i.to_bytes(16, "big")
               for i in range(slots_in_trie)]
        vals = [rlp.encode_int((a << 20) + i + 1) for i in range(slots_in_trie)]
        for rs, v in zip(raw, vals):
            st.insert(nk(rs), v)
        sroot = st.root_hash()
        sroots.append(sroot)
        step = slots_in_trie // slots_per
        for i in range(0, slots_in_trie, step)[:slots_per]:
            s_entries.append((sroot, st.get_proof(nk(raw[i])), nk(raw[i])))
            slots.append(raw[i])
            slot_accounts.append(a)
            values.append(vals[i])
    addr_keys = [nk(b"gs-acct-%d" % a) for a in range(n_accounts)]
    leaves = [rlp.encode([rlp.int_to_min_bytes(a + 1),
                          rlp.int_to_min_bytes(10**18 + a), sroots[a],
                          nk(b"code%d" % a)]) for a in range(n_accounts)]
    for k, leaf in zip(addr_keys, leaves):
        world.insert(k, leaf)
    wroot = world.root_hash()
    return StorageWorld(
        account_entries=[(wroot, world.get_proof(k), k) for k in addr_keys],
        storage_entries=s_entries,
        slots=np.frombuffer(b"".join(slots), np.uint8).reshape(len(slots), 32).copy(),
        slot_accounts=np.asarray(slot_accounts, np.int32),
        slot_values=values,
        account_leaves=leaves,
    )


def tx_geometry_block(n_txs: int = 256, seed: int = 11) -> dict:
    """The transaction-trie block of the JAX package's bench_configs.py
    (`_tx_geometry_batch`, :79-98; quick=False is 256 txs): EIP-1559
    transactions with 1400-1960 B of random calldata, so the leaf nodes
    are about 2 KB. Returns {"transactions": [...], "transactionsRoot":
    hex}, the block dict of `models.verify_block_transactions`."""
    rng = random.Random(seed)
    txs = []
    for i in range(n_txs):
        data = bytes(rng.randrange(256) for _ in range(rng.randrange(1400, 1960)))
        txs.append({
            "type": "0x2", "chainId": "0x1", "nonce": hex(i),
            "maxPriorityFeePerGas": "0x3b9aca00",
            "maxFeePerGas": "0x2540be400", "gas": "0x7a120",
            "to": "0x" + "%040x" % rng.getrandbits(160),
            "value": hex(rng.getrandbits(48)),
            "input": "0x" + data.hex(), "accessList": [],
            "yParity": hex(i & 1),
            "r": "0x" + "%064x" % rng.getrandbits(255),
            "s": "0x" + "%064x" % rng.getrandbits(255),
        })
    root = build_transaction_trie(txs).root_hash()
    return {"transactions": txs, "transactionsRoot": "0x" + root.hex()}


@dataclass
class TxGeometryBatch:
    """A pooled batch at transaction-trie geometry and how to verify it."""

    packed: PackedProofs
    values: list         # the expected value of each proof: its encoded tx
    max_value_len: int   # the longest encoded tx, rounded up to 128
    max_steps: int       # the node axis + 2


def tx_geometry_batch(block: dict, total: int = 4096) -> TxGeometryBatch:
    """The batch recipe of bench_configs.py `_tx_geometry_batch` (:99-122)
    over a `tx_geometry_block`: `total` proofs, proof i of tx i % n_txs,
    packed at node_len = the largest node + 4, rounded up to 4; values
    read back at full width."""
    txs = block["transactions"]
    inputs = get_all_transaction_proof_inputs(block)
    entries = [inputs[i % len(inputs)].as_entry() for i in range(total)]
    packed = pack_proofs(entries, node_len=_bucket_len(entries))
    encoded = [encode_transaction(tx) for tx in txs]
    return TxGeometryBatch(
        packed=packed, values=[encoded[i % len(txs)] for i in range(total)],
        max_value_len=-(-max(len(e) for e in encoded) // 128) * 128,
        max_steps=packed.nodes.shape[1] + 2)


def mixed_batch(total: int = 4096):
    """BASELINE config 4's witness (bench_configs.py `config4_mixed_batch`,
    quick=False is 4096): a third of `total` account proofs over a
    256-account trie (key keccak(b"a%d"), leaf RLP [1, 2, keccak(b"s"),
    keccak(b"c")]), a third storage proofs over a 256-slot trie (key
    keccak(keccak(b"slot%d")), value encode_int(i + 1)), the rest
    transaction proofs of synthetic_block(num_txs=32, seed=4) (those of
    get_transaction_proof_input), each part cycling over its keys; packed
    at node_len = the largest node + 4, so byte N - 1 is padding in every
    row. No pack-time hints, no segment schedules. Returns (entries,
    PackedProofs)."""
    nk = default_hasher()
    third = total // 3
    t = EthTrie(hasher=nk)
    for i in range(256):
        t.insert(nk(b"a%d" % i), rlp.encode([b"\x01", b"\x02", nk(b"s"), nk(b"c")]))
    root = t.root_hash()
    entries = []
    for i in range(third):
        k = nk(b"a%d" % (i % 256))
        entries.append((root, t.get_proof(k), k))
    st = EthTrie(hasher=nk)
    for i in range(256):
        st.insert(nk(nk(b"slot%d" % i)), rlp.encode_int(i + 1))
    sroot = st.root_hash()
    for i in range(third):
        k = nk(nk(b"slot%d" % (i % 256)))
        entries.append((sroot, st.get_proof(k), k))
    # the proofs of get_transaction_proof_input(block, i), from one trie build
    tx_inputs = get_all_transaction_proof_inputs(synthetic_block(num_txs=32, seed=4)["block"])
    while len(entries) < total:
        entries.append(tx_inputs[len(entries) % 32].as_entry())
    max_node = max(len(n) for _, p, _ in entries for n in p)
    return entries, pack_proofs(entries, node_len=max_node + 4)


@dataclass
class SweepWorld:
    """BASELINE config 5's and config 6's witness set: every account of one
    state trie with its proof (bench_configs.py
    `config5_sweep_with_root_reduction`, `config6_distinct_1m`)."""

    trie: EthTrie  # the state trie (proofs of absent keys too)
    root: bytes
    keys: list     # keccak(prefix % i)
    proofs: list   # proof of keys[i]
    leaves: list   # the leaf of keys[i]
    max_nodes: int  # the longest proof
    node_len: int = 576

    @property
    def n_accounts(self) -> int:
        return len(self.keys)

    def entries(self, rows) -> list:
        """(root, proof, key) of each account row in `rows`."""
        return [(self.root, self.proofs[i], self.keys[i]) for i in rows]

    def depth_order(self) -> list:
        """Account rows deepest proof first (bench_configs.py:597-599)."""
        return sorted(range(self.n_accounts), key=lambda i: -len(self.proofs[i]))

    def pack(self) -> PackedProofs:
        """The global witness of the resident sweeps: every account in
        depth order, at (max_nodes, node_len)."""
        return pack_proofs(self.entries(self.depth_order()), max_nodes=self.max_nodes,
                           node_len=self.node_len)

    def index_batches(self, n: int, batch: int, rng: np.random.Generator):
        """n batches of `batch` distinct rows of the global witness (i32),
        walking a random permutation and drawing a fresh one when it runs
        out (bench_configs.py `index_batches`)."""
        order, pos = rng.permutation(self.n_accounts), 0
        for _ in range(n):
            if pos + batch > self.n_accounts:
                order, pos = rng.permutation(self.n_accounts), 0
            yield order[pos:pos + batch].astype(np.int32)
            pos += batch

    def entry_batches(self, n: int, batch: int, rng: np.random.Generator):
        """index_batches as lists of raw entries (for sweep_entries); the
        indices are account rows."""
        for idx in self.index_batches(n, batch, rng):
            yield self.entries(idx)


def sweep_world(n_accounts: int = 65536, hasher=None,
                prefix: bytes = b"sweep-acct-%d") -> SweepWorld:
    """Config 5's recipe (bench_configs.py:541-552): account i under key
    keccak(prefix % i) with leaf RLP [i + 1, 10**18 + i, keccak(b"sr%d" %
    i), keccak(b"ch%d" % i)], hashed with `hasher` (the native keccak by
    default)."""
    nk = hasher or default_hasher()
    trie = EthTrie(hasher=nk)
    keys = [nk(prefix % i) for i in range(n_accounts)]
    leaves = [rlp.encode([rlp.int_to_min_bytes(i + 1), rlp.int_to_min_bytes(10**18 + i),
                          nk(b"sr%d" % i), nk(b"ch%d" % i)]) for i in range(n_accounts)]
    for k, leaf in zip(keys, leaves):
        trie.insert(k, leaf)
    proofs = [trie.get_proof(k) for k in keys]
    return SweepWorld(trie=trie, root=trie.root_hash(), keys=keys, proofs=proofs, leaves=leaves,
                      max_nodes=max(len(p) for p in proofs))


def distinct_world(n_accounts: int = 1 << 20) -> SweepWorld:
    """Config 6's recipe (bench_configs.py:687-705): config 5's with keys
    keccak(b"m-acct-%d" % i), 2^20 fully distinct accounts by default.
    Its witness is `pack()` (longest proof first, at node_len 576);
    `leaves[depth_order()[r]]` is the value of row r."""
    return sweep_world(n_accounts, prefix=b"m-acct-%d")
