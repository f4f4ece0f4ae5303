"""Verification workloads (port of `zk_state_proofs_tpu.models.verifier`):
merkle and account batches, and the two-level account -> storage
verification (the reference's storage circuit,
storage-circuit/src/main.rs:6-31).

Every entry point takes a `device`, "cuda" unless the caller names
another: "cuda" runs kernels K1 and K2 (`hinted` and `bounded`, with the
`exact` re-run) and raises without a card; "cpu" runs their plain
versions. Results come back as numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..oracle.trie import MissingKeyError, TrieError
from ..ops import mpt
from ..ops.account import decode_account
from ..ops.keccak_cuda import keccak256_cuda
from ..ops.rlp import bytes_to_nibbles_device
from ..utils.device import resolve_device
from ..utils.profiling import span
from ..witness.pack import PackedProofs, pack_proofs
from ..witness_bridge import BATCH_FIELDS, POOL_FIELDS, packed_to_tensors


@dataclass
class VerifyResult:
    """Per-proof outcome of a batched verification (numpy)."""

    status: np.ndarray      # i32 [B]: mpt.FOUND / EXCLUDED / INVALID
    values: np.ndarray      # u8  [B, V]
    value_lens: np.ndarray  # i32 [B]
    reasons: np.ndarray | None = None  # i32 [B] (diagnose_batch only)

    def value(self, i: int) -> bytes:
        return bytes(self.values[i][: self.value_lens[i]])

    @property
    def all_found(self) -> bool:
        return bool((self.status == mpt.FOUND).all())

    def counts(self) -> dict:
        s = self.status
        out = {
            "found": int((s == mpt.FOUND).sum()),
            "excluded": int((s == mpt.EXCLUDED).sum()),
            "invalid": int((s == mpt.INVALID).sum()),
        }
        if self.reasons is not None:
            for code, name in mpt.REASON_NAMES.items():
                if code == mpt.R_NONE:
                    continue
                n = int((self.reasons == code).sum())
                if n:
                    out[f"invalid_{name}"] = n
        return out


def _np(*ts):
    return tuple(t.cpu().numpy() for t in ts)


def _verify(packed: PackedProofs, max_value_len: int, dedup: bool, device):
    t = packed_to_tensors(packed, device, pool=dedup)
    batch = [t[k] for k in BATCH_FIELDS]
    if dedup:
        return mpt.verify_proofs_pooled(*batch, *(t[k] for k in POOL_FIELDS),
                                        t["pool_hints"],
                                        max_value_len=max_value_len)
    return mpt.verify_proofs(*batch, max_value_len=max_value_len)


def verify_merkle_batch(packed: PackedProofs, max_value_len: int = 128,
                        dedup: bool = True, device="cuda") -> VerifyResult:
    """Verify a batch of packed MPT proofs on `device`. dedup=True hashes
    each unique node once (the pooled path, with pack-time hints)."""
    return VerifyResult(*_np(*_verify(packed, max_value_len, dedup, device)))


def diagnose_batch(packed: PackedProofs, max_value_len: int = 128,
                   device="cuda") -> VerifyResult:
    """verify_merkle_batch plus per-proof INVALID reason codes
    (mpt.REASON_NAMES)."""
    t = packed_to_tensors(packed, device, pool=False)
    out = mpt.verify_proofs_diagnose(*(t[k] for k in BATCH_FIELDS),
                                     max_value_len=max_value_len)
    status, values, vlens, reasons = _np(*out)
    return VerifyResult(status, values, vlens, reasons=reasons)


def verify_merkle_proof(root: bytes, proof: list, key: bytes,
                        device="cuda") -> bytes:
    """Single-proof API: returns the value; raises MissingKeyError for a
    proven-absent key, TrieError for an invalid proof."""
    packed = pack_proofs([(root, proof, key)])
    res = verify_merkle_batch(packed, max_value_len=max(packed.nodes.shape[2], 128),
                              device=device)
    if res.status[0] == mpt.FOUND:
        return res.value(0)
    if res.status[0] == mpt.EXCLUDED:
        raise MissingKeyError("Key does not exist!")
    raise TrieError("invalid merkle proof")


def verify_account_batch(packed: PackedProofs, dedup: bool = True, device="cuda"):
    """Verify + decode the account leaf. Returns (VerifyResult, dict of
    decoded numpy account fields)."""
    status, values, vlens = _verify(packed, 128, dedup, device)
    acct = decode_account(values, vlens)
    res = VerifyResult(*_np(status, values, vlens))
    return res, {k: v.cpu().numpy() for k, v in acct.items()}


def batch_commitment(result: VerifyResult) -> bytes:
    """keccak over the (status || len || value) stream of a result: two
    runs agree iff every per-proof outcome and value agree bit-exactly."""
    stream = bytearray()
    for i in range(len(result.status)):
        stream += bytes([int(result.status[i])])
        v = result.value(i)
        stream += len(v).to_bytes(4, "little") + v
    return native.keccak256(bytes(stream))  # the oracle's keccak without the library


def _slot_key_nibbles(slots):
    """Level-2 keys on the device: keccak of each raw slot (kernel K1 on
    the card), nibble-expanded. slots u8 [B, W]; a slot row wider than 32
    bytes hashes its first 32 (the length is 32 either way), so padding
    bytes past 32 never change a key. Returns (key nibbles u8 [B, 64], key
    lengths i32 [B])."""
    b = slots.shape[0]
    lens = torch.full((b,), 32, dtype=torch.int32, device=slots.device)
    knib = bytes_to_nibbles_device(keccak256_cuda(slots, lens))
    return knib, torch.full((b,), 64, dtype=torch.int32, device=slots.device)


def _storage_core(a_batch, s_nodes, s_lens, s_num, slots):
    """Two-level verification, unpooled 1:1 form (slot j under account
    row j): both levels through `verify_proofs`. a_batch: the account
    BATCH_FIELDS tensors. Returns (a_status, account fields, s_status,
    s_values, s_value_lens)."""
    a_status, a_values, a_vlens = mpt.verify_proofs(*a_batch, max_value_len=128)
    acct = decode_account(a_values, a_vlens)
    s_knib, s_klen = _slot_key_nibbles(slots)
    s_status, s_values, s_vlens = mpt.verify_proofs(
        s_nodes, s_lens, s_num, acct["storage_root"], s_knib, s_klen,
        max_value_len=64)
    # an invalid/absent account or an undecodable leaf invalidates its slots
    account_ok = (a_status == mpt.FOUND) & acct["ok"]
    s_status = torch.where(account_ok, s_status, mpt.INVALID)
    return a_status, acct, s_status, s_values, s_vlens


def verify_storage_pooled(a_batch, a_pool, a_hints, s_nodes, s_lens, s_num,
                          s_pool, slots, slot_accounts):
    """Grouped, pooled two-level verification on tensors that already lie
    on one device (the reference's storage circuit,
    storage-circuit/src/main.rs:6-31, over A accounts and B slots).

    a_batch: the account level's BATCH_FIELDS tensors, a_pool its
    POOL_FIELDS tensors and a_hints its pack-time pool hints (None: the
    device hint pass makes them); s_nodes, s_lens, s_num and s_pool: the
    slot level's table and pool (its key fields are not read: the keys
    come from `slots`); slots u8 [B, >= 32] the raw slot keys, hashed on
    the device from their first 32 bytes; slot_accounts int [B] the
    account row of each slot. Returns (account status i32 [A], the decoded
    account fields (ops.account.decode_account's dict, [A] rows), slot
    status i32 [B], slot values u8 [B, 64], slot value lengths i32 [B]),
    on the device, with every launch queued.

    Each account proof is verified once (pooled, `hinted`); each slot's
    trusted root is its account's decoded storage_root (a row gather); the
    slot level walks pooled without hints (`bounded`): a storage trie
    holds inline leaves (a leaf under 32 bytes, deep in the trie with a
    small value: at 2^24 slots with 1-7-byte balances, about one proof in
    2,000, two in a batch of 4096), on which a hinted walk latches and the
    whole batch would be walked again in `exact`; `bounded` walks them
    without its re-run. A slot under an account that is not FOUND, or
    whose leaf does not decode, is INVALID. Spans: `zkp.storage` over the call, and inside it
    `zkp.storage.account` (the account level and its decode),
    `zkp.storage.slot_keys` (the slot hashing) and `zkp.storage.slots`
    (the root gather, the slot level and the override)."""
    with span("zkp.storage"):
        with span("zkp.storage.account"):
            a_status, a_values, a_vlens = mpt.verify_proofs_pooled(
                *a_batch, *a_pool, a_hints, max_value_len=128)
            acct = decode_account(a_values, a_vlens)
        with span("zkp.storage.slot_keys"):
            s_knib, s_klen = _slot_key_nibbles(slots)
        with span("zkp.storage.slots"):
            sa = slot_accounts.to(torch.int64)
            s_roots = torch.index_select(acct["storage_root"], 0, sa)
            s_status, s_values, s_vlens = mpt.verify_proofs_pooled(
                s_nodes, s_lens, s_num, s_roots, s_knib, s_klen, *s_pool,
                max_value_len=64, hinted=False)
            account_ok = (a_status == mpt.FOUND) & acct["ok"]
            s_status = torch.where(torch.index_select(account_ok, 0, sa), s_status,
                                   mpt.INVALID)
    return a_status, acct, s_status, s_values, s_vlens


@dataclass
class StorageVerifyResult:
    """1:1 two-level outcome: account row j owns slot j (numpy)."""

    account_status: np.ndarray   # i32 [B]
    storage_root: np.ndarray     # u8  [B, 32]
    nonce: np.ndarray            # u8  [B, 8] big-endian
    balance: np.ndarray          # u8  [B, 32] big-endian
    code_hash: np.ndarray        # u8  [B, 32]
    slot_status: np.ndarray      # i32 [B]
    slot_values: np.ndarray      # u8  [B, V]
    slot_value_lens: np.ndarray  # i32 [B]

    def slot_value(self, i: int) -> bytes:
        return bytes(self.slot_values[i][: self.slot_value_lens[i]])


@dataclass
class GroupedStorageVerifyResult:
    """N-slots-per-account outcome: account arrays are [A] (one row per
    unique account), slot arrays [B], and slot_accounts[j] names the
    account row that owns slot j (numpy)."""

    account_status: np.ndarray   # i32 [A]
    storage_root: np.ndarray     # u8  [A, 32]
    nonce: np.ndarray            # u8  [A, 8] big-endian
    balance: np.ndarray          # u8  [A, 32] big-endian
    code_hash: np.ndarray        # u8  [A, 32]
    slot_accounts: np.ndarray    # i32 [B]
    slot_status: np.ndarray      # i32 [B]
    slot_values: np.ndarray      # u8  [B, V]
    slot_value_lens: np.ndarray  # i32 [B]

    def slot_value(self, i: int) -> bytes:
        return bytes(self.slot_values[i][: self.slot_value_lens[i]])


def _checked_slots(slots, batch: int):
    slots = np.asarray(slots, dtype=np.uint8)
    if slots.shape != (batch, 32):
        raise ValueError(f"slots must be [B, 32], got {slots.shape}")
    return slots


def _grouped(a: PackedProofs, s: PackedProofs, slots, sa, device):
    """verify_storage_pooled on packed batches; numpy results."""
    dev = resolve_device(device)
    at = packed_to_tensors(a, dev)
    st = packed_to_tensors(s, dev)
    out = verify_storage_pooled(
        [at[k] for k in BATCH_FIELDS], [at[k] for k in POOL_FIELDS],
        at["pool_hints"], st["nodes"], st["node_lens"], st["num_nodes"],
        [st[k] for k in POOL_FIELDS], torch.from_numpy(slots).to(dev),
        torch.from_numpy(sa).to(dev))
    return _storage_numpy(*out)


def _storage_numpy(a_status, acct, s_status, s_values, s_vlens):
    return dict(
        account_status=a_status.cpu().numpy(),
        storage_root=acct["storage_root"].cpu().numpy(),
        nonce=acct["nonce"].cpu().numpy(),
        balance=acct["balance"].cpu().numpy(),
        code_hash=acct["code_hash"].cpu().numpy(),
        slot_status=s_status.cpu().numpy(),
        slot_values=s_values.cpu().numpy(),
        slot_value_lens=s_vlens.cpu().numpy())


def verify_storage_grouped(account_packed: PackedProofs,
                           storage_packed: PackedProofs, slots, slot_accounts,
                           device="cuda") -> GroupedStorageVerifyResult:
    """N-slots-per-account two-level verification (the reference's
    StorageProofInput shape, crypto-ops/src/types.rs:12-19).

    account_packed: A unique account proofs (key = keccak(address))
    storage_packed: B storage proofs (key_nibbles ignored: derived from
                    `slots` on the device)
    slots:          u8 [B, 32] raw slot keys (hashed on the device)
    slot_accounts:  i32 [B] the account row of each slot"""
    a, s = account_packed, storage_packed
    slots = _checked_slots(slots, s.batch)
    sa = np.asarray(slot_accounts, dtype=np.int32)
    if sa.shape != (s.batch,):
        raise ValueError(f"slot_accounts must be [B], got {sa.shape}")
    if sa.size and ((sa < 0).any() or (sa >= a.batch).any()):
        raise ValueError(f"slot_accounts out of range [0, {a.batch})")
    return GroupedStorageVerifyResult(slot_accounts=sa,
                                      **_grouped(a, s, slots, sa, device))


def verify_storage_batch(account_packed: PackedProofs,
                         storage_packed: PackedProofs, slots,
                         dedup: bool = True, device="cuda") -> StorageVerifyResult:
    """Two-level verification, 1:1 (account row j owns slot j).

    slots: u8 [B, 32] raw slot keys (hashed on the device). dedup=True
    runs the grouped, pooled core with the identity slot -> account map;
    dedup=False the unpooled core. Results are identical."""
    a, s = account_packed, storage_packed
    slots = _checked_slots(slots, s.batch)
    if dedup:
        sa = np.arange(s.batch, dtype=np.int32)
        return StorageVerifyResult(**_grouped(a, s, slots, sa, device))
    dev = resolve_device(device)
    at = packed_to_tensors(a, dev, pool=False)
    st = packed_to_tensors(s, dev, pool=False)
    out = _storage_core([at[k] for k in BATCH_FIELDS], st["nodes"],
                        st["node_lens"], st["num_nodes"],
                        torch.from_numpy(slots).to(dev))
    return StorageVerifyResult(**_storage_numpy(*out))
