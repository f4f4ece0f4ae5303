"""Account/merkle verification workloads (port of
`zk_state_proofs_tpu.models.verifier`, the account-proof part).

Every entry point takes an explicit `device`: "cuda" runs kernels K1 and
K2, "cpu" their plain versions; "cuda" without a card raises. Results come
back as numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from zk_state_proofs_tpu.oracle.trie import MissingKeyError, TrieError
from zk_state_proofs_tpu.witness.pack import PackedProofs, pack_proofs

from ..ops import mpt
from ..ops.account import decode_account
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
                        dedup: bool = True, device="cpu") -> VerifyResult:
    """Verify a batch of packed MPT proofs on `device`. dedup=True hashes
    each unique node once (the pooled path, with pack-time hints)."""
    return VerifyResult(*_np(*_verify(packed, max_value_len, dedup, device)))


def diagnose_batch(packed: PackedProofs, max_value_len: int = 128,
                   device="cpu") -> VerifyResult:
    """verify_merkle_batch plus per-proof INVALID reason codes
    (mpt.REASON_NAMES)."""
    t = packed_to_tensors(packed, device, pool=False)
    out = mpt.verify_proofs_diagnose(*(t[k] for k in BATCH_FIELDS),
                                     max_value_len=max_value_len)
    status, values, vlens, reasons = _np(*out)
    return VerifyResult(status, values, vlens, reasons=reasons)


def verify_merkle_proof(root: bytes, proof: list, key: bytes,
                        device="cpu") -> bytes:
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


def verify_account_batch(packed: PackedProofs, dedup: bool = True, device="cpu"):
    """Verify + decode the account leaf. Returns (VerifyResult, dict of
    decoded numpy account fields)."""
    status, values, vlens = _verify(packed, 128, dedup, device)
    acct = decode_account(values, vlens)
    res = VerifyResult(*_np(status, values, vlens))
    return res, {k: v.cpu().numpy() for k, v in acct.items()}


def batch_commitment(result: VerifyResult) -> bytes:
    """keccak over the (status || len || value) stream of a result: two
    runs agree iff every per-proof outcome and value agree bit-exactly."""
    from zk_state_proofs_tpu import native
    from zk_state_proofs_tpu.oracle import keccak256 as _keccak

    stream = bytearray()
    for i in range(len(result.status)):
        stream += bytes([int(result.status[i])])
        v = result.value(i)
        stream += len(v).to_bytes(4, "little") + v
    return native.keccak256(bytes(stream)) if native.available() else _keccak(bytes(stream))
