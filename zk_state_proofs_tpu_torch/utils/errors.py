"""Structured error taxonomy (the port's own copy of
`zk_state_proofs_tpu.utils.errors`).

The reference panics everywhere (reference: crypto-ops/src/lib.rs:14,21-22;
arbitrum/client.rs:37,62,91). The framework distinguishes, as exceptions on
host paths and as status codes on device paths (ops.mpt.FOUND / EXCLUDED /
INVALID):

  VerificationError   proof inconsistent with the trusted root
  MissingKeyError     proof consistent, key provably absent
  WitnessError        witness construction failed (bad RPC data, root
                      mismatch vs header)
  PackingError        batch does not fit the padding bucket
"""

from ..oracle.trie import MissingKeyError, TrieError as VerificationError
from ..witness.builders import WitnessError
from ..witness.pack import PackingError


__all__ = [
    "MissingKeyError",
    "VerificationError",
    "WitnessError",
    "PackingError",
]
