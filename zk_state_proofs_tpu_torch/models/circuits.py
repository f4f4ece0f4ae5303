"""Circuit entry points — the reference's zkVM guests as batched
verification (port of `zk_state_proofs_tpu.models.circuits`).

The reference verifies inside RISC-V zkVM guests that read a
borsh-encoded input, verify, and commit the result as public values:

  - the merkle guest (reference: circuits/sp1-merkle-proof/src/main.rs:4-14,
    risc0-merkle-proof/.../circuit/src/main.rs:5-15): read
    MerkleProofInput -> verify_merkle_proof -> commit(value);
  - the storage guest (reference: circuits/risc0-storage-proof/.../
    storage-circuit/src/main.rs:6-31): verify the account proof at
    address_keccak, decode the account, verify each storage proof at
    keccak(slot) against account.storage_root -> commit(stored_values).

The same semantics run here on `device` ("cuda" unless named: kernels K1
and K2; "cpu": their plain versions; a CUDA device without a card raises).
The "public values" are the returned bytes: same input bytes, same
committed bytes. Proving itself is out of scope.
"""

from __future__ import annotations

import numpy as np

from ..oracle.trie import MissingKeyError, TrieError
from ..ops import mpt
from ..witness.pack import pack_proofs
from ..witness.types import MerkleProofInput, StorageProofInput
from .verifier import verify_merkle_batch, verify_merkle_proof, verify_storage_grouped


def run_merkle_circuit(input_bytes: bytes, device="cuda") -> bytes:
    """The merkle guest on one borsh input: the committed value (the
    verified leaf bytes). Raises MissingKeyError for a proven-absent key,
    TrieError for an invalid proof, as the reference panics."""
    inp = MerkleProofInput.from_borsh(input_bytes)
    return verify_merkle_proof(inp.root_hash, inp.proof, inp.key, device=device)


def run_merkle_circuit_batch(inputs, device="cuda") -> list:
    """The merkle guest over many inputs (borsh bytes or MerkleProofInput)
    as one batch: the committed value of each, None where it is not
    FOUND."""
    inputs = [MerkleProofInput.from_borsh(i) if isinstance(i, (bytes, bytearray)) else i
              for i in inputs]
    packed = pack_proofs([i.as_entry() for i in inputs])
    res = verify_merkle_batch(packed, max_value_len=int(packed.nodes.shape[2]),
                              device=device)
    return [res.value(i) if res.status[i] == mpt.FOUND else None
            for i in range(packed.batch)]


def run_storage_circuit(input_bytes, device="cuda") -> list:
    """The storage guest on one borsh input (or StorageProofInput): verify
    the account proof at `address_keccak` once, decode the account, verify
    every storage proof at keccak(slot) against its storage_root; return
    the committed stored values (reference storage-circuit/src/main.rs:
    6-31). Raises ValueError on mismatched proof and key counts, TrieError
    on an invalid account or storage proof, MissingKeyError on an absent
    slot."""
    inp = (StorageProofInput.from_borsh(input_bytes)
           if isinstance(input_bytes, (bytes, bytearray)) else input_bytes)
    n = len(inp.storage_proofs)
    if n != len(inp.storage_keys):
        raise ValueError("storage_proofs and storage_keys length mismatch")
    if n == 0:
        return []
    # one account row and n slot rows, each slot under account row 0: the
    # reference's input shape (crypto-ops/src/types.rs:12-19)
    a_packed = pack_proofs([(inp.root_hash, inp.account_proof, inp.address_keccak)])
    s_packed = pack_proofs([(b"\x00" * 32, p, k)
                            for p, k in zip(inp.storage_proofs, inp.storage_keys)])
    slots = np.stack([np.frombuffer(k.rjust(32, b"\x00"), np.uint8)
                      for k in inp.storage_keys])
    res = verify_storage_grouped(a_packed, s_packed, slots, np.zeros(n, np.int32),
                                 device=device)
    if (res.account_status != mpt.FOUND).any():
        raise TrieError("invalid account proof")
    values = []
    for i in range(n):
        if res.slot_status[i] == mpt.EXCLUDED:
            raise MissingKeyError("Key does not exist!")
        if res.slot_status[i] != mpt.FOUND:
            raise TrieError("invalid storage proof")
        values.append(res.slot_value(i))
    return values
