"""Witness wire types + borsh-compatible (de)serialization.

The port's own copy of `zk_state_proofs_tpu.witness.types` (the tests hold
the two equal).

Byte-compatible with the reference's circuit input structs
(reference: crypto-ops/src/types.rs:5-19, borsh-derived), so witnesses
recorded by either framework interchange freely:

  MerkleProofInput  { proof: Vec<Vec<u8>>, root_hash: Vec<u8>, key: Vec<u8> }
  StorageProofInput { account_proof: Vec<Vec<u8>>,
                      storage_proofs: Vec<Vec<Vec<u8>>>,
                      root_hash: Vec<u8>, account_key: Vec<u8>,
                      storage_keys: Vec<Vec<u8>>, address_keccak: [u8; 32] }

borsh layout: Vec<T> = u32 little-endian count + elements; [u8; N] = raw
bytes; Vec<u8> = u32 LE length + bytes.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field


def _w_u32(out: io.BytesIO, v: int) -> None:
    out.write(struct.pack("<I", v))


def _w_bytes(out: io.BytesIO, b: bytes) -> None:
    _w_u32(out, len(b))
    out.write(b)


def _r_u32(buf: io.BytesIO) -> int:
    raw = buf.read(4)
    if len(raw) != 4:
        raise ValueError("borsh: truncated u32")
    return struct.unpack("<I", raw)[0]


def _r_bytes(buf: io.BytesIO) -> bytes:
    n = _r_u32(buf)
    raw = buf.read(n)
    if len(raw) != n:
        raise ValueError("borsh: truncated byte vec")
    return raw


@dataclass
class MerkleProofInput:
    """One MPT proof witness (reference: crypto-ops/src/types.rs:5-9)."""

    proof: list[bytes]
    root_hash: bytes
    key: bytes

    def to_borsh(self) -> bytes:
        out = io.BytesIO()
        _w_u32(out, len(self.proof))
        for node in self.proof:
            _w_bytes(out, node)
        _w_bytes(out, self.root_hash)
        _w_bytes(out, self.key)
        return out.getvalue()

    @classmethod
    def from_borsh(cls, data: bytes) -> "MerkleProofInput":
        buf = io.BytesIO(data)
        proof = [_r_bytes(buf) for _ in range(_r_u32(buf))]
        root_hash = _r_bytes(buf)
        key = _r_bytes(buf)
        if buf.read(1):
            raise ValueError("borsh: trailing bytes")
        return cls(proof=proof, root_hash=root_hash, key=key)

    def as_entry(self):
        """(root, proof, key) tuple for witness.pack_proofs."""
        return (self.root_hash, self.proof, self.key)


@dataclass
class StorageProofInput:
    """Two-level storage witness (reference: crypto-ops/src/types.rs:12-19).

    `account_key`/`address_keccak` are keccak(address) computed at witness
    time (reference storage.rs:58-64,77); `storage_keys` are RAW 32-byte
    slots hashed at verify time (reference storage-circuit/src/main.rs:26).
    """

    account_proof: list[bytes]
    storage_proofs: list[list[bytes]]
    root_hash: bytes
    account_key: bytes
    storage_keys: list[bytes]
    address_keccak: bytes

    def to_borsh(self) -> bytes:
        out = io.BytesIO()
        _w_u32(out, len(self.account_proof))
        for node in self.account_proof:
            _w_bytes(out, node)
        _w_u32(out, len(self.storage_proofs))
        for proof in self.storage_proofs:
            _w_u32(out, len(proof))
            for node in proof:
                _w_bytes(out, node)
        _w_bytes(out, self.root_hash)
        _w_bytes(out, self.account_key)
        _w_u32(out, len(self.storage_keys))
        for k in self.storage_keys:
            _w_bytes(out, k)
        if len(self.address_keccak) != 32:
            raise ValueError("address_keccak must be 32 bytes")
        out.write(self.address_keccak)
        return out.getvalue()

    @classmethod
    def from_borsh(cls, data: bytes) -> "StorageProofInput":
        buf = io.BytesIO(data)
        account_proof = [_r_bytes(buf) for _ in range(_r_u32(buf))]
        storage_proofs = [
            [_r_bytes(buf) for _ in range(_r_u32(buf))] for _ in range(_r_u32(buf))
        ]
        root_hash = _r_bytes(buf)
        account_key = _r_bytes(buf)
        storage_keys = [_r_bytes(buf) for _ in range(_r_u32(buf))]
        address_keccak = buf.read(32)
        if len(address_keccak) != 32:
            raise ValueError("borsh: truncated address_keccak")
        if buf.read(1):
            raise ValueError("borsh: trailing bytes")
        return cls(
            account_proof=account_proof,
            storage_proofs=storage_proofs,
            root_hash=root_hash,
            account_key=account_key,
            storage_keys=storage_keys,
            address_keccak=address_keccak,
        )
