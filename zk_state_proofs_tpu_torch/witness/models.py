"""Typed RPC response models with field validation.

The reference parses RPC responses into typed structs — op-alloy
transactions inside a typed BlockResult for Optimism (reference:
trie-utils/src/proofs/optimism/types.rs:4-38), and hand-rolled
BlockResult / AccountProof / StorageProof types with string-hex proof
fields for Arbitrum (reference: arbitrum/types.rs:3-66). These are the
equivalents: dataclass views over the raw JSON dicts that validate shape
and hex encoding up front, so a malformed response raises WitnessError at
the boundary instead of a KeyError deep inside the envelope encoders.

The port's own copy of `zk_state_proofs_tpu.witness.models` (the tests
hold the two equal).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .builders import WitnessError
from .encoding import (
    EIP1559,
    EIP2930,
    EIP4844,
    EIP7702,
    LEGACY,
    OP_DEPOSIT,
    tx_type,
)


def _hex_bytes(value, name: str, width: int | None = None) -> bytes:
    """Validated 0x-hex data field -> bytes."""
    if isinstance(value, (bytes, bytearray)):
        out = bytes(value)
    elif isinstance(value, str):
        s = value[2:] if value.startswith("0x") else value
        if len(s) % 2:  # RPCs serve quantity-style keys like "0x0"
            s = "0" + s
        try:
            out = bytes.fromhex(s)
        except ValueError as e:
            raise WitnessError(f"field {name!r} is not hex data: {value!r}") from e
    else:
        raise WitnessError(f"field {name!r} must be hex data, got {type(value).__name__}")
    if width is not None and len(out) != width:
        raise WitnessError(f"field {name!r} must be {width} bytes, got {len(out)}")
    return out


def _hex_qty(value, name: str) -> int:
    """Validated 0x-hex quantity field -> int."""
    if isinstance(value, int):
        return value
    if isinstance(value, str):
        try:
            return int(value, 16)
        except ValueError as e:
            raise WitnessError(f"field {name!r} is not a hex quantity: {value!r}") from e
    raise WitnessError(f"field {name!r} must be a hex quantity, got {type(value).__name__}")


def _require(obj: dict, names, where: str) -> None:
    if not isinstance(obj, dict):
        raise WitnessError(f"{where}: expected an object, got {type(obj).__name__}")
    missing = [n for n in names if obj.get(n) is None]
    if missing:
        raise WitnessError(f"{where}: missing required fields {missing}")


# required signed-envelope fields per EIP-2718 type (the alloy TxEnvelope
# variants the reference matches on, transaction.rs:47-62; deposit fields
# per op-alloy TxDeposit, transaction.rs:93-97)
_TX_REQUIRED = {
    LEGACY: ["nonce", "gasPrice", "gas", "value", "v", "r", "s"],
    EIP2930: ["chainId", "nonce", "gasPrice", "gas", "value", "r", "s"],
    EIP1559: ["chainId", "nonce", "maxPriorityFeePerGas", "maxFeePerGas",
              "gas", "value", "r", "s"],
    EIP4844: ["chainId", "nonce", "maxPriorityFeePerGas", "maxFeePerGas",
              "gas", "value", "maxFeePerBlobGas", "blobVersionedHashes",
              "r", "s"],
    EIP7702: ["chainId", "nonce", "maxPriorityFeePerGas", "maxFeePerGas",
              "gas", "value", "authorizationList", "r", "s"],
    OP_DEPOSIT: ["sourceHash", "from", "gas"],
}


def validate_transaction(tx: dict) -> dict:
    """Validate an RPC transaction dict against its envelope's required
    fields; returns the dict unchanged. WitnessError on any malformed
    shape (the reference gets this from serde's typed deserialization)."""
    if not isinstance(tx, dict):
        raise WitnessError(f"transaction must be an object, got {type(tx).__name__}")
    try:
        t = tx_type(tx)
    except ValueError as e:
        raise WitnessError(f"transaction has malformed type field: {tx.get('type')!r}") from e
    required = _TX_REQUIRED.get(t)
    if required is None:
        raise WitnessError(f"unsupported transaction type {t:#x}")
    _require(tx, required, f"transaction type {t:#x}")
    if t != LEGACY and t != OP_DEPOSIT and tx.get("yParity") is None and tx.get("v") is None:
        raise WitnessError(f"transaction type {t:#x}: missing yParity/v")
    for al_field in ("accessList", "authorizationList", "blobVersionedHashes"):
        if al_field in tx and tx[al_field] is not None and not isinstance(tx[al_field], list):
            raise WitnessError(f"transaction field {al_field!r} must be a list")
    return tx


@dataclass
class StorageProofEntry:
    """One storageProof item of an eth_getProof response (reference:
    arbitrum/types.rs:60-66 — string-hex key/proof/value)."""

    key: bytes          # 32-byte slot (left-padded)
    proof: list         # list[bytes] RLP nodes
    value: int

    @classmethod
    def from_rpc(cls, sp: dict) -> "StorageProofEntry":
        _require(sp, ["key", "proof"], "storageProof entry")
        if not isinstance(sp["proof"], list):
            raise WitnessError("storageProof entry: proof must be a list")
        return cls(
            key=_hex_bytes(sp["key"], "storageProof.key").rjust(32, b"\x00"),
            proof=[_hex_bytes(n, "storageProof.proof[i]") for n in sp["proof"]],
            value=_hex_qty(sp.get("value", "0x0"), "storageProof.value"),
        )


@dataclass
class AccountProofResult:
    """Typed eth_getProof response (reference: arbitrum/types.rs:44-58
    AccountProof — the same shape every network serves). Carries
    storage_hash so callers can cross-check the decoded account's
    storage_root against it (reference tests/account.rs:64-67)."""

    address: bytes            # 20
    balance: int
    code_hash: bytes          # 32
    nonce: int
    storage_hash: bytes       # 32
    account_proof: list       # list[bytes]
    storage_proof: list = field(default_factory=list)  # list[StorageProofEntry]

    @classmethod
    def from_rpc(cls, resp: dict) -> "AccountProofResult":
        _require(resp, ["address", "accountProof", "storageHash"],
                 "eth_getProof response")
        if not isinstance(resp["accountProof"], list):
            raise WitnessError("eth_getProof response: accountProof must be a list")
        return cls(
            address=_hex_bytes(resp["address"], "address", 20),
            balance=_hex_qty(resp.get("balance", "0x0"), "balance"),
            code_hash=_hex_bytes(resp.get("codeHash", "0x" + "00" * 32),
                                 "codeHash", 32),
            nonce=_hex_qty(resp.get("nonce", "0x0"), "nonce"),
            storage_hash=_hex_bytes(resp["storageHash"], "storageHash", 32),
            account_proof=[_hex_bytes(n, "accountProof[i]")
                           for n in resp["accountProof"]],
            storage_proof=[StorageProofEntry.from_rpc(sp)
                           for sp in resp.get("storageProof") or []],
        )


@dataclass
class OpBlock:
    """Typed Optimism block (reference: optimism/types.rs:12-27
    BlockResult with full op-alloy transactions, incl. deposit txs)."""

    hash: bytes
    number: int
    state_root: bytes
    transactions_root: bytes
    receipts_root: bytes | None
    transactions: list        # validated RPC tx dicts
    raw: dict

    @classmethod
    def from_rpc(cls, block: dict) -> "OpBlock":
        _require(block, ["hash", "number", "stateRoot", "transactionsRoot",
                         "transactions"], "Optimism block")
        if not isinstance(block["transactions"], list):
            raise WitnessError("Optimism block: transactions must be a list")
        txs = [validate_transaction(tx) for tx in block["transactions"]]
        rr = block.get("receiptsRoot")
        return cls(
            hash=_hex_bytes(block["hash"], "hash", 32),
            number=_hex_qty(block["number"], "number"),
            state_root=_hex_bytes(block["stateRoot"], "stateRoot", 32),
            transactions_root=_hex_bytes(block["transactionsRoot"],
                                         "transactionsRoot", 32),
            receipts_root=_hex_bytes(rr, "receiptsRoot", 32) if rr else None,
            transactions=txs,
            raw=block,
        )


@dataclass
class ArbBlock:
    """Typed Arbitrum block (reference: arbitrum/types.rs:9-26 — the
    BlockResult deliberately OMITS transactions: tx proofs unsupported)."""

    hash: bytes
    number: int
    state_root: bytes
    raw: dict

    @classmethod
    def from_rpc(cls, block: dict) -> "ArbBlock":
        _require(block, ["hash", "number", "stateRoot"], "Arbitrum block")
        return cls(
            hash=_hex_bytes(block["hash"], "hash", 32),
            number=_hex_qty(block["number"], "number"),
            state_root=_hex_bytes(block["stateRoot"], "stateRoot", 32),
            raw=block,
        )

    @property
    def transactions(self):
        raise WitnessError(
            "Arbitrum transaction proofs are not supported (reference "
            "parity: arbitrum/types.rs:20-26)"
        )
