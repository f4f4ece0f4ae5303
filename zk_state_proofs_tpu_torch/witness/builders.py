"""Witness builders for the block tries: transactions and receipts.

The port's own copy of the block half of `zk_state_proofs_tpu.witness.
builders` (the tests hold the two equal), with the transaction shape check
of `zk_state_proofs_tpu.witness.models.validate_transaction` that it calls.
Equivalents of the reference's trie-utils builders:
  - transaction: rebuild the whole tx trie locally from block data, insert
    each EIP-2718-encoded tx at path rlp(index), extract the proof, pair
    with the header's transactions_root
    (reference: trie-utils/src/proofs/transaction.rs:26-73)
  - receipt: same local-rebuild pattern over block receipts
    (reference: trie-utils/src/proofs/receipt.rs:28-93)
"""

from __future__ import annotations

from ..oracle import EthTrie, rlp
from .encoding import (EIP1559, EIP2930, EIP4844, EIP7702, LEGACY, OP_DEPOSIT,
                       _data, encode_receipt, encode_transaction, tx_type)
from .types import MerkleProofInput


class WitnessError(ValueError):
    """Witness construction failed (e.g. rebuilt root != header root)."""


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


def _require(obj: dict, names, where: str) -> None:
    if not isinstance(obj, dict):
        raise WitnessError(f"{where}: expected an object, got {type(obj).__name__}")
    missing = [n for n in names if obj.get(n) is None]
    if missing:
        raise WitnessError(f"{where}: missing required fields {missing}")


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


def build_transaction_trie(txs: list[dict]) -> EthTrie:
    """Insert every tx of a block at path rlp(index)
    (reference transaction.rs:44-64). Each tx is shape-validated first so
    a malformed RPC response raises WitnessError, not a KeyError inside
    the envelope encoder."""
    trie = EthTrie()
    for i, tx in enumerate(txs):
        trie.insert(rlp.encode_int(i), encode_transaction(validate_transaction(tx)))
    return trie


def build_receipt_trie(receipts: list[dict]) -> EthTrie:
    """Insert every receipt of a block at path rlp(index)
    (reference proofs/receipt.rs:44-86)."""
    trie = EthTrie()
    for i, rcpt in enumerate(receipts):
        trie.insert(rlp.encode_int(i), encode_receipt(rcpt))
    return trie


def _checked_root(trie: EthTrie, header_root, what: str) -> bytes:
    root = trie.root_hash()
    want = _data(header_root)
    if root != want:
        raise WitnessError(f"rebuilt {what} root {root.hex()} != header {what}Root "
                           f"{want.hex()}")
    return root


def get_transaction_proof_input(block: dict, index: int) -> MerkleProofInput:
    """Rebuild the block's tx trie, check the root against the header's
    transactionsRoot, and extract the proof for `index`."""
    txs = block["transactions"]
    if not 0 <= index < len(txs):
        raise WitnessError(f"tx index {index} out of range ({len(txs)} txs)")
    trie = build_transaction_trie(txs)
    root = _checked_root(trie, block["transactionsRoot"], "transactions")
    key = rlp.encode_int(index)
    return MerkleProofInput(proof=trie.get_proof(key), root_hash=root, key=key)


def get_receipt_proof_input(block: dict, receipts: list[dict], index: int) -> MerkleProofInput:
    """Rebuild the block's receipt trie, check against receiptsRoot, and
    extract the proof for `index`."""
    if not 0 <= index < len(receipts):
        raise WitnessError(f"receipt index {index} out of range")
    trie = build_receipt_trie(receipts)
    root = _checked_root(trie, block["receiptsRoot"], "receipts")
    key = rlp.encode_int(index)
    return MerkleProofInput(proof=trie.get_proof(key), root_hash=root, key=key)


def _all_inputs(trie: EthTrie, root: bytes, n: int) -> list:
    return [MerkleProofInput(proof=trie.get_proof(rlp.encode_int(i)), root_hash=root,
                             key=rlp.encode_int(i)) for i in range(n)]


def get_all_transaction_proof_inputs(block: dict) -> list:
    """All tx proofs of a block with ONE trie build (the per-index builder
    rebuilds per call, reference-style; this is the batch-friendly path)."""
    txs = block["transactions"]
    trie = build_transaction_trie(txs)
    root = _checked_root(trie, block["transactionsRoot"], "transactions")
    return _all_inputs(trie, root, len(txs))


def get_all_receipt_proof_inputs(block: dict, receipts: list) -> list:
    """All receipt proofs of a block with ONE trie build."""
    trie = build_receipt_trie(receipts)
    root = _checked_root(trie, block["receiptsRoot"], "receipts")
    return _all_inputs(trie, root, len(receipts))
