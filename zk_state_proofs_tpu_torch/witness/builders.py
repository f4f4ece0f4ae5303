"""Witness builders — the four proof-input flavors.

The port's own copy of `zk_state_proofs_tpu.witness.builders` (the tests
hold the two equal). Equivalents of the reference's trie-utils builders:
  - account: from an eth_getProof response; key = keccak(address)
    (reference: trie-utils/src/proofs/account.rs:24-74, key at :54)
  - storage: account proof + N storage proofs with RAW slot keys
    (reference: trie-utils/src/proofs/storage.rs:24-121)
  - transaction: rebuild the whole tx trie locally from block data, insert
    each EIP-2718-encoded tx at path rlp(index), extract the proof, pair
    with the header's transactions_root
    (reference: trie-utils/src/proofs/transaction.rs:26-73)
  - receipt: same local-rebuild pattern over block receipts
    (reference: trie-utils/src/proofs/receipt.rs:28-93)
"""

from __future__ import annotations

from ..oracle import EthTrie, keccak256, rlp
from .encoding import _data, encode_receipt, encode_transaction
from .types import MerkleProofInput, StorageProofInput


class WitnessError(ValueError):
    """Witness construction failed (e.g. rebuilt root != header root)."""


def build_transaction_trie(txs: list[dict]) -> EthTrie:
    """Insert every tx of a block at path rlp(index)
    (reference transaction.rs:44-64). Each tx is shape-validated first so
    a malformed RPC response raises WitnessError, not a KeyError inside
    the envelope encoder."""
    from .models import validate_transaction

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


def get_account_proof_input(proof_response: dict, state_root: bytes, address: str) -> MerkleProofInput:
    """From an eth_getProof response: account witness with key =
    keccak(address) (reference account.rs:42-55). The response is parsed
    through the typed AccountProofResult model first, so a malformed
    shape raises WitnessError at this boundary."""
    from .models import AccountProofResult

    parsed = AccountProofResult.from_rpc(proof_response)
    return MerkleProofInput(
        proof=parsed.account_proof,
        root_hash=bytes(state_root),
        key=keccak256(_data(address)),
    )


def get_storage_proof_input(
    proof_response: dict, state_root: bytes, address: str, storage_keys: list
) -> StorageProofInput:
    """From an eth_getProof response with storage keys: the two-level
    witness. Slot keys stay RAW (hashed at verify time), the account key is
    pre-hashed (reference storage.rs:58-77). Typed-model parsing as in
    get_account_proof_input."""
    from .models import AccountProofResult

    parsed = AccountProofResult.from_rpc(proof_response)
    by_key = {sp.key: sp.proof for sp in parsed.storage_proof}
    slots = [_data(k).rjust(32, b"\x00") for k in storage_keys]
    missing = [s.hex() for s in slots if s not in by_key]
    if missing:
        raise WitnessError(f"storage proofs missing for slots: {missing}")
    addr_keccak = keccak256(_data(address))
    return StorageProofInput(
        account_proof=parsed.account_proof,
        storage_proofs=[by_key[s] for s in slots],
        root_hash=bytes(state_root),
        account_key=addr_keccak,
        storage_keys=slots,
        address_keccak=addr_keccak,
    )

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
