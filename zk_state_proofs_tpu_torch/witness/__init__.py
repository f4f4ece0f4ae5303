"""Host witness layer: the port's own copies of the parts of
`zk_state_proofs_tpu.witness` it needs — the packer (proofs -> padded
arrays, the unique-node pool, pack-time RLP offset hints, depth and pool
segment schedules), the tx/receipt encoders, the wire types, the block
trie builders and the offline fixtures."""

from .builders import (
    WitnessError,
    build_receipt_trie,
    build_transaction_trie,
    get_all_receipt_proof_inputs,
    get_all_transaction_proof_inputs,
    get_receipt_proof_input,
    get_transaction_proof_input,
)
from .encoding import encode_receipt, encode_transaction
from .fixtures import ERC20_TRANSFER_TOPIC, load_fixture, synthetic_block
from .pack import PackedProofs, PackingError, host_item_offsets, pack_proofs
from .types import MerkleProofInput, StorageProofInput

__all__ = [
    "ERC20_TRANSFER_TOPIC",
    "MerkleProofInput",
    "PackedProofs",
    "PackingError",
    "StorageProofInput",
    "WitnessError",
    "build_receipt_trie",
    "build_transaction_trie",
    "encode_receipt",
    "encode_transaction",
    "get_all_receipt_proof_inputs",
    "get_all_transaction_proof_inputs",
    "get_receipt_proof_input",
    "get_transaction_proof_input",
    "host_item_offsets",
    "load_fixture",
    "pack_proofs",
    "synthetic_block",
]
