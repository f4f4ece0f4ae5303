"""Host witness layer: the port's own copies of `zk_state_proofs_tpu.witness`
— the packer (proofs -> padded arrays, the unique-node pool, pack-time RLP
offset hints, depth and pool segment schedules, the disk cache and its pool
integrity check), the tx/receipt encoders, the wire types, the four
proof-input builders, the typed RPC models and clients, and the recorded
and synthetic fixtures."""

from .builders import (
    WitnessError,
    build_receipt_trie,
    build_transaction_trie,
    get_account_proof_input,
    get_all_receipt_proof_inputs,
    get_all_transaction_proof_inputs,
    get_receipt_proof_input,
    get_storage_proof_input,
    get_transaction_proof_input,
)
from .encoding import encode_receipt, encode_transaction
from .fixtures import (
    ERC20_TRANSFER_TOPIC,
    load_fixture,
    record_block_fixture,
    record_proof_fixture,
    save_fixture,
    synthetic_block,
)
from .pack import (PackedProofs, PackingError, host_item_offsets, pack_proofs,
                   validate_node_pool)
from .rpc import (
    ArbitrumClient,
    EthereumClient,
    JsonRpcClient,
    OptimismClient,
    RpcError,
    load_infura_key_from_env,
)
from .types import MerkleProofInput, StorageProofInput

__all__ = [
    "ArbitrumClient",
    "ERC20_TRANSFER_TOPIC",
    "EthereumClient",
    "JsonRpcClient",
    "MerkleProofInput",
    "OptimismClient",
    "PackedProofs",
    "PackingError",
    "RpcError",
    "StorageProofInput",
    "WitnessError",
    "build_receipt_trie",
    "build_transaction_trie",
    "encode_receipt",
    "encode_transaction",
    "get_account_proof_input",
    "get_all_receipt_proof_inputs",
    "get_all_transaction_proof_inputs",
    "get_receipt_proof_input",
    "get_storage_proof_input",
    "get_transaction_proof_input",
    "host_item_offsets",
    "load_fixture",
    "load_infura_key_from_env",
    "pack_proofs",
    "record_block_fixture",
    "record_proof_fixture",
    "save_fixture",
    "synthetic_block",
    "validate_node_pool",
]
