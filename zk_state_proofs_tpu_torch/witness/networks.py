"""Per-network witness flavors (Ethereum / Optimism / Arbitrum).

Mirror of the reference's network split (reference: NetworkEvm enum,
trie-utils/src/types.rs:5-9; per-network builders account.rs:24-74,
storage.rs:24-121, transaction.rs:26-125):

  - Ethereum: account/storage via eth_getProof, tx/receipt via local
    trie rebuild.
  - Optimism: same shapes; deposit transactions (type 0x7e) get their
    manual envelope prefix (encoding.OP_DEPOSIT).
  - Arbitrum: account/storage only — transaction proofs are NOT supported,
    matching the reference (arbitrum/types.rs:20-26).

The port's own copy of `zk_state_proofs_tpu.witness.networks`.
"""

from __future__ import annotations

import enum

from .builders import (
    WitnessError,
    get_account_proof_input,
    get_receipt_proof_input,
    get_storage_proof_input,
    get_transaction_proof_input,
)
from .encoding import _data
from .rpc import ArbitrumClient, EthereumClient, OptimismClient


class NetworkEvm(enum.Enum):
    ETHEREUM = "ethereum"
    OPTIMISM = "optimism"
    ARBITRUM = "arbitrum"


_CLIENTS = {
    NetworkEvm.ETHEREUM: EthereumClient,
    NetworkEvm.OPTIMISM: OptimismClient,
    NetworkEvm.ARBITRUM: ArbitrumClient,
}


def client_for(network: NetworkEvm, url: str | None = None, transport=None):
    cls = _CLIENTS[network]
    if network is NetworkEvm.ETHEREUM:
        return cls(url=url, transport=transport)
    return cls(**({"url": url} if url else {}), transport=transport)


def get_account_proof_inputs(client, address: str, network: NetworkEvm, tag="latest"):
    """Account witness for any network (reference account.rs:24-74: the
    Arbitrum variant only differs in client plumbing — proofs are
    hex-decoded uniformly here)."""
    block = client.get_block_by_number(tag, full_txs=False)
    proof = client.get_proof(address, [], tag)
    return get_account_proof_input(proof, _data(block["stateRoot"]), address)


def get_storage_proof_inputs(client, address: str, storage_keys: list,
                             network: NetworkEvm, tag="latest"):
    """Storage witness for any network (reference storage.rs:24-121)."""
    block = client.get_block_by_number(tag, full_txs=False)
    proof = client.get_proof(address, storage_keys, tag)
    return get_storage_proof_input(proof, _data(block["stateRoot"]), address, storage_keys)


def get_transaction_proof_inputs(client, block_hash: str, index: int,
                                 network: NetworkEvm):
    """Transaction witness: local trie rebuild (reference
    transaction.rs:26-125). Raises for Arbitrum (reference parity)."""
    if network is NetworkEvm.ARBITRUM:
        raise WitnessError(
            "Arbitrum transaction proofs are not supported (reference parity: "
            "arbitrum/types.rs:20-26)"
        )
    block = client.get_block_by_hash(block_hash, full_txs=True)
    return get_transaction_proof_input(block, index)


def get_receipt_proof_inputs(client, block_hash: str, index: int,
                             network: NetworkEvm):
    """Receipt witness (reference proofs/receipt.rs:28-93 — Ethereum only in
    the reference; here any network whose RPC serves eth_getBlockReceipts)."""
    if network is NetworkEvm.ARBITRUM:
        raise WitnessError("Arbitrum receipt proofs are not supported")
    block = client.get_block_by_hash(block_hash, full_txs=True)
    receipts = client.get_block_receipts(block_hash)
    return get_receipt_proof_input(block, receipts, index)
