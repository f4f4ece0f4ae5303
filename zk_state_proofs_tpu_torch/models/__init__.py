"""Top-level verification workloads (accounts, two-level storage, block
transaction and receipt tries) and the serving layer."""

from .blocks import (Erc20Transfer, decode_receipt_value, extract_erc20_transfers,
                     verify_block_receipts, verify_block_transactions)
from .service import BatchVerifier, ServiceStats
from .verifier import (GroupedStorageVerifyResult, StorageVerifyResult,
                       VerifyResult, batch_commitment, diagnose_batch,
                       verify_account_batch, verify_merkle_batch,
                       verify_merkle_proof, verify_storage_batch,
                       verify_storage_grouped)

__all__ = [
    "BatchVerifier",
    "Erc20Transfer",
    "GroupedStorageVerifyResult",
    "ServiceStats",
    "StorageVerifyResult",
    "VerifyResult",
    "batch_commitment",
    "decode_receipt_value",
    "diagnose_batch",
    "extract_erc20_transfers",
    "verify_account_batch",
    "verify_block_receipts",
    "verify_block_transactions",
    "verify_merkle_batch",
    "verify_merkle_proof",
    "verify_storage_batch",
    "verify_storage_grouped",
]
