"""Top-level verification workloads and the serving layer."""

from .service import BatchVerifier, ServiceStats
from .verifier import (GroupedStorageVerifyResult, StorageVerifyResult,
                       VerifyResult, batch_commitment, diagnose_batch,
                       verify_account_batch, verify_merkle_batch,
                       verify_merkle_proof, verify_storage_batch,
                       verify_storage_grouped)

__all__ = [
    "BatchVerifier",
    "GroupedStorageVerifyResult",
    "ServiceStats",
    "StorageVerifyResult",
    "VerifyResult",
    "batch_commitment",
    "diagnose_batch",
    "verify_account_batch",
    "verify_merkle_batch",
    "verify_merkle_proof",
    "verify_storage_batch",
    "verify_storage_grouped",
]
