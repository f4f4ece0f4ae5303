"""Top-level verification workloads and the serving layer."""

from .service import BatchVerifier, ServiceStats
from .verifier import (VerifyResult, batch_commitment, diagnose_batch,
                       verify_account_batch, verify_merkle_batch,
                       verify_merkle_proof)

__all__ = [
    "BatchVerifier",
    "ServiceStats",
    "VerifyResult",
    "batch_commitment",
    "diagnose_batch",
    "verify_account_batch",
    "verify_merkle_batch",
    "verify_merkle_proof",
]
