"""Top-level verification workloads (accounts, two-level storage, block
transaction and receipt tries), the circuit entry points, the sweeps and
the serving layer."""

from .blocks import (Erc20Transfer, decode_receipt_value, extract_erc20_transfers,
                     verify_block_receipts, verify_block_transactions)
from .circuits import run_merkle_circuit, run_merkle_circuit_batch, run_storage_circuit
from .service import BatchVerifier, ServiceStats
from .sweep import (SweepResult, replicated_batches, sweep, sweep_entries,
                    sweep_resident, sweep_resident_epochs)
from .verifier import (GroupedStorageVerifyResult, StorageVerifyResult,
                       VerifyResult, batch_commitment, diagnose_batch,
                       verify_account_batch, verify_merkle_batch,
                       verify_merkle_proof, verify_storage_batch,
                       verify_storage_grouped, verify_storage_pooled)

__all__ = [
    "BatchVerifier",
    "ServiceStats",
    "run_merkle_circuit",
    "run_merkle_circuit_batch",
    "run_storage_circuit",
    "SweepResult",
    "replicated_batches",
    "sweep",
    "sweep_entries",
    "sweep_resident",
    "sweep_resident_epochs",
    "batch_commitment",
    "diagnose_batch",
    "verify_account_batch",
    "Erc20Transfer",
    "decode_receipt_value",
    "extract_erc20_transfers",
    "verify_block_receipts",
    "verify_block_transactions",
    "GroupedStorageVerifyResult",
    "StorageVerifyResult",
    "VerifyResult",
    "verify_merkle_batch",
    "verify_merkle_proof",
    "verify_storage_batch",
    "verify_storage_grouped",
    "verify_storage_pooled",
]
