"""Padding bucket geometry for packed proof batches.

A copy of `zk_state_proofs_tpu.utils.config.BucketConfig`: that module's
package `__init__` imports its profiling module, which imports jax, so the
port keeps its own copy of the dataclass.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class BucketConfig:
    """Padding bucket geometry for packed proof batches."""

    max_nodes: int = 8        # proof depth (hashed nodes)
    node_len: int = 576       # bytes per node buffer (branch max 532 + slack)
    key_nibbles: int = 64     # 32-byte keys
    max_value_len: int = 128  # extracted value bytes

    @classmethod
    def account(cls):
        return cls(max_nodes=12, node_len=576, key_nibbles=64, max_value_len=128)

    @classmethod
    def storage(cls):
        return cls(max_nodes=10, node_len=576, key_nibbles=64, max_value_len=64)

    @classmethod
    def transaction(cls, max_tx_bytes: int = 2048):
        # leaf node carries the whole encoded tx
        return cls(max_nodes=6, node_len=max(576, max_tx_bytes + 16),
                   key_nibbles=8, max_value_len=max_tx_bytes)

    @classmethod
    def receipt(cls, max_receipt_bytes: int = 2048):
        return cls(max_nodes=6, node_len=max(576, max_receipt_bytes + 16),
                   key_nibbles=8, max_value_len=max_receipt_bytes)
