"""Typed configuration with env overrides (the port's own copy of
`zk_state_proofs_tpu.utils.config`).

The reference's config surface is dotenv vars + cargo features + hard-coded
constants (reference: .env.example:2-8, trie-utils/src/constants.rs:1-24,
prover/Cargo.toml:32-35). Here it is one dataclass: RPC endpoints, batch
geometry (padding buckets), and mesh shape, overridable via environment
variables prefixed ZKP_.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields


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


@dataclass
class Config:
    ethereum_rpc_url: str = "https://mainnet.infura.io/v3/"
    optimism_rpc_url: str = "https://mainnet.optimism.io/"
    arbitrum_rpc_url: str = "https://arb1.arbitrum.io/rpc"
    infura_key: str = ""
    batch_size: int = 4096
    mesh_axis: str = "dp"
    n_devices: int = 0  # 0 = every rank of the process group (one device a rank)
    fixtures_dir: str = "fixtures"

    @classmethod
    def from_env(cls, **overrides) -> "Config":
        cfg = cls(**overrides)
        for f in fields(cls):
            env = os.environ.get("ZKP_" + f.name.upper())
            if env is not None and f.name not in overrides:
                setattr(cfg, f.name, type(getattr(cfg, f.name))(env))
        if not cfg.infura_key:
            cfg.infura_key = os.environ.get("INFURA", "")
        return cfg
