"""PackedProofs -> torch tensors, with the JAX arrays' dtypes and layouts.

The port's state is the packed witness. Both packages compute on the same
bytes: `packed_to_tensors` moves the numpy arrays of a
`zk_state_proofs_tpu.witness.PackedProofs` (built by the JAX package's
host packer) onto `device` without changing dtype or shape.
"""

from __future__ import annotations

import numpy as np
import torch

from zk_state_proofs_tpu.witness.pack import PackedProofs


def resolve_device(device) -> torch.device:
    """torch.device(device); a CUDA device without a card raises (there is
    no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is available")
    return dev


def _t(a, dtype, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def packed_to_tensors(packed: PackedProofs, device, pool: bool = True) -> dict:
    """Tensors of a packed batch on `device`:
      nodes u8 [B, D, N], node_lens i32 [B, D], num_nodes i32 [B],
      roots u8 [B, 32], key_nibbles u8 [B, K], key_lens i32 [B]
    and with pool=True also pool_nodes u8 [U, N], pool_lens i32 [U],
    pool_idx i32 [B, D] (packed.pool()) and pool_hints u8 [U, 36]
    (packed.pool_hints())."""
    dev = resolve_device(device)
    out = {
        "nodes": _t(packed.nodes, np.uint8, dev),
        "node_lens": _t(packed.node_lens, np.int32, dev),
        "num_nodes": _t(packed.num_nodes, np.int32, dev),
        "roots": _t(packed.roots, np.uint8, dev),
        "key_nibbles": _t(packed.key_nibbles, np.uint8, dev),
        "key_lens": _t(packed.key_lens, np.int32, dev),
    }
    if pool:
        pn, pl, pi = packed.pool()
        out["pool_nodes"] = _t(pn, np.uint8, dev)
        out["pool_lens"] = _t(pl, np.int32, dev)
        out["pool_idx"] = _t(pi, np.int32, dev)
        out["pool_hints"] = _t(packed.pool_hints(), np.uint8, dev)
    return out


BATCH_FIELDS = ("nodes", "node_lens", "num_nodes", "roots", "key_nibbles",
                "key_lens")
POOL_FIELDS = ("pool_nodes", "pool_lens", "pool_idx")


def account_entries(n_accounts: int, hasher=None):
    """(entries, leaves): (root, proof, key) entries for every account of an
    n_accounts-account oracle trie, depth-sorted (deepest first), and the
    leaf value of each key — the headline witness recipe
    of the JAX package's bench.py (`build_witness_batch`): key =
    keccak("bench-account-%d"), leaf = RLP [nonce, balance, storage_root,
    code_hash]. `hasher` defaults to the native keccak when it loads, the
    oracle's otherwise (bit-identical, slower)."""
    from zk_state_proofs_tpu import native
    from zk_state_proofs_tpu.oracle import EthTrie, keccak256, rlp

    if hasher is None:
        hasher = native.keccak256 if native.available() else keccak256
    t = EthTrie(hasher=hasher)
    leaves = {}
    for i in range(n_accounts):
        k = hasher(b"bench-account-%d" % i)
        leaves[k] = rlp.encode([rlp.int_to_min_bytes(i),
                                rlp.int_to_min_bytes(10**18 + i),
                                hasher(b"sroot%d" % i), hasher(b"code%d" % i)])
        t.insert(k, leaves[k])
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in leaves]
    entries.sort(key=lambda e: -len(e[1]))
    return entries, leaves
