"""Trie roots on the device: a level-wise keccak reduction (port of
`zk_state_proofs_tpu.ops.trie_build`).

Runs a host-built TriePlan (witness/trie_plan.py): per level, the child
digests are gathered from the digest table, added into the level's
zero-holed node templates (`index_put_(accumulate=True)`: holes are zero
and disjoint, so the sum is the digest bytes), and the whole level is
hashed in one launch of kernel K1 (`keccak_cuda`; its plain version on the
CPU). Leaf levels are wide and upper levels shrink geometrically, so
nearly all hashing is in the first one or two launches. The root is read
back once, at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from ..oracle.trie import EMPTY_ROOT
from ..utils.device import resolve_device
from .keccak_cuda import keccak256_cuda


def compute_root(plan, device="cuda"):
    """Run the reduction of `plan` on `device` ("cuda" unless named; a
    CUDA device without a card raises). Returns (root u8 [32], every
    node's digest u8 [total_nodes, 32]), both numpy."""
    return reduce_levels(plan, resolve_device(device), keccak256_cuda)


def reduce_levels(plan, dev, hash_level):
    """The level loop of compute_root on `dev`, each level's filled
    templates u8 [n, W] and lengths i32 [n] hashed by
    hash_level(templates, lengths) -> u8 [n, 32] (parallel.dist_trie
    passes a sharded one). Returns (root, digests), numpy."""
    if plan.root_is_empty:
        return np.frombuffer(EMPTY_ROOT, dtype=np.uint8).copy(), np.zeros((0, 32), np.uint8)
    digests = torch.zeros((plan.total_nodes, 32), dtype=torch.uint8, device=dev)
    cols = torch.arange(32, device=dev)
    for lvl in plan.levels:
        templ = torch.tensor(lvl.templates, device=dev)  # a copy: filled in place
        n = lvl.hole_src.shape[0]
        if (lvl.hole_src >= 0).any():
            src = torch.from_numpy(np.maximum(lvl.hole_src, 0).astype(np.int64)).to(dev)
            valid = torch.from_numpy(lvl.hole_src >= 0).to(dev)
            child = torch.where(valid[..., None], digests[src], 0)  # [n, H, 32]
            rows = torch.arange(n, device=dev)[:, None, None].expand(child.shape)
            at = (torch.from_numpy(lvl.hole_off.astype(np.int64)).to(dev)[:, :, None]
                  + cols).expand(child.shape)
            templ.index_put_((rows, at), child.to(torch.uint8), accumulate=True)
        dg = hash_level(templ, torch.from_numpy(lvl.lengths.astype(np.int32)).to(dev))
        digests[torch.from_numpy(lvl.node_ids.astype(np.int64)).to(dev)] = dg
    every = digests.cpu().numpy()
    return every[plan.root_id].copy(), every


def compute_root_bytes(plan, device="cuda") -> bytes:
    """The 32-byte root of `plan`, computed on `device`."""
    return bytes(compute_root(plan, device)[0])
