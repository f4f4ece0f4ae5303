"""Distributed trie-root reduction — collective root recomputation (port of
`zk_state_proofs_tpu.parallel.dist_trie`).

The level-wise keccak reduction (ops/trie_build.py) distributed over the
ranks of a mesh: wide levels (leaves — virtually all the hashing work) are
sharded across the ranks, each hashing its rows with kernel K1, and their
digests exchanged with `all_gather`; the geometrically-shrinking upper
levels are hashed on every rank (SURVEY.md §7.4: keep upper levels
replicated so collective latency doesn't dominate). This is the scale-out
path for witness generation over whole blocks / 1M-proof sweeps (BASELINE
config #5).
"""

from __future__ import annotations

import torch

from ..ops.keccak_cuda import keccak256_cuda
from ..ops.trie_build import reduce_levels

# shard a level across the mesh only when every rank gets at least this
# many nodes — below that the collective latency beats the compute win
MIN_NODES_PER_DEVICE = 8


def _hash_level_sharded(mesh, templates, lengths):
    """Hash one level's node templates (u8 [n, W], lengths i32 [n], on the
    rank's device) with the rows sharded over the mesh; returns the
    digests of all n rows on every rank (all_gather over the mesh)."""
    n = templates.shape[0]
    npad = -(-n // mesh.size) * mesh.size
    if npad != n:
        templates = torch.nn.functional.pad(templates, (0, 0, 0, npad - n))
        lengths = torch.nn.functional.pad(lengths, (0, npad - n))
    rows = mesh.shard(npad)
    return mesh.all_gather(keccak256_cuda(templates[rows], lengths[rows]))[:n]


def compute_root_sharded(mesh, plan):
    """Distributed variant of ops.trie_build.compute_root on the mesh's
    device: wide levels are hashed rank-parallel with all_gather'ed
    digests; narrow levels run on every rank. Returns (root u8[32],
    all_digests u8[total, 32]), numpy, on every rank."""

    def hash_level(templates, lengths):
        if templates.shape[0] >= mesh.size * MIN_NODES_PER_DEVICE:
            return _hash_level_sharded(mesh, templates, lengths)
        return keccak256_cuda(templates, lengths)

    return reduce_levels(plan, mesh.device, hash_level)
