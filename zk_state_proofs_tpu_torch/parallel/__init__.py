"""The mesh/sharding layer: data-parallel proof verification over the ranks
of a torch.distributed process group, with all_reduce-summed stats (port
of `zk_state_proofs_tpu.parallel`)."""

from .dist_trie import compute_root_sharded
from .mesh import (
    BATCH_AXIS,
    make_mesh,
    make_sharded_storage_verifier,
    make_sharded_verifier,
    pad_batch,
    verify_proofs_sharded,
    verify_storage_grouped_sharded,
)

__all__ = [
    "compute_root_sharded",
    "BATCH_AXIS",
    "make_mesh",
    "make_sharded_storage_verifier",
    "make_sharded_verifier",
    "pad_batch",
    "verify_proofs_sharded",
    "verify_storage_grouped_sharded",
]
