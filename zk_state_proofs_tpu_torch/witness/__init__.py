"""Host witness packing: the port's own copy of the packer of
`zk_state_proofs_tpu.witness` (proofs -> padded arrays, the unique-node pool,
pack-time RLP offset hints, depth and pool segment schedules)."""

from .pack import PackedProofs, PackingError, host_item_offsets, pack_proofs

__all__ = ["PackedProofs", "PackingError", "host_item_offsets", "pack_proofs"]
