"""Multi-rank sharded verification over torch.distributed (port of
`zk_state_proofs_tpu.parallel.mesh`).

JAX shards the proof batch over a `Mesh` of chips with `shard_map` and
reduces the global counts with `psum`. Here the mesh is the ranks of a
process group, one device a rank (`make_mesh`, over a
`torch.distributed.device_mesh.DeviceMesh`). Every rank holds the same
full host batch, as every JAX process does; each verifies its contiguous
share of the padded batch with the port's unsharded functions, the counts
are summed with `all_reduce`, and the sharded outputs come back to every
rank with `all_gather`. The results are bit-identical to the unsharded
functions. Padding rows have num_nodes == 0 and verify INVALID; an
`active` mask keeps them out of the counts.

One rank without a process group is a one-device mesh: its collectives
are identities, as a single-device JAX mesh's are. The collectives take
the device's tensors under either backend (NCCL, or gloo, whose
collectives copy CUDA tensors through host memory themselves).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops import mpt
from ..utils.device import resolve_device
from .multihost import put_global

BATCH_AXIS = "dp"

# dtypes of PackedProofs.astuple(): nodes, node_lens, num_nodes, roots,
# key_nibbles, key_lens
_BATCH_DTYPES = (np.uint8, np.int32, np.int32, np.uint8, np.uint8, np.int32)


class Mesh:
    """A 1-D mesh over the ranks of a process group, one device a rank.

    axis_names: (the batch axis name,); size: the number of ranks; rank:
    this process's; device: its device; device_mesh: the DeviceMesh over
    the group (None for one rank without a group)."""

    def __init__(self, axis: str, size: int, rank: int, device: torch.device,
                 device_mesh=None):
        self.axis_names = (axis,)
        self.size = size
        self.rank = rank
        self.device = device
        self.device_mesh = device_mesh

    @property
    def group(self):
        return None if self.device_mesh is None else self.device_mesh.get_group()

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}

    def __repr__(self) -> str:
        return (f"Mesh({self.axis_names[0]}={self.size}, rank={self.rank}, "
                f"device={self.device})")

    def shard(self, rows: int) -> slice:
        """This rank's contiguous share of `rows` (a multiple of size)."""
        if rows % self.size:
            raise ValueError(f"{rows} rows do not divide over {self.size} ranks")
        n = rows // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place; returns it."""
        if self.device_mesh is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (one shape on all), concatenated along dim 0 in
        rank order."""
        if self.device_mesh is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)


def make_mesh(n_devices: int | None = None, axis: str = BATCH_AXIS,
              device="cuda") -> Mesh:
    """1-D mesh over the proof-batch axis: every rank of the initialized
    process group (parallel.multihost.initialize), one device each. On
    "cuda" without an index, rank r takes card r % device_count; a named
    device is taken as given (several ranks may share one card under
    gloo); a rank's card becomes its current device. n_devices, where
    given, must be the world size. Without a process group the mesh is
    this one device. Raises without a card where the device is CUDA."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} ranks needs a process group of "
                             f"{n_devices} (parallel.multihost.initialize)")
        return Mesh(axis, 1, 0, dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices not in (None, world):
        raise ValueError(f"one device a rank: the mesh spans the group's {world} ranks, "
                         f"not {n_devices}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (world,), mesh_dim_names=(axis,))
    return Mesh(axis, world, rank, dev, dm)


def local_mesh(device) -> Mesh:
    """A one-rank mesh over `device` outside any process group: its
    collectives are identities (an unsharded call's mesh)."""
    return Mesh(BATCH_AXIS, 1, 0, resolve_device(device))


def pad_batch(arrays, multiple: int):
    """Pad the leading batch dim of every array to a multiple (proofs with
    num_nodes == 0 and a non-empty root verify to INVALID and are sliced
    off by the caller)."""
    b = arrays[0].shape[0]
    bp = -(-b // multiple) * multiple
    if bp == b:
        return arrays, b
    out = []
    for a in arrays:
        pad = [(0, bp - b)] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(np.asarray(a), pad))
    return tuple(out), b


def local_share(mesh: Mesh, arrays):
    """This rank's share of host arrays that every rank holds alike, all
    with one leading batch dim: padded to a multiple of the mesh size
    (pad_batch), then this rank's contiguous rows. Returns (the shares,
    numpy, and the share's active mask i32: 1 on a real row, 0 on
    padding)."""
    b = arrays[0].shape[0]
    padded, _ = pad_batch(tuple(arrays) + (np.ones(b, np.int32),), mesh.size)
    rows = mesh.shard(padded[0].shape[0])
    return tuple(np.asarray(a)[rows] for a in padded[:-1]), padded[-1][rows]


def local_counts(status: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """i64 [3]: FOUND, EXCLUDED, INVALID among the rows with active > 0."""
    live = active > 0  # padding rows stay out of the global stats
    return torch.stack([(live & (status == c)).sum()
                        for c in (mpt.FOUND, mpt.EXCLUDED, mpt.INVALID)])


def verify_local(mesh: Mesh, batch, pool=(), max_value_len: int = 128,
                 max_steps: int | None = None):
    """Verify this rank's share of a batch on the mesh's device: `batch`
    is the share (local_share) of PackedProofs.astuple()'s six host
    arrays; `pool`, where given, is (pool_nodes, pool_lens) whole and the
    share of pool_idx. A pooled share walks `hinted` with the device hint
    pass (`verify_proofs_pooled` without pack-time hints), else
    `verify_proofs`. Returns (status, values, value_lens), tensors."""
    batch = [put_global(mesh, np.asarray(a, dt), None) for a, dt in zip(batch, _BATCH_DTYPES)]
    if pool:
        pool = [put_global(mesh, np.asarray(a, dt), None)
                for a, dt in zip(pool, (np.uint8, np.int32, np.int32))]
        return mpt.verify_proofs_pooled(*batch, *pool, max_value_len=max_value_len,
                                        max_steps=max_steps)
    return mpt.verify_proofs(*batch, max_value_len=max_value_len, max_steps=max_steps)


def make_sharded_verifier(mesh: Mesh, max_value_len: int = 128, pooled: bool = False):
    """A sharded batch verifier over `mesh`.

    Returns fn(nodes, node_lens, num_nodes, roots, key_nibbles, key_lens,
    active) -> (status [B], values [B, V], value_lens [B], global_counts
    [3]), tensors on the rank's device: the host arrays' batch axis
    (a multiple of the mesh size) is sharded over the ranks, the outputs
    all-gathered to every rank, and the counts of the active rows summed
    over the ranks.

    pooled=True appends (pool_nodes, pool_lens, pool_idx) inputs: the
    unique-node pool is REPLICATED on every rank (proofs on every shard
    reference the same trie's nodes) while pool_idx is sharded with the
    proofs — each rank hashes the pool once instead of re-hashing its
    shard's node rows (see witness.pack.build_node_pool)."""

    def fn(nodes, node_lens, num_nodes, roots, key_nibbles, key_lens, active, *pool):
        if bool(pool) != pooled:
            raise ValueError(f"pooled={pooled} verifier given {len(pool)} pool inputs")
        share, _ = local_share(mesh, (nodes, node_lens, num_nodes, roots, key_nibbles,
                                      key_lens, active) + pool[2:])
        status, values, vlens = verify_local(mesh, share[:6], pool[:2] + share[7:],
                                             max_value_len=max_value_len)
        counts = local_counts(status, put_global(mesh, share[6], None))
        return (mesh.all_gather(status), mesh.all_gather(values), mesh.all_gather(vlens),
                mesh.all_reduce_sum(counts))

    return fn


def make_sharded_storage_verifier(mesh: Mesh):
    """Sharded GROUPED two-level storage verification over `mesh` (the
    reference's one-account/N-slots circuit shape,
    storage-circuit/src/main.rs:6-31, generalized to A accounts).

    Sharding layout: the SLOT batch is the parallel axis (it is the wide
    dimension — S slots per account); the A unique account proofs and
    both unique-node pools are REPLICATED, so every rank verifies the
    account level redundantly (A is small) and gathers its slots'
    trusted storage_roots locally — no collective inside the step, one
    all_reduce for the global slot counts. Results are bit-identical to
    models.verify_storage_grouped.

    Returns fn(a_nodes, a_lens, a_num, a_roots, a_knib, a_klen, a_pn,
    a_pl, a_pi, s_nodes, s_lens, s_num, s_pn, s_pl, s_pi, slots,
    slot_accounts, active) -> (account_status [A], storage_roots [A, 32],
    slot_status [B], slot_values [B, 64], slot_value_lens [B],
    global_counts [3]), tensors on the rank's device."""
    from ..models.verifier import verify_storage_pooled

    ax = mesh.axis_names[0]

    def rep(a, dt):
        return put_global(mesh, np.asarray(a, dt), None)

    def shd(a, dt):
        return put_global(mesh, np.asarray(a, dt), ax)

    def fn(a_nodes, a_lens, a_num, a_roots, a_knib, a_klen, a_pn, a_pl, a_pi,
           s_nodes, s_lens, s_num, s_pn, s_pl, s_pi, slots, slot_accounts, active):
        a_batch = [rep(a, dt) for a, dt in zip(
            (a_nodes, a_lens, a_num, a_roots, a_knib, a_klen), _BATCH_DTYPES)]
        a_pool = [rep(a_pn, np.uint8), rep(a_pl, np.int32), rep(a_pi, np.int32)]
        s_pool = [rep(s_pn, np.uint8), rep(s_pl, np.int32), shd(s_pi, np.int32)]
        a_status, acct, s_status, s_values, s_vlens = verify_storage_pooled(
            a_batch, a_pool, None, shd(s_nodes, np.uint8), shd(s_lens, np.int32),
            shd(s_num, np.int32), s_pool, shd(slots, np.uint8),
            shd(slot_accounts, np.int32))
        counts = local_counts(s_status, shd(active, np.int32))
        return (a_status, acct["storage_root"], mesh.all_gather(s_status),
                mesh.all_gather(s_values), mesh.all_gather(s_vlens),
                mesh.all_reduce_sum(counts))

    return fn


def _host(*ts):
    return tuple(t.cpu().numpy() for t in ts)


def verify_storage_grouped_sharded(mesh: Mesh, account_packed, storage_packed,
                                   slots, slot_accounts):
    """Convenience wrapper over make_sharded_storage_verifier: pad the
    slot batch to the mesh size, shard, verify, slice back. Returns
    (account_status [A], storage_roots [A, 32], slot_status [B],
    slot_values [B, 64], slot_value_lens [B], global_counts [3]), numpy."""
    a, s = account_packed, storage_packed
    slots = np.asarray(slots, dtype=np.uint8)
    sa = np.asarray(slot_accounts, dtype=np.int32)
    active = np.ones(s.batch, dtype=np.int32)
    s_pool = s.pool()
    (s_nodes, s_lens, s_num, d_slots, d_sa, d_active, s_pi), b = pad_batch(
        (s.nodes, s.node_lens, s.num_nodes, slots, sa, active, s_pool[2]), mesh.size)
    fn = make_sharded_storage_verifier(mesh)
    a_st, a_roots, s_st, s_v, s_vl, counts = _host(*fn(
        *(a.astuple() + a.pool()),
        s_nodes, s_lens, s_num, s_pool[0], s_pool[1], s_pi,
        d_slots, d_sa, d_active))
    return a_st, a_roots, s_st[:b], s_v[:b], s_vl[:b], counts


def verify_proofs_sharded(mesh: Mesh, packed, max_value_len: int = 128,
                          dedup: bool = True):
    """Convenience wrapper: pad the batch to the mesh size, shard, verify,
    slice back. `packed` is a witness.PackedProofs, the same on every
    rank. dedup=True hashes the (replicated) unique-node pool once per
    rank. Returns (status, values, value_lens, global_counts), numpy, on
    every rank."""
    active = np.ones(packed.batch, dtype=np.int32)
    if dedup:
        pool_nodes, pool_lens, pool_idx = packed.pool()
        arrays, b = pad_batch(packed.astuple() + (active, pool_idx), mesh.size)
        fn = make_sharded_verifier(mesh, max_value_len=max_value_len, pooled=True)
        out = fn(*arrays[:-1], pool_nodes, pool_lens, arrays[-1])
    else:
        arrays, b = pad_batch(packed.astuple() + (active,), mesh.size)
        fn = make_sharded_verifier(mesh, max_value_len=max_value_len)
        out = fn(*arrays)
    status, values, vlens, counts = _host(*out)
    return status[:b], values[:b], vlens[:b], counts
