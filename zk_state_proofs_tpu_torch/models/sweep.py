"""Large verification sweeps — the 1M-proof workload (BASELINE config 5);
port of `zk_state_proofs_tpu.models.sweep`.

Five forms, each returning the JAX function's counts, `total` and
`batches`:

  sweep                  PackedProofs batches, each copied to the card;
  sweep_resident         a witness set hashed once and kept on the card,
                         each batch a set of row indices (materialized
                         per-proof tables, or row gathers from the pool);
  sweep_resident_epochs  contiguous windows over the materialized tables,
                         each epoch distinct work (a counter byte);
  sweep_entries          raw entries packed on a worker thread while the
                         card verifies, copied through pinned memory;
  replicated_batches     the same batch n times (a synthetic driver).

The resident sweeps upload the witness (its pool and per-proof scalars)
anew on every call, and on a CUDA device copy it from page-locked host
memory: the first call on a witness stages its upload arrays once into a
page-locked block held on the witness (`_pinned_staging`), so each call's
copy is a direct DMA at the bus's rate, not CUDA's bounce through a
small pinned buffer. Nothing is kept on the card between calls.

Per-batch statuses are reduced to counts on the card, into one int64 [3]
tensor (FOUND, EXCLUDED, INVALID) read once at the end: the batch loops
read nothing back, so launches queue with no sync between batches (the
`exact` re-run is decided on the card too, by a flag that the first walk
records: `ops.mpt_cuda.rerun_exact`).
`forbid_sync=True` runs a loop under torch.cuda.set_sync_debug_mode
("error"), so a sync there raises. K2 still writes each proof's value
(max_value_len bytes); only statuses are counted, so every rate of a
sweep is a `counts_only` rate.

Every entry point takes a `device`: "cuda" unless named (kernels K1 and
K2; raises without a card), "cpu" for their plain versions. `sweep`,
`sweep_resident_epochs` and `sweep_entries` take a `mesh`
(parallel.make_mesh): every rank runs the same call on the same host
witness, verifies its share of each batch on its own device (the mesh's,
whose type `device` must name), and the counts are summed over the ranks
with one all_reduce at the end.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import mmap
import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import mpt
from ..ops.rlp import item_offsets
from ..utils.device import resolve_device
from ..utils.profiling import Meter, span
from ..witness.pack import PackedProofs, pack_proofs

_CODES = (mpt.FOUND, mpt.EXCLUDED, mpt.INVALID)


@dataclass
class SweepResult:
    total: int
    found: int
    excluded: int
    invalid: int
    seconds: float
    # the streamed sweep's breakdown (sweep_entries): the worker thread's
    # packing time (overlapped with the card's work), the time spent
    # queueing batches, and the time of the final read of the counts; the
    # resident sweeps report the one-time upload, hash and table build as
    # pack_seconds
    pack_seconds: float = 0.0
    dispatch_seconds: float = 0.0
    drain_seconds: float = 0.0
    batches: int = 0
    # the resident sweeps: the bytes of the witness upload that this call
    # copied to the card from page-locked host memory (0 on the CPU)
    pinned_upload_bytes: int = 0

    @property
    def proofs_per_sec(self) -> float:
        return self.total / max(self.seconds, 1e-9)


class _Counts:
    """FOUND / EXCLUDED / INVALID counts accumulated on the device, summed
    over the ranks of `mesh` (where given) when read."""

    def __init__(self, dev, mesh=None):
        self.acc = torch.zeros(3, dtype=torch.int64, device=dev)
        self.codes = torch.tensor(_CODES, dtype=torch.int32, device=dev)
        self.mesh = mesh

    def add(self, status, active=None) -> None:
        """Count `status`; with `active` (a tensor, one entry a row), only
        the rows where it is > 0 (padding rows stay out)."""
        hit = status[:, None] == self.codes
        if active is not None:
            hit &= (active > 0)[:, None]
        self.acc.add_(hit.sum(0))

    def read(self) -> np.ndarray:
        if self.mesh is not None:
            self.mesh.all_reduce_sum(self.acc)  # the one collective
        return self.acc.cpu().numpy()  # the one read back


@contextlib.contextmanager
def _sync_check(on: bool, dev):
    """torch.cuda.set_sync_debug_mode("error") inside, where on and dev is a
    CUDA device: any sync in the block raises."""
    if not (on and dev.type == "cuda"):
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _result(totals, total, seconds, meter, **times) -> SweepResult:
    if meter is not None:
        meter.record(total, 0, 0, seconds)
    return SweepResult(total=total, found=int(totals[0]), excluded=int(totals[1]),
                       invalid=int(totals[2]), seconds=seconds, **times)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sweep(batches, mesh=None, max_value_len: int = 128, max_steps=None,
          meter: Meter | None = None, dedup: bool = True,
          device="cuda") -> SweepResult:
    """Verify an iterable of PackedProofs (one bucket geometry), each
    copied to `device`. dedup=True hashes each batch's unique-node pool
    once (`verify_proofs_pooled`, hinted with the device hint pass, as the
    JAX function's pool carries no hints); dedup=False walks every node
    row (`verify_proofs`). With a mesh, each batch is padded to the mesh
    size and sharded over the ranks (parallel.mesh.verify_local), the pool
    replicated. Returns the counts and the wall time."""
    from ..parallel.mesh import local_mesh, local_share, verify_local

    dev = resolve_device(device, mesh)
    mesh = mesh if mesh is not None else local_mesh(dev)
    counts = _Counts(dev, mesh)
    total = nbatches = 0
    t0 = time.perf_counter()
    for packed in batches:
        pool = packed.pool() if dedup else ()
        share, active = local_share(mesh, packed.astuple() + pool[2:])
        status, _, _ = verify_local(mesh, share[:6], pool[:2] + share[6:],
                                    max_value_len, max_steps)
        counts.add(status, torch.from_numpy(active).to(dev))
        total += packed.batch
        nbatches += 1
    totals = counts.read()
    return _result(totals, total, time.perf_counter() - t0, meter, batches=nbatches)


def replicated_batches(packed: PackedProofs, n: int):
    """Yield the same packed batch n times (a synthetic sweep driver)."""
    for _ in range(n):
        yield packed


# The witness upload, under _upload's names and in its dtypes: the pool
# (node bytes, lengths, each proof's pool rows) and the per-proof scalars.
_UPLOAD = (("pool", np.uint8), ("plens", np.int32), ("idx", np.int32), ("num", np.int32),
           ("roots", np.uint8), ("knib", np.uint8), ("klen", np.int32))


def _upload_arrays(global_packed: PackedProofs) -> tuple:
    """The witness's arrays that _upload copies, in _UPLOAD's order."""
    return (*global_packed.pool(), global_packed.num_nodes, global_packed.roots,
            global_packed.key_nibbles, global_packed.key_lens)


_MAP_FLAGS = mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS | getattr(mmap, "MAP_POPULATE", 0)


def _unregister(ptr: int) -> None:
    torch.cuda.cudart().cudaHostUnregister(ptr)


class _PinnedStaging:
    """Host arrays copied once into one page-locked block: an anonymous
    mapping of their bytes (each array 64-byte aligned), registered with
    CUDA (cudaHostRegister), so that a copy from it to the card
    is a direct DMA; unregistered when the staging is collected, before
    its mapping is freed. `sources`: the arrays staged; `tensors`: their
    page-locked copies, under _UPLOAD's names and in its dtypes.

    The mapping's pages are made when it is mapped (MAP_POPULATE): faulted
    in one by one by the copy, 2.2 GB took 5.4 s on an H100's host, against
    0.9 s populated, the registration included."""

    def __init__(self, arrays):
        self.sources = arrays
        sizes = [a.size * np.dtype(dt).itemsize for a, (_, dt) in zip(arrays, _UPLOAD)]
        offs = np.cumsum([0] + [-(-s // 64) * 64 for s in sizes]).tolist()
        self._map = mmap.mmap(-1, max(offs[-1], 1), flags=_MAP_FLAGS)
        block = np.frombuffer(self._map, dtype=np.uint8)
        self.tensors = {}
        for a, (name, dt), off, size in zip(arrays, _UPLOAD, offs, sizes):
            view = block[off:off + size].view(dt).reshape(a.shape)
            view[...] = a
            self.tensors[name] = torch.from_numpy(view)
        ptr = block.ctypes.data
        torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(ptr, block.nbytes, 0))
        weakref.finalize(self, _unregister, ptr).atexit = False


def _pinned_staging(global_packed: PackedProofs, arrays) -> _PinnedStaging:
    """The page-locked staging of the witness's upload `arrays`: made by
    the first call on the witness (span `zkp.sweep.pin`) and held on it,
    so that it lives as long as the witness; made anew where an array is
    not the one staged (a rebuilt pool). A witness is not changed after it
    is packed (as its pool's memo assumes), so the staged bytes stay its
    bytes."""
    st = getattr(global_packed, "_upload_staging", None)
    if st is None or any(a is not s for a, s in zip(arrays, st.sources)):
        global_packed._upload_staging = None  # the old block goes first
        with span("zkp.sweep.pin"):
            st = _PinnedStaging(arrays)
        global_packed._upload_staging = st
    return st


def _upload(global_packed: PackedProofs, dev) -> dict:
    """The global witness on `dev`, in new device tensors: its pool, hashed
    once (K1), the pool index and the per-proof scalars; `pinned_bytes`,
    the bytes copied from page-locked host memory.

    On a CUDA device every copy comes from page-locked memory: the
    witness's own arrays where they are page-locked already, else their
    staging (_pinned_staging), which the first call on the witness makes.
    The copies are queued without a sync, and the span `zkp.sweep.upload`
    ends with one sync of the stream, so that it times the transfer to its
    end. On the CPU the arrays are used as they are (`pinned_bytes` 0)."""
    arrays = _upload_arrays(global_packed)
    host = {name: torch.from_numpy(np.ascontiguousarray(a, dtype=dt))
            for a, (name, dt) in zip(arrays, _UPLOAD)}
    pinned = dev.type == "cuda"
    if pinned and not all(h.is_pinned() for h in host.values()):
        host = _pinned_staging(global_packed, arrays).tensors
    with span("zkp.sweep.upload"):
        r = {k: h.to(dev, non_blocking=pinned) for k, h in host.items()}
        if pinned:
            torch.cuda.current_stream(dev).synchronize()
    r["pinned_bytes"] = sum(h.nbytes for h in host.values()) if pinned else 0
    r["dig"] = mpt.hash_pool(r["pool"], r["plens"])
    return r


def _expand_tables(r: dict):
    """The per-proof tables of every proof of the witness set, expanded
    once from the hashed pool by one row gather each: nodes u8 [A, D*N],
    lens i32 [A, D], and digests with the hints of the device hint pass
    (rlp.item_offsets, once per pool row) u8 [A, D*68]. The digests come
    from hashing the same pool rows the node bytes are gathered from."""
    a, dd = r["idx"].shape
    n = r["pool"].shape[1]
    with span("zkp.sweep.expand"):
        flat = r["idx"].reshape(-1).to(torch.int64)
        payload = torch.cat([r["dig"], item_offsets(r["pool"])], dim=1)  # [U, 68]
        return (torch.index_select(r["pool"], 0, flat).reshape(a, dd * n),
                torch.index_select(r["plens"], 0, flat).reshape(a, dd),
                torch.index_select(payload, 0, flat).reshape(a, dd * 68))


def _verify_sel(sel, r: dict, tables, max_value_len, max_steps, dev):
    """Statuses of the witness rows `sel` (i64 [B] on the device): the
    prehashed walk over rows of the materialized tables, or, without
    tables, the indexed verify over pool row gathers with the pack-time
    hints."""
    def take(x):
        return torch.index_select(x, 0, sel)

    if tables is not None:
        nodes2, lens, dh2 = tables
        b, dd = sel.shape[0], lens.shape[1]
        dh = take(dh2).reshape(b, dd, 68)
        status, _, _ = mpt.verify_proofs_prehashed(
            take(nodes2).reshape(b, dd, -1), take(lens), take(r["num"]), dh[..., :32],
            take(r["roots"]), take(r["knib"]), take(r["klen"]), hints=dh[..., 32:],
            max_value_len=max_value_len, max_steps=max_steps, device=dev)
    else:
        status, _, _ = mpt.verify_proofs_indexed(
            r["pool"], r["plens"], r["dig"], take(r["idx"]), take(r["num"]),
            take(r["roots"]), take(r["knib"]), take(r["klen"]), pool_hints=r["hints"],
            max_value_len=max_value_len, max_steps=max_steps, device=dev)
    return status


def _to_device(a, dtype, dev):
    """A host array on `dev`: through pinned memory, without a sync, on a
    CUDA device (the caching host allocator reuses a pinned block only
    after its copy has finished)."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def sweep_resident(global_packed: PackedProofs, index_batches,
                   max_value_len: int = 128, max_steps=None,
                   meter: Meter | None = None, fused: bool = False,
                   materialize: bool | None = None, device="cuda",
                   forbid_sync: bool = False) -> SweepResult:
    """A sweep over a witness set resident on the card: the global witness
    is uploaded and its pool hashed once; each batch is a set of row
    indices (i32 [B]) into it.

    materialize=True (the default where the node table A*D*N fits in
    2 GiB) expands the pool once into per-proof tables, and each batch is
    a gather of B proof rows and the prehashed walk, hinted with the
    device hint pass's hints; materialize=False gathers each batch's node
    rows from the pool (`verify_proofs_indexed`, the pack-time hints).

    fused=True uploads every batch's indices as one [nbatches, B] table
    and queues every batch with no host work between them but launches;
    the batches must have one length. Otherwise each batch's indices are
    copied through pinned memory. Either way nothing is read back until
    the end. The witness is uploaded by every call, on a card from its
    page-locked staging (_upload). pack_seconds is the upload, the hash
    and the table build; dispatch_seconds the time spent queueing the
    batches; pinned_upload_bytes the witness's bytes copied from
    page-locked memory."""
    dev = resolve_device(device)
    tp = time.perf_counter()
    r = _upload(global_packed, dev)
    a, dd = r["idx"].shape
    if materialize is None:
        materialize = a * dd * r["pool"].shape[1] <= 2 << 30
    if materialize:
        tables = _expand_tables(r)
    else:
        tables = None
        r["hints"] = torch.from_numpy(global_packed.pool_hints()).to(dev)
    _sync(dev)
    pack_s = time.perf_counter() - tp
    counts = _Counts(dev)
    kw = dict(max_value_len=max_value_len, max_steps=max_steps, dev=dev)
    t0 = time.perf_counter()
    if fused:  # one upload; the batches are its rows
        index_batches = torch.from_numpy(
            np.stack([np.asarray(s, dtype=np.int64) for s in index_batches])).to(dev)
    total = nbatches = 0
    dispatch_s = 0.0
    with _sync_check(forbid_sync, dev):
        for sel in index_batches:
            td = time.perf_counter()
            if not fused:
                sel = _to_device(sel, np.int64, dev)
            counts.add(_verify_sel(sel, r, tables, **kw))
            dispatch_s += time.perf_counter() - td
            total += sel.shape[0]
            nbatches += 1
    td = time.perf_counter()
    totals = counts.read()
    drain_s = time.perf_counter() - td
    return _result(totals, total, time.perf_counter() - t0, meter, pack_seconds=pack_s,
                   dispatch_seconds=dispatch_s, drain_seconds=drain_s, batches=nbatches,
                   pinned_upload_bytes=r["pinned_bytes"])


def epoch_windows(rows: int, batch: int) -> np.ndarray:
    """The start rows of one epoch's contiguous windows: ceil(rows / batch)
    windows of `batch` rows, the last one clamped to end at the last row
    (its overlap with the one before is verified twice)."""
    per_epoch = -(-rows // batch)
    return np.minimum(np.arange(per_epoch) * batch, rows - batch)


def sweep_resident_epochs(global_packed: PackedProofs, epochs: int, batch: int,
                          max_value_len: int = 128, max_steps=None, salt: int = 0,
                          meter: Meter | None = None, mesh=None, device="cuda",
                          forbid_sync: bool = False) -> SweepResult:
    """`epochs` passes over the resident witness set in contiguous
    `batch`-row windows (epoch_windows) of the materialized tables: no row
    gathers, each batch a view of the tables walked in place.

    Each call builds the tables anew (epoch_tables): on a card the witness
    is copied from page-locked memory, staged once per witness by its
    first call (`zkp.sweep.pin`), so a later call's copy is a direct DMA.
    pack_seconds times the whole build, the staging and the copy included;
    pinned_upload_bytes is the upload's bytes on a card, 0 on the CPU.

    With a mesh (n ranks), every rank builds the tables of its own A/n
    rows only (the pool is hashed whole on every rank) and sweeps them in
    windows of batch/n rows (epoch_windows per shard, the tail clamped
    per shard); the counts are summed over the ranks once, at the end.
    Requires A % n == 0 and batch % n == 0. Window coverage per epoch is
    identical to one rank's (each row verified once; tail overlap is per
    shard), and `total` counts every window row of every rank.

    Every epoch is distinct work: before a window is walked, byte N - 1 of
    each of its node rows is set to the epoch counter (salt + e) & 0xFF,
    as the JAX function sets it in its copy of the window. The port writes
    it into the resident table itself, which this call built and owns; the
    result is the same, since every window is written before it is walked.
    The digests and hints come from the unperturbed rows: the walk never
    reads byte N - 1 of a node shorter than N; a node exactly N bytes long
    is walked with its last byte replaced, in both packages alike (where
    that breaks its hints, the walk latches and re-runs in `exact`)."""
    from ..parallel.mesh import local_mesh

    dev = resolve_device(device, mesh)
    mesh = mesh if mesh is not None else local_mesh(dev)
    a, n = global_packed.batch, mesh.size
    if batch > a:
        raise ValueError(f"batch {batch} exceeds global rows {a}")
    if a % n or batch % n:
        raise ValueError(f"rows {a} and batch {batch} must divide the mesh ({n})")
    with span("zkp.sweep"):
        tp = time.perf_counter()
        with span("zkp.sweep.tables"):
            t = epoch_tables(global_packed, dev, rows=mesh.shard(a))
            _sync(dev)
        pack_s = time.perf_counter() - tp
        b_local = batch // n
        starts = [int(s) for s in epoch_windows(a // n, b_local)]
        counts = _Counts(dev, mesh)
        t0 = time.perf_counter()
        with span("zkp.sweep.windows"), _sync_check(forbid_sync, dev):
            for e in range(epochs):
                for s0 in starts:
                    with span("zkp.sweep.window"):
                        counts.add(epoch_batch(t, s0, b_local, (salt + e) & 0xFF, max_value_len,
                                               max_steps, dev)[0])
        dispatch_s = time.perf_counter() - t0
        with span("zkp.sweep.drain"):
            totals = counts.read()
        dt = time.perf_counter() - t0
    return _result(totals, epochs * len(starts) * batch, dt, meter, pack_seconds=pack_s,
                   dispatch_seconds=dispatch_s, drain_seconds=dt - dispatch_s,
                   batches=epochs * len(starts), pinned_upload_bytes=t["pinned_bytes"])


def epoch_tables(global_packed: PackedProofs, dev, rows: slice | None = None) -> dict:
    """The epoch sweep's tables on `dev`: the witness uploaded (_upload:
    on a card from its page-locked staging), its pool hashed, the
    per-proof tables expanded (nodes u8 [A, D, N], lens i32 [A, D],
    digests and hints u8 [A, D, 68]) and the per-proof scalars; with
    `rows`, the tables and scalars of those witness rows only (a rank's
    shard), against the whole pool. `pinned_bytes`: the upload's bytes
    copied from page-locked memory."""
    r = _upload(global_packed, dev)
    if rows is not None:
        for k in ("idx", "num", "roots", "knib", "klen"):
            r[k] = r[k][rows]
    a, dd = r["idx"].shape
    nodes2, lens, dh2 = _expand_tables(r)
    return {"nodes": nodes2.view(a, dd, -1), "lens": lens, "dh": dh2.view(a, dd, 68),
            "num": r["num"], "roots": r["roots"], "knib": r["knib"], "klen": r["klen"],
            "pinned_bytes": r["pinned_bytes"]}


def epoch_batch(t: dict, s0: int, batch: int, ctr: int, max_value_len: int = 128,
                max_steps=None, dev="cuda"):
    """One window of the epoch sweep: rows s0 .. s0 + batch of the tables
    `t` (epoch_tables), byte N - 1 of each node row set to `ctr` in place,
    walked in `hinted` mode. Returns (status i32 [batch], values u8
    [batch, max_value_len], value_lens i32 [batch])."""
    w = slice(s0, s0 + batch)
    nodes = t["nodes"]
    nodes[w, :, nodes.shape[2] - 1] = ctr
    dh = t["dh"][w]
    return mpt.verify_proofs_prehashed(
        nodes[w], t["lens"][w], t["num"][w], dh[..., :32], t["roots"][w], t["knib"][w],
        t["klen"][w], hints=dh[..., 32:], max_value_len=max_value_len,
        max_steps=max_steps, device=dev)


def sweep_entries(entry_batches, max_nodes: int, node_len: int,
                  key_nibbles: int = 64, max_value_len: int = 128, max_steps=None,
                  dedup: bool = True, prefetch: int = 2, pool_rows: int = 0,
                  mesh=None, meter: Meter | None = None, device="cuda",
                  forbid_sync: bool = False) -> SweepResult:
    """The streamed sweep, host packing included: `entry_batches` yields
    lists of raw (root, proof_nodes, key) entries. A one-worker thread
    pool packs up to `prefetch` batches ahead (the native packer, which
    releases the GIL, and the unique-node pool) into pinned host tensors,
    while the card verifies the batch before; each batch's copy to the
    card is queued without a sync. dedup=True ships the pool alone
    (`verify_proofs_pool_stream`: the node tables are gathered on the
    card); pass pool_rows (a fixed pool-row bucket) to keep one pool
    shape. dedup=False ships the [B, D, N] tables (`verify_proofs`).
    With a mesh, every rank packs the same batch and ships its share of
    the proofs (the batch padded to the mesh size; the pool replicated),
    and the counts of the active rows are summed over the ranks at the end.

    pack_seconds: the worker's packing time (overlapped with the card);
    dispatch_seconds: the main thread's time queueing batches, waits for
    the worker included; drain_seconds: the final read of the counts."""
    from ..parallel.mesh import local_mesh, local_share

    dev = resolve_device(device, mesh)
    mesh = mesh if mesh is not None else local_mesh(dev)
    pack_time = [0.0]
    fields = ((np.uint8, np.int32, np.int32, np.int32, np.uint8, np.uint8, np.int32)
              if dedup else (np.uint8, np.int32, np.int32, np.uint8, np.uint8, np.int32))
    fields += (np.int32,)  # the active mask

    def pack_one(entries):
        t0 = time.perf_counter()
        packed = pack_proofs(entries, max_nodes=max_nodes, node_len=node_len,
                             key_nibbles=key_nibbles)
        arrays = ((*packed.pool(min_rows=pool_rows), packed.num_nodes, packed.roots,
                   packed.key_nibbles, packed.key_lens) if dedup else packed.astuple())
        lead = 2 if dedup else 0  # this rank's proofs: pool rows stay whole
        share, active = local_share(mesh, arrays[lead:])
        arrays = arrays[:lead] + share + (active,)
        host = [torch.from_numpy(np.ascontiguousarray(x, dtype=t))
                for x, t in zip(arrays, fields)]
        if dev.type == "cuda":
            host = [h.pin_memory() for h in host]
        pack_time[0] += time.perf_counter() - t0
        return packed.batch, host

    fn = mpt.verify_proofs_pool_stream if dedup else mpt.verify_proofs
    kw = dict(max_value_len=max_value_len, max_steps=max_steps)
    if dedup:
        kw["device"] = dev
    counts = _Counts(dev, mesh)
    total = nbatches = 0
    dispatch_s = 0.0
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=1) as pool_exec, _sync_check(forbid_sync, dev):
        it = iter(entry_batches)
        inflight = []
        for _ in range(prefetch):
            entries = next(it, None)
            if entries is None:
                break
            inflight.append(pool_exec.submit(pack_one, entries))
        while inflight:
            td = time.perf_counter()
            b, host = inflight.pop(0).result()
            entries = next(it, None)
            if entries is not None:
                inflight.append(pool_exec.submit(pack_one, entries))
            args = [h.to(dev, non_blocking=True) for h in host]
            counts.add(fn(*args[:-1], **kw)[0], args[-1])
            dispatch_s += time.perf_counter() - td
            total += b
            nbatches += 1
    td = time.perf_counter()
    totals = counts.read()
    drain_s = time.perf_counter() - td
    return _result(totals, total, time.perf_counter() - t0, meter,
                   pack_seconds=pack_time[0], dispatch_seconds=dispatch_s,
                   drain_seconds=drain_s, batches=nbatches)
