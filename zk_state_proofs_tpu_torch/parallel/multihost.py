"""Multi-process initialization over torch.distributed (port of
`zk_state_proofs_tpu.parallel.multihost`).

JAX's `jax.distributed.initialize` wires every process into one runtime
whose mesh spans all their devices. Here each process is one rank of a
torch.distributed process group and owns one device; `initialize()` joins
the group, after which `mesh.make_mesh()` spans every rank and the sharded
verify, storage, sweep and trie-root paths run unchanged. Every rank holds
the same full host batch, as every JAX process does: `put_global` takes a
rank's shard of it, `gather_to_host` gathers the shards back.

The caller names the backend: "nccl" for ranks on separate cards, "gloo"
on the CPU or for several ranks on one card (gloo's collectives take CUDA
tensors). The module never picks one itself. `run_ranks` spawns a local
group of n ranks, each with its own deadline.
"""

from __future__ import annotations

import datetime
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, backend: str,
               timeout_s: float = 600.0) -> dict:
    """dist.init_process_group over `backend` ("nccl" or "gloo"). The
    coordinator is "host:port" of rank 0's TCP store; without one, the
    address, world size and rank come from the environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK). Every collective of the group gives up
    after `timeout_s`. Returns topology()."""
    kwargs = {"timeout": datetime.timedelta(seconds=timeout_s)}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, **kwargs)
    return topology()


def topology() -> dict:
    """This process's place in the group: one device a rank, so the
    global device count is the world size."""
    on = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if on else 0,
        "process_count": dist.get_world_size() if on else 1,
        "local_devices": torch.cuda.device_count() if torch.cuda.is_available() else 1,
        "global_devices": dist.get_world_size() if on else 1,
        "backend": dist.get_backend() if on else None,
    }


def put_global(mesh, arr, spec) -> torch.Tensor:
    """This rank's part of a host array that every rank holds identically,
    as a tensor on the rank's device: with `spec` the mesh axis name, its
    contiguous shard of the leading dim (which must divide by the mesh
    size); with spec None, the whole array (replicated)."""
    arr = np.asarray(arr)
    if spec is not None:
        if spec != mesh.axis_names[0]:
            raise ValueError(f"spec {spec!r} is not the mesh axis {mesh.axis_names[0]!r}")
        arr = arr[mesh.shard(arr.shape[0])]
    # a writable C-ordered copy only where needed: the tensor may share it
    return torch.from_numpy(np.require(arr, requirements=("C", "W"))).to(mesh.device)


def gather_to_host(x: torch.Tensor, mesh=None) -> np.ndarray:
    """The shards `x` of every rank of `mesh` (default: the whole group),
    concatenated along the leading dim, as host numpy on every rank. No
    collective for a single process."""
    if mesh is not None:
        return mesh.all_gather(x).cpu().numpy()
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x.cpu().numpy()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts).cpu().numpy()


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for a local group's store."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, backend, port, fn, args, queue, timeout_s):
    try:
        initialize(f"127.0.0.1:{port}", world, rank, backend=backend, timeout_s=timeout_s)
        try:
            queue.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, backend: str, args=(), timeout_s: float = 600.0) -> list:
    """Run fn(*args) in `world` spawned processes, ranks of one local group
    over `backend` (a store on 127.0.0.1), and return each rank's result in
    rank order. `fn` must be importable by the children (spawn, never fork:
    a forked child cannot use a CUDA context its parent made). The ranks
    must finish within `timeout_s`, and each collective gives up after it
    too. The first rank that fails or dies is reported, the others are
    stopped, and no child outlives this call."""
    import multiprocessing as mp
    import queue as queue_mod
    import time

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, port, fn, args, q, timeout_s),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world - len(results)} of {world} ranks ran past "
                                   f"{timeout_s} s")
            try:
                rank, ok, out = q.get(timeout=2.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (0, None)]
                if dead:
                    raise RuntimeError(f"ranks {dead} died, exit codes "
                                       f"{[procs[r].exitcode for r in dead]}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10.0 if len(results) == world else 0.5)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
