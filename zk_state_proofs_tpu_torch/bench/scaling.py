"""Scaling of the sharded layer over cards: proofs/s at mesh sizes 1, 2, 4, ...
up to the card count. The port's counterpart of the JAX package's
`bench_scaling.py` (`:1-125`).

    python -m zk_state_proofs_tpu_torch.bench.scaling

Each size n runs n processes, one card a rank, in one NCCL group
(parallel.multihost.run_ranks). Every rank holds the same 4096-proof
headline batch (bench.headline.build_witness_batch) and runs:

  sweep          `sweep(replicated_batches(batch, 8), mesh=)` after one
                 warm-up batch: each batch sharded over the ranks, the
                 counts summed (`bench_scaling.py:84-92`);
  sharded        the sharded pooled verifier (make_sharded_verifier),
                 CUDA events around back-to-back calls on host arrays
                 whose padding byte takes a counter, every status and value
                 folded and checked (`bench_scaling.py:26-63`).

Prints one JSON line per size on stderr and a summary line on stdout.
`efficiency` is proofs/s at n over n times proofs/s at 1, and is printed
only for sizes that ran: on one card only n = 1 runs, and the summary
says so.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models import replicated_batches, sweep
from ..ops import mpt
from ..ops._build import load_library
from ..parallel.multihost import run_ranks
from .common import Step, card_info, emit, log, perturb, require, value_word, wall_ms
from .headline import BATCH, build_witness_batch

SWEEP_BATCHES = 8
ITERS = 11   # back-to-back sharded calls a timed rep
REPS = 2
RANK_TIMEOUT_S = 600


def _rank(packed):
    """One rank's share of a size's run (spawned by run_ranks)."""
    from ..parallel import make_mesh
    from ..parallel.mesh import make_sharded_verifier

    mesh = make_mesh()
    dev = mesh.device
    sweep(replicated_batches(packed, 1), mesh=mesh, device=dev)  # warm-up
    res = sweep(replicated_batches(packed, SWEEP_BATCHES), mesh=mesh, device=dev)
    require(res.found == res.total, f"sweep: {res.found} of {res.total} FOUND")

    fn = make_sharded_verifier(mesh, max_value_len=128, pooled=True)
    args = [a.copy() for a in packed.astuple()]
    pool = [a.copy() for a in packed.pool()]
    active = np.ones(packed.batch, np.int32)

    def call(ctr):
        perturb(ctr, args[0], pool[0])  # host arrays: each call uploads its share
        return fn(*args, active, *pool)[:3]

    status, values, lens = call(0)
    require(bool((status == mpt.FOUND).all()), "sharded verify: a proof not FOUND")
    runs = Step(call, packed.batch, dev).timed(
        wall_ms, ITERS, REPS, value_word(values, lens), f"rank {mesh.rank} sharded")
    return {"rank": mesh.rank, "device": str(dev), "sweep_proofs_per_sec": res.proofs_per_sec,
            "sweep_found": res.found, "sweep_total": res.total,
            "sharded_ms_runs": runs, "sharded_ms_per_batch": min(runs)}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    card = card_info()
    ndev = torch.cuda.device_count()
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= ndev]
    packed = build_witness_batch(BATCH, BATCH)
    packed.pool()
    load_library()  # built once here, so that the ranks only load it
    results, base = {}, None
    for n in sizes:
        ranks = run_ranks(_rank, n, "nccl", (packed,), timeout_s=RANK_TIMEOUT_S)
        for r in ranks:
            require(r["sweep_found"] == r["sweep_total"], f"n={n} rank {r['rank']}: not FOUND")
        # every rank times the same calls; the slowest sets the rate
        pps = min(r["sweep_proofs_per_sec"] for r in ranks)
        sharded_ms = max(r["sharded_ms_per_batch"] for r in ranks)
        base = pps if base is None else base
        results[n] = {"proofs_per_sec": round(pps, 1), "efficiency": round(pps / (base * n), 3),
                      "sharded_proofs_per_sec": round(BATCH / sharded_ms * 1e3, 1),
                      "ranks": ranks}
        log(json.dumps({"devices": n, **results[n]}))
    note = ("one card: only n = 1 ran, so there is no efficiency figure beyond it"
            if sizes == [1] else f"sizes {sizes} over {ndev} cards of one host")
    emit(metric="scaling_proofs_per_sec", devices=sizes, results=results, batch=BATCH,
         sweep_batches=SWEEP_BATCHES, note=note, card=card["nvidia_smi"],
         device={"kind": card["kind"], "count": card["count"]}, ok=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
