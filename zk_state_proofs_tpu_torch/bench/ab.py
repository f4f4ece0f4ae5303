"""In-process A/B runs on one card, variants timed in turns. The port's
counterpart of the JAX package's `analysis/ab_walk.py` (`:1-140`) and
`analysis/ab_keccak.py` (`:1-201`).

    python -m zk_state_proofs_tpu_torch.bench.ab [--walk V ...] [--keccak V ...]
                                                 [--reps N]

  walk     verify_proofs_pooled on the headline batch (bench.headline,
           4096 distinct accounts) in K2's hint modes. A variant joins parts
           with "+": a mode (hinted, hinted4, hinted1, ordered, pairskip),
           `seg` (the depth segments) and `ps` (the pool segments); default
           every mode alone. Each call perturbs the padding and folds every
           status and value, checked after each timed run.
  keccak   K1 over the headline batch's unique-node pool (`ab_keccak.py:20-29`):
             base     the pool at its bucket width, one launch;
             tight    the rows trimmed to the longest row (rounded to 8);
             seg      one launch per run of equal block count, each at its
                      own width (PackedProofs.pool_block_segments(tile=1));
             pad128k  the pool tiled to 131,072 rows at the bucket width.
           Each call writes a counter into byte 0 of every row; seg's and
           base's digests are held equal, and base against the plain keccak;
           every timed call's first digests are held against the plain
           keccak of its rows (bench.common.HashStep).

Device time a call from CUDA events around calls queued behind a spin
kernel (bench.common.device_ms), the variants in turns: forward then
backward each rep (A, B, B, A), `--reps` reps, the best rep of each
variant. Prints one JSON line per harness on stdout. Only the differences
between variants of one run mean anything; compare runs on other cards
not at all.

`analysis/op_count.py`, which counts TPU lane operations in jaxprs, has no
port: the kernels' operation and byte counts are bench.common's bounds.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import keccak, keccak_cuda, mpt
from ..ops.mpt import HINT_MODES
from ..witness_bridge import packed_to_tensors
from .common import (HashStep, Step, card_info, device_ms, emit, in_turns, log, pooled_call,
                     read_counts, require, require_card, value_word, zero_counts)
from .headline import BATCH, build_witness_batch

ITERS = 11     # calls queued a timed run
PAD_ROWS = 131072
KECCAK_VARIANTS = ("base", "tight", "seg", "pad128k")


def walk_variant(packed, t, variant: str):
    """call(ctr) for one `ab_walk.py` variant (`:39-68`): the counter into
    the padding, then verify_proofs_pooled in the variant's hint mode, with
    the depth segments where it names `seg`, the pool segments where `ps`."""
    parts = variant.split("+")
    modes = [p for p in parts if p in HINT_MODES]
    require(len(modes) <= 1 and all(p in HINT_MODES or p in ("seg", "ps") for p in parts),
            f"walk variant {variant!r}: parts are one of {HINT_MODES}, seg and ps")
    kw = {"hint_mode": modes[0] if modes else None}
    if "seg" in parts:
        kw["depth_segments"] = packed.depth_segments()
    if "ps" in parts:
        kw["pool_segments"] = packed.pool_block_segments()
    return pooled_call(t, max_value_len=128, max_steps=packed.nodes.shape[1], **kw)


def ab_walk(packed, variants, reps: int, dev) -> dict:
    t = packed_to_tensors(packed, dev)
    timed = {}
    for v in variants:
        call = walk_variant(packed, t, v)
        status, values, lens = call(0)
        require(bool((status == mpt.FOUND).all()), f"[{v}] a proof not FOUND")
        step, once = Step(call, packed.batch, dev), value_word(values, lens)
        timed[v] = lambda step=step, once=once, v=v: step.timed(
            device_ms, ITERS, 1, once, f"walk [{v}]")[0]
    runs = in_turns(timed, 2 * reps)
    for v, r in runs.items():
        log(f"walk [{v}]: best {min(r):.4f} ms/batch ({packed.batch / min(r) * 1e3:,.0f} "
            f"proofs/s), runs {[round(x, 4) for x in r]}")
    return runs


def keccak_variant(pn, pl, variant: str, psegs):
    """(rows, lens, fn(rows) -> digests) for one `ab_keccak.py` variant
    (`:114-151`)."""
    if variant == "base":
        return pn, pl, lambda d: keccak_cuda.keccak256_cuda(d, pl)
    if variant == "tight":
        w = -(-int(pl.max()) // 8) * 8
        return pn[:, :w].contiguous(), pl, lambda d: keccak_cuda.keccak256_cuda(d, pl)
    if variant == "seg":
        return pn, pl, lambda d: mpt._hash_pool_rows(d, pl, psegs)
    if variant == "pad128k":
        reps = -(-PAD_ROWS // pn.shape[0])
        lens = pl.repeat(reps)[:PAD_ROWS].contiguous()
        return (pn.repeat(reps, 1)[:PAD_ROWS].contiguous(), lens,
                lambda d: keccak_cuda.keccak256_cuda(d, lens))
    raise ValueError(f"keccak variant {variant!r}: one of {KECCAK_VARIANTS}")


def ab_keccak(packed, variants, reps: int, dev) -> dict:
    pool_nodes, pool_lens, _ = packed.pool()
    pn = torch.from_numpy(pool_nodes.copy()).to(dev)
    pl = torch.from_numpy(pool_lens.astype(np.int32)).to(dev)
    psegs = packed.pool_block_segments(tile=1)
    base = keccak_cuda.keccak256_cuda(pn, pl)
    require(torch.equal(base, keccak.keccak256(pn, pl)), "K1 differs from the plain keccak")
    require(torch.equal(mpt._hash_pool_rows(pn, pl, psegs), base),
            "the segmented pool hash differs from one launch")
    timed, rows = {}, {}
    for v in variants:
        data, lens, fn = keccak_variant(pn.clone(), pl, v, psegs)
        rows[v] = data.shape[0]
        step = HashStep(fn, data, lens, 0)

        def run(step=step, v=v):
            ms = device_ms(step, ITERS, dev)
            step.check(f"keccak [{v}]")
            return ms
        timed[v] = run
    runs = in_turns(timed, 2 * reps)
    real = int((pool_lens > 0).sum())
    for v, r in runs.items():
        log(f"keccak [{v}]: best {min(r):.4f} ms/call over {rows[v]} rows "
            f"({rows[v] / min(r) / 1e3:.1f} M rows/s), runs {[round(x, 4) for x in r]}")
    return {"runs": runs, "rows": rows, "real_rows": real, "segments": psegs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--walk", nargs="*", default=list(HINT_MODES),
                    help="walk variants (none: skip the walk A/B)")
    ap.add_argument("--keccak", nargs="*", default=list(KECCAK_VARIANTS),
                    help="keccak variants (none: skip the keccak A/B)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    card = card_info()
    dev = require_card()
    packed = build_witness_batch(BATCH, BATCH)
    common = dict(batch=BATCH, iters=ITERS, reps=args.reps,
                  timing="device ms a call, CUDA events behind a spin, in turns A B B A",
                  card=card["nvidia_smi"], device={"kind": card["kind"], "count": card["count"]})
    if args.walk:
        zero_counts()
        runs = ab_walk(packed, args.walk, args.reps, dev)
        emit(ab="walk", best_ms={v: min(r) for v, r in runs.items()}, runs=runs, **common,
             launches=read_counts(dev), ok=True)
    if args.keccak:
        zero_counts()
        out = ab_keccak(packed, args.keccak, args.reps, dev)
        emit(ab="keccak", best_ms={v: min(r) for v, r in out["runs"].items()}, **out, **common,
             launches=read_counts(dev), ok=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
