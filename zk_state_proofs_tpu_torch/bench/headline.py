"""The headline benchmark on the card: pooled MPT proof verification
throughput. The port's counterpart of the JAX package's `bench.py`, with
its function names (`bench.py:34-371`).

    python -m zk_state_proofs_tpu_torch.bench.headline

Prints ONE JSON line on stdout (diagnostics go to stderr):

  value                   proofs/s at the headline shape (4096 distinct
                          account proofs over a 4096-account trie, 576 B
                          nodes, depth-sorted, pack-time hints, depth and
                          pool segment schedules): CUDA events around
                          `ITERS` back-to-back steps, best of `REPS` runs,
                          the host's launch cost included (what a caller
                          gets);
  window_proofs_per_sec   the same over every timed step of every run;
  device_proofs_per_sec   the same steps queued behind a spin kernel
                          (utils.profiling.queued_timer): the card's time;
  bare_*                  the call alone, no counter and no fold, timed in
                          turns with the step (step, bare; bare, step; ...):
                          `harness_ms_per_batch` is the step's mean ms over
                          the window less the bare call's, the share of the
                          step's own launches in `value`;
  profile                 torch.profiler over 10 steps and 10 bare calls:
                          host ms, device busy ms and launches a call;
  hot_trie_*              the same at 512 accounts repeated 8x;
  resident_sweep_*        sweep_resident_epochs, 4096 accounts x 256
                          epochs (1,048,576 proofs), host clock to the one
                          read of the counts (a `counts_only` rate);
  keccak_*                K1's rate at 1-4 rate blocks (2^17 rows) and on
                          the headline batch's real pool;
  card, device            nvidia-smi's name and power limit, torch's name
                          and device count.

Every timed step is distinct work: a counter goes into the last padding
byte of every node row and pool row, and each call's status and value
word are folded into accumulators that the host reads and checks
(bench.common.Step). Each timed K1 call's first digests are held against
the plain keccak of its rows (bench.common.HashStep). Any failed check raises: the program exits non-zero and
prints no line. It needs a card; it prints no CPU rate.

The JAX figure is an in-graph loop's rate (`bench.py:138-164`) against a
TPU target (`vs_baseline`); this line has neither, and no figure of it is
compared with a TPU number.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import sweep_resident_epochs
from ..ops import keccak_cuda, mpt
from ..witness import pack_proofs
from ..witness_bridge import account_entries, packed_to_tensors
from .common import (RATE, HashStep, Step, busy_profile, card_info, device_ms, emit, in_turns,
                     log, pooled_args, pooled_call, read_counts, require, require_card,
                     value_word, wall_ms, zero_counts)

BATCH = 4096
HOT_ACCOUNTS = 512     # the hot-trie shape: 512 accounts, each proof 8 times
ITERS = 21             # back-to-back steps a wall-clock run
HOT_ITERS = 11
DEVICE_ITERS = 11      # steps queued behind the spin a device run
REPS = 3
PROFILE_ITERS = 10
SWEEP_EPOCHS = 256
KECCAK_ROWS = 1 << 17
KECCAK_BUCKETS = ((100, 1), (200, 2), (350, 3), (532, 4))  # (bytes, rate blocks)
KECCAK_ITERS = 32      # back-to-back K1 calls a bucket's run
REALMIX_ITERS = 64     # K1 calls queued a real-pool run
KECCAK_REPS = 2


def build_witness_batch(batch: int, n_accounts: int = 512):
    """Real account-trie witnesses (`bench.py:34-69`): proof i is that of
    account i % n_accounts of an n_accounts-account trie
    (witness_bridge.account_entries), the batch depth-sorted descending
    (deepest first, stable), packed at node_len 576. n_accounts == batch
    is the distinct headline shape; fewer repeats proofs (the hot trie)."""
    entries, leaves = account_entries(n_accounts)
    by_key = {e[2]: e for e in entries}
    keys = list(leaves)  # account order
    batch_entries = [by_key[keys[i % n_accounts]] for i in range(batch)]
    batch_entries.sort(key=lambda e: -len(e[1]))
    return pack_proofs(batch_entries, node_len=576)


def verify_kwargs(packed) -> dict:
    """bench.py's measured call's options (`bench.py:72-193`): values of
    128 B, max_steps the table depth, both segment schedules."""
    return dict(max_value_len=128, max_steps=packed.nodes.shape[1],
                depth_segments=packed.depth_segments(),
                pool_segments=packed.pool_block_segments())


def bench_verify(iters: int, n_accounts: int, label: str, device):
    """Pooled verification throughput for one batch shape (`bench.py:72-193`):
    BATCH proofs over an n_accounts-account trie (BATCH: the distinct
    headline, HOT_ACCOUNTS: the hot trie). The bench step and the bare
    call are timed in turns. Returns (figures, packed, (step, bare))."""
    dev = require_card(device)
    t0 = time.time()
    packed = build_witness_batch(BATCH, n_accounts)
    pool = packed.pool()
    dedup = float(packed.num_nodes.sum()) / max(float((pool[1] > 0).sum()), 1.0)
    kw = verify_kwargs(packed)
    log(f"[{label}] witness build: {time.time() - t0:.1f}s  nodes={packed.nodes.shape} "
        f"pool={pool[0].shape} ({n_accounts} accounts, dedup {dedup:.1f}x); depth segments "
        f"{kw['depth_segments']}, pool segments {kw['pool_segments']}")
    t = packed_to_tensors(packed, dev)
    call, args = pooled_call(t, **kw), pooled_args(t)
    status, values, lens = call(0)
    found = int((status == mpt.FOUND).sum())
    require(found == BATCH, f"[{label}] {found} of {BATCH} proofs FOUND")
    once = value_word(values, lens)
    step = Step(call, BATCH, dev)

    def bare(_i):
        mpt.verify_proofs_pooled(*args, **kw)

    runs = {**in_turns({"wall": lambda: step.timed(wall_ms, iters, 1, once, f"[{label}] wall")[0],
                        "bare": lambda: wall_ms(bare, iters, dev)}, REPS),
            **in_turns({"device": lambda: step.timed(device_ms, DEVICE_ITERS, 1, once,
                                                      f"[{label}] device")[0],
                        "bare_device": lambda: device_ms(bare, DEVICE_ITERS, dev)}, REPS)}
    best = {k: min(r) for k, r in runs.items()}
    mean = {k: sum(r) / len(r) for k, r in runs.items()}
    log(f"[{label}] {best['wall']:.4f} ms/batch -> {BATCH / best['wall'] * 1e3:,.0f} proofs/s; "
        f"device {best['device']:.4f} ms -> {BATCH / best['device'] * 1e3:,.0f} proofs/s; "
        f"bare call {best['bare']:.4f} ms, device {best['bare_device']:.4f} ms; runs {runs}")
    return {"proofs_per_sec": BATCH / best["wall"] * 1e3,
            "window_proofs_per_sec": BATCH / mean["wall"] * 1e3,
            "device_proofs_per_sec": BATCH / best["device"] * 1e3,
            "ms_per_batch": best["wall"], "device_ms_per_batch": best["device"],
            "bare_ms_per_batch": best["bare"], "bare_device_ms_per_batch": best["bare_device"],
            "harness_ms_per_batch": mean["wall"] - mean["bare"],
            "harness_device_ms_per_batch": mean["device"] - mean["bare_device"],
            "ms_runs": runs, "dedup_ratio": dedup, "batch": BATCH, "found": found,
            "folded_calls": step.ctr}, packed, (step, bare)


def bench_resident_sweep(packed, device):
    """The device-resident epoch sweep (`bench.py:196-223`) over the
    distinct headline witness set: one warm-up with another salt, then
    SWEEP_EPOCHS epochs, each distinct work by the counter byte. Returns
    (proofs/s, shape label, SweepResult)."""
    dev = require_card(device)
    d = packed.nodes.shape[1]
    kw = dict(max_steps=d, device=dev, forbid_sync=True)
    sweep_resident_epochs(packed, SWEEP_EPOCHS, BATCH, salt=0x80, **kw)
    res = sweep_resident_epochs(packed, SWEEP_EPOCHS, BATCH, salt=0, **kw)
    require(res.found == res.total, f"resident sweep: {res.found} of {res.total} FOUND")
    shape = f"{BATCH} accounts x {SWEEP_EPOCHS} epochs, depth {d}, one call"
    log(f"resident epoch sweep [{shape}]: {res.total:,} proofs in {res.seconds:.3f}s -> "
        f"{res.proofs_per_sec:,.0f} proofs/s (pack+upload {res.pack_seconds:.2f}s)")
    return res.proofs_per_sec, shape, res


def _hash_rate(rows, lens, byte, iters, timer, dev):
    """Best ms a call of K1 over `rows` of KECCAK_REPS runs, each call
    writing a counter into byte `byte` of every row; every timed call's
    first digests are held against the plain keccak (HashStep)."""
    step = HashStep(lambda r: keccak_cuda.keccak256_cuda(r, lens), rows, lens, byte)
    best = min(timer(step, iters, dev) for _ in range(KECCAK_REPS))
    step.check("K1")
    return best


def bench_keccak_bucket(length: int, device):
    """One message-length bucket of the keccak figures (`bench.py:226-256`):
    KECCAK_ROWS random rows of `length` bytes, each hashed whole, the last
    byte a counter. CUDA events around back-to-back calls. Returns
    (hashes/s, bytes/s)."""
    dev = require_card(device)
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.integers(0, 256, (KECCAK_ROWS, length), dtype=np.uint8)).to(dev)
    lens = torch.full((KECCAK_ROWS,), length, dtype=torch.int32, device=dev)
    ms = _hash_rate(rows, lens, -1, KECCAK_ITERS, wall_ms, dev)
    return KECCAK_ROWS / ms * 1e3, KECCAK_ROWS * length / ms * 1e3


def bench_keccak_realmix(packed, device):
    """K1 on the real length mix the verifier hashes (`bench.py:259-304`):
    the headline batch's length-sorted pool in one launch, byte 0 of every
    row a counter. Device time (queued CUDA events), real rows a second."""
    dev = require_card(device)
    pool_nodes, pool_lens, _ = packed.pool()
    rows = torch.from_numpy(pool_nodes.copy()).to(dev)
    lens = torch.from_numpy(pool_lens.astype(np.int32)).to(dev)
    real = int((pool_lens > 0).sum())
    ms = _hash_rate(rows, lens, 0, REALMIX_ITERS, device_ms, dev)
    rate = real / ms * 1e3
    log(f"keccak diag [real pool mix: {real} rows of {rows.shape[0]} incl. padding, "
        f"{int(pool_lens.sum())} B, {int((pool_lens // RATE + 1).sum())} rate blocks]: "
        f"{rate / 1e6:.1f} M hashes/s ({int(pool_lens.sum()) / ms / 1e6:.2f} GB/s)")
    return rate


def bench_keccak(device):
    """K1's rate by rate-block count (`bench.py:307-325`): {blocks: (hashes/s,
    bytes/s)}."""
    out = {}
    for length, blocks in KECCAK_BUCKETS:
        out[blocks] = bench_keccak_bucket(length, device)
        log(f"keccak diag [{blocks} block(s), {length} B]: {out[blocks][0] / 1e6:.1f} M "
            f"hashes/s ({out[blocks][1] / 1e9:.2f} GB/s)")
    return out


def _profile(fn, dev) -> dict:
    prof = busy_profile(fn, PROFILE_ITERS, dev)
    return {"host_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"], "launches": prof["launches"]}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    card = card_info()
    dev = require_card()
    zero_counts()
    head, packed, (step, bare) = bench_verify(ITERS, BATCH, "distinct", dev)
    hot, _, _ = bench_verify(HOT_ITERS, HOT_ACCOUNTS, "hot-trie", dev)
    sweep_rate, shape, res = bench_resident_sweep(packed, dev)
    realmix = bench_keccak_realmix(packed, dev)
    buckets = bench_keccak(dev)
    launches = read_counts(dev)
    # the headline step's and bare call's device busy share, outside the
    # counted run
    profile = {"step": _profile(step, dev), "bare": _profile(bare, dev)}
    r = lambda x: round(x, 1)  # noqa: E731
    emit(metric="mpt_proofs_per_sec_per_chip", value=r(head["proofs_per_sec"]),
         unit="proofs/s", window_proofs_per_sec=r(head["window_proofs_per_sec"]),
         device_proofs_per_sec=r(head["device_proofs_per_sec"]),
         ms_per_batch=head["ms_per_batch"], device_ms_per_batch=head["device_ms_per_batch"],
         bare_ms_per_batch=head["bare_ms_per_batch"],
         bare_device_ms_per_batch=head["bare_device_ms_per_batch"],
         harness_ms_per_batch=head["harness_ms_per_batch"],
         harness_device_ms_per_batch=head["harness_device_ms_per_batch"],
         ms_runs=head["ms_runs"], batch=head["batch"], found=head["found"],
         folded_calls=head["folded_calls"], dedup_ratio=round(head["dedup_ratio"], 2),
         profile=profile,
         hot_trie_proofs_per_sec=r(hot["proofs_per_sec"]),
         hot_trie_window_proofs_per_sec=r(hot["window_proofs_per_sec"]),
         hot_trie_device_proofs_per_sec=r(hot["device_proofs_per_sec"]),
         hot_trie_ms_runs=hot["ms_runs"], hot_trie_batch=hot["batch"],
         hot_trie_found=hot["found"], hot_trie_folded_calls=hot["folded_calls"],
         hot_trie_dedup_ratio=round(hot["dedup_ratio"], 2),
         resident_sweep_proofs_per_sec=r(sweep_rate), resident_sweep_shape=shape,
         resident_sweep_proofs=res.total, resident_sweep_found=res.found,
         resident_sweep_seconds=res.seconds,
         keccak_real_mix_hashes_per_sec=r(realmix),
         keccak_hashes_per_sec={b: r(x[0]) for b, x in buckets.items()},
         keccak_bytes_per_sec={b: r(x[1]) for b, x in buckets.items()},
         launches=launches, card=card["nvidia_smi"],
         device={"kind": card["kind"], "count": card["count"]}, ok=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
