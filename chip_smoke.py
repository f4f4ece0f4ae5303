#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at full width, through the entry points a user
would call:

  * the pooled account-proof verifier behind `BatchVerifier`, at the
    headline shape: 4096 distinct account proofs over a 4096-account trie
    (the bench.py recipe, 576 B nodes, depth-sorted), served by
    `BatchVerifier(BucketConfig.account(), 4096)` with pinned depth and pool
    segment schedules;
  * the two-level account -> storage verifier `verify_storage_grouped` on
    the grouped-storage world of bench_configs.py: 512 accounts, each with a
    256-slot storage trie, 8 slot proofs per account (4096 slot proofs);
  * the pooled verify `verify_proofs_pooled(..., hint_mode=m)` in each of
    K2's five hinted modes, on the headline batch and on the transaction-
    geometry batch of bench_configs.py (4096 proofs over a 256-tx block of
    EIP-1559 txs with 1400-1960 B calldata: about 2 KB leaves, values read
    back at full width);
  * the block path: `verify_block_transactions` on that 256-tx block and on
    mainnet block 46147 (fixtures/, under its pinned transactionsRoot), and
    `verify_block_receipts` with ERC20 extraction on bench_configs.py's
    config-3 block (`synthetic_block(128, seed=3)`).

Phases, each printing a line:

  1. device: a CUDA device, or exit 1; the card's name and power limit;
  2. build: the kernels (csrc/*.cu) built from the checkout, one nvcc per
     source in parallel;
  3. K1 (keccak) against its plain version on the card, and the oracle;
  4. K2 (MPT walk, modes hinted and exact) against its plain version on the
     card: the headline batch, an adversarial batch, corrupted hints;
  5. account path: three requests through BatchVerifier; every headline
     proof FOUND with the oracle's leaf; results equal the plain path on the
     card; K1, hinted and exact launched by the path;
  6. timings with CUDA events, kernel path against plain path (the pooled
     verify, K1, and K2 in every hinted mode and exact, on the headline);
  7. K2 in mode bounded against its plain version: the full-width slot
     batch, crafted over-bound nodes (latch, then the exact re-run), a trie
     with inline children (served without a latch), the adversarial batch;
  8. K3 (keccak from raw words) against its plain version and K1: edge
     lengths and the headline pool, with an oracle sample;
  9. storage path: every account and slot FOUND with the oracle's values;
     equal to the plain path on the card and to verify_storage_batch (both
     dedup forms) on a 1:1 subset; a tampered account proof turns exactly
     its own slots INVALID; K1, hinted and bounded launched by the path;
 10. timings: the grouped storage call (kernel path against plain path),
     a torch.profiler breakdown of the call and of each of its stages
     alone (launches, host and device time), K2 bounded against exact on
     the slot batch;
 11. hint modes: K2 hinted4, hinted1, ordered and pairskip against their
     plain versions (headline segments, the adversarial batch, the
     transaction-geometry batch, a long-form item in branch slot 2 where
     only hinted4 does not latch, an unordered pack where ordered latches
     and re-runs in exact); then the pooled verify in each of the five
     hinted modes on the headline and transaction-geometry batches, equal
     to hinted's results, each mode launched;
 12. block path: all 256 txs FOUND with their encodings, block 46147
     FOUND with its raw tx under its real root, all 128 receipts FOUND with
     the transfers of the host decode (both engines), a tampered receipt
     node INVALID alone, the exact fallback at receipt geometry; each equal
     to the plain path on the card;
 13. timings: the transaction-geometry pooled verify (kernel against plain
     path), a device-time A/B of the five hinted modes on the headline and
     transaction-geometry batches, K1 on the transaction-geometry pool, and
     the share of K2's value copy at that geometry.

Any failed check exits non-zero. The next-to-last line is a JSON object of
the kernels; the last line is {"ok": true, "device": {...}}. Uses no JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

try:
    from zk_state_proofs_tpu_torch import native
    from zk_state_proofs_tpu_torch.models import (BatchVerifier, decode_receipt_value,
                                                  extract_erc20_transfers,
                                                  verify_block_receipts,
                                                  verify_block_transactions,
                                                  verify_merkle_batch, verify_storage_batch,
                                                  verify_storage_grouped)
    from zk_state_proofs_tpu_torch.models.blocks import _bucket_for
    from zk_state_proofs_tpu_torch.models.verifier import (_slot_key_nibbles,
                                                           _storage_core_grouped)
    from zk_state_proofs_tpu_torch.ops import keccak as tkeccak
    from zk_state_proofs_tpu_torch.ops import keccak_cuda, mpt, mpt_cuda
    from zk_state_proofs_tpu_torch.ops._build import load_library
    from zk_state_proofs_tpu_torch.ops.account import decode_account
    from zk_state_proofs_tpu_torch.ops.rlp import bytes_to_nibbles_device
    from zk_state_proofs_tpu_torch.oracle import EthTrie, keccak256 as oracle_keccak, rlp
    from zk_state_proofs_tpu_torch.utils.config import BucketConfig
    from zk_state_proofs_tpu_torch.utils.profiling import (cuda_timer, device_profile,
                                                           queued_timer)
    from zk_state_proofs_tpu_torch.witness import (
        ERC20_TRANSFER_TOPIC, encode_receipt, encode_transaction,
        get_all_receipt_proof_inputs, get_all_transaction_proof_inputs,
        get_transaction_proof_input, host_item_offsets, load_fixture, pack_proofs,
        synthetic_block)
    from zk_state_proofs_tpu_torch.witness_bridge import (
        BATCH_FIELDS, POOL_FIELDS, account_entries, packed_to_tensors, storage_world,
        tx_geometry_batch, tx_geometry_block)
except ImportError as exc:  # run outside a checkout of the repo
    print(f"FAIL: the repository's packages are not importable here: {exc}")
    sys.exit(1)

N_ACCOUNTS = 4096
TIMED_ITERS = 20
STORAGE_WORLD = (512, 8, 256)  # accounts, slot proofs per account, slots per trie
TX_BLOCK = (256, 11)     # txs, seed: bench_configs.py _tx_geometry_batch (quick=False)
TX_PROOFS = 4096         # proofs in the transaction-geometry batch
RECEIPT_BLOCK = (128, 3)  # synthetic_block(num_txs, seed): bench_configs.py config 3
PLAIN_ITERS = 3           # timed iterations of a plain path at transaction geometry
VARIANTS = ("hinted4", "hinted1", "ordered", "pairskip")  # K2's variants of hinted
# How device times are taken. torch.profiler lost kernel records in some
# windows of this script's runs (fewer kernels than launched), so device
# times come from CUDA events around calls queued behind a spin kernel.
DEVICE_TIMING = "CUDA events, 20 calls queued behind a spin kernel"

# The least time a kernel could take (`bound_ms`): the larger of its bytes
# over the memory rate and its operations over the ALU rate.
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# 32-bit integer operations: 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
# (Hopper SM; the float32 rate of 67 TFLOP/s counts 128 lanes and FMA as 2).
# Keccak's operations are LOP3 and SHF, which issue only on the integer ALU
# pipe; the FMA pipe's IMAD executes neither, so it does not raise this rate.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# per absorbed rate block, in 32-bit instructions as the card can issue them
# (three-input LOP3, one funnel shift per half of a 64-bit rotate), 24 rounds
# of: theta 80 (each column's 5-way XOR 2 LOP3 per half = 20, rot1 of the 5
# column sums 10 SHF, D folded into one 3-way XOR per lane half = 50); rho
# and pi 48 (24 rotates, none by 0 or 32); chi 50 (b ^ (~c & d) is one LOP3
# per lane half); iota 2. Plus the absorb: 17 lanes x 2 XOR.
KECCAK_OPS_PER_BLOCK = 24 * (80 + 48 + 50 + 2) + 17 * 2
# per walked node, a floor: 18 RLP header decodes of 16 operations each
WALK_OPS_PER_NODE = 18 * 16
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def max_err(got, want):
    """Largest |got - want| over tensors (integers: 0 means identical)."""
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"shape/dtype {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    repo = os.path.dirname(os.path.abspath(__file__))

    # ---- 1. device ----------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(card)
    log(f"[1 device] {kind}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; devices {torch.cuda.device_count()}")

    # ---- 2. build -----------------------------------------------------
    t0 = time.time()
    kl = load_library()
    log(f"[2 build] kernels built and loaded in {time.time() - t0:.2f} s "
        f"(nvcc {kl.build_seconds:.2f} s) -> {os.path.relpath(kl.path, repo)}")
    for line in kl.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[2 build] ptxas: {line.strip()}")

    # ---- witnesses ----------------------------------------------------
    t0 = time.time()
    hasher_name = ("native (C++, built here with g++)" if native.available()
                   else "oracle (pure Python; the native host library did not build)")
    entries, leaves = account_entries(N_ACCOUNTS)
    headline = pack_proofs(entries, node_len=576)
    segs = headline.depth_segments()
    psegs = headline.pool_block_segments()
    log(f"[witness] {N_ACCOUNTS} account proofs built in {time.time() - t0:.1f} s "
        f"with the {hasher_name} hasher; nodes {tuple(headline.nodes.shape)} "
        f"pool {tuple(headline.pool()[0].shape)} depth segments {segs} "
        f"pool segments {psegs}")
    ht = packed_to_tensors(headline, dev)
    batch = [ht[k] for k in BATCH_FIELDS]
    pool = [ht[k] for k in POOL_FIELDS]

    # ---- 3. K1 against its plain version --------------------------------
    rng = torch.Generator().manual_seed(0)
    edge = [0, 1, 135, 136, 137, 271, 272, 535, 536, 576]
    rows = torch.randint(0, 256, (len(edge) + 2, 576), generator=rng,
                         dtype=torch.uint8).to(dev)
    rows[-2:] = 0
    lens = torch.tensor(edge + [0, 0], dtype=torch.int32, device=dev)
    k1_err = max_err([keccak_cuda.keccak256_cuda(rows, lens)],
                     [tkeccak.keccak256(rows, lens)])
    pn, pl = pool[0], pool[1]
    dig_k = mpt._hash_pool_rows(pn, pl)
    dig_seg = mpt._hash_pool_rows(pn, pl, psegs)
    dig_plain = tkeccak.keccak256(pn, pl)
    k1_err = max(k1_err, max_err([dig_k, dig_seg], [dig_plain, dig_plain]))
    torch.cuda.synchronize()
    pn_h, pl_h, dk_h = pn.cpu().numpy(), pl.cpu().numpy(), dig_k.cpu().numpy()
    for i in range(0, pn_h.shape[0], 701):
        check(bytes(dk_h[i]) == oracle_keccak(bytes(pn_h[i, :pl_h[i]])),
              f"K1 digest of pool row {i} differs from the oracle")
    check(k1_err == 0, f"K1 differs from its plain version (max abs err {k1_err})")
    log(f"[3 K1] keccak256 kernel == plain on edge lengths {edge} and the "
        f"{pn.shape[0]}-row headline pool (with and without segments); "
        f"oracle sample ok; max abs err 0")

    # ---- 4. K2 against its plain version --------------------------------
    dig_table, hint_table = mpt.hash_nodes_pooled(pn, pl, pool[2], ht["pool_hints"], psegs)
    max_steps = headline.nodes.shape[1] + 6
    hctx = {"batch": batch, "pool": pool, "pool_hints": ht["pool_hints"], "segs": segs,
            "psegs": psegs, "dig": dig_table, "htab": hint_table, "steps": max_steps,
            "entries": entries, "leaves": leaves}
    head_segs = head_segments(hctx)

    k2_err = {"hinted": 0, "exact": 0}

    def compare_k2(args, hints, label, steps=max_steps):
        for mode in ("hinted", "exact"):
            got = mpt_cuda.walk_lanes(mode, *args, 128, steps, hints=hints)
            torch.cuda.synchronize()
            want = mpt.walk_kernel_plain(mode, *args, 128, steps, hints=hints)
            e = max_err(got, want)
            k2_err[mode] = max(k2_err[mode], e)
            check(e == 0, f"K2 {mode} differs from plain on {label} (max abs err {e})")

    for (a, h), (cnt, d) in zip(head_segs, segs):
        compare_k2(a, h, f"headline segment ({cnt}, {d})")

    adv_entries, inline_entries = adversarial_entries(entries)
    adv = pack_proofs(adv_entries + inline_entries, max_nodes=12, node_len=576)
    at = packed_to_tensors(adv, dev, pool=False)
    abatch = [at[k] for k in BATCH_FIELDS]
    adig = mpt.hash_nodes(abatch[0], abatch[1])
    b_, d_, n_ = adv.nodes.shape
    ahints = torch.from_numpy(host_item_offsets(adv.nodes.reshape(b_ * d_, n_))
                              .reshape(b_, d_, 36)).to(dev)
    adv_args = lane_args(abatch, adig)
    compare_k2(adv_args, ahints, "the adversarial batch", steps=d_ + 6)

    # corrupted hints: ovf latches, the exact kernel re-runs, results unchanged
    a, h = head_segs[0]
    honest = mpt_cuda.walk_batch_cuda(*a, 128, max_steps, hints=h, with_reasons=True)
    corrupt = (h.to(torch.int32) + 7).remainder(255).to(torch.uint8)
    compare_k2(a, corrupt, "corrupted hints")
    exact_before = mpt_cuda.LAUNCHES["exact"]
    *res, ovf = mpt_cuda.walk_batch_cuda(*a, 128, max_steps, hints=corrupt,
                                         with_reasons=True, with_overflow=True)
    check(bool((ovf != 0).all()), "corrupted hints did not latch the overflow flag")
    check(mpt_cuda.LAUNCHES["exact"] == exact_before + 1,
          "corrupted hints did not route to the exact kernel")
    check(max_err(res, honest) == 0, "exact re-run differs from the honest-hint run")
    log(f"[4 K2] walk kernel == plain in modes hinted and exact (six words "
        f"and values) on {len(segs)} headline segments, an adversarial batch "
        f"of {b_} proofs and corrupted hints; corrupted hints latched ovf on "
        f"{int((ovf != 0).sum())}/{ovf.numel()} proofs and re-ran in exact "
        f"with the honest results; max abs err 0")

    # ---- 5. main path through BatchVerifier ------------------------------
    bucket = BucketConfig.account()
    probe = BatchVerifier(bucket, N_ACCOUNTS, device=dev)
    probe.warmup(entries)  # derives the pinned pool bucket
    pinned = probe.pack(entries)
    svc = BatchVerifier(bucket, N_ACCOUNTS, pool_rows=probe.pool_rows,
                        depth_segments=pinned.depth_segments(),
                        pool_segments=pinned.pool_block_segments(), device=dev)
    t0 = time.time()
    svc.warmup(entries)
    torch.cuda.synchronize()
    log(f"[5 main] BatchVerifier(account bucket, {N_ACCOUNTS}) warm in "
        f"{time.time() - t0:.2f} s; depth segments {svc.depth_segments}; "
        f"pool segments {svc.pool_segments}")
    requests = [entries, entries[::3],
                adv_entries + inline_entries + entries[:N_ACCOUNTS // 8]]
    zero_counts()
    t0 = time.time()
    results = [svc.verify(req) for req in requests]
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    launches = read_counts()
    for name in ("keccak256", "hinted", "exact"):
        check(launches[name] > 0, f"the main path launched the {name} kernel no time")
    head = results[0]
    check(head.status.shape == (N_ACCOUNTS,) and head.values.shape == (N_ACCOUNTS, 128),
          "unexpected result shapes")
    check(head.all_found, f"headline proofs not all FOUND: {head.counts()}")
    for i, (_, _, key) in enumerate(entries):
        if head.value(i) != leaves[key]:
            fail(f"headline proof {i}: value differs from the oracle leaf")
    sub = results[1]
    check(sub.all_found and all(sub.value(i) == leaves[e[2]]
                                for i, e in enumerate(entries[::3])),
          "partial request: results differ from the oracle")
    for req, res in zip(requests, results):
        want = plain_service(svc, req)
        check(max_err([torch.from_numpy(res.status), torch.from_numpy(res.values),
                       torch.from_numpy(res.value_lens)], want) == 0,
              "BatchVerifier result differs from the plain path on the card")
    adv_res = results[2]
    log(f"[5 main] served 3 requests ({', '.join(str(len(r)) for r in requests)} "
        f"proofs) in {serve_s:.3f} s host time incl. packing; headline "
        f"{head.counts()}; adversarial {adv_res.counts()}; all equal the plain "
        f"path on the card; launches {launches}")

    # ---- 6. timings ---------------------------------------------------
    nodes, pnodes = batch[0], pool[0]
    # every value byte and length, folded per proof, as the headline request
    # returned them (same row order: entries are depth-sorted already)
    value_fold = torch.from_numpy(
        head.values.astype(np.int64).sum(1)
        + (head.value_lens.astype(np.int64) << 8)).to(dev)
    acc = torch.zeros(N_ACCOUNTS, dtype=torch.int64, device=dev)
    accv = torch.zeros(N_ACCOUNTS, dtype=torch.int64, device=dev)

    def pooled(i, kernels=True):
        # distinct work per iteration: the last padding byte of every node
        # row changes; results do not (bench.py's perturbation)
        nodes[:, :, -1] = i & 0xFF
        pnodes[:, -1] = i & 0xFF
        if kernels:
            s, v, l = mpt.verify_proofs_pooled(
                *batch, *pool, ht["pool_hints"], max_value_len=128,
                depth_segments=segs, pool_segments=psegs)
        else:
            s, v, l = plain_pooled(batch, pool, ht["pool_hints"], segs, psegs)
        acc.add_(s)
        accv.add_(v.to(torch.int64).sum(1) + (l.to(torch.int64) << 8))

    times = {}
    for label, kern in (("plain", False), ("kernel", True), ("kernel2", True),
                        ("plain2", False)):
        acc.zero_()
        accv.zero_()
        times[label] = cuda_timer(lambda i: pooled(i, kern), TIMED_ITERS)
        check(bool((acc == (TIMED_ITERS + 2) * mpt.FOUND).all())
              and bool((accv == (TIMED_ITERS + 2) * value_fold).all()),
              f"perturbed padding changed results ({label} path)")
    k_ms = min(times["kernel"], times["kernel2"])
    p_ms = min(times["plain"], times["plain2"])
    log(f"[6 time] pooled verify, {N_ACCOUNTS} proofs, kernel path "
        f"{k_ms:.4f} ms/batch = {N_ACCOUNTS / k_ms * 1e3:,.0f} proofs/s; plain "
        f"path {p_ms:.4f} ms/batch = {N_ACCOUNTS / p_ms * 1e3:,.0f} proofs/s "
        f"(runs {times}) on {card}")

    k1_ms = cuda_timer(lambda i: mpt._hash_pool_rows(pn, pl, psegs), TIMED_ITERS)
    k1_plain_ms = cuda_timer(
        lambda i: torch.cat([tkeccak.keccak256(pn[o:o + c, :w], pl[o:o + c])
                             for o, (c, w) in zip(seg_offsets(psegs), psegs)]),
        TIMED_ITERS)
    k2 = {}
    for mode in ("hinted", "exact") + VARIANTS:
        def run(i, fn):
            for a, h in head_segs:
                fn(mode, *a, 128, max_steps, hints=h)
        k2[mode] = (cuda_timer(lambda i: run(i, mpt_cuda.walk_lanes), TIMED_ITERS),
                    cuda_timer(lambda i: run(i, mpt.walk_kernel_plain), TIMED_ITERS))
    log(f"[6 time] K1 keccak, {pn.shape[0]}-row headline pool, segmented: "
        f"kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms on {card}")
    for mode, (km, pm) in k2.items():
        log(f"[6 time] K2 walk {mode}, {N_ACCOUNTS} proofs in {len(segs)} "
            f"segments: kernel {km:.4f} ms, plain {pm:.4f} ms on {card}")
    # ---- 7-10. K2 bounded, K3, the storage path, their timings ----------
    sw = storage_witness(dev)
    bnd = phase_bounded(sw, adv_args, inline_entries, dev)
    k3 = phase_k3(pn, pl, dig_k, card, dev)
    sto = phase_storage(sw, card, dev)
    del sw

    # ---- 11-13. the hint modes, the block path, their timings -----------
    adv_ctx = {"args": adv_args, "hints": ahints, "steps": d_ + 6}
    txw = tx_witness(dev)
    hm = phase_hint_modes(hctx, adv_ctx, txw, dev)
    blk = phase_blocks(txw, repo, dev)
    phase_block_timings(hctx, txw, hm["tx_result"], card)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "zk_state_proofs_tpu"))
    check(not loaded, f"JAX or the JAX package was imported: {loaded}")

    # ---- the kernels line -------------------------------------------------
    # each main path's launches, counted from zero over its own run (phases
    # 5, 9, 11 and 12); `launches` is their sum
    by_path = {"accounts": launches, "storage": sto["launches"],
               "hint_modes": hm["launches"], "blocks": blk["launches"]}
    headline_lens = (batch[0], batch[1], batch[2])
    src = "zk_state_proofs_tpu_torch/csrc/"
    kernels = [kernel_row(
        "keccak256", src + "keccak.cu", "zk_state_proofs_tpu/ops/keccak_pallas.py:122",
        by_path, "keccak256", k1_err, k1_ms, k1_plain_ms, keccak_bound(pl, psegs))]
    for mode in ("hinted", "exact"):
        kernels.append(kernel_row(
            f"mpt_walk_{mode}", src + "mpt_walk.cu",
            "zk_state_proofs_tpu/ops/mpt_pallas.py:165", by_path, mode,
            k2_err[mode], k2[mode][0], k2[mode][1],
            walk_bound(*headline_lens, batch[4].shape[1], 128, mode == "hinted")))
    for mode in VARIANTS:
        kernels.append(kernel_row(
            f"mpt_walk_{mode}", src + "mpt_walk.cu",
            "zk_state_proofs_tpu/ops/mpt_pallas.py:165", by_path, mode,
            hm["err"][mode], k2[mode][0], k2[mode][1],
            walk_bound(*headline_lens, batch[4].shape[1], 128, True)))
    kernels.append(kernel_row(
        "mpt_walk_bounded", src + "mpt_walk.cu",
        "zk_state_proofs_tpu/ops/mpt_pallas.py:165", by_path, "bounded",
        bnd["err"], sto["bounded_ms"], sto["bounded_plain_ms"], sto["bounded_bound"]))
    # K3 is on no main path (as in the JAX package): 0 launches there
    kernels.append(kernel_row(
        "keccak256_raw", src + "keccak.cu", "zk_state_proofs_tpu/ops/keccak_pallas.py:211",
        by_path, "keccak256_raw", k3["err"], k3["ms"], k3["plain_ms"],
        keccak_bound(pl, ((pn.shape[0], pn.shape[1]),))))
    log(f"[bound] the least time for each kernel's work: bytes over "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, 32-bit integer operations over "
        f"{INT32_OPS_PER_S / 1e12:.2f} T/s, the larger of the two")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


def zero_counts():
    for counts in (keccak_cuda.LAUNCHES, mpt_cuda.LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_counts():
    """Every kernel wrapper's launch count since zero_counts()."""
    return {**keccak_cuda.LAUNCHES, **mpt_cuda.LAUNCHES}


def seg_offsets(segments):
    offs, off = [], 0
    for cnt, _ in segments:
        offs.append(off)
        off += cnt
    return offs


def kernel_row(name, source, replaces, by_path, counter, err, ms, plain_ms, bound):
    bound_ms, bound_by = bound
    paths = {path: counts.get(counter, 0) for path, counts in by_path.items()}
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}  # no PyTorch call computes keccak or an MPT walk


def least_time(nbytes, ops):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def keccak_bound(lens, segments):
    """Bound of hashing rows of these lengths in segments ((count, width),
    ...): each row's first min(len, width) bytes read once, its length
    read, its digest written."""
    nbytes = ops = 0
    for o, (c, w) in zip(seg_offsets(segments), segments):
        ln = lens[o:o + c].to(torch.int64).clamp(min=0)
        nbytes += int(ln.clamp(max=w).sum()) + 36 * c
        ops += int((torch.div(ln, 136, rounding_mode="floor").clamp(max=w // 136) + 1).sum())
    return least_time(nbytes, ops * KECCAK_OPS_PER_BLOCK)


def walk_bound(nodes, node_lens, num_nodes, kn, max_value_len, hinted):
    """Bound of walking these proofs: each live node's bytes, length and
    digest (and hints) read once, the root, key and counts read, six words
    and the value written; WALK_OPS_PER_NODE per live node."""
    b, d, n = nodes.shape
    live = torch.arange(d, device=nodes.device)[None] < num_nodes.clamp(0, d)[:, None]
    n_live = int(live.sum())
    nbytes = (int(node_lens.clamp(0, n)[live].sum()) + n_live * (36 + (36 if hinted else 0))
              + b * (32 + kn + 8) + b * (24 + max_value_len))
    return least_time(nbytes, n_live * WALK_OPS_PER_NODE)


def storage_witness(dev):
    """The grouped-storage world at full width, packed, on the card."""
    t0 = time.time()
    w = storage_world(*STORAGE_WORLD)
    ap, sp = w.pack()
    at, st = packed_to_tensors(ap, dev), packed_to_tensors(sp, dev)
    s_dig = mpt.hash_nodes_pooled(*(st[k] for k in POOL_FIELDS))
    slot_args = lane_args([st[k] for k in BATCH_FIELDS], s_dig)
    mb = (ap.nodes.nbytes + sp.nodes.nbytes) / 1e6
    log(f"[witness] storage world {STORAGE_WORLD}: {ap.batch} account proofs "
        f"{tuple(ap.nodes.shape)}, {sp.batch} slot proofs {tuple(sp.nodes.shape)} "
        f"(node tables {mb:.1f} MB), slot pool {tuple(sp.pool()[0].shape)}, built "
        f"in {time.time() - t0:.1f} s")
    return {"world": w, "ap": ap, "sp": sp, "at": at, "st": st, "slot_args": slot_args,
            "slots": torch.from_numpy(w.slots).to(dev),
            "sa": torch.from_numpy(w.slot_accounts).to(dev)}


def over_bound_entries():
    """Well-formed RLP whose items pass the bounded windows (the JAX
    package's tests/test_mpt_pallas.py:450-481): a 2-item list with a
    100-byte item 0, and a 17-item list of 40-byte items."""
    key = oracle_keccak(b"smoke-over-bound")
    pair = rlp.encode([b"\x11" * 100, b"\x22"])
    wide = rlp.encode([b"\x33" * 40] * 17)
    return [(oracle_keccak(pair), [pair], key), (oracle_keccak(wide), [wide], key)]


def phase_bounded(sw, adv_args, inline_entries, dev):
    """Phase 7: K2 `bounded` against its plain version on the card (six
    words and values), and the latch and exact re-run on over-bound nodes."""
    err = 0

    def compare(args, label, max_value_len):
        nonlocal err
        steps = args[0].shape[1] + 6
        got = mpt_cuda.walk_lanes("bounded", *args, max_value_len, steps)
        torch.cuda.synchronize()
        want = mpt.walk_kernel_plain("bounded", *args, max_value_len, steps)
        e = max_err(got, want)
        err = max(err, e)
        check(e == 0, f"K2 bounded differs from plain on {label} (max abs err {e})")
        return got[0][:, 4]

    ovf = compare(sw["slot_args"], f"the {sw['sp'].batch}-slot batch", 64)
    check(int(ovf.sum()) == 0, "bounded latched on the honest slot batch")

    packed = pack_proofs(over_bound_entries(), node_len=704)
    t = packed_to_tensors(packed, dev, pool=False)
    b = [t[k] for k in BATCH_FIELDS]
    args = lane_args(b, mpt.hash_nodes(b[0], b[1]))
    check(bool((compare(args, "over-bound nodes", 64) == 1).all()),
          "over-bound nodes did not latch the bounded flag")
    exact_before = mpt_cuda.LAUNCHES["exact"]
    got = mpt_cuda.walk_batch_cuda(*args, 64, with_reasons=True)
    check(mpt_cuda.LAUNCHES["exact"] == exact_before + 1,
          "over-bound nodes did not re-run in exact")
    out, values = mpt.walk_kernel_plain("exact", *args, 64, packed.nodes.shape[1] + 6)
    want = (out[:, 0], values, torch.where(out[:, 0] == mpt.FOUND, out[:, 3], 0), out[:, 5])
    check(max_err(got, want) == 0, "the exact re-run differs from the plain exact walk")

    packed = pack_proofs(inline_entries, node_len=576)
    t = packed_to_tensors(packed, dev, pool=False)
    b = [t[k] for k in BATCH_FIELDS]
    args = lane_args(b, mpt.hash_nodes(b[0], b[1]))
    check(int(compare(args, "the inline-node trie", 64).sum()) == 0,
          "bounded latched on inline children")
    compare(adv_args, "the adversarial batch", 128)
    log(f"[7 K2] walk kernel == plain in mode bounded (six words and values) on "
        f"the {sw['sp'].batch}-slot batch (no latch), 2 over-bound nodes (latched, "
        f"re-ran in exact with the plain exact results), {len(inline_entries)} "
        f"inline-node proofs (no latch) and the adversarial batch; max abs err {err}")
    return {"err": err}


def phase_k3(pn, pl, dig_k, card, dev):
    """Phase 8: K3 against its plain version, K1 and the oracle; K3 against
    K1 and the plain version in time on the headline pool."""
    edge = [0, 1, 3, 4, 7, 8, 135, 136, 137, 271, 272, 535, 536, 576]
    rng = torch.Generator().manual_seed(1)
    err = 0
    for width in (576, 573):
        rows = torch.randint(0, 256, (len(edge), width), generator=rng,
                             dtype=torch.uint8).to(dev)
        lens = torch.tensor(edge, dtype=torch.int32, device=dev)
        got = keccak_cuda.keccak256_cuda_raw(rows, lens)
        torch.cuda.synchronize()
        err = max(err, max_err([got, got], [tkeccak.keccak256_raw(rows, lens),
                                            keccak_cuda.keccak256_cuda(rows, lens)]))
        host, gh = rows.cpu().numpy(), got.cpu().numpy()
        for i, n in enumerate(edge):
            if n <= width:
                check(bytes(gh[i]) == oracle_keccak(bytes(host[i, :n])),
                      f"K3 digest of length {n} (width {width}) differs from the oracle")
    got = keccak_cuda.keccak256_cuda_raw(pn, pl)
    err = max(err, max_err([got, got], [tkeccak.keccak256_raw(pn, pl), dig_k]))
    pn_h, pl_h, gh = pn.cpu().numpy(), pl.cpu().numpy(), got.cpu().numpy()
    for i in range(0, pn_h.shape[0], 701):
        check(bytes(gh[i]) == oracle_keccak(bytes(pn_h[i, :pl_h[i]])),
              f"K3 digest of pool row {i} differs from the oracle")
    check(err == 0, f"K3 differs from its plain version or K1 (max abs err {err})")

    def timed(fn):
        def run(i):
            pn[:, -1] = i & 0xFF  # padding byte: distinct work, same digests
            fn(pn, pl)
        return cuda_timer(run, TIMED_ITERS)

    t = {"k3": timed(keccak_cuda.keccak256_cuda_raw), "k1": timed(keccak_cuda.keccak256_cuda)}
    t["k1_2"], t["k3_2"] = timed(keccak_cuda.keccak256_cuda), timed(keccak_cuda.keccak256_cuda_raw)
    plain_ms = timed(tkeccak.keccak256_raw)
    ms, k1_ms = min(t["k3"], t["k3_2"]), min(t["k1"], t["k1_2"])
    dev_us = {name: device_us(lambda i: fn(pn, pl))
              for name, fn in (("K3", keccak_cuda.keccak256_cuda_raw),
                               ("K1", keccak_cuda.keccak256_cuda))}
    log(f"[8 K3] keccak256_raw kernel == plain == K1 on edge lengths {edge} at "
        f"widths 576 and 573 and the {pn.shape[0]}-row headline pool; oracle sample "
        f"ok; max abs err 0")
    log(f"[8 time] headline pool, {pn.shape[0]} rows x {pn.shape[1]} B, one launch: "
        f"K3 {ms:.4f} ms, K1 {k1_ms:.4f} ms, K3 plain {plain_ms:.4f} ms "
        f"(runs {t}); device time per launch ({DEVICE_TIMING}): "
        f"K3 {us_text(dev_us['K3'])}, K1 {us_text(dev_us['K1'])} on {card}")
    return {"err": err, "ms": ms, "plain_ms": plain_ms}


def device_us(fn):
    """Device µs per call of fn(i) (utils.profiling.queued_timer; None:
    not measured)."""
    ms = queued_timer(fn, TIMED_ITERS)
    return None if ms is None else 1e3 * ms


def kernel_device_us(fn, name_part, launches, iters=20, tries=3):
    """Device µs per call of the kernels whose name holds `name_part`, from
    a torch.profiler window of `iters` calls of fn(i). The profiler can
    lose kernel records: a window that counts other than `launches` such
    kernels a call is taken again, up to `tries` windows. None if no
    window was whole."""
    for _ in range(tries):
        rows = [(ms, n) for name, ms, n in device_profile(fn, iters)["top"]
                if name_part in name]
        if abs(sum(n for _, n in rows) - launches) < 1e-9:
            return 1e3 * sum(ms for ms, _ in rows)
    return None


def lower(*times):
    """The lowest measured time (None: not measured)."""
    got = [t for t in times if t is not None]
    return min(got) if got else None


def us_text(t):
    return "not measured" if t is None else f"{t:.2f} us"


def storage_fields(res):
    """The eight result arrays of a storage result, as tensors on the CPU."""
    if isinstance(res, tuple):
        a_status, acct, s_status, s_values, s_vlens = res
        arrs = [a_status, acct["storage_root"], acct["nonce"], acct["balance"],
                acct["code_hash"], s_status, s_values, s_vlens]
        return [x.cpu() for x in arrs]
    return [torch.from_numpy(np.asarray(getattr(res, f))) for f in (
        "account_status", "storage_root", "nonce", "balance", "code_hash",
        "slot_status", "slot_values", "slot_value_lens")]


def phase_storage(sw, card, dev):
    """Phases 9 and 10: the storage path through verify_storage_grouped,
    checked against the oracle, the plain path and verify_storage_batch;
    then its timings and K2 bounded against exact."""
    w, ap, sp, at, st = sw["world"], sw["ap"], sw["sp"], sw["at"], sw["st"]
    n_acc, n_slots = ap.batch, sp.batch
    sa = w.slot_accounts
    zero_counts()
    t0 = time.time()
    res = verify_storage_grouped(ap, sp, w.slots, sa, device=dev)
    torch.cuda.synchronize()
    host_s = time.time() - t0
    launches = read_counts()
    for name in ("keccak256", "hinted", "bounded"):
        check(launches[name] > 0, f"the storage path launched the {name} kernel no time")
    check(res.account_status.shape == (n_acc,) and res.slot_values.shape == (n_slots, 64),
          "unexpected storage result shapes")
    check(bool((res.account_status == mpt.FOUND).all()), "an account is not FOUND")
    check(bool((res.slot_status == mpt.FOUND).all()), "a slot is not FOUND")
    check(all(res.slot_value(i) == v for i, v in enumerate(w.slot_values)),
          "a slot value differs from the oracle")
    for a, leaf in enumerate(w.account_leaves):
        nonce, balance, sroot, code = rlp.decode(leaf)
        check(int.from_bytes(bytes(res.nonce[a]), "big") == int.from_bytes(nonce, "big")
              and int.from_bytes(bytes(res.balance[a]), "big") == int.from_bytes(balance, "big")
              and bytes(res.storage_root[a]) == sroot and bytes(res.code_hash[a]) == code,
              f"account {a}: decoded fields differ from the oracle leaf")
    got = storage_fields(res)

    core_args = ([at[k] for k in BATCH_FIELDS], [at[k] for k in POOL_FIELDS],
                 at["pool_hints"], st["nodes"], st["node_lens"], st["num_nodes"],
                 [st[k] for k in POOL_FIELDS], sw["slots"], sw["sa"])
    check(max_err(got, storage_fields(plain_storage(*core_args))) == 0,
          "the storage path differs from the plain path on the card")

    n1 = min(512, n_slots)  # a 1:1 subset: slot j with its own copy of its account's proof
    a1 = pack_proofs([w.account_entries[a] for a in sa[:n1]], node_len=ap.nodes.shape[2])
    s1 = pack_proofs(w.storage_entries[:n1], node_len=sp.nodes.shape[2])
    want1 = [x[torch.from_numpy(sa[:n1]).long()] for x in got[:5]] + [x[:n1] for x in got[5:]]
    for dedup in (True, False):
        r = verify_storage_batch(a1, s1, w.slots[:n1], dedup=dedup, device=dev)
        check(max_err(storage_fields(r), want1) == 0,
              f"verify_storage_batch(dedup={dedup}) differs from the grouped path")

    bad_row = 5
    entries = list(w.account_entries)
    proof = [bytes(x) for x in entries[bad_row][1]]
    leaf = bytearray(proof[-1])
    leaf[-1] ^= 1
    proof[-1] = bytes(leaf)
    entries[bad_row] = (entries[bad_row][0], proof, entries[bad_row][2])
    rb = verify_storage_grouped(pack_proofs(entries, node_len=ap.nodes.shape[2]), sp,
                                w.slots, sa, device=dev)
    mine = sa == bad_row
    check(rb.account_status[bad_row] == mpt.INVALID
          and bool((np.delete(rb.account_status, bad_row) == mpt.FOUND).all())
          and bool((rb.slot_status[mine] == mpt.INVALID).all())
          and bool((rb.slot_status[~mine] == mpt.FOUND).all())
          and bool((rb.slot_values[~mine] == res.slot_values[~mine]).all()),
          "a tampered account proof did not turn exactly its own slots INVALID")
    log(f"[9 storage] verify_storage_grouped on the card: {n_acc} accounts and "
        f"{n_slots} slots FOUND with the oracle's values, nonces, balances, "
        f"storage roots and code hashes ({host_s:.3f} s host time incl. the "
        f"host-to-card copy); equal to the plain path on the card and to "
        f"verify_storage_batch (dedup True and False) on {n1} slots; a tampered "
        f"account proof turned exactly its {int(mine.sum())} slots INVALID; "
        f"launches {launches}")

    # ---- 10. timings ----
    slots36 = torch.zeros((n_slots, 36), dtype=torch.uint8, device=dev)
    slots36[:, :32] = sw["slots"]
    args36 = core_args[:7] + (slots36, sw["sa"])
    bal = torch.from_numpy(res.balance.astype(np.int64).sum(1)).to(dev)
    fold = torch.from_numpy(res.slot_values.astype(np.int64).sum(1)
                            + (res.slot_value_lens.astype(np.int64) << 8)).to(dev)
    acc_a = torch.zeros(n_acc, dtype=torch.int64, device=dev)
    acc_s = torch.zeros(n_slots, dtype=torch.int64, device=dev)
    accv = torch.zeros(n_slots, dtype=torch.int64, device=dev)

    def storage_iter(i, kernels):
        # distinct work per iteration: the last padding byte of every node
        # row and slot changes; results do not (bench_configs.py's recipe)
        p = i & 0xFF
        for t in (at, st):
            t["nodes"][:, :, -1] = p
            t["pool_nodes"][:, -1] = p
        slots36[:, -1] = p
        a_st, acct, s_st, s_v, s_vl = (_storage_core_grouped if kernels
                                       else plain_storage)(*args36)
        acc_a.add_(a_st + acct["balance"].to(torch.int64).sum(1))
        acc_s.add_(s_st)
        accv.add_(s_v.to(torch.int64).sum(1) + (s_vl.to(torch.int64) << 8))

    times = {}
    for label, kern in (("plain", False), ("kernel", True), ("kernel2", True),
                        ("plain2", False)):
        for x in (acc_a, acc_s, accv):
            x.zero_()
        times[label] = cuda_timer(lambda i: storage_iter(i, kern), TIMED_ITERS)
        n = TIMED_ITERS + 2
        check(bool((acc_s == n * mpt.FOUND).all()) and bool((acc_a == n * (mpt.FOUND + bal)).all())
              and bool((accv == n * fold).all()),
              f"perturbed padding changed the storage results ({label} path)")
    k_ms = min(times["kernel"], times["kernel2"])
    p_ms = min(times["plain"], times["plain2"])
    log(f"[10 time] grouped storage verify, {n_acc} accounts + {n_slots} slots: "
        f"kernel path {k_ms:.4f} ms/batch = {n_slots / k_ms * 1e3:,.0f} slots/s; "
        f"plain path {p_ms:.4f} ms/batch = {n_slots / p_ms * 1e3:,.0f} slots/s "
        f"(runs {times}) on {card}")

    # the whole core call and each of its stages alone, on the same inputs,
    # each under torch.profiler over 10 calls (launches include copies)
    a_out = mpt.verify_proofs_pooled(*core_args[0], *core_args[1], core_args[2],
                                     max_value_len=128)
    acct = decode_account(*a_out[1:])
    s_knib, s_klen = _slot_key_nibbles(slots36)
    s_roots = torch.index_select(acct["storage_root"], 0, sw["sa"].to(torch.int64))
    stages = {
        "whole call": lambda i: _storage_core_grouped(*args36),
        "account level": lambda i: mpt.verify_proofs_pooled(
            *core_args[0], *core_args[1], core_args[2], max_value_len=128),
        "decode_account": lambda i: decode_account(*a_out[1:]),
        "slot keys": lambda i: _slot_key_nibbles(slots36),
        "slot level": lambda i: mpt.verify_proofs_pooled(
            *core_args[3:6], s_roots, s_knib, s_klen, *core_args[6], max_value_len=64,
            hinted=False)}
    for name, fn in stages.items():
        prof = device_profile(fn, 10)
        top = "; ".join(f"{n[:60]} {ms * 1e3:.1f} us x{c:.0f}" for n, ms, c in prof["top"])
        log(f"[10 profile] grouped storage, {name}, kernel path, torch.profiler over 10 "
            f"calls: host {prof['wall_ms']:.4f} ms/call, device busy "
            f"{prof['busy_ms']:.4f} ms/call "
            f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), {prof['launches']:.0f} "
            f"device launches/call" + (f"; top by device time: {top}"
                                       if name == "whole call" else "") + f" on {card}")

    sargs = sw["slot_args"]
    steps = sargs[0].shape[1] + 6

    def walk(mode, fn=mpt_cuda.walk_lanes):
        def run(i):
            sargs[0][:, :, -1] = i & 0xFF
            fn(mode, *sargs, 64, steps)
        return cuda_timer(run, TIMED_ITERS)

    wt = {"bounded": walk("bounded"), "exact": walk("exact")}
    wt["exact_2"], wt["bounded_2"] = walk("exact"), walk("bounded")
    b_ms, e_ms = min(wt["bounded"], wt["bounded_2"]), min(wt["exact"], wt["exact_2"])
    b_plain_ms = walk("bounded", mpt.walk_kernel_plain)
    dev_us = {}
    for m in ("bounded", "exact", "exact", "bounded"):  # the lower of two windows each
        us = device_us(lambda i: mpt_cuda.walk_lanes(m, *sargs, 64, steps))
        dev_us[m] = lower(dev_us.get(m), us)
    log(f"[10 time] K2 on the {n_slots}-slot batch {tuple(sargs[0].shape)}: bounded "
        f"{b_ms:.4f} ms, exact {e_ms:.4f} ms, bounded plain {b_plain_ms:.4f} ms "
        f"(runs {wt}); device time per launch ({DEVICE_TIMING}): "
        f"bounded {us_text(dev_us['bounded'])}, exact {us_text(dev_us['exact'])} on {card}")
    return {"launches": launches, "bounded_ms": b_ms, "bounded_plain_ms": b_plain_ms,
            "bounded_bound": walk_bound(*sargs[:3], sargs[5].shape[1], 64, False)}


def lane_args(batch, digests):
    """walk_lanes' seven proof tensors from BATCH_FIELDS tensors and a
    digest table."""
    return [batch[0], batch[1], batch[2], digests, *batch[3:]]


def head_segments(head):
    """(walk_lanes args, hints) of each headline depth segment."""
    b, out = head["batch"], []
    for o, (cnt, d) in zip(seg_offsets(head["segs"]), head["segs"]):
        sl = slice(o, o + cnt)
        out.append(([b[0][sl, :d], b[1][sl, :d], b[2][sl], head["dig"][sl, :d], b[3][sl],
                     b[4][sl], b[5][sl]], head["htab"][sl, :d]))
    return out


def long_slot_node():
    """A 17-item list whose items 0 and 1 are empty, item 2 a 60-byte
    string (a long-form header in branch slot 2, inside its bound) and the
    rest empty: `hinted` latches on it, `hinted4` does not."""
    return rlp.encode([b"", b"", b"\x5a" * 60] + [b""] * 14)


def tx_witness(dev):
    """The transaction-geometry block and its 4096-proof batch on the card,
    with the scattered digest and hint tables."""
    t0 = time.time()
    block = tx_geometry_block(*TX_BLOCK)
    geo = tx_geometry_batch(block, TX_PROOFS)
    t = packed_to_tensors(geo.packed, dev)
    pool = [t[k] for k in POOL_FIELDS]
    dig, htab = mpt.hash_nodes_pooled(*pool, t["pool_hints"])
    nodes = geo.packed.nodes
    want = np.zeros((geo.packed.batch, geo.max_value_len), np.uint8)
    for i, v in enumerate(geo.values):
        want[i, :len(v)] = np.frombuffer(v, np.uint8)
    log(f"[witness] transaction geometry: a {TX_BLOCK[0]}-tx block, {geo.packed.batch} "
        f"proofs, nodes {tuple(nodes.shape)} ({nodes.nbytes / 1e6:.1f} MB), pool "
        f"{tuple(geo.packed.pool()[0].shape)}, max_value_len {geo.max_value_len}, "
        f"max_steps {geo.max_steps}, built in {time.time() - t0:.1f} s")
    return {"block": block, "geo": geo, "t": t, "batch": [t[k] for k in BATCH_FIELDS],
            "pool": pool, "dig": dig, "htab": htab, "want_values": want,
            "want_lens": np.asarray([len(v) for v in geo.values], np.int32)}


def phase_hint_modes(head, adv, txw, dev):
    """Phase 11: K2 hinted4, hinted1, ordered and pairskip against their
    plain versions; the pooled verify in each of the five hinted modes."""
    err = dict.fromkeys(VARIANTS, 0)

    def compare(args, hints, label, mvl, steps):
        flags = {}
        for mode in VARIANTS:
            got = mpt_cuda.walk_lanes(mode, *args, mvl, steps, hints=hints)
            torch.cuda.synchronize()
            want = mpt.walk_kernel_plain(mode, *args, mvl, steps, hints=hints)
            e = max_err(got, want)
            err[mode] = max(err[mode], e)
            check(e == 0, f"K2 {mode} differs from plain on {label} (max abs err {e})")
            flags[mode] = got[0][:, 4]
        return flags

    for args, hints in head_segments(head):
        compare(args, hints, "a headline segment", 128, head["steps"])
    compare(adv["args"], adv["hints"], "the adversarial batch", 128, adv["steps"])
    geo = txw["geo"]
    targs = lane_args(txw["batch"], txw["dig"])
    flags = compare(targs, txw["htab"], "the transaction-geometry batch",
                    geo.max_value_len, geo.max_steps)
    check(all(int(f.sum()) == 0 for f in flags.values()),
          "a hinted mode latched on the honest transaction-geometry batch")

    # a long-form item in branch slot 2, and an unordered pack (root last)
    entries, leaves = head["entries"], head["leaves"]
    node = long_slot_node()
    crafted = (entries[:8] + [(r, p[::-1], k) for r, p, k in entries[8:16]]
               + [(oracle_keccak(node), [node], b"\x20" + bytes(31))])
    packed = pack_proofs(crafted, node_len=576)
    t = packed_to_tensors(packed, dev, pool=False)
    b = [t[k] for k in BATCH_FIELDS]
    cargs = lane_args(b, mpt.hash_nodes(b[0], b[1]))
    bb, d, n = packed.nodes.shape
    chints = torch.from_numpy(host_item_offsets(packed.nodes.reshape(bb * d, n))
                              .reshape(bb, d, 36)).to(dev)
    flags = compare(cargs, chints, "the crafted batch", 128, d + 6)
    hinted_out = mpt_cuda.walk_lanes("hinted", *cargs, 128, d + 6, hints=chints)[0]
    exact_out = mpt_cuda.walk_lanes("exact", *cargs, 128, d + 6)[0]
    h4_out = mpt_cuda.walk_lanes("hinted4", *cargs, 128, d + 6, hints=chints)[0]
    check(int(hinted_out[-1, 4]) == 1 and int(flags["hinted4"][-1]) == 0
          and bool((h4_out[-1] == exact_out[-1]).all()),
          "hinted4 did not serve the long-form slot-2 node where hinted latches")
    check(bool((flags["ordered"][8:16] == 1).all()) and int(hinted_out[8:16, 4].sum()) == 0,
          "ordered did not latch on the unordered pack")
    exact_before = mpt_cuda.LAUNCHES["exact"]
    got = mpt_cuda.walk_batch_cuda(*cargs, 128, d + 6, hints=chints, with_reasons=True,
                                   hint_mode="ordered")
    check(mpt_cuda.LAUNCHES["exact"] == exact_before + 1,
          "the unordered pack did not re-run in exact")
    out, values = mpt.walk_kernel_plain("exact", *cargs, 128, d + 6)
    want = (out[:, 0], values, torch.where(out[:, 0] == mpt.FOUND, out[:, 3], 0), out[:, 5])
    check(max_err(got, want) == 0, "the exact re-run differs from the plain exact walk")
    st, vals, vlens = (x.cpu().numpy() for x in got[:3])
    check(all(st[i] == mpt.FOUND and bytes(vals[i, :vlens[i]]) == leaves[crafted[i][2]]
              for i in range(16)), "the unordered pack's proofs are not FOUND with their leaves")

    # the main path of this phase: the pooled verify in every hinted mode
    zero_counts()
    res = {}
    for mode in mpt.HINT_MODES:
        before = mpt_cuda.LAUNCHES[mode]
        res[mode] = (
            mpt.verify_proofs_pooled(*head["batch"], *head["pool"], head["pool_hints"],
                                     max_value_len=128, hint_mode=mode,
                                     depth_segments=head["segs"], pool_segments=head["psegs"]),
            mpt.verify_proofs_pooled(*txw["batch"], *txw["pool"], txw["t"]["pool_hints"],
                                     max_value_len=geo.max_value_len,
                                     max_steps=geo.max_steps, hint_mode=mode))
        torch.cuda.synchronize()
        check(mpt_cuda.LAUNCHES[mode] == before + len(head["segs"]) + 1,
              f"the pooled verify did not launch K2 {mode}")
    launches = read_counts()
    check(launches["exact"] == 0, "an honest batch re-ran in exact")
    (hs, hv, hl), (ts, tv, tl) = (tuple(x.cpu().numpy() for x in r) for r in res["hinted"])
    check(bool((hs == mpt.FOUND).all()) and all(
        bytes(hv[i, :hl[i]]) == head["leaves"][e[2]] for i, e in enumerate(head["entries"])),
        "the headline pooled verify is not FOUND with the oracle leaves")
    check(bool((ts == mpt.FOUND).all()) and bool((tl == txw["want_lens"]).all())
          and bool((tv == txw["want_values"]).all()),
          "the transaction-geometry verify is not FOUND with the encoded txs")
    for mode in VARIANTS:
        for got, want in zip(res[mode], res["hinted"]):
            check(max_err(got, want) == 0, f"hint_mode={mode} differs from hinted")
    log(f"[11 hints] walk kernel == plain in modes {', '.join(VARIANTS)} (six words and "
        f"values) on {len(head['segs'])} headline segments, the adversarial batch, the "
        f"{geo.packed.batch}-proof transaction-geometry batch (no latch) and a crafted "
        f"batch; hinted4 served the long-form slot-2 node where hinted latches; ordered "
        f"latched on the 8 unordered proofs and re-ran in exact (FOUND, the oracle "
        f"leaves); max abs err {max(err.values())}")
    log(f"[11 hints] verify_proofs_pooled in modes {', '.join(mpt.HINT_MODES)} on the "
        f"headline batch ({len(head['segs'])} segments) and the transaction-geometry "
        f"batch: every proof FOUND with its value, every mode equal to hinted; "
        f"launches {launches}")
    return {"err": err, "launches": launches, "tx_result": res["hinted"][1]}


def block_pack(entries):
    """(packed, max_value_len) of block proofs, packed as
    models.blocks.verify_block_* pack them."""
    bucket = _bucket_for(entries, key_nibbles=8)
    return (pack_proofs(entries, max_nodes=bucket.max_nodes, node_len=bucket.node_len,
                        key_nibbles=bucket.key_nibbles), bucket.max_value_len)


def plain_block(entries, dev):
    """A block request verified on the plain path on the card, as
    verify_merkle_batch routes it: (status, values, value_lens)."""
    packed, mvl = block_pack(entries)
    t = packed_to_tensors(packed, dev)
    out = plain_pooled([t[k] for k in BATCH_FIELDS], [t[k] for k in POOL_FIELDS],
                       t["pool_hints"], max_value_len=mvl)
    return [x.cpu() for x in out]


def result_tensors(res):
    return [torch.from_numpy(np.asarray(x)) for x in (res.status, res.values, res.value_lens)]


def host_transfers(receipts):
    """The ERC20 transfers of the host decode of each encoded receipt."""
    topic = bytes.fromhex(ERC20_TRANSFER_TOPIC[2:])
    out = []
    for i, r in enumerate(receipts):
        for lg in decode_receipt_value(encode_receipt(r))["logs"]:
            if lg["topics"] and lg["topics"][0] == topic and len(lg["topics"]) == 3:
                out.append((lg["address"], lg["topics"][1][-20:], lg["topics"][2][-20:],
                            int.from_bytes(lg["data"][:32], "big"), i))
    return out


def transfer_fields(transfers):
    return [(t.token, t.sender, t.receiver, t.amount, t.tx_index) for t in transfers]


def phase_blocks(txw, repo, dev):
    """Phase 12: the block path on the card, each result against the
    oracle's encodings and the plain path on the card."""
    block = txw["block"]
    fx = synthetic_block(*RECEIPT_BLOCK)
    b46147 = load_fixture(os.path.join(repo, "fixtures", "mainnet_block_46147.json"))
    r_entries = [x.as_entry() for x in get_all_receipt_proof_inputs(fx["block"],
                                                                    fx["receipts"])]
    bad_row = 17
    proof = list(r_entries[bad_row][1])
    leaf = bytearray(proof[-1])
    leaf[-1] ^= 1
    proof[-1] = bytes(leaf)
    tampered = list(r_entries)
    tampered[bad_row] = (r_entries[bad_row][0], proof, r_entries[bad_row][2])
    node = long_slot_node()
    fallback = r_entries + [(oracle_keccak(node), [node], b"\x20")]

    # the main path of this phase, counted from zero
    zero_counts()
    t0 = time.time()
    rtx = verify_block_transactions(block, device=dev)
    r46 = verify_block_transactions(b46147, device=dev)
    rrc, transfers = verify_block_receipts(fx["block"], fx["receipts"], device=dev)
    tpacked, tmvl = block_pack(tampered)
    rtam = verify_merkle_batch(tpacked, max_value_len=tmvl, device=dev)
    exact_before = mpt_cuda.LAUNCHES["exact"]
    fpacked, fmvl = block_pack(fallback)
    rfb = verify_merkle_batch(fpacked, max_value_len=fmvl, device=dev)
    torch.cuda.synchronize()
    host_s = time.time() - t0
    launches = read_counts()
    for name in ("keccak256", "hinted", "exact"):
        check(launches[name] > 0, f"the block path launched the {name} kernel no time")

    txs = block["transactions"]
    check(rtx.status.shape == (len(txs),) and rtx.all_found
          and all(rtx.value(i) == encode_transaction(tx) for i, tx in enumerate(txs)),
          f"the {len(txs)}-tx block: not every tx FOUND with its encoding")
    raw = encode_transaction(b46147["transactions"][0])
    check(get_transaction_proof_input(b46147, 0).root_hash.hex()
          == b46147["transactionsRoot"][2:] and r46.all_found and r46.value(0) == raw,
          "block 46147: its tx is not FOUND with its raw bytes under the pinned root")
    n_rc = len(fx["receipts"])
    check(rrc.status.shape == (n_rc,) and rrc.all_found
          and all(rrc.value(i) == encode_receipt(r) for i, r in enumerate(fx["receipts"])),
          "not every receipt FOUND with its encoding")
    want = host_transfers(fx["receipts"])
    vec = extract_erc20_transfers(rrc.values, rrc.value_lens, rrc.status, engine="vectorized")
    check(len(want) > 0 and transfer_fields(transfers) == want
          and transfer_fields(vec) == want,
          "the ERC20 transfers differ from the host decode")
    others = np.arange(n_rc) != bad_row
    check(rtam.status[bad_row] == mpt.INVALID and bool((rtam.status[others] == mpt.FOUND).all())
          and bool((rtam.values[others] == rrc.values[others]).all()),
          "a tampered receipt node did not turn exactly its receipt INVALID")
    check(mpt_cuda.LAUNCHES["exact"] == exact_before + 1 and rfb.status[-1] == mpt.INVALID
          and bool((rfb.status[:n_rc] == mpt.FOUND).all())
          and bool((rfb.values[:n_rc] == rrc.values).all()),
          "the receipt batch with a latching node did not re-run in exact with the "
          "honest results")
    tx_entries = [x.as_entry() for x in get_all_transaction_proof_inputs(block)]
    b_entries = [x.as_entry() for x in get_all_transaction_proof_inputs(b46147)]
    for res, ents, label in ((rtx, tx_entries, "transactions"), (r46, b_entries, "46147"),
                             (rrc, r_entries, "receipts"), (rtam, tampered, "tampered"),
                             (rfb, fallback, "fallback")):
        check(max_err(result_tensors(res), plain_block(ents, dev)) == 0,
              f"the block path ({label}) differs from the plain path on the card")
    log(f"[12 blocks] verify_block_transactions: all {len(txs)} txs FOUND with their "
        f"encodings (values up to {int(rtx.value_lens.max())} B, nodes "
        f"{rtx.values.shape[1]} B wide); block 46147 FOUND with its raw tx under its "
        f"pinned transactionsRoot; verify_block_receipts: all {n_rc} receipts FOUND, "
        f"{len(transfers)} ERC20 transfers equal to the host decode with both engines; "
        f"a tampered receipt node turned exactly receipt {bad_row} INVALID; a latching "
        f"node re-ran the receipt batch in exact with the honest results; all equal to "
        f"the plain path on the card ({host_s:.2f} s host time incl. trie builds and "
        f"packing); launches {launches}")
    return {"launches": launches}


def phase_block_timings(head, txw, tx_result, card):
    """Phase 13: the transaction-geometry pooled verify, kernel against
    plain path; a device-time A/B of the five hinted modes; K1 on the
    transaction-geometry pool; the share of K2's value copy."""
    geo, batch, pool = txw["geo"], txw["batch"], txw["pool"]
    hints = txw["t"]["pool_hints"]
    nodes, pnodes = batch[0], pool[0]
    n_proofs, mvl, steps = geo.packed.batch, geo.max_value_len, geo.max_steps
    _, v0, l0 = tx_result
    fold = v0.to(torch.int64).sum(1) + (l0.to(torch.int64) << 8)
    acc = torch.zeros_like(fold)
    accv = torch.zeros_like(fold)

    def pooled(i, kernels):
        # distinct work per iteration: the last padding byte of every node
        # row changes; results do not
        nodes[:, :, -1] = i & 0xFF
        pnodes[:, -1] = i & 0xFF
        fn = mpt.verify_proofs_pooled if kernels else plain_pooled
        kw = dict(max_value_len=mvl, max_steps=steps)
        s, v, l = fn(*batch, *pool, hints, **kw) if kernels else fn(batch, pool, hints, **kw)
        acc.add_(s)
        accv.add_(v.to(torch.int64).sum(1) + (l.to(torch.int64) << 8))

    times = {}
    for label, kern, iters in (("plain", False, PLAIN_ITERS), ("kernel", True, TIMED_ITERS),
                               ("kernel2", True, TIMED_ITERS), ("plain2", False, PLAIN_ITERS)):
        acc.zero_()
        accv.zero_()
        times[label] = cuda_timer(lambda i: pooled(i, kern), iters)
        check(bool((acc == (iters + 2) * mpt.FOUND).all())
              and bool((accv == (iters + 2) * fold).all()),
              f"perturbed padding changed the transaction-geometry results ({label} path)")
    k_ms = min(times["kernel"], times["kernel2"])
    p_ms = min(times["plain"], times["plain2"])
    log(f"[13 time] pooled verify at transaction geometry, {n_proofs} proofs "
        f"{tuple(nodes.shape)}, values {mvl} B: kernel path {k_ms:.4f} ms/batch = "
        f"{n_proofs / k_ms * 1e3:,.0f} proofs/s; plain path {p_ms:.4f} ms/batch = "
        f"{n_proofs / p_ms * 1e3:,.0f} proofs/s (runs {times}) on {card}")
    prof = device_profile(lambda i: mpt.verify_proofs_pooled(
        *batch, *pool, hints, max_value_len=mvl, max_steps=steps), 10)
    top = "; ".join(f"{n[:50]} {ms * 1e3:.1f} us x{c:.0f}" for n, ms, c in prof["top"])
    log(f"[13 profile] pooled verify at transaction geometry, torch.profiler over 10 "
        f"calls: host {prof['wall_ms']:.4f} ms/call, device busy {prof['busy_ms']:.4f} "
        f"ms/call ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), "
        f"{prof['launches']:.0f} device launches/call; top by device time: {top} on {card}")

    segs = head_segments(head)
    targs = lane_args(batch, txw["dig"])

    def head_run(mode):
        for args, h in segs:
            mpt_cuda.walk_lanes(mode, *args, 128, head["steps"], hints=h)

    def tx_run(mode, mvl_=mvl):
        mpt_cuda.walk_lanes(mode, *targs, mvl_, steps, hints=txw["htab"])

    ab = {"headline": {}, "transaction geometry": {}}
    prof_ab = {"headline": {}, "transaction geometry": {}}
    order = mpt.HINT_MODES + mpt.HINT_MODES[::-1]  # the lower of two windows each
    for label, run, n in (("headline", head_run, len(segs)),
                          ("transaction geometry", tx_run, 1)):
        for m in order:
            ab[label][m] = lower(ab[label].get(m), device_us(lambda i: run(m)))
            prof_ab[label][m] = lower(prof_ab[label].get(m),
                                      kernel_device_us(lambda i: run(m), "mpt_walk", n))
        log(f"[13 A/B] K2 device time per batch on the {label} batch ({DEVICE_TIMING}, "
            f"the lower of two windows): " + ", ".join(
                f"{m} {us_text(us)}" for m, us in ab[label].items())
            + "; torch.profiler, windows that kept every kernel record: " + ", ".join(
                f"{m} {us_text(us)}" for m, us in prof_ab[label].items()) + f" on {card}")
    copy = {}
    for m in (mvl, 0, 0, mvl):
        copy[m] = lower(copy.get(m), device_us(lambda i: tx_run("hinted", m)))
    share = ("not measured" if None in copy.values()
             else f"{100 * (copy[mvl] - copy[0]) / copy[mvl]:.1f}%")
    log(f"[13 copy] K2 hinted at transaction geometry: {us_text(copy[mvl])} with the "
        f"{mvl}-byte value copy, {us_text(copy[0])} without (max_value_len 0): the copy is "
        f"{share} of the walk's device time on {card}")
    pn, pl = pool[0], pool[1]
    k1_ms = cuda_timer(lambda i: mpt._hash_pool_rows(pn, pl), TIMED_ITERS)
    k1_us = device_us(lambda i: mpt._hash_pool_rows(pn, pl))
    k1_bound = keccak_bound(pl, ((pn.shape[0], pn.shape[1]),))
    log(f"[13 time] K1 on the transaction-geometry pool {tuple(pn.shape)}, one launch: "
        f"{k1_ms:.4f} ms, device {us_text(k1_us)}, bound {k1_bound[0]:.5f} ms "
        f"({k1_bound[1]}) on {card}")
    tx_bound = walk_bound(*batch[:3], batch[4].shape[1], mvl, True)
    log(f"[13 bound] K2 hinted at transaction geometry: bound {tx_bound[0]:.5f} ms "
        f"({tx_bound[1]}); device {us_text(ab['transaction geometry']['hinted'])}")


def adversarial_entries(entries):
    """Failing account proofs built from the headline witnesses, plus a
    trie with inline (< 32 B) children, whose steps make the hinted walk
    latch its overflow flag and re-run in exact mode."""
    root = entries[0][0]
    bad = [bytearray(x) for x in entries[7][1]]
    bad[-1][9] ^= 0x40
    crafted = rlp.encode([b"\x01"])
    branch = [b""] * 17
    branch[entries[9][2][0] >> 4] = b"\x07" * 31
    crafted2 = rlp.encode(branch)
    absent = oracle_keccak(b"smoke-absent-account")
    adv = [
        (root, [bytes(x) for x in bad], entries[7][2]),         # corrupted node
        (b"\x31" * 32, entries[8][1], entries[8][2]),           # root missing
        (root, entries[10][1][:1], entries[10][2]),             # hash mismatch
        (oracle_keccak(crafted), [crafted], entries[11][2]),    # malformed
        (oracle_keccak(crafted2), [crafted2], entries[9][2]),   # bad child ref
        (root, entries[12][1], absent),                          # other key's proof
    ]
    t = EthTrie()
    keys = [oracle_keccak(b"smoke-inline-%d" % i)[:6] for i in range(48)]
    for i, k in enumerate(keys):
        t.insert(k, rlp.int_to_min_bytes(i + 1))
    iroot = t.root_hash()
    inline = [(iroot, t.get_proof(k), k) for k in keys[:16]]
    return adv, inline


def plain_walk(batch, digests, hints, max_value_len, max_steps=None):
    """walk_batch_cuda from the plain walk, on any device: hinted with
    hints, bounded without; the exact re-run when any flag latches.
    batch: (nodes, node_lens, num_nodes, roots, key_nibbles, key_lens)."""
    steps = batch[0].shape[1] + 6 if max_steps is None else max_steps
    args = (*batch[:3], digests, *batch[3:], max_value_len, steps)
    out, values = mpt.walk_kernel_plain("bounded" if hints is None else "hinted",
                                        *args, hints=hints)
    if bool((out[:, 4] != 0).any()):
        out, values = mpt.walk_kernel_plain("exact", *args)
    status = out[:, 0]
    return status, values, torch.where(status == mpt.FOUND, out[:, 3], 0)


def plain_table(pool, pool_hints=None, psegs=None):
    """hash_nodes_pooled from the plain keccak: the per-proof digest table
    (and hint table, with pool_hints)."""
    pn, pl, pidx = pool
    psegs = psegs or ((pn.shape[0], pn.shape[1]),)
    dig = torch.cat([tkeccak.keccak256(pn[o:o + c, :w], pl[o:o + c])
                     for o, (c, w) in zip(seg_offsets(psegs), psegs)])
    if pool_hints is None:
        return mpt.scatter_pool_payload(dig, pidx), None
    table = mpt.scatter_pool_payload(torch.cat([dig, pool_hints], 1), pidx)
    return table[..., :32], table[..., 32:]


def plain_pooled(batch, pool, pool_hints, segs=None, psegs=None, max_value_len=128,
                 max_steps=None):
    """The pooled main path built from the plain versions only (plain keccak,
    row gather, plain hinted walk with the exact re-run), on any device. A
    None max_steps resolves from the global node axis, as in the port."""
    segs = segs or ((batch[0].shape[0], batch[0].shape[1]),)
    steps = batch[0].shape[1] + 6 if max_steps is None else max_steps
    dig, hints = plain_table(pool, pool_hints, psegs)
    outs = []
    for o, (cnt, d) in zip(seg_offsets(segs), segs):
        sl = slice(o, o + cnt)
        seg = [batch[0][sl, :d], batch[1][sl, :d], *(x[sl] for x in batch[2:])]
        outs.append(plain_walk(seg, dig[sl, :d], hints[sl, :d], max_value_len, steps))
    return tuple(torch.cat(p) for p in zip(*outs))


def plain_storage(a_batch, a_pool, a_hints, s_nodes, s_lens, s_num, s_pool, slots,
                  slot_accounts):
    """models.verifier._storage_core_grouped from the plain versions only,
    on any device: the same arguments and results."""
    a_dig, a_h = plain_table(a_pool, a_hints)
    a_status, a_values, a_vlens = plain_walk(a_batch, a_dig, a_h, 128)
    acct = decode_account(a_values, a_vlens)
    b = slots.shape[0]
    knib = bytes_to_nibbles_device(tkeccak.keccak256(
        slots, torch.full((b,), 32, dtype=torch.int32, device=slots.device)))
    klen = torch.full((b,), 64, dtype=torch.int32, device=slots.device)
    sa = slot_accounts.to(torch.int64)
    s_roots = torch.index_select(acct["storage_root"], 0, sa)
    s_dig, _ = plain_table(s_pool)
    s_status, s_values, s_vlens = plain_walk(
        [s_nodes, s_lens, s_num, s_roots, knib, klen], s_dig, None, 64)
    account_ok = (a_status == mpt.FOUND) & acct["ok"]
    s_status = torch.where(torch.index_select(account_ok, 0, sa), s_status, mpt.INVALID)
    return a_status, acct, s_status, s_values, s_vlens


def plain_service(svc, req):
    """A request packed and routed as BatchVerifier.verify packs and routes
    it, verified on the plain path on the card; (status, values,
    value_lens) in request order."""
    n = len(req)
    order = sorted(range(n), key=lambda i: -len(req[i][1]))
    packed = svc.pack([req[i] for i in order])
    t = packed_to_tensors(packed, svc.device)
    segs = svc._compatible_segments(packed) or ((packed.batch, packed.nodes.shape[1]),)
    psegs = svc._compatible_pool_segments(packed) or (
        (packed.pool()[0].shape[0], packed.nodes.shape[2]),)
    out = plain_pooled([t[k] for k in BATCH_FIELDS], [t[k] for k in POOL_FIELDS],
                       t["pool_hints"], segs, psegs)
    inv = np.empty(n, dtype=np.int64)
    inv[np.asarray(order)] = np.arange(n)
    idx = torch.from_numpy(inv).to(out[0].device)
    return tuple(x[:n][idx].cpu() for x in out)


if __name__ == "__main__":
    main()
