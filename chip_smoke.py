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
    config-3 block (`synthetic_block(128, seed=3)`);
  * the sweeps of BASELINE config 5 (bench_configs.py
    `config5_sweep_with_root_reduction`): 65,536 accounts, batches of 4096,
    1,048,576 proofs through `sweep_resident_epochs`, and the other sweep
    forms; then trie roots on the card (`compute_root`) and the circuit
    entry points;
  * BASELINE config 4 (bench_configs.py `config4_mixed_batch`): 4096
    account, storage and transaction proofs through the disk cache
    (`PackedProofs.save` / `load`) and `verify_proofs_pooled` without
    pack-time hints or segment schedules;
  * BASELINE config 6 (bench_configs.py `config6_distinct_1m`), not cut:
    2^20 distinct account proofs in one resident epoch of
    `sweep_resident_epochs`.

Phases, each printing a line:

  1. device: a CUDA device, or exit 1; the card's name and power limit;
  2. build: the kernels (csrc/*.cu) built from the checkout, one nvcc per
     source in parallel;
  3. K1 (keccak) against its plain version on the card, and the oracle;
     the C++ host hasher (`native.keccak256_batch`) against K1 on every
     row of the headline pool (fails if the native library is absent);
     K4 (the device hint pass) against its plain version and the host's
     hints on the headline pool, and on fuzzed RLP rows of 576, 585 and
     2092 bytes, one launch a call;
  4. K2 (MPT walk, modes hinted and exact) against its plain version on the
     card: the headline batch, an adversarial batch, corrupted hints; the
     `exact` re-run's flag folded into the first walk against guard_plain
     of its words where no proof latched, one did and every one did (the
     three first walks queued before any guarded launch) and on the
     adversarial batch, the guarded launch walking exactly where one
     latched, every output equal to the plain route;
  5. account path: three requests through BatchVerifier, each packed pool
     first, copied through a page-locked staging (bytes logged); every headline
     proof FOUND with the oracle's leaf; results equal the plain path on the
     card; K1, hinted and exact launched by the path;
  6. timings with CUDA events, kernel path against plain path (the pooled
     verify, K1, and K2 in every hinted mode and exact, on the headline),
     and a torch.profiler breakdown of the headline pooled verify; its
     launches a call (a first walk and a guarded exact launch a depth
     segment) and the folded flag on each of its segments;
  7. K2 in mode bounded against its plain version: the full-width slot
     batch, crafted over-bound nodes (latch, then the exact re-run), a trie
     with inline children (served without a latch), the adversarial batch;
  8. K3 (keccak from raw words, a warp a message) against its plain
     version and K1: edge lengths at widths 576 and 573 and the headline
     pool, with an oracle sample; its time beside K1's;
  9. storage path: every account and slot FOUND with the oracle's values;
     equal to the plain path on the card and to verify_storage_batch (both
     dedup forms) on a 1:1 subset; a tampered account proof turns exactly
     its own slots INVALID; K1, hinted, bounded and K5 (the account
     decode) launched by the path; K5 against its plain version on the
     path's account values and on fuzzed values, one launch a call;
 10. timings: the grouped storage call (kernel path against plain path),
     a torch.profiler breakdown of the call, of config 2's form of it (no
     account hints) and of each of its stages alone (launches, host and
     device time), each before (the plain decode stages on the card) and
     after K4 and K5; K5's times; K2 bounded against exact on the slot
     batch;
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
     transaction-geometry batches, K1 on the transaction-geometry pool (and
     the C++ host hasher against K1 on every row of it, multi-block rows),
     the share of K2's value copy at that geometry, K4 on its pool, and
     config 1's call (no pack-time hints) before and after K4;
 14. K2's layout: its lanes a proof, dynamic shared memory a proof and a
     block, and how it stages node rows, on a headline segment, the slot
     batch and the transaction-geometry batch;
 15. sweeps at config 5's size: the 65,536-account world (every node
     shorter than N, so the epoch counter lands on padding), the epoch
     sweep (16 epochs, 1,048,576 proofs, after a warm-up with another salt:
     every proof FOUND), the fused resident sweep over 256 random batches,
     the streamed resident sweep (256 batches; 16 with materialize=False),
     sweep_entries over 256 freshly packed batches (pool-stream, prefetch
     2), sweep over a replicated batch; the guarded `exact` walk on no
     honest batch; a mixed 4096-proof witness (absent keys, tampered
     leaves, inline proofs) through every form, each equal to the plain
     route on the card, the guarded `exact` walk run; the batch loops of
     the epoch, fused and entries sweeps under
     torch.cuda.set_sync_debug_mode("error"); proofs/s per form, pack /
     dispatch / drain seconds, launches per batch (one first walk and one
     guarded exact) and the device-busy share of an epoch batch; the folded
     flag on an epoch window of the world and of the mixed witness; then
     the sweep's upload on config
     5's witness: its arrays copied to the card from the page-locked
     staging the resident sweeps copy from and by a plain pageable
     `.to(dev)`, in turns, host ms to the copies' end and GB/s of each,
     the one-time staging's seconds, and the epoch tables built through
     the staging equal to those built from the pageable copy, byte for
     byte;
 16. roots and circuits: compute_root on the receipt trie of
     synthetic_block(256, seed=5) and the transaction trie of the 256-tx
     block equals their receiptsRoot and transactionsRoot (and the plain
     reduction's every digest); run_merkle_circuit_batch over that block's
     256 borsh inputs commits the encoded txs; run_storage_circuit over one
     storage_world account's 8 slots commits their values, an absent slot
     raises MissingKeyError;
 17. the sharded layer (`parallel/`) at full size: world size 1 over NCCL
     (a TCP store on 127.0.0.1), then two ranks over gloo sharing the one
     card (spawned, each with its own deadline): verify_proofs_sharded on
     the headline, verify_storage_grouped_sharded on the storage world,
     compute_root_sharded on config 5's receipt trie (its receiptsRoot),
     config 5's sweep_resident_epochs(mesh=) (16 epochs, 1,048,576
     proofs) and sweep_entries(mesh=) over fresh batches, BatchVerifier
     (mesh=) serving three requests, and dryrun_multichip; at world size 1
     each result equals the unsharded call's bit for bit, and the two
     ranks' results equal world size 1's; the dry run's launches are
     counted apart from the full-size calls'; rates beside the card (one
     card: no scaling figure);
 18. the CLI on the card (`zk_state_proofs_tpu_torch.__main__.main`, its
     default device): selftest, verify-tx and diagnose on mainnet block
     46147, verify-receipts --erc20 on fixtures/synthetic_block_64.json,
     verify-storage on a synthetic getProof fixture and on its tampered
     header (exit 1); each command's JSON and exit code equal the same
     command with --device cpu; `python -m zk_state_proofs_tpu_torch
     selftest` in a subprocess prints the in-process JSON; a Chrome trace
     (utils.profiling.cuda_trace) of verify-tx on the card loads;
 19. config 4: the mixed batch packed, saved and loaded (the pool
     validated on load; a flipped pool byte, two swapped leaf rows of
     pool_idx and an out-of-range pool_idx each refused with
     PackingError), then verify_proofs_pooled with no pack-time hints and
     no segments (K1, the device hint pass, K2 hinted, the guarded exact):
     every proof FOUND, no guarded exact launch walked, the device hint
     pass equal to the host's hints, the results equal bit for bit to the
     plain route on the card (with the host's hints) and to the batch
     packed fresh; timed with CUDA events over distinct
     iterations (byte N - 1 of every node and pool row takes a counter),
     values and lengths in a checked accumulator; launches a call, the
     guarded exact launches that walked, K2's shared-memory layout; the
     call before and after K4 (at most 40 launches after); K4's times;
 20. config 6 at 2^20 accounts: the witness built and packed (seconds,
     max depth, pool rows, the node table's bytes, past 2^31), one
     resident epoch after a warm-up with another salt (proofs/s, pack /
     dispatch / drain seconds, peak device memory); outside the timed
     call, tables built again and every window read once: every proof
     FOUND with its leaf as its value; K1 over the whole pool against the
     plain keccak; K4 over the whole pool against its plain version;
     epoch_batch on the first window, the first window past byte 2^31 of
     the node table and the last window against the plain walk; K1 and
     K4 over the pool and K2 `hinted` alone on the first window timed;
 21. the benchmark programs (zk_state_proofs_tpu_torch/bench/), each in its
     own process as `python -m zk_state_proofs_tpu_torch.bench.<module>`:
     the headline at full width (4096 distinct accounts, the 512-account
     hot trie, the 256-epoch resident sweep, K1's rates by block count and
     on the real pool), configs 1-6 at --quick size and one short A/B pair
     of K2's hint modes and of K1's pool hashing; every JSON line ok, every
     proof FOUND, the accumulators checked, the lines printed, their
     launches counted as the `bench` path.

K1 is a warp per message and K2 a warp per proof over a shared-memory slab
(csrc/keccak.cu, csrc/mpt_walk.cu); K2's `exact` re-run is decided on the
card with no launch of its own: the first walk stores its tag into a slot
of a device flag ring where a proof latched, and the guarded `exact`
launch walks only where the slot holds the tag (csrc/mpt_walk.cu). The
build phase prints
ptxas's registers and spills (and static shared memory) for each kernel. Each
phase prints its seconds, and the run its total. Any failed check exits
non-zero. The next-to-last line is a JSON object of the kernels; the last
line is {"ok": true, "device": {...}}. Uses no JAX and nothing of the JAX
package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

try:
    import torch.distributed as dist

    from zk_state_proofs_tpu_torch import native
    from zk_state_proofs_tpu_torch.bench.common import (HBM_BYTES_PER_S, INT32_OPS_PER_S,
                                                        Step, account_bound, card_info,
                                                        hint_pass_bound, keccak_bound,
                                                        perturb, pooled_call, read_counts,
                                                        seg_offsets, value_word, walk_bound,
                                                        wall_ms, zero_counts)
    from zk_state_proofs_tpu_torch.__main__ import main as cli_main
    from zk_state_proofs_tpu_torch.entry import dryrun_multichip
    from zk_state_proofs_tpu_torch.models import (BatchVerifier, decode_receipt_value,
                                                  extract_erc20_transfers,
                                                  replicated_batches, run_merkle_circuit,
                                                  run_merkle_circuit_batch,
                                                  run_storage_circuit, sweep, sweep_entries,
                                                  sweep_resident, sweep_resident_epochs,
                                                  verify_block_receipts,
                                                  verify_block_transactions,
                                                  verify_merkle_batch, verify_storage_batch,
                                                  verify_storage_grouped)
    from zk_state_proofs_tpu_torch.models.blocks import _bucket_for
    from zk_state_proofs_tpu_torch.models.sweep import (_UPLOAD, _expand_tables,
                                                        _PinnedStaging, _pinned_staging,
                                                        _upload_arrays, epoch_batch,
                                                        epoch_tables, epoch_windows)
    from zk_state_proofs_tpu_torch.models.verifier import (_slot_key_nibbles,
                                                           verify_storage_pooled)
    from zk_state_proofs_tpu_torch.ops import keccak as tkeccak
    from zk_state_proofs_tpu_torch.ops import decode_cuda, keccak_cuda, mpt, mpt_cuda
    from zk_state_proofs_tpu_torch.ops._build import load_library
    from zk_state_proofs_tpu_torch.ops.account import decode_account, decode_account_plain
    from zk_state_proofs_tpu_torch.ops.rlp import (bytes_to_nibbles_device, item_offsets,
                                                   item_offsets_plain)
    from zk_state_proofs_tpu_torch.ops.trie_build import compute_root
    from zk_state_proofs_tpu_torch.oracle import (EthTrie, MissingKeyError,
                                                  keccak256 as oracle_keccak, rlp)
    from zk_state_proofs_tpu_torch.parallel import (compute_root_sharded, make_mesh,
                                                    verify_proofs_sharded,
                                                    verify_storage_grouped_sharded)
    from zk_state_proofs_tpu_torch.parallel.multihost import free_port, initialize, run_ranks
    from zk_state_proofs_tpu_torch.utils.config import BucketConfig
    from zk_state_proofs_tpu_torch.utils.profiling import (cuda_timer, cuda_trace,
                                                           device_profile, queued_timer)
    from zk_state_proofs_tpu_torch.witness import (
        ERC20_TRANSFER_TOPIC, PackedProofs, PackingError, encode_receipt, encode_transaction,
        get_all_receipt_proof_inputs, get_all_transaction_proof_inputs,
        get_transaction_proof_input, host_item_offsets, load_fixture, pack_proofs,
        save_fixture, synthetic_block)
    from zk_state_proofs_tpu_torch.witness.encoding import block_hash
    from zk_state_proofs_tpu_torch.witness.trie_plan import plan_index_trie
    from zk_state_proofs_tpu_torch.witness.types import StorageProofInput
    from zk_state_proofs_tpu_torch.witness_bridge import (
        BATCH_FIELDS, POOL_FIELDS, account_entries, account_fuzz_values, decode_fuzz_rows,
        default_hasher, distinct_world, mixed_batch, packed_to_tensors, storage_world,
        sweep_world, tx_geometry_batch, tx_geometry_block)
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
# bench_configs.py config5_sweep_with_root_reduction (quick=False): 65,536
# accounts, batches of 4096, 256 batches = 16 epochs = 1,048,576 proofs
SWEEP_ACCOUNTS = 65536
SWEEP_BATCH = 4096
SWEEP_BATCHES = 256
SWEEP_SEED = 5            # the index batches' numpy Generator
UPLOAD_REPS = 5           # turns of the sweep upload's A/B, page-locked against pageable
ROOT_BLOCK = (256, 5)     # synthetic_block(num_txs, seed): config 5's receipt-trie root
PAR_ENTRY_BATCHES = 32    # sweep_entries(mesh=) batches in phase 17 (host packing bound)
PAR_RANKS = 2             # gloo ranks sharing the one card in phase 17
PAR_TIMEOUT_S = 420       # each spawned rank's deadline, and its collectives'
MIXED_PROOFS = 4096       # bench_configs.py config4_mixed_batch (quick=False)
# bench_configs.py config6_distinct_1m (quick=False), not cut: 2^20 distinct
# accounts, one epoch of windows of 4096
DISTINCT_ACCOUNTS = 1 << 20
DISTINCT_BATCH = 4096
PLAIN_CHUNK = 1 << 18     # pool rows a call of the plain keccak in phase 20
INT32_BYTES = 1 << 31     # a byte offset past the int32 range
# K4 and K5 on fuzzed rows (witness_bridge.decode_fuzz_rows, account_fuzz_values):
# rows of each width, the account width; the most device launches a call that
# config 4's call and phase 10's grouped storage call may make with K4 and K5
FUZZ_ROWS = 4096
DECODE_WIDTHS = (576, 585, 2092)
ACCOUNT_WIDTH = 128
MIXED_LAUNCH_LIMIT = 40
STORAGE_LAUNCH_LIMIT = 60
# How device times are taken. torch.profiler lost kernel records in some
# windows of this script's runs (fewer kernels than launched), so device
# times come from CUDA events around calls queued behind a spin kernel.
DEVICE_TIMING = "CUDA events, 20 calls queued behind a spin kernel"
# phase 21: the benchmark programs, each run as a user runs it, in its own
# process: the headline at full width, configs 1-6 at --quick size, one
# short A/B pair of each harness
BENCH_RUNS = (("headline", ()), ("configs", ("--quick",)),
              ("ab", ("--walk", "hinted", "hinted1", "--keccak", "base", "seg", "--reps", "1")))
BENCH_TIMEOUT_S = 300     # each bench program's limit
CONFIG_NAMES = ("single_tx_proof", "account_storage_proof", "full_receipt_trie",
                "mixed_batch_4096", "sweep_with_root_reduction", "distinct_1m_resident")
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


_CLOCK = {"start": time.time(), "last": time.time()}


def stamp(label: str) -> None:
    """Log the seconds since the previous stamp (the phase just run)."""
    now = time.time()
    log(f"[time] {label}: {now - _CLOCK['last']:.1f} s")
    _CLOCK["last"] = now


def main() -> None:
    repo = os.path.dirname(os.path.abspath(__file__))

    # ---- 1. device ----------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    card = card_info()["nvidia_smi"]
    log(card)
    log(f"[1 device] {kind}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; devices {torch.cuda.device_count()}")

    # ---- 2. build -----------------------------------------------------
    t0 = time.time()
    kl = load_library()
    log(f"[2 build] kernels built and loaded in {time.time() - t0:.2f} s "
        f"(nvcc {kl.build_seconds:.2f} s) -> {os.path.relpath(kl.path, repo)}")
    kernel = "?"
    for line in kl.build_log.splitlines():
        if "Compiling entry function" in line:  # mangled: ...20mpt_walk_warp_kernelILi32E...
            found = re.search(r"(?<=\d)((?:mpt_walk|keccak256|walk)_[a-z0-9_]*?_kernel"
                              r"|item_offsets_kernel|decode_account_kernel)(?:ILi(\d+)E)?", line)
            kernel = (found.group(1) + (f"<{found.group(2)}>" if found.group(2) else "")
                      if found else line.split("'")[1])
        elif "registers" in line or "spill" in line:
            log(f"[2 build] ptxas {kernel}: {line.strip().removeprefix('ptxas info    : ')}")

    stamp("phases 1-2 (device, build)")

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
    native_against_k1(pn_h, pl_h, dk_h, "[3 native]", "headline pool")
    log(f"[3 K1] keccak256 kernel == plain on edge lengths {edge} and the "
        f"{pn.shape[0]}-row headline pool (with and without segments); "
        f"oracle sample ok; max abs err 0")
    _, k4_err = hint_pass_check(pn, "the headline pool", ht["pool_hints"])
    for width in DECODE_WIDTHS:
        fuzz = torch.from_numpy(decode_fuzz_rows(FUZZ_ROWS, width, seed=width)).to(dev)
        k4_err = max(k4_err, hint_pass_check(fuzz, f"fuzzed rows of {width} B")[1])
    log(f"[3 K4] the device hint pass kernel == plain (one launch a call) on the "
        f"{pn.shape[0]}-row headline pool (== the host's hints) and {FUZZ_ROWS} fuzzed RLP "
        f"rows at each width {DECODE_WIDTHS}; max abs err {k4_err}")

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
    walked = mpt_cuda.exact_walked(dev)
    *res, ovf = mpt_cuda.walk_batch_cuda(*a, 128, max_steps, hints=corrupt,
                                         with_reasons=True, with_overflow=True)
    check(bool((ovf != 0).all()), "corrupted hints did not latch the overflow flag")
    check(mpt_cuda.exact_walked(dev) == walked + 1,
          "corrupted hints did not route to the exact kernel")
    check(max_err(res, honest) == 0, "exact re-run differs from the honest-hint run")
    # the re-run flag folded into the first walk: no proof latched, one did,
    # every one did (the three first walks queued before any guarded
    # launch), and the adversarial batch (its inline proofs latch)
    one = h.clone()
    one[5] = corrupt[5]  # that proof alone latches
    fold_err, latched = fold_checks([*a, 128, max_steps], [
        ("honest hints", h), ("one proof's hints corrupted", one), ("corrupted hints", corrupt)])
    check(latched == [0, 1, a[0].shape[0]], f"latched proofs {latched}: 0, 1 and all expected")
    e, adv_latched = fold_checks([*adv_args, 128, d_ + 6], [("the adversarial batch", ahints)])
    fold_err = max(fold_err, e)
    log(f"[4 K2] walk kernel == plain in modes hinted and exact (six words "
        f"and values) on {len(segs)} headline segments, an adversarial batch "
        f"of {b_} proofs and corrupted hints; corrupted hints latched ovf on "
        f"{int((ovf != 0).sum())}/{ovf.numel()} proofs and re-ran in exact "
        f"with the honest results; max abs err 0")
    log(f"[4 fold] the re-run flag folded into K2's first walk == guard_plain of its words "
        f"on headline segment 0 with {latched} proofs latched (three first walks queued "
        f"before any guarded launch) and the adversarial batch ({adv_latched[0]} latched); "
        f"the guarded exact launch walked exactly where a proof latched, every output "
        f"(status, value, length, reason) == the plain route; max abs err {fold_err}")

    stamp("witness and phases 3-4 (K1, K2)")

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
    results = []
    for req in requests:
        staged, walked = svc.stats.staged_batches, svc.stats.walked_batches
        results.append(svc.verify(req))
        check(svc.stats.staged_batches == staged + 1,
              f"request {len(results) - 1} did not take the pool-first route")
        check(svc.stats.walked_batches == walked + 1,
              f"request {len(results) - 1} was not encoded by the native walk")
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    check(svc.pack(requests[0]).block.is_pinned(), "the pool-first block is not page-locked")
    launches = read_counts()
    for name in ("keccak256", "hinted", "exact", "exact_walked"):
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
        f"path on the card; launches {launches}; each packed pool first, "
        f"{svc._pool_first[1]} staged bytes copied a request")

    stamp("phase 5 (accounts)")

    # ---- 6. timings ---------------------------------------------------
    nodes, pnodes = batch[0], pool[0]
    # every value byte and length, folded per proof, as the headline request
    # returned them (same row order: entries are depth-sorted already)
    once = value_word(torch.from_numpy(head.values).to(dev),
                      torch.from_numpy(head.value_lens).to(dev))

    def plain_call(ctr):
        perturb(ctr, nodes, pnodes)
        return plain_pooled(batch, pool, ht["pool_hints"], segs, psegs)

    times = time_paths({"kernel": pooled_call(ht, max_value_len=128, depth_segments=segs,
                                              pool_segments=psegs),
                        "plain": plain_call}, N_ACCOUNTS, once, "phase 6", dev)
    k_ms = min(times["kernel"], times["kernel2"])
    p_ms = min(times["plain"], times["plain2"])
    log(f"[6 time] pooled verify, {N_ACCOUNTS} proofs, kernel path "
        f"{k_ms:.4f} ms/batch = {N_ACCOUNTS / k_ms * 1e3:,.0f} proofs/s; plain "
        f"path {p_ms:.4f} ms/batch = {N_ACCOUNTS / p_ms * 1e3:,.0f} proofs/s "
        f"(runs {times}) on {card}")

    prof = device_profile(lambda i: mpt.verify_proofs_pooled(
        *batch, *pool, ht["pool_hints"], max_value_len=128, depth_segments=segs,
        pool_segments=psegs), 10)
    top = "; ".join(f"{n[:50]} {ms * 1e3:.1f} us x{c:.0f}" for n, ms, c in prof["top"])
    log(f"[6 profile] pooled verify, {N_ACCOUNTS} proofs, torch.profiler over 10 calls: "
        f"host {prof['wall_ms']:.4f} ms/call, device busy {prof['busy_ms']:.4f} ms/call "
        f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), {prof['launches']:.0f} device "
        f"launches/call; top by device time: {top} on {card}")

    for k, (a, h) in enumerate(head_segs):
        fold_err = max(fold_err, fold_checks([*a, 128, max_steps],
                                             [(f"headline segment {k}", h)])[0])
    before = {**keccak_cuda.LAUNCHES, **mpt_cuda.LAUNCHES}
    mpt.verify_proofs_pooled(*batch, *pool, ht["pool_hints"], max_value_len=128,
                             depth_segments=segs, pool_segments=psegs)
    per_call = {k: v - before[k] for k, v in {**keccak_cuda.LAUNCHES, **mpt_cuda.LAUNCHES}.items()
                if v != before[k]}
    check(per_call.get("hinted") == per_call.get("exact") == len(segs),
          f"a headline pooled verify launched {per_call}: one hinted and one exact launch "
          f"a depth segment expected")
    log(f"[6 launches] a headline pooled verify: wrapper launches {per_call}; "
        f"{prof['launches']:.0f} device launches a call (torch.profiler, above); "
        f"the folded re-run flag == guard_plain on each of its {len(segs)} segments")

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
    stamp("phase 6 (timings)")

    # ---- 7-10. K2 bounded, K3, the storage path, their timings ----------
    sw = storage_witness(dev)
    bnd = phase_bounded(sw, adv_args, inline_entries, dev)
    k3 = phase_k3(pn, pl, dig_k, card, dev)
    sto = phase_storage(sw, card, dev)
    slot_args = sw["slot_args"]
    del sw
    stamp("phases 7-10 (bounded, K3, storage)")

    # ---- 11-13. the hint modes, the block path, their timings -----------
    adv_ctx = {"args": adv_args, "hints": ahints, "steps": d_ + 6}
    txw = tx_witness(dev)
    hm = phase_hint_modes(hctx, adv_ctx, txw, dev)
    blk = phase_blocks(txw, repo, dev)
    bt = phase_block_timings(hctx, txw, hm["tx_result"], card)
    phase_layout(head_segs, max_steps, slot_args, txw)
    stamp("phases 11-14 (hint modes, blocks, K2's layout)")
    kn = batch[4].shape[1]
    bound = {"k1": keccak_bound(pl, psegs), "k3": keccak_bound(pl, ((pn.shape[0], pn.shape[1]),)),
             "hinted": walk_bound(batch[0], batch[1], batch[2], kn, 128, True),
             "exact": walk_bound(batch[0], batch[1], batch[2], kn, 128, False)}
    tx_block = txw["block"]
    # the earlier phases' witnesses are not needed past here
    del txw, hctx, hm["tx_result"], head_segs, ht, batch, pool, pn, pl, dig_k, dig_seg
    del dig_plain, dig_table, hint_table, slot_args, adv_ctx, adv_args, nodes, pnodes
    torch.cuda.empty_cache()

    # ---- 15-16. the sweeps, roots and circuits ----------------------------
    swp = phase_sweeps(card, dev)
    k1_err = max(k1_err, swp["err"]["k1"])
    for mode in ("hinted", "exact"):
        k2_err[mode] = max(k2_err[mode], swp["err"]["k2"])
    stamp("phase 15 (sweeps)")
    swp["upload"] = phase_upload(swp["gp"], card, dev)
    stamp("phase 15 (the sweep's upload, page-locked against pageable)")
    rc = phase_roots_circuits(tx_block, card, dev)
    stamp("phase 16 (roots, circuits)")

    # ---- 17-18. the sharded layer and the CLI -----------------------------
    par = phase_parallel(entries, swp, card, dev)
    del swp["world"], swp["gp"]
    stamp("phase 17 (parallel)")
    cli = phase_cli(repo, card)
    stamp("phase 18 (cli)")

    # ---- 19-20. BASELINE configs 4 and 6 ----------------------------------
    mixed = phase_mixed(card, dev)
    k1_err = max(k1_err, mixed["err"])
    k2_err["hinted"] = max(k2_err["hinted"], mixed["err"])
    stamp("phase 19 (config 4, mixed batch)")
    distinct = phase_distinct(card, dev)
    k1_err = max(k1_err, distinct["err"]["k1"])
    k2_err["hinted"] = max(k2_err["hinted"], distinct["err"]["k2"])
    stamp("phase 20 (config 6, 2^20 distinct accounts)")
    torch.cuda.empty_cache()  # the bench processes allocate on the same card
    bench = phase_bench(repo)
    stamp("phase 21 (the bench programs)")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "zk_state_proofs_tpu"))
    check(not loaded, f"JAX or the JAX package was imported: {loaded}")

    # ---- the kernels line -------------------------------------------------
    # each main path's launches, counted from zero over its own run (phases
    # 5, 9, 11, 12, 15, 16, 17, 18, 19, 20 and 21; phase 17's are its
    # world-size-1 run's and both spawned ranks', phase 21's the bench
    # processes'); `launches` is their sum.
    # K2 `exact` also gives the guarded launches that walked (`walked`, the
    # device tally). K1 and K2 `hinted` also give their bounds at configs 4
    # and 6's shapes (`bound_ms_by_path`) and their times at config 6's
    # (`ms_by_path`: K1 over the pool, K2 alone on one window).
    by_path = {"accounts": launches, "storage": sto["launches"],
               "hint_modes": hm["launches"], "blocks": blk["launches"],
               "sweeps": swp["launches"], "roots_circuits": rc["launches"],
               "parallel": par["launches"], "cli": cli["launches"],
               "mixed": mixed["launches"], "distinct_1m": distinct["launches"],
               "bench": bench["launches"]}
    src = "zk_state_proofs_tpu_torch/csrc/"
    kernels = [kernel_row(
        "keccak256", src + "keccak.cu", "zk_state_proofs_tpu/ops/keccak_pallas.py:122",
        by_path, "keccak256", k1_err, k1_ms, k1_plain_ms, bound["k1"])]
    kernels[-1]["bound_ms_by_path"] = {p: r["bound"]["k1"][0] for p, r in (
        ("mixed", mixed), ("distinct_1m", distinct))}
    kernels[-1]["ms_by_path"] = {"distinct_1m": distinct["ms"]["k1"]}
    # the `exact` row's error includes the re-run's: the flag folded into
    # the first walk against guard_plain, the guarded launch's outputs
    # against the plain route (phases 4, 6 and 15)
    k2_err["exact"] = max(k2_err["exact"], fold_err, swp["err"]["fold"])
    for mode in ("hinted", "exact"):
        kernels.append(kernel_row(
            f"mpt_walk_{mode}", src + "mpt_walk.cu",
            "zk_state_proofs_tpu/ops/mpt_pallas.py:165", by_path, mode,
            k2_err[mode], k2[mode][0], k2[mode][1], bound[mode]))
    kernels[1]["bound_ms_by_path"] = {p: r["bound"]["hinted"][0] for p, r in (
        ("mixed", mixed), ("distinct_1m", distinct))}
    kernels[1]["ms_by_path"] = {"distinct_1m": distinct["ms"]["hinted"]}
    walked = {path: counts["exact_walked"] for path, counts in by_path.items()}
    kernels[-1].update(walked=sum(walked.values()), walked_by_path=walked)
    for mode in VARIANTS:
        kernels.append(kernel_row(
            f"mpt_walk_{mode}", src + "mpt_walk.cu",
            "zk_state_proofs_tpu/ops/mpt_pallas.py:165", by_path, mode,
            hm["err"][mode], k2[mode][0], k2[mode][1], bound["hinted"]))
    kernels.append(kernel_row(
        "mpt_walk_bounded", src + "mpt_walk.cu",
        "zk_state_proofs_tpu/ops/mpt_pallas.py:165", by_path, "bounded",
        bnd["err"], sto["bounded_ms"], sto["bounded_plain_ms"], sto["bounded_bound"]))
    # K3 is on no main path (as in the JAX package): 0 launches there
    kernels.append(kernel_row(
        "keccak256_raw", src + "keccak.cu", "zk_state_proofs_tpu/ops/keccak_pallas.py:211",
        by_path, "keccak256_raw", k3["err"], k3["ms"], k3["plain_ms"], bound["k3"]))
    kernels[-1]["device_us"] = {"k3": k3["device_us"]["K3"], "k1": k3["device_us"]["K1"]}
    # K4 and K5: the JAX package's device stages, not Pallas kernels; times
    # at config 4's pool (K4) and phase 10's account values (K5)
    k4, k5 = mixed["k4"], sto["k5"]
    no_library = "no PyTorch call computes an RLP item chain"
    kernels.append(kernel_row(
        "item_offsets", src + "rlp.cu", "zk_state_proofs_tpu/ops/rlp.py:201", by_path,
        "item_offsets", max(k4_err, k4["err"], distinct["k4"]["err"], bt["k4_err"],
        swp["err"]["k4"]), k4["ms"], k4["plain_ms"], k4["bound"]))
    kernels[-1].update(library_ms_reason=no_library, device_us=k4["device_us"],
                       pallas="none: the JAX package's device stage",
                       ms_by_path={"distinct_1m": distinct["k4"]["ms"]},
                       plain_ms_by_path={"distinct_1m": distinct["k4"]["plain_ms"]},
                       bound_ms_by_path={"distinct_1m": distinct["k4"]["bound"][0]})
    kernels.append(kernel_row(
        "decode_account", src + "rlp.cu", "zk_state_proofs_tpu/ops/account.py:30", by_path,
        "decode_account", k5["err"], k5["ms"], k5["plain_ms"], k5["bound"]))
    kernels[-1].update(library_ms_reason=no_library, device_us=k5["device_us"],
                       pallas="none: the JAX package's device stage")
    log(f"[bound] the least time for each kernel's work: bytes over "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, 32-bit integer operations over "
        f"{INT32_OPS_PER_S / 1e12:.2f} T/s, the larger of the two")
    log(f"[time] the whole run: {time.time() - _CLOCK['start']:.1f} s on {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


def mixed_sweep_witness(w):
    """A 4096-proof witness over the sweep world's trie, shuffled: 3960
    honest accounts, 64 absent keys (EXCLUDED), 64 tampered leaves
    (INVALID) and 8 proofs through inline nodes (which latch the hinted
    walk, so the guarded `exact` walk runs)."""
    rng = np.random.default_rng(11)
    rows = rng.permutation(w.n_accounts)
    entries = w.entries(rows[:3960])
    for i in range(64):
        key = oracle_keccak(b"smoke-sweep-absent-%d" % i)
        entries.append((w.root, w.trie.get_proof(key), key))
    for r in rows[3960:4024]:
        proof = list(w.proofs[r])
        proof[-1] = proof[-1][:-1] + bytes([proof[-1][-1] ^ 1])
        entries.append((w.root, proof, w.keys[r]))
    entries += adversarial_entries(w.entries(range(16)))[1][:8]
    return [entries[i] for i in rng.permutation(len(entries))]


def form_line(name, res):
    return (f"{name}: {res.total} proofs in {res.batches} batches, {res.seconds:.4f} s = "
            f"{res.proofs_per_sec:,.0f} proofs/s (counts_only); pack "
            f"{res.pack_seconds:.4f} s, dispatch {res.dispatch_seconds:.4f} s, drain "
            f"{res.drain_seconds:.4f} s")


def phase_sweeps(card, dev):
    """Phase 15: config 5's sweeps on the card, every form; a mixed
    witness through every form against the plain route; launches per
    batch, the device-busy share of an epoch batch."""
    t0 = time.time()
    w = sweep_world(SWEEP_ACCOUNTS)
    world_s = time.time() - t0
    t0 = time.time()
    gp = w.pack()
    pack_s = time.time() - t0
    n = gp.nodes.shape[2]
    longest = int(gp.node_lens.max())
    check(longest < n, f"a sweep node is {longest} B long, not under N = {n}: the epoch "
                       f"counter would land on a node byte")
    depth = {int(d): int(c) for d, c in enumerate(np.bincount(gp.num_nodes)) if c}
    log(f"[witness] config 5 sweep world: {w.n_accounts} accounts built in {world_s:.1f} s, "
        f"packed in {pack_s:.2f} s; nodes {tuple(gp.nodes.shape)} "
        f"({gp.nodes.nbytes / 1e6:.1f} MB), pool {tuple(gp.pool()[0].shape)}, longest node "
        f"{longest} of {n} B, proofs by depth {depth}")
    steps = w.max_nodes
    kw = dict(max_steps=steps, device=dev)
    epochs = SWEEP_BATCHES * SWEEP_BATCH // w.n_accounts
    rng = np.random.default_rng(SWEEP_SEED)
    # a fixed pool-row bucket for the streamed entries (bench_configs.py:577-583)
    probe = pack_proofs(next(w.entry_batches(1, SWEEP_BATCH, np.random.default_rng(5))),
                        max_nodes=steps, node_len=n)
    pool_rows = -(-int(probe.pool()[0].shape[0] * 1.125) // 128) * 128
    total = SWEEP_BATCHES * SWEEP_BATCH

    # the main path of this phase, counted from zero
    zero_counts()
    res = {}
    sweep_resident_epochs(gp, epochs, SWEEP_BATCH, salt=101, forbid_sync=True, **kw)
    before = dict(mpt_cuda.LAUNCHES)
    res["epochs"] = sweep_resident_epochs(gp, epochs, SWEEP_BATCH, salt=7, forbid_sync=True,
                                          **kw)
    per_batch = {k: (mpt_cuda.LAUNCHES[k] - before[k]) / res["epochs"].batches
                 for k in before if mpt_cuda.LAUNCHES[k] != before[k]}
    check(per_batch == {"hinted": 1, "exact": 1},
          f"an epoch batch launched {per_batch}: one hinted and one exact launch expected")
    sweep_resident(gp, w.index_batches(16, SWEEP_BATCH, rng), fused=True, **kw)
    res["fused"] = sweep_resident(gp, w.index_batches(SWEEP_BATCHES, SWEEP_BATCH, rng),
                                  fused=True, forbid_sync=True, **kw)
    res["streamed"] = sweep_resident(gp, w.index_batches(SWEEP_BATCHES, SWEEP_BATCH, rng), **kw)
    res["streamed, pool gathers"] = sweep_resident(
        gp, w.index_batches(16, SWEEP_BATCH, rng), materialize=False, **kw)
    sweep_entries(w.entry_batches(4, SWEEP_BATCH, rng), steps, n, pool_rows=pool_rows,
                  device=dev)
    res["entries"] = sweep_entries(w.entry_batches(SWEEP_BATCHES, SWEEP_BATCH, rng), steps, n,
                                   pool_rows=pool_rows, prefetch=2, forbid_sync=True,
                                   device=dev)
    res["replicated"] = sweep(replicated_batches(probe, 16), **kw)
    for name, r in res.items():
        want = {"epochs": total, "fused": total, "streamed": total, "entries": total,
                "streamed, pool gathers": 16 * SWEEP_BATCH, "replicated": 16 * SWEEP_BATCH}
        check(r.total == want[name] and r.found == r.total,
              f"sweep {name}: {r.found} of {r.total} proofs FOUND, {want[name]} expected")
    check(mpt_cuda.exact_walked(dev) == 0, "an honest sweep batch walked the guarded exact kernel")
    for name, r in res.items():
        log(f"[15 sweeps] {form_line(name, r)} on {card}")

    # the mixed witness through every form, against the plain route on the card
    mixed = mixed_sweep_witness(w)
    mp = pack_proofs(mixed, max_nodes=max(len(p) for _, p, _ in mixed), node_len=n)
    t = packed_to_tensors(mp, dev)
    plain_mixed = plain_pooled([t[k] for k in BATCH_FIELDS], [t[k] for k in POOL_FIELDS],
                               t["pool_hints"], max_value_len=128, max_steps=steps)
    status = plain_mixed[0].cpu().numpy()
    count = lambda st: [int((st == c).sum()) for c in (mpt.FOUND, mpt.EXCLUDED, mpt.INVALID)]
    summed = lambda parts: [sum(c) for c in zip(*(count(status[p]) for p in parts))]
    check(count(status) == [3960 + 8, 64, 64], f"the mixed witness on the plain route: {count(status)}")
    mrng = np.random.default_rng(SWEEP_SEED + 1)
    sels = [mrng.permutation(mp.batch)[:SWEEP_BATCH] for _ in range(8)]
    windows = [slice(s, s + SWEEP_BATCH) for s in epoch_windows(mp.batch, SWEEP_BATCH)]
    mixed_batch = pack_proofs([mixed[i] for i in sels[0]], max_nodes=mp.nodes.shape[1], node_len=n)
    mk = dict(max_steps=steps, device=dev)
    got = {
        "epochs": (sweep_resident_epochs(mp, 2, SWEEP_BATCH, salt=3, forbid_sync=True, **mk),
                   summed(windows * 2)),
        "fused": (sweep_resident(mp, iter(sels), fused=True, forbid_sync=True, **mk),
                  summed(sels)),
        "streamed": (sweep_resident(mp, iter(sels[:4]), **mk), summed(sels[:4])),
        "streamed, pool gathers": (sweep_resident(mp, iter(sels[:4]), materialize=False, **mk),
                                   summed(sels[:4])),
        "replicated": (sweep(replicated_batches(mixed_batch, 2), **mk), summed(sels[:1] * 2)),
        "replicated, no pool": (sweep(replicated_batches(mixed_batch, 2), dedup=False, **mk),
                                summed(sels[:1] * 2))}
    for dedup in (True, False):
        got[f"entries, dedup={dedup}"] = (
            sweep_entries(([mixed[i] for i in s] for s in sels[:4]), mp.nodes.shape[1], n,
                          dedup=dedup, forbid_sync=True, device=dev),
            summed(sels[:4]))
    walked = mpt_cuda.exact_walked(dev)
    for name, (r, want) in got.items():
        check([r.found, r.excluded, r.invalid] == want,
              f"mixed witness, sweep form {name}: {[r.found, r.excluded, r.invalid]}, the "
              f"plain route {want}")
    check(walked > 0, "the mixed witness did not walk the guarded exact kernel")
    launches = read_counts()
    for name in ("keccak256", "item_offsets", "hinted", "bounded", "exact", "exact_walked"):
        check(launches[name] > 0, f"the sweeps launched the {name} kernel no time")
    log(f"[15 sweeps] the epoch, fused and entries batch loops ran under "
        f"torch.cuda.set_sync_debug_mode('error'); every honest proof FOUND; no honest batch "
        f"walked exact; the mixed witness ({count(status)} FOUND / EXCLUDED / INVALID on the "
        f"plain route) gave the plain route's counts in every form ({', '.join(got)}), the "
        f"guarded exact walk ran {walked} times; launches {launches}")

    # per batch: launches, device time, the device-busy share of an epoch batch
    tables = epoch_tables(gp, dev)
    starts = [int(x) for x in epoch_windows(gp.batch, SWEEP_BATCH)]

    def one(i):
        s0 = starts[i % len(starts)]
        return epoch_batch(tables, s0, SWEEP_BATCH, i & 0xFF, 128, steps, dev)

    dev_us = lower(device_us(one), device_us(one))
    prof = device_profile(one, 10)
    wall_ms = 1e3 * res["epochs"].seconds / res["epochs"].batches
    busy = "not measured" if dev_us is None else f"{100 * dev_us / 1e3 / wall_ms:.1f}%"
    top = "; ".join(f"{nm[:40]} {ms * 1e3:.1f} us x{c:.0f}" for nm, ms, c in prof["top"])
    log(f"[15 time] epoch batch of {SWEEP_BATCH} proofs {tuple(tables['nodes'][:SWEEP_BATCH].shape)}: "
        f"host {wall_ms:.4f} ms a batch in the sweep, device {us_text(dev_us)} a batch "
        f"({DEVICE_TIMING}): device busy {busy} of the sweep's time; wrapper launches a batch "
        f"{per_batch}; torch.profiler over 10 batches: {prof['launches']:.0f} device launches "
        f"a batch, busy {prof['busy_ms']:.4f} ms, top {top} on {card}")
    log(f"[15 launches] an epoch batch: wrapper launches {per_batch}, "
        f"{prof['launches']:.0f} device launches recorded by torch.profiler")
    err = sweep_kernel_check(gp, tables, mp, t, plain_mixed, steps, dev)
    del tables

    return {"launches": launches, "err": err, "world": w,
            "gp": gp, "epochs": res["epochs"], "pool_rows": pool_rows}


def phase_upload(gp, card, dev):
    """Phase 15's upload A/B on config 5's witness: its upload arrays
    copied to new device tensors from the page-locked staging that the
    resident sweeps copy from (queued, one sync at the end) and by a plain
    pageable `.to(dev)` of the same arrays, in UPLOAD_REPS turns; host ms
    to the copies' end and GB/s of each (the median turn); the seconds of
    a fresh staging of the same arrays; the epoch tables built through the
    staging equal, byte for byte, those built from the pageable copy."""
    arrays = _upload_arrays(gp)
    t0 = time.perf_counter()
    fresh = _PinnedStaging(arrays)
    stage_s = time.perf_counter() - t0
    del fresh
    staged = _pinned_staging(gp, arrays).tensors
    nbytes = sum(h.nbytes for h in staged.values())

    def pinned():
        out = {k: h.to(dev, non_blocking=True) for k, h in staged.items()}
        torch.cuda.current_stream(dev).synchronize()
        return out

    def pageable():
        out = {name: torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(dev)
               for a, (name, dt) in zip(arrays, _UPLOAD)}
        torch.cuda.synchronize()
        return out

    ms = {"page-locked": [], "pageable": []}
    for _ in range(UPLOAD_REPS):
        for name, fn in (("page-locked", pinned), ("pageable", pageable)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ms[name].append(1e3 * (time.perf_counter() - t0))
    med = {k: float(np.median(v)) for k, v in ms.items()}
    rate = {k: nbytes / v / 1e6 for k, v in med.items()}
    t = epoch_tables(gp, dev)
    check(t["pinned_bytes"] == nbytes, f"epoch_tables copied {t['pinned_bytes']} B from "
                                       f"page-locked memory, not the upload's {nbytes}")
    r = pageable()
    r["dig"] = mpt.hash_pool(r["pool"], r["plens"])
    nodes, lens, dh = _expand_tables(r)
    a, d = r["idx"].shape
    for k, want in (("nodes", nodes.view(a, d, -1)), ("lens", lens), ("dh", dh.view(a, d, 68)),
                    ("num", r["num"]), ("roots", r["roots"]), ("knib", r["knib"]),
                    ("klen", r["klen"])):
        check(t[k].dtype == want.dtype and torch.equal(t[k], want),
              f"the epoch table {k} through the page-locked staging differs from the one "
              f"built from a pageable copy")
    del t, r, nodes, lens, dh
    log(f"[15 upload] config 5's witness upload ({nbytes / 1e6:.1f} MB: pool "
        f"{tuple(staged['pool'].shape)}, index {tuple(staged['idx'].shape)}, scalars), host ms "
        f"to the copies' end, median of {UPLOAD_REPS} turns: page-locked staging "
        f"{med['page-locked']:.3f} ms = {rate['page-locked']:.2f} GB/s, pageable .to(dev) "
        f"{med['pageable']:.3f} ms = {rate['pageable']:.2f} GB/s "
        f"({med['pageable'] / med['page-locked']:.2f}x); turns {ms}; a fresh staging "
        f"{stage_s:.3f} s; the epoch tables through the staging == those from the pageable "
        f"copy, byte for byte, on {card}")
    return {"bytes": nbytes, "ms": med, "gb_per_s": rate, "stage_s": stage_s}


def sweep_kernel_check(gp, tables, mp, t, plain_mixed, steps, dev):
    """The sweep path's kernels against their plain versions, proof by
    proof, at the shapes the path gives them: K1 over the whole sweep pool;
    through epoch_batch, the last epoch window of the world (K2 `hinted` on
    the device pass's hints; no flag latches, the guarded `exact` launch
    returns at once) and the whole mixed witness (its flags latch, so the
    guarded `exact` launch walks), each proof's status, value, value length
    and INVALID reason, and the folded re-run flag of each (fold_checks);
    the mixed witness through verify_proofs_indexed (pack-time hints) and
    verify_proofs_pool_stream (a fresh pool, the device pass's hints)
    against the plain route. Returns the largest errors of K1, K2 and the
    folded flag (0: identical)."""
    pool_nodes, pool_lens, _ = gp.pool()
    pn = torch.from_numpy(pool_nodes).to(dev)
    pl = torch.from_numpy(pool_lens.astype(np.int32)).to(dev)
    k1 = max_err([mpt.hash_pool(pn, pl)], [tkeccak.keccak256(pn, pl)])
    check(k1 == 0, f"K1 differs from plain keccak on the sweep pool {tuple(pn.shape)} "
                   f"(max abs err {k1})")
    _, k4 = hint_pass_check(pn, "the sweep pool", torch.from_numpy(gp.pool_hints()).to(dev))
    del pn, pl
    mtables = epoch_tables(mp, dev)
    last = int(epoch_windows(gp.batch, SWEEP_BATCH)[-1])
    errs, shapes, fold = {}, {}, {}
    for name, tb, s0, latches in (("world window", tables, last, False),
                                  ("mixed witness", mtables, 0, True)):
        walked = mpt_cuda.exact_walked(dev)
        got = epoch_batch(tb, s0, SWEEP_BATCH, 0xA5, 128, steps, dev)
        ran = mpt_cuda.exact_walked(dev) - walked
        w = slice(s0, s0 + SWEEP_BATCH)
        dh = tb["dh"][w]
        batch = [tb[k][w] for k in ("nodes", "lens", "num", "roots", "knib", "klen")]
        args = (*batch[:3], dh[..., :32], *batch[3:], 128, steps)
        reasons = mpt_cuda.walk_batch_cuda(*args, hints=dh[..., 32:], with_reasons=True)[3]
        want = plain_walk(batch, dh[..., :32], dh[..., 32:], 128, steps, with_reasons=True)
        errs[name] = max_err([*got, reasons], want)
        fold[name], n = fold_checks(args, [(f"the {name}", dh[..., 32:])])
        check((n[0] > 0) == latches, f"the {name}: {n[0]} proofs latched the folded flag")
        shapes[name] = tuple(batch[0].shape)
        check(errs[name] == 0, f"epoch_batch on the {name} differs from the plain walk "
                               f"(max abs err {errs[name]})")
        check(ran == int(latches), f"epoch_batch on the {name}: the guarded exact launch "
                                   f"walked {ran} times, {int(latches)} expected")
    del mtables
    pool = [t[k] for k in POOL_FIELDS]
    scalars = [t[k] for k in ("num_nodes", "roots", "key_nibbles", "key_lens")]
    dig = mpt.hash_pool(pool[0], pool[1])
    errs["indexed"] = max_err(mpt.verify_proofs_indexed(
        pool[0], pool[1], dig, pool[2], *scalars, pool_hints=t["pool_hints"],
        max_steps=steps, device=dev), plain_mixed)
    errs["pool stream"] = max_err(mpt.verify_proofs_pool_stream(
        *pool, *scalars, max_steps=steps, device=dev), plain_mixed)
    k2 = max(errs.values())
    check(k2 == 0, f"the sweep's entry points differ from the plain route: {errs}")
    check(max(fold.values()) == 0, f"the folded re-run flag on the sweep's batches: {fold}")
    log(f"[15 check] proof by proof, bit for bit: K1 == plain keccak and K4 == its plain "
        f"version and the host's hints on the sweep pool {pool_nodes.shape}; epoch_batch == "
        f"the plain walk (status, value, value length, reason) on the world's last window "
        f"{shapes['world window']} (exact not walked) and "
        f"the mixed witness {shapes['mixed witness']} (the guarded exact walked); "
        f"verify_proofs_indexed (pack-time hints) and verify_proofs_pool_stream on the "
        f"mixed witness == the plain route; max abs err {errs}; the re-run flag folded into "
        f"the first walk == guard_plain on both epoch windows, the guarded exact launch "
        f"walked where it latched (max abs err {fold})")
    return {"k1": k1, "k2": k2, "k4": k4, "fold": max(fold.values())}


def storage_circuit_input(w, a):
    """The storage guest's input for account row `a` of a StorageWorld (its
    account proof and slot proofs), and one for a slot absent from its
    storage trie, with the trie's proof of that absence."""
    root, account_proof, addr_key = w.account_entries[a]
    rows = np.flatnonzero(w.slot_accounts == a)
    inp = StorageProofInput(
        account_proof=account_proof, storage_proofs=[w.storage_entries[r][1] for r in rows],
        root_hash=root, account_key=addr_key,
        storage_keys=[bytes(w.slots[r]) for r in rows], address_keccak=addr_key)
    nk = default_hasher()
    st = EthTrie(hasher=nk)  # account a's storage trie, as storage_world builds it
    for i in range(STORAGE_WORLD[2]):
        st.insert(nk(a.to_bytes(16, "big") + i.to_bytes(16, "big")),
                  rlp.encode_int((a << 20) + i + 1))
    check(st.root_hash() == w.storage_entries[rows[0]][0], "storage trie rebuilt wrongly")
    absent = a.to_bytes(16, "big") + (1 << 20).to_bytes(16, "big")
    missing = StorageProofInput(
        account_proof=account_proof, storage_proofs=[st.get_proof(nk(absent))],
        root_hash=root, account_key=addr_key, storage_keys=[absent], address_keccak=addr_key)
    return inp, [w.slot_values[r] for r in rows], missing


def phase_roots_circuits(tx_block, card, dev):
    """Phase 16: trie roots on the card against the blocks' roots and the
    plain reduction; the circuit entry points against the oracle's bytes."""
    fx = synthetic_block(*ROOT_BLOCK)
    rplan = plan_index_trie([encode_receipt(r) for r in fx["receipts"]])
    txs = tx_block["transactions"]
    tplan = plan_index_trie([encode_transaction(tx) for tx in txs])
    inputs = [x.to_borsh() for x in get_all_transaction_proof_inputs(tx_block)]
    sw = storage_world(4, 8, STORAGE_WORLD[2])
    inp, values, missing = storage_circuit_input(sw, 2)

    # the main path of this phase, counted from zero
    zero_counts()
    t0 = time.time()
    r_root, r_dig = compute_root(rplan, device=dev)
    t_root, t_dig = compute_root(tplan, device=dev)
    committed = run_merkle_circuit_batch(inputs, device=dev)
    single = run_merkle_circuit(inputs[5], device=dev)
    stored = run_storage_circuit(inp.to_borsh(), device=dev)
    try:
        run_storage_circuit(missing.to_borsh(), device=dev)
        absent = "returned"
    except MissingKeyError:
        absent = "MissingKeyError"
    torch.cuda.synchronize()
    host_s = time.time() - t0
    launches = read_counts()
    for name in ("keccak256", "hinted", "bounded"):
        check(launches[name] > 0, f"roots and circuits launched the {name} kernel no time")

    check("0x" + bytes(r_root).hex() == fx["block"]["receiptsRoot"],
          "compute_root of the receipt trie differs from the block's receiptsRoot")
    check("0x" + bytes(t_root).hex() == tx_block["transactionsRoot"],
          "compute_root of the transaction trie differs from the block's transactionsRoot")
    for plan, dig in ((rplan, r_dig), (tplan, t_dig)):
        check(np.array_equal(dig, compute_root(plan, device="cpu")[1]),
              "compute_root on the card differs from the plain reduction")
    encoded = [encode_transaction(tx) for tx in txs]
    check(committed == encoded and single == encoded[5],
          "run_merkle_circuit_batch did not commit the encoded transactions")
    check(stored == values, "run_storage_circuit did not commit the slot values")
    check(absent == "MissingKeyError", f"an absent slot: run_storage_circuit {absent}")
    log(f"[16 roots] compute_root on the card: the receipt trie of synthetic_block"
        f"{ROOT_BLOCK} ({rplan.num_levels} levels, {rplan.total_nodes} nodes) equals its "
        f"receiptsRoot, the transaction trie of the {len(txs)}-tx block ({tplan.num_levels} "
        f"levels, {tplan.total_nodes} nodes) its transactionsRoot, every digest equal to the "
        f"plain reduction's")
    log(f"[16 circuits] run_merkle_circuit_batch committed the {len(txs)} encoded txs (up "
        f"to {max(map(len, encoded))} B), run_merkle_circuit tx 5; run_storage_circuit "
        f"committed the {len(values)} slot values of storage_world account 2, an absent "
        f"slot raised MissingKeyError ({host_s:.2f} s host time for the phase's calls); "
        f"launches {launches}")
    return {"launches": launches}


def entry_pool_rows(w, n):
    """A fixed pool-row bucket for config 5's streamed entries
    (bench_configs.py:577-583): the first batch's pool rows plus 12.5%,
    rounded up to 128."""
    probe = pack_proofs(next(w.entry_batches(1, SWEEP_BATCH, np.random.default_rng(5))),
                        max_nodes=w.max_nodes, node_len=n)
    return -(-int(probe.pool()[0].shape[0] * 1.125) // 128) * 128


def parallel_witness(entries=None, sweep_witness=None):
    """Phase 17's witnesses, built alike in every process: the headline
    accounts and their three service requests, the storage world, config
    5's receipt trie and sweep world."""
    t0 = time.time()
    if entries is None:
        entries, _ = account_entries(N_ACCOUNTS)
    w, gp = sweep_witness if sweep_witness is not None else (sweep_world(SWEEP_ACCOUNTS), None)
    if gp is None:
        gp = w.pack()
    sto = storage_world(*STORAGE_WORLD)
    fx = synthetic_block(*ROOT_BLOCK)
    adv, inline = adversarial_entries(entries)
    return {"entries": entries, "headline": pack_proofs(entries, node_len=576),
            "requests": [entries, entries[::3], adv + inline + entries[:N_ACCOUNTS // 8]],
            "storage": (*sto.pack(), sto.slots, sto.slot_accounts), "fx": fx,
            "rplan": plan_index_trie([encode_receipt(r) for r in fx["receipts"]]),
            "world": w, "gp": gp, "seconds": time.time() - t0}


def parallel_checks(mesh, wit, dev):
    """Every sharded entry point once over `mesh`, at full size, launches
    counted from zero. Returns the outputs (numpy), the counts of the
    sweeps, each call's seconds and the launches."""
    w, gp = wit["world"], wit["gp"]
    n = gp.nodes.shape[2]
    epochs = SWEEP_BATCHES * SWEEP_BATCH // w.n_accounts
    rows = entry_pool_rows(w, n)
    zero_counts()
    out, secs = {}, {}

    def timed_call(name, fn):
        t0 = time.perf_counter()
        r = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs[name] = time.perf_counter() - t0
        return r

    # each call twice: the first pays for the group's first collectives
    # (NCCL's communicator is made at its first use)
    for call in ("first call", "again"):
        out["verify"] = timed_call(f"verify_proofs_sharded, {call}",
                                   lambda: verify_proofs_sharded(mesh, wit["headline"]))
        out["storage"] = timed_call(f"verify_storage_grouped_sharded, {call}",
                                    lambda: verify_storage_grouped_sharded(mesh,
                                                                           *wit["storage"]))
        out["root"] = timed_call(f"compute_root_sharded, {call}",
                                 lambda: compute_root_sharded(mesh, wit["rplan"]))
    res = sweep_resident_epochs(gp, epochs, SWEEP_BATCH, salt=7, max_steps=w.max_nodes,
                                mesh=mesh, forbid_sync=True, device=dev.type)
    out["epochs"] = [res.found, res.excluded, res.invalid, res.total, res.batches]
    secs["sweep_resident_epochs"] = res.seconds
    res = sweep_entries(w.entry_batches(PAR_ENTRY_BATCHES, SWEEP_BATCH,
                                        np.random.default_rng(SWEEP_SEED + 2)),
                        w.max_nodes, n, pool_rows=rows, mesh=mesh, forbid_sync=True,
                        device=dev.type)
    out["entries"] = [res.found, res.excluded, res.invalid, res.total, res.batches]
    secs["sweep_entries"] = res.seconds
    secs["its packing (worker thread)"] = res.pack_seconds
    svc = BatchVerifier(BucketConfig.account(), N_ACCOUNTS, mesh=mesh, device=dev.type)
    svc.warmup(wit["entries"])
    served = timed_call("BatchVerifier.verify x3",
                        lambda: [svc.verify(r) for r in wit["requests"]])
    out["service"] = [(r.status, r.values, r.value_lens) for r in served]
    launches = read_counts()
    # the dry run's small shapes, counted apart from the full-size calls
    zero_counts()
    timed_call(f"dryrun_multichip({mesh.size})",
               lambda: dryrun_multichip(mesh.size, device=dev.type))
    return {"out": out, "seconds": secs, "launches": launches,
            "dryrun_launches": read_counts(), "rank": mesh.rank, "mesh": repr(mesh),
            "witness_seconds": wit["seconds"]}


SIZES = ("N_ACCOUNTS", "STORAGE_WORLD", "ROOT_BLOCK", "SWEEP_ACCOUNTS", "SWEEP_BATCH",
         "SWEEP_BATCHES", "SWEEP_SEED", "PAR_ENTRY_BATCHES", "DEVICE")


def parallel_rank(sizes):
    """One spawned rank of phase 17's gloo group, at the parent's sizes:
    its own witnesses, then parallel_checks on the shared card."""
    globals().update(sizes)
    torch.set_num_threads(4)
    mesh = make_mesh(device=DEVICE)
    return parallel_checks(mesh, parallel_witness(), mesh.device)


def same_outputs(got, want, what):
    """Bit equality of two parallel_checks outputs (nested numpy)."""
    if isinstance(want, dict):
        check(got.keys() == want.keys(), f"{what}: keys {list(got)}, {list(want)} expected")
        for k in want:
            same_outputs(got[k], want[k], f"{what} {k}")
    elif isinstance(want, (list, tuple)):
        check(len(got) == len(want), f"{what}: {len(got)} parts, {len(want)} expected")
        for i, (g, x) in enumerate(zip(got, want)):
            same_outputs(g, x, f"{what}[{i}]")
    else:
        g, x = np.asarray(got), np.asarray(want)
        check(g.shape == x.shape and g.dtype == x.dtype and np.array_equal(g, x),
              f"{what}: differs ({g.shape} {g.dtype} vs {x.shape} {x.dtype})")


def phase_parallel(entries, swp, card, dev):
    """Phase 17: the sharded layer at world size 1 over NCCL (each result
    against the unsharded call), then PAR_RANKS gloo ranks sharing the
    card (each result against world size 1's)."""
    wit = parallel_witness(entries, (swp["world"], swp["gp"]))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    t0 = time.time()
    initialize(f"127.0.0.1:{free_port()}", 1, 0, backend=backend, timeout_s=PAR_TIMEOUT_S)
    try:
        mesh = make_mesh(device=dev.type)
        one = parallel_checks(mesh, wit, dev)
    finally:
        dist.destroy_process_group()
    one_s = time.time() - t0
    out = one["out"]

    # world size 1 against the unsharded calls
    ref = verify_merkle_batch(wit["headline"], device=dev)
    same_outputs(out["verify"][:3], (ref.status, ref.values, ref.value_lens),
                 "verify_proofs_sharded against verify_merkle_batch")
    check(out["verify"][3].tolist() == [N_ACCOUNTS, 0, 0],
          f"verify_proofs_sharded counts {out['verify'][3].tolist()}")
    ap, sp, slots, sa = wit["storage"]
    sref = verify_storage_grouped(ap, sp, slots, sa, device=dev)
    same_outputs(out["storage"][:5], (sref.account_status, sref.storage_root,
                                      sref.slot_status, sref.slot_values,
                                      sref.slot_value_lens),
                 "verify_storage_grouped_sharded against verify_storage_grouped")
    check(out["storage"][5].tolist() == [sp.batch, 0, 0],
          f"sharded storage counts {out['storage'][5].tolist()}")
    same_outputs(out["root"], compute_root(wit["rplan"], device=dev),
                 "compute_root_sharded against compute_root")
    check("0x" + bytes(out["root"][0]).hex() == wit["fx"]["block"]["receiptsRoot"],
          "compute_root_sharded differs from the block's receiptsRoot")
    e = swp["epochs"]
    check(out["epochs"] == [e.found, e.excluded, e.invalid, e.total, e.batches]
          and e.found == e.total == SWEEP_BATCHES * SWEEP_BATCH,
          f"sharded epoch sweep {out['epochs']}, unsharded {e}")
    total = PAR_ENTRY_BATCHES * SWEEP_BATCH
    check(out["entries"] == [total, 0, 0, total, PAR_ENTRY_BATCHES],
          f"sharded sweep_entries {out['entries']}")
    plain = BatchVerifier(BucketConfig.account(), N_ACCOUNTS, device=dev)
    plain.warmup(wit["entries"])  # the pool-row bucket of the headline, as the mesh's
    for i, req in enumerate(wit["requests"]):
        r = plain.verify(req)
        same_outputs(out["service"][i], (r.status, r.values, r.value_lens),
                     f"BatchVerifier(mesh=) request {i} against BatchVerifier")
    check(bool((out["service"][0][0] == mpt.FOUND).all()), "a headline request proof not FOUND")
    for name in ("keccak256", "hinted", "bounded", "exact"):
        check(one["launches"][name] > 0, f"the sharded paths launched the {name} kernel no time")
    log(f"[17 parallel] world size 1 over {backend} ({one['mesh']}): verify_proofs_sharded "
        f"on the {N_ACCOUNTS}-proof headline, verify_storage_grouped_sharded on "
        f"storage_world{STORAGE_WORLD}, compute_root_sharded on the receipt trie of "
        f"synthetic_block{ROOT_BLOCK} (its receiptsRoot), BatchVerifier(mesh=) on 3 requests: "
        f"each equal to the unsharded call bit for bit; sweep_resident_epochs(mesh=) "
        f"{out['epochs'][3]} proofs in {out['epochs'][4]} batches and sweep_entries(mesh=) "
        f"{out['entries'][3]} proofs: every proof FOUND, the unsharded counts; "
        f"dryrun_multichip(1) ok; {one_s:.1f} s; launches {one['launches']}, the dry run's "
        f"apart {one['dryrun_launches']}")

    # PAR_RANKS gloo ranks sharing the card: each builds its own witnesses
    t0 = time.time()
    ranks = run_ranks(parallel_rank, PAR_RANKS, "gloo", args=({k: globals()[k] for k in SIZES},),
                      timeout_s=PAR_TIMEOUT_S)
    ranks_s = time.time() - t0
    for r in ranks:
        same_outputs(r["out"], out, f"rank {r['rank']} of {PAR_RANKS} against world size 1")
        for name in ("keccak256", "hinted", "bounded", "exact"):
            check(r["launches"][name] > 0,
                  f"rank {r['rank']} launched the {name} kernel no time")
    built = ", ".join(f"{r['witness_seconds']:.1f}" for r in ranks)
    log(f"[17 parallel] {PAR_RANKS} ranks over gloo on one card ({ranks[0]['mesh']}, "
        f"{ranks[1]['mesh']}): every output equal to world size 1's bit for bit (the same "
        f"{out['epochs'][3]}-proof epoch sweep and {out['entries'][3]}-proof entries sweep); "
        f"dryrun_multichip({PAR_RANKS}) ok; {ranks_s:.1f} s incl. spawning and each rank's "
        f"witnesses ({built} s); launches by rank {[r['launches'] for r in ranks]}, the dry "
        f"run's apart {[r['dryrun_launches'] for r in ranks]}")
    runs = [(f"world 1, {backend}", one)]
    runs += [(f"rank {r['rank']} of {PAR_RANKS}, gloo", r) for r in ranks]
    for label, run in runs:
        sec = run["seconds"]
        log(f"[17 time] {label}: " + "; ".join(f"{k} {v:.4f} s" for k, v in sec.items())
            + f"; epoch sweep {out['epochs'][3] / sec['sweep_resident_epochs']:,.0f} proofs/s, "
            f"entries {out['entries'][3] / sec['sweep_entries']:,.0f} proofs/s (counts_only) "
            f"on {card}")
    log("[17 time] one card: the ranks share it, so no multi-card scaling figure is measured")
    launches = dict(one["launches"])
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"launches": launches}


def getproof_fixture():
    """An eth_getProof-schema fixture from an oracle-built world state, with
    a real header layout whose hash anchors it like a mainnet block (the
    recipe of tests/test_mainnet_getproof.py `_synthetic_getproof_fixture`,
    here with the native hasher, which gives the oracle's bytes)."""
    nk = default_hasher()
    addr = bytes.fromhex("dac17f958d2ee523a2206206994597c13d831ec7")
    st = EthTrie(hasher=nk)
    slot0 = bytes(32)
    supply = 39_035_000_000_000
    st.insert(nk(slot0), rlp.encode_int(supply))
    for i in range(1, 200):
        st.insert(nk(i.to_bytes(32, "big")), rlp.encode_int(7 * i))
    sroot = st.root_hash()
    code_hash = nk(b"usdt-code")
    world = EthTrie(hasher=nk)
    world.insert(nk(addr), rlp.encode([rlp.int_to_min_bytes(1), rlp.int_to_min_bytes(0),
                                       sroot, code_hash]))
    for i in range(500):
        world.insert(nk(b"filler-%d" % i), rlp.encode([
            rlp.int_to_min_bytes(i + 1), rlp.int_to_min_bytes(10**18),
            nk(b"sr%d" % i), nk(b"ch%d" % i)]))
    empty = "0x56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421"
    header = {
        "parentHash": "0x" + "ab" * 32,
        "sha3Uncles": "0x1dcc4de8dec75d7aab85b567b6ccd41ad312451b948a7413f0a142fd40d49347",
        "miner": "0x" + "42" * 20, "stateRoot": "0x" + world.root_hash().hex(),
        "transactionsRoot": empty, "receiptsRoot": empty, "logsBloom": "0x" + "00" * 256,
        "difficulty": "0x20000", "number": "0x112a880", "gasLimit": "0x1c9c380",
        "gasUsed": "0x0", "timestamp": "0x66aabbcc", "extraData": "0x",
        "mixHash": "0x" + "00" * 32, "nonce": "0x0000000000000000",
    }
    header["hash"] = "0x" + block_hash(header).hex()
    return {
        "address": "0x" + addr.hex(), "storageKeys": ["0x" + slot0.hex()], "block": header,
        "proof": {
            "address": "0x" + addr.hex(), "balance": "0x0",
            "codeHash": "0x" + code_hash.hex(), "nonce": "0x1",
            "storageHash": "0x" + sroot.hex(),
            "accountProof": ["0x" + x.hex() for x in world.get_proof(nk(addr))],
            "storageProof": [{"key": "0x" + slot0.hex(), "value": hex(supply),
                              "proof": ["0x" + x.hex() for x in st.get_proof(nk(slot0))]}],
        },
    }


def run_cli(argv):
    """(exit code, stdout) of the port's CLI run in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    return rc, buf.getvalue()


def phase_cli(repo, card):
    """Phase 18: the port's CLI on the card, its default device, against
    the same commands with --device cpu; the module entry in a subprocess."""
    with tempfile.TemporaryDirectory() as tmp:
        block = load_fixture(os.path.join(repo, "fixtures", "mainnet_block_46147.json"))
        block_path = os.path.join(tmp, "block_46147.json")
        save_fixture(block_path, {"block": block})
        gp = getproof_fixture()
        proof_path = os.path.join(tmp, "proof.json")
        save_fixture(proof_path, gp)
        gp["block"]["gasUsed"] = "0x1"  # the header no longer hashes to its pinned hash
        tampered_path = os.path.join(tmp, "tampered.json")
        save_fixture(tampered_path, gp)
        commands = [(["selftest"], 0), (["verify-tx", "--fixture", block_path], 0),
                    (["diagnose", "--fixture", block_path], 0),
                    (["verify-receipts", "--erc20", "--fixture",
                      os.path.join(repo, "fixtures", "synthetic_block_64.json")], 0),
                    (["verify-storage", "--fixture", proof_path], 0),
                    (["verify-storage", "--fixture", tampered_path], 1)]
        zero_counts()
        t0 = time.time()
        on_card = [run_cli(argv) for argv, _ in commands]  # the default device: the card
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        card_s = time.time() - t0
        launches = read_counts()
        t0 = time.time()
        on_cpu = [run_cli(argv + ["--device", "cpu"]) for argv, _ in commands]
        cpu_s = time.time() - t0
        # the Chrome-trace export (utils.profiling.cuda_trace) around one
        # command on the card, after the counts were read
        with cuda_trace(os.path.join(tmp, "trace")):
            traced = run_cli(commands[1][0])
        with open(os.path.join(tmp, "trace", "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    for (argv, want_rc), got, cpu in zip(commands, on_card, on_cpu):
        check(got == cpu, f"CLI {argv[0]}: the card gave {got}, --device cpu {cpu}")
        check(got[0] == want_rc, f"CLI {argv[0]}: exit code {got[0]}, {want_rc} expected")
    outs = [json.loads(out) for _, out in on_card]
    check(outs[0]["ok"] and outs[1]["counts"]["found"] == 1 and outs[2]["failures"] == []
          and outs[3]["counts"]["found"] == 64 and outs[3]["erc20_transfers"]
          and outs[4]["account_found"] and outs[4]["slots"][0]["value"] != "0x"
          and outs[5]["error"] == "header-anchor mismatch",
          f"unexpected CLI output: {outs}")
    for name in ("keccak256", "hinted", "bounded", "exact"):
        check(launches[name] > 0, f"the CLI launched the {name} kernel no time")
    check(traced == on_card[1] and events, f"cuda_trace: {traced}, {len(events)} events")
    kernel_events = sum(e.get("cat") == "kernel" for e in events)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x]))
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "zk_state_proofs_tpu_torch", "selftest"],
                          cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    module_s = time.time() - t0
    check(proc.returncode == 0 and proc.stdout == on_card[0][1],
          f"python -m zk_state_proofs_tpu_torch selftest: exit {proc.returncode}, "
          f"{proc.stdout!r} {proc.stderr[-2000:]}")
    log(f"[18 cli] {', '.join(argv[0] for argv, _ in commands)} (the last on a tampered "
        f"header, exit 1) on the card, the CLI's default device: JSON and exit codes equal "
        f"--device cpu's; {card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU; `python -m "
        f"zk_state_proofs_tpu_torch selftest` in a subprocess printed the same JSON "
        f"({module_s:.1f} s incl. start-up); launches {launches} on {card}; cuda_trace "
        f"around verify-tx wrote a Chrome trace of {len(events)} events, {kernel_events} "
        f"of them the card's kernels")
    return {"launches": launches}


def tampered_pools(packed):
    """Three tampered copies of a pooled witness's pool, (what, pool_nodes,
    pool_idx): a byte flipped in a real pool row (row 0 is the zero row),
    two proofs' leaf rows of pool_idx swapped, a pool_idx past the pool."""
    pool_nodes, _, pool_idx = packed.pool()
    flipped = pool_nodes.copy()
    flipped[1, 0] ^= 0xFF
    leaf = packed.num_nodes.astype(np.int64) - 1
    leaf_rows = pool_idx[np.arange(packed.batch), leaf]
    j = int(np.nonzero(leaf_rows != leaf_rows[0])[0][0])
    swapped = pool_idx.copy()
    swapped[0, leaf[0]], swapped[j, leaf[j]] = leaf_rows[j], leaf_rows[0]
    beyond = pool_idx.copy()
    beyond[packed.batch // 2, 0] = pool_nodes.shape[0]
    return [("a flipped pool byte", flipped, pool_idx),
            ("two leaf rows swapped", pool_nodes, swapped),
            ("a pool_idx out of range", pool_nodes, beyond)]


def cache_round_trip(packed, tmp):
    """packed (its pool built) saved and loaded (the pool validated on
    load), and each tampered cache refused on load. Returns (the loaded
    witness, save s, load s, the refusals' messages)."""
    path = os.path.join(tmp, "witness.npz")
    t0 = time.time()
    packed.save(path)
    save_s = time.time() - t0
    t0 = time.time()
    cached = PackedProofs.load(path)
    load_s = time.time() - t0
    for f in ("nodes", "node_lens", "num_nodes", "roots", "key_nibbles", "key_lens",
              "pool_nodes", "pool_lens", "pool_idx"):
        check(np.array_equal(getattr(cached, f), getattr(packed, f)),
              f"the cache's {f} differs from the packed witness's")
    refused = []
    for what, pool_nodes, pool_idx in tampered_pools(packed):
        bad = os.path.join(tmp, "tampered.npz")
        PackedProofs(*packed.astuple(), pool_nodes=pool_nodes, pool_lens=packed.pool_lens,
                     pool_idx=pool_idx).save(bad)
        try:
            PackedProofs.load(bad)
        except PackingError as exc:
            refused.append(f"{what}: {exc}")
        else:
            fail(f"a cache with {what} loaded")
    return cached, save_s, load_s, refused


def phase_mixed(card, dev):
    """Phase 19: BASELINE config 4 (bench_configs.py config4_mixed_batch):
    4096 account, storage and transaction proofs, packed, saved and loaded
    through the disk cache (the pool validated; three tampered caches
    refused), then verify_proofs_pooled with no pack-time hints and no
    segment schedules (K1 over the pool, the device hint pass, K2
    `hinted`, the guarded `exact`) on the card: every proof FOUND, equal
    bit for bit to the plain route on the card and to the same batch
    packed fresh; timed over distinct iterations."""
    t0 = time.time()
    _, fresh = mixed_batch(MIXED_PROOFS)
    fresh.pool()
    witness_s = time.time() - t0
    with tempfile.TemporaryDirectory() as tmp:
        cached, save_s, load_s, refused = cache_round_trip(fresh, tmp)
    b, d, n = cached.nodes.shape
    log(f"[19 witness] config 4 mixed batch: {b} proofs (accounts, storage slots, "
        f"transactions) built in {witness_s:.2f} s; nodes {(b, d, n)} "
        f"({cached.nodes.nbytes / 1e6:.1f} MB), pool {cached.pool_nodes.shape}; saved in "
        f"{save_s:.3f} s, loaded and validated in {load_s:.3f} s; refused on load: "
        f"{'; '.join(refused)}")

    t = packed_to_tensors(cached, dev, hints=False)
    batch, pool = [t[k] for k in BATCH_FIELDS], [t[k] for k in POOL_FIELDS]
    steps = d + 6
    # the main path of this phase, counted from zero: one call
    zero_counts()
    got = mpt.verify_proofs_pooled(*batch, *pool, max_value_len=128)
    launches = read_counts()
    for name in ("keccak256", "hinted", "exact"):
        check(launches[name] > 0, f"the mixed batch launched the {name} kernel no time")
    check(launches["item_offsets"] == 1, f"the mixed batch launched the hint pass kernel "
                                         f"{launches['item_offsets']} times, not once")
    status = got[0].cpu().numpy()
    check(bool((status == mpt.FOUND).all()),
          f"mixed batch: {int((status == mpt.FOUND).sum())} of {b} proofs FOUND")
    # the reference takes the host's hints (native scan), so that the
    # device hint pass, which the port's call ran, is held against them
    host_hints = torch.from_numpy(cached.pool_hints()).to(dev)
    k4_hints, k4_err = hint_pass_check(pool[0], "config 4's mixed pool", host_hints)
    # no node of this batch is inline (< 32 B): no first walk latches
    check(launches["exact_walked"] == 0,
          f"{launches['exact_walked']} guarded exact launches walked on the mixed batch")
    want = plain_pooled(batch, pool, host_hints, max_value_len=128)
    ft = packed_to_tensors(fresh, dev, hints=False)
    again = mpt.verify_proofs_pooled(*[ft[k] for k in BATCH_FIELDS + POOL_FIELDS],
                                     max_value_len=128)
    err = {"plain route": max_err(got, want), "fresh pack": max_err(got, again)}
    check(max(err.values()) == 0, f"the mixed batch differs: max abs err {err}")
    dig, hints = mpt.hash_nodes_pooled(*pool, with_hints=True)
    layout = mpt_cuda.walk_layout("hinted", *batch[:3], dig, *batch[3:], 128, steps,
                                  hints=hints)
    del ft, again, want, dig, hints, host_hints

    # distinct work per iteration: byte N - 1 of every node and pool row (a
    # padding byte: node_len is the largest node + 4) takes the counter;
    # every value byte and length folded into checked accumulators
    step = Step(pooled_call(t, max_value_len=128), b, dev)
    runs = step.timed(wall_ms, TIMED_ITERS, 2, value_word(*got[1:]),
                      "the perturbed padding: the mixed batch")
    ms = min(runs)
    # device time from torch.profiler: before K4 a call's ~800 launches
    # overflowed the launch queue behind a spin kernel (queued_timer)
    prof = device_profile(step, 5)
    before_after("19", f"config 4's call {(b, d, n)}", step, card, ("item_offsets",),
                 MIXED_LAUNCH_LIMIT)
    k4 = stage_times(lambda: item_offsets(pool[0]), lambda: item_offsets_plain(pool[0]))
    k4.update(err=k4_err, bound=hint_pass_bound(pool[0], k4_hints))
    log(f"[19 time] K4 on config 4's pool {tuple(pool[0].shape)}: wrapper {k4['ms']:.4f} ms, "
        f"plain {k4['plain_ms']:.4f} ms (CUDA events over {TIMED_ITERS} calls), device "
        f"{us_text(k4['device_us'])} ({DEVICE_TIMING}), bound {k4['bound'][0]:.6f} ms "
        f"({k4['bound'][1]}) on {card}")
    top = "; ".join(f"{nm[:40]} {t * 1e3:.1f} us x{c:.0f}" for nm, t, c in prof["top"])
    kn = batch[4].shape[1]
    bound = {"k1": keccak_bound(pool[1], ((pool[0].shape[0], n),)),
             "hinted": walk_bound(*batch[:3], kn, 128, True)}
    per_call = {k: v for k, v in launches.items() if v and k != "exact_walked"}
    log(f"[19 time] config 4 mixed batch {(b, d, n)}, cache-loaded, no pack-time hints, no "
        f"segments: {ms:.4f} ms/batch = {b / ms * 1e3:,.0f} proofs/s ({TIMED_ITERS} distinct "
        f"iterations a run, CUDA events, runs {[round(r, 4) for r in runs]}; values and "
        f"lengths in a checked accumulator); torch.profiler over 5 calls: host "
        f"{prof['wall_ms']:.4f} ms a call, device busy "
        f"{prof['busy_ms']:.4f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%), "
        f"{prof['launches']:.0f} device launches a call, top {top}; wrapper launches a call "
        f"{per_call}, guarded exact launches that walked {launches['exact_walked']}; K2 "
        f"layout {layout}; bound K1 "
        f"{bound['k1'][0]:.6f} ms ({bound['k1'][1]}), K2 hinted {bound['hinted'][0]:.6f} ms "
        f"({bound['hinted'][1]}) on {card}")
    log(f"[19 check] all {b} proofs FOUND; the device hint pass (K4) == its plain version "
        f"and the host's hints on the {pool[0].shape[0]}-row pool; status, values and "
        f"lengths == the plain route (host hints) on the card and == the fresh pack (max abs "
        f"err {err})")
    return {"launches": launches, "err": max(err.values()), "bound": bound, "k4": k4}


def phase_distinct(card, dev):
    """Phase 20: BASELINE config 6 (bench_configs.py config6_distinct_1m),
    not cut: 2^20 distinct accounts, their proofs packed longest first at
    node_len 576, one resident epoch (sweep_resident_epochs, 256 windows of
    4096) after a warm-up with another salt; then, outside the timed call,
    every proof FOUND with its leaf as its value (epoch_batch over tables
    built again, one host read a window), K1 over the whole pool and
    epoch_batch on the first window, the first window past byte 2^31 of the
    node table and the last window against their plain versions; peak
    device memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    w = distinct_world(DISTINCT_ACCOUNTS)
    witness_s = time.time() - t0
    t0 = time.time()
    gp = w.pack()
    order = w.depth_order()  # row r holds account order[r]
    pool_nodes, pool_lens, _ = gp.pool()
    pack_s = time.time() - t0
    a, d, n = gp.nodes.shape
    longest = int(gp.node_lens.max())
    check(longest < n, f"a node is {longest} B long, not under N = {n}: the epoch counter "
                       f"would land on a node byte")
    table_bytes = a * d * n
    check(table_bytes > INT32_BYTES, f"the node table has {table_bytes} bytes, not past 2^31")
    depth = {int(k): int(c) for k, c in enumerate(np.bincount(gp.num_nodes)) if c}
    host_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    log(f"[20 witness] config 6: {a} distinct accounts built in {witness_s:.1f} s, packed "
        f"(longest proof first) with its pool in {pack_s:.1f} s; nodes {(a, d, n)} "
        f"({table_bytes / 1e9:.3f} GB), pool {pool_nodes.shape} ({pool_nodes.nbytes / 1e9:.3f} "
        f"GB), max_depth {w.max_nodes}, longest node {longest} of {n} B, proofs by depth "
        f"{depth}; host peak RSS {host_gb:.1f} GB")

    steps = w.max_nodes
    kw = dict(max_steps=steps, device=dev, forbid_sync=True)
    # the main path of this phase, counted from zero: the warm-up and the
    # measured call (each builds its own tables and frees them on return)
    zero_counts()
    warm = sweep_resident_epochs(gp, 1, DISTINCT_BATCH, salt=0x15A, **kw)
    res = sweep_resident_epochs(gp, 1, DISTINCT_BATCH, salt=7, **kw)
    launches = read_counts()
    peak_sweep = torch.cuda.max_memory_allocated(dev)
    for name, r in (("warm-up", warm), ("measured", res)):
        check(r.total == a and r.found == a,
              f"config 6 {name}: {r.found} of {r.total} proofs FOUND, {a} expected")
    for name in ("keccak256", "item_offsets", "hinted", "exact"):
        check(launches[name] > 0, f"config 6 launched the {name} kernel no time")
    log(f"[20 sweep] config 6 {form_line('one resident epoch', res)} (warm-up "
        f"{warm.proofs_per_sec:,.0f} proofs/s, pack {warm.pack_seconds:.4f} s); pack_seconds "
        f"is the upload, K1 over the pool, the hint pass and the table expansion; peak device "
        f"memory {peak_sweep / 1e9:.3f} GB (torch.cuda.max_memory_allocated over the warm-up "
        f"and the measured call); wrapper launches {launches}; on {card}")

    # the check, outside the timed call: tables built once more
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    tables = epoch_tables(gp, dev)
    torch.cuda.synchronize()
    tables_s = time.time() - t0
    leaves = [w.leaves[i] for i in order]
    check(max(map(len, leaves)) <= 128, "a leaf is longer than the value window")
    want_lens = np.fromiter(map(len, leaves), np.int32, count=a)
    want_values = np.frombuffer(b"".join(x.ljust(128, b"\0") for x in leaves),
                                np.uint8).reshape(a, 128)
    del leaves
    starts = [int(x) for x in epoch_windows(a, DISTINCT_BATCH)]
    for s0 in starts:
        st, v, ln = epoch_batch(tables, s0, DISTINCT_BATCH, 0x3C, 128, steps, dev)
        host = torch.cat([v, torch.stack([st, ln], 1).view(torch.uint8)], 1).cpu().numpy()
        rows = slice(s0, s0 + DISTINCT_BATCH)
        words = host[:, 128:].copy().view(np.int32)
        check(bool((words[:, 0] == mpt.FOUND).all()), f"config 6 window at row {s0}: "
              f"{int((words[:, 0] == mpt.FOUND).sum())} of {DISTINCT_BATCH} proofs FOUND")
        check(np.array_equal(words[:, 1], want_lens[rows])
              and np.array_equal(host[:, :128], want_values[rows]),
              f"config 6 window at row {s0}: a value differs from its leaf")
    del want_values, want_lens
    # K1 over the whole pool (one launch) against the plain keccak
    pn = torch.from_numpy(pool_nodes).to(dev)
    pl = torch.from_numpy(pool_lens.astype(np.int32)).to(dev)
    dig = mpt.hash_pool(pn, pl)
    k1 = 0
    for c in range(0, pn.shape[0], PLAIN_CHUNK):
        k1 = max(k1, max_err([dig[c:c + PLAIN_CHUNK]],
                             [tkeccak.keccak256(pn[c:c + PLAIN_CHUNK], pl[c:c + PLAIN_CHUNK])]))
    check(k1 == 0, f"K1 differs from plain keccak on the config 6 pool (max abs err {k1})")
    k1_ms = cuda_timer(lambda i: mpt.hash_pool(pn, pl), 5)
    bound = {"k1": keccak_bound(pl, ((pn.shape[0], n),))}
    # K4 over the whole pool (one launch) against its plain version
    k4_hints, k4_err = hint_pass_check(pn, "config 6's pool")
    k4 = {"err": k4_err, "bound": hint_pass_bound(pn, k4_hints),
          "ms": cuda_timer(lambda i: item_offsets(pn), 5),
          "plain_ms": cuda_timer(lambda i: item_offsets_plain(pn), 5)}
    log(f"[20 K4] the device hint pass kernel == plain over config 6's pool {tuple(pn.shape)} "
        f"(max abs err {k4_err}); wrapper {k4['ms']:.4f} ms, plain {k4['plain_ms']:.4f} ms "
        f"(CUDA events over 5), bound {k4['bound'][0]:.6f} ms ({k4['bound'][1]}) on {card}")
    del pn, pl, dig, k4_hints
    # epoch_batch against the plain route on three windows, each a view of
    # the node table at its own byte offset
    row_bytes = d * n
    past = next(s for s in starts if s * row_bytes > INT32_BYTES)
    errs = {}
    for name, s0 in (("first", starts[0]), ("first past 2^31", past), ("last", starts[-1])):
        got = epoch_batch(tables, s0, DISTINCT_BATCH, 0xA5, 128, steps, dev)
        win = slice(s0, s0 + DISTINCT_BATCH)
        batch = [tables[k][win] for k in ("nodes", "lens", "num", "roots", "knib", "klen")]
        check(batch[0].data_ptr() - tables["nodes"].data_ptr() == s0 * row_bytes,
              f"the {name} window is not a view at byte {s0 * row_bytes}")
        dh = tables["dh"][win]
        errs[f"{name} (byte {s0 * row_bytes})"] = max_err(
            got, plain_walk(batch, dh[..., :32], dh[..., 32:], 128, steps))
    check(max(errs.values()) == 0, f"epoch_batch differs from the plain walk: {errs}")
    kn = tables["knib"].shape[1]
    first = slice(0, DISTINCT_BATCH)
    bound["hinted"] = walk_bound(tables["nodes"][first], tables["lens"][first],
                                 tables["num"][first], kn, 128, True)
    epoch_bound = walk_bound(tables["nodes"], tables["lens"], tables["num"], kn, 128, True)
    # K2 `hinted` alone (one walk_lanes launch, as phase 13 times K2) on the
    # first window, the shape of its bound
    fb = [tables[k][first] for k in ("nodes", "lens", "num", "roots", "knib", "klen")]
    fdh = tables["dh"][first]
    k2_args = (*lane_args(fb, fdh[..., :32]), 128, steps)
    k2_us = lower(*(device_us(lambda i: mpt_cuda.walk_lanes("hinted", *k2_args,
                                                            hints=fdh[..., 32:]))
                    for _ in range(2)))

    def one(i):
        return epoch_batch(tables, starts[i % len(starts)], DISTINCT_BATCH, i & 0xFF, 128,
                           steps, dev)

    dev_us = lower(device_us(one), device_us(one))
    del tables, fb, fdh, k2_args
    peak_check = torch.cuda.max_memory_allocated(dev)
    wall_ms = 1e3 * res.seconds / res.batches
    busy = "not measured" if dev_us is None else f"{100 * dev_us / 1e3 / wall_ms:.1f}%"
    log(f"[20 time] config 6 window of {DISTINCT_BATCH} proofs {(DISTINCT_BATCH, d, n)}: host "
        f"{wall_ms:.4f} ms a window in the sweep, device {us_text(dev_us)} a window "
        f"({DEVICE_TIMING}): device busy {busy}; tables built again in {tables_s:.2f} s; "
        f"K1 over the pool {k1_ms:.4f} ms (one launch, CUDA events over 5), bound "
        f"{bound['k1'][0]:.6f} ms ({bound['k1'][1]}); K2 hinted alone on the first window "
        f"{us_text(k2_us)} (one launch, {DEVICE_TIMING}, the lower of two windows), bound "
        f"{bound['hinted'][0]:.6f} ms ({bound['hinted'][1]}), on the whole epoch "
        f"{epoch_bound[0]:.6f} ms ({epoch_bound[1]}); peak device memory of the check "
        f"{peak_check / 1e9:.3f} GB on {card}")
    log(f"[20 check] all {a} proofs FOUND with their leaves as values ({len(starts)} windows, "
        f"one host read each); K1 == plain keccak over the {pool_nodes.shape[0]}-row pool "
        f"(max abs err {k1}); epoch_batch == the plain walk on {list(errs)} (max abs err "
        f"{max(errs.values())})")
    return {"launches": launches, "err": {"k1": k1, "k2": max(errs.values())},
            "bound": bound, "peak_bytes": peak_sweep, "k4": k4,
            "ms": {"k1": k1_ms, "hinted": None if k2_us is None else k2_us / 1e3}}


def run_bench(repo, module, args):
    """`python -m zk_state_proofs_tpu_torch.bench.<module> *args` from the
    checkout: exit 0 and JSON lines on stdout, each with ok true, or fail."""
    out = subprocess.run([sys.executable, "-m", f"zk_state_proofs_tpu_torch.bench.{module}",
                          *args], cwd=repo, capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT_S)
    check(out.returncode == 0, f"bench.{module} exited {out.returncode}: "
                               f"{out.stderr.strip()[-3000:]}")
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    check(lines and all(x.get("ok") is True for x in lines),
          f"bench.{module}: a line without ok true: {out.stdout.strip()[-3000:]}")
    return lines


def phase_bench(repo):
    """Phase 21: the benchmark programs (zk_state_proofs_tpu_torch/bench/),
    each in its own process as a user runs it: the headline at full width
    (4096 distinct, 512 hot, the 256-epoch resident sweep, K1's rates),
    configs 1-6 at --quick size, one short A/B pair of each harness. Each
    line ok, every proof FOUND, the accumulators checked (each program
    raises otherwise); the lines printed; their kernel launches summed."""
    lines = {m: run_bench(repo, m, args) for m, args in BENCH_RUNS}
    (head,) = lines["headline"]
    check("vs_baseline" not in head and head["value"] > 0 and head["device_proofs_per_sec"] > 0
          and head["found"] == head["batch"] and head["hot_trie_found"] == head["hot_trie_batch"]
          and head["resident_sweep_found"] == head["resident_sweep_proofs"]
          and head["folded_calls"] > 0 and len(head["keccak_hashes_per_sec"]) == 4
          and head["window_proofs_per_sec"] > 0 and head["bare_ms_per_batch"] > 0
          and head["bare_device_ms_per_batch"] > 0
          and head["keccak_real_mix_hashes_per_sec"] > 0,
          f"bench.headline: an unexpected line {head}")
    cfg = {x["config"]: x for x in lines["configs"]}
    check(tuple(cfg) == CONFIG_NAMES, f"bench.configs printed {list(cfg)}")
    for name, got, want in (
            ("single_tx_proof", "tx_geometry_found", "tx_geometry_batch"),
            ("account_storage_proof", "grouped_found", "grouped_slot_proofs"),
            ("mixed_batch_4096", "found", "batch"),
            ("sweep_with_root_reduction", "found", "proofs"),
            ("distinct_1m_resident", "found", "proofs")):
        check(cfg[name][got] == cfg[name][want],
              f"bench.configs {name}: {got} {cfg[name][got]} of {cfg[name][want]}")
    check(cfg["sweep_with_root_reduction"]["root_ok"], "bench.configs: the receipt root differs")
    check([x["ab"] for x in lines["ab"]] == ["walk", "keccak"]
          and list(lines["ab"][0]["best_ms"]) == ["hinted", "hinted1"]
          and list(lines["ab"][1]["best_ms"]) == ["base", "seg"],
          f"bench.ab: unexpected lines {lines['ab']}")
    launches = {}
    for module, got in lines.items():
        for x in got:
            log(f"[21 {module}] {json.dumps(x)}")
            for k, v in x["launches"].items():
                launches[k] = launches.get(k, 0) + v
    for name in ("keccak256", "item_offsets", "decode_account", "hinted", "exact"):
        check(launches[name] > 0, f"the bench programs launched the {name} kernel no time")
    log(f"[21 bench] headline, configs --quick (6 lines) and ab: every line ok, every proof "
        f"FOUND, the accumulators checked; launches {launches}")
    return {"launches": launches}


def time_paths(calls, rows, once, what, dev, iters=None):
    """CUDA events around back-to-back steps (bench.common.Step: the counter
    into the padding, each call's status and value word folded) of each
    path's call(ctr), in turns plain, kernel, kernel, plain; after each run
    every proof FOUND in every call and the values those of `once`, or
    raise. calls: {"kernel": call, "plain": call}; iters by path (default
    TIMED_ITERS). Returns each run's ms by label."""
    steps = {path: Step(call, rows, dev) for path, call in calls.items()}
    times = {}
    for label in ("plain", "kernel", "kernel2", "plain2"):
        path = label.rstrip("2")
        (times[label],) = steps[path].timed(wall_ms, (iters or {}).get(path, TIMED_ITERS), 1,
                                            once, f"the perturbed padding: {what} ({label} path)")
    return times


def kernel_row(name, source, replaces, by_path, counter, err, ms, plain_ms, bound):
    bound_ms, bound_by = bound
    paths = {path: counts.get(counter, 0) for path, counts in by_path.items()}
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}  # no PyTorch call computes keccak, an MPT walk or RLP


def hint_pass_check(rows, what, host_hints=None):
    """K4 (ops.rlp.item_offsets on the card: one launch) against its plain
    version on the card, in chunks of PLAIN_CHUNK rows, and against the
    host's hints where given. Returns (the kernel's hints, max abs err)."""
    before = decode_cuda.LAUNCHES["item_offsets"]
    got = item_offsets(rows)
    check(decode_cuda.LAUNCHES["item_offsets"] == before + 1, f"K4 on {what}: not one launch")
    err = 0
    for c in range(0, rows.shape[0], PLAIN_CHUNK):
        err = max(err, max_err([got[c:c + PLAIN_CHUNK]],
                               [item_offsets_plain(rows[c:c + PLAIN_CHUNK])]))
    check(err == 0, f"K4 differs from its plain version on {what} (max abs err {err})")
    if host_hints is not None:
        check(torch.equal(got, host_hints), f"K4 differs from the host's hints on {what}")
    return got, err


def account_check(values, vlens, what):
    """K5 (ops.account.decode_account on the card: one launch) against its
    plain version on the card, every field. Returns the max abs err."""
    before = decode_cuda.LAUNCHES["decode_account"]
    got = decode_account(values, vlens)
    check(decode_cuda.LAUNCHES["decode_account"] == before + 1, f"K5 on {what}: not one launch")
    want = decode_account_plain(values, vlens)
    err = max_err([got[k] for k in want], list(want.values()))
    check(err == 0, f"K5 differs from its plain version on {what} (max abs err {err})")
    return err


def stage_times(call, plain):
    """A decode stage's times on the card: the wrapper's ms and the plain
    version's (CUDA events over TIMED_ITERS calls), the kernel's device µs
    (queued behind a spin; the lower of two windows)."""
    return {"ms": cuda_timer(lambda i: call(), TIMED_ITERS),
            "plain_ms": cuda_timer(lambda i: plain(), TIMED_ITERS),
            "device_us": lower(device_us(lambda i: call()), device_us(lambda i: call()))}


@contextlib.contextmanager
def plain_decode_stages():
    """The route before kernels K4 and K5, for a before/after in one run:
    ops.rlp.item_offsets and ops.account.decode_account run their plain
    versions on the card, op by op."""
    saved = decode_cuda.item_offsets_cuda, decode_cuda.decode_account_cuda
    decode_cuda.item_offsets_cuda = item_offsets_plain
    decode_cuda.decode_account_cuda = decode_account_plain
    try:
        yield
    finally:
        decode_cuda.item_offsets_cuda, decode_cuda.decode_account_cuda = saved


def before_after(tag, what, fn, card, kernels, limit=None):
    """torch.profiler over 10 calls of fn(i), in turns before (the plain
    decode stages on the card), after (K4 and K5), after, before: device
    launches a call, host ms a call and the device's busy share, from each
    side's window with the lower host ms. Fails where a window's launch
    counts of K4 and K5 moved other than as expected (in a before window,
    neither; in an after window, the `kernels` of "item_offsets" and
    "decode_account"), or where the after side makes more than `limit`
    launches a call."""
    runs = {"before": [], "after": []}
    for side in ("before", "after", "after", "before"):
        start = dict(decode_cuda.LAUNCHES)
        with plain_decode_stages() if side == "before" else contextlib.nullcontext():
            runs[side].append(device_profile(fn, 10))
        moved = sorted(k for k, v in decode_cuda.LAUNCHES.items() if v != start[k])
        want = sorted(kernels) if side == "after" else []
        check(moved == want, f"{what}, a {side} window: the decode kernels launched were "
                             f"{moved}, not {want}")
    out = {}
    for side, profs in runs.items():
        p = min(profs, key=lambda x: x["wall_ms"])
        out[side] = {"launches": p["launches"], "host_ms": p["wall_ms"], "busy_ms": p["busy_ms"],
                     "busy_pct": 100 * p["busy_ms"] / p["wall_ms"]}
    log(f"[{tag} decode] {what}, torch.profiler over 10 calls, the lower host ms of two "
        f"windows: " + "; ".join(
            f"{side} {x['launches']:.0f} device launches a call, host {x['host_ms']:.4f} ms, "
            f"device busy {x['busy_ms']:.4f} ms ({x['busy_pct']:.1f}%)"
            for side, x in out.items()) + f" (before: the plain decode stages on the card; "
        f"after: K4 and K5) on {card}")
    if limit is not None:
        check(out["after"]["launches"] <= limit, f"{what}: {out['after']['launches']:.0f} "
                                                 f"device launches a call, above {limit}")
    return out


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
    walked = mpt_cuda.exact_walked(dev)
    got = mpt_cuda.walk_batch_cuda(*args, 64, with_reasons=True)
    check(mpt_cuda.exact_walked(dev) == walked + 1, "over-bound nodes did not re-run in exact")
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
    """Phase 8: K3 (the warp sponge) against its plain version, K1 and the
    oracle; K3 against K1 and the plain version in time on the headline
    pool, and the device time of K3 and K1 in turns."""
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
    fns = {"K3": keccak_cuda.keccak256_cuda_raw, "K1": keccak_cuda.keccak256_cuda}
    dev_us = {}
    for name in [*fns, *reversed(fns)]:  # in turns, the lower of two windows each
        dev_us[name] = lower(dev_us.get(name), device_us(lambda i: fns[name](pn, pl)))
    log(f"[8 K3] keccak256_raw warp kernel == plain == K1 on edge "
        f"lengths {edge} at widths 576 and 573 and the {pn.shape[0]}-row headline pool; "
        f"oracle sample ok; max abs err {err}")
    log(f"[8 time] headline pool, {pn.shape[0]} rows x {pn.shape[1]} B, one launch: "
        f"K3 {ms:.4f} ms, K1 {k1_ms:.4f} ms, K3 plain {plain_ms:.4f} ms "
        f"(runs {t}); device time per launch ({DEVICE_TIMING}, in turns, the lower of "
        f"two windows): " + ", ".join(f"{k} {us_text(v)}" for k, v in dev_us.items())
        + f" on {card}")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "device_us": dev_us}


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
    for name in ("keccak256", "hinted", "bounded", "decode_account"):
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
    # K5 against its plain version: the storage path's account values (the
    # account level's output, i32 lengths and as i64), then fuzzed values
    a_out = mpt.verify_proofs_pooled(*core_args[0], *core_args[1], core_args[2],
                                     max_value_len=128)
    k5_err = max(account_check(*a_out[1:], f"the {n_acc} account values"),
                 account_check(a_out[1], a_out[2].long(), "the account values, i64 lengths"))
    fv, fl = (torch.from_numpy(x).to(dev)
              for x in account_fuzz_values(FUZZ_ROWS, ACCOUNT_WIDTH, seed=9))
    k5_err = max(k5_err, account_check(fv, fl, f"{FUZZ_ROWS} fuzzed account values"))
    log(f"[9 K5] the account decode kernel == plain (one launch a call, every field) on the "
        f"{n_acc} account values of the storage path (i32 and i64 lengths) and "
        f"{FUZZ_ROWS} fuzzed values of {ACCOUNT_WIDTH} B (oversize nonces and balances, "
        f"lengths past the row; {int(decode_account(fv, fl)['ok'].sum())} ok); "
        f"max abs err {k5_err}")

    # ---- 10. timings ----
    slots36 = torch.zeros((n_slots, 36), dtype=torch.uint8, device=dev)
    slots36[:, :32] = sw["slots"]
    args36 = core_args[:7] + (slots36, sw["sa"])
    bal = torch.from_numpy(res.balance.astype(np.int64).sum(1)).to(dev)
    once = value_word(torch.from_numpy(res.slot_values).to(dev),
                      torch.from_numpy(res.slot_value_lens).to(dev))
    acc_a = torch.zeros(n_acc, dtype=torch.int64, device=dev)

    def storage_call(kernels):
        def call(ctr):
            # distinct work per iteration: the last padding byte of every
            # node row and slot changes; results do not (bench_configs.py's
            # recipe)
            perturb(ctr, at["nodes"], at["pool_nodes"], st["nodes"], st["pool_nodes"], slots36)
            a_st, acct, s_st, s_v, s_vl = (verify_storage_pooled if kernels
                                           else plain_storage)(*args36)
            acc_a.add_(a_st).add_(acct["balance"].sum(1, dtype=torch.int64))
            return s_st, s_v, s_vl
        return Step(call, n_slots, dev)

    steps = {"kernel": storage_call(True), "plain": storage_call(False)}
    times = {}
    for label in ("plain", "kernel", "kernel2", "plain2"):
        acc_a.zero_()
        step = steps[label.rstrip("2")]
        (times[label],) = step.timed(wall_ms, TIMED_ITERS, 1, once,
                                     f"the perturbed padding: storage ({label} path)")
        check(bool((acc_a == step.fold.calls * (mpt.FOUND + bal)).all()),
              f"perturbed padding changed the storage account results ({label} path)")
    k_ms = min(times["kernel"], times["kernel2"])
    p_ms = min(times["plain"], times["plain2"])
    log(f"[10 time] grouped storage verify, {n_acc} accounts + {n_slots} slots: "
        f"kernel path {k_ms:.4f} ms/batch = {n_slots / k_ms * 1e3:,.0f} slots/s; "
        f"plain path {p_ms:.4f} ms/batch = {n_slots / p_ms * 1e3:,.0f} slots/s "
        f"(runs {times}) on {card}")

    # the whole core call and each of its stages alone, on the same inputs,
    # each under torch.profiler over 10 calls (launches include copies),
    # before (the plain decode stages) and after (K4, K5)
    acct = decode_account(*a_out[1:])
    s_knib, s_klen = _slot_key_nibbles(slots36)
    s_roots = torch.index_select(acct["storage_root"], 0, sw["sa"].to(torch.int64))
    stages = {
        "whole call": lambda i: verify_storage_pooled(*args36),
        "account level": lambda i: mpt.verify_proofs_pooled(
            *core_args[0], *core_args[1], core_args[2], max_value_len=128),
        "decode_account": lambda i: decode_account(*a_out[1:]),
        "slot keys": lambda i: _slot_key_nibbles(slots36),
        "slot level": lambda i: mpt.verify_proofs_pooled(
            *core_args[3:6], s_roots, s_knib, s_klen, *core_args[6], max_value_len=64,
            hinted=False)}
    for name, fn in stages.items():
        before_after("10", f"grouped storage, {name}", fn, card,
                     ("decode_account",) if name in ("whole call", "decode_account") else (),
                     STORAGE_LAUNCH_LIMIT if name == "whole call" else None)
    prof = device_profile(stages["whole call"], 10)
    top = "; ".join(f"{n[:60]} {ms * 1e3:.1f} us x{c:.0f}" for n, ms, c in prof["top"])
    log(f"[10 profile] grouped storage, whole call, kernel path, torch.profiler over 10 "
        f"calls: top by device time: {top} on {card}")
    # config 2's form: the account level hinted by the device hint pass
    nohint = args36[:2] + (None,) + args36[3:]
    before_after("10", "config 2's grouped storage call, no pack-time account hints",
                 lambda i: verify_storage_pooled(*nohint), card,
                 ("item_offsets", "decode_account"))
    k5 = stage_times(lambda: decode_account(*a_out[1:]), lambda: decode_account_plain(*a_out[1:]))
    k5.update(err=k5_err, bound=account_bound(a_out[1]))
    log(f"[10 time] K5 on the {n_acc} account values {tuple(a_out[1].shape)}: wrapper "
        f"{k5['ms']:.4f} ms, plain {k5['plain_ms']:.4f} ms (CUDA events over {TIMED_ITERS} "
        f"calls), device {us_text(k5['device_us'])} ({DEVICE_TIMING}), bound "
        f"{k5['bound'][0]:.6f} ms ({k5['bound'][1]}) on {card}")

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
            "bounded_bound": walk_bound(*sargs[:3], sargs[5].shape[1], 64, False), "k5": k5}


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
    walked = mpt_cuda.exact_walked(dev)
    got = mpt_cuda.walk_batch_cuda(*cargs, 128, d + 6, hints=chints, with_reasons=True,
                                   hint_mode="ordered")
    check(mpt_cuda.exact_walked(dev) == walked + 1, "the unordered pack did not re-run in exact")
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
    check(launches["exact_walked"] == 0, "an honest batch re-ran in exact")
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
    walked = mpt_cuda.exact_walked(dev)
    fpacked, fmvl = block_pack(fallback)
    rfb = verify_merkle_batch(fpacked, max_value_len=fmvl, device=dev)
    torch.cuda.synchronize()
    host_s = time.time() - t0
    launches = read_counts()
    for name in ("keccak256", "hinted", "exact", "exact_walked"):
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
    check(launches["exact_walked"] == walked + 1 and rfb.status[-1] == mpt.INVALID
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
    kw = dict(max_value_len=mvl, max_steps=steps)

    def plain_call(ctr):
        perturb(ctr, nodes, pnodes)
        return plain_pooled(batch, pool, hints, **kw)

    times = time_paths({"kernel": pooled_call(txw["t"], **kw), "plain": plain_call}, n_proofs,
                       value_word(*tx_result[1:]), "phase 13", nodes.device,
                       iters={"plain": PLAIN_ITERS})
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
    native_against_k1(pn.cpu().numpy(), pl.cpu().numpy(),
                      mpt._hash_pool_rows(pn, pl).cpu().numpy(), "[13 native]",
                      "transaction-geometry pool")
    k1_ms = cuda_timer(lambda i: mpt._hash_pool_rows(pn, pl), TIMED_ITERS)
    k1_us = device_us(lambda i: mpt._hash_pool_rows(pn, pl))
    k1_bound = keccak_bound(pl, ((pn.shape[0], pn.shape[1]),))
    log(f"[13 time] K1 on the transaction-geometry pool {tuple(pn.shape)}, one launch: "
        f"{k1_ms:.4f} ms, device {us_text(k1_us)}, bound {k1_bound[0]:.5f} ms "
        f"({k1_bound[1]}) on {card}")
    tx_bound = walk_bound(*batch[:3], batch[4].shape[1], mvl, True)
    log(f"[13 bound] K2 hinted at transaction geometry: bound {tx_bound[0]:.5f} ms "
        f"({tx_bound[1]}); device {us_text(ab['transaction geometry']['hinted'])}")
    # K4 on the transaction pool; config 1's call: no pack-time hints
    _, k4_err = hint_pass_check(pn, "the transaction-geometry pool", hints)
    log(f"[13 K4] the device hint pass kernel == plain and == the host's hints on the "
        f"transaction-geometry pool {tuple(pn.shape)}; max abs err {k4_err}")
    before_after("13", f"config 1's pooled verify at transaction geometry, {n_proofs} proofs, "
                 f"no pack-time hints (with the host's hints: host {prof['wall_ms']:.4f} ms, "
                 f"{prof['launches']:.0f} device launches a call, above)",
                 lambda i: mpt.verify_proofs_pooled(*batch, *pool, max_value_len=mvl,
                                                    max_steps=steps), card, ("item_offsets",))
    return {"k4_err": k4_err}


def native_against_k1(pool_nodes, pool_lens, k1_digests, tag, what):
    """The C++ host hasher (`native.keccak256_batch`, one call of
    zkp_keccak256_batch) on every pool row at its length, against K1's
    digests of the same rows, byte for byte. Fails where the native library
    did not build: the Python fallback must not stand in for it."""
    lib = native.get_lib()
    check(lib is not None and hasattr(lib, "zkp_keccak256_batch"),
          f"{tag} the native host library (zkp_keccak256_batch) did not build")
    msgs = [pool_nodes[i, :n].tobytes() for i, n in enumerate(pool_lens.tolist())]
    t0 = time.perf_counter()
    got = native.keccak256_batch(msgs)
    host_s = time.perf_counter() - t0
    bad = sum(g != d.tobytes() for g, d in zip(got, k1_digests))
    check(len(got) == len(k1_digests) and bad == 0,
          f"{tag} native.keccak256_batch differs from K1 on {bad} of {len(msgs)} rows")
    log(f"{tag} native.keccak256_batch == K1 on the {what}: {len(msgs)} rows "
        f"{tuple(pool_nodes.shape)}, {sum(len(m) for m in msgs)} bytes, mismatches {bad}; "
        f"host call {host_s:.6f} s")


def phase_layout(head_segs, head_steps, slot_args, txw):
    """Phase 14: K2's shared-memory layout (`mpt_cuda.walk_layout`) on a
    headline segment, the slot batch and the transaction-geometry batch."""
    geo = txw["geo"]
    targs = lane_args(txw["batch"], txw["dig"])
    for label, a, kw, mvl, steps in (
            ("headline segment", head_segs[0][0], {"hints": head_segs[0][1]}, 128, head_steps),
            ("slot batch", slot_args, {}, 64, slot_args[0].shape[1] + 6),
            ("transaction geometry", targs, {"hints": txw["htab"]}, geo.max_value_len,
             geo.max_steps)):
        mode = "hinted" if kw else "bounded"
        lay = mpt_cuda.walk_layout(mode, *a, mvl, steps, **kw)
        log(f"[14 layout] K2 {mode}, {label} {tuple(a[0].shape)}: {lay['lanes']} lanes a "
            f"proof, shared memory {lay['proof_bytes']} B a proof, {lay['block_bytes']} B "
            f"a block of 4 warps, node rows staged: {lay['staging']}")


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


def plain_walk(batch, digests, hints, max_value_len, max_steps=None, with_reasons=False):
    """walk_batch_cuda from the plain walk, on any device: hinted with
    hints, bounded without; the exact re-run when any flag latches.
    batch: (nodes, node_lens, num_nodes, roots, key_nibbles, key_lens).
    with_reasons appends the INVALID reason."""
    steps = batch[0].shape[1] + 6 if max_steps is None else max_steps
    args = (*batch[:3], digests, *batch[3:], max_value_len, steps)
    out, values = mpt.walk_kernel_plain("bounded" if hints is None else "hinted",
                                        *args, hints=hints)
    if bool((out[:, 4] != 0).any()):
        out, values = mpt.walk_kernel_plain("exact", *args)
    status = out[:, 0]
    result = (status, values, torch.where(status == mpt.FOUND, out[:, 3], 0))
    return result + (out[:, 5],) if with_reasons else result


def fold_checks(args, cases):
    """K2's `exact` re-run as walk_batch_cuda decides it, on the card, for
    each (label, hints) case of one batch (`args`: walk_lanes' positional
    inputs, max_value_len and max_steps included; hints None walks
    `bounded`): every case's first walk with a fresh tag, all queued before
    any guarded launch; each folded flag against guard_plain of the words
    its walk wrote; then each case's guarded `exact` launch, the tally
    counting the cases that latched, every output (status, value, length,
    reason) equal to the plain route. Returns (max abs err, proofs latched
    per case)."""
    dev = args[0].device
    queued = []
    for label, hints in cases:
        tag = mpt_cuda.next_tag()
        mode = "bounded" if hints is None else "hinted"
        queued.append((label, hints, tag, *mpt_cuda.walk_lanes(mode, *args, hints=hints, tag=tag)))
    walked = mpt_cuda.exact_walked(dev)
    err, latched = 0, []
    for label, _, tag, out, _ in queued:
        e = max_err([mpt_cuda.folded_flag(dev, tag)], [mpt_cuda.guard_plain(out)])
        check(e == 0, f"the folded re-run flag differs from guard_plain on {label}")
        err = max(err, e)
        latched.append(int((out[:, 4] != 0).sum()))
    for label, hints, tag, out, values in queued:
        out, values = mpt_cuda.rerun_exact(out, values, args, tag)
        status = out[:, 0]
        got = (status, values, torch.where(status == mpt.FOUND, out[:, 3], 0), out[:, 5])
        want = plain_walk([*args[:3], *args[4:7]], args[3], hints, args[7], args[8],
                          with_reasons=True)
        e = max_err(got, want)
        check(e == 0, f"the folded re-run on {label} differs from the plain route "
                      f"(max abs err {e})")
        err = max(err, e)
    ran = mpt_cuda.exact_walked(dev) - walked
    want_ran = sum(n > 0 for n in latched)
    check(ran == want_ran, f"the guarded exact launch walked {ran} times, {want_ran} of "
                           f"{len(cases)} first walks latched")
    return err, latched


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
    """models.verifier.verify_storage_pooled from the plain versions only,
    on any device: the same arguments and results."""
    a_dig, a_h = plain_table(a_pool, a_hints)
    a_status, a_values, a_vlens = plain_walk(a_batch, a_dig, a_h, 128)
    acct = decode_account_plain(a_values, a_vlens)
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
    """A request packed as BatchVerifier's dense route packs it (the dense
    table, pooled on the host) and routed as verify routes it, verified on
    the plain path on the card; (status, values, value_lens) in request
    order."""
    n = len(req)
    order = sorted(range(n), key=lambda i: -len(req[i][1]))
    bk = svc.bucket
    packed = pack_proofs(svc._padded([req[i] for i in order]), max_nodes=bk.max_nodes,
                         node_len=bk.node_len, key_nibbles=bk.key_nibbles)
    packed.pool(min_rows=svc.pool_rows)
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
