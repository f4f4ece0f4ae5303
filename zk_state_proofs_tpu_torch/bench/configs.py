"""BASELINE configs 1-6 as runnable benchmarks on the card. The port's
counterpart of the JAX package's `bench_configs.py` (`:1-745`), with its
configuration names and, wherever a key means the same thing, its keys.

    python -m zk_state_proofs_tpu_torch.bench.configs [--quick] [--configs 1,2,...] [--seed N]

  1. single_tx_proof            a transaction proof through the circuit
                                entry point, and 4096 proofs at
                                transaction-trie geometry (about 2 KB leaves,
                                values read back at full width);
  2. account_storage_proof      an account and slot proof through the storage
                                circuit, and the grouped two-level batch (512
                                accounts x 8 slots over 256-slot tries);
  3. full_receipt_trie          a block's receipts against its receiptsRoot
                                with ERC20 extraction, and the host ERC20
                                sweep (vectorized against per-receipt decode);
  4. mixed_batch_4096           4096 account, storage and transaction proofs
                                loaded through the disk cache, pooled with no
                                pack-time hints;
  5. sweep_with_root_reduction  config 5's sweeps over 65,536 accounts
                                (1,048,576 proofs) and a receipt-trie root;
  6. distinct_1m_resident       2^20 distinct accounts in one resident epoch.

Prints one JSON line per configuration on stdout, each with `ok`, the seed,
the card's name and power limit and the kernels' launches, and exits 1
unless every line has `ok` true. Any failed call raises (exit non-zero).
Every batch figure folds each call's status and values into accumulators
that the host reads and checks (bench.common.Step); a counter in a
padding byte makes every call distinct work.

The JAX script draws its salts with `secrets` (`:484`, `:561`, `:628`,
`:710`) to defeat a relay's duplicate-dispatch cache; the card has no such
cache, so the counters and the sweeps' random batches come from --seed.
Config 4's time is CUDA events around back-to-back calls (never queued
behind a spin: its ~800 launches a call fill the launch queue), its device
busy time torch.profiler's.
"""

from __future__ import annotations

import argparse
import os
import random
import tempfile
import time

import numpy as np
import torch

from ..models import (extract_erc20_transfers, run_merkle_circuit, run_storage_circuit,
                      sweep_entries, sweep_resident, sweep_resident_epochs, verify_block_receipts)
from ..models.verifier import verify_storage_pooled
from ..ops import mpt
from ..ops.trie_build import compute_root
from ..oracle import EthTrie, rlp
from ..witness import (ERC20_TRANSFER_TOPIC, PackedProofs, StorageProofInput, encode_receipt,
                       encode_transaction, get_transaction_proof_input, pack_proofs,
                       synthetic_block)
from ..witness.trie_plan import plan_index_trie
from ..witness_bridge import (BATCH_FIELDS, POOL_FIELDS, default_hasher, distinct_world,
                              mixed_batch, packed_to_tensors, storage_world, sweep_world,
                              tx_geometry_batch, tx_geometry_block)
from .common import (Step, busy_profile, card_info, emit, log, perturb, pooled_call,
                     read_counts, require, require_card, value_word, wall_ms, zero_counts)

ITERS = 9   # back-to-back calls a timed rep
REPS = 3


def _timed(call, rows, dev, seed, what):
    """The best ms a call of `call(ctr)` over REPS runs of ITERS
    back-to-back calls (CUDA events), each run's accumulators checked
    against the unperturbed call. Returns (best ms, every run's ms, the
    unperturbed call's outputs)."""
    first = call(0)
    runs = Step(call, rows, dev, ctr=seed).timed(wall_ms, ITERS, REPS,
                                                 value_word(*first[1:]), what)
    return min(runs), runs, first


def config1_single_tx(quick, seed, dev):
    fx = synthetic_block(num_txs=16 if quick else 64, seed=1)
    inp = get_transaction_proof_input(fx["block"], 15)
    t0 = time.time()
    value = run_merkle_circuit(inp.to_borsh(), device=dev)
    dt = time.time() - t0
    extras = _tx_geometry_batch(quick, seed, dev)
    ok = extras.pop("_ok") and value == encode_transaction(fx["block"]["transactions"][15])
    return "single_tx_proof", dict(ok=ok, seconds=round(dt, 3), **extras)


def _tx_geometry_batch(quick, seed, dev):
    """K2 at transaction-trie geometry (`bench_configs.py:55-169`): 4096 proofs
    over a 256-tx block of about 2 KB leaves, verify_proofs_pooled without
    pack-time hints (the device hint pass, as the JAX call), every value
    read back at full width."""
    total = 1024 if quick else 4096
    txb = tx_geometry_batch(tx_geometry_block(64 if quick else 256, 11), total)
    d = txb.packed.nodes.shape[1]
    t = packed_to_tensors(txb.packed, dev, hints=False)
    call = pooled_call(t, max_value_len=txb.max_value_len, max_steps=txb.max_steps)
    ms, runs, (status, values, lens) = _timed(call, total, dev, seed, "tx geometry")
    status, values, lens = status.cpu().numpy(), values.cpu().numpy(), lens.cpu().numpy()
    ok = bool((status == mpt.FOUND).all()) and all(
        bytes(values[i, :lens[i]]) == v for i, v in enumerate(txb.values))
    return {"_ok": ok, "tx_geometry_batch": total,
            "tx_geometry_node_len": int(txb.packed.nodes.shape[2]),
            "tx_geometry_depth": d, "tx_geometry_max_value_len": txb.max_value_len,
            "tx_geometry_proofs_per_sec": round(total / ms * 1e3, 1),
            "tx_geometry_ms_per_batch": round(ms, 4), "tx_geometry_ms_runs": runs,
            "tx_geometry_found": int((status == mpt.FOUND).sum()),
            "tx_geometry_backend": dev.type}


def config2_account_storage(quick, seed, dev):
    nk = default_hasher()
    world, st = EthTrie(hasher=nk), EthTrie(hasher=nk)
    addr = bytes.fromhex("dac17f958d2ee523a2206206994597c13d831ec7")
    slot = bytes(32)  # totalSupply, slot 0
    val = rlp.encode_int(39_035_000_000_000)
    st.insert(nk(slot), val)
    sroot = st.root_hash()
    world.insert(nk(addr), rlp.encode([b"\x01", b"\x01", sroot, nk(b"usdt")]))
    for i in range(64 if quick else 512):
        world.insert(nk(b"acct%d" % i), rlp.encode([b"\x01", b"", sroot, sroot]))
    inp = StorageProofInput(
        account_proof=world.get_proof(nk(addr)), storage_proofs=[st.get_proof(nk(slot))],
        root_hash=world.root_hash(), account_key=nk(addr), storage_keys=[slot],
        address_keccak=nk(addr))
    t0 = time.time()
    values = run_storage_circuit(inp.to_borsh(), device=dev)
    dt = time.time() - t0
    extras = _grouped_storage_batch(quick, seed, dev)
    ok = extras.pop("_ok") and values == [val]
    return "account_storage_proof", dict(ok=ok, seconds=round(dt, 3), **extras)


def _grouped_storage_batch(quick, seed, dev):
    """The two-level grouped storage core (`bench_configs.py:209-341`) on
    witness_bridge.storage_world: A accounts x 8 slots, the account level
    pooled and hinted by the device hint pass (no pack-time hints, as the
    JAX call), the slot level `bounded`. Slots are padded to 36 B so the
    counter rides the padding; every slot value and the account balances
    are folded."""
    n_accounts, slots_per = (64 if quick else 512), 8
    t0 = time.time()
    w = storage_world(n_accounts, slots_per, 64 if quick else 256)
    witness_s = time.time() - t0
    ap, sp = w.pack()
    at, st = packed_to_tensors(ap, dev, hints=False), packed_to_tensors(sp, dev, hints=False)
    b = sp.batch
    slots = torch.zeros((b, 36), dtype=torch.uint8, device=dev)
    slots[:, :32] = torch.from_numpy(w.slots).to(dev)
    sa = torch.from_numpy(w.slot_accounts).to(dev)
    # the account level's fold: each call adds its status and balance bytes
    acc_a = torch.zeros(n_accounts, dtype=torch.int64, device=dev)

    def call(ctr):
        perturb(ctr, at["nodes"], at["pool_nodes"], st["nodes"], st["pool_nodes"], slots)
        a_st, acct, s_st, s_v, s_vl = verify_storage_pooled(
            [at[k] for k in BATCH_FIELDS], [at[k] for k in POOL_FIELDS], None,
            st["nodes"], st["node_lens"], st["num_nodes"], [st[k] for k in POOL_FIELDS],
            slots, sa)
        acc_a.add_(a_st).add_(acct["balance"].sum(1, dtype=torch.int64))
        return s_st, s_v, s_vl

    first = call(0)
    a_word = acc_a.clone()  # FOUND + the balance's byte sum, if every account verified
    status, values, lens = (x.cpu().numpy() for x in first)
    ok = bool((status == mpt.FOUND).all()) and all(
        bytes(values[i, :lens[i]]) == v for i, v in enumerate(w.slot_values))
    step = Step(call, b, dev, ctr=seed)
    runs = []
    for rep in range(REPS):  # Step.timed's runs, each with the account fold checked too
        acc_a.zero_()
        runs += step.timed(wall_ms, ITERS, 1, value_word(*first[1:]), f"grouped storage {rep}")
        require(torch.equal(acc_a, step.fold.calls * a_word),
                f"grouped storage run {rep}: the account fold changed")
    ms = min(runs)
    return {"_ok": ok, "grouped_accounts": n_accounts, "grouped_slots_per_account": slots_per,
            "grouped_slot_proofs": b, "grouped_account_depth": int(ap.nodes.shape[1]),
            "grouped_slot_depth": int(sp.nodes.shape[1]),
            "grouped_witness_gen_seconds": round(witness_s, 2),
            "grouped_slots_per_sec": round(b / ms * 1e3, 1),
            "grouped_ms_per_batch": round(ms, 4), "grouped_ms_runs": runs,
            "grouped_found": int((status == mpt.FOUND).sum()), "grouped_backend": dev.type}


def config3_receipt_trie(quick, seed, dev):
    n = 32 if quick else 128
    fx = synthetic_block(num_txs=n, seed=3)
    t0 = time.time()
    res, transfers = verify_block_receipts(fx["block"], fx["receipts"], device=dev)
    dt = time.time() - t0
    extras = _erc20_extract_sweep(quick)
    return "full_receipt_trie", dict(ok=extras.pop("_ok") and res.all_found, receipts=n,
                                     erc20_transfers=len(transfers), seconds=round(dt, 3),
                                     **extras)


def _erc20_extract_sweep(quick):
    """Host cost of ERC20 log extraction at a sweep where every receipt is a
    candidate (`bench_configs.py:366-430`): the vectorized engine against
    the per-receipt host decode, their results asserted equal. Host only."""
    rows = 512 if quick else 4096
    rng = random.Random(17)

    def word():
        return "0x" + bytes(rng.randrange(256) for _ in range(32)).hex()

    receipts = []
    for i in range(rows):
        logs = [{"address": "0x" + bytes(rng.randrange(256) for _ in range(20)).hex(),
                 "topics": [ERC20_TRANSFER_TOPIC, word(), word()], "data": word()}
                for _ in range(rng.randrange(1, 4))]
        receipts.append({"type": "0x2", "status": "0x1",
                         "cumulativeGasUsed": hex(30000 * (i + 1)), "logs": logs})
    values = [encode_receipt(r) for r in receipts]
    arr = np.zeros((rows, max(map(len, values))), np.uint8)
    lens = np.zeros(rows, np.int32)
    for i, v in enumerate(values):
        arr[i, :len(v)] = np.frombuffer(v, np.uint8)
        lens[i] = len(v)
    status = np.full(rows, mpt.FOUND, np.int32)
    best = {}
    for engine in ("vectorized", "host"):
        best[engine] = float("inf")
        for _ in range(3):
            t0 = time.time()
            got = extract_erc20_transfers(arr, lens, status, engine=engine)
            best[engine] = min(best[engine], time.time() - t0)
            if engine == "vectorized":
                vec = got
    fields = ("token", "sender", "receiver", "amount", "tx_index")
    ok = len(vec) == len(got) == sum(len(r["logs"]) for r in receipts) and all(
        [getattr(g, f) for f in fields] == [getattr(h, f) for f in fields]
        for g, h in zip(vec, got))
    return {"_ok": ok, "erc20_sweep_receipts": rows, "erc20_sweep_transfers": len(vec),
            "erc20_vectorized_receipts_per_sec": round(rows / best["vectorized"], 1),
            "erc20_host_decode_receipts_per_sec": round(rows / best["host"], 1),
            "erc20_vectorized_speedup": round(best["host"] / best["vectorized"], 2)}


def config4_mixed_batch(quick, seed, dev):
    """BASELINE config 4 (`bench_configs.py:432-515`): witness_bridge.mixed_batch,
    saved and loaded through the disk cache (the pool validated on load),
    verify_proofs_pooled with no pack-time hints and no segments."""
    total = 512 if quick else 4096
    _, fresh = mixed_batch(total)
    fresh.pool()  # the pool is saved with the batch, and checked on load
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mixed.npz")
        t0 = time.time()
        fresh.save(path)
        save_s = time.time() - t0
        t0 = time.time()
        packed = PackedProofs.load(path)
        load_s = time.time() - t0
    call = pooled_call(packed_to_tensors(packed, dev, hints=False), max_value_len=128)
    ms, runs, (status, _, _) = _timed(call, total, dev, seed, "mixed batch")
    found = int((status == mpt.FOUND).sum())
    prof = busy_profile(lambda i: call(seed + i), 5, dev)
    return "mixed_batch_4096", dict(
        ok=found == total, batch=total, found=found, proofs_per_sec=round(total / ms * 1e3, 1),
        seconds=round(ms / 1e3, 6), ms_runs=runs, host_ms_per_call=prof["wall_ms"],
        device_busy_ms=prof["busy_ms"], device_launches_per_call=prof["launches"],
        cache_save_seconds=round(save_s, 4), cache_load_seconds=round(load_s, 4))


def config5_sweep_with_root_reduction(quick, seed, dev):
    """BASELINE config 5 (`bench_configs.py:518-671`): 65,536 accounts
    (quick: 8192), batches of 4096, 256 batches (quick: 16) through every
    sweep form on one card, and config 5's receipt-trie root."""
    n_accounts, batch, nbatches = (8192 if quick else 65536), 4096, (16 if quick else 256)
    t0 = time.time()
    w = sweep_world(n_accounts)
    witness_s = time.time() - t0
    d = w.max_nodes
    rng = np.random.default_rng(seed)
    # the pool-row bucket from a probe batch of a fixed seed: one pool shape
    probe = pack_proofs(next(w.entry_batches(1, batch, np.random.default_rng(5))),
                        max_nodes=d, node_len=576)
    probe_lens = probe.pool()[1]
    pool_rows = -(-int(probe.pool()[0].shape[0] * 1.125) // 128) * 128
    dedup = float(probe.num_nodes.sum()) / max(float((probe_lens > 0).sum()), 1.0)
    kw = dict(max_nodes=d, node_len=576, pool_rows=pool_rows, device=dev)
    sweep_entries(w.entry_batches(1, batch, rng), **kw)  # warm-up
    fresh = sweep_entries(w.entry_batches(nbatches, batch, rng), **kw)
    gp = w.pack()
    epochs = nbatches * batch // n_accounts
    sweep_resident_epochs(gp, epochs, batch, max_steps=d, salt=seed + 0x80, device=dev)
    res_ep = sweep_resident_epochs(gp, epochs, batch, max_steps=d, salt=seed, device=dev)
    sweep_resident(gp, w.index_batches(nbatches, batch, rng), max_steps=d, fused=True,
                   device=dev)  # warm-up
    res_fused = sweep_resident(gp, w.index_batches(nbatches, batch, rng), max_steps=d,
                               fused=True, device=dev)
    sweep_resident(gp, w.index_batches(1, batch, rng), max_steps=d, device=dev)  # warm-up
    res = sweep_resident(gp, w.index_batches(nbatches, batch, rng), max_steps=d, device=dev)
    fx = synthetic_block(num_txs=64 if quick else 256, seed=5)
    rroot, _ = compute_root(plan_index_trie([encode_receipt(r) for r in fx["receipts"]]),
                            device=dev)
    root_ok = "0x" + bytes(rroot).hex() == fx["block"]["receiptsRoot"]
    ok = root_ok and all(r.found == r.total for r in (res_ep, res_fused, res, fresh))
    return "sweep_with_root_reduction", dict(
        ok=ok, proofs=res_ep.total, found=res_ep.found,
        proofs_per_sec=round(res_ep.proofs_per_sec, 1), seconds=round(res_ep.seconds, 4),
        witness_gen_seconds=round(witness_s, 2),
        resident_pack_upload_seconds=round(res_ep.pack_seconds, 4),
        random_access_proofs_per_sec=round(res_fused.proofs_per_sec, 1),
        stream_proofs_per_sec=round(res.proofs_per_sec, 1),
        stream_dispatch_seconds=round(res.dispatch_seconds, 4),
        fresh_stream_proofs_per_sec=round(fresh.proofs_per_sec, 1),
        fresh_pack_seconds=round(fresh.pack_seconds, 2),
        fresh_dispatch_seconds=round(fresh.dispatch_seconds, 2),
        batches=res_ep.batches, accounts=n_accounts, pool_rows=pool_rows,
        dedup_ratio=round(dedup, 2), root_ok=root_ok, devices=1)


def config6_distinct_1m(quick, seed, dev):
    """2^20 fully distinct account proofs (quick: 2^17) in one resident epoch
    (`bench_configs.py:674-722`), witness_bridge.distinct_world."""
    n = (1 << 17) if quick else (1 << 20)
    t0 = time.time()
    w = distinct_world(n)
    witness_s = time.time() - t0
    t0 = time.time()
    gp = w.pack()
    gp.pool()
    pack_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    kw = dict(max_steps=w.max_nodes, device=dev, forbid_sync=True)
    sweep_resident_epochs(gp, 1, 4096, salt=seed + 0x80, **kw)  # warm-up
    res = sweep_resident_epochs(gp, 1, 4096, salt=seed, **kw)
    return "distinct_1m_resident", dict(
        ok=res.found == res.total == n, proofs=res.total, found=res.found,
        proofs_per_sec=round(res.proofs_per_sec, 1), seconds=round(res.seconds, 4),
        witness_gen_seconds=round(witness_s, 1), host_pack_seconds=round(pack_s, 1),
        device_pack_upload_seconds=round(res.pack_seconds, 4), accounts=n,
        max_depth=w.max_nodes, batches=res.batches,
        peak_device_memory_bytes=torch.cuda.max_memory_allocated(dev))


CONFIGS = {"1": config1_single_tx, "2": config2_account_storage, "3": config3_receipt_trie,
           "4": config4_mixed_batch, "5": config5_sweep_with_root_reduction,
           "6": config6_distinct_1m}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--configs", default="1,2,3,4,5,6")
    ap.add_argument("--seed", type=int, default=0,
                    help="the counters' start and the sweeps' batch order")
    args = ap.parse_args(argv)
    names = args.configs.split(",")
    unknown = [c for c in names if c not in CONFIGS]
    require(not unknown, f"unknown configs {unknown}: choose from {sorted(CONFIGS)}")
    card = card_info()
    dev = require_card()
    ok = True
    for c in names:
        zero_counts()
        t0 = time.time()
        name, fields = CONFIGS[c](args.quick, args.seed, dev)
        fields["ok"] = bool(fields["ok"])
        line = emit(config=name, **fields, quick=args.quick, seed=args.seed,
                    launches=read_counts(dev), run_seconds=round(time.time() - t0, 1),
                    card=card["nvidia_smi"])
        log(f"[config {c}] {name}: ok {line['ok']} in {line['run_seconds']} s")
        ok &= line["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
