#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — the pooled account-proof verifier behind
`BatchVerifier` — at the headline shape: 4096 distinct account proofs over a
4096-account trie (the bench.py recipe, 576 B nodes, depth-sorted), served
by `BatchVerifier(BucketConfig.account(), 4096)` with pinned depth and pool
segment schedules. Phases, each printing a line:

  1. device: a CUDA device, or exit 1; the card's name and power limit;
  2. build: the kernels (csrc/*.cu) built from the checkout;
  3. K1 (keccak) against its plain version on the card, and the oracle;
  4. K2 (MPT walk, modes hinted and exact) against its plain version on the
     card: the headline batch, an adversarial batch, corrupted hints;
  5. main path: three requests through BatchVerifier; every headline proof
     FOUND with the oracle's leaf; results equal the plain path on the card;
     both kernels launched by the main path;
  6. timings with CUDA events, kernel path against plain path.

Any failed check exits non-zero. The next-to-last line is a JSON object of
the kernels; the last line is {"ok": true, "device": {...}}. Uses no JAX.
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
    from zk_state_proofs_tpu import native
    from zk_state_proofs_tpu.oracle import EthTrie, keccak256 as oracle_keccak, rlp
    from zk_state_proofs_tpu.witness import pack_proofs
    from zk_state_proofs_tpu.witness.pack import host_item_offsets
    from zk_state_proofs_tpu_torch.models import BatchVerifier
    from zk_state_proofs_tpu_torch.ops import keccak as tkeccak
    from zk_state_proofs_tpu_torch.ops import keccak_cuda, mpt, mpt_cuda
    from zk_state_proofs_tpu_torch.ops._build import load_library
    from zk_state_proofs_tpu_torch.utils.config import BucketConfig
    from zk_state_proofs_tpu_torch.utils.profiling import cuda_timer
    from zk_state_proofs_tpu_torch.witness_bridge import (
        BATCH_FIELDS, POOL_FIELDS, account_entries, packed_to_tensors)
except ImportError as exc:  # run outside a checkout of the repo
    print(f"FAIL: the repository's packages are not importable here: {exc}")
    sys.exit(1)

N_ACCOUNTS = 4096
TIMED_ITERS = 20
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def native_host_ok(repo: str) -> bool:
    """Whether the tracked native host library (built elsewhere with
    -march=native) runs on this CPU: probed in a child process, since an
    unsupported instruction kills the process that executes it."""
    code = (
        "import numpy as np\n"
        "from zk_state_proofs_tpu import native\n"
        "from zk_state_proofs_tpu.oracle import EthTrie, keccak256\n"
        "from zk_state_proofs_tpu.witness import pack_proofs\n"
        "assert native.available()\n"
        "assert native.keccak256(b'abc') == keccak256(b'abc')\n"
        "t = EthTrie(hasher=native.keccak256)\n"
        "ks = [native.keccak256(b'p%d' % i) for i in range(40)]\n"
        "[t.insert(k, b'\\x01' * 40) for k in ks]\n"
        "p = pack_proofs([(t.root_hash(), t.get_proof(k), k) for k in ks], max_nodes=8, node_len=576)\n"
        "p.pool(); p.pool_hints()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    return out.returncode == 0


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
    if native_host_ok(repo):
        hasher_name = "native (C++)"
    else:
        native._load_failed = True  # every host path takes its Python form
        hasher_name = "oracle (pure Python; the native host library does not run here)"
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

    def max_err(got, want):
        """Largest |got - want| over tensors (integers: 0 means identical)."""
        err = 0
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"shape/dtype {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
            if g.numel():
                err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        return err

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

    def seg_args(t, dig, hints, sl, d):
        return ([t[0][sl, :d], t[1][sl, :d], t[2][sl], dig[sl, :d], t[3][sl],
                 t[4][sl], t[5][sl]], hints[sl, :d])

    k2_err = {"hinted": 0, "exact": 0}

    def compare_k2(args, hints, label, steps=max_steps):
        for mode in ("hinted", "exact"):
            got = mpt_cuda.walk_lanes(mode, *args, 128, steps, hints=hints)
            torch.cuda.synchronize()
            want = mpt.walk_kernel_plain(mode, *args, 128, steps, hints=hints)
            e = max_err(got, want)
            k2_err[mode] = max(k2_err[mode], e)
            check(e == 0, f"K2 {mode} differs from plain on {label} (max abs err {e})")

    off = 0
    for cnt, d in segs:
        a, h = seg_args(batch, dig_table, hint_table, slice(off, off + cnt), d)
        compare_k2(a, h, f"headline segment ({cnt}, {d})")
        off += cnt

    adv_entries, inline_entries = adversarial_entries(entries)
    adv = pack_proofs(adv_entries + inline_entries, max_nodes=12, node_len=576)
    at = packed_to_tensors(adv, dev, pool=False)
    abatch = [at[k] for k in BATCH_FIELDS]
    adig = mpt.hash_nodes(abatch[0], abatch[1])
    b_, d_, n_ = adv.nodes.shape
    ahints = torch.from_numpy(host_item_offsets(adv.nodes.reshape(b_ * d_, n_))
                              .reshape(b_, d_, 36)).to(dev)
    compare_k2([abatch[0], abatch[1], abatch[2], adig, *abatch[3:]], ahints,
               "the adversarial batch", steps=d_ + 6)

    # corrupted hints: ovf latches, the exact kernel re-runs, results unchanged
    sl = slice(0, segs[0][0])
    a, h = seg_args(batch, dig_table, hint_table, sl, segs[0][1])
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
    for counts in (keccak_cuda.LAUNCHES, mpt_cuda.LAUNCHES):
        for k in counts:
            counts[k] = 0
    t0 = time.time()
    results = [svc.verify(req) for req in requests]
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    launches = {"keccak256": keccak_cuda.LAUNCHES["keccak256"],
                "hinted": mpt_cuda.LAUNCHES["hinted"],
                "exact": mpt_cuda.LAUNCHES["exact"]}
    for name, n in launches.items():
        check(n > 0, f"the main path launched the {name} kernel no time")
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
    for mode in ("hinted", "exact"):
        def run(i, fn):
            off = 0
            for cnt, d in segs:
                a, h = seg_args(batch, dig_table, hint_table, slice(off, off + cnt), d)
                fn(mode, *a, 128, max_steps, hints=h)
                off += cnt
        k2[mode] = (cuda_timer(lambda i: run(i, mpt_cuda.walk_lanes), TIMED_ITERS),
                    cuda_timer(lambda i: run(i, mpt.walk_kernel_plain), TIMED_ITERS))
    log(f"[6 time] K1 keccak, {pn.shape[0]}-row headline pool, segmented: "
        f"kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms on {card}")
    for mode, (km, pm) in k2.items():
        log(f"[6 time] K2 walk {mode}, {N_ACCOUNTS} proofs in {len(segs)} "
            f"segments: kernel {km:.4f} ms, plain {pm:.4f} ms on {card}")
    check("jax" not in sys.modules, "JAX was imported")

    src = "zk_state_proofs_tpu_torch/csrc/"
    kernels = [
        {"name": "keccak256", "route": "cuda", "source": src + "keccak.cu",
         "replaces": "zk_state_proofs_tpu/ops/keccak_pallas.py:122",
         "launches": launches["keccak256"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
    ]
    for mode in ("hinted", "exact"):
        kernels.append({
            "name": f"mpt_walk_{mode}", "route": "cuda", "source": src + "mpt_walk.cu",
            "replaces": "zk_state_proofs_tpu/ops/mpt_pallas.py:165",
            "launches": launches[mode], "max_abs_err": k2_err[mode],
            "ms": k2[mode][0], "plain_ms": k2[mode][1]})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


def seg_offsets(segments):
    offs, off = [], 0
    for cnt, _ in segments:
        offs.append(off)
        off += cnt
    return offs


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


def plain_pooled(batch, pool, pool_hints, segs, psegs):
    """The pooled main path built from the plain versions only (plain keccak,
    row gather, plain hinted walk with the exact re-run), on any device."""
    pn, pl, pidx = pool
    dig = torch.cat([tkeccak.keccak256(pn[o:o + c, :w], pl[o:o + c])
                     for o, (c, w) in zip(seg_offsets(psegs), psegs)])
    table = mpt.scatter_pool_payload(torch.cat([dig, pool_hints], 1), pidx)
    max_steps = batch[0].shape[1] + 6
    outs = []
    for o, (cnt, d) in zip(seg_offsets(segs), segs):
        sl = slice(o, o + cnt)
        args = (batch[0][sl, :d], batch[1][sl, :d], batch[2][sl], table[sl, :d, :32],
                batch[3][sl], batch[4][sl], batch[5][sl], 128, max_steps)
        out, values = mpt.walk_kernel_plain("hinted", *args, hints=table[sl, :d, 32:])
        if bool((out[:, 4] != 0).any()):
            out, values = mpt.walk_kernel_plain("exact", *args)
        status = out[:, 0]
        outs.append((status, values, torch.where(status == mpt.FOUND, out[:, 3], 0)))
    return tuple(torch.cat(p) for p in zip(*outs))


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
