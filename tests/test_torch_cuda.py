"""Kernels K1-K5 against their plain versions, on the card; the `exact`
re-run decided on the card (the flag folded into the first walk) against
the route that reads its flag on the host; the
device hint pass and the sweeps on the card against the CPU; the
two-level storage entry at the benchmark's published widths against its
plain reference.

Every test here needs a CUDA device and skips without one. The file imports
no JAX and nothing of the JAX package, so it runs on a machine with PyTorch alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest configures JAX.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from proofbench.drivers._common import Batches
from proofbench.reference import storage as plain
from proofbench.traffic._storage import make_storage_world
from zk_state_proofs_tpu_torch.models import (BatchVerifier, replicated_batches, sweep,
                                              sweep_entries, sweep_resident,
                                              sweep_resident_epochs, verify_storage_pooled)
from zk_state_proofs_tpu_torch.models.sweep import (_UPLOAD, _expand_tables, _upload,
                                                    _upload_arrays, epoch_tables)
from zk_state_proofs_tpu_torch.oracle import EthTrie, keccak256, rlp
from zk_state_proofs_tpu_torch.ops import keccak as tkeccak
from zk_state_proofs_tpu_torch.ops import decode_cuda, keccak_cuda, mpt, mpt_cuda
from zk_state_proofs_tpu_torch.ops import rlp as rlp_ops
from zk_state_proofs_tpu_torch.ops.account import decode_account, decode_account_plain
from zk_state_proofs_tpu_torch.utils.config import BucketConfig
from zk_state_proofs_tpu_torch.witness import host_item_offsets, pack_proofs
from zk_state_proofs_tpu_torch.witness_bridge import (BATCH_FIELDS, POOL_FIELDS,
                                                      account_entries,
                                                      account_fuzz_values, decode_fuzz_rows,
                                                      packed_to_tensors, sweep_world)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel tests run on the card)")
    return torch.device("cuda")


def test_keccak_kernel_matches_plain(dev):
    edge = [0, 1, 135, 136, 137, 271, 272, 535, 536, 576, 0, 0]
    rng = np.random.default_rng(6)
    data = rng.integers(0, 256, (len(edge), 576), dtype=np.uint8)
    data[-2:] = 0
    rows = torch.from_numpy(data).to(dev)
    lens = torch.tensor(edge, dtype=torch.int32, device=dev)
    before = keccak_cuda.LAUNCHES["keccak256"]
    got = keccak_cuda.keccak256_cuda(rows, lens)
    torch.cuda.synchronize()
    assert keccak_cuda.LAUNCHES["keccak256"] == before + 1
    assert torch.equal(got, tkeccak.keccak256(rows, lens))
    for i, n in enumerate(edge):
        assert bytes(got[i].cpu().numpy()) == keccak256(bytes(data[i, :n]))
    # column slices hash in place: row stride 576, widths 300 and 137, rows
    # starting 0, 1 or 4 bytes in (1-, 4- and 8-byte aligned), with the
    # lengths as they are, so len > width on most rows (the pad bytes' places
    # come from len, the bytes at or past the width read 0)
    for start, width in ((0, 300), (1, 300), (4, 137), (1, 575)):
        view = rows[:, start:start + width]
        want = tkeccak.keccak256(view, lens)
        assert torch.equal(keccak_cuda.keccak256_cuda(view, lens), want)
    # transaction-geometry rows (2092 B, 4-byte aligned) of 1 to 16 blocks
    tx_lens = [0, 135, 136, 1000, 2091, 2092, 1500, 2176]
    tx = torch.from_numpy(rng.integers(0, 256, (len(tx_lens), 2092), dtype=np.uint8)).to(dev)
    tl = torch.tensor(tx_lens, dtype=torch.int32, device=dev)
    want = tkeccak.keccak256(tx, tl)
    assert torch.equal(keccak_cuda.keccak256_cuda(tx, tl), want)
    for i, n in enumerate(tx_lens[:6]):
        assert bytes(want[i].cpu().numpy()) == keccak256(bytes(tx[i, :n].cpu().numpy()))


def _entries():
    t = EthTrie()
    keys = [keccak256(b"card-%d" % i) for i in range(64)]
    for i, k in enumerate(keys):
        t.insert(k, b"\x09" + bytes([i]) * 40)
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys[:12]]
    absent = keccak256(b"card-absent")
    entries.append((root, t.get_proof(absent), absent))
    entries.append((b"\x31" * 32, t.get_proof(keys[1]), keys[1]))
    entries.append((root, t.get_proof(keys[2])[:1], keys[2]))
    crafted = rlp.encode([b"\x01"])
    entries.append((keccak256(crafted), [crafted], keys[3]))
    inl = EthTrie()
    ikeys = [keccak256(b"card-inl-%d" % i)[:6] for i in range(32)]
    for i, k in enumerate(ikeys):
        inl.insert(k, rlp.int_to_min_bytes(i + 1))
    entries += [(inl.root_hash(), inl.get_proof(k), k) for k in ikeys[:6]]
    return entries


def _batch():
    return pack_proofs(_entries(), max_nodes=8, node_len=576)


@pytest.mark.parametrize("mode", ["hinted", "bounded", "exact"])
def test_walk_kernel_matches_plain(dev, mode):
    packed = _batch()
    t = packed_to_tensors(packed, dev, pool=False)
    b = [t[k] for k in BATCH_FIELDS]
    dig = mpt.hash_nodes(b[0], b[1])
    bb, d, n = packed.nodes.shape
    hints = torch.from_numpy(host_item_offsets(packed.nodes.reshape(bb * d, n))
                             .reshape(bb, d, 36)).to(dev)
    args = (b[0], b[1], b[2], dig, b[3], b[4], b[5], 128, d + 6)
    got = mpt_cuda.walk_lanes(mode, *args, hints=hints)
    torch.cuda.synchronize()
    want = mpt.walk_kernel_plain(mode, *args, hints=hints)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if mode == "hinted":
        assert int(got[0][:, 4].sum()) > 0  # the inline-node proofs latch
        _check_window_past_2_31(dev)
    if mode == "exact":
        _check_device_hint_pass_and_sweeps(dev, packed)
        return
    # the `exact` re-run decided on the card (the flag folded into the first
    # walk, a guarded launch) equals the route that reads the flag on the
    # host, bit for bit, on an honest batch, the adversarial batch and a
    # batch that latches; the folded flag equals guard_plain of the first
    # walk's words; each walk_batch_cuda call is one first-walk launch and
    # one `exact` launch; the device tally counts the guarded launches that
    # walked
    key = keccak256(b"card-over-bound")
    pair = rlp.encode([b"\x11" * 100, b"\x22"])  # item 1 past bounded's window
    latching = pack_proofs(_entries()[:4] + [(keccak256(pair), [pair], key)],
                           max_nodes=8, node_len=576)
    inputs = {}
    for label, pk in (("honest", pack_proofs(_entries()[:12], max_nodes=8, node_len=576)),
                      ("adversarial", packed), ("latching", latching)):
        a, h = _walk_inputs(dev, pk)
        if mode == "hinted" and label == "latching":
            h = (h.to(torch.int32) + 7).remainder(255).to(torch.uint8)  # corrupt hints
        h = h if mode == "hinted" else None
        inputs[label] = (a, h)
        tag = mpt_cuda.next_tag()
        first = mpt_cuda.walk_lanes(mode, *a, hints=h, tag=tag)[0]
        latched = bool((first[:, 4] != 0).any())
        assert latched if label == "latching" else not latched or label == "adversarial"
        assert torch.equal(mpt_cuda.folded_flag(dev, tag), mpt_cuda.guard_plain(first))
        assert int(mpt_cuda.folded_flag(dev, tag)) == int(latched), label
        walked = mpt_cuda.exact_walked(dev)
        before = dict(mpt_cuda.LAUNCHES)
        got = mpt_cuda.walk_batch_cuda(*a, hints=h, with_reasons=True)
        added = {k: v - before[k] for k, v in mpt_cuda.LAUNCHES.items() if v != before[k]}
        assert added == {mode: 1, "exact": 1}, label
        assert mpt_cuda.exact_walked(dev) == walked + int(latched), label
        want = _host_route(mode, a, h)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (mode, label)
    # two batches' first walks queued before either batch's guarded launch:
    # each keeps its own flag, and only the batch that latched walks again
    walked = mpt_cuda.exact_walked(dev)
    queued = []
    for label in ("latching", "honest"):
        a, h = inputs[label]
        tag = mpt_cuda.next_tag()
        out, values = mpt_cuda.walk_lanes(mode, *a, hints=h, tag=tag)
        queued.append((label, a, h, tag, out, values))
    for label, a, h, tag, out, values in queued:
        assert torch.equal(mpt_cuda.folded_flag(dev, tag), mpt_cuda.guard_plain(out)), label
    for label, a, h, tag, out, values in queued:
        out, values = mpt_cuda.rerun_exact(out, values, a, tag)
        want = _host_route(mode, a, h)
        assert torch.equal(out[:, 0], want[0]) and torch.equal(values, want[1]), label
        assert torch.equal(out[:, 5], want[3]), label
    assert mpt_cuda.exact_walked(dev) == walked + 1


def _check_window_past_2_31(dev):
    """K2 `hinted` on a window of a node table larger than 2^31 bytes (a
    256-proof headline batch tiled to [2^20, 5, 576], as config 6's table
    [2^20, D, 576] is): the window's view starts past byte 2^31 and is
    walked in place; its results equal the plain walk of the same rows and
    the kernel's on the untiled batch."""
    entries, _ = account_entries(256)
    small = pack_proofs(entries, node_len=576)
    a, h = _walk_inputs(dev, small)
    reps, win = (1 << 20) // small.batch, 4096
    nodes = a[0].repeat(reps, 1, 1)
    assert nodes.numel() > 1 << 31
    s0 = nodes.shape[0] - win
    window = nodes[s0:]
    assert window.data_ptr() - nodes.data_ptr() > 1 << 31
    k = win // small.batch
    args = (window, *(x.repeat(k, *[1] * (x.ndim - 1)) for x in a[1:7]), *a[7:])
    hints = h.repeat(k, 1, 1)
    got = mpt_cuda.walk_lanes("hinted", *args, hints=hints)
    want = mpt.walk_kernel_plain("hinted", *args, hints=hints)
    one = mpt_cuda.walk_lanes("hinted", *a, hints=h)
    for g, w, o in zip(got, want, one):
        assert torch.equal(g, w) and torch.equal(g, o.repeat(k, 1))
    assert bool((got[0][:, 0] == mpt.FOUND).all())
    del nodes, window


def _walk_inputs(dev, packed):
    """(walk_lanes' positional inputs, hints) of a packed batch on the card."""
    t = packed_to_tensors(packed, dev, pool=False)
    b = [t[k] for k in BATCH_FIELDS]
    bb, d, n = packed.nodes.shape
    hints = torch.from_numpy(host_item_offsets(packed.nodes.reshape(bb * d, n))
                             .reshape(bb, d, 36)).to(dev)
    return (b[0], b[1], b[2], mpt.hash_nodes(b[0], b[1]), b[3], b[4], b[5], 128,
            d + 6), hints


def _host_route(mode, args, hints):
    """walk_batch_cuda with the re-run decided on the host: the flag read
    there, then an unguarded `exact` launch."""
    out, values = mpt_cuda.walk_lanes(mode, *args, hints=hints)
    if bool((out[:, 4] != 0).any()):
        out, values = mpt_cuda.walk_lanes("exact", *args)
    status = out[:, 0]
    return status, values, torch.where(status == mpt.FOUND, out[:, 3], 0), out[:, 5]


def _check_device_hint_pass_and_sweeps(dev, packed):
    """The device hint pass on the card (K4, one launch a call) equals its
    plain version on the card and on the CPU, on a pool, random rows and
    fuzzed RLP rows at widths 576, 585 and 2092 (and a row slice); the
    account decode (K5, one launch a call) equals its plain version on
    honest and fuzzed account values; a small sweep in every form counts on
    the card what it counts on the CPU, with no sync inside its batch
    loops."""
    rng = np.random.default_rng(2)
    rows = np.concatenate([packed.pool()[0], rng.integers(0, 256, (32, 576), dtype=np.uint8),
                           decode_fuzz_rows(96, 576, seed=1)])
    cases = [torch.from_numpy(rows)] + [torch.from_numpy(decode_fuzz_rows(96, w, seed=w))
                                        for w in (585, 2092)]
    cases = [(x, x.to(dev)) for x in cases]
    cases.append((cases[-1][0][:, :1500], cases[-1][1][:, :1500]))  # row stride 2092
    for x, xd in cases:
        cpu = rlp_ops.item_offsets(x)
        before = decode_cuda.LAUNCHES["item_offsets"]
        got = rlp_ops.item_offsets(xd)
        assert decode_cuda.LAUNCHES["item_offsets"] == before + 1
        assert torch.equal(got.cpu(), cpu)
        assert torch.equal(got, rlp_ops.item_offsets_plain(xd))
    honest = [rlp.encode([rlp.int_to_min_bytes(i), rlp.int_to_min_bytes(10**18 + i),
                          keccak256(b"s%d" % i), keccak256(b"c%d" % i)]) for i in range(32)]
    values = np.zeros((32, 128), np.uint8)
    for i, leaf in enumerate(honest):
        values[i, :len(leaf)] = np.frombuffer(leaf, np.uint8)
    fv, fl = account_fuzz_values(512, 128, seed=3)
    for v, ln in ((values, np.fromiter(map(len, honest), np.int32)), (fv, fl),
                  (fv, fl.astype(np.int64)), (fv[:, :37], fl)):
        v, ln = torch.from_numpy(np.ascontiguousarray(v)), torch.from_numpy(ln)
        cpu = decode_account(v, ln)
        before = decode_cuda.LAUNCHES["decode_account"]
        got = decode_account(v.to(dev), ln.to(dev))
        assert decode_cuda.LAUNCHES["decode_account"] == before + 1
        plain = decode_account_plain(v.to(dev), ln.to(dev))
        for k in cpu:
            assert torch.equal(got[k].cpu(), cpu[k]) and torch.equal(got[k], plain[k]), k
    assert bool(decode_account(torch.from_numpy(values).to(dev),
                               torch.tensor([len(x) for x in honest], device=dev))["ok"].all())
    w = sweep_world(48)
    entries = w.entries(range(48)) + _entries()[12:]
    gp = pack_proofs(entries, max_nodes=8, node_len=576)
    sels = [rng.permutation(gp.batch)[:16] for _ in range(3)]
    for device in ("cpu", dev):
        sync = device != "cpu"
        got = [sweep_resident(gp, iter(sels), fused=f, materialize=m, device=device,
                              forbid_sync=sync) for f, m in ((True, None), (False, False))]
        got.append(sweep_resident_epochs(gp, 2, 16, salt=5, device=device, forbid_sync=sync))
        for dedup in (True, False):
            got.append(sweep_entries(([entries[i] for i in s] for s in sels), 8, 576,
                                     dedup=dedup, pool_rows=256, device=device,
                                     forbid_sync=sync))
            got.append(sweep(replicated_batches(gp, 2), dedup=dedup, device=device))
        counts = [(r.found, r.excluded, r.invalid, r.total, r.batches) for r in got]
        if device == "cpu":
            want = counts
        assert counts == want
    assert min(want[0][:3]) > 0


def test_epoch_sweep_copies_the_witness_from_page_locked_memory(dev):
    """Two epoch sweeps on one witness copy every byte of its upload from
    page-locked memory, staged by the first call and reused by the second,
    and count what the CPU counts; tables built through the staging equal,
    byte for byte, tables built from a pageable copy of the same witness; a
    witness whose arrays are page-locked already is copied as it is."""
    w = sweep_world(48)
    gp = pack_proofs(w.entries(range(48)) + _entries()[12:], max_nodes=8, node_len=576)
    arrays = _upload_arrays(gp)
    upload = sum(a.size * np.dtype(dt).itemsize for a, (_, dt) in zip(arrays, _UPLOAD))
    assert not any(torch.from_numpy(a).is_pinned() for a in arrays)
    staged = None
    for salt in (5, 0x81):
        cpu = sweep_resident_epochs(gp, 2, 16, salt=salt, device="cpu")
        got = sweep_resident_epochs(gp, 2, 16, salt=salt, device=dev, forbid_sync=True)
        assert cpu.pinned_upload_bytes == 0 and got.pinned_upload_bytes == upload
        assert ((got.found, got.excluded, got.invalid, got.total, got.batches)
                == (cpu.found, cpu.excluded, cpu.invalid, cpu.total, cpu.batches))
        staged = staged or gp._upload_staging
        assert gp._upload_staging is staged
    assert all(h.is_pinned() for h in staged.tensors.values())
    assert min(cpu.found, cpu.excluded, cpu.invalid) > 0
    t = epoch_tables(gp, dev)
    assert t["pinned_bytes"] == upload and gp._upload_staging is staged
    r = {name: torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(dev)
         for a, (name, dt) in zip(arrays, _UPLOAD)}
    r["dig"] = mpt.hash_pool(r["pool"], r["plens"])
    nodes, lens, dh = _expand_tables(r)
    a, d = r["idx"].shape
    for k, want in (("nodes", nodes.view(a, d, -1)), ("lens", lens), ("dh", dh.view(a, d, 68)),
                    ("num", r["num"]), ("roots", r["roots"]), ("knib", r["knib"]),
                    ("klen", r["klen"])):
        assert t[k].dtype == want.dtype and torch.equal(t[k], want), k
    host = {name: h.numpy() for name, h in staged.tensors.items()}
    locked = dataclasses.replace(gp, pool_nodes=host["pool"], pool_lens=host["plens"],
                                 pool_idx=host["idx"], num_nodes=host["num"],
                                 roots=host["roots"], key_nibbles=host["knib"],
                                 key_lens=host["klen"])
    r2 = _upload(locked, dev)
    assert r2["pinned_bytes"] == upload and not hasattr(locked, "_upload_staging")
    assert torch.equal(r2["dig"], r["dig"]) and torch.equal(r2["idx"], r["idx"])


def test_service_stages_each_request_in_page_locked_memory(dev):
    """The service's pool-first route on the card: a batch's block is
    page-locked; requests with different pools queued back to back, with
    no sync between them and each block freed once its copy is queued,
    each equal the route that packs the dense table and copies it (so no
    block is rewritten under a copy in flight), and so do requests served
    one by one."""
    entries, _ = account_entries(96)
    svc = BatchVerifier(BucketConfig.account(), batch_size=64, device=dev)
    svc.warmup(entries[:64])
    assert svc.pack(entries[:64]).block.is_pinned()
    requests = [entries[:64], entries[32:96], entries[64:90], entries[5:17]]
    queued = [svc._verify_pool_first(svc.pack(req)) for req in requests]
    for req, out in zip(requests, queued):
        dense = pack_proofs(svc._padded(req), 12, 576, 64)
        dense.pool(min_rows=svc.pool_rows)
        want = svc._verify_packed(dense)
        for g, w in zip(out, want):
            assert torch.equal(g, w)
        res = svc.verify(req)
        for g, w in zip((res.status, res.values, res.value_lens), want):
            np.testing.assert_array_equal(g, w[:len(req)].cpu().numpy())
    assert svc.stats.staged_batches == svc.stats.walked_batches == len(requests)


# The walk kernel's three ways of holding node rows (csrc/mpt_walk.cu):
# the whole slab in shared memory (576, 573 and 2092 B rows: 16-, 1- and
# 4-byte aligned), one row at a time (8 x 4000 B exceeds a proof's budget,
# 24 KB in the hinted modes and 6 KB in `exact` and `bounded`, where
# 8 x 2092 B does too), and rows read from device memory (one 30000 B row
# exceeds either).
NODE_LENS = (576, 573, 2092, 4000, 30000)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_kernel_matches_plain_on_fuzzed_batch(dev, seed):
    """Random byte flips in node bytes and lengths (walked against the
    digests of the unflipped nodes, so the flips are decoded), and random
    hint bytes: the kernel's six words and values equal the plain walk's
    in every mode, at every node width of
    NODE_LENS, with value rows of 128 bytes, of 37 (not a multiple of 16,
    so rows start unaligned) and of 5000 (past the node buffer)."""
    rng = np.random.default_rng(seed)
    for node_len in NODE_LENS:
        packed = pack_proofs(_entries(), max_nodes=8, node_len=node_len)
        t = packed_to_tensors(packed, dev, pool=False)
        dig = mpt.hash_nodes(t["nodes"], t["node_lens"])  # of the unflipped nodes
        bb, d, n = packed.nodes.shape
        for i in range(bb):
            for j in range(int(packed.num_nodes[i])):
                ln = int(packed.node_lens[i, j])
                for pos in rng.integers(0, ln, rng.integers(0, 3)):
                    packed.nodes[i, j, pos] = rng.integers(0, 256)
                if rng.random() < 0.1:  # lengths past the buffer too
                    packed.node_lens[i, j] = rng.integers(0, n + 64)
        t = packed_to_tensors(packed, dev, pool=False)
        b = [t[k] for k in BATCH_FIELDS]
        hints = host_item_offsets(packed.nodes.reshape(bb * d, n)).reshape(bb, d, 36)
        flip = rng.random(hints.shape) < 0.02
        hints = np.where(flip, rng.integers(0, 256, hints.shape, dtype=np.uint8), hints)
        hints = torch.from_numpy(hints).to(dev)
        for mvl in (128, 37, 5000):
            args = (b[0], b[1], b[2], dig, b[3], b[4], b[5], mvl, d + 6)
            for mode in mpt.WALK_MODES:
                got = mpt_cuda.walk_lanes(mode, *args, hints=hints)
                torch.cuda.synchronize()
                want = mpt.walk_kernel_plain(mode, *args, hints=hints)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (mode, node_len, mvl)


def test_hinted_variants_match_plain(dev):
    """Every hinted mode (`hinted` and its variants `hinted4`, `hinted1`,
    `ordered`, `pairskip`) on the batch with an unordered proof and a
    long-form item in branch slot 2, at every node width of NODE_LENS
    (a node axis that is a multiple of 4 and ones that are not, so
    `hinted1`'s aligned word reads meet rows of every width), whole, as a
    row slice and as a depth segment's view (rows and node axis cut,
    strides kept): kernel == plain, and the flags of `hinted4` and
    `ordered` differ from `hinted`'s where they should."""
    entries = _entries()
    long_slot = rlp.encode([b"", b"", b"\x5a" * 60] + [b""] * 14)
    root0, proof0, key0 = entries[0]
    entries += [(root0, proof0[::-1], key0),
                (keccak256(long_slot), [long_slot], b"\x20" + b"\x00" * 31)]
    for node_len in NODE_LENS:
        _check_hinted_variants(dev, pack_proofs(entries, max_nodes=8, node_len=node_len))


def _check_hinted_variants(dev, packed):
    t = packed_to_tensors(packed, dev, pool=False)
    b = [t[k] for k in BATCH_FIELDS]
    dig = mpt.hash_nodes(b[0], b[1])
    bb, d, n = packed.nodes.shape
    hints = torch.from_numpy(host_item_offsets(packed.nodes.reshape(bb * d, n))
                             .reshape(bb, d, 36)).to(dev)
    for sl, dd in ((slice(0, bb), d), (slice(1, bb), d), (slice(1, bb), d - 2)):
        args = (b[0][sl, :dd], b[1][sl, :dd], b[2][sl], dig[sl, :dd], b[3][sl],
                b[4][sl], b[5][sl], 128, d + 6)
        flags = {}
        for mode in mpt.HINT_MODES:
            got = mpt_cuda.walk_lanes(mode, *args, hints=hints[sl, :dd])
            torch.cuda.synchronize()
            want = mpt.walk_kernel_plain(mode, *args, hints=hints[sl, :dd])
            for g, w in zip(got, want):
                assert torch.equal(g, w), (mode, n, dd)
            flags[mode] = got[0][:, 4].cpu()
        if dd < d:
            continue  # the cut proofs: the flags below are the whole slab's
        assert flags["hinted"][-1] == 1 and flags["hinted4"][-1] == 0
        assert flags["ordered"][-2] == 1 and flags["hinted"][-2] == 0
        for mode in ("hinted1", "pairskip"):
            assert torch.equal(flags[mode], flags["hinted"])


def test_keccak_raw_kernel_matches_plain_and_k1(dev):
    """K3 on the edge lengths, at a width that is a multiple of 8 (576) and
    at one that is not (573), and on rows of two to sixteen blocks (2092 B,
    lengths past the width too): equal to its plain version, to K1 and to
    the oracle."""
    edge = [0, 1, 3, 4, 7, 8, 135, 136, 137, 271, 272, 535, 536, 573]
    long = [272, 273, 543, 544, 1000, 1500, 2091, 2092, 2176]
    rng = np.random.default_rng(7)
    for width, lengths in ((576, edge), (573, edge), (2092, long)):
        data = rng.integers(0, 256, (len(lengths), width), dtype=np.uint8)
        rows = torch.from_numpy(data).to(dev)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        before = keccak_cuda.LAUNCHES["keccak256_raw"]
        got = keccak_cuda.keccak256_cuda_raw(rows, lens)
        torch.cuda.synchronize()
        assert keccak_cuda.LAUNCHES["keccak256_raw"] == before + 1
        assert torch.equal(got, tkeccak.keccak256_raw(rows, lens))
        assert torch.equal(got, keccak_cuda.keccak256_cuda(rows, lens))
        assert keccak_cuda.LAUNCHES["keccak256_raw"] == before + 1
        for i, n in enumerate(lengths):
            if n <= width:
                assert bytes(got[i].cpu().numpy()) == keccak256(bytes(data[i, :n]))


def test_storage_pooled_at_published_widths_matches_the_plain_reference(dev):
    """One batch of the benchmark's erc20_storage cell: 4096 holder slots
    of a 2^24-slot storage trie (7-9-node proofs in 576-byte rows, an
    11-node bucket, 64-byte values, inline leaves where the trie has them,
    one tampered leaf) under the token's mainnet-depth account proof,
    through K1, K2 `hinted` and `bounded` (with the guarded `exact`) and
    K5, against the plain reference walked on the card."""
    w = make_storage_world(2**40 + 7, holders=4096, virtual_slots=1 << 24, max_nodes=11,
                           virtual_accounts=1 << 28, account_max_nodes=12, node_len=576,
                           position=2, tampered=1, device=dev).to("cpu")
    ap = pack_proofs(Batches(w.account, 1, 1).entries([0]), max_nodes=12, node_len=576)
    sp = pack_proofs(Batches(w.slots, 4096, 1).entries(range(4096)), max_nodes=11,
                     node_len=576)
    at, st = packed_to_tensors(ap, dev), packed_to_tensors(sp, dev, hints=False)
    a_status, acct, s_status, s_values, s_vlens = verify_storage_pooled(
        [at[k] for k in BATCH_FIELDS], [at[k] for k in POOL_FIELDS], at["pool_hints"],
        st["nodes"], st["node_lens"], st["num_nodes"], [st[k] for k in POOL_FIELDS],
        w.raw_slots.to(dev), torch.zeros(4096, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()

    def table(pop):
        pn = pop.proof_nodes.to(dev)
        ids = pn.clamp(min=0)
        return (pop.nodes.to(dev)[ids], torch.where(pn >= 0, pop.node_lens.to(dev)[ids], 0),
                pop.proof_lens.to(dev))

    a = w.account
    want_a, want_acct = plain.verify_accounts(*table(a), a.root.to(dev).expand(1, 32),
                                              a.keys.to(dev))
    assert want_a.tolist() == [mpt.FOUND] and want_acct["ok"].tolist() == [True]
    assert a_status.tolist() == [mpt.FOUND] and acct["ok"].tolist() == [True]
    for f in ("nonce", "balance", "storage_root", "code_hash"):
        assert torch.equal(acct[f], want_acct[f]), f
    ws, wv, wl = plain.verify_slots(*table(w.slots), want_acct["storage_root"].expand(4096, 32),
                                    w.raw_slots.to(dev))
    assert int((ws == mpt.INVALID).sum()) == 1 and int((ws == mpt.FOUND).sum()) == 4095
    assert torch.equal(s_status.long(), ws) and torch.equal(s_vlens.long(), wl)
    mask = torch.arange(64, device=dev)[None, :] < wl[:, None]
    assert torch.equal(torch.where(mask, s_values, 0), wv)
