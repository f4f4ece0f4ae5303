"""The port's pooled verification slice end to end vs the JAX package:
verify_proofs_pooled (hints, depth segments, pool segments; config 4's
mixed batch without hints or segments), the
diagnostic reasons, the model entry points and BatchVerifier. Bit-exact."""

import importlib.util
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zk_state_proofs_tpu import native as jax_native
from zk_state_proofs_tpu.models import BatchVerifier as JaxBatchVerifier
from zk_state_proofs_tpu.oracle import EthTrie, keccak256, rlp
from zk_state_proofs_tpu.ops import mpt as jmpt
from zk_state_proofs_tpu.utils.config import BucketConfig as JaxBucketConfig
from zk_state_proofs_tpu.witness import pack_proofs
from zk_state_proofs_tpu.witness import synthetic_block as jax_synthetic_block
from zk_state_proofs_tpu.witness.builders import (
    get_transaction_proof_input as jax_get_transaction_proof_input)
from zk_state_proofs_tpu_torch.bench import headline
from zk_state_proofs_tpu_torch.bench.common import HashStep, Step, pooled_call, value_word
from zk_state_proofs_tpu_torch.models import (BatchVerifier, batch_commitment,
                                              diagnose_batch,
                                              verify_account_batch,
                                              verify_merkle_batch,
                                              verify_merkle_proof,
                                              verify_storage_batch,
                                              verify_storage_grouped)
from zk_state_proofs_tpu_torch.oracle import MissingKeyError, TrieError
from zk_state_proofs_tpu_torch.ops import keccak_cuda
from zk_state_proofs_tpu_torch.ops import mpt as tmpt
from zk_state_proofs_tpu_torch.utils.config import BucketConfig
from zk_state_proofs_tpu_torch import native as port_native
from zk_state_proofs_tpu_torch.models.service import _PoolFirstProofs
from zk_state_proofs_tpu_torch.witness.pack import PackingError
from zk_state_proofs_tpu_torch.witness.pack import pack_proofs as port_pack_proofs
from zk_state_proofs_tpu_torch.witness_bridge import (BATCH_FIELDS, POOL_FIELDS,
                                                      account_entries, mixed_batch,
                                                      packed_to_tensors,
                                                      storage_world)

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's thread pools from oversubscribing its cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def headline_256():
    """256 distinct account proofs over a 256-account trie (bench recipe)."""
    return pack_proofs(account_entries(256)[0], node_len=576)


def test_pooled_verify_matches_jax(headline_256):
    packed = headline_256
    segs = packed.depth_segments(tile=64)
    psegs = packed.pool_block_segments(tile=64)
    assert len(segs) >= 2 and len(psegs) >= 2
    want = jmpt.verify_proofs_pooled(
        *packed.astuple(), *packed.pool(), packed.pool_hints(),
        max_value_len=128, depth_segments=segs, pool_segments=psegs)
    t = packed_to_tensors(packed, "cpu")
    batch = [t[k] for k in BATCH_FIELDS]
    pool = [t[k] for k in POOL_FIELDS]
    for kw in (dict(depth_segments=segs, pool_segments=psegs), {},
               dict(hinted=False)):
        got = tmpt.verify_proofs_pooled(*batch, *pool, t["pool_hints"], **kw)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(want[0]) == tmpt.FOUND).all()
    # BASELINE config 4's mixed batch (accounts, storage slots,
    # transactions), pooled with no pack-time hints and no segment
    # schedules: the device hint pass, as bench_configs.py calls it
    entries, mixed = mixed_batch(total=512)
    assert entries == _jax_config4_entries(512)
    assert mixed.batch == 512 and mixed.nodes.shape[2] == max(
        len(n) for _, p, _ in entries for n in p) + 4
    want = jmpt.verify_proofs_pooled(*mixed.astuple(), *mixed.pool(), max_value_len=128)
    t = packed_to_tensors(mixed, "cpu", hints=False)
    got = tmpt.verify_proofs_pooled(*[t[k] for k in BATCH_FIELDS + POOL_FIELDS],
                                    max_value_len=128)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(want[0]) == tmpt.FOUND).all()
    # the headline benchmark (bench.headline): its witness recipe gives
    # bench.py's arrays, distinct and hot trie
    jax_bench = _root_bench()
    for n_accounts in (64, 16):
        want, got = jax_bench.build_witness_batch(64, n_accounts), headline.build_witness_batch(
            64, n_accounts)
        for w, g in zip(want.astuple() + want.pool() + (want.pool_hints(),),
                        got.astuple() + got.pool() + (got.pool_hints(),)):
            np.testing.assert_array_equal(g, w)
    # its timed step on the CPU from a fixed counter start: each call's
    # status, values and lengths equal the JAX function's on the same
    # perturbed arrays, and K = 2 steps, then one more, fold the same
    # (acc, accv) as the additive fold over the JAX outputs
    segs, psegs = got.depth_segments(tile=16), got.pool_block_segments(tile=16)
    d = got.nodes.shape[1]
    call = pooled_call(packed_to_tensors(got, "cpu"), max_value_len=128, max_steps=d,
                       depth_segments=segs, pool_segments=psegs)
    step = Step(call, 64, "cpu", ctr=7)
    nodes, (pool_nodes, *pool) = got.nodes.copy(), got.pool()
    pool_nodes, hints = pool_nodes.copy(), got.pool_hints()
    acc, accv = np.zeros(64, np.int64), np.zeros(64, np.int64)
    for ctr, k in ((8, 0), (9, 2), (10, 1)):
        nodes[..., -1] = pool_nodes[..., -1] = ctr
        s, v, ln = (np.asarray(x) for x in jmpt.verify_proofs_pooled(
            nodes, *got.astuple()[1:], pool_nodes, *pool, hints, max_value_len=128,
            max_steps=d, conditional=False, depth_segments=segs, pool_segments=psegs))
        for g, w in zip(call(ctr), (s, v, ln)):
            np.testing.assert_array_equal(g.numpy(), w)
        acc += s
        accv += v.sum(1, dtype=np.int64) + (ln.astype(np.int64) << 8)
        if k:
            step.run(k)
            np.testing.assert_array_equal(step.fold.acc.numpy(), acc)
            np.testing.assert_array_equal(step.fold.accv.numpy(), accv)
    assert step.ctr == 10 and (acc == 3 * tmpt.FOUND).all()
    once = value_word(torch.tensor(v), torch.tensor(ln))
    step.fold.check(once, "the CPU step")
    step.fold.accv[0] += 1  # one value byte off in one call
    with pytest.raises(RuntimeError):
        step.fold.check(once, "a changed value")
    # the K1 step: call k writes k into the last byte of every row; the
    # digests it keeps are the oracle's of those rows, and check() refuses
    # digests of other rows
    rows = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (6, 140), np.uint8))
    lens = torch.full((6,), 140, dtype=torch.int32)
    hs = HashStep(lambda r: keccak_cuda.keccak256_cuda(r, lens), rows, lens, -1)
    hs(), hs()
    for k, dig in enumerate(hs.kept, 1):
        want = rows.numpy().copy()
        want[:, -1] = k
        assert [bytes(x) for x in dig.numpy()] == [keccak256(bytes(r)) for r in want]
    hs.check("K1 on the CPU")
    hs = HashStep(lambda r: keccak_cuda.keccak256_cuda(r.flip(0), lens), rows, lens, -1)
    hs()
    with pytest.raises(RuntimeError):
        hs.check("K1 over the wrong rows")


def _root_bench():
    """The JAX package's root bench.py as a module. Its import sets two JAX
    compile-cache variables, which are taken back out of the environment."""
    before = set(os.environ)
    spec = importlib.util.spec_from_file_location(
        "root_bench", Path(__file__).resolve().parents[1] / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for key in set(os.environ) - before:
            del os.environ[key]
    return mod


def _jax_config4_entries(total):
    """bench_configs.py config4_mixed_batch's entries, built with the JAX
    package's oracle and builders (its native keccak in the two tries:
    the same digests as the oracle's, faster)."""
    nk = jax_native.keccak256
    third = total // 3
    t = EthTrie(hasher=nk)
    for i in range(256):
        t.insert(nk(b"a%d" % i), rlp.encode([b"\x01", b"\x02", nk(b"s"), nk(b"c")]))
    root = t.root_hash()
    entries = []
    for i in range(third):
        k = nk(b"a%d" % (i % 256))
        entries.append((root, t.get_proof(k), k))
    st = EthTrie(hasher=nk)
    for i in range(256):
        st.insert(nk(nk(b"slot%d" % i)), rlp.encode_int(i + 1))
    sroot = st.root_hash()
    for i in range(third):
        k = nk(nk(b"slot%d" % (i % 256)))
        entries.append((sroot, st.get_proof(k), k))
    fx = jax_synthetic_block(num_txs=32, seed=4)
    tx_inputs = [jax_get_transaction_proof_input(fx["block"], i) for i in range(32)]
    while len(entries) < total:
        entries.append(tx_inputs[len(entries) % 32].as_entry())
    return entries


def _adversarial_packed():
    t = EthTrie()
    keys = [keccak256(b"diag-%d" % i) for i in range(32)]
    for i, k in enumerate(keys):
        t.insert(k, b"\x05" + bytes([i]) * 40)
    root = t.root_hash()
    entries = [(root, t.get_proof(keys[0]), keys[0])]
    absent = keccak256(b"nope")
    entries.append((root, t.get_proof(absent), absent))
    entries.append((b"\x13" * 32, t.get_proof(keys[1]), keys[1]))
    entries.append((root, t.get_proof(keys[2])[:1], keys[2]))
    crafted = rlp.encode([b"\x01"])
    entries.append((keccak256(crafted), [crafted], keys[3]))
    branch = [b""] * 17
    branch[keys[4][0] >> 4] = b"\x07" * 31
    crafted2 = rlp.encode(branch)
    entries.append((keccak256(crafted2), [crafted2], keys[4]))
    return pack_proofs(entries), (t, root, keys)


def test_diagnose_reasons_match_jax():
    packed, _ = _adversarial_packed()
    want = jmpt.verify_proofs_diagnose(*(jnp.asarray(a) for a in packed.astuple()))
    res = diagnose_batch(packed, device="cpu")
    for w, g in zip(want, (res.status, res.values, res.value_lens, res.reasons)):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert list(res.reasons) == [tmpt.R_NONE, tmpt.R_NONE, tmpt.R_ROOT_MISSING,
                                 tmpt.R_HASH_MISMATCH, tmpt.R_MALFORMED,
                                 tmpt.R_BAD_CHILD_REF]
    counts = res.counts()
    assert counts["invalid_root-missing"] == 1
    assert counts["invalid_bad-child-ref"] == 1
    # verify_proofs (unpooled) agrees with the pooled path
    pooled = verify_merkle_batch(packed, device="cpu")
    unpooled = verify_merkle_batch(packed, dedup=False, device="cpu")
    np.testing.assert_array_equal(pooled.status, res.status)
    np.testing.assert_array_equal(unpooled.values, pooled.values)
    assert batch_commitment(pooled) == batch_commitment(unpooled)


def test_verify_merkle_proof_raise_semantics():
    _, (t, root, keys) = _adversarial_packed()
    assert verify_merkle_proof(root, t.get_proof(keys[7]), keys[7], device="cpu") == (
        b"\x05" + bytes([7]) * 40)
    absent = keccak256(b"absent-key")
    with pytest.raises(MissingKeyError):
        verify_merkle_proof(root, t.get_proof(absent), absent, device="cpu")
    with pytest.raises(TrieError) as exc:
        verify_merkle_proof(root, t.get_proof(keys[1]), keys[2], device="cpu")
    assert not isinstance(exc.value, MissingKeyError)


def test_verify_account_batch_decodes_leaves():
    entries, leaves = account_entries(64)
    packed = pack_proofs(entries[:8], node_len=576)
    res, acct = verify_account_batch(packed, device="cpu")
    assert res.all_found and acct["ok"].all()
    for i, (_, _, key) in enumerate(entries[:8]):
        assert res.value(i) == leaves[key]
        leaf = rlp.decode(res.value(i))
        assert bytes(acct["storage_root"][i]) == leaf[2]
        assert bytes(acct["code_hash"][i]) == leaf[3]
        assert int.from_bytes(bytes(acct["nonce"][i]), "big") == int.from_bytes(leaf[0], "big")
        assert int.from_bytes(bytes(acct["balance"][i]), "big") == int.from_bytes(leaf[1], "big")


def _packed_dense(svc, req):
    """req packed as the service's dense route packs it: the port's
    pack_proofs on the padded batch, its pool padded to the pinned rows."""
    bk = svc.bucket
    packed = port_pack_proofs(svc._padded(req), bk.max_nodes, bk.node_len, bk.key_nibbles)
    packed.pool(min_rows=svc.pool_rows)
    return packed


def _hold_pool_first(got, want):
    """A batch the service packed pool first, with no dense table built,
    against the dense packer on the same padded batch, byte for byte: the
    per-proof arrays (the dense table gathered from the pool on read), the
    pool and its hints."""
    assert isinstance(got, _PoolFirstProofs) and "nodes" not in vars(got)
    for k, g, w in zip(BATCH_FIELDS + POOL_FIELDS + ("pool_hints",),
                       got.astuple() + got.pool() + (got.pool_hints(),),
                       want.astuple() + want.pool() + (want.pool_hints(),)):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _hold_walk(svc, req):
    """The native walk of req's padded entries into the service's staging
    against encode_entries, byte for byte."""
    padded = svc._padded(req)
    got = port_native.walk_entries(padded, svc._staging)
    want = port_native.encode_entries(padded)
    assert got is not None
    for g, w in zip(got, want):
        w = np.frombuffer(w, dtype=np.uint8) if isinstance(w, bytes) else w
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _passed(svc, req, staging=None) -> _PoolFirstProofs:
    """req's padded entries walked into `staging` (encode_entries without
    one, or where the walk cannot read them), then the native pass into
    a block of its own."""
    layout, nbytes = svc._pool_first
    packed = _PoolFirstProofs(torch.empty(nbytes, dtype=torch.uint8), layout)
    bk = svc.bucket
    padded = svc._padded(req)
    encoded = port_native.walk_entries(padded, staging) if staging is not None else None
    if encoded is None:
        encoded = port_native.encode_entries(padded)
    port_native.pack_pool_native(encoded, bk.max_nodes, bk.node_len, bk.key_nibbles,
                                 packed.arrays)
    return packed


def test_batch_verifier_matches_jax_service():
    entries, _ = account_entries(96)
    proto = BatchVerifier(BucketConfig.account(), batch_size=64, device="cpu")
    proto.warmup(entries[:64])  # derives the pinned pool bucket
    sorted_batch = proto.pack(sorted(entries[:64], key=lambda e: -len(e[1])))
    segs = sorted_batch.depth_segments(tile=16)
    psegs = sorted_batch.pool_block_segments(tile=16)
    kw = dict(batch_size=64, pool_rows=proto.pool_rows, depth_segments=segs,
              pool_segments=psegs)
    jsvc = JaxBatchVerifier(JaxBucketConfig.account(), **kw)
    tsvc = BatchVerifier(BucketConfig.account(), device="cpu", **kw)
    # skip the JAX warmup's extra compiles; the port warms every route
    jsvc._warm = True
    tsvc.warmup(entries[:64])
    bad = [bytearray(x) for x in entries[70][1]]
    bad[-1][9] ^= 0x40
    absent = keccak256(b"svc-absent")
    requests = [
        entries[:64],                                   # full batch
        entries[64:90],                                 # partial: padding rows
        [(entries[70][0], [bytes(x) for x in bad], entries[70][2]),
         (b"\x31" * 32,) + entries[71][1:],
         (entries[0][0], entries[5][1], absent)] + entries[80:84],  # adversarial
    ]
    served = []
    for req in requests:
        want, got = jsvc.verify(req), tsvc.verify(req)
        np.testing.assert_array_equal(got.status, want.status)
        np.testing.assert_array_equal(got.values, want.values)
        np.testing.assert_array_equal(got.value_lens, want.value_lens)
        served.append(got)
    assert (got.status[:3] == tmpt.INVALID).all()
    assert tsvc.stats.batches == 3 and tsvc.stats.proofs == 64 + 26 + 7
    assert tsvc.stats.found == jsvc.stats.found
    # every request took the pool-first route, encoded by the native walk
    assert tsvc.stats.staged_batches == tsvc.stats.walked_batches == 3
    # its pass equals the dense packer on each request and on a trie whose nodes
    # hold inline (< 32 B) children, and raises the packer's errors: a
    # 13-node proof, a 577-byte node, a pool past the pinned rows
    t = EthTrie()
    keys = [keccak256(b"svc-inline-%d" % i)[:6] for i in range(48)]
    for i, k in enumerate(keys):
        t.insert(k, rlp.int_to_min_bytes(i + 1))
    inline = [(t.root_hash(), t.get_proof(k), k) for k in keys[:16]]
    for req in requests + [inline]:
        _hold_pool_first(tsvc.pack(req), _packed_dense(tsvc, req))
        _hold_walk(tsvc, req)
    rng = np.random.default_rng(5)
    root, key = entries[0][0], entries[0][2]
    for req in ([(root, [b"\x80"] * 13, key)], [(root, [b"\x01" * 577], key)],
                [(root, [rng.bytes(100) for _ in range(12)], key)] * 4 + [
                    (root, [rng.bytes(100) for _ in range(12)], e[2]) for e in entries[:60]]):
        with pytest.raises(PackingError) as want:
            _packed_dense(tsvc, req)
        with pytest.raises(PackingError) as got:
            tsvc.pack(req)
        assert str(got.value) == str(want.value)
    assert str(got.value).startswith("node pool needs")
    # the staging serves on after the refused batches
    again = tsvc.verify(requests[1])
    np.testing.assert_array_equal(again.values, served[1].values)
    np.testing.assert_array_equal(again.status, served[1].status)
    # callers on several threads take turns at the staging
    with ThreadPoolExecutor(3) as workers:
        for res, want in zip(workers.map(tsvc.verify, requests * 2), served * 2):
            np.testing.assert_array_equal(res.values, want.values)
            np.testing.assert_array_equal(res.status, want.status)
    # a one-rank mesh (no process group) serves the same results
    from zk_state_proofs_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device="cpu")
    msvc = BatchVerifier(BucketConfig.account(), mesh=mesh, device="cpu", **kw)
    for req in requests[1:]:
        want, got = tsvc.verify(req), msvc.verify(req)
        for f in ("status", "values", "value_lens"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    # neither the mesh nor a service without dedup packs pool first
    plain = BatchVerifier(BucketConfig.account(), batch_size=64, dedup=False, device="cpu")
    got = plain.verify(requests[2])
    np.testing.assert_array_equal(got.values, served[2].values)
    assert msvc.stats.staged_batches == plain.stats.staged_batches == 0
    assert msvc._pool_first is None and plain._pool_first is None


@pytest.fixture(scope="module")
def walk_service():
    """A warm CPU service (pool first, the native walk) and a 26-proof
    request of bytes in tuples and lists, padded to its 64 rows."""
    entries, _ = account_entries(96)
    svc = BatchVerifier(BucketConfig.account(), batch_size=64, device="cpu")
    svc.warmup(entries[:64])
    assert svc._staging is not None
    return svc, entries[64:90]


class _Bytes(bytes):
    pass


# each form of a request's objects: the walk reads lists and tuples of
# exactly-bytes objects in place; anything else is encoded by encode_entries
_FORMS = {
    "bytes": (True, lambda req: req),
    "tuple_proofs": (True, lambda req: [(r, tuple(p), k) for r, p, k in req]),
    "list_entries": (True, lambda req: [[r, p, k] for r, p, k in req]),
    "bytearray_node": (False, lambda req: req[:3] + [
        (req[3][0], req[3][1][:-1] + [bytearray(req[3][1][-1])], req[3][2])] + req[4:]),
    "memoryview_node": (False, lambda req: req[:-1] + [
        (req[-1][0], [memoryview(n) for n in req[-1][1]], req[-1][2])]),
    "bytes_subclass_root": (False, lambda req: [(_Bytes(req[0][0]),) + req[0][1:]] + req[1:]),
    "no_walk": (False, lambda req: req),
}


@pytest.mark.parametrize("form", list(_FORMS))
def test_service_walk_reads_bytes_in_place_else_encodes(walk_service, form, monkeypatch):
    """Each form of a request packs to the arrays of encode_entries and
    the native pass (and of the dense packer), and verifies to the same
    answers; walked_batches counts the requests the walk encoded."""
    svc, req = walk_service
    walks, make = _FORMS[form]
    if form == "no_walk":  # as where Python.h or g++ is missing
        monkeypatch.setattr(port_native, "_walk", False)
        svc = BatchVerifier(BucketConfig.account(), batch_size=64, pool_rows=svc.pool_rows,
                            device="cpu")
        svc.warmup(req)
        assert svc._staging is None and svc._pool_first is not None
    want = svc.verify(req)
    got_req = make(req)
    packed = svc.pack(got_req)
    assert packed.walked is walks
    _hold_pool_first(packed, _passed(svc, got_req))
    _hold_pool_first(svc.pack(got_req), _packed_dense(svc, req))
    before = svc.stats.walked_batches, svc.stats.staged_batches
    got = svc.verify(got_req)
    assert svc.stats.walked_batches == before[0] + walks
    assert svc.stats.staged_batches == before[1] + 1
    for f in ("status", "values", "value_lens"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_service_walk_staging_takes_turns_under_threads(walk_service):
    """More threads than cores pack distinct requests through one
    service's staging at once, the interpreter switching threads every
    microsecond: each packs its own request's arrays."""
    svc, req = walk_service
    reqs = [req[i:] for i in range(16)]
    want = [_passed(svc, r) for r in reqs]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(24) as workers:
            futures = [workers.submit(svc.pack, r) for r in reqs * 4]
            got = [f.result(timeout=120) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    for g, w in zip(got, want * 4):
        assert g.walked
        _hold_pool_first(g, w)


def _refused(req, rng):
    """Ten entries of req with entry 5 (and entry 8) past the bucket, in
    the ways each error case names."""
    root, key = req[0][0], req[0][2]
    deep = (root, [b"\x80"] * 13, key)
    wide = (root, [b"\x01" * 577], key)
    cases = {
        "root31": req[:5] + [(root[:31],) + req[5][1:]] + req[6:10],
        "nodes13": req[:5] + [deep] + req[6:8] + [wide] + req[9:10],
        "node577": req[:5] + [wide] + req[6:8] + [deep] + req[9:10],
        "key_past_nibbles": req[:5] + [(root, req[5][1], key + b"\x01")] + req[6:10],
        # a root error wins over an earlier proof past the bucket, as in
        # encode_entries and the pass; an unreadable entry after it falls back
        "break_then_root31": req[:5] + [deep] + req[6:8] + [(root[:31],) + req[8][1:]],
        "break_then_bytearray": req[:5] + [deep] + req[6:8] + [
            (root, [bytearray(n) for n in req[8][1]], key)],
        "pool_past_rows": [(root, [rng.bytes(100) for _ in range(12)], key)] * 4 + [
            (root, [rng.bytes(100) for _ in range(12)], e[2]) for e in (req * 3)[:60]],
    }
    return cases


@pytest.mark.parametrize("case", ["root31", "nodes13", "node577", "key_past_nibbles",
                                  "break_then_root31", "break_then_bytearray",
                                  "pool_past_rows"])
def test_service_walk_refuses_as_the_packers_do(walk_service, case):
    """A request past the bucket, or with a root not 32 bytes long, raises
    the PackingError of encode_entries and the native pass (and the dense
    packer's, where it checks), naming the same first proof, and the walk
    writes nothing past its staging."""
    svc, req = walk_service
    bad = _refused(req, np.random.default_rng(5))[case]
    staging = port_native.EntryStaging(*svc._staging.bucket)
    fences = {}
    for name, a in staging.arrays.items():
        fence = np.full(a.nbytes + 4096, 0xA5, dtype=np.uint8)
        staging.arrays[name] = fence[:a.nbytes].view(a.dtype)
        fences[name] = (fence, a.nbytes)
    with pytest.raises(PackingError) as want:
        _passed(svc, bad)
    if case not in ("root31", "break_then_root31"):  # the dense packer reads no root
        with pytest.raises(PackingError) as dense:
            _packed_dense(svc, bad)
        assert str(dense.value) == str(want.value)
    else:
        assert str(want.value) == "root must be 32 bytes"
    if case == "break_then_bytearray":  # encode_entries raises for it
        assert port_native.walk_entries(svc._padded(bad), staging) is None
    before = svc.stats.walked_batches, svc.stats.staged_batches
    with pytest.raises(PackingError) as got:
        _passed(svc, bad, staging)
    assert str(got.value) == str(want.value)
    with pytest.raises(PackingError) as served:
        svc.verify(bad)
    assert str(served.value) == str(want.value)
    assert (svc.stats.walked_batches, svc.stats.staged_batches) == before
    for name, (fence, n) in fences.items():
        assert (fence[n:] == 0xA5).all(), name


def test_packed_to_tensors_roundtrip(headline_256):
    packed = headline_256
    t = packed_to_tensors(packed, "cpu")
    arrays = dict(zip(BATCH_FIELDS, packed.astuple()))
    arrays.update(zip(POOL_FIELDS, packed.pool()))
    arrays["pool_hints"] = packed.pool_hints()
    for name, a in arrays.items():
        assert t[name].numpy().dtype == a.dtype, name
        np.testing.assert_array_equal(t[name].numpy(), a)
    assert t["nodes"].dtype == torch.uint8 and t["pool_idx"].dtype == torch.int32


def test_import_loads_neither_jax_nor_cuda():
    """Importing the port, and running the storage and block paths, a
    sweep and a circuit on the CPU, loads no JAX, no module of the JAX
    package and no CUDA."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import zk_state_proofs_tpu_torch\n"
        "import zk_state_proofs_tpu_torch.ops.mpt, zk_state_proofs_tpu_torch.ops.mpt_cuda\n"
        "import zk_state_proofs_tpu_torch.ops.keccak_cuda\n"
        "import zk_state_proofs_tpu_torch.models, zk_state_proofs_tpu_torch.witness_bridge\n"
        "import zk_state_proofs_tpu_torch.parallel, zk_state_proofs_tpu_torch.__main__\n"
        "import zk_state_proofs_tpu_torch.entry, zk_state_proofs_tpu_torch.witness.networks\n"
        "import zk_state_proofs_tpu_torch.bench.common, zk_state_proofs_tpu_torch.bench.headline\n"
        "import zk_state_proofs_tpu_torch.bench.configs, zk_state_proofs_tpu_torch.bench.scaling\n"
        "import zk_state_proofs_tpu_torch.bench.ab\n"
        "import torch.distributed as dist\n"
        "assert not torch.cuda.is_initialized(), 'cuda initialised'\n"
        "assert not dist.is_initialized(), 'a process group was initialised'\n"
        "from zk_state_proofs_tpu_torch.models import verify_storage_grouped\n"
        "from zk_state_proofs_tpu_torch.witness_bridge import storage_world\n"
        "w = storage_world(n_accounts=3, slots_per=2, slots_in_trie=8)\n"
        "res = verify_storage_grouped(*w.pack(), w.slots, w.slot_accounts, device='cpu')\n"
        "assert (res.slot_status == 1).all() and (res.account_status == 1).all()\n"
        "assert [res.slot_value(i) for i in range(6)] == w.slot_values\n"
        "from zk_state_proofs_tpu_torch.models import verify_block_receipts\n"
        "from zk_state_proofs_tpu_torch.models import verify_block_transactions\n"
        "from zk_state_proofs_tpu_torch.witness import synthetic_block\n"
        "from zk_state_proofs_tpu_torch.witness_bridge import tx_geometry_block\n"
        "fx = synthetic_block(num_txs=6, seed=2)\n"
        "r, transfers = verify_block_receipts(fx['block'], fx['receipts'], device='cpu')\n"
        "assert r.all_found and verify_block_transactions(tx_geometry_block(3),\n"
        "                                                 device='cpu').all_found\n"
        "import numpy as np\n"
        "from zk_state_proofs_tpu_torch.models import (replicated_batches, run_merkle_circuit,\n"
        "                                              sweep, sweep_resident_epochs)\n"
        "from zk_state_proofs_tpu_torch.witness import (encode_transaction,\n"
        "                                               get_transaction_proof_input)\n"
        "from zk_state_proofs_tpu_torch.witness_bridge import sweep_world\n"
        "sw = sweep_world(24)\n"
        "res = sweep_resident_epochs(sw.pack(), epochs=1, batch=8, device='cpu')\n"
        "assert res.found == res.total == 24 and res.batches == 3\n"
        "rows = next(sw.index_batches(1, 8, np.random.default_rng(0)))\n"
        "batch = zk_state_proofs_tpu_torch.witness.pack_proofs(sw.entries(rows))\n"
        "assert sweep(replicated_batches(batch, 2), device='cpu').found == 16\n"
        "inp = get_transaction_proof_input(fx['block'], 1)\n"
        "assert run_merkle_circuit(inp.to_borsh(), device='cpu') == \\\n"
        "    encode_transaction(fx['block']['transactions'][1])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'zk_state_proofs_tpu' or m.startswith('zk_state_proofs_tpu.'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized(), 'cuda initialised'\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    packed, _ = _adversarial_packed()
    with pytest.raises(RuntimeError):
        packed_to_tensors(packed, "cuda")
    with pytest.raises(RuntimeError):
        verify_merkle_batch(packed, device="cuda")
    with pytest.raises(RuntimeError):
        BatchVerifier(BucketConfig.account(), device="cuda")
    # the card is the default: a caller who names no device gets no CPU run
    with pytest.raises(RuntimeError):
        verify_merkle_batch(packed)
    with pytest.raises(RuntimeError):
        BatchVerifier(BucketConfig.account())
    w = storage_world(n_accounts=2, slots_per=1, slots_in_trie=4)
    ap, sp = w.pack()
    with pytest.raises(RuntimeError):
        verify_storage_grouped(ap, sp, w.slots, w.slot_accounts)
    with pytest.raises(RuntimeError):
        verify_storage_batch(ap, sp, w.slots)
    # the sweep slice's entry points default to the card too
    from zk_state_proofs_tpu_torch.models import (replicated_batches, run_merkle_circuit_batch,
                                                  run_storage_circuit, sweep, sweep_entries,
                                                  sweep_resident, sweep_resident_epochs)
    from zk_state_proofs_tpu_torch.ops.trie_build import compute_root
    from zk_state_proofs_tpu_torch.witness.trie_plan import plan_index_trie
    from zk_state_proofs_tpu_torch.witness.types import MerkleProofInput, StorageProofInput

    pn, pl, pi = packed.pool()
    scalars = (packed.num_nodes, packed.roots, packed.key_nibbles, packed.key_lens)
    calls = [lambda: sweep(replicated_batches(packed, 1)),
             lambda: sweep_resident(packed, [np.arange(2)]),
             lambda: sweep_resident_epochs(packed, 1, 2),
             lambda: sweep_entries([[]], 8, 576),
             lambda: compute_root(plan_index_trie([b"\x01" * 40])),
             lambda: run_merkle_circuit_batch([MerkleProofInput([b"\x80"], b"\x00" * 32,
                                                                b"\x01")]),
             lambda: run_storage_circuit(StorageProofInput(
                 [b"\x80"], [[b"\x80"]], b"\x00" * 32, b"\x00" * 32, [b"\x01"],
                 b"\x00" * 32)),
             lambda: tmpt.verify_proofs_indexed(pn, pl, np.zeros((pn.shape[0], 32), np.uint8),
                                                pi, *scalars),
             lambda: tmpt.verify_proofs_prehashed(*packed.astuple()[:3],
                                                  np.zeros(packed.nodes.shape[:2] + (32,),
                                                           np.uint8), *scalars[1:]),
             lambda: tmpt.verify_proofs_pool_stream(pn, pl, pi, *scalars)]
    # the CLI and the mesh default to the card too
    from zk_state_proofs_tpu_torch.__main__ import main
    from zk_state_proofs_tpu_torch.parallel import make_mesh

    calls += [lambda: main(["selftest", "--txs", "2"]), lambda: make_mesh(),
              lambda: make_mesh(device="cuda")]
    # the benchmark programs: their timers (on a CPU tensor or device too)
    # and every module's main
    from zk_state_proofs_tpu_torch.bench import ab, common, configs, scaling

    for where in ("cuda", "cpu", torch.zeros(1)):
        calls += [lambda w=where, t=timer: t(lambda i: None, 1, w)
                  for timer in (common.wall_ms, common.device_ms, common.busy_profile)]
    calls += [common.card_info, lambda: headline.main([]), lambda: configs.main(["--quick"]),
              lambda: scaling.main([]), lambda: ab.main([])]
    for call in calls:
        with pytest.raises(RuntimeError):
            call()
