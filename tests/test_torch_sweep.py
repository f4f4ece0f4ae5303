"""The port's sweep slice against the JAX package, on the CPU: the device
hint pass, the resident entry points (indexed, prehashed, pool-stream)
and every form of the five sweep functions; config 6's witness recipe.
Bit-exact statuses, values and counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zk_state_proofs_tpu import native as jax_native
from zk_state_proofs_tpu.models import sweep_resident_epochs as jax_sweep_resident_epochs
from zk_state_proofs_tpu.oracle import EthTrie as JaxEthTrie
from zk_state_proofs_tpu.oracle import rlp as jrlp_host
from zk_state_proofs_tpu.ops import mpt as jmpt
from zk_state_proofs_tpu.ops import rlp as jrlp
from zk_state_proofs_tpu.witness import pack_proofs as jax_pack
from zk_state_proofs_tpu_torch import native
from zk_state_proofs_tpu_torch.models import (replicated_batches, sweep, sweep_entries,
                                              sweep_resident, sweep_resident_epochs)
from zk_state_proofs_tpu_torch.models.sweep import epoch_windows
from zk_state_proofs_tpu_torch.ops import mpt as tmpt
from zk_state_proofs_tpu_torch.ops import rlp as trlp
from zk_state_proofs_tpu_torch.oracle import EthTrie, keccak256, rlp
from zk_state_proofs_tpu_torch.witness import pack_proofs
from zk_state_proofs_tpu_torch.witness_bridge import (decode_fuzz_rows, distinct_world,
                                                      sweep_world)

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's thread pools from oversubscribing its cores.
torch.set_num_threads(1)

BATCH = 16


@pytest.fixture(scope="module")
def mixed():
    """Config 5's recipe at 64 accounts, with 4 absent keys, 4 tampered
    leaves, a wrong root and 4 proofs through inline nodes (which latch
    the hinted walk), shuffled; packed at node_len = the longest node, so
    the state root's node (it ends in the empty value slot, 0x80) is
    exactly N bytes long and the epoch counter lands on its last byte."""
    w = sweep_world(64)
    entries = w.entries(range(64))
    for i in range(4):
        k = keccak256(b"sweep-absent-%d" % i)
        entries.append((w.root, w.trie.get_proof(k), k))
    for i in range(4):
        proof = [bytes(x) for x in w.proofs[10 + i]]
        proof[-1] = proof[-1][:-1] + bytes([proof[-1][-1] ^ 1])
        entries.append((w.root, proof, w.keys[10 + i]))
    entries.append((b"\x31" * 32, w.proofs[20], w.keys[20]))
    inl = EthTrie()
    ikeys = [keccak256(b"sweep-inline-%d" % i)[:6] for i in range(32)]
    for i, k in enumerate(ikeys):
        inl.insert(k, rlp.int_to_min_bytes(i + 1))
    entries += [(inl.root_hash(), inl.get_proof(k), k) for k in ikeys[:4]]
    order = np.random.default_rng(5).permutation(len(entries))
    entries = [entries[i] for i in order]
    node_len = max(len(n) for _, p, _ in entries for n in p)
    max_nodes = max(len(p) for _, p, _ in entries)
    assert max_nodes == w.max_nodes
    packed = pack_proofs(entries, max_nodes=max_nodes, node_len=node_len)
    assert len(w.proofs[0][0]) == node_len and w.proofs[0][0][-1] == 0x80
    return {"entries": entries, "packed": packed, "max_nodes": max_nodes,
            "node_len": node_len, "root": w.root}


def _jax_status(packed):
    status, _, _ = jmpt.verify_proofs_pooled(*packed.astuple(), *packed.pool(),
                                             packed.pool_hints())
    return np.asarray(status)


def _counts(status):
    return [int((status == c).sum()) for c in (tmpt.FOUND, tmpt.EXCLUDED, tmpt.INVALID)]


def _assert_counts(res, want, total, batches):
    assert [res.found, res.excluded, res.invalid] == want
    assert res.total == total and res.batches == batches


def test_resident_entry_points_match_jax(mixed):
    packed = mixed["packed"]
    pool_nodes, pool_lens, pool_idx = packed.pool()
    # the device hint pass: the JAX pass, the native scan, fuzzed rows at
    # a width that is a multiple of 4 and one that is not
    rng = np.random.default_rng(3)
    fuzz = pool_nodes.copy()
    flip = rng.random(fuzz.shape) < 0.01
    fuzz[flip] = rng.integers(0, 256, int(flip.sum()), dtype=np.uint8)
    for rows in (pool_nodes, fuzz, fuzz[:, :573],
                 rng.integers(0, 256, (64, 96), dtype=np.uint8)):
        got = trlp.item_offsets(torch.from_numpy(np.ascontiguousarray(rows))).numpy()
        np.testing.assert_array_equal(got, np.asarray(jrlp.item_offsets(jnp.asarray(rows))))
        np.testing.assert_array_equal(got, native.item_offsets_native(rows))
    # RLP-shaped fuzz (witness_bridge.decode_fuzz_rows: zero rows, random
    # rows, long forms 0xB8-0xBF and 0xF8-0xFF, lengths past the row) at
    # the two widths above (one a multiple of 4, one not), whose shapes
    # the JAX pass has run already, and at the transaction width
    for width in (pool_nodes.shape[1], 573, 2092):
        rows = decode_fuzz_rows(pool_nodes.shape[0], width, seed=width)
        got = trlp.item_offsets(torch.from_numpy(rows)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jrlp.item_offsets(jnp.asarray(rows))))
        np.testing.assert_array_equal(got, native.item_offsets_native(rows))

    t = {k: torch.from_numpy(np.asarray(v)) for k, v in dict(
        pool=pool_nodes, plens=pool_lens, idx=pool_idx, num=packed.num_nodes,
        roots=packed.roots, knib=packed.key_nibbles, klen=packed.key_lens,
        nodes=packed.nodes, lens=packed.node_lens).items()}
    dig = tmpt.hash_pool(t["pool"], t["plens"])
    jdig = jmpt.hash_pool(pool_nodes, pool_lens)
    np.testing.assert_array_equal(dig.numpy(), np.asarray(jdig))
    scalars = (packed.num_nodes, packed.roots, packed.key_nibbles, packed.key_lens)
    want = jmpt.verify_proofs_indexed(pool_nodes, pool_lens, jdig, pool_idx, *scalars)
    status = np.asarray(want[0])
    assert set(_counts(status)) != {0} and min(_counts(status)) > 0
    tsc = [t["num"], t["roots"], t["knib"], t["klen"]]
    gots = [tmpt.verify_proofs_indexed(t["pool"], t["plens"], dig, t["idx"], *tsc,
                                       pool_hints=hints, hinted=hinted, device="cpu")
            for hints, hinted in ((None, True), (torch.from_numpy(packed.pool_hints()), True),
                                  (None, False))]
    table = tmpt.scatter_pool_payload(torch.cat([dig, trlp.item_offsets(t["pool"])], 1),
                                      t["idx"])
    for hints in (table[..., 32:], None):
        gots.append(tmpt.verify_proofs_prehashed(t["nodes"], t["lens"], t["num"],
                                                 table[..., :32], t["roots"], t["knib"],
                                                 t["klen"], hints=hints, device="cpu"))
    jpre = jmpt.verify_proofs_prehashed(packed.nodes, packed.node_lens, packed.num_nodes,
                                        np.asarray(table[..., :32]), *scalars[1:])
    gots.append(tmpt.verify_proofs_pool_stream(pool_nodes, pool_lens, pool_idx, *scalars,
                                               device="cpu"))
    jstream = jmpt.verify_proofs_pool_stream(pool_nodes, pool_lens, pool_idx, *scalars)
    for ref in (jpre, jstream):
        for w, g in zip(want, ref):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for got in gots:
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the pooled verify without pack-time hints walks hinted (the device
    # hint pass), with the same results
    pooled = tmpt.verify_proofs_pooled(t["nodes"], t["lens"], *tsc, t["pool"], t["plens"],
                                       t["idx"])
    for w, g in zip(want, pooled):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    one = tmpt.walk_one(t["nodes"][0], t["lens"][0], t["num"][0], table[0, :, :32],
                        t["roots"][0], t["knib"][0], t["klen"][0], 128)
    assert int(one[0]) == int(status[0]) and int(one[2]) == int(np.asarray(want[2])[0])
    np.testing.assert_array_equal(one[1].numpy(), np.asarray(want[1])[0])


def test_sweeps_count_as_jax(mixed):
    entries, packed = mixed["entries"], mixed["packed"]
    max_nodes, node_len = mixed["max_nodes"], mixed["node_len"]
    n = packed.batch
    status = _jax_status(packed)  # per row, as the sweeps count it
    assert min(_counts(status)) > 0
    rng = np.random.default_rng(9)
    sels = [rng.permutation(n)[:BATCH] for _ in range(3)]
    want = [sum(c) for c in zip(*(_counts(status[s]) for s in sels))]
    total = 3 * BATCH
    kw = dict(max_steps=max_nodes, device="cpu")
    for fused, materialize in ((True, None), (False, True), (False, False), (True, False)):
        res = sweep_resident(packed, iter(sels), fused=fused, materialize=materialize,
                             forbid_sync=True, **kw)
        _assert_counts(res, want, total, 3)
    for dedup in (True, False):
        res = sweep_entries(([entries[i] for i in s] for s in sels), max_nodes=max_nodes,
                            node_len=node_len, dedup=dedup, pool_rows=256, prefetch=2,
                            forbid_sync=True, device="cpu")
        _assert_counts(res, want, total, 3)
        sub = pack_proofs([entries[i] for i in sels[0]], max_nodes=max_nodes,
                          node_len=node_len)
        res = sweep(replicated_batches(sub, 2), dedup=dedup, device="cpu")
        _assert_counts(res, [2 * c for c in _counts(status[sels[0]])], 2 * BATCH, 2)

    # the epoch sweep: windows (the tail clamped to end at the last row) and
    # the counter byte, held against the JAX function itself, twice on one
    # witness (a card copies the second call's upload from the staging the
    # first made; the CPU stages nothing); counter 0x81 on the root node's
    # last byte breaks its empty value slot, 0x7F and 0x80 do not
    jpacked = jax_pack(entries, max_nodes=max_nodes, node_len=node_len)
    jres = [jax_sweep_resident_epochs(jpacked, epochs=2, batch=BATCH, max_steps=max_nodes,
                                      salt=salt) for salt in (0x80, 0x7F)]
    res = sweep_resident_epochs(packed, epochs=2, batch=BATCH, salt=0x80, forbid_sync=True,
                                **kw)
    again = sweep_resident_epochs(packed, epochs=2, batch=BATCH, salt=0x7F, **kw)
    assert res.pinned_upload_bytes == again.pinned_upload_bytes == 0
    starts = epoch_windows(n, BATCH)
    assert starts[-1] == n - BATCH and len(starts) == -(-n // BATCH)

    def windows(st):
        return [sum(c) for c in zip(*(_counts(st[s:s + BATCH]) for s in starts))]

    epoch0 = windows(status)
    under_root = np.array([e[0] == mixed["root"] for e in entries])
    epoch1 = windows(np.where(under_root, tmpt.INVALID, status))
    assert epoch1 != epoch0
    for got, j in zip((res, again), jres):
        _assert_counts(got, [j.found, j.excluded, j.invalid], j.total, j.batches)
    _assert_counts(res, [a + b for a, b in zip(epoch0, epoch1)], 2 * len(starts) * BATCH,
                   2 * len(starts))
    _assert_counts(again, [2 * c for c in epoch0], 2 * len(starts) * BATCH, 2 * len(starts))
    with pytest.raises(ValueError):
        sweep_resident_epochs(packed, epochs=1, batch=n + 1, **kw)
    # a one-rank mesh (no process group) counts as the unsharded sweeps
    from zk_state_proofs_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device="cpu")
    res = sweep_resident_epochs(packed, epochs=1, batch=BATCH, salt=0x7F, mesh=mesh, **kw)
    _assert_counts(res, epoch0, len(starts) * BATCH, len(starts))
    res = sweep(replicated_batches(sub, 2), mesh=mesh, device="cpu")
    _assert_counts(res, [2 * c for c in _counts(status[sels[0]])], 2 * BATCH, 2)
    res = sweep_entries(([entries[i] for i in s] for s in sels), max_nodes=max_nodes,
                        node_len=node_len, pool_rows=256, mesh=mesh, forbid_sync=True,
                        device="cpu")
    _assert_counts(res, want, total, 3)

    # BASELINE config 6's recipe at 512 accounts: the keys, leaves and root
    # of bench_configs.py's build, every proof FOUND by the epoch sweep
    w = distinct_world(512)
    nk = jax_native.keccak256
    trie = JaxEthTrie(hasher=nk)
    keys = [nk(b"m-acct-%d" % i) for i in range(512)]
    leaves = [jrlp_host.encode([jrlp_host.int_to_min_bytes(i + 1),
                                jrlp_host.int_to_min_bytes(10**18 + i), nk(b"sr%d" % i),
                                nk(b"ch%d" % i)]) for i in range(512)]
    for k, leaf in zip(keys, leaves):
        trie.insert(k, leaf)
    assert w.keys == keys and w.leaves == leaves and w.root == trie.root_hash()
    order = w.depth_order()
    assert [len(w.proofs[i]) for i in order] == sorted((len(p) for p in w.proofs),
                                                       reverse=True)
    res = sweep_resident_epochs(w.pack(), epochs=1, batch=128, max_steps=w.max_nodes,
                                device="cpu")
    _assert_counts(res, [512, 0, 0], 512, 4)
