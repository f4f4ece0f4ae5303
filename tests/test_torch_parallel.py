"""The port's sharded layer (`parallel/`) across two processes, against its
unsharded functions and the JAX package's sharded ones.

Two gloo ranks on the CPU, spawned as separate processes, each holding the
same host witness: verify_proofs_sharded (31 proofs padded to the mesh,
dedup on and off), verify_storage_grouped_sharded, compute_root_sharded,
the sharded sweeps (epoch windows clamped per shard, replicated batches,
packed entries), BatchVerifier(mesh=) and dryrun_multichip(2) give the
unsharded port's results bit for bit. Meanwhile this process runs the JAX
package's verify_proofs_sharded and compute_root_sharded on the 8-device
virtual CPU mesh of tests/conftest.py, whose outputs equal the ranks'.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from zk_state_proofs_tpu_torch.oracle import EthTrie, keccak256, rlp
from zk_state_proofs_tpu_torch.parallel.multihost import free_port
from zk_state_proofs_tpu_torch.witness import pack_proofs
from zk_state_proofs_tpu_torch.witness.trie_plan import plan_index_trie
from zk_state_proofs_tpu_torch.witness_bridge import storage_world, sweep_world

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's thread pools from oversubscribing its cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 240

WORKER = textwrap.dedent("""
    import pickle
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    coordinator, rank, tmp = sys.argv[1], int(sys.argv[2]), sys.argv[3]

    from zk_state_proofs_tpu_torch.entry import dryrun_multichip
    from zk_state_proofs_tpu_torch.models import (
        BatchVerifier, replicated_batches, sweep, sweep_entries, sweep_resident_epochs,
        verify_merkle_batch, verify_storage_grouped)
    from zk_state_proofs_tpu_torch.models.sweep import epoch_windows
    from zk_state_proofs_tpu_torch.ops import mpt
    from zk_state_proofs_tpu_torch.ops.trie_build import compute_root
    from zk_state_proofs_tpu_torch.parallel import (
        compute_root_sharded, make_mesh, verify_proofs_sharded,
        verify_storage_grouped_sharded)
    from zk_state_proofs_tpu_torch.parallel import multihost
    from zk_state_proofs_tpu_torch.utils.config import BucketConfig

    topo = multihost.initialize(coordinator, 2, rank, backend="gloo", timeout_s=120)
    assert topo["process_count"] == 2 and topo["global_devices"] == 2, topo
    inp = pickle.loads(open(tmp + "/inputs.pkl", "rb").read())

    def counts(status):
        return [int((status == c).sum()) for c in (mpt.FOUND, mpt.EXCLUDED, mpt.INVALID)]

    def same(a, b, what):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)

    try:
        mesh = make_mesh(2, device="cpu")
        assert (mesh.size, mesh.rank, mesh.shape) == (2, rank, {"dp": 2}), mesh
        arr = np.arange(12, dtype=np.int32).reshape(6, 2)
        part = multihost.put_global(mesh, arr, "dp")
        same(part, arr[3 * rank:3 * rank + 3], "put_global shard")
        same(multihost.put_global(mesh, arr, None), arr, "put_global replicated")
        same(multihost.gather_to_host(part, mesh), arr, "gather_to_host")
        same(multihost.gather_to_host(part), arr, "gather_to_host, world")

        # pooled and unpooled sharded verify: 31 proofs padded to 32
        packed, entries = inp["packed"], inp["entries"]
        out = {}
        for dedup in (True, False):
            st, v, vl, c = verify_proofs_sharded(mesh, packed, dedup=dedup)
            ref = verify_merkle_batch(packed, dedup=dedup, device="cpu")
            for got, want, f in ((st, ref.status, "status"), (v, ref.values, "values"),
                                 (vl, ref.value_lens, "value_lens")):
                same(got, want, f"{f} dedup={dedup}")
            assert c.tolist() == counts(ref.status) == [29, 1, 1], c
            if dedup:
                out.update(status=st, values=v, value_lens=vl, counts=c)

        # grouped storage: slots sharded (9, padded to 10), a tampered account
        ap, sp, slots, sa = inp["storage"]
        got = verify_storage_grouped_sharded(mesh, ap, sp, slots, sa)
        ref = verify_storage_grouped(ap, sp, slots, sa, device="cpu")
        for g, f in zip(got[:5], ("account_status", "storage_root", "slot_status",
                                  "slot_values", "slot_value_lens")):
            same(g, getattr(ref, f), f)
        assert got[5].tolist() == counts(ref.slot_status) and got[5][2] == 3, got[5]

        # trie roots: the leaf level sharded, the upper levels on every rank
        plan = inp["plan"]
        assert plan.levels[0].templates.shape[0] >= 2 * 8 > plan.levels[-1].templates.shape[0]
        root, digests = compute_root_sharded(mesh, plan)
        want_root, want_digests = compute_root(plan, device="cpu")
        same(root, want_root, "root")
        same(digests, want_digests, "digests")
        assert bytes(root) == inp["root"]
        out.update(root=root, digests=digests)

        # the epoch sweep: 24 rows, 12 a rank, windows of 5 (the tail
        # clamped per shard), every row's status summed per window
        gp = inp["sweep_packed"]
        rows = verify_merkle_batch(gp, device="cpu").status
        starts = epoch_windows(12, 5)
        assert starts.tolist() == [0, 5, 7]
        want = np.sum([counts(rows[12 * s + w:12 * s + w + 5])
                       for s in (0, 1) for w in starts], axis=0) * 2
        res = sweep_resident_epochs(gp, epochs=2, batch=10, salt=3, mesh=mesh,
                                    forbid_sync=True, device="cpu")
        assert [res.found, res.excluded, res.invalid] == want.tolist(), (res, want)
        assert (res.total, res.batches) == (2 * 3 * 10, 6) and res.invalid > 0
        try:
            sweep_resident_epochs(gp, epochs=1, batch=9, mesh=mesh, device="cpu")
            raise AssertionError("a batch that does not divide the mesh was taken")
        except ValueError:
            pass

        # replicated batches and packed entries, padded per batch
        for dedup in (True, False):
            a = sweep(replicated_batches(packed, 2), mesh=mesh, dedup=dedup, device="cpu")
            b = sweep(replicated_batches(packed, 2), dedup=dedup, device="cpu")
            assert (a.found, a.excluded, a.invalid, a.total, a.batches) == \\
                (b.found, b.excluded, b.invalid, b.total, b.batches) == (58, 2, 2, 62, 2), a
            batches = [entries[i:i + 7] for i in range(0, len(entries), 7)]
            kw = dict(max_nodes=packed.nodes.shape[1], node_len=packed.nodes.shape[2],
                      dedup=dedup, device="cpu")
            a = sweep_entries(iter(batches), mesh=mesh, forbid_sync=True, **kw)
            b = sweep_entries(iter(batches), **kw)
            assert (a.found, a.excluded, a.invalid, a.total, a.batches) == \\
                (b.found, b.excluded, b.invalid, b.total, b.batches) == (29, 1, 1, 31, 5), a

        # the service: each request sharded, the results gathered
        svc = BatchVerifier(BucketConfig.account(), batch_size=32, mesh=mesh, device="cpu")
        plain = BatchVerifier(BucketConfig.account(), batch_size=32, device="cpu")
        for req in (entries, entries[3:12]):
            g, w = svc.verify(req), plain.verify(req)
            for f in ("status", "values", "value_lens"):
                same(getattr(g, f), getattr(w, f), f"service {f}")
        assert svc.stats.proofs == 40 and svc.stats.found == plain.stats.found

        dryrun_multichip(2, device="cpu")
        if rank == 0:
            np.savez(tmp + "/port.npz", **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"rank {rank} OK", flush=True)
""")


def _entries():
    """29 proofs of present keys, one of an absent key and one with a
    tampered leaf, over a 120-key trie with values drawn from a seed."""
    rng = np.random.default_rng(6)
    t = EthTrie()
    keys = [keccak256(b"par-%d" % i) for i in range(120)]
    values = [rng.integers(1, 256, 1 + i % 40, dtype=np.uint8).tobytes()
              for i in range(120)]
    for k, v in zip(keys, values):
        t.insert(k, v)
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys[:30]]
    bad = [bytes(n) for n in entries[7][1]]
    bad[-1] = bad[-1][:-1] + bytes([bad[-1][-1] ^ 1])
    entries[7] = (root, bad, keys[7])
    absent = keccak256(b"par-absent")
    entries.append((root, t.get_proof(absent), absent))
    return entries


def _inputs(entries):
    w = storage_world(n_accounts=3, slots_per=3, slots_in_trie=8)
    proof = [bytes(n) for n in w.account_entries[1][1]]
    proof[-1] = proof[-1][:-1] + bytes([proof[-1][-1] ^ 1])
    w.account_entries[1] = (w.account_entries[1][0], proof, w.account_entries[1][2])
    ap, sp = w.pack()
    rng = np.random.default_rng(9)
    values = [rng.integers(0, 256, 50 + int(rng.integers(300)), dtype=np.uint8).tobytes()
              for _ in range(73)]
    t = EthTrie()
    for i, v in enumerate(values):
        t.insert(rlp.encode_int(i), v)
    sw = sweep_world(24)
    rows = sw.entries(range(24))
    proof = [bytes(n) for n in rows[3][1]]
    proof[-1] = proof[-1][:-1] + bytes([proof[-1][-1] ^ 1])
    rows[3] = (sw.root, proof, sw.keys[3])
    absent = keccak256(b"sweep-par-absent")
    rows[17] = (sw.root, sw.trie.get_proof(absent), absent)
    sweep_packed = pack_proofs(rows, max_nodes=max(len(p) for _, p, _ in rows), node_len=576)
    return {"packed": pack_proofs(entries), "entries": entries,
            "storage": (ap, sp, w.slots, w.slot_accounts),
            "plan": plan_index_trie(values), "root": t.root_hash(),
            "sweep_packed": sweep_packed}, values


def test_sharded_port_matches_jax(tmp_path):
    entries = _entries()
    inputs, trie_values = _inputs(entries)
    (tmp_path / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + env.get("PYTHONPATH", "").split(os.pathsep))
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([sys.executable, str(script), coordinator, str(rank),
                               str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=str(tmp_path))
             for rank in (0, 1)]
    try:
        # the JAX package's sharded functions on the 8-device CPU mesh,
        # while the ranks run
        from zk_state_proofs_tpu.parallel import (compute_root_sharded, make_mesh,
                                                  verify_proofs_sharded)
        from zk_state_proofs_tpu.witness import pack_proofs as jax_pack
        from zk_state_proofs_tpu.witness.trie_plan import plan_index_trie as jax_plan

        mesh = make_mesh()
        assert mesh.devices.size == 8
        want = verify_proofs_sharded(mesh, jax_pack(entries))
        want_root, want_digests = compute_root_sharded(mesh, jax_plan(trie_values))
        outs = []
        for rank, p in enumerate(procs):
            out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            outs.append(out)
            assert p.returncode == 0, f"rank {rank} failed:\n{out}"
            assert f"rank {rank} OK" in out, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert "dryrun_multichip(2)" in outs[0]
    port = np.load(tmp_path / "port.npz")
    for f, w in zip(("status", "values", "value_lens", "counts"), want):
        np.testing.assert_array_equal(port[f], np.asarray(w), err_msg=f)
    assert port["counts"].tolist() == [29, 1, 1]
    np.testing.assert_array_equal(port["root"], np.asarray(want_root))
    np.testing.assert_array_equal(port["digests"], np.asarray(want_digests))
