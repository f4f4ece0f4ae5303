"""Entry points: one batched verification step, and a multi-rank dry run
(the port's twins of the JAX package's root `__graft_entry__.py`).

entry()             -> (fn, example_args): the batched MPT verification
                       step on the flagship verifier, its inputs on the
                       device.
dryrun_multichip(n) -> builds an n-rank mesh and runs the full sharded
                       verification step (batch sharded, stats
                       all_reduce'd) and every other collective path once
                       on small shapes.
"""

from __future__ import annotations

import functools

import numpy as np


def _example_packed(batch: int):
    """Small deterministic witness batch built by the oracle."""
    from .oracle import EthTrie, keccak256
    from .witness import pack_proofs

    t = EthTrie()
    kvs = {}
    for i in range(48):
        k = keccak256(b"entry-%d" % i)
        v = bytes([i % 200 + 1]) * (1 + i % 30)
        kvs[k] = v
        t.insert(k, v)
    root = t.root_hash()
    keys = (list(kvs) * ((batch // len(kvs)) + 1))[:batch]
    entries = [(root, t.get_proof(k), k) for k in keys]
    return pack_proofs(entries, max_nodes=6, node_len=576)


def entry(device="cuda"):
    """The forward step on the flagship model (batched MPT verify) and its
    inputs as tensors on `device` ("cuda" unless named)."""
    from .ops import mpt
    from .witness_bridge import BATCH_FIELDS, packed_to_tensors

    t = packed_to_tensors(_example_packed(batch=64), device, pool=False)
    fn = functools.partial(mpt.verify_proofs, max_value_len=64)
    return fn, tuple(t[k] for k in BATCH_FIELDS)


def _expect(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the sharded verification step over an n-rank mesh on small
    shapes, covering every collective the framework uses:

    1. POOLED sharded batch verification, 1024 proofs: batch sharded,
       unique-node pool replicated, global stats all_reduce'd.
    2. Sharded trie-root reduction: leaf level sharded, per-level digest
       exchange via all_gather, root checked against the oracle.
    3. Sharded device-resident epoch sweep (the flagship 1M-proof shape,
       BASELINE config 5): each rank's own rows of the witness tables,
       per-shard contiguous windows, counts all_reduce'd.
    4. Sharded GROUPED two-level storage verification (the reference's
       one-account/N-slots circuit shape): slots sharded, accounts + node
       pools replicated, slot keys hashed on the device, counts
       all_reduce'd.

    Every rank of a process group of n ranks (parallel.multihost.initialize,
    or multihost.run_ranks) calls it; n = 1 also runs without a group.
    Raises on any mismatch, and where n is not the group's size."""
    from .models import sweep_resident_epochs
    from .ops import mpt
    from .oracle import EthTrie, keccak256
    from .oracle import rlp as orlp
    from .parallel import (compute_root_sharded, make_mesh, verify_proofs_sharded,
                           verify_storage_grouped_sharded)
    from .witness import pack_proofs
    from .witness.trie_plan import plan_index_trie

    mesh = make_mesh(n_devices, device=device)

    # 1. pooled sharded verification (all_reduce + replicated pool)
    packed = _example_packed(batch=1024)
    packed.pool()
    status, values, vlens, counts = verify_proofs_sharded(
        mesh, packed, max_value_len=64, dedup=True)
    _expect((status == mpt.FOUND).all(), f"pooled statuses {status}")
    _expect(counts[0] == packed.batch, f"pooled counts {counts}")

    # 2. sharded trie-root reduction (all_gather over per-level digests)
    values_list = [bytes([i % 251 + 1]) * (40 + i % 80) for i in range(160)]
    t = EthTrie()
    for i, v in enumerate(values_list):
        t.insert(orlp.encode_int(i), v)
    want = t.root_hash()
    root, _ = compute_root_sharded(mesh, plan_index_trie(values_list))
    _expect(bytes(root) == want, "sharded trie-root reduction mismatch")

    # 3. sharded device-resident epoch sweep (row-sharded tables + all_reduce)
    packed_small = _example_packed(batch=128)
    res = sweep_resident_epochs(packed_small, epochs=2, batch=4 * n_devices, mesh=mesh,
                                max_value_len=64, device=mesh.device.type)
    _expect(res.found == res.total, f"epoch sweep {res}")

    # 4. sharded grouped two-level storage (slots sharded, accounts + pools
    #    replicated, all_reduce'd slot counts)
    n_acc, slots_per = 4, 2 * n_devices
    world = EthTrie()
    sroots, s_entries, slots_raw, slot_accounts = [], [], [], []
    for a in range(n_acc):
        st = EthTrie()
        raw = [a.to_bytes(16, "big") + i.to_bytes(16, "big") for i in range(slots_per)]
        for i, rs in enumerate(raw):
            st.insert(keccak256(rs), orlp.encode_int(100 * a + i + 1))
        sroots.append(st.root_hash())
        for rs in raw:
            s_entries.append((sroots[a], st.get_proof(keccak256(rs)), keccak256(rs)))
            slots_raw.append(rs)
            slot_accounts.append(a)
    addr_keys = [keccak256(b"dry-acct-%d" % a) for a in range(n_acc)]
    for a, k in enumerate(addr_keys):
        world.insert(k, orlp.encode([bytes([a + 1]), b"\x01", sroots[a],
                                     keccak256(b"c%d" % a)]))
    wroot = world.root_hash()
    ap = pack_proofs([(wroot, world.get_proof(k), k) for k in addr_keys])
    sp = pack_proofs(s_entries)
    slots_arr = np.frombuffer(b"".join(slots_raw), np.uint8).reshape(-1, 32)
    a_st, _, s_st, _, _, gcounts = verify_storage_grouped_sharded(
        mesh, ap, sp, slots_arr, np.asarray(slot_accounts, np.int32))
    _expect((a_st == mpt.FOUND).all(), f"account statuses {a_st}")
    _expect((s_st == mpt.FOUND).all(), f"slot statuses {s_st}")
    _expect(gcounts[0] == len(s_entries), f"slot counts {gcounts}")

    if mesh.rank == 0:
        print(f"dryrun_multichip({n_devices}): verified {int(counts[0])} pooled "
              f"proofs (sharded, all_reduce stats) + sharded trie-root reduction "
              f"(all_gather) + sharded resident epoch sweep ({res.total} proofs, "
              f"row-sharded tables, all_reduce counts) + sharded grouped storage "
              f"({n_acc} accounts x {slots_per} slots, slots sharded, accounts "
              f"replicated, all_reduce counts) ok across {n_devices} ranks ({mesh})",
              flush=True)
