"""Two-level account -> storage verification: the port (device="cpu", plain
versions of the kernels) against the JAX package on the same witnesses,
every field of the results bit for bit, and against the oracle's values;
the device-resident entry `verify_storage_pooled` and
`verify_storage_grouped` against the benchmark's plain reference
(proofbench/reference/storage.py) on its generator's seeded worlds.

Every JAX call here has one batch shape (ROWS account rows, ROWS slot rows,
one node bucket), so the JAX side compiles each storage core once."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zk_state_proofs_tpu.models import verify_storage_batch as jax_batch
from zk_state_proofs_tpu.models import verify_storage_grouped as jax_grouped
from zk_state_proofs_tpu.oracle import EthTrie, keccak256, rlp
from zk_state_proofs_tpu.ops import account as jaccount
from proofbench.drivers._common import Batches
from proofbench.reference import storage as plain
from proofbench.traffic._storage import make_storage_world
from zk_state_proofs_tpu.witness import pack_proofs as jax_pack
from zk_state_proofs_tpu_torch.models import (verify_storage_batch, verify_storage_grouped,
                                              verify_storage_pooled)
from zk_state_proofs_tpu_torch.ops import mpt
from zk_state_proofs_tpu_torch.ops.account import decode_account
from zk_state_proofs_tpu_torch.witness import pack_proofs
from zk_state_proofs_tpu_torch.witness_bridge import (BATCH_FIELDS, POOL_FIELDS,
                                                      account_fuzz_values, packed_to_tensors)

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's thread pools from oversubscribing its cores.
torch.set_num_threads(1)

BUCKET = dict(max_nodes=6, node_len=576)
ROWS = 44  # slots of the three worlds below
FIELDS = ("account_status", "storage_root", "nonce", "balance", "code_hash",
          "slot_status", "slot_values", "slot_value_lens")
# two raw slots whose keys keccak(slot) share their first 8 nibbles: their
# leaves sit under a branch at depth 8 and, with 1-byte values, are inline
INLINE_SLOTS = [(b"inline-slot-%d" % i).ljust(32, b"\0") for i in (42171, 108158)]


def _account_leaf(nonce, balance, storage_root, code_hash):
    return rlp.encode([rlp.int_to_min_bytes(nonce), rlp.int_to_min_bytes(balance),
                       storage_root, code_hash])


def _build_world(n_accounts, slots_per, tag=b""):
    """The JAX package's recipe (tests/test_storage_model.py:18-34):
    account a holds slots_per slots keccak("slot-a-s") -> 1000a + s + 1."""
    world = EthTrie()
    accounts = []
    for a in range(n_accounts):
        addr = keccak256(tag + b"addr-%d" % a)[:20]
        st = EthTrie()
        slots = {}
        for s in range(slots_per):
            slot = keccak256(tag + b"slot-%d-%d" % (a, s))
            slots[slot] = rlp.encode_int(1000 * a + s + 1)
            st.insert(keccak256(slot), slots[slot])
        sroot = st.root_hash()
        leaf = _account_leaf(a + 1, 10**18 + a, sroot, keccak256(b"code-%d" % a))
        world.insert(keccak256(addr), leaf)
        accounts.append((addr, st, sroot, slots, leaf))
    return world, accounts


def _inline_world():
    """One account whose storage trie holds inline (< 32 B) leaves."""
    world = EthTrie()
    addr = keccak256(b"addr-inline")[:20]
    st = EthTrie()
    slots = {}
    for s, slot in enumerate(INLINE_SLOTS + [keccak256(b"slot-x-%d" % i) for i in range(2)]):
        slots[slot] = rlp.encode_int(s + 5)
        st.insert(keccak256(slot), slots[slot])
    leaf = _account_leaf(7, 10**15, st.root_hash(), keccak256(b"code-inline"))
    world.insert(keccak256(addr), leaf)
    return world, [(addr, st, st.root_hash(), slots, leaf)]


@functools.lru_cache(maxsize=None)
def _witness():
    """8 accounts x 4 slots and 4 x 2 (the JAX recipe), plus the inline
    account: (account entries [13], slot entries [44], raw slots, slot ->
    account rows, oracle values, account leaves)."""
    a_entries, s_entries, slots, sa, values, leaves = [], [], [], [], [], []
    for world, accounts in (_build_world(8, 4), _build_world(4, 2, b"b-"),
                            _inline_world()):
        root = world.root_hash()
        for addr, st, sroot, slot_map, leaf in accounts:
            for slot, val in slot_map.items():
                s_entries.append((sroot, st.get_proof(keccak256(slot)), keccak256(slot)))
                slots.append(slot)
                sa.append(len(a_entries))
                values.append(val)
            a_entries.append((root, world.get_proof(keccak256(addr)), keccak256(addr)))
            leaves.append(leaf)
    slots = np.stack([np.frombuffer(s, np.uint8) for s in slots])
    return a_entries, s_entries, slots, np.asarray(sa, np.int32), values, leaves


def _pad(entries):
    """Account rows padded to ROWS with empty proofs (never referenced)."""
    return entries + [(b"\x00" * 31 + b"\x01", [], b"\x00")] * (ROWS - len(entries))


def _assert_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def _check_oracle(res, values, n_accounts):
    assert (res.account_status[:n_accounts] == mpt.FOUND).all()
    assert (res.slot_status == mpt.FOUND).all()
    for i, v in enumerate(values):
        assert res.slot_value(i) == v, i


def test_storage_grouped_matches_jax_and_oracle():
    a_entries, s_entries, slots, sa, values, leaves = _witness()
    assert len(s_entries) == ROWS
    a = _pad(a_entries)
    got = verify_storage_grouped(pack_proofs(a, **BUCKET), pack_proofs(s_entries, **BUCKET),
                                 slots, sa, device="cpu")
    want = jax_grouped(jax_pack(a, **BUCKET), jax_pack(s_entries, **BUCKET), slots, sa)
    _assert_equal(got, want)
    np.testing.assert_array_equal(got.slot_accounts, sa)
    _check_oracle(got, values, len(a_entries))
    for i, leaf in enumerate(leaves):
        nonce, balance, sroot, _ = rlp.decode(leaf)
        assert bytes(got.storage_root[i]) == sroot
        assert int.from_bytes(bytes(got.nonce[i]), "big") == int.from_bytes(nonce, "big")
        assert int.from_bytes(bytes(got.balance[i]), "big") == int.from_bytes(balance, "big")
    # the inline slots' proofs end in a branch that holds the leaf itself
    for j in np.flatnonzero(sa == len(a_entries) - 1)[:2]:
        branch = rlp.decode(s_entries[j][1][-1])
        assert len(branch) == 17 and any(isinstance(x, list) for x in branch)
    # the account decode on fuzzed values (witness_bridge.account_fuzz_values:
    # oversize nonces and balances, 31-33 B roots, list items, long forms,
    # flipped bytes, value_lens off by a few and past V), bit for bit
    values, lens = account_fuzz_values(512, 128, seed=7)
    got = decode_account(torch.from_numpy(values), torch.from_numpy(lens))
    want = jax.jit(jaccount.decode_account)(jnp.asarray(values), jnp.asarray(lens))
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)
    assert 0 < int(got["ok"].sum()) < len(lens)


@pytest.mark.parametrize("dedup", [True, False])
def test_storage_batch_matches_jax(dedup):
    """The 1:1 form (account row j owns slot j), pooled and unpooled."""
    a_entries, s_entries, slots, sa, values, _ = _witness()
    a = [a_entries[i] for i in sa]
    got = verify_storage_batch(pack_proofs(a, **BUCKET), pack_proofs(s_entries, **BUCKET),
                               slots, dedup=dedup, device="cpu")
    want = jax_batch(jax_pack(a, **BUCKET), jax_pack(s_entries, **BUCKET), slots,
                     dedup=dedup)
    _assert_equal(got, want)
    _check_oracle(got, values, ROWS)


def test_storage_grouped_bad_account_masks_its_slots_only():
    a_entries, s_entries, slots, sa, _, _ = _witness()
    bad = [bytes(p) for p in a_entries[1][1]]
    leaf = bytearray(bad[-1])
    leaf[-1] ^= 1
    bad[-1] = bytes(leaf)
    a = _pad(a_entries[:1] + [(a_entries[1][0], bad, a_entries[1][2])] + a_entries[2:])
    got = verify_storage_grouped(pack_proofs(a, **BUCKET), pack_proofs(s_entries, **BUCKET),
                                 slots, sa, device="cpu")
    want = jax_grouped(jax_pack(a, **BUCKET), jax_pack(s_entries, **BUCKET), slots, sa)
    _assert_equal(got, want)
    n = len(a_entries)
    assert got.account_status[1] == mpt.INVALID
    assert (np.delete(got.account_status[:n], 1) == mpt.FOUND).all()
    assert (got.slot_status[sa == 1] == mpt.INVALID).all()
    assert (got.slot_status[sa != 1] == mpt.FOUND).all()


def test_storage_entry_points_check_their_inputs():
    a_entries, s_entries, slots, sa, _, _ = _witness()
    ap, sp = pack_proofs(a_entries[:2]), pack_proofs(s_entries[:3])
    with pytest.raises(ValueError):
        verify_storage_grouped(ap, sp, slots[:3, :31], sa[:3])
    with pytest.raises(ValueError):
        verify_storage_grouped(ap, sp, slots[:3], sa[:2])
    with pytest.raises(ValueError):
        verify_storage_grouped(ap, sp, slots[:3], np.full(3, 2, np.int32))
    with pytest.raises(ValueError):
        verify_storage_batch(ap, sp, slots[:2])


# the benchmark's storage generator at a CPU size: 2^12 virtual slots (4-6
# node proofs), both levels in 576-byte rows, the slot level's 11-node and
# 64-byte-value bucket
ACCOUNT_BUCKET = dict(max_nodes=12, node_len=576)
SLOT_BUCKET = dict(max_nodes=11, node_len=576)


def _bench_world(seed, holders, tampered):
    return make_storage_world(seed, holders=holders, virtual_slots=1 << 12, max_nodes=11,
                              virtual_accounts=1 << 28, account_max_nodes=12, node_len=576,
                              position=2, tampered=tampered)


def _plain_table(pop):
    pn = pop.proof_nodes
    ids = pn.clamp(min=0)
    return pop.nodes[ids], torch.where(pn >= 0, pop.node_lens[ids], 0), pop.proof_lens


def _bench_case(worlds):
    """Packed account proofs (one a world), packed slot proofs, raw slots,
    slot -> account rows, and the plain reference's answers: (account
    status, fields) and (slot status, values, lengths)."""
    a_entries, s_entries, slots, sa, a_ref, s_ref = [], [], [], [], [], []
    for k, w in enumerate(worlds):
        q = w.slots.size
        a_entries += Batches(w.account, 1, 1).entries([0])
        s_entries += Batches(w.slots, q, 1).entries(range(q))
        slots.append(w.raw_slots)
        sa += [k] * q
        a = w.account
        status, acct = plain.verify_accounts(*_plain_table(a), a.root.expand(1, 32), a.keys)
        a_ref.append((status, acct))
        ok = (status == plain.FOUND) & acct["ok"]
        s_ref.append(plain.override(*plain.verify_slots(
            *_plain_table(w.slots), acct["storage_root"].expand(q, 32), w.raw_slots),
            ok.expand(q)))
    a_status = torch.cat([s for s, _ in a_ref])
    fields = {f: torch.cat([acct[f] for _, acct in a_ref])
              for f in ("ok", "nonce", "balance", "storage_root", "code_hash")}
    s_want = tuple(torch.cat(parts).numpy() for parts in zip(*s_ref))
    return (pack_proofs(a_entries, **ACCOUNT_BUCKET), pack_proofs(s_entries, **SLOT_BUCKET),
            torch.cat(slots).numpy(), np.asarray(sa, np.int32), (a_status, fields), s_want)


def _assert_plain(a_status, acct, s_status, s_values, s_vlens, want_a, want_s):
    """The port's two-level answers (numpy or tensors) equal the plain
    reference's: every status, ok flag (where `acct` has one) and value
    length; the fields of every FOUND, well-formed account; the bytes of
    every value."""
    w_status, w_fields = want_a
    np.testing.assert_array_equal(np.asarray(a_status), w_status.numpy())
    if "ok" in acct:
        np.testing.assert_array_equal(np.asarray(acct["ok"]), w_fields["ok"].numpy())
    good = (w_status.numpy() == mpt.FOUND) & w_fields["ok"].numpy()
    for f in ("nonce", "balance", "storage_root", "code_hash"):
        np.testing.assert_array_equal(np.asarray(acct[f])[good], w_fields[f].numpy()[good],
                                      err_msg=f)
    ws, wv, wl = want_s
    np.testing.assert_array_equal(np.asarray(s_status), ws)
    np.testing.assert_array_equal(np.asarray(s_vlens), wl)
    mask = np.arange(wv.shape[1])[None, :] < wl[:, None]
    np.testing.assert_array_equal(np.where(mask, np.asarray(s_values)[:, :wv.shape[1]], 0), wv)


def _grouped_fields(res):
    return {f: getattr(res, f) for f in ("nonce", "balance", "storage_root", "code_hash")}


def test_storage_pooled_and_grouped_match_the_plain_reference():
    ap, sp, slots, sa, want_a, want_s = _bench_case([_bench_world(2**35 + 3, 256, 1)])
    assert (want_s[0] == mpt.FOUND).sum() == 255 and (want_s[0] == mpt.INVALID).sum() == 1
    # the device-resident entry on tensors already on the device
    at, st = packed_to_tensors(ap, "cpu"), packed_to_tensors(sp, "cpu", hints=False)
    out = verify_storage_pooled(
        [at[k] for k in BATCH_FIELDS], [at[k] for k in POOL_FIELDS], at["pool_hints"],
        st["nodes"], st["node_lens"], st["num_nodes"], [st[k] for k in POOL_FIELDS],
        torch.from_numpy(slots), torch.from_numpy(sa))
    a_status, acct, s_status, s_values, s_vlens = out
    assert s_values.shape == (256, 64)
    _assert_plain(a_status, {k: v.numpy() for k, v in acct.items()}, s_status, s_values,
                  s_vlens, want_a, want_s)
    # the host-packed entry built on it
    got = verify_storage_grouped(ap, sp, slots, sa, device="cpu")
    _assert_plain(got.account_status, _grouped_fields(got), got.slot_status, got.slot_values,
                  got.slot_value_lens, want_a, want_s)


def test_storage_grouped_tampered_account_invalidates_its_slots_only():
    worlds = [_bench_world(2**35 + 10 + k, 32, 0) for k in range(4)]
    a = worlds[2].account
    leaf = a.proof_nodes[0, a.proof_lens[0] - 1]
    a.nodes = a.nodes.clone()
    a.nodes[leaf, a.node_lens[leaf] - 1] ^= 1  # the code hash's last byte
    ap, sp, slots, sa, want_a, want_s = _bench_case(worlds)
    assert want_a[0].tolist() == [mpt.FOUND, mpt.FOUND, mpt.INVALID, mpt.FOUND]
    assert (want_s[0][sa == 2] == mpt.INVALID).all() and (want_s[0][sa != 2] == mpt.FOUND).all()
    got = verify_storage_grouped(ap, sp, slots, sa, device="cpu")
    _assert_plain(got.account_status, _grouped_fields(got), got.slot_status, got.slot_values,
                  got.slot_value_lens, want_a, want_s)
