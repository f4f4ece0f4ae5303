"""The storage generator and the two-level reference on the CPU: a world
repeats for its seed; its slot proofs are as deep as its virtual trie's
keys make them; each leaf holds RLP(balance); the reference's slot walk
gives `mpt.verify`'s answers wherever no node is inline, and walks the
inline leaves of a deep trie to their balances.

The storage cell's span metrics are host events on the CPU too: they join
the harness test's set of metrics the CPU can read (`ON_THE_CPU`) here,
at import, as the older span metrics join it from conftest.py."""

import math

import torch

from proofbench.reference import storage as reference
from proofbench.reference.mpt import FOUND, INVALID, verify
from proofbench.tests import test_proofbench_harness
from proofbench.traffic._population import depth_tail
from proofbench.traffic._storage import make_storage_world

test_proofbench_harness.ON_THE_CPU |= {"storage_host_ms", "storage_account_ms"}

V_SLOTS = 1 << 24


def _world(seed, holders=256, virtual=V_SLOTS, tampered=1):
    return make_storage_world(seed, holders=holders, virtual_slots=virtual, max_nodes=11,
                              virtual_accounts=1 << 28, account_max_nodes=12, node_len=576,
                              position=2, tampered=tampered)


def _table(pop):
    pn = pop.proof_nodes
    ids = pn.clamp(min=0)
    return pop.nodes[ids], torch.where(pn >= 0, pop.node_lens[ids], 0), pop.proof_lens


def test_world_repeats_for_a_seed():
    a, b, c = _world(2**33 + 5), _world(2**33 + 5), _world(2**33 + 6)
    for f in ("nodes", "node_lens", "proof_nodes", "keys", "root", "intent"):
        assert torch.equal(getattr(a.slots, f), getattr(b.slots, f)), f
        assert torch.equal(getattr(a.account, f), getattr(b.account, f)), f
    assert torch.equal(a.raw_slots, b.raw_slots) and torch.equal(a.balances, b.balances)
    assert not torch.equal(a.slots.root, c.slots.root)
    assert int((a.slots.intent == INVALID).sum()) == int((c.slots.intent == INVALID).sum()) == 1


def test_proof_lengths_follow_the_virtual_trie_and_leaves_hold_balances():
    w = _world(21, holders=4096, tampered=0)
    s = w.slots
    lens = s.proof_lens + w.inline.to(torch.int64)  # an inline leaf's node is in its branch
    for n_nodes, want in ((7, 0.37), (8, 0.57), (9, 0.06)):
        exact = depth_tail(n_nodes - 2, V_SLOTS) - depth_tail(n_nodes - 1, V_SLOTS)
        assert abs(exact - want) < 0.01
        assert abs(float((lens == n_nodes).double().mean()) - exact) < 0.03, n_nodes
    assert int(lens.max()) <= 11
    nodes, node_lens, num = _table(s)
    # branches full down to nibble depth 4: 16 children, 532 bytes
    assert bool((node_lens[:, :5] == 532).all())
    # each leaf (hashed: the proof's last node) holds RLP(balance) at its
    # value's place; an inline one is held in its last branch
    ar = torch.arange(s.size)
    last = nodes[ar, num - 1]
    hashed = ~w.inline
    j = torch.arange(8)[None, :]
    raw = torch.gather(last, 1, (s.value_start[:, None] + j).clamp(max=575)).to(torch.int64)
    n = s.value_lens
    single = n == 1
    size = torch.where(single, 1, raw[:, 0] - 0x80)
    assert bool((size[hashed & ~single] == n[hashed & ~single] - 1).all())
    body = torch.where(single[:, None], raw, torch.cat([raw[:, 1:], raw[:, :1] * 0], 1))
    bal = torch.zeros(s.size, dtype=torch.int64)
    for k in range(8):
        bal = torch.where(k < size, (bal << 8) | body[:, k], bal)
    assert torch.equal(bal[hashed], w.balances[hashed])
    assert bool((raw[single & hashed, 0] < 0x80).all())
    assert bool((raw[~single & hashed, 1] != 0).all())
    bits = torch.floor(torch.log2(w.balances.double())) + 1
    assert 1 <= int(bits.min()) and int(bits.max()) <= 56


def test_reference_walks_inline_leaves_and_agrees_with_mpt_verify():
    # at 2^32 keys most leaves sit at nibble depth 9 or more: those with a
    # balance under 128 are inline
    w = _world(22, holders=512, virtual=1 << 32, tampered=4)
    assert int(w.inline.sum()) >= 10
    a = w.account
    a_status, acct = reference.verify_accounts(*_table(a), a.root.expand(1, 32), a.keys)
    assert a_status.tolist() == [FOUND] and acct["ok"].tolist() == [True]
    assert torch.equal(acct["storage_root"][0], w.slots.root)
    assert acct["nonce"][0].tolist() == [0] * 7 + [1] and int(acct["balance"].sum()) == 0
    s = w.slots
    nodes, lens, num = _table(s)
    roots = s.root.expand(s.size, 32)
    st, v, n = reference.verify_slots(nodes, lens, num, roots, w.raw_slots)
    assert torch.equal(st, s.intent) and torch.equal(n, s.value_lens)
    assert torch.equal(reference.slot_keys(w.raw_slots), s.keys)
    s2, v2, n2 = verify(nodes, lens, num, roots, s.keys, 64)
    off = ~w.inline
    assert torch.equal(s2[off], st[off]) and torch.equal(v2[off], v[off])
    assert torch.equal(n2[off], n[off])
    assert bool((s2[w.inline] == INVALID).all())  # mpt.verify refuses inline nodes
    inl = w.inline & (s.intent == FOUND)
    assert bool((v[inl, 0].to(torch.int64) == w.balances[inl]).all())
    # another storage root, or a slot under an account that is not FOUND:
    # INVALID
    other = roots.clone()
    other[:, 0] ^= 1
    assert bool((reference.verify_slots(nodes, lens, num, other, w.raw_slots)[0]
                 == INVALID).all())
    bad = torch.zeros(s.size, dtype=torch.bool)
    bad[::3] = True
    o_st, o_v, o_n = reference.override(st, v, n, ~bad)
    assert bool((o_st[bad] == INVALID).all()) and int(o_n[bad].sum()) == 0
    assert torch.equal(o_st[~bad], st[~bad]) and math.isclose(float(o_v[bad].sum()), 0.0)
