"""The reference's Keccak, the generator's population and the reference's
verdicts on it, on the CPU."""

import random

import numpy as np
import pytest
import torch

from proofbench.reference.keccak import keccak256, keccak256_rows
from proofbench.reference.mpt import FOUND, INVALID, verify
from proofbench.traffic._population import (EMPTY_CODE, EMPTY_ROOT, depth_tail,
                                            make_population)

V = 1 << 28


def test_keccak_known_answers():
    assert keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    assert keccak256(b"abc").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")
    assert keccak256(b"") == EMPTY_CODE and keccak256(b"\x80") == EMPTY_ROOT


def test_keccak_rows_match_the_port_oracle():
    from zk_state_proofs_tpu_torch.oracle.keccak import keccak256 as oracle

    rng = random.Random(7)
    lens = [0, 1, 135, 136, 137, 271, 272, 532, 575] + [rng.randrange(576) for _ in range(60)]
    msgs = [bytes(rng.randrange(256) for _ in range(n)) for n in lens]
    rows = torch.zeros((len(msgs), 576), dtype=torch.uint8)
    for i, m in enumerate(msgs):
        rows[i, :len(m)] = torch.tensor(list(m), dtype=torch.uint8)
    got = keccak256_rows(rows, torch.tensor(lens))
    assert [bytes(r.tolist()) for r in got] == [oracle(m) for m in msgs]


def _pop(seed, accounts=1024, tampered=16):
    return make_population(seed, accounts=accounts, virtual=V, max_nodes=12, node_len=576,
                           tampered=tampered)


def _table(pop):
    pn = pop.proof_nodes
    ids = pn.clamp(min=0)
    return pop.nodes[ids], torch.where(pn >= 0, pop.node_lens[ids], 0)


def test_population_repeats_for_a_seed():
    a, b, c = _pop(2**31 + 5), _pop(2**31 + 5), _pop(2**31 + 6)
    for f in ("nodes", "node_lens", "proof_nodes", "keys", "root", "intent"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert not torch.equal(a.root, c.root)
    assert int((a.intent == INVALID).sum()) == int((c.intent == INVALID).sum()) == 16


def test_depths_and_fan_out_follow_the_virtual_trie():
    pop = _pop(11, accounts=4096, tampered=0)
    lens = pop.proof_lens.numpy()
    for n_nodes in (8, 9, 10):
        want = depth_tail(n_nodes - 2, V) - depth_tail(n_nodes - 1, V)
        assert abs((lens == n_nodes).mean() - want) < 0.04, (n_nodes, want)
    assert lens.min() >= 7 and lens.max() <= 12
    nodes, node_lens = _table(pop)
    ar = torch.arange(pop.size)
    # branches down to depth 5 are full: 16 children, 532 bytes
    assert bool((node_lens[:, :6] == 532).all())
    # a branch at depth 6 expects 16 keys besides the path's, so about 10.5
    # children; from depth 7 on it holds two or three
    children = (node_lens[:, :-1] - 2 - 17) // 32
    at6 = children[pop.proof_lens > 8, 6].float().mean().item()
    assert 9.0 <= at6 <= 12.0, at6
    deep = children[:, 7:][(node_lens[:, 8:] > 0) & (node_lens[:, 7:-1] > 0)]
    assert 2.0 <= deep.float().mean().item() <= 3.0
    last = node_lens[ar, pop.proof_lens - 2]
    assert int(((last - 2 - 17) // 32).min()) >= 2
    leaf = node_lens[ar, pop.proof_lens - 1]
    assert 95 <= int(leaf.min()) and int(leaf.max()) <= 145


def test_paths_share_their_prefix_nodes():
    pop = _pop(12, accounts=2048, tampered=0)
    nib = torch.stack([pop.keys.to(torch.int64) >> 4, pop.keys.to(torch.int64) & 15],
                      2).reshape(pop.size, 64)
    for j in range(5):
        prefixes = {tuple(r) for r in nib[:, :j].tolist()}
        assert torch.unique(pop.proof_nodes[:, j]).numel() == len(prefixes)
    assert torch.unique(pop.proof_nodes[:, 0]).numel() == 1


def test_reference_verdicts():
    pop = _pop(13)
    nodes, lens = _table(pop)
    roots = pop.root.expand(pop.size, 32)
    s, v, n = verify(nodes, lens, pop.proof_lens, roots, pop.keys)
    assert torch.equal(s, pop.intent)
    assert torch.equal(n, pop.value_lens)
    ar = torch.arange(128)[None]
    leaf = nodes[torch.arange(pop.size), pop.proof_lens - 1]
    want = torch.gather(leaf, 1, (pop.value_start[:, None] + ar).clamp(max=575))
    assert torch.equal(v, torch.where(ar < pop.value_lens[:, None], want, 0))
    found = (pop.intent == FOUND).nonzero().squeeze(1)[:64]
    # a flipped byte in any node, or another root: INVALID
    bad = nodes[found].clone()
    rng = np.random.default_rng(3)
    for k, i in enumerate(found.tolist()):
        j = int(rng.integers(int(pop.proof_lens[i])))
        bad[k, j, int(rng.integers(int(lens[i, j])))] ^= 0x40
    s2, _, n2 = verify(bad, lens[found], pop.proof_lens[found], roots[found], pop.keys[found])
    assert bool((s2 == INVALID).all()) and int(n2.sum()) == 0
    other = roots[found].clone()
    other[:, 0] ^= 1
    s3, _, _ = verify(nodes[found], lens[found], pop.proof_lens[found], other, pop.keys[found])
    assert bool((s3 == INVALID).all())
    # the control walks without digests: tampered leaves come back FOUND
    s4, _, _ = verify(nodes, lens, pop.proof_lens, roots, pop.keys, check_hashes=False)
    assert bool((s4[pop.intent == INVALID] == FOUND).all())


@pytest.mark.cuda
def test_reference_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = _pop(14, accounts=512)
    b = make_population(14, accounts=512, virtual=V, max_nodes=12, node_len=576,
                        tampered=16, device="cuda")
    nodes, lens = _table(b)
    s, v, n = verify(nodes, lens, b.proof_lens, b.root.expand(b.size, 32), b.keys)
    assert torch.equal(s.cpu(), b.intent.cpu())
    assert torch.equal(n.cpu(), b.value_lens.cpu())
    assert a.size == b.size
