"""The port's trie-root reduction (`ops.trie_build`) against the JAX
package's and the oracle, on the plans of tests/test_trie_build.py."""

import random

import numpy as np
import torch

from zk_state_proofs_tpu.ops.trie_build import compute_root as jax_compute_root
from zk_state_proofs_tpu_torch.ops.trie_build import compute_root, compute_root_bytes
from zk_state_proofs_tpu_torch.oracle import EMPTY_ROOT, EthTrie, keccak256, rlp
from zk_state_proofs_tpu_torch.witness import synthetic_block
from zk_state_proofs_tpu_torch.witness.encoding import encode_receipt
from zk_state_proofs_tpu_torch.witness.trie_plan import plan_index_trie, plan_trie

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's thread pools from oversubscribing its cores.
torch.set_num_threads(1)


def _oracle_root(items):
    t = EthTrie()
    for k, v in items:
        t.insert(k, v)
    return t.root_hash()


def _indexed(values):
    return [(rlp.encode_int(i), v) for i, v in enumerate(values)]


def test_compute_root_matches_jax():
    rng = random.Random(0)
    index_values = [bytes(rng.randrange(256) for _ in range(60 + rng.randrange(400)))
                    for _ in range(130)]
    inline_values = [bytes([i + 1]) * (1 + i % 9) for i in range(20)]
    rng = random.Random(1)
    keyed = [(keccak256(b"k%d" % i),
              bytes(rng.randrange(1, 256) for _ in range(rng.randrange(1, 120))))
             for i in range(80)]
    fx = synthetic_block(num_txs=24, seed=21)
    receipts = [encode_receipt(r) for r in fx["receipts"]]
    dogs = [(b"do", b"verb"), (b"dog", b"puppy"), (b"doge", b"coin"),
            (b"horse", b"stallion")]
    rng = random.Random(3)
    multiblock = [bytes(rng.randrange(256) for _ in range(500 + rng.randrange(1500)))
                  for _ in range(40)]
    # (items, pinned root or None, held against the JAX reduction too): the
    # JAX reduction runs eagerly, one compile per level shape, so the
    # larger plans are held against the oracle alone
    cases = [(_indexed(index_values), None, False), (_indexed(inline_values), None, True),
             (keyed, None, False), ([(keccak256(b"solo"), b"v" * 40)], None, True),
             ([], EMPTY_ROOT, True),
             (_indexed(receipts), bytes.fromhex(fx["block"]["receiptsRoot"][2:]), True),
             (dogs, bytes.fromhex(
                 "5991bb8c6514148a29db676a14ac506cd2cd5775ace63c30a4fe457715e9ac84"), True),
             (_indexed(multiblock), None, False)]
    for items, pinned, with_jax in cases:
        plan = plan_trie(items)
        root, digests = compute_root(plan, device="cpu")
        assert bytes(root) == _oracle_root(items)
        if pinned is not None:
            assert bytes(root) == pinned
        assert compute_root_bytes(plan, device="cpu") == bytes(root)
        if with_jax:
            want_root, want = jax_compute_root(plan)
            np.testing.assert_array_equal(root, want_root)
            np.testing.assert_array_equal(digests, want)
    assert plan_index_trie(index_values).num_levels >= 2
