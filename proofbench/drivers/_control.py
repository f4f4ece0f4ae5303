"""The control: the reference put in the program's place at the entry a
driver's window calls, with the guarantee every configuration states
broken (its walk compares no digest, so tampered proofs come back FOUND).
A run with it installed has to come out not correct. The benchmark's own
runs never install it; `run --control 1` and the tests do."""

from __future__ import annotations

import torch

from proofbench.drivers._common import keys_from_nibbles
from proofbench.reference.mpt import verify


def _walk(nodes, node_lens, num_nodes, roots, key_nibbles, max_value_len):
    s, v, n = verify(nodes, node_lens, num_nodes, roots, keys_from_nibbles(key_nibbles),
                     max_value_len, check_hashes=False)
    return s.to(torch.int32), v, n.to(torch.int32)


def verify_proofs_pooled(nodes, node_lens, num_nodes, roots, key_nibbles, key_lens,
                         pool_nodes, pool_lens, pool_idx, pool_hints=None,
                         max_value_len: int = 128, **_):
    return _walk(nodes, node_lens, num_nodes, roots, key_nibbles, max_value_len)


def verify_proofs_prehashed(nodes, node_lens, num_nodes, digests, roots, key_nibbles,
                            key_lens, hints=None, max_value_len: int = 128, **_):
    return _walk(nodes, node_lens, num_nodes, roots, key_nibbles, max_value_len)


STAND_INS = {"verify_proofs_pooled": verify_proofs_pooled,
             "verify_proofs_prehashed": verify_proofs_prehashed}
