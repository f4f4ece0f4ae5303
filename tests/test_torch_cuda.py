"""Kernels K1 and K2 against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs on a machine with PyTorch alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest configures JAX.)
"""

import numpy as np
import pytest
import torch

from zk_state_proofs_tpu.oracle import EthTrie, keccak256, rlp
from zk_state_proofs_tpu.witness import pack_proofs
from zk_state_proofs_tpu.witness.pack import host_item_offsets
from zk_state_proofs_tpu_torch.ops import keccak as tkeccak
from zk_state_proofs_tpu_torch.ops import keccak_cuda, mpt, mpt_cuda
from zk_state_proofs_tpu_torch.witness_bridge import (BATCH_FIELDS,
                                                      packed_to_tensors)

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
    # a column slice (row stride 576, width 300) hashes in place
    short = lens.clamp(max=300)
    assert torch.equal(keccak_cuda.keccak256_cuda(rows[:, :300], short),
                       tkeccak.keccak256(rows[:, :300], short))


def _batch():
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
    return pack_proofs(entries, max_nodes=8, node_len=576)


@pytest.mark.parametrize("mode", ["hinted", "exact"])
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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_kernel_matches_plain_on_fuzzed_batch(dev, seed):
    """Random byte flips in node bytes and lengths (walked against the
    digests of the unflipped nodes, so the flips are decoded), and random
    hint bytes: the kernel's six words and values equal the plain walk's
    in both modes."""
    packed = _batch()
    t = packed_to_tensors(packed, dev, pool=False)
    dig = mpt.hash_nodes(t["nodes"], t["node_lens"])  # of the unflipped nodes
    rng = np.random.default_rng(seed)
    bb, d, n = packed.nodes.shape
    for i in range(bb):
        for j in range(int(packed.num_nodes[i])):
            ln = int(packed.node_lens[i, j])
            for pos in rng.integers(0, ln, rng.integers(0, 3)):
                packed.nodes[i, j, pos] = rng.integers(0, 256)
            if rng.random() < 0.1:
                packed.node_lens[i, j] = rng.integers(0, n)
    t = packed_to_tensors(packed, dev, pool=False)
    b = [t[k] for k in BATCH_FIELDS]
    hints = host_item_offsets(packed.nodes.reshape(bb * d, n)).reshape(bb, d, 36)
    flip = rng.random(hints.shape) < 0.02
    hints = np.where(flip, rng.integers(0, 256, hints.shape, dtype=np.uint8), hints)
    hints = torch.from_numpy(hints).to(dev)
    args = (b[0], b[1], b[2], dig, b[3], b[4], b[5], 128, d + 6)
    for mode in ("hinted", "exact"):
        got = mpt_cuda.walk_lanes(mode, *args, hints=hints)
        torch.cuda.synchronize()
        want = mpt.walk_kernel_plain(mode, *args, hints=hints)
        for g, w in zip(got, want):
            assert torch.equal(g, w), mode
