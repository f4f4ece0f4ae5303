"""Port keccak (plain PyTorch; kernel K1 on the card) vs the JAX package's
plain keccak and the oracle. Bit-exact, zero tolerance."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zk_state_proofs_tpu.oracle import EthTrie, keccak256 as oracle_keccak, rlp
from zk_state_proofs_tpu.ops import keccak as jkeccak
from zk_state_proofs_tpu.ops import mpt as jmpt
from zk_state_proofs_tpu.witness import pack_proofs
from zk_state_proofs_tpu_torch.ops import keccak as tkeccak
from zk_state_proofs_tpu_torch.ops import keccak_cuda
from zk_state_proofs_tpu_torch.ops import mpt as tmpt

EDGE_LENS = [0, 1, 135, 136, 137, 271, 272, 535, 536, 576]


def _rows(seed=0, width=576):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (len(EDGE_LENS) + 2, width), dtype=np.uint8)
    lens = np.asarray(EDGE_LENS + [0, 0], dtype=np.int32)
    data[-2:] = 0  # zero-length zero rows, like reserved pool row 0
    return data, lens


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 63])
def test_rotl64(n):
    rng = np.random.default_rng(n)
    xs = [int(x) for x in rng.integers(0, 2**63, 8, dtype=np.uint64)] + [2**64 - 1, 1]
    hi = torch.tensor([x >> 32 for x in xs], dtype=torch.int64)
    lo = torch.tensor([x & 0xFFFFFFFF for x in xs], dtype=torch.int64)
    nh, nl = tkeccak.rotl64(hi, lo, n)
    for i, x in enumerate(xs):
        want = ((x << n) | (x >> (64 - n))) & (2**64 - 1) if n else x
        assert (int(nh[i]) << 32) | int(nl[i]) == want
        assert 0 <= int(nh[i]) < 2**32 and 0 <= int(nl[i]) < 2**32


def test_lane_packing_roundtrip():
    rng = np.random.default_rng(1)
    block = torch.from_numpy(rng.integers(0, 256, (3, 136), dtype=np.uint8))
    hi, lo = tkeccak.bytes_to_lanes(block)
    assert hi.shape == (3, 17)
    assert torch.equal(tkeccak.lanes_to_bytes(hi, lo), block)
    jhi, jlo = jkeccak.bytes_to_lanes(jnp.asarray(block.numpy()))
    np.testing.assert_array_equal(np.asarray(jhi).astype(np.int64), hi.numpy())
    np.testing.assert_array_equal(np.asarray(jlo).astype(np.int64), lo.numpy())


def test_pad_messages_matches_jax():
    data, lens = _rows(2)
    want = np.asarray(jkeccak.pad_messages(jnp.asarray(data), jnp.asarray(lens), 5))
    got = tkeccak.pad_messages(torch.from_numpy(data), torch.from_numpy(lens), 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_keccak_edge_lengths_match_jax_and_oracle():
    data, lens = _rows(3)
    got = tkeccak.keccak256(torch.from_numpy(data), torch.from_numpy(lens)).numpy()
    want = np.asarray(jkeccak.keccak256(jnp.asarray(data), jnp.asarray(lens)))
    np.testing.assert_array_equal(got, want)
    for i, n in enumerate(lens):
        assert bytes(got[i]) == oracle_keccak(bytes(data[i, :n])), n
    # the CPU dispatch of the kernel wrapper is the plain version
    before = dict(keccak_cuda.LAUNCHES)
    disp = keccak_cuda.keccak256_cuda(torch.from_numpy(data), torch.from_numpy(lens))
    np.testing.assert_array_equal(disp.numpy(), got)
    assert keccak_cuda.LAUNCHES == before


def test_padding_bytes_do_not_change_digest():
    data, lens = _rows(4)
    noisy = data.copy()
    rng = np.random.default_rng(5)
    for i, n in enumerate(lens):
        noisy[i, n:] = rng.integers(0, 256, data.shape[1] - n, dtype=np.uint8)
    a = tkeccak.keccak256(torch.from_numpy(data), torch.from_numpy(lens))
    b = tkeccak.keccak256(torch.from_numpy(noisy), torch.from_numpy(lens))
    assert torch.equal(a, b)


def _pool():
    t = EthTrie()
    keys = [oracle_keccak(b"kpool-%d" % i) for i in range(48)]
    for i, k in enumerate(keys):
        t.insert(k, b"\x03" + bytes([i]) * 60)
    root = t.root_hash()
    packed = pack_proofs([(root, t.get_proof(k), k) for k in keys[:24]],
                         node_len=576)
    return packed


def test_segmented_pool_hash_matches_jax():
    packed = _pool()
    pool_nodes, pool_lens, _ = packed.pool()
    segs = packed.pool_block_segments(tile=32)
    assert len(segs) >= 2
    want = np.asarray(jmpt._hash_pool_rows(jnp.asarray(pool_nodes),
                                           jnp.asarray(pool_lens), segs))
    pn, pl = torch.from_numpy(pool_nodes), torch.from_numpy(pool_lens)
    np.testing.assert_array_equal(tmpt._hash_pool_rows(pn, pl, segs).numpy(), want)
    np.testing.assert_array_equal(tmpt._hash_pool_rows(pn, pl).numpy(), want)
    np.testing.assert_array_equal(tmpt.hash_pool(pn, pl).numpy(), want)
    with pytest.raises(ValueError):
        tmpt._hash_pool_rows(pn, pl, ((segs[0][0], segs[0][1]),))
