"""K2 `bounded` mode (plain PyTorch; the kernel on the card) vs the JAX
package: the overflow flag and the words against the TPU kernel in
interpret mode (one call, one mixed batch), and the results after the
`exact` re-run against the XLA walker `ops.mpt.walk_batch`. Bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zk_state_proofs_tpu.oracle import EthTrie, keccak256, rlp
from zk_state_proofs_tpu.ops import mpt as jmpt
from zk_state_proofs_tpu.ops import mpt_pallas
from zk_state_proofs_tpu.witness import pack_proofs
from zk_state_proofs_tpu_torch.ops import mpt as tmpt
from zk_state_proofs_tpu_torch.ops import mpt_cuda

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's thread pools from oversubscribing its cores.
torch.set_num_threads(1)

_jax_walk = jax.jit(jmpt.walk_batch, static_argnums=(7, 8))
ROWS = 24  # one JAX batch shape per bucket
_PAD = (b"\x00" * 31 + b"\x01", [], b"\x00")


def _trie(tag, n, value, key_len=32):
    t = EthTrie()
    keys = [keccak256(tag + b"-%d" % i)[:key_len] for i in range(n)]
    for i, k in enumerate(keys):
        t.insert(k, value(i))
    return t, keys


def _honest_and_adversarial():
    t, keys = _trie(b"bnd", 64, lambda i: b"\x09" + bytes([i]) * 40)
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys[:10]]
    absent = keccak256(b"bnd-absent")
    entries.append((root, t.get_proof(absent), absent))            # EXCLUDED
    entries.append((b"\x31" * 32, t.get_proof(keys[1]), keys[1]))  # root miss
    entries.append((root, t.get_proof(keys[2])[:1], keys[2]))      # hash miss
    crafted = rlp.encode([b"\x01"])
    entries.append((keccak256(crafted), [crafted], keys[3]))       # malformed
    bad = [bytearray(x) for x in t.get_proof(keys[4])]
    bad[-1][5] ^= 1
    entries.append((root, [bytes(x) for x in bad], keys[4]))       # corrupt
    branch = [b""] * 17
    branch[keys[5][0] >> 4] = b"\x07" * 31
    crafted2 = rlp.encode(branch)
    entries.append((keccak256(crafted2), [crafted2], keys[5]))     # bad child ref
    return entries


def _inline(n_proofs=8):
    """A storage-like trie with 6-byte keys and tiny values: inline
    (< 32 B) children on the walk."""
    t, keys = _trie(b"bnd-inl", 48, lambda i: rlp.int_to_min_bytes(i + 1), 6)
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys[:n_proofs]]
    absent = b"\xfe" * 6
    return entries + [(root, t.get_proof(absent), absent)]


def _over_bound(n_items17=17):
    """Well-formed RLP whose items exceed the branch/pair bounds (the JAX
    package's test_pallas_bounded_decode_overflow_fallback nodes)."""
    key = keccak256(b"bnd-ovf")
    pair = rlp.encode([b"\x11" * 100, b"\x22"])
    wide = rlp.encode([b"\x33" * 40] * n_items17)
    return [(keccak256(pair), [pair], key), (keccak256(wide), [wide], key)]


def _past_buffer_node(n: int) -> np.ndarray:
    """A 17-item node in an n-byte buffer (n % 4 == 0, 536 <= n <= 568)
    whose item 16 starts at byte n, past the buffer, within its bound
    (n <= 10 + 35*16). The clamped exact fetch reads byte n - 1 (0x80: an
    empty item 16, list end n + 1); the TPU kernel's bounded fetch reads
    byte n - 4 (0x81: a 2-byte item 16, end n + 2: malformed)."""
    node = np.zeros(n, np.uint8)
    payload = n + 1 - 3
    node[:3] = [0xF9, payload >> 8, payload & 0xFF]
    pos = 3
    for _ in range(15):                       # items 0..14: 33-byte hash refs
        node[pos] = 0xA0
        node[pos + 1:pos + 33] = 0x44
        pos += 33
    node[pos:pos + 2] = [0xB8, n - pos - 2]   # item 15 ends at byte n
    node[pos + 2:n] = 0x55
    node[n - 4], node[n - 1] = 0x81, 0x80
    return node


def _pack(entries, node_len, max_nodes=8):
    entries = list(entries)
    return pack_proofs(entries + [_PAD] * (ROWS - len(entries)),
                       max_nodes=max_nodes, node_len=node_len, key_nibbles=64)


def _put_past_buffer_node(packed, row, node, length):
    """Row `row` becomes a one-node proof of `node` (stored length
    `length` > the buffer) with key length 0, rooted at its digest."""
    packed.nodes[row] = 0
    packed.nodes[row, 0] = node
    packed.node_lens[row] = 0
    packed.node_lens[row, 0] = length
    packed.num_nodes[row] = 1
    packed.key_nibbles[row] = 0
    packed.key_lens[row] = 0
    t = [torch.from_numpy(packed.nodes[row:row + 1, :1]),
         torch.from_numpy(packed.node_lens[row:row + 1, :1])]
    packed.roots[row] = tmpt.hash_nodes(*t)[0, 0].numpy()


def _fuzz(packed, seed, max_len):
    """Random byte flips in live node bytes and random lengths in
    [0, max_len); returns the digests of the unflipped nodes, so the walk
    decodes the flipped bytes."""
    t = [torch.from_numpy(np.asarray(a)) for a in packed.astuple()]
    digests = tmpt.hash_nodes(t[0], t[1]).numpy()
    rng = np.random.default_rng(seed)
    b, d, _ = packed.nodes.shape
    for i in range(b):
        for j in range(int(packed.num_nodes[i])):
            n = int(packed.node_lens[i, j])
            for pos in rng.integers(0, max(n, 1), rng.integers(0, 3)):
                packed.nodes[i, j, pos] = rng.integers(0, 256)
            if rng.random() < 0.15:
                packed.node_lens[i, j] = rng.integers(0, max_len)
    return digests


def _compare(packed, digests=None):
    """Port's unhinted walk (bounded + exact re-run) and entry points vs
    the JAX XLA walker on the same bytes; returns the bounded flags."""
    a = [jnp.asarray(x) for x in packed.astuple()]
    t = [torch.from_numpy(np.asarray(x)) for x in packed.astuple()]
    if digests is None:
        dig, tdig = jmpt.hash_nodes(a[0], a[1]), tmpt.hash_nodes(t[0], t[1])
    else:
        dig, tdig = jnp.asarray(digests), torch.from_numpy(digests)
    want = [np.asarray(x) for x in _jax_walk(*a[:3], dig, *a[3:], 128, None)]
    *got, ovf = mpt_cuda.walk_batch_cuda(*t[:3], tdig, *t[3:], 128,
                                         with_reasons=True, with_overflow=True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)
    if digests is None:
        for w, g in zip(want, tmpt.verify_proofs_diagnose(*t)):
            np.testing.assert_array_equal(g.numpy(), w)
    return want[0], ovf.numpy()


def test_bounded_serves_honest_adversarial_and_inline_batches():
    before = dict(mpt_cuda.LAUNCHES)
    status, ovf = _compare(_pack(_honest_and_adversarial() + _inline(7), 576))
    assert (status[:10] == tmpt.FOUND).all() and (status[16:23] == tmpt.FOUND).all()
    assert (ovf == 0).all()  # bounded serves inline steps without latching
    assert mpt_cuda.LAUNCHES == before  # CPU tensors take the plain version


def test_bounded_over_bound_nodes_latch_and_match_walk_batch():
    entries = _honest_and_adversarial()[:4] + _over_bound()
    status, ovf = _compare(_pack(entries, 704))
    assert (status[:4] == tmpt.FOUND).all()
    assert (ovf[4:6] == 1).all() and (ovf[:4] == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_bounded_fuzzed_nodes_match_walk_batch(seed):
    packed = _pack(_honest_and_adversarial() + _inline(6), 576)
    digests = _fuzz(packed, seed, 576)
    status, _ = _compare(packed, digests)
    assert len(set(status.tolist())) >= 2


def test_bounded_narrow_bucket_and_past_buffer_node():
    """node_len 64: item cursors pass the 64-byte buffer (N4) without
    passing their bounds. A node stored longer than its buffer makes the
    TPU kernel's unlatched bounded result differ from exact there; the
    port latches and re-runs in exact."""
    t, keys = _trie(b"bnd-narrow", 3, lambda i: b"\x05" * (i + 1), 6)
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys]
    packed = _pack(entries, 64)
    node = np.zeros(64, np.uint8)
    node[:2] = [0xF8, 81]                       # list end 83, past the buffer
    node[2], node[3:35] = 0xA0, 0x11
    node[35], node[36:64] = 0xA0, 0x22
    node[60:64] = [0x81, 0x80, 0x80, 0x80]
    _put_past_buffer_node(packed, 3, node, 200)
    packed.key_lens[3], packed.key_nibbles[3, 0] = 64, 5
    status, ovf = _compare(packed, tmpt.hash_nodes(
        torch.from_numpy(packed.nodes), torch.from_numpy(packed.node_lens)).numpy())
    assert (status[:3] == tmpt.FOUND).all() and (ovf[:3] == 0).all()
    assert status[3] == tmpt.EXCLUDED and ovf[3] == 1
    # the same batch with the node at its honest length: no latch
    packed.node_lens[3, 0] = 64
    assert (_compare(packed)[1] == 0).all()


def _jax_bounded_lanes(nodes, lens, num, dig, roots, knib, klen, max_steps):
    """The TPU kernel in `bounded` mode (interpret mode here), one tile of
    128 lanes: the six output words per proof."""
    b, _, n = nodes.shape
    assert b <= 128 and n % 4 == 0
    pad = lambda a: np.pad(a, [(0, 128 - b)] + [(0, 0)] * (a.ndim - 1))
    lanes = lambda a: mpt_pallas._lanes(jnp.asarray(pad(a)), 1, 1)
    words = lambda a: mpt_pallas._to_words(jnp.asarray(a))
    out = mpt_pallas._walk_lanes(
        lanes(np.asarray(words(nodes))), lanes(lens.astype(np.int32)),
        lanes(num.astype(np.int32)), lanes(np.asarray(words(dig))),
        lanes(np.asarray(words(roots))), lanes(knib.astype(np.int32)),
        lanes(klen.astype(np.int32)), max_steps=max_steps, mode="bounded")
    return np.asarray(out).transpose(0, 2, 3, 1).reshape(128, 6)[:b]


def test_bounded_flag_and_words_match_tpu_kernel():
    """One interpret-mode call of the TPU kernel on one mixed batch (N =
    568, under the 570-byte bound of item 16): honest, adversarial,
    inline, over-bound, past-buffer and fuzzed proofs. The flag equals the
    TPU kernel's, and the other words wherever it is 0 — except where the
    TPU kernel's unlatched result differs from exact, where the port
    latches instead."""
    n = 568
    base = _honest_and_adversarial() + _inline() + _over_bound(n_items17=13)
    clean = pack_proofs(base + [_PAD] * 4, max_nodes=6, node_len=n)
    _put_past_buffer_node(clean, len(base), _past_buffer_node(n), 600)
    fuzzed = pack_proofs(base + [_PAD] * 4, max_nodes=6, node_len=n)
    fuzz_dig = _fuzz(fuzzed, 7, 640)
    arrays = [np.concatenate([a, b]) for a, b in zip(clean.astuple(), fuzzed.astuple())]
    nodes, lens, num, roots, knib, klen = arrays
    t = [torch.from_numpy(a) for a in arrays]
    dig = tmpt.hash_nodes(t[0], t[1]).numpy()
    dig[len(base) + 4:] = fuzz_dig
    steps = nodes.shape[1] + 6
    targs = (t[0], t[1], t[2], torch.from_numpy(dig), *t[3:], 64, steps)
    got, _ = tmpt.walk_kernel_plain("bounded", *targs)
    exact, _ = tmpt.walk_kernel_plain("exact", *targs)
    got, exact = got.numpy(), exact.numpy()
    want = _jax_bounded_lanes(nodes, lens, num, dig, roots, knib, klen, steps)
    words = [0, 1, 2, 3, 5]
    fault = (want[:, 4] == 0) & (want[:, words] != exact[:, words]).any(1)
    np.testing.assert_array_equal(got[:, 4], want[:, 4] | fault)
    ok = got[:, 4] == 0
    np.testing.assert_array_equal(got[ok][:, words], want[ok][:, words])
    np.testing.assert_array_equal(got[ok][:, words], exact[ok][:, words])
    assert fault[len(base)] and fault.sum() == 1  # the past-buffer node only
    assert want[:, 4].sum() >= 2 and (want[:len(base) - 2, 4] == 0).all()
