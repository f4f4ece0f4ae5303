"""Port MPT walk (plain PyTorch; kernel K2 on the card) vs the JAX package's
XLA walker `ops.mpt.walk_batch`: status, values, value lengths and reasons,
bit-exact, on honest, adversarial, inline-node, tiny-node, perturbed-padding
and truncated batches; plus the overflow contract of `hinted` mode."""

import ctypes
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zk_state_proofs_tpu.oracle import EthTrie, keccak256, rlp
from zk_state_proofs_tpu.ops import mpt as jmpt
from zk_state_proofs_tpu.witness import pack_proofs
from zk_state_proofs_tpu.witness.pack import host_item_offsets
from zk_state_proofs_tpu_torch.ops import mpt as tmpt
from zk_state_proofs_tpu_torch.ops import mpt_cuda

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's thread pools from oversubscribing its cores.
torch.set_num_threads(1)

_jax_walk = jax.jit(jmpt.walk_batch, static_argnums=(7, 8))


def _trie(tag, n, value):
    t = EthTrie()
    keys = [keccak256(tag + b"-%d" % i) for i in range(n)]
    for i, k in enumerate(keys):
        t.insert(k, value(i))
    return t, keys


BUCKET = dict(max_nodes=8, node_len=576, key_nibbles=64)
ROWS = 24  # one batch shape for the JAX side: a single compile serves most tests
_PAD = (b"\x00" * 31 + b"\x01", [], b"\x00")


def _pack(entries):
    """Pack into the shared bucket, padded to ROWS with empty proofs."""
    entries = list(entries)
    return pack_proofs(entries + [_PAD] * (ROWS - len(entries)), **BUCKET)


def _hints(packed):
    b, d, n = packed.nodes.shape
    return torch.from_numpy(
        host_item_offsets(packed.nodes.reshape(b * d, n)).reshape(b, d, 36))


def _tensors(packed):
    return [torch.from_numpy(np.asarray(a)) for a in packed.astuple()]


def _compare(packed, mvl=128, max_steps=None, hints=None, digests=None):
    """Run the JAX walker and the port (plain walk, and walk_batch_cuda with
    `hints` on the CPU) on the same bytes; assert bit-exact agreement.
    `digests` (u8 [B, D, 32]) replaces the node digests. Returns (status,
    reasons, fast-path overflow flags)."""
    a = [jnp.asarray(x) for x in packed.astuple()]
    dig = jmpt.hash_nodes(a[0], a[1])
    t = _tensors(packed)
    tdig = tmpt.hash_nodes(t[0], t[1])
    np.testing.assert_array_equal(tdig.numpy(), np.asarray(dig))
    if digests is not None:
        dig, tdig = jnp.asarray(digests), torch.from_numpy(digests)
    want = [np.asarray(x) for x in _jax_walk(*a[:3], dig, *a[3:], mvl, max_steps)]
    got = tmpt.walk_batch(*t[:3], tdig, *t[3:], mvl, max_steps)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)
    *res, ovf = mpt_cuda.walk_batch_cuda(*t[:3], tdig, *t[3:], mvl, max_steps,
                                         with_reasons=True, hints=hints,
                                         with_overflow=True)
    for w, g in zip(want, res):
        np.testing.assert_array_equal(g.numpy(), w)
    return want[0], want[3], ovf.numpy()


def _adversarial_entries():
    t, keys = _trie(b"hint", 64, lambda i: b"\x09" + bytes([i]) * 40)
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys[:12]]
    absent = keccak256(b"hint-absent")
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


def test_walk_honest_and_adversarial_match_jax():
    packed = _pack(_adversarial_entries())
    status, reasons, ovf = _compare(packed, hints=_hints(packed))
    assert (status[:12] == tmpt.FOUND).all()
    assert status[12] == tmpt.EXCLUDED
    assert list(reasons[13:18]) == [tmpt.R_ROOT_MISSING, tmpt.R_HASH_MISMATCH,
                                  tmpt.R_MALFORMED, tmpt.R_HASH_MISMATCH,
                                  tmpt.R_BAD_CHILD_REF]
    # inline-free trie, honest hints: the hinted walk serves every proof
    assert (ovf == 0).all()


def test_walk_inline_children_match_jax_and_latch_overflow():
    t = EthTrie()
    keys = [keccak256(b"inl-%d" % i)[:6] for i in range(48)]
    for i, k in enumerate(keys):
        t.insert(k, rlp.int_to_min_bytes(i + 1))  # tiny values -> inline nodes
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys[:10]]
    absent = b"\xfe" * 6
    entries.append((root, t.get_proof(absent), absent))
    packed = _pack(entries)
    status, _, ovf = _compare(packed, hints=_hints(packed))
    assert (status[:10] == tmpt.FOUND).all()
    assert (ovf > 0).any()  # inline steps defer to the exact re-run


def test_walk_single_leaf_tiny_node_matches_jax():
    st = EthTrie()
    slot = keccak256(bytes(32))
    val = rlp.encode_int(39_035_000_000_000)
    st.insert(slot, val)
    proof = st.get_proof(slot)
    packed = pack_proofs([(st.root_hash(), proof, slot)])
    assert packed.nodes.shape[2] // 4 < 64 // 4 + 2  # nw < vw
    status, _, _ = _compare(packed, mvl=64, hints=_hints(packed))
    assert status[0] == tmpt.FOUND
    t = _tensors(packed)
    res = tmpt.walk_batch(*t[:3], tmpt.hash_nodes(t[0], t[1]), *t[3:], 64)
    assert bytes(res[1][0, :int(res[2][0])].numpy()) == val


def test_walk_perturbed_padding_bytes_match_jax():
    packed = _pack(_adversarial_entries())
    t = _tensors(packed)
    base = tmpt.walk_batch(*t[:3], tmpt.hash_nodes(t[0], t[1]), *t[3:], 128)
    packed.nodes[:, :, -1] = 0xAB  # the clamp target, as bench.py perturbs it
    _compare(packed, hints=_hints(packed))
    t = _tensors(packed)
    pert = tmpt.walk_batch(*t[:3], tmpt.hash_nodes(t[0], t[1]), *t[3:], 128)
    for a, b in zip(base, pert):
        assert torch.equal(a, b)


def test_walk_truncation_by_max_steps_matches_jax():
    packed = _pack(_adversarial_entries()[:4])
    status, reasons, _ = _compare(packed, max_steps=1, hints=_hints(packed))
    assert (status[:4] == tmpt.INVALID).all()
    assert (reasons[:4] == tmpt.R_TRUNCATED).all()


def test_hinted_corrupt_hints_latch_and_keep_results():
    t, keys = _trie(b"cor", 32, lambda i: b"\x0a" * 48)
    root = t.root_hash()
    packed = pack_proofs([(root, t.get_proof(k), k) for k in keys[:8]])
    tt = _tensors(packed)
    dig = tmpt.hash_nodes(tt[0], tt[1])
    good = _hints(packed)
    tag = mpt_cuda.next_tag()
    ref = mpt_cuda.walk_batch_cuda(*tt[:3], dig, *tt[3:], 128, with_reasons=True)
    # the re-run flag's tags: the CPU route takes none; they are fresh and
    # never 0 (a slot's value before its first store), and FLAG_RING first
    # walks in a row, queued ahead of their re-runs, take as many slots
    tags = [mpt_cuda.next_tag() for _ in range(mpt_cuda.FLAG_RING)]
    assert tags == list(range(tag + 1, tag + 1 + mpt_cuda.FLAG_RING)) and tag > 0
    slots = {mpt_cuda.flag_slot(t) for t in tags}
    assert slots == set(range(mpt_cuda.FLAG_RING))
    fast, _ = tmpt.walk_kernel_plain("hinted", *tt[:3], dig, *tt[3:], 128, 8,
                                     hints=good)
    assert (fast[:, 4] == 0).all()
    for corrupt in (torch.zeros_like(good), (good + 7) % 255,
                    torch.roll(good, 2, dims=-1)):
        *res, ovf = mpt_cuda.walk_batch_cuda(
            *tt[:3], dig, *tt[3:], 128, with_reasons=True, hints=corrupt,
            with_overflow=True)
        assert (ovf > 0).any()
        for a, b in zip(ref, res):
            assert torch.equal(a, b)


def test_walk_args_layout_checked_once_per_library(monkeypatch):
    """The wrapper holds its `WalkArgs` against the loaded library's size
    once per library: a match is not asked again, a mismatch raises
    RuntimeError before any launch, on every call."""

    class Lib:
        def __init__(self, size):
            self.size, self.asked = size, 0

        def zkp_walk_args_size(self):
            self.asked += 1
            return self.size

    size = ctypes.sizeof(mpt_cuda.WalkArgs)
    loaded = []
    monkeypatch.setattr(mpt_cuda, "load_library", lambda: loaded[-1])
    monkeypatch.setattr(mpt_cuda, "_CHECKED", None)
    good, bad = SimpleNamespace(lib=Lib(size)), SimpleNamespace(lib=Lib(size + 8))
    loaded.append(good)
    assert mpt_cuda._library() is good.lib and mpt_cuda._library() is good.lib
    assert good.lib.asked == 1
    loaded.append(bad)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="WalkArgs layout"):
            mpt_cuda._library()
    assert bad.lib.asked == 2


def test_walk_kernel_plain_rejects_unknown_mode():
    packed = _pack(_adversarial_entries()[:2])
    t = _tensors(packed)
    with pytest.raises(ValueError):
        tmpt.walk_kernel_plain("ordered", *t[:3], tmpt.hash_nodes(t[0], t[1]),
                               *t[3:], 128, 8)


@pytest.mark.parametrize("seed", [0, 1])
def test_walk_fuzzed_nodes_and_hints_match_jax(seed):
    """Random byte flips in live node bytes (headers included) and in the
    lengths, walked against the digests of the unflipped nodes so the
    flipped bytes are decoded: every decode path, clamp and latch is
    compared with the JAX walker, and the hinted walk with random hints
    must still equal it."""
    packed = _pack(_adversarial_entries())
    t = _tensors(packed)
    digests = tmpt.hash_nodes(t[0], t[1]).numpy()
    rng = np.random.default_rng(seed)
    b, d, _ = packed.nodes.shape
    for i in range(b):
        for j in range(int(packed.num_nodes[i])):
            n = int(packed.node_lens[i, j])
            for pos in rng.integers(0, n, rng.integers(0, 3)):
                packed.nodes[i, j, pos] = rng.integers(0, 256)
            if rng.random() < 0.1:
                packed.node_lens[i, j] = rng.integers(0, 576)
    hints = _hints(packed)
    flip = torch.from_numpy(rng.random(hints.shape) < 0.02)
    noisy = torch.where(flip, torch.from_numpy(
        rng.integers(0, 256, hints.shape, dtype=np.uint8)), hints)
    status, reasons, _ = _compare(packed, hints=noisy, digests=digests)
    assert len(set(reasons.tolist())) >= 3  # the flips reach several outcomes
