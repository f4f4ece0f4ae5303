"""K2's hinted variants `hinted4`, `hinted1`, `ordered` and `pairskip`
(plain PyTorch; the kernels on the card) vs the JAX package: the overflow
flag and the words against the TPU kernel in interpret mode (one call per
mode, one mixed batch), the results after the `exact` re-run against the XLA
walker `ops.mpt.walk_batch`, and `verify_proofs_pooled(hint_mode=...)` with
and without depth segments. Bit-exact."""

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
from zk_state_proofs_tpu_torch.witness import host_item_offsets

VARIANTS = ("hinted4", "hinted1", "ordered", "pairskip")
_jax_walk = jax.jit(jmpt.walk_batch, static_argnums=(7, 8))


def _trie(tag, n, value, key_len=32):
    t = EthTrie()
    keys = [keccak256(tag + b"-%d" % i)[:key_len] for i in range(n)]
    for i, k in enumerate(keys):
        t.insert(k, value(i))
    return t, keys


def _long_slot_node():
    """A 17-item list whose items 0 and 1 are empty strings, item 2 a
    60-byte string (a long-form header in branch slot 2, inside its
    bound) and the rest empty: `hinted` latches on it, `hinted4` does not."""
    return rlp.encode([b"", b"", b"\x5a" * 60] + [b""] * 14)


def _entries():
    """(entries, rows): one mixed batch of small tries (nodes under 256 B,
    which keeps the interpret-mode runs short), and the row ranges of its
    parts."""
    t, keys = _trie(b"hm", 8, lambda i: b"\x09" + bytes([i]) * 40)
    root = t.root_hash()
    honest = [(root, t.get_proof(k), k) for k in keys[:4]]
    absent = keccak256(b"hm-absent")
    crafted = rlp.encode([b"\x01"])
    bad = [bytearray(x) for x in t.get_proof(keys[4])]
    bad[-1][5] ^= 1
    branch = [b""] * 17
    branch[keys[5][0] >> 4] = b"\x07" * 31
    crafted2 = rlp.encode(branch)
    adversarial = [
        (root, t.get_proof(absent), absent),                 # EXCLUDED
        (b"\x31" * 32, t.get_proof(keys[1]), keys[1]),       # root miss
        (root, t.get_proof(keys[2])[:1], keys[2]),           # hash miss
        (keccak256(crafted), [crafted], keys[3]),            # malformed
        (root, [bytes(x) for x in bad], keys[4]),            # corrupted node
        (keccak256(crafted2), [crafted2], keys[5]),          # bad child ref
    ]
    ti, ikeys = _trie(b"hm-inl", 10, lambda i: rlp.int_to_min_bytes(i + 1), 6)
    inline = [(ti.root_hash(), ti.get_proof(k), k) for k in ikeys[:4]]
    # the root last: `ordered` latches at step 0
    unordered = [(root, t.get_proof(k)[::-1], k) for k in keys[5:8]]
    long_slot = _long_slot_node()
    key2 = bytes([0x20]) + b"\x00" * 31  # first nibble 2: the long item
    special = [(keccak256(long_slot), [long_slot], key2),
               (root, t.get_proof(keys[6]), keys[6])]      # corrupted hints
    parts = [honest, adversarial, inline, unordered, special]
    rows, off = {}, 0
    for name, part in zip(("honest", "adversarial", "inline", "unordered", "special"), parts):
        rows[name] = slice(off, off + len(part))
        off += len(part)
    return [e for part in parts for e in part], rows


def _batch():
    """Packed arrays (numpy), digests and hints of the mixed batch; the
    corrupted-hints row gets its hints shifted."""
    entries, rows = _entries()
    packed = pack_proofs(entries, node_len=256)
    nodes, lens, num, roots, knib, klen = packed.astuple()
    b, d, n = nodes.shape
    hints = host_item_offsets(nodes.reshape(b * d, n)).reshape(b, d, 36)
    hints[rows["special"].stop - 1, 0, 7] ^= 0x04
    dig = tmpt.hash_nodes(torch.from_numpy(nodes), torch.from_numpy(lens)).numpy()
    return (nodes, lens, num, dig, roots, knib, klen), hints, rows


@pytest.fixture(scope="module")
def batch():
    return _batch()


def _jax_lanes(mode, arrays, hints, max_steps):
    """The TPU kernel in `mode` (interpret mode here), one tile of 128
    lanes: the six output words per proof."""
    nodes, lens, num, dig, roots, knib, klen = arrays
    b, _, n = nodes.shape
    assert b <= 128 and n % 4 == 0
    pad = lambda a: np.pad(a, [(0, 128 - b)] + [(0, 0)] * (a.ndim - 1))
    lanes = lambda a: mpt_pallas._lanes(jnp.asarray(pad(a)), 1, 1)
    words = lambda a: np.asarray(mpt_pallas._to_words(jnp.asarray(a)))
    out = mpt_pallas._walk_lanes(
        lanes(words(nodes)), lanes(lens.astype(np.int32)), lanes(num.astype(np.int32)),
        lanes(words(dig)), lanes(words(roots)), lanes(knib.astype(np.int32)),
        lanes(klen.astype(np.int32)), lanes(words(hints)), max_steps=max_steps, mode=mode)
    return np.asarray(out).transpose(0, 2, 3, 1).reshape(128, 6)[:b]


def _plain(mode, arrays, hints, max_steps):
    t = [torch.from_numpy(np.asarray(a)) for a in arrays]
    out, _ = tmpt.walk_kernel_plain(mode, *t, 64, max_steps,
                                    hints=torch.from_numpy(hints))
    return out.numpy()


@pytest.mark.parametrize("mode", VARIANTS)
def test_variant_flag_and_words_match_tpu_kernel(batch, mode):
    """The flag equals the TPU kernel's on every proof, the other words
    wherever it is 0 (and there equal the exact walk's)."""
    arrays, hints, rows = batch
    steps = arrays[0].shape[1] + 6
    got = _plain(mode, arrays, hints, steps)
    want = _jax_lanes(mode, arrays, hints, steps)
    exact = _plain("exact", arrays, hints, steps)
    np.testing.assert_array_equal(got[:, 4], want[:, 4])
    ok = got[:, 4] == 0
    words = [0, 1, 2, 3, 5]
    np.testing.assert_array_equal(got[ok][:, words], want[ok][:, words])
    np.testing.assert_array_equal(got[ok][:, words], exact[ok][:, words])
    hinted = _plain("hinted", arrays, hints, steps)
    long_slot, bad_hints = rows["special"].start, rows["special"].stop - 1
    assert hinted[long_slot, 4] == 1 and got[bad_hints, 4] == 1
    assert (got[rows["honest"], 4] == 0).all() and (got[rows["inline"], 4] == 1).all()
    if mode == "hinted4":
        assert got[long_slot, 4] == 0 and got[long_slot, 0] == tmpt.INVALID
        differ = np.flatnonzero(got[:, 4] != hinted[:, 4])
        assert differ.tolist() == [long_slot]
    elif mode == "ordered":
        assert (got[rows["unordered"], 4] == 1).all()
        assert (got[:, 4] >= hinted[:, 4]).all()
    else:  # the same function as hinted
        np.testing.assert_array_equal(got, hinted)


def test_walk_with_fallback_matches_walk_batch(batch):
    """walk_batch_cuda(hint_mode=m) (the plain version on the CPU) in each
    hinted mode against the XLA walker: status, values, lengths and
    reasons."""
    arrays, hints, _ = batch
    a = [jnp.asarray(x) for x in arrays]
    want = [np.asarray(x) for x in _jax_walk(*a, 64, None)]
    t = [torch.from_numpy(np.asarray(x)) for x in arrays]
    before = dict(mpt_cuda.LAUNCHES)
    for mode in ("hinted",) + VARIANTS:
        *got, ovf = mpt_cuda.walk_batch_cuda(*t, 64, hints=torch.from_numpy(hints),
                                             with_reasons=True, with_overflow=True,
                                             hint_mode=mode)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), w, mode)
        assert int(ovf.sum()) > 0
    assert mpt_cuda.LAUNCHES == before  # CPU tensors take the plain version


def test_pooled_hint_modes_segmented_match_unsegmented_and_jax():
    """verify_proofs_pooled(hint_mode=m) on a depth-sorted batch: with
    depth segments equal to the unsegmented call (a None max_steps resolves
    from the global node axis), and to the JAX package's pooled verify."""
    t, keys = _trie(b"hm-seg", 64, lambda i: b"\x0c" + bytes([i]) * 40)
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys[:24]]
    entries.sort(key=lambda e: -len(e[1]))
    packed = pack_proofs(entries)
    segs = packed.depth_segments(tile=8)
    assert len(segs) >= 2
    want = jmpt.verify_proofs_pooled(*packed.astuple(), *packed.pool(),
                                     packed.pool_hints(), max_value_len=64)
    args = [torch.from_numpy(np.asarray(x)) for x in
            packed.astuple() + packed.pool() + (packed.pool_hints(),)]
    for mode in ("hinted",) + VARIANTS:
        ref = tmpt.verify_proofs_pooled(*args, max_value_len=64, hint_mode=mode)
        seg = tmpt.verify_proofs_pooled(*args, max_value_len=64, hint_mode=mode,
                                        depth_segments=segs)
        for w, r, s in zip(want, ref, seg):
            np.testing.assert_array_equal(r.numpy(), np.asarray(w), mode)
            np.testing.assert_array_equal(s.numpy(), np.asarray(w), mode)
        assert (ref[0].numpy() == tmpt.FOUND).all(), mode


def test_unknown_hint_mode_raises(batch):
    arrays, hints, _ = batch
    t = [torch.from_numpy(np.asarray(x)) for x in arrays]
    h = torch.from_numpy(hints)
    for bad in ("bounded", "exact", "hinted2"):
        with pytest.raises(ValueError):
            mpt_cuda.walk_batch_cuda(*t, 64, hints=h, hint_mode=bad)
    with pytest.raises(ValueError):
        tmpt.walk_kernel_plain("sorted", *t, 64, 8, hints=h)
    with pytest.raises(ValueError):
        tmpt.walk_kernel_plain("ordered", *t, 64, 8)  # a hinted mode needs hints
