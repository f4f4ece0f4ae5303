"""The port's pooled verification slice end to end vs the JAX package:
verify_proofs_pooled (hints, depth segments, pool segments), the
diagnostic reasons, the model entry points and BatchVerifier. Bit-exact."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zk_state_proofs_tpu.models import BatchVerifier as JaxBatchVerifier
from zk_state_proofs_tpu.oracle import EthTrie, keccak256, rlp
from zk_state_proofs_tpu.ops import mpt as jmpt
from zk_state_proofs_tpu.utils.config import BucketConfig as JaxBucketConfig
from zk_state_proofs_tpu.witness import pack_proofs
from zk_state_proofs_tpu_torch.models import (BatchVerifier, batch_commitment,
                                              diagnose_batch,
                                              verify_account_batch,
                                              verify_merkle_batch,
                                              verify_merkle_proof,
                                              verify_storage_batch,
                                              verify_storage_grouped)
from zk_state_proofs_tpu_torch.oracle import MissingKeyError, TrieError
from zk_state_proofs_tpu_torch.ops import mpt as tmpt
from zk_state_proofs_tpu_torch.utils.config import BucketConfig
from zk_state_proofs_tpu_torch.witness_bridge import (BATCH_FIELDS, POOL_FIELDS,
                                                      account_entries,
                                                      packed_to_tensors,
                                                      storage_world)


@pytest.fixture(scope="module")
def headline_256():
    """256 distinct account proofs over a 256-account trie (bench recipe)."""
    return pack_proofs(account_entries(256)[0], node_len=576)


def test_pooled_verify_matches_jax(headline_256):
    packed = headline_256
    segs = packed.depth_segments(tile=64)
    psegs = packed.pool_block_segments(tile=64)
    assert len(segs) >= 2 and len(psegs) >= 2
    want = jmpt.verify_proofs_pooled(
        *packed.astuple(), *packed.pool(), packed.pool_hints(),
        max_value_len=128, depth_segments=segs, pool_segments=psegs)
    t = packed_to_tensors(packed, "cpu")
    batch = [t[k] for k in BATCH_FIELDS]
    pool = [t[k] for k in POOL_FIELDS]
    for kw in (dict(depth_segments=segs, pool_segments=psegs), {},
               dict(hinted=False)):
        got = tmpt.verify_proofs_pooled(*batch, *pool, t["pool_hints"], **kw)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(want[0]) == tmpt.FOUND).all()


def _adversarial_packed():
    t = EthTrie()
    keys = [keccak256(b"diag-%d" % i) for i in range(32)]
    for i, k in enumerate(keys):
        t.insert(k, b"\x05" + bytes([i]) * 40)
    root = t.root_hash()
    entries = [(root, t.get_proof(keys[0]), keys[0])]
    absent = keccak256(b"nope")
    entries.append((root, t.get_proof(absent), absent))
    entries.append((b"\x13" * 32, t.get_proof(keys[1]), keys[1]))
    entries.append((root, t.get_proof(keys[2])[:1], keys[2]))
    crafted = rlp.encode([b"\x01"])
    entries.append((keccak256(crafted), [crafted], keys[3]))
    branch = [b""] * 17
    branch[keys[4][0] >> 4] = b"\x07" * 31
    crafted2 = rlp.encode(branch)
    entries.append((keccak256(crafted2), [crafted2], keys[4]))
    return pack_proofs(entries), (t, root, keys)


def test_diagnose_reasons_match_jax():
    packed, _ = _adversarial_packed()
    want = jmpt.verify_proofs_diagnose(*(jnp.asarray(a) for a in packed.astuple()))
    res = diagnose_batch(packed, device="cpu")
    for w, g in zip(want, (res.status, res.values, res.value_lens, res.reasons)):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert list(res.reasons) == [tmpt.R_NONE, tmpt.R_NONE, tmpt.R_ROOT_MISSING,
                                 tmpt.R_HASH_MISMATCH, tmpt.R_MALFORMED,
                                 tmpt.R_BAD_CHILD_REF]
    counts = res.counts()
    assert counts["invalid_root-missing"] == 1
    assert counts["invalid_bad-child-ref"] == 1
    # verify_proofs (unpooled) agrees with the pooled path
    pooled = verify_merkle_batch(packed, device="cpu")
    unpooled = verify_merkle_batch(packed, dedup=False, device="cpu")
    np.testing.assert_array_equal(pooled.status, res.status)
    np.testing.assert_array_equal(unpooled.values, pooled.values)
    assert batch_commitment(pooled) == batch_commitment(unpooled)


def test_verify_merkle_proof_raise_semantics():
    _, (t, root, keys) = _adversarial_packed()
    assert verify_merkle_proof(root, t.get_proof(keys[7]), keys[7], device="cpu") == (
        b"\x05" + bytes([7]) * 40)
    absent = keccak256(b"absent-key")
    with pytest.raises(MissingKeyError):
        verify_merkle_proof(root, t.get_proof(absent), absent, device="cpu")
    with pytest.raises(TrieError) as exc:
        verify_merkle_proof(root, t.get_proof(keys[1]), keys[2], device="cpu")
    assert not isinstance(exc.value, MissingKeyError)


def test_verify_account_batch_decodes_leaves():
    entries, leaves = account_entries(64)
    packed = pack_proofs(entries[:8], node_len=576)
    res, acct = verify_account_batch(packed, device="cpu")
    assert res.all_found and acct["ok"].all()
    for i, (_, _, key) in enumerate(entries[:8]):
        assert res.value(i) == leaves[key]
        leaf = rlp.decode(res.value(i))
        assert bytes(acct["storage_root"][i]) == leaf[2]
        assert bytes(acct["code_hash"][i]) == leaf[3]
        assert int.from_bytes(bytes(acct["nonce"][i]), "big") == int.from_bytes(leaf[0], "big")
        assert int.from_bytes(bytes(acct["balance"][i]), "big") == int.from_bytes(leaf[1], "big")


def test_batch_verifier_matches_jax_service():
    entries, _ = account_entries(96)
    proto = BatchVerifier(BucketConfig.account(), batch_size=64, device="cpu")
    proto.warmup(entries[:64])  # derives the pinned pool bucket
    sorted_batch = proto.pack(sorted(entries[:64], key=lambda e: -len(e[1])))
    segs = sorted_batch.depth_segments(tile=16)
    psegs = sorted_batch.pool_block_segments(tile=16)
    kw = dict(batch_size=64, pool_rows=proto.pool_rows, depth_segments=segs,
              pool_segments=psegs)
    jsvc = JaxBatchVerifier(JaxBucketConfig.account(), **kw)
    tsvc = BatchVerifier(BucketConfig.account(), device="cpu", **kw)
    # skip the JAX warmup's extra compiles; the port warms every route
    jsvc._warm = True
    tsvc.warmup(entries[:64])
    bad = [bytearray(x) for x in entries[70][1]]
    bad[-1][9] ^= 0x40
    absent = keccak256(b"svc-absent")
    requests = [
        entries[:64],                                   # full batch
        entries[64:90],                                 # partial: padding rows
        [(entries[70][0], [bytes(x) for x in bad], entries[70][2]),
         (b"\x31" * 32,) + entries[71][1:],
         (entries[0][0], entries[5][1], absent)] + entries[80:84],  # adversarial
    ]
    for req in requests:
        want, got = jsvc.verify(req), tsvc.verify(req)
        np.testing.assert_array_equal(got.status, want.status)
        np.testing.assert_array_equal(got.values, want.values)
        np.testing.assert_array_equal(got.value_lens, want.value_lens)
    assert (got.status[:3] == tmpt.INVALID).all()
    assert tsvc.stats.batches == 3 and tsvc.stats.proofs == 64 + 26 + 7
    assert tsvc.stats.found == jsvc.stats.found
    with pytest.raises(NotImplementedError):
        BatchVerifier(BucketConfig.account(), mesh=object(), device="cpu")


def test_packed_to_tensors_roundtrip(headline_256):
    packed = headline_256
    t = packed_to_tensors(packed, "cpu")
    arrays = dict(zip(BATCH_FIELDS, packed.astuple()))
    arrays.update(zip(POOL_FIELDS, packed.pool()))
    arrays["pool_hints"] = packed.pool_hints()
    for name, a in arrays.items():
        assert t[name].numpy().dtype == a.dtype, name
        np.testing.assert_array_equal(t[name].numpy(), a)
    assert t["nodes"].dtype == torch.uint8 and t["pool_idx"].dtype == torch.int32


def test_import_loads_neither_jax_nor_cuda():
    """Importing the port, and running the storage and block paths on the
    CPU, loads no JAX, no module of the JAX package and no CUDA."""
    code = (
        "import sys, torch\n"
        "import zk_state_proofs_tpu_torch\n"
        "import zk_state_proofs_tpu_torch.ops.mpt, zk_state_proofs_tpu_torch.ops.mpt_cuda\n"
        "import zk_state_proofs_tpu_torch.ops.keccak_cuda\n"
        "import zk_state_proofs_tpu_torch.models, zk_state_proofs_tpu_torch.witness_bridge\n"
        "assert not torch.cuda.is_initialized(), 'cuda initialised'\n"
        "from zk_state_proofs_tpu_torch.models import verify_storage_grouped\n"
        "from zk_state_proofs_tpu_torch.witness_bridge import storage_world\n"
        "w = storage_world(n_accounts=3, slots_per=2, slots_in_trie=8)\n"
        "res = verify_storage_grouped(*w.pack(), w.slots, w.slot_accounts, device='cpu')\n"
        "assert (res.slot_status == 1).all() and (res.account_status == 1).all()\n"
        "assert [res.slot_value(i) for i in range(6)] == w.slot_values\n"
        "from zk_state_proofs_tpu_torch.models import verify_block_receipts\n"
        "from zk_state_proofs_tpu_torch.models import verify_block_transactions\n"
        "from zk_state_proofs_tpu_torch.witness import synthetic_block\n"
        "from zk_state_proofs_tpu_torch.witness_bridge import tx_geometry_block\n"
        "fx = synthetic_block(num_txs=6, seed=2)\n"
        "r, transfers = verify_block_receipts(fx['block'], fx['receipts'], device='cpu')\n"
        "assert r.all_found and verify_block_transactions(tx_geometry_block(3),\n"
        "                                                 device='cpu').all_found\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'zk_state_proofs_tpu' or m.startswith('zk_state_proofs_tpu.'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized(), 'cuda initialised'\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    packed, _ = _adversarial_packed()
    with pytest.raises(RuntimeError):
        packed_to_tensors(packed, "cuda")
    with pytest.raises(RuntimeError):
        verify_merkle_batch(packed, device="cuda")
    with pytest.raises(RuntimeError):
        BatchVerifier(BucketConfig.account(), device="cuda")
    # the card is the default: a caller who names no device gets no CPU run
    with pytest.raises(RuntimeError):
        verify_merkle_batch(packed)
    with pytest.raises(RuntimeError):
        BatchVerifier(BucketConfig.account())
    w = storage_world(n_accounts=2, slots_per=1, slots_in_trie=4)
    ap, sp = w.pack()
    with pytest.raises(RuntimeError):
        verify_storage_grouped(ap, sp, w.slots, w.slot_accounts)
    with pytest.raises(RuntimeError):
        verify_storage_batch(ap, sp, w.slots)
