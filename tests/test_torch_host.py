"""The port's own host modules (`oracle`, `witness.pack`, the block
witness modules, `native`) against the JAX package's, whose copies they
are: identical packed arrays, pools, hints and segment schedules, identical
digests, encodings, tries and proofs."""

import numpy as np
import pytest

from zk_state_proofs_tpu import oracle as jax_oracle
from zk_state_proofs_tpu.witness import pack_proofs as jax_pack
from zk_state_proofs_tpu_torch import native, oracle
from zk_state_proofs_tpu_torch.witness import pack_proofs
from zk_state_proofs_tpu_torch.witness_bridge import account_entries, storage_world

ARRAYS = ("nodes", "node_lens", "num_nodes", "roots", "key_nibbles", "key_lens")


def _assert_same_pack(got, want):
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for g, w in zip(got.pool(), want.pool()):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.pool_hints(), want.pool_hints())
    assert got.depth_segments() == want.depth_segments()
    assert got.pool_block_segments() == want.pool_block_segments()
    assert got.depth_segments(tile=32) == want.depth_segments(tile=32)
    assert got.pool_block_segments(tile=32) == want.pool_block_segments(tile=32)


@pytest.fixture(params=["native", "python"])
def host_path(request, monkeypatch):
    """The port's packer with its native library, and without it."""
    if request.param == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    elif not native.available():
        pytest.skip("the native host library does not build here")
    return request.param


def test_pack_matches_jax_on_headline_recipe(host_path):
    entries, _ = account_entries(256)
    _assert_same_pack(pack_proofs(entries, node_len=576), jax_pack(entries, node_len=576))


def test_pack_matches_jax_on_storage_world(host_path):
    w = storage_world(n_accounts=6, slots_per=3, slots_in_trie=24)
    for entries in (w.account_entries, w.storage_entries):
        _assert_same_pack(pack_proofs(entries), jax_pack(entries))
        _assert_same_pack(pack_proofs(entries, max_nodes=8, node_len=576),
                          jax_pack(entries, max_nodes=8, node_len=576))
    ap, sp = w.pack()
    assert ap.batch == 6 and sp.batch == 18
    assert sp.nodes.shape[2] % 4 == 0
    assert sp.nodes.shape[2] >= max(len(n) for _, p, _ in w.storage_entries for n in p) + 4


def test_oracle_keccak_rlp_and_trie_match_jax():
    rng = np.random.default_rng(11)
    for n in (0, 1, 55, 135, 136, 137, 300):
        msg = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert oracle.keccak256(msg) == jax_oracle.keccak256(msg)
        assert native.keccak256(msg) == oracle.keccak256(msg)
    items = [b"", b"\x01", b"\x7f\x80", [b"ab" * 40, [b"c"]], 10**20]
    enc = oracle.rlp.encode([oracle.rlp.int_to_min_bytes(x) if isinstance(x, int) else x
                             for x in items])
    assert enc == jax_oracle.rlp.encode([jax_oracle.rlp.int_to_min_bytes(x)
                                         if isinstance(x, int) else x for x in items])
    assert oracle.rlp.decode(enc) == jax_oracle.rlp.decode(enc)
    ours, theirs = oracle.EthTrie(), jax_oracle.EthTrie()
    keys = [oracle.keccak256(b"host-%d" % i)[: 6 + i % 27] for i in range(60)]
    for i, k in enumerate(keys):
        ours.insert(k, oracle.rlp.encode_int(i + 1))
        theirs.insert(k, jax_oracle.rlp.encode_int(i + 1))
    assert ours.root_hash() == theirs.root_hash()
    for k in keys[::7] + [b"\xee" * 8]:
        assert ours.get_proof(k) == theirs.get_proof(k)
    assert oracle.EMPTY_ROOT == jax_oracle.EMPTY_ROOT
    assert oracle.bytes_to_nibbles(b"\xab\x01") == jax_oracle.bytes_to_nibbles(b"\xab\x01")
    proof = ours.get_proof(keys[3])
    assert oracle.verify_merkle_proof(ours.root_hash(), proof, keys[3]) == \
        jax_oracle.verify_merkle_proof(theirs.root_hash(), proof, keys[3])
    with pytest.raises(oracle.MissingKeyError):
        oracle.verify_merkle_proof(ours.root_hash(), ours.get_proof(b"\xee" * 8), b"\xee" * 8)
    with pytest.raises(oracle.TrieError):
        oracle.verify_merkle_proof(ours.root_hash(), proof[:-1], keys[3])


def test_block_host_copies_match_jax():
    """The port's `witness.encoding`, `types`, `builders` and `fixtures`
    give the JAX package's bytes, roots and proofs."""
    from pathlib import Path

    from zk_state_proofs_tpu.witness import builders as jbuilders
    from zk_state_proofs_tpu.witness import encoding as jencoding
    from zk_state_proofs_tpu.witness import fixtures as jfixtures
    from zk_state_proofs_tpu.witness import types as jtypes
    from zk_state_proofs_tpu_torch.witness import builders, encoding, fixtures, types

    fx = fixtures.synthetic_block(num_txs=12, seed=4)
    assert fx == jfixtures.synthetic_block(num_txs=12, seed=4)
    block, receipts = fx["block"], fx["receipts"]
    assert {encoding.tx_type(tx) for tx in block["transactions"]} >= {0, 2}
    for tx in block["transactions"]:
        assert encoding.encode_transaction(tx) == jencoding.encode_transaction(tx)
    for r in receipts:
        assert encoding.encode_receipt(r) == jencoding.encode_receipt(r)
        for log in r["logs"]:
            assert encoding.encode_log(log) == jencoding.encode_log(log)
    path = Path(__file__).resolve().parent.parent / "fixtures" / "mainnet_headers.json"
    headers = fixtures.load_fixture(path)
    assert headers == jfixtures.load_fixture(path)
    for name in ("genesis", "block1"):
        assert encoding.encode_header(headers[name]) == jencoding.encode_header(headers[name])
        assert encoding.block_hash(headers[name]).hex() == headers[name]["hash"][2:]
    assert fixtures.ERC20_TRANSFER_TOPIC == jfixtures.ERC20_TRANSFER_TOPIC

    pairs = [(builders.get_all_transaction_proof_inputs(block),
              jbuilders.get_all_transaction_proof_inputs(block)),
             (builders.get_all_receipt_proof_inputs(block, receipts),
              jbuilders.get_all_receipt_proof_inputs(block, receipts)),
             ([builders.get_transaction_proof_input(block, 3),
               builders.get_receipt_proof_input(block, receipts, 5)],
              [jbuilders.get_transaction_proof_input(block, 3),
               jbuilders.get_receipt_proof_input(block, receipts, 5)])]
    for ours, theirs in pairs:
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a.to_borsh() == b.to_borsh()
            assert types.MerkleProofInput.from_borsh(b.to_borsh()) == a
    assert builders.build_receipt_trie(receipts).root_hash() == \
        jbuilders.build_receipt_trie(receipts).root_hash()
    storage = dict(account_proof=[b"\x01" * 40], storage_proofs=[[b"\x02" * 33], []],
                   root_hash=b"\x03" * 32, account_key=b"\x04" * 32,
                   storage_keys=[b"\x05" * 32, b"\x06"], address_keccak=b"\x07" * 32)
    raw = types.StorageProofInput(**storage).to_borsh()
    assert raw == jtypes.StorageProofInput(**storage).to_borsh()
    assert types.StorageProofInput.from_borsh(raw) == types.StorageProofInput(**storage)
    bad = dict(block["transactions"][0])
    bad.pop("nonce")
    with pytest.raises(builders.WitnessError):
        builders.build_transaction_trie([bad])
    with pytest.raises(jbuilders.WitnessError):
        jbuilders.build_transaction_trie([bad])
    with pytest.raises(builders.WitnessError):
        builders.get_receipt_proof_input(dict(block, receiptsRoot="0x" + "00" * 32),
                                         receipts, 0)
