"""The port's block models (transaction and receipt tries, ERC20 extraction)
against the JAX package's on the same block dicts, on the CPU: status,
values and lengths bit for bit, and the same transfers; the mainnet block
46147 under its pinned root; the transaction-geometry recipe (about 2 KB
leaves, full-width values) through the pooled verify in every hint mode."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from zk_state_proofs_tpu import models as jmodels
from zk_state_proofs_tpu.ops import mpt as jmpt
from zk_state_proofs_tpu.witness import builders as jbuilders
from zk_state_proofs_tpu.witness import synthetic_block as jax_synthetic_block
from zk_state_proofs_tpu_torch.models import (extract_erc20_transfers,
                                              verify_block_receipts,
                                              verify_block_transactions,
                                              verify_merkle_batch)
from zk_state_proofs_tpu_torch.ops import mpt as tmpt
from zk_state_proofs_tpu_torch.witness import (ERC20_TRANSFER_TOPIC, WitnessError,
                                               encode_receipt, encode_transaction,
                                               get_transaction_proof_input,
                                               load_fixture, pack_proofs,
                                               synthetic_block)
from zk_state_proofs_tpu_torch.witness_bridge import (BATCH_FIELDS, POOL_FIELDS,
                                                      packed_to_tensors,
                                                      tx_geometry_batch,
                                                      tx_geometry_block)

FIXTURE = Path(__file__).resolve().parent.parent / "fixtures" / "mainnet_block_46147.json"


def _assert_same(got, want):
    for f in ("status", "values", "value_lens"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def _fields(transfers):
    return [(t.token, t.sender, t.receiver, t.amount, t.tx_index) for t in transfers]


def test_block_transactions_match_jax():
    fx = synthetic_block(num_txs=20, seed=11)
    assert fx == jax_synthetic_block(num_txs=20, seed=11)
    block = fx["block"]
    got = verify_block_transactions(block, device="cpu")
    _assert_same(got, jmodels.verify_block_transactions(block))
    assert got.all_found
    for i, tx in enumerate(block["transactions"]):
        assert got.value(i) == encode_transaction(tx)


def test_block_receipts_and_transfers_match_jax():
    fx = synthetic_block(num_txs=24, seed=12)
    got, transfers = verify_block_receipts(fx["block"], fx["receipts"], device="cpu")
    want, want_transfers = jmodels.verify_block_receipts(fx["block"], fx["receipts"])
    _assert_same(got, want)
    assert got.all_found
    assert _fields(transfers) == _fields(want_transfers) and len(transfers) >= 3
    vec = extract_erc20_transfers(got.values, got.value_lens, got.status,
                                  engine="vectorized")
    assert _fields(vec) == _fields(transfers)
    planted = sum(1 for r in fx["receipts"] for log in r["logs"]
                  if log["topics"] and log["topics"][0] == ERC20_TRANSFER_TOPIC
                  and len(log["topics"]) == 3)
    assert len(transfers) == planted


def test_block_subset_indices_match_jax():
    fx = synthetic_block(num_txs=16, seed=13)
    got = verify_block_transactions(fx["block"], indices=[3, 9], device="cpu")
    _assert_same(got, jmodels.verify_block_transactions(fx["block"], indices=[3, 9]))
    assert got.status.shape == (2,) and got.all_found
    assert got.value(1) == encode_transaction(fx["block"]["transactions"][9])


def test_mainnet_block_46147_and_tamper():
    """The first mainnet transaction verifies under the block's pinned
    transactionsRoot; a drifted tx field fails the rebuilt root, and a
    flipped proof byte turns the proof INVALID."""
    block = load_fixture(FIXTURE)
    assert block == json.loads(FIXTURE.read_text())
    got = verify_block_transactions(block, device="cpu")
    _assert_same(got, jmodels.verify_block_transactions(block))
    raw = encode_transaction(block["transactions"][0])
    assert got.all_found and got.value(0) == raw
    inp = get_transaction_proof_input(block, 0)
    assert inp.root_hash.hex() == block["transactionsRoot"][2:]
    tampered = json.loads(json.dumps(block))
    tampered["transactions"][0]["value"] = "0x7a6a"
    with pytest.raises(WitnessError):
        get_transaction_proof_input(tampered, 0)
    with pytest.raises(jbuilders.WitnessError):
        jbuilders.get_transaction_proof_input(tampered, 0)
    node = bytearray(inp.proof[0])
    node[-1] ^= 1
    entries = [inp.as_entry(), (inp.root_hash, [bytes(node)], inp.key)]
    res = verify_merkle_batch(pack_proofs(entries), max_value_len=len(node), device="cpu")
    assert res.status.tolist() == [tmpt.FOUND, tmpt.INVALID] and res.value(0) == raw


def test_tx_geometry_recipe_matches_jax():
    """The transaction-geometry recipe at a small size (16 txs, 64 proofs,
    full value width): the pooled verify equals the JAX package's in every
    hint mode, and every proof is FOUND with its encoded tx."""
    block = tx_geometry_block(n_txs=16)
    assert jbuilders.build_transaction_trie(block["transactions"]).root_hash().hex() == \
        block["transactionsRoot"][2:]
    geo = tx_geometry_batch(block, total=64)
    packed = geo.packed
    n = packed.nodes.shape[2]
    assert n % 4 == 0 and n > 2000 and geo.max_value_len > 1400
    want = jmpt.verify_proofs_pooled(*packed.astuple(), *packed.pool(), packed.pool_hints(),
                                     max_value_len=geo.max_value_len,
                                     max_steps=geo.max_steps)
    t = packed_to_tensors(packed, "cpu")
    args = [t[k] for k in BATCH_FIELDS] + [t[k] for k in POOL_FIELDS] + [t["pool_hints"]]
    for mode in tmpt.HINT_MODES:
        got = tmpt.verify_proofs_pooled(*args, max_value_len=geo.max_value_len,
                                        max_steps=geo.max_steps, hint_mode=mode)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), mode)
    status, values, lens = (x.numpy() for x in got)
    assert (status == tmpt.FOUND).all()
    assert all(bytes(values[i, :lens[i]]) == v for i, v in enumerate(geo.values))


def test_transfer_extraction_rejects_embedded_fake_pattern():
    """A log whose data embeds the byte pattern of a transfer log yields no
    phantom transfer in either engine: the extractor parses structure."""
    topic = bytes.fromhex(ERC20_TRANSFER_TOPIC[2:])
    fake = (b"\x94" + b"\xaa" * 20 + b"\xf8\x63"
            + b"\xa0" + topic + b"\xa0" + b"\x11" * 32 + b"\xa0"
            + b"\x22" * 32 + b"\xa0" + b"\x33" * 32)
    receipts = [
        {"type": "0x0", "status": "0x1", "cumulativeGasUsed": "0x5208",
         "logs": [{"address": "0x" + "bb" * 20, "topics": ["0x" + "cc" * 32],
                   "data": "0x" + fake.hex()}]},
        {"type": "0x0", "status": "0x1", "cumulativeGasUsed": "0xa410",
         "logs": [{"address": "0x" + "dd" * 20,
                   "topics": [ERC20_TRANSFER_TOPIC, "0x" + "01" * 32, "0x" + "02" * 32],
                   "data": "0x" + "00" * 31 + "2a"}]},
    ]
    values = [encode_receipt(r) for r in receipts]
    arr = np.zeros((2, max(len(v) for v in values)), np.uint8)
    for i, v in enumerate(values):
        arr[i, :len(v)] = np.frombuffer(v, np.uint8)
    lens = np.asarray([len(v) for v in values], np.int32)
    status = np.full(2, tmpt.FOUND, np.int32)
    for engine in ("vectorized", "host"):
        got = extract_erc20_transfers(arr, lens, status, engine=engine)
        assert len(got) == 1, engine
        assert got[0].token == b"\xdd" * 20 and got[0].amount == 42 and got[0].tx_index == 1
        want = jmodels.extract_erc20_transfers(arr, lens, status, engine=engine)
        assert _fields(got) == _fields(want)
    # a receipt that is not FOUND gives no transfer
    assert extract_erc20_transfers(arr, lens, np.asarray([tmpt.FOUND, tmpt.INVALID])) == []


def test_receipts_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    fx = synthetic_block(num_txs=4, seed=5)
    with pytest.raises(RuntimeError):
        verify_block_receipts(fx["block"], fx["receipts"])
    with pytest.raises(RuntimeError):
        verify_block_transactions(fx["block"])
