"""The port's circuit entry points against the JAX package's, on the CPU:
borsh in, the same committed bytes out, the same exceptions (the flows of
tests/test_circuits.py)."""

import pytest
import torch

from zk_state_proofs_tpu import models as jmodels
from zk_state_proofs_tpu_torch.models import (run_merkle_circuit, run_merkle_circuit_batch,
                                              run_storage_circuit)
from zk_state_proofs_tpu_torch.oracle import (EthTrie, MissingKeyError, TrieError,
                                              keccak256, rlp)
from zk_state_proofs_tpu_torch.witness import (MerkleProofInput, StorageProofInput,
                                               get_transaction_proof_input,
                                               synthetic_block)
from zk_state_proofs_tpu_torch.witness.encoding import encode_transaction

# The suite runs in several worker processes on one machine: one intra-op
# thread each keeps torch's thread pools from oversubscribing its cores.
torch.set_num_threads(1)


def _storage_input():
    world, st = EthTrie(), EthTrie()
    addr = bytes.fromhex("ab" * 20)
    slots, values = [], []
    for s in range(3):
        slot = keccak256(b"slot%d" % s)
        val = rlp.encode_int(10_000 + s)
        st.insert(keccak256(slot), val)
        slots.append(slot)
        values.append(val)
    sroot = st.root_hash()
    world.insert(keccak256(addr), rlp.encode([b"\x05", b"\x10", sroot, keccak256(b"code")]))
    for i in range(30):
        world.insert(keccak256(b"x%d" % i), rlp.encode([b"\x01", b"", sroot, sroot]))
    inp = StorageProofInput(
        account_proof=world.get_proof(keccak256(addr)),
        storage_proofs=[st.get_proof(keccak256(s)) for s in slots],
        root_hash=world.root_hash(), account_key=keccak256(addr), storage_keys=slots,
        address_keccak=keccak256(addr))
    return inp, st, values


def _raises(exc, fn, *args):
    with pytest.raises(exc) as got:
        fn(*args)
    return type(got.value)


def test_circuits_match_jax():
    fx = synthetic_block(num_txs=12, seed=41)
    txs = fx["block"]["transactions"]
    inputs = [get_transaction_proof_input(fx["block"], i).to_borsh() for i in range(10)]
    committed = run_merkle_circuit(inputs[7], device="cpu")
    assert committed == encode_transaction(txs[7])
    # a batch with a proof of another key (not FOUND: None) at its end
    bad = MerkleProofInput.from_borsh(inputs[3])
    bad = MerkleProofInput(root_hash=bad.root_hash, proof=bad.proof,
                           key=MerkleProofInput.from_borsh(inputs[4]).key)
    batch = inputs + [bad.to_borsh()]
    got = run_merkle_circuit_batch(batch, device="cpu")
    assert got == jmodels.run_merkle_circuit_batch(batch)
    assert got[:10] == [encode_transaction(tx) for tx in txs[:10]] and got[10] is None
    assert run_merkle_circuit_batch([MerkleProofInput.from_borsh(i) for i in inputs[:2]],
                                    device="cpu") == got[:2]
    # an invalid proof and a proven-absent key raise as the reference panics
    assert _raises(TrieError, run_merkle_circuit, bad.to_borsh(), "cpu") is TrieError
    t = EthTrie()
    for i in range(20):
        t.insert(keccak256(b"c%d" % i), b"\x07" * 40)
    absent = keccak256(b"c-absent")
    gone = MerkleProofInput(root_hash=t.root_hash(), proof=t.get_proof(absent), key=absent)
    assert _raises(MissingKeyError, run_merkle_circuit, gone.to_borsh(), "cpu") \
        is MissingKeyError

    inp, st, values = _storage_input()
    assert run_storage_circuit(inp.to_borsh(), device="cpu") == values
    assert run_storage_circuit(inp, device="cpu") == values
    assert jmodels.run_storage_circuit(inp.to_borsh()) == values
    bad_slot = keccak256(b"absent")
    missing = StorageProofInput(
        account_proof=inp.account_proof, storage_proofs=[st.get_proof(keccak256(bad_slot))],
        root_hash=inp.root_hash, account_key=inp.account_key, storage_keys=[bad_slot],
        address_keccak=inp.address_keccak)
    assert _raises(MissingKeyError, run_storage_circuit, missing.to_borsh(), "cpu") \
        is MissingKeyError
    tampered = StorageProofInput(
        account_proof=inp.account_proof, storage_proofs=[inp.storage_proofs[1]],
        root_hash=inp.root_hash, account_key=inp.account_key,
        storage_keys=[inp.storage_keys[0]], address_keccak=inp.address_keccak)
    assert _raises(TrieError, run_storage_circuit, tampered, "cpu") is TrieError
    wrong_root = StorageProofInput(
        account_proof=inp.account_proof, storage_proofs=inp.storage_proofs[:1],
        root_hash=b"\x42" * 32, account_key=inp.account_key,
        storage_keys=inp.storage_keys[:1], address_keccak=inp.address_keccak)
    assert _raises(TrieError, run_storage_circuit, wrong_root, "cpu") is TrieError
    uneven = StorageProofInput(
        account_proof=inp.account_proof, storage_proofs=inp.storage_proofs,
        root_hash=inp.root_hash, account_key=inp.account_key,
        storage_keys=inp.storage_keys[:2], address_keccak=inp.address_keccak)
    with pytest.raises(ValueError):
        run_storage_circuit(uneven, device="cpu")
    empty = StorageProofInput(
        account_proof=inp.account_proof, storage_proofs=[], root_hash=inp.root_hash,
        account_key=inp.account_key, storage_keys=[], address_keccak=inp.address_keccak)
    assert run_storage_circuit(empty, device="cpu") == [] == jmodels.run_storage_circuit(empty)
