"""Recorded fixtures + synthetic block generator.

The port's own copy of `zk_state_proofs_tpu.witness.fixtures` (the tests
hold the two equal). Blocks and proof responses are recorded through an
RPC client into JSON files and load back offline, and a deterministic
synthetic-block generator produces realistic multi-envelope blocks (all
five EIP-2718 types + logs) whose header roots are computed with the
oracle trie builder, so the whole pipeline tests offline and bit-exactly.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

from .builders import build_receipt_trie, build_transaction_trie

# keccak("Transfer(address,address,uint256)") — ERC20 Transfer topic0
ERC20_TRANSFER_TOPIC = (
    "0xddf252ad1be2c89b69c2b068fc378daa952ba7f163c4a11628f55a4df523b3ef"
)


def save_fixture(path, obj: dict) -> None:
    Path(path).write_text(json.dumps(obj, indent=1, sort_keys=True))


def load_fixture(path) -> dict:
    return json.loads(Path(path).read_text())


def record_block_fixture(client, block_hash: str, path=None) -> dict:
    """Fetch a block + its receipts through `client` and (optionally) save:
    the recorded form feeds the same builders as live RPC."""
    block = client.get_block_by_hash(block_hash, full_txs=True)
    receipts = client.get_block_receipts(block_hash)
    fixture = {"block": block, "receipts": receipts}
    if path is not None:
        save_fixture(path, fixture)
    return fixture


def record_proof_fixture(client, address: str, storage_keys: list, tag="latest", path=None) -> dict:
    block = client.get_block_by_number(tag, full_txs=False)
    proof = client.get_proof(address, storage_keys, tag)
    fixture = {"block": block, "proof": proof, "address": address,
               "storageKeys": storage_keys}
    if path is not None:
        save_fixture(path, fixture)
    return fixture


# ---------------------------------------------------------------------------
# synthetic blocks
# ---------------------------------------------------------------------------

def _hx(n: int) -> str:
    return hex(n)


def _hb(b: bytes) -> str:
    return "0x" + b.hex()


def _addr(rng) -> str:
    return _hb(bytes(rng.randrange(256) for _ in range(20)))


def _word(rng) -> str:
    return _hb(bytes(rng.randrange(256) for _ in range(32)))


def synthetic_block(num_txs: int = 32, seed: int = 0, erc20_logs: bool = True) -> dict:
    """Deterministic synthetic block with a realistic envelope-type mix.

    Returns {"block": ..., "receipts": ...} shaped like RPC output, with
    transactionsRoot / receiptsRoot computed by the oracle trie builder."""
    rng = random.Random(seed)
    txs, receipts = [], []
    cumulative_gas = 0
    for i in range(num_txs):
        t = rng.choice([0, 0, 1, 2, 2, 2, 3, 4])  # 1559-heavy mainnet-ish mix
        base = {
            "type": _hx(t),
            "nonce": _hx(rng.randrange(1 << 24)),
            "gas": _hx(21000 + rng.randrange(1 << 20)),
            "to": _addr(rng) if rng.random() > 0.05 else None,
            "value": _hx(rng.randrange(1 << 60)),
            "input": _hb(bytes(rng.randrange(256) for _ in range(rng.randrange(0, 260)))),
            "r": _word(rng),
            "s": _word(rng),
        }
        if t == 0:
            base["gasPrice"] = _hx(rng.randrange(1 << 40))
            base["v"] = _hx(37 + rng.randrange(2))
        else:
            base["chainId"] = "0x1"
            base["yParity"] = _hx(rng.randrange(2))
            if t == 1:
                base["gasPrice"] = _hx(rng.randrange(1 << 40))
            else:
                base["maxPriorityFeePerGas"] = _hx(rng.randrange(1 << 32))
                base["maxFeePerGas"] = _hx(rng.randrange(1 << 40))
            if t >= 1:
                base["accessList"] = [
                    {"address": _addr(rng), "storageKeys": [_word(rng) for _ in range(rng.randrange(3))]}
                    for _ in range(rng.randrange(3))
                ]
            if t == 3:
                base["to"] = base["to"] or _addr(rng)  # 4844 requires a to
                base["maxFeePerBlobGas"] = _hx(rng.randrange(1 << 32))
                base["blobVersionedHashes"] = ["0x01" + _word(rng)[4:] for _ in range(1 + rng.randrange(3))]
            if t == 4:
                base["authorizationList"] = [
                    {"chainId": "0x1", "address": _addr(rng), "nonce": _hx(rng.randrange(100)),
                     "yParity": _hx(rng.randrange(2)), "r": _word(rng), "s": _word(rng)}
                    for _ in range(1 + rng.randrange(2))
                ]
        txs.append(base)

        gas_used = 21000 + rng.randrange(1 << 18)
        cumulative_gas += gas_used
        logs = []
        if erc20_logs and rng.random() < 0.6:
            logs.append({
                "address": _addr(rng),
                "topics": [
                    ERC20_TRANSFER_TOPIC,
                    "0x" + "00" * 12 + _addr(rng)[2:],
                    "0x" + "00" * 12 + _addr(rng)[2:],
                ],
                "data": _word(rng),
            })
        for _ in range(rng.randrange(3)):
            logs.append({
                "address": _addr(rng),
                "topics": [_word(rng) for _ in range(rng.randrange(1, 4))],
                "data": _hb(bytes(rng.randrange(256) for _ in range(rng.randrange(0, 96)))),
            })
        receipts.append({
            "type": _hx(t),
            "status": _hx(1 if rng.random() > 0.05 else 0),
            "cumulativeGasUsed": _hx(cumulative_gas),
            "logsBloom": _hb(bytes(rng.randrange(256) for _ in range(256))),
            "logs": logs,
            "transactionIndex": _hx(i),
        })

    tx_root = build_transaction_trie(txs).root_hash()
    receipt_root = build_receipt_trie(receipts).root_hash()
    block = {
        "hash": _word(rng),
        "number": _hx(rng.randrange(1 << 24)),
        "transactions": txs,
        "transactionsRoot": _hb(tx_root),
        "receiptsRoot": _hb(receipt_root),
    }
    return {"block": block, "receipts": receipts}
