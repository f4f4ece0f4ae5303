"""EIP-2718 transaction + receipt canonical encodings (host side).

The port's own copy of `zk_state_proofs_tpu.witness.encoding` (the tests
hold the two equal).

Re-creates the envelope encodings the reference gets from alloy
(reference: trie-utils/src/proofs/transaction.rs:47-62 for the five
Ethereum envelope types, :93-97 for the Optimism Deposit prefix byte;
receipt leaf layout trie-utils/src/receipt.rs:8-38 — RLP
[status, cumulative_gas_used, bloom, logs] with the type byte prepended for
typed receipts, golden vector trie-utils/tests/rlp.rs:12).

Inputs are RPC-style JSON dicts (hex-quantity strings), the form the
witness fetcher produces.
"""

from __future__ import annotations

from ..oracle import rlp

# EIP-2718 envelope type bytes
LEGACY = 0x00
EIP2930 = 0x01
EIP1559 = 0x02
EIP4844 = 0x03
EIP7702 = 0x04
OP_DEPOSIT = 0x7E  # Optimism deposit transaction (reference transaction.rs:93-97)


def _qty(v) -> bytes:
    """RPC hex quantity ('0x1a') / int -> minimal big-endian bytes."""
    if v is None:
        return b""
    if isinstance(v, str):
        return rlp.int_to_min_bytes(int(v, 16))
    return rlp.int_to_min_bytes(int(v))


def _data(v) -> bytes:
    """RPC hex data ('0xdeadbeef') -> bytes. Odd-length inputs (RPCs serve
    quantity-style storage keys like '0x0') get a leading zero nibble."""
    if v is None:
        return b""
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    s = v[2:] if v.startswith("0x") else v
    if len(s) % 2:
        s = "0" + s
    return bytes.fromhex(s)


def _access_list(al) -> list:
    return [[_data(e["address"]), [_data(k) for k in e.get("storageKeys", [])]] for e in (al or [])]


def _auth_list(al) -> list:
    """EIP-7702 authorization tuples [chain_id, address, nonce, y_parity, r, s]."""
    return [
        [
            _qty(a.get("chainId")),
            _data(a["address"]),
            _qty(a.get("nonce")),
            _qty(a.get("yParity", a.get("v"))),
            _qty(a.get("r")),
            _qty(a.get("s")),
        ]
        for a in (al or [])
    ]


def tx_type(tx: dict) -> int:
    return int(tx.get("type", "0x0"), 16) if isinstance(tx.get("type"), str) else int(tx.get("type") or 0)


def encode_transaction(tx: dict) -> bytes:
    """Canonical EIP-2718 encoding of a signed RPC transaction — the exact
    bytes inserted into the transaction trie at path rlp(index)
    (reference: transaction.rs:45,63)."""
    t = tx_type(tx)
    to = _data(tx.get("to"))
    sig = [_qty(tx.get("yParity", tx.get("v"))), _qty(tx.get("r")), _qty(tx.get("s"))]
    if t == LEGACY:
        # legacy keeps the raw v (carries chain id via EIP-155)
        fields = [
            _qty(tx.get("nonce")), _qty(tx.get("gasPrice")), _qty(tx.get("gas")),
            to, _qty(tx.get("value")), _data(tx.get("input")),
            _qty(tx.get("v")), _qty(tx.get("r")), _qty(tx.get("s")),
        ]
        return rlp.encode(fields)
    if t == EIP2930:
        fields = [
            _qty(tx.get("chainId")), _qty(tx.get("nonce")), _qty(tx.get("gasPrice")),
            _qty(tx.get("gas")), to, _qty(tx.get("value")), _data(tx.get("input")),
            _access_list(tx.get("accessList")), *sig,
        ]
    elif t == EIP1559:
        fields = [
            _qty(tx.get("chainId")), _qty(tx.get("nonce")),
            _qty(tx.get("maxPriorityFeePerGas")), _qty(tx.get("maxFeePerGas")),
            _qty(tx.get("gas")), to, _qty(tx.get("value")), _data(tx.get("input")),
            _access_list(tx.get("accessList")), *sig,
        ]
    elif t == EIP4844:
        fields = [
            _qty(tx.get("chainId")), _qty(tx.get("nonce")),
            _qty(tx.get("maxPriorityFeePerGas")), _qty(tx.get("maxFeePerGas")),
            _qty(tx.get("gas")), to, _qty(tx.get("value")), _data(tx.get("input")),
            _access_list(tx.get("accessList")),
            _qty(tx.get("maxFeePerBlobGas")),
            [_data(h) for h in tx.get("blobVersionedHashes", [])],
            *sig,
        ]
    elif t == EIP7702:
        fields = [
            _qty(tx.get("chainId")), _qty(tx.get("nonce")),
            _qty(tx.get("maxPriorityFeePerGas")), _qty(tx.get("maxFeePerGas")),
            _qty(tx.get("gas")), to, _qty(tx.get("value")), _data(tx.get("input")),
            _access_list(tx.get("accessList")),
            _auth_list(tx.get("authorizationList")),
            *sig,
        ]
    elif t == OP_DEPOSIT:
        # OP deposit tx (type 0x7e): [source_hash, from, to, mint, value,
        # gas, is_system_tx, input] (reference transaction.rs:93-97)
        fields = [
            _data(tx.get("sourceHash")), _data(tx.get("from")), to,
            _qty(tx.get("mint")), _qty(tx.get("value")), _qty(tx.get("gas")),
            _qty(1 if tx.get("isSystemTx") else 0), _data(tx.get("input")),
        ]
    else:
        raise ValueError(f"unsupported transaction type {t:#x}")
    return bytes([t]) + rlp.encode(fields)


# block header fields in RLP order: (json-rpc name, kind). Fields after
# `nonce` are fork-gated: encoded iff present in the block dict (EIP-1559
# baseFeePerGas, Shanghai withdrawalsRoot, Cancun blob fields + beacon
# root, Prague requestsHash).
_HEADER_BASE = [
    ("parentHash", "data"), ("sha3Uncles", "data"), ("miner", "data"),
    ("stateRoot", "data"), ("transactionsRoot", "data"),
    ("receiptsRoot", "data"), ("logsBloom", "data"), ("difficulty", "qty"),
    ("number", "qty"), ("gasLimit", "qty"), ("gasUsed", "qty"),
    ("timestamp", "qty"), ("extraData", "data"), ("mixHash", "data"),
    ("nonce", "data"),
]
_HEADER_FORK = [
    ("baseFeePerGas", "qty"), ("withdrawalsRoot", "data"),
    ("blobGasUsed", "qty"), ("excessBlobGas", "qty"),
    ("parentBeaconBlockRoot", "data"), ("requestsHash", "data"),
]


def encode_header(block: dict) -> bytes:
    """Canonical RLP of an execution block header from an RPC-shaped block
    dict. The header commits to transactionsRoot/receiptsRoot/stateRoot, so
    `keccak(encode_header(block)) == block["hash"]` pins every root a
    witness is verified against — the trust anchor the reference gets from
    fetching pinned blocks live (trie-utils/tests/transaction.rs:12-40,
    pinned hashes trie-utils/src/constants.rs:5-12). Anchored offline to
    the protocol-hardcoded mainnet genesis header in
    tests/test_golden_vectors.py."""
    fields = []
    for name, kind in _HEADER_BASE:
        v = block.get(name)
        fields.append(_qty(v) if kind == "qty" else _data(v))
    for name, kind in _HEADER_FORK:
        if block.get(name) is None:
            break  # fork fields are strictly ordered; absent = pre-fork
        v = block[name]
        fields.append(_qty(v) if kind == "qty" else _data(v))
    return rlp.encode(fields)


def block_hash(block: dict) -> bytes:
    """keccak256 of the canonically encoded header."""
    from ..oracle import keccak256

    return keccak256(encode_header(block))


def encode_log(log: dict) -> list:
    """Log item: [address, topics, data] (reference trie-utils/src/types.rs:17-35)."""
    return [_data(log["address"]), [_data(t) for t in log.get("topics", [])], _data(log.get("data"))]


def encode_receipt(receipt: dict) -> bytes:
    """Canonical receipt trie leaf: optional EIP-2718 type byte ++
    rlp([status, cumulative_gas_used, bloom, logs])
    (reference: trie-utils/src/receipt.rs:8-38, proofs/receipt.rs:56-81)."""
    status_field = receipt.get("status")
    if status_field is not None:
        status = _qty(status_field)
    else:
        # pre-Byzantium receipts carry the post-state root instead
        status = _data(receipt["root"])
    payload = rlp.encode(
        [
            status,
            _qty(receipt.get("cumulativeGasUsed")),
            _data(receipt.get("logsBloom", "0x" + "00" * 256)),
            [encode_log(l) for l in receipt.get("logs", [])],
        ]
    )
    t = tx_type(receipt)
    if t == LEGACY:
        return payload
    return bytes([t]) + payload
