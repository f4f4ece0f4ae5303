"""Pure-Python RLP (Recursive Length Prefix) codec — bit-exact oracle.

The port's own copy of `zk_state_proofs_tpu.oracle.rlp`.

Canonical Ethereum RLP with strict decoding. Matches the semantics the
reference framework gets from `alloy-rlp` (reference: trie-utils call sites
at proofs/transaction.rs:45,67 and receipt.rs:31) and the node codec inside
the `eth_trie` crate.

Items are `bytes` or (recursively) lists of items. Integers are encoded via
their minimal big-endian byte form (`encode_int`) — note index 0 encodes to
the empty string, i.e. RLP `0x80` (reference: transaction.rs:45 uses
`alloy_rlp::encode(index)` as the trie path).
"""

from __future__ import annotations

from typing import Union

RlpItem = Union[bytes, list]


class RlpError(ValueError):
    """Malformed RLP input."""


def int_to_min_bytes(value: int) -> bytes:
    """Minimal big-endian representation; 0 -> b'' (RLP canonical ints)."""
    if value < 0:
        raise ValueError("RLP cannot encode negative integers")
    if value == 0:
        return b""
    return value.to_bytes((value.bit_length() + 7) // 8, "big")


def encode(item: RlpItem) -> bytes:
    if isinstance(item, (bytes, bytearray, memoryview)):
        data = bytes(item)
        if len(data) == 1 and data[0] < 0x80:
            return data
        return _encode_length(len(data), 0x80) + data
    if isinstance(item, (list, tuple)):
        payload = b"".join(encode(sub) for sub in item)
        return _encode_length(len(payload), 0xC0) + payload
    if isinstance(item, int):
        return encode(int_to_min_bytes(item))
    raise TypeError(f"cannot RLP-encode {type(item)!r}")


def encode_int(value: int) -> bytes:
    return encode(int_to_min_bytes(value))


def _encode_length(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    len_bytes = int_to_min_bytes(length)
    return bytes([offset + 55 + len(len_bytes)]) + len_bytes


def decode(data: bytes) -> RlpItem:
    """Strict decode; raises RlpError on trailing bytes or malformed input."""
    item, consumed = _decode_at(bytes(data), 0)
    if consumed != len(data):
        raise RlpError(f"trailing bytes: consumed {consumed} of {len(data)}")
    return item


def _read_length(data: bytes, pos: int) -> tuple[int, int, bool]:
    """Return (payload_start, payload_len, is_list) for the item at `pos`."""
    if pos >= len(data):
        raise RlpError("out of bounds")
    b0 = data[pos]
    if b0 < 0x80:
        return pos, 1, False
    if b0 < 0xB8:  # short string
        return pos + 1, b0 - 0x80, False
    if b0 < 0xC0:  # long string
        lol = b0 - 0xB7
        n = int.from_bytes(data[pos + 1 : pos + 1 + lol], "big")
        if lol > len(data) - pos - 1 or n < 56:
            raise RlpError("non-canonical long string")
        return pos + 1 + lol, n, False
    if b0 < 0xF8:  # short list
        return pos + 1, b0 - 0xC0, True
    lol = b0 - 0xF7
    n = int.from_bytes(data[pos + 1 : pos + 1 + lol], "big")
    if lol > len(data) - pos - 1 or n < 56:
        raise RlpError("non-canonical long list")
    return pos + 1 + lol, n, True


def _decode_at(data: bytes, pos: int) -> tuple[RlpItem, int]:
    start, length, is_list = _read_length(data, pos)
    end = start + length
    if end > len(data):
        raise RlpError("length prefix exceeds input")
    if not is_list:
        payload = data[start:end]
        if length == 1 and payload[0] < 0x80 and start != pos:
            raise RlpError("non-canonical single byte")
        return payload, end
    items = []
    cursor = start
    while cursor < end:
        item, cursor = _decode_at(data, cursor)
        if cursor > end:
            raise RlpError("list item overruns list payload")
        items.append(item)
    return items, end


def decode_int(data: bytes) -> int:
    """Decode minimal big-endian bytes to int (inverse of int_to_min_bytes)."""
    if len(data) > 0 and data[0] == 0:
        raise RlpError("non-canonical integer (leading zero)")
    return int.from_bytes(data, "big")
