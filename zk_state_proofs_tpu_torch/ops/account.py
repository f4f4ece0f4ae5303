"""Batched Ethereum account-leaf decoding.

Port of `zk_state_proofs_tpu.ops.account`: the account leaf value is RLP
`[nonce, balance, storage_root, code_hash]`. Byte reads clamp into the value
buffer ([0, V - 1], the JAX `_get` rule: a read past the end repeats the
last byte) exactly as the JAX decoder does.
"""

from __future__ import annotations

import torch

from .rlp import MAX_ITEMS


def _get(buf, idx):
    """buf u8 [B, V], idx int [B, ...] -> int64, idx clamped into [0, V-1]."""
    b, v = buf.shape
    flat = idx.to(torch.int64).clamp(0, v - 1).reshape(b, -1)
    return torch.gather(buf, 1, flat).to(torch.int64).reshape(idx.shape)


def _item_head(buf, pos):
    """(payload_start, payload_len, is_list, head_valid) of the item at
    `pos` [B] (ops/rlp.item_head of the JAX package)."""
    b0, l1, l2, l3 = (_get(buf, pos + k) for k in range(4))
    single = b0 < 0x80
    long_str = (b0 >= 0xB8) & (b0 <= 0xBF)
    long_list = b0 >= 0xF8
    is_list = b0 >= 0xC0
    lol = torch.where(long_str, b0 - 0xB7, torch.where(long_list, b0 - 0xF7, 0))
    long_len = torch.where(lol == 1, l1, torch.where(
        lol == 2, (l1 << 8) | l2, (l1 << 16) | (l2 << 8) | l3))
    plen = torch.where(single, 1, torch.where(
        long_str | long_list, long_len, torch.where(is_list, b0 - 0xC0, b0 - 0x80)))
    pstart = torch.where(single, pos, pos + 1 + lol)
    return pstart, plen, is_list, lol <= 3


def _node_items(buf, start, buf_len):
    """Up to 17 item spans of the RLP list at `start` (ops/rlp.node_items):
    dict of [B, 17] payload_start/payload_len/is_list/present and [B]
    count/well_formed/list_end."""
    ps, plen, is_list, head_ok = _item_head(buf, start)
    end = ps + plen
    cursor = ps
    cols = {"payload_start": [], "payload_len": [], "is_list": [], "present": []}
    all_ok = torch.ones_like(is_list)
    for _ in range(MAX_ITEMS):
        ips, ipl, ilist, ok = _item_head(buf, cursor)
        present = cursor < end
        cols["payload_start"].append(ips)
        cols["payload_len"].append(ipl)
        cols["is_list"].append(ilist)
        cols["present"].append(present)
        all_ok = all_ok & (~present | ok)
        cursor = torch.where(present, ips + ipl, cursor)
    out = {k: torch.stack(v, dim=1) for k, v in cols.items()}
    out["count"] = out["present"].sum(1)
    out["well_formed"] = (is_list & head_ok & (cursor == end)
                          & (end <= buf_len) & all_ok)
    out["list_end"] = end
    return out


def _bytes_left_pad(buf, start, length, width: int):
    """Big-endian byte span -> left-padded u8 [B, width]."""
    j = torch.arange(width, device=buf.device)[None, :]
    pad = width - length[:, None]
    src = start[:, None] + j - pad
    return torch.where(j >= pad, _get(buf, src), 0).to(torch.uint8)


def decode_account(values, value_lens):
    """Decode account leaf values u8 [B, V] with lengths [B].

    Returns dict(ok bool [B], nonce u8 [B, 8] big-endian, balance u8
    [B, 32] big-endian, storage_root u8 [B, 32], code_hash u8 [B, 32])."""
    b = values.shape[0]
    vlen = value_lens.to(torch.int64)
    items = _node_items(values, torch.zeros(b, dtype=torch.int64,
                                            device=values.device), vlen)
    ps, pl, il = items["payload_start"], items["payload_len"], items["is_list"]
    ok = (items["well_formed"] & (items["count"] == 4) & ~il[:, 0] & ~il[:, 1]
          & (pl[:, 2] == 32) & (pl[:, 3] == 32) & (items["list_end"] == vlen))
    span32 = torch.arange(32, device=values.device)[None, :]
    return {
        "ok": ok,
        "nonce": _bytes_left_pad(values, ps[:, 0], pl[:, 0], 8),
        "balance": _bytes_left_pad(values, ps[:, 1], pl[:, 1], 32),
        "storage_root": _get(values, ps[:, 2:3] + span32).to(torch.uint8),
        "code_hash": _get(values, ps[:, 3:4] + span32).to(torch.uint8),
    }
