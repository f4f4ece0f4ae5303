"""RLP node decoding for the MPT walk, as indexed loads.

Port of the parts of `zk_state_proofs_tpu.ops.rlp` that the walk uses. The
JAX package fetches bytes through one-hot matmuls (`ops/select.py`, a TPU
workaround for the missing vector gather); here a fetch is a `torch.gather`.
The clamp of those fetches is kept: a byte position is clipped into
[0, L4 - 1], L4 being the buffer length rounded up to a multiple of 4, and
bytes past the buffer read 0 — so a malformed header that drives a cursor
past the buffer decodes the same bytes as in the JAX package.

All functions are batched over a leading proof axis B; integers are int64
(every value fits in int32, so results equal the JAX package's int32 ones).
"""

from __future__ import annotations

import torch

MAX_ITEMS = 17  # branch node arity (16 children + value)
_SHORT_SLOTS = tuple(range(2, 16))  # branch slots decoded from their first byte


def fetch_bytes(buf, pos, width: int):
    """buf u8/int [B, L], pos int [B, ...] -> int64 [B, ..., width] with
    out[b, ..., j] = buf[b, p + j], p = clip(pos, 0, L4 - 1), 0 past L."""
    b, length = buf.shape
    l4 = -(-length // 4) * 4
    p = pos.to(torch.int64).clamp(0, l4 - 1)
    idx = p[..., None] + torch.arange(width, device=buf.device)
    flat = idx.reshape(b, -1)
    got = torch.gather(buf, 1, flat.clamp(max=length - 1)).to(torch.int64)
    got = torch.where(flat < length, got, torch.zeros_like(got))
    return got.reshape(idx.shape)


def item_head_window(win):
    """RLP item header from a window of >= 4 bytes starting at the item.
    win int [..., >=4] -> (payload_offset, payload_len, is_list, head_valid),
    the offset relative to the window start. Mirrors
    `zk_state_proofs_tpu.ops.rlp.item_head_window`."""
    w = win.to(torch.int64)
    b0, b1, b2, b3 = w[..., 0], w[..., 1], w[..., 2], w[..., 3]
    single = b0 < 0x80
    long_str = (b0 >= 0xB8) & (b0 <= 0xBF)
    long_list = b0 >= 0xF8
    is_list = b0 >= 0xC0
    zero = torch.zeros_like(b0)
    lol = torch.where(long_str, b0 - 0xB7, torch.where(long_list, b0 - 0xF7, zero))
    long_len = torch.where(
        lol == 1, b1,
        torch.where(lol == 2, (b1 << 8) | b2, (b1 << 16) | (b2 << 8) | b3))
    payload_len = torch.where(
        single, torch.ones_like(b0),
        torch.where(long_str | long_list, long_len,
                    torch.where(is_list, b0 - 0xC0, b0 - 0x80)))
    payload_off = torch.where(single, zero, 1 + lol)
    return payload_off, payload_len, is_list, lol <= 3


def _empty_sel(start):
    zero = torch.zeros_like(start)
    false = torch.zeros_like(start, dtype=torch.bool)
    return {
        "i0_pay": zero, "i0_len": zero, "i0_list": false,
        "i1_start": zero, "i1_pay": zero, "i1_len": zero, "i1_list": false,
        "i16_pay": zero, "i16_len": zero,
        "c_start": zero, "c_pay": zero, "c_len": zero, "c_list": false,
    }


def decode_node_select(buf, start, buf_len, child_idx):
    """Serial decode of each proof's node at byte offset `start`: the node
    header, then up to 17 items, one header fetch each (each item's offset
    depends on the previous header). The walk's `exact` mode.

    buf u8 [B, L]; start/buf_len/child_idx int [B]. Returns a dict of [B]
    tensors: count, well_formed, i0_pay/len/list, i1_start/pay/
    len/list, i16_pay/len, and c_start/pay/len/list for the slot at
    child_idx (mirrors `zk_state_proofs_tpu.ops.rlp.decode_node_select`)."""
    start = start.to(torch.int64)
    po, plen, is_list, head_ok = item_head_window(fetch_bytes(buf, start, 4))
    ps = start + po
    end = ps + plen
    sel = _empty_sel(start)
    cursor = ps
    count = torch.zeros_like(start)
    all_ok = torch.ones_like(start, dtype=torch.bool)
    for i in range(MAX_ITEMS):
        ipo, ipl, ilist, ok = item_head_window(fetch_bytes(buf, cursor, 4))
        ips = cursor + ipo
        present = cursor < end
        if i == 0:
            sel["i0_pay"], sel["i0_len"], sel["i0_list"] = ips, ipl, ilist
        if i == 1:
            sel["i1_start"], sel["i1_pay"], sel["i1_len"], sel["i1_list"] = (
                cursor, ips, ipl, ilist)
        if i == 16:
            sel["i16_pay"], sel["i16_len"] = ips, ipl
        if i < 16:
            hit = present & (child_idx == i)
            sel["c_start"] = torch.where(hit, cursor, sel["c_start"])
            sel["c_pay"] = torch.where(hit, ips, sel["c_pay"])
            sel["c_len"] = torch.where(hit, ipl, sel["c_len"])
            sel["c_list"] = torch.where(hit, ilist, sel["c_list"])
        count = count + present.to(torch.int64)
        all_ok = all_ok & (~present | ok)
        cursor = torch.where(present, ips + ipl, cursor)
    sel["count"] = count
    sel["well_formed"] = (is_list & head_ok & (cursor == end)
                          & (end <= buf_len) & all_ok)
    return sel


def _item_bound(i: int) -> int:
    """Item i of an honest branch or pair node starts within 10 + 35*i
    bytes of the node's first byte (header <= 4 B, branch items <= 33 B,
    pair path <= 35 B with its header)."""
    return 10 + 35 * i


_SH_ROWS = (_item_bound(16) + 8) // 4 + 3  # 147 words: covers every unlatched fetch


def _fetch_window(buf, base, rel, hi_rows: int, sh_rows: int):
    """The `bounded` mode's 4-byte fetch (mpt_pallas.py:556-580): bytes
    rel..rel+3 of the node seen through a window of `sh_rows` words that
    starts at byte `base` (a multiple of 4). The word index clamps,
    wp = clip(rel, 0, L4 - 1) >> 2, but the byte offset rel & 3 does not;
    a word wp >= hi_rows reads 0 (both words of the fetch), and so do
    bytes past the window or past the buffer."""
    b, length = buf.shape
    l4 = -(-length // 4) * 4
    wp = rel.clamp(0, l4 - 1) >> 2
    k = (4 * wp + (rel & 3))[:, None] + torch.arange(4, device=buf.device)
    absp = base[:, None] + k
    got = torch.gather(buf, 1, absp.clamp(0, length - 1)).to(torch.int64)
    live = (absp < length) & (k < 4 * sh_rows) & (wp < min(sh_rows, hi_rows))[:, None]
    return torch.where(live, got, 0)


def decode_node_bounded(buf, start, buf_len, child_idx):
    """Serial decode with window-bounded fetches — the walk's `bounded`
    mode (`zk_state_proofs_tpu/ops/mpt_pallas.py:540-636`).

    The node is read through a window of min(L4/4, 147) words starting at
    base = (clip(start, 0, L4 - 1) >> 2) * 4: the header at clip(start)
    through its first 3 words, item i through its first
    (10 + 35*i + 8) // 4 + 2 words (`_fetch_window`). Returns
    decode_node_select's dict plus `bound_ovf` [B]: a present item starts
    more than 10 + 35*i bytes past base, so its fetch may lie outside its
    window. The caller latches it (on live proofs) and re-runs the exact
    decode.

    Unlatched, every present fetch lies inside its window and reads the
    bytes of the exact decode's clamped fetch, with one exception: a
    present item at a cursor past L4 - 1, which needs a list end past the
    buffer and is well formed only if the node's length exceeds the
    buffer (node_lens > L). The TPU kernel does not latch that case and
    can then disagree with the exact decode (ROADMAP queue 3), so the port
    latches it too — `bound_ovf` is set on such a node when its list end
    fits its length."""
    b, length = buf.shape
    l4 = -(-length // 4) * 4
    sh_rows = min(l4 // 4, _SH_ROWS)
    start = start.to(torch.int64)
    head_at = start.clamp(0, l4 - 1)
    base = (head_at >> 2) * 4
    po, plen, is_list, head_ok = item_head_window(
        _fetch_window(buf, base, head_at - base, 3, sh_rows))
    ps = start + po
    end = ps + plen
    sel = _empty_sel(start)
    cursor = ps
    count = torch.zeros_like(start)
    all_ok = torch.ones_like(start, dtype=torch.bool)
    ovf = torch.zeros_like(start, dtype=torch.bool)
    past = torch.zeros_like(start, dtype=torch.bool)
    for i in range(MAX_ITEMS):
        present = cursor < end
        ovf = ovf | (present & (cursor - base > _item_bound(i)))
        past = past | (present & (cursor > l4 - 1))
        ipo, ipl, ilist, ok = item_head_window(_fetch_window(
            buf, base, cursor - base, (_item_bound(i) + 8) // 4 + 2, sh_rows))
        ips = cursor + ipo
        if i == 0:
            sel["i0_pay"], sel["i0_len"], sel["i0_list"] = ips, ipl, ilist
        if i == 1:
            sel["i1_start"], sel["i1_pay"], sel["i1_len"], sel["i1_list"] = (
                cursor, ips, ipl, ilist)
        if i == 16:
            sel["i16_pay"], sel["i16_len"] = ips, ipl
        if i < 16:
            hit = present & (child_idx == i)
            sel["c_start"] = torch.where(hit, cursor, sel["c_start"])
            sel["c_pay"] = torch.where(hit, ips, sel["c_pay"])
            sel["c_len"] = torch.where(hit, ipl, sel["c_len"])
            sel["c_list"] = torch.where(hit, ilist, sel["c_list"])
        count = count + present.to(torch.int64)
        all_ok = all_ok & (~present | ok)
        cursor = torch.where(present, ips + ipl, cursor)
    sel["count"] = count
    sel["well_formed"] = (is_list & head_ok & (cursor == end)
                          & (end <= buf_len) & all_ok)
    sel["bound_ovf"] = ovf | (past & (end <= buf_len))
    return sel


def decode_node_hinted(buf, h, buf_len, child_idx, short_slots: bool = True):
    """Parallel decode at offset hints — the walk's `hinted` mode
    (`zk_state_proofs_tpu/ops/mpt_pallas.py:351-539`).

    h int [B, 18]: the claimed cursors of the serial chain (payload start of
    the node list, then the boundary after each item; `pool_hints` rows).
    Every item header is fetched at its hinted position at once, and the
    chain law h[i+1] == h[i] + head_i + payload_i (h[i+1] == h[i] past the
    list end) is checked for all items together. With short_slots, branch
    slots 2..15 are decoded from their first byte alone (an honest trie
    holds only short-form items there); without it (the walk's `hinted4`
    mode) every item is decoded from four header bytes. The node header is
    read at offset 0.

    Returns decode_node_select's dict plus `hint_ovf` [B]: the hints are
    not proven (a chain-law break, a present item past the live-window
    bound 10 + 35*i, or, with short_slots, a long-form header in slots
    2..15). The caller
    latches it and re-runs the exact decode; the other fields are then
    meaningless. Where hint_ovf is false they equal the exact decode's."""
    h = h.to(torch.int64)
    zero = torch.zeros_like(buf_len, dtype=torch.int64)
    po, plen, is_list, head_ok = item_head_window(fetch_bytes(buf, zero, 4))
    ps = po
    end = ps + plen
    hi = h[:, :MAX_ITEMS]                                   # [B, 17]
    win = fetch_bytes(buf, hi, 4)                           # [B, 17, 4]
    ipo, ipl, ilist, ok = item_head_window(win)
    # first-byte-only header for branch slots 2..15
    b0 = win[..., 0]
    single = b0 < 0x80
    short_str = (b0 >= 0x80) & (b0 <= 0xB7)
    short_list = (b0 >= 0xC0) & (b0 <= 0xF7)
    longf = ~single & ~short_str & ~short_list
    slot = torch.zeros(MAX_ITEMS, dtype=torch.bool, device=buf.device)
    if short_slots:
        slot[list(_SHORT_SLOTS)] = True
    ipo = torch.where(slot, torch.where(single, 0, 1), ipo)
    ipl = torch.where(slot, torch.where(single, 1, torch.where(short_str, b0 - 0x80, b0 - 0xC0)), ipl)
    ilist = torch.where(slot, b0 >= 0xC0, ilist)
    ok = torch.where(slot, ~longf, ok)

    present = hi < end[:, None]
    bound = 10 + 35 * torch.arange(MAX_ITEMS, device=buf.device)
    ips = hi + ipo
    chain_ok = (h[:, 0] == ps) & torch.where(
        present, h[:, 1:] == ips + ipl, h[:, 1:] == hi).all(1)
    hint_ovf = ((present & (hi > bound)).any(1) | (present & slot & longf).any(1)
                | ~chain_ok)

    sel = _empty_sel(zero)
    sel["i0_pay"], sel["i0_len"], sel["i0_list"] = ips[:, 0], ipl[:, 0], ilist[:, 0]
    sel["i1_start"], sel["i1_pay"] = hi[:, 1], ips[:, 1]
    sel["i1_len"], sel["i1_list"] = ipl[:, 1], ilist[:, 1]
    sel["i16_pay"], sel["i16_len"] = ips[:, 16], ipl[:, 16]
    hit = present[:, :16] & (child_idx.to(torch.int64)[:, None]
                             == torch.arange(16, device=buf.device))
    sel["c_start"] = torch.where(hit, hi[:, :16], 0).sum(1)
    sel["c_pay"] = torch.where(hit, ips[:, :16], 0).sum(1)
    sel["c_len"] = torch.where(hit, ipl[:, :16], 0).sum(1)
    sel["c_list"] = (hit & ilist[:, :16]).any(1)
    sel["count"] = present.sum(1)
    sel["well_formed"] = (is_list & head_ok & (h[:, MAX_ITEMS] == end)
                          & (end <= buf_len) & (~present | ok).all(1))
    sel["hint_ovf"] = hint_ovf
    return sel


def bytes_to_nibbles_device(key_bytes):
    """[..., K] -> [..., 2K] nibble expansion (high first)."""
    hi = key_bytes >> 4
    lo = key_bytes & 0x0F
    return torch.stack([hi, lo], dim=-1).reshape(*key_bytes.shape[:-1],
                                                 key_bytes.shape[-1] * 2)
