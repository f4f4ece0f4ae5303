"""The plain reference: Merkle-Patricia proof verification in PyTorch.

`verify` walks each proof from the trusted root as the Yellow Paper's trie
defines it: the root is the proof node whose Keccak-256 equals the root; a
branch node (17 RLP items) is left through the slot of the next key nibble
(an empty slot: the key is absent, EXCLUDED; a 32-byte reference: the next
node is the proof node with that hash, none: INVALID) or, with the key used
up, ends at its value slot; a leaf or extension node (2 items) holds a
hex-prefix path that must match the key's next nibbles (a leaf's whole rest
of the key: FOUND with its value, else EXCLUDED; an extension's prefix:
on to its child, else EXCLUDED). A node that is not a well-formed RLP list
of 2 or 17 items is INVALID, as is a walk longer than D + 6 steps.
Embedded (inline) child nodes, which a trie keyed by 32-byte hashes with
account values never holds, are INVALID here.

Every proof is walked at once, one step a loop; each step is whole-tensor
operations, so the reference runs on the card or the CPU alike. It takes
only the proof bytes, lengths, root and key that the traffic made, and
works out every digest and item itself.
"""

from __future__ import annotations

import torch

from .keccak import keccak256_rows

RUNNING, FOUND, EXCLUDED, INVALID = 0, 1, 2, 3


def _fetch(rows, lens, pos, k: int):
    """Bytes pos .. pos + k - 1 of each row (0 past its length), i64 [R, k]."""
    w = rows.shape[1]
    idx = pos[:, None] + torch.arange(k, device=rows.device)[None, :]
    b = torch.gather(rows, 1, idx.clamp(0, w - 1)).to(torch.int64)
    return torch.where((idx < lens[:, None]) & (idx >= 0), b, 0)


def _header(rows, lens, pos):
    """The RLP item at pos: (payload start, payload length, is list, ok)."""
    b = _fetch(rows, lens, pos, 3)
    b0 = b[:, 0]
    single = b0 < 0x80
    short_s = (b0 >= 0x80) & (b0 <= 0xB7)
    long_s = (b0 >= 0xB8) & (b0 <= 0xBF)
    short_l = (b0 >= 0xC0) & (b0 <= 0xF7)
    long_l = b0 >= 0xF8
    lol = torch.where(long_s, b0 - 0xB7, torch.where(long_l, b0 - 0xF7, 0))
    long_len = torch.where(lol == 1, b[:, 1], (b[:, 1] << 8) | b[:, 2])
    hl = torch.where(single, 0, 1 + lol)
    plen = torch.where(single, 1, torch.where(short_s, b0 - 0x80,
                       torch.where(short_l, b0 - 0xC0, long_len)))
    ok = (lol <= 2) & (pos + hl + plen <= lens)
    return pos + hl, plen, short_l | long_l, ok


def decode_nodes(rows, lens):
    """Each node's top-level RLP list: item count (up to 17), each item's
    payload start, length and list flag (i64 / bool [R, 17]), and whether
    the node is one well-formed list of 2 or 17 items filling its bytes."""
    r = rows.shape[0]
    dev = rows.device
    zero = torch.zeros(r, dtype=torch.int64, device=dev)
    start, plen, is_list, ok = _header(rows, lens, zero)
    end = start + plen
    wf = ok & is_list & (end == lens)
    cur = start
    count = zero.clone()
    st, ln, li = [], [], []
    for _ in range(17):
        present = cur < end
        s, n, lst, ok_i = _header(rows, lens, cur)
        wf &= ~present | (ok_i & (s + n <= end))
        st.append(torch.where(present, s, 0))
        ln.append(torch.where(present, n, 0))
        li.append(present & lst)
        count += present.to(torch.int64)
        cur = torch.where(present, s + n, cur)
    wf &= (cur == end) & ((count == 2) | (count == 17))
    return {"count": count, "start": torch.stack(st, 1), "len": torch.stack(ln, 1),
            "list": torch.stack(li, 1), "ok": wf}


def _lookup(digests, live, want):
    """First proof row whose digest equals want (u8 [B, 32]): (found, row)."""
    hit = (digests == want[:, None, :]).all(2) & live
    return hit.any(1), hit.to(torch.int64).argmax(1)


def verify(nodes, node_lens, num_nodes, roots, keys, max_value_len: int = 128,
           check_hashes: bool = True):
    """Verify B proofs: nodes u8 [B, D, W], node_lens [B, D], num_nodes
    [B], roots u8 [B, 32], keys u8 [B, 32]. Returns (status i64 [B], values
    u8 [B, max_value_len], value_lens i64 [B]); values are 0 past their
    length and value_lens 0 unless FOUND.

    check_hashes=False is the control: the walk takes the proof's nodes in
    order and never compares a digest, so it no longer proves anything."""
    b, d, w = nodes.shape
    dev = nodes.device
    node_lens = node_lens.to(torch.int64)
    num_nodes = num_nodes.to(torch.int64)
    live = torch.arange(d, device=dev)[None, :] < num_nodes[:, None]
    flat = nodes.reshape(b * d, w)
    flat_lens = torch.where(live, node_lens, 0).reshape(b * d)
    items = decode_nodes(flat, flat_lens)
    items = {k: v.view(b, d, *v.shape[1:]) for k, v in items.items()}
    digests = None
    if check_hashes:
        sel = live.reshape(-1).nonzero().squeeze(1)
        digests = torch.zeros((b * d, 32), dtype=torch.uint8, device=dev)
        digests[sel] = keccak256_rows(flat[sel], flat_lens[sel])
        digests = digests.view(b, d, 32)
    knib = torch.stack([keys.to(torch.int64) >> 4, keys.to(torch.int64) & 15],
                       2).reshape(b, 64)
    ar = torch.arange(b, device=dev)

    if check_hashes:
        has_root, cur = _lookup(digests, live, roots)
    else:
        has_root, cur = num_nodes > 0, torch.zeros(b, dtype=torch.int64, device=dev)
    status = torch.where(has_root, RUNNING, INVALID)
    key_pos = torch.zeros(b, dtype=torch.int64, device=dev)
    vnode = torch.zeros(b, dtype=torch.int64, device=dev)
    vstart = torch.zeros(b, dtype=torch.int64, device=dev)
    vlen = torch.zeros(b, dtype=torch.int64, device=dev)
    j64 = torch.arange(64, device=dev)[None, :]

    for _ in range(d + 6):
        run = status == RUNNING
        if not bool(run.any()):
            break
        cnt = items["count"][ar, cur]
        st = items["start"][ar, cur]
        ln = items["len"][ar, cur]
        li = items["list"][ar, cur]
        ok = items["ok"][ar, cur]
        row = nodes[ar, cur]
        rlen = node_lens[ar, cur]
        branch = ok & (cnt == 17)
        pair = ok & (cnt == 2)
        new = torch.where(ok, RUNNING, INVALID)
        child_st = torch.zeros_like(cur)
        child_ln = torch.zeros_like(cur)
        child_li = torch.zeros_like(run)
        step = torch.zeros_like(cur)
        go = torch.zeros_like(run)

        # branch
        used = key_pos >= 64
        nib = knib[ar, key_pos.clamp(max=63)]
        b_found = branch & used & (ln[:, 16] > 0)
        new = torch.where(branch & used, torch.where(b_found, FOUND, EXCLUDED), new)
        b_st = st.gather(1, nib[:, None])[:, 0]
        b_ln = ln.gather(1, nib[:, None])[:, 0]
        b_li = li.gather(1, nib[:, None])[:, 0]
        b_go = branch & ~used
        new = torch.where(b_go & ~b_li & (b_ln == 0), EXCLUDED, new)
        b_go = b_go & (b_li | (b_ln > 0))
        child_st = torch.where(b_go, b_st, child_st)
        child_ln = torch.where(b_go, b_ln, child_ln)
        child_li = torch.where(b_go, b_li, child_li)
        step = torch.where(b_go, 1, step)
        go |= b_go
        found_at = torch.where(b_found, st[:, 16], 0)
        found_len = torch.where(b_found, ln[:, 16], 0)

        # leaf or extension: a hex-prefix path in item 0
        p_st, p_ln = st[:, 0], ln[:, 0]
        hp = _fetch(row, rlen, p_st, 33)
        flag = hp[:, 0] >> 4
        odd = flag & 1
        hp_ok = ~li[:, 0] & (p_ln >= 1) & (flag <= 3) & ((odd == 1) | ((hp[:, 0] & 15) == 0))
        n_path = 2 * (p_ln - 1) + odd
        pn = torch.stack([hp >> 4, hp & 15], 2).reshape(b, 66)
        path = torch.where(odd[:, None] == 1, pn[:, 1:65], pn[:, 2:66])
        kidx = (key_pos[:, None] + j64).clamp(max=63)
        agree = ((j64 >= n_path[:, None]) | (path == knib.gather(1, kidx))).all(1)
        agree &= key_pos + n_path <= 64
        leaf = pair & hp_ok & (flag >= 2)
        ext = pair & hp_ok & (flag < 2)
        new = torch.where(pair & ~hp_ok, INVALID, new)
        l_found = leaf & agree & (key_pos + n_path == 64) & ~li[:, 1]
        new = torch.where(leaf, torch.where(l_found, FOUND,
                                            torch.where(agree & (key_pos + n_path == 64),
                                                        INVALID, EXCLUDED)), new)
        found_at = torch.where(l_found, st[:, 1], found_at)
        found_len = torch.where(l_found, ln[:, 1], found_len)
        new = torch.where(ext & (n_path == 0), INVALID, new)
        new = torch.where(ext & (n_path > 0) & ~agree, EXCLUDED, new)
        e_go = ext & (n_path > 0) & agree
        child_st = torch.where(e_go, st[:, 1], child_st)
        child_ln = torch.where(e_go, ln[:, 1], child_ln)
        child_li = torch.where(e_go, li[:, 1], child_li)
        step = torch.where(e_go, n_path, step)
        go |= e_go

        # the child: a 32-byte hash reference to another proof node
        ref = _fetch(row, rlen, child_st, 32).to(torch.uint8)
        if check_hashes:
            has, nxt = _lookup(digests, live, ref)
        else:
            nxt = cur + 1
            has = nxt < num_nodes
        good = go & ~child_li & (child_ln == 32) & has
        new = torch.where(go & ~good, INVALID, new)

        upd = run & (new != RUNNING)
        status = torch.where(upd, new, status)
        fnd = upd & (new == FOUND)
        vnode = torch.where(fnd, cur, vnode)
        vstart = torch.where(fnd, found_at, vstart)
        vlen = torch.where(fnd, found_len, vlen)
        adv = run & (new == RUNNING) & good
        cur = torch.where(adv, nxt, cur)
        key_pos = torch.where(adv, key_pos + step, key_pos)
        status = torch.where(run & (new == RUNNING) & ~good, INVALID, status)

    status = torch.where(status == RUNNING, INVALID, status)
    vlen = torch.where(status == FOUND, vlen, 0)
    vals = _fetch(nodes[ar, vnode], node_lens[ar, vnode], vstart, max_value_len)
    vals = torch.where(torch.arange(max_value_len, device=dev)[None, :] < vlen[:, None], vals, 0)
    return status, vals.to(torch.uint8), vlen
