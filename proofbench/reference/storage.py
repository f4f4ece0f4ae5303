"""The plain reference of two-level storage proofs: each account proof
against its state root, the account's leaf value decoded as RLP [nonce,
balance, storageRoot, codeHash], then each slot proof against its
account's storage root under the key keccak(slot). A slot under an account
that is not FOUND, or whose value is not such a list, is INVALID.

The account proofs go through `mpt.verify`. A storage trie holds inline
nodes (a leaf whose RLP is under 32 bytes lies inside its parent branch,
as the Yellow Paper's trie stores it), which `mpt.verify` refuses, so the
slot walk here (`verify_slots`) is `mpt.verify`'s with inline children: a
child item that is a list under 32 bytes is the next node, read in place;
a list child of 32 bytes or more is INVALID. Every slot proof without an
inline node gets `mpt.verify`'s answer.

Plain PyTorch, whole-tensor operations, on the card or the CPU alike;
nothing of the system under test.
"""

from __future__ import annotations

import torch

from .keccak import keccak256_rows
from .mpt import (EXCLUDED, FOUND, INVALID, RUNNING, _fetch, _header, _lookup, decode_nodes,
                  verify)

INLINE = 32  # a child node whose RLP is shorter lies inside its parent


def decode_accounts(values, value_lens) -> dict:
    """Account values u8 [A, V] of lengths [A]: ok bool [A] (one RLP list
    of four items filling the value, the first two strings, the last two
    32-byte strings), nonce u8 [A, 8] and balance u8 [A, 32] big-endian
    and left-padded (the last 8 or 32 bytes of a longer item),
    storage_root and code_hash u8 [A, 32]."""
    a = values.shape[0]
    dev = values.device
    lens = value_lens.to(torch.int64)
    start, plen, is_list, ok = _header(values, lens, torch.zeros(a, dtype=torch.int64,
                                                                 device=dev))
    end = start + plen
    ok = ok & is_list & (end == lens)
    cur = start
    items = []
    for _ in range(4):
        s, n, lst, ok_i = _header(values, lens, cur)
        ok = ok & ok_i & (cur < end) & ~lst
        items.append((s, n))
        cur = s + n
    ok = ok & (cur == end) & (items[2][1] == 32) & (items[3][1] == 32)

    def left_pad(item, width):
        s, n = item
        j = torch.arange(width, device=dev)[None, :]
        src = s[:, None] + n[:, None] - width + j
        return torch.where(src >= s[:, None], _gather(values, lens, src), 0).to(torch.uint8)

    return {"ok": ok, "nonce": left_pad(items[0], 8), "balance": left_pad(items[1], 32),
            "storage_root": _gather(values, lens, items[2][0][:, None]
                                    + torch.arange(32, device=dev)[None, :]).to(torch.uint8),
            "code_hash": _gather(values, lens, items[3][0][:, None]
                                 + torch.arange(32, device=dev)[None, :]).to(torch.uint8)}


def _gather(rows, lens, idx):
    """rows' bytes at idx i64 [R, K] (0 outside the row's length)."""
    w = rows.shape[1]
    b = torch.gather(rows, 1, idx.clamp(0, w - 1)).to(torch.int64)
    return torch.where((idx >= 0) & (idx < lens[:, None]), b, 0)


def verify_accounts(nodes, node_lens, num_nodes, roots, keys):
    """Account proofs (mpt.verify's arguments): (status i64 [A], the
    decoded fields of decode_accounts)."""
    status, values, vlens = verify(nodes, node_lens, num_nodes, roots, keys, 128)
    return status, decode_accounts(values, vlens)


def slot_keys(slots) -> torch.Tensor:
    """keccak of each raw slot's 32 bytes (u8 [B, >= 32]): the trie keys."""
    b = slots.shape[0]
    return keccak256_rows(slots[:, :32].contiguous(),
                          torch.full((b,), 32, dtype=torch.int64, device=slots.device))


def verify_slots(nodes, node_lens, num_nodes, roots, slots, max_value_len: int = 64):
    """Slot proofs: nodes u8 [B, D, W], node_lens [B, D], num_nodes [B],
    roots u8 [B, 32] (each slot's storage root), slots u8 [B, 32] raw (the
    keys are their Keccak). Returns (status i64 [B], values u8 [B,
    max_value_len], value_lens i64 [B]), as mpt.verify gives them, with
    inline children walked (see the module)."""
    b, d, w = nodes.shape
    dev = nodes.device
    keys = slot_keys(slots)
    node_lens = node_lens.to(torch.int64)
    num_nodes = num_nodes.to(torch.int64)
    live = torch.arange(d, device=dev)[None, :] < num_nodes[:, None]
    flat = nodes.reshape(b * d, w)
    flat_lens = torch.where(live, node_lens, 0).reshape(b * d)
    items = {k: v.view(b, d, *v.shape[1:]) for k, v in decode_nodes(flat, flat_lens).items()}
    sel = live.reshape(-1).nonzero().squeeze(1)
    digests = torch.zeros((b * d, 32), dtype=torch.uint8, device=dev)
    digests[sel] = keccak256_rows(flat[sel], flat_lens[sel])
    digests = digests.view(b, d, 32)
    knib = torch.stack([keys.to(torch.int64) >> 4, keys.to(torch.int64) & 15],
                       2).reshape(b, 64)
    ar = torch.arange(b, device=dev)
    zero = torch.zeros(b, dtype=torch.int64, device=dev)

    has_root, cur = _lookup(digests, live, roots)
    status = torch.where(has_root, RUNNING, INVALID)
    key_pos = zero.clone()
    # the node being read: proof row `cur`, or (inl) an inline node's bytes
    inl = torch.zeros(b, dtype=torch.bool, device=dev)
    inl_row = torch.zeros((b, w), dtype=torch.uint8, device=dev)
    inl_len = zero.clone()
    vals = torch.zeros((b, max_value_len), dtype=torch.int64, device=dev)
    vlen = zero.clone()
    j64 = torch.arange(64, device=dev)[None, :]
    j_in = torch.arange(INLINE, device=dev)[None, :]

    for _ in range(d + 6):
        run = status == RUNNING
        if not bool(run.any()):
            break
        row = torch.where(inl[:, None], inl_row, nodes[ar, cur])
        rlen = torch.where(inl, inl_len, node_lens[ar, cur])
        here = {k: v[ar, cur] for k, v in items.items()}
        if bool(inl.any()):
            own = decode_nodes(inl_row, inl_len)
            here = {k: torch.where(inl.view(-1, *([1] * (v.dim() - 1))), own[k], v)
                    for k, v in here.items()}
        cnt, st, ln, li, ok = (here[k] for k in ("count", "start", "len", "list", "ok"))
        branch = ok & (cnt == 17)
        pair = ok & (cnt == 2)
        new = torch.where(ok, RUNNING, INVALID)
        child = torch.zeros_like(cur)  # the item index of the child
        step = torch.zeros_like(cur)
        go = torch.zeros_like(run)

        # branch
        used = key_pos >= 64
        nib = knib[ar, key_pos.clamp(max=63)]
        b_found = branch & used & (ln[:, 16] > 0)
        new = torch.where(branch & used, torch.where(b_found, FOUND, EXCLUDED), new)
        b_ln = ln.gather(1, nib[:, None])[:, 0]
        b_li = li.gather(1, nib[:, None])[:, 0]
        b_go = branch & ~used
        new = torch.where(b_go & ~b_li & (b_ln == 0), EXCLUDED, new)
        b_go = b_go & (b_li | (b_ln > 0))
        child = torch.where(b_go, nib, child)
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
        child = torch.where(e_go, 1, child)
        step = torch.where(e_go, n_path, step)
        go |= e_go

        # the child: a 32-byte hash of another proof node, or an inline
        # node (a list under 32 bytes, from its header to its end)
        c_st = st.gather(1, child[:, None])[:, 0]
        c_ln = ln.gather(1, child[:, None])[:, 0]
        c_li = li.gather(1, child[:, None])[:, 0]
        list_start = _header(row, rlen, zero)[0]
        prev = (child - 1).clamp(min=0)[:, None]
        head = torch.where(child == 0, list_start,
                           st.gather(1, prev)[:, 0] + ln.gather(1, prev)[:, 0])
        c_size = c_st + c_ln - head
        has, nxt = _lookup(digests, live, _fetch(row, rlen, c_st, 32).to(torch.uint8))
        by_hash = go & ~c_li & (c_ln == 32) & has
        in_place = go & c_li & (c_size < INLINE)
        good = by_hash | in_place
        new = torch.where(go & ~good, INVALID, new)

        upd = run & (new != RUNNING)
        status = torch.where(upd, new, status)
        fnd = upd & (new == FOUND)
        got = _fetch(row, rlen, found_at, max_value_len)
        vals = torch.where(fnd[:, None], got, vals)
        vlen = torch.where(fnd, found_len, vlen)
        adv = run & (new == RUNNING) & good
        inner = torch.where(j_in < c_size[:, None], _fetch(row, rlen, head, INLINE), 0)
        moved = adv & in_place
        inl_row[:, :INLINE] = torch.where(moved[:, None], inner.to(torch.uint8),
                                          inl_row[:, :INLINE])
        inl_len = torch.where(moved, c_size, inl_len)
        cur = torch.where(adv & by_hash, nxt, cur)
        inl = torch.where(adv, in_place, inl)
        key_pos = torch.where(adv, key_pos + step, key_pos)
        status = torch.where(run & (new == RUNNING) & ~good, INVALID, status)

    status = torch.where(status == RUNNING, INVALID, status)
    vlen = torch.where(status == FOUND, vlen, 0)
    vals = torch.where(torch.arange(max_value_len, device=dev)[None, :] < vlen[:, None], vals, 0)
    return status, vals.to(torch.uint8), vlen


def override(status, values, value_lens, account_ok):
    """The slot answers with every slot whose account_ok (bool [B], its
    account's) is false made INVALID, with no value."""
    status = torch.where(account_ok, status, INVALID)
    value_lens = torch.where(account_ok, value_lens, 0)
    return status, torch.where(account_ok[:, None], values, 0), value_lens
