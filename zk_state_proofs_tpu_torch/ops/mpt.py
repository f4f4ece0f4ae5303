"""Batched MPT proof verification — the port of `zk_state_proofs_tpu.ops.mpt`.

Verification is phase-split as in the JAX package:

  1. hash the deduplicated node pool (kernel K1, `keccak_cuda`);
  2. scatter digests and pack-time RLP offset hints to the per-proof table
     (a row gather — the JAX package's one-hot bf16 matmul was a TPU
     workaround; bytes never pass through a float matmul here, where TF32
     would corrupt them);
  3. walk every proof (kernel K2, `mpt_cuda`): a hinted mode with hints
     (pack-time hints, or the device hint pass `rlp.item_offsets`, kernel
     K4 on the card;
     `hinted` unless `hint_mode` names another), `bounded` mode without
     them, and an `exact` re-run of the batch when any overflow flag
     latches, decided on the card;
  4. extract the values (inside K2 on the card).

This module holds the plain PyTorch walk — `walk_kernel_plain`, the plain
version of K2, which a CPU tensor runs — and the entry points: the pooled
verify, and for witness sets resident on the card `verify_proofs_indexed`
(row gathers from a hashed pool), `verify_proofs_prehashed` (the walk
against digests already hashed) and `verify_proofs_pool_stream` (a fresh
pool each call). Each proof gets a status (FOUND / EXCLUDED / INVALID),
its value and, from the diagnostic entry points, the first failure class
(REASON_NAMES).
"""

from __future__ import annotations

import torch

from ..oracle.trie import EMPTY_ROOT
from ..utils.device import resolve_device
from ..utils.profiling import span
from . import mpt_cuda
from .keccak_cuda import keccak256_cuda
from .rlp import (bytes_to_nibbles_device, decode_node_bounded,
                  decode_node_hinted, decode_node_select, fetch_bytes,
                  item_offsets)

# status codes (per proof)
RUNNING = 0
FOUND = 1
EXCLUDED = 2
INVALID = 3

# INVALID reason codes (per proof)
R_NONE = 0           # proof not INVALID
R_MALFORMED = 1      # ill-formed RLP node / wrong item count / bad hex-prefix
R_BAD_CHILD_REF = 2  # hash child reference is not 32 bytes
R_HASH_MISMATCH = 3  # referenced digest matches no proof node
R_ROOT_MISSING = 4   # no proof node hashes to the trusted root
R_TRUNCATED = 5      # walk ran out of nodes/steps before a terminal
REASON_NAMES = {
    R_NONE: "ok",
    R_MALFORMED: "malformed-node",
    R_BAD_CHILD_REF: "bad-child-ref",
    R_HASH_MISMATCH: "hash-mismatch",
    R_ROOT_MISSING: "root-missing",
    R_TRUNCATED: "truncated",
}

# the walk's modes: the hinted family (pack-time hints; `hint_mode`), then
# the two serial decodes
HINT_MODES = ("hinted", "hinted4", "hinted1", "ordered", "pairskip")
WALK_MODES = HINT_MODES + ("bounded", "exact")


def check_hint_mode(hint_mode: str | None) -> str:
    """The hinted mode a walk with hints runs in: None is 'hinted';
    anything outside HINT_MODES raises ValueError."""
    mode = "hinted" if hint_mode is None else hint_mode
    if mode not in HINT_MODES:
        raise ValueError(f"hint_mode {hint_mode!r} not in {HINT_MODES}")
    return mode


def _step_pair(buf, key_nibbles, key_lens, key_pos, p0s, p0l, p0list):
    """Extension/leaf machinery: hex-prefix decode + nibble-path compare."""
    maxnib = key_nibbles.shape[1]
    path_window = fetch_bytes(buf, p0s, maxnib // 2 + 2)
    wnib = bytes_to_nibbles_device(path_window)
    b0 = path_window[:, 0]
    flag = b0 >> 4
    is_leaf = flag >= 2
    odd = flag & 1
    hp_ok = ~p0list & (p0l >= 1) & (flag <= 3) & ((odd == 1) | ((b0 & 0x0F) == 0))
    n_path = 2 * (p0l - 1) + odd
    # path nibble j lives at global nibble index j + (2 - odd)
    path_nib = torch.where((odd == 1)[:, None], wnib[:, 1:maxnib + 1],
                           wnib[:, 2:maxnib + 2])
    key_nib = fetch_bytes(key_nibbles, key_pos, maxnib)
    j = torch.arange(maxnib, device=buf.device)[None, :]
    within_key = key_pos + n_path <= key_lens
    match = ((j >= n_path[:, None]) | (path_nib == key_nib)).all(1) & within_key
    return {"is_leaf": is_leaf, "hp_ok": hp_ok, "n_path": n_path, "match": match}


def _first_match(digests, expected, num_nodes):
    """(any, first index) of rows dd < num_nodes with digests[:, dd] ==
    expected. digests u8 [B, D, 32], expected [B, 32]."""
    d = digests.shape[1]
    rows = (digests.to(torch.int64) == expected.to(torch.int64)[:, None, :]).all(2) & (
        torch.arange(d, device=digests.device)[None, :] < num_nodes[:, None])
    return rows.any(1), rows.to(torch.int64).argmax(1)


def _step_merge(buf, num_nodes, digests, key_lens, carry, items, pair):
    """Resolve the batch's transitions from decode + pair outputs
    (mirrors `zk_state_proofs_tpu.ops.mpt._step_merge`)."""
    node_idx, off, key_pos, status, vnode, vstart, vlen, reason = carry

    is_branch = items["count"] == 17
    is_pair = items["count"] == 2
    bad_node = ~items["well_formed"] | (~is_branch & ~is_pair)

    # ---- branch node ----
    key_exhausted = key_pos >= key_lens
    bval_len = items["i16_len"]
    branch_found = is_branch & key_exhausted & (bval_len > 0)
    branch_excl = is_branch & key_exhausted & (bval_len == 0)
    take_child = is_branch & ~key_exhausted
    child_empty = take_child & ~items["c_list"] & (items["c_len"] == 0)

    # ---- extension/leaf node ----
    is_leaf = pair["is_leaf"]
    n_path = pair["n_path"]
    nibbles_match = pair["match"]
    leaf_found = is_pair & is_leaf & nibbles_match & (key_pos + n_path == key_lens)
    leaf_excl = is_pair & is_leaf & ~leaf_found
    ext_bad = is_pair & ~is_leaf & (n_path == 0)  # empty extension path
    ext_excl = is_pair & ~is_leaf & ~nibbles_match
    ext_child = is_pair & ~is_leaf & nibbles_match & ~ext_bad
    bad_node = bad_node | (is_pair & ~pair["hp_ok"]) | ext_bad

    # ---- child reference (branch child or extension child) ----
    has_child = take_child & ~child_empty | ext_child
    cstart = torch.where(take_child, items["c_start"], items["i1_start"])
    cpay = torch.where(take_child, items["c_pay"], items["i1_pay"])
    cplen = torch.where(take_child, items["c_len"], items["i1_len"])
    clist = torch.where(take_child, items["c_list"], items["i1_list"])
    child_hash = has_child & ~clist & (cplen == 32)
    child_inline = has_child & clist
    child_bad = has_child & ~clist & (cplen != 32)

    # hash-referenced child: the first proof row whose digest matches
    have_next, nxt = _first_match(digests, fetch_bytes(buf, cpay, 32), num_nodes)
    hash_fail = child_hash & ~have_next

    new_status = torch.where(
        bad_node | child_bad | hash_fail, INVALID,
        torch.where(branch_found | leaf_found, FOUND,
                    torch.where(branch_excl | child_empty | leaf_excl | ext_excl,
                                EXCLUDED, RUNNING)))
    found_now = new_status == FOUND
    new_vnode = torch.where(found_now, node_idx, vnode)
    new_vstart = torch.where(
        found_now, torch.where(leaf_found, items["i1_pay"], items["i16_pay"]), vstart)
    new_vlen = torch.where(
        found_now, torch.where(leaf_found, items["i1_len"], items["i16_len"]), vlen)
    new_key_pos = torch.where(take_child, key_pos + 1,
                              torch.where(ext_child, key_pos + n_path, key_pos))
    new_node_idx = torch.where(child_hash, nxt, node_idx)
    new_off = torch.where(child_hash, 0, torch.where(child_inline, cstart, off))
    # first failure class that applied
    new_reason = torch.where(
        bad_node, R_MALFORMED,
        torch.where(child_bad, R_BAD_CHILD_REF,
                    torch.where(hash_fail, R_HASH_MISMATCH, reason)))

    live = status == RUNNING
    new = (new_node_idx, new_off, new_key_pos, new_status, new_vnode, new_vstart,
           new_vlen, new_reason)
    return tuple(torch.where(live, n, o) for n, o in zip(new, carry))


def _init_carry(num_nodes, digests, roots):
    """Find each proof's root node by digest (it may sit anywhere in the
    unordered proof list)."""
    empty_proof = num_nodes == 0
    empty_root = torch.tensor(list(EMPTY_ROOT), dtype=torch.int64, device=roots.device)
    root_is_empty = (roots.to(torch.int64) == empty_root).all(1)
    root_ok, root_idx = _first_match(digests, roots, num_nodes)
    status0 = torch.where(
        empty_proof, torch.where(root_is_empty, EXCLUDED, INVALID),
        torch.where(root_ok, RUNNING, INVALID))
    reason0 = torch.where(status0 == INVALID, R_ROOT_MISSING, R_NONE)
    zero = torch.zeros_like(root_idx)
    return (root_idx, zero, zero, status0, zero, zero, zero, reason0)


def _extract_value(nodes, carry, max_value_len: int):
    """Each proof's value bytes out of its terminal node, as a gather:
    value[j] = nodes[vnode, clip(vstart, 0, N4 - 1) + j] for j < vlen
    (0 past the buffer), N4 the node length rounded up to a multiple of 4.
    Returns value u8 [B, max_value_len], the values of
    `zk_state_proofs_tpu.ops.mpt._extract_value`."""
    _, _, _, _, vnode, vstart, vlen, _ = carry
    b = nodes.shape[0]
    ar = torch.arange(b, device=nodes.device)
    buf = nodes[ar, vnode]
    value = fetch_bytes(buf, vstart, max_value_len)
    j = torch.arange(max_value_len, device=nodes.device)[None, :]
    return torch.where(j < vlen[:, None], value, 0).to(torch.uint8)


def walk_kernel_plain(mode: str, nodes, node_lens, num_nodes, digests, roots,
                      key_nibbles, key_lens, max_value_len: int, max_steps: int,
                      hints=None):
    """The plain version of kernel K2 (`mpt_cuda.walk_lanes`): one walk of
    every proof in `mode`, without a fallback.

    nodes u8 [B, D, N], node_lens i32 [B, D], num_nodes i32 [B], digests u8
    [B, D, 32], roots u8 [B, 32], key_nibbles u8 [B, K], key_lens i32 [B],
    hints u8 [B, D, 36] (the HINT_MODES only).

    Returns (out i32 [B, 6], values u8 [B, max_value_len]); out's columns
    are the TPU kernel's six words: status (RUNNING -> INVALID), vnode,
    vstart, vlen, the overflow flag and the reason (R_TRUNCATED when steps
    ran out). values are masked by vlen (not yet zeroed unless FOUND).

    'exact' decodes every node serially; its results equal
    `zk_state_proofs_tpu.ops.mpt.walk_batch`. 'hinted' decodes at the hints
    (rlp.decode_node_hinted) and latches the overflow flag on a live proof
    whenever its hints are not proven or it steps into an inline child
    (off != 0). Its variants: 'hinted4' decodes branch slots 2..15 from
    four header bytes, without their long-form latch; 'ordered' reads, at
    step s, the node row min(s, D - 1) and latches the flag on a live proof
    whose node_idx differs; 'hinted1' and 'pairskip' compute what 'hinted'
    computes (their kernels differ only in how they read the node and gate
    the pair block) and share its plain decode. 'bounded' decodes
    serially through bounded windows
    (rlp.decode_node_bounded) and latches the flag on a live proof whose
    item lies past its window. Proofs whose flag stays 0 get the exact
    results; the caller re-runs the rest in 'exact'.

    In hinted mode the TPU kernel reads some windows of latched proofs
    through truncated prefixes; here every fetch is full width, so the
    flag agrees with the TPU kernel on every proof and the other words
    agree wherever the flag is 0. Bounded mode reads the TPU kernel's
    windows; its flag and words agree with the TPU kernel's except where
    a node's length exceeds its buffer (rlp.decode_node_bounded), where
    the port latches and the TPU kernel does not."""
    if mode not in WALK_MODES:
        raise ValueError(f"walk mode {mode!r} not in {WALK_MODES}")
    hinted = mode in HINT_MODES
    if hinted and hints is None:
        raise ValueError(f"{mode} mode needs hints")
    b, d, _ = nodes.shape
    ar = torch.arange(b, device=nodes.device)
    num_nodes = num_nodes.to(torch.int64)
    key_lens = key_lens.to(torch.int64)
    carry = _init_carry(num_nodes, digests, roots)
    ovf = torch.zeros_like(carry[0], dtype=torch.bool)
    kn = key_nibbles.shape[1]
    knib = key_nibbles.to(torch.int64)

    for step in range(max_steps):
        node_idx, off, key_pos, status = carry[:4]
        live = status == RUNNING
        if not bool(live.any()):  # later steps are no-ops
            break
        rows = node_idx  # the node row this step reads
        if mode == "ordered":
            rows = torch.full_like(node_idx, min(step, d - 1))
            ovf = ovf | (live & (node_idx != rows))
        buf = nodes[ar, rows]
        blen = node_lens[ar, rows].to(torch.int64)
        in_key = (key_pos >= 0) & (key_pos < kn)
        c_nib = torch.where(in_key, knib[ar, key_pos.clamp(0, kn - 1)], 0)
        if hinted:
            hrow = hints[ar, rows].to(torch.int64)
            h = (hrow[:, 0::2] << 8) | hrow[:, 1::2]
            items = decode_node_hinted(buf, h, blen, c_nib,
                                       short_slots=mode != "hinted4")
            ovf = ovf | (live & ((off != 0) | items["hint_ovf"]))
        elif mode == "bounded":
            items = decode_node_bounded(buf, off, blen, c_nib)
            ovf = ovf | (live & items["bound_ovf"])
        else:
            items = decode_node_select(buf, off, blen, c_nib)
        pair = _step_pair(buf, key_nibbles, key_lens, key_pos, items["i0_pay"],
                          items["i0_len"], items["i0_list"])
        carry = _step_merge(buf, num_nodes, digests, key_lens, carry, items, pair)

    values = _extract_value(nodes, carry, max_value_len)
    status = carry[3]
    running = status == RUNNING
    out = torch.stack([
        torch.where(running, INVALID, status), carry[4], carry[5], carry[6],
        ovf.to(torch.int64), torch.where(running, R_TRUNCATED, carry[7]),
    ], dim=1).to(torch.int32)
    return out, values


def walk_batch(nodes, node_lens, num_nodes, digests, roots, key_nibbles,
               key_lens, max_value_len: int, max_steps: int | None = None):
    """Batched walk over [B, D, N] proofs in plain PyTorch (the port of
    `zk_state_proofs_tpu.ops.mpt.walk_batch`). Returns (status i32 [B],
    values u8 [B, max_value_len], value_lens i32 [B], reasons i32 [B])."""
    if max_steps is None:
        max_steps = nodes.shape[1] + 6  # hashed depth + headroom for inline nodes
    out, values = walk_kernel_plain("exact", nodes, node_lens, num_nodes, digests,
                                    roots, key_nibbles, key_lens, max_value_len,
                                    max_steps)
    status = out[:, 0]
    vlen = torch.where(status == FOUND, out[:, 3], 0)
    return status, values, vlen, out[:, 5]


def walk_one(nodes, node_lens, num_nodes, digests, root, key_nibbles, key_len,
             max_value_len: int, max_steps: int | None = None):
    """One proof through walk_batch: nodes u8 [D, N], node_lens i32 [D],
    num_nodes and key_len 0-d, digests u8 [D, 32], root u8 [32],
    key_nibbles u8 [K] -> (status, value u8 [max_value_len], value_len)."""
    status, value, vlen, _ = walk_batch(
        nodes[None], node_lens[None], num_nodes[None], digests[None], root[None],
        key_nibbles[None], key_len[None], max_value_len, max_steps)
    return status[0], value[0], vlen[0]


def hash_nodes(nodes, node_lens):
    """Digest every padded proof node: u8 [B, D, N], i32 [B, D] -> u8
    [B, D, 32] (kernel K1 on the card, plain keccak on the CPU)."""
    b, d, n = nodes.shape
    dig = keccak256_cuda(nodes.reshape(b * d, n), node_lens.reshape(b * d))
    return dig.reshape(b, d, 32)


def _hash_pool_rows(pool_nodes, pool_lens, pool_segments=None):
    """Digest pool rows, optionally as one keccak launch per contiguous
    ((row_count, width), ...) segment (PackedProofs.pool_block_segments()),
    each row hashed from its first `width` bytes. Identical digests
    whenever every row's length fits its segment's width."""
    if pool_segments is None:
        return keccak256_cuda(pool_nodes, pool_lens)
    outs, off = [], 0
    for cnt, w in pool_segments:
        outs.append(keccak256_cuda(pool_nodes[off:off + cnt, :w],
                                   pool_lens[off:off + cnt]))
        off += cnt
    if off != pool_nodes.shape[0]:
        raise ValueError(
            f"pool_segments cover {off} rows, pool has {pool_nodes.shape[0]}")
    return torch.cat(outs)


def scatter_pool_payload(payload, pool_idx):
    """Row gather: payload u8 [U, W], pool_idx i32 [B, D] -> u8 [B, D, W]."""
    b, d = pool_idx.shape
    rows = torch.index_select(payload, 0, pool_idx.reshape(b * d).to(torch.int64))
    return rows.reshape(b, d, payload.shape[1])


def hash_nodes_pooled(pool_nodes, pool_lens, pool_idx, pool_hints=None,
                      pool_segments=None, with_hints: bool = False):
    """Digest the unique-node pool once and scatter to the per-proof table:
    -> digests u8 [B, D, 32], or (digests, hints u8 [B, D, 36]) when
    pool_hints (u8 [U, 36], PackedProofs.pool_hints()) is given or
    with_hints is set — the 36 hint bytes ride the same row gather. With
    with_hints and no pool_hints the hints come from the device pass
    (rlp.item_offsets over the pool rows)."""
    with span("zkp.hash"):
        payload = _hash_pool_rows(pool_nodes, pool_lens, pool_segments)
        with_hints = with_hints or pool_hints is not None
        if with_hints:
            if pool_hints is None:
                pool_hints = item_offsets(pool_nodes)
            payload = torch.cat([payload, pool_hints], dim=1)  # [U, 68]
        out = scatter_pool_payload(payload, pool_idx)
    if with_hints:
        return out[..., :32], out[..., 32:]
    return out


def hash_pool(pool_nodes, pool_lens):
    """Digest a unique-node pool: u8 [U, N], i32 [U] -> u8 [U, 32]."""
    with span("zkp.hash"):
        return keccak256_cuda(pool_nodes, pool_lens)


def verify_proofs_pooled(nodes, node_lens, num_nodes, roots, key_nibbles,
                         key_lens, pool_nodes, pool_lens, pool_idx,
                         pool_hints=None, max_value_len: int = 128,
                         max_steps: int | None = None, hinted: bool = True,
                         hint_mode: str | None = None,
                         depth_segments: tuple | None = None,
                         pool_segments: tuple | None = None):
    """Pooled batched verification — the main path. Every tensor lies on
    one device; a CUDA device runs kernels K1 and K2, the CPU their plain
    versions. Returns (status i32 [B], values u8 [B, max_value_len],
    value_lens i32 [B]).

    hinted=True walks in K2's hinted mode `hint_mode` (None is 'hinted';
    HINT_MODES; the JAX package's argument of that name, which replaces
    its ZKP_WALK_HINT_MODE and ZKP_WALK_HINT4 environment switches), with
    pool_hints (u8 [U, 36], PackedProofs.pool_hints()) or, without them,
    hints from the device pass `ops.rlp.item_offsets`, as the JAX package
    walks on the TPU; hinted=False walks `bounded`. Either is re-run in
    `exact` when any proof latches the overflow flag. Results are
    identical in every case. An unknown hint_mode raises ValueError.

    depth_segments: ((count, d), ...) covering the batch in order
    (PackedProofs.depth_segments()) — one walk per contiguous segment over
    its first d node rows. max_steps=None resolves once, from the global
    node axis (D + 6), never per segment, so truncation matches the
    unsegmented call.

    pool_segments: ((row_count, width), ...) covering the pool in order
    (PackedProofs.pool_block_segments()) — one keccak launch per segment
    at its trimmed width."""
    with span("zkp.verify"):
        hint_mode = check_hint_mode(hint_mode)
        table = hash_nodes_pooled(pool_nodes, pool_lens, pool_idx,
                                  pool_hints if hinted else None, pool_segments,
                                  with_hints=hinted)
        digests, hints = table if hinted else (table, None)
        args = (nodes, node_lens, num_nodes, digests, roots, key_nibbles, key_lens,
                max_value_len, max_steps)
        if depth_segments is None:
            return mpt_cuda.walk_batch_cuda(*args, hints=hints, hint_mode=hint_mode)
        return mpt_cuda.walk_batch_cuda_segmented(depth_segments, *args, hints=hints,
                                                  hint_mode=hint_mode)


def _on(device, *xs):
    """xs (tensors or numpy arrays; None stays None) on `device`; a CUDA
    device without a card raises."""
    dev = resolve_device(device)
    return [None if x is None else torch.as_tensor(x).to(dev) for x in xs]


def verify_proofs_indexed(pool_nodes, pool_lens, pool_digests, pool_idx,
                          num_nodes, roots, key_nibbles, key_lens,
                          pool_hints=None, max_value_len: int = 128,
                          max_steps: int | None = None, hinted: bool = True,
                          device="cuda"):
    """Verification against a witness pool resident on the card (port of
    `zk_state_proofs_tpu.ops.mpt.verify_proofs_indexed`): the pool's
    bytes, lengths and digests (`hash_pool`) stay on the device, and each
    call gathers its proofs' node rows from it by index.

    pool_nodes u8 [U, N], pool_lens i32 [U], pool_digests u8 [U, 32],
    pool_idx i32 [B, D], num_nodes i32 [B], roots u8 [B, 32], key_nibbles
    u8 [B, K], key_lens i32 [B]. hinted=True walks `hinted` with
    pool_hints (u8 [U, 36]) or, without them, the device hint pass over
    the pool; the hint rows ride the digest gather. hinted=False walks
    `bounded`. Every input goes to `device` ("cuda" unless named: K1 and
    K2; "cpu": their plain versions). Returns (status, values,
    value_lens)."""
    (pool_nodes, pool_lens, pool_digests, pool_idx, num_nodes, roots, key_nibbles,
     key_lens, pool_hints) = _on(device, pool_nodes, pool_lens, pool_digests,
                                 pool_idx, num_nodes, roots, key_nibbles, key_lens,
                                 pool_hints)
    b, d = pool_idx.shape
    flat = pool_idx.reshape(b * d).to(torch.int64)
    nodes = torch.index_select(pool_nodes, 0, flat).reshape(b, d, -1)
    node_lens = torch.index_select(pool_lens, 0, flat).reshape(b, d)
    hints = None
    if hinted:
        if pool_hints is None:
            pool_hints = item_offsets(pool_nodes)
        taken = torch.index_select(torch.cat([pool_digests, pool_hints], dim=1), 0,
                                   flat).reshape(b, d, 68)
        digests, hints = taken[..., :32], taken[..., 32:]
    else:
        digests = torch.index_select(pool_digests, 0, flat).reshape(b, d, 32)
    return mpt_cuda.walk_batch_cuda(nodes, node_lens, num_nodes, digests, roots,
                                    key_nibbles, key_lens, max_value_len, max_steps,
                                    hints=hints)


def verify_proofs_prehashed(nodes, node_lens, num_nodes, digests, roots,
                            key_nibbles, key_lens, hints=None,
                            max_value_len: int = 128,
                            max_steps: int | None = None, device="cuda"):
    """The walk alone, against digests hashed before (port of
    `zk_state_proofs_tpu.ops.mpt.verify_proofs_prehashed`): for resident
    sweeps whose per-proof tables were expanded once from a hashed pool.
    The digests must come from the same node bytes; the walk still checks
    every hash link against `roots`. hints (u8 [B, D, 36]) walk `hinted`,
    none `bounded`. Inputs go to `device`, as verify_proofs_indexed.
    Returns (status, values, value_lens)."""
    args = _on(device, nodes, node_lens, num_nodes, digests, roots, key_nibbles,
               key_lens, hints)
    return mpt_cuda.walk_batch_cuda(*args[:7], max_value_len, max_steps,
                                    hints=args[7])


def verify_proofs_pool_stream(pool_nodes, pool_lens, pool_idx, num_nodes, roots,
                              key_nibbles, key_lens, max_value_len: int = 128,
                              max_steps: int | None = None, device="cuda"):
    """Pooled verification from the pool alone (port of
    `zk_state_proofs_tpu.ops.mpt.verify_proofs_pool_stream`): the per-proof
    node tables are gathered on the device from the pool, so a fresh batch
    ships its pool, indices and per-proof scalars only. Hashes the pool
    (K1), then verify_proofs_indexed with the device hint pass. Returns
    (status, values, value_lens)."""
    pool_nodes, pool_lens = _on(device, pool_nodes, pool_lens)
    digests = hash_pool(pool_nodes, pool_lens)
    return verify_proofs_indexed(pool_nodes, pool_lens, digests, pool_idx,
                                 num_nodes, roots, key_nibbles, key_lens,
                                 max_value_len=max_value_len, max_steps=max_steps,
                                 device=device)


def verify_proofs(nodes, node_lens, num_nodes, roots, key_nibbles, key_lens,
                  max_value_len: int = 128, max_steps: int | None = None):
    """Batched verification without a pool: every node row is hashed.
    Returns (status, values, value_lens). Walks in K2's `bounded` mode,
    re-run in `exact` when any proof latches the overflow flag, as the
    JAX package does on the TPU."""
    digests = hash_nodes(nodes, node_lens)
    return mpt_cuda.walk_batch_cuda(nodes, node_lens, num_nodes, digests, roots,
                                    key_nibbles, key_lens, max_value_len, max_steps)


def verify_proofs_diagnose(nodes, node_lens, num_nodes, roots, key_nibbles,
                           key_lens, max_value_len: int = 128,
                           max_steps: int | None = None):
    """`verify_proofs` plus the per-proof INVALID reason (REASON_NAMES).
    Walks in `bounded` mode with the `exact` re-run, as verify_proofs
    does. Returns (status, values, value_lens, reasons)."""
    digests = hash_nodes(nodes, node_lens)
    return mpt_cuda.walk_batch_cuda(nodes, node_lens, num_nodes, digests, roots,
                                    key_nibbles, key_lens, max_value_len, max_steps,
                                    with_reasons=True)
