"""The least time each kernel's work could take on an NVIDIA H100 SXM: the
larger of its bytes over the HBM rate and its 32-bit integer operations
over the ALU rate (ms). The constants and the counting rules are a frozen
copy of the port's kernel bounds (its `bench/common.py`), rewritten to take
the work from the traffic's own nodes and proofs, and to count what those
need: the distinct nodes a request hashes, each read once, and no padding
row of the program's own layout.
"""

from __future__ import annotations

import torch

from .mpt import decode_nodes

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock: Keccak's LOP3 and SHF
# issue only on the integer pipe
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# per absorbed block: 24 rounds of theta 80, rho and pi 48, chi 50, iota 2
# (three-input LOP3, a funnel shift per half of a 64-bit rotate), and the
# absorb's 17 lanes x 2 XOR
KECCAK_OPS_PER_BLOCK = 24 * (80 + 48 + 50 + 2) + 17 * 2
WALK_OPS_PER_NODE = 18 * 16  # per walked node: 18 RLP header decodes of 16
HEAD_OPS = 30  # per RLP head of the hint pass: 4 clamped reads, compares, the step
RATE = 136
DIGEST_BYTES = 32
HINT_BYTES = 36


def least_time(nbytes: float, ops: float) -> float:
    """ms: the larger of the bytes' and the operations' time."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3


def keccak_bound(lens: torch.Tensor) -> float:
    """Hashing rows of these lengths: each row's bytes and length read once,
    its digest written; L // 136 + 1 blocks a row."""
    lens = lens.to(torch.int64)
    nbytes = int(lens.sum()) + (4 + DIGEST_BYTES) * lens.numel()
    blocks = int((lens // RATE + 1).sum())
    return least_time(nbytes, blocks * KECCAK_OPS_PER_BLOCK)


def walk_bound(node_lens: torch.Tensor, num_nodes: torch.Tensor, key_nibbles: int,
               max_value_len: int, hinted: bool) -> float:
    """Walking these proofs (node_lens [B, D], num_nodes [B]): each live
    node's bytes, length and digest (and hints) read once, the root, key
    and counts read, six words and the value written; WALK_OPS_PER_NODE a
    live node."""
    b, d = node_lens.shape
    live = torch.arange(d, device=node_lens.device)[None] < num_nodes[:, None]
    n_live = int(live.sum())
    per_node = 4 + DIGEST_BYTES + (HINT_BYTES if hinted else 0)
    nbytes = (int(node_lens[live].to(torch.int64).sum()) + n_live * per_node
              + b * (32 + key_nibbles + 8) + b * (24 + max_value_len))
    return least_time(nbytes, n_live * WALK_OPS_PER_NODE)


def hint_pass_bound(rows: torch.Tensor, lens: torch.Tensor) -> float:
    """The device hint pass over these node rows (u8 [R, W]): the 32-byte
    sectors holding the 4-byte head windows its chain reads (the list's at
    0, then each present item's) read once, 36 hint bytes written a row;
    HEAD_OPS a head."""
    r, w = rows.shape
    dev = rows.device
    it = decode_nodes(rows, lens.to(torch.int64))
    count = it["count"]
    ends = it["start"] + it["len"]
    list_start = _list_payload_start(rows, lens)
    heads = torch.cat([list_start[:, None], ends[:, :16]], 1)  # item i's head
    present = torch.arange(17, device=dev)[None, :] < count[:, None]
    pos = torch.cat([torch.zeros_like(heads[:, :1]), heads], 1)
    read = torch.cat([torch.ones_like(present[:, :1]), present], 1) & (pos < w)
    n_sec = -(-w // 32)
    lo = torch.where(read, pos // 32, n_sec)
    hi = torch.where(read, (pos + 3).clamp(max=w - 1) // 32, n_sec)
    touched = torch.zeros((r, n_sec + 1), dtype=torch.bool, device=dev)
    touched.scatter_(1, torch.cat([lo, hi], 1), True)
    sectors = int(touched[:, :n_sec].sum())
    return least_time(sectors * 32 + r * HINT_BYTES, int(read.sum()) * HEAD_OPS)


def _list_payload_start(rows, lens):
    b0 = rows[:, 0].to(torch.int64)
    return torch.where(b0 >= 0xF8, 1 + b0 - 0xF7, 1)
