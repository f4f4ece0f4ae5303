"""Keccak-256 (the legacy padding Ethereum uses) in plain PyTorch.

One function, `keccak256_rows`, hashes every row of a byte table at once on
whatever device the table lies on: the state is a [25, R] int64 tensor, one
column a message, and each round is a few dozen whole-tensor operations.
Rows absorb only their own blocks (rows are ordered by block count, so the
rows still absorbing are a prefix). Nothing here imports the system under
test.
"""

from __future__ import annotations

import torch

RATE = 136  # bytes absorbed a block

_RC = (0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
       0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
       0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
       0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
       0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
       0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
       0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
       0x8000000000008080, 0x0000000080000001, 0x8000000080008008)
# rotation of lane x + 5y
_RHO = (0, 1, 62, 28, 27,
        36, 44, 6, 55, 20,
        3, 10, 43, 25, 39,
        41, 45, 15, 21, 8,
        18, 2, 61, 56, 14)


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _pi_source() -> list[int]:
    """src[dst]: pi moves lane (x, y) to (y, 2x + 3y)."""
    src = [0] * 25
    for x in range(5):
        for y in range(5):
            src[y + 5 * ((2 * x + 3 * y) % 5)] = x + 5 * y
    return src


_PI = _pi_source()


class _Tables:
    """The round constants and index tensors on one device."""

    def __init__(self, dev):
        def col(vals):
            return torch.tensor(vals, dtype=torch.int64, device=dev)[:, None]

        self.rc = [torch.tensor(_signed(c), dtype=torch.int64, device=dev) for c in _RC]
        self.rho_l = col(_RHO)
        self.rho_r = col([(64 - r) % 64 for r in _RHO])
        self.rho_m = col([(1 << r) - 1 for r in _RHO])
        self.pi = torch.tensor(_PI, dtype=torch.int64, device=dev)
        # chi: lane x + 5y with (x + 1, y) and (x + 2, y)
        self.chi1 = torch.tensor([(x + 1) % 5 + 5 * y for y in range(5) for x in range(5)],
                                 device=dev)
        self.chi2 = torch.tensor([(x + 2) % 5 + 5 * y for y in range(5) for x in range(5)],
                                 device=dev)


_TABLES: dict = {}


def _tables(dev) -> _Tables:
    key = str(dev)
    if key not in _TABLES:
        _TABLES[key] = _Tables(dev)
    return _TABLES[key]


def _rot1(x):
    """Rotate left by 1 (int64 lanes; >> is arithmetic, so mask)."""
    return (x << 1) | ((x >> 63) & 1)


def keccak_f(a, t: _Tables):
    """Keccak-f[1600] over a [25, R] int64 state (lane x + 5y in row x + 5y)."""
    r = a.shape[1]
    for rc in t.rc:
        c = a[0:5] ^ a[5:10] ^ a[10:15] ^ a[15:20] ^ a[20:25]
        d = c.roll(1, 0) ^ _rot1(c.roll(-1, 0))
        a = (a.view(5, 5, r) ^ d[None]).view(25, r)
        b = ((a << t.rho_l) | ((a >> t.rho_r) & t.rho_m))[t.pi]
        a = b ^ (~b[t.chi1] & b[t.chi2])
        a[0] ^= rc
    return a


def keccak256_rows(rows: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Keccak-256 of the first lens[i] bytes of each row: u8 [R, W], int [R]
    -> u8 [R, 32], on the rows' device."""
    dev = rows.device
    n = rows.shape[0]
    if n == 0:
        return torch.zeros((0, 32), dtype=torch.uint8, device=dev)
    lens = lens.to(device=dev, dtype=torch.int64)
    nblk = lens // RATE + 1
    order = torch.argsort(nblk, descending=True)
    lens_o = lens[order]
    nb_o = nblk[order]
    maxb = int(nb_o[0])
    width = maxb * RATE
    msg = torch.zeros((n, width), dtype=torch.uint8, device=dev)
    w = min(rows.shape[1], width)
    pos = torch.arange(w, device=dev)[None, :]
    msg[:, :w] = torch.where(pos < lens_o[:, None], rows[order, :w], 0)
    ar = torch.arange(n, device=dev)
    msg[ar, lens_o] ^= 0x01
    msg[ar, nb_o * RATE - 1] ^= 0x80
    lanes = msg.view(n, maxb, RATE).contiguous().view(torch.int64)  # [R, maxb, 17]
    counts = [int((nb_o > b).sum()) for b in range(maxb)]
    t = _tables(dev)
    state = torch.zeros((25, n), dtype=torch.int64, device=dev)
    for b in range(maxb):
        k = counts[b]
        s = state[:, :k].clone()
        s[:17] ^= lanes[:k, b, :].T
        state[:, :k] = keccak_f(s, t)
    out = torch.empty((n, 32), dtype=torch.uint8, device=dev)
    out[order] = state[:4].T.contiguous().view(torch.uint8).view(n, 32)
    return out


def keccak256(data: bytes, device="cpu") -> bytes:
    """Keccak-256 of one byte string (for tests and small tables)."""
    buf = torch.tensor(list(data) or [0], dtype=torch.uint8, device=device)[None]
    lens = torch.tensor([len(data)], device=device)
    return bytes(keccak256_rows(buf, lens)[0].cpu().tolist())
