"""Batched Keccak-256 in plain PyTorch — the plain version of kernel K1.

Port of `zk_state_proofs_tpu.ops.keccak`. The state is 25 64-bit lanes held
as (hi, lo) 32-bit halves, lane axis leading ([25, *batch]). The halves live
in int64 tensors and stay non-negative: PyTorch has no shifts for uint32 or
uint64, and `>>` on a negative int64 is arithmetic, so every left shift is
masked back to 32 bits. Ethereum's legacy padding (0x01 ... 0x80) is used.

This module is what a CPU tensor runs; `keccak_cuda.keccak256_cuda` (K1)
and `keccak_cuda.keccak256_cuda_raw` (K3) hold the kernels and dispatch
here for CPU tensors (`keccak256` and `keccak256_raw`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..oracle.keccak import RATE, ROTATION_OFFSETS, ROUND_CONSTANTS

LANES = 25
WORDS_PER_BLOCK = RATE // 8  # 17 u64 lanes absorbed per rate block
MASK32 = 0xFFFFFFFF

_RC_LO = [rc & MASK32 for rc in ROUND_CONSTANTS]
_RC_HI = [rc >> 32 for rc in ROUND_CONSTANTS]

# pi step as a single gather: out[i] = in[_PI_SRC[i]]
_PI_SRC = np.zeros(25, dtype=np.int64)
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
# post-pi rotation amounts: lane i is rotated by rho[_PI_SRC[i]]
_ROT = np.asarray(ROTATION_OFFSETS, dtype=np.int64)[_PI_SRC]


def rotl64(hi, lo, n):
    """Rotate the 64-bit lanes (hi, lo) left by n (an int, or an int64
    tensor broadcastable against hi, every amount in [0, 63])."""
    if isinstance(n, int):
        n = torch.tensor(n, dtype=torch.int64)
    swap = n >= 32
    h = torch.where(swap, lo, hi)
    l = torch.where(swap, hi, lo)
    m = n % 32
    # m == 0: `l >> 32` is 0 because the halves are < 2**32
    nh = ((h << m) & MASK32) | (l >> (32 - m))
    nl = ((l << m) & MASK32) | (h >> (32 - m))
    return nh, nl


def keccak_f1600(hi, lo):
    """Keccak-f[1600] permutation, batched. hi, lo: int64 [25, *batch]
    holding 32-bit halves (x + 5*y lane order). Returns the same shape."""
    batch_nd = hi.ndim - 1
    rot = torch.as_tensor(_ROT, device=hi.device).reshape((25,) + (1,) * batch_nd)
    pi = torch.as_tensor(_PI_SRC, device=hi.device)
    for r in range(24):
        gh = hi.reshape((5, 5) + hi.shape[1:])  # [y, x, *batch]
        gl = lo.reshape((5, 5) + lo.shape[1:])
        # theta: column parities and their neighbour mix
        ch = gh[0] ^ gh[1] ^ gh[2] ^ gh[3] ^ gh[4]  # [x, *batch]
        cl = gl[0] ^ gl[1] ^ gl[2] ^ gl[3] ^ gl[4]
        r1h, r1l = rotl64(ch, cl, 1)
        dh = torch.roll(ch, 1, dims=0) ^ torch.roll(r1h, -1, dims=0)
        dl = torch.roll(cl, 1, dims=0) ^ torch.roll(r1l, -1, dims=0)
        hi = (gh ^ dh[None]).reshape(hi.shape)
        lo = (gl ^ dl[None]).reshape(lo.shape)
        # pi (gather) then rho (per-lane rotation)
        hi, lo = rotl64(hi[pi], lo[pi], rot)
        # chi: b ^ (~b[x+1] & b[x+2]) along x (~ of a 32-bit half, masked)
        gh = hi.reshape((5, 5) + hi.shape[1:])
        gl = lo.reshape((5, 5) + lo.shape[1:])
        gh = gh ^ ((torch.roll(gh, -1, dims=1) ^ MASK32) & torch.roll(gh, -2, dims=1))
        gl = gl ^ ((torch.roll(gl, -1, dims=1) ^ MASK32) & torch.roll(gl, -2, dims=1))
        hi, lo = gh.reshape(hi.shape), gl.reshape(lo.shape)
        # iota: xor the round constant into lane 0
        hi = torch.cat([hi[:1] ^ _RC_HI[r], hi[1:]])
        lo = torch.cat([lo[:1] ^ _RC_LO[r], lo[1:]])
    return hi, lo


def pad_messages(data, lengths, num_blocks: int):
    """Keccak pad10*1 with the legacy 0x01 domain byte.

    data: uint8 [..., L], lengths: int32 [...]; returns uint8
    [..., num_blocks * RATE] with bytes past `length` zeroed, 0x01 at
    position `length` and 0x80 xored into the final byte of each message's
    last rate block. Bytes past L read as 0."""
    padded_len = num_blocks * RATE
    L = data.shape[-1]
    if L < padded_len:
        data = torch.nn.functional.pad(data, (0, padded_len - L))
    else:
        data = data[..., :padded_len]
    pos = torch.arange(padded_len, dtype=torch.int64, device=data.device)
    lengths = lengths.to(torch.int64)[..., None]
    msg = torch.where(pos < lengths, data, torch.zeros_like(data))
    msg = msg ^ ((pos == lengths).to(torch.uint8) * 0x01)
    last_byte = (torch.div(lengths, RATE, rounding_mode="floor") + 1) * RATE - 1
    msg = msg ^ ((pos == last_byte).to(torch.uint8) * 0x80)
    return msg


def bytes_to_lanes(block_bytes):
    """uint8 [..., RATE] -> (hi, lo) int64 [..., 17], little-endian lanes."""
    b = block_bytes.reshape(block_bytes.shape[:-1] + (WORDS_PER_BLOCK, 8)).to(torch.int64)
    lo = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    hi = b[..., 4] | (b[..., 5] << 8) | (b[..., 6] << 16) | (b[..., 7] << 24)
    return hi, lo


def lanes_to_bytes(hi, lo):
    """(hi, lo) int64 [..., n] -> uint8 [..., 8n], little-endian."""
    words = torch.stack([lo, hi], dim=-1)  # [..., n, 2]
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=hi.device)
    by = (words[..., None] >> shifts) & 0xFF  # [..., n, 2, 4]
    return by.to(torch.uint8).reshape(hi.shape[:-1] + (hi.shape[-1] * 8,))


def keccak256(data, lengths=None):
    """Batched Ethereum Keccak-256.

    data: uint8 [..., L]; lengths: int32 [...] (default: L). Returns uint8
    [..., 32]. Absorbs L // RATE + 1 blocks; a message absorbs only its own
    length // RATE + 1 of them (the rest leave its state unchanged)."""
    if lengths is None:
        lengths = torch.full(data.shape[:-1], data.shape[-1], dtype=torch.int32,
                             device=data.device)
    num_blocks = data.shape[-1] // RATE + 1
    padded = pad_messages(data, lengths, num_blocks)
    blocks = padded.reshape(padded.shape[:-1] + (num_blocks, RATE))
    nblocks = torch.div(lengths.to(torch.int64), RATE, rounding_mode="floor") + 1

    batch_shape = tuple(data.shape[:-1])
    hi = torch.zeros((LANES,) + batch_shape, dtype=torch.int64, device=data.device)
    lo = torch.zeros_like(hi)
    pad = (0,) * (2 * len(batch_shape)) + (0, LANES - WORDS_PER_BLOCK)
    for i in range(num_blocks):
        bh, bl = bytes_to_lanes(blocks[..., i, :])  # [..., 17]
        bh = torch.nn.functional.pad(torch.movedim(bh, -1, 0), pad)
        bl = torch.nn.functional.pad(torch.movedim(bl, -1, 0), pad)
        nh, nl = keccak_f1600(hi ^ bh, lo ^ bl)
        active = (i < nblocks)[None]
        hi, lo = torch.where(active, nh, hi), torch.where(active, nl, lo)
    out_hi = torch.movedim(hi[:4], 0, -1)  # [..., 4]
    out_lo = torch.movedim(lo[:4], 0, -1)
    return lanes_to_bytes(out_hi, out_lo)


def keccak256_fixed(data):
    """Keccak-256 of fixed-length messages: every row of data u8 [..., L]
    hashed whole, no length masking (port of
    `zk_state_proofs_tpu.ops.keccak.keccak256_fixed`)."""
    return keccak256(data)


def _raw_lane_half(words, nlen, q80, widx, q):
    """Lane halves from row words at word indices `widx` [17] (bytes
    q..q+3, q [17]): the raw bytes masked to the message length, the 0x01
    pad byte at `length` and the 0x80 byte at the last byte of the final
    rate block xored in (keccak_pallas.py:234-261). Words past the row
    read 0. words int64 [B, NW], nlen/q80 int64 [B, 1] -> int64 [B, 17]."""
    nw = words.shape[1]
    raw = torch.where(widx < nw, words[:, widx.clamp(max=nw - 1)], 0)
    nb = nlen - q  # bytes of this word inside the message
    mask = (1 << (8 * nb.clamp(0, 4))) - 1
    x = raw & mask
    x = x ^ torch.where((nb >= 0) & (nb <= 3), 1 << (8 * nb.clamp(0, 3)), 0)
    e = q80 - q
    return x ^ torch.where((e >= 0) & (e <= 3), 0x80 << (8 * e.clamp(0, 3)), 0)


def keccak256_raw(data, lengths=None):
    """The plain version of kernel K3 (`keccak_cuda.keccak256_cuda_raw`):
    Keccak-256 from little-endian u32 row words, with the pad10*1 bytes and
    the lane assembly done by masks on the words, as the TPU kernel
    `_keccak_kernel_raw` does. data u8 [B, L], lengths int [B] (default L)
    -> u8 [B, 32].

    Absorbs L // RATE + 1 blocks at most: block 0 always, block ib > 0
    while length // RATE + 1 > ib. Keccak lane j of block ib is words
    34*ib + 2j (low half) and 34*ib + 2j + 1 (high half)."""
    b, width = data.shape
    if lengths is None:
        lengths = torch.full((b,), width, dtype=torch.int32, device=data.device)
    num_blocks = width // RATE + 1
    l8 = -(-width // 8) * 8
    by = torch.nn.functional.pad(data, (0, l8 - width)).to(torch.int64)
    by = by.reshape(b, l8 // 4, 4)
    words = by[..., 0] | (by[..., 1] << 8) | (by[..., 2] << 16) | (by[..., 3] << 24)
    nlen = lengths.to(torch.int64)[:, None]
    nblk = torch.div(nlen, RATE, rounding_mode="floor") + 1
    q80 = nblk * RATE - 1  # byte position of the 0x80 domain bit
    j = torch.arange(WORDS_PER_BLOCK, device=data.device)
    hi = torch.zeros((LANES, b), dtype=torch.int64, device=data.device)
    lo = torch.zeros_like(hi)
    pad = (0, 0, 0, LANES - WORDS_PER_BLOCK)
    for ib in range(num_blocks):
        widx, q = 34 * ib + 2 * j, RATE * ib + 8 * j
        bl = _raw_lane_half(words, nlen, q80, widx, q)
        bh = _raw_lane_half(words, nlen, q80, widx + 1, q + 4)
        nh, nl = keccak_f1600(hi ^ torch.nn.functional.pad(bh.T, pad),
                              lo ^ torch.nn.functional.pad(bl.T, pad))
        active = (nblk[:, 0] > ib)[None] | (ib == 0)
        hi, lo = torch.where(active, nh, hi), torch.where(active, nl, lo)
    return lanes_to_bytes(hi[:4].T, lo[:4].T)
