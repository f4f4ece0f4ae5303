"""Pure-Python bit-exact Keccak-256 oracle.

The port's own copy of `zk_state_proofs_tpu.oracle.keccak`, so that the
port imports nothing of the JAX package.

Ethereum's *legacy* Keccak-256: sponge with rate 136 bytes, capacity 512 bits,
24 rounds of Keccak-f[1600], and the ORIGINAL Keccak padding (pad byte 0x01),
NOT the SHA-3 FIPS-202 padding (0x06).

This is the trusted slow reference against which every device kernel is
checked. Semantics mirror the reference framework's `digest_keccak`
(reference: crypto-ops/src/keccak.rs:6-12, backed by tiny-keccak's
Keccak-f[1600] sponge).
"""

from __future__ import annotations

RATE = 136  # bytes (1088-bit rate for Keccak-256)
ROUNDS = 24

# Round constants for the iota step (64-bit).
ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# Rotation offsets (rho step), indexed by lane x + 5*y.
ROTATION_OFFSETS = (
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
)

_MASK64 = (1 << 64) - 1


def _rotl64(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK64


def keccak_f1600(state: list[int]) -> list[int]:
    """One Keccak-f[1600] permutation over 25 64-bit lanes (x + 5*y order)."""
    a = list(state)
    for rc in ROUND_CONSTANTS:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi: b[y, 2x+3y] = rotl(a[x, y], r[x, y])
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl64(
                    a[x + 5 * y], ROTATION_OFFSETS[x + 5 * y]
                )
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ (
                    (~b[(x + 1) % 5 + 5 * y] & _MASK64) & b[(x + 2) % 5 + 5 * y]
                )
        # iota
        a[0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    """Ethereum Keccak-256 digest of `data` (legacy 0x01 padding)."""
    state = [0] * 25
    # pad10*1 with the legacy Keccak domain byte 0x01
    padded = bytearray(data)
    pad_len = RATE - (len(data) % RATE)
    padded += b"\x00" * pad_len
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    # absorb
    for off in range(0, len(padded), RATE):
        block = padded[off : off + RATE]
        for i in range(RATE // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f1600(state)
    # squeeze 32 bytes (single block, rate > 32)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out
