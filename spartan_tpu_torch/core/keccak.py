"""Keccak-f[1600] permutation (host side).

Backs the STROBE-128 sponge used by the merlin transcript
(spartan_tpu.core.strobe / .merlin).  Fiat-Shamir hashing is inherently
sequential so it stays on host; per-proof traffic is a few hundred
permutations.  Validated against hashlib's SHA3 in tests (we rebuild
sha3-256 from this permutation and compare digests).
"""

from __future__ import annotations

_MASK = (1 << 64) - 1

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets r[x][y]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rol(v: int, n: int) -> int:
    n &= 63
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f1600(lanes: list[int]) -> list[int]:
    """In: 25 lanes (x + 5*y indexing), 64-bit ints. Out: permuted lanes."""
    a = list(lanes)
    for rnd in range(24):
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(a[x + 5 * y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y] & _MASK)
        # iota
        a[0] ^= _RC[rnd]
    return a


def keccak_f1600_bytes(state: bytearray) -> None:
    """Apply the permutation in place on a 200-byte state."""
    lanes = [int.from_bytes(state[8 * i : 8 * i + 8], "little") for i in range(25)]
    lanes = keccak_f1600(lanes)
    for i, lane in enumerate(lanes):
        state[8 * i : 8 * i + 8] = lane.to_bytes(8, "little")
