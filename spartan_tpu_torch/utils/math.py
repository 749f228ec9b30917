"""Integer math helpers (reference src/math.rs:1-30)."""

from __future__ import annotations


def square_root(n: int) -> int:
    """math.rs:2-6 (usize::square_root)."""
    import math

    return math.isqrt(n)


def pow2(n: int) -> int:
    """math.rs:7-10: 2^n."""
    return 1 << n


def get_bits(n: int, num_bits: int) -> list[bool]:
    """math.rs:11-19: MSB-first bit vector of the low num_bits bits."""
    return [bool((n >> (num_bits - i - 1)) & 1) for i in range(num_bits)]


def log_2(n: int) -> int:
    """math.rs:20-29: exact log2 of a power of two (asserts like the
    reference's debug_assert)."""
    assert n > 0 and (n & (n - 1)) == 0, "log_2: not a power of two"
    return n.bit_length() - 1


def next_pow2(n: int) -> int:
    """lib.rs padding helper: smallest power of two >= n (>= 1)."""
    return 1 << (n - 1).bit_length() if n > 1 else 1
