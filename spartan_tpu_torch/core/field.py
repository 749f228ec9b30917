"""Host-side (python-int) prime field arithmetic.

This module is the *exact* reference oracle for the TPU limb kernels in
``spartan_tpu.ff``: every device kernel is differentially tested against
these functions.  It also backs the host-side protocol logic (transcript
scalars, tiny sigma-protocol algebra) where latency, not throughput,
matters.

Two fields are used by the ristretto255 group:

* ``P25519`` — the coordinate field, p = 2^255 - 19.
* ``Q`` — the scalar field (order of the ristretto255 group),
  q = 2^252 + 27742317777372353535851937790883648493.

Mirrors the behavior of the reference's scalar layer
(reference src/scalar/ristretto255.rs) without its Montgomery
internals: values here are canonical python ints in [0, modulus).
"""

from __future__ import annotations

# Coordinate field modulus of curve25519.
P25519 = 2**255 - 19

# Group order of ristretto255 (= order of the prime-order subgroup of
# curve25519); the scalar field Fq of the reference (ristretto255.rs:248-253).
Q = 2**252 + 27742317777372353535851937790883648493


def fadd(a: int, b: int, m: int = P25519) -> int:
    return (a + b) % m


def fsub(a: int, b: int, m: int = P25519) -> int:
    return (a - b) % m


def fmul(a: int, b: int, m: int = P25519) -> int:
    return (a * b) % m


def fneg(a: int, m: int = P25519) -> int:
    return (-a) % m


def fpow(a: int, e: int, m: int = P25519) -> int:
    return pow(a, e, m)


def finv(a: int, m: int = P25519) -> int:
    """Modular inverse; raises ZeroDivisionError on 0 (mirrors the
    reference's ``invert().unwrap()`` panics on zero)."""
    if a % m == 0:
        raise ZeroDivisionError("inverse of zero")
    return pow(a, -1, m)


def batch_inv(xs: list[int], m: int = Q) -> list[int]:
    """Montgomery batch inversion (ristretto255.rs:597-639)."""
    n = len(xs)
    if n == 0:
        return []
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        if x % m == 0:
            raise ZeroDivisionError("inverse of zero in batch")
        prefix[i + 1] = (prefix[i] * x) % m
    inv_all = finv(prefix[n], m)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = (prefix[i] * inv_all) % m
        inv_all = (inv_all * xs[i]) % m
    return out


# ---------------------------------------------------------------------------
# Canonical byte (de)serialization — little-endian 32 bytes, matching the
# wire format of the reference (ristretto255.rs:391-431).
# ---------------------------------------------------------------------------

def to_bytes(a: int) -> bytes:
    return int(a).to_bytes(32, "little")


def from_bytes(b: bytes, m: int) -> int | None:
    """Canonical decode: returns None when b encodes an int >= m
    (ristretto255.rs:391-414 returns CtOption none)."""
    assert len(b) == 32
    v = int.from_bytes(b, "little")
    if v >= m:
        return None
    return v


def from_bytes_mod_order(b: bytes, m: int) -> int:
    return int.from_bytes(b, "little") % m


def from_bytes_wide(b: bytes, m: int = Q) -> int:
    """64 uniform bytes -> field element (ristretto255.rs:435-466);
    used by merlin challenge_scalar (transcript.rs:26-30)."""
    assert len(b) == 64
    return int.from_bytes(b, "little") % m


# ---------------------------------------------------------------------------
# Square roots in Fp25519 (p = 5 mod 8) — the ristretto ingredient.
# ---------------------------------------------------------------------------

# sqrt(-1) mod p, the canonical (even) root.
SQRT_M1 = pow(2, (P25519 - 1) // 4, P25519)
if SQRT_M1 % 2 == 1:
    SQRT_M1 = P25519 - SQRT_M1


def is_negative(a: int) -> bool:
    """ristretto255's notion of sign: odd == negative (RFC 9496 §4.1)."""
    return (a % P25519) % 2 == 1


def ct_abs(a: int) -> int:
    a %= P25519
    return P25519 - a if a % 2 == 1 else a


def sqrt_ratio_m1(u: int, v: int) -> tuple[bool, int]:
    """(was_square, r) with r = sqrt(u/v) if u/v is square else
    sqrt(SQRT_M1 * u/v); r is non-negative. RFC 9496 §4.2."""
    p = P25519
    u %= p
    v %= p
    v3 = v * v % p * v % p
    v7 = v3 * v3 % p * v % p
    r = (u * v3 % p) * pow(u * v7 % p, (p - 5) // 8, p) % p
    check = v * r % p * r % p

    correct = check == u
    flipped = check == (p - u) % p
    flipped_i = check == (p - u) * SQRT_M1 % p

    if flipped or flipped_i:
        r = r * SQRT_M1 % p
    return (correct or flipped, ct_abs(r))


def sqrt(a: int) -> int | None:
    """Canonical (non-negative) sqrt in Fp25519, or None if non-square."""
    ok, r = sqrt_ratio_m1(a, 1)
    return r if ok else None
