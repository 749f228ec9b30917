"""Host-side ristretto255 group encoding (RFC 9496).

Provides the canonical 32-byte wire format (`encode`/`decode`), the
Elligator-based one-way map from 64 uniform bytes (`from_uniform_bytes`,
used for generator derivation, reference commitments.rs:15-33), and
ristretto equality.  These must match curve25519-dalek byte-for-byte;
validated against the RFC 9496 test vectors in tests/test_core_curve.py.
"""

from __future__ import annotations

from .field import P25519 as P
from .field import SQRT_M1, ct_abs, is_negative, sqrt_ratio_m1
from .edwards import BASEPOINT, D, Point

# Derived curve constants (RFC 9496 §4.1).
ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = (D - 1) * (D - 1) % P
# sqrt(a*d - 1) with a = -1  ->  sqrt(-d - 1)
SQRT_AD_MINUS_ONE = None
INVSQRT_A_MINUS_D = None


def _init_constants() -> None:
    global SQRT_AD_MINUS_ONE, INVSQRT_A_MINUS_D
    # RFC 9496 fixes the *odd* root for SQRT_AD_MINUS_ONE (it is given as an
    # explicit constant there, equal to dalek's); our sqrt helper returns the
    # even root, so pin the RFC value and check it.
    SQRT_AD_MINUS_ONE = (
        25063068953384623474111414158702152701244531502492656460079210482610430750235
    )
    assert SQRT_AD_MINUS_ONE * SQRT_AD_MINUS_ONE % P == (-D - 1) % P
    ok, r = sqrt_ratio_m1(1, (-1 - D) % P)
    assert ok
    INVSQRT_A_MINUS_D = r


_init_constants()


def _native_lib():
    from .. import native

    return native.get_lib()


def decode(b: bytes) -> Point | None:
    """RFC 9496 §4.3.1 DECODE. Returns None for invalid encodings
    (the reference surfaces this as DecompressionError, group.rs:14-21)."""
    if len(b) != 32:
        return None
    lib = _native_lib()
    if lib is not None:
        import ctypes

        out = ctypes.create_string_buffer(128)
        if lib.spartan_ristretto_decode(bytes(b), out) != 0:
            return None
        return Point._from_blob(out.raw)
    s = int.from_bytes(b, "little")
    if s >= P or is_negative(s):
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P * u1) - u2_sqr) % P
    was_square, invsqrt = sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = ct_abs(2 * s % P * den_x % P)
    y = u1 * den_y % P
    t = x * y % P
    if not was_square or is_negative(t) or y == 0:
        return None
    return Point(x, y, 1, t)


def encode(pt: Point) -> bytes:
    """RFC 9496 §4.3.2 ENCODE from extended coordinates."""
    lib = _native_lib()
    if lib is not None:
        import ctypes

        out = ctypes.create_string_buffer(32)
        lib.spartan_ristretto_encode(pt._blob(), out)
        return out.raw
    X, Y, Z, T = pt.X, pt.Y, pt.Z, pt.T
    u1 = (Z + Y) * (Z - Y) % P
    u2 = X * Y % P
    _, invsqrt = sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * T % P
    ix0 = X * SQRT_M1 % P
    iy0 = Y * SQRT_M1 % P
    enchanted_denominator = den1 * INVSQRT_A_MINUS_D % P
    rotate = is_negative(T * z_inv % P)
    if rotate:
        x, y, den_inv = iy0, ix0, enchanted_denominator
    else:
        x, y, den_inv = X, Y, den2
    if is_negative(x * z_inv % P):
        y = (-y) % P
    s = ct_abs(den_inv * ((Z - y) % P) % P)
    return int(s).to_bytes(32, "little")


def elligator_map(t: int) -> Point:
    """RFC 9496 §4.3.4 MAP: field element -> ristretto point."""
    r = SQRT_M1 * t % P * t % P
    u = (r + 1) * ONE_MINUS_D_SQ % P
    v = ((-1 - r * D) % P) * ((r + D) % P) % P
    was_square, s = sqrt_ratio_m1(u, v)
    s_prime = (-ct_abs(s * t % P)) % P
    if not was_square:
        s = s_prime
        c = r
    else:
        c = (-1) % P
    N = (c * ((r - 1) % P) % P * D_MINUS_ONE_SQ - v) % P
    w0 = 2 * s * v % P
    w1 = N * SQRT_AD_MINUS_ONE % P
    w2 = (1 - s * s) % P
    w3 = (1 + s * s) % P
    return Point(w0 * w3 % P, w2 * w1 % P, w1 * w3 % P, w0 * w2 % P)


def from_uniform_bytes(b: bytes) -> Point:
    """64 uniform bytes -> group element (RFC 9496 one-way map); matches
    dalek's RistrettoPoint::from_uniform_bytes used by MultiCommitGens
    (reference commitments.rs:15-33)."""
    assert len(b) == 64
    lib = _native_lib()
    if lib is not None:
        import ctypes

        out = ctypes.create_string_buffer(128)
        lib.spartan_ristretto_from_uniform(bytes(b), out)
        return Point._from_blob(out.raw)
    mask = (1 << 255) - 1
    t0 = (int.from_bytes(b[:32], "little") & mask) % P
    t1 = (int.from_bytes(b[32:], "little") & mask) % P
    return elligator_map(t0).add(elligator_map(t1))


BASEPOINT_BYTES = encode(BASEPOINT)
