"""ristretto255 in plain Python (RFC 9496): twisted Edwards points
(a = -1) in extended coordinates as ``(X, Y, Z, T)`` tuples, the
canonical encoding, the one-way map that derives generators, and
variable-time multiscalar multiplication (the verifier's data is
public)."""

from __future__ import annotations

import hashlib

from .field import P, Q

D = -121665 * pow(121666, -1, P) % P
D2 = 2 * D % P
SQRT_M1 = 19681161376707505956807079304988542015446066515923890162744021073123829784752
SQRT_AD_MINUS_ONE = 25063068953384623474111414158702152701244531502492656460079210482610430750235
INVSQRT_A_MINUS_D = 54469307008909316920995813868745141605393597292927456921205312896311721017578
ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = (D - 1) * (D - 1) % P

IDENTITY = (0, 1, 1, 0)


def add(p, q):
    """add-2008-hwcd-3, unified."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = T1 * D2 % P * T2 % P
    DD = 2 * Z1 * Z2 % P
    E, F, G, H = B - A, DD - C, DD + C, B + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def double(p):
    """dbl-2008-hwcd with a = -1."""
    X1, Y1, Z1, _ = p
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = 2 * Z1 * Z1 % P
    E = ((X1 + Y1) * (X1 + Y1) - A - B) % P
    G = B - A
    F = G - C
    H = -A - B
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def neg(p):
    X, Y, Z, T = p
    return (-X % P, Y, Z, -T % P)


def equal(p, q) -> bool:
    """Ristretto equality (RFC 9496 4.5)."""
    X1, Y1 = p[0], p[1]
    X2, Y2 = q[0], q[1]
    return (X1 * Y2 - Y1 * X2) % P == 0 or (Y1 * Y2 - X1 * X2) % P == 0


def _is_neg(x: int) -> bool:
    return x % P & 1 == 1


def _abs(x: int) -> int:
    x %= P
    return P - x if x & 1 else x


def _sqrt_ratio_m1(u: int, v: int) -> tuple[bool, int]:
    u %= P
    v %= P
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    correct = check == u
    flipped = check == -u % P
    flipped_i = check == -u * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    return correct or flipped, _abs(r)


def decode(b: bytes):
    """The point of a canonical encoding, or None."""
    if len(b) != 32:
        return None
    s = int.from_bytes(b, "little")
    if s >= P or s & 1:
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sq = u2 * u2 % P
    v = (-(D * u1 % P * u1) - u2_sq) % P
    ok, invsqrt = _sqrt_ratio_m1(1, v * u2_sq % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = _abs(2 * s * den_x)
    y = u1 * den_y % P
    t = x * y % P
    if not ok or _is_neg(t) or y == 0:
        return None
    return (x, y, 1, t)


def encode(p) -> bytes:
    X, Y, Z, T = (c % P for c in p)
    u1 = (Z + Y) * (Z - Y) % P
    u2 = X * Y % P
    _, invsqrt = _sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * T % P
    if _is_neg(T * z_inv):
        x, y, den_inv = Y * SQRT_M1 % P, X * SQRT_M1 % P, \
            den1 * INVSQRT_A_MINUS_D % P
    else:
        x, y, den_inv = X, Y, den2
    if _is_neg(x * z_inv):
        y = -y % P
    return _abs(den_inv * (Z - y)).to_bytes(32, "little")


def _elligator(t: int):
    r = SQRT_M1 * t % P * t % P
    u = (r + 1) * ONE_MINUS_D_SQ % P
    v = (-1 - r * D) * (r + D) % P
    ok, s = _sqrt_ratio_m1(u, v)
    if ok:
        c = P - 1
    else:
        s = -_abs(s * t) % P
        c = r
    N = (c * (r - 1) % P * D_MINUS_ONE_SQ - v) % P
    w0 = 2 * s * v % P
    w1 = N * SQRT_AD_MINUS_ONE % P
    w2 = (1 - s * s) % P
    w3 = (1 + s * s) % P
    return (w0 * w3 % P, w2 * w1 % P, w1 * w3 % P, w0 * w2 % P)


def from_uniform_bytes(b: bytes):
    mask = (1 << 255) - 1
    t0 = (int.from_bytes(b[:32], "little") & mask) % P
    t1 = (int.from_bytes(b[32:], "little") & mask) % P
    return add(_elligator(t0), _elligator(t1))


BASEPOINT_Y = 4 * pow(5, -1, P) % P


def _basepoint():
    yy = BASEPOINT_Y * BASEPOINT_Y % P
    ok, x = _sqrt_ratio_m1(yy - 1, D * yy + 1)
    assert ok
    if x & 1:
        x = P - x
    return (x, BASEPOINT_Y, 1, x * BASEPOINT_Y % P)


def derive_generators(label: bytes, count: int) -> list:
    """The first ``count`` points of Spartan's generator stream for
    ``label`` (``commitments.rs``: SHAKE-256 over the label and the
    encoded base point, 64 bytes a point)."""
    shake = hashlib.shake_256(label + encode(_basepoint()))
    stream = shake.digest(64 * count)
    return [from_uniform_bytes(stream[64 * i:64 * i + 64])
            for i in range(count)]


def mul(p, k: int):
    """k p with 4-bit windows."""
    return msm([k], [p])


def _straus(scalars: list[int], points: list):
    tables = []
    for p in points:
        row = [IDENTITY, p]
        for _ in range(14):
            row.append(add(row[-1], p))
        tables.append(row)
    nbits = max(s.bit_length() for s in scalars)
    acc = IDENTITY
    for w in range((nbits + 3) // 4 - 1, -1, -1):
        acc = double(double(double(double(acc))))
        for s, tab in zip(scalars, tables):
            d = (s >> (4 * w)) & 15
            if d:
                acc = add(acc, tab[d])
    return acc


def msm(scalars: list[int], points: list):
    """sum_i scalars[i] points[i]: Straus for a few points, Pippenger's
    buckets for many."""
    if len(scalars) != len(points):
        raise ValueError("msm: as many scalars as points")
    pairs = [(s % Q, p) for s, p in zip(scalars, points) if s % Q]
    if not pairs:
        return IDENTITY
    scalars = [s for s, _ in pairs]
    points = [p for _, p in pairs]
    n = len(points)
    if n < 24:
        return _straus(scalars, points)
    c = max(4, n.bit_length() - 2)
    mask = (1 << c) - 1
    nbits = max(s.bit_length() for s in scalars)
    acc = None
    for w in range((nbits + c - 1) // c - 1, -1, -1):
        if acc is not None:
            for _ in range(c):
                acc = double(acc)
        buckets = [None] * (mask + 1)
        shift = w * c
        for s, p in zip(scalars, points):
            d = (s >> shift) & mask
            if d:
                b = buckets[d]
                buckets[d] = p if b is None else add(b, p)
        running = total = None
        for d in range(mask, 0, -1):
            b = buckets[d]
            if b is not None:
                running = b if running is None else add(running, b)
            if running is not None:
                total = running if total is None else add(total, running)
        if total is not None:
            acc = total if acc is None else add(acc, total)
    return IDENTITY if acc is None else acc
