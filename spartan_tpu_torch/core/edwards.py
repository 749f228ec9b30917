"""Host-side twisted Edwards curve arithmetic (curve25519, a = -1).

Extended homogeneous coordinates (X : Y : Z : T) with x = X/Z, y = Y/Z,
x*y = T/Z.  This is the exact-oracle counterpart of the batched device
point kernels in ``spartan_tpu.curve.edwards``; it plays the role the
curve25519-dalek backend plays for the reference (reference src/group.rs).
"""

from __future__ import annotations

from .field import P25519 as P
from .field import finv


def _native_lib():
    from .. import native

    return native.get_lib()

# Edwards d = -121665/121666 mod p.
D = (-121665 * pow(121666, -1, P)) % P
D2 = (2 * D) % P

# Base point: y = 4/5, x recovered with even sign.
BASE_Y = (4 * pow(5, -1, P)) % P


def _recover_x(y: int, sign: int) -> int | None:
    from .field import sqrt

    # x^2 = (y^2 - 1) / (d y^2 + 1)
    yy = y * y % P
    u = (yy - 1) % P
    v = (D * yy + 1) % P
    x = sqrt(u * finv(v, P) % P)
    if x is None:
        return None
    if x % 2 != sign:
        x = (P - x) % P
    return x


class Point:
    """Immutable extended-coordinate point."""

    __slots__ = ("X", "Y", "Z", "T")

    def __init__(self, X: int, Y: int, Z: int, T: int):
        self.X, self.Y, self.Z, self.T = X % P, Y % P, Z % P, T % P

    @staticmethod
    def identity() -> "Point":
        return Point(0, 1, 1, 0)

    @staticmethod
    def from_affine(x: int, y: int) -> "Point":
        return Point(x, y, 1, x * y % P)

    def add(self, o: "Point") -> "Point":
        # add-2008-hwcd-3 (unified; matches a = -1, k = 2d).
        p = P
        A = (self.Y - self.X) * (o.Y - o.X) % p
        B = (self.Y + self.X) * (o.Y + o.X) % p
        C = self.T * D2 % p * o.T % p
        Dd = 2 * self.Z % p * o.Z % p
        E = (B - A) % p
        F = (Dd - C) % p
        G = (Dd + C) % p
        H = (B + A) % p
        return Point(E * F % p, G * H % p, F * G % p, E * H % p)

    def double(self) -> "Point":
        # dbl-2008-hwcd with a = -1.
        p = P
        A = self.X * self.X % p
        B = self.Y * self.Y % p
        C = 2 * self.Z % p * self.Z % p
        Dn = (-A) % p
        E = ((self.X + self.Y) * (self.X + self.Y) - A - B) % p
        G = (Dn + B) % p
        F = (G - C) % p
        H = (Dn - B) % p
        return Point(E * F % p, G * H % p, F * G % p, E * H % p)

    def neg(self) -> "Point":
        return Point((-self.X) % P, self.Y, self.Z, (-self.T) % P)

    def _blob(self) -> bytes:
        """Native ABI: X|Y|Z|T, 32 canonical LE bytes each."""
        return b"".join(
            v.to_bytes(32, "little") for v in (self.X, self.Y, self.Z, self.T))

    @staticmethod
    def _from_blob(b: bytes) -> "Point":
        return Point(*(int.from_bytes(b[32 * i : 32 * i + 32], "little")
                       for i in range(4)))

    def mul(self, k: int) -> "Point":
        """Scalar multiplication (host path; variable time — fine for
        public data, mirroring the reference's vartime MSM use).  Uses
        the native windowed ladder when available."""
        k %= 2**256
        lib = _native_lib()
        if lib is not None:
            import ctypes

            out = ctypes.create_string_buffer(128)
            lib.spartan_ge_scalarmul(
                self._blob(), k.to_bytes(32, "little"), out)
            return Point._from_blob(out.raw)
        acc = Point.identity()
        add = self
        while k:
            if k & 1:
                acc = acc.add(add)
            add = add.double()
            k >>= 1
        return acc

    def to_affine(self) -> tuple[int, int]:
        zi = finv(self.Z, P)
        return (self.X * zi % P, self.Y * zi % P)

    def eq_ristretto(self, o: "Point") -> bool:
        """Ristretto equality: X1*Y2 == Y1*X2 or Y1*Y2 == X1*X2
        (RFC 9496 §4.5, a = -1)."""
        return (
            self.X * o.Y % P == self.Y * o.X % P
            or self.Y * o.Y % P == self.X * o.X % P
        )


BASEPOINT = Point.from_affine(_recover_x(BASE_Y, 0), BASE_Y)


def msm_ct(scalars: list[int], points: list["Point"]) -> Point:
    """Constant-time small MSM for SECRET scalars (blinds, committed
    round-poly coefficients): fixed-window ladder with branch-free
    masked table selection in native code (spartan_ge_msm_ct) — control
    flow and memory access independent of the scalar values, the
    analogue of the reference's `subtle`-based CT Scalar traits
    (ristretto255.rs:218-243).  Results equal msm() exactly.

    Without the native library there is no CT substrate (python ints
    are inherently value-dependent in time); falls back to the vartime
    path — acceptable only for tests/dev boxes without g++."""
    lib = _native_lib()
    if lib is not None and len(scalars) > 0:
        import ctypes

        pts = b"".join(p._blob() for p in points)
        sc = b"".join((int(s) % 2**256).to_bytes(32, "little")
                      for s in scalars)
        out = ctypes.create_string_buffer(128)
        lib.spartan_ge_msm_ct(pts, sc, len(scalars), out)
        return Point._from_blob(out.raw)
    return msm(scalars, points)


def msm(scalars: list[int], points: list["Point"]) -> Point:
    """Host multiscalar multiplication (native Pippenger when available;
    the bulk MSM lives on device — curve/msm.py).  Mirrors
    group.rs:98-117 semantics (variable time, public data)."""
    lib = _native_lib()
    if lib is not None and len(scalars) > 0:
        import ctypes

        pts = b"".join(p._blob() for p in points)
        sc = b"".join((int(s) % 2**256).to_bytes(32, "little")
                      for s in scalars)
        out = ctypes.create_string_buffer(128)
        lib.spartan_ge_msm(pts, sc, len(scalars), out)
        return Point._from_blob(out.raw)
    acc = Point.identity()
    for s, pt in zip(scalars, points):
        acc = acc.add(pt.mul(s))
    return acc
