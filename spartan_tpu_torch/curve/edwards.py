"""Batched twisted-Edwards point arithmetic (extended coordinates,
a = -1) in plain PyTorch.

A point batch is a ``PointArray`` of four ``(..., 8)`` int32 coordinate
tensors (storage layout, canonical mod p), as the JAX package's
``PointArray`` holds four ``(..., 16)`` uint32 arrays.  ``add16`` /
``double16`` work on the compute layout (tuples of four ``(..., 16)``
int64 lazy coordinates) so that chains of point operations unpack once;
they are the formulas of the device kernels in ``csrc/fp25519.cuh``
(add-2008-hwcd-3, its mixed form ``madd16`` and dbl-2008-hwcd).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import edwards as host_ed
from ..ff import fp25519 as fp
from ..ff import limb


class PointArray(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor

    @property
    def shape(self):
        return self.x.shape[:-1]


def stack(p: PointArray) -> torch.Tensor:
    """PointArray (...,) -> (..., 4, 8) int32 (the kernels' layout)."""
    return torch.stack(list(p), dim=-2).contiguous()


def unstack(s: torch.Tensor) -> PointArray:
    return PointArray(*(s[..., k, :] for k in range(4)))


_D2 = host_ed.D2


def identity(shape=(), device=None) -> PointArray:
    zero = torch.zeros((*shape, limb.NWORDS), dtype=torch.int32,
                       device=device)
    one = zero.clone()
    one[..., 0] = 1
    return PointArray(zero, one, one.clone(), zero.clone())


# ---------------------------------------------------------------------------
# Compute layout: tuples of four (..., 16) int64 lazy coordinates
# ---------------------------------------------------------------------------

def _muls(xs, ys):
    """Independent products side by side: one mul16 over the stacked
    operands (the same products as one by one, fewer torch calls)."""
    return fp.mul16(torch.stack(torch.broadcast_tensors(*xs)),
                    torch.stack(torch.broadcast_tensors(*ys))).unbind(0)


def _ehfg(e, f, g, h):
    return tuple(_muls([e, g, f, e], [f, h, g, h]))


def add16(p, q):
    """Unified addition (add-2008-hwcd-3); valid for all inputs,
    doubling and the identity included."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    d2 = limb.const16(_D2, x1.device)
    a, b, c, zz = _muls(
        [fp.sub16(y1, x1), fp.add16(y1, x1), t1, z1],
        [fp.sub16(y2, x2), fp.add16(y2, x2), d2, z2])
    c = fp.mul16(c, t2)
    d = fp.dbl16(zz)
    e = fp.sub16(b, a)
    f = fp.sub16(d, c)
    g = fp.add16(d, c)
    h = fp.add16(b, a)
    return _ehfg(e, f, g, h)


def madd16(p, q):
    """Mixed addition: ``q`` is a precomputed affine entry (y+x, y-x,
    2d*x*y) with Z = 1, so it costs 7 products (``ge_madd`` in
    ``csrc/fp25519.cuh``); complete like ``add16``."""
    x1, y1, z1, t1 = p
    yp, ym, t2d = q
    a, b, c = _muls([fp.sub16(y1, x1), fp.add16(y1, x1), t1],
                    [ym, yp, t2d])
    d = fp.dbl16(z1)
    e = fp.sub16(b, a)
    f = fp.sub16(d, c)
    g = fp.add16(d, c)
    h = fp.add16(b, a)
    return _ehfg(e, f, g, h)


def double16(p):
    """dbl-2008-hwcd with a = -1."""
    x, y, z, _ = p
    u = fp.add16(x, y)
    a, b, zz, uu = _muls([x, y, z, u], [x, y, z, u])
    c = fp.dbl16(zz)
    d = fp.sub16(torch.zeros_like(a), a)
    e = fp.sub16(fp.sub16(uu, a), b)
    g = fp.add16(d, b)
    f = fp.sub16(g, c)
    h = fp.sub16(d, b)
    return _ehfg(e, f, g, h)


def unpack(p: PointArray):
    return tuple(limb.unpack(c) for c in p)


def pack(p16) -> PointArray:
    return PointArray(*(limb.pack(fp.canonical16(c)) for c in p16))


# ---------------------------------------------------------------------------
# Storage layout: canonical in, canonical out
# ---------------------------------------------------------------------------

def add(p: PointArray, q: PointArray) -> PointArray:
    return pack(add16(unpack(p), unpack(q)))


def double(p: PointArray) -> PointArray:
    return pack(double16(unpack(p)))


# ---------------------------------------------------------------------------
# Host boundary
# ---------------------------------------------------------------------------

def from_host(points: list[host_ed.Point], device=None) -> PointArray:
    def coord(attr):
        return limb.ints_to_limbs([getattr(pt, attr) for pt in points],
                                  device)

    return PointArray(coord("X"), coord("Y"), coord("Z"), coord("T"))


def to_host(p: PointArray) -> list[host_ed.Point]:
    cols = [limb.limbs_to_ints(c) for c in p]
    return [host_ed.Point(x, y, z, t) for x, y, z, t in zip(*cols)]
