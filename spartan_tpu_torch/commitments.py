"""Pedersen commitment generators and commitment helpers.

Generator derivation mirrors the reference MultiCommitGens::new
(commitments.rs:14-33): SHAKE-256 over (label || compressed ristretto
basepoint), squeezed in 64-byte chunks, each mapped to the group by the
RFC 9496 one-way map.  Derivation is host-side; the row-MSM's table of
multiples ``tab[d][i] = d * G_i`` (precomputed affine form, see
``build_table``) and the generators themselves in extended coordinates
(``points``, for the device bullet rounds' variable-base MSM) are built
once per generator object and device and kept on the object, one entry
per device (the JAX package cached them in unbounded module dicts keyed
by ``id``).
"""

from __future__ import annotations

import ctypes
import hashlib
from functools import lru_cache

import numpy as np
import torch

from . import native
from .core import edwards as hed
from .core import ristretto as hri
from .core.field import P25519 as P
from .core.field import Q
from .curve import edwards as ed
from .ff import limb


class MultiCommitGens:
    """n generators G plus blinding generator h."""

    def __init__(self, n: int, label: bytes, _points=None):
        self.n = n
        self.label = label
        if _points is None:
            _points = _derive_gens(label, n + 1)
        self.G = list(_points[:n])
        self.h = _points[n]
        self._tables: dict = {}

    @staticmethod
    def _of(n, label, G, h) -> "MultiCommitGens":
        out = MultiCommitGens.__new__(MultiCommitGens)
        out.n, out.label, out.G, out.h = n, label, G, h
        out._tables = {}
        return out

    def split_at(self, mid: int) -> tuple["MultiCommitGens", "MultiCommitGens"]:
        """commitments.rs:53-66."""
        return (MultiCommitGens._of(mid, self.label, self.G[:mid], self.h),
                MultiCommitGens._of(self.n - mid, self.label, self.G[mid:],
                                    self.h))

    def msm_table(self, device) -> torch.Tensor:
        """(16, n, 3, 8) int32 multiples of G on ``device``."""
        return self._table("G", self.G, device)

    def msm_table_h(self, device) -> torch.Tensor:
        """(16, 1, 3, 8) int32 multiples of h on ``device``."""
        return self._table("h", [self.h], device)

    def points(self, device) -> torch.Tensor:
        """(n, 4, 8) int32: G in extended coordinates on ``device``."""
        return self._table("P", self.G, device)

    def _table(self, which: str, pts, device) -> torch.Tensor:
        key = (which, str(torch.device(device)))
        tab = self._tables.get(key)
        if tab is None:
            tab = (ed.stack(ed.from_host(pts, device)) if which == "P"
                   else build_table(pts, device))
            self._tables[key] = tab
        return tab


def build_table(points: list[hed.Point], device=None) -> torch.Tensor:
    """tab[v][i] = v * points[i] for v < 16 in the precomputed affine form
    (y+x, y-x, 2d*x*y), canonical, tab[0] the identity (1, 1, 0): (16, n,
    3, 8) int32 on ``device``.  Built on the host from chained unified
    adds and one batched inversion: in the native library, or in python
    ints without it (``_table_ints``)."""
    n = len(points)
    lib = native.get_lib()
    if lib is None:
        return limb.ints_to_limbs(_table_ints(points), device).reshape(
            16, n, 3, limb.NWORDS)
    out = ctypes.create_string_buffer(16 * n * 96)
    lib.spartan_ge_table_niels(b"".join(p._blob() for p in points), n, out)
    arr = np.frombuffer(out.raw, dtype="<i4").reshape(16, n, 3, limb.NWORDS)
    return torch.from_numpy(arr.copy()).to(device)


def _table_ints(points: list[hed.Point]) -> list[int]:
    """build_table's entries as python ints, in its order."""
    rows = [[hed.Point.identity()] * len(points), list(points)]
    for _ in range(2, 16):
        rows.append([a.add(p) for a, p in zip(rows[-1], points)])
    flat = [pt for row in rows for pt in row]
    prefix, acc = [], 1
    for pt in flat:
        prefix.append(acc)
        acc = acc * pt.Z % P
    inv = pow(acc, P - 2, P)
    out = [0] * (3 * len(flat))
    for k in range(len(flat) - 1, -1, -1):
        zi = inv * prefix[k] % P
        inv = inv * flat[k].Z % P
        x, y = flat[k].X * zi % P, flat[k].Y * zi % P
        out[3 * k:3 * k + 3] = [(y + x) % P, (y - x) % P, hed.D2 * x * y % P]
    return out


@lru_cache(maxsize=64)
def _derive_gens_cached(label: bytes, count: int) -> tuple:
    shake = hashlib.shake_256()
    shake.update(label)
    shake.update(hri.BASEPOINT_BYTES)
    stream = shake.digest(64 * count)
    return tuple(
        hri.from_uniform_bytes(stream[64 * i : 64 * i + 64]) for i in range(count)
    )


def _derive_gens(label: bytes, count: int) -> tuple:
    return _derive_gens_cached(bytes(label), count)


def commit_scalar(x: int, blind: int, gens: MultiCommitGens) -> hed.Point:
    """Scalar::commit (commitments.rs:75-80): x*G[0] + blind*h, on the
    constant-time host ladder (both are prover secrets)."""
    assert gens.n == 1
    return hed.msm_ct([x % Q, blind % Q], [gens.G[0], gens.h])


def commit_vector_host(xs, blind: int, gens: MultiCommitGens) -> hed.Point:
    """[Scalar]::commit on host (small secret vectors; sigma protocols)."""
    assert gens.n == len(xs)
    return hed.msm_ct([x % Q for x in xs] + [blind % Q], gens.G + [gens.h])
