"""Pedersen commitment generators and commitment helpers.

Generator derivation mirrors the reference MultiCommitGens::new
(commitments.rs:14-33): SHAKE-256 over (label || compressed ristretto
basepoint), squeezed in 64-byte chunks, each mapped to the group by the
RFC 9496 one-way map.  Derivation is host-side; the row-MSM's table of
multiples ``tab[d][i] = d * G_i`` is built once per generator object and
device and kept on the object, one entry per device (the JAX package
cached it in an unbounded module dict keyed by ``id``).
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

import torch

from .core import edwards as hed
from .core import ristretto as hri
from .core.field import Q
from .curve import edwards as ded


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
        """(16, n, 4, 8) int32 multiples of G on ``device``."""
        return self._table("G", self.G, device)

    def msm_table_h(self, device) -> torch.Tensor:
        """(16, 1, 4, 8) int32 multiples of h on ``device``."""
        return self._table("h", [self.h], device)

    def _table(self, which: str, pts, device) -> torch.Tensor:
        key = (which, str(torch.device(device)))
        tab = self._tables.get(key)
        if tab is None:
            tab = build_table(ded.from_host(pts, device))
            self._tables[key] = tab
        return tab


def build_table(points: ded.PointArray) -> torch.Tensor:
    """tab[v][i] = v * points[i] for v < 16 (tab[0] the identity), by
    chained batched additions on the points' device, as the JAX
    package's ``_build_tab`` does.  (16, n, 4, 8) int32."""
    p16 = ded.unpack(points)
    rows = [ded.unpack(ded.identity(points.shape, points.x.device)), p16]
    for _ in range(2, 16):
        rows.append(ded.add16(rows[-1], p16))
    return torch.stack([ded.stack(ded.pack(r)) for r in rows], dim=0)


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
