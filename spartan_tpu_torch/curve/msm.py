"""Multi-scalar multiplication entry points.

The fixed-base device MSMs go through kernel B1 (``row_msm``):
``msm_rows`` is the row-batched commitment shape itself, ``msm`` is one
row.  ``vmsm`` is the host-facing vartime MSM of the protocols (python
ints, host points): below ``HOST_MAX`` points it stays on the host
(native Pippenger), as the JAX package's ``curve/msm.py:587-604`` does.
The variable-base MSMs of the bullet rounds, whose points change every
round (the folded generators), go through kernel K5
(``curve/point_msm.py``), chosen by ``protocols/bullet.py::DEVICE_MIN``
(a measured constant, not an option), and so do the device
dot-product-log's under ``SPARTAN_TPU_DEVICE_PROVER=1``.  The JAX
package's XLA MSM families were TPU compile choices and have no
counterpart here.
"""

from __future__ import annotations

import torch

from .. import native
from ..commitments import MultiCommitGens, build_table
from ..core import edwards as hed
from ..core.field import Q
from ..device import resolve
from ..ff import limb
from . import edwards as ed
from .row_msm import row_msm

HOST_MAX = 4096


def msm_rows(scalars: torch.Tensor, gens: MultiCommitGens) -> ed.PointArray:
    """out[l] = sum_i scalars[l, i] * gens.G[i]; scalars (L, R, 8)
    canonical, on the device the result lies on."""
    return ed.unstack(row_msm(scalars, gens.msm_table(scalars.device)))


def msm(scalars: torch.Tensor, points: list[hed.Point]) -> ed.PointArray:
    """sum_i scalars[i] * points[i] for (N, 8) canonical scalars: one
    row of the row-MSM (its multiples table is built here, once).
    Returns a PointArray of shape ()."""
    tab = build_table(points, scalars.device)
    return ed.unstack(row_msm(scalars[None], tab)[0])


def vmsm(scalars: list[int], points: list[hed.Point],
         device=None) -> hed.Point:
    """vartime_multiscalar_mul (reference group.rs:98-117): python-int
    scalars and host points in, host point out.  From HOST_MAX points
    on (or 192 without the native library) it runs on ``device``."""
    assert len(scalars) == len(points)
    n = len(scalars)
    if n == 0:
        return hed.Point.identity()
    host_max = HOST_MAX if native.available() else 192
    if n < host_max:
        return hed.msm(list(scalars), list(points))
    s = limb.ints_to_limbs([int(x) % Q for x in scalars], resolve(device))
    out = msm(s, list(points))
    return ed.to_host(ed.PointArray(*(c[None] for c in out)))[0]
