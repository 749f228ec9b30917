"""Kernel K5's plain version (``spartan_tpu_torch/curve/point_msm.py``),
the grouped variable-base MSM, on the CPU.

* Against python-int sums of ``core.edwards.Point.mul`` for random
  groups, empty and single-point groups, a group larger than the
  kernel's lanes, the scalars 0, 1 and q - 1 and the identity point.
* Once against the JAX package's ``curve/edwards.py::scalar_mul`` with
  ``sum_reduce`` (the XLA ops K5 replaces) at 4 points, one group: its
  sum recorded in ``tests/golden/port/point-msm-scalar-mul.npz``.
* The lane count and the argument checks the kernel relies on.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import random

import jax  # noqa: F401
import pytest
import torch

from golden.port.record import load, to_ints
from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu_torch.core import edwards as hed
from spartan_tpu_torch.core.field import P25519 as P
from spartan_tpu_torch.core.field import Q
from spartan_tpu_torch.curve import edwards as ed
from spartan_tpu_torch.curve import point_msm as pm
from spartan_tpu_torch.ff import limb


def _same_point(coords, want: hed.Point) -> bool:
    X, Y, Z, _ = coords
    return (X * want.Z - want.X * Z) % P == 0 and \
        (Y * want.Z - want.Y * Z) % P == 0


def _inputs(rng, n):
    pts = [hed.BASEPOINT.mul(rng.randrange(1, Q)) for _ in range(n)]
    ks = [rng.randrange(Q) for _ in range(n)]
    edges = [0, 1, Q - 1]
    ks[:len(edges)] = edges[:n]
    if n > 3:
        pts[3] = hed.Point.identity()
    return pts, ks


@pytest.mark.parametrize("sizes", [(3, 1, 0, 5), (2, 2, 2, 2), (70,)],
                         ids=["mixed", "pairs", "wider_than_lanes"])
def test_point_msm_plain_equals_python_ints(sizes):
    rng = random.Random(sum(sizes))
    pts, ks = _inputs(rng, sum(sizes))
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    out = pm.point_msm(ed.stack(ed.from_host(pts)),
                       limb.ints_to_limbs(ks), offs)
    assert out.shape == (len(sizes), 4, 8)
    cols = [limb.limbs_to_ints(out[:, c]) for c in range(4)]
    assert all(v < P for col in cols for v in col)  # canonical
    for g, (a, b) in enumerate(zip(offs, offs[1:])):
        want = hed.Point.identity()
        for pt, k in zip(pts[a:b], ks[a:b]):
            want = want.add(pt.mul(k))
        assert _same_point([col[g] for col in cols], want), g


def _scalar_mul_inputs():
    """4 points and scalars (``record.py`` reads them too)."""
    return _inputs(random.Random(4), 4)


def test_point_msm_plain_equals_jax_scalar_mul():
    pts, ks = _scalar_mul_inputs()
    got = pm.point_msm(ed.stack(ed.from_host(pts)), limb.ints_to_limbs(ks),
                       [0, 4])
    want = hed.Point(*to_ints(load("point-msm-scalar-mul")["point"]))
    assert _same_point([limb.limbs_to_ints(got[0, c])[0] for c in range(4)],
                       want)


def test_lanes_and_argument_checks():
    assert [pm.lanes(o) for o in ([0, 0], [0, 1], [0, 2, 4], [0, 7, 14],
                                  [0, 1026, 2052], [0, 3, 3])] == \
        [1, 1, 2, 8, 64, 4]
    pts = ed.stack(ed.from_host([hed.BASEPOINT] * 2))
    s = limb.ints_to_limbs([1, 2])
    with pytest.raises(ValueError):
        pm.point_msm(pts, s[:1], [0, 2])
    with pytest.raises(ValueError):
        pm.point_msm(pts[:, :3], s, [0, 2])
    with pytest.raises(ValueError):
        pm.point_msm(pts, s, [0, 1])  # offsets must end at N
    with pytest.raises(ValueError):
        pm.point_msm(pts, s, [0, 2, 1, 2])
    with pytest.raises(ValueError):
        pm.point_msm(pts, s.to(torch.int64), [0, 2])


def test_failed_build_raises(monkeypatch, tmp_path):
    """A kernel whose build fails raises when it is loaded: nothing falls
    back to the plain version (here the compiler is one that fails)."""
    from spartan_tpu_torch import _build

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(_build, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed for point_msm"):
        _build.load("point_msm", pm._declare)
    assert list(tmp_path.iterdir()) == []
