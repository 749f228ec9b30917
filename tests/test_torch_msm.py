"""The port's curve layer and the plain version of kernel B1 (row-MSM)
against the JAX package.

* The lazy mod-p ops and the unified point addition against the TPU
  kernel's own ``_FpLazy`` and ``_padd`` (``curve/pallas_msm.py``), run
  eagerly with ``_roll`` patched to ``jnp.roll`` as the JAX package's
  ``tests/test_pallas_msm.py`` does; their outputs are recorded in
  ``tests/golden/port/msm-*.npz``.
* ``row_msm_plain`` against ``spartan_tpu.core.edwards.msm`` at the
  shapes of ``tests/test_pallas_msm.py`` (tiny, R not a power of two,
  more lanes, R = 1), with the generators carried across from the JAX
  package's ``MultiCommitGens.device_G`` through ``interop``.

Everything is exact: residues and ristretto encodings compare equal.
"""

import hashlib
import random

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from golden.port.record import load, to_ints
from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu import commitments as jcom
from spartan_tpu.core import edwards as jed
from spartan_tpu.core import ristretto as jri
from spartan_tpu.core.field import P25519 as P
from spartan_tpu.core.field import Q
from spartan_tpu_torch import commitments, interop, native
from spartan_tpu_torch.curve import edwards as ed
from spartan_tpu_torch.curve import msm as dmsm
from spartan_tpu_torch.curve import ristretto as dri
from spartan_tpu_torch.curve import row_msm as rm
from spartan_tpu_torch.ff import fp25519 as fp
from spartan_tpu_torch.ff import limb

M = (1 << 256) - 1


def _lazy_inputs():
    """Operands of the lazy ops, 2^256 - 1, p and p - 1 among them
    (``record.py`` reads them too)."""
    rng = random.Random(21)
    A = [M, 0, P, 1] + [rng.randrange(1 << 256) for _ in range(4)]
    B = [M, M, P - 1, 0] + [rng.randrange(1 << 256) for _ in range(4)]
    return A, B


def test_lazy_ops_match_tpu_kernel_fplazy():
    A, B = _lazy_inputs()
    a16, b16 = limb.from_int16(A), limb.from_int16(B)
    jax_ops = load("msm-fplazy-ops")
    for ours, theirs in ((fp.mul16, "mul"), (fp.add16, "add"),
                         (fp.sub16, "sub")):
        got = [v % P for v in limb.to_int16(ours(a16, b16))]
        assert got == to_ints(jax_ops[theirs])


def _points(n, tag=b"t"):
    return [jri.from_uniform_bytes(hashlib.sha512(tag + bytes([i])).digest())
            for i in range(n)]


def _padd_inputs():
    """Three pairs of points, the last a doubling through the unified
    formula (``record.py`` reads them too)."""
    p1, p2 = _points(3, b"a"), _points(3, b"b")
    p2[2] = p1[2]
    return p1, p2


def test_point_add_matches_tpu_kernel_padd():
    """Same formula (add-2008-hwcd-3), so the same coordinates mod p."""
    p1, p2 = _padd_inputs()
    want = to_ints(load("msm-padd")["coords"])
    got = ed.add(ed.from_host(p1), ed.from_host(p2))
    assert [fp.decode_to_ints(c) for c in got] == want
    for w, q in enumerate(ed.to_host(got)):
        assert jri.encode(q) == jri.encode(p1[w].add(p2[w]))


def test_double_matches_host():
    pts = _points(4) + [jed.Point.identity()]
    d = ed.to_host(ed.double(ed.from_host(pts)))
    for p, dp in zip(pts, d):
        assert jri.encode(dp) == jri.encode(p.double())


def test_gens_match_jax_package():
    ours = commitments.MultiCommitGens(8, b"gens_test")
    theirs = jcom.MultiCommitGens(8, b"gens_test")
    assert [jri.encode(g) for g in ours.G + [ours.h]] == [
        jri.encode(g) for g in theirs.G + [theirs.h]]


def test_multiples_table():
    """Entries in the precomputed affine form: tab[d][i] = (y+x, y-x,
    2d*x*y) of the host's d * G_i, canonical; the identity is (1, 1, 0)."""
    pts = _points(5)
    tab = commitments.build_table(pts)
    assert tab.shape == (16, 5, 3, 8)
    for d in range(16):
        ent = [fp.decode_to_ints(tab[d, :, k]) for k in range(3)]
        for i, p in enumerate(pts):
            x, y = p.mul(d).to_affine() if d else (0, 1)
            assert [e[i] for e in ent] == [(y + x) % P, (y - x) % P,
                                           jed.D2 * x * y % P]


def test_multiples_table_native_and_python_agree():
    pts = _points(3) + [jed.Point.identity()]
    if not native.available():
        pytest.skip("no native host library (g++) on this machine")
    want = limb.ints_to_limbs(commitments._table_ints(pts)).reshape(16, 4, 3, 8)
    assert torch.equal(commitments.build_table(pts), want)


def test_madd16_matches_host():
    """The mixed add against the host's unified addition, the identity on
    either side included."""
    pts = _points(4) + [jed.Point.identity()]
    qs = _points(4, b"q") + [jed.Point.identity()]
    tab1 = limb.unpack(commitments.build_table(qs)[1])
    pre = tuple(tab1[:, k] for k in range(3))
    got = ed.to_host(ed.pack(ed.madd16(ed.unpack(ed.from_host(pts)), pre)))
    for p, q, g in zip(pts, qs, got):
        assert jri.encode(g) == jri.encode(p.add(q))


@pytest.mark.parametrize("L,R", [(4, 16), (3, 20), (2, 24), (4, 1)])
def test_row_msm_plain_vs_host_msm(L, R):
    rng = random.Random(L * 100 + R)
    gens = jcom.MultiCommitGens(R, b"row_msm_test")
    dG = gens.device_G  # the JAX package's device generators
    pts = interop.points_from_jax(*(np.asarray(c) for c in dG))
    ks = ([0, 1, 2, 15, 16, Q - 1]
          + [rng.randrange(Q) for _ in range(L * R)])[:L * R]
    s = limb.ints_to_limbs(ks).reshape(L, R, 8)
    out = rm.row_msm(s, commitments.build_table(ed.to_host(pts)))
    assert out.shape == (L, 4, 8)
    got = dri.compress_to_bytes(ed.unstack(out))
    for l in range(L):
        want = jed.msm(ks[l * R:(l + 1) * R], gens.G)
        assert got[l] == jri.encode(want)


def test_segments():
    assert rm.segments(1024, 1024) == 1
    assert rm.segments(1024, 1) == 1
    assert rm.segments(1, 4096) == 64
    assert rm.segments(1, 128) == 4
    assert rm.segments(3, 20) == 1


@pytest.mark.parametrize("R", [64, 256])
def test_row_msm_plain_segment_tree(R):
    """One row of 64 or 256 generators is cut into 2 or 8 segments whose
    sums meet in the halving tree: still the host's MSM."""
    assert rm.segments(1, R) == R // 32
    rng = random.Random(40 + R)
    pts = _points(R)
    ks = [rng.randrange(Q) for _ in range(R)]
    out = rm.row_msm_plain(limb.ints_to_limbs(ks)[None],
                           commitments.build_table(pts))
    assert dri.compress_to_bytes(ed.unstack(out)) == [
        jri.encode(jed.msm(ks, pts))]


def test_row_msm_checks_inputs():
    tab = commitments.build_table(_points(2))
    with pytest.raises(ValueError):
        rm.row_msm(torch.zeros((1, 3, 8), dtype=torch.int32), tab)
    with pytest.raises(ValueError):
        rm.row_msm(torch.zeros((1, 2, 8), dtype=torch.int64), tab)


def test_msm_and_vmsm():
    rng = random.Random(31)
    pts = _points(6)
    ks = [rng.randrange(Q) for _ in pts]
    want = jri.encode(jed.msm(ks, pts))
    got = dmsm.msm(limb.ints_to_limbs(ks), pts)
    assert dri.compress_to_bytes(got)[0] == want
    assert jri.encode(dmsm.vmsm(ks, pts, "cpu")) == want


def test_compress_matches_host_encode():
    pts = _points(5) + [jed.Point.identity()]
    blobs = dri.compress_to_bytes(ed.from_host(pts))
    assert blobs == [jri.encode(p) for p in pts]
