"""The port's two-tier (DCN × ICI) collectives
(``spartan_tpu_torch/parallel/dcn.py``) against python-int and host-point
oracles.

* Eight CPU devices shaped (hosts = 2, ici = 4), as the JAX package's
  ``tests/test_dcn.py`` shapes its eight virtual devices:
  ``all_reduce_field`` (on (2, 4) and (4, 2)), ``sum_mod_q_two_tier`` and
  ``msm_two_tier`` (kernel K5's plain version on each block).
* Two processes joined by ``torch.distributed`` (gloo, a ``file://``
  rendezvous), each holding one host's row of two CPU devices: the dcn
  step gathers one element or point a host, and both ranks get the
  oracle's answer.  Each process has a hard 60 s limit, so the test
  fails rather than hangs.
* ``init_multihost`` does nothing when nothing announces a multi-process
  run.
"""

import hashlib
import json
import os
import subprocess
import sys

import jax  # noqa: F401  (imported first in every port test file)
import numpy as np
import pytest

from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu_torch.core import edwards as hed
from spartan_tpu_torch.core import ristretto as hri
from spartan_tpu_torch.core.field import Q
from spartan_tpu_torch.curve import edwards as ed
from spartan_tpu_torch.ff import fq, limb
from spartan_tpu_torch.parallel import dcn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ints(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(n)]


def _points(n):
    return [hri.from_uniform_bytes(hashlib.sha512(b"dcn%d" % i).digest())
            for i in range(n)]


@pytest.fixture(scope="module")
def mesh2d():
    return dcn.make_mesh2d(n_hosts=2, chips_per_host=4, devices=["cpu"] * 8)


def test_mesh2d_axes(mesh2d):
    assert mesh2d.shape == {dcn.DCN_AXIS: 2, dcn.ICI_AXIS: 4}
    assert len(mesh2d.rows) == 2 and not mesh2d.distributed
    assert len(mesh2d.devices) == 8 and mesh2d.first_block == 0


def test_make_mesh2d_rejects_too_few_devices():
    with pytest.raises(ValueError):
        dcn.make_mesh2d(n_hosts=2, chips_per_host=4, devices=["cpu"] * 6)


@pytest.mark.parametrize("grid", [(2, 4), (4, 2)])
def test_all_reduce_field(grid):
    mesh2d = dcn.make_mesh2d(*grid, devices=["cpu"] * 8)
    xs = _ints(5, 8 * 3)
    partials = [fq.encode_ints(xs[3 * k:3 * k + 3]) for k in range(8)]
    got = dcn.all_reduce_field(partials, mesh2d)
    want = [sum(xs[3 * k + i] for k in range(8)) % Q for i in range(3)]
    assert fq.decode_to_ints(got) == want


def test_sum_mod_q_two_tier(mesh2d):
    xs = _ints(6, 64)
    got = dcn.sum_mod_q_two_tier(mesh2d)(fq.encode_ints(xs))
    assert got.shape == (8,)
    assert fq.decode_to_ints(got) == [sum(xs) % Q]


def test_msm_two_tier_vs_host(mesh2d):
    npts = 16
    pts = _points(npts)
    rng = np.random.default_rng(7)
    ks = [int(x) for x in rng.integers(1, 1 << 61, size=npts)]
    out = dcn.msm_two_tier(mesh2d)(limb.ints_to_limbs(ks),
                                   ed.stack(ed.from_host(pts)))
    got = ed.to_host(ed.unstack(out))[0]
    assert hri.encode(got) == hri.encode(hed.msm(ks, pts))
    assert dict(mesh2d.msm_blocks) == {("point_msm", 2): 8}


def test_init_multihost_does_nothing_alone(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert dcn.init_multihost() is False
    import torch.distributed as dist

    assert not dist.is_initialized()


_RANK = r"""
import json, sys
import torch.distributed as dist
from spartan_tpu_torch.curve import edwards as ed
from spartan_tpu_torch.ff import fq, limb
from spartan_tpu_torch.parallel import dcn

rank, init, xs, ks, pts = json.loads(sys.argv[1])
assert dcn.init_multihost(init_method=init, world_size=2, rank=rank,
                          backend="gloo")
mesh2d = dcn.make_mesh2d(devices=["cpu"] * 2)
partials = [fq.encode_ints([x]) for x in xs[2 * rank:2 * rank + 2]]
field = fq.decode_to_ints(dcn.all_reduce_field(partials, mesh2d))
table = fq.decode_to_ints(dcn.sum_mod_q_two_tier(mesh2d)(fq.encode_ints(xs)))
pts_t = limb.ints_to_limbs(pts).reshape(len(ks), 4, 8)
point = dcn.msm_two_tier(mesh2d)(limb.ints_to_limbs(ks), pts_t)
print(json.dumps({"shape": mesh2d.shape, "field": field, "table": table,
                  "point": limb.limbs_to_ints(point.reshape(4, 8))}))
dist.destroy_process_group()
"""


def test_two_ranks_over_gloo(tmp_path):
    xs = _ints(8, 4)
    pts = _points(8)
    ks = [int(x) for x in np.random.default_rng(9).integers(1, 1 << 61, 8)]
    flat = [c for p in pts for c in (p.X, p.Y, p.Z, p.T)]
    init = f"file://{tmp_path}/rendezvous"
    env = dict(os.environ, PYTHONPATH=ROOT, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, json.dumps([r, init, xs, ks, flat])],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    want_pt = hri.encode(hed.msm(ks, pts))
    for out in outs:
        assert out["shape"] == {"dcn": 2, "ici": 2}
        assert out["field"] == [sum(xs) % Q]
        assert out["table"] == [sum(xs) % Q]
        got = hed.Point(*out["point"])
        assert hri.encode(got) == want_pt
