"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: they need an NVIDIA card with ``nvcc`` (the kernels are
built from ``spartan_tpu_torch/csrc`` at first use) and skip without
one.  This file imports nothing of JAX, so it also runs where JAX is not
installed; ``--noconftest`` then skips ``tests/conftest.py``, which
configures JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Everything is integer arithmetic: the kernel and the plain version agree
bit for bit (tolerance zero).  Shapes are those of ``chip_smoke.py``,
the elementwise Fq kernel's (``ff/fq.py::to_mont``) also into a slice of
a larger table, as the prover's z takes the witness,
K4 (``curve/ristretto.py``) also at 1-4,097 points with lazy coordinates,
K3 (``transcript/device.py``) also with 16 segments and at odd offsets,
and for K5 (``curve/point_msm.py``) also groups that are no power of
two; K5 and K6 (``ff/bullet_kernel.py``) run on two streams at once too.
The golden NIZK and SNARK run with the default bullet rounds, with
every round on the device (``bullet.DEVICE_MIN`` set to 1), and under a
mesh that lists the card 4 times (``parallel/mesh.py``: one B1 or B2
launch a shard).
"""

import pytest
import torch

from spartan_tpu_torch.commitments import MultiCommitGens
from spartan_tpu_torch.core.field import Q
from spartan_tpu_torch.curve import row_msm as rm
from spartan_tpu_torch.ff import limb
from spartan_tpu_torch.ff import round_kernel as rk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _elems(n, seed, device):
    """(n, 8) values below 2^252 (< q), with 0, 1 and q - 1 first."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randint(-(1 << 31), 1 << 31, (n, 8), generator=g,
                      dtype=torch.int64).to(torch.int32)
    w[:, 7] &= 0x0FFFFFFF
    k = min(n, 3)
    w[:k] = limb.ints_to_limbs([0, 1, Q - 1][:k])
    return w.to(device)


@pytest.mark.parametrize("L,R", [(4, 16), (3, 20), (2, 24), (1024, 1),
                                 (1024, 1024), (1, 4096), (8, 4096)])
def test_row_msm_kernel_vs_plain(dev, L, R):
    tab = MultiCommitGens(R, b"cuda_test").msm_table(dev)
    s = _elems(L * R, L + R, dev).reshape(L, R, 8)
    before = rm.row_msm.launches
    got = rm.row_msm(s, tab)
    torch.cuda.synchronize()
    assert rm.row_msm.launches == before + 1
    assert torch.equal(got, rm.row_msm_plain(s, tab))


@pytest.mark.parametrize("n", [1, 5, 513, 1 << 20])
def test_to_mont_kernel_vs_plain(dev, n):
    from spartan_tpu_torch.ff import fq

    a = _elems(n, 7 * n, dev)
    a[-1] = limb.ints_to_limbs([1 << 252], dev)[0]
    before = fq.to_mont.launches
    got = fq.to_mont(a)
    torch.cuda.synchronize()
    assert fq.to_mont.launches == before + 1
    assert torch.equal(got, fq.to_mont_plain(a))


def test_to_mont_kernel_into_a_view(dev):
    """The witness's map writes into z[:n]: here into rows k..k+n of a
    larger table, whose other rows stay as they were."""
    from spartan_tpu_torch.ff import fq

    n, k = 4096, 3
    a = _elems(n, 11, dev)
    z = _elems(2 * n + k, 12, dev)
    keep = z.clone()
    out = fq.to_mont(a, out=z[k:k + n])
    torch.cuda.synchronize()
    assert out.data_ptr() == z[k:k + n].data_ptr()
    assert torch.equal(z[k:k + n], fq.to_mont_plain(a))
    assert torch.equal(z[:k], keep[:k])
    assert torch.equal(z[k + n:], keep[k + n:])


def test_witness_z_on_the_card(dev):
    from spartan_tpu_torch.ff import fq
    from spartan_tpu_torch.poly import dense
    from spartan_tpu_torch.r1cs.proof import witness_z

    n, inputs = 1 << 10, list(range(5, 15))
    vars_ints = limb.limbs_to_ints(_elems(n, 13, "cpu"))
    before = fq.to_mont.launches
    z = witness_z(limb.ints_to_limbs(vars_ints, dev), inputs)
    torch.cuda.synchronize()
    assert fq.to_mont.launches == before + 1
    z_ints = vars_ints + [1] + inputs + [0] * (n - len(inputs) - 1)
    assert torch.equal(z, dense.from_ints(z_ints, dev))


@pytest.mark.parametrize("ntab,n", [(4, 8), (4, 64), (4, 4096), (4, 1 << 20),
                                    (2, 8), (2, 256), (2, 1 << 21)])
@pytest.mark.parametrize("mode", ["evals", "fold_evals", "fold"])
def test_fold_evals_kernel_vs_plain(dev, ntab, n, mode):
    tabs = [_elems(n, 10 * n + t, dev) for t in range(ntab)]
    r = None if mode == "evals" else 987654321
    got_t, got_e = rk.fold_evals(tabs, r, mode)
    want_t, want_e = rk.fold_evals_plain(tabs, r, mode)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got_t, want_t))
    if mode == "fold":
        assert got_e is None and want_e is None
    else:
        assert torch.equal(got_e, want_e)


@pytest.mark.parametrize("ntab", [4, 2])
def test_fold_evals_kernel_two_round_chain(dev, ntab):
    tabs = [_elems(4096, 7 + t, dev) for t in range(ntab)]
    got, want = tabs, tabs
    for mode, r in (("fold_evals", 11), ("fold_evals", Q - 1), ("fold", 5)):
        got, ge = rk.fold_evals(got, r, mode)
        want, we = rk.fold_evals_plain(want, r, mode)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        if mode != "fold":
            assert torch.equal(ge, we)


def test_fold_evals_kernel_on_two_streams(dev):
    """Launches in flight on two streams at once each find their own last
    block: every one still equals the plain version."""
    sets = [[_elems(1 << 18, 100 * k + t, dev) for t in range(4)]
            for k in range(2)]
    streams = [torch.cuda.Stream() for _ in sets]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[] for _ in sets]
    for _ in range(8):
        for k, (tabs, s) in enumerate(zip(sets, streams)):
            with torch.cuda.stream(s):
                got[k].append(rk.fold_evals(tabs, None, "evals")[1])
    torch.cuda.synchronize()
    for tabs, evals in zip(sets, got):
        want = rk.fold_evals_plain(tabs, None, "evals")[1]
        assert all(torch.equal(e, want) for e in evals)


@pytest.mark.parametrize("batch,n", [(2, 4), (6, 64), (18, 4096)])
@pytest.mark.parametrize("mode", ["evals", "fold_evals", "fold"])
def test_fold_evals_batched_kernel_vs_plain(dev, batch, n, mode):
    """The batched 3-table (cubic_prod) mode of the product layers."""
    tabs = [_elems(batch * n, 7 * n + t, dev).reshape(batch, n, 8)
            for t in range(3)]
    r = None if mode == "evals" else Q - 2
    got_t, got_e = rk.fold_evals(tabs, r, mode)
    want_t, want_e = rk.fold_evals_plain(tabs, r, mode)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got_t, want_t))
    if mode == "fold":
        assert got_e is None and want_e is None
    else:
        assert got_e.shape == (3, batch, 8)
        assert torch.equal(got_e, want_e)


def test_fold_evals_batched_kernel_on_two_streams(dev):
    sets = [[_elems(18 * 4096, 300 * k + t, dev).reshape(18, 4096, 8)
             for t in range(3)] for k in range(2)]
    streams = [torch.cuda.Stream() for _ in sets]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[] for _ in sets]
    for _ in range(8):
        for k, (tabs, s) in enumerate(zip(sets, streams)):
            with torch.cuda.stream(s):
                got[k].append(rk.fold_evals(tabs, 12345, "fold_evals")[1])
    torch.cuda.synchronize()
    for tabs, evals in zip(sets, got):
        want = rk.fold_evals_plain(tabs, 12345, "fold_evals")[1]
        assert all(torch.equal(e, want) for e in evals)


@pytest.mark.parametrize("rounds", ["default", "DEVICE_MIN=1"])
def test_golden_snark_on_the_card(dev, rounds, monkeypatch):
    import os

    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import SNARK, Instance, SNARKGens
    from spartan_tpu_torch.core.merlin import Transcript
    from spartan_tpu_torch.protocols import bullet

    if rounds != "default":  # every bullet round on the device
        monkeypatch.setitem(bullet.DEVICE_MIN, "cuda", 1)

    inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
        16, 16, 2, seed=424242, device=dev)
    gens = SNARKGens(16, 16, 2, 16)
    comm, decomm = SNARK.encode(inst, gens)
    snark = SNARK.prove(inst, comm, decomm, vars_a, inputs_a, gens,
                        Transcript(b"golden_snark"), _tape_seed=31337)
    golden = os.path.join(os.path.dirname(__file__), "golden")
    for name, blob in (("snark_commitment.bin",
                        ser.commitment_to_bytes(comm)),
                       ("snark_proof.bin", ser.snark_to_bytes(snark))):
        with open(os.path.join(golden, name), "rb") as f:
            assert blob == f.read(), name
    snark.verify(comm, inputs_a, Transcript(b"golden_snark"), gens)


@pytest.mark.parametrize("rounds", ["default", "DEVICE_MIN=1"])
def test_golden_nizk_on_the_card(dev, rounds, monkeypatch):
    import os

    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import NIZK, Instance, NIZKGens
    from spartan_tpu_torch.core.merlin import Transcript
    from spartan_tpu_torch.protocols import bullet

    if rounds != "default":  # every bullet round on the device
        monkeypatch.setitem(bullet.DEVICE_MIN, "cuda", 1)

    inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
        16, 16, 2, seed=424242, device=dev)
    nizk = NIZK.prove(inst, vars_a, inputs_a, NIZKGens(16, 16, 2),
                      Transcript(b"golden_nizk"), _tape_seed=31337)
    golden = os.path.join(os.path.dirname(__file__), "golden",
                          "nizk_proof.bin")
    with open(golden, "rb") as f:
        assert ser.nizk_to_bytes(nizk) == f.read()


@pytest.mark.parametrize("proof", ["nizk", "snark"])
def test_golden_under_a_mesh_on_the_card(dev, proof):
    import os

    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import (NIZK, SNARK, Instance, NIZKGens,
                                       SNARKGens)
    from spartan_tpu_torch.core.merlin import Transcript
    from spartan_tpu_torch.parallel import context as pctx
    from spartan_tpu_torch.parallel.mesh import Mesh

    inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
        16, 16, 2, seed=424242, device=dev)
    mesh = Mesh([dev] * 4)
    before = rk.fold_evals.launches.copy()
    with pctx.use_mesh(mesh):
        if proof == "nizk":
            blobs = {"nizk_proof.bin": ser.nizk_to_bytes(NIZK.prove(
                inst, vars_a, inputs_a, NIZKGens(16, 16, 2),
                Transcript(b"golden_nizk"), _tape_seed=31337))}
        else:
            gens = SNARKGens(16, 16, 2, 16)
            comm, decomm = SNARK.encode(inst, gens)
            snark = SNARK.prove(inst, comm, decomm, vars_a, inputs_a, gens,
                                Transcript(b"golden_snark"),
                                _tape_seed=31337)
            blobs = {"snark_commitment.bin": ser.commitment_to_bytes(comm),
                     "snark_proof.bin": ser.snark_to_bytes(snark)}
    golden = os.path.join(os.path.dirname(__file__), "golden")
    for name, blob in blobs.items():
        with open(os.path.join(golden, name), "rb") as f:
            assert blob == f.read(), name
    # phase one's first round: a launch a shard at 16 / 4 entries
    assert mesh.sharded_rounds["sumcheck", 4] > 0
    assert rk.fold_evals.launches["cubic", 1, 4, "evals"] \
        >= before["cubic", 1, 4, "evals"] + 4
    assert mesh.msm_blocks

def test_strobe_step_kernel_vs_plain(dev):
    """K3 on 64 random states with and without a mask, with segments,
    permuting or not, against the plain version (in place on copies)."""
    from spartan_tpu_torch.transcript import device as dt

    g = torch.Generator().manual_seed(21)
    for k in range(64):
        st = torch.randint(0, 256, (200,), generator=g,
                           dtype=torch.int64).to(torch.uint8)
        mask = (bytes(torch.randint(0, 256, (200,), generator=g).tolist())
                if k % 3 else None)
        segs = [(torch.randint(0, 256, (n,), generator=g,
                               dtype=torch.int64).to(torch.uint8), off)
                for n, off in ((32, 5), (64, 40), (1, 199))]
        want = st.clone()
        dt.strobe_step_plain(want, mask, segs, k % 2 == 0)
        got = st.to(dev)
        before = dt.strobe_step.launches
        dt.strobe_step(got, mask, [(s.to(dev), o) for s, o in segs],
                       k % 2 == 0)
        torch.cuda.synchronize()
        assert dt.strobe_step.launches == before + 1
        assert torch.equal(got.cpu(), want)


def test_compress_kernel_vs_plain(dev):
    """K4 against the plain version on random points, the identity and
    lazy coordinates."""
    from spartan_tpu_torch.core import edwards as hed
    from spartan_tpu_torch.curve import edwards as ed
    from spartan_tpu_torch.curve import ristretto as dri

    pts = [hed.Point.identity()] + [hed.BASEPOINT.mul(7 ** k + 1)
                                    for k in range(1, 130)]
    p = ed.from_host(pts, dev)
    before = dri.compress.launches
    got = dri.compress(p)
    torch.cuda.synchronize()
    assert dri.compress.launches == before + 1
    assert torch.equal(got, dri.compress_plain(p))


def _encode_points(n, dev, lazy):
    """(n, 4, 8) int32 points on ``dev``: the identity, then k * 12345 B
    for k = 1 ... n - 1 in projective form (Z != 1); with ``lazy`` every
    coordinate below 2^256 - p has p added."""
    from spartan_tpu_torch.core import edwards as hed
    from spartan_tpu_torch.core.field import P25519 as P
    from spartan_tpu_torch.curve import edwards as ed

    step = hed.BASEPOINT.mul(12345)
    pts, acc = [hed.Point.identity()], step
    while len(pts) < n:
        pts.append(acc)
        acc = acc.add(step)
    t = ed.stack(ed.from_host(pts))
    if lazy:
        vals = [v + P if v + P < 1 << 256 else v
                for v in limb.limbs_to_ints(t.reshape(-1, 8))]
        t = limb.ints_to_limbs(vals).reshape(t.shape)
    return t.to(dev)


@pytest.mark.parametrize("lazy", [False, True], ids=["canonical", "lazy"])
@pytest.mark.parametrize("n", [1, 2, 3, 31, 33, 129, 4097])
def test_compress_kernel_sizes(dev, n, lazy):
    """K4 (8 lanes a point, 16 points a block) on partial groups and
    blocks, the identity first: equal to the plain version, one launch."""
    from spartan_tpu_torch.curve import edwards as ed
    from spartan_tpu_torch.curve import ristretto as dri

    p = ed.unstack(_encode_points(n, dev, lazy))
    before = dri.compress.launches
    got = dri.compress(p)
    torch.cuda.synchronize()
    assert dri.compress.launches == before + 1
    assert torch.equal(got, dri.compress_plain(p))


# (offset, length) of each device segment: 16 adjacent ones (the most a
# step takes) ending at byte 199; segments at odd offsets, adjacent and
# apart, the last ending at byte 199; none
STROBE_SEGS = {
    "sixteen": [(64 + sum(range(1, n)), n) for n in range(1, 17)],
    "odd": [(1, 6), (7, 24), (31, 2), (35, 100), (135, 65)],
    "adjacent": [(0, 100), (100, 100)],
    "none": [],
}


@pytest.mark.parametrize("form", ["mask+permute", "mask only",
                                  "permute only"])
@pytest.mark.parametrize("segs", list(STROBE_SEGS))
def test_strobe_step_kernel_segments(dev, segs, form):
    """K3 (one Keccak lane a warp lane) with each segment set of
    STROBE_SEGS, with a mask and the permutation, with a mask only and
    with the permutation only: equal to the plain version on 8 random
    states."""
    from spartan_tpu_torch.transcript import device as dt

    g = torch.Generator().manual_seed(len(STROBE_SEGS[segs]) + len(form))
    mask = None if form == "permute only" else bytes(
        torch.randint(0, 256, (200,), generator=g).tolist())
    permute = form != "mask only"
    data = [(torch.randint(0, 256, (n,), generator=g,
                           dtype=torch.int64).to(torch.uint8), off)
            for off, n in STROBE_SEGS[segs]]
    for _ in range(8):
        st = torch.randint(0, 256, (200,), generator=g,
                           dtype=torch.int64).to(torch.uint8)
        want = st.clone()
        dt.strobe_step_plain(want, mask, data, permute)
        got = st.to(dev)
        dt.strobe_step(got, mask, [(d.to(dev), o) for d, o in data],
                       permute)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("ntab,shape", [(4, (4096,)), (2, (4096,)),
                                        (3, (6, 64))])
@pytest.mark.parametrize("mode", ["fold_evals", "fold"])
def test_fold_evals_kernel_device_r(dev, ntab, shape, mode):
    """B2 with the challenge read through a pointer equals the by-value
    form and the plain version."""
    from spartan_tpu_torch.ff import fq

    n = 1
    for d in shape:
        n *= d
    tabs = [_elems(n, 30 + t, dev).reshape(*shape, 8) for t in range(ntab)]
    r = (3 ** 99) % Q
    got = rk.fold_evals(tabs, fq.mont_limbs(r, dev), mode)
    want = rk.fold_evals(tabs, r, mode)
    plain = rk.fold_evals_plain(tabs, r, mode)
    torch.cuda.synchronize()
    for a, b, c in zip(got[0], want[0], plain[0]):
        assert torch.equal(a, b) and torch.equal(a, c)
    if mode != "fold":
        assert torch.equal(got[1], want[1]) and torch.equal(got[1], plain[1])


@pytest.mark.parametrize("gate", ["SPARTAN_TPU_DEVICE_PROVER",
                                  "SPARTAN_TPU_DEVICE_NONZK"])
def test_golden_snark_device_prover_on_the_card(dev, gate, monkeypatch):
    import os

    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import SNARK, Instance, SNARKGens
    from spartan_tpu_torch.core.merlin import Transcript

    monkeypatch.setenv(gate, "1")
    inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
        16, 16, 2, seed=424242, device=dev)
    gens = SNARKGens(16, 16, 2, 16)
    comm, decomm = SNARK.encode(inst, gens)
    snark = SNARK.prove(inst, comm, decomm, vars_a, inputs_a, gens,
                        Transcript(b"golden_snark"), _tape_seed=31337)
    golden = os.path.join(os.path.dirname(__file__), "golden",
                          "snark_proof.bin")
    with open(golden, "rb") as f:
        assert ser.snark_to_bytes(snark) == f.read()
    snark.verify(comm, inputs_a, Transcript(b"golden_snark"), gens)


def test_golden_nizk_device_prover_on_the_card(dev, monkeypatch):
    import os

    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import NIZK, Instance, NIZKGens
    from spartan_tpu_torch.core.merlin import Transcript

    monkeypatch.setenv("SPARTAN_TPU_DEVICE_PROVER", "1")
    inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
        16, 16, 2, seed=424242, device=dev)
    nizk = NIZK.prove(inst, vars_a, inputs_a, NIZKGens(16, 16, 2),
                      Transcript(b"golden_nizk"), _tape_seed=31337)
    golden = os.path.join(os.path.dirname(__file__), "golden",
                          "nizk_proof.bin")
    with open(golden, "rb") as f:
        assert ser.nizk_to_bytes(nizk) == f.read()


def _points(n, seed, device):
    """(n, 4, 8) points s * B for random s, the identity first."""
    from spartan_tpu_torch.core import edwards as hed
    from spartan_tpu_torch.curve import edwards as ed

    g = torch.Generator().manual_seed(seed)
    pts = [hed.Point.identity()] + [
        hed.BASEPOINT.mul(int(k)) for k in
        torch.randint(1, 1 << 62, (n - 1,), generator=g).tolist()]
    return ed.stack(ed.from_host(pts[:n], device))


@pytest.mark.parametrize("sizes", [(3, 1, 0, 5), (7, 7, 7, 7, 7), (70, 5, 129),
                                   (1026,), (2050, 2050), (2,) * 1024,
                                   (5, 6), (1,), (300,)],
                         ids=["mixed", "zk_round", "odd", "cross_2048",
                              "cross_4096", "fold_2x1024", "n_not_mult_4",
                              "one_point", "group_of_many_quads"])
def test_point_msm_kernel_vs_plain(dev, sizes):
    from spartan_tpu_torch.curve import point_msm as pm

    offs = [0]
    for k in sizes:
        offs.append(offs[-1] + k)
    pts = _points(offs[-1], len(sizes), dev)
    s = _elems(offs[-1], offs[-1], dev)
    before = pm.point_msm.launches
    got = pm.point_msm(pts, s, offs)
    torch.cuda.synchronize()
    assert pm.point_msm.launches == before + 1
    assert torch.equal(got, pm.point_msm_plain(pts, s, offs))


def test_point_msm_kernel_edge_scalars(dev):
    """Scalars whose signed radix-16 digits below the top are all -8, all
    +7 or mixed at the extremes, 0, 1, q - 1 and 2^252, on random points
    and the identity, one group each and one group of all: equal to the
    plain version and to the host's s * P."""
    from spartan_tpu_torch.core import edwards as hed
    from spartan_tpu_torch.core.field import P25519 as P
    from spartan_tpu_torch.curve import edwards as ed
    from spartan_tpu_torch.curve import point_msm as pm

    m8 = (7 * 16 ** 63 + 8) // 15  # digits 0 ... 62 all -8, 63 is 1
    p7 = 7 * (16 ** 63 - 1) // 15  # digits 0 ... 62 all 7
    ks = [m8, p7, 0, 1, Q - 1, 1 << 252, m8 + 15 * 16 ** 30, 8]
    pts = _points(len(ks), 11, dev)
    s = limb.ints_to_limbs(ks, dev)
    for offs in (list(range(len(ks) + 1)), [0, len(ks)]):
        got = pm.point_msm(pts, s, offs)
        torch.cuda.synchronize()
        assert torch.equal(got, pm.point_msm_plain(pts, s, offs))
    cols = [limb.limbs_to_ints(got[:, c]) for c in range(4)]
    want = hed.Point.identity()
    for pt, k in zip(ed.to_host(ed.unstack(pts)), ks):
        want = want.add(pt.mul(k))
    X, Y, Z = cols[0][0], cols[1][0], cols[2][0]
    assert (X * want.Z - want.X * Z) % P == 0
    assert (Y * want.Z - want.Y * Z) % P == 0


def test_point_msm_kernel_on_two_streams(dev):
    """Launches in flight on two streams at once each use their own
    scratch: every one equals the plain version."""
    from spartan_tpu_torch.curve import point_msm as pm

    offs = [0, 2, 4, 7, 64, 130]
    sets = [(_points(130, 7 + k, dev), _elems(130, 9 + k, dev))
            for k in range(2)]
    streams = [torch.cuda.Stream() for _ in sets]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = [[] for _ in sets]
    for _ in range(4):
        for k, ((pts, s), st) in enumerate(zip(sets, streams)):
            with torch.cuda.stream(st):
                got[k].append(pm.point_msm(pts, s, offs))
    torch.cuda.synchronize()
    for (pts, s), outs in zip(sets, got):
        want = pm.point_msm_plain(pts, s, offs)
        assert all(torch.equal(o, want) for o in outs)


@pytest.mark.parametrize("mode,n", [
    (mode, n) for mode in ("cross", "fold", "fold_bytes")
    for n in (2, 6, 1024, 2048, 4096)] + [("head", 2), ("tail", 2)])
def test_bullet_step_kernel_vs_plain(dev, mode, n):
    from spartan_tpu_torch.ff.bullet_kernel import (bullet_step,
                                                    bullet_step_plain)
    a, b = _elems(n, n, dev), _elems(n, n + 1, dev)
    blinds = _elems(2, 5, dev)
    chal = torch.randint(0, 256, (64,), generator=torch.Generator()
                         .manual_seed(n), dtype=torch.int64).to(
                             torch.uint8).to(dev)
    before = sum(bullet_step.launches.values())
    if mode == "cross":
        got = [bullet_step("cross", a, b, blinds)]
        want = [bullet_step_plain("cross", a, b, blinds)]
    elif mode.startswith("fold"):
        u = chal if mode == "fold_bytes" else _elems(4, 77, dev)[3]
        bf_k, bf_p = _elems(3, 6, dev)[2].clone(), _elems(3, 6, dev)[2].clone()
        got = [*bullet_step("fold", a, b, u, blinds, bf_k), bf_k]
        want = [*bullet_step_plain("fold", a, b, u, blinds, bf_p), bf_p]
    elif mode == "head":
        got = [bullet_step("head", chal, a[0], a[1])]
        want = [bullet_step_plain("head", chal, a[0], a[1])]
    else:
        drr = _elems(3, 8, dev)
        got = [bullet_step("tail", chal, a[0], a[1], b[0], drr)]
        want = [bullet_step_plain("tail", chal, a[0], a[1], b[0], drr)]
    torch.cuda.synchronize()
    assert sum(bullet_step.launches.values()) == before + 1
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("form", ["words", "bytes"])
@pytest.mark.parametrize("u", [1, Q - 1, 1 << 200], ids=["one", "q_minus_1",
                                                         "pow2"])
def test_bullet_step_fold_edge_u(dev, u, form):
    """The fold's safegcd inverse at u = 1, q - 1 and a power of two,
    read as 8 Montgomery words and as 64 squeezed bytes (whose value mod
    q is u): equal to the plain version."""
    from spartan_tpu_torch.ff import fq
    from spartan_tpu_torch.ff.bullet_kernel import (bullet_step,
                                                    bullet_step_plain)

    a, b = _elems(2048, 60, dev), _elems(2048, 61, dev)
    x = _elems(4, 62, dev)
    if form == "words":
        uu = fq.encode_ints([u], dev)[0]
    else:
        uu = torch.tensor(list(u.to_bytes(64, "little")), dtype=torch.uint8,
                          device=dev)
    bk, bp = x[3].clone(), x[3].clone()
    got = [*bullet_step("fold", a, b, uu, x[:2], bk), bk]
    want = [*bullet_step_plain("fold", a, b, uu, x[:2], bp), bp]
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_bullet_step_kernel_on_two_streams(dev):
    """Folds in flight on two streams at once, each updating its own
    blind_fin: each equals the plain version."""
    from spartan_tpu_torch.ff.bullet_kernel import (bullet_step,
                                                    bullet_step_plain)

    sets = [(_elems(2048, 30 + k, dev), _elems(2048, 40 + k, dev),
             _elems(4, 50 + k, dev)) for k in range(2)]
    streams = [torch.cuda.Stream() for _ in sets]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = []
    for (a, b, x), st in zip(sets, streams):
        with torch.cuda.stream(st):
            bf = x[3].clone()
            got.append((*bullet_step("fold", a, b, x[2], x[:2], bf), bf))
    torch.cuda.synchronize()
    for (a, b, x), outs in zip(sets, got):
        bf = x[3].clone()
        want = (*bullet_step_plain("fold", a, b, x[2], x[:2], bf), bf)
        assert all(torch.equal(o, w) for o, w in zip(outs, want))


@pytest.mark.parametrize("wide", [0, 1], ids=["32-bit", "64-bit"])
def test_divstep_chain_kernel(dev, wide):
    """The divstep chain that measures the fold's bound: three batches
    on the card equal the same batches on python ints (a batch's matrix
    depends on the low word of f and g only)."""
    from spartan_tpu_torch import _build
    from spartan_tpu_torch.ff import bullet_kernel as bk

    bits, steps, scale = (64, 59, 8) if wide else (32, 30, 1)
    mask = (1 << bits) - 1
    f, g, zeta = 0x1812631a5cf5d3ed & mask, 0x0123456789abcdef & mask, -1
    fgz = torch.tensor([f, g, zeta], dtype=torch.int64, device=dev)
    lib = _build.load("bullet_step", bk._declare)
    rc = lib.divstep_chain_launch(fgz.data_ptr(), 3, wide,
                                  _build.stream_handle(dev))
    _build.check(rc, "divstep_chain")
    for _ in range(3):
        u, v, q, r = scale, 0, 0, scale
        ff, gg = f, g
        for _ in range(steps):
            if zeta < 0 and gg & 1:
                zeta, ff, gg = -zeta - 2, gg, (gg - ff) >> 1
                u, v, q, r = 2 * q, 2 * r, q - u, r - v
            else:
                if gg & 1:
                    gg, q, r = (gg + ff) >> 1, q + u, r + v
                else:
                    gg >>= 1
                zeta, u, v = zeta - 1, 2 * u, 2 * v
        f, g = (f ^ ((u ^ v) & mask)) | 1, g ^ ((q ^ r) & mask)
    want = [(x + (1 << 63)) % (1 << 64) - (1 << 63) for x in (f, g, zeta)]
    assert fgz.tolist() == want
