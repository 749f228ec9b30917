"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: they need an NVIDIA card with ``nvcc`` (the kernels are
built from ``spartan_tpu_torch/csrc`` at first use) and skip without
one.  This file imports nothing of JAX, so it also runs where JAX is not
installed; ``--noconftest`` then skips ``tests/conftest.py``, which
configures JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Everything is integer arithmetic: the kernel and the plain version agree
bit for bit (tolerance zero).  Shapes are those of ``chip_smoke.py``.
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


def test_golden_snark_on_the_card(dev):
    import os

    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import SNARK, Instance, SNARKGens
    from spartan_tpu_torch.core.merlin import Transcript

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


def test_golden_nizk_on_the_card(dev):
    import os

    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import NIZK, Instance, NIZKGens
    from spartan_tpu_torch.core.merlin import Transcript

    inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
        16, 16, 2, seed=424242, device=dev)
    nizk = NIZK.prove(inst, vars_a, inputs_a, NIZKGens(16, 16, 2),
                      Transcript(b"golden_nizk"), _tape_seed=31337)
    golden = os.path.join(os.path.dirname(__file__), "golden",
                          "nizk_proof.bin")
    with open(golden, "rb") as f:
        assert ser.nizk_to_bytes(nizk) == f.read()


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
