"""The port's device-resident prover (``spartan_tpu_torch/protocols/
device_prover.py``) on the CPU, through the kernels' plain versions.

* A ZK sum-check phase on the device (quad and cubic, n = 2^4) equals
  ``ZKSumcheckInstanceProof._prove_rounds``: the same proof, challenges,
  final claims and last blind, the host transcript and the tape left in
  the same state.
* The device product layers, with and without dot-product circuits,
  equal ``ProductCircuitEvalProofBatched.prove`` on the host.
* The round-polynomial helpers equal ``poly.unipoly.UniPoly``.
* A device ZK phase commits its rows (tape secrets) with kernel K5,
  never with B1.
* The slice as a whole, against the JAX package: with
  ``SPARTAN_TPU_DEVICE_PROVER=1`` (its dot-product-log proofs on the
  device too) the port reproduces ``tests/golden/nizk_proof.bin`` and
  ``snark_proof.bin`` (the JAX package's bytes, ``tests/test_golden.py``)
  byte for byte and both verify; so does the SNARK with
  ``SPARTAN_TPU_DEVICE_NONZK=1``, and both with every bullet round on
  the device (``bullet.DEVICE_MIN`` of the CPU set to 1, no gate).  No
  JAX code runs here.

The golden proofs under ``SPARTAN_TPU_DEVICE_PROVER`` run the opt-in device
prover alone and take over 20 s on the CPU: they are ``slow``.
"""

import os
import random

import jax  # noqa: F401
import pytest
import torch

from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu_torch import serialize as ser
from spartan_tpu_torch.api import (NIZK, SNARK, Instance, NIZKGens,
                                   SNARKGens)
from spartan_tpu_torch.commitments import MultiCommitGens
from spartan_tpu_torch.core.field import Q
from spartan_tpu_torch.core.merlin import RandomTape, Transcript
from spartan_tpu_torch.curve import row_msm as rm
from spartan_tpu_torch.ff import fq, limb
from spartan_tpu_torch.poly.unipoly import UniPoly
from spartan_tpu_torch.protocols import bullet
from spartan_tpu_torch.protocols import device_prover as dp
from spartan_tpu_torch.protocols.product_tree import (
    DotProductCircuitBatch, ProductCircuitBatch,
    ProductCircuitEvalProofBatched)
from spartan_tpu_torch.protocols.sumcheck import ZKSumcheckInstanceProof
from spartan_tpu_torch.transcript.device import DeviceTranscript

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SHAPE = (16, 16, 2)
GATES = ("SPARTAN_TPU_DEVICE_PROVER", "SPARTAN_TPU_DEVICE_NONZK")
# every bullet round on the device, no gate
DEVICE_ROUNDS = "DEVICE_MIN=1"


def _golden(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


@pytest.fixture
def no_gates(monkeypatch):
    for g in GATES:
        monkeypatch.delenv(g, raising=False)
    return monkeypatch


@pytest.mark.parametrize("which", ["quad", "cubic"])
def test_zk_phase_on_device_equals_host(which, no_gates):
    rng = random.Random(5)
    ntab, deg = (2, 2) if which == "quad" else (4, 3)
    n = 16
    vals = [[rng.randrange(Q) for _ in range(n)] for _ in range(ntab)]
    if which == "quad":
        claim = sum(a * b for a, b in zip(*vals)) % Q
    else:
        claim = sum(a * (b * c - d) for a, b, c, d in zip(*vals)) % Q
    tables = [fq.encode_ints(v) for v in vals]
    gens_1 = MultiCommitGens(1, b"gens_1")
    gens_n = MultiCommitGens(deg + 1, b"gens_n")
    runs = []
    for prove in (ZKSumcheckInstanceProof._prove_rounds,
                  dp.zk_sumcheck_phase_device):
        t, tape = Transcript(b"zk"), RandomTape(b"tape", seed=9)
        out = prove(claim, 4321, 4, tables, which, gens_1, gens_n, t, tape)
        runs.append((out, DeviceTranscript.host_state(t),
                     tape.random_scalar(b"next")))
    host, dev = runs
    assert dev[0][0] == host[0][0]  # the proof
    assert dev[0][1:] == host[0][1:]  # r, final claims, last blind
    assert dev[1:] == host[1:]  # transcript state, tape


def test_zk_phase_commits_with_k5_not_b1(no_gates):
    def b1(*a, **k):
        raise AssertionError("B1 launched in a device ZK phase")

    no_gates.setattr(rm, "row_msm", b1)
    no_gates.setattr(rm, "row_msm_plain", b1)
    calls = []

    def k5(points, scalars, offsets):
        calls.append(tuple(offsets))
        return point_msm(points, scalars, offsets)

    point_msm = dp.point_msm
    no_gates.setattr(dp, "point_msm", k5)
    rng = random.Random(2)
    tables = [fq.encode_ints([rng.randrange(Q) for _ in range(4)])
              for _ in range(2)]
    claim = sum(a * b for a, b in zip(*(fq.decode_to_ints(t)
                                        for t in tables))) % Q
    dp.zk_sumcheck_phase_device(
        claim, 5, 2, tables, "quad", MultiCommitGens(1, b"g1"),
        MultiCommitGens(3, b"gn"), Transcript(b"zk"),
        RandomTape(b"tape", seed=3))
    # per round: comm_poly with delta, then comm_eval (with the next
    # round's two), then Cy with beta; groups of the 6 bases
    assert calls == [(0, 6, 12), (0, 6, 12, 18), (0, 6, 12), (0, 6),
                     (0, 6, 12)]


@pytest.mark.parametrize("with_dotp", [False, True])
def test_product_layers_on_device_equal_host(with_dotp, no_gates):
    rng = random.Random(11)
    B, n = 2, 16

    def table(b, m):
        return fq.encode_ints([rng.randrange(1, Q) for _ in range(b * m)]
                              ).reshape(b, m, 8)

    prod = ProductCircuitBatch(table(B, n))
    dotp = (DotProductCircuitBatch(*(table(2, n // 2) for _ in range(3)))
            if with_dotp else None)
    runs = []
    for prove in (ProductCircuitEvalProofBatched.prove,
                  dp.prove_product_layers_device):
        t = Transcript(b"pc")
        t.append_message(b"before", b"x" * 50)
        proof, rand = prove(prod, dotp, t)
        runs.append((proof, rand, DeviceTranscript.host_state(t)))
    assert runs[1] == runs[0]


def test_unipoly_helpers_equal_host():
    rng = random.Random(1)
    claim, r = rng.randrange(Q), rng.randrange(Q)
    for k in (2, 3):
        es = [rng.randrange(Q) for _ in range(k)]
        want = UniPoly.from_evals([es[0], (claim - es[0]) % Q] + es[1:])
        got = dp.unipoly_from_evals(
            list(limb.unpack(fq.encode_ints(es))), limb.unpack(
                fq.mont_limbs(claim)))
        assert fq.decode_to_ints(limb.pack(got)) == want.coeffs
        ev = dp.unipoly_evaluate(got, limb.unpack(fq.mont_limbs(r)))
        assert fq.decode_to_ints(limb.pack(ev)[None]) == [want.evaluate(r)]
        th, td = Transcript(b"u"), DeviceTranscript(b"u", device="cpu")
        want.append_to_transcript(b"poly", th)
        dp.unipoly_append(td, b"poly", got)
        assert DeviceTranscript.host_state(th)[0] == \
            td.state_words().numpy().tobytes()
    rs = [rng.randrange(Q) for _ in range(3)]
    from spartan_tpu_torch.poly import dense

    got = dp._eq_table_dev([fq.mont_limbs(x) for x in rs], "cpu")
    assert torch.equal(got, dense.eq_evals(rs, "cpu"))


@pytest.fixture(scope="module")
def golden_inst():
    return Instance.produce_synthetic_r1cs(*SHAPE, seed=424242,
                                           device="cpu")


@pytest.fixture(scope="module")
def golden_snark_setup(golden_inst):
    """Gens and the computation commitment (encode runs no sum-check, so
    the gates do not touch it)."""
    inst = golden_inst[0]
    nnz = max(m.get_num_nz_entries()
              for m in (inst.inst.A, inst.inst.B, inst.inst.C))
    gens = SNARKGens(*SHAPE, nnz)
    return gens, *SNARK.encode(inst, gens)


def _set_path(monkeypatch, path: str) -> None:
    if path == DEVICE_ROUNDS:
        monkeypatch.setitem(bullet.DEVICE_MIN, "cpu", 1)
    else:
        monkeypatch.setenv(path, "1")


# the gate's case runs the opt-in device prover alone, over 20 s cold: slow
@pytest.mark.parametrize(
    "path", [pytest.param(GATES[0], marks=pytest.mark.slow), DEVICE_ROUNDS])
def test_golden_nizk_with_device_prover(path, golden_inst, no_gates):
    _set_path(no_gates, path)
    inst, vars_a, inputs_a = golden_inst
    gens = NIZKGens(*SHAPE)
    nizk = NIZK.prove(inst, vars_a, inputs_a, gens,
                      Transcript(b"golden_nizk"), _tape_seed=31337)
    assert ser.nizk_to_bytes(nizk) == _golden("nizk_proof.bin")
    nizk.verify(inst, inputs_a, Transcript(b"golden_nizk"), gens)


@pytest.mark.parametrize(
    "gate", [pytest.param(GATES[0], marks=pytest.mark.slow), GATES[1],
             DEVICE_ROUNDS])
def test_golden_snark_with_device_prover(gate, golden_inst,
                                         golden_snark_setup, no_gates):
    _set_path(no_gates, gate)
    inst, vars_a, inputs_a = golden_inst
    gens, comm, decomm = golden_snark_setup
    snark = SNARK.prove(inst, comm, decomm, vars_a, inputs_a, gens,
                        Transcript(b"golden_snark"), _tape_seed=31337)
    assert ser.snark_to_bytes(snark) == _golden("snark_proof.bin")
    snark.verify(comm, inputs_a, Transcript(b"golden_snark"), gens,
                 device="cpu")
