"""The port's NIZK (``spartan_tpu_torch.api``) on the CPU against the JAX
package's frozen wire bytes and its verifier.

* At the golden shape (16, 16, 2), seed 424242, tape seed 31337 and
  ``Transcript(b"golden_nizk")`` (``tests/test_golden.py``), the port's
  digest and proof equal ``tests/golden/`` byte for byte.
* The JAX package's reader accepts the port's proof, and its
  ``NIZK.verify`` accepted the same bytes (recorded with its
  transcript's next challenge in ``tests/golden/port/nizk-jax-verify.npz``:
  the verify compiles XLA); the port's verifier leaves its transcript
  where the JAX package's left it.
* The port verifies the golden proof and rejects tampered copies, and
  its writer and reader round-trip.
"""

import os

import jax  # noqa: F401
import pytest
import torch

from golden.port.record import load, to_ints
from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu import serialize as jser
from spartan_tpu_torch import serialize as ser
from spartan_tpu_torch.api import NIZK, Assignment, Instance, NIZKGens
from spartan_tpu_torch.core.field import Q
from spartan_tpu_torch.core.merlin import Transcript
from spartan_tpu_torch.utils.errors import (ProofDeserializeError,
                                            ProofVerifyError, R1CSError)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SHAPE = (16, 16, 2)


def _golden(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def port():
    inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
        *SHAPE, seed=424242, device="cpu")
    gens = NIZKGens(*SHAPE)
    nizk = NIZK.prove(inst, vars_a, inputs_a, gens,
                      Transcript(b"golden_nizk"), _tape_seed=31337)
    return inst, inputs_a, gens, ser.nizk_to_bytes(nizk)


def test_golden_digest(port):
    assert port[0].digest == _golden("instance_digest.bin")


def test_golden_nizk_bytes(port):
    assert port[3] == _golden("nizk_proof.bin")


def test_jax_package_verifies_port_proof(port):
    inst, inputs_a, gens, blob = port
    jax_verify = load("nizk-jax-verify")
    jser.nizk_from_bytes(blob)
    assert blob == jax_verify["proof"].tobytes()
    t = Transcript(b"golden_nizk")
    ser.nizk_from_bytes(blob).verify(inst, inputs_a, t, gens)
    assert t.challenge_scalar(b"post") == to_ints(jax_verify["post"])


def test_port_verifies_golden_proof(port):
    inst, inputs_a, gens, _ = port
    nizk = ser.nizk_from_bytes(_golden("nizk_proof.bin"))
    nizk.verify(inst, inputs_a, Transcript(b"golden_nizk"), gens)
    with pytest.raises(ProofVerifyError):
        nizk.verify(inst, inputs_a, Transcript(b"another_label"), gens)


# offsets into the 4192-byte golden proof: the first row commitment, a
# sum-check round's polynomial commitment, a scalar of a round's dot
# product proof, a bullet L point, the last scalar of ry
@pytest.mark.parametrize("offset", [8, 200, 1500, 3300, 4191])
def test_port_rejects_tampered_proof(port, offset):
    inst, inputs_a, gens, _ = port
    bad = bytearray(_golden("nizk_proof.bin"))
    bad[offset] ^= 1
    with pytest.raises((ProofVerifyError, ProofDeserializeError)):
        ser.nizk_from_bytes(bytes(bad)).verify(
            inst, inputs_a, Transcript(b"golden_nizk"), gens)


def test_wrong_inputs_rejected(port):
    inst, inputs_a, gens, blob = port
    nizk = ser.nizk_from_bytes(blob)
    wrong = Assignment([(inputs_a.assignment[0] + 1) % Q]
                       + inputs_a.assignment[1:])
    with pytest.raises(ProofVerifyError):
        nizk.verify(inst, wrong, Transcript(b"golden_nizk"), gens)
    with pytest.raises(ProofVerifyError):
        nizk.verify(inst, Assignment(inputs_a.assignment[:1]),
                    Transcript(b"golden_nizk"), gens)


def test_writer_reader_roundtrip(port):
    blob = port[3]
    assert ser.nizk_to_bytes(ser.nizk_from_bytes(blob)) == blob
    with pytest.raises(ProofDeserializeError):
        ser.nizk_from_bytes(blob[:-1])
    with pytest.raises(ProofDeserializeError):
        ser.nizk_from_bytes(blob + b"\x00")
    bad = bytearray(blob)
    bad[-32:] = (Q + 1).to_bytes(32, "little")  # non-canonical scalar
    with pytest.raises(ProofDeserializeError):
        ser.nizk_from_bytes(bytes(bad))


@pytest.mark.parametrize("row_msm_vmsm", [False, True],
                         ids=["bullet_rounds_on_the_device",
                              "and_vmsm_through_the_row_msm"])
def test_large_msm_paths_give_the_same_bytes(port, monkeypatch,
                                             row_msm_vmsm):
    """The MSM branches that the prover and verifier take only at large
    sizes forced at the golden shape: the dot-product-log's Cx through K5
    and every bullet round on the device (from 2 bullet.DEVICE_MIN
    entries), and with them ``vmsm`` from HOST_MAX points through the
    row-MSM.  The same bytes, and the proof verifies."""
    from spartan_tpu_torch.curve import msm as dmsm
    from spartan_tpu_torch.protocols import bullet

    if row_msm_vmsm:
        monkeypatch.setattr(dmsm, "HOST_MAX", 4)
    monkeypatch.setitem(bullet.DEVICE_MIN, "cpu", 1)
    inst, inputs_a, gens, blob = port
    _, vars_a, _ = Instance.produce_synthetic_r1cs(*SHAPE, seed=424242,
                                                   device="cpu")
    nizk = NIZK.prove(inst, vars_a, inputs_a, gens,
                      Transcript(b"golden_nizk"), _tape_seed=31337)
    assert ser.nizk_to_bytes(nizk) == blob
    nizk.verify(inst, inputs_a, Transcript(b"golden_nizk"), gens)


def test_cubic_instance_prove_verify():
    """x^3 + x + 5 = y (the JAX package's examples/cubic.py), through
    Instance.new: padding, input-column remapping, is_sat."""
    one = 1
    A = [(0, 0, one), (1, 1, one), (2, 2, one), (2, 0, one), (3, 3, one),
         (3, 4, 5)]
    B = [(0, 0, one), (1, 0, one), (2, 4, one), (3, 4, one)]
    C = [(0, 1, one), (1, 2, one), (2, 3, one), (3, 5, one)]
    # variables z0 = x, z1 = x^2, z2 = x^3, z3 = x^3 + x; then 1, y
    inst = Instance.new(4, 4, 1, A, B, C, device="cpu")
    x = 3
    vars_a = Assignment([x, x * x, x ** 3, x ** 3 + x])
    inputs_a = Assignment([x ** 3 + x + 5])
    assert inst.is_sat(vars_a, inputs_a)
    assert not inst.is_sat(vars_a, Assignment([7]))
    gens = NIZKGens(4, 4, 1)
    nizk = NIZK.prove(inst, vars_a, inputs_a, gens, Transcript(b"cubic"),
                      device="cpu")
    blob = ser.nizk_to_bytes(nizk)
    ser.nizk_from_bytes(blob).verify(inst, inputs_a, Transcript(b"cubic"),
                                     gens)
    with pytest.raises(ProofVerifyError):
        ser.nizk_from_bytes(blob).verify(inst, Assignment([7]),
                                         Transcript(b"cubic"), gens)


def test_instance_validation():
    with pytest.raises(R1CSError):
        Instance.new(2, 2, 1, [(5, 0, 1)], [], [], device="cpu")
    with pytest.raises(R1CSError):
        Instance.new(2, 2, 1, [(0, 9, 1)], [], [], device="cpu")
    with pytest.raises(R1CSError):
        Instance.new(2, 2, 1, [(0, 0, Q)], [], [], device="cpu")
    with pytest.raises(R1CSError):
        Instance.new(2, 2, 1, [(0, 0, b"\xff" * 32)], [], [], device="cpu")


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None selects it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Instance.produce_synthetic_r1cs(*SHAPE, seed=1)
    inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
        *SHAPE, seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NIZK.prove(inst, vars_a, inputs_a, NIZKGens(*SHAPE),
                   Transcript(b"x"), device="cuda")
