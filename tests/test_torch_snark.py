"""The port's SNARK (``spartan_tpu_torch.api.SNARK``) on the CPU against
the JAX package's frozen wire bytes.

* At the golden shape (16, 16, 2), seed 424242, tape seed 31337 and
  ``Transcript(b"golden_snark")`` (``tests/test_golden.py``), the port's
  computation commitment and SNARK proof equal ``tests/golden/`` byte for
  byte: the JAX package's bytes, so no JAX SNARK runs here.
* So does the proof with every bullet round on the device.
* The port verifies the golden proof and rejects tampered copies and a
  wrong input count; its writer and reader round-trip both blobs.
"""

import os

import jax  # noqa: F401
import pytest
import torch

from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu_torch import serialize as ser
from spartan_tpu_torch.api import SNARK, Assignment, Instance, SNARKGens
from spartan_tpu_torch.core.field import Q
from spartan_tpu_torch.core.merlin import Transcript
from spartan_tpu_torch.utils.errors import (ProofDeserializeError,
                                            ProofVerifyError)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SHAPE = (16, 16, 2)


def _golden(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


def _nnz(inst):
    return max(m.get_num_nz_entries()
               for m in (inst.inst.A, inst.inst.B, inst.inst.C))


@pytest.fixture(scope="module")
def port():
    inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
        *SHAPE, seed=424242, device="cpu")
    gens = SNARKGens(*SHAPE, _nnz(inst))
    comm, decomm = SNARK.encode(inst, gens)
    snark = SNARK.prove(inst, comm, decomm, vars_a, inputs_a, gens,
                        Transcript(b"golden_snark"), _tape_seed=31337)
    return dict(inst=inst, vars=vars_a, inputs=inputs_a, gens=gens,
                decomm=decomm, comm=ser.commitment_to_bytes(comm),
                proof=ser.snark_to_bytes(snark))


def _verify(port, proof_blob, inputs=None, label=b"golden_snark"):
    ser.snark_from_bytes(proof_blob).verify(
        ser.commitment_from_bytes(port["comm"]),
        port["inputs"] if inputs is None else inputs, Transcript(label),
        port["gens"], device="cpu")


def test_golden_commitment_bytes(port):
    assert port["comm"] == _golden("snark_commitment.bin")


def test_golden_snark_bytes(port):
    assert port["proof"] == _golden("snark_proof.bin")


def test_golden_snark_with_bullet_rounds_on_the_device(port, monkeypatch):
    """Every bullet round of the SNARK's dot-product-log proofs on the
    device (``bullet.DEVICE_MIN`` of the CPU set to 1: kernels K5, K6 and
    K4 through their plain versions): the golden bytes, and the proof
    verifies."""
    from spartan_tpu_torch.protocols import bullet

    monkeypatch.setitem(bullet.DEVICE_MIN, "cpu", 1)
    comm = ser.commitment_from_bytes(port["comm"])
    snark = SNARK.prove(port["inst"], comm, port["decomm"], port["vars"],
                        port["inputs"], port["gens"],
                        Transcript(b"golden_snark"), _tape_seed=31337)
    blob = ser.snark_to_bytes(snark)
    assert blob == _golden("snark_proof.bin")
    _verify(port, blob)


def test_port_verifies_golden_snark(port):
    _verify(port, _golden("snark_proof.bin"))
    with pytest.raises(ProofVerifyError):
        _verify(port, _golden("snark_proof.bin"), label=b"another_label")


# offsets into the 13,800-byte golden proof: the sat proof (bytes 0-3887:
# its first row commitment, a sum-check round); Ar, Br, Cr (3888-3983);
# the derefs commitment (3984-4247); the product layer (4248-11871: its
# claims, the mem circuits' proof from 5000, the ops circuits' from
# 7472); the hash layer (11872-13799: an evaluation, the last poly-eval
# proof's last scalar)
@pytest.mark.parametrize("offset", [8, 1500, 3900, 4200, 4300, 4700, 6000,
                                    8000, 11000, 12100, 13799])
def test_port_rejects_tampered_snark(port, offset):
    bad = bytearray(_golden("snark_proof.bin"))
    bad[offset] ^= 1
    with pytest.raises((ProofVerifyError, ProofDeserializeError)):
        _verify(port, bytes(bad))


def test_wrong_inputs_rejected(port):
    inputs = port["inputs"].assignment
    with pytest.raises(ProofVerifyError):
        _verify(port, port["proof"], Assignment(inputs[:1]))
    with pytest.raises(ProofVerifyError):
        _verify(port, port["proof"],
                Assignment([(inputs[0] + 1) % Q] + inputs[1:]))


def test_writer_reader_roundtrip(port):
    comm, proof = port["comm"], port["proof"]
    assert ser.commitment_to_bytes(ser.commitment_from_bytes(comm)) == comm
    assert ser.snark_to_bytes(ser.snark_from_bytes(proof)) == proof
    for reader, blob in ((ser.commitment_from_bytes, comm),
                         (ser.snark_from_bytes, proof)):
        with pytest.raises(ProofDeserializeError):
            reader(blob[:-1])
        with pytest.raises(ProofDeserializeError):
            reader(blob + b"\x00")


def test_snark_entry_points_need_a_card_unless_cpu_is_asked(port):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None selects it")
    inst, gens = port["inst"], port["gens"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SNARK.encode(inst, gens, device="cuda")
    comm, decomm = SNARK.encode(inst, gens, device="cpu")
    _, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
        *SHAPE, seed=424242, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SNARK.prove(inst, comm, decomm, vars_a, inputs_a, gens,
                    Transcript(b"x"), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ser.snark_from_bytes(port["proof"]).verify(
            comm, inputs_a, Transcript(b"golden_snark"), gens)
