"""Public API: Instance / Assignment / SNARK / NIZK — reference src/lib.rs.

The signatures are those of the JAX package's ``api.py`` plus a
``device=`` argument: ``None`` is the CUDA card (an error without one),
``"cpu"`` runs the plain PyTorch versions of the kernels.  An instance
lives on one device; ``SNARK.encode``, ``SNARK.prove`` and ``NIZK.prove``
run there.

Byte-level input conventions match the reference: assignments and matrix
values are 32-byte little-endian canonical scalars; out-of-range bytes
raise InvalidScalar, out-of-range indices InvalidIndex
(lib.rs:56-275)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .core.field import Q, from_bytes
from .core.merlin import RandomTape, Transcript
from .device import resolve
from .r1cs.commit import (R1CSCommitment, R1CSCommitmentGens,
                          R1CSDecommitment, R1CSEvalProof, commit_r1cs)
from .r1cs.proof import R1CSGens, R1CSProof
from .r1cs.shape import R1CSShape, _next_pow2
from .utils.errors import ProofVerifyError, R1CSError
from .utils.timer import Timer


class Assignment:
    """lib.rs:56-111."""

    def __init__(self, assignment: list[int]):
        self.assignment = [a % Q for a in assignment]

    @staticmethod
    def new(byte_rows: list[bytes]) -> "Assignment":
        vals = []
        for b in byte_rows:
            v = from_bytes(bytes(b), Q)
            if v is None:
                raise R1CSError(R1CSError.INVALID_SCALAR)
            vals.append(v)
        return Assignment(vals)

    @staticmethod
    def from_ints(xs: list[int]) -> "Assignment":
        return Assignment(list(xs))

    def pad(self, length: int) -> "Assignment":
        assert length > len(self.assignment)
        return Assignment(
            self.assignment + [0] * (length - len(self.assignment)))


VarsAssignment = Assignment
InputsAssignment = Assignment


class Instance:
    """lib.rs:113-275: validation, padding, input-column remapping."""

    def __init__(self, inst: R1CSShape, digest: bytes):
        self.inst = inst
        self.digest = digest

    @property
    def device(self) -> torch.device:
        return self.inst.device

    @staticmethod
    def new(num_cons: int, num_vars: int, num_inputs: int,
            A: list, B: list, C: list, device=None) -> "Instance":
        """Entries are (row, col, val) where val is 32 little-endian
        bytes or a python int."""
        dev = resolve(device)
        num_vars_padded = max(num_vars, num_inputs + 1)
        num_vars_padded = _next_pow2(num_vars_padded)
        if num_cons in (0, 1):
            num_cons_padded = 2
        else:
            num_cons_padded = _next_pow2(num_cons)

        def convert(tups):
            mat = []
            for row, col, val in tups:
                if row >= num_cons:
                    raise R1CSError(R1CSError.INVALID_INDEX)
                if col >= num_vars + 1 + num_inputs:
                    raise R1CSError(R1CSError.INVALID_INDEX)
                if isinstance(val, (bytes, bytearray)):
                    v = from_bytes(bytes(val), Q)
                    if v is None:
                        raise R1CSError(R1CSError.INVALID_SCALAR)
                else:
                    v = int(val)
                    if not 0 <= v < Q:
                        raise R1CSError(R1CSError.INVALID_SCALAR)
                # constant/input columns shift past the padded vars
                if col >= num_vars:
                    mat.append((row, col + num_vars_padded - num_vars, v))
                else:
                    mat.append((row, col, v))
            if num_cons in (0, 1):
                for i in range(len(tups), num_cons_padded):
                    mat.append((i, num_vars, 0))
            return mat

        inst = R1CSShape.create(
            num_cons_padded, num_vars_padded, num_inputs,
            convert(A), convert(B), convert(C), dev)
        return Instance(inst, inst.get_digest())

    def is_sat(self, vars_a: Assignment, inputs_a: Assignment) -> bool:
        if len(vars_a.assignment) > self.inst.num_vars:
            raise R1CSError(R1CSError.INVALID_NUMBER_OF_INPUTS)
        if len(inputs_a.assignment) != self.inst.num_inputs:
            raise R1CSError(R1CSError.INVALID_NUMBER_OF_INPUTS)
        return self.inst.is_sat(_pad_vars(self.inst, vars_a).assignment,
                                inputs_a.assignment)

    @staticmethod
    def produce_synthetic_r1cs(num_cons: int, num_vars: int,
                               num_inputs: int, seed: int = 0, device=None):
        inst, vars_i, inputs_i = R1CSShape.produce_synthetic(
            num_cons, num_vars, num_inputs, seed, resolve(device))
        return (Instance(inst, inst.get_digest()),
                Assignment(vars_i), Assignment(inputs_i))


def _pad_vars(inst: R1CSShape, vars_a: Assignment) -> Assignment:
    if inst.num_vars > len(vars_a.assignment):
        return vars_a.pad(inst.num_vars)
    return vars_a


def _check_device(inst: "Instance", device) -> None:
    if device is not None and resolve(device) != inst.device:
        raise ValueError(f"the instance lies on {inst.device}, not on "
                         f"{resolve(device)}")


class SNARKGens:
    """lib.rs:277-311.  num_nz_entries: max nonzeros in any matrix."""

    def __init__(self, num_cons: int, num_vars: int, num_inputs: int,
                 num_nz_entries: int):
        num_vars_padded = _next_pow2(max(num_vars, num_inputs + 1))
        self.gens_r1cs_sat = R1CSGens(b"gens_r1cs_sat", num_cons,
                                      num_vars_padded)
        self.gens_r1cs_eval = R1CSCommitmentGens(
            b"gens_r1cs_eval", num_cons, num_vars_padded, num_inputs,
            num_nz_entries)


class ComputationCommitment:
    def __init__(self, comm: R1CSCommitment):
        self.comm = comm


class ComputationDecommitment:
    def __init__(self, decomm: R1CSDecommitment):
        self.decomm = decomm


@dataclass
class SNARK:
    """lib.rs:313-465: proof with preprocessing (Spark commitment to the
    R1CS matrices; sub-linear verifier)."""

    r1cs_sat_proof: R1CSProof
    inst_evals: tuple
    r1cs_eval_proof: R1CSEvalProof

    PROTOCOL = b"Spartan SNARK proof"

    @staticmethod
    def encode(inst: Instance, gens: SNARKGens, device=None):
        """Commits the instance's matrices on its device (``device``, if
        given, must name it)."""
        _check_device(inst, device)
        t = Timer("SNARK::encode")
        comm, decomm = commit_r1cs(inst.inst, gens.gens_r1cs_eval)
        t.stop()
        return ComputationCommitment(comm), ComputationDecommitment(decomm)

    @staticmethod
    def prove(inst: Instance, comm: ComputationCommitment,
              decomm: ComputationDecommitment, vars_a: Assignment,
              inputs_a: Assignment, gens: SNARKGens,
              transcript: Transcript, _tape_seed: int | None = None,
              device=None) -> "SNARK":
        """Proves on the instance's device (``device``, if given, must
        name it)."""
        _check_device(inst, device)
        t = Timer("SNARK::prove")
        tape = RandomTape(b"proof", seed=_tape_seed)
        transcript.append_protocol_name(SNARK.PROTOCOL)
        comm.comm.append_to_transcript(b"comm", transcript)

        padded = _pad_vars(inst.inst, vars_a)
        r1cs_sat_proof, rx, ry = R1CSProof.prove(
            inst.inst, padded.assignment, inputs_a.assignment,
            gens.gens_r1cs_sat, transcript, tape)

        t_eval = Timer("eval_sparse_polys")
        inst_evals = inst.inst.evaluate(rx, ry)
        for label, e in zip((b"Ar_claim", b"Br_claim", b"Cr_claim"),
                            inst_evals):
            transcript.append_scalar(label, e)
        t_eval.stop()

        r1cs_eval_proof = R1CSEvalProof.prove(
            decomm.decomm, rx, ry, inst_evals, gens.gens_r1cs_eval,
            transcript, tape)
        t.stop()
        return SNARK(r1cs_sat_proof, inst_evals, r1cs_eval_proof)

    def verify(self, comm: ComputationCommitment, inputs_a: Assignment,
               transcript: Transcript, gens: SNARKGens, device=None) -> None:
        """Host-side, apart from MSMs too large for the host, which run
        on ``device`` (the card unless "cpu" is asked for)."""
        dev = resolve(device)
        t = Timer("SNARK::verify")
        transcript.append_protocol_name(SNARK.PROTOCOL)
        comm.comm.append_to_transcript(b"comm", transcript)

        t_sat = Timer("verify_sat_proof")
        if len(inputs_a.assignment) != comm.comm.num_inputs:
            raise ProofVerifyError("wrong number of inputs")
        rx, ry = self.r1cs_sat_proof.verify(
            comm.comm.num_vars, comm.comm.num_cons, inputs_a.assignment,
            self.inst_evals, transcript, gens.gens_r1cs_sat, dev)
        t_sat.stop()

        t_eval = Timer("verify_eval_proof")
        for label, e in zip((b"Ar_claim", b"Br_claim", b"Cr_claim"),
                            self.inst_evals):
            transcript.append_scalar(label, e)
        self.r1cs_eval_proof.verify(comm.comm, rx, ry, self.inst_evals,
                                    gens.gens_r1cs_eval, transcript, dev)
        t_eval.stop()
        t.stop()


class NIZKGens:
    """lib.rs:467-487."""

    def __init__(self, num_cons: int, num_vars: int, num_inputs: int):
        num_vars_padded = _next_pow2(max(num_vars, num_inputs + 1))
        self.gens_r1cs_sat = R1CSGens(b"gens_r1cs_sat", num_cons,
                                      num_vars_padded)


@dataclass
class NIZK:
    """lib.rs:489-587."""

    r1cs_sat_proof: R1CSProof
    r: tuple  # (rx, ry)

    PROTOCOL = b"Spartan NIZK proof"

    @staticmethod
    def prove(inst: Instance, vars_a: Assignment, inputs_a: Assignment,
              gens: NIZKGens, transcript: Transcript,
              _tape_seed: int | None = None, device=None) -> "NIZK":
        """Proves on the instance's device (``device``, if given, must
        name it)."""
        _check_device(inst, device)
        t = Timer("NIZK::prove")
        tape = RandomTape(b"proof", seed=_tape_seed)
        transcript.append_protocol_name(NIZK.PROTOCOL)
        transcript.append_message(b"R1CSShapeDigest", inst.digest)
        padded = _pad_vars(inst.inst, vars_a)
        proof, rx, ry = R1CSProof.prove(
            inst.inst, padded.assignment, inputs_a.assignment,
            gens.gens_r1cs_sat, transcript, tape)
        t.stop()
        return NIZK(proof, (rx, ry))

    def verify(self, inst: Instance, inputs_a: Assignment,
               transcript: Transcript, gens: NIZKGens, device=None) -> None:
        """Host-side, apart from MSMs too large for the host, which run
        on the instance's device."""
        _check_device(inst, device)
        t = Timer("NIZK::verify")
        transcript.append_protocol_name(NIZK.PROTOCOL)
        transcript.append_message(b"R1CSShapeDigest", inst.digest)

        t_eval = Timer("eval_sparse_polys")
        claimed_rx, claimed_ry = self.r
        inst_evals = inst.inst.evaluate(claimed_rx, claimed_ry)
        t_eval.stop()

        if len(inputs_a.assignment) != inst.inst.num_inputs:
            raise ProofVerifyError("wrong number of inputs")
        rx, ry = self.r1cs_sat_proof.verify(
            inst.inst.num_vars, inst.inst.num_cons, inputs_a.assignment,
            inst_evals, transcript, gens.gens_r1cs_sat, inst.device)
        if rx != list(claimed_rx) or ry != list(claimed_ry):
            raise ProofVerifyError("claimed (rx, ry) mismatch")
        t.stop()
