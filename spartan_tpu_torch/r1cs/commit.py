"""R1CS matrix commitment via Spark (reference r1cs.rs:28-84,305-368)."""

from __future__ import annotations

from dataclasses import dataclass

from ..core.merlin import RandomTape, Transcript
from ..protocols.spark import (
    MultiSparseMatPolynomialAsDense,
    SparseMatPolyCommitment,
    SparseMatPolyCommitmentGens,
    SparseMatPolyEvalProof,
    multi_commit,
)
from ..utils.timer import Timer
from .shape import R1CSShape, _log2


class R1CSCommitmentGens:
    def __init__(self, label: bytes, num_cons: int, num_vars: int,
                 num_inputs: int, num_nz_entries: int):
        assert num_inputs < num_vars
        num_poly_vars_x = _log2(num_cons)
        num_poly_vars_y = _log2(2 * num_vars)
        self.gens = SparseMatPolyCommitmentGens(
            label, num_poly_vars_x, num_poly_vars_y, num_nz_entries, 3)


@dataclass
class R1CSCommitment:
    num_cons: int
    num_vars: int
    num_inputs: int
    comm: SparseMatPolyCommitment

    def append_to_transcript(self, _label: bytes, transcript: Transcript):
        transcript.append_u64(b"num_cons", self.num_cons)
        transcript.append_u64(b"num_vars", self.num_vars)
        transcript.append_u64(b"num_inputs", self.num_inputs)
        self.comm.append_to_transcript(b"comm", transcript)


@dataclass
class R1CSDecommitment:
    dense: MultiSparseMatPolynomialAsDense


def commit_r1cs(inst: R1CSShape, gens: R1CSCommitmentGens):
    comm, dense_rep = multi_commit([inst.A, inst.B, inst.C], gens.gens)
    return (
        R1CSCommitment(inst.num_cons, inst.num_vars, inst.num_inputs, comm),
        R1CSDecommitment(dense_rep),
    )


@dataclass
class R1CSEvalProof:
    proof: SparseMatPolyEvalProof

    @staticmethod
    def prove(decomm: R1CSDecommitment, rx, ry, evals: tuple,
              gens: R1CSCommitmentGens, transcript: Transcript,
              tape: RandomTape) -> "R1CSEvalProof":
        t = Timer("R1CSEvalProof::prove")
        proof = SparseMatPolyEvalProof.prove(
            decomm.dense, rx, ry, list(evals), gens.gens, transcript, tape)
        t.stop()
        return R1CSEvalProof(proof)

    def verify(self, comm: R1CSCommitment, rx, ry, evals: tuple,
               gens: R1CSCommitmentGens, transcript: Transcript,
               device=None) -> None:
        self.proof.verify(comm.comm, rx, ry, list(evals), gens.gens,
                          transcript, device)
