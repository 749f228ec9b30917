"""ZK sum-check (reference src/sumcheck.rs:64-179,427-776).

Per round the prover reads the round polynomial's evaluations at
{0,2,3} from the device, the host commits the polynomial, absorbs it
into the transcript and draws the challenge, and the device binds the
top variable of every table to it.  Kernel B2 (``ff.round_kernel``)
does the device side of a round in one launch: the fold by the previous
challenge fused with the next round's evaluations.  A phase of k rounds
is 1 + (k - 1) + 1 launches: evals only, then fold-and-evals, then the
last fold.  Tables stay in the normal (half-pair) layout throughout.

Only the zero-knowledge variant is on the NIZK path; the clear-text
``SumcheckInstanceProof`` belongs to the SNARK slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..commitments import MultiCommitGens, commit_scalar, commit_vector_host
from ..core import ristretto as hri
from ..core.field import Q
from ..core.merlin import RandomTape, Transcript
from ..curve.msm import vmsm
from ..ff import fq
from ..ff.round_kernel import fold_evals
from ..poly.unipoly import UniPoly
from ..utils.errors import ProofVerifyError
from . import _combs
from .sigma import DotProductProof, _decompress


@dataclass
class ZKSumcheckInstanceProof:
    comm_polys: list  # bytes
    comm_evals: list  # bytes
    proofs: list  # DotProductProof

    def verify(self, comm_claim: bytes, num_rounds: int, degree_bound: int,
               gens_1: MultiCommitGens, gens_n: MultiCommitGens,
               transcript: Transcript) -> tuple[bytes, list[int]]:
        if gens_n.n != degree_bound + 1:
            raise ProofVerifyError("generator count != degree bound + 1")
        if (len(self.comm_polys) != num_rounds
                or len(self.comm_evals) != num_rounds
                or len(self.proofs) != num_rounds):
            raise ProofVerifyError("wrong number of rounds")
        r = []
        for i in range(num_rounds):
            comm_poly = self.comm_polys[i]
            transcript.append_point(b"comm_poly", comm_poly)
            r_i = transcript.challenge_scalar(b"challenge_nextround")
            comm_claim_per_round = comm_claim if i == 0 else self.comm_evals[i - 1]
            comm_eval = self.comm_evals[i]
            transcript.append_point(b"comm_claim_per_round", comm_claim_per_round)
            transcript.append_point(b"comm_eval", comm_eval)
            w = transcript.challenge_vector(b"combine_two_claims_to_one", 2)
            comm_target = hri.encode(vmsm(
                w, [_decompress(comm_claim_per_round), _decompress(comm_eval)]
            ))
            a_sc = [1] * (degree_bound + 1)
            a_sc[0] = 2
            a_eval = [1]
            for _ in range(degree_bound):
                a_eval.append(a_eval[-1] * r_i % Q)
            a = [(w[0] * x + w[1] * y) % Q for x, y in zip(a_sc, a_eval)]
            self.proofs[i].verify(gens_1, gens_n, transcript, a,
                                  comm_poly, comm_target)
            r.append(r_i)
        return self.comm_evals[-1], r

    @staticmethod
    def _prove_rounds(claim: int, blind_claim: int, num_rounds: int,
                      tables: list[torch.Tensor], which: str,
                      gens_1: MultiCommitGens, gens_n: MultiCommitGens,
                      transcript: Transcript, tape: RandomTape):
        """Shared round loop for prove_quad / prove_cubic_with_additive_term
        (identical structure, sumcheck.rs:428-586 vs 588-776).  ``tables``
        are (n, 8) Montgomery tables, n = 2^num_rounds; ``which`` names
        the comb ("quad" or "cubic")."""
        assert len(tables) == _combs.NTABLES[which]
        assert tables[0].shape[0] == 1 << num_rounds
        nevals = _combs.NEVALS[which]
        blinds_poly = tape.random_vector(b"blinds_poly", num_rounds)
        blinds_evals = tape.random_vector(b"blinds_evals", num_rounds)
        claim_per_round = claim % Q
        comm_claim_per_round = hri.encode(
            commit_scalar(claim_per_round, blind_claim, gens_1))

        r: list[int] = []
        comm_polys: list[bytes] = []
        comm_evals: list[bytes] = []
        proofs: list[DotProductProof] = []

        tables, es_dev = fold_evals(tables, None, "evals")
        for j in range(num_rounds):
            es = fq.decode_to_ints(es_dev)[:nevals]
            e0 = es[0]
            evals = [e0, (claim_per_round - e0) % Q] + es[1:]
            poly = UniPoly.from_evals(evals)
            comm_poly = hri.encode(
                commit_vector_host(poly.coeffs, blinds_poly[j], gens_n))
            transcript.append_point(b"comm_poly", comm_poly)
            comm_polys.append(comm_poly)

            r_j = transcript.challenge_scalar(b"challenge_nextround")
            # the device folds (and evaluates the next round) while the
            # host runs this round's sigma proof
            mode = "fold_evals" if j + 1 < num_rounds else "fold"
            tables, es_dev = fold_evals(tables, r_j, mode)

            eval_r = poly.evaluate(r_j)
            comm_eval = hri.encode(
                commit_scalar(eval_r, blinds_evals[j], gens_1))
            transcript.append_point(b"comm_claim_per_round", comm_claim_per_round)
            transcript.append_point(b"comm_eval", comm_eval)
            w = transcript.challenge_vector(b"combine_two_claims_to_one", 2)

            target = (w[0] * claim_per_round + w[1] * eval_r) % Q
            blind_sc = blind_claim if j == 0 else blinds_evals[j - 1]
            blind = (w[0] * blind_sc + w[1] * blinds_evals[j]) % Q

            a_sc = [1] * (poly.degree() + 1)
            a_sc[0] = 2
            a_eval = [1]
            for _ in range(poly.degree()):
                a_eval.append(a_eval[-1] * r_j % Q)
            a = [(w[0] * x + w[1] * y) % Q for x, y in zip(a_sc, a_eval)]

            proof, _, _ = DotProductProof.prove(
                gens_1, gens_n, transcript, tape,
                poly.coeffs, blinds_poly[j], a, target, blind)

            proofs.append(proof)
            claim_per_round = eval_r
            comm_claim_per_round = comm_eval
            r.append(r_j)
            comm_evals.append(comm_eval)

        final_claims = fq.decode_to_ints(torch.cat(tables, dim=0))
        return (
            ZKSumcheckInstanceProof(comm_polys, comm_evals, proofs),
            r,
            final_claims,
            blinds_evals[num_rounds - 1],
        )

    @staticmethod
    def prove_quad(claim: int, blind_claim: int, num_rounds: int,
                   poly_A: torch.Tensor, poly_B: torch.Tensor,
                   gens_1: MultiCommitGens, gens_n: MultiCommitGens,
                   transcript: Transcript, tape: RandomTape):
        return ZKSumcheckInstanceProof._prove_rounds(
            claim, blind_claim, num_rounds, [poly_A, poly_B], "quad",
            gens_1, gens_n, transcript, tape)

    @staticmethod
    def prove_cubic_with_additive_term(
            claim: int, blind_claim: int, num_rounds: int,
            poly_A, poly_B, poly_C, poly_D,
            gens_1: MultiCommitGens, gens_n: MultiCommitGens,
            transcript: Transcript, tape: RandomTape):
        return ZKSumcheckInstanceProof._prove_rounds(
            claim, blind_claim, num_rounds, [poly_A, poly_B, poly_C, poly_D],
            "cubic", gens_1, gens_n, transcript, tape)
