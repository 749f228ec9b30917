"""Sum-check (reference src/sumcheck.rs): the ZK variant of the NIZK
path (sumcheck.rs:64-179,427-776) and the clear-text variant of the
SNARK's product layers (sumcheck.rs:18-61,183-252).

Per round the prover reads the round polynomial's evaluations at
{0,2,3} from the device, the host commits the polynomial, absorbs it
into the transcript and draws the challenge, and the device binds the
top variable of every table to it.  Kernel B2 (``ff.round_kernel``)
does the device side of a round in one launch: the fold by the previous
challenge fused with the next round's evaluations.  A phase of k rounds
is 1 + (k - 1) + 1 launches: evals only, then fold-and-evals, then the
last fold.  Tables stay in the normal (half-pair) layout throughout.

The clear-text ``SumcheckInstanceProof`` sends the round polynomials
as they are.  Its rounds over the comb A*B*C (``prove_cubic_batched``,
the product-tree layers' rounds; ``prove_cubic`` is its one-instance
case) run through kernel B2's batched 3-table mode.

Under a device mesh (``parallel/context.py``) the ZK phases' tables,
and the product layers' tables that their site passes in, are sharded
over the mesh, one B2 launch a shard a round (``parallel/mesh.py``),
for the same bytes.

This is the port's one prover path.  The JAX package's opt-in
device-resident loops (its ``protocols/device_prover.py``, with the
transcript on the device and one fetch a phase) are not ported: on the
H100 they proved slower than these rounds.
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
from ..parallel import context as pctx
from ..parallel.mesh import (ShardedProductLayerTables,
                             ShardedSumcheckTables, evals_to_ints)
from ..poly.unipoly import UniPoly
from ..utils.errors import ProofVerifyError
from . import _combs
from .sigma import DotProductProof, _decompress


@dataclass
class SumcheckInstanceProof:
    compressed_polys: list  # list[list[int]]

    def verify(self, claim: int, num_rounds: int, degree_bound: int,
               transcript: Transcript) -> tuple[int, list[int]]:
        """sumcheck.rs:18-61.  Returns (the last round's claim, the
        challenges)."""
        if (len(self.compressed_polys) != num_rounds
                or any(len(c) != degree_bound
                       for c in self.compressed_polys)):
            raise ProofVerifyError("wrong number of rounds or coefficients")
        e = claim % Q
        r = []
        for coeffs in self.compressed_polys:
            poly = UniPoly.decompress(coeffs, e)
            if poly.degree() != degree_bound:
                raise ProofVerifyError("degree bound violated")
            if (poly.eval_at_zero() + poly.eval_at_one()) % Q != e:
                raise ProofVerifyError("sum claim mismatch")
            poly.append_to_transcript(b"poly", transcript)
            r_i = transcript.challenge_scalar(b"challenge_nextround")
            r.append(r_i)
            e = poly.evaluate(r_i)
        return e, r

    @staticmethod
    def prove_cubic(claim: int, num_rounds: int, polys: list[torch.Tensor],
                    transcript: Transcript
                    ) -> tuple["SumcheckInstanceProof", list[int], list[int]]:
        """prove_cubic with comb = A*B*C (sumcheck.rs:183-252); ``polys``
        = [A, B, C], (n, 8) tables, n = 2^num_rounds.  Returns (proof,
        challenges, the three final claims): the one-instance case of
        ``prove_cubic_batched``."""
        proof, r, tables = SumcheckInstanceProof.prove_cubic_batched(
            claim, num_rounds, [t[None] for t in polys], [1], transcript)
        claims = fq.decode_to_ints(torch.cat([t[:, 0] for t in tables]))
        return proof, r, claims

    @staticmethod
    def prove_cubic_batched(claim: int, num_rounds: int,
                            tables: list[torch.Tensor], coeffs: list[int],
                            transcript: Transcript, mesh=None
                            ) -> tuple["SumcheckInstanceProof", list[int],
                                       list[torch.Tensor]]:
        """prove_cubic_batched (sumcheck.rs:254-424) over the comb A*B*C
        of B instances: ``tables`` = [A, B, C], (B, n, 8), n =
        2^num_rounds; instance b's round polynomial enters with weight
        ``coeffs[b]``.  One launch of kernel B2's batched mode a round
        (a shard, over ``mesh``), its (3, B) evals fetched at once.
        Returns (proof, challenges, the bound (B, 1, 8) tables)."""
        e = claim % Q
        r: list[int] = []
        compressed = []
        tabs = ShardedProductLayerTables(mesh, *tables)
        if num_rounds:
            ev = tabs.evals()
        for j in range(num_rounds):
            flat = evals_to_ints(ev)
            nb = len(flat) // 3
            e0, e2, e3 = (sum(c * v for c, v in
                              zip(coeffs, flat[i * nb:(i + 1) * nb])) % Q
                          for i in range(3))
            poly = UniPoly.from_evals([e0, (e - e0) % Q, e2, e3])
            poly.append_to_transcript(b"poly", transcript)
            r_j = transcript.challenge_scalar(b"challenge_nextround")
            r.append(r_j)
            mode = "fold_evals" if j + 1 < num_rounds else "fold"
            ev = tabs.round(r_j, mode)
            e = poly.evaluate(r_j)
            compressed.append(poly.compress())
        return SumcheckInstanceProof(compressed), r, tabs.tables


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
        the comb ("quad" or "cubic").  Under a device mesh the tables
        are sharded over it (JAX ``sumcheck.py:436-447``)."""
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

        tabs = ShardedSumcheckTables(pctx.get_mesh(), tables, which)
        es_dev = tabs.evals()
        for j in range(num_rounds):
            es = evals_to_ints(es_dev)[:nevals]
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
            es_dev = tabs.round(r_j, mode)

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

        final_claims = fq.decode_to_ints(tabs.final_scalars())
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
