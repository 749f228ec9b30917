"""R1CSProof — the satisfiability argument at the heart of Spartan
(reference src/r1csproof.rs).

Prover pipeline (transcript order reproduced exactly from
r1csproof.rs:144-349):
  1. upload the witness once, canonical; commit to it
     (row-MSM kernel + batch compress)                            [device]
  2. z on the device (the Montgomery map kernel writes the witness
     into it); tau challenge; eq-table expand; SpMV -> Az,Bz,Cz   [device]
  3. phase-1 ZK sumcheck of sum eq(tau,x)(Az*Bz - Cz) = 0        [B2 rounds]
  4. claim-linking sigma proofs (Knowledge/Product/Equality)      [host]
  5. r_A,r_B,r_C combine; transpose-SpMV eval tables              [device]
  6. phase-2 ZK sumcheck of sum (rA*A~+rB*B~+rC*C~)(y)*Z(y)       [B2 rounds]
  7. witness evaluation proof at ry (bound_L + bullet IPA)        [device+host]
  8. final equality proof                                         [host]
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..commitments import MultiCommitGens, commit_scalar
from ..core import ristretto as hri
from ..core.field import Q
from ..core.merlin import RandomTape, Transcript
from ..curve.msm import vmsm
from ..ff import fq, limb
from ..poly import commit as poly_commit
from ..poly import dense
from ..poly.commit import PolyCommitment, PolyCommitmentGens, PolyEvalProof
from ..protocols.sigma import EqualityProof, KnowledgeProof, ProductProof, _decompress
from ..protocols.sumcheck import ZKSumcheckInstanceProof
from ..utils.timer import Timer
from .shape import R1CSShape, SparsePolynomial, _log2


class R1CSSumcheckGens:
    """r1csproof.rs:40-57."""

    def __init__(self, label: bytes, gens_1_ref: MultiCommitGens):
        self.gens_1 = gens_1_ref
        self.gens_3 = MultiCommitGens(3, label)
        self.gens_4 = MultiCommitGens(4, label)


class R1CSGens:
    """r1csproof.rs:59-74."""

    def __init__(self, label: bytes, _num_cons: int, num_vars: int):
        num_poly_vars = _log2(num_vars)
        self.gens_pc = PolyCommitmentGens(num_poly_vars, label)
        self.gens_sc = R1CSSumcheckGens(label, self.gens_pc.gens.gens_1)


def witness_z(vars_canon: torch.Tensor, input_ints: list[int]
              ) -> torch.Tensor:
    """z = (vars, 1, inputs, 0, ..., 0), 2 num_vars entries
    (r1csproof.rs:178-185), as a Montgomery table on the device of the
    witness's canonical scalars ``vars_canon`` ((num_vars, 8)): the vars
    mapped there straight into z's first half (``fq.to_mont``), the
    constant 1 and the inputs mapped on the host."""
    n = vars_canon.shape[0]
    z = torch.zeros((2 * n, limb.NWORDS), dtype=torch.int32,
                    device=vars_canon.device)
    fq.to_mont(vars_canon, out=z[:n])
    z[n:n + 1 + len(input_ints)] = fq.encode_ints([1, *input_ints], z.device)
    return z


@dataclass
class R1CSProof:
    comm_vars: PolyCommitment
    sc_proof_phase1: ZKSumcheckInstanceProof
    claims_phase2: tuple  # (comm_Az, comm_Bz, comm_Cz, comm_prod) bytes
    pok_claims_phase2: tuple  # (KnowledgeProof, ProductProof)
    proof_eq_sc_phase1: EqualityProof
    sc_proof_phase2: ZKSumcheckInstanceProof
    comm_vars_at_ry: bytes
    proof_eval_vars_at_ry: PolyEvalProof
    proof_eq_sc_phase2: EqualityProof

    PROTOCOL = b"R1CS proof"

    @staticmethod
    def prove(inst: R1CSShape, vars_ints: list[int], input_ints: list[int],
              gens: R1CSGens, transcript: Transcript, tape: RandomTape
              ) -> tuple["R1CSProof", list[int], list[int]]:
        """Runs on the instance's device."""
        dev = inst.device
        t_prove = Timer("R1CSProof::prove")
        transcript.append_protocol_name(R1CSProof.PROTOCOL)
        assert len(input_ints) < len(vars_ints)
        transcript.append_scalar_vector(b"input", input_ints)

        t_commit = Timer("polycommit")
        # the witness crosses to the device once, as canonical scalars:
        # B1 commits to them as they are, and phase one maps them into z
        vars_canon = limb.ints_to_limbs(vars_ints, dev)
        comm_vars, blinds_vars = poly_commit.commit_canonical(
            vars_canon, gens.gens_pc, tape)
        comm_vars.append_to_transcript(b"poly_commitment", transcript)
        t_commit.stop()

        t_sc1 = Timer("prove_sc_phase_one")
        z = witness_z(vars_canon, input_ints)
        del vars_canon
        poly_vars = z[:len(vars_ints)]  # the witness's Montgomery table

        num_rounds_x = _log2(inst.num_cons)
        num_rounds_y = _log2(z.shape[0])
        tau = transcript.challenge_vector(b"challenge_tau", num_rounds_x)
        poly_tau = dense.eq_evals(tau, dev)
        poly_Az, poly_Bz, poly_Cz = inst.multiply_vec(z)

        (sc_proof_phase1, rx, claims_phase1, blind_claim_postsc1) = (
            ZKSumcheckInstanceProof.prove_cubic_with_additive_term(
                0, 0, num_rounds_x, poly_tau, poly_Az, poly_Bz, poly_Cz,
                gens.gens_sc.gens_1, gens.gens_sc.gens_4, transcript, tape))
        tau_claim, Az_claim, Bz_claim, Cz_claim = claims_phase1
        t_sc1.stop()

        Az_blind = tape.random_scalar(b"Az_blind")
        Bz_blind = tape.random_scalar(b"Bz_blind")
        Cz_blind = tape.random_scalar(b"Cz_blind")
        prod_Az_Bz_blind = tape.random_scalar(b"prod_Az_Bz_blind")

        pok_Cz_claim, comm_Cz_claim = KnowledgeProof.prove(
            gens.gens_sc.gens_1, transcript, tape, Cz_claim, Cz_blind)
        prod = Az_claim * Bz_claim % Q
        (proof_prod, comm_Az_claim, comm_Bz_claim, comm_prod_Az_Bz_claims) = (
            ProductProof.prove(gens.gens_sc.gens_1, transcript, tape,
                               Az_claim, Az_blind, Bz_claim, Bz_blind,
                               prod, prod_Az_Bz_blind))

        transcript.append_point(b"comm_Az_claim", comm_Az_claim)
        transcript.append_point(b"comm_Bz_claim", comm_Bz_claim)
        transcript.append_point(b"comm_Cz_claim", comm_Cz_claim)
        transcript.append_point(b"comm_prod_Az_Bz_claims", comm_prod_Az_Bz_claims)

        taus_bound_rx = tau_claim
        blind_expected_claim_postsc1 = (
            taus_bound_rx * (prod_Az_Bz_blind - Cz_blind)) % Q
        claim_post_phase1 = (
            (Az_claim * Bz_claim - Cz_claim) * taus_bound_rx) % Q
        proof_eq_sc_phase1, _, _ = EqualityProof.prove(
            gens.gens_sc.gens_1, transcript, tape,
            claim_post_phase1, blind_expected_claim_postsc1,
            claim_post_phase1, blind_claim_postsc1)

        t_sc2 = Timer("prove_sc_phase_two")
        r_A = transcript.challenge_scalar(b"challenge_Az")
        r_B = transcript.challenge_scalar(b"challenge_Bz")
        r_C = transcript.challenge_scalar(b"challenge_Cz")
        claim_phase2 = (r_A * Az_claim + r_B * Bz_claim + r_C * Cz_claim) % Q
        blind_claim_phase2 = (
            r_A * Az_blind + r_B * Bz_blind + r_C * Cz_blind) % Q

        evals_rx = dense.eq_evals(rx, dev)
        evals_A, evals_B, evals_C = inst.compute_eval_table_sparse(
            evals_rx, z.shape[0])
        rA_m, rB_m, rC_m = (fq.mont_limbs(x, dev) for x in (r_A, r_B, r_C))
        evals_ABC = fq.add(
            fq.add(fq.mul(evals_A, rA_m), fq.mul(evals_B, rB_m)),
            fq.mul(evals_C, rC_m))

        (sc_proof_phase2, ry, claims_phase2, blind_claim_postsc2) = (
            ZKSumcheckInstanceProof.prove_quad(
                claim_phase2, blind_claim_phase2, num_rounds_y,
                z, evals_ABC,
                gens.gens_sc.gens_1, gens.gens_sc.gens_3, transcript, tape))
        t_sc2.stop()

        t_pe = Timer("polyeval")
        eval_vars_at_ry = dense.evaluate(poly_vars, ry[1:])
        blind_eval = tape.random_scalar(b"blind_eval")
        proof_eval_vars_at_ry, comm_vars_at_ry = PolyEvalProof.prove(
            poly_vars, blinds_vars, ry[1:], eval_vars_at_ry, blind_eval,
            gens.gens_pc, transcript, tape)
        t_pe.stop()

        blind_eval_Z_at_ry = (1 - ry[0]) * blind_eval % Q
        blind_expected_claim_postsc2 = (
            claims_phase2[1] * blind_eval_Z_at_ry) % Q
        claim_post_phase2 = claims_phase2[0] * claims_phase2[1] % Q
        proof_eq_sc_phase2, _, _ = EqualityProof.prove(
            gens.gens_pc.gens.gens_1, transcript, tape,
            claim_post_phase2, blind_expected_claim_postsc2,
            claim_post_phase2, blind_claim_postsc2)
        t_prove.stop()

        return (
            R1CSProof(
                comm_vars, sc_proof_phase1,
                (comm_Az_claim, comm_Bz_claim, comm_Cz_claim,
                 comm_prod_Az_Bz_claims),
                (pok_Cz_claim, proof_prod),
                proof_eq_sc_phase1, sc_proof_phase2,
                comm_vars_at_ry, proof_eval_vars_at_ry, proof_eq_sc_phase2,
            ),
            rx, ry,
        )

    def verify(self, num_vars: int, num_cons: int, input_ints: list[int],
               evals: tuple[int, int, int], transcript: Transcript,
               gens: R1CSGens, device=None) -> tuple[list[int], list[int]]:
        """Host-side; ``device`` takes the MSMs too large for the host."""
        transcript.append_protocol_name(R1CSProof.PROTOCOL)
        transcript.append_scalar_vector(b"input", input_ints)
        self.comm_vars.append_to_transcript(b"poly_commitment", transcript)

        num_rounds_x = _log2(num_cons)
        num_rounds_y = _log2(2 * num_vars)
        tau = transcript.challenge_vector(b"challenge_tau", num_rounds_x)

        claim_phase1 = hri.encode(commit_scalar(0, 0, gens.gens_sc.gens_1))
        comm_claim_post_phase1, rx = self.sc_proof_phase1.verify(
            claim_phase1, num_rounds_x, 3,
            gens.gens_sc.gens_1, gens.gens_sc.gens_4, transcript)

        (comm_Az_claim, comm_Bz_claim, comm_Cz_claim,
         comm_prod_Az_Bz_claims) = self.claims_phase2
        pok_Cz_claim, proof_prod = self.pok_claims_phase2

        pok_Cz_claim.verify(gens.gens_sc.gens_1, transcript, comm_Cz_claim)
        proof_prod.verify(gens.gens_sc.gens_1, transcript,
                          comm_Az_claim, comm_Bz_claim, comm_prod_Az_Bz_claims)

        transcript.append_point(b"comm_Az_claim", comm_Az_claim)
        transcript.append_point(b"comm_Bz_claim", comm_Bz_claim)
        transcript.append_point(b"comm_Cz_claim", comm_Cz_claim)
        transcript.append_point(b"comm_prod_Az_Bz_claims", comm_prod_Az_Bz_claims)

        taus_bound_rx = 1
        for r_i, t_i in zip(rx, tau):
            taus_bound_rx = (
                taus_bound_rx * (r_i * t_i + (1 - r_i) * (1 - t_i))) % Q
        expected_claim_post_phase1 = hri.encode(
            _decompress(comm_prod_Az_Bz_claims)
            .add(_decompress(comm_Cz_claim).neg())
            .mul(taus_bound_rx))
        self.proof_eq_sc_phase1.verify(
            gens.gens_sc.gens_1, transcript,
            expected_claim_post_phase1, comm_claim_post_phase1)

        r_A = transcript.challenge_scalar(b"challenge_Az")
        r_B = transcript.challenge_scalar(b"challenge_Bz")
        r_C = transcript.challenge_scalar(b"challenge_Cz")
        comm_claim_phase2 = hri.encode(vmsm(
            [r_A, r_B, r_C],
            [_decompress(comm_Az_claim), _decompress(comm_Bz_claim),
             _decompress(comm_Cz_claim)]))

        comm_claim_post_phase2, ry = self.sc_proof_phase2.verify(
            comm_claim_phase2, num_rounds_y, 2,
            gens.gens_sc.gens_1, gens.gens_sc.gens_3, transcript)

        self.proof_eval_vars_at_ry.verify(
            gens.gens_pc, transcript, ry[1:],
            self.comm_vars_at_ry, self.comm_vars, device)

        entries = [(0, 1)] + [(i + 1, v % Q) for i, v in enumerate(input_ints)]
        poly_input_eval = SparsePolynomial(
            _log2(num_vars), entries).evaluate(ry[1:])

        comm_eval_Z_at_ry = vmsm(
            [(1 - ry[0]) % Q, ry[0]],
            [_decompress(self.comm_vars_at_ry),
             commit_scalar(poly_input_eval, 0, gens.gens_pc.gens.gens_1)])

        eval_A_r, eval_B_r, eval_C_r = evals
        scalar = (r_A * eval_A_r + r_B * eval_B_r + r_C * eval_C_r) % Q
        expected_claim_post_phase2 = hri.encode(comm_eval_Z_at_ry.mul(scalar))
        self.proof_eq_sc_phase2.verify(
            gens.gens_sc.gens_1, transcript,
            expected_claim_post_phase2, comm_claim_post_phase2)
        return rx, ry
