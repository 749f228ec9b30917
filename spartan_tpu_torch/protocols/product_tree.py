"""Grand-product circuits and their batched sum-check evaluation proofs
(reference src/product_tree.rs; the JAX package's
``protocols/product_tree.py``, normal layout only).

All same-shaped circuits live in one ``(B, n, 8)`` tensor: the tree
build is one field product per layer, and a layer's rounds are
``SumcheckInstanceProof.prove_cubic_batched`` over the circuits'
(left, right, eq) tables, the dot-product circuits' (left, right,
weight) tables appended as more instances at layer 0: one launch of
kernel B2's batched 3-table mode (``ff.round_kernel``) a round, the
``(3, B)`` evals fetched in one transfer and folded on the host with
the layer's random coefficients (one launch a shard under a device
mesh, ``parallel/mesh.py``).  The JAX package's bit-reversed layout,
its padded tiers and one-program rounds answered the TPU's compile
costs and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.field import Q
from ..core.merlin import Transcript
from ..ff import fq, limb
from ..parallel import context as pctx
from ..poly import dense
from ..utils.errors import ProofVerifyError
from .sumcheck import SumcheckInstanceProof


class ProductCircuitBatch:
    """B binary product trees over ``(B, n, 8)`` leaf tables
    (product_tree.rs:12-64, instance-batched): layer k holds the left and
    right halves of the products of layer k - 1, the leaves first."""

    def __init__(self, inputs: torch.Tensor):
        n = inputs.shape[1]
        assert n & (n - 1) == 0 and n >= 2
        self.num_layers = n.bit_length() - 1
        self.left = [inputs[:, : n // 2]]
        self.right = [inputs[:, n // 2:]]
        for _ in range(self.num_layers - 1):
            prod = fq.mul(self.left[-1], self.right[-1])
            half = prod.shape[1] // 2
            self.left.append(prod[:, :half])
            self.right.append(prod[:, half:])

    def evaluate(self) -> list[int]:
        """The B roots."""
        return fq.decode_to_ints(
            fq.mul(self.left[-1][:, 0], self.right[-1][:, 0]))


class DotProductCircuitBatch:
    """B weighted dot products <L, R . W> (product_tree.rs:66-108)."""

    def __init__(self, left, right, weight):
        self.left, self.right, self.weight = left, right, weight

    def evaluate(self) -> list[int]:
        prod = fq.mul(fq.mul(self.left, self.right), self.weight)
        return fq.decode_to_ints(fq.sum_mod(prod, dim=1))


@dataclass
class LayerProofBatched:
    proof: SumcheckInstanceProof
    claims_prod_left: list
    claims_prod_right: list


def _combine(coeffs: list[int], vals: list[int]) -> int:
    return sum(c * v for c, v in zip(coeffs, vals)) % Q


@dataclass
class ProductCircuitEvalProofBatched:
    """product_tree.rs:258-486."""

    proof: list  # LayerProofBatched
    claims_dotp: tuple  # (left, right, weight) final claims

    @staticmethod
    def prove(prod: ProductCircuitBatch,
              dotp: DotProductCircuitBatch | None,
              transcript: Transcript):
        """Returns (proof, the last layer's challenges)."""
        num_prod = prod.left[0].shape[0]
        dev = prod.left[0].device
        claims_to_verify = prod.evaluate()
        claims_dotp_final = ([], [], [])
        proof_layers = []
        rand: list[int] = []

        for layer_id in range(prod.num_layers - 1, -1, -1):
            A = prod.left[layer_id]
            Bt = prod.right[layer_id]
            m = A.shape[1]
            C_par = dense.eq_evals(rand, dev)
            assert C_par.shape[0] == m
            num_rounds = m.bit_length() - 1

            # the dot-product circuits' tables have the same length as
            # the layer-0 tables, so they join the batch as instances
            # (sumcheck.rs's par/seq split run as one batch)
            has_seq = layer_id == 0 and dotp is not None
            if has_seq:
                claims_to_verify = claims_to_verify + dotp.evaluate()

            coeffs = transcript.challenge_vector(
                b"rand_coeffs_next_layer", len(claims_to_verify))
            claim = _combine(coeffs, claims_to_verify)

            C_b = C_par[None].expand(num_prod, m, limb.NWORDS)
            if has_seq:
                A = torch.cat([A, dotp.left])
                Bt = torch.cat([Bt, dotp.right])
                C_b = torch.cat([C_b, dotp.weight])

            # the layer's rounds shard over an active device mesh (JAX
            # product_tree.py:411-420); prove_cubic's callers do not
            layer_proof, r_round, tables = \
                SumcheckInstanceProof.prove_cubic_batched(
                    claim, num_rounds, [A, Bt, C_b], coeffs, transcript,
                    pctx.get_mesh())
            A, Bt, C_b = tables

            # all end-of-layer claims in one fetch
            finals = fq.decode_to_ints(
                torch.cat([A[:, 0], Bt[:, 0], C_b[num_prod:, 0]]))
            ntot = A.shape[0]
            claims_prod_left = finals[:num_prod]
            claims_prod_right = finals[ntot:ntot + num_prod]
            for i in range(num_prod):
                transcript.append_scalar(b"claim_prod_left",
                                         claims_prod_left[i])
                transcript.append_scalar(b"claim_prod_right",
                                         claims_prod_right[i])

            if has_seq:
                dl = finals[num_prod:ntot]
                dr = finals[ntot + num_prod:2 * ntot]
                dw = finals[2 * ntot:]
                for i in range(len(dl)):
                    transcript.append_scalar(b"claim_dotp_left", dl[i])
                    transcript.append_scalar(b"claim_dotp_right", dr[i])
                    transcript.append_scalar(b"claim_dotp_weight", dw[i])
                claims_dotp_final = (dl, dr, dw)

            r_layer = transcript.challenge_scalar(b"challenge_r_layer")
            claims_to_verify = [
                (lv + r_layer * (rv - lv)) % Q
                for lv, rv in zip(claims_prod_left, claims_prod_right)
            ]
            rand = [r_layer] + r_round
            proof_layers.append(LayerProofBatched(
                layer_proof, claims_prod_left, claims_prod_right))

        return (ProductCircuitEvalProofBatched(proof_layers,
                                               claims_dotp_final),
                rand)

    def verify(self, claims_prod_vec: list[int], claims_dotp_vec: list[int],
               n_leaves: int, transcript: Transcript):
        """product_tree.rs:385-486.  Returns (claims_prod, claims_dotp,
        rand)."""
        num_layers = n_leaves.bit_length() - 1
        if len(self.proof) != num_layers:
            raise ProofVerifyError("product proof: wrong layer count")
        rand: list[int] = []
        claims_to_verify = list(claims_prod_vec)
        claims_to_verify_dotp: list[int] = []
        num_prod = len(claims_prod_vec)
        for i in range(num_layers):
            last = i == num_layers - 1
            if last:
                claims_to_verify = claims_to_verify + list(claims_dotp_vec)

            coeffs = transcript.challenge_vector(
                b"rand_coeffs_next_layer", len(claims_to_verify))
            claim = _combine(coeffs, claims_to_verify)
            claim_last, rand_prod = self.proof[i].proof.verify(
                claim, i, 3, transcript)

            claims_prod_left = self.proof[i].claims_prod_left
            claims_prod_right = self.proof[i].claims_prod_right
            if (len(claims_prod_left) != num_prod
                    or len(claims_prod_right) != num_prod):
                raise ProofVerifyError("product proof: claim count")

            for k in range(num_prod):
                transcript.append_scalar(b"claim_prod_left",
                                         claims_prod_left[k])
                transcript.append_scalar(b"claim_prod_right",
                                         claims_prod_right[k])

            if len(rand) != len(rand_prod):
                raise ProofVerifyError("product proof: round count")
            eq = dense.eq_evaluate(rand, rand_prod)
            claim_expected = sum(
                coeffs[k] * (claims_prod_left[k] * claims_prod_right[k] % Q)
                % Q * eq for k in range(num_prod)) % Q

            if last:
                dl, dr, dw = self.claims_dotp
                if not len(dl) == len(dr) == len(dw) == len(claims_dotp_vec):
                    raise ProofVerifyError("product proof: dotp claim count")
                for k in range(len(dl)):
                    transcript.append_scalar(b"claim_dotp_left", dl[k])
                    transcript.append_scalar(b"claim_dotp_right", dr[k])
                    transcript.append_scalar(b"claim_dotp_weight", dw[k])
                    claim_expected = (
                        claim_expected
                        + coeffs[k + num_prod] * dl[k] % Q * dr[k] % Q
                        * dw[k]) % Q

            if claim_expected != claim_last:
                raise ProofVerifyError("product layer claim mismatch")

            r_layer = transcript.challenge_scalar(b"challenge_r_layer")
            claims_to_verify = [
                (lv + r_layer * (rv - lv)) % Q
                for lv, rv in zip(claims_prod_left, claims_prod_right)
            ]
            if last:
                dl, dr, dw = self.claims_dotp
                for k in range(len(claims_dotp_vec) // 2):
                    for vec in (dl, dr, dw):
                        claims_to_verify_dotp.append(
                            (vec[2 * k] + r_layer
                             * (vec[2 * k + 1] - vec[2 * k])) % Q)

            rand = [r_layer] + rand_prod
        return claims_to_verify, claims_to_verify_dotp, rand
