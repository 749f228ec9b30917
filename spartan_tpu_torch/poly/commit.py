"""Polynomial commitment (sqrt-matrix Pedersen) and evaluation proof
(reference dense_mlpoly.rs:24-404).

The 2^ell table is viewed as an L x R matrix (L = 2^(ell/2) rows); each
row gets one Pedersen commitment under a shared generator vector: one
row-MSM (kernel B1) over all rows (under a device mesh, a launch a
device on its block of rows, ``parallel/mesh.py``), a second one with
R = 1 for the blinds times h, one batched point addition and one
batched ristretto compression.  The evaluation proof reduces Z(r) = v
to a log-size dot-product proof on the R-side vector.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..commitments import commit_scalar
from ..core import ristretto as hri
from ..core.field import Q
from ..core.merlin import RandomTape, Transcript
from ..curve import edwards as ded
from ..curve import msm as dmsm
from ..curve import ristretto as dri
from ..curve.row_msm import row_msm
from ..ff import fq, limb
from ..parallel import context as pctx
from ..parallel.mesh import msm_rows_blocked
from ..protocols.dotproduct_log import DotProductProofLog
from ..protocols.sigma import DotProductProofGens
from ..utils.errors import ProofVerifyError
from ..utils.timer import Timer
from . import dense


class PolyCommitmentGens:
    """dense_mlpoly.rs:24-37: gens sized to the R side (2^(ell - ell/2))."""

    def __init__(self, num_vars: int, label: bytes):
        _, right = dense.factored_lens(num_vars)
        self.gens = DotProductProofGens(1 << right, label)


@dataclass
class PolyCommitment:
    C: list  # list of 32-byte compressed row commitments

    def append_to_transcript(self, label: bytes, transcript: Transcript) -> None:
        transcript.append_message(label, b"poly_commitment_begin")
        for c in self.C:
            transcript.append_point(b"poly_commitment_share", c)
        transcript.append_message(label, b"poly_commitment_end")


def commit(Z: torch.Tensor, gens: PolyCommitmentGens,
           tape: RandomTape | None) -> tuple[PolyCommitment, list[int]]:
    """DensePolynomial::commit (dense_mlpoly.rs:164-204).  Z: (n, 8)
    Montgomery table, n = 2^ell.  Returns (commitment, blinds)."""
    return commit_canonical(fq.from_mont(Z), gens, tape)


def commit_canonical(S: torch.Tensor, gens: PolyCommitmentGens,
                     tape: RandomTape | None
                     ) -> tuple[PolyCommitment, list[int]]:
    """``commit`` of the table whose canonical scalars are S ((n, 8),
    n = 2^ell, B1's input as it is): the row-MSM, blinds times h and the
    compression."""
    n = S.shape[0]
    ell = n.bit_length() - 1
    assert 1 << ell == n
    left, right = dense.factored_lens(ell)
    L_size, R_size = 1 << left, 1 << right
    if tape is not None:
        blinds = tape.random_vector(b"poly_blinds", L_size)
    else:
        blinds = [0] * L_size
    g = gens.gens.gens_n

    t = Timer("commit::msm_rows")
    scalars = S.reshape(L_size, R_size, limb.NWORDS)
    rows = msm_rows_blocked(scalars, g, pctx.get_mesh())  # (L_size,)
    t.stop()
    t = Timer("commit::blinds")
    # blinds * h: the same row-MSM kernel with R = 1 and generator h
    blind_limbs = limb.ints_to_limbs(blinds, S.device)
    bh = ded.unstack(row_msm(blind_limbs[:, None, :], g.msm_table_h(S.device)))
    rows = ded.add(rows, bh)
    t.stop()
    t = Timer("commit::compress")
    blobs = dri.compress_to_bytes(rows)
    t.stop()
    return PolyCommitment(blobs), blinds


@dataclass
class PolyEvalProof:
    """dense_mlpoly.rs:302-404."""

    proof: DotProductProofLog

    PROTOCOL = b"polynomial evaluation proof"

    @staticmethod
    def prove(Z: torch.Tensor, blinds: list[int] | None, r: list[int],
              Zr: int, blind_Zr: int | None, gens: PolyCommitmentGens,
              transcript: Transcript, tape: RandomTape
              ) -> tuple["PolyEvalProof", bytes]:
        transcript.append_protocol_name(PolyEvalProof.PROTOCOL)
        ell = len(r)
        assert Z.shape[0] == 1 << ell
        left, _ = dense.factored_lens(ell)
        L_size = 1 << left
        blinds = blinds if blinds is not None else [0] * L_size
        blind_Zr = blind_Zr if blind_Zr is not None else 0
        assert len(blinds) == L_size

        # L and R chi tables (host ints, sqrt-size each)
        L_ints = _eq_evals_host(r[:left])
        R_ints = _eq_evals_host(r[left:])

        t = Timer("polyeval::bound_L")
        L_dev = dense.from_ints(L_ints, Z.device)
        LZ = dense.bound_L(Z, L_dev)  # (R_size, 8)
        t.stop()
        LZ_blind = sum(b * l for b, l in zip(blinds, L_ints)) % Q

        t = Timer("polyeval::dotproduct_log")
        R_dev = dense.from_ints(R_ints, Z.device)
        proof, _Cx, C_Zr_prime = DotProductProofLog.prove(
            gens.gens, transcript, tape, LZ, LZ_blind,
            R_dev, R_ints, Zr, blind_Zr)
        t.stop()
        return PolyEvalProof(proof), C_Zr_prime

    def verify(self, gens: PolyCommitmentGens, transcript: Transcript,
               r: list[int], C_Zr: bytes, comm: PolyCommitment,
               device=None) -> None:
        transcript.append_protocol_name(PolyEvalProof.PROTOCOL)
        ell = len(r)
        left, _ = dense.factored_lens(ell)
        L_ints = _eq_evals_host(r[:left])
        R_ints = _eq_evals_host(r[left:])
        C_pts = []
        for blob in comm.C:
            pt = hri.decode(blob)
            if pt is None:
                raise ProofVerifyError("poly commitment decompression")
            C_pts.append(pt)
        C_LZ = hri.encode(dmsm.vmsm(L_ints, C_pts, device))
        self.proof.verify(len(R_ints), gens.gens, transcript, R_ints,
                          C_LZ, C_Zr, device)

    def verify_plain(self, gens: PolyCommitmentGens, transcript: Transcript,
                     r: list[int], Zr: int, comm: PolyCommitment,
                     device=None) -> None:
        """verify against a claimed value in the clear (blind 0)."""
        C_Zr = hri.encode(commit_scalar(Zr, 0, gens.gens.gens_1))
        self.verify(gens, transcript, r, C_Zr, comm, device)


def _eq_evals_host(r: list[int]) -> list[int]:
    """EqPolynomial::evals on host ints (sqrt-size tables only)."""
    evals = [1]
    for rj in r:
        nxt = []
        for e in evals:
            hi = e * rj % Q
            nxt.append((e - hi) % Q)
            nxt.append(hi)
        evals = nxt
    return evals
