"""Sigma protocols: Knowledge / Equality / Product / DotProduct ZK
arguments (reference src/nizk/mod.rs), host-orchestrated.

These operate on a handful of scalars and points per invocation (the
claim-linking glue between sumcheck phases), so they run on host python
ints; DotProductProofLog over sqrt(n)-size vectors lives in
``dotproduct_log.py``.

Transcript label schedules reproduce the reference byte-for-byte
(including its duplicated "r_delta" label quirk, nizk/mod.rs:446-448).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..commitments import MultiCommitGens, commit_scalar, commit_vector_host
from ..core import ristretto as hri
from ..core.edwards import Point
from ..core.field import Q
from ..core.merlin import RandomTape, Transcript
from ..utils.errors import ProofVerifyError


def _decompress(b: bytes) -> Point:
    pt = hri.decode(b)
    if pt is None:
        raise ProofVerifyError(f"decompression error: {b.hex()}")
    return pt


# ---------------------------------------------------------------------------
# KnowledgeProof (nizk/mod.rs:15-75)
# ---------------------------------------------------------------------------

@dataclass
class KnowledgeProof:
    alpha: bytes
    z1: int
    z2: int

    PROTOCOL = b"knowledge proof"

    @staticmethod
    def prove(gens_1: MultiCommitGens, transcript: Transcript, tape: RandomTape,
              x: int, r: int) -> tuple["KnowledgeProof", bytes]:
        transcript.append_protocol_name(KnowledgeProof.PROTOCOL)
        t1 = tape.random_scalar(b"t1")
        t2 = tape.random_scalar(b"t2")
        C = hri.encode(commit_scalar(x, r, gens_1))
        transcript.append_point(b"C", C)
        alpha = hri.encode(commit_scalar(t1, t2, gens_1))
        transcript.append_point(b"alpha", alpha)
        c = transcript.challenge_scalar(b"c")
        z1 = (x * c + t1) % Q
        z2 = (r * c + t2) % Q
        return KnowledgeProof(alpha, z1, z2), C

    def verify(self, gens_1: MultiCommitGens, transcript: Transcript,
               C: bytes) -> None:
        transcript.append_protocol_name(KnowledgeProof.PROTOCOL)
        transcript.append_point(b"C", C)
        transcript.append_point(b"alpha", self.alpha)
        c = transcript.challenge_scalar(b"c")
        lhs = hri.encode(commit_scalar(self.z1, self.z2, gens_1))
        rhs = hri.encode(_decompress(C).mul(c).add(_decompress(self.alpha)))
        if lhs != rhs:
            raise ProofVerifyError("knowledge proof failed")


# ---------------------------------------------------------------------------
# EqualityProof (nizk/mod.rs:77-144)
# ---------------------------------------------------------------------------

@dataclass
class EqualityProof:
    alpha: bytes
    z: int

    PROTOCOL = b"equality proof"

    @staticmethod
    def prove(gens_1: MultiCommitGens, transcript: Transcript, tape: RandomTape,
              v1: int, s1: int, v2: int, s2: int
              ) -> tuple["EqualityProof", bytes, bytes]:
        transcript.append_protocol_name(EqualityProof.PROTOCOL)
        r = tape.random_scalar(b"r")
        C1 = hri.encode(commit_scalar(v1, s1, gens_1))
        transcript.append_point(b"C1", C1)
        C2 = hri.encode(commit_scalar(v2, s2, gens_1))
        transcript.append_point(b"C2", C2)
        alpha = hri.encode(gens_1.h.mul(r))
        transcript.append_point(b"alpha", alpha)
        c = transcript.challenge_scalar(b"c")
        z = (c * (s1 - s2) + r) % Q
        return EqualityProof(alpha, z), C1, C2

    def verify(self, gens_1: MultiCommitGens, transcript: Transcript,
               C1: bytes, C2: bytes) -> None:
        transcript.append_protocol_name(EqualityProof.PROTOCOL)
        transcript.append_point(b"C1", C1)
        transcript.append_point(b"C2", C2)
        transcript.append_point(b"alpha", self.alpha)
        c = transcript.challenge_scalar(b"c")
        Cdiff = _decompress(C1).add(_decompress(C2).neg())
        rhs = hri.encode(Cdiff.mul(c).add(_decompress(self.alpha)))
        lhs = hri.encode(gens_1.h.mul(self.z))
        if lhs != rhs:
            raise ProofVerifyError("equality proof failed")


# ---------------------------------------------------------------------------
# ProductProof (nizk/mod.rs:146-290)
# ---------------------------------------------------------------------------

@dataclass
class ProductProof:
    alpha: bytes
    beta: bytes
    delta: bytes
    z: tuple

    PROTOCOL = b"product proof"

    @staticmethod
    def prove(gens_1: MultiCommitGens, transcript: Transcript, tape: RandomTape,
              x: int, rX: int, y: int, rY: int, z: int, rZ: int
              ) -> tuple["ProductProof", bytes, bytes, bytes]:
        transcript.append_protocol_name(ProductProof.PROTOCOL)
        b1 = tape.random_scalar(b"b1")
        b2 = tape.random_scalar(b"b2")
        b3 = tape.random_scalar(b"b3")
        b4 = tape.random_scalar(b"b4")
        b5 = tape.random_scalar(b"b5")

        X = hri.encode(commit_scalar(x, rX, gens_1))
        transcript.append_point(b"X", X)
        Y = hri.encode(commit_scalar(y, rY, gens_1))
        transcript.append_point(b"Y", Y)
        Zc = hri.encode(commit_scalar(z, rZ, gens_1))
        transcript.append_point(b"Z", Zc)
        alpha = hri.encode(commit_scalar(b1, b2, gens_1))
        transcript.append_point(b"alpha", alpha)
        beta = hri.encode(commit_scalar(b3, b4, gens_1))
        transcript.append_point(b"beta", beta)
        # delta commits b3 under base X (nizk/mod.rs:198-206)
        Xpt = _decompress(X)
        delta = hri.encode(Xpt.mul(b3).add(gens_1.h.mul(b5)))
        transcript.append_point(b"delta", delta)
        c = transcript.challenge_scalar(b"c")
        zs = (
            (b1 + c * x) % Q,
            (b2 + c * rX) % Q,
            (b3 + c * y) % Q,
            (b4 + c * rY) % Q,
            (b5 + c * (rZ - rX * y)) % Q,
        )
        return ProductProof(alpha, beta, delta, zs), X, Y, Zc

    @staticmethod
    def _check(P: bytes, X: bytes, c: int, gens_1: MultiCommitGens,
               z1: int, z2: int, base_override: Point | None = None) -> bool:
        lhs = hri.encode(_decompress(P).add(_decompress(X).mul(c)))
        base = base_override if base_override is not None else gens_1.G[0]
        rhs = hri.encode(base.mul(z1 % Q).add(gens_1.h.mul(z2 % Q)))
        return lhs == rhs

    def verify(self, gens_1: MultiCommitGens, transcript: Transcript,
               X: bytes, Y: bytes, Z: bytes) -> None:
        transcript.append_protocol_name(ProductProof.PROTOCOL)
        transcript.append_point(b"X", X)
        transcript.append_point(b"Y", Y)
        transcript.append_point(b"Z", Z)
        transcript.append_point(b"alpha", self.alpha)
        transcript.append_point(b"beta", self.beta)
        transcript.append_point(b"delta", self.delta)
        z1, z2, z3, z4, z5 = self.z
        c = transcript.challenge_scalar(b"c")
        ok = (
            ProductProof._check(self.alpha, X, c, gens_1, z1, z2)
            and ProductProof._check(self.beta, Y, c, gens_1, z3, z4)
            and ProductProof._check(
                self.delta, Z, c, gens_1, z3, z5, base_override=_decompress(X)
            )
        )
        if not ok:
            raise ProofVerifyError("product proof failed")


# ---------------------------------------------------------------------------
# DotProductProof, linear-size (nizk/mod.rs:292-405)
# ---------------------------------------------------------------------------

@dataclass
class DotProductProof:
    delta: bytes
    beta: bytes
    z: list
    z_delta: int
    z_beta: int

    PROTOCOL = b"dot product proof"

    @staticmethod
    def compute_dotproduct(a, b) -> int:
        assert len(a) == len(b)
        return sum(x * y for x, y in zip(a, b)) % Q

    @staticmethod
    def prove(gens_1: MultiCommitGens, gens_n: MultiCommitGens,
              transcript: Transcript, tape: RandomTape,
              x_vec: list, blind_x: int, a_vec: list, y: int, blind_y: int
              ) -> tuple["DotProductProof", bytes, bytes]:
        transcript.append_protocol_name(DotProductProof.PROTOCOL)
        n = len(x_vec)
        assert len(a_vec) == n and gens_n.n == n and gens_1.n == 1

        d_vec = tape.random_vector(b"d_vec", n)
        r_delta = tape.random_scalar(b"r_delta")
        r_beta = tape.random_scalar(b"r_beta")

        Cx = hri.encode(commit_vector_host(x_vec, blind_x, gens_n))
        transcript.append_point(b"Cx", Cx)
        Cy = hri.encode(commit_scalar(y, blind_y, gens_1))
        transcript.append_point(b"Cy", Cy)
        transcript.append_scalar_vector(b"a", a_vec)

        delta = hri.encode(commit_vector_host(d_vec, r_delta, gens_n))
        transcript.append_point(b"delta", delta)
        dotp_a_d = DotProductProof.compute_dotproduct(a_vec, d_vec)
        beta = hri.encode(commit_scalar(dotp_a_d, r_beta, gens_1))
        transcript.append_point(b"beta", beta)

        c = transcript.challenge_scalar(b"c")
        z = [(c * x + d) % Q for x, d in zip(x_vec, d_vec)]
        z_delta = (c * blind_x + r_delta) % Q
        z_beta = (c * blind_y + r_beta) % Q
        return DotProductProof(delta, beta, z, z_delta, z_beta), Cx, Cy

    def verify(self, gens_1: MultiCommitGens, gens_n: MultiCommitGens,
               transcript: Transcript, a: list, Cx: bytes, Cy: bytes) -> None:
        if gens_n.n != len(a) or gens_1.n != 1:
            raise ProofVerifyError("dot product proof: dimension mismatch")
        transcript.append_protocol_name(DotProductProof.PROTOCOL)
        transcript.append_point(b"Cx", Cx)
        transcript.append_point(b"Cy", Cy)
        transcript.append_scalar_vector(b"a", a)
        transcript.append_point(b"delta", self.delta)
        transcript.append_point(b"beta", self.beta)
        c = transcript.challenge_scalar(b"c")

        lhs1 = _decompress(Cx).mul(c).add(_decompress(self.delta))
        rhs1 = commit_vector_host(self.z, self.z_delta, gens_n)
        ok = hri.encode(lhs1) == hri.encode(rhs1)
        dotp_z_a = DotProductProof.compute_dotproduct(self.z, a)
        lhs2 = _decompress(Cy).mul(c).add(_decompress(self.beta))
        rhs2 = commit_scalar(dotp_z_a, self.z_beta, gens_1)
        ok = ok and hri.encode(lhs2) == hri.encode(rhs2)
        if not ok:
            raise ProofVerifyError("dot product proof failed")


class DotProductProofGens:
    """nizk/mod.rs:408-419: one derivation of n+1 gens, split n/1."""

    def __init__(self, n: int, label: bytes):
        self.n = n
        base = MultiCommitGens(n + 1, label)
        self.gens_n, self.gens_1 = base.split_at(n)
