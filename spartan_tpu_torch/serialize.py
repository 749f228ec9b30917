"""Binary (de)serialization of the NIZK proof — the analogue of the
reference's serde+bincode derive on its proof types (reference
src/lib.rs:45-57,489), byte-compatible with the JAX package's
``serialize.py``.

Wire format (bincode fixint, little-endian):
  u64         8 bytes LE
  scalar      32 bytes LE **Montgomery form** (v*R mod q, R = 2^256) —
              matching the reference's bincode derive on
              Scalar([u64;4]), which serializes the raw Montgomery
              limbs (ristretto255.rs:195-199, lib.rs:380).  Unlike the
              Rust derive (which accepts any [u64;4]), the Reader
              rejects non-canonical (>= q) Montgomery residues.
  point       32 bytes compressed ristretto
  list<T>     u64 count + items
  struct      fields in declaration order

The SNARK codecs belong to the SNARK slice of the port.
"""

from __future__ import annotations

import io

from .core.field import Q
from .poly.commit import PolyCommitment, PolyEvalProof
from .protocols.bullet import BulletReductionProof
from .protocols.dotproduct_log import DotProductProofLog
from .protocols.sigma import (
    DotProductProof,
    EqualityProof,
    KnowledgeProof,
    ProductProof,
)
from .protocols.sumcheck import ZKSumcheckInstanceProof
from .r1cs.proof import R1CSProof
from .utils.errors import ProofDeserializeError

_R_INV = pow(1 << 256, -1, Q)  # R^-1 for Montgomery wire decoding


class Writer:
    def __init__(self):
        self.buf = io.BytesIO()

    def u64(self, x: int):
        self.buf.write(int(x).to_bytes(8, "little"))

    def scalar(self, x: int):
        # Montgomery-limb encoding: (x * 2^256) mod q, 32 bytes LE —
        # byte-compatible with the reference's bincode derive
        self.buf.write(((int(x) << 256) % Q).to_bytes(32, "little"))

    def point(self, b: bytes):
        assert len(b) == 32, len(b)
        self.buf.write(b)

    def scalars(self, xs):
        self.u64(len(xs))
        for x in xs:
            self.scalar(x)

    def points(self, bs):
        self.u64(len(bs))
        for b in bs:
            self.point(b)

    def getvalue(self) -> bytes:
        return self.buf.getvalue()


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ProofDeserializeError("truncated proof bytes")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def scalar(self) -> int:
        mont = int.from_bytes(self.take(32), "little")
        if mont >= Q:
            raise ProofDeserializeError("non-canonical scalar in proof bytes")
        return mont * _R_INV % Q

    def point(self) -> bytes:
        return self.take(32)

    def scalars(self) -> list[int]:
        return [self.scalar() for _ in range(self.u64())]

    def points(self) -> list[bytes]:
        return [self.point() for _ in range(self.u64())]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise ProofDeserializeError(
                f"trailing bytes: {len(self.data) - self.pos}")


# ---------------------------------------------------------------------------
# leaf proof codecs
# ---------------------------------------------------------------------------

def _w_knowledge(w: Writer, p: KnowledgeProof):
    w.point(p.alpha); w.scalar(p.z1); w.scalar(p.z2)


def _r_knowledge(r: Reader) -> KnowledgeProof:
    return KnowledgeProof(r.point(), r.scalar(), r.scalar())


def _w_equality(w: Writer, p: EqualityProof):
    w.point(p.alpha); w.scalar(p.z)


def _r_equality(r: Reader) -> EqualityProof:
    return EqualityProof(r.point(), r.scalar())


def _w_product(w: Writer, p: ProductProof):
    w.point(p.alpha); w.point(p.beta); w.point(p.delta)
    for z in p.z:
        w.scalar(z)


def _r_product(r: Reader) -> ProductProof:
    alpha, beta, delta = r.point(), r.point(), r.point()
    return ProductProof(alpha, beta, delta,
                        tuple(r.scalar() for _ in range(5)))


def _w_dotproduct(w: Writer, p: DotProductProof):
    w.point(p.delta); w.point(p.beta)
    w.scalars(p.z); w.scalar(p.z_delta); w.scalar(p.z_beta)


def _r_dotproduct(r: Reader) -> DotProductProof:
    delta, beta = r.point(), r.point()
    return DotProductProof(delta, beta, r.scalars(), r.scalar(), r.scalar())


def _w_bullet(w: Writer, p: BulletReductionProof):
    w.points(p.L_vec); w.points(p.R_vec)


def _r_bullet(r: Reader) -> BulletReductionProof:
    return BulletReductionProof(r.points(), r.points())


def _w_dotproduct_log(w: Writer, p: DotProductProofLog):
    _w_bullet(w, p.bullet_reduction_proof)
    w.point(p.delta); w.point(p.beta)
    w.scalar(p.z1); w.scalar(p.z2)


def _r_dotproduct_log(r: Reader) -> DotProductProofLog:
    bullet = _r_bullet(r)
    delta, beta = r.point(), r.point()
    return DotProductProofLog(bullet, delta, beta, r.scalar(), r.scalar())


def _w_polyeval(w: Writer, p: PolyEvalProof):
    _w_dotproduct_log(w, p.proof)


def _r_polyeval(r: Reader) -> PolyEvalProof:
    return PolyEvalProof(_r_dotproduct_log(r))


def _w_polycommitment(w: Writer, c: PolyCommitment):
    w.points(c.C)


def _r_polycommitment(r: Reader) -> PolyCommitment:
    return PolyCommitment(r.points())


def _w_zk_sumcheck(w: Writer, p: ZKSumcheckInstanceProof):
    w.points(p.comm_polys)
    w.points(p.comm_evals)
    w.u64(len(p.proofs))
    for pr in p.proofs:
        _w_dotproduct(w, pr)


def _r_zk_sumcheck(r: Reader) -> ZKSumcheckInstanceProof:
    comm_polys = r.points()
    comm_evals = r.points()
    proofs = [_r_dotproduct(r) for _ in range(r.u64())]
    return ZKSumcheckInstanceProof(comm_polys, comm_evals, proofs)


# ---------------------------------------------------------------------------
# R1CS satisfiability proof
# ---------------------------------------------------------------------------

def _w_r1cs_proof(w: Writer, p: R1CSProof):
    _w_polycommitment(w, p.comm_vars)
    _w_zk_sumcheck(w, p.sc_proof_phase1)
    for pt in p.claims_phase2:
        w.point(pt)
    _w_knowledge(w, p.pok_claims_phase2[0])
    _w_product(w, p.pok_claims_phase2[1])
    _w_equality(w, p.proof_eq_sc_phase1)
    _w_zk_sumcheck(w, p.sc_proof_phase2)
    w.point(p.comm_vars_at_ry)
    _w_polyeval(w, p.proof_eval_vars_at_ry)
    _w_equality(w, p.proof_eq_sc_phase2)


def _r_r1cs_proof(r: Reader) -> R1CSProof:
    comm_vars = _r_polycommitment(r)
    sc1 = _r_zk_sumcheck(r)
    claims = tuple(r.point() for _ in range(4))
    pok = (_r_knowledge(r), _r_product(r))
    eq1 = _r_equality(r)
    sc2 = _r_zk_sumcheck(r)
    comm_vars_at_ry = r.point()
    pe = _r_polyeval(r)
    eq2 = _r_equality(r)
    return R1CSProof(comm_vars, sc1, claims, pok, eq1, sc2,
                     comm_vars_at_ry, pe, eq2)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def nizk_to_bytes(nizk) -> bytes:
    w = Writer()
    _w_r1cs_proof(w, nizk.r1cs_sat_proof)
    rx, ry = nizk.r
    w.scalars(rx)
    w.scalars(ry)
    return w.getvalue()


def nizk_from_bytes(data: bytes):
    from .api import NIZK

    r = Reader(data)
    proof = _r_r1cs_proof(r)
    rx = r.scalars()
    ry = r.scalars()
    r.done()
    return NIZK(proof, (rx, ry))
