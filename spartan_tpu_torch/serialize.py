"""Binary (de)serialization of the NIZK and SNARK proofs and of the SNARK's
computation commitment — the analogue of the
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
"""

from __future__ import annotations

import io
import zlib

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
from .protocols.product_tree import (LayerProofBatched,
                                     ProductCircuitEvalProofBatched)
from .protocols.spark import (DerefsCommitment, DerefsEvalProof,
                              HashLayerProof, PolyEvalNetworkProof,
                              ProductLayerProof, SparseMatPolyCommitment,
                              SparseMatPolyEvalProof)
from .protocols.sumcheck import SumcheckInstanceProof, ZKSumcheckInstanceProof
from .r1cs.commit import R1CSCommitment, R1CSEvalProof
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


def _w_sumcheck(w: Writer, p: SumcheckInstanceProof):
    w.u64(len(p.compressed_polys))
    for coeffs in p.compressed_polys:
        w.scalars(coeffs)


def _r_sumcheck(r: Reader) -> SumcheckInstanceProof:
    return SumcheckInstanceProof([r.scalars() for _ in range(r.u64())])


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
# Spark / SNARK eval proof
# ---------------------------------------------------------------------------

def _w_layer_proof(w: Writer, p: LayerProofBatched):
    _w_sumcheck(w, p.proof)
    w.scalars(p.claims_prod_left)
    w.scalars(p.claims_prod_right)


def _r_layer_proof(r: Reader) -> LayerProofBatched:
    return LayerProofBatched(_r_sumcheck(r), r.scalars(), r.scalars())


def _w_prod_circuit_proof(w: Writer, p: ProductCircuitEvalProofBatched):
    w.u64(len(p.proof))
    for lp in p.proof:
        _w_layer_proof(w, lp)
    dl, dr, dw = ((list(x) for x in p.claims_dotp) if p.claims_dotp
                  else ([], [], []))
    w.scalars(dl); w.scalars(dr); w.scalars(dw)


def _r_prod_circuit_proof(r: Reader) -> ProductCircuitEvalProofBatched:
    layers = [_r_layer_proof(r) for _ in range(r.u64())]
    dl, dr, dw = r.scalars(), r.scalars(), r.scalars()
    return ProductCircuitEvalProofBatched(layers, (dl, dr, dw))


def _w_product_layer_proof(w: Writer, p: ProductLayerProof):
    for four in (p.eval_row, p.eval_col):
        init, read, write, audit = four
        w.scalar(init); w.scalars(read); w.scalars(write); w.scalar(audit)
    left, right = p.eval_val
    w.scalars(left); w.scalars(right)
    _w_prod_circuit_proof(w, p.proof_mem)
    _w_prod_circuit_proof(w, p.proof_ops)


def _r_product_layer_proof(r: Reader) -> ProductLayerProof:
    fours = []
    for _ in range(2):
        init = r.scalar(); read = r.scalars()
        write = r.scalars(); audit = r.scalar()
        fours.append((init, read, write, audit))
    eval_val = (r.scalars(), r.scalars())
    proof_mem = _r_prod_circuit_proof(r)
    proof_ops = _r_prod_circuit_proof(r)
    return ProductLayerProof(fours[0], fours[1], eval_val, proof_mem,
                             proof_ops)


def _w_hash_layer_proof(w: Writer, p: HashLayerProof):
    for three in (p.eval_row, p.eval_col):
        addr, read_ts, audit_ts = three
        w.scalars(addr); w.scalars(read_ts); w.scalar(audit_ts)
    w.scalars(p.eval_val)
    row_ops, col_ops = p.eval_derefs
    w.scalars(row_ops); w.scalars(col_ops)
    _w_polyeval(w, p.proof_ops)
    _w_polyeval(w, p.proof_mem)
    _w_polyeval(w, p.proof_derefs.proof_derefs)


def _r_hash_layer_proof(r: Reader) -> HashLayerProof:
    threes = [(r.scalars(), r.scalars(), r.scalar()) for _ in range(2)]
    eval_val = r.scalars()
    eval_derefs = (r.scalars(), r.scalars())
    proof_ops = _r_polyeval(r)
    proof_mem = _r_polyeval(r)
    proof_derefs = DerefsEvalProof(_r_polyeval(r))
    return HashLayerProof(threes[0], threes[1], eval_val, eval_derefs,
                          proof_ops, proof_mem, proof_derefs)


def _w_sparse_eval_proof(w: Writer, p: SparseMatPolyEvalProof):
    _w_polycommitment(w, p.comm_derefs.comm_ops_val)
    _w_product_layer_proof(w, p.poly_eval_network_proof.proof_prod_layer)
    _w_hash_layer_proof(w, p.poly_eval_network_proof.proof_hash_layer)


def _r_sparse_eval_proof(r: Reader) -> SparseMatPolyEvalProof:
    comm_derefs = DerefsCommitment(_r_polycommitment(r))
    prod = _r_product_layer_proof(r)
    hashp = _r_hash_layer_proof(r)
    return SparseMatPolyEvalProof(
        comm_derefs, PolyEvalNetworkProof(prod, hashp))


# ---------------------------------------------------------------------------
# the SNARK's computation commitment (shipped to verifiers)
# ---------------------------------------------------------------------------

def _w_r1cs_commitment(w: Writer, c: R1CSCommitment):
    w.u64(c.num_cons); w.u64(c.num_vars); w.u64(c.num_inputs)
    w.u64(c.comm.batch_size); w.u64(c.comm.num_ops)
    w.u64(c.comm.num_mem_cells)
    _w_polycommitment(w, c.comm.comm_comb_ops)
    _w_polycommitment(w, c.comm.comm_comb_mem)


def _r_r1cs_commitment(r: Reader) -> R1CSCommitment:
    num_cons, num_vars, num_inputs = r.u64(), r.u64(), r.u64()
    batch_size, num_ops, num_mem_cells = r.u64(), r.u64(), r.u64()
    comm = SparseMatPolyCommitment(
        batch_size, num_ops, num_mem_cells,
        _r_polycommitment(r), _r_polycommitment(r))
    return R1CSCommitment(num_cons, num_vars, num_inputs, comm)


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


def snark_to_bytes(snark) -> bytes:
    w = Writer()
    _w_r1cs_proof(w, snark.r1cs_sat_proof)
    for e in snark.inst_evals:
        w.scalar(e)
    _w_sparse_eval_proof(w, snark.r1cs_eval_proof.proof)
    return w.getvalue()


def snark_from_bytes(data: bytes):
    from .api import SNARK

    r = Reader(data)
    proof = _r_r1cs_proof(r)
    inst_evals = tuple(r.scalar() for _ in range(3))
    evalp = R1CSEvalProof(_r_sparse_eval_proof(r))
    r.done()
    return SNARK(proof, inst_evals, evalp)


def commitment_to_bytes(comm) -> bytes:
    """ComputationCommitment -> bytes (lib.rs:278-303)."""
    w = Writer()
    _w_r1cs_commitment(w, comm.comm)
    return w.getvalue()


def commitment_from_bytes(data: bytes):
    from .api import ComputationCommitment

    r = Reader(data)
    c = _r_r1cs_commitment(r)
    r.done()
    return ComputationCommitment(c)


# ---------------------------------------------------------------------------
# proof-size reports
# ---------------------------------------------------------------------------

def _sz(fn, *args) -> int:
    w = Writer()
    fn(w, *args)
    return len(w.getvalue())


def r1cs_sat_size_report(p) -> dict:
    """Per-field wire sizes of an R1CSProof, field names matching
    r1csproof.rs:21-37 — the raw material for byte-level proof-size
    audits against the reference's reported len_r1cs_sat_proof."""
    return {
        "comm_vars": _sz(_w_polycommitment, p.comm_vars),
        "sc_proof_phase1": _sz(_w_zk_sumcheck, p.sc_proof_phase1),
        "claims_phase2": 4 * 32,
        "pok_claims_phase2": (_sz(_w_knowledge, p.pok_claims_phase2[0])
                              + _sz(_w_product, p.pok_claims_phase2[1])),
        "proof_eq_sc_phase1": _sz(_w_equality, p.proof_eq_sc_phase1),
        "sc_proof_phase2": _sz(_w_zk_sumcheck, p.sc_proof_phase2),
        "comm_vars_at_ry": 32,
        "proof_eval_vars_at_ry": _sz(_w_polyeval, p.proof_eval_vars_at_ry),
        "proof_eq_sc_phase2": _sz(_w_equality, p.proof_eq_sc_phase2),
    }


def nizk_size_report(nizk) -> dict:
    """Field-by-field wire sizes of a NIZK blob (sums to
    len(nizk_to_bytes(nizk)))."""
    rx, ry = nizk.r
    rep = dict(r1cs_sat_size_report(nizk.r1cs_sat_proof))
    rep["r (rx, ry)"] = 2 * 8 + 32 * (len(rx) + len(ry))
    return rep


def snark_size_report(snark) -> dict:
    """Field-by-field wire sizes of a SNARK blob (sums to
    len(snark_to_bytes(snark))); eval-proof subfields follow
    sparse_mlpoly.rs struct names."""
    ep = snark.r1cs_eval_proof.proof
    return {
        "r1cs_sat_proof": sum(
            r1cs_sat_size_report(snark.r1cs_sat_proof).values()),
        "inst_evals": 3 * 32,
        "eval::comm_derefs": _sz(
            _w_polycommitment, ep.comm_derefs.comm_ops_val),
        "eval::proof_prod_layer": _sz(
            _w_product_layer_proof,
            ep.poly_eval_network_proof.proof_prod_layer),
        "eval::proof_hash_layer": _sz(
            _w_hash_layer_proof,
            ep.poly_eval_network_proof.proof_hash_layer),
    }


def compressed_size(data: bytes) -> int:
    """zlib-compressed byte length, mirroring the reference's reported
    proof sizes (profiler/snark.rs:48-50)."""
    return len(zlib.compress(data, 9))
