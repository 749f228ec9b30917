"""Readers of the proof and commitment bytes (bincode, fixint, little
endian): u64 as 8 bytes, a scalar as its 32-byte Montgomery residue
(``v 2^256 mod q``, canonical), a point as its 32-byte ristretto
encoding, a list as a u64 count and its items, a struct as its fields in
order.  Points stay as bytes; the verifier decodes them."""

from __future__ import annotations

from types import SimpleNamespace as NS

from .field import Q, R_INV


class WireError(ValueError):
    pass


class Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise WireError("truncated")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def count(self) -> int:
        n = self.u64()
        if n > len(self.data):
            raise WireError("list longer than the bytes")
        return n

    def scalar(self) -> int:
        m = int.from_bytes(self.take(32), "little")
        if m >= Q:
            raise WireError("non-canonical scalar")
        return m * R_INV % Q

    def point(self) -> bytes:
        return self.take(32)

    def scalars(self) -> list[int]:
        return [self.scalar() for _ in range(self.count())]

    def points(self) -> list[bytes]:
        return [self.point() for _ in range(self.count())]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise WireError("trailing bytes")


def _dot(r: Reader):
    return NS(delta=r.point(), beta=r.point(), z=r.scalars(),
              z_delta=r.scalar(), z_beta=r.scalar())


def _dot_log(r: Reader):
    return NS(L=r.points(), R=r.points(), delta=r.point(), beta=r.point(),
              z1=r.scalar(), z2=r.scalar())


def _zk_sumcheck(r: Reader):
    comm_polys, comm_evals = r.points(), r.points()
    proofs = [_dot(r) for _ in range(r.count())]
    return NS(comm_polys=comm_polys, comm_evals=comm_evals, proofs=proofs)


def _r1cs_proof(r: Reader):
    comm_vars = r.points()
    sc1 = _zk_sumcheck(r)
    claims = [r.point() for _ in range(4)]
    knowledge = NS(alpha=r.point(), z1=r.scalar(), z2=r.scalar())
    product = NS(alpha=r.point(), beta=r.point(), delta=r.point(),
                 z=[r.scalar() for _ in range(5)])
    eq1 = NS(alpha=r.point(), z=r.scalar())
    sc2 = _zk_sumcheck(r)
    comm_vars_at_ry = r.point()
    eval_proof = _dot_log(r)
    eq2 = NS(alpha=r.point(), z=r.scalar())
    return NS(comm_vars=comm_vars, sc1=sc1, claims=claims,
              knowledge=knowledge, product=product, eq1=eq1, sc2=sc2,
              comm_vars_at_ry=comm_vars_at_ry, eval_proof=eval_proof,
              eq2=eq2)


def _prod_circuit(r: Reader):
    layers = []
    for _ in range(r.count()):
        polys = [r.scalars() for _ in range(r.count())]
        layers.append(NS(polys=polys, left=r.scalars(), right=r.scalars()))
    return NS(layers=layers, dotp=(r.scalars(), r.scalars(), r.scalars()))


def _spark_proof(r: Reader):
    comm_derefs = r.points()
    fours = []
    for _ in range(2):
        fours.append((r.scalar(), r.scalars(), r.scalars(), r.scalar()))
    dotp_left, dotp_right = r.scalars(), r.scalars()
    proof_mem = _prod_circuit(r)
    proof_ops = _prod_circuit(r)
    threes = [(r.scalars(), r.scalars(), r.scalar()) for _ in range(2)]
    eval_val = r.scalars()
    derefs = (r.scalars(), r.scalars())
    return NS(comm_derefs=comm_derefs, eval_row=fours[0], eval_col=fours[1],
              dotp_left=dotp_left, dotp_right=dotp_right,
              proof_mem=proof_mem, proof_ops=proof_ops,
              hash_row=threes[0], hash_col=threes[1], eval_val=eval_val,
              eval_derefs=derefs, pe_ops=_dot_log(r), pe_mem=_dot_log(r),
              pe_derefs=_dot_log(r))


def read_nizk(data: bytes):
    r = Reader(data)
    proof = _r1cs_proof(r)
    rx, ry = r.scalars(), r.scalars()
    r.end()
    return NS(sat=proof, rx=rx, ry=ry)


def read_snark(data: bytes):
    r = Reader(data)
    proof = _r1cs_proof(r)
    evals = [r.scalar() for _ in range(3)]
    spark = _spark_proof(r)
    r.end()
    return NS(sat=proof, evals=evals, spark=spark)


def read_commitment(data: bytes):
    r = Reader(data)
    out = NS(num_cons=r.u64(), num_vars=r.u64(), num_inputs=r.u64(),
             batch_size=r.u64(), num_ops=r.u64(), num_mem_cells=r.u64(),
             comb_ops=r.points(), comb_mem=r.points())
    r.end()
    return out
