"""Spark sparse multilinear polynomial commitment (reference
src/sparse_mlpoly.rs; the JAX package's ``protocols/spark.py``): offline
memory checking and grand products.

* AddrTimestamps' sequential counter scan (sparse_mlpoly.rs:220-254) is
  an occurrence rank computed by one stable argsort in host numpy.
* Addresses, timestamps and the identity are small integers: they go to
  the device as one word each and become Montgomery tables there with
  one ``to_mont``.
* The dense representation's combined tables are committed through the
  row-MSM (kernel B1); hash leaves, deref gathers and evaluations are
  torch operations over ``(B, N, 8)`` tables, in pieces where a whole
  table's limb products would be large.
* The 12 ops product circuits and 4 mem circuits are two instance-batched
  ``ProductCircuitBatch`` trees whose layer rounds are kernel B2's
  batched mode (``protocols/product_tree.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.field import Q
from ..core.merlin import RandomTape, Transcript
from ..ff import fq, limb
from ..poly import dense
from ..poly.commit import (PolyCommitment, PolyCommitmentGens,
                           PolyEvalProof, commit)
from ..utils.errors import ProofVerifyError
from ..utils.timer import Timer
from .product_tree import (
    DotProductCircuitBatch,
    ProductCircuitBatch,
    ProductCircuitEvalProofBatched,
)

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def _log2(n: int) -> int:
    assert n > 0
    return (n - 1).bit_length() if n > 1 else 0


def _fold_bot_host(vals: list[int], challenges: list[int]) -> int:
    """bound_poly_var_bot applied for each challenge in reverse order on a
    short host vector (the n-to-1 evaluation reductions)."""
    cur = [v % Q for v in vals]
    for r in reversed(challenges):
        cur = [(cur[2 * k] + r * (cur[2 * k + 1] - cur[2 * k])) % Q
               for k in range(len(cur) // 2)]
    assert len(cur) == 1
    return cur[0]


def _evaluate_batched(groups: list[torch.Tensor], r: list[int]) -> list[int]:
    """Each group's (b, n, 8) polynomials evaluated at the point r, all
    fetched at once."""
    chis = dense.eq_evals(r, groups[0].device)
    outs = [fq.dot_mod(P, chis, dim=1) for P in groups]
    return fq.decode_to_ints(torch.cat(outs))


def _usize_table(values: torch.Tensor) -> torch.Tensor:
    """Nonnegative integers below 2^31 (an int64 tensor) -> their
    Montgomery table (..., 8) on the same device."""
    words = values.new_zeros((*values.shape, limb.NWORDS), dtype=torch.int32)
    words[..., 0] = values.to(torch.int32)
    return fq.to_mont(words)


# ---------------------------------------------------------------------------
# AddrTimestamps (sparse_mlpoly.rs:213-282)
# ---------------------------------------------------------------------------


class AddrTimestamps:
    """Addresses of the B instances' reads and their read and audit
    timestamps: numpy integers, and Montgomery tables on ``device``."""

    def __init__(self, ops_addr_int: np.ndarray, read_ts_int: np.ndarray,
                 audit_ts_int: np.ndarray, device):
        self.ops_addr_int = np.asarray(ops_addr_int, dtype=np.int64)
        self.read_ts_int = np.asarray(read_ts_int, dtype=np.int64)
        self.audit_ts_int = np.asarray(audit_ts_int, dtype=np.int64)
        self.num_cells = self.audit_ts_int.shape[0]
        assert max(self.read_ts_int.max(initial=0),
                   self.audit_ts_int.max(initial=0)) < 1 << 31
        self.addr_idx = torch.from_numpy(self.ops_addr_int).to(device)
        self.ops_addr = _usize_table(self.addr_idx)  # (B, N, 8)
        self.read_ts = _usize_table(
            torch.from_numpy(self.read_ts_int).to(device))  # (B, N, 8)
        self.audit_ts = _usize_table(
            torch.from_numpy(self.audit_ts_int).to(device))  # (cells, 8)

    @staticmethod
    def build(num_cells: int, ops_addr: np.ndarray,
              device) -> "AddrTimestamps":
        """ops_addr: (B, N) addresses.  Timestamps accumulate across the
        instances in order, as the reference's shared audit counter
        does."""
        B, N = ops_addr.shape
        assert ops_addr.max(initial=0) < num_cells
        flat = ops_addr.reshape(-1).astype(np.int64)
        order = np.argsort(flat, kind="stable")
        sorted_a = flat[order]
        idx = np.arange(flat.size, dtype=np.int64)
        is_start = np.empty(flat.size, dtype=bool)
        if flat.size:
            is_start[0] = True
            is_start[1:] = sorted_a[1:] != sorted_a[:-1]
        group_start = np.maximum.accumulate(np.where(is_start, idx, 0))
        read_ts = np.empty(flat.size, dtype=np.int64)
        read_ts[order] = idx - group_start
        audit = np.bincount(flat, minlength=num_cells).astype(np.int64)
        return AddrTimestamps(ops_addr, read_ts.reshape(B, N), audit, device)

    def deref(self, mem_val: torch.Tensor) -> torch.Tensor:
        """(B, N, 8) gather of mem_val[addr] (sparse_mlpoly.rs:256-272)."""
        return mem_val[self.addr_idx]


# ---------------------------------------------------------------------------
# Dense representation + commitment (sparse_mlpoly.rs:330-520)
# ---------------------------------------------------------------------------


class Derefs:
    def __init__(self, row_ops_val: torch.Tensor, col_ops_val: torch.Tensor):
        self.row_ops_val = row_ops_val  # (B, N, 8)
        self.col_ops_val = col_ops_val
        self.comb = dense.merge_pad([row_ops_val.flatten(0, 1),
                                     col_ops_val.flatten(0, 1)])

    def commit(self, gens: PolyCommitmentGens) -> "DerefsCommitment":
        comm, _ = commit(self.comb, gens, None)
        return DerefsCommitment(comm)


@dataclass
class DerefsCommitment:
    comm_ops_val: PolyCommitment

    def append_to_transcript(self, label: bytes, transcript: Transcript):
        transcript.append_message(b"derefs_commitment",
                                  b"begin_derefs_commitment")
        self.comm_ops_val.append_to_transcript(label, transcript)
        transcript.append_message(b"derefs_commitment",
                                  b"end_derefs_commitment")


class MultiSparseMatPolynomialAsDense:
    def __init__(self, batch_size: int, row: AddrTimestamps,
                 col: AddrTimestamps, val: torch.Tensor):
        self.batch_size = batch_size
        self.row = row
        self.col = col
        self.val = val  # (B, N, 8)
        self.comb_ops = dense.merge_pad([
            row.ops_addr.flatten(0, 1), row.read_ts.flatten(0, 1),
            col.ops_addr.flatten(0, 1), col.read_ts.flatten(0, 1),
            val.flatten(0, 1)])
        self.comb_mem = dense.merge_pad([row.audit_ts, col.audit_ts])

    def deref(self, row_mem_val, col_mem_val) -> Derefs:
        return Derefs(self.row.deref(row_mem_val), self.col.deref(col_mem_val))


class SparseMatPolyCommitmentGens:
    """sparse_mlpoly.rs:291-328."""

    def __init__(self, label: bytes, num_vars_x: int, num_vars_y: int,
                 num_nz_entries: int, batch_size: int):
        num_vars_ops = (_log2(_next_pow2(num_nz_entries))
                        + _log2(_next_pow2(batch_size * 5)))
        num_vars_mem = max(num_vars_x, num_vars_y) + 1
        num_vars_derefs = (_log2(_next_pow2(num_nz_entries))
                           + _log2(_next_pow2(batch_size * 2)))
        self.gens_ops = PolyCommitmentGens(num_vars_ops, label)
        self.gens_mem = PolyCommitmentGens(num_vars_mem, label)
        self.gens_derefs = PolyCommitmentGens(num_vars_derefs, label)


@dataclass
class SparseMatPolyCommitment:
    batch_size: int
    num_ops: int
    num_mem_cells: int
    comm_comb_ops: PolyCommitment
    comm_comb_mem: PolyCommitment

    def append_to_transcript(self, _label: bytes, transcript: Transcript):
        transcript.append_u64(b"batch_size", self.batch_size)
        transcript.append_u64(b"num_ops", self.num_ops)
        transcript.append_u64(b"num_mem_cells", self.num_mem_cells)
        self.comm_comb_ops.append_to_transcript(b"comm_comb_ops", transcript)
        self.comm_comb_mem.append_to_transcript(b"comm_comb_mem", transcript)


def multi_sparse_to_dense_rep(sparse_polys) -> MultiSparseMatPolynomialAsDense:
    """sparse_mlpoly.rs:370-427."""
    assert sparse_polys
    vx = sparse_polys[0].num_vars_x
    vy = sparse_polys[0].num_vars_y
    for p in sparse_polys[1:]:
        assert p.num_vars_x == vx and p.num_vars_y == vy
    dev = sparse_polys[0].vals.device

    N = max(p.get_num_nz_entries() for p in sparse_polys)
    B = len(sparse_polys)
    ops_row = np.zeros((B, N), dtype=np.int64)
    ops_col = np.zeros((B, N), dtype=np.int64)
    val = torch.zeros((B, N, limb.NWORDS), dtype=torch.int32, device=dev)
    for i, p in enumerate(sparse_polys):
        ops_row[i, :p.nnz] = p._rows_np
        ops_col[i, :p.nnz] = p._cols_np
        val[i, :p.nnz] = p.vals

    num_mem_cells = 1 << max(vx, vy)
    row = AddrTimestamps.build(num_mem_cells, ops_row, dev)
    col = AddrTimestamps.build(num_mem_cells, ops_col, dev)
    return MultiSparseMatPolynomialAsDense(B, row, col, val)


def multi_commit(sparse_polys, gens: SparseMatPolyCommitmentGens):
    """sparse_mlpoly.rs:483-504."""
    dense_rep = multi_sparse_to_dense_rep(sparse_polys)
    comm_ops, _ = commit(dense_rep.comb_ops, gens.gens_ops, None)
    comm_mem, _ = commit(dense_rep.comb_mem, gens.gens_mem, None)
    comm = SparseMatPolyCommitment(
        dense_rep.batch_size, dense_rep.row.read_ts.shape[1],
        dense_rep.row.num_cells, comm_ops, comm_mem)
    return comm, dense_rep


# ---------------------------------------------------------------------------
# Hash layers (sparse_mlpoly.rs:506-678)
# ---------------------------------------------------------------------------


def _hash_leaves(addr, val, ts, r_hash: int, r_ms: int):
    """hash(a, v, t) - r_ms = t*r^2 + v*r + a - r_ms over device tables."""
    dev = addr.device
    h = fq.add(fq.add(fq.mul(ts, fq.mont_limbs(r_hash * r_hash % Q, dev)),
                      fq.mul(val, fq.mont_limbs(r_hash, dev))), addr)
    return fq.sub(h, fq.mont_limbs(r_ms, dev))


class Layers:
    """Hashed init/read/write/audit leaf tables of one address space
    (sparse_mlpoly.rs:528-654)."""

    def __init__(self, eval_table: torch.Tensor, addr_ts: AddrTimestamps,
                 poly_ops_val: torch.Tensor, r_mem_check):
        r_hash, r_ms = r_mem_check
        dev = eval_table.device
        num_cells = eval_table.shape[0]
        ident = _usize_table(torch.arange(num_cells, device=dev))
        zero = torch.zeros_like(eval_table)
        self.init_leaves = _hash_leaves(ident, eval_table, zero, r_hash, r_ms)
        self.audit_leaves = _hash_leaves(
            ident, eval_table, addr_ts.audit_ts, r_hash, r_ms)
        self.read_leaves = _hash_leaves(
            addr_ts.ops_addr, poly_ops_val, addr_ts.read_ts, r_hash, r_ms)
        self.write_leaves = _hash_leaves(
            addr_ts.ops_addr, poly_ops_val,
            fq.add(addr_ts.read_ts, fq.mont_limbs(1, dev)), r_hash, r_ms)


# ---------------------------------------------------------------------------
# Proof layers
# ---------------------------------------------------------------------------


def _multiset_holds(init: int, read: list[int], write: list[int],
                    audit: int) -> bool:
    """init * prod(write) == prod(read) * audit."""
    ws = rs = 1
    for w in write:
        ws = ws * w % Q
    for r in read:
        rs = rs * r % Q
    return init * ws % Q == rs * audit % Q


def _append_claims(transcript: Transcript, which: bytes, four) -> None:
    init, read, write, audit = four
    transcript.append_scalar(b"claim_" + which + b"_eval_init", init)
    transcript.append_scalar_vector(b"claim_" + which + b"_eval_read", read)
    transcript.append_scalar_vector(b"claim_" + which + b"_eval_write",
                                    write)
    transcript.append_scalar(b"claim_" + which + b"_eval_audit", audit)


@dataclass
class ProductLayerProof:
    eval_row: tuple  # (init, read vec, write vec, audit)
    eval_col: tuple
    eval_val: tuple  # (dotp_left vec, dotp_right vec)
    proof_mem: ProductCircuitEvalProofBatched
    proof_ops: ProductCircuitEvalProofBatched

    PROTOCOL = b"Sparse polynomial product layer proof"

    @staticmethod
    def prove(row_layers: Layers, col_layers: Layers,
              dense_rep: MultiSparseMatPolynomialAsDense, derefs: Derefs,
              evals: list[int], transcript: Transcript):
        transcript.append_protocol_name(ProductLayerProof.PROTOCOL)
        B = dense_rep.batch_size
        N = dense_rep.val.shape[1]

        # the two instance-batched circuit trees
        t = Timer("spark::tree_build")
        ops_circuit = ProductCircuitBatch(torch.cat([
            row_layers.read_leaves, row_layers.write_leaves,
            col_layers.read_leaves, col_layers.write_leaves]))  # (4B, N, 8)
        mem_circuit = ProductCircuitBatch(torch.stack([
            row_layers.init_leaves, row_layers.audit_leaves,
            col_layers.init_leaves, col_layers.audit_leaves]))  # (4, C, 8)

        ops_evals = ops_circuit.evaluate()
        mem_evals = mem_circuit.evaluate()
        t.stop()
        eval_row = (mem_evals[0], ops_evals[0:B], ops_evals[B:2 * B],
                    mem_evals[1])
        eval_col = (mem_evals[2], ops_evals[2 * B:3 * B],
                    ops_evals[3 * B:4 * B], mem_evals[3])

        # multiset consistency (prover-side assert, sparse_mlpoly.rs:1055)
        assert _multiset_holds(*eval_row)
        _append_claims(transcript, b"row", eval_row)
        assert _multiset_holds(*eval_col)
        _append_claims(transcript, b"col", eval_col)

        # dot-product circuits proving the evaluations, each split in two
        # halves (sparse_mlpoly.rs:1089-1118), interleaved [left_0,
        # right_0, left_1, right_1, ...]
        def interleave(t):
            return t.reshape(2 * B, N // 2, limb.NWORDS)

        t = Timer("spark::dotp_evaluate")
        dotp = DotProductCircuitBatch(interleave(derefs.row_ops_val),
                                      interleave(derefs.col_ops_val),
                                      interleave(dense_rep.val))
        dotp_evals = dotp.evaluate()
        t.stop()
        eval_dotp_left = dotp_evals[0::2]
        eval_dotp_right = dotp_evals[1::2]
        for i in range(B):
            transcript.append_scalar(b"claim_eval_dotp_left",
                                     eval_dotp_left[i])
            transcript.append_scalar(b"claim_eval_dotp_right",
                                     eval_dotp_right[i])
            assert (eval_dotp_left[i] + eval_dotp_right[i]) % Q == evals[i] % Q

        t = Timer("spark::layer_rounds")
        proof_ops, rand_ops = ProductCircuitEvalProofBatched.prove(
            ops_circuit, dotp, transcript)
        proof_mem, rand_mem = ProductCircuitEvalProofBatched.prove(
            mem_circuit, None, transcript)
        t.stop()
        proof = ProductLayerProof(eval_row, eval_col,
                                  (eval_dotp_left, eval_dotp_right),
                                  proof_mem, proof_ops)
        return proof, rand_mem, rand_ops

    def verify(self, num_ops: int, num_cells: int, evals: list[int],
               transcript: Transcript):
        transcript.append_protocol_name(ProductLayerProof.PROTOCOL)
        num_instances = len(evals)
        for four in (self.eval_row, self.eval_col):
            if (len(four[1]) != num_instances
                    or len(four[2]) != num_instances):
                raise ProofVerifyError("product layer: wrong instance count")
        if not _multiset_holds(*self.eval_row):
            raise ProofVerifyError("row multiset check failed")
        _append_claims(transcript, b"row", self.eval_row)
        if not _multiset_holds(*self.eval_col):
            raise ProofVerifyError("col multiset check failed")
        _append_claims(transcript, b"col", self.eval_col)

        eval_dotp_left, eval_dotp_right = self.eval_val
        if (len(eval_dotp_left) != num_instances
                or len(eval_dotp_right) != num_instances):
            raise ProofVerifyError("product layer: dotp count")
        claims_dotp_circuit = []
        for i in range(num_instances):
            if (eval_dotp_left[i] + eval_dotp_right[i]) % Q != evals[i] % Q:
                raise ProofVerifyError("dotp split mismatch")
            transcript.append_scalar(b"claim_eval_dotp_left",
                                     eval_dotp_left[i])
            transcript.append_scalar(b"claim_eval_dotp_right",
                                     eval_dotp_right[i])
            claims_dotp_circuit += [eval_dotp_left[i], eval_dotp_right[i]]

        row_init, row_read, row_write, row_audit = self.eval_row
        col_init, col_read, col_write, col_audit = self.eval_col
        claims_prod_circuit = (list(row_read) + list(row_write)
                               + list(col_read) + list(col_write))
        claims_ops, claims_dotp, rand_ops = self.proof_ops.verify(
            claims_prod_circuit, claims_dotp_circuit, num_ops, transcript)
        claims_mem, _, rand_mem = self.proof_mem.verify(
            [row_init, row_audit, col_init, col_audit], [], num_cells,
            transcript)
        return claims_mem, rand_mem, claims_ops, claims_dotp, rand_ops


def _joint_claim(transcript: Transcript, evals: list[int], label: bytes,
                 challenge_label: bytes, rand: list[int]):
    """Append the evaluations, fold them into one claim with fresh
    challenges, append it; returns (the claim, its point)."""
    transcript.append_scalar_vector(label, evals)
    challenges = transcript.challenge_vector(challenge_label,
                                             _log2(len(evals)))
    joint = _fold_bot_host(evals, challenges)
    return joint, challenges + list(rand)


def _padded(evals: list[int]) -> list[int]:
    return list(evals) + [0] * (_next_pow2(len(evals)) - len(evals))


@dataclass
class HashLayerProof:
    eval_row: tuple  # (addr vec, read_ts vec, audit_ts)
    eval_col: tuple
    eval_val: list
    eval_derefs: tuple  # (row_ops_val vec, col_ops_val vec)
    proof_ops: PolyEvalProof
    proof_mem: PolyEvalProof
    proof_derefs: "DerefsEvalProof"

    PROTOCOL = b"Sparse polynomial hash layer proof"

    @staticmethod
    def prove(rand: tuple, dense_rep: MultiSparseMatPolynomialAsDense,
              derefs: Derefs, gens: SparseMatPolyCommitmentGens,
              transcript: Transcript, tape: RandomTape) -> "HashLayerProof":
        transcript.append_protocol_name(HashLayerProof.PROTOCOL)
        rand_mem, rand_ops = rand

        # every evaluation at the ops point in one fetch, then the two at
        # the mem point (audit) in another
        t = Timer("spark::evaluate")
        groups = [derefs.row_ops_val, derefs.col_ops_val,
                  dense_rep.row.ops_addr, dense_rep.row.read_ts,
                  dense_rep.col.ops_addr, dense_rep.col.read_ts,
                  dense_rep.val]
        all_ops = _evaluate_batched(groups, rand_ops)
        B = dense_rep.batch_size
        (eval_row_ops_val, eval_col_ops_val, eval_row_addr,
         eval_row_read_ts, eval_col_addr, eval_col_read_ts, eval_val) = (
            all_ops[i * B:(i + 1) * B] for i in range(7))
        eval_row_audit_ts, eval_col_audit_ts = _evaluate_batched(
            [torch.stack([dense_rep.row.audit_ts, dense_rep.col.audit_ts])],
            rand_mem)
        t.stop()

        proof_derefs = DerefsEvalProof.prove(
            derefs, eval_row_ops_val, eval_col_ops_val, rand_ops,
            gens.gens_derefs, transcript, tape)

        evals_ops = _padded(eval_row_addr + eval_row_read_ts + eval_col_addr
                            + eval_col_read_ts + eval_val)
        joint_ops, r_joint_ops = _joint_claim(
            transcript, evals_ops, b"claim_evals_ops",
            b"challenge_combine_n_to_one", rand_ops)
        transcript.append_scalar(b"joint_claim_eval_ops", joint_ops)
        proof_ops, _ = PolyEvalProof.prove(
            dense_rep.comb_ops, None, r_joint_ops, joint_ops, None,
            gens.gens_ops, transcript, tape)

        joint_mem, r_joint_mem = _joint_claim(
            transcript, [eval_row_audit_ts, eval_col_audit_ts],
            b"claim_evals_mem", b"challenge_combine_two_to_one", rand_mem)
        transcript.append_scalar(b"joint_claim_eval_mem", joint_mem)
        proof_mem, _ = PolyEvalProof.prove(
            dense_rep.comb_mem, None, r_joint_mem, joint_mem, None,
            gens.gens_mem, transcript, tape)

        return HashLayerProof(
            (eval_row_addr, eval_row_read_ts, eval_row_audit_ts),
            (eval_col_addr, eval_col_read_ts, eval_col_audit_ts),
            eval_val,
            (eval_row_ops_val, eval_col_ops_val),
            proof_ops, proof_mem, proof_derefs,
        )

    @staticmethod
    def _verify_helper(rand_mem, claims, eval_ops_val, eval_ops_addr,
                       eval_read_ts, eval_audit_ts, r, r_hash, r_ms):
        claim_init, claim_read, claim_write, claim_audit = claims
        r2 = r_hash * r_hash % Q

        def hashed(a, v, t):
            return (t * r2 + v * r_hash + a - r_ms) % Q

        eval_init_addr = 0
        for i, ri in enumerate(rand_mem):
            eval_init_addr = (
                eval_init_addr + (1 << (len(rand_mem) - i - 1)) * ri) % Q
        eval_init_val = dense.eq_evaluate(r, rand_mem)
        if hashed(eval_init_addr, eval_init_val, 0) != claim_init % Q:
            raise ProofVerifyError("hash layer: init claim")
        if not (len(eval_ops_addr) == len(eval_ops_val) == len(eval_read_ts)
                == len(claim_read) == len(claim_write)):
            raise ProofVerifyError("hash layer: claim count")
        for i in range(len(eval_ops_addr)):
            if (hashed(eval_ops_addr[i], eval_ops_val[i], eval_read_ts[i])
                    != claim_read[i] % Q):
                raise ProofVerifyError("hash layer: read claim")
            if (hashed(eval_ops_addr[i], eval_ops_val[i],
                       (eval_read_ts[i] + 1) % Q) != claim_write[i] % Q):
                raise ProofVerifyError("hash layer: write claim")
        if (hashed(eval_init_addr, eval_init_val, eval_audit_ts)
                != claim_audit % Q):
            raise ProofVerifyError("hash layer: audit claim")

    def verify(self, rand, claims_row, claims_col, claims_dotp,
               comm: SparseMatPolyCommitment,
               gens: SparseMatPolyCommitmentGens,
               comm_derefs: DerefsCommitment, rx, ry, r_hash, r_ms,
               transcript: Transcript, device=None):
        transcript.append_protocol_name(HashLayerProof.PROTOCOL)
        rand_mem, rand_ops = rand

        eval_row_ops_val, eval_col_ops_val = self.eval_derefs
        if len(eval_row_ops_val) != len(eval_col_ops_val):
            raise ProofVerifyError("hash layer: derefs eval count")
        self.proof_derefs.verify(rand_ops, eval_row_ops_val,
                                 eval_col_ops_val, gens.gens_derefs,
                                 comm_derefs, transcript, device)

        if (len(claims_dotp) != 3 * len(eval_row_ops_val)
                or len(self.eval_val) < len(eval_row_ops_val)):
            raise ProofVerifyError("hash layer: dotp claim count")
        for i in range(len(claims_dotp) // 3):
            if (claims_dotp[3 * i] % Q != eval_row_ops_val[i] % Q
                    or claims_dotp[3 * i + 1] % Q != eval_col_ops_val[i] % Q
                    or claims_dotp[3 * i + 2] % Q != self.eval_val[i] % Q):
                raise ProofVerifyError("hash layer: dotp claims mismatch")

        eval_row_addr, eval_row_read_ts, eval_row_audit_ts = self.eval_row
        eval_col_addr, eval_col_read_ts, eval_col_audit_ts = self.eval_col

        evals_ops = _padded(list(eval_row_addr) + list(eval_row_read_ts)
                            + list(eval_col_addr) + list(eval_col_read_ts)
                            + list(self.eval_val))
        joint_ops, r_joint_ops = _joint_claim(
            transcript, evals_ops, b"claim_evals_ops",
            b"challenge_combine_n_to_one", rand_ops)
        transcript.append_scalar(b"joint_claim_eval_ops", joint_ops)
        self.proof_ops.verify_plain(gens.gens_ops, transcript, r_joint_ops,
                                    joint_ops, comm.comm_comb_ops, device)

        joint_mem, r_joint_mem = _joint_claim(
            transcript, [eval_row_audit_ts, eval_col_audit_ts],
            b"claim_evals_mem", b"challenge_combine_two_to_one", rand_mem)
        transcript.append_scalar(b"joint_claim_eval_mem", joint_mem)
        self.proof_mem.verify_plain(gens.gens_mem, transcript, r_joint_mem,
                                    joint_mem, comm.comm_comb_mem, device)

        HashLayerProof._verify_helper(
            rand_mem, claims_row, eval_row_ops_val, eval_row_addr,
            eval_row_read_ts, eval_row_audit_ts, rx, r_hash, r_ms)
        HashLayerProof._verify_helper(
            rand_mem, claims_col, eval_col_ops_val, eval_col_addr,
            eval_col_read_ts, eval_col_audit_ts, ry, r_hash, r_ms)


@dataclass
class DerefsEvalProof:
    """sparse_mlpoly.rs:70-204."""

    proof_derefs: PolyEvalProof

    PROTOCOL = b"Derefs evaluation proof"

    @staticmethod
    def prove(derefs: Derefs, eval_row_ops_val, eval_col_ops_val, r,
              gens: PolyCommitmentGens, transcript: Transcript,
              tape: RandomTape) -> "DerefsEvalProof":
        transcript.append_protocol_name(DerefsEvalProof.PROTOCOL)
        joint, r_joint = _joint_claim(
            transcript, _padded(eval_row_ops_val + eval_col_ops_val),
            b"evals_ops_val", b"challenge_combine_n_to_one", r)
        transcript.append_scalar(b"joint_claim_eval", joint)
        proof, _ = PolyEvalProof.prove(derefs.comb, None, r_joint, joint,
                                       None, gens, transcript, tape)
        return DerefsEvalProof(proof)

    def verify(self, r, eval_row_ops_val, eval_col_ops_val,
               gens: PolyCommitmentGens, comm: DerefsCommitment,
               transcript: Transcript, device=None):
        transcript.append_protocol_name(DerefsEvalProof.PROTOCOL)
        joint, r_joint = _joint_claim(
            transcript,
            _padded(list(eval_row_ops_val) + list(eval_col_ops_val)),
            b"evals_ops_val", b"challenge_combine_n_to_one", r)
        transcript.append_scalar(b"joint_claim_eval", joint)
        self.proof_derefs.verify_plain(gens, transcript, r_joint, joint,
                                       comm.comm_ops_val, device)


@dataclass
class PolyEvalNetworkProof:
    proof_prod_layer: ProductLayerProof
    proof_hash_layer: HashLayerProof

    PROTOCOL = b"Sparse polynomial evaluation proof"

    @staticmethod
    def prove(dense_rep, derefs, mem_rx, mem_ry, r_mem_check, evals,
              gens, transcript, tape) -> "PolyEvalNetworkProof":
        transcript.append_protocol_name(PolyEvalNetworkProof.PROTOCOL)
        t = Timer("spark::hash_leaves")
        row_layers = Layers(mem_rx, dense_rep.row, derefs.row_ops_val,
                            r_mem_check)
        col_layers = Layers(mem_ry, dense_rep.col, derefs.col_ops_val,
                            r_mem_check)
        t.stop()
        proof_prod_layer, rand_mem, rand_ops = ProductLayerProof.prove(
            row_layers, col_layers, dense_rep, derefs, evals, transcript)
        del row_layers, col_layers  # free the leaves before the hash layer
        proof_hash_layer = HashLayerProof.prove(
            (rand_mem, rand_ops), dense_rep, derefs, gens, transcript, tape)
        return PolyEvalNetworkProof(proof_prod_layer, proof_hash_layer)

    def verify(self, comm, comm_derefs, evals, gens, rx, ry, r_mem_check,
               nz: int, transcript: Transcript, device=None):
        transcript.append_protocol_name(PolyEvalNetworkProof.PROTOCOL)
        num_instances = len(evals)
        r_hash, r_ms = r_mem_check
        num_ops = _next_pow2(nz)
        num_cells = 1 << len(rx)
        if len(rx) != len(ry):
            raise ProofVerifyError("eval network: unequal rx/ry")

        claims_mem, rand_mem, claims_ops, claims_dotp, rand_ops = (
            self.proof_prod_layer.verify(num_ops, num_cells, evals,
                                         transcript))
        if (len(claims_mem) != 4 or len(claims_ops) != 4 * num_instances
                or len(claims_dotp) != 3 * num_instances):
            raise ProofVerifyError("eval network: claim counts")
        k = num_instances
        self.proof_hash_layer.verify(
            (rand_mem, rand_ops),
            (claims_mem[0], claims_ops[:k], claims_ops[k:2 * k],
             claims_mem[1]),
            (claims_mem[2], claims_ops[2 * k:3 * k], claims_ops[3 * k:],
             claims_mem[3]),
            claims_dotp, comm, gens, comm_derefs, rx, ry, r_hash, r_ms,
            transcript, device)


def _equalize(rx: list[int], ry: list[int]):
    """sparse_mlpoly.rs:1429-1445: zero-prefix the shorter point."""
    d = len(ry) - len(rx)
    return [0] * d + list(rx), [0] * -d + list(ry)


@dataclass
class SparseMatPolyEvalProof:
    """sparse_mlpoly.rs:1418-1553."""

    comm_derefs: DerefsCommitment
    poly_eval_network_proof: PolyEvalNetworkProof

    PROTOCOL = b"Sparse polynomial evaluation proof"

    @staticmethod
    def prove(dense_rep: MultiSparseMatPolynomialAsDense, rx, ry,
              evals: list[int], gens: SparseMatPolyCommitmentGens,
              transcript: Transcript, tape: RandomTape):
        transcript.append_protocol_name(SparseMatPolyEvalProof.PROTOCOL)
        assert len(evals) == dense_rep.batch_size
        dev = dense_rep.val.device
        rx_ext, ry_ext = _equalize(rx, ry)
        mem_rx = dense.eq_evals(rx_ext, dev)
        mem_ry = dense.eq_evals(ry_ext, dev)
        derefs = dense_rep.deref(mem_rx, mem_ry)

        t_commit = Timer("commit_nondet_witness")
        comm_derefs = derefs.commit(gens.gens_derefs)
        comm_derefs.append_to_transcript(b"comm_poly_row_col_ops_val",
                                         transcript)
        t_commit.stop()

        r_mem_check = transcript.challenge_vector(b"challenge_r_hash", 2)
        t_net = Timer("build_layered_network+evalproof_layered_network")
        proof = PolyEvalNetworkProof.prove(
            dense_rep, derefs, mem_rx, mem_ry,
            (r_mem_check[0], r_mem_check[1]), evals, gens, transcript, tape)
        t_net.stop()
        return SparseMatPolyEvalProof(comm_derefs, proof)

    def verify(self, comm: SparseMatPolyCommitment, rx, ry,
               evals: list[int], gens: SparseMatPolyCommitmentGens,
               transcript: Transcript, device=None):
        transcript.append_protocol_name(SparseMatPolyEvalProof.PROTOCOL)
        rx_ext, ry_ext = _equalize(rx, ry)
        if (1 << len(rx_ext)) != comm.num_mem_cells:
            raise ProofVerifyError("sparse eval: point/commitment size")
        self.comm_derefs.append_to_transcript(b"comm_poly_row_col_ops_val",
                                              transcript)
        r_mem_check = transcript.challenge_vector(b"challenge_r_hash", 2)
        self.poly_eval_network_proof.verify(
            comm, self.comm_derefs, evals, gens, rx_ext, ry_ext,
            (r_mem_check[0], r_mem_check[1]), comm.num_ops, transcript,
            device)
