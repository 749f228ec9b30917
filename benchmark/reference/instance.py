"""The R1CS instance as the verifier sees it, worked out again from the
benchmark's own matrices: padding and column layout (``lib.rs``), the
digest's uncompressed bytes (``r1cs.rs``: bincode of the shape), the
matrices' evaluations at (rx, ry), and Spark's dense representation
with a check of a commitment to it (``sparse_mlpoly.rs``)."""

from __future__ import annotations

import operator
import random

import numpy as np

from . import group as G
from .field import Q, eq_table, log2, next_pow2


class RefInstance:
    """``A``, ``B``, ``C``: (rows, cols, vals) with numpy int64 rows and
    columns in the caller's layout (variables, then the constant 1, then
    the inputs) and python-int values."""

    def __init__(self, num_cons: int, num_vars: int, num_inputs: int,
                 A, B, C):
        self.num_inputs = num_inputs
        self.num_vars = next_pow2(max(num_vars, num_inputs + 1))
        self.num_cons = 2 if num_cons <= 1 else next_pow2(num_cons)
        shift = self.num_vars - num_vars
        self.mats = []
        for rows, cols, vals in (A, B, C):
            cols = np.asarray(cols, dtype=np.int64)
            cols = np.where(cols >= num_vars, cols + shift, cols)
            self.mats.append((np.asarray(rows, dtype=np.int64), cols,
                              [v % Q for v in vals]))

    # ------------------------------------------------------------ digest

    def bincode(self) -> bytes:
        """The shape's bincode bytes, which the digest compresses."""
        vx, vy = log2(self.num_cons), log2(2 * self.num_vars)
        parts = [np.array([self.num_cons, self.num_vars, self.num_inputs],
                          dtype="<u8").tobytes()]
        for rows, cols, vals in self.mats:
            n = len(vals)
            parts.append(np.array([vx, vy, n], dtype="<u8").tobytes())
            rec = np.empty(n, dtype=[("r", "<u8"), ("c", "<u8"),
                                     ("s", "u1", (32,))])
            rec["r"], rec["c"] = rows, cols
            mont = b"".join(((v << 256) % Q).to_bytes(32, "little")
                            for v in vals)
            rec["s"] = np.frombuffer(mont, dtype="u1").reshape(n, 32)
            parts.append(rec.tobytes())
        return b"".join(parts)

    # ------------------------------------------------------- evaluations

    def evaluate(self, rx: list[int], ry: list[int]) -> list[int]:
        """(A(rx, ry), B(rx, ry), C(rx, ry))."""
        if len(rx) != log2(self.num_cons) or \
                len(ry) != log2(2 * self.num_vars):
            raise ValueError("evaluation point of the wrong size")
        ex, ey = eq_table(rx), eq_table(ry)
        out = []
        for rows, cols, vals in self.mats:
            exr = map(ex.__getitem__, rows.tolist())
            eyc = map(ey.__getitem__, cols.tolist())
            if all(v == 1 for v in vals):
                out.append(sum(map(operator.mul, exr, eyc)) % Q)
            else:
                out.append(sum(map(operator.mul,
                                   map(operator.mul, vals, exr), eyc)) % Q)
        return out

    # ------------------------------------------------------------- Spark

    def dense(self):
        """Spark's combined tables as (L, R) matrices: ``ops`` (the rows'
        and columns' addresses and read timestamps, then the values) and
        ``mem`` (the audit timestamps).  Entries below 2^31 sit in an
        int64 array, larger values in a list of (flat index, value)."""
        B = len(self.mats)
        N = max(next_pow2(max(len(v), 1)) for _, _, v in self.mats)
        cells = 1 << max(log2(self.num_cons), log2(2 * self.num_vars))
        addr = np.zeros((2, B, N), dtype=np.int64)
        vals = [[0] * N for _ in range(B)]
        for b, (rows, cols, v) in enumerate(self.mats):
            addr[0, b, :len(v)] = rows
            addr[1, b, :len(v)] = cols
            vals[b][:len(v)] = v
        ts, audit = [], []
        for k in range(2):  # rows, then columns
            seen = np.zeros(cells, dtype=np.int64)
            flat = addr[k].reshape(-1)
            # read timestamp: how often the address was read before, over
            # the instances in order (one shared counter per cell)
            order = np.argsort(flat, kind="stable")
            s = flat[order]
            first = np.r_[True, s[1:] != s[:-1]]
            idx = np.arange(flat.size, dtype=np.int64)
            rank = idx - np.maximum.accumulate(np.where(first, idx, 0))
            read = np.empty_like(flat)
            read[order] = rank
            np.add.at(seen, flat, 1)
            ts.append(read)
            audit.append(seen)
        small_ops = np.concatenate([addr[0].reshape(-1), ts[0],
                                    addr[1].reshape(-1), ts[1],
                                    np.zeros(B * N, dtype=np.int64)])
        big_ops = []
        base = 4 * B * N
        for b in range(B):
            for i, v in enumerate(vals[b]):
                if v < 1 << 31:
                    small_ops[base + b * N + i] = v
                else:
                    big_ops.append((base + b * N + i, v))
        ops = _matrix(small_ops, big_ops)
        mem = _matrix(np.concatenate(audit), [])
        return dict(batch=B, num_ops=N, cells=cells, ops=ops, mem=mem)


def _matrix(small: np.ndarray, big: list):
    """Pad to a power of two and view as (L, R), L = 2^(ell // 2)."""
    n = next_pow2(small.size)
    ell = log2(n)
    L = 1 << (ell // 2)
    flat = np.zeros(n, dtype=np.int64)
    flat[:small.size] = small
    return flat.reshape(L, n // L), big


def row_combination(mat, rho: list[int]) -> list[int]:
    """w_j = sum_i rho_i M[i, j] mod q, for 128-bit ``rho``."""
    small, big = mat
    L, R = small.shape
    limbs = np.array([[(r >> (16 * a)) & 0xFFFF for a in range(8)]
                      for r in rho], dtype=np.int64)  # (L, 8)
    if small.max(initial=0) >= 1 << 31 or small.min(initial=0) < 0:
        raise ValueError("small entries out of range")
    S = small.T @ limbs  # (R, 8), each < L 2^47
    w = [sum(int(S[j, a]) << (16 * a) for a in range(8)) for j in range(R)]
    for f, v in big:
        i, j = divmod(f, R)
        w[j] += rho[i] * v
    return [x % Q for x in w]


def commitment_holds(mat, rows: list, gens_G: list, seed: int) -> bool:
    """Whether the row commitments ``rows`` (points) commit to ``mat``
    under ``gens_G`` with zero blinds: one random combination of the
    rows, sum_i rho_i C_i == sum_j w_j G_j, with 128-bit rho from
    ``seed``."""
    small, _ = mat
    L, R = small.shape
    if len(rows) != L or len(gens_G) < R:
        return False
    rng = random.Random(seed)
    rho = [rng.getrandbits(128) | 1 for _ in range(L)]
    lhs = G.msm(rho, rows)
    rhs = G.msm(row_combination(mat, rho), gens_G[:R])
    return G.equal(lhs, rhs)
