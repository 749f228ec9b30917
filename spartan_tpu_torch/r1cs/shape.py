"""R1CS shape and sparse-matrix products (reference src/r1cs.rs and the
SpMV pieces of src/sparse_mlpoly.rs:330-504).

Matrices are COO on the device: int64 row/col index vectors plus an
``(nnz, 8)`` Montgomery value table.  SpMV and its transpose are
gather -> batched field product -> ``index_add_`` of the 16-bit limbs
into int64 accumulators (exact for up to 2^47 entries per output cell)
-> one wide modular reduction.  This stays a PyTorch operation, as it
was an XLA one in the JAX package.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..core.field import Q
from ..ff import fq, limb
from ..poly import dense


class SparseMatPolynomial:
    """COO sparse multilinear matrix polynomial."""

    def __init__(self, num_vars_x: int, num_vars_y: int,
                 rows: np.ndarray, cols: np.ndarray, vals_ints: list[int],
                 device):
        self.num_vars_x = num_vars_x
        self.num_vars_y = num_vars_y
        self._rows_np = np.asarray(rows, dtype=np.int64)
        self._cols_np = np.asarray(cols, dtype=np.int64)
        self._vals_ints = [v % Q for v in vals_ints]
        mont = fq.encode_ints(self._vals_ints)  # host Montgomery map
        self._vals_mont_bytes = mont.numpy().astype("<i4").tobytes()
        self.rows = torch.from_numpy(self._rows_np).to(device)
        self.cols = torch.from_numpy(self._cols_np).to(device)
        self.vals = mont.to(device)  # (nnz, 8) Montgomery

    @staticmethod
    def from_entries(num_vars_x: int, num_vars_y: int,
                     entries: list[tuple[int, int, int]],
                     device) -> "SparseMatPolynomial":
        rows = np.array([e[0] for e in entries], dtype=np.int64)
        cols = np.array([e[1] for e in entries], dtype=np.int64)
        return SparseMatPolynomial(num_vars_x, num_vars_y, rows, cols,
                                   [e[2] for e in entries], device)

    @property
    def nnz(self) -> int:
        return int(self._rows_np.shape[0])

    def get_num_nz_entries(self) -> int:
        """nnz rounded up to a power of two (at least 1)."""
        n = max(self.nnz, 1)
        return 1 << (n - 1).bit_length()

    def entries_ints(self) -> list[tuple[int, int, int]]:
        return list(zip(self._rows_np.tolist(), self._cols_np.tolist(),
                        self._vals_ints))

    def vals_mont_bytes(self) -> bytes:
        """The nnz 32-byte LE Montgomery entries (host copy)."""
        return self._vals_mont_bytes

    def multiply_vec(self, num_rows: int, num_cols: int,
                     z: torch.Tensor) -> torch.Tensor:
        """Az: (num_rows, 8) Montgomery (sparse_mlpoly.rs:454-464)."""
        assert z.shape[0] == num_cols
        return _spmv(self.rows, self.cols, self.vals, z, num_rows)

    def compute_eval_table_sparse(self, rx: torch.Tensor, num_rows: int,
                                  num_cols: int) -> torch.Tensor:
        """M_evals[col] += rx[row] * val (sparse_mlpoly.rs:466-480)."""
        assert rx.shape[0] == num_rows
        return _spmv(self.cols, self.rows, self.vals, rx, num_cols)

    @staticmethod
    def multi_evaluate(polys: list["SparseMatPolynomial"], rx: list[int],
                       ry: list[int]) -> list[int]:
        """The verifier's eval_sparse_polys (r1cs.rs:300-303), on the
        host: native C++ Montgomery batch ops, or python ints without
        the native library."""
        from .. import native

        if native.available():
            eq_rx = native.fq_eq_evals_mont(rx)
            eq_ry = native.fq_eq_evals_mont(ry)
            return [
                native.fq_sparse_eval(eq_rx, eq_ry, p._rows_np, p._cols_np,
                                      p.vals_mont_bytes())
                for p in polys
            ]
        eqx = _eq_evals_host_py(rx)
        eqy = _eq_evals_host_py(ry)
        outs = []
        for p in polys:
            total = 0
            for r, c, v in p.entries_ints():
                total += eqx[r] * eqy[c] % Q * v
            outs.append(total % Q)
        return outs


def _eq_evals_host_py(r: list[int]) -> list[int]:
    """eq(r, x) table with python ints (dense_mlpoly.rs:68-84 order)."""
    tab = [1]
    for rj in r:
        nxt = []
        for t in tab:
            hi = t * rj % Q
            nxt.append((t - hi) % Q)
            nxt.append(hi)
        tab = nxt
    return tab


def _spmv(out_idx: torch.Tensor, in_idx: torch.Tensor, vals: torch.Tensor,
          z: torch.Tensor, out_size: int) -> torch.Tensor:
    prod = fq.mul16(limb.unpack(vals), limb.unpack(z)[in_idx])
    acc = torch.zeros((out_size, limb.NLIMBS), dtype=torch.int64,
                      device=z.device)
    acc.index_add_(0, out_idx, prod)
    return fq.reduce_wide(acc)


class R1CSShape:
    """reference r1cs.rs:18-26,86-140."""

    def __init__(self, num_cons: int, num_vars: int, num_inputs: int,
                 A: SparseMatPolynomial, B: SparseMatPolynomial,
                 C: SparseMatPolynomial):
        assert num_cons == _next_pow2(num_cons)
        assert num_vars == _next_pow2(num_vars)
        assert num_inputs < num_vars
        self.num_cons = num_cons
        self.num_vars = num_vars
        self.num_inputs = num_inputs
        self.A, self.B, self.C = A, B, C

    @property
    def device(self) -> torch.device:
        return self.A.vals.device

    @staticmethod
    def create(num_cons: int, num_vars: int, num_inputs: int,
               A: list, B: list, C: list, device) -> "R1CSShape":
        npx = _log2(num_cons)
        npy = _log2(2 * num_vars)
        return R1CSShape(
            num_cons, num_vars, num_inputs,
            SparseMatPolynomial.from_entries(npx, npy, A, device),
            SparseMatPolynomial.from_entries(npx, npy, B, device),
            SparseMatPolynomial.from_entries(npx, npy, C, device),
        )

    def get_digest(self) -> bytes:
        """zlib(bincode(shape)) (r1cs.rs:154-158): u64 LE ints,
        u64-length-prefixed vecs, each entry 8 B row | 8 B col | 32 B
        Montgomery scalar, deflated by torch's vendored miniz (the
        compressor family of the reference's flate2 backend)."""
        out = bytearray()
        out += struct.pack("<QQQ", self.num_cons, self.num_vars, self.num_inputs)
        for m in (self.A, self.B, self.C):
            out += struct.pack("<QQ", m.num_vars_x, m.num_vars_y)
            n = m.nnz
            out += struct.pack("<Q", n)
            rec = np.empty(n, dtype=[("r", "<u8"), ("c", "<u8"),
                                     ("s", "u1", (32,))])
            rec["r"] = m._rows_np
            rec["c"] = m._cols_np
            rec["s"] = np.frombuffer(m.vals_mont_bytes(),
                                     dtype="u1").reshape(n, 32)
            out += rec.tobytes()
        from ..utils import miniz

        return miniz.zlib_stream(bytes(out), 6)

    def multiply_vec(self, z: torch.Tensor):
        n, m = self.num_cons, z.shape[0]
        assert m > self.num_vars
        return (self.A.multiply_vec(n, m, z),
                self.B.multiply_vec(n, m, z),
                self.C.multiply_vec(n, m, z))

    def compute_eval_table_sparse(self, rx: torch.Tensor, num_cols: int):
        return tuple(M.compute_eval_table_sparse(rx, self.num_cons, num_cols)
                     for M in (self.A, self.B, self.C))

    def evaluate(self, rx: list[int], ry: list[int]) -> tuple[int, int, int]:
        e = SparseMatPolynomial.multi_evaluate([self.A, self.B, self.C], rx, ry)
        return e[0], e[1], e[2]

    def is_sat(self, vars_ints: list[int], input_ints: list[int]) -> bool:
        assert len(vars_ints) == self.num_vars
        assert len(input_ints) == self.num_inputs
        from .. import native

        z_ints = list(vars_ints) + [1] + list(input_ints)
        if native.available():
            # public-data check on the host (C++ SpMV)
            R256 = (1 << 256) % Q
            zb = b"".join((v * R256 % Q).to_bytes(32, "little")
                          for v in z_ints)
            Az, Bz, Cz = (
                native.fq_spmv(m._rows_np, m._cols_np, m.vals_mont_bytes(),
                               zb, self.num_cons)
                for m in (self.A, self.B, self.C))
            return all((a * b - c) % Q == 0 for a, b, c in zip(Az, Bz, Cz))
        z = dense.from_ints(z_ints, self.device)
        Az, Bz, Cz = self.multiply_vec(z)
        diff = fq.sub(fq.mul(Az, Bz), Cz)
        return bool(torch.all(diff == 0))

    @staticmethod
    def produce_synthetic(num_cons: int, num_vars: int, num_inputs: int,
                          seed: int | None = 0, device=None):
        """Synthetic satisfiable instance (r1cs.rs:160-238): one entry per
        row per matrix at rotating columns; deterministic for any integer
        seed (``random.Random(seed)``), so it matches the JAX package's
        instance for the same seed."""
        import random as _random

        from ..core.field import batch_inv

        rng = _random.Random(seed)
        size_z = num_vars + num_inputs + 1
        Z = [rng.randrange(Q) for _ in range(size_z)]
        Z[num_vars] = 1
        nonzero_idx = [i for i, z in enumerate(Z) if z != 0]
        invs = batch_inv([Z[i] for i in nonzero_idx])
        Z_inv = [0] * size_z
        for i, v in zip(nonzero_idx, invs):
            Z_inv[i] = v
        A, B, C = [], [], []
        for i in range(num_cons):
            a_idx = i % size_z
            b_idx = (i + 2) % size_z
            A.append((i, a_idx, 1))
            B.append((i, b_idx, 1))
            ab = Z[a_idx] * Z[b_idx] % Q
            c_idx = (i + 3) % size_z
            if Z[c_idx] == 0:
                C.append((i, num_vars, ab))
            else:
                C.append((i, c_idx, ab * Z_inv[c_idx] % Q))
        inst = R1CSShape.create(num_cons, num_vars, num_inputs, A, B, C,
                                device)
        assert inst.is_sat(Z[:num_vars], Z[num_vars + 1:])
        return inst, Z[:num_vars], Z[num_vars + 1:]


class SparsePolynomial:
    """Verifier-side sparse multilinear poly for the input vector
    (sparse_mlpoly.rs:1555-1594); host ints, O(#entries log n)."""

    def __init__(self, num_vars: int, entries: list[tuple[int, int]]):
        self.num_vars = num_vars
        self.entries = entries

    def evaluate(self, r: list[int]) -> int:
        assert len(r) == self.num_vars
        total = 0
        for idx, val in self.entries:
            chi = 1
            for j in range(len(r)):
                bit = (idx >> (len(r) - j - 1)) & 1
                chi = chi * (r[j] if bit else (1 - r[j]) % Q) % Q
            total = (total + chi * val) % Q
        return total


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else max(n, 1)


def _log2(n: int) -> int:
    assert n > 0
    return (n - 1).bit_length() if n > 1 else 0
