"""The benchmark's circuit and its witnesses, in plain Python.  The
circuit comes from the configuration's ``circuit_seed`` (a deployment
proves one circuit), each request's inputs from the run's seed.

Upstream's synthetic instance (``r1cs.rs``) has one witness per instance.
A prover proves one circuit for many witnesses, so this circuit keeps
upstream's sizes and density (one entry per constraint in each of A, B
and C) but is a computation: constraint i multiplies two earlier values,
chosen by the seed among the variables before it, the constant 1 and the
inputs, into variable i; A and B carry 1 and C a random non-zero
coefficient c_i, so that z_a z_b = c_i v_i.  Every witness follows
forward from its inputs: v_i = z_a z_b / c_i.

Columns follow the port's ``Instance.new`` layout: variables
0..num_vars-1, the constant 1 at num_vars, input k at num_vars + 1 + k.
"""

from __future__ import annotations

import numpy as np

from .reference.field import Q, batch_inv


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), *stream])


def _scalars(rng: np.random.Generator, n: int) -> list[int]:
    """n uniform non-zero scalars (64 random bytes each, reduced)."""
    raw = rng.bytes(64 * n)
    return [int.from_bytes(raw[64 * i:64 * i + 64], "little") % (Q - 1) + 1
            for i in range(n)]


class Circuit:
    def __init__(self, num_cons: int, num_vars: int, num_inputs: int,
                 seed: int, *stream: int):
        """``stream`` tells apart further circuits of one seed (a new
        circuit a request)."""
        if num_cons > num_vars:
            raise ValueError("one new variable a constraint")
        self.num_cons, self.num_vars = num_cons, num_vars
        self.num_inputs = num_inputs
        rng = _rng(seed, 0, *stream)
        # operand k of constraint i: one of the i earlier variables, the
        # constant or an input, uniformly
        pool = np.arange(num_cons, dtype=np.int64) + 1 + num_inputs
        ops = (rng.random((2, num_cons)) * pool).astype(np.int64)
        ops = np.minimum(ops, pool - 1)
        i = np.arange(num_cons, dtype=np.int64)
        # pool index k < i is variable k; k >= i is column num_vars + k - i
        self.a_col = np.where(ops[0] < i, ops[0], num_vars + ops[0] - i)
        self.b_col = np.where(ops[1] < i, ops[1], num_vars + ops[1] - i)
        self.coeffs = _scalars(rng, num_cons)
        self._inv = None

    def matrices(self):
        """(rows, cols, vals) of A, B and C."""
        rows = np.arange(self.num_cons, dtype=np.int64)
        ones = [1] * self.num_cons
        return ((rows, self.a_col, ones), (rows, self.b_col, ones),
                (rows, rows.copy(), list(self.coeffs)))

    def entries(self):
        """A, B and C as lists of (row, col, val) for ``Instance.new``."""
        out = []
        for rows, cols, vals in self.matrices():
            out.append(list(zip(rows.tolist(), cols.tolist(), vals)))
        return out

    def inputs(self, seed: int, request: int) -> list[int]:
        return _scalars(_rng(seed, 1, request), self.num_inputs)

    def witness(self, inputs: list[int], upto: int | None = None
                ) -> list[int]:
        """The variables that satisfy every constraint for ``inputs``;
        with ``upto``, only the first ``upto`` of them (a variable
        depends only on those before it)."""
        if self._inv is None:
            self._inv = batch_inv(self.coeffs)
        n = self.num_vars if upto is None else min(upto, self.num_vars)
        z = [0] * self.num_vars + [1] + list(inputs)
        a, b, inv = self.a_col.tolist(), self.b_col.tolist(), self._inv
        for i in range(min(self.num_cons, n)):
            z[i] = z[a[i]] * z[b[i]] % Q * inv[i] % Q
        return z[:n]


def is_satisfied(circuit: Circuit, vars_: list[int],
                 inputs: list[int]) -> bool:
    """Every constraint checked with plain ints."""
    z = list(vars_) + [1] + list(inputs)
    (_, a, _), (_, b, _), (rows, c, cv) = circuit.matrices()
    return all(z[ai] * z[bi] % Q == cvi * z[ci] % Q
               for ai, bi, ci, cvi in zip(a.tolist(), b.tolist(),
                                          c.tolist(), cv))
