"""The port's dense polynomials (``poly/dense.py``) and R1CS shape
(``r1cs/shape.py``) against python-int arithmetic and the JAX package's
R1CS shape, carried across through ``interop`` (the JAX shape, its digest
and an evaluation recorded in ``tests/golden/port/r1cs-synthetic.npz``).
The sparse product (``ff/spmv.py``): its set-up tables against the COO
entries, kernel K9's wrapper through a launch emulated on host memory
(short, long, chunked and empty rows), and the evaluation on the
instance's device against the host's.
"""

import ctypes
import random

import jax  # noqa: F401
import pytest
import torch  # noqa: F401

import numpy as np

from golden.port.record import load, to_ints
from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu.core.field import Q
from spartan_tpu.poly.commit import _eq_evals_host
from spartan_tpu_torch import interop, native
from spartan_tpu_torch.ff import fq, spmv
from spartan_tpu_torch.poly import dense
from spartan_tpu_torch.r1cs.shape import R1CSShape, SparseMatPolynomial


def _ints(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(Q) for _ in range(n)]


@pytest.mark.parametrize("ell", [0, 1, 5])
def test_eq_evals(ell):
    r = _ints(ell, ell)
    assert dense.to_ints(dense.eq_evals(r, "cpu")) == _eq_evals_host(r)


def test_evaluate_bound_L():
    Z = _ints(64, 1)
    T = dense.from_ints(Z, "cpu")
    pt = _ints(6, 2)
    chi = _eq_evals_host(pt)
    assert dense.evaluate(T, pt) == sum(c * z for c, z in zip(chi, Z)) % Q
    L = _ints(8, 3)
    got = dense.to_ints(dense.bound_L(T, dense.from_ints(L, "cpu")))
    assert got == [sum(L[j] * Z[8 * j + i] for j in range(8)) % Q
                   for i in range(8)]
    assert dense.factored_lens(7) == (3, 4)


def _naive_spmv(entries, z, n_out, transpose=False):
    out = [0] * n_out
    for r, c, v in entries:
        o, i = (c, r) if transpose else (r, c)
        out[o] = (out[o] + v * z[i]) % Q
    return out


def _table_entries(t):
    """(output, input, value) of every non-zero of a set-up table, and
    the long rows' chunks as (output row, begin, end)."""
    def ints(a, n):  # None stands for the identity
        return list(range(n)) if a is None else a.tolist()

    off, idx, perm = (ints(t.off, t.n_tab + 1), ints(t.idx, t.nnz),
                      ints(t.perm, t.nnz))
    vals = dense.to_ints(t.vals)
    entries = [(r, idx[j], vals[perm[j]]) for r in range(t.n_tab)
               for j in range(off[r], off[r + 1])]
    chunks = []
    if t.chunks is not None:
        rows = t.long_rows.tolist()
        for l, b, e in t.chunks.tolist():
            assert rows[l][1] <= len(chunks) < rows[l + 1][1]
            chunks.append((rows[l][0], b, e))
    return entries, chunks


def test_spmv_and_eval_table_vs_ints():
    rng = random.Random(4)
    entries = [(rng.randrange(16), rng.randrange(32), rng.randrange(Q))
               for _ in range(100)]
    entries += [(3, 7, Q - 1)] * 40  # many entries in one cell
    m = SparseMatPolynomial.from_entries(4, 5, entries, "cpu")
    z = _ints(32, 5)
    got = dense.to_ints(m.multiply_vec(16, 32, dense.from_ints(z, "cpu")))
    assert got == _naive_spmv(entries, z, 16)
    rx = _ints(16, 6)
    got = dense.to_ints(m.compute_eval_table_sparse(
        dense.from_ints(rx, "cpu"), 16, 32))
    assert got == _naive_spmv(entries, rx, 32, transpose=True)
    # the set-up tables: by row and by column, each the COO's entries
    # sorted by output (stably) up to the last non-empty output, and the
    # rows of more than LONG_ROW non-zeros (row 3, column 7) cut into
    # chunks that cover them
    for t, key, n_out in ((m.by_row, lambda e: e, 16),
                          (m.by_col, lambda e: (e[1], e[0], e[2]), 32)):
        want = sorted((key(e) for e in entries), key=lambda e: e[0])
        got, chunks = _table_entries(t)
        assert (t.n_out, t.nnz, got) == (n_out, len(entries), want)
        assert t.n_tab == want[-1][0] + 1 and t.vals is m.vals
        off = t.off.tolist()  # several non-zeros an output: not None
        long = [r for r in range(t.n_tab)
                if off[r + 1] - off[r] > spmv.LONG_ROW]
        assert long == [3 if n_out == 16 else 7]
        assert [(r, off[r], off[r + 1]) for r in long] == chunks
        assert t.n_in == max(e[1] for e in want) + 1
        # the threads' order: every row, longest first
        counts = [off[r + 1] - off[r] for r in t.order.tolist()]
        assert sorted(t.order.tolist()) == list(range(t.n_tab))
        assert counts == sorted(counts, reverse=True)
    # entries already in row order need no permutation
    inorder = SparseMatPolynomial.from_entries(4, 5, sorted(entries), "cpu")
    assert inorder.by_row.perm is None and m.by_row.perm is not None
    # a diagonal: every index array the identity, so none is stored
    diag = SparseMatPolynomial.from_entries(
        4, 5, [(r, r, 1) for r in range(16)], "cpu")
    for t in (diag.by_row, diag.by_col):
        assert (t.off, t.idx, t.perm, t.order) == (None,) * 4
        assert t.n_tab == 16 and t.n_out == 16 << (t is diag.by_col)


class _EmulatedK9:
    """K9's C entry emulated on host memory with python ints: the short
    rows a thread each in the table's order (skipping the long ones),
    then the chunks, each
    writing its 9-word partial and taking a ticket where its row has more
    than one, the last of them summing the row's partials, as
    ``csrc/fq_spmv.cu`` does."""

    @staticmethod
    def _ints(addr, n, width=4):
        raw = ctypes.string_at(addr, n * width) if n else b""
        return [int.from_bytes(raw[i:i + width], "little", signed=True)
                for i in range(0, len(raw), width)]

    @staticmethod
    def _elem(addr, i, words=8):
        return int.from_bytes(ctypes.string_at(addr + 4 * words * i,
                                               4 * words), "little")

    @staticmethod
    def _put(addr, i, v, words=8):
        ctypes.memmove(addr + 4 * words * i, v.to_bytes(4 * words,
                                                        "little"),
                       4 * words)

    def fq_spmv_launch(self, off, idx, val, perm, order, n_out, n_tab,
                       long_min, chunk, rows, n_chunks, partial, ticket, x,
                       out, stream):
        r_inv = pow(1 << 256, -1, Q)

        def at(a, b, n):  # a[b:b + n], or the identity for a null array
            return self._ints(a + 4 * b, n) if a else range(b, b + n)

        offs = at(off, 0, n_tab + 1)
        slots = at(order, 0, n_tab)
        assert sorted(slots) == list(range(n_tab)) and n_tab <= n_out

        def acc(b, e):
            ids, at_v = at(idx, b, e - b), at(perm, b, e - b)
            return sum(self._elem(val, j) * self._elem(x, i) * r_inv % Q
                       for j, i in zip(at_v, ids))

        for r in slots:
            if offs[r + 1] - offs[r] <= long_min:
                self._put(out, r, acc(offs[r], offs[r + 1]) % Q)
        for r in range(n_tab, n_out):  # past the last non-empty row
            self._put(out, r, 0)
        chunks = [self._ints(chunk + 12 * c, 3) for c in range(n_chunks)]
        longs = self._ints(rows, 2 * (max([c[0] for c in chunks] + [-1]) + 2))
        for c, (l, b, e) in enumerate(chunks):
            row, c0, c1 = longs[2 * l], longs[2 * l + 1], longs[2 * l + 3]
            if c1 - c0 == 1:
                self._put(out, row, acc(b, e) % Q)
                continue
            self._put(partial, c, acc(b, e), 9)
            done = self._ints(ticket + 4 * l, 1)[0]
            ctypes.memmove(ticket + 4 * l, (done + 1).to_bytes(4, "little"),
                           4)
            if done == c1 - c0 - 1:
                total = sum(self._elem(partial, p, 9) for p in range(c0, c1))
                self._put(out, row, total % Q)
        return 0


@pytest.fixture
def emulated_k9(monkeypatch):
    monkeypatch.setattr(spmv._build, "load", lambda name, declare:
                        _EmulatedK9())
    monkeypatch.setattr(spmv._build, "stream_handle", lambda dev: 0)


@pytest.mark.parametrize("case", ["short", "long", "chunked", "empty_rows",
                                  "no_entries", "by_col", "diagonal"])
def test_spmv_k9_wrapper_through_an_emulated_launch(emulated_k9,
                                                    monkeypatch, case):
    """``spmv._k9`` hands K9 the set-up table (offsets, indices, values,
    the threads' row order, the long rows' chunks with their partials and
    zeroed tickets): equal to the plain version, one launch counted as
    ("spmv", nnz).  Edge values 0, 1 and q - 1."""
    rng = random.Random(17)
    vals = [0, 1, Q - 1]
    n_out, n_in = 16, 24
    if case in ("long", "chunked", "by_col"):
        monkeypatch.setattr(spmv, "LONG_ROW", 4)
        monkeypatch.setattr(spmv, "LONG_CHUNK", 3)
    if case == "short":
        ent = [(r, rng.randrange(n_in)) for r in range(n_out)
               for _ in range(rng.randrange(1, 4))]
    elif case in ("long", "chunked", "by_col"):
        # rows 0, 9 and 13 over LONG_ROW: chunks of 3, or one a row
        ent = [(r, rng.randrange(n_in)) for r in range(n_out)
               for _ in range(rng.randrange(0, 3))]
        ent += [(0, rng.randrange(n_in)) for _ in range(11)]
        ent += [(9, 5)] * 6 + [(13, 2)] * 5
        if case == "long":
            monkeypatch.setattr(spmv, "LONG_CHUNK", 64)
    elif case == "empty_rows":
        ent = [(r, rng.randrange(n_in)) for r in (1, 2, 2, 7, 9)]
    elif case == "diagonal":  # offsets and input indices the identity
        ent = [(r, r) for r in range(n_out)]
    else:
        ent = []
    if case == "by_col":
        ent = [(c, r) for r, c in ent]
        n_out, n_in = n_in, n_out
    rng.shuffle(ent)
    out_idx = np.array([e[0] for e in ent], dtype=np.int64)
    in_idx = np.array([e[1] for e in ent], dtype=np.int64)
    v = dense.from_ints(vals + [rng.randrange(Q) for _ in range(len(ent))],
                        "cpu")[:len(ent)]
    t = spmv.SpmvTable(out_idx, in_idx, v, n_out)
    x = dense.from_ints([Q - 1, 0, 1] + _ints(n_in - 3, 18), "cpu")
    per_row = np.diff(t.long_rows[:, 1].numpy()) if t.n_chunks else [1]
    assert (max(per_row) > 1) == (case in ("chunked", "by_col"))
    assert (t.order is None) == (case in ("no_entries", "diagonal"))
    assert (t.perm is None) == (case == "no_entries")
    assert (t.off is None and t.idx is None) == (case in ("no_entries",
                                                          "diagonal"))
    assert (t.n_tab < n_out) == (case in ("empty_rows", "no_entries"))
    assert (t.n_chunks > 0) == (case in ("long", "chunked", "by_col"))
    before = fq.launches["spmv", t.nnz]
    got = spmv._k9(t, x, None)
    assert torch.equal(got, spmv.spmv_plain(t, x))
    assert dense.to_ints(got) == _naive_spmv(
        [(o, i, w) for (o, i), w in zip(ent, dense.to_ints(v))],
        dense.to_ints(x), n_out)
    assert fq.launches["spmv", t.nnz] == before + 1
    # into a view of a larger table, as the evaluation writes its three
    ys = torch.zeros((2, n_out, 8), dtype=torch.int32)
    spmv._k9(t, x, ys[1])
    assert torch.equal(ys[1], got) and not ys[0].any()


@pytest.mark.parametrize("host", ["native", "python"])
def test_evaluate_tables_equals_the_host(host, monkeypatch):
    """eval_sparse_polys by the device path (eq tables, a sparse product
    by row against eq(ry), one dot with eq(rx), one fetch; its plain
    versions on the CPU) against the host's (native C++, or python ints
    without the native library), on a synthetic instance and on a
    matrix with a long row and column, empty rows and edge values."""
    from spartan_tpu_torch.utils import rt

    if host == "native" and not native.available():
        pytest.skip("no native host library")
    if host == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    inst, _, _ = R1CSShape.produce_synthetic(32, 32, 3, seed=5,
                                             device="cpu")
    rng = random.Random(19)
    skew = [(3, rng.randrange(64), rng.choice([1, Q - 1]))
            for _ in range(40)]
    skew += [(rng.randrange(32), 9, rng.randrange(Q)) for _ in range(40)]
    skew += [(0, 0, 0), (31, 63, 1)]
    M = SparseMatPolynomial.from_entries(5, 6, skew, "cpu")
    polys = [inst.A, inst.B, inst.C, M]
    rx, ry = _ints(5, 20), _ints(6, 21)
    f0, _ = rt.snapshot()
    got = SparseMatPolynomial.evaluate_tables(polys, rx, ry)
    assert rt.snapshot()[0] == f0 + 1
    assert got == SparseMatPolynomial.multi_evaluate(polys, rx, ry)
    eqx, eqy = _eq_evals_host(rx), _eq_evals_host(ry)
    assert got[3] == sum(eqx[r] * eqy[c] * v for r, c, v in skew) % Q


@pytest.fixture(scope="module")
def jax_shape():
    """The JAX package's ``R1CSShape.produce_synthetic(16, 16, 2,
    seed=99)``, recorded."""
    return load("r1cs-synthetic")


def _eval_point():
    """(rx, ry) of the evaluation (``record.py`` reads it too)."""
    return _ints(4, 7), _ints(5, 8)


def test_shape_carried_across_from_jax(jax_shape):
    j = jax_shape
    vars_i, inputs_i = to_ints(j["vars"]), to_ints(j["inputs"])
    mats = [(j[f"{m}_rows"], j[f"{m}_cols"], j[f"{m}_vals"]) for m in "ABC"]
    ours = interop.shape_from_jax(16, 16, 2, mats, "cpu")
    assert ours.get_digest() == j["digest"].tobytes()
    assert ours.is_sat(vars_i, inputs_i)
    assert not ours.is_sat([(vars_i[0] + 1) % Q] + vars_i[1:], inputs_i)
    assert ours.evaluate(*_eval_point()) == tuple(to_ints(j["evaluated"]))


def test_synthetic_instance_matches_jax(jax_shape):
    j = jax_shape
    vars_i, inputs_i = to_ints(j["vars"]), to_ints(j["inputs"])
    ours, v, i = R1CSShape.produce_synthetic(16, 16, 2, seed=99,
                                             device="cpu")
    assert (v, i) == (vars_i, inputs_i)
    assert ours.get_digest() == j["digest"].tobytes()
    z = v + [1] + i + [0] * (16 - 3)
    Az, Bz, Cz = (dense.to_ints(t) for t in
                  ours.multiply_vec(dense.from_ints(z, "cpu")))
    assert all((a * b - c) % Q == 0 for a, b, c in zip(Az, Bz, Cz))
