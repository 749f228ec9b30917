"""The port's dense polynomials (``poly/dense.py``) and R1CS shape
(``r1cs/shape.py``) against python-int arithmetic and the JAX package's
R1CS shape, carried across through ``interop`` (the JAX shape, its digest
and an evaluation recorded in ``tests/golden/port/r1cs-synthetic.npz``).
"""

import random

import jax  # noqa: F401
import pytest
import torch  # noqa: F401

from golden.port.record import load, to_ints
from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu.core.field import Q
from spartan_tpu.poly.commit import _eq_evals_host
from spartan_tpu_torch import interop
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
