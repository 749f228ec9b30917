"""The plain version of kernel B2 (``ff.round_kernel.fold_evals``) in all
three modes, against the JAX package's XLA round step: ``dense.
bound_var_top`` then ``sumcheck._evals_cubic_additive`` / ``_evals_quad``
— the path that ``tests/test_pallas.py`` holds the Pallas kernel to.

The JAX step's outputs at three small shapes are recorded in
``tests/golden/port/round-*.npz`` (``record.py``); the larger shape and a
chain of rounds are checked against python-int arithmetic.  Exact:
equality.
"""

import random

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from golden.port.record import load, to_ints
from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu.core.field import Q
from spartan_tpu_torch import interop
from spartan_tpu_torch.ff import fq
from spartan_tpu_torch.ff import round_kernel as rk


def _tables(ntab, n, seed):
    rng = random.Random(seed)
    return [[0, Q - 1] + [rng.randrange(Q) for _ in range(n - 2)]
            for _ in range(ntab)]


def _ours(ints):
    return [fq.encode_ints(t) for t in ints]


def _round_inputs(ntab, n):
    """The tables and the challenge r (``record.py`` reads them too)."""
    return _tables(ntab, n, seed=ntab * 1000 + n), 987654321


@pytest.mark.parametrize("ntab,n", [(4, 8), (4, 64), (2, 8)])
def test_fold_evals_plain_matches_jax_round(ntab, n):
    ints, r = _round_inputs(ntab, n)
    jax_round = load(f"round-{ntab}-{n}")
    k = 3 if ntab == 4 else 2

    # round 0: evals over the tables themselves
    _, es = rk.fold_evals(_ours(ints), None, "evals")
    assert fq.decode_to_ints(es)[:k] == to_ints(jax_round["evals"])

    # fold by r, then the next round's evals; and the fold alone
    want_t = to_ints(jax_round["tables"])
    want_e = to_ints(jax_round["folded_evals"])
    tabs, es = rk.fold_evals(_ours(ints), r, "fold_evals")
    assert [fq.decode_to_ints(t) for t in tabs] == want_t
    assert fq.decode_to_ints(es)[:k] == want_e
    # the port's tables carry across to the JAX layout byte for byte
    for t, T in zip(tabs, jax_round["folded"]):
        assert np.array_equal(interop.fq_to_jax(t), T)
    tabs, es = rk.fold_evals(_ours(ints), r, "fold")
    assert [fq.decode_to_ints(t) for t in tabs] == want_t and es is None


def _int_round(T, r):
    h = len(T[0]) // 2
    return [[(t[j] + r * (t[j + h] - t[j])) % Q for j in range(h)] for t in T]


def _int_evals(T):
    h = len(T[0]) // 2
    out = []
    for X in (0, 2, 3):
        s = 0
        for j in range(h):
            v = [(t[j] + X * (t[j + h] - t[j])) % Q for t in T]
            s += v[0] * (v[1] * v[2] - v[3]) if len(T) == 4 else v[0] * v[1]
        out.append(s % Q)
    if len(T) == 2:
        out[2] = 0
    return out


@pytest.mark.parametrize("ntab", [4, 2])
def test_fold_evals_plain_chain_vs_ints(ntab):
    """n = 4096: evals, two fold-and-evals rounds, then the last fold."""
    ints = _tables(ntab, 4096, seed=7 + ntab)
    tabs, es = rk.fold_evals(_ours(ints), None, "evals")
    assert fq.decode_to_ints(es) == _int_evals(ints)
    for r in (123, Q - 1):
        ints = _int_round(ints, r)
        tabs, es = rk.fold_evals(tabs, r, "fold_evals")
        assert [fq.decode_to_ints(t) for t in tabs] == ints
        assert fq.decode_to_ints(es) == _int_evals(ints)
    ints = _int_round(ints, 5)
    tabs, es = rk.fold_evals(tabs, 5, "fold")
    assert [fq.decode_to_ints(t) for t in tabs] == ints and es is None


def test_fold_evals_checks_inputs():
    t = fq.encode_ints([1, 2, 3, 4])
    with pytest.raises(ValueError):
        rk.fold_evals([t, t, t], 1, "fold")  # 3 tables
    with pytest.raises(ValueError):
        rk.fold_evals([t, t], 1, "bogus")
    with pytest.raises(ValueError):
        rk.fold_evals([t, fq.encode_ints([1, 2])], 1, "fold")
    with pytest.raises(ValueError):
        rk.fold_evals([t[:3], t[:3]], None, "evals")  # not a power of 2
    with pytest.raises(ValueError):
        rk.fold_evals([t, t], None, "fold")  # no challenge
    with pytest.raises(ValueError):
        rk.fold_evals([t, t], 3, "evals")
    assert torch.equal(rk.fold_evals([t, t], None, "evals")[0][0], t)
