"""The port's Spark pieces on the CPU against the JAX package and python
ints.

* Kernel B2's batched 3-table (cubic_prod) mode, plain version, in all
  three modes against the JAX product-tree round step
  (``product_tree._evals_cubic_batched``, ``_bound_var_top_batched``) at
  one tiny shape, its outputs recorded in
  ``tests/golden/port/spark-cubic-prod.npz``, and along a chain of
  rounds against python ints.  Exact: equality.
* ``AddrTimestamps`` against the JAX package's (its numpy part only: the
  JAX device tables are not built, so nothing compiles).
* ``interop.dense_rep_from_jax`` against the port's own
  ``multi_sparse_to_dense_rep`` on the golden instance, and both against
  the JAX package's combined tables (its dense representation recorded
  in ``tests/golden/port/spark-dense-rep.npz``).
* ``ProductCircuitEvalProofBatched`` and the clear-text
  ``SumcheckInstanceProof`` prove -> verify on random tables, the final
  claims held against direct evaluations.
"""

import random

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from golden.port.record import load, to_ints
from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu.protocols import spark as jspark
from spartan_tpu_torch import interop
from spartan_tpu_torch.api import Instance
from spartan_tpu_torch.core.field import Q
from spartan_tpu_torch.core.merlin import Transcript
from spartan_tpu_torch.ff import fq
from spartan_tpu_torch.ff import round_kernel as rk
from spartan_tpu_torch.poly import dense
from spartan_tpu_torch.protocols import spark
from spartan_tpu_torch.protocols.product_tree import (
    DotProductCircuitBatch, LayerProofBatched, ProductCircuitBatch,
    ProductCircuitEvalProofBatched)
from spartan_tpu_torch.protocols.sumcheck import SumcheckInstanceProof
from spartan_tpu_torch.utils.errors import ProofVerifyError


def _ints(shape, seed):
    """Random residues with 0 and q - 1 first, nested lists of ``shape``."""
    rng = random.Random(seed)
    b, n = shape
    return [[0, Q - 1] + [rng.randrange(Q) for _ in range(n - 2)]
            for _ in range(b)]


def _ours(tab):
    b, n = len(tab), len(tab[0])
    return fq.encode_ints([v for row in tab for v in row]).reshape(b, n, 8)


def _decoded(t):
    """(B, n, 8) or (3, B, 8) -> nested lists of ints per leading index."""
    return [fq.decode_to_ints(x) for x in t]


def _cubic_prod_inputs():
    """Three (5, 8) tables and the challenge r (``record.py`` reads them
    too): 5 instances, a batch no JAX test compiles these functions at."""
    return [_ints((5, 8), seed=k) for k in range(3)], 987654321


def test_cubic_prod_plain_matches_jax_round():
    ints, r = _cubic_prod_inputs()
    ours = [_ours(t) for t in ints]
    jax_round = load("spark-cubic-prod")
    folded = to_ints(jax_round["tables"])

    # round 0: evals over the tables themselves
    _, es = rk.fold_evals_plain(ours, None, "evals")
    assert _decoded(es) == to_ints(jax_round["evals"])

    # the fold alone, and the fold then the next round's evals
    tabs, es = rk.fold_evals_plain(ours, r, "fold")
    assert es is None
    assert [_decoded(t) for t in tabs] == folded
    tabs, es = rk.fold_evals_plain(ours, r, "fold_evals")
    assert [_decoded(t) for t in tabs] == folded
    assert _decoded(es) == to_ints(jax_round["folded_evals"])


def _py_fold(T, r):
    m = len(T) // 2
    return [(T[j] + r * (T[m + j] - T[j])) % Q for j in range(m)]


def _py_evals(A, B, C):
    m = len(A) // 2
    out = []
    for x in (0, 2, 3):
        acc = 0
        for j in range(m):
            p = 1
            for T in (A, B, C):
                p = p * (T[j] + x * (T[m + j] - T[j])) % Q
            acc += p
        out.append(acc % Q)
    return out


def test_cubic_prod_chain_against_python_ints():
    """(5, 32): evals, then fold_evals three times, then the last fold."""
    ints = [_ints((5, 32), seed=10 + k) for k in range(3)]
    rs = [123456789, Q - 1, 3 ** 150 % Q, 7]
    tabs, es = rk.fold_evals(
        [_ours(t) for t in ints], None, "evals")
    for k, r in enumerate(rs):
        per_instance = [_py_evals(*(t[b] for t in ints)) for b in range(5)]
        assert _decoded(es) == [list(e) for e in zip(*per_instance)]
        ints = [[_py_fold(row, r) for row in t] for t in ints]
        mode = "fold_evals" if k + 1 < len(rs) else "fold"
        tabs, es = rk.fold_evals(tabs, r, mode)
        assert [_decoded(t) for t in tabs] == ints
    assert es is None and tabs[0].shape == (5, 2, 8)


def test_fold_evals_checks_the_batched_shape():
    t = [torch.zeros((2, 8, 8), dtype=torch.int32)] * 3
    with pytest.raises(ValueError):
        rk.fold_evals([x[0] for x in t], None, "evals")  # (n, 8): unbatched
    with pytest.raises(ValueError):
        rk.fold_evals([x[:, :6] for x in t], None, "evals")  # n not 2^k
    with pytest.raises(ValueError):
        rk.fold_evals([x[:, :2] for x in t], 5, "fold_evals")  # n < 4


def test_addr_timestamps_match_jax(monkeypatch):
    # the JAX package's timestamps are numpy; its device tables are not
    # built here (they would compile)
    monkeypatch.setattr(jspark, "_usize_table", np.asarray)
    rng = np.random.default_rng(7)
    ops_addr = rng.integers(0, 64, size=(3, 128))
    ops_addr[1, :40] = 5  # a hot cell
    ours = spark.AddrTimestamps.build(64, ops_addr, "cpu")
    theirs = jspark.AddrTimestamps(64, 128, ops_addr)
    for name in ("ops_addr_int", "read_ts_int", "audit_ts_int"):
        assert np.array_equal(getattr(ours, name), getattr(theirs, name))
    assert fq.decode_to_ints(ours.read_ts.flatten(0, 1)) == \
        ours.read_ts_int.reshape(-1).tolist()
    assert int(ours.audit_ts_int.sum()) == ops_addr.size


def test_dense_rep_from_jax_matches_the_ports_own():
    j = load("spark-dense-rep")
    inst, _, _ = Instance.produce_synthetic_r1cs(16, 16, 2, seed=424242,
                                                 device="cpu")
    own = spark.multi_sparse_to_dense_rep([inst.inst.A, inst.inst.B,
                                           inst.inst.C])
    got = interop.dense_rep_from_jax(
        *((j[f"{t}_ops_addr_int"], j[f"{t}_read_ts_int"],
           j[f"{t}_audit_ts_int"]) for t in ("row", "col")),
        j["val"], int(j["batch_size"]), "cpu")
    assert got.batch_size == own.batch_size == 3
    for a, b in ((got.row, own.row), (got.col, own.col)):
        for name in ("ops_addr_int", "read_ts_int", "audit_ts_int"):
            assert np.array_equal(getattr(a, name), getattr(b, name))
        for name in ("ops_addr", "read_ts", "audit_ts"):
            assert torch.equal(getattr(a, name), getattr(b, name))
    assert torch.equal(got.val, own.val)
    assert torch.equal(got.comb_ops, own.comb_ops)
    assert torch.equal(got.comb_mem, own.comb_mem)
    assert torch.equal(own.comb_ops, interop.fq_from_jax(j["comb_ops"]))
    assert torch.equal(own.comb_mem, interop.fq_from_jax(j["comb_mem"]))


def _evaluate(tab_ints, r):
    return dense.evaluate(fq.encode_ints(tab_ints), r)


def test_product_circuit_prove_verify():
    B, n = 3, 16
    leaves = _ints((B, n), seed=3)
    for b in range(B):
        leaves[b][0] = b + 1  # roots other than zero
    halves = [_ints((2, n // 2), seed=4 + k) for k in range(3)]  # L, R, W
    prod = ProductCircuitBatch(_ours(leaves))
    roots = prod.evaluate()
    for b in range(B):
        want = 1
        for v in leaves[b]:
            want = want * v % Q
        assert roots[b] == want
    dotp = DotProductCircuitBatch(*(_ours(h) for h in halves))
    dotp_vals = dotp.evaluate()
    assert dotp_vals == [sum(x * y % Q * z for x, y, z in
                             zip(*(h[k] for h in halves))) % Q
                         for k in range(2)]

    proof, rand = ProductCircuitEvalProofBatched.prove(
        prod, dotp, Transcript(b"pc"))
    claims, claims_dotp, rand_v = proof.verify(roots, dotp_vals, n,
                                               Transcript(b"pc"))
    assert rand_v == rand and len(rand) == 4
    # the final claims are the leaf polynomials at rand; the dot-product
    # ones are the whole (two-half) tables at rand
    assert claims == [_evaluate(leaves[b], rand) for b in range(B)]
    assert claims_dotp == [_evaluate(h[0] + h[1], rand) for h in halves]

    proof.proof[2].claims_prod_left[0] += 1
    with pytest.raises(ProofVerifyError):
        proof.verify(roots, dotp_vals, n, Transcript(b"pc"))


def test_clear_sumcheck_prove_cubic_verify():
    n, rounds = 32, 5
    A, Bt, C = _ints((3, n), seed=21)
    claim = sum(a * b % Q * c for a, b, c in zip(A, Bt, C)) % Q
    tabs = [fq.encode_ints(t) for t in (A, Bt, C)]
    proof, r, finals = SumcheckInstanceProof.prove_cubic(
        claim, rounds, tabs, Transcript(b"sc"))
    e, r_v = proof.verify(claim, rounds, 3, Transcript(b"sc"))
    assert r_v == r
    assert finals == [_evaluate(t, r) for t in (A, Bt, C)]
    assert e == finals[0] * finals[1] % Q * finals[2] % Q
    # a wrong claim leads to another last claim (the compressed form
    # takes the linear term from the claim, so the rounds themselves hold)
    assert proof.verify(claim + 1, rounds, 3, Transcript(b"sc"))[0] != e
    # a round polynomial of the wrong length is refused, not indexed (the
    # JAX package's verifier raises IndexError on [], ROADMAP queue C)
    for bad in ([], [1, 2]):
        short = SumcheckInstanceProof([bad] + proof.compressed_polys[1:])
        with pytest.raises(ProofVerifyError):
            short.verify(claim, rounds, 3, Transcript(b"sc"))


def test_product_proof_rejects_short_dotp_claims():
    """A one-layer proof whose dot-product claims are one triple short of
    the two claims it is checked against, the layer claim made to match:
    a ProofVerifyError (the JAX package's verifier indexes past the
    triple and raises IndexError, ROADMAP queue C)."""
    c = Transcript(b"y").challenge_vector(b"rand_coeffs_next_layer", 3)
    dl = (c[1] * 7 + c[2] * 9) * pow(c[1], -1, Q) % Q
    proof = ProductCircuitEvalProofBatched(
        [LayerProofBatched(SumcheckInstanceProof([]), [3], [5])],
        ([dl], [1], [1]))
    with pytest.raises(ProofVerifyError, match="dotp claim count"):
        proof.verify([15], [7, 9], 2, Transcript(b"y"))
