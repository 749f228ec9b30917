"""The plain version of kernel B2 (``ff.round_kernel.fold_evals``) in all
three modes, against the JAX package's XLA round step: ``dense.
bound_var_top`` then ``sumcheck._evals_cubic_additive`` / ``_evals_quad``
— the path that ``tests/test_pallas.py`` holds the Pallas kernel to.

The JAX step's outputs at three small shapes are recorded in
``tests/golden/port/round-*.npz`` (``record.py``); the larger shape and a
chain of rounds are checked against python-int arithmetic.  Exact:
equality.

The ZK sum-check built on those rounds
(``ZKSumcheckInstanceProof.prove_quad`` /
``prove_cubic_with_additive_term``) proves and verifies on random
tables, its last evaluation commitment held against python ints; its
verifier refuses short and tampered proofs; its round commitments (tape
secrets) never reach the variable-time row-MSM B1; and
``UniPoly.from_evals`` equals Lagrange interpolation over python ints.
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
from spartan_tpu_torch.commitments import MultiCommitGens, commit_scalar
from spartan_tpu_torch.core import ristretto as hri
from spartan_tpu_torch.core.merlin import RandomTape, Transcript
from spartan_tpu_torch.curve import msm as dmsm
from spartan_tpu_torch.curve import row_msm as rm
from spartan_tpu_torch.ff import fq
from spartan_tpu_torch.ff import round_kernel as rk
from spartan_tpu_torch.poly.unipoly import UniPoly
from spartan_tpu_torch.protocols.sumcheck import ZKSumcheckInstanceProof
from spartan_tpu_torch.utils.errors import ProofVerifyError


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


# the ZK sum-check's two combs: tables, degree, and the comb of one entry
ZK_COMBS = {"quad": (2, 2, lambda v: v[0] * v[1]),
            "cubic": (4, 3, lambda v: v[0] * (v[1] * v[2] - v[3]))}
ZK_ROUNDS = 4


def _zk_prove(which, seed, label=b"zk"):
    """A ZK phase over random tables of 2^ZK_ROUNDS entries.  Returns the
    python-int tables, the claim, its blind, the gens and the prover's
    output (proof, r, final claims, last blind)."""
    ntab, deg, comb = ZK_COMBS[which]
    ints = _tables(ntab, 1 << ZK_ROUNDS, seed)
    claim = sum(comb(v) for v in zip(*ints)) % Q
    blind = 4321 + seed
    gens_1 = MultiCommitGens(1, b"gens_1")
    gens_n = MultiCommitGens(deg + 1, b"gens_n")
    prove = (ZKSumcheckInstanceProof.prove_quad if which == "quad" else
             ZKSumcheckInstanceProof.prove_cubic_with_additive_term)
    out = prove(claim, blind, ZK_ROUNDS, *_ours(ints), gens_1, gens_n,
                Transcript(label), RandomTape(b"tape", seed=seed))
    return ints, claim, blind, gens_1, gens_n, out


@pytest.mark.parametrize("which", sorted(ZK_COMBS))
def test_zk_sumcheck_prove_verify(which):
    ints, claim, blind, gens_1, gens_n, out = _zk_prove(which, seed=5)
    proof, r, finals, last_blind = out
    comm_claim = hri.encode(commit_scalar(claim, blind, gens_1))
    comm_eval, r_v = proof.verify(comm_claim, ZK_ROUNDS, ZK_COMBS[which][1],
                                  gens_1, gens_n, Transcript(b"zk"))
    assert r_v == r and len(r) == ZK_ROUNDS
    # the tables bound at r by python ints: the final claims, and the last
    # commitment is to their comb under the returned blind
    for r_j in r:
        ints = _int_round(ints, r_j)
    assert finals == [t[0] for t in ints]
    want = ZK_COMBS[which][2](finals) % Q
    assert comm_eval == proof.comm_evals[-1] == hri.encode(
        commit_scalar(want, last_blind, gens_1))
    with pytest.raises(ProofVerifyError):
        proof.verify(hri.encode(commit_scalar(claim + 1, blind, gens_1)),
                     ZK_ROUNDS, ZK_COMBS[which][1], gens_1, gens_n,
                     Transcript(b"zk"))
    proof.comm_polys[1] = proof.comm_polys[0]
    with pytest.raises(ProofVerifyError):
        proof.verify(comm_claim, ZK_ROUNDS, ZK_COMBS[which][1], gens_1,
                     gens_n, Transcript(b"zk"))


def test_zk_sumcheck_verify_rejects_short_proofs():
    """One dot-product proof fewer than rounds: a ProofVerifyError, not an
    IndexError (ROADMAP queue C)."""
    _, claim, blind, gens_1, gens_n, out = _zk_prove("quad", seed=6)
    proof = out[0]
    short = ZKSumcheckInstanceProof(proof.comm_polys, proof.comm_evals,
                                    proof.proofs[:-1])
    with pytest.raises(ProofVerifyError):
        short.verify(hri.encode(commit_scalar(claim, blind, gens_1)),
                     ZK_ROUNDS, 2, gens_1, gens_n, Transcript(b"zk"))


@pytest.mark.parametrize("which", sorted(ZK_COMBS))
def test_zk_phase_never_commits_secrets_with_b1(which, monkeypatch):
    """The round polynomials, evaluations and sigma nonces are tape
    secrets: the phase commits them on the constant-time host ladder,
    never through the variable-time row-MSM B1."""
    def b1(*a, **k):
        raise AssertionError("B1 launched in a ZK sum-check phase")

    for mod, name in ((rm, "row_msm"), (rm, "row_msm_plain"),
                      (dmsm, "row_msm")):
        monkeypatch.setattr(mod, name, b1)
    proof = _zk_prove(which, seed=7)[-1][0]
    assert len(proof.proofs) == ZK_ROUNDS
    # B1 is blocked, not merely unreached by these sizes
    with pytest.raises(AssertionError, match="B1"):
        dmsm.msm(fq.encode_ints([1]), [MultiCommitGens(1, b"g").G[0]])


@pytest.mark.parametrize("which", sorted(ZK_COMBS))
def test_unipoly_from_evals_against_python_ints(which):
    rng = random.Random(len(which))
    npts = ZK_COMBS[which][1] + 1
    evals = [rng.randrange(Q) for _ in range(npts)]
    poly = UniPoly.from_evals(evals)
    assert poly.degree() == npts - 1

    def lagrange(x):
        acc = 0
        for i, e in enumerate(evals):
            num = den = 1
            for j in range(npts):
                if j != i:
                    num = num * (x - j) % Q
                    den = den * (i - j) % Q
            acc += e * num * pow(den, -1, Q)
        return acc % Q

    for x in [0, 1, 2, 3, rng.randrange(Q), Q - 1]:
        assert poly.evaluate(x) == lagrange(x)
    assert (poly.eval_at_zero(), poly.eval_at_one()) == tuple(evals[:2])
    hint = (evals[0] + evals[1]) % Q
    compressed = poly.compress()
    assert len(compressed) == npts - 1
    assert UniPoly.decompress(compressed, hint).coeffs == poly.coeffs
