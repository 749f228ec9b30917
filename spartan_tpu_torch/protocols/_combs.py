"""Sumcheck round-evaluation combs (the JAX package's
``protocols/_combs.py``), on the ``(..., 16)`` int64 compute layout of
``ff.fq``.

Per round the prover needs the round polynomial's evaluations at
{0,2,3} (the value at 1 is recovered from the claim): the table is
split into (lo, hi) halves pairing index i with i + n/2, the comb is
evaluated at extrapolated points p_t = lo + t*(hi - lo), and the lane
results are summed (reference sumcheck.rs:199-228).  The plain version
of kernel B2 (``ff/round_kernel.py``) is built on these formulas; the
kernel (``csrc/fold_evals.cu``) repeats them per thread.  Tables may
carry leading batch axes, ``(..., n, 16)``: the halves and the sums run
along the ``n`` axis, one set of evals per instance (the product-tree
layers batch their circuits so, ``protocols/product_tree.py``).
"""

from __future__ import annotations

from ..ff import fq

NTABLES = {"quad": 2, "cubic": 4, "cubic_prod": 3}
NEVALS = {"quad": 2, "cubic": 3, "cubic_prod": 3}


def comb16(which: str, tabs):
    """quad: A*B; cubic: A*(B*C - D) (r1csproof.rs:85-89); cubic_prod:
    A*B*C (product_tree.rs)."""
    if which == "quad":
        a, b = tabs
        return fq.mul16(a, b)
    if which == "cubic":
        a, b, c, d = tabs
        return fq.mul16(a, fq.sub16(fq.mul16(b, c), d))
    if which == "cubic_prod":
        a, b, c = tabs
        return fq.mul16(fq.mul16(a, b), c)
    raise ValueError(which)


def evals16(which: str, tables) -> list:
    """Round evals of the ``which`` comb over ``tables`` ((..., n, 16)
    int64 Montgomery): [e0, e2] for quad, [e0, e2, e3] for the cubic
    combs, each (..., 16)."""
    n = tables[0].shape[-2] // 2
    lo = [T[..., :n, :] for T in tables]
    hi = [T[..., n:, :] for T in tables]
    e0 = fq.sum16(comb16(which, lo), dim=-2)
    p2 = [fq.sub16(fq.add16(h, h), l) for h, l in zip(hi, lo)]
    e2 = fq.sum16(comb16(which, p2), dim=-2)
    if which == "quad":
        return [e0, e2]
    p3 = [fq.add16(x2, fq.sub16(h, l)) for x2, h, l in zip(p2, hi, lo)]
    return [e0, e2, fq.sum16(comb16(which, p3), dim=-2)]
