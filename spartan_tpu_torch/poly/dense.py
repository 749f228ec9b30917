"""Dense multilinear polynomials as device eval tables.

A polynomial over ell variables is its 2^ell-entry Boolean-hypercube
evaluation table, an ``(n, 8)`` int32 Fq Montgomery tensor (reference
dense_mlpoly.rs:17-22).  Normal index layout only: the JAX package's
bit-reversed layout existed for its TPU compile cache.
"""

from __future__ import annotations

import torch

from ..core.field import Q
from ..ff import fq, limb


def eq_evals(r: list[int], device=None) -> torch.Tensor:
    """EqPolynomial::evals (dense_mlpoly.rs:68-84): the 2^ell chi table
    for point r, built by ell doubling steps.  r[0] pairs with the MOST
    significant index bit."""
    t = limb.unpack(fq.encode_ints([1], device))
    rs = limb.unpack(fq.encode_ints(r, device))
    for j in range(len(r)):
        hi = fq.mul16(t, rs[j])
        lo = fq.sub16(t, hi)
        t = torch.stack([lo, hi], dim=1).reshape(-1, limb.NLIMBS)
    return limb.pack(t)


def eq_evaluate(r: list[int], rx: list[int]) -> int:
    """eq(r, rx) on the host (dense_mlpoly.rs:59-66)."""
    acc = 1
    for a, b in zip(r, rx):
        acc = acc * ((a * b + (1 - a) * (1 - b)) % Q) % Q
    return acc


def bound_var_top(Z: torch.Tensor, r: int) -> torch.Tensor:
    """bound_poly_var_top (dense_mlpoly.rs:215-223): halve the table,
    new[i] = Z[i] + r*(Z[i+n/2] - Z[i])."""
    n = Z.shape[0] // 2
    z = limb.unpack(Z)
    rm = limb.unpack(fq.mont_limbs(r, Z.device))
    lo, hi = z[:n], z[n:]
    return limb.pack(fq.add16(lo, fq.mul16(rm, fq.sub16(hi, lo))))


def evaluate(Z: torch.Tensor, r: list[int]) -> int:
    """Z~(r) in O(n): <eq_evals(r), Z> (dense_mlpoly.rs:236-242)."""
    chis = eq_evals(r, Z.device)
    assert chis.shape[0] == Z.shape[0]
    return fq.decode_to_ints(fq.dot_mod(chis, Z)[None])[0]


def bound_L(Z: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Matrix-view row combination (dense_mlpoly.rs:206-213): Z viewed as
    (L_size, R_size); returns LZ[i] = sum_j L[j] Z[j, i]."""
    Zm = Z.reshape(L.shape[0], -1, limb.NWORDS)
    return fq.dot_mod(Zm, L[:, None, :], dim=0)


def factored_lens(ell: int) -> tuple[int, int]:
    """compute_factored_lens (dense_mlpoly.rs:86-88)."""
    return ell // 2, ell - ell // 2


def merge_pad(polys: list[torch.Tensor]) -> torch.Tensor:
    """DensePolynomial::merge (dense_mlpoly.rs:258-272): concatenate and
    zero-pad to the next power of two."""
    n = sum(p.shape[0] for p in polys)
    target = 1 << (n - 1).bit_length() if n > 1 else 1
    pad = polys[0].new_zeros((target - n, limb.NWORDS))
    return torch.cat([*polys, pad])


def from_ints(xs: list[int], device=None) -> torch.Tensor:
    """Canonical ints -> Montgomery table on ``device``."""
    return fq.encode_ints(xs, device)


def to_ints(Z: torch.Tensor) -> list[int]:
    return fq.decode_to_ints(Z)
