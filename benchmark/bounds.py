"""The least device time of the port's two hand kernels for the work the
protocol needs, from published peaks of one NVIDIA H100 SXM.

A frozen copy of ``chip_smoke.py``'s bound arithmetic (``row_msm_bound``,
``fold_evals_bound``, ``round_chain_bound``), so that later changes to the
program cannot move the yardstick.  Bytes: each input read once and each
output written once, over 3.35 TB/s of HBM.  Operations: 32x32->64-bit
multiply-adds, two IMAD slots each, over 132 SMs x 64 IMAD a clock
x 1.98 GHz.  The larger of the two is the bound.  Everything here counts
from the instance's sizes and the scalars the benchmark made, never from
the program's launch counters, so the same work is counted whatever
implements it.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_S = 3.35e12
IMAD_S = 132 * 64 * 1.98e9
IMAD_PER_WIDE = 2
FP_MUL_WIDE = 64 + 8  # a product mod p: 8x8 schoolbook + the fold
FQ_MUL_WIDE = 64 + 64 + 8  # a Montgomery product mod q (CIOS)
NWINDOWS = 64  # B1's 4-bit windows of a 256-bit scalar


def _seconds(bytes_: float, wide: float) -> float:
    return max(bytes_ / HBM_BYTES_S, wide * IMAD_PER_WIDE / IMAD_S)


# ----------------------------------------------------------------- B2

def fold_evals_s(ntab: int, n: int, mode: str, batch: int = 1) -> float:
    """One launch of B2 on ``batch`` instances of ``ntab`` tables of n
    entries: 2 Montgomery products a pair a table to fold, the comb's
    products at 3 points (6 for the cubic combs, 2 for the quadratic)."""
    out = n // 2 if mode != "evals" else 0
    bytes_ = batch * (ntab * n * 32 + ntab * out * 32 + 96)
    pairs = batch * (n // 4 if mode == "fold_evals" else n // 2)
    folds = 2 * ntab * pairs if mode == "fold_evals" else (
        ntab * pairs if mode == "fold" else 0)
    combs = 0 if mode == "fold" else pairs * (2 if ntab == 2 else 6)
    return _seconds(bytes_, (folds + combs) * FQ_MUL_WIDE)


def sumcheck_launches(ntab: int, log_n: int, batch: int = 1) -> list:
    """B2's launches for one sum-check over tables of 2^log_n: the evals,
    then fold-and-evals a round, the last round a fold."""
    if log_n == 0:
        return []
    n = 1 << log_n
    out = [(ntab, batch, n, "evals")]
    out += [(ntab, batch, n >> k, "fold_evals") for k in range(log_n - 1)]
    out.append((ntab, batch, n >> (log_n - 1), "fold"))
    return out


def product_layer_launches(instances: int, log_leaves: int,
                           extra_at_bottom: int = 0) -> list:
    """B2's launches for one batched product-circuit proof: layer j of
    the tree (2^j products, j rounds) is a cubic sum-check over three
    tables of 2^j, the instances batched; the bottom layer also carries
    ``extra_at_bottom`` dot-product instances."""
    out = []
    for j in range(1, log_leaves):
        batch = instances + (extra_at_bottom if j == log_leaves - 1 else 0)
        out += sumcheck_launches(3, j, batch)
    return out


def sat_proof_launches(num_cons: int, num_vars: int) -> list:
    """Phase one: 4 tables (eq, Az, Bz, Cz) of num_cons; phase two: 2
    tables (Z, the combined evaluations) of 2 num_vars."""
    lx = (num_cons - 1).bit_length()
    ly = (2 * num_vars - 1).bit_length()
    return sumcheck_launches(4, lx) + sumcheck_launches(2, ly)


def spark_launches(num_cons: int, num_vars: int, nnz: int,
                   batch: int = 3) -> list:
    """The eval proof's two batched circuits: 4 batch ops trees over
    next_pow2(nnz) leaves with 2 batch dot-product halves at the bottom,
    and 4 mem trees over the memory's cells."""
    log_ops = (max(nnz, 1) - 1).bit_length()
    cells = max((num_cons - 1).bit_length(), (2 * num_vars - 1).bit_length())
    return (product_layer_launches(4 * batch, log_ops, 2 * batch)
            + product_layer_launches(4, cells))


def launches_s(launches: list) -> float:
    return sum(fold_evals_s(ntab, n, mode, b)
               for ntab, b, n, mode in launches)


# ----------------------------------------------------------------- B1

def nonzero_digits(scalars_le: bytes, L: int, R: int) -> np.ndarray:
    """(L, R, 64) bool: B1's 4-bit windows of the canonical scalars (32
    little-endian bytes each, row-major), least significant first."""
    b = np.frombuffer(scalars_le, dtype=np.uint8).reshape(L, R, 32)
    nib = np.stack([b & 15, b >> 4], axis=-1).reshape(L, R, NWINDOWS)
    return nib != 0


def row_msm_s(nz: np.ndarray) -> float:
    """B1 on (L, R) scalars with these non-zero digits: a mixed add (7
    products) a non-zero digit; per row, 4 doublings (8 products each) a
    window below its top non-zero window and a unified add (9) for each
    lower window with a non-zero digit.  Bytes: the scalars, the
    16-entry table of R generators (96 B an entry) and the L results."""
    L, R = nz.shape[:2]
    madds = int(nz.sum())
    win = nz.any(axis=1)  # (L, 64)
    w = np.arange(NWINDOWS)
    top = np.where(win, w, -1).max(axis=1)  # (L,)
    dbls = 4 * int(np.clip(top, 0, None).sum())
    adds = int((win & (w[None, :] < top[:, None])).sum())
    bytes_ = L * R * 32 + 16 * R * 96 + L * 128
    return _seconds(bytes_, (madds * 7 + adds * 9 + dbls * 8) * FP_MUL_WIDE)


def witness_commit_s(vars_le: bytes, blinds: list[int],
                     num_vars: int) -> float:
    """B1's two launches of the witness commitment: the (L, R) witness
    rows against G, and the L blinds against h."""
    ell = (num_vars - 1).bit_length()
    L, R = 1 << (ell // 2), 1 << (ell - ell // 2)
    blinds_le = b"".join(x.to_bytes(32, "little") for x in blinds)
    return (row_msm_s(nonzero_digits(vars_le, L, R))
            + row_msm_s(nonzero_digits(blinds_le, L, 1)))
