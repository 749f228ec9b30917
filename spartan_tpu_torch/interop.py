"""Carry state from the JAX package into the port.

The JAX package stores a 256-bit element as ``(..., 16)`` uint32 arrays
of 16-bit limbs; the port stores the same 32 little-endian bytes as
``(..., 8)`` int32 (``ff/limb.py``).  Going across is a reinterpretation
of the bytes.  Every function here takes numpy arrays (``np.asarray``
of the JAX arrays) and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.field import Q
from .curve import edwards as ed
from .ff import fp25519, fq, limb
from .protocols import spark
from .r1cs.shape import R1CSShape, SparseMatPolynomial, _log2


def fq_from_jax(a, device=None) -> torch.Tensor:
    """A JAX array of 16-bit limbs, ``(..., 16)`` (an Fq Montgomery
    table, or any 256-bit values) -> the port's ``(..., 8)`` int32 with
    the same bytes."""
    a = np.asarray(a)
    if a.shape[-1] != limb.NLIMBS or int(a.max(initial=0)) > limb.LIMB_MASK:
        raise ValueError(f"expected (..., 16) limbs below 2^16, got shape "
                         f"{a.shape}")
    words = np.ascontiguousarray(a.astype("<u2")).view("<i4")
    return torch.from_numpy(words.copy()).to(device)


def fq_to_jax(t: torch.Tensor) -> np.ndarray:
    """(..., 8) int32 -> (..., 16) uint32 16-bit limbs (the JAX layout)."""
    words = t.detach().cpu().contiguous().numpy().astype("<i4")
    return words.view("<u2").astype(np.uint32)


def points_from_jax(x, y, z, t, device=None) -> ed.PointArray:
    """A JAX ``PointArray``'s four ``(n, 16)`` coordinate arrays -> the
    port's PointArray (coordinates brought to [0, p))."""
    return ed.PointArray(*(
        fp25519.reduce_canonical(fq_from_jax(c, device))
        for c in (x, y, z, t)))


def sparse_from_jax(num_vars_x: int, num_vars_y: int, rows, cols, vals,
                    device=None) -> SparseMatPolynomial:
    """A JAX ``SparseMatPolynomial``'s ``_rows_np``/``_cols_np`` and
    ``(nnz, 16)`` Montgomery ``vals`` -> the port's."""
    mont = limb.limbs_to_ints(fq_from_jax(vals))
    vals_ints = [v * fq.R_INV % Q for v in mont]
    return SparseMatPolynomial(num_vars_x, num_vars_y, np.asarray(rows),
                               np.asarray(cols), vals_ints, device)


def shape_from_jax(num_cons: int, num_vars: int, num_inputs: int,
                   mats, device=None) -> R1CSShape:
    """An ``R1CSShape``: its sizes and ``(rows, cols, vals)`` of A, B, C
    as in ``sparse_from_jax``."""
    npx, npy = _log2(num_cons), _log2(2 * num_vars)
    A, B, C = (sparse_from_jax(npx, npy, r, c, v, device) for r, c, v in mats)
    return R1CSShape(num_cons, num_vars, num_inputs, A, B, C)


def dense_rep_from_jax(row, col, val, batch_size: int,
                       device=None) -> spark.MultiSparseMatPolynomialAsDense:
    """A JAX ``MultiSparseMatPolynomialAsDense``: ``row`` and ``col`` are
    its ``AddrTimestamps``' ``(ops_addr_int, read_ts_int, audit_ts_int)``
    numpy arrays, ``val`` its ``(B, N, 16)`` Montgomery values -> the
    port's (its Montgomery tables and combined tables built here)."""
    row_t, col_t = (spark.AddrTimestamps(*(np.asarray(a) for a in t),
                                         device) for t in (row, col))
    return spark.MultiSparseMatPolynomialAsDense(
        batch_size, row_t, col_t, fq_from_jax(val, device))
