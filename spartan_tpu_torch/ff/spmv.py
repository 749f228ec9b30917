"""The Fq sparse product: ``out[r] = sum of val * x[idx]`` over the
non-zeros of output r, Montgomery in and out.

A matrix is laid out once, in set-up, as a ``SpmvTable`` sorted by
output index: the R1CS shape builds one by row (Az, Bz, Cz and the
evaluation at (rx, ry)) and one by column (the eval tables) for each of
A, B and C.  ``spmv`` launches kernel K9 (``csrc/fq_spmv.cu``) for
tensors on the card and runs the plain version ``spmv_plain`` (torch's
int64 limb ops: gather, ``fq.mul16``, ``index_add_``, one wide
reduction) for tensors on the CPU; there is no fallback from one to the
other.  Launches are counted in ``fq.launches`` as ("spmv", nnz).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from . import fq, limb

# Rows of more non-zeros than LONG_ROW are cut into chunks of at most
# LONG_CHUNK, a block of K9 a chunk; shorter rows take a thread each.
LONG_ROW = 32
LONG_CHUNK = 2048


class SpmvTable:
    """One orientation of a sparse matrix for ``spmv``, of n_out outputs
    of which the first n_tab (the last non-empty one's index plus one)
    are listed: ``off`` ((n_tab + 1,) int32: the non-zeros of output r
    are entries off[r] .. off[r + 1] - 1), ``idx`` ((nnz,) int32 input
    indices, n_in their largest plus one) and ``vals``, the matrix's own
    (nnz, 8) Montgomery table, entry j's value vals[perm[j]] (``perm``,
    (nnz,) int32): no value is copied.  ``order`` ((n_tab,) int32) lists
    the rows longest first, the order K9's threads take them in, so that
    a warp's rows have one length.  Each of these four is None where it
    would be the identity: ``off`` for one non-zero an output, ``perm``
    for values already in output order, ``order`` where the lengths
    already fall.  Rows of more than LONG_ROW non-zeros are
    listed in ``long_rows`` ((L + 1, 2) int32: output row and first
    chunk, the last entry's first chunk the number of chunks) and cut
    into ``chunks`` ((C, 3) int32: long row, begin, end); both None
    without such rows."""

    def __init__(self, out_idx: np.ndarray, in_idx: np.ndarray,
                 vals: torch.Tensor, n_out: int):
        out_idx = np.asarray(out_idx, dtype=np.int64)
        in_idx = np.asarray(in_idx, dtype=np.int64)
        nnz = len(out_idx)
        if nnz >= 1 << 31 or len(in_idx) != nnz or vals.shape[0] != nnz:
            raise ValueError(f"spmv table: {nnz} non-zeros, "
                             f"{len(in_idx)} indices, {vals.shape[0]} values")
        if nnz and not (0 <= out_idx.min() and out_idx.max() < n_out
                        and 0 <= in_idx.min() and in_idx.max() < 1 << 31):
            raise ValueError(f"spmv table: an index outside {n_out} x 2^31")
        dev = vals.device
        self.n_out, self.nnz, self.vals = n_out, nnz, vals
        self.n_in = int(in_idx.max()) + 1 if nnz else 0
        self.n_tab = int(out_idx.max()) + 1 if nnz else 0
        counts = np.bincount(out_idx, minlength=self.n_tab)
        off = np.zeros(self.n_tab + 1, dtype=np.int64)
        np.cumsum(counts, out=off[1:])
        perm = np.argsort(out_idx, kind="stable")
        order = np.argsort(-counts, kind="stable")
        self.off, self.idx, self.perm, self.order = (
            _index(a, dev) for a in (off, in_idx[perm], perm, order))
        self.chunks = self.long_rows = None
        long = np.flatnonzero(counts > LONG_ROW)
        if len(long):
            per = -(-counts[long] // LONG_CHUNK)
            first = np.zeros(len(long) + 1, dtype=np.int64)
            np.cumsum(per, out=first[1:])
            row = np.repeat(np.arange(len(long)), per)
            begin = off[long][row] + (np.arange(first[-1]) - first[row]) \
                * LONG_CHUNK
            end = np.minimum(begin + LONG_CHUNK, off[long + 1][row])
            self.chunks = torch.from_numpy(np.stack(
                [row, begin, end], 1).astype(np.int32)).to(dev)
            self.long_rows = torch.from_numpy(np.stack(
                [np.append(long, 0), first], 1).astype(np.int32)).to(dev)

    @property
    def n_chunks(self) -> int:
        return 0 if self.chunks is None else self.chunks.shape[0]

    @property
    def n_long(self) -> int:
        return 0 if self.long_rows is None else self.long_rows.shape[0] - 1


def _index(a: np.ndarray, dev) -> torch.Tensor | None:
    """``a`` as an int32 tensor on ``dev``, or None for the identity."""
    if np.array_equal(a, np.arange(len(a))):
        return None
    return torch.from_numpy(a.astype(np.int32)).to(dev)


def _at(a: torch.Tensor | None, n: int, dev) -> torch.Tensor:
    return torch.arange(n, device=dev) if a is None else a.long()


def spmv_plain(t: SpmvTable, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K9: the products of the compute
    layout added into int64 limb columns (exact for up to 2^47 entries an
    output) and reduced once.  Its calls on CUDA tensors are counted in
    ``cuda_calls``: the main path makes none."""
    if x.is_cuda:
        spmv_plain.cuda_calls += 1
    dev = x.device
    off = _at(t.off, t.n_tab + 1, dev)
    rows = torch.repeat_interleave(torch.arange(t.n_tab, device=dev),
                                   off[1:] - off[:-1], output_size=t.nnz)
    prod = fq.mul16(limb.unpack(t.vals[_at(t.perm, t.nnz, dev)]),
                    limb.unpack(x)[_at(t.idx, t.nnz, dev)])
    acc = torch.zeros((t.n_out, limb.NLIMBS), dtype=torch.int64,
                      device=dev)
    acc.index_add_(0, rows, prod)
    return fq.reduce_wide(acc)


spmv_plain.cuda_calls = 0


def _declare(lib) -> None:
    p, i64 = ctypes.c_void_p, ctypes.c_long
    lib.fq_spmv_launch.argtypes = [p, p, p, p, p, i64, i64, i64, p, p, i64,
                                   p, p, p, p, p]
    lib.fq_spmv_launch.restype = ctypes.c_int


def _k9(t: SpmvTable, x: torch.Tensor, out) -> torch.Tensor:
    dev = x.device
    if out is None:
        out = torch.empty((t.n_out, limb.NWORDS), dtype=torch.int32,
                          device=dev)
    x = x.contiguous()
    partial = ticket = None
    if t.n_chunks:
        partial = torch.empty(t.n_chunks * 9, dtype=torch.int32, device=dev)
        ticket = torch.zeros(t.n_long, dtype=torch.int32, device=dev)
    _build.check_aligned("spmv", t.vals, x, out)

    def ptr(y):
        return y.data_ptr() if y is not None else None

    lib = _build.load("fq_spmv", _declare)
    rc = lib.fq_spmv_launch(ptr(t.off), ptr(t.idx),
                            t.vals.data_ptr(), ptr(t.perm), ptr(t.order),
                            t.n_out, t.n_tab, LONG_ROW,
                            ptr(t.chunks), ptr(t.long_rows), t.n_chunks,
                            ptr(partial), ptr(ticket), x.data_ptr(),
                            out.data_ptr(), _build.stream_handle(dev))
    fq.launches["spmv", t.nnz] += 1
    _build.check(rc, "spmv")
    return out


def spmv(t: SpmvTable, x: torch.Tensor, out: torch.Tensor | None = None
         ) -> torch.Tensor:
    """The sparse product of ``t`` with the (n, 8) Montgomery table ``x``
    (n >= t.n_in, on the table's device): the (t.n_out, 8) Montgomery
    table of each output's sum of val * x[idx].  ``out``, a contiguous
    int32 tensor of that shape on the device that overlaps no operand,
    receives the result and is returned."""
    dev = fq._device("spmv", x, t.vals)
    if x.dim() != 2 or x.shape[0] < t.n_in:
        raise ValueError(f"spmv: an (n, 8) table with n >= {t.n_in}, got "
                         f"{tuple(x.shape)}")
    fq._check_out("spmv", out, (t.n_out, limb.NWORDS), dev)
    if dev.type == "cpu":
        res = spmv_plain(t, x)
        return res if out is None else out.copy_(res)
    return _k9(t, x, out)
