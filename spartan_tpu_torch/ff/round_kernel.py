"""Kernel B2, the fused sum-check round.

``fold_evals`` launches the CUDA kernel (``csrc/fold_evals.cu``) for
tensors on the card and runs ``fold_evals_plain`` for tensors on the
CPU; there is no fallback from one to the other.  It replaces the TPU
kernel ``spartan_tpu/ff/pallas_kernels.py:211`` (``_fold_evals_kernel``,
wrapped by ``fold_evals_pairs``/``fold_evals``), whose dataflow is the
JAX prover's round step (``protocols/sumcheck.py::_fold_then_evals``).

``tables`` are 2 (quad comb A*B) or 4 (cubic comb A*(B*C - D)) ``(n, 8)``
int32 Montgomery tables of one power-of-two size, or 3 (cubic_prod comb
A*B*C) ``(B, n, 8)`` tables: B instances, each folded and evaluated on
its own (the product-tree layers' batched round, the JAX package's
``protocols/product_tree.py:33-113``).  Modes:

* ``"evals"``: round 0 — evals of the round polynomial over the tables;
* ``"fold_evals"``: bind the top variable to ``r`` (F[j] = T[j] +
  r*(T[j+n/2] - T[j])), then the evals over the folded tables;
* ``"fold"``: the last round's fold only.

Returns ``(tables_out, evals)``: the folded tables (the inputs in
``"evals"`` mode) and a ``(3, 8)`` Montgomery tensor of the evals at
X = 0, 2, 3 (X = 3 is zero for the quad comb; ``(3, B, 8)``, one column
an instance, for the batched comb; ``None`` in ``"fold"`` mode).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from .. import _build
from ..core.field import Q
from ..protocols import _combs
from . import fq, limb

MODES = {"evals": 0, "fold_evals": 1, "fold": 2}
BLOCK = 128  # threads per block of the CUDA kernel
BLOCKS_PER_SM = 4  # the kernel's __launch_bounds__ residency
_PARTIAL_WORDS = 27  # a block's three 9-word sums
_WHICH = {2: "quad", 3: "cubic_prod", 4: "cubic"}


class _FqArg(ctypes.Structure):
    _fields_ = [("v", ctypes.c_uint32 * 8)]


def _declare(lib) -> None:
    p = ctypes.c_void_p
    lib.fold_evals_launch.argtypes = (
        [p] * 8 + [ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                   _FqArg, p, ctypes.c_int, p, p, p, p])
    lib.fold_evals_launch.restype = ctypes.c_int


def _grid(batch: int, n: int, mode: str, device) -> int:
    """Blocks of the launch, ``batch`` times the blocks of one instance:
    together about one full wave (BLOCKS_PER_SM a multiprocessor)
    striding over the pairs, fewer when there are fewer pairs, and at
    least one an instance."""
    pairs = n // 4 if mode == "fold_evals" else n // 2
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per = max(1, min(BLOCKS_PER_SM * sms // batch, -(-pairs // BLOCK)))
    return batch * per


def fold_evals_plain(tables, r, mode: str):
    """The plain PyTorch version of the kernel (same outputs).  Its calls
    on CUDA tensors are counted in ``cuda_calls``: the main path makes
    none."""
    if tables[0].is_cuda:
        fold_evals_plain.cuda_calls += 1
    T = [limb.unpack(t) for t in tables]
    out = list(tables)
    if mode != "evals":
        rm = limb.unpack(r if isinstance(r, torch.Tensor)
                         else fq.mont_limbs(r, tables[0].device))
        m = T[0].shape[-2] // 2
        T = [fq.add16(t[..., :m, :],
                      fq.mul16(rm, fq.sub16(t[..., m:, :], t[..., :m, :])))
             for t in T]
        out = [limb.pack(t) for t in T]
        if mode == "fold":
            return out, None
    es = _combs.evals16(_WHICH[len(T)], T)
    es += [torch.zeros_like(es[0])] * (3 - len(es))
    return out, limb.pack(torch.stack(es))


fold_evals_plain.cuda_calls = 0


def _check(tables, r, mode: str) -> tuple[int, int]:
    """(batch, n) of valid arguments; raises on anything else."""
    if mode not in MODES:
        raise ValueError(f"fold_evals: unknown mode {mode!r}")
    if (r is None) != (mode == "evals"):
        raise ValueError(f"fold_evals: mode {mode!r} takes "
                         f"{'no' if mode == 'evals' else 'a'} challenge")
    if isinstance(r, torch.Tensor) and (
            r.shape != (limb.NWORDS,) or r.dtype != torch.int32
            or r.device != tables[0].device):
        raise ValueError("fold_evals: a device challenge is an (8,) int32 "
                         "Montgomery tensor on the tables' device")
    if len(tables) not in _WHICH:
        raise ValueError(f"fold_evals: 2, 3 or 4 tables, got {len(tables)}")
    batched = len(tables) == 3
    shape = tables[0].shape
    if len(shape) != 2 + batched or shape[-1] != limb.NWORDS:
        raise ValueError(f"fold_evals: {len(tables)} tables must be "
                         f"{'(B, n, 8)' if batched else '(n, 8)'}, got "
                         f"{tuple(shape)}")
    for t in tables:
        if (t.shape != shape or t.dtype != torch.int32
                or t.device != tables[0].device):
            raise ValueError("fold_evals: tables must be int32 of one shape "
                             "on one device")
    batch, n = (shape[0] if batched else 1), shape[-2]
    least = 4 if mode == "fold_evals" else 2
    if n < least or n & (n - 1) or batch < 1:
        raise ValueError(f"fold_evals: mode {mode!r} needs a power-of-two "
                         f"size >= {least} and an instance, got "
                         f"{tuple(shape)}")
    return batch, n


def fold_evals(tables, r, mode: str):
    """Kernel B2 on the card, its plain version on the CPU.  ``r`` is the
    challenge: a Python int (passed by value), or an (8,) int32
    Montgomery tensor on the tables' device that the kernel reads
    through a pointer (the device prover's squeezed challenges; no
    fetch).  Launches are counted in ``fold_evals.launches``, a Counter
    keyed by (comb, batch, n, mode); those with a device ``r`` also in
    ``fold_evals.launches_device_r``."""
    batch, n = _check(tables, r, mode)
    dev = tables[0].device
    if dev.type == "cpu":
        return fold_evals_plain(tables, r, mode)
    if dev.type != "cuda":
        raise ValueError(f"fold_evals: unsupported device {dev}")
    lib = _build.load("fold_evals", _declare)
    ins = [t.contiguous() for t in tables]
    _build.check_aligned("fold_evals", *ins)
    half = (*tables[0].shape[:-2], n // 2, limb.NWORDS)
    outs = ([torch.empty(half, dtype=torch.int32, device=dev) for _ in ins]
            if mode != "evals" else [])
    nblocks = _grid(batch, n, mode, dev)
    partial = ticket = evals = None
    if mode != "fold":
        # the blocks' partial sums, then the zeroed counter by which the
        # last block finds itself: a launch's own, so launches on other
        # streams cannot share it
        scratch = torch.zeros(nblocks * _PARTIAL_WORDS + 1,
                              dtype=torch.int32, device=dev)
        partial, ticket = scratch[:-1], scratch[-1:]
        evals = torch.empty((3, *tables[0].shape[:-2], limb.NWORDS),
                            dtype=torch.int32, device=dev)
    rarg = _FqArg()
    rdev = None
    if isinstance(r, torch.Tensor):
        rdev = r.contiguous()
    elif r is not None:
        rm = (r % Q) * fq.R % Q
        for k in range(8):
            rarg.v[k] = (rm >> (32 * k)) & 0xFFFFFFFF

    def ptrs(ts):
        return [t.data_ptr() for t in ts] + [None] * (4 - len(ts))

    def ptr(t):
        return t.data_ptr() if t is not None else None

    rc = lib.fold_evals_launch(
        *ptrs(ins), *ptrs(outs), len(ins), n, batch, MODES[mode], rarg,
        ptr(rdev), nblocks, ptr(partial), ptr(ticket), ptr(evals),
        _build.stream_handle(dev))
    fold_evals.launches[_WHICH[len(ins)], batch, n, mode] += 1
    fold_evals.launches_device_r += rdev is not None
    _build.check(rc, "fold_evals")
    return (outs if mode != "evals" else ins), evals


fold_evals.launches = collections.Counter()
fold_evals.launches_device_r = 0
