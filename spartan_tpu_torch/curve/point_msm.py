"""Kernel K5, the grouped variable-base MSM:
``out[g] = sum_{off[g] <= i < off[g+1]} s[i] * P[i]``.

``point_msm`` launches the CUDA kernel (``csrc/point_msm.cu``) for tensors
on the card and runs ``point_msm_plain`` for tensors on the CPU; there is
no fallback from one to the other.  It replaces the JAX package's
variable-base device MSMs (XLA, not Pallas): ``curve/edwards.py:100``
(``scalar_mul``) with ``:119`` (``sum_reduce``) and ``curve/msm.py:147``
(``_msm_windows``), as its bullet rounds and device dot-product-log call
them.

Inputs: points ``(N, 4, 8)`` int32 in extended coordinates (``edwards.
stack``), canonical scalars ``(N, 8)`` int32 (below 2^253), and the group
offsets, a host sequence of G + 1 ints from 0 to N.  Output ``(G, 4,
8)`` int32, canonical.  Both versions run the same point formulas in the
same order, so their coordinates agree bit for bit, and both are
constant time in the scalars (the kernel by construction, see
``csrc/point_msm.cuh``):

1. per point, a table of the multiples 1P ... 8P in cached form lambda
   (Y - X, Y + X, 2Z, 2dT), lambda = 121666 (P, then seven cached
   additions of P); the scalar as 64 signed radix-16 digits in [-8, 8);
   the identity plus the entry of the top digit, then for each lower
   digit 4 doublings and one cached addition of its entry (the identity
   lambda (1, 1, 2, 0) for 0, negated for a negative digit), every entry
   read;
2. per group, ``lanes(offsets)`` lanes: lane t sums the group's points
   t, t + lanes, ... in order by the unified addition (from its first
   point, or the identity when it has none), then lane t += lane t +
   half for half = lanes/2, ..., 1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..core.field import P25519 as P
from ..ff import fp25519 as fp
from ..ff import limb
from . import edwards as ed

NWINDOWS = 64
MAX_LANES = 64  # the kernel's group_sum block


def lanes(offsets) -> int:
    """Lanes a group is summed in: the least power of two that covers
    the largest group, at most MAX_LANES."""
    most = max((b - a for a, b in zip(offsets, offsets[1:])), default=1)
    k = 1
    while k < min(most, MAX_LANES):
        k *= 2
    return k


def _check_offsets(offsets, n: int) -> tuple:
    offs = tuple(int(x) for x in offsets)
    if (len(offs) < 1 or offs[0] != 0 or offs[-1] != n
            or any(b < a for a, b in zip(offs, offs[1:]))):
        raise ValueError(f"point_msm: offsets must rise from 0 to {n}, got "
                         f"{offs[:4]}...{offs[-2:]}")
    return offs


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.point_msm_launch.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.point_msm_launch.restype = ctypes.c_int
    # one thread's chain of field products, for measuring their latency
    lib.fp_mul_chain_launch.argtypes = [p, i, p]
    lib.fp_mul_chain_launch.restype = ctypes.c_int


LAMBDA = 121666  # d = -121665/121666, so lambda 2d = -243330
# the constants that make a cached entry of (Y - X, Y + X, Z, T)
_CACHED_K = (LAMBDA, LAMBDA, 2 * LAMBDA, -2 * 121665 % P)
# s + _RECODE has the nibbles d_w + 8 (w < 63) and d_63 on top
_RECODE = 8 * (16 ** 63 - 1) // 15


def _consts(values, n, dev):
    return [limb.const16(v, dev).expand(n, limb.NLIMBS) for v in values]


def _to_cached(p):
    x, y, z, t = p
    return tuple(ed._muls([fp.sub16(y, x), fp.add16(y, x), z, t],
                          _consts(_CACHED_K, x.shape[0], x.device)))


def _cadd(p, c):
    """p + c for a cached c: the kernel's q_cadd."""
    x1, y1, z1, t1 = p
    a, b, d, cc = ed._muls([fp.sub16(y1, x1), fp.add16(y1, x1), z1, t1],
                           list(c))
    return ed._ehfg(fp.sub16(b, a), fp.sub16(d, cc), fp.add16(d, cc),
                    fp.add16(b, a))


def _select(tab, dig):
    """The entry of each digit in [-8, 8): tab holds (9, N, 16) per
    coordinate, the identity first; every entry is weighed by a 0/1
    mask and summed, so each is read, then negated where the digit is
    negative."""
    mag = dig.abs()
    onehot = mag[None, :] == torch.arange(9, device=dig.device)[:, None]
    w = onehot.to(torch.int64)[..., None]  # (9, N, 1)
    e = tuple((w * c).sum(0) for c in tab)
    neg = (e[1], e[0], e[2], fp.sub16(torch.zeros_like(e[3]), e[3]))
    s = (dig < 0)[:, None]
    return tuple(torch.where(s, a, b) for a, b in zip(neg, e))


def _digits(scalars):
    """(N, 64) signed radix-16 digits, the kernel's recode16."""
    t = limb.carry(limb.unpack(scalars) + limb.const16(_RECODE,
                                                       scalars.device))
    nib = torch.stack([(t[:, w // 4] >> (4 * (w % 4))) & 15
                       for w in range(NWINDOWS)], dim=1)
    nib[:, :-1] -= 8
    return nib


@torch.inference_mode()
def point_msm_plain(points: torch.Tensor, scalars: torch.Tensor,
                    offsets) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same operation order).
    Its calls on CUDA tensors are counted in ``cuda_calls``: the main
    path makes none."""
    if points.is_cuda:
        point_msm_plain.cuda_calls += 1
    n = points.shape[0]
    offs = _check_offsets(offsets, n)
    dev = points.device
    p = ed.unpack(ed.unstack(points))  # four (N, 16)
    ident = ed.unpack(ed.identity((n,), dev))
    rows = [_to_cached(p)]
    acc = p
    for _ in range(7):
        acc = _cadd(acc, rows[0])
        rows.append(_to_cached(acc))
    rows.insert(0, tuple(_consts((LAMBDA, LAMBDA, 2 * LAMBDA, 0), n, dev)))
    tab = tuple(torch.stack([r[c] for r in rows]) for c in range(4))
    dig = _digits(scalars)
    acc = _cadd(ident, _select(tab, dig[:, -1]))
    for w in range(NWINDOWS - 2, -1, -1):
        for _ in range(4):
            acc = ed.double16(acc)
        acc = _cadd(acc, _select(tab, dig[:, w]))

    # the group sums: (G, lanes) lanes, walked as the kernel's blocks do
    G, k = len(offs) - 1, lanes(offs)
    starts = torch.tensor(offs[:-1], device=dev)[:, None]
    ends = torch.tensor(offs[1:], device=dev)[:, None]
    lane = torch.arange(k, device=dev)[None, :]
    prod = tuple(torch.cat([c, i[:1]]) for c, i in zip(acc, ident))

    def take(step):
        idx = starts + lane + step * k
        valid = idx < ends
        return torch.where(valid, idx, n), valid  # row n: the identity

    idx, _ = take(0)
    sums = tuple(c[idx] for c in prod)  # (G, k, 16)
    steps = max((b - a + k - 1) // k for a, b in zip(offs, offs[1:])) \
        if G else 0
    for step in range(1, steps):
        idx, valid = take(step)
        new = ed.add16(sums, tuple(c[idx] for c in prod))
        sums = tuple(torch.where(valid[..., None], a, b)
                     for a, b in zip(new, sums))
    half = k
    while half > 1:
        half //= 2
        sums = ed.add16(tuple(c[:, :half] for c in sums),
                        tuple(c[:, half:2 * half] for c in sums))
    return ed.stack(ed.pack(tuple(c[:, 0] for c in sums)))


point_msm_plain.cuda_calls = 0


@functools.lru_cache(maxsize=64)
def _offsets_on(offs: tuple, device: str) -> torch.Tensor:
    """The offsets as an int32 tensor on the card, uploaded once per
    pattern (a bullet round's patterns repeat proof after proof)."""
    return torch.tensor(offs, dtype=torch.int32, device=device)


def point_msm(points: torch.Tensor, scalars: torch.Tensor,
              offsets) -> torch.Tensor:
    """Kernel K5 on the card, its plain version on the CPU.  Launches are
    counted in ``point_msm.launches``."""
    n = points.shape[0]
    if points.shape != (n, 4, limb.NWORDS) or points.dtype != torch.int32:
        raise ValueError(f"points must be (N, 4, 8) int32, got "
                         f"{tuple(points.shape)} {points.dtype}")
    if scalars.shape != (n, limb.NWORDS) or scalars.dtype != torch.int32:
        raise ValueError(f"scalars must be ({n}, 8) int32, got "
                         f"{tuple(scalars.shape)} {scalars.dtype}")
    if scalars.device != points.device:
        raise ValueError("points and scalars lie on different devices")
    dev = points.device
    if dev.type == "cpu":
        return point_msm_plain(points, scalars, offsets)
    if dev.type != "cuda":
        raise ValueError(f"point_msm: unsupported device {dev}")
    offs = _check_offsets(offsets, n)
    lib = _build.load("point_msm", _declare)
    points, scalars = points.contiguous(), scalars.contiguous()
    _build.check_aligned("point_msm", points, scalars)
    off_dev = _offsets_on(offs, str(dev))
    prod = torch.empty_like(points)  # this launch's scratch
    out = torch.empty((len(offs) - 1, 4, limb.NWORDS), dtype=torch.int32,
                      device=dev)
    rc = lib.point_msm_launch(points.data_ptr(), scalars.data_ptr(),
                              off_dev.data_ptr(), prod.data_ptr(),
                              out.data_ptr(), n, len(offs) - 1,
                              lanes(offs), _build.stream_handle(dev))
    point_msm.launches += 1
    _build.check(rc, "point_msm")
    return out


point_msm.launches = 0
