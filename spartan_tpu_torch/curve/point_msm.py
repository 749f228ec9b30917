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
stack``), canonical scalars ``(N, 8)`` int32, and the group offsets, a
host sequence of G + 1 ints from 0 to N.  Output ``(G, 4, 8)`` int32,
canonical.  Both versions run the same point operations in the same
order, so their coordinates agree bit for bit, and both are constant
time in the scalars (the kernel by construction, see
``csrc/point_msm.cuh``):

1. per point, a table ``k * P`` for k < 16 (the identity, P, then
   unified adds of P), then 64 4-bit windows from the top: 4 doublings
   and one unified add of the entry the digit selects, every entry read;
2. per group, ``lanes(offsets)`` lanes: lane t sums the group's points
   t, t + lanes, ... in order (from its first point, or the identity
   when it has none), then lane t += lane t + half for half = lanes/2,
   ..., 1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
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


def _select16(tab, dig):
    """tab[dig] for a table of 16 entries (each a 4-tuple of (N, 16)) and
    (N,) digits: every entry weighed by a 0/1 mask and summed, so each
    is read."""
    onehot = (dig[None, :] == torch.arange(16, device=dig.device)[:, None])
    w = onehot.to(torch.int64)[..., None]  # (16, N, 1)
    return tuple((w * c).sum(0) for c in tab)


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
    rows = [ident, p]
    for _ in range(2, 16):
        rows.append(ed.add16(rows[-1], p))
    tab = tuple(torch.stack([r[c] for r in rows]) for c in range(4))
    s16 = limb.unpack(scalars)  # (N, 16)
    acc = ident
    for w in range(NWINDOWS - 1, -1, -1):
        for _ in range(4):
            acc = ed.double16(acc)
        dig = (s16[:, w // 4] >> (4 * (w % 4))) & 15
        acc = ed.add16(acc, _select16(tab, dig))

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
