"""Kernel B1, the row-MSM: ``out[l] = sum_i s[l, i] * G_i``.

``row_msm`` launches the CUDA kernel (``csrc/row_msm.cu``) for tensors on
the card and runs ``row_msm_plain`` for tensors on the CPU; there is no
fallback from one to the other.  It replaces the TPU kernel
``spartan_tpu/curve/pallas_msm.py:275`` (``_msm_window_kernel``) with its
wrapper ``msm_rows_pallas`` and XLA tail.

Inputs: canonical scalars ``(L, R, 8)`` int32 and the generators'
multiples table ``tab`` ``(16, R, 3, 8)`` int32, ``tab[d][i] = d * G_i``
in the precomputed affine form (y+x, y-x, 2d*x*y) (built once per
``MultiCommitGens``, see ``commitments.py``).  Output: ``(L, 4, 8)``
int32 points, canonical extended coordinates.  Both versions run the
same point operations in the same order, so their coordinates agree bit
for bit:

1. the R generators are cut into ``segments(L, R)`` segments; per (row,
   segment, 4-bit window), starting from the identity, one mixed add of
   the digit's table entry per generator in order (the identity entry
   included);
2. per (row, window), the segment sums in a halving tree (slot j +=
   slot j + half, half = S/2, ..., 1), unified adds;
3. per row, a Horner combine over the 64 windows, top window first
   (4 doublings and one unified add a window).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..ff import limb
from . import edwards as ed

NWINDOWS = 64
_MAX_SEGMENTS = 64
_MIN_SEGMENT = 32  # generators a thread walks, at the least
_THREADS = 1 << 16  # enough (row, segment, window) threads to fill the card


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.row_msm_launch.argtypes = [p, p, p, p, i, i, i, p]
    lib.row_msm_launch.restype = ctypes.c_int


def segments(L: int, R: int) -> int:
    """How many segments the R generators are cut into: doubled while
    the segments stay >= _MIN_SEGMENT long and divide R, and the
    threads stay <= _THREADS.  1 for the commitment's 1024 x 1024, 64 for
    one row of 4096."""
    s = 1
    while (2 * s <= _MAX_SEGMENTS and R % (2 * s) == 0
           and R // (2 * s) >= _MIN_SEGMENT
           and L * NWINDOWS * 2 * s <= _THREADS):
        s *= 2
    return s


def _digits(scalars: torch.Tensor) -> torch.Tensor:
    """(L, R, 8) canonical scalars -> (L, R, 64) 4-bit windows, LSB
    first."""
    s16 = limb.unpack(scalars)  # (L, R, 16)
    shifts = torch.arange(0, 16, 4, device=scalars.device)
    return ((s16.unsqueeze(-1) >> shifts) & 15).flatten(-2)


def row_msm_plain(scalars: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same operation order).
    Its calls on CUDA tensors are counted in ``cuda_calls``: the main
    path makes none."""
    if scalars.is_cuda:
        row_msm_plain.cuda_calls += 1
    L, R = scalars.shape[:2]
    S = segments(L, R)
    seg = R // S
    dig = _digits(scalars).reshape(L, S, seg, NWINDOWS)
    tab16 = limb.unpack(tab)  # (16, R, 3, 16)
    first = torch.arange(S, device=scalars.device)[None, :, None] * seg
    acc = ed.unpack(ed.identity((L, S, NWINDOWS), scalars.device))
    for k in range(seg):
        sel = tab16[dig[:, :, k, :], first + k]  # (L, S, 64, 3, 16)
        acc = ed.madd16(acc, tuple(sel[..., c, :] for c in range(3)))
    half = S
    while half > 1:
        half //= 2
        acc = ed.add16(tuple(c[:, :half] for c in acc),
                       tuple(c[:, half:2 * half] for c in acc))
    win = tuple(c[:, 0] for c in acc)  # (L, 64, 16)
    res = tuple(c[:, NWINDOWS - 1] for c in win)
    for w in range(NWINDOWS - 2, -1, -1):
        for _ in range(4):
            res = ed.double16(res)
        res = ed.add16(res, tuple(c[:, w] for c in win))
    return ed.stack(ed.pack(res))


row_msm_plain.cuda_calls = 0


def row_msm(scalars: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """Kernel B1 on the card, its plain version on the CPU."""
    L, R = scalars.shape[:2]
    if scalars.shape != (L, R, limb.NWORDS) or scalars.dtype != torch.int32:
        raise ValueError(f"scalars must be (L, R, 8) int32, got "
                         f"{tuple(scalars.shape)} {scalars.dtype}")
    if tab.shape != (16, R, 3, limb.NWORDS) or tab.dtype != torch.int32:
        raise ValueError(f"tab must be (16, {R}, 3, 8) int32, got "
                         f"{tuple(tab.shape)} {tab.dtype}")
    if tab.device != scalars.device:
        raise ValueError("scalars and tab lie on different devices")
    if scalars.device.type == "cpu":
        return row_msm_plain(scalars, tab)
    if scalars.device.type != "cuda":
        raise ValueError(f"row_msm: unsupported device {scalars.device}")
    lib = _build.load("row_msm", _declare)
    scalars = scalars.contiguous()
    tab = tab.contiguous()
    _build.check_aligned("row_msm", scalars, tab)
    dev = scalars.device
    S = segments(L, R)
    part = torch.empty((L, S, NWINDOWS, 4, limb.NWORDS), dtype=torch.int32,
                       device=dev)
    out = torch.empty((L, 4, limb.NWORDS), dtype=torch.int32, device=dev)
    if L == 0:
        return out
    rc = lib.row_msm_launch(scalars.data_ptr(), tab.data_ptr(),
                            part.data_ptr(), out.data_ptr(), L, R, S,
                            _build.stream_handle(dev))
    row_msm.launches += 1
    _build.check(rc, "row_msm")
    return out


row_msm.launches = 0
