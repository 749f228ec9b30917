"""Kernel B1, the row-MSM: ``out[l] = sum_i s[l, i] * G_i``.

``row_msm`` launches the CUDA kernel (``csrc/row_msm.cu``) for tensors on
the card and runs ``row_msm_plain`` for tensors on the CPU; there is no
fallback from one to the other.  It replaces the TPU kernel
``spartan_tpu/curve/pallas_msm.py:275`` (``_msm_window_kernel``) with its
wrapper ``msm_rows_pallas`` and XLA tail.

Inputs: canonical scalars ``(L, R, 8)`` int32 and the generators'
multiples table ``tab`` ``(16, R, 4, 8)`` int32, ``tab[d][i] = d * G_i``
(built once per ``MultiCommitGens``, see ``commitments.py``).  Output:
``(L, 4, 8)`` int32 points, canonical coordinates.  Both versions run
the same point operations in the same order — per (row, 4-bit window)
a sum over i = 0..R-1 of the digit's table entry (the identity entry
included), then a Horner combine over the 64 windows, top window first
— so their coordinates agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..ff import limb
from . import edwards as ed

NWINDOWS = 64


def _declare(lib) -> None:
    p = ctypes.c_void_p
    lib.row_msm_launch.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, p]
    lib.row_msm_launch.restype = ctypes.c_int


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
    dig = _digits(scalars)  # (L, R, 64)
    tab16 = limb.unpack(tab)  # (16, R, 4, 16)
    acc16 = limb.unpack(ed.stack(ed.identity((L, NWINDOWS),
                                             scalars.device)))
    acc = tuple(acc16[..., k, :] for k in range(4))
    for i in range(R):
        sel = tab16[dig[:, i, :], i]  # (L, 64, 4, 16)
        acc = ed.add16(acc, tuple(sel[..., k, :] for k in range(4)))
    res = tuple(c[:, NWINDOWS - 1] for c in acc)
    for w in range(NWINDOWS - 2, -1, -1):
        for _ in range(4):
            res = ed.double16(res)
        res = ed.add16(res, tuple(c[:, w] for c in acc))
    return ed.stack(ed.pack(res))


row_msm_plain.cuda_calls = 0


def row_msm(scalars: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """Kernel B1 on the card, its plain version on the CPU."""
    L, R = scalars.shape[:2]
    if scalars.shape != (L, R, limb.NWORDS) or scalars.dtype != torch.int32:
        raise ValueError(f"scalars must be (L, R, 8) int32, got "
                         f"{tuple(scalars.shape)} {scalars.dtype}")
    if tab.shape != (16, R, 4, limb.NWORDS) or tab.dtype != torch.int32:
        raise ValueError(f"tab must be (16, {R}, 4, 8) int32, got "
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
    dev = scalars.device
    win = torch.empty((L, NWINDOWS, 4, limb.NWORDS), dtype=torch.int32,
                      device=dev)
    out = torch.empty((L, 4, limb.NWORDS), dtype=torch.int32, device=dev)
    if L == 0:
        return out
    rc = lib.row_msm_launch(scalars.data_ptr(), tab.data_ptr(),
                            win.data_ptr(), out.data_ptr(), L, R,
                            _build.stream_handle(dev))
    row_msm.launches += 1
    _build.check(rc, "row_msm")
    return out


row_msm.launches = 0
