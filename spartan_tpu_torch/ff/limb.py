"""Limb layouts and plain big-integer helpers for the port.

Storage layout: a 256-bit field element is a ``(..., 8)`` ``torch.int32``
tensor holding its 32 little-endian bytes bit for bit (eight 32-bit
limbs, two's-complement reinterpretation of uint32).  The CUDA kernels
read it as ``uint32_t[8]``.  These are the same bytes as the JAX
package's ``(..., 16)`` uint32 arrays of 16-bit limbs, so carrying
state across is a reinterpretation (see ``interop.py``).

Compute layout of the plain PyTorch versions: ``(..., 16)`` ``int64``
16-bit limbs.  torch's uint32 has no add, shift or compare on the CPU,
and int64 leaves room for whole schoolbook column sums (< 2^37) and
for signed borrows, so carries are resolved only where needed.
"""

from __future__ import annotations

from itertools import repeat

import numpy as np
import torch
import torch.nn.functional as F

NLIMBS = 16  # 16-bit compute limbs per element
NWORDS = 8  # 32-bit storage limbs per element
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

# numel above which mul_wide switches from the one-shot outer product
# (4 ops, ~34x the operand bytes live) to the 16-step schoolbook loop
_OUTER_MAX = 1 << 20


# ---------------------------------------------------------------------------
# Host <-> tensor packing
# ---------------------------------------------------------------------------

def ints_to_limbs(xs, device=None) -> torch.Tensor:
    """Python ints in [0, 2^256) -> (len, 8) int32 storage limbs, in one
    bulk pass (``int.to_bytes`` mapped over ``xs``, one join)."""
    if len(xs) == 0:
        return torch.zeros((0, NWORDS), dtype=torch.int32, device=device)
    raw = b"".join(map(int.to_bytes, xs, repeat(32), repeat("little")))
    arr = np.frombuffer(raw, dtype="<i4").reshape(len(xs), NWORDS)
    return torch.from_numpy(arr.copy()).to(device)


def limbs_to_ints(a: torch.Tensor) -> list[int]:
    """(..., 8) int32 storage limbs -> flat list of python ints."""
    raw = a.detach().to("cpu", torch.int32).contiguous().numpy()
    raw = raw.reshape(-1, NWORDS).astype("<i4").tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little")
            for i in range(len(raw) // 32)]


def int_to_limbs16(x: int, n: int = NLIMBS) -> list[int]:
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)]


_consts: dict = {}


def const16(x: int, device, n: int = NLIMBS) -> torch.Tensor:
    """A constant as an (n,) int64 16-bit-limb tensor on ``device``
    (cached per device: the round loops use the same few constants)."""
    key = (x, n, str(device))
    t = _consts.get(key)
    if t is None:
        t = torch.tensor(int_to_limbs16(x, n), dtype=torch.int64,
                         device=device)
        _consts[key] = t
    return t


# ---------------------------------------------------------------------------
# Storage <-> compute layout
# ---------------------------------------------------------------------------

def unpack(a: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 -> (..., 16) int64 exact 16-bit limbs."""
    assert a.dtype == torch.int32 and a.shape[-1] == NWORDS, (a.dtype, a.shape)
    return a.contiguous().view(torch.int16).to(torch.int64) & LIMB_MASK


def pack(x: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 exact 16-bit limbs -> (..., 8) int32."""
    w = x[..., 0::2] | (x[..., 1::2] << LIMB_BITS)
    w = torch.where(w >= (1 << 31), w - (1 << 32), w)
    return w.to(torch.int32)


# ---------------------------------------------------------------------------
# Carries and products (compute layout)
# ---------------------------------------------------------------------------

def pad_limbs(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[-1] == n:
        return x
    assert x.shape[-1] < n
    return F.pad(x, (0, n - x.shape[-1]))


def carry(x: torch.Tensor) -> torch.Tensor:
    """Ripple carries so every limb but the top one is in [0, 2^16).
    Limbs may be negative (signed borrows resolve the same way); the top
    limb keeps whatever is left, so its sign is the sign of the value."""
    x = x.clone()
    for k in range(x.shape[-1] - 1):
        c = x[..., k] >> LIMB_BITS
        x[..., k] &= LIMB_MASK
        x[..., k + 1] += c
    return x


def mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n) x (..., n) -> (..., 2n) schoolbook column sums (not
    carried; each < n * max_limb^2)."""
    a, b = torch.broadcast_tensors(a, b)
    n = a.shape[-1]
    if a.numel() <= _OUTER_MAX:
        # outer product, then skew row i right by i with a pad-and-view:
        # rows of width 2n+1 re-read as rows of width 2n put p[i][j] at
        # column i + j; the pad columns fill the rest with zeros
        p = a.unsqueeze(-1) * b.unsqueeze(-2)
        p = torch.constant_pad_nd(p, (0, n + 1)).flatten(-2)[..., : 2 * n * n]
        return p.unflatten(-1, (n, 2 * n)).sum(-2)
    acc = torch.zeros((*a.shape[:-1], 2 * n), dtype=torch.int64,
                      device=a.device)
    for i in range(n):
        acc[..., i:i + n] += a[..., i:i + 1] * b
    return acc


def sub_borrow(a: torch.Tensor, b: torch.Tensor):
    """a - b for exact limbs: (low limbs of a - b mod 2^(16n), a < b)."""
    d = carry(a - b)
    neg = d[..., -1] < 0
    d[..., -1] &= LIMB_MASK
    return d, neg


def cond_sub(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a - m if a >= m else a (exact limbs)."""
    d, neg = sub_borrow(a, m)
    return torch.where(neg.unsqueeze(-1), a, d)


def to_int16(x: torch.Tensor) -> list[int]:
    """(..., n) int64 limbs (any carry state, nonnegative value) ->
    python ints (test helper)."""
    rows = x.detach().cpu().reshape(-1, x.shape[-1]).tolist()
    return [sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(r))
            for r in rows]


def from_int16(xs, device=None, n: int = NLIMBS) -> torch.Tensor:
    return torch.tensor([int_to_limbs16(int(x), n) for x in xs],
                        dtype=torch.int64, device=device)
