"""Plain PyTorch lazy arithmetic mod p = 2^255 - 19, the coordinate
field of the ristretto255 group.

Lazy representation (compute layout ``(..., 16)`` int64): limbs are
loose, each in [0, 2^16 + 2^10), and the value is only congruent mod p.
Reduction uses 2^256 = 38 (mod p): a carry pass moves each limb's
overflow one limb up and wraps the top limb's overflow, times 38, into
limb 0, so no pass ever compares or subtracts.  Subtraction adds a
multiple of p whose limbs all exceed any loose limb (``_SUB_BIAS``), so
it never borrows.  ``canonical16`` brings a value to [0, p) exactly; the
point kernels' outputs are compared in that form.

The CUDA kernels carry their own copy in ``csrc/fp25519.cuh`` (8 x
32-bit limbs, values < 2^256, the same 38-fold).
"""

from __future__ import annotations

import torch

from ..core.field import P25519 as P
from ..core.field import SQRT_M1
from . import limb
from .limb import LIMB_BITS, LIMB_MASK, NLIMBS


def _bias_limbs() -> list[int]:
    """Limbs c_k in [2^17, 2^17 + 2^16) with sum c_k 2^(16k) = 0 mod p."""
    base = sum((1 << 17) << (LIMB_BITS * k) for k in range(NLIMBS))
    d = (-base) % P
    return [(1 << 17) + ((d >> (LIMB_BITS * k)) & LIMB_MASK)
            for k in range(NLIMBS)]


_SUB_BIAS = _bias_limbs()


def _bias(device) -> torch.Tensor:
    key = ("fp_bias", str(device))
    t = limb._consts.get(key)
    if t is None:
        t = torch.tensor(_SUB_BIAS, dtype=torch.int64, device=device)
        limb._consts[key] = t
    return t


def _wrap(device):
    """(index, weight): limb k's carry comes from limb k - 1, limb 0's
    from limb 15 times 38 (cached per device)."""
    key = ("fp_wrap", str(device))
    t = limb._consts.get(key)
    if t is None:
        t = (torch.tensor([NLIMBS - 1] + list(range(NLIMBS - 1)),
                          device=device),
             torch.tensor([38] + [1] * (NLIMBS - 1), dtype=torch.int64,
                          device=device))
        limb._consts[key] = t
    return t


def _wrap_carry(x: torch.Tensor, passes: int) -> torch.Tensor:
    """Parallel carry passes with the 2^256 = 38 wrap; each pass keeps the
    value's residue mod p and shrinks every limb to < 2^16 + 38 * (old
    limb >> 16)."""
    idx, w = _wrap(x.device)
    for _ in range(passes):
        c = x >> LIMB_BITS
        x = (x & LIMB_MASK).add_(c.index_select(-1, idx).mul_(w))
    return x


def mul16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Loose x loose -> loose.  Columns < 2^36.1; the 38-fold < 2^41.4;
    three passes bring every limb below 2^16 + 608."""
    t = limb.mul_wide(a, b)
    return _wrap_carry(t[..., :NLIMBS] + 38 * t[..., NLIMBS:], 3)


def add16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _wrap_carry(a + b, 2)


def sub16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _wrap_carry(a + _bias(a.device) - b, 2)


def dbl16(a: torch.Tensor) -> torch.Tensor:
    return add16(a, a)


def canonical16(x: torch.Tensor) -> torch.Tensor:
    """Loose limbs -> exact canonical [0, p)."""
    x = limb.carry(x)
    for _ in range(2):  # fold the top limb's overflow twice: < 2^256 after
        top = x[..., -1] >> LIMB_BITS
        x[..., -1] &= LIMB_MASK
        x[..., 0] += 38 * top
        x = limb.carry(x)
    p = limb.const16(P, x.device)
    return limb.cond_sub(limb.cond_sub(x, p), p)  # 2^256 = 2p + 38


# ---------------------------------------------------------------------------
# Storage layout (..., 8) int32: canonical in, canonical out
# ---------------------------------------------------------------------------

def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return limb.pack(canonical16(mul16(limb.unpack(a), limb.unpack(b))))


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return limb.pack(canonical16(add16(limb.unpack(a), limb.unpack(b))))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return limb.pack(canonical16(sub16(limb.unpack(a), limb.unpack(b))))


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def pow_fixed(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a host exponent e >= 1: square-and-multiply over e's bits
    from the top, on the lazy compute layout, canonical at the end."""
    assert e >= 1
    x = limb.unpack(a)
    acc = x
    for bit in bin(e)[3:]:
        acc = mul16(acc, acc)
        if bit == "1":
            acc = mul16(acc, x)
    return limb.pack(canonical16(acc))


def is_negative(a: torch.Tensor) -> torch.Tensor:
    """ristretto's sign of a canonical value: odd is negative."""
    return (a[..., 0] & 1) == 1


def ct_abs(a: torch.Tensor) -> torch.Tensor:
    return torch.where(is_negative(a).unsqueeze(-1), neg(a), a)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Equality of canonical values, per element."""
    return (a == b).all(dim=-1)


def sqrt_ratio_m1(u: torch.Tensor, v: torch.Tensor):
    """RFC 9496 SQRT_RATIO_M1, batched: (was_square (...,) bool, the
    non-negative root (..., 8)), as the JAX package's
    ``ff/fp25519.py::sqrt_ratio_m1``."""
    v3 = mul(square(v), v)
    v7 = mul(square(v3), v)
    r = mul(mul(u, v3), pow_fixed(mul(u, v7), (P - 5) // 8))
    check = mul(v, square(r))
    neg_u = neg(u)
    i = encode_ints([SQRT_M1], u.device)[0]
    correct = eq(check, u)
    flipped = eq(check, neg_u)
    flipped_i = eq(check, mul(neg_u, i))
    r = torch.where((flipped | flipped_i).unsqueeze(-1), mul(r, i), r)
    return correct | flipped, ct_abs(r)


def reduce_canonical(a: torch.Tensor) -> torch.Tensor:
    """Any value < 2^256 in storage layout -> canonical [0, p)."""
    return limb.pack(canonical16(limb.unpack(a)))


def encode_ints(xs, device=None) -> torch.Tensor:
    return limb.ints_to_limbs([x % P for x in xs], device)


def decode_to_ints(a: torch.Tensor) -> list[int]:
    return limb.limbs_to_ints(a)
