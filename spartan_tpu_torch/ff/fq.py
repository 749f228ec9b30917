"""Plain PyTorch arithmetic in the ristretto255 scalar field Fq,
q = 2^252 + 27742317777372353535851937790883648493.

Values are in Montgomery form (aR mod q, R = 2^256), canonical, as in
the JAX package and the reference scalar.  The public functions take and
return the storage layout (``(..., 8)`` int32, see ``limb``); the
``*16`` functions work on the ``(..., 16)`` int64 compute layout so that
chains of operations unpack once.  REDC is word-serial over 16-bit
words: each step needs only the low limb exact (t mod 2^16 equals limb
0 mod 2^16 whatever the carry state of the rest), so the schoolbook
columns are never carried in full until the end.

Device kernels carry their own copy of this arithmetic in
``csrc/fq.cuh`` (8 x 32-bit limbs, CIOS).
"""

from __future__ import annotations

import time

import torch

from ..core.field import Q
from ..utils import rt
from . import limb
from .limb import LIMB_BITS, LIMB_MASK, NLIMBS

R = 1 << 256
R_INV = pow(R, -1, Q)
R2_INT = R * R % Q
R3_INT = R * R * R % Q
NPRIME0 = (-pow(Q, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)


def _q(device) -> torch.Tensor:
    return limb.const16(Q, device)


# ---------------------------------------------------------------------------
# Compute layout (..., 16) int64, exact canonical limbs in and out
# ---------------------------------------------------------------------------

def redc16(t: torch.Tensor) -> torch.Tensor:
    """t (..., <=32 limbs, value < R*q, any nonnegative carry state)
    -> t * R^-1 mod q, canonical exact limbs."""
    t = limb.pad_limbs(t, 2 * NLIMBS + 1).clone()
    q = _q(t.device)
    for i in range(NLIMBS):
        m = ((t[..., i] & LIMB_MASK) * NPRIME0) & LIMB_MASK
        t[..., i:i + NLIMBS] += m.unsqueeze(-1) * q
        t[..., i + 1] += t[..., i] >> LIMB_BITS
    out = limb.carry(t[..., NLIMBS:2 * NLIMBS + 1])  # < 2q < 2^254
    return limb.cond_sub(out[..., :NLIMBS], q)


def mul16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return redc16(limb.mul_wide(a, b))


def add16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return limb.cond_sub(limb.carry(a + b), _q(a.device))


def sub16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = limb.carry(a - b)
    neg = (d[..., -1] < 0).to(torch.int64).unsqueeze(-1)
    return limb.carry(d + neg * _q(a.device))


def reduce_wide16(w: torch.Tensor) -> torch.Tensor:
    """Any nonnegative (..., <=32 limb) integer < 2^512 -> w mod q,
    canonical.  The reference's from_u512 decomposition: with w = lo +
    2^256 hi, mont(lo, R2) + mont(hi, R3) = wR mod q, then one REDC."""
    w = limb.carry(limb.pad_limbs(w, 2 * NLIMBS))
    lo, hi = w[..., :NLIMBS], w[..., NLIMBS:]
    dev = w.device
    x = add16(mul16(lo, limb.const16(R2_INT, dev)),
              mul16(hi, limb.const16(R3_INT, dev)))
    return redc16(x)


def sum16(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Modular sum along ``dim`` (one integer sum, then one reduction;
    int64 limb sums are exact for up to 2^47 terms)."""
    s = x.sum(dim)
    return reduce_wide16(limb.carry(limb.pad_limbs(s, 2 * NLIMBS)))


# ---------------------------------------------------------------------------
# Storage layout (..., 8) int32
# ---------------------------------------------------------------------------

def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product: (aR)(bR)R^-1 = abR."""
    return limb.pack(mul16(limb.unpack(a), limb.unpack(b)))


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return limb.pack(add16(limb.unpack(a), limb.unpack(b)))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return limb.pack(sub16(limb.unpack(a), limb.unpack(b)))


def to_mont(a: torch.Tensor) -> torch.Tensor:
    return limb.pack(mul16(limb.unpack(a), limb.const16(R2_INT, a.device)))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    return limb.pack(redc16(limb.unpack(a)))


def reduce_wide(w: torch.Tensor) -> torch.Tensor:
    """(..., k) int64 16-bit limbs (k <= 32) -> canonical w mod q,
    storage layout."""
    return limb.pack(reduce_wide16(w))


def sum_mod(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return limb.pack(sum16(limb.unpack(x), dim))


def dot_mod(a: torch.Tensor, b: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """<a, b> mod q along ``dim`` (Montgomery in, Montgomery out)."""
    return limb.pack(sum16(mul16(limb.unpack(a), limb.unpack(b)), dim))


# ---------------------------------------------------------------------------
# Host boundary
# ---------------------------------------------------------------------------

def encode_ints(xs, device=None) -> torch.Tensor:
    """Canonical python ints -> Montgomery storage tensor (the Montgomery
    map is applied on the host: one bulk int pass, no device round)."""
    return limb.ints_to_limbs([(x % Q) * R % Q for x in xs], device)


def decode_to_ints(a: torch.Tensor) -> list[int]:
    """Montgomery storage tensor -> canonical python ints.  This is the
    prover's blocking device->host fetch; ``utils.rt`` counts and times
    every call."""
    t0 = time.perf_counter()
    vals = limb.limbs_to_ints(a)
    rt.record(time.perf_counter() - t0)
    return [v * R_INV % Q for v in vals]


def mont_limbs(x: int, device=None) -> torch.Tensor:
    """One canonical int -> its (8,) Montgomery storage tensor."""
    return encode_ints([x], device)[0]
