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
``csrc/fq.cuh`` (8 x 32-bit limbs, CIOS).  ``to_mont`` launches the
elementwise kernel (``csrc/fq_elementwise.cu``) for tensors on the card
and runs ``to_mont_plain`` for tensors on the CPU; there is no fallback
from one to the other.
"""

from __future__ import annotations

import ctypes
import math
import time

import torch

from .. import _build
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

# Elements an elementwise operation of the storage layout handles at once.
# The compute layout's temporaries (wide columns, REDC) take ~0.4 KB an
# element, so a Spark table of 2^24 entries at once would hold ~7 GB.
CHUNK = 1 << 21


def _elementwise(fn, *xs) -> torch.Tensor:
    """fn over the compute layout of ``xs`` (broadcast), in pieces of at
    most CHUNK elements; the pieces' results are the whole's."""
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    n = math.prod(shape[:-1])
    if n <= CHUNK:
        return limb.pack(fn(*(limb.unpack(x) for x in xs)))
    flat = [x.expand(shape).reshape(n, limb.NWORDS) for x in xs]
    out = torch.empty((n, limb.NWORDS), dtype=torch.int32,
                      device=xs[0].device)
    for i in range(0, n, CHUNK):
        out[i:i + CHUNK] = limb.pack(
            fn(*(limb.unpack(f[i:i + CHUNK]) for f in flat)))
    return out.reshape(shape)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product: (aR)(bR)R^-1 = abR."""
    return _elementwise(mul16, a, b)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _elementwise(add16, a, b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _elementwise(sub16, a, b)


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def to_mont_plain(a: torch.Tensor) -> torch.Tensor:
    """aR mod q: the plain PyTorch version of the kernel's TO_MONT mode
    (the same canonical words)."""
    r2 = limb.const16(R2_INT, a.device)
    return _elementwise(lambda x: mul16(x, r2), a)


_MODES = {"to_mont": 0}  # csrc/fq_elementwise.cu's MODE_*


def _declare(lib) -> None:
    p = ctypes.c_void_p
    lib.fq_elementwise_launch.argtypes = [p, p, ctypes.c_long, ctypes.c_int,
                                          p]
    lib.fq_elementwise_launch.restype = ctypes.c_int


def to_mont(a: torch.Tensor, out: torch.Tensor | None = None
            ) -> torch.Tensor:
    """aR mod q for (..., 8) values below 2^256 (canonical scalars):
    the elementwise kernel on the card, ``to_mont_plain`` on the CPU.
    ``out``, a contiguous int32 tensor of ``a``'s shape on its device
    that does not overlap it (such as a slice of a larger table),
    receives the result and is returned."""
    if a.dtype != torch.int32 or a.shape[-1:] != (limb.NWORDS,):
        raise ValueError(f"to_mont: (..., 8) int32 values, got "
                         f"{tuple(a.shape)} {a.dtype}")
    if out is not None and (out.shape != a.shape or out.dtype != a.dtype
                            or out.device != a.device
                            or not out.is_contiguous()):
        raise ValueError("to_mont: out must be a contiguous int32 tensor of "
                         "the input's shape on its device")
    if a.device.type == "cpu":
        res = to_mont_plain(a)
        return res if out is None else out.copy_(res)
    if a.device.type != "cuda":
        raise ValueError(f"to_mont: unsupported device {a.device}")
    lib = _build.load("fq_elementwise", _declare)
    a = a.contiguous()
    if out is None:
        out = torch.empty_like(a)
    _build.check_aligned("to_mont", a, out)
    n = a.numel() // limb.NWORDS
    if n:
        rc = lib.fq_elementwise_launch(a.data_ptr(), out.data_ptr(), n,
                                       _MODES["to_mont"],
                                       _build.stream_handle(a.device))
        to_mont.launches += 1
        _build.check(rc, "to_mont")
    return out


to_mont.launches = 0


def from_mont(a: torch.Tensor) -> torch.Tensor:
    return _elementwise(redc16, a)


def reduce_wide(w: torch.Tensor) -> torch.Tensor:
    """(..., k) int64 16-bit limbs (k <= 32) -> canonical w mod q,
    storage layout."""
    return limb.pack(reduce_wide16(w))


def sum_mod(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return limb.pack(sum16(limb.unpack(x), dim))


def dot_mod(a: torch.Tensor, b: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """<a, b> mod q along ``dim`` of the elements (broadcast; Montgomery
    in, Montgomery out).  The products go in pieces of at most CHUNK
    elements along ``dim``, summed as integers and reduced once."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    dim %= len(shape) - 1
    size = shape[dim]
    step = max(1, CHUNK * size // max(1, math.prod(shape[:-1])))
    a, b = a.expand(shape), b.expand(shape)
    acc = 0
    for i in range(0, size, step):
        k = min(step, size - i)
        acc = acc + mul16(limb.unpack(a.narrow(dim, i, k)),
                          limb.unpack(b.narrow(dim, i, k))).sum(dim)
    return limb.pack(reduce_wide16(acc))


# ---------------------------------------------------------------------------
# Host boundary
# ---------------------------------------------------------------------------

def encode_ints(xs, device=None) -> torch.Tensor:
    """Python ints -> Montgomery storage tensor (the Montgomery map is
    applied on the host, for short vectors: no device round; ``utils.rt``
    counts the elements).  A long table goes up canonical
    (``limb.ints_to_limbs``) and through ``to_mont`` on its device."""
    mont = [(x % Q) * R % Q for x in xs]
    rt.count_encoded(len(mont))
    return limb.ints_to_limbs(mont, device)


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
