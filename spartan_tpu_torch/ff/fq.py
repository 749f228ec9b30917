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
``csrc/fq.cuh`` (8 x 32-bit limbs, CIOS).  The storage-layout functions
(``mul``, ``add``, ``sub``, ``neg``, ``square``, ``to_mont``,
``from_mont``, ``eq_step``, ``dot_mod``, ``sum_mod``) launch the
elementwise kernel K7 (``csrc/fq_elementwise.cu``) or the reduction
kernel K8 (``csrc/fq_reduce.cu``) for tensors on the card and run their
plain versions (``*_plain``) for tensors on the CPU; there is no
fallback from one to the other.
"""

from __future__ import annotations

import collections
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


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product: (aR)(bR)R^-1 = abR (plain PyTorch)."""
    return _elementwise(mul16, a, b)


def add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _elementwise(add16, a, b)


def sub_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _elementwise(sub16, a, b)


def to_mont_plain(a: torch.Tensor) -> torch.Tensor:
    """aR mod q: the plain PyTorch version of the kernel's TO_MONT mode
    (the same canonical words)."""
    r2 = limb.const16(R2_INT, a.device)
    return _elementwise(lambda x: mul16(x, r2), a)


def from_mont_plain(a: torch.Tensor) -> torch.Tensor:
    return _elementwise(redc16, a)


def eq_step_plain(t: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """One doubling step of an eq table: entry i of the (m, 8) table t
    becomes entries 2i (t[i] - t[i] r) and 2i + 1 (t[i] r, Montgomery)."""
    hi = mul_plain(t, r)
    return torch.stack([sub_plain(t, hi), hi], dim=1).reshape(-1,
                                                              limb.NWORDS)


def reduce_wide(w: torch.Tensor) -> torch.Tensor:
    """(..., k) int64 16-bit limbs (k <= 32) -> canonical w mod q,
    storage layout."""
    return limb.pack(reduce_wide16(w))


def sum_mod_plain(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return limb.pack(sum16(limb.unpack(x), dim))


def dot_mod_plain(a: torch.Tensor, b: torch.Tensor,
                  dim: int = 0) -> torch.Tensor:
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
# The same functions on the card: kernels K7 (csrc/fq_elementwise.cu) and
# K8 (csrc/fq_reduce.cu).  Each public function below runs its plain
# version for tensors on the CPU and its kernel for tensors on the card,
# and raises on what neither takes; there is no fallback from one to the
# other.  ``launches`` counts the kernels' launches by (mode, n), n the
# elements a launch reads from its first operand.
# ---------------------------------------------------------------------------

_MODES = {"to_mont": 0, "mul": 1, "add": 2, "sub": 3, "from_mont": 4,
          "eq": 5}  # csrc/fq_elementwise.cu's MODE_*
_REDUCE_BLOCK = 256  # csrc/fq_reduce.cu's BLOCK and ELEMS
_REDUCE_ELEMS = 2
_REDUCE_BLOCKS_PER_SM = 4  # K8's grid: about one wave of blocks

launches = collections.Counter()


def _declare_elementwise(lib) -> None:
    p, i64 = ctypes.c_void_p, ctypes.c_long
    lib.fq_elementwise_launch.argtypes = [p, i64, i64, p, i64, i64, p, i64,
                                          i64, ctypes.c_int, p]
    lib.fq_elementwise_launch.restype = ctypes.c_int


def _declare_reduce(lib) -> None:
    p, i64 = ctypes.c_void_p, ctypes.c_long
    lib.fq_reduce_launch.argtypes = [p, i64, i64, i64, i64, i64, i64, p, i64,
                                     p, ctypes.c_int, i64, p, p, p]
    lib.fq_reduce_launch.restype = ctypes.c_int


def _device(what: str, *xs) -> torch.device:
    """The one device of ``xs``, each an (..., 8) int32 tensor; raises
    on anything else."""
    for x in xs:
        if (not isinstance(x, torch.Tensor) or x.dtype != torch.int32
                or x.dim() == 0 or x.shape[-1] != limb.NWORDS):
            got = (f"{tuple(x.shape)} {x.dtype}"
                   if isinstance(x, torch.Tensor) else type(x).__name__)
            raise ValueError(f"{what}: (..., 8) int32 values, got {got}")
    devs = {x.device for x in xs}
    if len(devs) != 1:
        raise ValueError(f"{what}: operands on {sorted(map(str, devs))}")
    dev = xs[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def _check_out(what: str, out, shape, dev) -> None:
    if out is not None and (tuple(out.shape) != tuple(shape)
                            or out.dtype != torch.int32
                            or out.device != dev
                            or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be a contiguous int32 tensor of "
                         f"shape {tuple(shape)} on {dev}")


def _collapse(sizes, strides):
    """The one stride that walks dims of these sizes and strides in
    row-major order, or None where there is none (0 for no dims)."""
    stride = span = None
    for size, st in zip(reversed(sizes), reversed(strides)):
        if size == 1:
            continue
        if stride is None:
            stride = st
        elif st != span:
            return None
        span = st * size
    return 0 if stride is None else stride


def _strides(x: torch.Tensor, parts):
    """x's element strides in words, one a group of its element dims
    (``parts``: (start, stop) pairs), or None where a group does not
    flatten or an element does not start on a 16-byte boundary."""
    if x.stride(-1) != 1:
        return None
    out = []
    for lo, hi in parts:
        s = _collapse(x.shape[lo:hi], x.stride()[lo:hi])
        if s is None or s % 4:
            return None
        out.append(s)
    return out


def _k7(mode: str, xs, shape, out) -> torch.Tensor:
    """K7's ``mode`` over the operands ``xs`` (one or two, broadcast to
    ``shape``) into ``out`` (fresh when None).  An operand is read in
    place where its strides fit the kernel's two levels (rows of
    ``cols`` elements), and copied to a contiguous table where not."""
    dev = xs[0].device
    lens = shape[:-1]
    n = math.prod(lens)
    if out is None:
        out = torch.empty((2 * n, limb.NWORDS) if mode == "eq" else shape,
                          dtype=torch.int32, device=dev)
    if n == 0:
        return out
    ex = [x.expand(shape) for x in xs]

    def split(p):  # rows: element dims before p; columns: the rest
        return (0, p), (p, len(lens))

    # one level (cols = n) where every operand flattens, else the first
    # split of the element dims at which each operand's two groups do
    for p in range(max(1, len(lens))):
        st = [_strides(x, split(p)) for x in ex]
        if None not in st:
            break
    else:
        p = 0
        ex = [x if _strides(x, split(0)) else x.contiguous() for x in ex]
        st = [_strides(x, split(0)) for x in ex]
    _build.check_aligned(mode, *ex, out)
    args = []
    for x, (rs, cs) in zip(ex + ex[:1], st + st[:1]):
        args += [x.data_ptr(), rs, cs]
    lib = _build.load("fq_elementwise", _declare_elementwise)
    rc = lib.fq_elementwise_launch(*args[:6], out.data_ptr(), n,
                                   math.prod(lens[p:]), _MODES[mode],
                                   _build.stream_handle(dev))
    launches[mode, n] += 1
    _build.check(rc, mode)
    return out


def _binary(what: str, plain, a, b, out) -> torch.Tensor:
    dev = _device(what, a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    _check_out(what, out, shape, dev)
    if dev.type == "cpu":
        res = plain(a, b)
        return res if out is None else out.copy_(res)
    return _k7(what, [a, b], shape, out)


def _unary(what: str, plain, a, out) -> torch.Tensor:
    dev = _device(what, a)
    _check_out(what, out, a.shape, dev)
    if dev.type == "cpu":
        res = plain(a)
        return res if out is None else out.copy_(res)
    return _k7(what, [a], a.shape, out)


def mul(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor | None = None
        ) -> torch.Tensor:
    """Montgomery product: (aR)(bR)R^-1 = abR, elementwise with
    broadcasting.  ``out``, a contiguous int32 tensor of the result's
    shape on its device that overlaps no operand (such as a slice of a
    larger table), receives the result and is returned; the same for
    ``add``, ``sub``, ``to_mont``, ``from_mont`` and ``eq_step``."""
    return _binary("mul", mul_plain, a, b, out)


def add(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor | None = None
        ) -> torch.Tensor:
    return _binary("add", add_plain, a, b, out)


def sub(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor | None = None
        ) -> torch.Tensor:
    return _binary("sub", sub_plain, a, b, out)


def neg(a: torch.Tensor) -> torch.Tensor:
    if _device("neg", a).type == "cpu":
        return sub(torch.zeros_like(a), a)
    return sub(a.new_zeros(limb.NWORDS), a)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def to_mont(a: torch.Tensor, out: torch.Tensor | None = None
            ) -> torch.Tensor:
    """aR mod q for (..., 8) values below 2^256 (canonical scalars)."""
    return _unary("to_mont", to_mont_plain, a, out)


def from_mont(a: torch.Tensor, out: torch.Tensor | None = None
              ) -> torch.Tensor:
    """aR^-1 mod q for (..., 8) values below 2^256: the canonical
    scalars of a Montgomery table."""
    return _unary("from_mont", from_mont_plain, a, out)


def eq_step(t: torch.Tensor, r: torch.Tensor,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """One doubling step of an eq table (``eq_step_plain``): the (m, 8)
    table t and one element r (shape (8,)) give the (2m, 8) table."""
    dev = _device("eq_step", t, r)
    if t.dim() != 2 or r.shape != (limb.NWORDS,):
        raise ValueError(f"eq_step: an (m, 8) table and an (8,) element, "
                         f"got {tuple(t.shape)} and {tuple(r.shape)}")
    _check_out("eq_step", out, (2 * t.shape[0], limb.NWORDS), dev)
    if dev.type == "cpu":
        res = eq_step_plain(t, r)
        return res if out is None else out.copy_(res)
    return _k7("eq", [t, r], t.shape, out)


def _elem_dim(what: str, ndim: int, dim: int) -> int:
    """``dim`` among the ndim - 1 element dims, negative from the last."""
    if ndim < 2 or not -(ndim - 1) <= dim < ndim - 1:
        raise ValueError(f"{what}: no element dim {dim} in {ndim - 1}")
    return dim % (ndim - 1)


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _k8(mode: str, t: torch.Tensor, w: torch.Tensor | None, shape,
        dim: int) -> torch.Tensor:
    """K8 over t (broadcast to ``shape``) viewed as (O, I, K) around
    element dim ``dim``, weighted by w (one element along every other
    dim) or not.  Operands are read in place where their strides
    flatten to those three, and copied to a contiguous table where not."""
    dev = t.device
    lens = shape[:-1]
    O, I, K = math.prod(lens[:dim]), lens[dim], math.prod(lens[dim + 1:])
    out = torch.empty((*lens[:dim], *lens[dim + 1:], limb.NWORDS),
                      dtype=torch.int32, device=dev)
    if O * K == 0:
        return out
    if I == 0:
        return out.zero_()
    parts = ((0, dim), (dim, dim + 1), (dim + 1, len(lens)))
    ops = []
    for x in (t, w):
        if x is not None:
            x = x.expand(shape)
            if _strides(x, parts) is None:
                x = x.contiguous()
        ops.append(x)
    t, w = ops
    # KT columns a block, a warp's worth at most; the blocks of a column
    # group split its rows, about one wave of blocks in all, each block
    # taking at least 4 steps of its BLOCK / KT rows ELEMS at a time
    kt = min(1 << (K - 1).bit_length(), 32)
    groups = O * -(-K // kt)
    wave = _REDUCE_BLOCKS_PER_SM * _sm_count(dev)
    step = _REDUCE_BLOCK // kt * _REDUCE_ELEMS
    splits = max(1, min(-(-wave // groups), -(-I // (4 * step)), 65535))
    partial = ticket = None
    if splits > 1:
        partial = torch.empty(groups * splits * kt * 9, dtype=torch.int32,
                              device=dev)
        ticket = torch.zeros(groups, dtype=torch.int32, device=dev)
    _build.check_aligned(mode, *(x for x in (t, w, out) if x is not None))

    def ptr(x):
        return x.data_ptr() if x is not None else None

    lib = _build.load("fq_reduce", _declare_reduce)
    rc = lib.fq_reduce_launch(
        t.data_ptr(), *_strides(t, parts), O, I, K, ptr(w),
        _strides(w, parts)[1] if w is not None else 0, out.data_ptr(),
        kt.bit_length() - 1, splits, ptr(partial), ptr(ticket),
        _build.stream_handle(dev))
    launches[mode, O * I * K] += 1
    _build.check(rc, mode)
    return out


def sum_mod(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The sum mod q along element dim ``dim``."""
    dev = _device("sum_mod", x)
    dim = _elem_dim("sum_mod", x.dim(), dim)
    if dev.type == "cpu":
        return sum_mod_plain(x, dim)
    return _k8("sum", x, None, x.shape, dim)


def _varies_along(x: torch.Tensor, ndim: int, dim: int) -> bool:
    """Whether x, broadcast to ndim dims, has one element along every
    element dim but ``dim``."""
    sh = (1,) * (ndim - x.dim()) + tuple(x.shape)
    return all(s == 1 for d, s in enumerate(sh[:-1]) if d != dim)


def dot_mod(a: torch.Tensor, b: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """<a, b> mod q along element dim ``dim`` (broadcast; Montgomery in,
    Montgomery out).  On the card, one K8 launch weighted by the operand
    that varies along ``dim`` alone; where neither does, the products
    (K7) and their sum (K8)."""
    dev = _device("dot_mod", a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    dim = _elem_dim("dot_mod", len(shape), dim)
    if dev.type == "cpu":
        return dot_mod_plain(a, b, dim)
    for t, w in ((a, b), (b, a)):
        if _varies_along(w, len(shape), dim):
            return _k8("dot", t, w, shape, dim)
    return _k8("sum", mul(a, b), None, shape, dim)


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
