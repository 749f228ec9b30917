"""Kernel K6, the scalar step of a bullet round.

``bullet_step`` launches the CUDA kernel (``csrc/bullet_step.cu``) for
tensors on the card and runs ``bullet_step_plain`` for tensors on the
CPU; there is no fallback from one to the other.  It replaces the JAX
package's XLA scalar work of its device bullet rounds:
``protocols/bullet.py:89`` (``_bullet_fold_jit``) and the scalar part of
``protocols/device_prover.py:682-748`` (``_bullet_round_fn``), with the
device dot-product-log's head and tail.  The bullet rounds
(``protocols/bullet.py``) launch the cross and fold modes; no prover
path launches head or tail, whose user there is not ported.

Residues are ``(..., 8)`` int32 Montgomery unless named canonical; ``a``
and ``b`` are ``(n, 8)`` with m = n/2.  A challenge (``u``, ``r``, ``c``)
is either ``(8,)`` int32 Montgomery or the ``(64,)`` uint8 bytes the
device transcript squeezed (reduced as ``from_bytes_wide``).  Modes and
their arguments:

* ``"cross"``, ``(a, b, blinds)`` with ``blinds`` ``(2, 8)`` = (blind_L,
  blind_R): returns K5's scalar rows ``(2, m + 2, 8)``, canonical:
  ``[a_L, <a_L, b_R>, blind_L]`` and ``[a_R, <a_R, b_L>, blind_R]``.
* ``"fold"``, ``(a, b, u, blinds, blind_fin)``: returns ``(a', b', gsc)``
  with a' = u a_L + u^-1 a_R, b' = u^-1 b_L + u b_R, and gsc ``(m, 2,
  8)`` = [u^-1, u] canonical (K5's G-fold scalars for the pairs (G_L[i],
  G_R[i])); adds blind_L u^2 + blind_R u^-2 to ``blind_fin`` ``(8,)`` in
  place.  The kernel inverts u by safegcd, the plain version as u^(q-2):
  the inverse is unique, so both give the same residue.
* ``"head"``, ``(r, blind_x, blind_y)``: returns ``(2, 8)`` = [r
  canonical, blind_x + r blind_y].
* ``"tail"``, ``(c, x_hat, a_hat, blind_fin, drr)`` with ``drr`` ``(3,
  8)`` = (d, r_delta, r_beta): returns ``(2, 8)`` = [d + c x_hat a_hat,
  a_hat (c blind_fin + r_beta) + r_delta].

Every output is a canonical residue, so the kernel and the plain version
agree bit for bit.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from .. import _build
from ..core.field import Q
from . import fq, limb

MODES = ("cross", "fold", "head", "tail")
_QM2_BITS = bin(Q - 2)[2:]  # the inverse's exponent, top bit first


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bullet_cross_launch.argtypes = [p, p, i, p, p, p]
    lib.bullet_fold_launch.argtypes = [p, p, i, p, i, p, p, p, p, p, p]
    lib.bullet_head_launch.argtypes = [p, p, p, p, p]
    lib.bullet_tail_launch.argtypes = [p, p, p, p, p, p, p]
    # one thread's chain of divsteps, for measuring their latency
    lib.divstep_chain_launch.argtypes = [p, i, i, p]
    for f in (lib.bullet_cross_launch, lib.bullet_fold_launch,
              lib.bullet_head_launch, lib.bullet_tail_launch,
              lib.divstep_chain_launch):
        f.restype = ctypes.c_int


# ---------------------------------------------------------------------------
# The plain version (compute layout (..., 16))
# ---------------------------------------------------------------------------

def _challenge16(x: torch.Tensor) -> torch.Tensor:
    """A challenge as (16,) Montgomery limbs: its 64 bytes reduced as
    from_bytes_wide (lo R^2 + hi R^3, two Montgomery products), or its
    8 words as they are."""
    if x.dtype == torch.int32:
        return limb.unpack(x)
    w = x.to(torch.int64).view(32, 2)
    w = (w[:, 0] | (w[:, 1] << 8)).view(2, 16)  # lo, hi
    dev = x.device
    r23 = torch.stack([limb.const16(fq.R2_INT, dev),
                       limb.const16(fq.R3_INT, dev)])
    y = fq.mul16(w, r23)
    return fq.add16(y[0], y[1])


def _inv16(x: torch.Tensor) -> torch.Tensor:
    """x^(q-2) by binary square-and-multiply from the top bit (the
    kernel's fq_inv reaches the same residue by safegcd)."""
    r = x
    for bit in _QM2_BITS[1:]:
        r = fq.mul16(r, r)
        if bit == "1":
            r = fq.mul16(r, x)
    return r


def _canon16(x: torch.Tensor) -> torch.Tensor:
    """Montgomery limbs -> the canonical value's storage words."""
    return limb.pack(fq.redc16(x))


@torch.inference_mode()
def bullet_step_plain(mode: str, *args):
    """The plain PyTorch version of the kernel (the same residues).  Its
    calls on CUDA tensors are counted in ``cuda_calls``: the main path
    makes none."""
    if args[0].is_cuda:
        bullet_step_plain.cuda_calls += 1
    if mode == "cross":
        a, b, blinds = args
        m = a.shape[0] // 2
        A, B = limb.unpack(a), limb.unpack(b)
        prods = fq.mul16(torch.stack([A[:m], A[m:]]),
                         torch.stack([B[m:], B[:m]]))  # (2, m, 16)
        c = fq.sum16(prods, dim=1)  # (2, 16)
        rows = torch.cat([torch.stack([A[:m], A[m:]]), c[:, None],
                          limb.unpack(blinds)[:, None]], dim=1)
        return _canon16(rows)
    if mode == "fold":
        a, b, u, blinds, blind_fin = args
        m = a.shape[0] // 2
        A, B = limb.unpack(a), limb.unpack(b)
        u16 = _challenge16(u)
        ui16 = _inv16(u16)
        uu = torch.stack([u16, ui16])
        p = fq.mul16(torch.stack([A[:m], A[m:], B[:m], B[m:]]),
                     uu[[0, 1, 1, 0]][:, None, :])
        a2 = limb.pack(fq.add16(p[0], p[1]))
        b2 = limb.pack(fq.add16(p[2], p[3]))
        sq = fq.mul16(uu, uu)  # u^2, u^-2
        bl = fq.mul16(limb.unpack(blinds), sq)
        blind_fin.copy_(limb.pack(fq.add16(
            fq.add16(limb.unpack(blind_fin), bl[0]), bl[1])))
        gsc = _canon16(uu[[1, 0]]).expand(m, 2, limb.NWORDS).contiguous()
        return a2, b2, gsc
    if mode == "head":
        r, bx, by = args
        r16 = _challenge16(r)
        bg = fq.add16(limb.unpack(bx), fq.mul16(r16, limb.unpack(by)))
        return torch.stack([_canon16(r16), limb.pack(bg)])
    if mode == "tail":
        c, x_hat, a_hat, blind_fin, drr = args
        c16 = _challenge16(c)
        xh, ah = limb.unpack(x_hat), limb.unpack(a_hat)
        d, r_delta, r_beta = limb.unpack(drr)
        z1 = fq.add16(d, fq.mul16(c16, fq.mul16(xh, ah)))
        z2 = fq.add16(fq.mul16(ah, fq.add16(
            fq.mul16(c16, limb.unpack(blind_fin)), r_beta)), r_delta)
        return limb.pack(torch.stack([z1, z2]))
    raise ValueError(f"bullet_step: unknown mode {mode!r}")


bullet_step_plain.cuda_calls = 0


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def _check(mode: str, args) -> None:
    if mode not in MODES:
        raise ValueError(f"bullet_step: unknown mode {mode!r}")
    nargs = {"cross": 3, "fold": 5, "head": 3, "tail": 5}[mode]
    if len(args) != nargs:
        raise ValueError(f"bullet_step {mode}: {nargs} arguments, got "
                         f"{len(args)}")
    dev = args[0].device
    for x in args:
        if x.device != dev:
            raise ValueError(f"bullet_step {mode}: arguments on different "
                             f"devices")
    if mode in ("cross", "fold"):
        a, b = args[:2]
        n = a.shape[0]
        if (a.shape != (n, limb.NWORDS) or b.shape != a.shape or n < 2
                or n % 2 or a.dtype != torch.int32 or b.dtype != torch.int32):
            raise ValueError(f"bullet_step {mode}: a, b must be (n, 8) "
                             f"int32 of one even size, got {tuple(a.shape)}"
                             f" {tuple(b.shape)}")
        blinds = args[2] if mode == "cross" else args[3]
        if blinds.shape != (2, limb.NWORDS) or blinds.dtype != torch.int32:
            raise ValueError(f"bullet_step {mode}: blinds must be (2, 8) "
                             f"int32")
    chal = {"fold": 2, "head": 0, "tail": 0}.get(mode)
    if chal is not None:
        x = args[chal]
        if not ((x.shape == (limb.NWORDS,) and x.dtype == torch.int32)
                or (x.shape == (64,) and x.dtype == torch.uint8)):
            raise ValueError(f"bullet_step {mode}: a challenge is (8,) "
                             f"int32 Montgomery or (64,) uint8 bytes")
    singles = {"fold": [4], "head": [1, 2], "tail": [1, 2, 3]}.get(mode, [])
    for k in singles:
        if args[k].shape != (limb.NWORDS,) or args[k].dtype != torch.int32:
            raise ValueError(f"bullet_step {mode}: argument {k} must be "
                             f"(8,) int32")
    if mode == "fold" and not args[4].is_contiguous():
        raise ValueError("bullet_step fold: blind_fin is updated in place "
                         "and must be contiguous")
    if mode == "tail" and (args[4].shape != (3, limb.NWORDS)
                           or args[4].dtype != torch.int32):
        raise ValueError("bullet_step tail: drr must be (3, 8) int32")


def bullet_step(mode: str, *args):
    """Kernel K6 on the card, its plain version on the CPU.  Launches are
    counted in ``bullet_step.launches``, a Counter by mode."""
    _check(mode, args)
    dev = args[0].device
    if dev.type == "cpu":
        return bullet_step_plain(mode, *args)
    if dev.type != "cuda":
        raise ValueError(f"bullet_step: unsupported device {dev}")
    lib = _build.load("bullet_step", _declare)
    args = [x.contiguous() for x in args]
    _build.check_aligned("bullet_step", *args)
    stream = _build.stream_handle(dev)

    def empty(*shape):
        return torch.empty((*shape, limb.NWORDS), dtype=torch.int32,
                           device=dev)

    if mode == "cross":
        a, b, blinds = args
        m = a.shape[0] // 2
        out = empty(2, m + 2)
        rc = lib.bullet_cross_launch(a.data_ptr(), b.data_ptr(), m,
                                     blinds.data_ptr(), out.data_ptr(),
                                     stream)
    elif mode == "fold":
        a, b, u, blinds, blind_fin = args
        m = a.shape[0] // 2
        out = (empty(m), empty(m), empty(m, 2))
        rc = lib.bullet_fold_launch(
            a.data_ptr(), b.data_ptr(), m, u.data_ptr(),
            int(u.dtype == torch.uint8), blinds.data_ptr(),
            blind_fin.data_ptr(), *(x.data_ptr() for x in out), stream)
    elif mode == "head":
        r, bx, by = args
        out = empty(2)
        rc = lib.bullet_head_launch(r.data_ptr(), bx.data_ptr(),
                                    by.data_ptr(), out.data_ptr(), stream)
    else:
        c, x_hat, a_hat, blind_fin, drr = args
        out = empty(2)
        rc = lib.bullet_tail_launch(c.data_ptr(), x_hat.data_ptr(),
                                    a_hat.data_ptr(), blind_fin.data_ptr(),
                                    drr.data_ptr(), out.data_ptr(), stream)
    bullet_step.launches[mode] += 1
    _build.check(rc, f"bullet_step {mode}")
    return out


bullet_step.launches = collections.Counter()
