"""ristretto255 encoding of device point batches (RFC 9496 ENCODE).

``compress_to_bytes`` encodes on the host through the native batch
encoder: the canonical coordinates come off the device as X|Y|Z|T
32-byte blobs, which is the native library's point layout.  Without the
native library each point is encoded by the Python core.

``compress`` keeps the encoding on the device (the JAX package's
``curve/ristretto.py:26``), for the device bullet rounds and the
dot-product-log's Cx: kernel K4 (``csrc/ristretto.cu``) on the card,
``compress_plain`` on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, native
from ..core import edwards as host_ed
from ..core import ristretto as host_ri
from ..ff import fp25519 as fp
from ..ff import limb
from .edwards import PointArray, stack


def compress_to_bytes(p: PointArray) -> list[bytes]:
    """Batch ENCODE: PointArray (...,) with canonical coordinates ->
    list of 32-byte encodings (flattened batch order)."""
    s = stack(p).reshape(-1, 4, 8).cpu()
    n = s.shape[0]
    blobs = s.numpy().astype("<i4").tobytes()
    lib = native.get_lib()
    if lib is not None:
        out = ctypes.create_string_buffer(32 * n)
        lib.spartan_ristretto_encode_batch(blobs, n, out)
        raw = out.raw
        return [raw[32 * i:32 * i + 32] for i in range(n)]
    return [host_ri.encode(host_ed.Point._from_blob(blobs[128 * i:128 * i + 128]))
            for i in range(n)]


def compress_plain(p: PointArray) -> torch.Tensor:
    """The plain PyTorch version of kernel K4: PointArray (...,) ->
    the encodings' s, canonical, (..., 8) int32 (32 little-endian
    bytes).  Its calls on CUDA tensors are counted in ``cuda_calls``:
    the main path makes none."""
    X, Y, Z, T = p
    if X.is_cuda:
        compress_plain.cuda_calls += 1
    dev = X.device
    sqrt_m1 = fp.encode_ints([fp.SQRT_M1], dev)[0]
    u1 = fp.mul(fp.add(Z, Y), fp.sub(Z, Y))
    u2 = fp.mul(X, Y)
    one = fp.encode_ints([1], dev)[0].expand_as(u1)
    _, invsqrt = fp.sqrt_ratio_m1(one, fp.mul(u1, fp.square(u2)))
    den1 = fp.mul(invsqrt, u1)
    den2 = fp.mul(invsqrt, u2)
    z_inv = fp.mul(fp.mul(den1, den2), T)
    ix0 = fp.mul(X, sqrt_m1)
    iy0 = fp.mul(Y, sqrt_m1)
    enchanted = fp.mul(den1, fp.encode_ints([host_ri.INVSQRT_A_MINUS_D],
                                            dev)[0])
    rotate = fp.is_negative(fp.mul(T, z_inv)).unsqueeze(-1)
    x = torch.where(rotate, iy0, X)
    y = torch.where(rotate, ix0, Y)
    den_inv = torch.where(rotate, enchanted, den2)
    flip = fp.is_negative(fp.mul(x, z_inv)).unsqueeze(-1)
    y = torch.where(flip, fp.neg(y), y)
    return fp.ct_abs(fp.mul(den_inv, fp.sub(Z, y)))


compress_plain.cuda_calls = 0


def _declare(lib) -> None:
    p = ctypes.c_void_p
    lib.ristretto_encode_launch.argtypes = [p, p, ctypes.c_int, p]
    lib.ristretto_encode_launch.restype = ctypes.c_int
    lib.g_mul_chain_launch.argtypes = [p, ctypes.c_int, ctypes.c_int, p]
    lib.g_mul_chain_launch.restype = ctypes.c_int
    lib.empty_launch.argtypes = [p]
    lib.empty_launch.restype = ctypes.c_int


def compress(p: PointArray) -> torch.Tensor:
    """Kernel K4 on the card, its plain version on the CPU: PointArray
    (...,) -> (..., 8) int32 encodings, on the points' device.  View
    the result as ``torch.uint8`` for the 32 bytes of each."""
    dev = p.x.device
    if dev.type == "cpu":
        return compress_plain(p)
    if dev.type != "cuda":
        raise ValueError(f"compress: unsupported device {dev}")
    shape = p.shape
    pts = stack(p).reshape(-1, 4, limb.NWORDS)
    if pts.dtype != torch.int32:
        raise ValueError(f"compress: int32 coordinates, got {pts.dtype}")
    out = torch.empty((pts.shape[0], limb.NWORDS), dtype=torch.int32,
                      device=dev)
    lib = _build.load("ristretto", _declare)
    rc = lib.ristretto_encode_launch(pts.data_ptr(), out.data_ptr(),
                                     pts.shape[0], _build.stream_handle(dev))
    compress.launches += 1
    _build.check(rc, "ristretto_encode")
    return out.reshape(*shape, limb.NWORDS)


compress.launches = 0
