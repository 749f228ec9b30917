"""miniz (tdefl) zlib stream for the instance digest — byte parity.

The reference digests ``zlib(bincode(shape))`` through flate2's
``rust_backend`` — miniz_oxide, a port of miniz's tdefl compressor —
at ``Compression::default()`` (level 6) (reference Cargo.toml:31,75;
r1cs.rs:154-158).  CPython's ``zlib`` (madler) emits a *different*
(equally valid) deflate stream for the same input at the same level:
measured, the two streams differ for every nonempty input tried
(artifacts/miniz_ab_zlib.py).  The digest is absorbed into every
transcript (lib.rs:511-515), so a madler digest breaks
cross-verification for every instance.

This module binds the miniz 3.0.2 C library that torch vendors
(``mz_compress2`` is exported from ``libtorch_cpu.so``, found beside
``torch/__init__.py``) — the exact compressor family miniz_oxide ports.
``mz_compress2(level=6)`` performs one-shot compression with the same
flag mapping (``create_comp_flags_from_zip_params(6, 15, 0)``) the
Rust side derives, and tdefl's output is chunking-independent under
MZ_NO_FLUSH, so the one-shot stream equals flate2's streamed one.

There is no fallback: without the vendored miniz the digest, and with it
every transcript, would differ, so a missing library raises.
``SPARTAN_TPU_MINIZ_LIB`` points at an explicit shared object.
"""

from __future__ import annotations

import ctypes
import os
import zlib

_lib = None


def _candidates() -> list[str]:
    import torch

    cands = []
    explicit = os.environ.get("SPARTAN_TPU_MINIZ_LIB")
    if explicit:
        cands.append(explicit)
    cands.append(os.path.join(os.path.dirname(torch.__file__), "lib",
                              "libtorch_cpu.so"))
    return cands


def _load():
    global _lib
    if _lib is not None:
        return _lib
    for path in _candidates():
        if not os.path.exists(path):
            continue
        try:
            lib = ctypes.CDLL(path)
            fn = lib.mz_compress2
        except (OSError, AttributeError):
            continue
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_ulong),
                       ctypes.c_char_p, ctypes.c_ulong, ctypes.c_int]
        _lib = fn
        break
    return _lib


def available() -> bool:
    return _load() is not None


def compress(data: bytes, level: int = 6) -> bytes:
    """miniz (tdefl) zlib stream; raises RuntimeError if unavailable."""
    fn = _load()
    if fn is None:
        raise RuntimeError("no vendored miniz found")
    n = len(data)
    # mz_compressBound: 110% + 128, but never below the stored-block
    # worst case (5 B of block header per 31 KB) — high-entropy bincode
    # (Montgomery scalars) can be incompressible (ADVICE r3 low)
    cap = max(128 + n * 110 // 100,
              128 + n + (n // (31 * 1024) + 1) * 5)
    dst = ctypes.create_string_buffer(cap)
    dlen = ctypes.c_ulong(cap)
    rc = fn(dst, ctypes.byref(dlen), data, n, int(level))
    if rc != 0:
        raise RuntimeError(f"mz_compress2 failed: {rc}")
    out = dst.raw[: dlen.value]
    assert zlib.decompress(out) == data  # cheap validity cross-check
    return out


def zlib_stream(data: bytes, level: int = 6) -> bytes:
    """The reference-parity stream (vendored miniz).  Raises when the
    library is missing: a madler-zlib digest would change every
    transcript."""
    if not available():
        raise RuntimeError(
            "spartan_tpu_torch: torch's vendored miniz (mz_compress2 in "
            f"libtorch_cpu.so) was not found at {_candidates()}; the "
            "instance digest needs it")
    return compress(data, level)
