"""Loader for the native host-crypto library (host_crypto.cpp).

Builds on first use with g++ (-O3 -march=native -shared -fPIC) into the
port's build directory (``build/`` beside the package, see ``_build.py``),
keyed by a hash of the source and of the host CPU, so edits recompile
automatically, a copy of the checkout on another machine builds its own
library, and repeated imports are instant.  If no compiler is available,
everything falls back to the pure-Python implementations in ``core`` —
set SPARTAN_TPU_NATIVE=0 to force the fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "host_crypto.cpp")

_lib = None
_tried = False


def _cpu_id() -> bytes:
    """The machine and its CPU's feature flags: what -march=native
    compiles for."""
    flags = b""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    flags = line
                    break
    except OSError:
        pass
    return platform.machine().encode() + b"\0" + flags


def _build_and_load() -> ctypes.CDLL | None:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + b"\0" + _cpu_id()).hexdigest()[:16]
    from .._build import build_dir

    cache_dir = os.environ.get("SPARTAN_TPU_NATIVE_CACHE", build_dir())
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, f"host_crypto_{tag}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
               "-fPIC", _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired):
            return None
        os.replace(tmp, so_path)
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None

    u8p = ctypes.POINTER(ctypes.c_uint8)
    size_t = ctypes.c_size_t

    lib.spartan_keccak_f1600.argtypes = [ctypes.c_char_p]
    lib.spartan_strobe_init.argtypes = [ctypes.c_char_p, ctypes.c_char_p, size_t]
    for name in ("spartan_strobe_meta_ad", "spartan_strobe_ad",
                 "spartan_strobe_key"):
        getattr(lib, name).argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, size_t, ctypes.c_int]
    lib.spartan_strobe_prf.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, size_t, ctypes.c_int]

    lib.spartan_ge_add.argtypes = [ctypes.c_char_p] * 2 + [ctypes.c_char_p]
    lib.spartan_ge_double.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.spartan_ge_neg.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.spartan_ge_scalarmul.argtypes = [ctypes.c_char_p] * 2 + [ctypes.c_char_p]
    lib.spartan_ge_scalarmul_ct.argtypes = (
        [ctypes.c_char_p] * 2 + [ctypes.c_char_p])
    lib.spartan_ge_msm.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, size_t, ctypes.c_char_p]
    lib.spartan_ge_msm_ct.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, size_t, ctypes.c_char_p]
    lib.spartan_ge_seq_points.argtypes = [
        ctypes.c_char_p, size_t, ctypes.c_char_p]
    lib.spartan_ge_table_niels.argtypes = [
        ctypes.c_char_p, size_t, ctypes.c_char_p]
    lib.spartan_ristretto_decode.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.spartan_ristretto_decode.restype = ctypes.c_int
    lib.spartan_ristretto_encode.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.spartan_ristretto_encode_batch.argtypes = [
        ctypes.c_char_p, size_t, ctypes.c_char_p]
    lib.spartan_ristretto_from_uniform.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p]

    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.spartan_fq_eq_evals.argtypes = [ctypes.c_char_p, size_t,
                                        ctypes.c_char_p]
    lib.spartan_fq_sparse_eval.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, u64p, u64p, ctypes.c_char_p,
        size_t, ctypes.c_char_p]
    lib.spartan_fq_spmv.argtypes = [
        u64p, u64p, ctypes.c_char_p, size_t, ctypes.c_char_p, size_t,
        ctypes.c_char_p]
    del u8p
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The loaded native library, or None (pure-Python fallback)."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("SPARTAN_TPU_NATIVE", "1") == "0":
        return None
    _lib = _build_and_load()
    return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# Host-path scalar-field (mod q) batch helpers — the verifier's
# eval_sparse_polys (r1cs.rs:300-303) is latency-bound public-data work
# that must never pay an XLA compile; these run on the C++ Montgomery
# core in host_crypto.cpp.
# ---------------------------------------------------------------------------

def fq_eq_evals_mont(r_ints: list[int]) -> bytes:
    """eq(r, x) hypercube table (dense_mlpoly.rs:68-84 ordering,
    r[0] = top variable) as 2^ell 32-byte LE Montgomery entries."""
    import ctypes as _ct

    lib = get_lib()
    assert lib is not None
    ell = len(r_ints)
    rb = b"".join(int(x).to_bytes(32, "little") for x in r_ints)
    out = _ct.create_string_buffer(32 << ell)
    lib.spartan_fq_eq_evals(rb, ell, out)
    return out.raw


def fq_sparse_eval(eq_rx: bytes, eq_ry: bytes, rows, cols,
                   vals_mont: bytes) -> int:
    """sum_k eq_rx[rows[k]] * eq_ry[cols[k]] * vals[k] mod q.
    rows/cols: numpy uint64 arrays; vals_mont: nnz 32-byte LE
    Montgomery entries (the device limb layout, 16x u16 LE)."""
    import ctypes as _ct

    import numpy as np

    lib = get_lib()
    assert lib is not None
    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    cols = np.ascontiguousarray(cols, dtype=np.uint64)
    nnz = rows.shape[0]
    assert len(vals_mont) == 32 * nnz
    out = _ct.create_string_buffer(32)
    u64p = _ct.POINTER(_ct.c_uint64)
    lib.spartan_fq_sparse_eval(
        eq_rx, eq_ry, rows.ctypes.data_as(u64p), cols.ctypes.data_as(u64p),
        vals_mont, nnz, out)
    return int.from_bytes(out.raw, "little")


def fq_spmv(rows, cols, vals_mont: bytes, z_mont: bytes,
            num_rows: int) -> list[int]:
    """out[rows[k]] += vals[k] * z[cols[k]] mod q (multiply_vec,
    sparse_mlpoly.rs:454-464); returns plain ints."""
    import ctypes as _ct

    import numpy as np

    lib = get_lib()
    assert lib is not None
    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    cols = np.ascontiguousarray(cols, dtype=np.uint64)
    nnz = rows.shape[0]
    assert len(vals_mont) == 32 * nnz
    out = _ct.create_string_buffer(32 * num_rows)
    u64p = _ct.POINTER(_ct.c_uint64)
    lib.spartan_fq_spmv(
        rows.ctypes.data_as(u64p), cols.ctypes.data_as(u64p), vals_mont,
        nnz, z_mont, num_rows, out)
    raw = out.raw
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little")
            for i in range(num_rows)]
