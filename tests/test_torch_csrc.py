"""The CUDA kernels' field and point arithmetic (``csrc/fq.cuh``,
``csrc/fp25519.cuh``) compiled for the host with g++ and held against
python-int oracles.

The headers are plain C++ apart from CUDA's qualifiers and vector types,
which a small shim defines away, so the arithmetic that runs inside the
kernels is checked here without a card.  Values include the edge cases
0, 1, q-1, p-1, p and the lazy 2^256 - 1.
"""

import ctypes
import os
import random
import shutil
import subprocess

import jax  # noqa: F401  (imported first in every port test file)
import pytest
import torch  # noqa: F401

from spartan_tpu.core import edwards as jed
from spartan_tpu.core import ristretto as jri
from spartan_tpu.core.field import P25519 as P
from spartan_tpu.core.field import Q

CSRC = os.path.join(os.path.dirname(__file__), "..", "spartan_tpu_torch",
                    "csrc")

SHIM = r"""
#include <stdint.h>
#define __device__
#define __forceinline__ inline
#define __constant__
struct uint4 { uint32_t x, y, z, w; };
static inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z,
                               uint32_t w) { return uint4{x, y, z, w}; }
#include "fq.cuh"
#include "fp25519.cuh"
extern "C" {
void h_fq_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) { fq_mul(r, a, b); }
void h_fq_add(uint32_t* r, const uint32_t* a, const uint32_t* b) { fq_add(r, a, b); }
void h_fq_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) { fq_sub(r, a, b); }
void h_fp_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) { fp_mul(r, a, b); }
void h_fp_add(uint32_t* r, const uint32_t* a, const uint32_t* b) { fp_add(r, a, b); }
void h_fp_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) { fp_sub(r, a, b); }
void h_fp_canon(uint32_t* r) { fp_canon(r); }
void h_ge_add(uint32_t* r, const uint32_t* p, const uint32_t* q) {
  ge_t a, b, c; ge_load(a, p); ge_load(b, q); ge_add(c, a, b); ge_store(r, c);
}
void h_ge_dbl(uint32_t* r, const uint32_t* p) {
  ge_t a, c; ge_load(a, p); ge_dbl(c, a); ge_store(r, c);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    d = tmp_path_factory.mktemp("csrc_host")
    src = d / "shim.cpp"
    src.write_text(SHIM)
    so = d / "libshim.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-I", CSRC, str(src), "-o", str(so)], check=True)
    return ctypes.CDLL(str(so))


def _buf(x: int, words: int = 8):
    return (ctypes.c_uint32 * words)(
        *[(x >> (32 * i)) & 0xFFFFFFFF for i in range(words)])


def _val(buf) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(buf))


def _op(lib, name, *args):
    out = _buf(0)
    getattr(lib, name)(out, *(_buf(a) for a in args))
    return _val(out)


R = 1 << 256
M = R - 1


def test_fq_ops(lib):
    rng = random.Random(11)
    xs = [0, 1, Q - 1, 2, Q - 2] + [rng.randrange(Q) for _ in range(300)]
    ys = [Q - 1, 0, Q - 1, Q - 1, 7] + [rng.randrange(Q) for _ in range(300)]
    r_inv = pow(R, -1, Q)
    for x, y in zip(xs, ys):
        assert _op(lib, "h_fq_mul", x, y) == x * y * r_inv % Q
        assert _op(lib, "h_fq_add", x, y) == (x + y) % Q
        assert _op(lib, "h_fq_sub", x, y) == (x - y) % Q


def test_fp_lazy_ops(lib):
    rng = random.Random(12)
    xs = [0, 1, P - 1, P, M, 19, 38, 37] + [rng.randrange(R) for _ in range(300)]
    ys = [M, M, P - 1, P - 1, M, 0, M, 38] + [rng.randrange(R) for _ in range(300)]
    for x, y in zip(xs, ys):
        for name, ref in (("h_fp_mul", x * y), ("h_fp_add", x + y),
                          ("h_fp_sub", x - y)):
            out = _op(lib, name, x, y)
            assert out < R and out % P == ref % P, (name, x, y)
            buf = _buf(out)
            lib.h_fp_canon(buf)
            assert _val(buf) == ref % P


def _pt_buf(pt):
    return _buf(sum(c << (256 * k) for k, c in
                    enumerate((pt.X, pt.Y, pt.Z, pt.T))), 32)


def _pt(buf) -> "jed.Point":
    v = _val(buf)
    X, Y, Z, T = ((v >> (256 * k)) % R % P for k in range(4))
    return jed.Point(X, Y, Z, T)


def test_point_ops(lib):
    rng = random.Random(13)
    pts = [jri.from_uniform_bytes(rng.randbytes(64)) for _ in range(8)]
    pts.append(jed.Point.identity())
    for p in pts:
        for q in pts:
            out = (ctypes.c_uint32 * 32)()
            lib.h_ge_add(out, _pt_buf(p), _pt_buf(q))
            assert jri.encode(_pt(out)) == jri.encode(p.add(q))
        out = (ctypes.c_uint32 * 32)()
        lib.h_ge_dbl(out, _pt_buf(p))
        assert jri.encode(_pt(out)) == jri.encode(p.double())
