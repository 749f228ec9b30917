"""The CUDA kernels' field and point arithmetic (``csrc/fq.cuh``,
``csrc/fp25519.cuh``, ``csrc/carry.cuh``), kernel K3's keccak-f[1600]
permutation with one Keccak lane a warp lane (``csrc/keccak.cuh``, the
warp's 32 lanes in a loop), kernel K4's product spread over a group of
8 lanes (``csrc/fp25519_group.cuh``, the group's lanes in a loop) and
its ristretto255 encode (``csrc/ristretto.cuh``), kernel K5's constant-time scalar
multiplication by a quad of lanes (``csrc/point_msm.cuh``: the 4-way
doubling and cached addition, the signed radix-16 recoding, the whole
ladder, and the plain version against it bit for bit) and kernel K6's
safegcd inverse and its divstep batches (64-bit and 32-bit), wide
reduction and Montgomery exit
(``csrc/bullet_step.cuh``), and kernel K9's row body (``csrc/fq_spmv.cuh``)
compiled for the host with g++ and held
against python-int oracles, ``core/keccak.py`` and
``core/ristretto.encode``.

The headers are plain C++ apart from CUDA's qualifiers and vector types,
which a small shim defines away, so the arithmetic that runs inside the
kernels is checked here without a card (K5's quad runs its four lanes
in a loop there, a shuffle reading every lane before writing any).  Off
the device, ``carry.cuh``
gives its carry-chain primitives in C++ with the carry flag in a
variable, so the chains' word and carry bookkeeping is what is checked
here (the PTX instructions themselves only on the card, kernel against
plain version).  Values include the edge cases 0, 1, q-1, p-1, p and the
lazy 2^256 - 1.
"""

import ctypes
import os
import random
import shutil
import subprocess

import jax  # noqa: F401  (imported first in every port test file)
import pytest
import torch  # noqa: F401

from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu.core import edwards as jed
from spartan_tpu.core import field as jfield
from spartan_tpu.core import keccak as jkeccak
from spartan_tpu.core import ristretto as jri
from spartan_tpu.core.field import P25519 as P
from spartan_tpu.core.field import Q

CSRC = os.path.join(os.path.dirname(__file__), "..", "spartan_tpu_torch",
                    "csrc")

SHIM = r"""
#include <stdint.h>
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__
struct uint4 { uint32_t x, y, z, w; };
static inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z,
                               uint32_t w) { return uint4{x, y, z, w}; }
#include "fq.cuh"
#include "fp25519.cuh"
#include "keccak.cuh"
#include "ristretto.cuh"
#include "point_msm.cuh"
#include "bullet_step.cuh"
#include "fq_spmv.cuh"
extern "C" {
static void q_load(qfe& q, const uint32_t* p) {
  for (int k = 0; k < 4; k++) for (int i = 0; i < 8; i++) q.w[k][i] = p[8 * k + i];
}
static void q_store(uint32_t* p, const qfe& q) {
  for (int k = 0; k < 4; k++) for (int i = 0; i < 8; i++) p[8 * k + i] = q.w[k][i];
}
void h_q_scalar_mul(uint32_t* r, const uint32_t* p, const uint32_t* s) {
  qfe a, c; q_load(a, p); q_scalar_mul(c, a, s); q_store(r, c);
}
void h_q_dbl(uint32_t* r, const uint32_t* p) {
  qfe a, c; q_load(a, p); q_dbl(c, a); q_store(r, c);
}
void h_q_cadd(uint32_t* r, const uint32_t* p, const uint32_t* q, int neg) {
  qfe a, b, c, tab[8], e;
  q_load(a, p); q_load(b, q); q_to_cached(c, b);
  for (int t = 0; t < 8; t++) tab[t] = c;  // the entry of +-1
  q_select(e, tab, neg ? -1 : 1);
  q_cadd(c, a, e); q_store(r, c);
}
void h_recode16(int8_t* dg, const uint32_t* s) {
  uint32_t t[8]; recode16(t, s);
  for (int w = 0; w < 64; w++) {
    int v = (t[w >> 3] >> (4 * (w & 7))) & 15;
    dg[w] = (int8_t)(w < 63 ? v - 8 : v);
  }
}
void h_fq_inv(uint32_t* r, const uint32_t* x) { fq_inv(r, x); }
void h_fq_modinv(uint32_t* r, const uint32_t* x) { fq_modinv(r, x); }
int32_t h_divsteps_30(int32_t zeta, uint32_t f0, uint32_t g0, int64_t* t) {
  trans2x2_32_t m; int32_t z = divsteps_30(zeta, f0, g0, m);
  t[0] = m.u; t[1] = m.v; t[2] = m.q; t[3] = m.r; return z;
}
int64_t h_divsteps_59(int64_t zeta, uint64_t f0, uint64_t g0, int64_t* t) {
  trans2x2_t m; int64_t z = divsteps_59(zeta, f0, g0, m);
  t[0] = m.u; t[1] = m.v; t[2] = m.q; t[3] = m.r; return z;
}
void h_fq_from_mont(uint32_t* r, const uint32_t* x) { fq_from_mont(r, x); }
void h_fq_to_mont2(uint32_t* r, const uint32_t* x) {
  fq_to_mont_n<2>((uint32_t(*)[8])r, (const uint32_t(*)[8])x);
}
void h_fq_from_bytes_wide(uint32_t* r, const uint8_t* b) {
  fq_from_bytes_wide(r, b);
}
void h_keccak_f1600(uint64_t* a) {
  klane k;
  for (int t = 0; t < 32; t++) k.v[t] = a[t < 25 ? t : t - 25];
  keccak_f1600_lanes(k);
  for (int t = 0; t < 25; t++) a[t] = k.v[t];
}
void h_g_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) { g_mul(r, a, b); }
void h_ristretto_encode(uint32_t* s, const uint32_t* p) {
  ge_t q; ge_load(q, p); ristretto_encode(s, q);
}
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
void h_ge_madd(uint32_t* r, const uint32_t* p, const uint32_t* q) {
  ge_t a, c; ge_pre_t b; ge_load(a, p); ge_pre_load(b, q);
  ge_madd(c, a, b); ge_store(r, c);
}
void h_fq_mul3(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  fq_mul_n<3>((uint32_t(*)[8])r, (const uint32_t(*)[8])a,
              (const uint32_t(*)[8])b);
}
void h_fq_add_lazy(uint32_t* r, const uint32_t* a, const uint32_t* b) { fq_add_lazy(r, a, b); }
void h_fq_acc_add(uint32_t* acc, const uint32_t* x) { fq_acc_add(acc, x); }
void h_fq_acc_add9(uint32_t* acc, const uint32_t* x) { fq_acc_add9(acc, x); }
void h_fq_reduce_wide(uint32_t* r, const uint32_t* v) { fq_reduce_wide(r, v); }
void h_fq_from_mont2(uint32_t* r, const uint32_t* x) {
  fq_from_mont_n<2>((uint32_t(*)[8])r, (const uint32_t(*)[8])x);
}
void h_fq_eq_step2(uint32_t* lo, uint32_t* hi, const uint32_t* t,
                   const uint32_t* r) {
  fq_eq_step_n<2>((uint32_t(*)[8])lo, (uint32_t(*)[8])hi,
                  (const uint32_t(*)[8])t, (const uint32_t(*)[8])r);
}
void h_fq_acc_mul2(uint32_t* acc, const uint32_t* a, const uint32_t* w) {
  fq_acc_mul_n<2>(acc, (const uint32_t(*)[8])a, (const uint32_t(*)[8])w);
}
void h_fq_spmv_acc2(uint32_t* acc, const int32_t* idx, const uint32_t* val,
                    const int32_t* perm, const uint32_t* x, long j0, long e,
                    long step) {
  fq_spmv_acc<2>(acc, idx, val, perm, x, j0, e, step);
}
void h_fq_spmv_finish(uint32_t* r, const uint32_t* acc, long n) {
  fq_spmv_finish(r, acc, n);
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


def _op9(lib, name, acc, x, xwords):
    buf = _buf(acc, 9)
    getattr(lib, name)(buf, _buf(x, xwords))
    return _val(buf)


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
    # three independent products side by side (fq_mul_n<3>)
    for k in range(0, len(xs) - 2, 3):
        out = _buf(0, 24)
        lib.h_fq_mul3(out, _buf(xs[k] | xs[k + 1] << 256 | xs[k + 2] << 512, 24),
                      _buf(ys[k] | ys[k + 1] << 256 | ys[k + 2] << 512, 24))
        v = _val(out)
        assert [(v >> (256 * n)) % R for n in range(3)] == [
            xs[k + n] * ys[k + n] * r_inv % Q for n in range(3)]


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


M8 = (7 * 16 ** 63 + 8) // 15  # its digits 0 ... 62 are all -8


def test_scalar_mul_ct(lib):
    """K5's per-point ladder on a quad: s * P for the scalars 0, 1, 15,
    16, q - 1, 2^252, one whose digits are all -8 and random ones, the
    identity point included."""
    rng = random.Random(17)
    pts = [jri.from_uniform_bytes(rng.randbytes(64)) for _ in range(3)]
    pts.append(jed.Point.identity())
    for p in pts:
        for k in (0, 1, 15, 16, Q - 1, 1 << 252, M8, rng.randrange(Q)):
            out = (ctypes.c_uint32 * 32)()
            lib.h_q_scalar_mul(out, _pt_buf(p), _buf(k))
            assert jri.encode(_pt(out)) == jri.encode(p.mul(k)), k


@pytest.mark.parametrize("op", ["dbl", "cadd", "cadd_neg"])
def test_quad_point_ops(lib, op):
    """The 4-way doubling and the 4-way addition of a cached entry (and
    of its negation, as a negative digit selects it), the quad's four
    lanes simulated by a loop: against the host's point arithmetic, and
    each result a point of the extended form (X Y = Z T)."""
    pts = _pts(18, 5) + [jed.Point.identity()]
    for p in pts:
        for q in (pts if op != "dbl" else [None]):
            out = (ctypes.c_uint32 * 32)()
            if op == "dbl":
                lib.h_q_dbl(out, _pt_buf(p))
                want = p.double()
            else:
                lib.h_q_cadd(out, _pt_buf(p), _pt_buf(q), op == "cadd_neg")
                want = p.add(q.neg() if op == "cadd_neg" else q)
            got = _pt(out)
            assert jri.encode(got) == jri.encode(want)
            assert got.X * got.Y % P == got.Z * got.T % P


def test_signed_radix16_recoding(lib):
    """The branch-free recoding: 64 digits in [-8, 8) that recompose the
    scalar, for 0, 1, q - 1, 2^252, the all -8 scalar and random ones."""
    rng = random.Random(20)
    for s in [0, 1, Q - 1, 1 << 252, M8, 8, 0x88] + [
            rng.randrange(Q) for _ in range(50)]:
        dg = (ctypes.c_int8 * 64)()
        lib.h_recode16(dg, _buf(s))
        d = list(dg)
        assert all(-8 <= x < 8 for x in d), s
        assert sum(x << (4 * w) for w, x in enumerate(d)) == s
    lib.h_recode16(dg, _buf(M8))
    assert list(dg)[:63] == [-8] * 63


def test_plain_point_msm_equals_host_kernel(lib):
    """K5's plain version (``curve/point_msm.py``), one point a group,
    against the quad ladder compiled for the host: the same canonical
    coordinates, word for word."""
    from spartan_tpu_torch.curve import edwards as ted
    from spartan_tpu_torch.curve import point_msm as pm
    from spartan_tpu_torch.ff import limb

    rng = random.Random(21)
    pts = _pts(22, 5) + [jed.Point.identity()]
    ks = [0, Q - 1, M8, 1 << 252, rng.randrange(Q), rng.randrange(Q)]
    got = pm.point_msm(ted.stack(ted.from_host(pts)), limb.ints_to_limbs(ks),
                       range(len(pts) + 1))
    cols = [limb.limbs_to_ints(got[:, c]) for c in range(4)]
    for g, (p, k) in enumerate(zip(pts, ks)):
        out = (ctypes.c_uint32 * 32)()
        lib.h_q_scalar_mul(out, _pt_buf(p), _buf(k))
        v = _val(out)
        assert [(v >> (256 * c)) % R % P for c in range(4)] == [
            col[g] for col in cols], g


def test_fq_safegcd_inverse(lib):
    """K6's safegcd inverse: x * x^-1 = 1 mod q for 1, q - 1, every power
    of two below q and random x (and 0 for 0), against pow(x, -1, q)."""
    rng = random.Random(23)
    for x in [1, Q - 1, Q - 2] + [1 << k for k in range(253)] + [
            rng.randrange(1, Q) for _ in range(200)]:
        inv = _op(lib, "h_fq_modinv", x)
        assert inv == pow(x, -1, Q) and x * inv % Q == 1, x
    assert _op(lib, "h_fq_modinv", 0) == 0


def _divsteps(zeta, f, g, steps, scale):
    """``steps`` divsteps of safegcd on python ints (f odd) in
    libsecp256k1's form, zeta = -(delta + 1/2): the new zeta, f, g and
    the transition matrix (u, v, q, r), started from ``scale`` times the
    identity and doubled in u, v at every step."""
    u, v, q, r = scale, 0, 0, scale
    for _ in range(steps):
        if zeta < 0 and g & 1:
            zeta, f, g = -zeta - 2, g, (g - f) >> 1
            u, v, q, r = 2 * q, 2 * r, q - u, r - v
        else:
            if g & 1:
                g, q, r = (g + f) >> 1, q + u, r + v
            else:
                g >>= 1
            zeta, u, v = zeta - 1, 2 * u, 2 * v
    return zeta, f, g, (u, v, q, r)


@pytest.mark.parametrize("width", [30, 59])
def test_divsteps_batch(lib, width):
    """A batch of K6's divsteps on the low word of f and g, 59 on 64-bit
    words (the fold's) and 30 on 32-bit words (the form whose chain the
    fold's bound counts): the matrix and zeta equal the python-int
    divsteps', and the matrix maps (f, g) to 2^62 or 2^30 times the
    batch's (f, g)."""
    bits, scale, shift = {30: (32, 1, 30), 59: (64, 8, 62)}[width]
    word = ctypes.c_int32 if bits == 32 else ctypes.c_int64
    fn = getattr(lib, f"h_divsteps_{width}")
    fn.restype = word
    fn.argtypes = [word, ctypes.c_uint32 if bits == 32 else ctypes.c_uint64,
                   ctypes.c_uint32 if bits == 32 else ctypes.c_uint64,
                   ctypes.POINTER(ctypes.c_int64)]
    rng = random.Random(29 + width)
    cases = [(-1, Q, 1), (-1, 1, 0), (-1, Q, Q - 1), (5, 1, R - 1),
             (-7, R - 1, 1 << 200)] + [
        (rng.randrange(-700, 700), rng.randrange(R) | 1, rng.randrange(R))
        for _ in range(300)]
    for zeta, f, g in cases:
        t = (ctypes.c_int64 * 4)()
        got = fn(zeta, f % (1 << bits), g % (1 << bits), t)
        zeta_n, f_n, g_n, m = _divsteps(zeta, f, g, width, scale)
        assert (got, tuple(t)) == (zeta_n, m), (zeta, f, g)
        u, v, q, r = m
        assert (u * f + v * g, q * f + r * g) == (f_n << shift, g_n << shift)


def test_fq_inverse_and_conversions(lib):
    """K6's inverse of a Montgomery residue (safegcd, then one product by
    R^3), a residue's canonical value, the Montgomery map of two values
    side by side (the elementwise kernel's, also of values >= q) and the
    Montgomery form of 64 challenge bytes."""
    rng = random.Random(19)
    for x in (1, 2, Q - 1, rng.randrange(Q), rng.randrange(Q)):
        assert _op(lib, "h_fq_inv", x * R % Q) == pow(x, -1, Q) * R % Q
        assert _op(lib, "h_fq_from_mont", x * R % Q) == x
    assert _op(lib, "h_fq_inv", 0) == 0
    xs = [0, 1, Q - 1, 1 << 252, Q, M, rng.randrange(Q), rng.randrange(R)]
    for x, y in zip(xs[::2], xs[1::2]):
        out = _buf(0, 16)
        lib.h_fq_to_mont2(out, _buf(x | y << 256, 16))
        assert _val(out) == (x * R % Q) | (y * R % Q) << 256, (x, y)
    for b in (bytes(64), b"\xff" * 64, rng.randbytes(64)):
        out = _buf(0)
        lib.h_fq_from_bytes_wide(out, (ctypes.c_uint8 * 64)(*b))
        assert _val(out) == int.from_bytes(b, "little") % Q * R % Q


def _pre_buf(pt):
    """A host point as the table's precomputed entry (y+x, y-x, 2d*x*y)."""
    x, y = pt.to_affine()
    vals = ((y + x) % P, (y - x) % P, jed.D2 * x * y % P)
    return _buf(sum(c << (256 * k) for k, c in enumerate(vals)), 24)


def _pts(seed: int, n: int):
    rng = random.Random(seed)
    return [jri.from_uniform_bytes(rng.randbytes(64)) for _ in range(n)]


@pytest.mark.parametrize("pairs", ["random", "edges"])
def test_mixed_add(lib, pairs):
    """ge_madd against the host's point addition: every pair of a few
    points and the identity, on either side; and the edges p + p,
    p + (-p) and the identity's own entry (1, 1, 0)."""
    pts = _pts(14, 6) + [jed.Point.identity()]
    if pairs == "random":
        cases = [(p, q) for p in pts for q in pts]
    else:
        cases = [c for p in pts for c in ((p, p), (p, p.neg()),
                                          (p.neg(), p))]
    for p, q in cases:
        out = (ctypes.c_uint32 * 32)()
        lib.h_ge_madd(out, _pt_buf(p), _pre_buf(q))
        assert jri.encode(_pt(out)) == jri.encode(p.add(q))


EDGES = [0, 1, Q - 1, P - 1, M]
TOP = 1 << 288  # the 9-word accumulators' range


@pytest.mark.parametrize("op", ["acc_add", "acc_add9", "add_lazy",
                                "mul_lazy", "reduce_wide"])
def test_fq_accumulate_and_reduce(lib, op):
    """The 9-word accumulators, the lazy sum that feeds fq_mul's second
    operand, and the one reduction mod q, at the edge values 0, 1, q-1,
    p-1, 2^256-1 and at random values."""
    rng = random.Random(15)
    accs = [0, 1, Q - 1, M, TOP - 1 - M, (1 << 287) - 1]
    if op == "acc_add":
        xs = EDGES + [rng.randrange(1 << 256) for _ in range(20)]
        for acc in accs + [rng.randrange(1 << 287) for _ in range(20)]:
            for x in xs:
                if acc + x < TOP:
                    assert _op9(lib, "h_fq_acc_add", acc, x, 8) == acc + x
    elif op == "acc_add9":
        for acc in accs + [rng.randrange(1 << 287) for _ in range(20)]:
            for x in accs + [rng.randrange(1 << 287) for _ in range(5)]:
                if acc + x < TOP:
                    assert _op9(lib, "h_fq_acc_add9", acc, x, 9) == acc + x
    elif op == "add_lazy":
        xs = EDGES + [rng.randrange(1 << 255) for _ in range(20)]
        for x in xs:
            for y in xs:
                if x + y < 1 << 256:
                    assert _op(lib, "h_fq_add_lazy", x, y) == x + y
    elif op == "mul_lazy":
        # fq_mul takes a lazy second operand (< 2^256) beside a canonical
        # first
        r_inv = pow(1 << 256, -1, Q)
        xs = [0, 1, Q - 1] + [rng.randrange(Q) for _ in range(10)]
        ys = EDGES + [3 * Q - 1] + [rng.randrange(1 << 256) for _ in range(10)]
        for x in xs:
            for y in ys:
                assert _op(lib, "h_fq_mul", x, y) == x * y * r_inv % Q
    else:
        vs = EDGES + [TOP - 1, M + 1, Q * (1 << 32) + 5,
                      sum(EDGES)] + [rng.randrange(TOP) for _ in range(50)]
        for v in vs:
            out = _buf(0)
            lib.h_fq_reduce_wide(out, _buf(v, 9))
            assert _val(out) == v % Q, v


def _pair(x: int, y: int):
    return _buf(x | y << 256, 16)


def _halves(buf) -> list[int]:
    v = _val(buf)
    return [v % R, v >> 256]


@pytest.mark.parametrize("op", ["from_mont2", "eq_step2", "acc_mul2"])
def test_fq_kernel_mode_bodies(lib, op):
    """The bodies of K7's FROM_MONT and EQ modes and of K8's weighted
    sum, two elements side by side, at the edge values and at random
    ones: FROM_MONT takes any value below 2^256, the weighted sum
    accumulates up to the 9-word range."""
    rng = random.Random(16)
    r_inv = pow(R, -1, Q)
    xs = [0, 1, Q - 1] + [rng.randrange(Q) for _ in range(40)]
    ys = [Q - 1, 0, 1] + [rng.randrange(Q) for _ in range(40)]
    if op == "from_mont2":
        vs = EDGES + [rng.randrange(R) for _ in range(41)]
        for x, y in zip(vs[0::2], vs[1::2]):
            out = _buf(0, 16)
            lib.h_fq_from_mont2(out, _pair(x, y))
            assert _halves(out) == [x * r_inv % Q, y * r_inv % Q]
    elif op == "eq_step2":
        for k in range(len(xs) - 1):
            t, r = (xs[k], xs[k + 1]), (ys[k], ys[k + 1])
            lo, hi = _buf(0, 16), _buf(0, 16)
            lib.h_fq_eq_step2(lo, hi, _pair(*t), _pair(*r))
            want_hi = [a * b * r_inv % Q for a, b in zip(t, r)]
            assert _halves(hi) == want_hi
            assert _halves(lo) == [(a - h) % Q for a, h in zip(t, want_hi)]
    else:
        for acc in [0, Q - 1, TOP - 1 - 2 * Q, rng.randrange(1 << 280)]:
            for k in range(len(xs) - 1):
                a, w = (xs[k], xs[k + 1]), (ys[k], ys[k + 1])
                buf = _buf(acc, 9)
                lib.h_fq_acc_mul2(buf, _pair(*a), _pair(*w))
                assert _val(buf) == acc + sum(
                    x * y * r_inv % Q for x, y in zip(a, w))


@pytest.mark.parametrize("layout", ["identity", "indexed", "permuted"])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 33])
def test_fq_spmv_row_body(lib, n, layout):
    """K9's row body (``csrc/fq_spmv.cuh``): a row's n products, two side
    by side and then one at a time, walked by one thread (step 1) and
    split over a chunk block's threads (step 4, their accumulators
    summed), the inputs and values read through null index arrays (the
    identity), an input index, or an input index and a permutation of
    the values, and the row's one reduction (a conditional subtraction
    for up to two products): against python ints, with values and
    inputs at 0, 1 and q - 1 and at random."""
    p, i64 = ctypes.c_void_p, ctypes.c_long
    lib.h_fq_spmv_acc2.argtypes = [p, p, p, p, p, i64, i64, i64]
    lib.h_fq_spmv_finish.argtypes = [p, p, i64]
    rng = random.Random(30 + n)
    r_inv = pow(R, -1, Q)
    xs = [0, 1, Q - 1] + [rng.randrange(Q) for _ in range(37)]
    vals = [rng.choice([0, 1, Q - 1, rng.randrange(Q)]) for _ in range(n)]
    idx = list(range(n))
    if layout != "identity":
        idx = [rng.randrange(len(xs)) for _ in range(n)]
    at = list(range(n))
    if layout == "permuted":
        rng.shuffle(at)
    want = sum(vals[a] * xs[i] * r_inv % Q for a, i in zip(at, idx))
    vbuf = _buf(sum(v << (256 * j) for j, v in enumerate(vals)),
                max(8 * n, 8))
    xbuf = _buf(sum(x << (256 * j) for j, x in enumerate(xs)), 8 * len(xs))
    ibuf = (ctypes.c_int32 * max(n, 1))(*idx) if layout != "identity" \
        else None
    pbuf = (ctypes.c_int32 * max(n, 1))(*at) if layout == "permuted" \
        else None
    acc = _buf(0, 9)
    lib.h_fq_spmv_acc2(acc, ibuf, vbuf, pbuf, xbuf, 0, n, 1)
    assert _val(acc) == want
    out = _buf(0)
    lib.h_fq_spmv_finish(out, acc, n)
    assert _val(out) == want % Q
    total = 0
    for t in range(4):
        acc = _buf(0, 9)
        lib.h_fq_spmv_acc2(acc, ibuf, vbuf, pbuf, xbuf, t, n, 4)
        total += _val(acc)
    assert total == want


@pytest.mark.parametrize("square", [False, True], ids=["product", "square"])
def test_group_mul(lib, square):
    """K4's product and squaring on a group of 8 lanes (every lane
    computing its word, the columns gathered and carried in every lane)
    against python ints: at 0, 1, p - 1, p, 2^255, 2^256 - 1, lazy values
    at and above p, values whose column sum passes 2^256 ((2^255 - 1) *
    2^32 also carries out of word 0 when 38 is added back), and random
    values; the result below 2^256 and congruent."""
    rng = random.Random(24 + square)
    xs = [0, 1, P - 1, P, 1 << 255, M, P + 1, 2 * P, M - 18, 38, 19,
          M - (1 << 224), (1 << 255) - 1] + [
        rng.randrange(R) for _ in range(400)] + [
        M - rng.randrange(1 << rng.randrange(1, 200)) for _ in range(200)]
    ys = [M, M, P - 1, P - 1, 1 << 255, M, P + 1, 2 * P, 1, M, 38, 2,
          1 << 32] + [
        rng.randrange(R) for _ in range(400)] + [
        rng.choice([1, 2, 38, M]) for _ in range(200)]
    for x, y in zip(xs, ys):
        y = x if square else y
        out = _op(lib, "h_g_mul", x, y)
        assert out < R and out % P == x * y % P, (x, y)


@pytest.mark.parametrize("seed", range(4))
def test_keccak_permutation(lib, seed):
    rng = random.Random(16 + seed)
    for _ in range(8):
        lanes = [rng.randrange(1 << 64) for _ in range(25)]
        buf = (ctypes.c_uint64 * 25)(*lanes)
        lib.h_keccak_f1600(buf)
        assert list(buf) == jkeccak.keccak_f1600(lanes)


def _branch(pt):
    """(rotate, y flipped) of ENCODE at this representative."""
    X, Y, Z, T = pt.X, pt.Y, pt.Z, pt.T
    u1 = (Z + Y) * (Z - Y) % P
    _, inv = jfield.sqrt_ratio_m1(1, u1 * (X * Y) ** 2 % P)
    z_inv = inv * u1 % P * (inv * X * Y % P) % P * T % P
    rotate = jfield.is_negative(T * z_inv % P)
    x = Y * jfield.SQRT_M1 % P if rotate else X
    return rotate, jfield.is_negative(x * z_inv % P)


def test_ristretto_encode(lib):
    """ENCODE of random points in projective form (Z != 1), of the
    identity, and of points in each branch (rotate, negative y), also
    with lazy coordinates (+p, below 2^256)."""
    rng = random.Random(17)
    pts, seen = [jed.Point.identity()], set()
    while len(pts) < 24 or len(seen) < 4:
        p = jri.from_uniform_bytes(rng.randbytes(64)).add(jed.BASEPOINT)
        seen.add(_branch(p))
        pts.append(p)
    for p in pts:
        for lazy in (0, P):
            out = _buf(0)
            buf = _buf(sum((c + (lazy if c + lazy < R else 0)) << (256 * k)
                           for k, c in enumerate((p.X, p.Y, p.Z, p.T))), 32)
            lib.h_ristretto_encode(out, buf)
            assert _val(out).to_bytes(32, "little") == jri.encode(p)
