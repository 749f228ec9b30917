// Lazy arithmetic mod p = 2^255 - 19 and ed25519 point formulas on the
// device.
//
// An element is uint32_t[8], little-endian limbs, any value < 2^256
// congruent mod p (lazy, as the TPU kernel's _FpLazy in
// spartan_tpu/curve/pallas_msm.py).  Products fold with 2^256 = 38
// (mod p); a borrow out of a subtraction is repaid by subtracting 38
// (stored value a - b + 2^256 = a - b + 38 mod p).  fp_canon brings a
// value to [0, p).  Points are extended twisted-Edwards coordinates
// (a = -1): add-2008-hwcd-3 (unified), its mixed form against a
// precomputed (y+x, y-x, 2d*x*y) entry with Z = 1, and dbl-2008-hwcd:
// the formulas of spartan_tpu_torch/curve/edwards.py.
//
// fp_add, fp_sub and fp_mul are carry chains (carry.cuh).  The product
// is schoolbook with two independent chains, one over the even words of
// a and one over the odd words, so the scheduler always has two
// multiply-adds ready; then one 38-fold.
#pragma once
#include <stdint.h>

#include "carry.cuh"

static __constant__ uint32_t FP_P[8] = {
    0xffffffedu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
    0xffffffffu, 0xffffffffu, 0xffffffffu, 0x7fffffffu};
static __constant__ uint32_t FP_D2[8] = {  // 2d mod p
    0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au,
    0xeef3d130u, 0x198e80f2u, 0x56dffce7u, 0x2406d9dcu};

// t = a * b, 16 words.  e sums a[2k] * b and o sums a[2k+1] * b / 2^32,
// each row one carry chain; the two are independent until t = e + o<<32.
static __device__ __forceinline__ void mul_wide8(uint32_t t[16],
                                                 const uint32_t a[8],
                                                 const uint32_t b[8]) {
  uint32_t e[16], o[16];
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    e[k] = mullo(a[k], b[0]);
    e[k + 1] = mulhi(a[k], b[0]);
    o[k] = mullo(a[k + 1], b[0]);
    o[k + 1] = mulhi(a[k + 1], b[0]);
  }
  e[8] = 0;
  o[8] = 0;
#pragma unroll
  for (int i = 1; i < 8; i++) {
    // words i..i+7 gain one row; word i+7 holds the last row's carry
    e[i] = madlo_cc(a[0], b[i], e[i]);
    e[i + 1] = madhic_cc(a[0], b[i], e[i + 1]);
#pragma unroll
    for (int k = 2; k < 8; k += 2) {
      e[i + k] = madloc_cc(a[k], b[i], e[i + k]);
      e[i + k + 1] = madhic_cc(a[k], b[i], e[i + k + 1]);
    }
    e[i + 8] = addc(0, 0);
    o[i] = madlo_cc(a[1], b[i], o[i]);
    o[i + 1] = madhic_cc(a[1], b[i], o[i + 1]);
#pragma unroll
    for (int k = 2; k < 8; k += 2) {
      o[i + k] = madloc_cc(a[k + 1], b[i], o[i + k]);
      o[i + k + 1] = madhic_cc(a[k + 1], b[i], o[i + k + 1]);
    }
    if (i < 7) o[i + 8] = addc(0, 0);  // o < 2^480: its word 15 is 0
  }
  t[0] = e[0];
  t[1] = add_cc(e[1], o[0]);
#pragma unroll
  for (int k = 2; k < 15; k++) t[k] = addc_cc(e[k], o[k - 1]);
  t[15] = addc(e[15], o[14]);  // a * b < 2^512: no carry out
}

// r += 38 * c for c < 2^11; a carry out of that leaves r < 38 * 2^11,
// so the second +38 cannot carry
static __device__ __forceinline__ void fp_fold38(uint32_t r[8], uint32_t c) {
  r[0] = madlo_cc(c, 38u, r[0]);
#pragma unroll
  for (int j = 1; j < 8; j++) r[j] = addc_cc(r[j], 0);
  c = addc(0, 0);
  r[0] += c * 38u;
}

static __device__ __forceinline__ void fp_add(uint32_t r[8],
                                              const uint32_t a[8],
                                              const uint32_t b[8]) {
  r[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < 8; j++) r[j] = addc_cc(a[j], b[j]);
  fp_fold38(r, addc(0, 0));
}

static __device__ __forceinline__ void fp_sub(uint32_t r[8],
                                              const uint32_t a[8],
                                              const uint32_t b[8]) {
  r[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < 8; j++) r[j] = subc_cc(a[j], b[j]);
  // a borrow wrapped the value by 2^256 (= +38 mod p): take 38 back off
  uint32_t m = subc(0, 0) & 38u;
  r[0] = sub_cc(r[0], m);
#pragma unroll
  for (int j = 1; j < 8; j++) r[j] = subc_cc(r[j], 0);
  // wrapped again (the value was < 38): now >= 2^256 - 38, no borrow
  r[0] -= subc(0, 0) & 38u;
}

static __device__ __forceinline__ void fp_mul(uint32_t r[8],
                                              const uint32_t a[8],
                                              const uint32_t b[8]) {
  uint32_t t[16];
  mul_wide8(t, a, b);
  // r = t_lo + 38 * t_hi: the low halves, then the high halves one word up
  r[0] = madlo_cc(t[8], 38u, t[0]);
#pragma unroll
  for (int j = 1; j < 8; j++) r[j] = madloc_cc(t[8 + j], 38u, t[j]);
  uint32_t c = addc(0, 0);
  r[1] = madhi_cc(t[8], 38u, r[1]);
#pragma unroll
  for (int j = 2; j < 8; j++) r[j] = madhic_cc(t[7 + j], 38u, r[j]);
  c = madhic(t[15], 38u, c);  // c <= 39
  fp_fold38(r, c);
}


// [0, 2^256) -> [0, p): 2^256 = 2p + 38, so at most two subtractions
static __device__ __forceinline__ void fp_canon(uint32_t r[8]) {
#pragma unroll
  for (int k = 0; k < 2; k++) {
    uint32_t d[8];
    uint64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint64_t s = (uint64_t)r[j] - FP_P[j] - borrow;
      d[j] = (uint32_t)s;
      borrow = s >> 63;
    }
#pragma unroll
    for (int j = 0; j < 8; j++) r[j] = borrow ? r[j] : d[j];
  }
}

struct ge_t {
  uint32_t x[8], y[8], z[8], t[8];
};

static __device__ __forceinline__ void ge_identity(ge_t& p) {
#pragma unroll
  for (int j = 0; j < 8; j++) {
    p.x[j] = 0; p.y[j] = j == 0; p.z[j] = j == 0; p.t[j] = 0;
  }
}

// add-2008-hwcd-3, unified: r = p + q (r may alias p)
static __device__ __forceinline__ void ge_add(ge_t& r, const ge_t& p,
                                              const ge_t& q) {
  uint32_t a[8], b[8], c[8], d[8], e[8], f[8], g[8], h[8], u[8], v[8];
  fp_sub(u, p.y, p.x);
  fp_sub(v, q.y, q.x);
  fp_mul(a, u, v);
  fp_add(u, p.y, p.x);
  fp_add(v, q.y, q.x);
  fp_mul(b, u, v);
  fp_mul(u, p.t, FP_D2);
  fp_mul(c, u, q.t);
  fp_mul(u, p.z, q.z);
  fp_add(d, u, u);
  fp_sub(e, b, a);
  fp_sub(f, d, c);
  fp_add(g, d, c);
  fp_add(h, b, a);
  fp_mul(r.x, e, f);
  fp_mul(r.y, g, h);
  fp_mul(r.z, f, g);
  fp_mul(r.t, e, h);
}

// A table entry in the precomputed form of an affine point (x, y):
// (y + x, y - x, 2d * x * y), canonical; the identity is (1, 1, 0).
struct ge_pre_t {
  uint32_t yplusx[8], yminusx[8], t2d[8];
};

// The mixed add: add-2008-hwcd-3 with Z2 = 1 and 2d*T2 precomputed,
// 7 products (r may alias p).  Complete, like the unified add.
static __device__ __forceinline__ void ge_madd(ge_t& r, const ge_t& p,
                                               const ge_pre_t& q) {
  uint32_t a[8], b[8], c[8], d[8], e[8], f[8], g[8], h[8], u[8];
  fp_sub(u, p.y, p.x);
  fp_mul(a, u, q.yminusx);
  fp_add(u, p.y, p.x);
  fp_mul(b, u, q.yplusx);
  fp_mul(c, p.t, q.t2d);
  fp_add(d, p.z, p.z);
  fp_sub(e, b, a);
  fp_sub(f, d, c);
  fp_add(g, d, c);
  fp_add(h, b, a);
  fp_mul(r.x, e, f);
  fp_mul(r.y, g, h);
  fp_mul(r.z, f, g);
  fp_mul(r.t, e, h);
}

// dbl-2008-hwcd with a = -1: r = 2p (r may alias p)
static __device__ __forceinline__ void ge_dbl(ge_t& r, const ge_t& p) {
  uint32_t a[8], b[8], c[8], d[8], e[8], f[8], g[8], h[8], u[8];
  const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  fp_mul(a, p.x, p.x);
  fp_mul(b, p.y, p.y);
  fp_mul(u, p.z, p.z);
  fp_add(c, u, u);
  fp_sub(d, zero, a);
  fp_add(u, p.x, p.y);
  fp_mul(e, u, u);
  fp_sub(e, e, a);
  fp_sub(e, e, b);
  fp_add(g, d, b);
  fp_sub(f, g, c);
  fp_sub(h, d, b);
  fp_mul(r.x, e, f);
  fp_mul(r.y, g, h);
  fp_mul(r.z, f, g);
  fp_mul(r.t, e, h);
}

static __device__ __forceinline__ void ge_load(ge_t& p, const uint32_t* src) {
  const uint4* v = reinterpret_cast<const uint4*>(src);
  uint32_t* dst[4] = {p.x, p.y, p.z, p.t};
#pragma unroll
  for (int k = 0; k < 4; k++) {
    uint4 lo = v[2 * k], hi = v[2 * k + 1];
    dst[k][0] = lo.x; dst[k][1] = lo.y; dst[k][2] = lo.z; dst[k][3] = lo.w;
    dst[k][4] = hi.x; dst[k][5] = hi.y; dst[k][6] = hi.z; dst[k][7] = hi.w;
  }
}

static __device__ __forceinline__ void ge_pre_load(ge_pre_t& p,
                                                   const uint32_t* src) {
  const uint4* v = reinterpret_cast<const uint4*>(src);
  uint32_t* dst[3] = {p.yplusx, p.yminusx, p.t2d};
#pragma unroll
  for (int k = 0; k < 3; k++) {
    uint4 lo = v[2 * k], hi = v[2 * k + 1];
    dst[k][0] = lo.x; dst[k][1] = lo.y; dst[k][2] = lo.z; dst[k][3] = lo.w;
    dst[k][4] = hi.x; dst[k][5] = hi.y; dst[k][6] = hi.z; dst[k][7] = hi.w;
  }
}

static __device__ __forceinline__ void ge_store(uint32_t* dst_p,
                                                const ge_t& p) {
  uint4* v = reinterpret_cast<uint4*>(dst_p);
  const uint32_t* src[4] = {p.x, p.y, p.z, p.t};
#pragma unroll
  for (int k = 0; k < 4; k++) {
    v[2 * k] = make_uint4(src[k][0], src[k][1], src[k][2], src[k][3]);
    v[2 * k + 1] = make_uint4(src[k][4], src[k][5], src[k][6], src[k][7]);
  }
}
