// Scalar helpers of kernel K6 (bullet_step.cu) on fq.cuh: the canonical
// value of a Montgomery residue, the Montgomery form of a 64-byte
// challenge, and the inverse by Bernstein-Yang safegcd.
#pragma once
#include <stdint.h>

#include "fq.cuh"

static __constant__ uint32_t FQ_R3[8] = {  // R^3 mod q
    0x7b83a2dbu, 0x2a9e4968u, 0xaef7f3ecu, 0x278324e6u,
    0x04ec5b65u, 0x8065dc6cu, 0x3599cec7u, 0x0e530b77u};

// r = a R^-1: the canonical value of the residue a
static __device__ __forceinline__ void fq_from_mont(uint32_t r[8],
                                                    const uint32_t a[8]) {
  const uint32_t one[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  fq_mul(r, a, one);
}

// r = the Montgomery form of int(b) mod q for 64 little-endian bytes b
// (from_bytes_wide, transcript.rs:26-30): with b = lo + 2^256 hi,
// mont(R^2, lo) + mont(R^3, hi) = b R mod q
static __device__ __forceinline__ void fq_from_bytes_wide(uint32_t r[8],
                                                          const uint8_t* b) {
  uint32_t lo[8], hi[8], r2[8], r3[8], x[8], y[8];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    lo[j] = (uint32_t)b[4 * j] | ((uint32_t)b[4 * j + 1] << 8) |
            ((uint32_t)b[4 * j + 2] << 16) | ((uint32_t)b[4 * j + 3] << 24);
    hi[j] = (uint32_t)b[32 + 4 * j] | ((uint32_t)b[33 + 4 * j] << 8) |
            ((uint32_t)b[34 + 4 * j] << 16) | ((uint32_t)b[35 + 4 * j] << 24);
    r2[j] = FQ_R2[j];
    r3[j] = FQ_R3[j];
  }
  fq_mul(x, r2, lo);  // the first operand < q, the second any < 2^256
  fq_mul(y, r3, hi);
  fq_add(r, x, y);
}

// The inverse mod q by Bernstein-Yang safegcd ("Fast constant-time gcd
// computation and modular inversion", 2019), laid out as libsecp256k1's
// secp256k1_modinv64: values in five signed 62-bit limbs (v[0..3] in
// [0, 2^62), v[4] signed), 59 divsteps at a time on the low 64 bits of f
// and g, kept as a 2x2 transition matrix scaled by 2^62, which is then
// applied to (f, g) and to (d, e) (the latter made divisible by 2^62 by
// adding a multiple of q).  A fixed 10 batches (590 divsteps, enough for
// any input below 2^256) and masks in place of branches: the same work
// for every input, though u is a public challenge.  The chain is 590
// short divsteps and 10 matrix updates of 64x64-bit products.
struct s62_t {
  int64_t v[5];
};
struct trans2x2_t {
  int64_t u, v, q, r;
};

#define S62_M62 (UINT64_MAX >> 2)
static __constant__ int64_t FQ_S62[5] = {  // q in signed 62-bit limbs
    0x1812631a5cf5d3edll, 0x137be77a8bde7359ll, 1, 0, 16};
#define FQ_INV62 0x2d4ae25cedab81e5ull  // q^-1 mod 2^62

static __device__ __forceinline__ int64_t mulhi_s64(int64_t a, int64_t b) {
#if defined(__CUDA_ARCH__)
  return __mul64hi(a, b);
#else
  return (int64_t)(((__int128)a * b) >> 64);
#endif
}

// a signed 128-bit accumulator (lo, hi)
struct i128_t {
  uint64_t lo;
  int64_t hi;
};

static __device__ __forceinline__ void i128_mul(i128_t& c, int64_t a,
                                                int64_t b) {
  c.lo = (uint64_t)a * (uint64_t)b;
  c.hi = mulhi_s64(a, b);
}

static __device__ __forceinline__ void i128_accum_mul(i128_t& c, int64_t a,
                                                      int64_t b) {
  uint64_t lo = (uint64_t)a * (uint64_t)b;
  int64_t hi = mulhi_s64(a, b);
  c.lo += lo;
  c.hi += hi + (int64_t)(c.lo < lo);
}

// c >>= 62, arithmetic
static __device__ __forceinline__ void i128_rshift62(i128_t& c) {
  c.lo = (c.lo >> 62) | ((uint64_t)c.hi << 2);
  c.hi >>= 62;
}

// 59 divsteps on the low bits f0, g0 of f and g (f odd): the transition
// matrix t, scaled by 2^62, and the new zeta = -(delta + 1/2)
static __device__ __forceinline__ int64_t divsteps_59(int64_t zeta,
                                                      uint64_t f0,
                                                      uint64_t g0,
                                                      trans2x2_t& t) {
  uint64_t u = 8, v = 0, q = 0, r = 8;
  uint64_t f = f0, g = g0;
#pragma unroll 1
  for (int i = 3; i < 62; i++) {
    uint64_t c1 = (uint64_t)(zeta >> 63);  // zeta < 0
    uint64_t c2 = 0 - (g & 1);              // g odd
    uint64_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    c1 &= c2;
    zeta = (int64_t)(((uint64_t)zeta ^ c1) - 1);
    f += g & c1;
    u += q & c1;
    v += r & c1;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t.u = (int64_t)u;
  t.v = (int64_t)v;
  t.q = (int64_t)q;
  t.r = (int64_t)r;
  return zeta;
}

// The same divsteps on 32-bit words, 30 at a time, as libsecp256k1's
// secp256k1_modinv32_divsteps_30: the transition matrix scaled by 2^30.
// fq_modinv does not use it; bullet_step.cu's divstep_chain_kernel times
// a chain of it, the shortest dependent chain of a divstep on this card's
// 32-bit ALUs, for the fold's bound.
struct trans2x2_32_t {
  int32_t u, v, q, r;
};

static __device__ __forceinline__ int32_t divsteps_30(int32_t zeta,
                                                      uint32_t f0,
                                                      uint32_t g0,
                                                      trans2x2_32_t& t) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
  uint32_t f = f0, g = g0;
#pragma unroll
  for (int i = 0; i < 30; i++) {
    uint32_t c1 = (uint32_t)(zeta >> 31);  // zeta < 0
    uint32_t c2 = 0 - (g & 1);              // g odd
    uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    c1 &= c2;
    zeta = (int32_t)(((uint32_t)zeta ^ c1) - 1);
    f += g & c1;
    u += q & c1;
    v += r & c1;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t.u = (int32_t)u;
  t.v = (int32_t)v;
  t.q = (int32_t)q;
  t.r = (int32_t)r;
  return zeta;
}

// (d, e) = t (d, e) / 2^62 mod q, with d, e in (-2q, q)
static __device__ __forceinline__ void update_de_62(s62_t& d, s62_t& e,
                                                    const trans2x2_t& t) {
  const int64_t u = t.u, v = t.v, q = t.q, r = t.r;
  int64_t sd = d.v[4] >> 63, se = e.v[4] >> 63;
  int64_t md = (u & sd) + (v & se), me = (q & sd) + (r & se);
  i128_t cd, ce;
  i128_mul(cd, u, d.v[0]);
  i128_accum_mul(cd, v, e.v[0]);
  i128_mul(ce, q, d.v[0]);
  i128_accum_mul(ce, r, e.v[0]);
  // make the low 62 bits of t (d, e) + q (md, me) zero
  md -= (int64_t)((FQ_INV62 * cd.lo + (uint64_t)md) & S62_M62);
  me -= (int64_t)((FQ_INV62 * ce.lo + (uint64_t)me) & S62_M62);
  i128_accum_mul(cd, FQ_S62[0], md);
  i128_accum_mul(ce, FQ_S62[0], me);
  i128_rshift62(cd);
  i128_rshift62(ce);
#pragma unroll
  for (int k = 1; k < 5; k++) {
    i128_accum_mul(cd, u, d.v[k]);
    i128_accum_mul(cd, v, e.v[k]);
    i128_accum_mul(ce, q, d.v[k]);
    i128_accum_mul(ce, r, e.v[k]);
    i128_accum_mul(cd, FQ_S62[k], md);
    i128_accum_mul(ce, FQ_S62[k], me);
    d.v[k - 1] = (int64_t)(cd.lo & S62_M62);
    e.v[k - 1] = (int64_t)(ce.lo & S62_M62);
    i128_rshift62(cd);
    i128_rshift62(ce);
  }
  d.v[4] = (int64_t)cd.lo;
  e.v[4] = (int64_t)ce.lo;
}

// (f, g) = t (f, g) / 2^62 (exact)
static __device__ __forceinline__ void update_fg_62(s62_t& f, s62_t& g,
                                                    const trans2x2_t& t) {
  const int64_t u = t.u, v = t.v, q = t.q, r = t.r;
  i128_t cf, cg;
  i128_mul(cf, u, f.v[0]);
  i128_accum_mul(cf, v, g.v[0]);
  i128_mul(cg, q, f.v[0]);
  i128_accum_mul(cg, r, g.v[0]);
  i128_rshift62(cf);
  i128_rshift62(cg);
#pragma unroll
  for (int k = 1; k < 5; k++) {
    i128_accum_mul(cf, u, f.v[k]);
    i128_accum_mul(cf, v, g.v[k]);
    i128_accum_mul(cg, q, f.v[k]);
    i128_accum_mul(cg, r, g.v[k]);
    f.v[k - 1] = (int64_t)(cf.lo & S62_M62);
    g.v[k - 1] = (int64_t)(cg.lo & S62_M62);
    i128_rshift62(cf);
    i128_rshift62(cg);
  }
  f.v[4] = (int64_t)cf.lo;
  g.v[4] = (int64_t)cg.lo;
}

// r in (-2q, q) -> [0, q), negated first when sign < 0
static __device__ __forceinline__ void normalize_62(s62_t& r, int64_t sign) {
#pragma unroll
  for (int pass = 0; pass < 2; pass++) {
    int64_t add = r.v[4] >> 63;
#pragma unroll
    for (int k = 0; k < 5; k++) r.v[k] += FQ_S62[k] & add;
    if (pass == 0) {
      int64_t neg = sign >> 63;
#pragma unroll
      for (int k = 0; k < 5; k++) r.v[k] = (r.v[k] ^ neg) - neg;
    }
#pragma unroll
    for (int k = 0; k < 4; k++) {
      r.v[k + 1] += r.v[k] >> 62;
      r.v[k] &= (int64_t)S62_M62;
    }
  }
}

// r = x^-1 mod q for a canonical x (0 for x = 0), canonical
static __device__ __forceinline__ void fq_modinv(uint32_t r[8],
                                                 const uint32_t x[8]) {
  uint64_t w[4];
#pragma unroll
  for (int k = 0; k < 4; k++)
    w[k] = (uint64_t)x[2 * k] | ((uint64_t)x[2 * k + 1] << 32);
  s62_t d = {{0, 0, 0, 0, 0}}, e = {{1, 0, 0, 0, 0}}, f, g;
#pragma unroll
  for (int k = 0; k < 5; k++) f.v[k] = FQ_S62[k];
  g.v[0] = (int64_t)(w[0] & S62_M62);
  g.v[1] = (int64_t)(((w[0] >> 62) | (w[1] << 2)) & S62_M62);
  g.v[2] = (int64_t)(((w[1] >> 60) | (w[2] << 4)) & S62_M62);
  g.v[3] = (int64_t)(((w[2] >> 58) | (w[3] << 6)) & S62_M62);
  g.v[4] = (int64_t)(w[3] >> 56);
  int64_t zeta = -1;  // -(delta + 1/2), delta = 1/2
#pragma unroll 1
  for (int i = 0; i < 10; i++) {
    trans2x2_t t;
    zeta = divsteps_59(zeta, (uint64_t)f.v[0], (uint64_t)g.v[0], t);
    update_de_62(d, e, t);
    update_fg_62(f, g, t);
  }
  // g = 0 now and f = +-1: d is +-x^-1
  normalize_62(d, f.v[4]);
  w[0] = (uint64_t)d.v[0] | ((uint64_t)d.v[1] << 62);
  w[1] = ((uint64_t)d.v[1] >> 2) | ((uint64_t)d.v[2] << 60);
  w[2] = ((uint64_t)d.v[2] >> 4) | ((uint64_t)d.v[3] << 58);
  w[3] = ((uint64_t)d.v[3] >> 6) | ((uint64_t)d.v[4] << 56);
#pragma unroll
  for (int k = 0; k < 4; k++) {
    r[2 * k] = (uint32_t)w[k];
    r[2 * k + 1] = (uint32_t)(w[k] >> 32);
  }
}

// r = x^-1, Montgomery in and out (0 for x = 0): safegcd on the residue
// x = uR gives u^-1 R^-1, and one Montgomery product by R^3 makes it
// u^-1 R
static __device__ __forceinline__ void fq_inv(uint32_t r[8],
                                              const uint32_t x[8]) {
  uint32_t y[8], r3[8];
  fq_modinv(y, x);
#pragma unroll
  for (int j = 0; j < 8; j++) r3[j] = FQ_R3[j];
  fq_mul(r, r3, y);
}
