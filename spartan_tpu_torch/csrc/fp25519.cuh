// Lazy arithmetic mod p = 2^255 - 19 and ed25519 point formulas on the
// device.
//
// An element is uint32_t[8], little-endian limbs, any value < 2^256
// congruent mod p (lazy, as the TPU kernel's _FpLazy in
// spartan_tpu/curve/pallas_msm.py).  Products fold with 2^256 = 38
// (mod p); a borrow out of a subtraction is repaid by subtracting 38
// (stored value a - b + 2^256 = a - b + 38 mod p).  fp_canon brings a
// value to [0, p).  Points are extended twisted-Edwards coordinates
// (a = -1): add-2008-hwcd-3 (unified) and dbl-2008-hwcd, the formulas
// of spartan_tpu_torch/curve/edwards.py.
#pragma once
#include <stdint.h>

static __constant__ uint32_t FP_P[8] = {
    0xffffffedu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
    0xffffffffu, 0xffffffffu, 0xffffffffu, 0x7fffffffu};
static __constant__ uint32_t FP_D2[8] = {  // 2d mod p
    0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au,
    0xeef3d130u, 0x198e80f2u, 0x56dffce7u, 0x2406d9dcu};

// r += 38 * c (c < 2^26), wrapping 2^256 = 38 once more if it carries out
static __device__ __forceinline__ void fp_fold(uint32_t r[8], uint64_t c) {
  uint64_t s = (uint64_t)r[0] + c * 38;
  r[0] = (uint32_t)s;
  c = s >> 32;
#pragma unroll
  for (int j = 1; j < 8; j++) {
    s = (uint64_t)r[j] + c;
    r[j] = (uint32_t)s;
    c = s >> 32;
  }
  // a carry here leaves r < 38 * 2^26: adding 38 cannot carry again
  r[0] += (uint32_t)c * 38u;
}

static __device__ __forceinline__ void fp_add(uint32_t r[8],
                                              const uint32_t a[8],
                                              const uint32_t b[8]) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    uint64_t s = (uint64_t)a[j] + b[j] + c;
    r[j] = (uint32_t)s;
    c = s >> 32;
  }
  fp_fold(r, c);
}

static __device__ __forceinline__ void fp_sub(uint32_t r[8],
                                              const uint32_t a[8],
                                              const uint32_t b[8]) {
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    uint64_t s = (uint64_t)a[j] - b[j] - borrow;
    r[j] = (uint32_t)s;
    borrow = s >> 63;
  }
  // wrapped by 2^256 (= +38 mod p): take 38 back off
  uint64_t s = (uint64_t)r[0] - 38u * borrow;
  r[0] = (uint32_t)s;
  borrow = s >> 63;
#pragma unroll
  for (int j = 1; j < 8; j++) {
    s = (uint64_t)r[j] - borrow;
    r[j] = (uint32_t)s;
    borrow = s >> 63;
  }
  // wrapped again (value was < 38): it is now >= 2^256 - 38, so one more
  // -38 cannot borrow
  r[0] -= 38u * (uint32_t)borrow;
}

static __device__ __forceinline__ void fp_mul(uint32_t r[8],
                                              const uint32_t a[8],
                                              const uint32_t b[8]) {
  uint32_t t[16];
#pragma unroll
  for (int j = 0; j < 16; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    uint64_t s = (uint64_t)t[j + 8] * 38u + t[j] + c;
    r[j] = (uint32_t)s;
    c = s >> 32;
  }
  fp_fold(r, c);  // c < 39
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
