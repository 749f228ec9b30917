// ristretto255 ENCODE (RFC 9496 section 4.3.2) of an extended point, on
// the lazy field arithmetic of fp25519.cuh.
//
// Plain C++ apart from CUDA's qualifiers, so tests/test_torch_csrc.py
// compiles it with g++ and holds it against spartan_tpu_torch/core/
// ristretto.py::encode.  The steps are those of the JAX package's
// spartan_tpu/curve/ristretto.py::compress and of the plain twin
// spartan_tpu_torch/curve/ristretto.py::compress_plain; the encoding is
// unique, so every correct route gives the same 32 bytes.
#pragma once
#include <stdint.h>

#include "fp25519.cuh"

static __constant__ uint32_t FP_SQRT_M1[8] = {
    0x4a0ea0b0u, 0xc4ee1b27u, 0xad2fe478u, 0x2f431806u,
    0x3dfbd7a7u, 0x2b4d0099u, 0x4fc1df0bu, 0x2b832480u};
static __constant__ uint32_t FP_INVSQRT_A_MINUS_D[8] = {
    0x805d40eau, 0x99c8fdaau, 0x5a4172beu, 0x9d2f1617u,
    0xfe01d840u, 0x16c27b91u, 0xcfaffca2u, 0x786c8905u};

static __device__ __forceinline__ void fp_copy(uint32_t r[8],
                                               const uint32_t a[8]) {
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = a[j];
}

// r = a^(2^n) (r may alias a)
static __device__ __forceinline__ void fp_sqn(uint32_t r[8],
                                              const uint32_t a[8], int n) {
  fp_copy(r, a);
#pragma unroll 1
  for (int i = 0; i < n; i++) fp_mul(r, r, r);
}

// r = z^((p - 5) / 8) = z^(2^252 - 3): 251 squarings and 11 products
// (ref10's pow22523 chain)
static __device__ void fp_pow_p58(uint32_t r[8], const uint32_t z[8]) {
  uint32_t t0[8], t1[8], t2[8];
  fp_mul(t0, z, z);       // 2
  fp_sqn(t1, t0, 2);      // 8
  fp_mul(t1, z, t1);      // 9
  fp_mul(t0, t0, t1);     // 11
  fp_mul(t0, t0, t0);     // 22
  fp_mul(t0, t1, t0);     // 2^5 - 1
  fp_sqn(t1, t0, 5);
  fp_mul(t0, t1, t0);     // 2^10 - 1
  fp_sqn(t1, t0, 10);
  fp_mul(t1, t1, t0);     // 2^20 - 1
  fp_sqn(t2, t1, 20);
  fp_mul(t1, t2, t1);     // 2^40 - 1
  fp_sqn(t1, t1, 10);
  fp_mul(t0, t1, t0);     // 2^50 - 1
  fp_sqn(t1, t0, 50);
  fp_mul(t1, t1, t0);     // 2^100 - 1
  fp_sqn(t2, t1, 100);
  fp_mul(t1, t2, t1);     // 2^200 - 1
  fp_sqn(t1, t1, 50);
  fp_mul(t0, t1, t0);     // 2^250 - 1
  fp_sqn(t0, t0, 2);      // 2^252 - 4
  fp_mul(r, t0, z);       // 2^252 - 3
}

static __device__ __forceinline__ bool fp_eq(const uint32_t a[8],
                                             const uint32_t b[8]) {
  uint32_t x[8], y[8];
  fp_copy(x, a);
  fp_copy(y, b);
  fp_canon(x);
  fp_canon(y);
  uint32_t d = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) d |= x[j] ^ y[j];
  return d == 0;
}

static __device__ __forceinline__ bool fp_is_negative(const uint32_t a[8]) {
  uint32_t x[8];
  fp_copy(x, a);
  fp_canon(x);
  return x[0] & 1;
}

static __device__ __forceinline__ void fp_neg(uint32_t r[8],
                                              const uint32_t a[8]) {
  const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  fp_sub(r, zero, a);
}

static __device__ __forceinline__ void fp_select(uint32_t r[8], bool c,
                                                 const uint32_t a[8],
                                                 const uint32_t b[8]) {
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = c ? a[j] : b[j];
}

// r = |a|, canonical: the non-negative (even) one of a and -a
static __device__ __forceinline__ void fp_abs(uint32_t r[8],
                                              const uint32_t a[8]) {
  uint32_t n[8];
  fp_copy(r, a);
  fp_canon(r);
  fp_neg(n, r);
  fp_canon(n);
  fp_select(r, r[0] & 1, n, r);
}

// s = ENCODE(p), canonical
static __device__ void ristretto_encode(uint32_t s[8], const ge_t& p) {
  uint32_t u1[8], u2[8], a[8], b[8], v[8];
  fp_add(a, p.z, p.y);
  fp_sub(b, p.z, p.y);
  fp_mul(u1, a, b);
  fp_mul(u2, p.x, p.y);
  fp_mul(a, u2, u2);
  fp_mul(v, u1, a);
  // invsqrt = SQRT_RATIO_M1(1, v)
  uint32_t v3[8], v7[8], r[8], check[8], one[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  fp_mul(a, v, v);
  fp_mul(v3, a, v);
  fp_mul(a, v3, v3);
  fp_mul(v7, a, v);
  fp_pow_p58(a, v7);
  fp_mul(r, v3, a);
  fp_mul(a, r, r);
  fp_mul(check, v, a);
  uint32_t neg_one[8], neg_i[8];
  fp_neg(neg_one, one);
  fp_neg(neg_i, FP_SQRT_M1);
  bool flip = fp_eq(check, neg_one) || fp_eq(check, neg_i);
  fp_mul(a, r, FP_SQRT_M1);
  fp_select(r, flip, a, r);
  uint32_t inv[8];
  fp_abs(inv, r);
  // den1, den2, z_inv = den1 den2 T; rotate when T z_inv is negative
  uint32_t den1[8], den2[8], zinv[8];
  fp_mul(den1, inv, u1);
  fp_mul(den2, inv, u2);
  fp_mul(a, den1, den2);
  fp_mul(zinv, a, p.t);
  fp_mul(a, p.t, zinv);
  bool rotate = fp_is_negative(a);
  uint32_t x[8], y[8], den_inv[8];
  fp_mul(a, p.y, FP_SQRT_M1);  // iy0
  fp_mul(b, p.x, FP_SQRT_M1);  // ix0
  fp_select(x, rotate, a, p.x);
  fp_select(y, rotate, b, p.y);
  fp_mul(a, den1, FP_INVSQRT_A_MINUS_D);  // enchanted
  fp_select(den_inv, rotate, a, den2);
  fp_mul(a, x, zinv);
  fp_neg(b, y);
  fp_select(y, fp_is_negative(a), b, y);
  fp_sub(a, p.z, y);
  fp_mul(b, den_inv, a);
  fp_abs(s, b);
}
