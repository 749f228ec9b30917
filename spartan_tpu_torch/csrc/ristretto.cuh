// ristretto255 ENCODE (RFC 9496 section 4.3.2) of an extended point, by
// the 8 lanes of a group (fp25519_group.cuh).
//
// Every lane of the group holds the point and every intermediate value
// whole: the products (g_mul) are spread over the group, the additions,
// selects and comparisons (fp25519.cuh) are cheap and run in every lane
// alike.  ENCODE's inverse square root is z^((p - 5) / 8), ref10's
// pow22523 chain: 251 squarings and 11 products, 22 more products around
// it, each a dependent g_mul.  Values are passed by value (fe), and the
// product and the run of squarings are called functions, not inlined: one
// copy of their code serves all 284 products, so the instruction cache
// stays warm (inlined, the encode's straight-line products ran from a cold
// one).  Only public points are encoded (each goes into the transcript and
// the proof), so nothing here needs to be constant time; the selects are
// branch-free all the same.
//
// Plain C++ apart from CUDA's qualifiers, so tests/test_torch_csrc.py
// compiles it with g++ (the group's 8 lanes in a loop) and holds it
// against spartan_tpu_torch/core/ristretto.py::encode.  The steps are
// those of the JAX package's spartan_tpu/curve/ristretto.py::compress and
// of the plain twin spartan_tpu_torch/curve/ristretto.py::compress_plain;
// the encoding is unique, so every correct route gives the same 32 bytes.
#pragma once
#include <stdint.h>

#include "fp25519.cuh"
#include "fp25519_group.cuh"

static __constant__ uint32_t FP_SQRT_M1[8] = {
    0x4a0ea0b0u, 0xc4ee1b27u, 0xad2fe478u, 0x2f431806u,
    0x3dfbd7a7u, 0x2b4d0099u, 0x4fc1df0bu, 0x2b832480u};
static __constant__ uint32_t FP_INVSQRT_A_MINUS_D[8] = {
    0x805d40eau, 0x99c8fdaau, 0x5a4172beu, 0x9d2f1617u,
    0xfe01d840u, 0x16c27b91u, 0xcfaffca2u, 0x786c8905u};

// a field element by value (lazy, < 2^256), whole in every lane
struct fe {
  uint32_t w[8];
};

static __device__ __forceinline__ fe fe_of(const uint32_t a[8]) {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.w[j] = a[j];
  return r;
}

static __device__ __noinline__ fe fe_mul(fe a, fe b) {
  fe r;
  g_mul(r.w, a.w, b.w);
  return r;
}

// a^(2^n)
static __device__ __noinline__ fe fe_sqn(fe a, int n) {
  fe r;
  g_sqn(r.w, a.w, n);
  return r;
}

static __device__ __forceinline__ fe fe_add(fe a, fe b) {
  fe r;
  fp_add(r.w, a.w, b.w);
  return r;
}

static __device__ __forceinline__ fe fe_sub(fe a, fe b) {
  fe r;
  fp_sub(r.w, a.w, b.w);
  return r;
}

static __device__ __forceinline__ fe fe_neg(fe a) {
  fe zero = {{0, 0, 0, 0, 0, 0, 0, 0}};
  return fe_sub(zero, a);
}

static __device__ __forceinline__ fe fe_canon(fe a) {
  fp_canon(a.w);
  return a;
}

static __device__ __forceinline__ bool fe_eq(fe a, fe b) {
  a = fe_canon(a);
  b = fe_canon(b);
  uint32_t d = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) d |= a.w[j] ^ b.w[j];
  return d == 0;
}

static __device__ __forceinline__ bool fe_is_negative(fe a) {
  return fe_canon(a).w[0] & 1;
}

// c ? a : b, word by word
static __device__ __forceinline__ fe fe_pick(bool c, fe a, fe b) {
  fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.w[j] = c ? a.w[j] : b.w[j];
  return r;
}

// |a|, canonical: the non-negative (even) one of a and -a
static __device__ __forceinline__ fe fe_abs(fe a) {
  a = fe_canon(a);
  return fe_pick(a.w[0] & 1, fe_canon(fe_neg(a)), a);
}

// z^((p - 5) / 8) = z^(2^252 - 3): 251 squarings and 11 products (ref10's
// pow22523 chain)
static __device__ __forceinline__ fe fp_pow_p58(fe z) {
  fe t0 = fe_mul(z, z);    // 2
  fe t1 = fe_sqn(t0, 2);   // 8
  t1 = fe_mul(z, t1);      // 9
  t0 = fe_mul(t0, t1);     // 11
  t0 = fe_mul(t0, t0);     // 22
  t0 = fe_mul(t1, t0);     // 2^5 - 1
  t1 = fe_sqn(t0, 5);
  t0 = fe_mul(t1, t0);     // 2^10 - 1
  t1 = fe_sqn(t0, 10);
  t1 = fe_mul(t1, t0);     // 2^20 - 1
  fe t2 = fe_sqn(t1, 20);
  t1 = fe_mul(t2, t1);     // 2^40 - 1
  t1 = fe_sqn(t1, 10);
  t0 = fe_mul(t1, t0);     // 2^50 - 1
  t1 = fe_sqn(t0, 50);
  t1 = fe_mul(t1, t0);     // 2^100 - 1
  t2 = fe_sqn(t1, 100);
  t1 = fe_mul(t2, t1);     // 2^200 - 1
  t1 = fe_sqn(t1, 50);
  t0 = fe_mul(t1, t0);     // 2^250 - 1
  t0 = fe_sqn(t0, 2);      // 2^252 - 4
  return fe_mul(t0, z);    // 2^252 - 3
}

// s = ENCODE(p), canonical
static __device__ __forceinline__ void ristretto_encode(uint32_t s[8],
                                                        const ge_t& p) {
  fe X = fe_of(p.x), Y = fe_of(p.y), Z = fe_of(p.z), T = fe_of(p.t);
  fe sqrt_m1 = fe_of(FP_SQRT_M1), one = {{1, 0, 0, 0, 0, 0, 0, 0}};
  fe u1 = fe_mul(fe_add(Z, Y), fe_sub(Z, Y));
  fe u2 = fe_mul(X, Y);
  fe v = fe_mul(u1, fe_mul(u2, u2));
  // invsqrt = SQRT_RATIO_M1(1, v)
  fe v3 = fe_mul(fe_mul(v, v), v);
  fe v7 = fe_mul(fe_mul(v3, v3), v);
  fe r = fe_mul(v3, fp_pow_p58(v7));
  fe check = fe_mul(v, fe_mul(r, r));
  bool flip = fe_eq(check, fe_neg(one)) | fe_eq(check, fe_neg(sqrt_m1));
  r = fe_pick(flip, fe_mul(r, sqrt_m1), r);
  fe inv = fe_abs(r);
  // den1, den2, z_inv = den1 den2 T; rotate when T z_inv is negative
  fe den1 = fe_mul(inv, u1), den2 = fe_mul(inv, u2);
  fe zinv = fe_mul(fe_mul(den1, den2), T);
  bool rotate = fe_is_negative(fe_mul(T, zinv));
  fe x = fe_pick(rotate, fe_mul(Y, sqrt_m1), X);  // iy0
  fe y = fe_pick(rotate, fe_mul(X, sqrt_m1), Y);  // ix0
  fe enchanted = fe_mul(den1, fe_of(FP_INVSQRT_A_MINUS_D));
  fe den_inv = fe_pick(rotate, enchanted, den2);
  y = fe_pick(fe_is_negative(fe_mul(x, zinv)), fe_neg(y), y);
  fe out = fe_abs(fe_mul(den_inv, fe_sub(Z, y)));
#pragma unroll
  for (int j = 0; j < 8; j++) s[j] = out.w[j];
}
