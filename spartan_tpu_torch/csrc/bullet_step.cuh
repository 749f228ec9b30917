// Scalar helpers of kernel K6 (bullet_step.cu) on fq.cuh: the canonical
// value of a Montgomery residue, the Montgomery form of a 64-byte
// challenge, and the inverse by Fermat.
#pragma once
#include <stdint.h>

#include "fq.cuh"

static __constant__ uint32_t FQ_R3[8] = {  // R^3 mod q
    0x7b83a2dbu, 0x2a9e4968u, 0xaef7f3ecu, 0x278324e6u,
    0x04ec5b65u, 0x8065dc6cu, 0x3599cec7u, 0x0e530b77u};
static __constant__ uint32_t FQ_QM2[8] = {  // q - 2, the inverse's exponent
    0x5cf5d3ebu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu,
    0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u};

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

// r = x^(q-2) = x^-1, Montgomery in and out (0 for x = 0): binary
// square-and-multiply from the exponent's top bit (252), ~317 products.
// The exponent is a public constant, so its bits may steer the loop.
static __device__ __forceinline__ void fq_inv(uint32_t r[8],
                                              const uint32_t x[8]) {
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = x[j];
#pragma unroll 1
  for (int bit = 251; bit >= 0; bit--) {
    fq_mul(r, r, r);
    if ((FQ_QM2[bit >> 5] >> (bit & 31)) & 1u) fq_mul(r, r, x);
  }
}
