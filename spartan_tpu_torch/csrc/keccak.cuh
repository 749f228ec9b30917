// keccak-f[1600] on 25 64-bit lanes (lane x + 5y), the permutation of
// the STROBE-128 sponge under the merlin transcript.
//
// Plain C++ apart from CUDA's qualifiers, so tests/test_torch_csrc.py
// compiles it with g++ and holds it against spartan_tpu_torch/core/
// keccak.py.  The rounds loop stays rolled; inside a round every index
// is a constant, so the 25 lanes live in registers.
#pragma once
#include <stdint.h>

static __constant__ uint64_t KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

static __device__ __forceinline__ uint64_t rol64(uint64_t v, int n) {
  return n ? (v << n) | (v >> (64 - n)) : v;
}

// one round: theta, rho and pi, chi, iota
static __device__ __forceinline__ void keccak_round(uint64_t a[25],
                                                    uint64_t rc) {
  uint64_t c[5], b[25];
#pragma unroll
  for (int x = 0; x < 5; x++)
    c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
  for (int x = 0; x < 5; x++) {
    uint64_t d = c[(x + 4) % 5] ^ rol64(c[(x + 1) % 5], 1);
#pragma unroll
    for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d;
  }
  // b[y + 5 ((2x + 3y) mod 5)] = rol(a[x + 5y], r[x][y])
  b[0] = rol64(a[0], 0);
  b[16] = rol64(a[5], 36);
  b[7] = rol64(a[10], 3);
  b[23] = rol64(a[15], 41);
  b[14] = rol64(a[20], 18);
  b[10] = rol64(a[1], 1);
  b[1] = rol64(a[6], 44);
  b[17] = rol64(a[11], 10);
  b[8] = rol64(a[16], 45);
  b[24] = rol64(a[21], 2);
  b[20] = rol64(a[2], 62);
  b[11] = rol64(a[7], 6);
  b[2] = rol64(a[12], 43);
  b[18] = rol64(a[17], 15);
  b[9] = rol64(a[22], 61);
  b[5] = rol64(a[3], 28);
  b[21] = rol64(a[8], 55);
  b[12] = rol64(a[13], 25);
  b[3] = rol64(a[18], 21);
  b[19] = rol64(a[23], 56);
  b[15] = rol64(a[4], 27);
  b[6] = rol64(a[9], 20);
  b[22] = rol64(a[14], 39);
  b[13] = rol64(a[19], 8);
  b[4] = rol64(a[24], 14);
#pragma unroll
  for (int y = 0; y < 5; y++)
#pragma unroll
    for (int x = 0; x < 5; x++)
      a[x + 5 * y] = b[x + 5 * y] ^
                     (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
  a[0] ^= rc;
}

static __device__ __forceinline__ void keccak_f1600(uint64_t a[25]) {
#pragma unroll 1
  for (int i = 0; i < 24; i++) keccak_round(a, KECCAK_RC[i]);
}
