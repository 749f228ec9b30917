// keccak-f[1600], the permutation of the STROBE-128 sponge under the
// merlin transcript, with one 64-bit Keccak lane a warp lane: lane t < 25
// holds A[t], t = x + 5y.  A round is
//   theta: the column parity C[x] from the four other lanes of the column
//          (shuffles), then D[x] = C[x - 1] ^ rol(C[x + 1], 1) from the
//          neighbouring columns' lanes of the same row (shuffles);
//   rho, pi and chi: A = B ^ (~B[x + 1] & B[x + 2]), where B of a lane
//          is its pi source's word rotated by its own amount (per-lane
//          tables): three shuffles of the theta output at once, from the
//          sources of the lane and of its two chi neighbours, each then
//          rotated by that lane's amount;
//   iota:  lane 0 takes the round constant.
// So a round is three rounds of shuffles, each a few ALU steps apart.
// Lanes 25-31 mirror lanes 0-6 so that every lane of the warp takes part
// in the full-mask shuffles; nobody reads them.
//
// The same source runs on the host (no __CUDA_ARCH__: nvcc's host pass,
// and g++ in tests/test_torch_csrc.py), where a klane holds the warp's 32
// lanes and a shuffle is an index into them (every lane read before any
// is written), so the rounds are checked against
// spartan_tpu_torch/core/keccak.py without a card.
#pragma once
#include <stdint.h>

#if defined(__CUDA_ARCH__)
#define KN 1  // this lane's value
#else
#define KN 32  // the warp's lanes, lane t at v[t]
#endif

static __constant__ uint64_t KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};
// rho and pi together: lane t takes lane KECCAK_PI_SRC[t] of the theta
// output rotated left by KECCAK_ROTN[t] (B[y + 5((2x + 3y) mod 5)] =
// rol(A[x + 5y], r[x][y]))
static __constant__ uint8_t KECCAK_PI_SRC[25] = {
    0, 6, 12, 18, 24, 3, 9, 10, 16, 22, 1, 7, 13, 19, 20,
    4, 5, 11, 17, 23, 2, 8, 14, 15, 21};
static __constant__ uint8_t KECCAK_ROTN[25] = {
    0, 44, 43, 21, 14, 28, 20, 3, 45, 61, 1, 6, 25, 8, 18,
    27, 36, 10, 15, 56, 62, 55, 39, 41, 2};

// a 64-bit value in each lane of the warp
struct klane {
  uint64_t v[KN];
};

// a lane index (or any per-lane 32-bit value) in each lane
struct kidx {
  uint32_t v[KN];
};

// the warp lane that element j of a klane belongs to
static __device__ __forceinline__ uint32_t k_lane(int j) {
#if defined(__CUDA_ARCH__)
  return threadIdx.x & 31;
#else
  return (uint32_t)j;
#endif
}

// r = x of lane src in each lane (r may alias x)
static __device__ __forceinline__ void k_shfl(klane& r, const klane& x,
                                              const kidx& src) {
#if defined(__CUDA_ARCH__)
  r.v[0] = __shfl_sync(0xffffffffu, x.v[0], src.v[0]);
#else
  klane t = x;
  for (int j = 0; j < KN; j++) r.v[j] = t.v[src.v[j]];
#endif
}

// v rotated left by n < 64: on the device a swap of the halves for n >= 32
// and two funnel shifts
static __device__ __forceinline__ uint64_t k_rol(uint64_t v, uint32_t n) {
#if defined(__CUDA_ARCH__)
  uint32_t lo = (uint32_t)v, hi = (uint32_t)(v >> 32);
  if (n & 32) {
    uint32_t s = lo;
    lo = hi;
    hi = s;
  }
  return ((uint64_t)__funnelshift_l(lo, hi, n) << 32) |
         __funnelshift_l(hi, lo, n);
#else
  return (v << n) | (v >> ((64 - n) & 63));
#endif
}

// each lane's sources: the other four lanes of its column, the two
// neighbouring columns, and the rho-pi sources of itself and of its two
// chi neighbours with their rotations
struct kplan {
  kidx col[4], xm1, xp1, pi[3], rot[3];
};

static __device__ __forceinline__ void k_plan(kplan& pl) {
#pragma unroll
  for (int j = 0; j < KN; j++) {
    uint32_t t = k_lane(j), l = t < 25 ? t : t - 25;
    uint32_t x = l % 5, y = l / 5;
#pragma unroll
    for (int m = 0; m < 4; m++) pl.col[m].v[j] = x + 5 * ((y + 1 + m) % 5);
    pl.xm1.v[j] = (x + 4) % 5 + 5 * y;
    pl.xp1.v[j] = (x + 1) % 5 + 5 * y;
#pragma unroll
    for (int m = 0; m < 3; m++) {
      uint32_t b = (x + m) % 5 + 5 * y;  // B of this lane, x + 1, x + 2
      pl.pi[m].v[j] = KECCAK_PI_SRC[b];
      pl.rot[m].v[j] = KECCAK_ROTN[b];
    }
  }
}

// the 24 rounds on the warp's lanes, in place
static __device__ __forceinline__ void keccak_f1600_lanes(klane& a) {
  kplan pl;
  k_plan(pl);
#pragma unroll 1
  for (int r = 0; r < 24; r++) {
    klane c, t0, t1, t2, t3;
    k_shfl(t0, a, pl.col[0]);
    k_shfl(t1, a, pl.col[1]);
    k_shfl(t2, a, pl.col[2]);
    k_shfl(t3, a, pl.col[3]);
#pragma unroll
    for (int j = 0; j < KN; j++)
      c.v[j] = a.v[j] ^ t0.v[j] ^ t1.v[j] ^ t2.v[j] ^ t3.v[j];
    k_shfl(t0, c, pl.xm1);
    k_shfl(t1, c, pl.xp1);
#pragma unroll
    for (int j = 0; j < KN; j++) a.v[j] ^= t0.v[j] ^ k_rol(t1.v[j], 1);
    k_shfl(t0, a, pl.pi[0]);
    k_shfl(t1, a, pl.pi[1]);
    k_shfl(t2, a, pl.pi[2]);
#pragma unroll
    for (int j = 0; j < KN; j++) {
      t0.v[j] = k_rol(t0.v[j], pl.rot[0].v[j]);
      t1.v[j] = k_rol(t1.v[j], pl.rot[1].v[j]);
      t2.v[j] = k_rol(t2.v[j], pl.rot[2].v[j]);
    }
    uint64_t rc = KECCAK_RC[r];
#pragma unroll
    for (int j = 0; j < KN; j++)
      a.v[j] = (t0.v[j] ^ (~t1.v[j] & t2.v[j])) ^ (k_lane(j) == 0 ? rc : 0);
  }
}
