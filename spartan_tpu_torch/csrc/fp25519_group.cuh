// Products mod p = 2^255 - 19 spread over a group of 8 lanes, for kernel
// K4 (ristretto.cu).
//
// Every lane of a group holds both operands whole (8 words, the lazy form
// of fp25519.cuh: any value < 2^256), and lane k computes word k of the
// product: column k of the 512-bit schoolbook product plus 38 times column
// k + 8 (2^256 = 38 mod p),
//   S_k = T_k + 37 M_k,  T_k = sum_i lo(a_i b_{k-i}) + hi(a_i b_{k-1-i}),
// indices mod 8, where M_k sums the terms that land in the high half (the
// lo terms with i > k, the hi terms with i >= k), picked by per-lane masks:
// 16 half-products, their plain sums, one multiply by 37; S_k < 2^42.
// b_{k-i} is b reversed and rotated by the lane index, three stages of
// selects.  Then the group exchanges its columns: 16 shuffles (the low and
// the high word of each S_k) give every lane all of them, and every lane
// adds them up, word k + 1 taking S_k >> 32 (word 0 taking 38 times
// S_7 >> 32).  A carry out of word 7 is worth 38 more: two carry chains,
// the sum and the sum plus 38, run side by side, and the carry of the
// first picks one.  So a product's chain is a multiply and an add tree,
// one round of shuffles and an 8-step carry chain, not the 8-row carry
// chain of a one-lane product.
//
// The same source runs on the host (no __CUDA_ARCH__: nvcc's host pass,
// and g++ in tests/test_torch_csrc.py), where a glane holds the 8 lanes of
// one group and each per-lane step loops over them.  Whole values are plain
// uint32_t[8] on both sides.
//
// On the device every lane of the warp must run g_mul together (full-mask
// shuffles), so a kernel gives its spare lanes a copy of the last group's
// work.
#pragma once
#include <stdint.h>

#include "fp25519.cuh"

#define G_LANES 8

#if defined(__CUDA_ARCH__)
#define GN 1  // this lane's value
#else
#define GN G_LANES  // the group's lanes, lane k at v[k]
#endif

// one 32-bit value in each lane of a group
struct glane {
  uint32_t v[GN];
};

// the lane of the group that element j of a glane belongs to
static __device__ __forceinline__ uint32_t g_k(int j) {
#if defined(__CUDA_ARCH__)
  return threadIdx.x & (G_LANES - 1);
#else
  return (uint32_t)j;
#endif
}

// r[j] = x of lane j: the group's words, whole in every lane
static __device__ __forceinline__ void g_gather(uint32_t r[8],
                                                const glane& x) {
#if defined(__CUDA_ARCH__)
  uint32_t base = threadIdx.x & 24;
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = __shfl_sync(0xffffffffu, x.v[0], base | j);
#else
  for (int j = 0; j < 8; j++) r[j] = x.v[j];
#endif
}

// S_k, lane k's column of a * b (see the top of the file)
static __device__ __forceinline__ uint64_t g_column(const uint32_t a[8],
                                                    const uint32_t b[8],
                                                    uint32_t k) {
  // rv[i] = b[(k - i) & 7]: b reversed, then rotated by k in 3 stages
  uint32_t rv[8], tmp[8];
#pragma unroll
  for (int i = 0; i < 8; i++) rv[i] = b[(8 - i) & 7];
#pragma unroll
  for (int s = 1; s < 8; s <<= 1) {
    bool on = (k & s) != 0;
#pragma unroll
    for (int i = 0; i < 8; i++) tmp[i] = on ? rv[(i - s) & 7] : rv[i];
#pragma unroll
    for (int i = 0; i < 8; i++) rv[i] = tmp[i];
  }
  uint64_t t[2] = {0, 0}, m[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint32_t lo = mullo(a[i], rv[i]), hi = mulhi(a[i], rv[(i + 1) & 7]);
    t[i & 1] += (uint64_t)lo + hi;
    m[i & 1] += (uint64_t)(lo & (0u - ((uint32_t)i > k))) +
                (hi & (0u - ((uint32_t)i >= k)));
  }
  return (t[0] + t[1]) + 37 * (m[0] + m[1]);
}

// r = a * b mod p, lazy (< 2^256); a, b, r whole and the same in every
// lane of the group (r may alias a or b)
static __device__ __forceinline__ void g_mul(uint32_t r[8],
                                             const uint32_t a[8],
                                             const uint32_t b[8]) {
  glane lo, hi;
#pragma unroll
  for (int j = 0; j < GN; j++) {
    uint64_t s = g_column(a, b, g_k(j));
    lo.v[j] = (uint32_t)s;
    hi.v[j] = (uint32_t)(s >> 32);  // < 2^10: S_k < 2^36 + 37 * 2^36
  }
  uint32_t l[8], h[8];
  g_gather(h, hi);
  g_gather(l, lo);
  // x = the columns' sum mod 2^256, y = x + 38 (mod 2^256): when the sum
  // passed 2^256 (it stays below 2^256 + 2^235), y is the result
  uint32_t x[8], y[8];
  x[0] = madlo_cc(h[7], 38u, l[0]);
#pragma unroll
  for (int j = 1; j < 8; j++) x[j] = addc_cc(l[j], h[j - 1]);
  uint32_t e = addc(0, 0);
  y[0] = add_cc(l[0], mullo(h[7], 38u) + 38u);
#pragma unroll
  for (int j = 1; j < 8; j++) y[j] = addc_cc(l[j], h[j - 1]);
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = e ? y[j] : x[j];
}

// r = a^(2^n) (r may alias a)
static __device__ __forceinline__ void g_sqn(uint32_t r[8],
                                             const uint32_t a[8], int n) {
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = a[j];
#pragma unroll 1
  for (int i = 0; i < n; i++) g_mul(r, r, r);
}
