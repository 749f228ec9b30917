// Constant-time variable-base scalar multiplication of one ed25519
// point, for kernel K5 (point_msm.cu).
//
// r = s * p for a canonical scalar s (8 words) and an extended point p:
// a table tab[k] = k * p for k < 16 (tab[0] the identity, tab[k] =
// tab[k-1] + p by the unified add), then the 64 4-bit windows of s from
// the top: 4 doublings, then one unified add of tab[digit].  The entry
// is chosen by reading all 16 entries and keeping one by a mask
// (ge_select16), so no branch and no address depends on a digit; the
// identity entry is added like any other.  The plain PyTorch twin
// (spartan_tpu_torch/curve/point_msm.py) runs the same point operations
// in the same order.
#pragma once
#include <stdint.h>

#include "fp25519.cuh"

// all ones when a == b, else 0, with no branch and no compare flag
static __device__ __forceinline__ uint32_t ct_eq_mask(uint32_t a,
                                                      uint32_t b) {
  uint32_t x = a ^ b;
  return ((x | (0u - x)) >> 31) - 1u;
}

// r = tab[d]: every entry read, all but one masked off
static __device__ __forceinline__ void ge_select16(ge_t& r,
                                                   const ge_t tab[16],
                                                   uint32_t d) {
#pragma unroll
  for (int j = 0; j < 8; j++) {
    r.x[j] = 0; r.y[j] = 0; r.z[j] = 0; r.t[j] = 0;
  }
#pragma unroll
  for (int k = 0; k < 16; k++) {
    uint32_t m = ct_eq_mask((uint32_t)k, d);
#pragma unroll
    for (int j = 0; j < 8; j++) {
      r.x[j] |= tab[k].x[j] & m;
      r.y[j] |= tab[k].y[j] & m;
      r.z[j] |= tab[k].z[j] & m;
      r.t[j] |= tab[k].t[j] & m;
    }
  }
}

static __device__ __forceinline__ void ge_scalar_mul_ct(ge_t& r,
                                                        const ge_t& p,
                                                        const uint32_t s[8]) {
  ge_t tab[16];
  ge_identity(tab[0]);
  tab[1] = p;
#pragma unroll 1
  for (int k = 2; k < 16; k++) ge_add(tab[k], tab[k - 1], p);
  ge_identity(r);
#pragma unroll 1
  for (int w = 63; w >= 0; w--) {
#pragma unroll 1
    for (int k = 0; k < 4; k++) ge_dbl(r, r);
    ge_t e;
    ge_select16(e, tab, (s[w >> 3] >> ((w & 7) * 4)) & 15u);
    ge_add(r, r, e);
  }
}
