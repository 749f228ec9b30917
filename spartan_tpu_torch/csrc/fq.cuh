// Montgomery arithmetic in the ristretto255 scalar field Fq on the device,
// q = 2^252 + 27742317777372353535851937790883648493, R = 2^256.
//
// An element is uint32_t[8], little-endian limbs, canonical (< q), in
// Montgomery form: the same 32 bytes as the port's (..., 8) int32 storage
// layout (spartan_tpu_torch/ff/limb.py).  Multiplication is CIOS with
// 32-bit words.  The plain PyTorch twin is spartan_tpu_torch/ff/fq.py;
// the TPU kernel's copy was the 16-bit-limb class _Fq in
// spartan_tpu/ff/pallas_kernels.py.
//
// fq_add, fq_sub and fq_mul are carry chains (carry.cuh).  The CIOS
// product skips q's three zero words (q = q0..q3 + q7 * 2^224): 104 wide
// multiply-adds a product; fq_mul_n runs N independent products side by
// side.
//
// fq_add_lazy leaves a sum unreduced where it only feeds fq_mul's second
// operand.  A sum of many elements is kept unreduced in a 9-word accumulator
// (fq_acc_add, fq_acc_add9) and brought to [0, q) once (fq_reduce_wide).
#pragma once
#include <stdint.h>

#include "carry.cuh"

static __constant__ uint32_t FQ_R2[8] = {  // R^2 mod q
    0x449c0f01u, 0xa40611e3u, 0x68859347u, 0xd00e1ba7u,
    0x17f5be65u, 0xceec73d2u, 0x7c309a3du, 0x0399411bu};
#define FQ_NP0 0x12547e1bu  // -q^-1 mod 2^32
#define FQ_Q0 0x5cf5d3edu
#define FQ_Q1 0x5812631au
#define FQ_Q2 0xa2f79cd6u
#define FQ_Q3 0x14def9deu
#define FQ_Q7 0x10000000u

// r = t - q if t >= q else t   (t < 2q)
static __device__ __forceinline__ void fq_cond_sub(uint32_t r[8],
                                                   const uint32_t t[8]) {
  uint32_t d[8];
  d[0] = sub_cc(t[0], FQ_Q0);
  d[1] = subc_cc(t[1], FQ_Q1);
  d[2] = subc_cc(t[2], FQ_Q2);
  d[3] = subc_cc(t[3], FQ_Q3);
  d[4] = subc_cc(t[4], 0);
  d[5] = subc_cc(t[5], 0);
  d[6] = subc_cc(t[6], 0);
  d[7] = subc_cc(t[7], FQ_Q7);
  uint32_t borrow = subc(0, 0);
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = borrow ? t[j] : d[j];
}

static __device__ __forceinline__ void fq_add(uint32_t r[8],
                                              const uint32_t a[8],
                                              const uint32_t b[8]) {
  uint32_t t[8];
  t[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < 7; j++) t[j] = addc_cc(a[j], b[j]);
  t[7] = addc(a[7], b[7]);  // a + b < 2q < 2^254: no carry out
  fq_cond_sub(r, t);
}

static __device__ __forceinline__ void fq_sub(uint32_t r[8],
                                              const uint32_t a[8],
                                              const uint32_t b[8]) {
  uint32_t d[8];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < 8; j++) d[j] = subc_cc(a[j], b[j]);
  uint32_t mask = subc(0, 0);  // all ones on a borrow: add q back
  r[0] = add_cc(d[0], FQ_Q0 & mask);
  r[1] = addc_cc(d[1], FQ_Q1 & mask);
  r[2] = addc_cc(d[2], FQ_Q2 & mask);
  r[3] = addc_cc(d[3], FQ_Q3 & mask);
  r[4] = addc_cc(d[4], 0);
  r[5] = addc_cc(d[5], 0);
  r[6] = addc_cc(d[6], 0);
  r[7] = addc(d[7], FQ_Q7 & mask);
}

// N independent Montgomery products r[n] = a[n] * b[n] * R^-1 mod q
// (CIOS), for a[n] < q and any b[n] < 2^256, stepped together one word of
// b at a time: each product is one serial chain, so the N chains side by
// side give the scheduler N instructions to choose from.  The running
// value t (9 words) stays below 2^288, so no chain carries out of t[8].
// Each chain adds whole 64-bit products (low half to word k, high half
// to word k+1; one chain for the even and one for the odd words of a and
// of q): ptxas fuses each such pair into one IMAD.WIDE.U32(.X), where
// chains of low halves and of high halves cost an IMAD and an IADD3.X a
// half.
template <int N>
static __device__ __forceinline__ void fq_mul_n(uint32_t (*r)[8],
                                                const uint32_t (*a)[8],
                                                const uint32_t (*b)[8]) {
  uint32_t t[N][9];
#pragma unroll
  for (int n = 0; n < N; n++)
#pragma unroll
    for (int j = 0; j < 9; j++) t[n][j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
#pragma unroll
    for (int n = 0; n < N; n++) {
      uint32_t* u = t[n];
      const uint32_t* x = a[n];
      uint32_t y = b[n][i];
      // u += x * y
      u[0] = madlo_cc(x[0], y, u[0]);
      u[1] = madhic_cc(x[0], y, u[1]);
#pragma unroll
      for (int k = 2; k < 8; k += 2) {
        u[k] = madloc_cc(x[k], y, u[k]);
        u[k + 1] = madhic_cc(x[k], y, u[k + 1]);
      }
      u[8] = addc(u[8], 0);
      u[1] = madlo_cc(x[1], y, u[1]);
      u[2] = madhic_cc(x[1], y, u[2]);
#pragma unroll
      for (int k = 3; k < 7; k += 2) {
        u[k] = madloc_cc(x[k], y, u[k]);
        u[k + 1] = madhic_cc(x[k], y, u[k + 1]);
      }
      u[7] = madloc_cc(x[7], y, u[7]);
      u[8] = madhic(x[7], y, u[8]);
      // u += m * q with m making the low word 0, then drop that word
      uint32_t m = u[0] * FQ_NP0;
      u[0] = madlo_cc(m, FQ_Q0, u[0]);
      u[1] = madhic_cc(m, FQ_Q0, u[1]);
      u[2] = madloc_cc(m, FQ_Q2, u[2]);
      u[3] = madhic_cc(m, FQ_Q2, u[3]);
      u[4] = addc_cc(u[4], 0);
      u[5] = addc_cc(u[5], 0);
      u[6] = addc_cc(u[6], 0);
      u[7] = addc_cc(u[7], 0);
      u[8] = addc(u[8], 0);
      u[1] = madlo_cc(m, FQ_Q1, u[1]);
      u[2] = madhic_cc(m, FQ_Q1, u[2]);
      u[3] = madloc_cc(m, FQ_Q3, u[3]);
      u[4] = madhic_cc(m, FQ_Q3, u[4]);
      u[5] = addc_cc(u[5], 0);
      u[6] = addc_cc(u[6], 0);
      u[7] = madloc_cc(m, FQ_Q7, u[7]);
      u[8] = madhic(m, FQ_Q7, u[8]);
#pragma unroll
      for (int j = 0; j < 8; j++) u[j] = u[j + 1];
      u[8] = 0;
    }
  }
#pragma unroll
  for (int n = 0; n < N; n++) fq_cond_sub(r[n], t[n]);  // t < 2q
}

static __device__ __forceinline__ void fq_mul(uint32_t r[8],
                                              const uint32_t a[8],
                                              const uint32_t b[8]) {
  uint32_t ra[1][8];
  fq_mul_n<1>(ra, (const uint32_t(*)[8])a, (const uint32_t(*)[8])b);
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = ra[0][j];
}

// N Montgomery maps side by side: r[n] = a[n] * R mod q, canonical, for
// any a[n] < 2^256 (a product by R^2: R^2 < q is the first operand, so
// a[n] may take any value fq_mul_n allows its second)
template <int N>
static __device__ __forceinline__ void fq_to_mont_n(uint32_t (*r)[8],
                                                    const uint32_t (*a)[8]) {
  uint32_t r2[N][8];
#pragma unroll
  for (int n = 0; n < N; n++)
#pragma unroll
    for (int j = 0; j < 8; j++) r2[n][j] = FQ_R2[j];
  fq_mul_n<N>(r, (const uint32_t(*)[8])r2, a);
}

// r = a + b unreduced, for a sum the caller keeps below 2^256 (a lazy
// second operand of fq_mul)
static __device__ __forceinline__ void fq_add_lazy(uint32_t r[8],
                                                   const uint32_t a[8],
                                                   const uint32_t b[8]) {
  r[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < 7; j++) r[j] = addc_cc(a[j], b[j]);
  r[7] = addc(a[7], b[7]);
}

// acc (9 words) += x (8 words)
static __device__ __forceinline__ void fq_acc_add(uint32_t acc[9],
                                                  const uint32_t x[8]) {
  acc[0] = add_cc(acc[0], x[0]);
#pragma unroll
  for (int j = 1; j < 8; j++) acc[j] = addc_cc(acc[j], x[j]);
  acc[8] = addc(acc[8], 0);
}

// acc (9 words) += x (9 words); the sum stays below 2^288
static __device__ __forceinline__ void fq_acc_add9(uint32_t acc[9],
                                                   const uint32_t x[9]) {
  acc[0] = add_cc(acc[0], x[0]);
#pragma unroll
  for (int j = 1; j < 8; j++) acc[j] = addc_cc(acc[j], x[j]);
  acc[8] = addc(acc[8], x[8]);
}


// r = v mod q for a 9-word v = lo + v[8] * 2^256: v * R^-1 is
// lo * R^-1 + v[8] (R = 2^256), and one more product by R^2 undoes the
// R^-1.  As Montgomery residues, v is a sum of residues and r its
// residue.
static __device__ __forceinline__ void fq_reduce_wide(uint32_t r[8],
                                                      const uint32_t v[9]) {
  const uint32_t one[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  const uint32_t hi[8] = {v[8], 0, 0, 0, 0, 0, 0, 0};
  uint32_t r2[8];
#pragma unroll
  for (int j = 0; j < 8; j++) r2[j] = FQ_R2[j];
  uint32_t u[8];
  fq_mul(u, one, v);  // lo * R^-1 mod q (v's ninth word is not read)
  fq_add(u, u, hi);
  fq_mul(r, u, r2);
}

static __device__ __forceinline__ void fq_load(uint32_t r[8],
                                               const uint32_t* p) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
  uint4 lo = v[0], hi = v[1];
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

static __device__ __forceinline__ void fq_store(uint32_t* p,
                                                const uint32_t a[8]) {
  uint4* v = reinterpret_cast<uint4*>(p);
  v[0] = make_uint4(a[0], a[1], a[2], a[3]);
  v[1] = make_uint4(a[4], a[5], a[6], a[7]);
}
