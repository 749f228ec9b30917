// Montgomery arithmetic in the ristretto255 scalar field Fq on the device,
// q = 2^252 + 27742317777372353535851937790883648493, R = 2^256.
//
// An element is uint32_t[8], little-endian limbs, canonical (< q), in
// Montgomery form: the same 32 bytes as the port's (..., 8) int32 storage
// layout (spartan_tpu_torch/ff/limb.py).  Multiplication is CIOS with
// 32-bit words and 64-bit products.  The plain PyTorch twin is
// spartan_tpu_torch/ff/fq.py; the TPU kernel's copy was the 16-bit-limb
// class _Fq in spartan_tpu/ff/pallas_kernels.py.
#pragma once
#include <stdint.h>

static __constant__ uint32_t FQ_Q[8] = {
    0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu,
    0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u};
#define FQ_NP0 0x12547e1bu  // -q^-1 mod 2^32

// r = t - q if t >= q else t   (t < 2q, so one subtraction suffices)
static __device__ __forceinline__ void fq_cond_sub(uint32_t r[8],
                                                   const uint32_t t[8]) {
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    uint64_t s = (uint64_t)t[j] - FQ_Q[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = s >> 63;
  }
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = borrow ? t[j] : d[j];
}

static __device__ __forceinline__ void fq_add(uint32_t r[8],
                                              const uint32_t a[8],
                                              const uint32_t b[8]) {
  uint32_t t[8];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    uint64_t s = (uint64_t)a[j] + b[j] + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
  fq_cond_sub(r, t);  // a + b < 2q < 2^254: no carry out
}

static __device__ __forceinline__ void fq_sub(uint32_t r[8],
                                              const uint32_t a[8],
                                              const uint32_t b[8]) {
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    uint64_t s = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = s >> 63;
  }
  uint32_t mask = 0u - (uint32_t)borrow;  // add q back on a borrow
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    uint64_t s = (uint64_t)d[j] + (FQ_Q[j] & mask) + c;
    r[j] = (uint32_t)s;
    c = s >> 32;
  }
}

// Montgomery product r = a * b * R^-1 mod q (CIOS).
static __device__ __forceinline__ void fq_mul(uint32_t r[8],
                                              const uint32_t a[8],
                                              const uint32_t b[8]) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * FQ_NP0;
    s = (uint64_t)m * FQ_Q[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      s = (uint64_t)m * FQ_Q[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  fq_cond_sub(r, t);  // t < 2q: t[8] == 0
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
