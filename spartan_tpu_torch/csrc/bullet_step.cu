// K6, the scalar step of a bullet round (the inner-product reduction of
// nizk/bullet.rs:32-135) on the device.
//
// Replaces the JAX package's XLA scalar work of a device bullet round:
// spartan_tpu/protocols/bullet.py:89 (_bullet_fold_jit) and the scalar
// part of spartan_tpu/protocols/device_prover.py:682-748
// (_bullet_round_fn: the cross products c_L, c_R, the fold of a and b by
// u and u^-1, blind_fin), with its head (the r challenge, blind_Gamma,
// :672-675) and tail (z1, z2, :779-782).  All values are Fq residues in
// Montgomery form unless named canonical; a, b are (n, 8) with m = n/2.
//   cross: c_L = <a_L, b_R>, c_R = <a_R, b_L>; writes K5's two scalar
//          rows, canonical: [a_L, c_L, blind_L] and [a_R, c_R, blind_R]
//          (for the points [G_R, Q, H] and [G_L, Q, H]).
//   fold:  u read through a pointer (8 Montgomery words, or the 64 bytes
//          the device transcript squeezed); u^-1 by safegcd
//          (bullet_step.cuh) on one thread of each block while the rest
//          wait; a' = u a_L + u^-1
//          a_R, b' = u^-1 b_L + u b_R; blind_fin += blind_L u^2 +
//          blind_R u^-2 in place; K5's G-fold scalars [u^-1, u] for each
//          pair (G_L[i], G_R[i]), canonical.
//   head:  r from its 64 challenge bytes: r canonical (K5's scalar for
//          Q = r g_1) and blind_Gamma = blind_x + r blind_y.
//   tail:  c from its 64 challenge bytes: z1 = d + c x_hat a_hat,
//          z2 = a_hat (c blind_fin + r_beta) + r_delta.
//
// Bound on this card: at the sizes of this slice (m <= 2,048) neither
// bytes (~4 m x 32 B, ~80 ns) nor multiply-adds (~4 m Montgomery
// products) but the inverse's dependent chain in fold (590 divsteps, one
// after another, and 10 matrix updates), and launch latency in the
// others.
//
// Design: cross is one block of 256 threads: each thread takes every
// 256th pair (four products side by side), then a shared-memory halving
// tree sums the two dot products; thread 0 converts them and the blinds.
// fold runs ceil(m / 256) blocks, at most one a SM: each block's thread
// 0 inverts u itself (the blocks need no word from each other), block 0
// updates blind_fin, then every thread folds its pairs.  head and tail
// are one thread.  The plain PyTorch twin is
// spartan_tpu_torch/ff/bullet_kernel.py (the same values, canonical
// residues, so bit for bit).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bullet_step.cuh"

#define BLOCK 256
#define MAX_FOLD_BLOCKS 132

static __device__ __forceinline__ void load_scalar(uint32_t r[8],
                                                   const void* src,
                                                   int wide) {
  if (wide)
    fq_from_bytes_wide(r, (const uint8_t*)src);
  else
    fq_load(r, (const uint32_t*)src);
}

// a, b: (2m, 8); blinds: (2, 8); out: (2, m + 2, 8) canonical
__global__ void __launch_bounds__(BLOCK)
    bullet_cross_kernel(const uint32_t* __restrict__ a,
                        const uint32_t* __restrict__ b, int m,
                        const uint32_t* __restrict__ blinds,
                        uint32_t* __restrict__ out) {
  __shared__ uint32_t sh[2 * 8 * BLOCK];  // word j of sum k at (k*8+j)*BLOCK
  const uint32_t one[4][8] = {{1}, {1}, {1}, {1}};
  int t = threadIdx.x;
  uint32_t* outL = out;
  uint32_t* outR = out + (size_t)(m + 2) * 8;
  uint32_t c[2][8];
#pragma unroll
  for (int j = 0; j < 8; j++) c[0][j] = c[1][j] = 0;
  for (int i = t; i < m; i += BLOCK) {
    uint32_t x[4][8], y[4][8], p[4][8];
    fq_load(x[0], a + (size_t)i * 8);        // a_L
    fq_load(x[1], a + (size_t)(m + i) * 8);  // a_R
    fq_load(y[0], b + (size_t)(m + i) * 8);  // b_R
    fq_load(y[1], b + (size_t)i * 8);        // b_L
#pragma unroll
    for (int j = 0; j < 8; j++) {
      x[2][j] = x[0][j];
      x[3][j] = x[1][j];
      y[2][j] = one[2][j];
      y[3][j] = one[3][j];
    }
    fq_mul_n<4>(p, x, y);
    fq_add(c[0], c[0], p[0]);
    fq_add(c[1], c[1], p[1]);
    fq_store(outL + (size_t)i * 8, p[2]);
    fq_store(outR + (size_t)i * 8, p[3]);
  }
#pragma unroll
  for (int k = 0; k < 2; k++)
#pragma unroll
    for (int j = 0; j < 8; j++) sh[(k * 8 + j) * BLOCK + t] = c[k][j];
  __syncthreads();
  for (int half = BLOCK / 2; half >= 1; half >>= 1) {
    if (t < half) {
#pragma unroll
      for (int k = 0; k < 2; k++) {
        uint32_t o[8];
#pragma unroll
        for (int j = 0; j < 8; j++) o[j] = sh[(k * 8 + j) * BLOCK + t + half];
        fq_add(c[k], c[k], o);
#pragma unroll
        for (int j = 0; j < 8; j++) sh[(k * 8 + j) * BLOCK + t] = c[k][j];
      }
    }
    __syncthreads();
  }
  if (t == 0) {
    uint32_t x[4][8], p[4][8];
    fq_load(x[2], blinds);
    fq_load(x[3], blinds + 8);
#pragma unroll
    for (int j = 0; j < 8; j++) {
      x[0][j] = c[0][j];
      x[1][j] = c[1][j];
    }
    fq_mul_n<4>(p, x, one);
    fq_store(outL + (size_t)m * 8, p[0]);
    fq_store(outL + (size_t)(m + 1) * 8, p[2]);
    fq_store(outR + (size_t)m * 8, p[1]);
    fq_store(outR + (size_t)(m + 1) * 8, p[3]);
  }
}

// a, b: (2m, 8); blinds: (2, 8); blind_fin: (8,) in place; a2, b2: (m, 8);
// gsc: (m, 2, 8) canonical
__global__ void __launch_bounds__(BLOCK)
    bullet_fold_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b, int m, const void* u_src,
                       int u_wide, const uint32_t* __restrict__ blinds,
                       uint32_t* __restrict__ blind_fin,
                       uint32_t* __restrict__ a2, uint32_t* __restrict__ b2,
                       uint32_t* __restrict__ gsc) {
  __shared__ uint32_t su[4][8];  // u, u^-1 (Montgomery), then canonical
  if (threadIdx.x == 0) {
    uint32_t x[2][8], y[2][8], p[2][8];
    load_scalar(x[0], u_src, u_wide);
    fq_inv(x[1], x[0]);
    const uint32_t one[2][8] = {{1}, {1}};
    fq_mul_n<2>(p, x, one);
#pragma unroll
    for (int j = 0; j < 8; j++) {
      su[0][j] = x[0][j];
      su[1][j] = x[1][j];
      su[2][j] = p[0][j];
      su[3][j] = p[1][j];
    }
    if (blockIdx.x == 0) {
      fq_mul_n<2>(y, x, x);  // u^2, u^-2
      fq_load(x[0], blinds);
      fq_load(x[1], blinds + 8);
      fq_mul_n<2>(p, x, y);
      uint32_t bf[8];
      fq_load(bf, blind_fin);
      fq_add(bf, bf, p[0]);
      fq_add(bf, bf, p[1]);
      fq_store(blind_fin, bf);
    }
  }
  __syncthreads();
  uint32_t u[8], ui[8];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    u[j] = su[0][j];
    ui[j] = su[1][j];
  }
  for (int i = blockIdx.x * BLOCK + threadIdx.x; i < m;
       i += gridDim.x * BLOCK) {
    uint32_t x[4][8], y[4][8], p[4][8], r[8];
    fq_load(x[0], a + (size_t)i * 8);
    fq_load(x[1], a + (size_t)(m + i) * 8);
    fq_load(x[2], b + (size_t)i * 8);
    fq_load(x[3], b + (size_t)(m + i) * 8);
#pragma unroll
    for (int j = 0; j < 8; j++) {
      y[0][j] = u[j];
      y[1][j] = ui[j];
      y[2][j] = ui[j];
      y[3][j] = u[j];
    }
    fq_mul_n<4>(p, x, y);
    fq_add(r, p[0], p[1]);
    fq_store(a2 + (size_t)i * 8, r);
    fq_add(r, p[2], p[3]);
    fq_store(b2 + (size_t)i * 8, r);
    fq_store(gsc + (size_t)i * 16, su[3]);
    fq_store(gsc + (size_t)i * 16 + 8, su[2]);
  }
}

// one thread's chain of `batches` divstep batches on the low words of f
// and g, each batch starting from the last one's zeta and from f, g mixed
// with its matrix: 30 divsteps on 32-bit words (wide = 0, divsteps_30) or
// the fold's own 59 on 64-bit words (wide = 1, divsteps_59).
// chip_smoke.py times it to measure one divstep's latency, the unit of
// the fold's bound.  fgz: (3,) int64 = f (odd), g, zeta, updated
__global__ void divstep_chain_kernel(int64_t* fgz, int batches, int wide) {
  uint64_t f = (uint64_t)fgz[0], g = (uint64_t)fgz[1];
  int64_t zeta = fgz[2];
  if (wide) {
#pragma unroll 1
    for (int i = 0; i < batches; i++) {
      trans2x2_t t;
      zeta = divsteps_59(zeta, f, g, t);
      f = (f ^ (uint64_t)(t.u ^ t.v)) | 1;
      g ^= (uint64_t)(t.q ^ t.r);
    }
  } else {
    uint32_t f32 = (uint32_t)f, g32 = (uint32_t)g;
    int32_t z32 = (int32_t)zeta;
#pragma unroll 1
    for (int i = 0; i < batches; i++) {
      trans2x2_32_t t;
      z32 = divsteps_30(z32, f32, g32, t);
      f32 = (f32 ^ (uint32_t)(t.u ^ t.v)) | 1;
      g32 ^= (uint32_t)(t.q ^ t.r);
    }
    f = f32;
    g = g32;
    zeta = z32;
  }
  fgz[0] = (int64_t)f;
  fgz[1] = (int64_t)g;
  fgz[2] = zeta;
}

// r: 64 challenge bytes; bx, by: (8,); out: (2, 8) = [r canonical,
// blind_Gamma]
__global__ void bullet_head_kernel(const uint8_t* __restrict__ r_bytes,
                                   const uint32_t* __restrict__ bx,
                                   const uint32_t* __restrict__ by,
                                   uint32_t* __restrict__ out) {
  uint32_t r[8], x[8], y[8];
  fq_from_bytes_wide(r, r_bytes);
  fq_from_mont(x, r);
  fq_store(out, x);
  fq_load(y, by);
  fq_mul(x, r, y);
  fq_load(y, bx);
  fq_add(x, x, y);
  fq_store(out + 8, x);
}

// c: 64 challenge bytes; x_hat, a_hat, bf: (8,); drr: (3, 8) = d,
// r_delta, r_beta; out: (2, 8) = [z1, z2]
__global__ void bullet_tail_kernel(const uint8_t* __restrict__ c_bytes,
                                   const uint32_t* __restrict__ x_hat,
                                   const uint32_t* __restrict__ a_hat,
                                   const uint32_t* __restrict__ bf,
                                   const uint32_t* __restrict__ drr,
                                   uint32_t* __restrict__ out) {
  uint32_t c[8], xh[8], ah[8], v[8], w[8], s[8];
  fq_from_bytes_wide(c, c_bytes);
  fq_load(xh, x_hat);
  fq_load(ah, a_hat);
  fq_mul(v, xh, ah);  // y_hat
  fq_mul(w, c, v);
  fq_load(s, drr);  // d
  fq_add(w, w, s);
  fq_store(out, w);
  fq_load(s, bf);
  fq_mul(v, c, s);
  fq_load(s, drr + 16);  // r_beta
  fq_add(v, v, s);
  fq_mul(w, ah, v);
  fq_load(s, drr + 8);  // r_delta
  fq_add(w, w, s);
  fq_store(out + 8, w);
}

extern "C" int bullet_cross_launch(const void* a, const void* b, int m,
                                   const void* blinds, void* out,
                                   void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  bullet_cross_kernel<<<1, BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, m, (const uint32_t*)blinds,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int bullet_fold_launch(const void* a, const void* b, int m,
                                  const void* u, int u_wide,
                                  const void* blinds, void* blind_fin,
                                  void* a2, void* b2, void* gsc,
                                  void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  int grid = (m + BLOCK - 1) / BLOCK;
  if (grid > MAX_FOLD_BLOCKS) grid = MAX_FOLD_BLOCKS;
  bullet_fold_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, m, u, u_wide,
      (const uint32_t*)blinds, (uint32_t*)blind_fin, (uint32_t*)a2,
      (uint32_t*)b2, (uint32_t*)gsc);
  return (int)cudaGetLastError();
}

extern "C" int bullet_head_launch(const void* r, const void* bx,
                                  const void* by, void* out, void* stream) {
  bullet_head_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)r, (const uint32_t*)bx, (const uint32_t*)by,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int bullet_tail_launch(const void* c, const void* x_hat,
                                  const void* a_hat, const void* bf,
                                  const void* drr, void* out, void* stream) {
  bullet_tail_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)c, (const uint32_t*)x_hat, (const uint32_t*)a_hat,
      (const uint32_t*)bf, (const uint32_t*)drr, (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int divstep_chain_launch(void* fgz, int batches, int wide,
                                    void* stream) {
  if (batches < 0) return (int)cudaErrorInvalidValue;
  divstep_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((int64_t*)fgz,
                                                          batches, wide);
  return (int)cudaGetLastError();
}
