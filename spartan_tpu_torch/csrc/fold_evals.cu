// One fused sum-check round on the device.
//
// Replaces the TPU kernel spartan_tpu/ff/pallas_kernels.py:211
// (_fold_evals_kernel, called from _fold_evals_call at :265), whose
// dataflow is the JAX prover's round step
// spartan_tpu/protocols/sumcheck.py:103-116 (_fold_then_evals).
// For ntab in {2, 4} tables T of n = 2m elements (Fq, Montgomery):
//   fold:   F[j] = T[j] + r * (T[m + j] - T[j])           for j < m
//   evals:  the next round polynomial at X = 0, 2 (and 3) over the
//           pairs (F[j], F[j + m/2]): sum_j comb(lo + X (hi - lo)),
//           comb = A (B C - D) for 4 tables (phase 1), A B for 2.
// Modes: EVALS (round 0: evals over T itself), FOLD_EVALS, FOLD (last).
//
// Bound on this card: bytes, barely.  The first phase-1 round reads
// 4 x 2^20 x 32 B and writes 4 x 2^19 x 32 B (~201 MB, ~60 us at
// 3.35 TB/s); its ~3.7M Montgomery products (136 32x32->64-bit
// multiply-adds each) take about as long at the card's IMAD rate, so
// the kernel has no slack on either side.
//
// Design: thread j < m/2 reads T[j], T[j + m/2], T[m + j], T[m + j + m/2]
// of each table (the TPU kernel's four input blocks per table), writes
// F[j] and F[j + m/2], and forms the three comb values of its pair, so
// every element is read once and the folded table is produced in the
// order the next round reads it.  Blocks run in no order here, so the
// TPU kernel's running sum in scratch memory becomes a per-block tree
// sum mod q in shared memory plus a second one-block kernel that sums
// the block partials.  The challenge r arrives in Montgomery form.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fq.cuh"

#define MODE_EVALS 0
#define MODE_FOLD_EVALS 1
#define MODE_FOLD 2
#define BLOCK 256

struct tables_t {
  const uint32_t* in[4];
  uint32_t* out[4];
};

struct fq_arg_t {
  uint32_t v[8];
};

template <int NTAB>
static __device__ __forceinline__ void comb(uint32_t r[8],
                                           const uint32_t (&x)[NTAB][8]) {
  if constexpr (NTAB == 4) {  // A * (B * C - D)
    uint32_t bc[8];
    fq_mul(bc, x[1], x[2]);
    fq_sub(bc, bc, x[NTAB - 1]);
    fq_mul(r, x[0], bc);
  } else {  // A * B
    fq_mul(r, x[0], x[1]);
  }
}

// Sum three field elements per thread over the block; thread 0 gets the
// totals.  sh: 3 * 8 * BLOCK words.
static __device__ void block_sum3(uint32_t (*e)[8], uint32_t* sh) {
  int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < 3; k++)
#pragma unroll
    for (int j = 0; j < 8; j++) sh[(k * 8 + j) * BLOCK + t] = e[k][j];
  __syncthreads();
  for (int half = BLOCK / 2; half > 0; half >>= 1) {
    if (t < half) {
#pragma unroll
      for (int k = 0; k < 3; k++) {
        uint32_t a[8], b[8];
#pragma unroll
        for (int j = 0; j < 8; j++) {
          a[j] = sh[(k * 8 + j) * BLOCK + t];
          b[j] = sh[(k * 8 + j) * BLOCK + t + half];
        }
        fq_add(a, a, b);
#pragma unroll
        for (int j = 0; j < 8; j++) sh[(k * 8 + j) * BLOCK + t] = a[j];
      }
    }
    __syncthreads();
  }
  if (t == 0) {
#pragma unroll
    for (int k = 0; k < 3; k++)
#pragma unroll
      for (int j = 0; j < 8; j++) e[k][j] = sh[(k * 8 + j) * BLOCK];
  }
}

// n: size of the input tables.  FOLD: one thread per j < n/2.
// EVALS: one thread per pair j < n/2.  FOLD_EVALS: one thread per
// j < n/4.  partial: (gridDim.x, 3, 8) block sums (not written in FOLD).
template <int NTAB, int MODE>
__global__ void fold_evals_kernel(tables_t tabs, long n, fq_arg_t r,
                                  uint32_t* __restrict__ partial) {
  __shared__ uint32_t sh[3 * 8 * BLOCK];
  long j = (long)blockIdx.x * BLOCK + threadIdx.x;
  long m = n / 2;
  long count = MODE == MODE_FOLD_EVALS ? m / 2 : m;
  bool live = j < count;

  uint32_t lo[NTAB][8], hi[NTAB][8];
  if (live) {
#pragma unroll
    for (int t = 0; t < NTAB; t++) {
      const uint32_t* T = tabs.in[t];
      if constexpr (MODE == MODE_EVALS) {
        fq_load(lo[t], T + 8 * j);
        fq_load(hi[t], T + 8 * (j + m));
      } else if constexpr (MODE == MODE_FOLD) {
        uint32_t a[8], b[8];
        fq_load(a, T + 8 * j);
        fq_load(b, T + 8 * (j + m));
        fq_sub(b, b, a);
        fq_mul(b, r.v, b);
        fq_add(a, a, b);
        fq_store(tabs.out[t] + 8 * j, a);
      } else {
        long h = m / 2;
        uint32_t a[8], b[8];
        fq_load(a, T + 8 * j);
        fq_load(b, T + 8 * (m + j));
        fq_sub(b, b, a);
        fq_mul(b, r.v, b);
        fq_add(lo[t], a, b);
        fq_load(a, T + 8 * (j + h));
        fq_load(b, T + 8 * (m + j + h));
        fq_sub(b, b, a);
        fq_mul(b, r.v, b);
        fq_add(hi[t], a, b);
        fq_store(tabs.out[t] + 8 * j, lo[t]);
        fq_store(tabs.out[t] + 8 * (j + h), hi[t]);
      }
    }
  }
  if constexpr (MODE == MODE_FOLD) return;

  uint32_t e[3][8];
#pragma unroll
  for (int k = 0; k < 3; k++)
#pragma unroll
    for (int w = 0; w < 8; w++) e[k][w] = 0;
  if (live) {
    comb<NTAB>(e[0], lo);
    // X = 2: p2 = 2 hi - lo; X = 3: p3 = p2 + (hi - lo)
    uint32_t p[NTAB][8];
#pragma unroll
    for (int t = 0; t < NTAB; t++) {
      fq_add(p[t], hi[t], hi[t]);
      fq_sub(p[t], p[t], lo[t]);
    }
    comb<NTAB>(e[1], p);
    if constexpr (NTAB == 4) {
#pragma unroll
      for (int t = 0; t < NTAB; t++) {
        uint32_t d[8];
        fq_sub(d, hi[t], lo[t]);
        fq_add(p[t], p[t], d);
      }
      comb<NTAB>(e[2], p);
    }
  }
  block_sum3(e, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; k++)
      fq_store(partial + ((size_t)blockIdx.x * 3 + k) * 8, e[k]);
  }
}

// One block: evals[k] = sum_b partial[b][k] mod q.
__global__ void sum_partials_kernel(const uint32_t* __restrict__ partial,
                                    int nparts, uint32_t* __restrict__ evals) {
  __shared__ uint32_t sh[3 * 8 * BLOCK];
  uint32_t e[3][8];
#pragma unroll
  for (int k = 0; k < 3; k++)
#pragma unroll
    for (int w = 0; w < 8; w++) e[k][w] = 0;
  for (int b = threadIdx.x; b < nparts; b += BLOCK) {
#pragma unroll
    for (int k = 0; k < 3; k++) {
      uint32_t x[8];
      fq_load(x, partial + ((size_t)b * 3 + k) * 8);
      fq_add(e[k], e[k], x);
    }
  }
  block_sum3(e, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; k++) fq_store(evals + k * 8, e[k]);
  }
}

// in/out: ntab table pointers each (unused slots may be null).  partial:
// scratch of nblocks * 3 * 8 words, nblocks = ceil(threads / 256).
// evals: (3, 8) output (untouched in FOLD mode).
extern "C" int fold_evals_launch(const void* in0, const void* in1,
                                 const void* in2, const void* in3,
                                 void* out0, void* out1, void* out2,
                                 void* out3, int ntab, long n, int mode,
                                 fq_arg_t r, void* partial, void* evals,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  tables_t tabs;
  tabs.in[0] = (const uint32_t*)in0;
  tabs.in[1] = (const uint32_t*)in1;
  tabs.in[2] = (const uint32_t*)in2;
  tabs.in[3] = (const uint32_t*)in3;
  tabs.out[0] = (uint32_t*)out0;
  tabs.out[1] = (uint32_t*)out1;
  tabs.out[2] = (uint32_t*)out2;
  tabs.out[3] = (uint32_t*)out3;
  long threads = mode == MODE_FOLD_EVALS ? n / 4 : n / 2;
  int nblocks = (int)((threads + BLOCK - 1) / BLOCK);
  uint32_t* part = (uint32_t*)partial;
#define LAUNCH(NT, MD) \
  fold_evals_kernel<NT, MD><<<nblocks, BLOCK, 0, s>>>(tabs, n, r, part)
  if (ntab == 4) {
    if (mode == MODE_EVALS) LAUNCH(4, MODE_EVALS);
    else if (mode == MODE_FOLD_EVALS) LAUNCH(4, MODE_FOLD_EVALS);
    else LAUNCH(4, MODE_FOLD);
  } else {
    if (mode == MODE_EVALS) LAUNCH(2, MODE_EVALS);
    else if (mode == MODE_FOLD_EVALS) LAUNCH(2, MODE_FOLD_EVALS);
    else LAUNCH(2, MODE_FOLD);
  }
#undef LAUNCH
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || mode == MODE_FOLD) return (int)e;
  sum_partials_kernel<<<1, BLOCK, 0, s>>>((const uint32_t*)partial, nblocks,
                                          (uint32_t*)evals);
  return (int)cudaGetLastError();
}
