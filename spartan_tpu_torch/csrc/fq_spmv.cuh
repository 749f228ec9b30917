// The row body of the Fq sparse product (kernel K9, fq_spmv.cu): a row's
// sum of products val[j] * x[idx[j]] over its non-zeros, kept unreduced
// in a 9-word accumulator, and the one reduction of the row.
//
// A matrix is held sorted by output index (spartan_tpu_torch/ff/spmv.py,
// SpmvTable): the non-zeros of output r are entries off[r] .. off[r + 1]
// - 1; entry j's input index is idx[j] and its value (Montgomery, 8
// words) val[perm[j]].  Each of off, idx and perm (int32) is null where
// it would be the identity (off[r] = r: one non-zero an output).  Values
// and inputs are canonical (< q), so each product is canonical and a sum
// of k of them stays below k * q.
#pragma once
#include <stdint.h>

#include "fq.cuh"

// a[k], or k where the array is the identity (null)
static __device__ __forceinline__ long fq_spmv_at(
    const int32_t* __restrict__ a, long k) {
  return a ? (long)(uint32_t)a[k] : k;
}

// acc += sum of value(j) * x[idx[j]] for j = j0, j0 + step, ... below e,
// N products side by side while N entries remain, then one at a time (a
// row of one entry costs one product, not N)
template <int N>
static __device__ __forceinline__ void fq_spmv_acc(
    uint32_t acc[9], const int32_t* __restrict__ idx,
    const uint32_t* __restrict__ val, const int32_t* __restrict__ perm,
    const uint32_t* __restrict__ x, long j0, long e, long step) {
  long j = j0;
  for (; j + (N - 1) * step < e; j += N * step) {
    uint32_t a[N][8], b[N][8];
#pragma unroll
    for (int n = 0; n < N; n++) {
      const long k = j + n * step;
      fq_load(a[n], val + 8 * fq_spmv_at(perm, k));
      fq_load(b[n], x + 8 * fq_spmv_at(idx, k));
    }
    fq_acc_mul_n<N>(acc, a, b);
  }
  for (; j < e; j += step) {
    uint32_t a[1][8], b[1][8];
    fq_load(a[0], val + 8 * fq_spmv_at(perm, j));
    fq_load(b[0], x + 8 * fq_spmv_at(idx, j));
    fq_acc_mul_n<1>(acc, a, b);
  }
}

// r = acc mod q for the sum of a row's n products: below 2q for n <= 2,
// where one conditional subtraction does (an empty row gives 0), and
// fq_reduce_wide's two products otherwise
static __device__ __forceinline__ void fq_spmv_finish(uint32_t r[8],
                                                      const uint32_t acc[9],
                                                      long n) {
  if (n <= 2)
    fq_cond_sub(r, acc);
  else
    fq_reduce_wide(r, acc);
}
