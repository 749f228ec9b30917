// Elementwise Fq arithmetic on the device (kernel K7): out[i] = f(a[i],
// b[i]) over Fq storage tables (spartan_tpu_torch/ff/limb.py), one launch
// an operation.
//
// Replaces no TPU kernel: the JAX package runs its limb arithmetic in XLA
// (spartan_tpu/ff/fq.py; the Montgomery map of an uploaded table:
// spartan_tpu/poly/dense.py:134).  The plain PyTorch twin is
// spartan_tpu_torch/ff/fq.py (the eq table's: poly/dense.py), whose
// wrappers launch this file's modes for tensors on the card.  Modes:
//   TO_MONT:   out[i] = a[i] * R mod q (a product by R^2), canonical for
//              any a[i] < 2^256: the prover's witness, uploaded as
//              canonical bytes, straight into its slice of z; Spark's
//              integer tables.
//   FROM_MONT: out[i] = a[i] * R^-1 mod q (a product by 1), any a[i] <
//              2^256: the canonical scalars that B1 commits to.
//   MUL:       out[i] = a[i] * b[i] * R^-1 (the Montgomery product).
//   ADD, SUB:  out[i] = a[i] +- b[i] mod q.
//   EQ:        one doubling step of the eq table: out[2i + 1] = a[i] *
//              b[i] (Montgomery) and out[2i] = a[i] - out[2i + 1], over
//              the n entries of a; b is the step's point coordinate.
// Operands other than TO_MONT's and FROM_MONT's are canonical (< q).
//
// Bound on this card: bytes, barely.  A product over 2^21 elements reads
// 128 MiB and writes 64 MiB, 0.060 ms at 3.35 TB/s; its 2^21 products of
// 136 multiply-adds (two IMAD slots each) take about half that at the
// card's IMAD rate.  ADD and SUB are bytes alone.  EQ reads 32 and writes
// 64 bytes an entry.
//
// Design: ELEMS elements a thread, BLOCK apart, computed side by side
// (fq_mul_n<ELEMS>: independent carry chains for the scheduler to
// interleave), in one pass of blocks over the table with no loop.  An
// element is 32 bytes, loaded and stored as two 16-byte vectors: a warp's
// first load covers half of each of 32 adjacent 32-byte sectors and its
// second load the other halves, so device memory moves whole sectors and
// each byte once.  An operand need not be a contiguous table: element i
// is read at a + (i / cols) * rs + (i % cols) * cs words, which takes one
// element broadcast over the table (rs = cs = 0), a table (cols = n) and
// the batched halves of a product tree's layer (a view with a row stride)
// without a copy; the division runs only where cols < n.  The output is
// contiguous, and may be a view into a larger table (the wrapper passes
// its data pointer, 16-byte aligned).
//
// ptxas (sm_90a, CUDA 12.8), registers: 34 (TO_MONT), 48 (MUL), 38-40
// (ADD, SUB, FROM_MONT), 48 (EQ); no spills.  Times: PERF.md section 6.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fq.cuh"

#define MODE_TO_MONT 0
#define MODE_MUL 1
#define MODE_ADD 2
#define MODE_SUB 3
#define MODE_FROM_MONT 4
#define MODE_EQ 5
#define BLOCK 256
#define ELEMS 2

// An operand: element i at p + (i / cols) * rs + (i % cols) * cs words.
struct operand_t {
  const uint32_t* p;
  long rs, cs;
};

static __device__ __forceinline__ const uint32_t* element(const operand_t& x,
                                                          long i, long cols,
                                                          long n) {
  if (cols >= n) return x.p + i * x.cs;
  long r = i / cols;
  return x.p + r * x.rs + (i - r * cols) * x.cs;
}

template <int MODE>
__global__ void __launch_bounds__(BLOCK)
    fq_elementwise_kernel(operand_t a, operand_t b, uint32_t* __restrict__ out,
                          long n, long cols) {
  constexpr bool BINARY = MODE == MODE_MUL || MODE == MODE_ADD ||
                          MODE == MODE_SUB || MODE == MODE_EQ;
  const long first = (long)blockIdx.x * (BLOCK * ELEMS) + threadIdx.x;
  uint32_t x[ELEMS][8], y[ELEMS][8], r[ELEMS][8];
#pragma unroll
  for (int e = 0; e < ELEMS; e++) {
    const long i = first + (long)e * BLOCK;
    if (i < n) {
      fq_load(x[e], element(a, i, cols, n));
      if constexpr (BINARY) fq_load(y[e], element(b, i, cols, n));
    } else {
#pragma unroll
      for (int j = 0; j < 8; j++) x[e][j] = y[e][j] = 0;
    }
  }
  if constexpr (MODE == MODE_TO_MONT) {
    fq_to_mont_n<ELEMS>(r, x);
  } else if constexpr (MODE == MODE_FROM_MONT) {
    fq_from_mont_n<ELEMS>(r, x);
  } else if constexpr (MODE == MODE_MUL) {
    fq_mul_n<ELEMS>(r, x, y);
  } else if constexpr (MODE == MODE_EQ) {
    fq_eq_step_n<ELEMS>(x, r, x, y);  // x becomes lo, r hi
  } else {
#pragma unroll
    for (int e = 0; e < ELEMS; e++) {
      if constexpr (MODE == MODE_ADD) fq_add(r[e], x[e], y[e]);
      else fq_sub(r[e], x[e], y[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < ELEMS; e++) {
    const long i = first + (long)e * BLOCK;
    if (i >= n) continue;
    if constexpr (MODE == MODE_EQ) {
      fq_store(out + 16 * i, x[e]);
      fq_store(out + 16 * i + 8, r[e]);
    } else {
      fq_store(out + 8 * i, r[e]);
    }
  }
}

// a, b: operands of n elements each (b unused by TO_MONT and FROM_MONT),
// element i at p + (i / cols) * rs + (i % cols) * cs words, 16-byte
// aligned; out: n elements (2n in EQ mode), contiguous, 16-byte aligned,
// overlapping neither.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown mode or cols < 1.
extern "C" int fq_elementwise_launch(const void* a, long a_rs, long a_cs,
                                     const void* b, long b_rs, long b_cs,
                                     void* out, long n, long cols, int mode,
                                     void* stream) {
  if (mode < MODE_TO_MONT || mode > MODE_EQ || cols < 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const operand_t x{(const uint32_t*)a, a_rs, a_cs};
  const operand_t y{(const uint32_t*)b, b_rs, b_cs};
  const long per = (long)BLOCK * ELEMS;
  const unsigned grid = (unsigned)((n + per - 1) / per);
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* o = (uint32_t*)out;
#define LAUNCH(MD) \
  fq_elementwise_kernel<MD><<<grid, BLOCK, 0, s>>>(x, y, o, n, cols)
  switch (mode) {
    case MODE_TO_MONT: LAUNCH(MODE_TO_MONT); break;
    case MODE_MUL: LAUNCH(MODE_MUL); break;
    case MODE_ADD: LAUNCH(MODE_ADD); break;
    case MODE_SUB: LAUNCH(MODE_SUB); break;
    case MODE_FROM_MONT: LAUNCH(MODE_FROM_MONT); break;
    default: LAUNCH(MODE_EQ); break;
  }
#undef LAUNCH
  return (int)cudaGetLastError();
}
