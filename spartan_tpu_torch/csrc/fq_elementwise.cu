// Elementwise maps of Fq tables on the device: out[i] = f(a[i]) over an
// (n, 8) storage table (spartan_tpu_torch/ff/limb.py), one launch a map.
//
// Replaces no TPU kernel: the JAX package runs its limb arithmetic in XLA
// (the Montgomery map of an uploaded table: spartan_tpu/poly/dense.py:134,
// fq.to_mont on the device).  The plain PyTorch twin is
// spartan_tpu_torch/ff/fq.py, whose wrappers launch this file's modes for
// tensors on the card.  Modes:
//   TO_MONT: out[i] = a[i] * R mod q (fq_to_mont_n: one CIOS product by
//            R^2), canonical for any a[i] < 2^256.  The prover's witness
//            goes up as canonical bytes and is mapped here, straight into
//            its slice of z; Spark's integer tables too.
//
// Bound on this card: bytes, barely.  At 2^20 elements the map reads 32 MiB
// and writes 32 MiB, 0.020 ms at 3.35 TB/s; its 2^20 products of 136
// multiply-adds (two IMAD slots each) take 0.017 ms at the card's IMAD
// rate.
//
// Design: ELEMS elements a thread, BLOCK apart, mapped side by side
// (fq_to_mont_n<ELEMS>: independent carry chains for the scheduler to
// interleave), in one pass of blocks over the table with no loop.  An
// element is 32 bytes, loaded and stored as two 16-byte vectors: a warp's
// first load covers half of each of 32 adjacent 32-byte sectors and its
// second load the other halves, so device memory moves whole sectors
// and each byte once.  The output may be a view into a larger table (the
// wrapper passes its data pointer, 16-byte aligned).
#include <cuda_runtime.h>
#include <stdint.h>

#include "fq.cuh"

#define MODE_TO_MONT 0
#define BLOCK 256
#define ELEMS 2

template <int MODE>
__global__ void __launch_bounds__(BLOCK)
    fq_elementwise_kernel(const uint32_t* __restrict__ a,
                          uint32_t* __restrict__ out, long n) {
  const long first = (long)blockIdx.x * (BLOCK * ELEMS) + threadIdx.x;
  uint32_t x[ELEMS][8], r[ELEMS][8];
#pragma unroll
  for (int e = 0; e < ELEMS; e++) {
    const long i = first + (long)e * BLOCK;
    if (i < n) {
      fq_load(x[e], a + 8 * i);
    } else {
#pragma unroll
      for (int j = 0; j < 8; j++) x[e][j] = 0;
    }
  }
  if constexpr (MODE == MODE_TO_MONT) fq_to_mont_n<ELEMS>(r, x);
#pragma unroll
  for (int e = 0; e < ELEMS; e++) {
    const long i = first + (long)e * BLOCK;
    if (i < n) fq_store(out + 8 * i, r[e]);
  }
}

// a, out: n elements (8 words each), 16-byte aligned; out may not overlap
// a.  mode: MODE_TO_MONT.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown mode.
extern "C" int fq_elementwise_launch(const void* a, void* out, long n,
                                     int mode, void* stream) {
  if (mode != MODE_TO_MONT) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const long per = (long)BLOCK * ELEMS;
  fq_elementwise_kernel<MODE_TO_MONT>
      <<<(unsigned)((n + per - 1) / per), BLOCK, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)a, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
