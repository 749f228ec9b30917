// Batched ristretto255 ENCODE of extended points: out[k] = the 32-byte
// encoding s of point k, as 8 little-endian words.
//
// Replaces spartan_tpu/curve/ristretto.py:26 (compress, XLA ops, not a
// Pallas kernel): the device prover compresses every Pedersen commitment
// of a ZK round on the card, so the transcript can absorb it with no
// fetch.
//
// Bound on this card: operations.  One encode is ~280 field products
// (the inverse square root's 251 squarings and 11 products, ~20 more
// around it), ~72 wide 32-bit multiply-adds each; the bytes (128 in,
// 32 out a point) are nothing beside them.  A ZK round encodes 1 or 2
// points a launch, so there the launch's latency is the time: one
// thread runs its point's ~280 dependent products in a row.
// Design: one thread a point (ristretto.cuh on fp25519.cuh's carry
// chains), 128 threads a block; the square-and-multiply chain is ref10's
// pow22523.  The plain PyTorch twin is
// spartan_tpu_torch/curve/ristretto.py::compress_plain.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ristretto.cuh"

#define BLOCK 128

// pts: (k, 4, 8) extended coordinates (any values < 2^256); out: (k, 8)
__global__ void __launch_bounds__(BLOCK)
    ristretto_encode_kernel(const uint32_t* __restrict__ pts,
                            uint32_t* __restrict__ out, int k) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= k) return;
  ge_t p;
  ge_load(p, pts + (size_t)i * 32);
  uint32_t s[8];
  ristretto_encode(s, p);
#pragma unroll
  for (int j = 0; j < 8; j++) out[(size_t)i * 8 + j] = s[j];
}

extern "C" int ristretto_encode_launch(const void* pts, void* out, int k,
                                       void* stream) {
  if (k <= 0) return 0;
  ristretto_encode_kernel<<<(k + BLOCK - 1) / BLOCK, BLOCK, 0,
                            (cudaStream_t)stream>>>((const uint32_t*)pts,
                                                    (uint32_t*)out, k);
  return (int)cudaGetLastError();
}
