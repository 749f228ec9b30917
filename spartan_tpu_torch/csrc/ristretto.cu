// Batched ristretto255 ENCODE of extended points: out[k] = the 32-byte
// encoding s of point k, as 8 little-endian words.
//
// Replaces spartan_tpu/curve/ristretto.py:26 (compress, XLA ops, not a
// Pallas kernel): the bullet rounds and the dot-product-log compress
// their Pedersen commitments on the card, so one fetch brings their
// encodings to the host transcript.
//
// Bound on this card: operations.  One encode is 284 field products (the
// inverse square root's 251 squarings and 11 products, 22 more around
// it), 72 wide 32-bit multiply-adds each; the bytes (128 in, 32 out a
// point) are nothing beside them.  But the path's launches hold 1 or 2
// points, so the time is the chain of 284 dependent products, far above
// the bound, and the design shortens each product's latency:
// a group of 8 lanes takes a point and spreads every product over its
// lanes (fp25519_group.cuh), lane k computing word k.  Lanes past the
// last point work on the last point and store nothing, so every lane of
// a warp takes part in the group's shuffles.  The plain
// PyTorch twin is spartan_tpu_torch/curve/ristretto.py::compress_plain.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ristretto.cuh"

#define BLOCK 128

// pts: (k, 4, 8) extended coordinates (any values < 2^256); out: (k, 8)
__global__ void __launch_bounds__(BLOCK)
    ristretto_encode_kernel(const uint32_t* __restrict__ pts,
                            uint32_t* __restrict__ out, int k) {
  int t = blockIdx.x * BLOCK + threadIdx.x;
  int i = t / G_LANES;
  ge_t p;
  ge_load(p, pts + (size_t)(i < k ? i : k - 1) * 32);
  uint32_t s[8];
  ristretto_encode(s, p);
  if (i < k && (t & (G_LANES - 1)) == 0) {
    uint4* o = reinterpret_cast<uint4*>(out + (size_t)i * 8);
    o[0] = make_uint4(s[0], s[1], s[2], s[3]);
    o[1] = make_uint4(s[4], s[5], s[6], s[7]);
  }
}

// one group's dependent chain of `steps` products x = x * y (square:
// x = x * x), a warp of 4 groups alike; xy: x in words 0..7, y in 8..15,
// the chain's end back in 0..7.  chip_smoke.py times it: the latency of
// a product and of a squaring on the group, the unit of K4's chain floor
__global__ void g_mul_chain_kernel(uint32_t* __restrict__ xy, int steps,
                                   int square) {
  uint32_t x[8], y[8];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    x[j] = xy[j];
    y[j] = xy[8 + j];
  }
  if (square)
    for (int i = 0; i < steps; i++) g_mul(x, x, x);
  else
    for (int i = 0; i < steps; i++) g_mul(x, x, y);
  if (threadIdx.x == 0)
#pragma unroll
    for (int j = 0; j < 8; j++) xy[j] = x[j];
}

__global__ void empty_kernel() {}

extern "C" int ristretto_encode_launch(const void* pts, void* out, int k,
                                       void* stream) {
  if (k <= 0) return 0;
  if (k > (1 << 26)) return (int)cudaErrorInvalidValue;
  int threads = k * G_LANES;
  ristretto_encode_kernel<<<(threads + BLOCK - 1) / BLOCK, BLOCK, 0,
                            (cudaStream_t)stream>>>((const uint32_t*)pts,
                                                    (uint32_t*)out, k);
  return (int)cudaGetLastError();
}

extern "C" int g_mul_chain_launch(void* xy, int steps, int square,
                                  void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  g_mul_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((uint32_t*)xy,
                                                          steps, square);
  return (int)cudaGetLastError();
}

// an empty kernel: the floor of one launch
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
