// One STROBE-128 step of the device transcript: absorb what is pending
// into the 200-byte sponge state, then (optionally) run keccak-f[1600].
//
// Replaces spartan_tpu/transcript/device.py:89 (keccak_f1600_device, the
// permutation as XLA ops, not a Pallas kernel) together with the absorbs
// of that file's DeviceTranscript (dynamic-update-slices of the state).
// The transcript's positions, labels and lengths are known on the host;
// only the data (scalars, compressed points, squeezed bytes) lies on the
// device.  So the host folds every constant byte of a block (labels,
// lengths, op headers, STROBE's padding) into one 200-byte mask passed by
// value, and passes each device segment as (pointer, offset, length).
// One launch a permutation: XOR the mask, XOR the segments, permute.
// With permute = 0 it only absorbs (before the state is read back).
//
// Bound on this card: latency.  The bytes are 400 and a few segments;
// the permutation is 24 dependent rounds of ~12 dependent 64-bit ALU
// steps.  Design: one warp; its lanes XOR the bytes in shared memory,
// lane 0 runs the 24 rounds on the 25 lanes in registers (keccak.cuh),
// the warp writes the state back.  A permutation spread over 25 lanes
// with shuffles would cut the chain a little but not the launch, which
// dominates.  The plain PyTorch twin is
// spartan_tpu_torch/transcript/device.py::strobe_step_plain.
#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak.cuh"

#define MAX_SEGS 16

struct mask_t {
  uint8_t b[200];
};

struct seg_t {
  const uint8_t* src;
  int dst;
  int len;
};

struct segs_t {
  seg_t s[MAX_SEGS];
  int n;
};

__global__ void strobe_step_kernel(uint8_t* __restrict__ state, mask_t mask,
                                   segs_t segs, int permute) {
  __shared__ uint64_t lanes[25];
  uint8_t* sh = reinterpret_cast<uint8_t*>(lanes);
  int t = threadIdx.x;
  for (int i = t; i < 200; i += 32) sh[i] = state[i] ^ mask.b[i];
  __syncwarp();
  for (int k = 0; k < segs.n; k++) {
    for (int i = t; i < segs.s[k].len; i += 32)
      sh[segs.s[k].dst + i] ^= segs.s[k].src[i];
    __syncwarp();
  }
  if (permute && t == 0) {
    uint64_t a[25];
#pragma unroll
    for (int i = 0; i < 25; i++) a[i] = lanes[i];
    keccak_f1600(a);
#pragma unroll
    for (int i = 0; i < 25; i++) lanes[i] = a[i];
  }
  __syncwarp();
  for (int i = t; i < 200; i += 32) state[i] = sh[i];
}

// state: 200 bytes on the device, updated in place; segs.n <= MAX_SEGS,
// each segment inside the state and none overlapping another.
extern "C" int strobe_step_launch(void* state, mask_t mask, segs_t segs,
                                  int permute, void* stream) {
  if (segs.n < 0 || segs.n > MAX_SEGS) return (int)cudaErrorInvalidValue;
  strobe_step_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (uint8_t*)state, mask, segs, permute);
  return (int)cudaGetLastError();
}
