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
// the permutation is 24 dependent rounds of a few dependent 64-bit ALU
// steps.  Design: one warp, one Keccak lane a warp lane (keccak.cuh), so
// a round is three rounds of shuffles and a few ALU steps a lane.  Lane t
// builds its word from its 8 state bytes, its word of the mask and the
// bytes of the segments that fall on them: a scan of the segments by
// compares finds each byte's source (the segments do not overlap, so a
// byte takes at most one segment byte), then its 16 loads go out together;
// it runs the rounds and writes its 8 bytes back.  No shared memory, no
// sync.  The plain PyTorch twin is
// spartan_tpu_torch/transcript/device.py::strobe_step_plain.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "keccak.cuh"

#define MAX_SEGS 16

struct mask_t {
  uint8_t b[200];
};

// the same 200 bytes as 25 little-endian words
struct mask_words_t {
  uint64_t w[25];
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

__global__ void __launch_bounds__(32)
    strobe_step_kernel(uint8_t* __restrict__ state, mask_words_t mask,
                       segs_t segs, int permute) {
  int t = threadIdx.x, l = t < 25 ? t : t - 25, base = 8 * l;
  // for each of lane l's 8 bytes, the segment byte that falls on it (the
  // segments do not overlap): found by compares alone, so that the loads
  // below are issued together
  const uint8_t* src[8];
  bool hit[8];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    src[j] = state;
    hit[j] = false;
  }
  for (int k = 0; k < segs.n; k++) {
    int i0 = base - segs.s[k].dst, n = segs.s[k].len;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      bool in = (unsigned)(i0 + j) < (unsigned)n;
      src[j] = in ? segs.s[k].src + i0 + j : src[j];
      hit[j] |= in;
    }
  }
  uint64_t w = mask.w[l];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    uint8_t x = state[base + j];
    if (hit[j]) x ^= *src[j];
    w ^= (uint64_t)x << (8 * j);
  }
  klane a;
  a.v[0] = w;
  if (permute) keccak_f1600_lanes(a);
  if (t < 25)
#pragma unroll
    for (int j = 0; j < 8; j++) state[base + j] = (uint8_t)(a.v[0] >> (8 * j));
}

// state: 200 bytes on the device, updated in place; segs.n <= MAX_SEGS,
// each segment inside the state and none overlapping another.
extern "C" int strobe_step_launch(void* state, mask_t mask, segs_t segs,
                                  int permute, void* stream) {
  if (segs.n < 0 || segs.n > MAX_SEGS) return (int)cudaErrorInvalidValue;
  mask_words_t m;
  memcpy(&m, &mask, sizeof m);
  strobe_step_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (uint8_t*)state, m, segs, permute);
  return (int)cudaGetLastError();
}
