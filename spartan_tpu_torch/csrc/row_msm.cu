// Row-MSM on ed25519: out[l] = sum_i s[l, i] * G_i for l < L.
//
// Replaces the TPU kernel spartan_tpu/curve/pallas_msm.py:275
// (_msm_window_kernel, called from _msm_windows_pallas at :359) and its
// XLA tail (_msm_tail, :455).  Same function: 4-bit windows over a
// table tab[d][i] = d * G_i of the generators' multiples, a sum per
// (row, window), then a Horner combine over the 64 windows.
//
// Bound on this card: operations.  At L = R = 1024 the window sums are
// 64 * L * R = 67M point adds.  With a table in the precomputed form
// (y+x, y-x, 2d*x*y, Z = 1) each is a mixed add of 7 field products
// (~1,000 32-bit multiply-adds); this table keeps extended (X, Y, Z, T)
// points, so each add here is a unified add of 9.  The bytes (scalars
// 32 MB, table 2 MB, output 128 kB) take ~10 us at 3.35 TB/s.
//
// Design (simple and exact, not yet fast): one thread per (row, window)
// walks the R generators in order, looks up its digit's table entry
// (a gather: cheap on this card, unlike the TPU's select tree) and adds
// it; the whole table (16 * R * 128 B) stays in L2.  A second kernel runs
// one thread per row for the Horner combine (4 doublings and one add per
// window) and canonicalises.  Both keep the coordinates lazy (< 2^256).
// The plain PyTorch twin (spartan_tpu_torch/curve/row_msm.py) performs
// the same point operations in the same order, so the canonical
// coordinates agree bit for bit.  A bucket (Pippenger) redesign is later
// work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp25519.cuh"

// scalars: (L, R, 8) canonical; tab: (16, R, 4, 8); win: (L, 64, 4, 8)
__global__ void msm_windows_kernel(const uint32_t* __restrict__ scalars,
                                   const uint32_t* __restrict__ tab,
                                   uint32_t* __restrict__ win, int L, int R) {
  int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= L * 64) return;
  int l = tid >> 6, w = tid & 63;
  int word = w >> 3, shift = (w & 7) * 4;
  const uint32_t* srow = scalars + (size_t)l * R * 8 + word;
  ge_t acc, p;
  ge_identity(acc);
  // the loop bodies are whole point operations: unrolling them only
  // multiplies the code ptxas has to schedule
#pragma unroll 1
  for (int i = 0; i < R; i++) {
    uint32_t d = (srow[(size_t)i * 8] >> shift) & 15u;
    ge_load(p, tab + ((size_t)d * R + i) * 32);
    ge_add(acc, acc, p);
  }
  ge_store(win + (size_t)tid * 32, acc);
}

// win: (L, 64, 4, 8) lazy window sums -> out: (L, 4, 8) canonical
__global__ void msm_horner_kernel(const uint32_t* __restrict__ win,
                                  uint32_t* __restrict__ out, int L) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const uint32_t* base = win + (size_t)l * 64 * 32;
  ge_t acc, p;
  ge_load(acc, base + 63 * 32);
#pragma unroll 1
  for (int w = 62; w >= 0; w--) {
#pragma unroll 1
    for (int k = 0; k < 4; k++) ge_dbl(acc, acc);
    ge_load(p, base + w * 32);
    ge_add(acc, acc, p);
  }
  fp_canon(acc.x);
  fp_canon(acc.y);
  fp_canon(acc.z);
  fp_canon(acc.t);
  ge_store(out + (size_t)l * 32, acc);
}

extern "C" int row_msm_launch(const void* scalars, const void* tab,
                              void* win, void* out, int L, int R,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int bs = 128;
  int n = L * 64;
  msm_windows_kernel<<<(n + bs - 1) / bs, bs, 0, s>>>(
      (const uint32_t*)scalars, (const uint32_t*)tab, (uint32_t*)win, L, R);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  msm_horner_kernel<<<(L + bs - 1) / bs, bs, 0, s>>>(
      (const uint32_t*)win, (uint32_t*)out, L);
  return (int)cudaGetLastError();
}
