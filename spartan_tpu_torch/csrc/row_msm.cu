// Row-MSM on ed25519: out[l] = sum_i s[l, i] * G_i for l < L.
//
// Replaces the TPU kernel spartan_tpu/curve/pallas_msm.py:275
// (_msm_window_kernel, called from _msm_windows_pallas at :359) and its
// XLA tail (_msm_tail, :455).  Same function: 4-bit windows over a
// table of the generators' multiples, a sum per (row, window), then a
// Horner combine over the 64 windows.
//
// Bound on this card: operations.  At L = R = 1024 the window sums need
// one point add per non-zero digit: ~59 of a canonical scalar's 64
// (the top window's digit is almost always 0, the others are 0 one time
// in 16), ~62M mixed adds of 7 field products (~1,000 32-bit
// multiply-adds each) against the table's precomputed form; the Horner
// combine adds up to 252 doublings and 63 unified adds a row.  This
// kernel adds every digit, zero ones included (the identity entry).
// The bytes (scalars 32 MB, table 1.5 MB, output 128 kB) take ~10 us
// at 3.35 TB/s.
//
// Design:
// - The table holds tab[d][i] = d * G_i in the precomputed affine form
//   (y+x, y-x, 2d*x*y), Z = 1, 96 B an entry (commitments.build_table),
//   so each window add is ge_madd: 7 products, not the unified add's 9.
// - msm_windows_kernel: one thread per (row l, segment s, window w),
//   128 registers at most, so 16 warps stay resident on each SM.
//   The R generators are cut into S segments of R/S (S from the wrapper:
//   1 at the commitment's 1024 x 1024, up to 64 when L is small, so the
//   one-row path still has thousands of threads).  A thread walks its
//   segment in order; the next generator's table entry (an L2 gather:
//   the table stays resident) and the scalar word after it are loaded
//   while the current add runs, so the gather latency hides behind
//   ~1,400 instructions of arithmetic.  Scalar words are shared by the
//   8 windows of a word and the 32 lanes of a warp read 4 neighbouring
//   words.  No atomics: the order of additions is fixed.
// - msm_tree_kernel (S > 1): one thread per (row, window) adds the S
//   segment sums in a fixed halving tree (slot j += slot j + half), as
//   the TPU kernel's lane halving tree did (pallas_msm.py:341-348).
// - msm_horner_kernel: 4 doublings and one unified add per window, top
//   window first; canonical output.  Each row is one serial chain of
//   point operations, so a row gets a quad of 4 lanes: every formula
//   stage has 4 independent products, one a lane, and shuffles give
//   all 4 lanes the results (critical path 2 products a doubling and 3
//   an add, not 8 and 9).  On an H100 at 1024 x 1024, one thread a row
//   took 0.83 of 7.77 ms (11%); a quad takes 0.36 ms (5%).
// - Field products are the carry-chain forms of fp25519.cuh: each
//   64-bit product's halves sit next to each other in one chain, which
//   ptxas fuses into one IMAD.WIDE.U32(.X).
// The plain PyTorch twin (spartan_tpu_torch/curve/row_msm.py) performs
// the same point operations in the same order, so the canonical
// coordinates agree bit for bit.
//
// ptxas (sm_90a, CUDA 12.8, as chip_smoke.py prints it): windows 126
// registers (capped at 128 for 4 blocks, 16 warps, a SM), tree 128,
// Horner 66; no spills.  Times on the H100: PERF.md section 6.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp25519.cuh"

#define ENTRY_WORDS 24  // (y+x, y-x, 2dxy) x 8 words
#define WIN_BLOCK 128
#define HORNER_BLOCK 64

// scalars: (L, R, 8) canonical; tab: (16, R, 3, 8); part: (L, S, 64, 4, 8)
__global__ void __launch_bounds__(WIN_BLOCK, 4)
    msm_windows_kernel(const uint32_t* __restrict__ scalars,
                       const uint32_t* __restrict__ tab,
                       uint32_t* __restrict__ part, int L, int R, int S) {
  int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= L * S * 64) return;
  int w = tid & 63, ls = tid >> 6;
  int s = ls % S, l = ls / S;
  int seg = R / S, i0 = s * seg;
  int shift = (w & 7) * 4;
  const uint32_t* sp = scalars + ((size_t)l * R + i0) * 8 + (w >> 3);
  const uint32_t* tp = tab + (size_t)i0 * ENTRY_WORDS;
  size_t dstride = (size_t)R * ENTRY_WORDS;

  ge_t acc;
  ge_identity(acc);
  ge_pre_t cur, nxt;
  uint32_t d = (__ldg(sp) >> shift) & 15u;
  ge_pre_load(cur, tp + d * dstride);
  uint32_t word = __ldg(sp + (seg > 1 ? 8 : 0));
  // the loop body is a whole point operation: unrolling it only
  // multiplies the code ptxas has to schedule
#pragma unroll 1
  for (int k = 0; k < seg; k++) {
    // prefetch: entry k + 1 and scalar word k + 2 (clamped at the end)
    int k1 = k + 1 < seg ? k + 1 : k;
    int k2 = k + 2 < seg ? k + 2 : seg - 1;
    d = (word >> shift) & 15u;
    ge_pre_load(nxt, tp + d * dstride + (size_t)k1 * ENTRY_WORDS);
    word = __ldg(sp + (size_t)k2 * 8);
    ge_madd(acc, acc, cur);
    cur = nxt;
  }
  ge_store(part + (size_t)tid * 32, acc);
}

// part: (L, S, 64, 4, 8); slot s = 0 gets the sum over s, by halving
__global__ void __launch_bounds__(64)
    msm_tree_kernel(uint32_t* __restrict__ part, int L, int S) {
  int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= L * 64) return;
  int l = tid >> 6, w = tid & 63;
  uint32_t* base = part + ((size_t)l * S * 64 + w) * 32;
  ge_t a, b;
#pragma unroll 1
  for (int half = S / 2; half > 0; half >>= 1) {
#pragma unroll 1
    for (int j = 0; j < half; j++) {
      ge_load(a, base + (size_t)j * 64 * 32);
      ge_load(b, base + (size_t)(j + half) * 64 * 32);
      ge_add(a, a, b);
      ge_store(base + (size_t)j * 64 * 32, a);
    }
  }
}

// The Horner combine is one serial chain of point operations per row, so
// a row gets a quad of 4 lanes: each stage of a formula has 4 independent
// products, one a lane, and shuffles hand every lane all four results.
// The lanes hold the same point throughout.

// r = lane src's v, within the quad
static __device__ __forceinline__ void quad_get(uint32_t r[8],
                                                const uint32_t v[8],
                                                int src) {
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = __shfl_sync(0xffffffffu, v[j], src, 4);
}

// r = (a, b, c, d)[k], without branches
static __device__ __forceinline__ void sel4(uint32_t r[8], int k,
                                            const uint32_t a[8],
                                            const uint32_t b[8],
                                            const uint32_t c[8],
                                            const uint32_t d[8]) {
#pragma unroll
  for (int j = 0; j < 8; j++)
    r[j] = k == 0 ? a[j] : k == 1 ? b[j] : k == 2 ? c[j] : d[j];
}

// the last stage shared by both formulas: (X, Y, Z, T) = (EF, GH, FG, EH)
static __device__ __forceinline__ void quad_efgh(ge_t& r, int k,
                                                 const uint32_t e[8],
                                                 const uint32_t f[8],
                                                 const uint32_t g[8],
                                                 const uint32_t h[8]) {
  uint32_t x1[8], x2[8], v[8];
  sel4(x1, k, e, g, f, e);
  sel4(x2, k, f, h, g, h);
  fp_mul(v, x1, x2);
  quad_get(r.x, v, 0);
  quad_get(r.y, v, 1);
  quad_get(r.z, v, 2);
  quad_get(r.t, v, 3);
}

// ge_dbl's field values: lanes square X, Y, Z, X + Y
static __device__ __forceinline__ void quad_dbl(ge_t& p, int k) {
  const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  uint32_t s[8], v[8], a[8], b[8], c[8], u[8], d[8], e[8], f[8], g[8], h[8];
  fp_add(s, p.x, p.y);
  sel4(u, k, p.x, p.y, p.z, s);
  fp_mul(v, u, u);
  quad_get(a, v, 0);
  quad_get(b, v, 1);
  quad_get(c, v, 2);
  quad_get(u, v, 3);
  fp_add(c, c, c);
  fp_sub(d, zero, a);
  fp_sub(e, u, a);
  fp_sub(e, e, b);
  fp_add(g, d, b);
  fp_sub(f, g, c);
  fp_sub(h, d, b);
  quad_efgh(p, k, e, f, g, h);
}

// ge_add's field values (p += q): lanes form (Y1-X1)(Y2-X2),
// (Y1+X1)(Y2+X2), T1 T2 and Z1 Z2; every lane then takes T1 T2 times 2d
static __device__ __forceinline__ void quad_add(ge_t& p, const ge_t& q,
                                                int k) {
  uint32_t s1[8], s2[8], t1[8], t2[8], l1[8], l2[8], v[8];
  uint32_t a[8], b[8], c[8], d[8], e[8], f[8], g[8], h[8];
  fp_sub(s1, p.y, p.x);
  fp_add(t1, p.y, p.x);
  fp_sub(s2, q.y, q.x);
  fp_add(t2, q.y, q.x);
  sel4(l1, k, s1, t1, p.t, p.z);
  sel4(l2, k, s2, t2, q.t, q.z);
  fp_mul(v, l1, l2);
  quad_get(a, v, 0);
  quad_get(b, v, 1);
  quad_get(c, v, 2);
  quad_get(d, v, 3);
  fp_mul(c, c, FP_D2);
  fp_add(d, d, d);
  fp_sub(e, b, a);
  fp_sub(f, d, c);
  fp_add(g, d, c);
  fp_add(h, b, a);
  quad_efgh(p, k, e, f, g, h);
}

// part: (L, S, 64, 4, 8) lazy window sums in slot 0 -> out: (L, 4, 8)
// canonical.  4 lanes a row (the last warp's spare quads repeat row L-1
// and store nothing).
__global__ void __launch_bounds__(HORNER_BLOCK)
    msm_horner_kernel(const uint32_t* __restrict__ part,
                      uint32_t* __restrict__ out, int L, int S) {
  int tid = blockIdx.x * blockDim.x + threadIdx.x;
  int l = tid >> 2, k = tid & 3;
  int row = l < L ? l : L - 1;
  const uint32_t* base = part + (size_t)row * S * 64 * 32;
  ge_t acc, p;
  ge_load(acc, base + 63 * 32);
#pragma unroll 1
  for (int w = 62; w >= 0; w--) {
#pragma unroll 1
    for (int n = 0; n < 4; n++) quad_dbl(acc, k);
    ge_load(p, base + w * 32);
    quad_add(acc, p, k);
  }
  if (l >= L || k != 0) return;
  fp_canon(acc.x);
  fp_canon(acc.y);
  fp_canon(acc.z);
  fp_canon(acc.t);
  ge_store(out + (size_t)l * 32, acc);
}

static int launch_windows(const void* scalars, const void* tab, void* part,
                          int L, int R, int S, cudaStream_t s) {
  int n = L * S * 64;
  msm_windows_kernel<<<(n + WIN_BLOCK - 1) / WIN_BLOCK, WIN_BLOCK, 0, s>>>(
      (const uint32_t*)scalars, (const uint32_t*)tab, (uint32_t*)part, L, R,
      S);
  return (int)cudaGetLastError();
}

// the tree (S > 1) and the Horner combine
static int launch_combine(void* part, void* out, int L, int S,
                          cudaStream_t s) {
  if (S > 1) {
    msm_tree_kernel<<<(L * 64 + 63) / 64, 64, 0, s>>>((uint32_t*)part, L, S);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  int n = 4 * L;
  msm_horner_kernel<<<(n + HORNER_BLOCK - 1) / HORNER_BLOCK, HORNER_BLOCK, 0,
                      s>>>((const uint32_t*)part, (uint32_t*)out, L, S);
  return (int)cudaGetLastError();
}

// scalars: (L, R, 8); tab: (16, R, 3, 8); part: scratch (L, S, 64, 4, 8);
// out: (L, 4, 8)
extern "C" int row_msm_launch(const void* scalars, const void* tab,
                              void* part, void* out, int L, int R, int S,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int e = launch_windows(scalars, tab, part, L, R, S, s);
  return e ? e : launch_combine(part, out, L, S, s);
}

// The same MSM, with the device time of each stage in ms[0] (window sums)
// and ms[1] (combine), read from events around each; it waits for the
// stream.  For measurement only: the wrapper never calls it.
extern "C" int row_msm_stage_ms(const void* scalars, const void* tab,
                                void* part, void* out, int L, int R, int S,
                                void* stream, float* ms) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaEvent_t ev[3];
  for (int k = 0; k < 3; k++) cudaEventCreate(&ev[k]);
  cudaEventRecord(ev[0], s);
  int e = launch_windows(scalars, tab, part, L, R, S, s);
  cudaEventRecord(ev[1], s);
  if (!e) e = launch_combine(part, out, L, S, s);
  cudaEventRecord(ev[2], s);
  if (!e) e = (int)cudaEventSynchronize(ev[2]);
  if (!e) e = (int)cudaEventElapsedTime(&ms[0], ev[0], ev[1]);
  if (!e) e = (int)cudaEventElapsedTime(&ms[1], ev[1], ev[2]);
  for (int k = 0; k < 3; k++) cudaEventDestroy(ev[k]);
  return e;
}
