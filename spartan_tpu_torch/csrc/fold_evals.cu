// One fused sum-check round on the device, in one launch.
//
// Replaces the TPU kernel spartan_tpu/ff/pallas_kernels.py:211
// (_fold_evals_kernel, called from _fold_evals_call at :265), whose
// dataflow is the JAX prover's round step
// spartan_tpu/protocols/sumcheck.py:103-116 (_fold_then_evals), and, in
// its batched 3-table mode, the JAX product-tree layer round
// spartan_tpu/protocols/product_tree.py:33-113 (_evals_cubic_batched,
// _bound_var_top_batched, _step3, _fold3), the same dataflow with a
// batch axis.  For ntab tables T of `batch` instances of n = 2m elements
// each (Fq, Montgomery), per instance:
//   fold:   F[j] = T[j] + r * (T[m + j] - T[j])           for j < m
//   evals:  the next round polynomial at X = 0, 2 (and 3) over the
//           pairs (F[j], F[j + m/2]): sum_j comb(lo + X (hi - lo)),
//           comb = A (B C - D) for 4 tables (phase 1), A B C for 3 (the
//           product-tree layers), A B for 2 (phase 2).
// Modes: EVALS (round 0: evals over T itself), FOLD_EVALS, FOLD (last).
// The 2- and 4-table modes run one instance (batch = 1).
//
// Bound on this card: bytes, barely.  The first phase-1 round reads
// 4 x 2^20 x 32 B and writes 4 x 2^19 x 32 B (~201 MB, ~60 us at
// 3.35 TB/s); its ~3.7M Montgomery products take about as long at the
// card's IMAD rate, so the kernel has no slack on either side.  The
// largest product-layer round, 3 tables of (18, 2^19) folded, reads
// ~906 MB and writes ~453 MB (~0.41 ms).
//
// Design: a fixed grid of BLOCKS_PER_SM blocks of 128 threads per SM
// (fewer when the round is small) strides over the pairs.  With a batch,
// each block owns one instance: the grid is batch x blocks an instance,
// as many as keep the grid to one wave, and one an instance for the
// small layers.  So a thread's accumulators belong to one instance and a
// block's partial stays one 27-word sum.  Per pair a thread reads T[j],
// T[j + m/2], T[m + j], T[m + j + m/2] of each table, writes F[j] and
// F[j + m/2] (the order the next round reads), and builds the comb
// table by table (B, C, D, then A for the cubic comb) so that only one
// table's values are live at a time; the __launch_bounds__ register cap
// (128) keeps 16 warps resident on every SM.  Each thread sums its comb
// values unreduced in three 9-word accumulators.  At the end, warp
// shuffles and one shared-memory step sum the block; each block writes
// its partial, and the last block to finish (an atomic ticket after
// __threadfence; the wrapper zeroes a ticket for each launch, so
// launches on different streams never share one) sums each instance's
// partials, a warp an instance, and reduces them mod q once, a thread an
// (instance, eval), so that the reductions run side by side.  The sums
// are exact residues, so the result does not depend on the order and equals
// fold_evals_plain bit for bit.  The field products are the carry-chain
// CIOS of fq.cuh, run side by side where they are independent (a
// table's two folds; the comb at X = 0, 2, 3), so that each warp has
// more than one chain to issue from.  The challenge r arrives in
// Montgomery form, by value from the host path or, for the device prover
// (protocols/device_prover.py), as a pointer to the 8 words the device
// transcript squeezed (a template flag: the by-value kernels are as
// they were).
//
// It replaces a first design of one thread per pair at 162-188
// registers (8 warps a SM), a shared-memory tree per block and a second
// launch to sum the blocks: 0.395 ms at (4, 2^20, fold_evals) on an H100,
// now ~0.12 ms.  There the fold-only mode runs at ~75% of its bytes
// bound and the fused mode at ~49%: its products are issue-bound (more
// chains side by side, or 8% fewer wide multiplies, did not move it).
//
// ptxas (sm_90a, CUDA 12.8, as chip_smoke.py prints it), registers:
// 4 tables 128 (fold_evals; 12 bytes spilled), 120 (evals), 96 (fold);
// 2 tables 114, 88, 62; no other spills.  Times: PERF.md section 6.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fq.cuh"

#define MODE_EVALS 0
#define MODE_FOLD_EVALS 1
#define MODE_FOLD 2
#define BLOCK 128
#define BLOCKS_PER_SM 4
#define NWARPS (BLOCK / 32)
#define INST_GROUP 32  // instances the last block reduces side by side

struct tables_t {
  const uint32_t* in[4];
  uint32_t* out[4];
};

struct fq_arg_t {
  uint32_t v[8];
};

// f[n] = a[n] + r * (b[n] - a[n]) for N independent folds, their
// products side by side
template <int N>
static __device__ __forceinline__ void fold_n(uint32_t (*f)[8],
                                              const uint32_t (*a)[8],
                                              const uint32_t (*b)[8],
                                              const fq_arg_t& r) {
  uint32_t d[N][8], rr[N][8];
#pragma unroll
  for (int n = 0; n < N; n++) {
    fq_sub(d[n], b[n], a[n]);
#pragma unroll
    for (int w = 0; w < 8; w++) rr[n][w] = r.v[w];
  }
  fq_mul_n<N>(d, rr, d);
#pragma unroll
  for (int n = 0; n < N; n++) fq_add(f[n], a[n], d[n]);
}

// Table t's pair (lo, hi) for pair j, folded first in FOLD_EVALS mode,
// as the round polynomial's factor at X = 0, 2 (and 3 when NP == 3).
// LAZY leaves the values at X = 2, 3 unreduced (< 3q), for a factor
// that only enters fq_mul as its second operand.
template <int MODE, int NP, bool LAZY>
static __device__ __forceinline__ void factor(uint32_t x[NP][8],
                                              const tables_t& tabs, int t,
                                              long j, long m,
                                              const fq_arg_t& r) {
  const uint32_t* T = tabs.in[t];
  uint32_t lo[8], hi[8];
  if constexpr (MODE == MODE_EVALS) {
    fq_load(lo, T + 8 * j);
    fq_load(hi, T + 8 * (j + m));
  } else {
    long h = m / 2;
    uint32_t a[2][8], b[2][8], f[2][8];
    fq_load(a[0], T + 8 * j);
    fq_load(a[1], T + 8 * (j + h));
    fq_load(b[0], T + 8 * (m + j));
    fq_load(b[1], T + 8 * (m + j + h));
    fold_n<2>(f, a, b, r);
    fq_store(tabs.out[t] + 8 * j, f[0]);
    fq_store(tabs.out[t] + 8 * (j + h), f[1]);
#pragma unroll
    for (int w = 0; w < 8; w++) {
      lo[w] = f[0][w];
      hi[w] = f[1][w];
    }
  }
  uint32_t d[8];
  fq_sub(d, hi, lo);
#pragma unroll
  for (int w = 0; w < 8; w++) x[0][w] = lo[w];
  if constexpr (LAZY) {
    fq_add_lazy(x[1], hi, d);  // 2 hi - lo
    if constexpr (NP == 3) fq_add_lazy(x[2], x[1], d);  // 3 hi - 2 lo
  } else {
    fq_add(x[1], hi, d);
    if constexpr (NP == 3) fq_add(x[2], x[1], d);
  }
}

// Sum the NP accumulators over the warp; lane 0 gets the totals.
template <int NP>
static __device__ __forceinline__ void warp_sum(uint32_t acc[3][9]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < NP; k++) {
      uint32_t o[9];
#pragma unroll
      for (int w = 0; w < 9; w++)
        o[w] = __shfl_down_sync(0xffffffffu, acc[k][w], off);
      fq_acc_add9(acc[k], o);
    }
  }
}

// Sum the NP accumulators over the block; thread 0 gets the totals.
template <int NP>
static __device__ __forceinline__ void block_sum(uint32_t acc[3][9],
                                                 uint32_t (*sh)[3][9]) {
  warp_sum<NP>(acc);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NP; k++)
#pragma unroll
      for (int w = 0; w < 9; w++) sh[warp][k][w] = acc[k][w];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int v = 1; v < NWARPS; v++)
#pragma unroll
      for (int k = 0; k < NP; k++) fq_acc_add9(acc[k], sh[v][k]);
  }
}

// This block's instance b and its place among the instance's blocks:
// the tables moved to instance b; returns the first pair and the stride.
static __device__ __forceinline__ void instance_of(tables_t& tabs, long n,
                                                   int batch, long* j0,
                                                   long* stride) {
  int bpi = gridDim.x / batch;
  long b = blockIdx.x / bpi;
#pragma unroll
  for (int t = 0; t < 4; t++) {
    if (tabs.in[t]) tabs.in[t] += b * n * 8;
    if (tabs.out[t]) tabs.out[t] += b * (n / 2) * 8;
  }
  *j0 = (long)(blockIdx.x % bpi) * BLOCK + threadIdx.x;
  *stride = (long)bpi * BLOCK;
}

template <int NTAB>
static __device__ __forceinline__ void fold_only(tables_t tabs, long n,
                                                 int batch,
                                                 const fq_arg_t& r) {
  long m = n / 2, j0, stride;
  instance_of(tabs, n, batch, &j0, &stride);
  for (long j = j0; j < m; j += stride) {
    uint32_t a[NTAB][8], b[NTAB][8], f[NTAB][8];
#pragma unroll
    for (int t = 0; t < NTAB; t++) {
      fq_load(a[t], tabs.in[t] + 8 * j);
      fq_load(b[t], tabs.in[t] + 8 * (m + j));
    }
    fold_n<NTAB>(f, a, b, r);
#pragma unroll
    for (int t = 0; t < NTAB; t++) fq_store(tabs.out[t] + 8 * j, f[t]);
  }
}

template <int NTAB, int MODE>
static __device__ __forceinline__ void with_evals(
    tables_t tabs, long n, int batch, const fq_arg_t& r, uint32_t* partial,
    unsigned int* ticket, uint32_t* evals) {
  constexpr int NP = NTAB == 2 ? 2 : 3;
  long m = n / 2, j0, stride;
  long count = MODE == MODE_FOLD_EVALS ? m / 2 : m;
  instance_of(tabs, n, batch, &j0, &stride);

  uint32_t acc[3][9];
#pragma unroll
  for (int k = 0; k < 3; k++)
#pragma unroll
    for (int w = 0; w < 9; w++) acc[k][w] = 0;
  for (long j = j0; j < count; j += stride) {
    uint32_t e[NP][8];
    if constexpr (NTAB == 4) {  // A * (B * C - D), table by table
      uint32_t x[NP][8];
      factor<MODE, NP, false>(e, tabs, 1, j, m, r);
      factor<MODE, NP, true>(x, tabs, 2, j, m, r);
      fq_mul_n<NP>(e, e, x);
      factor<MODE, NP, false>(x, tabs, 3, j, m, r);
#pragma unroll
      for (int k = 0; k < NP; k++) fq_sub(e[k], e[k], x[k]);
      factor<MODE, NP, true>(x, tabs, 0, j, m, r);
      fq_mul_n<NP>(e, e, x);
    } else if constexpr (NTAB == 3) {  // A * B * C
      uint32_t x[NP][8];
      factor<MODE, NP, false>(e, tabs, 0, j, m, r);
      factor<MODE, NP, true>(x, tabs, 1, j, m, r);
      fq_mul_n<NP>(e, e, x);
      factor<MODE, NP, true>(x, tabs, 2, j, m, r);
      fq_mul_n<NP>(e, e, x);
    } else {  // A * B
      uint32_t x[NP][8];
      factor<MODE, NP, false>(e, tabs, 0, j, m, r);
      factor<MODE, NP, true>(x, tabs, 1, j, m, r);
      fq_mul_n<NP>(e, e, x);
    }
#pragma unroll
    for (int k = 0; k < NP; k++) fq_acc_add(acc[k], e[k]);
  }

  __shared__ uint32_t sh[NWARPS][3][9];
  __shared__ bool last;
  block_sum<NP>(acc, sh);
  if (threadIdx.x == 0) {
    uint32_t* dst = partial + (size_t)blockIdx.x * 27;
#pragma unroll
    for (int k = 0; k < NP; k++)
#pragma unroll
      for (int w = 0; w < 9; w++) dst[k * 9 + w] = acc[k][w];
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: each warp sums one instance's partials at a time
  // (read from L2: other SMs wrote them), its lanes striding over the
  // instance's blocks; then one thread an (instance, eval) reduces mod q.
  // INST_GROUP instances at a time, so that the reductions run side by
  // side and not one after another in one thread.
  __shared__ uint32_t inst_sum[INST_GROUP][3][9];
  int bpi = gridDim.x / batch;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = 0; g < batch; g += INST_GROUP) {
    int ng = min(INST_GROUP, batch - g);
    for (int i = warp; i < ng; i += NWARPS) {
#pragma unroll
      for (int k = 0; k < 3; k++)
#pragma unroll
        for (int w = 0; w < 9; w++) acc[k][w] = 0;
      for (int p = lane; p < bpi; p += 32) {
        const uint32_t* src = partial + ((size_t)(g + i) * bpi + p) * 27;
#pragma unroll
        for (int k = 0; k < NP; k++) {
          uint32_t o[9];
#pragma unroll
          for (int w = 0; w < 9; w++) o[w] = __ldcg(src + k * 9 + w);
          fq_acc_add9(acc[k], o);
        }
      }
      warp_sum<NP>(acc);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NP; k++)
#pragma unroll
          for (int w = 0; w < 9; w++) inst_sum[i][k][w] = acc[k][w];
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < 3 * ng; t += BLOCK) {
      int i = t % ng, k = t / ng;
      uint32_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (k < NP) fq_reduce_wide(v, inst_sum[i][k]);
      fq_store(evals + ((size_t)k * batch + g + i) * 8, v);
    }
    __syncthreads();  // inst_sum is reused
  }
}

template <int NTAB, int MODE>
static __device__ __forceinline__ void round_body(
    const tables_t& tabs, long n, int batch, const fq_arg_t& r,
    uint32_t* partial, unsigned int* ticket, uint32_t* evals) {
  if constexpr (MODE == MODE_FOLD)
    fold_only<NTAB>(tabs, n, batch, r);
  else
    with_evals<NTAB, MODE>(tabs, n, batch, r, partial, ticket, evals);
}

// n: size of each instance's input tables; batch: instances, a divisor
// of gridDim.x.  FOLD: pairs j < n/2 (no evals).  EVALS: pairs j < n/2.
// FOLD_EVALS: pairs j < n/4.  r: the challenge by value, or, when RDEV,
// read from rdev (8 words on the device: a challenge the device
// transcript squeezed, which the host never sees).  partial: (gridDim.x,
// 3, 9) block sums; ticket: a counter, zero at the launch and this
// launch's own; evals: (3, batch, 8) canonical Montgomery residues.
template <int NTAB, int MODE, bool RDEV>
__global__ void __launch_bounds__(BLOCK, BLOCKS_PER_SM)
    fold_evals_kernel(tables_t tabs, long n, int batch, fq_arg_t r,
                      const uint32_t* __restrict__ rdev,
                      uint32_t* __restrict__ partial,
                      unsigned int* __restrict__ ticket,
                      uint32_t* __restrict__ evals) {
  if constexpr (RDEV) {
    fq_arg_t rv;
#pragma unroll
    for (int w = 0; w < 8; w++) rv.v[w] = __ldg(rdev + w);
    round_body<NTAB, MODE>(tabs, n, batch, rv, partial, ticket, evals);
  } else {
    round_body<NTAB, MODE>(tabs, n, batch, r, partial, ticket, evals);
  }
}

// in/out: ntab table pointers each (unused slots are null), each
// (batch, n) elements in, (batch, n/2) out.  nblocks: a multiple of
// batch.  rdev: null for the challenge r by value, else its 8 words on
// the device.  partial: scratch of nblocks * 27 words; ticket: one zeroed
// word that no other launch in flight shares; evals: (3, batch, 8)
// output.  FOLD mode writes neither partial nor evals.
extern "C" int fold_evals_launch(const void* in0, const void* in1,
                                 const void* in2, const void* in3,
                                 void* out0, void* out1, void* out2,
                                 void* out3, int ntab, long n, int batch,
                                 int mode, fq_arg_t r, const void* rdev,
                                 int nblocks, void* partial, void* ticket,
                                 void* evals, void* stream) {
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
  const uint32_t* rd = (const uint32_t*)rdev;
  uint32_t* part = (uint32_t*)partial;
  unsigned int* tk = (unsigned int*)ticket;
  uint32_t* ev = (uint32_t*)evals;
#define LAUNCH(NT, MD, RD)                                                \
  fold_evals_kernel<NT, MD, RD><<<nblocks, BLOCK, 0, s>>>(tabs, n, batch, \
                                                          r, rd, part, tk, ev)
#define LAUNCH_R(NT, MD)       \
  if (rd) LAUNCH(NT, MD, true); \
  else LAUNCH(NT, MD, false)
  if (ntab == 4) {
    if (mode == MODE_EVALS) LAUNCH(4, MODE_EVALS, false);
    else if (mode == MODE_FOLD_EVALS) { LAUNCH_R(4, MODE_FOLD_EVALS); }
    else { LAUNCH_R(4, MODE_FOLD); }
  } else if (ntab == 3) {
    if (mode == MODE_EVALS) LAUNCH(3, MODE_EVALS, false);
    else if (mode == MODE_FOLD_EVALS) { LAUNCH_R(3, MODE_FOLD_EVALS); }
    else { LAUNCH_R(3, MODE_FOLD); }
  } else {
    if (mode == MODE_EVALS) LAUNCH(2, MODE_EVALS, false);
    else if (mode == MODE_FOLD_EVALS) { LAUNCH_R(2, MODE_FOLD_EVALS); }
    else { LAUNCH_R(2, MODE_FOLD); }
  }
#undef LAUNCH_R
#undef LAUNCH
  return (int)cudaGetLastError();
}
