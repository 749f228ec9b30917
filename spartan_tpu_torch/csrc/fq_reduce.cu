// Weighted sums of Fq tables on the device (kernel K8):
//   out[o, k] = sum_i a[o, i, k] * w[i]   (Montgomery products, mod q)
// or, without w, out[o, k] = sum_i a[o, i, k] mod q.
//
// Replaces no TPU kernel: the JAX package runs these sums in XLA
// (spartan_tpu/ff/fq.py's dot and sum over limb tables).  The plain
// PyTorch twin is spartan_tpu_torch/ff/fq.py (dot_mod_plain,
// sum_mod_plain), whose dot_mod and sum_mod launch this kernel for
// tensors on the card.  The one form covers a matrix's row combination
// (o = 1, a sum over rows: dense.bound_L), a batch of polynomials
// evaluated at one point (k = 1: Spark's batched evaluations,
// dense.evaluate), the dot-product circuits' sums (no w) and the device
// prover's.
//
// Bound on this card: bytes, barely.  a is read once (32 bytes an
// element; w and the partials are small beside it): bound_L over 2^24
// entries reads 512 MiB, 0.160 ms at 3.35 TB/s; its 2^24 products of 136
// multiply-adds (two IMAD slots each) take about as long at the card's
// IMAD rate.  A plain sum is bytes alone.
//
// Design: a block owns KT consecutive columns k of one o and a range of
// i; its BLOCK threads are RT = BLOCK / KT rows of KT lanes, so that a
// warp reads KT adjacent elements of one row (k-major, as a is laid out)
// or, for k = 1, 32 consecutive i.  Each thread steps over its rows
// ELEMS at a time, their products side by side (fq_acc_mul_n), and sums
// them unreduced in a 9-word accumulator (fq.cuh: below 2^288 for up to
// 2^35 products).  A shared-memory tree sums the block's rows, so each
// column has one 9-word partial a block.  With one block a column the
// block reduces mod q at once (fq_reduce_wide); otherwise each block
// writes its partials, and the last of a column group's blocks to finish
// (an atomic ticket after __threadfence, one ticket a group, zeroed by
// the wrapper for each launch) sums them through the same tree and
// reduces once.  Sums of residues are exact, so the result does not
// depend on the order and equals the plain version bit for bit.  Operand
// strides are free (any view that flattens to (o, i, k) reads without a
// copy).
//
// ptxas (sm_90a, CUDA 12.8), registers: 74 weighted, 44 plain; 9,217
// bytes of shared memory; no spills.  Times: PERF.md section 6.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fq.cuh"

#define BLOCK 256
#define ELEMS 2

struct table_t {
  const uint32_t* p;
  long so, si, sk;  // strides in words
  long O, I, K;
};

// The block's rows summed into row 0 (threads ii == 0 hold the column
// sums); sh is the block's scratch, word-major.
static __device__ __forceinline__ void tree_sum(uint32_t acc[9],
                                                uint32_t (*sh)[BLOCK],
                                                int kt_log) {
  const int t = threadIdx.x, ii = t >> kt_log;
#pragma unroll
  for (int w = 0; w < 9; w++) sh[w][t] = acc[w];
  for (int st = (BLOCK >> kt_log) >> 1; st > 0; st >>= 1) {
    __syncthreads();
    if (ii < st) {
      uint32_t o[9];
#pragma unroll
      for (int w = 0; w < 9; w++) o[w] = sh[w][t + (st << kt_log)];
      fq_acc_add9(acc, o);
#pragma unroll
      for (int w = 0; w < 9; w++) sh[w][t] = acc[w];
    }
  }
  __syncthreads();
}

template <bool WEIGHTED>
__global__ void __launch_bounds__(BLOCK)
    fq_reduce_kernel(table_t a, const uint32_t* __restrict__ w, long ws,
                     uint32_t* __restrict__ out,
                     uint32_t* __restrict__ partial,
                     unsigned int* __restrict__ ticket, int kt_log,
                     long ktiles) {
  __shared__ uint32_t sh[9][BLOCK];
  __shared__ bool last;
  const int KT = 1 << kt_log, RT = BLOCK >> kt_log;
  const int t = threadIdx.x, kk = t & (KT - 1), ii = t >> kt_log;
  const long g = blockIdx.x, o = g / ktiles;
  const long k = (g - o * ktiles) * KT + kk;
  const long splits = gridDim.y, s = blockIdx.y;
  const long chunk = (a.I + splits - 1) / splits;
  const long i0 = s * chunk, i1 = i0 + chunk < a.I ? i0 + chunk : a.I;

  uint32_t acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  if (k < a.K) {
    const uint32_t* col = a.p + o * a.so + k * a.sk;
    for (long i = i0 + ii; i < i1; i += (long)RT * ELEMS) {
      uint32_t x[ELEMS][8], y[ELEMS][8];
#pragma unroll
      for (int e = 0; e < ELEMS; e++) {
        const long j = i + (long)e * RT;
        if (j < i1) {
          fq_load(x[e], col + j * a.si);
          if constexpr (WEIGHTED) fq_load(y[e], w + j * ws);
        } else {
#pragma unroll
          for (int q = 0; q < 8; q++) x[e][q] = y[e][q] = 0;
        }
      }
      if constexpr (WEIGHTED) {
        fq_acc_mul_n<ELEMS>(acc, x, y);
      } else {
#pragma unroll
        for (int e = 0; e < ELEMS; e++) fq_acc_add(acc, x[e]);
      }
    }
  }
  tree_sum(acc, sh, kt_log);
  if (splits == 1) {
    if (ii == 0 && k < a.K) {
      uint32_t r[8];
      fq_reduce_wide(r, acc);
      fq_store(out + (o * a.K + k) * 8, r);
    }
    return;
  }

  // partials: (group, split, KT, 9) words
  uint32_t* part = partial + (size_t)g * splits * KT * 9;
  if (ii == 0) {
#pragma unroll
    for (int q = 0; q < 9; q++)
      part[((size_t)s * KT + kk) * 9 + q] = acc[q];
    __threadfence();
  }
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket + g, 1u) == (unsigned)(splits - 1);
  __syncthreads();
  if (!last) return;

  // the group's last block: its rows stride over the splits' partials
  // (read from L2: other SMs wrote them), then the same tree
#pragma unroll
  for (int q = 0; q < 9; q++) acc[q] = 0;
  for (long p = ii; p < splits; p += RT) {
    uint32_t v[9];
#pragma unroll
    for (int q = 0; q < 9; q++)
      v[q] = __ldcg(part + ((size_t)p * KT + kk) * 9 + q);
    fq_acc_add9(acc, v);
  }
  tree_sum(acc, sh, kt_log);
  if (ii == 0 && k < a.K) {
    uint32_t r[8];
    fq_reduce_wide(r, acc);
    fq_store(out + (o * a.K + k) * 8, r);
  }
}

// a: O x I x K elements at p + o * so + i * si + k * sk words, 16-byte
// aligned; w: I elements ws words apart, or null for a plain sum; out: O
// x K contiguous elements.  KT = 2^kt_log columns a block (a power of two
// up to BLOCK), ktiles = ceil(K / KT); grid O * ktiles blocks by
// `splits`.  With splits > 1: partial, O * ktiles * splits * KT * 9
// words of scratch, and ticket, O * ktiles zeroed words no other launch
// in flight shares.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a shape the grid cannot take.
extern "C" int fq_reduce_launch(const void* a, long so, long si, long sk,
                                long O, long I, long K, const void* w, long ws,
                                void* out, int kt_log, long splits,
                                void* partial, void* ticket, void* stream) {
  if (O <= 0 || K <= 0) return 0;
  if (kt_log < 0 || (1 << kt_log) > BLOCK || splits < 1 || splits > 65535 ||
      (splits > 1 && (!partial || !ticket)))
    return (int)cudaErrorInvalidValue;
  const long KT = 1L << kt_log, ktiles = (K + KT - 1) / KT;
  if (O * ktiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const table_t t{(const uint32_t*)a, so, si, sk, O, I, K};
  const dim3 grid((unsigned)(O * ktiles), (unsigned)splits);
  cudaStream_t s = (cudaStream_t)stream;
  if (w)
    fq_reduce_kernel<true><<<grid, BLOCK, 0, s>>>(
        t, (const uint32_t*)w, ws, (uint32_t*)out, (uint32_t*)partial,
        (unsigned int*)ticket, kt_log, ktiles);
  else
    fq_reduce_kernel<false><<<grid, BLOCK, 0, s>>>(
        t, nullptr, 0, (uint32_t*)out, (uint32_t*)partial,
        (unsigned int*)ticket, kt_log, ktiles);
  return (int)cudaGetLastError();
}
