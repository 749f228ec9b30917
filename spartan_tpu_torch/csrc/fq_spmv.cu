// The Fq sparse product on the device (kernel K9):
//   out[r] = sum over the non-zeros j of output r of val[j] * x[idx[j]]
// (Montgomery products, mod q), for every output r of a matrix held
// sorted by output index (fq_spmv.cuh).  The R1CS proof's Az, Bz, Cz
// (outputs the rows, inputs z), its eval tables (outputs the columns,
// inputs eq(rx)) and the evaluation of A, B, C at (rx, ry) (outputs the
// rows, inputs eq(ry), then a dot with eq(rx) by K8).
//
// Replaces no TPU kernel: the JAX package runs this product in XLA
// (gather, limb products, a scatter-add; spartan_tpu/r1cs/shape.py).
// The plain PyTorch twin is spartan_tpu_torch/r1cs/shape.py
// (_spmv_plain), whose spmv launches this kernel for tensors on the
// card.
//
// Bound on this card: bytes.  Each non-zero reads 4 bytes of index, 32
// of value and 32 of gathered input; each output reads 4 bytes of offset
// and writes 32.  (A table by column also reads 4 bytes of perm a
// non-zero and its values out of order, a whole 32-byte sector each.)  At 2^20 non-zeros into 2^20 rows that is ~113 MB,
// 0.034 ms at 3.35 TB/s; into 2^21 columns ~155 MB, 0.046 ms.  The 2^20
// products of 136 multiply-adds (two IMAD slots each) take ~0.017 ms.
//
// Design: two kinds of blocks in one launch.  Short rows (at most
// long_min non-zeros): one thread a row; the thread walks its row ELEMS
// products side by side, keeps a 9-word unreduced accumulator and
// reduces once (fq_spmv_finish: a row of one or two entries needs only a
// conditional subtraction).  An empty row writes zero, and so do the
// rows past the table's last non-empty one (n_tab up to n_out), which
// the table leaves out.  A warp takes as
// long as its longest row, so where row lengths vary the threads take
// the rows in the wrapper's order, longest first (order[t] is thread t's
// row; consecutive threads then get rows of one length), and in output
// order where the lengths do not vary or already fall (order null).  Long rows are cut into chunks of at most a fixed
// number of non-zeros (the wrapper's table: chunk c covers entries
// begin .. end - 1 of long row l); a block a chunk, its threads striding
// over the chunk, a shared-memory tree summing their accumulators.  A
// row of one chunk is reduced and written by its block; otherwise each
// block writes its 9-word partial, and the last of the row's blocks to
// finish (an atomic ticket after __threadfence, one ticket a row, zeroed
// by the wrapper for each launch) sums the row's partials through the
// same tree and reduces once, as in K8.  The chunk blocks come first in
// the grid, so they start while the short rows run.  So one row with
// many non-zeros never holds up a warp of short rows.  There are no
// atomics on outputs: every output is written once, by one thread.
// Sums of residues are exact, so the result does not depend on the
// order and equals the plain version bit for bit.
//
// Times and registers: PERF.md section 6.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fq_spmv.cuh"

#define BLOCK 256
#define ELEMS 2

struct csr_t {  // each index array null where it is the identity
  const int32_t* off;    // n_tab + 1 offsets into idx and perm
  const int32_t* idx;    // input index of each non-zero
  const uint32_t* val;   // 8 words a non-zero
  const int32_t* perm;   // entry j's value is val[perm[j]]
  const int32_t* order;  // thread t's row
  long n_out, n_tab;
  long long_min;  // rows with more non-zeros are the chunks' rows
};

struct chunks_t {
  const int32_t* chunk;  // (n_chunks, 3): long row l, begin, end
  const int32_t* rows;   // (n_long + 1, 2): output row, first chunk
  long n_chunks;
  uint32_t* partial;     // n_chunks x 9 words
  unsigned int* ticket;  // n_long zeroed words
};

// The block's accumulators summed into thread 0's acc; sh is the
// block's scratch, word-major.
static __device__ __forceinline__ void block_sum(uint32_t acc[9],
                                                 uint32_t (*sh)[BLOCK]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int w = 0; w < 9; w++) sh[w][t] = acc[w];
  for (int st = BLOCK >> 1; st > 0; st >>= 1) {
    __syncthreads();
    if (t < st) {
      uint32_t o[9];
#pragma unroll
      for (int w = 0; w < 9; w++) o[w] = sh[w][t + st];
      fq_acc_add9(acc, o);
#pragma unroll
      for (int w = 0; w < 9; w++) sh[w][t] = acc[w];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(BLOCK)
    fq_spmv_kernel(csr_t a, chunks_t c, const uint32_t* __restrict__ x,
                   uint32_t* __restrict__ out) {
  const int t = threadIdx.x;
  uint32_t acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  uint32_t r[8];
  if ((long)blockIdx.x >= c.n_chunks) {  // short rows, a thread a row
    const long slot = ((long)blockIdx.x - c.n_chunks) * BLOCK + t;
    if (slot >= a.n_out) return;
    long row = slot, b = 0, e = 0;
    if (slot < a.n_tab) {
      if (a.order) row = a.order[slot];
      b = fq_spmv_at(a.off, row);
      e = fq_spmv_at(a.off, row + 1);
      if (e - b > a.long_min) return;  // a chunk block writes it
    }
    fq_spmv_acc<ELEMS>(acc, a.idx, a.val, a.perm, x, b, e, 1);
    fq_spmv_finish(r, acc, e - b);
    fq_store(out + 8 * row, r);
    return;
  }

  __shared__ uint32_t sh[9][BLOCK];
  __shared__ bool last;
  const int32_t* ch = c.chunk + 3 * (long)blockIdx.x;
  const long l = ch[0], b = ch[1], e = ch[2];
  const long row = c.rows[2 * l], c0 = c.rows[2 * l + 1],
             c1 = c.rows[2 * l + 3];
  fq_spmv_acc<ELEMS>(acc, a.idx, a.val, a.perm, x, b + t, e, BLOCK);
  block_sum(acc, sh);
  if (c1 - c0 == 1) {
    if (t == 0) {
      fq_reduce_wide(r, acc);
      fq_store(out + 8 * row, r);
    }
    return;
  }
  if (t == 0) {
#pragma unroll
    for (int w = 0; w < 9; w++) c.partial[9 * (long)blockIdx.x + w] = acc[w];
    __threadfence();
    last = atomicAdd(c.ticket + l, 1u) == (unsigned)(c1 - c0 - 1);
  }
  __syncthreads();
  if (!last) return;

  // the row's last block: its threads stride over the row's partials
  // (read from L2: other SMs wrote them), then the same tree
#pragma unroll
  for (int w = 0; w < 9; w++) acc[w] = 0;
  for (long p = c0 + t; p < c1; p += BLOCK) {
    uint32_t v[9];
#pragma unroll
    for (int w = 0; w < 9; w++) v[w] = __ldcg(c.partial + 9 * p + w);
    fq_acc_add9(acc, v);
  }
  block_sum(acc, sh);
  if (t == 0) {
    fq_reduce_wide(r, acc);
    fq_store(out + 8 * row, r);
  }
}

// off: n_tab + 1 int32 offsets, nondecreasing, off[0] = 0, for the
// first n_tab <= n_out rows (the others are empty); idx: the non-zeros'
// input indices (int32) in output order; val: their values, 16-byte
// aligned, 8 words each, entry j's at val[perm[j]] (perm nnz int32);
// order: a permutation of the n_tab rows, the order the threads take
// them in; each of off, idx, perm and order null for the identity;
// x: the input table, 8 words an element, 16-byte aligned, holding every
// idx; out: n_out elements, contiguous, 16-byte aligned.  Rows with more
// than long_min non-zeros are listed in rows ((n_long + 1) x 2 int32:
// output row and first chunk, the last entry's first chunk n_chunks) and
// cut into the chunks of chunk (n_chunks x 3 int32: long row, begin,
// end; a row's chunks consecutive, covering its entries); partial
// (n_chunks x 9 words) and ticket (n_long zeroed words no other launch
// in flight shares) serve rows of more than one chunk.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the grid
// cannot take.
extern "C" int fq_spmv_launch(const void* off, const void* idx,
                              const void* val, const void* perm,
                              const void* order, long n_out, long n_tab,
                              long long_min, const void* chunk,
                              const void* rows,
                              long n_chunks, void* partial, void* ticket,
                              const void* x, void* out, void* stream) {
  if (n_out < 0 || n_tab < 0 || n_tab > n_out || n_chunks < 0 ||
      long_min < 0 ||
      (n_chunks > 0 && (!chunk || !rows || !partial || !ticket)))
    return (int)cudaErrorInvalidValue;
  const long blocks = n_chunks + (n_out + BLOCK - 1) / BLOCK;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const csr_t a{(const int32_t*)off, (const int32_t*)idx,
                (const uint32_t*)val, (const int32_t*)perm,
                (const int32_t*)order, n_out, n_tab, long_min};
  const chunks_t c{(const int32_t*)chunk, (const int32_t*)rows, n_chunks,
                   (uint32_t*)partial, (unsigned int*)ticket};
  fq_spmv_kernel<<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      a, c, (const uint32_t*)x, (uint32_t*)out);
  return (int)cudaGetLastError();
}
