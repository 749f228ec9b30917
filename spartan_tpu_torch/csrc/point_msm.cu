// K5, the grouped variable-base MSM on ed25519:
//   out[g] = sum_{off[g] <= i < off[g+1]} s[i] * P[i]   for g < G.
//
// Replaces the JAX package's variable-base device MSMs (XLA ops, not a
// Pallas kernel): spartan_tpu/curve/edwards.py:100 (scalar_mul, a
// select-based double-and-add) with :119 (sum_reduce), and
// spartan_tpu/curve/msm.py:147 (_msm_windows), as the bullet rounds
// (spartan_tpu/protocols/bullet.py:67-87) and the device dot-product-log
// (spartan_tpu/protocols/device_prover.py:658, :705-708) call them.  One
// contract serves every use: a bullet round's G fold (n/2 groups of 2
// points, scalars u^-1 and u), its cross terms L and R (two groups of
// n/2 + 2: the half of G, Q and H), the dot-product-log's Cx, Cy, Q,
// delta and beta, and the device ZK rounds' Pedersen rows (groups of at
// most 7).  The scalars are secrets in most of these (blinds, the tape's
// d, r_delta, r_beta, the witness vector), so the kernel is constant
// time: see point_msm.cuh.
//
// Bound on this card: operations.  A point costs 7 cached additions and 8
// conversions for its table, 63 x 4 doublings and 64 additions (~2,600
// field products of 72 wide multiply-adds mod p), a group g of m points
// m - 1 more additions; the bytes (160 B a point in, 128 B a group out)
// are nothing beside that.  At the sizes of this slice (1,026 to 4,098
// points) the card is mostly idle, so a launch's time is its longest
// dependent chain, not the card's multiply rate.  The design keeps that
// chain short: a quad of lanes takes a point (point_msm.cuh), so a point
// operation is two product latencies, ~654 dependent product-steps a
// point in all.
//
// Design:
// - point_mul_kernel: four lanes a point, lane k loading and storing
//   coordinate k; the table 1P ... 8P lives in registers and the scalar
//   is recoded into signed radix-16 digits (point_msm.cuh); the product
//   goes to a per-launch scratch buffer (lazy coordinates).  A lane past
//   the last point works on the last point and stores nothing, so every
//   lane of a warp takes part in the quads' shuffles.
// - group_sum_kernel: one block a group, `lanes` threads (a power of two
//   covering the largest group, at most MAX_LANES, chosen by the
//   wrapper): lane t sums the group's points t, t + lanes, ... in order
//   (starting from its first point, the identity when it has none), then
//   the lanes' sums meet in a fixed halving tree through shared memory
//   (lane t += lane t + half) by the unified addition.  Lane 0 writes the
//   canonical result.  No atomics, so the order of additions is fixed and
//   the plain version repeats it: the coordinates agree bit for bit.
// The scratch is the wrapper's, allocated for each launch, so launches
// on different streams never share it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "point_msm.cuh"

#define MUL_BLOCK 64
#define MAX_LANES 64

// pts: (n, 4, 8); sc: (n, 8) canonical; prod: (n, 4, 8)
__global__ void __launch_bounds__(MUL_BLOCK)
    point_mul_kernel(const uint32_t* __restrict__ pts,
                     const uint32_t* __restrict__ sc,
                     uint32_t* __restrict__ prod, int n) {
  int t = blockIdx.x * MUL_BLOCK + threadIdx.x;
  int i = t >> 2, k = t & 3;
  int src = i < n ? i : n - 1;
  qfe p, r;
  const uint4* v = reinterpret_cast<const uint4*>(pts + (size_t)src * 32 +
                                                  k * 8);
  uint4 lo = v[0], hi = v[1];
  p.w[0][0] = lo.x; p.w[0][1] = lo.y; p.w[0][2] = lo.z; p.w[0][3] = lo.w;
  p.w[0][4] = hi.x; p.w[0][5] = hi.y; p.w[0][6] = hi.z; p.w[0][7] = hi.w;
  v = reinterpret_cast<const uint4*>(sc + (size_t)src * 8);
  lo = v[0];
  hi = v[1];
  const uint32_t s[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  q_scalar_mul(r, p, s);
  if (i < n) {
    uint4* o = reinterpret_cast<uint4*>(prod + (size_t)i * 32 + k * 8);
    o[0] = make_uint4(r.w[0][0], r.w[0][1], r.w[0][2], r.w[0][3]);
    o[1] = make_uint4(r.w[0][4], r.w[0][5], r.w[0][6], r.w[0][7]);
  }
}

// one thread's dependent chain of `steps` products x = x * y (x, y: 8
// words each, x updated): chip_smoke.py times it to measure one product's
// latency, the unit of K5's chain floor
__global__ void fp_mul_chain_kernel(uint32_t* __restrict__ xy, int steps) {
  uint32_t x[8], y[8];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    x[j] = xy[j];
    y[j] = xy[8 + j];
  }
#pragma unroll 1
  for (int i = 0; i < steps; i++) fp_mul(x, x, y);
#pragma unroll
  for (int j = 0; j < 8; j++) xy[j] = x[j];
}

// word j of coordinate c of lane slot k at sh[(c * 8 + j) * MAX_LANES + k]:
// the lanes of a warp hit different banks
static __device__ __forceinline__ void sh_put(uint32_t* sh, int k,
                                              const ge_t& p) {
  const uint32_t* src[4] = {p.x, p.y, p.z, p.t};
#pragma unroll
  for (int c = 0; c < 4; c++)
#pragma unroll
    for (int j = 0; j < 8; j++) sh[(c * 8 + j) * MAX_LANES + k] = src[c][j];
}

static __device__ __forceinline__ void sh_get(ge_t& p, const uint32_t* sh,
                                              int k) {
  uint32_t* dst[4] = {p.x, p.y, p.z, p.t};
#pragma unroll
  for (int c = 0; c < 4; c++)
#pragma unroll
    for (int j = 0; j < 8; j++) dst[c][j] = sh[(c * 8 + j) * MAX_LANES + k];
}

// prod: (n, 4, 8); off: (G + 1,) int32; out: (G, 4, 8) canonical
__global__ void __launch_bounds__(MAX_LANES)
    group_sum_kernel(const uint32_t* __restrict__ prod,
                     const int* __restrict__ off, uint32_t* __restrict__ out,
                     int lanes) {
  __shared__ uint32_t sh[32 * MAX_LANES];
  int g = blockIdx.x, t = threadIdx.x;
  int lo = off[g], hi = off[g + 1];
  ge_t acc;
  int i = lo + t;
  if (i < hi)
    ge_load(acc, prod + (size_t)i * 32);
  else
    ge_identity(acc);
  for (i += lanes; i < hi; i += lanes) {
    ge_t q;
    ge_load(q, prod + (size_t)i * 32);
    ge_add(acc, acc, q);
  }
  for (int half = lanes >> 1; half >= 1; half >>= 1) {
    if (t >= half && t < 2 * half) sh_put(sh, t - half, acc);
    __syncthreads();
    if (t < half) {
      ge_t q;
      sh_get(q, sh, t);
      ge_add(acc, acc, q);
    }
    __syncthreads();
  }
  if (t == 0) {
    fp_canon(acc.x);
    fp_canon(acc.y);
    fp_canon(acc.z);
    fp_canon(acc.t);
    ge_store(out + (size_t)g * 32, acc);
  }
}

extern "C" int point_msm_launch(const void* pts, const void* scalars,
                                const void* off, void* prod, void* out,
                                int n, int groups, int lanes, void* stream) {
  if (n < 0 || n > (1 << 28) || groups < 0 || lanes < 1 ||
      lanes > MAX_LANES || (lanes & (lanes - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0)
    point_mul_kernel<<<(4 * n + MUL_BLOCK - 1) / MUL_BLOCK, MUL_BLOCK, 0,
                       s>>>((const uint32_t*)pts, (const uint32_t*)scalars,
                            (uint32_t*)prod, n);
  int e = (int)cudaGetLastError();
  if (e || groups == 0) return e;
  group_sum_kernel<<<groups, lanes, 0, s>>>(
      (const uint32_t*)prod, (const int*)off, (uint32_t*)out, lanes);
  return (int)cudaGetLastError();
}

extern "C" int fp_mul_chain_launch(void* xy, int steps, void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  fp_mul_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((uint32_t*)xy,
                                                          steps);
  return (int)cudaGetLastError();
}
