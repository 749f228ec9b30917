// Constant-time variable-base scalar multiplication of one ed25519
// point by a quad of lanes, for kernel K5 (point_msm.cu).
//
// Layout: the four lanes of a quad hold one point, lane k coordinate k of
// (X, Y, Z, T) in extended twisted-Edwards coordinates, and swap
// coordinates with __shfl_sync inside the quad.  The point operations are
// the 4-way parallel forms of the extended formulas (Hisil, Wong, Carter,
// Dawson 2008; laid out for four lanes as curve25519-dalek's AVX2 backend
// does): a doubling is four independent squarings and then four
// independent products, an addition of a cached entry four products and
// then four more, one of each per lane.  So a point operation costs two
// product latencies and four rounds of shuffles.
//
// Cached entries hold lambda (Y - X, Y + X, 2Z, 2dT) with lambda = 121666:
// d = -121665/121666, so lambda 2d = -243330 and the entry is made from
// (Y - X, Y + X, Z, T) by one product per lane with the constants
// (lambda, lambda, 2 lambda, -243330); the scale lambda changes the sum's
// projective representative, not its point.
//
// r = s * P for a scalar s < 2^253 (a canonical scalar; 8 words):
// - the table 1P ... 8P in cached form (P, then seven additions of P),
//   one coordinate per lane, 8 x 8 words a lane held in registers;
// - the scalar recoded into 64 signed radix-16 digits d_w in [-8, 8)
//   without a branch: t = s + 8 (16^63 - 1) / 15 by one carry chain, and
//   d_w = nibble w of t minus 8 (w < 63), d_63 = nibble 63 of t;
// - acc = the identity plus the entry of d_63, then for w = 62 ... 0: four
//   doublings and the addition of the entry of d_w.
// Constant time: the scalars are secrets (the witness, blinds, the tape's
// d).  An entry is chosen by reading the identity and all 8 entries and
// keeping one by a mask (ct_eq_mask of |d|); a negative digit negates the
// entry by a masked swap of its first two lanes (Y - X and Y + X) and a
// masked negation of its fourth (2dT), both computed for every digit.
// The table lives in registers at indices fixed by the unrolled loops,
// digits are read by shifts that depend only on the window index, and
// every lane runs every operation: no branch and no address depends on a
// digit.
//
// The same source runs on the host (no __CUDA_ARCH__: nvcc's host pass,
// and g++ in tests/test_torch_csrc.py), where a qfe holds the four lanes
// of a quad and each operation loops over them, a shuffle reading the
// lanes' values before writing any.  The plain PyTorch twin
// (spartan_tpu_torch/curve/point_msm.py) runs the same formulas in the
// same order, so the coordinates agree bit for bit.
#pragma once
#include <stdint.h>

#include "fp25519.cuh"

#if defined(__CUDA_ARCH__)
#define QN 1  // this lane's element of the quad
#else
#define QN 4  // the quad's four lanes, lane k at w[k]
#endif

// one field element in each lane of a quad
struct qfe {
  uint32_t w[QN][8];
};

#define Q_LAMBDA 121666u
// lanes of a pick, one bit a lane
#define L0 1u
#define L1 2u
#define L2 4u
#define L3 8u
// the quad lanes that lanes 0, 1, 2, 3 read in a shuffle
#define QSRC(a, b, c, d) ((a) | ((b) << 2) | ((c) << 4) | ((d) << 6))

static __constant__ uint32_t Q_CACHED_K[4][8] = {
    // lambda, lambda, 2 lambda, -243330 (mod p)
    {Q_LAMBDA, 0, 0, 0, 0, 0, 0, 0},
    {Q_LAMBDA, 0, 0, 0, 0, 0, 0, 0},
    {2 * Q_LAMBDA, 0, 0, 0, 0, 0, 0, 0},
    {0xfffc496bu, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
     0xffffffffu, 0xffffffffu, 0x7fffffffu}};

// the lane of a quad that element j of a qfe belongs to
static __device__ __forceinline__ uint32_t q_k(int j) {
#if defined(__CUDA_ARCH__)
  return threadIdx.x & 3;
#else
  return (uint32_t)j;
#endif
}

// all ones when a == b, else 0, with no branch and no compare flag
static __device__ __forceinline__ uint32_t ct_eq_mask(uint32_t a,
                                                      uint32_t b) {
  uint32_t x = a ^ b;
  return ((x | (0u - x)) >> 31) - 1u;
}

static __device__ __forceinline__ void q_mul(qfe& r, const qfe& a,
                                             const qfe& b) {
#pragma unroll
  for (int j = 0; j < QN; j++) fp_mul(r.w[j], a.w[j], b.w[j]);
}

static __device__ __forceinline__ void q_add(qfe& r, const qfe& a,
                                             const qfe& b) {
#pragma unroll
  for (int j = 0; j < QN; j++) fp_add(r.w[j], a.w[j], b.w[j]);
}

static __device__ __forceinline__ void q_sub(qfe& r, const qfe& a,
                                             const qfe& b) {
#pragma unroll
  for (int j = 0; j < QN; j++) fp_sub(r.w[j], a.w[j], b.w[j]);
}

// r = a in the lanes set in `lanes`, b in the others
static __device__ __forceinline__ void q_pick(qfe& r, uint32_t lanes,
                                              const qfe& a, const qfe& b) {
#pragma unroll
  for (int j = 0; j < QN; j++) {
    uint32_t m = 0u - ((lanes >> q_k(j)) & 1u);
#pragma unroll
    for (int i = 0; i < 8; i++) r.w[j][i] = (a.w[j][i] & m) | (b.w[j][i] & ~m);
  }
}

// r = a where mask is all ones, else b (one mask for the whole quad)
static __device__ __forceinline__ void q_cmov(qfe& r, uint32_t mask,
                                              const qfe& a, const qfe& b) {
#pragma unroll
  for (int j = 0; j < QN; j++)
#pragma unroll
    for (int i = 0; i < 8; i++)
      r.w[j][i] = (a.w[j][i] & mask) | (b.w[j][i] & ~mask);
}

// lane k of r = v of quad lane (src >> 2k) & 3
static __device__ __forceinline__ void q_shfl(qfe& r, const qfe& v,
                                              uint32_t src) {
#if defined(__CUDA_ARCH__)
  int from = (src >> (2 * (threadIdx.x & 3))) & 3;
#pragma unroll
  for (int i = 0; i < 8; i++)
    r.w[0][i] = __shfl_sync(0xffffffffu, v.w[0][i], from, 4);
#else
  qfe t = v;
  for (int j = 0; j < QN; j++)
    for (int i = 0; i < 8; i++) r.w[j][i] = t.w[(src >> (2 * j)) & 3][i];
#endif
}

// the identity (0, 1, 1, 0)
static __device__ __forceinline__ void q_identity(qfe& r) {
#pragma unroll
  for (int j = 0; j < QN; j++) {
    uint32_t k = q_k(j);
#pragma unroll
    for (int i = 0; i < 8; i++) r.w[j][i] = 0;
    r.w[j][0] = (k == 1 || k == 2) ? 1u : 0u;
  }
}

// (Y - X, Y + X, Z, T) of an extended point
static __device__ __forceinline__ void q_yx(qfe& a, const qfe& p) {
  qfe w, d, s;
  q_shfl(w, p, QSRC(1, 0, 2, 3));  // lane 0 <- Y, lane 1 <- X
  q_sub(d, w, p);
  q_add(s, p, w);
  q_pick(a, L0, d, p);
  q_pick(a, L1, s, a);
}

// the cached form lambda (Y - X, Y + X, 2Z, 2dT) of an extended point
static __device__ __forceinline__ void q_to_cached(qfe& c, const qfe& p) {
  qfe a, k;
  q_yx(a, p);
#pragma unroll
  for (int j = 0; j < QN; j++)
#pragma unroll
    for (int i = 0; i < 8; i++) k.w[j][i] = Q_CACHED_K[q_k(j)][i];
  q_mul(c, a, k);
}

// r = p + c for a cached c (add-2008-hwcd-3; r may alias p):
//   A = (Y1 - X1) c0, B = (Y1 + X1) c1, D = Z1 c2, C = T1 c3,
//   E = B - A, F = D - C, G = D + C, H = B + A,
//   (X3, Y3, Z3, T3) = (E F, G H, F G, E H)
static __device__ __forceinline__ void q_cadd(qfe& r, const qfe& p,
                                              const qfe& c) {
  qfe a, m, w, x, y, d, s;
  q_yx(a, p);
  q_mul(m, a, c);                  // (A, B, D, C)
  q_shfl(w, m, QSRC(1, 0, 3, 2));  // the pair's other product
  q_pick(x, L1 | L2, m, w);
  q_pick(y, L1 | L2, w, m);
  q_sub(d, x, y);                  // (E, E, F, F)
  q_add(s, m, w);                  // (H, H, G, G)
  q_pick(x, L1, s, d);             // (E, H, F, F)
  q_shfl(a, x, QSRC(0, 1, 2, 0));  // (E, H, F, E)
  q_pick(y, L2, d, s);             // (H, H, F, G)
  q_shfl(w, y, QSRC(2, 3, 3, 0));  // (F, G, G, H)
  q_mul(r, a, w);
}

// r = 2p (dbl-2008-hwcd with a = -1; r may alias p):
//   S = (X + Y)^2, B = Y^2, Zs = Z^2, A = X^2,
//   G = B - A, H = -(A + B), E = S - (A + B), F = G - 2 Zs,
//   (X3, Y3, Z3, T3) = (E F, G H, F G, E H)
static __device__ __forceinline__ void q_dbl(qfe& r, const qfe& p) {
  qfe a, m, w, x, y, g, h, e, f, s, t;
  q_shfl(w, p, QSRC(1, 1, 2, 0));  // lane 0 <- Y, lane 3 <- X
  q_add(x, p, w);
  q_pick(a, L0, x, p);
  q_pick(a, L3, w, a);             // (X + Y, Y, Z, X)
  q_mul(m, a, a);                  // (S, B, Zs, A)
  q_shfl(w, m, QSRC(2, 3, 0, 1));  // (Zs, A, S, B)
  q_add(t, m, w);                  // lanes 1, 3: A + B
  q_shfl(s, t, QSRC(3, 1, 2, 3));  // lane 0: A + B
  q_pick(x, L1, m, w);
  q_pick(y, L1, w, m);
  q_sub(g, x, y);                  // lanes 1, 3: G
  q_sub(h, qfe{}, t);              // lanes 1, 3: H
  q_pick(x, L1, g, m);             // (S, G, ., .)
  q_shfl(y, x, QSRC(1, 1, 1, 0));  // (G, ., G, S)
  q_pick(a, L0, w, m);             // lanes 0, 2: Zs
  q_add(a, a, a);
  q_sub(f, y, a);                  // lanes 0, 2: F
  q_pick(a, L0, m, y);             // lanes 0, 3: S
  q_pick(x, L0, s, t);             // lanes 0, 3: A + B
  q_sub(e, a, x);                  // lanes 0, 3: E
  q_pick(a, L1, g, e);
  q_pick(a, L2, f, a);             // (E, G, F, E)
  q_pick(w, L0, f, h);
  q_pick(w, L2, y, w);             // (F, H, G, H)
  q_mul(r, a, w);
}

// e = the entry of digit d in [-8, 8]: the identity lambda (1, 1, 2, 0)
// for 0, tab[|d| - 1] else, negated for d < 0; every entry read
static __device__ __forceinline__ void q_select(qfe& e, const qfe tab[8],
                                                int32_t d) {
  uint32_t neg = (uint32_t)(d >> 31);
  uint32_t ad = ((uint32_t)d ^ neg) - neg;
  uint32_t m = ct_eq_mask(ad, 0);
#pragma unroll
  for (int j = 0; j < QN; j++) {
    uint32_t k = q_k(j);
#pragma unroll
    for (int i = 0; i < 8; i++) e.w[j][i] = 0;
    e.w[j][0] = (k < 2 ? Q_LAMBDA : k == 2 ? 2 * Q_LAMBDA : 0u) & m;
  }
#pragma unroll
  for (int t = 0; t < 8; t++) {
    m = ct_eq_mask(ad, (uint32_t)t + 1);
#pragma unroll
    for (int j = 0; j < QN; j++)
#pragma unroll
      for (int i = 0; i < 8; i++) e.w[j][i] |= tab[t].w[j][i] & m;
  }
  qfe w, n, x;
  q_shfl(w, e, QSRC(1, 0, 2, 3));
  q_sub(n, qfe{}, e);
  q_pick(x, L0 | L1, w, n);
  q_pick(x, L2, e, x);             // -e: (Y + X, Y - X, 2Z, -2dT) scaled
  q_cmov(e, neg, x, e);
}

// t = s + 8 (16^63 - 1) / 15 for s < 2^253: nibble w of t is d_w + 8 for
// w < 63 and nibble 63 is d_63, the signed radix-16 digits of s
static __device__ __forceinline__ void recode16(uint32_t t[8],
                                                const uint32_t s[8]) {
  t[0] = add_cc(s[0], 0x88888888u);
#pragma unroll
  for (int j = 1; j < 7; j++) t[j] = addc_cc(s[j], 0x88888888u);
  t[7] = addc(s[7], 0x08888888u);
}

static __device__ __forceinline__ void q_scalar_mul(qfe& r, const qfe& p,
                                                    const uint32_t s[8]) {
  qfe tab[8], acc, e;
  q_to_cached(tab[0], p);
  acc = p;
#pragma unroll 1
  for (int t = 1; t < 8; t++) {  // tab[t] = (t + 1) P
    q_cadd(acc, acc, tab[0]);
    q_to_cached(e, acc);
#pragma unroll
    for (int u = 1; u < 8; u++)
      if (u == t) tab[u] = e;
  }
  uint32_t d[8];
  recode16(d, s);
  q_identity(acc);
  q_select(e, tab, (int32_t)(d[7] >> 28));
  q_cadd(acc, acc, e);
  // the rest of the digits from the top: cur holds the word being read,
  // its next nibble on top; words move up d[] so no index is dynamic
  uint32_t cur = d[7] << 4;
  int left = 7;
#pragma unroll 1
  for (int w = 62; w >= 0; w--) {
    if (left == 0) {
#pragma unroll
      for (int u = 7; u > 0; u--) d[u] = d[u - 1];
      cur = d[7];
      left = 8;
    }
    int32_t dig = (int32_t)(cur >> 28) - 8;
    cur <<= 4;
    left--;
#pragma unroll 1
    for (int k = 0; k < 4; k++) q_dbl(acc, acc);
    q_select(e, tab, dig);
    q_cadd(acc, acc, e);
  }
  r = acc;
}
