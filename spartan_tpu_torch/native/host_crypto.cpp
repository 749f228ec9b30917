// Native host-crypto core for spartan_tpu.
//
// TPU-native split: the device (JAX/Pallas) owns bulk field/MSM compute;
// this library owns the *host* serial paths that the reference gets from
// Rust crates — the merlin/STROBE transcript (keccak-f[1600] sponge),
// ristretto255 point codec, and small/mid-size variable-time MSM
// (reference src/group.rs, src/transcript.rs via the merlin crate).
//
// Field arithmetic: 5x51-bit limbs mod 2^255-19 (the standard ref10/dalek
// representation) with unsigned __int128 accumulation.
//
// ABI (all little-endian):
//   fe/point blob: extended coordinates X,Y,Z,T, canonical 32 bytes each
//   scalar: 32 bytes (any 256-bit value; used vartime, public data only)
//   strobe state: 200-byte sponge + pos + pos_begin + cur_flags (203 B)
//
// Build: g++ -O3 -shared -fPIC (see native/__init__.py).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint8_t u8;

// ===========================================================================
// keccak-f[1600]
// ===========================================================================

static const u64 KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

static inline u64 rol64(u64 v, unsigned n) {
  n &= 63;
  return n ? ((v << n) | (v >> (64 - n))) : v;
}

extern "C" void spartan_keccak_f1600(u8 state[200]) {
  u64 a[25];
  memcpy(a, state, 200);
  static const unsigned ROT[5][5] = {
      {0, 36, 3, 41, 18}, {1, 44, 10, 45, 2}, {62, 6, 43, 15, 61},
      {28, 55, 25, 21, 56}, {27, 20, 39, 8, 14}};
  for (int rnd = 0; rnd < 24; rnd++) {
    u64 c[5], d[5], b[25];
    for (int x = 0; x < 5; x++)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ rol64(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d[x];
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rol64(a[x + 5 * y], ROT[x][y]);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) &
                                       b[(x + 2) % 5 + 5 * y]);
    a[0] ^= KECCAK_RC[rnd];
  }
  memcpy(state, a, 200);
}

// ===========================================================================
// STROBE-128 (merlin subset: meta_ad / ad / prf / key)
// ===========================================================================

static const int STROBE_R = 166;
enum { FLAG_I = 1, FLAG_A = 2, FLAG_C = 4, FLAG_T = 8, FLAG_M = 16, FLAG_K = 32 };

struct StrobeState {
  u8 st[200];
  u8 pos;
  u8 pos_begin;
  u8 cur_flags;
};  // 203 bytes

static void strobe_run_f(StrobeState* s) {
  s->st[s->pos] ^= s->pos_begin;
  s->st[s->pos + 1] ^= 0x04;
  s->st[STROBE_R + 1] ^= 0x80;
  spartan_keccak_f1600(s->st);
  s->pos = 0;
  s->pos_begin = 0;
}

static void strobe_absorb(StrobeState* s, const u8* data, size_t n) {
  for (size_t i = 0; i < n; i++) {
    s->st[s->pos] ^= data[i];
    if (++s->pos == STROBE_R) strobe_run_f(s);
  }
}

static void strobe_overwrite(StrobeState* s, const u8* data, size_t n) {
  for (size_t i = 0; i < n; i++) {
    s->st[s->pos] = data[i];
    if (++s->pos == STROBE_R) strobe_run_f(s);
  }
}

static void strobe_squeeze(StrobeState* s, u8* out, size_t n) {
  for (size_t i = 0; i < n; i++) {
    out[i] = s->st[s->pos];
    s->st[s->pos] = 0;
    if (++s->pos == STROBE_R) strobe_run_f(s);
  }
}

static void strobe_begin_op(StrobeState* s, u8 flags, int more) {
  if (more) return;  // flag equality is asserted python-side
  u8 hdr[2] = {s->pos_begin, flags};
  s->pos_begin = s->pos + 1;
  s->cur_flags = flags;
  strobe_absorb(s, hdr, 2);
  if ((flags & (FLAG_C | FLAG_K)) && s->pos != 0) strobe_run_f(s);
}

extern "C" void spartan_strobe_init(u8* buf, const u8* label, size_t n) {
  StrobeState* s = (StrobeState*)buf;
  memset(s, 0, sizeof(StrobeState));
  const u8 hdr[6] = {1, (u8)(STROBE_R + 2), 1, 0, 1, 96};
  memcpy(s->st, hdr, 6);
  memcpy(s->st + 6, "STROBEv1.0.2", 12);
  spartan_keccak_f1600(s->st);
  // meta_ad(label, false)
  strobe_begin_op(s, FLAG_M | FLAG_A, 0);
  strobe_absorb(s, label, n);
}

extern "C" void spartan_strobe_meta_ad(u8* buf, const u8* d, size_t n, int more) {
  StrobeState* s = (StrobeState*)buf;
  strobe_begin_op(s, FLAG_M | FLAG_A, more);
  strobe_absorb(s, d, n);
}

extern "C" void spartan_strobe_ad(u8* buf, const u8* d, size_t n, int more) {
  StrobeState* s = (StrobeState*)buf;
  strobe_begin_op(s, FLAG_A, more);
  strobe_absorb(s, d, n);
}

extern "C" void spartan_strobe_prf(u8* buf, u8* out, size_t n, int more) {
  StrobeState* s = (StrobeState*)buf;
  strobe_begin_op(s, FLAG_I | FLAG_A | FLAG_C, more);
  strobe_squeeze(s, out, n);
}

extern "C" void spartan_strobe_key(u8* buf, const u8* d, size_t n, int more) {
  StrobeState* s = (StrobeState*)buf;
  strobe_begin_op(s, FLAG_A | FLAG_C, more);
  strobe_overwrite(s, d, n);
}

// ===========================================================================
// fe25519: 5x51-bit limbs mod 2^255-19
// ===========================================================================

struct fe {
  u64 v[5];
};

static const u64 M51 = (1ULL << 51) - 1;

static void fe_frombytes(fe* h, const u8 s[32]) {
  u64 u0, u1, u2, u3;
  memcpy(&u0, s, 8);
  memcpy(&u1, s + 8, 8);
  memcpy(&u2, s + 16, 8);
  memcpy(&u3, s + 24, 8);
  h->v[0] = u0 & M51;
  h->v[1] = ((u0 >> 51) | (u1 << 13)) & M51;
  h->v[2] = ((u1 >> 38) | (u2 << 26)) & M51;
  h->v[3] = ((u2 >> 25) | (u3 << 39)) & M51;
  h->v[4] = (u3 >> 12) & M51;  // drops bit 255 (canonical inputs)
}

// weak carry: limbs -> < 2^51 + eps
static inline void fe_carry(fe* h) {
  u64 c;
  c = h->v[0] >> 51; h->v[0] &= M51; h->v[1] += c;
  c = h->v[1] >> 51; h->v[1] &= M51; h->v[2] += c;
  c = h->v[2] >> 51; h->v[2] &= M51; h->v[3] += c;
  c = h->v[3] >> 51; h->v[3] &= M51; h->v[4] += c;
  c = h->v[4] >> 51; h->v[4] &= M51; h->v[0] += 19 * c;
  c = h->v[0] >> 51; h->v[0] &= M51; h->v[1] += c;
}

static void fe_tobytes(u8 s[32], const fe* f) {
  fe t = *f;
  fe_carry(&t);
  fe_carry(&t);
  // compute q = floor(t / p) in {0,1}
  u64 q = (t.v[0] + 19) >> 51;
  q = (t.v[1] + q) >> 51;
  q = (t.v[2] + q) >> 51;
  q = (t.v[3] + q) >> 51;
  q = (t.v[4] + q) >> 51;
  t.v[0] += 19 * q;
  u64 c;
  c = t.v[0] >> 51; t.v[0] &= M51; t.v[1] += c;
  c = t.v[1] >> 51; t.v[1] &= M51; t.v[2] += c;
  c = t.v[2] >> 51; t.v[2] &= M51; t.v[3] += c;
  c = t.v[3] >> 51; t.v[3] &= M51; t.v[4] += c;
  t.v[4] &= M51;
  u64 u0 = t.v[0] | (t.v[1] << 51);
  u64 u1 = (t.v[1] >> 13) | (t.v[2] << 38);
  u64 u2 = (t.v[2] >> 26) | (t.v[3] << 25);
  u64 u3 = (t.v[3] >> 39) | (t.v[4] << 12);
  memcpy(s, &u0, 8);
  memcpy(s + 8, &u1, 8);
  memcpy(s + 16, &u2, 8);
  memcpy(s + 24, &u3, 8);
}

static inline void fe_add(fe* h, const fe* a, const fe* b) {
  for (int i = 0; i < 5; i++) h->v[i] = a->v[i] + b->v[i];
  fe_carry(h);
}

// 4p, so subtraction of limbs < 2^52 never underflows
static const u64 FOURP[5] = {
    4 * ((1ULL << 51) - 19), 4 * M51, 4 * M51, 4 * M51, 4 * M51};

static inline void fe_sub(fe* h, const fe* a, const fe* b) {
  for (int i = 0; i < 5; i++) h->v[i] = a->v[i] + FOURP[i] - b->v[i];
  fe_carry(h);
}

static inline void fe_neg(fe* h, const fe* a) {
  for (int i = 0; i < 5; i++) h->v[i] = FOURP[i] - a->v[i];
  fe_carry(h);
}

static void fe_mul(fe* h, const fe* f, const fe* g) {
  u64 f0 = f->v[0], f1 = f->v[1], f2 = f->v[2], f3 = f->v[3], f4 = f->v[4];
  u64 g0 = g->v[0], g1 = g->v[1], g2 = g->v[2], g3 = g->v[3], g4 = g->v[4];
  u64 g1_19 = 19 * g1, g2_19 = 19 * g2, g3_19 = 19 * g3, g4_19 = 19 * g4;
  u128 r0 = (u128)f0 * g0 + (u128)f1 * g4_19 + (u128)f2 * g3_19 +
            (u128)f3 * g2_19 + (u128)f4 * g1_19;
  u128 r1 = (u128)f0 * g1 + (u128)f1 * g0 + (u128)f2 * g4_19 +
            (u128)f3 * g3_19 + (u128)f4 * g2_19;
  u128 r2 = (u128)f0 * g2 + (u128)f1 * g1 + (u128)f2 * g0 +
            (u128)f3 * g4_19 + (u128)f4 * g3_19;
  u128 r3 = (u128)f0 * g3 + (u128)f1 * g2 + (u128)f2 * g1 +
            (u128)f3 * g0 + (u128)f4 * g4_19;
  u128 r4 = (u128)f0 * g4 + (u128)f1 * g3 + (u128)f2 * g2 +
            (u128)f3 * g1 + (u128)f4 * g0;
  u64 c;
  u64 h0 = (u64)r0 & M51; c = (u64)(r0 >> 51); r1 += c;
  u64 h1 = (u64)r1 & M51; c = (u64)(r1 >> 51); r2 += c;
  u64 h2 = (u64)r2 & M51; c = (u64)(r2 >> 51); r3 += c;
  u64 h3 = (u64)r3 & M51; c = (u64)(r3 >> 51); r4 += c;
  u64 h4 = (u64)r4 & M51; c = (u64)(r4 >> 51);
  h0 += 19 * c;
  c = h0 >> 51; h0 &= M51; h1 += c;
  h->v[0] = h0; h->v[1] = h1; h->v[2] = h2; h->v[3] = h3; h->v[4] = h4;
}

static inline void fe_sq(fe* h, const fe* f) { fe_mul(h, f, f); }

static void fe_sqn(fe* h, const fe* f, int n) {
  fe t = *f;
  for (int i = 0; i < n; i++) fe_sq(&t, &t);
  *h = t;
}

static void fe_one(fe* h) { h->v[0] = 1; h->v[1] = h->v[2] = h->v[3] = h->v[4] = 0; }
static void fe_zero(fe* h) { memset(h->v, 0, sizeof(h->v)); }

// z^(2^250-1) shared tail used by both invert and pow22523 (ref10 chain)
static void fe_pow_2_250_minus_1(fe* out, fe* t0_out, const fe* z) {
  fe t0, t1, t2, t3;
  fe_sq(&t0, z);                       // 2
  fe_sq(&t1, &t0); fe_sq(&t1, &t1);    // 8
  fe_mul(&t1, z, &t1);                 // 9
  fe_mul(&t0, &t0, &t1);               // 11
  fe_sq(&t2, &t0);                     // 22
  fe_mul(&t1, &t1, &t2);               // 31 = 2^5-1
  fe_sqn(&t2, &t1, 5);                 // 2^10-2^5
  fe_mul(&t1, &t2, &t1);               // 2^10-1
  fe_sqn(&t2, &t1, 10);
  fe_mul(&t2, &t2, &t1);               // 2^20-1
  fe_sqn(&t3, &t2, 20);
  fe_mul(&t2, &t3, &t2);               // 2^40-1
  fe_sqn(&t2, &t2, 10);
  fe_mul(&t1, &t2, &t1);               // 2^50-1
  fe_sqn(&t2, &t1, 50);
  fe_mul(&t2, &t2, &t1);               // 2^100-1
  fe_sqn(&t3, &t2, 100);
  fe_mul(&t2, &t3, &t2);               // 2^200-1
  fe_sqn(&t2, &t2, 50);
  fe_mul(out, &t2, &t1);               // 2^250-1
  *t0_out = t0;                        // z^11, reused by invert
}

static void fe_invert(fe* out, const fe* z) {
  fe t, t0;
  fe_pow_2_250_minus_1(&t, &t0, z);
  fe_sqn(&t, &t, 5);                   // 2^255-2^5
  fe_mul(out, &t, &t0);                // 2^255-21 = p-2
}

static void fe_pow22523(fe* out, const fe* z) {
  fe t, t0;
  fe_pow_2_250_minus_1(&t, &t0, z);
  fe_sqn(&t, &t, 2);                   // 2^252-4
  fe_mul(out, &t, z);                  // 2^252-3
}

static int fe_isnegative(const fe* f) {
  u8 s[32];
  fe_tobytes(s, f);
  return s[0] & 1;
}

static int fe_iszero(const fe* f) {
  u8 s[32];
  fe_tobytes(s, f);
  for (int i = 0; i < 32; i++)
    if (s[i]) return 0;
  return 1;
}

static int fe_eq(const fe* a, const fe* b) {
  fe d;
  fe_sub(&d, a, b);
  return fe_iszero(&d);
}

static void fe_abs(fe* h, const fe* f) {
  if (fe_isnegative(f)) fe_neg(h, f);
  else *h = *f;
}

// ---------------------------------------------------------------------------
// curve constants (initialized from canonical little-endian bytes)
// ---------------------------------------------------------------------------

static fe FE_D, FE_D2, FE_SQRT_M1, FE_SQRT_AD_MINUS_ONE, FE_INVSQRT_A_MINUS_D,
    FE_ONE_MINUS_D_SQ, FE_D_MINUS_ONE_SQ;

static void hex32(fe* out, const char* hex) {
  u8 b[32];
  for (int i = 0; i < 32; i++) {
    auto nyb = [](char c) -> int {
      return c <= '9' ? c - '0' : c - 'a' + 10;
    };
    b[i] = (u8)((nyb(hex[2 * i]) << 4) | nyb(hex[2 * i + 1]));
  }
  fe_frombytes(out, b);
}

static struct ConstInit {
  ConstInit() {
    hex32(&FE_D,
          "a3785913ca4deb75abd841414d0a700098e879777940c78c73fe6f2bee6c0352");
    fe_add(&FE_D2, &FE_D, &FE_D);
    hex32(&FE_SQRT_M1,
          "b0a00e4a271beec478e42fad0618432fa7d7fb3d99004d2b0bdfc14f8024832b");
    hex32(&FE_SQRT_AD_MINUS_ONE,
          "1b2e7b49a0f6977ebd54781b0c8e9daffdd1f531c9fc3c0fac48832bbf316937");
    hex32(&FE_INVSQRT_A_MINUS_D,
          "ea405d80aafdc899be72415a17162f9d40d801fe917bc216a2fcafcf05896c78");
    hex32(&FE_ONE_MINUS_D_SQ,
          "76c15f94c1097ce20f355ecd38a1812ce4df70beddab9499d7e0b3b2a8729002");
    hex32(&FE_D_MINUS_ONE_SQ,
          "204ded44aa5aad3199191eb02c4a9ed2eb4e9b522fd3dc4c41226cf67ab36859");
  }
} _const_init;

// sqrt_ratio_m1 (RFC 9496 §4.2): returns was_square; r = sqrt(u/v) variant
static int fe_sqrt_ratio_m1(fe* r, const fe* u, const fe* v) {
  fe v3, v7, t, check, u_neg, u_neg_i, r_prime;
  fe_sq(&v3, v);
  fe_mul(&v3, &v3, v);           // v^3
  fe_sq(&v7, &v3);
  fe_mul(&v7, &v7, v);           // v^7
  fe_mul(&t, u, &v7);
  fe_pow22523(&t, &t);           // (u v^7)^((p-5)/8)
  fe_mul(r, u, &v3);
  fe_mul(r, r, &t);              // u v^3 (u v^7)^((p-5)/8)
  fe_sq(&check, r);
  fe_mul(&check, &check, v);     // v r^2
  fe_neg(&u_neg, u);
  fe_mul(&u_neg_i, &u_neg, &FE_SQRT_M1);
  int correct = fe_eq(&check, u);
  int flipped = fe_eq(&check, &u_neg);
  int flipped_i = fe_eq(&check, &u_neg_i);
  fe_mul(&r_prime, r, &FE_SQRT_M1);
  if (flipped | flipped_i) *r = r_prime;
  fe_abs(r, r);
  return correct | flipped;
}

// ===========================================================================
// ge25519: extended coordinates (X:Y:Z:T), a = -1
// ===========================================================================

struct ge {
  fe X, Y, Z, T;
};

static void ge_identity(ge* h) {
  fe_zero(&h->X);
  fe_one(&h->Y);
  fe_one(&h->Z);
  fe_zero(&h->T);
}

// add-2008-hwcd-3 (unified)
static void ge_add(ge* r, const ge* p, const ge* q) {
  fe A, B, C, D, E, F, G, H, t0, t1;
  fe_sub(&t0, &p->Y, &p->X);
  fe_sub(&t1, &q->Y, &q->X);
  fe_mul(&A, &t0, &t1);
  fe_add(&t0, &p->Y, &p->X);
  fe_add(&t1, &q->Y, &q->X);
  fe_mul(&B, &t0, &t1);
  fe_mul(&C, &p->T, &FE_D2);
  fe_mul(&C, &C, &q->T);
  fe_add(&t0, &p->Z, &p->Z);
  fe_mul(&D, &t0, &q->Z);
  fe_sub(&E, &B, &A);
  fe_sub(&F, &D, &C);
  fe_add(&G, &D, &C);
  fe_add(&H, &B, &A);
  fe_mul(&r->X, &E, &F);
  fe_mul(&r->Y, &G, &H);
  fe_mul(&r->Z, &F, &G);
  fe_mul(&r->T, &E, &H);
}

// dbl-2008-hwcd, a = -1
static void ge_double(ge* r, const ge* p) {
  fe A, B, C, D, E, F, G, H, t0;
  fe_sq(&A, &p->X);
  fe_sq(&B, &p->Y);
  fe_sq(&C, &p->Z);
  fe_add(&C, &C, &C);
  fe_neg(&D, &A);
  fe_add(&t0, &p->X, &p->Y);
  fe_sq(&t0, &t0);
  fe_sub(&t0, &t0, &A);
  fe_sub(&E, &t0, &B);
  fe_add(&G, &D, &B);
  fe_sub(&F, &G, &C);
  fe_sub(&H, &D, &B);
  fe_mul(&r->X, &E, &F);
  fe_mul(&r->Y, &G, &H);
  fe_mul(&r->Z, &F, &G);
  fe_mul(&r->T, &E, &H);
}

static void ge_neg(ge* r, const ge* p) {
  fe_neg(&r->X, &p->X);
  r->Y = p->Y;
  r->Z = p->Z;
  fe_neg(&r->T, &p->T);
}

// blob <-> ge  (blob = X|Y|Z|T, 32 canonical bytes each)
static void ge_fromblob(ge* h, const u8* blob) {
  fe_frombytes(&h->X, blob);
  fe_frombytes(&h->Y, blob + 32);
  fe_frombytes(&h->Z, blob + 64);
  fe_frombytes(&h->T, blob + 96);
}

static void ge_toblob(u8* blob, const ge* p) {
  fe_tobytes(blob, &p->X);
  fe_tobytes(blob + 32, &p->Y);
  fe_tobytes(blob + 64, &p->Z);
  fe_tobytes(blob + 96, &p->T);
}

extern "C" void spartan_ge_add(const u8* a, const u8* b, u8* out) {
  ge p, q, r;
  ge_fromblob(&p, a);
  ge_fromblob(&q, b);
  ge_add(&r, &p, &q);
  ge_toblob(out, &r);
}

extern "C" void spartan_ge_double(const u8* a, u8* out) {
  ge p, r;
  ge_fromblob(&p, a);
  ge_double(&r, &p);
  ge_toblob(out, &r);
}

extern "C" void spartan_ge_neg(const u8* a, u8* out) {
  ge p, r;
  ge_fromblob(&p, a);
  ge_neg(&r, &p);
  ge_toblob(out, &r);
}

// vartime scalar mul: 4-bit fixed window
static void ge_scalarmul(ge* r, const ge* p, const u8 sc[32]) {
  ge table[16];
  ge_identity(&table[0]);
  table[1] = *p;
  for (int i = 2; i < 16; i += 2) {
    ge_double(&table[i], &table[i / 2]);
    ge_add(&table[i + 1], &table[i], p);
  }
  ge acc;
  ge_identity(&acc);
  int started = 0;
  for (int i = 31; i >= 0; i--) {
    for (int half = 1; half >= 0; half--) {
      int nib = half ? (sc[i] >> 4) : (sc[i] & 0xF);
      if (started) {
        ge_double(&acc, &acc);
        ge_double(&acc, &acc);
        ge_double(&acc, &acc);
        ge_double(&acc, &acc);
      }
      if (nib) {
        if (started) ge_add(&acc, &acc, &table[nib]);
        else { acc = table[nib]; started = 1; }
      } else if (!started) {
        continue;
      }
    }
  }
  if (!started) ge_identity(&acc);
  *r = acc;
}

extern "C" void spartan_ge_scalarmul(const u8* pt, const u8* sc, u8* out) {
  ge p, r;
  ge_fromblob(&p, pt);
  ge_scalarmul(&r, &p, sc);
  ge_toblob(out, &r);
}

// ---------------------------------------------------------------------------
// Constant-time scalar mul / MSM for SECRET scalars (blinds and committed
// round-poly coefficients).  The reference keeps constant-time Scalar
// arithmetic via `subtle` (ristretto255.rs:218-243) while committing with
// vartime MSM; the analogue here: control flow and memory access are
// independent of the scalar — 64 fixed window iterations of 4 doublings
// plus ONE unified add of a table entry chosen by a branch-free masked
// scan over all 16 entries (index 0 holds the identity, so zero nibbles
// are a uniform identity-add; ge_add is a complete unified Edwards
// formula, valid for identity and doubling inputs alike).
// ---------------------------------------------------------------------------

static inline void fe_cmov(fe* r, const fe* a, u64 mask) {
  for (int i = 0; i < 5; i++) r->v[i] ^= mask & (r->v[i] ^ a->v[i]);
}

static inline void ge_cmov(ge* r, const ge* a, u64 mask) {
  fe_cmov(&r->X, &a->X, mask);
  fe_cmov(&r->Y, &a->Y, mask);
  fe_cmov(&r->Z, &a->Z, mask);
  fe_cmov(&r->T, &a->T, mask);
}

// r = table[nib] without a secret-indexed load: scan all entries, masked
static void ge_select_ct(ge* r, const ge table[16], unsigned nib) {
  *r = table[0];
  for (unsigned j = 1; j < 16; j++) {
    u64 mask = (u64)((int64_t)((u64)(nib ^ j) - 1) >> 63);  // all-ones iff j==nib
    ge_cmov(r, &table[j], mask);
  }
}

static void ge_scalarmul_ct(ge* r, const ge* p, const u8 sc[32]) {
  ge table[16];
  ge_identity(&table[0]);
  table[1] = *p;
  for (int i = 2; i < 16; i += 2) {
    ge_double(&table[i], &table[i / 2]);
    ge_add(&table[i + 1], &table[i], p);
  }
  ge acc;
  ge_identity(&acc);
  for (int i = 31; i >= 0; i--) {
    for (int half = 1; half >= 0; half--) {
      unsigned nib = half ? (sc[i] >> 4) : (sc[i] & 0xF);
      ge_double(&acc, &acc);
      ge_double(&acc, &acc);
      ge_double(&acc, &acc);
      ge_double(&acc, &acc);
      ge t;
      ge_select_ct(&t, table, nib);
      ge_add(&acc, &acc, &t);
    }
  }
  *r = acc;
}

extern "C" void spartan_ge_scalarmul_ct(const u8* pt, const u8* sc, u8* out) {
  ge p, r;
  ge_fromblob(&p, pt);
  ge_scalarmul_ct(&r, &p, sc);
  ge_toblob(out, &r);
}

// small-n constant-time MSM: pts = n*128 bytes, scalars = n*32 bytes.
// Cost is n * (256 doublings + 64 adds) — meant for the <= 8-term
// blind-bearing Pedersen commitments, not bulk (public-base) MSM.
extern "C" void spartan_ge_msm_ct(const u8* pts, const u8* scalars, size_t n,
                                  u8* out) {
  ge r;
  ge_identity(&r);
  for (size_t i = 0; i < n; i++) {
    ge p, t;
    ge_fromblob(&p, pts + 128 * i);
    ge_scalarmul_ct(&t, &p, scalars + 32 * i);
    ge_add(&r, &r, &t);
  }
  ge_toblob(out, &r);
}

// ---------------------------------------------------------------------------
// vartime Pippenger MSM (dense_mlpoly.rs:148-162 / group.rs:98-117 workload)
//
// Design (vs the round-1 textbook version, measured ~4x faster):
//   * inputs batch-normalized once to affine Niels form (Y+X, Y-X, 2dXY;
//     Z == 1) with one shared Montgomery batch inversion -> every bucket
//     accumulation is a 7-mul mixed add instead of a 9-mul unified add
//   * signed digits in [-2^(c-1), 2^(c-1)] -> half the buckets per window
//     (point negation is free in Niels form: swap Y+X/Y-X, negate 2dXY)
//   * window width c chosen by the measured cost model per call
// ---------------------------------------------------------------------------

// affine Niels point (Z == 1)
struct genl {
  fe YpX, YmX, T2d;
};

// carry-free add/sub for the mixed-add hot path (lazy reduction): inputs
// are mul outputs (limbs < 2^52) or one add/sub thereof (< 2^54); fe_mul
// tolerates limbs up to ~2^54 (19*g < 2^58.6, 5 u128 terms < 2^113.6).
static inline void fe_add_nr(fe* h, const fe* a, const fe* b) {
  for (int i = 0; i < 5; i++) h->v[i] = a->v[i] + b->v[i];
}
static inline void fe_sub_nr(fe* h, const fe* a, const fe* b) {
  for (int i = 0; i < 5; i++) h->v[i] = a->v[i] + FOURP[i] - b->v[i];
}

// r = p + q, q affine Niels: 7 muls, lazy-reduced adds
static inline void ge_madd(ge* r, const ge* p, const genl* q) {
  fe A, B, C, D, E, F, G, H, t0, t1;
  fe_sub_nr(&t0, &p->Y, &p->X);
  fe_mul(&A, &t0, &q->YmX);
  fe_add_nr(&t1, &p->Y, &p->X);
  fe_mul(&B, &t1, &q->YpX);
  fe_mul(&C, &p->T, &q->T2d);
  fe_add_nr(&D, &p->Z, &p->Z);
  fe_sub_nr(&E, &B, &A);
  fe_sub_nr(&F, &D, &C);
  fe_add_nr(&G, &D, &C);
  fe_add_nr(&H, &B, &A);
  fe_mul(&r->X, &E, &F);
  fe_mul(&r->Y, &G, &H);
  fe_mul(&r->Z, &F, &G);
  fe_mul(&r->T, &E, &H);
}

// r = p - q, q affine Niels: swap YpX/YmX and flip the sign of C
static inline void ge_msub(ge* r, const ge* p, const genl* q) {
  fe A, B, C, D, E, F, G, H, t0, t1;
  fe_sub_nr(&t0, &p->Y, &p->X);
  fe_mul(&A, &t0, &q->YpX);
  fe_add_nr(&t1, &p->Y, &p->X);
  fe_mul(&B, &t1, &q->YmX);
  fe_mul(&C, &p->T, &q->T2d);
  fe_add_nr(&D, &p->Z, &p->Z);
  fe_sub_nr(&E, &B, &A);
  fe_add_nr(&F, &D, &C);
  fe_sub_nr(&G, &D, &C);
  fe_add_nr(&H, &B, &A);
  fe_mul(&r->X, &E, &F);
  fe_mul(&r->Y, &G, &H);
  fe_mul(&r->Z, &F, &G);
  fe_mul(&r->T, &E, &H);
}

// batch-normalize n extended points to affine Niels (one field inversion)
static void ge_batch_to_niels(const ge* P, size_t n, genl* out) {
  std::vector<fe> pre(n);
  fe acc;
  fe_one(&acc);
  for (size_t i = 0; i < n; i++) {
    pre[i] = acc;
    fe_mul(&acc, &acc, &P[i].Z);
  }
  fe inv;
  fe_invert(&inv, &acc);
  for (size_t i = n; i-- > 0;) {
    fe zi, x, y, t;
    fe_mul(&zi, &inv, &pre[i]);
    fe_mul(&inv, &inv, &P[i].Z);
    fe_mul(&x, &P[i].X, &zi);
    fe_mul(&y, &P[i].Y, &zi);
    fe_mul(&t, &P[i].T, &zi);  // t = xy since T = XY/Z
    fe_add(&out[i].YpX, &y, &x);
    fe_sub(&out[i].YmX, &y, &x);
    fe_mul(&out[i].T2d, &t, &FE_D2);
  }
}

// vartime Pippenger MSM: pts = n*128 bytes, scalars = n*32 bytes
extern "C" void spartan_ge_msm(const u8* pts, const u8* scalars, size_t n,
                               u8* out) {
  ge r;
  ge_identity(&r);
  if (n == 0) { ge_toblob(out, &r); return; }
  std::vector<ge> P(n);
  for (size_t i = 0; i < n; i++) ge_fromblob(&P[i], pts + 128 * i);
  std::vector<genl> N(n);
  ge_batch_to_niels(P.data(), n, N.data());

  // window width: minimize windows*(n mixed adds + 2*2^(c-1) full adds);
  // capped at 14 — beyond that the 2^(c-1)*160 B bucket set falls out of
  // L2 and random-access misses cost more than the saved windows
  int c = 2;
  double best = 1e30;
  for (int cc = 2; cc <= 14; cc++) {
    double w = (double)((256 + cc - 1) / cc + 1);
    double cost = w * (n * 7.0 + (double)(1ULL << (cc - 1)) * 2 * 9.0);
    if (cost < best) { best = cost; c = cc; }
  }
  const char* cenv = getenv("SPARTAN_TPU_HOST_MSM_C");
  if (cenv && atoi(cenv) >= 2 && atoi(cenv) <= 15) c = atoi(cenv);  // int16 digits

  // signed-digit recoding: digits in [-2^(c-1), 2^(c-1)], any 256-bit
  // value; stored WINDOW-MAJOR so each Pippenger pass streams its column
  int nwin = (256 + c - 1) / c + 1;  // +1: carry out of the top window
  std::vector<int16_t> dig((size_t)nwin * n);
  int topw = 0;  // highest window with any nonzero digit
  const u64 half = 1ULL << (c - 1), full = 1ULL << c;
  for (size_t i = 0; i < n; i++) {
    const u8* sc = scalars + 32 * i;
    u64 carry = 0;
    for (int w = 0; w < nwin; w++) {
      int bit0 = w * c;
      u64 word = 0;
      int byte = bit0 >> 3, shift = bit0 & 7;
      for (int b = 0; b < 8 && byte + b < 32; b++)
        word |= (u64)sc[byte + b] << (8 * b);
      u64 d = ((word >> shift) & (full - 1)) + carry;
      int32_t v;
      if (d > half) { v = (int32_t)d - (int32_t)full; carry = 1; }
      else { v = (int32_t)d; carry = 0; }
      dig[(size_t)w * n + i] = (int16_t)v;
      if (v && w > topw) topw = w;
    }
  }

  size_t nbuckets = half;
  std::vector<ge> buckets(nbuckets);
  std::vector<u8> used(nbuckets);

  int started = 0;
  for (int w = topw; w >= 0; w--) {
    if (started)
      for (int k = 0; k < c; k++) ge_double(&r, &r);
    memset(used.data(), 0, nbuckets);
    const int16_t* dw = &dig[(size_t)w * n];
    for (size_t i = 0; i < n; i++) {
      int32_t d = dw[i];
      if (!d) continue;
      size_t idx = (size_t)(d < 0 ? -d : d) - 1;
      if (used[idx]) {
        if (d > 0) ge_madd(&buckets[idx], &buckets[idx], &N[i]);
        else ge_msub(&buckets[idx], &buckets[idx], &N[i]);
      } else {
        if (d > 0) buckets[idx] = P[i];
        else ge_neg(&buckets[idx], &P[i]);
        used[idx] = 1;
      }
    }
    // suffix-sum buckets: sum_d d*B_d
    ge running, total;
    int have_run = 0, have_tot = 0;
    for (size_t d = nbuckets; d-- > 0;) {
      if (used[d]) {
        if (have_run) ge_add(&running, &running, &buckets[d]);
        else { running = buckets[d]; have_run = 1; }
      }
      if (have_run) {
        if (have_tot) ge_add(&total, &total, &running);
        else { total = running; have_tot = 1; }
      }
    }
    if (have_tot) {
      if (started) ge_add(&r, &r, &total);
      else { r = total; started = 1; }
    }
  }
  ge_toblob(out, &r);
}

// The row-MSM's table: out holds 16 x n entries, entry (d, i) at
// 96 * (d * n + i), of d * P_i in the precomputed affine form
// (y+x | y-x | 2d*x*y), 32 canonical bytes each; d = 0 is (1, 1, 0).
// The multiples come from chained unified adds, normalised with one
// batched inversion.
extern "C" void spartan_ge_table_niels(const u8* pts, size_t n, u8* out) {
  std::vector<ge> M(16 * n);
  for (size_t i = 0; i < n; i++) {
    ge_identity(&M[i]);
    ge_fromblob(&M[n + i], pts + 128 * i);
    for (size_t d = 2; d < 16; d++)
      ge_add(&M[d * n + i], &M[(d - 1) * n + i], &M[n + i]);
  }
  std::vector<genl> N(16 * n);
  ge_batch_to_niels(M.data(), 16 * n, N.data());
  for (size_t k = 0; k < 16 * n; k++) {
    fe_tobytes(out + 96 * k, &N[k].YpX);
    fe_tobytes(out + 96 * k + 32, &N[k].YmX);
    fe_tobytes(out + 96 * k + 64, &N[k].T2d);
  }
}

// bench helper: out[i] = (i+1) * base, n blobs of 128 bytes.  MSM cost is
// independent of the point VALUES (vartime only in scalar digits), so
// sequential multiples are an honest generator stand-in and derive in
// milliseconds instead of the minutes hash-to-group costs at 2^20.
extern "C" void spartan_ge_seq_points(const u8* base, size_t n, u8* out) {
  ge b, acc;
  ge_fromblob(&b, base);
  acc = b;
  for (size_t i = 0; i < n; i++) {
    ge_toblob(out + 128 * i, &acc);
    ge_add(&acc, &acc, &b);
  }
}

// ===========================================================================
// ristretto255 codec (RFC 9496)
// ===========================================================================

extern "C" int spartan_ristretto_decode(const u8 in[32], u8* out_blob) {
  // canonical check: s < p and nonnegative
  fe s;
  fe_frombytes(&s, in);
  u8 chk[32];
  fe_tobytes(chk, &s);
  if (memcmp(chk, in, 32) != 0) return -1;  // non-canonical (incl. bit 255)
  if (in[0] & 1) return -1;                 // negative

  fe ss, u1, u2, u2_sqr, v, one, invsqrt, den_x, den_y, x, y, t;
  fe_one(&one);
  fe_sq(&ss, &s);
  fe_sub(&u1, &one, &ss);
  fe_add(&u2, &one, &ss);
  fe_sq(&u2_sqr, &u2);
  // v = -(D*u1^2) - u2^2
  fe t0;
  fe_sq(&t0, &u1);
  fe_mul(&t0, &t0, &FE_D);
  fe_neg(&v, &t0);
  fe_sub(&v, &v, &u2_sqr);
  fe vu2;
  fe_mul(&vu2, &v, &u2_sqr);
  int was_square = fe_sqrt_ratio_m1(&invsqrt, &one, &vu2);
  fe_mul(&den_x, &invsqrt, &u2);
  fe_mul(&den_y, &invsqrt, &den_x);
  fe_mul(&den_y, &den_y, &v);
  fe_add(&t0, &s, &s);
  fe_mul(&x, &t0, &den_x);
  fe_abs(&x, &x);
  fe_mul(&y, &u1, &den_y);
  fe_mul(&t, &x, &y);
  if (!was_square || fe_isnegative(&t) || fe_iszero(&y)) return -1;
  ge p;
  p.X = x; p.Y = y; fe_one(&p.Z); p.T = t;
  ge_toblob(out_blob, &p);
  return 0;
}

extern "C" void spartan_ristretto_encode(const u8* blob, u8 out[32]) {
  ge p;
  ge_fromblob(&p, blob);
  fe u1, u2, t0, one, invsqrt, den1, den2, z_inv, ix0, iy0, ench, x, y, den_inv, s;
  fe_one(&one);
  fe_add(&t0, &p.Z, &p.Y);
  fe_sub(&u1, &p.Z, &p.Y);
  fe_mul(&u1, &t0, &u1);              // (Z+Y)(Z-Y)
  fe_mul(&u2, &p.X, &p.Y);
  fe_sq(&t0, &u2);
  fe_mul(&t0, &t0, &u1);              // u1 * u2^2
  fe_sqrt_ratio_m1(&invsqrt, &one, &t0);
  fe_mul(&den1, &invsqrt, &u1);
  fe_mul(&den2, &invsqrt, &u2);
  fe_mul(&z_inv, &den1, &den2);
  fe_mul(&z_inv, &z_inv, &p.T);
  fe_mul(&ix0, &p.X, &FE_SQRT_M1);
  fe_mul(&iy0, &p.Y, &FE_SQRT_M1);
  fe_mul(&ench, &den1, &FE_INVSQRT_A_MINUS_D);
  fe_mul(&t0, &p.T, &z_inv);
  if (fe_isnegative(&t0)) {
    x = iy0; y = ix0; den_inv = ench;
  } else {
    x = p.X; y = p.Y; den_inv = den2;
  }
  fe_mul(&t0, &x, &z_inv);
  if (fe_isnegative(&t0)) fe_neg(&y, &y);
  fe_sub(&t0, &p.Z, &y);
  fe_mul(&s, &den_inv, &t0);
  fe_abs(&s, &s);
  fe_tobytes(out, &s);
}

// batch encode: n blobs -> n*32 bytes
extern "C" void spartan_ristretto_encode_batch(const u8* blobs, size_t n,
                                               u8* out) {
  for (size_t i = 0; i < n; i++)
    spartan_ristretto_encode(blobs + 128 * i, out + 32 * i);
}

// elligator one-way map: 64 uniform bytes -> point blob (RFC 9496 §4.3.4)
static void elligator(ge* out, const fe* t) {
  fe r, u, v, s, s_prime, c, N, w0, w1, w2, w3, one, t0, t1;
  fe_one(&one);
  fe_sq(&r, t);
  fe_mul(&r, &r, &FE_SQRT_M1);        // r = sqrt(-1) t^2
  fe_add(&t0, &r, &one);
  fe_mul(&u, &t0, &FE_ONE_MINUS_D_SQ);
  // v = (-1 - r*D) * (r + D)
  fe_mul(&t0, &r, &FE_D);
  fe_add(&t0, &t0, &one);
  fe_neg(&t0, &t0);
  fe_add(&t1, &r, &FE_D);
  fe_mul(&v, &t0, &t1);
  int was_square = fe_sqrt_ratio_m1(&s, &u, &v);
  fe_mul(&s_prime, &s, t);
  fe_abs(&s_prime, &s_prime);
  fe_neg(&s_prime, &s_prime);
  if (!was_square) { s = s_prime; c = r; }
  else { fe_neg(&c, &one); }
  // N = c (r-1) D_MINUS_ONE_SQ - v
  fe_sub(&t0, &r, &one);
  fe_mul(&t0, &c, &t0);
  fe_mul(&t0, &t0, &FE_D_MINUS_ONE_SQ);
  fe_sub(&N, &t0, &v);
  fe_add(&t0, &s, &s);
  fe_mul(&w0, &t0, &v);
  fe_mul(&w1, &N, &FE_SQRT_AD_MINUS_ONE);
  fe_sq(&t0, &s);
  fe_sub(&w2, &one, &t0);
  fe_add(&w3, &one, &t0);
  fe_mul(&out->X, &w0, &w3);
  fe_mul(&out->Y, &w2, &w1);
  fe_mul(&out->Z, &w1, &w3);
  fe_mul(&out->T, &w0, &w2);
}

extern "C" void spartan_ristretto_from_uniform(const u8 in[64], u8* out_blob) {
  u8 half[32];
  fe t0, t1;
  memcpy(half, in, 32);
  half[31] &= 0x7F;
  fe_frombytes(&t0, half);
  memcpy(half, in + 32, 32);
  half[31] &= 0x7F;
  fe_frombytes(&t1, half);
  ge p0, p1, r;
  elligator(&p0, &t0);
  elligator(&p1, &t1);
  ge_add(&r, &p0, &p1);
  ge_toblob(out_blob, &r);
}

// ---------------------------------------------------------------------------
// Scalar field Fq, q = 2^252 + 27742317777372353535851937790883648493
// (ristretto255 group order).  4x u64 limbs, Montgomery form (R = 2^256),
// textbook CIOS multiplication with unsigned __int128 — the host-side
// batch arithmetic behind the verifier's eval_sparse_polys
// (reference r1cs.rs:300-303): latency-bound public-data work that
// should never wait on an XLA compile.
// ---------------------------------------------------------------------------

typedef unsigned __int128 u128;

struct fq { u64 v[4]; };

static const fq FQ_Q = {{0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                         0x0ULL, 0x1000000000000000ULL}};
static const u64 FQ_INV = 0xd2b51da312547e1bULL;  // -q^-1 mod 2^64
static const fq FQ_R2 = {{0xa40611e3449c0f01ULL, 0xd00e1ba768859347ULL,
                          0xceec73d217f5be65ULL, 0x0399411b7c309a3dULL}};
static const fq FQ_ONE_M = {{0xd6ec31748d98951dULL, 0xc6ef5bf4737dcf70ULL,
                             0xfffffffffffffffeULL, 0x0fffffffffffffffULL}};

static inline void fq_cond_sub_q(fq* a) {
  // a -= q if a >= q (a < 2q on entry)
  u64 b[4]; u128 brw = 0;
  for (int i = 0; i < 4; i++) {
    u128 d = (u128)a->v[i] - FQ_Q.v[i] - (u64)brw;
    b[i] = (u64)d;
    brw = (d >> 64) & 1;  // 1 if borrow
  }
  if (!brw) for (int i = 0; i < 4; i++) a->v[i] = b[i];
}

static void fq_mont_mul(fq* out, const fq* a, const fq* b) {
  // CIOS: t has 5 limbs; one reduction step per a-limb.
  u64 t[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < 4; i++) {
    u128 c = 0;
    for (int j = 0; j < 4; j++) {
      u128 s = (u128)t[j] + (u128)a->v[i] * b->v[j] + (u64)c;
      t[j] = (u64)s;
      c = s >> 64;
    }
    u128 s4 = (u128)t[4] + (u64)c;
    u64 t5 = (u64)(s4 >> 64);
    t[4] = (u64)s4;
    u64 m = t[0] * FQ_INV;
    c = ((u128)t[0] + (u128)m * FQ_Q.v[0]) >> 64;
    for (int j = 1; j < 4; j++) {
      u128 s = (u128)t[j] + (u128)m * FQ_Q.v[j] + (u64)c;
      t[j - 1] = (u64)s;
      c = s >> 64;
    }
    u128 s = (u128)t[4] + (u64)c;
    t[3] = (u64)s;
    t[4] = t5 + (u64)(s >> 64);
  }
  for (int i = 0; i < 4; i++) out->v[i] = t[i];
  fq_cond_sub_q(out);  // t[4] is 0 here: a,b < q => result < 2q
}

static inline void fq_add(fq* out, const fq* a, const fq* b) {
  u128 c = 0;
  for (int i = 0; i < 4; i++) {
    u128 s = (u128)a->v[i] + b->v[i] + (u64)c;
    out->v[i] = (u64)s;
    c = s >> 64;
  }
  fq_cond_sub_q(out);
}

static inline void fq_sub(fq* out, const fq* a, const fq* b) {
  u128 brw = 0;
  for (int i = 0; i < 4; i++) {
    u128 d = (u128)a->v[i] - b->v[i] - (u64)brw;
    out->v[i] = (u64)d;
    brw = (d >> 64) & 1;
  }
  if (brw) {
    u128 c = 0;
    for (int i = 0; i < 4; i++) {
      u128 s = (u128)out->v[i] + FQ_Q.v[i] + (u64)c;
      out->v[i] = (u64)s;
      c = s >> 64;
    }
  }
}

// Bytes are 32 B little-endian.  to_mont multiplies by R^2; from_mont
// multiplies by 1.
static inline void fq_frombytes(fq* out, const u8* p) {
  for (int i = 0; i < 4; i++) {
    u64 v = 0;
    for (int j = 7; j >= 0; j--) v = (v << 8) | p[i * 8 + j];
    out->v[i] = v;
  }
}

static inline void fq_tobytes(u8* p, const fq* a) {
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 8; j++) p[i * 8 + j] = (u8)(a->v[i] >> (8 * j));
}

// eq(r, x) table over the Boolean hypercube, MSB-first (r[0] is the
// top variable — dense_mlpoly.rs:68-84 ordering): out has 2^ell
// 32-byte Montgomery-form entries.  Inputs r are PLAIN 32-byte LE
// scalars; the table doubles in place per variable.
extern "C" void spartan_fq_eq_evals(const u8* r_bytes, size_t ell,
                                    u8* out) {
  size_t n = (size_t)1 << ell;
  fq* tab = new fq[n];
  tab[0] = FQ_ONE_M;
  size_t sz = 1;
  for (size_t j = 0; j < ell; j++) {
    fq rj, rj_m, one_minus;
    fq_frombytes(&rj, r_bytes + 32 * j);
    fq_mont_mul(&rj_m, &rj, &FQ_R2);
    fq_sub(&one_minus, &FQ_ONE_M, &rj_m);
    for (size_t i = sz; i-- > 0;) {
      fq lo, hi;
      fq_mont_mul(&hi, &tab[i], &rj_m);
      fq_mont_mul(&lo, &tab[i], &one_minus);
      tab[2 * i] = lo;
      tab[2 * i + 1] = hi;
    }
    sz *= 2;
  }
  for (size_t i = 0; i < n; i++) fq_tobytes(out + 32 * i, &tab[i]);
  delete[] tab;
}

// sum_k eq_rx[rows[k]] * eq_ry[cols[k]] * vals[k]: the verifier's
// sparse-poly evaluation (sparse_mlpoly.rs:440-452).  eq tables and
// vals are Montgomery-form 32-byte LE entries (vals straight from the
// device limb arrays, which store v*R mod q); the result is a PLAIN
// 32-byte LE scalar.
extern "C" void spartan_fq_sparse_eval(const u8* eq_rx, const u8* eq_ry,
                                       const u64* rows, const u64* cols,
                                       const u8* vals, size_t nnz,
                                       u8* out32) {
  fq acc = {{0, 0, 0, 0}};
  for (size_t k = 0; k < nnz; k++) {
    fq a, b, v, t;
    fq_frombytes(&a, eq_rx + 32 * rows[k]);
    fq_frombytes(&b, eq_ry + 32 * cols[k]);
    fq_frombytes(&v, vals + 32 * k);
    fq_mont_mul(&t, &a, &b);      // (eqrx*eqry) R
    fq_mont_mul(&t, &t, &v);      // (eqrx*eqry*val) R
    fq_add(&acc, &acc, &t);
  }
  fq one = {{1, 0, 0, 0}};
  fq_mont_mul(&acc, &acc, &one);  // from Montgomery
  fq_tobytes(out32, &acc);
}

// Az[rows[k]] += vals[k] * z[cols[k]] — host SpMV (multiply_vec,
// sparse_mlpoly.rs:454-464).  vals and z Montgomery 32-byte LE; out
// (num_rows entries) PLAIN 32-byte LE.
extern "C" void spartan_fq_spmv(const u64* rows, const u64* cols,
                                const u8* vals, size_t nnz, const u8* z,
                                size_t num_rows, u8* out) {
  fq* acc = new fq[num_rows]();
  for (size_t k = 0; k < nnz; k++) {
    fq v, zz, t;
    fq_frombytes(&v, vals + 32 * k);
    fq_frombytes(&zz, z + 32 * cols[k]);
    fq_mont_mul(&t, &v, &zz);  // val*z*R: both Montgomery
    fq_add(&acc[rows[k]], &acc[rows[k]], &t);
  }
  fq one = {{1, 0, 0, 0}};
  for (size_t i = 0; i < num_rows; i++) {
    fq r;
    fq_mont_mul(&r, &acc[i], &one);
    fq_tobytes(out + 32 * i, &r);
  }
  delete[] acc;
}
