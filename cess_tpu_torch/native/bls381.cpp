// BLS12-381 min-sig fast path, built by g++ at first use
// (cess_tpu_torch/_build.py build_host) and loaded via ctypes by
// cess_tpu_torch/crypto/bls_native.py. The port's own copy of the
// reference package's native/bls381.cpp.
//
// Role: the native half of the verify-bls-signatures equivalent
// (SURVEY.md 2.3 "C++ BLS12-381 host-side"; the reference vendors the
// ic-verify-bls-signature Rust crate,
// utils/verify-bls-signatures/src/lib.rs:1-247). The
// pure-Python implementation (crypto/bls12381.py) is the
// readable oracle; this file mirrors its exact constructions —
// Fp2(u^2=-1) -> Fp6(v^3=1+u) -> Fp12(w^2=v) tower, optimal-ate loop
// over |u| with trailing conjugation, try-and-increment hash-to-G1
// over expand_message_xmd(SHA-256), ZCash point encoding — so the two
// produce BYTE-IDENTICAL signatures and agree on every verify
// (differentially tested in tests/test_torch_crypto.py). 6x64-bit Montgomery
// arithmetic; derived exponents (inversion, sqrt, Legendre, Frobenius
// gammas, final-exp hard part) are baked as hex with regeneration
// notes and cross-checked by the differential tests.
//
// Build: cess_tpu_torch/_build.py build_host, into build/native/.
#include <cstddef>
#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;

// ---------------------------------------------------------------- Fp
// p = 0x1a0111ea...aaab (381 bits), limbs little-endian
static const uint64_t PL[6] = {
    0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL,
    0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};
// R2 = 2^768 mod p   (regen: python -c "print(hex(pow(2,768,P)))")
static const uint64_t R2L[6] = {
    0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL, 0x8de5476c4c95b6d5ULL,
    0x67eb88a9939d83c0ULL, 0x9a793e85b519952dULL, 0x11988fe592cae3aaULL};
// -p^-1 mod 2^64
static const uint64_t NP = 0x89f3fffcfffcfffdULL;

struct Fp { uint64_t l[6]; };

static inline bool fp_is_zero(const Fp &a) {
  uint64_t o = 0;
  for (int i = 0; i < 6; i++) o |= a.l[i];
  return o == 0;
}
static inline bool fp_eq(const Fp &a, const Fp &b) {
  uint64_t o = 0;
  for (int i = 0; i < 6; i++) o |= a.l[i] ^ b.l[i];
  return o == 0;
}
static inline int cmp6(const uint64_t *a, const uint64_t *b) {
  for (int i = 5; i >= 0; i--) {
    if (a[i] < b[i]) return -1;
    if (a[i] > b[i]) return 1;
  }
  return 0;
}
static inline void sub6(uint64_t *r, const uint64_t *a, const uint64_t *b) {
  u128 bw = 0;
  for (int i = 0; i < 6; i++) {
    u128 d = (u128)a[i] - b[i] - (uint64_t)bw;
    r[i] = (uint64_t)d;
    bw = (d >> 64) ? 1 : 0;
  }
}
static inline void fp_add(Fp &r, const Fp &a, const Fp &b) {
  u128 c = 0;
  for (int i = 0; i < 6; i++) {
    c += (u128)a.l[i] + b.l[i];
    r.l[i] = (uint64_t)c;
    c >>= 64;
  }
  if (c || cmp6(r.l, PL) >= 0) sub6(r.l, r.l, PL);
}
static inline void fp_sub(Fp &r, const Fp &a, const Fp &b) {
  if (cmp6(a.l, b.l) >= 0) {
    sub6(r.l, a.l, b.l);
  } else {
    uint64_t t[6];
    sub6(t, b.l, a.l);
    sub6(r.l, PL, t);
  }
}
static inline void fp_neg(Fp &r, const Fp &a) {
  if (fp_is_zero(a)) { r = a; return; }
  sub6(r.l, PL, a.l);
}
// CIOS Montgomery multiplication
static void fp_mul(Fp &r, const Fp &a, const Fp &b) {
  uint64_t t[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 6; i++) {
    u128 c = 0;
    for (int j = 0; j < 6; j++) {
      u128 s = (u128)t[j] + (u128)a.l[i] * b.l[j] + (uint64_t)c;
      t[j] = (uint64_t)s;
      c = s >> 64;
    }
    u128 s = (u128)t[6] + (uint64_t)c;
    t[6] = (uint64_t)s;
    t[7] = (uint64_t)(s >> 64);
    uint64_t m = t[0] * NP;
    c = ((u128)m * PL[0] + t[0]) >> 64;
    for (int j = 1; j < 6; j++) {
      s = (u128)t[j] + (u128)m * PL[j] + (uint64_t)c;
      t[j - 1] = (uint64_t)s;
      c = s >> 64;
    }
    s = (u128)t[6] + (uint64_t)c;
    t[5] = (uint64_t)s;
    t[6] = t[7] + (uint64_t)(s >> 64);
    t[7] = 0;
  }
  if (t[6] || cmp6(t, PL) >= 0) sub6(t, t, PL);
  memcpy(r.l, t, 48);
}
static inline void fp_sqr(Fp &r, const Fp &a) { fp_mul(r, a, a); }

static Fp FP_ZERO, FP_ONE;  // FP_ONE = R mod p (Montgomery 1)

static void fp_from_bytes_be(Fp &r, const uint8_t *b48) {  // -> Montgomery
  Fp t;
  for (int i = 0; i < 6; i++) {
    uint64_t w = 0;
    for (int j = 0; j < 8; j++) w = (w << 8) | b48[(5 - i) * 8 + j];
    t.l[i] = w;
  }
  Fp r2;
  memcpy(r2.l, R2L, 48);
  fp_mul(r, t, r2);
}
static void fp_to_bytes_be(uint8_t *b48, const Fp &a) {  // Montgomery ->
  Fp one = {{1, 0, 0, 0, 0, 0}}, std;
  fp_mul(std, a, one);
  for (int i = 0; i < 6; i++)
    for (int j = 0; j < 8; j++)
      b48[(5 - i) * 8 + j] = (uint8_t)(std.l[i] >> (8 * (7 - j)));
}
// pow over a big-endian hex-derived exponent (byte array)
static void fp_pow(Fp &r, const Fp &a, const uint8_t *e, size_t n) {
  Fp acc = FP_ONE, base = a;
  for (size_t i = 0; i < n; i++)
    for (int bit = 7; bit >= 0; bit--) {
      fp_sqr(acc, acc);
      if ((e[i] >> bit) & 1) fp_mul(acc, acc, base);
    }
  r = acc;
}
// exponent constants (big-endian bytes). Regenerate with python:
//   hex(P-2), hex((P+1)//4), hex((P-1)//2)
static const uint8_t EXP_INV[48] = {  // p-2
    0x1a,0x01,0x11,0xea,0x39,0x7f,0xe6,0x9a,0x4b,0x1b,0xa7,0xb6,
    0x43,0x4b,0xac,0xd7,0x64,0x77,0x4b,0x84,0xf3,0x85,0x12,0xbf,
    0x67,0x30,0xd2,0xa0,0xf6,0xb0,0xf6,0x24,0x1e,0xab,0xff,0xfe,
    0xb1,0x53,0xff,0xff,0xb9,0xfe,0xff,0xff,0xff,0xff,0xaa,0xa9};
static const uint8_t EXP_SQRT[48] = {  // (p+1)/4
    0x06,0x80,0x44,0x7a,0x8e,0x5f,0xf9,0xa6,0x92,0xc6,0xe9,0xed,
    0x90,0xd2,0xeb,0x35,0xd9,0x1d,0xd2,0xe1,0x3c,0xe1,0x44,0xaf,
    0xd9,0xcc,0x34,0xa8,0x3d,0xac,0x3d,0x89,0x07,0xaa,0xff,0xff,
    0xac,0x54,0xff,0xff,0xee,0x7f,0xbf,0xff,0xff,0xff,0xea,0xab};
static const uint8_t EXP_LEGENDRE[48] = {  // (p-1)/2
    0x0d,0x00,0x88,0xf5,0x1c,0xbf,0xf3,0x4d,0x25,0x8d,0xd3,0xdb,
    0x21,0xa5,0xd6,0x6b,0xb2,0x3b,0xa5,0xc2,0x79,0xc2,0x89,0x5f,
    0xb3,0x98,0x69,0x50,0x7b,0x58,0x7b,0x12,0x0f,0x55,0xff,0xff,
    0x58,0xa9,0xff,0xff,0xdc,0xff,0x7f,0xff,0xff,0xff,0xd5,0x55};

static inline void fp_inv(Fp &r, const Fp &a) { fp_pow(r, a, EXP_INV, 48); }
// sqrt candidate (p == 3 mod 4); returns false if non-residue
static bool fp_sqrt(Fp &r, const Fp &a) {
  Fp s, s2;
  fp_pow(s, a, EXP_SQRT, 48);
  fp_sqr(s2, s);
  if (!fp_eq(s2, a)) return false;
  r = s;
  return true;
}
// standard-form helpers (for serialization decisions)
static void fp_std(uint64_t out[6], const Fp &a) {
  Fp one = {{1, 0, 0, 0, 0, 0}}, std;
  fp_mul(std, a, one);
  memcpy(out, std.l, 48);
}
static bool fp_is_big(const Fp &a) {  // standard(a) > (p-1)/2
  static const uint64_t HALF[6] = {
      0xdcff7fffffffd555ULL, 0x0f55ffff58a9ffffULL, 0xb39869507b587b12ULL,
      0xb23ba5c279c2895fULL, 0x258dd3db21a5d66bULL, 0x0d0088f51cbff34dULL};
  uint64_t s[6];
  fp_std(s, a);
  return cmp6(s, HALF) > 0;
}
static bool fp_is_odd(const Fp &a) {
  uint64_t s[6];
  fp_std(s, a);
  return s[0] & 1;
}

// ---------------------------------------------------------------- Fp2
struct Fp2 { Fp c0, c1; };  // c0 + c1*u, u^2 = -1
static Fp2 F2_ZERO, F2_ONE, XI;  // XI = 1 + u

static inline void f2_add(Fp2 &r, const Fp2 &a, const Fp2 &b) {
  fp_add(r.c0, a.c0, b.c0);
  fp_add(r.c1, a.c1, b.c1);
}
static inline void f2_sub(Fp2 &r, const Fp2 &a, const Fp2 &b) {
  fp_sub(r.c0, a.c0, b.c0);
  fp_sub(r.c1, a.c1, b.c1);
}
static inline void f2_neg(Fp2 &r, const Fp2 &a) {
  fp_neg(r.c0, a.c0);
  fp_neg(r.c1, a.c1);
}
static void f2_mul(Fp2 &r, const Fp2 &a, const Fp2 &b) {
  Fp t0, t1, t2, s1, s2;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(s1, a.c0, a.c1);
  fp_add(s2, b.c0, b.c1);
  fp_mul(t2, s1, s2);
  fp_sub(r.c0, t0, t1);
  fp_sub(t2, t2, t0);
  fp_sub(r.c1, t2, t1);
}
static void f2_sqr(Fp2 &r, const Fp2 &a) {
  Fp s, d, t;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(t, a.c0, a.c1);
  fp_mul(r.c0, s, d);
  fp_add(r.c1, t, t);
}
static void f2_inv(Fp2 &r, const Fp2 &a) {
  Fp n, t0, t1, d;
  fp_sqr(t0, a.c0);
  fp_sqr(t1, a.c1);
  fp_add(n, t0, t1);
  fp_inv(d, n);
  fp_mul(r.c0, a.c0, d);
  Fp nd;
  fp_neg(nd, a.c1);
  fp_mul(r.c1, nd, d);
}
static inline void f2_conj(Fp2 &r, const Fp2 &a) {
  r.c0 = a.c0;
  fp_neg(r.c1, a.c1);
}
static inline bool f2_is_zero(const Fp2 &a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}
static inline bool f2_eq(const Fp2 &a, const Fp2 &b) {
  return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}
static void f2_muls(Fp2 &r, const Fp2 &a, uint64_t s) {  // small scalar
  Fp2 acc = F2_ZERO, base = a;
  while (s) {
    if (s & 1) f2_add(acc, acc, base);
    f2_add(base, base, base);
    s >>= 1;
  }
  r = acc;
}
static void f2_pow(Fp2 &r, const Fp2 &a, const uint8_t *e, size_t n) {
  Fp2 acc = F2_ONE;
  for (size_t i = 0; i < n; i++)
    for (int bit = 7; bit >= 0; bit--) {
      f2_sqr(acc, acc);
      if ((e[i] >> bit) & 1) f2_mul(acc, acc, a);
    }
  r = acc;
}
// sqrt in Fp2 (complex method, matches the Python oracle's structure)
static bool f2_sqrt(Fp2 &r, const Fp2 &a) {
  if (f2_is_zero(a)) { r = F2_ZERO; return true; }
  Fp n, t0, t1, d;
  fp_sqr(t0, a.c0);
  fp_sqr(t1, a.c1);
  fp_add(n, t0, t1);            // norm
  if (!fp_sqrt(d, n)) return false;
  Fp two = FP_ONE, inv2;
  fp_add(two, FP_ONE, FP_ONE);
  fp_inv(inv2, two);
  Fp x0, r0;
  fp_add(x0, a.c0, d);
  fp_mul(x0, x0, inv2);
  if (!fp_sqrt(r0, x0)) {
    fp_sub(x0, a.c0, d);
    fp_mul(x0, x0, inv2);
    if (!fp_sqrt(r0, x0)) return false;
  }
  if (fp_is_zero(r0)) {
    Fp half_c1, r1;
    fp_mul(half_c1, a.c1, inv2);
    if (!fp_sqrt(r1, half_c1)) return false;
    Fp2 cand = {FP_ZERO, r1}, sq;
    f2_sqr(sq, cand);
    if (!f2_eq(sq, a)) return false;
    r = cand;
    return true;
  }
  Fp r0x2, r0x2i, r1;
  fp_add(r0x2, r0, r0);
  fp_inv(r0x2i, r0x2);
  fp_mul(r1, a.c1, r0x2i);
  Fp2 cand = {r0, r1}, sq;
  f2_sqr(sq, cand);
  if (!f2_eq(sq, a)) return false;
  r = cand;
  return true;
}

// ---------------------------------------------------------------- Fp6
struct Fp6 { Fp2 c0, c1, c2; };  // over Fp2, v^3 = XI
static Fp6 F6_ZERO, F6_ONE;

static inline void f6_add(Fp6 &r, const Fp6 &a, const Fp6 &b) {
  f2_add(r.c0, a.c0, b.c0);
  f2_add(r.c1, a.c1, b.c1);
  f2_add(r.c2, a.c2, b.c2);
}
static inline void f6_sub(Fp6 &r, const Fp6 &a, const Fp6 &b) {
  f2_sub(r.c0, a.c0, b.c0);
  f2_sub(r.c1, a.c1, b.c1);
  f2_sub(r.c2, a.c2, b.c2);
}
static inline void f6_neg(Fp6 &r, const Fp6 &a) {
  f2_neg(r.c0, a.c0);
  f2_neg(r.c1, a.c1);
  f2_neg(r.c2, a.c2);
}
static void f6_mul(Fp6 &r, const Fp6 &a, const Fp6 &b) {
  Fp2 t0, t1, t2, s1, s2, x, y;
  f2_mul(t0, a.c0, b.c0);
  f2_mul(t1, a.c1, b.c1);
  f2_mul(t2, a.c2, b.c2);
  // c0 = t0 + XI*((a1+a2)(b1+b2) - t1 - t2)
  f2_add(s1, a.c1, a.c2);
  f2_add(s2, b.c1, b.c2);
  f2_mul(x, s1, s2);
  f2_sub(x, x, t1);
  f2_sub(x, x, t2);
  f2_mul(x, XI, x);
  f2_add(r.c0, t0, x);
  // c1 = (a0+a1)(b0+b1) - t0 - t1 + XI*t2
  f2_add(s1, a.c0, a.c1);
  f2_add(s2, b.c0, b.c1);
  f2_mul(x, s1, s2);
  f2_sub(x, x, t0);
  f2_sub(x, x, t1);
  f2_mul(y, XI, t2);
  f2_add(r.c1, x, y);
  // c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
  f2_add(s1, a.c0, a.c2);
  f2_add(s2, b.c0, b.c2);
  f2_mul(x, s1, s2);
  f2_sub(x, x, t0);
  f2_sub(x, x, t2);
  f2_add(r.c2, x, t1);
}
static inline void f6_sqr(Fp6 &r, const Fp6 &a) { f6_mul(r, a, a); }
static void f6_mulv(Fp6 &r, const Fp6 &a) {  // * v
  Fp2 t;
  f2_mul(t, XI, a.c2);
  r.c2 = a.c1;
  r.c1 = a.c0;
  r.c0 = t;
}
static void f6_inv(Fp6 &r, const Fp6 &a) {
  Fp2 t0, t1, t2, x, y, den, di;
  f2_sqr(t0, a.c0);
  f2_mul(x, a.c1, a.c2);
  f2_mul(x, XI, x);
  f2_sub(t0, t0, x);                 // t0 = a0^2 - XI*a1*a2
  f2_sqr(t1, a.c2);
  f2_mul(t1, XI, t1);
  f2_mul(x, a.c0, a.c1);
  f2_sub(t1, t1, x);                 // t1 = XI*a2^2 - a0*a1
  f2_sqr(t2, a.c1);
  f2_mul(x, a.c0, a.c2);
  f2_sub(t2, t2, x);                 // t2 = a1^2 - a0*a2
  f2_mul(den, a.c0, t0);
  f2_mul(x, a.c2, t1);
  f2_mul(y, a.c1, t2);
  f2_add(x, x, y);
  f2_mul(x, XI, x);
  f2_add(den, den, x);
  f2_inv(di, den);
  f2_mul(r.c0, t0, di);
  f2_mul(r.c1, t1, di);
  f2_mul(r.c2, t2, di);
}

// --------------------------------------------------------------- Fp12
struct Fp12 { Fp6 c0, c1; };  // over Fp6, w^2 = v
static Fp12 F12_ONE;

static inline void f12_sub(Fp12 &r, const Fp12 &a, const Fp12 &b) {
  f6_sub(r.c0, a.c0, b.c0);
  f6_sub(r.c1, a.c1, b.c1);
}
static void f12_mul(Fp12 &r, const Fp12 &a, const Fp12 &b) {
  Fp6 t0, t1, s1, s2, x;
  f6_mul(t0, a.c0, b.c0);
  f6_mul(t1, a.c1, b.c1);
  f6_add(s1, a.c0, a.c1);
  f6_add(s2, b.c0, b.c1);
  f6_mul(x, s1, s2);
  f6_sub(x, x, t0);
  f6_sub(r.c1, x, t1);
  f6_mulv(t1, t1);
  f6_add(r.c0, t0, t1);
}
static inline void f12_sqr(Fp12 &r, const Fp12 &a) { f12_mul(r, a, a); }
static void f12_inv(Fp12 &r, const Fp12 &a) {
  Fp6 t0, t1, den, di, n1;
  f6_sqr(t0, a.c0);
  f6_sqr(t1, a.c1);
  f6_mulv(t1, t1);
  f6_sub(den, t0, t1);
  f6_inv(di, den);
  f6_mul(r.c0, a.c0, di);
  f6_neg(n1, a.c1);
  f6_mul(r.c1, n1, di);
}
static inline void f12_conj(Fp12 &r, const Fp12 &a) {  // Frobenius^6
  r.c0 = a.c0;
  f6_neg(r.c1, a.c1);
}
static bool f12_is_one(const Fp12 &a) {
  if (!f2_eq(a.c0.c0, F2_ONE)) return false;
  return f2_is_zero(a.c0.c1) && f2_is_zero(a.c0.c2) &&
         f2_is_zero(a.c1.c0) && f2_is_zero(a.c1.c1) && f2_is_zero(a.c1.c2);
}
static void f12_pow(Fp12 &r, const Fp12 &a, const uint8_t *e, size_t n) {
  Fp12 acc = F12_ONE;
  for (size_t i = 0; i < n; i++)
    for (int bit = 7; bit >= 0; bit--) {
      f12_sqr(acc, acc);
      if ((e[i] >> bit) & 1) f12_mul(acc, acc, a);
    }
  r = acc;
}

// Frobenius gammas: GAMMA_V = XI^((p-1)/3), GAMMA_V2 = XI^(2(p-1)/3),
// GAMMA_W = XI^((p-1)/6) — computed at init from baked exponents.
static Fp2 GAMMA_V, GAMMA_V2, GAMMA_W;
// (p-1)/6 BE bytes (regen: hex((P-1)//6))
static const uint8_t EXP_P1_6[48] = {
    0x04,0x55,0x82,0xfc,0x5e,0xea,0xa6,0x6f,0x0c,0x84,0x9b,0xf3,
    0xb5,0xe1,0xf2,0x23,0xe6,0x13,0xe1,0xeb,0x7d,0xeb,0x83,0x1f,
    0xe6,0x88,0x23,0x1a,0xd3,0xc8,0x29,0x06,0x05,0x1c,0xaa,0xaa,
    0x72,0xe3,0x55,0x55,0x49,0xaa,0x7f,0xff,0xff,0xff,0xf1,0xc7};

static void f6_frob(Fp6 &r, const Fp6 &a) {
  Fp2 t;
  f2_conj(r.c0, a.c0);
  f2_conj(t, a.c1);
  f2_mul(r.c1, t, GAMMA_V);
  f2_conj(t, a.c2);
  f2_mul(r.c2, t, GAMMA_V2);
}
static void f12_frob(Fp12 &r, const Fp12 &a) {
  Fp6 t;
  f6_frob(r.c0, a.c0);
  f6_frob(t, a.c1);
  f2_mul(r.c1.c0, t.c0, GAMMA_W);
  f2_mul(r.c1.c1, t.c1, GAMMA_W);
  f2_mul(r.c1.c2, t.c2, GAMMA_W);
}

// hard exponent (p^4 - p^2 + 1)/r, 1268 bits -> 159 BE bytes
// (regen: hex((P**4 - P**2 + 1)//R))
static const uint8_t EXP_HARD[159] = {
    0x0f,0x68,0x6b,0x3d,0x80,0x7d,0x01,0xc0,0xbd,0x38,0xc3,0x19,
    0x5c,0x89,0x9e,0xd3,0xcd,0xe8,0x8e,0xeb,0x99,0x6c,0xa3,0x94,
    0x50,0x66,0x32,0x52,0x8d,0x6a,0x9a,0x2f,0x23,0x00,0x63,0xcf,
    0x08,0x15,0x17,0xf6,0x8f,0x77,0x64,0xc2,0x8b,0x6f,0x8a,0xe5,
    0xa7,0x2b,0xce,0x8d,0x63,0xcb,0x9f,0x82,0x7e,0xca,0x0b,0xa6,
    0x21,0x31,0x5b,0x20,0x76,0x99,0x50,0x03,0xfc,0x77,0xa1,0x79,
    0x88,0xf8,0x76,0x1b,0xdc,0x51,0xdc,0x23,0x78,0xb9,0x03,0x90,
    0x96,0xd1,0xb7,0x67,0xf1,0x7f,0xcb,0xde,0x78,0x37,0x65,0x91,
    0x5c,0x97,0xf3,0x6c,0x6f,0x18,0x21,0x2e,0xd0,0xb2,0x83,0xed,
    0x23,0x7d,0xb4,0x21,0xd1,0x60,0xae,0xb6,0xa1,0xe7,0x99,0x83,
    0x77,0x49,0x40,0x99,0x67,0x54,0xc8,0xc7,0x1a,0x26,0x29,0xb0,
    0xde,0xa2,0x36,0x90,0x5c,0xe9,0x37,0x33,0x5d,0x5b,0x68,0xfa,
    0x99,0x12,0xaa,0xe2,0x08,0xcc,0xf1,0xe5,0x16,0xc3,0xf4,0x38,
    0xe3,0xba,0x79};

static void final_exp(Fp12 &r, const Fp12 &f) {
  Fp12 g, inv, fr;
  f12_inv(inv, f);
  f12_conj(g, f);
  f12_mul(g, g, inv);       // f^(p^6-1)
  f12_frob(fr, g);
  f12_frob(fr, fr);
  f12_mul(g, fr, g);        // ^(p^2+1)
  f12_pow(r, g, EXP_HARD, sizeof(EXP_HARD));
}

// -------------------------------------------------------------- curves
struct G1 { Fp x, y; bool inf; };
struct G2 { Fp2 x, y; bool inf; };
static Fp B1;       // 4 (Montgomery)
static Fp2 B2;      // 4*(1+u)
static G1 G1_GEN;
static G2 G2_GEN;

static bool g1_on_curve(const G1 &p) {
  if (p.inf) return true;
  Fp y2, x3, t;
  fp_sqr(y2, p.y);
  fp_sqr(t, p.x);
  fp_mul(x3, t, p.x);
  fp_add(x3, x3, B1);
  return fp_eq(y2, x3);
}
static bool g2_on_curve(const G2 &p) {
  if (p.inf) return true;
  Fp2 y2, x3, t;
  f2_sqr(y2, p.y);
  f2_sqr(t, p.x);
  f2_mul(x3, t, p.x);
  f2_add(x3, x3, B2);
  return f2_eq(y2, x3);
}

// G1 Jacobian
struct G1J { Fp X, Y, Z; bool inf; };
static void g1j_dbl(G1J &r, const G1J &p) {
  if (p.inf) { r = p; return; }
  Fp A, Bv, C, D, E, F, t, X3, Y3, Z3;
  fp_sqr(A, p.X);
  fp_sqr(Bv, p.Y);
  fp_sqr(C, Bv);
  fp_add(t, p.X, Bv);
  fp_sqr(t, t);
  fp_sub(t, t, A);
  fp_sub(t, t, C);
  fp_add(D, t, t);
  fp_add(E, A, A);
  fp_add(E, E, A);
  fp_sqr(F, E);
  fp_sub(X3, F, D);
  fp_sub(X3, X3, D);
  fp_sub(t, D, X3);
  fp_mul(Y3, E, t);
  Fp c8;
  fp_add(c8, C, C);
  fp_add(c8, c8, c8);
  fp_add(c8, c8, c8);
  fp_sub(Y3, Y3, c8);
  fp_mul(Z3, p.Y, p.Z);
  fp_add(Z3, Z3, Z3);
  r.X = X3; r.Y = Y3; r.Z = Z3; r.inf = fp_is_zero(Z3);
}
static void g1j_add_aff(G1J &r, const G1J &p, const G1 &q) {
  if (q.inf) { r = p; return; }
  if (p.inf) {
    r.X = q.x; r.Y = q.y; r.Z = FP_ONE; r.inf = false;
    return;
  }
  Fp Z1Z1, U2, S2, H, HH, I, J, rr, V, t, X3, Y3, Z3;
  fp_sqr(Z1Z1, p.Z);
  fp_mul(U2, q.x, Z1Z1);
  fp_mul(S2, q.y, p.Z);
  fp_mul(S2, S2, Z1Z1);
  if (fp_eq(U2, p.X)) {
    if (!fp_eq(S2, p.Y)) { r.inf = true; r.X = FP_ONE; r.Y = FP_ONE; r.Z = FP_ZERO; return; }
    g1j_dbl(r, p);
    return;
  }
  fp_sub(H, U2, p.X);
  fp_sqr(HH, H);
  fp_add(I, HH, HH);
  fp_add(I, I, I);
  fp_mul(J, H, I);
  fp_sub(rr, S2, p.Y);
  fp_add(rr, rr, rr);
  fp_mul(V, p.X, I);
  fp_sqr(X3, rr);
  fp_sub(X3, X3, J);
  fp_sub(X3, X3, V);
  fp_sub(X3, X3, V);
  fp_sub(t, V, X3);
  fp_mul(Y3, rr, t);
  fp_mul(t, p.Y, J);
  fp_add(t, t, t);
  fp_sub(Y3, Y3, t);
  fp_mul(Z3, H, p.Z);
  fp_add(Z3, Z3, Z3);
  r.X = X3; r.Y = Y3; r.Z = Z3; r.inf = fp_is_zero(Z3);
}
static void g1j_to_aff(G1 &r, const G1J &p) {
  if (p.inf || fp_is_zero(p.Z)) { r.inf = true; r.x = FP_ZERO; r.y = FP_ONE; return; }
  Fp zi, zi2, zi3;
  fp_inv(zi, p.Z);
  fp_sqr(zi2, zi);
  fp_mul(zi3, zi2, zi);
  fp_mul(r.x, p.X, zi2);
  fp_mul(r.y, p.Y, zi3);
  r.inf = false;
}
static void g1_mul_bytes(G1 &r, const G1 &p, const uint8_t *k, size_t n) {
  G1J acc;
  acc.inf = true; acc.X = FP_ONE; acc.Y = FP_ONE; acc.Z = FP_ZERO;
  bool started = false;
  for (size_t i = 0; i < n; i++)
    for (int bit = 7; bit >= 0; bit--) {
      if (started) g1j_dbl(acc, acc);
      if ((k[i] >> bit) & 1) {
        g1j_add_aff(acc, acc, p);
        started = true;
      }
    }
  g1j_to_aff(r, acc);
}
static void g1_add(G1 &r, const G1 &a, const G1 &b) {
  G1J j;
  j.inf = a.inf;
  if (!a.inf) { j.X = a.x; j.Y = a.y; j.Z = FP_ONE; }
  else { j.X = FP_ONE; j.Y = FP_ONE; j.Z = FP_ZERO; }
  g1j_add_aff(j, j, b);
  g1j_to_aff(r, j);
}

// G2 Jacobian (same shapes over Fp2)
struct G2J { Fp2 X, Y, Z; bool inf; };
static void g2j_dbl(G2J &r, const G2J &p) {
  if (p.inf) { r = p; return; }
  Fp2 A, Bv, C, D, E, F, t, X3, Y3, Z3;
  f2_sqr(A, p.X);
  f2_sqr(Bv, p.Y);
  f2_sqr(C, Bv);
  f2_add(t, p.X, Bv);
  f2_sqr(t, t);
  f2_sub(t, t, A);
  f2_sub(t, t, C);
  f2_add(D, t, t);
  f2_add(E, A, A);
  f2_add(E, E, A);
  f2_sqr(F, E);
  f2_sub(X3, F, D);
  f2_sub(X3, X3, D);
  f2_sub(t, D, X3);
  f2_mul(Y3, E, t);
  Fp2 c8;
  f2_add(c8, C, C);
  f2_add(c8, c8, c8);
  f2_add(c8, c8, c8);
  f2_sub(Y3, Y3, c8);
  f2_mul(Z3, p.Y, p.Z);
  f2_add(Z3, Z3, Z3);
  r.X = X3; r.Y = Y3; r.Z = Z3; r.inf = f2_is_zero(Z3);
}
static void g2j_add_aff(G2J &r, const G2J &p, const G2 &q) {
  if (q.inf) { r = p; return; }
  if (p.inf) {
    r.X = q.x; r.Y = q.y; r.Z = F2_ONE; r.inf = false;
    return;
  }
  Fp2 Z1Z1, U2, S2, H, HH, I, J, rr, V, t, X3, Y3, Z3;
  f2_sqr(Z1Z1, p.Z);
  f2_mul(U2, q.x, Z1Z1);
  f2_mul(S2, q.y, p.Z);
  f2_mul(S2, S2, Z1Z1);
  if (f2_eq(U2, p.X)) {
    if (!f2_eq(S2, p.Y)) { r.inf = true; r.X = F2_ONE; r.Y = F2_ONE; r.Z = F2_ZERO; return; }
    g2j_dbl(r, p);
    return;
  }
  f2_sub(H, U2, p.X);
  f2_sqr(HH, H);
  f2_add(I, HH, HH);
  f2_add(I, I, I);
  f2_mul(J, H, I);
  f2_sub(rr, S2, p.Y);
  f2_add(rr, rr, rr);
  f2_mul(V, p.X, I);
  f2_sqr(X3, rr);
  f2_sub(X3, X3, J);
  f2_sub(X3, X3, V);
  f2_sub(X3, X3, V);
  f2_sub(t, V, X3);
  f2_mul(Y3, rr, t);
  f2_mul(t, p.Y, J);
  f2_add(t, t, t);
  f2_sub(Y3, Y3, t);
  f2_mul(Z3, H, p.Z);
  f2_add(Z3, Z3, Z3);
  r.X = X3; r.Y = Y3; r.Z = Z3; r.inf = f2_is_zero(Z3);
}
static void g2j_to_aff(G2 &r, const G2J &p) {
  if (p.inf || f2_is_zero(p.Z)) { r.inf = true; r.x = F2_ZERO; r.y = F2_ONE; return; }
  Fp2 zi, zi2, zi3;
  f2_inv(zi, p.Z);
  f2_sqr(zi2, zi);
  f2_mul(zi3, zi2, zi);
  f2_mul(r.x, p.X, zi2);
  f2_mul(r.y, p.Y, zi3);
  r.inf = false;
}
static void g2_mul_bytes(G2 &r, const G2 &p, const uint8_t *k, size_t n) {
  G2J acc;
  acc.inf = true; acc.X = F2_ONE; acc.Y = F2_ONE; acc.Z = F2_ZERO;
  bool started = false;
  for (size_t i = 0; i < n; i++)
    for (int bit = 7; bit >= 0; bit--) {
      if (started) g2j_dbl(acc, acc);
      if ((k[i] >> bit) & 1) {
        g2j_add_aff(acc, acc, p);
        started = true;
      }
    }
  g2j_to_aff(r, acc);
}

// group order r (BE bytes) for subgroup checks
static const uint8_t R_BYTES[32] = {
    0x73,0xed,0xa7,0x53,0x29,0x9d,0x7d,0x48,0x33,0x39,0xd8,0x08,
    0x09,0xa1,0xd8,0x05,0x53,0xbd,0xa4,0x02,0xff,0xfe,0x5b,0xfe,
    0xff,0xff,0xff,0xff,0x00,0x00,0x00,0x01};
// G1 cofactor (derived (p-u)/r; regen: hex(H1))
static const uint8_t H1_BYTES[16] = {
    0x39,0x6c,0x8c,0x00,0x55,0x55,0xe1,0x56,
    0x8c,0x00,0xaa,0xab,0x00,0x00,0xaa,0xab};

static bool g1_in_subgroup(const G1 &p) {
  if (!g1_on_curve(p)) return false;
  if (p.inf) return true;
  G1 t;
  g1_mul_bytes(t, p, R_BYTES, 32);
  return t.inf;
}
static bool g2_in_subgroup(const G2 &p) {
  if (!g2_on_curve(p)) return false;
  if (p.inf) return true;
  G2 t;
  g2_mul_bytes(t, p, R_BYTES, 32);
  return t.inf;
}

// ------------------------------------------------------------- pairing
// untwist Q=(x,y) in E'(Fp2) to E(Fp12): X = x*v^2/XI (c2 slot),
// Y = (y*v/XI)*w (c1.c1 slot) — same embedding as the Python oracle.
struct QEmb { Fp12 x, y; };
static void untwist(QEmb &r, const G2 &q) {
  Fp2 xi_inv, t;
  f2_inv(xi_inv, XI);
  memset(&r, 0, sizeof(r));
  r.x.c0 = F6_ZERO;
  r.x.c1 = F6_ZERO;
  f2_mul(t, q.x, xi_inv);
  r.x.c0.c2 = t;
  f2_mul(t, q.y, xi_inv);
  r.y.c0 = F6_ZERO;
  r.y.c1 = F6_ZERO;
  r.y.c1.c1 = t;
}
static void f12_from_fp(Fp12 &r, const Fp &a) {
  memset(&r, 0, sizeof(r));
  r.c0.c0.c0 = a;
  r.c0.c0.c1 = FP_ZERO;
  r.c0.c1 = F2_ZERO;
  r.c0.c2 = F2_ZERO;
  r.c1 = F6_ZERO;
}
// |u| = 0xd201000000010000, 64 bits
static const uint64_t ABS_U = 0xd201000000010000ULL;

static void miller_loop(Fp12 &f, const G1 &p, const G2 &q) {
  if (p.inf || q.inf) { f = F12_ONE; return; }
  QEmb Q, T;
  untwist(Q, q);
  T = Q;
  Fp12 xp, yp, lam, line, t0, t1, t2, three, two;
  f12_from_fp(xp, p.x);
  f12_from_fp(yp, p.y);
  Fp fp3, fp2v;
  fp_add(fp3, FP_ONE, FP_ONE);
  fp_add(fp3, fp3, FP_ONE);
  fp_add(fp2v, FP_ONE, FP_ONE);
  f12_from_fp(three, fp3);
  f12_from_fp(two, fp2v);
  f = F12_ONE;
  int top = 63;
  while (top >= 0 && !((ABS_U >> top) & 1)) top--;
  for (int i = top - 1; i >= 0; i--) {
    // doubling step: lam = 3*xT^2 / (2*yT)
    f12_sqr(t0, T.x);
    f12_mul(t0, t0, three);
    f12_mul(t1, T.y, two);
    f12_inv(t1, t1);
    f12_mul(lam, t0, t1);
    // line = yP - yT - lam*(xP - xT)
    f12_sub(t0, xp, T.x);
    f12_mul(t0, lam, t0);
    f12_sub(line, yp, T.y);
    f12_sub(line, line, t0);
    f12_sqr(f, f);
    f12_mul(f, f, line);
    // T = 2T
    f12_sqr(t0, lam);
    f12_sub(t0, t0, T.x);
    f12_sub(t0, t0, T.x);          // x3
    f12_sub(t1, T.x, t0);
    f12_mul(t1, lam, t1);
    f12_sub(T.y, t1, T.y);
    T.x = t0;
    if ((ABS_U >> i) & 1) {
      // addition step: lam = (yQ - yT)/(xQ - xT)
      f12_sub(t0, Q.y, T.y);
      f12_sub(t1, Q.x, T.x);
      f12_inv(t1, t1);
      f12_mul(lam, t0, t1);
      f12_sub(t0, xp, T.x);
      f12_mul(t0, lam, t0);
      f12_sub(line, yp, T.y);
      f12_sub(line, line, t0);
      f12_mul(f, f, line);
      f12_sqr(t0, lam);
      f12_sub(t0, t0, T.x);
      f12_sub(t0, t0, Q.x);        // x3
      f12_sub(t2, T.x, t0);
      f12_mul(t2, lam, t2);
      f12_sub(T.y, t2, T.y);
      T.x = t0;
    }
  }
  Fp12 cf;
  f12_conj(cf, f);                 // u < 0
  f = cf;
}

// ------------------------------------------------------------- SHA-256
struct Sha256 {
  uint32_t h[8];
  uint64_t len;
  uint8_t buf[64];
  size_t fill;
};
static const uint32_t SHA_K[64] = {
    0x428a2f98,0x71374491,0xb5c0fbcf,0xe9b5dba5,0x3956c25b,0x59f111f1,
    0x923f82a4,0xab1c5ed5,0xd807aa98,0x12835b01,0x243185be,0x550c7dc3,
    0x72be5d74,0x80deb1fe,0x9bdc06a7,0xc19bf174,0xe49b69c1,0xefbe4786,
    0x0fc19dc6,0x240ca1cc,0x2de92c6f,0x4a7484aa,0x5cb0a9dc,0x76f988da,
    0x983e5152,0xa831c66d,0xb00327c8,0xbf597fc7,0xc6e00bf3,0xd5a79147,
    0x06ca6351,0x14292967,0x27b70a85,0x2e1b2138,0x4d2c6dfc,0x53380d13,
    0x650a7354,0x766a0abb,0x81c2c92e,0x92722c85,0xa2bfe8a1,0xa81a664b,
    0xc24b8b70,0xc76c51a3,0xd192e819,0xd6990624,0xf40e3585,0x106aa070,
    0x19a4c116,0x1e376c08,0x2748774c,0x34b0bcb5,0x391c0cb3,0x4ed8aa4a,
    0x5b9cca4f,0x682e6ff3,0x748f82ee,0x78a5636f,0x84c87814,0x8cc70208,
    0x90befffa,0xa4506ceb,0xbef9a3f7,0xc67178f2};
static inline uint32_t rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}
static void sha_block(Sha256 &s, const uint8_t *p) {
  uint32_t w[64];
  for (int i = 0; i < 16; i++)
    w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16) |
           ((uint32_t)p[4 * i + 2] << 8) | p[4 * i + 3];
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = s.h[0], b = s.h[1], c = s.h[2], d = s.h[3];
  uint32_t e = s.h[4], f = s.h[5], g = s.h[6], hh = s.h[7];
  for (int i = 0; i < 64; i++) {
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = hh + S1 + ch + SHA_K[i] + w[i];
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + mj;
    hh = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  s.h[0] += a; s.h[1] += b; s.h[2] += c; s.h[3] += d;
  s.h[4] += e; s.h[5] += f; s.h[6] += g; s.h[7] += hh;
}
static void sha_init(Sha256 &s) {
  static const uint32_t H0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                 0xa54ff53a, 0x510e527f, 0x9b05688c,
                                 0x1f83d9ab, 0x5be0cd19};
  memcpy(s.h, H0, sizeof(H0));
  s.len = 0;
  s.fill = 0;
}
static void sha_update(Sha256 &s, const uint8_t *p, size_t n) {
  s.len += n;
  while (n) {
    size_t take = 64 - s.fill;
    if (take > n) take = n;
    memcpy(s.buf + s.fill, p, take);
    s.fill += take;
    p += take;
    n -= take;
    if (s.fill == 64) {
      sha_block(s, s.buf);
      s.fill = 0;
    }
  }
}
static void sha_final(Sha256 &s, uint8_t out[32]) {
  uint64_t bits = s.len * 8;
  uint8_t pad = 0x80;
  sha_update(s, &pad, 1);
  uint8_t z = 0;
  while (s.fill != 56) sha_update(s, &z, 1);
  uint8_t lb[8];
  for (int i = 0; i < 8; i++) lb[i] = (uint8_t)(bits >> (8 * (7 - i)));
  sha_update(s, lb, 8);
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 4; j++)
      out[4 * i + j] = (uint8_t)(s.h[i] >> (8 * (3 - j)));
}
static void sha256(uint8_t out[32], const uint8_t *a, size_t an,
                   const uint8_t *b, size_t bn, const uint8_t *c, size_t cn) {
  Sha256 s;
  sha_init(s);
  if (an) sha_update(s, a, an);
  if (bn) sha_update(s, b, bn);
  if (cn) sha_update(s, c, cn);
  sha_final(s, out);
}

// expand_message_xmd(SHA-256) for length 64 (RFC 9380 5.3.1)
static int xmd64(uint8_t out[64], const uint8_t *msg, size_t msg_len,
                 const uint8_t *dst, size_t dst_len) {
  if (dst_len > 255) return -1;
  uint8_t dst_prime[256];
  memcpy(dst_prime, dst, dst_len);
  dst_prime[dst_len] = (uint8_t)dst_len;
  size_t dpl = dst_len + 1;
  uint8_t b0[32], bi[32];
  {
    Sha256 s;
    sha_init(s);
    uint8_t zpad[64] = {0};
    sha_update(s, zpad, 64);
    sha_update(s, msg, msg_len);
    uint8_t lib[3] = {0x00, 0x40, 0x00};  // I2OSP(64,2) || 0x00
    sha_update(s, lib, 3);
    sha_update(s, dst_prime, dpl);
    sha_final(s, b0);
  }
  {
    Sha256 s;
    sha_init(s);
    sha_update(s, b0, 32);
    uint8_t one = 1;
    sha_update(s, &one, 1);
    sha_update(s, dst_prime, dpl);
    sha_final(s, bi);
  }
  memcpy(out, bi, 32);
  {
    Sha256 s;
    sha_init(s);
    uint8_t x[32];
    for (int i = 0; i < 32; i++) x[i] = b0[i] ^ bi[i];
    sha_update(s, x, 32);
    uint8_t two = 2;
    sha_update(s, &two, 1);
    sha_update(s, dst_prime, dpl);
    sha_final(s, bi);
  }
  memcpy(out + 32, bi, 32);
  return 0;
}

// big-endian reduce 48 bytes mod p -> Fp (Montgomery)
static void fp_from_wide_be(Fp &r, const uint8_t *b48) {
  // value < 2^384; subtract p at most a few times in standard form
  uint64_t v[7] = {0};
  for (int i = 0; i < 6; i++) {
    uint64_t w = 0;
    for (int j = 0; j < 8; j++) w = (w << 8) | b48[(5 - i) * 8 + j];
    v[i] = w;
  }
  // v < 2^384 < 6p, so at most a handful of subtractions (v[6] is
  // always 0 for 48-byte input; no borrow can leave the low 6 limbs)
  while (!(v[6] == 0 && cmp6(v, PL) < 0)) {
    u128 bw = 0;
    for (int i = 0; i < 6; i++) {
      u128 d = (u128)v[i] - PL[i] - (uint64_t)bw;
      v[i] = (uint64_t)d;
      bw = (d >> 64) ? 1 : 0;
    }
  }
  Fp t, r2;
  memcpy(t.l, v, 48);
  memcpy(r2.l, R2L, 48);
  fp_mul(r, t, r2);
}

// try-and-increment hash-to-G1 (identical to the Python oracle)
static int hash_to_g1(G1 &out, const uint8_t *msg, size_t msg_len,
                      const uint8_t *dst, size_t dst_len) {
  uint8_t dstc[300];
  if (dst_len > 250) return -1;
  memcpy(dstc, dst, dst_len);
  memcpy(dstc + dst_len, "|ctr=", 5);
  for (int ctr = 0; ctr < 256; ctr++) {
    dstc[dst_len + 5] = (uint8_t)ctr;
    uint8_t seed[64];
    if (xmd64(seed, msg, msg_len, dstc, dst_len + 6) != 0) return -1;
    Fp x;
    fp_from_wide_be(x, seed);
    Fp rhs, t;
    fp_sqr(t, x);
    fp_mul(rhs, t, x);
    fp_add(rhs, rhs, B1);
    Fp y;
    if (!fp_sqrt(y, rhs)) continue;
    bool odd = fp_is_odd(y);
    if (odd != ((seed[63] & 1) != 0)) fp_neg(y, y);
    G1 pt = {x, y, false};
    G1 cleared;
    g1_mul_bytes(cleared, pt, H1_BYTES, 16);
    if (!cleared.inf) {
      out = cleared;
      return 0;
    }
  }
  return -1;
}

// --------------------------------------------------- serialization
static const uint8_t C_FLAG = 0x80, I_FLAG = 0x40, S_FLAG = 0x20;

static void g1_compress(uint8_t out[48], const G1 &p) {
  if (p.inf) {
    memset(out, 0, 48);
    out[0] = C_FLAG | I_FLAG;
    return;
  }
  fp_to_bytes_be(out, p.x);
  out[0] |= C_FLAG;
  if (fp_is_big(p.y)) out[0] |= S_FLAG;
}
static int g1_decompress(G1 &r, const uint8_t in[48], bool subgroup) {
  uint8_t flags = in[0];
  if (!(flags & C_FLAG)) return -1;
  if (flags & I_FLAG) {
    if (flags & 0x3F) return -1;
    for (int i = 1; i < 48; i++)
      if (in[i]) return -1;
    r.inf = true;
    r.x = FP_ZERO;
    r.y = FP_ONE;
    return 0;
  }
  uint8_t xb[48];
  memcpy(xb, in, 48);
  xb[0] &= 0x1F;
  // range check x < p
  {
    uint64_t v[6];
    for (int i = 0; i < 6; i++) {
      uint64_t w = 0;
      for (int j = 0; j < 8; j++) w = (w << 8) | xb[(5 - i) * 8 + j];
      v[i] = w;
    }
    if (cmp6(v, PL) >= 0) return -1;
  }
  Fp x;
  fp_from_bytes_be(x, xb);
  Fp rhs, t, y;
  fp_sqr(t, x);
  fp_mul(rhs, t, x);
  fp_add(rhs, rhs, B1);
  if (!fp_sqrt(y, rhs)) return -1;
  bool big = fp_is_big(y);
  if (big != ((flags & S_FLAG) != 0)) fp_neg(y, y);
  r.x = x;
  r.y = y;
  r.inf = false;
  if (subgroup && !g1_in_subgroup(r)) return -1;
  return 0;
}
static void g2_compress(uint8_t out[96], const G2 &p) {
  if (p.inf) {
    memset(out, 0, 96);
    out[0] = C_FLAG | I_FLAG;
    return;
  }
  fp_to_bytes_be(out, p.x.c1);
  fp_to_bytes_be(out + 48, p.x.c0);
  out[0] |= C_FLAG;
  bool big = fp_is_big(p.y.c1) ||
             (fp_is_zero(p.y.c1) && fp_is_big(p.y.c0));
  if (big) out[0] |= S_FLAG;
}
static int g2_decompress(G2 &r, const uint8_t in[96], bool subgroup) {
  uint8_t flags = in[0];
  if (!(flags & C_FLAG)) return -1;
  if (flags & I_FLAG) {
    if (flags & 0x3F) return -1;
    for (int i = 1; i < 96; i++)
      if (in[i]) return -1;
    r.inf = true;
    r.x = F2_ZERO;
    r.y = F2_ONE;
    return 0;
  }
  uint8_t c1b[48], c0b[48];
  memcpy(c1b, in, 48);
  c1b[0] &= 0x1F;
  memcpy(c0b, in + 48, 48);
  for (int part = 0; part < 2; part++) {
    const uint8_t *b = part ? c0b : c1b;
    uint64_t v[6];
    for (int i = 0; i < 6; i++) {
      uint64_t w = 0;
      for (int j = 0; j < 8; j++) w = (w << 8) | b[(5 - i) * 8 + j];
      v[i] = w;
    }
    if (cmp6(v, PL) >= 0) return -1;
  }
  Fp2 x;
  fp_from_bytes_be(x.c1, c1b);
  fp_from_bytes_be(x.c0, c0b);
  Fp2 rhs, t, y;
  f2_sqr(t, x);
  f2_mul(rhs, t, x);
  f2_add(rhs, rhs, B2);
  if (!f2_sqrt(y, rhs)) return -1;
  bool big = fp_is_big(y.c1) || (fp_is_zero(y.c1) && fp_is_big(y.c0));
  if (big != ((flags & S_FLAG) != 0)) f2_neg(y, y);
  r.x = x;
  r.y = y;
  r.inf = false;
  if (subgroup && !g2_in_subgroup(r)) return -1;
  return 0;
}

// ---------------------------------------------------------------- init
static bool INIT_DONE = false;
static G2 NEG_G2_GEN;
static void init_all() {
  if (INIT_DONE) return;
  memset(&FP_ZERO, 0, sizeof(FP_ZERO));
  // FP_ONE = to_mont(1)
  {
    Fp one = {{1, 0, 0, 0, 0, 0}}, r2;
    memcpy(r2.l, R2L, 48);
    fp_mul(FP_ONE, one, r2);
  }
  F2_ZERO.c0 = FP_ZERO;
  F2_ZERO.c1 = FP_ZERO;
  F2_ONE.c0 = FP_ONE;
  F2_ONE.c1 = FP_ZERO;
  XI.c0 = FP_ONE;
  XI.c1 = FP_ONE;
  F6_ZERO.c0 = F2_ZERO; F6_ZERO.c1 = F2_ZERO; F6_ZERO.c2 = F2_ZERO;
  F6_ONE.c0 = F2_ONE; F6_ONE.c1 = F2_ZERO; F6_ONE.c2 = F2_ZERO;
  F12_ONE.c0 = F6_ONE;
  F12_ONE.c1 = F6_ZERO;
  // B1 = 4, B2 = 4*XI
  Fp two;
  fp_add(two, FP_ONE, FP_ONE);
  fp_add(B1, two, two);
  f2_muls(B2, XI, 4);
  // generators (standard constants, big-endian)
  static const uint8_t G1X[48] = {
      0x17,0xf1,0xd3,0xa7,0x31,0x97,0xd7,0x94,0x26,0x95,0x63,0x8c,
      0x4f,0xa9,0xac,0x0f,0xc3,0x68,0x8c,0x4f,0x97,0x74,0xb9,0x05,
      0xa1,0x4e,0x3a,0x3f,0x17,0x1b,0xac,0x58,0x6c,0x55,0xe8,0x3f,
      0xf9,0x7a,0x1a,0xef,0xfb,0x3a,0xf0,0x0a,0xdb,0x22,0xc6,0xbb};
  static const uint8_t G1Y[48] = {
      0x08,0xb3,0xf4,0x81,0xe3,0xaa,0xa0,0xf1,0xa0,0x9e,0x30,0xed,
      0x74,0x1d,0x8a,0xe4,0xfc,0xf5,0xe0,0x95,0xd5,0xd0,0x0a,0xf6,
      0x00,0xdb,0x18,0xcb,0x2c,0x04,0xb3,0xed,0xd0,0x3c,0xc7,0x44,
      0xa2,0x88,0x8a,0xe4,0x0c,0xaa,0x23,0x29,0x46,0xc5,0xe7,0xe1};
  static const uint8_t G2X0[48] = {
      0x02,0x4a,0xa2,0xb2,0xf0,0x8f,0x0a,0x91,0x26,0x08,0x05,0x27,
      0x2d,0xc5,0x10,0x51,0xc6,0xe4,0x7a,0xd4,0xfa,0x40,0x3b,0x02,
      0xb4,0x51,0x0b,0x64,0x7a,0xe3,0xd1,0x77,0x0b,0xac,0x03,0x26,
      0xa8,0x05,0xbb,0xef,0xd4,0x80,0x56,0xc8,0xc1,0x21,0xbd,0xb8};
  static const uint8_t G2X1[48] = {
      0x13,0xe0,0x2b,0x60,0x52,0x71,0x9f,0x60,0x7d,0xac,0xd3,0xa0,
      0x88,0x27,0x4f,0x65,0x59,0x6b,0xd0,0xd0,0x99,0x20,0xb6,0x1a,
      0xb5,0xda,0x61,0xbb,0xdc,0x7f,0x50,0x49,0x33,0x4c,0xf1,0x12,
      0x13,0x94,0x5d,0x57,0xe5,0xac,0x7d,0x05,0x5d,0x04,0x2b,0x7e};
  static const uint8_t G2Y0[48] = {
      0x0c,0xe5,0xd5,0x27,0x72,0x7d,0x6e,0x11,0x8c,0xc9,0xcd,0xc6,
      0xda,0x2e,0x35,0x1a,0xad,0xfd,0x9b,0xaa,0x8c,0xbd,0xd3,0xa7,
      0x6d,0x42,0x9a,0x69,0x51,0x60,0xd1,0x2c,0x92,0x3a,0xc9,0xcc,
      0x3b,0xac,0xa2,0x89,0xe1,0x93,0x54,0x86,0x08,0xb8,0x28,0x01};
  static const uint8_t G2Y1[48] = {
      0x06,0x06,0xc4,0xa0,0x2e,0xa7,0x34,0xcc,0x32,0xac,0xd2,0xb0,
      0x2b,0xc2,0x8b,0x99,0xcb,0x3e,0x28,0x7e,0x85,0xa7,0x63,0xaf,
      0x26,0x74,0x92,0xab,0x57,0x2e,0x99,0xab,0x3f,0x37,0x0d,0x27,
      0x5c,0xec,0x1d,0xa1,0xaa,0xa9,0x07,0x5f,0xf0,0x5f,0x79,0xbe};
  fp_from_bytes_be(G1_GEN.x, G1X);
  fp_from_bytes_be(G1_GEN.y, G1Y);
  G1_GEN.inf = false;
  fp_from_bytes_be(G2_GEN.x.c0, G2X0);
  fp_from_bytes_be(G2_GEN.x.c1, G2X1);
  fp_from_bytes_be(G2_GEN.y.c0, G2Y0);
  fp_from_bytes_be(G2_GEN.y.c1, G2Y1);
  G2_GEN.inf = false;
  NEG_G2_GEN = G2_GEN;
  f2_neg(NEG_G2_GEN.y, G2_GEN.y);
  // Frobenius gammas: GAMMA_V = XI^((p-1)/3) = (XI^((p-1)/6))^2
  f2_pow(GAMMA_W, XI, EXP_P1_6, 48);
  f2_sqr(GAMMA_V, GAMMA_W);
  f2_mul(GAMMA_V2, GAMMA_V, GAMMA_V);
  INIT_DONE = true;
}

// ----------------------------------------------------------------- API
extern "C" {

// 1 = valid, 0 = invalid/malformed
int cessbls_verify(const uint8_t *pk96, const uint8_t *msg, size_t msg_len,
                   const uint8_t *sig48, const uint8_t *dst,
                   size_t dst_len) {
  init_all();
  G2 pk;
  G1 sig;
  if (g2_decompress(pk, pk96, true) != 0) return 0;
  if (g1_decompress(sig, sig48, true) != 0) return 0;
  if (pk.inf || sig.inf) return 0;
  G1 h;
  if (hash_to_g1(h, msg, msg_len, dst, dst_len) != 0) return 0;
  Fp12 f1, f2v, f;
  miller_loop(f1, sig, NEG_G2_GEN);
  miller_loop(f2v, h, pk);
  f12_mul(f, f1, f2v);
  Fp12 out;
  final_exp(out, f);
  return f12_is_one(out) ? 1 : 0;
}

// sig = sk * H(msg); sk is 32 bytes big-endian (already reduced mod r
// by the caller). Returns 0 on success.
int cessbls_sign(const uint8_t *sk32, const uint8_t *msg, size_t msg_len,
                 const uint8_t *dst, size_t dst_len, uint8_t *out48) {
  init_all();
  G1 h, s;
  if (hash_to_g1(h, msg, msg_len, dst, dst_len) != 0) return -1;
  g1_mul_bytes(s, h, sk32, 32);
  g1_compress(out48, s);
  return 0;
}

// pk = sk * G2. Returns 0 on success.
int cessbls_pk_from_sk(const uint8_t *sk32, uint8_t *out96) {
  init_all();
  G2 pk;
  g2_mul_bytes(pk, G2_GEN, sk32, 32);
  g2_compress(out96, pk);
  return 0;
}

// aggregate verify over n (pk, msg) pairs against one aggregate sig.
// msgs are concatenated; msg_lens holds each length. 1 = valid.
int cessbls_aggregate_verify(size_t n, const uint8_t *pks96,
                             const uint8_t *msgs, const size_t *msg_lens,
                             const uint8_t *sig48, const uint8_t *dst,
                             size_t dst_len) {
  init_all();
  G1 sig;
  if (g1_decompress(sig, sig48, true) != 0) return 0;
  if (sig.inf) return 0;
  Fp12 f, fi;
  miller_loop(f, sig, NEG_G2_GEN);
  const uint8_t *mp = msgs;
  for (size_t i = 0; i < n; i++) {
    G2 pk;
    if (g2_decompress(pk, pks96 + 96 * i, true) != 0) return 0;
    if (pk.inf) return 0;
    G1 h;
    if (hash_to_g1(h, mp, msg_lens[i], dst, dst_len) != 0) return 0;
    mp += msg_lens[i];
    miller_loop(fi, h, pk);
    f12_mul(f, f, fi);
  }
  Fp12 out;
  final_exp(out, f);
  return f12_is_one(out) ? 1 : 0;
}

// aggregate n G1 signatures. Returns 0 on success.
int cessbls_aggregate(size_t n, const uint8_t *sigs48, uint8_t *out48) {
  init_all();
  G1 acc;
  acc.inf = true;
  acc.x = FP_ZERO;
  acc.y = FP_ONE;
  for (size_t i = 0; i < n; i++) {
    G1 s;
    if (g1_decompress(s, sigs48 + 48 * i, true) != 0) return -1;
    G1 sum;
    g1_add(sum, acc, s);
    acc = sum;
  }
  g1_compress(out48, acc);
  return 0;
}

// internal sanity: generator orders + pairing bilinearity on small
// scalars. 1 = healthy.
int cessbls_selftest() {
  init_all();
  if (!g1_on_curve(G1_GEN) || !g2_on_curve(G2_GEN)) return 0;
  if (!g1_in_subgroup(G1_GEN) || !g2_in_subgroup(G2_GEN)) return 0;
  // e(2P, 3Q) == e(3P, 2Q) (both = e(P,Q)^6), != 1
  uint8_t two[1] = {2}, three[1] = {3};
  G1 p2, p3;
  G2 q2, q3;
  g1_mul_bytes(p2, G1_GEN, two, 1);
  g1_mul_bytes(p3, G1_GEN, three, 1);
  g2_mul_bytes(q2, G2_GEN, two, 1);
  g2_mul_bytes(q3, G2_GEN, three, 1);
  Fp12 a, b, ea, eb;
  miller_loop(a, p2, q3);
  miller_loop(b, p3, q2);
  final_exp(ea, a);
  final_exp(eb, b);
  if (f12_is_one(ea)) return 0;
  for (int i = 0; i < 1; i++) {
    if (memcmp(&ea, &eb, sizeof(ea)) != 0) return 0;
  }
  return 1;
}

}  // extern "C"
