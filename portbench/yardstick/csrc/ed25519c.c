/* The benchmark's signer: a frozen copy of the port's
 * stellar_core_tpu_torch/native/ed25519c.c (commit 8db80e4), with
 * prep_constants.h as native/gen_constants.py wrote it there. The
 * benchmark builds it with `cc` into portbench/cache/ and signs its
 * traffic with it; it never calls the port's signer. Do not edit: it is
 * part of the yardstick.
 *
 * The original header follows.
 *
 * Self-contained ed25519 + X25519 for containers without OpenSSL bindings.
 *
 * Copied from stellar_core_tpu/native/ed25519c.c at commit 6685f6a; carry a
 * fix in either copy to the other. In this package it is the CPU signer and
 * the independent CPU verifier that the CUDA kernel is held against.
 *
 * Role: the synchronous CPU crypto floor under crypto/keys.py when the
 * `cryptography` package is absent — sign, public-key derivation, and
 * RFC 8032 cofactorless verify with EXACTLY the accept/reject semantics
 * of ops/ed25519.py's verify_oracle (strict S < L, non-canonical point
 * encodings rejected, affine compare against the decompressed R). The
 * pure-Python fallback (crypto/fallback.py) is the behavioral oracle;
 * tests/test_crypto.py asserts parity triple-wise with the TPU kernel.
 *
 * Field arithmetic: 5x51-bit limbs with unsigned __int128 products
 * (portable C11, same toolchain contract as prep.c). Not constant-time —
 * this backs tests and benchmarks, not production key handling.
 *
 * Shares prep_constants.h (SHA-512 round constants, L/P/mu limbs) with
 * prep.c via the generated build header.
 */

#include <stdint.h>
#include <string.h>

#include "prep_constants.h"

typedef unsigned __int128 u128;

/* ------------------------------------------------------------- SHA-512 */

static inline uint64_t rotr64(uint64_t x, int n)
{
    return (x >> n) | (x << (64 - n));
}

static inline uint64_t load_be64(const uint8_t *p)
{
    uint64_t v = 0;
    for (int i = 0; i < 8; i++)
        v = (v << 8) | p[i];
    return v;
}

static void sha512_block(uint64_t st[8], const uint8_t *block)
{
    uint64_t w[80];
    for (int i = 0; i < 16; i++)
        w[i] = load_be64(block + 8 * i);
    for (int i = 16; i < 80; i++) {
        uint64_t s0 = rotr64(w[i - 15], 1) ^ rotr64(w[i - 15], 8) ^
                      (w[i - 15] >> 7);
        uint64_t s1 = rotr64(w[i - 2], 19) ^ rotr64(w[i - 2], 61) ^
                      (w[i - 2] >> 6);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint64_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint64_t e = st[4], f = st[5], g = st[6], h = st[7];
    for (int i = 0; i < 80; i++) {
        uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
        uint64_t ch = (e & f) ^ (~e & g);
        uint64_t t1 = h + S1 + ch + SHA512_K[i] + w[i];
        uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
        uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
        uint64_t t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

typedef struct {
    uint64_t st[8];
    uint8_t buf[128];
    uint64_t buflen;
    uint64_t total;
} sha512_ctx;

static void sha512_init(sha512_ctx *c)
{
    memcpy(c->st, SHA512_H0, sizeof c->st);
    c->buflen = 0;
    c->total = 0;
}

static void sha512_update(sha512_ctx *c, const uint8_t *p, uint64_t n)
{
    c->total += n;
    if (c->buflen) {
        uint64_t fill = 128 - c->buflen;
        if (fill > n)
            fill = n;
        memcpy(c->buf + c->buflen, p, fill);
        c->buflen += fill;
        p += fill;
        n -= fill;
        if (c->buflen == 128) {
            sha512_block(c->st, c->buf);
            c->buflen = 0;
        }
    }
    while (n >= 128) {
        sha512_block(c->st, p);
        p += 128;
        n -= 128;
    }
    if (n) {
        memcpy(c->buf, p, n);
        c->buflen = n;
    }
}

static void sha512_final(sha512_ctx *c, uint8_t out[64])
{
    uint64_t used = c->buflen;
    c->buf[used++] = 0x80;
    if (used > 112) {
        memset(c->buf + used, 0, 128 - used);
        sha512_block(c->st, c->buf);
        used = 0;
    }
    memset(c->buf + used, 0, 112 - used);
    uint64_t bits = c->total << 3;
    memset(c->buf + 112, 0, 8);
    for (int i = 0; i < 8; i++)
        c->buf[120 + i] = (uint8_t)(bits >> (8 * (7 - i)));
    sha512_block(c->st, c->buf);
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
            out[8 * i + j] = (uint8_t)(c->st[i] >> (8 * (7 - j)));
}

/* ----------------------------------------- 512-bit mod L (Barrett) */
/* identical algorithm to prep.c (same generated ED_MU / ED_L limbs) */

static void mod_L(const uint64_t x[8], uint64_t r[4])
{
    uint64_t prod[14];
    memset(prod, 0, sizeof prod);
    u128 carry = 0;
    for (int k = 0; k < 13; k++) {
        u128 acc = carry;
        uint64_t acc_hi = 0;
        int lo = k >= 4 ? k - 4 : 0;
        int hi = k < 8 ? k : 8 - 1;
        for (int i = lo; i <= hi && i < 8; i++) {
            int j = k - i;
            if (j < 0 || j > 4)
                continue;
            u128 t = (u128)x[i] * ED_MU[j];
            acc += t;
            if (acc < t)
                acc_hi++;
        }
        prod[k] = (uint64_t)acc;
        carry = (acc >> 64) + ((u128)acc_hi << 64);
    }
    prod[13] = (uint64_t)carry;
    uint64_t q[6];
    for (int i = 0; i < 6; i++)
        q[i] = prod[8 + i];

    uint64_t ql[5];
    memset(ql, 0, sizeof ql);
    carry = 0;
    for (int k = 0; k < 5; k++) {
        u128 acc = carry;
        for (int i = 0; i <= k && i < 6; i++) {
            int j = k - i;
            if (j > 3)
                continue;
            acc += (u128)q[i] * ED_L[j];
        }
        ql[k] = (uint64_t)acc;
        carry = acc >> 64;
    }
    uint64_t rr[5];
    u128 borrow = 0;
    for (int i = 0; i < 5; i++) {
        u128 xi = i < 8 ? x[i] : 0;
        u128 rhs = (u128)ql[i] + borrow;
        if (xi >= rhs) {
            rr[i] = (uint64_t)(xi - rhs);
            borrow = 0;
        } else {
            rr[i] = (uint64_t)((((u128)1) << 64) + xi - rhs);
            borrow = 1;
        }
    }
    for (int round = 0; round < 3; round++) {
        int ge = 0;
        if (rr[4]) {
            ge = 1;
        } else {
            ge = 1;
            for (int i = 3; i >= 0; i--) {
                if (rr[i] > ED_L[i])
                    break;
                if (rr[i] < ED_L[i]) {
                    ge = 0;
                    break;
                }
            }
        }
        if (!ge)
            break;
        u128 b2 = 0;
        for (int i = 0; i < 5; i++) {
            u128 rhs = (u128)(i < 4 ? ED_L[i] : 0) + b2;
            u128 xi = rr[i];
            if (xi >= rhs) {
                rr[i] = (uint64_t)(xi - rhs);
                b2 = 0;
            } else {
                rr[i] = (uint64_t)((((u128)1) << 64) + xi - rhs);
                b2 = 1;
            }
        }
    }
    for (int i = 0; i < 4; i++)
        r[i] = rr[i];
}

/* 256x256 -> 512 multiply then reduce: out = (a*b + c) mod L */
static void sc_muladd(const uint64_t a[4], const uint64_t b[4],
                      const uint64_t c[4], uint64_t out[4])
{
    uint64_t prod[8];
    memset(prod, 0, sizeof prod);
    u128 carry = 0;
    for (int k = 0; k < 8; k++) {
        u128 acc = carry;
        uint64_t acc_hi = 0;
        for (int i = 0; i < 4; i++) {
            int j = k - i;
            if (j < 0 || j > 3)
                continue;
            u128 t = (u128)a[i] * b[j];
            acc += t;
            if (acc < t)
                acc_hi++;
        }
        prod[k] = (uint64_t)acc;
        carry = (acc >> 64) + ((u128)acc_hi << 64);
    }
    u128 cc = 0;
    for (int i = 0; i < 4; i++) {
        cc += (u128)prod[i] + c[i];
        prod[i] = (uint64_t)cc;
        cc >>= 64;
    }
    for (int i = 4; i < 8 && cc; i++) {
        cc += prod[i];
        prod[i] = (uint64_t)cc;
        cc >>= 64;
    }
    mod_L(prod, out);
}

/* little-endian 32-byte < 4x64-bit-limb constant */
static int lt_le(const uint8_t b[32], const uint64_t lim[4])
{
    for (int i = 3; i >= 0; i--) {
        uint64_t v = 0;
        for (int j = 7; j >= 0; j--)
            v = (v << 8) | b[8 * i + j];
        if (v < lim[i])
            return 1;
        if (v > lim[i])
            return 0;
    }
    return 0;
}

/* --------------------------------------------- field: 5x51-bit limbs */

#define MASK51 0x7FFFFFFFFFFFFULL

typedef uint64_t fe[5];

static inline uint64_t load64(const uint8_t *p)
{
    uint64_t v = 0;
    for (int i = 7; i >= 0; i--)
        v = (v << 8) | p[i];
    return v;
}

static void fe_frombytes(fe h, const uint8_t s[32])
{
    h[0] = load64(s) & MASK51;
    h[1] = (load64(s + 6) >> 3) & MASK51;
    h[2] = (load64(s + 12) >> 6) & MASK51;
    h[3] = (load64(s + 19) >> 1) & MASK51;
    h[4] = (load64(s + 24) >> 12) & MASK51;
}

static void fe_copy(fe h, const fe f) { memcpy(h, f, sizeof(fe)); }

static void fe_0(fe h) { memset(h, 0, sizeof(fe)); }

static void fe_1(fe h) { fe_0(h); h[0] = 1; }

static void fe_add(fe h, const fe f, const fe g)
{
    uint64_t c;
    h[0] = f[0] + g[0];
    h[1] = f[1] + g[1];
    h[2] = f[2] + g[2];
    h[3] = f[3] + g[3];
    h[4] = f[4] + g[4];
    c = h[0] >> 51; h[0] &= MASK51; h[1] += c;
    c = h[1] >> 51; h[1] &= MASK51; h[2] += c;
    c = h[2] >> 51; h[2] &= MASK51; h[3] += c;
    c = h[3] >> 51; h[3] &= MASK51; h[4] += c;
    c = h[4] >> 51; h[4] &= MASK51; h[0] += 19 * c;
}

/* h = f - g, computed as f + 2p - g to stay non-negative */
static void fe_sub(fe h, const fe f, const fe g)
{
    uint64_t c;
    h[0] = f[0] + 0xFFFFFFFFFFFDAULL - g[0];
    h[1] = f[1] + 0xFFFFFFFFFFFFEULL - g[1];
    h[2] = f[2] + 0xFFFFFFFFFFFFEULL - g[2];
    h[3] = f[3] + 0xFFFFFFFFFFFFEULL - g[3];
    h[4] = f[4] + 0xFFFFFFFFFFFFEULL - g[4];
    c = h[0] >> 51; h[0] &= MASK51; h[1] += c;
    c = h[1] >> 51; h[1] &= MASK51; h[2] += c;
    c = h[2] >> 51; h[2] &= MASK51; h[3] += c;
    c = h[3] >> 51; h[3] &= MASK51; h[4] += c;
    c = h[4] >> 51; h[4] &= MASK51; h[0] += 19 * c;
}

static void fe_mul(fe h, const fe f, const fe g)
{
    u128 f0 = f[0], f1 = f[1], f2 = f[2], f3 = f[3], f4 = f[4];
    uint64_t g0 = g[0], g1 = g[1], g2 = g[2], g3 = g[3], g4 = g[4];
    uint64_t g1_19 = 19 * g1, g2_19 = 19 * g2;
    uint64_t g3_19 = 19 * g3, g4_19 = 19 * g4;
    u128 h0 = f0 * g0 + f1 * g4_19 + f2 * g3_19 + f3 * g2_19 + f4 * g1_19;
    u128 h1 = f0 * g1 + f1 * g0 + f2 * g4_19 + f3 * g3_19 + f4 * g2_19;
    u128 h2 = f0 * g2 + f1 * g1 + f2 * g0 + f3 * g4_19 + f4 * g3_19;
    u128 h3 = f0 * g3 + f1 * g2 + f2 * g1 + f3 * g0 + f4 * g4_19;
    u128 h4 = f0 * g4 + f1 * g3 + f2 * g2 + f3 * g1 + f4 * g0;
    uint64_t r0, r1, r2, r3, r4, c;
    r0 = (uint64_t)h0 & MASK51; h1 += (uint64_t)(h0 >> 51);
    r1 = (uint64_t)h1 & MASK51; h2 += (uint64_t)(h1 >> 51);
    r2 = (uint64_t)h2 & MASK51; h3 += (uint64_t)(h2 >> 51);
    r3 = (uint64_t)h3 & MASK51; h4 += (uint64_t)(h3 >> 51);
    r4 = (uint64_t)h4 & MASK51;
    r0 += 19 * (uint64_t)(h4 >> 51);
    c = r0 >> 51; r0 &= MASK51; r1 += c;
    c = r1 >> 51; r1 &= MASK51; r2 += c;
    h[0] = r0; h[1] = r1; h[2] = r2; h[3] = r3; h[4] = r4;
}

/* dedicated squaring: 15 wide products instead of fe_mul's 25 */
static void fe_sq(fe h, const fe f)
{
    uint64_t f0 = f[0], f1 = f[1], f2 = f[2], f3 = f[3], f4 = f[4];
    uint64_t f1_2 = 2 * f1, f2_2 = 2 * f2;
    uint64_t f3_2 = 2 * f3, f4_2 = 2 * f4;
    uint64_t f3_19 = 19 * f3, f4_19 = 19 * f4;
    u128 h0 = (u128)f0 * f0 + (u128)f1_2 * f4_19 + (u128)f2_2 * f3_19;
    u128 h1 = (u128)f0 * f1_2 + (u128)f2_2 * f4_19 + (u128)f3 * f3_19;
    u128 h2 = (u128)f0 * f2_2 + (u128)f1 * f1 + (u128)f3_2 * f4_19;
    u128 h3 = (u128)f0 * f3_2 + (u128)f1_2 * f2 + (u128)f4 * f4_19;
    u128 h4 = (u128)f0 * f4_2 + (u128)f1_2 * f3 + (u128)f2 * f2;
    uint64_t r0, r1, r2, r3, r4, c;
    r0 = (uint64_t)h0 & MASK51; h1 += (uint64_t)(h0 >> 51);
    r1 = (uint64_t)h1 & MASK51; h2 += (uint64_t)(h1 >> 51);
    r2 = (uint64_t)h2 & MASK51; h3 += (uint64_t)(h2 >> 51);
    r3 = (uint64_t)h3 & MASK51; h4 += (uint64_t)(h3 >> 51);
    r4 = (uint64_t)h4 & MASK51;
    r0 += 19 * (uint64_t)(h4 >> 51);
    c = r0 >> 51; r0 &= MASK51; r1 += c;
    c = r1 >> 51; r1 &= MASK51; r2 += c;
    h[0] = r0; h[1] = r1; h[2] = r2; h[3] = r3; h[4] = r4;
}

/* h = f^(2^k), k >= 1 */
static void fe_pow2k(fe h, const fe f, int k)
{
    fe_sq(h, f);
    for (int i = 1; i < k; i++)
        fe_sq(h, h);
}

/* freeze to fully-reduced form */
static void fe_tobytes(uint8_t s[32], const fe f)
{
    fe t;
    fe_copy(t, f);
    uint64_t c;
    for (int i = 0; i < 2; i++) {
        c = t[0] >> 51; t[0] &= MASK51; t[1] += c;
        c = t[1] >> 51; t[1] &= MASK51; t[2] += c;
        c = t[2] >> 51; t[2] &= MASK51; t[3] += c;
        c = t[3] >> 51; t[3] &= MASK51; t[4] += c;
        c = t[4] >> 51; t[4] &= MASK51; t[0] += 19 * c;
    }
    /* q = 1 iff t >= p */
    uint64_t q = (t[0] + 19) >> 51;
    q = (t[1] + q) >> 51;
    q = (t[2] + q) >> 51;
    q = (t[3] + q) >> 51;
    q = (t[4] + q) >> 51;
    t[0] += 19 * q;
    c = t[0] >> 51; t[0] &= MASK51; t[1] += c;
    c = t[1] >> 51; t[1] &= MASK51; t[2] += c;
    c = t[2] >> 51; t[2] &= MASK51; t[3] += c;
    c = t[3] >> 51; t[3] &= MASK51; t[4] += c;
    t[4] &= MASK51;
    uint64_t w0 = t[0] | (t[1] << 51);
    uint64_t w1 = (t[1] >> 13) | (t[2] << 38);
    uint64_t w2 = (t[2] >> 26) | (t[3] << 25);
    uint64_t w3 = (t[3] >> 39) | (t[4] << 12);
    for (int i = 0; i < 8; i++) {
        s[i] = (uint8_t)(w0 >> (8 * i));
        s[8 + i] = (uint8_t)(w1 >> (8 * i));
        s[16 + i] = (uint8_t)(w2 >> (8 * i));
        s[24 + i] = (uint8_t)(w3 >> (8 * i));
    }
}

static int fe_eq(const fe a, const fe b)
{
    uint8_t x[32], y[32];
    fe_tobytes(x, a);
    fe_tobytes(y, b);
    return memcmp(x, y, 32) == 0;
}

static int fe_iszero(const fe a)
{
    uint8_t x[32];
    static const uint8_t zero[32];
    fe_tobytes(x, a);
    return memcmp(x, zero, 32) == 0;
}

static int fe_parity(const fe a)
{
    uint8_t x[32];
    fe_tobytes(x, a);
    return x[0] & 1;
}

/* h = f^e where e is 32 little-endian bytes (MSB-first square&multiply) */
static void fe_pow(fe h, const fe f, const uint8_t e[32])
{
    fe acc, base;
    fe_1(acc);
    fe_copy(base, f);
    int started = 0;
    for (int i = 31; i >= 0; i--) {
        for (int b = 7; b >= 0; b--) {
            if (started)
                fe_sq(acc, acc);
            if ((e[i] >> b) & 1) {
                if (started)
                    fe_mul(acc, acc, base);
                else {
                    fe_copy(acc, base);
                    started = 1;
                }
            }
        }
    }
    fe_copy(h, acc);
}

/* exponent byte arrays (little-endian) */
static const uint8_t EXP_PM14[32] = {     /* (p - 1) / 4 = 2^253 - 5 */
    0xfb, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
    0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
    0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
    0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x1f};

/* f^(p-2) = f^(2^255 - 21) via the standard addition chain
   (254 squarings + 11 multiplies vs ~500 ops for generic fe_pow) */
static void fe_invert(fe out, const fe z)
{
    fe t0, t1, t2, t3;
    fe_sq(t0, z);                  /* 2 */
    fe_pow2k(t1, t0, 2);           /* 8 */
    fe_mul(t1, z, t1);             /* 9 */
    fe_mul(t0, t0, t1);            /* 11 */
    fe_sq(t2, t0);                 /* 22 */
    fe_mul(t1, t1, t2);            /* 31 = 2^5 - 1 */
    fe_pow2k(t2, t1, 5);
    fe_mul(t1, t2, t1);            /* 2^10 - 1 */
    fe_pow2k(t2, t1, 10);
    fe_mul(t2, t2, t1);            /* 2^20 - 1 */
    fe_pow2k(t3, t2, 20);
    fe_mul(t2, t3, t2);            /* 2^40 - 1 */
    fe_pow2k(t2, t2, 10);
    fe_mul(t1, t2, t1);            /* 2^50 - 1 */
    fe_pow2k(t2, t1, 50);
    fe_mul(t2, t2, t1);            /* 2^100 - 1 */
    fe_pow2k(t3, t2, 100);
    fe_mul(t2, t3, t2);            /* 2^200 - 1 */
    fe_pow2k(t2, t2, 50);
    fe_mul(t1, t2, t1);            /* 2^250 - 1 */
    fe_pow2k(t1, t1, 5);           /* 2^255 - 2^5 */
    fe_mul(out, t1, t0);           /* 2^255 - 21 */
}

/* f^(2^252 - 3): frombytes needs f^((p+3)/8) = pow22523(f) * f */
static void fe_pow22523(fe out, const fe z)
{
    fe t0, t1, t2;
    fe_sq(t0, z);                  /* 2 */
    fe_pow2k(t1, t0, 2);           /* 8 */
    fe_mul(t1, z, t1);             /* 9 */
    fe_mul(t0, t0, t1);            /* 11 */
    fe_sq(t0, t0);                 /* 22 */
    fe_mul(t0, t1, t0);            /* 31 = 2^5 - 1 */
    fe_pow2k(t1, t0, 5);
    fe_mul(t0, t1, t0);            /* 2^10 - 1 */
    fe_pow2k(t1, t0, 10);
    fe_mul(t1, t1, t0);            /* 2^20 - 1 */
    fe_pow2k(t2, t1, 20);
    fe_mul(t1, t2, t1);            /* 2^40 - 1 */
    fe_pow2k(t1, t1, 10);
    fe_mul(t0, t1, t0);            /* 2^50 - 1 */
    fe_pow2k(t1, t0, 50);
    fe_mul(t1, t1, t0);            /* 2^100 - 1 */
    fe_pow2k(t2, t1, 100);
    fe_mul(t1, t2, t1);            /* 2^200 - 1 */
    fe_pow2k(t1, t1, 50);
    fe_mul(t0, t1, t0);            /* 2^250 - 1 */
    fe_pow2k(t0, t0, 2);           /* 2^252 - 4 */
    fe_mul(out, t0, z);            /* 2^252 - 3 */
}

/* ------------------------------------------------ group: extended coords */

typedef struct {
    fe x, y, z, t;
} ge;

static fe FE_D2;       /* 2d */
static fe FE_SQRTM1;   /* sqrt(-1) */
static fe FE_D;
static ge GE_B;        /* base point */
static int g_init_done = 0;

static void ge_identity(ge *q)
{
    fe_0(q->x);
    fe_1(q->y);
    fe_1(q->z);
    fe_0(q->t);
}

static void ge_add(ge *out, const ge *p, const ge *q)
{
    fe a, b, c, d, e, f, g, h, t0, t1;
    fe_sub(t0, p->y, p->x);
    fe_sub(t1, q->y, q->x);
    fe_mul(a, t0, t1);
    fe_add(t0, p->y, p->x);
    fe_add(t1, q->y, q->x);
    fe_mul(b, t0, t1);
    fe_mul(c, p->t, FE_D2);
    fe_mul(c, c, q->t);
    fe_mul(d, p->z, q->z);
    fe_add(d, d, d);
    fe_sub(e, b, a);
    fe_sub(f, d, c);
    fe_add(g, d, c);
    fe_add(h, b, a);
    fe_mul(out->x, e, f);
    fe_mul(out->y, g, h);
    fe_mul(out->z, f, g);
    fe_mul(out->t, e, h);
}

static void ge_dbl(ge *out, const ge *p)
{
    fe a, b, c, e, f, g, h, t0;
    fe_sq(a, p->x);
    fe_sq(b, p->y);
    fe_sq(c, p->z);
    fe_add(c, c, c);
    fe_add(h, a, b);
    fe_add(t0, p->x, p->y);
    fe_sq(t0, t0);
    fe_sub(e, h, t0);
    fe_sub(g, a, b);
    fe_add(f, c, g);
    fe_mul(out->x, e, f);
    fe_mul(out->y, g, h);
    fe_mul(out->z, f, g);
    fe_mul(out->t, e, h);
}

/* t[v] = [v]p for v = 0..15 (evens by doubling, odds by one add; the
   unified hwcd add formula is complete on a=-1/ed25519 anyway) */
static void ge_table16(ge t[16], const ge *p)
{
    ge_identity(&t[0]);
    t[1] = *p;
    for (int v = 2; v < 16; v++) {
        if (v & 1)
            ge_add(&t[v], &t[v - 1], p);
        else
            ge_dbl(&t[v], &t[v / 2]);
    }
}

/* fixed-base comb: GE_BCOMB[j][v] = [v * 16^j]B, built once at init.
   A base mult is then ~60 additions and ZERO doublings — the dominant
   cost of sign/public and of verify's [S]B half. */
#define COMB_NIBS 64
static ge GE_BCOMB[COMB_NIBS][16];

static void ge_scalarmult_base(ge *q, const uint8_t n[32])
{
    ge_identity(q);
    for (int j = 0; j < COMB_NIBS; j++) {
        int nib = (n[j >> 1] >> ((j & 1) * 4)) & 15;
        if (nib)
            ge_add(q, q, &GE_BCOMB[j][nib]);
    }
}

/* q = [n]p for a variable point: 4-bit fixed window
   (252 doublings + ~60 adds vs 512 doublings + ~128 adds naive) */
static void ge_scalarmult_w4(ge *q, const ge *p, const uint8_t n[32])
{
    ge t[16];
    ge_table16(t, p);
    ge_identity(q);
    int started = 0;
    for (int j = COMB_NIBS - 1; j >= 0; j--) {
        if (started) {
            ge_dbl(q, q);
            ge_dbl(q, q);
            ge_dbl(q, q);
            ge_dbl(q, q);
        }
        int nib = (n[j >> 1] >> ((j & 1) * 4)) & 15;
        if (nib) {
            ge_add(q, q, &t[nib]);
            started = 1;
        }
    }
}

static void ge_tobytes(uint8_t s[32], const ge *p)
{
    fe zi, x, y;
    fe_invert(zi, p->z);
    fe_mul(x, p->x, zi);
    fe_mul(y, p->y, zi);
    fe_tobytes(s, y);
    s[31] |= (uint8_t)(fe_parity(x) << 7);
}

/* RFC 8032 decompression matching ops/ed25519.py _recover_x exactly.
 * Input bytes must already satisfy y < p (caller checks lt_le vs ED_P).
 * Returns 0 on failure. */
static int ge_frombytes(ge *p, const uint8_t s[32])
{
    uint8_t yb[32];
    memcpy(yb, s, 32);
    int sign = yb[31] >> 7;
    yb[31] &= 0x7f;
    fe y, y2, num, den, x2, x, chk;
    fe_frombytes(y, yb);
    fe_sq(y2, y);
    fe one;
    fe_1(one);
    fe_sub(num, y2, one);           /* y^2 - 1 */
    fe_mul(den, y2, FE_D);
    fe_add(den, den, one);          /* d y^2 + 1 */
    fe_invert(den, den);
    fe_mul(x2, num, den);
    if (fe_iszero(x2)) {
        if (sign)
            return 0;
        fe_0(x);
    } else {
        fe_pow22523(x, x2);
        fe_mul(x, x, x2);       /* x2^((p+3)/8) = x2^(2^252 - 2) */
        fe_sq(chk, x);
        if (!fe_eq(chk, x2)) {
            fe_mul(x, x, FE_SQRTM1);
            fe_sq(chk, x);
            if (!fe_eq(chk, x2))
                return 0;
        }
        if (fe_parity(x) != sign) {
            fe zero;
            fe_0(zero);
            fe_sub(x, zero, x);
        }
    }
    fe_copy(p->x, x);
    fe_copy(p->y, y);
    fe_1(p->z);
    fe_mul(p->t, x, y);
    return 1;
}

int sct_ed25519_init(void)
{
    if (g_init_done)
        return 0;
    /* d = -121665 / 121666 */
    fe n121665, n121666, zero;
    fe_0(n121665);
    n121665[0] = 121665;
    fe_0(n121666);
    n121666[0] = 121666;
    fe_0(zero);
    fe t;
    fe_invert(t, n121666);
    fe_mul(FE_D, n121665, t);
    fe_sub(FE_D, zero, FE_D);
    fe_add(FE_D2, FE_D, FE_D);
    /* sqrt(-1) = 2^((p-1)/4) */
    fe two;
    fe_0(two);
    two[0] = 2;
    fe_pow(FE_SQRTM1, two, EXP_PM14);
    /* B: y = 4/5, x = recover(y, 0) */
    fe four, five, by;
    fe_0(four);
    four[0] = 4;
    fe_0(five);
    five[0] = 5;
    fe_invert(t, five);
    fe_mul(by, four, t);
    uint8_t byb[32];
    fe_tobytes(byb, by);
    if (!ge_frombytes(&GE_B, byb))
        return -1;
    /* comb tables: GE_BCOMB[j] holds [0..15] * (16^j B) */
    ge cur = GE_B;
    for (int j = 0; j < COMB_NIBS; j++) {
        ge_table16(GE_BCOMB[j], &cur);
        if (j + 1 < COMB_NIBS)
            ge_dbl(&cur, &GE_BCOMB[j][8]);   /* 16^(j+1) B */
    }
    g_init_done = 1;
    return 0;
}

/* --------------------------------------------------------------- ed25519 */

static void scalar_tobytes(uint8_t out[32], const uint64_t r[4])
{
    for (int w = 0; w < 4; w++)
        for (int j = 0; j < 8; j++)
            out[8 * w + j] = (uint8_t)(r[w] >> (8 * j));
}

static void digest_mod_L(const uint8_t digest[64], uint8_t out[32])
{
    uint64_t x[8], red[4];
    for (int w = 0; w < 8; w++) {
        uint64_t v = 0;
        for (int j = 7; j >= 0; j--)
            v = (v << 8) | digest[8 * w + j];
        x[w] = v;
    }
    mod_L(x, red);
    scalar_tobytes(out, red);
}

static void clamp(uint8_t a[32])
{
    a[0] &= 248;
    a[31] &= 127;
    a[31] |= 64;
}

int sct_ed25519_public(const uint8_t seed[32], uint8_t out[32])
{
    sha512_ctx c;
    uint8_t h[64];
    sha512_init(&c);
    sha512_update(&c, seed, 32);
    sha512_final(&c, h);
    clamp(h);
    ge A;
    ge_scalarmult_base(&A, h);
    ge_tobytes(out, &A);
    return 0;
}

int sct_ed25519_sign(const uint8_t seed[32], const uint8_t *msg,
                     uint64_t mlen, uint8_t out_sig[64])
{
    sha512_ctx c;
    uint8_t h[64], a_enc[32], r_scalar[32], k_scalar[32], digest[64];
    sha512_init(&c);
    sha512_update(&c, seed, 32);
    sha512_final(&c, h);
    clamp(h);
    ge A;
    ge_scalarmult_base(&A, h);
    ge_tobytes(a_enc, &A);

    /* r = SHA512(prefix || msg) mod L */
    sha512_init(&c);
    sha512_update(&c, h + 32, 32);
    sha512_update(&c, msg, mlen);
    sha512_final(&c, digest);
    digest_mod_L(digest, r_scalar);

    ge R;
    ge_scalarmult_base(&R, r_scalar);
    ge_tobytes(out_sig, &R);

    /* k = SHA512(R || A || msg) mod L */
    sha512_init(&c);
    sha512_update(&c, out_sig, 32);
    sha512_update(&c, a_enc, 32);
    sha512_update(&c, msg, mlen);
    sha512_final(&c, digest);
    digest_mod_L(digest, k_scalar);

    /* S = (r + k*a) mod L */
    uint64_t ka[4], kk[4], aa[4], rr[4], ss[4];
    for (int w = 0; w < 4; w++) {
        uint64_t kv = 0, av = 0, rv = 0;
        for (int j = 7; j >= 0; j--) {
            kv = (kv << 8) | k_scalar[8 * w + j];
            av = (av << 8) | h[8 * w + j];
            rv = (rv << 8) | r_scalar[8 * w + j];
        }
        kk[w] = kv;
        aa[w] = av;
        rr[w] = rv;
    }
    (void)ka;
    sc_muladd(kk, aa, rr, ss);
    scalar_tobytes(out_sig + 32, ss);
    return 0;
}

int sct_ed25519_verify(const uint8_t pub[32], const uint8_t sig[64],
                       const uint8_t *msg, uint64_t mlen)
{
    uint8_t ayb[32], ryb[32];
    memcpy(ayb, pub, 32);
    memcpy(ryb, sig, 32);
    ayb[31] &= 0x7f;
    ryb[31] &= 0x7f;
    /* strict canonicality: S < L, yA < p, yR < p (oracle parity) */
    if (!lt_le(sig + 32, ED_L) || !lt_le(ayb, ED_P) || !lt_le(ryb, ED_P))
        return 0;
    ge A, R;
    if (!ge_frombytes(&A, pub) || !ge_frombytes(&R, sig))
        return 0;

    uint8_t digest[64], k_scalar[32];
    sha512_ctx c;
    sha512_init(&c);
    sha512_update(&c, sig, 32);
    sha512_update(&c, pub, 32);
    sha512_update(&c, msg, mlen);
    sha512_final(&c, digest);
    digest_mod_L(digest, k_scalar);

    /* Q = [S]B + [k](-A); accept iff Q == R affinely */
    ge negA = A;
    fe zero;
    fe_0(zero);
    fe_sub(negA.x, zero, A.x);
    fe_sub(negA.t, zero, A.t);
    ge sB, kA, Q;
    ge_scalarmult_base(&sB, sig + 32);
    ge_scalarmult_w4(&kA, &negA, k_scalar);
    ge_add(&Q, &sB, &kA);

    /* affine compare: X_q * Z_r == X_r * Z_q and same for Y */
    fe lhs, rhs;
    fe_mul(lhs, Q.x, R.z);
    fe_mul(rhs, R.x, Q.z);
    if (!fe_eq(lhs, rhs))
        return 0;
    fe_mul(lhs, Q.y, R.z);
    fe_mul(rhs, R.y, Q.z);
    return fe_eq(lhs, rhs);
}

int sct_ed25519_verify_batch(const uint8_t *pubs, const uint8_t *sigs,
                             const uint8_t *msgs, const uint64_t *msg_off,
                             int64_t n, uint8_t *out)
{
    for (int64_t i = 0; i < n; i++)
        out[i] = (uint8_t)sct_ed25519_verify(
            pubs + 32 * i, sigs + 64 * i, msgs + msg_off[i],
            msg_off[i + 1] - msg_off[i]);
    return 0;
}

/* ---------------------------------------------------------------- X25519 */

int sct_x25519(const uint8_t scalar[32], const uint8_t u[32],
               uint8_t out[32])
{
    uint8_t k[32], ub[32];
    memcpy(k, scalar, 32);
    k[0] &= 248;
    k[31] &= 127;
    k[31] |= 64;
    memcpy(ub, u, 32);
    ub[31] &= 0x7f;   /* RFC 7748: mask the top bit of u */

    fe x1, x2, z2, x3, z3;
    fe_frombytes(x1, ub);
    fe_1(x2);
    fe_0(z2);
    fe_copy(x3, x1);
    fe_1(z3);
    int swap = 0;
    fe a, aa, b, bb, e, cc, d, da, cb, t0, a24;
    fe_0(a24);
    a24[0] = 121665;
    for (int t = 254; t >= 0; t--) {
        int kt = (k[t >> 3] >> (t & 7)) & 1;
        if (swap ^ kt) {
            fe tmp;
            fe_copy(tmp, x2); fe_copy(x2, x3); fe_copy(x3, tmp);
            fe_copy(tmp, z2); fe_copy(z2, z3); fe_copy(z3, tmp);
        }
        swap = kt;
        fe_add(a, x2, z2);
        fe_sq(aa, a);
        fe_sub(b, x2, z2);
        fe_sq(bb, b);
        fe_sub(e, aa, bb);
        fe_add(cc, x3, z3);
        fe_sub(d, x3, z3);
        fe_mul(da, d, a);
        fe_mul(cb, cc, b);
        fe_add(t0, da, cb);
        fe_sq(x3, t0);
        fe_sub(t0, da, cb);
        fe_sq(t0, t0);
        fe_mul(z3, t0, x1);
        fe_mul(x2, aa, bb);
        fe_mul(t0, a24, e);
        fe_add(t0, t0, aa);
        fe_mul(z2, e, t0);
    }
    if (swap) {
        fe tmp;
        fe_copy(tmp, x2); fe_copy(x2, x3); fe_copy(x3, tmp);
        fe_copy(tmp, z2); fe_copy(z2, z3); fe_copy(z3, tmp);
    }
    fe_invert(z2, z2);
    fe_mul(x2, x2, z2);
    fe_tobytes(out, x2);
    return 0;
}
