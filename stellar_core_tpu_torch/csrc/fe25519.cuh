// GF(2^255-19) arithmetic for the Hopper ed25519 verify kernel.
//
// Radix 2^25.5 (ref10's layout): a field element is 10 signed int32 limbs,
// limb k at bit offset ceil(25.5 k) = 0,26,51,77,...,230, 26 bits wide for
// even k and 25 for odd k. The reference package (ops/field.py) uses 20
// limbs of 13 bits only because the TPU has no 64-bit multiply; Hopper
// issues a 32x32->64 multiply (IMAD.WIDE), so a product is 100 wide
// products (fe_mul) or 55 (fe_sq, symmetric half-product) instead of 400
// or 210 int32 products.
//
// A product f_i*g_j carries weight 2^(off_i + off_j) = 2^off_(i+j) times 2
// when i and j are both odd; columns with i + j >= 10 wrap with
// 2^255 = 19 (mod p).
//
// Bound audit (every value below is a magnitude; limbs are signed):
//   tight  T = 2^25: every limb after fe_carry / fe_mul / fe_sq
//          (ref10 carry chain: even limbs <= 2^25, odd <= 2^24 + 2^16).
//          A canonical value (limbs in [0, 2^26)) is within 2T.
//   fe_add/fe_sub/fe_neg do not carry: the result bound is the sum of the
//          operands' bounds. Callers keep every fe_mul/fe_sq input within
//          M = 4T = 2^27 (the point formulas need at most 4T, see
//          ed25519_verify.cu).
//   fe_mul column k = lo_k + 19 hi_k, with lo_k the i+j = k terms and
//          hi_k the i+j = k+10 terms, each term <= 2 M^2 = 2^55 (doubled
//          when both indices are odd). Worst column is k = 0:
//          M^2 + 19 (5*2 M^2 + 4 M^2) = 267 M^2 = 2^62.06 < 2^63.
//   fe_sq  the same columns as fe_mul(f, f), summed in another order: the
//          same bound. Its doubled operands 2 f_i <= 2^28 stay in int32.
//   fe_carry64 inputs <= 2^62.06: carry c9 <= 2^37.1, 19 c9 < 2^41.4, so
//          every intermediate stays far inside int64; output is tight.
//   fe_freeze needs a tight input (ref10 fe_tobytes precondition: even
//          limbs <= 1.1 2^25, odd limbs <= 1.1 2^24), so it carries first.
//
// The file compiles as host C++ too (without nvcc every function is plain
// `static inline`), so its arithmetic can be tested on a machine without a
// card.

#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define SCT_FN __device__ __forceinline__
#define SCT_FN_OUTLINE __device__ __noinline__
#define SCT_LDG(p) __ldg(p)
#else
#define SCT_FN static inline
#define SCT_FN_OUTLINE static
#define SCT_LDG(p) (*(p))
#endif

struct fe {
    int32_t v[10];
};

SCT_FN int fe_off(int k) { return (51 * k + 1) >> 1; }   // ceil(25.5 k)

SCT_FN void fe_0(fe &h)
{
#pragma unroll
    for (int i = 0; i < 10; i++)
        h.v[i] = 0;
}

SCT_FN void fe_1(fe &h)
{
    fe_0(h);
    h.v[0] = 1;
}

SCT_FN void fe_add(fe &h, const fe &f, const fe &g)
{
#pragma unroll
    for (int i = 0; i < 10; i++)
        h.v[i] = f.v[i] + g.v[i];
}

SCT_FN void fe_sub(fe &h, const fe &f, const fe &g)
{
#pragma unroll
    for (int i = 0; i < 10; i++)
        h.v[i] = f.v[i] - g.v[i];
}

SCT_FN void fe_neg(fe &h, const fe &f)
{
#pragma unroll
    for (int i = 0; i < 10; i++)
        h.v[i] = -f.v[i];
}

// h = cond ? g : h
SCT_FN void fe_cmov(fe &h, const fe &g, bool cond)
{
#pragma unroll
    for (int i = 0; i < 10; i++)
        h.v[i] = cond ? g.v[i] : h.v[i];
}

// ref10 carry chain over 64-bit columns; output tight (see audit).
SCT_FN void fe_carry64(fe &h, int64_t t[10])
{
    int64_t c;
    c = (t[0] + (1LL << 25)) >> 26; t[1] += c; t[0] -= c * (1LL << 26);
    c = (t[4] + (1LL << 25)) >> 26; t[5] += c; t[4] -= c * (1LL << 26);
    c = (t[1] + (1LL << 24)) >> 25; t[2] += c; t[1] -= c * (1LL << 25);
    c = (t[5] + (1LL << 24)) >> 25; t[6] += c; t[5] -= c * (1LL << 25);
    c = (t[2] + (1LL << 25)) >> 26; t[3] += c; t[2] -= c * (1LL << 26);
    c = (t[6] + (1LL << 25)) >> 26; t[7] += c; t[6] -= c * (1LL << 26);
    c = (t[3] + (1LL << 24)) >> 25; t[4] += c; t[3] -= c * (1LL << 25);
    c = (t[7] + (1LL << 24)) >> 25; t[8] += c; t[7] -= c * (1LL << 25);
    c = (t[4] + (1LL << 25)) >> 26; t[5] += c; t[4] -= c * (1LL << 26);
    c = (t[8] + (1LL << 25)) >> 26; t[9] += c; t[8] -= c * (1LL << 26);
    c = (t[9] + (1LL << 24)) >> 25; t[0] += c * 19; t[9] -= c * (1LL << 25);
    c = (t[0] + (1LL << 25)) >> 26; t[1] += c; t[0] -= c * (1LL << 26);
#pragma unroll
    for (int i = 0; i < 10; i++)
        h.v[i] = (int32_t)t[i];
}

SCT_FN void fe_carry(fe &h, const fe &f)
{
    int64_t t[10];
#pragma unroll
    for (int i = 0; i < 10; i++)
        t[i] = f.v[i];
    fe_carry64(h, t);
}

SCT_FN void fe_mul(fe &h, const fe &f, const fe &g)
{
    int64_t lo[10], hi[10];
#pragma unroll
    for (int k = 0; k < 10; k++)
        lo[k] = hi[k] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int32_t fi = f.v[i];
        const int32_t fi2 = 2 * f.v[i];
#pragma unroll
        for (int j = 0; j < 10; j++) {
            const int64_t p = (int64_t)((i & j & 1) ? fi2 : fi) * g.v[j];
            if (i + j < 10)
                lo[i + j] += p;
            else
                hi[i + j - 10] += p;
        }
    }
#pragma unroll
    for (int k = 0; k < 10; k++)
        lo[k] += 19 * hi[k];
    fe_carry64(h, lo);
}

SCT_FN void fe_sq(fe &h, const fe &f)
{
    int64_t lo[10], hi[10];
#pragma unroll
    for (int k = 0; k < 10; k++)
        lo[k] = hi[k] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int32_t fi = f.v[i];
        const int32_t fi2 = 2 * f.v[i];
#pragma unroll
        for (int j = i; j < 10; j++) {
            // diagonal: f_i^2 (doubled weight when i is odd);
            // off-diagonal: 2 f_i f_j (doubled again when both are odd)
            const int32_t fj = f.v[j];
            const int64_t p = (i == j)
                ? (int64_t)fi * ((i & 1) ? fi2 : fi)
                : (int64_t)fi2 * ((i & j & 1) ? 2 * fj : fj);
            if (i + j < 10)
                lo[i + j] += p;
            else
                hi[i + j - 10] += p;
        }
    }
#pragma unroll
    for (int k = 0; k < 10; k++)
        lo[k] += 19 * hi[k];
    fe_carry64(h, lo);
}

// x^(2^n), n >= 1
SCT_FN void fe_sqn(fe &h, const fe &f, int n)
{
    fe_sq(h, f);
#pragma unroll 1
    for (int i = 1; i < n; i++)
        fe_sq(h, h);
}

// x^((p-5)/8) = x^(2^252 - 3): the addition chain of ops/field.py's
// fe_pow_p58 (ref10 pow22523), 251 squarings and 11 multiplies.
SCT_FN void fe_pow_p58(fe &out, const fe &x)
{
    fe z2, z9, z11, t, z_5_0, z_10_0, z_20_0, z_50_0, z_100_0;
    fe_sq(z2, x);                       // 2
    fe_sqn(t, z2, 2);                   // 8
    fe_mul(z9, x, t);                   // 9
    fe_mul(z11, z2, z9);                // 11
    fe_sq(t, z11);                      // 22
    fe_mul(z_5_0, z9, t);               // 2^5 - 1
    fe_sqn(t, z_5_0, 5);
    fe_mul(z_10_0, t, z_5_0);           // 2^10 - 1
    fe_sqn(t, z_10_0, 10);
    fe_mul(z_20_0, t, z_10_0);          // 2^20 - 1
    fe_sqn(t, z_20_0, 20);
    fe_mul(t, t, z_20_0);               // 2^40 - 1
    fe_sqn(t, t, 10);
    fe_mul(z_50_0, t, z_10_0);          // 2^50 - 1
    fe_sqn(t, z_50_0, 50);
    fe_mul(z_100_0, t, z_50_0);         // 2^100 - 1
    fe_sqn(t, z_100_0, 100);
    fe_mul(t, t, z_100_0);              // 2^200 - 1
    fe_sqn(t, t, 50);
    fe_mul(t, t, z_50_0);               // 2^250 - 1
    fe_sqn(t, t, 2);
    fe_mul(out, t, x);                  // 2^252 - 3
}

// Canonical representative in [0, p) with exact limbs (ref10 fe_tobytes
// reduction: q = floor(h / p) from a rounded top estimate, h - q p, then
// an exact carry that drops bit 255).
SCT_FN void fe_freeze(fe &h, const fe &f)
{
    fe_carry(h, f);
    int32_t *v = h.v;
    int32_t q = (19 * v[9] + (1 << 24)) >> 25;
#pragma unroll
    for (int i = 0; i < 10; i++)
        q = (v[i] + q) >> ((i & 1) ? 25 : 26);
    v[0] += 19 * q;
#pragma unroll
    for (int i = 0; i < 9; i++) {
        const int s = (i & 1) ? 25 : 26;
        const int32_t c = v[i] >> s;
        v[i + 1] += c;
        v[i] -= c * (1 << s);
    }
    v[9] &= (1 << 25) - 1;
}

SCT_FN bool fe_eq(const fe &a, const fe &b)
{
    fe fa, fb;
    fe_freeze(fa, a);
    fe_freeze(fb, b);
    int32_t d = 0;
#pragma unroll
    for (int i = 0; i < 10; i++)
        d |= fa.v[i] ^ fb.v[i];
    return d == 0;
}

SCT_FN bool fe_is_zero(const fe &a)
{
    fe fa;
    fe_freeze(fa, a);
    int32_t d = 0;
#pragma unroll
    for (int i = 0; i < 10; i++)
        d |= fa.v[i];
    return d == 0;
}

SCT_FN int fe_parity(const fe &a)
{
    fe fa;
    fe_freeze(fa, a);
    return fa.v[0] & 1;
}

// 20 13-bit limbs (the reference's input contract, value < 2^255) ->
// 10 radix-2^25.5 limbs.
SCT_FN void fe_from_limbs13(fe &h, const int32_t *l)
{
#pragma unroll
    for (int k = 0; k < 10; k++) {
        const int off = fe_off(k);
        const int w = (k & 1) ? 25 : 26;
        const int i0 = off / 13, s = off % 13;
        uint32_t x = (uint32_t)SCT_LDG(l + i0) >> s;
        if (i0 + 1 < 20)
            x |= (uint32_t)SCT_LDG(l + i0 + 1) << (13 - s);
        if (i0 + 2 < 20)
            x |= (uint32_t)SCT_LDG(l + i0 + 2) << (26 - s);
        h.v[k] = (int32_t)(x & ((1u << w) - 1));
    }
}

SCT_FN void fe_load(fe &h, const int32_t *p)
{
#pragma unroll
    for (int i = 0; i < 10; i++)
        h.v[i] = SCT_LDG(p + i);
}
