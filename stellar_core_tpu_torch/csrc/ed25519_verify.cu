// Batched ed25519 verification on Hopper (sm_90a).
//
// Replaces the TPU program stellar_core_tpu/ops/ed25519.py::verify_kernel
// (jitted as verify_batch_jit): RFC 8032 cofactorless verify,
// [S]B + [k](-A) == R, computed projectively. One thread verifies one
// signature; one launch covers one bucket of the verifier's ladder.
//
// Input contract (unchanged from the reference, so both packages run on the
// same prep arrays; repacked here into radix 2^25.5, see fe25519.cuh):
//   ay, ry          (B, 20) int32, 13-bit limbs of the canonical y (< p)
//   a_sign, r_sign  (B,)    int32, the x sign bits
//   s_nibs, k_nibs  (B, 64) int32, signed radix-16 digits in [-8, 8),
//                   least significant first, of S and k = SHA512(R|A|M) mod L
//   params          int32 block: the fixed-base table [64][9][3][10]
//                   (Niels form y+x, y-x, 2dxy of v 16^j B, v = 0..8) then
//                   d, 2d and sqrt(-1), 10 limbs each; built on the host
//                   from the same Python-int constants as the plain version
//   out             (B,) bool
//
// What bounds it on this card: integer multiply issue. A verify is 1,819
// field multiplies (100 wide 32x32->64 products each) and 1,550 squarings
// (55 each), about 267K IMAD.WIDE per signature, against a few hundred
// bytes of input: operations, not bytes, set the floor. The design spends
// multiplies where the reference's TPU layout spent lanes: radix 2^25.5
// (10 limbs) instead of 13-bit limbs cuts products per multiply from 400
// to 100; squarings use the symmetric half-product; doublings skip T when
// the next step does not read it, and the ladder add skips T except on
// its last window (the reference's own savings, kept).
//
// Memory: the per-signature table of v(-A), v = 0..8 (9 points x 4 x 10
// limbs = 1,440 B) is indexed by a data-dependent digit, so it lives in
// local memory (L1-cached). The fixed table (69,120 B) exceeds the 64 KB
// constant bank and each thread reads a different entry, so it is read
// from global memory through the read-only path (__ldg).
//
// First design, not yet tuned: one thread per signature means a bucket of
// 8,192 fills 256 warps, about two per SM of 132, so most of each SM's
// four schedulers idle. Splitting a verify over several threads is the
// next step. `-Xptxas -v` (CUDA 12.9, sm_90a): the kernel uses 255
// registers with a 1,648-byte stack frame (the table above), 44 B of
// spill stores and 52 B of spill loads; the out-of-line fe_decompress
// spills 4 B. Each build writes these figures beside the library
// (build/libed25519_verify-*.log).
//
// The file compiles as host C++ too (the kernel and the launcher exist
// only under nvcc), which lets the per-signature routine be tested on a
// machine without a card.

#include "fe25519.cuh"

#define SCT_FIXED_WORDS (64 * 9 * 3 * 10)
#define SCT_PARAM_D (SCT_FIXED_WORDS)
#define SCT_PARAM_D2 (SCT_FIXED_WORDS + 10)
#define SCT_PARAM_SQRTM1 (SCT_FIXED_WORDS + 20)
#define SCT_PARAM_WORDS (SCT_FIXED_WORDS + 30)
#define SCT_THREADS 32

// Extended coordinates (X:Y:Z:T), x = X/Z, y = Y/Z, T = XY/Z.
struct ge {
    fe x, y, z, t;
};

// Bounds below use the audit's T (tight) and M = 4T (fe_mul input bound);
// canonical values (ay, ry, the tables, the constants) are <= 2T.

// dbl-2008-hwcd, a = -1. Never reads p.t; writes r.t only when need_t.
// a, b, c' tight; c = 2c' <= 2T; h <= 2T; e = h - (x+y)^2 <= 3T;
// g <= 2T; f = c + g <= 4T = M. r may alias p.
SCT_FN void pt_dbl(ge &r, const ge &p, bool need_t)
{
    fe a, b, c, e, f, g, h, u;
    fe_sq(a, p.x);
    fe_sq(b, p.y);
    fe_sq(c, p.z);
    fe_add(c, c, c);
    fe_add(u, p.x, p.y);                 // <= 3T (y may be canonical)
    fe_sq(u, u);
    fe_add(h, a, b);
    fe_sub(e, h, u);
    fe_sub(g, a, b);
    fe_add(f, c, g);
    fe_mul(r.x, e, f);
    fe_mul(r.y, g, h);
    fe_mul(r.z, f, g);
    if (need_t)
        fe_mul(r.t, e, h);
}

// add-2008-hwcd-3 with q's T pre-multiplied by 2d (q.t = 2d T2), so
// c = T1 (2d T2) is one multiply. Writes r.t only when need_t.
// y1 -+ x1 <= 2T, y2 -+ x2 <= 3T; d <= 2T; e, h <= 2T; f, g <= 3T.
// r may alias p.
SCT_FN void pt_add_folded(ge &r, const ge &p, const ge &q, bool need_t)
{
    fe a, b, c, d, e, f, g, h, u, w;
    fe_sub(u, p.y, p.x);
    fe_sub(w, q.y, q.x);
    fe_mul(a, u, w);
    fe_add(u, p.y, p.x);
    fe_add(w, q.y, q.x);
    fe_mul(b, u, w);
    fe_mul(c, p.t, q.t);
    fe_mul(d, p.z, q.z);
    fe_add(d, d, d);
    fe_sub(e, b, a);
    fe_sub(f, d, c);
    fe_add(g, d, c);
    fe_add(h, b, a);
    fe_mul(r.x, e, f);
    fe_mul(r.y, g, h);
    fe_mul(r.z, f, g);
    if (need_t)
        fe_mul(r.t, e, h);
}

// Mixed addition with a Niels point (y+x, y-x, 2dxy), Z2 = 1.
// Same bounds as pt_add_folded. r may alias p.
SCT_FN void pt_add_niels(ge &r, const ge &p, const fe &ypx, const fe &ymx,
                         const fe &xy2d)
{
    fe a, b, c, d, e, f, g, h, u;
    fe_sub(u, p.y, p.x);
    fe_mul(a, u, ymx);
    fe_add(u, p.y, p.x);
    fe_mul(b, u, ypx);
    fe_mul(c, p.t, xy2d);
    fe_add(d, p.z, p.z);
    fe_sub(e, b, a);
    fe_sub(f, d, c);
    fe_add(g, d, c);
    fe_add(h, b, a);
    fe_mul(r.x, e, f);
    fe_mul(r.y, g, h);
    fe_mul(r.z, f, g);
    fe_mul(r.t, e, h);
}

// RFC 8032 5.1.3 x-recovery, as ops/ed25519.py::fe_decompress: x =
// u v^3 (u v^7)^((p-5)/8) with u = y^2 - 1, v = d y^2 + 1; times sqrt(-1)
// when only -u matches; reject when neither matches or x = 0 with sign 1;
// then fix the parity. y is canonical (host-checked y < p). Called twice;
// kept out of line so the kernel carries one copy of its 274 multiplies.
SCT_FN_OUTLINE bool fe_decompress(fe &x, const fe &y, int sign,
                          const int32_t *params)
{
    fe one, y2, u, v, v3, v7, t, vx2;
    fe_1(one);
    fe_sq(y2, y);
    fe_sub(u, y2, one);
    fe_load(t, params + SCT_PARAM_D);
    fe_mul(v, y2, t);
    fe_add(v, v, one);
    fe_sq(t, v);
    fe_mul(v3, t, v);
    fe_sq(t, v3);
    fe_mul(v7, t, v);
    fe_mul(t, u, v7);
    fe_pow_p58(t, t);
    fe_mul(x, u, v3);
    fe_mul(x, x, t);
    fe_sq(t, x);
    fe_mul(vx2, v, t);
    const bool ok1 = fe_eq(vx2, u);
    fe_neg(t, u);
    const bool ok2 = fe_eq(vx2, t);
    fe_load(t, params + SCT_PARAM_SQRTM1);
    fe_mul(t, x, t);
    fe_cmov(x, t, ok2 && !ok1);
    const bool ok = (ok1 || ok2) && !(fe_is_zero(x) && sign == 1);
    fe_neg(t, x);
    fe_cmov(x, t, fe_parity(x) != sign);
    return ok;
}

SCT_FN bool verify_one(const int32_t *ay13, int a_sign, const int32_t *ry13,
                       int r_sign, const int32_t *s_dig,
                       const int32_t *k_dig, const int32_t *params)
{
    fe ay, ry, ax, rx, d2;
    fe_from_limbs13(ay, ay13);
    fe_from_limbs13(ry, ry13);
    const bool a_ok = fe_decompress(ax, ay, a_sign, params);
    const bool r_ok = fe_decompress(rx, ry, r_sign, params);
    fe_load(d2, params + SCT_PARAM_D2);

    // tab[v] = v (-A) for v = 0..8, built with the true T, which is then
    // pre-multiplied by 2d for pt_add_folded. -A = (-ax, ay, 1, -ax ay).
    ge tab[9];
    fe_0(tab[0].x);
    fe_1(tab[0].y);
    fe_1(tab[0].z);
    fe_0(tab[0].t);
    fe_neg(tab[1].x, ax);
    tab[1].y = ay;
    fe_1(tab[1].z);
    fe_mul(tab[1].t, tab[1].x, ay);
    ge a_folded = tab[1];
    fe_mul(a_folded.t, tab[1].t, d2);
#pragma unroll 1
    for (int v = 2; v < 9; v++) {
        if ((v & 1) == 0)
            pt_dbl(tab[v], tab[v >> 1], true);
        else
            pt_add_folded(tab[v], tab[v - 1], a_folded, true);
    }
#pragma unroll 1
    for (int v = 1; v < 9; v++)
        fe_mul(tab[v].t, tab[v].t, d2);

    // variable base: [k](-A), most significant digit first; 4 doublings
    // and one signed-digit add per window. Only the 4th doubling makes T
    // (the add reads it); only the last window's add makes T (the
    // fixed-base chain reads it).
    ge q;
    fe_0(q.x);
    fe_1(q.y);
    fe_1(q.z);
    fe_0(q.t);
#pragma unroll 1
    for (int i = 63; i >= 0; i--) {
#pragma unroll 1
        for (int r = 0; r < 4; r++)
            pt_dbl(q, q, r == 3);
        const int dig = k_dig[i];
        ge sel = tab[dig < 0 ? -dig : dig];
        if (dig < 0) {                   // -(x, y, z, t) = (-x, y, z, -t)
            fe_neg(sel.x, sel.x);
            fe_neg(sel.t, sel.t);
        }
        pt_add_folded(q, q, sel, i == 0);
    }

    // fixed base: [S]B = sum_j table[j][s_j], 64 Niels adds, no doublings
#pragma unroll 1
    for (int j = 0; j < 64; j++) {
        const int dig = s_dig[j];
        const bool neg = dig < 0;
        const int32_t *e = params + (j * 9 + (neg ? -dig : dig)) * 30;
        // Niels negation: swap y+x and y-x, negate 2dxy
        fe ypx, ymx, xy2d;
        fe_load(ypx, e + (neg ? 10 : 0));
        fe_load(ymx, e + (neg ? 0 : 10));
        fe_load(xy2d, e + 20);
        if (neg)
            fe_neg(xy2d, xy2d);
        pt_add_niels(q, q, ypx, ymx, xy2d);
    }

    // projective compare with the affine R: X == rx Z and Y == ry Z
    fe t;
    fe_mul(t, rx, q.z);
    bool eq = fe_eq(q.x, t);
    fe_mul(t, ry, q.z);
    eq = fe_eq(q.y, t) && eq;
    return a_ok && r_ok && eq;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void __launch_bounds__(SCT_THREADS)
ed25519_verify_kernel(const int32_t *__restrict__ ay,
                      const int32_t *__restrict__ a_sign,
                      const int32_t *__restrict__ ry,
                      const int32_t *__restrict__ r_sign,
                      const int32_t *__restrict__ s_nibs,
                      const int32_t *__restrict__ k_nibs,
                      const int32_t *__restrict__ params,
                      bool *__restrict__ out, int n)
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= n)
        return;
    out[b] = verify_one(ay + 20 * b, __ldg(a_sign + b), ry + 20 * b,
                        __ldg(r_sign + b), s_nibs + 64 * b, k_nibs + 64 * b,
                        params);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller owns every buffer; the kernel allocates nothing.
extern "C" int sct_ed25519_verify(const int32_t *ay, const int32_t *a_sign,
                                  const int32_t *ry, const int32_t *r_sign,
                                  const int32_t *s_nibs,
                                  const int32_t *k_nibs,
                                  const int32_t *params, bool *out, int n,
                                  void *stream)
{
    if (n > 0) {
        const int blocks = (n + SCT_THREADS - 1) / SCT_THREADS;
        ed25519_verify_kernel<<<blocks, SCT_THREADS, 0,
                                (cudaStream_t)stream>>>(
            ay, a_sign, ry, r_sign, s_nibs, k_nibs, params, out, n);
    }
    return (int)cudaGetLastError();
}

extern "C" int sct_ed25519_param_words(void) { return SCT_PARAM_WORDS; }

extern "C" const char *sct_cuda_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
#endif
