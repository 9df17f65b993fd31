// Batched ed25519 verification on Hopper (sm_90a).
//
// Replaces the TPU program stellar_core_tpu/ops/ed25519.py::verify_kernel
// (jitted as verify_batch_jit): RFC 8032 cofactorless verify,
// [S]B + [k](-A) == R, computed projectively. Four lanes of a warp (a
// quad) verify one signature; one launch covers one bucket of the
// verifier's ladder.
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
// What bounds it on this card. Per signature the work is a few hundred
// bytes of input against some 3,400 field operations (each 55-100 wide
// 32x32->64 products and a carry chain), so operations, not bytes, set the
// floor. But a verify is one dependent chain of those operations, and a
// bucket of 128 to 8,192 signatures cannot fill 132 SMs with one thread per
// signature (the first design, on an H100 80GB HBM3 at 700 W: 1.51 ms at
// 128 and 1.58 ms at 8,192, flat in the lane count, about 12x the
// operation bound at 8,192): the time is the chain's latency.
//
// The design shortens the chain by splitting each point operation over a
// quad. Lane q of the quad holds coordinate q of the running point in
// extended coordinates (X, Y, Z, T). Doubling (dbl-2008-hwcd, a = -1) and
// addition (add-2008-hwcd-3) each become two rounds of four independent
// field operations, the 4-processor schedule of Hisil, Wong, Carter and
// Dawson ("Twisted Edwards Curves Revisited", Asiacrypt 2008):
//   doubling  round 1: X^2, Y^2, 2Z^2, (X+Y)^2
//   addition  round 1: (Y1-X1)(Y2-X2), (Y1+X1)(Y2+X2), T1 2dT2, Z1 2Z2
//   both      round 2: E F, G H, F G, E H  ->  X3, Y3, Z3, T3 on lanes 0..3
// Between rounds the quad exchanges operands with width-4 shuffles, 10
// limbs at a time. The added points are kept in cached form (Y-X, Y+X,
// 2dT, 2Z), so round 1 of an add reads lane q's own coordinate of the
// table entry and needs one shuffle (lanes 0/1 and 2/3 swap X/Y and Z/T);
// a negative digit swaps the reads of lanes 0 and 1 and negates lane 2's.
// The fixed-base Niels entries (y+x, y-x, 2dxy, Z = 1) are the same form
// with 2Z = 2. The ladder's 64 windows of 4 doublings and one add are 640
// rounds instead of 2,304 serial field operations; the 64 fixed-base adds
// ride in the same windows on a second accumulator, whose instructions
// interleave with the ladder add's. The two decompressions are
// 255-squaring chains that do not split: lane 0 decompresses A and lane 1
// R, in parallel (lanes 2 and 3 repeat them, which keeps the warp's
// control uniform). The critical path is about 940 field operations
// instead of 3,361. The design issues more products than the first one
// (334,900 per verify against 266,350: every lane of a doubling computes
// T, and the decompressions run on four lanes), and the bound keeps the
// first design's count as its yardstick.
//
// Control is data-independent: table reads are indexed loads and signs
// are selects, so every lane of a warp runs the same instructions and the
// whole-warp shuffles are well defined. Lanes past the batch compute on
// the last signature and do not store.
//
// Memory: the per-signature table of v(-A), v = 0..8, in cached form (9 x 4
// x 10 limbs = 1,440 B), is written by the quad and read at a data-dependent
// index, so it lives in shared memory (46,080 B for the 32 signatures of a
// 128-thread block, under the 48 KB static limit). The block's tables are
// laid out by row (entry v, limb l), one word per thread, so a warp's 32
// reads of one limb fall on 32 banks whatever each quad's digit (a layout
// per signature, 360 words, would put quads s and s + 4 on one bank). The
// fixed table (69,120 B) is read through the read-only path (__ldg): each
// lane reads its own coordinate of the entry, and lanes 2 and 3 the same
// one.
//
// `-Xptxas -v` (CUDA 12.9, sm_90a): 254 registers, 0 bytes stack frame, no
// spills, 46,080 bytes shared memory. 254 registers allow two 128-thread
// blocks per SM, which is all that a bucket of 8,192 (256 blocks over 132
// SMs) asks for. Each build writes the report beside the library
// (build/libed25519_verify-*.log).
//
// The file compiles as host C++ too (the kernel and the launcher exist
// only under nvcc). There the quad's lanes are an array of four, each
// round runs for q = 0..3 in turn and the exchange goes through a copy of
// the array: a lockstep loop that runs the kernel's own rounds, so that
// the schedule can be tested on a machine without a card.

#include "fe25519.cuh"

#define SCT_FIXED_WORDS (64 * 9 * 3 * 10)
#define SCT_PARAM_D (SCT_FIXED_WORDS)
#define SCT_PARAM_D2 (SCT_FIXED_WORDS + 10)
#define SCT_PARAM_SQRTM1 (SCT_FIXED_WORDS + 20)
#define SCT_PARAM_WORDS (SCT_FIXED_WORDS + 30)
#define SCT_THREADS 128
#define SCT_SIGS_PER_BLOCK (SCT_THREADS / 4)
// The tables of v(-A) of a block's 32 signatures share one array of 90
// rows (entry v, limb l: row 10 v + l), each row one word per thread of
// the block: thread 4s + q's word of row r is at r * SCT_TAB_STRIDE + 4s + q.
#define SCT_TAB_ROWS (9 * 10)
#define SCT_TAB_STRIDE SCT_THREADS

// --- the quad -------------------------------------------------------------
//
// quad<T> holds one lane's value on the card and all four lanes' on the
// host; QL(x, q) is lane q's. SCT_QFOR(q) runs its body for the calling
// lane (card) or for q = 0..3 in turn (host). SCT_QX(dst, src, from) is
// the exchange: lane q's dst becomes lane `from`'s src, where `from` is an
// expression of q naming a lane of the same quad.

#ifdef __CUDACC__
#define SCT_QN 1
#define SCT_QI(q) ((void)(q), 0)
#define SCT_QFOR(q) \
    for (int q = (int)(threadIdx.x & 3), sct_once_ = 1; sct_once_; \
         sct_once_ = 0)
#define SCT_QSYNC() __syncwarp()

SCT_FN void sct_shfl(fe &dst, const fe &src, int from)
{
#pragma unroll
    for (int i = 0; i < 10; i++)
        dst.v[i] = __shfl_sync(0xffffffffu, src.v[i], from, 4);
}

SCT_FN void sct_shfl(int &dst, const int &src, int from)
{
    dst = __shfl_sync(0xffffffffu, src, from, 4);
}

#define SCT_QX(dst, src, from) \
    do { SCT_QFOR(q) { (void)q; \
         sct_shfl(QL(dst, q), QL(src, q), (from)); } } while (0)
#else
#define SCT_QN 4
#define SCT_QI(q) (q)
#define SCT_QFOR(q) for (int q = 0; q < 4; q++)
#define SCT_QSYNC() ((void)0)
#define SCT_QX(dst, src, from) \
    do { const auto sct_src_ = (src); \
         SCT_QFOR(q) QL(dst, q) = sct_src_.l[(from)]; } while (0)
#endif

#define QL(x, q) ((x).l[SCT_QI(q)])

template <class T> struct quad {
    T l[SCT_QN];
};
typedef quad<fe> qfe;
typedef quad<int> qint;

// h = c ? g : f
SCT_FN void fe_sel(fe &h, const fe &f, const fe &g, bool c)
{
#pragma unroll
    for (int i = 0; i < 10; i++)
        h.v[i] = c ? g.v[i] : f.v[i];
}

// Bounds below use the audit's T (tight) and M = 4T (fe_mul input bound);
// canonical values (ay, ry, the tables, the constants) are <= 2T. Every
// product and square is tight.

// Round 2 of a point operation. r holds round 1's products on lanes 0..3:
//   doubling  a, b, c, d = X^2, Y^2, 2Z^2, (X+Y)^2 (c <= 2T);
//             H = a + b, G = a - b, E = H - d, F = c + G
//             (E <= 3T, F <= 4T = M, G, H <= 2T);
//   addition  a, b, c, d = A, B, C, D (all tight);
//             E = b - a, F = d - c, G = d + c, H = b + a (all <= 2T).
// Every lane takes all four from their lanes (40 shuffles), forms E, F,
// G, H and multiplies its pair (F E, G H, F G, H E: the second factor
// within 3T) into coordinate q of the result.
SCT_FN void q_round2(qfe &p, const qfe &r, bool dbl)
{
    qfe a, b, c, d;
    SCT_QX(a, r, 0);
    SCT_QX(b, r, 1);
    SCT_QX(c, r, 2);
    SCT_QX(d, r, 3);
    SCT_QFOR(q) {
        fe e, f, g, h, s1, s2;
        if (dbl) {
            fe_add(h, QL(a, q), QL(b, q));
            fe_sub(g, QL(a, q), QL(b, q));
            fe_sub(e, h, QL(d, q));
            fe_add(f, QL(c, q), g);
        } else {
            fe_sub(e, QL(b, q), QL(a, q));
            fe_sub(f, QL(d, q), QL(c, q));
            fe_add(g, QL(d, q), QL(c, q));
            fe_add(h, QL(b, q), QL(a, q));
        }
        fe_sel(s1, f, g, q == 1);
        fe_sel(s1, s1, h, q == 3);
        fe_sel(s2, e, h, q == 1);
        fe_sel(s2, s2, g, q == 2);
        fe_mul(QL(p, q), s1, s2);
    }
}

// p = 2p (dbl-2008-hwcd). Lane 3 squares X + Y (<= 3T: Y may be
// canonical), so it takes X and Y from lanes 0 and 1; lane 2 doubles its
// square. p's T is not read.
SCT_FN void q_dbl(qfe &p)
{
    qfe x, y, r;
    SCT_QX(x, p, q == 3 ? 0 : q);
    SCT_QX(y, p, q == 3 ? 1 : q);
    SCT_QFOR(q) {
        fe in, sq, sq2;
        fe_add(in, QL(x, q), QL(y, q));
        fe_sel(in, QL(p, q), in, q == 3);
        fe_sq(sq, in);
        fe_add(sq2, sq, sq);
        fe_sel(QL(r, q), sq, sq2, q == 2);
    }
    q_round2(p, r, true);
}

// p = p + c (add-2008-hwcd-3) with c in cached form (Y-X, Y+X, 2dT, 2Z),
// lane q holding coordinate q. Round 1 needs lane q's own cached
// coordinate and one swap within pairs: Y1 -+ X1 on lanes 0/1 (<= 3T),
// T1 on lane 2, Z1 on lane 3; c's limbs are <= 3T.
SCT_FN void q_add(qfe &p, const qfe &c)
{
    qfe o, r;
    SCT_QX(o, p, q ^ 1);
    SCT_QFOR(q) {
        fe s, t;
        fe_sub(s, QL(o, q), QL(p, q));
        fe_add(t, QL(p, q), QL(o, q));
        fe_sel(s, s, t, q == 1);
        fe_sel(s, s, QL(o, q), q >= 2);
        fe_mul(QL(r, q), s, QL(c, q));
    }
    q_round2(p, r, false);
}

// c = cached form of p: (Y-X, Y+X, 2d T, 2Z) on lanes 0..3.
SCT_FN void q_cached(qfe &c, const qfe &p, const fe &d2)
{
    qfe o;
    SCT_QX(o, p, q ^ 1);
    SCT_QFOR(q) {
        fe s, t, m;
        fe_sub(s, QL(o, q), QL(p, q));
        fe_add(t, QL(p, q), QL(o, q));
        fe_sel(s, s, t, q == 1);
        fe_mul(m, QL(o, q), d2);
        fe_sel(s, s, m, q == 2);
        fe_add(t, QL(o, q), QL(o, q));
        fe_sel(QL(c, q), s, t, q == 3);
    }
}

// tab[v] = cached(p); lane q writes coordinate q (rows 10 v .. 10 v + 9).
SCT_FN void q_put(int32_t *tab, int v, const qfe &p, const fe &d2)
{
    qfe c;
    q_cached(c, p, d2);
    SCT_QFOR(q) {
#pragma unroll
        for (int i = 0; i < 10; i++)
            tab[(v * 10 + i) * SCT_TAB_STRIDE + q] = QL(c, q).v[i];
    }
}

// RFC 8032 5.1.3 x-recovery, as ops/ed25519.py::fe_decompress: x =
// u v^3 (u v^7)^((p-5)/8) with u = y^2 - 1, v = d y^2 + 1; times sqrt(-1)
// when only -u matches; reject when neither matches or x = 0 with sign 1;
// then fix the parity. y is canonical (host-checked y < p).
SCT_FN bool fe_decompress(fe &x, const fe &y, int sign,
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

// One signature on one quad. tab is the quad's 1,440-byte table (shared
// memory on the card). Returns the decision on lane 0 (the host: the
// decision); the other lanes' return value is meaningless.
SCT_FN bool verify_quad(const int32_t *ay13, int a_sign,
                        const int32_t *ry13, int r_sign,
                        const int32_t *s_dig, const int32_t *k_dig,
                        const int32_t *params, int32_t *tab)
{
    fe ay, ry, d2;
    fe_from_limbs13(ay, ay13);
    fe_from_limbs13(ry, ry13);
    fe_load(d2, params + SCT_PARAM_D2);

    // decompress A on lanes 0 and 2, R on lanes 1 and 3
    qfe x;
    qint ok;
    SCT_QFOR(q) {
        fe y;
        fe_sel(y, ay, ry, q & 1);
        QL(ok, q) = fe_decompress(QL(x, q), y, (q & 1) ? r_sign : a_sign,
                                  params);
    }

    // -A = (-ax, ay, 1, -ax ay), coordinate q on lane q
    qfe ax, p;
    SCT_QX(ax, x, 0);
    SCT_QFOR(q) {
        fe nax, t, one;
        fe_neg(nax, QL(ax, q));
        fe_mul(t, nax, ay);
        fe_1(one);
        fe_sel(nax, nax, ay, q == 1);
        fe_sel(nax, nax, one, q == 2);
        fe_sel(QL(p, q), nax, t, q == 3);
    }

    // tab[v] = cached(v (-A)), v = 0..8; the identity is (1, 1, 0, 2)
    SCT_QFOR(q) {
#pragma unroll
        for (int i = 0; i < 10; i++)
            tab[i * SCT_TAB_STRIDE + q] =
                i ? 0 : (q == 2 ? 0 : (q == 3 ? 2 : 1));
    }
    // built in an order that keeps two points live; the adds read the
    // cached -A back from the table (lane q its own coordinate)
    qfe c1, p2, t, u;
    q_put(tab, 1, p, d2);
    SCT_QFOR(q) {
#pragma unroll
        for (int i = 0; i < 10; i++)
            QL(c1, q).v[i] = tab[(10 + i) * SCT_TAB_STRIDE + q];
    }
    p2 = p;
    q_dbl(p2);
    q_put(tab, 2, p2, d2);
    t = p2;
    q_add(t, c1);
    q_put(tab, 3, t, d2);
    q_dbl(t);
    q_put(tab, 6, t, d2);
    q_add(t, c1);
    q_put(tab, 7, t, d2);
    t = p2;
    q_dbl(t);
    q_put(tab, 4, t, d2);
    u = t;
    q_add(u, c1);
    q_put(tab, 5, u, d2);
    q_dbl(t);
    q_put(tab, 8, t, d2);
    SCT_QSYNC();

    // variable base: acc = [k](-A), most significant digit first, 4
    // doublings and one signed-digit add per window; -(Y-X, Y+X, 2dT, 2Z) =
    // (Y+X, Y-X, -2dT, 2Z). Fixed base: sb = [S]B = sum_j table[j][s_j],
    // the Niels entries as cached points (y-x, y+x, 2dxy, 2), a negative
    // digit swapping y-+x and negating 2dxy. Window i also adds table[i]
    // into sb: the two adds are independent, so their instructions
    // interleave. Then acc + sb.
    qfe acc, sb, c, cf;
    SCT_QFOR(q) {
        fe_0(QL(acc, q));
        QL(acc, q).v[0] = (q == 1 || q == 2) ? 1 : 0;
        QL(sb, q) = QL(acc, q);
    }
#pragma unroll 1
    for (int i = 63; i >= 0; i--) {
#pragma unroll 1
        for (int r = 0; r < 4; r++)
            q_dbl(acc);
        const int dig = SCT_LDG(k_dig + i);
        const bool neg = dig < 0;
        const int idx = neg ? -dig : dig;
        const int sdig = SCT_LDG(s_dig + i);
        const int sneg = sdig < 0;
        const int32_t *e = params + (i * 9 + (sneg ? -sdig : sdig)) * 30;
        SCT_QFOR(q) {
            const int from = (neg && q < 2) ? (q ^ 1) : q;
            fe v, nv, two;
#pragma unroll
            for (int l = 0; l < 10; l++)
                v.v[l] = tab[(idx * 10 + l) * SCT_TAB_STRIDE + from];
            fe_neg(nv, v);
            fe_sel(QL(c, q), v, nv, neg && q == 2);
            const int comp = q >= 2 ? 2 : (q ^ 1 ^ sneg);
            fe_load(v, e + 10 * comp);
            fe_neg(nv, v);
            fe_sel(v, v, nv, sneg && q == 2);
            fe_0(two);
            two.v[0] = 2;
            fe_sel(QL(cf, q), v, two, q == 3);
        }
        q_add(acc, c);
        q_add(sb, cf);
    }
    fe_load(d2, params + SCT_PARAM_D2);
    q_cached(c, sb, d2);
    q_add(acc, c);

    // projective compare with the affine R: X == rx Z on lane 0 (with
    // a_ok), Y == ry Z on lane 1 (with r_ok)
    qfe z, rx;
    qint good, other;
    SCT_QX(z, acc, 2);
    SCT_QX(rx, x, 1);
    SCT_QFOR(q) {
        fe f, t2;
        fe_sel(f, ry, QL(rx, q), q == 0);
        fe_mul(t2, f, QL(z, q));
        QL(good, q) = fe_eq(QL(acc, q), t2) && QL(ok, q);
    }
    SCT_QX(other, good, 1);
    bool res = false;
    SCT_QFOR(q) {
        if (q == 0)
            res = QL(good, q) && QL(other, q);
    }
    return res;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// Thread 4s + q of a block is lane q of the quad that verifies the
// block's signature s. Every lane runs to the end (the quads exchange with
// whole-warp shuffles); a lane past the batch verifies signature n - 1 and
// does not store.
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
    __shared__ int32_t tabs[SCT_TAB_ROWS * SCT_TAB_STRIDE];
    const int s = threadIdx.x >> 2;
    const int b = blockIdx.x * SCT_SIGS_PER_BLOCK + s;
    const int bi = b < n ? b : n - 1;
    const bool ok = verify_quad(ay + 20 * bi, __ldg(a_sign + bi),
                                ry + 20 * bi, __ldg(r_sign + bi),
                                s_nibs + 64 * bi, k_nibs + 64 * bi, params,
                                tabs + 4 * s);
    if ((threadIdx.x & 3) == 0 && b < n)
        out[b] = ok;
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
        const int blocks = (n + SCT_SIGS_PER_BLOCK - 1) / SCT_SIGS_PER_BLOCK;
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
#else
// The host's lockstep loop: one signature, its quad's four lanes run in
// turn within each round, the table in a local array with the card's
// row stride (signature 0's column).
static bool verify_one(const int32_t *ay13, int a_sign, const int32_t *ry13,
                       int r_sign, const int32_t *s_dig,
                       const int32_t *k_dig, const int32_t *params)
{
    int32_t tab[SCT_TAB_ROWS * SCT_TAB_STRIDE];
    return verify_quad(ay13, a_sign, ry13, r_sign, s_dig, k_dig, params,
                       tab);
}
#endif
