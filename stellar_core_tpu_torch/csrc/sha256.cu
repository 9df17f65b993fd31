// Batched SHA-256 on Hopper (sm_90a).
//
// Replaces the TPU program stellar_core_tpu/ops/sha256.py::hash_blocks_kernel
// (:112, with _compress :74; jitted as hash_blocks_jit :135): FIPS 180-4
// SHA-256 of one message per lane, each lane absorbing only its own blocks.
// One launch covers one chunk of the hasher's (lanes x blocks) ladder.
//
// Input contract (the reference's, so both packages run on the same host
// padding):
//   words     (B, max_blocks, 16) uint32 big-endian message words, FIPS-
//             padded per lane, batch first (the host layout; no transpose)
//   n_blocks  (B,) int32 true block counts; lane b absorbs blocks
//             0 .. min(max(n_blocks[b], 0), max_blocks) - 1, so a padding
//             lane (count 0 or less) comes out as the initial state H0,
//             exactly as the reference's mask `i < n_blocks` leaves it
//   out       (B, 8) uint32 digest words
//
// What bounds it on this card. A message is a Merkle-Damgard chain: block
// i + 1 starts from block i's state, so a lane's blocks cannot be spread
// over threads, and a launch takes at least its longest lane's block
// count times the latency of one compression (the chain floor). At the
// hasher's launch sizes (at most 4,096 lanes, 128 warps of messages) the
// card holds at most one chain-carrying warp per SM, so the chain floor,
// not the card's issue rate, sets the time. Once the card is full (many
// warps per scheduler) 32-bit integer issue binds: a block is about 1,000
// instructions on the INT32 pipe (64 rounds of 6 funnel shifts and 4 LOP3,
// 48 schedule steps of 6 shifts and 2 LOP3), 64 lanes per clock per SM,
// against 64 bytes read, so operations and not bytes set the throughput
// bound.
//
// The design shortens the chain's step and keeps everything else off it,
// paying in issue: a block costs a warp pair about 1,660 instructions (the
// round warp's 1,007, the schedule warp's 654) against the first design's
// 1,402 on one warp, but the warp that carries the chain issues 1,007 of
// them, which ptxas schedules in 1,753 clocks against 3,186, and never
// waits on a load (sm_90a SASS, CUDA 12.9). At the hasher's launch sizes
// the card is never full, so the trade wins; on a full card the extra
// 18 % of issue would be lost.
//
// 1. Staging. The schedule warp copies each lane's real blocks into a
//    two-stage ring in shared memory with cp.async, 16 bytes per thread:
//    four neighbouring threads copy one lane's 64-byte block, eight lanes
//    per instruction, and a copy past the lane's clamped count is never
//    issued, so padding lanes and padding blocks cost no device reads (a
//    per-close chunk ships 85 % padding blocks). Block i + 2 is in flight
//    while block i is expanded, so the chain never waits on a global load
//    (the first design loaded each block just before compressing it). A
//    stage is laid out [quad][lane], so the schedule warp's 16-byte reads
//    are conflict-free. One 1-D bulk copy per lane on an mbarrier (the
//    TMA's form without a tensor map) was built first and dropped: the bulk
//    copy takes its addresses from uniform registers, so ptxas issues a
//    warp's 32 per-lane copies one after another (a loop over the lanes in
//    the SASS), and on an H100 that design took 0.00499 ms at 4096x1 and
//    0.00609 ms at 4096x2 against 0.00422 and 0.00530 ms for this one
//    (experiments/sha256_variants.py).
// 2. A warp pair per 32 messages. The schedule warp expands W[16..63] of
//    block i + 1, adds K[t], and writes the 64 words W[t] + K[t] into a
//    two-slot ring in shared memory, while the round warp runs block i's 64
//    rounds from the other slot. The ring is laid out [t / 4][lane][t % 4]:
//    each warp access is one 16-byte load or store per lane, 512
//    contiguous bytes, conflict-free. The two warps hand off through one
//    named barrier per block (bar.sync id, 64); both step to the pair's
//    largest clamped count, so a ragged pair never deadlocks, and a lane
//    past its own count computes on whatever its slot holds and does not
//    commit. The schedule's instructions, the copies and the K loads run
//    on a second scheduler of the SM; the round warp issues 64 rounds, 16
//    ring loads and the state update.
// 3. The round. h_t is e three rounds back and d_t is a three rounds back,
//    so h + WK[t] and d + h + WK[t] are computed off the chain, and the new
//    e is one three-input add after S1 and Ch. ptxas compiles a block's 64
//    rounds to 1,007 instructions (384 funnel shifts, 258 LOP3, 192 IADD3
//    and 136 IMAD.IADD; 16 ring loads): 13 a round on the ALU pipe, which
//    one warp issues every other clock. Two variants measured slower on an
//    H100 (experiments/sha256_variants.py): the adds forced onto the FMA
//    pipe as IMAD (1.06 against 0.95 us per block; ptxas then schedules
//    the loop in 1,941 clocks), and e' = d + T1, one add fewer and one
//    level deeper (0.96 us).
//
// Launch: CTAs of SHA_PAIRS warp pairs, each with 2 x 8 KB of schedule
// ring and 2 x 2 KB of stages (20,480 bytes of static shared memory per
// pair, whatever max_blocks is). At 4,096 lanes that is 128 CTAs of one
// pair, one per SM, so no two chains share a scheduler. A copy of this
// kernel with the pair index taken out (one pair per CTA written in)
// measured 3 % slower per block on an H100 (0.98-0.99 against 0.95 us,
// experiments/sha256_variants.py): ptxas allocated its registers
// differently. So the pair index stays. `-Xptxas -v` (CUDA 12.9,
// sm_90a): 68 registers, 0 bytes stack frame, no spills, 20,480 bytes
// shared memory.
//
// The file compiles as host C++ too (the kernel, the copies, the barriers
// and the launcher exist only under nvcc). The schedule and round
// functions are the same on both: `sha256_lane` runs them in turn per
// lane, and `sha256_pair` runs a whole pair's lanes through the card's
// stages and ring slots, in the order in which the card's schedule warp is
// furthest ahead, so that tier-1 tests can check both without a card.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define SHA_FN __host__ __device__ __forceinline__
#else
#include <string.h>
#define SHA_FN static inline
typedef struct {
    uint32_t x, y, z, w;
} uint4;
static inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z,
                               uint32_t w)
{
    uint4 v = {x, y, z, w};
    return v;
}
#endif

#define SHA_WARP 32               // messages per warp pair
#define SHA_PAIRS 1               // warp pairs per CTA (see Launch above)
#define SHA_THREADS (64 * SHA_PAIRS)
#define SHA_SLOT (16 * SHA_WARP)  // uint4 per ring slot: 64 words x 32 lanes
#define SHA_STAGE (4 * SHA_WARP)  // uint4 per stage: one block x 32 lanes

#define SHA_K_INIT                                                         \
    {0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,      \
     0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,      \
     0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,      \
     0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,      \
     0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,      \
     0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,      \
     0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,      \
     0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,      \
     0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,      \
     0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,      \
     0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,      \
     0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,      \
     0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u}

#define SHA_H0_INIT                                                        \
    {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,                   \
     0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u}

#ifdef __CUDACC__
__constant__ uint32_t SHA_K_DEV[64] = SHA_K_INIT;
#endif
static const uint32_t SHA_K_HOST[64] = SHA_K_INIT;

SHA_FN uint32_t sha_k(int t)
{
#ifdef __CUDA_ARCH__
    return SHA_K_DEV[t];
#else
    return SHA_K_HOST[t];
#endif
}

SHA_FN uint32_t sha_rotr(uint32_t x, int n)
{
#ifdef __CUDA_ARCH__
    return __funnelshift_r(x, x, n);
#else
    return (x >> n) | (x << (32 - n));
#endif
}

SHA_FN int sha_clamp(int n, int lo, int hi)
{
    return n < lo ? lo : n > hi ? hi : n;
}

// First uint4 of block i's stage (the staged words) and of its ring slot
// (its W + K), in a pair's two-entry rings; lane l's quad q is at
// + q * SHA_WARP + l in both.
SHA_FN int sha_stage(int i) { return (i & 1) * SHA_STAGE; }
SHA_FN int sha_slot(int i) { return (i & 1) * SHA_SLOT; }

// The schedule of one block: W[0..15] from the staged block (quad j at
// blk[j * bstep]), W[16..63] by a rolling 16-word window, and the 64
// words W[t] + K[t] written as 16 quads, quad q at wk[q * step].
SHA_FN void sha256_schedule(const uint4 *blk, int bstep, uint4 *wk,
                            int step)
{
    uint32_t w[16];
#pragma unroll
    for (int j = 0; j < 4; j++) {
        const uint4 v = blk[j * bstep];
        w[4 * j] = v.x;
        w[4 * j + 1] = v.y;
        w[4 * j + 2] = v.z;
        w[4 * j + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < 16; q++) {
        uint32_t o[4];
#pragma unroll
        for (int r = 0; r < 4; r++) {
            const int t = 4 * q + r;
            if (t >= 16) {
                // w[t & 15] holds W[t-16]; extend it in place to W[t]
                const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
                const uint32_t s0 =
                    sha_rotr(w15, 7) ^ sha_rotr(w15, 18) ^ (w15 >> 3);
                const uint32_t s1 =
                    sha_rotr(w2, 17) ^ sha_rotr(w2, 19) ^ (w2 >> 10);
                w[t & 15] += s0 + w[(t - 7) & 15] + s1;
            }
            o[r] = w[t & 15] + sha_k(t);
        }
        wk[q * step] = make_uint4(o[0], o[1], o[2], o[3]);
    }
}

// One round with wk = W[t] + K[t]. h and d are words three rounds old, so
// hwk and dhwk are off the chain.
SHA_FN void sha_round(uint32_t &a, uint32_t &b, uint32_t &c, uint32_t &d,
                      uint32_t &e, uint32_t &f, uint32_t &g, uint32_t &h,
                      uint32_t wk)
{
    const uint32_t hwk = h + wk;
    const uint32_t dhwk = d + hwk;
    const uint32_t S1 = sha_rotr(e, 6) ^ sha_rotr(e, 11) ^ sha_rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t S0 = sha_rotr(a, 2) ^ sha_rotr(a, 13) ^ sha_rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = dhwk + S1 + ch;
    d = c;
    c = b;
    b = a;
    a = (hwk + S1 + ch) + (S0 + maj);
}

// The 64 rounds of one block from its schedule (quad q at wk[q * step]),
// added into the state s.
SHA_FN void sha256_rounds(uint32_t s[8], const uint4 *wk, int step)
{
    uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
    uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
    for (int q = 0; q < 16; q++) {
        const uint4 v = wk[q * step];
        sha_round(a, b, c, d, e, f, g, h, v.x);
        sha_round(a, b, c, d, e, f, g, h, v.y);
        sha_round(a, b, c, d, e, f, g, h, v.z);
        sha_round(a, b, c, d, e, f, g, h, v.w);
    }
    s[0] += a;
    s[1] += b;
    s[2] += c;
    s[3] += d;
    s[4] += e;
    s[5] += f;
    s[6] += g;
    s[7] += h;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// The pair's hand-off: its two warps, 64 threads, on barrier 1 + pair.
__device__ __forceinline__ void sha_pair_sync(int pair)
{
    asm volatile("bar.sync %0, %1;" ::"r"(1 + pair), "n"(64) : "memory");
}

// Block i of the pair's lanes into block i's stage, as one cp.async
// commit group. Thread l copies quad l & 3 of lanes l / 4 + 8 c,
// c = 0..3: four neighbouring threads, one 64-byte block; row[c] is the
// thread's first word of lane c's row and nc[c] that lane's clamped count.
__device__ __forceinline__ void sha_stage_copy(uint4 *stage,
                                               const uint32_t *words,
                                               const size_t row[4],
                                               const int nc[4], int lane,
                                               int i)
{
#pragma unroll
    for (int c = 0; c < 4; c++)
        if (i < nc[c])
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                             (uint32_t)__cvta_generic_to_shared(
                                 stage + sha_stage(i) + (lane & 3) * SHA_WARP +
                                 (lane >> 2) + 8 * c)),
                         "l"(words + row[c] + 16 * i)
                         : "memory");
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// Threads 64p .. 64p + 31 of a CTA are pair p's round warp, the next 32
// its schedule warp; lane l of both carries message 32 (SHA_PAIRS x
// blockIdx.x + p) + l.
__global__ void __launch_bounds__(SHA_THREADS)
sha256_blocks_kernel(const uint32_t *__restrict__ words,
                     const int32_t *__restrict__ n_blocks,
                     uint32_t *__restrict__ out, int batch, int max_blocks)
{
    __shared__ uint4 rings[SHA_PAIRS][2 * SHA_SLOT];
    __shared__ uint4 stages[SHA_PAIRS][2 * SHA_STAGE];
    const int pair = threadIdx.x >> 6, lane = threadIdx.x & 31;
    const int first = (blockIdx.x * SHA_PAIRS + pair) * SHA_WARP;
    const int b = first + lane;
    const int n =
        b < batch ? sha_clamp(__ldg(n_blocks + b), 0, max_blocks) : 0;
    const int nmax = __reduce_max_sync(0xffffffffu, n);
    uint4 *ring = rings[pair];

    if ((threadIdx.x & 32) == 0) {
        // the round warp
        uint32_t s[8] = SHA_H0_INIT;
        for (int i = 0; i < nmax; i++) {
            sha_pair_sync(pair);   // block i's schedule is in its slot
            uint32_t t[8];
#pragma unroll
            for (int j = 0; j < 8; j++)
                t[j] = s[j];
            sha256_rounds(t, ring + sha_slot(i) + lane, SHA_WARP);
            if (i < n) {
#pragma unroll
                for (int j = 0; j < 8; j++)
                    s[j] = t[j];
            }
        }
        if (b < batch) {
            uint4 *o = reinterpret_cast<uint4 *>(out + 8 * (size_t)b);
            o[0] = make_uint4(s[0], s[1], s[2], s[3]);
            o[1] = make_uint4(s[4], s[5], s[6], s[7]);
        }
        return;
    }

    // the schedule warp
    uint4 *stage = stages[pair];
    int nc[4];
    size_t row[4];
#pragma unroll
    for (int c = 0; c < 4; c++) {
        const int l = (lane >> 2) + 8 * c;
        nc[c] = __shfl_sync(0xffffffffu, n, l);
        row[c] = (size_t)(first + l) * max_blocks * 16 + 4 * (lane & 3);
    }
#pragma unroll 1
    for (int i = 0; i < 2; i++)
        sha_stage_copy(stage, words, row, nc, lane, i);
    for (int i = 0; i < nmax; i++) {
        // block i has landed (block i + 1 may still be in flight)
        asm volatile("cp.async.wait_group 1;" ::: "memory");
        __syncwarp();
        sha256_schedule(stage + sha_stage(i) + lane, SHA_WARP,
                        ring + sha_slot(i) + lane, SHA_WARP);
        __syncwarp();              // every lane has read block i's stage
        sha_stage_copy(stage, words, row, nc, lane, i + 2);
        sha_pair_sync(pair);       // hand block i's schedule over
    }
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller owns every buffer; the kernel allocates nothing.
extern "C" int sct_sha256_blocks(const uint32_t *words,
                                 const int32_t *n_blocks, uint32_t *out,
                                 int batch, int max_blocks, void *stream)
{
    if (batch > 0) {
        const int groups = (batch + SHA_WARP - 1) / SHA_WARP;
        sha256_blocks_kernel<<<(groups + SHA_PAIRS - 1) / SHA_PAIRS,
                               SHA_THREADS, 0, (cudaStream_t)stream>>>(
            words, n_blocks, out, batch, max_blocks);
    }
    return (int)cudaGetLastError();
}

extern "C" const char *sct_sha256_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
#else
// SHA-256 of one lane on the host: `words` is the lane's (max_blocks, 16)
// row; each block is expanded into a slot, then compressed from it.
static void sha256_lane(const uint32_t *words, int n_blocks, int max_blocks,
                        uint32_t out[8])
{
    uint32_t s[8] = SHA_H0_INIT;
    uint4 blk[4], wk[16];
    const int n = sha_clamp(n_blocks, 0, max_blocks);
    for (int i = 0; i < n; i++) {
        memcpy(blk, words + 16 * i, sizeof blk);
        sha256_schedule(blk, 1, wk, 1);
        sha256_rounds(s, wk, 1);
    }
    memcpy(out, s, sizeof s);
}

// Block i of every lane of the pair that has it, into block i's stage at
// the card's offsets; the stage's other entries become poison.
static void sha_stage_host(uint4 *stage, const uint32_t *words,
                           const int *n, int max_blocks, int first, int i)
{
    memset(stage + sha_stage(i), 0xa5, SHA_STAGE * sizeof(uint4));
    for (int l = 0; l < SHA_WARP; l++)
        for (int q = 0; q < 4 && i < n[l]; q++)
            memcpy(stage + sha_stage(i) + q * SHA_WARP + l,
                   words + ((size_t)(first + l) * max_blocks + i) * 16 + 4 * q,
                   sizeof(uint4));
}

// One warp pair of the card on the host: lanes first .. first + 31 of the
// batch, through the card's stages and ring slots, in the order in which
// the schedule warp is furthest ahead: block i + 2 is staged into block
// i's stage right after block i's schedule is read from it, and block
// i + 1's schedule is written before the rounds of block i read theirs.
// A wrong stage, slot or parity changes the digests.
static void sha256_pair(const uint32_t *words, const int32_t *n_blocks,
                        uint32_t *out, int batch, int max_blocks, int first)
{
    static const uint32_t h0[8] = SHA_H0_INIT;
    uint4 ring[2 * SHA_SLOT], stage[2 * SHA_STAGE];
    uint32_t s[SHA_WARP][8];
    int n[SHA_WARP], nmax = 0;
    for (int l = 0; l < SHA_WARP; l++) {
        const int b = first + l;
        n[l] = b < batch ? sha_clamp(n_blocks[b], 0, max_blocks) : 0;
        nmax = n[l] > nmax ? n[l] : nmax;
        memcpy(s[l], h0, sizeof h0);
    }
    memset(ring, 0xa5, sizeof ring);
    sha_stage_host(stage, words, n, max_blocks, first, 0);
    sha_stage_host(stage, words, n, max_blocks, first, 1);
    for (int i = 0; i <= nmax; i++) {
        if (i < nmax) {
            // the schedule warp's step i
            for (int l = 0; l < SHA_WARP; l++)
                sha256_schedule(stage + sha_stage(i) + l, SHA_WARP,
                                ring + sha_slot(i) + l, SHA_WARP);
            sha_stage_host(stage, words, n, max_blocks, first, i + 2);
        }
        if (i > 0) {
            // the round warp's step i - 1, which the card runs beside it
            for (int l = 0; l < SHA_WARP; l++) {
                uint32_t t[8];
                memcpy(t, s[l], sizeof t);
                sha256_rounds(t, ring + sha_slot(i - 1) + l, SHA_WARP);
                if (i - 1 < n[l])
                    memcpy(s[l], t, sizeof t);
            }
        }
    }
    for (int l = 0; l < SHA_WARP && first + l < batch; l++)
        memcpy(out + 8 * (size_t)(first + l), s[l], sizeof s[l]);
}
#endif
