// Batched SHA-256 on Hopper (sm_90a).
//
// Replaces the TPU program stellar_core_tpu/ops/sha256.py::hash_blocks_kernel
// (:112, with _compress :74; jitted as hash_blocks_jit :135): FIPS 180-4
// SHA-256 of one message per lane, each lane absorbing only its own blocks.
// One thread hashes one message; one launch covers one chunk of the
// hasher's (lanes x blocks) ladder.
//
// Input contract (the reference's, so both packages run on the same host
// padding):
//   words     (B, max_blocks, 16) uint32 big-endian message words, FIPS-
//             padded per lane, batch first (the host layout; no transpose)
//   n_blocks  (B,) int32 true block counts; lane b absorbs blocks
//             0 .. min(n_blocks[b], max_blocks) - 1, so a padding lane
//             (count 0) comes out as the initial state H0, exactly as the
//             reference's mask `i < n_blocks` leaves it
//   out       (B, 8) uint32 digest words
//
// What bounds it on this card: 32-bit integer issue. A block is a long
// dependent chain of about 1,384 integer instructions (64 rounds of 14:
// 6 rotates, 4 three-input logic ops, 4 three-input adds; 48 schedule
// steps of 10; 8 final adds) against 64 bytes read, about 22 instructions
// per byte, while the card issues 64 INT32 operations per clock per SM
// against about 13 bytes per clock per SM from HBM: operations, not bytes,
// set the floor. The design keeps every instruction on registers: the 8
// state words, the 8 working words and a rolling 16-word message schedule
// (the reference materialises all 64 schedule words in memory) live in
// registers, the 64 round constants live in __constant__ memory (every
// thread of a warp reads the same K[t] in the same round, a broadcast, and
// with the rounds unrolled each read is an immediate constant-bank
// operand), and rotations are single funnel shifts.
//
// Ragged lanes: each thread loops to its own block count and stops, where
// the reference runs every lane to max_blocks under a mask. The digests
// are the same; the hasher sorts messages by block count before it chunks
// them, so the threads of a warp mostly stop together.
//
// First design, not yet tuned: a chunk of 4,096 messages is 128 warps,
// about one per SM, so each SM's four schedulers run one dependent chain
// between them and the kernel is bound by the chain's latency, not by the
// issue rate above. Each thread also reads its own 64-byte row (strided by
// max_blocks x 64 bytes across the warp), so loads are not coalesced. Many
// messages per warp with coalesced 16-byte loads, or a block-first layout,
// is later work (ROADMAP Queue 2).
//
// The file compiles as host C++ too (the kernel and the launcher exist only
// under nvcc), which lets the per-message routine be tested on a machine
// without a card.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define SHA_FN __host__ __device__ __forceinline__
#else
#define SHA_FN static inline
#endif

#define SHA_THREADS 64

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

// The 16 words of one 64-byte block: four 16-byte loads on the card (a
// block row is 64-byte aligned: the tensor's storage is, and every row is
// a multiple of 64 bytes), plain reads on the host.
SHA_FN void load_block(const uint32_t *p, uint32_t w[16])
{
#ifdef __CUDA_ARCH__
    const uint4 *q = reinterpret_cast<const uint4 *>(p);
#pragma unroll
    for (int j = 0; j < 4; j++) {
        const uint4 v = __ldg(q + j);
        w[4 * j] = v.x;
        w[4 * j + 1] = v.y;
        w[4 * j + 2] = v.z;
        w[4 * j + 3] = v.w;
    }
#else
    for (int j = 0; j < 16; j++)
        w[j] = p[j];
#endif
}

// One compression of the block in w (consumed: it becomes the rolling
// schedule) into the state s.
SHA_FN void sha256_compress(uint32_t s[8], uint32_t w[16])
{
    uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
    uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
    for (int t = 0; t < 64; t++) {
        if (t >= 16) {
            // w[t & 15] holds w[t-16]; extend it in place to w[t]
            const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
            const uint32_t s0 =
                sha_rotr(w15, 7) ^ sha_rotr(w15, 18) ^ (w15 >> 3);
            const uint32_t s1 =
                sha_rotr(w2, 17) ^ sha_rotr(w2, 19) ^ (w2 >> 10);
            w[t & 15] += s0 + w[(t - 7) & 15] + s1;
        }
        const uint32_t S1 =
            sha_rotr(e, 6) ^ sha_rotr(e, 11) ^ sha_rotr(e, 25);
        const uint32_t ch = (e & f) ^ (~e & g);
        const uint32_t t1 = h + S1 + ch + sha_k(t) + w[t & 15];
        const uint32_t S0 =
            sha_rotr(a, 2) ^ sha_rotr(a, 13) ^ sha_rotr(a, 22);
        const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
        h = g;
        g = f;
        f = e;
        e = d + t1;
        d = c;
        c = b;
        b = a;
        a = t1 + S0 + maj;
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

// SHA-256 of one lane: `words` is the lane's (max_blocks, 16) row.
SHA_FN void sha256_lane(const uint32_t *words, int n_blocks, int max_blocks,
                        uint32_t out[8])
{
    uint32_t s[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                     0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
    const int n = n_blocks < max_blocks ? n_blocks : max_blocks;
#pragma unroll 1
    for (int i = 0; i < n; i++) {
        uint32_t w[16];
        load_block(words + 16 * i, w);
        sha256_compress(s, w);
    }
#pragma unroll
    for (int j = 0; j < 8; j++)
        out[j] = s[j];
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void __launch_bounds__(SHA_THREADS)
sha256_blocks_kernel(const uint32_t *__restrict__ words,
                     const int32_t *__restrict__ n_blocks,
                     uint32_t *__restrict__ out, int batch, int max_blocks)
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= batch)
        return;
    uint32_t s[8];
    sha256_lane(words + (size_t)b * max_blocks * 16, __ldg(n_blocks + b),
                max_blocks, s);
    uint4 *o = reinterpret_cast<uint4 *>(out + 8 * (size_t)b);
    o[0] = make_uint4(s[0], s[1], s[2], s[3]);
    o[1] = make_uint4(s[4], s[5], s[6], s[7]);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller owns every buffer; the kernel allocates nothing.
extern "C" int sct_sha256_blocks(const uint32_t *words,
                                 const int32_t *n_blocks, uint32_t *out,
                                 int batch, int max_blocks, void *stream)
{
    if (batch > 0) {
        const int blocks = (batch + SHA_THREADS - 1) / SHA_THREADS;
        sha256_blocks_kernel<<<blocks, SHA_THREADS, 0,
                               (cudaStream_t)stream>>>(
            words, n_blocks, out, batch, max_blocks);
    }
    return (int)cudaGetLastError();
}

extern "C" const char *sct_sha256_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
#endif
