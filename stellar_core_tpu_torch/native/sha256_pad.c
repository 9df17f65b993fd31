/* FIPS 180-4 padding of one hash chunk, written straight into the
 * hasher's staging buffer.
 *
 * The batched SHA-256 kernel (csrc/sha256.cu) takes a chunk as
 * (lanes, blocks, 16) 32-bit words holding each message's padded bytes as
 * big-endian word values, and (lanes,) block counts. sct_sha256_pad fills
 * both for messages 0..n-1, each the bytes blob[off[i] .. off[i]+len[i]):
 * every lane's real blocks (the message, the 0x80 marker, zeros and the
 * 64-bit bit length), and the count of every lane of the shape, 0 on the
 * padding lanes n..lanes-1. Words past a lane's count are not written:
 * the kernel and its plain version read only blocks i < count.
 *
 * It is the C form of ops/sha256.pad_messages_np, which stays the plain
 * version the tests hold it against. It touches no Python object, so the
 * ctypes call runs without the interpreter lock.
 *
 * Returns 0, or SCT_PAD_BAD_SHAPE (n outside 0..lanes, or lanes or blocks
 * below 1), SCT_PAD_OUT_OF_BLOB (a message reaching past blob_len) or
 * SCT_PAD_TOO_LONG (a message needing more than `blocks` blocks). All
 * inputs are checked before anything is written.
 */

#include <stdint.h>
#include <string.h>

#define SCT_PAD_BAD_SHAPE 1
#define SCT_PAD_OUT_OF_BLOB 2
#define SCT_PAD_TOO_LONG 3

static inline uint32_t load_be32(const uint8_t *p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

int sct_sha256_pad(const uint8_t *blob, uint64_t blob_len,
                   const uint64_t *off, const uint64_t *len, int64_t n,
                   int64_t lanes, int64_t blocks, uint32_t *words,
                   int32_t *counts) {
    if (lanes < 1 || blocks < 1 || n < 0 || n > lanes)
        return SCT_PAD_BAD_SHAPE;
    for (int64_t i = 0; i < n; i++) {
        if (off[i] > blob_len || len[i] > blob_len - off[i])
            return SCT_PAD_OUT_OF_BLOB;
        if ((len[i] + 9 + 63) / 64 > (uint64_t)blocks)
            return SCT_PAD_TOO_LONG;
    }
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *m = blob + off[i];
        const uint64_t L = len[i];
        const uint64_t total = (L + 9 + 63) / 64 * 16;   /* words written */
        uint32_t *w = words + (uint64_t)i * (uint64_t)blocks * 16;
        const uint64_t full = L / 4;
        for (uint64_t q = 0; q < full; q++)
            w[q] = load_be32(m + 4 * q);
        /* the last 0-3 message bytes, then the 0x80 marker: word `full`,
         * at most total - 3 (the marker is at byte L <= 64 * blocks - 9) */
        uint32_t last = 0;
        const unsigned r = (unsigned)(L % 4);
        for (unsigned j = 0; j < r; j++)
            last |= (uint32_t)m[4 * full + j] << (24 - 8 * j);
        last |= 0x80u << (24 - 8 * r);
        w[full] = last;
        if (total - 2 > full + 1)
            memset(w + full + 1, 0, (total - 2 - full - 1) * 4);
        const uint64_t bits = L * 8;
        w[total - 2] = (uint32_t)(bits >> 32);
        w[total - 1] = (uint32_t)bits;
        counts[i] = (int32_t)(total / 16);
    }
    for (int64_t i = n; i < lanes; i++)
        counts[i] = 0;
    return 0;
}
