/* Copied from `stellar_core_tpu/native/applyc.c` at commit c67d465; carry
 * a fix in either copy to the other. Changed: the module's name, which is
 * `_sctapply_torch` (its PyModuleDef and PyInit), so that this extension
 * and the reference's never share a name in one process; one comment
 * drops the reference's tracker reference. Deliberately different, in the
 * Python around it (`ledger/native_apply.py`): a close with no verifier
 * raises, and an exception raised by the verify callback propagates out of
 * `apply_close` (NULL with the error set) and fails the close as
 * SignatureVerifyError.
 */
/* Native transaction-apply fast path — full op coverage + conflict-graph
 * parallel close.
 *
 * This module implements the fee and apply phases of a ledger close for
 * every wire operation type (CREATE_ACCOUNT..PATH_PAYMENT_STRICT_SEND),
 * plain v1 AND fee-bump envelopes, muxed (med25519) account references,
 * protocol >= 10 — and returns {"bail": reason} for the residual inputs
 * the Python path (the semantics oracle, tests/test_native_apply.py)
 * still owns: non-ed25519 signer keys, >255 thresholds on the wire,
 * inflation payouts (protocol < 12 with the weekly timer due),
 * malformed-at-apply op shapes whose Python behavior is an exception.
 *
 * Contract: entry-for-entry identical output to the Python path — same
 * LedgerTxn delta (keys, pre-images, post-images, first-touch order),
 * same TransactionResult XDR, same fee/tx/op meta XDR — so header
 * hashes are bit-identical whichever path applied the close.
 *
 * Concurrency model (the conflict-graph parallel close):
 *   1. parse + prefetch: every statically-knowable LedgerKey a tx can
 *      touch is loaded through the Python lookup callback up front.
 *      Ops whose key set is state-dependent (offers, path payments,
 *      allow-trust revokes — they walk the order book) mark the close
 *      "dynamic": it still applies natively, but serially with the GIL.
 *   2. pre-verify: one batched verify() callback covers every
 *      (signer-key, signature, contents-hash) pair any tx could consume
 *      — live signer sets plus the statically-knowable additions
 *      (set-options signers, created-account master keys), so apply
 *      never needs Python again. Signer-set MEMBERSHIP is still
 *      evaluated against live state at apply time; the prepass only
 *      fixes the pure (key, sig, msg) verify results.
 *   3. fees: serial, in tx order (cheap; the per-tx fee deltas are the
 *      txfeehistory rows).
 *   4. apply: txs are union-found into clusters by touched entries;
 *      disjoint clusters apply concurrently on pthreads with the GIL
 *      released (malloc-only, no CPython calls). A fully-static close
 *      that doesn't parallelize still drops the GIL for the serial
 *      apply loop, so the catchup pipeline can verify ledger N+1
 *      underneath. Serial-equivalence: each entry's first level-0 touch
 *      is stamped (tx index, within-tx ordinal) and the merged
 *      close-level delta is sorted by stamp, reproducing the serial
 *      first-touch order exactly.
 *   5. emit: results / fee / meta XDR and the close-level delta are
 *      materialized into Python objects with the GIL, from the plain-C
 *      buffers the apply phase produced.
 *
 * Entry point: apply_close(params, envs, hashes, lookup, verify, book,
 * acct_offers, opts) -> dict | None. `book(selling, buying)` and
 * `acct_offers(account)` return root-state offer blobs for the order
 * book and per-seller offer scans; the overlay merges its own
 * created/modified/erased offers on top. `hashes[i]` is the tx
 * contents hash — 64 bytes (outer||inner) for fee bumps. opts:
 * {"workers": N, "mode": "auto"|"serial"|"parallel"}.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <pthread.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#define LET_ACCOUNT 0
#define LET_TRUSTLINE 1
#define LET_OFFER 2
#define LET_DATA 3

/* TransactionResultCode */
#define txFEE_BUMP_INNER_SUCCESS 1
#define txSUCCESS 0
#define txFAILED (-1)
#define txTOO_EARLY (-2)
#define txTOO_LATE (-3)
#define txMISSING_OPERATION (-4)
#define txBAD_SEQ (-5)
#define txBAD_AUTH (-6)
#define txNO_ACCOUNT (-8)
#define txINSUFFICIENT_FEE (-9)
#define txBAD_AUTH_EXTRA (-10)
#define txINTERNAL_ERROR (-11)
#define txNOT_SUPPORTED (-12)
#define txFEE_BUMP_INNER_FAILED (-13)

/* OperationResultCode */
#define opINNER 0
#define opBAD_AUTH (-1)
#define opNO_ACCOUNT (-2)
#define opNOT_SUPPORTED (-3)

/* OperationType (all 14) */
#define OP_CREATE_ACCOUNT 0
#define OP_PAYMENT 1
#define OP_PATH_PAYMENT_RECV 2
#define OP_MANAGE_SELL_OFFER 3
#define OP_CREATE_PASSIVE_OFFER 4
#define OP_SET_OPTIONS 5
#define OP_CHANGE_TRUST 6
#define OP_ALLOW_TRUST 7
#define OP_ACCOUNT_MERGE 8
#define OP_INFLATION 9
#define OP_MANAGE_DATA 10
#define OP_BUMP_SEQUENCE 11
#define OP_MANAGE_BUY_OFFER 12
#define OP_PATH_PAYMENT_SEND 13

/* SetOptionsResultCode */
#define SO_SUCCESS 0
#define SO_LOW_RESERVE (-1)
#define SO_TOO_MANY_SIGNERS (-2)
#define SO_INVALID_INFLATION (-4)
#define SO_CANT_CHANGE (-5)

/* CreateAccountResultCode */
#define CA_SUCCESS 0
#define CA_UNDERFUNDED (-2)
#define CA_LOW_RESERVE (-3)
#define CA_ALREADY_EXIST (-4)

/* PaymentResultCode */
#define PAY_SUCCESS 0
#define PAY_UNDERFUNDED (-2)
#define PAY_SRC_NO_TRUST (-3)
#define PAY_SRC_NOT_AUTHORIZED (-4)
#define PAY_NO_DESTINATION (-5)
#define PAY_NO_TRUST (-6)
#define PAY_NOT_AUTHORIZED (-7)
#define PAY_LINE_FULL (-8)
#define PAY_NO_ISSUER (-9)

/* PathPaymentResultCode (shared by both strictness arms) */
#define PP_SUCCESS 0
#define PP_UNDERFUNDED (-2)
#define PP_SRC_NO_TRUST (-3)
#define PP_SRC_NOT_AUTHORIZED (-4)
#define PP_NO_DESTINATION (-5)
#define PP_NO_TRUST (-6)
#define PP_NOT_AUTHORIZED (-7)
#define PP_LINE_FULL (-8)
#define PP_NO_ISSUER (-9)
#define PP_TOO_FEW_OFFERS (-10)
#define PP_OFFER_CROSS_SELF (-11)
#define PP_OVER_LIMIT (-12)  /* OVER_SENDMAX / UNDER_DESTMIN */

/* ManageOfferResultCode */
#define MO_SUCCESS 0
#define MO_SELL_NO_TRUST (-2)
#define MO_SELL_NOT_AUTHORIZED (-3)
#define MO_BUY_NO_TRUST (-4)
#define MO_BUY_NOT_AUTHORIZED (-5)
#define MO_LINE_FULL (-6)
#define MO_UNDERFUNDED (-7)
#define MO_CROSS_SELF (-8)
#define MO_SELL_NO_ISSUER (-9)
#define MO_BUY_NO_ISSUER (-10)
#define MO_NOT_FOUND (-11)
#define MO_LOW_RESERVE (-12)

/* ChangeTrustResultCode */
#define CT_SUCCESS 0
#define CT_NO_ISSUER (-2)
#define CT_INVALID_LIMIT (-3)
#define CT_LOW_RESERVE (-4)
#define CT_SELF_NOT_ALLOWED (-5)

/* AllowTrustResultCode */
#define AT_SUCCESS 0
#define AT_NO_TRUST_LINE (-2)
#define AT_TRUST_NOT_REQUIRED (-3)
#define AT_CANT_REVOKE (-4)
#define AT_SELF_NOT_ALLOWED (-5)

/* AccountMergeResultCode */
#define AM_SUCCESS 0
#define AM_NO_ACCOUNT (-2)
#define AM_IMMUTABLE_SET (-3)
#define AM_HAS_SUB_ENTRIES (-4)
#define AM_SEQNUM_TOO_FAR (-5)
#define AM_DEST_FULL (-6)

/* InflationResultCode */
#define INF_SUCCESS 0
#define INF_NOT_TIME (-1)
#define INFLATION_FREQUENCY 604800LL

/* ManageDataResultCode */
#define MD_SUCCESS 0
#define MD_NAME_NOT_FOUND (-2)
#define MD_LOW_RESERVE (-3)

/* BumpSequenceResultCode */
#define BS_SUCCESS 0

/* AccountFlags / TrustLineFlags / OfferEntryFlags */
#define AUTH_REQUIRED_FLAG 0x1
#define AUTH_REVOCABLE_FLAG 0x2
#define AUTH_IMMUTABLE_FLAG 0x4
#define TL_AUTHORIZED 1
#define TL_MAINTAIN 2
#define TL_AUTH_LEVELS_MASK 3
#define OFFER_PASSIVE_FLAG 1

#define MAX_SUBENTRIES 1000
#define INT64_MAXV 0x7fffffffffffffffLL
#define MAXLEVEL 4
#define NBUCKETS 4096
#define MAX_SIGNERS 20
#define MAX_SIGS 20
#define MAX_OPTYPES 16 /* wire op types are 0..13; table rounded up */
#define MAX_ASSET 52   /* alphanum12 asset XDR: 4+12+4+32 */
#define MAX_PATH 5
#define MAX_WORKERS 32

/* ------------------------------------------------- arena + buffer */

/* Bump allocator: the apply phase's per-op buffers (delta blobs, op
   payloads) live until emission, so per-buffer malloc/free churns the
   allocator from every worker thread at once — under sandboxed kernels
   (gVisor) that contention costs more than the apply work itself. Each
   apply context owns an arena; blocks free wholesale at close end. */
typedef struct ABlock {
    struct ABlock *next;
    size_t used, cap;
    /* data follows */
} ABlock;

typedef struct {
    ABlock *head;
} Arena;

#define ARENA_BLOCK (256 * 1024)

static void *arena_alloc(Arena *a, size_t n)
{
    n = (n + 15) & ~(size_t)15;
    ABlock *b = a->head;
    if (!b || b->used + n > b->cap) {
        size_t cap = n > ARENA_BLOCK ? n : ARENA_BLOCK;
        b = malloc(sizeof(ABlock) + cap);
        if (!b)
            return NULL;
        b->cap = cap;
        b->used = 0;
        b->next = a->head;
        a->head = b;
    }
    void *p = (char *)(b + 1) + b->used;
    b->used += n;
    return p;
}

static void arena_free_all(Arena *a)
{
    ABlock *b = a->head;
    while (b) {
        ABlock *n = b->next;
        free(b);
        b = n;
    }
    a->head = NULL;
}

typedef struct {
    char *data;
    Py_ssize_t len, cap;
    Arena *ar; /* NULL: plain malloc/realloc ownership */
} Buf;

static int buf_put(Buf *b, const void *src, Py_ssize_t n)
{
    if (b->len + n > b->cap) {
        Py_ssize_t cap = b->cap ? b->cap : 256;
        while (cap < b->len + n)
            cap *= 2;
        char *p;
        if (b->ar) {
            p = arena_alloc(b->ar, cap);
            if (p && b->len)
                memcpy(p, b->data, b->len);
        } else
            p = realloc(b->data, cap);
        if (!p)
            return -1;
        b->data = p;
        b->cap = cap;
    }
    if (n) /* UBSan: memcpy src must be non-null even for n==0 */
        memcpy(b->data + b->len, src, n);
    b->len += n;
    return 0;
}

static int buf_u32(Buf *b, uint32_t v)
{
    unsigned char w[4] = {(unsigned char)(v >> 24), (unsigned char)(v >> 16),
                          (unsigned char)(v >> 8), (unsigned char)v};
    return buf_put(b, w, 4);
}

static int buf_i32(Buf *b, int32_t v) { return buf_u32(b, (uint32_t)v); }

static int buf_u64(Buf *b, uint64_t v)
{
    unsigned char w[8];
    int i;
    for (i = 0; i < 8; i++)
        w[i] = (unsigned char)(v >> (56 - 8 * i));
    return buf_put(b, w, 8);
}

static int buf_i64(Buf *b, int64_t v) { return buf_u64(b, (uint64_t)v); }

static int buf_padded(Buf *b, const uint8_t *p, int n)
{
    static const uint8_t z[4] = {0, 0, 0, 0};
    int pad = (4 - (n & 3)) & 3;
    if (buf_put(b, p, n) < 0)
        return -1;
    if (pad && buf_put(b, z, pad) < 0)
        return -1;
    return 0;
}

static void buf_free(Buf *b)
{
    if (!b->ar)
        free(b->data);
    b->data = NULL;
    b->len = b->cap = 0;
}

static void wr_u32_at(uint8_t *p, uint32_t v)
{
    p[0] = (uint8_t)(v >> 24);
    p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8);
    p[3] = (uint8_t)v;
}

static void wr_i64_at(uint8_t *p, int64_t sv)
{
    uint64_t v = (uint64_t)sv;
    int i;
    for (i = 0; i < 8; i++)
        p[i] = (uint8_t)(v >> (56 - 8 * i));
}

/* ------------------------------------------------------------- reader */

typedef struct {
    const uint8_t *p;
    Py_ssize_t len, pos;
} Rd;

static int rd_u32(Rd *r, uint32_t *v)
{
    if (r->pos + 4 > r->len)
        return -1;
    const uint8_t *p = r->p + r->pos;
    *v = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | p[3];
    r->pos += 4;
    return 0;
}

static int rd_i64(Rd *r, int64_t *v)
{
    if (r->pos + 8 > r->len)
        return -1;
    const uint8_t *p = r->p + r->pos;
    uint64_t u = 0;
    int i;
    for (i = 0; i < 8; i++)
        u = (u << 8) | p[i];
    *v = (int64_t)u;
    r->pos += 8;
    return 0;
}

static int rd_u64(Rd *r, uint64_t *v)
{
    int64_t s;
    if (rd_i64(r, &s) < 0)
        return -1;
    *v = (uint64_t)s;
    return 0;
}

static const uint8_t *rd_take(Rd *r, Py_ssize_t n)
{
    if (n < 0 || r->pos + n > r->len)
        return NULL;
    const uint8_t *p = r->p + r->pos;
    r->pos += n;
    return p;
}

static int rd_skip_padded(Rd *r, Py_ssize_t n)
{
    Py_ssize_t pad = (4 - (n & 3)) & 3;
    return rd_take(r, n + pad) ? 0 : -1;
}

/* ------------------------------------------------------------- entries */

/* The COMPLETE mutable state of one ledger entry under the supported
   ops, snapshotted whole per savepoint level. One struct for all four
   entry kinds keeps the journal a single struct copy; at ~1KB per
   first-touch per level that is still noise next to one signature
   verify. Byte-exact rollback/diff needs the full pre-image — a dirty
   flag cannot reproduce Python's touched-but-unchanged filtering when
   an op writes identical values. */
typedef struct {
    int exists;
    int64_t balance, seqNum;
    /* account */
    uint32_t numSub, flags; /* flags shared with trustline/offer */
    uint8_t thresholds[4];
    int nsigners;
    int has_infl;
    int home_len;
    int ext_v; /* AccountEntryExt / TrustLineEntryExt version (0/1) */
    int64_t liab_buying, liab_selling;
    /* trustline */
    int64_t tl_limit;
    /* offer */
    int64_t o_amount;
    int32_t o_pn, o_pd;
    /* data */
    int d_len;
    /* lastModifiedLedgerSeq this state serializes with (the base
       blob's value for loaded entries; the creating close's seq for
       entries created/recreated this close) */
    uint32_t lm;
    /* ---- variable-occupancy tails: everything below is only LIVE up
       to the counters above, and mut_copy() moves only the live part —
       the ~1KB whole-struct copy per savepoint touch was the close's
       memory-bandwidth ceiling (and what capped parallel scaling) */
    uint8_t infl[32];
    uint8_t home[32];
    uint8_t d_val[64];
    uint32_t signer_weights[MAX_SIGNERS];
    uint8_t signer_keys[MAX_SIGNERS][32];
} MutState;

/* copy only the live bytes of one MutState. Inactive tail slots keep
   stale bytes — every reader (mut_struct_eq, ser_entry, check_sig)
   bounds itself by the counters, so the garbage is never observed. */
static void mut_copy(MutState *dst, const MutState *src)
{
    memcpy(dst, src, offsetof(MutState, infl));
    if (src->has_infl)
        memcpy(dst->infl, src->infl, 32);
    if (src->home_len)
        memcpy(dst->home, src->home, src->home_len);
    if (src->d_len)
        memcpy(dst->d_val, src->d_val, src->d_len);
    if (src->nsigners) {
        memcpy(dst->signer_weights, src->signer_weights,
               src->nsigners * sizeof(uint32_t));
        memcpy(dst->signer_keys, src->signer_keys, src->nsigners * 32);
    }
}

typedef struct {
    int seen;
    MutState st;
} EntrySave;

typedef struct Entry {
    struct Entry *next;
    uint32_t hash;
    uint8_t *keyb;
    int keylen;
    uint8_t *base; /* close-start LedgerEntry blob (owned); NULL if absent */
    int baselen;
    int type;        /* LET_* */
    MutState st;     /* live state */
    MutState base_st; /* as parsed from base (patch fast-path + deltas) */
    /* identity (immutable once set): account id / trustline holder /
       offer seller / data holder */
    uint8_t acc_key[32];
    /* offers only: */
    int64_t offer_id;
    uint8_t o_sell[MAX_ASSET];
    int o_sell_len;
    uint8_t o_buy[MAX_ASSET];
    int o_buy_len;
    /* patch offsets into base blob: */
    int off_balance, off_seq;
    EntrySave save[MAXLEVEL];
    int64_t order0; /* (txidx<<24)|ordinal stamp of first level-0 touch
                       in a parallel cluster (serial-order merge key) */
    int uf_tx;      /* union-find scratch: first tx to claim this entry */
    int in_created; /* already on the created_offers list */
} Entry;

/* field-wise equality of everything EXCEPT balance/seqNum/lm — the
   patch fast-path test (balance/seq byte-patch the base blob) */
static int mut_struct_eq(const MutState *a, const MutState *b)
{
    int i;
    if (a->exists != b->exists || a->numSub != b->numSub ||
        a->flags != b->flags ||
        memcmp(a->thresholds, b->thresholds, 4) != 0 ||
        a->nsigners != b->nsigners || a->has_infl != b->has_infl ||
        a->home_len != b->home_len || a->ext_v != b->ext_v ||
        a->liab_buying != b->liab_buying ||
        a->liab_selling != b->liab_selling ||
        a->tl_limit != b->tl_limit || a->o_amount != b->o_amount ||
        a->o_pn != b->o_pn || a->o_pd != b->o_pd || a->d_len != b->d_len)
        return 0;
    if (a->has_infl && memcmp(a->infl, b->infl, 32) != 0)
        return 0;
    if (a->home_len && memcmp(a->home, b->home, a->home_len) != 0)
        return 0;
    if (a->d_len && memcmp(a->d_val, b->d_val, a->d_len) != 0)
        return 0;
    for (i = 0; i < a->nsigners; i++)
        if (memcmp(a->signer_keys[i], b->signer_keys[i], 32) != 0 ||
            a->signer_weights[i] != b->signer_weights[i])
            return 0;
    return 1;
}

static int mut_eq(const MutState *a, const MutState *b)
{
    if (a->exists != b->exists)
        return 0;
    if (!a->exists)
        return 1; /* both absent: equal regardless of residue */
    if (a->balance != b->balance || a->seqNum != b->seqNum ||
        a->lm != b->lm)
        return 0;
    return mut_struct_eq(a, b);
}

typedef struct {
    Entry **v;
    int n, cap;
} EList;

static int elist_push(EList *l, Entry *e)
{
    if (l->n == l->cap) {
        int cap = l->cap ? l->cap * 2 : 32;
        Entry **p = realloc(l->v, cap * sizeof(Entry *));
        if (!p)
            return -1;
        l->v = p;
        l->cap = cap;
    }
    l->v[l->n++] = e;
    return 0;
}

/* order-book cache: one root fetch per (selling, buying) pair per close */
typedef struct {
    uint8_t sell[MAX_ASSET], buy[MAX_ASSET];
    int sell_len, buy_len;
    EList offers; /* root-order Entry views (overlay state is live) */
} Book;

typedef struct {
    uint8_t acct[32];
    EList offers; /* root-order per-seller offers */
} AcctBook;

/* statically-knowable signer additions: (account, key) pairs from every
   SET_OPTIONS signer arm in the txset — the pre-verify superset */
typedef struct {
    uint8_t acct[32];
    uint8_t key[32];
} StaticSigner;

typedef struct {
    Entry *buckets[NBUCKETS];
    Entry **all;
    int nall, capall;
    EList closed0;          /* global level-0 first-touch order (fee
                               phase + serial apply) */
    EList created_offers;   /* offers created this close, creation order */
    PyObject *lookup, *verify, *book_cb, *acct_cb;
    int64_t feePool, idPool;
    uint32_t ledgerVersion, ledgerSeq, inflationSeq;
    uint64_t closeTime;
    int64_t baseFee, baseReserve, effBase;
    int bail;  /* unsupported input: fall back to the Python path */
    int pyerr; /* a Python exception is set: propagate */
    const char *bailmsg;
    char bailbuf[48];
    Book *books;
    int nbooks, capbooks;
    AcctBook *abooks;
    int nabooks, capabooks;
    StaticSigner *sadds;
    int nsadds, capsadds;
    int nopy; /* GIL released: any Python need is an engine bug -> bail */
    int abort_flag; /* parallel: some cluster bailed/oomed. Written by
        any worker, polled by the rest with no lock in between, so
        access goes through ctx_abort/ctx_aborted (__atomic) ONLY: a
        plain — even volatile — access racing an atomic one is a data
        race under ThreadSanitizer and UB per the C11 memory model. */
} Ctx;

/* per-apply-context view: the journal + attribution one tx stream (the
   serial loop, the fee phase, or one parallel cluster) mutates. Entries
   are disjoint across concurrently-live AEnvs by construction. */
typedef struct {
    Ctx *c;
    EList lv[MAXLEVEL]; /* lv[0] used only when use_local0 */
    int use_local0;     /* parallel cluster: stamp + collect locally */
    int txidx;          /* current global tx index (order stamps) */
    int ord0;           /* within-tx level-0 ordinal */
    int bail, oom;
    const char *bailmsg;
    char bailbuf[48];
    int64_t op_cnt[MAX_OPTYPES];
    int64_t op_ns[MAX_OPTYPES];
    Arena ar; /* owns every deferred-output buffer this context built */
} AEnv;

/* cross-thread abort latch: relaxed is enough — the flag only asks
   workers to stop early; the authoritative bail/oom state merges after
   the pool join (which is the synchronization point). */
static void ctx_abort(Ctx *c)
{
    __atomic_store_n(&c->abort_flag, 1, __ATOMIC_RELAXED);
}

static int ctx_aborted(Ctx *c)
{
    return __atomic_load_n(&c->abort_flag, __ATOMIC_RELAXED);
}

static void env_bail(AEnv *env, const char *msg)
{
    if (!env->bail) {
        env->bail = 1;
        env->bailmsg = msg;
    }
    ctx_abort(env->c);
}

static void ctx_bail(Ctx *c, const char *msg)
{
    if (!c->bailmsg)
        c->bailmsg = msg;
    c->bail = 1;
}

static int64_t now_ns(void)
{
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000000000LL + (int64_t)ts.tv_nsec;
}

/* per-op attribution clock: two reads per applied op. clock_gettime is
   a real syscall under gVisor-style sandboxes (no vDSO) and its ~µs
   cost both dominates the ~1µs native ops AND serializes parallel
   workers; rdtsc is a register read. Ticks are converted to ns once
   per close against a CLOCK_MONOTONIC bracket (constant_tsc keeps the
   ratio stable; attribution-grade accuracy is all that's needed). */
#if defined(__x86_64__) || defined(__i386__)
static int64_t now_ticks(void)
{
    uint32_t lo, hi;
    __asm__ __volatile__("rdtsc" : "=a"(lo), "=d"(hi));
    return (int64_t)(((uint64_t)hi << 32) | lo);
}
#else
static int64_t now_ticks(void) { return now_ns(); }
#endif

static uint32_t fnv1a(const uint8_t *p, int n)
{
    uint32_t h = 2166136261u;
    int i;
    for (i = 0; i < n; i++) {
        h ^= p[i];
        h *= 16777619u;
    }
    return h;
}

static void ctx_free(Ctx *c)
{
    int i;
    for (i = 0; i < c->nall; i++) {
        Entry *e = c->all[i];
        free(e->keyb);
        free(e->base);
        free(e);
    }
    free(c->all);
    free(c->closed0.v);
    free(c->created_offers.v);
    for (i = 0; i < c->nbooks; i++)
        free(c->books[i].offers.v);
    free(c->books);
    for (i = 0; i < c->nabooks; i++)
        free(c->abooks[i].offers.v);
    free(c->abooks);
    free(c->sadds);
}

/* -------------------------------------------------------- entry parsing */

/* optional entry extension with liabilities: u32 disc {0,1}; v1 carries
   {i64 buying, i64 selling, u32 inner-ext 0} */
static int rd_liab_ext(Rd *r, MutState *st)
{
    uint32_t u;
    if (rd_u32(r, &u) < 0 || u > 1)
        return -1;
    st->ext_v = (int)u;
    st->liab_buying = st->liab_selling = 0;
    if (u == 1) {
        if (rd_i64(r, &st->liab_buying) < 0 ||
            rd_i64(r, &st->liab_selling) < 0)
            return -1;
        if (rd_u32(r, &u) < 0 || u != 0)
            return -1;
    }
    return 0;
}

/* account LedgerEntry blob -> Entry; returns -1 on unsupported */
static int parse_account(Ctx *c, Entry *e, const uint8_t *blob, int len)
{
    Rd r = {blob, len, 0};
    MutState *st = &e->st;
    uint32_t u, ktype, n;
    int i;
    if (rd_u32(&r, &st->lm) < 0)
        return -1;
    if (rd_u32(&r, &u) < 0 || u != LET_ACCOUNT)
        return -1;
    if (rd_u32(&r, &ktype) < 0 || ktype != 0)
        return -1;
    const uint8_t *key = rd_take(&r, 32);
    if (!key)
        return -1;
    memcpy(e->acc_key, key, 32);
    e->off_balance = (int)r.pos;
    if (rd_i64(&r, &st->balance) < 0)
        return -1;
    e->off_seq = (int)r.pos;
    if (rd_i64(&r, &st->seqNum) < 0)
        return -1;
    if (rd_u32(&r, &st->numSub) < 0)
        return -1;
    if (rd_u32(&r, &u) < 0 || u > 1) /* inflationDest optional */
        return -1;
    st->has_infl = (int)u;
    if (u == 1) {
        const uint8_t *ip;
        if (rd_u32(&r, &ktype) < 0 || ktype != 0 ||
            !(ip = rd_take(&r, 32)))
            return -1;
        memcpy(st->infl, ip, 32);
    }
    if (rd_u32(&r, &st->flags) < 0)
        return -1;
    if (rd_u32(&r, &u) < 0 || u > 32) /* homeDomain */
        return -1;
    st->home_len = (int)u;
    if (u) {
        Py_ssize_t at = r.pos;
        if (rd_skip_padded(&r, u) < 0)
            return -1;
        memcpy(st->home, blob + at, u);
    }
    const uint8_t *th = rd_take(&r, 4);
    if (!th)
        return -1;
    memcpy(st->thresholds, th, 4);
    if (rd_u32(&r, &n) < 0)
        return -1;
    if (n > MAX_SIGNERS) {
        ctx_bail(c, "multisig-shape");
        return -1;
    }
    st->nsigners = (int)n;
    for (i = 0; i < st->nsigners; i++) {
        if (rd_u32(&r, &ktype) < 0)
            return -1;
        if (ktype != 0) { /* pre-auth-tx / hash-x signers: Python path */
            ctx_bail(c, "signer-key-type");
            return -1;
        }
        const uint8_t *sk = rd_take(&r, 32);
        if (!sk)
            return -1;
        memcpy(st->signer_keys[i], sk, 32);
        if (rd_u32(&r, &st->signer_weights[i]) < 0)
            return -1;
    }
    if (rd_liab_ext(&r, st) < 0)
        return -1;
    if (rd_u32(&r, &u) < 0 || u != 0) /* LedgerEntry ext */
        return -1;
    if (r.pos != r.len)
        return -1;
    st->exists = 1;
    e->base_st = *st;
    return 0;
}

static int parse_trustline(Ctx *c, Entry *e, const uint8_t *blob, int len)
{
    Rd r = {blob, len, 0};
    MutState *st = &e->st;
    uint32_t u, atype;
    (void)c;
    if (rd_u32(&r, &st->lm) < 0)
        return -1;
    if (rd_u32(&r, &u) < 0 || u != LET_TRUSTLINE)
        return -1;
    const uint8_t *acct;
    if (rd_u32(&r, &u) < 0 || u != 0 || !(acct = rd_take(&r, 32)))
        return -1;
    memcpy(e->acc_key, acct, 32);
    if (rd_u32(&r, &atype) < 0)
        return -1;
    if (atype == 1) {
        if (!rd_take(&r, 4 + 4 + 32))
            return -1;
    } else if (atype == 2) {
        if (!rd_take(&r, 12 + 4 + 32))
            return -1;
    } else
        return -1; /* native trustlines don't exist */
    e->off_balance = (int)r.pos;
    if (rd_i64(&r, &st->balance) < 0)
        return -1;
    if (rd_i64(&r, &st->tl_limit) < 0)
        return -1;
    if (rd_u32(&r, &st->flags) < 0)
        return -1;
    if (rd_liab_ext(&r, st) < 0)
        return -1;
    if (rd_u32(&r, &u) < 0 || u != 0)
        return -1;
    if (r.pos != r.len)
        return -1;
    st->exists = 1;
    e->base_st = *st;
    return 0;
}

/* raw Asset XDR at the reader head -> out[], returns length or -1 */
static int rd_asset_raw(Rd *r, uint8_t *out)
{
    Py_ssize_t at = r->pos;
    uint32_t atype, kt;
    if (rd_u32(r, &atype) < 0)
        return -1;
    if (atype == 0) {
        /* native */
    } else if (atype == 1 || atype == 2) {
        if (!rd_take(r, atype == 1 ? 4 : 12))
            return -1;
        if (rd_u32(r, &kt) < 0 || kt != 0 || !rd_take(r, 32))
            return -1;
    } else
        return -1;
    int n = (int)(r->pos - at);
    memcpy(out, r->p + at, n);
    return n;
}

static int parse_offer(Ctx *c, Entry *e, const uint8_t *blob, int len)
{
    Rd r = {blob, len, 0};
    MutState *st = &e->st;
    uint32_t u;
    (void)c;
    if (rd_u32(&r, &st->lm) < 0)
        return -1;
    if (rd_u32(&r, &u) < 0 || u != LET_OFFER)
        return -1;
    const uint8_t *acct;
    if (rd_u32(&r, &u) < 0 || u != 0 || !(acct = rd_take(&r, 32)))
        return -1;
    memcpy(e->acc_key, acct, 32);
    if (rd_i64(&r, &e->offer_id) < 0)
        return -1;
    e->o_sell_len = rd_asset_raw(&r, e->o_sell);
    if (e->o_sell_len < 0)
        return -1;
    e->o_buy_len = rd_asset_raw(&r, e->o_buy);
    if (e->o_buy_len < 0)
        return -1;
    if (rd_i64(&r, &st->o_amount) < 0)
        return -1;
    uint32_t pn, pd;
    if (rd_u32(&r, &pn) < 0 || rd_u32(&r, &pd) < 0)
        return -1;
    st->o_pn = (int32_t)pn;
    st->o_pd = (int32_t)pd;
    if (rd_u32(&r, &st->flags) < 0)
        return -1;
    if (rd_u32(&r, &u) < 0 || u != 0) /* OfferEntry ext */
        return -1;
    if (rd_u32(&r, &u) < 0 || u != 0) /* LedgerEntry ext */
        return -1;
    if (r.pos != r.len)
        return -1;
    st->exists = 1;
    e->base_st = *st;
    return 0;
}

static int parse_data(Ctx *c, Entry *e, const uint8_t *blob, int len)
{
    Rd r = {blob, len, 0};
    MutState *st = &e->st;
    uint32_t u, n;
    (void)c;
    if (rd_u32(&r, &st->lm) < 0)
        return -1;
    if (rd_u32(&r, &u) < 0 || u != LET_DATA)
        return -1;
    const uint8_t *acct;
    if (rd_u32(&r, &u) < 0 || u != 0 || !(acct = rd_take(&r, 32)))
        return -1;
    memcpy(e->acc_key, acct, 32);
    if (rd_u32(&r, &n) < 0 || n > 64) /* dataName */
        return -1;
    if (rd_skip_padded(&r, n) < 0) /* name lives in keyb; skip here */
        return -1;
    if (rd_u32(&r, &n) < 0 || n > 64) /* dataValue */
        return -1;
    st->d_len = (int)n;
    {
        Py_ssize_t at = r.pos;
        if (rd_skip_padded(&r, n) < 0)
            return -1;
        memcpy(st->d_val, blob + at, n);
    }
    if (rd_u32(&r, &u) < 0 || u != 0) /* DataEntry ext */
        return -1;
    if (rd_u32(&r, &u) < 0 || u != 0) /* LedgerEntry ext */
        return -1;
    if (r.pos != r.len)
        return -1;
    st->exists = 1;
    e->base_st = *st;
    return 0;
}

/* ------------------------------------------------------- overlay access */

static Entry *find_entry(Ctx *c, const uint8_t *keyb, int keylen,
                         uint32_t *hout)
{
    uint32_t h = fnv1a(keyb, keylen);
    if (hout)
        *hout = h;
    Entry *e = c->buckets[h & (NBUCKETS - 1)];
    for (; e; e = e->next)
        if (e->hash == h && e->keylen == keylen &&
            memcmp(e->keyb, keyb, keylen) == 0)
            return e;
    return NULL;
}

/* allocate + index a fresh Entry shell for keyb (state unset) */
static Entry *insert_entry(AEnv *env, const uint8_t *keyb, int keylen,
                           uint32_t h)
{
    Ctx *c = env->c;
    Entry *e = calloc(1, sizeof(Entry));
    if (!e) {
        env->oom = 1;
        return NULL;
    }
    e->hash = h;
    e->keylen = keylen;
    e->keyb = malloc(keylen);
    if (!e->keyb) {
        free(e);
        env->oom = 1;
        return NULL;
    }
    memcpy(e->keyb, keyb, keylen);
    e->uf_tx = -1;
    {
        Rd kr = {keyb, keylen, 0};
        uint32_t kt = 0;
        rd_u32(&kr, &kt);
        e->type = (int)kt;
    }
    if (c->nall == c->capall) {
        int cap = c->capall ? c->capall * 2 : 64;
        Entry **p = realloc(c->all, cap * sizeof(Entry *));
        if (!p) {
            free(e->keyb);
            free(e);
            env->oom = 1;
            return NULL;
        }
        c->all = p;
        c->capall = cap;
    }
    c->all[c->nall++] = e;
    e->next = c->buckets[h & (NBUCKETS - 1)];
    c->buckets[h & (NBUCKETS - 1)] = e;
    return e;
}

/* parse a base blob into a freshly-inserted entry */
static int entry_adopt_blob(AEnv *env, Entry *e, const uint8_t *blob,
                            int len)
{
    Ctx *c = env->c;
    e->base = malloc(len > 0 ? len : 1);
    if (!e->base) {
        env->oom = 1;
        return -1;
    }
    memcpy(e->base, blob, len);
    e->baselen = len;
    int rc;
    switch (e->type) {
    case LET_ACCOUNT:
        rc = parse_account(c, e, e->base, len);
        break;
    case LET_TRUSTLINE:
        rc = parse_trustline(c, e, e->base, len);
        break;
    case LET_OFFER:
        rc = parse_offer(c, e, e->base, len);
        break;
    case LET_DATA:
        rc = parse_data(c, e, e->base, len);
        break;
    default:
        rc = -1;
    }
    if (rc < 0) {
        if (!c->bailmsg)
            ctx_bail(c, "entry-kind");
        env->bail = 1;
        env->bailmsg = c->bailmsg;
        ctx_abort(c);
        return -1;
    }
    return 0;
}

/* overlay get-or-load; NULL means bail/oom/pyerr (check env/ctx flags).
   A miss calls the Python lookup callback — illegal when the GIL is
   released (c->nopy): that is an engine bug (incomplete static prefetch),
   surfaced as a bail so the close re-runs on the Python path. */
static Entry *get_entry(AEnv *env, const uint8_t *keyb, int keylen)
{
    Ctx *c = env->c;
    uint32_t h;
    Entry *e = find_entry(c, keyb, keylen, &h);
    if (e)
        return e;
    if (c->nopy) {
        env_bail(env, "prefetch-miss");
        return NULL;
    }

    PyObject *kb = PyBytes_FromStringAndSize((const char *)keyb, keylen);
    if (!kb) {
        c->pyerr = 1;
        return NULL;
    }
    PyObject *blob = PyObject_CallFunctionObjArgs(c->lookup, kb, NULL);
    Py_DECREF(kb);
    if (!blob) {
        c->pyerr = 1;
        return NULL;
    }
    e = insert_entry(env, keyb, keylen, h);
    if (!e) {
        Py_DECREF(blob);
        return NULL;
    }
    if (blob == Py_None) {
        /* absent: exists stays 0 */
    } else if (PyBytes_Check(blob)) {
        if (entry_adopt_blob(env, e, (const uint8_t *)PyBytes_AS_STRING(blob),
                             (int)PyBytes_GET_SIZE(blob)) < 0) {
            Py_DECREF(blob);
            return NULL;
        }
    } else {
        ctx_bail(c, "lookup-type");
        env->bail = 1;
        Py_DECREF(blob);
        return NULL;
    }
    Py_DECREF(blob);
    return e;
}

static Entry *get_account(AEnv *env, const uint8_t *accid)
{
    uint8_t keyb[40];
    wr_u32_at(keyb, LET_ACCOUNT);
    wr_u32_at(keyb + 4, 0); /* PUBLIC_KEY_TYPE_ED25519 */
    memcpy(keyb + 8, accid, 32);
    return get_entry(env, keyb, 40);
}

/* trustline key: u32 TRUSTLINE | AccountID | Asset (raw asset bytes) */
static Entry *get_trustline(AEnv *env, const uint8_t *accid,
                            const uint8_t *asset, int assetlen)
{
    uint8_t keyb[40 + MAX_ASSET];
    wr_u32_at(keyb, LET_TRUSTLINE);
    wr_u32_at(keyb + 4, 0);
    memcpy(keyb + 8, accid, 32);
    memcpy(keyb + 40, asset, assetlen);
    return get_entry(env, keyb, 40 + assetlen);
}

/* data key: u32 DATA | AccountID | string64 name */
static Entry *get_data(AEnv *env, const uint8_t *accid,
                       const uint8_t *name, int namelen)
{
    uint8_t keyb[40 + 4 + 64 + 4];
    int pad = (4 - (namelen & 3)) & 3;
    wr_u32_at(keyb, LET_DATA);
    wr_u32_at(keyb + 4, 0);
    memcpy(keyb + 8, accid, 32);
    wr_u32_at(keyb + 40, (uint32_t)namelen);
    memcpy(keyb + 44, name, namelen);
    memset(keyb + 44 + namelen, 0, pad);
    return get_entry(env, keyb, 44 + namelen + pad);
}

static void offer_key(uint8_t *keyb, const uint8_t *seller, int64_t oid)
{
    wr_u32_at(keyb, LET_OFFER);
    wr_u32_at(keyb + 4, 0);
    memcpy(keyb + 8, seller, 32);
    wr_i64_at(keyb + 40, oid);
}

/* ----------------------------------------------------- savepoint journal */

static int touch(AEnv *env, Entry *e, int lv)
{
    if (e->save[lv].seen)
        return 0;
    e->save[lv].seen = 1;
    mut_copy(&e->save[lv].st, &e->st);
    if (elist_push(&env->lv[lv], e) < 0) {
        env->oom = 1;
        ctx_abort(env->c);
        return -1;
    }
    return 0;
}

/* commit level lv into lv-1. Level-0 destination is the global
   closed0 list in serial mode, or the cluster-local stamped list in
   parallel mode (sorted back into serial first-touch order after the
   join). */
static int commit_level(AEnv *env, int lv)
{
    int i;
    EList *from = &env->lv[lv];
    for (i = 0; i < from->n; i++) {
        Entry *e = from->v[i];
        if (!e->save[lv - 1].seen) {
            mut_copy(&e->save[lv - 1].st, &e->save[lv].st);
            e->save[lv - 1].seen = 1;
            if (lv == 1) {
                if (env->use_local0) {
                    e->order0 = ((int64_t)env->txidx << 24) |
                                (int64_t)env->ord0++;
                    if (elist_push(&env->lv[0], e) < 0) {
                        env->oom = 1;
                        ctx_abort(env->c);
                        return -1;
                    }
                } else {
                    if (elist_push(&env->c->closed0, e) < 0) {
                        env->oom = 1;
                        ctx_abort(env->c);
                        return -1;
                    }
                }
            } else {
                if (elist_push(&env->lv[lv - 1], e) < 0) {
                    env->oom = 1;
                    ctx_abort(env->c);
                    return -1;
                }
            }
        }
        e->save[lv].seen = 0;
    }
    from->n = 0;
    return 0;
}

static void rollback_level(AEnv *env, int lv)
{
    int i;
    EList *from = &env->lv[lv];
    for (i = 0; i < from->n; i++) {
        Entry *e = from->v[i];
        mut_copy(&e->st, &e->save[lv].st);
        e->save[lv].seen = 0;
    }
    from->n = 0;
}

/* -------------------------------------------------------- serialization */

/* append the LedgerEntry blob for state `st` of entry e (st->exists
   assumed). Patch fast-path: when only balance/seqNum moved against the
   base parse, the base blob is reused bitwise with the two fields
   patched — zero re-encode risk on the payment path. */
static int ser_entry(Entry *e, const MutState *st, Buf *out)
{
    if (e->base && st->lm == e->base_st.lm &&
        (e->type == LET_ACCOUNT || e->type == LET_TRUSTLINE) &&
        mut_struct_eq(st, &e->base_st)) {
        Py_ssize_t at = out->len;
        if (buf_put(out, e->base, e->baselen) < 0)
            return -1;
        uint8_t *p = (uint8_t *)out->data + at;
        wr_i64_at(p + e->off_balance, st->balance);
        if (e->type == LET_ACCOUNT)
            wr_i64_at(p + e->off_seq, st->seqNum);
        return 0;
    }
    if (buf_u32(out, st->lm) < 0 || buf_u32(out, (uint32_t)e->type) < 0)
        return -1;
    switch (e->type) {
    case LET_ACCOUNT:
        if (buf_u32(out, 0) < 0 || buf_put(out, e->acc_key, 32) < 0 ||
            buf_i64(out, st->balance) < 0 || buf_i64(out, st->seqNum) < 0 ||
            buf_u32(out, st->numSub) < 0 ||
            buf_u32(out, (uint32_t)st->has_infl) < 0)
            return -1;
        if (st->has_infl &&
            (buf_u32(out, 0) < 0 || buf_put(out, st->infl, 32) < 0))
            return -1;
        if (buf_u32(out, st->flags) < 0 ||
            buf_u32(out, (uint32_t)st->home_len) < 0)
            return -1;
        if (st->home_len && buf_padded(out, st->home, st->home_len) < 0)
            return -1;
        if (buf_put(out, st->thresholds, 4) < 0 ||
            buf_u32(out, (uint32_t)st->nsigners) < 0)
            return -1;
        for (int i = 0; i < st->nsigners; i++) {
            if (buf_u32(out, 0) < 0 /* SIGNER_KEY_TYPE_ED25519 */ ||
                buf_put(out, st->signer_keys[i], 32) < 0 ||
                buf_u32(out, st->signer_weights[i]) < 0)
                return -1;
        }
        break;
    case LET_TRUSTLINE:
        /* holder + asset are the key's bytes (keyb+8 / keyb+40..) */
        if (buf_u32(out, 0) < 0 || buf_put(out, e->keyb + 8, 32) < 0 ||
            buf_put(out, e->keyb + 40, e->keylen - 40) < 0 ||
            buf_i64(out, st->balance) < 0 ||
            buf_i64(out, st->tl_limit) < 0 ||
            buf_u32(out, st->flags) < 0)
            return -1;
        break;
    case LET_OFFER:
        if (buf_u32(out, 0) < 0 || buf_put(out, e->acc_key, 32) < 0 ||
            buf_i64(out, e->offer_id) < 0 ||
            buf_put(out, e->o_sell, e->o_sell_len) < 0 ||
            buf_put(out, e->o_buy, e->o_buy_len) < 0 ||
            buf_i64(out, st->o_amount) < 0 ||
            buf_i32(out, st->o_pn) < 0 || buf_i32(out, st->o_pd) < 0 ||
            buf_u32(out, st->flags) < 0 ||
            buf_u32(out, 0) < 0 /* OfferEntry ext */)
            return -1;
        break;
    case LET_DATA:
        /* holder + name are the key's bytes */
        if (buf_u32(out, 0) < 0 || buf_put(out, e->keyb + 8, 32) < 0 ||
            buf_put(out, e->keyb + 40, e->keylen - 40) < 0 ||
            buf_u32(out, (uint32_t)st->d_len) < 0 ||
            (st->d_len && buf_padded(out, st->d_val, st->d_len) < 0) ||
            buf_u32(out, 0) < 0 /* DataEntry ext */)
            return -1;
        break;
    default:
        return -1;
    }
    if (e->type == LET_ACCOUNT || e->type == LET_TRUSTLINE) {
        /* AccountEntryExt / TrustLineEntryExt (+ liabilities at v1) */
        if (buf_u32(out, (uint32_t)st->ext_v) < 0)
            return -1;
        if (st->ext_v == 1 &&
            (buf_i64(out, st->liab_buying) < 0 ||
             buf_i64(out, st->liab_selling) < 0 ||
             buf_u32(out, 0) < 0 /* v1 inner ext */))
            return -1;
    }
    if (buf_u32(out, 0) < 0 /* LedgerEntry ext v0 */)
        return -1;
    return 0;
}

/* LedgerEntryChanges blob for level lv of env (does NOT commit).
   Mirrors LedgerTxn.get_delta + delta_to_changes: entries in
   first-touch order, touched-but-unchanged filtered, STATE before
   UPDATED/REMOVED, CREATED alone. Returns a malloc Buf (caller owns). */
static int delta_changes_buf(AEnv *env, int lv, Buf *b)
{
    uint32_t n = 0;
    int i;
    if (buf_u32(b, 0) < 0)
        goto oom;
    for (i = 0; i < env->lv[lv].n; i++) {
        Entry *e = env->lv[lv].v[i];
        EntrySave *s = &e->save[lv];
        if (mut_eq(&e->st, &s->st))
            continue;
        if (s->st.exists && e->st.exists) {
            if (buf_u32(b, 3) < 0 || /* LEDGER_ENTRY_STATE */
                ser_entry(e, &s->st, b) < 0)
                goto oom;
            if (buf_u32(b, 1) < 0 || /* LEDGER_ENTRY_UPDATED */
                ser_entry(e, &e->st, b) < 0)
                goto oom;
            n += 2;
        } else if (!s->st.exists && e->st.exists) {
            if (buf_u32(b, 0) < 0 || /* LEDGER_ENTRY_CREATED */
                ser_entry(e, &e->st, b) < 0)
                goto oom;
            n += 1;
        } else { /* s exists, e doesn't: deletion */
            if (buf_u32(b, 3) < 0 || ser_entry(e, &s->st, b) < 0)
                goto oom;
            if (buf_u32(b, 2) < 0 || /* LEDGER_ENTRY_REMOVED: the key */
                buf_put(b, e->keyb, e->keylen) < 0)
                goto oom;
            n += 2;
        }
    }
    wr_u32_at((uint8_t *)b->data, n);
    return 0;
oom:
    env->oom = 1;
    ctx_abort(env->c);
    return -1;
}

static int empty_changes_buf(Buf *b)
{
    return buf_u32(b, 0);
}

/* ------------------------------------------------------------ tx parsing */

typedef struct {
    int has_src;
    uint8_t src[32];
    int optype;
    int dynamic; /* touches the order book: close stays serial+GIL */
    /* create-account / payment / account-merge destination */
    uint8_t dest[32];
    int64_t amount;
    int asset_native;
    uint8_t asset[MAX_ASSET]; /* raw Asset XDR (payment / change-trust) */
    int assetlen;
    const uint8_t *issuer; /* into asset[] (credit assets) */
    /* SET_OPTIONS (every field optional on the wire) */
    int so_has_infl, so_has_clear, so_has_set;
    int so_has_mw, so_has_lt, so_has_mt, so_has_ht;
    int so_has_home, so_has_signer;
    uint8_t so_infl[32];
    uint32_t so_clear, so_set, so_mw, so_lt, so_mt, so_ht;
    int so_home_len;
    uint8_t so_home[32];
    uint8_t so_signer_key[32];
    uint32_t so_signer_w;
    /* CHANGE_TRUST */
    int64_t ct_limit;
    /* ALLOW_TRUST */
    uint8_t at_trustor[32];
    uint32_t at_auth;
    uint8_t at_asset[MAX_ASSET]; /* derived credit asset (issuer = src) */
    int at_assetlen;
    /* MANAGE_DATA */
    int md_name_len, md_has_val, md_val_len;
    uint8_t md_name[64], md_val[64];
    /* BUMP_SEQUENCE */
    int64_t bs_to;
    /* offers (sell-side normal form; buy offers are converted) */
    uint8_t o_sell[MAX_ASSET], o_buy[MAX_ASSET];
    int o_sell_len, o_buy_len;
    __int128 o_amount;     /* sell amount (buyAmount*n/d can exceed i64) */
    int64_t o_buy_amount;  /* ManageBuyOffer wire buyAmount */
    int32_t o_pn, o_pd;    /* effective sell-side price */
    int64_t o_offer_id;
    int o_passive, o_is_buy;
    /* path payments */
    uint8_t pp_send[MAX_ASSET], pp_dest[MAX_ASSET];
    int pp_send_len, pp_dest_len;
    int64_t pp_amount; /* destAmount (recv) / sendAmount (send) */
    int64_t pp_limit;  /* sendMax (recv) / destMin (send) */
    int pp_npath;
    uint8_t pp_path[MAX_PATH][MAX_ASSET];
    int pp_path_len[MAX_PATH];
} Op;

typedef struct {
    uint8_t hint[4];
    const uint8_t *sig;
    int siglen;
    PyObject *sig_obj; /* lazily-built bytes for the verify callback */
    int used;
} Sig;

/* one (signer-key, signature-index) candidate with its batch-verified
   result */
typedef struct {
    uint8_t key[32];
    int sigidx;
    int ok;
} VPair;

typedef struct {
    VPair *pairs;
    int n, cap;
} VSet;

/* per-tx deferred outputs: built (malloc-only) during apply, turned
   into Python objects at emission with the GIL */
typedef struct {
    int code;      /* optype when code==opINNER */
    int optype;
    int inner_code;
    int has_payload;
    Buf payload;   /* serialized success payload (merge/offers/paths) */
} OpRes;

typedef struct Tx {
    int is_fee_bump;
    uint8_t src[32];
    int64_t fee_bid; /* u32 for v1 txs, i64 for fee-bump outers */
    int64_t seqNum;
    int has_tb;
    uint64_t minTime, maxTime;
    int nops;
    Op *ops;
    int nsigs;
    Sig sigs[MAX_SIGS];
    const uint8_t *hash; /* contents hash (borrowed from hashes list) */
    PyObject *hash_obj;  /* borrowed bytes object for that hash */
    int64_t feeCharged;
    VSet vs;             /* pre-verified candidate pairs */
    struct Tx *inner;    /* fee bumps: the wrapped v1 tx */
    int dynamic;         /* any op needs the order book */
    /* deferred outputs */
    int out_have;        /* outputs below are valid */
    int out_code;        /* tx-level TransactionResultCode */
    int out_ok;          /* ops committed (SUCCESS) */
    int out_empty_txch;  /* INTERNAL_ERROR arm: empty tx changes */
    int out_meta_ops;    /* op slots in the meta (0 on pre-ops failures) */
    int out_res_ops;     /* op results in the result (SUCCESS/FAILED) */
    OpRes *opres;
    int opres_in_arena; /* opres/opch live in the applying env's arena */
    Buf txch;
    Buf *opch;           /* per-op changes (valid when out_ok) */
    Buf out_rb, out_mb;  /* result / meta XDR, pre-emitted on the
                            applying thread (pure C; the GIL-held
                            emission pass only wraps PyBytes) */
} Tx;

static void tx_free(Tx *t)
{
    int i;
    if (!t)
        return;
    free(t->ops);
    for (i = 0; i < t->nsigs; i++)
        Py_XDECREF(t->sigs[i].sig_obj);
    free(t->vs.pairs);
    if (t->opres) {
        for (i = 0; i < t->nops; i++)
            buf_free(&t->opres[i].payload);
        if (!t->opres_in_arena)
            free(t->opres);
    }
    buf_free(&t->txch);
    buf_free(&t->out_rb);
    buf_free(&t->out_mb);
    if (t->opch) {
        for (i = 0; i < t->nops; i++)
            buf_free(&t->opch[i]);
        if (!t->opres_in_arena)
            free(t->opch);
    }
    if (t->inner) {
        tx_free(t->inner);
        free(t->inner);
    }
}

/* MuxedAccount: ed25519 or med25519 (sub-id stripped — the repo's
   frames resolve .account_id everywhere state or results are built) */
static int rd_muxed(Rd *r, uint8_t *out32)
{
    uint32_t kt;
    if (rd_u32(r, &kt) < 0)
        return -1;
    if (kt == 0x100) { /* KEY_TYPE_MUXED_ED25519: u64 id + key */
        if (!rd_take(r, 8))
            return -1;
    } else if (kt != 0)
        return -1;
    const uint8_t *p = rd_take(r, 32);
    if (!p)
        return -1;
    memcpy(out32, p, 32);
    return 0;
}

static int rd_asset_op(Rd *r, Op *op)
{
    Py_ssize_t at = r->pos;
    uint32_t atype;
    if (rd_u32(r, &atype) < 0)
        return -1;
    if (atype == 0) {
        op->asset_native = 1;
        op->assetlen = 4;
    } else if (atype == 1 || atype == 2) {
        uint32_t kt;
        if (!rd_take(r, atype == 1 ? 4 : 12))
            return -1;
        if (rd_u32(r, &kt) < 0 || kt != 0)
            return -1;
        if (!rd_take(r, 32))
            return -1;
        op->asset_native = 0;
        op->assetlen = (int)(r->pos - at);
    } else
        return -1;
    memcpy(op->asset, r->p + at, r->pos - at);
    op->issuer = op->asset + op->assetlen - 32;
    return 0;
}

static int asset_is_native(const uint8_t *a, int n)
{
    return n == 4 && a[0] == 0 && a[1] == 0 && a[2] == 0 && a[3] == 0;
}

static const uint8_t *asset_issuer(const uint8_t *a, int n)
{
    return a + n - 32; /* credit assets only */
}

static int asset_eq(const uint8_t *a, int an, const uint8_t *b, int bn)
{
    return an == bn && memcmp(a, b, an) == 0;
}

/* parse one Operation body; returns -1 on malformed/bailed input */
static int parse_op_body(Ctx *c, Rd *r, Op *op)
{
    uint32_t u, kt;
    switch (op->optype) {
    case OP_CREATE_ACCOUNT: {
        const uint8_t *p;
        if (rd_u32(r, &kt) < 0 || kt != 0 || !(p = rd_take(r, 32)))
            return -1;
        memcpy(op->dest, p, 32);
        if (rd_i64(r, &op->amount) < 0)
            return -1;
        return 0;
    }
    case OP_PAYMENT:
        if (rd_muxed(r, op->dest) < 0 || rd_asset_op(r, op) < 0 ||
            rd_i64(r, &op->amount) < 0)
            return -1;
        return 0;
    case OP_PATH_PAYMENT_RECV:
    case OP_PATH_PAYMENT_SEND: {
        int recv = (op->optype == OP_PATH_PAYMENT_RECV);
        op->pp_send_len = rd_asset_raw(r, op->pp_send);
        if (op->pp_send_len < 0)
            return -1;
        /* recv: sendMax then dest/destAsset/destAmount;
           send: sendAmount then dest/destAsset/destMin */
        int64_t first;
        if (rd_i64(r, &first) < 0)
            return -1;
        if (rd_muxed(r, op->dest) < 0)
            return -1;
        op->pp_dest_len = rd_asset_raw(r, op->pp_dest);
        if (op->pp_dest_len < 0)
            return -1;
        int64_t second;
        if (rd_i64(r, &second) < 0)
            return -1;
        if (recv) {
            op->pp_limit = first;   /* sendMax */
            op->pp_amount = second; /* destAmount */
        } else {
            op->pp_amount = first;  /* sendAmount */
            op->pp_limit = second;  /* destMin */
        }
        if (rd_u32(r, &u) < 0 || u > MAX_PATH)
            return -1;
        op->pp_npath = (int)u;
        for (int k = 0; k < op->pp_npath; k++) {
            op->pp_path_len[k] = rd_asset_raw(r, op->pp_path[k]);
            if (op->pp_path_len[k] < 0)
                return -1;
        }
        op->dynamic = 1;
        return 0;
    }
    case OP_MANAGE_SELL_OFFER:
    case OP_CREATE_PASSIVE_OFFER:
    case OP_MANAGE_BUY_OFFER: {
        op->o_sell_len = rd_asset_raw(r, op->o_sell);
        if (op->o_sell_len < 0)
            return -1;
        op->o_buy_len = rd_asset_raw(r, op->o_buy);
        if (op->o_buy_len < 0)
            return -1;
        int64_t amt;
        uint32_t pn, pd;
        if (rd_i64(r, &amt) < 0 || rd_u32(r, &pn) < 0 ||
            rd_u32(r, &pd) < 0)
            return -1;
        if (op->optype == OP_CREATE_PASSIVE_OFFER) {
            op->o_offer_id = 0;
            op->o_passive = 1;
        } else if (rd_i64(r, &op->o_offer_id) < 0)
            return -1;
        if ((int32_t)pn <= 0 || (int32_t)pd <= 0) {
            /* zero/negative price at apply is a Python exception
               (ZeroDivisionError in exchange) — keep it the oracle */
            ctx_bail(c, "op-shape");
            return -1;
        }
        if (op->optype == OP_MANAGE_BUY_OFFER) {
            op->o_is_buy = 1;
            op->o_buy_amount = amt;
            /* equivalent sell offer: amount = buyAmount*n/d (floor,
               may exceed int64 — Python ints are unbounded), price
               inverted (ManageBuyOfferOpFrame._params) */
            op->o_amount = amt > 0
                               ? ((__int128)amt * (int32_t)pn) /
                                     (int32_t)pd
                               : 0;
            op->o_pn = (int32_t)pd;
            op->o_pd = (int32_t)pn;
        } else {
            op->o_amount = amt;
            op->o_pn = (int32_t)pn;
            op->o_pd = (int32_t)pd;
        }
        op->dynamic = 1;
        return 0;
    }
    case OP_SET_OPTIONS: {
        if (rd_u32(r, &u) < 0 || u > 1)
            return -1;
        op->so_has_infl = (int)u;
        if (u) {
            const uint8_t *p;
            if (rd_u32(r, &kt) < 0 || kt != 0 || !(p = rd_take(r, 32)))
                return -1;
            memcpy(op->so_infl, p, 32);
        }
        struct {
            int *has;
            uint32_t *val;
        } ou32[6] = {
            {&op->so_has_clear, &op->so_clear},
            {&op->so_has_set, &op->so_set},
            {&op->so_has_mw, &op->so_mw},
            {&op->so_has_lt, &op->so_lt},
            {&op->so_has_mt, &op->so_mt},
            {&op->so_has_ht, &op->so_ht},
        };
        for (int k = 0; k < 6; k++) {
            if (rd_u32(r, &u) < 0 || u > 1)
                return -1;
            *ou32[k].has = (int)u;
            if (u && rd_u32(r, ou32[k].val) < 0)
                return -1;
        }
        /* thresholds > 255 make the Python oracle raise mid-close
           (bytearray assignment); keep it the oracle */
        if ((op->so_has_mw && op->so_mw > 255) ||
            (op->so_has_lt && op->so_lt > 255) ||
            (op->so_has_mt && op->so_mt > 255) ||
            (op->so_has_ht && op->so_ht > 255)) {
            ctx_bail(c, "threshold-range");
            return -1;
        }
        if (rd_u32(r, &u) < 0 || u > 1)
            return -1;
        op->so_has_home = (int)u;
        if (u) {
            uint32_t sl;
            if (rd_u32(r, &sl) < 0 || sl > 32)
                return -1;
            Py_ssize_t at = r->pos;
            if (rd_skip_padded(r, sl) < 0)
                return -1;
            op->so_home_len = (int)sl;
            memcpy(op->so_home, r->p + at, sl);
        }
        if (rd_u32(r, &u) < 0 || u > 1)
            return -1;
        op->so_has_signer = (int)u;
        if (u) {
            const uint8_t *p;
            if (rd_u32(r, &kt) < 0)
                return -1;
            if (kt != 0) { /* pre-auth-tx / hash-x: Python path */
                ctx_bail(c, "signer-key-type");
                return -1;
            }
            if (!(p = rd_take(r, 32)))
                return -1;
            memcpy(op->so_signer_key, p, 32);
            if (rd_u32(r, &op->so_signer_w) < 0)
                return -1;
        }
        return 0;
    }
    case OP_CHANGE_TRUST:
        if (rd_asset_op(r, op) < 0 || rd_i64(r, &op->ct_limit) < 0)
            return -1;
        if (op->asset_native) {
            /* Python do_apply would build LedgerKey.account(None) and
               raise — keep it the oracle */
            ctx_bail(c, "op-shape");
            return -1;
        }
        return 0;
    case OP_ALLOW_TRUST: {
        const uint8_t *p;
        if (rd_u32(r, &kt) < 0 || kt != 0 || !(p = rd_take(r, 32)))
            return -1;
        memcpy(op->at_trustor, p, 32);
        uint32_t atype;
        const uint8_t *code;
        int codelen;
        if (rd_u32(r, &atype) < 0)
            return -1;
        if (atype == 1)
            codelen = 4;
        else if (atype == 2)
            codelen = 12;
        else
            return -1;
        if (!(code = rd_take(r, codelen)))
            return -1;
        if (rd_u32(r, &op->at_auth) < 0)
            return -1;
        /* Python derives Asset.credit(code.rstrip(b"\0").decode()) with
           the op SOURCE as issuer — a 12-byte arm with a short code
           becomes ALPHANUM4, exactly like the frame does. The issuer
           bytes are filled at apply (op source resolved there). */
        int trimmed = codelen;
        while (trimmed > 0 && code[trimmed - 1] == 0)
            trimmed--;
        if (trimmed == 0) {
            ctx_bail(c, "op-shape"); /* Asset.credit("") raises */
            return -1;
        }
        for (int k = 0; k < trimmed; k++)
            if (code[k] >= 0x80) {
                ctx_bail(c, "op-shape"); /* non-ascii code raises */
                return -1;
            }
        int outcode = trimmed <= 4 ? 4 : 12;
        wr_u32_at(op->at_asset, outcode == 4 ? 1 : 2);
        memset(op->at_asset + 4, 0, outcode);
        memcpy(op->at_asset + 4, code, trimmed);
        wr_u32_at(op->at_asset + 4 + outcode, 0);
        /* issuer placeholder zeroed; patched per-apply with op source */
        memset(op->at_asset + 8 + outcode, 0, 32);
        op->at_assetlen = 8 + outcode + 32;
        /* a full revoke pulls the trustor's offers (order-book walk) */
        if (op->at_auth == 0)
            op->dynamic = 1;
        return 0;
    }
    case OP_ACCOUNT_MERGE:
        if (rd_muxed(r, op->dest) < 0)
            return -1;
        return 0;
    case OP_INFLATION:
        return 0; /* void body */
    case OP_MANAGE_DATA: {
        uint32_t nl;
        if (rd_u32(r, &nl) < 0 || nl > 64)
            return -1;
        Py_ssize_t at = r->pos;
        if (rd_skip_padded(r, nl) < 0)
            return -1;
        op->md_name_len = (int)nl;
        memcpy(op->md_name, r->p + at, nl);
        if (rd_u32(r, &u) < 0 || u > 1)
            return -1;
        op->md_has_val = (int)u;
        if (u) {
            uint32_t vl;
            if (rd_u32(r, &vl) < 0 || vl > 64)
                return -1;
            at = r->pos;
            if (rd_skip_padded(r, vl) < 0)
                return -1;
            op->md_val_len = (int)vl;
            memcpy(op->md_val, r->p + at, vl);
        }
        return 0;
    }
    case OP_BUMP_SEQUENCE:
        if (rd_i64(r, &op->bs_to) < 0)
            return -1;
        return 0;
    default:
        /* unknown wire op type: Python path names it */
        snprintf(c->bailbuf, sizeof(c->bailbuf), "op-%d", op->optype);
        ctx_bail(c, c->bailbuf);
        return -1;
    }
}

/* parse a TransactionV1Envelope BODY (after the outer disc) into t */
static int parse_v1_body(Ctx *c, Rd *r, Tx *t)
{
    uint32_t u, n;
    int i;
    if (rd_muxed(r, t->src) < 0)
        return -1;
    uint32_t fee32;
    if (rd_u32(r, &fee32) < 0 || rd_i64(r, &t->seqNum) < 0)
        return -1;
    t->fee_bid = (int64_t)fee32;
    if (rd_u32(r, &u) < 0 || u > 1)
        return -1;
    t->has_tb = (int)u;
    if (t->has_tb &&
        (rd_u64(r, &t->minTime) < 0 || rd_u64(r, &t->maxTime) < 0))
        return -1;
    if (rd_u32(r, &u) < 0) /* memo */
        return -1;
    switch (u) {
    case 0:
        break;
    case 1: {
        uint32_t sl;
        if (rd_u32(r, &sl) < 0 || sl > 28 || rd_skip_padded(r, sl) < 0)
            return -1;
        break;
    }
    case 2:
        if (!rd_take(r, 8))
            return -1;
        break;
    case 3:
    case 4:
        if (!rd_take(r, 32))
            return -1;
        break;
    default:
        return -1;
    }
    if (rd_u32(r, &n) < 0 || n > 100)
        return -1;
    t->nops = (int)n;
    t->ops = calloc(n ? n : 1, sizeof(Op));
    if (!t->ops) {
        c->pyerr = 1;
        PyErr_NoMemory();
        return -1;
    }
    for (i = 0; i < t->nops; i++) {
        Op *op = &t->ops[i];
        if (rd_u32(r, &u) < 0 || u > 1)
            return -1;
        op->has_src = (int)u;
        if (op->has_src && rd_muxed(r, op->src) < 0)
            return -1;
        if (rd_u32(r, &u) < 0)
            return -1;
        op->optype = (int)u;
        if (parse_op_body(c, r, op) < 0)
            return -1;
        /* version-retired ops are opNOT_SUPPORTED at apply: no book
           access happens, so they don't force the serial path */
        if ((op->optype == OP_MANAGE_BUY_OFFER && c->ledgerVersion < 11) ||
            (op->optype == OP_PATH_PAYMENT_SEND && c->ledgerVersion < 12))
            op->dynamic = 0;
        if (op->dynamic)
            t->dynamic = 1;
    }
    if (rd_u32(r, &u) < 0 || u != 0) /* tx ext */
        return -1;
    if (rd_u32(r, &n) < 0)
        return -1;
    if (n > MAX_SIGS) {
        ctx_bail(c, "multisig-shape");
        return -1;
    }
    t->nsigs = (int)n;
    for (i = 0; i < t->nsigs; i++) {
        const uint8_t *h = rd_take(r, 4);
        if (!h)
            return -1;
        memcpy(t->sigs[i].hint, h, 4);
        uint32_t sl;
        if (rd_u32(r, &sl) < 0 || sl > 64)
            return -1;
        Py_ssize_t pad = (4 - (sl & 3)) & 3;
        const uint8_t *sp = rd_take(r, sl + pad);
        if (!sp)
            return -1;
        t->sigs[i].sig = sp;
        t->sigs[i].siglen = (int)sl;
    }
    return 0;
}

/* whole TransactionEnvelope (v1 or fee bump). `hash` is 32 bytes for
   v1, 64 (outer||inner) for fee bumps. */
static int parse_envelope(Ctx *c, const uint8_t *blob, Py_ssize_t len,
                          const uint8_t *hash, Py_ssize_t hashlen,
                          PyObject *hash_obj, Tx *t)
{
    Rd r = {blob, len, 0};
    uint32_t u, n;
    int i;
    if (rd_u32(&r, &u) < 0)
        return -1;
    if (u == 2) { /* ENVELOPE_TYPE_TX */
        if (hashlen != 32) {
            ctx_bail(c, "input-shape");
            return -1;
        }
        t->hash = hash;
        t->hash_obj = hash_obj;
        if (parse_v1_body(c, &r, t) < 0)
            return -1;
        if (r.pos != r.len)
            return -1;
        return 0;
    }
    if (u != 5) { /* not ENVELOPE_TYPE_TX_FEE_BUMP either */
        ctx_bail(c, "envelope-type");
        return -1;
    }
    if (hashlen != 64) {
        ctx_bail(c, "input-shape");
        return -1;
    }
    t->is_fee_bump = 1;
    t->hash = hash; /* outer contents hash */
    t->hash_obj = hash_obj;
    if (rd_muxed(&r, t->src) < 0) /* feeSource */
        return -1;
    if (rd_i64(&r, &t->fee_bid) < 0)
        return -1;
    if (rd_u32(&r, &u) < 0 || u != 2) /* innerTx disc: ENVELOPE_TYPE_TX */
        return -1;
    t->inner = calloc(1, sizeof(Tx));
    if (!t->inner) {
        c->pyerr = 1;
        PyErr_NoMemory();
        return -1;
    }
    t->inner->hash = hash + 32; /* inner contents hash */
    t->inner->hash_obj = hash_obj;
    if (parse_v1_body(c, &r, t->inner) < 0)
        return -1;
    t->dynamic = t->inner->dynamic;
    if (rd_u32(&r, &u) < 0 || u != 0) /* FeeBumpTransaction ext */
        return -1;
    if (rd_u32(&r, &n) < 0) /* outer signatures */
        return -1;
    if (n > MAX_SIGS) {
        ctx_bail(c, "multisig-shape");
        return -1;
    }
    t->nsigs = (int)n;
    for (i = 0; i < t->nsigs; i++) {
        const uint8_t *h = rd_take(&r, 4);
        if (!h)
            return -1;
        memcpy(t->sigs[i].hint, h, 4);
        uint32_t sl;
        if (rd_u32(&r, &sl) < 0 || sl > 64)
            return -1;
        Py_ssize_t pad = (4 - (sl & 3)) & 3;
        const uint8_t *sp = rd_take(&r, sl + pad);
        if (!sp)
            return -1;
        t->sigs[i].sig = sp;
        t->sigs[i].siglen = (int)sl;
    }
    if (r.pos != r.len)
        return -1;
    return 0;
}

/* ---------------------------------------------------- signature checking */

static int vset_add(Ctx *c, VSet *vs, const uint8_t *key, int sigidx)
{
    int i;
    for (i = 0; i < vs->n; i++)
        if (vs->pairs[i].sigidx == sigidx &&
            memcmp(vs->pairs[i].key, key, 32) == 0)
            return 0;
    if (vs->n == vs->cap) {
        int cap = vs->cap ? vs->cap * 2 : 32;
        VPair *p = realloc(vs->pairs, cap * sizeof(VPair));
        if (!p) {
            c->pyerr = 1;
            PyErr_NoMemory();
            return -1;
        }
        vs->pairs = p;
        vs->cap = cap;
    }
    memcpy(vs->pairs[vs->n].key, key, 32);
    vs->pairs[vs->n].sigidx = sigidx;
    vs->pairs[vs->n].ok = 0;
    vs->n++;
    return 0;
}

static int vset_ok(const VSet *vs, const uint8_t *key, int sigidx)
{
    int i;
    for (i = 0; i < vs->n; i++)
        if (vs->pairs[i].sigidx == sigidx &&
            memcmp(vs->pairs[i].key, key, 32) == 0)
            return vs->pairs[i].ok;
    return 0;
}

/* record one statically-knowable signer addition (set-options arms) */
static int sadd_push(Ctx *c, const uint8_t *acct, const uint8_t *key)
{
    if (c->nsadds == c->capsadds) {
        int cap = c->capsadds ? c->capsadds * 2 : 16;
        StaticSigner *p = realloc(c->sadds, cap * sizeof(StaticSigner));
        if (!p) {
            c->pyerr = 1;
            PyErr_NoMemory();
            return -1;
        }
        c->sadds = p;
        c->capsadds = cap;
    }
    memcpy(c->sadds[c->nsadds].acct, acct, 32);
    memcpy(c->sadds[c->nsadds].key, key, 32);
    c->nsadds++;
    return 0;
}

/* candidate (key, sig) pairs for one account against one sig list:
   live signer set at PREPASS time ∪ the master key (always — weight
   edits are dynamic but the key itself is fixed) ∪ statically-added
   signer keys. Membership is re-checked live at apply; this only
   decides which pure (key, sig, msg) verifies happen up front. */
static int vset_collect(AEnv *env, VSet *vs, Sig *sigs, int nsigs,
                        const uint8_t *accid)
{
    Ctx *c = env->c;
    Entry *a = get_account(env, accid);
    int i, j;
    if (!a)
        return -1;
    for (i = 0; i < nsigs; i++) {
        /* master key / raw key of a missing account */
        if (memcmp(sigs[i].hint, accid + 28, 4) == 0)
            if (vset_add(c, vs, accid, i) < 0)
                return -1;
        if (a->st.exists)
            for (j = 0; j < a->st.nsigners; j++)
                if (memcmp(sigs[i].hint, a->st.signer_keys[j] + 28,
                           4) == 0)
                    if (vset_add(c, vs, a->st.signer_keys[j], i) < 0)
                        return -1;
        for (j = 0; j < c->nsadds; j++)
            if (memcmp(c->sadds[j].acct, accid, 32) == 0 &&
                memcmp(sigs[i].hint, c->sadds[j].key + 28, 4) == 0)
                if (vset_add(c, vs, c->sadds[j].key, i) < 0)
                    return -1;
    }
    return 0;
}

/* append one vset's (key, sig, msg) tuples to the global verify list */
static int vset_append_batch(Ctx *c, PyObject *lst, VSet *vs, Sig *sigs,
                             const uint8_t *hash)
{
    int i;
    PyObject *msg = NULL;
    for (i = 0; i < vs->n; i++) {
        int si = vs->pairs[i].sigidx;
        if (!sigs[si].sig_obj) {
            sigs[si].sig_obj = PyBytes_FromStringAndSize(
                (const char *)sigs[si].sig, sigs[si].siglen);
            if (!sigs[si].sig_obj)
                goto fail;
        }
        if (!msg) {
            msg = PyBytes_FromStringAndSize((const char *)hash, 32);
            if (!msg)
                goto fail;
        }
        PyObject *key = PyBytes_FromStringAndSize(
            (const char *)vs->pairs[i].key, 32);
        if (!key)
            goto fail;
        PyObject *tup = PyTuple_Pack(3, key, sigs[si].sig_obj, msg);
        Py_DECREF(key);
        if (!tup)
            goto fail;
        int rc = PyList_Append(lst, tup);
        Py_DECREF(tup);
        if (rc < 0)
            goto fail;
    }
    Py_XDECREF(msg);
    return 0;
fail:
    Py_XDECREF(msg);
    c->pyerr = 1;
    return -1;
}

/* read one vset's results back from the global verify result sequence */
static int vset_read_results(Ctx *c, PyObject *seq, Py_ssize_t *pos,
                             VSet *vs)
{
    int i;
    for (i = 0; i < vs->n; i++) {
        if (*pos >= PySequence_Fast_GET_SIZE(seq)) {
            ctx_bail(c, "verify-shape");
            return -1;
        }
        vs->pairs[i].ok =
            PyObject_IsTrue(PySequence_Fast_GET_ITEM(seq, *pos)) == 1;
        (*pos)++;
    }
    return 0;
}

/* SignatureChecker.check_signature over ed25519 signers, against LIVE
   account state. Mirrors the Python loop exactly: signatures in order,
   each consuming the first remaining hint-matched verified signer;
   weights capped at 255; zero thresholds still need one valid signer. */
static int check_sig(Sig *sigs, int nsigs, const VSet *vs, Entry *a,
                     const uint8_t *accid, int level)
{
    const uint8_t *keys[MAX_SIGNERS + 1];
    uint32_t weights[MAX_SIGNERS + 1];
    int n = 0, i, j;
    if (a && a->st.exists) {
        for (i = 0; i < a->st.nsigners; i++) {
            keys[n] = a->st.signer_keys[i];
            weights[n++] = a->st.signer_weights[i];
        }
        if (a->st.thresholds[0] > 0) {
            keys[n] = a->acc_key;
            weights[n++] = a->st.thresholds[0];
        }
    } else {
        keys[n] = accid;
        weights[n++] = 1;
    }
    uint32_t needed =
        (a && a->st.exists) ? a->st.thresholds[1 + level] : 0;
    uint32_t total = 0;
    for (i = 0; i < nsigs; i++) {
        for (j = 0; j < n; j++) {
            if (memcmp(sigs[i].hint, keys[j] + 28, 4) != 0)
                continue;
            if (!vset_ok(vs, keys[j], i))
                continue;
            sigs[i].used = 1;
            total += weights[j] > 255 ? 255 : weights[j];
            if (total >= needed)
                return 1;
            memmove(&keys[j], &keys[j + 1], (n - j - 1) * sizeof(keys[0]));
            memmove(&weights[j], &weights[j + 1],
                    (n - j - 1) * sizeof(weights[0]));
            n--;
            break;
        }
    }
    return 0;
}

/* ------------------------------------------------------- balance helpers */

/* transactions/account_helpers.py add_balance, protocol >= 10 (the
   engine requires >= 10). delta is 128-bit: Python's unbounded ints
   make -INT64_MIN well-defined (range checks reject it). */
static int add_balance(Ctx *c, Entry *e, __int128 delta)
{
    MutState *st = &e->st;
    __int128 newb = (__int128)st->balance + delta;
    if (newb < 0 || newb > INT64_MAXV)
        return 0;
    if (delta < 0) {
        __int128 minb = (__int128)(2 + st->numSub) * c->baseReserve;
        if (newb - minb < st->liab_selling)
            return 0;
    }
    if (newb > (__int128)INT64_MAXV - st->liab_buying)
        return 0;
    st->balance = (int64_t)newb;
    return 1;
}

/* add_trust_balance, protocol >= 10 */
static int add_trust_balance(Entry *e, __int128 delta)
{
    MutState *st = &e->st;
    if (delta == 0)
        return 1;
    if (!(st->flags & TL_AUTH_LEVELS_MASK))
        return 0;
    __int128 newb = (__int128)st->balance + delta;
    if (newb < 0 || newb > st->tl_limit)
        return 0;
    if (newb < st->liab_selling)
        return 0;
    if (newb > (__int128)st->tl_limit - st->liab_buying)
        return 0;
    st->balance = (int64_t)newb;
    return 1;
}

/* add_buying_liabilities (TransactionUtils.cpp:285 role) */
static int add_buying_liab(Entry *e, __int128 delta)
{
    MutState *st = &e->st;
    if (delta == 0)
        return 1;
    __int128 max_liab;
    if (e->type == LET_ACCOUNT)
        max_liab = (__int128)INT64_MAXV - st->balance;
    else {
        if (!(st->flags & TL_AUTH_LEVELS_MASK))
            return 0;
        max_liab = (__int128)st->tl_limit - st->balance;
    }
    __int128 newv = (__int128)st->liab_buying + delta;
    if (newv < 0 || newv > max_liab)
        return 0;
    st->liab_buying = (int64_t)newv;
    st->ext_v = 1; /* _prepare_liabilities promotes the extension */
    return 1;
}

/* add_selling_liabilities */
static int add_selling_liab(Ctx *c, Entry *e, __int128 delta)
{
    MutState *st = &e->st;
    if (delta == 0)
        return 1;
    __int128 max_liab;
    if (e->type == LET_ACCOUNT) {
        max_liab = (__int128)st->balance -
                   (__int128)(2 + st->numSub) * c->baseReserve;
        if (max_liab < 0)
            return 0;
    } else {
        if (!(st->flags & TL_AUTH_LEVELS_MASK))
            return 0;
        max_liab = st->balance;
    }
    __int128 newv = (__int128)st->liab_selling + delta;
    if (newv < 0 || newv > max_liab)
        return 0;
    st->liab_selling = (int64_t)newv;
    st->ext_v = 1;
    return 1;
}

/* account_helpers.py change_subentries: reserve check (incl. selling
   liabilities at v10+) on add; the remove arm cannot fail there */
static int change_subentries(Ctx *c, Entry *e, int delta)
{
    MutState *st = &e->st;
    int64_t nc = (int64_t)st->numSub + delta;
    if (nc < 0 || nc > MAX_SUBENTRIES)
        return 0;
    __int128 effmin = (__int128)(2 + nc) * c->baseReserve;
    effmin += st->liab_selling;
    if (delta > 0 && (__int128)st->balance < effmin)
        return 0;
    st->numSub = (uint32_t)nc;
    return 1;
}

/* max_amount_receive: headroom below the ceiling minus buying liab */
static __int128 max_amount_receive(Entry *e)
{
    const MutState *st = &e->st;
    if (e->type == LET_ACCOUNT)
        return (__int128)INT64_MAXV - st->balance - st->liab_buying;
    if (!(st->flags & TL_AUTH_LEVELS_MASK))
        return 0;
    __int128 out = (__int128)st->tl_limit - st->balance - st->liab_buying;
    return out;
}

/* ---------------------------------------------------------- order books */

/* fetch + index the root's offers for one (selling, buying) pair (the
   Python `book` callback); GIL required. Entries already in the overlay
   keep their live state — dedupe by key. */
static Book *get_book(AEnv *env, const uint8_t *sell, int sell_len,
                      const uint8_t *buy, int buy_len)
{
    Ctx *c = env->c;
    int i;
    for (i = 0; i < c->nbooks; i++)
        if (asset_eq(c->books[i].sell, c->books[i].sell_len, sell,
                     sell_len) &&
            asset_eq(c->books[i].buy, c->books[i].buy_len, buy, buy_len))
            return &c->books[i];
    if (c->nopy) {
        env_bail(env, "prefetch-miss");
        return NULL;
    }
    if (c->nbooks == c->capbooks) {
        int cap = c->capbooks ? c->capbooks * 2 : 8;
        Book *p = realloc(c->books, cap * sizeof(Book));
        if (!p) {
            env->oom = 1;
            return NULL;
        }
        c->books = p;
        c->capbooks = cap;
    }
    Book *bk = &c->books[c->nbooks];
    memset(bk, 0, sizeof(*bk));
    memcpy(bk->sell, sell, sell_len);
    bk->sell_len = sell_len;
    memcpy(bk->buy, buy, buy_len);
    bk->buy_len = buy_len;

    PyObject *sb = PyBytes_FromStringAndSize((const char *)sell, sell_len);
    PyObject *bb = PyBytes_FromStringAndSize((const char *)buy, buy_len);
    PyObject *res = NULL, *seq = NULL;
    if (!sb || !bb)
        goto pyfail;
    res = PyObject_CallFunctionObjArgs(c->book_cb, sb, bb, NULL);
    if (!res)
        goto pyfail;
    seq = PySequence_Fast(res, "book() must return a sequence");
    if (!seq)
        goto pyfail;
    for (Py_ssize_t k = 0; k < PySequence_Fast_GET_SIZE(seq); k++) {
        PyObject *blob = PySequence_Fast_GET_ITEM(seq, k);
        if (!PyBytes_Check(blob)) {
            ctx_bail(c, "lookup-type");
            env->bail = 1;
            goto out;
        }
        /* derive the offer key from the blob: lastModified(4) type(4)
           keytype(4) seller(32) offerID(8) */
        const uint8_t *p = (const uint8_t *)PyBytes_AS_STRING(blob);
        Py_ssize_t bl = PyBytes_GET_SIZE(blob);
        if (bl < 52) {
            ctx_bail(c, "lookup-type");
            env->bail = 1;
            goto out;
        }
        uint8_t keyb[48];
        wr_u32_at(keyb, LET_OFFER);
        wr_u32_at(keyb + 4, 0);
        memcpy(keyb + 8, p + 12, 32);  /* seller */
        memcpy(keyb + 40, p + 44, 8);  /* offerID (big-endian already) */
        uint32_t h;
        Entry *e = find_entry(c, keyb, 48, &h);
        if (!e) {
            e = insert_entry(env, keyb, 48, h);
            if (!e)
                goto out;
            if (entry_adopt_blob(env, e, p, (int)bl) < 0)
                goto out;
        }
        if (elist_push(&bk->offers, e) < 0) {
            env->oom = 1;
            goto out;
        }
    }
    Py_DECREF(seq);
    Py_DECREF(res);
    Py_DECREF(sb);
    Py_DECREF(bb);
    c->nbooks++;
    return bk;
pyfail:
    c->pyerr = 1;
out:
    Py_XDECREF(seq);
    Py_XDECREF(res);
    Py_XDECREF(sb);
    Py_XDECREF(bb);
    free(bk->offers.v);
    return NULL;
}

/* exact fraction compare: a.price < b.price, tie-break by offerID
   (ledgertxn.price_less) */
static int price_less(const Entry *a, const Entry *b)
{
    int64_t lhs = (int64_t)a->st.o_pn * b->st.o_pd;
    int64_t rhs = (int64_t)b->st.o_pn * a->st.o_pd;
    if (lhs != rhs)
        return lhs < rhs;
    return a->offer_id < b->offer_id;
}

/* best (lowest-price) live offer selling `sell` for `buy`, merged view:
   the root book plus overlay-created offers for the pair */
static Entry *best_offer(AEnv *env, const uint8_t *sell, int sell_len,
                         const uint8_t *buy, int buy_len)
{
    Ctx *c = env->c;
    Book *bk = get_book(env, sell, sell_len, buy, buy_len);
    if (!bk)
        return NULL;
    Entry *best = NULL;
    int i;
    for (i = 0; i < bk->offers.n; i++) {
        Entry *e = bk->offers.v[i];
        if (!e->st.exists)
            continue;
        if (!best || price_less(e, best))
            best = e;
    }
    for (i = 0; i < c->created_offers.n; i++) {
        Entry *e = c->created_offers.v[i];
        if (!e->st.exists || e->base)
            continue; /* base offers are already in the book list */
        if (!asset_eq(e->o_sell, e->o_sell_len, sell, sell_len) ||
            !asset_eq(e->o_buy, e->o_buy_len, buy, buy_len))
            continue;
        if (!best || price_less(e, best))
            best = e;
    }
    return best;
}

/* the root's per-seller offer list (the `acct_offers` callback),
   cached per account */
static AcctBook *get_acct_book(AEnv *env, const uint8_t *acct)
{
    Ctx *c = env->c;
    int i;
    for (i = 0; i < c->nabooks; i++)
        if (memcmp(c->abooks[i].acct, acct, 32) == 0)
            return &c->abooks[i];
    if (c->nopy) {
        env_bail(env, "prefetch-miss");
        return NULL;
    }
    if (c->nabooks == c->capabooks) {
        int cap = c->capabooks ? c->capabooks * 2 : 4;
        AcctBook *p = realloc(c->abooks, cap * sizeof(AcctBook));
        if (!p) {
            env->oom = 1;
            return NULL;
        }
        c->abooks = p;
        c->capabooks = cap;
    }
    AcctBook *ab = &c->abooks[c->nabooks];
    memset(ab, 0, sizeof(*ab));
    memcpy(ab->acct, acct, 32);
    PyObject *ao = PyBytes_FromStringAndSize((const char *)acct, 32);
    PyObject *res = NULL, *seq = NULL;
    if (!ao)
        goto pyfail;
    res = PyObject_CallFunctionObjArgs(c->acct_cb, ao, NULL);
    if (!res)
        goto pyfail;
    seq = PySequence_Fast(res, "acct_offers() must return a sequence");
    if (!seq)
        goto pyfail;
    for (Py_ssize_t k = 0; k < PySequence_Fast_GET_SIZE(seq); k++) {
        PyObject *blob = PySequence_Fast_GET_ITEM(seq, k);
        if (!PyBytes_Check(blob) || PyBytes_GET_SIZE(blob) < 52) {
            ctx_bail(c, "lookup-type");
            env->bail = 1;
            goto out;
        }
        const uint8_t *p = (const uint8_t *)PyBytes_AS_STRING(blob);
        Py_ssize_t bl = PyBytes_GET_SIZE(blob);
        uint8_t keyb[48];
        wr_u32_at(keyb, LET_OFFER);
        wr_u32_at(keyb + 4, 0);
        memcpy(keyb + 8, p + 12, 32);
        memcpy(keyb + 40, p + 44, 8);
        uint32_t h;
        Entry *e = find_entry(c, keyb, 48, &h);
        if (!e) {
            e = insert_entry(env, keyb, 48, h);
            if (!e)
                goto out;
            if (entry_adopt_blob(env, e, p, (int)bl) < 0)
                goto out;
        }
        if (elist_push(&ab->offers, e) < 0) {
            env->oom = 1;
            goto out;
        }
    }
    Py_DECREF(seq);
    Py_DECREF(res);
    Py_DECREF(ao);
    c->nabooks++;
    return ab;
pyfail:
    c->pyerr = 1;
out:
    Py_XDECREF(seq);
    Py_XDECREF(res);
    Py_XDECREF(ao);
    free(ab->offers.v);
    return NULL;
}

/* -------------------------------------------------- offer exchange math */

typedef struct {
    __int128 wheat, sheep;
} Exch;

static __int128 i128min(__int128 a, __int128 b) { return a < b ? a : b; }

static __int128 ceil_div128(__int128 a, __int128 b)
{
    /* Python -(-a // b) with b > 0 */
    if (a >= 0)
        return (a + b - 1) / b;
    return -((-a) / b);
}

static __int128 floor_div128(__int128 a, __int128 b)
{
    /* Python floor division, b > 0 */
    if (a >= 0)
        return a / b;
    return -ceil_div128(-a, b);
}

/* offer_exchange.exchange: exact crossing amounts */
static Exch exchange(__int128 offer_amount, int32_t n, int32_t d,
                     __int128 max_wheat_receive, __int128 max_sheep_send)
{
    Exch out = {0, 0};
    __int128 wheat = i128min(offer_amount, max_wheat_receive);
    if (wheat <= 0 || max_sheep_send <= 0)
        return out;
    __int128 sheep = ceil_div128(wheat * n, d);
    if (sheep > max_sheep_send) {
        wheat = floor_div128(max_sheep_send * d, n);
        wheat = i128min(wheat, i128min(offer_amount, max_wheat_receive));
        sheep = ceil_div128(wheat * n, d);
    }
    if (wheat <= 0 || sheep <= 0 || sheep > max_sheep_send)
        return out;
    out.wheat = wheat;
    out.sheep = sheep;
    return out;
}

/* offer_exchange.adjust_offer */
static __int128 adjust_offer(int32_t n, int32_t d, __int128 max_sell,
                             __int128 max_receive)
{
    if (max_sell <= 0 || max_receive <= 0)
        return 0;
    __int128 wheat_value = i128min(max_sell * n, max_receive * d);
    __int128 wheat, sheep;
    if (n > d) {
        wheat = floor_div128(wheat_value, n);
        sheep = floor_div128(wheat * n, d);
    } else {
        sheep = floor_div128(wheat_value, d);
        wheat = ceil_div128(sheep * d, n);
    }
    if (wheat <= 0 || sheep <= 0)
        return 0;
    __int128 err = 100 * (__int128)n * wheat - 100 * (__int128)d * sheep;
    if (err < 0)
        err = -err;
    if (err > (__int128)n * wheat)
        return 0;
    return wheat;
}

/* offer_liabilities: (buying, selling) a resting offer encumbers */
static void offer_liabilities(int32_t n, int32_t d, __int128 amount,
                              __int128 *buying, __int128 *selling)
{
    Exch e = exchange(amount, n, d, INT64_MAXV, INT64_MAXV);
    *buying = e.sheep;
    *selling = e.wheat;
}

/* canSellAtMost: available balance net of reserve/limit and SELLING
   liabilities. Loads via the overlay without recording. */
static __int128 available_to_sell(AEnv *env, const uint8_t *acct,
                                  const uint8_t *asset, int assetlen,
                                  int *err)
{
    Ctx *c = env->c;
    if (asset_is_native(asset, assetlen)) {
        Entry *a = get_account(env, acct);
        if (!a) {
            *err = 1;
            return 0;
        }
        if (!a->st.exists)
            return 0;
        __int128 avail = (__int128)a->st.balance -
                         (__int128)(2 + a->st.numSub) * c->baseReserve -
                         a->st.liab_selling;
        return avail > 0 ? avail : 0;
    }
    if (memcmp(acct, asset_issuer(asset, assetlen), 32) == 0)
        return INT64_MAXV;
    Entry *tl = get_trustline(env, acct, asset, assetlen);
    if (!tl) {
        *err = 1;
        return 0;
    }
    if (!tl->st.exists || !(tl->st.flags & TL_AUTH_LEVELS_MASK))
        return 0;
    __int128 avail = (__int128)tl->st.balance - tl->st.liab_selling;
    return avail > 0 ? avail : 0;
}

/* canBuyAtMost: headroom net of BUYING liabilities */
static __int128 available_to_receive(AEnv *env, const uint8_t *acct,
                                     const uint8_t *asset, int assetlen,
                                     int *err)
{
    if (asset_is_native(asset, assetlen)) {
        Entry *a = get_account(env, acct);
        if (!a) {
            *err = 1;
            return 0;
        }
        if (!a->st.exists)
            return 0;
        __int128 out = (__int128)INT64_MAXV - a->st.balance -
                       a->st.liab_buying;
        return out > 0 ? out : 0;
    }
    if (memcmp(acct, asset_issuer(asset, assetlen), 32) == 0)
        return INT64_MAXV;
    Entry *tl = get_trustline(env, acct, asset, assetlen);
    if (!tl) {
        *err = 1;
        return 0;
    }
    if (!tl->st.exists || !(tl->st.flags & TL_AUTH_LEVELS_MASK))
        return 0;
    __int128 out = (__int128)tl->st.tl_limit - tl->st.balance -
                   tl->st.liab_buying;
    return out > 0 ? out : 0;
}

/* _credit: returns 0 on failure, -1 on engine error, 1 ok */
static int xfer_credit(AEnv *env, const uint8_t *acct, const uint8_t *asset,
                       int assetlen, __int128 amount, int lv)
{
    Ctx *c = env->c;
    if (amount == 0)
        return 1;
    if (asset_is_native(asset, assetlen)) {
        Entry *a = get_account(env, acct);
        if (!a)
            return -1;
        if (!a->st.exists)
            return 0;
        if (touch(env, a, lv) < 0)
            return -1;
        return add_balance(c, a, amount);
    }
    if (memcmp(acct, asset_issuer(asset, assetlen), 32) == 0)
        return 1; /* issuer receiving its own asset burns it */
    Entry *tl = get_trustline(env, acct, asset, assetlen);
    if (!tl)
        return -1;
    if (!tl->st.exists)
        return 0;
    if (touch(env, tl, lv) < 0)
        return -1;
    return add_trust_balance(tl, amount);
}

static int xfer_debit(AEnv *env, const uint8_t *acct, const uint8_t *asset,
                      int assetlen, __int128 amount, int lv)
{
    return xfer_credit(env, acct, asset, assetlen,
                       amount == 0 ? 0 : -amount, lv);
}

/* acquireOrReleaseLiabilities over one offer's owner (sign = ±1).
   `amount`/`pn`/`pd` describe the offer being (re)encumbered. */
static int apply_offer_liab(AEnv *env, Entry *offer, __int128 amount,
                            int sign, int lv, int *err)
{
    __int128 buying, selling;
    offer_liabilities(offer->st.o_pn, offer->st.o_pd, amount, &buying,
                      &selling);
    const uint8_t *seller = offer->acc_key;
    int ok = 1;
    if (asset_is_native(offer->o_buy, offer->o_buy_len)) {
        Entry *a = get_account(env, seller);
        if (!a) {
            *err = 1;
            return 0;
        }
        if (!a->st.exists)
            ok = 0;
        else {
            if (touch(env, a, lv) < 0) {
                *err = 1;
                return 0;
            }
            ok = add_buying_liab(a, sign * buying);
        }
    } else if (memcmp(seller, asset_issuer(offer->o_buy, offer->o_buy_len),
                      32) != 0) {
        Entry *tl = get_trustline(env, seller, offer->o_buy,
                                  offer->o_buy_len);
        if (!tl) {
            *err = 1;
            return 0;
        }
        if (!tl->st.exists)
            ok = 0;
        else {
            if (touch(env, tl, lv) < 0) {
                *err = 1;
                return 0;
            }
            ok = add_buying_liab(tl, sign * buying);
        }
    }
    if (!ok)
        return 0;
    if (asset_is_native(offer->o_sell, offer->o_sell_len)) {
        Entry *a = get_account(env, seller);
        if (!a) {
            *err = 1;
            return 0;
        }
        if (!a->st.exists)
            ok = 0;
        else {
            if (touch(env, a, lv) < 0) {
                *err = 1;
                return 0;
            }
            ok = add_selling_liab(env->c, a, sign * selling);
        }
    } else if (memcmp(seller,
                      asset_issuer(offer->o_sell, offer->o_sell_len),
                      32) != 0) {
        Entry *tl = get_trustline(env, seller, offer->o_sell,
                                  offer->o_sell_len);
        if (!tl) {
            *err = 1;
            return 0;
        }
        if (!tl->st.exists)
            ok = 0;
        else {
            if (touch(env, tl, lv) < 0) {
                *err = 1;
                return 0;
            }
            ok = add_selling_liab(env->c, tl, sign * selling);
        }
    }
    return ok;
}

/* _erase_offer: erase + give back the seller's subentry */
static int erase_offer(AEnv *env, Entry *offer, int lv)
{
    if (touch(env, offer, lv) < 0)
        return -1;
    offer->st.exists = 0;
    Entry *acc = get_account(env, offer->acc_key);
    if (!acc)
        return -1;
    if (acc->st.exists) {
        if (touch(env, acc, lv) < 0)
            return -1;
        change_subentries(env->c, acc, -1);
    }
    return 0;
}

/* ------------------------------------------------------- cross_offers */

#define CROSS_SUCCESS 0
#define CROSS_PARTIAL 1
#define CROSS_SELF 2
#define CROSS_BAD_PRICE 3
#define CROSS_ERR (-1)

/* one ClaimOfferAtom appended to `claims` (pre-serialized) */
static int claim_append(Buf *claims, int *nclaims, const uint8_t *seller,
                        int64_t offer_id, const uint8_t *sold_asset,
                        int sold_len, __int128 sold,
                        const uint8_t *bought_asset, int bought_len,
                        __int128 bought)
{
    if (buf_u32(claims, 0) < 0 || buf_put(claims, seller, 32) < 0 ||
        buf_i64(claims, offer_id) < 0 ||
        buf_put(claims, sold_asset, sold_len) < 0 ||
        buf_i64(claims, (int64_t)sold) < 0 ||
        buf_put(claims, bought_asset, bought_len) < 0 ||
        buf_i64(claims, (int64_t)bought) < 0)
        return -1;
    (*nclaims)++;
    return 0;
}

/* offer_exchange.cross_offers: cross the (selling=buy_asset,
   buying=sell_asset) book until the taker has bought max_buy, spent
   max_sell, hit the price limit, or emptied the book. Offer owners'
   balances adjust in place; the taker's do NOT. Claims are serialized
   ClaimOfferAtom bytes appended to `claims` (count in *nclaims). */
static int cross_offers(AEnv *env, const uint8_t *taker,
                        const uint8_t *sell_asset, int sell_len,
                        const uint8_t *buy_asset, int buy_len,
                        __int128 max_buy, __int128 max_sell,
                        int has_limit, int32_t ln, int32_t ld,
                        int passive_taker, __int128 *bought_out,
                        __int128 *sold_out, Buf *claims, int *nclaims,
                        int lv)
{
    Ctx *c = env->c;
    __int128 bought = 0, sold = 0;
    int err = 0;
    while (bought < max_buy && sold < max_sell) {
        Entry *best = best_offer(env, buy_asset, buy_len, sell_asset,
                                 sell_len);
        if (env->bail || env->oom || c->pyerr)
            return CROSS_ERR;
        if (!best) {
            *bought_out = bought;
            *sold_out = sold;
            return CROSS_PARTIAL;
        }
        int32_t n = best->st.o_pn, d = best->st.o_pd;
        if (has_limit) {
            int64_t lhs = (int64_t)n * ln;
            int64_t rhs = (int64_t)d * ld;
            if (lhs > rhs || (lhs == rhs &&
                              (passive_taker ||
                               (best->st.flags & OFFER_PASSIVE_FLAG)))) {
                *bought_out = bought;
                *sold_out = sold;
                return CROSS_BAD_PRICE;
            }
        }
        if (memcmp(best->acc_key, taker, 32) == 0) {
            *bought_out = bought;
            *sold_out = sold;
            return CROSS_SELF;
        }
        const uint8_t *owner = best->acc_key;
        int64_t pre_amount = best->st.o_amount; /* Python reads the
            parent-copy's amount after mutating the live one */
        /* release the resting offer's liabilities up front */
        int ok = apply_offer_liab(env, best, pre_amount, -1, lv, &err);
        if (err)
            return CROSS_ERR;
        if (!ok) {
            env_bail(env, "liab-release"); /* Python asserts here */
            return CROSS_ERR;
        }
        __int128 wheat_cap =
            i128min(pre_amount, available_to_sell(env, owner, buy_asset,
                                                  buy_len, &err));
        if (err)
            return CROSS_ERR;
        __int128 recv_cap = available_to_receive(env, owner, sell_asset,
                                                 sell_len, &err);
        if (err)
            return CROSS_ERR;
        if (recv_cap < INT64_MAXV)
            wheat_cap = i128min(wheat_cap, floor_div128(recv_cap * d, n));
        if (wheat_cap <= 0) {
            /* unfunded/unreceivable offer: garbage-collect it */
            if (erase_offer(env, best, lv) < 0)
                return CROSS_ERR;
            continue;
        }
        Exch ex = exchange(wheat_cap, n, d, max_buy - bought,
                           max_sell - sold);
        if (ex.wheat == 0) {
            /* taker exhausted; restore the resting offer's liabilities */
            ok = apply_offer_liab(env, best, pre_amount, +1, lv, &err);
            if (err)
                return CROSS_ERR;
            if (!ok) {
                env_bail(env, "liab-reacquire");
                return CROSS_ERR;
            }
            *bought_out = bought;
            *sold_out = sold;
            return CROSS_SUCCESS;
        }
        /* settle the owner's side */
        int ok1 = xfer_debit(env, owner, buy_asset, buy_len, ex.wheat, lv);
        int ok2 = xfer_credit(env, owner, sell_asset, sell_len, ex.sheep,
                              lv);
        if (ok1 < 0 || ok2 < 0)
            return CROSS_ERR;
        if (!ok1 || !ok2) {
            env_bail(env, "owner-settle"); /* Python asserts */
            return CROSS_ERR;
        }
        if (touch(env, best, lv) < 0)
            return CROSS_ERR;
        best->st.o_amount -= (int64_t)ex.wheat;
        if (best->st.o_amount <= 0 ||
            (ex.wheat == wheat_cap && ex.wheat < pre_amount)) {
            if (erase_offer(env, best, lv) < 0)
                return CROSS_ERR;
        } else {
            /* clamp the residual to what the owner can still back,
               then re-encumber (v10+ — the engine requires v10) */
            __int128 can_sell = available_to_sell(env, owner, buy_asset,
                                                  buy_len, &err);
            if (err)
                return CROSS_ERR;
            __int128 can_recv = available_to_receive(env, owner,
                                                     sell_asset, sell_len,
                                                     &err);
            if (err)
                return CROSS_ERR;
            __int128 adj = adjust_offer(
                n, d, i128min(best->st.o_amount, can_sell), can_recv);
            best->st.o_amount = (int64_t)adj;
            if (best->st.o_amount <= 0) {
                if (erase_offer(env, best, lv) < 0)
                    return CROSS_ERR;
            } else {
                ok = apply_offer_liab(env, best, best->st.o_amount, +1,
                                      lv, &err);
                if (err)
                    return CROSS_ERR;
                if (!ok) {
                    env_bail(env, "liab-reacquire");
                    return CROSS_ERR;
                }
            }
        }
        bought += ex.wheat;
        sold += ex.sheep;
        if (claim_append(claims, nclaims, owner, best->offer_id,
                         buy_asset, buy_len, ex.wheat, sell_asset,
                         sell_len, ex.sheep) < 0) {
            env->oom = 1;
            return CROSS_ERR;
        }
    }
    *bought_out = bought;
    *sold_out = sold;
    return CROSS_SUCCESS;
}

/* ------------------------------------------------------------ op applies */

static int apply_create_account(AEnv *env, Op *op, const uint8_t *src_id,
                                OpRes *res)
{
    Ctx *c = env->c;
    res->code = opINNER;
    res->optype = OP_CREATE_ACCOUNT;
    Entry *dest = get_account(env, op->dest); /* load_without_record */
    if (!dest)
        return -1;
    if (dest->st.exists) {
        res->inner_code = CA_ALREADY_EXIST;
        return 0;
    }
    if ((__int128)op->amount < (__int128)2 * c->baseReserve) {
        res->inner_code = CA_LOW_RESERVE;
        return 0;
    }
    Entry *src = get_account(env, src_id);
    if (!src)
        return -1;
    if (touch(env, src, 3) < 0)
        return -1;
    if (!add_balance(c, src, -(__int128)op->amount)) {
        res->inner_code = CA_UNDERFUNDED;
        return 0;
    }
    if (touch(env, dest, 3) < 0)
        return -1;
    MutState *st = &dest->st;
    memset(st, 0, sizeof(*st));
    st->exists = 1;
    dest->type = LET_ACCOUNT;
    memcpy(dest->acc_key, op->dest, 32);
    st->balance = op->amount;
    st->seqNum = (int64_t)((uint64_t)c->ledgerSeq << 32);
    st->thresholds[0] = 1;
    st->lm = c->ledgerSeq;
    res->inner_code = CA_SUCCESS;
    return 0;
}

static int apply_payment(AEnv *env, Op *op, const uint8_t *src_id,
                         OpRes *res)
{
    res->code = opINNER;
    res->optype = OP_PAYMENT;
    Entry *dest_acc = get_account(env, op->dest);
    if (!dest_acc)
        return -1;
    if (touch(env, dest_acc, 3) < 0) /* ltx.load records before check */
        return -1;
    if (!dest_acc->st.exists) {
        res->inner_code = PAY_NO_DESTINATION;
        return 0;
    }
    if (op->asset_native) {
        Entry *src = get_account(env, src_id);
        if (!src)
            return -1;
        if (touch(env, src, 3) < 0)
            return -1;
        if (memcmp(src_id, op->dest, 32) != 0) {
            if (!add_balance(env->c, src, -(__int128)op->amount)) {
                res->inner_code = PAY_UNDERFUNDED;
                return 0;
            }
            if (!add_balance(env->c, dest_acc, op->amount)) {
                res->inner_code = PAY_LINE_FULL;
                return 0;
            }
        }
        res->inner_code = PAY_SUCCESS;
        return 0;
    }
    /* credit asset: source side */
    if (memcmp(src_id, op->issuer, 32) != 0) {
        Entry *stl = get_trustline(env, src_id, op->asset, op->assetlen);
        if (!stl)
            return -1;
        if (!stl->st.exists) {
            res->inner_code = PAY_SRC_NO_TRUST;
            return 0;
        }
        if (touch(env, stl, 3) < 0)
            return -1;
        if (!(stl->st.flags & TL_AUTHORIZED)) {
            res->inner_code = PAY_SRC_NOT_AUTHORIZED;
            return 0;
        }
        if (!add_trust_balance(stl, -(__int128)op->amount)) {
            res->inner_code = PAY_UNDERFUNDED;
            return 0;
        }
    } else {
        Entry *iss = get_account(env, op->issuer);
        if (!iss)
            return -1;
        if (!iss->st.exists) {
            res->inner_code = PAY_NO_ISSUER;
            return 0;
        }
        if (touch(env, iss, 3) < 0)
            return -1;
    }
    /* destination side */
    if (memcmp(op->dest, op->issuer, 32) != 0) {
        Entry *dtl = get_trustline(env, op->dest, op->asset, op->assetlen);
        if (!dtl)
            return -1;
        if (!dtl->st.exists) {
            res->inner_code = PAY_NO_TRUST;
            return 0;
        }
        if (touch(env, dtl, 3) < 0)
            return -1;
        if (!(dtl->st.flags & TL_AUTHORIZED)) {
            res->inner_code = PAY_NOT_AUTHORIZED;
            return 0;
        }
        if (!add_trust_balance(dtl, op->amount)) {
            res->inner_code = PAY_LINE_FULL;
            return 0;
        }
    }
    res->inner_code = PAY_SUCCESS;
    return 0;
}

static int apply_set_options(AEnv *env, Op *op, const uint8_t *src_id,
                             OpRes *res)
{
    res->code = opINNER;
    res->optype = OP_SET_OPTIONS;
    Entry *src = get_account(env, src_id); /* exists checked by caller */
    if (!src)
        return -1;
    if (touch(env, src, 3) < 0)
        return -1;
    MutState *st = &src->st;
    if (op->so_has_infl) {
        Entry *d = get_account(env, op->so_infl); /* load_without_record */
        if (!d)
            return -1;
        if (!d->st.exists) {
            res->inner_code = SO_INVALID_INFLATION;
            return 0;
        }
        st->has_infl = 1;
        memcpy(st->infl, op->so_infl, 32);
    }
    if (op->so_has_clear) {
        if (st->flags & AUTH_IMMUTABLE_FLAG) {
            res->inner_code = SO_CANT_CHANGE;
            return 0;
        }
        st->flags &= ~op->so_clear;
    }
    if (op->so_has_set) {
        if (st->flags & AUTH_IMMUTABLE_FLAG) {
            res->inner_code = SO_CANT_CHANGE;
            return 0;
        }
        st->flags |= op->so_set;
    }
    if (op->so_has_mw)
        st->thresholds[0] = (uint8_t)op->so_mw;
    if (op->so_has_lt)
        st->thresholds[1] = (uint8_t)op->so_lt;
    if (op->so_has_mt)
        st->thresholds[2] = (uint8_t)op->so_mt;
    if (op->so_has_ht)
        st->thresholds[3] = (uint8_t)op->so_ht;
    if (op->so_has_home) {
        st->home_len = op->so_home_len;
        if (op->so_home_len)
            memcpy(st->home, op->so_home, op->so_home_len);
    }
    if (op->so_has_signer) {
        int idx = -1, i;
        for (i = 0; i < st->nsigners; i++)
            if (memcmp(st->signer_keys[i], op->so_signer_key, 32) == 0) {
                idx = i;
                break;
            }
        if (op->so_signer_w == 0) {
            if (idx >= 0) {
                memmove(st->signer_keys[idx], st->signer_keys[idx + 1],
                        (st->nsigners - idx - 1) * 32);
                memmove(&st->signer_weights[idx],
                        &st->signer_weights[idx + 1],
                        (st->nsigners - idx - 1) * sizeof(uint32_t));
                st->nsigners--;
                change_subentries(env->c, src, -1); /* rc ignored */
            }
        } else if (idx >= 0) {
            st->signer_weights[idx] = op->so_signer_w;
        } else {
            if (st->nsigners >= MAX_SIGNERS) {
                res->inner_code = SO_TOO_MANY_SIGNERS;
                return 0;
            }
            if (!change_subentries(env->c, src, +1)) {
                res->inner_code = SO_LOW_RESERVE;
                return 0;
            }
            memcpy(st->signer_keys[st->nsigners], op->so_signer_key, 32);
            st->signer_weights[st->nsigners] = op->so_signer_w;
            st->nsigners++;
        }
        /* Python re-sorts the WHOLE list after every signer arm (by
           key.to_xdr(); all keys share the ed25519 type prefix, so raw
           key bytes compare identically). Stable insertion sort. */
        for (i = 1; i < st->nsigners; i++) {
            uint8_t k[32];
            uint32_t w = st->signer_weights[i];
            int j = i;
            memcpy(k, st->signer_keys[i], 32);
            while (j > 0 && memcmp(k, st->signer_keys[j - 1], 32) < 0) {
                memcpy(st->signer_keys[j], st->signer_keys[j - 1], 32);
                st->signer_weights[j] = st->signer_weights[j - 1];
                j--;
            }
            memcpy(st->signer_keys[j], k, 32);
            st->signer_weights[j] = w;
        }
    }
    res->inner_code = SO_SUCCESS;
    return 0;
}

static int apply_change_trust(AEnv *env, Op *op, const uint8_t *src_id,
                              OpRes *res)
{
    Ctx *c = env->c;
    res->code = opINNER;
    res->optype = OP_CHANGE_TRUST;
    if (memcmp(src_id, op->issuer, 32) == 0) {
        res->inner_code = CT_SELF_NOT_ALLOWED;
        return 0;
    }
    Entry *tl = get_trustline(env, src_id, op->asset, op->assetlen);
    if (!tl)
        return -1;
    if (tl->st.exists) {
        if (touch(env, tl, 3) < 0) /* ltx.load records */
            return -1;
        /* limit floor: balance + buying liabilities (v10+) */
        if ((__int128)op->ct_limit <
            (__int128)tl->st.balance + tl->st.liab_buying) {
            res->inner_code = CT_INVALID_LIMIT;
            return 0;
        }
        if (op->ct_limit == 0) {
            tl->st.exists = 0; /* erase */
            Entry *src = get_account(env, src_id);
            if (!src)
                return -1;
            if (touch(env, src, 3) < 0)
                return -1;
            change_subentries(c, src, -1); /* rc ignored, like Python */
            res->inner_code = CT_SUCCESS;
            return 0;
        }
        Entry *iss = get_account(env, op->issuer); /* without_record */
        if (!iss)
            return -1;
        if (!iss->st.exists) {
            res->inner_code = CT_NO_ISSUER;
            return 0;
        }
        tl->st.tl_limit = op->ct_limit;
        res->inner_code = CT_SUCCESS;
        return 0;
    }
    if (op->ct_limit == 0) {
        res->inner_code = CT_INVALID_LIMIT;
        return 0;
    }
    Entry *iss = get_account(env, op->issuer); /* load_without_record */
    if (!iss)
        return -1;
    if (!iss->st.exists) {
        res->inner_code = CT_NO_ISSUER;
        return 0;
    }
    Entry *src = get_account(env, src_id);
    if (!src)
        return -1;
    if (touch(env, src, 3) < 0)
        return -1;
    if (!change_subentries(c, src, +1)) {
        res->inner_code = CT_LOW_RESERVE;
        return 0;
    }
    if (touch(env, tl, 3) < 0)
        return -1;
    MutState *st = &tl->st;
    memset(st, 0, sizeof(*st));
    st->exists = 1;
    st->tl_limit = op->ct_limit;
    st->flags = (iss->st.flags & AUTH_REQUIRED_FLAG) ? 0 : TL_AUTHORIZED;
    st->lm = c->ledgerSeq;
    res->inner_code = CT_SUCCESS;
    return 0;
}

static int apply_bump_sequence(AEnv *env, Op *op, const uint8_t *src_id,
                               OpRes *res)
{
    res->code = opINNER;
    res->optype = OP_BUMP_SEQUENCE;
    Entry *src = get_account(env, src_id);
    if (!src)
        return -1;
    if (touch(env, src, 3) < 0)
        return -1;
    if (op->bs_to > src->st.seqNum)
        src->st.seqNum = op->bs_to;
    res->inner_code = BS_SUCCESS;
    return 0;
}

static int apply_manage_data(AEnv *env, Op *op, const uint8_t *src_id,
                             OpRes *res)
{
    Ctx *c = env->c;
    res->code = opINNER;
    res->optype = OP_MANAGE_DATA;
    Entry *d = get_data(env, src_id, op->md_name, op->md_name_len);
    if (!d)
        return -1;
    if (d->st.exists && touch(env, d, 3) < 0) /* ltx.load records */
        return -1;
    if (!op->md_has_val) {
        if (!d->st.exists) {
            res->inner_code = MD_NAME_NOT_FOUND;
            return 0;
        }
        d->st.exists = 0;
        Entry *src = get_account(env, src_id);
        if (!src)
            return -1;
        if (touch(env, src, 3) < 0)
            return -1;
        change_subentries(c, src, -1);
        res->inner_code = MD_SUCCESS;
        return 0;
    }
    if (d->st.exists) {
        d->st.d_len = op->md_val_len;
        if (op->md_val_len)
            memcpy(d->st.d_val, op->md_val, op->md_val_len);
        res->inner_code = MD_SUCCESS;
        return 0;
    }
    Entry *src = get_account(env, src_id);
    if (!src)
        return -1;
    if (touch(env, src, 3) < 0)
        return -1;
    if (!change_subentries(c, src, +1)) {
        res->inner_code = MD_LOW_RESERVE;
        return 0;
    }
    if (touch(env, d, 3) < 0)
        return -1;
    MutState *st = &d->st;
    memset(st, 0, sizeof(*st));
    st->exists = 1;
    st->d_len = op->md_val_len;
    if (op->md_val_len)
        memcpy(st->d_val, op->md_val, op->md_val_len);
    st->lm = c->ledgerSeq;
    res->inner_code = MD_SUCCESS;
    return 0;
}

static int apply_account_merge(AEnv *env, Op *op, const uint8_t *src_id,
                               OpRes *res)
{
    Ctx *c = env->c;
    res->code = opINNER;
    res->optype = OP_ACCOUNT_MERGE;
    Entry *dest = get_account(env, op->dest);
    if (!dest)
        return -1;
    if (dest->st.exists && touch(env, dest, 3) < 0)
        return -1;
    if (!dest->st.exists) {
        res->inner_code = AM_NO_ACCOUNT;
        return 0;
    }
    Entry *src = get_account(env, src_id);
    if (!src)
        return -1;
    if (touch(env, src, 3) < 0)
        return -1;
    if (src->st.flags & AUTH_IMMUTABLE_FLAG) {
        res->inner_code = AM_IMMUTABLE_SET;
        return 0;
    }
    /* only OWNED subentries (trustlines/offers/data) block a merge */
    if (src->st.numSub != (uint32_t)src->st.nsigners) {
        res->inner_code = AM_HAS_SUB_ENTRIES;
        return 0;
    }
    if (src->st.seqNum >= (int64_t)((uint64_t)c->ledgerSeq << 32)) {
        res->inner_code = AM_SEQNUM_TOO_FAR;
        return 0;
    }
    int64_t balance = src->st.balance;
    if (!add_balance(c, dest, balance)) {
        res->inner_code = AM_DEST_FULL;
        return 0;
    }
    src->st.exists = 0;
    res->inner_code = AM_SUCCESS;
    res->has_payload = 1;
    if (buf_i64(&res->payload, balance) < 0) {
        env->oom = 1;
        return -1;
    }
    return 0;
}

static int apply_inflation(AEnv *env, OpRes *res)
{
    Ctx *c = env->c;
    res->code = opINNER;
    res->optype = OP_INFLATION;
    /* caller gated version < 12 */
    if ((int64_t)c->closeTime <
        ((int64_t)c->inflationSeq + 1) * INFLATION_FREQUENCY) {
        res->inner_code = INF_NOT_TIME;
        return 0;
    }
    /* a due payout needs the balance-weighted vote query over ALL
       accounts (merged with the open txn chain) plus strkey-ordered
       tie-breaks — the Python path stays the oracle for this */
    env_bail(env, "inflation-payout");
    return -1;
}

/* AllowTrustOpFrame.do_apply (+ _remove_offers on a full revoke) */
static int apply_allow_trust(AEnv *env, Op *op, const uint8_t *src_id,
                             OpRes *res)
{
    Ctx *c = env->c;
    res->code = opINNER;
    res->optype = OP_ALLOW_TRUST;
    if (memcmp(op->at_trustor, src_id, 32) == 0) {
        res->inner_code = AT_SELF_NOT_ALLOWED;
        return 0;
    }
    Entry *issuer = get_account(env, src_id); /* load_account records */
    if (!issuer)
        return -1;
    if (touch(env, issuer, 3) < 0)
        return -1;
    if (!(issuer->st.flags & AUTH_REQUIRED_FLAG)) {
        res->inner_code = AT_TRUST_NOT_REQUIRED;
        return 0;
    }
    int not_revocable = !(issuer->st.flags & AUTH_REVOCABLE_FLAG);
    if (not_revocable && op->at_auth == 0) {
        res->inner_code = AT_CANT_REVOKE;
        return 0;
    }
    /* the derived asset's issuer is the op source */
    uint8_t asset[MAX_ASSET];
    int assetlen = op->at_assetlen;
    memcpy(asset, op->at_asset, assetlen);
    memcpy(asset + assetlen - 32, src_id, 32);
    Entry *tl = get_trustline(env, op->at_trustor, asset, assetlen);
    if (!tl)
        return -1;
    if (!tl->st.exists) {
        res->inner_code = AT_NO_TRUST_LINE;
        return 0;
    }
    if (touch(env, tl, 3) < 0)
        return -1;
    int fully = !!(tl->st.flags & TL_AUTHORIZED);
    int maintain_or_more = !!(tl->st.flags & TL_AUTH_LEVELS_MASK);
    if (not_revocable && fully && (op->at_auth & TL_MAINTAIN)) {
        res->inner_code = AT_CANT_REVOKE;
        return 0;
    }
    if (maintain_or_more && op->at_auth == 0) {
        /* _remove_offers: pull the trustor's offers in this asset and
           release their liabilities. Python loads the whole filtered
           list first (each load records), then processes per offer. */
        AcctBook *ab = get_acct_book(env, op->at_trustor);
        if (!ab)
            return -1;
        EList matched = {NULL, 0, 0};
        int i;
        for (i = 0; i < ab->offers.n; i++) {
            Entry *e = ab->offers.v[i];
            if (!e->st.exists)
                continue;
            if (!asset_eq(e->o_sell, e->o_sell_len, asset, assetlen) &&
                !asset_eq(e->o_buy, e->o_buy_len, asset, assetlen))
                continue;
            if (elist_push(&matched, e) < 0) {
                env->oom = 1;
                free(matched.v);
                return -1;
            }
        }
        for (i = 0; i < c->created_offers.n; i++) {
            Entry *e = c->created_offers.v[i];
            if (!e->st.exists || e->base)
                continue;
            if (memcmp(e->acc_key, op->at_trustor, 32) != 0)
                continue;
            if (!asset_eq(e->o_sell, e->o_sell_len, asset, assetlen) &&
                !asset_eq(e->o_buy, e->o_buy_len, asset, assetlen))
                continue;
            if (elist_push(&matched, e) < 0) {
                env->oom = 1;
                free(matched.v);
                return -1;
            }
        }
        for (i = 0; i < matched.n; i++) /* the load() pass records */
            if (touch(env, matched.v[i], 3) < 0) {
                free(matched.v);
                return -1;
            }
        for (i = 0; i < matched.n; i++) {
            Entry *e = matched.v[i];
            int lerr = 0;
            int ok = apply_offer_liab(env, e, e->st.o_amount, -1, 3,
                                      &lerr);
            if (lerr || !ok) {
                if (!lerr)
                    env_bail(env, "liab-release");
                free(matched.v);
                return -1;
            }
            Entry *acct = get_account(env, op->at_trustor);
            if (!acct) {
                free(matched.v);
                return -1;
            }
            if (touch(env, acct, 3) < 0) {
                free(matched.v);
                return -1;
            }
            change_subentries(c, acct, -1);
            e->st.exists = 0; /* erase */
        }
        free(matched.v);
    }
    tl->st.flags = op->at_auth;
    res->inner_code = AT_SUCCESS;
    return 0;
}

/* serialize one OfferEntry BODY (the manage-offer result arm) */
static int ser_offer_body(Buf *b, const uint8_t *seller, int64_t oid,
                          const uint8_t *sell, int sell_len,
                          const uint8_t *buy, int buy_len, int64_t amount,
                          int32_t pn, int32_t pd, uint32_t flags)
{
    if (buf_u32(b, 0) < 0 || buf_put(b, seller, 32) < 0 ||
        buf_i64(b, oid) < 0 || buf_put(b, sell, sell_len) < 0 ||
        buf_put(b, buy, buy_len) < 0 || buf_i64(b, amount) < 0 ||
        buf_i32(b, pn) < 0 || buf_i32(b, pd) < 0 ||
        buf_u32(b, flags) < 0 || buf_u32(b, 0) < 0 /* ext */)
        return -1;
    return 0;
}

/* assemble a ManageOfferSuccessResult payload:
   claims array + offer union arm */
static int mo_success_payload(OpRes *res, const Buf *claims, int nclaims,
                              int arm /* 0 created / 1 updated / 2 del */,
                              const Buf *offer_body)
{
    res->has_payload = 1;
    if (buf_u32(&res->payload, (uint32_t)nclaims) < 0 ||
        buf_put(&res->payload, claims->data, claims->len) < 0 ||
        buf_u32(&res->payload, (uint32_t)arm) < 0)
        return -1;
    if (arm != 2 &&
        buf_put(&res->payload, offer_body->data, offer_body->len) < 0)
        return -1;
    return 0;
}

/* _ManageOfferBase.do_apply for all three offer op flavors */
static int apply_manage_offer(AEnv *env, Op *op, const uint8_t *src_id,
                              OpRes *res)
{
    Ctx *c = env->c;
    res->code = opINNER;
    res->optype = op->optype;
    Buf claims = {NULL, 0, 0, &env->ar};
    Buf offer_body = {NULL, 0, 0, &env->ar};
    int nclaims = 0;
    int rc = -1;
    int err = 0;

    int is_delete = op->o_is_buy
                        ? (op->o_buy_amount == 0 && op->o_offer_id != 0)
                        : (op->o_amount == 0 && op->o_offer_id != 0);
    if (!is_delete) {
        /* checkOfferValid: FULL authorization on both lines; issuer
           existence checks only pre-13 */
        const uint8_t *legs[2] = {op->o_sell, op->o_buy};
        const int lens[2] = {op->o_sell_len, op->o_buy_len};
        const int no_issuer[2] = {MO_SELL_NO_ISSUER, MO_BUY_NO_ISSUER};
        const int no_trust[2] = {MO_SELL_NO_TRUST, MO_BUY_NO_TRUST};
        const int not_auth[2] = {MO_SELL_NOT_AUTHORIZED,
                                 MO_BUY_NOT_AUTHORIZED};
        for (int leg = 0; leg < 2; leg++) {
            if (asset_is_native(legs[leg], lens[leg]))
                continue;
            if (memcmp(src_id, asset_issuer(legs[leg], lens[leg]), 32) ==
                0)
                continue;
            if (c->ledgerVersion < 13) {
                Entry *iss = get_account(
                    env, asset_issuer(legs[leg], lens[leg]));
                if (!iss)
                    goto out;
                if (!iss->st.exists) {
                    res->inner_code = no_issuer[leg];
                    rc = 0;
                    goto out;
                }
            }
            Entry *tl = get_trustline(env, src_id, legs[leg], lens[leg]);
            if (!tl)
                goto out;
            if (!tl->st.exists) {
                res->inner_code = no_trust[leg];
                rc = 0;
                goto out;
            }
            if (!(tl->st.flags & TL_AUTHORIZED)) {
                res->inner_code = not_auth[leg];
                rc = 0;
                goto out;
            }
        }
    }

    uint32_t existing_flags = 0;
    int is_update = 0;
    if (op->o_offer_id != 0) {
        uint8_t keyb[48];
        offer_key(keyb, src_id, op->o_offer_id);
        Entry *e = get_entry(env, keyb, 48);
        if (!e)
            goto out;
        if (!e->st.exists) {
            res->inner_code = MO_NOT_FOUND;
            rc = 0;
            goto out;
        }
        if (touch(env, e, 3) < 0)
            goto out;
        int ok = apply_offer_liab(env, e, e->st.o_amount, -1, 3, &err);
        if (err)
            goto out;
        if (!ok) {
            env_bail(env, "liab-release");
            goto out;
        }
        existing_flags = e->st.flags;
        e->st.exists = 0; /* pulled from the book; subentry kept */
        is_update = 1;
    }

    if (is_delete) {
        Entry *src = get_account(env, src_id);
        if (!src)
            goto out;
        if (touch(env, src, 3) < 0)
            goto out;
        change_subentries(c, src, -1);
        res->inner_code = MO_SUCCESS;
        if (mo_success_payload(res, &claims, 0, 2, NULL) < 0) {
            env->oom = 1;
            goto out;
        }
        rc = 0;
        goto out;
    }

    if (!is_update) {
        Entry *src = get_account(env, src_id);
        if (!src)
            goto out;
        if (touch(env, src, 3) < 0)
            goto out;
        if (!change_subentries(c, src, +1)) {
            res->inner_code = MO_LOW_RESERVE;
            rc = 0;
            goto out;
        }
    }
    __int128 buy_liab, sell_liab;
    offer_liabilities(op->o_pn, op->o_pd, op->o_amount, &buy_liab,
                      &sell_liab);
    __int128 max_sell_funds =
        available_to_sell(env, src_id, op->o_sell, op->o_sell_len, &err);
    if (err)
        goto out;
    __int128 recv_cap = available_to_receive(env, src_id, op->o_buy,
                                             op->o_buy_len, &err);
    if (err)
        goto out;
    if (recv_cap < buy_liab || recv_cap <= 0) {
        res->inner_code = MO_LINE_FULL;
        rc = 0;
        goto out;
    }
    if (max_sell_funds < sell_liab ||
        (max_sell_funds <= 0 && op->o_amount > 0)) {
        res->inner_code = MO_UNDERFUNDED;
        rc = 0;
        goto out;
    }
    __int128 wheat_cap =
        op->o_is_buy
            ? (op->o_buy_amount > 0 ? (__int128)op->o_buy_amount
                                    : (__int128)INT64_MAXV)
            : (__int128)INT64_MAXV;
    __int128 max_sell = op->o_is_buy
                            ? max_sell_funds
                            : i128min(op->o_amount, max_sell_funds);
    __int128 bought = 0, sold = 0;
    int code = cross_offers(env, src_id, op->o_sell, op->o_sell_len,
                            op->o_buy, op->o_buy_len,
                            i128min(recv_cap, wheat_cap), max_sell, 1,
                            op->o_pn, op->o_pd, op->o_passive, &bought,
                            &sold, &claims, &nclaims, 3);
    if (code == CROSS_ERR)
        goto out;
    if (code == CROSS_SELF) {
        res->inner_code = MO_CROSS_SELF;
        rc = 0;
        goto out;
    }
    /* settle taker net amounts (Python asserts both) */
    int ok1 = xfer_debit(env, src_id, op->o_sell, op->o_sell_len, sold, 3);
    int ok2 =
        xfer_credit(env, src_id, op->o_buy, op->o_buy_len, bought, 3);
    if (ok1 < 0 || ok2 < 0)
        goto out;
    if (!ok1 || !ok2) {
        env_bail(env, "taker-settle");
        goto out;
    }
    __int128 sheep_resid =
        op->o_is_buy ? (__int128)INT64_MAXV : (op->o_amount - sold);
    __int128 can_sell =
        available_to_sell(env, src_id, op->o_sell, op->o_sell_len, &err);
    if (err)
        goto out;
    __int128 can_recv = available_to_receive(env, src_id, op->o_buy,
                                             op->o_buy_len, &err);
    if (err)
        goto out;
    __int128 remaining =
        adjust_offer(op->o_pn, op->o_pd, i128min(sheep_resid, can_sell),
                     i128min(can_recv, wheat_cap - bought));
    int arm;
    if (remaining > 0) {
        int64_t new_id;
        if (is_update)
            new_id = op->o_offer_id;
        else {
            c->idPool += 1;
            new_id = c->idPool;
        }
        uint32_t flags =
            (op->o_passive || (existing_flags & OFFER_PASSIVE_FLAG))
                ? OFFER_PASSIVE_FLAG
                : 0;
        uint8_t keyb[48];
        offer_key(keyb, src_id, new_id);
        Entry *e = get_entry(env, keyb, 48);
        if (!e)
            goto out;
        if (touch(env, e, 3) < 0)
            goto out;
        MutState *st = &e->st;
        memset(st, 0, sizeof(*st));
        st->exists = 1;
        e->type = LET_OFFER;
        memcpy(e->acc_key, src_id, 32);
        e->offer_id = new_id;
        memcpy(e->o_sell, op->o_sell, op->o_sell_len);
        e->o_sell_len = op->o_sell_len;
        memcpy(e->o_buy, op->o_buy, op->o_buy_len);
        e->o_buy_len = op->o_buy_len;
        st->o_amount = (int64_t)remaining;
        st->o_pn = op->o_pn;
        st->o_pd = op->o_pd;
        st->flags = flags;
        st->lm = c->ledgerSeq;
        if (!e->base && !e->in_created) {
            if (elist_push(&c->created_offers, e) < 0) {
                env->oom = 1;
                goto out;
            }
            e->in_created = 1;
        }
        int ok = apply_offer_liab(env, e, st->o_amount, +1, 3, &err);
        if (err)
            goto out;
        if (!ok) {
            env_bail(env, "liab-acquire");
            goto out;
        }
        arm = is_update ? 1 : 0;
        if (ser_offer_body(&offer_body, src_id, new_id, op->o_sell,
                           op->o_sell_len, op->o_buy, op->o_buy_len,
                           st->o_amount, st->o_pn, st->o_pd, flags) < 0) {
            env->oom = 1;
            goto out;
        }
    } else {
        Entry *src = get_account(env, src_id);
        if (!src)
            goto out;
        if (touch(env, src, 3) < 0)
            goto out;
        change_subentries(c, src, -1);
        arm = 2;
    }
    res->inner_code = MO_SUCCESS;
    if (mo_success_payload(res, &claims, nclaims, arm, &offer_body) < 0) {
        env->oom = 1;
        goto out;
    }
    rc = 0;
out:
    buf_free(&claims);
    buf_free(&offer_body);
    return rc;
}

/* _PathPaymentBase credit/debit capability codes (0 = ok) */
static int pp_dest_credit_code(AEnv *env, const uint8_t *dest,
                               const uint8_t *asset, int assetlen,
                               __int128 amount, int *err)
{
    if (asset_is_native(asset, assetlen)) {
        if (available_to_receive(env, dest, asset, assetlen, err) < amount)
            return *err ? 0 : PP_LINE_FULL;
        return 0;
    }
    if (memcmp(dest, asset_issuer(asset, assetlen), 32) == 0)
        return 0;
    Entry *iss = get_account(env, asset_issuer(asset, assetlen));
    if (!iss) {
        *err = 1;
        return 0;
    }
    if (!iss->st.exists)
        return PP_NO_ISSUER;
    Entry *tl = get_trustline(env, dest, asset, assetlen);
    if (!tl) {
        *err = 1;
        return 0;
    }
    if (!tl->st.exists)
        return PP_NO_TRUST;
    if (!(tl->st.flags & TL_AUTHORIZED))
        return PP_NOT_AUTHORIZED;
    if (available_to_receive(env, dest, asset, assetlen, err) < amount)
        return *err ? 0 : PP_LINE_FULL;
    return 0;
}

static int pp_src_debit_code(AEnv *env, const uint8_t *src,
                             const uint8_t *asset, int assetlen,
                             __int128 amount, int *err)
{
    if (asset_is_native(asset, assetlen)) {
        if (available_to_sell(env, src, asset, assetlen, err) < amount)
            return *err ? 0 : PP_UNDERFUNDED;
        return 0;
    }
    if (memcmp(src, asset_issuer(asset, assetlen), 32) == 0)
        return 0;
    Entry *iss = get_account(env, asset_issuer(asset, assetlen));
    if (!iss) {
        *err = 1;
        return 0;
    }
    if (!iss->st.exists)
        return PP_NO_ISSUER;
    Entry *tl = get_trustline(env, src, asset, assetlen);
    if (!tl) {
        *err = 1;
        return 0;
    }
    if (!tl->st.exists)
        return PP_SRC_NO_TRUST;
    if (!(tl->st.flags & TL_AUTHORIZED))
        return PP_SRC_NOT_AUTHORIZED;
    if (available_to_sell(env, src, asset, assetlen, err) < amount)
        return *err ? 0 : PP_UNDERFUNDED;
    return 0;
}

/* PathPaymentSuccess payload: claims + SimplePaymentResult */
static int pp_success_payload(OpRes *res, const Buf *claims, int nclaims,
                              const uint8_t *dest, const uint8_t *asset,
                              int assetlen, __int128 amount)
{
    res->has_payload = 1;
    if (buf_u32(&res->payload, (uint32_t)nclaims) < 0 ||
        buf_put(&res->payload, claims->data, claims->len) < 0 ||
        buf_u32(&res->payload, 0) < 0 ||
        buf_put(&res->payload, dest, 32) < 0 ||
        buf_put(&res->payload, asset, assetlen) < 0 ||
        buf_i64(&res->payload, (int64_t)amount) < 0)
        return -1;
    return 0;
}

static int apply_path_payment(AEnv *env, Op *op, const uint8_t *src_id,
                              OpRes *res)
{
    res->code = opINNER;
    res->optype = op->optype;
    int strict_send = (op->optype == OP_PATH_PAYMENT_SEND);
    int err = 0, rc = -1, i;
    /* the asset chain: send + path + dest */
    const uint8_t *chain[2 + MAX_PATH];
    int chain_len[2 + MAX_PATH];
    int nchain = 0;
    chain[nchain] = op->pp_send;
    chain_len[nchain++] = op->pp_send_len;
    for (i = 0; i < op->pp_npath; i++) {
        chain[nchain] = op->pp_path[i];
        chain_len[nchain++] = op->pp_path_len[i];
    }
    chain[nchain] = op->pp_dest;
    chain_len[nchain++] = op->pp_dest_len;

    Buf hop_claims[1 + MAX_PATH];
    int hop_n[1 + MAX_PATH];
    int nhops = 0;
    memset(hop_claims, 0, sizeof(hop_claims));
    memset(hop_n, 0, sizeof(hop_n));
    for (i = 0; i < 1 + MAX_PATH; i++)
        hop_claims[i].ar = &env->ar;

    Entry *dest = get_account(env, op->dest);
    if (!dest)
        goto out;
    if (dest->st.exists && touch(env, dest, 3) < 0)
        goto out;
    if (!dest->st.exists) {
        res->inner_code = PP_NO_DESTINATION;
        rc = 0;
        goto out;
    }

    if (!strict_send) {
        /* strict receive: check the destination leg up front */
        int code = pp_dest_credit_code(env, op->dest, op->pp_dest,
                                       op->pp_dest_len, op->pp_amount,
                                       &err);
        if (err)
            goto out;
        if (code) {
            res->inner_code = code;
            rc = 0;
            goto out;
        }
        __int128 needed = op->pp_amount;
        /* walk backwards: acquire `needed` of chain[i+1] with chain[i] */
        for (i = nchain - 2; i >= 0; i--) {
            if (asset_eq(chain[i], chain_len[i], chain[i + 1],
                         chain_len[i + 1]))
                continue;
            __int128 bought = 0, sold = 0;
            Buf *cb = &hop_claims[nhops];
            int cr = cross_offers(env, src_id, chain[i], chain_len[i],
                                  chain[i + 1], chain_len[i + 1], needed,
                                  INT64_MAXV, 0, 0, 0, 0, &bought, &sold,
                                  cb, &hop_n[nhops], 3);
            nhops++;
            if (cr == CROSS_ERR)
                goto out;
            if (cr == CROSS_SELF) {
                res->inner_code = PP_OFFER_CROSS_SELF;
                rc = 0;
                goto out;
            }
            if (bought < needed) {
                res->inner_code = PP_TOO_FEW_OFFERS;
                rc = 0;
                goto out;
            }
            needed = sold;
        }
        if (needed > op->pp_limit) {
            res->inner_code = PP_OVER_LIMIT; /* OVER_SENDMAX */
            rc = 0;
            goto out;
        }
        int dcode = pp_src_debit_code(env, src_id, op->pp_send,
                                      op->pp_send_len, needed, &err);
        if (err)
            goto out;
        if (dcode) {
            res->inner_code = dcode;
            rc = 0;
            goto out;
        }
        int ok1 = xfer_debit(env, src_id, op->pp_send, op->pp_send_len,
                             needed, 3);
        int ok2 = xfer_credit(env, op->dest, op->pp_dest, op->pp_dest_len,
                              op->pp_amount, 3);
        if (ok1 < 0 || ok2 < 0)
            goto out;
        if (!ok1 || !ok2) {
            env_bail(env, "pp-settle");
            goto out;
        }
        res->inner_code = PP_SUCCESS;
        /* claims: hops were gathered backwards; the result wants the
           chain order (claims prepend per hop) */
        Buf all = {NULL, 0, 0, &env->ar};
        int total = 0;
        for (i = nhops - 1; i >= 0; i--) {
            if (buf_put(&all, hop_claims[i].data, hop_claims[i].len) < 0) {
                buf_free(&all);
                env->oom = 1;
                goto out;
            }
            total += hop_n[i];
        }
        int prc = pp_success_payload(res, &all, total, op->dest,
                                     op->pp_dest, op->pp_dest_len,
                                     op->pp_amount);
        buf_free(&all);
        if (prc < 0) {
            env->oom = 1;
            goto out;
        }
        rc = 0;
        goto out;
    }

    /* strict send */
    {
        int code = pp_src_debit_code(env, src_id, op->pp_send,
                                     op->pp_send_len, op->pp_amount, &err);
        if (err)
            goto out;
        if (code) {
            res->inner_code = code;
            rc = 0;
            goto out;
        }
        int okd = xfer_debit(env, src_id, op->pp_send, op->pp_send_len,
                             op->pp_amount, 3);
        if (okd < 0)
            goto out;
        if (!okd) {
            env_bail(env, "pp-settle");
            goto out;
        }
        __int128 have = op->pp_amount;
        for (i = 0; i < nchain - 1; i++) {
            if (asset_eq(chain[i], chain_len[i], chain[i + 1],
                         chain_len[i + 1]))
                continue;
            __int128 bought = 0, sold = 0;
            Buf *cb = &hop_claims[nhops];
            int cr = cross_offers(env, src_id, chain[i], chain_len[i],
                                  chain[i + 1], chain_len[i + 1],
                                  INT64_MAXV, have, 0, 0, 0, 0, &bought,
                                  &sold, cb, &hop_n[nhops], 3);
            nhops++;
            if (cr == CROSS_ERR)
                goto out;
            if (cr == CROSS_SELF) {
                res->inner_code = PP_OFFER_CROSS_SELF;
                rc = 0;
                goto out;
            }
            if (bought == 0 || sold < have) {
                res->inner_code = PP_TOO_FEW_OFFERS;
                rc = 0;
                goto out;
            }
            have = bought;
        }
        if (have < op->pp_limit) {
            res->inner_code = PP_OVER_LIMIT; /* UNDER_DESTMIN */
            rc = 0;
            goto out;
        }
        int ccode = pp_dest_credit_code(env, op->dest, op->pp_dest,
                                        op->pp_dest_len, have, &err);
        if (err)
            goto out;
        if (ccode) {
            res->inner_code = ccode;
            rc = 0;
            goto out;
        }
        int okc = xfer_credit(env, op->dest, op->pp_dest, op->pp_dest_len,
                              have, 3);
        if (okc < 0)
            goto out;
        if (!okc) {
            env_bail(env, "pp-settle");
            goto out;
        }
        res->inner_code = PP_SUCCESS;
        Buf all = {NULL, 0, 0, &env->ar};
        int total = 0;
        for (i = 0; i < nhops; i++) {
            if (buf_put(&all, hop_claims[i].data, hop_claims[i].len) < 0) {
                buf_free(&all);
                env->oom = 1;
                goto out;
            }
            total += hop_n[i];
        }
        int prc = pp_success_payload(res, &all, total, op->dest,
                                     op->pp_dest, op->pp_dest_len, have);
        buf_free(&all);
        if (prc < 0) {
            env->oom = 1;
            goto out;
        }
        rc = 0;
    }
out:
    for (i = 0; i < 1 + MAX_PATH; i++)
        buf_free(&hop_claims[i]);
    return rc;
}

/* ------------------------------------------------------- op dispatching */

/* OperationFrame.is_version_supported */
static int op_version_supported(Ctx *c, int optype)
{
    switch (optype) {
    case OP_INFLATION:
        return c->ledgerVersion < 12;
    case OP_BUMP_SEQUENCE:
        return c->ledgerVersion >= 10;
    case OP_MANAGE_BUY_OFFER:
        return c->ledgerVersion >= 11;
    case OP_PATH_PAYMENT_SEND:
        return c->ledgerVersion >= 12;
    default:
        return 1;
    }
}

/* threshold level for processSignatures (reference per-frame
   getThresholdLevel) */
static int op_threshold_level(const Op *op)
{
    switch (op->optype) {
    case OP_ALLOW_TRUST:
    case OP_INFLATION:
    case OP_BUMP_SEQUENCE:
        return 0; /* LOW */
    case OP_ACCOUNT_MERGE:
        return 2; /* HIGH */
    case OP_SET_OPTIONS:
        if (op->so_has_mw || op->so_has_lt || op->so_has_mt ||
            op->so_has_ht || op->so_has_signer)
            return 2;
        return 1;
    default:
        return 1; /* MEDIUM */
    }
}

/* OperationFrame.apply: version gate, op-source existence, do_apply */
static int apply_one_op(AEnv *env, Op *op, const uint8_t *osrc,
                        OpRes *res)
{
    if (!op_version_supported(env->c, op->optype)) {
        res->code = opNOT_SUPPORTED;
        return 0;
    }
    Entry *oa = get_account(env, osrc); /* load_without_record */
    if (!oa)
        return -1;
    if (!oa->st.exists) {
        res->code = opNO_ACCOUNT;
        return 0;
    }
    switch (op->optype) {
    case OP_CREATE_ACCOUNT:
        return apply_create_account(env, op, osrc, res);
    case OP_PAYMENT:
        return apply_payment(env, op, osrc, res);
    case OP_PATH_PAYMENT_RECV:
    case OP_PATH_PAYMENT_SEND:
        return apply_path_payment(env, op, osrc, res);
    case OP_MANAGE_SELL_OFFER:
    case OP_CREATE_PASSIVE_OFFER:
    case OP_MANAGE_BUY_OFFER:
        return apply_manage_offer(env, op, osrc, res);
    case OP_SET_OPTIONS:
        return apply_set_options(env, op, osrc, res);
    case OP_CHANGE_TRUST:
        return apply_change_trust(env, op, osrc, res);
    case OP_ALLOW_TRUST:
        return apply_allow_trust(env, op, osrc, res);
    case OP_ACCOUNT_MERGE:
        return apply_account_merge(env, op, osrc, res);
    case OP_INFLATION:
        return apply_inflation(env, res);
    case OP_MANAGE_DATA:
        return apply_manage_data(env, op, osrc, res);
    case OP_BUMP_SEQUENCE:
        return apply_bump_sequence(env, op, osrc, res);
    default:
        env_bail(env, "op-dispatch");
        return -1;
    }
}

/* --------------------------------------------------------- tx apply */

/* the v1 apply phase for one tx (fees already charged). Mirrors
   TransactionFrame.apply exactly; stores every output (result code,
   op results, changes blobs) as plain C data for later emission.
   `fee_for_result` is the feeCharged every emitted result carries
   (the fee-phase value, or 0 for a fee bump's inner tx). */
static int apply_tx_v1(AEnv *env, Tx *t, int64_t fee_for_result)
{
    Ctx *c = env->c;
    int code = txSUCCESS;
    Entry *src = NULL;
    int i;
    (void)fee_for_result;

    t->txch.ar = &env->ar;
    for (i = 0; i < t->nsigs; i++)
        t->sigs[i].used = 0;

    /* _common_valid (applying), reference order */
    if (t->has_tb && t->minTime && c->closeTime < t->minTime)
        code = txTOO_EARLY;
    else if (t->has_tb && t->maxTime && c->closeTime > t->maxTime)
        code = txTOO_LATE;
    else if (t->nops == 0)
        code = txMISSING_OPERATION;
    else {
        __int128 minfee = (__int128)c->baseFee *
                          (t->nops > 1 ? t->nops : 1);
        if ((__int128)t->fee_bid < minfee)
            code = txINSUFFICIENT_FEE;
    }
    if (code == txSUCCESS) {
        src = get_account(env, t->src);
        if (!src)
            return -1;
        if (!src->st.exists)
            code = txNO_ACCOUNT;
        else {
            if (touch(env, src, 1) < 0) /* load_account records */
                return -1;
            if (src->st.seqNum == INT64_MAXV ||
                t->seqNum != src->st.seqNum + 1)
                code = txBAD_SEQ;
            else if (!check_sig(t->sigs, t->nsigs, &t->vs, src, t->src,
                                0 /* LOW */))
                code = txBAD_AUTH;
        }
    }

    int pre_seq = (code == txTOO_EARLY || code == txTOO_LATE ||
                   code == txMISSING_OPERATION ||
                   code == txINSUFFICIENT_FEE || code == txNO_ACCOUNT ||
                   code == txBAD_SEQ);
    if (!pre_seq) {
        if (src->st.seqNum > t->seqNum) {
            /* Python raises -> txINTERNAL_ERROR, tx txn rolled back */
            rollback_level(env, 1);
            t->out_have = 1;
            t->out_code = txINTERNAL_ERROR;
            t->out_empty_txch = 1;
            t->out_meta_ops = 0;
            t->out_res_ops = 0;
            return 0;
        }
        if (touch(env, src, 1) < 0)
            return -1;
        src->st.seqNum = t->seqNum;
    }

    int sigs_ok = 1;
    if (code == txSUCCESS) {
        /* processSignatures: every op's source at its threshold level.
           Any op-level failure leaves sibling result slots unset in the
           Python frame (unserializable mix) — bail to the oracle. */
        for (i = 0; i < t->nops; i++) {
            Op *o = &t->ops[i];
            const uint8_t *osrc = o->has_src ? o->src : t->src;
            Entry *oa = get_account(env, osrc);
            if (!oa)
                return -1;
            if (!check_sig(t->sigs, t->nsigs, &t->vs,
                           oa->st.exists ? oa : NULL, osrc,
                           op_threshold_level(o))) {
                env_bail(env, "op-auth");
                return -1;
            }
        }
        /* _remove_one_time_signer: no pre-auth signers on this path */
        for (i = 0; i < t->nsigs; i++)
            if (!t->sigs[i].used) {
                sigs_ok = 0;
                break;
            }
    }

    if (delta_changes_buf(env, 1, &t->txch) < 0)
        return -1;
    if (commit_level(env, 1) < 0)
        return -1;

    if (code != txSUCCESS || !sigs_ok) {
        t->out_have = 1;
        t->out_code = (code != txSUCCESS) ? code : txBAD_AUTH_EXTRA;
        t->out_meta_ops = 0;
        t->out_res_ops = 0;
        return 0;
    }

    /* ops phase: every op applies in its own nested txn; any failure
       rolls the whole ops txn back (fees/seq already committed) */
    t->opres = arena_alloc(&env->ar, t->nops * sizeof(OpRes));
    t->opch = arena_alloc(&env->ar, t->nops * sizeof(Buf));
    if (!t->opres || !t->opch) {
        env->oom = 1;
        return -1;
    }
    memset(t->opres, 0, t->nops * sizeof(OpRes));
    memset(t->opch, 0, t->nops * sizeof(Buf));
    t->opres_in_arena = 1;
    for (i = 0; i < t->nops; i++) {
        t->opch[i].ar = &env->ar;
        t->opres[i].payload.ar = &env->ar;
    }
    int ok = 1;
    /* header.idPool is transactional in Python (each nested LedgerTxn
       copies the header): a failed op/ops-phase must roll back any ids
       its offers consumed */
    int64_t tx_idpool = c->idPool;
    for (i = 0; i < t->nops; i++) {
        Op *op = &t->ops[i];
        const uint8_t *osrc = op->has_src ? op->src : t->src;
        int64_t t_op = now_ticks();
        int64_t op_idpool = c->idPool;
        int rc = apply_one_op(env, op, osrc, &t->opres[i]);
        if (rc < 0)
            return -1;
        int op_ok =
            (t->opres[i].code == opINNER && t->opres[i].inner_code == 0);
        if (op_ok) {
            if (delta_changes_buf(env, 3, &t->opch[i]) < 0)
                return -1;
            if (commit_level(env, 3) < 0)
                return -1;
        } else {
            rollback_level(env, 3);
            c->idPool = op_idpool;
            ok = 0;
        }
        if (op->optype >= 0 && op->optype < MAX_OPTYPES) {
            env->op_cnt[op->optype]++;
            env->op_ns[op->optype] += now_ticks() - t_op; /* ticks:
                converted to ns once per close (see apply_close) */
        }
    }
    if (ok) {
        if (commit_level(env, 2) < 0 || commit_level(env, 1) < 0)
            return -1;
    } else {
        rollback_level(env, 2);
        c->idPool = tx_idpool;
    }
    t->out_have = 1;
    t->out_code = ok ? txSUCCESS : txFAILED;
    t->out_ok = ok;
    t->out_meta_ops = t->nops;
    t->out_res_ops = t->nops;
    return 0;
}

/* FeeBumpTransactionFrame.apply: outer commonValid (reads only,
   rolled back), then the inner tx applies as a plain v1 tx whose
   results carry feeCharged 0; the wrapper is built at emission. */
static int emit_result(Tx *t, Buf *b);
static int emit_meta(Tx *t, Buf *b);

/* pre-emit the tx's result/meta XDR on the applying thread */
static int tx_preemit(AEnv *env, Tx *t)
{
    t->out_rb.ar = &env->ar;
    t->out_mb.ar = &env->ar;
    if (emit_result(t, &t->out_rb) < 0 || emit_meta(t, &t->out_mb) < 0) {
        env->oom = 1;
        return -1;
    }
    return 0;
}

static int apply_tx(AEnv *env, Tx *t)
{
    if (!t->is_fee_bump) {
        if (apply_tx_v1(env, t, t->feeCharged) < 0)
            return -1;
        return tx_preemit(env, t);
    }

    Ctx *c = env->c;
    int i;
    for (i = 0; i < t->nsigs; i++)
        t->sigs[i].used = 0;
    int code = txSUCCESS;
    if (c->ledgerVersion < 13)
        code = txNOT_SUPPORTED; /* fee bumps are CAP-0015 / protocol 13 */
    else {
        __int128 minfee = (__int128)c->baseFee * (t->inner->nops + 1);
        if ((__int128)t->fee_bid < minfee ||
            t->fee_bid < t->inner->fee_bid)
            code = txINSUFFICIENT_FEE;
    }
    if (code == txSUCCESS) {
        Entry *src = get_account(env, t->src);
        if (!src)
            return -1;
        if (!src->st.exists)
            code = txNO_ACCOUNT;
        else if (!check_sig(t->sigs, t->nsigs, &t->vs, src, t->src,
                            0 /* LOW */))
            code = txBAD_AUTH;
        else {
            for (i = 0; i < t->nsigs; i++)
                if (!t->sigs[i].used) {
                    code = txBAD_AUTH_EXTRA;
                    break;
                }
        }
    }
    if (code != txSUCCESS) {
        /* outer failure: no inner apply, no state mutated, empty meta */
        t->out_have = 1;
        t->out_code = code;
        t->out_empty_txch = 1;
        t->out_meta_ops = 0;
        t->out_res_ops = 0;
        return tx_preemit(env, t);
    }
    if (apply_tx_v1(env, t->inner, 0) < 0)
        return -1;
    t->out_have = 1;
    t->out_code = (t->inner->out_code == txSUCCESS)
                      ? txFEE_BUMP_INNER_SUCCESS
                      : txFEE_BUMP_INNER_FAILED;
    return tx_preemit(env, t);
}

/* ------------------------------------------------------------ fee phase */

/* processFeeSeqNum for every tx in apply order (v10+: fees only; the
   sequence number is consumed during apply). Emits the per-tx
   fee-changes blob (the txfeehistory row). */
static int fee_phase(AEnv *env, Tx **txs, int ntx, Buf *fee_bufs)
{
    Ctx *c = env->c;
    int ti;
    for (ti = 0; ti < ntx; ti++) {
        Tx *t = txs[ti];
        int nops_for_fee =
            t->is_fee_bump ? t->inner->nops + 1
                           : (t->nops > 1 ? t->nops : 1);
        __int128 fee128 = (__int128)c->effBase * nops_for_fee;
        int64_t fee = fee128 > (__int128)t->fee_bid ? t->fee_bid
                                                    : (int64_t)fee128;
        Entry *src = get_account(env, t->src);
        if (!src)
            return -1;
        if (!src->st.exists) {
            env_bail(env, "fee-source-missing"); /* Python asserts */
            return -1;
        }
        if (touch(env, src, 1) < 0)
            return -1;
        int64_t cap = src->st.balance > 0 ? src->st.balance : 0;
        if (fee > cap)
            fee = cap;
        src->st.balance -= fee;
        c->feePool += fee;
        t->feeCharged = fee;
        fee_bufs[ti].ar = &env->ar;
        if (delta_changes_buf(env, 1, &fee_bufs[ti]) < 0)
            return -1;
        if (commit_level(env, 1) < 0)
            return -1;
    }
    return 0;
}

/* ----------------------------------------------- static keys / prefetch */

/* load every statically-knowable entry one tx can touch (apply +
   signature phases), so a GIL-free apply never needs the lookup
   callback. Returns -1 on engine error only; dynamic ops contribute
   their statically-known keys too (cheap cache warm). */
static int prefetch_tx_v1(AEnv *env, Tx *t)
{
    int i;
    if (!get_account(env, t->src))
        return -1;
    for (i = 0; i < t->nops; i++) {
        Op *op = &t->ops[i];
        const uint8_t *osrc = op->has_src ? op->src : t->src;
        if (!get_account(env, osrc))
            return -1;
        switch (op->optype) {
        case OP_CREATE_ACCOUNT:
            if (!get_account(env, op->dest))
                return -1;
            break;
        case OP_PAYMENT:
            if (!get_account(env, op->dest))
                return -1;
            if (!op->asset_native) {
                /* the issuer account is only ever read when it IS the
                   op source or destination (apply_payment's issuer
                   arms) — both already enumerated; a blanket issuer
                   key would chain every same-asset payment into one
                   conflict cluster for no reason */
                if (memcmp(osrc, op->issuer, 32) != 0 &&
                    !get_trustline(env, osrc, op->asset, op->assetlen))
                    return -1;
                if (memcmp(op->dest, op->issuer, 32) != 0 &&
                    !get_trustline(env, op->dest, op->asset,
                                   op->assetlen))
                    return -1;
            }
            break;
        case OP_SET_OPTIONS:
            if (op->so_has_infl && !get_account(env, op->so_infl))
                return -1;
            break;
        case OP_CHANGE_TRUST:
            if (!get_account(env, op->issuer) ||
                !get_trustline(env, osrc, op->asset, op->assetlen))
                return -1;
            break;
        case OP_ALLOW_TRUST: {
            uint8_t asset[MAX_ASSET];
            memcpy(asset, op->at_asset, op->at_assetlen);
            memcpy(asset + op->at_assetlen - 32, osrc, 32);
            if (!get_trustline(env, op->at_trustor, asset,
                               op->at_assetlen))
                return -1;
            break;
        }
        case OP_ACCOUNT_MERGE:
            if (!get_account(env, op->dest))
                return -1;
            break;
        case OP_MANAGE_DATA:
            if (!get_data(env, osrc, op->md_name, op->md_name_len))
                return -1;
            break;
        case OP_PATH_PAYMENT_RECV:
        case OP_PATH_PAYMENT_SEND:
            if (op_version_supported(env->c, op->optype) &&
                !get_account(env, op->dest))
                return -1;
            break;
        default:
            break;
        }
    }
    return 0;
}

static int prefetch_tx(AEnv *env, Tx *t)
{
    if (!get_account(env, t->src)) /* fee source / tx source */
        return -1;
    if (t->is_fee_bump)
        return prefetch_tx_v1(env, t->inner);
    return prefetch_tx_v1(env, t);
}

/* gather the statically-knowable signer additions across the txset */
static int collect_static_adds_v1(Ctx *c, Tx *t)
{
    int i;
    for (i = 0; i < t->nops; i++) {
        Op *op = &t->ops[i];
        if (op->optype == OP_SET_OPTIONS && op->so_has_signer) {
            const uint8_t *osrc = op->has_src ? op->src : t->src;
            if (sadd_push(c, osrc, op->so_signer_key) < 0)
                return -1;
        }
    }
    return 0;
}

/* candidate collection for one tx (and its inner, for fee bumps) */
static int collect_tx_candidates(AEnv *env, Tx *t)
{
    int i;
    if (vset_collect(env, &t->vs, t->sigs, t->nsigs, t->src) < 0)
        return -1;
    Tx *v1 = t->is_fee_bump ? t->inner : t;
    if (t->is_fee_bump &&
        vset_collect(env, &v1->vs, v1->sigs, v1->nsigs, v1->src) < 0)
        return -1;
    for (i = 0; i < v1->nops; i++) {
        Op *op = &v1->ops[i];
        const uint8_t *osrc = op->has_src ? op->src : v1->src;
        if (vset_collect(env, &v1->vs, v1->sigs, v1->nsigs, osrc) < 0)
            return -1;
    }
    return 0;
}

/* one verify() callback for every candidate pair in the close */
static int preverify_all(Ctx *c, AEnv *env, Tx **txs, int ntx)
{
    PyObject *lst = PyList_New(0);
    int ti;
    if (!lst) {
        c->pyerr = 1;
        return -1;
    }
    for (ti = 0; ti < ntx; ti++) {
        Tx *t = txs[ti];
        if (collect_tx_candidates(env, t) < 0)
            goto fail;
        if (vset_append_batch(c, lst, &t->vs, t->sigs, t->hash) < 0)
            goto fail;
        if (t->is_fee_bump &&
            vset_append_batch(c, lst, &t->inner->vs, t->inner->sigs,
                              t->inner->hash) < 0)
            goto fail;
    }
    if (PyList_GET_SIZE(lst) == 0) {
        Py_DECREF(lst);
        return 0;
    }
    PyObject *res = PyObject_CallFunctionObjArgs(c->verify, lst, NULL);
    Py_DECREF(lst);
    lst = NULL;
    if (!res) {
        c->pyerr = 1;
        return -1;
    }
    PyObject *seq = PySequence_Fast(res, "verify() must return a sequence");
    Py_DECREF(res);
    if (!seq) {
        c->pyerr = 1;
        return -1;
    }
    Py_ssize_t pos = 0;
    for (ti = 0; ti < ntx; ti++) {
        Tx *t = txs[ti];
        if (vset_read_results(c, seq, &pos, &t->vs) < 0)
            goto fail_seq;
        if (t->is_fee_bump &&
            vset_read_results(c, seq, &pos, &t->inner->vs) < 0)
            goto fail_seq;
    }
    if (pos != PySequence_Fast_GET_SIZE(seq)) {
        ctx_bail(c, "verify-shape");
        goto fail_seq;
    }
    Py_DECREF(seq);
    return 0;
fail_seq:
    Py_DECREF(seq);
    return -1;
fail:
    Py_XDECREF(lst);
    return -1;
}

/* ------------------------------------------------- conflict clustering */

/* the same static-key walk as prefetch, but recording Entry pointers
   (pure hash hits after prefetch — the GIL is still held, so a stray
   miss is handled, not fatal) */
static int tx_entries_v1(AEnv *env, Tx *t, EList *out)
{
    int i;
    Entry *e;
#define REC(expr)                                                        \
    do {                                                                 \
        e = (expr);                                                      \
        if (!e)                                                          \
            return -1;                                                   \
        if (elist_push(out, e) < 0) {                                    \
            env->oom = 1;                                                \
            return -1;                                                   \
        }                                                                \
    } while (0)
    REC(get_account(env, t->src));
    for (i = 0; i < t->nops; i++) {
        Op *op = &t->ops[i];
        const uint8_t *osrc = op->has_src ? op->src : t->src;
        REC(get_account(env, osrc));
        switch (op->optype) {
        case OP_CREATE_ACCOUNT:
        case OP_ACCOUNT_MERGE:
            REC(get_account(env, op->dest));
            break;
        case OP_PAYMENT:
            REC(get_account(env, op->dest));
            if (!op->asset_native) {
                /* issuer key omitted: read only in the issuer-source/
                   issuer-dest arms, whose account is already recorded */
                if (memcmp(osrc, op->issuer, 32) != 0)
                    REC(get_trustline(env, osrc, op->asset,
                                      op->assetlen));
                if (memcmp(op->dest, op->issuer, 32) != 0)
                    REC(get_trustline(env, op->dest, op->asset,
                                      op->assetlen));
            }
            break;
        case OP_SET_OPTIONS:
            if (op->so_has_infl)
                REC(get_account(env, op->so_infl));
            break;
        case OP_CHANGE_TRUST:
            REC(get_account(env, op->issuer));
            REC(get_trustline(env, osrc, op->asset, op->assetlen));
            break;
        case OP_ALLOW_TRUST: {
            uint8_t asset[MAX_ASSET];
            memcpy(asset, op->at_asset, op->at_assetlen);
            memcpy(asset + op->at_assetlen - 32, osrc, 32);
            REC(get_trustline(env, op->at_trustor, asset,
                              op->at_assetlen));
            break;
        }
        case OP_MANAGE_DATA:
            REC(get_data(env, osrc, op->md_name, op->md_name_len));
            break;
        default:
            break;
        }
    }
#undef REC
    return 0;
}

static int tx_entries(AEnv *env, Tx *t, EList *out)
{
    Entry *e = get_account(env, t->src);
    if (!e)
        return -1;
    if (elist_push(out, e) < 0) {
        env->oom = 1;
        return -1;
    }
    return tx_entries_v1(env, t->is_fee_bump ? t->inner : t, out);
}

static int uf_find(int *parent, int x)
{
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];
        x = parent[x];
    }
    return x;
}

static void uf_union(int *parent, int a, int b)
{
    a = uf_find(parent, a);
    b = uf_find(parent, b);
    if (a != b)
        parent[b < a ? a : b] = b < a ? b : a; /* smaller index wins */
}

/* one parallel worker: applies its assigned txs (grouped by cluster,
   ascending tx index within each) on a private journal. Pure C — the
   GIL is released; any Python need trips the nopy bail. */
typedef struct {
    AEnv env;
    Tx **txs;    /* global tx array */
    int *order;  /* tx indices this worker applies, in order */
    int n;
    int failed;
} Worker;

static void *worker_main(void *arg)
{
    Worker *w = (Worker *)arg;
    /* run on a STACK-local env: the Worker array is contiguous, and
       the per-op attribution counters are written on every op — false
       sharing across adjacent workers' cache lines costs ~5x per-op
       when they live in the shared array */
    AEnv env = w->env;
    int k;
    /* buffers built here record &env.ar (this stack frame); the arena
       HEAD is copied back into w->env below and only ever freed through
       it — buf_free never dereferences the stale pointer */
    for (k = 0; k < w->n; k++) {
        if (ctx_aborted(env.c))
            break;
        int ti = w->order[k];
        env.txidx = ti;
        env.ord0 = 0;
        if (apply_tx(&env, w->txs[ti]) < 0) {
            w->failed = 1;
            ctx_abort(env.c);
            break;
        }
    }
    w->env = env;
    return NULL;
}

static int cmp_order0(const void *pa, const void *pb)
{
    const Entry *a = *(Entry *const *)pa;
    const Entry *b = *(Entry *const *)pb;
    if (a->order0 < b->order0)
        return -1;
    if (a->order0 > b->order0)
        return 1;
    return 0;
}

/* merge one finished env back into the context (op attribution +
   bail state); level-0 lists are merged separately (sorted) */
static void env_merge(AEnv *dst, const AEnv *src)
{
    int i;
    for (i = 0; i < MAX_OPTYPES; i++) {
        dst->op_cnt[i] += src->op_cnt[i];
        dst->op_ns[i] += src->op_ns[i];
    }
    if (src->bail && !dst->bail) {
        dst->bail = 1;
        dst->bailmsg = src->bailmsg;
        if (src->bailmsg == src->bailbuf) {
            memcpy(dst->bailbuf, src->bailbuf, sizeof(dst->bailbuf));
            dst->bailmsg = dst->bailbuf;
        }
    }
    if (src->oom)
        dst->oom = 1;
}

static void env_free_lists(AEnv *env)
{
    int i;
    for (i = 0; i < MAXLEVEL; i++)
        free(env->lv[i].v);
    arena_free_all(&env->ar);
}

/* ------------------------------------------------ persistent worker pool
 *
 * pthread_create costs ~200µs under sandboxed kernels — several ms per
 * close at 8 workers, which would eat the whole parallel win. The pool
 * threads persist for the process lifetime (detached; they park on the
 * condvar between closes and die with the process). */
static struct {
    pthread_mutex_t mu;
    pthread_cond_t work_cv, done_cv;
    Worker *ws;
    int n, next, done;
    uint64_t gen;
    int nthreads;
    int inited;
} POOL = {PTHREAD_MUTEX_INITIALIZER, PTHREAD_COND_INITIALIZER,
          PTHREAD_COND_INITIALIZER, NULL, 0, 0, 0, 0, 0, 0};

static void *pool_thread(void *arg)
{
    uint64_t my_gen = (uint64_t)(uintptr_t)arg;
    pthread_mutex_lock(&POOL.mu);
    for (;;) {
        /* brief lock-free spin before blocking: condvar wakeups are
           slow syscalls under sandboxed kernels, and back-to-back
           closes re-dispatch within microseconds */
        pthread_mutex_unlock(&POOL.mu);
        for (int spin = 0; spin < 400000; spin++) {
            if (__atomic_load_n(&POOL.gen, __ATOMIC_ACQUIRE) != my_gen)
                break;
        }
        pthread_mutex_lock(&POOL.mu);
        while (POOL.gen == my_gen || POOL.ws == NULL)
            pthread_cond_wait(&POOL.work_cv, &POOL.mu);
        my_gen = POOL.gen;
        while (POOL.next < POOL.n) {
            Worker *w = &POOL.ws[POOL.next++];
            pthread_mutex_unlock(&POOL.mu);
            worker_main(w);
            pthread_mutex_lock(&POOL.mu);
            POOL.done++;
            if (POOL.done == POOL.n)
                pthread_cond_signal(&POOL.done_cv);
        }
    }
    return NULL;
}

/* run all workers on the pool; returns 0, or -1 if threads could not
   be spawned (caller falls back to serial). Call with the GIL released. */
static int pool_run(Worker *ws, int n)
{
    pthread_mutex_lock(&POOL.mu);
    while (POOL.nthreads < n && POOL.nthreads < MAX_WORKERS) {
        pthread_t t;
        pthread_attr_t at;
        pthread_attr_init(&at);
        pthread_attr_setdetachstate(&at, PTHREAD_CREATE_DETACHED);
        if (pthread_create(&t, &at, pool_thread,
                           (void *)(uintptr_t)POOL.gen) != 0) {
            pthread_attr_destroy(&at);
            break;
        }
        pthread_attr_destroy(&at);
        POOL.nthreads++;
    }
    if (POOL.nthreads == 0) {
        pthread_mutex_unlock(&POOL.mu);
        return -1;
    }
    POOL.ws = ws;
    POOL.n = n;
    POOL.next = 0;
    POOL.done = 0;
    /* pool threads spin on gen OUTSIDE the mutex (atomic acquire
       loads); the publishing store must be atomic too — a plain
       increment racing those loads is a TSan-reportable data race.
       The mutex still orders the plain gen reads in pool_thread. */
    __atomic_store_n(&POOL.gen, POOL.gen + 1, __ATOMIC_RELEASE);
    pthread_cond_broadcast(&POOL.work_cv);
    while (POOL.done < POOL.n)
        pthread_cond_wait(&POOL.done_cv, &POOL.mu);
    POOL.ws = NULL;
    pthread_mutex_unlock(&POOL.mu);
    return 0;
}

/* -------------------------------------------------------------- emission */

/* TransactionResult XDR for one applied v1 tx (fee bumps wrap this) */
static int emit_v1_result(Tx *t, int64_t fee, Buf *b)
{
    int i;
    if (buf_i64(b, fee) < 0 || buf_i32(b, t->out_code) < 0)
        return -1;
    if (t->out_code == txSUCCESS || t->out_code == txFAILED) {
        if (buf_u32(b, (uint32_t)t->out_res_ops) < 0)
            return -1;
        for (i = 0; i < t->out_res_ops; i++) {
            OpRes *r = &t->opres[i];
            if (buf_i32(b, r->code) < 0)
                return -1;
            if (r->code != opINNER)
                continue;
            if (buf_i32(b, r->optype) < 0 ||
                buf_i32(b, r->inner_code) < 0)
                return -1;
            if (r->has_payload &&
                buf_put(b, r->payload.data, r->payload.len) < 0)
                return -1;
        }
    }
    if (buf_u32(b, 0) < 0) /* TransactionResult ext */
        return -1;
    return 0;
}

static int emit_result(Tx *t, Buf *b)
{
    if (!t->is_fee_bump)
        return emit_v1_result(t, t->feeCharged, b);
    if (buf_i64(b, t->feeCharged) < 0 || buf_i32(b, t->out_code) < 0)
        return -1;
    if (t->out_code == txFEE_BUMP_INNER_SUCCESS ||
        t->out_code == txFEE_BUMP_INNER_FAILED) {
        /* InnerTransactionResultPair: inner hash + inner result (the
           inner's feeCharged is 0 — FeeBumpTransactionFrame.apply
           initializes it so) */
        if (buf_put(b, t->inner->hash, 32) < 0 ||
            emit_v1_result(t->inner, 0, b) < 0)
            return -1;
    }
    if (buf_u32(b, 0) < 0)
        return -1;
    return 0;
}

/* TransactionMeta v1 from the stored changes blobs */
static int emit_meta(Tx *t, Buf *b)
{
    Tx *v1 = t->is_fee_bump ? t->inner : t;
    if (buf_u32(b, 1) < 0) /* TransactionMeta disc v1 */
        return -1;
    if (t->is_fee_bump && !v1->out_have) {
        /* outer envelope failed: inner never applied — empty meta */
        return (buf_u32(b, 0) < 0 || buf_u32(b, 0) < 0) ? -1 : 0;
    }
    if (v1->out_empty_txch || v1->txch.len == 0) {
        if (buf_u32(b, 0) < 0)
            return -1;
    } else if (buf_put(b, v1->txch.data, v1->txch.len) < 0)
        return -1;
    if (buf_u32(b, (uint32_t)v1->out_meta_ops) < 0)
        return -1;
    for (int i = 0; i < v1->out_meta_ops; i++) {
        if (v1->out_ok && v1->opch && v1->opch[i].len) {
            if (buf_put(b, v1->opch[i].data, v1->opch[i].len) < 0)
                return -1;
        } else if (buf_u32(b, 0) < 0)
            return -1;
    }
    return 0;
}

static PyObject *buf_to_pybytes(Buf *b)
{
    return PyBytes_FromStringAndSize(b->data ? b->data : "", b->len);
}

/* ----------------------------------------------------------- the close */

static int params_i64(PyObject *params, const char *name, int64_t *out,
                      int required, int64_t dflt)
{
    PyObject *v = PyDict_GetItemString(params, name);
    if (!v) {
        if (!required) {
            *out = dflt;
            return 0;
        }
        PyErr_Format(PyExc_KeyError, "params missing %s", name);
        return -1;
    }
    *out = PyLong_AsLongLong(v);
    if (*out == -1 && PyErr_Occurred())
        return -1;
    return 0;
}

static PyObject *apply_close(PyObject *self, PyObject *args)
{
    PyObject *params, *envs, *hashes, *lookup, *verify, *book_cb,
        *acct_cb, *opts = Py_None;
    if (!PyArg_ParseTuple(args, "OOOOOOO|O", &params, &envs, &hashes,
                          &lookup, &verify, &book_cb, &acct_cb, &opts))
        return NULL;

    Ctx c;
    memset(&c, 0, sizeof(c));
    c.lookup = lookup;
    c.verify = verify;
    c.book_cb = book_cb;
    c.acct_cb = acct_cb;

    int64_t v;
    if (params_i64(params, "ledgerVersion", &v, 1, 0) < 0)
        return NULL;
    c.ledgerVersion = (uint32_t)v;
    if (params_i64(params, "ledgerSeq", &v, 1, 0) < 0)
        return NULL;
    c.ledgerSeq = (uint32_t)v;
    if (params_i64(params, "closeTime", &v, 1, 0) < 0)
        return NULL;
    c.closeTime = (uint64_t)v;
    if (params_i64(params, "baseFee", &c.baseFee, 1, 0) < 0 ||
        params_i64(params, "baseReserve", &c.baseReserve, 1, 0) < 0 ||
        params_i64(params, "effBaseFee", &c.effBase, 1, 0) < 0 ||
        params_i64(params, "feePool", &c.feePool, 1, 0) < 0 ||
        params_i64(params, "idPool", &c.idPool, 1, 0) < 0)
        return NULL;
    if (params_i64(params, "inflationSeq", &v, 0, 0) < 0)
        return NULL;
    c.inflationSeq = (uint32_t)v;

    if (c.ledgerVersion < 10) /* pre-10 fee/seq semantics: Python path */
        Py_RETURN_NONE;

    int workers = 0, force_serial = 0, force_parallel = 0;
    if (opts != Py_None && PyDict_Check(opts)) {
        PyObject *w = PyDict_GetItemString(opts, "workers");
        if (w) {
            workers = (int)PyLong_AsLong(w);
            if (workers == -1 && PyErr_Occurred())
                return NULL;
        }
        PyObject *m = PyDict_GetItemString(opts, "mode");
        if (m && PyUnicode_Check(m)) {
            const char *ms = PyUnicode_AsUTF8(m);
            if (!ms)
                return NULL;
            if (strcmp(ms, "serial") == 0)
                force_serial = 1;
            else if (strcmp(ms, "parallel") == 0)
                force_parallel = 1;
        }
    }
    if (workers <= 0)
        workers = 1;
    if (workers > MAX_WORKERS)
        workers = MAX_WORKERS;

    Py_ssize_t ntx = PySequence_Length(envs);
    if (ntx < 0)
        return NULL;
    if (PySequence_Length(hashes) != ntx) {
        PyErr_SetString(PyExc_ValueError, "envs/hashes length mismatch");
        return NULL;
    }

    Tx *txs = calloc(ntx ? ntx : 1, sizeof(Tx));
    Tx **txp = calloc(ntx ? ntx : 1, sizeof(Tx *));
    Buf *fee_bufs = calloc(ntx ? ntx : 1, sizeof(Buf));
    if (!txs || !txp || !fee_bufs) {
        free(txs);
        free(txp);
        free(fee_bufs);
        return PyErr_NoMemory();
    }

    AEnv env0;
    memset(&env0, 0, sizeof(env0));
    env0.c = &c;

    PyObject *results = NULL, *fee_changes = NULL, *metas = NULL;
    PyObject *changes = NULL, *out = NULL;
    int bailing = 0, any_dynamic = 0, used_parallel = 0;
    int nclusters = 0, max_cluster = 0, nworkers_used = 1;
    Py_ssize_t ti;
    int i;
    int *parent = NULL, *cl_of = NULL, *cl_sizes = NULL, *cl_order = NULL;
    int *tx_by_cluster = NULL, *cl_off = NULL;
    Worker *ws = NULL;

    /* ---- parse every envelope up front: one unsupported tx fails the
       whole close over to Python BEFORE any state mutates */
    for (ti = 0; ti < ntx; ti++) {
        PyObject *env = PySequence_GetItem(envs, ti);
        PyObject *h = PySequence_GetItem(hashes, ti);
        if (!env || !h || !PyBytes_Check(env) || !PyBytes_Check(h)) {
            Py_XDECREF(env);
            Py_XDECREF(h);
            if (!PyErr_Occurred())
                ctx_bail(&c, "input-shape");
            else
                c.pyerr = 1;
            goto done;
        }
        txp[ti] = &txs[ti];
        int rc = parse_envelope(
            &c, (const uint8_t *)PyBytes_AS_STRING(env),
            PyBytes_GET_SIZE(env), (const uint8_t *)PyBytes_AS_STRING(h),
            PyBytes_GET_SIZE(h), h, &txs[ti]);
        /* envs/hashes lists own the buffers the parsed tx borrows
           (sig/hash pointers); the caller holds the lists alive */
        Py_DECREF(env);
        Py_DECREF(h);
        if (rc < 0) {
            if (!c.pyerr && !c.bail)
                ctx_bail(&c, "envelope");
            goto done;
        }
        if (txs[ti].dynamic)
            any_dynamic = 1;
    }

    /* statically-knowable signer additions feed the pre-verify superset */
    for (ti = 0; ti < ntx; ti++) {
        Tx *t = txp[ti];
        if (collect_static_adds_v1(&c, t->is_fee_bump ? t->inner : t) < 0)
            goto done;
    }

    /* ---- prefetch + pre-verify (GIL held, Python callbacks allowed).
       Fully-static closes skip the dedicated prefetch walk: the
       clustering pass below enumerates the same keys through the same
       lazy-loading accessors, so one walk does both jobs. */
    if (any_dynamic) {
        for (ti = 0; ti < ntx; ti++) {
            if (prefetch_tx(&env0, txp[ti]) < 0 || env0.bail ||
                env0.oom || c.pyerr || c.bail)
                goto done;
        }
    }
    if (preverify_all(&c, &env0, txp, (int)ntx) < 0 || env0.bail ||
        env0.oom || c.pyerr || c.bail)
        goto done;

    /* ---- phase 1: fees, serial and in tx order */
    if (fee_phase(&env0, txp, (int)ntx, fee_bufs) < 0 || env0.bail ||
        env0.oom || c.pyerr || c.bail)
        goto done;

    /* ---- phase 2: apply. Conflict clustering first (cheap), so even
       the serial path reports cluster telemetry. */
    int64_t cal_ns0 = now_ns(), cal_t0 = now_ticks();
    int64_t apply_phase_ns = 0; /* the tx-execution wall (phase 2 only:
        cluster scheduling + apply), the quantity the conflict-graph
        parallelism accelerates — parse/verify/fees/emission excluded */
    int want_parallel = !force_serial && !any_dynamic && ntx > 1 &&
                        (workers > 1 || force_parallel);
    if (ntx > 0 && !any_dynamic) {
        parent = malloc(ntx * sizeof(int));
        cl_of = malloc(ntx * sizeof(int));
        cl_sizes = calloc(ntx, sizeof(int));
        if (!parent || !cl_of || !cl_sizes) {
            env0.oom = 1;
            goto done;
        }
        for (ti = 0; ti < ntx; ti++)
            parent[ti] = (int)ti;
        EList keys = {NULL, 0, 0};
        for (ti = 0; ti < ntx; ti++) {
            keys.n = 0;
            if (tx_entries(&env0, txp[ti], &keys) < 0 || env0.bail ||
                env0.oom || c.pyerr || c.bail) {
                free(keys.v);
                goto done;
            }
            for (i = 0; i < keys.n; i++) {
                Entry *e = keys.v[i];
                if (e->uf_tx < 0)
                    e->uf_tx = (int)ti;
                else
                    uf_union(parent, e->uf_tx, (int)ti);
            }
        }
        free(keys.v);
        /* label clusters 0..n-1 by first-seen root */
        for (ti = 0; ti < ntx; ti++)
            cl_of[ti] = -1;
        for (ti = 0; ti < ntx; ti++) {
            int root = uf_find(parent, (int)ti);
            if (cl_of[root] < 0)
                cl_of[root] = nclusters++;
            cl_of[ti] = cl_of[root];
            cl_sizes[cl_of[ti]]++;
        }
        for (i = 0; i < nclusters; i++)
            if (cl_sizes[i] > max_cluster)
                max_cluster = cl_sizes[i];
    }

    if (want_parallel && nclusters > 1) {
        /* group tx indices by cluster (ascending within each) */
        cl_off = calloc(nclusters + 1, sizeof(int));
        tx_by_cluster = malloc(ntx * sizeof(int));
        cl_order = malloc(nclusters * sizeof(int));
        if (!cl_off || !tx_by_cluster || !cl_order) {
            env0.oom = 1;
            goto done;
        }
        for (i = 0; i < nclusters; i++)
            cl_off[i + 1] = cl_off[i] + cl_sizes[i];
        {
            int *fill = calloc(nclusters, sizeof(int));
            if (!fill) {
                env0.oom = 1;
                goto done;
            }
            for (ti = 0; ti < ntx; ti++) {
                int cl = cl_of[ti];
                tx_by_cluster[cl_off[cl] + fill[cl]++] = (int)ti;
            }
            free(fill);
        }
        /* LPT: clusters descending by size onto the least-loaded worker */
        for (i = 0; i < nclusters; i++)
            cl_order[i] = i;
        for (i = 1; i < nclusters; i++) { /* insertion sort, desc */
            int k = cl_order[i], j = i;
            while (j > 0 && cl_sizes[cl_order[j - 1]] < cl_sizes[k]) {
                cl_order[j] = cl_order[j - 1];
                j--;
            }
            cl_order[j] = k;
        }
        nworkers_used = workers < nclusters ? workers : nclusters;
        ws = calloc(nworkers_used, sizeof(Worker));
        if (!ws) {
            env0.oom = 1;
            goto done;
        }
        int64_t *load = calloc(nworkers_used, sizeof(int64_t));
        int *wcount = calloc(nworkers_used, sizeof(int));
        int *assign = malloc(nclusters * sizeof(int));
        if (!load || !wcount || !assign) {
            free(load);
            free(wcount);
            free(assign);
            env0.oom = 1;
            goto done;
        }
        for (i = 0; i < nclusters; i++) {
            int best = 0, w;
            for (w = 1; w < nworkers_used; w++)
                if (load[w] < load[best])
                    best = w;
            assign[cl_order[i]] = best;
            load[best] += cl_sizes[cl_order[i]];
            wcount[best] += cl_sizes[cl_order[i]];
        }
        int w, ok = 1;
        for (w = 0; w < nworkers_used; w++) {
            ws[w].env.c = &c;
            ws[w].env.use_local0 = 1;
            ws[w].txs = txp;
            ws[w].order = malloc((wcount[w] ? wcount[w] : 1) *
                                 sizeof(int));
            if (!ws[w].order) {
                ok = 0;
                break;
            }
            ws[w].n = 0;
        }
        if (ok) {
            /* clusters in LPT order so each worker's stream is fixed */
            for (i = 0; i < nclusters; i++) {
                int cl = cl_order[i];
                int w2 = assign[cl];
                for (int k = cl_off[cl]; k < cl_off[cl + 1]; k++)
                    ws[w2].order[ws[w2].n++] = tx_by_cluster[k];
            }
        }
        free(load);
        free(wcount);
        free(assign);
        if (!ok) {
            env0.oom = 1;
            goto done;
        }

        c.nopy = 1;
        int pool_rc;
        int64_t t_apply0 = now_ns();
        Py_BEGIN_ALLOW_THREADS
        pool_rc = pool_run(ws, nworkers_used);
        Py_END_ALLOW_THREADS
        apply_phase_ns = now_ns() - t_apply0;
        c.nopy = 0;
        if (pool_rc != 0) {
            ctx_bail(&c, "thread-spawn");
            goto done;
        }
        used_parallel = 1;
        /* merge: attribution + failure flags, then the stamped level-0
           entries back into serial first-touch order */
        EList all0 = {NULL, 0, 0};
        for (w = 0; w < nworkers_used; w++) {
            env_merge(&env0, &ws[w].env);
            for (i = 0; i < ws[w].env.lv[0].n; i++)
                if (elist_push(&all0, ws[w].env.lv[0].v[i]) < 0) {
                    env0.oom = 1;
                    break;
                }
        }
        if (env0.bail || env0.oom || c.bail || c.pyerr) {
            free(all0.v);
            goto done;
        }
        if (all0.n) /* UBSan: qsort base must be non-null even for n==0 */
            qsort(all0.v, all0.n, sizeof(Entry *), cmp_order0);
        for (i = 0; i < all0.n; i++)
            if (elist_push(&c.closed0, all0.v[i]) < 0) {
                env0.oom = 1;
                break;
            }
        free(all0.v);
        if (env0.oom)
            goto done;
    } else {
        /* serial apply — GIL-free when the whole txset is static */
        int64_t t_apply0 = now_ns();
        if (!any_dynamic) {
            c.nopy = 1;
            int failed = 0;
            Py_BEGIN_ALLOW_THREADS
            for (ti = 0; ti < ntx; ti++) {
                env0.txidx = (int)ti;
                if (apply_tx(&env0, txp[ti]) < 0) {
                    failed = 1;
                    break;
                }
            }
            Py_END_ALLOW_THREADS
            c.nopy = 0;
            if (failed || env0.bail || env0.oom || c.bail || c.pyerr)
                goto done;
        } else {
            for (ti = 0; ti < ntx; ti++) {
                env0.txidx = (int)ti;
                if (apply_tx(&env0, txp[ti]) < 0 || env0.bail ||
                    env0.oom || c.bail || c.pyerr)
                    goto done;
            }
        }
        apply_phase_ns = now_ns() - t_apply0;
    }

    /* convert the per-op tick attribution to nanoseconds against the
       apply phase's CLOCK_MONOTONIC bracket */
    {
        int64_t cal_ns1 = now_ns(), cal_t1 = now_ticks();
        if (cal_t1 > cal_t0 && cal_ns1 > cal_ns0) {
            double scale = (double)(cal_ns1 - cal_ns0) /
                           (double)(cal_t1 - cal_t0);
            for (i = 0; i < MAX_OPTYPES; i++)
                env0.op_ns[i] = (int64_t)(env0.op_ns[i] * scale);
        }
    }

    /* ---- outputs */
    results = PyList_New(0);
    fee_changes = PyList_New(0);
    metas = PyList_New(0);
    changes = PyList_New(0);
    if (!results || !fee_changes || !metas || !changes) {
        c.pyerr = 1;
        goto done;
    }
    for (ti = 0; ti < ntx; ti++) {
        Tx *t = txp[ti];
        PyObject *o;
        o = buf_to_pybytes(&t->out_rb);
        if (!o || PyList_Append(results, o) < 0) {
            Py_XDECREF(o);
            c.pyerr = 1;
            goto done;
        }
        Py_DECREF(o);
        o = buf_to_pybytes(&t->out_mb);
        if (!o || PyList_Append(metas, o) < 0) {
            Py_XDECREF(o);
            c.pyerr = 1;
            goto done;
        }
        Py_DECREF(o);
        o = buf_to_pybytes(&fee_bufs[ti]);
        if (!o || PyList_Append(fee_changes, o) < 0) {
            Py_XDECREF(o);
            c.pyerr = 1;
            goto done;
        }
        Py_DECREF(o);
    }

    /* close-level changed entries, serial first-touch order */
    for (i = 0; i < c.closed0.n; i++) {
        Entry *e = c.closed0.v[i];
        EntrySave *s = &e->save[0];
        if (mut_eq(&e->st, &s->st))
            continue;
        PyObject *key = PyBytes_FromStringAndSize((const char *)e->keyb,
                                                  e->keylen);
        PyObject *prev = NULL, *cur = NULL;
        if (key && s->st.exists) {
            Buf b = {NULL, 0, 0};
            if (ser_entry(e, &s->st, &b) == 0)
                prev = PyBytes_FromStringAndSize(b.data, b.len);
            buf_free(&b);
        } else if (key) {
            prev = Py_None;
            Py_INCREF(prev);
        }
        if (key && prev && e->st.exists) {
            Buf b = {NULL, 0, 0};
            if (ser_entry(e, &e->st, &b) == 0)
                cur = PyBytes_FromStringAndSize(b.data, b.len);
            buf_free(&b);
        } else if (key && prev) {
            cur = Py_None;
            Py_INCREF(cur);
        }
        PyObject *tup = (key && prev && cur)
                            ? PyTuple_Pack(3, key, prev, cur)
                            : NULL;
        Py_XDECREF(key);
        Py_XDECREF(prev);
        Py_XDECREF(cur);
        if (!tup || PyList_Append(changes, tup) < 0) {
            Py_XDECREF(tup);
            c.pyerr = 1;
            goto done;
        }
        Py_DECREF(tup);
    }

    {
        PyObject *op_stats = PyDict_New();
        if (!op_stats) {
            c.pyerr = 1;
            goto done;
        }
        for (i = 0; i < MAX_OPTYPES; i++) {
            if (!env0.op_cnt[i])
                continue;
            PyObject *k = PyLong_FromLong(i);
            PyObject *v2 =
                Py_BuildValue("(LL)", (long long)env0.op_cnt[i],
                              (long long)env0.op_ns[i]);
            if (!k || !v2 || PyDict_SetItem(op_stats, k, v2) < 0) {
                Py_XDECREF(k);
                Py_XDECREF(v2);
                Py_DECREF(op_stats);
                c.pyerr = 1;
                goto done;
            }
            Py_DECREF(k);
            Py_DECREF(v2);
        }
        out = Py_BuildValue(
            "{s:L,s:L,s:O,s:O,s:O,s:O,s:O,"
            "s:{s:i,s:i,s:i,s:i,s:L}}",
            "feePool", (long long)c.feePool, "idPool",
            (long long)c.idPool, "changes", changes, "results", results,
            "fee_changes", fee_changes, "meta", metas, "op_stats",
            op_stats, "clusters", "count", nclusters, "max_txs",
            max_cluster, "parallel", used_parallel, "workers",
            used_parallel ? nworkers_used : 1, "apply_ns",
            (long long)apply_phase_ns);
        Py_DECREF(op_stats);
        if (!out)
            c.pyerr = 1;
    }

done:
    if (env0.bail && !c.bailmsg) {
        if (env0.bailmsg == env0.bailbuf) {
            memcpy(c.bailbuf, env0.bailbuf, sizeof(c.bailbuf));
            c.bailmsg = c.bailbuf;
        } else
            c.bailmsg = env0.bailmsg;
        c.bail = 1;
    }
    if (env0.bail)
        c.bail = 1;
    if (env0.oom && !c.pyerr && !PyErr_Occurred())
        PyErr_NoMemory();
    if (env0.oom)
        c.pyerr = 1;
    bailing = c.bail && !c.pyerr;
    for (ti = 0; ti < ntx; ti++)
        tx_free(&txs[ti]);
    free(txs);
    free(txp);
    for (ti = 0; ti < (fee_bufs ? ntx : 0); ti++)
        buf_free(&fee_bufs[ti]);
    free(fee_bufs);
    free(parent);
    free(cl_of);
    free(cl_sizes);
    free(cl_order);
    free(tx_by_cluster);
    free(cl_off);
    if (ws) {
        for (i = 0; i < nworkers_used; i++) {
            free(ws[i].order);
            env_free_lists(&ws[i].env);
        }
        free(ws);
    }
    env_free_lists(&env0);
    Py_XDECREF(results);
    Py_XDECREF(fee_changes);
    Py_XDECREF(metas);
    Py_XDECREF(changes);
    ctx_free(&c);
    if (c.pyerr) {
        if (!PyErr_Occurred())
            PyErr_SetString(PyExc_RuntimeError, "native apply failed");
        return NULL;
    }
    if (bailing)
        return Py_BuildValue("{s:s}", "bail",
                             c.bailmsg ? c.bailmsg : "unsupported");
    if (!out)
        Py_RETURN_NONE;
    return out;
}

static PyMethodDef methods[] = {
    {"apply_close", apply_close, METH_VARARGS,
     "apply_close(params, envs, hashes, lookup, verify, book, "
     "acct_offers[, opts]) -> dict | None"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_sctapply_torch",
    "Native transaction-apply fast path (see module docstring in source).",
    -1, methods,
};

PyMODINIT_FUNC PyInit__sctapply_torch(void)
{
    return PyModule_Create(&moduledef);
}
