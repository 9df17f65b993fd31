"""LedgerTxn: nested in-memory copy-on-write ledger state transactions.

Copied from `stellar_core_tpu/ledger/ledgertxn.py` at commit bb973b8; carry
a fix in either copy to the other. Kept: the apply engine's hooks
(`inject_native_changes`, the serialized-entry cache `_cur_blobs` and the
`blobs` argument of `commit_child` that its injected deltas fill,
`get_delta`'s `need_prev`, and the roots' `get_entry_blob` /
`offers_for_book_blobs` / `offers_by_account_blobs` callbacks); BucketDB's
routing on the SQL root (`attach_bucketdb`, `detach_bucketdb`,
`bucket_backed`, `_load_blob`: a point read that misses the entry cache
is served from the bucket list, from SQL only on a `bucketdb.read-fail`
degrade, and `prefetch` resolves a set's keys in one batched pass per
level); the close cockpit's read telemetry (`stats`: `_on_cache_evict`,
`_note_prefetched`, `record_read`, the bulk-scan rows).

Role parity: reference `src/ledger/LedgerTxn*` (LedgerTxn.h:18-165): a tree
of transactions over (LedgerKey → LedgerEntry), root backed by SQL with an
entry cache and bulk commits; children see parent state copy-on-write;
commit merges down, rollback discards. Entry-type-specific SQL backends
(LedgerTxnAccountSQL.cpp etc.) correspond to the per-table writers here.

Simplifications vs reference: Python object mutability replaces the
"activeness" discipline — load() snapshots the pre-image for delta/meta
generation, and entries are owned by the innermost open txn.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple

from ..database.database import Database
from ..util.cache import LRUCache
from ..xdr import (
    Asset, LedgerEntry, LedgerEntryType, LedgerHeader, LedgerKey, OfferEntry,
    ledger_entry_key,
)
from ..xdr import fastcodec
from ..crypto import strkey


def _kb(key: LedgerKey) -> bytes:
    """LedgerKey → canonical bytes (the txn tree's map key), memoized on
    the instance — keys are treated as immutable once built, and the same
    key object flows through load/commit/delta several times per access."""
    kb = key.__dict__.get("_kb")
    if kb is None:
        kb = key.to_xdr()
        key.__dict__["_kb"] = kb
    return kb


# copy-on-write primitives: compiled structural copies (xdr/fastcodec.py),
# ~4x cheaper than the pack+unpack round-trip (replay profile: entry/header
# copies were ~14% of catchup CPU)
_copy_entry = fastcodec.compile_copy(LedgerEntry)
_copy_header = fastcodec.compile_copy(LedgerHeader)


_acc_str_cache: Dict[bytes, str] = {}


def _acc_str(account_id) -> str:
    """strkey encoding for SQL row keys, memoized — a busy account's key
    is re-encoded on every load/commit otherwise (CRC16 per call)."""
    kb = account_id.key_bytes
    s = _acc_str_cache.get(kb)
    if s is None:
        if len(_acc_str_cache) > 0x10000:
            _acc_str_cache.clear()
        s = strkey.encode_public_key(kb)
        _acc_str_cache[kb] = s
    return s


def _asset_str(asset: Asset) -> str:
    import base64
    return base64.b64encode(asset.to_xdr()).decode()


def price_less(a_offer: OfferEntry, b_offer: OfferEntry) -> bool:
    """Exact fraction compare a.price < b.price, tie-break by offerID
    (reference isBetterOffer, LedgerTxn.cpp role)."""
    lhs = a_offer.price.n * b_offer.price.d
    rhs = b_offer.price.n * a_offer.price.d
    if lhs != rhs:
        return lhs < rhs
    return a_offer.offerID < b_offer.offerID


class AbstractLedgerTxnParent:
    # Exactly one child may be open under any parent — roots included
    # (reference LedgerTxn.cpp addChild: both LedgerTxn and LedgerTxnRoot
    # throw if a child is already open).
    _child: Optional["LedgerTxn"] = None

    def _register_child(self, child: "LedgerTxn") -> None:
        assert self._child is None, "parent already has an open child"
        self._child = child

    def _clear_child(self, child: "LedgerTxn") -> None:
        if self._child is child:
            self._child = None

    def get_entry(self, key: LedgerKey) -> Optional[LedgerEntry]:
        raise NotImplementedError

    def get_header(self) -> LedgerHeader:
        raise NotImplementedError

    def _all_offers_for_book(self, selling: Asset,
                             buying: Asset) -> Dict[bytes, LedgerEntry]:
        raise NotImplementedError

    def _offers_by_account(self, account_id) -> Dict[bytes, LedgerEntry]:
        raise NotImplementedError

    def commit_child(self, changes: Dict[bytes, Optional[LedgerEntry]],
                     header: LedgerHeader,
                     blobs: Optional[Dict[bytes, bytes]] = None) -> None:
        """`blobs` optionally carries known-serialized forms of entries in
        `changes` (native-injected deltas) so roots can skip
        re-serializing them."""
        raise NotImplementedError


class LedgerTxn(AbstractLedgerTxnParent):
    """A nested transaction. Exactly one child may be open at a time."""

    def __init__(self, parent: AbstractLedgerTxnParent) -> None:
        self._parent = parent
        self._changes: Dict[bytes, Optional[LedgerEntry]] = {}
        self._previous: Dict[bytes, Optional[bytes]] = {}  # pre-images (xdr)
        # parsed pre-image snapshots (same instant as _previous): get_delta
        # reads these instead of re-parsing the blob — a structural copy at
        # record time is ~4x cheaper than LedgerEntry.from_xdr at delta
        # time, and the close path takes a delta per fee/op txn
        self._prev_objs: Dict[bytes, LedgerEntry] = {}
        # serialized forms of UNTOUCHED _changes values (native-injected
        # deltas): valid only while the parsed object has never been
        # handed to a mutator — every path that exposes a mutable entry
        # pops the key. get_delta/commit reuse these instead of
        # re-serializing
        self._cur_blobs: Dict[bytes, bytes] = {}
        self._header = _copy_header(parent.get_header())
        self._open = True
        self._child: Optional["LedgerTxn"] = None
        if isinstance(parent, LedgerTxn):
            assert parent._open, "parent is sealed"
        parent._register_child(self)

    # -- header -------------------------------------------------------------
    def load_header(self) -> LedgerHeader:
        self._assert_open()
        return self._header

    def get_header(self) -> LedgerHeader:
        return self._header

    # -- entry access -------------------------------------------------------
    def _assert_open(self) -> None:
        assert self._open, "LedgerTxn is closed"
        assert self._child is None, "child transaction is open"

    def get_entry(self, key: LedgerKey) -> Optional[LedgerEntry]:
        kb = _kb(key)
        if kb in self._changes:
            cur = self._changes[kb]
            if cur is not None:
                # the caller holds an aliased reference from here on; a
                # mutation through it must not leave a stale blob behind
                self._cur_blobs.pop(kb, None)
            return cur
        return self._parent.get_entry(key)

    def load(self, key: LedgerKey) -> Optional[LedgerEntry]:
        """Load for update: snapshots the pre-image, returns a mutable entry
        owned by this txn (None if absent)."""
        self._assert_open()
        kb = _kb(key)
        if kb in self._changes:
            cur = self._changes[kb]
            if cur is not None:
                self._cur_blobs.pop(kb, None)   # handing out a mutable ref
            return cur
        base = self._parent.get_entry(key)
        if base is None:
            return None
        mine = _copy_entry(base)
        if kb not in self._previous:
            self._previous[kb] = base.to_xdr()
            self._prev_objs[kb] = _copy_entry(base)
        self._changes[kb] = mine
        return mine

    def load_without_record(self, key: LedgerKey) -> Optional[LedgerEntry]:
        """Read-only peek (reference loadWithoutRecord): no delta recorded."""
        self._assert_open()
        e = self.get_entry(key)
        return _copy_entry(e) if e is not None else None

    def inject_native_changes(self, changes) -> None:
        """Install the apply engine's close-level delta
        (ledger/native_apply.py): `changes` is [(key_xdr, prev_xdr|None,
        cur_xdr|None)] in first-touch order, exactly what this txn's
        _previous/_changes would hold after the Python fee+apply phases.
        Entries parse once per close here instead of once per tx there."""
        self._assert_open()
        assert not self._changes, "native delta injected over live changes"
        for kb, prev_b, cur_b in changes:
            self._previous[kb] = prev_b
            if cur_b is None:
                self._changes[kb] = None
            else:
                self._changes[kb] = LedgerEntry.from_xdr(cur_b)
                self._cur_blobs[kb] = cur_b

    def create(self, entry: LedgerEntry) -> LedgerEntry:
        self._assert_open()
        key = ledger_entry_key(entry)
        kb = _kb(key)
        assert self.get_entry(key) is None, "entry already exists"
        mine = _copy_entry(entry)
        self._previous.setdefault(kb, None)
        self._changes[kb] = mine
        self._cur_blobs.pop(kb, None)
        return mine

    def _record_previous(self, kb: bytes) -> None:
        """Snapshot the parent-visible state of `kb` (blob + parsed)."""
        if kb in self._previous:
            return
        base = self._parent.get_entry(LedgerKey.from_xdr(kb))
        if base is None:
            self._previous[kb] = None
        else:
            self._previous[kb] = base.to_xdr()
            self._prev_objs[kb] = _copy_entry(base)

    def create_or_update_without_loading(self, entry: LedgerEntry) -> None:
        """Upsert with no existence check and no returned handle
        (reference createOrUpdateWithoutLoading, LedgerTxn.h: bulk-apply
        path). Still records the pre-image so deltas stay exact."""
        self._assert_open()
        key = ledger_entry_key(entry)
        kb = _kb(key)
        self._record_previous(kb)
        self._changes[kb] = _copy_entry(entry)
        self._cur_blobs.pop(kb, None)

    def erase(self, key: LedgerKey) -> None:
        self._assert_open()
        kb = _kb(key)
        existing = self.get_entry(key)
        assert existing is not None, "erasing missing entry"
        if kb not in self._previous:
            # `existing` is the parent's state here (anything recorded in
            # _changes implies _previous was already recorded)
            self._previous[kb] = existing.to_xdr()
            self._prev_objs[kb] = _copy_entry(existing)
        self._changes[kb] = None
        self._cur_blobs.pop(kb, None)

    def erase_without_loading(self, key: LedgerKey) -> None:
        """Delete with no existence check (reference eraseWithoutLoading):
        erasing an absent key is a no-op record of absence, not an error."""
        self._assert_open()
        kb = _kb(key)
        self._record_previous(kb)
        self._changes[kb] = None
        self._cur_blobs.pop(kb, None)

    # -- order book ---------------------------------------------------------
    def _all_offers_for_book(self, selling: Asset,
                             buying: Asset) -> Dict[bytes, LedgerEntry]:
        out = self._parent._all_offers_for_book(selling, buying)
        sb = (selling.to_xdr(), buying.to_xdr())
        for kb, e in self._changes.items():
            if LedgerKey.from_xdr(kb).disc != LedgerEntryType.OFFER:
                continue
            if e is None:
                out.pop(kb, None)
            else:
                o = e.data.value
                if (o.selling.to_xdr(), o.buying.to_xdr()) == sb:
                    out[kb] = e
                else:
                    out.pop(kb, None)
        return out

    def best_offer(self, selling: Asset, buying: Asset,
                   exclude: Optional[set] = None) -> Optional[LedgerEntry]:
        """Best (lowest-price) offer in the book, excluding offer ids in
        `exclude`."""
        self._assert_open()
        offers = self._all_offers_for_book(selling, buying)
        best: Optional[LedgerEntry] = None
        for e in offers.values():
            o = e.data.value
            if exclude and o.offerID in exclude:
                continue
            if best is None or price_less(o, best.data.value):
                best = e
        return best

    def _offers_by_account(self, account_id) -> Dict[bytes, LedgerEntry]:
        out = self._parent._offers_by_account(account_id)
        acc = account_id.to_xdr()
        for kb, e in self._changes.items():
            if LedgerKey.from_xdr(kb).disc != LedgerEntryType.OFFER:
                continue
            if e is None:
                out.pop(kb, None)
            elif e.data.value.sellerID.to_xdr() == acc:
                out[kb] = e
            else:
                out.pop(kb, None)
        return out

    def load_offers_by_account(self, account_id,
                               asset: Optional[Asset] = None
                               ) -> List[LedgerEntry]:
        """Load (for update) the account's offers; with `asset`, only
        offers buying or selling it (reference
        loadOffersByAccountAndAsset, LedgerTxn.h)."""
        self._assert_open()
        res = []
        for kb, view in list(self._offers_by_account(account_id).items()):
            if asset is not None:
                o = view.data.value
                # filter on the view BEFORE load(): non-matching offers
                # must not be copied or recorded in the delta
                if o.selling != asset and o.buying != asset:
                    continue
            e = self.load(LedgerKey.from_xdr(kb))
            if e is not None:
                res.append(e)
        return res

    def _all_offers(self) -> Dict[bytes, LedgerEntry]:
        out = self._parent._all_offers()
        for kb, e in self._changes.items():
            if LedgerKey.from_xdr(kb).disc != LedgerEntryType.OFFER:
                continue
            if e is None:
                out.pop(kb, None)
            else:
                out[kb] = e
        return out

    def load_all_offers(self) -> List[LedgerEntry]:
        """Load (for update) every offer in the ledger (reference
        loadAllOffers, LedgerTxn.h — liability-upgrade path)."""
        self._assert_open()
        res = []
        for kb in list(self._all_offers()):
            e = self.load(LedgerKey.from_xdr(kb))
            if e is not None:
                res.append(e)
        return res

    def query_inflation_winners(self, max_winners: int,
                                min_votes: int) -> List[Tuple[bytes, int]]:
        """[(accountID key_bytes, votes)] for inflation destinations with
        at least `min_votes` of balance-weighted votes, sorted votes
        descending (ties: account key descending), capped at
        `max_winners` (reference queryInflationWinners, LedgerTxn.cpp —
        including uncommitted changes in this txn chain, which the SQL
        root alone cannot see)."""
        self._assert_open()
        # innermost change wins: collect ancestor overlays root-first
        chain: List["LedgerTxn"] = []
        node: AbstractLedgerTxnParent = self
        while isinstance(node, LedgerTxn):
            chain.append(node)
            node = node._parent
        merged: Dict[bytes, Optional[LedgerEntry]] = dict(
            node._all_accounts())
        for txn in reversed(chain):
            for kb, e in txn._changes.items():
                if LedgerKey.from_xdr(kb).disc == LedgerEntryType.ACCOUNT:
                    merged[kb] = e
        votes: Dict[bytes, int] = {}
        for e in merged.values():
            if e is None:
                continue
            acc = e.data.value
            if acc.inflationDest is not None:
                k = acc.inflationDest.key_bytes
                votes[k] = votes.get(k, 0) + acc.balance
        winners = sorted(
            ((k, v) for k, v in votes.items() if v >= min_votes),
            key=lambda kv: (-kv[1], tuple(
                -c for c in strkey.encode_public_key(kv[0]).encode())))
        return winners[:max_winners]

    # -- lifecycle ----------------------------------------------------------
    def commit(self) -> None:
        self._assert_open()
        # seal only after commit_child succeeds: a transient failure there
        # (e.g. sqlite "database is locked" at the root) must leave this
        # txn open and registered so the caller can roll back — otherwise
        # the parent's child slot is bricked for every future txn
        self._parent.commit_child(self._changes, self._header,
                                  self._cur_blobs or None)
        self._open = False
        self._parent._clear_child(self)

    def rollback(self) -> None:
        assert self._open
        if self._child is not None:
            self._child.rollback()
        self._open = False
        self._changes.clear()
        self._prev_objs.clear()
        self._cur_blobs.clear()
        self._parent._clear_child(self)

    def commit_child(self, changes: Dict[bytes, Optional[LedgerEntry]],
                     header: LedgerHeader,
                     blobs: Optional[Dict[bytes, bytes]] = None) -> None:
        for kb, e in changes.items():
            self._record_previous(kb)
            b = blobs.get(kb) if (blobs and e is not None) else None
            if b is not None:
                self._cur_blobs[kb] = b
            else:
                self._cur_blobs.pop(kb, None)
            self._changes[kb] = e
        # adopt the child's header VALUES in place: callers hold references
        # from load_header(), and replacing the object would silently orphan
        # their later mutations (close_ledger sets txSetResultHash /
        # bucketListHash after per-tx child commits)
        new = _copy_header(header)
        for n, _t in type(self._header).xdr_fields:
            setattr(self._header, n, getattr(new, n))

    # -- delta (meta + invariants) ------------------------------------------
    def get_delta(self, need_prev: bool = True, raw_keys: bool = False
                  ) -> List[Tuple[LedgerKey, Optional[LedgerEntry],
                                  Optional[LedgerEntry]]]:
        """[(key, previous, current)] for every touched-and-changed entry.

        need_prev=False skips materializing the parsed pre-image for
        native-injected deltas (blob-only): `previous` is then the raw
        pre-image XDR for those entries — callers that only test
        `prev is None` (the close's init/live/dead split) must not read
        into it. Parsed pre-images recorded by load() are returned parsed
        either way.

        raw_keys=True returns the raw LedgerKey XDR instead of a parsed
        LedgerKey — the close path only needs key OBJECTS for deleted
        entries (bucket dead keys), so it parses those itself instead of
        paying ~one parse per touched account per close.

        The returned `current` entries are the LIVE _changes objects and
        must be treated READ-ONLY: unlike get_entry/load, this path does
        not invalidate _cur_blobs, so a caller mutating an entry through
        the delta would desynchronize the cached serialized form the
        commit path reuses."""
        out = []
        for kb, cur in self._changes.items():
            prev_b = self._previous.get(kb)
            if cur is None:
                cur_b = None
            else:
                cur_b = self._cur_blobs.get(kb)
                if cur_b is None:
                    cur_b = cur.to_xdr()
            if prev_b == cur_b:
                continue  # touched but unchanged
            if prev_b:
                prev = self._prev_objs.get(kb)
                if prev is None:   # injected native delta: blob only
                    prev = prev_b if not need_prev \
                        else LedgerEntry.from_xdr(prev_b)
            else:
                prev = None
            key = kb if raw_keys else LedgerKey.from_xdr(kb)
            out.append((key, prev, cur))
        return out

    def has_changes(self) -> bool:
        return bool(self._changes)

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if self._open:
            if et is None:
                self.commit()
            else:
                self.rollback()
        return False


class InMemoryLedgerTxnRoot(AbstractLedgerTxnParent):
    """Dict-backed root (reference InMemoryLedgerTxnRoot.h role; used by
    standalone/test mode)."""

    def __init__(self, header: Optional[LedgerHeader] = None) -> None:
        self._entries: Dict[bytes, bytes] = {}
        self._header = header

    def set_header(self, header: LedgerHeader) -> None:
        self._header = header

    def get_header(self) -> LedgerHeader:
        assert self._header is not None
        return self._header

    def get_entry(self, key: LedgerKey) -> Optional[LedgerEntry]:
        b = self._entries.get(_kb(key))
        return LedgerEntry.from_xdr(b) if b is not None else None

    def _all_offers_for_book(self, selling, buying):
        out: Dict[bytes, LedgerEntry] = {}
        sb = (selling.to_xdr(), buying.to_xdr())
        for kb, eb in self._entries.items():
            if LedgerKey.from_xdr(kb).disc != LedgerEntryType.OFFER:
                continue
            e = LedgerEntry.from_xdr(eb)
            o = e.data.value
            if (o.selling.to_xdr(), o.buying.to_xdr()) == sb:
                out[kb] = e
        return out

    def _offers_by_account(self, account_id):
        out: Dict[bytes, LedgerEntry] = {}
        acc = account_id.to_xdr()
        for kb, eb in self._entries.items():
            if LedgerKey.from_xdr(kb).disc != LedgerEntryType.OFFER:
                continue
            e = LedgerEntry.from_xdr(eb)
            if e.data.value.sellerID.to_xdr() == acc:
                out[kb] = e
        return out

    def get_entry_blob(self, kb: bytes) -> Optional[bytes]:
        """Raw LedgerEntry XDR by key XDR — the native apply engine's
        lookup callback (no parse, no copy)."""
        return self._entries.get(kb)

    def offers_for_book_blobs(self, selling_xdr: bytes,
                              buying_xdr: bytes) -> List[bytes]:
        """Raw offer-entry blobs for one (selling, buying) book — the
        native engine's `book` callback. The engine merges its own
        overlay (created/modified/erased offers) on top; this returns
        only close-start root state."""
        out: List[bytes] = []
        for kb, eb in self._entries.items():
            if LedgerKey.from_xdr(kb).disc != LedgerEntryType.OFFER:
                continue
            e = LedgerEntry.from_xdr(eb)
            o = e.data.value
            if o.selling.to_xdr() == selling_xdr and \
                    o.buying.to_xdr() == buying_xdr:
                out.append(eb)
        return out

    def offers_by_account_blobs(self, account_key: bytes) -> List[bytes]:
        """Raw offer-entry blobs of one seller (ed25519 key bytes) —
        the native engine's `acct_offers` callback (allow-trust
        revokes). Root order matches `_offers_by_account`, so the
        engine's merged iteration order equals the Python path's."""
        out: List[bytes] = []
        for kb, eb in self._entries.items():
            if LedgerKey.from_xdr(kb).disc != LedgerEntryType.OFFER:
                continue
            e = LedgerEntry.from_xdr(eb)
            if e.data.value.sellerID.key_bytes == account_key:
                out.append(eb)
        return out

    def _all_offers_for_book(self, selling, buying):
        out: Dict[bytes, LedgerEntry] = {}
        sb = (selling.to_xdr(), buying.to_xdr())
        for kb, eb in self._entries.items():
            if LedgerKey.from_xdr(kb).disc != LedgerEntryType.OFFER:
                continue
            e = LedgerEntry.from_xdr(eb)
            o = e.data.value
            if (o.selling.to_xdr(), o.buying.to_xdr()) == sb:
                out[kb] = e
        return out

    def _offers_by_account(self, account_id):
        out: Dict[bytes, LedgerEntry] = {}
        acc = account_id.to_xdr()
        for kb, eb in self._entries.items():
            if LedgerKey.from_xdr(kb).disc != LedgerEntryType.OFFER:
                continue
            e = LedgerEntry.from_xdr(eb)
            if e.data.value.sellerID.to_xdr() == acc:
                out[kb] = e
        return out

    def _all_offers(self):
        out: Dict[bytes, LedgerEntry] = {}
        for kb, eb in self._entries.items():
            if LedgerKey.from_xdr(kb).disc == LedgerEntryType.OFFER:
                out[kb] = LedgerEntry.from_xdr(eb)
        return out

    def _all_accounts(self):
        out: Dict[bytes, LedgerEntry] = {}
        for kb, eb in self._entries.items():
            if LedgerKey.from_xdr(kb).disc == LedgerEntryType.ACCOUNT:
                out[kb] = LedgerEntry.from_xdr(eb)
        return out

    def commit_child(self, changes, header, blobs=None) -> None:
        for kb, e in changes.items():
            if e is None:
                self._entries.pop(kb, None)
            else:
                b = blobs.get(kb) if blobs else None
                self._entries[kb] = b if b is not None else e.to_xdr()
        self._header = header

    def count_entries(self) -> int:
        return len(self._entries)

    def all_entries(self) -> Iterator[LedgerEntry]:
        for eb in self._entries.values():
            yield LedgerEntry.from_xdr(eb)

    def clear_entries(self) -> None:
        """Drop all ledger entries (bucket-apply catchup resets state
        before loading the snapshot)."""
        self._entries.clear()


_ENTRY_TYPE_NAMES = {
    LedgerEntryType.ACCOUNT: "account",
    LedgerEntryType.TRUSTLINE: "trustline",
    LedgerEntryType.OFFER: "offer",
    LedgerEntryType.DATA: "data",
}


class LedgerTxnRoot(AbstractLedgerTxnParent):
    """SQL-backed root with an entry cache and per-type bulk writers
    (reference LedgerTxnRoot + LedgerTxn{Account,Offer,TrustLine,Data}SQL).

    BucketDB routing: with a BucketDB
    attached (`attach_bucketdb`), point reads that miss the entry cache
    are served from the bloom-filtered bucket indexes instead of SQL —
    SQL stays the write-behind query index (bulk order-book scans,
    history, operator queries) and is only consulted for point reads
    when a `bucketdb.read-fail` degrade makes a bucket read
    non-authoritative. The entry cache itself is a true-LRU bound
    whose evictions are metered, and the prefetch
    bulk-warm resolves a whole txset's keys in one batched pass per
    bucket level.

    `stats` (ledger/apply_stats.py ApplyStats) is the close cockpit's
    state-read telemetry: per-type SQL point lookups, entry-cache
    hit/miss/eviction, bucket-served reads, prefetch coverage and
    hit-rate (reference getPrefetchHitRate parity), bulk-scan row
    counts. Every hook is a no-op when no stats object is wired (tests,
    standalone tools)."""

    ENTRY_CACHE_SIZE = 4096

    def __init__(self, db: Database,
                 header: Optional[LedgerHeader] = None,
                 stats=None) -> None:
        self._db = db
        self._header = header
        self._cache: LRUCache = LRUCache(self.ENTRY_CACHE_SIZE,
                                         on_evict=self._on_cache_evict)
        self._stats = stats
        self._bucketdb = None
        # keys warmed by prefetch(): a later cache-hit on one counts as a
        # prefetch hit, a fallthrough load counts as a prefetch miss
        # (reference LedgerTxnRoot::getPrefetchHitRate). LRU-bounded at a
        # few multiples of the cache it describes — evicting the oldest
        # keys one by one instead of clearing wholesale (the old
        # bounded-set half-cache budget degraded to silent coverage loss
        # exactly when hot state outgrew it).
        self._prefetched: "OrderedDict[bytes, bool]" = OrderedDict()

    def set_header(self, header: LedgerHeader) -> None:
        self._header = header

    def get_header(self) -> LedgerHeader:
        assert self._header is not None
        return self._header

    # -- BucketDB attachment -------------------------------------------------
    def attach_bucketdb(self, bucketdb) -> None:
        """Route point reads through `bucketdb` (bucket/bucket_index.py).
        Only valid while the bucket list covers this root's entire
        entry state (enabled-before-genesis, or restored from a HAS
        that matches the LCL header) — Application.enable_buckets and
        LedgerManager enforce that."""
        self._bucketdb = bucketdb

    def detach_bucketdb(self) -> None:
        """Fall back to SQL point reads (bucket-list restore failed or
        the list is otherwise not authoritative for this state)."""
        self._bucketdb = None

    def bucket_backed(self) -> bool:
        return self._bucketdb is not None

    # -- reads --------------------------------------------------------------
    def _on_cache_evict(self) -> None:
        if self._stats is not None:
            self._stats.record_cache_evictions()

    def _note_prefetched(self, kb: bytes) -> None:
        pf = self._prefetched
        pf[kb] = True
        pf.move_to_end(kb)
        while len(pf) > 4 * self.ENTRY_CACHE_SIZE:
            pf.popitem(last=False)

    def _load_blob(self, key: Optional[LedgerKey], kb: bytes
                   ) -> Tuple[Optional[bytes], str, Optional[LedgerKey]]:
        """One cache-missing point read: (blob|None, serving source,
        parsed key | None). BucketDB first when attached; SQL only when
        no BucketDB is attached or the bucket read degraded
        (`bucketdb.read-fail`). The key is parsed at most once — it is
        returned so the caller can name the entry type for the SQL
        lookup meters without re-parsing."""
        bdb = self._bucketdb
        if bdb is not None:
            served, blob = bdb.lookup(kb)
            if served:
                return blob, "bucket", key
        if key is None:
            key = LedgerKey.from_xdr(kb)
        return self._select_blob(key), "sql", key

    def get_entry(self, key: LedgerKey) -> Optional[LedgerEntry]:
        kb = _kb(key)
        hit = self._cache.maybe_get(kb)
        st = self._stats
        if hit is not None:
            blob = hit
            if st is not None:
                st.record_read(True, kb in self._prefetched)
        else:
            blob, source, _key = self._load_blob(key, kb)
            self._cache.put(kb, blob if blob is not None else b"")
            if st is not None:
                st.record_read(False, False,
                               _ENTRY_TYPE_NAMES.get(key.disc, "unknown"),
                               source=source)
        if not blob:
            return None
        return LedgerEntry.from_xdr(blob)

    def get_entry_blob(self, kb: bytes) -> Optional[bytes]:
        """Raw LedgerEntry XDR by key XDR, through the entry cache — the
        apply engine's lookup callback."""
        hit = self._cache.maybe_get(kb)
        st = self._stats
        if hit is not None:
            if st is not None:
                st.record_read(True, kb in self._prefetched)
            return hit or None
        blob, source, pkey = self._load_blob(None, kb)
        self._cache.put(kb, blob if blob is not None else b"")
        if st is not None:
            # the key parse is only needed to NAME a SQL lookup's entry
            # type; bucket-served reads never parse it at all (this is
            # the apply engine's per-entry hot path), and the SQL path
            # reuses _load_blob's parse
            etype = None if pkey is None else \
                _ENTRY_TYPE_NAMES.get(pkey.disc, "unknown")
            st.record_read(False, False, etype, source=source)
        return blob

    def offers_for_book_blobs(self, selling_xdr: bytes,
                              buying_xdr: bytes) -> List[bytes]:
        """Raw offer blobs for one book (the apply engine's `book`
        callback); the same SQL the Python path's `_all_offers_for_book`
        runs, counted into the same bulk-scan telemetry."""
        import base64
        cur = self._db.execute(
            "SELECT entry FROM offers WHERE selling=? AND buying=?",
            (base64.b64encode(selling_xdr).decode(),
             base64.b64encode(buying_xdr).decode()))
        return [blob for (blob,) in self._record_scan(cur.fetchall())]

    def offers_by_account_blobs(self, account_key: bytes) -> List[bytes]:
        """Raw offer blobs of one seller (ed25519 key bytes) — the apply
        engine's `acct_offers` callback. Row order (the seller index →
        offerid) matches `_offers_by_account`, so the engine's merged
        iteration order equals the Python path's."""
        from ..xdr import PublicKey
        cur = self._db.execute(
            "SELECT entry FROM offers WHERE sellerid=?",
            (_acc_str(PublicKey.ed25519(account_key)),))
        return [blob for (blob,) in self._record_scan(cur.fetchall())]

    def _select_blob(self, key: LedgerKey) -> Optional[bytes]:
        t = key.disc
        v = key.value
        if t == LedgerEntryType.ACCOUNT:
            cur = self._db.execute(
                "SELECT entry FROM accounts WHERE accountid=?",
                (_acc_str(v.accountID),))
        elif t == LedgerEntryType.TRUSTLINE:
            cur = self._db.execute(
                "SELECT entry FROM trustlines WHERE accountid=? AND asset=?",
                (_acc_str(v.accountID), _asset_str(v.asset)))
        elif t == LedgerEntryType.OFFER:
            cur = self._db.execute(
                "SELECT entry FROM offers WHERE offerid=?", (v.offerID,))
        elif t == LedgerEntryType.DATA:
            cur = self._db.execute(
                "SELECT entry FROM accountdata WHERE accountid=? AND "
                "dataname=?", (_acc_str(v.accountID), v.dataName))
        else:
            raise ValueError("bad key type %d" % t)
        row = cur.fetchone()
        return row[0] if row else None

    def _record_scan(self, rows) -> list:
        if self._stats is not None:
            self._stats.record_bulk_scan(len(rows))
        return rows

    def _all_offers_for_book(self, selling, buying):
        out: Dict[bytes, LedgerEntry] = {}
        cur = self._db.execute(
            "SELECT entry FROM offers WHERE selling=? AND buying=?",
            (_asset_str(selling), _asset_str(buying)))
        for (blob,) in self._record_scan(cur.fetchall()):
            e = LedgerEntry.from_xdr(blob)
            out[_kb(ledger_entry_key(e))] = e
        return out

    def _offers_by_account(self, account_id):
        out: Dict[bytes, LedgerEntry] = {}
        cur = self._db.execute(
            "SELECT entry FROM offers WHERE sellerid=?",
            (_acc_str(account_id),))
        for (blob,) in self._record_scan(cur.fetchall()):
            e = LedgerEntry.from_xdr(blob)
            out[_kb(ledger_entry_key(e))] = e
        return out

    def _all_offers(self):
        out: Dict[bytes, LedgerEntry] = {}
        for (blob,) in self._record_scan(self._db.execute(
                "SELECT entry FROM offers").fetchall()):
            e = LedgerEntry.from_xdr(blob)
            out[_kb(ledger_entry_key(e))] = e
        return out

    def _all_accounts(self):
        out: Dict[bytes, LedgerEntry] = {}
        for (blob,) in self._record_scan(self._db.execute(
                "SELECT entry FROM accounts").fetchall()):
            e = LedgerEntry.from_xdr(blob)
            out[_kb(ledger_entry_key(e))] = e
        return out

    def prefetch(self, keys) -> int:
        """Bulk-warm the entry cache for `keys`; returns how many were
        actually cached (reference LedgerTxnRoot::prefetch,
        LedgerTxn.cpp — stops loading when the cache is half full so
        prefetch can't evict the working set). Coverage — keys resident
        afterwards (already warm + newly loaded) over keys requested —
        feeds `ledger.apply.prefetch.coverage-pct`; later root reads of
        prefetched keys count into the getPrefetchHitRate-parity
        hit/miss meters.

        With a BucketDB attached, the cold keys resolve in ONE batched
        pass per bucket level (bloom-filtered, newest-level-first —
        bucket/bucket_index.py prefetch_batch) instead of one multi-level
        walk per key; the warmed cache then feeds the apply engine its
        entry blobs directly through `get_entry_blob`."""
        budget = self._cache._max // 2
        n = 0
        requested = 0
        covered = 0
        note = self._stats is not None
        loads: Dict[str, int] = {}
        bucket_loads = 0
        # pass 1: split warm keys from cold ones; cold collection stops
        # at the half-cache budget (remaining keys only count coverage,
        # exactly like the old per-key walk)
        room = max(0, budget - len(self._cache))
        cold: List[Tuple[LedgerKey, bytes]] = []
        for key in keys:
            requested += 1
            kb = _kb(key)
            if self._cache.maybe_get(kb) is not None:
                covered += 1
                if note:
                    self._note_prefetched(kb)
                continue
            if len(cold) >= room:
                continue   # over budget: keep counting coverage only
            cold.append((key, kb))
        # pass 2: resolve every cold key — one batched BucketDB pass per
        # level when attached, per-key SQL otherwise (or on degrade)
        resolved: Dict[bytes, Optional[bytes]] = {}
        bdb = self._bucketdb
        if bdb is not None and cold:
            served, resolved = bdb.prefetch_batch([kb for _k, kb in cold])
            if not served:
                resolved = {}   # degraded: fall back to per-key SQL
        for key, kb in cold:
            if kb in resolved:
                blob = resolved[kb]
                bucket_loads += 1
            else:
                blob = self._select_blob(key)
                if note:
                    name = _ENTRY_TYPE_NAMES.get(key.disc, "unknown")
                    loads[name] = loads.get(name, 0) + 1
            self._cache.put(kb, blob if blob is not None else b"")
            if note:
                self._note_prefetched(kb)
            n += 1
            covered += 1
        if self._stats is not None:
            self._stats.record_prefetch(requested, covered, loads,
                                        bucket_loads=bucket_loads)
        return n

    def clear_entries(self) -> None:
        """Drop all ledger entries + cache (bucket-apply catchup resets
        state before loading the snapshot)."""
        with self._db.transaction():
            for table in ("accounts", "trustlines", "offers",
                          "accountdata"):
                self._db.execute("DELETE FROM %s" % table)
        self._cache.clear()

    # -- commit -------------------------------------------------------------
    def commit_child(self, changes, header, blobs=None) -> None:
        with self._db.transaction():
            for kb, e in changes.items():
                key = LedgerKey.from_xdr(kb)
                if e is None:
                    self._delete(key)
                    self._cache.put(kb, b"")
                else:
                    b = blobs.get(kb) if blobs else None
                    if b is None:
                        b = e.to_xdr()
                    self._upsert(key, e, b)
                    self._cache.put(kb, b)
            self._header = header

    def _delete(self, key: LedgerKey) -> None:
        t, v = key.disc, key.value
        if t == LedgerEntryType.ACCOUNT:
            self._db.execute("DELETE FROM accounts WHERE accountid=?",
                             (_acc_str(v.accountID),))
        elif t == LedgerEntryType.TRUSTLINE:
            self._db.execute(
                "DELETE FROM trustlines WHERE accountid=? AND asset=?",
                (_acc_str(v.accountID), _asset_str(v.asset)))
        elif t == LedgerEntryType.OFFER:
            self._db.execute("DELETE FROM offers WHERE offerid=?",
                             (v.offerID,))
        elif t == LedgerEntryType.DATA:
            self._db.execute(
                "DELETE FROM accountdata WHERE accountid=? AND dataname=?",
                (_acc_str(v.accountID), v.dataName))

    def _upsert(self, key: LedgerKey, e: LedgerEntry,
                blob: Optional[bytes] = None) -> None:
        t = key.disc
        if blob is None:
            blob = e.to_xdr()
        lm = e.lastModifiedLedgerSeq
        d = e.data.value
        if t == LedgerEntryType.ACCOUNT:
            self._db.execute(
                "INSERT INTO accounts (accountid,balance,seqnum,"
                "numsubentries,flags,lastmodified,entry) VALUES (?,?,?,?,?,?,?)"
                " ON CONFLICT(accountid) DO UPDATE SET balance=excluded."
                "balance,seqnum=excluded.seqnum,numsubentries=excluded."
                "numsubentries,flags=excluded.flags,lastmodified=excluded."
                "lastmodified,entry=excluded.entry",
                (_acc_str(d.accountID), d.balance, d.seqNum, d.numSubEntries,
                 d.flags, lm, blob))
        elif t == LedgerEntryType.TRUSTLINE:
            self._db.execute(
                "INSERT INTO trustlines (accountid,asset,balance,flags,"
                "lastmodified,entry) VALUES (?,?,?,?,?,?)"
                " ON CONFLICT(accountid,asset) DO UPDATE SET balance="
                "excluded.balance,flags=excluded.flags,lastmodified="
                "excluded.lastmodified,entry=excluded.entry",
                (_acc_str(d.accountID), _asset_str(d.asset), d.balance,
                 d.flags, lm, blob))
        elif t == LedgerEntryType.OFFER:
            self._db.execute(
                "INSERT INTO offers (sellerid,offerid,selling,buying,amount,"
                "pricen,priced,price,flags,lastmodified,entry) "
                "VALUES (?,?,?,?,?,?,?,?,?,?,?)"
                " ON CONFLICT(offerid) DO UPDATE SET sellerid=excluded."
                "sellerid,selling=excluded.selling,buying=excluded.buying,"
                "amount=excluded.amount,pricen=excluded.pricen,priced="
                "excluded.priced,price=excluded.price,flags=excluded.flags,"
                "lastmodified=excluded.lastmodified,entry=excluded.entry",
                (_acc_str(d.sellerID), d.offerID, _asset_str(d.selling),
                 _asset_str(d.buying), d.amount, d.price.n, d.price.d,
                 d.price.n / d.price.d, d.flags, lm, blob))
        elif t == LedgerEntryType.DATA:
            self._db.execute(
                "INSERT INTO accountdata (accountid,dataname,lastmodified,"
                "entry) VALUES (?,?,?,?)"
                " ON CONFLICT(accountid,dataname) DO UPDATE SET lastmodified"
                "=excluded.lastmodified,entry=excluded.entry",
                (_acc_str(d.accountID), d.dataName, lm, blob))

    def count_entries(self) -> int:
        n = 0
        for table in ("accounts", "trustlines", "offers", "accountdata"):
            n += self._db.execute(
                "SELECT COUNT(*) FROM %s" % table).fetchone()[0]
        return n

    def all_entries(self) -> Iterator[LedgerEntry]:
        for table in ("accounts", "trustlines", "offers", "accountdata"):
            for (blob,) in self._db.execute(
                    "SELECT entry FROM %s" % table).fetchall():
                yield LedgerEntry.from_xdr(blob)


def delta_to_changes(delta) -> list:
    """LedgerTxn delta triples → LedgerEntryChanges wire form (reference
    meta convention: CREATED alone; STATE pre-image before
    UPDATED/REMOVED). Feeds TransactionMeta and txfeehistory rows."""
    from ..xdr import LedgerEntryChange, LedgerEntryChangeType as CT
    out = []
    for key, prev, cur in delta:
        if prev is None and cur is not None:
            out.append(LedgerEntryChange(CT.LEDGER_ENTRY_CREATED, cur))
        elif cur is None:
            out.append(LedgerEntryChange(CT.LEDGER_ENTRY_STATE, prev))
            out.append(LedgerEntryChange(CT.LEDGER_ENTRY_REMOVED, key))
        else:
            out.append(LedgerEntryChange(CT.LEDGER_ENTRY_STATE, prev))
            out.append(LedgerEntryChange(CT.LEDGER_ENTRY_UPDATED, cur))
    return out
