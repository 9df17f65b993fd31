"""Bucket entries as the state commitment hashes them, for drains at scale.

This module writes the XDR of a protocol-13 `BucketEntry` (LIVEENTRY) for
the four ledger entry kinds with a small hand-written encoder (RFC 4506:
big-endian 4-byte words, strings and opaques padded to 4 bytes), which
fills a million bodies from numpy arrays in well under a second. The
layouts follow `stellar_core_tpu/xdr/ledger_entries.py` and `xdr/ledger.py`
at commit ada2c73; `tests/test_torch_state_commitment.py` holds every body
here byte for byte against that codec and against the port's copy of it
(`stellar_core_tpu_torch.xdr`). `bucket_entries` turns bodies into the
port's `BucketEntry` objects through that copy, and `canonical_order`
sorts bodies into a bucket's entry order without decoding them.

Scalar fields are fixed values (below); every 32-byte key field (account
IDs, issuers, signer keys, the data value) is a slot that the bulk
generator fills from a seeded numpy generator. The entry sizes are the
codec's; the mix of `entry_records` is an assumption with no published
source behind it: 60 % accounts with no signers and no home domain, 25 %
trustlines to a 4-character asset, 10 % offers selling such an asset for
the native one, 4 % data entries with a 32-byte value, 1 % accounts with
1-20 signers (20 is the protocol's most, signer counts uniform). It drives
a smoke run; a benchmark cell needs a mix measured on a real ledger.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..xdr import BucketEntry

LIVEENTRY = 0
ACCOUNT, TRUSTLINE, OFFER, DATA = 0, 1, 2, 3
ASSET_NATIVE, ASSET_ALPHANUM4 = 0, 1
MAX_SIGNERS = 20

# the fixed scalar fields
LAST_MODIFIED = 1_000_000
BALANCE = 10 ** 10
SEQ_NUM = 4_294_967_296
LIMIT = 2 ** 63 - 1
OFFER_ID = 123_456
AMOUNT = 5 * 10 ** 7
PRICE = (3, 7)
ASSET_CODE = b"USDC"
DATA_NAME = b"config"
THRESHOLDS = bytes([1, 0, 0, 0])

KINDS = ("account", "trustline", "offer", "data", "account_signers")
MIX = (0.60, 0.25, 0.10, 0.04, 0.01)


class _Xdr:
    """Appends XDR items; `key()` leaves a 32-byte slot and records its
    offset."""

    def __init__(self) -> None:
        self.buf = bytearray()
        self.slots: List[int] = []

    def u32(self, v: int) -> None:
        self.buf += struct.pack(">I", v)

    def i64(self, v: int) -> None:
        self.buf += struct.pack(">q", v)

    def var(self, data: bytes) -> None:
        self.u32(len(data))
        self.buf += data + b"\x00" * (-len(data) % 4)

    def key(self, data: bytes) -> None:
        self.slots.append(len(self.buf))
        self.buf += data

    def account_id(self, key: bytes) -> None:
        self.u32(0)                       # PUBLIC_KEY_TYPE_ED25519
        self.key(key)

    def asset4(self, issuer: bytes) -> None:
        self.u32(ASSET_ALPHANUM4)
        self.buf += ASSET_CODE
        self.account_id(issuer)


def _entry(kind: int, keys: Sequence[bytes], n_signers: int = 0
           ) -> Tuple[bytes, List[int]]:
    """(BucketEntry XDR body, offsets of its 32-byte key slots)."""
    keys = list(keys)
    x = _Xdr()
    x.u32(LIVEENTRY)
    x.u32(LAST_MODIFIED)
    x.u32(kind)
    if kind == ACCOUNT:
        x.account_id(keys.pop(0))
        x.i64(BALANCE)
        x.i64(SEQ_NUM)
        x.u32(n_signers)                  # numSubEntries
        x.u32(0)                          # inflationDest: absent
        x.u32(0)                          # flags
        x.var(b"")                        # homeDomain
        x.buf += THRESHOLDS
        x.u32(n_signers)
        for _ in range(n_signers):
            x.u32(0)                      # SIGNER_KEY_TYPE_ED25519
            x.key(keys.pop(0))
            x.u32(1)                      # weight
    elif kind == TRUSTLINE:
        x.account_id(keys.pop(0))
        x.asset4(keys.pop(0))
        x.i64(BALANCE)
        x.i64(LIMIT)
        x.u32(1)                          # AUTHORIZED_FLAG
    elif kind == OFFER:
        x.account_id(keys.pop(0))
        x.i64(OFFER_ID)
        x.asset4(keys.pop(0))             # selling
        x.u32(ASSET_NATIVE)               # buying
        x.i64(AMOUNT)
        x.u32(PRICE[0])
        x.u32(PRICE[1])
        x.u32(0)                          # flags
    elif kind == DATA:
        x.account_id(keys.pop(0))
        x.var(DATA_NAME)
        x.u32(32)
        x.key(keys.pop(0))                # dataValue
    else:
        raise ValueError("unknown ledger entry type %r" % kind)
    x.u32(0)                              # the entry's ext
    x.u32(0)                              # LedgerEntry ext
    assert not keys, "unused keys"
    return bytes(x.buf), x.slots


def n_keys(kind: str, n_signers: int = 0) -> int:
    """How many 32-byte keys a body of `kind` takes."""
    return {"account": 1, "trustline": 2, "offer": 2, "data": 2,
            "account_signers": 1 + n_signers}[kind]


def _body(kind: str, keys: Sequence[bytes], n_signers: int = 0
          ) -> Tuple[bytes, List[int]]:
    if kind == "account_signers":
        if not 1 <= n_signers <= MAX_SIGNERS:
            raise ValueError("an account holds 1-%d signers" % MAX_SIGNERS)
        return _entry(ACCOUNT, keys, n_signers)
    return _entry({"account": ACCOUNT, "trustline": TRUSTLINE,
                   "offer": OFFER, "data": DATA}[kind], keys)


def entry_body(kind: str, keys: Sequence[bytes], n_signers: int = 0
               ) -> bytes:
    """The XDR body of one bucket entry of `kind` (see KINDS) with the
    given 32-byte keys; "account_signers" takes `n_signers` signer keys."""
    return _body(kind, keys, n_signers)[0]


def _template(kind: str, n_signers: int = 0) -> Tuple[bytes, List[int]]:
    return _body(kind, [b"\x00" * 32] * n_keys(kind, n_signers), n_signers)


def leaf_lengths() -> Dict[str, object]:
    """Leaf length (1-byte prefix + body) of each kind; for
    "account_signers" a dict by signer count."""
    out: Dict[str, object] = {
        k: 1 + len(_template(k)[0]) for k in KINDS[:4]}
    out["account_signers"] = {
        s: 1 + len(_template("account_signers", s)[0])
        for s in range(1, MAX_SIGNERS + 1)}
    return out


def entry_records(rng: np.random.Generator, n: int) -> List[bytes]:
    """n bucket-entry XDR bodies in the module's mix, in a random order,
    with every key slot filled from `rng`."""
    kind = rng.choice(len(KINDS), size=n, p=MIX)
    signers = rng.integers(1, MAX_SIGNERS + 1, size=n)
    signers[kind != KINDS.index("account_signers")] = 0
    out: List[bytes] = [b""] * n
    for k in range(len(KINDS)):
        for s in np.unique(signers[kind == k]):
            idx = np.nonzero((kind == k) & (signers == s))[0]
            body, slots = _template(KINDS[k], int(s))
            size = len(body)
            arr = np.tile(np.frombuffer(body, np.uint8), (len(idx), 1))
            for off in slots:
                arr[:, off:off + 32] = rng.integers(
                    0, 256, (len(idx), 32), dtype=np.uint8)
            blob = arr.tobytes()
            for j, i in enumerate(idx.tolist()):
                out[i] = blob[j * size:(j + 1) * size]
    return out


# A body's identity prefix: the LedgerEntryData discriminant (the entry
# type) and the first field of every kind, its account ID as XDR (4-byte
# key type + 32 bytes). With distinct account IDs the bucket order
# (bucket.bucket_entry_sort_key: type, then account ID, then the kind's
# other fields) is the byte order of this prefix.
ID_START, ID_END = 8, 48


def canonical_order(records: Sequence[bytes]) -> np.ndarray:
    """Indices that put `records` (bodies of this module) in the bucket
    list's canonical entry order, by one numpy sort of their identity
    prefixes. Raises ValueError if two bodies share an account ID within
    one type (then the prefix does not decide the order)."""
    ids = np.frombuffer(b"".join(r[ID_START:ID_END] for r in records),
                        dtype="S%d" % (ID_END - ID_START))
    order = np.argsort(ids, kind="stable")
    s = ids[order]
    if len(s) > 1 and bool((s[1:] == s[:-1]).any()):
        raise ValueError("two entries share a type and an account ID")
    return order


def bucket_entries(records: Sequence[bytes]) -> list:
    """The port's `BucketEntry` objects of these bodies, each decoded by
    the port's XDR codec."""
    return [BucketEntry.from_xdr(r) for r in records]
