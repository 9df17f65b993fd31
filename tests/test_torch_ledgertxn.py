"""The port's LedgerTxn (`stellar_core_tpu_torch/ledger/ledgertxn.py`) held
against the JAX package's.

Two parts:

- every case of `tests/test_ledgertxn.py`, run on the port: the module's
  source with its imports pointed at `stellar_core_tpu_torch`, over the
  in-memory root and the SQL root (sqlite `:memory:`), as the reference
  runs them;
- a seeded random sequence of nested create / load-and-modify / erase /
  commit / rollback over accounts, trust lines, offers and data entries,
  applied step for step to both packages over both roots: after every
  commit the deltas (key, pre-image, current, as XDR) are equal, and at
  the end so are the roots' entries and headers. No tolerance: the bytes
  must match.
"""

import inspect

import numpy as np
import pytest

import stellar_core_tpu.xdr as RX
import stellar_core_tpu_torch.xdr as PX
from stellar_core_tpu.database.database import Database as RDatabase
from stellar_core_tpu.ledger import ledgertxn as RL
from stellar_core_tpu_torch.database.database import Database as PDatabase
from stellar_core_tpu_torch.ledger import ledgertxn as PL

from torch_mirror_harness import port_cases

CASES = port_cases("test_ledgertxn.py")
ROOT_CASES = sorted(n for n in dir(CASES) if n.startswith("test_")
                    and "root" in inspect.signature(getattr(CASES, n))
                    .parameters)
PLAIN_CASES = sorted(n for n in dir(CASES) if n.startswith("test_")
                     and n not in ROOT_CASES)


def _root(L, D, X, kind: str):
    header = CASES.make_header() if X is PX else _ref_header()
    if kind == "memory":
        return L.InMemoryLedgerTxnRoot(header)
    return L.LedgerTxnRoot(D(":memory:"), header)


def _ref_header():
    return RX.LedgerHeader.from_xdr(CASES.make_header().to_xdr())


def test_reference_cases_collected():
    assert len(ROOT_CASES) >= 14 and PLAIN_CASES == [
        "test_bulk_commit_round_trips_sql"]


@pytest.mark.parametrize("kind", ["memory", "sql"])
@pytest.mark.parametrize("name", ROOT_CASES)
def test_reference_case(name, kind):
    getattr(CASES, name)(_root(PL, PDatabase, PX, kind))


@pytest.mark.parametrize("name", PLAIN_CASES)
def test_reference_case_plain(name):
    getattr(CASES, name)()


# -- the seeded random sequence, both packages step for step ---------------

ACCOUNTS = 12
STEPS = 400


def _entry(X, rng_vals: tuple):
    """One ledger entry of the package `X` from drawn integers: an
    account, a trust line, an offer or a data entry of account `a`."""
    kind, a, b, amount, seq = rng_vals
    acc = X.PublicKey.ed25519(bytes([a + 1] * 32))
    issuer = X.PublicKey.ed25519(bytes([200 + b % 3] * 32))
    usd = X.Asset.credit("USD", issuer)
    if kind == 0:
        body = X.AccountEntry(
            accountID=acc, balance=amount, seqNum=seq, numSubEntries=0,
            inflationDest=None, flags=0, homeDomain="",
            thresholds=b"\x01\x00\x00\x00", signers=[],
            ext=X.AccountEntryExt.v0())
        data = X.LedgerEntryData(X.LedgerEntryType.ACCOUNT, body)
    elif kind == 1:
        body = X.TrustLineEntry(accountID=acc, asset=usd, balance=amount,
                                limit=10 ** 15, flags=1,
                                ext=X.TrustLineEntryExt.v0())
        data = X.LedgerEntryData(X.LedgerEntryType.TRUSTLINE, body)
    elif kind == 2:
        body = X.OfferEntry(sellerID=acc, offerID=1 + b, selling=usd,
                            buying=X.Asset.native(), amount=amount,
                            price=X.Price(n=1 + b, d=1 + a), flags=0,
                            ext=X._Ext.v0())
        data = X.LedgerEntryData(X.LedgerEntryType.OFFER, body)
    else:
        body = X.DataEntry(accountID=acc, dataName="k%d" % b,
                           dataValue=b"v%d" % amount, ext=X._Ext.v0())
        data = X.LedgerEntryData(X.LedgerEntryType.DATA, body)
    return X.LedgerEntry(lastModifiedLedgerSeq=seq % 1000, data=data,
                         ext=X._Ext.v0())


def _delta_bytes(delta) -> list:
    return [(k.to_xdr(), p.to_xdr() if p is not None else None,
             c.to_xdr() if c is not None else None) for k, p, c in delta]


class _Side:
    """One package's txn stack over one root."""

    def __init__(self, L, D, X, kind):
        self.L, self.X = L, X
        self.root = _root(L, D, X, kind)
        self.stack = []

    def top(self):
        return self.stack[-1] if self.stack else None

    def open(self):
        parent = self.top() or self.root
        self.stack.append(self.L.LedgerTxn(parent))

    def key(self, vals):
        return self.X.ledger_entry_key(_entry(self.X, vals))


@pytest.mark.parametrize("kind", ["memory", "sql"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_nested_sequence_matches_reference(kind, seed):
    rng = np.random.default_rng(seed)
    sides = [_Side(RL, RDatabase, RX, kind), _Side(PL, PDatabase, PX, kind)]
    commits = 0
    for _ in range(STEPS):
        op = int(rng.integers(0, 10))
        vals = (int(rng.integers(0, 4)), int(rng.integers(0, ACCOUNTS)),
                int(rng.integers(0, 4)), int(rng.integers(1, 10 ** 9)),
                int(rng.integers(1, 2 ** 40)))
        if op <= 1 or not sides[0].stack:
            if len(sides[0].stack) < 4:
                for s in sides:
                    s.open()
            continue
        if op == 2:       # commit the innermost txn into its parent
            deltas = [_delta_bytes(s.top().get_delta()) for s in sides]
            assert deltas[0] == deltas[1]
            for s in sides:
                s.stack.pop().commit()
            commits += 1
            continue
        if op == 3:       # roll the innermost txn back
            for s in sides:
                s.stack.pop().rollback()
            continue
        present = [s.top().get_entry(s.key(vals)) is not None for s in sides]
        assert present[0] == present[1]
        if op <= 6:       # create, or load and modify
            for s in sides:
                ltx = s.top()
                if present[0]:
                    e = ltx.load(s.key(vals))
                    e.lastModifiedLedgerSeq = vals[4] % 997
                    if vals[0] == 2:
                        e.data.value.amount = vals[3]
                    elif vals[0] != 3:
                        e.data.value.balance = vals[3]
                else:
                    ltx.create(_entry(s.X, vals))
        elif op <= 8 and present[0]:   # erase
            for s in sides:
                s.top().erase(s.key(vals))
        else:             # a read-only peek must not dirty the txn
            for s in sides:
                s.top().load_without_record(s.key(vals))
        deltas = [_delta_bytes(s.top().get_delta()) for s in sides]
        assert deltas[0] == deltas[1]
    while sides[0].stack:
        deltas = [_delta_bytes(s.top().get_delta()) for s in sides]
        assert deltas[0] == deltas[1]
        for s in sides:
            s.stack.pop().commit()
        commits += 1
    assert commits > 10
    ents = [sorted(e.to_xdr() for e in s.root.all_entries()) for s in sides]
    assert ents[0] == ents[1] and len(ents[0]) > 5
    assert sides[0].root.count_entries() == sides[1].root.count_entries()
    assert sides[0].root.get_header().to_xdr() == \
        sides[1].root.get_header().to_xdr()
