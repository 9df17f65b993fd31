"""Invariants: registered safety predicates checked at apply time.

Copied from `stellar_core_tpu/invariant/invariants.py` at commit 634bc5e;
carry a fix in either copy to the other. Left out:
`BucketListIsConsistentWithDatabase.check_on_bucket_apply`. Nothing calls
it in either package (the manager checks the close only, and neither has a
bucket-apply hook), and the reference's raises AttributeError on its first
entry (ROADMAP Queue 3 item 9). The class stays registered, so
`INVARIANT_CHECKS` enables the same names as in the reference; it inherits
the base class's no-op check and comes back with a bucket-apply hook.

Role parity: reference `src/invariant/` — InvariantManager
(InvariantManager.h:39-56) + concrete invariants
(ConservationOfLumens.cpp, LedgerEntryIsValid.cpp,
AccountSubEntriesCountIsValid.cpp, LiabilitiesMatchOffers.cpp,
BucketListIsConsistentWithDatabase.cpp). A failing invariant raises
InvariantDoesNotHold, which aborts the node (tests run with all enabled).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

from ..util.log import get_logger
from ..xdr import LedgerEntryType, LedgerHeader

log = get_logger("Invariant")

Delta = List[Tuple[object, object, object]]  # (key, prev, cur)


class InvariantDoesNotHold(Exception):
    pass


class Invariant:
    name = "abstract"

    def check_on_close(self, delta: Delta, header_prev: LedgerHeader,
                       header_cur: LedgerHeader) -> Optional[str]:
        """Return an error string or None."""
        return None

    def check_on_operation(self, op_frame, delta: Delta,
                           header_prev: LedgerHeader,
                           header_cur: LedgerHeader) -> Optional[str]:
        """Per-operation check over the op's own LedgerTxn delta
        (reference InvariantManager::checkOnOperationApply,
        InvariantManager.h:39-49). Catches compensating-bug pairs that a
        whole-ledger delta would cancel out. Default: reuse the close
        check on the op delta."""
        return self.check_on_close(delta, header_prev, header_cur)

    def check_on_bucket_apply(self, entries, ltx_root, level: int,
                              is_curr: bool) -> Optional[str]:
        """Post-bucket-application consistency (reference
        checkOnBucketApply)."""
        return None


class LedgerEntryIsValid(Invariant):
    name = "LedgerEntryIsValid"

    def check_on_close(self, delta, header_prev, header_cur):
        for key, prev, cur in delta:
            if cur is None:
                continue
            d = cur.data
            if cur.lastModifiedLedgerSeq > header_cur.ledgerSeq:
                return "entry lastModified in the future"
            if d.disc == LedgerEntryType.ACCOUNT:
                a = d.value
                if a.balance < 0:
                    return "account balance negative"
                if a.seqNum < 0:
                    return "account seqnum negative"
                if prev is not None and \
                        prev.data.disc == LedgerEntryType.ACCOUNT and \
                        a.seqNum < prev.data.value.seqNum:
                    return "account seqnum decreased"
                if len(a.signers) > 20:
                    return "too many signers"
                hints = [s.key.to_xdr() for s in a.signers]
                if hints != sorted(hints):
                    return "signers not sorted"
            elif d.disc == LedgerEntryType.TRUSTLINE:
                t = d.value
                if t.balance < 0 or t.limit <= 0 or t.balance > t.limit:
                    return "trustline balance/limit invalid"
            elif d.disc == LedgerEntryType.OFFER:
                o = d.value
                if o.amount <= 0:
                    return "offer amount non-positive"
                if o.price.n <= 0 or o.price.d <= 0:
                    return "offer price invalid"
        return None


class ConservationOfLumens(Invariant):
    name = "ConservationOfLumens"

    def check_on_close(self, delta, header_prev, header_cur):
        d_balance = 0
        for key, prev, cur in delta:
            if prev is not None and \
                    prev.data.disc == LedgerEntryType.ACCOUNT:
                d_balance -= prev.data.value.balance
            if cur is not None and \
                    cur.data.disc == LedgerEntryType.ACCOUNT:
                d_balance += cur.data.value.balance
        d_fee = header_cur.feePool - header_prev.feePool
        d_total = header_cur.totalCoins - header_prev.totalCoins
        if d_balance + d_fee != d_total:
            return ("lumens not conserved: dBalance=%d dFeePool=%d "
                    "dTotal=%d" % (d_balance, d_fee, d_total))
        return None


class AccountSubEntriesCountIsValid(Invariant):
    name = "AccountSubEntriesCountIsValid"

    def check_on_close(self, delta, header_prev, header_cur):
        d_sub: Dict[bytes, int] = {}
        d_declared: Dict[bytes, int] = {}
        for key, prev, cur in delta:
            t = (cur or prev).data.disc
            if t == LedgerEntryType.ACCOUNT:
                acc = (cur or prev).data.value.accountID.key_bytes
                pv = prev.data.value.numSubEntries if prev else 0
                cv = cur.data.value.numSubEntries if cur else 0
                d_declared[acc] = d_declared.get(acc, 0) + cv - pv
                # signers live inside the account entry but count as
                # subentries (reference AccountSubEntriesCountIsValid
                # counts signers.size() alongside owned entries)
                ps = len(prev.data.value.signers) if prev else 0
                cs = len(cur.data.value.signers) if cur else 0
                d_sub[acc] = d_sub.get(acc, 0) + cs - ps
                if cur is None:
                    # merged account must have no subentries
                    if prev.data.value.numSubEntries != ps:
                        return "account removed with subentries"
                    d_declared.pop(acc, None)
                    d_sub.pop(acc, None)
            elif t in (LedgerEntryType.TRUSTLINE, LedgerEntryType.DATA):
                e = (cur or prev).data.value
                acc = e.accountID.key_bytes
                d_sub[acc] = d_sub.get(acc, 0) + \
                    (1 if cur is not None else 0) - \
                    (1 if prev is not None else 0)
            elif t == LedgerEntryType.OFFER:
                e = (cur or prev).data.value
                acc = e.sellerID.key_bytes
                d_sub[acc] = d_sub.get(acc, 0) + \
                    (1 if cur is not None else 0) - \
                    (1 if prev is not None else 0)
        for acc in set(d_sub) | set(d_declared):
            if d_sub.get(acc, 0) != d_declared.get(acc, 0):
                return ("subentry count mismatch for account: "
                        "actual delta %d vs declared %d" %
                        (d_sub.get(acc, 0), d_declared.get(acc, 0)))
        return None


class SequentialLedgers(Invariant):
    name = "SequentialLedgers"

    def check_on_close(self, delta, header_prev, header_cur):
        if header_cur.ledgerSeq != header_prev.ledgerSeq + 1:
            return "ledger seq not sequential"
        return None

    def check_on_operation(self, op_frame, delta, header_prev, header_cur):
        return None  # ops run within one ledger


class LiabilitiesMatchOffers(Invariant):
    """Reference src/invariant/LiabilitiesMatchOffers.cpp: every change in
    an account's/trustline's liabilities must be explained by offer
    changes in the same delta, and liabilities must stay within balance /
    limit bounds."""

    name = "LiabilitiesMatchOffers"

    @staticmethod
    def _liab(entry) -> Tuple[int, int]:
        if entry is None:
            return (0, 0)
        dv = entry.data.value
        if dv.ext.disc == 0:
            return (0, 0)
        li = dv.ext.value.liabilities
        return (li.buying, li.selling)

    def _offer_deltas(self, delta):
        from ..transactions.offer_exchange import offer_liabilities
        from ..xdr import Asset
        d_buying: Dict[tuple, int] = {}
        d_selling: Dict[tuple, int] = {}
        for key, prev, cur in delta:
            if (cur or prev).data.disc != LedgerEntryType.OFFER:
                continue
            for e, sign in ((prev, -1), (cur, +1)):
                if e is None:
                    continue
                o = e.data.value
                bl, sl = offer_liabilities(o.price.n, o.price.d, o.amount)
                seller = o.sellerID.key_bytes
                # issuer side carries no liability (issuer mints/burns)
                if o.buying.is_native or o.sellerID != o.buying.issuer:
                    k = (seller, o.buying.to_xdr())
                    d_buying[k] = d_buying.get(k, 0) + sign * bl
                if o.selling.is_native or o.sellerID != o.selling.issuer:
                    k = (seller, o.selling.to_xdr())
                    d_selling[k] = d_selling.get(k, 0) + sign * sl
        return d_buying, d_selling

    def check_on_operation(self, op_frame, delta, header_prev, header_cur):
        from ..xdr import Asset
        if header_cur.ledgerVersion < 10:
            return None
        d_buying, d_selling = self._offer_deltas(delta)
        native = Asset.native().to_xdr()
        for key, prev, cur in delta:
            t = (cur or prev).data.disc
            if t == LedgerEntryType.ACCOUNT:
                dv = (cur or prev).data.value
                k = (dv.accountID.key_bytes, native)
            elif t == LedgerEntryType.TRUSTLINE:
                dv = (cur or prev).data.value
                k = (dv.accountID.key_bytes, dv.asset.to_xdr())
            else:
                continue
            pb, ps = self._liab(prev)
            cb, cs = self._liab(cur)
            if cb - pb != d_buying.pop(k, 0):
                return ("buying liabilities changed by %d without matching "
                        "offer delta" % (cb - pb))
            if cs - ps != d_selling.pop(k, 0):
                return ("selling liabilities changed by %d without "
                        "matching offer delta" % (cs - ps))
            # bound checks on the new state (reference checkBalanceAndLimit)
            if cur is not None:
                dvc = cur.data.value
                if cb < 0 or cs < 0:
                    return "negative liabilities"
                if t == LedgerEntryType.ACCOUNT:
                    reserve = (2 + dvc.numSubEntries) * header_cur.baseReserve
                    if dvc.balance - reserve < cs:
                        return "selling liabilities exceed available balance"
                    if dvc.balance > (2**63 - 1) - cb:
                        return "buying liabilities exceed INT64 headroom"
                else:
                    if dvc.balance < cs:
                        return "selling liabilities exceed trust balance"
                    if dvc.balance > dvc.limit - cb:
                        return "buying liabilities exceed trust limit"
        for k, v in list(d_buying.items()) + list(d_selling.items()):
            if v != 0:
                return ("offer liability delta %d has no matching "
                        "account/trustline change" % v)
        return None

    def check_on_close(self, delta, header_prev, header_cur):
        return self.check_on_operation(None, delta, header_prev, header_cur)


class BucketListIsConsistentWithDatabase(Invariant):
    """Reference src/invariant/BucketListIsConsistentWithDatabase.cpp:
    after a bucket is applied during catchup, the ledger state must
    contain exactly the bucket's live entries and none of its dead
    keys. The check itself is left out (see the module header)."""

    name = "BucketListIsConsistentWithDatabase"


ALL_INVARIANTS = [LedgerEntryIsValid, ConservationOfLumens,
                  AccountSubEntriesCountIsValid, SequentialLedgers,
                  LiabilitiesMatchOffers,
                  BucketListIsConsistentWithDatabase]


class InvariantManager:
    """Registry + enforcement (reference InvariantManagerImpl.cpp:72-143)."""

    def __init__(self, metrics=None) -> None:
        self._registered: Dict[str, Invariant] = {}
        self._enabled: List[Invariant] = []
        self._metrics = metrics
        for cls in ALL_INVARIANTS:
            self.register(cls())

    def register(self, inv: Invariant) -> None:
        assert inv.name not in self._registered
        self._registered[inv.name] = inv

    def enable(self, pattern: str) -> None:
        rx = re.compile(pattern)
        for name, inv in self._registered.items():
            if rx.fullmatch(name) and inv not in self._enabled:
                self._enabled.append(inv)

    def enabled_names(self) -> List[str]:
        return [i.name for i in self._enabled]

    def check_on_ledger_close(self, delta, header_prev, header_cur) -> None:
        for inv in self._enabled:
            err = inv.check_on_close(delta, header_prev, header_cur)
            if err is not None:
                msg = "invariant %s violated: %s" % (inv.name, err)
                log.error(msg)
                raise InvariantDoesNotHold(msg)
