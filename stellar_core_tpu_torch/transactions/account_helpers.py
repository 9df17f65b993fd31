"""Account-state helpers shared by operations.

Copied from `stellar_core_tpu/transactions/account_helpers.py` at commit
588326f; carry a fix in either copy to the other.

Role parity: reference `src/transactions/TransactionUtils.{h,cpp}` (load*,
addBalance, getAvailableBalance, reserve math) and
`src/ledger/LedgerTxnHeader` utilities.
"""

from __future__ import annotations

from typing import Optional

from ..xdr import (
    AccountEntry, AccountEntryExt, AccountEntryExtensionV1, AccountFlags,
    Asset, LedgerEntry, LedgerEntryData, LedgerEntryType, LedgerHeader,
    LedgerKey, Liabilities, TrustLineEntry, TrustLineEntryExt,
    TrustLineEntryExtensionV1, TrustLineFlags, _Ext,
)

INT64_MAX = 2**63 - 1
MAX_SUBENTRIES = 1000

# protocol version introducing liabilities (reference
# src/transactions/TransactionUtils.cpp gating)
LIABILITIES_VERSION = 10


def first_ledger_seq_for_account(header: LedgerHeader) -> int:
    return header.ledgerSeq


def starting_sequence_number(header: LedgerHeader) -> int:
    """New accounts start at ledgerSeq << 32 (reference
    getStartingSequenceNumber)."""
    return header.ledgerSeq << 32


def base_reserve(header: LedgerHeader) -> int:
    return header.baseReserve


def min_balance(header: LedgerHeader, num_subentries: int) -> int:
    """(2 + numSubEntries) * baseReserve (reference getMinBalance for
    protocol >= 9)."""
    return (2 + num_subentries) * header.baseReserve


def load_account(ltx, account_id) -> Optional[LedgerEntry]:
    return ltx.load(LedgerKey.account(account_id))


def load_account_entry(ltx, account_id) -> Optional[AccountEntry]:
    e = load_account(ltx, account_id)
    return e.data.value if e is not None else None


def load_trustline(ltx, account_id, asset: Asset) -> Optional[LedgerEntry]:
    return ltx.load(LedgerKey.trustline(account_id, asset))


# -- liabilities (protocol >= 10; reference TransactionUtils.cpp:165-440) ---

def _raw_liabilities(dv) -> tuple:
    """(buying, selling) off an AccountEntry or TrustLineEntry."""
    if dv.ext.disc == 0:
        return (0, 0)
    li = dv.ext.value.liabilities
    return (li.buying, li.selling)


def _prepare_liabilities(dv) -> Liabilities:
    """Promote the entry extension to v1 and return its Liabilities."""
    if dv.ext.disc == 0:
        li = Liabilities(buying=0, selling=0)
        if isinstance(dv, AccountEntry):
            dv.ext = AccountEntryExt(1, AccountEntryExtensionV1(
                liabilities=li, ext=_Ext.v0()))
        else:
            dv.ext = TrustLineEntryExt(1, TrustLineEntryExtensionV1(
                liabilities=li, ext=_Ext.v0()))
    return dv.ext.value.liabilities


def get_buying_liabilities(header: LedgerHeader, entry: LedgerEntry) -> int:
    if header.ledgerVersion < LIABILITIES_VERSION:
        return 0
    return _raw_liabilities(entry.data.value)[0]


def get_selling_liabilities(header: LedgerHeader, entry: LedgerEntry) -> int:
    if header.ledgerVersion < LIABILITIES_VERSION:
        return 0
    return _raw_liabilities(entry.data.value)[1]


def add_buying_liabilities(header: LedgerHeader, entry: LedgerEntry,
                           delta: int) -> bool:
    """Reference addBuyingLiabilities (TransactionUtils.cpp:285): buying
    liabilities may not push balance past INT64_MAX (native) or the
    trustline limit."""
    if delta == 0:
        return True
    dv = entry.data.value
    buying, _selling = _raw_liabilities(dv)
    if entry.data.disc == LedgerEntryType.ACCOUNT:
        max_liab = INT64_MAX - dv.balance
    else:
        # maintain-or-more: liabilities on existing offers stay
        # adjustable (reference checkAuthorization in addBuyingLiabilities)
        if not trustline_authorized_to_maintain(dv):
            return False
        max_liab = dv.limit - dv.balance
    new = buying + delta
    if new < 0 or new > max_liab:
        return False
    _prepare_liabilities(dv).buying = new
    return True


def add_selling_liabilities(header: LedgerHeader, entry: LedgerEntry,
                            delta: int) -> bool:
    """Reference addSellingLiabilities (TransactionUtils.cpp:373): selling
    liabilities may not encumber the reserve (native) or exceed the
    trustline balance."""
    if delta == 0:
        return True
    dv = entry.data.value
    _buying, selling = _raw_liabilities(dv)
    if entry.data.disc == LedgerEntryType.ACCOUNT:
        max_liab = dv.balance - min_balance(header, dv.numSubEntries)
        if max_liab < 0:
            return False
    else:
        if not trustline_authorized_to_maintain(dv):
            return False
        max_liab = dv.balance
    new = selling + delta
    if new < 0 or new > max_liab:
        return False
    _prepare_liabilities(dv).selling = new
    return True


def account_available_balance(header: LedgerHeader,
                              acc: AccountEntry) -> int:
    """balance - reserve - selling liabilities (reference
    getAvailableBalance, TransactionUtils.cpp:440)."""
    avail = acc.balance - min_balance(header, acc.numSubEntries)
    if header.ledgerVersion >= LIABILITIES_VERSION:
        avail -= _raw_liabilities(acc)[1]
    return max(0, avail)


def trustline_available_balance(header: LedgerHeader,
                                tl: TrustLineEntry) -> int:
    avail = tl.balance
    if header.ledgerVersion >= LIABILITIES_VERSION:
        avail -= _raw_liabilities(tl)[1]
    return max(0, avail)


def max_amount_receive(header: LedgerHeader, entry: LedgerEntry) -> int:
    """Headroom below the ceiling minus buying liabilities (reference
    getMaxAmountReceive, TransactionUtils.cpp:509)."""
    dv = entry.data.value
    if entry.data.disc == LedgerEntryType.ACCOUNT:
        out = INT64_MAX
        if header.ledgerVersion >= LIABILITIES_VERSION:
            out -= dv.balance + _raw_liabilities(dv)[0]
        return out
    if not trustline_authorized_to_maintain(dv):
        # maintain-or-more, like every capacity primitive (reference
        # getMaxAmountReceive → checkAuthorization)
        return 0
    out = dv.limit - dv.balance
    if header.ledgerVersion >= LIABILITIES_VERSION:
        out -= _raw_liabilities(dv)[0]
    return out


def add_balance(header: LedgerHeader, entry: LedgerEntry,
                delta: int) -> bool:
    """Adjust native balance respecting reserve floor, INT64 ceiling, and
    liabilities (reference addBalance, TransactionUtils.cpp:220)."""
    acc = entry.data.value
    new = acc.balance + delta
    if new < 0 or new > INT64_MAX:
        return False
    if header.ledgerVersion >= LIABILITIES_VERSION:
        buying, selling = _raw_liabilities(acc)
        if delta < 0 and \
                new - min_balance(header, acc.numSubEntries) < selling:
            return False
        if new > INT64_MAX - buying:
            return False
    elif delta < 0 and new < min_balance(header, acc.numSubEntries):
        return False
    acc.balance = new
    return True


def add_trust_balance(header: LedgerHeader, entry: LedgerEntry,
                      delta: int) -> bool:
    """Adjust a trustline balance respecting limit, authorization, and
    liabilities (reference addBalance TRUSTLINE arm)."""
    tl = entry.data.value
    if delta == 0:
        return True
    # the balance PRIMITIVE accepts maintain-or-more so existing offers
    # can execute (reference checkAuthorization,
    # TransactionUtils.cpp:18-34); payments enforce FULL authorization
    # at the op level. Pre-13 lines can only carry the AUTHORIZED bit,
    # so this is version-safe.
    if not (tl.flags & TrustLineFlags.AUTH_LEVELS_MASK):
        return False
    new = tl.balance + delta
    if new < 0 or new > tl.limit:
        return False
    if header.ledgerVersion >= LIABILITIES_VERSION:
        buying, selling = _raw_liabilities(tl)
        if new < selling:
            return False
        if new > tl.limit - buying:
            return False
    tl.balance = new
    return True


def trustline_authorized(tl: TrustLineEntry) -> bool:
    return bool(tl.flags & TrustLineFlags.AUTHORIZED_FLAG)


def trustline_authorized_to_maintain(tl: TrustLineEntry) -> bool:
    """Either auth level: enough to keep/release/execute existing
    liabilities (reference isAuthorizedToMaintainLiabilities)."""
    return bool(tl.flags & TrustLineFlags.AUTH_LEVELS_MASK)


def change_subentries(header: LedgerHeader, entry: LedgerEntry,
                      delta: int) -> bool:
    """Add/remove subentries, enforcing reserve (incl. selling
    liabilities) on add (reference addNumEntries:333-369)."""
    acc = entry.data.value
    new_count = acc.numSubEntries + delta
    if new_count < 0 or new_count > MAX_SUBENTRIES:
        return False
    eff_min = min_balance(header, new_count)
    if header.ledgerVersion >= LIABILITIES_VERSION:
        eff_min += _raw_liabilities(acc)[1]
    if delta > 0 and acc.balance < eff_min:
        return False
    acc.numSubEntries = new_count
    return True


def make_account_entry(account_id, balance: int, seq_num: int,
                       last_modified: int = 0) -> LedgerEntry:
    acc = AccountEntry(
        accountID=account_id, balance=balance, seqNum=seq_num,
        numSubEntries=0, inflationDest=None, flags=0, homeDomain="",
        thresholds=bytes([1, 0, 0, 0]), signers=[], ext=AccountEntryExt.v0())
    return LedgerEntry(
        lastModifiedLedgerSeq=last_modified,
        data=LedgerEntryData(LedgerEntryType.ACCOUNT, acc), ext=_Ext.v0())


class ThresholdLevel:
    LOW = 0
    MEDIUM = 1
    HIGH = 2


def account_threshold(acc: AccountEntry, level: int) -> int:
    return acc.thresholds[1 + level]


def account_master_weight(acc: AccountEntry) -> int:
    return acc.thresholds[0]


def is_auth_required(acc: AccountEntry) -> bool:
    return bool(acc.flags & AccountFlags.AUTH_REQUIRED_FLAG)


def is_immutable_auth(acc: AccountEntry) -> bool:
    return bool(acc.flags & AccountFlags.AUTH_IMMUTABLE_FLAG)
