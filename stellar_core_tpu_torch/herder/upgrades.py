"""Upgrades: protocol/fee/size/reserve upgrade voting.

Copied from `stellar_core_tpu/herder/upgrades.py` at commit 183ecd9; carry
a fix in either copy to the other.

Role parity: reference `src/herder/Upgrades.{h,cpp}` — armed via config or
the HTTP admin endpoint, nominated inside StellarValue.upgrades, validated
against scheduled parameters, applied at ledger close (after txs).
"""

from __future__ import annotations

import time
from typing import List, Optional

from ..xdr import LedgerHeader, LedgerUpgrade, LedgerUpgradeType

# armed parameters expire this long after their scheduled time, so nodes
# restarted with stale configs don't try to change the network (reference
# Upgrades::UPDGRADE_EXPIRATION_HOURS)
UPGRADE_EXPIRATION_SECONDS = 12 * 3600


class UpgradeValidity:
    VALID = 0
    XDR_INVALID = 1
    INVALID = 2


class UpgradeParameters:
    def __init__(self) -> None:
        self.upgrade_time: int = 0
        self.protocol_version: Optional[int] = None
        self.base_fee: Optional[int] = None
        self.max_tx_set_size: Optional[int] = None
        self.base_reserve: Optional[int] = None

    def to_json(self) -> dict:
        return {
            "time": self.upgrade_time,
            "version": self.protocol_version,
            "fee": self.base_fee,
            "maxtxsize": self.max_tx_set_size,
            "reserve": self.base_reserve,
        }


class Upgrades:
    def __init__(self, params: Optional[UpgradeParameters] = None) -> None:
        self.params = params or UpgradeParameters()

    def set_parameters(self, params: UpgradeParameters) -> None:
        self.params = params

    def create_upgrades_for(self, header: LedgerHeader,
                            close_time: int) -> List[bytes]:
        """Upgrades to nominate, given the current header (reference
        createUpgradesFor)."""
        out: List[bytes] = []
        p = self.params
        if close_time < p.upgrade_time:
            return out
        if p.protocol_version is not None and \
                p.protocol_version != header.ledgerVersion:
            out.append(LedgerUpgrade(
                LedgerUpgradeType.LEDGER_UPGRADE_VERSION,
                p.protocol_version).to_xdr())
        if p.base_fee is not None and p.base_fee != header.baseFee:
            out.append(LedgerUpgrade(
                LedgerUpgradeType.LEDGER_UPGRADE_BASE_FEE,
                p.base_fee).to_xdr())
        if p.max_tx_set_size is not None and \
                p.max_tx_set_size != header.maxTxSetSize:
            out.append(LedgerUpgrade(
                LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE,
                p.max_tx_set_size).to_xdr())
        if p.base_reserve is not None and \
                p.base_reserve != header.baseReserve:
            out.append(LedgerUpgrade(
                LedgerUpgradeType.LEDGER_UPGRADE_BASE_RESERVE,
                p.base_reserve).to_xdr())
        return out

    def is_valid_for_nomination(self, raw: bytes, header: LedgerHeader,
                                close_time: int) -> bool:
        """Would we vote for this upgrade? (reference isValid w/ nomination
        mode)."""
        try:
            up = LedgerUpgrade.from_xdr(raw)
        except Exception:
            return False
        p = self.params
        if close_time < p.upgrade_time:
            return False
        t = up.disc
        if t == LedgerUpgradeType.LEDGER_UPGRADE_VERSION:
            return up.value == p.protocol_version
        if t == LedgerUpgradeType.LEDGER_UPGRADE_BASE_FEE:
            return up.value == p.base_fee
        if t == LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
            return up.value == p.max_tx_set_size
        if t == LedgerUpgradeType.LEDGER_UPGRADE_BASE_RESERVE:
            return up.value == p.base_reserve
        return False

    @staticmethod
    def validity_for_apply(raw: bytes, header: LedgerHeader,
                           max_ledger_version: int) -> int:
        """Full apply-validity (reference isValidForApply): version
        upgrades must be strictly monotonic and within the supported
        protocol; fee/reserve must be nonzero; unknown types are invalid.
        Close-time behavior: a non-VALID upgrade in an externalized value
        fails the close (LedgerManagerImpl.cpp:617-634)."""
        try:
            up = LedgerUpgrade.from_xdr(raw)
        except Exception:
            return UpgradeValidity.XDR_INVALID
        t = up.disc
        if t == LedgerUpgradeType.LEDGER_UPGRADE_VERSION:
            ok = header.ledgerVersion < up.value <= max_ledger_version
        elif t == LedgerUpgradeType.LEDGER_UPGRADE_BASE_FEE:
            ok = up.value != 0
        elif t == LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
            ok = True
        elif t == LedgerUpgradeType.LEDGER_UPGRADE_BASE_RESERVE:
            ok = up.value != 0
        else:
            ok = False
        return UpgradeValidity.VALID if ok else UpgradeValidity.INVALID

    @staticmethod
    def is_valid_for_apply(raw: bytes, header: LedgerHeader,
                           max_ledger_version: int = 2**32 - 1) -> bool:
        return Upgrades.validity_for_apply(
            raw, header, max_ledger_version) == UpgradeValidity.VALID

    @staticmethod
    def remove_upgrades(value_upgrades: List[bytes],
                        header: LedgerHeader) -> List[bytes]:
        return [u for u in value_upgrades
                if Upgrades.is_valid_for_apply(u, header)]

    def remove_applied_and_expired(self, value_upgrades: List[bytes],
                                   close_time: int) -> bool:
        """Reset armed parameters that (a) just externalized — each upgrade
        in the closed value clears a matching armed target — or (b) whose
        scheduled time passed more than UPGRADE_EXPIRATION_SECONDS ago
        (reference Upgrades::removeUpgrades). Returns True if anything was
        reset (callers persist the new parameters)."""
        p = self.params
        updated = False
        if p.upgrade_time + UPGRADE_EXPIRATION_SECONDS <= close_time:
            for field in ("protocol_version", "base_fee",
                          "max_tx_set_size", "base_reserve"):
                if getattr(p, field) is not None:
                    setattr(p, field, None)
                    updated = True
            return updated
        by_type = {
            LedgerUpgradeType.LEDGER_UPGRADE_VERSION: "protocol_version",
            LedgerUpgradeType.LEDGER_UPGRADE_BASE_FEE: "base_fee",
            LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
                "max_tx_set_size",
            LedgerUpgradeType.LEDGER_UPGRADE_BASE_RESERVE: "base_reserve",
        }
        for raw in value_upgrades:
            try:
                up = LedgerUpgrade.from_xdr(raw)
            except Exception:
                continue
            field = by_type.get(up.disc)
            if field is not None and getattr(p, field) == up.value:
                setattr(p, field, None)
                updated = True
        return updated

    @staticmethod
    def apply_to(ltx, up: LedgerUpgrade) -> None:
        """Apply one externalized upgrade inside `ltx` (reference
        Upgrades::applyTo). Version and reserve upgrades can rewrite
        ledger ENTRIES, not just the header: crossing into protocol 10
        (or raising the reserve at >=10) recomputes every offer owner's
        liabilities via prepare_liabilities."""
        header = ltx.load_header()
        t = up.disc
        if t == LedgerUpgradeType.LEDGER_UPGRADE_VERSION:
            prev = header.ledgerVersion
            header.ledgerVersion = up.value
            if prev < 10 <= header.ledgerVersion:
                prepare_liabilities(ltx, header)
        elif t == LedgerUpgradeType.LEDGER_UPGRADE_BASE_FEE:
            header.baseFee = up.value
        elif t == LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
            header.maxTxSetSize = up.value
        elif t == LedgerUpgradeType.LEDGER_UPGRADE_BASE_RESERVE:
            increased = up.value > header.baseReserve
            header.baseReserve = up.value
            if header.ledgerVersion >= 10 and increased:
                prepare_liabilities(ltx, header)


def prepare_liabilities(ltx, header: LedgerHeader) -> None:
    """Bring offers and liabilities into a valid state (reference
    Upgrades.cpp prepareLiabilities:611-762). For every account with
    offers: (1) total the liabilities its offers imply per asset, (2)
    erase ALL offers buying an asset whose initial buying total exceeds
    the available limit (and likewise selling vs available balance) —
    deletion decisions use only the INITIAL totals so offer order can't
    matter, (3) round remaining offers to exchange-representable amounts,
    (4) write the recomputed totals into the account/trustline liability
    extensions."""
    from ..transactions.account_helpers import (
        INT64_MAX, change_subentries, get_buying_liabilities,
        get_selling_liabilities, load_account, load_trustline, min_balance,
        trustline_authorized_to_maintain,
    )
    from ..transactions.offer_exchange import adjust_offer, offer_liabilities
    from ..xdr import LedgerKey

    offers = ltx.load_all_offers()
    by_account: dict = {}
    for e in offers:
        by_account.setdefault(e.data.value.sellerID.key_bytes, []).append(e)

    for _seller, acct_offers in sorted(by_account.items()):
        seller = acct_offers[0].data.value.sellerID

        # (1) initial per-asset totals; None marks int64 overflow (legacy
        # offers predate liability caps). Issuer-owned sides total 0 but
        # the asset key must exist for the deletion check below.
        init_buying: dict = {}
        init_selling: dict = {}

        def add_init(table, asset, amount):
            k = asset.to_xdr()
            cur = table.setdefault(k, 0)
            if not asset.is_native and seller == asset.issuer:
                return
            if cur is not None:
                cur += amount
                table[k] = cur if cur <= INT64_MAX else None

        for e in acct_offers:
            o = e.data.value
            buying_liab, selling_liab = offer_liabilities(
                o.price.n, o.price.d, o.amount)
            add_init(init_buying, o.buying, buying_liab)
            add_init(init_selling, o.selling, selling_liab)

        acc_entry = load_account(ltx, seller)
        assert acc_entry is not None, "offer owner account missing"
        acc = acc_entry.data.value
        balance = acc.balance
        balance_above_reserve = balance - min_balance(
            header, acc.numSubEntries)

        def available_balance(asset):
            # capacity to DELIVER asset, liabilities excluded (reference
            # getAvailableBalanceExcludingLiabilities)
            if asset.is_native:
                return balance_above_reserve
            if seller == asset.issuer:
                return INT64_MAX
            tl = ltx.load_without_record(LedgerKey.trustline(seller, asset))
            if tl is not None and \
                    trustline_authorized_to_maintain(tl.data.value):
                return tl.data.value.balance
            return 0

        def available_limit(asset):
            # capacity to RECEIVE asset (reference
            # getAvailableLimitExcludingLiabilities)
            if asset.is_native:
                return INT64_MAX - balance
            if seller == asset.issuer:
                return INT64_MAX
            tl = ltx.load_without_record(LedgerKey.trustline(seller, asset))
            if tl is not None and \
                    trustline_authorized_to_maintain(tl.data.value):
                return tl.data.value.limit - tl.data.value.balance
            return 0

        def excess(table, asset, cap_fn):
            total = table[asset.to_xdr()]
            return total is None or total > cap_fn(asset)

        # (2)+(3) erase/adjust each offer; recompute surviving totals.
        # `final` only gains entries from SURVIVING offers — matching the
        # reference, whose updateOffer touches its liabilities map only in
        # the non-erase branch: an asset that loses every offer keeps its
        # previously-recorded liabilities (at the v10 crossing they are 0
        # by construction; at a reserve raise the excess stays recorded,
        # conservatively — same quirk as the reference).
        final: dict = {}   # asset xdr -> [buying, selling]
        for e in acct_offers:
            o = e.data.value
            erase = excess(init_selling, o.selling, available_balance) or \
                excess(init_buying, o.buying, available_limit)
            adj = adjust_offer(o.price.n, o.price.d, o.amount, INT64_MAX)
            if erase or adj == 0:
                ltx.erase(LedgerKey.offer(seller, o.offerID))
                assert change_subentries(header, acc_entry, -1)
                continue
            o.amount = adj   # load_all_offers loads for update: sticks
            buying_liab, selling_liab = offer_liabilities(
                o.price.n, o.price.d, o.amount)
            if o.buying.is_native or seller != o.buying.issuer:
                final.setdefault(o.buying.to_xdr(), [0, 0])[0] += buying_liab
            if o.selling.is_native or seller != o.selling.issuer:
                final.setdefault(o.selling.to_xdr(), [0, 0])[1] += \
                    selling_liab

        # (4) set account/trustline liabilities to the recomputed totals
        from ..transactions.account_helpers import (
            add_buying_liabilities, add_selling_liabilities,
        )
        from ..xdr import Asset
        for asset_x, (buying, selling) in sorted(final.items()):
            asset = Asset.from_xdr(asset_x)
            if asset.is_native:
                target = acc_entry
            else:
                target = load_trustline(ltx, seller, asset)
                assert target is not None, \
                    "offer survived without its trustline"
            d_sell = selling - get_selling_liabilities(header, target)
            d_buy = buying - get_buying_liabilities(header, target)
            if header.ledgerVersion > 10 and (d_sell > 0 or d_buy > 0):
                raise RuntimeError(
                    "invalid liabilities delta above protocol 10")
            if not add_selling_liabilities(header, target, d_sell):
                raise RuntimeError(
                    "invalid selling liabilities during upgrade")
            if not add_buying_liabilities(header, target, d_buy):
                raise RuntimeError(
                    "invalid buying liabilities during upgrade")
