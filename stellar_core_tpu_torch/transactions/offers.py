"""Offer and path-payment operation frames.

Copied from `stellar_core_tpu/transactions/offers.py` at commit 951138b;
carry a fix in either copy to the other.

Role parity: reference `src/transactions/ManageOfferOpFrameBase.cpp`,
`ManageSellOfferOpFrame.cpp`, `ManageBuyOfferOpFrame.cpp`,
`CreatePassiveSellOfferOpFrame.cpp`, `PathPaymentStrictReceiveOpFrame.cpp`,
`PathPaymentStrictSendOpFrame.cpp` — all built on OfferExchange
(offer_exchange.py).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..xdr import (
    Asset, LedgerEntry, LedgerEntryData, LedgerEntryType, LedgerKey,
    ManageOfferSuccessResult, ManageOfferSuccessResultOffer, OfferEntry,
    OfferEntryFlags, OperationType, PathPaymentSuccess, Price,
    SimplePaymentResult, TrustLineFlags, _Ext,
)
from .account_helpers import (
    INT64_MAX, change_subentries, load_account, load_trustline,
)
from .offer_exchange import (
    CrossResult, _available_to_receive, _available_to_sell, _credit, _debit,
    acquire_liabilities, adjust_offer, cross_offers, offer_liabilities,
    release_liabilities,
)
from .operation_frame import OperationFrame, register_op
from .operations import _valid_asset


class ManageOfferResultCode:
    SUCCESS = 0
    MALFORMED = -1
    SELL_NO_TRUST = -2
    SELL_NOT_AUTHORIZED = -3
    BUY_NO_TRUST = -4
    BUY_NOT_AUTHORIZED = -5
    LINE_FULL = -6
    UNDERFUNDED = -7
    CROSS_SELF = -8
    SELL_NO_ISSUER = -9
    BUY_NO_ISSUER = -10
    NOT_FOUND = -11
    LOW_RESERVE = -12


class PathPaymentResultCode:
    SUCCESS = 0
    MALFORMED = -1
    UNDERFUNDED = -2
    SRC_NO_TRUST = -3
    SRC_NOT_AUTHORIZED = -4
    NO_DESTINATION = -5
    NO_TRUST = -6
    NOT_AUTHORIZED = -7
    LINE_FULL = -8
    NO_ISSUER = -9
    TOO_FEW_OFFERS = -10
    OFFER_CROSS_SELF = -11
    OVER_SENDMAX = -12       # strict receive
    UNDER_DESTMIN = -12      # strict send (same wire value, different arm)


def _offer_deleted() -> ManageOfferSuccessResultOffer:
    return ManageOfferSuccessResultOffer(2, None)


class _ManageOfferBase(OperationFrame):
    """Shared crossing + book-entry logic (reference
    ManageOfferOpFrameBase)."""

    passive = False
    # True for ManageBuyOffer: the crossing/residual caps are expressed
    # on the buying (wheat) side instead of the sell amount
    is_buy = False

    # subclass accessors -----------------------------------------------------
    def _params(self) -> Tuple[Asset, Asset, int, Price, int]:
        """(selling, buying, sell_amount, price(buying per selling),
        offer_id)"""
        raise NotImplementedError

    def _is_delete(self) -> bool:
        selling, buying, amount, price, offer_id = self._params()
        return amount == 0 and offer_id != 0

    def _wheat_receive_cap(self) -> int:
        """Cap on units of `buying` acquired while crossing AND promised
        by the residual. INT64_MAX for sell offers (the sell amount caps
        the other side); ManageBuyOffer overrides with buyAmount
        (reference applyOperationSpecificLimits,
        ManageBuyOfferOpFrame.cpp:69-76)."""
        return INT64_MAX

    def do_check_valid(self, header) -> bool:
        selling, buying, amount, price, offer_id = self._params()
        if not _valid_asset(selling) or not _valid_asset(buying) or \
                selling == buying:
            return self.set_inner(ManageOfferResultCode.MALFORMED)
        if price.n <= 0 or price.d <= 0 or amount < 0 or offer_id < 0:
            return self.set_inner(ManageOfferResultCode.MALFORMED)
        if amount == 0 and offer_id == 0:
            return self.set_inner(ManageOfferResultCode.MALFORMED)
        return self.set_inner(
            ManageOfferResultCode.SUCCESS,
            ManageOfferSuccessResult(offersClaimed=[],
                                     offer=_offer_deleted()))

    def _check_trust(self, ltx, src_id, selling: Asset,
                     buying: Asset, header) -> Optional[int]:
        """Posting/updating needs FULL authorization on both lines;
        maintain-liabilities is not enough (reference checkOfferValid,
        ManageOfferOpFrameBase.cpp:28-97; issuer-existence checks only
        pre-13)."""
        if not selling.is_native and src_id != selling.issuer:
            if header.ledgerVersion < 13 and ltx.load_without_record(
                    LedgerKey.account(selling.issuer)) is None:
                return ManageOfferResultCode.SELL_NO_ISSUER
            tl = ltx.load_without_record(
                LedgerKey.trustline(src_id, selling))
            if tl is None:
                return ManageOfferResultCode.SELL_NO_TRUST
            if not (tl.data.value.flags & TrustLineFlags.AUTHORIZED_FLAG):
                return ManageOfferResultCode.SELL_NOT_AUTHORIZED
        if not buying.is_native and src_id != buying.issuer:
            if header.ledgerVersion < 13 and ltx.load_without_record(
                    LedgerKey.account(buying.issuer)) is None:
                return ManageOfferResultCode.BUY_NO_ISSUER
            tl = ltx.load_without_record(
                LedgerKey.trustline(src_id, buying))
            if tl is None:
                return ManageOfferResultCode.BUY_NO_TRUST
            if not (tl.data.value.flags & TrustLineFlags.AUTHORIZED_FLAG):
                return ManageOfferResultCode.BUY_NOT_AUTHORIZED
        return None

    def do_apply(self, ltx) -> bool:
        """Reference ManageOfferOpFrameBase::doApply:200-460: release the
        old offer's liabilities, check the posted offer is fully backable,
        cross, clamp the residual to capacity, acquire liabilities."""
        selling, buying, amount, price, offer_id = self._params()
        src_id = self.source_account_id()
        header = ltx.load_header()

        if not self._is_delete():
            # deletes skip trust checks entirely (reference
            # checkOfferValid "don't bother loading trust lines")
            err = self._check_trust(ltx, src_id, selling, buying, header)
            if err is not None:
                return self.set_inner(err)

        existing_flags = 0
        is_update = False
        if offer_id != 0:
            key = LedgerKey.offer(src_id, offer_id)
            existing = ltx.load(key)
            if existing is None:
                return self.set_inner(ManageOfferResultCode.NOT_FOUND)
            # free the balance this offer encumbered before erasing it
            release_liabilities(ltx, existing.data.value)
            existing_flags = existing.data.value.flags
            ltx.erase(key)  # pulled from the book; subentry kept for now
            is_update = True

        if self._is_delete():
            src = load_account(ltx, src_id)
            change_subentries(header, src, -1)
            return self.set_inner(
                ManageOfferResultCode.SUCCESS,
                ManageOfferSuccessResult(offersClaimed=[],
                                         offer=_offer_deleted()))

        # the posted offer must be fully backable by the available limit
        # and balance (reference computeOfferExchangeParameters:161-186);
        # a NEW offer also consumes a subentry's reserve first
        if not is_update:
            src = load_account(ltx, src_id)
            if not change_subentries(header, src, +1):
                return self.set_inner(ManageOfferResultCode.LOW_RESERVE)
        buy_liab, sell_liab = offer_liabilities(price.n, price.d, amount)
        max_sell_funds = _available_to_sell(ltx, src_id, selling)
        recv_cap = _available_to_receive(ltx, src_id, buying)
        if recv_cap < buy_liab or recv_cap <= 0:
            return self.set_inner(ManageOfferResultCode.LINE_FULL)
        if max_sell_funds < sell_liab:
            return self.set_inner(ManageOfferResultCode.UNDERFUNDED)
        if max_sell_funds <= 0 and amount > 0:
            return self.set_inner(ManageOfferResultCode.UNDERFUNDED)

        # a buy offer's caps live on the wheat (buying) side — the sell
        # side is limited by funds only (reference
        # applyOperationSpecificLimits: sell offers clamp sheep, buy
        # offers clamp wheat)
        wheat_cap = self._wheat_receive_cap()
        max_sell = max_sell_funds if self.is_buy \
            else min(amount, max_sell_funds)
        code, bought, sold, claims = cross_offers(
            ltx, src_id, selling, buying,
            max_buy=min(recv_cap, wheat_cap),
            max_sell=max_sell, price_limit=(price.n, price.d),
            passive_taker=self.passive)
        if code == CrossResult.CROSSED_SELF:
            return self.set_inner(ManageOfferResultCode.CROSS_SELF)
        # settle taker net amounts
        assert _debit(ltx, src_id, selling, sold)
        assert _credit(ltx, src_id, buying, bought)

        # residual amount clamped to post-trade capacity (reference
        # adjustOffer idempotence, ManageOfferOpFrameBase.cpp:375-402:
        # v10+ only — the legacy path posts the raw remainder). For a buy
        # offer, the residual promises the REMAINING buy amount
        sheep_resid = INT64_MAX if self.is_buy else (amount - sold)
        if header.ledgerVersion >= 10:
            remaining = adjust_offer(
                price.n, price.d,
                min(sheep_resid, _available_to_sell(ltx, src_id, selling)),
                min(_available_to_receive(ltx, src_id, buying),
                    wheat_cap - bought))
        else:
            remaining = max_sell - sold

        if remaining > 0:
            if is_update:
                new_id = offer_id
            else:
                header.idPool += 1
                new_id = header.idPool
            flags = OfferEntryFlags.PASSIVE_FLAG if (
                self.passive or
                (existing_flags & OfferEntryFlags.PASSIVE_FLAG)) else 0
            oe = OfferEntry(sellerID=src_id, offerID=new_id, selling=selling,
                            buying=buying, amount=remaining, price=price,
                            flags=flags, ext=_Ext.v0())
            entry = LedgerEntry(
                lastModifiedLedgerSeq=header.ledgerSeq,
                data=LedgerEntryData(LedgerEntryType.OFFER, oe),
                ext=_Ext.v0())
            ltx.create(entry)
            assert acquire_liabilities(ltx, oe), \
                "acquire after backability check must succeed"
            arm = ManageOfferSuccessResultOffer(1 if is_update else 0, oe)
        else:
            # no offer stays: give back the subentry taken above (new) or
            # the one the erased offer held (update)
            src = load_account(ltx, src_id)
            change_subentries(header, src, -1)
            arm = _offer_deleted()
        return self.set_inner(
            ManageOfferResultCode.SUCCESS,
            ManageOfferSuccessResult(offersClaimed=claims, offer=arm))


@register_op
class ManageSellOfferOpFrame(_ManageOfferBase):
    op_type = OperationType.MANAGE_SELL_OFFER

    def _params(self):
        b = self.op.body.value
        return b.selling, b.buying, b.amount, b.price, b.offerID


@register_op
class CreatePassiveSellOfferOpFrame(_ManageOfferBase):
    op_type = OperationType.CREATE_PASSIVE_SELL_OFFER
    passive = True

    def _params(self):
        b = self.op.body.value
        return b.selling, b.buying, b.amount, b.price, 0


@register_op
class ManageBuyOfferOpFrame(_ManageOfferBase):
    op_type = OperationType.MANAGE_BUY_OFFER
    is_buy = True

    def is_version_supported(self, ledger_version: int) -> bool:
        # introduced in protocol 11 (reference
        # ManageBuyOfferOpFrame::isVersionSupported)
        return ledger_version >= 11

    def _wheat_receive_cap(self) -> int:
        b = self.op.body.value
        return b.buyAmount if b.buyAmount > 0 else INT64_MAX

    def _is_delete(self) -> bool:
        # delete is buyAmount == 0 — NOT the converted sell amount,
        # which floors to 0 for small buyAmount at sub-unit prices
        # (reference isDeleteOffer, ManageBuyOfferOpFrame.cpp:46-49)
        b = self.op.body.value
        return b.buyAmount == 0 and b.offerID != 0

    def _params(self):
        b = self.op.body.value
        # buy price is buying-per-selling from the buyer's view: price of
        # buyAmount units. Equivalent sell offer: sell amount =
        # buyAmount*n/d (rounded down), price inverted.
        sell_amount = (b.buyAmount * b.price.n) // b.price.d \
            if b.buyAmount > 0 else 0
        inv = Price(n=b.price.d, d=b.price.n)
        return b.selling, b.buying, sell_amount, inv, b.offerID

    def do_check_valid(self, header) -> bool:
        b = self.op.body.value
        if not _valid_asset(b.selling) or not _valid_asset(b.buying) or \
                b.selling == b.buying:
            return self.set_inner(ManageOfferResultCode.MALFORMED)
        if b.price.n <= 0 or b.price.d <= 0 or b.buyAmount < 0 or \
                b.offerID < 0:
            return self.set_inner(ManageOfferResultCode.MALFORMED)
        if b.buyAmount == 0 and b.offerID == 0:
            return self.set_inner(ManageOfferResultCode.MALFORMED)
        return self.set_inner(
            ManageOfferResultCode.SUCCESS,
            ManageOfferSuccessResult(offersClaimed=[],
                                     offer=_offer_deleted()))


class _PathPaymentBase(OperationFrame):
    def _dest_credit_code(self, ltx, dest_id, asset: Asset,
                          amount: int) -> Optional[int]:
        if asset.is_native:
            # int64 balance headroom (reference canBuyAtMost on native:
            # crediting past INT64_MAX is LINE_FULL, not a crash)
            if _available_to_receive(ltx, dest_id, asset) < amount:
                return PathPaymentResultCode.LINE_FULL
            return None
        if dest_id == asset.issuer:
            return None
        if ltx.load_without_record(
                LedgerKey.account(asset.issuer)) is None:
            return PathPaymentResultCode.NO_ISSUER
        tl = ltx.load_without_record(LedgerKey.trustline(dest_id, asset))
        if tl is None:
            return PathPaymentResultCode.NO_TRUST
        t = tl.data.value
        if not (t.flags & TrustLineFlags.AUTHORIZED_FLAG):
            return PathPaymentResultCode.NOT_AUTHORIZED
        if _available_to_receive(ltx, dest_id, asset) < amount:
            return PathPaymentResultCode.LINE_FULL
        return None

    def _src_debit_code(self, ltx, src_id, asset: Asset,
                        amount: int) -> Optional[int]:
        if asset.is_native:
            if _available_to_sell(ltx, src_id, asset) < amount:
                return PathPaymentResultCode.UNDERFUNDED
            return None
        if src_id == asset.issuer:
            return None
        if ltx.load_without_record(
                LedgerKey.account(asset.issuer)) is None:
            return PathPaymentResultCode.NO_ISSUER
        tl = ltx.load_without_record(LedgerKey.trustline(src_id, asset))
        if tl is None:
            return PathPaymentResultCode.SRC_NO_TRUST
        t = tl.data.value
        if not (t.flags & TrustLineFlags.AUTHORIZED_FLAG):
            return PathPaymentResultCode.SRC_NOT_AUTHORIZED
        if _available_to_sell(ltx, src_id, asset) < amount:
            return PathPaymentResultCode.UNDERFUNDED
        return None


@register_op
class PathPaymentStrictReceiveOpFrame(_PathPaymentBase):
    op_type = OperationType.PATH_PAYMENT_STRICT_RECEIVE

    def do_check_valid(self, header) -> bool:
        b = self.op.body.value
        if b.destAmount <= 0 or b.sendMax <= 0:
            return self.set_inner(PathPaymentResultCode.MALFORMED)
        assets = [b.sendAsset, b.destAsset] + list(b.path)
        if not all(_valid_asset(a) for a in assets):
            return self.set_inner(PathPaymentResultCode.MALFORMED)
        return self.set_inner(
            PathPaymentResultCode.SUCCESS,
            PathPaymentSuccess(offers=[], last=SimplePaymentResult(
                destination=self.source_account_id(),
                asset=b.destAsset, amount=0)))

    def do_apply(self, ltx) -> bool:
        b = self.op.body.value
        src_id = self.source_account_id()
        dest_id = b.destination.account_id
        if load_account(ltx, dest_id) is None:
            return self.set_inner(PathPaymentResultCode.NO_DESTINATION)
        code = self._dest_credit_code(ltx, dest_id, b.destAsset,
                                      b.destAmount)
        if code is not None:
            return self.set_inner(code)

        chain = [b.sendAsset] + list(b.path) + [b.destAsset]
        needed = b.destAmount
        all_claims = []
        # walk backwards: acquire `needed` of chain[i+1] with chain[i]
        for i in range(len(chain) - 2, -1, -1):
            have_asset, want_asset = chain[i], chain[i + 1]
            if have_asset == want_asset:
                continue
            res, bought, sold, claims = cross_offers(
                ltx, src_id, have_asset, want_asset, max_buy=needed,
                max_sell=INT64_MAX)
            if res == CrossResult.CROSSED_SELF:
                return self.set_inner(PathPaymentResultCode.OFFER_CROSS_SELF)
            if bought < needed:
                return self.set_inner(PathPaymentResultCode.TOO_FEW_OFFERS)
            all_claims = claims + all_claims
            needed = sold
        if needed > b.sendMax:
            return self.set_inner(PathPaymentResultCode.OVER_SENDMAX)
        code = self._src_debit_code(ltx, src_id, b.sendAsset, needed)
        if code is not None:
            return self.set_inner(code)
        assert _debit(ltx, src_id, b.sendAsset, needed)
        assert _credit(ltx, dest_id, b.destAsset, b.destAmount)
        return self.set_inner(
            PathPaymentResultCode.SUCCESS,
            PathPaymentSuccess(
                offers=all_claims,
                last=SimplePaymentResult(destination=dest_id,
                                         asset=b.destAsset,
                                         amount=b.destAmount)))


@register_op
class PathPaymentStrictSendOpFrame(_PathPaymentBase):
    op_type = OperationType.PATH_PAYMENT_STRICT_SEND

    def is_version_supported(self, ledger_version: int) -> bool:
        # introduced by CAP-0018's companion in protocol 12 (reference
        # PathPaymentStrictSendOpFrame::isVersionSupported)
        return ledger_version >= 12

    def do_check_valid(self, header) -> bool:
        b = self.op.body.value
        if b.sendAmount <= 0 or b.destMin <= 0:
            return self.set_inner(PathPaymentResultCode.MALFORMED)
        assets = [b.sendAsset, b.destAsset] + list(b.path)
        if not all(_valid_asset(a) for a in assets):
            return self.set_inner(PathPaymentResultCode.MALFORMED)
        return self.set_inner(
            PathPaymentResultCode.SUCCESS,
            PathPaymentSuccess(offers=[], last=SimplePaymentResult(
                destination=self.source_account_id(),
                asset=b.destAsset, amount=0)))

    def do_apply(self, ltx) -> bool:
        b = self.op.body.value
        src_id = self.source_account_id()
        dest_id = b.destination.account_id
        if load_account(ltx, dest_id) is None:
            return self.set_inner(PathPaymentResultCode.NO_DESTINATION)
        code = self._src_debit_code(ltx, src_id, b.sendAsset, b.sendAmount)
        if code is not None:
            return self.set_inner(code)
        assert _debit(ltx, src_id, b.sendAsset, b.sendAmount)

        chain = [b.sendAsset] + list(b.path) + [b.destAsset]
        have = b.sendAmount
        all_claims = []
        for i in range(len(chain) - 1):
            have_asset, want_asset = chain[i], chain[i + 1]
            if have_asset == want_asset:
                continue
            res, bought, sold, claims = cross_offers(
                ltx, src_id, have_asset, want_asset, max_buy=INT64_MAX,
                max_sell=have)
            if res == CrossResult.CROSSED_SELF:
                return self.set_inner(PathPaymentResultCode.OFFER_CROSS_SELF)
            if bought == 0 or sold < have:
                # couldn't convert everything: not enough offers
                return self.set_inner(PathPaymentResultCode.TOO_FEW_OFFERS)
            all_claims += claims
            have = bought
        if have < b.destMin:
            return self.set_inner(PathPaymentResultCode.UNDER_DESTMIN)
        code = self._dest_credit_code(ltx, dest_id, b.destAsset, have)
        if code is not None:
            return self.set_inner(code)
        assert _credit(ltx, dest_id, b.destAsset, have)
        return self.set_inner(
            PathPaymentResultCode.SUCCESS,
            PathPaymentSuccess(
                offers=all_claims,
                last=SimplePaymentResult(destination=dest_id,
                                         asset=b.destAsset, amount=have)))
