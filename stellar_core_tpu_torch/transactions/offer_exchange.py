"""OfferExchange: the order-book crossing engine.

Copied from `stellar_core_tpu/transactions/offer_exchange.py` at commit
183ecd9; carry a fix in either copy to the other.

Role parity: reference `src/transactions/OfferExchange.cpp` (exchangeV10,
crossOfferV10, convertWithOffers) and `util/numeric.cpp` (128-bit rounding).
Python integers are arbitrary precision, so the exchange math here is exact
rational arithmetic with explicit rounding direction instead of 128-bit
intrinsics.

Vocabulary (as in the reference): the resting offer sells WHEAT and buys
SHEEP at price n/d = sheep per wheat. The taker receives wheat and sends
sheep.

Rounding contract: the resting offer owner never receives less than the
price implies — sheep is rounded UP for a given wheat, or wheat rounded
DOWN for a given sheep budget. Zero-amount trades are rejected.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..xdr import (
    Asset, ClaimOfferAtom, LedgerEntry, LedgerKey, OfferEntryFlags,
    TrustLineFlags, ledger_entry_key,
)
from .account_helpers import (
    INT64_MAX, LIABILITIES_VERSION, add_balance, add_buying_liabilities,
    add_selling_liabilities, add_trust_balance, change_subentries,
    get_buying_liabilities, get_selling_liabilities, load_account,
    load_trustline, min_balance,
)

# either auth level lets EXISTING offers execute (CAP-0018)
_AUTH_ANY = TrustLineFlags.AUTH_LEVELS_MASK


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def exchange(offer_amount: int, n: int, d: int, max_wheat_receive: int,
             max_sheep_send: int) -> Tuple[int, int]:
    """Exact crossing amounts: returns (wheat_received, sheep_sent)."""
    wheat = min(offer_amount, max_wheat_receive)
    if wheat <= 0 or max_sheep_send <= 0:
        return 0, 0
    sheep = _ceil_div(wheat * n, d)
    if sheep > max_sheep_send:
        wheat = (max_sheep_send * d) // n
        wheat = min(wheat, offer_amount, max_wheat_receive)
        sheep = _ceil_div(wheat * n, d)
    if wheat <= 0 or sheep <= 0 or sheep > max_sheep_send:
        return 0, 0
    return wheat, sheep


def _available_to_sell(ltx, account_id, asset: Asset) -> int:
    """How much of `asset` the account can actually deliver (reference
    canSellAtMost: available balance net of reserve and SELLING
    liabilities)."""
    header = ltx.get_header()
    if asset.is_native:
        acc_e = ltx.load_without_record(LedgerKey.account(account_id))
        if acc_e is None:
            return 0
        acc = acc_e.data.value
        avail = acc.balance - min_balance(header, acc.numSubEntries)
        if header.ledgerVersion >= LIABILITIES_VERSION:
            avail -= get_selling_liabilities(header, acc_e)
        return max(0, avail)
    if account_id == asset.issuer:
        return INT64_MAX
    tl_e = ltx.load_without_record(LedgerKey.trustline(account_id, asset))
    if tl_e is None or not (tl_e.data.value.flags & _AUTH_ANY):
        # maintain-liabilities is enough to EXECUTE existing offers
        # (reference canSellAtMost isAuthorizedToMaintainLiabilities)
        return 0
    avail = tl_e.data.value.balance
    if header.ledgerVersion >= LIABILITIES_VERSION:
        avail -= get_selling_liabilities(header, tl_e)
    return max(0, avail)


def _available_to_receive(ltx, account_id, asset: Asset) -> int:
    """Reference canBuyAtMost: headroom net of BUYING liabilities."""
    header = ltx.get_header()
    if asset.is_native:
        acc_e = ltx.load_without_record(LedgerKey.account(account_id))
        if acc_e is None:
            return 0
        out = INT64_MAX - acc_e.data.value.balance
        if header.ledgerVersion >= LIABILITIES_VERSION:
            out -= get_buying_liabilities(header, acc_e)
        return max(0, out)
    if account_id == asset.issuer:
        return INT64_MAX
    tl_e = ltx.load_without_record(LedgerKey.trustline(account_id, asset))
    if tl_e is None or not (tl_e.data.value.flags & _AUTH_ANY):
        # (reference canBuyAtMost isAuthorizedToMaintainLiabilities)
        return 0
    tl = tl_e.data.value
    out = tl.limit - tl.balance
    if header.ledgerVersion >= LIABILITIES_VERSION:
        out -= get_buying_liabilities(header, tl_e)
    return max(0, out)


def _credit(ltx, account_id, asset: Asset, amount: int) -> bool:
    if amount == 0:
        return True
    header = ltx.get_header()
    if asset.is_native:
        e = load_account(ltx, account_id)
        return e is not None and add_balance(header, e, amount)
    if account_id == asset.issuer:
        return True  # issuer receiving its own asset burns it
    e = load_trustline(ltx, account_id, asset)
    if e is None:
        return False
    return add_trust_balance(header, e, amount)


def _debit(ltx, account_id, asset: Asset, amount: int) -> bool:
    if amount == 0:
        return True
    header = ltx.get_header()
    if asset.is_native:
        e = load_account(ltx, account_id)
        return e is not None and add_balance(header, e, -amount)
    if account_id == asset.issuer:
        return True  # issuer paying its own asset mints it
    e = load_trustline(ltx, account_id, asset)
    if e is None:
        return False
    return add_trust_balance(header, e, -amount)


# -- offer liabilities (reference TransactionUtils.cpp:590-632 + ManageOffer
#    getOfferBuying/SellingLiabilities) --------------------------------------

def offer_liabilities(n: int, d: int, amount: int):
    """(buying, selling) liabilities a resting offer of `amount` at price
    n/d encumbers: the owner owes `amount` wheat (selling) and has claim
    to ceil(amount*n/d) sheep (buying)."""
    wheat, sheep = exchange(amount, n, d, INT64_MAX, INT64_MAX)
    return sheep, wheat


def adjust_offer(n: int, d: int, max_sell: int, max_receive: int) -> int:
    """Largest posting amount backable by max_sell/max_receive (reference
    adjustOffer, OfferExchange.cpp:903: exchangeV10 with unbounded taker,
    NORMAL rounding — idempotent on adjusted offers). Models a buyer with
    no limits crossing the offer, so sheep always stays: round toward the
    taker, then zero the offer entirely if either side would eat more
    than 1% price error (checkPriceErrorBound, OfferExchange.cpp:174) —
    this is what deletes dust offers at the v10 upgrade."""
    if max_sell <= 0 or max_receive <= 0:
        return 0
    wheat_value = min(max_sell * n, max_receive * d)
    if n > d:  # wheat more valuable
        wheat = wheat_value // n
        sheep = (wheat * n) // d
    else:
        sheep = wheat_value // d
        wheat = _ceil_div(sheep * d, n)
    if wheat <= 0 or sheep <= 0:
        return 0
    # |100·n·wheat − 100·d·sheep| ≤ n·wheat  (≤1% relative price error)
    if abs(100 * n * wheat - 100 * d * sheep) > n * wheat:
        return 0
    return wheat


def apply_offer_liabilities(ltx, offer, sign: int) -> bool:
    """Acquire (+1) or release (-1) the liabilities an offer encumbers on
    its owner's account/trustlines (reference
    acquireOrReleaseLiabilities, TransactionUtils.cpp:134-206)."""
    header = ltx.get_header()
    if header.ledgerVersion < LIABILITIES_VERSION:
        return True
    buying_liab, selling_liab = offer_liabilities(
        offer.price.n, offer.price.d, offer.amount)
    seller = offer.sellerID
    ok = True
    if offer.buying.is_native:
        e = load_account(ltx, seller)
        ok = e is not None and \
            add_buying_liabilities(header, e, sign * buying_liab)
    elif seller != offer.buying.issuer:
        e = load_trustline(ltx, seller, offer.buying)
        ok = e is not None and \
            add_buying_liabilities(header, e, sign * buying_liab)
    if not ok:
        return False
    if offer.selling.is_native:
        e = load_account(ltx, seller)
        ok = e is not None and \
            add_selling_liabilities(header, e, sign * selling_liab)
    elif seller != offer.selling.issuer:
        e = load_trustline(ltx, seller, offer.selling)
        ok = e is not None and \
            add_selling_liabilities(header, e, sign * selling_liab)
    return ok


def acquire_liabilities(ltx, offer) -> bool:
    return apply_offer_liabilities(ltx, offer, +1)


def release_liabilities(ltx, offer) -> None:
    ok = apply_offer_liabilities(ltx, offer, -1)
    assert ok, "releasing offer liabilities must succeed"


class CrossResult:
    SUCCESS = 0
    PARTIAL = 1          # book exhausted before filling
    CROSSED_SELF = 2
    BAD_PRICE_LIMIT = 3  # remaining book worse than limit (manage offer)


def cross_offers(ltx, taker_id, sell_asset: Asset, buy_asset: Asset,
                 max_buy: int, max_sell: int,
                 price_limit: Optional[Tuple[int, int]] = None,
                 passive_taker: bool = False
                 ) -> Tuple[int, int, int, List[ClaimOfferAtom]]:
    """Cross the (selling=buy_asset, buying=sell_asset) book until the taker
    has bought max_buy, spent max_sell, hit the price limit, or emptied the
    book.

    price_limit (n, d): the taker's own price (sell per buy). Resting offers
    with sheep-per-wheat price strictly greater than d/n don't cross; at
    exactly d/n, a passive taker doesn't cross.

    Returns (code, bought, sold, claims). Offer owners' balances are
    adjusted in place; the taker's are NOT (caller settles net amounts).
    """
    bought = 0
    sold = 0
    claims: List[ClaimOfferAtom] = []
    while bought < max_buy and sold < max_sell:
        best = ltx.best_offer(buy_asset, sell_asset)
        if best is None:
            return CrossResult.PARTIAL, bought, sold, claims
        offer = best.data.value
        n, d = offer.price.n, offer.price.d
        if price_limit is not None:
            ln, ld = price_limit
            # offer price (sheep/wheat) vs taker reciprocal limit (ld/ln)
            lhs = n * ln
            rhs = d * ld
            if lhs > rhs:
                return CrossResult.BAD_PRICE_LIMIT, bought, sold, claims
            if lhs == rhs and (passive_taker or
                               (offer.flags & OfferEntryFlags.PASSIVE_FLAG)):
                return CrossResult.BAD_PRICE_LIMIT, bought, sold, claims
        if offer.sellerID == taker_id:
            return CrossResult.CROSSED_SELF, bought, sold, claims

        owner = offer.sellerID
        key = ledger_entry_key(best)
        # release the resting offer's liabilities up front so the owner's
        # full capacity is visible to the exchange; re-acquired below if
        # the offer survives (reference crossOfferV10 shape)
        release_liabilities(ltx, offer)
        wheat_cap = min(offer.amount,
                        _available_to_sell(ltx, owner, buy_asset))
        recv_cap = _available_to_receive(ltx, owner, sell_asset)
        if recv_cap < INT64_MAX:
            wheat_cap = min(wheat_cap, (recv_cap * d) // n)
        if wheat_cap <= 0:
            # unfunded/unreceivable offer: garbage-collect it
            _erase_offer(ltx, key, owner)
            continue
        wheat, sheep = exchange(wheat_cap, n, d, max_buy - bought,
                                max_sell - sold)
        if wheat == 0:
            # taker exhausted; restore the resting offer's liabilities
            assert acquire_liabilities(ltx, offer), \
                "re-acquire after release must succeed"
            return CrossResult.SUCCESS, bought, sold, claims
        # settle the owner's side
        ok1 = _debit(ltx, owner, buy_asset, wheat)
        ok2 = _credit(ltx, owner, sell_asset, sheep)
        assert ok1 and ok2, "owner settlement failed after capacity check"
        live = ltx.load(key)
        o = live.data.value
        o.amount -= wheat
        if o.amount <= 0 or wheat == wheat_cap and wheat < offer.amount:
            # fully taken, or residual is unfunded
            _erase_offer(ltx, key, owner)
        elif ltx.get_header().ledgerVersion >= 10:
            # clamp the residual to what the owner can still back, then
            # re-encumber (reference performExchange newAmount + acquire;
            # v10+ only — the legacy engine keeps the raw remainder)
            o.amount = adjust_offer(
                n, d, min(o.amount, _available_to_sell(ltx, owner,
                                                       buy_asset)),
                _available_to_receive(ltx, owner, sell_asset))
            if o.amount <= 0:
                _erase_offer(ltx, key, owner)
            else:
                assert acquire_liabilities(ltx, o), \
                    "re-acquire of clamped residual must succeed"
        bought += wheat
        sold += sheep
        claims.append(ClaimOfferAtom(
            sellerID=owner, offerID=offer.offerID, assetSold=buy_asset,
            amountSold=wheat, assetBought=sell_asset, amountBought=sheep))
    return CrossResult.SUCCESS, bought, sold, claims


def _erase_offer(ltx, key: LedgerKey, owner) -> None:
    ltx.erase(key)
    acc = load_account(ltx, owner)
    if acc is not None:
        change_subentries(ltx.get_header(), acc, -1)
