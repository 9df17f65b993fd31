"""Concrete operation frames (non-offer ops).

Copied from `stellar_core_tpu/transactions/operations.py` at commit
5e00e2c; carry a fix in either copy to the other.

Role parity: reference `src/transactions/*OpFrame.cpp` for: create-account,
payment, set-options, change-trust, allow-trust, account-merge, inflation,
manage-data, bump-sequence. Result codes mirror the public protocol enums.
Offers and path payments live in offers.py (they share OfferExchange).
"""

from __future__ import annotations

from ..xdr import (
    AccountFlags, Asset, AssetType, DataEntry, LedgerEntry, LedgerEntryData,
    LedgerEntryType, LedgerKey, OperationType, SignerKeyType, TrustLineEntry,
    TrustLineEntryExt, TrustLineFlags, _Ext,
)
from .account_helpers import (
    INT64_MAX, ThresholdLevel, add_balance, add_trust_balance,
    change_subentries, is_auth_required, is_immutable_auth, load_account,
    load_trustline, make_account_entry, min_balance,
    starting_sequence_number,
)
from .operation_frame import OperationFrame, register_op


# -- result codes (protocol enums) ------------------------------------------

class CreateAccountResultCode:
    SUCCESS = 0
    MALFORMED = -1
    UNDERFUNDED = -2
    LOW_RESERVE = -3
    ALREADY_EXIST = -4


class PaymentResultCode:
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


class SetOptionsResultCode:
    SUCCESS = 0
    LOW_RESERVE = -1
    TOO_MANY_SIGNERS = -2
    BAD_FLAGS = -3
    INVALID_INFLATION = -4
    CANT_CHANGE = -5
    UNKNOWN_FLAG = -6
    THRESHOLD_OUT_OF_RANGE = -7
    BAD_SIGNER = -8
    INVALID_HOME_DOMAIN = -9


class ChangeTrustResultCode:
    SUCCESS = 0
    MALFORMED = -1
    NO_ISSUER = -2
    INVALID_LIMIT = -3
    LOW_RESERVE = -4
    SELF_NOT_ALLOWED = -5


class AllowTrustResultCode:
    SUCCESS = 0
    MALFORMED = -1
    NO_TRUST_LINE = -2
    TRUST_NOT_REQUIRED = -3
    CANT_REVOKE = -4
    SELF_NOT_ALLOWED = -5


class AccountMergeResultCode:
    SUCCESS = 0
    MALFORMED = -1
    NO_ACCOUNT = -2
    IMMUTABLE_SET = -3
    HAS_SUB_ENTRIES = -4
    SEQNUM_TOO_FAR = -5
    DEST_FULL = -6


class InflationResultCode:
    SUCCESS = 0
    NOT_TIME = -1


class ManageDataResultCode:
    SUCCESS = 0
    NOT_SUPPORTED_YET = -1
    NAME_NOT_FOUND = -2
    LOW_RESERVE = -3
    INVALID_NAME = -4


class BumpSequenceResultCode:
    SUCCESS = 0
    BAD_SEQ = -1


def _valid_asset(asset: Asset) -> bool:
    if asset.is_native:
        return True
    code = asset.value.assetCode
    trimmed = code.rstrip(b"\x00")
    if not trimmed or b"\x00" in trimmed:
        return False
    if asset.disc == AssetType.ASSET_TYPE_CREDIT_ALPHANUM4:
        return 1 <= len(trimmed) <= 4
    return 5 <= len(trimmed) <= 12


@register_op
class CreateAccountOpFrame(OperationFrame):
    op_type = OperationType.CREATE_ACCOUNT

    def do_check_valid(self, header) -> bool:
        if self.op.body.value.startingBalance <= 0:
            return self.set_inner(CreateAccountResultCode.MALFORMED)
        if self.op.body.value.destination == self.source_account_id():
            return self.set_inner(CreateAccountResultCode.MALFORMED)
        return self.set_inner(CreateAccountResultCode.SUCCESS)

    def do_apply(self, ltx) -> bool:
        body = self.op.body.value
        header = ltx.load_header()
        dest_key = LedgerKey.account(body.destination)
        if ltx.load_without_record(dest_key) is not None:
            return self.set_inner(CreateAccountResultCode.ALREADY_EXIST)
        if body.startingBalance < min_balance(header, 0):
            return self.set_inner(CreateAccountResultCode.LOW_RESERVE)
        src = load_account(ltx, self.source_account_id())
        if not add_balance(header, src, -body.startingBalance):
            return self.set_inner(CreateAccountResultCode.UNDERFUNDED)
        entry = make_account_entry(
            body.destination, body.startingBalance,
            starting_sequence_number(header), header.ledgerSeq)
        ltx.create(entry)
        return self.set_inner(CreateAccountResultCode.SUCCESS)


@register_op
class PaymentOpFrame(OperationFrame):
    op_type = OperationType.PAYMENT

    def do_check_valid(self, header) -> bool:
        body = self.op.body.value
        if body.amount <= 0 or not _valid_asset(body.asset):
            return self.set_inner(PaymentResultCode.MALFORMED)
        return self.set_inner(PaymentResultCode.SUCCESS)

    def do_apply(self, ltx) -> bool:
        body = self.op.body.value
        header = ltx.load_header()
        src_id = self.source_account_id()
        dest_id = body.destination.account_id
        asset, amount = body.asset, body.amount

        dest_acc = load_account(ltx, dest_id)
        if dest_acc is None:
            return self.set_inner(PaymentResultCode.NO_DESTINATION)

        if asset.is_native:
            src = load_account(ltx, src_id)
            if src_id != dest_id:
                if not add_balance(header, src, -amount):
                    return self.set_inner(PaymentResultCode.UNDERFUNDED)
                if not add_balance(header, dest_acc, amount):
                    return self.set_inner(PaymentResultCode.LINE_FULL)
            return self.set_inner(PaymentResultCode.SUCCESS)

        issuer = asset.issuer
        # source side (liability-aware: cannot spend encumbered balance)
        if src_id != issuer:
            stl = load_trustline(ltx, src_id, asset)
            if stl is None:
                return self.set_inner(PaymentResultCode.SRC_NO_TRUST)
            tl = stl.data.value
            if not (tl.flags & TrustLineFlags.AUTHORIZED_FLAG):
                return self.set_inner(PaymentResultCode.SRC_NOT_AUTHORIZED)
            if not add_trust_balance(header, stl, -amount):
                return self.set_inner(PaymentResultCode.UNDERFUNDED)
        else:
            if load_account(ltx, issuer) is None:
                return self.set_inner(PaymentResultCode.NO_ISSUER)
        # destination side (cannot receive into buying-encumbered headroom)
        if dest_id != issuer:
            dtl = load_trustline(ltx, dest_id, asset)
            if dtl is None:
                return self.set_inner(PaymentResultCode.NO_TRUST)
            tl = dtl.data.value
            if not (tl.flags & TrustLineFlags.AUTHORIZED_FLAG):
                return self.set_inner(PaymentResultCode.NOT_AUTHORIZED)
            if not add_trust_balance(header, dtl, amount):
                return self.set_inner(PaymentResultCode.LINE_FULL)
        return self.set_inner(PaymentResultCode.SUCCESS)


@register_op
class SetOptionsOpFrame(OperationFrame):
    op_type = OperationType.SET_OPTIONS

    def threshold_level(self) -> int:
        b = self.op.body.value
        # raising to HIGH when touching thresholds/signers (reference
        # SetOptionsOpFrame::getThresholdLevel)
        if (b.masterWeight is not None or b.lowThreshold is not None
                or b.medThreshold is not None or b.highThreshold is not None
                or b.signer is not None):
            return ThresholdLevel.HIGH
        return ThresholdLevel.MEDIUM

    def do_check_valid(self, header) -> bool:
        b = self.op.body.value
        if b.setFlags is not None and b.clearFlags is not None \
                and (b.setFlags & b.clearFlags) != 0:
            return self.set_inner(SetOptionsResultCode.BAD_FLAGS)
        for v in (b.masterWeight, b.lowThreshold, b.medThreshold,
                  b.highThreshold):
            if v is not None and v > 255:
                return self.set_inner(
                    SetOptionsResultCode.THRESHOLD_OUT_OF_RANGE)
        for v in (b.setFlags, b.clearFlags):
            if v is not None and (v & ~AccountFlags.MASK_ACCOUNT_FLAGS):
                return self.set_inner(SetOptionsResultCode.UNKNOWN_FLAG)
        if b.signer is not None:
            if b.signer.key.disc == SignerKeyType.SIGNER_KEY_TYPE_ED25519 \
                    and b.signer.key.value == \
                    self.source_account_id().key_bytes:
                return self.set_inner(SetOptionsResultCode.BAD_SIGNER)
            if b.signer.weight > 255 and header.ledgerVersion > 9:
                # reference SetOptionsOpFrame.cpp:254-258
                return self.set_inner(SetOptionsResultCode.BAD_SIGNER)
        if b.homeDomain is not None and (
                len(b.homeDomain) > 32 or
                any(ord(c) < 0x20 or ord(c) >= 0x7F for c in b.homeDomain)):
            # control and non-ASCII characters are invalid (reference
            # isString32Valid / isStringValid)
            return self.set_inner(SetOptionsResultCode.INVALID_HOME_DOMAIN)
        return self.set_inner(SetOptionsResultCode.SUCCESS)

    def do_apply(self, ltx) -> bool:
        b = self.op.body.value
        header = ltx.load_header()
        entry = load_account(ltx, self.source_account_id())
        acc = entry.data.value

        if b.inflationDest is not None:
            if ltx.load_without_record(
                    LedgerKey.account(b.inflationDest)) is None:
                return self.set_inner(SetOptionsResultCode.INVALID_INFLATION)
            acc.inflationDest = b.inflationDest
        if b.clearFlags is not None:
            if is_immutable_auth(acc):
                return self.set_inner(SetOptionsResultCode.CANT_CHANGE)
            acc.flags &= ~b.clearFlags
        if b.setFlags is not None:
            if is_immutable_auth(acc):
                return self.set_inner(SetOptionsResultCode.CANT_CHANGE)
            acc.flags |= b.setFlags
        th = bytearray(acc.thresholds)
        if b.masterWeight is not None:
            th[0] = b.masterWeight
        if b.lowThreshold is not None:
            th[1] = b.lowThreshold
        if b.medThreshold is not None:
            th[2] = b.medThreshold
        if b.highThreshold is not None:
            th[3] = b.highThreshold
        acc.thresholds = bytes(th)
        if b.homeDomain is not None:
            acc.homeDomain = b.homeDomain
        if b.signer is not None:
            signers = list(acc.signers)
            idx = next((i for i, s in enumerate(signers)
                        if s.key == b.signer.key), None)
            if b.signer.weight == 0:
                if idx is not None:
                    signers.pop(idx)
                    change_subentries(header, entry, -1)
            elif idx is not None:
                signers[idx].weight = b.signer.weight
            else:
                if len(signers) >= 20:
                    return self.set_inner(
                        SetOptionsResultCode.TOO_MANY_SIGNERS)
                if not change_subentries(header, entry, +1):
                    return self.set_inner(SetOptionsResultCode.LOW_RESERVE)
                signers.append(b.signer)
            signers.sort(key=lambda s: s.key.to_xdr())
            acc.signers = signers
        return self.set_inner(SetOptionsResultCode.SUCCESS)


@register_op
class ChangeTrustOpFrame(OperationFrame):
    op_type = OperationType.CHANGE_TRUST

    def do_check_valid(self, header) -> bool:
        b = self.op.body.value
        if b.limit < 0 or b.line.is_native or not _valid_asset(b.line):
            return self.set_inner(ChangeTrustResultCode.MALFORMED)
        return self.set_inner(ChangeTrustResultCode.SUCCESS)

    def do_apply(self, ltx) -> bool:
        b = self.op.body.value
        header = ltx.load_header()
        src_id = self.source_account_id()
        if src_id == b.line.issuer:
            return self.set_inner(ChangeTrustResultCode.SELF_NOT_ALLOWED)
        key = LedgerKey.trustline(src_id, b.line)
        existing = ltx.load(key)
        if existing is not None:
            # reference order (ChangeTrustOpFrame.cpp:66-93): the limit
            # floor first — balance + buying liabilities (v10+; the
            # helper reports 0 below 10) — THEN delete-without-issuer is
            # legal, and only a non-delete edit needs a live issuer
            from .account_helpers import get_buying_liabilities
            tl = existing.data.value
            if b.limit < tl.balance + get_buying_liabilities(header,
                                                             existing):
                return self.set_inner(ChangeTrustResultCode.INVALID_LIMIT)
            if b.limit == 0:
                ltx.erase(key)
                src = load_account(ltx, src_id)
                change_subentries(header, src, -1)
                return self.set_inner(ChangeTrustResultCode.SUCCESS)
            if ltx.load_without_record(
                    LedgerKey.account(b.line.issuer)) is None:
                return self.set_inner(ChangeTrustResultCode.NO_ISSUER)
            tl.limit = b.limit
            return self.set_inner(ChangeTrustResultCode.SUCCESS)
        if b.limit == 0:
            return self.set_inner(ChangeTrustResultCode.INVALID_LIMIT)
        issuer_acc = ltx.load_without_record(
            LedgerKey.account(b.line.issuer))
        if issuer_acc is None:
            return self.set_inner(ChangeTrustResultCode.NO_ISSUER)
        src = load_account(ltx, src_id)
        if not change_subentries(header, src, +1):
            return self.set_inner(ChangeTrustResultCode.LOW_RESERVE)
        flags = 0 if is_auth_required(issuer_acc.data.value) \
            else TrustLineFlags.AUTHORIZED_FLAG
        tl = TrustLineEntry(accountID=src_id, asset=b.line, balance=0,
                            limit=b.limit, flags=flags,
                            ext=TrustLineEntryExt.v0())
        ltx.create(LedgerEntry(
            lastModifiedLedgerSeq=header.ledgerSeq,
            data=LedgerEntryData(LedgerEntryType.TRUSTLINE, tl),
            ext=_Ext.v0()))
        return self.set_inner(ChangeTrustResultCode.SUCCESS)


@register_op
class AllowTrustOpFrame(OperationFrame):
    op_type = OperationType.ALLOW_TRUST

    def threshold_level(self) -> int:
        return ThresholdLevel.LOW

    @staticmethod
    def _flag_valid(flag: int, ledger_version: int) -> bool:
        """reference trustLineFlagIsValid (TransactionUtils.cpp): pre-13
        only AUTHORIZED; from 13 also MAINTAIN_LIABILITIES, but never
        both auth bits at once."""
        if ledger_version < 13:
            return (flag & ~TrustLineFlags.MASK_TRUSTLINE_FLAGS) == 0
        both = TrustLineFlags.AUTH_LEVELS_MASK
        return (flag & ~TrustLineFlags.MASK_TRUSTLINE_FLAGS_V13) == 0 \
            and (flag & both) != both

    def do_check_valid(self, header) -> bool:
        b = self.op.body.value
        code = b.asset.value.rstrip(b"\x00")
        if not code:
            return self.set_inner(AllowTrustResultCode.MALFORMED)
        if not self._flag_valid(b.authorize, header.ledgerVersion):
            return self.set_inner(AllowTrustResultCode.MALFORMED)
        return self.set_inner(AllowTrustResultCode.SUCCESS)

    def do_apply(self, ltx) -> bool:
        b = self.op.body.value
        header = ltx.load_header()
        issuer_id = self.source_account_id()
        if b.trustor == issuer_id:
            return self.set_inner(AllowTrustResultCode.SELF_NOT_ALLOWED)
        issuer = load_account(ltx, issuer_id)
        acc = issuer.data.value
        if not is_auth_required(acc):
            return self.set_inner(AllowTrustResultCode.TRUST_NOT_REQUIRED)
        not_revocable = not (acc.flags & AccountFlags.AUTH_REVOCABLE_FLAG)
        if not_revocable and b.authorize == 0:
            return self.set_inner(AllowTrustResultCode.CANT_REVOKE)
        code = b.asset.value
        asset = Asset.credit(code.rstrip(b"\x00").decode("ascii"), issuer_id)
        tle = load_trustline(ltx, b.trustor, asset)
        if tle is None:
            return self.set_inner(AllowTrustResultCode.NO_TRUST_LINE)
        tl = tle.data.value
        # downgrading AUTHORIZED → MAINTAIN_LIABILITIES is also a
        # (partial) revocation (reference AllowTrustOpFrame.cpp:99-110)
        fully = bool(tl.flags & TrustLineFlags.AUTHORIZED_FLAG)
        maintain_or_more = bool(
            tl.flags & TrustLineFlags.AUTH_LEVELS_MASK)
        if not_revocable and fully and (
                b.authorize &
                TrustLineFlags.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG):
            return self.set_inner(AllowTrustResultCode.CANT_REVOKE)
        # a FULL revoke (from >= maintain) pulls the trustor's offers in
        # this asset and releases their liabilities (reference :115-140,
        # protocol >= 10)
        if header.ledgerVersion >= 10 and maintain_or_more and \
                b.authorize == 0:
            self._remove_offers(ltx, header, b.trustor, asset)
        tl.flags = b.authorize
        return self.set_inner(AllowTrustResultCode.SUCCESS)

    @staticmethod
    def _remove_offers(ltx, header, trustor, asset: Asset) -> None:
        from .offer_exchange import release_liabilities
        for entry in ltx.load_offers_by_account(trustor, asset):
            oe = entry.data.value
            release_liabilities(ltx, oe)
            acct = load_account(ltx, trustor)
            change_subentries(header, acct, -1)
            ltx.erase(LedgerKey.offer(trustor, oe.offerID))


@register_op
class AccountMergeOpFrame(OperationFrame):
    op_type = OperationType.ACCOUNT_MERGE

    def threshold_level(self) -> int:
        return ThresholdLevel.HIGH

    def do_check_valid(self, header) -> bool:
        if self.op.body.value.account_id == self.source_account_id():
            return self.set_inner(AccountMergeResultCode.MALFORMED)
        return self.set_inner(AccountMergeResultCode.SUCCESS)

    def do_apply(self, ltx) -> bool:
        header = ltx.load_header()
        src_id = self.source_account_id()
        dest_id = self.op.body.value.account_id
        dest = load_account(ltx, dest_id)
        if dest is None:
            return self.set_inner(AccountMergeResultCode.NO_ACCOUNT)
        src = load_account(ltx, src_id)
        acc = src.data.value
        if is_immutable_auth(acc):
            return self.set_inner(AccountMergeResultCode.IMMUTABLE_SET)
        # signers live inside the account entry and die with it; only
        # OWNED subentries (trustlines/offers/data) block a merge
        # (reference MergeOpFrame.cpp:95: numSubEntries != signers.size())
        if acc.numSubEntries != len(acc.signers):
            return self.set_inner(AccountMergeResultCode.HAS_SUB_ENTRIES)
        # replay protection (reference: seqnum in current ledger's range)
        if acc.seqNum >= starting_sequence_number(header):
            return self.set_inner(AccountMergeResultCode.SEQNUM_TOO_FAR)
        balance = acc.balance
        # v10+: the destination's buying liabilities count against the
        # INT64 ceiling (reference doApply → addBalance → DEST_FULL)
        if not add_balance(header, dest, balance):
            return self.set_inner(AccountMergeResultCode.DEST_FULL)
        ltx.erase(LedgerKey.account(src_id))
        return self.set_inner(AccountMergeResultCode.SUCCESS, balance)


@register_op
class InflationOpFrame(OperationFrame):
    op_type = OperationType.INFLATION

    INFLATION_FREQUENCY = 7 * 24 * 60 * 60  # weekly
    INFLATION_RATE_TRILLIONTHS = 190721000
    INFLATION_WIN_MIN_PERCENT = 500000000  # 0.05% in trillionths
    INFLATION_NUM_WINNERS = 2000

    def threshold_level(self) -> int:
        return ThresholdLevel.LOW

    def is_version_supported(self, ledger_version: int) -> bool:
        # inflation retired by protocol 12 (reference
        # InflationOpFrame::isVersionSupported: version < 12 →
        # opNOT_SUPPORTED afterwards, NOT a success-noop)
        return ledger_version < 12

    def do_check_valid(self, header) -> bool:
        return self.set_inner(InflationResultCode.SUCCESS, [])

    def do_apply(self, ltx) -> bool:
        from ..xdr import AccountID, InflationPayout
        from .account_helpers import max_amount_receive
        header = ltx.load_header()
        close_time = header.scpValue.closeTime
        seq = header.inflationSeq
        next_time = (seq + 1) * self.INFLATION_FREQUENCY
        if close_time < next_time:
            return self.set_inner(InflationResultCode.NOT_TIME)
        # classic mechanism (reference InflationOpFrame::doApply): tally
        # inflationDest votes weighted by balance; winners over 0.05%.
        # The query runs on the LedgerTxn so votes see uncommitted changes
        # in the open txn chain (fees charged this close, earlier ops in
        # this tx) — reference queryInflationWinners merges child deltas.
        total = header.totalCoins
        min_votes = total * self.INFLATION_WIN_MIN_PERCENT // 10**12
        winners = [
            (AccountID.ed25519(kb), v)
            for kb, v in ltx.query_inflation_winners(
                self.INFLATION_NUM_WINNERS, min_votes)]
        inflation_amount = total * self.INFLATION_RATE_TRILLIONTHS // 10**12
        amount_to_dole = inflation_amount + header.feePool
        header.feePool = 0
        header.inflationSeq += 1
        left = amount_to_dole
        payouts = []
        for dest_id, v in winners:
            # each winner's share is its fraction of ALL coins, not of
            # the winning votes (reference bigDivide(amountToDole,
            # w.votes, totalVotes) with totalVotes = lh.totalCoins) —
            # the unclaimed remainder stays in the fee pool
            share = amount_to_dole * v // total
            if share == 0:
                continue
            dest = load_account(ltx, dest_id)
            if dest is None:
                continue  # missing winner: nothing doled
            if header.ledgerVersion >= 10:
                # pre-10 has no receive clamp: an overflowing payout
                # throws below (reference InflationOpFrame.cpp:80-100)
                share = min(share, max_amount_receive(header, dest))
                if share == 0:
                    continue
            if not add_balance(header, dest, share):
                raise RuntimeError("inflation overflowed winner balance")
            left -= share
            if header.ledgerVersion <= 7:
                header.totalCoins += share
            payouts.append(InflationPayout(destination=dest_id,
                                           amount=share))
        # unclaimed funds return to the fee pool; from protocol 8 the
        # minted coins enter circulation regardless of how much was
        # claimed (reference InflationOpFrame.cpp:110-114)
        header.feePool += left
        if header.ledgerVersion > 7:
            header.totalCoins += inflation_amount
        return self.set_inner(InflationResultCode.SUCCESS, payouts)


@register_op
class ManageDataOpFrame(OperationFrame):
    op_type = OperationType.MANAGE_DATA

    def do_check_valid(self, header) -> bool:
        b = self.op.body.value
        if not b.dataName or len(b.dataName) > 64:
            return self.set_inner(ManageDataResultCode.INVALID_NAME)
        return self.set_inner(ManageDataResultCode.SUCCESS)

    def do_apply(self, ltx) -> bool:
        b = self.op.body.value
        header = ltx.load_header()
        src_id = self.source_account_id()
        key = LedgerKey.data(src_id, b.dataName)
        existing = ltx.load(key)
        if b.dataValue is None:
            if existing is None:
                return self.set_inner(ManageDataResultCode.NAME_NOT_FOUND)
            ltx.erase(key)
            src = load_account(ltx, src_id)
            change_subentries(header, src, -1)
            return self.set_inner(ManageDataResultCode.SUCCESS)
        if existing is not None:
            existing.data.value.dataValue = b.dataValue
            return self.set_inner(ManageDataResultCode.SUCCESS)
        src = load_account(ltx, src_id)
        if not change_subentries(header, src, +1):
            return self.set_inner(ManageDataResultCode.LOW_RESERVE)
        de = DataEntry(accountID=src_id, dataName=b.dataName,
                       dataValue=b.dataValue, ext=_Ext.v0())
        ltx.create(LedgerEntry(
            lastModifiedLedgerSeq=header.ledgerSeq,
            data=LedgerEntryData(LedgerEntryType.DATA, de), ext=_Ext.v0()))
        return self.set_inner(ManageDataResultCode.SUCCESS)


@register_op
class BumpSequenceOpFrame(OperationFrame):
    op_type = OperationType.BUMP_SEQUENCE

    def threshold_level(self) -> int:
        return ThresholdLevel.LOW

    def is_version_supported(self, ledger_version: int) -> bool:
        # introduced in protocol 10 (reference BumpSequenceOpFrame::
        # isVersionSupported)
        return ledger_version >= 10

    def do_check_valid(self, header) -> bool:
        if self.op.body.value.bumpTo < 0:
            return self.set_inner(BumpSequenceResultCode.BAD_SEQ)
        return self.set_inner(BumpSequenceResultCode.SUCCESS)

    def do_apply(self, ltx) -> bool:
        bump_to = self.op.body.value.bumpTo
        src = load_account(ltx, self.source_account_id())
        if bump_to > src.data.value.seqNum:
            src.data.value.seqNum = bump_to
        return self.set_inner(BumpSequenceResultCode.SUCCESS)
