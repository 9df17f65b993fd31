"""Test DSL: in-memory ledger + account helpers for building/applying txs.

Copied from `stellar_core_tpu/testing/__init__.py` at commit 378eae4;
carry a fix in either copy to the other (`AppLedgerAdapter` runs over
the port's `main/application.py`). `TestLedger()` without a
verifier verifies on the card (`make_verifier()`); tests on the host pass
`CpuSigVerifier()` or `CudaSigVerifier(device="cpu")`.

Role parity: reference `src/test/TxTests.{h,cpp}`, `src/test/TestAccount.h`,
`src/test/TestMarket.h` — the fixtures every transactions/herder test uses.
Used by tests/ and by the LoadGenerator.
"""

from __future__ import annotations

from typing import List, Optional

from ..crypto.batch_verifier import make_verifier
from ..crypto.hashing import sha256
from ..crypto.keys import SecretKey
from ..ledger.ledgertxn import InMemoryLedgerTxnRoot, LedgerTxn
from ..transactions.transaction_frame import TransactionFrame
from ..xdr import (
    Asset, LedgerHeader, LedgerKey, Memo, MuxedAccount, Operation,
    OperationBody, OperationType, Price, PublicKey, StellarValue,
    StellarValueExt, TimeBounds, Transaction, TransactionEnvelope, _Ext,
)

TESTING_NETWORK_ID = sha256(b"(sct) testing network")
GENESIS_TOTAL_COINS = 10**17

# Default protocol for TestLedger/genesis_header. The pytest harness's
# --protocol-version option rewrites this (tests/conftest.py), re-running
# every version-agnostic suite at another protocol — the reference's
# `--all-versions` re-run (src/test/test.cpp:213-217). Tests pinning an
# explicit ledger_version are unaffected.
DEFAULT_LEDGER_VERSION = 13


def genesis_header(base_fee=100, base_reserve=5_000_000,
                   max_tx_set_size=100, ledger_version=None) -> LedgerHeader:
    if ledger_version is None:
        ledger_version = DEFAULT_LEDGER_VERSION
    return LedgerHeader(
        ledgerVersion=ledger_version, previousLedgerHash=b"\x00" * 32,
        scpValue=StellarValue(txSetHash=b"\x00" * 32, closeTime=1,
                              upgrades=[], ext=StellarValueExt(0, None)),
        txSetResultHash=b"\x00" * 32, bucketListHash=b"\x00" * 32,
        ledgerSeq=2, totalCoins=GENESIS_TOTAL_COINS, feePool=0,
        inflationSeq=0, idPool=0, baseFee=base_fee,
        baseReserve=base_reserve, maxTxSetSize=max_tx_set_size,
        skipList=[b"\x00" * 32] * 4, ext=_Ext.v0())


def root_secret_key(network_id: bytes = TESTING_NETWORK_ID) -> SecretKey:
    """Deterministic root (genesis) key derived from the network id
    (reference txtest::getRoot role)."""
    return SecretKey.from_seed(sha256(network_id))


class TestLedger:
    """An in-memory ledger with a funded root account; applies transactions
    directly (fee+seq then apply), without consensus."""

    __test__ = False    # not a pytest collection target

    def __init__(self, network_id: bytes = TESTING_NETWORK_ID,
                 verifier=None,
                 ledger_version: Optional[int] = None) -> None:
        self.network_id = network_id
        self.root = InMemoryLedgerTxnRoot(
            genesis_header(ledger_version=ledger_version))
        self.verifier = verifier if verifier is not None else make_verifier()
        root_sk = root_secret_key(network_id)
        from ..transactions.account_helpers import make_account_entry
        ltx = LedgerTxn(self.root)
        ltx.create(make_account_entry(
            root_sk.public_key, GENESIS_TOTAL_COINS,
            (ltx.load_header().ledgerSeq - 1) << 32))
        ltx.commit()
        self.root_account = TestAccount(self, root_sk)

    # -- state access -------------------------------------------------------
    def header(self) -> LedgerHeader:
        return self.root.get_header()

    def balance(self, account_id: PublicKey) -> int:
        e = self.root.get_entry(LedgerKey.account(account_id))
        assert e is not None, "no such account"
        return e.data.value.balance

    def account_exists(self, account_id: PublicKey) -> bool:
        return self.root.get_entry(LedgerKey.account(account_id)) is not None

    def trust_balance(self, account_id: PublicKey, asset: Asset) -> int:
        e = self.root.get_entry(LedgerKey.trustline(account_id, asset))
        assert e is not None, "no trustline"
        return e.data.value.balance

    def seq_num(self, account_id: PublicKey) -> int:
        e = self.root.get_entry(LedgerKey.account(account_id))
        return e.data.value.seqNum

    # -- applying -----------------------------------------------------------
    def advance_ledger(self) -> None:
        """Bump ledgerSeq/closeTime as a real close would."""
        ltx = LedgerTxn(self.root)
        h = ltx.load_header()
        h.ledgerSeq += 1
        h.scpValue.closeTime += 5
        ltx.commit()

    def apply_frame(self, frame: TransactionFrame) -> bool:
        """check → charge fee/seq → apply, mirroring ledger close for a
        single tx."""
        self.advance_ledger()
        # `with` rolls back on an exception mid-apply (common in failing
        # tests) so the root's child slot isn't left registered
        with LedgerTxn(self.root) as ltx:
            ok = frame.check_valid(ltx, 0, self.verifier)
            if not ok:
                ltx.rollback()
                return False
            frame.process_fee_seq_num(ltx, None)
            applied = frame.apply(ltx, self.verifier)
            ltx.commit()  # fees/seq consumed even on failed apply
        return applied

    def close_with(self, frames: List[TransactionFrame]) -> List[bool]:
        """Apply a batch like a ledger close: all fees/seqs first, then all
        ops (reference LedgerManagerImpl::closeLedger ordering)."""
        self.advance_ledger()
        with LedgerTxn(self.root) as ltx:
            for f in frames:
                f.process_fee_seq_num(ltx, None)
            results = [f.apply(ltx, self.verifier) for f in frames]
        return results


class AppLedgerAdapter:
    """Adapts a full Application to the TestLedger account-DSL surface:
    txs are submitted through the Herder and applied by consensus closes
    (MANUAL_CLOSE)."""

    def __init__(self, app) -> None:
        self.app = app
        self.network_id = app.config.network_id

    def header(self) -> LedgerHeader:
        return self.app.ledger_manager.lcl_header

    def _root(self):
        return self.app.ledger_manager.ltx_root()

    def balance(self, account_id: PublicKey) -> int:
        e = self._root().get_entry(LedgerKey.account(account_id))
        assert e is not None, "no such account"
        return e.data.value.balance

    def account_exists(self, account_id: PublicKey) -> bool:
        return self._root().get_entry(
            LedgerKey.account(account_id)) is not None

    def trust_balance(self, account_id, asset):
        e = self._root().get_entry(
            LedgerKey.trustline(account_id, asset))
        assert e is not None
        return e.data.value.balance

    def seq_num(self, account_id: PublicKey) -> int:
        e = self._root().get_entry(LedgerKey.account(account_id))
        return e.data.value.seqNum if e is not None else 0

    def apply_frame(self, frame) -> bool:
        status = self.app.submit_transaction(frame)
        if status != 0:
            return False
        self.app.manual_close()
        from ..xdr import TransactionResultCode
        return frame.result.code == TransactionResultCode.txSUCCESS

    def root_account(self) -> "TestAccount":
        return TestAccount(self, self.app.network_root_key())


class TestAccount:
    __test__ = False    # not a pytest collection target

    def __init__(self, ledger: TestLedger, sk: SecretKey) -> None:
        self.ledger = ledger
        self.sk = sk

    @property
    def account_id(self) -> PublicKey:
        return self.sk.public_key

    @property
    def muxed(self) -> MuxedAccount:
        return MuxedAccount.from_account_id(self.account_id)

    def next_seq(self) -> int:
        return self.ledger.seq_num(self.account_id) + 1

    def balance(self) -> int:
        return self.ledger.balance(self.account_id)

    # -- op builders --------------------------------------------------------
    @staticmethod
    def op(body: OperationBody,
           source: Optional[PublicKey] = None) -> Operation:
        return Operation(
            sourceAccount=(MuxedAccount.from_account_id(source)
                           if source else None),
            body=body)

    def op_create_account(self, dest: PublicKey, balance: int) -> Operation:
        from ..xdr import CreateAccountOp
        return self.op(OperationBody(
            OperationType.CREATE_ACCOUNT,
            CreateAccountOp(destination=dest, startingBalance=balance)))

    def op_payment(self, dest: PublicKey, amount: int,
                   asset: Optional[Asset] = None) -> Operation:
        from ..xdr import PaymentOp
        return self.op(OperationBody(
            OperationType.PAYMENT,
            PaymentOp(destination=MuxedAccount.from_account_id(dest),
                      asset=asset or Asset.native(), amount=amount)))

    def op_change_trust(self, asset: Asset, limit: int) -> Operation:
        from ..xdr import ChangeTrustOp
        return self.op(OperationBody(
            OperationType.CHANGE_TRUST,
            ChangeTrustOp(line=asset, limit=limit)))

    def op_manage_sell_offer(self, selling: Asset, buying: Asset,
                             amount: int, n: int, d: int,
                             offer_id: int = 0) -> Operation:
        from ..xdr import ManageSellOfferOp
        return self.op(OperationBody(
            OperationType.MANAGE_SELL_OFFER,
            ManageSellOfferOp(selling=selling, buying=buying, amount=amount,
                              price=Price(n=n, d=d), offerID=offer_id)))

    def op_manage_buy_offer(self, selling: Asset, buying: Asset,
                            buy_amount: int, n: int, d: int,
                            offer_id: int = 0) -> Operation:
        from ..xdr import ManageBuyOfferOp
        return self.op(OperationBody(
            OperationType.MANAGE_BUY_OFFER,
            ManageBuyOfferOp(selling=selling, buying=buying,
                             buyAmount=buy_amount, price=Price(n=n, d=d),
                             offerID=offer_id)))

    def op_create_passive_sell_offer(self, selling: Asset, buying: Asset,
                                     amount: int, n: int, d: int
                                     ) -> Operation:
        from ..xdr import CreatePassiveSellOfferOp
        return self.op(OperationBody(
            OperationType.CREATE_PASSIVE_SELL_OFFER,
            CreatePassiveSellOfferOp(selling=selling, buying=buying,
                                     amount=amount, price=Price(n=n, d=d))))

    def op_set_options(self, inflation_dest=None, clear_flags=None,
                       set_flags=None, master_weight=None, low=None,
                       med=None, high=None, home_domain=None,
                       signer=None) -> Operation:
        from ..xdr import SetOptionsOp
        return self.op(OperationBody(
            OperationType.SET_OPTIONS,
            SetOptionsOp(inflationDest=inflation_dest,
                         clearFlags=clear_flags, setFlags=set_flags,
                         masterWeight=master_weight, lowThreshold=low,
                         medThreshold=med, highThreshold=high,
                         homeDomain=home_domain, signer=signer)))

    def op_add_signer(self, key_bytes32: bytes, weight: int = 1) -> Operation:
        from ..xdr import Signer, SignerKey
        return self.op_set_options(
            signer=Signer(key=SignerKey.ed25519(key_bytes32), weight=weight))

    def op_allow_trust(self, trustor: PublicKey, code: bytes = b"USD\x00",
                       authorize: int = 1) -> Operation:
        from ..xdr import AllowTrustAsset, AllowTrustOp
        return self.op(OperationBody(
            OperationType.ALLOW_TRUST,
            AllowTrustOp(trustor=trustor, asset=AllowTrustAsset(1, code),
                         authorize=authorize)))

    def op_manage_data(self, name: str,
                       value: Optional[bytes]) -> Operation:
        from ..xdr import ManageDataOp
        return self.op(OperationBody(
            OperationType.MANAGE_DATA,
            ManageDataOp(dataName=name, dataValue=value)))

    # -- tx builders --------------------------------------------------------
    def tx(self, ops: List[Operation], seq: Optional[int] = None,
           fee: Optional[int] = None,
           time_bounds: Optional[TimeBounds] = None,
           extra_signers: Optional[List[SecretKey]] = None,
           memo: Optional[Memo] = None,
           ) -> TransactionFrame:
        header = self.ledger.header()
        t = Transaction(
            sourceAccount=self.muxed,
            fee=fee if fee is not None else header.baseFee * len(ops),
            seqNum=seq if seq is not None else self.next_seq(),
            timeBounds=time_bounds, memo=memo or Memo.none(),
            operations=ops, ext=_Ext.v0())
        frame = TransactionFrame(
            self.ledger.network_id, TransactionEnvelope.for_tx(t))
        frame.add_signature(self.sk)
        for sk in (extra_signers or []):
            frame.add_signature(sk)
        return frame

    # -- high-level actions (apply immediately) -----------------------------
    def create(self, balance: int,
               sk: Optional[SecretKey] = None) -> "TestAccount":
        sk = sk or SecretKey.pseudo_random_for_testing()
        frame = self.tx([self.op_create_account(sk.public_key, balance)])
        assert self.ledger.apply_frame(frame), frame.result
        return TestAccount(self.ledger, sk)

    def pay(self, dest: "TestAccount", amount: int,
            asset: Optional[Asset] = None) -> bool:
        frame = self.tx([self.op_payment(dest.account_id, amount, asset)])
        return self.ledger.apply_frame(frame)

    def change_trust(self, asset: Asset, limit: int) -> bool:
        return self.ledger.apply_frame(
            self.tx([self.op_change_trust(asset, limit)]))
