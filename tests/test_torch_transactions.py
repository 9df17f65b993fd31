"""The port's transactions layer, TestLedger and upgrades held against the
JAX package's cases.

- every case of `tests/test_transactions.py` (validity codes, fees,
  sequence numbers, multisig thresholds, each operation's arms, offer
  crossing, path payments, fee bumps), run on the port's `TestLedger`
  with `CpuSigVerifier()` passed in: the module's source with its imports
  pointed at `stellar_core_tpu_torch`;
- the cases of `tests/test_upgrades.py` that need no `Application`, the
  same way, and its through-consensus case as a close of the port's
  `LedgerManager` whose value carries the armed upgrades;
- without a verifier, `SignatureChecker`, both frames' `check_valid` and
  `apply` and `LedgerManager.close_ledger` raise TypeError (the close
  also without a hasher), a verifier whose flush fails fails the apply
  (no txINTERNAL_ERROR), and a value after a gap goes to catchup (the
  manager's `catchup_trigger`) instead of closing.
"""

import inspect
from types import SimpleNamespace

import pytest

from stellar_core_tpu_torch import testing as T
from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
from stellar_core_tpu_torch.crypto.batch_verifier import (
    BatchSigVerifier, CpuSigVerifier, CudaSigVerifier,
)
from stellar_core_tpu_torch.crypto.keys import flush_verify_cache
from stellar_core_tpu_torch.herder.txset import TxSetFrame
from stellar_core_tpu_torch.herder.upgrades import (
    UpgradeParameters, Upgrades,
)
from stellar_core_tpu_torch.ledger.ledger_manager import (
    LedgerCloseData, LedgerManager, LedgerManagerState,
)
from stellar_core_tpu_torch.ledger.ledgertxn import LedgerTxn
from stellar_core_tpu_torch.transactions.signature_checker import (
    SignatureChecker, SignatureVerifyError,
)
from stellar_core_tpu_torch.xdr import (
    LedgerKey, StellarValue, StellarValueExt, TransactionResultCode,
)

from test_torch_ledgertxn import CASES as LEDGERTXN_CASES
from torch_mirror_harness import port_cases
import torch_threads  # noqa: F401  (one intra-op thread a worker)


class CpuTestLedger(T.TestLedger):
    """The port's TestLedger verifying on the host."""

    __test__ = False

    def __init__(self, *args, **kw):
        kw.setdefault("verifier", CpuSigVerifier())
        super().__init__(*args, **kw)


TX = port_cases("test_transactions.py")
TX.TestLedger = CpuTestLedger
TX_CASES = sorted(n for n in dir(TX) if n.startswith("test_"))

UP = port_cases("test_upgrades.py", drop=(r"\.main\.", "AppLedgerAdapter",
                                          r"util\.timer"))
UP.make_header = LEDGERTXN_CASES.make_header
UP_CASES = sorted(n for n in dir(UP) if n.startswith("test_")
                  and "app" not in inspect.signature(getattr(UP, n))
                  .parameters)


def test_reference_cases_collected():
    assert len(TX_CASES) == 29
    assert UP_CASES == ["test_apply_validity_rules",
                        "test_create_upgrades_only_after_scheduled_time",
                        "test_nomination_votes_only_for_armed_values"]


@pytest.mark.parametrize("name", TX_CASES)
def test_transactions_case(name):
    ledger = CpuTestLedger()
    getattr(TX, name)(ledger, ledger.root_account)


@pytest.mark.parametrize("name", UP_CASES)
def test_upgrades_case(name):
    getattr(UP, name)()


def test_transactions_on_the_verify_kernels_plain_version():
    """The card's verifier on the host (`CudaSigVerifier(device="cpu")`,
    the kernel's plain version) drives a case's accounts and payment."""
    ledger = T.TestLedger(verifier=CudaSigVerifier(device="cpu"))
    TX.test_create_account_and_payment(ledger, ledger.root_account)


# -- no verifier, no verify --------------------------------------------------

def _signed_payment():
    ledger = CpuTestLedger()
    root = ledger.root_account
    a = root.create(10 ** 9)
    return ledger, a.tx([a.op_payment(root.account_id, 10)])


def test_signature_checker_raises_without_verifier():
    with pytest.raises(TypeError):
        SignatureChecker(b"\x00" * 32, [], None)


def test_frames_raise_without_verifier():
    from stellar_core_tpu_torch.transactions.transaction_frame import (
        FeeBumpTransactionFrame,
    )
    from stellar_core_tpu_torch.xdr import (
        EnvelopeType, FeeBumpTransaction, FeeBumpTransactionEnvelope,
        TransactionEnvelope, _Ext,
    )
    from stellar_core_tpu_torch.xdr.transaction import _InnerTxEnvelope
    ledger, frame = _signed_payment()
    fb = FeeBumpTransactionFrame(ledger.network_id, TransactionEnvelope(
        EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP, FeeBumpTransactionEnvelope(
            tx=FeeBumpTransaction(
                feeSource=ledger.root_account.muxed, fee=1000,
                innerTx=_InnerTxEnvelope(EnvelopeType.ENVELOPE_TYPE_TX,
                                         frame.envelope.value),
                ext=_Ext.v0()),
            signatures=[])))
    fb.add_signature(ledger.root_account.sk)
    for f in (frame, fb):
        with LedgerTxn(ledger.root) as ltx:
            with pytest.raises(TypeError):
                f.check_valid(ltx, 0, None)
            with pytest.raises(TypeError):
                f.apply(ltx, None)
            ltx.rollback()
    # the root's child slot is free again: nothing was left open
    with LedgerTxn(ledger.root) as ltx:
        assert frame.check_valid(ltx, 0, CpuSigVerifier())
        ltx.rollback()


class _FailingVerifier(BatchSigVerifier):
    """A verifier whose every drain fails, as a lost card's does."""

    name = "failing"

    def enqueue(self, key, sig, msg):
        from stellar_core_tpu_torch.crypto.batch_verifier import VerifyFuture
        return VerifyFuture()

    def flush(self):
        raise RuntimeError("device lost")


def test_failed_drain_fails_the_apply():
    ledger, frame = _signed_payment()
    with LedgerTxn(ledger.root) as ltx:
        frame.process_fee_seq_num(ltx, None)
        with pytest.raises(SignatureVerifyError):
            frame.apply(ltx, _FailingVerifier())
        ltx.rollback()


# -- LedgerManager closes ----------------------------------------------------

class _Config:
    DATABASE = "in-memory"
    LEDGER_PROTOCOL_VERSION = 13
    GENESIS_TOTAL_COINS = T.GENESIS_TOTAL_COINS
    TESTING_UPGRADE_DESIRED_FEE = 100
    TESTING_UPGRADE_RESERVE = 5_000_000
    TESTING_UPGRADE_MAX_TX_SET_SIZE = 1000
    network_id = T.TESTING_NETWORK_ID


def _manager(verifier, hasher="cpu"):
    app = SimpleNamespace(config=_Config(), sig_verifier=verifier,
                          batch_hasher=hasher and make_hasher(hasher),
                          network_root_key=T.root_secret_key)
    lm = LedgerManager(app)
    lm.start_new_ledger()
    return lm


class _Shim:
    """TestAccount's ledger surface over a LedgerManager."""

    network_id = T.TESTING_NETWORK_ID

    def __init__(self, lm):
        self.lm = lm

    def header(self):
        return self.lm.root.get_header()

    def seq_num(self, account_id):
        e = self.lm.root.get_entry(LedgerKey.account(account_id))
        return e.data.value.seqNum if e is not None else 0

    def balance(self, account_id):
        return self.lm.root.get_entry(
            LedgerKey.account(account_id)).data.value.balance


def _close(lm, frames, upgrades=()):
    header = lm.root.get_header()
    ts = TxSetFrame(T.TESTING_NETWORK_ID, lm.lcl_hash, frames)
    lm.value_externalized(LedgerCloseData(
        header.ledgerSeq + 1, ts,
        StellarValue(txSetHash=ts.get_contents_hash(),
                     closeTime=header.scpValue.closeTime + 5,
                     upgrades=list(upgrades),
                     ext=StellarValueExt(0, None))))
    return ts.sort_for_apply()


def test_close_raises_without_verifier():
    lm = _manager(None)
    root = T.TestAccount(_Shim(lm), T.root_secret_key())
    seq = lm.last_closed_ledger_num()
    with pytest.raises(TypeError):
        _close(lm, [root.tx([root.op_payment(root.account_id, 1)])])
    assert lm.last_closed_ledger_num() == seq


def test_close_raises_without_hasher():
    """A close never hashes on the host unseen: an app without a
    `batch_hasher` fails the close before anything is applied."""
    lm = _manager(CpuSigVerifier(), hasher=None)
    root = T.TestAccount(_Shim(lm), T.root_secret_key())
    seq, before = lm.last_closed_ledger_num(), lm.lcl_hash
    with pytest.raises(TypeError):
        _close(lm, [root.tx([root.op_payment(root.account_id, 1)])])
    assert lm.last_closed_ledger_num() == seq and lm.lcl_hash == before
    assert lm.root._child is None


def test_gapped_value_raises():
    """A value past lcl + 1 no longer raises: as in the reference, the
    manager enters LM_CATCHING_UP_STATE and hands the value to its
    `catchup_trigger` (the CatchupManager's `process_ledger`), and while
    catching up every value, an in-order one too, goes there unclosed.
    Synced again, the next in-order value closes and an old one is
    skipped."""
    lm = _manager(CpuSigVerifier())
    handed = []
    lm.catchup_trigger = handed.append
    header = lm.root.get_header()
    ts = TxSetFrame(T.TESTING_NETWORK_ID, lm.lcl_hash, [])
    value = StellarValue(txSetHash=ts.get_contents_hash(),
                         closeTime=header.scpValue.closeTime + 5,
                         upgrades=[], ext=StellarValueExt(0, None))
    gapped = LedgerCloseData(header.ledgerSeq + 2, ts, value)
    in_order = LedgerCloseData(header.ledgerSeq + 1, ts, value)
    lm.value_externalized(gapped)
    assert lm.state == LedgerManagerState.LM_CATCHING_UP_STATE
    lm.value_externalized(in_order)
    assert handed == [gapped, in_order]
    assert lm.last_closed_ledger_num() == header.ledgerSeq
    lm.state = LedgerManagerState.LM_SYNCED_STATE
    _close(lm, [])
    assert lm.last_closed_ledger_num() == header.ledgerSeq + 1
    before = lm.lcl_hash
    lm.value_externalized(in_order)
    assert lm.lcl_hash == before and len(handed) == 2


def test_failed_drain_fails_and_rolls_back_the_close():
    # an earlier case may have verified the same payment: the drain must
    # see it
    flush_verify_cache()
    lm = _manager(_FailingVerifier())
    root = T.TestAccount(_Shim(lm), T.root_secret_key())
    before = lm.lcl_hash
    ents = sorted(e.to_xdr() for e in lm.root.all_entries())
    with pytest.raises(SignatureVerifyError):
        _close(lm, [root.tx([root.op_payment(root.account_id, 1)])])
    assert lm.lcl_hash == before
    assert sorted(e.to_xdr() for e in lm.root.all_entries()) == ents
    assert lm.root._child is None


def test_armed_upgrades_apply_through_a_close():
    """The reference's test_armed_upgrades_apply_through_consensus on the
    port's LedgerManager: the armed fee and version upgrades ride the
    next value and apply after its transactions; a tx built against the
    upgraded header bids and pays the new fee."""
    p = UpgradeParameters()
    p.upgrade_time = 0
    p.base_fee = 123
    p.protocol_version = 13
    lm = _manager(CpuSigVerifier())
    shim = _Shim(lm)
    root = T.TestAccount(shim, T.root_secret_key())
    alice_sk = T.SecretKey.from_seed(b"\x0a" * 32)
    ups = Upgrades(p).create_upgrades_for(lm.lcl_header, close_time=0)
    assert ups
    frames = _close(lm, [root.tx([root.op_create_account(
        alice_sk.public_key, 10 ** 9)])], upgrades=ups)
    assert frames[0].result.code == TransactionResultCode.txSUCCESS
    h = lm.lcl_header
    assert h.baseFee == 123 and h.ledgerVersion == 13
    alice = T.TestAccount(shim, alice_sk)
    f = alice.tx([alice.op_payment(root.account_id, 10)])
    assert f.fee_bid == 123
    before = alice.balance()
    _close(lm, [f])
    assert alice.balance() == before - 10 - 123
