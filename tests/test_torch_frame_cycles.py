"""A parsed transaction's object graph is acyclic: an operation frame does
not own its transaction frame (the reference's `TransactionFrame&`), so a
transaction frame, its op frames, its envelope and its results die by
reference count the moment their holder drops them, and a catchup pass
leaves nothing for the cyclic collector.

Every case parses its envelopes from wire bytes, as catchup does: a
one-payment v1 transaction, a multi-operation transaction whose ops mix
their own source and none, a fee-bump envelope, and a 200-transaction
`TxSetFrame.from_wire` of all three.
"""

from __future__ import annotations

import gc
import weakref
from types import SimpleNamespace

import pytest

from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.herder.txset import TxSetFrame
from stellar_core_tpu_torch.testing import TESTING_NETWORK_ID, TestAccount
from stellar_core_tpu_torch.transactions.transaction_frame import (
    FeeBumpTransactionFrame, TransactionFrame,
)
from stellar_core_tpu_torch.xdr import (
    EnvelopeType, FeeBumpTransaction, FeeBumpTransactionEnvelope, Memo,
    Transaction, TransactionEnvelope, TransactionSet, _Ext,
)
from stellar_core_tpu_torch.xdr.transaction import _InnerTxEnvelope

import torch_threads  # noqa: F401  (one intra-op thread a worker)

KINDS = ("payment", "multi_op", "fee_bump", "txset")
_PORT = "stellar_core_tpu_torch"


def _keys():
    return [SecretKey.from_seed(bytes([i]) * 32) for i in (1, 2, 3, 4)]


def _v1(source: TestAccount, ops, seq: int) -> TransactionEnvelope:
    tx = Transaction(sourceAccount=source.muxed, fee=100 * len(ops),
                     seqNum=seq, timeBounds=None, memo=Memo.none(),
                     operations=ops, ext=_Ext.v0())
    frame = TransactionFrame(source.ledger.network_id,
                             TransactionEnvelope.for_tx(tx))
    frame.add_signature(source.sk)
    return frame.envelope


def _envelope(kind: str, accounts, seq: int) -> TransactionEnvelope:
    src, dest, other, fee_src = accounts
    if kind == "payment":
        return _v1(src, [src.op_payment(dest.account_id, 10)], seq)
    if kind == "multi_op":
        own = src.op_payment(dest.account_id, 5)
        own.sourceAccount = other.muxed
        return _v1(src, [own, src.op_manage_data("k", b"v"),
                         src.op_payment(other.account_id, 7)], seq)
    assert kind == "fee_bump"
    own = src.op_payment(dest.account_id, 3)
    own.sourceAccount = other.muxed
    inner = _v1(src, [src.op_payment(dest.account_id, 4), own], seq)
    fb = FeeBumpTransactionFrame(src.ledger.network_id, TransactionEnvelope(
        EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP, FeeBumpTransactionEnvelope(
            tx=FeeBumpTransaction(
                feeSource=fee_src.muxed, fee=1000,
                innerTx=_InnerTxEnvelope(EnvelopeType.ENVELOPE_TYPE_TX,
                                         inner.value),
                ext=_Ext.v0()),
            signatures=[])))
    fb.add_signature(fee_src.sk)
    return fb.envelope


@pytest.fixture(scope="module")
def wire():
    """Each kind's wire bytes: an envelope, or for `txset` a set of 200
    envelopes of the three other kinds in turn."""
    ledger = SimpleNamespace(network_id=TESTING_NETWORK_ID)
    accounts = [TestAccount(ledger, sk) for sk in _keys()]
    out = {k: _envelope(k, accounts, 1).to_xdr() for k in KINDS[:3]}
    out["txset"] = TransactionSet(
        previousLedgerHash=b"\x07" * 32,
        txs=[_envelope(KINDS[i % 3], accounts, 1 + i)
             for i in range(200)]).to_xdr()
    return ledger.network_id, out


def _parse(network_id: bytes, kind: str, blob: bytes):
    """The kind's frames parsed from wire, touched the way catchup touches
    them: the set's hash, each frame's frozen signatures and contents
    hash, each op's source."""
    if kind == "txset":
        built = TxSetFrame.from_wire(network_id,
                                     TransactionSet.from_xdr(blob))
        built.get_contents_hash()
        frames = built.frames
    else:
        built = TransactionFrame.make_from_wire(
            network_id, TransactionEnvelope.from_xdr(blob))
        frames = [built]
    for f in frames:
        f.freeze_signatures()
        f.contents_hash()
        for op in _tx_frame(f).op_frames:
            op.source_account_id()
    return built


def _tx_frame(f) -> TransactionFrame:
    return f.inner if isinstance(f, FeeBumpTransactionFrame) else f


def _frames(built):
    return built.frames if isinstance(built, TxSetFrame) else [built]


@pytest.mark.parametrize("kind", KINDS)
def test_parsed_frames_leave_no_cyclic_garbage(kind, wire):
    network_id, blobs = wire
    gc.collect()
    flags = gc.get_debug()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        built = _parse(network_id, kind, blobs[kind])
        assert _frames(built)
        del built
        gc.collect()
        port = sorted({type(o).__qualname__ for o in gc.garbage
                       if type(o).__module__.startswith(_PORT)})
    finally:
        gc.set_debug(flags)
        gc.garbage.clear()
        gc.collect()
    assert port == []


def _weakrefs(built) -> list:
    refs = [weakref.ref(built)]
    for f in _frames(built):
        refs.append(weakref.ref(f))
        if isinstance(f, FeeBumpTransactionFrame):
            refs.append(weakref.ref(f.inner))
        refs.extend(weakref.ref(op) for op in _tx_frame(f).op_frames)
    return refs


@pytest.mark.parametrize("kind", KINDS)
def test_dropped_frame_dies_by_reference_count(kind, wire):
    network_id, blobs = wire
    enabled = gc.isenabled()
    gc.disable()
    try:
        built = _parse(network_id, kind, blobs[kind])
        refs = _weakrefs(built)
        kinds = {type(r()) for r in refs}
        del built
        alive = [r for r in refs if r() is not None]
    finally:
        if enabled:
            gc.enable()
    assert TransactionFrame in kinds
    if kind in ("fee_bump", "txset"):
        assert FeeBumpTransactionFrame in kinds
    assert alive == []


@pytest.mark.parametrize("kind", KINDS)
def test_op_source_falls_back_to_the_transactions(kind, wire):
    network_id, blobs = wire
    built = _parse(network_id, kind, blobs[kind])
    own = fallback = 0
    for f in _frames(built):
        tx = _tx_frame(f)
        for op in tx.op_frames:
            if op.op.sourceAccount is not None:
                want = op.op.sourceAccount.account_id
                own += 1
            else:
                want = tx.source_account_id()
                if f is not tx:
                    # a fee bump's ops fall back to the inner source,
                    # never to the fee source
                    assert want == f.seq_account_id() != f.fee_account_id()
                fallback += 1
            assert op.source_account_id() == want
    assert fallback
    assert own or kind == "payment"
