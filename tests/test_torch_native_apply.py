"""The port's apply engine held against its Python path and the reference's
engine.

Every case of `tests/test_native_apply.py` (12 functions, 15 cases, the
three soak seeds included) runs on the port from the reference's own
source (`torch_mirror_harness.Mirror`, imports pointed at
`stellar_core_tpu_torch`). Its harnesses there close every set on a port
manager through the engine and on one pinned to the Python phases (the
parallel harness: forced-parallel engine, forced-serial engine, Python)
and compare, after every close, the header hash, the sorted entries and
each transaction's result, fee meta and tx meta XDR. This file adds, at
every close: the close-level delta the bucket list takes (keys, pre-images,
post-images, first-touch order), equal between the port's managers; and
the same envelopes closed on a manager of the reference's with its engine,
whose header hash, entries, results, fee and tx meta and delta equal the
port engine's.

Where the port differs on purpose, the source is rewritten for both
sides: the residual-bail case hands `native_apply_txset` a CpuSigVerifier
where the reference's source passes None (the reference builds that same
verifier; the port raises TypeError, held below), and the port's stub
app carries the verifier and hasher its close requires. The port's
managers carry their own close cockpit (`apply_stats`), whose cluster
telemetry the cases read as the reference's.

Port-only cases: a failed engine build raises with the compiler's
output; a verifier that raises inside the engine's callback fails the
close with nothing applied; no verifier raises TypeError;
`_classify_engine_bail` names equal the reference's. Tolerance: none.
"""

import os

import pytest

from stellar_core_tpu.ledger import native_apply as RNA
from stellar_core_tpu.ledger.ledgertxn import LedgerTxn as RLedgerTxn
from stellar_core_tpu_torch import native as N
from stellar_core_tpu_torch import _build
from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
from stellar_core_tpu_torch.crypto.batch_verifier import CpuSigVerifier
from stellar_core_tpu_torch.ledger import native_apply as NA
from stellar_core_tpu_torch.ledger.ledgertxn import LedgerTxn

from torch_mirror_harness import Mirror

pytestmark = pytest.mark.skipif(
    _build.find_cc() is None, reason="no C compiler on this host")


def _blob(x):
    if x is None or isinstance(x, bytes):
        return x
    return x.to_xdr()


class DeltaSpy:
    """Records the close-level delta (the close's one
    `get_delta(need_prev=False, ...)`) of every close of one package, as
    (key, pre-image, post-image) XDR in first-touch order."""

    def __init__(self, cls):
        self.cls, self.got = cls, []

    def __enter__(self):
        orig = self.orig = self.cls.get_delta
        got = self.got

        def spy(ltx, need_prev=True, raw_keys=False):
            out = orig(ltx, need_prev, raw_keys)
            if not need_prev:
                got.append([(_blob(k), _blob(p), _blob(c))
                            for k, p, c in out])
            return out

        self.cls.get_delta = spy
        return self

    def __exit__(self, *exc):
        self.cls.get_delta = self.orig
        return False


def _observe(lm, frames):
    from stellar_core_tpu_torch.xdr import LedgerEntryChanges
    from stellar_core_tpu_torch.xdr.codec import xdr_bytes
    return {
        "lcl_hash": lm.lcl_hash,
        "entries": sorted(e.to_xdr() for e in lm.root.all_entries()),
        "results": [f.result.to_xdr() for f in frames],
        "fee_meta": [xdr_bytes(LedgerEntryChanges, f.fee_meta)
                     for f in frames],
        "tx_meta": [f.tx_meta().to_xdr() for f in frames],
    }


def _ref_observe(lm, frames):
    from stellar_core_tpu.xdr import LedgerEntryChanges
    from stellar_core_tpu.xdr.codec import xdr_bytes
    return {
        "lcl_hash": lm.lcl_hash,
        "entries": sorted(e.to_xdr() for e in lm.root.all_entries()),
        "results": [f.result.to_xdr() for f in frames],
        "fee_meta": [xdr_bytes(LedgerEntryChanges, f.fee_meta)
                     for f in frames],
        "tx_meta": [f.tx_meta().to_xdr() for f in frames],
    }


def _ref_close(rmod, lm, blobs):
    """Close `blobs` on a reference manager as the reference's harness
    does; returns its frames in apply order."""
    from stellar_core_tpu.herder.txset import TxSetFrame
    from stellar_core_tpu.ledger.ledger_manager import LedgerCloseData
    from stellar_core_tpu.transactions.transaction_frame import (
        TransactionFrame,
    )
    from stellar_core_tpu.xdr import (
        StellarValue, StellarValueExt, TransactionEnvelope,
    )
    net = rmod.TESTING_NETWORK_ID
    fr = [TransactionFrame.make_from_wire(
        net, TransactionEnvelope.from_xdr(b)) for b in blobs]
    header = lm.root.get_header()
    ts = TxSetFrame(net, lm.lcl_hash, fr)
    value = StellarValue(txSetHash=ts.get_contents_hash(),
                         closeTime=header.scpValue.closeTime + 5,
                         upgrades=[], ext=StellarValueExt(0, None))
    lm.close_ledger(LedgerCloseData(header.ledgerSeq + 1, ts, value))
    return ts.sort_for_apply()


def _hook(side, pkg, mods, log):
    """Port side only: the stub app's verifier and hasher, and harnesses
    that also close every set on the reference's engine and compare the
    close-level deltas."""
    if side != "port":
        return
    mod = mods["test_native_apply.py"]
    mod._StubApp.sig_verifier = CpuSigVerifier()
    mod._StubApp.batch_hasher = make_hasher("cpu")

    def held(harness_cls, n_port):
        class Held(harness_cls):
            """`harness_cls` whose every close also runs on a manager of
            the reference's with its engine."""

            def __init__(self):
                super().__init__()
                self.ref = MIRROR_REF["mod"].DiffHarness._mk(True)

            def close(self, frames):
                rmod = MIRROR_REF["mod"]
                blobs = [f.envelope_bytes() for f in frames]
                with DeltaSpy(LedgerTxn) as pd:
                    out = super().close(frames)
                with DeltaSpy(RLedgerTxn) as rd:
                    r_frames = _ref_close(rmod, self.ref, blobs)
                assert len(pd.got) == n_port and len(rd.got) == 1
                for d in pd.got[1:]:
                    assert d == pd.got[0], "close-level delta diverged"
                assert rd.got[0] == pd.got[0], \
                    "the reference engine's delta diverged"
                lm = getattr(self, "native", None) or self.parallel
                po, ro = _observe(lm, out), _ref_observe(self.ref,
                                                         r_frames)
                for k in po:
                    assert po[k] == ro[k], \
                        "%s diverged from the reference engine" % k
                log.append(("close", len(out),
                            all(f._native_meta_b is not None for f in out)))
                return out
        return Held

    mod.DiffHarness = held(mod.DiffHarness, 2)
    mod.ParallelDiffHarness = held(mod.ParallelDiffHarness, 3)


# the residual-bail case passes no verifier; the reference then builds a
# CpuSigVerifier, the port raises (held by test_no_verifier_raises)
SUBS = [(r"native_apply_txset\(lm, ltx, \[bad\], None, None\)",
         "native_apply_txset(lm, ltx, [bad], None, __import__("
         "'{pkg}.crypto.batch_verifier', fromlist=['CpuSigVerifier'])"
         ".CpuSigVerifier())")]
MIRROR_REF = {}
MIRROR = Mirror(["test_native_apply.py"], hook=_hook, subs=SUBS)
MIRROR_REF["mod"] = MIRROR.sides["ref"]["mods"]["test_native_apply.py"]
CASES = MIRROR.cases()


def test_mirrors_every_case():
    """12 functions, 15 cases (the soak's three seeds among them)."""
    assert len({name for _f, name, _i in CASES}) == 12
    assert len(CASES) == 15


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_engine_matches(case):
    closes = MIRROR.run("port", case)
    _f, name, _i = case
    if name in ("test_native_apply_residual_bails",
                "test_pipeline_stall_fault_runs_prewarm_inline"):
        return          # no harness close beyond the set-up, or none
    assert closes and any(native for _c, _n, native in closes)


# ------------------------------------------------------------ port-only

def test_failed_engine_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output;
    no Python apply is chosen in its place."""
    src = tmp_path / "native"
    src.mkdir()
    (src / "applyc.c").write_text(
        "#include <Python.h>\nint broken( { return 0; }\n")
    monkeypatch.setattr(_build, "NATIVE_DIR", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(N, "_EXTS", {})
    with pytest.raises(RuntimeError) as e:
        N.apply_engine()
    assert "cc failed for applyc.c" in str(e.value)
    assert "broken" in str(e.value)
    assert "applyc" not in N._EXTS


def test_engine_loads_from_port_build_dir():
    mod = N.apply_engine()
    assert mod.__name__ == "_sctapply_torch"
    assert os.path.dirname(mod.__file__) == _build.native_build_dir()


class RaisingVerifier(CpuSigVerifier):
    calls = 0

    def prewarm_many(self, triples):
        RaisingVerifier.calls += 1
        raise RuntimeError("drain failed on the card")


def _port_harness():
    return MIRROR.sides["port"]["mods"]["test_native_apply.py"]


def test_raising_callback_fails_close_and_applies_nothing(monkeypatch):
    """A verifier that raises inside the engine's verify callback: the
    close raises SignatureVerifyError (as the Python phases do on a failed
    drain), the LCL and every entry stay as they were, and no transaction
    is applied by the Python phases instead."""
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.crypto.hashing import sha256
    from stellar_core_tpu_torch.herder.txset import TxSetFrame
    from stellar_core_tpu_torch.ledger.ledger_manager import (
        LedgerCloseData,
    )
    from stellar_core_tpu_torch.testing import TestAccount, root_secret_key
    from stellar_core_tpu_torch.transactions import transaction_frame as TF
    from stellar_core_tpu_torch.xdr import StellarValue, StellarValueExt
    m = _port_harness()
    lm = m.DiffHarness._mk(True)
    shim = m._Shim(lm)
    root = TestAccount(shim, root_secret_key())
    a = TestAccount(shim, SecretKey.from_seed(sha256(b"raise-a")))
    frame = root.tx([root.op_create_account(a.account_id, 10 ** 9)])
    applied = []
    monkeypatch.setattr(TF.TransactionFrame, "apply",
                        lambda *a, **k: applied.append(1))
    lm.app.sig_verifier = RaisingVerifier()
    lcl, entries = lm.lcl_hash, sorted(
        e.to_xdr() for e in lm.root.all_entries())
    header = lm.root.get_header()
    seq = header.ledgerSeq
    ts = TxSetFrame(m.TESTING_NETWORK_ID, lm.lcl_hash, [frame])
    value = StellarValue(txSetHash=ts.get_contents_hash(),
                         closeTime=header.scpValue.closeTime + 5,
                         upgrades=[], ext=StellarValueExt(0, None))
    from stellar_core_tpu_torch.transactions.signature_checker import (
        SignatureVerifyError,
    )
    RaisingVerifier.calls = 0
    with pytest.raises(SignatureVerifyError, match="drain failed"):
        lm.close_ledger(LedgerCloseData(seq + 1, ts, value))
    assert RaisingVerifier.calls == 1
    assert applied == []
    assert lm.lcl_hash == lcl and lm.last_closed_ledger_num() == seq
    assert sorted(e.to_xdr() for e in lm.root.all_entries()) == entries


def test_no_verifier_raises():
    m = _port_harness()
    lm = m.DiffHarness._mk(True)
    ltx = LedgerTxn(lm.root)
    try:
        with pytest.raises(TypeError, match="needs a verifier"):
            NA.native_apply_txset(lm, ltx, [], None, None)
    finally:
        ltx.rollback()


def test_bail_names_match_reference():
    reasons = ["op-%d" % n for n in range(-1, 30)] + [
        "op-", "op-x1", "signer-key-type", "multisig-shape",
        "threshold-range", "inflation-payout", "op-shape", "op-auth",
        "verify-shape", "envelope"]
    for r in reasons:
        assert NA._classify_engine_bail(r) == RNA._classify_engine_bail(r)
