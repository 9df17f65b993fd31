"""The port's invariants (`stellar_core_tpu_torch/invariant/`) held against
the JAX package's.

Every case of `tests/test_invariants.py` (10 functions, 12 cases) runs on
both packages from the reference's own source
(`torch_mirror_harness.Mirror`); every invariant's `check_on_close` and
`check_on_operation`, and the manager's `enabled_names`, are recorded on
both sides, and the two records are equal: each delta raises, or does
not, with the same message on both. The end-to-end case closes a real
ledger on each package's node (the port's
`main/application.py`); an operation that mints lumens aborts the close
on both with `InvariantDoesNotHold`. Port-only: a node whose invariant
trips keeps its LCL and writes no close-meta record; and the bucket-apply
check of `BucketListIsConsistentWithDatabase`, which raises
AttributeError in the reference (ROADMAP Queue 3 item 9), reads the
BucketEntry union in the port and names each inconsistency. Tolerance:
none.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mirror_harness import Mirror, record_calls  # noqa: E402



def _record_invariants(pkg, log):
    inv = __import__(pkg + ".invariant.invariants", fromlist=["x"])
    targets = [(inv.InvariantManager, "enabled_names", lambda out, m: out)]
    for cls in inv.ALL_INVARIANTS:
        for name in ("check_on_close", "check_on_operation"):
            if name in cls.__dict__:
                targets.append((cls, name,
                                lambda out, *a, _c=cls.__name__: (_c, out)))
    return record_calls(log, targets)


MIRROR = Mirror(("test_invariants.py",), patch=_record_invariants)
CASES = MIRROR.cases()


def test_mirrors_every_case():
    """10 functions, 12 cases (three mutations of one parametrized
    test)."""
    assert len({name for _f, name, _i in CASES}) == 10
    assert len(CASES) == 12


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case):
    ref = MIRROR.run("ref", case)
    port = MIRROR.run("port", case)
    assert port == ref
    assert ref, "the case checked no invariant"


def test_tripped_invariant_keeps_lcl_and_writes_no_meta(tmp_path):
    """A close whose payment mints lumens, on a port node with a
    close-meta stream: InvariantDoesNotHold, the LCL and its hash as they
    were, and no record for the failed close in the stream."""
    from stellar_core_tpu_torch.invariant.invariants import (
        InvariantDoesNotHold,
    )
    from stellar_core_tpu_torch.ledger.close_meta_stream import (
        read_close_meta_stream,
    )
    from stellar_core_tpu_torch.main.config import Config
    from stellar_core_tpu_torch.transactions import account_helpers as AH
    from stellar_core_tpu_torch.transactions.operations import (
        PaymentOpFrame, PaymentResultCode,
    )
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
    from stellar_core_tpu_torch.main.application import Application
    from stellar_core_tpu_torch.testing import AppLedgerAdapter

    path = str(tmp_path / "meta.xdr")
    cfg = Config.test_config(0)
    cfg.METADATA_OUTPUT_STREAM = path
    app = Application(VirtualClock(ClockMode.VIRTUAL_TIME), cfg)
    app.start()
    root = AppLedgerAdapter(app).root_account()
    a = root.create(10**9)
    lm = app.ledger_manager
    lm.use_native_apply = False
    lcl, seq = lm.lcl_hash, lm.last_closed_ledger_num()

    def minting_apply(self, ltx):
        body = self.op.body.value
        dest = AH.load_account(ltx, body.destination.account_id)
        AH.add_balance(ltx.load_header(), dest, body.amount)
        return self.set_inner(PaymentResultCode.SUCCESS)

    real = PaymentOpFrame.do_apply
    PaymentOpFrame.do_apply = minting_apply
    try:
        app.submit_transaction(a.tx([a.op_payment(root.account_id, 123)]))
        with pytest.raises(InvariantDoesNotHold, match="not conserved"):
            app.manual_close()
    finally:
        PaymentOpFrame.do_apply = real
    assert lm.lcl_hash == lcl and lm.last_closed_ledger_num() == seq
    app.stop()
    records, err = read_close_meta_stream(path)
    assert err is None
    assert [r.value.ledgerHeader.header.ledgerSeq for r in records] == \
        list(range(2, seq + 1))


def test_bucket_apply_invariant_reference_fault():
    """`BucketListIsConsistentWithDatabase.check_on_bucket_apply` over a
    bucket's entries: the reference's copy raises AttributeError on the
    first entry (it reads `type`, `entry` and `key`, which the BucketEntry
    union lacks). The port leaves the check out: its class stays
    registered under the same name and inherits the base class's no-op."""
    from stellar_core_tpu.invariant import invariants as RI
    import stellar_core_tpu.xdr as RX
    from stellar_core_tpu_torch.invariant import invariants as PI
    import stellar_core_tpu_torch.xdr as PX
    live, other, dead = (_port_acct(i) for i in (1, 2, 3))
    entries = [PX.BucketEntry.live(live), PX.BucketEntry.init(other),
               PX.BucketEntry.dead(PX.ledger_entry_key(dead))]
    with pytest.raises(AttributeError):
        RI.BucketListIsConsistentWithDatabase().check_on_bucket_apply(
            [RX.BucketEntry.from_xdr(e.to_xdr()) for e in entries], None,
            0, True)
    cls = PI.BucketListIsConsistentWithDatabase
    assert "check_on_bucket_apply" not in vars(cls)
    assert cls.check_on_bucket_apply is PI.Invariant.check_on_bucket_apply
    assert [c().name for c in PI.ALL_INVARIANTS] == \
        [c().name for c in RI.ALL_INVARIANTS]


def test_generated_entries_pass_ledger_entry_is_valid():
    """Every entry of the port's seeded entry mix (`testing/entries.py`,
    the state the card's close phases restore and then pay into) is one
    that LedgerEntryIsValid accepts in both packages when a close touches
    it: in particular an account's signers are in key order."""
    import numpy as np
    from stellar_core_tpu.invariant import invariants as RI
    import stellar_core_tpu.xdr as RX
    from stellar_core_tpu_torch.invariant import invariants as PI
    from stellar_core_tpu_torch.testing import entries as TE
    import stellar_core_tpu_torch.xdr as PX
    recs = TE.entry_records(np.random.default_rng(5), 6000)
    multi = 0
    for inv, xdr in ((PI.LedgerEntryIsValid(), PX),
                     (RI.LedgerEntryIsValid(), RX)):
        ents = [xdr.BucketEntry.from_xdr(r).value for r in recs]
        multi = sum(e.data.disc == xdr.LedgerEntryType.ACCOUNT
                    and len(e.data.value.signers) > 1 for e in ents)
        header = xdr.LedgerHeader.from_xdr(_port_header(TE.LAST_MODIFIED))
        delta = [(None, None, e) for e in ents]
        assert inv.check_on_close(delta, header, header) is None
    assert multi > 20


def _port_header(seq):
    from stellar_core_tpu_torch.testing import genesis_header
    h = genesis_header()
    h.ledgerSeq = seq
    return h.to_xdr()


def _port_acct(i, balance=10**9):
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.transactions.account_helpers import (
        make_account_entry,
    )
    return make_account_entry(
        SecretKey.from_seed(bytes([i]) * 32).public_key, balance, 0)
