"""The port's close-meta stream (`ledger/close_meta_stream.py` and the
close's `_emit_close_meta`) held against the JAX package's.

Every case of `tests/test_close_meta_stream.py` (7) runs on both packages
from the reference's own source (`torch_mirror_harness.Mirror`), the
port's node being its own `main/application.py`; every record a node
writes (`CloseMetaStream.write_one`) is logged as its XDR bytes, and the
two logs are equal record for record, byte for byte. Port-only: the same closes, on the apply engine and on
the Python phases, with a base-fee and a base-reserve upgrade, write the
same stream file, byte for byte, on both packages; and the port's
`read_close_meta_stream` reads the reference's file to the same values.
Tolerance: none.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mirror_harness import Mirror, record_calls  # noqa: E402



def _record_stream(pkg, log):
    cms = __import__(pkg + ".ledger.close_meta_stream", fromlist=["x"])
    return record_calls(log, [
        (cms.CloseMetaStream, "write_one",
         lambda out, s, meta: meta.to_xdr()),
    ])


MIRROR = Mirror(("test_close_meta_stream.py",), patch=_record_stream)
CASES = MIRROR.cases()


def test_mirrors_six_cases():
    """All seven, since the port's Config reads TOML."""
    assert len(CASES) == 7


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case, tmp_path):
    sides = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        sides[side] = MIRROR.run(side, case, {"tmp_path": d})
    assert sides["port"] == sides["ref"]
    _f, name, _i = case
    if name not in ("test_dead_pipe_disables_stream_not_consensus",
                    "test_config_knob_roundtrip"):
        assert sides["ref"], "the case wrote no record"


def _closes(pkg, app_cls, adapter_cls, path, native):
    """A node of `pkg` streaming to `path`: two accounts, payments both
    ways over three closes, then a base-fee and a base-reserve upgrade
    riding a payment close."""
    cfg_mod = __import__(pkg + ".main.config", fromlist=["x"])
    timer = __import__(pkg + ".util.timer", fromlist=["x"])
    up = __import__(pkg + ".herder.upgrades", fromlist=["x"])
    keys = __import__(pkg + ".crypto.keys", fromlist=["x"])
    hashing = __import__(pkg + ".crypto.hashing", fromlist=["x"])
    cfg = cfg_mod.Config.test_config(0)
    cfg.METADATA_OUTPUT_STREAM = path
    app = app_cls(timer.VirtualClock(timer.ClockMode.VIRTUAL_TIME), cfg)
    app.start()
    app.ledger_manager.use_native_apply = native
    root = adapter_cls(app).root_account()
    sks = [keys.SecretKey.from_seed(hashing.sha256(b"meta-%d" % i))
           for i in range(2)]
    a, b = (root.create(10**9, sk=sk) for sk in sks)
    for i in range(3):
        app.clock.set_virtual_time(app.clock.now() + 5)
        app.submit_transaction(a.tx([a.op_payment(b.account_id, 10 + i)]))
        app.submit_transaction(b.tx([b.op_payment(a.account_id, 20 + i)]))
        app.manual_close()
    p = up.UpgradeParameters()
    p.upgrade_time = 0
    p.base_fee = 250
    p.base_reserve = 4_000_000
    app.herder.upgrades.set_parameters(p)
    app.submit_transaction(a.tx([a.op_payment(root.account_id, 7)]))
    app.manual_close()
    lcl = app.ledger_manager.lcl_hash
    app.stop()
    return lcl


@pytest.mark.parametrize("native", [True, False], ids=["engine", "python"])
def test_stream_bytes_equal_reference(native, tmp_path):
    from stellar_core_tpu.ledger import close_meta_stream as RCMS
    from stellar_core_tpu.main.application import Application as RApp
    from stellar_core_tpu.testing import AppLedgerAdapter as RAdapter
    from stellar_core_tpu_torch.ledger import close_meta_stream as PCMS
    from stellar_core_tpu_torch.main.application import Application
    from stellar_core_tpu_torch.testing import AppLedgerAdapter
    rpath, ppath = str(tmp_path / "ref.xdr"), str(tmp_path / "port.xdr")
    rl = _closes("stellar_core_tpu", RApp, RAdapter, rpath, native)
    pl = _closes("stellar_core_tpu_torch", Application, AppLedgerAdapter,
                 ppath, native)
    assert pl == rl
    with open(rpath, "rb") as fh:
        rb = fh.read()
    with open(ppath, "rb") as fh:
        pb = fh.read()
    assert pb == rb
    precs, perr = PCMS.read_close_meta_stream(rpath)
    rrecs, rerr = RCMS.read_close_meta_stream(rpath)
    assert perr is None and rerr is None
    assert [r.to_xdr() for r in precs] == [r.to_xdr() for r in rrecs]
    ups = [um for r in precs for um in r.value.upgradesProcessing]
    assert len(ups) == 2
    assert sum(len(r.value.txProcessing) for r in precs) == 2 + 6 + 1
