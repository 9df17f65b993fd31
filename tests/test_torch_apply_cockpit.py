"""The port's close cockpit (`ledger/apply_stats.py` and its hooks in the
close, the frames, the SQL root, the bucket layer and the apply engine's
glue) held against the JAX package's.

Every case of `tests/test_apply_cockpit.py` (14) runs on both packages
from the reference's own source (`torch_mirror_harness.Mirror`), the
port's node being its own `main/application.py`. Every sealed
close window (`ApplyStats.end_close`: path, bail, op counts, and the
reads: SQL lookups by type, cache hits and misses, bucket reads, bulk-scan
rows, read and write sets), every prefetch pass (`record_prefetch`),
every bail and every engine cluster shape is recorded on both sides, with
the times left out, and the two records are equal, on the apply engine
and on the Python phases alike. The reference's `_drive_closes` makes
its traffic with `LoadGenerator` (`simulation/`, not ported); both sides
here take the next two closes of `tests/torch_close_harness.py`'s
workload instead (funding, signers, trust lines, then the standard mix),
built once as envelope bytes and submitted through each node's herder
(six closes for the exposition case, whose assertion reads a payment's
count: the workload's first payments close sixth), and each case keeps
its assertions, the admin endpoint's and the
Prometheus exposition's included. The taxonomy case
reads `docs/observability.md` through the reference's analysis package
on both sides (the port has no `analysis/`). The only tolerance is the
reference's own `_breakdown_sums` bound on the per-op parts' sum against
the apply wall.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_close_harness as CH  # noqa: E402
from torch_mirror_harness import Mirror, record_calls  # noqa: E402

import stellar_core_tpu_torch.xdr as PX  # noqa: E402

DRIVE = '''
def _drive_closes(app, n_payments=6, n_closes=2):
    import torch_close_harness as _CH
    from {pkg}.transactions.transaction_frame import TransactionFrame
    from {pkg}.xdr import TransactionEnvelope
    steps = _WORKLOADS.setdefault(id(app), _workload_steps(app))
    for _ in range(n_closes):
        for blob in next(steps):
            app.submit_transaction(TransactionFrame.make_from_wire(
                app.config.network_id, TransactionEnvelope.from_xdr(blob)))
        app.clock.set_virtual_time(app.clock.now() + 1.0)
        app.manual_close()


_WORKLOADS = {}
'''

SUBS = (
    (r"from stellar_core_tpu_torch\.analysis\.crules import",
     "from stellar_core_tpu.analysis.crules import"),
    (r"(?ms)^def _drive_closes\(app, n_payments=6\):\n.*?\n\n\n", DRIVE),
    # the exposition case reads a payment's op count: the workload's
    # first payments close sixth (after funding, signers, trust lines,
    # authorization and issuance)
    (r"(?m)^(def test_prometheus_series_roundtrip\(app\):\n"
     r"    _drive_closes\(app)\)", r"\1, n_closes=6)"),
)


class NodeShim:
    """The workload's ledger surface over a node of either package: the
    node's header, and sequence numbers and balances read through its
    root with the node's own keys."""

    def __init__(self, app, X):
        self.app, self.X = app, X
        self.network_id = app.config.network_id

    def header(self):
        return self.app.ledger_manager.lcl_header

    def _entry(self, account_id):
        key = self.X.LedgerKey.from_xdr(
            PX.LedgerKey.account(account_id).to_xdr())
        return self.app.ledger_manager.ltx_root().get_entry(key)

    def seq_num(self, account_id):
        e = self._entry(account_id)
        return e.data.value.seqNum if e is not None else 0

    def balance(self, account_id):
        return self._entry(account_id).data.value.balance


def _workload_steps(X):
    def steps(app):
        w = CH.Workload(None, shim=NodeShim(app, X))
        for build, _ups in w.schedule():
            yield [f.envelope_bytes() for f in build()]
    return steps


def _hook(side, pkg, mods, log):
    mod = mods["test_apply_cockpit.py"]
    X = __import__(pkg + ".xdr", fromlist=["x"])
    mod._workload_steps = _workload_steps(X)
    if side == "port":
        from stellar_core_tpu_torch.crypto.batch_hasher import make_hasher
        from stellar_core_tpu_torch.crypto.batch_verifier import (
            CpuSigVerifier,
        )
        # the port's close needs the app's verifier and hasher
        mod._StubApp.sig_verifier = CpuSigVerifier()
        mod._StubApp.batch_hasher = make_hasher("cpu")


def _close_blob(out, *a, **kw):
    if out is None:
        return None
    return {"seq": out["seq"], "path": out["path"], "bail": out["bail"],
            "ops": {n: d["count"] for n, d in out["ops"].items()},
            "reads": out["reads"]}


def _record_cockpit(pkg, log):
    st = __import__(pkg + ".ledger.apply_stats", fromlist=["x"])
    return record_calls(log, [
        (st.ApplyStats, "end_close", _close_blob),
        (st.ApplyStats, "record_prefetch",
         lambda out, s, *a, **kw: (a, sorted(kw.items()))),
        (st.ApplyStats, "record_bail", lambda out, s, reason: reason),
        (st.ApplyStats, "record_clusters",
         lambda out, s, count, width, workers, parallel, apply_ns=0: (
             count, width, parallel)),
        (st.ApplyStats, "record_tx_counts", lambda out, s, *a: a),
    ])


MIRROR = Mirror(("test_apply_cockpit.py",), hook=_hook,
                patch=_record_cockpit, subs=SUBS)
CASES = MIRROR.cases()


# the cases that close no ledger: key collection, traits, the taxonomy
PURE = ("test_frame_traits_muxed_detection",
        "test_txset_prefetch_keys_cover_sources_and_destinations",
        "test_native_bail_taxonomy_is_metric_safe_and_classify_stable")


def test_mirrors_twelve_cases():
    """All fourteen, since the port has its admin endpoint."""
    assert len(CASES) == 14


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case, tmp_path):
    sides = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        sides[side] = MIRROR.run(side, case, {"tmp_path": d})
    assert sides["port"] == sides["ref"]
    _f, name, _i = case
    if name not in PURE:
        assert sides["ref"], "the case closed no ledger"
