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
its traffic with each package's own `simulation/load_generator.py`, and
each case keeps its assertions, the admin endpoint's and the
Prometheus exposition's included. The taxonomy case
reads `docs/observability.md` through each side's own analysis package
(the port's `analysis/crules.py` on the port's side). The only tolerance
is the reference's own `_breakdown_sums` bound on the per-op parts' sum against
the apply wall.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mirror_harness import Mirror, record_calls  # noqa: E402

def _hook(side, pkg, mods, log):
    mod = mods["test_apply_cockpit.py"]
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
                patch=_record_cockpit)
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
