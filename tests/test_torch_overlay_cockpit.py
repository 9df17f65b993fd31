"""The port's overlay and propagation cockpits
(`stellar_core_tpu_torch/overlay/overlay_stats.py`,
`overlay/propagation_stats.py`) held against the JAX package's.

Eleven of the fifteen cases of `tests/test_overlay_cockpit.py` and eleven
of the thirteen of `tests/test_propagation.py` run on both packages from
the reference's own source (`torch_mirror_harness.Mirror`), the port's
nodes built by `torch_sim_harness` and `torch_app_harness`, with the
decisions of `torch_overlay_records.record_overlay` recorded on both
sides and equal, in order. Left out, for `main/command_handler.py` and
`util/metrics.py`'s exposition (ROADMAP Queue 1 item 8): the
`overlaystats` endpoint, the two Prometheus help cases and the help
catalog (`test_overlay_cockpit.py`), the `propagation` / `health`
endpoints on a live net and over HTTP (`test_propagation.py`); and the
four lines of `test_propagation_disabled_by_config` that read those
endpoints are cut from both sides' source (the rest of the case runs).
Tolerance: none.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_app_harness import APP_SUBS  # noqa: E402
from torch_mirror_harness import Mirror  # noqa: E402
from torch_sim_harness import SIM_SUBS  # noqa: E402
import torch_overlay_records as R  # noqa: E402

# the admin endpoint's reads in the disabled-cockpit case
ENDPOINT_SUBS = (
    (r"\n    st, body = a\.command_handler\.handle_command\(\"propagation\", "
     r"\{\}\)\n    assert st == 200 and \"disabled\" in body\[\"error\"\]",
     ""),
    (r"\n    st, health = a\.command_handler\.handle_command\(\"health\", "
     r"\{\}\)\n    assert st == 200 and health\.get\("
     r"\"worst_peer_usefulness\"\) is None", ""),
)

MIRROR = Mirror(("test_overlay_cockpit.py", "test_propagation.py"),
                patch=R.record_overlay,
                subs=APP_SUBS + SIM_SUBS + ENDPOINT_SUBS)
CASES = MIRROR.cases(drop=(
    "test_overlaystats_endpoint_round_trip",
    "test_prometheus_help_lines",
    "test_prometheus_help_fallback_is_the_metric_name",
    "test_help_catalog_parses_docs_tables",
    "test_propagation_and_health_endpoints_on_live_net",
    "test_propagation_endpoint_over_http"))


def test_mirrors_twenty_two_cases():
    by_file = {}
    for f, _n, _i in CASES:
        by_file[f] = by_file.get(f, 0) + 1
    assert by_file == {"test_overlay_cockpit.py": 11,
                       "test_propagation.py": 11}
    src = MIRROR.sides["port"]["mods"]["test_propagation.py"]
    assert "command_handler" not in \
        src.test_propagation_disabled_by_config.__code__.co_names


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case, tmp_path):
    sides = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        sides[side] = MIRROR.run(side, case, {"tmp_path": d})
    assert sides["port"] == sides["ref"]
