"""The port's overlay over real TCP sockets on localhost
(`stellar_core_tpu_torch/overlay/transport.py`'s reactor, transports and
door under the overlay manager) held against the JAX package's: the
oversized frame, the straggler and the inbound preferred peer of
`tests/test_overlay_tcp.py`.

The thirteen cases of `tests/test_overlay_tcp.py` wait on the host's
clock, so they are split over `test_torch_overlay_tcp*.py` to keep each
file short; `torch_overlay_records.TCP_GROUPS` names the split, and the
first file checks that it covers all thirteen. Each case runs on both
packages from the reference's own source (`torch_mirror_harness.Mirror`),
the port's nodes being its own `main/application.py` on REAL_TIME
clocks. A real-time run's event order depends on the host's timing, so
what is recorded on each side is what the run decides whatever the timing
(`torch_overlay_records.record_tcp`): the pairs that authenticated and
every bare transport that reported itself closed; the two sides' records
are equal as sets. Tolerance: none.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_overlay_records as R  # noqa: E402
from torch_mirror_harness import Mirror  # noqa: E402

MIRROR = R.tcp_mirror(24600)
CASES = [c for c in MIRROR.cases() if c[1] in R.TCP_GROUPS['tcp_peers']]


@pytest.mark.parametrize("case", CASES, ids=Mirror.case_id)
def test_port_equals_reference(case, tmp_path):
    R.tcp_sides(MIRROR, case, tmp_path)
