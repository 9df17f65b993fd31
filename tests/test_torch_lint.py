"""The repo's own lint rules over the port.

`stellar_core_tpu.analysis.engine.run_analysis` runs over
`stellar_core_tpu_torch/` with the rules that read Python sources alone:
D1 (wall clock outside the clock abstraction), D2 (unseeded randomness),
T1 (threads), E1 (swallowed exceptions in consensus code), S1 (set order
feeding consensus) and FL1 (floats in consensus code). The allowlist is
the reference's own (`stellar_core_tpu/analysis/allowlist.txt`), each
entry's path rewritten to the port's copy of the file, keeping the
entries whose file the port has and, where an entry names a function or
class, whose file defines it. Every finding must be covered by such an
entry, no file may fail to parse, and no entry may cover nothing: since
the simulation slice brought the `simulate` command back, the port leaves
out no allowlisted code. The command line brings its findings with it
(the key generation of `gen-seed`; `simulate`'s stopwatch and its
throwaway node seed), each covered by the reference's entry.
"""

import os
import re

from stellar_core_tpu.analysis.engine import LintConfig, run_analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = ("D1", "D2", "T1", "E1", "S1", "FL1")


def defines(path, qual) -> bool:
    """Whether the file at `path` defines the last name of `qual`."""
    with open(path, encoding="utf-8") as fh:
        return re.search(r"(?m)^\s*(def|class)\s+%s\b"
                         % re.escape(qual.split(".")[-1]),
                         fh.read()) is not None


def port_allowlist(path) -> int:
    """The reference's allowlist for RULES, pointed at the port; returns
    the number of entries kept."""
    with open(os.path.join(REPO, "stellar_core_tpu", "analysis",
                           "allowlist.txt"), encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    kept = []
    for line in lines:
        m = re.match(r"(\S+)\s+stellar_core_tpu/(\S+?)(#\S+)?\s+(--|—)\s",
                     line.strip())
        if m is None or m.group(1) not in RULES:
            continue
        port = os.path.join(REPO, "stellar_core_tpu_torch", m.group(2))
        if os.path.exists(port) and (m.group(3) is None or defines(
                port, m.group(3)[1:])):
            kept.append(line.strip().replace(
                "stellar_core_tpu/", "stellar_core_tpu_torch/", 1))
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(kept) + "\n")
    return len(kept)


def test_port_is_clean_under_the_reference_allowlist(tmp_path):
    allow = tmp_path / "allowlist.txt"
    assert port_allowlist(allow) > 10
    cfg = LintConfig(
        repo_root=REPO,
        package_dir=os.path.join(REPO, "stellar_core_tpu_torch"),
        package_name="stellar_core_tpu_torch", allowlist_path=str(allow),
        docs_metrics_path=None, docs_robustness_path=None,
        fault_registry=None, enabled_rules=RULES)
    res = run_analysis(cfg)
    assert res.parse_errors == []
    assert res.findings, "the rules found nothing to check"
    assert res.violations == [], "\n".join(map(str, res.violations))
    assert res.stale_entries == []
    # the slot journal's perf-counter stamps, allowlisted as in the
    # reference: this slice's modules are in the scan
    assert any(f.path == "stellar_core_tpu_torch/util/slot_timeline.py"
               for f in res.findings)
    # the overlay slice's reactor thread and keyed short hash, allowlisted
    # as in the reference
    paths = {f.path for f in res.findings}
    assert "stellar_core_tpu_torch/overlay/transport.py" in paths
    assert "stellar_core_tpu_torch/crypto/hashing.py" in paths
    # the command line: the key generation of `gen-seed` (D2) and
    # `simulate`'s stopwatch (D1, twice) and node seed (D2), allowlisted
    # as in the reference; the admin API and the fuzzer have no finding
    main = sorted((f.rule, f.qualname) for f in res.findings
                  if f.path.startswith("stellar_core_tpu_torch/main/"))
    assert main == [("D1", "cmd_simulate"), ("D1", "cmd_simulate"),
                    ("D2", "cmd_gen_seed"), ("D2", "cmd_simulate")]
