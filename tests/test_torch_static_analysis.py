"""The port's lint engine (`stellar_core_tpu_torch/analysis/`) under the
reference's own gate.

Every case of `tests/test_static_analysis.py` (52) runs from the
reference's source (`torch_mirror_harness.Mirror`, imports and paths
pointed at `stellar_core_tpu_torch`; the pyproject stanza the port reads is
`[tool.sctlint-torch]`).

- The 40 cases that build a fixture tree and lint it run on both packages
  (`[ref-...]` and `[port-...]`), each with the reference's assertions. The
  port's run also runs the reference's and holds every report that
  `run_analysis` returned equal, in order: each finding's rule, path, line,
  scope and message, the violations, the stale allowlist entries, the
  parse errors and the cache's hit and miss counts.
- The 12 cases that read the real tree, its allowlist, its command line or
  its `SCT_SANITIZE` check run on the port alone: the port's package is
  clean under its own allowlist with no stale entry, the C rules reach
  the port's apply engine from both kinds of GIL-released region, the
  footprint census a port `Application` registers equals the one the scan
  sees, and a typo'd sanitize mode fails the import of the port's
  `native`.

Tolerance: none.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mirror_harness import Mirror  # noqa: E402

FILE = "test_static_analysis.py"
# the port's engine reads its own pyproject stanza
PORT_SUBS = ((r"\[tool\.sctlint\]", "[tool.sctlint-torch]"),)


def _report(res) -> tuple:
    return (
        [(f.rule, f.path, f.line, f.qualname, f.message)
         for f in res.findings],
        [(f.rule, f.path, f.line) for f in res.violations],
        [(e.rule, e.path, e.qual, e.lineno) for e in res.stale_entries],
        list(res.parse_errors), res.cache_hits, res.cache_misses)


def _hook(side, pkg, mods, log):
    mod = mods[FILE]
    run = mod.run_analysis

    def recorded(*a, **kw):
        res = run(*a, **kw)
        log.append(_report(res))
        return res

    mod.run_analysis = recorded


MIRROR = Mirror((FILE,), hook=_hook, port_subs=PORT_SUBS)
# the cases that read the real tree (its allowlist, command line, native
# sources, Application and SCT_SANITIZE check): the port's tree for the port
REAL_TREE = ("test_package_is_clean_under_committed_allowlist",
             "test_real_tree_has_findings_behind_the_allowlist",
             "test_committed_allowlist_parses_and_every_entry_has_a_why",
             "test_cli_exit_codes",
             "test_changed_mode_restricts_per_module_rules",
             "test_real_tree_native_findings_behind_allowlist",
             "test_cli_native_flag",
             "test_unknown_sct_sanitize_value_fails_loudly",
             "test_b1_census_runtime_parity_drift_guard",
             "test_cli_json_output_roundtrip",
             "test_cli_list_covers_new_rules",
             "test_changed_mode_covers_new_rules_per_module")
TREE_CASES = MIRROR.cases(drop=REAL_TREE)
REAL_CASES = [c for c in MIRROR.cases() if c[1] in REAL_TREE]


def test_mirrors_every_case():
    assert len(TREE_CASES) == 40
    assert len(REAL_CASES) == len(REAL_TREE) == 12


def _run(side, case, tmp_path):
    d = tmp_path / side
    d.mkdir()
    return MIRROR.run(side, case, builtins={"tmp_path": d})


@pytest.mark.parametrize("case", TREE_CASES, ids=Mirror.case_id)
@pytest.mark.parametrize("side", ["ref", "port"])
def test_fixture_case(side, case, tmp_path):
    log = _run(side, case, tmp_path)
    if side == "port":
        assert log == _run("ref", case, tmp_path)


@pytest.mark.parametrize("case", REAL_CASES, ids=Mirror.case_id)
def test_real_tree_case_on_the_port(case, tmp_path):
    _run("port", case, tmp_path)
