"""sctlint CLI: `python -m stellar_core_tpu_torch.analysis [options]
[files...]`, over the port's package with the port's allowlist.

Copied from `stellar_core_tpu/analysis/__main__.py` at commit 94afec1;
carry a fix in either copy to the other. Changed: `--changed` and
`--native` also take the CUDA sources (`.cu`, `.cuh`), which the port's
C rules read; the reference's `tools/sctlint` wrapper has no port twin.

Exit status: 0 clean, 1 violations/stale allowlist entries, 2 usage or
parse errors — CI-gate friendly.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from .engine import default_config, run_analysis


# the sources the rules read: Python, and C (the CUDA sources too)
_C_SUFFIXES = (".c", ".cu", ".cuh")
_SUFFIXES = (".py",) + _C_SUFFIXES


def _changed_files(repo_root: str) -> list:
    """Working-tree .py, .c, .cu and .cuh files changed vs HEAD, plus
    untracked ones — the native sources ride the same pre-commit fast
    path as the Python ones."""
    def git(*args):
        r = subprocess.run(["git", "-C", repo_root] + list(args),
                           capture_output=True, text=True)
        return r.stdout.splitlines() if r.returncode == 0 else []

    names = set(git("diff", "--name-only", "HEAD")) | \
        set(git("ls-files", "--others", "--exclude-standard"))
    return sorted(n for n in names if n.endswith(_SUFFIXES))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="sctlint",
        description="Determinism & thread-discipline analyzer: Python "
                    "rules D1/D2/T1/E1/F1/M1, native C rules N1-N4, "
                    "admin-surface rule A1 — docs/static-analysis.md")
    ap.add_argument("files", nargs="*",
                    help="restrict per-module rules to these .py/.c/.cu "
                         "files (default: whole package)")
    ap.add_argument("--changed", action="store_true",
                    help="lint only .py/.c/.cu files changed vs HEAD "
                         "(plus untracked)")
    ap.add_argument("--native", action="store_true",
                    help="run only the native C rules (N1-N4) over "
                         "native/*.c and csrc/*.cu(h) — the fast pre-commit gate for "
                         "engine changes")
    ap.add_argument("--repo-root", default=None)
    ap.add_argument("--list", action="store_true", dest="list_all",
                    help="print every finding (all rules, N/A ones "
                         "included) before allowlist filtering")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit one machine-readable JSON object "
                         "(findings, violations, stale entries, cache "
                         "counters) instead of the human lines; exit "
                         "codes unchanged")
    ap.add_argument("--no-cache", action="store_true",
                    help="bypass the build/sctlint-cache facts cache "
                         "(forces a full re-parse)")
    args = ap.parse_args(argv)

    cfg = default_config(args.repo_root)
    if args.no_cache:
        cfg.cache_dir = None
    if args.native:
        cfg.enabled_rules = tuple(
            r for r in cfg.enabled_rules if r.startswith("N"))
        if not cfg.enabled_rules:
            print("sctlint: --native but no N rules enabled "
                  "(pyproject [tool.sctlint] rules)")
            return 2
    files = args.files or None
    if args.changed:
        files = _changed_files(cfg.repo_root)
        if args.native:
            files = [f for f in files if f.endswith(_C_SUFFIXES)]
        if not files:
            print("sctlint: no changed files")
            return 0

    res = run_analysis(cfg, files=files)

    if args.as_json:
        def row(f):
            return {"rule": f.rule, "path": f.path, "line": f.line,
                    "qualname": f.qualname, "message": f.message}
        print(json.dumps({
            "ok": res.ok,
            "findings": [row(f) for f in res.findings],
            "violations": [row(f) for f in res.violations],
            "parse_errors": list(res.parse_errors),
            "stale_entries": [
                {"rule": e.rule, "path": e.path, "qual": e.qual,
                 "lineno": e.lineno} for e in res.stale_entries],
            "cache": {"hits": res.cache_hits,
                      "misses": res.cache_misses},
        }, indent=2, sort_keys=True))
        if res.parse_errors:
            return 2
        return 0 if res.ok else 1

    if args.list_all:
        for f in res.findings:
            print(f.format())
        print("-- %d finding(s) before allowlist --" % len(res.findings))

    for err in res.parse_errors:
        print("PARSE-ERROR %s" % err)
    for f in res.violations:
        print(f.format())
    for e in res.stale_entries:
        print("STALE-ALLOWLIST %s:%d: '%s %s%s' matched no finding — "
              "remove or fix the entry"
              % (cfg.allowlist_path, e.lineno, e.rule, e.path,
                 ("#" + e.qual) if e.qual else ""))

    if res.parse_errors:
        return 2
    if res.violations or res.stale_entries:
        print("sctlint: %d violation(s), %d stale allowlist entr(ies)"
              % (len(res.violations), len(res.stale_entries)))
        return 1
    scope = "%d file(s)" % len(files) if files else "whole package"
    print("sctlint: clean (%s; %d finding(s) allowlisted)"
          % (scope, len(res.findings) - len(res.violations)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
