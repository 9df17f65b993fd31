"""sctlint engine: file walking, allowlist, rule orchestration.

Copied from `stellar_core_tpu/analysis/engine.py` at commit 94afec1;
carry a fix in either copy to the other. Changed, in `default_config`
and the walk only (every rule, finding id and message is the
reference's):

- it lints `stellar_core_tpu_torch/` with the port's allowlist, fault
  registry and op-name table, and caches under the port's `build/`;
- its pyproject stanza is `[tool.sctlint-torch]`, so the reference's
  `[tool.sctlint]` (which names the reference's allowlist) never applies;
- a docs path may be a sequence of files, read as one text: the metric
  catalog is `docs/metrics.md` plus `docs/metrics-torch.md`, the metrics
  only the port registers;
- the C rules also read the CUDA sources of `csrc_dir` (`*.cu`, `*.cuh`)
  beside `native_dir`'s `*.c`.

The allowlist file (`stellar_core_tpu_torch/analysis/allowlist.txt`) is
the single place intentional exceptions live. One entry per line:

    RULE path[#qualname-prefix] -- justification

e.g.

    D1 stellar_core_tpu_torch/util/timer.py -- the clock abstraction itself

An entry suppresses every finding of RULE in that file (optionally
narrowed to functions whose qualname starts with the given prefix). A
justification is mandatory; an entry that matches nothing is STALE and
reported as an error — the allowlist can only shrink or be re-justified,
never rot. `--` and the em-dash `—` are both accepted separators.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

# a docs file, or several read as one text
DocsPath = Union[None, str, Sequence[str]]


@dataclass
class Finding:
    rule: str
    path: str        # repo-relative, posix separators
    line: int
    qualname: str    # enclosing def/class scope, "" at module level
    message: str

    def format(self) -> str:
        where = "%s:%d" % (self.path, self.line)
        if self.qualname:
            where += " (%s)" % self.qualname
        return "%s %s: %s" % (self.rule, where, self.message)


@dataclass
class AllowEntry:
    rule: str
    path: str
    qual: str                 # "" = whole file
    justification: str
    lineno: int
    matched: int = 0

    def covers(self, f: Finding) -> bool:
        return (f.rule == self.rule and f.path == self.path and
                (not self.qual or f.qualname.startswith(self.qual)))


@dataclass
class LintConfig:
    repo_root: str
    package_dir: str                     # absolute path to the package
    package_name: str
    allowlist_path: Optional[str]
    docs_metrics_path: DocsPath
    docs_robustness_path: DocsPath
    fault_registry: Optional[Set[str]]   # None = skip F1
    fault_registry_path: str = ""
    e1_dirs: Tuple[str, ...] = ("scp", "herder", "ledger", "bucket")
    enabled_rules: Tuple[str, ...] = ("D1", "D2", "T1", "E1", "F1", "M1",
                                      "S1", "FL1", "B1",
                                      "N1", "N2", "N3", "N4", "A1")
    # -- dataflow rules (S1/FL1/B1, flowrules.py) --------------------------
    s1_dirs: Tuple[str, ...] = ("scp", "herder", "ledger", "bucket",
                                "crypto", "history")
    fl1_dirs: Tuple[str, ...] = ("scp", "herder", "ledger")
    b1_root_classes: Tuple[str, ...] = ("Application", "Herder",
                                        "OverlayManager", "LedgerManager")
    # per-file facts/results cache under build/sctlint-cache; None (the
    # fixture default) disables caching entirely
    cache_dir: Optional[str] = None
    # -- C-side (N1-N4) and admin-surface (A1) extensions ------------------
    native_dir: Optional[str] = None     # *.c scanned here; None = skip N*
    csrc_dir: Optional[str] = None       # *.cu / *.cuh scanned here too
    docs_observability_path: DocsPath = None
    docs_admin_path: DocsPath = None     # None = skip A1
    command_handler_path: str = ""       # repo-relative .py with cmd_*
    bail_test_path: Optional[str] = None  # test tied to the N4 taxonomy
    op_type_names: Optional[Dict[int, str]] = None  # None = skip op check


@dataclass
class AnalysisResult:
    findings: List[Finding] = field(default_factory=list)   # pre-allowlist
    violations: List[Finding] = field(default_factory=list)  # post-allowlist
    stale_entries: List[AllowEntry] = field(default_factory=list)
    parse_errors: List[str] = field(default_factory=list)
    cache_hits: int = 0
    cache_misses: int = 0

    @property
    def ok(self) -> bool:
        return not self.violations and not self.stale_entries and \
            not self.parse_errors


_SEP_RE = re.compile(r"\s+(?:--|—)\s+")


def load_allowlist(path: str) -> List[AllowEntry]:
    entries: List[AllowEntry] = []
    with open(path, encoding="utf-8") as fh:
        for i, raw in enumerate(fh, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = _SEP_RE.split(line, maxsplit=1)
            if len(parts) != 2 or not parts[1].strip():
                raise ValueError(
                    "%s:%d: allowlist entry needs a justification "
                    "('RULE path -- why'): %r" % (path, i, line))
            head, justification = parts[0].split(), parts[1].strip()
            if len(head) != 2:
                raise ValueError(
                    "%s:%d: expected 'RULE path[#qual]', got %r"
                    % (path, i, parts[0]))
            rule, target = head
            fpath, _, qual = target.partition("#")
            entries.append(AllowEntry(rule, fpath, qual, justification, i))
    return entries


def _read(path: DocsPath) -> str:
    if path is not None and not isinstance(path, str):
        return "\n".join(_read(p) for p in path)
    if path is None or not os.path.exists(path):
        return ""
    with open(path, encoding="utf-8") as fh:
        return fh.read()


def default_config(repo_root: Optional[str] = None) -> LintConfig:
    if repo_root is None:
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    pkg = os.path.join(repo_root, "stellar_core_tpu_torch")
    docs = os.path.join(repo_root, "docs")
    # no fallback: if the registry import breaks, the lint run must die
    # loudly rather than silently dropping the F1 rule and printing
    # "clean" (fault_registry=None is only for fixture configs that
    # explicitly opt out of F1)
    from ..util.faults import KNOWN_SITES
    registry: Optional[Set[str]] = set(KNOWN_SITES)
    # same no-fallback stance as KNOWN_SITES: if the op-name table
    # import breaks, the lint run dies loudly rather than silently
    # skipping N4's op-type leg
    from ..ledger.apply_stats import OP_TYPE_NAMES
    cfg = LintConfig(
        repo_root=repo_root,
        package_dir=pkg,
        package_name="stellar_core_tpu_torch",
        allowlist_path=os.path.join(pkg, "analysis", "allowlist.txt"),
        docs_metrics_path=(os.path.join(docs, "metrics.md"),
                           os.path.join(docs, "metrics-torch.md")),
        docs_robustness_path=os.path.join(docs, "robustness.md"),
        fault_registry=registry,
        fault_registry_path="stellar_core_tpu_torch/util/faults.py",
        native_dir=os.path.join(pkg, "native"),
        csrc_dir=os.path.join(pkg, "csrc"),
        docs_observability_path=os.path.join(docs, "observability.md"),
        docs_admin_path=os.path.join(docs, "admin.md"),
        command_handler_path="stellar_core_tpu_torch/main/command_handler.py",
        bail_test_path=os.path.join(repo_root, "tests",
                                    "test_apply_cockpit.py"),
        op_type_names=dict(OP_TYPE_NAMES),
        cache_dir=os.path.join(pkg, "build", "sctlint-cache"),
    )
    _apply_pyproject(cfg)
    return cfg


def _apply_pyproject(cfg: LintConfig) -> None:
    """Honor a `[tool.sctlint-torch]` stanza in pyproject.toml (shared
    config home with `[tool.ruff]`, so one file drives both linters).

    Deliberately NOT tomllib: the stanza is defined as flat single-line
    `key = "value"` / `key = ["a", "b"]` entries and is parsed with the
    same simple scanner on every interpreter, so behavior can never
    diverge between py3.10 (no tomllib) and 3.11+. Anything the scanner
    can't read — multi-line arrays, nested tables — yields nothing for
    that key and the default stays: misparses FAIL SAFE to the full
    rule set, never to a weaker gate."""
    pp = os.path.join(cfg.repo_root, "pyproject.toml")
    if not os.path.exists(pp):
        return
    data: Dict[str, object] = {}
    in_stanza = False
    for line in _read(pp).splitlines():
        s = line.split("#", 1)[0].strip()
        if s.startswith("["):
            in_stanza = s == "[tool.sctlint-torch]"
            continue
        if in_stanza and "=" in s:
            k, _, v = s.partition("=")
            v = v.strip()
            if v.startswith("[") and v.endswith("]"):
                data[k.strip()] = [x.strip().strip("\"'")
                                  for x in v.strip("[]").split(",")
                                  if x.strip()]
            elif not v.startswith("["):
                data[k.strip()] = v.strip("\"'")
    if data.get("allowlist"):
        cfg.allowlist_path = os.path.join(cfg.repo_root,
                                          str(data["allowlist"]))
    # empty lists count as "not set": an empty rules list would make
    # the whole gate vacuously green
    if isinstance(data.get("rules"), list) and data["rules"]:
        cfg.enabled_rules = tuple(str(r) for r in data["rules"])
    if isinstance(data.get("e1-dirs"), list) and data["e1-dirs"]:
        cfg.e1_dirs = tuple(str(d) for d in data["e1-dirs"])
    if isinstance(data.get("s1-dirs"), list) and data["s1-dirs"]:
        cfg.s1_dirs = tuple(str(d) for d in data["s1-dirs"])
    if isinstance(data.get("fl1-dirs"), list) and data["fl1-dirs"]:
        cfg.fl1_dirs = tuple(str(d) for d in data["fl1-dirs"])


def _py_files(package_dir: str) -> List[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(package_dir):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "build")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


def _c_files(native_dir: Optional[str],
             suffixes: Tuple[str, ...] = (".c",)) -> List[str]:
    if native_dir is None or not os.path.isdir(native_dir):
        return []
    out = []
    for dirpath, dirnames, filenames in os.walk(native_dir):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "build")]
        for fn in sorted(filenames):
            if fn.endswith(suffixes):
                out.append(os.path.join(dirpath, fn))
    return out


def _config_digest(cfg: LintConfig) -> str:
    """Every knob that can change a PER-FILE verdict, folded into the
    cache key (tree-wide rules re-run every time anyway)."""
    import hashlib
    blob = repr((cfg.enabled_rules, cfg.e1_dirs, cfg.s1_dirs,
                 cfg.fl1_dirs, cfg.package_name))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def _per_module_findings(cfg: LintConfig, facts, flow) -> List[Finding]:
    """The per-module (cacheable) Python rules for one file."""
    from . import flowrules as FR
    from . import rules as R
    out: List[Finding] = []
    if "D1" in cfg.enabled_rules:
        out.extend(R.rule_d1_wallclock(facts))
    if "D2" in cfg.enabled_rules:
        out.extend(R.rule_d2_randomness(facts))
    if "E1" in cfg.enabled_rules:
        out.extend(R.rule_e1_swallow(facts, cfg.e1_dirs,
                                     cfg.package_name))
    if "S1" in cfg.enabled_rules:
        out.extend(FR.rule_s1_set_order(flow, cfg.s1_dirs,
                                        cfg.package_name))
    if "FL1" in cfg.enabled_rules:
        out.extend(FR.rule_fl1_float(flow, cfg.fl1_dirs,
                                     cfg.package_name))
    return out


def run_analysis(config: Optional[LintConfig] = None,
                 files: Optional[Sequence[str]] = None) -> AnalysisResult:
    """Run every enabled rule. `files` (absolute or repo-relative)
    restricts the per-module rules (D1/D2/E1/S1/FL1 for .py, N1/N2/N3
    for .c) to those files — the `--changed` fast path; tree-wide rules
    (T1/F1/M1/B1/N4/A1) always scan the whole package, since their
    facts are cross-module (and cross-language). Per-file parsing and
    per-module findings are served from the content-addressed cache
    (cache.py) when `cfg.cache_dir` is set."""
    from . import crules as C
    from . import flowrules as FR
    from . import rules as R
    from .cache import SctlintCache

    cfg = config or default_config()
    res = AnalysisResult()
    cache = SctlintCache(cfg.cache_dir, _config_digest(cfg))

    all_paths = _py_files(cfg.package_dir)
    facts_by_path: Dict[str, "R.ModuleFacts"] = {}
    flow_by_path: Dict[str, "FR.FlowFacts"] = {}
    findings_by_path: Dict[str, List[Finding]] = {}
    for abspath in all_paths:
        rel = os.path.relpath(abspath, cfg.repo_root).replace(os.sep, "/")
        with open(abspath, "rb") as fh:
            data = fh.read()
        key = cache.key_for(rel, data)
        entry = cache.get(key)
        if entry is None:
            try:
                tree = ast.parse(data.decode("utf-8"), filename=rel)
            except (SyntaxError, UnicodeDecodeError) as e:
                res.parse_errors.append("%s: %s" % (rel, e))
                continue
            facts = R.ModuleFacts(rel, tree)
            flow = FR.FlowFacts(rel, tree)
            perfile = _per_module_findings(cfg, facts, flow)
            cache.put(key, (facts, flow, perfile))
        else:
            facts, flow, perfile = entry
        facts_by_path[rel] = facts
        flow_by_path[rel] = flow
        findings_by_path[rel] = perfile

    n_rules_on = any(r in cfg.enabled_rules
                     for r in ("N1", "N2", "N3", "N4"))
    cfacts_by_path: Dict[str, "C.CFileFacts"] = {}
    if n_rules_on:
        for abspath in _c_files(cfg.native_dir) + _c_files(
                cfg.csrc_dir, (".cu", ".cuh")):
            rel = os.path.relpath(abspath, cfg.repo_root) \
                .replace(os.sep, "/")
            with open(abspath, "rb") as fh:
                data = fh.read()
            key = cache.key_for(rel, data)
            entry = cache.get(key)
            if entry is None:
                try:
                    cfacts = C.CFileFacts(rel, data.decode("utf-8"))
                except ValueError as e:
                    res.parse_errors.append("%s: %s" % (rel, e))
                    continue
                cper: List[Finding] = []
                if "N1" in cfg.enabled_rules:
                    cper.extend(C.rule_n1_nogil_python(cfacts))
                if "N2" in cfg.enabled_rules:
                    cper.extend(C.rule_n2_alloc_discipline(cfacts))
                if "N3" in cfg.enabled_rules:
                    cper.extend(C.rule_n3_lock_balance(cfacts))
                cache.put(key, (cfacts, cper))
            else:
                cfacts, cper = entry
            cfacts_by_path[rel] = cfacts
            findings_by_path[rel] = cper

    restrict: Optional[Set[str]] = None
    if files is not None:
        restrict = set()
        for f in files:
            a = f if os.path.isabs(f) else os.path.join(cfg.repo_root, f)
            restrict.add(os.path.relpath(a, cfg.repo_root)
                         .replace(os.sep, "/"))

    all_facts = list(facts_by_path.values())
    all_flow = list(flow_by_path.values())
    for rel in sorted(findings_by_path):
        if restrict is not None and rel not in restrict:
            continue
        res.findings.extend(findings_by_path[rel])

    if "B1" in cfg.enabled_rules:
        res.findings.extend(FR.rule_b1_bounded_structs(
            all_flow, cfg.b1_root_classes,
            "%s/util/footprint.py" % cfg.package_name))
    if "T1" in cfg.enabled_rules:
        res.findings.extend(R.rule_t1_thread_discipline(all_facts))
    if "F1" in cfg.enabled_rules and cfg.fault_registry is not None:
        res.findings.extend(R.rule_f1_fault_sites(
            all_facts, set(cfg.fault_registry), cfg.fault_registry_path,
            _read(cfg.docs_robustness_path), "docs/robustness.md"))
    if "M1" in cfg.enabled_rules:
        res.findings.extend(R.rule_m1_metric_catalog(
            all_facts, _read(cfg.docs_metrics_path), "docs/metrics.md"))
    if "N4" in cfg.enabled_rules and cfacts_by_path:
        py_bails = [(facts.path, line, reason, qual)
                    for facts in all_facts
                    for (line, reason, qual) in facts.bail_literals]
        res.findings.extend(C.rule_n4_cross_boundary(
            [cfacts_by_path[k] for k in sorted(cfacts_by_path)],
            py_bails,
            _read(cfg.docs_observability_path), "docs/observability.md",
            _read(cfg.docs_metrics_path), "docs/metrics.md",
            _read(cfg.bail_test_path) if cfg.bail_test_path else None,
            "tests/test_apply_cockpit.py",
            cfg.op_type_names))
    if "A1" in cfg.enabled_rules and cfg.docs_admin_path:
        # a MISSING admin doc reads as "" and flags every handler —
        # fail-safe, same stance as M1's missing metrics catalog
        # (docs_admin_path=None is the explicit fixture opt-out)
        res.findings.extend(R.rule_a1_admin_endpoints(
            all_facts, cfg.command_handler_path,
            _read(cfg.docs_admin_path), "docs/admin.md"))

    entries: List[AllowEntry] = []
    if cfg.allowlist_path and os.path.exists(cfg.allowlist_path):
        entries = load_allowlist(cfg.allowlist_path)

    for f in res.findings:
        covered = False
        for e in entries:
            if e.covers(f):
                e.matched += 1
                covered = True
        if not covered:
            res.violations.append(f)

    # stale entries only meaningful on full-tree runs with their rule
    # enabled: a --changed run that skipped a file (or an M1-only run)
    # must not flag unrelated entries as stale
    if restrict is None:
        res.stale_entries = [e for e in entries
                             if e.matched == 0 and
                             e.rule in cfg.enabled_rules]
    res.cache_hits = cache.hits
    res.cache_misses = cache.misses
    cache.prune()
    return res
