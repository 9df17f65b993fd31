"""The port's lint engine (`stellar_core_tpu_torch/analysis/`) over the port,
and held against the reference's engine.

- The port's package is clean under the reference's allowlist for the
  rules that read Python sources alone: D1 (wall clock outside the clock
  abstraction), D2 (unseeded randomness), T1 (threads), E1 (swallowed
  exceptions in consensus code), S1 (set order feeding consensus) and FL1
  (floats in consensus code). That allowlist is the reference's
  (`stellar_core_tpu/analysis/allowlist.txt`), each entry's path
  rewritten to the port's copy of the file, and it equals the port's
  committed allowlist entry for entry: the port leaves out no allowlisted
  code, and allows nothing the reference does not.
- A differential: both engines lint the same trees, and their reports are
  equal finding for finding (rule, path, line, scope, message), with the
  violations, the stale allowlist entries and the parse errors. The
  trees are the reference's own package under the reference's
  configuration (the port's engine gets the same configuration, the
  reference's fault registry and op-name table handed over as data), and
  fixture trees made from a seed, each with one violation of each of the
  14 rules (names, variants, padding lines and file places drawn from the
  seed), whose report must name every rule.

Tolerance: none.
"""

import dataclasses
import os
import re
import textwrap

import numpy as np
import pytest

from stellar_core_tpu.analysis import engine as RE
from stellar_core_tpu_torch.analysis import engine as PE
from stellar_core_tpu_torch.analysis.engine import LintConfig, run_analysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = ("D1", "D2", "T1", "E1", "S1", "FL1")
ALL_RULES = ("D1", "D2", "T1", "E1", "F1", "M1", "S1", "FL1", "B1",
             "N1", "N2", "N3", "N4", "A1")


def defines(path, qual) -> bool:
    """Whether the file at `path` defines the last name of `qual` (a C
    file: names it as a function at the start of a line's declaration)."""
    name = re.escape(qual.split(".")[-1])
    pattern = (r"(?m)^\s*(def|class)\s+%s\b" if path.endswith(".py")
               else r"(?m)^\w[\w\s\*]*\b%s\s*\(") % name
    with open(path, encoding="utf-8") as fh:
        return re.search(pattern, fh.read()) is not None


def mapped_reference_allowlist(rules=None) -> list:
    """The reference's allowlist entries (for `rules`, or all), each
    pointed at the port's copy of its file, kept where the port has the
    file and, for an entry that names a function or class, defines it."""
    with open(os.path.join(REPO, "stellar_core_tpu", "analysis",
                           "allowlist.txt"), encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    kept = []
    for line in lines:
        m = re.match(r"(\S+)\s+stellar_core_tpu/(\S+?)(#\S+)?\s+(--|—)\s",
                     line.strip())
        if m is None or (rules is not None and m.group(1) not in rules):
            continue
        port = os.path.join(REPO, "stellar_core_tpu_torch", m.group(2))
        if os.path.exists(port) and (m.group(3) is None or defines(
                port, m.group(3)[1:])):
            kept.append(line.strip().replace(
                "stellar_core_tpu/", "stellar_core_tpu_torch/", 1))
    return kept


def _entries(path) -> list:
    return [(e.rule, e.path, e.qual, e.justification)
            for e in PE.load_allowlist(path)]


def test_port_is_clean_under_the_reference_allowlist(tmp_path):
    allow = tmp_path / "allowlist.txt"
    kept = mapped_reference_allowlist(RULES)
    assert len(kept) > 10
    allow.write_text("\n".join(kept) + "\n")
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
    # reference
    assert any(f.path == "stellar_core_tpu_torch/util/slot_timeline.py"
               for f in res.findings)
    # the overlay's reactor thread and keyed short hash, allowlisted as in
    # the reference
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
    # the port's committed allowlist is the reference's, pointed at the
    # port, every entry of every rule kept
    full = tmp_path / "full.txt"
    full.write_text("\n".join(mapped_reference_allowlist()) + "\n")
    port_cfg = PE.default_config()
    assert _entries(port_cfg.allowlist_path) == _entries(str(full))
    assert len(_entries(str(full))) == len(RE.load_allowlist(
        RE.default_config().allowlist_path))


# -- the differential --------------------------------------------------------


def report(res) -> dict:
    return {
        "findings": [(f.rule, f.path, f.line, f.qualname, f.message)
                     for f in res.findings],
        "violations": [(f.rule, f.path, f.line) for f in res.violations],
        "stale": [(e.rule, e.path, e.qual, e.lineno)
                  for e in res.stale_entries],
        "parse_errors": list(res.parse_errors),
    }


def both_reports(kw: dict) -> tuple:
    """Each engine's report of one configuration, given as the keyword
    arguments of both packages' `LintConfig`."""
    return (report(RE.run_analysis(RE.LintConfig(**kw))),
            report(PE.run_analysis(PE.LintConfig(**kw))))


def test_engines_agree_on_the_reference_tree():
    ref_cfg = RE.default_config()
    ref_cfg.cache_dir = None
    kw = dataclasses.asdict(ref_cfg)
    ref, port = both_reports(kw)
    assert ref["findings"] and not ref["violations"]
    assert {f[0] for f in ref["findings"]} >= {"D1", "D2", "FL1", "N2"}
    assert port == ref


_LETTERS = list("abcdefghijklmnopqrstuvwxyz")


class _Draw:
    def __init__(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)
        self.used = set()

    def name(self, prefix: str) -> str:
        while True:
            n = "%s_%s" % (prefix, "".join(self.rng.choice(_LETTERS, 5)))
            if n not in self.used:
                self.used.add(n)
                return n

    def pick(self, options):
        return options[int(self.rng.integers(len(options)))]

    def pad(self) -> str:
        """0-3 filler functions, so each violation's line is drawn too."""
        return "".join("def %s():\n    return %d\n\n\n"
                       % (self.name("_pad"), int(self.rng.integers(100)))
                       for _ in range(int(self.rng.integers(4))))


def seeded_fixture(root, seed: int) -> dict:
    """Write a fixture repo under `root` with one violation of each rule
    of ALL_RULES; return the `LintConfig` keyword arguments that lint it."""
    d = _Draw(seed)
    py = {}
    c = {}

    clock_imp, clock_call = d.pick([
        ("import time", "time.time()"), ("import time", "time.monotonic()"),
        ("from time import perf_counter", "perf_counter()"),
        ("import datetime", "datetime.datetime.now()")])
    py["%s/%s.py" % (d.pick(["overlay", "util", "main"]),
                     d.name("clock"))] = \
        "%s\n\n\n%sdef %s():\n    return %s\n" % (
            clock_imp, d.pad(), d.name("stamp"), clock_call)

    rnd_imp, rnd_call = d.pick([
        ("import random", "random.randint(1, 6)"),
        ("import random", "random.Random()"),
        ("import os", "os.urandom(32)")])
    py["util/%s.py" % d.name("roll")] = \
        "%s\n\n\n%sdef %s():\n    return %s\n" % (
            rnd_imp, d.pad(), d.name("draw"), rnd_call)

    py["%s/%s.py" % (d.pick(["scp", "herder", "ledger", "bucket"]),
                     d.name("swallow"))] = (
        "%sdef %s(g):\n    try:\n        g()\n    except %s:\n"
        "        pass\n" % (d.pad(), d.name("quiet"),
                            d.pick(["Exception", "BaseException"])))

    marked, relay = d.name("apply"), d.name("relay")
    lm = d.name("lm")
    py["ledger/%s.py" % lm] = (
        "from ..util.threads import main_thread_only\n\n\n%s"
        "@main_thread_only\ndef %s(x):\n    return x\n\n\n"
        "def %s(x):\n    return %s(x)\n" % (d.pad(), marked, relay, marked))
    spawn = d.pick(["threading.Thread(target=lambda: %s(x)).start()",
                    "spawn_worker(\"w\", lambda: %s(x))"]) % relay
    py["overlay/%s.py" % d.name("worker")] = (
        "import threading\n\nfrom ..ledger.%s import %s\n"
        "from ..util.threads import spawn_worker\n\n\n%s"
        "def %s(x):\n    %s\n" % (lm, relay, d.pad(), d.name("start"),
                                  spawn))

    typo = "%s.%s" % (d.pick(["overlay", "archive", "device"]),
                      d.name("typo").replace("_", "-"))
    py["overlay/%s.py" % d.name("faulty")] = (
        "%sdef %s(faults):\n    if faults.should_fire(%r):\n        return\n"
        "    faults.fire_point(\"device.dispatch\")\n"
        % (d.pad(), d.name("maybe"), typo))

    known = "overlay.%s" % d.name("known").replace("_", "-")
    ghost = "ledger.%s" % d.name("ghost").replace("_", "-")
    py["util/%s.py" % d.name("meters")] = (
        "%sdef %s(metrics):\n    metrics.new_meter(%r).mark()\n"
        "    metrics.%s(%r)\n" % (d.pad(), d.name("record"), known,
                                  d.pick(["new_timer", "new_counter",
                                          "new_histogram"]), ghost))

    py["scp/%s.py" % d.name("nominate")] = (
        "%sdef %s(nodes):\n    cand = {n.id for n in nodes}\n    out = []\n"
        "    for c in cand:\n        out.append(c)\n    return out\n"
        % (d.pad(), d.name("leaders")))

    py["ledger/%s.py" % d.name("fees")] = (
        "%sdef %s(fee, ops):\n    return fee / max(1, ops)\n"
        % (d.pad(), d.name("rate")))

    thing, attr = d.name("Thing"), d.name("items")
    py["main/app.py"] = (
        "from ..sub.things import %s\n\n\nclass Application:\n"
        "    def __init__(self):\n        self.thing = %s()\n"
        % (thing, thing))
    py["sub/things.py"] = (
        "class %s:\n    def __init__(self):\n        self.%s = {}\n\n"
        "    def on_message(self, k, v):\n        self.%s[k] = v\n"
        % (thing, attr, attr))

    cmd = d.name("cmd_ghost")
    py["main/command_handler.py"] = (
        "class CommandHandler:\n    def cmd_info(self, params):\n"
        "        return {}\n\n    def %s(self, params):\n"
        "        return {}\n" % cmd)

    helper, worker, hot = d.name("helper"), d.name("worker"), d.name("op")
    reason = d.name("mystery").replace("_", "-")
    c["eng.c"] = (
        "#include <Python.h>\n#include <pthread.h>\n#include <stdlib.h>\n\n"
        "typedef struct { int x; } Ctx;\n"
        "static pthread_mutex_t MU = PTHREAD_MUTEX_INITIALIZER;\n\n"
        "static void ctx_bail(Ctx *c, const char *m) { c->x = 1; }\n\n"
        "static void %s(void *p) {\n"
        "    PyErr_SetString(PyExc_RuntimeError, \"boom\");\n}\n\n"
        "static int %s(void *env) {\n    char *buf = %s;\n"
        "    return buf != 0;\n}\n\n"
        "static void *%s(void *arg) {\n    %s(arg);\n    %s(arg);\n"
        "    return 0;\n}\n\n"
        "static void spawn(void) {\n    pthread_t t;\n"
        "    pthread_create(&t, 0, %s, 0);\n}\n\n"
        "static int %s(int *q) {\n    pthread_mutex_lock(&MU);\n"
        "    if (!*q) {\n        return -1;\n    }\n"
        "    pthread_mutex_unlock(&MU);\n    return 0;\n}\n\n"
        "static void parse(Ctx *c) {\n    ctx_bail(c, \"%s\");\n"
        "    ctx_bail(c, \"prefetch-miss\");\n}\n"
        % (helper, hot, d.pick(["malloc(64)", "calloc(8, 8)"]), worker,
           helper, hot, worker, d.name("pop"), reason))

    pkg = os.path.join(str(root), "fakepkg")
    for rel, src in py.items():
        path = os.path.join(pkg, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(src)
        init = os.path.join(os.path.dirname(path), "__init__.py")
        if not os.path.exists(init):
            open(init, "w").close()
    os.makedirs(os.path.join(pkg, "native"), exist_ok=True)
    for name, src in c.items():
        with open(os.path.join(pkg, "native", name), "w") as fh:
            fh.write(textwrap.dedent(src))
    docs = os.path.join(str(root), "docs")
    os.makedirs(docs, exist_ok=True)
    texts = {
        "robustness.md": "site catalog: `device.dispatch`\n",
        "metrics.md": "| `%s` | meter |\n" % known,
        "observability.md": "### Native bail taxonomy\n\n"
                            "| reason | origin | meaning |\n|---|---|---|\n"
                            "| `prefetch-miss` | C | worker miss |\n",
        "admin.md": "| Endpoint | Purpose |\n|---|---|\n"
                    "| `info` | Node summary |\n",
    }
    for name, text in texts.items():
        with open(os.path.join(docs, name), "w") as fh:
            fh.write(text)
    return dict(
        repo_root=str(root), package_dir=pkg, package_name="fakepkg",
        allowlist_path=None,
        docs_metrics_path=os.path.join(docs, "metrics.md"),
        docs_robustness_path=os.path.join(docs, "robustness.md"),
        fault_registry={"device.dispatch"},
        fault_registry_path="fakepkg/util/faults.py",
        native_dir=os.path.join(pkg, "native"),
        docs_observability_path=os.path.join(docs, "observability.md"),
        docs_admin_path=os.path.join(docs, "admin.md"),
        command_handler_path="fakepkg/main/command_handler.py")


@pytest.mark.parametrize("seed", range(6))
def test_engines_agree_on_seeded_fixtures(tmp_path, seed):
    ref, port = both_reports(seeded_fixture(tmp_path, seed))
    assert port == ref
    # one violation of each rule, each found
    assert sorted({v[0] for v in ref["violations"]}) == sorted(ALL_RULES)
    assert ref["parse_errors"] == [] and ref["stale"] == []
