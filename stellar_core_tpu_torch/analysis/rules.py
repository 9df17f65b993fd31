"""Rule implementations for sctlint (see package docstring for the
rule catalog).

Copied from `stellar_core_tpu/analysis/rules.py` at commit a6220d9;
carry a fix in either copy to the other. Nothing is changed but this
header and one comment's tracker reference.

Two phases: `ModuleFacts` is a single AST walk per module collecting
everything every rule needs (clock reads, randomness, except-pass
handlers, fault-site literals, metric literals, function defs + their
direct calls, thread entry points, `@main_thread_only` marks); the
`rule_*` functions then turn facts — some per-module, some whole-tree
(T1's call-graph walk, F1/M1's registry and doc cross-checks) — into
findings.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .engine import Finding

# clock-reading attributes on the `time` module (time.sleep is a pacing
# call, not a clock read — the VirtualClock contract covers scheduling
# separately)
_TIME_READS = {"time", "monotonic", "perf_counter", "perf_counter_ns",
               "monotonic_ns", "time_ns", "process_time", "clock"}
_DATETIME_READS = {"now", "utcnow", "today", "fromtimestamp"}
# random-module attributes that are NOT the unseeded global stream
_RANDOM_OK = {"Random", "SystemRandom", "seed"}
_METRIC_CALLS = {"new_counter", "new_gauge", "new_meter", "new_timer",
                 "new_histogram"}
_FAULT_CALLS = {"should_fire", "fire_point"}

# method names too generic to follow across objects in the T1 walk:
# `tmp.close()` / `sock.send()` / `thread.start()` resolving by bare
# name into unrelated package defs produced chains like
# `_cc_build -> close -> remove_transport -> ... -> recv_scp_envelope`.
# A name on this list is still followed for `self.X()` / bare `X()`
# calls (same-module resolution), and a *marked* function name always
# triggers regardless — the stoplist only prunes cross-object breadth.
_GENERIC_ATTRS = {
    "close", "send", "sendall", "recv", "accept", "connect", "start",
    "stop", "run", "join", "wake", "write", "read", "flush", "commit",
    "rollback", "execute", "executemany", "fetchone", "fetchall",
    "get", "put", "pop", "append", "appendleft", "popleft", "add",
    "remove", "discard", "clear", "update", "set", "setdefault",
    "cancel", "acquire", "release", "submit", "shutdown", "mark",
    "result", "done", "items", "keys", "values", "copy", "extend",
    "sort", "split", "strip", "encode", "decode", "hex", "digest",
    "info", "debug", "warning", "error", "exception", "sleep", "wait",
    "notify", "unlink", "exists", "makedirs",
}


class FuncInfo:
    """One function/method def: identity plus its DIRECT calls (nested
    defs are separate FuncInfos — their bodies run on whatever thread
    eventually calls them, not on their parent's). Calls are
    (kind, name) with kind `bare` (f()), `self` (self.f()) or `attr`
    (obj.f()) — resolution precision differs per kind."""

    __slots__ = ("path", "qualname", "name", "line", "calls", "marked")

    def __init__(self, path: str, qualname: str, name: str,
                 line: int) -> None:
        self.path = path
        self.qualname = qualname
        self.name = name
        self.line = line
        self.calls: Set[Tuple[str, str]] = set()
        self.marked = False            # @main_thread_only


class ThreadEntry:
    """A function handed to a worker: Thread(target=X) / executor.submit(X).
    `func_name` resolves against FuncInfo names; for lambdas the calls
    are inlined."""

    __slots__ = ("path", "line", "func_kind", "func_name", "inline_calls",
                 "via")

    def __init__(self, path: str, line: int, func_kind: str,
                 func_name: Optional[str],
                 inline_calls: Optional[Set[Tuple[str, str]]],
                 via: str) -> None:
        self.path = path
        self.line = line
        self.func_kind = func_kind
        self.func_name = func_name
        self.inline_calls = inline_calls or set()
        self.via = via


class ModuleFacts(ast.NodeVisitor):
    """Single-pass fact collector for one module."""

    def __init__(self, path: str, tree: ast.AST) -> None:
        self.path = path
        # import bindings: local name -> canonical ("time", "datetime",
        # "random", "os") for module imports; ("time", "perf_counter")
        # style tuples for from-imports of flagged names
        self.module_alias: Dict[str, str] = {}
        self.from_bind: Dict[str, Tuple[str, str]] = {}

        self.imported_names: Set[str] = set()

        self.clock_uses: List[Tuple[int, str, str]] = []   # line, expr, qual
        self.random_uses: List[Tuple[int, str, str]] = []
        self.except_passes: List[Tuple[int, str, str]] = []  # line, kind, qual
        self.fault_literals: List[Tuple[int, str, str]] = []  # line, site, qual
        self.metric_literals: List[Tuple[int, str, str]] = []  # line, name, qual
        self.bail_literals: List[Tuple[int, str, str]] = []  # line, reason, qual
        self.functions: List[FuncInfo] = []
        self.thread_entries: List[ThreadEntry] = []

        self._scope: List[str] = []      # qualname stack (defs + classes)
        self._func_stack: List[FuncInfo] = []
        self.visit(tree)

    # -- scope bookkeeping ---------------------------------------------------
    def _qual(self) -> str:
        return ".".join(self._scope)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    def _visit_func(self, node) -> None:
        self._scope.append(node.name)
        fi = FuncInfo(self.path, self._qual(), node.name, node.lineno)
        for dec in node.decorator_list:
            dn = dec.func if isinstance(dec, ast.Call) else dec
            name = dn.attr if isinstance(dn, ast.Attribute) else (
                dn.id if isinstance(dn, ast.Name) else None)
            if name == "main_thread_only":
                fi.marked = True
        self.functions.append(fi)
        self._func_stack.append(fi)
        self.generic_visit(node)
        self._func_stack.pop()
        self._scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- imports -------------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            root = a.name.split(".")[0]
            if root in ("time", "datetime", "random", "os"):
                self.module_alias[a.asname or root] = root

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module in ("time", "datetime", "random", "os"):
            for a in node.names:
                self.from_bind[a.asname or a.name] = (node.module, a.name)
        else:
            # any other from-import: a bare call of this name may target
            # a def in another package module (T1 resolution)
            for a in node.names:
                self.imported_names.add(a.asname or a.name)

    # -- expression-level facts ----------------------------------------------
    def _root_module(self, node) -> Optional[str]:
        """Canonical module of an attribute chain's root Name, walking
        through `datetime.datetime.now` style nesting."""
        while isinstance(node, ast.Attribute):
            node = node.value
        if isinstance(node, ast.Name):
            return self.module_alias.get(node.id)
        return None

    def visit_Attribute(self, node: ast.Attribute) -> None:
        mod = self._root_module(node.value)
        if mod == "time" and node.attr in _TIME_READS:
            self.clock_uses.append(
                (node.lineno, "time.%s" % node.attr, self._qual()))
        elif mod == "datetime" and node.attr in _DATETIME_READS:
            self.clock_uses.append(
                (node.lineno, "datetime.%s" % node.attr, self._qual()))
        elif mod == "random" and node.attr not in _RANDOM_OK:
            self.random_uses.append(
                (node.lineno, "random.%s" % node.attr, self._qual()))
        elif mod == "os" and node.attr == "urandom":
            self.random_uses.append(
                (node.lineno, "os.urandom", self._qual()))
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load):
            bind = self.from_bind.get(node.id)
            if bind is not None:
                mod, orig = bind
                if mod == "time" and orig in _TIME_READS:
                    self.clock_uses.append(
                        (node.lineno, "time.%s" % orig, self._qual()))
                elif mod == "datetime" and orig in ("datetime", "date"):
                    pass  # class reference; .now/.today caught via Attribute
                elif mod == "random" and orig not in _RANDOM_OK:
                    self.random_uses.append(
                        (node.lineno, "random.%s" % orig, self._qual()))
                elif mod == "os" and orig == "urandom":
                    self.random_uses.append(
                        (node.lineno, "os.urandom", self._qual()))

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        attr = fn.attr if isinstance(fn, ast.Attribute) else None
        name = fn.id if isinstance(fn, ast.Name) else None
        callee = attr or name

        # argless random.Random() / Random() from-import = unseeded
        if callee == "Random" and not node.args and not node.keywords:
            mod = self._root_module(fn.value) if attr else \
                self.from_bind.get(name, (None,))[0]
            if mod == "random":
                self.random_uses.append(
                    (node.lineno, "random.Random()", self._qual()))

        # datetime.datetime.now() handled by visit_Attribute; from-import
        # `datetime` class: datetime.now() is Attribute(value=Name) where
        # Name binds ("datetime","datetime")
        if attr in _DATETIME_READS and isinstance(fn.value, ast.Name):
            bind = self.from_bind.get(fn.value.id)
            if bind is not None and bind[0] == "datetime":
                self.clock_uses.append(
                    (node.lineno, "%s.%s" % (bind[1], attr), self._qual()))

        # fault-site literals
        if callee in _FAULT_CALLS and node.args:
            a = node.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                self.fault_literals.append(
                    (node.lineno, a.value, self._qual()))
        elif callee == "check_faults" and len(node.args) >= 2:
            a = node.args[1]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                self.fault_literals.append(
                    (node.lineno, a.value, self._qual()))
        elif callee == "_fire" and node.args:
            # ChaosTransport._fire composes site_prefix + "." + site;
            # the default (and only) prefix is "overlay"
            a = node.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                self.fault_literals.append(
                    (node.lineno, "overlay." + a.value, self._qual()))

        # native-bail classification literals (N4's Python side):
        # `_bail(stats, "reason")` gates in ledger/native_apply.py and
        # direct `record_bail("reason")` calls
        if callee == "_bail" and len(node.args) >= 2:
            a = node.args[1]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                self.bail_literals.append(
                    (node.lineno, a.value, self._qual()))
        elif callee == "record_bail" and node.args:
            a = node.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                self.bail_literals.append(
                    (node.lineno, a.value, self._qual()))

        # metric registrations
        if callee in _METRIC_CALLS and node.args:
            lit = _literal_prefix(node.args[0])
            if lit is not None:
                self.metric_literals.append(
                    (node.lineno, lit, self._qual()))
        # footprint-census registrations: a
        # `track_struct("<name>", ...)` enrollment surfaces the
        # per-struct gauge `footprint.struct.<name>` — cataloged like
        # any metric registration, so a bounded structure cannot join
        # the census undocumented
        elif callee == "track_struct" and node.args:
            lit = _literal_prefix(node.args[0])
            if lit is not None:
                self.metric_literals.append(
                    (node.lineno, "footprint.struct." + lit,
                     self._qual()))

        # thread entry points
        if callee == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    self._note_thread_entry(node.lineno, kw.value,
                                            "Thread(target=...)")
        elif callee == "submit" and node.args:
            self._note_thread_entry(node.lineno, node.args[0],
                                    "executor.submit(...)")
        elif callee == "spawn_worker":
            # util.threads.spawn_worker(name, target): the audited
            # worker factory — its target walks exactly like a bare
            # Thread(target=...) so routing a spawn through the registry
            # can never weaken the T1 discipline check
            if len(node.args) >= 2:
                self._note_thread_entry(node.lineno, node.args[1],
                                        "spawn_worker(...)")
            for kw in node.keywords:
                if kw.arg == "target":
                    self._note_thread_entry(node.lineno, kw.value,
                                            "spawn_worker(...)")

        # call-graph edge for the enclosing def
        if self._func_stack and callee is not None:
            self._func_stack[-1].calls.add((_call_kind(fn), callee))

        self.generic_visit(node)

    def _note_thread_entry(self, line: int, expr, via: str) -> None:
        if isinstance(expr, ast.Name):
            self.thread_entries.append(
                ThreadEntry(self.path, line, "bare", expr.id, None, via))
        elif isinstance(expr, ast.Attribute):
            self.thread_entries.append(
                ThreadEntry(self.path, line, _call_kind(expr), expr.attr,
                            None, via))
        elif isinstance(expr, ast.Lambda):
            calls: Set[Tuple[str, str]] = set()
            for sub in ast.walk(expr.body):
                if isinstance(sub, ast.Call):
                    f = sub.func
                    if isinstance(f, ast.Attribute):
                        calls.add((_call_kind(f), f.attr))
                    elif isinstance(f, ast.Name):
                        calls.add(("bare", f.id))
            self.thread_entries.append(
                ThreadEntry(self.path, line, "inline", None, calls, via))

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        names: List[str] = []
        t = node.type
        if t is None:
            names = ["<bare>"]
        elif isinstance(t, ast.Name):
            names = [t.id]
        elif isinstance(t, ast.Tuple):
            names = [e.id for e in t.elts if isinstance(e, ast.Name)]
        body_is_pass = all(
            isinstance(s, ast.Pass) or
            (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant)
             and s.value.value is Ellipsis)
            for s in node.body)
        if body_is_pass and any(
                n in ("<bare>", "Exception", "BaseException")
                for n in names):
            kind = names[0] if names else "<bare>"
            self.except_passes.append((node.lineno, kind, self._qual()))
        self.generic_visit(node)


def _call_kind(fn) -> str:
    """`bare` for f(), `self` for self.f(), `attr` for obj.f()."""
    if isinstance(fn, ast.Name):
        return "bare"
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
            and fn.value.id == "self":
        return "self"
    return "attr"


def _literal_prefix(node) -> Optional[str]:
    """Literal (or literal-prefix) of a metric-name expression:
    "a.b" -> "a.b"; "a.%s" % x -> "a.%s"; f"a.{x}" -> "a.%s"."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod) and \
            isinstance(node.left, ast.Constant) and \
            isinstance(node.left.value, str):
        return node.left.value
    if isinstance(node, ast.JoinedStr):
        parts: List[str] = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append("%s")
        return "".join(parts)
    return None


# --------------------------------------------------------------------------
# Per-module rules


def rule_d1_wallclock(facts: ModuleFacts) -> List[Finding]:
    return [Finding("D1", facts.path, line, qual,
                    "wall-clock read `%s`: consensus/subsystem code must "
                    "take time from the injected VirtualClock (or "
                    "util.timer.real_* for sanctioned real-time "
                    "measurement)" % expr)
            for (line, expr, qual) in facts.clock_uses]


def rule_d2_randomness(facts: ModuleFacts) -> List[Finding]:
    return [Finding("D2", facts.path, line, qual,
                    "unseeded randomness `%s`: route through util.rnd "
                    "(seeded global stream) or a seeded random.Random; "
                    "os.urandom is for key generation only" % expr)
            for (line, expr, qual) in facts.random_uses]


def rule_e1_swallow(facts: ModuleFacts, e1_dirs: Sequence[str],
                    package_name: str) -> List[Finding]:
    parts = facts.path.split("/")
    try:
        sub = parts[parts.index(package_name) + 1]
    except (ValueError, IndexError):
        sub = parts[0] if len(parts) > 1 else ""
    if sub not in e1_dirs:
        return []
    return [Finding("E1", facts.path, line, qual,
                    "`except %s: pass` silently swallows in consensus "
                    "code — log it, count it, or narrow the type"
                    % kind)
            for (line, kind, qual) in facts.except_passes]


# --------------------------------------------------------------------------
# Whole-tree rules


def rule_f1_fault_sites(all_facts: Sequence[ModuleFacts],
                        registry: Set[str], registry_path: str,
                        docs_text: str, docs_name: str) -> List[Finding]:
    out: List[Finding] = []
    used: Set[str] = set()
    for facts in all_facts:
        for (line, site, qual) in facts.fault_literals:
            used.add(site)
            if site not in registry:
                out.append(Finding(
                    "F1", facts.path, line, qual,
                    "fault site %r is not in util.faults.KNOWN_SITES — "
                    "register it (and catalog it in %s)"
                    % (site, docs_name)))
    for site in sorted(registry):
        if site not in docs_text:
            out.append(Finding(
                "F1", registry_path, 1, "KNOWN_SITES",
                "registered fault site %r is missing from the %s site "
                "catalog" % (site, docs_name)))
        if site not in used:
            out.append(Finding(
                "F1", registry_path, 1, "KNOWN_SITES",
                "registered fault site %r has no should_fire/fire_point/"
                "check_faults call site left in the tree — remove it from "
                "the registry and %s" % (site, docs_name)))
    return out


def rule_m1_metric_catalog(all_facts: Sequence[ModuleFacts],
                           docs_text: str, docs_name: str) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[str] = set()
    for facts in all_facts:
        for (line, name, qual) in facts.metric_literals:
            probe = name.split("%")[0]
            if name in seen:
                continue
            seen.add(name)
            if probe not in docs_text:
                out.append(Finding(
                    "M1", facts.path, line, qual,
                    "metric %r is registered in code but absent from %s "
                    "— add it to the catalog table" % (name, docs_name)))
    return out


_A1_ROW_TOKEN = re.compile(r"`([a-zA-Z][\w-]*)")


def rule_a1_admin_endpoints(all_facts: Sequence[ModuleFacts],
                            handler_path: str, docs_text: str,
                            docs_name: str) -> List[Finding]:
    """A1: every `cmd_*` handler in main/command_handler.py has a row in
    the docs/admin.md endpoint table, and every endpoint the table names
    still has a handler — the operator surface and its documentation
    move together (M1's pattern applied to the admin API).

    Endpoint names come from the first cell of each table row: every
    backtick-opened token's leading word (`bans[?action=...]` -> `bans`;
    combined rows like `` `setcursor`, `getcursor` `` yield each)."""
    handlers: Dict[str, Tuple[str, int]] = {}
    for facts in all_facts:
        if facts.path != handler_path:
            continue
        for fi in facts.functions:
            if fi.name.startswith("cmd_") and len(fi.name) > 4:
                handlers[fi.name[4:].replace("_", "-")] = \
                    (facts.path, fi.line)
    doc_rows: Dict[str, int] = {}
    in_table = False
    for lineno, line in enumerate(docs_text.splitlines(), 1):
        s = line.strip()
        if not s.startswith("|"):
            in_table = False
            continue
        cells = s.split("|")
        first = cells[1] if len(cells) > 1 else ""
        if "Endpoint" in first:
            in_table = True
            continue
        if not in_table or set(first.strip()) <= {"-", " ", ":"}:
            continue
        for tok in _A1_ROW_TOKEN.findall(first):
            doc_rows.setdefault(tok, lineno)
    out: List[Finding] = []
    for name, (path, line) in sorted(handlers.items()):
        if name not in doc_rows:
            out.append(Finding(
                "A1", path, line, "cmd_" + name.replace("-", "_"),
                "admin endpoint `%s` has no row in the %s endpoint "
                "table — document it (purpose + params) in the same "
                "change" % (name, docs_name)))
    for name, lineno in sorted(doc_rows.items()):
        if name not in handlers:
            out.append(Finding(
                "A1", docs_name, lineno, "",
                "%s documents endpoint `%s` but main/command_handler.py "
                "has no cmd_%s handler — remove or fix the row"
                % (docs_name, name, name.replace("-", "_"))))
    return out


def rule_t1_thread_discipline(all_facts: Sequence[ModuleFacts],
                              max_depth: int = 12) -> List[Finding]:
    """Call-graph walk from every thread entry point; reaching a
    `@main_thread_only` def is a violation.

    Resolution is by name (Python has no static dispatch), with
    precision per call kind: bare `f()` and `self.f()` resolve within
    the caller's module first; `obj.f()` resolves package-wide unless
    the name is on the generic-method stoplist (_GENERIC_ATTRS). A call
    to a *marked* name triggers regardless of kind. The remaining
    over-approximation is the right bias for a discipline check — a
    false edge is an allowlist line with a justification, a missed edge
    is a silent determinism bug.
    """
    from collections import deque

    by_name: Dict[str, List[FuncInfo]] = {}
    by_mod_name: Dict[Tuple[str, str], List[FuncInfo]] = {}
    imports_of: Dict[str, Set[str]] = {}
    marked_names: Set[str] = set()
    for facts in all_facts:
        imports_of[facts.path] = facts.imported_names
        for fi in facts.functions:
            by_name.setdefault(fi.name, []).append(fi)
            by_mod_name.setdefault((fi.path, fi.name), []).append(fi)
            if fi.marked:
                marked_names.add(fi.name)
    if not marked_names:
        return []

    def resolve(caller_path: str, kind: str,
                name: str) -> List[FuncInfo]:
        local = by_mod_name.get((caller_path, name), [])
        if kind == "bare":
            # same module, else a from-imported name targets its defs
            # elsewhere in the package (stdlib imports just miss)
            if local or name not in imports_of.get(caller_path, ()):
                return local
            return by_name.get(name, [])
        if kind == "self" and local:
            return local
        if name.startswith("__") or name in _GENERIC_ATTRS:
            # cross-object generic names (sock.close, thread.start)
            # resolve to nothing; self-calls already matched above
            return []
        return by_name.get(name, [])

    def walk(entry: ThreadEntry) -> Optional[List[str]]:
        if entry.func_name is not None:
            seeds = [(entry.func_kind, entry.func_name)]
        else:
            seeds = sorted(entry.inline_calls)
        seen: Set[int] = set()
        frontier: deque = deque()
        for (kind, name) in seeds:
            if name in marked_names:
                return [name]
            for fi in resolve(entry.path, kind, name):
                frontier.append((fi, (name,)))
        while frontier:
            fi, chain = frontier.popleft()
            if id(fi) in seen or len(chain) > max_depth:
                continue
            seen.add(id(fi))
            for (kind, name) in sorted(fi.calls):
                if name in marked_names:
                    return list(chain) + [name]
                for cand in resolve(fi.path, kind, name):
                    if id(cand) not in seen:
                        frontier.append((cand, chain + (name,)))
        return None

    out: List[Finding] = []
    for facts in all_facts:
        for entry in facts.thread_entries:
            chain = walk(entry)
            if chain is not None:
                out.append(Finding(
                    "T1", entry.path, entry.line, "",
                    "worker entry point (%s) can reach "
                    "@main_thread_only function via %s — workers must "
                    "hand results to consensus with clock.post_to_main"
                    % (entry.via, " -> ".join(chain))))
    return out
