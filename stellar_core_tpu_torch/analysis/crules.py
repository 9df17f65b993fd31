"""C-side concurrency-discipline rules (N1–N4) for sctlint.

Copied from `stellar_core_tpu/analysis/crules.py` at commit c67d465;
carry a fix in either copy to the other. Nothing is changed but this
header. The port's engine also hands these rules the CUDA sources of
`csrc/` (`*.cu`, `*.cuh`): the tokenizer reads them as C, and N1-N3
find nothing there, since no kernel source calls CPython, the heap or a
mutex.

The apply hot path lives in `native/applyc.c`: a ~5.6k-line
engine that applies disjoint transaction clusters on a detached pthread
pool with the GIL released. The Python rules (D1–M1, rules.py) cannot
see any of it, yet the native layer carries the same classes of
invariant — thread discipline, allocation discipline, registry/doc
parity — that sctlint exists to enforce. This module is T1/F1/M1's
approach ported across the language boundary, on a purpose-built C
tokenizer instead of `ast`:

- **N1 — no CPython in GIL-released code.** Regions are (a) everything
  reachable from a pthread worker entry point (the 3rd argument of
  `pthread_create`) and (b) calls bracketed by
  `Py_BEGIN_ALLOW_THREADS`/`Py_END_ALLOW_THREADS` (or
  `PyEval_SaveThread`/`PyEval_RestoreThread`). A call-graph walk from
  those roots flags any reachable `Py*`/`_Py*` call. The engine's own
  escape idiom is honored and ENFORCED: a function may contain Python
  calls after an `if (...->nopy) { ... return/goto ...; }` guard —
  everything past a returning nopy-guard only runs with the GIL held —
  but a reachable Py* call with no guard before it is a violation.
- **N2 — allocation discipline.** The same reachability set must not
  call `malloc`/`calloc`/`realloc`/`free` (&co): per-op buffers on the
  hot path go through the per-context bump arenas (`arena_alloc`),
  whose own block `malloc` is the one sanctioned allocator
  (`ARENA_FUNCS` below). Deliberate amortized-growth remainders are
  allowlist lines, not silent exemptions.
- **N3 — lock balance.** Structured path analysis per function: every
  `pthread_mutex_lock` must be matched by an unlock on every return
  path (per-mutex, branch-aware, loop bodies must be net-zero;
  `pthread_cond_wait` is net-zero by contract). Functions mixing
  mutexes with `goto` are flagged as unanalyzable rather than guessed
  at.
- **N4 — cross-boundary registries.** (a) Every C bail-reason literal
  (`ctx_bail`/`env_bail`, plus `snprintf`-into-`bailbuf` dynamic
  prefixes) and every Python-side `_bail(...)` literal must have a row
  in the "Native bail taxonomy" table in docs/observability.md, every
  row must have a live call site, and the taxonomy must stay exercised
  by tests/test_apply_cockpit.py. (b) The engine's `#define OP_*` op
  table must cover exactly the wire op types the Python
  `ledger.apply.op.<type>` name table knows (no `unknown-N` metric
  names possible), with the dynamic prefix documented in
  docs/metrics.md.

Like the Python rules, everything over-approximates in the safe
direction: a false edge costs an allowlist line with a justification, a
missed edge is a data race or a GIL crash found in production.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .engine import Finding

# the sanctioned hot-path allocator: its block malloc/free IS the arena
ARENA_FUNCS = {"arena_alloc", "arena_free_all"}
ALLOC_FUNCS = {"malloc", "calloc", "realloc", "free", "strdup",
               "aligned_alloc", "posix_memalign", "reallocarray"}
# GIL bracket macros/calls: region delimiters, never themselves findings
_GIL_BEGIN = {"Py_BEGIN_ALLOW_THREADS", "PyEval_SaveThread"}
_GIL_END = {"Py_END_ALLOW_THREADS", "PyEval_RestoreThread"}
_PY_CALL_RE = re.compile(r"^_?Py[A-Z_]")
_C_KEYWORDS = {"if", "else", "for", "while", "do", "switch", "case",
               "default", "return", "break", "continue", "goto",
               "sizeof", "struct", "union", "enum", "typedef", "static",
               "const", "volatile", "register", "extern", "inline"}

_LOCK_CALLS = {"pthread_mutex_lock": 1, "pthread_mutex_unlock": -1,
               "pthread_spin_lock": 1, "pthread_spin_unlock": -1}
_COND_WAITS = {"pthread_cond_wait", "pthread_cond_timedwait"}


class Tok:
    __slots__ = ("kind", "val", "line")

    def __init__(self, kind: str, val: str, line: int) -> None:
        self.kind = kind
        self.val = val
        self.line = line

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "Tok(%s,%r,%d)" % (self.kind, self.val, self.line)


def tokenize_c(text: str) -> Tuple[List[Tok], List[Tuple[int, str]]]:
    """C token stream (comments dropped, strings kept as single tokens)
    plus the preprocessor directives as (line, folded-text) pairs."""
    toks: List[Tok] = []
    directives: List[Tuple[int, str]] = []
    i, n, line = 0, len(text), 1
    ident = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
    num = re.compile(r"(?:0[xX][0-9a-fA-F]+|\d+(?:\.\d*)?(?:[eE][+-]?\d+)?)"
                     r"[uUlLfF]*")
    while i < n:
        ch = text[i]
        if ch == "\n":
            line += 1
            i += 1
            continue
        if ch in " \t\r\v\f":
            i += 1
            continue
        if text.startswith("//", i):
            j = text.find("\n", i)
            i = n if j < 0 else j
            continue
        if text.startswith("/*", i):
            j = text.find("*/", i + 2)
            if j < 0:
                raise ValueError("line %d: unterminated /* comment" % line)
            line += text.count("\n", i, j)
            i = j + 2
            continue
        if ch == "#" and (not toks or toks[-1].line != line):
            # preprocessor directive: consume to EOL honoring \-continuation
            start, parts = line, []
            while i < n:
                j = text.find("\n", i)
                j = n if j < 0 else j
                seg = text[i:j]
                i = j + 1
                line += 1
                if seg.endswith("\\"):
                    parts.append(seg[:-1])
                    continue
                parts.append(seg)
                break
            directives.append((start, " ".join(parts)))
            continue
        if ch in "\"'":
            q, j, start_line = ch, i + 1, line
            while j < n:
                if text[j] == "\\":
                    # a \<newline> continuation inside the literal must
                    # still count the line, or every later token's
                    # reported line (and allowlist diagnostics) drifts
                    if j + 1 < n and text[j + 1] == "\n":
                        line += 1
                    j += 2
                    continue
                if text[j] == q:
                    break
                if text[j] == "\n":
                    raise ValueError("line %d: unterminated %s literal"
                                     % (line, "string" if q == '"'
                                        else "char"))
                j += 1
            if j >= n:
                raise ValueError("line %d: unterminated literal" % line)
            toks.append(Tok("str" if q == '"' else "char",
                            text[i + 1:j], start_line))
            i = j + 1
            continue
        m = ident.match(text, i)
        if m:
            toks.append(Tok("id", m.group(), line))
            i = m.end()
            continue
        m = num.match(text, i)
        if m:
            toks.append(Tok("num", m.group(), line))
            i = m.end()
            continue
        toks.append(Tok("punct", ch, line))
        i += 1
    return toks, directives


def _match_close(toks: Sequence[Tok], i: int, open_c: str,
                 close_c: str) -> int:
    """Index of the punct closing the one at i (assumes toks[i] opens)."""
    depth = 0
    for j in range(i, len(toks)):
        t = toks[j]
        if t.kind == "punct":
            if t.val == open_c:
                depth += 1
            elif t.val == close_c:
                depth -= 1
                if depth == 0:
                    return j
    raise ValueError("line %d: unbalanced %r" % (toks[i].line, open_c))


def _stmt_end(toks: Sequence[Tok], k: int) -> int:
    """Index of the token ending the single statement starting at k:
    the top-level `;`, or — for a brace-less compound statement like
    `if (x) while (y) { ... }` — the `}` closing its block (such a
    statement has no terminating semicolon). Nesting depth is honored
    (a `;` inside a for-header doesn't end it). Returns len(toks) when
    the statement runs off the slice."""
    depth = 0
    while k < len(toks):
        t = toks[k]
        if t.kind == "punct":
            if t.val == "{" and depth == 0:
                return _match_close(toks, k, "{", "}")
            if t.val in "([{":
                depth += 1
            elif t.val in ")]}":
                depth -= 1
            elif t.val == ";" and depth == 0:
                return k
        k += 1
    return k


def call_args(toks: Sequence[Tok], open_paren: int) -> List[List[Tok]]:
    """Split the argument list of a call whose '(' is at open_paren into
    top-level-comma-separated token slices."""
    close = _match_close(toks, open_paren, "(", ")")
    args: List[List[Tok]] = []
    cur: List[Tok] = []
    depth = 0
    for j in range(open_paren + 1, close):
        t = toks[j]
        if t.kind == "punct":
            if t.val in "([{":
                depth += 1
            elif t.val in ")]}":
                depth -= 1
            elif t.val == "," and depth == 0:
                args.append(cur)
                cur = []
                continue
        cur.append(t)
    if cur or args:
        args.append(cur)
    return args


class CFunc:
    """One function definition: its body token slice plus the derived
    facts every N-rule consumes."""

    def __init__(self, path: str, name: str, line: int,
                 body: List[Tok]) -> None:
        self.path = path
        self.name = name
        self.line = line
        self.body = body
        # ordered calls: (body_idx, name, line)
        self.calls: List[Tuple[int, str, int]] = []
        self.py_calls: List[Tuple[int, str, int]] = []
        self.alloc_calls: List[Tuple[int, str, int]] = []
        self.gil_regions: List[Tuple[int, int]] = []
        self.nopy_guard_end: Optional[int] = None  # body idx after guard
        self.thread_targets: List[Tuple[str, int]] = []  # (fn, line)
        self._derive()

    def _derive(self) -> None:
        toks = self.body
        begin_at: Optional[int] = None
        for i, t in enumerate(toks):
            if t.kind != "id":
                continue
            nxt = toks[i + 1] if i + 1 < len(toks) else None
            is_call = nxt is not None and nxt.kind == "punct" and \
                nxt.val == "("
            if t.val in _GIL_BEGIN:
                if begin_at is None:
                    begin_at = i
                continue
            if t.val in _GIL_END:
                if begin_at is not None:
                    self.gil_regions.append((begin_at, i))
                    begin_at = None
                continue
            if not is_call or t.val in _C_KEYWORDS:
                continue
            self.calls.append((i, t.val, t.line))
            if _PY_CALL_RE.match(t.val):
                self.py_calls.append((i, t.val, t.line))
            if t.val in ALLOC_FUNCS:
                self.alloc_calls.append((i, t.val, t.line))
            if t.val == "pthread_create":
                args = call_args(toks, i + 1)
                if len(args) >= 3:
                    target = [a for a in args[2] if a.kind == "id"]
                    if target:
                        self.thread_targets.append(
                            (target[-1].val, t.line))
        if begin_at is not None:
            # unmatched begin: treat the rest of the body as the region
            self.gil_regions.append((begin_at, len(toks) - 1))
        self._find_nopy_guard()

    def _find_nopy_guard(self) -> None:
        """The engine's GIL-escape idiom: `if (...nopy...) { ...;
        return/goto; }`. Everything after a RETURNING guard only runs
        with the GIL held, so the nogil walk stops there. A guard that
        falls through guards nothing — and neither does an INVERTED
        test (`if (!c->nopy) return;` returns exactly when the GIL is
        held, so the code after it is the nogil path)."""
        toks = self.body
        for i, t in enumerate(toks):
            if t.kind != "id" or t.val != "nopy":
                continue
            # the nopy access must sit inside an if-CONDITION: walking
            # backward we must reach `if` before any statement/block
            # boundary (an assignment like `c.nopy = 1` is no guard)
            k = i - 1
            in_if = False
            while k >= 0:
                tk = toks[k]
                if tk.kind == "id" and tk.val == "if":
                    in_if = True
                    break
                if tk.kind == "punct" and tk.val in (";", "{", "}"):
                    break
                k -= 1
            if not in_if:
                return
            # polarity: a `!` anywhere before the access chain, or a
            # trailing `== 0`, inverts the test — not a nogil guard
            if any(toks[m].kind == "punct" and toks[m].val == "!"
                   for m in range(k + 1, i)):
                return
            # find the enclosing if-condition's close paren
            j = i
            depth = 0
            while j < len(toks):
                tj = toks[j]
                if tj.kind == "punct":
                    if tj.val == "(":
                        depth += 1
                    elif tj.val == ")":
                        if depth == 0:
                            break
                        depth -= 1
                j += 1
            if j >= len(toks):
                return
            # the condition must be the BARE truthy nopy access — an
            # identifier chain of `.`/`->` only. A compound test
            # (`c->nopy && x`) can fall through with nopy set; a
            # comparison (`== 0`, Yoda `0 == ...`) may invert it; a
            # call wrapper (`invert(c->nopy)`) can do anything. So any
            # token besides ids and `-`/`>`/`.` puncts disqualifies
            # the guard — over-reject in the safe direction (an
            # unhonored real guard costs an allowlist line; an honored
            # fake one is a GIL crash).
            cond_lo = k + 1  # the `(` after `if`
            for m in range(cond_lo + 1, j):
                tm = toks[m]
                if tm.kind == "id":
                    continue
                if tm.kind == "punct" and tm.val in ("-", ">", "."):
                    continue
                return
            # guard body: block or single statement
            k = j + 1
            if k < len(toks) and toks[k].kind == "punct" and \
                    toks[k].val == "{":
                end = _match_close(toks, k, "{", "}")
            else:
                end = _stmt_end(toks, k)
            body = toks[k:end + 1]
            if any(b.kind == "id" and b.val in ("return", "goto")
                   for b in body):
                self.nopy_guard_end = end
            return  # only the FIRST nopy reference is the guard point

    def nogil_calls(self) -> List[Tuple[int, str, int]]:
        """Calls that can run with the GIL released: everything up to
        the end of a returning nopy guard, or all calls without one."""
        if self.nopy_guard_end is None:
            return self.calls
        return [c for c in self.calls if c[0] <= self.nopy_guard_end]

    def nogil_py_calls(self) -> List[Tuple[int, str, int]]:
        if self.nopy_guard_end is None:
            return self.py_calls
        return [c for c in self.py_calls if c[0] <= self.nopy_guard_end]

    def nogil_alloc_calls(self) -> List[Tuple[int, str, int]]:
        if self.nopy_guard_end is None:
            return self.alloc_calls
        return [c for c in self.alloc_calls if c[0] <= self.nopy_guard_end]


class CFileFacts:
    """Single-pass fact collector for one C translation unit."""

    def __init__(self, path: str, text: str) -> None:
        self.path = path
        self.toks, self.directives = tokenize_c(text)
        self.functions: Dict[str, CFunc] = {}
        self.defines: Dict[str, str] = {}
        self._collect_defines()
        self._collect_functions()

    def _collect_defines(self) -> None:
        d_re = re.compile(r"#\s*define\s+([A-Za-z_]\w*)\s+(.+?)\s*$")
        for (_line, text) in self.directives:
            m = d_re.match(text)
            if m and "(" not in m.group(1):
                # object-like macros only; strip trailing comments
                val = m.group(2).split("/*")[0].strip()
                self.defines[m.group(1)] = val

    def _collect_functions(self) -> None:
        toks = self.toks
        i = 0
        while i < len(toks):
            t = toks[i]
            if t.kind == "punct" and t.val == "{":
                # top-level non-function brace (struct body, initializer)
                i = _match_close(toks, i, "{", "}") + 1
                continue
            if t.kind == "id" and t.val not in _C_KEYWORDS and \
                    i + 1 < len(toks) and toks[i + 1].kind == "punct" and \
                    toks[i + 1].val == "(":
                close = _match_close(toks, i + 1, "(", ")")
                j = close + 1
                if j < len(toks) and toks[j].kind == "punct" and \
                        toks[j].val == "{":
                    end = _match_close(toks, j, "{", "}")
                    fn = CFunc(self.path, t.val, t.line, toks[j:end + 1])
                    # first definition wins (C forbids dups per TU anyway)
                    self.functions.setdefault(t.val, fn)
                    i = end + 1
                    continue
                i = close + 1
                continue
            i += 1

    def thread_entries(self) -> List[Tuple[str, str, int]]:
        """(target_fn, spawning_fn, line) for every pthread_create."""
        out = []
        for fn in self.functions.values():
            for (target, line) in fn.thread_targets:
                out.append((target, fn.name, line))
        return out


# --------------------------------------------------------------------------
# N1/N2: the nogil reachability walk


def _nogil_roots(facts: CFileFacts) -> Dict[str, str]:
    """Function name -> provenance string for every nogil root: pthread
    entry points and calls made inside GIL-released brackets."""
    roots: Dict[str, str] = {}
    for (target, spawner, line) in facts.thread_entries():
        roots.setdefault(
            target, "pthread worker entry (pthread_create in %s:%d)"
            % (spawner, line))
    for fn in facts.functions.values():
        for (lo, hi) in fn.gil_regions:
            for (idx, name, line) in fn.calls:
                if lo < idx < hi and name not in _GIL_BEGIN and \
                        name not in _GIL_END:
                    roots.setdefault(
                        name, "GIL-released bracket in %s:%d"
                        % (fn.name, line))
    return roots


def _walk_nogil(facts: CFileFacts, max_depth: int = 24
                ) -> Dict[str, Tuple[str, Tuple[str, ...]]]:
    """BFS over nogil-visible call edges; returns
    {reached_fn: (provenance, chain)}. Memoized per CFileFacts — N1
    and N2 share one walk per translation unit."""
    from collections import deque

    cached = getattr(facts, "_nogil_walk", None)
    if cached is not None:
        return cached

    roots = _nogil_roots(facts)
    reached: Dict[str, Tuple[str, Tuple[str, ...]]] = {}
    frontier: deque = deque()
    for name, why in sorted(roots.items()):
        if name in facts.functions and name not in reached:
            reached[name] = (why, (name,))
            frontier.append(name)
    while frontier:
        cur = frontier.popleft()
        why, chain = reached[cur]
        if len(chain) > max_depth:
            continue
        for (_idx, callee, _line) in facts.functions[cur].nogil_calls():
            if callee in facts.functions and callee not in reached:
                reached[callee] = (why, chain + (callee,))
                frontier.append(callee)
    facts._nogil_walk = reached
    return reached


def rule_n1_nogil_python(facts: CFileFacts) -> List[Finding]:
    out: List[Finding] = []
    # direct Py* calls lexically inside a GIL-released bracket
    for fn in facts.functions.values():
        for (lo, hi) in fn.gil_regions:
            for (idx, name, line) in fn.py_calls:
                if lo < idx < hi:
                    out.append(Finding(
                        "N1", facts.path, line, fn.name,
                        "CPython call `%s` inside a GIL-released "
                        "bracket — the GIL is NOT held here" % name))
    for name, (why, chain) in sorted(_walk_nogil(facts).items()):
        fn = facts.functions[name]
        for (_idx, pyname, line) in fn.nogil_py_calls():
            out.append(Finding(
                "N1", facts.path, line, fn.name,
                "CPython call `%s` reachable with the GIL released "
                "[%s via %s] — guard it behind the returning "
                "`if (...->nopy)` idiom or keep Python out of the "
                "worker path" % (pyname, why, " -> ".join(chain))))
    return out


def rule_n2_alloc_discipline(facts: CFileFacts) -> List[Finding]:
    out: List[Finding] = []
    # direct allocator calls lexically inside a GIL-released bracket
    # (same scan as N1's direct-bracket pass — the bracketed region IS
    # the hot path even when its host function is no worker entry)
    for fn in facts.functions.values():
        if fn.name in ARENA_FUNCS:
            continue
        for (lo, hi) in fn.gil_regions:
            for (idx, alloc, line) in fn.alloc_calls:
                if lo < idx < hi:
                    out.append(Finding(
                        "N2", facts.path, line, fn.name,
                        "heap call `%s` inside a GIL-released bracket "
                        "— per-op buffers go through the per-context "
                        "bump arena (arena_alloc)" % alloc))
    for name, (why, chain) in sorted(_walk_nogil(facts).items()):
        if name in ARENA_FUNCS:
            continue  # the arena implementation IS the allocator
        fn = facts.functions[name]
        for (_idx, alloc, line) in fn.nogil_alloc_calls():
            out.append(Finding(
                "N2", facts.path, line, fn.name,
                "heap call `%s` on the cluster-apply hot path [%s via "
                "%s] — per-op buffers go through the per-context bump "
                "arena (arena_alloc)" % (alloc, why, " -> ".join(chain))))
    return out


# --------------------------------------------------------------------------
# N3: structured lock-balance analysis


class _LockEval:
    """Branch-aware, per-mutex lock-depth evaluation over one function
    body. States are frozensets of (mutex_key, depth) pairs; the
    evaluator computes the set of possible states at every `return` and
    at the implicit end-of-function, plus net-delta checks across loop
    bodies."""

    MAX_STATES = 64

    def __init__(self, fn: CFunc, path: str) -> None:
        self.fn = fn
        self.path = path
        self.findings: List[Finding] = []
        self._reported: Set[Tuple[str, int]] = set()

    # -- state helpers ------------------------------------------------------
    @staticmethod
    def _adjust(state: frozenset, key: str, delta: int) -> frozenset:
        d = dict(state)
        d[key] = d.get(key, 0) + delta
        if d[key] == 0:
            del d[key]
        return frozenset(d.items())

    def _flag(self, line: int, msg: str) -> None:
        k = (msg, line)
        if k not in self._reported:
            self._reported.add(k)
            self.findings.append(
                Finding("N3", self.path, line, self.fn.name, msg))

    def _held(self, state: frozenset) -> List[str]:
        return sorted(k for (k, v) in state if v > 0)

    # -- driver -------------------------------------------------------------
    def run(self) -> List[Finding]:
        toks = self.fn.body
        if any(t.kind == "id" and t.val == "goto" for t in toks) and \
                any(t.kind == "id" and t.val in _LOCK_CALLS for t in toks):
            self._flag(self.fn.line,
                       "mixes pthread mutex calls with `goto` — lock "
                       "balance is not statically analyzable here; "
                       "restructure or allowlist with a justification")
            return self.findings
        body = toks[1:-1] if toks and toks[0].val == "{" else toks
        ends, _brk, _cont = self._eval(body, {frozenset()})
        for st in ends:
            held = self._held(st)
            if held:
                self._flag(self.fn.line,
                           "falls off the end still holding %s"
                           % ", ".join("`%s`" % h for h in held))
        return self.findings

    def _eval(self, toks: List[Tok], states: Set[frozenset]
              ) -> Tuple[Set[frozenset], Set[frozenset], Set[frozenset]]:
        """Evaluate a statement sequence. Returns (fallthrough states,
        break states, continue states)."""
        breaks: Set[frozenset] = set()
        continues: Set[frozenset] = set()
        i = 0
        while i < len(toks) and states:
            t = toks[i]
            if t.kind == "punct" and t.val == "{":
                end = _match_close(toks, i, "{", "}")
                states, b, c = self._eval(toks[i + 1:end], states)
                breaks |= b
                continues |= c
                i = end + 1
                continue
            if t.kind == "id" and t.val == "if":
                i, states, b, c = self._eval_if(toks, i, states)
                breaks |= b
                continues |= c
                continue
            if t.kind == "id" and t.val in ("while", "for"):
                i, states = self._eval_loop(toks, i, states)
                continue
            if t.kind == "id" and t.val == "do":
                i, states = self._eval_do(toks, i, states)
                continue
            if t.kind == "id" and t.val == "switch":
                i, states, c = self._eval_switch(toks, i, states)
                continues |= c   # continue passes through to the loop
                continue
            if t.kind == "id" and t.val == "return":
                for st in states:
                    held = self._held(st)
                    if held:
                        self._flag(t.line,
                                   "return path still holds %s"
                                   % ", ".join("`%s`" % h for h in held))
                return set(), breaks, continues
            if t.kind == "id" and t.val == "break":
                breaks |= states
                return set(), breaks, continues
            if t.kind == "id" and t.val == "continue":
                continues |= states
                return set(), breaks, continues
            if t.kind == "id" and t.val in _LOCK_CALLS and \
                    i + 1 < len(toks) and toks[i + 1].val == "(":
                key = self._mutex_key(toks, i + 1)
                delta = _LOCK_CALLS[t.val]
                nxt = set()
                for st in states:
                    ns = self._adjust(st, key, delta)
                    if delta < 0 and dict(ns).get(key, 0) < 0:
                        self._flag(t.line,
                                   "unlocks `%s` on a path where it is "
                                   "not held" % key)
                        ns = self._adjust(ns, key, 1)  # clamp, continue
                    nxt.add(ns)
                states = self._cap(nxt)
                i = _match_close(toks, i + 1, "(", ")") + 1
                continue
            if t.kind == "punct" and t.val == "(":
                i = _match_close(toks, i, "(", ")") + 1
                continue
            i += 1
        return states, breaks, continues

    def _cap(self, states: Set[frozenset]) -> Set[frozenset]:
        if len(states) > self.MAX_STATES:  # pragma: no cover - safety net
            states = set(sorted(states)[:self.MAX_STATES])
        return states

    def _mutex_key(self, toks: List[Tok], open_paren: int) -> str:
        args = call_args(toks, open_paren)
        if not args:
            return "<?>"
        return "".join(t.val for t in args[0] if t.val != "&")

    def _cond_and_body(self, toks: List[Tok], i: int
                       ) -> Tuple[List[Tok], int, int, int]:
        """For a construct at i with shape KW (cond) body: returns
        (cond tokens, body start, body end inclusive, next index)."""
        j = i + 1
        if not (j < len(toks) and toks[j].kind == "punct" and
                toks[j].val == "("):
            return [], i + 1, i, i + 1
        close = _match_close(toks, j, "(", ")")
        cond = toks[j + 1:close]
        k = close + 1
        if k < len(toks) and toks[k].kind == "punct" and toks[k].val == "{":
            end = _match_close(toks, k, "{", "}")
            return cond, k + 1, end - 1, end + 1
        end = _stmt_end(toks, k)
        return cond, k, end, end + 1

    def _eval_if(self, toks: List[Tok], i: int, states: Set[frozenset]
                 ) -> Tuple[int, Set[frozenset], Set[frozenset],
                            Set[frozenset]]:
        _cond, b0, b1, nxt = self._cond_and_body(toks, i)
        then_states, brk, cont = self._eval(toks[b0:b1 + 1], set(states))
        if nxt < len(toks) and toks[nxt].kind == "id" and \
                toks[nxt].val == "else":
            e = nxt + 1
            if e < len(toks) and toks[e].kind == "id" and toks[e].val == "if":
                e2, else_states, b2, c2 = self._eval_if(toks, e, set(states))
                return e2, then_states | else_states, brk | b2, cont | c2
            if e < len(toks) and toks[e].kind == "punct" and \
                    toks[e].val == "{":
                end = _match_close(toks, e, "{", "}")
                else_states, b2, c2 = self._eval(toks[e + 1:end],
                                                 set(states))
                return end + 1, then_states | else_states, \
                    brk | b2, cont | c2
            end = _stmt_end(toks, e)
            else_states, b2, c2 = self._eval(toks[e:end + 1], set(states))
            return end + 1, then_states | else_states, brk | b2, cont | c2
        return nxt, self._cap(then_states | states), brk, cont

    @staticmethod
    def _infinite(kw: str, cond: List[Tok]) -> bool:
        if kw == "for":
            # for (a; COND; b): infinite when COND is empty
            depth = 0
            semis = []
            for idx, t in enumerate(cond):
                if t.kind == "punct":
                    if t.val in "([{":
                        depth += 1
                    elif t.val in ")]}":
                        depth -= 1
                    elif t.val == ";" and depth == 0:
                        semis.append(idx)
            if len(semis) == 2:
                return semis[1] - semis[0] == 1
            return False
        return len(cond) == 1 and cond[0].val in ("1", "true")

    def _eval_loop(self, toks: List[Tok], i: int, states: Set[frozenset]
                   ) -> Tuple[int, Set[frozenset]]:
        kw = toks[i].val
        cond, b0, b1, nxt = self._cond_and_body(toks, i)
        body_states, brk, cont = self._eval(toks[b0:b1 + 1], set(states))
        # `continue` rejoins the loop head: its states are iteration
        # outcomes too, so a lock leaked on a continue path is the same
        # across-iteration imbalance as one leaked at the body end
        body_states = body_states | cont
        for st in body_states:
            if st not in states:
                entry = next(iter(states)) if len(states) == 1 else None
                self._flag(toks[i].line,
                           "lock imbalance across a loop iteration "
                           "(body net-changes held locks%s)"
                           % ("" if entry is None else ": %s -> %s"
                              % (self._held(entry) or "[]",
                                 self._held(st) or "[]")))
        if self._infinite(kw, cond):
            return nxt, self._cap(brk)   # no fallthrough without a break
        return nxt, self._cap(states | body_states | brk)

    def _eval_do(self, toks: List[Tok], i: int, states: Set[frozenset]
                 ) -> Tuple[int, Set[frozenset]]:
        k = i + 1
        if k < len(toks) and toks[k].kind == "punct" and toks[k].val == "{":
            end = _match_close(toks, k, "{", "}")
            body_states, brk, cont = self._eval(toks[k + 1:end],
                                                set(states))
            body_states = body_states | cont  # continue = iteration end
            for st in body_states:
                if st not in states:
                    self._flag(toks[i].line,
                               "lock imbalance across a do-while "
                               "iteration")
            nxt = end + 1
            while nxt < len(toks) and not (toks[nxt].kind == "punct" and
                                           toks[nxt].val == ";"):
                nxt += 1
            return nxt + 1, self._cap(body_states | brk)
        return k, states

    def _eval_switch(self, toks: List[Tok], i: int, states: Set[frozenset]
                     ) -> Tuple[int, Set[frozenset], Set[frozenset]]:
        _cond, b0, b1, nxt = self._cond_and_body(toks, i)
        body = toks[b0:b1 + 1]
        # case dispatch is not straight-line: an early return/break
        # would hide later cases' lock ops from a linear scan. Any
        # mutex call INSIDE a switch is therefore declared unanalyzable
        # (the goto stance) rather than guessed at.
        if any(t.kind == "id" and t.val in _LOCK_CALLS for t in body):
            self._flag(toks[i].line,
                       "switch contains pthread mutex calls — "
                       "case-level lock balance is not statically "
                       "analyzable here; restructure or allowlist "
                       "with a justification")
            # neutralize lock state downstream: the single finding
            # above is the verdict; guessing on would double-report
            return nxt, {frozenset()}, set()
        # no lock ops inside: the body cannot change lock state, so
        # evaluation reduces to checking `return` against the entry
        # states (an early return in a case still exits holding
        # whatever the function holds) and propagating `continue`
        # (which belongs to the enclosing loop, not the switch)
        held = sorted({h for st in states for h in self._held(st)})
        if held:
            for t in body:
                if t.kind == "id" and t.val == "return":
                    self._flag(t.line,
                               "return path still holds %s"
                               % ", ".join("`%s`" % h for h in held))
        cont: Set[frozenset] = set()
        if any(t.kind == "id" and t.val == "continue" for t in body):
            cont = set(states)
        return nxt, states, cont


def rule_n3_lock_balance(facts: CFileFacts) -> List[Finding]:
    out: List[Finding] = []
    for fn in facts.functions.values():
        uses_lock = any(t.kind == "id" and t.val in _LOCK_CALLS
                        for t in fn.body)
        uses_wait = any(t.kind == "id" and t.val in _COND_WAITS
                        for t in fn.body)
        if uses_lock or uses_wait:
            out.extend(_LockEval(fn, facts.path).run())
    out.sort(key=lambda f: f.line)
    return out


# --------------------------------------------------------------------------
# N4: cross-boundary registries (bail taxonomy + op-type table)

_BAIL_CALLS = {"ctx_bail": 1, "env_bail": 1}  # literal arg index
_TAXONOMY_HEADING = "native bail taxonomy"
_ROW_RE = re.compile(r"^\|\s*`([^`|]+)`\s*\|\s*([^|]*)\|")


def native_bail_taxonomy(docs_text: str) -> Dict[str, str]:
    """Parse the "Native bail taxonomy" table out of
    docs/observability.md: {reason: origin}. `reason` may carry a
    `<...>` placeholder marking a dynamic family (`op-<type>`).
    Exposed publicly — tests/test_apply_cockpit.py exercises the same
    registry the N4 rule enforces."""
    out: Dict[str, str] = {}
    in_section = False
    for line in docs_text.splitlines():
        if line.startswith("#"):
            in_section = _TAXONOMY_HEADING in line.lower()
            continue
        if not in_section:
            continue
        m = _ROW_RE.match(line.strip())
        if m and m.group(1).strip() not in ("reason",):
            out[m.group(1).strip()] = m.group(2).strip().lower()
    return out


def _collect_c_bails(all_cfacts: Sequence[CFileFacts]
                     ) -> Tuple[List[Tuple[str, str, int, str]], Set[str]]:
    """([(path, reason, line, func)], {dynamic prefixes}) from
    ctx_bail/env_bail literals and snprintf-into-bailbuf formats."""
    literals: List[Tuple[str, str, int, str]] = []
    prefixes: Set[str] = set()
    for facts in all_cfacts:
        for fn in facts.functions.values():
            for (idx, name, line) in fn.calls:
                if name in _BAIL_CALLS:
                    args = call_args(fn.body, idx + 1)
                    if len(args) > _BAIL_CALLS[name]:
                        arg = args[_BAIL_CALLS[name]]
                        # pure literal arg, incl. adjacent-string
                        # concatenation ("liab-" "release")
                        if arg and all(t.kind == "str" for t in arg):
                            literals.append(
                                (facts.path,
                                 "".join(t.val for t in arg),
                                 line, fn.name))
                elif name == "snprintf":
                    args = call_args(fn.body, idx + 1)
                    if len(args) >= 3 and any(
                            t.val == "bailbuf" for t in args[0]):
                        fmt = [t for t in args[2] if t.kind == "str"]
                        if fmt:
                            prefixes.add(fmt[0].val.split("%")[0])
    return literals, prefixes


def rule_n4_cross_boundary(
        all_cfacts: Sequence[CFileFacts],
        py_bail_literals: Sequence[Tuple[str, int, str, str]],
        docs_obs_text: str, docs_obs_name: str,
        docs_metrics_text: str, docs_metrics_name: str,
        bail_test_text: Optional[str], bail_test_name: str,
        op_type_names: Optional[Dict[int, str]]) -> List[Finding]:
    """Registry parity across the C/Python boundary.

    `py_bail_literals`: (path, line, reason, qual) from the Python-side
    `_bail(stats, "...")` gates (collected by rules.ModuleFacts)."""
    out: List[Finding] = []
    taxonomy = native_bail_taxonomy(docs_obs_text)
    dyn_rows = {r.split("<")[0]: r for r in taxonomy if "<" in r}
    exact_rows = {r for r in taxonomy if "<" not in r}

    c_literals, c_prefixes = _collect_c_bails(all_cfacts)

    def covered(reason: str) -> bool:
        # exact rows ONLY: a literal reason in code is an exact member
        # of the registry. Dynamic rows (`op-<type>`) exist for the
        # snprintf/classifier-BUILT families and must not shadow the
        # exact namespace under their prefix — else a new `op-foo`
        # literal would ship undocumented and deleting the `op-shape`
        # row would go unnoticed.
        return reason in exact_rows

    if not taxonomy and (c_literals or py_bail_literals):
        first = c_literals[0] if c_literals else None
        out.append(Finding(
            "N4", first[0] if first else docs_obs_name,
            first[2] if first else 1, first[3] if first else "",
            "no 'Native bail taxonomy' table found in %s — the bail "
            "registry the C and Python gates classify into must be "
            "cataloged there" % docs_obs_name))
        return out

    seen: Set[str] = set()
    for (path, reason, line, func) in c_literals:
        if reason in seen:
            continue
        seen.add(reason)
        if not covered(reason):
            out.append(Finding(
                "N4", path, line, func,
                "C bail reason %r has no row in the %s native-bail "
                "taxonomy table" % (reason, docs_obs_name)))
    for prefix in sorted(c_prefixes):
        if prefix not in dyn_rows:
            # the snprintf family needs a dynamic `prefix<...>` row
            out.append(Finding(
                "N4", all_cfacts[0].path if all_cfacts else docs_obs_name,
                1, "",
                "dynamic C bail family %r (snprintf into bailbuf) has "
                "no `%s<...>` row in the %s taxonomy"
                % (prefix, prefix, docs_obs_name)))
    for (path, line, reason, qual) in py_bail_literals:
        if reason in seen:
            continue
        seen.add(reason)
        if not covered(reason):
            out.append(Finding(
                "N4", path, line, qual,
                "Python bail reason %r has no row in the %s "
                "native-bail taxonomy table" % (reason, docs_obs_name)))

    live = {r for (_p, r, _l, _f) in c_literals} | \
        {r for (_p, _l, r, _q) in py_bail_literals}
    for row in sorted(taxonomy):
        if "<" in row:
            # a dynamic row is kept alive by a dynamic PRODUCER (a
            # snprintf-into-bailbuf family) only — exact literals
            # under the prefix have their own rows
            if row.split("<")[0] not in c_prefixes:
                out.append(Finding(
                    "N4", docs_obs_name, 1, "",
                    "taxonomy row `%s` matches no dynamic bail "
                    "producer left in the tree — remove or fix it"
                    % row))
        elif row not in live:
            out.append(Finding(
                "N4", docs_obs_name, 1, "",
                "taxonomy row `%s` has no ctx_bail/env_bail/_bail call "
                "site left in the tree — remove or fix it" % row))

    if bail_test_text is not None and \
            "native_bail_taxonomy" not in bail_test_text:
        out.append(Finding(
            "N4", bail_test_name, 1, "",
            "%s no longer exercises the native-bail taxonomy "
            "(expected a native_bail_taxonomy() cross-check) — the "
            "registry, docs and test move together" % bail_test_name))

    # -- op-type table -------------------------------------------------------
    if op_type_names is not None:
        # the op table lives in ONE translation unit (the apply
        # engine): check the TU with the largest OP_* define set, so a
        # stray OP_-prefixed constant in another file can't demand all
        # 14 wire types there
        engine_facts: Optional[CFileFacts] = None
        engine_defs: Dict[int, str] = {}
        for facts in all_cfacts:
            defs: Dict[int, str] = {}
            for (name, val) in facts.defines.items():
                if name.startswith("OP_"):
                    try:
                        defs[int(val, 0)] = name
                    except ValueError:
                        continue
            if len(defs) > len(engine_defs):
                engine_facts, engine_defs = facts, defs
        if engine_facts is not None:
            for v, name in sorted(engine_defs.items()):
                if v not in op_type_names:
                    out.append(Finding(
                        "N4", engine_facts.path, 1, "",
                        "C op-type define %s=%d has no Python "
                        "OP_TYPE_NAMES entry — its op_stats row would "
                        "surface as `ledger.apply.op.unknown-%d`"
                        % (name, v, v)))
            for v, pyname in sorted(op_type_names.items()):
                if v not in engine_defs:
                    out.append(Finding(
                        "N4", engine_facts.path, 1, "",
                        "wire op type %d (`%s`) has no OP_* define in "
                        "%s — the engine cannot classify or attribute "
                        "it" % (v, pyname, engine_facts.path)))
            maxop = engine_facts.defines.get("MAX_OPTYPES")
            if maxop is not None:
                try:
                    if int(maxop.split()[0], 0) <= max(engine_defs):
                        out.append(Finding(
                            "N4", engine_facts.path, 1, "",
                            "MAX_OPTYPES (%s) does not cover the "
                            "largest OP_* define (%d) — the op_stats "
                            "table would drop its attribution"
                            % (maxop, max(engine_defs))))
                except ValueError:
                    pass
        if "ledger.apply.op.<" not in docs_metrics_text:
            out.append(Finding(
                "N4", docs_metrics_name, 1, "",
                "the dynamic `ledger.apply.op.<type>` prefix is no "
                "longer documented in %s — the C op_stats table feeds "
                "exactly that name space" % docs_metrics_name))
    return out
