"""Dataflow rules for sctlint: S1 (set-iteration determinism), FL1
(float leakage into replicated state), B1 (bounded-memory census parity).

Copied from `stellar_core_tpu/analysis/flowrules.py` at commit 94afec1;
carry a fix in either copy to the other. Nothing is changed but this
header and one comment's tracker reference.

D1/D2 police the *inputs* a replicated transition function may read;
these rules police the two remaining silent-divergence classes a Python
core carries (the ACE-Runtime determinism contract, PAPERS.md
2603.10242) plus the unbounded-growth class the footprint census
can only observe at runtime:

- **S1 — set-ordered iteration.** `set` iteration order depends on
  `PYTHONHASHSEED` for str/bytes elements, so any set-ordered sequence
  that feeds hashing, XDR serialization, message emission, or a
  returned collection in consensus-critical packages diverges
  bit-identically-replicated state across nodes. A lightweight
  intraprocedural dataflow pass (below) tracks set-origin values
  through assignments, comprehensions, `list()`/`tuple()`/`join`/`*`
  laundering and module-local helper returns; `sorted(...)` is the
  sanctioned neutralizer. The runtime twin is the PYTHONHASHSEED
  differential gate (tests/test_hashseed_differential.py): two
  subprocesses under different hash seeds must externalize identical
  per-height header hashes, bucket-list hashes and txset orderings.
- **FL1 — float leakage.** IEEE-754 arithmetic is deterministic per
  platform but its *use* in fee/balance/sequence math invites rounding
  drift the moment any operand path differs; replicated-state code in
  `ledger/`, `scp/`, `herder/` must stay on integers. Flagged: true
  division (`/` always yields float), arithmetic on float-origin
  operands, and float-typed returns. Telemetry/metrics call sites
  resolve via allowlist lines with per-site justifications.
- **B1 — bounded-memory parity.** Every long-lived subsystem class
  (discovered by walking Application/Herder/OverlayManager/
  LedgerManager construction, transitively) whose instance-attribute
  containers grow from runtime handlers must be bounded by
  construction (`deque(maxlen=...)`, `LRUCache`,
  `RandomEvictionCache`), carry explicit cap/eviction logic, or be
  enrolled in the footprint census via `track_struct(...)` — and every
  enrollment must still reference a live instance attribute
  (registry ⇄ code parity, the F1/M1/N4 shape applied to memory).

Like every sctlint rule the bias is over-approximation in the safe
direction: a false edge is an allowlist line with a justification, a
missed edge is a consensus fork or an OOM at height 10^6.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .engine import Finding

# -- taint lattice ----------------------------------------------------------
# None        clean
# ("set",)    unordered set-valued (or a mapping keyed in set order):
#             safe to return/pass, hazardous to iterate unsorted
# ("seq", line, desc)
#             an ORDERED sequence derived from set iteration order; the
#             recorded site is where the nondeterministic ordering was
#             created (list(s), a comprehension, join, *-unpack, ...)
# ("float",)  float-typed value

_SET = ("set",)
_FLOAT = ("float",)

# callables whose result order/content is insensitive to input order
_ORDER_INSENSITIVE = {
    "len", "sum", "min", "max", "any", "all", "bool", "sorted",
    "frozenset", "abs", "int", "str", "repr", "id", "isinstance",
    "Counter",
}
# sequence-producing callables that PRESERVE the argument's iteration
# order (the laundering set: list(s) looks innocent, still hashes dirty)
_ORDER_PRESERVING = {"list", "tuple", "iter", "enumerate", "reversed"}
# set methods returning another set
_SET_METHODS = {"union", "intersection", "difference",
                "symmetric_difference", "copy"}
# sink callables: hashing, XDR serialization, message emission. Matched
# by exact name or substring ("hash"/"xdr"/"digest") on the called name.
_SINK_NAMES = {"sha256", "digest", "hexdigest", "broadcast_message",
               "send_message", "emit", "rebroadcast", "emit_envelope",
               "pack", "dumps"}
_SINK_SUBSTR = ("hash", "xdr", "digest")

_ARITH_OPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv,
              ast.Mod, ast.Pow)

# -- B1 vocabulary ----------------------------------------------------------
_UNBOUNDED_CTORS = {"dict", "list", "set", "defaultdict", "OrderedDict"}
_BOUNDED_CTORS = {"LRUCache", "RandomEvictionCache"}
_GROWTH_METHODS = {"append", "appendleft", "add", "insert", "extend",
                   "update", "setdefault", "push"}
_EVICT_METHODS = {"pop", "popleft", "popitem", "clear", "discard",
                  "remove", "evict", "prune"}
# methods that run at wiring/teardown time, not from live handlers: a
# container only ever grown here is filled once, not leaked into
_SETUP_METHODS = {"__init__", "__post_init__", "start", "setup",
                  "configure", "enable", "arm", "wire", "rewire",
                  "shutdown", "stop", "restore", "load", "bootstrap"}


def _sink_call(name: Optional[str]) -> bool:
    if not name:
        return False
    if name in _SINK_NAMES:
        return True
    low = name.lower()
    return any(s in low for s in _SINK_SUBSTR)


def _callee_name(fn) -> Optional[str]:
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _ann_is_set(ann) -> bool:
    """Annotation names a set type (Set[...], FrozenSet[...], set)."""
    if isinstance(ann, ast.Subscript):
        ann = ann.value
    if isinstance(ann, ast.Attribute):
        return ann.attr in ("Set", "FrozenSet", "MutableSet",
                            "AbstractSet")
    if isinstance(ann, ast.Name):
        return ann.id in ("set", "frozenset", "Set", "FrozenSet",
                          "MutableSet", "AbstractSet")
    return False


def _ann_is_float(ann) -> bool:
    if isinstance(ann, ast.Name):
        return ann.id == "float"
    return False


class FlowFn:
    """Summary of one function after the intraprocedural pass."""

    __slots__ = ("qualname", "name", "line", "returns_set",
                 "returns_float")

    def __init__(self, qualname: str, name: str, line: int) -> None:
        self.qualname = qualname
        self.name = name
        self.line = line
        self.returns_set = False
        self.returns_float = False


class ClassFlow:
    """B1 facts for one class definition."""

    __slots__ = ("name", "qualname", "line", "containers", "constructed",
                 "growths", "caps")

    def __init__(self, name: str, qualname: str, line: int) -> None:
        self.name = name
        self.qualname = qualname
        self.line = line
        # attr -> (kind, bounded, line)
        self.containers: Dict[str, Tuple[str, bool, int]] = {}
        # attr -> constructed class name (self.x = SomeClass(...))
        self.constructed: Dict[str, str] = {}
        # (method, attr, op, line) growth mutations outside __init__
        self.growths: List[Tuple[str, str, str, int]] = []
        # attrs with cap/eviction evidence anywhere in the class
        self.caps: Set[str] = set()


class FlowFacts:
    """Per-module dataflow facts: S1/FL1 candidate findings (computed at
    parse time so they cache with the module), per-function return
    summaries, and the class/enrollment facts the tree-wide B1 rule
    consumes. Holds no AST after construction — picklable for the
    content-sha cache."""

    def __init__(self, path: str, tree: ast.AST) -> None:
        self.path = path
        self.functions: Dict[str, FlowFn] = {}   # by bare name, last wins
        self.classes: List[ClassFlow] = []
        # (line, qual, literal-name, frozenset of referenced attr tails)
        self.track_calls: List[Tuple[int, str, str, frozenset]] = []
        self.module_names: Set[str] = set()      # module-level assigns
        self.self_attrs: Set[str] = set()        # every `self.X = ...`
        # the attribute universe B1's reverse-parity check resolves
        # against: function/class names, class-level constants,
        # module-level names — anything a track_struct lambda may
        # legitimately dereference
        self.defined_names: Set[str] = set()
        # candidate findings: (rule, line, qual, message)
        self.s1_sites: List[Tuple[int, str, str]] = []
        self.fl1_sites: List[Tuple[int, str, str]] = []

        self._fn_nodes: List[Tuple[ast.AST, str, Optional[ClassFlow]]] = []
        self._collect(tree)
        self._summarize()
        self._analyze()
        del self._fn_nodes               # drop AST references

    # -- structural collection ----------------------------------------------
    def _collect(self, tree: ast.AST) -> None:
        def walk(node, scope: List[str], cls: Optional[ClassFlow]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    cf = ClassFlow(child.name,
                                   ".".join(scope + [child.name]),
                                   child.lineno)
                    self.classes.append(cf)
                    self.defined_names.add(child.name)
                    walk(child, scope + [child.name], cf)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    qual = ".".join(scope + [child.name])
                    self._fn_nodes.append((child, qual, cls))
                    self.defined_names.add(child.name)
                    if cls is not None:
                        self._class_facts(cls, child)
                    self._scan_track_and_attrs(child, qual)
                    walk(child, scope + [child.name], None)
                else:
                    if isinstance(child, (ast.Assign, ast.AnnAssign)):
                        targets = child.targets \
                            if isinstance(child, ast.Assign) \
                            else [child.target]
                        for t in targets:
                            if isinstance(t, ast.Name):
                                self.defined_names.add(t.id)
                                if not scope:
                                    self.module_names.add(t.id)
                    walk(child, scope, cls)
        walk(tree, [], None)

    def _scan_track_and_attrs(self, fnode, qual: str) -> None:
        """track_struct enrollments + the universe of self-attrs (the
        reverse-parity side of B1)."""
        for node in ast.walk(fnode):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        self.self_attrs.add(t.attr)
            if isinstance(node, ast.Call) and \
                    _callee_name(node.func) == "track_struct" and node.args:
                a = node.args[0]
                if not (isinstance(a, ast.Constant) and
                        isinstance(a.value, str)):
                    continue
                refs: Set[str] = set()
                for arg in list(node.args[1:]) + \
                        [kw.value for kw in node.keywords]:
                    for sub in ast.walk(arg):
                        if isinstance(sub, ast.Attribute):
                            refs.add(sub.attr)
                        elif isinstance(sub, ast.Name):
                            refs.add(sub.id)
                self.track_calls.append(
                    (node.lineno, qual, a.value, frozenset(refs)))

    def _class_facts(self, cls: ClassFlow, fnode) -> None:
        """Container inits, constructions, growths and cap evidence for
        one method of `cls`."""
        meth = fnode.name
        in_init = meth == "__init__"
        for node in ast.walk(fnode):
            # self.X = <container or construction> (init only)
            if in_init and isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                val = node.value
                for t in targets:
                    if not (isinstance(t, ast.Attribute) and
                            isinstance(t.value, ast.Name) and
                            t.value.id == "self"):
                        continue
                    kind, bounded = self._container_of(val)
                    if kind is not None:
                        cls.containers[t.attr] = (kind, bounded,
                                                  node.lineno)
                    elif isinstance(val, ast.Call):
                        cn = _callee_name(val.func)
                        if cn and cn[:1].isupper():
                            cls.constructed[t.attr] = cn
            # growth / eviction on self.X
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                recv = node.func.value
                if isinstance(recv, ast.Attribute) and \
                        isinstance(recv.value, ast.Name) and \
                        recv.value.id == "self":
                    if node.func.attr in _GROWTH_METHODS and not in_init:
                        cls.growths.append((meth, recv.attr,
                                            node.func.attr, node.lineno))
                    elif node.func.attr in _EVICT_METHODS:
                        cls.caps.add(recv.attr)
            if isinstance(node, ast.Assign) and not in_init:
                for t in node.targets:
                    if isinstance(t, ast.Subscript) and \
                            isinstance(t.value, ast.Attribute) and \
                            isinstance(t.value.value, ast.Name) and \
                            t.value.value.id == "self":
                        cls.growths.append((meth, t.value.attr, "[]=",
                                            node.lineno))
            if isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) and \
                            isinstance(t.value, ast.Attribute) and \
                            isinstance(t.value.value, ast.Name) and \
                            t.value.value.id == "self":
                        cls.caps.add(t.value.attr)
            # len(self.X) inside a comparison or loop/branch test
            if isinstance(node, (ast.Compare, ast.While, ast.If)):
                tests = [node.test] if isinstance(node, (ast.While,
                                                         ast.If)) \
                    else [node]
                for test in tests:
                    for sub in ast.walk(test):
                        if isinstance(sub, ast.Call) and \
                                _callee_name(sub.func) == "len" and \
                                sub.args and \
                                isinstance(sub.args[0], ast.Attribute) \
                                and isinstance(sub.args[0].value,
                                               ast.Name) and \
                                sub.args[0].value.id == "self":
                            cls.caps.add(sub.args[0].attr)

    @staticmethod
    def _container_of(val) -> Tuple[Optional[str], bool]:
        """(kind, bounded) when `val` constructs a container literal."""
        if isinstance(val, ast.Dict):
            return "dict", False
        if isinstance(val, ast.List):
            return "list", False
        if isinstance(val, ast.Set):
            return "set", False
        if isinstance(val, ast.Call):
            cn = _callee_name(val.func)
            if cn == "deque":
                bounded = any(kw.arg == "maxlen" for kw in val.keywords) \
                    or len(val.args) >= 2
                return "deque", bounded
            if cn in _UNBOUNDED_CTORS:
                return cn, False
            if cn in _BOUNDED_CTORS:
                return cn, True
        return None, False

    # -- function summaries (the module-local helper hop) --------------------
    def _summarize(self) -> None:
        for fnode, qual, _cls in self._fn_nodes:
            self.functions[fnode.name] = FlowFn(qual, fnode.name,
                                                fnode.lineno)
        # fixpoint: a helper returning set()/a float taints its callers'
        # summaries; the tree is small, convergence takes 2-3 rounds
        for _ in range(4):
            changed = False
            for fnode, qual, cls in self._fn_nodes:
                fn = self.functions[fnode.name]
                pass_ = _FnPass(self, cls, collect=False)
                rs, rf = pass_.run(fnode)
                if rs and not fn.returns_set:
                    fn.returns_set = changed = True
                if rf and not fn.returns_float:
                    fn.returns_float = changed = True
            if not changed:
                break

    def _analyze(self) -> None:
        for fnode, qual, cls in self._fn_nodes:
            pass_ = _FnPass(self, cls, collect=True, qual=qual)
            pass_.run(fnode)


class _FnPass:
    """One forward walk over a function body: evaluates expression
    taints against a local environment, records S1/FL1 candidate sites
    when `collect` is set, and reports whether the function returns
    set-origin / float-origin values."""

    def __init__(self, facts: FlowFacts, cls: Optional[ClassFlow],
                 collect: bool, qual: str = "") -> None:
        self.facts = facts
        self.cls = cls
        self.collect = collect
        self.qual = qual
        self.env: Dict[str, Optional[tuple]] = {}
        self.kinds: Dict[str, str] = {}       # name -> container kind
        self.returned_names: Set[str] = set()
        self.returns_set = False
        self.returns_float = False
        self._seen_sites: Set[Tuple[int, int, str]] = set()

    # -- driver --------------------------------------------------------------
    def run(self, fnode) -> Tuple[bool, bool]:
        for arg in list(fnode.args.args) + list(fnode.args.kwonlyargs):
            if arg.annotation is not None:
                if _ann_is_set(arg.annotation):
                    self.env[arg.arg] = _SET
                elif _ann_is_float(arg.annotation):
                    self.env[arg.arg] = _FLOAT
        # pre-pass: names returned anywhere (loop-accumulator sink)
        for node in ast.walk(fnode):
            if isinstance(node, ast.Return) and \
                    isinstance(node.value, ast.Name):
                self.returned_names.add(node.value.id)
        for stmt in fnode.body:
            self._stmt(stmt)
        return self.returns_set, self.returns_float

    def _site(self, line: int, col: int, rule: str, msg: str) -> None:
        if not self.collect:
            return
        key = (line, col, msg)
        if key in self._seen_sites:
            return
        self._seen_sites.add(key)
        if rule == "S1":
            self.facts.s1_sites.append((line, self.qual, msg))
        else:
            self.facts.fl1_sites.append((line, self.qual, msg))

    # -- statements ----------------------------------------------------------
    def _stmt(self, node) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return                         # nested defs analyzed separately
        if isinstance(node, ast.Assign):
            o = self._ev(node.value)
            k = self._kind_of(node.value)
            for t in node.targets:
                self._bind(t, o, k)
        elif isinstance(node, ast.AnnAssign):
            o = self._ev(node.value) if node.value is not None else None
            if node.value is None or o is None:
                if _ann_is_set(node.annotation):
                    o = _SET
                elif _ann_is_float(node.annotation):
                    o = _FLOAT
            self._bind(node.target, o, self._kind_of(node.value))
        elif isinstance(node, ast.AugAssign):
            o = self._ev(node.value)
            if isinstance(node.target, ast.Name):
                cur = self.env.get(node.target.id)
                new = self._binop_taint(node.op, cur, o, node)
                if new is not None:
                    self.env[node.target.id] = new
        elif isinstance(node, ast.Return):
            o = self._ev(node.value) if node.value is not None else None
            if o is not None:
                if o[0] == "set":
                    self.returns_set = True
                elif o[0] == "float":
                    self.returns_float = True
                    self._site(node.lineno, node.col_offset, "FL1",
                               "float-typed return: replicated-state "
                               "code must stay on integers (scale to "
                               "stroops/ppm)")
                elif o[0] == "seq":
                    self._site(o[1], 0, "S1",
                               "set-ordered sequence (%s) is returned — "
                               "wrap the set in sorted(...) at the "
                               "ordering point" % o[2])
        elif isinstance(node, ast.For):
            self._for(node)
        elif isinstance(node, (ast.While, ast.If)):
            self._ev(node.test)
            for s in node.body:
                self._stmt(s)
            for s in node.orelse:
                self._stmt(s)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                self._ev(item.context_expr)
            for s in node.body:
                self._stmt(s)
        elif isinstance(node, ast.Try):
            for s in node.body:
                self._stmt(s)
            for h in node.handlers:
                for s in h.body:
                    self._stmt(s)
            for s in node.orelse + node.finalbody:
                self._stmt(s)
        elif isinstance(node, ast.Expr):
            self._ev(node.value)
        elif isinstance(node, (ast.Raise, ast.Assert, ast.Delete)):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self._ev(child)

    def _bind(self, target, o, kind: Optional[str]) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = o
            if kind is not None:
                self.kinds[target.id] = kind
        elif isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id == "self":
            self.env[("self", target.attr)] = o
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, None, None)

    def _kind_of(self, val) -> Optional[str]:
        if val is None:
            return None
        k, _ = FlowFacts._container_of(val)
        return k

    def _for(self, node: ast.For) -> None:
        it = self._ev(node.iter)
        if it is not None and it[0] in ("set", "seq"):
            line = node.iter.lineno if it[0] == "set" else it[1]
            desc = "set" if it[0] == "set" else it[2]
            consumed = self._loop_consumes(node.body)
            if consumed:
                self._site(line, node.col_offset, "S1",
                           "iteration over %s in a loop that %s — wrap "
                           "the iterable in sorted(...)" % (desc,
                                                            consumed))
        self._bind(node.target, None, None)
        for s in node.body:
            self._stmt(s)
        for s in node.orelse:
            self._stmt(s)

    def _loop_consumes(self, body) -> Optional[str]:
        """Does this loop body leak iteration ORDER into consensus-
        visible state? (hash/XDR/emit calls, yields, or appends into a
        returned ordered accumulator; adds into sets/dicts are
        order-insensitive and stay clean)."""
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    name = _callee_name(node.func)
                    if _sink_call(name):
                        return "feeds `%s(...)`" % name
                    if name in ("append", "extend", "insert") and \
                            isinstance(node.func, ast.Attribute) and \
                            isinstance(node.func.value, ast.Name):
                        acc = node.func.value.id
                        if acc in self.returned_names and \
                                self.kinds.get(acc) != "set" and \
                                self.kinds.get(acc) != "dict":
                            return "builds returned collection `%s`" \
                                % acc
                elif isinstance(node, (ast.Yield, ast.YieldFrom)):
                    return "yields in iteration order"
        return None

    # -- expressions ---------------------------------------------------------
    def _ev(self, node) -> Optional[tuple]:
        if node is None:
            return None
        m = getattr(self, "_ev_%s" % type(node).__name__, None)
        if m is not None:
            return m(node)
        # default: evaluate children for side-record (sites), no taint
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._ev(child)
        return None

    def _ev_Name(self, node):
        return self.env.get(node.id)

    def _ev_Attribute(self, node):
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            o = self.env.get(("self", node.attr))
            if o is not None:
                return o
            if self.cls is not None:
                info = self.cls.containers.get(node.attr)
                if info is not None and info[0] == "set":
                    return _SET
            return None
        self._ev(node.value)
        return None

    def _ev_Constant(self, node):
        if isinstance(node.value, float):
            return _FLOAT
        return None

    def _ev_Set(self, node):
        for e in node.elts:
            self._ev(e)
        return _SET

    def _ev_SetComp(self, node):
        self._comp_generators(node)
        return _SET

    def _ev_DictComp(self, node):
        # a dict comprehension over a set inherits set insertion order
        if self._comp_generators(node):
            return _SET
        return None

    def _ev_ListComp(self, node):
        return self._ordered_comp(node, "list comprehension")

    def _ev_GeneratorExp(self, node):
        return self._ordered_comp(node, "generator expression")

    def _ordered_comp(self, node, what: str):
        tainted = self._comp_generators(node)
        self._ev(node.elt)
        if tainted:
            return ("seq", node.lineno, "%s over a set" % what)
        return None

    def _comp_generators(self, node) -> bool:
        tainted = False
        for gen in node.generators:
            o = self._ev(gen.iter)
            if o is not None and o[0] in ("set", "seq"):
                tainted = True
            self._bind(gen.target, None, None)
            for cond in gen.ifs:
                self._ev(cond)
        if isinstance(node, ast.DictComp):
            self._ev(node.key)
            self._ev(node.value)
        elif not isinstance(node, ast.SetComp):
            pass  # elt evaluated by caller where needed
        return tainted

    def _ev_List(self, node):
        return self._display(node)

    def _ev_Tuple(self, node):
        return self._display(node)

    def _display(self, node):
        out = None
        for e in node.elts:
            if isinstance(e, ast.Starred):
                o = self._ev(e.value)
                if o is not None and o[0] in ("set", "seq"):
                    out = ("seq", e.lineno, "*-unpack of a set")
            else:
                # a set-ordered sequence nested in a display keeps its
                # taint: `return list(s), x` leaks order just the same
                o = self._ev(e)
                if out is None and o is not None and o[0] == "seq":
                    out = o
        return out

    def _ev_BinOp(self, node):
        left = self._ev(node.left)
        right = self._ev(node.right)
        return self._binop_taint(node.op, left, right, node)

    def _binop_taint(self, op, left, right, node):
        sets = [o for o in (left, right) if o is not None and
                o[0] == "set"]
        if isinstance(op, (ast.BitOr, ast.BitAnd, ast.BitXor)) and sets:
            return _SET
        if isinstance(op, ast.Sub) and sets:
            return _SET
        if isinstance(op, ast.Div):
            self._site(node.lineno, node.col_offset, "FL1",
                       "true division always yields float — use // "
                       "(or integer ppm/stroop scaling) in "
                       "replicated-state code")
            return _FLOAT
        if isinstance(op, _ARITH_OPS):
            if any(o is not None and o[0] == "float"
                   for o in (left, right)):
                self._site(node.lineno, node.col_offset, "FL1",
                           "arithmetic on a float-origin operand in "
                           "replicated-state code")
                return _FLOAT
        return None

    def _ev_UnaryOp(self, node):
        return self._ev(node.operand)

    def _ev_IfExp(self, node):
        self._ev(node.test)
        a = self._ev(node.body)
        b = self._ev(node.orelse)
        return a or b

    def _ev_NamedExpr(self, node):
        o = self._ev(node.value)
        self._bind(node.target, o, self._kind_of(node.value))
        return o

    def _ev_Await(self, node):
        return self._ev(node.value)

    def _ev_Starred(self, node):
        return self._ev(node.value)

    def _ev_Subscript(self, node):
        self._ev(node.value)
        self._ev(node.slice)
        return None

    def _ev_Compare(self, node):
        self._ev(node.left)
        for c in node.comparators:
            self._ev(c)
        return None

    def _ev_BoolOp(self, node):
        out = None
        for v in node.values:
            o = self._ev(v)
            out = out or o
        return out

    def _ev_JoinedStr(self, node):
        for v in node.values:
            if isinstance(v, ast.FormattedValue):
                self._ev(v.value)
        return None

    def _ev_Lambda(self, node):
        return None                      # bodies run elsewhere

    def _ev_Call(self, node):
        name = _callee_name(node.func)
        argo = [self._ev(a) for a in node.args]
        for kw in node.keywords:
            self._ev(kw.value)

        # sinks first: a set-ordered value handed to hash/XDR/emit
        if _sink_call(name):
            for a, o in zip(node.args, argo):
                if o is not None and o[0] in ("set", "seq"):
                    where = o[1] if o[0] == "seq" else a.lineno
                    self._site(where, node.col_offset, "S1",
                               "set-ordered value feeds `%s(...)` — "
                               "sort it first" % name)
        # *-unpack of a set straight into any call's positional args
        # (sink callees already reported it through the arg check above)
        for a in node.args:
            if isinstance(a, ast.Starred) and not _sink_call(name):
                o = self._ev(a.value)
                if o is not None and o[0] in ("set", "seq"):
                    self._site(a.lineno, node.col_offset, "S1",
                               "*-unpack of a set into `%s(...)` — "
                               "sort it first" % (name or "call"))

        if name in ("set", "frozenset"):
            return _SET
        if name == "sorted" or name in _ORDER_INSENSITIVE:
            return None
        if name == "float":
            return _FLOAT
        if name in _ORDER_PRESERVING:
            if argo and argo[0] is not None and argo[0][0] == "set":
                return ("seq", node.lineno, "%s() of a set" % name)
            if argo and argo[0] is not None and argo[0][0] == "seq":
                return argo[0]
            return None
        if name == "fromkeys" and argo:
            if argo[0] is not None and argo[0][0] in ("set", "seq"):
                return _SET
            return None
        if isinstance(node.func, ast.Attribute):
            recv = self._ev(node.func.value)
            if recv is not None and recv[0] == "set":
                if name in _SET_METHODS:
                    return _SET
                if name in ("keys", "values", "items"):
                    return _SET
                if name == "pop":
                    return ("seq", node.lineno,
                            "set.pop() (arbitrary element)")
            if name == "join" and argo:
                o = argo[0]
                if o is not None and o[0] == "set":
                    return ("seq", node.lineno, "join() over a set")
                if o is not None and o[0] == "seq":
                    return o
        # module-local helper hop (bare f() or self.f())
        fn = self.facts.functions.get(name) if name else None
        if fn is not None and (isinstance(node.func, ast.Name) or
                               (isinstance(node.func, ast.Attribute) and
                                isinstance(node.func.value, ast.Name) and
                                node.func.value.id == "self")):
            if fn.returns_set:
                return _SET
            if fn.returns_float:
                return _FLOAT
        return None


# --------------------------------------------------------------------------
# Rules


def _subdir(path: str, package_name: str) -> str:
    parts = path.split("/")
    try:
        return parts[parts.index(package_name) + 1]
    except (ValueError, IndexError):
        return parts[0] if len(parts) > 1 else ""


def rule_s1_set_order(flow: FlowFacts, s1_dirs: Sequence[str],
                      package_name: str) -> List[Finding]:
    """S1: set-ordered iteration feeding hashing/serialization/emission/
    returned collections in consensus-critical packages."""
    if _subdir(flow.path, package_name) not in s1_dirs:
        return []
    return [Finding("S1", flow.path, line, qual, msg)
            for (line, qual, msg) in sorted(flow.s1_sites)]


def rule_fl1_float(flow: FlowFacts, fl1_dirs: Sequence[str],
                   package_name: str) -> List[Finding]:
    """FL1: float arithmetic / float-typed returns in replicated-state
    packages. Telemetry paths earn allowlist lines, not exemptions."""
    if _subdir(flow.path, package_name) not in fl1_dirs:
        return []
    return [Finding("FL1", flow.path, line, qual, msg)
            for (line, qual, msg) in sorted(flow.fl1_sites)]


def discover_longlived(all_flow: Sequence[FlowFacts],
                       roots: Sequence[str]) -> Dict[str, ClassFlow]:
    """Transitive closure of subsystem classes constructed (directly or
    through intermediates) during Application/Herder/OverlayManager/
    LedgerManager setup — name-resolved package-wide, the T1 stance."""
    by_name: Dict[str, ClassFlow] = {}
    for flow in all_flow:
        for cf in flow.classes:
            by_name.setdefault(cf.name, cf)
    out: Dict[str, ClassFlow] = {}
    frontier = [r for r in roots if r in by_name]
    while frontier:
        name = frontier.pop()
        if name in out:
            continue
        cf = by_name[name]
        out[name] = cf
        for ctor in cf.constructed.values():
            if ctor in by_name and ctor not in out:
                frontier.append(ctor)
    return out


def rule_b1_bounded_structs(all_flow: Sequence[FlowFacts],
                            roots: Sequence[str],
                            footprint_path: str) -> List[Finding]:
    """B1: long-lived subsystem containers grown from runtime handlers
    must be bounded by construction, carry cap/eviction logic, or be
    enrolled in the footprint census; and every `track_struct(...)`
    enrollment must still reference a live instance attribute."""
    path_of: Dict[str, str] = {}
    enrolled_attrs: Set[str] = set()
    known_attrs: Set[str] = set()
    track_calls: List[Tuple[str, int, str, str, frozenset]] = []
    for flow in all_flow:
        known_attrs |= flow.self_attrs | flow.defined_names
        for (line, qual, name, refs) in flow.track_calls:
            enrolled_attrs |= refs
            track_calls.append((flow.path, line, qual, name, refs))
        for cf in flow.classes:
            path_of.setdefault(cf.name, flow.path)

    longlived = discover_longlived(all_flow, roots)
    out: List[Finding] = []
    for name in sorted(longlived):
        cf = longlived[name]
        path = path_of.get(name, footprint_path)
        for attr in sorted(cf.containers):
            kind, bounded, line = cf.containers[attr]
            if bounded:
                continue
            growths = [(m, op, ln) for (m, a, op, ln) in cf.growths
                       if a == attr and m not in _SETUP_METHODS]
            if not growths:
                continue
            if attr in cf.caps:
                continue
            if attr in enrolled_attrs:
                continue
            m, op, _ln = growths[0]
            out.append(Finding(
                "B1", path, line, "%s.__init__" % cf.qualname,
                "unbounded %s `self.%s` on long-lived %s grows in "
                "handler `%s` (%s) with no cap/eviction — bound it "
                "(deque maxlen / LRUCache / explicit cap) or enroll it "
                "in the footprint census via track_struct(...)"
                % (kind, attr, name, m, op)))
    for (path, line, qual, name, refs) in sorted(track_calls):
        if not (refs & known_attrs):
            out.append(Finding(
                "B1", path, line, qual,
                "track_struct enrollment %r references no live "
                "attribute — the enrolled structure was removed or "
                "renamed; fix or drop the enrollment" % name))
    return out
