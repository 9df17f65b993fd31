"""Runs a reference test module's cases on both packages from one source.

`Mirror(files)` executes each named `tests/` module twice: as written
(the `ref` side, on `stellar_core_tpu`) and with every `stellar_core_tpu`
import pointed at `stellar_core_tpu_torch` (the `port` side). Each side's
modules are registered under a side prefix, so a module that imports
another of the set (`from test_scp_ballot_vectors import ...`) gets the
same side's copy. `@pytest.fixture` decorators become plain functions
(keeping their `params`), and a case's fixtures are called by name from
its own module (or taken from the pytest fixtures the caller passes, such
as `tmp_path`), once a case each, as pytest shares them.

Cases are the module's `test_` functions and the `test_` methods of its
`Test*` classes that pytest collects (no `__init__`; the method runs on a
fresh instance), one case for every combination of the test's
`parametrize` marks and of the `params` of the fixtures it reaches; a
fixture that takes `request` gets its param as `request.param`.
`Mirror(files, sides=("port",))` builds the port side alone: it reads the
reference's source as text and imports neither `stellar_core_tpu` nor
`jax`, so a machine without either (the card's host) can run the
reference's cases on the port. `port_cases(file)` is the one-module form
of that rewrite, fixtures left as pytest's.

A side's `hook(side, pkg, mods, log)` swaps names in its modules for
recording subclasses once, at load; `patch(pkg, log)`, where given, is a
context manager entered around each run, for recorders that must reach
classes a case imports inside its own body (`record_calls`). `run`
clears the side's `log`, reseeds the side's global RNG (as the suite's
conftest reseeds the reference's before every test), runs the case and
returns what the recorders appended. A test holds the two logs equal.
`port_subs` rewrite the port side alone (`torch_sim_harness.SIM_SUBS`
names the CPU where the port's default is the card). A run that silences
logging for the process (the reference's `fuzz` command) is undone after
it, so the cases after it on the same worker still log.
"""

import contextlib
import inspect
import itertools
import logging
import os
import re
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"ref": "stellar_core_tpu", "port": "stellar_core_tpu_torch"}
SEED = 0xFEEDFACE     # tests/conftest.py's per-test reseed


def _source(test_file: str, pkg: str) -> tuple:
    """(path, source) of `tests/<test_file>` with every `stellar_core_tpu`
    import pointed at `pkg`."""
    path = os.path.join(REPO, "tests", test_file)
    with open(path) as fh:
        src = fh.read()
    return path, re.sub(r"\bstellar_core_tpu\b", pkg, src)


def _exec(name: str, path: str, src: str) -> types.ModuleType:
    mod = types.ModuleType(name)
    mod.__file__ = path
    mod._mirror_fixture = _mirror_fixture
    sys.modules[name] = mod
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def port_cases(test_file: str, drop=()) -> types.ModuleType:
    """A reference test module's source with every `stellar_core_tpu`
    import pointed at the port (lines matching a pattern of `drop`
    removed), executed as a module of its own."""
    path, src = _source(test_file, PACKAGES["port"])
    src = "\n".join(ln for ln in src.split("\n")
                    if not any(re.search(d, ln) for d in drop))
    return _exec("port_" + test_file[:-3], path, src)


class Mirror:
    def __init__(self, files, hook=None, patch=None, subs=(),
                 siblings=(), port_subs=(), sides=("ref", "port")) -> None:
        """`subs`: (pattern, replacement) pairs applied to both sides'
        source after the package rewrite, `{pkg}` in a replacement
        naming the side's package; `port_subs`: pairs applied to the
        port side's source alone, after `subs`; `siblings`: module names
        the files import from each other; `sides`: the sides to build."""
        if "ref" in sides:
            import torch_threads  # noqa: F401  (one intra-op thread a worker)
        self.files = tuple(files)
        self.patch = patch
        self.sides = {}
        for side in sides:
            pkg = PACKAGES[side]
            prefix = "_mirror_%s_" % side
            log: list = []
            mods = {}
            for f in self.files:
                path, src = _source(f, pkg)
                src = re.sub(r"@pytest\.fixture\b", "@_mirror_fixture", src)
                for pat, rep in tuple(subs) + (tuple(port_subs)
                                        if side == "port" else ()):
                    src = re.sub(pat, rep.replace("{pkg}", pkg), src)
                for sib in siblings:
                    src = re.sub(r"\bfrom %s import" % sib,
                                 "from %s%s import" % (prefix, sib), src)
                mods[f] = _exec(prefix + f[:-3], path, src)
            if hook is not None:
                hook(side, pkg, mods, log)
            self.sides[side] = {"pkg": pkg, "mods": mods, "log": log}

    def cases(self, drop=(), drop_fixtures=()) -> list:
        """(file, test name, parameter indices or None) for every test of
        the first side not named in `drop` (a class's tests as
        `Class.test_name`) and taking none of the fixtures named in
        `drop_fixtures`, each parametrize mark and parametrised fixture
        expanded."""
        out = []
        first = next(iter(self.sides.values()))
        for f, mod in first["mods"].items():
            for name in _test_names(mod):
                if name in drop:
                    continue
                fn = _unbound(mod, name)
                if any(p in _args(fn) for p in drop_fixtures):
                    continue
                marks = _parametrize_marks(fn)
                fixtures = _param_fixtures(mod, fn, marks)
                sizes = [len(m.args[1]) for m in marks] + \
                    [len(getattr(mod, x)._mirror_params) for x in fixtures]
                if not sizes:
                    out.append((f, name, None))
                    continue
                for idx in itertools.product(*(range(n) for n in sizes)):
                    out.append((f, name, idx))
        return out

    @staticmethod
    def case_id(case) -> str:
        f, name, idx = case
        tail = "" if idx is None else "-" + "-".join(map(str, idx))
        return "%s::%s%s" % (f[5:-3], name, tail)

    def run(self, side: str, case, builtins=None) -> list:
        f, name, idx = case
        s = self.sides[side]
        mod = s["mods"][f]
        unbound = _unbound(mod, name)
        marks = _parametrize_marks(unbound)
        fixtures = _param_fixtures(mod, unbound, marks)
        kwargs = {}
        params = {}
        if idx is not None:
            for m, i in zip(marks, idx):
                names = _argnames(m)
                val = m.args[1][i]
                if hasattr(val, "values"):        # pytest.param(...)
                    vals = val.values
                else:
                    vals = (val,) if len(names) == 1 else val
                kwargs.update(zip(names, vals))
            for x, i in zip(fixtures, idx[len(marks):]):
                val = getattr(mod, x)._mirror_params[i]
                params[x] = val.values[0] if hasattr(val, "values") else val
        __import__(s["pkg"] + ".util.rnd", fromlist=["g_random"]) \
            .g_random.seed(SEED)
        del s["log"][:]
        silenced = logging.root.manager.disable
        teardown = []
        patch = self.patch(s["pkg"], s["log"]) if self.patch is not None \
            else contextlib.nullcontext()
        try:
            with patch:
                fn = _bound(mod, name)
                done = dict(builtins or {})
                for p in inspect.signature(fn).parameters:
                    if p not in kwargs:
                        kwargs[p] = _fixture(mod, p, done, teardown, params)
                fn(**kwargs)
        finally:
            for gen in reversed(teardown):
                next(gen, None)
            logging.disable(silenced)
        return list(s["log"])


@contextlib.contextmanager
def record_calls(log: list, targets):
    """While entered, each (class, method name, summarise) of `targets`
    appends `(method name, summarise(result, *args))` to `log` after
    every call; the methods are restored on exit."""
    saved = []
    for cls, name, summarise in targets:
        orig = cls.__dict__[name]

        def wrapper(*a, _orig=orig, _name=name, _sum=summarise, **kw):
            out = _orig(*a, **kw)
            log.append((_name, _sum(out, *a, **kw)))
            return out

        saved.append((cls, name, orig))
        setattr(cls, name, wrapper)
    try:
        yield
    finally:
        for cls, name, orig in reversed(saved):
            setattr(cls, name, orig)


def _mirror_fixture(fn=None, *, params=None, **_kw):
    """`pytest.fixture` in a mirrored module: the function itself, its
    `params` kept as `_mirror_params`."""
    def mark(f):
        f._mirror_params = list(params) if params is not None else None
        return f
    return mark(fn) if callable(fn) else mark


def _test_names(mod) -> list:
    """The tests pytest collects from `mod`, in name order: `test_`
    functions, then `Class.test_` for each `Test*` class defined there
    without an `__init__`."""
    out = sorted(n for n in vars(mod) if n.startswith("test_")
                 and callable(getattr(mod, n)))
    for cname in sorted(vars(mod)):
        cls = getattr(mod, cname)
        if not (cname.startswith("Test") and isinstance(cls, type)
                and cls.__module__ == mod.__name__
                and getattr(cls, "__test__", True)
                and cls.__init__ is object.__init__):
            continue
        out.extend("%s.%s" % (cname, n) for n in sorted(dir(cls))
                   if n.startswith("test_") and callable(getattr(cls, n)))
    return out


def _unbound(mod, name: str):
    owner, _, meth = name.rpartition(".")
    return getattr(getattr(mod, owner), meth) if owner else getattr(mod, name)


def _bound(mod, name: str):
    owner, _, meth = name.rpartition(".")
    return getattr(getattr(mod, owner)(), meth) if owner \
        else getattr(mod, name)


def _args(fn) -> list:
    params = list(inspect.signature(fn).parameters)
    return params[1:] if params[:1] == ["self"] else params


def _param_fixtures(mod, fn, marks) -> list:
    """The fixtures with `params` that `fn` reaches, depth first, not
    counting arguments its parametrize marks give."""
    given = {n for m in marks for n in _argnames(m)}
    out, seen = [], set()

    def walk(names):
        for n in names:
            if n in given or n in seen:
                continue
            seen.add(n)
            fx = getattr(mod, n, None)
            if fx is None or not hasattr(fx, "_mirror_params"):
                continue
            walk(_args(fx))
            if fx._mirror_params is not None:
                out.append(n)
    walk(_args(fn))
    return out


def _argnames(mark) -> list:
    names = mark.args[0]
    return [n.strip() for n in names.split(",")] \
        if isinstance(names, str) else list(names)


def _parametrize_marks(fn) -> list:
    return [m for m in getattr(fn, "pytestmark", [])
            if m.name == "parametrize"]


def _fixture(mod, name: str, done: dict, teardown: list, params: dict):
    """The value of fixture `name` for one case: `done` holds the values
    already made (and the caller's builtins), so a fixture two others take
    is made once, as pytest makes it."""
    if name in done:
        return done[name]
    fn = getattr(mod, name)
    args = {}
    for p in inspect.signature(fn).parameters:
        args[p] = types.SimpleNamespace(param=params.get(name)) \
            if p == "request" else _fixture(mod, p, done, teardown, params)
    out = fn(**args)
    if inspect.isgenerator(out):
        teardown.append(out)
        out = next(out)
    done[name] = out
    return out
