"""Runs a reference test module's cases on both packages from one source.

`Mirror(files)` executes each named `tests/` module twice: as written
(the `ref` side, on `stellar_core_tpu`) and with every `stellar_core_tpu`
import pointed at `stellar_core_tpu_torch` (the `port` side). Each side's
modules are registered under a side prefix, so a module that imports
another of the set (`from test_scp_ballot_vectors import ...`) gets the
same side's copy. `@pytest.fixture` decorators are stripped, and a case's
fixtures are called by name from its own module (or taken from the
pytest fixtures the caller passes, such as `tmp_path`).

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

import torch_threads  # noqa: F401  (one intra-op thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"ref": "stellar_core_tpu", "port": "stellar_core_tpu_torch"}
SEED = 0xFEEDFACE     # tests/conftest.py's per-test reseed


class Mirror:
    def __init__(self, files, hook=None, patch=None, subs=(),
                 siblings=(), port_subs=()) -> None:
        """`subs`: (pattern, replacement) pairs applied to both sides'
        source after the package rewrite, `{pkg}` in a replacement
        naming the side's package; `port_subs`: pairs applied to the
        port side's source alone, after `subs`; `siblings`: module names
        the files import from each other."""
        self.files = tuple(files)
        self.patch = patch
        self.sides = {}
        for side, pkg in PACKAGES.items():
            prefix = "_mirror_%s_" % side
            log: list = []
            mods = {}
            for f in self.files:
                path = os.path.join(REPO, "tests", f)
                with open(path) as fh:
                    src = fh.read()
                src = re.sub(r"\bstellar_core_tpu\b", pkg, src)
                src = re.sub(r"(?m)^@pytest\.fixture.*$", "", src)
                for pat, rep in tuple(subs) + (tuple(port_subs)
                                        if side == "port" else ()):
                    src = re.sub(pat, rep.replace("{pkg}", pkg), src)
                for sib in siblings:
                    src = re.sub(r"\bfrom %s import" % sib,
                                 "from %s%s import" % (prefix, sib), src)
                name = prefix + f[:-3]
                mod = types.ModuleType(name)
                mod.__file__ = path
                sys.modules[name] = mod
                exec(compile(src, path, "exec"), mod.__dict__)
                mods[f] = mod
            if hook is not None:
                hook(side, pkg, mods, log)
            self.sides[side] = {"pkg": pkg, "mods": mods, "log": log}

    def cases(self, drop=(), drop_fixtures=()) -> list:
        """(file, test name, parameter indices or None) for every test of
        the reference side not named in `drop` and taking none of the
        fixtures named in `drop_fixtures`, each parametrize mark
        expanded."""
        out = []
        for f, mod in self.sides["ref"]["mods"].items():
            for name in sorted(n for n in vars(mod)
                               if n.startswith("test_") and n not in drop
                               and callable(getattr(mod, n))):
                params = inspect.signature(getattr(mod, name)).parameters
                if any(p in params for p in drop_fixtures):
                    continue
                marks = _parametrize_marks(getattr(mod, name))
                if not marks:
                    out.append((f, name, None))
                    continue
                for idx in itertools.product(
                        *(range(len(m.args[1])) for m in marks)):
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
        fn = getattr(mod, name)
        kwargs = {}
        if idx is not None:
            for m, i in zip(_parametrize_marks(fn), idx):
                names = [n.strip() for n in m.args[0].split(",")] \
                    if isinstance(m.args[0], str) else list(m.args[0])
                val = m.args[1][i]
                if hasattr(val, "values"):        # pytest.param(...)
                    vals = val.values
                else:
                    vals = (val,) if len(names) == 1 else val
                kwargs.update(zip(names, vals))
        __import__(s["pkg"] + ".util.rnd", fromlist=["g_random"]) \
            .g_random.seed(SEED)
        del s["log"][:]
        silenced = logging.root.manager.disable
        teardown = []
        patch = self.patch(s["pkg"], s["log"]) if self.patch is not None \
            else contextlib.nullcontext()
        try:
            with patch:
                for p in inspect.signature(fn).parameters:
                    if p not in kwargs:
                        kwargs[p] = _fixture(mod, p, builtins or {},
                                             teardown)
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


def _parametrize_marks(fn) -> list:
    return [m for m in getattr(fn, "pytestmark", [])
            if m.name == "parametrize"]


def _fixture(mod, name: str, builtins: dict, teardown: list):
    if name in builtins:
        return builtins[name]
    fn = getattr(mod, name)
    args = {p: _fixture(mod, p, builtins, teardown)
            for p in inspect.signature(fn).parameters}
    out = fn(**args)
    if inspect.isgenerator(out):
        teardown.append(out)
        out = next(out)
    return out
