"""Import hygiene of the port: no module of `stellar_core_tpu_torch`, and
not `chip_smoke.py`, imports JAX or anything of the JAX package.

Three checks, over every subpackage (the history and catchup slice's
`work`, `process`, `main`, `history`, `historywork` and `catchup` among
them, named in the first): every port module imported in a fresh interpreter leaves
neither `jax` nor a `stellar_core_tpu` module in `sys.modules`; no import
statement in the port's sources (including the ones inside functions,
which an import-time check cannot reach) names them; and every relative
import in the port's sources, inside functions too, resolves to a module
of `stellar_core_tpu_torch/` (a lazy import of a module the port lacks
fails only when its function first runs).
"""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "stellar_core_tpu_torch")


def _port_sources():
    for root, _dirs, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _module_names():
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)[:-3]
        if rel.endswith("__init__"):
            rel = rel[:-len("/__init__")]
        yield rel.replace(os.sep, ".")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "stellar_core_tpu")


def test_port_modules_import_no_jax():
    mods = sorted(_module_names())
    for m in ("ops.ed25519", "ops.sha256", "crypto.hashing",
              "crypto.batch_hasher", "ledger.state_commitment",
              "testing.entries", "parallel.mesh", "util.metrics",
              "util.tracing", "util.threads", "util.timer", "util.faults",
              "native", "crypto.batch_verifier", "util.log",
              "util.xdrstream", "util.tmpdir", "crypto.strkey",
              "crypto.keys", "xdr", "xdr.codec", "xdr.fastcodec",
              "xdr.basic", "xdr.ledger_entries", "xdr.transaction",
              "xdr.scp", "xdr.ledger", "xdr.overlay", "bucket",
              "bucket.bucket", "bucket.bucket_list",
              "bucket.bucket_manager",
              # the history and catchup slice
              "work", "work.basic_work", "work.work", "work.scheduler",
              "process", "process.process_manager", "main",
              "main.config", "main.persistent_state", "history",
              "history.checkpoints", "history.archive",
              "history.archive_state", "history.snapshot",
              "history.history_manager", "historywork",
              "historywork.works", "historywork.apply_works", "catchup",
              "catchup.range", "catchup.catchup_work",
              "catchup.catchup_manager", "util.status_manager"):
        assert "stellar_core_tpu_torch." + m in mods, m
    code = (
        "import importlib, sys\n"
        "for m in %r:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'stellar_core_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(%r))\n" % (mods, mods))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip() == str(len(mods))


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_names_no_jax_import(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, bad


def _module_file(parts) -> str:
    """The file of the port module `parts` (a list of names under the
    package root), or None."""
    base = os.path.join(PKG, *parts)
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.isfile(cand):
            return cand
    return None


def _defined_names(path: str) -> set:
    """Top-level names a module binds (defs, classes, assignments,
    imports)."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                out.update(n.id for n in ast.walk(t)
                           if isinstance(n, ast.Name))
    return out


@pytest.mark.parametrize("path", sorted(p for p in _port_sources()
                                        if p.startswith(PKG)),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_relative_imports_resolve(path):
    rel = os.path.relpath(path, PKG)[:-3].split(os.sep)
    pkg = rel[:-1]      # the package a module's relative imports start at
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    bad = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom) or node.level == 0:
            continue
        up = node.level - 1
        assert up <= len(pkg), (node.lineno, "import above the package")
        base = pkg[:len(pkg) - up]
        mod = base + (node.module.split(".") if node.module else [])
        f = _module_file(mod)
        if f is None:
            bad.append((node.lineno, ".".join(mod)))
            continue
        names = None
        for a in node.names:
            if a.name == "*" or _module_file(mod + [a.name]) is not None:
                continue
            if names is None:
                names = _defined_names(f)
            if a.name not in names:
                bad.append((node.lineno, ".".join(mod) + ":" + a.name))
    assert not bad, bad
