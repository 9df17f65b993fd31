"""Import hygiene of the port: no module of `stellar_core_tpu_torch`, and
not `chip_smoke.py`, imports JAX or anything of the JAX package.

Two checks: every port module imported in a fresh interpreter leaves
neither `jax` nor a `stellar_core_tpu` module in `sys.modules`, and no
import statement in the port's sources (including the ones inside
functions, which an import-time check cannot reach) names them.
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
              "bucket.bucket_manager"):
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
