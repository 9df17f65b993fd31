"""What the benchmark may load: no module of JAX or of the JAX package (a
prefix of the port's name, so names are compared whole), nothing of the
port in the reference, and no file of the JAX package's benchmark."""

import ast
import os
import subprocess
import sys

from portbench.run import FORBIDDEN_MODULES, forbidden_loaded
from portbench.tests.conftest import REPO

PB = os.path.join(REPO, "portbench")
PORT = "stellar_core_tpu_torch"
# the yardstick: the reference, the generators' encoder and signer, the
# trace and roofline arithmetic, and the control
YARDSTICK = ("yardstick", "control.py")


def _sources():
    for d, _dirs, files in os.walk(PB):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    assert "stellar_core_tpu" in FORBIDDEN_MODULES
    for path in _sources():
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN_MODULES, (path, name)


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources():
        rel = os.path.relpath(path, PB)
        if rel.startswith(YARDSTICK):
            for name in _imports(path):
                assert name.split(".")[0] != PORT, (rel, name)


def test_no_source_reads_the_jax_packages_benchmark():
    for path in _sources():
        if os.path.basename(path) == os.path.basename(__file__):
            continue
        with open(path) as fh:
            text = fh.read()
        for word in ("bench.py", "bench/", "BENCH_", "MULTICHIP_"):
            assert word not in text.replace("portbench/", ""), (path, word)


def test_the_reference_loads_without_the_port():
    code = ("import sys; import portbench.yardstick.ed25519_ref, "
            "portbench.yardstick.xdr, portbench.yardstick.signer, "
            "portbench.control, portbench.run; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    tops = eval(out)
    assert PORT not in tops
    assert not set(tops) & set(FORBIDDEN_MODULES)


def test_a_run_loads_neither_jax_nor_the_jax_package(small_root):
    code = ("import json, sys; from portbench.run import run_cell, "
            "forbidden_loaded; r = run_cell(sys.argv[1], "
            "'catchup-verify.pubnet', 5, 1.0, True, backend='cpu-resilient');"
            " print(json.dumps([r['correct'], forbidden_loaded()]))")
    out = subprocess.run([sys.executable, "-c", code, small_root], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[true, []]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "stellar_core_tpu_torch_extra", sys)
    assert "stellar_core_tpu_torch_extra" not in forbidden_loaded()
    monkeypatch.setitem(sys.modules, "stellar_core_tpu.fake", sys)
    assert "stellar_core_tpu.fake" in forbidden_loaded()
