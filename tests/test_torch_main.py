"""The port's own rules for a node (`stellar_core_tpu_torch/main/`).

- `Config()` names the card's stack ("cuda-resilient") for both the
  verifier and the hasher; `Config.test_config()` names the CPU ("cpu").
- `Config.from_toml` refuses the reference's TPU backend names and names
  their counterparts.
- A node built from `Config()` where there is no card raises from its
  verifier's constructor: it never builds a CPU node in its place.
- A node of `test_config()` starts, serves `info` over `start_http(0)`
  and closes a ledger through `manualclose`, both over HTTP.
- `python -m stellar_core_tpu_torch version` and `gen-seed` print what the
  reference's commands print (for `gen-seed`, with the same random bytes).
- The operator's cycle through `python -m stellar_core_tpu_torch`, each
  step a process of its own on a TOML config that names the CPU: `new-db`,
  `force-scp`, `run` in the background (its admin API's `info`, a payment
  through `tx`, a close through `manualclose`), SIGINT (exit 0), `run`
  again from the same database (`info` at the same ledger, one more
  close), then `offline-info` after the stop. This is `chip_smoke.py`'s M1
  without the archive, on the CPU.
"""

import io
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from contextlib import redirect_stdout

import pytest
import torch

from stellar_core_tpu_torch.crypto import strkey
from stellar_core_tpu_torch.crypto.hashing import sha256
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.main.application import Application
from stellar_core_tpu_torch.main.config import Config
from stellar_core_tpu_torch.testing import AppLedgerAdapter
from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock

import torch_threads  # noqa: F401  (one intra-op thread a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONUNBUFFERED="1",
           PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


def test_config_defaults_name_the_card():
    cfg = Config()
    assert cfg.SIG_VERIFY_BACKEND == "cuda-resilient"
    assert cfg.HASH_BACKEND == "cuda-resilient"
    t = Config.test_config(0)
    assert (t.SIG_VERIFY_BACKEND, t.HASH_BACKEND) == ("cpu", "cpu")
    a = Config.test_config(0, backend="cuda-async")
    assert (a.SIG_VERIFY_BACKEND, a.HASH_BACKEND) == \
        ("cuda-async", "cuda-resilient")


@pytest.mark.parametrize("knob", ["SIG_VERIFY_BACKEND", "HASH_BACKEND"])
@pytest.mark.parametrize("name,counterpart", [
    ("tpu", "cuda-resilient"), ("tpu-async", "cuda-async")])
def test_from_toml_refuses_tpu_backends(knob, name, counterpart):
    seed = strkey.encode_seed(SecretKey.from_seed(sha256(b"n")).seed)
    with pytest.raises(ValueError, match=counterpart):
        Config.from_toml('NODE_SEED = "%s"\n%s = "%s"\n' % (seed, knob, name),
                         is_path=False)
    with pytest.raises(ValueError, match="not one of"):
        Config.from_toml('NODE_SEED = "%s"\n%s = "gpu"\n' % (seed, knob),
                         is_path=False)


def test_default_node_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: Config() builds the card's node")
    cfg = Config.test_config(0)
    cfg.SIG_VERIFY_BACKEND = Config().SIG_VERIFY_BACKEND
    cfg.HASH_BACKEND = Config().HASH_BACKEND
    with pytest.raises(RuntimeError, match="CUDA"):
        Application(VirtualClock(ClockMode.VIRTUAL_TIME), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Application(VirtualClock(ClockMode.VIRTUAL_TIME), Config())


def _get(port, path):
    with urllib.request.urlopen("http://127.0.0.1:%d/%s" % (port, path),
                                timeout=30) as r:
        assert r.status == 200
        return json.loads(r.read())


def test_cpu_node_serves_info_and_manualclose_over_http():
    cfg = Config.test_config(0)
    app = Application(VirtualClock(ClockMode.REAL_TIME), cfg)
    app.start()
    port = app.command_handler.start_http(0)
    out = {}

    def fetch():
        out["info"] = _get(port, "info")
        out["close"] = _get(port, "manualclose")

    import threading
    t = threading.Thread(target=fetch)
    t.start()
    deadline = time.monotonic() + 60
    while t.is_alive() and time.monotonic() < deadline:
        if app.crank(False) == 0:
            time.sleep(0.001)
    t.join(5)
    app.stop()
    assert out["info"]["ledger"]["num"] == 1
    assert out["info"]["state"] == "Synced!"
    assert out["close"] == {"status": "ok", "ledger": 2}
    assert app.ledger_manager.last_closed_ledger_num() == 2


def _cli(*args, check=True):
    p = subprocess.run([sys.executable, "-m", "stellar_core_tpu_torch"] +
                       list(args), cwd=REPO, env=ENV, capture_output=True,
                       text=True, timeout=300)
    if check:
        assert p.returncode == 0, p.stderr
    return p


def test_cli_version_and_gen_seed_match_reference(monkeypatch):
    from stellar_core_tpu.main.commandline import main as ref_main
    assert _cli("version").stdout.splitlines() == ["stellar-core-tpu 0.1"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert ref_main(["version"]) == 0
    assert buf.getvalue().splitlines() == ["stellar-core-tpu 0.1"]

    # gen-seed draws its seed from os.urandom: the same bytes on both
    fixed = "lambda n: bytes(range(7, 7 + n))"
    p = subprocess.run(
        [sys.executable, "-c",
         "import os, runpy, sys; os.urandom = %s; "
         "sys.argv = ['stellar_core_tpu_torch', 'gen-seed']; "
         "runpy.run_module('stellar_core_tpu_torch', run_name='__main__')"
         % fixed], cwd=REPO, env=ENV, capture_output=True, text=True,
        timeout=120)
    assert p.returncode == 0, p.stderr
    monkeypatch.setattr(os, "urandom", eval(fixed))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert ref_main(["gen-seed"]) == 0
    assert p.stdout == buf.getvalue()
    lines = p.stdout.splitlines()
    assert lines[0].startswith("Secret seed: S")
    assert lines[1].startswith("Public: G")
    # and a real draw: two lines of the same shape
    out = _cli("gen-seed").stdout.splitlines()
    assert [l.split(":")[0] for l in out] == ["Secret seed", "Public"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_for_port(proc, port, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.stderr.read()
        try:
            with socket.create_connection(("127.0.0.1", port), 0.5):
                return
        except OSError:
            time.sleep(0.1)
    raise AssertionError("admin port %d never opened" % port)


def _stop(proc):
    proc.send_signal(signal.SIGINT)
    try:
        rc = proc.wait(60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc


def test_cli_node_lifecycle(tmp_path):
    port = _free_port()
    sk = SecretKey.from_seed(sha256(b"cli-lifecycle"))
    conf = tmp_path / "node.toml"
    conf.write_text("\n".join([
        'DATABASE = "sqlite3://%s"' % (tmp_path / "node.db"),
        'BUCKET_DIR_PATH = "%s"' % (tmp_path / "buckets"),
        'NODE_SEED = "%s"' % strkey.encode_seed(sk.seed),
        'SIG_VERIFY_BACKEND = "cpu"', 'HASH_BACKEND = "cpu"',
        'RUN_STANDALONE = true', 'MANUAL_CLOSE = true',
        'UNSAFE_QUORUM = true', 'HTTP_PORT = %d' % port, ""]))
    out = _cli("new-db", "--conf", str(conf)).stdout
    assert out.startswith("new ledger: genesis ")
    assert _cli("force-scp", "--conf", str(conf)).stdout.strip() == \
        "force-scp set"

    # a payment from the network root, signed by the test's own frame
    cfg = Config.from_toml(str(conf))
    app = Application(VirtualClock(ClockMode.VIRTUAL_TIME), cfg)
    assert app.ledger_manager.load_last_known_ledger()
    root = AppLedgerAdapter(app).root_account()
    dest = SecretKey.from_seed(sha256(b"cli-lifecycle-dest")).public_key
    frame = root.tx([root.op_create_account(dest, 10**9)])
    del app, root

    def run_node():
        proc = subprocess.Popen(
            [sys.executable, "-m", "stellar_core_tpu_torch", "run",
             "--conf", str(conf)], cwd=REPO, env=ENV,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        _wait_for_port(proc, port)
        return proc

    proc = run_node()
    try:
        info = _get(port, "info")
        assert info["ledger"]["num"] == 1 and info["state"] == "Synced!"
        assert _get(port, "tx?blob=" + frame.envelope.to_xdr().hex()) == \
            {"status": "PENDING"}
        assert _get(port, "manualclose") == {"status": "ok", "ledger": 2}
        assert _get(port, "info")["ledger"]["num"] == 2
    finally:
        rc = _stop(proc)
    assert rc == 0, proc.stderr.read()

    proc = run_node()
    try:
        assert _get(port, "info")["ledger"]["num"] == 2
        assert _get(port, "manualclose")["ledger"] == 3
    finally:
        rc = _stop(proc)
    assert rc == 0, proc.stderr.read()
    info = json.loads(_cli("offline-info", "--conf", str(conf)).stdout)
    assert info["ledger"]["num"] == 3


def test_force_scp_flag_starts_scp_reference_fault(tmp_path):
    """A database flagged by `force-scp`, and a config without FORCE_SCP:
    the reference's `start` bootstraps the herder, whose bootstrap asserts
    FORCE_SCP, and dies; the port's sets FORCE_SCP from the flag first
    and starts synced (`main/application.py`'s header)."""
    from stellar_core_tpu.main.application import Application as RApp
    from stellar_core_tpu.main.config import Config as RConfig
    from stellar_core_tpu.util.timer import (
        ClockMode as RClockMode, VirtualClock as RVirtualClock,
    )
    apps = {}
    for side, App, Cfg, Clock, Mode in (
            ("ref", RApp, RConfig, RVirtualClock, RClockMode),
            ("port", Application, Config, VirtualClock, ClockMode)):
        cfg = Cfg.test_config(0)
        cfg.DATABASE = "sqlite3://%s" % (tmp_path / ("%s.db" % side))
        cfg.FORCE_SCP = False
        app = App(Clock(Mode.VIRTUAL_TIME), cfg)
        app.ledger_manager.start_new_ledger()
        app.persistent_state.set_force_scp(True)
        cfg2 = Cfg.test_config(0)
        cfg2.DATABASE = cfg.DATABASE
        cfg2.FORCE_SCP = False
        apps[side] = App(Clock(Mode.VIRTUAL_TIME), cfg2)
    with pytest.raises(AssertionError):
        apps["ref"].start()
    apps["port"].start()
    assert apps["port"].get_info()["state"] == "Synced!"
