"""What the mirrors of the reference's node-level tests share: the records
each side's node leaves, and the source rewrites that keep the port's
nodes on the CPU.

`node_records(pkg, log)` is a `torch_mirror_harness.Mirror` patch. While
it is entered, every admin command (`CommandHandler.handle_command`:
name, HTTP status and the body's shape, see `shape`), every close
(`LedgerManager.value_externalized`: the new LCL's sequence and hash),
every transaction admission (`Herder.recv_transaction`: its status) and
every transaction a `TestLedger` applies (`apply_frame`: whether it
succeeded) is appended to the side's log; on the port's side the port's
thread-discipline checks are armed for the case, as `tests/conftest.py`
arms the reference's around every test. `shape` keeps a body's keys and
the types of its leaves, so times and rates that differ between two runs
leave the record alone while a missing or extra field does not. One
deliberate difference of the port is taken out of the bodies before:
a close without a bucket list hashes its stand-in bucket-list hash
through the node's hasher (`ledger/ledger_manager.py`), where the
reference hashes it on the host, so the port's hasher counts drains at
the site "other" (`hasher.site.other.*` in `metrics`, `sites.other` in
`hasher`).

`CPU_TOML` rewrites a reference test's TOML configs to name the CPU for
both backends (the port's `Config` defaults them to the card's stack);
the reference reads the same two lines as its own defaults.
"""

import contextlib
import functools

from torch_mirror_harness import record_calls

# a TOML line list or string the reference's CLI tests write, extended by
# the two backend knobs (both sides accept them; "cpu" is the
# reference's default and the port's CPU stack)
CPU_TOML = (
    (r"'UNSAFE_QUORUM = true',",
     r"""'UNSAFE_QUORUM = true', 'SIG_VERIFY_BACKEND = "cpu"', """
     r"""'HASH_BACKEND = "cpu"',"""),
    (r"""'NODE_SEED = "%s"\\n'""",
     r"""'NODE_SEED = "%s"\\n' 'SIG_VERIFY_BACKEND = "cpu"\\n' """
     r"""'HASH_BACKEND = "cpu"\\n'"""),
)


# the port side's rewrites of the CLI cases whose reference commands read
# no config (`simulate` without `--conf`, `gen-fuzz` and `fuzz`, which
# take none there): each gets `--conf` naming the CPU (`cpu_conf`), and
# the `simulate` and `fuzz` outputs are read from their first line (the
# port's commands print their launch counts on a second)
CLI_CPU_CONF = (
    (r'cli_main\(\["(simulate|gen-fuzz|fuzz)", ',
     r'cli_main(["\1", "--conf", __import__("torch_main_harness")'
     r'.cpu_conf(), '),
    (r'(cli_main\(\["(?:simulate|fuzz)",[^\n]*\n\s*out = json\.loads\('
     r'capsys\.readouterr\(\)\.out)\)',
     r'\1.splitlines()[0])'),
)


@functools.lru_cache(maxsize=None)
def cpu_conf() -> str:
    """A TOML config naming the CPU for both backends, with a node seed
    (a config file needs one), written once in a directory of its own;
    its path."""
    import os
    import tempfile
    from stellar_core_tpu_torch.crypto import strkey
    d = tempfile.mkdtemp(prefix="sct-cpu-conf-")
    path = os.path.join(d, "cpu.toml")
    with open(path, "w") as fh:
        fh.write('SIG_VERIFY_BACKEND = "cpu"\nHASH_BACKEND = "cpu"\n'
                 'NODE_SEED = "%s"\n' % strkey.encode_seed(b"\x07" * 32))
    return path


def shape(body, depth: int = 0):
    """A body's structure: dict keys (sorted) with their values' shapes,
    a list's first element's shape, and a leaf's type name (int and float
    read as one "number": a mean is 0 on one side and 0.25 on the
    other)."""
    if depth > 8:
        return "..."
    if isinstance(body, dict):
        return {str(k): shape(v, depth + 1) for k, v in sorted(
            body.items(), key=lambda kv: str(kv[0]))}
    if isinstance(body, (list, tuple)):
        return [shape(body[0], depth + 1)] if body else []
    if isinstance(body, bool) or body is None:
        return type(body).__name__
    if isinstance(body, (int, float)):
        return "number"
    if isinstance(body, str):
        return "str" if depth else body.splitlines()[:1]
    return type(body).__name__


def _without_port_sites(name, body):
    """The body less the port's stand-in hash drains (module
    docstring)."""
    if name == "metrics" and isinstance(body, dict):
        return {k: v for k, v in body.items()
                if not k.startswith("hasher.site.other.")}
    if name == "hasher" and isinstance(body, dict) and \
            "other" in body.get("sites", {}):
        body = dict(body, sites={k: v for k, v in body["sites"].items()
                                 if k != "other"})
    return body


def cpu_test_ledger(side, pkg, mods, log) -> None:
    """A `Mirror` hook: on the port's side, every module's `TestLedger`
    verifies on the host (the port's `TestLedger()` verifies on the card
    unless handed a verifier; the reference's on the host)."""
    if side != "port":
        return
    testing = __import__(pkg + ".testing", fromlist=["x"])
    bv = __import__(pkg + ".crypto.batch_verifier", fromlist=["x"])

    class HostTestLedger(testing.TestLedger):
        __test__ = False

        def __init__(self, *a, **kw):
            if kw.get("verifier") is None and len(a) < 2:
                kw["verifier"] = bv.CpuSigVerifier()
            super().__init__(*a, **kw)

    for mod in mods.values():
        if getattr(mod, "TestLedger", None) is testing.TestLedger:
            mod.TestLedger = HostTestLedger


@contextlib.contextmanager
def node_records(pkg: str, log: list):
    ch = __import__(pkg + ".main.command_handler", fromlist=["x"])
    lm = __import__(pkg + ".ledger.ledger_manager", fromlist=["x"])
    hd = __import__(pkg + ".herder.herder", fromlist=["x"])
    testing = __import__(pkg + ".testing", fromlist=["x"])
    threads = __import__(pkg + ".util.threads", fromlist=["x"])
    targets = [
        (ch.CommandHandler, "handle_command",
         lambda out, _h, name, _p: (
             "cmd", name, out[0],
             shape(_without_port_sites(name, out[1])))),
        (lm.LedgerManager, "value_externalized",
         lambda out, m, _lcd: ("close", m.last_closed_ledger_num(),
                               m.lcl_hash.hex())),
        (hd.Herder, "recv_transaction",
         lambda out, *_a: ("tx", int(out))),
        (testing.TestLedger, "apply_frame",
         lambda out, *_a: ("apply", bool(out))),
    ]
    port = pkg.endswith("_torch")
    if port:
        threads.arm()
    try:
        with record_calls(log, targets):
            yield
    finally:
        if port:
            threads.disarm()
