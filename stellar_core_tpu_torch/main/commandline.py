"""Command-line interface.

Copied from `stellar_core_tpu/main/commandline.py` at commit bb973b8;
carry a fix in either copy to the other. Nothing is left out.
`print-xdr` and `dump-xdr` read the port's `xdr` types, and `test` runs
the port's own tests (`tests/test_torch_*.py`).

Deliberately different:

- `catchup`, `simulate` and `fuzz` print a second line after the
  reference's: the process's verify and hash launch counts
  (`CommandHandler.launch_counters`, one entry per node a `fuzz` run
  built), since the process ends before an operator could ask its admin
  API. `simulate`'s also holds the last closed ledger's hash. Each waits
  for its nodes' kernel warmups first, so its counts are whole.
- `fuzz` and `gen-fuzz` take `--conf` (the reference's take none) and
  fuzz on its SIG_VERIFY_BACKEND, the card's stack unless the file names
  the CPU (`main/fuzz.py`).
- `simulate` stops its node and removes its temporary bucket directory
  as it exits (the reference leaves both), and keeps the virtual clock at
  least at the LCL's close time while it funds its senders: the
  reference's funding closes never move the clock, so past about 60
  senders the nominated close time (the LCL's + 1) runs more than the
  herder's 60 s slip ahead of it and the funding transaction never
  closes (ROADMAP Queue 3 item 12). After the funding it moves the clock
  to where the reference's stands, so the close times, and every hash,
  are the reference's wherever the reference closes.
- `fuzz` silences logging below ERROR only while it runs: the
  reference's `logging.disable(logging.ERROR)` stays in force after the
  command returns, so a caller in the same process (a test, an embedding
  program) loses every later warning (ROADMAP Queue 3 item 13).

Role parity: reference `src/main/CommandLine.cpp:1039-1093` — subcommand
dispatch for node operation (`run`, `new-db`, `force-scp`, `catchup`,
`publish`, `offline-info`), key tooling (`gen-seed`, `sec-to-pub`,
`convert-id`, `sign-transaction`), debugging (`print-xdr`, `dump-xdr`,
`http-command`), and `version`. Invoked via
`python -m stellar_core_tpu_torch <command>`; a node started with no
backend named verifies and hashes on the card (`main/config.py`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from ..util.timer import ClockMode, VirtualClock
from .config import Config


def _load_config(args) -> Config:
    if getattr(args, "conf", None):
        cfg = Config.from_toml(args.conf)
    else:
        cfg = Config()
    return cfg


def _make_app(cfg: Config, real_time: bool = True):
    from .application import Application
    clock = VirtualClock(ClockMode.REAL_TIME if real_time
                         else ClockMode.VIRTUAL_TIME)
    app = Application(clock, cfg)
    app.enable_buckets()
    return app


# -- commands ----------------------------------------------------------------

def cmd_run(args) -> int:
    """Run a node (reference `run` → ApplicationUtils::runWithConfig)."""
    cfg = _load_config(args)
    app = _make_app(cfg)
    app.start()
    app.command_handler.start_http()
    print("node %s up; admin API on port %d"
          % (cfg.NODE_SEED.public_key.key_bytes.hex()[:8]
             if cfg.NODE_SEED else "?", cfg.HTTP_PORT))
    try:
        while True:
            if app.crank(False) == 0:
                time.sleep(0.001)
    except KeyboardInterrupt:
        app.stop()
    return 0


def cmd_new_db(args) -> int:
    """Reset the DB to genesis (reference `new-db`)."""
    cfg = _load_config(args)
    app = _make_app(cfg, real_time=False)
    app.ledger_manager.start_new_ledger()
    print("new ledger: genesis %s"
          % app.ledger_manager.lcl_hash.hex())
    return 0


def cmd_force_scp(args) -> int:
    """Set/clear the DB flag that makes the next `run` start SCP
    immediately from the LCL (reference `force-scp`)."""
    cfg = _load_config(args)
    app = _make_app(cfg, real_time=False)
    if app.persistent_state is None:
        print("force-scp needs a persistent database", file=sys.stderr)
        return 1
    app.persistent_state.set_force_scp(not args.reset)
    print("force-scp %s" % ("cleared" if args.reset else "set"))
    return 0


def cmd_catchup(args) -> int:
    """Offline catchup `<to>/<count>` (reference `catchup`)."""
    from ..catchup import CURRENT, CatchupConfiguration
    from ..work.basic_work import State
    cfg = _load_config(args)
    app = _make_app(cfg)
    app.start()
    spec = args.destination
    to_s, _, count_s = spec.partition("/")
    to = CURRENT if to_s == "current" else int(to_s)
    count = CURRENT if count_s in ("", "max") else int(count_s)
    work = app.catchup_manager.start_catchup(
        CatchupConfiguration(to, count))
    if work is None:
        print("no readable history archive configured", file=sys.stderr)
        return 1
    while not work.is_done():
        if app.crank(False) == 0:
            time.sleep(0.001)
    print("catchup %s at ledger %d"
          % (work.state.name,
             app.ledger_manager.last_closed_ledger_num()))
    print("catchup launches %s"
          % json.dumps(app.command_handler.launch_counters(),
                       sort_keys=True))
    return 0 if work.state == State.SUCCESS else 1


def cmd_publish(args) -> int:
    """Publish any queued checkpoints (reference `publish`)."""
    cfg = _load_config(args)
    app = _make_app(cfg)
    app.ledger_manager.load_last_known_ledger()
    n = app.history_manager.publish_queued_history()
    print("published %d checkpoint(s)" % n)
    return 0


def cmd_new_hist(args) -> int:
    """Initialize a history archive with the genesis HAS (reference
    `new-hist`)."""
    cfg = _load_config(args)
    app = _make_app(cfg, real_time=False)
    app.ledger_manager.start_new_ledger()
    hm = app.history_manager
    ok = True
    for name in args.archives:
        arch = hm.archives.get(name)
        if arch is None or not arch.has_put():
            print("archive %r not configured/writable" % name,
                  file=sys.stderr)
            ok = False
            continue
        from ..history.archive import WELL_KNOWN
        from ..history.archive_state import HistoryArchiveState
        import tempfile, os
        # initializing an EXISTING history store must fail (reference
        # HistoryTests.cpp:1221 "initialize existing history store fails")
        fd, probe = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            exists = arch.has_get() and \
                arch.get_file_sync(WELL_KNOWN, probe) and \
                os.path.getsize(probe) > 0
        finally:
            os.unlink(probe)
        if exists:
            print("archive %r already initialized; refusing to overwrite"
                  % name, file=sys.stderr)
            ok = False
            continue
        has = HistoryArchiveState(
            app.ledger_manager.last_closed_ledger_num())
        with tempfile.NamedTemporaryFile("w", suffix=".json",
                                         delete=False) as f:
            f.write(has.to_json())
        if arch.put_file_sync(f.name, WELL_KNOWN):
            print("initialized archive %s" % name)
        else:
            ok = False
        os.unlink(f.name)
    return 0 if ok else 1


def cmd_offline_info(args) -> int:
    cfg = _load_config(args)
    app = _make_app(cfg, real_time=False)
    app.ledger_manager.load_last_known_ledger()
    print(json.dumps(app.get_info(), indent=2))
    return 0


def cmd_gen_seed(args) -> int:
    """Generate a random node seed (reference `gen-seed`)."""
    import os as _os
    from ..crypto.keys import SecretKey
    from ..crypto import strkey
    sk = SecretKey.from_seed(_os.urandom(32))
    print("Secret seed:", strkey.encode_seed(sk.seed))
    print("Public:", strkey.encode_public_key(sk.public_key.key_bytes))
    return 0


def cmd_sec_to_pub(args) -> int:
    """Print the public key for a secret seed read from stdin
    (reference `sec-to-pub`)."""
    from ..crypto.keys import SecretKey
    from ..crypto import strkey
    seed = (args.seed or sys.stdin.readline().strip())
    sk = SecretKey.from_seed(strkey.decode_seed(seed))
    print(strkey.encode_public_key(sk.public_key.key_bytes))
    return 0


def cmd_convert_id(args) -> int:
    """Display an identifier in all known forms (reference
    `convert-id`)."""
    from ..crypto import strkey
    s = args.id
    out = {}
    try:
        raw = strkey.decode_public_key(s)
        out = {"type": "public_key", "strkey": s, "hex": raw.hex()}
    except Exception:
        try:
            raw = bytes.fromhex(s)
            out = {"type": "hex", "hex": s,
                   "strkey": strkey.encode_public_key(raw)}
        except ValueError:
            print("unrecognized id %r" % s, file=sys.stderr)
            return 1
    print(json.dumps(out, indent=2))
    return 0


def cmd_sign_transaction(args) -> int:
    """Add a signature to a transaction envelope read from a file
    (reference `sign-transaction`)."""
    from ..crypto.keys import SecretKey
    from ..crypto import strkey
    from ..crypto.hashing import sha256
    from ..transactions.transaction_frame import TransactionFrame
    from ..xdr import TransactionEnvelope
    cfg = _load_config(args)
    if args.netid:
        network_id = sha256(args.netid.encode())
    else:
        network_id = cfg.network_id
    raw = open(args.txfile, "rb").read()
    try:
        raw = bytes.fromhex(raw.decode().strip())
    except Exception:
        pass
    env = TransactionEnvelope.from_xdr(raw)
    seed = args.seed or sys.stdin.readline().strip()
    sk = SecretKey.from_seed(strkey.decode_seed(seed))
    frame = TransactionFrame.make_from_wire(network_id, env)
    frame.add_signature(sk)
    print(frame.envelope.to_xdr().hex())
    return 0


def cmd_print_xdr(args) -> int:
    """Pretty-print one XDR value (reference `print-xdr`)."""
    from .. import xdr as X
    raw = open(args.file, "rb").read()
    try:
        raw = bytes.fromhex(raw.decode().strip())
    except Exception:
        pass
    t = getattr(X, args.filetype, None)
    if t is None:
        print("unknown XDR type %r" % args.filetype, file=sys.stderr)
        return 1
    v = t.from_xdr(raw)
    print(_xdr_to_jsonable(v))
    return 0


def _xdr_to_jsonable(v, depth: int = 0):
    if depth > 24:
        return "..."
    if isinstance(v, bytes):
        return v.hex()
    if isinstance(v, (int, str, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_xdr_to_jsonable(x, depth + 1) for x in v]
    fields = getattr(type(v), "xdr_fields", None)
    if fields is not None:
        return {n: _xdr_to_jsonable(getattr(v, n), depth + 1)
                for n, _t in fields}
    if hasattr(v, "disc") and hasattr(v, "value"):
        return {"disc": v.disc,
                "value": _xdr_to_jsonable(v.value, depth + 1)}
    return str(v)


def cmd_http_command(args) -> int:
    """Send a command to a running node's admin port (reference
    `http-command`)."""
    import urllib.request
    cfg = _load_config(args)
    url = "http://127.0.0.1:%d/%s" % (cfg.HTTP_PORT, args.command)
    with urllib.request.urlopen(url, timeout=35) as r:
        print(r.read().decode())
    return 0


def cmd_version(args) -> int:
    cfg = Config()
    print(cfg.VERSION_STR)
    return 0


def cmd_test(args) -> int:
    """Run the port's tests (reference `test`): `tests/test_torch_*.py`
    of the checkout, or the pytest arguments given."""
    import glob
    import os

    import pytest
    extra = list(args.pytest_args or [])
    if not any(not a.startswith("-") for a in extra):
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        extra += sorted(glob.glob(os.path.join(repo, "tests",
                                               "test_torch_*.py")))
    return pytest.main(["-q"] + extra)


def _harvest_inferred_quorum(cfg, first: int, last: int):
    """Shared harvest loop of infer-quorum/write-quorum: mine SCP history
    from every readable configured archive."""
    from ..history.archive import HistoryArchive
    from ..history.inferred_quorum import InferredQuorum
    iq = InferredQuorum()
    total = 0
    for name, d in cfg.HISTORY.items():
        arch = HistoryArchive.from_config(name, d)
        if not arch.has_get():
            continue
        total += iq.harvest_archive(arch, first, last,
                                    cfg.CHECKPOINT_FREQUENCY)
    return iq, total


def cmd_infer_quorum(args) -> int:
    """Mine quorum sets from published SCP history (reference infer-quorum,
    src/history/InferredQuorum.cpp)."""
    import json

    from .config import Config

    cfg = Config.from_toml(args.conf) if args.conf else Config()
    iq, total = _harvest_inferred_quorum(cfg, args.first, args.last)
    out = iq.to_json()
    out["entries"] = total
    out["quorum_intersection"] = iq.check_quorum_intersection()
    print(json.dumps(out, indent=1))
    return 0


def _verifier_counts(v) -> dict:
    """`launch_counters()["verifier"]`'s shape for a verifier that no
    Application owns (a fuzz run's `TestLedger`)."""
    inner = getattr(v, "inner", v)
    counters = {"batches_dispatched": getattr(inner, "batches_dispatched",
                                              0)}
    if getattr(inner, "_fleet_health", None) is not None:
        from ..ops import ed25519 as _ed25519
        counters["kernel_launches"] = _ed25519.LAUNCHES
    st = v.stats.to_json() if v.stats is not None else {}
    return {"drains": st.get("drains", {}).get("by_backend"),
            "counters": counters,
            "warmed": len(st.get("warmup", {}).get("buckets", {}) or {})}


def cmd_fuzz(args) -> int:
    """Mutational fuzz run over an untrusted intake surface (reference
    `fuzz` AFL mode, src/test/FuzzerImpl.cpp; docs/fuzzing.md). With
    --input, runs that single input and exits (the reference `fuzz`
    contract for AFL integration)."""
    import logging

    backend = _load_config(args).SIG_VERIFY_BACKEND
    silenced = logging.root.manager.disable
    logging.disable(logging.ERROR)
    try:
        return _fuzz(args, backend)
    finally:
        logging.disable(silenced)


def _fuzz(args, backend: str) -> int:
    from .fuzz import fuzz_overlay, fuzz_tx, run_one
    built: list = []
    if args.input:
        data = open(args.input, "rb").read()
        stats = run_one(args.mode, data, backend=backend, built=built)
    else:
        fn = fuzz_tx if args.mode == "tx" else fuzz_overlay
        stats = fn(iterations=args.iterations, seed=args.seed,
                   backend=backend, built=built)
    print(json.dumps({"mode": args.mode, **stats}))
    apps = [b for b in built if hasattr(b, "command_handler")]
    for app in apps:
        app.wait_for_warmups()
    nodes = [a.command_handler.launch_counters() for a in apps]
    nodes += [{"verifier": _verifier_counts(b.verifier)} for b in built
              if not hasattr(b, "command_handler")]
    print(json.dumps({"backend": backend, "launches": nodes},
                     sort_keys=True))
    return 0


def cmd_gen_fuzz(args) -> int:
    """Write a random fuzzer input file (reference `gen-fuzz`)."""
    from .fuzz import gen_input
    data = gen_input(args.mode, args.seed,
                     backend=_load_config(args).SIG_VERIFY_BACKEND)
    with open(args.output, "wb") as f:
        f.write(data)
    print("wrote %d-byte %s fuzz input to %s"
          % (len(data), args.mode, args.output))
    return 0


def cmd_simulate(args) -> int:
    """Simulate applying synthetic payment ledgers offline and report the
    close rate (reference `simulate`)."""
    import os
    import shutil
    import tempfile

    from ..crypto.keys import SecretKey
    from ..testing import AppLedgerAdapter
    cfg = _load_config(args)
    cfg.RUN_STANDALONE = True
    cfg.MANUAL_CLOSE = True
    cfg.FORCE_SCP = True
    cfg.UNSAFE_QUORUM = True
    cfg.DATABASE = "in-memory"
    if cfg.NODE_SEED is None:
        cfg.NODE_SEED = SecretKey.from_seed(os.urandom(32))
    cfg.QUORUM_SET = cfg.self_qset()
    cfg.BUCKET_DIR_PATH = tempfile.mkdtemp(prefix="sct-simulate-")
    try:
        app = _make_app(cfg, real_time=False)
        app.start()
        ad = AppLedgerAdapter(app)
        root = ad.root_account()
        senders = []
        t_fund = app.clock.now()
        for _ in range(args.txs):
            # each funding close nominates the LCL's close time + 1; the
            # clock is kept at the LCL's, so that close time never runs
            # past the allowed slip (the reference's funding loop stops
            # closing at about 60 senders; ROADMAP Queue 3 item 12)
            ct = app.ledger_manager.lcl_header.scpValue.closeTime
            if app.clock.now() < ct:
                app.clock.set_virtual_time(ct)
            senders.append(root.create(10**10))
        app.clock.set_virtual_time(max(
            app.clock.now(),
            t_fund + app.ledger_manager.last_closed_ledger_num()))
        t0 = time.perf_counter()
        for _ in range(args.ledgers):
            for s in senders:
                app.submit_transaction(
                    s.tx([s.op_payment(root.account_id, 1)]))
            app.clock.set_virtual_time(app.clock.now() + 1.0)
            app.manual_close()
        dt = time.perf_counter() - t0
        print(json.dumps({
            "ledgers": args.ledgers, "txs_per_ledger": args.txs,
            "wall_s": round(dt, 3),
            "ledgers_per_sec": round(args.ledgers / dt, 2),
            "txs_per_sec": round(args.ledgers * args.txs / dt, 1)}))
        app.wait_for_warmups()
        lm = app.ledger_manager
        print(json.dumps({
            "ledger": lm.last_closed_ledger_num(),
            "hash": lm.lcl_hash.hex(),
            "launches": app.command_handler.launch_counters()},
            sort_keys=True))
        app.stop()
    finally:
        shutil.rmtree(cfg.BUCKET_DIR_PATH, ignore_errors=True)
    return 0


def cmd_check_quorum(args) -> int:
    """Check quorum intersection of the last network activity (reference
    `check-quorum`): builds the node→qset map from the newest SCP history
    rows in the local DB and runs the enumeration checker
    (QuorumIntersectionCheckerImpl role)."""
    from ..herder.pending_envelopes import statement_qset_hash
    from ..herder.quorum_intersection import QuorumIntersectionChecker
    from ..xdr import SCPEnvelope, SCPQuorumSet

    cfg = _load_config(args)
    app = _make_app(cfg, real_time=False)
    db = getattr(app, "database", None)
    if db is None:
        print("check-quorum needs a persistent database", file=sys.stderr)
        return 1
    row = db.execute("SELECT MAX(ledgerseq) FROM scphistory").fetchone()
    if row is None or row[0] is None:
        print(json.dumps({"error": "no SCP history rows"}))
        return 1
    seq = row[0]
    qmap = {}
    for (blob,) in db.execute(
            "SELECT envelope FROM scphistory WHERE ledgerseq = ?", (seq,)):
        env = SCPEnvelope.from_xdr(blob)
        node = env.statement.nodeID.key_bytes
        qh = statement_qset_hash(env.statement)
        qrow = db.execute("SELECT qset FROM scpquorums WHERE qsethash = ?",
                          (qh.hex(),)).fetchone()
        qmap[node] = SCPQuorumSet.from_xdr(qrow[0]) if qrow else None
    checker = QuorumIntersectionChecker(qmap)
    ok = checker.network_enjoys_quorum_intersection()
    out = {"ledger": seq, "nodes": len(qmap), "intersection": bool(ok)}
    if getattr(args, "critical", False):
        from ..herder.quorum_intersection import (
            intersection_critical_groups_strkey,
        )
        out["intersection_critical"] = \
            intersection_critical_groups_strkey(qmap)
    print(json.dumps(out, indent=1))
    return 0 if ok else 2


def cmd_write_quorum(args) -> int:
    """Print the quorum graph mined from history (reference
    `write-quorum`): per-node qsets in jsonable form."""
    cfg = _load_config(args)
    iq, _total = _harvest_inferred_quorum(cfg, args.first, args.last)
    from ..crypto.strkey import encode_public_key
    out = iq.to_json()
    out["graph"] = {encode_public_key(node): _xdr_to_jsonable(
                        iq.get_qset(node))
                    for node in sorted(iq.node_qset)}
    print(json.dumps(out, indent=1))
    return 0


def cmd_dump_xdr(args) -> int:
    """Dump a STREAM FILE of XDR records, one JSON document per record
    (reference `dump-xdr`; print-xdr handles single values)."""
    from .. import xdr as X
    from ..util.xdrstream import XDRInputFileStream

    t = getattr(X, args.filetype, None)
    if t is None:
        print("unknown XDR type %r" % args.filetype, file=sys.stderr)
        return 1
    n = 0
    with XDRInputFileStream(args.file) as ins:
        for rec in ins.read_all(t):
            print(json.dumps(_xdr_to_jsonable(rec)))
            n += 1
    print("-- %d record(s)" % n, file=sys.stderr)
    return 0


def cmd_report_last_history_checkpoint(args) -> int:
    """Fetch and print the most recent HistoryArchiveState from each
    readable archive (reference `report-last-history-checkpoint`)."""
    import os
    import tempfile

    from ..history.archive import HistoryArchive, WELL_KNOWN

    cfg = _load_config(args)
    ok = False
    for name, d in cfg.HISTORY.items():
        arch = HistoryArchive.from_config(name, d)
        if not arch.has_get():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            if arch.get_file_sync(WELL_KNOWN, tmp):
                print(json.dumps({"archive": name,
                                  "state": json.load(open(tmp))}, indent=1))
                ok = True
            else:
                print("archive %s: fetch failed" % name, file=sys.stderr)
        finally:
            os.unlink(tmp)
    return 0 if ok else 1


def cmd_upgrade_db(args) -> int:
    """Apply any pending DB schema migrations (reference `upgrade-db`);
    opening the database runs the migration hook."""
    cfg = _load_config(args)
    app = _make_app(cfg, real_time=False)
    db = getattr(app, "database", None)
    if db is None:
        print("no persistent database configured", file=sys.stderr)
        return 1
    print("database schema at version %s" % db.get_state("databaseschema"))
    return 0


def cmd_load_xdr(args) -> int:
    """Load an XDR bucket file directly into the ledger state, for
    debugging (reference `load-xdr`). Since SQL is a write-behind query
    index (docs/db-schema.md), the entries are applied BOTH
    into the DB tables and into the bucket list (+ persisted local HAS)
    — an SQL-only injection would be invisible to BucketDB-routed point
    reads."""
    from ..bucket.applicator import BucketApplicator
    from ..bucket.bucket import Bucket
    from ..xdr import BucketEntryType

    cfg = _load_config(args)
    app = _make_app(cfg, real_time=False)
    app.ledger_manager.load_last_known_ledger()
    b = Bucket.read_from(args.file)
    applicator = BucketApplicator(app.ledger_manager.ltx_root(), b)
    n = 0
    while applicator:
        n += applicator.advance()
    bm = app.bucket_manager
    if bm is not None:
        from ..crypto.hashing import sha256
        lm = app.ledger_manager
        live = [e.value for e in b.payload_entries()
                if e.disc in (BucketEntryType.LIVEENTRY,
                              BucketEntryType.INITENTRY)]
        dead = [e.value for e in b.payload_entries()
                if e.disc == BucketEntryType.DEADENTRY]
        hdr = lm.lcl_header
        bm.add_batch(hdr.ledgerSeq, hdr.ledgerVersion, [], live, dead)
        # restamp the stored LCL header's bucketListHash over the
        # mutated list and re-derive the LCL hash: otherwise the next
        # start's restore check (list hash != header) would wipe the
        # bucket list and the injected entries would be invisible to
        # bucket-backed reads. Offline state surgery already forks this
        # node from any network; the restamp just keeps it locally
        # coherent.
        hdr.bucketListHash = bm.get_hash()
        lm.lcl_hash = sha256(hdr.to_xdr())
        lm._store_header(hdr)
        lm._store_local_has()
    print("applied %d entr%s from %s (bucket hash %s)"
          % (n, "y" if n == 1 else "ies", args.file,
             b.get_hash().hex()[:16]))
    return 0


def cmd_rebuild_ledger_from_buckets(args) -> int:
    """Rebuild the SQL ledger state from the current bucket files
    (reference `rebuild-ledger-from-buckets`): clears entry tables, then
    streams the bucket list newest-first (level 0 curr, snap, level 1 …)
    into the DB — the first bucket to mention a key wins."""
    from ..bucket.applicator import apply_buckets

    cfg = _load_config(args)
    app = _make_app(cfg, real_time=False)
    if not app.ledger_manager.load_last_known_ledger():
        print("no last-known ledger in DB", file=sys.stderr)
        return 1
    bm = getattr(app, "bucket_manager", None)
    db = getattr(app, "database", None)
    if bm is None or db is None:
        print("needs bucket directory + persistent DB", file=sys.stderr)
        return 1
    # refuse to wipe the SQL state unless the on-disk bucket list hashes
    # to exactly what the LCL header committed to — an empty or stale list
    # would otherwise destroy the only copy of the ledger
    header = app.ledger_manager.lcl_header
    if bm.get_hash() != header.bucketListHash:
        print("bucket list hash %s does not match header %s; refusing"
              % (bm.get_hash().hex()[:16],
                 header.bucketListHash.hex()[:16]), file=sys.stderr)
        return 1
    root = app.ledger_manager.ltx_root()
    for table in ("accounts", "trustlines", "offers", "accountdata"):
        db.execute("DELETE FROM %s" % table)
    db.commit()
    root._cache.clear()   # raw DELETEs bypassed the root's entry cache
    buckets = []
    for lev in bm.bucket_list.levels:
        buckets.append(lev.curr)
        buckets.append(lev.snap)
    n = apply_buckets(root, buckets)
    print("rebuilt %d ledger entr%s from %d bucket level(s)"
          % (n, "y" if n == 1 else "ies", len(bm.bucket_list.levels)))
    return 0


# -- parser ------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="stellar-core-tpu-torch",
        description="replicated ledger node on a CUDA card")
    sub = ap.add_subparsers(dest="command", required=True)

    def add(name, fn, help_, conf=True):
        p = sub.add_parser(name, help=help_)
        if conf:
            p.add_argument("--conf", help="TOML config file")
        p.set_defaults(fn=fn)
        return p

    add("run", cmd_run, "run a node")
    p = add("fuzz", cmd_fuzz, "fuzz an intake surface (tx|overlay)")
    p.add_argument("--mode", choices=("tx", "overlay"), default="tx")
    p.add_argument("--iterations", type=int, default=10000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--input", help="run this single input file and exit")
    p = add("gen-fuzz", cmd_gen_fuzz, "generate a random fuzzer input")
    p.add_argument("output")
    p.add_argument("--mode", choices=("tx", "overlay"), default="tx")
    p.add_argument("--seed", type=int, default=1)
    p = add("check-quorum", cmd_check_quorum,
            "check quorum intersection of last network activity")
    p.add_argument("--critical", action="store_true",
                   help="also search for intersection-critical groups")
    p = add("write-quorum", cmd_write_quorum,
            "print a quorum graph mined from history")
    p.add_argument("--first", type=int, default=1)
    p.add_argument("--last", type=int, default=2**31 - 1)
    p = add("dump-xdr", cmd_dump_xdr, "dump an XDR stream file",
            conf=False)
    p.add_argument("file")
    p.add_argument("--filetype", default="LedgerHeaderHistoryEntry")
    add("report-last-history-checkpoint",
        cmd_report_last_history_checkpoint,
        "print each archive's latest HistoryArchiveState")
    add("upgrade-db", cmd_upgrade_db,
        "upgrade database schema to the current version")
    p = add("load-xdr", cmd_load_xdr,
            "load an XDR bucket file into the DB, for testing")
    p.add_argument("file")
    add("rebuild-ledger-from-buckets", cmd_rebuild_ledger_from_buckets,
        "rebuild SQL ledger state from the current bucket files")
    p = add("simulate", cmd_simulate, "simulate applying ledgers")
    p.add_argument("--ledgers", type=int, default=32)
    p.add_argument("--txs", type=int, default=16)
    add("new-db", cmd_new_db, "reset DB to the genesis ledger")
    p = add("force-scp", cmd_force_scp,
            "start SCP from the LCL on next run")
    p.add_argument("--reset", action="store_true")
    p = add("catchup", cmd_catchup, "catch up from history archives")
    p.add_argument("destination",
                   help="<to>/<count>, e.g. current/max or 100000/64")
    add("publish", cmd_publish, "publish queued checkpoints")
    p = add("infer-quorum", cmd_infer_quorum,
            "infer the network quorum structure from SCP history")
    p.add_argument("--first", type=int, default=1)
    p.add_argument("--last", type=int, default=2**31 - 1)
    p = add("new-hist", cmd_new_hist, "initialize history archives")
    p.add_argument("archives", nargs="+")
    add("offline-info", cmd_offline_info, "info for an offline instance")
    add("gen-seed", cmd_gen_seed, "generate a random node seed",
        conf=False)
    p = add("sec-to-pub", cmd_sec_to_pub,
            "public key for a secret seed", conf=False)
    p.add_argument("--seed", help="seed (otherwise read from stdin)")
    p = add("convert-id", cmd_convert_id,
            "display an ID in all known forms", conf=False)
    p.add_argument("id")
    p = add("sign-transaction", cmd_sign_transaction,
            "add a signature to a transaction envelope")
    p.add_argument("txfile")
    p.add_argument("--netid", help="network passphrase")
    p.add_argument("--seed", help="signing seed (else stdin)")
    p = add("print-xdr", cmd_print_xdr, "pretty-print one XDR value",
            conf=False)
    p.add_argument("file")
    p.add_argument("--filetype", default="TransactionEnvelope")
    p = add("http-command", cmd_http_command,
            "send a command to a running node")
    p.add_argument("command")
    add("version", cmd_version, "print version", conf=False)
    p = add("test", cmd_test, "run the test suite", conf=False)
    p.add_argument("pytest_args", nargs="*")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    import sys
    sys.exit(main())
