"""SQL persistence over sqlite3.

Copied from `stellar_core_tpu/database/database.py` at commit 183ecd9;
carry a fix in either copy to the other.

Role parity: reference `src/database/Database.{h,cpp}` (soci session wrapper,
prepared-statement cache, schema versioning, query metrics). sqlite3 module
caches statements internally; we add schema management and timing metrics.
"""

from __future__ import annotations

import sqlite3
import time
from typing import Any, Iterable, Optional

from ..util.log import get_logger

log = get_logger("Database")

SCHEMA_VERSION = 3

_SCHEMA = [
    """CREATE TABLE IF NOT EXISTS storestate (
        statename TEXT PRIMARY KEY, state TEXT)""",
    """CREATE TABLE IF NOT EXISTS accounts (
        accountid TEXT PRIMARY KEY, balance INTEGER, seqnum INTEGER,
        numsubentries INTEGER, flags INTEGER, lastmodified INTEGER,
        entry BLOB)""",
    """CREATE TABLE IF NOT EXISTS trustlines (
        accountid TEXT, asset TEXT, balance INTEGER, flags INTEGER,
        lastmodified INTEGER, entry BLOB,
        PRIMARY KEY (accountid, asset))""",
    """CREATE TABLE IF NOT EXISTS offers (
        sellerid TEXT, offerid INTEGER PRIMARY KEY, selling TEXT,
        buying TEXT, amount INTEGER, pricen INTEGER, priced INTEGER,
        price REAL, flags INTEGER, lastmodified INTEGER, entry BLOB)""",
    """CREATE INDEX IF NOT EXISTS offers_by_book
        ON offers (selling, buying, price, offerid)""",
    """CREATE INDEX IF NOT EXISTS offers_by_seller ON offers (sellerid)""",
    """CREATE TABLE IF NOT EXISTS accountdata (
        accountid TEXT, dataname TEXT, lastmodified INTEGER, entry BLOB,
        PRIMARY KEY (accountid, dataname))""",
    """CREATE TABLE IF NOT EXISTS ledgerheaders (
        ledgerhash TEXT PRIMARY KEY, prevhash TEXT, bucketlisthash TEXT,
        ledgerseq INTEGER UNIQUE, closetime INTEGER, data BLOB)""",
    """CREATE TABLE IF NOT EXISTS txhistory (
        txid TEXT, ledgerseq INTEGER, txindex INTEGER, txbody BLOB,
        txresult BLOB, txmeta BLOB, PRIMARY KEY (ledgerseq, txindex))""",
    """CREATE TABLE IF NOT EXISTS txfeehistory (
        txid TEXT, ledgerseq INTEGER, txindex INTEGER, txchanges BLOB,
        PRIMARY KEY (ledgerseq, txindex))""",
    """CREATE TABLE IF NOT EXISTS scphistory (
        nodeid TEXT, ledgerseq INTEGER, envelope BLOB)""",
    """CREATE TABLE IF NOT EXISTS scpquorums (
        qsethash TEXT PRIMARY KEY, lastledgerseq INTEGER, qset BLOB)""",
    """CREATE TABLE IF NOT EXISTS peers (
        ip TEXT, port INTEGER, nextattempt INTEGER, numfailures INTEGER,
        type INTEGER, PRIMARY KEY (ip, port))""",
    """CREATE TABLE IF NOT EXISTS bans (nodeid TEXT PRIMARY KEY)""",
    """CREATE TABLE IF NOT EXISTS publishqueue (
        ledgerseq INTEGER PRIMARY KEY, state TEXT)""",
    """CREATE TABLE IF NOT EXISTS pubsub (
        resid TEXT PRIMARY KEY, lastread INTEGER)""",
    """CREATE TABLE IF NOT EXISTS upgradehistory (
        ledgerseq INTEGER NOT NULL, upgradeindex INTEGER NOT NULL,
        upgrade BLOB NOT NULL, changes BLOB NOT NULL,
        PRIMARY KEY (ledgerseq, upgradeindex))""",
]


class Database:
    def __init__(self, path: str = ":memory:", metrics=None) -> None:
        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=MEMORY")
        self._conn.execute("PRAGMA synchronous=OFF")
        self._metrics = metrics
        self._init_schema()

    # -- schema -------------------------------------------------------------
    def _init_schema(self) -> None:
        for stmt in _SCHEMA:
            self._conn.execute(stmt)
        cur = self._conn.execute(
            "SELECT state FROM storestate WHERE statename='databaseschema'")
        row = cur.fetchone()
        if row is None:
            self.set_state("databaseschema", str(SCHEMA_VERSION))
        else:
            v = int(row[0])
            if v > SCHEMA_VERSION:
                raise RuntimeError("database schema %d newer than binary" % v)
            # migrations v -> SCHEMA_VERSION (reference Database::upgrade)
            # v1 -> v2: txfeehistory; v2 -> v3: upgradehistory — both
            # created above by the CREATE IF NOT EXISTS pass, so each
            # step is just the bump
            self.set_state("databaseschema", str(SCHEMA_VERSION))
        self._conn.commit()

    # -- storestate kv ------------------------------------------------------
    def get_state(self, name: str) -> Optional[str]:
        cur = self._conn.execute(
            "SELECT state FROM storestate WHERE statename=?", (name,))
        row = cur.fetchone()
        return row[0] if row else None

    def set_state(self, name: str, value: str) -> None:
        self._conn.execute(
            "INSERT INTO storestate (statename, state) VALUES (?, ?) "
            "ON CONFLICT(statename) DO UPDATE SET state=excluded.state",
            (name, value))

    # -- execution ----------------------------------------------------------
    # total_query_seconds accumulates ALL SQL time (exec + commit) so
    # callers can exclude DB time from their own timers (reference
    # DBTimeExcluder, LedgerManagerImpl.cpp:525)
    total_query_seconds = 0.0

    def execute(self, sql: str, params: Iterable[Any] = ()) -> sqlite3.Cursor:
        t0 = time.perf_counter()
        cur = self._conn.execute(sql, tuple(params))
        dt = time.perf_counter() - t0
        self.total_query_seconds += dt
        if self._metrics is not None:
            self._metrics.new_timer("database.query.exec").update(dt)
        return cur

    def executemany(self, sql: str, rows) -> None:
        t0 = time.perf_counter()
        self._conn.executemany(sql, rows)
        dt = time.perf_counter() - t0
        self.total_query_seconds += dt
        if self._metrics is not None:
            self._metrics.new_timer("database.query.exec").update(dt)

    def commit(self) -> None:
        t0 = time.perf_counter()
        self._conn.commit()
        self.total_query_seconds += time.perf_counter() - t0

    def rollback(self) -> None:
        self._conn.rollback()

    def close(self) -> None:
        self._conn.close()

    class _Tx:
        def __init__(self, db: "Database") -> None:
            self._db = db

        def __enter__(self):
            return self._db

        def __exit__(self, et, ev, tb):
            if et is None:
                self._db.commit()
            else:
                self._db.rollback()
            return False

    def transaction(self) -> "Database._Tx":
        return Database._Tx(self)
