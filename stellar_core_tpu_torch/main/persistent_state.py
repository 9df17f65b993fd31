"""PersistentState: durable key/value node state in the DB.

Copied from `stellar_core_tpu/main/persistent_state.py` at commit
63f3249; carry a fix in either copy to the other.

Role parity: reference `src/main/PersistentState.h` — LCL, SCP state,
force-SCP flag, history-archive state, DB schema version.
"""

from __future__ import annotations

from typing import Optional

from ..database.database import Database


class PersistentState:
    kLastClosedLedger = "lastclosedledger"
    kHistoryArchiveState = "historyarchivestate"
    kForceSCPOnNextLaunch = "forcescponnextlaunch"
    kLastSCPData = "scphistory"
    kDatabaseSchema = "databaseschema"
    kNetworkPassphrase = "networkpassphrase"
    kLedgerUpgrades = "ledgerupgrades"

    def __init__(self, db: Database) -> None:
        self._db = db

    def get_state(self, key: str) -> Optional[str]:
        return self._db.get_state(key)

    def set_state(self, key: str, value: str) -> None:
        self._db.set_state(key, value)
        self._db.commit()

    def set_force_scp(self, on: bool) -> None:
        self.set_state(self.kForceSCPOnNextLaunch,
                       "true" if on else "false")

    def get_force_scp(self) -> bool:
        return self.get_state(self.kForceSCPOnNextLaunch) == "true"
