"""InferredQuorum: mine quorum sets from published SCP history streams.

Copied from `stellar_core_tpu/history/inferred_quorum.py` at commit
1bfed9e; carry a fix in either copy to the other. Nothing is left out.

Role parity: reference `src/history/InferredQuorum.{h,cpp}` + the
`infer-quorum` CLI subcommand (src/main/CommandLine.cpp:1060-1066): walk a
range of checkpoints' scp-*.xdr streams, harvest every (nodeID → latest
quorum set) binding plus pubkey activity counts, and report the network's
inferred quorum structure.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional, Tuple

from ..crypto.hashing import sha256
from ..crypto.strkey import encode_public_key
from ..herder.pending_envelopes import statement_qset_hash
from ..util.xdrstream import XDRInputFileStream
from ..xdr import SCPHistoryEntry, SCPQuorumSet
from .archive import HistoryArchive, category_path
from .checkpoints import checkpoints_in_range
from .snapshot import gunzip_file


class InferredQuorum:
    def __init__(self) -> None:
        self.qsets: Dict[bytes, SCPQuorumSet] = {}         # qset hash → qset
        self.node_qset: Dict[bytes, bytes] = {}            # node → qset hash
        self.counts: Dict[bytes, int] = {}                 # node → #pledges
        self.latest_seq: Dict[bytes, int] = {}             # node → last slot

    # -- harvesting ----------------------------------------------------------
    def note_entry(self, entry) -> None:
        v0 = entry.value
        for q in v0.quorumSets:
            self.qsets[sha256(q.to_xdr())] = q
        for env in v0.ledgerMessages.messages:
            st = env.statement
            node = st.nodeID.key_bytes
            self.counts[node] = self.counts.get(node, 0) + 1
            if st.slotIndex >= self.latest_seq.get(node, 0):
                self.latest_seq[node] = st.slotIndex
                self.node_qset[node] = statement_qset_hash(st)

    def harvest_stream(self, path: str) -> int:
        n = 0
        with XDRInputFileStream(path) as stream:
            while True:
                entry = stream.read_one(SCPHistoryEntry)
                if entry is None:
                    break
                self.note_entry(entry)
                n += 1
        return n

    def harvest_archive(self, archive: HistoryArchive,
                        first_ledger: int, last_ledger: int,
                        freq: int) -> int:
        """Fetch + gunzip the scp category for every checkpoint in range.
        The range is clamped to the archive head (from the .well-known
        HistoryArchiveState) so an open-ended --last never turns into
        millions of speculative fetches."""
        entries = 0
        with tempfile.TemporaryDirectory(prefix="sct-iq-") as tmp:
            has_path = os.path.join(tmp, "has.json")
            if archive.get_file_sync(
                    ".well-known/stellar-history.json", has_path):
                import json
                with open(has_path) as fh:
                    head = int(json.load(fh).get("currentLedger", 0))
                if head:
                    last_ledger = min(last_ledger, head)
            for cp in checkpoints_in_range(first_ledger, last_ledger, freq):
                remote = category_path("scp", cp, ".xdr.gz")
                local = os.path.join(tmp, "scp-%08x.xdr.gz" % cp)
                if not archive.get_file_sync(remote, local):
                    continue
                entries += self.harvest_stream(gunzip_file(local))
        return entries

    # -- reporting -----------------------------------------------------------
    def get_qset(self, node: bytes) -> Optional[SCPQuorumSet]:
        h = self.node_qset.get(node)
        return self.qsets.get(h) if h is not None else None

    def nodes_by_activity(self) -> List[Tuple[bytes, int]]:
        return sorted(self.counts.items(), key=lambda kv: (-kv[1], kv[0]))

    def to_json(self) -> dict:
        def qset_json(q: SCPQuorumSet) -> dict:
            return {
                "threshold": q.threshold,
                "validators": [encode_public_key(v.key_bytes)
                               for v in q.validators],
                "inner": [qset_json(i) for i in q.innerSets],
            }

        nodes = []
        for node, count in self.nodes_by_activity():
            q = self.get_qset(node)
            nodes.append({
                "node": encode_public_key(node),
                "pledges": count,
                "last_slot": self.latest_seq.get(node, 0),
                "qset": qset_json(q) if q is not None else None,
            })
        return {"node_count": len(nodes), "qset_count": len(self.qsets),
                "nodes": nodes}

    def check_quorum_intersection(self) -> Optional[bool]:
        """Run the quorum-intersection checker over the inferred qset map
        (reference checkQuorumIntersection on an InferredQuorum)."""
        from ..herder.quorum_intersection import QuorumIntersectionChecker
        qmap = {n: self.get_qset(n) for n in self.node_qset}
        if not qmap or any(v is None for v in qmap.values()):
            return None
        return QuorumIntersectionChecker(qmap).network_enjoys_quorum_intersection()
