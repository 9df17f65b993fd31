"""ItemFetcher/Tracker: anycast fetch of txsets and quorum sets.

Copied from `stellar_core_tpu/overlay/item_fetcher.py` at commit 9a356c0;
carry a fix in either copy to the other. Nothing is left out.

Role parity: reference `src/overlay/ItemFetcher.{h,cpp}` and
`Tracker.{h,cpp}` — one Tracker per wanted item hash holds the envelopes
waiting on it, asks one random authenticated peer at a time, rotates to the
next peer on timeout (MS_TO_WAIT_FOR_FETCH_REPLY) or DONT_HAVE, and when
the item arrives re-feeds the waiting envelopes to the Herder.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..util import rnd
from ..util.log import get_logger
from ..util.timer import VirtualTimer
from ..xdr import SCPEnvelope, StellarMessage

log = get_logger("Overlay")

MS_TO_WAIT_FOR_FETCH_REPLY = 1.5
MAX_REBUILD_FETCH_LIST = 1000
# retry-delay growth cap (multiplier saturates here) and the give-up
# bound: after this many full candidate-list rebuilds with no answer the
# tracker stops polling and counts an `overlay.item-fetcher.giveup` —
# an unfetchable txset becomes a visible metric instead of an eternal
# silent poll (docs/robustness.md)
MAX_DELAY_REBUILDS = 10
GIVEUP_REBUILDS = 32


class Tracker:
    """Fetch state for one item (reference Tracker.h)."""

    def __init__(self, overlay, item_hash: bytes,
                 make_request: Callable[[bytes], StellarMessage]) -> None:
        self.overlay = overlay
        self.item_hash = item_hash
        self.make_request = make_request
        self.waiting: List[SCPEnvelope] = []
        self.last_asked_peer: Optional[str] = None
        self.peers_asked: List[str] = []
        self.timer = VirtualTimer(overlay.app.clock)
        self.num_list_rebuild = 0
        self._stopped = False
        # called (with self) when the tracker abandons the fetch, so the
        # owning ItemFetcher can drop it from its registry
        self.on_giveup: Optional[Callable[["Tracker"], None]] = None

    def listen(self, env: SCPEnvelope) -> None:
        if len(self.waiting) < MAX_REBUILD_FETCH_LIST:
            self.waiting.append(env)

    def try_next_peer(self) -> None:
        """Ask one peer we haven't asked this round; when all are
        exhausted, rebuild the candidate list and back off slightly
        (reference Tracker::tryNextPeer). After GIVEUP_REBUILDS fruitless
        rebuilds the tracker gives up instead of polling forever."""
        if self._stopped:
            return
        peers = self.overlay.authenticated_peer_ids()
        candidates = [p for p in peers if p not in self.peers_asked]
        if not candidates:
            self.peers_asked = []
            self.num_list_rebuild += 1
            if self.num_list_rebuild >= GIVEUP_REBUILDS:
                self._give_up()
                return
            candidates = list(peers)
        if candidates:
            pid = candidates[rnd.g_random.randrange(len(candidates))]
            self.last_asked_peer = pid
            self.peers_asked.append(pid)
            peer = self.overlay.get_peer(pid)
            if peer is not None:
                peer.send_message(self.make_request(self.item_hash))
        delay = MS_TO_WAIT_FOR_FETCH_REPLY * (1 + min(
            self.num_list_rebuild, MAX_DELAY_REBUILDS))
        self.timer.expires_from_now(delay)
        self.timer.async_wait(self.try_next_peer)

    def _give_up(self) -> None:
        log.warning("giving up fetching %s after %d peer-list rebuilds "
                    "(%d envelopes waiting)", self.item_hash.hex()[:8],
                    self.num_list_rebuild, len(self.waiting))
        m = getattr(self.overlay.app, "metrics", None)
        if m is not None:
            m.new_meter("overlay.item-fetcher.giveup").mark()
        self.stop()
        if self.on_giveup is not None:
            self.on_giveup(self)

    def doesnt_have(self, peer_id: str) -> None:
        if peer_id == self.last_asked_peer:
            self.timer.cancel()
            self.try_next_peer()

    def stop(self) -> None:
        self._stopped = True
        self.timer.cancel()
        self.waiting.clear()


class ItemFetcher:
    """Hash → Tracker registry (reference ItemFetcher.h:41-96)."""

    def __init__(self, overlay,
                 make_request: Callable[[bytes], StellarMessage]) -> None:
        self.overlay = overlay
        self.make_request = make_request
        self.trackers: Dict[bytes, Tracker] = {}

    def fetch(self, item_hash: bytes,
              envelope: Optional[SCPEnvelope] = None) -> None:
        tr = self.trackers.get(item_hash)
        if tr is None:
            tr = Tracker(self.overlay, item_hash, self.make_request)
            tr.on_giveup = lambda t: self.trackers.pop(t.item_hash, None)
            self.trackers[item_hash] = tr
            if envelope is not None:
                tr.listen(envelope)
            tr.try_next_peer()
        elif envelope is not None:
            tr.listen(envelope)

    def recv(self, item_hash: bytes, feed: Callable[[SCPEnvelope], None]
             ) -> None:
        """Item arrived: stop tracking, re-feed waiting envelopes."""
        tr = self.trackers.pop(item_hash, None)
        if tr is None:
            return
        waiting = list(tr.waiting)
        tr.stop()
        for env in waiting:
            feed(env)

    def doesnt_have(self, item_hash: bytes, peer_id: str) -> None:
        tr = self.trackers.get(item_hash)
        if tr is not None:
            tr.doesnt_have(peer_id)

    def stop_fetching_below(self, slot_index: int) -> None:
        """Drop trackers whose every waiting envelope is below the slot
        (reference ItemFetcher::stopFetchingBelow)."""
        for h in list(self.trackers):
            tr = self.trackers[h]
            tr.waiting = [e for e in tr.waiting
                          if e.statement.slotIndex >= slot_index]
            if not tr.waiting:
                tr.stop()
                del self.trackers[h]

    def num_fetching(self) -> int:
        return len(self.trackers)
