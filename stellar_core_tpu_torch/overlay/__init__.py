"""Overlay (p2p) layer.

Copied from `stellar_core_tpu/overlay/__init__.py` at commit 17156c3; carry
a fix in either copy to the other. Nothing is left out.

Role parity: reference `src/overlay` — authenticated TCP mesh with XDR
framing, gossip flood, anycast item fetch, peer book."""

from .floodgate import Floodgate
from .item_fetcher import ItemFetcher, Tracker
from .overlay_manager import OverlayManager
from .peer import Peer, PeerState
from .peer_auth import PeerAuth, PeerRole
from .peer_manager import BanManager, PeerManager, parse_peer_address
from .transport import (
    LoopbackTransport, TCPDoor, TCPReactor, TCPTransport, Transport,
)

__all__ = [
    "BanManager", "Floodgate", "ItemFetcher", "LoopbackTransport",
    "OverlayManager", "Peer", "PeerAuth", "PeerManager", "PeerRole",
    "PeerState", "TCPDoor", "TCPReactor", "TCPTransport", "Tracker",
    "Transport", "parse_peer_address",
]
