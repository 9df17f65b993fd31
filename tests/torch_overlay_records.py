"""What the overlay mirrors record on each side (`torch_mirror_harness.
Mirror`'s `patch`): decisions only, never times, MAC keys or the random
X25519 secrets of a session.

`record_overlay` records, in order, every handshake's outcome (who
accepted whom), every peer drop with its reason and error code, every
floodgate record (first sight or duplicate) and broadcast (peers sent
to), every envelope the herder took in (its EnvelopeState) and every
close (sequence and ledger hash): the virtual-time simulations run the
same events in the same order on both packages. `record_tcp` records what
a real-time TCP run decides whatever the timing: each authenticated pair
once, and every bare transport (one no peer owns) that reported itself
closed; a test compares these as sets.
"""

import contextlib

from torch_mirror_harness import record_calls


def _mod(pkg: str, name: str):
    return __import__(pkg + "." + name, fromlist=["x"])


def _id(pk) -> str:
    return pk.key_bytes.hex()[:8] if pk is not None else "-"


@contextlib.contextmanager
def record_overlay(pkg: str, log: list):
    om = _mod(pkg, "overlay.overlay_manager")
    peer = _mod(pkg, "overlay.peer")
    fg = _mod(pkg, "overlay.floodgate")
    herder = _mod(pkg, "herder.herder")
    lm = _mod(pkg, "ledger.ledger_manager")
    with record_calls(log, [
        (om.OverlayManager, "accept_authenticated_peer",
         lambda out, o, p: (_id(o.app.config.node_id()), _id(p.peer_id),
                            out)),
        (peer.Peer, "drop",
         lambda out, p, reason="", send_error=None: (reason, send_error)),
        (fg.Floodgate, "add_record", lambda out, *a, **kw: out),
        (fg.Floodgate, "broadcast", lambda out, *a, **kw: out),
        (herder.Herder, "recv_scp_envelope",
         lambda out, *a, **kw: int(out)),
        (lm.LedgerManager, "value_externalized",
         lambda out, m, lcd: (lcd.ledger_seq, m.lcl_hash.hex())),
    ]):
        yield


@contextlib.contextmanager
def record_tcp(pkg: str, log: list):
    om = _mod(pkg, "overlay.overlay_manager")
    peer = _mod(pkg, "overlay.peer")
    tr = _mod(pkg, "overlay.transport")

    def closed(out, t):
        # a peer's transport closes by whichever end drops first (a race
        # between two nodes' dials): recorded only for a bare transport
        owner = getattr(t.on_closed, "__self__", None)
        return None if isinstance(owner, peer.Peer) else "closed"

    with record_calls(log, [
        (om.OverlayManager, "accept_authenticated_peer",
         lambda out, o, p: out and tuple(sorted(
             (_id(o.app.config.node_id()), _id(p.peer_id))))),
        (tr.TCPTransport, "_notify_closed", closed),
    ]):
        yield


# the split of tests/test_overlay_tcp.py's cases over the
# test_torch_overlay_tcp*.py files (each file waits on the host's clock)
TCP_GROUPS = {
    'tcp': (
        'test_three_node_tcp_consensus',
        'test_tcp_midstream_disconnect_recovers',
        'test_tcp_transport_write_coalescing_preserves_frames',
        'test_tcp_transport_stuck_reader_queue_overflow_drops',
        'test_tcp_transport_oldest_unsent_age_tracks_stall',
        'test_tcp_nonblocking_connect_failure_reported_async',
        'test_tcp_transport_reset_midwrite_no_deadlock',
        'test_send_overflow_fault_site_forces_drop_and_meter',
        'test_quick_restart_rejoins_consensus',
    ),
    'tcp_auth': (
        'test_tcp_auth_failure_bad_network_id',
    ),
    'tcp_peers': (
        'test_tcp_oversized_frame_disconnects',
        'test_straggler_peer_dropped_by_tick',
        'test_inbound_preferred_peer_matches_listening_port',
    ),
}


def tcp_mirror(base_port: int):
    """The TCP cases on both sides, their ports moved to `base_port` and
    up (the reference's own file listens from 23400 and may run at the
    same time in another worker; each of the mirror's files takes a range
    of its own)."""
    from torch_mirror_harness import Mirror
    return Mirror(("test_overlay_tcp.py",), patch=record_tcp,
                  subs=((r"(?m)^BASE_PORT = 23400$",
                         "BASE_PORT = %d" % base_port),))


def tcp_sides(mirror, case, tmp_path) -> None:
    """Runs `case` on both sides; raises unless their `record_tcp`
    records are equal as sets (a refused handshake, recorded as False,
    and a peer's closed transport are left out: whether a simultaneous
    dial is refused, and which end closes first, depend on the
    timing)."""
    sides = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        sides[side] = {(k, v) for k, v in mirror.run(
            side, case, {"tmp_path": d}) if v}
    assert sides["port"] == sides["ref"], sides
