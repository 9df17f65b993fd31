"""PeerAuth: per-connection identity certs and session MAC keys.

Copied from `stellar_core_tpu/overlay/peer_auth.py` at commit 17156c3;
carry a fix in either copy to the other. Nothing is left out.
`verify_remote_cert` checks the remote AuthCert's ed25519 signature on the
host through `PubKeyUtils.verify_sig`, once per connection, as stellar-
core's PeerAuth does; it never goes to the card (a host verify site,
ROADMAP Queue 1). The X25519 keys come from crypto/curve25519.py, the
port's C or pure-Python ladder.

Role parity: reference `src/overlay/PeerAuth.{h,cpp}` — each node keeps one
X25519 ECDH keypair; its public half is published in an AuthCert signed by
the node's ed25519 identity key, valid one hour, reissued after half an
hour (PeerAuth.cpp:19-54). Session MAC keys come from ECDH → HKDF-extract,
then HKDF-expand over a direction byte and both handshake nonces
(PeerAuth.cpp:92-135), giving distinct sending/receiving keys per
direction.
"""

from __future__ import annotations

import struct
from typing import Tuple

from ..crypto.curve25519 import (
    curve25519_derive_public, curve25519_derive_shared,
    curve25519_random_secret, hkdf_expand_key,
)
from ..crypto.hashing import sha256
from ..crypto.keys import PubKeyUtils
from ..util.cache import RandomEvictionCache
from ..xdr import AuthCert, EnvelopeType, PublicKey

CERT_EXPIRATION_SECONDS = 3600


def _cert_sign_bytes(network_id: bytes, expiration: int,
                     pubkey32: bytes) -> bytes:
    """xdr(networkID ‖ ENVELOPE_TYPE_AUTH ‖ expiration ‖ cert.pubkey)
    (reference PeerAuth.cpp:29-31)."""
    return (network_id +
            struct.pack(">i", EnvelopeType.ENVELOPE_TYPE_AUTH) +
            struct.pack(">Q", expiration) + pubkey32)


class PeerRole:
    WE_CALLED_REMOTE = 0
    REMOTE_CALLED_US = 1


class PeerAuth:
    def __init__(self, app) -> None:
        self.app = app
        self._secret = curve25519_random_secret()
        self.public = curve25519_derive_public(self._secret)
        self._cert: AuthCert = self._make_cert()
        self._shared_cache = RandomEvictionCache(0xFFFF)

    def _make_cert(self) -> AuthCert:
        expiration = self.app.clock.system_now() + CERT_EXPIRATION_SECONDS
        h = sha256(_cert_sign_bytes(self.app.config.network_id, expiration,
                                    self.public))
        sig = self.app.config.NODE_SEED.sign(h)
        return AuthCert(pubkey=self.public, expiration=expiration, sig=sig)

    def get_auth_cert(self) -> AuthCert:
        if self._cert.expiration < self.app.clock.system_now() + \
                CERT_EXPIRATION_SECONDS // 2:
            self._cert = self._make_cert()
        return self._cert

    def verify_remote_cert(self, remote_node: PublicKey,
                           cert: AuthCert) -> bool:
        if cert.expiration < self.app.clock.system_now():
            return False
        h = sha256(_cert_sign_bytes(self.app.config.network_id,
                                    cert.expiration, cert.pubkey))
        return PubKeyUtils.verify_sig(remote_node, cert.sig, h)

    # -- session keys --------------------------------------------------------
    def _shared_key(self, remote_public: bytes, we_called: bool) -> bytes:
        ck = (remote_public, we_called)
        got = self._shared_cache.maybe_get(ck)
        if got is not None:
            return got
        if we_called:
            a, b = self.public, remote_public
        else:
            a, b = remote_public, self.public
        k = curve25519_derive_shared(self._secret, remote_public, a, b)
        self._shared_cache.put(ck, k)
        return k

    def get_sending_mac_key(self, remote_public: bytes, local_nonce: bytes,
                            remote_nonce: bytes, we_called: bool) -> bytes:
        """K_AB when we called (A=local), K_BA when they called (B=local)
        (reference PeerAuth.cpp:92-113)."""
        prefix = b"\x00" if we_called else b"\x01"
        k = self._shared_key(remote_public, we_called)
        return hkdf_expand_key(k, prefix + local_nonce + remote_nonce)

    def get_receiving_mac_key(self, remote_public: bytes, local_nonce: bytes,
                              remote_nonce: bytes, we_called: bool) -> bytes:
        """Mirror of the remote's sending key: their direction byte with
        their (remote) nonce first (reference PeerAuth.cpp:116-135)."""
        prefix = b"\x01" if we_called else b"\x00"
        k = self._shared_key(remote_public, we_called)
        return hkdf_expand_key(k, prefix + remote_nonce + local_nonce)
