"""Sans-IO DTLS 1.2 (RFC 6347) — server and client roles.

The port's copy of ai_rtc_agent_tpu/server/secure/dtls.py.  aiortc keeps
DTLS in OpenSSL's bindings; without aiortc or pyOpenSSL this module
implements the protocol directly over the ``cryptography`` primitive
library:

  * cipher suite TLS_ECDHE_ECDSA_WITH_AES_128_GCM_SHA256 (0xC02B) — the
    suite every browser offers for WebRTC, with x25519 or P-256 key share
  * self-signed ECDSA-P256 certificate (the WebRTC model: trust comes from
    the SDP a=fingerprint, not a CA — RFC 8827 s6.5)
  * cookie exchange (HelloVerifyRequest), fragmentation + reassembly,
    duplicate-triggered flight retransmission
  * extended master secret (RFC 7627), renegotiation_info echo
  * use_srtp negotiation (RFC 5764) + RFC 5705 keying-material exporter —
    the bridge into srtp.py
  * optional CertificateRequest so the peer's certificate can be checked
    against the SDP fingerprint (browsers always hold a certificate)

Design: `DtlsEndpoint` is sans-IO — `handle_datagram(bytes, addr=None) ->
[bytes]` plus `start()`/`retransmit()`; the UDP plumbing lives in
endpoint.py (which passes the source address so the HVR cookie is
path-bound).
Interop is pinned against `openssl s_client -dtls1_2 -use_srtp` in
tests/test_secure_dtls.py (the same stack browsers run).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import logging
import os
import struct

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec, x25519
from cryptography.hazmat.primitives.ciphers.aead import AESGCM
from cryptography.x509.oid import NameOID

logger = logging.getLogger(__name__)

DTLS_10 = 0xFEFF
DTLS_12 = 0xFEFD

CT_CCS = 20
CT_ALERT = 21
CT_HANDSHAKE = 22
CT_APPDATA = 23

HT_HELLO_REQUEST = 0
HT_CLIENT_HELLO = 1
HT_SERVER_HELLO = 2
HT_HELLO_VERIFY_REQUEST = 3
HT_CERTIFICATE = 11
HT_SERVER_KEY_EXCHANGE = 12
HT_CERTIFICATE_REQUEST = 13
HT_SERVER_HELLO_DONE = 14
HT_CERTIFICATE_VERIFY = 15
HT_CLIENT_KEY_EXCHANGE = 16
HT_FINISHED = 20

CIPHER_ECDHE_ECDSA_AES128_GCM_SHA256 = 0xC02B

EXT_SUPPORTED_GROUPS = 0x000A
EXT_EC_POINT_FORMATS = 0x000B
EXT_SIGNATURE_ALGORITHMS = 0x000D
EXT_USE_SRTP = 0x000E
EXT_EXTENDED_MASTER_SECRET = 0x0017
EXT_RENEGOTIATION_INFO = 0xFF01

GROUP_SECP256R1 = 0x0017
GROUP_X25519 = 0x001D

SIG_ECDSA_SECP256R1_SHA256 = 0x0403

# profile ids live in srtp.py (one registry: PROFILE_KEYING drives both
# negotiation here and key derivation there)
from .srtp import (  # noqa: E402
    PROFILE_AEAD_AES_128_GCM,
    PROFILE_AES128_CM_SHA1_80,
)

# our preference order: the CM profile is end-to-end validated against
# openssl's exported keying material; the AEAD profile (RFC 7714) is
# implemented but its KDF interpretation lacks an independent
# cross-validation in this image (no RFC 7714 s16/17 vector source on
# disk, no second SRTP implementation — adding those vectors is the
# closure when a source exists), so it negotiates only when the peer
# does not offer the CM profile
DEFAULT_SRTP_PROFILES = (PROFILE_AES128_CM_SHA1_80, PROFILE_AEAD_AES_128_GCM)

MASTER_SECRET_LEN = 48
VERIFY_DATA_LEN = 12
GCM_TAG_LEN = 16
RECORD_HEADER_LEN = 13
HS_HEADER_LEN = 12


def p_sha256(secret: bytes, label: bytes, seed: bytes, n: int) -> bytes:
    """TLS 1.2 PRF (RFC 5246 s5) with SHA-256."""
    seed = label + seed
    out = b""
    a = seed
    while len(out) < n:
        a = hmac.new(secret, a, hashlib.sha256).digest()
        out += hmac.new(secret, a + seed, hashlib.sha256).digest()
    return out[:n]


def fingerprint_of_der(der: bytes) -> str:
    digest = hashlib.sha256(der).hexdigest().upper()
    return ":".join(digest[i : i + 2] for i in range(0, len(digest), 2))


class DtlsCertificate:
    """Self-signed ECDSA-P256 identity + its SDP fingerprint string."""

    def __init__(self, private_key, cert):
        self.private_key = private_key
        self.cert = cert
        self.der = cert.public_bytes(serialization.Encoding.DER)
        self.fingerprint = fingerprint_of_der(self.der)


def generate_certificate(common_name: str = "ai-rtc-agent-tpu") -> DtlsCertificate:
    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(days=1))
        .not_valid_after(now + datetime.timedelta(days=365))
        .sign(key, hashes.SHA256())
    )
    return DtlsCertificate(key, cert)


class DtlsError(Exception):
    """Fatal protocol violation by the peer — alert + dead association."""


class DtlsDiscard(Exception):
    """Invalid record that must be SILENTLY dropped (RFC 6347 s4.1.2.7):
    decrypt failures and malformed structure are spoofable by any off-path
    sender, so treating them as fatal would be a one-datagram DoS."""


# every scalar a handshake handler may mutate BEFORE its body parse can
# raise.  The reassembly drain snapshots these and restores them on any
# plain-exception rewind — anything missing here becomes a one-datagram
# wedge: the mutated flag sticks, and the real peer's message then trips a
# repeat-guard forever.  One list, used for both save and
# restore, so the pairing cannot desync.
_SNAP_ATTRS = (
    "_peer_key_share",
    "_pre_master",
    "_session_hash",
    "_cert_verify_ok",
    "peer_cert_der",
    "_client_random",
    "_server_random",
    "_record_version",
    "_peer_wants_cert",
    "_ecdh_group",
    "_ems",
    "_peer_offered_ems",
    "_peer_offered_reneg",
    "srtp_profile",
    "_state",
)


class _Unexpected(Exception):
    """A handshake message that is valid in shape but arrives in a state
    (or order) where processing it would let a spoofed plaintext record
    mutate the association — state machine, transcript or msg_seq cursor.
    Deliberately NOT DtlsError/DtlsDiscard: the reassembly drain rewinds
    the seq cursor + transcript for plain exceptions before handle_datagram
    silently drops the record, so the real peer's message at that msg_seq
    still processes later."""


class _RecordCipher:
    """One direction of the epoch-1 AES-128-GCM record protection."""

    def __init__(self, key: bytes, implicit_iv: bytes):
        self.aead = AESGCM(key)
        self.iv = implicit_iv  # 4 bytes

    def seal(self, seq8: bytes, ctype: int, plaintext: bytes) -> bytes:
        # explicit nonce on the wire = the 8-byte epoch||seq (standard
        # practice; RFC 5288 only requires uniqueness)
        nonce = self.iv + seq8
        aad = seq8 + struct.pack("!BHH", ctype, DTLS_12, len(plaintext))
        return seq8 + self.aead.encrypt(nonce, plaintext, aad)

    def open(self, seq8: bytes, ctype: int, wire: bytes) -> bytes:
        if len(wire) < 8 + GCM_TAG_LEN:
            raise DtlsError("short GCM record")
        explicit, ct = wire[:8], wire[8:]
        nonce = self.iv + explicit
        aad = seq8 + struct.pack(
            "!BHH", ctype, DTLS_12, len(ct) - GCM_TAG_LEN
        )
        try:
            return self.aead.decrypt(nonce, ct, aad)
        except Exception as e:  # InvalidTag
            raise DtlsDiscard(f"record decrypt failed: {e}")


def _hs_header(msg_type: int, length: int, msg_seq: int) -> bytes:
    return (
        struct.pack("!B", msg_type)
        + length.to_bytes(3, "big")
        + struct.pack("!H", msg_seq)
        + (0).to_bytes(3, "big")
        + length.to_bytes(3, "big")
    )


class DtlsEndpoint:
    """One DTLS 1.2 association (sans-IO).

    Usage:
        server = DtlsEndpoint("server", cert)
        out = server.handle_datagram(dgram)      # -> datagrams to send
        ...
        if server.established:
            km = server.export_srtp_keying_material()

    A client additionally calls start() for its first flight."""

    MTU = 1200

    def __init__(
        self,
        role: str,
        certificate: DtlsCertificate | None = None,
        srtp_profiles: tuple = DEFAULT_SRTP_PROFILES,
        request_client_cert: bool = False,
        verify_fingerprint: str | None = None,
    ):
        assert role in ("server", "client")
        self.role = role
        self.cert = certificate or generate_certificate()
        self.srtp_profiles = srtp_profiles
        self.request_client_cert = request_client_cert
        # expected peer cert SHA-256 fingerprint (from the SDP a=fingerprint);
        # verified when the peer presents a certificate
        self.verify_fingerprint = verify_fingerprint
        self.established = False
        self.failed: str | None = None
        self.srtp_profile: int | None = None
        self.peer_cert_der: bytes | None = None
        self.alert_received: tuple | None = None

        self._cookie_secret = os.urandom(16)
        self._client_random = b""
        self._server_random = b""
        self._session_hash_input = bytearray()  # transcript (CH2 onward)
        self._master_secret: bytes | None = None
        self._pre_master: bytes | None = None
        self._ems = False
        self._peer_offered_ems = False
        self._peer_offered_reneg = False
        self._session_hash: bytes | None = None  # through ClientKeyExchange
        self._ecdh_private = None
        self._ecdh_group: int | None = None
        self._peer_key_share: bytes | None = None

        self._send_epoch = 0
        self._send_seq = {0: 0, 1: 0}
        self._recv_epoch = 0
        self._send_msg_seq = 0
        self._recv_next_seq = 0
        self._write_cipher: _RecordCipher | None = None
        self._read_cipher: _RecordCipher | None = None
        self._reassembly: dict = {}
        # epoch-1 anti-replay sliding window (RFC 6347 s4.1.2.6)
        self._replay_max = -1
        self._replay_mask = 0
        # records before version negotiation go out as DTLS 1.0 (the
        # ClientHello/HelloVerifyRequest convention); everything after must
        # say DTLS 1.2 — OpenSSL silently DISCARDS post-first-packet records
        # whose version differs from the negotiated one
        self._record_version = DTLS_10
        self._key_block: bytes | None = None
        self._dup_seen = False
        self._last_flight: list = []  # datagrams (for retransmit)
        self._appdata: list = []
        self._state = "WAIT_CH1" if role == "server" else "START"
        # client-side accumulators for the server flight
        # flips True only after a CertificateVerify signature checked out —
        # the server Finished handler requires it whenever a client cert
        # was requested (possession proof, RFC 8827 s6.5)
        self._cert_verify_ok = False
        self._peer_wants_cert = False
        # hello phase is STATELESS and restartable (RFC 6347 s4.2.1 server
        # philosophy): HVRs echo the peer's msg_seq and consume nothing; a
        # valid-cookie hello (re-)derives both msg_seq counters from itself.
        # _hvr_count bounds client-side restart thrash from spoofed HVRs;
        # _accepted_ch_* make the server's accept idempotent/replay-safe.
        self._hvr_count = 0
        self._accepted_ch_body: bytes | None = None
        self._accepted_ch_seq = -1
        # source address of the datagram currently being processed (when
        # the I/O layer supplies one) — binds the HVR cookie to the path
        self._dgram_addr: tuple | None = None
        # address that last successfully advanced the handshake: the
        # duplicate-triggered flight retransmit only answers this source
        self._assoc_addr: tuple | None = None

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def start(self) -> list:
        """Client only: produce the first ClientHello flight."""
        assert self.role == "client"
        self._client_random = os.urandom(32)
        ch = self._build_client_hello(cookie=b"")
        self._state = "WAIT_SH"
        flight = self._flush_handshake([(HT_CLIENT_HELLO, ch, False)])
        self._last_flight = flight
        return flight

    def handle_datagram(self, data: bytes, addr: tuple | None = None) -> list:
        """Feed one UDP datagram; returns datagrams to transmit.

        ``addr`` (optional) is the datagram's source address; when given,
        the server binds its HelloVerifyRequest cookie to it so a cookie
        minted for one source cannot validate a spoofed-source ClientHello
        (RFC 6347 s4.2.1 return-routability / anti-amplification)."""
        if self.failed is not None:
            return []  # dead association — a fatal alert already went out
        out: list = []
        self._dgram_addr = addr
        self._dup_seen = False
        off = 0
        while off + RECORD_HEADER_LEN <= len(data):
            ctype, ver, epoch = struct.unpack_from("!BHH", data, off)
            seq6 = data[off + 5 : off + 11]
            (length,) = struct.unpack_from("!H", data, off + 11)
            frag = data[off + RECORD_HEADER_LEN : off + RECORD_HEADER_LEN + length]
            off += RECORD_HEADER_LEN + length
            if len(frag) < length:
                break  # truncated datagram
            try:
                out.extend(self._handle_record(ctype, epoch, seq6, frag))
            except DtlsDiscard as e:
                logger.debug("dtls %s: discarding record (%s)", self.role, e)
                continue
            except DtlsError as e:
                # content-level protocol violation from the (sequenced) peer
                # conversation — fatal (bad Finished, fingerprint mismatch,
                # no common cipher, missing CertificateVerify)
                logger.warning("dtls %s: %s", self.role, e)
                self.failed = str(e)
                out.append(self._alert_datagram(2, 40))  # fatal handshake_failure
                return out
            except Exception as e:
                # malformed structure (truncated CKE, bogus key share…) is
                # unauthenticated at epoch 0 and therefore SPOOFABLE by any
                # off-path sender: silently discard the record (RFC 6347
                # s4.1.2.7) instead of handing a one-datagram kill switch to
                # whoever can hit this port.  The real peer retransmits.
                logger.debug(
                    "dtls %s: dropping malformed record (%s: %s)",
                    self.role,
                    type(e).__name__,
                    e,
                )
                continue
        if (
            self._dup_seen
            and not out
            and self._last_flight
            and (
                addr is None
                or self._assoc_addr is None
                or addr == self._assoc_addr
            )
        ):
            # the peer retransmitted a flight we already processed — our
            # answering flight was lost; resend it (once per datagram).
            # Address-gated: a stale-msg_seq record is a ~25-byte forgery,
            # and answering an arbitrary source with a ~1.5 KB flight would
            # be a 60x amplifier aimed wherever the attacker spoofs
            #
            out.extend(self._last_flight)
        return out

    def retransmit(self) -> list:
        """Resend the last flight (caller drives the timer)."""
        return list(self._last_flight)

    def send_application_data(self, payload: bytes) -> list:
        if not self.established:
            raise DtlsError("not established")
        return [self._encrypt_record(CT_APPDATA, payload)]

    def recv_application_data(self) -> list:
        out, self._appdata = self._appdata, []
        return out

    def export_srtp_keying_material(self, length: int | None = None) -> bytes:
        """RFC 5705 exporter, label "EXTRACTOR-dtls_srtp" (RFC 5764 s4.2).
        Length defaults to the negotiated profile's 2*(key+salt)."""
        if self._master_secret is None:
            raise DtlsError("handshake incomplete")
        if length is None:
            from .srtp import PROFILE_KEYING, keying_material_length

            if self.srtp_profile not in PROFILE_KEYING:
                raise DtlsError(
                    f"no supported SRTP profile negotiated "
                    f"({self.srtp_profile!r}) — pass an explicit length "
                    "for non-SRTP exporter uses"
                )
            length = keying_material_length(self.srtp_profile)
        return p_sha256(
            self._master_secret,
            b"EXTRACTOR-dtls_srtp",
            self._client_random + self._server_random,
            length,
        )

    def peer_fingerprint(self) -> str | None:
        if self.peer_cert_der is None:
            return None
        return fingerprint_of_der(self.peer_cert_der)

    def close(self) -> list:
        try:
            return [self._alert_datagram(1, 0)]  # warning close_notify
        except Exception:
            return []

    # ------------------------------------------------------------------
    # record layer
    # ------------------------------------------------------------------

    def _encrypt_record(self, ctype: int, payload: bytes) -> bytes:
        epoch = self._send_epoch
        seq = self._send_seq[epoch]
        self._send_seq[epoch] = seq + 1
        seq8 = struct.pack("!H", epoch) + seq.to_bytes(6, "big")
        if epoch == 0:
            body = payload
        else:
            body = self._write_cipher.seal(seq8, ctype, payload)
        return (
            struct.pack("!BH", ctype, DTLS_12 if epoch else self._record_version)
            + seq8
            + struct.pack("!H", len(body))
            + body
        )

    def _alert_datagram(self, level: int, desc: int) -> bytes:
        return self._encrypt_record(CT_ALERT, struct.pack("!BB", level, desc))

    def _handle_record(self, ctype: int, epoch: int, seq6: bytes, frag: bytes) -> list:
        if epoch != self._recv_epoch:
            # wrong-epoch records are dropped unauthenticated noise: an
            # epoch-1 record before CCS (peer will retransmit), or — the
            # security-relevant case — a spoofed PLAINTEXT epoch-0 record
            # after the handshake, which must never reach the alert or
            # handshake logic (flight recovery rides the authenticated
            # epoch-1 Finished duplicate instead)
            return []
        if epoch > 0:
            seq8 = struct.pack("!H", epoch) + seq6
            seq_int = int.from_bytes(seq6, "big")
            if not self._replay_ok(seq_int):
                # an exact replay is how a retransmitted final flight looks
                # when the peer resends identical bytes — treat it as the
                # our-flight-was-lost signal rather than processing it
                self._dup_seen = True
                return []
            frag = self._read_cipher.open(seq8, ctype, frag)
            self._replay_note(seq_int)
        if ctype == CT_CCS:
            # peer switches to its epoch-1 cipher for everything after.
            # CCS is ONE unauthenticated plaintext byte; accepting it in the
            # wrong state flips _recv_epoch early and the peer's remaining
            # plaintext flight (CertificateVerify!) gets wrong-epoch-dropped
            # into a fatal auth failure — so gate it to the
            # exact point the real peer sends it
            if self.role == "server":
                if self._state != "WAIT_CLIENT_FLIGHT" or (
                    self.request_client_cert and not self._cert_verify_ok
                ):
                    return []
            elif self._state != "WAIT_SERVER_FINISHED":
                return []
            self._derive_keys_if_needed()
            if self._key_block is None:
                return []  # CCS before key exchange completed — drop
            self._read_cipher = self._peer_cipher()
            self._recv_epoch = 1
            return []
        if ctype == CT_ALERT:
            if len(frag) >= 2:
                self.alert_received = (frag[0], frag[1])
                # only AUTHENTICATED (epoch-1) fatal alerts may kill the
                # association — an epoch-0 alert is one spoofed datagram
                # away from anyone who can reach the port
                if frag[0] == 2 and epoch > 0:
                    self.failed = f"peer fatal alert {frag[1]}"
            return []
        if ctype == CT_APPDATA:
            if self.established:
                self._appdata.append(frag)
            return []
        if ctype != CT_HANDSHAKE:
            return []
        return self._handle_handshake_fragment(frag)

    def _replay_ok(self, seq: int) -> bool:
        if seq > self._replay_max:
            return True
        diff = self._replay_max - seq
        if diff >= 64:
            return False
        return not (self._replay_mask >> diff) & 1

    def _replay_note(self, seq: int) -> None:
        if seq > self._replay_max:
            shift = seq - self._replay_max
            # clamp BEFORE shifting: a 2^48-range seq jump must not build a
            # terabit big-int on the way to the 64-bit mask
            if shift >= 64:
                self._replay_mask = 1
            else:
                self._replay_mask = (
                    (self._replay_mask << shift) | 1
                ) & 0xFFFFFFFFFFFFFFFF
            self._replay_max = seq
        else:
            self._replay_mask |= 1 << (self._replay_max - seq)

    # ------------------------------------------------------------------
    # handshake reassembly
    # ------------------------------------------------------------------

    def _handle_handshake_fragment(self, frag: bytes) -> list:
        out: list = []
        off = 0
        while off + HS_HEADER_LEN <= len(frag):
            msg_type = frag[off]
            total = int.from_bytes(frag[off + 1 : off + 4], "big")
            (msg_seq,) = struct.unpack_from("!H", frag, off + 4)
            frag_off = int.from_bytes(frag[off + 6 : off + 9], "big")
            frag_len = int.from_bytes(frag[off + 9 : off + 12], "big")
            body = frag[off + HS_HEADER_LEN : off + HS_HEADER_LEN + frag_len]
            off += HS_HEADER_LEN + frag_len
            if len(body) < frag_len:
                break
            # hello phase: handled OUT OF BAND, before any seq bookkeeping.
            # A racing/restarting peer's hello may carry any msg_seq (stale
            # or ahead); binding it to the in-order drain is exactly what
            # let one spoofed hello permanently desync the exchange.  CH/HVR are tiny — never fragmented in practice;
            # a fragmented one falls through to the drain and is rejected.
            if (
                frag_off == 0
                and frag_len == total
                and not self.established
                and (
                    (
                        self.role == "server"
                        and msg_type == HT_CLIENT_HELLO
                        and self._peer_key_share is None
                    )
                    or (
                        self.role == "client"
                        and msg_type == HT_HELLO_VERIFY_REQUEST
                        and not self._server_random
                    )
                )
            ):
                if self.role == "server":
                    out.extend(self._hello_phase_server(bytes(body), msg_seq))
                else:
                    out.extend(self._hello_phase_client(bytes(body), msg_seq))
                continue
            if msg_seq < self._recv_next_seq:
                # duplicate from the peer's last flight → ours was likely
                # lost; flag for a single resend (classic DTLS recovery)
                self._dup_seen = True
                continue
            # bound attacker-controlled allocations: no legitimate handshake
            # message here exceeds a few KB (largest: a certificate chain),
            # and flights never run more than a handful of messages ahead
            if total > 0x10000 or msg_seq >= self._recv_next_seq + 8:
                continue
            slot = self._reassembly.setdefault(
                msg_seq, [msg_type, total, bytearray(total), bytearray(total)]
            )
            if slot[0] != msg_type or slot[1] != total:
                continue  # inconsistent fragment — drop
            slot[2][frag_off : frag_off + frag_len] = body
            for i in range(frag_off, min(frag_off + frag_len, total)):
                slot[3][i] = 1
            # drain in-order completed messages
            while True:
                nxt = self._reassembly.get(self._recv_next_seq)
                if nxt is None or not all(nxt[3]):
                    break
                mtype, mtotal, mbody, _ = nxt
                del self._reassembly[self._recv_next_seq]
                seq = self._recv_next_seq
                self._recv_next_seq += 1
                # snapshot BEFORE processing: a malformed (possibly spoofed)
                # message may have been transcribed and half-parsed before
                # its body raised — without a full rewind the real peer's
                # retransmission would be transcribed a second time and the
                # Finished hashes could never match again
                t_len = len(self._session_hash_input)
                snap = tuple(getattr(self, a) for a in _SNAP_ATTRS)
                try:
                    out.extend(self._process_handshake(mtype, bytes(mbody), seq))
                    # remember which source address is actually speaking the
                    # handshake — the duplicate-triggered flight retransmit
                    # is gated on it (anti-amplification)
                    if self._dgram_addr is not None:
                        self._assoc_addr = self._dgram_addr
                except (DtlsError, DtlsDiscard):
                    raise
                except Exception as e:
                    self._recv_next_seq = seq
                    del self._session_hash_input[t_len:]
                    for a, v in zip(_SNAP_ATTRS, snap):
                        setattr(self, a, v)
                    # swallow, don't re-raise: this record is being silently
                    # dropped either way, but a re-raise would ALSO discard
                    # the response flights already accumulated in `out` for
                    # real messages processed earlier in this same drain —
                    # a spoofed pre-buffered junk message would then cost
                    # the peer a full retransmission timeout per flight
                    #
                    logger.debug(
                        "dtls %s: dropping handshake msg seq %d (%s: %s)",
                        self.role,
                        seq,
                        type(e).__name__,
                        e,
                    )
                    break
        return out

    def _transcribe(self, msg_type: int, body: bytes, msg_seq: int) -> None:
        self._session_hash_input += _hs_header(msg_type, len(body), msg_seq) + body

    def _transcript_hash(self) -> bytes:
        return hashlib.sha256(bytes(self._session_hash_input)).digest()

    # ------------------------------------------------------------------
    # handshake message construction
    # ------------------------------------------------------------------

    def _flush_handshake(self, msgs: list) -> list:
        """msgs: [(type, body, encrypted)] → records packed into datagrams.
        Each message is transcribed (unless it is CH1/HVR) and fragmented
        to MTU."""
        datagrams: list = []
        pending = b""
        for msg_type, body, encrypted in msgs:
            msg_seq = self._send_msg_seq
            self._send_msg_seq += 1
            transcribe = not (
                msg_type == HT_HELLO_VERIFY_REQUEST
                or (msg_type == HT_CLIENT_HELLO and self._ch_is_first(body))
            )
            if transcribe:
                self._transcribe(msg_type, body, msg_seq)
            # fragment
            max_frag = self.MTU - RECORD_HEADER_LEN - HS_HEADER_LEN - 64
            offsets = range(0, max(len(body), 1), max_frag)
            for fo in offsets:
                chunk = body[fo : fo + max_frag]
                hdr = (
                    struct.pack("!B", msg_type)
                    + len(body).to_bytes(3, "big")
                    + struct.pack("!H", msg_seq)
                    + fo.to_bytes(3, "big")
                    + len(chunk).to_bytes(3, "big")
                )
                record = self._encrypt_record(CT_HANDSHAKE, hdr + chunk) if encrypted else self._plain_record(CT_HANDSHAKE, hdr + chunk)
                if pending and len(pending) + len(record) > self.MTU:
                    datagrams.append(pending)
                    pending = b""
                pending += record
        if pending:
            datagrams.append(pending)
        return datagrams

    def _ch_is_first(self, body: bytes) -> bool:
        """A ClientHello with an empty cookie is the pre-cookie CH1 — it and
        the HelloVerifyRequest stay out of the transcript (RFC 6347 s4.2.1)."""
        try:
            return self._peek_hello(body)[1] == b""
        except (ValueError, IndexError):
            return False

    def _plain_record(self, ctype: int, payload: bytes) -> bytes:
        seq = self._send_seq[0]
        self._send_seq[0] = seq + 1
        seq8 = struct.pack("!H", 0) + seq.to_bytes(6, "big")
        return (
            struct.pack("!BH", ctype, self._record_version)
            + seq8
            + struct.pack("!H", len(payload))
            + payload
        )

    def _build_client_hello(self, cookie: bytes) -> bytes:
        exts = b""
        exts += struct.pack(
            "!HHH", EXT_SUPPORTED_GROUPS, 6, 4
        ) + struct.pack("!HH", GROUP_X25519, GROUP_SECP256R1)
        exts += struct.pack("!HH", EXT_EC_POINT_FORMATS, 2) + b"\x01\x00"
        exts += struct.pack(
            "!HHH", EXT_SIGNATURE_ALGORITHMS, 4, 2
        ) + struct.pack("!H", SIG_ECDSA_SECP256R1_SHA256)
        profiles = b"".join(struct.pack("!H", p) for p in self.srtp_profiles)
        exts += (
            struct.pack("!HH", EXT_USE_SRTP, len(profiles) + 3)
            + struct.pack("!H", len(profiles))
            + profiles
            + b"\x00"
        )
        exts += struct.pack("!HH", EXT_EXTENDED_MASTER_SECRET, 0)
        exts += struct.pack("!HH", EXT_RENEGOTIATION_INFO, 1) + b"\x00"
        body = struct.pack("!H", DTLS_12) + self._client_random
        body += b"\x00"  # session id
        body += struct.pack("!B", len(cookie)) + cookie
        body += struct.pack("!H", 2) + struct.pack(
            "!H", CIPHER_ECDHE_ECDSA_AES128_GCM_SHA256
        )
        body += b"\x01\x00"  # compression: null
        body += struct.pack("!H", len(exts)) + exts
        return body

    # ------------------------------------------------------------------
    # handshake state machine
    # ------------------------------------------------------------------

    def _process_handshake(self, msg_type: int, body: bytes, msg_seq: int) -> list:
        if self.role == "server":
            return self._server_process(msg_type, body, msg_seq)
        return self._client_process(msg_type, body, msg_seq)

    # ---------------- server ----------------

    def _server_process(self, msg_type: int, body: bytes, msg_seq: int) -> list:
        if msg_type == HT_CLIENT_HELLO:
            # real hellos are intercepted statelessly pre-drain; one that
            # reaches the in-order drain is fragmented (no real browser
            # fragments a CH) or arrived after the key exchange — spoof
            # either way
            raise _Unexpected(f"ClientHello in state {self._state}")
        if msg_type == HT_CERTIFICATE and self._state == "WAIT_CLIENT_FLIGHT":
            if self._peer_key_share is not None:
                # the client flight orders Certificate → ClientKeyExchange →
                # CertificateVerify (RFC 5246 s7.4.8); a certificate landing
                # AFTER the CKE is how a replayed cert would dodge the
                # CertificateVerify it owes
                raise _Unexpected("client Certificate after ClientKeyExchange")
            if not self.request_client_cert or self.peer_cert_der is not None:
                # unsolicited or repeated client Certificate: no legitimate
                # client sends one we didn't request, or sends two — only a
                # spoof does, and processing it would pollute the transcript
                # or overwrite the identity
                raise _Unexpected("unsolicited/repeated client Certificate")
            self._transcribe(msg_type, body, msg_seq)
            self._parse_peer_certificate(body)
            return []
        if msg_type == HT_CLIENT_KEY_EXCHANGE and self._state == "WAIT_CLIENT_FLIGHT":
            if self.request_client_cert and self.peer_cert_der is None:
                # when a certificate was requested it must precede the CKE;
                # accepting the CKE first would let the whole client-auth
                # requirement evaporate with the Certificate message
                raise _Unexpected("ClientKeyExchange before required client Certificate")
            self._transcribe(msg_type, body, msg_seq)
            plen = body[0]
            self._peer_key_share = body[1 : 1 + plen]
            self._compute_pre_master()
            # EMS session hash: transcript through ClientKeyExchange
            self._session_hash = self._transcript_hash()
            return []
        if msg_type == HT_CERTIFICATE_VERIFY and self._state == "WAIT_CLIENT_FLIGHT":
            if self.peer_cert_der is None or self._peer_key_share is None:
                raise _Unexpected(
                    "CertificateVerify before Certificate/ClientKeyExchange"
                )
            self._verify_certificate_verify(body)
            self._transcribe(msg_type, body, msg_seq)
            self._cert_verify_ok = True
            return []
        if msg_type == HT_FINISHED and self._state == "WAIT_CLIENT_FLIGHT":
            if self._recv_epoch == 0:
                # a legitimate Finished always arrives AFTER the peer's CCS,
                # i.e. encrypted on epoch 1 — a plaintext epoch-0 Finished
                # is a forgery and must not reach the fatal verify/auth
                # checks below
                raise _Unexpected("plaintext Finished before ChangeCipherSpec")
            if self.request_client_cert and not self._cert_verify_ok:
                # the requested client auth never completed — the client
                # presented a (possibly replayed) certificate without the
                # CertificateVerify that proves key possession, omitted its
                # Certificate entirely, or smuggled it outside the
                # Certificate→CKE→CertificateVerify order; with an
                # SDP-pinned identity this is mandatory (RFC 8827 s6.5)
                raise DtlsError(
                    "client authentication incomplete: no verified "
                    "Certificate/CertificateVerify before Finished"
                )
            self._derive_keys_if_needed()
            expect = p_sha256(
                self._master_secret,
                b"client finished",
                self._transcript_hash(),
                VERIFY_DATA_LEN,
            )
            if not hmac.compare_digest(expect, body):
                raise DtlsError("client Finished verify_data mismatch")
            self._transcribe(msg_type, body, msg_seq)
            # flight 6: CCS + server Finished
            ccs = self._plain_record(CT_CCS, b"\x01")
            self._send_epoch = 1
            self._write_cipher = self._own_cipher()
            verify = p_sha256(
                self._master_secret,
                b"server finished",
                self._transcript_hash(),
                VERIFY_DATA_LEN,
            )
            fin = self._flush_handshake([(HT_FINISHED, verify, True)])
            self.established = True
            self._state = "ESTABLISHED"
            flight = [ccs + fin[0]] + fin[1:]
            self._last_flight = flight
            return flight
        # no branch matched: wrong type for this state.  Raise (→ seq-cursor
        # rewind + silent drop) rather than return []: a plain return would
        # CONSUME the msg_seq, turning the real peer's message at that seq
        # into a permanent duplicate — a spoofed livelock
        raise _Unexpected(
            f"handshake type {msg_type} in server state {self._state}"
        )

    # ---------------- hello phase (stateless, restartable) ----------------

    @staticmethod
    def _peek_hello(body: bytes) -> tuple:
        """Pure parse of (client_random, cookie) from a ClientHello body —
        raises on truncation BEFORE any state is touched."""
        off = 2
        client_random = bytes(body[off : off + 32])
        if len(client_random) != 32:
            raise ValueError("short ClientHello")
        off += 32
        sid_len = body[off]
        off += 1 + sid_len
        cookie_len = body[off]
        cookie = bytes(body[off + 1 : off + 1 + cookie_len])
        if len(cookie) != cookie_len:
            raise ValueError("short ClientHello cookie")
        return client_random, cookie

    def _hello_phase_server(self, body: bytes, msg_seq: int) -> list:
        client_random, cookie = self._peek_hello(body)
        expected = self._cookie_for(client_random)
        if not cookie or not hmac.compare_digest(cookie, expected):
            if self._accepted_ch_body is not None:
                # a wrong-cookie hello after we already accepted one is a
                # spoof (or a mid-handshake NAT rebind, vanishingly rare
                # under ICE) — restarting the exchange for it would let any
                # blind forgery reset the real client's progress
                raise _Unexpected("wrong-cookie ClientHello after accept")
            # stateless HelloVerifyRequest: echo the hello's msg_seq and
            # touch no sequencing/transcript state — every racing or
            # restarting client gets a usable cookie and nothing to poison
            # (RFC 6347 s4.2.1).  The WAIT_CH2 label is introspection-only
            # (nothing branches on CH1-vs-CH2; tests and logs read it).
            hvr = (
                struct.pack("!H", DTLS_10)
                + struct.pack("!B", len(expected))
                + expected
            )
            rec = self._plain_record(
                CT_HANDSHAKE, _hs_header(HT_HELLO_VERIFY_REQUEST, len(hvr), msg_seq) + hvr
            )
            self._state = "WAIT_CH2"
            return [rec]
        if self._accepted_ch_body is not None:
            if (
                body == self._accepted_ch_body
                and msg_seq == self._accepted_ch_seq
            ):
                # pure retransmit of the accepted hello → our flight was
                # lost.  Ride the duplicate path's single end-of-datagram
                # resend (address-gated, once per datagram) instead of
                # emitting the flight here: N replayed copies packed into
                # one datagram must not extract N flights
                self._dup_seen = True
                return []
            if body != self._accepted_ch_body:
                # valid cookie but different hello after accept: only an
                # observing injector can build this (cookie+random ride the
                # wire) — documented concession; never restart for it
                raise _Unexpected("divergent ClientHello after accept")
            # same body, new msg_seq: the client restarted its hello (a
            # spoofed HVR reset it) — restart our side in lockstep
        return self._accept_client_hello(body, msg_seq)

    def _accept_client_hello(self, body: bytes, msg_seq: int) -> list:
        # the accepted hello DEFINES the handshake: both msg_seq cursors
        # derive from it (our flight answers at its seq — the convention
        # OpenSSL's DTLSv1_listen follows), and everything negotiated by a
        # previous accept of this association is recomputed
        self._session_hash_input = bytearray()
        self._reassembly.clear()
        self._recv_next_seq = msg_seq + 1
        self._send_msg_seq = msg_seq
        self.peer_cert_der = None
        self._cert_verify_ok = False
        self._pre_master = None
        self._master_secret = None
        self._session_hash = None
        self._key_block = None
        self._accepted_ch_body = body
        self._accepted_ch_seq = msg_seq
        if self._dgram_addr is not None:
            self._assoc_addr = self._dgram_addr
        return self._server_on_client_hello(body, msg_seq)

    def _server_on_client_hello(self, body: bytes, msg_seq: int) -> list:
        # parse (cookie already validated by _hello_phase_server)
        off = 0
        (client_version,) = struct.unpack_from("!H", body, off)
        off += 2
        client_random = body[off : off + 32]
        off += 32
        sid_len = body[off]
        off += 1 + sid_len
        cookie_len = body[off]
        cookie = body[off + 1 : off + 1 + cookie_len]
        off += 1 + cookie_len
        (cs_len,) = struct.unpack_from("!H", body, off)
        off += 2
        ciphers = [
            struct.unpack_from("!H", body, off + i)[0] for i in range(0, cs_len, 2)
        ]
        off += cs_len
        comp_len = body[off]
        off += 1 + comp_len
        exts = self._parse_extensions(body[off:])

        # CH2 accepted — everything we send from here is DTLS 1.2
        self._record_version = DTLS_12
        self._transcribe(HT_CLIENT_HELLO, body, msg_seq)
        self._client_random = client_random
        if CIPHER_ECDHE_ECDSA_AES128_GCM_SHA256 not in ciphers:
            raise DtlsError("no common cipher suite (need 0xC02B)")
        if client_version < DTLS_12:  # DTLS versions compare inverted
            pass  # fefd < feff numerically; accept any >= 1.0, negotiate 1.2
        groups = exts.get(EXT_SUPPORTED_GROUPS, b"")
        offered_groups = []
        if len(groups) >= 2:
            (glen,) = struct.unpack_from("!H", groups, 0)
            offered_groups = [
                struct.unpack_from("!H", groups, 2 + i)[0]
                for i in range(0, min(glen, len(groups) - 2), 2)
            ]
        if GROUP_X25519 in offered_groups or not offered_groups:
            self._ecdh_group = GROUP_X25519
        elif GROUP_SECP256R1 in offered_groups:
            self._ecdh_group = GROUP_SECP256R1
        else:
            raise DtlsError("no common ECDH group")
        self._peer_offered_ems = EXT_EXTENDED_MASTER_SECRET in exts
        self._peer_offered_reneg = EXT_RENEGOTIATION_INFO in exts or 0x00FF in (
            ciphers
        )
        srtp = exts.get(EXT_USE_SRTP)
        if srtp and len(srtp) >= 2:
            (plen,) = struct.unpack_from("!H", srtp, 0)
            offered = [
                struct.unpack_from("!H", srtp, 2 + i)[0]
                for i in range(0, min(plen, len(srtp) - 2), 2)
            ]
            for p in self.srtp_profiles:
                if p in offered:
                    self.srtp_profile = p
                    break

        self._server_random = os.urandom(32)
        self._ems = self._peer_offered_ems

        # ServerHello
        exts_out = b""
        if self._peer_offered_reneg:
            exts_out += struct.pack("!HH", EXT_RENEGOTIATION_INFO, 1) + b"\x00"
        exts_out += struct.pack("!HH", EXT_EC_POINT_FORMATS, 2) + b"\x01\x00"
        if self.srtp_profile is not None:
            exts_out += (
                struct.pack("!HH", EXT_USE_SRTP, 5)
                + struct.pack("!H", 2)
                + struct.pack("!H", self.srtp_profile)
                + b"\x00"
            )
        if self._ems:
            exts_out += struct.pack("!HH", EXT_EXTENDED_MASTER_SECRET, 0)
        sh = (
            struct.pack("!H", DTLS_12)
            + self._server_random
            + b"\x00"  # session id
            + struct.pack("!H", CIPHER_ECDHE_ECDSA_AES128_GCM_SHA256)
            + b"\x00"  # compression
            + struct.pack("!H", len(exts_out))
            + exts_out
        )

        # Certificate
        cert_entry = len(self.cert.der).to_bytes(3, "big") + self.cert.der
        cert_msg = len(cert_entry).to_bytes(3, "big") + cert_entry

        # ServerKeyExchange
        if self._ecdh_group == GROUP_X25519:
            self._ecdh_private = x25519.X25519PrivateKey.generate()
            pub = self._ecdh_private.public_key().public_bytes(
                serialization.Encoding.Raw, serialization.PublicFormat.Raw
            )
        else:
            self._ecdh_private = ec.generate_private_key(ec.SECP256R1())
            pub = self._ecdh_private.public_key().public_bytes(
                serialization.Encoding.X962,
                serialization.PublicFormat.UncompressedPoint,
            )
        params = (
            b"\x03"
            + struct.pack("!H", self._ecdh_group)
            + struct.pack("!B", len(pub))
            + pub
        )
        signed = self._client_random + self._server_random + params
        sig = self.cert.private_key.sign(signed, ec.ECDSA(hashes.SHA256()))
        ske = (
            params
            + struct.pack("!H", SIG_ECDSA_SECP256R1_SHA256)
            + struct.pack("!H", len(sig))
            + sig
        )

        msgs = [
            (HT_SERVER_HELLO, sh, False),
            (HT_CERTIFICATE, cert_msg, False),
            (HT_SERVER_KEY_EXCHANGE, ske, False),
        ]
        if self.request_client_cert:
            # ecdsa_sign cert type, sha256/ecdsa sig alg, no CA names
            creq = (
                b"\x01\x40"
                + struct.pack("!H", 2)
                + struct.pack("!H", SIG_ECDSA_SECP256R1_SHA256)
                + struct.pack("!H", 0)
            )
            msgs.append((HT_CERTIFICATE_REQUEST, creq, False))
        msgs.append((HT_SERVER_HELLO_DONE, b"", False))
        flight = self._flush_handshake(msgs)
        self._last_flight = flight
        self._state = "WAIT_CLIENT_FLIGHT"
        return flight

    def _cookie_for(self, client_random: bytes) -> bytes:
        """HVR cookie: HMAC over the client random AND (when the I/O layer
        passes one) the datagram's source address, so a cookie the attacker
        legitimately obtained at its own address cannot be replayed with a
        spoofed source to aim our ~1.5 KB certificate flight at a victim
        (RFC 6347 s4.2.1)."""
        addr = b"" if self._dgram_addr is None else repr(self._dgram_addr).encode()
        return hmac.new(
            self._cookie_secret, client_random + addr, hashlib.sha256
        ).digest()[:16]

    def _parse_peer_certificate(self, body: bytes) -> None:
        total = int.from_bytes(body[0:3], "big")
        if total == 0:
            if self.verify_fingerprint:
                # the SDP pinned an identity — a peer declining to present
                # its certificate must not complete the handshake, or the
                # pin is advisory (RFC 8827 s6.5 makes it mandatory)
                raise DtlsError(
                    "peer declined to present a certificate but the SDP "
                    "pins a fingerprint"
                )
            if self.role == "server" and self.request_client_cert:
                # spec-legal decline (RFC 5246 s7.4.6) of auth we require:
                # answer with a FATAL alert, not the silent stall the CKE
                # ordering guard would otherwise produce
                raise DtlsError(
                    "client answered CertificateRequest with an empty "
                    "certificate list"
                )
            self.peer_cert_der = None  # empty list (no client cert)
            return
        first_len = int.from_bytes(body[3:6], "big")
        self.peer_cert_der = bytes(body[6 : 6 + first_len])
        if self.verify_fingerprint:
            got = fingerprint_of_der(self.peer_cert_der)
            if got.lower() != self.verify_fingerprint.lower():
                raise DtlsError(
                    "peer certificate fingerprint mismatch "
                    f"(sdp {self.verify_fingerprint[:16]}…, dtls {got[:16]}…)"
                )

    def _verify_certificate_verify(self, body: bytes) -> None:
        # structural defects are discard-class, not fatal: a malformed CV is
        # a ~25-byte plaintext forgery anyone can aim at the port, and the
        # real client's well-formed CV should still process afterwards
        #.  Only a failed SIGNATURE check is fatal.
        if len(body) < 4:
            raise _Unexpected("short CertificateVerify")
        (alg,) = struct.unpack_from("!H", body, 0)
        (slen,) = struct.unpack_from("!H", body, 2)
        sig = body[4 : 4 + slen]
        if alg != SIG_ECDSA_SECP256R1_SHA256:
            raise _Unexpected(f"unsupported CertificateVerify alg {alg:#06x}")
        pub = x509.load_der_x509_certificate(self.peer_cert_der).public_key()
        try:
            pub.verify(
                sig, bytes(self._session_hash_input), ec.ECDSA(hashes.SHA256())
            )
        except Exception:
            raise DtlsError("CertificateVerify signature invalid")

    # ---------------- client ----------------

    def _hello_phase_client(self, body: bytes, msg_seq: int) -> list:
        """Stateless HVR handling: restart the hello with the offered
        cookie, deriving the expected server-flight msg_seq from our own
        hello's (the accept convention).  Bounded so spoofed HVRs cost RTTs,
        never the handshake."""
        if self._state != "WAIT_SH":
            raise _Unexpected("HelloVerifyRequest before start")
        if self._hvr_count >= 8:
            # restart-thrash bound (a real exchange uses 1-2): fail LOUDLY —
            # silently dropping would let 8 junk HVRs park the handshake in
            # a signal-less livelock; a clean `failed` lets the signaling
            # layer re-offer
            raise DtlsError("HelloVerifyRequest restart budget exhausted")
        cookie_len = body[2]
        cookie = bytes(body[3 : 3 + cookie_len])  # raises → silent discard
        self._hvr_count += 1
        # cookied CH restarts the transcript (CH1/HVR excluded, RFC 6347)
        self._session_hash_input = bytearray()
        self._reassembly.clear()
        ch = self._build_client_hello(cookie=cookie)
        ch_seq = self._send_msg_seq
        flight = self._flush_handshake([(HT_CLIENT_HELLO, ch, False)])
        # the server's accepting flight answers at OUR hello's msg_seq
        self._recv_next_seq = ch_seq
        self._last_flight = flight
        return flight

    def _client_process(self, msg_type: int, body: bytes, msg_seq: int) -> list:
        if msg_type == HT_HELLO_VERIFY_REQUEST:
            # real HVRs are intercepted statelessly pre-drain; one that gets
            # here is post-ServerHello, fragmented, or mid-key-exchange —
            # a spoof in every case
            raise _Unexpected("unexpected HelloVerifyRequest")
        if msg_type == HT_SERVER_HELLO:
            if self._state != "WAIT_SH" or self._server_random:
                raise _Unexpected("repeated/unexpected ServerHello")
            self._record_version = DTLS_12
            self._transcribe(msg_type, body, msg_seq)
            self._server_random = body[2:34]
            off = 34
            sid_len = body[off]
            off += 1 + sid_len
            (cipher,) = struct.unpack_from("!H", body, off)
            off += 3  # cipher + compression
            if cipher != CIPHER_ECDHE_ECDSA_AES128_GCM_SHA256:
                raise DtlsError(f"server chose unsupported cipher {cipher:#06x}")
            exts = {}
            if off + 2 <= len(body):
                exts = self._parse_extensions(body[off:])
            self._ems = EXT_EXTENDED_MASTER_SECRET in exts
            srtp = exts.get(EXT_USE_SRTP)
            if srtp and len(srtp) >= 4:
                chosen = struct.unpack_from("!H", srtp, 2)[0]
                if chosen not in self.srtp_profiles:
                    # a server may only echo something WE offered
                    raise DtlsError(
                        f"server chose unoffered SRTP profile {chosen:#06x}"
                    )
                self.srtp_profile = chosen
            return []
        if msg_type == HT_CERTIFICATE:
            # server-flight ordering + repeat guards: each
            # flight-4 message is legitimate exactly once, after ServerHello
            # and before the client's final flight goes out — anything else
            # is a spoof/replay whose processing would pollute the
            # transcript or overwrite negotiated state
            if (
                self._state != "WAIT_SH"
                or not self._server_random
                or self.peer_cert_der is not None
            ):
                raise _Unexpected("unexpected/repeated server Certificate")
            self._transcribe(msg_type, body, msg_seq)
            self._parse_peer_certificate(body)
            return []
        if msg_type == HT_SERVER_KEY_EXCHANGE:
            if (
                self._state != "WAIT_SH"
                or self.peer_cert_der is None
                or self._peer_key_share is not None
            ):
                raise _Unexpected("unexpected/repeated ServerKeyExchange")
            self._transcribe(msg_type, body, msg_seq)
            if body[0] != 3:
                raise DtlsError("only named_curve ECDHE supported")
            (group,) = struct.unpack_from("!H", body, 1)
            plen = body[3]
            point = body[4 : 4 + plen]
            off = 4 + plen
            (alg,) = struct.unpack_from("!H", body, off)
            (slen,) = struct.unpack_from("!H", body, off + 2)
            sig = body[off + 4 : off + 4 + slen]
            # verify the params signature against the server certificate
            params = body[: 4 + plen]
            signed = self._client_random + self._server_random + params
            pub = x509.load_der_x509_certificate(self.peer_cert_der).public_key()
            try:
                pub.verify(sig, signed, ec.ECDSA(hashes.SHA256()))
            except Exception:
                raise DtlsError("ServerKeyExchange signature invalid")
            self._ecdh_group = group
            self._peer_key_share = point
            return []
        if msg_type == HT_CERTIFICATE_REQUEST:
            if (
                self._state != "WAIT_SH"
                or not self._server_random
                or self._peer_wants_cert
            ):
                raise _Unexpected("unexpected/repeated CertificateRequest")
            self._transcribe(msg_type, body, msg_seq)
            self._peer_wants_cert = True
            return []
        if msg_type == HT_SERVER_HELLO_DONE:
            # repeat guard matters here more than anywhere: re-running
            # _client_final_flight would regenerate the ECDH key and fork
            # the transcript — an unrecoverable wedge from an EMPTY spoofed
            # message
            if self._state != "WAIT_SH" or self._peer_key_share is None:
                raise _Unexpected("unexpected/repeated ServerHelloDone")
            self._transcribe(msg_type, body, msg_seq)
            return self._client_final_flight()
        if msg_type == HT_FINISHED:
            if self._state != "WAIT_SERVER_FINISHED" or self._recv_epoch == 0:
                # same epoch gate as the server side: Finished rides epoch 1
                raise _Unexpected("unexpected/plaintext server Finished")
            self._derive_keys_if_needed()
            expect = p_sha256(
                self._master_secret,
                b"server finished",
                self._transcript_hash(),
                VERIFY_DATA_LEN,
            )
            if not hmac.compare_digest(expect, body):
                raise DtlsError("server Finished verify_data mismatch")
            self._transcribe(msg_type, body, msg_seq)
            self.established = True
            self._state = "ESTABLISHED"
            return []
        # same rationale as the server-side fall-through: never silently
        # consume a msg_seq for a message no state expects
        raise _Unexpected(
            f"handshake type {msg_type} in client state {self._state}"
        )

    def _client_final_flight(self) -> list:
        msgs = []
        if self._peer_wants_cert:
            cert_entry = len(self.cert.der).to_bytes(3, "big") + self.cert.der
            cert_msg = len(cert_entry).to_bytes(3, "big") + cert_entry
            msgs.append((HT_CERTIFICATE, cert_msg, False))
        # ClientKeyExchange
        if self._ecdh_group == GROUP_X25519:
            self._ecdh_private = x25519.X25519PrivateKey.generate()
            pub = self._ecdh_private.public_key().public_bytes(
                serialization.Encoding.Raw, serialization.PublicFormat.Raw
            )
        else:
            self._ecdh_private = ec.generate_private_key(ec.SECP256R1())
            pub = self._ecdh_private.public_key().public_bytes(
                serialization.Encoding.X962,
                serialization.PublicFormat.UncompressedPoint,
            )
        cke = struct.pack("!B", len(pub)) + pub
        msgs.append((HT_CLIENT_KEY_EXCHANGE, cke, False))
        pre_flight = self._flush_handshake(msgs)
        self._compute_pre_master()
        self._session_hash = self._transcript_hash()
        cv_flight: list = []
        if self._peer_wants_cert:
            sig = self.cert.private_key.sign(
                bytes(self._session_hash_input), ec.ECDSA(hashes.SHA256())
            )
            cv = (
                struct.pack("!H", SIG_ECDSA_SECP256R1_SHA256)
                + struct.pack("!H", len(sig))
                + sig
            )
            cv_flight = self._flush_handshake([(HT_CERTIFICATE_VERIFY, cv, False)])
        self._derive_keys_if_needed()
        ccs = self._plain_record(CT_CCS, b"\x01")
        self._send_epoch = 1
        self._write_cipher = self._own_cipher()
        verify = p_sha256(
            self._master_secret,
            b"client finished",
            self._transcript_hash(),
            VERIFY_DATA_LEN,
        )
        fin = self._flush_handshake([(HT_FINISHED, verify, True)])
        flight = pre_flight + cv_flight + [ccs + fin[0]] + fin[1:]
        self._last_flight = flight
        self._state = "WAIT_SERVER_FINISHED"
        return flight

    # ------------------------------------------------------------------
    # key schedule
    # ------------------------------------------------------------------

    def _compute_pre_master(self) -> None:
        if self._ecdh_group == GROUP_X25519:
            peer = x25519.X25519PublicKey.from_public_bytes(
                bytes(self._peer_key_share)
            )
            self._pre_master = self._ecdh_private.exchange(peer)
        else:
            peer = ec.EllipticCurvePublicKey.from_encoded_point(
                ec.SECP256R1(), bytes(self._peer_key_share)
            )
            self._pre_master = self._ecdh_private.exchange(ec.ECDH(), peer)

    def _derive_keys_if_needed(self) -> None:
        if self._master_secret is not None or self._pre_master is None:
            return
        if self._ems:
            self._master_secret = p_sha256(
                self._pre_master,
                b"extended master secret",
                self._session_hash,
                MASTER_SECRET_LEN,
            )
        else:
            self._master_secret = p_sha256(
                self._pre_master,
                b"master secret",
                self._client_random + self._server_random,
                MASTER_SECRET_LEN,
            )
        # AEAD key block: client_key(16) server_key(16) client_iv(4) server_iv(4)
        kb = p_sha256(
            self._master_secret,
            b"key expansion",
            self._server_random + self._client_random,
            40,
        )
        self._key_block = kb

    def _own_cipher(self) -> _RecordCipher:
        kb = self._key_block
        if self.role == "client":
            return _RecordCipher(kb[0:16], kb[32:36])
        return _RecordCipher(kb[16:32], kb[36:40])

    def _peer_cipher(self) -> _RecordCipher:
        kb = self._key_block
        if self.role == "client":
            return _RecordCipher(kb[16:32], kb[36:40])
        return _RecordCipher(kb[0:16], kb[32:36])

    # ------------------------------------------------------------------

    @staticmethod
    def _parse_extensions(data: bytes) -> dict:
        out: dict = {}
        if len(data) < 2:
            return out
        (total,) = struct.unpack_from("!H", data, 0)
        off = 2
        end = min(2 + total, len(data))
        while off + 4 <= end:
            etype, elen = struct.unpack_from("!HH", data, off)
            off += 4
            out[etype] = data[off : off + elen]
            off += elen
        return out
