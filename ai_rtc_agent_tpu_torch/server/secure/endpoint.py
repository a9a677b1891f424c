"""RFC 7983 demux: STUN + DTLS + SRTP/SRTCP on one UDP socket.

The port's copy of ai_rtc_agent_tpu/server/secure/endpoint.py.  aiortc
runs this multiplexing inside its RTCDtlsTransport/RTCIceTransport pair;
`SecureMediaSession` is the agent's sans-IO equivalent, composed from
the three protocol modules in this package.  The asyncio plumbing lives in
server/rtc_native.py (`_RtpReceiverProtocol`).

Demux rule (RFC 7983 s7): first byte 0..3 → STUN, 20..63 → DTLS,
128..191 → RTP/RTCP (RTCP when the full second byte is 192..223,
i.e. payload types 200-206 — RFC 5761 s4).
"""

from __future__ import annotations

import logging

from ...media.rtcp import is_rtcp
from .dtls import DtlsEndpoint, DtlsCertificate, generate_certificate
from .srtp import PROFILE_KEYING, derive_srtp_contexts
from .stun import IceLiteResponder, is_stun

logger = logging.getLogger(__name__)


def classify(datagram: bytes) -> str:
    if not datagram:
        return "drop"
    b = datagram[0]
    if b < 4:
        return "stun" if is_stun(datagram) else "drop"
    if 20 <= b <= 63:
        return "dtls"
    if 128 <= b <= 191:
        if is_rtcp(datagram):
            return "rtcp"
        return "rtp"
    return "drop"


class SecureMediaSession:
    """Security state for ONE peer on one socket: ICE-lite responder, a
    DTLS server endpoint, and the SRTP contexts derived when the handshake
    completes.

    Sans-IO: `handle(datagram, addr)` returns
        (to_send: list[(bytes, addr)], kind: str, plaintext: bytes | None)
    where `plaintext` is the unprotected RTP/RTCP payload when kind is
    "rtp"/"rtcp" and the handshake is done.  Outbound media goes through
    `protect_rtp` / `protect_rtcp` (None until keys exist)."""

    def __init__(
        self,
        certificate: DtlsCertificate | None = None,
        remote_fingerprint: str | None = None,
        remote_ufrag: str | None = None,
        ice_ufrag: str | None = None,
        ice_pwd: str | None = None,
        stats=None,
    ):
        self.stats = stats  # FrameStats: secure counters land in /metrics
        if stats is not None:
            # pre-register at 0 so monitoring sees the gauges from the
            # first scrape — "key missing" must not be confusable with
            # "secure tier not wired"
            stats.count("secure_sessions", 0)
            stats.count("srtp_drops", 0)
        self.cert = certificate or generate_certificate()
        self.ice = IceLiteResponder(ufrag=ice_ufrag, pwd=ice_pwd)
        self.ice.set_remote(remote_ufrag, None)
        # WebRTC requires verifying the peer's certificate against its SDP
        # fingerprint (RFC 8827 s6.5) — request the client cert whenever the
        # offer carried one
        self.dtls = DtlsEndpoint(
            "server",
            self.cert,
            request_client_cert=remote_fingerprint is not None,
            verify_fingerprint=remote_fingerprint,
        )
        self.tx_srtp = None
        self.rx_srtp = None
        self._handshake_done_cb = None
        self.peer_addr: tuple | None = None
        # optional SCTP association (WebRTC datachannels, RFC 8831): SCTP
        # packets ride the DTLS session as application data (RFC 8261)
        self.sctp = None

    # ------------------------------------------------------------------

    @property
    def established(self) -> bool:
        return self.dtls.established and self.rx_srtp is not None

    def on_established(self, cb) -> None:
        self._handshake_done_cb = cb

    def fingerprint(self) -> str:
        return self.cert.fingerprint

    def handle(self, datagram: bytes, addr: tuple):
        kind = classify(datagram)
        out: list = []
        payload = None
        if kind == "stun":
            reply = self.ice.handle(datagram, addr)
            if reply is not None:
                out.append((reply, addr))
            if self.ice.nominated_addr is not None:
                self.peer_addr = self.ice.nominated_addr
        elif kind == "dtls":
            was_established = self.dtls.established
            for d in self.dtls.handle_datagram(datagram, addr):
                out.append((d, addr))
            if self.dtls.established:
                self.peer_addr = self.peer_addr or addr
                if not was_established:
                    self._derive_srtp()
            # DTLS application data = SCTP packets (datachannel plane)
            msgs = self.dtls.recv_application_data()
            if msgs and self.sctp is not None:
                for m in msgs:
                    for reply in self.sctp.handle_packet(m):
                        for d in self.dtls.send_application_data(reply):
                            out.append((d, addr))
        elif kind == "rtp":
            if self.rx_srtp is not None:
                try:
                    payload = self.rx_srtp.unprotect(datagram)
                except ValueError as e:
                    logger.debug("srtp drop: %s", e)
                    kind = "drop"
                    if self.stats is not None:
                        self.stats.count("srtp_drops")
            else:
                kind = "drop"  # media before keys — never pass unprotected
        elif kind == "rtcp":
            if self.rx_srtp is not None:
                try:
                    payload = self.rx_srtp.unprotect_rtcp(datagram)
                except ValueError as e:
                    logger.debug("srtcp drop: %s", e)
                    kind = "drop"
                    if self.stats is not None:
                        self.stats.count("srtp_drops")
            else:
                kind = "drop"
        return out, kind, payload

    def _derive_srtp(self) -> None:
        profile = self.dtls.srtp_profile
        if profile not in PROFILE_KEYING:
            logger.warning(
                "dtls done but no usable SRTP profile (%s) — media stays off",
                profile,
            )
            return
        km = self.dtls.export_srtp_keying_material()  # profile-sized
        self.tx_srtp, self.rx_srtp = derive_srtp_contexts(
            km, is_server=True, profile=profile
        )
        logger.info(
            "DTLS-SRTP established (peer fp %s…)",
            (self.dtls.peer_fingerprint() or "none")[:23],
        )
        if self.stats is not None:
            self.stats.count("secure_sessions")
        if self._handshake_done_cb is not None:
            self._handshake_done_cb()

    # ------------------------------------------------------------------

    def protect_rtp(self, packet: bytes) -> bytes | None:
        if self.tx_srtp is None:
            return None
        return self.tx_srtp.protect(packet)

    def protect_rtp_frame(self, packets) -> list | None:
        """Frame-granular SRTP: protect every fragment of one
        access unit in a single pass — one keystream computation, cached
        cipher/HMAC objects.  None until the handshake derives keys."""
        if self.tx_srtp is None:
            return None
        return self.tx_srtp.protect_frame(packets)

    def protect_rtcp(self, packet: bytes) -> bytes | None:
        if self.tx_srtp is None:
            return None
        return self.tx_srtp.protect_rtcp(packet)

    def sctp_transmit(self, pkt: bytes) -> list:
        """Wrap one outbound SCTP packet for the wire.
        -> [(datagram, addr)] (empty until the handshake is done)."""
        if not self.dtls.established or self.peer_addr is None:
            return []
        return [
            (d, self.peer_addr) for d in self.dtls.send_application_data(pkt)
        ]

    def retransmit(self) -> list:
        """Datagrams to resend if the peer has gone quiet mid-handshake
        (the caller owns the timer)."""
        if self.dtls.established or self.peer_addr is None:
            return []
        return [(d, self.peer_addr) for d in self.dtls.retransmit()]
