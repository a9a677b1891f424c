"""Minimal SDP offer/answer engine for the native RTP provider (the port's
copy of ai_rtc_agent_tpu/server/sdp.py).

This module implements the small, deterministic subset the agent needs:

  parse(text)          -> SdpOffer (media sections, rtpmap/fmtp, direction,
                          connection addresses; unknown attributes ignored)
  build_answer(offer)  -> RFC-conformant answer text that
                            * accepts the first H264 payload (prefers
                              packetization-mode=1), echoing the offered
                              payload type number,
                            * accepts `m=application ... webrtc-datachannel`
                              on the secure tier (SCTP datachannels, RFC
                              8841) and rejects other non-video sections
                              (port 0),
                            * mirrors a=mid and inverts direction
                              (sendonly -> recvonly etc.),
                            * embeds the host candidate inline
                              (full gather, no trickle: what OBS's WHIP
                              client needs).

Offers without a DTLS fingerprint get a plain RTP/UDP answer; fingerprinted
offers get the ICE-lite + DTLS-SRTP surface of server/secure/.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

H264_CLOCK = 90000


@dataclass
class MediaSection:
    kind: str  # video | audio | application | ...
    port: int
    proto: str  # RTP/AVP | UDP/TLS/RTP/SAVPF | ...
    payloads: list = field(default_factory=list)  # ints, offer order
    rtpmap: dict = field(default_factory=dict)  # pt -> "H264/90000"
    fmtp: dict = field(default_factory=dict)  # pt -> param string
    direction: str = "sendrecv"
    mid: str | None = None
    connection: str | None = None  # media-level c= address
    attrs: list = field(default_factory=list)  # raw a= lines (verbatim)
    fmt_tokens: list = field(default_factory=list)  # raw m= fmt column

    def sctp_port(self, default: int = 5000) -> int:
        for a in self.attrs:
            if a.startswith("sctp-port:"):
                try:
                    return int(a.split(":", 1)[1])
                except ValueError:
                    break
        return default

    def h264_payloads(self) -> list:
        """Offered H264 payload types, packetization-mode=1 first (the only
        mode the native packetizer emits: single NAL + FU-A, RFC 6184)."""
        pts = [
            pt
            for pt in self.payloads
            if self.rtpmap.get(pt, "").upper().startswith("H264/")
        ]
        return sorted(
            pts,
            key=lambda pt: "packetization-mode=1" not in self.fmtp.get(pt, ""),
        )


@dataclass
class SdpOffer:
    session_connection: str | None
    media: list
    ice_ufrag: str | None
    raw: str
    ice_pwd: str | None = None
    fingerprint: str | None = None  # value only (colon-hex)
    fingerprint_algo: str | None = None  # e.g. "sha-256"
    setup: str | None = None  # actpass | active | passive
    bundle: list | None = None  # a=group:BUNDLE mids (browser offers)

    def is_secure(self) -> bool:
        """A browser/OBS WebRTC offer: DTLS fingerprint present (the
        UDP/TLS/RTP/SAVPF tier)."""
        return self.fingerprint is not None

    def video(self) -> MediaSection | None:
        for m in self.media:
            if m.kind == "video":
                return m
        return None

    def application(self) -> MediaSection | None:
        """The datachannel m= section (RFC 8841), if offered."""
        for m in self.media:
            if m.kind == "application" and "SCTP" in m.proto.upper():
                return m
        return None


def is_sdp(text: str) -> bool:
    """Real SDP starts with a v= line (the JSON envelopes never do)."""
    return isinstance(text, str) and text.lstrip().startswith("v=")


def parse(text: str) -> SdpOffer:
    session_conn = None
    ice_ufrag = None
    ice_pwd = None
    fingerprint = None
    fingerprint_algo = None
    setup = None
    bundle = None
    media: list = []
    cur: MediaSection | None = None

    def _secure_attr(val: str) -> bool:
        # fingerprint/ice credentials appear at session OR media level
        # (browsers put them per-media); first value wins either way
        nonlocal ice_ufrag, ice_pwd, fingerprint, fingerprint_algo, setup
        if val.startswith("ice-ufrag:") and ice_ufrag is None:
            ice_ufrag = val.split(":", 1)[1]
        elif val.startswith("ice-pwd:") and ice_pwd is None:
            ice_pwd = val.split(":", 1)[1]
        elif val.startswith("fingerprint:") and fingerprint is None:
            parts = val.split(":", 1)[1].split(None, 1)
            if len(parts) == 2:
                fingerprint_algo, fingerprint = parts[0].lower(), parts[1]
        elif val.startswith("setup:") and setup is None:
            setup = val.split(":", 1)[1]
        else:
            return False
        return True

    for raw_line in text.replace("\r\n", "\n").split("\n"):
        line = raw_line.strip()
        if not line or len(line) < 2 or line[1] != "=":
            continue
        key, val = line[0], line[2:]
        if key == "m":
            parts = val.split()
            if len(parts) < 3:
                raise ValueError(f"malformed m= line: {line!r}")
            cur = MediaSection(
                kind=parts[0],
                port=int(parts[1]),
                proto=parts[2],
                payloads=[int(p) for p in parts[3:] if p.isdigit()],
                fmt_tokens=parts[3:],
            )
            media.append(cur)
        elif key == "c":
            # "IN IP4 203.0.113.9"; a bare/malformed c= is ignored rather
            # than crashing the parse (hostile bodies must map to 4xx)
            parts = val.split()
            if not parts:
                continue
            addr = parts[-1].split("/")[0]
            if cur is None:
                session_conn = addr
            else:
                cur.connection = addr
        elif key == "a":
            if cur is None:
                if val.startswith("group:BUNDLE"):
                    bundle = val.split()[1:]
                else:
                    _secure_attr(val)
                continue
            cur.attrs.append(val)
            _secure_attr(val)
            if val.startswith("rtpmap:"):
                m = re.match(r"rtpmap:(\d+)\s+(\S+)", val)
                if m:
                    cur.rtpmap[int(m.group(1))] = m.group(2)
            elif val.startswith("fmtp:"):
                m = re.match(r"fmtp:(\d+)\s+(.*)", val)
                if m:
                    cur.fmtp[int(m.group(1))] = m.group(2)
            elif val in ("sendrecv", "sendonly", "recvonly", "inactive"):
                cur.direction = val
            elif val.startswith("mid:"):
                cur.mid = val.split(":", 1)[1]
    if not media:
        raise ValueError("offer has no m= sections")
    return SdpOffer(
        session_connection=session_conn,
        media=media,
        ice_ufrag=ice_ufrag,
        raw=text,
        ice_pwd=ice_pwd,
        fingerprint=fingerprint,
        fingerprint_algo=fingerprint_algo,
        setup=setup,
        bundle=bundle,
    )


_MIRROR = {
    "sendonly": "recvonly",
    "recvonly": "sendonly",
    "sendrecv": "sendrecv",
    "inactive": "inactive",
}


def build_answer(
    offer: SdpOffer,
    host: str,
    video_port: int,
    session_id: int = 1,
    secure: dict | None = None,
) -> str:
    """Answer accepting H264 video; everything else rejected.

    Plain RTP by default; when `secure` is given (keys: ice_ufrag, ice_pwd,
    fingerprint) the answer carries the ICE-lite + DTLS-SRTP surface a
    browser requires: a=ice-lite, per-media ice credentials,
    a=fingerprint:sha-256, a=setup:passive (we are always the DTLS server, as
    aiortc answers actpass offers).

    The host candidate is embedded in the answer (a=candidate +
    a=end-of-candidates): full gather before answering, never trickle, as OBS needs."""
    lines = [
        "v=0",
        f"o=- {session_id} 2 IN IP4 {host}",
        "s=tpu-rtc-agent",
        "t=0 0",
    ]
    if secure is not None:
        lines.append("a=ice-lite")
    def _accepts_datachannel(m: MediaSection) -> bool:
        # the datachannel rides SCTP over the SAME DTLS session as media
        # (RFC 8261 + BUNDLE) — only the secure tier can carry it
        return (
            secure is not None
            and m.kind == "application"
            and "SCTP" in m.proto.upper()
        )

    if offer.bundle:
        # echo the BUNDLE group for the mids we ACCEPT (RFC 9143 s7.3:
        # rejected m-lines leave the group) — browsers with
        # bundlePolicy=max-bundle refuse an answer that drops the group
        accepted = [
            m.mid
            for m in offer.media
            if (m.kind == "video" or _accepts_datachannel(m))
            and m.mid is not None
            and m.mid in offer.bundle
        ]
        if accepted:
            lines.append("a=group:BUNDLE " + " ".join(accepted))
    for m in offer.media:
        if _accepts_datachannel(m):
            # accepted datachannel section (RFC 8841): same socket as the
            # media (our demux speaks STUN/DTLS/SRTP on one port), SCTP
            # inside the DTLS session
            fmt = " ".join(m.fmt_tokens) or "webrtc-datachannel"
            lines.append(f"m=application {video_port} {m.proto} {fmt}")
            lines.append(f"c=IN IP4 {host}")
            if m.mid is not None:
                lines.append(f"a=mid:{m.mid}")
            lines.append(f"a=ice-ufrag:{secure['ice_ufrag']}")
            lines.append(f"a=ice-pwd:{secure['ice_pwd']}")
            lines.append(f"a=fingerprint:sha-256 {secure['fingerprint']}")
            lines.append("a=setup:passive")
            # OUR listening port (sctp.DEFAULT_SCTP_PORT), not an echo of
            # the offerer's: the answer's a=sctp-port describes the
            # answerer, and port-validating stacks check the common header
            lines.append("a=sctp-port:5000")
            lines.append("a=max-message-size:65536")
            lines.append(
                f"a=candidate:1 1 udp 2130706431 {host} {video_port} typ host"
            )
            lines.append("a=end-of-candidates")
            continue
        if m.kind != "video":
            # rejected section: port 0, mirror the proto + first fmt token
            first = m.fmt_tokens[0] if m.fmt_tokens else "0"
            lines.append(f"m={m.kind} 0 {m.proto} {first}")
            if m.mid is not None:
                lines.append(f"a=mid:{m.mid}")
            continue
        h264 = m.h264_payloads()
        pt = h264[0] if h264 else (m.payloads[0] if m.payloads else 96)
        lines.append(f"m=video {video_port} {m.proto} {pt}")
        lines.append(f"c=IN IP4 {host}")
        lines.append(f"a=rtpmap:{pt} H264/{H264_CLOCK}")
        fmtp = m.fmtp.get(pt)
        if fmtp:
            lines.append(f"a=fmtp:{pt} {fmtp}")
        if m.mid is not None:
            lines.append(f"a=mid:{m.mid}")
        if secure is not None:
            lines.append(f"a=ice-ufrag:{secure['ice_ufrag']}")
            lines.append(f"a=ice-pwd:{secure['ice_pwd']}")
            lines.append(f"a=fingerprint:sha-256 {secure['fingerprint']}")
            lines.append("a=setup:passive")
        lines.append(f"a={_MIRROR.get(m.direction, 'sendrecv')}")
        lines.append("a=rtcp-mux")
        lines.append(
            f"a=candidate:1 1 udp 2130706431 {host} {video_port} typ host"
        )
        lines.append("a=end-of-candidates")
    return "\r\n".join(lines) + "\r\n"


def client_media_addr(offer: SdpOffer) -> tuple | None:
    """Where the client expects to RECEIVE video, or None.

    Only meaningful when the offer direction includes receiving
    (recvonly/sendrecv — a WHEP viewer or a bidirectional /offer peer);
    a WHIP publisher (sendonly) receives nothing."""
    m = offer.video()
    if m is None or m.direction == "sendonly" or m.direction == "inactive":
        return None
    addr = m.connection or offer.session_connection
    if not addr or addr == "0.0.0.0" or m.port <= 0:
        return None
    return (addr, m.port)
