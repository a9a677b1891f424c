"""Minimal SCTP + DCEP: WebRTC data channels over the native DTLS tier.

The port's copy of ai_rtc_agent_tpu/server/secure/sctp.py.  The agent's
runtime control plane rides WebRTC data channels, which aiortc implements
via a full SCTP association over DTLS (RFC 8261/8831) plus the DCEP channel
protocol (RFC 8832).  This module implements the subset a browser's
`createDataChannel("config")` actually exercises:

  * association setup: INIT / INIT-ACK (state cookie) / COOKIE-ECHO /
    COOKIE-ACK, verification tags, CRC32c packet checksums
  * DATA / SACK: cumulative ack + gap reports, duplicate suppression,
    ordered delivery with B/E fragment reassembly, outbound fragmentation,
    timer + SACK-driven retransmission (caller owns the clock)
  * HEARTBEAT echo, ABORT / SHUTDOWN teardown
  * DCEP: DATA_CHANNEL_OPEN -> DATA_CHANNEL_ACK, string (PPID 51) and
    binary (PPID 53) message delivery, empty-message PPIDs 56/57

Deliberately out of scope (nothing a datachannel config plane needs):
multihoming, FORWARD-TSN/partial reliability, stream reset, congestion
control beyond a static a_rwnd (config traffic is a few hundred bytes).

Sans-IO like the rest of this package: `handle_packet(bytes) -> [bytes]`
returns SCTP packets to send back; the caller wraps them in DTLS
application-data records and owns every socket and timer.
"""

from __future__ import annotations

import logging
import os
import struct
import time

logger = logging.getLogger(__name__)

# chunk types (RFC 9260 s3.2)
CT_DATA = 0
CT_INIT = 1
CT_INIT_ACK = 2
CT_SACK = 3
CT_HEARTBEAT = 4
CT_HEARTBEAT_ACK = 5
CT_ABORT = 6
CT_SHUTDOWN = 7
CT_SHUTDOWN_ACK = 8
CT_ERROR = 9
CT_COOKIE_ECHO = 10
CT_COOKIE_ACK = 11
CT_SHUTDOWN_COMPLETE = 14

PARAM_STATE_COOKIE = 7

# WebRTC PPIDs (RFC 8831 s8)
PPID_DCEP = 50
PPID_STRING = 51
PPID_BINARY = 53
PPID_STRING_EMPTY = 56
PPID_BINARY_EMPTY = 57

DCEP_OPEN = 0x03
DCEP_ACK = 0x02

DEFAULT_SCTP_PORT = 5000
A_RWND = 131072
# DTLS MTU is 1200; SCTP common header 12 + DATA chunk header 16 + slack
MAX_FRAGMENT = 1100
RTX_TIMEOUT_S = 1.0
RTX_MAX = 8


# ---------------------------------------------------------------------------
# CRC32c (Castagnoli) — zlib.crc32 is the WRONG polynomial for SCTP
# ---------------------------------------------------------------------------

def _crc32c_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _tsn_gt(a: int, b: int) -> bool:
    """Serial-number arithmetic (RFC 9260 s1.6): is TSN a after b?"""
    return ((a - b) & 0xFFFFFFFF) < 0x80000000 and a != b


class DataChannel:
    """The surface agent.py's `_wire_datachannel` drives (mirrors
    signaling.LoopbackDataChannel + the aiortc RTCDataChannel subset)."""

    def __init__(self, assoc: "SctpAssociation", sid: int, label: str):
        self._assoc = assoc
        self.sid = sid
        self.label = label
        self.readyState = "connecting"
        self.protocol = ""
        self._handlers: dict = {}

    def on(self, event: str, f=None):
        def register(fn):
            self._handlers[event] = fn
            return fn

        return register(f) if f else register

    def send(self, message) -> list:
        """Queue one channel message.  When the association has a
        `transmit` callback wired (the live rtc_native path) the packets go
        straight to the wire; either way they are returned for sans-IO
        callers."""
        if isinstance(message, str):
            data = message.encode()
            ppid = PPID_STRING if data else PPID_STRING_EMPTY
        else:
            data = bytes(message)
            ppid = PPID_BINARY if data else PPID_BINARY_EMPTY
        packets = self._assoc.send(self.sid, ppid, data or b"\x00")
        if self._assoc.transmit is not None:
            for p in packets:
                self._assoc.transmit(p)
        return packets

    def _emit(self, event: str, *args):
        h = self._handlers.get(event)
        if h is not None:
            self._assoc._dispatch(h, *args)


class SctpAssociation:
    """One SCTP association on one DTLS session (sans-IO, both roles).

    role "server": pure responder (the browser, as the connecting peer,
    always initiates INIT).  role "client": call `start()` for the INIT
    packet and `open_channel(label)` once established — this is what the
    test suite and examples/secure_webrtc_client.py drive against the
    server, standing in for the browser."""

    def __init__(
        self,
        role: str = "server",
        port: int = DEFAULT_SCTP_PORT,
        remote_port: int | None = None,
        on_channel=None,
        on_message=None,
        dispatch=None,
    ):
        assert role in ("server", "client")
        self.role = role
        self.port = port
        self.remote_port = remote_port or port
        self.established = False
        self.closed = False
        self.channels: dict = {}  # sid -> DataChannel
        self.on_channel = on_channel  # fn(DataChannel) — DCEP open accepted
        self.on_message = on_message  # fn(DataChannel, str|bytes)
        # live-wire hook: fn(sctp_packet) that DTLS-wraps + sends; None for
        # sans-IO use (tests drive returned packet lists by hand)
        self.transmit = None
        # async integration point: how channel event handlers are invoked
        # (rtc_native passes asyncio.ensure_future-based dispatch; tests use
        # the synchronous default)
        self._dispatch_fn = dispatch or (lambda fn, *a: fn(*a))

        self._my_tag = struct.unpack("!I", os.urandom(4))[0] or 1
        self._peer_tag = 0
        self._next_tsn = struct.unpack("!I", os.urandom(4))[0]
        self._cum_in = None  # last cumulatively-acked inbound TSN
        self._in_buf: dict = {}  # tsn -> (flags, sid, ssn, ppid, data)
        self._dup_tsns: list = []
        self._out_ssn: dict = {}  # sid -> next stream seq
        self._reasm: dict = {}  # sid -> [(tsn, flags, ppid, data)] pending
        self._unacked: dict = {}  # tsn -> [chunk_bytes, sent_at, retries]
        self._cookie = None
        self._reply_q: list = []  # DCEP replies queued during _on_data
        # client-role handshake flight (INIT, then COOKIE-ECHO): kept for
        # timer-driven retransmission until the association establishes —
        # the initiator owns recovery of a lost handshake packet
        self._hs_flight: list | None = None

    # ------------------------------------------------------------------
    # packet building
    # ------------------------------------------------------------------

    def _packet(self, chunks: bytes, vtag: int | None = None) -> bytes:
        hdr = struct.pack(
            "!HHII",
            self.port,
            self.remote_port,
            self._peer_tag if vtag is None else vtag,
            0,
        )
        pkt = bytearray(hdr + chunks)
        struct.pack_into("<I", pkt, 8, crc32c(bytes(pkt)))  # little-endian!
        return bytes(pkt)

    @staticmethod
    def _chunk(ctype: int, flags: int, value: bytes) -> bytes:
        length = 4 + len(value)
        pad = (-length) % 4
        return struct.pack("!BBH", ctype, flags, length) + value + b"\x00" * pad

    def _init_params(self) -> bytes:
        return struct.pack(
            "!IIHHI", self._my_tag, A_RWND, 65535, 65535, self._next_tsn
        )

    # ------------------------------------------------------------------
    # client role
    # ------------------------------------------------------------------

    def start(self) -> list:
        assert self.role == "client"
        flight = [
            self._packet(self._chunk(CT_INIT, 0, self._init_params()), vtag=0)
        ]
        self._hs_flight = [flight, time.monotonic(), 0]
        return flight

    def open_channel(self, label: str, sid: int | None = None) -> tuple:
        """-> (DataChannel, [packets]) — DCEP OPEN on a fresh stream.
        WebRTC sid parity: the DTLS client uses even stream ids."""
        if sid is None:
            sid = 0 if self.role == "client" else 1
            while sid in self.channels:
                sid += 2
        ch = DataChannel(self, sid, label)
        self.channels[sid] = ch
        lbl = label.encode()
        dcep = struct.pack("!BBHIHH", DCEP_OPEN, 0, 0, 0, len(lbl), 0) + lbl
        return ch, self.send(sid, PPID_DCEP, dcep)

    # ------------------------------------------------------------------
    # outbound data
    # ------------------------------------------------------------------

    def send(self, sid: int, ppid: int, data: bytes) -> list:
        """Fragment + queue one message; returns packets to transmit."""
        if self.closed:
            return []
        ssn = self._out_ssn.get(sid, 0)
        self._out_ssn[sid] = (ssn + 1) & 0xFFFF
        packets = []
        frags = [data[i : i + MAX_FRAGMENT] for i in range(0, len(data), MAX_FRAGMENT)] or [b""]
        for i, frag in enumerate(frags):
            flags = 0
            if i == 0:
                flags |= 2  # B
            if i == len(frags) - 1:
                flags |= 1  # E
            tsn = self._next_tsn
            self._next_tsn = (self._next_tsn + 1) & 0xFFFFFFFF
            value = struct.pack("!IHHI", tsn, sid, ssn, ppid) + frag
            chunk = self._chunk(CT_DATA, flags, value)
            self._unacked[tsn] = [chunk, time.monotonic(), 0]
            packets.append(self._packet(chunk))
        return packets

    def retransmit_due(self, now: float | None = None) -> list:
        """Caller-driven timer: packets whose SACK never came.  After
        RTX_MAX tries the association aborts (the channel owner sees
        closed=True and tears down)."""
        if self.closed:
            return []
        now = time.monotonic() if now is None else now
        if not self.established:
            # client role: the handshake flight is ours to recover
            if self._hs_flight is None:
                return []
            flight, sent_at, retries = self._hs_flight
            if now - sent_at < RTX_TIMEOUT_S * (1 + retries):
                return []
            if retries >= RTX_MAX:
                self.closed = True
                self._close_channels()
                return []
            self._hs_flight[1] = now
            self._hs_flight[2] = retries + 1
            return list(flight)
        out = []
        for tsn, entry in list(self._unacked.items()):
            chunk, sent_at, retries = entry
            if now - sent_at < RTX_TIMEOUT_S * (1 + retries):
                continue
            if retries >= RTX_MAX:
                self.closed = True
                self._close_channels()
                logger.warning("sctp: retransmit budget exhausted — aborting")
                return [self._packet(self._chunk(CT_ABORT, 0, b""))]
            entry[1] = now
            entry[2] = retries + 1
            out.append(self._packet(chunk))
        return out

    # ------------------------------------------------------------------
    # inbound
    # ------------------------------------------------------------------

    def handle_packet(self, pkt: bytes) -> list:
        if self.closed or len(pkt) < 12:
            return []
        vtag = struct.unpack_from("!I", pkt, 4)[0]
        zeroed = bytearray(pkt)
        struct.pack_into("!I", zeroed, 8, 0)
        # the wire checksum is the CRC32c value serialized little-endian
        # (RFC 9260 appendix B reflection quirk — usrsctp does the same)
        if crc32c(bytes(zeroed)) != struct.unpack_from("<I", pkt, 8)[0]:
            logger.debug("sctp: bad CRC32c — dropped")
            return []
        out: list = []
        saw_data = False
        off = 12
        while off + 4 <= len(pkt):
            ctype, flags, length = struct.unpack_from("!BBH", pkt, off)
            if length < 4 or off + length > len(pkt):
                break
            value = pkt[off + 4 : off + length]
            off += length + ((-length) % 4)
            # vtag check: INIT rides vtag 0; everything else must carry ours
            if ctype != CT_INIT and vtag != self._my_tag:
                logger.debug("sctp: bad vtag %#x — dropped", vtag)
                return []
            if ctype == CT_INIT:
                out.extend(self._on_init(value))
            elif ctype == CT_INIT_ACK:
                out.extend(self._on_init_ack(value))
            elif ctype == CT_COOKIE_ECHO:
                out.extend(self._on_cookie_echo(value))
            elif ctype == CT_COOKIE_ACK:
                self.established = True
                self._hs_flight = None
            elif ctype == CT_DATA:
                saw_data = True
                self._on_data(flags, value)
            elif ctype == CT_SACK:
                self._on_sack(value)
            elif ctype == CT_HEARTBEAT:
                out.append(
                    self._packet(self._chunk(CT_HEARTBEAT_ACK, 0, value))
                )
            elif ctype == CT_ABORT:
                self.closed = True
                self._close_channels()
                return out
            elif ctype == CT_SHUTDOWN:
                self.closed = True
                self._close_channels()
                out.append(self._packet(self._chunk(CT_SHUTDOWN_ACK, 0, b"")))
                return out
            elif ctype == CT_SHUTDOWN_COMPLETE:
                self.closed = True
                self._close_channels()
                return out
        if saw_data:
            out.append(self._sack_packet())
            # a SACK often frees the peer to send more; also flush DCEP
            # replies queued by _on_data (they were appended there)
            out.extend(self._pending_replies())
        return out

    def _pending_replies(self) -> list:
        q, self._reply_q = self._reply_q, []
        return q

    def _close_channels(self) -> None:
        """Teardown is observable, not silent: every channel flips to
        closed and fires its close handler."""
        for ch in self.channels.values():
            if ch.readyState != "closed":
                ch.readyState = "closed"
                ch._emit("close")

    def close(self) -> list:
        """Local teardown -> packets to transmit (a one-packet ABORT: the
        peer's stack tears down immediately instead of waiting out its
        retransmission budget)."""
        if self.closed:
            return []
        self.closed = True
        self._close_channels()
        if not self._peer_tag:
            return []
        return [self._packet(self._chunk(CT_ABORT, 0, b""))]

    # ---------------- handshake ----------------

    def _on_init(self, value: bytes) -> list:
        if len(value) < 16:
            return []
        if self.established:
            # Retransmitted/duplicate INIT on a live association (RFC 9260
            # s5.2.2): answer with the EXISTING tag and cookie, mutating
            # nothing — resetting _peer_tag/_cum_in here would silently
            # desync TSN tracking of the established association.
            if self._cookie is None:
                return []
            params = self._init_params() + self._chunk_param(
                PARAM_STATE_COOKIE, self._cookie
            )
            return [self._packet(self._chunk(CT_INIT_ACK, 0, params))]
        peer_tag, _rwnd, _os, _mis, peer_tsn = struct.unpack_from("!IIHHI", value, 0)
        self._peer_tag = peer_tag
        self._cum_in = (peer_tsn - 1) & 0xFFFFFFFF
        self._cookie = os.urandom(32)
        params = self._init_params() + self._chunk_param(
            PARAM_STATE_COOKIE, self._cookie
        )
        return [self._packet(self._chunk(CT_INIT_ACK, 0, params))]

    @staticmethod
    def _chunk_param(ptype: int, value: bytes) -> bytes:
        length = 4 + len(value)
        pad = (-length) % 4
        return struct.pack("!HH", ptype, length) + value + b"\x00" * pad

    def _on_init_ack(self, value: bytes) -> list:
        if self.role != "client" or len(value) < 16:
            return []
        peer_tag, _rwnd, _os, _mis, peer_tsn = struct.unpack_from("!IIHHI", value, 0)
        self._peer_tag = peer_tag
        self._cum_in = (peer_tsn - 1) & 0xFFFFFFFF
        # find the state cookie param
        off = 16
        cookie = None
        while off + 4 <= len(value):
            ptype, plen = struct.unpack_from("!HH", value, off)
            if plen < 4 or off + plen > len(value):
                break
            if ptype == PARAM_STATE_COOKIE:
                cookie = value[off + 4 : off + plen]
            off += plen + ((-plen) % 4)
        if cookie is None:
            return []
        flight = [self._packet(self._chunk(CT_COOKIE_ECHO, 0, cookie))]
        self._hs_flight = [flight, time.monotonic(), 0]
        return flight

    def _on_cookie_echo(self, value: bytes) -> list:
        if self._cookie is None or value != self._cookie:
            logger.debug("sctp: cookie mismatch — dropped")
            return []
        self.established = True
        return [self._packet(self._chunk(CT_COOKIE_ACK, 0, b""))]

    # ---------------- data path ----------------

    def _on_data(self, flags: int, value: bytes) -> None:
        if len(value) < 12:
            return
        tsn, sid, ssn, ppid = struct.unpack_from("!IHHI", value, 0)
        data = value[12:]
        if self._cum_in is None:
            return  # DATA before the handshake set the TSN base — drop
        if not _tsn_gt(tsn, self._cum_in):
            self._dup_tsns.append(tsn)
            return
        if tsn in self._in_buf:
            self._dup_tsns.append(tsn)
            return
        if len(self._in_buf) > 1024:
            return  # bound buffering against a TSN-scatter flood
        self._in_buf[tsn] = (flags, sid, ssn, ppid, data)
        # advance the cumulative ack over contiguous TSNs, delivering
        # completed messages as E fragments close them
        while True:
            nxt = (self._cum_in + 1) & 0xFFFFFFFF
            if nxt not in self._in_buf:
                break
            f, s, q, p, d = self._in_buf.pop(nxt)
            self._cum_in = nxt
            pend = self._reasm.setdefault(s, [])
            if f & 2:  # B — fresh message start
                pend.clear()
            pend.append(d)
            if f & 1:  # E — message complete
                msg = b"".join(pend)
                pend.clear()
                self._deliver(s, p, msg)

    def _sack_packet(self) -> bytes:
        gaps = b""
        n_gaps = 0
        if self._in_buf and self._cum_in is not None:
            # compress the out-of-order buffer into gap-ack blocks
            tsns = sorted(
                self._in_buf, key=lambda t: (t - self._cum_in) & 0xFFFFFFFF
            )[:16]
            start = prev = None
            blocks = []
            for t in tsns:
                rel = (t - self._cum_in) & 0xFFFFFFFF
                if rel > 0xFFFF:
                    break
                if start is None:
                    start = prev = rel
                elif rel == prev + 1:
                    prev = rel
                else:
                    blocks.append((start, prev))
                    start = prev = rel
            if start is not None:
                blocks.append((start, prev))
            n_gaps = len(blocks)
            gaps = b"".join(struct.pack("!HH", s, e) for s, e in blocks)
        dups = self._dup_tsns[:16]
        self._dup_tsns = []
        value = (
            struct.pack(
                "!IIHH", self._cum_in or 0, A_RWND, n_gaps, len(dups)
            )
            + gaps
            + b"".join(struct.pack("!I", d) for d in dups)
        )
        return self._packet(self._chunk(CT_SACK, 0, value))

    def _on_sack(self, value: bytes) -> None:
        if len(value) < 12:
            return
        (cum,) = struct.unpack_from("!I", value, 0)
        for tsn in list(self._unacked):
            if not _tsn_gt(tsn, cum):
                del self._unacked[tsn]

    # ---------------- DCEP + delivery ----------------

    def _deliver(self, sid: int, ppid: int, data: bytes) -> None:
        if ppid == PPID_DCEP:
            self._on_dcep(sid, data)
            return
        ch = self.channels.get(sid)
        if ch is None:
            return
        if ppid in (PPID_STRING, PPID_STRING_EMPTY):
            msg = "" if ppid == PPID_STRING_EMPTY else data.decode("utf-8", "replace")
        elif ppid in (PPID_BINARY, PPID_BINARY_EMPTY):
            msg = b"" if ppid == PPID_BINARY_EMPTY else data
        else:
            return
        ch._emit("message", msg)
        if self.on_message is not None:
            self.on_message(ch, msg)

    def _on_dcep(self, sid: int, data: bytes) -> None:
        if not data:
            return
        if data[0] == DCEP_OPEN and len(data) >= 12:
            _t, _ct, _prio, _rel, llen, plen = struct.unpack_from("!BBHIHH", data, 0)
            label = data[12 : 12 + llen].decode("utf-8", "replace")
            ch = self.channels.get(sid)
            if ch is None:
                ch = DataChannel(self, sid, label)
                self.channels[sid] = ch
            ch.label = label
            ch.protocol = data[12 + llen : 12 + llen + plen].decode(
                "utf-8", "replace"
            )
            ch.readyState = "open"
            # DCEP ACK rides the SAME stream (RFC 8832 s5.2)
            self._reply_q.extend(self.send(sid, PPID_DCEP, bytes([DCEP_ACK])))
            if self.on_channel is not None:
                self.on_channel(ch)
            ch._emit("open")
        elif data[0] == DCEP_ACK:
            ch = self.channels.get(sid)
            if ch is not None:
                ch.readyState = "open"
                ch._emit("open")

    def _dispatch(self, fn, *args):
        try:
            self._dispatch_fn(fn, *args)
        except Exception:
            logger.exception("datachannel handler failed")
