"""Native WebRTC provider — the agent's own full wire stack (the port's copy
of ai_rtc_agent_tpu/server/rtc_native.py).

The default provider when aiortc is absent, and a complete browser-capable
tier:
RTP packetization (native/rtp.cpp, RFC 6184), H.264 codecs (native/h264.cpp
→ libavcodec), the SPSC frame ring, real SDP offer/answer (server/sdp.py),
ICE-lite + DTLS 1.2 + SRTP/SRTCP on one demuxed socket (server/secure/),
SCTP data channels (server/secure/sctp.py, RFC 8831/8832), and full RTCP —
periodic SR/RR with reception statistics, NACK retransmission, PLI
(media/rtcp.py).  UDP sockets open through the event loop, so the
--udp-ports pinning patch applies to media as it does for aiortc.

Signaling stays the agent's HTTP surface and accepts BOTH body shapes:

  * REAL SDP (browser/OBS-shaped WHIP/WHEP offers): parsed by server/sdp.py;
    the answer echoes the offered H264 payload type, mirrors a=mid, inverts
    the direction and embeds the bound UDP port as an inline host candidate
    (full gather, no trickle, as OBS needs).  Held to the JAX agent's
    answers by tests/test_torch_native_rtp.py.
  * JSON envelope (the framework's own test/LAN shape):
      offer:  {"native_rtp": true, "video": true,
               "client_addr": ["127.0.0.1", 5004],  # where WE send RTP out
               "width": 512, "height": 512}
      answer: {"native_rtp": true, "server_port": N}  # where the client sends

Media flow per connection:
  client RTP -> UDP socket -> H264RingSource (depacketize+decode+ring)
    -> VideoStreamTrack(pipeline) -> sender task -> H264Sink
    (encode+packetize) -> UDP -> client.

Offers WITHOUT a DTLS fingerprint (the JSON envelope above, LAN tools) ride
plain RTP; fingerprinted offers (every browser/OBS) get the encrypted tier
(server/secure/).

A frame's trace (obs/trace.py) gets its ``protect`` and ``send`` spans in
the sender pump (``per_packet_tx`` marks the per-packet tier's combined
span) and its terminal there: ``sent``, or ``dropped`` while the secure
tier has no keys yet.

A WHEP viewer joined to its publisher's broadcast group (``join_broadcast``,
server/broadcast.py) builds no sink and no pump of its own: a plain viewer
takes its media from the group socket and sends its PLIs back there, a
secure viewer keeps its own SRTP, fed the group's rewritten packets.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
import uuid

from ..media import rtcp as rtcp_mod
from ..media import sockio
from ..media.plane import H264RingSource, H264Sink
from ..obs.trace import get_trace
from ..utils import env as env_util
from ..utils.dispatch import spawn
from ..utils.profiling import FrameStats
from . import sdp

logger = logging.getLogger(__name__)


class SessionDescription:
    def __init__(self, sdp: str, type: str):
        self.sdp = sdp
        self.type = type


# the outbound stream identity: one constant feeds the H264Sink/packetizer
# AND the RTCP sender state, so SRs always describe the actual RTP stream
OUT_SSRC = 0x5EED


class _RtcpState:
    """Outbound-stream RTCP bookkeeping: send
    counters feeding periodic Sender Reports, the retransmission cache
    answering NACKs, and receiver-report gauges for /metrics — the
    machinery aiortc carries internally.
    """

    # per-second retransmission budget: NACKs are unauthenticated on the
    # plain tier, and even the secure tier shouldn't let one feedback
    # datagram extract the whole 512-packet cache (amplification)
    RTX_PER_SECOND = 64
    # feedback-driven IDR floor: forged PLIs / cache-miss NACKs must not be
    # able to degrade the encoder to all-keyframes; legit
    # receivers recover fine at 2 IDR/s
    IDR_MIN_INTERVAL_S = 0.5

    def __init__(self, stats: FrameStats | None = None, ssrc: int = OUT_SSRC):
        self.ssrc = ssrc
        self.cache = rtcp_mod.RetransmissionCache()
        self.recv = rtcp_mod.ReceiverStats()
        # network-adaptation ladder (resilience/netadapt.py): fed the
        # peer's report blocks about OUR stream + local NACK/PLI feedback
        self.netadapt = None
        self.packet_count = 0
        self.octet_count = 0
        self.last_rtp_ts = 0
        self.last_sent_wall = None  # wall clock paired with last_rtp_ts
        self.stats = stats
        self._rtx_window_start = 0.0
        self._rtx_in_window = 0
        self._last_idr = 0.0

    def sent(self, plain_pkt: bytes, wire: bytes) -> None:
        self.packet_count += 1
        self.octet_count += max(0, len(plain_pkt) - 12)
        if len(plain_pkt) >= 8:
            self.last_rtp_ts = int.from_bytes(plain_pkt[4:8], "big")
            self.last_sent_wall = time.time()
        if not isinstance(wire, (bytes, bytearray)):
            # the batched packetizer hands out pooled memoryviews; the
            # NACK cache outlives the pool, so it must own stable bytes
            wire = bytes(wire)
        self.cache.add(plain_pkt, wire)

    def make_report(self) -> bytes | None:
        """The periodic report for this session: an SR (with a reception
        block about the publisher's stream when one is inbound) while we
        are sending, a bare RR while we only receive, None before any
        traffic.  RFC 3550 s6.4 — the both-directions reporting browsers
        expect from a full endpoint."""
        blk = self.recv.report_block()
        if self.packet_count > 0:
            # RFC 3550 s6.4.1: the NTP and RTP timestamps must denote the
            # SAME instant — use the wall clock captured when last_rtp_ts
            # was sent, not now() (a stalled pipeline would skew the map)
            return rtcp_mod.make_sr(
                self.ssrc,
                self.last_rtp_ts,
                self.packet_count,
                self.octet_count,
                now=self.last_sent_wall,
                report_blocks=[blk] if blk else None,
            )
        if blk is not None:
            return rtcp_mod.make_rr(
                self.ssrc,
                blk["ssrc"],
                fraction_lost=blk["fraction_lost"],
                cumulative_lost=blk["cumulative_lost"],
                highest_seq=blk["highest_seq"],
                jitter=blk["jitter"],
            )
        return None

    def _rtx_allowed(self) -> bool:
        now = time.monotonic()
        if now - self._rtx_window_start >= 1.0:
            self._rtx_window_start = now
            self._rtx_in_window = 0
        if self._rtx_in_window >= self.RTX_PER_SECOND:
            return False
        self._rtx_in_window += 1
        return True

    def on_rtcp(self, payload: bytes, resend, allow_wildcard_pli: bool = False) -> bool:
        """Handle one inbound compound RTCP datagram.  `resend` transmits a
        cached WIRE packet.  Returns True when the sender should IDR
        (PLI, or a NACK for packets that aged out of the cache).

        Feedback about a DIFFERENT media SSRC is ignored wholesale — a
        misdirected/forged NACK must neither drain the cache nor force
        spurious keyframes, and another stream's RR must not pollute the
        rr_* gauges."""
        force_idr = False
        for item in rtcp_mod.parse_compound(payload):
            if item["type"] == "pli":
                # Secure tier: exact SSRC match only — a media_ssrc=0
                # wildcard would keep the forged-PLI door the filter exists
                # to close open.  Plain tier
                # (allow_wildcard_pli): media_ssrc==0 is honored — it is
                # what older clients (and this repo's own media/rtp.py
                # make_pli default) emit, and on an unauthenticated LAN
                # socket the exact-match defense buys nothing while
                # silently breaking legacy keyframe recovery.
                m = item.get("media_ssrc")
                if m == self.ssrc or (allow_wildcard_pli and not m):
                    force_idr = True
                    if self.netadapt is not None:
                        self.netadapt.on_tx_feedback(plis=1)
            elif item["type"] == "nack":
                if item.get("media_ssrc") != self.ssrc:
                    continue
                if self.stats is not None:
                    self.stats.count("rtcp_nacks")
                if self.netadapt is not None:
                    self.netadapt.on_tx_feedback(nacks=len(item["seqs"]))
                for seq in item["seqs"]:
                    wire = self.cache.get(seq)
                    if wire is not None and self._rtx_allowed():
                        resend(wire)
                        if self.stats is not None:
                            self.stats.count("rtcp_nack_retransmits")
                    elif wire is None:
                        # aged out of the cache: a keyframe is the only
                        # recovery that still helps
                        force_idr = True
            elif item["type"] in ("rr", "sr"):
                # reception report blocks ride RRs AND (from bidirectional
                # peers, RFC 3550 s6.4.1) SRs; select the block about OUR
                # stream — a multi-block compound from a multi-stream peer
                # must not gauge a stranger's loss, and an absent block
                # must not gauge at all (regression: tests/test_rtcp.py)
                blk = next(
                    (
                        b
                        for b in item.get("blocks", ())
                        if b["ssrc"] == self.ssrc
                    ),
                    None,
                )
                if blk is None:
                    continue
                if self.stats is not None:
                    self.stats.count("rtcp_rrs")
                    self.stats.gauge("rr_fraction_lost", blk["fraction_lost"])
                    self.stats.gauge("rr_jitter", blk["jitter"])
                if self.netadapt is not None:
                    self.netadapt.on_receiver_report(blk)
        if force_idr:
            now = time.monotonic()
            if now - self._last_idr < self.IDR_MIN_INTERVAL_S:
                return False
            self._last_idr = now
        return force_idr


_looks_like_rtcp = rtcp_mod.is_rtcp  # one RFC 5761 demux rule, one place


class _RtpReceiverProtocol(asyncio.DatagramProtocol):
    """Hands packets to a queue; H.264 decode runs on a worker thread, never
    on the event loop (5-30 ms/frame of software codec would starve every
    other coroutine — same rule as tracks.py pushing inference to threads).

    Keyframe recovery: a decode error fires an
    RTCP-PLI back at the sender's source address, so their encoder emits an
    IDR within a frame instead of the stream freezing for up to a gop.
    Inbound PLI on this socket (bidirectional peers) forwards to ``on_pli``
    so OUR encoder keyframes."""

    PLI_MIN_INTERVAL = 0.25  # s — bound the PLI storm under loss bursts

    def __init__(self, source: H264RingSource | None, rtcp_state: _RtcpState,
                 on_pli=None, session=None, plane_stats: FrameStats | None = None):
        """`session`: a secure.SecureMediaSession — when given, this socket
        speaks the full RFC 7983 mux (STUN + DTLS + SRTP/SRTCP) instead of
        plain RTP; `source` may be None for a send-only (WHEP) secure peer
        whose socket still has to answer ICE checks and the handshake.
        `plane_stats`: per-session host-plane stage gauges (/metrics)."""
        self.source = source
        self.session = session
        self._rtcp_state = rtcp_state
        self._last_rx_ssrc = 0  # publisher's SSRC, learned from its RTP
        self.transport = None
        self._on_pli = on_pli
        self._last_addr = None
        self._last_pli_sent = 0.0
        self._plane_stats = plane_stats
        # coalesced I/O: after asyncio hands over the tick's
        # first datagram, drain the rest of the burst through pooled
        # buffers in the same callback; outbound frames flush as one
        # sendmmsg batch.  HOST_PLANE_RX_BATCH=0 restores per-callback RX.
        self._drain = (
            sockio.DatagramDrain()
            if env_util.get_bool("HOST_PLANE_RX_BATCH", True)
            else None
        )
        self._flush = sockio.CoalescedFlush()
        # fault injection hook (resilience/faults.py): None unless a plan
        # targeting inbound datagrams is active — the disabled hot path
        # costs exactly one is-None test
        from ..resilience import faults as _faults

        self._rx_faults = _faults.scope("rx")
        self._q: asyncio.Queue = asyncio.Queue(maxsize=256)
        self._task = asyncio.ensure_future(self._decode_loop())
        self._loop = asyncio.get_event_loop()
        if source is not None:
            # fired on the decode worker thread -> hop back to the loop
            source.on("decode_error", self._request_keyframe_threadsafe)

    def connection_made(self, transport):
        self.transport = transport
        self._flush.bind(transport)

    def _request_keyframe_threadsafe(self):
        try:
            self._loop.call_soon_threadsafe(self._send_pli)
        except RuntimeError:
            pass  # loop already closed

    def _send_pli(self):
        import time as _t

        now = _t.monotonic()
        if (
            self.transport is None
            or self._last_addr is None
            or now - self._last_pli_sent < self.PLI_MIN_INTERVAL
        ):
            return
        self._last_pli_sent = now
        try:
            from ..media import rtp as R

            # name the stream we are asking a keyframe FOR — peers with an
            # exact-match feedback filter (like ours) ignore wildcard PLIs
            pkt = R.make_pli(media_ssrc=self._last_rx_ssrc)
            if self.session is not None:
                pkt = self.session.protect_rtcp(pkt)
                if pkt is None:
                    return  # keys not derived yet — nothing to recover
            self.transport.sendto(pkt, self._last_addr)
        except Exception:
            logger.exception("PLI send failed")

    def send_media(self, packet: bytes) -> bool:
        """Outbound RTP through this socket (secure tier: SRTP-protected to
        the ICE-latched peer).  Returns False while not yet sendable."""
        if self.transport is None:
            return False
        if self.session is None:
            return False  # plain tier sends on its own socket
        wire = self.session.protect_rtp(packet)
        addr = self.session.peer_addr
        if wire is None or addr is None:
            return False
        # cache the CIPHERTEXT: a NACK answer resends it verbatim
        self._rtcp_state.sent(packet, wire)
        self.transport.sendto(wire, addr)
        return True

    def send_media_batch(self, packets, trace=None) -> bool:
        """Outbound RTP, one whole frame at a time: frame-granular SRTP
        (protect_frame — one keystream pass for every fragment) and a
        single coalesced socket flush.  Returns False while the handshake
        has not yet produced keys / an ICE-latched peer.  ``trace``: the
        frame's trace, which gets the protect and send spans (on the
        monotonic clock, apart from the perf_counter µs gauges)."""
        if self.transport is None or self.session is None or not packets:
            return False
        stats = self._plane_stats
        t0 = time.perf_counter()
        tm0 = time.monotonic() if trace is not None else 0.0
        wires = self.session.protect_rtp_frame(packets)
        addr = self.session.peer_addr
        if wires is None or addr is None:
            return False
        t1 = time.perf_counter()
        tm1 = time.monotonic() if trace is not None else 0.0
        for plain, wire in zip(packets, wires):
            self._rtcp_state.sent(plain, wire)
        self._flush.flush(wires, addr)
        if stats is not None:
            t2 = time.perf_counter()
            stats.record_stage("protect", t1 - t0)
            stats.record_stage("send", t2 - t1)
            stats.count("tx_packets", len(wires))
        if trace is not None:
            trace.add_span("protect", tm0, tm1)
            trace.add_span("send", tm1, time.monotonic())
        return True

    def datagram_received(self, data, addr):
        if self._drain is None or self._flush.sock is None:
            self._one(data, addr)
            return
        # batched drain: asyncio delivers the tick's first datagram, the
        # rest of the burst is slurped here through pooled buffers — one
        # event-loop callback per burst instead of one per packet
        t0 = time.perf_counter() if self._plane_stats is not None else 0.0
        self._one(data, addr)
        n = 1 + self._drain.drain(self._flush.sock, self._drained)
        if self._plane_stats is not None:
            self._plane_stats.record_stage("recv", time.perf_counter() - t0)
            self._plane_stats.count("rx_datagrams", n)

    def _drained(self, view, addr):
        # pooled view: stabilize whenever something downstream may hold it
        # past this call — fault-injected delayed redelivery, and the
        # DTLS/STUN handshake paths (reassembly buffers).  RTP/RTCP either
        # consume synchronously or copy on their own (reorder-buffer hold,
        # SRTP unprotect).
        if self._rx_faults is not None or (len(view) > 0 and view[0] < 128):
            self._one(bytes(view), addr)
        else:
            self._one(view, addr)

    def _one(self, data, addr):
        if self._rx_faults is not None:
            # injected loss/dup/reorder/delay/truncation (chaos testing);
            # delayed copies re-enter via _ingest so they are not re-faulted
            # tpurtc: allow[pooled-view] -- _drained stabilizes to bytes before _one whenever _rx_faults is active; pooled views only reach here when the injector is None
            for d, delay in self._rx_faults.apply(data):
                if delay > 0:
                    self._loop.call_later(delay, self._ingest, d, addr)
                else:
                    self._ingest(d, addr)
            return
        self._ingest(data, addr)

    def _ingest(self, data, addr):
        if self.session is not None:
            outs, kind, payload = self.session.handle(data, addr)
            for d, a in outs:
                self.transport.sendto(d, a)
            if kind == "rtcp":
                dst = self.session.peer_addr or addr
                force = self._rtcp_state.on_rtcp(
                    payload, lambda w: self.transport.sendto(w, dst)
                )
                if force and self._on_pli is not None:
                    self._on_pli()
                return
            if kind != "rtp" or self.source is None:
                return
            data = payload
            self._last_addr = self.session.peer_addr or addr
        else:
            if _looks_like_rtcp(data):
                self._last_addr = addr
                force = self._rtcp_state.on_rtcp(
                    data,
                    lambda w: self.transport.sendto(w, addr),
                    allow_wildcard_pli=True,  # plain tier: legacy peers
                )
                if force and self._on_pli is not None:
                    self._on_pli()
                return
        # RTP version gate: a stray non-RTP datagram (probe,
        # junk aimed at the open port) must not lock ReceiverStats onto a
        # bogus SSRC, point PLIs at garbage, redirect the PLI return
        # address, or reach the depacketizer
        if len(data) < 12 or (data[0] >> 6) != 2:
            return
        if self.session is None:
            # plain tier: trust the source address only once the datagram
            # proved RTP-shaped (the secure tier latches via ICE instead)
            self._last_addr = addr
        self._rtcp_state.recv.received(data)
        # PLIs name the stream the stats are LOCKED on (which re-locks if
        # the locked stream goes silent — rtcp.ReceiverStats), not blindly
        # the last datagram's SSRC
        self._last_rx_ssrc = self._rtcp_state.recv.ssrc or int.from_bytes(
            data[8:12], "big"
        )
        try:
            # reorder + depacketize inline (microseconds); queue only
            # COMPLETED access units so the worker hop is per frame
            aus = self.source.depacketize(data)
        except Exception:
            logger.exception("RTP depacketize error")
            return
        for got in aus:
            if self._q.full():
                # freshest-frame-wins (resilience/overload.py policy): shed
                # the OLDEST queued AU — the decode backlog IS the latency,
                # and the stalest frame is the least valuable one in it
                try:
                    self._q.get_nowait()
                except asyncio.QueueEmpty:
                    pass
                if self._plane_stats is not None:
                    self._plane_stats.count("overload_shed_rx_queue")
            try:
                self._q.put_nowait(got)
            except asyncio.QueueFull:
                pass  # raced a concurrent producer: drop rather than block

    async def _decode_loop(self):
        while True:
            au, ts = await self._q.get()
            try:
                await asyncio.to_thread(self.source.feed_au, au, ts)
            except Exception:
                logger.exception("H.264 decode error")

    def close(self):
        self._task.cancel()
        self._flush.close()  # our dup'd fd, not the transport's


class _PliListenerProtocol(asyncio.DatagramProtocol):
    """Send-side return channel: RTCP from the viewer — PLI forces an IDR,
    NACKs answer from the retransmission cache, RRs land in /metrics
    (the machinery aiortc handles internally)."""

    def __init__(self, on_pli, rtcp_state: _RtcpState):
        self._on_pli = on_pli
        self._rtcp_state = rtcp_state
        self.transport = None

    def connection_made(self, transport):
        self.transport = transport

    def datagram_received(self, data, addr):
        if self.transport is None:
            return
        # plain-tier return channel: wildcard (media_ssrc=0) PLIs are
        # honored — legacy/LAN clients emit them
        force = self._rtcp_state.on_rtcp(
            data, lambda w: self.transport.sendto(w), allow_wildcard_pli=True
        )
        if force:
            self._on_pli()


class NativeRtpPeerConnection:
    """RTCPeerConnection-surface over raw RTP/UDP (the subset the agent
    drives: events, transceivers, add/track, SDP, gather, close)."""

    def __init__(self, provider: "NativeRtpProvider", configuration=None):
        self._provider = provider
        self.configuration = configuration
        self.connectionState = "new"
        self.iceConnectionState = "new"
        self.localDescription = None
        self.remoteDescription = None
        self.in_track: H264RingSource | None = None
        self.out_tracks: list = []
        self._handlers: dict = {}
        self._transceivers: list = []
        self._senders: list = []
        self._recv_transport = None
        self._recv_protocol = None
        self._send_transport = None
        self._sender_tasks: list = []
        self._sink: H264Sink | None = None
        self._client_addr = None
        self._payload: dict = {}
        self._sdp_offer = None  # parsed real-SDP offer (server/sdp.py)
        self._h264_pt: int | None = None  # offered H264 payload type
        self._secure_session = None  # secure.SecureMediaSession (DTLS tier)
        self._sctp = None  # secure.sctp.SctpAssociation (datachannels)
        self._sctp_timer_task = None
        self._rtcp_state = _RtcpState(stats=provider.stats)
        self._sr_task = None
        self.server_port: int | None = None
        self.pc_id = str(uuid.uuid4())
        # host-plane instrumentation + batching: per-session
        # packetize/protect/send/recv µs histograms, surfaced at /metrics
        # under host_plane_sessions; HOST_PLANE_BATCH=0 restores the
        # per-packet TX path end to end
        self.plane_stats = FrameStats()
        self._batch_tx = env_util.get_bool("HOST_PLANE_BATCH", True)
        self._plain_flush = sockio.CoalescedFlush()
        # network adaptation (resilience/netadapt.py): attached by the
        # agent's session wiring; None = no quality ladder on this session
        self.netadapt = None
        self.kf_governor = None
        # the broadcast fan-out (server/broadcast.py): set by join_broadcast()
        # before setRemoteDescription; the session is then a viewer of a
        # shared TX plane instead of owning a sink and pump, and its PLIs
        # go to the group's governed re-sync
        self._broadcast_group = None
        provider.register_plane_session(self.pc_id, self.plane_stats, pc=self)

    # -- events --------------------------------------------------------------

    def on(self, event: str, f=None):
        def register(fn):
            self._handlers[event] = fn
            return fn

        return register(f) if f else register

    async def _emit(self, event: str, *args):
        h = self._handlers.get(event)
        if h:
            r = h(*args)
            if asyncio.iscoroutine(r):
                await r

    # -- transceiver surface (parity with provider contract) -----------------

    def addTransceiver(self, kind: str, direction: str = "sendrecv"):
        tr = type("Transceiver", (), {"kind": kind, "sender": None, "_codecs": None})()
        tr.setCodecPreferences = lambda codecs: setattr(tr, "_codecs", codecs)
        self._transceivers.append(tr)
        return tr

    def getTransceivers(self):
        return list(self._transceivers)

    def addTrack(self, track):
        sender = type("Sender", (), {"track": track})()
        self._senders.append(sender)
        self.out_tracks.append(track)
        if self._transceivers:
            self._transceivers[0].sender = sender
        return sender

    # -- SDP -----------------------------------------------------------------

    async def setRemoteDescription(self, desc: SessionDescription):
        self.remoteDescription = desc
        if sdp.is_sdp(desc.sdp):
            # REAL SDP (browser/OBS-shaped WHIP/WHEP bodies): parse media
            # sections, remember the offered H264 payload type for our
            # outgoing packets, learn where the client receives (if it does)
            offer = sdp.parse(desc.sdp)
            self._sdp_offer = offer
            video = offer.video()
            if video is None and offer.application() is None:
                raise ValueError("offer has no video or datachannel m= section")
            if video is not None:
                h264 = video.h264_payloads()
                if h264:
                    self._h264_pt = h264[0]
                self._client_addr = sdp.client_media_addr(offer)
                # the client sends us media unless its offer is recvonly
                self._payload = {
                    "video": video.direction in ("sendonly", "sendrecv"),
                }
            else:
                # datachannel-only offer: no media, but the socket still
                # carries ICE + DTLS + SCTP
                self._payload = {"video": False}
            payload = self._payload
            if offer.is_secure():
                # browser-shaped offer: ICE-lite + DTLS-SRTP on ONE socket
                # (server/secure/).  Media flows only after the handshake.
                if offer.fingerprint_algo != "sha-256":
                    # refusing beats silently comparing a sha-384 value
                    # against our sha-256 digest (every connection would die
                    # with a misleading "fingerprint mismatch")
                    raise ValueError(
                        "only sha-256 DTLS fingerprints are supported "
                        f"(offer used {offer.fingerprint_algo!r})"
                    )
                try:
                    from .secure import SecureMediaSession
                except ImportError as e:
                    # no crypto backend on this box: a clean 400 with the
                    # reason beats a 500 mid-handshake (the session could
                    # never complete DTLS anyway)
                    raise ValueError(
                        "offer requires the encrypted tier but its crypto "
                        f"backend is unavailable ({e})"
                    ) from e

                self._secure_session = SecureMediaSession(
                    certificate=self._provider.dtls_certificate,
                    remote_fingerprint=offer.fingerprint,
                    remote_ufrag=offer.ice_ufrag,
                    stats=self._provider.stats,
                )
                app_section = offer.application()
                if app_section is not None:
                    # browser offered a datachannel (m=application): attach
                    # an SCTP association to the DTLS session so
                    # createDataChannel("config") reaches the agent's
                    # runtime-config handler
                    self._attach_sctp(app_section)
        else:
            try:
                payload = json.loads(desc.sdp)
            except (ValueError, TypeError) as e:
                raise ValueError(
                    f"native_rtp offer must be SDP or a JSON envelope: {e}"
                )
            if not payload.get("native_rtp"):
                raise ValueError("not a native_rtp offer")
            self._payload = payload
            if payload.get("client_addr"):
                host, port = payload["client_addr"]
                self._client_addr = (str(host), int(port))
        wants_video = payload.get("video", True)
        if wants_video or self._secure_session is not None:
            if wants_video:
                w = int(payload.get("width", self._provider.default_width))
                h = int(payload.get("height", self._provider.default_height))
                self.in_track = H264RingSource(
                    w, h, stats=self._provider.stats,
                    use_h264=self._provider.use_h264,
                )
            loop = asyncio.get_event_loop()
            # port 0 routes through the pinned-UDP-port patch when active;
            # in the secure tier this one socket carries EVERYTHING —
            # ICE checks, the DTLS handshake, SRTP in and SRTCP/SRTP out
            self._recv_transport, self._recv_protocol = (
                await loop.create_datagram_endpoint(
                    lambda: _RtpReceiverProtocol(
                        self.in_track,
                        self._rtcp_state,
                        on_pli=self._force_sink_keyframe,
                        session=self._secure_session,
                        plane_stats=self.plane_stats,
                    ),
                    local_addr=("0.0.0.0", 0),
                )
            )
            self.server_port = self._recv_transport.get_extra_info("sockname")[1]
            # RTCP reports flow for receive-only (WHIP) sessions too — the
            # publisher expects RRs about its stream (RFC 3550 s6.4.2)
            if self._sr_task is None:
                self._sr_task = asyncio.ensure_future(self._sr_loop())
            if self.in_track is not None:
                await self._emit("track", self.in_track)
        if (
            not wants_video
            and self._secure_session is None
            and self._client_addr is not None
        ):
            if self._broadcast_group is not None:
                # broadcast viewer (plain tier): no socket of its own; its
                # media comes from the group socket and its RTCP PLI goes
                # back there, so that is the port the answer advertises
                self.server_port = self._broadcast_group.port
            else:
                # pure send side (WHEP viewer): bind the send socket NOW so
                # the answer advertises ITS port — the viewer's RTCP PLI
                # must have a reachable target or keyframe recovery never
                # engages
                await self._ensure_send_transport()
                self.server_port = (
                    self._send_transport.get_extra_info("sockname")[1]
                )

    async def createAnswer(self):
        if self._sdp_offer is not None:
            # real SDP in -> real SDP out; port 9 (discard) when we opened
            # no receive socket (pure WHEP send side)
            secure = None
            if self._secure_session is not None:
                secure = {
                    "ice_ufrag": self._secure_session.ice.ufrag,
                    "ice_pwd": self._secure_session.ice.pwd,
                    "fingerprint": self._secure_session.fingerprint(),
                }
            return SessionDescription(
                sdp=sdp.build_answer(
                    self._sdp_offer,
                    host=self._provider.advertise_host,
                    video_port=self.server_port or 9,
                    secure=secure,
                ),
                type="answer",
            )
        return SessionDescription(
            sdp=json.dumps(
                {
                    "native_rtp": True,
                    "server_port": self.server_port,
                    "answer_for": self.pc_id,
                }
            ),
            type="answer",
        )

    async def setLocalDescription(self, desc: SessionDescription):
        self.localDescription = desc
        await self._start_senders()
        self.connectionState = "connected"
        self.iceConnectionState = "completed"
        await self._emit("connectionstatechange")

    def _attach_sctp(self, app_section):
        from .secure.sctp import SctpAssociation

        loop = asyncio.get_event_loop()

        def dispatch(fn, *args):
            r = fn(*args)
            if asyncio.iscoroutine(r):
                spawn(r)

        stats = self._provider.stats
        if stats is not None:
            # pre-register so "0" is distinguishable from "not wired"
            stats.count("datachannels", 0)
            stats.count("datachannel_messages", 0)

        def on_channel(channel):
            # DCEP open accepted — surface it exactly like aiortc does
            if stats is not None:
                stats.count("datachannels")
            spawn(self._emit("datachannel", channel))

        def on_message(channel, message):
            if stats is not None:
                stats.count("datachannel_messages")

        self._sctp = SctpAssociation(
            "server",
            remote_port=app_section.sctp_port(),
            on_channel=on_channel,
            on_message=on_message,
            dispatch=dispatch,
        )
        self._sctp.transmit = self._sctp_transmit
        self._secure_session.sctp = self._sctp
        self._sctp_timer_task = loop.create_task(self._sctp_timer())

    def _sctp_transmit(self, pkt: bytes) -> None:
        if self._recv_transport is None or self._secure_session is None:
            return
        for d, a in self._secure_session.sctp_transmit(pkt):
            self._recv_transport.sendto(d, a)

    async def _sctp_timer(self):
        """Drive the association's retransmission clock (sans-IO core —
        the timer lives here, like the DTLS retransmit timer)."""
        try:
            while self._sctp is not None and not self._sctp.closed:
                await asyncio.sleep(0.5)
                for pkt in self._sctp.retransmit_due():
                    self._sctp_transmit(pkt)
        except asyncio.CancelledError:
            pass

    def attach_netadapt(self, ladder):
        """Join this session to its network-adaptation ladder
        (resilience/netadapt.py): RR blocks about our stream and NACK/PLI
        feedback flow in; rung moves actuate out through the sink's
        reconfigure() and the keyframe governor."""
        if ladder is None:
            return
        from ..resilience.netadapt import KeyframeGovernor

        self.netadapt = ladder
        self._rtcp_state.netadapt = ladder
        self.kf_governor = KeyframeGovernor(coalesce_s=ladder.pli_coalesce_s)
        ladder.apply = self._apply_net_profile
        self._apply_net_profile(ladder.profile())

    def _apply_net_profile(self, profile: dict):
        """One network-rung actuation: encoder bitrate/scale through the
        blessed reconfigure() path, keyframe cadence into the governor.
        Governor knobs are plain attribute writes (lock-free); the sink
        call takes ``_enc_lock``, which a worker thread can hold across a
        full encode (or an encoder rebuild) — so when this fires on the
        event loop (the control plane's tick task), the sink actuation is
        pushed to a worker instead of stalling every session's loop."""
        gov = self.kf_governor
        if gov is not None:
            gov.coalesce_s = profile["pli_coalesce_s"]
            gov.interval_s = profile["keyframe_interval_s"]
        sink = self._sink
        if sink is None:
            return

        def actuate():
            try:
                sink.reconfigure(
                    bitrate=profile["bitrate"], scale=profile["scale"]
                )
            except Exception:
                logger.exception("netadapt sink actuation failed")

        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            actuate()  # already off the loop (POST /config to_thread path)
            return
        loop.run_in_executor(None, actuate)

    def _force_sink_keyframe(self):
        """RTCP-PLI handler: the viewer dropped a frame — next encode is
        IDR.  Under network adaptation the keyframe governor coalesces
        storms: N PLIs inside one window cost ONE IDR."""
        if self._broadcast_group is not None:
            # broadcast viewer (secure tier: its PLIs arrive on its own
            # demuxed socket): the re-sync is the group's governed GOP
            # replay, never a sink of this session
            self._broadcast_group.on_viewer_pli(self.pc_id)
            return
        if self.kf_governor is not None and not self.kf_governor.request():
            return
        if self._sink is not None:
            self._sink.force_keyframe()

    async def _ensure_send_transport(self):
        if self._send_transport is not None:
            return
        loop = asyncio.get_event_loop()
        # the send socket doubles as the PLI return channel: the only
        # upstream traffic we understand is "please keyframe"
        self._send_transport, _ = await loop.create_datagram_endpoint(
            lambda: _PliListenerProtocol(
                self._force_sink_keyframe, rtcp_state=self._rtcp_state
            ),
            local_addr=("0.0.0.0", 0),
            remote_addr=self._client_addr,
        )
        self._plain_flush.bind(self._send_transport)

    def join_broadcast(self, group) -> None:
        """Make this session a viewer of a shared broadcast TX plane
        (server/broadcast.py); call before setRemoteDescription.  The
        session then builds no sink and no pump; it joins the group in
        :meth:`_start_senders`, once the transports a viewer needs exist."""
        self._broadcast_group = group

    async def _start_senders(self):
        if self._broadcast_group is not None:
            group = self._broadcast_group
            if self._secure_session is not None:
                # secure viewer: its SRTP and socket stay its own (the
                # cached-cipher frame path), only encode and packetize are
                # shared; send_media_batch protects (copies) before it returns
                group.add_viewer(self.pc_id, send_secure=self._recv_protocol.send_media_batch,
                                 payload_type=self._h264_pt)
            elif self._client_addr is not None:
                # plain viewer: its media and its RTCP go through the group socket
                group.add_viewer(self.pc_id, addr=self._client_addr, payload_type=self._h264_pt)
            return
        if not self.out_tracks:
            return
        if self._secure_session is None:
            if self._client_addr is None:
                return
            await self._ensure_send_transport()
        # secure tier: outbound SRTP rides the ONE demuxed socket, to the
        # ICE-latched address — the SDP c= line of a browser offer is
        # useless (0.0.0.0 / trickle), so there is no _client_addr to need
        w = int(self._payload.get("width", self._provider.default_width))
        h = int(self._payload.get("height", self._provider.default_height))
        self._sink = H264Sink(
            w, h, stats=self._provider.stats, use_h264=self._provider.use_h264,
            payload_type=self._h264_pt or 96, ssrc=OUT_SSRC,
            plane_stats=self.plane_stats,
        )
        if self.netadapt is not None:
            # the ladder may have moved before the sink existed (attach
            # races setLocalDescription) — actuate the current rung now
            self._apply_net_profile(self.netadapt.profile())
        for track in self.out_tracks:
            self._sender_tasks.append(
                asyncio.ensure_future(self._pump(track, self._sink))
            )
        # periodic reports for the outbound stream (RFC 3550; the clock
        # mapping receivers use for lip-sync and stats) — unless the
        # receive path already started the loop
        if self._sr_task is None:
            self._sr_task = asyncio.ensure_future(self._sr_loop())

    async def _sr_loop(self):
        while self.connectionState != "closed":
            try:
                await asyncio.sleep(rtcp_mod.report_interval_s())
                report = self._rtcp_state.make_report()
                if report is None:
                    continue
                if self._secure_session is not None:
                    wire = self._secure_session.protect_rtcp(report)
                    dst = self._secure_session.peer_addr
                    if wire is not None and dst is not None and self._recv_transport:
                        self._recv_transport.sendto(wire, dst)
                elif self._send_transport is not None:
                    self._send_transport.sendto(report)
                elif (
                    self._recv_transport is not None
                    and self._recv_protocol is not None
                    and self._recv_protocol._last_addr is not None
                ):
                    # plain receive-only (WHIP publisher): the RR rides the
                    # receive socket back to the publisher's source address
                    self._recv_transport.sendto(
                        report, self._recv_protocol._last_addr
                    )
            except asyncio.CancelledError:
                return
            except Exception:
                # one transient send failure (route flap, close race) must
                # not kill the session's reports forever
                logger.exception("RTCP report emission failed — will retry")

    async def _pump(self, track, sink: H264Sink):
        """The RTP sender loop (aiortc's RTP sender, as the native tier runs
        it).  The H.264 encode runs on a worker thread; the whole frame's packet batch
        then flushes in ONE loop hop (frame-granular SRTP + sendmmsg)
        instead of one sendto per fragment."""
        try:
            while self.connectionState != "closed":
                frame = await track.recv()
                gov = self.kf_governor
                if gov is not None and gov.periodic_due():
                    # loss-driven re-sync cadence (netadapt): scheduled
                    # IDRs replace per-PLI reaction under sustained loss
                    sink.force_keyframe()
                pkts = await asyncio.to_thread(sink.consume, frame)
                trace = get_trace(frame)
                if not pkts:
                    # a TX-deadline shed (sealed in the sink), or the encoder
                    # buffers: the timeline stays open for its AU's frame
                    continue
                sent = False
                if self._secure_session is not None:
                    # drops silently until DTLS keys + ICE latch exist
                    if self._batch_tx:
                        sent = self._recv_protocol.send_media_batch(pkts, trace=trace)
                    else:
                        # protect and send interleave per packet: one
                        # combined span, marked per_packet_tx
                        tm0 = time.monotonic() if trace is not None else 0.0
                        for pkt in pkts:
                            sent = self._recv_protocol.send_media(pkt) or sent
                        if trace is not None:
                            trace.mark("per_packet_tx")
                            trace.add_span("send", tm0, time.monotonic())
                else:
                    self._send_plain(pkts, trace=trace)
                    sent = True
                if trace is not None:
                    trace.finish("sent" if sent else "dropped")
        except (ConnectionError, asyncio.CancelledError):
            pass
        except Exception:
            logger.exception("sender pump failed")

    def _send_plain(self, pkts, trace=None) -> None:
        """Plain-tier frame flush: one coalesced batch on the connected
        send socket (per-packet sendto when batching is off)."""
        t0 = time.perf_counter()
        tm0 = time.monotonic() if trace is not None else 0.0
        for pkt in pkts:
            self._rtcp_state.sent(pkt, pkt)
        if self._batch_tx:
            self._plain_flush.flush(pkts)
        else:
            for pkt in pkts:
                self._send_transport.sendto(pkt)
        self.plane_stats.record_stage("send", time.perf_counter() - t0)
        self.plane_stats.count("tx_packets", len(pkts))
        if trace is not None:
            trace.add_span("send", tm0, time.monotonic())

    # OBS full-gather parity — nothing to gather on plain UDP
    async def _RTCPeerConnection__gather(self):
        pass

    async def close(self):
        if self.connectionState == "closed":
            return
        self.connectionState = "closed"
        self._provider.unregister_plane_session(self.pc_id)
        if self._broadcast_group is not None:
            self._broadcast_group.remove_viewer(self.pc_id)
            self._broadcast_group = None
        for t in self._sender_tasks:
            t.cancel()
        if self._sctp_timer_task is not None:
            self._sctp_timer_task.cancel()
        if self._sr_task is not None:
            self._sr_task.cancel()
        if self._sctp is not None:
            # tell the peer's stack the channels are gone (one ABORT) —
            # otherwise its datachannels dangle until its own RTX budget
            for pkt in self._sctp.close():
                self._sctp_transmit(pkt)
        if self.in_track:
            self.in_track.stop()
            self.in_track.close()
        if self._sink:
            self._sink.close()
        if self._recv_protocol:
            self._recv_protocol.close()
        if self._recv_transport:
            self._recv_transport.close()
        self._plain_flush.close()
        if self._send_transport:
            self._send_transport.close()
        await self._emit("connectionstatechange")


class NativeRtpProvider:
    name = "native-rtp"

    def __init__(
        self,
        default_width: int = 512,
        default_height: int = 512,
        use_h264: bool | None = None,
        stats: FrameStats | None = None,
        advertise_host: str | None = None,
    ):
        self.default_width = default_width
        self.default_height = default_height
        self.use_h264 = use_h264
        self.stats = stats
        # address written into real-SDP answers (c= / a=candidate); plain
        # RTP has no ICE so the operator advertises the reachable interface
        self.advertise_host = advertise_host or env_util.get_str(
            "ADVERTISE_HOST", "127.0.0.1"
        )
        self._dtls_certificate = None
        # pc_id -> per-session host-plane FrameStats: the
        # packetize/protect/send/recv µs histograms behind /metrics'
        # host_plane_sessions block
        self._plane_sessions: dict = {}
        # pc_id -> live peer connection: the runtime encoder-config surface
        # (/config {"encoder": ...}) fans out over these
        self._live_pcs: dict = {}

    def register_plane_session(
        self, pc_id: str, stats: FrameStats, pc=None
    ) -> None:
        self._plane_sessions[pc_id] = stats
        if pc is not None:
            self._live_pcs[pc_id] = pc

    def unregister_plane_session(self, pc_id: str) -> None:
        self._plane_sessions.pop(pc_id, None)
        self._live_pcs.pop(pc_id, None)

    ENCODER_CONFIG_KEYS = ("bitrate", "gop", "fps", "scale")

    def validate_encoder_config(self, cfg) -> dict:
        """Reject a malformed encoder config BEFORE any sink mutates —
        /config's contract is that a 400 means nothing was applied."""
        if not isinstance(cfg, dict) or not cfg:
            raise ValueError("encoder config must be a non-empty JSON object")
        out = {}
        for key, val in cfg.items():
            if key not in self.ENCODER_CONFIG_KEYS:
                raise ValueError(
                    f"unknown encoder config key {key!r} "
                    f"(expected one of {self.ENCODER_CONFIG_KEYS})"
                )
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                raise ValueError(f"encoder {key} must be a number")
            val = int(val)
            if val <= 0:
                raise ValueError(f"encoder {key} must be positive")
            out[key] = val
        return out

    def apply_encoder_config(self, cfg: dict) -> int:
        """Runtime encoder reconfigure (POST /config ``{"encoder": {...}}``):
        validate, then fan out to every live session's sink through the ONE
        blessed mutation path (H264Sink.reconfigure → H264Encoder.
        reconfigure).  -> number of sinks updated (0 = no live senders)."""
        cfg = self.validate_encoder_config(cfg)
        n = 0
        for pc in list(self._live_pcs.values()):
            na = getattr(pc, "netadapt", None)
            sink = getattr(pc, "_sink", None)
            if na is not None:
                # ladder-joined session: the operator's bitrate becomes the
                # ladder's BASE and actuation flows through the CURRENT
                # rung's profile — a session holding at reduce_resolution
                # must not have full rate/scale pushed onto its congested
                # link by an operator update (the rung scales the new base
                # instead; recovery returns to it).  gop/fps are not
                # rung-owned and apply directly.
                if "bitrate" in cfg:
                    na.base_bitrate = cfg["bitrate"]
                direct = {k: v for k, v in cfg.items() if k in ("gop", "fps")}
                if sink is not None and direct:
                    sink.reconfigure(**direct)
                pc._apply_net_profile(na.profile())
                if sink is not None:
                    n += 1
            elif sink is not None:
                sink.reconfigure(**cfg)
                n += 1
        return n

    def host_plane_snapshot(self) -> dict:
        """{pc_id: stage µs percentiles} for every live session."""
        return {
            pc_id: stats.stage_snapshot_us(
                ("packetize", "protect", "send", "recv")
            )
            for pc_id, stats in self._plane_sessions.items()
        }

    @property
    def dtls_certificate(self):
        """One DTLS identity per provider (lazy: ECDSA keygen only when a
        secure offer actually arrives)."""
        if self._dtls_certificate is None:
            from .secure import generate_certificate

            self._dtls_certificate = generate_certificate()
        return self._dtls_certificate

    def attach_stats(self, stats: FrameStats):
        self.stats = stats

    def session_description(self, sdp: str, type: str):
        return SessionDescription(sdp, type)

    def peer_connection(self, ice_servers=None):
        return NativeRtpPeerConnection(self, configuration=ice_servers)

    def h264_codec_preferences(self, kind: str = "video"):
        return [{"mimeType": "video/H264", "name": "H264"}]

    def force_codec(self, pc, sender, forced_codec: str):
        for t in pc.getTransceivers():
            if t.sender is sender:
                t.setCodecPreferences([{"mimeType": forced_codec}])
