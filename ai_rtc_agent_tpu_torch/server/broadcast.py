"""The broadcast TX plane: encode once, packetize once, serve the audience
(the port's copy of ai_rtc_agent_tpu/server/broadcast.py).

:class:`BroadcastGroup` carries one publisher's outbound media for every
WHEP viewer of it:

* one :class:`~ai_rtc_agent_tpu_torch.media.plane.H264Sink` encodes and
  packetizes each processed frame once (pooled views);
* per viewer, only a vectorized SSRC/seq/ts header rewrite over those views
  (:class:`~ai_rtc_agent_tpu_torch.media.rtp.RtpHeaderRewriter`); a secure
  viewer then goes through its own session's SRTP (``send_media_batch``),
  and the plain audience goes out in one ``sendmmsg`` burst
  (:meth:`~ai_rtc_agent_tpu_torch.media.sockio.CoalescedFlush.flush_grouped`);
* a viewer's PLI, or a join, never reaches the engine or the encoder: the
  current GOP is replayed from :class:`~ai_rtc_agent_tpu_torch.media.gop.GopCache`
  as stable bytes, and the group's
  :class:`~ai_rtc_agent_tpu_torch.resilience.netadapt.KeyframeGovernor`
  coalesces a storm to one replay per ``NETADAPT_PLI_COALESCE_MS`` window.

The group also runs in AU mode (:meth:`BroadcastGroup.feed_au`) with no sink:
an edge agent's :class:`EdgePuller` subscribes once to the owning agent's
/whep, depacketizes, and feeds the access units here, so the owner serves
one viewer per edge and the edge serves its own audience.  The puller makes
its two HTTP calls (the owner's /whep and the DELETE) through
``fleet/transport.py``: over aiohttp between processes, in process on the
card's machine, which has no aiohttp.

Metrics are per group (one counter for the whole audience, never a
per-viewer label).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time

from ..media import sockio
from ..media.gop import GopCache
from ..media.plane import H264Sink
from ..media.rtp import BatchedRtpPacketizer, RtpHeaderRewriter, is_pli
from ..resilience.netadapt import KeyframeGovernor
from ..utils import env
from ..utils.dispatch import spawn
from ..utils.profiling import FrameStats
from . import wire

logger = logging.getLogger(__name__)

# the edge pull socket's receive buffer: the owner's group sends a frame in
# one sendmmsg burst, and a raw 512x512 frame is ~660 datagrams (~1.5 MB of
# the kernel's accounting), past the 212,992 B Linux default
PULL_RCVBUF = 8 << 20


class _Viewer:
    """What one viewer's copy of a frame needs beyond the shared
    packetization: a header rewrite with its own seq space (SRTP's
    consecutive-seq fast path needs each viewer's continuity) and one of a
    plain destination address or a secure send hook."""

    __slots__ = ("viewer_id", "rewriter", "addr", "send_secure")

    def __init__(self, viewer_id, rewriter, addr=None, send_secure=None):
        self.viewer_id = viewer_id
        self.rewriter = rewriter
        self.addr = addr
        self.send_secure = send_secure


class _GroupSocketProtocol(asyncio.DatagramProtocol):
    """The group's shared UDP socket: TX for every plain viewer's media, RX
    for their RTCP (the only message honoured is a PLI)."""

    def __init__(self, group: "BroadcastGroup"):
        self._group = group
        self.transport = None

    def connection_made(self, transport):
        self.transport = transport

    def datagram_received(self, data, addr):
        if is_pli(data):
            self._group.on_viewer_pli(addr=addr)


class BroadcastGroup:
    """One publisher's broadcast fan-out: one TX media plane, N viewers."""

    def __init__(
        self,
        publisher_id: str,
        *,
        width: int,
        height: int,
        fps: int = 30,
        use_h264: bool | None = None,
        ssrc: int = 0x5EED,
        payload_type: int = 96,
        stats: FrameStats | None = None,
        coalesce_s: float | None = None,
    ):
        self.publisher_id = publisher_id
        self.stats = stats or FrameStats()
        self.gop = GopCache()
        if coalesce_s is None:
            coalesce_s = env.get_float("NETADAPT_PLI_COALESCE_MS", 700.0) / 1e3
        self.governor = KeyframeGovernor(coalesce_s=coalesce_s)
        self._ssrc = ssrc
        self._payload_type = payload_type
        self._wh = (width, height)
        self._fps = fps
        self._use_h264 = use_h264
        self._viewers: dict = {}
        self._by_addr: dict = {}  # plain viewer addr -> viewer_id (the PLI map)
        self._sink: H264Sink | None = None
        self._track = None
        self._pump_task: asyncio.Task | None = None
        self._transport = None
        self._flush = sockio.CoalescedFlush()
        # the replay and AU-mode packetizer, on the event loop only (the
        # sink's own packetizer runs on the encode worker; sharing one would
        # race its pool)
        self._au_pkt = BatchedRtpPacketizer(ssrc=ssrc, payload_type=payload_type)
        self.port: int | None = None
        self.closed = False
        self.frames = 0  # AUs fanned out (monotonic)
        # AU mode has no encoder to force: a granted re-sync with an empty
        # cache escalates here (the edge puller sends one PLI to the owner)
        self.idr_fallback = None

    # -- lifecycle -----------------------------------------------------------

    async def start(self, track=None) -> None:
        """Bind the group socket; with ``track`` (a relay's view of the
        publisher's processed stream) start the encode pump, without it
        the group runs in AU mode (:meth:`feed_au`)."""
        loop = asyncio.get_running_loop()
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _GroupSocketProtocol(self), local_addr=("0.0.0.0", 0)
        )
        self.port = self._transport.get_extra_info("sockname")[1]
        self._flush.bind(self._transport)
        if track is not None:
            self._track = track
            self._sink = H264Sink(
                self._wh[0], self._wh[1], fps=self._fps, stats=self.stats,
                use_h264=self._use_h264, ssrc=self._ssrc, payload_type=self._payload_type,
                plane_stats=self.stats,
                au_tap=self._on_au,  # the worker thread; GopCache.add is safe there
            )
            self._pump_task = spawn(self._pump())

    async def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self._pump_task is not None:
            self._pump_task.cancel()
        if self._track is not None:
            self._track.stop()
        if self._sink is not None:
            self._sink.close()
        self._flush.close()
        if self._transport is not None:
            self._transport.close()
        self._viewers.clear()
        self._by_addr.clear()

    # -- viewers -------------------------------------------------------------

    @property
    def viewer_count(self) -> int:
        return len(self._viewers)

    def add_viewer(self, viewer_id: str, *, addr=None, send_secure=None,
                   payload_type: int | None = None) -> None:
        """Join one viewer: ``addr`` (plain tier: its media and its PLIs go
        through the group socket) or ``send_secure`` (the viewer session's
        frame-batch send hook; its SRTP and socket stay its own).  A
        ``payload_type`` other than the group's is patched into every packet
        (a browser's offer picks its own H264 PT).  A join mid-stream
        replays the cached GOP to this viewer only; the engine and the
        encoder are untouched."""
        # seq0 follows the replay packetizer's cursor: the join replay below
        # advances both in lockstep, so in AU mode (live traffic shares that
        # packetizer) the viewer stays aligned and the rewrite's identity
        # path hands it the source views; frame mode desyncs at the replay
        # (the live seq is the sink's) and pays the copying rewrite
        rewriter = RtpHeaderRewriter(
            ssrc=self._ssrc,
            payload_type=payload_type if payload_type != self._payload_type else None,
            seq0=self._au_pkt.seq,
        )
        v = _Viewer(viewer_id, rewriter, addr=addr, send_secure=send_secure)
        self._viewers[viewer_id] = v
        if addr is not None:
            self._by_addr[tuple(addr)] = viewer_id
        self.stats.count("broadcast_viewer_joins")
        snap = self.gop.snapshot()
        if snap:
            self._replay(snap, [v])
        else:
            # nothing cached yet (before the first IDR): one governed
            # encoder keyframe re-syncs the whole join burst
            self._request_idr()

    def remove_viewer(self, viewer_id: str) -> None:
        v = self._viewers.pop(viewer_id, None)
        if v is not None and v.addr is not None:
            self._by_addr.pop(tuple(v.addr), None)

    # -- media in ------------------------------------------------------------

    def _on_au(self, au, ts: int) -> None:
        # the encode worker's thread (H264Sink au_tap): the cache keeps bytes
        self.gop.add(au, ts)

    async def _pump(self):
        """Frame mode: pull the publisher's processed frames once, encode
        and packetize once, fan the pooled views out to everyone."""
        try:
            while not self.closed:
                frame = await self._track.recv()
                if self.governor.periodic_due():
                    self._sink.force_keyframe()
                pkts = await asyncio.to_thread(self._sink.consume, frame)
                if pkts:
                    self.fan_out(pkts)
        except (ConnectionError, asyncio.CancelledError):
            pass
        except Exception:
            logger.exception("broadcast pump failed")

    def feed_au(self, au, ts: int) -> None:
        """AU mode (the edge pull): one depacketized access unit of the
        owning agent's stream: cache it, packetize once, fan out."""
        self.gop.add(au, ts)
        t0 = time.perf_counter()
        pkts = self._au_pkt.packetize(au, int(ts))
        self.stats.record_stage("packetize", time.perf_counter() - t0)
        if pkts:
            self.fan_out(pkts)

    # -- media out -----------------------------------------------------------

    def _deliver(self, pkts, viewers) -> list:
        """Each viewer's rewrite of one frame's packets, with the gather of
        the copying path computed once for all of them; a secure viewer is
        sent to here (``protect_frame`` copies into ciphertext before it
        returns), the plain viewers' batches are returned for one burst."""
        batches = []
        plan = None
        for v in viewers:
            rw = v.rewriter
            if plan is None and not rw.aligned(pkts):
                plan = rw.plan(pkts)
            out = rw.rewrite(pkts, plan)
            if v.send_secure is not None:
                v.send_secure(out)
            elif v.addr is not None:
                batches.append((out, v.addr))
        return batches

    def fan_out(self, pkts) -> None:
        """One packetized frame to every viewer: the rewrites over the shared
        pooled views, the secure viewers through their own SRTP, the plain
        audience in one sendmmsg burst.  Event loop only (the rewriters and
        the grouped sender are single-threaded)."""
        self.frames += 1
        if not self._viewers:
            return
        t0 = time.perf_counter()
        batches = self._deliver(pkts, self._viewers.values())
        t1 = time.perf_counter()
        self.stats.record_stage("rewrite", t1 - t0)
        if batches:
            # flush_grouped copies each view into its iovec pool inside the
            # call: no rewrite view outlives its pool slot
            self._flush.flush_grouped(batches)
            self.stats.record_stage("send", time.perf_counter() - t1)
        self.stats.count("tx_packets", len(pkts) * len(self._viewers))

    # -- keyframe re-sync (never the engine) ---------------------------------

    def on_viewer_pli(self, viewer_id: str | None = None, addr=None) -> None:
        """A viewer lost its decoder state.  Governed: one re-sync per
        coalesce window however many viewers storm, served from the GOP
        cache (no engine or encoder work); only an empty cache falls back
        to one governed encoder IDR."""
        self.stats.count("broadcast_pli")
        if addr is not None and viewer_id is None:
            viewer_id = self._by_addr.get(tuple(addr))
        if not self.governor.request():
            self.stats.count("broadcast_pli_coalesced")
            return
        snap = self.gop.snapshot()
        if snap:
            # the one granted re-sync of the window covers every viewer
            # that stormed (or is about to), like a coalesced encoder IDR
            self._replay(snap, list(self._viewers.values()))
        else:
            self._force_upstream_idr()

    def _request_idr(self) -> None:
        if self.governor.request():
            self._force_upstream_idr()
        else:
            self.stats.count("broadcast_pli_coalesced")

    def _force_upstream_idr(self) -> None:
        """A governed re-sync that missed the cache: frame mode forces this
        group's encoder (one IDR, the engine untouched); AU mode escalates
        to the pull's source."""
        self.stats.count("broadcast_encoder_idr")
        if self._sink is not None:
            self._sink.force_keyframe()
        elif self.idr_fallback is not None:
            self.idr_fallback()

    def _replay(self, snap, viewers) -> None:
        """Re-packetize the cached GOP (stable bytes) and deliver it to
        ``viewers``: each viewer's seq goes on through the same rewriter as
        its live traffic, timestamps are the AUs' own."""
        if not viewers:
            return
        self.stats.count("broadcast_gop_replays")
        t0 = time.perf_counter()
        for au, ts in snap:
            pkts = self._au_pkt.packetize(au, ts)
            if not pkts:
                continue
            batches = self._deliver(pkts, viewers)
            if batches:
                self._flush.flush_grouped(batches)
        self.stats.record_stage("gop_replay", time.perf_counter() - t0)

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        """The group's gauges for /metrics: O(1) reads, never per viewer."""
        return {
            "viewers": len(self._viewers),
            "frames": self.frames,
            "gop_aus": self.gop.aus,
            "gop_bytes": self.gop.bytes,
            "gop_idrs": self.gop.idrs,
            "gop_overflows": self.gop.overflows,
            "pli_granted": self.governor.granted,
            "pli_coalesced": self.governor.coalesced,
            "port": self.port,
        }


class _PullProtocol(asyncio.DatagramProtocol):
    def __init__(self, puller: "EdgePuller"):
        self._puller = puller

    def datagram_received(self, data, addr):
        self._puller.on_datagram(data)


class EdgePuller:
    """An edge agent's one pulled copy of a publisher's stream.

    Subscribes to the owning agent's /whep as a plain native viewer (a
    JSON-envelope offer; it claims no engine slot there either), reorders
    and reassembles the RTP into access units and feeds them to a local
    AU-mode :class:`BroadcastGroup`, from which the edge's own viewers fan
    out: the owner serves one viewer per edge, not one per audience member.

    ``transport`` (fleet/transport.py) carries the /whep offer and the
    DELETE: ``AiohttpTransport`` between processes, ``InProcessTransport``
    for agents in this process (the media still crosses real UDP).

    Keyframe escalation stays governed end to end: a local viewer storm
    coalesces at the edge group, and only a granted re-sync that missed
    the cache sends one PLI upstream, where the owner's group coalesces
    again.

    The pull socket's receive buffer holds a whole frame's burst
    (:data:`PULL_RCVBUF`, past ``net.core.rmem_max`` where the process may);
    the JAX puller keeps the default, which a raw 512x512 frame overflows."""

    def __init__(self, group: BroadcastGroup, owner_url: str, transport,
                 advertise_host: str | None = None):
        from ..media.rtp import RtpDepacketizer, RtpReorderBuffer

        self.group = group
        self.owner_url = owner_url.rstrip("/")
        self._http = transport
        self._advertise = advertise_host or env.get_str("ADVERTISE_HOST", "127.0.0.1")
        self._reorder = RtpReorderBuffer()
        self._depkt = RtpDepacketizer()  # raises without the native runtime
        self._transport = None
        self._session_path: str | None = None
        self._upstream = None  # (host, port) of the owner's group socket
        self.rcvbuf = None  # the receive buffer the kernel granted
        self.closed = False
        self.aus = 0  # access units pulled (monotonic)

    async def open(self) -> "EdgePuller":
        loop = asyncio.get_running_loop()
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _PullProtocol(self), local_addr=("0.0.0.0", 0)
        )
        self.rcvbuf = sockio.set_rcvbuf(self._transport.get_extra_info("socket"), PULL_RCVBUF)
        port = self._transport.get_extra_info("sockname")[1]
        offer = json.dumps({"native_rtp": True, "video": False,
                            "client_addr": [self._advertise, port]})
        resp = await self._http.request(
            "POST", f"{self.owner_url}/whep", data=offer.encode("utf-8"),
            headers={"Content-Type": "application/sdp"},
        )
        if resp.status not in (200, 201):
            raise RuntimeError(f"owner refused edge pull: HTTP {resp.status}")
        self._session_path = resp.headers.get(wire.LOCATION)
        body = resp.json()
        host = self.owner_url.split("://", 1)[-1].split("/", 1)[0]
        host = host.rsplit(":", 1)[0] or "127.0.0.1"
        self._upstream = (host, int(body["server_port"]))
        self.group.idr_fallback = self.request_upstream_idr
        # a fresh edge has nothing cached: one governed IDR from the owner
        # now, so that the first local viewer can decode at once
        self.request_upstream_idr()
        return self

    def on_datagram(self, data) -> None:
        """The owner's RTP in, AUs out to the local group (the event loop,
        microseconds a packet: reorder and reassembly, no decode)."""
        for pkt in self._reorder.push(data):
            got = self._depkt.push(pkt)
            if got is not None:
                self.aus += 1
                self.group.feed_au(got[0], got[1])

    def request_upstream_idr(self) -> None:
        if self._transport is not None and self._upstream is not None:
            from ..media.rtp import make_pli

            self._transport.sendto(make_pli(), self._upstream)

    async def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.group.idr_fallback = None
        if self._session_path:
            try:
                await self._http.request("DELETE", f"{self.owner_url}{self._session_path}")
            except Exception:
                logger.debug("edge pull DELETE failed", exc_info=True)
        if self._transport is not None:
            self._transport.close()
        self._depkt.close()
