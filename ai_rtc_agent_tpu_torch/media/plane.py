"""The native media plane, assembled: RTP ⇄ H.264 ⇄ frame ring ⇄ pipeline
(the port's copy of ai_rtc_agent_tpu/media/plane.py; the frame traces of obs/trace.py stamp ``decode``,
``encode`` and ``packetize`` here, and a TX-deadline shed seals ``shed``):

  RTP packets ──► RtpDepacketizer ──► H264Decoder ──► FrameRing (native
  SPSC, latest-wins) ──► H264RingSource.recv() ──► VideoStreamTrack ──►
  pipeline (uint8 in, uint8 out) ──► H264Sink.consume() ──►
  H264Encoder ──► RtpPacketizer ──► RTP packets

Every stage stamps ``FrameStats``: decode / encode ms per frame, plus true
glass-to-glass (decode-complete → encode-complete) via the frame's
``wall_ts`` (/metrics ``glass``).

Falls back to ``NullCodec`` framing when libavcodec 5.x isn't present so
the full byte-stream contract stays testable anywhere (media/codec.py).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from fractions import Fraction

import numpy as np

from ..obs.trace import get_trace
from ..utils import env as env_util
from ..utils.profiling import FrameStats
from . import native
from .codec import H264Decoder, H264Encoder, NullCodec
from .frames import VideoFrame
from .ring import FrameRing
from .rtcp import is_rtcp
from .rtp import (
    BatchedRtpPacketizer,
    RtpDepacketizer,
    RtpPacketizer,
    RtpReorderBuffer,
)

logger = logging.getLogger(__name__)

CLOCK_RATE = 90_000  # RTP video clock


class H264RingSource:
    """Track-like source: RTP/H.264 bytes in, decoded frames out.

    ``feed_packet`` / ``feed_au`` run on the network thread: depacketize,
    decode (native shim or NullCodec), push into the native SPSC frame ring
    (latest-wins — a slow consumer drops stale frames instead of building a
    latency queue, which is what a real-time stream wants).  ``recv()`` is
    the asyncio pull side feeding ``VideoStreamTrack``.
    """

    kind = "video"

    def __init__(
        self,
        width: int,
        height: int,
        stats: FrameStats | None = None,
        ring_slots: int = 4,
        use_h264: bool | None = None,
    ):
        self.stats = stats or FrameStats()
        self.use_h264 = native.h264_available() if use_h264 is None else use_h264
        self._dec = H264Decoder() if self.use_h264 else None
        self._ring = FrameRing((height, width, 3), n_slots=ring_slots)
        self._ring_slots = ring_slots
        # serializes ring REPLACEMENT (geometry change, decode thread)
        # against the consumer's pop (asyncio thread): freeing the old
        # native ring without this would race a concurrent pop
        # (use-after-free).  Nanoseconds per acquire; both sides are
        # microseconds-long critical sections.
        self._ring_lock = threading.Lock()
        self._dropped_before_resize = 0
        self._depkt = RtpDepacketizer() if native.load() else None
        self._reorder = RtpReorderBuffer()
        self._meta: dict = {}  # pts -> wall_ts at decode completion
        # the native tier mints each frame's trace at decode (the frame id is
        # the RTP pts) while a session tracer is attached and tracing is live
        self.tracer = None  # SessionTracer | None (set by the agent's wiring)
        self._trace_decode: dict = {}  # pts -> (t0, t1) of its decode
        self._ended = False
        self._handlers: dict = {}
        # decode runs on an executor thread while close() runs on the event
        # loop: freeing the native decoder mid-decode is a segfault, so the
        # two serialize here and post-close feeds become no-ops
        self._io_lock = threading.Lock()
        self._closed = False
        # frame-arrival signal: recv() sleeps on this instead of busy-polling
        # the ring; the decode thread sets it via call_soon_threadsafe
        self._loop = None
        self._frame_event: asyncio.Event | None = None

    # -- network side (any thread) ------------------------------------------

    def poll(self):
        """Non-blocking pop of the newest decoded frame: (frame, pts) or
        None — the sync-consumer counterpart of the async recv()."""
        with self._ring_lock:
            return self._ring.pop()

    def depacketize(self, packet: bytes) -> list:
        """One RTP packet -> list of completed (AU bytes, ts).  Runs the
        reorder buffer first (UDP reorders; FU-A assembly needs order), so
        one packet may release several buffered ones and complete multiple
        AUs.  Microseconds of work — safe inline on the receive path; only
        the AU decode (feed_au) needs a worker thread."""
        if self._depkt is None:
            raise RuntimeError("native RTP runtime unavailable")
        if self._closed:
            return []
        if is_rtcp(packet):
            # rtcp-mux (RFC 5761): reports ride the media port.  A compound
            # RTCP fed into the reorder buffer would be read as an RTP seq
            # (bytes 2:4 are its LENGTH field) and desync the window.
            return []
        aus = []
        for pkt in self._reorder.push(packet):
            got = self._depkt.push(pkt)
            if got is not None:
                aus.append(got)
        return aus

    def feed_packet(self, packet: bytes):
        """One RTP packet; completed AUs -> decode -> ring."""
        for au, ts in self.depacketize(packet):
            self.feed_au(au, ts)

    def feed_au(self, au: bytes, pts: int = 0):
        """One encoded access unit -> decoded frame into the ring.

        A corrupt AU (packet loss past the reorder window, mid-stream join
        before the first keyframe) drops THAT frame, keeps the stream alive
        AND fires ``on_decode_error`` — the transport layer turns that into
        an RTCP-PLI-shaped message to the sender so the encoder emits an
        IDR within a frame instead of the viewer freezing for up to a gop
."""
        t0 = time.monotonic()
        with self._io_lock:
            if self._closed:
                return  # connection torn down while this AU sat on a worker
            if self.use_h264:
                try:
                    got = self._dec.decode(au, pts)
                except RuntimeError as e:
                    logger.warning("dropping undecodable AU (%s)", e)
                    cb = self._handlers.get("decode_error")
                    if cb is not None:
                        try:
                            cb()
                        except Exception:
                            logger.exception("decode_error handler failed")
                    return
                if got is None:
                    return
                frame, out_pts = got
            else:
                frame, out_pts = NullCodec.decode(au)
            now = time.monotonic()
            self.stats.record_stage("decode", now - t0)
            self._meta[int(out_pts)] = now
            if len(self._meta) > 64:  # bound the pts->wall map
                for k in sorted(self._meta)[:-64]:
                    self._meta.pop(k, None)
            tracer = self.tracer
            if tracer is not None and tracer.controller.active():
                # the stage gauge's clock reads are the decode span
                self._trace_decode[int(out_pts)] = (t0, now)
                if len(self._trace_decode) > 64:  # the same bound as _meta
                    for k in sorted(self._trace_decode)[:-64]:
                        self._trace_decode.pop(k, None)
            if frame.shape != self._ring.frame_shape:
                # real-SDP offers carry no geometry — the H.264 SPS is the
                # source of truth.  A browser camera at any resolution must
                # work, so the ring follows the decoder, not the ctor hint.
                logger.info(
                    "stream geometry %s != configured %s — resizing ring",
                    frame.shape,
                    self._ring.frame_shape,
                )
                with self._ring_lock:
                    self._dropped_before_resize += self._ring.dropped
                    old = self._ring
                    self._ring = FrameRing(frame.shape, n_slots=self._ring_slots)
                    old.close()
            self._ring.push_latest(frame, meta=int(out_pts))
        if self._loop is not None and self._frame_event is not None:
            try:
                self._loop.call_soon_threadsafe(self._frame_event.set)
            except RuntimeError:
                pass  # loop already closed

    # -- pipeline side (asyncio) --------------------------------------------

    def _wrap(self, got) -> VideoFrame:
        arr, pts = got
        vf = VideoFrame.from_ndarray(arr)
        vf.pts = int(pts)
        vf.time_base = Fraction(1, CLOCK_RATE)
        vf.wall_ts = self._meta.get(int(pts))
        tracer = self.tracer
        if tracer is not None and tracer.controller.active():
            trace = tracer.mint(frame_id=int(pts))
            dec = self._trace_decode.pop(int(pts), None)
            if dec is not None:
                trace.add_span("decode", dec[0], dec[1])
            vf.trace = trace
        return vf

    def recv_nowait(self) -> VideoFrame | None:
        """Non-blocking pull for the overload ingest hop (server/tracks.py
        freshest-frame-wins).  The ring is already latest-wins, so this
        rarely fires — it exists so the track layer can treat every source
        uniformly."""
        got = self.poll()
        return None if got is None else self._wrap(got)

    async def recv(self) -> VideoFrame:
        if self._loop is None:
            self._loop = asyncio.get_running_loop()
            self._frame_event = asyncio.Event()
        while True:
            got = self.poll()  # ring-lock-protected pop (geometry swaps)
            if got is not None:
                return self._wrap(got)
            if self._ended:
                raise ConnectionError("source ended")
            # event-driven wait (timeout is only a liveness fallback for
            # frames pushed before the loop reference existed)
            try:
                await asyncio.wait_for(self._frame_event.wait(), timeout=0.25)
            except asyncio.TimeoutError:
                pass
            self._frame_event.clear()

    def on(self, event: str, f=None):
        def register(fn):
            self._handlers[event] = fn
            return fn

        return register(f) if f else register

    def stop(self):
        self._ended = True
        from ..utils.dispatch import fire_handler

        fire_handler(self._handlers.get("ended"))

    @property
    def dropped(self) -> int:
        return self._ring.dropped + self._dropped_before_resize

    def close(self):
        with self._io_lock:  # never free the decoder under an active decode
            self._closed = True
            with self._ring_lock:
                self._ring.close()
            if self._dec:
                self._dec.close()
            if self._depkt:
                self._depkt.close()


class H264Sink:
    """Processed frames in, RTP/H.264 packets out (+ encode/glass gauges)."""

    def __init__(
        self,
        width: int,
        height: int,
        fps: int = 30,
        stats: FrameStats | None = None,
        use_h264: bool | None = None,
        ssrc: int = 0x5EED,
        payload_type: int = 96,
        plane_stats: FrameStats | None = None,
        au_tap=None,
    ):
        """``payload_type``: RTP PT for outgoing packets — real-SDP answers
        echo the client's offered H264 payload number (server/sdp.py), so
        the wire must carry the same value.  ``plane_stats``: per-session
        host-plane stage gauges (packetize µs histograms at /metrics).
        ``au_tap``: an optional ``(au_bytes, pts)`` callable, called on the
        worker thread with every non-empty encoded AU before packetize (the
        broadcast plane's GOP cache; the AU bytes are stable, the packets
        below are pooled views)."""
        self.stats = stats or FrameStats()
        self._au_tap = au_tap
        self.plane_stats = plane_stats
        self.use_h264 = native.h264_available() if use_h264 is None else use_h264
        self._enc = H264Encoder(width, height, fps) if self.use_h264 else None
        self._wh = (height, width)
        self._fps = fps
        self._closed = False
        # consume() runs on a worker thread while force_keyframe()/close()
        # arrive from the event loop (PLI path) — the encoder swap on a
        # geometry change must not free a handle another thread is using
        self._enc_lock = threading.Lock()
        # HOST_PLANE_BATCH (default on): the vectorized frame-granular
        # packetizer — wire-identical to the native per-packet one
        # (tests/test_host_plane.py) and native-toolchain-independent.
        # Packets are memoryviews into its rotating pool: valid until the
        # pool wraps (HOST_PLANE_POOL_SLOTS more frames); holders copy.
        if env_util.get_bool("HOST_PLANE_BATCH", True):
            self._pkt = BatchedRtpPacketizer(ssrc=ssrc, payload_type=payload_type)
        else:
            self._pkt = (
                RtpPacketizer(ssrc=ssrc, payload_type=payload_type)
                if native.load()
                else None
            )
        self._pts = 0
        self._pts_step = CLOCK_RATE // max(1, fps)
        # encode/TX-hop deadline (resilience/overload.py): a frame whose
        # decode stamp has aged past this never reaches the encoder — under
        # overload the oldest work is shed at the LAST hop too, instead of
        # burning encode + wire on pixels the viewer will discard as stale.
        # 0 disables; only stamped frames (wall_ts) are ever shed.  Follows
        # the OVERLOAD_CONTROL kill-switch: with the plane off there is no
        # shedding ladder to walk a slow session to passthrough, so an
        # ungated deadline here could shed EVERY frame of a slow-but-
        # flowing stream — the pre-overload behavior (late beats frozen)
        # must come back whole.
        self._deadline_s = (
            env_util.get_float("OVERLOAD_TX_DEADLINE_MS", 2000.0) / 1e3
            if env_util.get_bool("OVERLOAD_CONTROL", True)
            else 0.0
        )
        self.shed_stale = 0  # frames dropped at this hop (monotonic)
        # network-adaptation actuation state (resilience/netadapt.py):
        # encode-side decimation divisor, and the last-applied encoder
        # profile — recorded even on the NullCodec tier so quality rungs
        # are observable/testable without libavcodec
        self._scale = 1
        self.profile: dict = {
            "bitrate": None, "gop": None, "fps": fps, "scale": 1,
        }

    def reconfigure(
        self,
        *,
        bitrate: int | None = None,
        gop: int | None = None,
        fps: int | None = None,
        scale: int | None = None,
    ) -> None:
        """Runtime encoder profile change — the session-level entry of the
        ONE blessed encoder mutation path (H264Encoder.reconfigure).  Used
        by the network-adaptation ladder and the runtime /config surface.
        ``scale``: encode-side decimation divisor (>=1); the encoder
        restarts at the reduced geometry through the existing
        geometry-change path in consume().  Safe from any thread — the
        lock serializes against consume()'s encoder use."""
        with self._enc_lock:
            for key, val in (
                ("bitrate", bitrate), ("gop", gop), ("fps", fps),
            ):
                if val is not None:
                    self.profile[key] = int(val)
            if scale is not None:
                self._scale = max(1, int(scale))
                self.profile["scale"] = self._scale
            if fps is not None:
                self._fps = max(1, int(fps))
                self._pts_step = CLOCK_RATE // self._fps
            if self._enc is not None:
                self._enc.reconfigure(bitrate=bitrate, gop=gop, fps=fps)

    def consume(self, frame) -> list[bytes]:
        """frame: VideoFrame or [H,W,3] uint8 -> list of RTP packets
        ('' AUs while the encoder buffers produce an empty list)."""
        if hasattr(frame, "to_ndarray"):
            arr = frame.to_ndarray(format="rgb24")
            pts = frame.pts if frame.pts is not None else self._pts
            wall = getattr(frame, "wall_ts", None)
        else:
            arr, pts, wall = np.asarray(frame), self._pts, None
        self._pts = int(pts) + self._pts_step
        trace = get_trace(frame)
        if (
            wall is not None
            and self._deadline_s
            and time.monotonic() - wall > self._deadline_s
        ):
            self.shed_stale += 1
            self.stats.count("overload_shed_tx_stale")
            if trace is not None:  # the TX-deadline eviction seals the timeline
                trace.mark("tx_shed")
                trace.finish("shed")
            return []

        t0 = time.monotonic()
        with self._enc_lock:
            if self.use_h264 and self._enc is None:
                return []  # sink closed while a frame sat on the worker
            if self._scale > 1:
                # reduce-resolution rung: cheap decimation before encode —
                # the geometry-change branch below restarts the encoder at
                # the smaller size (new SPS; decoders re-sync on it).
                # Crop to EVEN dims: yuv420 encoders reject odd geometry,
                # and the degradation rung must never kill the send path
                arr = arr[:: self._scale, :: self._scale]
                h2 = arr.shape[0] & ~1 or arr.shape[0]
                w2 = arr.shape[1] & ~1 or arr.shape[1]
                arr = np.ascontiguousarray(arr[:h2, :w2])
            if self.use_h264 and arr.shape[:2] != self._wh:
                # the pipeline's output geometry is the model's, which a
                # real-SDP answer cannot know up front — restart the encoder
                # at the true size (new SPS; decoders re-sync on it)
                logger.info(
                    "encode geometry %s != configured %s — restarting encoder",
                    arr.shape[:2],
                    self._wh,
                )
                self._enc.close()
                self._wh = (arr.shape[0], arr.shape[1])
                # build ONCE with the session's LIVE profile: a geometry
                # restart must not revert a runtime reconfigure to
                # compile-time defaults (the restart-defaults bug class),
                # and reconfigure-after-build would throw the fresh
                # encoder away on libs without in-place rate control
                # tpurtc: allow[encoder-reconfig] -- geometry restart re-applies this sink's live reconfigure() profile; rate targets still have one owner
                self._enc = H264Encoder(
                    arr.shape[1], arr.shape[0], self._fps,
                    bitrate=self.profile["bitrate"],
                    gop=self.profile["gop"] or 60,
                )
            if self.use_h264:
                au = self._enc.encode(arr, pts=int(pts))
            else:
                au = NullCodec.encode(arr, pts=int(pts))
        now = time.monotonic()
        self.stats.record_stage("encode", now - t0)
        if trace is not None:
            trace.add_span("encode", t0, now)  # the stage gauge's stamps
        if wall is not None:
            self.stats.record_stage("glass", now - wall)
        if not au:
            return []
        if self._au_tap is not None:
            self._au_tap(au, int(pts))
        with self._enc_lock:  # close() frees the native packetizer too
            if self._pkt is None:
                return [au] if not self._closed else []
            t1 = time.perf_counter()
            # the µs gauges run on perf_counter, the trace on monotonic
            tm0 = time.monotonic() if trace is not None else 0.0
            pkts = self._pkt.packetize(au, int(pts))
            if self.plane_stats is not None:
                self.plane_stats.record_stage(
                    "packetize", time.perf_counter() - t1
                )
            if trace is not None:
                trace.add_span("packetize", tm0, time.monotonic())
            return pkts

    def force_keyframe(self):
        """Next consumed frame encodes as an IDR (PLI recovery — safe from
        any thread: the lock serializes against the geometry-change
        encoder swap in consume())."""
        with self._enc_lock:
            if self._enc is not None:
                self._enc.force_keyframe()

    def flush(self) -> bytes:
        with self._enc_lock:
            if not self.use_h264 or self._enc is None:
                return b""
            return self._enc.flush()

    def close(self):
        with self._enc_lock:
            self._closed = True
            if self._enc:
                self._enc.close()
                self._enc = None
            if self._pkt:
                self._pkt.close()
                self._pkt = None
