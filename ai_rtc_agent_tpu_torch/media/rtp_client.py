"""Reusable native-RTP client: the peer-side loop of the media plane (the
port's copy of ai_rtc_agent_tpu/media/rtp_client.py), used by the tests and
``chip_smoke.py``: the offer envelope, socket plumbing and the feed/poll
drain discipline.

The drain interleaves ``feed_packet`` with ``poll``: the receive ring is a
4-slot latest-wins buffer, so feeding a whole burst before popping would
evict all but the newest few frames and undercount a perfectly healthy
stream.

The receive protocol drains each burst through the agent's own pooled
``DatagramDrain`` (HOST_PLANE_RX_BATCH), where the JAX client takes one
datagram per event-loop callback; the datagrams and their order are the
same.  Beside the JAX client's surface, two peer-side settings that a 512² raw
``NullCodec`` stream over loopback needs (about 660 datagrams a frame, in
one burst each way) and that the agent's own sockets do not get:
``rcvbuf`` (the client's receive buffer, as a browser sizes its own) and
:meth:`NativeRtpClient.send_paced` (a sender pacer: the frame's packets go
out in bursts of ``burst``, yielding to the event loop between them, as a
WebRTC sender paces).  ``rx_stats`` counts the downlink's losses (RFC 3550
reception statistics) and ``drain(on_frame)`` hands each decoded frame and
its pts to the caller.
"""

from __future__ import annotations

import asyncio
import json
import socket
import time

import numpy as np

from ..resilience import faults as _faults
from ..resilience.overload import DeadlineQueue
from ..utils import env
from .frames import VideoFrame
from .plane import H264RingSource, H264Sink
from .rtcp import ReceiverStats, is_rtcp
from .sockio import CoalescedFlush, DatagramDrain, dup_raw_socket


class NativeRtpClient:
    """Encode/send + receive/decode endpoints against a native-rtp agent."""

    def __init__(self, width: int, height: int, fps: int = 30,
                 use_h264: bool | None = None, rcvbuf: int | None = None):
        self.width, self.height, self.fps = width, height, fps
        self._use_h264 = use_h264
        self._rcvbuf = rcvbuf
        self.rx_stats = ReceiverStats()  # the downlink's RTP, as received
        # bounded downlink packet queue (resilience/overload.py): a slow
        # drain sheds the OLDEST packets instead of building unbounded
        # latency; sheds are counted on the queue (freshest-frame-wins at
        # packet granularity — no deadline here, since dropping individual
        # late fragments would corrupt the AUs their siblings complete)
        self._recv_q = DeadlineQueue(
            bound=env.get_int("OVERLOAD_RX_QUEUE_BOUND", 512)
        )
        self._recv_tr = None
        self._recv_raw = None  # dup'd fd of the receive socket (the drain's)
        self._send_tr = None
        self.sink: H264Sink | None = None
        self.back: H264RingSource | None = None
        self._out = CoalescedFlush()  # per-frame coalesced uplink flush
        # chaos hooks (resilience/faults.py): impair this client's uplink
        # ("tx") and downlink ("rx") when a fault plan is active; both are
        # None — one is-None test per packet — otherwise
        self._tx_faults = _faults.scope("tx")
        self._rx_faults = _faults.scope("rx")

    async def open(self) -> "NativeRtpClient":
        loop = asyncio.get_event_loop()
        q = self._recv_q
        drain = DatagramDrain() if env.get_bool("HOST_PLANE_RX_BATCH", True) else None
        client = self

        def pooled(view, _addr):
            q.push(bytes(view))  # the pool slot is reused: keep a copy

        class _Recv(asyncio.DatagramProtocol):
            def datagram_received(self, data, addr):
                q.push(data)
                if drain is not None and client._recv_raw is not None:
                    drain.drain(client._recv_raw, pooled)

        self._recv_tr, _ = await loop.create_datagram_endpoint(
            _Recv, local_addr=("0.0.0.0", 0)
        )
        sock = self._recv_tr.get_extra_info("socket")
        if drain is not None:
            self._recv_raw = dup_raw_socket(sock)
        if self._rcvbuf:
            try:  # past net.core.rmem_max where the process may
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUFFORCE, self._rcvbuf)
            except (OSError, AttributeError):
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, self._rcvbuf)
        self.back = H264RingSource(
            self.width, self.height, use_h264=self._use_h264
        )
        return self

    @property
    def port(self) -> int:
        return self._recv_tr.get_extra_info("sockname")[1]

    @property
    def rcvbuf_bytes(self) -> int:
        """The receive buffer the kernel granted (SO_RCVBUF as read back)."""
        sock = self._recv_tr.get_extra_info("socket")
        return sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)

    def offer_envelope(self) -> str:
        """The JSON-envelope offer body for this client's geometry/port."""
        return json.dumps(
            {
                "native_rtp": True, "video": True,
                "width": self.width, "height": self.height,
                "client_addr": ["127.0.0.1", self.port],
            }
        )

    async def connect(self, server_port: int, host: str = "127.0.0.1"):
        loop = asyncio.get_event_loop()
        self._send_tr, _ = await loop.create_datagram_endpoint(
            asyncio.DatagramProtocol, remote_addr=(host, server_port)
        )
        self._out.bind(self._send_tr)
        self.sink = H264Sink(
            self.width, self.height, fps=self.fps, use_h264=self._use_h264
        )

    def send(self, arr_u8: np.ndarray, index: int):
        frame = VideoFrame.from_ndarray(np.ascontiguousarray(arr_u8))
        frame.pts = index * (90_000 // self.fps)
        pkts = self.sink.consume(frame)
        if not pkts:
            return
        if self._tx_faults is None:
            self._flush(pkts)
            return
        # chaos path: apply per-packet faults, but pace at FRAME
        # granularity — delayed survivors ride ONE timer per frame (at
        # the latest injected delay) instead of one call_later per
        # fragment; copies stabilize pooled views
        # across the timer hop
        immediate, delayed, due = [], [], 0.0
        for pkt in pkts:
            # the injector can HOLD a packet across calls (reorder fault)
            # — pooled views must be stabilized before they reach it
            if not isinstance(pkt, (bytes, bytearray)):
                pkt = bytes(pkt)
            for d, delay in self._tx_faults.apply(pkt):
                if delay > 0:
                    delayed.append(bytes(d))
                    due = max(due, delay)
                else:
                    immediate.append(d)
        self._flush(immediate)
        if delayed:
            asyncio.get_event_loop().call_later(due, self._flush, delayed)

    async def send_paced(self, arr_u8: np.ndarray, index: int, burst: int = 16,
                         gap_s: float = 0.0) -> int:
        """:meth:`send` through a sender pacer: the frame's packets in
        bursts of ``burst``.  ``gap_s`` 0: the event loop is served between
        bursts (an agent sharing this loop drains its socket there);
        otherwise the frame is encoded and sent from a worker thread, its
        bursts ``gap_s`` apart (sub-millisecond sleeps the loop's timer
        cannot give).  -> packets sent.  No fault injection on this path."""
        frame = VideoFrame.from_ndarray(np.ascontiguousarray(arr_u8))
        frame.pts = index * (90_000 // self.fps)
        if gap_s > 0:
            return await asyncio.to_thread(self._send_spread, frame, burst, gap_s)
        pkts = self.sink.consume(frame)
        for i in range(0, len(pkts), burst):
            self._flush(pkts[i:i + burst])
            await asyncio.sleep(0)
        return len(pkts)

    def _send_spread(self, frame, burst: int, gap_s: float) -> int:
        pkts = self.sink.consume(frame)
        for i in range(0, len(pkts), burst):
            if i:
                time.sleep(gap_s)
            self._flush(pkts[i:i + burst])
        return len(pkts)

    def _flush(self, pkts):
        """One coalesced flush of a frame's packets on the connected send
        socket (sendmmsg when available, sendto loop otherwise)."""
        self._out.flush(pkts)

    def drain(self, on_frame=None) -> int:
        """Feed every queued packet, polling decoded frames AFTER EACH feed
        (latest-wins ring: batch-feeding would evict).  ``on_frame(frame,
        pts)`` gets each decoded frame.  -> frames received."""
        got = 0

        def poll_all():
            nonlocal got
            while (item := self.back.poll()) is not None:
                got += 1
                if on_frame is not None:
                    on_frame(*item)

        while True:
            entry = self._recv_q.pop()
            if entry is None:
                break
            data, _stamp = entry
            if self._rx_faults is not None:
                # downlink impairment: delays collapse to reorder here (the
                # drain is synchronous — schedule-late == deliver-late)
                for d, _delay in self._rx_faults.apply(data):
                    self.back.feed_packet(d)
                    poll_all()
                continue
            if not is_rtcp(data):
                self.rx_stats.received(data)
            self.back.feed_packet(data)
            poll_all()
        poll_all()
        return got

    def close(self):
        for c in (self.sink, self.back):
            if c is not None:
                c.close()
        self._out.close()
        if self._recv_raw is not None:
            self._recv_raw.close()
            self._recv_raw = None
        for t in (self._send_tr, self._recv_tr):
            if t is not None:
                t.close()
