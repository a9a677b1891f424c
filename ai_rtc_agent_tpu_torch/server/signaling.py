"""WebRTC providers (counterpart of ai_rtc_agent_tpu/server/signaling.py).

The session layer drives a small peer-connection surface: construction,
``addTransceiver`` + ``setCodecPreferences``, ``on(...)`` event handlers,
``setRemoteDescription``/``createAnswer``/``setLocalDescription``,
``addTrack`` and the private ``__gather()`` that OBS needs.  Three
providers implement it:

* ``AiortcProvider`` — the aiortc stack, imported when the provider is made.
* ``NativeRtpProvider`` (server/rtc_native.py) — the agent's own WebRTC
  tier: real SDP, RTP/RTCP over UDP through the C++ runtime of native/,
  ICE-lite + DTLS-SRTP and SCTP datachannels.
* ``LoopbackProvider`` — in-process: the "SDP" is a JSON envelope, media
  flows through asyncio queues and datachannel messages are delivered
  directly.  It carries the CPU tests and ``chip_smoke.py``'s serve phase.

``get_provider()`` takes ``WEBRTC_PROVIDER`` (aiortc | native-rtp |
loopback) and, unset, picks as the JAX package does: aiortc; without it the
native tier when its C++ runtime loads and ``cryptography`` imports; else
loopback, with a warning.
"""

from __future__ import annotations

import asyncio
import json
import logging
import uuid

from ..utils import env as env_util
from ..utils.dispatch import fire_handler

logger = logging.getLogger(__name__)


class SessionDescription:
    def __init__(self, sdp: str, type: str):
        self.sdp = sdp
        self.type = type


class _Events:
    """``on(event)`` registration, usable as a decorator or a call."""

    def on(self, event: str, f=None):
        def register(fn):
            self._handlers[event] = fn
            return fn

        return register(f) if f else register


async def _maybe_await(x):
    if asyncio.iscoroutine(x):
        await x


class LoopbackTrack(_Events):
    """Pull-model media track fed by an asyncio queue."""

    kind = "video"

    def __init__(self, name: str = "loopback"):
        self.name = name
        self._q: asyncio.Queue = asyncio.Queue(maxsize=16)
        self._ended = asyncio.Event()
        self._handlers: dict = {}

    async def push(self, frame):
        await self._q.put(frame)

    async def recv(self):
        if self._ended.is_set() and self._q.empty():
            raise ConnectionError("track ended")
        return await self._q.get()

    def recv_nowait(self):
        """The next frame without waiting, or None: the overload plane's
        ingest hop (server/tracks.py) skips ahead to a fresher frame with it."""
        try:
            return self._q.get_nowait()
        except asyncio.QueueEmpty:
            return None

    def stop(self):
        self._ended.set()
        fire_handler(self._handlers.get("ended"))


class LoopbackDataChannel(_Events):
    def __init__(self, label="config"):
        self.label = label
        self._handlers: dict = {}

    async def deliver(self, message: str):
        h = self._handlers.get("message")
        if h:
            await _maybe_await(h(message))


class LoopbackPeerConnection(_Events):
    """The RTCPeerConnection surface the session layer drives."""

    def __init__(self, configuration=None):
        self.configuration = configuration
        self.connectionState = "new"
        self.iceConnectionState = "new"
        self.localDescription = None
        self.remoteDescription = None
        self._handlers: dict = {}
        self._transceivers: list = []
        self._senders: list = []
        self.out_tracks: list = []  # tracks the agent sends back to the peer
        self.in_track: LoopbackTrack | None = None
        self.datachannel = LoopbackDataChannel()
        self._gathered = False
        self.pc_id = str(uuid.uuid4())

    async def _emit(self, event: str, *args):
        h = self._handlers.get(event)
        if h:
            await _maybe_await(h(*args))

    def addTransceiver(self, kind: str, direction: str = "sendrecv"):
        tr = type("Transceiver", (), {"kind": kind, "sender": None, "_codecs": None})()

        def setCodecPreferences(codecs):
            tr._codecs = codecs

        tr.setCodecPreferences = setCodecPreferences
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

    async def setRemoteDescription(self, desc: SessionDescription):
        self.remoteDescription = desc
        # loopback "negotiation": the offer may carry an inbound track marker
        payload = _parse_loopback_sdp(desc.sdp)
        if payload.get("video"):
            self.in_track = LoopbackTrack()
            await self._emit("track", self.in_track)
        if payload.get("datachannel"):
            await self._emit("datachannel", self.datachannel)

    async def createAnswer(self):
        return SessionDescription(
            sdp=json.dumps({"loopback": True, "answer_for": self.pc_id}), type="answer"
        )

    async def setLocalDescription(self, desc: SessionDescription):
        self.localDescription = desc
        self.connectionState = "connected"
        self.iceConnectionState = "completed"
        await self._emit("connectionstatechange")

    async def close(self):
        if self.connectionState == "closed":
            return
        self.connectionState = "closed"
        if self.in_track:
            self.in_track.stop()
        await self._emit("connectionstatechange")

    # the session layer calls aiortc's name-mangled gather for OBS; loopback
    # has nothing to gather and records that it was asked
    async def _RTCPeerConnection__gather(self):
        self._gathered = True


def _parse_loopback_sdp(sdp: str) -> dict:
    try:
        d = json.loads(sdp)
        return d if isinstance(d, dict) else {}
    except ValueError:
        # real SDP text: detect a video m-line / datachannel m-line
        return {"video": "m=video" in sdp, "datachannel": "m=application" in sdp}


def make_loopback_offer(video: bool = True, datachannel: bool = True) -> str:
    return json.dumps({"loopback": True, "video": video, "datachannel": datachannel})


class LoopbackProvider:
    name = "loopback"

    def session_description(self, sdp: str, type: str):
        return SessionDescription(sdp, type)

    def peer_connection(self, ice_servers: list[dict] | None = None):
        return LoopbackPeerConnection(configuration=ice_servers)

    def h264_codec_preferences(self, kind: str = "video"):
        return [{"mimeType": "video/H264", "name": "H264"}]

    def force_codec(self, pc, sender, forced_codec: str):
        kind = forced_codec.split("/")[0]
        prefs = [c for c in self.h264_codec_preferences(kind) if c["mimeType"] == forced_codec]
        for t in pc.getTransceivers():
            if t.sender is sender:
                t.setCodecPreferences(prefs)


class AiortcProvider:
    name = "aiortc"

    def __init__(self):
        from aiortc import (
            RTCConfiguration,
            RTCIceServer,
            RTCPeerConnection,
            RTCSessionDescription,
        )
        from aiortc.rtcrtpsender import RTCRtpSender

        self._RTCConfiguration = RTCConfiguration
        self._RTCIceServer = RTCIceServer
        self._RTCPeerConnection = RTCPeerConnection
        self._RTCSessionDescription = RTCSessionDescription
        self._RTCRtpSender = RTCRtpSender

    def session_description(self, sdp: str, type: str):
        return self._RTCSessionDescription(sdp=sdp, type=type)

    def peer_connection(self, ice_servers: list[dict] | None = None):
        if ice_servers:
            cfg = self._RTCConfiguration(iceServers=[self._RTCIceServer(**s) for s in ice_servers])
            return self._RTCPeerConnection(configuration=cfg)
        return self._RTCPeerConnection()

    def h264_codec_preferences(self, kind: str = "video"):
        caps = self._RTCRtpSender.getCapabilities(kind)
        return [c for c in caps.codecs if c.name == "H264"]

    def force_codec(self, pc, sender, forced_codec: str):
        kind = forced_codec.split("/")[0]
        caps = self._RTCRtpSender.getCapabilities(kind)
        transceiver = next(t for t in pc.getTransceivers() if t.sender == sender)
        transceiver.setCodecPreferences([c for c in caps.codecs if c.mimeType == forced_codec])


def get_provider(name: str | None = None):
    name = name or env_util.get_str("WEBRTC_PROVIDER")

    def native():
        from .rtc_native import NativeRtpProvider

        return NativeRtpProvider()

    if name == "loopback":
        return LoopbackProvider()
    if name == "native-rtp":
        return native()
    if name and name != "aiortc":
        # three tiers with different security properties: a typo must not
        # pick another
        raise ValueError(
            f"unknown WEBRTC_PROVIDER {name!r} (expected aiortc | native-rtp | loopback)"
        )
    try:
        return AiortcProvider()
    except ImportError:
        if name == "aiortc":
            raise
        # without aiortc the native tier serves browsers, but only when its
        # C++ runtime loads and its crypto backend imports: otherwise every
        # browser session would die at setup, so a working loopback it is
        from ..media import native as native_rt

        def secure_importable() -> bool:
            try:
                from .secure import SecureMediaSession  # noqa: F401

                return True
            except ImportError:
                return False

        if native_rt.load() is None or not secure_importable():
            logger.warning(
                "aiortc not installed and the native tier's runtime deps "
                "are unavailable — using the loopback provider"
            )
            return LoopbackProvider()
        logger.warning(
            "aiortc not installed — using the native-rtp provider "
            "(in-repo secure WebRTC tier)"
        )
        return native()
