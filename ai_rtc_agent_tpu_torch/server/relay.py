"""Media relay: one processed track, many subscribers (counterpart of
ai_rtc_agent_tpu/server/relay.py).

Without a relay, every viewer's sender loop would call ``recv()`` on the
same track concurrently (corrupting its frames-in-flight state) and each
frame would reach exactly one viewer.  ``TrackRelay`` runs one pump task
that pulls the source once per frame and fans it out to per-subscriber
latest-wins queues: a slow viewer drops frames instead of building latency
or stalling the others.
"""

from __future__ import annotations

import asyncio
import logging
import time

logger = logging.getLogger(__name__)


class RelayedTrack:
    """Track-like view for one subscriber."""

    kind = "video"

    def __init__(self, relay: "TrackRelay", maxsize: int = 2):
        self._relay = relay
        self._q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self._ended = False

    def _push(self, frame):
        if self._ended:
            return
        try:
            self._q.put_nowait(frame)
        except asyncio.QueueFull:
            # latest-wins: drop the stalest frame, counted on the relay's
            # aggregate stats (never per viewer)
            if self._relay.stats is not None:
                self._relay.stats.count("broadcast_viewer_drops")
            try:
                self._q.get_nowait()
            except asyncio.QueueEmpty:
                pass
            try:
                self._q.put_nowait(frame)
            except asyncio.QueueFull:
                pass

    async def recv(self):
        if self._ended and self._q.empty():
            raise ConnectionError("relay ended")
        frame = await self._q.get()
        if frame is None:
            raise ConnectionError("relay ended")
        stats = self._relay.stats
        if stats is not None:
            wall = getattr(frame, "wall_ts", None)
            if wall is not None:
                # freshness: decode-stamp age when a subscriber takes delivery
                stats.record_stage("broadcast_freshness", time.monotonic() - wall)
        return frame

    def stop(self):
        self._ended = True
        self._relay._unsubscribe(self)

    def on(self, event: str, f=None):  # event-surface parity for providers
        def register(fn):
            return fn

        return register(f) if f else register


class TrackRelay:
    """Fan one source track out to any number of subscribers."""

    def __init__(self, source, stats=None):
        """``stats``: optional FrameStats shared by all subscribers — drop
        counts and freshness land here in aggregate."""
        self.source = source
        self.stats = stats
        self._subs: list[RelayedTrack] = []
        self._task: asyncio.Task | None = None

    def subscribe(self, maxsize: int = 2) -> RelayedTrack:
        sub = RelayedTrack(self, maxsize=maxsize)
        self._subs.append(sub)
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._pump())
        return sub

    def _unsubscribe(self, sub: RelayedTrack):
        if sub in self._subs:
            self._subs.remove(sub)

    async def _pump(self):
        try:
            while self._subs:
                frame = await self.source.recv()
                for sub in list(self._subs):
                    sub._push(frame)
        except ConnectionError:  # the source ended
            pass
        except Exception:
            logger.exception("relay pump failed")
        finally:
            for sub in list(self._subs):
                sub._push(None)

    def stop(self):
        if self._task:
            self._task.cancel()
        for sub in list(self._subs):
            sub._ended = True
        self._subs.clear()
