"""The processed media track (counterpart of ai_rtc_agent_tpu/server/tracks.py).

Wraps a source track; every ``recv()`` pulls a frame and returns the
diffused frame.

* WARMUP_FRAMES frames go through the pipeline and are dropped at connect;
  DROP_FRAMES frames are skipped before each output (the OBS stutter
  workaround).
* Every pipeline call runs in a worker thread (``asyncio.to_thread``), so a
  step never stalls the event loop; ``recv()`` calls are serialized per
  track, which keeps the order.
* PIPELINE_DEPTH frames stay in flight through ``submit``/``fetch``:
  ``recv()`` submits the new frame and fetches the one submitted ``depth``
  calls ago, so one frame's step overlaps the previous frame's readback.
  A submit and its fetch may run on different worker threads.
* With ``frame_buffer_size`` > 1 the pipeline's ``submit_batch`` steps fbs
  consecutive frames at once, and the outputs drain one per ``recv()``.

A frame that a bounded queue of the batch scheduler or ``--multipeer``
shed comes back as a ``ShedFrame``; the track delivers its source pixels
(passthrough).  With the overload plane attached, the track is the ingest
hop: a pulled frame older than half of ``OVERLOAD_FRAME_DEADLINE_MS`` is
shed while a fresher one waits behind it (freshest frame wins, counted),
and each admitted frame's age lands in /metrics' freshness reservoir.
Sources that can skip ahead expose ``recv_nowait()`` (the loopback track
does); others never shed here.

With a session tracer (obs/trace.py ``SessionTracer``) the track is also
the ingest hop of a frame's trace: a frame that arrives without one (the
loopback and aiortc tiers; the native tier mints at decode) gets one here,
the ``ingest`` span runs from its decode stamp to its admission, and a
frame shed at ingest is marked ``ingest_shed`` and sealed ``shed``.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque

from ..resilience.overload import ShedFrame
from ..utils import env
from ..utils.dispatch import fire_handler

logger = logging.getLogger(__name__)


class VideoStreamTrack:
    kind = "video"

    def __init__(self, track, pipeline, pipeline_depth: int | None = None, overload=None,
                 tracer=None):
        self.track = track
        self.pipeline = pipeline
        self.overload = overload  # OverloadControlPlane | None
        self.tracer = tracer  # SessionTracer | None: None never touches a trace
        self.warmup_frame_idx = 0
        self.warmup_frames = env.warmup_frames()
        self.drop_frames = env.drop_frames()
        self.pipeline_depth = (
            env.pipeline_depth() if pipeline_depth is None else max(1, pipeline_depth)
        )
        if not hasattr(pipeline, "submit"):
            self.pipeline_depth = 1
        # in flight: at most `pipeline_depth` frames (or fbs batches)
        self._pending: deque = deque(maxlen=self.pipeline_depth)
        # outputs of one fetch_batch, drained one per recv() before the next
        # tpurtc: allow[bounded-queue] -- refilled only when empty (_recv_batched's while loop); holds at most one fetch_batch's fbs outputs (fbs is not known at ctor time)
        self._outbuf: deque = deque()
        self._handlers: dict = {}

    def on(self, event: str, f=None):
        def register(fn):
            self._handlers[event] = fn
            return fn

        return register(f) if f else register

    def stop(self):
        fire_handler(self._handlers.get("ended"))

    @property
    def _fbs(self) -> int:
        return int(getattr(self.pipeline, "frame_buffer_size", 1) or 1)

    @staticmethod
    def _stamp_ingest(trace, frame):
        """The ingest span: decode complete (the wall_ts stamp) -> admitted."""
        now = time.monotonic()
        wall = getattr(frame, "wall_ts", None)
        trace.add_span("ingest", wall if wall is not None else now, now)

    async def _pull_fresh(self):
        """One source frame, freshest wins: while the frame at hand is older
        than half the deadline and the source has a fresher one, shed it and
        take the next.  A stale frame with nothing behind it is delivered
        (a late frame beats a frozen stream)."""
        frame = await self.track.recv()
        tracer = self.tracer
        trace = tracer.attach(frame) if tracer is not None else None
        ov = self.overload
        if ov is None:
            if trace is not None:
                self._stamp_ingest(trace, frame)
            return frame
        recv_nowait = getattr(self.track, "recv_nowait", None)
        if ov.frame_deadline_s and recv_nowait is not None:
            shed = 0
            while ov.frame_age(frame) > ov.frame_deadline_s / 2.0:
                nxt = recv_nowait()
                if nxt is None:
                    break
                if trace is not None:  # the shed frame's timeline ends here
                    trace.mark("ingest_shed")
                    trace.finish("shed")
                frame = nxt
                trace = tracer.attach(frame) if tracer is not None else None
                shed += 1
            if shed:
                ov.note_shed_ingest(shed)
        if trace is not None:
            self._stamp_ingest(trace, frame)
        if getattr(frame, "wall_ts", None) is not None:  # unstamped frames have no age
            ov.note_delivered(ov.frame_age(frame))
        return frame

    async def recv(self):
        fbs = self._fbs
        if fbs > 1 and hasattr(self.pipeline, "submit_batch"):
            return await self._recv_batched(fbs)

        while self.warmup_frame_idx < self.warmup_frames:
            logger.info("dropping warmup frames %d", self.warmup_frame_idx)
            frame = await self.track.recv()
            await asyncio.to_thread(self.pipeline, frame)
            self.warmup_frame_idx += 1

        for _ in range(self.drop_frames):
            await self.track.recv()

        if self.pipeline_depth == 1:
            frame = await self._pull_fresh()
            return _pixels(await asyncio.to_thread(self.pipeline, frame))

        # keep `depth` frames in flight, return the oldest
        while len(self._pending) < self.pipeline_depth:
            frame = await self._pull_fresh()
            handle = await asyncio.to_thread(self.pipeline.submit, frame)
            self._pending.append((frame, handle))
        src, handle = self._pending.popleft()
        return _pixels(await asyncio.to_thread(self.pipeline.fetch, handle, src))

    async def _recv_batched(self, fbs: int):
        async def pull_batch():
            return [await self._pull_fresh() for _ in range(fbs)]

        while self.warmup_frame_idx < self.warmup_frames:
            logger.info("dropping warmup frame batch @%d", self.warmup_frame_idx)
            srcs = await pull_batch()
            h = await asyncio.to_thread(self.pipeline.submit_batch, srcs)
            await asyncio.to_thread(self.pipeline.fetch_batch, h, srcs)
            self.warmup_frame_idx += fbs

        # keep `pipeline_depth` batches in flight, as the single-frame path
        while not self._outbuf:
            for _ in range(self.drop_frames):
                await self.track.recv()
            srcs = await pull_batch()
            self._pending.append((srcs, await asyncio.to_thread(self.pipeline.submit_batch, srcs)))
            if len(self._pending) >= self.pipeline_depth:
                srcs0, h0 = self._pending.popleft()
                outs = await asyncio.to_thread(self.pipeline.fetch_batch, h0, srcs0)
                self._outbuf.extend(_pixels(o) for o in outs)
        return self._outbuf.popleft()


def _pixels(out):
    """A shed frame's source pixels; any other output as it is."""
    return out.frame if isinstance(out, ShedFrame) else out
