"""Per-frame lifecycle tracing: span timelines for the media path (the
port's copy of ai_rtc_agent_tpu/obs/trace.py; it imports nothing of the
JAX package).

Each frame gets a :class:`FrameTrace`: a frame id (minted at decode on the
native tier, at the track's ingest hop otherwise) plus monotonic span
stamps from every hop of the pipeline:

    decode → ingest → submit → batch_join → engine_step → fetch →
    postprocess → encode → packetize → protect → send

and a **terminal marker** for how the frame left the pipeline: ``sent``
(reached the wire), ``shed`` (freshest-frame-wins or deadline eviction,
resilience/overload.py), ``passthrough`` (engine bypassed, source pixels
delivered) or ``dropped``.  Completed timelines land in a bounded
per-session ring (:class:`SessionTracer`) that the flight recorder
(obs/recorder.py) snapshots and obs/export.py renders as Chrome
trace-event JSON.

* Off, a hop pays one attribute read at the mint site
  (``controller.enabled``) and one ``getattr(frame, "trace", None)`` per
  downstream hop (:func:`get_trace`): no allocation, lock or clock read.
* On, a trace is one ``__slots__`` object and two lists; the only shared
  structure is the completed-timeline ring (a bounded ``deque``).
* Every clock read is on the host, outside the captured CUDA graphs: a
  replay returns at once, so ``engine_step`` ends where the host resolves
  the step's readback, never at the launch.
* Every stamp in obs/ is read through :func:`clock` (``time.monotonic``,
  the clock the media path and the batch scheduler stamp with too), and a
  :class:`ClockMap` taken when a device profiler window opens carries that
  clock onto the profiler's time base, so host spans and device records
  share one timeline (obs/export.py's bridge, the benchmark's profiler).

Work that belongs to no single frame (the batch scheduler's dispatcher:
why it held, each bucket step's dispatch, the snapshot bank, each step's
first readback resolve) lands in a :class:`StepTracer`, one bounded ring
per process, gated by the same :class:`TraceController`.

Knobs: ``TRACE_ENABLE``, ``TRACE_RING_FRAMES``, ``TRACE_MAX_CAPTURE_S``.
"""

from __future__ import annotations

import collections
import threading
import time

from ..utils import env

# span taxonomy: one Perfetto track per stage (obs/export.py assigns one
# tid per name)
STAGES = (
    "decode",       # H.264 AU -> pixels (media/plane.py, native tier)
    "ingest",       # decode-complete -> admitted into the pipeline (queue wait)
    "submit",       # host preprocess + device dispatch
    "batch_join",   # batch-scheduler coalescing window: enqueue -> the
                    # cross-session batch step this frame rode dispatched
    "engine_step",  # dispatch-complete -> result resolved (device residency)
    "fetch",        # the blocking host-side resolve (readback tail)
    "postprocess",  # output wrap + timing metadata
    "encode",       # pixels -> H.264 AU
    "packetize",    # AU -> RTP packets
    "protect",      # SRTP protect_frame
    "send",         # socket flush
)

# terminal markers — how a frame left the pipeline
TERMINAL_SENT = "sent"
TERMINAL_SHED = "shed"
TERMINAL_PASSTHROUGH = "passthrough"
TERMINAL_DROPPED = "dropped"
TERMINALS = (
    TERMINAL_SENT, TERMINAL_SHED, TERMINAL_PASSTHROUGH, TERMINAL_DROPPED,
)

# the batch scheduler's dispatcher (stream/scheduler.py) on the StepTracer:
# each wait stamped with its reason, then the step's own host work
HOLD_REASONS = (
    "empty",       # no frame queued
    "window",      # frames queued, the coalescing window still running
    "depth",       # PIPELINE_DEPTH steps in flight (unresolved)
    "quarantine",  # the engine guard holds the plane
    "step_lock",   # batch popped, waiting for the step lock
)
STEP_RING = 8192  # StepTracer entries kept (a dispatcher turn stamps 2-6)


def clock() -> float:
    """THE host clock of every obs stamp: ``time.monotonic`` (looked up at
    each call, so a test's fake clock reaches it)."""
    return time.monotonic()


class ClockMap:
    """:func:`clock` onto a device profiler's time base.

    ``host_ns``/``wall_ns``: one paired read of the monotonic clock and the
    wall clock (``time.time_ns``), taken when a profiler window opens
    (:meth:`read`); ``base_ns``: the profiler's own zero on the wall clock
    (torch.profiler's ``trace_start_ns`` for its events, a Chrome trace's
    ``baseTimeNanoseconds`` for its ``ts``), bound once known.  The
    profiler stamps host and device records on the wall clock in ns (kineto
    converts the card's timestamps to it), so a host stamp ``t`` (s) lands
    at ``t * 1e9 - host_ns + wall_ns`` there, ``base_ns`` less on its time
    base.  The pair drifts apart only by the wall clock's slew over a
    window (NTP slews at most 0.05%)."""

    __slots__ = ("host_ns", "wall_ns", "base_ns")

    def __init__(self, host_ns: int, wall_ns: int, base_ns: int = 0):
        self.host_ns, self.wall_ns, self.base_ns = int(host_ns), int(wall_ns), int(base_ns)

    @classmethod
    def read(cls) -> "ClockMap":
        """The tightest of five wall reads bracketed by two monotonic reads
        (the bracket's midpoint is the pair's host time)."""
        best = None
        for _ in range(5):
            a = time.monotonic_ns()
            w = time.time_ns()
            b = time.monotonic_ns()
            if best is None or b - a < best[0]:
                best = (b - a, (a + b) // 2, w)
        return cls(best[1], best[2])

    def bind(self, base_ns: int) -> "ClockMap":
        """The same pair against another profiler zero."""
        return ClockMap(self.host_ns, self.wall_ns, base_ns)

    def to_device_us(self, t: float) -> float:
        """Host stamp ``t`` (s, :func:`clock`) on the profiler's time base
        (us from ``base_ns``).  The two ~1e18 ns wall readings are
        subtracted as integers first: a float there is 256 ns coarse."""
        return ((t * 1e9 - self.host_ns) + (self.wall_ns - self.base_ns)) / 1e3


def profiler_base_ns(prof) -> int | None:
    """The zero of a stopped ``torch.profiler.profile``'s event times
    (``FunctionEvent.time_range`` is us from it) on the wall clock, or None
    when it has no results."""
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    return None if results is None else int(results.trace_start_ns())


def safe_list(dq) -> list:
    """Copy a deque that other threads may be appending to.  CPython
    raises ``RuntimeError`` when a deque mutates mid-iteration, and the
    appenders (frame hops on worker threads, the supervisor thread) are
    deliberately lock-free — so the READER retries.  An append every
    ~33 ms vs a µs-scale copy of ≤256 entries means one retry is already
    rare; 64 attempts is unreachable in practice, and the empty-list
    fallback keeps the incident path (snapshot-at-DEGRADED) from ever
    raising."""
    for _ in range(64):
        try:
            return list(dq)
        except RuntimeError:  # appender won the race — copy again
            continue
    return []


def get_trace(frame):
    """The :class:`FrameTrace` riding ``frame``, or None — THE hot-path
    accessor every hop guards on.  Bare ndarrays (device fast path) and
    foreign frame types simply return None, so untraced tiers pay one
    getattr + isinstance per hop and nothing else.  The isinstance is
    load-bearing, not defensive: ``ndarray.trace`` is a real numpy
    method, so a bare getattr would hand hops a bound method to stamp."""
    trace = getattr(frame, "trace", None)
    return trace if type(trace) is FrameTrace else None


class TraceController:
    """Process-wide tracing switch with a bounded capture window.

    ``TRACE_ENABLE=1`` turns tracing on at startup (unbounded — the
    operator asked for it); ``POST /debug/trace`` starts a window bounded
    by ``TRACE_MAX_CAPTURE_S`` that expires lazily at the next mint, so a
    forgotten capture can never keep per-frame allocation on forever.
    """

    __slots__ = ("enabled", "max_capture_s", "_until", "_clock")

    def __init__(self, clock=clock):
        self._clock = clock
        self._until = 0.0  # 0 = no deadline
        self.max_capture_s = env.get_float("TRACE_MAX_CAPTURE_S", 300.0)
        self.enabled = env.get_bool("TRACE_ENABLE", False)

    def start(self, duration_s: float | None = None) -> float:
        """Enable tracing for a bounded window; returns the granted
        duration (requests are clamped to ``TRACE_MAX_CAPTURE_S``)."""
        d = self.max_capture_s
        if duration_s is not None:
            d = max(0.1, min(float(duration_s), self.max_capture_s))
        self._until = self._clock() + d
        self.enabled = True
        return d

    def stop(self):
        self.enabled = False
        self._until = 0.0

    def active(self) -> bool:
        """Hot-path gate: one attribute read when off; when on, the
        capture deadline is checked lazily (and flips ``enabled`` off
        when expired, restoring the one-attr-read fast path)."""
        if not self.enabled:
            return False
        if self._until and self._clock() >= self._until:
            self.enabled = False
            self._until = 0.0
            return False
        return True

    def status(self) -> dict:
        remaining = None
        if self.enabled and self._until:
            remaining = max(0.0, self._until - self._clock())
        return {
            "enabled": self.active(),
            "remaining_s": None if remaining is None else round(remaining, 3),
            "max_capture_s": self.max_capture_s,
        }


class _Span:
    """``with trace.span("encode"):`` — the preferred spelling: the exit
    stamps the span on every path."""

    __slots__ = ("_frame_trace", "_name", "_t0")

    def __init__(self, frame_trace, name):
        self._frame_trace = frame_trace
        self._name = name

    def __enter__(self):
        self._t0 = clock()
        return self

    def __exit__(self, *exc):
        self._frame_trace.add_span(self._name, self._t0, clock())
        return False


class FrameTrace:
    """One frame's hop-by-hop timeline.

    ``spans`` is a list of ``(name, t0, t1)`` monotonic stamps; ``marks``
    a list of ``(name, t)`` instants (similarity skips, sheds, the
    terminal marker).  :meth:`finish` seals the trace with its terminal
    marker and hands it to the owning ring — after that every further
    stamp is a no-op, so a passthrough frame that keeps flowing to the
    encoder cannot grow its (already completed) timeline."""

    __slots__ = (
        "frame_id", "session_id", "born", "spans", "marks", "terminal",
        "step", "_owner", "_open",
    )

    def __init__(self, frame_id, session_id: str = "", owner=None, born=None):
        self.frame_id = frame_id
        self.session_id = session_id
        self.born = clock() if born is None else born
        self.spans: list = []  # (name, t0, t1)
        self.marks: list = []  # (name, t)
        self.terminal: str | None = None
        # the batch scheduler's step id this frame rode (its batch_join and
        # engine_step belong to that step's dispatch on the StepTracer)
        self.step: int | None = None
        self._owner = owner
        self._open: list = []  # begin()/end() stack: (name, t0)

    # -- stamping -------------------------------------------------------------

    def add_span(self, name: str, t0: float, t1: float):
        """Record one completed span (externally timed hops reuse clock
        reads they already took — e.g. decode, whose t0/t1 also feed the
        FrameStats stage gauge)."""
        if self.terminal is None:
            self.spans.append((name, t0, t1))

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def begin(self, name: str, t: float | None = None):
        """Open a span explicitly; every ``begin`` must reach a matching
        :meth:`end` on all paths."""
        self._open.append((name, clock() if t is None else t))

    def end(self, name: str | None = None, t: float | None = None):
        """Close the most recent open span (or the named one)."""
        if not self._open:
            return
        t1 = clock() if t is None else t
        if name is None:
            n, t0 = self._open.pop()
            self.add_span(n, t0, t1)
            return
        for i in range(len(self._open) - 1, -1, -1):
            if self._open[i][0] == name:
                n, t0 = self._open.pop(i)
                self.add_span(n, t0, t1)
                return

    def mark(self, name: str, t: float | None = None):
        if self.terminal is None:
            self.marks.append((name, clock() if t is None else t))

    def span_end(self, name: str) -> float | None:
        """End stamp of the most recent span named ``name`` (lets the
        fetch hop derive engine_step = submit-end → fetch-end)."""
        for n, _t0, t1 in reversed(self.spans):
            if n == name:
                return t1
        return None

    # -- lifecycle ------------------------------------------------------------

    @property
    def done(self) -> bool:
        return self.terminal is not None

    def finish(self, terminal: str = TERMINAL_SENT, t: float | None = None):
        """Seal the timeline with its terminal marker and publish it to
        the session ring.  Idempotent: the first terminal wins (a frame
        shed at ingest must not be re-terminated by a later hop that
        still holds a stale reference)."""
        if self.terminal is not None:
            return
        now = clock() if t is None else t
        while self._open:  # dangling begins close at the terminal stamp
            n, t0 = self._open.pop()
            self.spans.append((n, t0, now))
        self.marks.append((f"terminal:{terminal}", now))
        self.terminal = terminal
        owner = self._owner
        if owner is not None:
            owner.complete(self)

    def to_dict(self) -> dict:
        # lists, not tuples: snapshots must survive a JSON round-trip
        # unchanged (the /debug/flight body IS the stored capture)
        out = {
            "frame_id": self.frame_id,
            "session": self.session_id,
            "born": round(self.born, 6),
            "terminal": self.terminal,
            "spans": [
                [n, round(t0, 6), round(t1, 6)] for n, t0, t1 in self.spans
            ],
            "marks": [[n, round(t, 6)] for n, t in self.marks],
        }
        if self.step is not None:
            out["step"] = self.step
        return out


class SessionTracer:
    """Per-session trace minting + the bounded ring of completed frame
    timelines (``TRACE_RING_FRAMES``, oldest-evicted — the flight
    recorder's frame-level black box)."""

    def __init__(
        self,
        session_id: str,
        controller: TraceController,
        ring_frames: int | None = None,
        slo=None,
    ):
        self.session_id = session_id
        self.controller = controller
        # SLO plane (obs/slo.py): when enabled, timelines mint even with
        # tracing off and every sealed one feeds the stage histograms —
        # the ring is only retained while tracing proper is on
        self.slo = slo
        # fleet journey correlation (``{"journey_id","leg","agent"}``,
        # set via SessionRecorder.set_journey): stamped onto sealed
        # timelines at SNAPSHOT time only — the per-frame hot path never
        # reads it
        self.journey: dict | None = None
        n = (
            env.get_int("TRACE_RING_FRAMES", 256)
            if ring_frames is None
            else ring_frames
        )
        self.ring: collections.deque = collections.deque(maxlen=max(1, n))
        self.frames_completed = 0
        self._seq = 0
        self._lock = threading.Lock()  # mint-seq only; stamping is lock-free

    def mint(self, frame_id=None) -> FrameTrace:
        """A fresh trace (caller attaches it to the frame)."""
        if frame_id is None:
            with self._lock:
                self._seq += 1
                frame_id = self._seq
        return FrameTrace(frame_id, self.session_id, owner=self)

    def attach(self, frame) -> FrameTrace | None:
        """The frame's existing trace, or a freshly minted one bound to
        it — None (and zero allocation) while tracing is off.  Frames
        that cannot carry attributes (bare ndarrays, C-extension frame
        types) also get None: no downstream hop could ever stamp or
        terminate a trace the frame cannot carry, so minting one would
        pay allocation per frame for a timeline that can only leak
        uncompleted."""
        frame_trace = get_trace(frame)  # NOT a bare getattr: ndarray.trace
        if frame_trace is not None:     # is a numpy method, never a trace
            return frame_trace
        controller = self.controller
        # split gate: the off path pays ONE attribute read per plane (the
        # trace switch, then the SLO switch); the (already paying-for-
        # allocation) on path takes the lazy-expiry check
        if not controller.enabled or not controller.active():
            slo = self.slo
            if slo is None or not slo.enabled:
                return None
            # SLO-only mint: the timeline exists to feed the stage
            # histograms at finish(); complete() skips the ring
        frame_trace = self.mint()
        try:
            frame.trace = frame_trace
        except (AttributeError, TypeError):
            return None  # untraceable frame type: this tier stays untraced
        return frame_trace

    def complete(self, frame_trace: FrameTrace):
        slo = self.slo
        if slo is not None:
            # stage histograms + over-budget counters (obs/slo.py);
            # observe() no-ops when the plane is disabled
            slo.observe(self.session_id, frame_trace)
            if not self.controller.enabled:
                # SLO-only mode: aggregation happened, but completed
                # timelines are only RETAINED while tracing is on — the
                # /debug/flight frame ring must reflect capture windows,
                # not the always-on budget bookkeeping
                return
        self.ring.append(frame_trace)  # deque append: atomic, bounded
        self.frames_completed += 1

    def snapshot_frames(self) -> list:
        out = [t.to_dict() for t in safe_list(self.ring)]
        journey = self.journey
        if journey:
            for d in out:
                d["journey_id"] = journey.get("journey_id")
                d["leg"] = journey.get("leg")
        return out


class StepTracer:
    """The process-level span ring: work that belongs to no single frame.

    The batch scheduler's dispatcher stamps into it (stream/scheduler.py):
    ``hold.<reason>`` for each wait (:data:`HOLD_REASONS`), ``dispatch``
    (the step lock held -> the bucket step queued on the device, with the
    step id, bucket ``k``, the riders' ``slots``, the ``variant`` and
    ``warm``; on one device its children ``dispatch.replay`` and
    ``dispatch.readback``), ``bank``, and the instant ``resolve`` (t1 None) when a
    step's first readback row frees its in-flight place.  An entry is
    ``(name, t0, t1, args)`` on :func:`clock`.  Gated by the frame rings'
    :class:`TraceController`: a stamper checks :meth:`on` once a turn and
    builds no entry while it is off; the ring is a bounded deque (appends
    are atomic, no lock)."""

    def __init__(self, controller: TraceController, ring: int | None = None):
        self.controller = controller
        self.ring: collections.deque = collections.deque(
            maxlen=max(1, STEP_RING if ring is None else ring))

    def on(self) -> bool:
        """The gate: one attribute read while tracing is off."""
        controller = self.controller
        return controller.enabled and controller.active()

    def span(self, name: str, t0: float, t1: float, args: dict | None = None):
        self.ring.append((name, t0, t1, args))

    def instant(self, name: str, t: float, args: dict | None = None):
        self.ring.append((name, t, None, args))

    def snapshot(self) -> list:
        """The ring as JSON-safe lists ``[name, t0, t1 or None, args]``."""
        return [[n, round(t0, 6), None if t1 is None else round(t1, 6), a]
                for n, t0, t1, a in safe_list(self.ring)]
