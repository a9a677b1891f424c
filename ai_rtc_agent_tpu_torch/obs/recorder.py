"""Black-box flight recorder: what happened in the seconds before a
session broke (the port's copy of ai_rtc_agent_tpu/obs/recorder.py).

Each session carries two bounded rings:

* the **frame ring**: completed :class:`~.trace.FrameTrace` timelines
  (filled only while tracing is on; obs/trace.py), and
* the **event log**: always-on structured entries for the rare control
  events that explain a degradation afterwards: supervisor transitions,
  overload and network ladder moves, engine restart attempts, webhook
  emissions, SLO breaches and serve-time capture breaches.

On ``StreamDegraded``/``FAILED`` the agent freezes both rings into a
**snapshot** (bounded store, ``FLIGHT_SNAPSHOTS``) whose id rides the
StreamDegraded webhook, so an orchestrator can pull ``GET
/debug/flight?id=<id>`` for the post-mortem, or ``?session=<key>`` for a
live capture, and ``&format=chrome`` for a Perfetto rendering
(obs/export.py).  ``set_journey`` binds a session to a fleet journey; the
port has no fleet yet, so nothing calls it.

Knobs: ``FLIGHT_RECORDER`` (kill switch), ``FLIGHT_EVENTS``,
``FLIGHT_SNAPSHOTS``.
"""

from __future__ import annotations

import collections
import threading

from ..utils import env
from .trace import SessionTracer, StepTracer, TraceController, clock, safe_list


class SessionRecorder:
    """One session's black box: frame-timeline ring + event log."""

    def __init__(
        self,
        session_id: str,
        controller: TraceController,
        clock=clock,
        slo=None,
        steps: StepTracer | None = None,
    ):
        self.session_id = session_id
        self.tracer = SessionTracer(session_id, controller, slo=slo)
        self.steps = steps  # the process's dispatcher ring (FlightRecorder.steps)
        self._clock = clock
        n = env.get_int("FLIGHT_EVENTS", 256)
        self.events: collections.deque = collections.deque(maxlen=max(1, n))
        # fleet journey correlation: rides every snapshot once set
        self.journey: dict | None = None

    def set_journey(self, journey_id: str, leg: int = 1, agent: str = ""):
        """Bind this session to its fleet journey — every snapshot,
        sealed timeline (via the tracer) and black-box capture carries
        the id from here on, and the event log records the leg start so
        a merged bundle shows where each process picked the session up."""
        meta = {"journey_id": journey_id, "leg": int(leg), "agent": agent}
        self.journey = meta
        self.tracer.journey = meta
        self.event("journey", **meta)

    def event(self, kind: str, **data):
        """One structured entry.  Always on (the black box must be
        recording *before* the incident); safe from any thread (bounded
        deque append)."""
        entry = {"t": round(self._clock(), 6), "kind": kind}
        entry.update(data)
        self.events.append(entry)

    def recent_events(self, n: int = 8) -> list:
        return safe_list(self.events)[-n:]

    def snapshot(self, reason: str = "on-demand") -> dict:
        """Freeze both rings into a plain-dict capture (json-safe).
        Reads race lock-free appenders — safe_list retries, so the
        snapshot-at-DEGRADED path can never raise mid-incident.  The
        dispatcher's entries from the first frame's birth on ride along as
        ``steps`` (obs/trace.py ``StepTracer``; left out when there are
        none)."""
        frames = self.tracer.snapshot_frames()
        out = {
            "session": self.session_id,
            "reason": reason,
            "taken_at": round(self._clock(), 6),
            "journey": self.journey,
            "events": safe_list(self.events),
            "frames": frames,
        }
        if self.steps is not None and frames and self.steps.ring:
            t0 = min(fr["born"] for fr in frames)
            steps = [e for e in self.steps.snapshot() if (e[2] or e[1]) >= t0]
            if steps:
                out["steps"] = steps
        return out


class FlightRecorder:
    """Process-global registry of session recorders + the bounded
    snapshot store.  Owns the one :class:`TraceController` every session
    tracer shares, and the process's dispatcher ring (``steps``, which the
    agent hands its batch scheduler), so ``/debug/trace`` start/stop flips
    the whole process at once."""

    def __init__(self, stats=None, clock=clock, slo=None):
        self.controller = TraceController(clock=clock)
        self.steps = StepTracer(self.controller)
        self.stats = stats  # FrameStats: snapshots count as flight_snapshots_total
        self.slo = slo  # SloPlane (obs/slo.py): every session tracer feeds it
        self._clock = clock
        self.sessions: dict = {}
        n = env.get_int("FLIGHT_SNAPSHOTS", 8)
        self.snapshots: collections.deque = collections.deque(maxlen=max(1, n))
        self._snap_seq = 0
        self._lock = threading.Lock()

    # -- session registry -----------------------------------------------------

    def register(self, session_id: str) -> SessionRecorder:
        """Get-or-create (idempotent: the supervisor wrap and the track
        wiring both register, whichever runs first wins)."""
        rec = self.sessions.get(session_id)
        if rec is None:
            rec = SessionRecorder(
                session_id, self.controller, self._clock, slo=self.slo,
                steps=self.steps,
            )
            self.sessions[session_id] = rec
        return rec

    def unregister(self, session_id: str):
        """Session teardown.  Stored snapshots survive — that is the
        point of a black box.  The SLO plane's per-session burn state
        goes with the session (aggregate histograms keep the history)."""
        self.sessions.pop(session_id, None)
        if self.slo is not None:
            self.slo.unregister(session_id)

    def session(self, session_id: str) -> SessionRecorder | None:
        return self.sessions.get(session_id)

    # -- snapshots ------------------------------------------------------------

    def take_snapshot(self, session_id: str, reason: str = "on-demand"):
        """Freeze a session's rings into the bounded store; -> snapshot id
        (or None for an unknown session)."""
        rec = self.sessions.get(session_id)
        if rec is None:
            return None
        with self._lock:
            self._snap_seq += 1
            snap_id = f"flt-{self._snap_seq}"
        snap = rec.snapshot(reason)
        snap["id"] = snap_id
        self.snapshots.append(snap)
        if self.stats is not None:
            self.stats.count("flight_snapshots")
        return snap_id

    def get_snapshot(self, snap_id: str) -> dict | None:
        for snap in reversed(safe_list(self.snapshots)):
            if snap.get("id") == snap_id:
                return snap
        return None

    def index(self) -> dict:
        """The ``GET /debug/flight`` (no args) directory listing."""
        return {
            "trace": self.controller.status(),
            "sessions": sorted(self.sessions),
            "snapshots": [
                {
                    "id": s["id"],
                    "session": s["session"],
                    "reason": s["reason"],
                    "taken_at": s["taken_at"],
                    "journey_id": (s.get("journey") or {}).get("journey_id"),
                    "frames": len(s["frames"]),
                    "events": len(s["events"]),
                }
                for s in safe_list(self.snapshots)
            ],
        }
