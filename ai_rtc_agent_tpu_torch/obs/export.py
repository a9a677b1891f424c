"""Render flight-recorder captures as Chrome trace-event JSON and JSONL,
and the torch.profiler bridge (the port's copy of
ai_rtc_agent_tpu/obs/export.py).

``to_chrome_trace`` turns a snapshot (obs/recorder.py) into the Trace
Event Format that Perfetto and ``chrome://tracing`` load:

* one *process* per capture (named after the session, and stamped with
  its journey, agent and leg when bound to one; :func:`merge_chrome_traces`
  renders each source under its own pid),
* one *track* (tid) per pipeline stage (obs/trace.py ``STAGES``); spans
  that overlap within a stage (several frames in flight) spill onto
  ``<stage> #2``-style lanes so every track stays disjoint,
* instant events for the frames' marks (``terminal:shed`` ...) on a
  ``lifecycle`` track and for the event log's entries on an ``events``
  track,
* with the batch scheduler's entries in the capture (``steps``; obs/trace.py
  ``StepTracer``), a ``dispatcher`` track: its holds, dispatches and banks,
  and each step's ``resolve`` instant; a frame's ``batch_join`` and
  ``engine_step`` carry the ``step`` id of the dispatch that carried them.

Time base: without a ``clock`` the capture is rebased to its earliest
stamp; with one (an obs/trace.py ``ClockMap`` bound to a profiler Chrome
trace's ``baseTimeNanoseconds``) every ``ts`` is on that trace's time base,
so the two files line up (:func:`merge_profiler_trace` puts them in one).

``to_jsonl`` is the grep-friendly rendering: one JSON object per line
(header, then events, then frame timelines).

The profiler bridge is the port's counterpart of the JAX package's
``jax.profiler`` bridge: :func:`start_profiler_bridge` opens
``torch.profiler.profile(activities=[CPU, CUDA])`` over the same window as
the host-side capture, and :func:`stop_profiler_bridge` closes it and
writes its Chrome trace into the directory the caller named.  At the open
it reads a :class:`~.trace.ClockMap`; at the close it binds it to the
written trace's base (``last_clock``), so a capture rendered with it, or
merged into the trace, lines up the card's kernels (those inside CUDA
graph replays too) with the frame timeline over one incident.  The
profiler runs on a thread of its own, which starts and stops it: its CPU-op recording is per thread, and
its device activity (CUPTI) covers every thread's launches.  On the wire
the names stay the JAX agent's: ``POST /debug/trace`` takes
``jax_profiler_dir`` and answers ``jax_profiler``.  A bridge that fails is
answered with its error, never a silent skip.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time

from .trace import STAGES, ClockMap

# tid layout: events/lifecycle low, then 16 reserved lanes per taxonomy
# stage; unknown stages and lane spill past 16 allocate unique tids from
# the region above _DYNAMIC_BASE (never shared — tracks must stay disjoint)
_EVENTS_TID = 1
_LIFECYCLE_TID = 2
_DISPATCHER_TID = 3
_CAPTURE_PID = 1 << 30  # a capture merged into a profiler trace (whose pids are processes')
_STEP_SPANS = ("batch_join", "engine_step")  # args carry the frame's step id
_STAGE_BASE = {name: 16 * (i + 1) for i, name in enumerate(STAGES)}
_MAX_LANES = 15
_DYNAMIC_BASE = 16 * (len(STAGES) + 1)


def _lane_out(spans):
    """Greedy interval-lane assignment: spans (t0, t1, payload) sorted by
    t0 go to the first lane whose previous span already ended — tracks
    come out disjoint, which is what keeps the rendering honest."""
    lanes: list = []  # lane -> last end
    out = []
    for t0, t1, payload in sorted(spans, key=lambda s: (s[0], s[1])):
        for i, end in enumerate(lanes):
            if t0 >= end:
                lanes[i] = t1
                out.append((i, t0, t1, payload))
                break
        else:
            lanes.append(t1)
            out.append((len(lanes) - 1, t0, t1, payload))
    return out, len(lanes)


def to_chrome_trace(snapshot: dict, pid: int = 1,
                    meta: dict | None = None, clock: ClockMap | None = None) -> dict:
    """Snapshot -> ``{"traceEvents": [...]}`` (Perfetto-loadable).

    ``pid``/``meta`` serve the multi-source merge
    (:func:`merge_chrome_traces`): each source renders under its own
    process id, and the journey/agent/leg metadata
    (``{"journey_id", "agent", "leg"}`` — defaulting to the snapshot's
    own ``journey`` binding) is stamped into the process-name metadata
    event and every span/instant's ``args`` so merged multi-agent
    exports stay distinguishable inside Perfetto.  ``clock``: every ``ts``
    on that profiler trace's time base instead of the capture's own."""
    session = snapshot.get("session", "?")
    if meta is None:
        meta = snapshot.get("journey") or None
    proc_name = f"session {session}"
    stamp: dict = {}
    if meta:
        stamp = {
            k: v for k, v in (
                ("journey_id", meta.get("journey_id")),
                ("agent", meta.get("agent")),
                ("leg", meta.get("leg")),
            ) if v not in (None, "")
        }
        label = " ".join(
            f"{k.replace('_id', '')} {v}" for k, v in stamp.items()
        )
        if label:
            proc_name = f"{label} session {session}"
    events: list = [
        {
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": proc_name, **stamp},
        },
        {
            "ph": "M", "name": "thread_name", "pid": pid, "tid": _EVENTS_TID,
            "args": {"name": "events"},
        },
        {
            "ph": "M", "name": "thread_name", "pid": pid,
            "tid": _LIFECYCLE_TID, "args": {"name": "lifecycle"},
        },
    ]

    frames = snapshot.get("frames", [])
    log = snapshot.get("events", [])
    # common time base: ts starts near 0 so the viewport opens on the data
    t_min = None
    for fr in frames:
        for _n, t0, _t1 in fr.get("spans", []):
            t_min = t0 if t_min is None else min(t_min, t0)
        for _n, t in fr.get("marks", []):
            t_min = t if t_min is None else min(t_min, t)
    for ev in log:
        t = ev.get("t")
        if t is not None:
            t_min = t if t_min is None else min(t_min, t)
    base = t_min or 0.0

    def us(t: float) -> float:
        if clock is not None:
            return round(clock.to_device_us(t), 1)
        return round(1e6 * (t - base), 1)

    # spans, one track per stage (+ overflow lanes for in-flight overlap)
    per_stage: dict = {}
    for fr in frames:
        fid = fr.get("frame_id")
        for name, t0, t1 in fr.get("spans", []):
            per_stage.setdefault(name, []).append((t0, t1, fid))
    # unknown stages + lane spill past the 16 reserved per-stage tids
    # draw UNIQUE tids from here — folding spill onto one shared tid
    # would render overlapping X events, exactly the malformed track the
    # export tests forbid
    dyn_next = [_DYNAMIC_BASE]

    def _alloc_dynamic() -> int:
        tid = dyn_next[0]
        dyn_next[0] += 1
        return tid

    steps_of = {fr.get("frame_id"): fr["step"] for fr in frames if "step" in fr}
    for stage in sorted(per_stage):
        spans = per_stage[stage]
        tid_base = _STAGE_BASE.get(stage)
        laned, n_lanes = _lane_out(spans)
        lane_tid = {}
        for lane in range(n_lanes):
            if tid_base is not None and lane <= _MAX_LANES:
                lane_tid[lane] = tid_base + lane
            else:  # unknown stage, or in-flight overlap deeper than 16
                lane_tid[lane] = _alloc_dynamic()
            label = stage if lane == 0 else f"{stage} #{lane + 1}"
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": lane_tid[lane], "args": {"name": label},
            })
        for lane, t0, t1, fid in laned:
            args = {"frame_id": fid, **stamp}
            if stage in _STEP_SPANS and fid in steps_of:
                args["step"] = steps_of[fid]
            events.append({
                "ph": "X", "name": stage, "cat": "frame", "pid": pid,
                "tid": lane_tid[lane],
                "ts": us(t0), "dur": max(0.0, round(1e6 * (t1 - t0), 1)),
                "args": args,
            })

    # the batch scheduler's dispatcher: one thread, so one disjoint track
    steps = snapshot.get("steps") or []
    if steps:
        events.append({
            "ph": "M", "name": "thread_name", "pid": pid,
            "tid": _DISPATCHER_TID, "args": {"name": "dispatcher"},
        })
    for name, t0, t1, args in steps:
        ev = {"name": name, "cat": "dispatcher", "pid": pid, "tid": _DISPATCHER_TID,
              "ts": us(t0), "args": {**(args or {}), **stamp}}
        if t1 is None:
            ev.update(ph="i", s="t")
        else:
            ev.update(ph="X", dur=max(0.0, round(1e6 * (t1 - t0), 1)))
        events.append(ev)

    # frame marks (terminal markers, similarity skips, ingest sheds)
    for fr in frames:
        fid = fr.get("frame_id")
        for name, t in fr.get("marks", []):
            events.append({
                "ph": "i", "s": "t", "name": name, "cat": "lifecycle",
                "pid": pid, "tid": _LIFECYCLE_TID, "ts": us(t),
                "args": {"frame_id": fid, "terminal": fr.get("terminal"),
                         **stamp},
            })

    # event log (supervisor/overload/restart/webhook) as instants
    for ev in log:
        ev = dict(ev)
        t = ev.pop("t", base)
        kind = ev.pop("kind", "event")
        events.append({
            "ph": "i", "s": "p", "name": kind, "cat": "resilience",
            "pid": pid, "tid": _EVENTS_TID, "ts": us(t),
            "args": {**ev, **stamp},
        })

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "session": session,
            "reason": snapshot.get("reason"),
            "snapshot_id": snapshot.get("id"),
            **stamp,
        },
    }


def merge_chrome_traces(sources, journey: str | None = None) -> dict:
    """Merge several flight-recorder captures — typically one per leg of
    a fleet journey, pulled from different agent processes — into ONE
    Perfetto-loadable document.

    ``sources``: iterable of ``(snapshot, meta)`` where ``meta`` is the
    ``{"journey_id", "agent", "leg"}`` stamp (falls back to the
    snapshot's own ``journey`` binding).  Each source renders under its
    own process id, so two agents' identically-named stage tracks can
    never collide; within a source the per-stage lane discipline of
    :func:`to_chrome_trace` holds unchanged.

    Time bases are per-source: every process's monotonic clock is
    normalized to start near 0 (cross-host clocks do not line up; the
    journey ring's wall-clock stamps in the JSON bundle give the
    absolute ordering)."""
    events: list = []
    rendered = []
    for i, (snapshot, meta) in enumerate(sources):
        doc = to_chrome_trace(snapshot, pid=i + 1, meta=meta)
        events.extend(doc["traceEvents"])
        rendered.append({
            "pid": i + 1,
            "session": snapshot.get("session"),
            "agent": (meta or {}).get("agent"),
            "leg": (meta or {}).get("leg"),
            "snapshot_id": snapshot.get("id"),
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "journey_id": journey,
            "sources": rendered,
        },
    }


def merge_profiler_trace(snapshot: dict, profiler_doc: dict, clock: ClockMap) -> dict:
    """One Perfetto document: a profiler window's Chrome trace
    (``profiler_doc``, as the bridge wrote it) with ``snapshot`` rendered
    onto its time base under a pid of its own.  ``clock``: the window's
    ClockMap (``last_clock`` after the bridge closes); it is bound here to the
    document's own ``baseTimeNanoseconds`` (0 when it has none, which means
    absolute times)."""
    clock = clock.bind(int(profiler_doc.get("baseTimeNanoseconds", 0)))
    frames = to_chrome_trace(snapshot, pid=_CAPTURE_PID, clock=clock)
    out = dict(profiler_doc)
    out["traceEvents"] = list(profiler_doc.get("traceEvents", [])) + frames["traceEvents"]
    return out


def to_jsonl(snapshot: dict) -> str:
    """One JSON object per line: header, event-log entries, frame
    timelines — the grep/jq-friendly rendering of the same capture."""
    lines = [json.dumps({
        "record": "header",
        "session": snapshot.get("session"),
        "reason": snapshot.get("reason"),
        "id": snapshot.get("id"),
        "taken_at": snapshot.get("taken_at"),
    })]
    for ev in snapshot.get("events", []):
        lines.append(json.dumps({"record": "event", **ev}))
    for fr in snapshot.get("frames", []):
        lines.append(json.dumps({"record": "frame", **fr}))
    return "\n".join(lines) + "\n"


# -- torch.profiler bridge ----------------------------------------------------

_BRIDGE_LOCK = threading.Lock()
_BRIDGE: "_ProfilerBridge | None" = None
_SEQ = 0
last_trace_path: str | None = None  # the Chrome trace the last window wrote
last_clock: ClockMap | None = None  # its ClockMap, bound to that trace's base


# the card idle this long after the window opens and before it closes: a
# device trace keeps only the records stamped inside the window the profiler
# opened on the host clock, so work sent at once loses its first kernels
# without it (scripts/torch_trace_window.py shows it on the card)
SETTLE_S = 0.5


def _settle_device():
    """At an edge of a window: wait for the card's queued work, then leave it
    idle for SETTLE_S (nothing to wait for where CUDA was never used)."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)


class _ProfilerBridge:
    """One profiler window on a thread of its own, which also waits out the
    device settle at both edges (so neither the caller nor a serving thread
    does): :meth:`start` returns once the window is open and settled, and
    :meth:`stop` once the work sent before it is in the trace."""

    def __init__(self, log_dir: str, seq: int):
        self.path = os.path.join(log_dir, f"torch-trace-{os.getpid()}-{seq}.json")
        self.error: str | None = None
        self.clock: ClockMap | None = None
        self._started = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="profiler-bridge", daemon=True)

    def start(self) -> str | None:
        self._thread.start()
        self._started.wait()
        return self.error

    def _run(self):
        try:
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            self.clock = ClockMap.read()
            _settle_device()
        except Exception as e:
            self.error = f"torch profiler start failed: {e}"
            self._started.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            _settle_device()
            prof.stop()
            prof.export_chrome_trace(self.path)
            self.clock = self.clock.bind(chrome_base_ns(self.path))
        except Exception as e:
            self.error = f"torch profiler stop failed: {e}"

    def stop(self) -> str | None:
        self._stop.set()
        self._thread.join()
        return self.error


def chrome_base_ns(path: str) -> int:
    """A profiler Chrome trace's ``baseTimeNanoseconds`` (its ``ts`` are us
    from it), read from the file's tail, where kineto writes it; 0 (absolute
    times) when it has none."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        f.seek(max(0, f.tell() - 65536))
        tail = f.read().decode("utf-8", "replace")
    found = re.findall(r'"baseTimeNanoseconds"\s*:\s*(\d+)', tail)
    return int(found[-1]) if found else 0


def start_profiler_bridge(log_dir: str) -> str | None:
    """Open a torch.profiler window whose Chrome trace lands in ``log_dir``
    at :func:`stop_profiler_bridge`, the card settled at both edges
    (SETTLE_S on the bridge's thread, after a device sync).  -> None on
    success, else the reason (a window already open, the profiler's own
    error); never raises."""
    global _BRIDGE, _SEQ
    with _BRIDGE_LOCK:
        if _BRIDGE is not None:
            return "torch profiler trace already active"
        _SEQ += 1
        bridge = _ProfilerBridge(str(log_dir), _SEQ)
        err = bridge.start()
        if err is None:
            _BRIDGE = bridge
        return err


def stop_profiler_bridge() -> str | None:
    """Close the window :func:`start_profiler_bridge` opened (a no-op when
    none is open) and write its trace.  -> None on success, else the
    reason."""
    global _BRIDGE, last_trace_path, last_clock
    with _BRIDGE_LOCK:
        bridge, _BRIDGE = _BRIDGE, None
        if bridge is None:
            return None
        err = bridge.stop()
        if err is None:
            last_trace_path, last_clock = bridge.path, bridge.clock
        return err
