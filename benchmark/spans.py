"""The program's own spans in a traced run, on the device trace's clock.

``Tracing.make`` turns the port's tracing on (obs/trace.py): one
``TraceController``, the batch scheduler's ``StepTracer`` (its dispatcher's
``hold.<reason>``, ``dispatch`` and ``bank`` spans and each step's
``resolve`` instant) and one ``SessionTracer`` a track that keeps every
frame trace it mints (a frame's ``ingest``, ``submit`` and its ``submit.*``
children, ``batch_join``, ``engine_step``, ``fetch``, and the ``step`` it
rode); each ring holds the whole window.  ``ClockedProfiler`` is the
harness's device profiler window (trace.Profiler) that also reads the
port's ``ClockMap`` at its open, binds it to the profiler's zero at its
close, and has the tracers on while it is open.  A program whose
obs/trace.py has no ``StepTracer`` or ``ClockMap`` gets no Tracing (None),
and then no spans.  spanrun.py wires both into a run of run.py.

``collect`` maps every stamp with the window's ``ClockMap`` onto the
device records' time base (us) and derives from the same records what the
readers match the spans with; it is ``ctx["spans"]``:

* ``settled``: (lo, hi), the span trace.reduce reads (its 0.5 s settle);
* ``dispatcher``: [(name, t0, t1, args)] of the dispatcher's spans;
* ``resolves``: {step id: t} of each step's first readback resolve;
* ``frames``: [{"session", "step", "spans": [(name, t0, t1)]}];
* ``idle``: [(t0, t1)], the holes in the device's busy union in ``settled``;
* ``epilogues``: [(start, end of the D2H copies after it)], one a bucket
  step (the epilogue launch is the step marker), in device order.
"""

from __future__ import annotations

import collections
import re
import statistics

from .trace import SETTLE_US, STEP_MARKER, Profiler, classify

# the dispatcher's states in which a frame waited inside the program
QUEUED = ("hold.window", "hold.depth", "hold.step_lock", "dispatch")
D2H = re.compile(r"DtoH|Device -> Pinned|Device -> Pageable")
STEPS_A_FRAME = 8  # ring entries a camera frame can cause, at most (holds, dispatch, resolve)


class Tracing:
    """The traced run's tracers (see the module's docstring)."""

    def __init__(self, T, traffic: dict):
        window_s = traffic["trace_s"] + 2.0
        frames = int(traffic["camera_fps"] * window_s) + 1
        self.duration_s = window_s
        self.controller = T.TraceController()
        self.controller.stop()  # on for the profiler's window only (start)
        self.steps = T.StepTracer(self.controller,
                                  ring=STEPS_A_FRAME * frames * traffic["sessions"])

        class Keeper(T.SessionTracer):
            """A track's tracer that keeps every trace it mints."""

            def __init__(self, sid, controller):
                super().__init__(sid, controller, ring_frames=1)
                self.kept = collections.deque(maxlen=2 * frames)

            def mint(self, frame_id=None):
                trace = super().mint(frame_id)
                self.kept.append(trace)
                return trace

        self.tracers = [Keeper(f"bench-{i}", self.controller) for i in range(traffic["sessions"])]

    @classmethod
    def make(cls, traffic: dict):
        """The tracers, or None where the program lacks the pieces."""
        from ai_rtc_agent_tpu_torch.obs import trace as T

        if not all(hasattr(T, n) for n in ("StepTracer", "ClockMap", "profiler_base_ns")):
            return None
        return cls(T, traffic)

    def attach(self, sched):
        sched.tracer = self.steps

    def tracer(self, i: int):
        return self.tracers[i]

    def start(self, seconds: float | None = None):
        self.controller.start(self.duration_s if seconds is None else seconds)

    def stop(self):
        self.controller.stop()


class ClockedProfiler(Profiler):
    """trace.Profiler with the port's ClockMap (``clock``: None until the
    window closes, or where the port has none) and ``tracing`` on while it
    is open."""

    def __init__(self, tracing=None):
        super().__init__()
        self.tracing = tracing
        self._map = None
        self.clock = None

    def start(self):
        from ai_rtc_agent_tpu_torch.obs import trace as T

        if self.tracing is not None:
            self.tracing.start()
        super().start()
        self._map = T.ClockMap.read() if hasattr(T, "ClockMap") else None

    def stop(self, t_close: float | None = None):
        from ai_rtc_agent_tpu_torch.obs import trace as T

        if self.tracing is not None:
            self.tracing.stop()
        super().stop(t_close)
        base = T.profiler_base_ns(self._prof) if self._map is not None else None
        self.clock = None if base is None else self._map.bind(base)


def settled_span(records: list):
    """trace.reduce's settled span (lo, hi) of device records, or None."""
    if not records:
        return None
    lo = min(r[1] for r in records) + SETTLE_US
    hi = max(r[2] for r in records) - SETTLE_US
    return (lo, hi) if hi > lo else None


def union(intervals) -> list:
    """The union of [(t0, t1)] as sorted disjoint intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a: list, b: list) -> float:
    """The length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_holes(records: list, lo: float, hi: float) -> list:
    """The holes in the union of device intervals, inside [lo, hi]."""
    busy = union((max(s, lo), min(e, hi)) for _, s, e in records if e > lo and s < hi)
    holes, t = [], lo
    for s, e in busy:
        if s > t:
            holes.append((t, s))
        t = max(t, e)
    if hi > t:
        holes.append((t, hi))
    return holes


def epilogues(records: list) -> list:
    """[(epilogue start, end of the last D2H copy before the next epilogue, or
    None)] in device order: each bucket step's marker and its readback."""
    starts = sorted(s for n, s, _ in records if classify(n) == STEP_MARKER)
    copies = sorted((s, e) for n, s, e in records if D2H.search(n))
    out, j = [], 0
    for i, s in enumerate(starts):
        nxt = starts[i + 1] if i + 1 < len(starts) else float("inf")
        while j < len(copies) and copies[j][0] < s:
            j += 1
        end = None
        while j < len(copies) and copies[j][0] < nxt:
            end = copies[j][1] if end is None else max(end, copies[j][1])
            j += 1
        out.append((s, end))
    return out


def collect(tracing, profile):
    """``ctx["spans"]`` of a traced run (``profile``: its ClockedProfiler),
    or None (no tracers, no clock map, no settled device span)."""
    cm = getattr(profile, "clock", None)
    if tracing is None or profile is None or cm is None:
        return None
    records = profile.records()
    settled = settled_span(records)
    if settled is None:
        return None
    m = cm.to_device_us
    dispatcher, resolves = [], {}
    for name, t0, t1, args in list(tracing.steps.ring):
        if t1 is None:
            if name == "resolve":
                resolves[args["step"]] = m(t0)
        else:
            dispatcher.append((name, m(t0), m(t1), args))
    frames = [{"session": i, "step": tr.step,
               "spans": [(n, m(a), m(b)) for n, a, b in list(tr.spans)]}
              for i, tracer in enumerate(tracing.tracers) for tr in list(tracer.kept)]
    return {"settled": settled, "dispatcher": dispatcher, "resolves": resolves,
            "frames": frames, "idle": idle_holes(records, *settled),
            "epilogues": epilogues(records)}


# -- what the readers read ------------------------------------------------------------

def dispatcher_in(sp, names=None) -> list:
    """The dispatcher's spans (of ``names``) that overlap the settled span."""
    lo, hi = sp["settled"]
    return [d for d in sp["dispatcher"] if d[2] > lo and d[1] < hi
            and (names is None or d[0] in names)]


def frame_ms(sp, names) -> list:
    """Per traced frame whose spans of ``names`` all end in the settled span:
    their summed duration (ms)."""
    lo, hi = sp["settled"]
    out = []
    for fr in sp["frames"]:
        got = [(t0, t1) for n, t0, t1 in fr["spans"] if n in names]
        if len(got) == len(names) and all(lo <= t1 <= hi for _, t1 in got):
            out.append(sum(t1 - t0 for t0, t1 in got) / 1e3)
    return out


def step_epilogues(sp) -> dict:
    """{step id: (its epilogue's start, its readback's end)} for the steps
    dispatched in the settled span.  Steps run on the device in dispatch
    order, one epilogue each, so step s has epilogue ``base + s``: the base
    is the one most steps agree with, a step agreeing where an epilogue
    starts after its dispatch and before its first resolve."""
    epis = sp["epilogues"]
    disp = {a["step"]: t0 for n, t0, _, a in sp["dispatcher"] if n == "dispatch"}
    starts = [s for s, _ in epis]
    votes: dict = {}
    for step, t0 in disp.items():
        t_res = sp["resolves"].get(step)
        if t_res is None:
            continue
        for i, s in enumerate(starts):
            if t0 <= s <= t_res:
                votes[i - step] = votes.get(i - step, 0) + 1
    if not votes:
        return {}
    base = max(votes, key=votes.get)
    lo, hi = sp["settled"]
    return {step: epis[base + step] for step, t0 in disp.items()
            if lo <= t0 <= hi and 0 <= base + step < len(epis)}


def resolve_lags_ms(sp) -> list:
    """Per step dispatched in the settled span: its resolve less the end of
    its readback copy on the device (ms)."""
    out = []
    for step, (_, end) in step_epilogues(sp).items():
        t_res = sp["resolves"].get(step)
        if end is not None and t_res is not None:
            out.append((t_res - end) / 1e3)
    return out


def summary(ctx) -> str:
    """One line for standard error: how the settled span splits by the spans."""
    sp = ctx["spans"]
    lo, hi = sp["settled"]
    win = hi - lo
    states = collections.OrderedDict()
    for name, t0, t1, _ in dispatcher_in(sp):
        states.setdefault(name, []).append((max(t0, lo), min(t1, hi)))
    cover = union(iv for ivs in states.values() for iv in ivs)
    idle = sp["idle"]
    idle_by = {name: overlap(idle, union(ivs)) / 1e3 for name, ivs in states.items()}
    idle_by["none"] = (sum(e - s for s, e in idle) - overlap(idle, cover)) / 1e3
    held = {name: sum(e - s for s, e in union(ivs)) / 1e3 for name, ivs in states.items()}
    steps = len([d for d in dispatcher_in(sp, ("dispatch",))])
    med = {}
    for n in ("ingest", "submit", "submit.coerce", "submit.pin", "submit.copy",
              "submit.enqueue", "batch_join", "engine_step", "fetch"):
        v = frame_ms(sp, (n,))
        if v:
            med[n] = round(statistics.median(v), 3)
    lags = resolve_lags_ms(sp)
    return (f"spans: settled {win / 1e6:.3f} s, dispatcher covers "
            f"{100 * sum(e - s for s, e in cover) / win:.2f}%, {steps} dispatches; "
            f"dispatcher ms by state {({k: round(v, 3) for k, v in held.items()})}; "
            f"device idle ms by state {({k: round(v, 3) for k, v in idle_by.items()})}; "
            f"frame span ms p50 {med}; resolve lag ms p50 "
            f"{round(statistics.median(lags), 3) if lags else None} over {len(lags)} steps")


def hold_ms_per_step(ctx, reason: str):
    """Delta of the scheduler's hold counter for ``reason`` over the delta of
    its steps, between the window's edges (ms), or None."""
    a, b = ctx["counters"]["t0"], ctx["counters"]["t1"]
    ha, hb = a.get("batchsched_hold_ms_total"), b.get("batchsched_hold_ms_total")
    steps = b["batchsched_steps_total"] - a["batchsched_steps_total"]
    if ha is None or hb is None or reason not in hb or steps <= 0:
        return None
    return (hb[reason] - ha.get(reason, 0.0)) / steps
