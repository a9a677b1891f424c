"""The port's observability planes (ai_rtc_agent_tpu_torch/obs/) against the
JAX package's (ai_rtc_agent_tpu/obs/), on the CPU.

Each scenario runs once over the JAX modules and once over the port's, from
the same inputs (a seed, and ``time.monotonic`` replaced by one fake clock
that both sides read in turn), and the two results must be equal: exact for
counters, text and event structure, and for timestamps through the shared
fake clock.  The scenarios mirror the cases of tests/test_obs.py,
test_slo.py, test_devtel.py and test_promexport.py.  Two deliberate
differences are held as such: the port's device telemetry has no
jax.monitoring listener, so its plane is held to the JAX plane in the JAX
plane's own fallback mode ("cache-wrap", every build reported by its
site); and the profiler bridge is torch.profiler's.

Then the port alone, as the JAX package's agent-level tests do it: a forced
serve-time bucket build in the port's scheduler (a tiny-test BatchScheduler
on the CPU, whose builds are its eager builder's, so DEVTEL_RETRACE_MIN_MS
is 0 here) breaches once on all three surfaces (the flight recorder's
event log, the StreamDegraded webhook with ``RETRACE_BREACH``,
``retrace_breaches_total`` in /metrics and its Prometheus text), attributed
to the bucket's key; the prewarm and an engine guard rebuild never breach;
the spans a frame collects through the scheduler; the H2D and D2H meters;
the torch.profiler bridge's window.
"""

import asyncio
import json
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.media import frames as JF
from ai_rtc_agent_tpu.obs import devtel as JDEV
from ai_rtc_agent_tpu.obs import export as JEXP
from ai_rtc_agent_tpu.obs import promexport as JPROM
from ai_rtc_agent_tpu.obs import recorder as JREC
from ai_rtc_agent_tpu.obs import slo as JSLO
from ai_rtc_agent_tpu.obs import trace as JTR
from ai_rtc_agent_tpu.server import events as JEV
from ai_rtc_agent_tpu.utils import profiling as JPROF
from ai_rtc_agent_tpu_torch.media import frames as PF
from ai_rtc_agent_tpu_torch.obs import devtel as PDEV
from ai_rtc_agent_tpu_torch.obs import export as PEXP
from ai_rtc_agent_tpu_torch.obs import promexport as PPROM
from ai_rtc_agent_tpu_torch.obs import recorder as PREC
from ai_rtc_agent_tpu_torch.obs import slo as PSLO
from ai_rtc_agent_tpu_torch.obs import trace as PTR
from ai_rtc_agent_tpu_torch.server import events as PEV
from ai_rtc_agent_tpu_torch.utils import profiling as PPROF

SIDES = {
    "jax": SimpleNamespace(trace=JTR, recorder=JREC, slo=JSLO, export=JEXP, prom=JPROM,
                           devtel=JDEV, frames=JF, profiling=JPROF, events=JEV,
                           stop_bridge=JEXP.stop_jax_bridge),
    "port": SimpleNamespace(trace=PTR, recorder=PREC, slo=PSLO, export=PEXP, prom=PPROM,
                            devtel=PDEV, frames=PF, profiling=PPROF, events=PEV,
                            stop_bridge=PEXP.stop_profiler_bridge),
}


class FakeClock:
    """``time.monotonic`` for both sides: each read advances 1 ms."""

    def __init__(self, t0: float = 1000.0):
        self.t = t0

    def __call__(self) -> float:
        self.t += 0.001
        return round(self.t, 6)


@pytest.fixture(autouse=True)
def cache_wrap(monkeypatch):
    """Both devtel planes detached after each scenario; the JAX plane in its
    fallback mode (no jax.monitoring listener), the port's only mode."""
    monkeypatch.setattr(JDEV, "_LISTENER_INSTALLED", False)
    monkeypatch.setattr(JDEV, "_MONITORING_OK", False)
    yield
    JDEV.deactivate()
    PDEV.deactivate()


def both(monkeypatch, scenario):
    """Run ``scenario(side)`` over each package under one fresh fake clock;
    the results must be equal.  -> the port's."""
    got = {}
    for name, side in SIDES.items():
        monkeypatch.setattr(time, "monotonic", FakeClock())
        got[name] = scenario(side)
    assert got["port"] == got["jax"]
    return got["port"]


def _on(m):
    c = m.trace.TraceController(clock=time.monotonic)
    c.enabled = True
    return c


class _Bare:
    """A frame type that takes attributes (the SLO tests' frame)."""


# -- trace.py --------------------------------------------------------------------

def sc_attach_off(m):
    ctrl = m.trace.TraceController(clock=time.monotonic)
    ctrl.stop()
    tracer = m.trace.SessionTracer("s", ctrl)
    f = m.frames.VideoFrame.from_ndarray(np.zeros((4, 4, 3), np.uint8))
    return [tracer.attach(f) is None, f.trace is None, m.trace.get_trace(f) is None,
            m.trace.get_trace(np.zeros(3)) is None]


def sc_attach_on(m):
    tracer = m.trace.SessionTracer("s", _on(m))
    f = m.frames.VideoFrame.from_ndarray(np.zeros((4, 4, 3), np.uint8))
    tr = tracer.attach(f)
    return [f.trace is tr, tracer.attach(f) is tr, tr.to_dict(),
            tracer.attach(np.zeros((4, 4, 3), np.uint8)) is None]


def sc_span_mark_first_terminal_wins(m):
    tracer = m.trace.SessionTracer("s", _on(m))
    tr = tracer.mint()
    with tr.span("encode"):
        pass
    tr.add_span("ingest", 1.0, 2.0)
    tr.mark("similar_skip")
    tr.finish("shed")
    tr.add_span("send", 3.0, 4.0)
    tr.mark("late")
    tr.finish("sent")
    return [tr.done, tr.terminal, tr.to_dict(), tracer.frames_completed,
            tracer.snapshot_frames()]


def sc_begin_end_pairing(m):
    tr = m.trace.FrameTrace(1)
    tr.begin("submit", t=1.0)
    tr.begin("fetch", t=2.0)
    tr.end(t=3.0)
    tr.begin("engine_step", t=3.5)
    tr.end("submit", t=4.0)
    tr.begin("encode")
    tr.finish("sent", t=5.0)
    return [tr.to_dict(), tr.span_end("submit"), tr.span_end("never")]


def sc_ring_bounded(m):
    tracer = m.trace.SessionTracer("s", _on(m), ring_frames=3)
    for i in range(7):
        tracer.mint(frame_id=i).finish("sent")
    return [tracer.snapshot_frames(), tracer.frames_completed]


def sc_controller_window(m):
    now = [100.0]
    ctrl = m.trace.TraceController(clock=lambda: now[0])
    ctrl.max_capture_s = 30.0
    out = [ctrl.start(10_000.0), ctrl.status(), ctrl.start(0.01), ctrl.status()]
    ctrl.start(5.0)
    now[0] += 4.0
    out += [ctrl.active(), ctrl.status()]
    now[0] += 2.0
    out += [ctrl.active(), ctrl.enabled, ctrl.status()]
    ctrl.stop()
    return out + [ctrl.status()]


def sc_trace_enable_env(m):
    return m.trace.TraceController(clock=time.monotonic).active()


def sc_safe_list(m):
    class Flaky:
        def __init__(self):
            self.attempts = 0

        def __iter__(self):
            self.attempts += 1
            if self.attempts <= 2:
                raise RuntimeError("deque mutated during iteration")
            return iter([1, 2, 3])

    class Hostile:
        def __iter__(self):
            raise RuntimeError("deque mutated during iteration")

    return [m.trace.safe_list(Flaky()), m.trace.safe_list(Hostile()), m.trace.STAGES,
            m.trace.TERMINALS]


# -- recorder.py ---------------------------------------------------------------------

def sc_event_log_bounded(m):
    flight = m.recorder.FlightRecorder(clock=time.monotonic)
    rec = flight.register("s1")
    for i in range(10):
        rec.event("supervisor", old="HEALTHY", new="DEGRADED", i=i)
    return [list(rec.events), rec.recent_events(2), rec.recent_events()]


def sc_snapshot_store(m):
    stats = m.profiling.FrameStats()
    flight = m.recorder.FlightRecorder(stats=stats, clock=time.monotonic)
    flight.register("s1").event("webhook", event="StreamDegraded")
    ids = [flight.take_snapshot("s1", reason=f"r{i}") for i in range(3)]
    out = [ids, flight.get_snapshot(ids[0]), flight.get_snapshot(ids[2]),
           flight.take_snapshot("nope")]
    flight.unregister("s1")
    out += [flight.get_snapshot(ids[2]), flight.session("s1"), flight.index(),
            stats.snapshot()["flight_snapshots_total"]]
    return out


def sc_snapshot_frames_events_journey(m):
    flight = m.recorder.FlightRecorder(clock=time.monotonic)
    flight.controller.enabled = True
    rec = flight.register("s1")
    tr = rec.tracer.mint(frame_id=7)
    tr.add_span("ingest", 1.0, 2.0)
    tr.finish("passthrough")
    rec.event("overload_rung", old="normal", new="skip2")
    first = flight.take_snapshot("s1", reason="DEGRADED: test")
    rec.set_journey("j-1", leg=2, agent="a")
    second = flight.take_snapshot("s1", reason="journeyed")
    return [flight.get_snapshot(first), flight.get_snapshot(second), flight.index(),
            rec.tracer.snapshot_frames()]


def sc_webhook_flight_fields(m):
    posted, emitted = [], []

    class Sess:
        async def post(self, url, headers=None, json=None):
            posted.append(json)
            return SimpleNamespace(status=200)

    async def go():
        h = m.events.StreamEventHandler(session_factory=Sess)
        h.webhook_url, h.token = "http://orch/webhook", "tok"
        h.on_emit = lambda name, sid: emitted.append((name, sid))
        recent = [{"t": 1.0, "kind": "supervisor", "new": "DEGRADED"}]
        await h.handle_session_state("s1", "room", "DEGRADED", "step timeout",
                                     flight_snapshot_id="flt-9", recent_events=recent)
        await h.handle_session_state("s1", "room", "HEALTHY", "recovered")
        await h.handle_session_state("device-telemetry", "", "RETRACE_BREACH", "capture")
        await h.handle_session_state("s1", "", "SLO_BREACH", "slo", recent_events=recent)

    asyncio.run(go())
    for p in posted:
        p["timestamp"] = type(p["timestamp"]).__name__
    return [posted, emitted]


# -- export.py -----------------------------------------------------------------------

def _synthetic_snapshot() -> dict:
    """tests/test_obs.py's: pipelined overlap on engine_step (lane spill), a
    shed at ingest, a passthrough, and two event-log entries."""
    return {
        "id": "flt-1", "session": "s1", "reason": "DEGRADED: step timeout", "taken_at": 110.0,
        "events": [
            {"t": 103.0, "kind": "supervisor", "old": "HEALTHY", "new": "DEGRADED",
             "reason": "step timeout"},
            {"t": 103.5, "kind": "webhook", "event": "StreamDegraded"},
        ],
        "frames": [
            {"frame_id": 1, "session": "s1", "born": 100.0, "terminal": "sent",
             "spans": [["ingest", 100.0, 100.1], ["submit", 100.1, 100.2],
                       ["engine_step", 100.2, 101.5], ["send", 101.6, 101.7]],
             "marks": [["terminal:sent", 101.7]]},
            {"frame_id": 2, "session": "s1", "born": 100.5, "terminal": "sent",
             "spans": [["ingest", 100.5, 100.6], ["engine_step", 100.7, 102.0]],
             "marks": [["terminal:sent", 102.1]]},
            {"frame_id": 3, "session": "s1", "born": 102.5, "terminal": "shed", "spans": [],
             "marks": [["ingest_shed", 102.6], ["terminal:shed", 102.6]]},
            {"frame_id": 4, "session": "s1", "born": 103.0, "terminal": "passthrough",
             "spans": [["ingest", 103.0, 103.1]], "marks": [["terminal:passthrough", 103.2]]},
        ],
    }


def _random_snapshot(seed: int) -> dict:
    """Frames from a seed: random stages (one unknown), overlaps, marks."""
    rng = random.Random(seed)
    stages = list(JTR.STAGES) + ["weird_stage"]
    frames = []
    for i in range(rng.randint(1, 24)):
        t = rng.uniform(0.0, 5.0)
        spans = []
        for _ in range(rng.randint(0, 6)):
            t0 = t + rng.uniform(0.0, 0.05)
            spans.append([rng.choice(stages), round(t0, 6), round(t0 + rng.uniform(0, 0.1), 6)])
        frames.append({"frame_id": i, "session": "s", "born": round(t, 6),
                       "terminal": rng.choice(JTR.TERMINALS), "spans": spans,
                       "marks": [[f"batch_k{rng.randint(1, 8)}", round(t + 0.01, 6)]]})
    return {"id": f"flt-{seed}", "session": "s", "reason": "r", "taken_at": 9.0,
            "events": [{"t": 0.5, "kind": "slo", "stage": "send"}], "frames": frames}


SNAPSHOTS = {
    "synthetic": _synthetic_snapshot(),
    "empty": {"session": "s", "reason": "r", "events": [], "frames": []},
    "deep_spill": {"session": "s", "reason": "r", "events": [], "frames": [
        {"frame_id": i, "session": "s", "born": 0.0, "terminal": "sent",
         "spans": [["ingest", float(i), 30.0 + i]], "marks": []} for i in range(20)]},
    "journeyed": dict(_synthetic_snapshot(), journey={"journey_id": "j-9", "agent": "a", "leg": 2}),
    **{f"seed{s}": _random_snapshot(s) for s in range(3)},
}


def sc_exports(name):
    def run(m):
        snap = json.loads(json.dumps(SNAPSHOTS[name]))
        return [m.export.to_chrome_trace(snap), m.export.to_jsonl(snap),
                m.export.to_chrome_trace(snap, pid=3, meta={"journey_id": "j", "agent": "b"})]
    return run


def sc_merge(m):
    sources = [(SNAPSHOTS["synthetic"], {"journey_id": "j", "agent": "a", "leg": 1}),
               (SNAPSHOTS["seed1"], None), (SNAPSHOTS["journeyed"], {"agent": "c", "leg": 3})]
    return m.export.merge_chrome_traces(sources, journey="j")


def sc_stop_bridge_without_start(m):
    return m.stop_bridge()


# -- slo.py ----------------------------------------------------------------------------

def _feed(tracer, n, stage="engine_step", ms=20.0, terminal="sent"):
    for _ in range(n):
        tr = tracer.attach(_Bare())
        tr.add_span(stage, 0.0, ms / 1e3)
        tr.finish(terminal)


def _slo_tracer(m, plane, session="s1", tracing=False):
    ctrl = m.trace.TraceController(clock=time.monotonic)
    ctrl.enabled = bool(tracing)
    return m.trace.SessionTracer(session, ctrl, slo=plane)


def sc_histogram(m):
    rng = random.Random(5)
    h = m.slo.StageHistogram(budget_ms=10.0)
    empty = h.quantile_ms(0.5)
    for v in [0.05, 0.3, 1.0, 3.0, 30.0, 30.0, 9999.0] + [rng.uniform(0, 3000) for _ in range(200)]:
        h.observe(v)
    inf = m.slo.StageHistogram(budget_ms=10.0)
    for _ in range(10):
        inf.observe(60_000.0)
    return [empty, h.cumulative(), h.count, h.over, round(h.sum_ms, 6),
            [h.quantile_ms(q) for q in (0.01, 0.5, 0.9, 0.99, 1.0)], inf.quantile_ms(0.99),
            m.slo.BUCKET_BOUNDS_MS]


def sc_budgets(m):
    return m.slo.stage_budgets_ms()


def sc_bad_objective(m):
    try:
        m.slo.SloPlane()
    except ValueError as e:
        return str(e)
    return None


def sc_slo_feed(m):
    out = []
    plane = m.slo.SloPlane()
    tracer = _slo_tracer(m, plane)
    _feed(tracer, 5, stage="decode", ms=2.0)
    out.append([plane.frames_observed, plane.global_hist["decode"].count, len(tracer.ring),
                tracer.frames_completed])
    tracer = _slo_tracer(m, plane, session="s2", tracing=True)
    _feed(tracer, 3)
    out.append([plane.frames_observed, len(tracer.ring), plane.snapshot()])
    off = m.slo.SloPlane()
    off.enabled = False
    f = _Bare()
    out.append([_slo_tracer(m, off).attach(f) is None, hasattr(f, "trace")])
    traced = _slo_tracer(m, off, tracing=True)
    _feed(traced, 2)
    out.append([off.frames_observed, len(traced.ring)])
    tr = _slo_tracer(m, plane, session="s3").attach(_Bare())
    tr.add_span("not_a_stage", 0.0, 1.0)
    tr.finish("sent")
    plane.unregister("s1")
    out.append([plane.frames_observed, plane.session_snapshot("s1"), sorted(plane.sessions),
                plane.snapshot()])
    return out


BREACH_ENV = {"SLO_TICK_S": "1.0", "SLO_FAST_WINDOW_S": "3", "SLO_SLOW_WINDOW_S": "10",
              "SLO_OBJECTIVE": "0.99", "SLO_BURN_THRESHOLD": "2.0", "SLO_UP_TICKS": "2",
              "SLO_DOWN_TICKS": "3", "SLO_ENGINE_STEP_BUDGET_MS": "50"}


def sc_breach_sequence(seed):
    """A seeded sequence of ticks and observations over two sessions and two
    stages: every tick's snapshots and every breach transition."""

    def run(m):
        rng = random.Random(seed)
        stats = m.profiling.FrameStats()
        plane = m.slo.SloPlane(stats=stats)
        moves = []
        plane.on_breach = lambda sid, stage, state, info: moves.append((sid, stage, state, info))
        tracers = [_slo_tracer(m, plane, session=f"s{i}") for i in range(2)]
        out = []
        for tick in range(30):
            for tracer in tracers:
                bad = rng.random() < (0.9 if 5 <= tick < 15 else 0.05)
                _feed(tracer, rng.randint(0, 12), ms=200.0 if bad else 5.0)
                _feed(tracer, rng.randint(0, 3), stage="send", ms=rng.choice([1.0, 7.0]))
            plane.tick()
            out.append([plane.snapshot(), plane.session_snapshot("s0"),
                        plane.session_snapshot("s1")])
        return [out, moves, plane.breaches_total, stats.snapshot().get("slo_breaches_total")]

    return run


def sc_breach_callback_failure(m):
    plane = m.slo.SloPlane()
    plane.on_breach = lambda *a: (_ for _ in ()).throw(RuntimeError("bug"))
    tracer = _slo_tracer(m, plane)
    for _ in range(3):
        _feed(tracer, 10, ms=200.0)
        plane.tick()
    return [plane.breaches_total, plane.session_snapshot("s1")]


def sc_idle_session(m):
    plane = m.slo.SloPlane()
    tracer = _slo_tracer(m, plane)
    _feed(tracer, 1, ms=200.0)
    states = []
    for _ in range(10):
        plane.tick()
        st = plane.sessions["s1"].stages["engine_step"]
        states.append((st.state, st.burn_fast, st.burn_slow))
    return states


# -- devtel.py -------------------------------------------------------------------------

def _snapshot(p) -> dict:
    """A plane's /metrics gauges, ``device_live_buffers`` by key: on the CPU
    it is the port's own count (obs/devtel.py), not the JAX live arrays."""
    snap = p.snapshot()
    snap["device_live_buffers"] = type(snap["device_live_buffers"]).__name__
    return snap


def sc_devtel_phases(m):
    p = m.devtel.DevTelPlane(stats=m.profiling.FrameStats())
    fired = []
    p.on_breach = fired.append
    p.record_compile(3.0, context="sbucket-4:full")
    p.serving()
    p.record_compile(3.0, context="sbucket-2:full")
    p.record_compile(0.05, context="small", expected=False)
    p.record_compile(2.0, context="blessed", expected=True)
    p.record_compile(1.0)
    p.warmup()
    p.record_compile(1.0, context="rebuild")
    return [_snapshot(p), p.session_view(), p.health(), p.fragment(), list(p.compiles), fired,
            p.stats.snapshot().get("retrace_breaches_total")]


def sc_devtel_coalesce(m):
    p = m.devtel.DevTelPlane(stats=m.profiling.FrameStats())
    fired = []
    p.on_breach = fired.append
    p.serving()
    for _ in range(3):
        p.record_compile(1.0, context="sbucket-2:full")
    bad = m.devtel.DevTelPlane()
    bad.serving()
    bad.on_breach = lambda info: (_ for _ in ()).throw(RuntimeError("bug"))
    bad.record_compile(1.0)
    return [p.retrace_breaches, p.stats.snapshot()["retrace_breaches_total"], fired,
            bad.retrace_breaches]


def sc_devtel_scopes(m):
    p = m.devtel.activate(m.devtel.DevTelPlane())
    p.serving()
    with m.devtel.compile_scope("outer-key"):
        m.devtel.note_aot("build", seconds=0.3)
        with m.devtel.expected_scope("inner-build"):
            m.devtel.note_aot("build", seconds=0.3)
        with m.devtel.compile_scope("prewarm", expected=True):
            m.devtel.note_aot("build", seconds=0.4)
        m.devtel.note_aot("build", seconds=0.3)
    m.devtel.note_aot("build", seconds=0.3)
    m.devtel.note_aot("build", seconds=0.3, context="an-engine-key")
    m.devtel.note_aot("hit")
    m.devtel.note_aot("miss")
    return [list(p.compiles), p.retrace_breaches, _snapshot(p), p.watchdog]


def sc_devtel_transfers(m):
    p = m.devtel.activate(m.devtel.DevTelPlane())
    rng = np.random.default_rng(2)
    for n in rng.integers(1, 1 << 20, 16):
        m.devtel.note_h2d(int(n))
    for n in rng.integers(1, 1 << 20, 9):
        m.devtel.note_d2h(int(n))
    p.note_aot("hit")
    p.note_aot("miss")
    p.note_aot("build", seconds=2.5)
    p.set_aot_inventory(3, 4096)
    return _snapshot(p)


def sc_devtel_off(m):
    p = m.devtel.activate(m.devtel.DevTelPlane())
    out = [p.enabled, p.watchdog, m.devtel.compile_scope("x") is m.devtel._NULL,
           m.devtel.expected_scope() is m.devtel._NULL]
    m.devtel.note_h2d(100)
    m.devtel.note_d2h(100)
    m.devtel.note_aot("build", seconds=1.0)
    m.devtel.deactivate()
    m.devtel.note_h2d(1)
    m.devtel.note_aot("hit")
    return out + [p.h2d_transfers, p.d2h_transfers, p.compiles_total, p.aot_builds,
                  m.devtel.active()]


def sc_devtel_deactivate_keeps_newer(m):
    a = m.devtel.activate(m.devtel.DevTelPlane())
    b = m.devtel.activate(m.devtel.DevTelPlane())
    m.devtel.deactivate(a)
    kept = m.devtel.active() is b
    m.devtel.deactivate(b)
    return [kept, m.devtel.active(), a.watchdog, m.devtel.PHASE_WARMUP, m.devtel.PHASE_SERVING]


# -- promexport.py -----------------------------------------------------------------------

def _prom_plane(m):
    plane = m.slo.SloPlane()
    ctrl = m.trace.TraceController()
    ctrl.stop()
    tracer = m.trace.SessionTracer("s", ctrl, slo=plane)
    for i in range(20):
        tr = tracer.attach(_Bare())
        tr.add_span("decode", 0.0, 0.002)
        tr.add_span("engine_step", 0.0, 0.02 if i % 2 else 0.2)
        tr.finish("sent")
    return plane


PROM_SNAPSHOT = {
    "frames_total": 12, "fps": 29.97, "latency_p50_ms": None, "flag": True, "neg": -3,
    "big": 1e16, "tiny": 1.5e-7, "slo_stages": {"decode": {"count": 1}}, "name": "text",
    "host_plane_sessions": {"s1": {"send_p50_us": 3.0}}, "bad-name": 1, "9lives": 2,
    "engine_trips_total": 2, "engine_rebuild_ms_p50": 123.4, "overload_queues": [1, 2],
    "retrace_breaches_total": 1, "aot_cache_bytes": 4096,
}


def sc_prom(m):
    plane = _prom_plane(m)
    off = m.slo.SloPlane()
    off.enabled = False
    return [m.prom.render(PROM_SNAPSHOT), m.prom.render(PROM_SNAPSHOT, slo=plane),
            m.prom.render(PROM_SNAPSHOT, slo=off), m.prom.CONTENT_TYPE,
            m.prom.labeled("x", {"stage": 'a"b\\c\nd'}, 1.5)]


def sc_prom_nan(m):
    try:
        m.prom.render({"x": float("nan")})
        return "rendered"
    except ValueError:
        return "refused"


SCENARIOS = {
    "attach_off": (sc_attach_off, {}),
    "attach_on": (sc_attach_on, {}),
    "span_mark_first_terminal_wins": (sc_span_mark_first_terminal_wins, {}),
    "begin_end_pairing": (sc_begin_end_pairing, {}),
    "ring_bounded": (sc_ring_bounded, {}),
    "controller_window": (sc_controller_window, {}),
    "trace_enable_on": (sc_trace_enable_env, {"TRACE_ENABLE": "1"}),
    "trace_enable_off": (sc_trace_enable_env, {"TRACE_ENABLE": "0"}),
    "safe_list": (sc_safe_list, {}),
    "event_log_bounded": (sc_event_log_bounded, {"FLIGHT_EVENTS": "4"}),
    "snapshot_store": (sc_snapshot_store, {"FLIGHT_SNAPSHOTS": "2"}),
    "snapshot_frames_events_journey": (sc_snapshot_frames_events_journey, {}),
    "webhook_flight_fields": (sc_webhook_flight_fields, {}),
    **{f"export_{name}": (sc_exports(name), {}) for name in SNAPSHOTS},
    "merge_chrome_traces": (sc_merge, {}),
    "stop_bridge_without_start": (sc_stop_bridge_without_start, {}),
    "histogram": (sc_histogram, {}),
    "budgets": (sc_budgets, {}),
    "budgets_env": (sc_budgets, {"SLO_ENGINE_STEP_BUDGET_MS": "123.5", "SLO_SEND_BUDGET_MS": "7"}),
    "bad_objective": (sc_bad_objective, {"SLO_OBJECTIVE": "1.5"}),
    "slo_feed": (sc_slo_feed, {}),
    **{f"breach_sequence_{s}": (sc_breach_sequence(s), BREACH_ENV) for s in range(3)},
    "breach_callback_failure": (sc_breach_callback_failure, BREACH_ENV),
    "idle_session": (sc_idle_session, BREACH_ENV),
    "devtel_phases": (sc_devtel_phases, {}),
    "devtel_phases_min_ms": (sc_devtel_phases, {"DEVTEL_RETRACE_MIN_MS": "1500"}),
    "devtel_coalesce": (sc_devtel_coalesce, {"DEVTEL_BREACH_COALESCE_S": "60"}),
    "devtel_coalesce_off": (sc_devtel_coalesce, {"DEVTEL_BREACH_COALESCE_S": "0"}),
    "devtel_scopes": (sc_devtel_scopes, {}),
    "devtel_transfers": (sc_devtel_transfers, {}),
    "devtel_off": (sc_devtel_off, {"DEVTEL_ENABLE": "0"}),
    "devtel_on": (sc_devtel_off, {}),
    "devtel_deactivate_keeps_newer": (sc_devtel_deactivate_keeps_newer, {}),
    "prom": (sc_prom, {}),
    "prom_nan": (sc_prom_nan, {}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_obs_matches_jax(monkeypatch, name):
    """One scenario through each package: equal results (exact; clock reads
    through the shared fake clock)."""
    scenario, env = SCENARIOS[name]
    for k in ("TRACE_ENABLE", "FLIGHT_EVENTS", "FLIGHT_SNAPSHOTS", "DEVTEL_ENABLE",
              "DEVTEL_RETRACE_MIN_MS", "DEVTEL_BREACH_COALESCE_S", "SLO_ENABLE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    both(monkeypatch, scenario)


def test_snapshot_survives_concurrent_ring_appends():
    """Writers hammer both rings while snapshots run: nothing raises (the
    DEGRADED auto-snapshot path never may)."""
    flight = PREC.FlightRecorder()
    flight.controller.enabled = True
    rec = flight.register("s1")
    stop = threading.Event()
    errors = []

    def writer():
        i = 0
        while not stop.is_set():
            rec.tracer.mint(frame_id=i).finish("sent")
            rec.event("overload_rung", i=i)
            i += 1

    def reader():
        try:
            for _ in range(300):
                assert isinstance(rec.snapshot()["frames"], list)
                flight.take_snapshot("s1", reason="race")
                flight.index()
        except Exception as e:  # reported below
            errors.append(e)

    writers = [threading.Thread(target=writer) for _ in range(2)]
    r = threading.Thread(target=reader)
    for t in writers:
        t.start()
    r.start()
    r.join(timeout=60)
    stop.set()
    for t in writers:
        t.join(timeout=10)
    assert not r.is_alive() and not any(t.is_alive() for t in writers)
    assert not errors, errors


def test_profiler_bridge_window_writes_a_chrome_trace(tmp_path):
    """The torch.profiler bridge: a window opened on one thread, ops on
    another, closed on a third, writes its Chrome trace into the named
    directory; a second open while one is open is refused with its reason."""
    import torch

    out = {}
    t = threading.Thread(target=lambda: out.setdefault("start", PEXP.start_profiler_bridge(
        str(tmp_path / "prof"))))
    t.start()
    t.join()
    assert out["start"] is None
    assert PEXP.start_profiler_bridge(str(tmp_path / "other")) == \
        "torch profiler trace already active"
    torch.ones(8) @ torch.ones(8)
    t = threading.Thread(target=lambda: out.setdefault("stop", PEXP.stop_profiler_bridge()))
    t.start()
    t.join()
    assert out["stop"] is None and PEXP.stop_profiler_bridge() is None
    path = PEXP.last_trace_path
    assert path.startswith(str(tmp_path / "prof"))
    doc = json.loads(open(path).read())
    assert isinstance(doc["traceEvents"], list)


# -- the port's agent over a tiny-test scheduler on the CPU ----------------------------------

class WebhookSink:
    """The webhook endpoint: every posted body."""

    def __init__(self):
        self.posted = []

    def __call__(self):
        sink = self

        class Sess:
            async def post(self, url, headers=None, json=None):
                sink.posted.append(json)
                return SimpleNamespace(status=200)

        return Sess()


def _frame(m, fill, pts):
    from fractions import Fraction

    vf = m.VideoFrame.from_ndarray(np.full((64, 64, 3), fill, np.uint8))
    vf.pts, vf.time_base = pts, Fraction(1, 30)
    return vf


async def _wait(pred, what, timeout_s=30.0):
    t = time.perf_counter()
    while not pred():
        assert time.perf_counter() - t < timeout_s, f"no {what} within {timeout_s} s"
        await asyncio.sleep(0.01)


def test_agent_serve_time_bucket_build_breaches_on_all_three_surfaces(monkeypatch):
    """The port's agent over a tiny-test BatchScheduler (2 slots, every bucket
    prewarmed at startup, the JAX defaults): the prewarm's builds are warmup
    builds; a served frame is traced through submit, batch_join,
    engine_step, fetch and postprocess, and meters one frame each way; a
    bucket build forced at dispatch while a session is live breaches
    exactly once, on the flight recorder of every live session, the
    StreamDegraded webhook (RETRACE_BREACH) and retrace_breaches_total
    (JSON and Prometheus), attributed to that bucket's key; an engine
    guard rebuild, which captures every bucket again, does not."""
    from ai_rtc_agent_tpu_torch.server import agent as PA
    from ai_rtc_agent_tpu_torch.server import signaling as PS

    for k, v in {"SUPERVISOR": "1", "OVERLOAD_CONTROL": "1", "ENGINE_GUARD": "1",
                 "OVERLOAD_LOOP_LAG_BUDGET_MS": "100000", "BATCHSCHED_MAX_SESSIONS": "2",
                 "WARMUP_FRAMES": "0", "DEVTEL_RETRACE_MIN_MS": "0", "TRACE_ENABLE": "1",
                 "ENGINE_REBUILD_BACKOFF_S": "0.01", "WEBHOOK_URL": "http://orchestrator/hook",
                 "AUTH_TOKEN": "tok"}.items():
        monkeypatch.setenv(k, v)
    sink = WebhookSink()

    async def go():
        app = PA.build_app(model_id="tiny-test", provider=PS.LoopbackProvider(), device="cpu")
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            app["stream_event_handler"]._session_factory = sink
            plane, sched, flight = app["devtel"], app["batch_scheduler"], app["flight"]
            keys = sched.bucket_keys()
            assert plane.phase == "serving" and plane.retrace_breaches == 0
            warm = [c for c in plane.compiles if c["context"] in keys.values()]
            assert sorted(c["context"] for c in warm) == sorted(keys.values())
            assert all(c["phase"] == "warmup" and c["expected"] for c in warm)
            assert plane.aot_builds >= len(keys) and plane.aot_entries >= len(keys)
            r = await client.post("/whip", data=PS.make_loopback_offer(),
                                  headers={"Content-Type": "application/sdp"})
            assert r.status == 201
            (sid,) = app["state"]["whip_pcs"]
            pub, track = app["state"]["whip_pcs"][sid], app["state"]["whip_tracks"][sid]
            h2d, d2h = plane.h2d_bytes, plane.d2h_bytes
            for i in range(3):
                await pub.in_track.push(_frame(PF, 10 * i, i))
            outs = [await asyncio.wait_for(track.recv(), 60) for _ in range(2)]
            assert [o.pts for o in outs] == [0, 1]
            # every frame submitted meters its upload; every frame fetched its row
            assert plane.h2d_bytes - h2d == 3 * 64 * 64 * 3
            assert plane.d2h_bytes - d2h == 2 * 64 * 64 * 3
            tr = outs[0].trace
            names = [n for n, _, _ in tr.spans if "." not in n]  # the stages, not submit.*
            assert names[:6] == ["ingest", "submit", "batch_join", "engine_step", "fetch",
                                 "postprocess"], names
            spans = {n: (t0, t1) for n, t0, t1 in tr.spans}
            assert all(t1 >= t0 for t0, t1 in spans.values())
            # submit's children, in order, inside it; the frame names its step
            kids = [n for n, _, _ in tr.spans if n.startswith("submit.")]
            assert kids == ["submit.coerce", "submit.pin", "submit.copy", "submit.enqueue"]
            assert all(spans["submit"][0] <= spans[k][0] <= spans[k][1] <= spans["submit"][1]
                       for k in kids)
            assert tr.step is not None and tr.to_dict()["step"] == tr.step
            assert spans["batch_join"][1] == spans["engine_step"][0]
            assert spans["engine_step"][1] == spans["fetch"][1] <= spans["postprocess"][0]
            assert any(n.startswith("batch_k") for n, _ in tr.marks)
            assert plane.retrace_breaches == 0
            # a bucket evicted: the next dispatch builds it, at serve time
            evicted = sched._bucket.graph_cache._steps.pop(keys[(1, "full")])
            assert evicted is not None
            await pub.in_track.push(_frame(PF, 90, 3))
            await asyncio.wait_for(track.recv(), 60)
            await _wait(lambda: any(p.get("state") == "RETRACE_BREACH" for p in sink.posted),
                        "RETRACE_BREACH webhook")
            breaches = [p for p in sink.posted if p.get("state") == "RETRACE_BREACH"]
            assert len(breaches) == 1 and breaches[0]["event"] == "StreamDegraded"
            assert keys[(1, "full")] in breaches[0]["reason"]
            assert breaches[0]["stream_id"] == "device-telemetry"
            events = [e for e in flight.session(sid).events if e["kind"] == "retrace"]
            assert [e["context"] for e in events] == [keys[(1, "full")]]
            assert events[0]["phase"] == "serving" and events[0]["expected"] is False
            body = await (await client.get("/metrics")).json()
            assert body["retrace_breaches_total"] == 1
            assert body["devtel_serving_compiles_total"] == 1
            text = await (await client.get("/metrics", params={"format": "prom"})).text()
            assert "retrace_breaches_total 1" in text.splitlines()
            health = await (await client.get("/health")).json()
            assert health["devtel"]["retrace_breaches"] == 1
            assert health["devtel"]["watchdog"] == "cache-wrap"
            last = health["sessions"][sid]["devtel"]["last_breach"]
            assert last["context"] == keys[(1, "full")]
            # the engine guard's rebuild recaptures every bucket: no breach
            guard = app["engine_guard"]
            builds = plane.aot_builds
            guard._trip("test trip")
            await _wait(lambda: guard.state == "ARMED" and guard.rebuilds == 1, "rebuild")
            assert plane.aot_builds == builds + len(keys)
            assert plane.retrace_breaches == 1 and plane.phase == "serving"
            await pub.in_track.push(_frame(PF, 120, 4))
            await asyncio.wait_for(track.recv(), 60)
            assert plane.retrace_breaches == 1
            assert [p.get("state") for p in sink.posted].count("RETRACE_BREACH") == 1
        finally:
            await client.close()

    asyncio.run(go())


def test_agent_devtel_kill_switch(monkeypatch):
    """DEVTEL_ENABLE=0: no plane, its hooks inert, no /metrics keys, /health
    silent."""
    from ai_rtc_agent_tpu_torch.server import agent as PA
    from ai_rtc_agent_tpu_torch.server import signaling as PS

    monkeypatch.setenv("DEVTEL_ENABLE", "0")

    class Pipe:
        def __call__(self, frame):
            return frame

    async def go():
        app = PA.build_app(pipeline=Pipe(), provider=PS.LoopbackProvider())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            assert app["devtel"] is None and PDEV.active() is None
            j = await (await client.get("/metrics")).json()
            assert "devtel_enabled" not in j and "aot_cache_hits_total" not in j
            assert "devtel" not in await (await client.get("/health")).json()
        finally:
            await client.close()

    asyncio.run(go())
