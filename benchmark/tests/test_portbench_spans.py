"""The readers of the program's own spans and counters, on synthetic
contexts: a known idle gap under hold.depth against one under hold.empty,
zero readings, the absence of spans or counters (a program without them);
``spans.collect`` mapping host stamps onto the device records; a step
matched to its own epilogue with two steps in flight; and spanrun's wiring
through a CPU run of the tiny cell, undone after it."""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import spans as SP
from benchmark.tests import _tiny

METRICS = Path(__file__).resolve().parents[1] / "metrics"
NEW = ("idle_queued_share", "hold_depth_ms_per_step", "hold_window_ms_per_step",
       "resolve_lag_ms_p50", "submit_copy_ms_p50", "ingest_ms_p50")


def read(name, ctx):
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}",
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _spans(dispatcher, idle=(), frames=(), resolves=None, epilogues=()):
    return {"settled": (0.0, 10_000.0), "dispatcher": list(dispatcher), "idle": list(idle),
            "frames": list(frames), "resolves": resolves or {}, "epilogues": list(epilogues)}


def _counters(a, b, steps=(10, 30)):
    return {"t0": {"batchsched_steps_total": steps[0], "batchsched_hold_ms_total": a},
            "t1": {"batchsched_steps_total": steps[1], "batchsched_hold_ms_total": b}}


def test_idle_under_depth_counts_idle_under_empty_does_not():
    # the device idles 1000 us while the dispatcher holds at depth, and 1000 us
    # while nothing is queued: only the first is a frame waiting in the program
    sp = _spans([("hold.depth", 900.0, 2100.0, None), ("dispatch", 2100.0, 2150.0, {"step": 1}),
                 ("hold.empty", 4800.0, 6200.0, None)],
                idle=[(1000.0, 2000.0), (5000.0, 6000.0)])
    got = read("idle_queued_share", {"spans": sp})
    assert got == pytest.approx(10.0)
    device_idle = 100.0 * sum(e - s for s, e in sp["idle"]) / 10_000.0
    assert got <= device_idle == 20.0


def test_idle_queued_share_reads_zero_and_nothing():
    sp = _spans([("hold.empty", 0.0, 9000.0, None), ("dispatch", 9000.0, 9100.0, {"step": 1})],
                idle=[(100.0, 8000.0)])
    assert read("idle_queued_share", {"spans": sp}) == 0.0
    assert read("idle_queued_share", {"spans": None}) is None
    assert read("idle_queued_share", {}) is None
    assert read("idle_queued_share", {"spans": _spans([], idle=[(0.0, 5.0)])}) is None


@pytest.mark.parametrize("name,reason", [("hold_depth_ms_per_step", "depth"),
                                         ("hold_window_ms_per_step", "window")])
def test_hold_counters_per_step(name, reason):
    a = {"empty": 5.0, "window": 10.0, "depth": 100.0, "quarantine": 0.0, "step_lock": 1.0}
    b = dict(a, window=70.0, depth=1500.0)
    want = {"depth": 1400.0 / 20, "window": 60.0 / 20}[reason]
    assert read(name, {"counters": _counters(a, b)}) == pytest.approx(want)
    assert read(name, {"counters": _counters(a, a)}) == 0.0  # counted, nothing held
    # a program without the counter (or no step in the window) gives nothing
    parent = {"t0": {"batchsched_steps_total": 1}, "t1": {"batchsched_steps_total": 9}}
    assert read(name, {"counters": parent}) is None
    assert read(name, {"counters": _counters(a, b, steps=(5, 5))}) is None


def _frame(step, **spans):
    return {"session": 0, "step": step, "spans": [(n, t0, t1) for n, (t0, t1) in spans.items()]}


def test_frame_span_medians():
    frames = [_frame(1, ingest=(1000.0, 3000.0), **{"submit.pin": (3000.0, 3100.0),
                                                   "submit.copy": (3100.0, 3400.0)}),
              _frame(2, ingest=(2000.0, 6000.0), **{"submit.pin": (6000.0, 6200.0),
                                                   "submit.copy": (6200.0, 6300.0)}),
              _frame(3, ingest=(8000.0, 12_000.0))]  # admitted after the settled span
    sp = _spans([("dispatch", 0.0, 1.0, {"step": 1})], frames=frames)
    assert read("ingest_ms_p50", {"spans": sp}) == pytest.approx(3.0)  # 2 and 4 ms
    assert read("submit_copy_ms_p50", {"spans": sp}) == pytest.approx(0.35)  # 0.4, 0.3
    bare = _spans([("dispatch", 0.0, 1.0, {"step": 1})],
                  frames=[_frame(1, ingest=(1000.0, 1000.0))])
    assert read("ingest_ms_p50", {"spans": bare}) == 0.0
    assert read("submit_copy_ms_p50", {"spans": bare}) is None  # no submit.* spans
    for name in ("ingest_ms_p50", "submit_copy_ms_p50", "resolve_lag_ms_p50"):
        assert read(name, {"spans": None}) is None


def test_resolve_lag_matches_each_step_to_its_own_epilogue():
    """Two steps in flight: step 2 is dispatched before step 1's epilogue
    runs, so the first epilogue after a dispatch is not always its own."""
    disp, epis, res = [], [], {}
    for s in range(1, 9):
        t0 = 1000.0 * s  # dispatched every ms ...
        disp.append(("dispatch", t0, t0 + 50.0, {"step": s}))
        e = t0 + 1500.0  # ... its epilogue 1.5 ms later (after the next dispatch)
        epis.append((e, e + 100.0))  # its readback ends 0.1 ms after the epilogue starts
        res[s] = e + 100.0 + 20.0 * s  # resolved 20 s us later
    epis.insert(0, (500.0, 520.0))  # a step dispatched before the tracers came on
    sp = _spans(disp, resolves=res, epilogues=epis)
    sp["settled"] = (0.0, 20_000.0)
    assert read("resolve_lag_ms_p50", {"spans": sp}) == pytest.approx(0.09)  # 20..160 us
    sp["resolves"] = {s: e + 100.0 for s, (e, _) in zip(range(1, 9), epis[1:])}
    assert read("resolve_lag_ms_p50", {"spans": sp}) == 0.0


def test_collect_maps_host_stamps_onto_the_records():
    from ai_rtc_agent_tpu_torch.obs import trace as T

    host, wall = 9_000_000_000_000, 1_792_000_000_000_000_000
    base = wall - 3_000_000_000  # the profiler's zero, 3 s before the pair
    cm = T.ClockMap(host, wall, base)
    t = host / 1e9  # a host stamp at the pair: 3e6 us on the records' base
    us = 3_000_000.0
    records = [("cudaMemcpy warm", us - 600_000.0, us - 599_000.0),
               ("vectorized_elementwise_kernel", us + 1000.0, us + 2000.0),
               ("stream_epilogue_kernel", us + 2000.0, us + 2100.0),
               ("Memcpy DtoH (Device -> Pinned)", us + 2100.0, us + 2200.0),
               ("tail", us + 700_000.0, us + 701_000.0)]
    ctl = T.TraceController()
    ctl.enabled = True
    steps = T.StepTracer(ctl)
    steps.span("hold.depth", t, t + 0.001)
    steps.span("dispatch", t + 0.001, t + 0.0011, {"step": 4})
    steps.instant("resolve", t + 0.0025, {"step": 4})
    tracer = T.SessionTracer("s", ctl, ring_frames=4)
    ft = tracer.mint()
    ft.add_span("ingest", t - 0.002, t)
    ft.step = 4
    tracing = SimpleNamespace(steps=steps, tracers=[SimpleNamespace(kept=[ft])])
    profile = SimpleNamespace(clock=cm, records=lambda: records)
    sp = SP.collect(tracing, profile)
    lo, hi = sp["settled"]
    assert (lo, hi) == (us - 100_000.0, us + 201_000.0)
    (name, d0, d1, args), = [d for d in sp["dispatcher"] if d[0] == "dispatch"]
    assert (d0, d1, args["step"]) == (pytest.approx(us + 1000.0), pytest.approx(us + 1100.0), 4)
    assert sp["resolves"][4] == pytest.approx(us + 2500.0)
    assert sp["epilogues"] == [(us + 2000.0, us + 2200.0)]
    assert sp["frames"][0]["step"] == 4
    assert sp["frames"][0]["spans"] == [("ingest", pytest.approx(us - 2000.0), pytest.approx(us))]
    assert sp["idle"][0] == (lo, us + 1000.0)
    ctx = {"spans": sp}
    assert read("resolve_lag_ms_p50", ctx) == pytest.approx(0.3)
    assert read("ingest_ms_p50", ctx) == pytest.approx(2.0)
    # idle under hold.depth: from the pair (us) to the first kernel, 1000 us;
    # the dispatch runs beside that kernel
    assert read("idle_queued_share", ctx) == pytest.approx(100.0 * 1000.0 / (hi - lo), rel=1e-3)
    assert "dispatcher covers" in SP.summary(ctx)
    assert SP.collect(tracing, SimpleNamespace(clock=None, records=lambda: records)) is None
    assert SP.collect(None, profile) is None


def test_spanrun_wires_the_tracers_into_a_cpu_run_and_undoes_it():
    from ai_rtc_agent_tpu_torch.server import tracks

    from benchmark import camera as CAM
    from benchmark import harness
    from benchmark import run as R
    from benchmark import spanrun
    from benchmark import trace as TR

    before = (CAM.CameraFrame, tracks.VideoStreamTrack, TR.Profiler, harness.serve,
              R.metrics_of, R.reader)
    traffic = _tiny.traffic()
    with spanrun.spans_on(traffic, traced=False) as tracing:
        res = R.run_cell(_tiny.BENCH.parent, _tiny.WORKLOAD, {"chips": 1}, _tiny.config(),
                         traffic, _tiny.metrics(False), 2**32 + 5, 1.5, False, "cpu")
    assert (CAM.CameraFrame, tracks.VideoStreamTrack, TR.Profiler, harness.serve,
            R.metrics_of, R.reader) == before
    assert res["correct"] is True and res["metrics"]["served_fps"]["value"] > 0
    disp = {a["step"]: a for n, _, _, a in tracing.steps.ring if n == "dispatch"}
    assert disp and {n for n, *_ in tracing.steps.ring} >= {"dispatch", "resolve", "hold.empty"}
    kept = [tr for t in tracing.tracers for tr in t.kept]
    rode = [tr for tr in kept if tr.step is not None]
    assert rode and all(tr.step in disp for tr in rode)
    names = {n for tr in rode for n, *_ in tr.spans}
    assert {"ingest", "submit", "submit.coerce", "submit.pin", "submit.copy", "submit.enqueue",
            "batch_join", "engine_step", "fetch"} <= names
    # the traced run's metrics gain the span readers; others stay as they are
    with spanrun.spans_on(traffic, traced=True):
        bench = {"per_layer": [{"name": "slots_filled"}], "end_to_end": [{"name": "served_fps"}]}
        assert [m["name"] for m in R.metrics_of(bench, "x", True)] == [
            "slots_filled", "idle_queued_share", "resolve_lag_ms_p50", "submit_copy_ms_p50",
            "ingest_ms_p50"]
        assert [m["name"] for m in R.metrics_of(bench, "x", False)] == ["served_fps"]


def test_spanrun_leaves_a_program_without_tracers_alone(monkeypatch):
    from ai_rtc_agent_tpu_torch.obs import trace as T

    from benchmark import run as R
    from benchmark import spanrun

    monkeypatch.delattr(T, "StepTracer")
    reader = R.reader
    with spanrun.spans_on(_tiny.traffic(), traced=True) as tracing:
        assert tracing is None and R.reader is reader


def test_new_metrics_have_readers_and_entries():
    import json

    bench = json.loads((_tiny.BENCH.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    from benchmark import spanrun

    for name in NEW:
        assert (METRICS / f"{name}.py").exists()
    for m in spanrun.SPAN_METRICS:
        assert m["name"] in NEW and m["name"] not in entries  # read by spanrun only
    for name in ("hold_depth_ms_per_step", "hold_window_ms_per_step"):
        assert entries[name]["layer"] == entries["slots_filled"]["layer"]
        assert entries[name]["workloads"] == entries["slots_filled"]["workloads"]
