"""The batch scheduler's own spans and counters (stream/scheduler.py through
obs/trace.py's StepTracer), on a tiny-test scheduler on the CPU.

* Each wait of the dispatcher is held to its reason: a window running with
  one of two sessions fed (``hold.window``), two steps unfetched
  (``hold.depth``); the always-on ``batchsched_hold_ms_total`` counts the
  same waits, and ``batchsched_dispatch_ms_total`` each step's dispatch.
* Each ``dispatch`` span carries the step id, the bucket, the riders'
  slots, the variant and warm; a frame that rode the step names it, its
  ``batch_join`` ends where the dispatch starts, and the step's first
  readback resolve is a ``resolve`` instant with the same id.
* A traced frame's ``submit`` holds ``submit.coerce``, ``submit.pin``,
  ``submit.copy`` and ``submit.enqueue``, in order, inside it.
* Tracing off (no tracer, or a tracer whose window is closed): nothing is
  minted or stamped, and the hold counters still count.
* ``batchsched_occupancy_p50`` / ``_max`` come from the occupancy histogram
  and read what the 512-step deque they replace gave, under 512 steps.
* The agent hands its scheduler the flight recorder's StepTracer, and a
  session capture carries the dispatcher's entries.
"""

import random
import threading
import time

import numpy as np
import pytest

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.obs import trace as T
from ai_rtc_agent_tpu_torch.obs.recorder import FlightRecorder
from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

FRAME = np.zeros((64, 64, 3), np.uint8)


@pytest.fixture(scope="module")
def bundle():
    return PREG.load_model_bundle("tiny-test", device="cpu")


def _sched(bundle, **kw):
    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    kw.setdefault("prewarm", False)
    return BatchScheduler(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt,
                          device="cpu", **kw)


def _traced(sched):
    """A StepTracer on an open window, handed to ``sched``; and a session
    tracer on the same controller."""
    ctl = T.TraceController()
    ctl.enabled = True
    sched.tracer = T.StepTracer(ctl)
    return sched.tracer, T.SessionTracer("s", ctl, ring_frames=64)


class Frame:
    """A frame type that carries a trace (the track's tracer hangs it on)."""

    def __init__(self):
        self.trace = None

    def to_ndarray(self, format="rgb24"):  # noqa: A002
        return FRAME


def _spans(tracer, name):
    return [e for e in tracer.ring if e[0] == name]


def _wait_for(pred, what, timeout_s=30.0):
    t = time.monotonic()
    while not pred():
        assert time.monotonic() - t < timeout_s, f"no {what} within {timeout_s} s"
        time.sleep(0.01)


def test_window_hold_span_and_counter(bundle):
    """Two live sessions, one fed: the dispatcher waits out the window with
    a frame queued (hold.window, ~the window long), and counts it."""
    s = _sched(bundle, max_sessions=2, window_ms=300.0)
    try:
        steps, _ = _traced(s)
        a = s.claim("a")
        s.claim("b")
        before = s.snapshot()["batchsched_hold_ms_total"]["window"]
        h = a.submit(FRAME)
        a.fetch(h)
        held = s.snapshot()["batchsched_hold_ms_total"]["window"] - before
        assert 250.0 <= held < 5000.0, held
        spans = _spans(steps, "hold.window")
        assert spans and 0.25 <= sum(t1 - t0 for _, t0, t1, _ in spans) < 5.0
        disp = _spans(steps, "dispatch")[-1]
        assert spans[-1][2] <= disp[1]  # the window ends before the step is dispatched
    finally:
        s.close()


def test_depth_hold_span_and_counter(bundle):
    """Two steps dispatched and unfetched: the third frame waits on
    PIPELINE_DEPTH (hold.depth) until a fetch resolves one; the counter
    counts the same wait."""
    s = _sched(bundle, max_sessions=2, fetch_timeout=20.0)
    try:
        steps, _ = _traced(s)
        a = s.claim("a")
        held = [a.submit(FRAME) for _ in range(BatchScheduler.PIPELINE_DEPTH)]
        for h in held:
            h.future.result(timeout=20.0)  # dispatched, not fetched
        before = s.snapshot()["batchsched_hold_ms_total"]["depth"]
        third = a.submit(FRAME)
        time.sleep(0.3)
        assert not third.future.done()  # held at depth
        a.fetch(held[0])
        a.fetch(third)
        a.fetch(held[1])
        counted = s.snapshot()["batchsched_hold_ms_total"]["depth"] - before
        assert counted >= 250.0, counted
        spans = _spans(steps, "hold.depth")
        assert spans and sum(t1 - t0 for _, t0, t1, _ in spans) >= 0.25
    finally:
        s.close()


def test_dispatch_span_names_the_step_its_frames_rode(bundle):
    """Each dispatch span carries step id, bucket, slots (the cohort),
    variant and warm; a frame that rode it names the step, its batch_join
    ends at the dispatch's start, its engine_step starts there, and the
    step's first resolve is an instant with the same id."""
    s = _sched(bundle, max_sessions=2, window_ms=500.0)
    try:
        steps, tracer = _traced(s)
        a, b = s.claim("a"), s.claim("b")
        fa, fb = Frame(), Frame()
        tracer.attach(fa), tracer.attach(fb)
        ha, hb = a.submit(fa), b.submit(fb)
        a.fetch(ha, fa), b.fetch(hb, fb)
        (disp,) = [e for e in _spans(steps, "dispatch") if e[3]["slots"] == [a.slot, b.slot]]
        args = disp[3]
        assert args["k"] == 2 and args["variant"] == "full" and args["warm"] is False
        assert fa.trace.step == fb.trace.step == args["step"]
        for fr in (fa, fb):
            sp = {n: (t0, t1) for n, t0, t1 in fr.trace.spans}
            assert sp["batch_join"][1] == disp[1] == sp["engine_step"][0]
            assert sp["engine_step"][1] >= disp[2]
        resolves = [e for e in steps.ring if e[0] == "resolve" and e[3]["step"] == args["step"]]
        assert len(resolves) == 1 and resolves[0][2] is None and resolves[0][1] >= disp[2]
        # step ids count up, one a dispatch
        ids = [e[3]["step"] for e in _spans(steps, "dispatch")]
        assert ids == sorted(ids) and len(set(ids)) == len(ids)
        total = s.snapshot()["batchsched_dispatch_ms_total"]
        assert total >= 1e3 * sum(t1 - t0 for _, t0, t1, _ in _spans(steps, "dispatch")) - 1e-3
    finally:
        s.close()


def test_submit_children_nest_inside_submit(bundle):
    s = _sched(bundle, max_sessions=1)
    try:
        _, tracer = _traced(s)
        a = s.claim("a")
        f = Frame()
        tracer.attach(f)
        a.fetch(a.submit(f), f)
        spans = f.trace.spans
        kids = [(n, t0, t1) for n, t0, t1 in spans if n.startswith("submit.")]
        assert [n for n, _, _ in kids] == ["submit.coerce", "submit.pin", "submit.copy",
                                           "submit.enqueue"]
        (_, s0, s1), = [x for x in spans if x[0] == "submit"]
        assert all(s0 <= t0 <= t1 <= s1 for _, t0, t1 in kids)
        assert all(kids[i][2] <= kids[i + 1][1] for i in range(3))  # one after another
    finally:
        s.close()


@pytest.mark.parametrize("how", ["no_tracer", "window_closed"])
def test_tracing_off_stamps_nothing_but_the_counters_count(bundle, how):
    s = _sched(bundle, max_sessions=2, window_ms=100.0)
    try:
        ctl = T.TraceController()
        ctl.stop()
        steps = T.StepTracer(ctl)
        if how == "window_closed":
            s.tracer = steps
        tracer = T.SessionTracer("s", ctl, ring_frames=8)
        a = s.claim("a")
        s.claim("b")
        f = Frame()
        assert tracer.attach(f) is None and f.trace is None
        a.fetch(a.submit(f), f)
        assert f.trace is None and not steps.ring and not tracer.ring
        snap = s.snapshot()
        assert snap["batchsched_hold_ms_total"]["window"] > 50.0
        assert snap["batchsched_hold_ms_total"]["empty"] > 0.0
        assert snap["batchsched_dispatch_ms_total"] > 0.0
        assert set(snap["batchsched_hold_ms_total"]) == set(T.HOLD_REASONS)
    finally:
        s.close()


SEQUENCES = {
    "one": [3],
    "even": [1, 2, 3, 4],
    "skewed": [1] * 7 + [4] * 2 + [2],
    **{f"seed{k}": [random.Random(k).randint(1, 8) for _ in range(random.Random(k).randint(1, 511))]
       for k in range(4)},
}


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("name", list(SEQUENCES))
def test_occupancy_gauges_read_from_the_histogram(bundle, name, dp):
    """p50 and max of the occupancy from its histogram: what the sorted
    512-step deque gave, for a fixed sequence of fewer than 512 steps (on a
    dp mesh too, whose snapshot also counts sessions a shard)."""
    seq = SEQUENCES[name]
    hist: dict = {}
    for n in seq:
        hist[n] = hist.get(n, 0) + 1
    want_p50 = BatchScheduler._percentile(sorted(seq), 0.5)
    assert BatchScheduler._hist_percentile(hist, 0.5) == want_p50
    s = _sched(bundle, max_sessions=2, dp=dp, devices=["cpu"] * dp)
    try:
        s._occ_hist = hist
        snap = s.snapshot()
        assert snap["batchsched_occupancy_p50"] == want_p50
        assert snap["batchsched_occupancy_max"] == max(seq)
    finally:
        s.close()


def test_occupancy_gauges_after_real_steps(bundle):
    s = _sched(bundle, max_sessions=2)
    try:
        assert "batchsched_occupancy_p50" not in s.snapshot()
        a = s.claim("a")
        for _ in range(3):
            a(FRAME)
        snap = s.snapshot()
        assert snap["batchsched_occupancy_hist"] == {"1": 3}
        assert (snap["batchsched_occupancy_p50"], snap["batchsched_occupancy_max"]) == (1, 1)
    finally:
        s.close()


def test_flight_recorder_hands_its_step_ring_to_captures(bundle):
    """The recorder's StepTracer shares its controller, so a /debug/trace
    window flips it; a session capture carries the dispatcher's entries
    from its first frame on."""
    flight = FlightRecorder()
    s = _sched(bundle, max_sessions=1)
    try:
        s.tracer = flight.steps
        rec = flight.register("sess")
        a = s.claim("sess")
        f = Frame()
        assert rec.tracer.attach(f) is None  # window closed: nothing
        a.fetch(a.submit(f), f)
        assert not flight.steps.ring and "steps" not in rec.snapshot()
        flight.controller.start(30.0)
        f = Frame()
        rec.tracer.attach(f)
        a.fetch(a.submit(f), f)
        f.trace.finish("sent")
        _wait_for(lambda: any(e[0] == "resolve" for e in flight.steps.ring), "resolve")
        snap = rec.snapshot()
        names = {e[0] for e in snap["steps"]}
        assert {"dispatch", "resolve"} <= names
        assert snap["frames"][0]["step"] in {e[3]["step"] for e in snap["steps"]
                                             if e[0] == "dispatch"}
    finally:
        flight.controller.stop()
        s.close()


def test_step_ring_is_bounded_and_thread_safe():
    ctl = T.TraceController()
    ctl.enabled = True
    steps = T.StepTracer(ctl, ring=100)
    threads = [threading.Thread(target=lambda: [steps.span("dispatch", 0.0, 1.0, {"step": i})
                                                for i in range(1000)]) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(steps.ring) == 100 and len(steps.snapshot()) == 100


# -- the clock: obs stamps onto a profiler's time base ----------------------------------

def test_clock_map_with_synthetic_bases():
    """A host stamp lands at host - host_ns + wall_ns - base_ns (us); the
    ~1e18 ns wall readings cost no precision."""
    wall, host = 1_792_349_303_157_626_558, 5_000_000_000_123
    cm = T.ClockMap(host_ns=host, wall_ns=wall, base_ns=wall - 2_000_000_000)
    assert cm.to_device_us(host / 1e9) == pytest.approx(2_000_000.0, abs=1e-3)
    assert cm.to_device_us(host / 1e9 + 0.25) == pytest.approx(2_250_000.0, abs=1e-3)
    # against another zero: the same pair, moved by the difference
    other = cm.bind(wall - 1_000_000)
    assert other.to_device_us(host / 1e9) == pytest.approx(1_000.0, abs=1e-3)
    assert (other.host_ns, other.wall_ns, other.base_ns) == (host, wall, wall - 1_000_000)
    # a read pairs the two clocks: a stamp taken now is now on the wall clock
    got = T.ClockMap.read()
    t, w = T.clock(), time.time_ns()
    assert abs(got.bind(0).to_device_us(t) * 1e3 - w) < 5e6  # within 5 ms
    assert T.profiler_base_ns(object()) is None


def test_clock_map_lines_up_a_cpu_profiler_op():
    """On the CPU profiler (host events, the clock kineto converts the
    card's to as well): an op timed on the obs clock lands inside its host
    span on the profiler's time base."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(256, 256)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    cm = T.ClockMap.read()
    t0 = T.clock()
    a @ a
    t1 = T.clock()
    prof.stop()
    cm = cm.bind(T.profiler_base_ns(prof))
    (ev,) = [e for e in prof.events() if e.name == "aten::mm"]
    assert cm.to_device_us(t0) - 50 <= ev.time_range.start
    assert ev.time_range.end <= cm.to_device_us(t1) + 50


def _frame_snapshot(t0):
    return {"session": "s", "reason": "r", "events": [], "frames": [
        {"frame_id": 1, "session": "s", "born": t0, "terminal": "sent", "step": 7,
         "spans": [["submit", t0, t0 + 0.001], ["batch_join", t0 + 0.001, t0 + 0.002],
                   ["engine_step", t0 + 0.002, t0 + 0.030]], "marks": []}],
        "steps": [["hold.window", t0 + 0.001, t0 + 0.002, None],
                  ["dispatch", t0 + 0.002, t0 + 0.004, {"step": 7, "k": 1, "slots": [0],
                                                        "variant": "full", "warm": True}],
                  ["resolve", t0 + 0.029, None, {"step": 7}]]}


def test_merged_profiler_trace_puts_the_kernel_inside_its_frames_engine_step():
    """A profiler window's Chrome trace (ts in us from baseTimeNanoseconds)
    and a capture merged onto its time base: a synthetic kernel that ran
    10-25 ms after the frame's dispatch sits inside the frame's engine_step;
    the dispatcher's track and the frame carry the step id."""
    from ai_rtc_agent_tpu_torch.obs import export as E

    host, wall = 7_000_000_000_000, 1_792_000_000_000_000_000
    base = 1_790_000_000_000_000_000
    cm = T.ClockMap(host, wall)
    t0 = host / 1e9 + 1.0  # the frame's submit, 1 s after the pair
    k0 = (wall - base) / 1e3 + 1e6 + 12_000.0  # the kernel, 12 ms after submit
    doc = {"baseTimeNanoseconds": base, "traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "flash_attention_kernel", "pid": 0, "tid": 7,
         "ts": k0, "dur": 5_000.0}]}
    merged = E.merge_profiler_trace(_frame_snapshot(t0), doc, cm)
    evs = merged["traceEvents"]
    (kernel,) = [e for e in evs if e.get("cat") == "kernel"]
    (step,) = [e for e in evs if e.get("name") == "engine_step" and e.get("ph") == "X"]
    assert step["ts"] <= kernel["ts"] and kernel["ts"] + kernel["dur"] <= step["ts"] + step["dur"]
    assert step["args"]["step"] == 7 and merged["baseTimeNanoseconds"] == base
    disp = [e for e in evs if e.get("cat") == "dispatcher"]
    assert [e["name"] for e in disp] == ["hold.window", "dispatch", "resolve"]
    assert disp[1]["args"]["step"] == 7 and disp[2]["ph"] == "i"
    assert disp[1]["ts"] == step["ts"]  # the dispatch starts the frame's engine_step
    # without a clock the capture keeps its own zero (its first stamp at 0)
    own = E.to_chrome_trace(_frame_snapshot(t0))
    assert min(e["ts"] for e in own["traceEvents"] if "ts" in e) == 0.0


def test_profiler_bridge_binds_its_clock_to_the_written_trace(tmp_path):
    """The bridge reads a ClockMap at the open and binds it at the close to
    the trace file's own baseTimeNanoseconds, which the capture's Chrome
    rendering then shares (the bridge's ops are on its own thread; the
    alignment itself is the merge test's and the card's)."""
    import json

    from ai_rtc_agent_tpu_torch.obs import export as E

    t0 = T.clock()
    assert E.start_profiler_bridge(str(tmp_path)) is None
    t1 = T.clock()
    assert E.stop_profiler_bridge() is None
    doc = json.loads(open(E.last_trace_path).read())
    cm = E.last_clock
    assert cm.base_ns == E.chrome_base_ns(E.last_trace_path) == int(
        doc.get("baseTimeNanoseconds", 0))
    assert t0 <= cm.host_ns / 1e9 <= t1
    snap = _frame_snapshot(t1)
    got = E.to_chrome_trace(snap, clock=cm)
    (sub,) = [e for e in got["traceEvents"] if e.get("name") == "submit"]
    assert sub["ts"] == round(cm.to_device_us(t1), 1)
