"""The port's resilience modules (ai_rtc_agent_tpu_torch/resilience/: retry,
faults, supervisor, overload) against the JAX package's, on the CPU.

Each script drives one module's classes through the same inputs, scripted
clock, seeded rng and fault plan, and returns a transcript: delays, states,
transitions, shed counts, Retry-After values, snapshots.  The port's
transcript must equal the JAX one.  Clocks and sleeps are injected, so no
script waits on the wall clock except the supervisor's step budgets, which
are tens of milliseconds.  The cases mirror tests/test_resilience_retry.py,
_faults.py, _supervisor.py and tests/test_overload.py.
"""

import asyncio
import json
import random
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.resilience import faults as JF
from ai_rtc_agent_tpu.resilience import overload as JO
from ai_rtc_agent_tpu.resilience import retry as JR
from ai_rtc_agent_tpu.resilience import supervisor as JS
from ai_rtc_agent_tpu_torch.resilience import faults as PF
from ai_rtc_agent_tpu_torch.resilience import overload as PO
from ai_rtc_agent_tpu_torch.resilience import retry as PR
from ai_rtc_agent_tpu_torch.resilience import supervisor as PS

SIDES = {
    "jax": SimpleNamespace(retry=JR, faults=JF, sup=JS, ov=JO),
    "port": SimpleNamespace(retry=PR, faults=PF, sup=PS, ov=PO),
}


@pytest.fixture(autouse=True)
def no_fault_plan():
    for m in SIDES.values():
        m.faults.deactivate()
    yield
    for m in SIDES.values():
        m.faults.deactivate()


class Clock:
    """A scripted monotonic clock; ``sleep`` advances it."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


def _both(script, *args):
    got = {name: script(m, *args) for name, m in SIDES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


# -- retry ------------------------------------------------------------------------------

POLICIES = [
    dict(attempts=5),
    dict(attempts=6, base_delay_s=0.1, max_delay_s=0.5, jitter=0.0),
    dict(attempts=8, full_jitter=True),
    dict(attempts=None, deadline_s=3.0, base_delay_s=1.0, multiplier=1.0, jitter=0.0),
    dict(attempts=4, multiplier=3.0, jitter=0.25),
]


def retry_delays(m, kw):
    gen = m.retry.RetryPolicy(**kw).delays(random.Random(11))
    return [round(next(gen), 12) for _ in range(10)]


def retry_run(m, kw):
    """fn fails 3 times, then returns; the sleeps, the retries observed and
    the result (or the exhaustion's message and last error)."""
    clock, calls, seen = Clock(), [0], []

    def fn():
        calls[0] += 1
        if calls[0] <= 3:
            raise OSError(f"down {calls[0]}")
        return "up"

    sleeps = []

    def sleep(d):
        sleeps.append(round(d, 12))
        clock.sleep(d)

    try:
        out = m.retry.RetryPolicy(**kw).run(
            fn, retry_on=(OSError,), sleep=sleep, clock=clock, rng=random.Random(5),
            on_retry=lambda i, e, d: seen.append((i, str(e), round(d, 12))), label="svc")
    except m.retry.RetryError as e:
        out = ("exhausted", str(e), str(e.last))
    return out, sleeps, seen, calls[0]


def retry_default_and_filter(m, kw):
    """A default instead of raising; an exception outside retry_on escapes
    at once."""
    p = m.retry.RetryPolicy(**kw)
    fails = lambda: (_ for _ in ()).throw(OSError("x"))  # noqa: E731
    clock = Clock()
    got = [p.run(fails, sleep=clock.sleep, clock=clock, rng=random.Random(1), default="dflt")]
    with pytest.raises(KeyError):
        p.run(lambda: {}["k"], retry_on=(OSError,), sleep=lambda d: None)
    return got


def retry_async(m, kw):
    calls = [0]

    async def fn():
        calls[0] += 1
        if calls[0] < 3:
            raise OSError("again")
        return calls[0]

    policy = m.retry.RetryPolicy(**dict(kw, base_delay_s=0.001, max_delay_s=0.002))
    try:
        return asyncio.run(policy.arun(fn, retry_on=(OSError,), rng=random.Random(3)))
    except m.retry.RetryError as e:
        return "exhausted", str(e)


def retry_shapes(m):
    out = [m.retry.poll_policy(12.0, 0.5), m.retry.transient_policy(4, 0.2)]
    for bad in (dict(attempts=0), dict(attempts=None)):
        with pytest.raises(ValueError) as e:
            m.retry.RetryPolicy(**bad)
        out.append(str(e.value))
    return [repr(o) if not isinstance(o, str) else o for o in out]


@pytest.mark.parametrize("script", [retry_delays, retry_run, retry_default_and_filter,
                                    retry_async])
@pytest.mark.parametrize("kw", POLICIES, ids=[str(i) for i in range(len(POLICIES))])
def test_retry_matches_jax(script, kw):
    _both(script, kw)


def test_retry_shapes_match_jax():
    _both(retry_shapes)


# -- faults -----------------------------------------------------------------------------

PLAN = {"seed": 7, "faults": [
    {"target": "rx", "kind": "drop", "p": 0.3, "start": 5, "stop": 60},
    {"target": "rx", "kind": "dup", "p": 0.1},
    {"target": "rx", "kind": "reorder", "p": 0.15},
    {"target": "rx", "kind": "delay", "p": 0.2, "delay_s": 0.05},
    {"target": "rx", "kind": "truncate", "p": 0.05, "keep": 4},
    {"target": "tx", "kind": "loss_burst", "period": 10, "burst": 3, "start": 20, "stop": 80},
    {"target": "engine", "kind": "slow_step", "start": 2, "stop": 4, "delay_s": 3.0},
    {"target": "engine", "kind": "nan", "start": 5, "stop": 7},
    {"target": "engine", "kind": "device_lost", "start": 9, "stop": 10},
    {"target": "engine", "kind": "slow_step", "p": 0.5, "start": 11, "delay_s": 0.5},
]}


def faults_plan(m):
    plan = m.faults.FaultPlan.from_json(json.dumps(PLAN))
    return [repr(s) for s in plan.specs], plan.seed, [len(plan.for_target(t)) for t in
                                                     ("rx", "tx", "engine")]


BAD_SPECS = [
    {"target": "disk", "kind": "drop"},
    {"target": "rx", "kind": "slow_step"},
    {"target": "engine", "kind": "drop"},
    {"target": "rx", "kind": "drop", "p": 1.5},
    {"target": "rx", "kind": "loss_burst", "period": 0},
    {"target": "rx", "kind": "loss_burst", "period": 4, "burst": 5},
]


def faults_bad_specs(m):
    out = []
    for spec in BAD_SPECS:
        with pytest.raises(ValueError) as e:
            m.faults.FaultPlan.from_dict({"faults": [spec]})
        out.append(str(e.value))
    with pytest.raises(ValueError):
        m.faults.scope("disk")
    return out


def faults_net(m):
    """Every rx and tx decision over 120 datagrams replays."""
    m.faults.activate(m.faults.FaultPlan.from_dict(PLAN))
    out = []
    for target in ("rx", "tx"):
        sc = m.faults.scope(target)
        got = [sc.apply(bytes([i % 256]) * 12) for i in range(120)]
        out.append((got, sc.stats))
    return out


def faults_engine(m):
    """The engine scope's actions per step (slow steps recorded, not slept),
    DeviceLostError at its step, the nan window."""
    m.faults.activate(m.faults.FaultPlan.from_dict(PLAN))
    sc = m.faults.scope("engine")
    slept = []
    sc._sleep = slept.append
    actions = []
    for _ in range(40):
        try:
            actions.append(sc.step())
        except m.faults.DeviceLostError as e:
            actions.append(f"lost: {e}")
    # a second scope of the same plan draws another (seeded) stream
    sc2 = m.faults.scope("engine")
    sc2._sleep = slept.append
    actions2 = []
    for _ in range(30):
        try:
            actions2.append(sc2.step())
        except m.faults.DeviceLostError:
            actions2.append("lost")
    return actions, actions2, slept, sc.stats, m.faults.scope("rx") is not None


def faults_wedge(m):
    """A wedge holds the stepping thread until release_wedge; a released
    wedge stays open for the plan; deactivate frees a held step."""
    m.faults.activate(m.faults.FaultPlan.from_dict(
        {"faults": [{"target": "engine", "kind": "wedge", "start": 0, "stop": 2}]}))
    sc = m.faults.scope("engine")
    got, done = [], threading.Event()
    t = threading.Thread(target=lambda: (got.append(sc.step()), done.set()))
    t.start()
    held = not done.wait(0.1)
    m.faults.release_wedge()
    t.join(5)
    got.append(sc.step())  # the released wedge stays open
    m.faults.activate(m.faults.FaultPlan.from_dict(
        {"faults": [{"target": "engine", "kind": "wedge"}]}))
    sc = m.faults.scope("engine")
    t = threading.Thread(target=lambda: got.append(sc.step()))
    t.start()
    m.faults.deactivate()
    t.join(5)
    return held, got, m.faults.scope("engine"), m.faults.active()


def faults_env(m, monkeypatch, tmp_path):
    out = []
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(PLAN))
    for raw in (json.dumps(PLAN), f"@{path}", "{not json", "@/nonexistent/plan.json", ""):
        m.faults.deactivate()
        monkeypatch.setenv("FAULT_PLAN", raw)
        m.faults._install_from_env()
        plan = m.faults.active()
        out.append(None if plan is None else (len(plan.specs), plan.seed))
    return out


@pytest.mark.parametrize("script", [faults_plan, faults_bad_specs, faults_net, faults_engine,
                                    faults_wedge])
def test_faults_match_jax(script):
    _both(script)


def test_fault_plan_env_matches_jax(monkeypatch, tmp_path):
    _both(faults_env, monkeypatch, tmp_path)


# -- supervisor ---------------------------------------------------------------------------

def _sup(m, clock, **kw):
    """A supervisor on the scripted clock whose restarts run at once; its
    transitions are recorded (without the clock)."""
    log = []
    kw.setdefault("restart", lambda: log.append("restart"))
    sup = m.sup.SessionSupervisor(
        "s1", clock=clock, sleep=clock.sleep, stall_after_s=2.0, probe_interval_s=1.0,
        restart_backoff_s=0.25, on_transition=lambda a, b, r: log.append((a, b, r)), **kw)
    return sup, log


def _settle(sup):
    for _ in range(500):
        if not sup.recovery_pending:
            return
        threading.Event().wait(0.002)
    raise AssertionError("restart did not settle")


def _view(sup):
    snap = sup.snapshot()
    snap.pop("since_s")
    snap["transitions"] = [{k: v for k, v in t.items() if k != "t"} for t in snap["transitions"]]
    return snap


def sup_stall_and_recover(m):
    clock = Clock()
    sup, log = _sup(m, clock)
    sup.note_frame_out(processed=True)
    sup.on_stall("engine step exceeded 5.0s")
    _settle(sup)
    views = [_view(sup)]
    for _ in range(3):
        clock.sleep(0.1)
        sup.on_step_ok(0.01)
        sup.note_frame_out(processed=True)
    views.append(_view(sup))
    return log, views


def sup_error_burst_and_device_lost(m):
    clock = Clock()
    sup, log = _sup(m, clock, error_burst=3)
    sup.on_step_error(RuntimeError("once"))
    sup.on_step_error(RuntimeError("twice"))
    sup.on_step_ok()
    sup.on_step_error(RuntimeError("again"))
    states = [sup.state]
    sup.on_step_error(m.faults.DeviceLostError("halt"))
    _settle(sup)
    return log, states, _view(sup)


def sup_restart_budget(m):
    """Restarts that keep failing spend the budget: FAILED, and the gate
    refuses the engine from then on."""
    clock = Clock()

    def restart():
        raise RuntimeError("engine gone")

    sup, log = _sup(m, clock, restart=restart, max_restarts=2)
    sup.on_stall("wedged")
    _settle(sup)
    return log, _view(sup), sup.should_try_engine(), sup.may_finish_inflight()


def sup_probes_watchdog_overload(m):
    """DEGRADED without a restart probes on the interval; the output-age
    watchdog degrades an idle stream and resyncs; the overload hold keeps
    probes from walking it out until cleared."""
    clock = Clock()
    resyncs = []
    sup, log = _sup(m, clock, restart=None, resync=lambda: resyncs.append(clock.t))
    out = [sup.check()]
    sup.note_frame_out(processed=True)
    clock.sleep(2.5)
    out.append(sup.check())
    gates = []
    for _ in range(6):
        gates.append(sup.should_try_engine())
        clock.sleep(0.4)
    sup.on_step_ok()
    sup.note_overload("overload shedding: passthrough")
    for _ in range(4):
        sup.on_step_ok()
    out.append(sup.state)
    sup.note_overload_clear()
    for _ in range(4):
        sup.on_step_ok()
    out.append(sup.state)
    return log, out, gates, resyncs, m.sup.worst_state(["HEALTHY", "RECOVERING", "DEGRADED"])


class _Engine:
    """A pipeline stand-in: inverts frames; ``hold`` blocks a call until set;
    ``nan`` makes the next call a float array of NaNs; ``shed`` returns a
    ShedFrame."""

    owns_step_signal = False

    def __init__(self, m):
        self.m, self.hold, self.mode, self.restarts = m, None, None, 0

    def __call__(self, frame):
        if self.hold is not None:
            self.hold.wait(5)
        mode, self.mode = self.mode, None
        if mode == "nan":
            return np.full(frame.shape, np.nan, np.float32)
        if mode == "shed":
            return self.m.ov.ShedFrame(frame)
        if mode == "error":
            raise RuntimeError("step failed")
        return 255 - frame

    def submit(self, frame):
        return frame

    def fetch(self, handle, src=None):
        return self(handle)

    def submit_batch(self, frames):
        return list(frames)

    def fetch_batch(self, handles, srcs=None):
        return [self(f) for f in handles]

    def restart(self):
        self.restarts += 1

    def update_prompt(self, p):
        self.prompt = p


def _frame(v):
    return np.full((4, 4, 3), v, np.uint8)


def sup_resilient_pipeline(m):
    """Healthy steps, a stalled step (passthrough of the source frame, a
    background restart, RECOVERING), a NaN output and a shed (passthrough,
    counted), the pipelined surface and fetch_batch with a shed position,
    then HEALTHY again; the control plane passes through."""
    eng = _Engine(m)
    sup = m.sup.SessionSupervisor("s1", stall_after_s=60.0, probe_interval_s=0.0,
                                  restart_backoff_s=0.0, sleep=lambda d: None)
    rp = m.sup.ResilientPipeline(eng, sup, step_timeout_s=0.05, first_step_timeout_s=0.05,
                                 warm_steps=0)
    out = []
    out.append(int(rp(_frame(10))[0, 0, 0]))
    eng.hold = threading.Event()
    held = rp._runner
    out.append(int(rp(_frame(20))[0, 0, 0]))  # passthrough: the source pixels
    eng.hold.set()
    held._thread.join(5)  # the abandoned step finishes before the next mode
    eng.hold = None
    _settle(sup)
    out.append((sup.state, eng.restarts))
    eng.mode = "nan"
    out.append(int(rp(_frame(30))[0, 0, 0]))
    eng.mode = "shed"
    out.append(int(rp(_frame(40))[0, 0, 0]))
    h = rp.submit(_frame(50))
    out.append(int(rp.fetch(h)[0, 0, 0]))
    eng.mode = "error"
    out.append(int(rp.fetch(rp.submit(_frame(60)))[0, 0, 0]))
    hb = rp.submit_batch([_frame(70), _frame(80)])
    out.append([int(o[0, 0, 0]) for o in rp.fetch_batch(hb)])
    for v in (90, 100, 110):
        out.append(int(rp(_frame(v))[0, 0, 0]))
    rp.update_prompt("p")
    out.append((eng.prompt, sup.state, sup.processed_frames, sup.passthrough_frames))
    out.append([(a, b) for _, a, b, _ in sup.transitions])
    rp.close()
    return out


def sup_throttle_and_step_feed(m):
    """The overload ladder gates frames before the engine; steady steps feed
    the admission EWMA, warm-up steps and owns_step_signal pipelines do not;
    a blown budget feeds it doubled."""
    out = []
    for owns in (False, True):
        clock = Clock()
        adm = m.ov.AdmissionController(step_budget_s=1.0, clock=clock)
        eng = _Engine(m)
        eng.owns_step_signal = owns
        sup = m.sup.SessionSupervisor("s", probe_interval_s=0.0, sleep=lambda d: None)
        ladder = m.ov.OverloadLadder("s", adm, sup, clock=clock)
        rp = m.sup.ResilientPipeline(eng, sup, step_timeout_s=0.05, warm_steps=2)
        rp.throttle = ladder
        for v in range(5):
            rp(_frame(v))
        out.append((adm.step_ewma.samples, owns))
        ladder.rung = 1  # skip2: every other frame passes through
        out.append([int(rp(_frame(200))[0, 0, 0]) for _ in range(4)])
        ladder.rung = 0
        eng.hold = threading.Event()
        held = rp._runner
        rp(_frame(1))  # blows the budget: the runner is abandoned
        eng.hold.set()
        held._thread.join(5)
        out.append((adm.step_ewma.samples, sup.state, rp._runner is not held))
        rp.close()
    return out


@pytest.mark.parametrize("script", [sup_stall_and_recover, sup_error_burst_and_device_lost,
                                    sup_restart_budget, sup_probes_watchdog_overload,
                                    sup_resilient_pipeline, sup_throttle_and_step_feed])
def test_supervisor_matches_jax(script):
    _both(script)


# -- overload -------------------------------------------------------------------------------

def ov_deadline_queue(m):
    clock = Clock()
    evicted, shed = [], []
    q = m.ov.DeadlineQueue(3, deadline_s=0.5, clock=clock,
                           on_shed=lambda r, n: shed.append((r, n)),
                           on_evict=lambda item, r: evicted.append((item, r)))
    out = []
    for i in range(5):
        out.append(q.push(i))
        clock.sleep(0.2)
    out.append((q.depth, q.oldest_stamp()))
    out.append(q.pop())
    clock.sleep(0.4)
    out.append(q.pop())
    out.append((q.pop(), q.depth, q.shed_overflow, q.shed_stale))
    q.push("x", stamp=1.0)
    q.clear()
    return out, evicted, shed, q.depth


def ov_admission(m):
    clock = Clock()
    adm = m.ov.AdmissionController(step_budget_s=0.5, lag_budget_s=0.1, max_sessions=3,
                                   retry_after_s=2.0, clock=clock)
    out = [adm.admit(0), adm.capacity(0), adm.capacity(1, free_slots=1),
           adm.capacity(0, free_slots=0)]
    for dt in (0.2, 0.9, 1.4):
        adm.note_step_latency(dt)
        out.append((round(adm.pressure(), 6), adm.admit(1), round(adm.retry_after_s(), 6),
                    adm.capacity(1)))
    adm.note_step_timeout(5.0)
    out.append((round(adm.retry_after_s(), 6), adm.admit(0)))
    for _ in range(30):
        clock.sleep(1.0)
        adm.decay_stale_step_signal(2.0)
    out.append((round(adm.pressure(), 9), adm.admit(3), adm.admit(2)))
    adm.note_loop_lag(0.3)
    out.append((round(adm.pressure(), 6), adm.admit(0)))
    adm.lag_ewma.value = 0.0
    adm.hold_freeze()
    adm.hold_freeze()
    adm.release_freeze()
    out.append((adm.frozen, adm.admit(0), adm.capacity(0, free_slots=2)))
    adm.release_freeze()
    adm.release_freeze()
    out.append((adm.frozen, adm.admit(0), adm.rejected))
    return out


def ov_ladder(m):
    """Hysteresis up and down, the skip pattern and the probe rungs, the
    freeze at the top rung, the supervisor held DEGRADED while shedding."""
    clock = Clock()
    adm = m.ov.AdmissionController(clock=clock)
    sup = m.sup.SessionSupervisor("s", clock=clock, sleep=clock.sleep)
    rungs = []
    lad = m.ov.OverloadLadder("s", adm, sup, up_after=2, down_after=3, probe_interval_s=1.0,
                              clock=clock, on_rung=lambda a, b: rungs.append((a, b)))
    out = []
    for pressure in [True] * 9 + [False] * 14:
        lad.tick(pressure)
        admits = []
        for _ in range(4):
            admits.append(lad.admit_frame())
            clock.sleep(0.3)
        out.append((lad.rung, lad.effective_rung, admits, adm.frozen, sup.state))
    lad.tick(True)
    lad.close()
    out.append((lad.rung, adm.frozen, lad.frames_skipped))
    return out, rungs, [(a, b) for _, a, b, _ in sup.transitions]


def ov_plane(m, monkeypatch):
    """The plane from its env: reservations counted at the cap and expired
    by their TTL, admission and capacity, drain, ladders ticked together,
    stale step pressure decaying, queues in the snapshot."""
    for k, v in {"OVERLOAD_MAX_SESSIONS": "2", "OVERLOAD_STEP_BUDGET_MS": "500",
                 "OVERLOAD_UP_TICKS": "1", "OVERLOAD_DOWN_TICKS": "2",
                 "OVERLOAD_TICK_S": "0.25", "OVERLOAD_PROBE_S": "1.0"}.items():
        monkeypatch.setenv(k, v)
    clock = Clock()
    plane = m.ov.OverloadControlPlane(clock=clock)
    out = [plane.admission_gate("a"), plane.admission_gate("b"), plane.admission_gate("c"),
           plane.capacity(free_slots=5)]
    clock.sleep(31.0)
    out.append((plane.admission_gate("c"), plane.capacity()))
    plane.release_admission("c")
    sup = m.sup.SessionSupervisor("a", clock=clock, sleep=clock.sleep)
    lad = plane.register_session("a", sup)
    plane.register_queue("batchwin:a", m.ov.DeadlineQueue(2))
    plane.register_queue("ingest:a", m.ov.QueueProbe(asyncio.Queue(maxsize=16)))
    plane.admission.note_step_latency(0.9)
    for _ in range(5):
        plane.tick()
        clock.sleep(0.25)
    out.append((lad.rung, sup.state, plane.capacity(free_slots=3)))
    for _ in range(12):
        plane.tick()
        clock.sleep(0.25)
    out.append((lad.rung, round(plane.admission.pressure(), 9), plane.admission_gate("d")))
    out.append((plane.begin_drain(), plane.begin_drain(), plane.capacity(free_slots=3),
                plane.admission_gate("e")))
    out.append((plane.end_drain(), plane.end_drain(), plane.draining))
    plane.note_shed_ingest(2)
    plane.note_delivered(0.04)
    plane.note_delivered(0.01)
    snap = plane.snapshot()
    plane.unregister_session("a")
    out.append((snap, sorted(plane.queues), plane.frame_deadline_s))
    plane.stop()
    return out


@pytest.mark.parametrize("script", [ov_deadline_queue, ov_admission, ov_ladder])
def test_overload_matches_jax(script):
    _both(script)


def test_overload_plane_matches_jax(monkeypatch):
    _both(ov_plane, monkeypatch)


def test_shed_to_passthrough_resolves_once():
    from concurrent.futures import Future

    fut = Future()
    PO.shed_to_passthrough(fut, "pixels")
    PO.shed_to_passthrough(fut, "again")
    assert isinstance(fut.result(), PO.ShedFrame) and fut.result().frame == "pixels"
    cancelled = Future()
    cancelled.cancel()
    PO.shed_to_passthrough(cancelled, "x")
    assert cancelled.cancelled()
