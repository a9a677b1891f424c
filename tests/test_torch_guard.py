"""The engine fault domain in the port (resilience/engine_guard.py over
stream/scheduler.py) against the JAX package's, on the CPU.

* The guard alone, over a fake scheduler, both packages' guards driven by
  the same script: deadline and device-lost trips, a non-fault error that
  does not trip, the cold deadline, the backed-off rebuild, exhaustion and
  evacuation, Retry-After and the metric snapshots.
* The guard over each package's BatchScheduler (tiny-test, 32x32, the
  2-stage turbo ring, two sessions each in a ResilientPipeline), under
  the same fault plans in one run: ``nan`` (the scheduler ignores it, as
  the JAX one does), ``device_lost`` and a rebuild, ``wedge`` and a
  rebuild, then a rebuild that keeps failing.  Both give the same guard
  states, the same webhooks (Engine*/AgentEvacuating) and the same
  session states; every passthrough frame is its source; after each
  recovery the frames stay within 1 uint8 level of the JAX ones (the JAX
  weights and session states carried across by ``bridge``).  On the port
  side: the restored rows equal the snapshot bank bit for bit, and the
  wedged step released after the rebuild writes nothing.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.resilience import engine_guard as JG
from ai_rtc_agent_tpu.resilience import faults as JF
from ai_rtc_agent_tpu.resilience import supervisor as JS
from ai_rtc_agent_tpu.stream.scheduler import BatchScheduler as JBatchScheduler
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.resilience import engine_guard as PG
from ai_rtc_agent_tpu_torch.resilience import faults as PF
from ai_rtc_agent_tpu_torch.resilience import supervisor as PS
from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler
from ai_rtc_agent_tpu_torch.tree import tree_equal, tree_map

GUARDS = {"jax": (JG, JF), "port": (PG, PF)}
CFG32 = dict(t_index_list=(0, 1), num_inference_steps=2, timestep_spacing="trailing",
             scheduler="turbo", cfg_type="none", height=32, width=32)


@pytest.fixture(autouse=True)
def no_fault_plan(monkeypatch):
    monkeypatch.setenv("ENGINE_SNAPSHOT_EVERY_S", "0.000001")  # bank after every step
    for _, f in GUARDS.values():
        f.deactivate()
    yield
    for _, f in GUARDS.values():
        f.deactivate()


# -- the guard alone ---------------------------------------------------------------------

class FakeSched:
    def __init__(self, fail_rebuilds=0):
        self.captures, self.rebuilds, self.fail_rebuilds = 0, [], fail_rebuilds

    def attach_guard(self, g):
        self.guard = g

    def capture_quarantine_snapshots(self):
        self.captures += 1
        return {"sess-a": "banked"}

    def rebuild_engine(self, snaps):
        self.rebuilds.append(snaps)
        if len(self.rebuilds) <= self.fail_rebuilds:
            raise RuntimeError("device still gone")
        return len(snaps)


def _mk(side, sched, **kw):
    G, _ = GUARDS[side]
    events, sleeps = [], []
    kw.setdefault("deadline_s", 0.05)
    g = G.EngineGuard(sched, max_attempts=3, backoff_s=1.0, auto_rebuild=False,
                      sleep=sleeps.append,
                      on_transition=lambda ev, info: events.append(
                          (ev, {k: v for k, v in info.items() if k != "rebuild_ms"})),
                      **kw)
    return g, events, sleeps


def _view(g):
    snap = g.snapshot()
    for k in ("engine_rebuild_ms_p50", "engine_rebuild_ms_p99"):
        snap[k] = k in snap
    return g.state, g.health(), snap, g.retry_after_s()


def unit_trips(side):
    G, F = GUARDS[side]
    out = []
    g, events, _ = _mk(side, FakeSched())
    out.append(g.dispatch(lambda: 42))
    release = threading.Event()
    with pytest.raises(G.EngineQuarantinedError) as e:
        g.dispatch(lambda: release.wait(5))
    release.set()
    out.append((str(e.value), _view(g)))
    ran = []
    with pytest.raises(G.EngineQuarantinedError):
        g.dispatch(lambda: ran.append(1))
    out.append((ran, g.trips, events))
    g.close()
    g, events, _ = _mk(side, FakeSched())
    with pytest.raises(ValueError):
        g.dispatch(lambda: (_ for _ in ()).throw(ValueError("shapes")))
    out.append(_view(g))
    out.append(g.dispatch(lambda: time.sleep(0.2) or "cold ok", cold=True))
    with pytest.raises(F.DeviceLostError):
        g.dispatch(lambda: (_ for _ in ()).throw(F.DeviceLostError("halt 0x13")))
    out.append((_view(g), events))
    g.close()
    return out


@pytest.mark.parametrize("fail_rebuilds", [0, 1, 3])
def test_guard_rebuild_schedule_matches_jax(fail_rebuilds):
    def script(side):
        _, F = GUARDS[side]
        sched = FakeSched(fail_rebuilds)
        evacuated = []
        g, events, sleeps = _mk(side, sched, cold_deadline_s=5.0,
                                on_exhausted=lambda: evacuated.append(g.state))
        with pytest.raises(F.DeviceLostError):
            g.dispatch(lambda: (_ for _ in ()).throw(F.DeviceLostError("x")))
        rebuilt = g.run_rebuild()
        out = (rebuilt, sleeps, sched.captures, sched.rebuilds, evacuated, events, _view(g))
        g.close()
        return out

    got = {side: script(side) for side in GUARDS}
    assert got["port"] == got["jax"]


def test_guard_trips_match_jax():
    got = {side: unit_trips(side) for side in GUARDS}
    assert got["port"] == got["jax"]


def test_run_bounded_abandons_a_stuck_call():
    """The port's rebuild attempts run on the stepping runner under the cold
    deadline: a call stuck behind a stalled device raises, and the next
    call runs on a fresh runner."""
    g, _, _ = _mk("port", FakeSched())
    release = threading.Event()
    with pytest.raises(TimeoutError, match="exceeded 0.05s"):
        g.run_bounded(lambda: release.wait(5), 0.05, "rebuild")
    assert g.run_bounded(lambda: threading.current_thread().name, 1.0) == "resilient-step"
    release.set()
    g.close()


# -- the guard over the schedulers ---------------------------------------------------------

@pytest.fixture(scope="module")
def bundles():
    jb = JREG.load_model_bundle("tiny-test")
    pb = PREG.load_model_bundle("tiny-test", device="cpu",
                                params=bridge.params_from_jax(jax.tree.map(np.asarray, jb.params)))
    return jb, pb


def _scheduler(side, bundles):
    jb, pb = bundles
    if side == "jax":
        cfg = JREG.default_stream_config("tiny-test", **CFG32)
        return JBatchScheduler(jb.stream_models, jb.params, cfg, jb.encode_prompt, max_sessions=2,
                               window_ms=0.0, prewarm=False, dp=1)
    cfg = PREG.default_stream_config("tiny-test", device="cpu", **CFG32)
    return BatchScheduler(pb.stream_models, pb.params, cfg, pb.encode_prompt, max_sessions=2,
                          window_ms=0.0, prewarm=False, device="cpu")


def _inject(side, sched, kind):
    _, F = GUARDS[side]
    F.activate(F.FaultPlan(specs=(F.FaultSpec(target="engine", kind=kind, start=0, stop=1),),
                           seed=7))
    sched._fault_scope = F.scope("engine")


def _rows(sched, slot):
    return tree_map(lambda a: a[slot].clone(), sched.states)


def _equal(a, b) -> bool:
    return tree_equal(a, b)


def chaos(side, bundles, carried: dict, checks: dict):
    """One run of the fault sequence; -> (transcript, frames per tick)."""
    G, F = GUARDS[side]
    S = JS if side == "jax" else PS
    sched = _scheduler(side, bundles)
    events = []
    guard = G.EngineGuard(
        sched, deadline_s=0.5, cold_deadline_s=120.0, auto_rebuild=False, sleep=lambda s: None,
        on_transition=lambda ev, info: events.append(
            (ev, info["state"], info.get("attempt"), info.get("restored"))))
    keys = ["s0", "s1"]
    sess = [sched.claim(k, prompt=f"chaos {k}", seed=i) for i, k in enumerate(keys)]
    if side == "jax":
        carried["states"] = jax.tree.map(np.asarray, sched.states)
    else:
        bridge.states_from_jax(carried["states"], sched.states)
    live = [S.ResilientPipeline(s, step_timeout_s=30.0) for s in sess]
    rng = np.random.default_rng(19)
    frames = [rng.integers(0, 256, (32, 32, 3), np.uint8) for _ in range(12)]
    out, seen = [], []

    def tick(i, expect_passthrough=False):
        row = []
        for rp in live:
            got = np.asarray(rp.fetch(rp.submit(frames[i])))
            if expect_passthrough:  # the source frame, bit for bit
                assert np.array_equal(got, frames[i])
            row.append(got)
        seen.append((i, expect_passthrough, row))

    try:
        for i in range(2):
            tick(i)
        _inject(side, sched, "nan")  # the scheduler's step ignores it
        tick(2)
        out.append(guard.state)
        if side == "port":
            checks["bank"] = {slot: tree_map(torch.clone, row)
                              for slot, row in sched._snap_rows.items()}
        _inject(side, sched, "device_lost")
        tick(3, expect_passthrough=True)
        out.append((guard.state, guard.trips))
        with pytest.raises(Exception, match="quarantined"):
            sched.claim("late", prompt="late", seed=9)
        out.append(guard.run_rebuild())
        if side == "port":
            checks["restored"] = all(_equal(_rows(sched, s.slot), checks["bank"][s.slot])
                                     for s in sess)
        tick(4)
        tick(5)
        _inject(side, sched, "wedge")
        old_runner = guard._runner
        t0 = time.monotonic()
        tick(6, expect_passthrough=True)
        out.append((guard.state, guard.trips, time.monotonic() - t0 < 20.0))
        out.append(guard.run_rebuild())
        after = [_rows(sched, s.slot) for s in sess] if side == "port" else None
        F.release_wedge()  # the held step wakes after the rebuild
        old_runner._thread.join(10)
        if side == "port":
            checks["late_wrote_nothing"] = all(
                _equal(_rows(sched, s.slot), a) for s, a in zip(sess, after))
        tick(7)
        tick(8)

        def refuse(*a, **k):
            raise RuntimeError("device still gone")

        sched.rebuild_engine = refuse
        _inject(side, sched, "device_lost")
        tick(9, expect_passthrough=True)
        out.append(guard.run_rebuild())
        tick(10, expect_passthrough=True)
        tick(11, expect_passthrough=True)
        out.append((guard.state, guard.trips, guard.rebuilds, guard.retry_after_s()))
        out.append(events)
        for rp in live:
            snap = rp.supervisor.snapshot()
            out.append(([(t["from"], t["to"]) for t in snap["transitions"]],
                        snap["processed_frames"], snap["passthrough_frames"]))
    finally:
        F.release_wedge()
        guard.close()
        sched.close()
    return out, seen


def test_guard_over_the_scheduler_matches_jax(bundles):
    carried, checks = {}, {}
    want, want_frames = chaos("jax", bundles, carried, checks)
    got, got_frames = chaos("port", bundles, carried, checks)
    assert got == want
    assert checks == {"bank": checks["bank"], "restored": True, "late_wrote_nothing": True}
    assert len(checks["bank"]) == 2
    for (i, passthrough, g_row), (_, _, w_row) in zip(got_frames, want_frames):
        for g, w in zip(g_row, w_row):
            assert g.shape == w.shape == (32, 32, 3)
            diff = np.abs(g.astype(np.int16) - w.astype(np.int16)).max()
            assert diff <= 1, f"frame {i}: {diff} levels from the JAX scheduler"
    # the sequence held: two trips recovered, the third exhausted the rebuild
    assert got[-4][:3] == ("FAILED", 3, 2)
    assert [e[0] for e in got[-3]] == ["EngineDegraded", "EngineRecovered"] * 2 + [
        "EngineDegraded", "AgentEvacuating"]
