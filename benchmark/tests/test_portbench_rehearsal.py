"""The harness on the CPU, at the program's tiny family: a rehearsal whose
device metrics are refused (never filled from CPU time); the comparison
failing each fault a serving cell can have, with the timed path broken
underneath; the fp8 control failing the limit."""

from __future__ import annotations

import pytest

from benchmark import run as R
from benchmark.tests import _tiny

SEED = 2**32 + 17


def _run(trace=False, seconds=1.5, cfg=None, control=None):
    return R.run_cell(_tiny.BENCH.parent, _tiny.WORKLOAD, {"chips": 1}, cfg or _tiny.config(),
                      _tiny.traffic(), _tiny.metrics(trace), SEED, seconds, trace, "cpu",
                      control=control)


def test_rehearsal_refuses_device_metrics():
    res = _run(trace=True)
    assert res["correct"] is True
    assert not set(res["metrics"]) & _tiny.DEVICE_METRICS
    assert {"submit_ms_p50", "slots_filled", "window_wait_ms_p50"} <= set(res["metrics"])
    assert res["device"]["platform"] == "cpu" and "busy_s" not in res["device"]
    assert "breakdown" not in res
    assert res["device"]["memory_peak_bytes"] is None


def test_fp8_control_fails_the_limit():
    res = _run(control="fp8")
    assert res["correct"] is False and res["control"] == "fp8"
    gap = res["checks"]["frame_gap_levels"]
    assert gap["value"] > gap["limit"]


def _state_unchanged(monkeypatch):
    """The ring's step returns its state unchanged: the epilogue's ring and
    stock writes go nowhere."""
    from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF

    plain = KF.epilogue_plain

    def unchanged(*a, advanced_out=None, stock_out=None, **k):
        return plain(*a, advanced_out=None if advanced_out is None else advanced_out.clone(),
                     stock_out=None if stock_out is None else stock_out.clone(), **k)

    monkeypatch.setattr(KF, "epilogue_plain", unchanged)


def _half_batch(monkeypatch):
    """Half of a bucket step's rows left out: the second half of the riders
    get the first rider's output."""
    from ai_rtc_agent_tpu_torch.parallel import multipeer

    call = multipeer.BucketStep.__call__

    def half(self, params, states, frames, slots, k, variant=None):
        out = call(self, params, states, frames, slots, k, variant).clone()
        n = len(slots)
        out[max(1, n // 2):n] = out[0]
        return out

    monkeypatch.setattr(multipeer.BucketStep, "__call__", half)


def _answer_altered(monkeypatch):
    """An answer altered where it is produced: a block of the served frame
    moved by 16 levels."""
    from ai_rtc_agent_tpu_torch.stream import scheduler

    fetch = scheduler.ScheduledSession.fetch

    def altered(self, handle, src_frame=None):
        out = fetch(self, handle, src_frame)
        if hasattr(out, "shape"):
            out = out.copy()
            out[:16, :16] ^= 16
        return out

    monkeypatch.setattr(scheduler.ScheduledSession, "fetch", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_fault_fails_the_comparison(monkeypatch, fault):
    fault(monkeypatch)
    res = _run()
    assert res["correct"] is False
    gap = res["checks"]["frame_gap_levels"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_replay_buckets_steps_every_bucket_once(n):
    import torch

    from benchmark import harness
    from benchmark.reference import params as P

    cfg = _tiny.config()
    sched = harness.build(cfg, P.make_tree(cfg, 1, "cpu", torch.float32), n, "cpu")
    try:
        harness.replay_buckets(sched, n, 64, 64)
        hist = sched.snapshot()["batchsched_occupancy_hist"]
        sizes = [k for k in (1, 2, 4, 8) if k <= n]
        assert all(hist.get(str(k), 0) >= 1 for k in sizes)
        assert sched.free_slots == n
    finally:
        harness.release(sched)
