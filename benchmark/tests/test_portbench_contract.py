"""The run's contract on every exit path: a result line on success and on
a failed comparison; no result and a non-zero exit without a card, without
the program, on an error and on SIGTERM."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from benchmark import run as R
from benchmark.tests import _tiny

REPO = Path(__file__).resolve().parents[2]
ARGS = ["--workload", _tiny.WORKLOAD, "--seed", "4294967311", "--seconds", "1.5"]


def _fake_card(monkeypatch, root):
    import torch

    monkeypatch.setattr(R, "ROOT", root)
    monkeypatch.setattr(R, "DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


def _result(out: str):
    lines = [ln for ln in out.strip().splitlines() if ln.strip()]
    return json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None


def test_success_prints_the_result_last(monkeypatch, tmp_path, capsys):
    _fake_card(monkeypatch, _tiny.checkout(tmp_path))
    assert R.main(ARGS + ["--trace", "0"]) == 0
    cap = capsys.readouterr()
    res = _result(cap.out)
    assert res["correct"] is True
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {n for n, _ in _tiny.E2E}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == {"frame_gap_levels", "frames_compared_at_least",
                                  "live_share_at_least"}
    live = res["checks"]["live_share_at_least"]
    assert live["limit"] <= live["value"] <= 1.0
    assert any("check frame_gap_levels" in ln for ln in cap.err.strip().splitlines()[-3:])


def test_failed_comparison_prints_correct_false(monkeypatch, tmp_path, capsys):
    from ai_rtc_agent_tpu_torch.stream import scheduler

    fetch = scheduler.ScheduledSession.fetch

    def altered(self, handle, src_frame=None):  # a served frame that is wrong
        out = fetch(self, handle, src_frame)
        return out ^ 64 if hasattr(out, "shape") else out

    monkeypatch.setattr(scheduler.ScheduledSession, "fetch", altered)
    _fake_card(monkeypatch, _tiny.checkout(tmp_path))
    assert R.main(ARGS + ["--trace", "0"]) == 0
    res = _result(capsys.readouterr().out)
    assert res["correct"] is False
    gap = res["checks"]["frame_gap_levels"]
    assert gap["value"] > gap["limit"]


def test_no_card_no_result(monkeypatch, tmp_path, capsys):
    import torch

    monkeypatch.setattr(R, "ROOT", _tiny.checkout(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert R.main(ARGS) == 3
    cap = capsys.readouterr()
    assert cap.out == "" and "no CUDA card" in cap.err


def test_too_few_cards_no_result(monkeypatch, tmp_path, capsys):
    import torch

    monkeypatch.setattr(R, "ROOT", _tiny.checkout(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert R.main(ARGS) == 3
    assert capsys.readouterr().out == ""


def test_error_no_result(monkeypatch, tmp_path, capsys):
    from benchmark import harness

    _fake_card(monkeypatch, _tiny.checkout(tmp_path))

    def broken(*a, **k):
        raise RuntimeError("the program failed to build")

    monkeypatch.setattr(harness, "build", broken)
    assert R.main(ARGS) == 1
    cap = capsys.readouterr()
    assert cap.out == "" and "the program failed to build" in cap.err


def test_jax_loaded_no_result(monkeypatch, tmp_path, capsys):
    import types

    _fake_card(monkeypatch, _tiny.checkout(tmp_path))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert R.main(ARGS) == 4
    cap = capsys.readouterr()
    assert cap.out == "" and "jaxlib" in cap.err


def test_top_level_names_compared_whole(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "ai_rtc_agent_tpu_torch_x", types.ModuleType("x"))
    assert "ai_rtc_agent_tpu" not in R.forbidden_modules()


def test_real_checkout_without_a_card_or_program(tmp_path):
    """As the driver runs it: on this card-less machine, and in a directory
    that holds only BENCHMARK.json and the benchmark's files."""
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "sd-turbo-512.live4", "--seed", "1", "--seconds", "1"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(REPO / "benchmark"), str(bare / "benchmark")], check=True)
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "sd-turbo-512.live4", "--seed", "1", "--seconds", "1"],
                          cwd=bare, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "cannot import the program" in proc.stderr


def _stuck_run(root: Path, watchdog_s: float = 340.0):
    """A run on the CPU whose sessions take 30 s to settle."""
    script = textwrap.dedent(f"""
        import sys, torch
        sys.path.insert(0, {str(REPO)!r})
        from benchmark import run as R
        R.ROOT = __import__("pathlib").Path({str(root)!r})
        R.DEVICE = "cpu"
        R.WATCHDOG_S = {watchdog_s!r}
        torch.cuda.is_available = lambda: True
        torch.cuda.device_count = lambda: 1
        sys.exit(R.main({ARGS!r}))
    """)
    return subprocess.Popen([sys.executable, "-c", script], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=dict(os.environ, PYTHONPATH=""))


def test_sigterm_no_result(tmp_path):
    proc = _stuck_run(_tiny.checkout(tmp_path, seconds_traffic=_tiny.traffic(settle_s=30.0)))
    for line in proc.stderr:  # serving: the sessions are claimed
        if "sessions claimed" in line:
            break
    proc.send_signal(signal.SIGTERM)
    try:
        out, err = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail("the run did not stop on SIGTERM")
    assert proc.returncode != 0
    assert _result(out) is None


def test_watchdog_ends_a_stuck_run_with_its_stacks(tmp_path):
    proc = _stuck_run(_tiny.checkout(tmp_path, seconds_traffic=_tiny.traffic(settle_s=30.0)),
                      watchdog_s=8.0)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 1
    assert _result(out) is None
    assert "Timeout" in err and "most recent call first" in err
