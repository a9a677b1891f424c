"""The port's measurement helpers (ai_rtc_agent_tpu_torch/utils/contract.py,
hwfp.py, perfbank.py) against the JAX package's copies, on the CPU.

* ``sigterm_to_exception``: a SIGTERM unwinds as a TimeoutError naming its
  source, as tests/test_contract_helper.py holds the JAX one.
* ``hwfp.fingerprint``: the host fields equal the JAX fingerprint's; the
  host-only mode says ``unprobed``; without a card the full probe records
  ``unavailable`` and the error, and does not raise.
* ``perfbank.bank``: under PERF_LOG_PATH unset, empty, os.devnull and an
  unwritable path it writes the same bytes as the JAX ``bank`` given the
  same entries (each pointed into its own tmp directory), and records the
  same ``bank_error``.  Nothing here writes the repository's PERF_LOG.jsonl.
* ``perfbank.paired``: the JAX estimator's result on the same
  deterministic legs, call order included.
* None of the new modules brings jax into ``sys.modules`` (a fresh process).
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.utils import contract as JC
from ai_rtc_agent_tpu.utils import hwfp as JH
from ai_rtc_agent_tpu.utils import perfbank as JP
from ai_rtc_agent_tpu_torch.utils import contract as PC
from ai_rtc_agent_tpu_torch.utils import hwfp as PH
from ai_rtc_agent_tpu_torch.utils import perfbank as PP

REPO = Path(__file__).resolve().parents[1]
HOST_FIELDS = ("host_cpus", "machine", "python")


@pytest.mark.parametrize("helper", [PC.sigterm_to_exception, JC.sigterm_to_exception],
                         ids=["port", "jax"])
def test_sigterm_raises_timeout_error_naming_its_source(helper):
    old = signal.getsignal(signal.SIGTERM)
    try:
        helper("unit test")
        with pytest.raises(TimeoutError, match=r"^SIGTERM \(unit test\)$"):
            os.kill(os.getpid(), signal.SIGTERM)
        defaults = []
        for default in (PC.sigterm_to_exception, JC.sigterm_to_exception):
            default()
            with pytest.raises(TimeoutError) as e:
                os.kill(os.getpid(), signal.SIGTERM)
            defaults.append(str(e.value))
        assert defaults[0] == defaults[1]
    finally:
        signal.signal(signal.SIGTERM, old)


def test_host_only_fingerprint_is_the_jax_one():
    got, want = PH.fingerprint(probe_device=False), JH.fingerprint(probe_jax=False)
    assert {k: got[k] for k in HOST_FIELDS} == {k: want[k] for k in HOST_FIELDS}
    assert got == {**{k: want[k] for k in HOST_FIELDS}, "backend": "unprobed"}


def test_full_probe_without_a_card_records_unavailable():
    fp = PH.fingerprint()
    assert {k: fp[k] for k in HOST_FIELDS} == {k: JH.fingerprint(False)[k] for k in HOST_FIELDS}
    assert fp["backend"] == "unavailable"
    assert fp["error"].startswith("RuntimeError: torch.cuda.is_available() is false")
    assert "device_kind" not in fp and "card" not in fp


def test_full_probe_records_the_card(monkeypatch):
    """With a card answering (stubbed: torch.cuda and nvidia-smi), the
    probe records its identity and the nvidia-smi line as printed; a failing
    nvidia-smi makes the whole probe ``unavailable``."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    line = "NVIDIA H100 80GB HBM3, 700.00 W"
    runs = []

    def smi(cmd, **kw):
        runs.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=line + "\n", stderr="")

    monkeypatch.setattr(PH.subprocess, "run", smi)
    fp = PH.fingerprint()
    assert runs == [PH.NVIDIA_SMI]
    assert {k: fp[k] for k in ("backend", "device_kind", "device_count", "card", "power_limit",
                               "torch", "cuda")} == {
        "backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3", "device_count": 1,
        "card": line, "power_limit": "700.00 W", "torch": torch.__version__,
        "cuda": torch.version.cuda}
    monkeypatch.setattr(PH.subprocess, "run", lambda cmd, **kw: subprocess.CompletedProcess(
        cmd, 9, stdout="", stderr="no devices were found"))
    fp = PH.fingerprint()
    assert fp["backend"] == "unavailable" and "no devices were found" in fp["error"]


ENTRIES = [{"metric": "fps", "value": 84.77, "n": 1}, {"metric": "ms", "value": [1.5, 2.0]},
           {"nested": {"a": None, "b": True}}]


def _bank_both(tmp_path, entries):
    """Bank ``entries`` through both packages, each with its own repo root
    under ``tmp_path`` -> (port entries, jax entries) after banking."""
    port, jax_ = [dict(e) for e in entries], [dict(e) for e in entries]
    for e in port:
        PP.bank(e, repo_root=str(tmp_path / "port"))
    for e in jax_:
        JP.bank(e, repo_root=str(tmp_path / "jax"))
    return port, jax_


@pytest.mark.parametrize("mode", ["unset", "empty", "devnull", "file", "unwritable"])
def test_bank_writes_what_the_jax_bank_writes(mode, tmp_path, monkeypatch):
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    monkeypatch.delenv("PERF_LOG_PATH", raising=False)
    if mode == "empty":
        monkeypatch.setenv("PERF_LOG_PATH", "")
    elif mode == "devnull":
        monkeypatch.setenv("PERF_LOG_PATH", os.devnull)
    elif mode == "unwritable":
        monkeypatch.setenv("PERF_LOG_PATH", str(tmp_path / "port"))  # a directory
    if mode == "file":
        paths = [tmp_path / "log-port.jsonl", tmp_path / "log-jax.jsonl"]
        port = [dict(e) for e in ENTRIES]
        jax_ = [dict(e) for e in ENTRIES]
        monkeypatch.setenv("PERF_LOG_PATH", str(paths[0]))
        for e in port:
            PP.bank(e)
        monkeypatch.setenv("PERF_LOG_PATH", str(paths[1]))
        for e in jax_:
            JP.bank(e)
    else:
        port, jax_ = _bank_both(tmp_path, ENTRIES)
        paths = [tmp_path / "port" / "PERF_LOG.jsonl", tmp_path / "jax" / "PERF_LOG.jsonl"]
    assert port == jax_
    written = [p.read_bytes() if p.is_file() else None for p in paths]
    assert written[0] == written[1]
    if mode in ("unset", "file"):
        assert [json.loads(line) for line in written[0].splitlines()] == ENTRIES
    else:
        assert written[0] is None
    assert all("bank_error" in e for e in port) == (mode == "unwritable")


def test_bank_default_is_the_repository_log():
    assert PP._REPO == str(REPO) and JP._REPO == str(REPO)


@pytest.mark.parametrize("reps", [1, 2, 5, 6])
def test_paired_is_the_jax_estimator(reps):
    def legs():
        calls, ticks = [], iter(range(1, 1000))

        def leg(name, scale):
            def run():
                calls.append(name)
                return scale * next(ticks) % 7 + 0.5

            return run

        return calls, leg("a", 3.0), leg("b", 2.0)

    port_calls, a, b = legs()
    got = PP.paired(a, b, reps)
    jax_calls, a, b = legs()
    want = JP.paired(a, b, reps)
    assert got == want and port_calls == jax_calls
    assert port_calls[:4] == ["a", "b", "b", "a"][:2 * reps]
    assert PP.paired(lambda: 1.0, lambda: 0.0, 3) == JP.paired(lambda: 1.0, lambda: 0.0, 3)


def test_new_modules_import_no_jax():
    code = ("import sys\n"
            "import ai_rtc_agent_tpu_torch.utils.contract, ai_rtc_agent_tpu_torch.utils.hwfp\n"
            "import ai_rtc_agent_tpu_torch.utils.perfbank, ai_rtc_agent_tpu_torch.utils.golden\n"
            "import ai_rtc_agent_tpu_torch.assets.download\n"
            "import ai_rtc_agent_tpu_torch.assets.build_engines\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ai_rtc_agent_tpu', 'requests', 'huggingface_hub'))\n"
            "print(bad)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
