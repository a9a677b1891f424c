"""One restart in place across processes, on the CPU.

A tiny-test port agent (``python -m ai_rtc_agent_tpu_torch.server.agent
--device cpu``, loopback provider) serves one WHIP session; ``POST
/admin/recycle`` writes the handoff and answers 202, the agent re-execs its
own command line (server/lifecycle.py) and exits; the replacement binds the
same port, imports the handoff before it answers, and the re-offer carrying
the ``rcy-<stream id>`` token adopts the session, whose export equals the
handoff's row byte for byte.  The replacement retires with ``respawn:
false``.  Everything stays on 127.0.0.1.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
MODULE = "ai_rtc_agent_tpu_torch.server.agent"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _call(port, path, body=None, headers=None, method=None):
    data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _wait(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            got = pred()
        except OSError:
            got = None
        if got:
            return got
        time.sleep(0.1)
    pytest.fail(f"timed out waiting for {what}")


def _agents_on(port: int) -> list:
    """Pids of port agents started on ``port`` (the re-exec'd replacement is
    not this test's child)."""
    pids = []
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            argv = (entry / "cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        if MODULE.encode() in argv and str(port).encode() in argv:
            pids.append(int(entry.name))
    return pids


def test_recycle_re_execs_and_the_replacement_adopts_the_handoff(tmp_path):
    port = _free_port()
    handoff = tmp_path / "handoff.json"
    env = dict(os.environ, PYTHONPATH=str(REPO), WEBRTC_PROVIDER="loopback", WARMUP_FRAMES="0",
               BATCHSCHED_MAX_SESSIONS="2", RECYCLE_HANDOFF=str(handoff),
               RECYCLE_EXIT_DELAY_S="0.05", OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    log = open(tmp_path / "agent.log", "wb")
    proc = subprocess.Popen([sys.executable, "-m", MODULE, "--model-id", "tiny-test", "--device",
                             "cpu", "--port", str(port), "--log-level", "WARNING"],
                            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        _wait(lambda: _call(port, "/")[0] == 200, 60, "the agent")
        boot = json.loads(_call(port, "/capacity")[2])["boot_id"]
        offer = json.dumps({"loopback": True, "video": True, "datachannel": True}).encode()
        status, headers, _ = _call(port, "/whip", offer, {"Content-Type": "application/sdp"})
        assert status == 201
        sid = headers["Location"].rsplit("/", 1)[1]

        status, _, body = _call(port, "/admin/recycle", {"respawn": True},
                                {"Content-Type": "application/json"})
        assert status == 202
        answer = json.loads(body)
        assert (answer["sessions"], answer["handoff"]) == (1, str(handoff))
        written = json.loads(handoff.read_text())  # before the replacement consumes it
        assert [e["session"] for e in written["sessions"]] == [sid]
        assert proc.wait(timeout=30) == 0  # the old process exits on its own

        _wait(lambda: _call(port, "/")[0] == 200, 60, "the replacement")
        cap = json.loads(_call(port, "/capacity")[2])
        assert cap["boot_id"] != boot
        assert not handoff.exists()  # consumed at startup, before it answered
        status, headers, _ = _call(port, "/whip", offer, {"Content-Type": "application/sdp",
                                                          "X-Migrated-Session": f"rcy-{sid}"})
        assert status == 201
        new = headers["Location"].rsplit("/", 1)[1]
        status, _, body = _call(port, f"/migrate/export?session={new}")
        assert status == 200
        assert json.loads(body)["state_b64"] == written["sessions"][0]["snapshot"]["state_b64"]

        status, _, _ = _call(port, "/admin/recycle", {"respawn": False},
                             {"Content-Type": "application/json"})
        assert status == 202
        _wait(lambda: not _agents_on(port), 30, "the replacement to retire")
    finally:
        for pid in _agents_on(port):
            os.kill(pid, signal.SIGTERM)
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        log.close()
