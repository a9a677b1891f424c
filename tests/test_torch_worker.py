"""The port's worker sidecar (server/worker.py) against the JAX package's:
every scenario of tests/test_worker.py (the health probe, publish with
retry and a terminal 4xx, the lease, republishing on a capacity or boot id
change) runs on ``ai_rtc_agent_tpu`` and on ``ai_rtc_agent_tpu_torch`` with
the same assertions."""

import importlib

import pytest

import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from _torch_threads import few_torch_threads  # noqa: F401,E402  (autouse)

ROOTS = {"jax": "ai_rtc_agent_tpu", "torch": "ai_rtc_agent_tpu_torch"}
_ROOT = ["ai_rtc_agent_tpu"]
# module-level names bound to the package under test: (module, name)
_NAMES = {'worker': ('server', 'worker')}


def _imp(mod: str, *names):
    """``names`` of ``mod`` in the package under test (one name: the object)."""
    base = f"{_ROOT[0]}.{mod}" if mod else _ROOT[0]
    m = importlib.import_module(base)
    got = [getattr(m, n) if hasattr(m, n) else importlib.import_module(f"{base}.{n}")
           for n in names]
    return got[0] if len(got) == 1 else got


@pytest.fixture(autouse=True, params=sorted(ROOTS))
def pkg(request):
    """Every scenario runs on the JAX package and on the port."""
    _ROOT[0] = ROOTS[request.param]
    g = globals()
    for name, (mod, attr) in _NAMES.items():
        g[name] = _imp(mod, attr)
        owner = getattr(g[name], "__module__", None) or getattr(g[name], "__name__", None)
        if isinstance(owner, str):  # a class, function or module (not a constant)
            assert owner.split(".")[0] == _ROOT[0], (name, owner)
    yield request.param
    _ROOT[0] = ROOTS["jax"]




def _serve_health(port, status=200, n_requests=10):
    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(status)
            self.end_headers()
            self.wfile.write(b"OK")

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", port), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv


def test_handler_publishes_and_holds(monkeypatch):
    monkeypatch.setenv("AGENT_TIMEOUT", "10")
    monkeypatch.setenv("WORKER_REPUBLISH_S", "5")
    srv = _serve_health(18931)
    published = []
    t = {"now": 0.0}

    def fake_sleep(s):
        published.append(("slept", s))
        t["now"] += s

    rc = worker.handler(
        18931, publish=published.append, sleep=fake_sleep,
        clock=lambda: t["now"],
    )
    srv.shutdown()
    assert rc == 0
    info = published[0]
    assert info["status"] == "ready"
    assert info["public_port"] == "18931"
    assert published[1][0] == "slept"
    # the lease is held to its full AGENT_TIMEOUT across republish ticks
    assert sum(s for tag, s in published[1:] if tag == "slept") == 10


def test_handler_republish_legacy_single_sleep(monkeypatch):
    """WORKER_REPUBLISH_S<=0 restores the original one-sleep lease."""
    monkeypatch.setenv("AGENT_TIMEOUT", "600")
    monkeypatch.setenv("WORKER_REPUBLISH_S", "0")
    srv = _serve_health(18932)
    slept = []
    rc = worker.handler(
        18932, publish=lambda i: None, sleep=slept.append,
        clock=lambda: 0.0,
    )
    srv.shutdown()
    assert rc == 0
    assert slept == [600]


def test_handler_republishes_on_capacity_change(monkeypatch):
    """A box that fills up mid-lease must republish
    its shrunken capacity instead of advertising the stale number for
    the rest of AGENT_TIMEOUT; an unchanged capacity republishes
    NOTHING (bounded cadence, no publish storm)."""
    monkeypatch.setenv("AGENT_TIMEOUT", "20")
    monkeypatch.setenv("WORKER_REPUBLISH_S", "5")
    monkeypatch.setattr(worker, "check_server", lambda url, budget_s: True)
    caps = [
        {"capacity": 4, "saturated": False},   # initial publish
        {"capacity": 4, "saturated": False},   # tick 1: unchanged
        {"capacity": 0, "saturated": True},    # tick 2: box filled up
        {"capacity": 0, "saturated": True},    # tick 3: unchanged again
    ]
    monkeypatch.setattr(worker, "fetch_capacity", lambda url: caps.pop(0))
    published = []
    t = {"now": 0.0}

    def fake_sleep(s):
        t["now"] += s

    rc = worker.handler(
        0, publish=published.append, sleep=fake_sleep,
        clock=lambda: t["now"],
    )
    assert rc == 0
    assert len(published) == 2
    assert published[0]["capacity"] == 4
    assert published[0]["saturated"] is False
    assert published[1]["capacity"] == 0
    assert published[1]["saturated"] is True
    # identity fields ride every republish (the orchestrator keys on them)
    assert published[1]["worker_id"] == published[0]["worker_id"]


def test_handler_failed_republish_retries_on_next_tick(monkeypatch):
    """A republish that fails terminally (publish -> False) must not
    burn the change: the next tick sees the same delta and tries
    again."""
    monkeypatch.setenv("AGENT_TIMEOUT", "15")
    monkeypatch.setenv("WORKER_REPUBLISH_S", "5")
    monkeypatch.setattr(worker, "check_server", lambda url, budget_s: True)
    caps = [
        {"capacity": 4, "saturated": False},
        {"capacity": 1, "saturated": False},  # change; publish fails
        {"capacity": 1, "saturated": False},  # unchanged vs LAST PUBLISHED
    ]
    monkeypatch.setattr(worker, "fetch_capacity", lambda url: caps.pop(0))
    calls = []
    outcomes = iter([None, False, None])  # initial ok, republish fails, retry ok

    def flaky_publish(info):
        calls.append(info)
        return next(outcomes)

    t = {"now": 0.0}

    def fake_sleep(s):
        t["now"] += s

    rc = worker.handler(
        0, publish=flaky_publish, sleep=fake_sleep, clock=lambda: t["now"]
    )
    assert rc == 0
    assert len(calls) == 3
    assert calls[1]["capacity"] == 1 and calls[2]["capacity"] == 1


def test_handler_fails_when_agent_down(monkeypatch):
    monkeypatch.setattr(worker, "HEALTH_BUDGET_S", 1.5)
    rc = worker.handler(18999, publish=lambda i: None, sleep=lambda s: None)
    assert rc == 1


def _serve_publish(status, hits):
    """-> (server, os-assigned port) answering every POST with ``status``."""
    class H(BaseHTTPRequestHandler):
        def do_POST(self):
            hits.append(self.path)
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(status)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]


def test_publish_404_is_terminal_single_attempt(monkeypatch):
    """ROADMAP open item 3: urlopen raises HTTPError BEFORE the status
    check and retry_on used to catch it as URLError, re-POSTing a
    permanent 404 through the whole backoff budget.  4xx must fail after
    EXACTLY one attempt."""
    hits = []
    srv, port = _serve_publish(404, hits)
    monkeypatch.setenv("WORKER_PUBLISH_URL", f"http://127.0.0.1:{port}/pub")
    try:
        ok = worker.default_publish({"status": "ready"})
    finally:
        srv.shutdown()
    assert ok is False
    assert len(hits) == 1


def test_publish_2xx_succeeds(monkeypatch):
    hits = []
    srv, port = _serve_publish(204, hits)
    monkeypatch.setenv("WORKER_PUBLISH_URL", f"http://127.0.0.1:{port}/pub")
    try:
        ok = worker.default_publish({"status": "ready"})
    finally:
        srv.shutdown()
    assert ok is True
    assert len(hits) == 1


def test_check_server_times_out():
    t0 = __import__("time").monotonic()
    assert not worker.check_server("http://127.0.0.1:18998/", budget_s=1.0)
    assert __import__("time").monotonic() - t0 < 5
