"""The port's fleet tier against the JAX package's, transcript for transcript.

One scenario runs through the JAX stack (its agents and router) and through
the port's (server/agent.py and fleet/router.py over fleet/routing.py),
each a real router and two real agent apps in this process over aiohttp,
with fake schedulers speaking the migration surface.  Every answer is
recorded: statuses, the wire headers (the journey's included), bodies, the
webhooks the clients receive, the agents' /health journey context, their
``/debug/flight?journey=`` fragments, the router's journey bundle and
rollup.  Ids (stream ids, journey ids, tokens, snapshot ids) are replaced
by their order of first appearance and clock readings by their type; the
two transcripts must then be equal.  The keys of the broadcast plane (not
ported yet) are left out.

The scenario: placement with a journey, the agent's journey context and
fragment, drain with ``mode=migrate`` (export, import, StreamMigrated, the
pinned re-offer adopted as leg 2), the journey bundle, the rollup, a crash
of the empty source (AGENT_DEAD, nothing to re-point), the agent's
migration surface refusing bad requests, and the kill switches
(``MIGRATE_ENABLE=0``, ``RECYCLE_ENABLE=0``, ``JOURNEY_ENABLE=0``).
"""

import asyncio
import importlib
import json
import re
import time

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

ROOTS = {"jax": "ai_rtc_agent_tpu", "torch": "ai_rtc_agent_tpu_torch"}
ID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}|j-[0-9a-f]{6,}|"
                r"mig-[0-9a-f]{12}|flt-\d+|[0-9a-f]{12}|127\.0\.0\.1:\d+")
CLOCK_KEYS = {"t", "ts", "at", "timestamp", "taken_at", "born", "dur", "written_at",
              "created_at", "placed_at", "started_at", "ended_at", "sealed_at", "last_ok",
              "age_s"}
LEFT_OUT = ("broadcast",)
# the device telemetry's build watchdog: jax.monitoring in JAX, the port's
# graph-cache wrap (obs/devtel.py): compared by type
KNOWN_APART = {"watchdog"}


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


class _Session:
    owns_step_signal = True

    def __init__(self, owner, slot, key, counter=0):
        self._owner, self.slot, self.session_key, self.counter = owner, slot, key, counter
        self.prompt = "p"
        self.window_queue = owner.queue(2)

    def __call__(self, frame):
        self.counter += 1
        return 255 - np.asarray(frame)

    def update_prompt(self, p):
        self.prompt = p

    def update_t_index_list(self, t):
        pass

    def release(self):
        self._owner.released.append(self.session_key)


class _Scheduler:
    """The migration surface over a counter (tests/test_migration.py's fake)."""

    def __init__(self, root):
        sched = _mod(root, "stream.scheduler")
        self.schema, self.mismatch = sched.SESSION_SNAPSHOT_SCHEMA, sched.SnapshotMismatch
        self.full = sched.CapacityError
        self.queue = _mod(root, "resilience.overload").DeadlineQueue
        self.max_sessions, self.sessions, self.released = 2, {}, []
        self.on_step = None

    @property
    def free_slots(self):
        return self.max_sessions - len([s for s in self.sessions.values()
                                        if s.session_key not in self.released])

    def claim(self, session_key=None, prompt=None, seed=None):
        if self.free_slots <= 0:
            raise self.full("full")
        sess = self.sessions[session_key] = _Session(self, len(self.sessions), session_key)
        return sess

    def session(self, key):
        for s in self.sessions.values():
            if s.session_key == key and key not in self.released:
                return s
        return None

    def snapshot_session(self, key):
        sess = self.session(key)
        if sess is None:
            raise KeyError(key)
        return {"schema": self.schema, "kind": "scheduler", "counter": sess.counter,
                "prompt": sess.prompt}

    def restore_session(self, snap, key=None):
        if snap.get("schema") != self.schema:
            raise self.mismatch("schema")
        sess = self.sessions[key] = _Session(self, len(self.sessions), key, int(snap["counter"]))
        return sess

    def update_prompt(self, p):
        pass

    def update_t_index_list(self, t):
        pass

    def snapshot(self):
        return {"batchsched_sessions": self.max_sessions - self.free_slots}

    def session_snapshots(self):
        return {s.session_key: {"slot": s.slot} for s in self.sessions.values()
                if s.session_key not in self.released}

    def close(self):
        pass


class _Capture:
    status = 200

    def __init__(self):
        self.posted = []

    def __call__(self):
        return self

    async def post(self, url, headers=None, json=None):
        self.posted.append(json)
        return self


class _Ids:
    """Each id becomes <n> by its order of first appearance."""

    def __init__(self):
        self.seen = {}

    def __call__(self, text: str) -> str:
        return ID.sub(lambda m: self.seen.setdefault(m.group(0), f"<{len(self.seen)}>"), text)


def _norm(obj, ids):
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k.startswith(LEFT_OUT):
                continue
            if k in CLOCK_KEYS | KNOWN_APART or k.endswith(("_ms", "_ms_p50", "_ms_p99",
                                                              "_ms_p95")):
                out[k] = type(v).__name__
            else:
                out[ids(k)] = _norm(v, ids)
        return out
    if isinstance(obj, list):
        return [_norm(v, ids) for v in obj]
    if isinstance(obj, str):
        return ids(obj)
    return obj


WIRE = ("Content-Type", "Location", "Retry-After", "X-Stream-Id", "X-Journey-Id",
        "X-Journey-Leg")


async def _record(log, ids, label, resp):
    text = await resp.text()
    try:
        body = json.loads(text)
    except ValueError:
        body = text
    log.append([label, resp.status, {k: ids(resp.headers[k]) for k in WIRE if k in resp.headers},
                _norm(body, ids)])
    return body


async def _wait(pred, what):
    deadline = time.monotonic() + 15
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        await asyncio.sleep(0.05)


async def _scenario(root, monkeypatch) -> list:
    log, ids = [], _Ids()
    agent_mod = _mod(root, "server.agent")
    signaling = _mod(root, "server.signaling")
    clients = _Capture()
    router_app = _mod(root, "fleet.router").build_router_app(
        registry=_mod(root, "fleet.registry").FleetRegistry(dead_after=1),
        events_handler=_mod(root, "server.events").StreamEventHandler(
            session_factory=clients, webhook_url="http://clients.invalid/hook", token="t"))
    router = TestClient(TestServer(router_app))
    await router.start_server()
    scheds = [_Scheduler(root), _Scheduler(root)]
    apps, agents = [], []

    class _Stub:
        def __call__(self, frame):
            return frame

    try:
        for i, sched in enumerate(scheds):
            monkeypatch.setenv("WORKER_ID", f"agent{i}")
            app = agent_mod.build_app(pipeline=_Stub(), provider=signaling.LoopbackProvider(),
                                      batch_scheduler=sched)
            client = TestClient(TestServer(app))
            await client.start_server()
            apps.append(app)
            agents.append(client)
            r = await router.post("/fleet/register", json={
                "worker_id": f"agent{i}", "public_ip": "127.0.0.1",
                "public_port": str(client.server.port), "status": "ready", "capacity": 2})
            await _record(log, ids, f"register {i}", r)
        await router_app["poller"].poll_once()
        monkeypatch.setenv("WORKER_ID", "agent0")
        offer = {"room_id": "room", "offer": {"sdp": signaling.make_loopback_offer(),
                                              "type": "offer"}}
        r = await router.post("/offer", json=offer)
        await _record(log, ids, "offer", r)
        sid, jid = r.headers["X-Stream-Id"], r.headers["X-Journey-Id"]
        health = await (await agents[0].get("/health")).json()
        log.append(["agent0 journey context", _norm(
            health["sessions"][sid].get("context"), ids)])
        await _record(log, ids, "fragment", await agents[0].get(
            "/debug/flight", params={"journey": jid}))
        await _record(log, ids, "fragment unknown", await agents[0].get(
            "/debug/flight", params={"journey": "j-000000"}))
        scheds[0].session(sid)(np.zeros((4, 4, 3), np.uint8))
        await _record(log, ids, "drain migrate", await router.post(
            "/fleet/drain?agent=agent0&mode=migrate"))
        await _wait(lambda: any(e["event"] == "StreamMigrated" for e in clients.posted),
                    "StreamMigrated")
        r = await router.post("/offer", json=offer, headers={"X-Journey-Id": jid})
        await _record(log, ids, "re-offer", r)
        new = r.headers["X-Stream-Id"]
        log.append(["adopted", scheds[1].session(new).counter, sorted(apps[1]["imported_sessions"])])
        await _record(log, ids, "journey bundle", await router.get(f"/fleet/debug/journey/{jid}"))
        await _record(log, ids, "journeys", await router.get("/fleet/debug/journeys"))
        m = await (await router.get("/metrics")).json()
        log.append(["rollup", _norm({k: v for k, v in sorted(m.items())
                                     if k.startswith(("migration", "journey", "fleet_"))}, ids)])
        # the agent's migration surface refusing bad requests
        a = agents[1]
        await _record(log, ids, "export no session", await a.get("/migrate/export"))
        await _record(log, ids, "export unknown", await a.get("/migrate/export",
                                                               params={"session": "nobody"}))
        await _record(log, ids, "import bad json", await a.post("/migrate/import", data=b"{",
                                                                headers={"Content-Type": "x"}))
        await _record(log, ids, "import no token", await a.post("/migrate/import", json={}))
        await _record(log, ids, "import bad kind", await a.post(
            "/migrate/import", json={"token": "tk-1", "snapshot": {"kind": "mystery"}}))
        await _record(log, ids, "import old schema", await a.post(
            "/migrate/import", json={"token": "tk-2", "snapshot": {"kind": "scheduler",
                                                                   "schema": 1}}))
        await _record(log, ids, "import control plane", await a.post(
            "/migrate/import", json={"token": "tk-3", "snapshot": {"kind": "control-plane",
                                                                   "schema": 1}}))
        await _record(log, ids, "import again", await a.post(
            "/migrate/import", json={"token": "tk-3", "snapshot": {"kind": "control-plane",
                                                                   "schema": 1}}))
        monkeypatch.setenv("MIGRATE_ENABLE", "0")
        await _record(log, ids, "export off", await a.get("/migrate/export",
                                                          params={"session": new}))
        await _record(log, ids, "import off", await a.post("/migrate/import", json={}))
        monkeypatch.delenv("MIGRATE_ENABLE")
        monkeypatch.setenv("RECYCLE_ENABLE", "0")
        await _record(log, ids, "recycle off", await a.post("/admin/recycle", json={}))
        monkeypatch.delenv("RECYCLE_ENABLE")
        # the emptied source dies: nothing left to re-point
        await agents[0].close()
        await router_app["poller"].poll_once()
        await _record(log, ids, "fleet health", await router.get("/fleet/health"))
        log.append(["client webhooks", [_norm({k: v for k, v in e.items()
                                               if k not in ("reason",)}, ids)
                                        for e in clients.posted]])
    finally:
        for client in agents:
            await client.close()
        await router.close()
    return log


def test_migration_and_journey_transcripts_match_the_jax_stack(monkeypatch):
    got = {root: asyncio.run(_scenario(ROOTS[root], monkeypatch)) for root in ("jax", "torch")}
    for want, have in zip(got["jax"], got["torch"]):
        assert have == want, want[0]
    assert len(got["torch"]) == len(got["jax"])


async def _killswitch(root, monkeypatch) -> list:
    """JOURNEY_ENABLE=0: no journey minted or echoed; the debug endpoints
    404; mode=migrate refused."""
    monkeypatch.setenv("JOURNEY_ENABLE", "0")
    log, ids = [], _Ids()
    router_app = _mod(root, "fleet.router").build_router_app(poll=False)
    router = TestClient(TestServer(router_app))
    await router.start_server()
    app = _mod(root, "server.agent").build_app(
        pipeline=lambda f: f, provider=_mod(root, "server.signaling").LoopbackProvider(),
        batch_scheduler=_Scheduler(root))
    agent = TestClient(TestServer(app))
    await agent.start_server()
    try:
        await _record(log, ids, "register", await router.post("/fleet/register", json={
            "worker_id": "a", "public_ip": "127.0.0.1", "public_port": str(agent.server.port),
            "status": "ready", "capacity": 2}))
        offer = {"room_id": "r", "offer": {"sdp": _mod(root, "server.signaling")
                                           .make_loopback_offer(), "type": "offer"}}
        await _record(log, ids, "offer", await router.post("/offer", json=offer,
                                                           headers={"X-Journey-Id": "j-abcdef"}))
        await _record(log, ids, "agent offer with journey headers", await agent.post(
            "/offer", json=offer, headers={"X-Journey-Id": "j-123456", "X-Journey-Leg": "2"}))
        await _record(log, ids, "journeys", await router.get("/fleet/debug/journeys"))
        await _record(log, ids, "bundle", await router.get("/fleet/debug/journey/j-abcdef"))
        await _record(log, ids, "drain migrate", await router.post(
            "/fleet/drain?agent=a&mode=migrate"))
        await _record(log, ids, "upgrade", await router.post("/fleet/upgrade"))
        await _record(log, ids, "evacuate", await router.post("/fleet/evacuate",
                                                              json={"agent": "a"}))
    finally:
        await agent.close()
        await router.close()
    return log


def test_journey_kill_switch_transcripts_match_the_jax_stack(monkeypatch):
    got = {root: asyncio.run(_killswitch(ROOTS[root], monkeypatch)) for root in ("jax", "torch")}
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("header,value", [("X-Journey-Leg", "0"), ("X-Journey-Leg", "x"),
                                          ("X-Journey-Leg", "3")])
def test_agent_journey_binding_matches_the_jax_agent(header, value):
    """An /offer straight to the agent with the router's headers: the answer
    echoes them (a bad leg reads as 1), /health carries the binding, the
    fragment answers, and the session's webhooks would carry it."""
    async def one(root):
        ids = _Ids()
        app = _mod(root, "server.agent").build_app(
            pipeline=lambda f: f, provider=_mod(root, "server.signaling").LoopbackProvider(),
            batch_scheduler=_Scheduler(root))
        agent = TestClient(TestServer(app))
        await agent.start_server()
        log = []
        try:
            offer = {"room_id": "r", "offer": {"sdp": _mod(root, "server.signaling")
                                               .make_loopback_offer(), "type": "offer"}}
            r = await agent.post("/offer", json=offer,
                                 headers={"X-Journey-Id": "j-5e551e", header: value})
            await _record(log, ids, "offer", r)
            sid = r.headers["X-Stream-Id"]
            health = await (await agent.get("/health")).json()
            log.append(_norm(health["sessions"][sid].get("context"), ids))
            log.append(_norm(app["journey_map"], ids))
            await _record(log, ids, "fragment", await agent.get(
                "/debug/flight", params={"journey": "j-5e551e"}))
        finally:
            await agent.close()
        return log

    assert asyncio.run(one(ROOTS["torch"])) == asyncio.run(one(ROOTS["jax"]))
