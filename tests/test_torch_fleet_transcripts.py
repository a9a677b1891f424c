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
two transcripts must then be equal, the broadcast plane's keys included.

The scenarios.  Migration and journeys: placement with a journey, the agent's journey context and
fragment, drain with ``mode=migrate`` (export, import, StreamMigrated, the
pinned re-offer adopted as leg 2), the journey bundle, the rollup, a crash
of the empty source (AGENT_DEAD, nothing to re-point), the agent's
migration surface refusing bad requests, and the kill switches
(``MIGRATE_ENABLE=0``, ``RECYCLE_ENABLE=0``, ``JOURNEY_ENABLE=0``).  The
edge pull, over the native tier and real loopback UDP: a publisher placed on
one agent, viewers placed through the router on the other, which answers
``POST /broadcast/pull`` with ``pulling`` and then ``exists``, counts as one
viewer at the owner and serves the owner's frames to its viewers;
``BROADCAST_EDGE_PULL=0`` answers 409 and pins the viewer to the owner.  The
evacuation of an agent holding a publisher and a broadcast viewer (chip_smoke
phase 10b's placement): the sweep moves the publisher and finds no session
to export for the viewer.
"""

import asyncio
import importlib
import json
import re
import time

import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

ROOTS = {"jax": "ai_rtc_agent_tpu", "torch": "ai_rtc_agent_tpu_torch"}
ID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}|j-[0-9a-f]{6,}|"
                r"mig-[0-9a-f]{12}|flt-\d+|[0-9a-f]{12}|127\.0\.0\.1:\d+")
CLOCK_KEYS = {"t", "ts", "at", "timestamp", "taken_at", "born", "dur", "written_at",
              "created_at", "placed_at", "started_at", "ended_at", "sealed_at", "last_ok",
              "age_s"}
# keys of the agents' bodies left out of the comparison: none since the
# broadcast plane was ported
LEFT_OUT = ()
# the device telemetry's build watchdog: jax.monitoring in JAX, the port's
# graph-cache wrap (obs/devtel.py), and the UDP ports the kernel hands out:
# compared by type
KNOWN_APART = {"watchdog", "server_port", "port"}


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
        return 255 - (frame.to_ndarray() if hasattr(frame, "to_ndarray") else np.asarray(frame))

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
            if k in LEFT_OUT:
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


# -- the broadcast plane across agents ----------------------------------------------------

SIZE = 64
SDP = {"Content-Type": "application/sdp"}


def _native_envelope(port, video):
    return json.dumps({"native_rtp": True, "video": video, "width": SIZE, "height": SIZE,
                       "client_addr": ["127.0.0.1", port]})


async def _register(router, agents, i, log, ids):
    r = await router.post("/fleet/register", json={
        "worker_id": f"agent{i}", "public_ip": "127.0.0.1",
        "public_port": str(agents[i].server.port), "status": "ready", "capacity": 2})
    await _record(log, ids, f"register {i}", r)


async def _native_fleet(root, monkeypatch, log, ids, clients=None, register=2):
    """A router and two agents on the native tier (fake schedulers), each
    agent's /broadcast/pull answers tapped into ``pulls``; the first
    ``register`` of them registered with the router."""
    rtc = _mod(root, "server.rtc_native")
    router_app = _mod(root, "fleet.router").build_router_app(
        registry=_mod(root, "fleet.registry").FleetRegistry(dead_after=1),
        events_handler=_mod(root, "server.events").StreamEventHandler(
            session_factory=clients or _Capture(), webhook_url="http://clients.invalid/hook",
            token="t"))
    router = TestClient(TestServer(router_app))
    await router.start_server()
    apps, agents, pulls = [], [], []
    for i in range(2):
        monkeypatch.setenv("WORKER_ID", f"agent{i}")
        app = _mod(root, "server.agent").build_app(
            pipeline=lambda f: f, batch_scheduler=_Scheduler(root),
            provider=rtc.NativeRtpProvider(default_width=SIZE, default_height=SIZE,
                                           use_h264=False))

        @web.middleware
        async def tap(request, handler, i=i):
            resp = await handler(request)
            if request.path == "/broadcast/pull":
                pulls.append([f"agent{i}", resp.status, json.loads(resp.text)
                              if resp.content_type == "application/json" else resp.text])
            return resp

        app.middlewares.append(tap)
        client = TestClient(TestServer(app))
        await client.start_server()
        apps.append(app)
        agents.append(client)
        if i < register:
            await _register(router, agents, i, log, ids)
    await router_app["poller"].poll_once()
    return router_app, router, apps, agents, pulls


def _client():
    """The browser's side, the same for both packages' agents: the port's
    native client (the JAX one's drain hands back no frames)."""
    from ai_rtc_agent_tpu_torch.media.rtp_client import NativeRtpClient

    return NativeRtpClient(SIZE, SIZE, use_h264=False).open()


async def _publish(router, apps, log, ids):
    pub = await _client()
    r = await router.post("/whip", data=pub.offer_envelope(), headers=SDP)
    body = await _record(log, ids, "whip", r)
    await pub.connect(body["server_port"])
    owner = next(i for i, a in enumerate(apps) if a["state"]["whip_pcs"])
    return pub, owner


async def _view(router, apps, log, ids, label):
    v = await _client()
    r = await router.post("/whep", data=_native_envelope(v.port, False), headers=SDP)
    await _record(log, ids, label, r)
    sid = r.headers["Location"].rsplit("/", 1)[1]
    return v, next(i for i, a in enumerate(apps) if sid in a["state"]["whep_pcs"])


async def _edge_pull(root, monkeypatch) -> list:
    log, ids = [], _Ids()
    router_app, router, apps, agents, pulls = await _native_fleet(root, monkeypatch, log, ids)
    clients = []
    try:
        pub, owner = await _publish(router, apps, log, ids)
        clients.append(pub)
        placed = []
        for label in ("viewer 1", "viewer 2"):
            v, at = await _view(router, apps, log, ids, label)
            clients.append(v)
            placed.append(at)
        log.append(["viewers on the edge", [at != owner for at in placed]])
        log.append(["pulls", _norm(pulls, ids)])
        frames = [np.random.default_rng(70 + i).integers(0, 256, (SIZE, SIZE, 3), np.uint8)
                  for i in range(4)]
        got = [{}, {}]
        for i, arr in enumerate(frames):
            pub.send(arr, i)
            deadline = time.monotonic() + 15
            while not all(3000 * i in g for g in got):
                assert time.monotonic() < deadline, f"frame {i} did not reach both viewers"
                await asyncio.sleep(0.01)
                for v, g in zip(clients[1:], got):
                    v.drain(lambda a, pts, g=g: g.setdefault(pts, a.copy()))
        log.append(["viewed", [[bool(np.array_equal(g[3000 * i], 255 - arr))
                                for i, arr in enumerate(frames)] for g in got]])
        for i, client in enumerate(agents):
            m = await (await client.get("/metrics")).json()
            role = "owner" if i == owner else "edge"
            log.append([f"{role} broadcast", _norm(m["broadcast"], ids),
                        sorted(_norm({k: v["viewers"] for k, v in
                                      m.get("broadcast_sessions", {}).items()}, ids).items())])
        edge_app = apps[1 - owner]
        log.append(["edge pulled AUs", edge_app["state"]["edge_puller"].aus >= len(frames)])
        monkeypatch.setenv("BROADCAST_EDGE_PULL", "0")
        await _record(log, ids, "pull off", await agents[1 - owner].post(
            "/broadcast/pull", json={"owner_url": "http://127.0.0.1:1"}))
        v, at = await _view(router, apps, log, ids, "viewer with the pull off")
        clients.append(v)
        log.append(["pinned to the owner", at == owner])
        monkeypatch.delenv("BROADCAST_EDGE_PULL")
        await _record(log, ids, "pull bad body", await agents[1 - owner].post(
            "/broadcast/pull", data=b"{", headers={"Content-Type": "application/json"}))
        await _record(log, ids, "pull no owner", await agents[1 - owner].post(
            "/broadcast/pull", json={}))
        m = await (await router.get("/metrics")).json()
        log.append(["router edge pulls", {k: v for k, v in sorted(m.items())
                                          if k.startswith("fleet_edge_pull")}])
    finally:
        for c in clients:
            c.close()
        for client in agents:
            await client.close()
        await router.close()
    return log


def test_edge_pull_transcripts_match_the_jax_stack(monkeypatch):
    if any(_mod(r, "media.native").load() is None for r in ROOTS.values()):
        pytest.skip("native lib unavailable (the edge's depacketizer)")
    monkeypatch.setenv("WARMUP_FRAMES", "0")
    got = {root: asyncio.run(_edge_pull(ROOTS[root], monkeypatch)) for root in ("jax", "torch")}
    for want, have in zip(got["jax"], got["torch"]):
        assert have == want, want[0]
    assert len(got["torch"]) == len(got["jax"])
    log = dict((e[0], e[1:]) for e in got["torch"])
    assert log["viewers on the edge"] == [[True, True]]
    assert [p[2]["status"] for p in log["pulls"][0]] == ["pulling", "exists"]
    assert log["viewed"] == [[[True] * 4, [True] * 4]]
    assert log["owner broadcast"][0]["broadcast_viewers"] == 1  # the edge's one pull
    assert log["edge broadcast"][0]["broadcast_viewers"] == 2
    assert log["pull off"][0] == 409 and log["pinned to the owner"] == [True]


async def _evacuate_viewer(root, monkeypatch) -> list:
    """Phase 10b's placement on the native tier: a publisher and a WHEP
    viewer on agent A (placed while A is the fleet's only agent, so the
    viewer's edge is its owner), B registered, then ``/fleet/evacuate`` of
    A."""
    log, ids, clients = [], _Ids(), _Capture()
    router_app, router, apps, agents, _ = await _native_fleet(root, monkeypatch, log, ids,
                                                              clients, register=1)
    peers = []
    try:
        pub, owner = await _publish(router, apps, log, ids)
        peers.append(pub)
        v, at = await _view(router, apps, log, ids, "viewer")
        peers.append(v)
        log.append(["on the owner", at == owner, sum(g.viewer_count for g in
                                                       apps[owner]["state"]["broadcast_groups"]
                                                       .values())])
        await _register(router, agents, 1, log, ids)
        await router_app["poller"].poll_once()
        r = await router.post("/fleet/evacuate", json={"agent": f"agent{owner}"},
                              headers={"Authorization": "Bearer t"})
        await _record(log, ids, "evacuate", r)
        await _wait(lambda: not router_app["migrate_sweeps"], "the evacuation sweep")
        m = await (await router.get("/metrics")).json()
        log.append(["rollup", _norm({k: v for k, v in sorted(m.items())
                                     if k.startswith(("migration", "evacuation"))}, ids)])
        log.append(["client webhooks", [_norm({k: v for k, v in e.items() if k != "reason"}, ids)
                                        for e in clients.posted]])
        log.append(["target holds", [sorted(a["imported_sessions"]) != [] for a in apps]])
        await _record(log, ids, "viewer export", await agents[owner].get(
            "/migrate/export", params={"session": next(iter(apps[owner]["state"]["whep_pcs"]))}))
    finally:
        for c in peers:
            c.close()
        for client in agents:
            await client.close()
        await router.close()
    return log


def test_evacuating_a_broadcast_viewer_matches_the_jax_stack(monkeypatch):
    """The sweep counts the viewer among A's sessions and its export answers
    404 on both packages: the reference's behaviour, kept."""
    if any(_mod(r, "media.native").load() is None for r in ROOTS.values()):
        pytest.skip("native lib unavailable")
    monkeypatch.setenv("WARMUP_FRAMES", "0")
    got = {root: asyncio.run(_evacuate_viewer(ROOTS[root], monkeypatch))
           for root in ("jax", "torch")}
    for want, have in zip(got["jax"], got["torch"]):
        assert have == want, want[0]
    assert len(got["torch"]) == len(got["jax"])
    log = dict((e[0], e[1:]) for e in got["torch"])
    assert log["evacuate"][0] == 200 and log["evacuate"][2]["evacuating"] == 2
    assert log["viewer export"][0] == 404
