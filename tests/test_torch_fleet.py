"""The fleet tier of the port against the JAX package's, scenario for scenario.

Every scenario of tests/test_fleet.py (registry, poller, placement,
Retry-After, drain, dead-agent re-pointing, event ingest, the rollup and
its Prometheus exposition, journeys, evidence and incident bundles) runs
twice: once on ``ai_rtc_agent_tpu`` and once on ``ai_rtc_agent_tpu_torch``
(the ``pkg`` fixture binds the module's names to the package under test),
with the same assertions, so the two routers, registries and agents
answer alike.  The port's router is its aiohttp layer (fleet/router.py)
over the framework-free core (fleet/routing.py)."""

import importlib

import asyncio
import json

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer
from _torch_threads import few_torch_threads  # noqa: F401,E402  (autouse)

ROOTS = {"jax": "ai_rtc_agent_tpu", "torch": "ai_rtc_agent_tpu_torch"}
_ROOT = ["ai_rtc_agent_tpu"]
# module-level names bound to the package under test: (module, name)
_NAMES = {'FleetPoller': ('fleet.registry', 'FleetPoller'), 'FleetRegistry': ('fleet.registry', 'FleetRegistry'), 'build_router_app': ('fleet.router', 'build_router_app'), 'StreamEventHandler': ('server.events', 'StreamEventHandler'), 'FrameStats': ('utils.profiling', 'FrameStats'), 'JourneyLog': ('fleet.journey', 'JourneyLog')}


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




def run(coro):
    return asyncio.run(coro)


class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _reg(**kw):
    kw.setdefault("clock", Clock())
    kw.setdefault("stats", FrameStats())
    return FleetRegistry(**kw)


def _info(wid, port=9000, **extra):
    return {"worker_id": wid, "public_ip": "127.0.0.1",
            "public_port": str(port), "status": "ready", **extra}


# ---------------------------------------------------------------------------
# registry: membership + health state machine
# ---------------------------------------------------------------------------

def test_register_bounded_and_revive():
    reg = _reg(max_agents=2)
    a = reg.register(_info("a", 9001, capacity=4))
    b = reg.register(_info("b", 9002))
    assert a.capacity == 4 and b.capacity == -1
    assert reg.register(_info("c", 9003)) is None  # bounded membership
    # refresh updates in place
    a2 = reg.register(_info("a", 9001, capacity=1, saturated=True))
    assert a2 is a and a.capacity == 1 and a.saturated
    # a recycled replacement publishing over a DEAD record revives fresh
    reg.mark_dead(a)
    a3 = reg.register(_info("a", 9001, capacity=4))
    assert a3 is not a and a3.state == "HEALTHY" and a3.fail_count == 0
    with pytest.raises(ValueError):
        reg.register({"status": "ready"})  # no identity


def test_poll_failures_mark_dead_once():
    died = []
    reg = _reg(dead_after=2, on_dead=died.append)
    a = reg.register(_info("a"))
    reg.note_poll_fail(a)
    assert a.state == "HEALTHY" and not died
    reg.note_poll_fail(a)
    assert a.state == "DEAD" and died == [a]
    reg.note_poll_fail(a)  # dead stays dead, on_dead fires ONCE
    assert died == [a]
    # a successful poll cannot resurrect a corpse — only re-registration
    reg.note_poll(a, {"capacity": 3}, {"status": "HEALTHY", "sessions": {}})
    assert a.state == "DEAD"


def test_poll_drives_states_and_drain_to_recyclable():
    reg = _reg()
    a = reg.register(_info("a"))
    reg.note_poll(a, {"capacity": 3, "saturated": False},
                  {"status": "DEGRADED", "sessions": {"s1": {}}})
    assert a.state == "DEGRADED" and a.live_sessions == 1 and a.capacity == 3
    reg.note_poll(a, None, {"status": "HEALTHY", "sessions": {}})
    assert a.state == "HEALTHY"
    # drain: state pins DRAINING; zero live sessions flips recyclable
    a.draining = True
    reg.note_poll(a, None, {"status": "HEALTHY", "sessions": {"s": {}}})
    assert a.state == "DRAINING" and not a.recyclable
    reg.note_poll(a, None, {"status": "HEALTHY", "sessions": {}})
    assert a.recyclable


def test_pick_least_loaded_with_tiers_and_backoff():
    clock = Clock()
    reg = _reg(clock=clock)
    a = reg.register(_info("a", capacity=1))
    b = reg.register(_info("b", capacity=3))
    assert reg.pick() is b  # most free capacity wins
    reg.note_placed(b)
    reg.note_placed(b)  # b effective 1, tie with a -> fewest live+placed
    assert reg.pick() is a
    reg.note_placed(a)
    assert reg.pick() is b  # a exhausted (effective 0)
    reg.note_placed(b)
    assert reg.pick() is None  # whole fleet structurally full
    # capacity poll resets the optimistic decrement
    reg.note_poll(b, {"capacity": 2, "saturated": False}, None)
    assert reg.pick() is b
    # Retry-After honor window: a backoff blocks pick until it expires
    b.backoff(30.0, clock())
    assert reg.pick() is None
    clock.now = 31.0
    assert reg.pick() is b
    # DEGRADED serves only when no HEALTHY agent can
    b.state = "DEGRADED"
    reg.note_poll(a, {"capacity": 1, "saturated": False}, None)
    a.state = "HEALTHY"
    assert reg.pick() is a
    a.state = "DEGRADED"
    assert reg.pick() in (a, b)
    a.state = "DEAD"
    b.state = "DEAD"
    assert reg.pick() is None


def test_unbounded_capacity_sorts_first_and_saturated_blocks():
    reg = _reg()
    a = reg.register(_info("a", capacity=5))
    b = reg.register(_info("b"))  # no capacity field -> unbounded (-1)
    assert reg.pick() is b
    b.saturated = True
    assert reg.pick() is a


def test_ingest_event_marks_owner_degraded():
    reg = _reg()
    a = reg.register(_info("a"))
    reg.ingest_event(
        {"event": "StreamDegraded", "state": "RETRACE_BREACH",
         "stream_id": "s1"},
        "a",
    )
    assert a.state == "DEGRADED"
    snap = reg.stats.snapshot()
    assert snap["fleet_breaches_total"] == 1
    assert snap["fleet_events_ingested_total"] == 1
    # unattributable events still count, mark nothing
    reg.ingest_event({"event": "StreamDegraded", "state": "DEGRADED",
                      "stream_id": "???"}, None)
    assert reg.stats.snapshot()["fleet_breaches_total"] == 2
    # recovery events are not breaches
    reg.ingest_event({"event": "StreamRecovered", "state": "HEALTHY",
                      "stream_id": "s1"}, "a")
    assert reg.stats.snapshot()["fleet_breaches_total"] == 2


def test_registry_snapshot_rollup_is_aggregate_only():
    reg = _reg()
    a = reg.register(_info("a", capacity=2))
    b = reg.register(_info("b", capacity=4))
    reg.note_poll(a, None, {"status": "HEALTHY",
                            "sessions": {"x": {}, "y": {}}})
    b.state = "DEAD"
    snap = reg.snapshot()
    assert snap["fleet_agents"] == 2
    assert snap["fleet_agents_healthy"] == 1
    assert snap["fleet_agents_dead"] == 1
    assert snap["fleet_sessions"] == 2
    assert snap["fleet_capacity_free"] == 2  # dead agent's 4 excluded
    # aggregate values only — nothing keyed by agent identity
    assert all(not isinstance(v, dict) for v in snap.values())


def test_retry_after_hint_is_soonest_agent():
    clock = Clock()
    reg = _reg(clock=clock)
    a = reg.register(_info("a"))
    b = reg.register(_info("b"))
    assert reg.retry_after_hint(2.0) == 2.0  # nothing hinted: default
    a.backoff(30.0, clock())
    b.backoff(5.0, clock())
    assert reg.retry_after_hint(2.0) == 5.0  # soonest admitting agent
    clock.now = 4.5
    # b's remaining window is 0.5s — floored at 1s so clients never hammer
    assert reg.retry_after_hint(2.0) == 1.0


# ---------------------------------------------------------------------------
# fake agent for router tests
# ---------------------------------------------------------------------------

class FakeAgent:
    """Minimal agent surface the router drives: /offer (+X-Stream-Id),
    /whip, /whep, /broadcast/pull, /capacity, /health, /drain — with a
    switchable 503 mode."""

    def __init__(self, name, capacity=2, retry_after=7):
        self.name = name
        self.capacity = capacity
        self.retry_after = retry_after
        self.mode = "ok"
        self.fail_delete = False  # transient 5xx mode for DELETE
        self.refuse_pull = False  # 409 mode for /broadcast/pull
        self.sessions: dict = {}
        self.hits = {"offer": 0, "whip": 0, "whep": 0, "pull": [],
                     "drain": [], "delete": [], "flight": []}
        # journey fragments served at GET /debug/flight?journey= —
        # {journey_id: fragment-dict}, set by tests simulating an agent
        # that holds records for the journey
        self.flight: dict = {}
        self.server = None

    def _app(self):
        app = web.Application()

        async def offer(req):
            self.hits["offer"] += 1
            if self.mode == "503":
                return web.Response(
                    status=503, text="overloaded",
                    headers={"Retry-After": str(self.retry_after)},
                )
            sid = f"{self.name}-s{len(self.sessions) + 1}"
            self.sessions[sid] = {
                "journey": req.headers.get("X-Journey-Id"),
                "leg": req.headers.get("X-Journey-Leg"),
            }
            headers = {"X-Stream-Id": sid}
            # a journey-aware agent echoes the binding (server/agent.py)
            if req.headers.get("X-Journey-Id"):
                headers["X-Journey-Id"] = req.headers["X-Journey-Id"]
                headers["X-Journey-Leg"] = req.headers.get(
                    "X-Journey-Leg", "1"
                )
            return web.json_response(
                {"sdp": "answer-sdp", "type": "answer"}, headers=headers
            )

        async def whip(req):
            self.hits["whip"] += 1
            sid = f"{self.name}-w{len(self.sessions) + 1}"
            self.sessions[sid] = {}
            return web.Response(
                status=201, text="answer-sdp",
                headers={"Location": f"/whip/{sid}"},
            )

        async def whep(req):
            self.hits["whep"] += 1
            sid = f"{self.name}-v{len(self.sessions) + 1}"
            self.sessions[sid] = {}
            return web.Response(
                status=201, text="answer-sdp",
                headers={"Location": f"/whep/{sid}"},
            )

        async def broadcast_pull(req):
            body = await req.json()
            self.hits["pull"].append(body["owner_url"])
            if self.refuse_pull:
                return web.Response(status=409, text="fan-out disabled")
            return web.json_response({"publisher": "default"})

        async def whip_delete(req):
            sid = req.match_info["session"]
            self.hits["delete"].append(sid)
            if self.fail_delete:
                return web.Response(status=503, text="transient")
            return web.Response(
                status=200 if self.sessions.pop(sid, None) is not None
                else 404
            )

        async def capacity(req):
            return web.json_response({
                "capacity": max(0, self.capacity - len(self.sessions)),
                "saturated": self.mode == "503",
                "retry_after_s": 0.0,
            })

        async def health(req):
            return web.json_response({
                "status": "HEALTHY",
                "sessions": {k: {} for k in self.sessions},
            })

        async def drain(req):
            body = await req.json()
            self.hits["drain"].append(body["action"])
            return web.json_response({"draining": body["action"] == "freeze"})

        async def debug_flight(req):
            jid = req.query.get("journey", "")
            self.hits["flight"].append(jid)
            frag = self.flight.get(jid)
            if frag is None:
                return web.json_response(
                    {"error": f"no records for journey {jid!r}"},
                    status=404,
                )
            return web.json_response(frag)

        app.router.add_post("/offer", offer)
        app.router.add_get("/debug/flight", debug_flight)
        app.router.add_post("/whip", whip)
        app.router.add_delete("/whip/{session}", whip_delete)
        app.router.add_post("/whep", whep)
        app.router.add_post("/broadcast/pull", broadcast_pull)
        app.router.add_get("/capacity", capacity)
        app.router.add_get("/health", health)
        app.router.add_post("/drain", drain)
        return app

    async def start(self):
        self.server = TestServer(self._app())
        await self.server.start_server()
        return self

    @property
    def port(self):
        return self.server.port

    async def close(self):
        await self.server.close()


async def _router(agents, *, clock=None, dead_after=3, events=None,
                  poll=False):
    reg = FleetRegistry(clock=clock or Clock(), dead_after=dead_after)
    app = build_router_app(registry=reg, poll=poll, events_handler=events)
    client = TestClient(TestServer(app))
    await client.start_server()
    for agent in agents:
        r = await client.post("/fleet/register", json=_info(
            agent.name, agent.port, capacity=agent.capacity
        ))
        assert r.status == 200
    return app, client, reg


_OFFER = {"room_id": "r1", "offer": {"sdp": "v=0 m=video", "type": "offer"}}


def test_router_places_and_proxies_offer():
    async def go():
        a = await FakeAgent("a").start()
        app, client, reg = await _router([a])
        try:
            r = await client.post("/offer", json=_OFFER)
            assert r.status == 200
            body = await r.json()
            assert body["type"] == "answer"
            assert r.headers["X-Stream-Id"] == "a-s1"
            assert app["session_table"].owner("a-s1") == "a"
            m = await (await client.get("/metrics")).json()
            assert m["fleet_placements_total"] == 1
            assert m["fleet_agents"] == 1
        finally:
            await client.close()
            await a.close()

    run(go())


def test_router_spreads_by_capacity():
    async def go():
        agents = [await FakeAgent(n).start() for n in ("a", "b", "c")]
        app, client, reg = await _router(agents)
        try:
            for _ in range(3):
                r = await client.post("/offer", json=_OFFER)
                assert r.status == 200
            # least-loaded greedy with optimistic decrement: one each
            assert [ag.hits["offer"] for ag in agents] == [1, 1, 1]
        finally:
            await client.close()
            for ag in agents:
                await ag.close()

    run(go())


def test_router_honors_retry_after_and_replaces():
    """A saturated agent's 503 carries Retry-After —
    the request re-places elsewhere, and that agent is NOT re-offered
    within its hint window (no hot loop)."""
    async def go():
        clock = Clock()
        sat = await FakeAgent("sat", capacity=8, retry_after=30).start()
        sat.mode = "503"
        ok = await FakeAgent("ok", capacity=2).start()
        app, client, reg = await _router([sat, ok], clock=clock)
        try:
            r = await client.post("/offer", json=_OFFER)
            assert r.status == 200  # re-placed onto the healthy agent
            assert sat.hits["offer"] == 1 and ok.hits["offer"] == 1
            # within the hint window the saturated agent is never retried
            r = await client.post("/offer", json=_OFFER)
            assert r.status == 200
            assert sat.hits["offer"] == 1 and ok.hits["offer"] == 2
            # after the window it becomes eligible again
            sat.mode = "ok"
            clock.now = 31.0
            reg.agents["sat"].saturated = False  # poll would clear this
            r = await client.post("/offer", json=_OFFER)
            assert r.status == 200
            assert sat.hits["offer"] == 2
            m = await (await client.get("/metrics")).json()
            assert m["fleet_placement_retries_total"] == 1
        finally:
            await client.close()
            await sat.close()
            await ok.close()

    run(go())


def test_fleet_saturated_returns_one_coherent_503():
    async def go():
        clock = Clock()
        a = await FakeAgent("a", retry_after=9).start()
        b = await FakeAgent("b", retry_after=4).start()
        a.mode = b.mode = "503"
        app, client, reg = await _router([a, b], clock=clock)
        try:
            r = await client.post("/offer", json=_OFFER)
            assert r.status == 503
            # ONE coherent refusal: the soonest agent's hint, not a fan
            # of client-visible retries
            assert int(r.headers["Retry-After"]) == 4
            assert a.hits["offer"] + b.hits["offer"] == 2  # once each
            # second request inside both windows: no agent contacted
            r = await client.post("/offer", json=_OFFER)
            assert r.status == 503
            assert int(r.headers["Retry-After"]) >= 1
            assert a.hits["offer"] + b.hits["offer"] == 2
            m = await (await client.get("/metrics")).json()
            assert m["fleet_rejects_total"] == 2
        finally:
            await client.close()
            await a.close()
            await b.close()

    run(go())


def test_whip_location_and_routed_delete():
    async def go():
        a = await FakeAgent("a").start()
        app, client, reg = await _router([a])
        try:
            r = await client.post(
                "/whip", data="v=0 m=video",
                headers={"Content-Type": "application/sdp"},
            )
            assert r.status == 201
            sid = r.headers["Location"].rsplit("/", 1)[-1]
            assert app["session_table"].owner(sid) == "a"
            r = await client.delete(f"/whip/{sid}")
            assert r.status == 200
            assert a.hits["delete"] == [sid]
            assert app["session_table"].owner(sid) is None
            # unknown session: the router answers, no agent guessing
            r = await client.delete("/whip/nope")
            assert r.status == 404
        finally:
            await client.close()
            await a.close()

    run(go())


def test_whep_edge_pull_places_viewer_off_owner():
    """Two-level fan-out: a /whep viewer lands on a NON-owner
    edge agent after the router arranges its single pulled copy of the
    publisher's stream (idempotent POST /broadcast/pull), so per-box
    viewer caps multiply across the fleet."""
    async def go():
        a = await FakeAgent("a").start()
        b = await FakeAgent("b").start()
        app, client, reg = await _router([a, b])
        try:
            r = await client.post(
                "/whip", data="v=0 m=video",
                headers={"Content-Type": "application/sdp"},
            )
            assert r.status == 201
            owner = a if a.hits["whip"] else b
            edge = b if owner is a else a
            r = await client.post(
                "/whep", data="viewer-offer",
                headers={"Content-Type": "application/sdp"},
            )
            assert r.status == 201
            # the edge was told where to pull from, then got the viewer
            assert edge.hits["pull"] == [f"http://127.0.0.1:{owner.port}"]
            assert edge.hits["whep"] == 1 and owner.hits["whep"] == 0
            sid = r.headers["Location"].rsplit("/", 1)[-1]
            assert app["session_table"].owner(sid) == edge.name
            m = await (await client.get("/metrics")).json()
            assert m["fleet_edge_pulls_total"] == 1
        finally:
            await client.close()
            await a.close()
            await b.close()

    run(go())


def test_whep_edge_pull_refusal_falls_back_to_owner():
    """An edge that refuses the pull (fan-out disabled there — 409) must
    not strand the viewer: the placement falls back to the owning agent,
    which is always correct, just not scaled out."""
    async def go():
        a = await FakeAgent("a").start()
        b = await FakeAgent("b").start()
        app, client, reg = await _router([a, b])
        try:
            r = await client.post(
                "/whip", data="v=0 m=video",
                headers={"Content-Type": "application/sdp"},
            )
            assert r.status == 201
            owner = a if a.hits["whip"] else b
            edge = b if owner is a else a
            edge.refuse_pull = True
            r = await client.post(
                "/whep", data="viewer-offer",
                headers={"Content-Type": "application/sdp"},
            )
            assert r.status == 201
            assert len(edge.hits["pull"]) == 1
            assert owner.hits["whep"] == 1 and edge.hits["whep"] == 0
            m = await (await client.get("/metrics")).json()
            assert m["fleet_edge_pull_refused_total"] == 1
            assert "fleet_edge_pulls_total" not in m
        finally:
            await client.close()
            await a.close()
            await b.close()

    run(go())


def test_drain_flow_to_recyclable_and_cancel():
    async def go():
        a = await FakeAgent("a").start()
        b = await FakeAgent("b").start()
        app, client, reg = await _router([a, b])
        try:
            # one live session on a
            r = await client.post("/offer", json=_OFFER)
            assert r.status == 200 and a.hits["offer"] == 1
            reg.agents["a"].live_sessions = 1
            r = await client.post("/fleet/drain?agent=a")
            body = await r.json()
            assert r.status == 200 and body["draining"]
            assert body["agent_ack"] and a.hits["drain"] == ["freeze"]
            assert not body["recyclable"]  # session still live
            # placement never lands on a draining agent
            r = await client.post("/offer", json=_OFFER)
            assert r.status == 200 and b.hits["offer"] == 1
            # sessions finish -> the poll feed flips recyclable
            a.sessions.clear()
            reg.note_poll(reg.agents["a"], None,
                          {"status": "HEALTHY", "sessions": {}})
            h = await (await client.get("/fleet/health")).json()
            assert h["agents"]["a"]["state"] == "DRAINING"
            assert h["agents"]["a"]["recyclable"]
            m = await (await client.get("/metrics")).json()
            assert m["fleet_drains_total"] == 1
            assert m["fleet_agents_recyclable"] == 1
            # cancel reverts both sides
            r = await client.post("/fleet/drain?agent=a&action=cancel")
            assert (await r.json())["draining"] is False
            assert a.hits["drain"] == ["freeze", "unfreeze"]
            assert reg.agents["a"].state == "HEALTHY"
            # unknown agent / bad action are client errors
            assert (await client.post("/fleet/drain?agent=zz")).status == 404
            assert (await client.post("/fleet/drain")).status == 400
            assert (
                await client.post("/fleet/drain?agent=a&action=zap")
            ).status == 400
        finally:
            await client.close()
            await a.close()
            await b.close()

    run(go())


def test_dead_agent_repoints_sessions_through_webhooks():
    """Crash replacement: DEAD agent -> every session the router placed
    there gets a StreamDegraded(state=AGENT_DEAD) webhook so the client
    re-offers; the table forgets the dead placements."""
    posted = []

    class FakeResp:
        status = 200

    class FakeSession:
        async def post(self, url, headers=None, json=None):
            posted.append(json)
            return FakeResp()

    async def go():
        a = await FakeAgent("a").start()
        b = await FakeAgent("b").start()
        events = StreamEventHandler(
            session_factory=FakeSession,
            webhook_url="http://client-notify.example/hook", token="t",
        )
        app, client, reg = await _router(
            [a, b], dead_after=2, events=events
        )
        try:
            for _ in range(2):
                assert (await client.post("/offer", json=_OFFER)).status == 200
            placed_a = [
                sid for sid in list(app["session_table"]._m)
                if app["session_table"].owner(sid) == "a"
            ]
            assert placed_a  # least-loaded spread put >=1 session on a
            rec = reg.agents["a"]
            reg.note_poll_fail(rec)
            reg.note_poll_fail(rec)
            assert rec.state == "DEAD"
            # webhook fan-out is fire-and-forget tasks — let them run
            await asyncio.sleep(0)
            await asyncio.gather(*list(events._tasks))
            assert len(posted) == len(placed_a)
            ev = posted[0]
            assert ev["event"] == "StreamDegraded"
            assert ev["state"] == "AGENT_DEAD"
            assert ev["stream_id"] in placed_a
            assert ev["room_id"] == "r1"
            for sid in placed_a:
                assert app["session_table"].owner(sid) is None
            # the client's re-offer lands on the replacement
            r = await client.post("/offer", json=_OFFER)
            assert r.status == 200
            assert r.headers["X-Stream-Id"].startswith("b-")
            m = await (await client.get("/metrics")).json()
            assert m["fleet_sessions_repointed_total"] == len(placed_a)
            assert m["fleet_agents_died_total"] == 1
        finally:
            await client.close()
            await a.close()
            await b.close()

    run(go())


def test_router_events_ingest_marks_owner_and_checks_token():
    async def go():
        a = await FakeAgent("a").start()
        events = StreamEventHandler(webhook_url=None, token="sekret")
        app, client, reg = await _router([a], events=events)
        try:
            assert (await client.post("/offer", json=_OFFER)).status == 200
            ev = {"event": "StreamDegraded", "state": "RETRACE_BREACH",
                  "stream_id": "a-s1", "room_id": "", "timestamp": 1}
            r = await client.post("/fleet/events", json=ev)
            assert r.status == 401  # token configured, none sent
            r = await client.post(
                "/fleet/events", json=ev,
                headers={"Authorization": "Bearer sekret"},
            )
            assert r.status == 200
            assert reg.agents["a"].state == "DEGRADED"
            m = await (await client.get("/metrics")).json()
            assert m["fleet_breaches_total"] == 1
        finally:
            await client.close()
            await a.close()

    run(go())


def test_register_endpoint_validates_and_bounds():
    async def go():
        reg = FleetRegistry(clock=Clock(), max_agents=1)
        app = build_router_app(registry=reg, poll=False)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.post("/fleet/register", json=_info("a", 9001))
            assert r.status == 200
            r = await client.post("/fleet/register", json=_info("b", 9002))
            assert r.status == 503 and "Retry-After" in r.headers
            r = await client.post("/fleet/register", data="not json")
            assert r.status == 400
            r = await client.post("/fleet/register", json={"status": "x"})
            assert r.status == 400
        finally:
            await client.close()

    run(go())


def test_poller_updates_and_detects_death():
    async def go():
        a = await FakeAgent("a", capacity=5).start()
        reg = FleetRegistry(clock=Clock(), dead_after=2)
        rec = reg.register(_info("a", a.port))
        poller = FleetPoller(reg, interval_s=999.0, timeout_s=1.0)
        await poller.start()
        try:
            a.sessions["s1"] = {}
            await poller.poll_once()
            assert rec.capacity == 4  # the agent's own counted view
            assert rec.live_sessions == 1
            assert rec.state == "HEALTHY"
            await a.close()  # the process "dies"
            await poller.poll_once()
            assert rec.state == "HEALTHY" and rec.fail_count == 1
            await poller.poll_once()
            assert rec.state == "DEAD"
        finally:
            await poller.stop()
            if a.server.started:
                await a.close()

    run(go())


# ---------------------------------------------------------------------------
# prometheus conformance of the fleet rollup
# ---------------------------------------------------------------------------

def test_fleet_metrics_prom_conformance():
    from test_promexport import validate_exposition

    async def go():
        a = await FakeAgent("a").start()
        app, client, reg = await _router([a])
        try:
            assert (await client.post("/offer", json=_OFFER)).status == 200
            r = await client.get("/metrics", params={"format": "prom"})
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/plain")
            text = await r.text()
            families = validate_exposition(text)
            assert families["fleet_placements_total"]["type"] == "counter"
            assert families["fleet_agents"]["type"] == "gauge"
            assert families["fleet_sessions"]["type"] == "gauge"
            # journey families ride the same rollup with
            # dedicated HELP rows
            assert families["journeys_total"]["type"] == "counter"
            assert families["journey_legs_total"]["type"] == "counter"
            assert families["journey_replacements_total"]["type"] == "counter"
            assert families["journeys_tracked"]["type"] == "gauge"
            assert families["journey_bundles_stored"]["type"] == "gauge"
            assert "# HELP journeys_total session journeys placed" in text
            assert ("# HELP journey_replacements_total crash re-placements"
                    in text)
            # NEVER labeled by unbounded agent/session/journey identity:
            # the fleet rollup is aggregate-only, so no sample —
            # including every journey family — carries any label at all
            for fam in families.values():
                for _name, labels, _v in fam["samples"]:
                    assert labels == {}, (fam, labels)
            r = await client.get("/metrics", params={"format": "nope"})
            assert r.status == 400
        finally:
            await client.close()
            await a.close()

    run(go())


# ---------------------------------------------------------------------------
# agent-side drain endpoint (the admission-freeze rung over HTTP)
# ---------------------------------------------------------------------------

def test_agent_drain_endpoint_freezes_admission():
    build_app = _imp('server.agent', 'build_app')
    LoopbackProvider = _imp('server.signaling', 'LoopbackProvider')
    make_loopback_offer = _imp('server.signaling', 'make_loopback_offer')

    class FakePipeline:
        def __call__(self, frame):
            return frame

        def update_prompt(self, p):
            pass

        def update_t_index_list(self, t):
            pass

    async def go():
        app = build_app(pipeline=FakePipeline(), provider=LoopbackProvider())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.post("/drain", json={"action": "freeze"})
            body = await r.json()
            assert r.status == 200 and body["draining"] and body["changed"]
            cap = await (await client.get("/capacity")).json()
            assert cap["saturated"] and cap["draining"]
            assert cap["capacity"] == 0
            h = await (await client.get("/health")).json()
            assert h["overload"]["draining"] and h["overload"]["frozen"]
            # a draining agent admits nothing, with a Retry-After
            r = await client.post("/offer", json={
                "room_id": "r",
                "offer": {"sdp": make_loopback_offer(), "type": "offer"},
            })
            assert r.status == 503 and "Retry-After" in r.headers
            m = await (await client.get("/metrics")).json()
            assert m["overload_draining"] == 1
            # freeze is idempotent; unfreeze restores admission
            r = await client.post("/drain", json={"action": "freeze"})
            assert (await r.json())["changed"] is False
            r = await client.post("/drain", json={"action": "unfreeze"})
            assert (await r.json())["draining"] is False
            r = await client.post("/offer", json={
                "room_id": "r",
                "offer": {"sdp": make_loopback_offer(), "type": "offer"},
            })
            assert r.status == 200
            assert r.headers["X-Stream-Id"]  # the router's session key
            # bad bodies are client errors
            assert (await client.post("/drain", data="x")).status == 400
            assert (
                await client.post("/drain", json={"action": "zap"})
            ).status == 400
        finally:
            await client.close()

    run(go())


def test_agent_drain_without_overload_plane_is_409(monkeypatch):
    build_app = _imp('server.agent', 'build_app')
    LoopbackProvider = _imp('server.signaling', 'LoopbackProvider')

    monkeypatch.setenv("OVERLOAD_CONTROL", "0")

    async def go():
        app = build_app(pipeline=object(), provider=LoopbackProvider())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r = await client.post("/drain", json={"action": "freeze"})
            assert r.status == 409
        finally:
            await client.close()

    run(go())


# ---------------------------------------------------------------------------
# review regressions
# ---------------------------------------------------------------------------

def test_register_evicts_dead_corpse_when_full():
    """Orchestrators recycle crashed agents under NEW ids — DEAD records
    must not lock replacements out of a bounded registry."""
    reg = _reg(max_agents=2)
    a = reg.register(_info("a", 9001))
    reg.register(_info("b", 9002))
    assert reg.register(_info("c", 9003)) is None  # full of LIVE agents
    reg.mark_dead(a)
    c = reg.register(_info("c", 9003))  # corpse evicted, newcomer admitted
    assert c is not None and "a" not in reg.agents
    assert len(reg.agents) == 2


def test_poller_survives_garbage_200s_and_counts_them_dead():
    """A reverse proxy answering 200 with a non-agent body (JSON array,
    error page) must neither kill the poll task (AttributeError on
    .get) nor read as health — the agent behind it still reaches DEAD."""
    async def go():
        app = web.Application()

        async def garbage(req):
            return web.json_response(["not", "an", "agent"])

        app.router.add_get("/capacity", garbage)
        app.router.add_get("/health", garbage)
        server = TestServer(app)
        await server.start_server()
        reg = FleetRegistry(clock=Clock(), dead_after=2)
        rec = reg.register(_info("gw", server.port))
        poller = FleetPoller(reg, interval_s=999.0, timeout_s=1.0)
        await poller.start()
        try:
            await poller.poll_once()
            assert rec.fail_count == 1 and rec.state == "HEALTHY"
            await poller.poll_once()  # the loop is still alive to get here
            assert rec.state == "DEAD"
        finally:
            await poller.stop()
            await server.close()

    run(go())


def test_stream_ended_forgets_session_table_entry():
    """StreamEnded ingest prunes the placement map: a long-ended session
    must not draw an AGENT_DEAD re-point later, nor crowd live sessions
    out of the bounded table."""
    async def go():
        a = await FakeAgent("a").start()
        events = StreamEventHandler(webhook_url=None, token=None)
        app, client, reg = await _router([a], events=events)
        try:
            assert (await client.post("/offer", json=_OFFER)).status == 200
            assert app["session_table"].owner("a-s1") == "a"
            r = await client.post("/fleet/events", json={
                "event": "StreamEnded", "stream_id": "a-s1",
                "room_id": "r1", "timestamp": 1,
            })
            assert r.status == 200
            assert app["session_table"].owner("a-s1") is None
        finally:
            await client.close()
            await a.close()

    run(go())


def test_routed_delete_keeps_mapping_on_agent_5xx():
    """A transient agent error on DELETE must not burn the placement
    mapping — the client's retry has to still route."""
    async def go():
        a = await FakeAgent("a").start()
        app, client, reg = await _router([a])
        try:
            r = await client.post(
                "/whip", data="v=0 m=video",
                headers={"Content-Type": "application/sdp"},
            )
            sid = r.headers["Location"].rsplit("/", 1)[-1]
            a.fail_delete = True
            r = await client.delete(f"/whip/{sid}")
            assert r.status == 503
            assert app["session_table"].owner(sid) == "a"  # retained
            a.fail_delete = False
            r = await client.delete(f"/whip/{sid}")  # retry routes + lands
            assert r.status == 200
            assert app["session_table"].owner(sid) is None
        finally:
            await client.close()
            await a.close()

    run(go())


def test_drain_before_first_poll_is_not_recyclable():
    """live_sessions defaults to 0 before any /health poll — draining a
    never-polled agent must not advertise recyclable (an orchestrator
    would hard-drop whatever it is actually serving)."""
    async def go():
        a = await FakeAgent("a").start()
        app, client, reg = await _router([a])
        try:
            assert reg.agents["a"].last_ok is None  # no poll ran
            r = await client.post("/fleet/drain?agent=a")
            body = await r.json()
            assert body["draining"] and not body["recyclable"]
            # polled evidence of zero sessions DOES flip it
            reg.note_poll(reg.agents["a"], None,
                          {"status": "HEALTHY", "sessions": {}})
            assert reg.agents["a"].recyclable
        finally:
            await client.close()
            await a.close()

    run(go())


# ---------------------------------------------------------------------------
# session journeys: correlation ids, the router ring, evidence
# auto-capture, incident bundles
# ---------------------------------------------------------------------------



def _jlog(monkeypatch=None, clock=None, **env):
    if monkeypatch is not None:
        for k, v in env.items():
            monkeypatch.setenv(k, str(v))
    return JourneyLog(clock=clock or Clock())


def test_journey_log_legs_ring_eviction_and_latency(monkeypatch):
    clock = Clock()
    jl = _jlog(monkeypatch, clock=clock, JOURNEY_MAX=2, JOURNEY_RING=4)
    j1 = jl.mint()
    assert jl.next_leg(j1) == 1 and not jl.known(j1)  # lazily materialized
    assert jl.place(j1, "a0", "s1", "offer", "room", retried=1) == 1
    assert jl.known(j1) and jl.journey_for_stream("s1") == j1
    # placement->first-frame latency off the StreamStarted ingest
    clock.now = 0.25
    jl.note_started("s1")
    snap = jl.snapshot()
    assert snap["journey_started_total"] == 1
    assert snap["journey_place_to_start_ms_p50"] == 250.0
    # re-placement increments the leg and the replacement counter
    assert jl.next_leg(j1) == 2
    assert jl.place(j1, "a1", "s2", "offer", "room") == 2
    rec = jl.get(j1)
    assert [leg["agent"] for leg in rec["legs"]] == ["a0", "a1"]
    kinds = [e["kind"] for e in rec["events"]]
    assert kinds == ["placed", "started", "re_placed"]
    assert rec["events"][0]["retried"] == 1
    assert jl.snapshot()["journey_replacements_total"] == 1
    # the ring is bounded (JOURNEY_RING=4): oldest entries evicted
    for i in range(6):
        jl.note(j1, "degraded", state="DEGRADED", i=i)
    assert len(jl.get(j1)["events"]) == 4
    # ended forgets the stream mapping, keeps the record
    jl.end_stream("s2")
    assert jl.journey_for_stream("s2") is None and jl.known(j1)
    # the journey TABLE is bounded (JOURNEY_MAX=2): oldest evicted with
    # its stream mappings
    j2, j3 = jl.mint(), jl.mint()
    jl.place(j2, "a0", "s3", "whip", "")
    jl.place(j3, "a0", "s4", "whip", "")
    assert not jl.known(j1) and jl.journey_for_stream("s1") is None
    assert jl.snapshot()["journeys_evicted_total"] == 1
    assert jl.snapshot()["journeys_tracked"] == 2
    # aggregate-only: nothing keyed by journey identity
    assert all(not isinstance(v, (dict, list))
               for v in jl.snapshot().values())


def test_journey_evidence_and_bundles_survive_eviction(monkeypatch):
    jl = _jlog(monkeypatch, JOURNEY_MAX=1, JOURNEY_EVIDENCE=2,
               JOURNEY_BUNDLES=2)
    j1 = jl.mint()
    jl.place(j1, "a0", "s1", "offer", "")
    for i in range(3):  # bounded evidence: oldest dropped
        jl.add_evidence(j1, "a0", {"snapshots": [], "i": i})
    assert [e["fragment"]["i"] for e in jl.evidence_for(j1)] == [1, 2]
    # re-seals COALESCE per journey: a flapping session's breach
    # volleys must not evict other journeys' only incident record
    jl.seal_bundle(j1, "breach DEGRADED")
    bundle = jl.seal_bundle(j1, "AGENT_DEAD a0")
    assert len(jl.bundles) == 1  # replaced, not appended
    assert jl.bundles_for(j1)[0]["reason"] == "AGENT_DEAD a0"
    assert bundle["journey_id"] == j1
    assert [e["kind"] for e in bundle["journey"]["events"]][-1] == "bundle"
    assert len(bundle["evidence"]) == 2
    # sealed bundles outlive the journey table's eviction churn
    j2 = jl.mint()
    jl.place(j2, "a1", "s2", "offer", "")
    assert not jl.known(j1)
    assert jl.bundles_for(j1) and jl.bundles_for(j1)[0]["reason"].startswith(
        "AGENT_DEAD"
    )
    assert jl.seal_bundle("j-unknown", "x") is None
    snap = jl.snapshot()
    assert snap["journey_bundles_sealed_total"] == 2
    assert snap["journey_evidence_captured_total"] == 3
    # an explicit leg (what the router already forwarded to the agent)
    # wins over the recomputed one — concurrent re-offers or a table
    # eviction racing the proxy await must not desync record vs agent
    jl.place(j2, "a2", "s9", "offer", "", leg=7)
    assert jl.get(j2)["legs"][-1]["leg"] == 7
    # a typo'd ring kind is a programming error, not telemetry
    with pytest.raises(ValueError):
        jl.note(j2, "agent-dead")


def test_journey_disabled_records_nothing(monkeypatch):
    monkeypatch.setenv("JOURNEY_ENABLE", "0")
    jl = JourneyLog(clock=Clock())
    assert jl.enabled is False
    jid = jl.mint()
    assert jl.place(jid, "a0", "s1", "offer", "") == 1
    assert not jl.known(jid)
    jl.note(jid, "degraded")
    assert jl.snapshot()["journey_events_total"] == 0


def _fragment(agent, jid, session="s", taken_at=10.0, snap_id="flt-1"):
    """A minimal agent-side journey fragment: one stored snapshot with a
    frame span + the journey binding (the shape server/agent.py serves
    at GET /debug/flight?journey=)."""
    return {
        "agent": agent,
        "journey_id": jid,
        "sessions": {},
        "snapshots": [{
            "id": snap_id,
            "session": session,
            "reason": "DEGRADED: test",
            "taken_at": taken_at,
            "journey": {"journey_id": jid, "leg": 1, "agent": agent},
            "events": [{"t": taken_at, "kind": "supervisor",
                        "old": "HEALTHY", "new": "DEGRADED"}],
            "frames": [{
                "frame_id": 1, "session": session, "born": taken_at,
                "terminal": "sent",
                "spans": [["engine_step", taken_at, taken_at + 0.01]],
                "marks": [["terminal:sent", taken_at + 0.01]],
            }],
        }],
        "devtel": {"phase": "serving", "recent_compiles": []},
    }


def test_router_mints_forwards_and_continues_journeys():
    """The correlation tentpole at the router: a placed session gets a
    journey id (forwarded to the agent, echoed to the client); an
    AGENT_DEAD webhook carries it; the client's re-offer echoing it
    continues the SAME journey with leg 2 on the replacement agent."""
    posted = []

    class FakeResp:
        status = 200

    class FakeSession:
        async def post(self, url, headers=None, json=None):
            posted.append(json)
            return FakeResp()

    async def go():
        a = await FakeAgent("a").start()
        b = await FakeAgent("b").start()
        events = StreamEventHandler(
            session_factory=FakeSession,
            webhook_url="http://client-notify.example/hook", token="t",
        )
        app, client, reg = await _router([a, b], dead_after=2,
                                         events=events)
        try:
            r = await client.post("/offer", json=_OFFER)
            assert r.status == 200
            jid = r.headers["X-Journey-Id"]
            assert jid.startswith("j-")
            assert r.headers["X-Journey-Leg"] == "1"
            sid = r.headers["X-Stream-Id"]
            # the agent saw the forwarded headers
            owner = app["session_table"].owner(sid)
            agent = a if owner == "a" else b
            assert agent.sessions[sid]["journey"] == jid
            jl = app["journeys"]
            rec = jl.get(jid)
            assert [e["kind"] for e in rec["events"]] == ["placed"]
            assert rec["legs"][0] == {
                "leg": 1, "agent": owner, "stream_id": sid, "kind": "offer",
                "room_id": "r1", "placed_at": rec["legs"][0]["placed_at"],
            }

            # the agent dies: the AGENT_DEAD webhook carries the journey
            # id and a bundle seals (with whatever evidence exists)
            dead_rec = reg.agents[owner]
            reg.note_poll_fail(dead_rec)
            reg.note_poll_fail(dead_rec)
            assert dead_rec.state == "DEAD"
            await asyncio.sleep(0)
            await asyncio.gather(*list(events._tasks))
            ev = next(e for e in posted if e.get("state") == "AGENT_DEAD")
            assert ev["journey_id"] == jid and ev["journey_leg"] == 1
            kinds = [e["kind"] for e in jl.get(jid)["events"]]
            assert "agent_dead" in kinds and "bundle" in kinds
            assert jl.bundles_for(jid)

            # the client re-offers echoing the id: SAME journey, leg 2,
            # on the surviving agent
            r = await client.post("/offer", json=_OFFER,
                                  headers={"X-Journey-Id": jid})
            assert r.status == 200
            assert r.headers["X-Journey-Id"] == jid
            assert r.headers["X-Journey-Leg"] == "2"
            survivor = "b" if owner == "a" else "a"
            assert app["session_table"].owner(
                r.headers["X-Stream-Id"]
            ) == survivor
            rec = jl.get(jid)
            assert rec["legs"][1]["leg"] == 2
            assert rec["legs"][1]["agent"] == survivor
            assert [e["kind"] for e in rec["events"]][-1] == "re_placed"

            # an UNKNOWN echoed id cannot graft onto ring state: a fresh
            # journey is minted instead
            r = await client.post("/offer", json=_OFFER,
                                  headers={"X-Journey-Id": "j-forged"})
            assert r.status == 200
            assert r.headers["X-Journey-Id"] != "j-forged"

            m = await (await client.get("/metrics")).json()
            assert m["journeys_total"] == 2
            assert m["journey_legs_total"] == 3
            assert m["journey_replacements_total"] == 1
            assert m["journey_bundles_sealed_total"] == 1
        finally:
            await client.close()
            await a.close()
            await b.close()

    run(go())


def test_breach_webhook_autocaptures_evidence_and_bundle():
    """The alert-path auto-capture: a StreamDegraded breach volley makes
    the router pull the owning agent's ?journey= fragment and seal a
    bundle — BEFORE any crash can erase the records."""
    async def go():
        a = await FakeAgent("a").start()
        events = StreamEventHandler(webhook_url=None, token=None)
        app, client, reg = await _router([a], events=events)
        try:
            r = await client.post("/offer", json=_OFFER)
            jid = r.headers["X-Journey-Id"]
            sid = r.headers["X-Stream-Id"]
            a.flight[jid] = _fragment("a", jid, session=sid)
            breach = {
                "event": "StreamDegraded", "state": "DEGRADED",
                "stream_id": sid, "room_id": "r1", "timestamp": 1,
                "journey_id": jid, "journey_leg": 1,
                "reason": "step timeout",
            }
            # a volley of near-simultaneous breach webhooks (DEGRADED →
            # FAILED within ms) dedups to ONE in-flight pull — duplicate
            # fragments must not churn the bounded evidence ring
            r = await client.post("/fleet/events", json=breach)
            assert r.status == 200
            r = await client.post(
                "/fleet/events", json={**breach, "state": "FAILED"}
            )
            assert r.status == 200
            await asyncio.gather(*list(app["journey_tasks"]))
            jl = app["journeys"]
            ev = jl.evidence_for(jid)
            assert len(ev) == 1 and ev[0]["agent"] == "a"
            assert ev[0]["fragment"]["snapshots"][0]["id"] == "flt-1"
            assert a.hits["flight"] == [jid]
            assert not app["journey_inflight"]  # key released with the task
            bundles = jl.bundles_for(jid)
            assert bundles and bundles[0]["reason"] == "breach DEGRADED"
            assert bundles[0]["evidence"]  # the capture rode the seal
            kinds = [e["kind"] for e in jl.get(jid)["events"]]
            assert kinds[:2] == ["placed", "degraded"]
            assert "evidence" in kinds and "bundle" in kinds
            # a session-table eviction must not blind the capture:
            # attribution falls back to the journey's own last leg
            app["session_table"].forget(sid)
            r = await client.post(
                "/fleet/events", json={**breach, "state": "SLO_BREACH"}
            )
            assert r.status == 200
            await asyncio.gather(*list(app["journey_tasks"]))
            assert len(jl.evidence_for(jid)) == 2
            assert a.hits["flight"] == [jid, jid]
            m = await (await client.get("/metrics")).json()
            assert m["journey_evidence_captured_total"] == 2
        finally:
            await client.close()
            await a.close()

    run(go())


def test_journey_bundle_endpoint_one_get_and_chrome_merge():
    """The one-GET incident bundle: router ring + stored evidence (the
    dead agent's) + live fragments (the survivor's) in one body, and
    ?format=chrome merging every captured leg into a single validated
    Perfetto doc with per-agent disjoint pids."""
    from test_obs import _validate_chrome

    async def go():
        a = await FakeAgent("a").start()
        b = await FakeAgent("b").start()
        events = StreamEventHandler(webhook_url=None, token=None)
        app, client, reg = await _router([a, b], dead_after=2,
                                         events=events)
        try:
            r = await client.post("/offer", json=_OFFER)
            jid = r.headers["X-Journey-Id"]
            sid = r.headers["X-Stream-Id"]
            owner = app["session_table"].owner(sid)
            dead_agent, live_agent = (a, b) if owner == "a" else (b, a)
            # breach -> evidence banked from the soon-to-die agent
            dead_agent.flight[jid] = _fragment(owner, jid, session=sid)
            await client.post("/fleet/events", json={
                "event": "StreamDegraded", "state": "RETRACE_BREACH",
                "stream_id": sid, "room_id": "r1", "timestamp": 1,
                "journey_id": jid,
            })
            await asyncio.gather(*list(app["journey_tasks"]))
            # the agent dies; the client re-offers onto the survivor
            rec = reg.agents[owner]
            reg.note_poll_fail(rec)
            reg.note_poll_fail(rec)
            r = await client.post("/offer", json=_OFFER,
                                  headers={"X-Journey-Id": jid})
            assert r.status == 200
            sid2 = r.headers["X-Stream-Id"]
            live_agent.flight[jid] = _fragment(
                live_agent.name, jid, session=sid2, taken_at=20.0,
                snap_id="flt-2",
            )
            live_agent.flight[jid]["snapshots"][0]["journey"]["leg"] = 2

            # ONE GET: the whole story
            r = await client.get(f"/fleet/debug/journey/{jid}")
            assert r.status == 200
            bundle = await r.json()
            kinds = [e["kind"] for e in bundle["journey"]["events"]]
            for expected in ("placed", "degraded", "agent_dead",
                             "re_placed"):
                assert expected in kinds, kinds
            # the dead agent's records came from the evidence store...
            assert [e["agent"] for e in bundle["evidence"]] == [owner]
            srcs = {f["source"] for f in bundle["fragments"]}
            assert "unreachable" in srcs  # the corpse answers nothing
            # ...the survivor's from the live fan-out
            live = [f for f in bundle["fragments"]
                    if f.get("source") == "live"]
            assert [f["agent"] for f in live] == [live_agent.name]
            assert bundle["bundles"]  # sealed on the alert paths
            # every piece shares the one journey id
            assert bundle["journey_id"] == jid
            assert all(
                s["journey"]["journey_id"] == jid
                for f in live for s in f["snapshots"]
            )

            # the merged Perfetto doc validates with per-agent pids
            r = await client.get(f"/fleet/debug/journey/{jid}",
                                 params={"format": "chrome"})
            assert r.status == 200
            doc = await r.json()
            evs = _validate_chrome(doc)
            agent_by_pid = {
                e["pid"]: e["args"]["agent"] for e in evs
                if e["ph"] == "M" and e["name"] == "process_name"
            }
            assert len(agent_by_pid) >= 2
            assert set(agent_by_pid.values()) == {owner, live_agent.name}
            assert all(
                e["args"]["journey_id"] == jid for e in evs
                if e["ph"] == "X"
            )

            # crisp error surfaces: unknown id 404, unknown param 400,
            # bad format 400 — all JSON bodies
            r = await client.get("/fleet/debug/journey/j-nope")
            assert r.status == 404 and "error" in await r.json()
            r = await client.get(f"/fleet/debug/journey/{jid}",
                                 params={"fromat": "chrome"})
            assert r.status == 400
            assert "fromat" in (await r.json())["error"]
            r = await client.get(f"/fleet/debug/journey/{jid}",
                                 params={"format": "jsonl"})
            assert r.status == 400
            # the directory endpoint lists it
            idx = await (await client.get("/fleet/debug/journeys")).json()
            assert [j["journey_id"] for j in idx["journeys"]] == [jid]
            assert idx["journeys"][0]["legs"] == 2
            assert idx["bundles"]
        finally:
            await client.close()
            await a.close()
            await b.close()

    run(go())


def test_journey_kill_switch_removes_plane(monkeypatch):
    monkeypatch.setenv("JOURNEY_ENABLE", "0")

    async def go():
        a = await FakeAgent("a").start()
        app, client, reg = await _router([a])
        try:
            assert app["journeys"] is None
            r = await client.post("/offer", json=_OFFER)
            assert r.status == 200
            assert "X-Journey-Id" not in r.headers
            assert a.sessions["a-s1"]["journey"] is None
            r = await client.get("/fleet/debug/journeys")
            assert r.status == 404 and "error" in await r.json()
            r = await client.get("/fleet/debug/journey/j-x")
            assert r.status == 404
            m = await (await client.get("/metrics")).json()
            assert "journeys_total" not in m
        finally:
            await client.close()
            await a.close()

    run(go())
