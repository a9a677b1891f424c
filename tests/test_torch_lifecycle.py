"""The fleet lifecycle of the port against the JAX package's, scenario for
scenario.

Every scenario of tests/test_fleet_lifecycle.py (epochs and boot ids, the
handoff file round trip, the re-exec argv, the agent's /admin/recycle and
its handoff import before the agent reports healthy, AGENT_RECYCLED
re-pins, the rolling upgrade and its halts and cancel, autoscale) runs on
``ai_rtc_agent_tpu`` and on ``ai_rtc_agent_tpu_torch`` with the same
assertions (the ``pkg`` fixture binds the module's names to the package
under test)."""

import importlib

import asyncio
import os

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer
from _torch_threads import few_torch_threads  # noqa: F401,E402  (autouse)

ROOTS = {"jax": "ai_rtc_agent_tpu", "torch": "ai_rtc_agent_tpu_torch"}
_ROOT = ["ai_rtc_agent_tpu"]
# module-level names bound to the package under test: (module, name)
_NAMES = {'AutoscaleController': ('fleet.registry', 'AutoscaleController'), 'FleetPoller': ('fleet.registry', 'FleetPoller'), 'FleetRegistry': ('fleet.registry', 'FleetRegistry'), 'build_router_app': ('fleet.router', 'build_router_app'), 'lifecycle': ('server', 'lifecycle'), 'FrameStats': ('utils.profiling', 'FrameStats')}


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
# registry epochs: the old-process-ghost shape
# ---------------------------------------------------------------------------

def test_same_url_new_boot_bumps_epoch():
    reg = _reg()
    a = reg.register(_info("a", 9001, boot_id="b1", capacity=4))
    assert a.epoch == 1 and a.boot_id == "b1"
    # same publish refreshes in place — no bump
    assert reg.register(_info("a", 9001, boot_id="b1")) is a and a.epoch == 1
    # SAME address, NEW process nonce: the restart-in-place recycle —
    # fresh record, epoch bumped
    a2 = reg.register(_info("a", 9001, boot_id="b2", capacity=4))
    assert a2 is not a and a2.epoch == 2 and a2.boot_id == "b2"
    assert reg.agents["a"] is a2


def test_retired_boot_ghost_publish_dropped():
    stats = FrameStats()
    reg = _reg(stats=stats)
    reg.register(_info("a", 9001, boot_id="b1"))
    a2 = reg.register(_info("a", 9001, boot_id="b2"))
    assert a2.epoch == 2
    # the OLD process's worker sidecar republishing after the swap: the
    # record must not absorb the ghost's capacity view
    ghost = reg.register(_info("a", 9001, boot_id="b1", capacity=1))
    assert ghost is a2 and a2.epoch == 2 and a2.capacity == -1
    assert stats.snapshot()["fleet_stale_epoch_dropped_total"] == 1


def test_dead_revival_and_address_change_bump_epoch():
    reg = _reg()
    a = reg.register(_info("a", 9001, boot_id="b1"))
    reg.mark_dead(a)
    a2 = reg.register(_info("a", 9001, boot_id="b2"))
    assert a2.epoch == 2 and a2.state == "HEALTHY"
    a3 = reg.register(_info("a", 9002, boot_id="b2"))  # new address
    assert a3.epoch == 3
    # a bootless first publish later learning its nonce is NOT a swap
    b = reg.register(_info("b", 9003))
    assert b.epoch == 1 and b.boot_id == ""
    assert reg.register(_info("b", 9003, boot_id="x")) is b and b.epoch == 1


def test_poller_drops_superseded_poll_answer():
    stats = FrameStats()
    reg = _reg(stats=stats)
    a = reg.register(_info("a", 9001, boot_id="b1"))
    poller = FleetPoller(reg, interval_s=0.01, timeout_s=0.5)

    async def fake_get(url):
        # the record is superseded while this poll's HTTP is in flight:
        # the bodies describe the OLD process
        reg.register(_info("a", 9001, boot_id="b2"))
        if url.endswith("/capacity"):
            return {"capacity": 0, "saturated": True, "boot_id": "b1"}
        return {"status": "DEGRADED", "sessions": {"s": {}}}

    poller._get_json = fake_get

    async def go():
        await poller._poll_agent(a)

    run(go())
    new = reg.agents["a"]
    assert new.epoch == 2
    # the ghost answer touched NOTHING on the new record
    assert new.capacity == -1 and not new.saturated and new.state == "HEALTHY"
    assert stats.snapshot()["fleet_stale_epoch_dropped_total"] >= 1


def test_poller_drops_foreign_boot_answer():
    stats = FrameStats()
    reg = _reg(stats=stats)
    a = reg.register(_info("a", 9001, boot_id="b1"))
    poller = FleetPoller(reg, interval_s=0.01, timeout_s=0.5)

    async def fake_get(url):
        # a recycled replacement bound the port before its worker
        # re-registered: its answers carry a DIFFERENT nonce
        if url.endswith("/capacity"):
            return {"capacity": 9, "saturated": False, "boot_id": "b2"}
        return {"status": "HEALTHY", "sessions": {}}

    poller._get_json = fake_get
    run(poller._poll_agent(a))
    assert a.capacity == -1 and a.last_ok is None
    assert stats.snapshot()["fleet_stale_epoch_dropped_total"] == 1


# ---------------------------------------------------------------------------
# router webhook attribution across epochs
# ---------------------------------------------------------------------------

def test_router_drops_stale_epoch_webhook_but_not_recycled():
    async def go():
        reg = FleetRegistry(clock=Clock(), stats=None)
        app = build_router_app(registry=reg, poll=False)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            await client.post("/fleet/register",
                              json=_info("a", 9001, boot_id="b1"))
            # a placement from epoch 1
            app["session_table"].remember(
                "s1", "a", "r1", "offer", epoch=reg.agents["a"].epoch
            )
            # the agent recycles: epoch moves under the same address
            await client.post("/fleet/register",
                              json=_info("a", 9001, boot_id="b2"))
            assert reg.agents["a"].epoch == 2
            # an ordinary breach webhook minted by the OLD process: drop
            r = await client.post("/fleet/events", json={
                "event": "StreamDegraded", "stream_id": "s1",
                "state": "DEGRADED", "reason": "late ghost",
            })
            assert r.status == 200
            m = await (await client.get("/metrics")).json()
            assert m["fleet_stale_epoch_dropped_total"] == 1
            assert m.get("fleet_breaches_total", 0) == 0
            # AGENT_RECYCLED is exempt — only the NEW process announces
            # the swap, and the announce races the worker re-register
            r = await client.post("/fleet/events", json={
                "event": "StreamDegraded", "stream_id": "s1",
                "state": "AGENT_RECYCLED", "reason": "recycled",
            })
            assert r.status == 200
            m = await (await client.get("/metrics")).json()
            assert m["fleet_recycled_sessions_total"] == 1
            # the re-offer mints a fresh stream id: the old row is gone
            assert app["session_table"].owner("s1") is None
        finally:
            await client.close()

    run(go())


# ---------------------------------------------------------------------------
# autoscale controller: hysteresis, cooldown, retire choice
# ---------------------------------------------------------------------------

def _ctl(reg, clock, **kw):
    kw.setdefault("enabled", True)
    kw.setdefault("alpha", 1.0)  # no smoothing: deterministic streaks
    kw.setdefault("up_ticks", 3)
    kw.setdefault("down_ticks", 3)
    kw.setdefault("cooldown_s", 30.0)
    return AutoscaleController(reg, clock=clock, **kw)


def test_autoscale_spawns_exactly_once_under_sustained_pressure():
    clock = Clock()
    reg = _reg(clock=clock)
    a = reg.register(_info("a", 9001, capacity=2))
    a.saturated = True  # sustained 503 pressure
    ctl = _ctl(reg, clock)
    decisions = []
    for _ in range(20):  # way past up_ticks: hysteresis must pin at ONE
        clock.now += 1.0
        decisions.append(ctl.tick())
    assert decisions.count("up") == 1
    assert decisions.index("up") == 2  # the third >= high read
    # cooldown elapsed + still saturated -> exactly one more
    clock.now += 31.0
    more = [ctl.tick() for _ in range(5)]
    assert more.count("up") == 1


def test_autoscale_reject_pressure_and_disabled_default():
    clock = Clock()
    reg = _reg(clock=clock)
    reg.register(_info("a", 9001, capacity=8))  # plenty of headroom
    ctl = _ctl(reg, clock)
    # router-level 503s override the calm per-agent reads
    assert ctl.sample(rejects_total=1) == 1.0
    assert ctl.sample(rejects_total=1) == 0.0  # no NEW rejects: calm
    # default-off: inert no matter the pressure
    off = AutoscaleController(reg, clock=clock)
    assert off.enabled is False and off.tick(rejects_total=99) is None


def test_autoscale_retires_emptiest_and_respects_floor():
    clock = Clock()
    reg = _reg(clock=clock)
    a = reg.register(_info("a", 9001, capacity=8))
    b = reg.register(_info("b", 9002, capacity=8))
    a.live_sessions = 3
    b.live_sessions = 1
    ctl = _ctl(reg, clock, min_agents=1)
    assert ctl.retire_candidate() is b  # emptiest healthy box
    b.draining = True  # mid-retire: not a candidate twice
    assert ctl.retire_candidate() is None  # a alone == min_agents floor
    b.draining = False
    decisions = []
    for _ in range(5):  # idle fleet: EWMA sits at 0 <= low
        clock.now += 1.0
        decisions.append(ctl.tick())
    assert decisions.count("down") == 1


# ---------------------------------------------------------------------------
# rolling upgrade sweep (in-process, fake agents)
# ---------------------------------------------------------------------------

class LifecycleAgent:
    """Fake agent for upgrade-sweep tests: /health, /capacity (with the
    process nonce), /drain, and an /admin/recycle that either swaps the
    nonce (success) or refuses."""

    def __init__(self, name, recycle_status=202):
        self.name = name
        self.boot = f"{name}-boot1"
        self.recycle_status = recycle_status
        self.recycles = 0
        self.drains = []
        self.server = None

    def _app(self):
        app = web.Application()

        async def health(req):
            return web.json_response({"status": "HEALTHY", "sessions": {}})

        async def capacity(req):
            return web.json_response({
                "capacity": 2, "saturated": False, "boot_id": self.boot,
            })

        async def drain(req):
            self.drains.append((await req.json())["action"])
            return web.json_response({"draining": True})

        async def recycle(req):
            self.recycles += 1
            if self.recycle_status >= 400:
                return web.json_response(
                    {"error": "refused"}, status=self.recycle_status
                )
            self.boot = f"{self.name}-boot{self.recycles + 1}"
            return web.json_response({"recycling": True}, status=202)

        app.router.add_get("/health", health)
        app.router.add_get("/capacity", capacity)
        app.router.add_post("/drain", drain)
        app.router.add_post("/admin/recycle", recycle)
        return app

    async def start(self):
        self.server = TestServer(self._app())
        await self.server.start_server()
        return self

    async def close(self):
        await self.server.close()


async def _upgrade_router(agents, **env_keys):
    reg = FleetRegistry(clock=Clock())
    app = build_router_app(registry=reg, poll=False)
    app["upgrade_step_timeout_s"] = env_keys.pop("step_timeout", 5.0)
    client = TestClient(TestServer(app))
    await client.start_server()
    for agent in agents:
        r = await client.post("/fleet/register", json=_info(
            agent.name, agent.server.port, boot_id=agent.boot, capacity=2
        ))
        assert r.status == 200
        # polled evidence: the sweep refuses to recycle a record whose
        # live_sessions is only the pre-first-poll default
        reg.note_poll(reg.agents[agent.name], {"capacity": 2},
                      {"status": "HEALTHY", "sessions": {}})
    return app, client, reg


async def _wait_upgrade_idle(app, client, agents, budget=5.0):
    """Drive the sweep to completion, playing the worker-republish part
    (the real fleet's sidecar re-registers the replacement's nonce)."""
    deadline = asyncio.get_event_loop().time() + budget
    while app["upgrade"]["active"]:
        assert asyncio.get_event_loop().time() < deadline, "sweep stuck"
        for agent in agents:
            rec = app["fleet"].agents.get(agent.name)
            if rec is not None and rec.boot_id != agent.boot:
                await client.post("/fleet/register", json=_info(
                    agent.name, agent.server.port, boot_id=agent.boot,
                    capacity=2,
                ))
                rec = app["fleet"].agents[agent.name]
                app["fleet"].note_poll(rec, {"capacity": 2},
                                       {"status": "HEALTHY", "sessions": {}})
        await asyncio.sleep(0.05)


def test_upgrade_sweeps_all_agents_and_bumps_epochs():
    async def go():
        a = await LifecycleAgent("a").start()
        b = await LifecycleAgent("b").start()
        app, client, reg = await _upgrade_router([a, b])
        try:
            r = await client.post("/fleet/upgrade")
            assert r.status == 202 and (await r.json())["active"]
            # double-start refused while the sweep runs
            assert (await client.post("/fleet/upgrade")).status == 409
            await _wait_upgrade_idle(app, client, [a, b])
            up = (await (await client.get("/fleet/health")).json())["upgrade"]
            assert up["halted"] is None and sorted(up["done"]) == ["a", "b"]
            assert a.recycles == 1 and b.recycles == 1
            assert reg.agents["a"].epoch == 2 and reg.agents["b"].epoch == 2
            m = await (await client.get("/metrics")).json()
            assert m["fleet_upgrades_total"] == 1
        finally:
            await client.close()
            await a.close()
            await b.close()

    run(go())


def test_upgrade_halts_on_recycle_refusal_leaving_agent_serving():
    async def go():
        a = await LifecycleAgent("a", recycle_status=409).start()
        b = await LifecycleAgent("b").start()
        app, client, reg = await _upgrade_router([a, b])
        try:
            r = await client.post("/fleet/upgrade")
            assert r.status == 202
            await _wait_upgrade_idle(app, client, [a, b])
            up = app["upgrade"]
            assert up["halted"] and up["halted"].startswith("a:")
            assert "recycle refused" in up["halted"]
            # the failed step un-drained its target: still serving
            rec = reg.agents["a"]
            assert rec.draining is False and rec.state != "DEAD"
            assert a.drains[-1] == "unfreeze"
            # the sweep stopped BEFORE b
            assert b.recycles == 0 and up["done"] == []
            m = await (await client.get("/metrics")).json()
            assert m["fleet_upgrade_halts_total"] == 1
            assert m.get("fleet_upgrades_total", 0) == 0
            # a fresh start is allowed once the halted sweep is inactive
            a.recycle_status = 202
            assert (await client.post("/fleet/upgrade")).status == 202
            await _wait_upgrade_idle(app, client, [a, b])
            assert app["upgrade"]["halted"] is None
        finally:
            await client.close()
            await a.close()
            await b.close()

    run(go())


def test_upgrade_cancel_undrains_current_target():
    async def go():
        a = await LifecycleAgent("a").start()
        app, client, reg = await _upgrade_router([a], step_timeout=10.0)
        try:
            # a live session pins the drain-to-zero wait open (nothing in
            # the session table to move — the poll view says busy)
            reg.note_poll(reg.agents["a"], {"capacity": 2},
                          {"status": "HEALTHY", "sessions": {"s": {}}})
            r = await client.post("/fleet/upgrade")
            assert r.status == 202
            await asyncio.sleep(0.2)
            assert app["upgrade"]["current"] == "a"
            r = await client.post("/fleet/upgrade", params={
                "action": "cancel"
            })
            assert r.status == 200
            deadline = asyncio.get_event_loop().time() + 5.0
            while app["upgrade"]["active"]:
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.02)
            assert "cancelled" in (app["upgrade"]["halted"] or "")
            rec = reg.agents["a"]
            assert rec.draining is False and a.recycles == 0
            assert a.drains[-1] == "unfreeze"
        finally:
            await client.close()
            await a.close()

    run(go())


def test_upgrade_needs_migration_and_agents():
    async def go():
        app = build_router_app(poll=False)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            assert (await client.post("/fleet/upgrade")).status == 409
            r = await client.post("/fleet/upgrade", params={"action": "zap"})
            assert r.status == 400
            # cancel with no sweep running is a cheap no-op status read
            r = await client.post("/fleet/upgrade",
                                  params={"action": "cancel"})
            assert r.status == 200 and (await r.json())["active"] is False
        finally:
            await client.close()

    run(go())


# ---------------------------------------------------------------------------
# agent restart-in-place surface
# ---------------------------------------------------------------------------

def test_handoff_file_round_trip(tmp_path):
    path = str(tmp_path / "handoff.json")
    lifecycle.write_handoff(path, [{"session": "s1", "snapshot": {}}],
                            {"worker_id": "a"})
    data = lifecycle.read_handoff(path)
    assert data["worker_id"] == "a" and len(data["sessions"]) == 1
    lifecycle.consume_handoff(path)
    assert not os.path.exists(path)
    assert lifecycle.read_handoff(path) is None  # gone
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        f.write("{\"schema\": 99}")
    assert lifecycle.read_handoff(bad) is None  # foreign schema
    with open(bad, "w") as f:
        f.write("not json")
    assert lifecycle.read_handoff(bad) is None


def test_admin_recycle_exports_and_spawns(monkeypatch, tmp_path):
    build_app = _imp('server.agent', 'build_app')
    LoopbackProvider = _imp('server.signaling', 'LoopbackProvider')
    make_loopback_offer = _imp('server.signaling', 'make_loopback_offer')

    handoff = str(tmp_path / "handoff.json")
    monkeypatch.setenv("RECYCLE_HANDOFF", handoff)
    monkeypatch.setenv("RECYCLE_EXIT_DELAY_S", "0.01")
    spawned = []
    exited = []
    monkeypatch.setattr(
        lifecycle, "spawn_replacement",
        lambda p: spawned.append(p) or True,
    )
    monkeypatch.setattr(
        lifecycle, "exit_process", lambda code=0: exited.append(code)
    )

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
            r = await client.post("/offer", json={
                "room_id": "r1",
                "offer": {"sdp": make_loopback_offer(), "type": "offer"},
            })
            assert r.status == 200
            r = await client.post("/admin/recycle", json={"respawn": True})
            assert r.status == 202
            body = await r.json()
            assert body["sessions"] == 1 and body["handoff"] == handoff
            # double-recycle refused while the first is in flight
            assert (await client.post("/admin/recycle")).status == 409
            deadline = asyncio.get_event_loop().time() + 3.0
            while not exited:
                assert asyncio.get_event_loop().time() < deadline
                await asyncio.sleep(0.02)
            assert spawned == [handoff] and exited == [0]
            data = lifecycle.read_handoff(handoff)
            assert len(data["sessions"]) == 1
            entry = data["sessions"][0]
            assert entry["room_id"] == "r1" and entry["snapshot"]["session"]
        finally:
            await client.close()

    run(go())


def test_admin_recycle_gates(monkeypatch):
    build_app = _imp('server.agent', 'build_app')
    LoopbackProvider = _imp('server.signaling', 'LoopbackProvider')

    monkeypatch.setenv("RECYCLE_ENABLE", "0")

    async def go():
        app = build_app(pipeline=object(), provider=LoopbackProvider())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            assert (await client.post("/admin/recycle")).status == 404
        finally:
            await client.close()

    run(go())


def test_replacement_imports_handoff_and_announces(monkeypatch, tmp_path):
    build_app = _imp('server.agent', 'build_app')
    LoopbackProvider = _imp('server.signaling', 'LoopbackProvider')

    handoff = str(tmp_path / "handoff.json")
    lifecycle.write_handoff(
        handoff,
        [{
            "session": "old-sid", "room_id": "r1",
            "snapshot": {"schema": 1, "kind": "control-plane",
                         "session": "old-sid"},
            "journey": {"journey_id": "j1", "leg": 2},
        }],
        {"worker_id": "a", "webhook": {"url": None, "token": None}},
    )
    monkeypatch.setenv("RECYCLE_HANDOFF", handoff)
    announced = []

    StreamEventHandler = _imp('server.events', 'StreamEventHandler')

    def record(self, stream_id, room_id, state, reason,
               flight_snapshot_id=None, recent_events=None, journey=None):
        announced.append((stream_id, room_id, state, journey))

    monkeypatch.setattr(StreamEventHandler, "handle_session_state", record)

    async def go():
        app = build_app(pipeline=object(), provider=LoopbackProvider())
        client = TestClient(TestServer(app))
        await client.start_server()  # on_startup runs the import
        try:
            assert not os.path.exists(handoff)  # consumed whatever happens
            parked = app.get("imported_sessions", {})
            assert "rcy-old-sid" in parked
            assert announced == [
                ("old-sid", "r1", "AGENT_RECYCLED",
                 {"journey_id": "j1", "leg": 2}),
            ]
            m = await (await client.get("/metrics")).json()
            assert m["recycle_imports_total"] == 1
        finally:
            await client.close()

    run(go())


def test_exec_hook_spawn_backends(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(lifecycle.subprocess, "Popen",
                        lambda *a, **k: calls.append((a, k)) or
                        type("P", (), {"pid": 123})())
    assert lifecycle.run_exec_hook(None) is False  # no hook: explicit no
    assert lifecycle.run_exec_hook("spawn-agent --here",
                                   {"RECYCLE_HANDOFF": "/x"}) is True
    (args, kw) = calls[-1]
    assert args[0] == "spawn-agent --here" and kw["shell"] is True
    assert kw["env"]["RECYCLE_HANDOFF"] == "/x"
    # spawn_replacement prefers the hook; falls back to argv re-exec
    monkeypatch.setenv("RECYCLE_EXEC_HOOK", "spawn-agent")
    assert lifecycle.spawn_replacement("/h") is True
    assert calls[-1][1]["env"]["RECYCLE_HANDOFF"] == "/h"
    monkeypatch.delenv("RECYCLE_EXEC_HOOK")
    assert lifecycle.spawn_replacement("/h2") is True
    assert calls[-1][1]["env"]["RECYCLE_HANDOFF"] == "/h2"
    assert isinstance(calls[-1][0][0], list)  # argv re-exec form


def test_reexec_argv_reconstructs_module_launch(monkeypatch):
    """``python -m pkg.mod`` sets sys.argv[0] to the module's FILE path;
    re-running that file as a script breaks the package's relative
    imports, so the re-exec argv must restore the ``-m`` form (and strip
    the ``.__main__`` suffix a bare ``-m pkg`` launch carries).  Plain
    script launches (no __main__ spec) re-exec their argv verbatim."""
    import sys
    import types

    monkeypatch.setattr(sys, "argv",
                        ["/repo/pkg/server/agent.py", "--port", "8899"])
    fake_main = types.ModuleType("__main__")
    fake_main.__spec__ = types.SimpleNamespace(name="pkg.server.agent")
    monkeypatch.setitem(sys.modules, "__main__", fake_main)
    assert lifecycle.reexec_argv() == [
        sys.executable, "-m", "pkg.server.agent", "--port", "8899"]

    fake_main.__spec__ = types.SimpleNamespace(name="pkg.__main__")
    assert lifecycle.reexec_argv()[1:3] == ["-m", "pkg"]

    fake_main.__spec__ = None  # plain `python script.py` launch
    assert lifecycle.reexec_argv() == [
        sys.executable, "/repo/pkg/server/agent.py", "--port", "8899"]
