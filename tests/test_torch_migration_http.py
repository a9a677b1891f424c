"""Live migration over HTTP on the port against the JAX package, scenario for
scenario.

Every scenario of tests/test_migration.py's HTTP section (two real agent
apps and the real router in one process, fake schedulers speaking the
migration surface) runs on ``ai_rtc_agent_tpu`` and on
``ai_rtc_agent_tpu_torch`` with the same assertions: drain with
``mode=migrate`` (export, counted-reservation import, StreamMigrated, the
pinned re-offer adopted as journey leg 2), abort safety and the terminal
4xx, crash restore from the banked export, the sweep's timeout, its
idempotence and cancel, a failed import releasing its reservation, a
session that ended mid-sweep, concurrent imports of one token, a stale
pin, the journey requirement and the kill switches."""

import importlib

import asyncio
import time

import numpy as np
import pytest
from _torch_threads import few_torch_threads  # noqa: F401,E402  (autouse)

ROOTS = {"jax": "ai_rtc_agent_tpu", "torch": "ai_rtc_agent_tpu_torch"}
_ROOT = ["ai_rtc_agent_tpu"]
# module-level names bound to the package under test: (module, name)
_NAMES = {'SESSION_SNAPSHOT_SCHEMA': ('stream.scheduler', 'SESSION_SNAPSHOT_SCHEMA'), 'CapacityError': ('stream.scheduler', 'CapacityError'), 'SnapshotMismatch': ('stream.scheduler', 'SnapshotMismatch')}


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


@pytest.fixture(autouse=True)
def admission_out_of_reach(monkeypatch):
    """Both agents' admission budgets beyond what a loaded test box can
    trip (as in tests/test_torch_migration_agents.py): under the suite's
    parallel workers the router's re-offer met a loop-lag EWMA over its
    200 ms budget and a 503 "fleet saturated".  These tests are about the
    move, not admission."""
    monkeypatch.setenv("OVERLOAD_LOOP_LAG_BUDGET_MS", "100000")
    monkeypatch.setenv("OVERLOAD_STEP_BUDGET_MS", "100000")




# ---------------------------------------------------------------------------
# 3. HTTP orchestration: two real agent apps + the real router
# ---------------------------------------------------------------------------

class _MigSession:
    """Duck-typed scheduler session whose identity is a state counter —
    adoption continuity is assertable without a model."""

    owns_step_signal = True

    def __init__(self, owner, slot, key, counter=0):
        DeadlineQueue = _imp('resilience.overload', 'DeadlineQueue')

        self._owner = owner
        self.slot = slot
        self.session_key = key
        self.counter = counter
        self.prompt = "p"
        self.window_queue = DeadlineQueue(2)

    def __call__(self, frame):
        self.counter += 1
        arr = frame if isinstance(frame, np.ndarray) else frame.to_ndarray()
        return 255 - arr

    def update_prompt(self, p):
        self.prompt = p

    def update_t_index_list(self, t):
        pass

    def release(self):
        self._owner.released.append(self.session_key)


class _MigScheduler:
    """Fake batch scheduler speaking the migration surface: snapshot
    carries the session counter, restore recreates it (or refuses —
    ``refuse_restores`` models a mismatched target; ``explode_restores``
    models an unexpected runtime failure inside the install)."""

    def __init__(self, max_sessions=2, refuse_restores=False,
                 restore_delay_s=0.0, explode_restores=False):
        self.max_sessions = max_sessions
        self.sessions = {}
        self.released = []
        self.restores = 0
        self.refuse_restores = refuse_restores
        self.restore_delay_s = restore_delay_s
        self.explode_restores = explode_restores
        self.on_step = None

    @property
    def free_slots(self):
        return self.max_sessions - len(
            [s for s in self.sessions.values()
             if s.session_key not in self.released]
        )

    def claim(self, session_key=None, prompt=None, seed=None):
        if self.free_slots <= 0:
            raise CapacityError("full")
        sess = _MigSession(self, len(self.sessions), session_key)
        self.sessions[session_key] = sess
        return sess

    def session(self, key):
        # scan by the session_key ATTRIBUTE (the real scheduler's
        # semantics): adoption renames a restored session to the freshly
        # minted stream id
        for s in self.sessions.values():
            if s.session_key == key and key not in self.released:
                return s
        return None

    def snapshot_session(self, key):
        sess = self.sessions.get(key)
        if sess is None:
            raise KeyError(key)
        return {
            "schema": SESSION_SNAPSHOT_SCHEMA,
            "kind": "scheduler",
            "counter": sess.counter,
            "prompt": sess.prompt,
        }

    def restore_session(self, snap, key=None):
        self.restores += 1
        if self.restore_delay_s:
            time.sleep(self.restore_delay_s)
        if self.explode_restores:
            raise RuntimeError("injected install failure")
        if self.refuse_restores or snap.get("schema") != (
            SESSION_SNAPSHOT_SCHEMA
        ):
            raise SnapshotMismatch("refused by test target")
        if self.free_slots <= 0:
            raise CapacityError("full")
        sess = _MigSession(
            self, len(self.sessions), key, counter=int(snap["counter"])
        )
        sess.prompt = snap.get("prompt", "p")
        self.sessions[key] = sess
        return sess

    def update_prompt(self, p):
        pass

    def update_t_index_list(self, t):
        pass

    def snapshot(self):
        return {"batchsched_sessions": self.max_sessions - self.free_slots,
                "batchsched_max_sessions": self.max_sessions}

    def session_snapshots(self):
        return {
            s.session_key: {"slot": s.slot}
            for s in self.sessions.values()
            if s.session_key not in self.released
        }

    def close(self):
        pass


async def _spawn_agent(sched):
    from aiohttp.test_utils import TestClient, TestServer

    build_app = _imp('server.agent', 'build_app')
    LoopbackProvider = _imp('server.signaling', 'LoopbackProvider')

    class _Stub:
        def __call__(self, frame):
            return frame

    app = build_app(
        pipeline=_Stub(), provider=LoopbackProvider(), batch_scheduler=sched
    )
    client = TestClient(TestServer(app))
    await client.start_server()
    return app, client


def _offer_body():
    make_loopback_offer = _imp('server.signaling', 'make_loopback_offer')

    return {
        "room_id": "mig-room",
        "offer": {"sdp": make_loopback_offer(), "type": "offer"},
    }


async def _fleet_harness(scheds):
    """Real router + one real agent app per fake scheduler, registered
    and polled once.  -> (router_client, router_app, agents, posted)."""
    from aiohttp.test_utils import TestClient, TestServer

    FleetRegistry = _imp('fleet.registry', 'FleetRegistry')
    build_router_app = _imp('fleet.router', 'build_router_app')
    StreamEventHandler = _imp('server.events', 'StreamEventHandler')

    posted = []

    class _Resp:
        status = 200

    class _CaptureSession:
        async def post(self, url, headers=None, json=None):
            posted.append(json)
            return _Resp()

    events = StreamEventHandler(
        session_factory=_CaptureSession,
        webhook_url="http://client-notify.example/hook", token="t",
    )
    reg = FleetRegistry(dead_after=2)
    router_app = build_router_app(
        registry=reg, events_handler=events, poll=True
    )
    router = TestClient(TestServer(router_app))
    await router.start_server()
    agents = []
    for i, sched in enumerate(scheds):
        app, client = await _spawn_agent(sched)
        agents.append((app, client))
        r = await router.post("/fleet/register", json={
            "worker_id": f"m-agent{i}", "public_ip": "127.0.0.1",
            "public_port": str(client.server.port), "status": "ready",
            "capacity": sched.max_sessions,
        })
        assert r.status == 200
    await router_app["poller"].poll_once()
    return router, router_app, agents, posted


async def _wait_for(predicate, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while True:
        r = predicate()
        if r:
            return r
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        await asyncio.sleep(0.05)


def test_http_migrate_drain_moves_session_and_repins_reoffer():
    """The full wire story: drain?mode=migrate exports off the source,
    imports on the target under a counted reservation, fires
    StreamMigrated, and the client's echoed re-offer is PINNED to the
    target where the imported session is ADOPTED as journey leg 2 with
    its state counter intact (mid-stream resume, not a fresh claim)."""
    src_sched = _MigScheduler()
    dst_sched = _MigScheduler()

    async def go():
        router, router_app, agents, posted = await _fleet_harness(
            [src_sched, dst_sched]
        )
        try:
            r = await router.post("/offer", json=_offer_body())
            assert r.status == 200, await r.text()
            sid = r.headers["X-Stream-Id"]
            jid = r.headers["X-Journey-Id"]
            assert router_app["session_table"].owner(sid) == "m-agent0"
            # stream a little: the counter IS the mid-stream state
            sess = src_sched.session(sid)
            for _ in range(5):
                sess(np.zeros((4, 4, 3), np.uint8))
            assert sess.counter == 5

            r = await router.post(
                "/fleet/drain?agent=m-agent0&mode=migrate"
            )
            body = await r.json()
            assert body["draining"] and body["mode"] == "migrate"
            assert body["migrating"] == 1

            migrated = await _wait_for(
                lambda: [e for e in posted
                         if e.get("event") == "StreamMigrated"],
                10, "StreamMigrated webhook",
            )
            ev = migrated[0]
            assert ev["stream_id"] == sid
            assert ev["journey_id"] == jid
            assert ev["source_agent"] == "m-agent0"
            assert ev["target_agent"] == "m-agent1"
            assert ev["reason"] == "drain"
            assert dst_sched.restores == 1
            # the source kept serving the whole time
            assert src_sched.released == []

            # the client re-offers echoing its journey id -> pinned to
            # the target, adopted, leg 2
            r = await router.post(
                "/offer", json=_offer_body(),
                headers={"X-Journey-Id": jid},
            )
            assert r.status == 200, await r.text()
            assert r.headers["X-Journey-Id"] == jid
            assert r.headers["X-Journey-Leg"] == "2"
            new_sid = r.headers["X-Stream-Id"]
            assert router_app["session_table"].owner(new_sid) == "m-agent1"
            adopted = dst_sched.session(new_sid)
            assert adopted is not None
            assert adopted.counter == 5  # mid-stream state, not a fresh claim
            # adoption consumed the parked import (no double-adopt)
            dst_app = agents[1][0]
            assert dst_app["imported_sessions"] == {}
            # one journey, both legs; the ring tells the move story
            record = router_app["journeys"].get(jid)
            kinds = [e["kind"] for e in record["events"]]
            assert "migrated" in kinds
            assert [leg["agent"] for leg in record["legs"]] == [
                "m-agent0", "m-agent1",
            ]
            m = await (await router.get("/metrics")).json()
            assert m["migrations_total"] == 1
            assert m.get("migrations_failed_total", 0) == 0
            assert m["migration_ms_p50"] > 0
            # a moved session's banked export is dropped — the source
            # dying later must not crash-restore a SECOND copy
            assert m["migration_snapshots_banked"] == 0
            # prom rendering stays label-free and conformant
            r = await router.get("/metrics", params={"format": "prom"})
            text = await r.text()
            assert "# TYPE migrations_total counter" in text
            assert "migration_ms_p50" in text
        finally:
            for _app, client in agents:
                await client.close()
            await router.close()

    asyncio.run(go())


def test_http_migrate_abort_safety_and_retry_4xx_terminal():
    """A target that REFUSES the restore (schema-mismatch 409) gets
    exactly ONE import attempt (the retry-4xx rule) and the source keeps
    serving — the drain degrades to kill semantics with a
    ``migrate_failed`` ring entry and captured evidence."""
    src_sched = _MigScheduler()
    dst_sched = _MigScheduler(refuse_restores=True)

    async def go():
        router, router_app, agents, posted = await _fleet_harness(
            [src_sched, dst_sched]
        )
        try:
            r = await router.post("/offer", json=_offer_body())
            assert r.status == 200
            sid = r.headers["X-Stream-Id"]
            jid = r.headers["X-Journey-Id"]
            r = await router.post(
                "/fleet/drain?agent=m-agent0&mode=migrate"
            )
            assert (await r.json())["migrating"] == 1

            def failed():
                rec = router_app["journeys"].get(jid)
                return [e for e in rec["events"]
                        if e["kind"] == "migrate_failed"]

            await _wait_for(failed, 10, "migrate_failed ring entry")
            assert dst_sched.restores == 1  # 409 was TERMINAL: one attempt
            assert src_sched.released == []  # source serving untouched
            assert not [e for e in posted
                        if e.get("event") == "StreamMigrated"]
            m = await (await router.get("/metrics")).json()
            assert m["migrations_failed_total"] == 1
            assert m.get("migrations_total", 0) == 0
            # the banked export still serves the crash path
            assert m["migration_snapshots_banked"] == 1
            # kill-drain semantics continue: agent frozen, recyclable
            # once the client eventually leaves
            rec = router_app["fleet"].agents["m-agent0"]
            assert rec.draining
        finally:
            for _app, client in agents:
                await client.close()
            await router.close()

    asyncio.run(go())


def test_http_crash_restore_reuses_banked_snapshot():
    """AGENT_DEAD with a recent snapshot banked (an interrupted
    drain-as-move exported it before the source died): the crash path
    reuses the restore surface — import on a survivor + StreamMigrated
    (reason=agent_dead) instead of the plain AGENT_DEAD re-point — and
    the client resumes mid-stream."""
    src_sched = _MigScheduler()
    dst_sched = _MigScheduler(refuse_restores=True)

    async def go():
        router, router_app, agents, posted = await _fleet_harness(
            [src_sched, dst_sched]
        )
        try:
            r = await router.post("/offer", json=_offer_body())
            assert r.status == 200
            sid = r.headers["X-Stream-Id"]
            jid = r.headers["X-Journey-Id"]
            sess = src_sched.session(sid)
            for _ in range(7):
                sess(np.zeros((4, 4, 3), np.uint8))
            # a migrate-drain whose import FAILS still banks the export
            await router.post("/fleet/drain?agent=m-agent0&mode=migrate")
            await _wait_for(
                lambda: router_app["snapshot_bank"].get(sid), 10,
                "banked snapshot",
            )
            assert not [e for e in posted
                        if e.get("event") == "StreamMigrated"]

            # the target recovers; then the SOURCE dies (SIGKILL shape:
            # consecutive poll failures) -> crash restore from the bank
            dst_sched.refuse_restores = False
            reg = router_app["fleet"]
            rec = reg.agents["m-agent0"]
            reg.note_poll_fail(rec)
            reg.note_poll_fail(rec)
            assert rec.state == "DEAD"

            migrated = await _wait_for(
                lambda: [e for e in posted
                         if e.get("event") == "StreamMigrated"],
                10, "crash-restore StreamMigrated",
            )
            ev = migrated[0]
            assert ev["reason"] == "agent_dead"
            assert ev["target_agent"] == "m-agent1"
            assert ev["journey_id"] == jid
            # no plain AGENT_DEAD re-point for this stream — the restore
            # superseded it
            assert not [e for e in posted
                        if e.get("state") == "AGENT_DEAD"]
            # the echoed re-offer adopts the restored mid-stream state
            r = await router.post(
                "/offer", json=_offer_body(),
                headers={"X-Journey-Id": jid},
            )
            assert r.status == 200
            new_sid = r.headers["X-Stream-Id"]
            assert router_app["session_table"].owner(new_sid) == "m-agent1"
            adopted = dst_sched.session(new_sid)
            assert adopted is not None and adopted.counter == 7
            m = await (await router.get("/metrics")).json()
            assert m["migrations_total"] == 1
        finally:
            for _app, client in agents:
                await client.close()
            await router.close()

    asyncio.run(go())


def test_http_migrate_timeout_falls_back_to_kill_drain():
    """A hung target trips MIGRATE_TIMEOUT_S: the sweep is abandoned
    (migration_fallbacks_total), the source keeps serving, and the drain
    keeps its ordinary kill semantics."""
    src_sched = _MigScheduler()
    dst_sched = _MigScheduler(restore_delay_s=1.5)

    async def go():
        router, router_app, agents, posted = await _fleet_harness(
            [src_sched, dst_sched]
        )
        router_app["migrate_timeout_s"] = 0.2
        try:
            r = await router.post("/offer", json=_offer_body())
            assert r.status == 200
            r = await router.post(
                "/fleet/drain?agent=m-agent0&mode=migrate"
            )
            assert (await r.json())["migrating"] == 1

            await _wait_for(
                lambda: not router_app["migrate_tasks"], 10,
                "migrate sweep to finish",
            )
            m = await (await router.get("/metrics")).json()
            assert m["migration_fallbacks_total"] == 1
            assert m.get("migrations_total", 0) == 0
            assert src_sched.released == []
            assert router_app["fleet"].agents["m-agent0"].draining
        finally:
            for _app, client in agents:
                await client.close()
            await router.close()

    asyncio.run(go())


def test_http_migrate_drain_idempotent_and_cancel_stops_new_moves():
    """Code-review regressions: (a) re-asserting an already-draining
    migrate drain must NOT spawn a second sweep over the same sessions;
    (b) action=cancel stops NEW moves mid-sweep (in-flight ones finish)."""
    # the SOURCE advertises the most capacity so both offers land on it
    src_sched = _MigScheduler(max_sessions=4)
    dst_sched = _MigScheduler(max_sessions=2, restore_delay_s=0.3)

    async def go():
        router, router_app, agents, posted = await _fleet_harness(
            [src_sched, dst_sched]
        )
        router_app["migrate_max_parallel"] = 1
        try:
            for _ in range(2):
                r = await router.post("/offer", json=_offer_body())
                assert r.status == 200
            r = await router.post("/fleet/drain?agent=m-agent0&mode=migrate")
            assert (await r.json())["migrating"] == 2
            # an operator retry of the same drain: no second sweep
            r = await router.post("/fleet/drain?agent=m-agent0&mode=migrate")
            assert (await r.json())["migrating"] == 0
            # cancel while the FIRST move's import is still sleeping:
            # the superseded sweep's QUEUED session must never leave
            await router.post(
                "/fleet/drain?agent=m-agent0&action=cancel"
            )
            stale_restores = dst_sched.restores
            # ...and an IMMEDIATE restart must start a FRESH sweep (the
            # superseded sweep finishing its in-flight move does not
            # block it — cancel-then-restart migrates, it does not
            # silently degrade to kill semantics)
            r = await router.post(
                "/fleet/drain?agent=m-agent0&mode=migrate"
            )
            assert (await r.json())["migrating"] >= 1
            await _wait_for(
                lambda: not router_app["migrate_tasks"], 10,
                "sweeps to finish",
            )
            assert dst_sched.restores > stale_restores  # fresh sweep ran
            # a retry of the RUNNING fresh sweep still no-ops
            r = await router.post(
                "/fleet/drain?agent=m-agent0&mode=migrate"
            )
            # (sweep just finished, so this may re-sweep leftovers —
            # both outcomes are valid; the invariant is no CONCURRENT
            # duplicate, pinned by the stale_restores check above)
            await _wait_for(
                lambda: not router_app["migrate_tasks"], 10,
                "trailing sweep to finish",
            )
        finally:
            for _app, client in agents:
                await client.close()
            await router.close()

    asyncio.run(go())


def test_http_import_releases_reservation_on_unexpected_failure():
    """An install blowing up with an unexpected error (not a refusal,
    not capacity) answers 500 — and must NOT strand the counted
    admission reservation for its TTL (the router retries 5xx; a
    phantom reservation per episode would 503 real offers)."""
    sched = _MigScheduler(explode_restores=True)

    async def go():
        app, client = await _spawn_agent(sched)
        try:
            cap0 = (await (await client.get("/capacity")).json())["capacity"]
            r = await client.post("/migrate/import", json={
                "token": "boom",
                "snapshot": {
                    "kind": "scheduler",
                    "schema": SESSION_SNAPSHOT_SCHEMA,
                    "counter": 1,
                },
            })
            assert r.status == 500
            cap1 = (await (await client.get("/capacity")).json())["capacity"]
            assert cap1 == cap0  # reservation released, not stranded
        finally:
            await client.close()

    asyncio.run(go())


def test_http_ended_session_mid_sweep_is_not_a_failed_migration():
    """A client hanging up while its session waits in the sweep queue is
    a SUCCESSFUL drain outcome: no migrations_failed count, no
    migrate_failed ring entry, no evidence pull."""
    # the SOURCE advertises the most capacity so both offers land on it
    src_sched = _MigScheduler(max_sessions=4)
    dst_sched = _MigScheduler(max_sessions=2, restore_delay_s=0.3)

    async def go():
        router, router_app, agents, posted = await _fleet_harness(
            [src_sched, dst_sched]
        )
        router_app["migrate_max_parallel"] = 1
        src_app = agents[0][0]
        try:
            sids = []
            for _ in range(2):
                r = await router.post("/offer", json=_offer_body())
                assert r.status == 200
                sids.append(r.headers["X-Stream-Id"])
            r = await router.post("/fleet/drain?agent=m-agent0&mode=migrate")
            assert (await r.json())["migrating"] == 2
            # while the first move's import sleeps, the SECOND session
            # ends naturally: StreamEnded prunes the table and the agent
            # stops exporting it
            router_app["session_table"].forget(sids[1])
            src_app["supervisors"].pop(sids[1], None)
            src_sched.released.append(sids[1])
            await _wait_for(
                lambda: not router_app["migrate_tasks"], 10,
                "sweep to finish",
            )
            m = await (await router.get("/metrics")).json()
            assert m.get("migrations_failed_total", 0) == 0
            assert m["migrations_total"] == 1  # the live one moved
        finally:
            for _app, client in agents:
                await client.close()
            await router.close()

    asyncio.run(go())


def test_http_concurrent_import_same_token_restores_once():
    """A retry racing a FIRST import still inside its restore must not
    land a second slot: one request restores, the other answers 503 (or
    the idempotent parked result) — never two restores."""
    sched = _MigScheduler(restore_delay_s=0.3)

    async def go():
        app, client = await _spawn_agent(sched)
        try:
            body = {
                "token": "race",
                "snapshot": {
                    "kind": "scheduler",
                    "schema": SESSION_SNAPSHOT_SCHEMA,
                    "counter": 1,
                },
            }
            r1, r2 = await asyncio.gather(
                client.post("/migrate/import", json=body),
                client.post("/migrate/import", json=body),
            )
            statuses = sorted([r1.status, r2.status])
            assert statuses in ([200, 200], [200, 503]), statuses
            assert sched.restores == 1
            assert len(app["imported_sessions"]) == 1
        finally:
            await client.close()

    asyncio.run(go())


def test_http_stale_pin_is_ignored():
    """A migration pin older than the target's import TTL is dead (the
    parked session expired): the re-offer must fall back to ordinary
    placement instead of chasing the old target with a dead token."""
    src_sched = _MigScheduler()
    dst_sched = _MigScheduler()

    async def go():
        router, router_app, agents, posted = await _fleet_harness(
            [src_sched, dst_sched]
        )
        try:
            r = await router.post("/offer", json=_offer_body())
            assert r.status == 200
            jid = r.headers["X-Journey-Id"]
            await router.post("/fleet/drain?agent=m-agent0&mode=migrate")
            await _wait_for(
                lambda: jid in router_app["migrations"], 10, "pin"
            )
            router_app["migrations"][jid]["ts"] -= 60.0  # age past TTL
            r = await router.post(
                "/offer", json=_offer_body(),
                headers={"X-Journey-Id": jid},
            )
            assert r.status == 200
            new_sid = r.headers["X-Stream-Id"]
            # not adopted: wherever it landed, it is a FRESH claim (the
            # restored counter never surfaces) and the stale pin is gone
            adopted = dst_sched.session(new_sid)
            assert adopted is None or adopted.counter == 0
            assert jid not in router_app["migrations"]
        finally:
            for _app, client in agents:
                await client.close()
            await router.close()

    asyncio.run(go())


def test_http_migrate_requires_journey_plane():
    """mode=migrate without the journey plane would silently degrade
    every move to a fresh re-prime (the re-offer pin is keyed by journey
    id) — the router refuses with 409 instead."""
    import os

    sched = _MigScheduler()

    async def go():
        router, router_app, agents, posted = await _fleet_harness([sched])
        try:
            assert router_app["journeys"] is None
            r = await router.post("/fleet/drain?agent=m-agent0&mode=migrate")
            assert r.status == 409
            assert "journey" in (await r.text())
            # plain kill-drain still works
            r = await router.post("/fleet/drain?agent=m-agent0")
            assert r.status == 200
        finally:
            for _app, client in agents:
                await client.close()
            await router.close()

    os.environ["JOURNEY_ENABLE"] = "0"
    try:
        asyncio.run(go())
    finally:
        os.environ.pop("JOURNEY_ENABLE", None)


def test_http_migrate_kill_switch_and_agent_surface():
    """MIGRATE_ENABLE=0 removes the surface end to end: the agent's
    export/import endpoints 404 and the router refuses mode=migrate with
    409 (drain itself still works).  With it on, the agent endpoints
    enforce the reservation-first + schema-refusal contract directly."""
    sched = _MigScheduler()

    async def go_disabled():
        app, client = await _spawn_agent(sched)
        try:
            r = await client.get("/migrate/export?session=x")
            assert r.status == 404
            r = await client.post("/migrate/import", json={})
            assert r.status == 404
        finally:
            await client.close()

    async def go_enabled():
        app, client = await _spawn_agent(sched)
        try:
            # unknown session -> 404; missing selector -> 400
            r = await client.get("/migrate/export")
            assert r.status == 400
            r = await client.get("/migrate/export?session=nobody")
            assert r.status == 404
            # import: schema mismatch -> 409 AND the reservation it took
            # is released (capacity unchanged)
            cap0 = (await (await client.get("/capacity")).json())["capacity"]
            r = await client.post("/migrate/import", json={
                "token": "t1",
                "snapshot": {"kind": "scheduler", "schema": 999},
            })
            assert r.status == 409
            cap1 = (await (await client.get("/capacity")).json())["capacity"]
            assert cap0 == cap1
            # a good import parks the session AND holds a reservation
            r = await client.post("/migrate/import", json={
                "token": "t2",
                "snapshot": {
                    "kind": "scheduler",
                    "schema": SESSION_SNAPSHOT_SCHEMA,
                    "counter": 3,
                },
            })
            assert r.status == 200
            body = await r.json()
            assert body["restored"] is True
            assert "t2" in app["imported_sessions"]
            cap2 = (await (await client.get("/capacity")).json())["capacity"]
            assert cap2 == cap1 - 1  # reservation counted, not double-sold
            # a RETRIED import under the same token (lost response) is
            # idempotent: no second restore, no second slot, the parked
            # session stays reachable
            restores_before = sched.restores
            r = await client.post("/migrate/import", json={
                "token": "t2",
                "snapshot": {
                    "kind": "scheduler",
                    "schema": SESSION_SNAPSHOT_SCHEMA,
                    "counter": 3,
                },
            })
            assert r.status == 200
            assert (await r.json())["restored"] is True
            assert sched.restores == restores_before
            cap3 = (await (await client.get("/capacity")).json())["capacity"]
            assert cap3 == cap2
            # unknown kind -> 400
            r = await client.post("/migrate/import", json={
                "token": "t3", "snapshot": {"kind": "??", "schema": 1},
            })
            assert r.status == 400
        finally:
            await client.close()

    import os

    os.environ["MIGRATE_ENABLE"] = "0"
    try:
        asyncio.run(go_disabled())
    finally:
        os.environ.pop("MIGRATE_ENABLE", None)
    asyncio.run(go_enabled())
