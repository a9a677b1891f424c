"""Live migration between agents with real tiny schedulers, on the CPU.

The HTTP transcripts of tests/test_torch_migration_http.py run on fake
schedulers; here the agents serve real ones (tiny-test, the 2-stage turbo
ring at 32x32, whose latent ring carries state from frame to frame) behind
the port's router (fleet/router.py over aiohttp):

* port agent -> port agent: ``/fleet/drain?mode=migrate`` exports the
  session, the target imports it, the pinned re-offer adopts it as journey
  leg 2, and every frame after the move equals an unmigrated control's bit
  for bit;
* JAX agent -> port agent through the same router: the JAX scheduler's
  snapshot lands in the port's scheduler and the frames after the move stay
  within 1 uint8 level of the JAX control's.
"""

import asyncio
import time

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.server import agent as JA
from ai_rtc_agent_tpu.server.signaling import LoopbackProvider as JLoopbackProvider
from ai_rtc_agent_tpu.stream.scheduler import BatchScheduler as JBatchScheduler
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.fleet.registry import FleetRegistry
from ai_rtc_agent_tpu_torch.fleet.router import build_router_app
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.server import agent as PA
from ai_rtc_agent_tpu_torch.server.events import StreamEventHandler
from ai_rtc_agent_tpu_torch.server.signaling import LoopbackProvider, make_loopback_offer
from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

RING = dict(t_index_list=(0, 1), num_inference_steps=2, timestep_spacing="trailing",
            scheduler="turbo", cfg_type="none", height=32, width=32)


class _Stub:
    def __call__(self, frame):
        return frame


class _Capture:
    status = 200

    def __init__(self):
        self.posted = []

    def __call__(self):
        return self

    async def post(self, url, headers=None, json=None):
        self.posted.append(json)
        return self


@pytest.fixture(autouse=True)
def admission_out_of_reach(monkeypatch):
    """Both agents' admission budgets beyond what a loaded test box can
    trip: under the suite's parallel workers the JAX agent's loop-lag EWMA
    crossed its 200 ms budget and refused the router's first /offer (503
    "fleet saturated").  These tests are about the move, not admission."""
    monkeypatch.setenv("OVERLOAD_LOOP_LAG_BUDGET_MS", "100000")
    monkeypatch.setenv("OVERLOAD_STEP_BUDGET_MS", "100000")


@pytest.fixture(scope="module")
def bundles():
    jb = JREG.load_model_bundle("tiny-test")
    pb = PREG.load_model_bundle("tiny-test", device="cpu",
                                params=bridge.params_from_jax(jax.tree.map(np.asarray, jb.params)))
    return jb, pb


def _port_sched(pb):
    return BatchScheduler(pb.stream_models, pb.params, PREG.default_stream_config(
        "tiny-test", device="cpu", **RING), pb.encode_prompt, max_sessions=2, window_ms=10_000.0,
        device="cpu", model_id="tiny-test")


def _jax_sched(jb):
    """No coalescing window: the agent's session and the control beside it
    each step alone, through the one compiled bucket of 1."""
    return JBatchScheduler(jb.stream_models, jb.params, JREG.default_stream_config(
        "tiny-test", **RING), jb.encode_prompt, max_sessions=2, window_ms=0.0,
        prewarm=False, dp=1, model_id="tiny-test")


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (32, 32, 3), np.uint8) for _ in range(n)]


def _tick(sess, frame):
    return np.asarray(sess.fetch(sess.submit(frame)))


async def _levels(a, b, frames) -> list:
    """Step sessions ``a`` and ``b`` through ``frames`` off the loop (a
    blocked loop reads as loop lag to the agents' overload planes)."""
    def run():
        return [int(np.abs(_tick(a, f).astype(int) - _tick(b, f)).max()) for f in frames]

    return await asyncio.to_thread(run)


async def _wait_for(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        await asyncio.sleep(0.05)
    return pred()


async def _migrate(apps, scheds, make_control, frames, tolerance):
    """Place a session on agent 0 through the router, step it, drain agent 0
    with mode=migrate, re-offer, and step the adopted session on agent 1
    beside the control ``make_control()`` claims after the placement (a
    session of the same initial state)."""
    clients = _Capture()
    router_app = build_router_app(registry=FleetRegistry(dead_after=2), events_handler=(
        StreamEventHandler(session_factory=clients, webhook_url="http://clients.invalid/hook",
                           token="t")))
    router = TestClient(TestServer(router_app))
    await router.start_server()
    agents = []
    try:
        for app in apps:
            client = TestClient(TestServer(app))
            await client.start_server()
            agents.append(client)
        body = {"room_id": "moving", "offer": {"sdp": make_loopback_offer(), "type": "offer"}}
        for i, client in enumerate(agents[:1]):
            r = await router.post("/fleet/register", json={
                "worker_id": f"agent{i}", "public_ip": "127.0.0.1",
                "public_port": str(client.server.port), "status": "ready", "capacity": 2})
            assert r.status == 200
        r = await router.post("/offer", json=body)
        assert r.status == 200, await r.text()
        sid, jid = r.headers["X-Stream-Id"], r.headers["X-Journey-Id"]
        r = await router.post("/fleet/register", json={
            "worker_id": "agent1", "public_ip": "127.0.0.1",
            "public_port": str(agents[1].server.port), "status": "ready", "capacity": 2})
        assert r.status == 200
        await router_app["poller"].poll_once()
        src, control = scheds[0].session(sid), make_control()
        assert max(await _levels(src, control, frames[:3])) <= tolerance
        r = await router.post("/fleet/drain?agent=agent0&mode=migrate")
        assert (await r.json())["migrating"] == 1
        ev = await _wait_for(lambda: [e for e in clients.posted
                                      if e["event"] == "StreamMigrated"], 60, "StreamMigrated")
        assert (ev[0]["source_agent"], ev[0]["target_agent"], ev[0]["journey_id"]) == (
            "agent0", "agent1", jid)
        r = await router.post("/offer", json=body, headers={"X-Journey-Id": jid})
        assert r.status == 200, await r.text()
        assert r.headers["X-Journey-Leg"] == "2"
        new = r.headers["X-Stream-Id"]
        assert router_app["session_table"].owner(new) == "agent1"
        assert apps[1]["imported_sessions"] == {}
        moved = scheds[1].session(new)
        assert moved is not None and moved.frames_submitted == 3
        levels = await _levels(moved, control, frames[3:])
        assert max(levels) <= tolerance, levels
        m = await (await router.get("/metrics")).json()
        assert (m["migrations_total"], m.get("migrations_failed_total", 0)) == (1, 0)
    finally:
        for client in agents:
            await client.close()
        await router.close()


def test_drain_migrate_moves_a_real_port_session_between_port_agents(bundles):
    _, pb = bundles
    scheds = [_port_sched(pb) for _ in range(2)]
    control_sched = _port_sched(pb)
    apps = [PA.build_app(pipeline=_Stub(), provider=LoopbackProvider(), batch_scheduler=s)
            for s in scheds]
    try:  # the offer's claim: slot 0, seed 0
        asyncio.run(_migrate(apps, scheds, lambda: control_sched.claim("control", seed=0),
                             _frames(8, 41), tolerance=0))
    finally:
        control_sched.close()


def test_a_session_migrates_from_a_jax_agent_to_a_port_agent(bundles):
    jb, pb = bundles
    jsched, psched = _jax_sched(jb), _port_sched(pb)
    apps = [JA.build_app(pipeline=_Stub(), provider=JLoopbackProvider(), batch_scheduler=jsched),
            PA.build_app(pipeline=_Stub(), provider=LoopbackProvider(), batch_scheduler=psched)]
    # the control: the JAX agent's second slot, claimed after the placement
    # took the first with seed 0
    asyncio.run(_migrate(apps, [jsched, psched], lambda: jsched.claim("control", seed=0),
                         _frames(8, 42), tolerance=1))
