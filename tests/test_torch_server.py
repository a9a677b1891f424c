"""The port's serving seam (ai_rtc_agent_tpu_torch/server/) against the JAX
agent, on the CPU.

* HTTP contract: one request script runs against the JAX ``build_app`` and
  the port's, each with the same fake pipeline (inverted colours) and its
  own loopback provider, and the transcripts must be equal: statuses,
  content types, CORS headers, ``Location`` (session ids masked), answer
  bodies (ids masked), the pipeline's control-plane state and the frames
  the viewers receive.  ``SUPERVISOR=0`` puts the JAX agent on the
  unsupervised tier the port serves.
* The slice as a whole: the tiny-test turbo pipeline served through each
  agent (JAX with its Pallas attention in interpret mode; the port on the
  CPU with the JAX pipeline's weights and prepared state carried across by
  ``bridge``), the same frames pushed into both, the viewed frames at most 1
  uint8 level apart (the rounding-tie class of tests/test_torch_stream.py);
  and the port's viewed frames bit-exact to its own ``__call__`` from the
  same state.
* The pipeline surface the track drives, the track itself, webhooks, TURN,
  env getters and FrameStats against their JAX counterparts, exactly.
* Guards: only ``server/agent.py`` imports aiohttp at module level, nothing
  imports pydantic, the provider choice (``WEBRTC_PROVIDER``, and the
  default without aiortc, the native runtime or ``cryptography``) and its
  warning are the JAX ``get_provider``'s, and the agent refuses to start
  without ``device="cpu"`` on a box with no card.
"""

import ast
import asyncio
import base64
import json
import os
import random
import re
import time
from fractions import Fraction
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.media import frames as JF
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.parallel import checkpoint as JC
from ai_rtc_agent_tpu.resilience import retry as JRETRY
from ai_rtc_agent_tpu.server import agent as JA
from ai_rtc_agent_tpu.server import events as JE
from ai_rtc_agent_tpu.server import relay as JR
from ai_rtc_agent_tpu.server import signaling as JS
from ai_rtc_agent_tpu.server import tracks as JT
from ai_rtc_agent_tpu.server import turn as JTURN
from ai_rtc_agent_tpu.stream.pipeline import StreamDiffusionPipeline as JPipeline
from ai_rtc_agent_tpu.utils import env as JENV
from ai_rtc_agent_tpu.utils import profiling as JPROF
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.media import frames as PF
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.server import agent as PA
from ai_rtc_agent_tpu_torch.server import events as PE
from ai_rtc_agent_tpu_torch.server import relay as PR
from ai_rtc_agent_tpu_torch.server import sessions
from ai_rtc_agent_tpu_torch.server import signaling as PS
from ai_rtc_agent_tpu_torch.server import tracks as PT
from ai_rtc_agent_tpu_torch.server import turn as PTURN
from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline as PPipeline
from ai_rtc_agent_tpu_torch.utils import env as PENV
from ai_rtc_agent_tpu_torch.utils import profiling as PPROF

REPO = Path(__file__).resolve().parents[1]
SIDES = {
    "jax": SimpleNamespace(agent=JA, signaling=JS, relay=JR, frames=JF),
    "port": SimpleNamespace(agent=PA, signaling=PS, relay=PR, frames=PF),
}
SDP = {"Content-Type": "application/sdp"}
CORS = ("Access-Control-Allow-Origin", "Access-Control-Allow-Headers",
        "Access-Control-Allow-Methods")
UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
TURBO = dict(t_index_list=(0,), num_inference_steps=1, timestep_spacing="trailing",
             scheduler="turbo", cfg_type="none")


@pytest.fixture(autouse=True)
def unsupervised(monkeypatch):
    monkeypatch.setenv("SUPERVISOR", "0")
    monkeypatch.setenv("WARMUP_FRAMES", "0")
    monkeypatch.delenv("HW_ENCODE", raising=False)
    monkeypatch.delenv("NVENC", raising=False)
    monkeypatch.delenv("PIPELINE_DEPTH", raising=False)
    monkeypatch.delenv("DROP_FRAMES", raising=False)


class FakePipeline:
    """Pipeline stand-in: invert colors; records control-plane calls."""

    def __init__(self):
        self.prompt = None
        self.t_index_list = None
        self.calls = 0

    def __call__(self, frame):
        self.calls += 1
        arr = frame if isinstance(frame, np.ndarray) else frame.to_ndarray()
        return 255 - arr

    def update_prompt(self, p):
        self.prompt = p

    def update_t_index_list(self, t):
        if len(t) != 4:
            raise ValueError("length must stay 4")
        self.t_index_list = list(t)


async def _obs(r) -> dict:
    """What the contract fixes of a response: status, content type, CORS,
    Location and X-Stream-Id (ids masked), the body (ids masked)."""
    body = await r.text()
    loc = r.headers.get("Location")
    return {
        "status": r.status,
        "type": r.content_type,
        "cors": [r.headers.get(k) for k in CORS],
        "location": None if loc is None else UUID.sub("<id>", loc),
        "stream_id": UUID.sub("<id>", r.headers.get("X-Stream-Id", "")),
        "body": UUID.sub("<id>", body),
    }


def _run_both(case, monkeypatch, make_pipe=None):
    """Run ``case(ctx)`` against each agent; the transcripts must be equal."""

    async def drive(m):
        pipe = (make_pipe or FakePipeline)()
        app = m.agent.build_app(pipeline=pipe, provider=m.signaling.LoopbackProvider())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await case(SimpleNamespace(app=app, client=client, pipe=pipe, m=m,
                                              monkeypatch=monkeypatch))
        finally:
            await client.close()

    got = {side: asyncio.run(drive(m)) for side, m in SIDES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


async def _whip(c):
    return await c.client.post("/whip", data=c.m.signaling.make_loopback_offer(), headers=SDP)


async def _whep(c):
    offer = c.m.signaling.make_loopback_offer(video=False, datachannel=False)
    return await c.client.post("/whep", data=offer, headers=SDP)


def _viewers(c):
    return [pc.out_tracks[0] for pc in c.app["state"]["whep_pcs"].values()]


async def case_health_and_cors(c):
    out = [await _obs(await c.client.get("/"))]
    for path in ("/config", "/whip", "/whep", "/offer"):
        out.append(await _obs(await c.client.options(path)))
    return out


async def case_config(c):
    post = c.client.post
    out = [await _obs(await post("/config", json={"prompt": "hello", "t_index_list": [1, 2, 3, 4]}))]
    for body in ({"t_index_list": [1]}, {"t_index_list": [18, None]},
                 {"prompt": "late", "guidance_scale": 2.0}, {"prompt": "late", "delta": 0.5},
                 {"prompt": "late", "encoder": {"bitrate": 1}}):
        out.append(await _obs(await post("/config", json=body)))
    for raw in ("[1,2]", "null", "{", "not json"):
        out.append(await _obs(await post("/config", data=raw,
                                         headers={"Content-Type": "application/json"})))
    # refused before anything applies: the pipeline has no update_adapter
    # (the JAX message, which names the scheduler as the owner)
    out.append(await _obs(await post("/config", json={"prompt": "late", "adapter": "ghibli"})))
    out.append((c.pipe.prompt, c.pipe.t_index_list))
    return out


async def case_whep_without_source(c):
    out = [await _obs(await c.client.post("/whep", data="fake", headers=SDP))]
    out.append(await _obs(await c.client.delete("/whep")))
    out.append(await _obs(await c.client.post("/whip", data="x", headers={"Content-Type": "text/plain"})))
    out.append(await _obs(await c.client.post("/whep", data="x", headers={"Content-Type": "text/plain"})))
    for path in ("/whip", "/whep/nonexistent", "/whip/nonexistent"):
        out.append(await _obs(await c.client.delete(path)))
    return out


async def case_whip_then_whep_end_to_end(c):
    """WARMUP_FRAMES=2: the first two frames go through the pipeline and are
    dropped; the viewer's first frame is the third, inverted."""
    c.monkeypatch.setenv("WARMUP_FRAMES", "2")
    out = [await _obs(await _whip(c))]
    source = c.app["state"]["source_track"]
    out.append(await _obs(await _whep(c)))
    (viewer,) = _viewers(c)
    out.append((source is not None, viewer is not source))
    pub = next(iter(c.app["state"]["whip_pcs"].values()))
    for i in range(4):
        await pub.in_track.push(np.full((8, 8, 3), i * 10, dtype=np.uint8))
    out.append((await viewer.recv()).tolist())
    out.append(c.pipe.calls >= 3)
    await pub.datachannel.deliver(json.dumps({"prompt": "via dc"}))
    await pub.datachannel.deliver("not json")  # logged, not raised
    out.append(c.pipe.prompt)
    return out


async def case_offer_with_webhooks(c):
    events = []
    h = c.app["stream_event_handler"]
    h.handle_stream_started = lambda s, r, **kw: events.append(("started", r))
    h.handle_stream_ended = lambda s, r, **kw: events.append(("ended", r))
    offer = {"sdp": c.m.signaling.make_loopback_offer(), "type": "offer"}
    r = await c.client.post("/offer", json={"room_id": "room1", "offer": offer})
    out = [await _obs(r)]
    (pc,) = c.app["pcs"]
    out.append((pc.connectionState, len(pc.out_tracks)))
    await pc.in_track.push(np.full((8, 8, 3), 40, dtype=np.uint8))
    out.append((await pc.out_tracks[0].recv()).tolist())
    await pc.datachannel.deliver(json.dumps({"prompt": "offer dc"}))
    out.append(c.pipe.prompt)
    await pc.close()
    out.append((list(events), len(c.app["pcs"])))
    for body in ({"offer": offer}, {"room_id": "r"}, {"room_id": "r", "offer": {"sdp": "x"}}):
        out.append(await _obs(await c.client.post("/offer", json=body)))
    out.append(await _obs(await c.client.post("/offer", data="{",
                                              headers={"Content-Type": "application/json"})))
    out.append(len(c.app["pcs"]))
    return out


async def case_session_scoped_delete(c):
    out = [await _obs(await _whip(c))]
    locs = []
    for _ in range(2):
        r = await _whep(c)
        out.append(await _obs(r))
        locs.append(r.headers["Location"])
    by_session = dict(c.app["state"]["whep_pcs"])
    sids = [loc.rsplit("/", 1)[1] for loc in locs]
    out.append(await _obs(await c.client.delete(locs[0])))
    out.append([by_session[s].connectionState for s in sids])
    out.append(sids[1] in c.app["state"]["whep_pcs"])
    out.append(await _obs(await c.client.delete("/whep/nonexistent")))
    out.append(await _obs(await c.client.delete("/whep")))
    out.append(by_session[sids[1]].connectionState)
    out.append(await _obs(await c.client.delete("/whip")))
    out.append((c.app["state"]["source_track"] is None, dict(c.app["state"]["whip_pcs"])))
    return out


async def case_two_viewers(c):
    out = [await _obs(await _whip(c))]
    for _ in range(2):
        out.append(await _obs(await _whep(c)))
    viewers = _viewers(c)
    pub = next(iter(c.app["state"]["whip_pcs"].values()))
    for i in range(3):
        await pub.in_track.push(np.full((8, 8, 3), 30 + i * 40, dtype=np.uint8))
    # in rounds: a viewer left unread past its 2-frame queue drops (latest wins)
    out.append([[(await v.recv()).tolist() for v in viewers] for _ in range(3)])
    return out


async def case_slow_viewer_drops_not_blocks(c):
    class Source:
        def __init__(self):
            self.q = asyncio.Queue()

        async def recv(self):
            return await self.q.get()

    src = Source()
    relay = c.m.relay.TrackRelay(src)
    fast, slow = relay.subscribe(maxsize=2), relay.subscribe(maxsize=2)
    for i in range(8):
        await src.q.put(np.full((4, 4, 3), i, np.uint8))
    out = [[int((await fast.recv())[0, 0, 0]) for _ in range(2)], int((await slow.recv())[0, 0, 0])]
    slow.stop()
    await src.q.put(np.full((4, 4, 3), 99, np.uint8))
    out.append(int((await fast.recv())[0, 0, 0]))
    relay.stop()
    return out


async def case_publisher_failover(c):
    locs = []
    out = []
    for _ in range(2):
        r = await _whip(c)
        out.append(await _obs(r))
        locs.append(r.headers["Location"])
    sids = [loc.rsplit("/", 1)[1] for loc in locs]
    st = c.app["state"]
    out.append(st["source_relay"] is st["whip_relays"][sids[1]])
    out.append(await _obs(await c.client.delete(locs[1])))
    out.append((st["source_track"] is st["whip_tracks"][sids[0]],
                st["source_relay"] is st["whip_relays"][sids[0]], sids[1] in st["whip_relays"]))
    out.append(await _obs(await _whep(c)))
    (viewer,) = _viewers(c)
    await st["whip_pcs"][sids[0]].in_track.push(np.full((8, 8, 3), 77, np.uint8))
    out.append((await viewer.recv()).tolist())
    return out


async def case_publisher_churn_sweeps_dead_sessions(c):
    locs = [(await _whip(c)).headers["Location"] for _ in range(2)]
    sids = [loc.rsplit("/", 1)[1] for loc in locs]
    out = [await _obs(await c.client.delete(locs[0]))]
    st = c.app["state"]
    out.append((sids[0] in st["whip_tracks"], sids[0] in st["whip_relays"],
                st["source_relay"] is st["whip_relays"][sids[1]]))
    return out


async def case_failed_offer_closes_its_pc(c):
    async def boom(self):
        raise RuntimeError("synthetic createAnswer failure")

    c.monkeypatch.setattr(c.m.signaling.LoopbackPeerConnection, "createAnswer", boom)
    offer = {"sdp": c.m.signaling.make_loopback_offer(), "type": "offer"}
    out = [(await c.client.post("/offer", json={"room_id": "r1", "offer": offer})).status]
    out.append(len(c.app["pcs"]))
    out.append((await _whip(c)).status)  # a failed publish leaves nothing either
    out.append((len(c.app["pcs"]), dict(c.app["state"]["whip_pcs"]), c.app["state"]["source_track"]))
    return out


async def case_metrics(c):
    r = await c.client.get("/metrics")
    body = await r.json()
    port_keys = ("frames_total", "fps", "latency_p50_ms", "latency_p90_ms", "latency_max_ms")
    return [r.status, r.content_type, {k: body[k] for k in port_keys}]


CASES = [case_health_and_cors, case_config, case_whep_without_source,
         case_whip_then_whep_end_to_end, case_offer_with_webhooks, case_session_scoped_delete,
         case_two_viewers, case_slow_viewer_drops_not_blocks, case_publisher_failover,
         case_publisher_churn_sweeps_dead_sessions, case_failed_offer_closes_its_pc, case_metrics]


@pytest.mark.parametrize("case", CASES, ids=[f.__name__[5:] for f in CASES])
def test_http_contract_matches_jax_agent(monkeypatch, case):
    _run_both(case, monkeypatch)


# -- the JAX agent's defaults: supervision, overload control, the engine guard ----

def jax_defaults(monkeypatch):
    """SUPERVISOR, OVERLOAD_CONTROL and ENGINE_GUARD on, as both agents
    default; the loop-lag budget out of reach, so that a busy test box's
    event loop does not refuse admissions in one run and not the other."""
    for name in ("SUPERVISOR", "OVERLOAD_CONTROL", "ENGINE_GUARD"):
        monkeypatch.setenv(name, "1")
    monkeypatch.setenv("OVERLOAD_LOOP_LAG_BUDGET_MS", "100000")


def _health(body: dict) -> dict:
    """A /health body as the contract fixes it: every plane, each
    session's supervisor snapshot with its clock readings as types, the
    sessions sorted by their snapshots (their ids are random).  Compared by
    key: the overload plane's ``pressure`` (a ratio of two EWMAs of clock
    readings), the SLO views' clock readings (``timed``) and the device
    telemetry's ``watchdog`` (the JAX plane hears XLA through
    jax.monitoring, the port's builds report themselves: "cache-wrap",
    obs/devtel.py)."""
    out = comparable(body)
    if "overload" in out:  # a ratio of the step and loop-lag EWMAs: a clock reading
        out["overload"] = dict(out["overload"], pressure=type(out["overload"]["pressure"]).__name__)
    if "devtel" in out:
        out["devtel"] = dict(out["devtel"], watchdog=type(out["devtel"]["watchdog"]).__name__)
    sessions = []
    for snap in out.get("sessions", {}).values():
        snap = timed(comparable(snap))
        for k in ("since_s", "last_frame_age_s"):
            snap[k] = type(snap[k]).__name__
        snap["transitions"] = [{k: v for k, v in t.items() if k != "t"}
                               for t in snap["transitions"]]
        sessions.append(snap)
    out["sessions"] = sorted(sessions, key=lambda x: json.dumps(x, sort_keys=True))
    return out


async def _get_json(c, path):
    r = await c.client.get(path)
    return r.status, r.content_type, await r.json()


async def _refused(r) -> list:
    return [await _obs(r), r.headers.get("Retry-After")]


async def case_operator_endpoints(c):
    """/health and /capacity idle and with a live session; /drain freezes
    admission (a new /whip and /offer answer 503 with Retry-After) while the
    live session's frames go on; unfreeze admits again; bad bodies 400."""
    out = []
    status, ctype, body = await _get_json(c, "/health")
    out.append((status, ctype, _health(body)))
    out.append((await _get_json(c, "/capacity"))[:2] + (comparable((await _get_json(c, "/capacity"))[2]),))
    out.append(await _obs(await _whip(c)))
    out.append(await _obs(await _whep(c)))
    (viewer,) = _viewers(c)
    pub = next(iter(c.app["state"]["whip_pcs"].values()))
    await pub.in_track.push(np.full((8, 8, 3), 20, dtype=np.uint8))
    out.append((await viewer.recv()).tolist())
    out.append(_health((await _get_json(c, "/health"))[2]))
    post = c.client.post
    for action in ("freeze", "freeze"):
        r = await post("/drain", json={"action": action})
        out.append((r.status, r.content_type, await r.json()))
    out.append(comparable((await _get_json(c, "/capacity"))[2]))
    out.append(await _refused(await _whip(c)))
    offer = {"sdp": c.m.signaling.make_loopback_offer(), "type": "offer"}
    out.append(await _refused(await post("/offer", json={"room_id": "r", "offer": offer})))
    await pub.in_track.push(np.full((8, 8, 3), 90, dtype=np.uint8))  # the live session goes on
    out.append((await viewer.recv()).tolist())
    out.append(_health((await _get_json(c, "/health"))[2]))
    r = await post("/drain", json={"action": "unfreeze"})
    out.append((r.status, await r.json()))
    out.append(comparable((await _get_json(c, "/capacity"))[2]))
    out.append(await _obs(await _whip(c)))
    for raw in ('{"action": "melt"}', "[1]", "{"):
        out.append(await _obs(await post("/drain", data=raw,
                                         headers={"Content-Type": "application/json"})))
    out.append(_health((await _get_json(c, "/health"))[2]))
    return out


async def case_session_cap_refuses_with_retry_after(c):
    """OVERLOAD_MAX_SESSIONS=1: the second session is refused at the door
    with the unscaled Retry-After; a DELETE frees the place."""
    out = [await _obs(await _whip(c))]
    r = await _whip(c)
    out.append(await _refused(r))
    out.append(comparable((await _get_json(c, "/capacity"))[2]))
    out.append(await _obs(await c.client.delete("/whip")))
    await asyncio.sleep(0)  # the close handlers end supervision
    out.append(comparable((await _get_json(c, "/capacity"))[2]))
    out.append(await _obs(await _whip(c)))
    return out


OPERATOR_CASES = [case_operator_endpoints, case_session_cap_refuses_with_retry_after]


@pytest.mark.parametrize("case", CASES + OPERATOR_CASES,
                         ids=[f.__name__[5:] for f in CASES + OPERATOR_CASES])
def test_http_contract_under_the_jax_defaults(monkeypatch, case):
    """The same transcripts with supervision, overload control and the
    engine guard on (each agent's default), and the operator endpoints."""
    jax_defaults(monkeypatch)
    if case is case_session_cap_refuses_with_retry_after:
        monkeypatch.setenv("OVERLOAD_MAX_SESSIONS", "1")
    _run_both(case, monkeypatch)


async def case_no_overload_plane(c):
    out = [await _obs(await c.client.post("/drain", json={"action": "freeze"}))]
    out.append(comparable((await _get_json(c, "/capacity"))[2]))
    status, _, body = await _get_json(c, "/health")
    out.append((status, _health(body)))
    out.append(await _obs(await _whip(c)))
    out.append(_health((await _get_json(c, "/health"))[2]))
    return out


def test_operator_endpoints_without_the_overload_plane(monkeypatch):
    """OVERLOAD_CONTROL=0: /drain answers 409 (no freeze rung), /capacity
    counts no pressure, /health has no overload section."""
    jax_defaults(monkeypatch)
    monkeypatch.setenv("OVERLOAD_CONTROL", "0")
    _run_both(case_no_overload_plane, monkeypatch)


BOOT_ID = re.compile(r"[0-9a-f]{12}")


def comparable(body: dict) -> dict:
    """``body`` with its ``boot_id`` (a random nonce per process, so never
    equal across agents) held to the nonce's form, 12 hex digits, and
    masked; every other key kept as it is."""
    if "boot_id" not in body:
        return dict(body)
    assert BOOT_ID.fullmatch(str(body["boot_id"])), body["boot_id"]
    return {**body, "boot_id": "<boot_id>"}


# readings of a clock (and of the process's live buffers: JAX arrays against
# torch tensors): compared by key and type, everything else by value
TIMING_KEYS = {"t", "born", "taken_at", "ts", "dur", "remaining_s", "timestamp", "fps",
               "device_live_buffers", "p50_ms", "p99_ms", "burn_fast", "burn_slow", "over",
               "overload_pressure"}
TIMING_METRIC = re.compile(r"^(latency_|overload_(loop_lag|freshness|step)).*_ms(_\w+)?$")


def timed(obj):
    """``obj`` with every clock reading replaced by its type: the keys of
    TIMING_KEYS and TIMING_METRIC, a span ``[name, t0, t1]`` and a mark
    ``[name, t]`` by their names."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in TIMING_KEYS or TIMING_METRIC.match(k):
                out[k] = type(v).__name__
            elif k in ("spans", "marks"):
                out[k] = [x[0] for x in v]
            else:
                out[UUID.sub("<id>", k)] = timed(v)
        return out
    if isinstance(obj, list):
        return [timed(x) for x in obj]
    if isinstance(obj, str):
        return UUID.sub("<id>", obj)
    return obj


def prom_samples(text: str) -> list:
    """A Prometheus exposition as (line) tuples, clock readings masked: a
    comment line as it is, a sample as (name, labels, value or its type)."""
    out = []
    for line in text.splitlines():
        if line.startswith("#"):
            out.append(line)
            continue
        head, value = line.rsplit(" ", 1)
        name = head.split("{", 1)[0]
        if name in TIMING_KEYS or TIMING_METRIC.match(name) or name in (
                "slo_stage_latency_ms_bucket", "slo_stage_latency_ms_sum"):
            value = "<reading>"
        out.append((head, value))
    return out


def test_port_metrics_are_the_jax_frame_stats():
    """/metrics carries FrameStats and the overload plane's gauges under the
    JAX agent's names, the broadcast plane's included."""
    async def go(m):
        app = m.agent.build_app(pipeline=FakePipeline(), provider=m.signaling.LoopbackProvider())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await (await client.get("/metrics")).json()
        finally:
            await client.close()

    got = asyncio.run(go(SIDES["port"]))
    assert set(got) == set(comparable(asyncio.run(go(SIDES["jax"]))))
    assert set(JPROF.FrameStats().snapshot()) < set(got)


# -- observability: /debug/trace, /debug/flight, /metrics?format=prom ----------------

async def _jobs(r) -> list:
    """A JSON (or JSONL) response as the contract fixes it: status, content
    type, CORS, the body with clock readings and ids masked."""
    text = await r.text()
    if r.content_type == "application/x-ndjson":
        body = [timed(json.loads(line)) for line in text.splitlines()]
    elif r.content_type == "application/json":
        body = timed(json.loads(text))
    else:
        body = UUID.sub("<id>", text)
    return [r.status, r.content_type, [r.headers.get(k) for k in CORS], body]


def _stale(fill: int, age_s: float, m):
    f = m.frames.VideoFrame.from_ndarray(np.full((8, 8, 3), fill, dtype=np.uint8))
    f.wall_ts = time.monotonic() - age_s
    return f


async def case_debug_trace(c):
    """GET status, a start clamped to TRACE_MAX_CAPTURE_S, /metrics'
    trace_enabled, stop, the 400s, and a window with the profiler bridge
    (``jax_profiler_dir``: jax.profiler there, torch.profiler here)."""
    get, post = c.client.get, c.client.post
    out = [await _jobs(await get("/debug/trace"))]
    out.append(await _jobs(await post("/debug/trace", json={"action": "start", "duration_s": 9000})))
    out.append(await _jobs(await get("/debug/trace")))
    out.append((await (await get("/metrics")).json())["trace_enabled"])
    out.append(await _jobs(await post("/debug/trace", json={"action": "stop"})))
    out.append((await (await get("/metrics")).json())["trace_enabled"])
    for body in ({"action": "bogus"}, {"action": "start", "duration_s": "abc"}, {}):
        out.append(await _obs(await post("/debug/trace", json=body)))
    out.append(await _obs(await post("/debug/trace", data=b"not json")))
    log_dir = c.tmp / c.m.agent.__name__.split(".")[0]
    r = await post("/debug/trace", json={"action": "start", "duration_s": 5,
                                         "jax_profiler_dir": str(log_dir)})
    body = await r.json()
    out.append((r.status, body["tracing"], body["jax_profiler"].replace(str(log_dir), "<dir>")))
    out.append(await _jobs(await post("/debug/trace", json={"action": "stop"})))
    out.append(log_dir.is_dir() and any(log_dir.rglob("*")))
    return out


async def case_debug_flight(c):
    """TRACE_ENABLE=1 with the JAX defaults: a WHIP session whose ingest
    sheds three stale frames (their timelines sealed ``shed``), then the
    index, a live capture, a stored snapshot in the three formats, and the
    400 and 404 cases."""
    get = c.client.get
    out = [await _obs(await _whip(c))]
    (sid,) = c.app["state"]["whip_pcs"]
    pub = c.app["state"]["whip_pcs"][sid]
    track = c.app["state"]["whip_tracks"][sid]
    for fill in (10, 11, 12):
        await pub.in_track.push(_stale(fill, 10.0, c.m))
    await pub.in_track.push(_stale(40, 0.0, c.m))
    got = await asyncio.wait_for(track.recv(), 10)
    out.append((got if isinstance(got, np.ndarray) else got.to_ndarray()).tolist())
    out.append(await _jobs(await get("/debug/flight")))
    out.append(await _jobs(await get("/debug/flight", params={"session": sid})))
    out.append(c.app["flight"].take_snapshot(sid, reason="operator"))
    for fmt in ("json", "chrome", "jsonl"):
        out.append(await _jobs(await get("/debug/flight", params={"id": "flt-1", "format": fmt})))
    out.append(await _jobs(await get("/debug/flight", params={"session": sid, "format": "chrome"})))
    out.append(await _jobs(await get("/debug/flight")))
    for params in ({"id": "flt-none"}, {"session": "nope"}, {"id": "flt-1", "format": "bogus"},
                   {"format": "chrome"}, {"bogus": "1"}, {"journey": "j-1"},
                   {"journey": "j-1", "id": "flt-1"}, {"journey": "j-1", "format": "chrome"}):
        out.append(await _jobs(await get("/debug/flight", params=params)))
    return out


async def case_metrics_prom(c):
    """/metrics as JSON and as the Prometheus exposition after a served
    frame (clock readings masked), and an unknown format."""
    out = [await _obs(await _whip(c)), await _obs(await _whep(c))]
    (viewer,) = _viewers(c)
    pub = next(iter(c.app["state"]["whip_pcs"].values()))
    for fill in (20, 30):
        await pub.in_track.push(_stale(fill, 0.0, c.m))
        out.append((await viewer.recv()).tolist())
    r = await c.client.get("/metrics")
    out.append([r.status, r.content_type, timed(comparable(await r.json()))])
    r = await c.client.get("/metrics", params={"format": "prom"})
    out.append([r.status, r.headers.get("Content-Type"), prom_samples(await r.text())])
    out.append(await _obs(await c.client.get("/metrics", params={"format": "xml"})))
    return out


async def case_kill_switches(c):
    """FLIGHT_RECORDER=0 or DEVTEL_ENABLE=0 (set by the test): the planes'
    keys and the debug surface as each agent leaves them."""
    out = [await _jobs(await c.client.get("/debug/flight")),
           await _jobs(await c.client.get("/debug/trace")),
           await _jobs(await c.client.post("/debug/trace", data=b"not json"))]
    out.append(await _obs(await _whip(c)))
    r = await c.client.get("/metrics")
    out.append(sorted(comparable(timed(await r.json()))))
    out.append(_health((await _get_json(c, "/health"))[2]))
    out.append((c.app["flight"] is None, c.app["slo"] is None, c.app["devtel"] is None))
    return out


class _RaisingPipeline(FakePipeline):
    """Inverts colours; its calls 2 to 4 raise (a burst of failed steps)."""

    def __call__(self, frame):
        if 1 <= self.calls <= 3:
            self.calls += 1
            raise RuntimeError("synthetic step failure")
        return super().__call__(frame)

    def restart(self):
        pass


async def case_degraded_webhook_carries_flight_fields(c):
    """A failed step degrades a supervised session: the StreamDegraded
    webhook carries the snapshot frozen at the transition and the event
    log's last entries; the snapshot is stored under that id."""
    posted = []

    class Sess:
        async def post(self, url, headers=None, json=None):
            posted.append(json)
            return SimpleNamespace(status=200)

    handler = c.app["stream_event_handler"]
    handler.webhook_url, handler.token = "http://orchestrator/hook", "tok"
    handler._session_factory = Sess
    out = [await _obs(await _whip(c))]
    pub = next(iter(c.app["state"]["whip_pcs"].values()))
    (track,) = c.app["state"]["whip_tracks"].values()
    for fill in (50, 60, 70, 80):
        await pub.in_track.push(_stale(fill, 0.0, c.m))
        got = await asyncio.wait_for(track.recv(), 10)
        out.append((got if isinstance(got, np.ndarray) else got.to_ndarray()).tolist())
    for _ in range(200):
        if any(p["event"] == "StreamDegraded" for p in posted):
            break
        await asyncio.sleep(0.01)
    degraded = next(p for p in posted if p["event"] == "StreamDegraded")
    out.append(timed(degraded))
    snap = c.app["flight"].get_snapshot(degraded["flight_snapshot_id"])
    out.append((snap["reason"], timed(snap["events"][:1])))
    return out


case_degraded_webhook_carries_flight_fields.pipeline = _RaisingPipeline

OBS_CASES = [
    (case_debug_trace, {"TRACE_MAX_CAPTURE_S": "60"}),
    (case_debug_flight, {"TRACE_ENABLE": "1"}),
    (case_metrics_prom, {}),
    (case_kill_switches, {"FLIGHT_RECORDER": "0"}),
    (case_kill_switches, {"DEVTEL_ENABLE": "0"}),
    (case_kill_switches, {"SLO_ENABLE": "0"}),
    (case_degraded_webhook_carries_flight_fields, {}),
]


@pytest.mark.parametrize("case,env", OBS_CASES,
                         ids=[f.__name__[5:] + "".join(f"-{k}={v}" for k, v in e.items())
                              for f, e in OBS_CASES])
def test_observability_transcripts_match_jax_agent(monkeypatch, tmp_path, case, env):
    """/debug/trace, /debug/flight, /metrics?format=prom, the kill switches
    and the StreamDegraded webhook's flight fields, under the JAX defaults:
    equal to the JAX agent's, clock readings compared by key."""
    jax_defaults(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    async def with_tmp(c):
        c.tmp = tmp_path
        return await case(c)

    _run_both(with_tmp, monkeypatch, getattr(case, "pipeline", None))


# -- the slice as a whole: the tiny-test turbo pipeline served by each agent ------

@pytest.fixture(scope="module")
def jax_pipe():
    """Pallas flash attention (interpret mode); the composed epilogue, whose
    Pallas kernel the port's kernel tests already hold."""
    cfg = JREG.default_stream_config("tiny-test", attn_impl="pallas", use_fused_epilogue=False, **TURBO)
    pipe = JPipeline("tiny-test", config=cfg)
    pipe(np.zeros((64, 64, 3), np.uint8))  # compile before serving; turbo/none keeps no ring
    pipe.state0 = jax.tree.map(np.asarray, pipe.engine.state)
    return pipe


@pytest.fixture(scope="module")
def port_pipe(jax_pipe):
    cfg = PREG.default_stream_config("tiny-test", device="cpu", **TURBO)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jax_pipe.engine.params))
    return PPipeline("tiny-test", config=cfg, device="cpu", params=params, prompt=jax_pipe.prompt)


def _frames(n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(n)]


async def _serve(m, pipeline, frames):
    """WHIP + WHEP through ``m``'s agent; push ``frames`` (pts 0, 1, ...) and
    one more behind them (the track keeps 2 in flight); -> frames viewed."""
    app = m.agent.build_app(pipeline=pipeline, provider=m.signaling.LoopbackProvider())
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        c = SimpleNamespace(client=client, m=m)
        assert (await _whip(c)).status == 201 and (await _whep(c)).status == 201
        pub = next(iter(app["state"]["whip_pcs"].values()))
        viewer = next(pc for pc in app["state"]["whep_pcs"].values()).out_tracks[0]
        for i, f in enumerate(frames + frames[-1:]):
            vf = m.frames.VideoFrame.from_ndarray(f)
            vf.pts, vf.time_base = i, Fraction(1, 30)
            await pub.in_track.push(vf)
        return [await asyncio.wait_for(viewer.recv(), 60) for _ in frames]
    finally:
        await client.close()


def test_served_frames_match_the_jax_agent(jax_pipe, port_pipe):
    frames = _frames()
    want = asyncio.run(_serve(SIDES["jax"], jax_pipe, frames))
    port_pipe.engine.state = bridge.state_from_jax(jax_pipe.state0)
    got = asyncio.run(_serve(SIDES["port"], port_pipe, frames))
    assert [g.pts for g in got] == [w.pts for w in want] == list(range(len(frames)))
    assert {g.time_base for g in got} == {w.time_base for w in want} == {Fraction(1, 30)}
    for g, w in zip(got, want):
        diff = np.abs(g.to_ndarray().astype(np.int16) - w.to_ndarray().astype(np.int16))
        assert g.to_ndarray().shape == (64, 64, 3) and diff.max() <= 1, diff.max()


def test_served_frames_are_the_direct_call_after_restart(port_pipe):
    frames = _frames(seed=4)
    port_pipe.restart()
    served = asyncio.run(_serve(SIDES["port"], port_pipe, frames))
    port_pipe.restart()
    for vf, f in zip(served, frames):
        np.testing.assert_array_equal(vf.to_ndarray(), port_pipe(f))


# -- the pipeline surface the track drives ---------------------------------------

def _vframes(mod, frames, pts0=10):
    out = []
    for i, f in enumerate(frames):
        vf = mod.VideoFrame.from_ndarray(f)
        vf.pts, vf.time_base, vf.wall_ts = pts0 + i, Fraction(1, 90000), 5.0 + i
        out.append(vf)
    return out


def _assert_frames_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        if hasattr(w, "pts"):
            assert (g.pts, g.time_base, g.wall_ts) == (w.pts, w.time_base, w.wall_ts)
            g, w = g.to_ndarray(), w.to_ndarray()
        assert g.shape == w.shape and g.dtype == w.dtype == np.uint8
        assert np.abs(g.astype(np.int16) - w.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("with_src", [True, False])
def test_fetch_with_source_frame_matches_jax(jax_pipe, port_pipe, with_src):
    frames = _frames(3, seed=5)
    port_pipe.engine.state = bridge.state_from_jax(jax_pipe.state0)
    outs = {}
    for name, pipe, mod in (("jax", jax_pipe, JF), ("port", port_pipe, PF)):
        src = _vframes(mod, frames)
        handles = [pipe.submit(f) for f in src]
        outs[name] = [pipe.fetch(h, f if with_src else None) for h, f in zip(handles, src)]
        # postprocess wraps only a source with pts
        outs[name].append(pipe.postprocess(frames[0], src[0]))
        outs[name].append(pipe.postprocess(frames[0], frames[1]))
    _assert_frames_close(outs["port"], outs["jax"])


@pytest.mark.parametrize("hw_encode", ["0", "1"])
def test_call_keeps_pts_unless_hw_encode(monkeypatch, jax_pipe, port_pipe, hw_encode):
    monkeypatch.setenv("HW_ENCODE", hw_encode)
    frames = _frames(2, seed=6)
    port_pipe.engine.state = bridge.state_from_jax(jax_pipe.state0)
    got = [port_pipe(f) for f in _vframes(PF, frames)] + [port_pipe(frames[0])]
    want = [jax_pipe(f) for f in _vframes(JF, frames)] + [jax_pipe(frames[0])]
    _assert_frames_close(got, want)
    assert isinstance(got[0], np.ndarray) == (hw_encode == "1")


def test_fbs2_batches_match_jax():
    """frame_buffer_size=2 (JAX on its default composed path): submit_batch /
    fetch_batch of two frames at a time, pts carried per frame."""
    cfg = JREG.default_stream_config("tiny-test", frame_buffer_size=2, **TURBO)
    jpipe = JPipeline("tiny-test", config=cfg)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jpipe.engine.params))
    ppipe = PPipeline("tiny-test", config=PREG.default_stream_config(
        "tiny-test", device="cpu", frame_buffer_size=2, **TURBO), device="cpu", params=params,
        prompt=jpipe.prompt)
    ppipe.engine.state = bridge.state_from_jax(jax.tree.map(np.asarray, jpipe.engine.state))
    assert ppipe.frame_buffer_size == jpipe.frame_buffer_size == 2
    frames = _frames(4, seed=7)
    outs = {}
    for name, pipe, mod in (("jax", jpipe, JF), ("port", ppipe, PF)):
        src = _vframes(mod, frames)
        h0, h1 = pipe.submit_batch(src[:2]), pipe.submit_batch(src[2:])
        outs[name] = pipe.fetch_batch(h0, src[:2]) + pipe.fetch_batch(h1)
    _assert_frames_close(outs["port"], outs["jax"])


class FakeBatchPipeline(FakePipeline):
    """Invert colors through submit/fetch and submit_batch/fetch_batch."""

    def __init__(self, fbs):
        super().__init__()
        self.frame_buffer_size = fbs

    def submit(self, frame):
        return self(frame)

    def fetch(self, handle, src=None):
        return handle

    def submit_batch(self, frames):
        return [self(f) for f in frames]

    def fetch_batch(self, handle, srcs=None):
        return handle


@pytest.mark.parametrize("depth,fbs,warmup,drop", [
    (1, 1, 0, 0), (2, 1, 0, 0), (3, 1, 2, 1), (1, 2, 0, 0), (2, 2, 2, 0), (2, 2, 0, 1),
])
def test_track_matches_jax(monkeypatch, depth, fbs, warmup, drop):
    """VideoStreamTrack: warm-up, dropped frames, frames in flight and the
    fbs batched path deliver the same frames in the same order."""
    monkeypatch.setenv("WARMUP_FRAMES", str(warmup))
    monkeypatch.setenv("DROP_FRAMES", str(drop))

    async def drive(tracks_mod, sig):
        src = sig.LoopbackTrack()
        pipe = FakeBatchPipeline(fbs)
        track = tracks_mod.VideoStreamTrack(src, pipe, pipeline_depth=depth)
        for i in range(16):  # the source queue's bound; the cases need at most 16
            await src.push(np.full((4, 4, 3), i, np.uint8))
        return [int((await track.recv())[0, 0, 0]) for _ in range(6)], pipe.calls

    want = asyncio.run(drive(JT, JS))
    assert asyncio.run(drive(PT, PS)) == want


# -- webhooks, TURN, env, FrameStats, frames ------------------------------------

class _Capture:
    def __init__(self):
        self.posts = []

    def __call__(self):
        return self

    async def post(self, url, headers=None, json=None):
        self.posts.append((url, headers, json))
        return SimpleNamespace(status=200)


@pytest.mark.parametrize("event", ["started", "ended"])
def test_webhook_json_matches_jax_model_dump(monkeypatch, event):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.7)
    monkeypatch.setenv("WEBHOOK_URL", "http://hook/x")
    monkeypatch.setenv("AUTH_TOKEN", "tok")

    async def post(mod):
        cap = _Capture()
        h = mod.StreamEventHandler(session_factory=cap)
        await getattr(h, f"handle_stream_{event}")("stream-1", "room-9")
        return cap.posts

    got, want = asyncio.run(post(PE)), asyncio.run(post(JE))
    assert got == want and len(got) == 1
    assert got[0][2]["event"] == f"Stream{event.capitalize()}"


FAULT_WEBHOOKS = [
    ("handle_session_state", ("stream-1", "room-9", "DEGRADED", "engine step exceeded 5.0s"), {}),
    ("handle_session_state", ("stream-1", "room-9", "FAILED", "restart budget exhausted"),
     {"recent_events": [{"kind": "restart_attempt"}]}),
    ("handle_session_state", ("stream-1", "room-9", "RECOVERING", "engine restarted"), {}),
    ("handle_session_state", ("stream-1", "room-9", "HEALTHY", "engine steps healthy"), {}),
    ("handle_engine_state", ("EngineDegraded", "QUARANTINED"), {"reason": "device lost: x"}),
    ("handle_engine_state", ("EngineRecovered", "ARMED"),
     {"reason": "", "rebuild_ms": 812.5, "attempt": 2, "restored": 3}),
    ("handle_engine_state", ("AgentEvacuating", "EVACUATING"), {"reason": "step wedged"}),
]


@pytest.mark.parametrize("method,args,kw", FAULT_WEBHOOKS,
                         ids=[f"{m[7:]}-{a[2] if len(a) > 2 else a[0]}" for m, a, _ in FAULT_WEBHOOKS])
def test_fault_webhooks_match_jax_model_dump(monkeypatch, method, args, kw):
    """The supervisor's and the engine guard's webhooks: the JSON the JAX
    agent posts (a keyword that is no field of the event is dropped)."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.7)
    monkeypatch.setenv("WEBHOOK_URL", "http://hook/x")
    monkeypatch.setenv("AUTH_TOKEN", "tok")

    async def post(mod):
        cap = _Capture()
        await getattr(mod.StreamEventHandler(session_factory=cap), method)(*args, **kw)
        return cap.posts

    got, want = asyncio.run(post(PE)), asyncio.run(post(JE))
    assert got == want and len(got) == 1


def test_webhooks_off_without_url_and_token(monkeypatch):
    monkeypatch.delenv("WEBHOOK_URL", raising=False)
    monkeypatch.delenv("AUTH_TOKEN", raising=False)
    assert PE.StreamEventHandler().handle_stream_started("s", "r") is None
    monkeypatch.setenv("WEBHOOK_URL", "http://hook/x")
    monkeypatch.setenv("AUTH_TOKEN", "tok")
    with pytest.raises(ValueError):  # a name outside the closed vocabulary
        PE.StreamEventHandler().send_request("StreamTeleported", "s", "r")


TOKEN = {"ice_servers": [
    {"url": "stun:global.stun.twilio.com:3478"},
    {"url": "turn:global.turn.twilio.com:3478?transport=udp", "username": "u", "credential": "c"},
    {"url": "turn:global.turn.twilio.com:443?transport=tcp", "urls": "turns:x", "username": "u2",
     "credential": "c2"},
]}


@pytest.mark.parametrize("env,reply", [
    ({"ICE_SERVERS": json.dumps([{"urls": ["turn:a"], "username": "x", "credential": "y"}])}, None),
    ({"ICE_SERVERS": "{not json"}, None),
    ({"ICE_SERVERS": json.dumps({"urls": "turn:a"})}, None),
    ({"TWILIO_ACCOUNT_SID": "AC1", "TWILIO_AUTH_TOKEN": "s3"}, (200, TOKEN)),
    ({"TWILIO_ACCOUNT_SID": "AC1", "TWILIO_AUTH_TOKEN": "s3"}, (403, {})),
    ({}, (200, TOKEN)),
])
def test_ice_servers_match_jax(monkeypatch, env, reply):
    for k in ("ICE_SERVERS", "TWILIO_ACCOUNT_SID", "TWILIO_AUTH_TOKEN"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def servers(mod):
        calls = []

        def http_post(url, headers):
            calls.append((url, headers))
            return reply

        return mod.get_ice_servers(http_post), calls

    got, want = servers(PTURN), servers(JTURN)
    assert got == want
    if got[0]:
        assert PTURN.get_link_headers(got[0]) == JTURN.get_link_headers(want[0])


def test_twilio_backoff_schedule_matches_jax_transient_policy():
    """Transport failures retry 3 times with the same full-jitter delays as
    the JAX package's transient_policy (same seeded rng), then give up."""

    def failing():
        raise OSError("down")

    delays = {}
    for name in ("port", "jax"):
        slept = []
        with pytest.raises((PTURN.RetryError, JRETRY.RetryError)):
            if name == "port":
                PTURN.transient_retry(failing, (OSError,), sleep=slept.append, rng=random.Random(7))
            else:
                JRETRY.transient_policy(attempts=3).run(
                    failing, retry_on=(OSError,), sleep=slept.append, rng=random.Random(7))
        delays[name] = slept
    assert delays["port"] == delays["jax"] and len(delays["port"]) == 2


@pytest.mark.parametrize("name,value", [
    ("WARMUP_FRAMES", None), ("WARMUP_FRAMES", "3"), ("DROP_FRAMES", "2"), ("PIPELINE_DEPTH", "0"),
    ("PIPELINE_DEPTH", "4"), ("HW_ENCODE", "off"), ("HW_ENCODE", "yes"), ("NVENC", "1"),
    ("HW_DECODE", "1"), ("HW_DECODE", "off"), ("NVDEC", "yes"), ("ENC_PRESET", "fast"),
    ("NVENC_PRESET", "slow"), ("ENC_DEFAULT_BITRATE", "800000"),
    ("NVENC_DEFAULT_BITRATE", "900000"), ("ADVERTISE_HOST", "10.0.0.2"),
])
def test_env_getters_match_jax(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)
    for fn in ("warmup_frames", "drop_frames", "pipeline_depth", "hw_encode", "hw_decode"):
        assert getattr(PENV, fn)() == getattr(JENV, fn)(), fn
    assert PENV.get_str(name, "d") == JENV.get_str(name, "d")
    assert PENV.get_bool(name, True) == JENV.get_bool(name, True)
    for args in (("ENC_PRESET", "NVENC_PRESET", "ultrafast"),
                 ("ENC_TUNING_INFO", "NVENC_TUNING_INFO", "zerolatency")):
        assert PENV.get_str_aliased(*args) == JENV.get_str_aliased(*args)
    args = ("ENC_DEFAULT_BITRATE", "NVENC_DEFAULT_BITRATE", 3_000_000)
    assert PENV.get_int_aliased(*args) == JENV.get_int_aliased(*args)


def test_env_rejects_a_non_integer(monkeypatch):
    monkeypatch.setenv("WARMUP_FRAMES", "ten")
    with pytest.raises(ValueError, match="not an integer"):
        PENV.warmup_frames()


def test_frame_stats_snapshot_matches_jax():
    stats = [PPROF.FrameStats(window=8), JPROF.FrameStats(window=8)]
    for s in stats:
        for i in range(12):
            s.record(0.01 * (i % 5 + 1), t=100.0 + 0.04 * i)
            s.record_stage("broadcast_freshness", 0.002 * i)
        s.count("broadcast_viewer_drops", 3)
    assert stats[0].snapshot() == stats[1].snapshot()


def test_wrap_processed_matches_jax():
    arr = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    outs = [mod.wrap_processed(255 - arr, _vframes(mod, [arr], pts0=7)[0]) for mod in (PF, JF)]
    meta = [(o.pts, o.time_base, o.wall_ts) for o in outs]
    assert meta[0] == meta[1] == (7, Fraction(1, 90000), 5.0)
    np.testing.assert_array_equal(outs[0].to_ndarray(), outs[1].to_ndarray())
    with pytest.raises(ValueError):
        PF.VideoFrame.from_ndarray(arr[..., :2])


def test_udp_port_pinning_patch():
    """Unbound datagram endpoints land on a pinned port; both busy raises;
    an explicit port bypasses the pin list."""

    async def go():
        loop = asyncio.get_running_loop()
        PA.patch_loop_datagram(["39561", "39562"])
        made = [await loop.create_datagram_endpoint(asyncio.DatagramProtocol,
                                                    local_addr=("127.0.0.1", 0)) for _ in range(2)]
        ports = {tr.get_extra_info("sockname")[1] for tr, _ in made}
        with pytest.raises(OSError):
            await loop.create_datagram_endpoint(asyncio.DatagramProtocol, local_addr=("127.0.0.1", 0))
        tr3, _ = await loop.create_datagram_endpoint(asyncio.DatagramProtocol,
                                                     local_addr=("127.0.0.1", 39610))
        explicit = tr3.get_extra_info("sockname")[1]
        for tr, _ in made + [(tr3, None)]:
            tr.close()
        return ports, explicit

    assert asyncio.run(go()) == ({39561, 39562}, 39610)


# -- guards ------------------------------------------------------------------------

def _module_level_imports(tree):
    """Import roots of statements that run at import time (not in a def)."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if isinstance(node, ast.ClassDef):
                stack.extend(node.body)
            continue
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        else:
            stack.extend(ast.iter_child_nodes(node))


def _port_files():
    return sorted((REPO / "ai_rtc_agent_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_only_the_http_layer_imports_aiohttp_at_module_level():
    importers = [p.relative_to(REPO).as_posix() for p in _port_files()
                 if "aiohttp" in _module_level_imports(ast.parse(p.read_text()))]
    assert importers == ["ai_rtc_agent_tpu_torch/fleet/router.py",
                         "ai_rtc_agent_tpu_torch/server/agent.py"]


def test_route_table_equals_the_jax_agents():
    """Every (method, path) the JAX agent serves, /broadcast/pull and /demo
    included, and nothing else (HEAD comes with each GET on both)."""
    def table(app):
        return sorted((r.method, r.resource.canonical) for r in app.router.routes())

    assert table(PA.build_app(pipeline=FakePipeline(), provider=PS.LoopbackProvider())) == \
        table(JA.build_app(pipeline=FakePipeline(), provider=JS.LoopbackProvider()))


def test_profile_port_zero_parses_and_any_other_is_refused(monkeypatch, capsys):
    """``--profile-port 0`` parses as the JAX agent's flag does; any other
    value stops ``main`` with a parser error naming the port's profiler,
    before anything is built or served."""
    ran = []
    monkeypatch.setattr(PA.web, "run_app", lambda app, **kw: ran.append(app))
    PA.main(["--model-id", "tiny-test", "--device", "cpu", "--profile-port", "0"])
    assert len(ran) == 1
    with pytest.raises(SystemExit) as exc:
        PA.main(["--model-id", "tiny-test", "--device", "cpu", "--profile-port", "9012"])
    assert exc.value.code == 2 and len(ran) == 1
    err = capsys.readouterr().err
    assert "--profile-port 9012" in err and "POST /debug/trace" in err


def test_demo_page_transcript_matches_jax(monkeypatch):
    """GET /demo serves the bundled page (the JAX package's page, copied),
    and answers 404 "demo page not bundled" without it."""
    async def go(m):
        app = m.agent.build_app(pipeline=FakePipeline(), provider=m.signaling.LoopbackProvider())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            out = [await _obs(await client.get("/demo"))]
            real = os.path.exists
            with monkeypatch.context() as mp:
                mp.setattr(os.path, "exists",
                           lambda p: False if str(p).endswith("demo.html") else real(p))
                out.append(await _obs(await client.get("/demo")))
            return out
        finally:
            await client.close()

    got, want = asyncio.run(go(SIDES["port"])), asyncio.run(go(SIDES["jax"]))
    assert got == want
    assert got[0]["status"] == 200 and "<html" in got[0]["body"].lower()
    assert got[1]["status"] == 404 and got[1]["body"] == "demo page not bundled"


def test_nothing_imports_pydantic():
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] == "pydantic" for n in names), path


def _block_aiortc(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_aiortc(name, *a, **kw):
        if name == "aiortc" or name.startswith("aiortc."):
            raise ImportError("aiortc unavailable (test)")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_aiortc)


PROVIDER_CHOICES = {
    "by name": "NativeRtpProvider",
    "by env": "NativeRtpProvider",
    "default without aiortc": "NativeRtpProvider",
    "default without the native runtime": "LoopbackProvider",
    "default without cryptography": "LoopbackProvider",
}


@pytest.mark.parametrize("how", list(PROVIDER_CHOICES))
def test_provider_choice_matches_jax(monkeypatch, caplog, how):
    """The port picks the provider the JAX ``get_provider`` picks, with the
    same warning: native-rtp by name or env; without aiortc the native tier
    when its C++ runtime loads and ``cryptography`` imports, else loopback."""
    import builtins
    import sys

    from ai_rtc_agent_tpu.media import native as JN
    from ai_rtc_agent_tpu_torch.media import native as PN

    _block_aiortc(monkeypatch)
    monkeypatch.delenv("WEBRTC_PROVIDER", raising=False)
    if how == "by env":
        monkeypatch.setenv("WEBRTC_PROVIDER", "native-rtp")
    if how == "default without the native runtime":
        monkeypatch.setattr(JN, "load", lambda: None)
        monkeypatch.setattr(PN, "load", lambda: None)
    if how == "default without cryptography":
        blocked = builtins.__import__

        def no_crypto(name, *a, **kw):
            if name == "cryptography" or name.startswith("cryptography."):
                raise ImportError("cryptography unavailable (test)")
            return blocked(name, *a, **kw)

        monkeypatch.setattr(builtins, "__import__", no_crypto)
        for name in [m for m in sys.modules if ".server.secure." in m
                     and m.rsplit(".", 1)[1] in ("endpoint", "dtls", "srtp")]:
            monkeypatch.delitem(sys.modules, name)
    choices = []
    for side in (JS, PS):
        caplog.clear()
        with caplog.at_level("WARNING", logger=side.__name__):
            provider = side.get_provider("native-rtp" if how == "by name" else None)
        choices.append((type(provider).__name__,
                        [r.getMessage() for r in caplog.records if r.name == side.__name__]))
    assert choices[0] == choices[1]
    assert choices[1][0] == PROVIDER_CHOICES[how]
    assert bool(choices[1][1]) == how.startswith("default")  # the warning names the tier
    if how != "by name":
        assert type(PA.build_app(pipeline=FakePipeline())["provider"]).__name__ == choices[1][0]


def test_provider_names(monkeypatch):
    _block_aiortc(monkeypatch)
    assert isinstance(PS.get_provider("loopback"), PS.LoopbackProvider)
    with pytest.raises(ImportError):
        PS.get_provider("aiortc")
    with pytest.raises(ValueError, match="unknown WEBRTC_PROVIDER"):
        PS.get_provider("loopbak")


@pytest.mark.parametrize("device", ["cpu", None])
def test_cli_serves_on_the_cpu_only_when_asked(monkeypatch, device):
    """``--device cpu`` serves tiny-test end to end (through the batch
    scheduler, the default path); without it the agent raises at startup on
    a box with no card instead of serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WEBRTC_PROVIDER", "loopback")
    built = {}
    monkeypatch.setattr(PA.web, "run_app", lambda app, **kw: built.update(app=app, **kw))
    PA.main(["--model-id", "tiny-test", "--port", "8899"] + (["--device", device] if device else []))
    assert built["port"] == 8899

    async def go():
        server = TestServer(built["app"])
        if device is None:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                await server.start_server()
            return None
        client = TestClient(server)
        await client.start_server()
        try:
            c = SimpleNamespace(client=client, m=SIDES["port"])
            assert (await client.get("/")).status == 200
            assert (await _whip(c)).status == 201 and (await _whep(c)).status == 201
            app = built["app"]
            pub = next(iter(app["state"]["whip_pcs"].values()))
            viewer = _viewers(SimpleNamespace(app=app))[0]
            for f in _frames(3):
                await pub.in_track.push(f)
            out = await asyncio.wait_for(viewer.recv(), 60)
            r = await client.post("/config", json={"prompt": "a red boat"})
            # the default path: the session rode the batch scheduler, which
            # /config updated (its live sessions and its default prompt)
            sched = app["batch_scheduler"]
            return out.shape, out.dtype, r.status, sched.prompt, sched.device.type
        finally:
            await client.close()

    got = asyncio.run(go())
    if device == "cpu":
        assert got == ((64, 64, 3), np.uint8, 200, "a red boat", "cpu")


def test_mode_txt2img_parses_and_serves_an_offer_as_the_jax_agent(monkeypatch):
    """``--mode txt2img`` on each agent's command line reaches the served
    config (no silent flag drop); one /offer session on each, the JAX
    session's weights and state carried across, other pixels pushed into
    the port's: the answers' forms agree and every viewed frame is within 1
    level of the JAX agent's (txt2img reads no pixel)."""
    for name, value in (("WEBRTC_PROVIDER", "loopback"), ("SUPERVISOR", "0"),
                        ("WARMUP_FRAMES", "0"), ("BATCHSCHED_MAX_SESSIONS", "1"),
                        ("OVERLOAD_LOOP_LAG_BUDGET_MS", "100000")):
        monkeypatch.setenv(name, value)
    built = {}
    for name, m, extra in (("jax", JA, []), ("port", PA, ["--device", "cpu"])):
        monkeypatch.setattr(m.web, "run_app", lambda app, name=name, **kw: built.update({name: app}))
        m.main(["--model-id", "tiny-test", "--mode", "txt2img"] + extra)
    assert built["jax"]["mode"] == built["port"]["mode"] == "txt2img"
    got = {}

    async def serve(name, frames, hook):
        app = built[name]
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            m = SIDES[name]
            r = await client.post("/offer", json={
                "room_id": "r", "offer": {"sdp": m.signaling.make_loopback_offer(),
                                          "type": "offer"}})
            body = await r.json()
            assert app["pipeline"].config.mode == "txt2img"
            hook(app)
            pc = next(iter(app["pcs"]))
            for i, f in enumerate(frames):
                vf = m.frames.VideoFrame.from_ndarray(f)
                vf.pts, vf.time_base = i, Fraction(1, 30)
                await pc.in_track.push(vf)
            seen = [(await asyncio.wait_for(pc.out_tracks[0].recv(), 120)).to_ndarray()
                    for _ in range(len(frames) - 2)]  # the track keeps 2 in flight
            return r.status, sorted(body), body["type"], seen
        finally:
            await client.close()

    def keep(app):
        got["params"] = jax.tree.map(np.asarray, app["pipeline"].engine.params)
        got["states"] = jax.tree.map(np.asarray, app["batch_scheduler"].states)

    want = asyncio.run(serve("jax", _frames(6, seed=20), keep))
    params = bridge.params_from_jax(got["params"])
    monkeypatch.setattr(PREG, "init_params", lambda fam, seed=0, device="cpu": params)
    port = asyncio.run(serve("port", _frames(6, seed=21),
                             lambda app: bridge.states_from_jax(got["states"],
                                                                app["batch_scheduler"].states)))
    assert port[:3] == want[:3] and want[0] == 200
    assert len(port[3]) == len(want[3]) == 4
    for a, b in zip(port[3], want[3]):
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


def test_unet_cache_3_serves_an_offer_as_the_jax_agent(monkeypatch):
    """``--unet-cache 3`` on each agent's command line reaches the served
    config of the pipeline and the batch scheduler (no silent flag drop);
    one /offer session on each agent, the JAX weights and session state
    carried across, the same frames pushed into both.  The transcript
    compared whole: the answers' forms; after 3 steps, /migrate/export's
    fingerprint (``unet_cache`` 3), cadence fields (``cache_tick`` 3,
    ``cache_uncaptured`` false) and control plane equal the JAX agent's, its
    deep-feature row within 1e-3 of the JAX row (f32, 3 steps); a /config
    prompt mid-session (the next step recaptures on both); every viewed
    frame within 1 level of the JAX agent's."""
    for name, value in (("WEBRTC_PROVIDER", "loopback"), ("SUPERVISOR", "0"),
                        ("WARMUP_FRAMES", "0"), ("BATCHSCHED_MAX_SESSIONS", "1"),
                        ("OVERLOAD_LOOP_LAG_BUDGET_MS", "100000")):
        monkeypatch.setenv(name, value)
    built = {}
    for name, m, extra in (("jax", JA, []), ("port", PA, ["--device", "cpu"])):
        monkeypatch.setattr(m.web, "run_app", lambda app, name=name, **kw: built.update({name: app}))
        m.main(["--model-id", "tiny-test", "--unet-cache", "3"] + extra)
    assert built["jax"]["unet_cache"] == built["port"]["unet_cache"] == 3
    frames = _frames(8, seed=40)
    got = {}

    async def until_dispatched(sched, n):
        """The cadence's tick counts the bucket steps dispatched since the
        claim on both schedulers (their steps_total counts at different
        points: the JAX one at a row's first fetch)."""
        deadline = time.monotonic() + 120
        while sched._tick < n:
            assert time.monotonic() < deadline, "steps never ran"
            await asyncio.sleep(0.02)

    async def serve(name, hook):
        app = built[name]
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            m = SIDES[name]
            r = await client.post("/offer", json={
                "room_id": "r", "offer": {"sdp": m.signaling.make_loopback_offer(),
                                          "type": "offer"}})
            body = await r.json()
            sched = app["batch_scheduler"]
            assert app["pipeline"].config.unet_cache_interval == 3 and sched._cache_interval == 3
            hook(app)
            pc = next(iter(app["pcs"]))

            async def push(fs, i0):
                for i, f in enumerate(fs):
                    vf = m.frames.VideoFrame.from_ndarray(f)
                    vf.pts, vf.time_base = i0 + i, Fraction(1, 30)
                    await pc.in_track.push(vf)

            async def view(n):
                return [(await asyncio.wait_for(pc.out_tracks[0].recv(), 120)).to_ndarray()
                        for _ in range(n)]

            await push(frames[:4], 0)
            seen = await view(2)  # the track keeps 2 in flight: 3 frames submitted
            await until_dispatched(sched, 3)
            export = await (await client.get(
                f"/migrate/export?session={r.headers['X-Stream-Id']}")).json()
            row = JC.deserialize_pytree(base64.b64decode(export.pop("state_b64")))
            config = await client.post("/config", json={"prompt": "a watercolor fox"})
            await push(frames[4:], 4)
            seen += await view(4)
            plane = {k: export[k] for k in ("schema", "kind", "fingerprint", "cache_tick",
                                           "cache_uncaptured", "prompt", "t_index_list",
                                           "frames_submitted", "had_output")}
            return (r.status, sorted(body), body["type"], plane, config.status, sched._tick,
                    seen, np.asarray(row["unet_cache"], np.float32))
        finally:
            await client.close()

    def keep(app):
        got["params"] = jax.tree.map(np.asarray, app["pipeline"].engine.params)
        got["states"] = jax.tree.map(np.asarray, app["batch_scheduler"].states)

    want = asyncio.run(serve("jax", keep))
    params = bridge.params_from_jax(got["params"])
    monkeypatch.setattr(PREG, "init_params", lambda fam, seed=0, device="cpu": params)
    port = asyncio.run(serve("port", lambda app: bridge.states_from_jax(
        got["states"], app["batch_scheduler"].states)))
    assert port[:6] == want[:6] and want[0] == 200 and want[4] == 200
    assert want[3]["fingerprint"]["unet_cache"] == 3 and want[3]["cache_tick"] == 3
    np.testing.assert_allclose(port[7], want[7], rtol=1e-3, atol=1e-3)
    assert np.abs(want[7]).max() > 0
    assert len(port[6]) == len(want[6]) == 6
    for a, b in zip(port[6], want[6]):
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


def _find(node, key):
    """Every dict under ``node`` (a JSON body) that holds ``key``."""
    if isinstance(node, dict):
        if key in node:
            yield node
        for v in node.values():
            yield from _find(v, key)
    elif isinstance(node, list):
        for v in node:
            yield from _find(v, key)


ADAPTER_CONFIGS = ({"adapter": "r8"}, {"adapter": None}, {"adapter": "nope", "prompt": "late"},
                   {"adapter": 5}, {"adapter": "r16", "prompt": "a watercolor fox"})


@pytest.mark.parametrize("with_dir", [True, False], ids=["adapter_dir", "no_adapter_dir"])
def test_adapter_dir_serves_styles_as_the_jax_agent(monkeypatch, tmp_path, with_dir):
    """``ADAPTER_DIR`` with three kohya styles (chip_smoke phase 15's, at
    tiny-test's geometry) on each agent: the boot loads them into the batch
    scheduler's bank (rank 16); one /offer session on each, the JAX weights
    and session state (its factor bank too) carried across, the same frames
    pushed into both.  The /config transcript is the JAX agent's, response
    for response: a swap, a ``null`` clear, an unknown name (400, nothing
    applied: the prompt stays), a non-string (400), a swap with a prompt;
    /health's and /metrics' adapter fields equal; every viewed frame within
    1 level.  Without ADAPTER_DIR the same requests get the JAX answers (the
    scheduler says no registry is bound) and the state has no bank."""
    import chip_smoke

    # supervised (the JAX default): /health's sessions carry the scheduler's view
    for name, value in (("WEBRTC_PROVIDER", "loopback"), ("SUPERVISOR", "1"),
                        ("WARMUP_FRAMES", "0"), ("BATCHSCHED_MAX_SESSIONS", "1"),
                        ("OVERLOAD_LOOP_LAG_BUDGET_MS", "100000")):
        monkeypatch.setenv(name, value)
    if with_dir:
        chip_smoke.adapter_files(np, tmp_path, PREG._model_configs("tiny")[0])
        monkeypatch.setenv("ADAPTER_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("ADAPTER_DIR", raising=False)
    built = {}
    for name, m, extra in (("jax", JA, []), ("port", PA, ["--device", "cpu"])):
        monkeypatch.setattr(m.web, "run_app", lambda app, name=name, **kw: built.update({name: app}))
        m.main(["--model-id", "tiny-test"] + extra)
    frames = _frames(7, seed=50)
    got = {}

    async def serve(name, hook):
        app = built[name]
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            m = SIDES[name]
            r = await client.post("/offer", json={
                "room_id": "r", "offer": {"sdp": m.signaling.make_loopback_offer(),
                                          "type": "offer"}})
            body = await r.json()
            sched = app["batch_scheduler"]
            hook(app)
            pc = next(iter(app["pcs"]))

            async def push(fs, i0):
                for i, f in enumerate(fs):
                    vf = m.frames.VideoFrame.from_ndarray(f)
                    vf.pts, vf.time_base = i0 + i, Fraction(1, 30)
                    await pc.in_track.push(vf)

            async def view(n):
                return [(await asyncio.wait_for(pc.out_tracks[0].recv(), 120)).to_ndarray()
                        for _ in range(n)]

            await push(frames[:3], 0)
            seen = await view(1)  # the track keeps 2 in flight
            replies = []
            for cfg in ADAPTER_CONFIGS:
                replies.append(await _obs(await client.post("/config", json=cfg)))
                replies.append((sched.prompt, sched.default_adapter))
            await push(frames[3:], 3)
            seen += await view(4)
            health = await (await client.get("/health")).json()
            metrics = await (await client.get("/metrics")).json()
            fields = ("adapter", "adapter_rank")
            per = [{k: d[k] for k in fields} for d in _find(health, "adapter_rank")]
            gauges = {k: v for k, v in metrics.items() if k.startswith("adapter_")}
            return (r.status, sorted(body), replies, per, gauges, "adapters" in sched.states,
                    seen)
        finally:
            await client.close()

    def keep(app):
        got["params"] = jax.tree.map(np.asarray, app["pipeline"].engine.params)
        got["states"] = jax.tree.map(np.asarray, app["batch_scheduler"].states)

    want = asyncio.run(serve("jax", keep))
    params = bridge.params_from_jax(got["params"])
    monkeypatch.setattr(PREG, "init_params", lambda fam, seed=0, device="cpu": params)
    port = asyncio.run(serve("port", lambda app: bridge.states_from_jax(
        got["states"], app["batch_scheduler"].states)))
    assert port[:6] == want[:6] and want[0] == 200
    statuses = [r["status"] for r in want[2][::2]]
    if with_dir:
        assert statuses == [200, 200, 400, 400, 200]
        assert want[3] == [{"adapter": "r16", "adapter_rank": 16}] and want[5]
        assert want[4] == {"adapter_sessions": 1, "adapter_swaps_total": 3, "adapter_rank": 16}
        assert want[2][5] == (want[2][1][0], None)  # the refused body applied nothing
        assert want[2][9] == ("a watercolor fox", "r16")
    else:
        assert statuses == [400, 400, 400, 400, 400] and "ADAPTER_DIR" in want[2][0]["body"]
        assert want[3] == [] and want[4] == {} and not want[5]
    assert len(port[6]) == len(want[6]) == 5
    for a, b in zip(port[6], want[6]):
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


def test_controlnet_and_annotator_serve_an_offer_as_the_jax_agent(monkeypatch):
    """``--controlnet tiny-cnet --annotator hed`` on each agent's command line
    reaches the served config of the pipeline and the batch scheduler (no
    silent flag drop); the JAX ControlNet's zero convs non-zero from a seed
    (zero, the ControlNet is a no-op), its weights and the session's state
    carried across; one /offer session on each agent, the same frames
    pushed into both: the answers' forms agree, /migrate/export's row
    carries the conditioning ring within 1e-4 of the JAX row, and every
    viewed frame is within 1 level of the JAX agent's."""
    from ai_rtc_agent_tpu.models import controlnet as JCN

    for name, value in (("WEBRTC_PROVIDER", "loopback"), ("SUPERVISOR", "0"),
                        ("WARMUP_FRAMES", "0"), ("BATCHSCHED_MAX_SESSIONS", "1"),
                        ("OVERLOAD_LOOP_LAG_BUDGET_MS", "100000")):
        monkeypatch.setenv(name, value)
    init = JCN.init_controlnet

    def woken(*a, **kw):
        p = init(*a, **kw)
        rng = np.random.default_rng(0)
        for zc in p["zero_convs"] + [p["mid_zero_conv"], p["cond_embedding"]["conv_out"]]:
            zc["kernel"] = jax.numpy.asarray(0.3 * rng.standard_normal(zc["kernel"].shape),
                                             jax.numpy.float32)
        return p

    monkeypatch.setattr(JCN, "init_controlnet", woken)
    built = {}
    for name, m, extra in (("jax", JA, []), ("port", PA, ["--device", "cpu"])):
        monkeypatch.setattr(m.web, "run_app", lambda app, name=name, **kw: built.update({name: app}))
        m.main(["--model-id", "tiny-test", "--controlnet", "tiny-cnet", "--annotator", "hed"]
               + extra)
    assert built["jax"]["controlnet"] == built["port"]["controlnet"] == "tiny-cnet"
    assert built["jax"]["annotator"] == built["port"]["annotator"] == "hed"
    frames = _frames(6, seed=50)
    got = {}

    async def serve(name, hook):
        app = built[name]
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            m = SIDES[name]
            r = await client.post("/offer", json={
                "room_id": "r", "offer": {"sdp": m.signaling.make_loopback_offer(),
                                          "type": "offer"}})
            body = await r.json()
            cfg = app["pipeline"].config
            assert (cfg.use_controlnet, cfg.annotator) == (True, "hed")
            assert app["batch_scheduler"].cfg.annotator == "hed"
            hook(app)
            pc = next(iter(app["pcs"]))
            for i, f in enumerate(frames):
                vf = m.frames.VideoFrame.from_ndarray(f)
                vf.pts, vf.time_base = i, Fraction(1, 30)
                await pc.in_track.push(vf)
            seen = [(await asyncio.wait_for(pc.out_tracks[0].recv(), 120)).to_ndarray()
                    for _ in range(len(frames) - 2)]  # the track keeps 2 in flight
            export = await (await client.get(
                f"/migrate/export?session={r.headers['X-Stream-Id']}")).json()
            row = JC.deserialize_pytree(base64.b64decode(export["state_b64"]))
            return (r.status, sorted(body), body["type"], export["fingerprint"], seen,
                    np.asarray(row["cnet_cond"], np.float32))
        finally:
            await client.close()

    def keep(app):
        got["params"] = jax.tree.map(np.asarray, app["pipeline"].engine.params)
        got["states"] = jax.tree.map(np.asarray, app["batch_scheduler"].states)

    want = asyncio.run(serve("jax", keep))
    assert sorted(got["params"]) == ["clip", "controlnet", "hed", "taesd", "unet"]
    params = bridge.params_from_jax(got["params"])
    monkeypatch.setattr(PREG, "init_params", lambda fam, seed=0, device="cpu": params)
    port = asyncio.run(serve("port", lambda app: bridge.states_from_jax(
        got["states"], app["batch_scheduler"].states)))
    assert port[:4] == want[:4] and want[0] == 200
    np.testing.assert_allclose(port[5], want[5], rtol=1e-4, atol=1e-4)
    assert want[5].max() > 0
    assert len(port[4]) == len(want[4]) == 4
    for a, b in zip(port[4], want[4]):
        assert np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("argv", [["--annotator", "hed"],
                                  ["--controlnet", "tiny-cnet", "--unet-cache", "3"]],
                         ids=["annotator_alone", "controlnet_with_unet_cache"])
def test_controlnet_refusals_match_the_jax_agent(monkeypatch, argv):
    """``--annotator`` without ``--controlnet``, and ``--controlnet`` with
    ``--unet-cache``: both agents parse the line and refuse at startup with
    the same ValueError, before any model is built."""
    monkeypatch.setenv("WEBRTC_PROVIDER", "loopback")
    built, errors = {}, {}
    for name, m, extra in (("jax", JA, []), ("port", PA, ["--device", "cpu"])):
        monkeypatch.setattr(m.web, "run_app", lambda app, name=name, **kw: built.update({name: app}))
        m.main(["--model-id", "tiny-test"] + argv + extra)

        async def start(app):
            with pytest.raises(ValueError) as e:
                await TestServer(app).start_server()
            return str(e.value)

        errors[name] = asyncio.run(start(built[name]))
        assert built[name].get("pipeline") is None
    assert errors["port"] == errors["jax"]
    assert "--annotator requires --controlnet" in errors["jax"] or \
        "UNET_CACHE is incompatible with ControlNet" in errors["jax"]


@pytest.mark.parametrize("plane", ["batch_scheduler", "shared_pipeline", "multipeer"])
def test_config_t_index_of_the_wrong_length_answers_the_jax_400(monkeypatch, plane):
    """A /config whose ``t_index_list`` has 3 entries where the tiny-test
    stream has 4 stages, on each agent with the real tiny-test pipeline:
    under the batch scheduler (the default), under ``BATCHSCHED=0`` (the
    engine answers) and under ``--multipeer 2`` with one peer connected.  The
    transcript compared whole: status, content type, CORS and the body's text
    (each plane's JAX wording)."""
    for name, value in (("WEBRTC_PROVIDER", "loopback"), ("BATCHSCHED_PREWARM", "0"),
                        ("BATCHSCHED_MAX_SESSIONS", "1"),
                        ("OVERLOAD_LOOP_LAG_BUDGET_MS", "100000")):
        monkeypatch.setenv(name, value)
    if plane == "shared_pipeline":
        monkeypatch.setenv("BATCHSCHED", "0")

    async def drive(name):
        m = SIDES[name]
        kw = {"device": "cpu"} if name == "port" else {}
        app = m.agent.build_app(model_id="tiny-test", provider=m.signaling.LoopbackProvider(),
                                multipeer=2 if plane == "multipeer" else 0, **kw)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            out = []
            if plane == "multipeer":
                r = await client.post("/offer", json={
                    "room_id": "r", "offer": {"sdp": m.signaling.make_loopback_offer(),
                                              "type": "offer"}})
                out.append(r.status)
            out.append(await _obs(await client.post("/config",
                                                    json={"t_index_list": [10, 20, 30]})))
            return out
        finally:
            await client.close()

    got = {name: asyncio.run(drive(name)) for name in SIDES}
    assert got["port"] == got["jax"]
    want = "t_index_list length must stay 4 (compiled batch size)"
    if plane == "shared_pipeline":
        want += "; rebuild the engine to change depth"
    assert got["jax"][-1]["status"] == 400 and got["jax"][-1]["body"] == want
    assert got["jax"][0] == 200 or plane != "multipeer"
