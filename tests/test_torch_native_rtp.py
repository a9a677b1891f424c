"""The port's agent over its native WebRTC tier (server/rtc_native.py,
server/sdp.py, media/) against the JAX agent, on the CPU.

* The slice as a whole: the tiny-test turbo pipeline (JAX: Pallas attention
  in interpret mode; the port on the CPU with the JAX weights and prepared
  state carried across by ``bridge``) served by each agent with
  ``NativeRtpProvider`` and NullCodec, over real loopback UDP through a
  JSON-envelope /offer and through /whip + /whep: the frames that come back
  for the same pushed frames, matched by pts, are at most 1 uint8 level
  apart (the rounding-tie class of tests/test_torch_stream.py).
* Interop: the JAX ``NativeRtpClient`` against the port's agent and the
  port's client against the JAX agent, each frame back bit for bit.
* SDP: the answers to tests/fixtures/sdp/ offers equal the JAX agent's,
  with ports, ICE credentials, fingerprints and session ids masked; the
  videoless WHIP 400; a seeded fuzz of offers gets the JAX statuses and
  never a 500, and leaks no peer connection.
* ``/config {"encoder": ...}`` is accepted, refused and applied as the JAX
  agent does it; ``/metrics`` ``host_plane_sessions`` and ``/health``'s
  per-session ``netadapt`` carry the JAX keys (supervision, overload
  control and the engine guard on, as both agents default).
"""

import asyncio
import importlib
import json
import re
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.media.rtp_client import NativeRtpClient as JClient
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.server import agent as JA
from ai_rtc_agent_tpu.server import rtc_native as JRN
from ai_rtc_agent_tpu.server import signaling as JS
from ai_rtc_agent_tpu.stream.pipeline import StreamDiffusionPipeline as JPipeline
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.media.rtp_client import NativeRtpClient as PClient
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.server import agent as PA
from ai_rtc_agent_tpu_torch.server import rtc_native as PRN
from ai_rtc_agent_tpu_torch.server import signaling as PS
from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline as PPipeline

SIDES = {
    "jax": SimpleNamespace(agent=JA, rtc=JRN, client=JClient, signaling=JS),
    "port": SimpleNamespace(agent=PA, rtc=PRN, client=PClient, signaling=PS),
}
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "sdp"
SDP = {"Content-Type": "application/sdp"}
UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
TURBO = dict(t_index_list=(0,), num_inference_steps=1, timestep_spacing="trailing",
             scheduler="turbo", cfg_type="none")
SIZE = 64


@pytest.fixture(autouse=True)
def env(monkeypatch):
    monkeypatch.setenv("SUPERVISOR", "0")
    monkeypatch.setenv("WARMUP_FRAMES", "0")
    for name in ("HW_ENCODE", "NVENC", "PIPELINE_DEPTH", "DROP_FRAMES", "WEBRTC_PROVIDER"):
        monkeypatch.delenv(name, raising=False)


def jax_defaults(monkeypatch):
    """Supervision, overload control and the engine guard on (each agent's
    default); the loop-lag budget out of reach of a busy test box."""
    for name in ("SUPERVISOR", "OVERLOAD_CONTROL", "ENGINE_GUARD"):
        monkeypatch.setenv(name, "1")
    monkeypatch.setenv("OVERLOAD_LOOP_LAG_BUDGET_MS", "100000")


class Invert:
    def __call__(self, frame):
        arr = frame if isinstance(frame, np.ndarray) else frame.to_ndarray()
        return 255 - arr

    def update_prompt(self, p):
        pass

    def update_t_index_list(self, t):
        pass


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8) for _ in range(n)]


async def _start(side, pipeline, provider=None):
    m = SIDES[side]
    app = m.agent.build_app(pipeline=pipeline,
                            provider=provider or m.rtc.NativeRtpProvider(use_h264=False))
    client = TestClient(TestServer(app))
    await client.start_server()
    return app, client


def _pull(c, got: dict):
    """Decode what the client's socket queued: {pts: frame}."""
    while (entry := c._recv_q.pop()) is not None:
        c.back.feed_packet(entry[0])
        while (item := c.back.poll()) is not None:
            got[item[1]] = item[0].copy()


async def _open_session(client_mod, http, how: str):
    """A publishing client and the client that views the processed stream
    (the same one over /offer), connected."""
    pub = await client_mod(SIZE, SIZE, use_h264=False).open()
    if how == "offer":
        r = await http.post("/offer", json={"room_id": "r",
                                            "offer": {"sdp": pub.offer_envelope(), "type": "offer"}})
        assert r.status == 200, await r.text()
        port = json.loads((await r.json())["sdp"])["server_port"]
        view = pub
    else:
        r = await http.post("/whip", data=pub.offer_envelope(), headers=SDP)
        assert r.status == 201, await r.text()
        port = json.loads(await r.text())["server_port"]
        view = await client_mod(SIZE, SIZE, use_h264=False).open()
        envelope = {"native_rtp": True, "video": False, "width": SIZE, "height": SIZE,
                    "client_addr": ["127.0.0.1", view.port]}
        r = await http.post("/whep", data=json.dumps(envelope), headers=SDP)
        assert r.status == 201, await r.text()
    await pub.connect(port)
    return pub, view


async def _exchange(pub, view, frames, timeout_s=60.0) -> dict:
    """Send frame i once frame i - 2 is back (the track keeps 2 in flight),
    then one more behind the last; -> {pts: frame} of what came back."""
    got = {}
    step = 90_000 // pub.fps
    for i, f in enumerate(frames + frames[-1:]):
        if i >= 2:
            t = time.monotonic()
            while (i - 2) * step not in got:
                assert time.monotonic() - t < timeout_s, f"frame {i - 2} never came back"
                await asyncio.sleep(0.005)
                _pull(view, got)
        pub.send(f, i)
    t = time.monotonic()
    while (len(frames) - 1) * step not in got and time.monotonic() - t < timeout_s:
        await asyncio.sleep(0.005)
        _pull(view, got)
    return got


async def _serve(side, pipeline, how, frames, client_side=None):
    """``frames`` through ``side``'s agent over the native tier, pushed by
    ``client_side``'s NativeRtpClient (the agent's own by default)."""
    app, http = await _start(side, pipeline)
    pub = view = None
    try:
        pub, view = await _open_session(SIDES[client_side or side].client, http, how)
        got = await _exchange(pub, view, frames)
        assert len(app["pcs"]) == (1 if how == "offer" else 2)
        return got
    finally:
        for c in {id(x): x for x in (pub, view) if x is not None}.values():
            c.close()
        await http.close()


# -- the slice as a whole ------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pipe():
    cfg = JREG.default_stream_config("tiny-test", attn_impl="pallas", use_fused_epilogue=False,
                                     **TURBO)
    pipe = JPipeline("tiny-test", config=cfg)
    pipe(np.zeros((SIZE, SIZE, 3), np.uint8))  # compile before serving; turbo/none keeps no ring
    pipe.state0 = jax.tree.map(np.asarray, pipe.engine.state)
    return pipe


@pytest.fixture(scope="module")
def port_pipe(jax_pipe):
    cfg = PREG.default_stream_config("tiny-test", device="cpu", **TURBO)
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jax_pipe.engine.params))
    return PPipeline("tiny-test", config=cfg, device="cpu", params=params, prompt=jax_pipe.prompt)


@pytest.mark.parametrize("how", ["offer", "whip"], ids=["offer", "whip+whep"])
def test_served_frames_match_the_jax_agent(jax_pipe, port_pipe, how):
    frames = _frames(5, seed=21)
    want = asyncio.run(_serve("jax", jax_pipe, how, frames))
    port_pipe.engine.state = bridge.state_from_jax(jax_pipe.state0)
    got = asyncio.run(_serve("port", port_pipe, how, frames))
    step = 90_000 // 30
    pts = [i * step for i in range(len(frames))]
    assert set(pts) <= set(got) and set(pts) <= set(want)
    for p in pts:
        diff = np.abs(got[p].astype(np.int16) - want[p].astype(np.int16))
        assert got[p].shape == (SIZE, SIZE, 3) and diff.max() <= 1, (p, diff.max())
    # the port's served frames are its own direct calls, bit for bit
    port_pipe.engine.state = bridge.state_from_jax(jax_pipe.state0)
    for p, f in zip(pts, frames):
        assert np.array_equal(got[p], np.asarray(port_pipe(f)))


@pytest.mark.parametrize("how", ["offer", "whip"], ids=["offer", "whip+whep"])
@pytest.mark.parametrize("agent,client", [("port", "jax"), ("jax", "port")],
                         ids=["jax client, port agent", "port client, jax agent"])
def test_clients_and_agents_interoperate(agent, client, how):
    frames = _frames(6, seed=22)
    got = asyncio.run(_serve(agent, Invert(), how, frames, client_side=client))
    for i, f in enumerate(frames):
        assert np.array_equal(got[i * 3000], 255 - f), i


class TracedInvert(Invert):
    """Inverts colours and carries the source frame's pts and trace to the
    output (the pipelines' output contract), so the sender pump seals it."""

    def __init__(self, frames_mod):
        self.frames_mod = frames_mod

    def __call__(self, frame):
        return self.frames_mod.wrap_processed(super().__call__(frame), frame)


@pytest.mark.parametrize("how", ["offer", "whip"], ids=["offer", "whip+whep"])
def test_native_tier_frame_traces_match_the_jax_agent(monkeypatch, how):
    """TRACE_ENABLE=1: each frame's timeline on the native tier, minted at
    decode (its id the RTP pts) and sealed ``sent`` by the sender pump, with
    the decode, ingest, encode, packetize and send spans, as the JAX agent
    records it (clock readings left out).  The JAX agent's WHEP viewer takes
    its dedicated per-viewer chain (BROADCAST_FANOUT=0), the one the port
    has until its broadcast plane."""
    monkeypatch.setenv("TRACE_ENABLE", "1")
    monkeypatch.setenv("BROADCAST_FANOUT", "0")
    frames = _frames(5, seed=23)

    async def run(side):
        mod = SIDES[side].agent.__name__.rsplit(".", 2)[0]
        frames_mod = importlib.import_module(f"{mod}.media.frames")
        app, http = await _start(side, TracedInvert(frames_mod))
        pub = view = None
        try:
            pub, view = await _open_session(SIDES[side].client, http, how)
            got = await _exchange(pub, view, frames)
            flight = app["flight"]
            for _ in range(200):  # the last frame's pump seals it after its send
                if sum(r.tracer.frames_completed for r in flight.sessions.values()) >= len(frames):
                    break
                await asyncio.sleep(0.01)
            (key,) = [k for k, r in flight.sessions.items() if r.tracer.frames_completed]
            r = await http.get("/debug/flight", params={"session": key})
            capture = await r.json()
            return [sorted(got)[:len(frames)],
                    [[f["frame_id"], f["terminal"], [s[0] for s in f["spans"]],
                      [m[0] for m in f["marks"]]] for f in capture["frames"]][:len(frames)]]
        finally:
            for c in {id(x): x for x in (pub, view) if x is not None}.values():
                c.close()
            await http.close()

    got = {side: asyncio.run(run(side)) for side in SIDES}
    assert got["port"] == got["jax"]
    spans = got["port"][1][0][2]
    assert spans == ["decode", "ingest", "encode", "packetize", "send"], spans
    assert all(f[1] == "sent" for f in got["port"][1])


# -- SDP -------------------------------------------------------------------------------

MASKS = [
    (re.compile(r"^(m=\w+) \d+", re.M), r"\1 <port>"),
    (re.compile(r"(\d+\.\d+\.\d+\.\d+) \d+ typ host"), r"\1 <port> typ host"),
    (re.compile(r"^a=ice-ufrag:\S+", re.M), "a=ice-ufrag:<ufrag>"),
    (re.compile(r"^a=ice-pwd:\S+", re.M), "a=ice-pwd:<pwd>"),
    (re.compile(r"^a=fingerprint:(\S+) \S+", re.M), r"a=fingerprint:\1 <fingerprint>"),
    (UUID, "<id>"),
    (re.compile(r'"server_port": \d+'), '"server_port": <port>'),
]


def _mask(text: str) -> str:
    for pat, rep in MASKS:
        text = pat.sub(rep, text)
    return text


async def _answer(http, path, body):
    r = await http.post(path, data=body, headers=SDP)
    return r.status, r.content_type, UUID.sub("<id>", r.headers.get("Location", "")), \
        _mask(await r.text())


async def case_fixture_answers(http, app):
    out = [await _answer(http, "/whip", (FIXTURES / name).read_text())
           for name in ("browser_whip_offer.sdp", "obs_whip_offer.sdp")]
    out.append(await _answer(http, "/whip", '{"native_rtp": true, "video": true}'))
    out.append(await _answer(http, "/whep", (FIXTURES / "plainrtp_whep_offer.sdp").read_text()))
    (viewer,) = [pc for pc in app["state"]["whep_pcs"].values()]
    out.append((viewer._client_addr, viewer._h264_pt))
    sha384 = (FIXTURES / "browser_whip_offer.sdp").read_text().replace(
        "a=fingerprint:sha-256", "a=fingerprint:sha-384")
    out.append(await _answer(http, "/whip", sha384))
    return out


VIDEOLESS = ("v=0\r\no=- 1 1 IN IP4 0.0.0.0\r\ns=-\r\nt=0 0\r\n"
             "m=audio 5004 RTP/AVP 111\r\na=rtpmap:111 opus/48000/2\r\n")


async def case_videoless_whip(http, app):
    out = [await _answer(http, "/whip", VIDEOLESS) for _ in range(2)]
    r = await http.post("/offer", json={"room_id": "x", "offer": {"sdp": VIDEOLESS, "type": "offer"}})
    out.append((r.status, await r.text()))
    out.append((len(app["pcs"]), len(app["state"]["whip_pcs"])))
    return out


def _fuzz_bodies(seed, n=24):
    """Offers cut, spliced and corrupted from the fixtures, from a seed."""
    rng = np.random.default_rng(seed)
    sources = [(FIXTURES / f).read_text() for f in sorted(p.name for p in FIXTURES.iterdir())]
    bodies = [b"", b"v=0", b"\xff\xfe\x00binary\x9c", b"m=video 1 RTP/AVP",
              b'{"native_rtp": false}', b'{"native_rtp": true, "client_addr": ["x"]}']
    for _ in range(n):
        lines = sources[rng.integers(len(sources))].splitlines()
        kind = rng.integers(4)
        if kind == 0:  # drop lines
            lines = [ln for ln in lines if rng.random() > 0.3]
        elif kind == 1:  # truncate one line
            i = rng.integers(len(lines))
            lines[i] = lines[i][: rng.integers(len(lines[i]) + 1)]
        elif kind == 2:  # shuffle
            lines = [lines[i] for i in rng.permutation(len(lines))]
        else:  # corrupt bytes
            text = bytearray("\r\n".join(lines).encode())
            for i in rng.integers(0, len(text), 6):
                text[i] = int(rng.integers(0, 256))
            bodies.append(bytes(text))
            continue
        bodies.append("\r\n".join(lines).encode())
    return bodies


async def case_fuzz(http, app):
    r = await http.post("/whip", data='{"native_rtp": true, "video": true}', headers=SDP)
    assert r.status == 201
    out = []
    for path in ("/whip", "/whep"):
        for body in _fuzz_bodies(seed=5):
            r = await http.post(path, data=body, headers=SDP)
            assert r.status != 500, (path, body[:60])
            out.append(r.status)
            if r.status == 201:
                await http.delete(r.headers["Location"])
    await asyncio.sleep(0)
    out.append(len(app["pcs"]))
    return out


@pytest.mark.parametrize("case", [case_fixture_answers, case_videoless_whip, case_fuzz],
                         ids=["fixture answers", "videoless whip", "fuzz"])
def test_sdp_answers_match_the_jax_agent(case):
    async def run(side):
        app, http = await _start(side, Invert())
        try:
            return await case(http, app)
        finally:
            await http.close()

    got, want = asyncio.run(run("port")), asyncio.run(run("jax"))
    assert got == want


# -- /config, /metrics, /health --------------------------------------------------------

def _session_pc(app):
    (pc,) = [pc for pc in app["pcs"] if getattr(pc, "_sink", None) is not None]
    return pc


ENCODER_CONFIGS = [
    {"encoder": {"bitrate": 800_000, "gop": 30}},
    {"encoder": {"fps": 15, "scale": 2}},
    {"encoder": {"bitrate": 0}},
    {"encoder": {"nope": 1}},
    {"encoder": {"fps": True}},
    {"encoder": {}},
    {"encoder": "fast"},
    {"encoder": {"bitrate": 1_000_000}, "t_index_list": [1, 2]},
    {"encoder": {"bitrate": 1_200_000}, "prompt": "a lighthouse"},
]


def _keys(d: dict) -> list:
    return sorted(d)


async def case_operator_surface(http, app, side):
    pub = await SIDES[side].client(SIZE, SIZE, use_h264=False).open()
    try:
        r = await http.post("/offer", json={"room_id": "r",
                                            "offer": {"sdp": pub.offer_envelope(), "type": "offer"}})
        assert r.status == 200
        await pub.connect(json.loads((await r.json())["sdp"])["server_port"])
        got = await _exchange(pub, pub, _frames(4, seed=23))
        pc = _session_pc(app)
        out = [[p for p in sorted(got) if p < 4 * 3000]]
        for cfg in ENCODER_CONFIGS:
            r = await http.post("/config", json=cfg)
            out.append((r.status, await r.text(), dict(pc._sink.profile),
                        pc.netadapt.base_bitrate, pc.netadapt.profile()))
        metrics = await (await http.get("/metrics")).json()
        (plane,) = metrics["host_plane_sessions"].values()
        out.append((_keys(plane), sorted(k for k in metrics if k.startswith(("rtcp", "decode",
                                                                                 "encode", "glass",
                                                                                 "netadapt")))))
        health = await (await http.get("/health")).json()
        (session,) = health["sessions"].values()
        out.append((_keys(session["netadapt"]), session["netadapt"]["rung"]))
        return out
    finally:
        pub.close()


def test_operator_surface_matches_the_jax_agent(monkeypatch):
    jax_defaults(monkeypatch)

    async def run(side):
        app, http = await _start(side, Invert())
        try:
            return await case_operator_surface(http, app, side)
        finally:
            await http.close()

    got, want = asyncio.run(run("port")), asyncio.run(run("jax"))
    assert got == want
    assert got[1][0] == 200 and got[3][0] == 400


@pytest.mark.parametrize("side", ["port", "jax"])
def test_encoder_config_is_refused_without_the_native_tier(side):
    async def run():
        app, http = await _start(side, Invert(), provider=SIDES[side].signaling.LoopbackProvider())
        try:
            r = await http.post("/config", json={"encoder": {"bitrate": 800_000}})
            return r.status, await r.text()
        finally:
            await http.close()

    assert asyncio.run(run()) == (400, "encoder reconfigure not supported by this provider")
