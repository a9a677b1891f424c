"""Cross-session batching in the port (stream/scheduler.py, parallel/
multipeer.py, server/multipeer_serving.py) against the JAX package, on the
CPU.

* The agent as a whole: two concurrent loopback /offer sessions on the
  port's agent and on the JAX agent (tiny-test, the default path: the
  batch scheduler; ``SUPERVISOR=0``, the same env), the JAX weights and the
  JAX scheduler's session states carried across by ``bridge``, different
  frames into each session and then a datachannel prompt on one.  Each
  session's frames stay within 1 uint8 level of the JAX agent's (the
  rounding-tie class of tests/test_torch_stream.py).  On a port that
  serves every connection through one pipeline the two sessions share one
  ring and one prompt, and this fails.
* The scheduler against dedicated engines (the same state row and frames),
  every frame within 1 level, across join, leave, buckets 1/2/4 with
  padding, per-session prompt / t-index / guidance updates, a similarity
  skip and restart; once against the JAX ``BatchScheduler`` itself.
* Capacity: the (max+1)th claim raises ``CapacityError`` (503 with
  Retry-After at the agent), a DELETE gives the slot back, ``POST /config``
  reaches every session; a window sheds its oldest frame as passthrough; a
  step whose riders left, or whose readback failed, stops holding back the
  dispatcher.
* Style adapters: the scheduler's adapter plane (claims, swaps, the
  counters, /health and /metrics fields, the fingerprint, the refusals)
  against the JAX scheduler's, and a swap under DeepCache resetting the
  cadence as the JAX one does.
* ``--multipeer``: the peer engine and pipeline against dedicated engines,
  a peer's queue shedding its oldest frame, and the agent's slot claims,
  503 and per-peer datachannel prompt.

The shapes mirror tests/test_batch_scheduler.py, tests/test_multipeer.py,
tests/test_multipeer_serving.py and tests/batchsched_equiv_driver.py.
"""

import asyncio
import json
import threading
import time
from fractions import Fraction
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.media import frames as JF
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.parallel.multipeer import CapacityError as JCapacityError
from ai_rtc_agent_tpu.resilience.overload import DeadlineQueue as JDeadlineQueue
from ai_rtc_agent_tpu.server import agent as JA
from ai_rtc_agent_tpu.server import signaling as JS
from ai_rtc_agent_tpu.stream.scheduler import BatchScheduler as JBatchScheduler
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.media import frames as PF
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.parallel.multipeer import (
    CapacityError,
    MultiPeerEngine,
    bucket_for,
    bucket_sizes,
    pad_bucket,
)
from ai_rtc_agent_tpu_torch.resilience.overload import DeadlineQueue as PDeadlineQueue
from ai_rtc_agent_tpu_torch.resilience.overload import ShedFrame
from ai_rtc_agent_tpu_torch.server import agent as PA
from ai_rtc_agent_tpu_torch.server import signaling as PS
from ai_rtc_agent_tpu_torch.server.multipeer_serving import MultiPeerPipeline
from ai_rtc_agent_tpu_torch.stream import engine as PENG
from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

SIDES = {
    "jax": SimpleNamespace(agent=JA, signaling=JS, frames=JF, kw={}, queue=JDeadlineQueue,
                           full=JCapacityError),
    "port": SimpleNamespace(agent=PA, signaling=PS, frames=PF, kw={"device": "cpu"},
                            queue=PDeadlineQueue, full=CapacityError),
}
TURBO8 = dict(t_index_list=(2,), num_inference_steps=8, timestep_spacing="trailing",
              scheduler="turbo", cfg_type="none")


@pytest.fixture(autouse=True)
def agent_env(monkeypatch):
    monkeypatch.setenv("SUPERVISOR", "0")
    monkeypatch.setenv("WARMUP_FRAMES", "0")
    monkeypatch.setenv("BATCHSCHED_MAX_SESSIONS", "2")
    # the JAX agent's startup compiles its buckets on the loop: keep its
    # loop-lag admission gate from refusing the offers that follow
    monkeypatch.setenv("OVERLOAD_LOOP_LAG_BUDGET_MS", "100000")
    for name in ("HW_ENCODE", "NVENC", "PIPELINE_DEPTH", "DROP_FRAMES", "BATCHSCHED",
                 "BATCHSCHED_WINDOW_MS", "BATCHSCHED_PREWARM"):
        monkeypatch.delenv(name, raising=False)


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(n)]


def _close(a, b):
    diff = np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16))
    assert np.asarray(a).shape == np.asarray(b).shape and diff.max() <= 1, diff.max()


def _offer_body(m, room):
    return {"room_id": room, "offer": {"sdp": m.signaling.make_loopback_offer(), "type": "offer"}}


# -- the agent as a whole: two /offer sessions, port vs JAX ----------------------------

N_PUSH, N_BEFORE, N_AFTER = 7, 4, 2  # the track keeps 2 frames in flight
DC_PROMPT = "a watercolor fox"


async def _drain(app):
    """Until every frame submitted so far has left its coalescing window
    (its step is under way): a control write now lands after it."""
    sched = app.get("batch_scheduler")
    while sched is not None and any(q.depth for q in sched._queues):
        await asyncio.sleep(0.005)


async def _two_offer_sessions(m, bridge_hook):
    """Two /offer sessions on ``m``'s agent (tiny-test, built at startup):
    ``bridge_hook(app)`` once both are claimed; session j gets its own
    frames; a datachannel prompt on session 0 after N_BEFORE frames.
    -> the frames each session viewed."""
    app = m.agent.build_app(model_id="tiny-test", provider=m.signaling.LoopbackProvider(), **m.kw)
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        pcs = []
        for room in ("room-a", "room-b"):
            r = await client.post("/offer", json=_offer_body(m, room))
            assert r.status == 200, await r.text()
            pcs += [pc for pc in app["pcs"] if pc not in pcs]
        bridge_hook(app)
        for j, pc in enumerate(pcs):
            for i, f in enumerate(_frames(N_PUSH, seed=10 + j)):
                vf = m.frames.VideoFrame.from_ndarray(f)
                vf.pts, vf.time_base = i, Fraction(1, 30)
                await pc.in_track.push(vf)

        async def view(pc, n):
            return [(await asyncio.wait_for(pc.out_tracks[0].recv(), 120)).to_ndarray()
                    for _ in range(n)]

        seen = await asyncio.gather(*(view(pc, N_BEFORE) for pc in pcs))
        await _drain(app)
        await pcs[0].datachannel.deliver(json.dumps({"prompt": DC_PROMPT}))
        more = await asyncio.gather(*(view(pc, N_AFTER) for pc in pcs))
        return [a + b for a, b in zip(seen, more)]
    finally:
        await client.close()


def test_two_offer_sessions_match_the_jax_agent(monkeypatch):
    _two_sessions_match_the_jax_agent(monkeypatch, _two_offer_sessions)


def test_two_offer_sessions_match_the_jax_agent_under_the_jax_defaults(monkeypatch):
    """The same with supervision, overload control and the engine guard on
    (each agent's default): every session rides a ResilientPipeline and
    every bucket step the guard's runner, to its completion."""
    for name in ("SUPERVISOR", "OVERLOAD_CONTROL", "ENGINE_GUARD"):
        monkeypatch.setenv(name, "1")
    _two_sessions_match_the_jax_agent(monkeypatch, _two_offer_sessions)


async def _two_whip_sessions(m, bridge_hook):
    """Two /whip publishers on ``m``'s agent at ``--fbs 2``; session j gets
    its own frames, its processed track is read directly (two frames per
    step, 2 steps in flight); a datachannel prompt on session 0 after
    N_BEFORE frames.  -> the frames each session's track gave."""
    app = m.agent.build_app(model_id="tiny-test", provider=m.signaling.LoopbackProvider(), fbs=2,
                            **m.kw)
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        sids = []
        for _ in range(2):
            r = await client.post("/whip", data=m.signaling.make_loopback_offer(),
                                  headers={"Content-Type": "application/sdp"})
            assert r.status == 201, await r.text()
            sids.append(r.headers["Location"].rsplit("/", 1)[1])
        state = app["state"]
        pcs = [state["whip_pcs"][sid] for sid in sids]
        tracks = [state["whip_tracks"][sid] for sid in sids]
        bridge_hook(app)
        n_push = N_BEFORE + N_AFTER + 2  # one group of 2 behind the last viewed
        for j, pc in enumerate(pcs):
            for i, f in enumerate(_frames(n_push, seed=40 + j)):
                vf = m.frames.VideoFrame.from_ndarray(f)
                vf.pts, vf.time_base = i, Fraction(1, 30)
                await pc.in_track.push(vf)

        async def view(track, n):
            return [(await asyncio.wait_for(track.recv(), 120)).to_ndarray() for _ in range(n)]

        seen = await asyncio.gather(*(view(t, N_BEFORE) for t in tracks))
        await _drain(app)
        await pcs[0].datachannel.deliver(json.dumps({"prompt": DC_PROMPT}))
        more = await asyncio.gather(*(view(t, N_AFTER) for t in tracks))
        return [a + b for a, b in zip(seen, more)]
    finally:
        await client.close()


def test_two_whip_sessions_at_fbs2_match_the_jax_agent(monkeypatch):
    """``--fbs 2``: each /whip publisher claims its own scheduler session,
    whose two consecutive frames ride one bucket step as one row of its
    slot; a datachannel prompt on one session moves only its own frames.
    Both within 1 level of the JAX agent.  A port that serves ``--fbs`` > 1
    through one shared pipeline (two sessions in one ring, one prompt for
    both) fails this."""
    _two_sessions_match_the_jax_agent(monkeypatch, _two_whip_sessions)


def _two_sessions_match_the_jax_agent(monkeypatch, drive):
    got = {}

    def keep_jax(app):
        got["params"] = jax.tree.map(np.asarray, app["pipeline"].engine.params)
        got["states"] = jax.tree.map(np.asarray, app["batch_scheduler"].states)

    want = asyncio.run(drive(SIDES["jax"], keep_jax))
    params = bridge.params_from_jax(got["params"])
    monkeypatch.setattr(PREG, "init_params", lambda fam, seed=0, device="cpu": params)

    def carry(app):
        sched = app.get("batch_scheduler")
        if sched is None:  # one pipeline for every session: carry session 0's state
            row = jax.tree.map(lambda a: a[0], got["states"])
            app["pipeline"].engine.state = bridge.state_from_jax(row)
        else:
            bridge.states_from_jax(got["states"], sched.states)

    port = asyncio.run(drive(SIDES["port"], carry))
    assert [len(v) for v in port] == [len(v) for v in want] == [N_BEFORE + N_AFTER] * 2
    for j in range(2):
        for i, (a, b) in enumerate(zip(port[j], want[j])):
            assert a.shape == b.shape == (64, 64, 3), (j, i)
            diff = np.abs(a.astype(np.int16) - b.astype(np.int16)).max()
            assert diff <= 1, f"session {j} frame {i}: {diff} levels from the JAX agent"


# -- the scheduler against dedicated engines -------------------------------------------

@pytest.fixture(scope="module")
def port_bundle():
    return PREG.load_model_bundle("tiny-test", device="cpu")


def _dedicated(bundle, cfg, prompt, seed):
    return PENG.StreamEngine(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt,
                             device="cpu").prepare(prompt, seed=seed)


CONFIGS = {
    # 8 sub-timesteps with one stage, so that a t-index update is a real change
    "turbo": dict(TURBO8, similar_image_filter=True, similar_image_threshold=1.0),
    # the tiny default: the 4-stage LCM ring, cfg self (renoise within a session)
    "lcm_self": dict(similar_image_filter=True, similar_image_threshold=1.0),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_scheduler_matches_dedicated_engines(port_bundle, config):
    """The JAX equivalence driver's dense drive: k=2, a join into the padded
    bucket of 4, per-session prompt / guidance / t-index updates, a leave,
    the solo path, a rejoin on the freed slot, restart, similarity skips —
    every frame within 1 level of a dedicated engine."""
    b = port_bundle
    cfg = PREG.default_stream_config("tiny-test", device="cpu", **CONFIGS[config])
    # a window long enough that each round goes as one batch (submits come
    # from one thread), short enough for a similarity skip, which leaves the
    # other session alone in it
    sched = BatchScheduler(b.stream_models, b.params, cfg, b.encode_prompt, max_sessions=4,
                           window_ms=200.0, device="cpu")
    rng = np.random.default_rng(0)
    compared = [0]

    def frames(n):
        return [rng.integers(0, 256, (64, 64, 3), np.uint8) for _ in range(n)]

    def step(sessions, engines, fs=None):
        fs = fs or frames(len(sessions))
        handles = [s.submit(f) for s, f in zip(sessions, fs)]
        for s, h, eng, f in zip(sessions, handles, engines, fs):
            _close(s.fetch(h), eng(f))
            compared[0] += 1

    try:
        s1 = sched.claim("a", prompt="a red cat", seed=11)
        s2 = sched.claim("b", prompt="a blue dog", seed=22)
        e1, e2 = (_dedicated(b, cfg, p, sd) for p, sd in (("a red cat", 11), ("a blue dog", 22)))
        for _ in range(3):
            step([s1, s2], [e1, e2])
        s3 = sched.claim("c", prompt="green hills", seed=33)  # join: 3 rows, the bucket of 4
        e3 = _dedicated(b, cfg, "green hills", 33)
        for _ in range(2):
            step([s1, s2, s3], [e1, e2, e3])
        t_index = [5] if config == "turbo" else [10, 20, 30, 40]
        s2.update_prompt("a completely different prompt")
        e2.update_prompt("a completely different prompt")
        s3.update_guidance(guidance_scale=1.7, delta=0.8)
        e3.update_guidance(1.7, 0.8)
        s1.update_t_index_list(t_index)
        e1.update_t_index_list(t_index)
        for _ in range(2):
            step([s1, s2, s3], [e1, e2, e3])
        s2.release()  # leave: the survivors go on
        for _ in range(2):
            step([s1, s3], [e1, e3])
        s3.release()  # down to one: the solo path
        for _ in range(3):
            f = frames(1)[0]
            _close(s1(f), e1(f))
            compared[0] += 1
        s2b = sched.claim("d", prompt="a blue dog", seed=22)  # the freed slot, a fresh state
        assert s2b.slot == s2.slot
        e2 = _dedicated(b, cfg, "a blue dog", 22)
        step([s1, s2b], [e1, e2])
        s1.restart()  # the live control plane (t-indices included), a fresh state
        e1 = _dedicated(b, cfg, "a red cat", 11)
        e1.update_t_index_list(t_index)
        step([s1, s2b], [e1, e2])
        # similarity skips: per-session filters in lockstep with the engines'
        for s, e in ((s1, e1), (s2b, e2)):
            s._sim = PENG.SimilarityFilter(0.9, 3, seed=0)
            e._sim_filter = PENG.SimilarityFilter(0.9, 3, seed=0)
        still = frames(1)[0]
        for _ in range(6):
            step([s1, s2b], [e1, e2], [still, frames(1)[0]])
        assert s1.frames_skipped_similar > 0 and s2b.frames_skipped_similar == 0
        assert {"1", "2", "3"} <= set(sched.snapshot()["batchsched_occupancy_hist"])
        assert compared[0] >= 40
    finally:
        sched.close()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
@pytest.mark.parametrize("config", ["turbo", "lcm_self"])
def test_session_step_matches_dedicated_engines(port_bundle, config, fused):
    """The bucket step itself over a stacked state, a padded bucket (slots
    [2, 0, 1, 1], 3 real) with per-session prompts, seeds and guidance,
    through the fused epilogue or the composed ops: each real session's
    frame within 1 level of its dedicated engine, over 3 steps (the ring
    and stock carry across)."""
    b = port_bundle
    cfg = PREG.default_stream_config("tiny-test", device="cpu", use_fused_epilogue=fused,
                                     **(TURBO8 if config == "turbo" else {}))
    engines = []
    for i, prompt in enumerate(("a cat", "a dog", "green hills")):
        eng = _dedicated(b, cfg, prompt, i)
        eng.update_guidance(1.2 + 0.1 * i, 1.0 - 0.1 * i)
        engines.append(eng)
    states = PENG.stack_states([e.state for e in engines])
    step = PENG.make_session_step_fn(b.stream_models, cfg)
    slots = [2, 0, 1, 1]
    for j in range(3):
        fr = _frames(3, seed=50 + j)
        out = step(b.params, states, torch.from_numpy(np.stack([fr[s] for s in slots])),
                   torch.tensor(slots, dtype=torch.int32), 3)
        assert out.shape == (4, 64, 64, 3)
        for row, s in enumerate(slots[:3]):
            _close(out[row].numpy(), engines[s](fr[s]))


def test_session_step_has_no_glue_around_the_epilogue(monkeypatch, port_bundle):
    """The bucket step launches nothing between the UNet and the decode but
    the epilogue (views only), as the single-session step."""
    seen, section = set(), [None]

    class OpLog(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if section[0] == "glue":
                seen.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    m = port_bundle.stream_models

    def unet(*a):
        out = m.unet(*a)
        section[0] = "glue"
        return out

    def decode(*a):
        section[0] = None
        return m.vae_decode(*a)

    def epilogue(*a, **k):
        section[0] = None
        out = kernel(*a, **k)
        section[0] = "glue"
        return out

    kernel = PENG.fused_stream_epilogue
    monkeypatch.setattr(PENG, "fused_stream_epilogue", epilogue)
    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    step = PENG.make_session_step_fn(PENG.StreamModels(unet, m.vae_encode, decode), cfg)
    eng = _dedicated(port_bundle, cfg, "a cat", 1)
    states = PENG.stack_states([eng.state] * 3)
    frames = torch.from_numpy(np.stack(_frames(3, seed=1)))
    with OpLog():
        step(port_bundle.params, states, frames, torch.tensor([2, 0, 0], dtype=torch.int32), 2)
    assert seen <= {"slice", "select", "view"}, seen


def test_scheduler_matches_the_jax_batch_scheduler(monkeypatch):
    """Two sessions in the bucket of 2 on the JAX BatchScheduler and on the
    port's, the JAX session states carried by ``states_from_jax``, a prompt
    update on one of them: every frame within 1 level."""
    jb = JREG.load_model_bundle("tiny-test")
    cfg = JREG.default_stream_config("tiny-test")
    js = JBatchScheduler(jb.stream_models, jb.params, cfg, jb.encode_prompt, max_sessions=2,
                         window_ms=10_000.0, prewarm=False, dp=1)
    pb = PREG.load_model_bundle("tiny-test", device="cpu",
                                params=bridge.params_from_jax(jax.tree.map(np.asarray, jb.params)))
    ps = BatchScheduler(pb.stream_models, pb.params, PREG.default_stream_config("tiny-test",
                        device="cpu"), pb.encode_prompt, max_sessions=2, window_ms=10_000.0,
                        device="cpu")
    try:
        jsess = [js.claim(f"j{i}", prompt=p, seed=i) for i, p in enumerate(("a cat", "a dog"))]
        psess = [ps.claim(f"p{i}", prompt=p, seed=i) for i, p in enumerate(("a cat", "a dog"))]
        bridge.states_from_jax(jax.tree.map(np.asarray, js.states), ps.states)
        streams = [_frames(5, seed=30 + i) for i in range(2)]
        for j in range(5):
            if j == 2:
                jsess[1].update_prompt("a watercolor fox")
                psess[1].update_prompt("a watercolor fox")
            got = {}
            for name, sess in (("jax", jsess), ("port", psess)):
                handles = [s.submit(f[j]) for s, f in zip(sess, streams)]
                got[name] = [s.fetch(h) for s, h in zip(sess, handles)]
            for a, b in zip(got["port"], got["jax"]):
                _close(a, b)
        assert js.snapshot()["batchsched_occupancy_hist"] == {"2": 5}
        assert ps.snapshot()["batchsched_occupancy_hist"] == {"2": 5}
    finally:
        js.close()
        ps.close()


ADAPTER_MODULES = ("down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q",
                   "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_v")


@pytest.fixture(scope="module")
def adapter_bundles():
    """A JAX tiny-test bundle, the port's over its weights, and a maker of the
    JAX tests' two-style registry (styleA on one attention linear, styleB on
    two, rank 2: the bucket of 4) on either package from the same groups."""
    from ai_rtc_agent_tpu.adapters import AdapterRegistry as JAdapterRegistry
    from ai_rtc_agent_tpu.models import loader as JLD
    from ai_rtc_agent_tpu_torch.adapters import AdapterRegistry
    from ai_rtc_agent_tpu_torch.models import loader as PLD

    jb = JREG.load_model_bundle("tiny-test")
    pb = PREG.load_model_bundle("tiny-test", device="cpu",
                                params=bridge.params_from_jax(jax.tree.map(np.asarray, jb.params)))

    def registry(side):
        rng = np.random.default_rng(7)
        b, cls, ld = (jb, JAdapterRegistry, JLD) if side == "jax" else (pb, AdapterRegistry, PLD)
        reg = cls(b.params["unet"], ld.unet_key_map(b.unet_cfg))
        for name, mods in (("styleA", ADAPTER_MODULES[:1]), ("styleB", ADAPTER_MODULES)):
            reg.add(name, {m: {"down": (rng.normal(size=(2, 8)) * 0.4).astype(np.float32),
                               "up": (rng.normal(size=(8, 2)) * 0.4).astype(np.float32),
                               "alpha": 2.0} for m in mods})
        return reg

    return SimpleNamespace(jb=jb, pb=pb, registry=registry)


def _adapter_scheds(ab, cfg_over=None, adapters=True, max_sessions=4):
    cfg_over = cfg_over or {}
    js = JBatchScheduler(ab.jb.stream_models, ab.jb.params,
                         JREG.default_stream_config("tiny-test", **cfg_over), ab.jb.encode_prompt,
                         max_sessions=max_sessions, window_ms=10_000.0, prewarm=False, dp=1,
                         adapters=ab.registry("jax") if adapters else None)
    ps = BatchScheduler(ab.pb.stream_models, ab.pb.params,
                        PREG.default_stream_config("tiny-test", device="cpu", **cfg_over),
                        ab.pb.encode_prompt, max_sessions=max_sessions, window_ms=10_000.0,
                        prewarm=False, device="cpu",
                        adapters=ab.registry("port") if adapters else None)
    return js, ps


def _raised(fn, kind=Exception) -> str:
    with pytest.raises(kind) as e:
        fn()
    return f"{type(e.value).__name__}: {e.value}"


def test_adapter_plane_matches_the_jax_scheduler(adapter_bundles):
    """The JAX test_adapter_bucket_keys_bank_shape_and_metrics on both
    packages side by side: the bank's shapes, a claim's default adapter,
    per-session and global swaps, the swap counter, /health's and /metrics'
    adapter fields and the fingerprint equal the JAX scheduler's; an unknown
    name is refused with the JAX error before a slot is taken or a bank row
    written; an adapterless scheduler refuses with the JAX messages."""
    js, ps = _adapter_scheds(adapter_bundles)
    try:
        assert ps._bucket_label(2, "full") == js._bucket_label(2, "full") == "sbucket-2:full:r4"
        jbank, pbank = js.states["adapters"], ps.states["adapters"]
        assert set(pbank) == set(jbank)
        for path in jbank:
            for part in ("down", "up"):
                assert tuple(pbank[path][part].shape) == jbank[path][part].shape
        before = {p: f["down"].clone() for p, f in pbank.items()}
        for sched in (js, ps):
            assert sched.snapshot()["adapter_sessions"] == 0
        assert _raised(lambda: ps.claim("x", adapter="nope")) == _raised(
            lambda: js.claim("x", adapter="nope"))
        assert ps.free_slots == 4 and js.snapshot()["batchsched_sessions"] == 0
        sessions = {}
        for name, sched in (("jax", js), ("port", ps)):
            a = sched.claim("a", prompt="a cat", seed=1, adapter="styleA")
            assert _raised(lambda: a.update_adapter("nope")).startswith("KeyError")
            assert a.adapter == "styleA"
            a.update_adapter("styleB")
            assert a.adapter == "styleB"
            sched.update_adapter("styleA")
            b = sched.claim("b", prompt="a dog", seed=2)
            c = sched.claim("c", prompt="a fox", seed=3, adapter="styleB")
            c.update_adapter(None)
            sessions[name] = (a, b, c)
        assert [s.adapter for s in sessions["port"]] == [s.adapter for s in sessions["jax"]] == [
            "styleA", "styleA", None]
        a = sessions["port"][0]
        assert not torch.equal(pbank[next(iter(pbank))]["down"][a.slot],
                               before[next(iter(pbank))][a.slot])
        for key in ("adapter_sessions", "adapter_swaps_total", "adapter_rank"):
            assert ps.snapshot()[key] == js.snapshot()[key], key
        assert ps.snapshot()["adapter_sessions"] == 2 and ps.adapter_swaps_total == 3
        assert ps.session_snapshots() == {
            f"{k}": v for k, v in js.session_snapshots().items()}
        assert ps.snapshot_fingerprint() == {**js.snapshot_fingerprint(), "model_id": ""}
        # the bank rows equal the JAX rows slot for slot after the swaps
        bridge_rows = jax.tree.map(np.asarray, js.states["adapters"])
        for path in bridge_rows:
            for part in ("down", "up"):
                np.testing.assert_array_equal(pbank[path][part].numpy(), bridge_rows[path][part])
    finally:
        js.close()
        ps.close()
    js, ps = _adapter_scheds(adapter_bundles, adapters=False, max_sessions=2)
    try:
        assert ps._bucket_label(2, "full") == js._bucket_label(2, "full") == "sbucket-2:full"
        assert "adapters" not in ps.states and "adapter_rank" not in ps.snapshot_fingerprint()
        assert "adapter_rank" not in ps.snapshot()
        for fn in (lambda s: s.claim("x", adapter="styleA"), lambda s: s.update_adapter("x"),
                   lambda s: s.update_adapter(None)):
            assert _raised(lambda: fn(ps)) == _raised(lambda: fn(js))
        assert ps.free_slots == 2
    finally:
        js.close()
        ps.close()


def test_an_adapter_swap_resets_the_deepcache_cadence_as_jax_does(adapter_bundles):
    """DeepCache N=3: a styled session steps capture, cached; a swap sets the
    tick to 0 and marks the slot uncaptured on both packages, so the next
    step captures; every frame within 1 level of the JAX scheduler's."""
    over = dict(TURBO8, unet_cache_interval=3)
    js, ps = _adapter_scheds(adapter_bundles, over, max_sessions=1)
    seen = {"jax": [], "port": []}
    jorig, porig = js._bucket_step, ps._next_variant_locked

    def jspy(k, variant="full"):
        seen["jax"].append(variant)
        return jorig(k, variant)

    def pspy(slots):
        seen["port"].append(porig(slots))
        return seen["port"][-1]

    js._bucket_step, ps._next_variant_locked = jspy, pspy
    try:
        ja = js.claim("a", prompt="a cat", seed=1, adapter="styleA")
        pa = ps.claim("a", prompt="a cat", seed=1, adapter="styleA")
        bridge.states_from_jax(jax.tree.map(np.asarray, js.states), ps.states)
        frames = _frames(5, seed=61)
        for j, f in enumerate(frames):
            if j == 2:
                ja.update_adapter("styleB")
                pa.update_adapter("styleB")
                assert (js._tick, ps._tick) == (0, 0)
                assert ja.slot in js._uncaptured and pa.slot in ps._uncaptured
            _close(pa(f), ja(f))
        assert seen["port"] == seen["jax"] == ["capture", "cached", "capture", "cached", "cached"]
    finally:
        js.close()
        ps.close()


def test_scheduler_at_fbs2_matches_the_jax_batch_scheduler():
    """frame_buffer_size 2 through both schedulers, two sessions in the
    bucket of 2 (each session's two consecutive frames one row of its
    slot), the JAX states carried across, a prompt update on one session:
    every frame within 1 level; a group's frames resolve to their own
    slices, in order."""
    jb = JREG.load_model_bundle("tiny-test")
    cfg = JREG.default_stream_config("tiny-test", frame_buffer_size=2)
    js = JBatchScheduler(jb.stream_models, jb.params, cfg, jb.encode_prompt, max_sessions=2,
                         window_ms=10_000.0, prewarm=False, dp=1)
    pb = PREG.load_model_bundle("tiny-test", device="cpu",
                                params=bridge.params_from_jax(jax.tree.map(np.asarray, jb.params)))
    ps = BatchScheduler(pb.stream_models, pb.params, PREG.default_stream_config(
        "tiny-test", device="cpu", frame_buffer_size=2), pb.encode_prompt, max_sessions=2,
        window_ms=10_000.0, device="cpu")
    try:
        assert (ps.fbs, ps.queue_bound) == (js.fbs, js.queue_bound) == (2, 4)
        jsess = [js.claim(f"j{i}", prompt=p, seed=i) for i, p in enumerate(("a cat", "a dog"))]
        psess = [ps.claim(f"p{i}", prompt=p, seed=i) for i, p in enumerate(("a cat", "a dog"))]
        assert [s.frame_buffer_size for s in psess] == [2, 2]
        bridge.states_from_jax(jax.tree.map(np.asarray, js.states), ps.states)
        streams = [_frames(8, seed=60 + i) for i in range(2)]
        for j in range(0, 8, 2):
            if j == 4:
                jsess[1].update_prompt("a watercolor fox")
                psess[1].update_prompt("a watercolor fox")
            got = {}
            for name, sess in (("jax", jsess), ("port", psess)):
                handles = [s.submit_batch(f[j:j + 2]) for s, f in zip(sess, streams)]
                got[name] = [s.fetch_batch(h) for s, h in zip(sess, handles)]
            for a, b in zip(got["port"], got["jax"]):
                assert len(a) == len(b) == 2
                for x, y in zip(a, b):
                    _close(x, y)
        snap = ps.snapshot()
        assert (snap["batchsched_fbs"], snap["batchsched_occupancy_hist"]) == (2, {"2": 4})
        assert js.snapshot()["batchsched_occupancy_hist"] == {"2": 4}
    finally:
        js.close()
        ps.close()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
def test_session_step_at_fbs2_matches_dedicated_engines(port_bundle, fused):
    """The bucket step at frame_buffer_size 2 (the 4-stage ring: 8 rows a
    session, the renoise moving rows by 2 within each segment), a padded
    bucket [1, 0, 0] with 2 real sessions: each session's two frames equal
    its dedicated engine's over 3 steps."""
    b = port_bundle
    cfg = PREG.default_stream_config("tiny-test", device="cpu", use_fused_epilogue=fused,
                                     frame_buffer_size=2)
    engines = [_dedicated(b, cfg, p, i) for i, p in enumerate(("a cat", "a dog"))]
    states = PENG.stack_states([e.state for e in engines])
    step = PENG.make_session_step_fn(b.stream_models, cfg)
    slots = [1, 0, 0]
    for j in range(3):
        fr = [np.stack(_frames(2, seed=70 + 2 * j + s)) for s in range(2)]
        out = step(b.params, states, torch.from_numpy(np.stack([fr[s] for s in slots])),
                   torch.tensor(slots, dtype=torch.int32), 2)
        assert out.shape == (3, 2, 64, 64, 3)
        for row, s in enumerate(slots[:2]):
            _close(out[row].numpy(), engines[s](fr[s]))


def test_fbs2_scheduler_refuses_the_similarity_filter_and_a_short_queue(port_bundle):
    b = port_bundle
    cfg = PREG.default_stream_config("tiny-test", device="cpu", frame_buffer_size=2)
    with pytest.raises(ValueError, match="fbs group"):
        BatchScheduler(b.stream_models, b.params, cfg, b.encode_prompt, queue_bound=1,
                       device="cpu", prewarm=False)
    cfg = PREG.default_stream_config("tiny-test", device="cpu", frame_buffer_size=2,
                                     similar_image_filter=True)
    with pytest.raises(ValueError, match="similarity filter"):
        BatchScheduler(b.stream_models, b.params, cfg, b.encode_prompt, device="cpu",
                       prewarm=False)


# -- capacity, windows and the control plane --------------------------------------------

def test_capacity_and_window_shed(port_bundle):
    """The 3rd claim on 2 slots raises CapacityError; a session's window
    sheds its oldest frame as passthrough at once (no step ever runs: one
    session waits for the other inside a huge window)."""
    b = port_bundle
    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    s = BatchScheduler(b.stream_models, b.params, cfg, b.encode_prompt, max_sessions=2,
                       window_ms=10_000.0, queue_bound=2, prewarm=False, device="cpu")
    try:
        a = s.claim("a")
        s.claim("b")
        with pytest.raises(CapacityError):
            s.claim("c")
        f = np.zeros((64, 64, 3), np.uint8)
        h1 = a.submit(f)
        a.submit(f + 1)
        a.submit(f + 2)
        out = h1.future.result(timeout=2.0)
        assert isinstance(out, ShedFrame)
        assert a.fetch(h1) is out
        assert a.window_queue.shed_overflow == 1
        snap = s.snapshot()
        assert (snap["batchsched_sessions"], snap["batchsched_max_sessions"]) == (2, 2)
        assert snap["batchsched_steps_total"] == 0
    finally:
        s.close()


@pytest.mark.parametrize("leave", ["released", "failed_readback"])
def test_unfetched_steps_do_not_hold_back_dispatch(port_bundle, leave):
    """Two steps that nobody will read: their riders left without fetching
    (a closed connection), or their readback failed.  Neither may count as
    in flight: the next session's frame steps at once instead of waiting
    out the 60 s age-out behind PIPELINE_DEPTH."""
    b = port_bundle
    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    s = BatchScheduler(b.stream_models, b.params, cfg, b.encode_prompt, max_sessions=3,
                       prewarm=False, fetch_timeout=10.0, device="cpu")
    frame = _frames(1, seed=4)[0]
    try:
        for i in range(BatchScheduler.PIPELINE_DEPTH):
            sess = s.claim(f"solo{i}")
            h = sess.submit(frame)
            batch, row = h.future.result(timeout=10.0)  # dispatched, not fetched
            if leave == "released":
                sess.release()
            else:
                def fail(row):
                    raise RuntimeError("readback failed")

                batch.readback.row = fail
                with pytest.raises(RuntimeError, match="readback failed"):
                    sess.fetch(h)
        assert s._in_flight(time.monotonic()) == 0
        late = s.claim("late")
        out = late(frame)  # within fetch_timeout, or it raises
        assert out.shape == frame.shape and out.dtype == np.uint8
    finally:
        s.close()


def test_global_updates_reach_every_session_and_outlive_them(port_bundle):
    """POST /config semantics: the global update_* methods reach every live
    session and become the defaults of later claims; a bad t-index list
    fails the call even with no session."""
    b = port_bundle
    cfg = PREG.default_stream_config("tiny-test", device="cpu", **TURBO8)
    s = BatchScheduler(b.stream_models, b.params, cfg, b.encode_prompt, max_sessions=2,
                       prewarm=False, device="cpu")
    try:
        with pytest.raises(ValueError):
            s.update_t_index_list([1, 2])
        s.update_t_index_list([5])
        a = s.claim("a")
        s.update_prompt("a global prompt")
        s.update_guidance(1.6, 0.7)
        late = s.claim("late")
        for sess in (a, late):
            assert sess.t_index_list == [5] and sess.prompt == "a global prompt"
            assert (sess.guidance_scale, sess.delta) == (1.6, 0.7)
            assert float(s.states["guidance"][sess.slot]) == pytest.approx(1.6)
        want = PENG.coeff_state(cfg, s._template.schedule, (5,), "cpu")["timesteps"]
        assert torch.equal(s.states["coeffs"]["timesteps"][late.slot], want)
        assert torch.equal(s.states["cond"][a.slot], s.states["cond"][late.slot])
    finally:
        s.close()


def test_bucket_choice():
    assert bucket_sizes(8) == [1, 2, 4, 8] and bucket_sizes(5) == [1, 2, 4, 5]
    assert bucket_sizes(8, include_capacity=False) == [1, 2, 4]
    assert [bucket_for([1, 2, 4, 8], n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    assert bucket_for([1, 2, 4], 5) is None
    assert pad_bucket([3, 0, 5], 4) == [3, 0, 5, 5] and pad_bucket([2], 1) == [2]


class _StubPipeline:
    def __call__(self, frame):
        return frame


class _FakeSession:
    def __init__(self, owner, slot, key):
        self._owner, self.slot, self.session_key = owner, slot, key
        self.prompt = None
        self.window_queue = owner.side.queue(2)

    def __call__(self, frame):
        arr = frame if isinstance(frame, np.ndarray) else frame.to_ndarray()
        return 255 - arr

    def update_prompt(self, p):
        self.prompt = p

    def update_t_index_list(self, t):
        pass

    def release(self):
        self._owner.released.append(self.slot)

    def snapshot(self):
        return {"slot": self.slot}


class _FakeScheduler:
    """A scheduler stand-in (the JAX tests' shape): the HTTP surface without
    a model."""

    def __init__(self, side, max_sessions=2):
        self.side, self.max_sessions = side, max_sessions
        self.claimed, self.released = [], []
        self.prompt, self.on_step = None, None

    @property
    def free_slots(self):
        return self.max_sessions - len(self.claimed) + len(self.released)

    def claim(self, session_key=None, prompt=None, seed=None):
        if self.free_slots <= 0:
            raise self.side.full("full")
        sess = _FakeSession(self, len(self.claimed), session_key)
        self.claimed.append(sess)
        return sess

    def update_prompt(self, p):
        self.prompt = p

    def update_t_index_list(self, t):
        pass

    def snapshot(self):
        return {"batchsched_sessions": len(self.claimed) - len(self.released),
                "batchsched_max_sessions": self.max_sessions, "batchsched_steps_total": 7}

    def session_snapshots(self):
        return {s.session_key: s.snapshot() for s in self.claimed if s.slot not in self.released}

    def close(self):
        pass


def _both_agents(case):
    """``case(client, app, fake, m)`` against each agent with a fake scheduler
    of 2 slots; the transcripts must be equal."""

    async def drive(side):
        m = SIDES[side]
        fake = _FakeScheduler(m)
        app = m.agent.build_app(pipeline=_StubPipeline(), provider=m.signaling.LoopbackProvider(),
                                batch_scheduler=fake)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await case(client, app, fake, m)
        finally:
            await client.close()

    got = {side: asyncio.run(drive(side)) for side in SIDES}
    assert got["port"] == got["jax"]
    return got["port"]


async def _released(fake, n):
    for _ in range(100):
        if len(fake.released) >= n:
            return True
        await asyncio.sleep(0.02)
    return False


def test_agent_sessions_claim_503_release_and_config_match_jax():
    """/offer and /whip each claim a scheduler session; the 3rd gets 503
    with Retry-After and the JAX text; /metrics carries the scheduler's
    gauges; POST /config goes to the scheduler; closing a connection and
    DELETE /whip/{id} give the slots back; a datachannel prompt reaches
    only its own session."""
    _claim_503_release_and_config()


def test_agent_sessions_claim_503_release_and_config_under_the_jax_defaults(monkeypatch):
    """The same with supervision and overload control on (each agent's
    default): the sessions ride supervisors, the admission gate reserves
    each offer, and /health lists each session's scheduler view."""
    for name in ("SUPERVISOR", "OVERLOAD_CONTROL", "ENGINE_GUARD"):
        monkeypatch.setenv(name, "1")
    _claim_503_release_and_config(health=True)


def _claim_503_release_and_config(health=False):
    async def case(client, app, fake, m):
        out = []
        r = await client.post("/offer", json=_offer_body(m, "r1"))
        out.append(r.status)
        r = await client.post("/whip", data=m.signaling.make_loopback_offer(),
                              headers={"Content-Type": "application/sdp"})
        out.append(r.status)
        whip = r.headers.get("Location")
        r = await client.post("/offer", json=_offer_body(m, "r2"))
        out += [r.status, await r.text(), "Retry-After" in r.headers]
        body = await (await client.get("/metrics")).json()
        out.append({k: v for k, v in body.items() if k.startswith("batchsched_")})
        out.append((await client.post("/config", json={"prompt": "global p"})).status)
        out.append(fake.prompt)
        offer_pc = next(pc for pc in app["pcs"] if pc.out_tracks)
        await offer_pc.datachannel.deliver(json.dumps({"prompt": "only mine"}))
        out.append(sorted(str(s.prompt) for s in fake.claimed))
        if health:
            body = await (await client.get("/health")).json()
            views = sorted((s["state"], s["batchsched"]["slot"]) for s in body["sessions"].values())
            assert views == [("HEALTHY", 0), ("HEALTHY", 1)], views
            out.append(views)
        await offer_pc.close()
        out.append(await _released(fake, 1))
        out.append((await client.delete(whip)).status)
        out.append(await _released(fake, 2))
        r = await client.post("/offer", json=_offer_body(m, "r3"))
        out.append(r.status)
        return out

    got = _both_agents(case)
    assert got[:5] == [200, 201, 503, "all batch-scheduler session slots in use", True]
    assert got[-1] == 200 and got[-2] is True and got[-4] is True


def test_agent_batchsched_off_fbs_and_no_fallback(monkeypatch):
    """BATCHSCHED=0 serves the shared pipeline; --fbs 2 serves the batch
    scheduler at fbs 2 (the JAX agent's path); a scheduler that cannot be
    built fails the startup (no fallback to the shared path)."""

    async def boot(**kw):
        app = PA.build_app(model_id="tiny-test", provider=PS.LoopbackProvider(), device="cpu", **kw)
        server = TestServer(app)
        await server.start_server()
        await server.close()
        return app

    monkeypatch.setenv("BATCHSCHED", "0")
    app = asyncio.run(boot())
    assert app["batch_scheduler"] is None and app["pipeline"] is not None
    monkeypatch.delenv("BATCHSCHED")
    app = asyncio.run(boot(fbs=2))
    assert app["pipeline"].frame_buffer_size == app["batch_scheduler"].fbs == 2

    def broken(*a, **k):
        raise RuntimeError("scheduler refused")

    monkeypatch.setattr(BatchScheduler, "__init__", broken)
    with pytest.raises(RuntimeError, match="scheduler refused"):
        asyncio.run(boot())


# -- --multipeer --------------------------------------------------------------------------

def _multipeer_engine(bundle, cfg, max_peers=4):
    return MultiPeerEngine(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt,
                           max_peers=max_peers, device="cpu").start("default prompt")


def test_multipeer_engine_matches_dedicated_engines(port_bundle, monkeypatch):
    """Two peers of four step through the bucket of 2 (and, with
    MULTIPEER_BUCKETS=0, through the step of every slot): each peer's frames
    within 1 level of a dedicated engine; idle slots come back as zeros."""
    b = port_bundle
    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    for buckets in ("1", "0"):
        monkeypatch.setenv("MULTIPEER_BUCKETS", buckets)
        mp = _multipeer_engine(b, cfg)
        assert (mp.connect("peer zero"), mp.connect("peer one", seed=9)) == (0, 1)
        engines = [_dedicated(b, cfg, "peer zero", 0), _dedicated(b, cfg, "peer one", 9)]
        rng = np.random.default_rng(3)
        for _ in range(3):
            frames = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
            out = mp.step_all(frames)
            assert out.shape == (4, 64, 64, 3) and out.dtype == np.uint8
            for s in (0, 1):
                _close(out[s], engines[s](frames[s]))
            if buckets == "1":
                assert not out[2:].any()
        with pytest.raises(ValueError):
            mp.step_all(np.zeros((3, 64, 64, 3), np.uint8))
        mp.disconnect(0)
        assert mp.connect("replacement") == 0


def test_multipeer_per_peer_prompt_isolation(port_bundle):
    cfg = PREG.default_stream_config("tiny-test", device="cpu", **TURBO8)
    mp = _multipeer_engine(port_bundle, cfg)
    mp.connect("prompt A", seed=7)
    mp.connect("prompt A", seed=7)  # the same state in both slots
    frames = np.random.default_rng(1).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    frames[1] = frames[0]
    base = mp.step_all(frames.copy())
    np.testing.assert_array_equal(base[0], base[1])
    mp.update_prompt(1, "a completely different prompt")
    out = mp.step_all(frames.copy())
    np.testing.assert_array_equal(out[0], base[0])
    assert not np.array_equal(out[0], out[1])
    with pytest.raises(ValueError):
        mp.update_t_index(0, [1, 2])


def test_multipeer_pipeline_two_peers_independent():
    mp = MultiPeerPipeline("tiny-test", max_peers=2, device="cpu")
    try:
        p1 = mp.claim("a red cat")
        p2 = mp.claim("a blue dog")
        with pytest.raises(CapacityError):
            mp.claim("third peer")
        frame = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
        o1, o2 = p1(frame), p2(frame)
        assert o1.shape == frame.shape and o1.dtype == np.uint8 and o2.shape == frame.shape
        assert not np.array_equal(o1, o2)  # other prompts, other seeds
        p1.update_prompt("another style")
        p1.update_t_index_list([5, 15, 25, 35])
        with pytest.raises(ValueError):
            p1.update_t_index_list([5, 15])
        assert p1(frame).shape == frame.shape
        mp.update_prompt("global prompt")
        mp.update_t_index_list([6, 16, 26, 36])
        p1.release()
        p1.release()
        assert mp.free_slots == 1
        assert mp.claim("replacement peer").slot == p1.slot
    finally:
        mp.close()


def test_multipeer_pipeline_sheds_the_oldest_frame_as_passthrough(monkeypatch):
    """A peer that outpaces the step: while a tick's readback waits, its
    queue (a DeadlineQueue of QUEUE_BOUND frames) sheds the oldest frame,
    whose waiter resolves at once with a ShedFrame of its own pixels; the
    frames kept are stepped."""
    mp = MultiPeerPipeline("tiny-test", max_peers=2, device="cpu")
    try:
        peer = mp.claim("a red cat")
        entered, go = threading.Event(), threading.Event()
        fetch = mp.engine.fetch

        def held_fetch(pending):
            entered.set()
            assert go.wait(10.0)
            return fetch(pending)

        monkeypatch.setattr(mp.engine, "fetch", held_fetch)
        frames = _frames(2 + MultiPeerPipeline.QUEUE_BOUND, seed=8)
        handles = [peer.submit(frames[0])]
        assert entered.wait(10.0)  # the first tick is out, its readback held
        handles += [peer.submit(f) for f in frames[1:]]
        shed = handles[1].result(timeout=1.0)
        assert isinstance(shed, ShedFrame) and np.array_equal(shed.frame, frames[1])
        assert mp._queues[peer.slot].shed_overflow == 1
        go.set()
        for h in handles[:1] + handles[2:]:
            out = peer.fetch(h)
            assert out.shape == frames[0].shape and out.dtype == np.uint8
    finally:
        go.set()
        mp.close()


class _HeldPeerEngine:
    """A peer engine stand-in for the coordinators of both packages: no model
    work, and its readback waits for ``go``, so the coordinator holds in its
    first fetch while a peer's frames arrive."""

    def __init__(self, *args, max_peers=1, **kwargs):
        self.max_peers = max_peers
        self.active = [False] * max_peers
        self.entered, self.go = threading.Event(), threading.Event()

    def start(self, prompt):
        return self

    def use_aot_cache(self, *args, **kwargs):
        return False

    def prewarm_buckets(self):
        pass

    def reserve(self):
        slot = self.active.index(False)
        self.active[slot] = True
        return slot

    def build_state(self, prompt, seed):
        return None

    def install(self, slot, state):
        pass

    def disconnect(self, slot):
        self.active[slot] = False

    @property
    def free_slots(self):
        return self.active.count(False)

    def submit(self, frames):
        return frames

    def fetch(self, pending):
        self.entered.set()
        assert self.go.wait(10.0)
        return pending


@pytest.mark.parametrize("bound", [1, 3])
def test_multipeer_queue_bound_sheds_as_the_jax_coordinator_does(monkeypatch, bound):
    """OVERLOAD_PEER_QUEUE_BOUND (the JAX coordinator's knob, floor 1): with
    the first tick's readback held, one peer sends 5 more frames; each
    coordinator sheds the same frames (the oldest past the bound, each
    delivered as a ShedFrame of its own pixels) and counts them in
    ``frames_shed``.  A port with a fixed bound of 2 sheds 3 and 1 here,
    not 4 and 2."""
    from ai_rtc_agent_tpu.server import multipeer_serving as JMS
    from ai_rtc_agent_tpu_torch.server import multipeer_serving as PMS

    monkeypatch.setenv("OVERLOAD_PEER_QUEUE_BOUND", str(bound))
    fake_registry = SimpleNamespace(
        load_model_bundle=lambda *a, **k: SimpleNamespace(params={}, stream_models=None,
                                                          encode_prompt=None),
        cast_params=lambda params, dtype: params)
    frames = [np.full((64, 64, 3), i, np.uint8) for i in range(6)]
    shed = {}
    for name, mod, cfg, kw in (
            ("jax", JMS, JREG.default_stream_config("tiny-test"), {}),
            ("port", PMS, PREG.default_stream_config("tiny-test", device="cpu"),
             {"device": "cpu"})):
        monkeypatch.setattr(mod, "registry", fake_registry)
        monkeypatch.setattr(mod, "MultiPeerEngine", _HeldPeerEngine)
        monkeypatch.setattr(mod, "maybe_load_safety_checker", lambda *a, **k: None)
        mp = mod.MultiPeerPipeline("tiny-test", max_peers=1, config=cfg, **kw)
        try:
            peer = mp.claim("a red cat")
            handles = [peer.submit(frames[0])]
            assert mp.engine.entered.wait(10.0)  # the first tick is out, its readback held
            handles += [peer.submit(f) for f in frames[1:]]
            gone = [i for i, h in enumerate(handles) if h.done()]
            assert all(type(handles[i].result()).__name__ == "ShedFrame" and np.array_equal(
                handles[i].result().frame, frames[i]) for i in gone)
            shed[name] = (gone, mp.frames_shed)
            mp.engine.go.set()
            for i, h in enumerate(handles):
                if i not in gone:
                    assert np.array_equal(h.result(timeout=10.0), frames[i])
        finally:
            mp.engine.go.set()
            mp.close()
    assert shed["port"] == shed["jax"] == (list(range(1, 6 - bound)), 5 - bound)


def test_agent_multipeer_offer_claims_503_and_release():
    """--multipeer 2 on the port's agent (a real tiny-test peer engine on the
    CPU): two offers claim the slots, the 3rd gets 503 with Retry-After and
    the JAX text, a datachannel prompt reaches its own peer, closing a
    connection frees its slot; --multipeer refuses --fbs > 1."""

    async def go():
        app = PA.build_app(model_id="tiny-test", provider=PS.LoopbackProvider(), device="cpu",
                           multipeer=2)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            m = SIDES["port"]
            statuses = [(await client.post("/offer", json=_offer_body(m, f"r{i}"))).status
                        for i in range(2)]
            mp = app["multipeer_pipeline"]
            assert statuses == [200, 200] and mp.free_slots == 0 and app["pipeline"] is None
            r = await client.post("/offer", json=_offer_body(m, "r3"))
            assert (r.status, await r.text()) == (503, "all peer slots in use")
            assert "Retry-After" in r.headers
            pcs = [pc for pc in app["pcs"] if pc.out_tracks]  # a set: any order
            mine = pcs[0].out_tracks[0].pipeline._pipeline.slot  # TimedPipeline -> PeerPipeline
            before = mp.engine.states["cond"].clone()
            await pcs[0].datachannel.deliver(json.dumps({"prompt": "peer0 style"}))
            assert not torch.equal(mp.engine.states["cond"][mine], before[mine])
            assert torch.equal(mp.engine.states["cond"][1 - mine], before[1 - mine])
            await pcs[0].close()
            for _ in range(100):
                if mp.free_slots == 1:
                    break
                await asyncio.sleep(0.02)
            assert mp.free_slots == 1
            assert (await client.post("/offer", json=_offer_body(m, "r4"))).status == 200
        finally:
            await client.close()

    asyncio.run(go())
    app = PA.build_app(model_id="tiny-test", provider=PS.LoopbackProvider(), device="cpu",
                       multipeer=2, fbs=2)
    with pytest.raises(ValueError, match="--fbs"):
        asyncio.run(TestServer(app).start_server())
