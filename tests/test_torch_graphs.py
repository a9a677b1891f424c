"""The compiled step of the port on the CPU (aot/cache.py and the engines
around it): keys, the static-buffer path, in-place state writes.

* Keys: the port's ``stream_engine_key``, the scheduler's ``bucket_keys``
  and the multipeer engine's keys are the JAX package's recipe for the
  same configuration, up to the version part.
* The static-buffer path: on the CPU every step runs eagerly over the same
  static buffers a CUDA graph is captured over on the card (the frames,
  the slot vector and the count of real sessions as device data), so these
  tests drive the plumbing the card replays.  The port's ``BatchScheduler``
  is held against the JAX ``BatchScheduler`` within 1 uint8 level (the
  rounding-tie class of tests/test_torch_stream.py) across join and leave,
  a padded bucket (3 of 4), prompt, t-index and guidance updates, a
  restart, and 2 frames in flight per session.
* In place: a graph reads fixed addresses, so no control-plane write may
  rebind a state leaf: the ``data_ptr`` of every leaf of the three engines
  stays put across updates and restarts, and the factor bank's across
  adapter swaps.  A bound bank adds ``lrank-R`` to the keys, as in JAX.
* The count of real sessions from device memory: a slot vector naming a
  4th distinct slot with a count of 3 leaves that slot's rows bit-equal.
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.stream import engine as JENG
from ai_rtc_agent_tpu.stream.scheduler import BatchScheduler as JBatchScheduler
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.aot import cache as AOT
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.parallel.multipeer import BucketStep, MultiPeerEngine
from ai_rtc_agent_tpu_torch.stream import engine as PENG
from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline
from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler
from ai_rtc_agent_tpu_torch.tree import tree_map

TURBO = dict(t_index_list=(0,), num_inference_steps=1, timestep_spacing="trailing",
             scheduler="turbo", cfg_type="none")
TURBO8 = dict(t_index_list=(2,), num_inference_steps=8, timestep_spacing="trailing",
              scheduler="turbo", cfg_type="none")


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(n)]


def _close(a, b):
    diff = np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16))
    assert np.asarray(a).shape == np.asarray(b).shape and diff.max() <= 1, diff.max()


def _unversioned(key: str) -> str:
    head, _, version = key.rpartition("--v-")
    assert head and version, key
    return head


# -- keys ------------------------------------------------------------------------------

KEY_CONFIGS = {
    "default": {}, "turbo": TURBO, "bf16": {"dtype": "bfloat16"},
    "hw": {"height": 768, "width": 640}, "initialize": {"cfg_type": "initialize"},
    "fused": {"use_fused_epilogue": True}, "plain": {"attn_impl": "plain"},
    "fbs2": {"frame_buffer_size": 2},
}


def _configs(overrides):
    port = dataclasses.replace(PENG.StreamConfig(), **overrides)
    jax_cfg = dataclasses.replace(JENG.StreamConfig(), **{**overrides, "attn_impl": port.attn_impl})
    return port, jax_cfg


@pytest.mark.parametrize("model_id", ["stabilityai/sd-turbo", "tiny-test"])
@pytest.mark.parametrize("name", list(KEY_CONFIGS))
def test_stream_engine_key_is_the_jax_recipe(model_id, name):
    port, jax_cfg = _configs(KEY_CONFIGS[name])
    got = AOT.stream_engine_key(model_id, port, peers=4)
    assert _unversioned(got) == _unversioned(JENG.stream_engine_key(model_id, jax_cfg, peers=4))
    assert got.endswith("--v-0.1.0+torch")


def test_every_graph_flag_changes_the_key():
    base = PENG.StreamConfig()
    key = lambda cfg, **kw: AOT.stream_engine_key("m", cfg, **kw)  # noqa: E731
    keys = [key(base, sbucket=2, sessions=8), key(base, sbucket=4, sessions=8),
            key(base, sbucket=2, sessions=4)]
    for change in ({"dtype": "bfloat16"}, {"height": 256}, {"cfg_type": "none"},
                   {"use_fused_epilogue": True}, {"attn_impl": "plain"}):
        keys.append(key(dataclasses.replace(base, **change), sbucket=2, sessions=8))
    assert len(set(keys)) == len(keys)


def _jax_bucket_keys(model_id, jax_cfg, max_sessions, sizes, params=None, variants=("full",),
                     adapter_rank=0):
    """The JAX ``BatchScheduler.bucket_keys`` of a single-device scheduler
    (dense unless ``params`` are given; adapterless unless ``adapter_rank``),
    called on a stand-in for its ``self``."""
    owner = SimpleNamespace(model_id=model_id, params=params or {}, mesh=None,
                            _adapter_rank=adapter_rank,
                            cfg=jax_cfg, max_sessions=max_sessions, _bucket_sizes=sizes,
                            _variants=list(variants))
    return JBatchScheduler.bucket_keys(owner, model_id)


@pytest.fixture(scope="module")
def port_bundle():
    return PREG.load_model_bundle("tiny-test", device="cpu")


@pytest.mark.parametrize("max_sessions", [1, 4, 8])
def test_scheduler_bucket_keys_are_the_jax_recipe(port_bundle, max_sessions):
    b = port_bundle
    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    sched = BatchScheduler(b.stream_models, b.params, cfg, b.encode_prompt,
                           max_sessions=max_sessions, prewarm=False, device="cpu",
                           model_id="tiny-test")
    try:
        got = sched.bucket_keys()
        want = _jax_bucket_keys("tiny-test", _configs(dataclasses.asdict(cfg))[1], max_sessions,
                                sched._bucket_sizes)
        assert {k: _unversioned(v) for k, v in got.items()} == {
            k: _unversioned(v) for k, v in want.items()}
        assert sched.graph_status() == dict.fromkeys(got, False)  # the CPU steps eagerly
        assert sched.snapshot()["batchsched_graphs"] == {f"{k}:{v}": False for k, v in got}
    finally:
        sched.close()


def _style_registry(bundle, rank: int):
    """A port registry of one style of ``rank`` on one attention linear."""
    from ai_rtc_agent_tpu_torch.adapters import AdapterRegistry
    from ai_rtc_agent_tpu_torch.models import loader as PLD

    rng = np.random.default_rng(rank)
    reg = AdapterRegistry(bundle.params["unet"], PLD.unet_key_map(bundle.unet_cfg))
    reg.add("style", {"down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q": {
        "down": rng.normal(size=(rank, 8)).astype(np.float32),
        "up": rng.normal(size=(8, rank)).astype(np.float32), "alpha": float(rank)}})
    return reg


@pytest.mark.parametrize("rank,bucket", [(3, 4), (12, 16)])
def test_adapter_bucket_keys_are_the_jax_recipe(port_bundle, rank, bucket):
    """A bound factor bank adds ``lrank-R`` (its padded rank) to every bucket
    key, as the JAX scheduler's keys with ``_adapter_rank=R``; an adapterless
    scheduler's keys stay as they were (the test above)."""
    from ai_rtc_agent_tpu.aot.cache import adapter_key_extra as jextra

    b = port_bundle
    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    sched = BatchScheduler(b.stream_models, b.params, cfg, b.encode_prompt, max_sessions=4,
                           prewarm=False, device="cpu", model_id="tiny-test",
                           adapters=_style_registry(b, rank))
    try:
        got = sched.bucket_keys()
        want = _jax_bucket_keys("tiny-test", _configs(dataclasses.asdict(cfg))[1], 4,
                                sched._bucket_sizes, adapter_rank=bucket)
        assert {k: _unversioned(v) for k, v in got.items()} == {
            k: _unversioned(v) for k, v in want.items()}
        assert all(f"--lrank-{bucket}--" in v for v in got.values())
        assert AOT.adapter_key_extra(bucket) == jextra(bucket) == {"lrank": bucket}
        assert AOT.adapter_key_extra(0) == jextra(0) == {}
    finally:
        sched.close()


def test_multipeer_keys_extend_the_jax_peers_key(port_bundle):
    b = port_bundle
    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    mp = MultiPeerEngine(b.stream_models, b.params, cfg, b.encode_prompt, max_peers=4,
                         device="cpu", model_id="tiny-test")
    keys = mp.bucket_keys()
    assert sorted(keys) == [(1, "full"), (2, "full"), (4, "full")]
    want = JENG.stream_engine_key("tiny-test", _configs(dataclasses.asdict(cfg))[1], peers=4)
    assert _unversioned(keys[(4, "full")]) == _unversioned(want)
    assert len(set(keys.values())) == 3 and all("sbucket" in keys[(k, "full")] for k in (1, 2))


def test_variant_bucket_keys_are_the_jax_recipe(port_bundle, monkeypatch):
    """DeepCache keys a capture + cached pair per bucket and w8 params add
    ``quant-w8``: the scheduler's keys are the JAX scheduler's, and the
    peer engine's full step keys are the JAX MultiPeerEngine's AOT pair."""
    monkeypatch.setenv("QUANT_WEIGHTS", "w8")
    monkeypatch.setenv("QUANT_MIN_SIZE", "256")
    jb = JREG.load_model_bundle("tiny-test")
    jq = JREG.cast_params(jb.params, "float32")
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jq))
    b = port_bundle
    cfg = PREG.default_stream_config("tiny-test", device="cpu", unet_cache_interval=3)
    jcfg = _configs(dataclasses.asdict(cfg))[1]
    sched = BatchScheduler(b.stream_models, params, cfg, b.encode_prompt, max_sessions=4,
                           prewarm=False, device="cpu", model_id="tiny-test")
    try:
        got = sched.bucket_keys()
        want = _jax_bucket_keys("tiny-test", jcfg, 4, sched._bucket_sizes, params=jq,
                                variants=("capture", "cached"))
        assert {k: _unversioned(v) for k, v in got.items()} == {
            k: _unversioned(v) for k, v in want.items()}
        assert all("quant-w8" in v and "dcache-3" in v for v in got.values())
        assert sched._bucket_label(2, "cached") == "sbucket-2:cached"
    finally:
        sched.close()
    mp = MultiPeerEngine(b.stream_models, params, cfg, b.encode_prompt, max_peers=4,
                         device="cpu", model_id="tiny-test")
    keys = mp.bucket_keys()
    for v in ("capture", "cached"):
        want = JENG.stream_engine_key("tiny-test", jcfg, peers=4, variant=v,
                                      **JENG.params_variant_extra(jq))
        assert _unversioned(keys[(4, v)]) == _unversioned(want)


# -- captured steps on the CPU ---------------------------------------------------------

def test_captured_step_runs_eagerly_over_its_buffers_on_the_cpu():
    inputs = {"x": torch.zeros(3)}
    cache = AOT.GraphCache(graphs=False, device="cpu")
    step = cache.get("k", lambda: (lambda b: b["x"] * 2, inputs))
    assert cache.get("k", lambda: pytest.fail("built twice")) is step
    step.inputs["x"].copy_(torch.tensor([1.0, 2.0, 3.0]))
    assert torch.equal(step.run(), torch.tensor([2.0, 4.0, 6.0]))
    assert cache.status() == {"k": False} and not step.captured
    with pytest.raises(ValueError, match="CUDA"):
        AOT.CapturedStep("g", lambda b: b["x"], inputs, graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        AOT.GraphCache(graphs=True, device="cpu")
    with pytest.raises(RuntimeError, match="eagerly"):
        step.capture()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
def test_bucket_warm_and_padding_write_no_slot(port_bundle, fused):
    """The count of real sessions as data: a warm step (count 0) writes no
    slot; a slot vector naming 4 distinct slots with a count of 3 leaves
    the 4th slot's ring and stock bit-equal and moves the other three; the
    static buffers keep their storage from one occupancy to the next."""
    b = port_bundle
    cfg = PREG.default_stream_config("tiny-test", device="cpu", use_fused_epilogue=fused)
    eng = PENG.StreamEngine(b.stream_models, b.params, cfg, b.encode_prompt, device="cpu")
    states = PENG.stack_states([eng.build_state(f"p{i}", seed=i) for i in range(5)])
    start = tree_map(lambda a: a.clone(), states)
    bucket = BucketStep(b.stream_models, cfg, torch.device("cpu"))
    bucket.warm(b.params, states, 4)
    for key in ("x_buf", "stock"):
        assert torch.equal(states[key], start[key]), key
    step = bucket.step_for(b.params, states, 4)
    ptrs = {name: t.data_ptr() for name, t in step.inputs.items()}
    step.inputs["frames"].copy_(torch.from_numpy(np.stack(_frames(4, seed=3))))
    step.inputs["slots"].copy_(torch.tensor([1, 3, 0, 2], dtype=torch.int32))
    step.inputs["k_real"].fill_(3)
    step.run()
    for key in ("x_buf", "stock"):
        for idle in (2, 4):
            assert torch.equal(states[key][idle], start[key][idle]), (key, idle)
        for real in (1, 3, 0):
            assert not torch.equal(states[key][real], start[key][real]), (key, real)
    out = bucket(b.params, states, np.stack(_frames(3, seed=4)), [4, 2, 3], 4)
    assert out.shape == (4, 64, 64, 3)
    assert bucket.step_for(b.params, states, 4) is step
    assert {name: t.data_ptr() for name, t in step.inputs.items()} == ptrs
    assert step.inputs["slots"].tolist() == [4, 2, 3, 3] and int(step.inputs["k_real"]) == 3


# -- the static-buffer path against the JAX BatchScheduler -----------------------------

def test_scheduler_static_path_matches_the_jax_batch_scheduler(monkeypatch):
    """Two sessions, a join into the padded bucket of 4, prompt, t-index and
    guidance updates on one session each, a restart, a leave; every round
    two frames in flight per session.  The JAX session states are carried
    by ``states_from_jax`` at each claim and restart (the two frameworks
    draw different noise).  Every frame within 1 level of the JAX
    scheduler's."""
    monkeypatch.delenv("BATCHSCHED_PREWARM", raising=False)
    jb = JREG.load_model_bundle("tiny-test")
    jcfg = JREG.default_stream_config("tiny-test", **TURBO8)
    js = JBatchScheduler(jb.stream_models, jb.params, jcfg, jb.encode_prompt, max_sessions=4,
                         window_ms=10_000.0, prewarm=False, dp=1)
    pb = PREG.load_model_bundle("tiny-test", device="cpu",
                                params=bridge.params_from_jax(jax.tree.map(np.asarray, jb.params)))
    ps = BatchScheduler(pb.stream_models, pb.params,
                        PREG.default_stream_config("tiny-test", device="cpu", **TURBO8),
                        pb.encode_prompt, max_sessions=4, window_ms=10_000.0, device="cpu")
    sides = {"jax": (js, []), "port": (ps, [])}
    rng = np.random.default_rng(0)
    rounds = [0]

    def carry(slot):
        bridge.states_from_jax(jax.tree.map(np.asarray, js.states), ps.states, slots=[slot])

    def claim(prompt, seed):
        for name, (sched, sess) in sides.items():
            sess.append(sched.claim(f"{name}{len(sess)}", prompt=prompt, seed=seed))
        assert sides["jax"][1][-1].slot == sides["port"][1][-1].slot
        carry(sides["port"][1][-1].slot)

    def step(live):
        frames = [[rng.integers(0, 256, (64, 64, 3), np.uint8) for _ in range(2)] for _ in live]
        got = {}
        for name, (_, sess) in sides.items():
            # each session's two frames in flight, submitted round-robin
            handles = [[None, None] for _ in live]
            for j in range(2):
                for i, s in enumerate(live):
                    handles[i][j] = sess[s].submit(frames[i][j])
            got[name] = [[sess[s].fetch(h) for h in hs] for s, hs in zip(live, handles)]
        for a, b in zip(got["port"], got["jax"]):
            for x, y in zip(a, b):
                _close(x, y)
        rounds[0] += 1

    try:
        claim("a red cat", 11)
        claim("a blue dog", 22)
        step([0, 1])
        claim("green hills", 33)  # 3 sessions: the bucket of 4, padded
        step([0, 1, 2])
        for _, sess in sides.values():
            sess[1].update_prompt("a completely different prompt")
            sess[0].update_t_index_list([5])
            sess[2].update_guidance(guidance_scale=1.7, delta=0.8)
        step([0, 1, 2])
        for _, sess in sides.values():
            sess[0].restart()
        carry(sides["port"][1][0].slot)
        step([0, 1, 2])
        for _, sess in sides.values():
            sess[1].release()
        step([0, 2])
        assert rounds[0] == 5
        hist = ps.snapshot()["batchsched_occupancy_hist"]
        assert hist == js.snapshot()["batchsched_occupancy_hist"] and {"2", "3"} <= set(hist)
    finally:
        js.close()
        ps.close()


# -- in place: every state leaf keeps its storage ------------------------------------------

def _ptrs(state: dict) -> dict:
    out = {}
    for key, value in state.items():
        if isinstance(value, dict):
            out.update({f"{key}.{k}": v for k, v in _ptrs(value).items()})
        else:
            out[key] = value.data_ptr()
    return out


def test_engine_control_plane_writes_in_place():
    pipe = StreamDiffusionPipeline("tiny-test", device="cpu")
    state, ptrs = pipe.engine.state, _ptrs(pipe.engine.state)
    frame = _frames(1, seed=5)[0]
    pipe(frame)
    before = pipe.engine.state["cond"].clone()
    pipe.update_prompt("a red boat")
    assert not torch.equal(pipe.engine.state["cond"], before)
    pipe.update_t_index_list([12, 22, 32, 42])
    pipe.update_guidance(1.8, 0.7)
    assert float(pipe.engine.state["guidance"]) == pytest.approx(1.8)
    pipe(frame)
    pipe.restart()
    pipe(frame)
    assert pipe.engine.state is state and _ptrs(pipe.engine.state) == ptrs


def test_scheduler_control_plane_writes_in_place(port_bundle):
    b = port_bundle
    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    sched = BatchScheduler(b.stream_models, b.params, cfg, b.encode_prompt, max_sessions=2,
                           device="cpu")
    try:
        states, ptrs = sched.states, _ptrs(sched.states)
        a, c = sched.claim("a"), sched.claim("c")
        frame = _frames(1, seed=6)[0]
        a(frame)
        a.update_prompt("a new prompt")
        a.update_t_index_list([10, 20, 30, 40])
        a.update_guidance(1.5, 0.5)
        sched.update_prompt("global")
        sched.update_guidance(1.3, 0.9)
        a.restart()
        c.release()
        sched.claim("again")
        a(frame)
        assert sched.states is states and _ptrs(sched.states) == ptrs
    finally:
        sched.close()


def test_adapter_swaps_write_the_bank_in_place(port_bundle):
    """A styled claim, per-session and global swaps, a clear, a restart and a
    release and claim: every state leaf, the factor bank's too, keeps its
    storage (a captured graph reads the live bank at every replay)."""
    b = port_bundle
    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    sched = BatchScheduler(b.stream_models, b.params, cfg, b.encode_prompt, max_sessions=2,
                           device="cpu", adapters=_style_registry(b, 3))
    try:
        states, ptrs = sched.states, _ptrs(sched.states)
        assert any(k.startswith("adapters.") for k in ptrs)
        a, c = sched.claim("a", adapter="style"), sched.claim("c")
        frame = _frames(1, seed=8)[0]
        a(frame)
        c.update_adapter("style")
        a.update_adapter(None)
        sched.update_adapter("style")
        a.restart()
        c.release()
        sched.claim("again", adapter=None)
        a(frame)
        assert sched.states is states and _ptrs(sched.states) == ptrs
        assert a.adapter == "style" and sched.adapter_swaps_total == 4
    finally:
        sched.close()


def test_multipeer_control_plane_writes_in_place(port_bundle):
    b = port_bundle
    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    mp = MultiPeerEngine(b.stream_models, b.params, cfg, b.encode_prompt, max_peers=2,
                         device="cpu").start("default")
    states, ptrs = mp.states, _ptrs(mp.states)
    mp.prewarm_buckets()
    slot = mp.connect("peer")
    frames = np.stack(_frames(2, seed=7))
    mp.step_all(frames)
    mp.update_prompt(slot, "another")
    mp.update_t_index(slot, [10, 20, 30, 40])
    mp.disconnect(slot)
    mp.connect("again")
    mp.step_all(frames)
    assert mp.states is states and _ptrs(mp.states) == ptrs
