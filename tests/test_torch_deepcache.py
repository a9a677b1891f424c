"""DeepCache (UNET_CACHE / --unet-cache) in the port against the JAX package,
on the CPU (tiny-test, f32, the JAX weights carried by ``bridge``).

* The UNet: ``deep_cache="capture"`` then ``"use"`` on the same inputs is
  the full pass exactly (the port alone, ``torch.equal``); against the JAX
  forward, the capture's output and deep feature and the cached pass over
  the JAX deep feature agree within f32 round-off (rtol 1e-4, atol 1e-4:
  a UNet of convolutions in two frameworks' f32).  The JAX refusals are
  kept: ``cached_h`` missing, a skip mismatch, ControlNet residuals.
* The engine: the LCM ring (cfg self) at N = 2 and 3 with a prompt update,
  a t-index update and ``reset_cache_cadence`` mid-stream, the JAX engine's
  prepared state (its pre-sized ``unet_cache`` too) handed over: every
  frame within 1 uint8 level of the JAX engine's, the cadence's tick equal
  after every frame, and the cached frames not the full stream's; the JAX
  engine's captured deep feature crosses bit for bit through
  ``state_from_jax``, ``states_from_jax`` and the wire codec.
* The batch scheduler's global cadence with a mid-cadence join (the JAX
  ``test_deepcache_uncaptured_rider_forces_capture``): the same variant for
  every bucket step as the JAX scheduler, every frame within 1 level.
* ``--multipeer``: one peer of two through the JAX and the port
  MultiPeerEngine at N = 3, a prompt update mid-stream: within 1 level.
* The refusals: sequential mode, a bundle with no DeepCache pair,
  ControlNet, a bad UNET_CACHE spelling (the JAX messages); txt2img warns.
* The quality gate (the JAX ``tests/test_deepcache_quality.py`` on the
  port): interval 3 tracks the full stream on ``moving_scene``, PSNR >= 40
  dB and SSIM >= 0.99, and interval 3 is not worse than interval 5 by
  more than 3 dB.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.models import unet as JU
from ai_rtc_agent_tpu.parallel import checkpoint as JC
from ai_rtc_agent_tpu.parallel.multipeer import MultiPeerEngine as JMultiPeerEngine
from ai_rtc_agent_tpu.stream import engine as JENG
from ai_rtc_agent_tpu.stream.scheduler import BatchScheduler as JBatchScheduler
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.models import unet as PU
from ai_rtc_agent_tpu_torch.parallel import checkpoint as PC
from ai_rtc_agent_tpu_torch.parallel.multipeer import MultiPeerEngine
from ai_rtc_agent_tpu_torch.stream import engine as PENG
from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline
from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler
from ai_rtc_agent_tpu_torch.utils.quality import moving_scene, psnr, ssim

TURBO = dict(t_index_list=(0,), num_inference_steps=1, timestep_spacing="trailing",
             scheduler="turbo", cfg_type="none")
N_FRAMES = 8
# (frame index, action) before that frame, on both engines
UPDATES = {3: "prompt", 5: "t_index", 6: "reset"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _frames(n, seed, size=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(n)]


def _levels(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max())


@pytest.fixture(scope="module")
def jax_bundle():
    return JREG.load_model_bundle("tiny-test")


@pytest.fixture(scope="module")
def port_bundle(jax_bundle):
    return PREG.load_model_bundle("tiny-test", device="cpu",
                                  params=bridge.params_from_jax(_np(jax_bundle.params)))


def _port_cfg(**kw):
    return PREG.default_stream_config("tiny-test", device="cpu", **kw)


# -- the UNet ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unet_inputs():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    t = np.array([999, 500], np.int32)
    ctx = rng.normal(size=(2, 16, 32)).astype(np.float32)
    return x, t, ctx


def test_capture_then_use_is_exact_and_matches_jax(jax_bundle, port_bundle, unet_inputs):
    x, t, ctx = unet_inputs
    cfg = port_bundle.unet_cfg
    p = port_bundle.params["unet"]
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    with torch.inference_mode():
        full = PU.apply_unet(p, *args, cfg)
        out, deep = PU.apply_unet(p, *args, cfg, deep_cache="capture")
        used = PU.apply_unet(p, *args, cfg, deep_cache="use", cached_h=deep)
    assert torch.equal(out, full) and torch.equal(used, full)
    assert tuple(deep.shape) == PU.deep_cache_shape(cfg, x.shape)
    jp, jcfg = jax_bundle.params["unet"], jax_bundle.unet_cfg
    jargs = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    capture = jax.jit(lambda p, *a: JU.apply_unet(p, *a, jcfg, deep_cache="capture"))
    use = jax.jit(lambda p, h, *a: JU.apply_unet(p, *a, jcfg, deep_cache="use", cached_h=h))
    jout, jdeep = capture(jp, *jargs)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(deep.numpy(), np.asarray(jdeep), rtol=1e-4, atol=1e-4)
    # the cached pass over JAX's deep feature, and over another feature
    other = np.asarray(jdeep) * 0.5
    for h in (np.asarray(jdeep), other):
        want = use(jp, jnp.asarray(h), *jargs)
        with torch.inference_mode():
            got = PU.apply_unet(p, *args, cfg, deep_cache="use",
                                cached_h=torch.from_numpy(np.array(h)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_the_unet_keeps_the_jax_refusals(jax_bundle, port_bundle, unet_inputs):
    x, t, ctx = unet_inputs
    cfg, p = port_bundle.unet_cfg, port_bundle.params["unet"]
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    jargs = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    jp, jcfg = jax_bundle.params["unet"], jax_bundle.unet_cfg
    deep = torch.zeros(PU.deep_cache_shape(cfg, x.shape))
    cases = [
        (dict(deep_cache="use"), dict(deep_cache="use"), "requires cached_h"),
        (dict(deep_cache="use", cached_h=deep, down_residuals=[deep]),
         dict(deep_cache="use", cached_h=jnp.asarray(deep.numpy()),
              down_residuals=[jnp.asarray(deep.numpy())]), "incompatible with ControlNet"),
    ]
    for kw, jkw, match in cases:
        with pytest.raises(ValueError, match=match) as got:
            PU.apply_unet(p, *args, cfg, **kw)
        with pytest.raises(ValueError, match=match) as want:
            JU.apply_unet(jp, *jargs, jcfg, **jkw)
        assert str(got.value) == str(want.value)
    short = dict(p, up_blocks=p["up_blocks"][:-1] + [dict(
        p["up_blocks"][-1], resnets=p["up_blocks"][-1]["resnets"][:-1],
        attentions=p["up_blocks"][-1]["attentions"][:-1])])
    jshort = dict(jp, up_blocks=jp["up_blocks"][:-1] + [dict(
        jp["up_blocks"][-1], resnets=jp["up_blocks"][-1]["resnets"][:-1],
        attentions=jp["up_blocks"][-1]["attentions"][:-1])])
    with pytest.raises(ValueError, match="skip mismatch") as got:
        PU.apply_unet(short, *args, cfg, deep_cache="use", cached_h=deep)
    with pytest.raises(ValueError, match="skip mismatch") as want:
        JU.apply_unet(jshort, *jargs, jcfg, deep_cache="use", cached_h=jnp.asarray(deep.numpy()))
    assert str(got.value) == str(want.value)


# -- the engine -----------------------------------------------------------------------

def _update(eng, i, t_index):
    kind = UPDATES.get(i)
    if kind == "prompt":
        eng.update_prompt("a dog in space")
    elif kind == "t_index":
        eng.update_t_index_list(t_index)
    elif kind == "reset":
        eng.reset_cache_cadence()


@pytest.mark.parametrize("interval", [2, 3])
def test_engine_cadence_and_resets_match_the_jax_engine(jax_bundle, port_bundle, interval):
    cfg = JREG.default_stream_config("tiny-test", unet_cache_interval=interval)
    t_index = [min(t + 5, cfg.num_inference_steps - 1) for t in cfg.t_index_list]
    jeng = JENG.StreamEngine(jax_bundle.stream_models, jax_bundle.params, cfg,
                             jax_bundle.encode_prompt)
    jeng.prepare("a cat", guidance_scale=1.4, delta=0.9, seed=1)
    state0 = _np(jeng.state)
    assert "unet_cache" in state0
    b = port_bundle
    peng = PENG.StreamEngine(b.stream_models, b.params, _port_cfg(unet_cache_interval=interval),
                             b.encode_prompt, device="cpu")
    full = PENG.StreamEngine(b.stream_models, b.params, _port_cfg(), b.encode_prompt,
                             device="cpu")
    peng.prepare("a cat")
    assert tuple(peng.state["unet_cache"].shape) == state0["unet_cache"].shape
    peng.state = bridge.state_from_jax(state0)
    full.state = bridge.state_from_jax({k: v for k, v in state0.items() if k != "unet_cache"})
    away = 0
    for i, f in enumerate(_frames(N_FRAMES, seed=interval)):
        for eng in (jeng, peng, full):
            _update(eng, i, t_index)
        want = jeng(f)
        got = peng(f)
        assert _levels(got, want) <= 1, f"frame {i}"
        assert peng._tick == jeng._tick, f"frame {i}"
        away = max(away, _levels(got, full(f)))
    assert away > 1  # the cached steps are not the full stream
    # a JAX row's captured deep feature crosses bit for bit: the bridge, the
    # stacked bridge and the wire codec
    deep = np.asarray(jeng.state["unet_cache"])
    assert np.abs(deep).max() > 0
    stacked = {"unet_cache": torch.zeros((2,) + deep.shape, dtype=torch.float32)}
    for got in (bridge.state_from_jax({"unet_cache": deep})["unet_cache"],
                bridge.states_from_jax({"unet_cache": deep[None]}, stacked, slots=[0])[
                    "unet_cache"][0],
                PC.deserialize_pytree(JC.serialize_pytree({"unet_cache": deep}))["unet_cache"]):
        assert got.dtype == torch.float32 and got.numpy().tobytes() == deep.tobytes()


def test_the_pipeline_warms_both_graphs_and_captures_first(port_bundle):
    pipe = StreamDiffusionPipeline("tiny-test", config=_port_cfg(unet_cache_interval=3),
                                   device="cpu", params=port_bundle.params)
    eng = pipe.engine
    assert eng.variants == ("capture", "cached") and eng._tick == 0
    assert sorted(eng.keys) == ["cached", "capture"]
    assert all(f"variant-{v}" in k and "dcache-3" in k for v, k in eng.keys.items())
    assert sorted(eng.graph_cache.status()) == sorted(eng.keys.values())
    for f in _frames(4, seed=9):
        pipe(f)
    assert eng._tick == 4


# -- the batch scheduler and --multipeer -----------------------------------------------

def test_scheduler_cadence_with_a_mid_cadence_join_matches_the_jax_scheduler(jax_bundle,
                                                                               port_bundle):
    jcfg = JREG.default_stream_config("tiny-test", unet_cache_interval=3, **TURBO)
    js = JBatchScheduler(jax_bundle.stream_models, jax_bundle.params, jcfg,
                         jax_bundle.encode_prompt, max_sessions=2, window_ms=10_000.0,
                         prewarm=False, dp=1)
    b = port_bundle
    ps = BatchScheduler(b.stream_models, b.params, _port_cfg(unet_cache_interval=3, **TURBO),
                        b.encode_prompt, max_sessions=2, window_ms=10_000.0, device="cpu")
    seen = {"jax": [], "port": []}
    jorig, porig = js._bucket_step, ps._next_variant_locked

    def jspy(k, variant="full"):
        seen["jax"].append((k, variant))
        return jorig(k, variant)

    def pspy(slots):
        variant = porig(slots)
        seen["port"].append((ps._bucket_for(len(slots)), variant))
        return variant

    js._bucket_step = jspy
    ps._next_variant_locked = pspy
    try:
        ja = js.claim("a", prompt="pa", seed=1)
        pa = ps.claim("a", prompt="pa", seed=1)
        bridge.states_from_jax(_np(js.states), ps.states, slots=[ja.slot])
        frames = [_frames(9, seed=20), _frames(9, seed=21)]

        def step(pairs, j):
            out = {}
            for name, sess in (("jax", [s for s, _ in pairs]), ("port", [s for _, s in pairs])):
                handles = [s.submit(frames[i][j]) for i, s in enumerate(sess)]
                out[name] = [s.fetch(h) for s, h in zip(sess, handles)]
            for a, bb in zip(out["port"], out["jax"]):
                assert _levels(a, bb) <= 1, j

        for j in range(2):  # a alone: capture, cached
            step([(ja, pa)], j)
        jc = js.claim("c", prompt="pc", seed=9)
        pc = ps.claim("c", prompt="pc", seed=9)
        bridge.states_from_jax(_np(js.states), ps.states, slots=[jc.slot])
        assert jc.slot in js._uncaptured and pc.slot in ps._uncaptured
        js._tick = ps._tick = 4  # mid-cadence: unforced, the cached graph would run
        for j in range(2, 5):  # the uncaptured rider forces a capture; then the cadence
            step([(ja, pa), (jc, pc)], j)
        ja.update_prompt("a watercolor fox")
        pa.update_prompt("a watercolor fox")
        for j in range(5, 7):
            step([(ja, pa), (jc, pc)], j)
        assert seen["port"][2] == (2, "capture")
        assert seen["port"] == seen["jax"], seen
        assert {v for _, v in seen["port"]} == {"capture", "cached"}
        assert ps.snapshot_fingerprint() == js.snapshot_fingerprint()
    finally:
        js.close()
        ps.close()


def test_multipeer_cadence_matches_the_jax_peer_engine(jax_bundle, port_bundle):
    jcfg = JREG.default_stream_config("tiny-test", unet_cache_interval=3, **TURBO)
    jm = JMultiPeerEngine(jax_bundle.stream_models, jax_bundle.params, jcfg,
                          jax_bundle.encode_prompt, max_peers=2).start("p")
    b = port_bundle
    pm = MultiPeerEngine(b.stream_models, b.params, _port_cfg(unet_cache_interval=3, **TURBO),
                         b.encode_prompt, max_peers=2, device="cpu").start("p")
    assert sorted(pm.bucket_keys()) == [(1, "cached"), (1, "capture"), (2, "cached"),
                                        (2, "capture")]
    js, ps = jm.connect("a cat", seed=3), pm.connect("a cat", seed=3)
    assert js == ps
    bridge.states_from_jax(_np(jm.states), pm.states)
    frames = _frames(7, seed=30)
    for i, f in enumerate(frames):
        if i == 4:
            for m in (jm, pm):
                m.update_prompt(js, "a dog in space")
        batch = np.stack([f, f])
        got, want = pm.step_all(batch)[js], np.asarray(jm.step_all(batch))[js]
        assert _levels(got, want) <= 1, i
        assert pm._tick == jm._tick, i


# -- the refusals ---------------------------------------------------------------------

def _raised(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_variants_keep_the_jax_refusals(jax_bundle, port_bundle, monkeypatch, caplog):
    seq = dict(use_denoising_batch=False, unet_cache_interval=3)
    assert _raised(lambda: PENG.make_step_fn(port_bundle.stream_models, _port_cfg(**seq),
                                             "capture")) == \
        _raised(lambda: JENG.make_step_fn(jax_bundle.stream_models,
                                          JREG.default_stream_config("tiny-test", **seq),
                                          "capture"))
    bare = dataclasses.replace(port_bundle.stream_models, unet_capture=None, unet_cached=None)
    jbare = dataclasses.replace(jax_bundle.stream_models, unet_capture=None, unet_cached=None)
    cfg3 = dict(unet_cache_interval=3)
    assert _raised(lambda: PENG.make_step_fn(bare, _port_cfg(**cfg3), "cached")) == _raised(
        lambda: JENG.make_step_fn(jbare, JREG.default_stream_config("tiny-test", **cfg3),
                                  "cached"))
    cnet = dict(use_controlnet=True, unet_cache_interval=3)
    assert _raised(lambda: _port_cfg(**cnet)) == _raised(
        lambda: JREG.default_stream_config("tiny-test", **cnet))
    for spelling in ("deepcashe:3", "three", "deepcache:x"):
        monkeypatch.setenv("UNET_CACHE", spelling)
        assert _raised(_port_cfg) == _raised(lambda: JREG.default_stream_config("tiny-test"))
    for spelling in ("3", "deepcache:3"):
        monkeypatch.setenv("UNET_CACHE", spelling)
        assert _port_cfg().unet_cache_interval == 3
        assert _port_cfg(unet_cache_interval=2).unet_cache_interval == 2  # an override wins
    with caplog.at_level(logging.WARNING):
        assert _port_cfg(mode="txt2img").mode == "txt2img"
    assert any("UNET_CACHE with txt2img" in r.message for r in caplog.records)


# -- the quality gate ---------------------------------------------------------------------

WARMUP = 6  # ring depth 4 + slack: compare steady-state outputs only
QUALITY_FRAMES = 18


def _stream(port_bundle, interval):
    b = port_bundle
    eng = PENG.StreamEngine(b.stream_models, b.params, _port_cfg(unet_cache_interval=interval),
                            b.encode_prompt, device="cpu")
    eng.prepare("a moving scene", seed=7)
    return [eng(f) for f in moving_scene(QUALITY_FRAMES, 64, 64)][WARMUP:]


@pytest.fixture(scope="module")
def curves(port_bundle):
    full = _stream(port_bundle, 0)
    rows = {}
    for interval in (3, 5):
        cached = _stream(port_bundle, interval)
        rows[interval] = (float(np.mean([psnr(a, b) for a, b in zip(full, cached)])),
                          float(np.mean([ssim(a, b) for a, b in zip(full, cached)])))
    return rows


def test_interval3_tracks_the_full_stream(curves):
    for interval, (p, s) in sorted(curves.items()):
        print(f"DEEPCACHE port interval={interval} psnr={p:.2f}dB ssim={s:.4f}")
        assert np.isfinite(p) and 0.0 <= s <= 1.0
    p3, s3 = curves[3]
    assert p3 >= 40.0, f"interval-3 PSNR collapsed: {p3:.2f} dB"
    assert s3 >= 0.99, f"interval-3 SSIM collapsed: {s3:.4f}"
    assert p3 > curves[5][0] - 3.0
