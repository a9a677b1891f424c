"""ControlNet (``--controlnet``, ``--annotator``) in the port against the JAX
package, on the CPU: tiny-test (``latent_scale`` 4, ``num_down`` 2), f32,
the JAX weights carried by ``bridge`` with every zero conv and the cond
embedding's ``conv_out`` set non-zero on both sides (zero, they make the
ControlNet an exact no-op and every check would pass without it), the JAX
states handed over by ``state_from_jax`` / ``states_from_jax``.

* The modules: ``canny_soft`` (atol 1e-5), ``apply_controlnet``'s residuals
  with a scalar and a per-row scale and ``apply_unet`` with them (rtol
  1e-4, atol 1e-4: convolutions in two frameworks' f32), the key map at
  SD1.5's full geometry and at tiny, a ControlNet snapshot loaded bit for
  bit, ``cast_params`` quantizing the same leaves.
* The engine, ring cfg self with each annotator and full CFG and sequential
  mode, step for step against the JAX engine: every frame within 1 uint8
  level, the conditioning ring within 1e-4; the ring rotates with the
  latent ring; scale 0 is the plain engine within 1 level and scale 1
  moves it.
* The batch scheduler at k = 2 (and at fbs 2) against the JAX
  ``BatchScheduler`` fed the same rows, and ``--multipeer``: within 1
  level; the keys separate ControlNet graphs (and each annotator's) from
  plain ones, as the JAX keys do.
* The refusals: w8 params with the HED annotator fail on both packages
  (the JAX engine with a KeyError at its first step, the port at build
  with a ValueError naming the combination), ``use_controlnet`` without a
  ControlNet, UNET_CACHE with ControlNet.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.models import controlnet as JCN
from ai_rtc_agent_tpu.models import loader as JLD
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.models import unet as JU
from ai_rtc_agent_tpu.parallel.multipeer import MultiPeerEngine as JMultiPeerEngine
from ai_rtc_agent_tpu.stream import engine as JENG
from ai_rtc_agent_tpu.stream import pipeline as JPIPE
from ai_rtc_agent_tpu.stream.scheduler import BatchScheduler as JBatchScheduler
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.aot.cache import stream_engine_key
from ai_rtc_agent_tpu_torch.models import controlnet as PCN
from ai_rtc_agent_tpu_torch.models import loader as PLD
from ai_rtc_agent_tpu_torch.models import quant as PQ
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.models import unet as PU
from ai_rtc_agent_tpu_torch.parallel.multipeer import MultiPeerEngine
from ai_rtc_agent_tpu_torch.server.multipeer_serving import MultiPeerPipeline
from ai_rtc_agent_tpu_torch.stream import engine as PENG
from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline
from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

CNET = "tiny-cnet"
TURBO = dict(t_index_list=(0,), num_inference_steps=1, timestep_spacing="trailing",
             scheduler="turbo", cfg_type="none")
N_FRAMES = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _frames(n, seed, size=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(n)]


def _levels(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max())


def wake_zero_convs(cnet: dict, seed: int = 0) -> dict:
    """Every zero conv and the cond embedding's conv_out of a JAX ControlNet
    tree filled from a numpy seed (kernel N(0, 0.3), bias N(0, 0.1)), in
    place: the residuals reach the UNet."""
    rng = np.random.default_rng(seed)
    for zc in cnet["zero_convs"] + [cnet["mid_zero_conv"], cnet["cond_embedding"]["conv_out"]]:
        zc["kernel"] = jnp.asarray(0.3 * rng.standard_normal(zc["kernel"].shape), jnp.float32)
        zc["bias"] = jnp.asarray(0.1 * rng.standard_normal(zc["bias"].shape), jnp.float32)
    return cnet


@pytest.fixture(scope="module")
def jax_bundle():
    b = JREG.load_model_bundle("tiny-test", controlnet=CNET, annotator="hed")
    wake_zero_convs(b.params["controlnet"])
    return b


@pytest.fixture(scope="module")
def port_bundle(jax_bundle):
    return PREG.load_model_bundle("tiny-test", device="cpu", controlnet=CNET, annotator="hed",
                                  params=bridge.params_from_jax(_np(jax_bundle.params)))


def _jcfg(**kw):
    return JREG.default_stream_config("tiny-test", use_controlnet=True, **kw)


def _pcfg(**kw):
    return PREG.default_stream_config("tiny-test", device="cpu", use_controlnet=True, **kw)


# -- the modules ------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 23, 17, 3)])
def test_canny_soft_matches_jax(shape):
    img = np.random.default_rng(0).random(shape, dtype=np.float32)
    want = np.asarray(JCN.canny_soft(jnp.asarray(img)))
    got = PCN.canny_soft(torch.from_numpy(img))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(got[..., 0], got[..., 2])


@pytest.fixture(scope="module")
def cnet_inputs():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    t = np.array([999, 500], np.int32)
    ctx = rng.normal(size=(2, 16, 32)).astype(np.float32)
    img = rng.random((2, 64, 64, 3), dtype=np.float32)
    return x, t, ctx, img


@pytest.mark.parametrize("scale", [1.0, 0.6, "per_row"])
def test_controlnet_residuals_and_the_conditioned_unet_match_jax(jax_bundle, port_bundle,
                                                                 cnet_inputs, scale):
    x, t, ctx, img = cnet_inputs
    jcfg, pcfg = jax_bundle.unet_cfg, port_bundle.unet_cfg
    jscale = jnp.asarray([0.5, 1.5], jnp.float32)[:, None, None, None] \
        if scale == "per_row" else scale
    pscale = torch.tensor([0.5, 1.5]) if scale == "per_row" else scale
    jp, pp = jax_bundle.params, port_bundle.params
    jdown, jmid = JCN.apply_controlnet(jp["controlnet"], *map(jnp.asarray, (x, t, ctx, img)),
                                       jcfg, conditioning_scale=jscale)
    args = [torch.from_numpy(a) for a in (x, t, ctx)]
    with torch.inference_mode():
        down, mid = PCN.apply_controlnet(pp["controlnet"], *args, torch.from_numpy(img), pcfg,
                                         conditioning_scale=pscale)
        assert len(down) == len(jdown) == len(PCN._skip_channels(pcfg))
        for g, w in zip(down + [mid], list(jdown) + [jmid]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
        assert float(mid.abs().max()) > 0.1  # the residuals are not zero
        got = PU.apply_unet(pp["unet"], *args, pcfg, down_residuals=down, mid_residual=mid)
        plain = PU.apply_unet(pp["unet"], *args, pcfg)
    want = JU.apply_unet(jp["unet"], *map(jnp.asarray, (x, t, ctx)), jcfg,
                         down_residuals=jdown, mid_residual=jmid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert float((got - plain).abs().max()) > 1e-3


def test_the_unet_refuses_a_wrong_count_of_residuals_as_jax_does(jax_bundle, port_bundle,
                                                                 cnet_inputs):
    x, t, ctx, _ = cnet_inputs
    with pytest.raises(ValueError) as got:
        PU.apply_unet(port_bundle.params["unet"], *(torch.from_numpy(a) for a in (x, t, ctx)),
                      port_bundle.unet_cfg, down_residuals=[torch.zeros(1)])
    with pytest.raises(ValueError) as want:
        JU.apply_unet(jax_bundle.params["unet"], *map(jnp.asarray, (x, t, ctx)),
                      jax_bundle.unet_cfg, down_residuals=[jnp.zeros(1)])
    assert str(got.value) == str(want.value)


def test_an_untrained_controlnet_is_an_exact_no_op(cnet_inputs):
    x, t, ctx, img = cnet_inputs
    cfg = PU.UNetConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    p = PCN.init_controlnet(gen, cfg, num_down=2)
    down, mid = PCN.apply_controlnet(p, *(torch.from_numpy(a) for a in (x, t, ctx)),
                                     torch.from_numpy(img), cfg)
    assert all(float(r.abs().max()) == 0.0 for r in down + [mid])
    shapes = jax.eval_shape(lambda: JCN.init_controlnet(jax.random.PRNGKey(0),
                                                        JU.UNetConfig.tiny(), num_down=2))
    want = bridge.params_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    assert jax.tree.map(lambda a: tuple(a.shape), want) == jax.tree.map(
        lambda a: tuple(a.shape), p)


@pytest.mark.parametrize("geometry", ["sd15", "tiny"])
def test_controlnet_key_map_equals_the_jax_map(geometry):
    nd = {"sd15": 3, "tiny": 2}[geometry]
    pm = PLD.controlnet_key_map(getattr(PU.UNetConfig, geometry)(), nd)
    assert pm == JLD.controlnet_key_map(getattr(JU.UNetConfig, geometry)(), nd)
    assert PLD.unet_key_map(getattr(PU.UNetConfig, geometry)()) == JLD.unet_key_map(
        getattr(JU.UNetConfig, geometry)())
    assert "controlnet_cond_embedding.blocks.5.weight" in pm or nd < 3
    assert pm["controlnet_mid_block.weight"] == ("mid_zero_conv", "kernel")


def test_a_controlnet_snapshot_loads_bit_for_bit_on_both_packages(port_bundle, tmp_path):
    """The port's tree written through controlnet_key_map as a diffusers-named
    snapshot (its zero convs non-zero): load_model_bundle(controlnet=<dir>)
    holds every leaf bit for bit, and the JAX bundle loads the same file to
    the same values."""
    cfg = port_bundle.unet_cfg
    tree = port_bundle.params["controlnet"]
    km = PLD.controlnet_key_map(cfg, 2)
    PLD.write_safetensors(str(tmp_path / "diffusion_pytorch_model.safetensors"),
                          PLD.tree_to_state_dict(tree, km))
    got = PREG.load_model_bundle("tiny-test", device="cpu", controlnet=str(tmp_path))
    jgot = JREG.load_model_bundle("tiny-test", controlnet=str(tmp_path))
    carried = bridge.params_from_jax(_np(jgot.params["controlnet"]))
    leaves = [jax.tree.leaves(_np(t)) for t in (got.params["controlnet"], tree, carried)]
    assert len(leaves[0]) == len(leaves[1]) == len(leaves[2]) == len(
        PLD.tree_to_state_dict(tree, km))
    for a, b, c in zip(*leaves):
        assert a.dtype == np.float32 and a.tobytes() == b.tobytes() == c.tobytes()
    assert got.stream_models.controlnet is not None


def test_cast_params_quantizes_the_same_controlnet_leaves(jax_bundle, port_bundle, monkeypatch):
    monkeypatch.setenv("QUANT_WEIGHTS", "w8")
    monkeypatch.setenv("QUANT_MIN_SIZE", "256")
    jq = JREG.cast_params({"controlnet": jax_bundle.params["controlnet"]}, "float32")
    pq = PREG.cast_params({"controlnet": port_bundle.params["controlnet"]}, "float32")

    def int8_paths(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from int8_paths(v, path + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from int8_paths(v, path + (i,))
        elif tree is not None and str(tree.dtype) in ("int8", "torch.int8"):
            yield path

    want = set(int8_paths(_np(jq)))
    assert want and set(int8_paths(pq)) == want
    assert any(p[1] == "zero_convs" for p in want)
    assert PQ.quantized_bytes_saved(pq) > 0


# -- the engine -------------------------------------------------------------------------

def _jax_engine(b, cfg):
    eng = JENG.StreamEngine(b.stream_models, b.params, cfg, b.encode_prompt, jit_compile=False,
                            donate=False)
    eng.prepare("a cat", guidance_scale=1.4, delta=0.9, seed=1)
    return eng


def _port_engine(b, cfg, state):
    eng = PENG.StreamEngine(b.stream_models, b.params, cfg, b.encode_prompt, device="cpu")
    eng.state = bridge.state_from_jax(state)
    return eng


ENGINE_CASES = [("canny", "ring"), ("hed", "ring"), ("identity", "ring"), ("canny", "full"),
                ("hed", "sequential")]


@pytest.mark.parametrize("annotator,mode", ENGINE_CASES)
def test_engine_matches_the_jax_engine(jax_bundle, port_bundle, annotator, mode):
    over = {"ring": {}, "full": dict(cfg_type="full"),
            "sequential": dict(use_denoising_batch=False)}[mode]
    jeng = _jax_engine(jax_bundle, _jcfg(annotator=annotator, **over))
    state0 = _np(jeng.state)
    assert state0["cnet_cond"].shape == (3, 64, 64, 3) and float(state0["cnet_scale"]) == 1.0
    peng = _port_engine(port_bundle, _pcfg(annotator=annotator, **over), state0)
    peng.prepare("a cat")  # the port's own state has the JAX structure
    assert {k: tuple(v.shape) for k, v in peng.state.items() if k != "coeffs"} == {
        k: v.shape for k, v in state0.items() if k != "coeffs"}
    peng.state = bridge.state_from_jax(state0)
    for i, f in enumerate(_frames(N_FRAMES, seed=10 + ENGINE_CASES.index((annotator, mode)))):
        if i == 2:
            jeng.update_controlnet_scale(0.7)
            peng.update_controlnet_scale(0.7)
        assert _levels(peng(f), jeng(f)) <= 1, f"frame {i}"
    np.testing.assert_allclose(peng.state["cnet_cond"].numpy(), np.asarray(jeng.state["cnet_cond"]),
                               rtol=1e-4, atol=1e-4)
    for key in ("x_buf", "stock"):
        np.testing.assert_allclose(peng.state[key].numpy(), np.asarray(jeng.state[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_the_cond_ring_rotates_with_the_latent_ring(port_bundle):
    """The JAX ``test_cond_ring_rotates_with_latent_ring`` on the port: the
    ring's head is the latest frame's annotation, which moves one slot when
    the next frame enters."""
    eng = PENG.StreamEngine(port_bundle.stream_models, port_bundle.params, _pcfg(),
                            port_bundle.encode_prompt, device="cpu")
    eng.prepare("ctrl", guidance_scale=1.0, seed=3)
    f1, f2 = _frames(2, seed=3)
    eng(f1)
    ring1 = eng.state["cnet_cond"].clone()
    eng(f2)
    ring2 = eng.state["cnet_cond"]
    want = JCN.canny_soft(jnp.asarray(f1[None], jnp.float32) / 255.0)
    np.testing.assert_allclose(ring1[0].numpy(), np.asarray(want)[0], atol=1e-5)
    assert torch.equal(ring2[1], ring1[0]) and torch.equal(ring2[2], ring1[1])


def test_scale_zero_is_the_plain_engine_and_the_controlnet_moves_it(port_bundle):
    b = port_bundle
    plain = PENG.StreamEngine(b.stream_models, b.params, PREG.default_stream_config(
        "tiny-test", device="cpu"), b.encode_prompt, device="cpu").prepare("ctrl", seed=3)
    conditioned = PENG.StreamEngine(b.stream_models, b.params, _pcfg(), b.encode_prompt,
                                    device="cpu").prepare("ctrl", seed=3)
    off = PENG.StreamEngine(b.stream_models, b.params, _pcfg(), b.encode_prompt,
                            device="cpu").prepare("ctrl", seed=3)
    off.update_controlnet_scale(0.0)
    moved = 0
    for f in _frames(4, seed=5):
        want = plain(f)
        assert _levels(off(f), want) <= 1
        moved = max(moved, _levels(conditioned(f), want))
    assert moved > 1
    with pytest.raises(RuntimeError, match="without use_controlnet"):
        plain.update_controlnet_scale(0.5)


# -- the batch scheduler and --multipeer ---------------------------------------------------

@pytest.mark.parametrize("fbs,annotator", [(1, "canny"), (2, "hed")])
def test_scheduler_matches_the_jax_batch_scheduler(jax_bundle, port_bundle, fbs, annotator):
    """Two sessions in the bucket of 2 (at fbs 2 each session's two frames
    one row of its slot), the JAX rows carried across, a different scale on
    one session: every frame within 1 level, the rings within 1e-4."""
    over = dict(annotator=annotator, frame_buffer_size=fbs)
    js = JBatchScheduler(jax_bundle.stream_models, jax_bundle.params, _jcfg(**over),
                         jax_bundle.encode_prompt, max_sessions=2, window_ms=10_000.0,
                         prewarm=False, dp=1)
    ps = BatchScheduler(port_bundle.stream_models, port_bundle.params, _pcfg(**over),
                        port_bundle.encode_prompt, max_sessions=2, window_ms=10_000.0,
                        device="cpu")
    try:
        jsess = [js.claim(f"j{i}", prompt=p, seed=i) for i, p in enumerate(("a cat", "a dog"))]
        psess = [ps.claim(f"p{i}", prompt=p, seed=i) for i, p in enumerate(("a cat", "a dog"))]
        js.states = dict(js.states, cnet_scale=js.states["cnet_scale"].at[jsess[1].slot].set(0.4))
        bridge.states_from_jax(_np(js.states), ps.states)
        assert float(ps.states["cnet_scale"][psess[1].slot]) == pytest.approx(0.4)
        streams = [_frames(3 * fbs, seed=70 + i) for i in range(2)]
        for j in range(0, 3 * fbs, fbs):
            got = {}
            for name, sess in (("jax", jsess), ("port", psess)):
                if fbs == 1:
                    handles = [s.submit(f[j]) for s, f in zip(sess, streams)]
                    got[name] = [[s.fetch(h)] for s, h in zip(sess, handles)]
                else:
                    handles = [s.submit_batch(f[j:j + fbs]) for s, f in zip(sess, streams)]
                    got[name] = [s.fetch_batch(h) for s, h in zip(sess, handles)]
            for a, b in zip(got["port"], got["jax"]):
                assert len(a) == len(b) == fbs
                for x, y in zip(a, b):
                    assert _levels(x, y) <= 1, j
        np.testing.assert_allclose(ps.states["cnet_cond"].numpy(),
                                   np.asarray(js.states["cnet_cond"], np.float32),
                                   rtol=1e-4, atol=1e-4)
        assert ps.snapshot_fingerprint() == js.snapshot_fingerprint()
    finally:
        js.close()
        ps.close()


def test_multipeer_matches_the_jax_peer_engine(jax_bundle, port_bundle):
    jm = JMultiPeerEngine(jax_bundle.stream_models, jax_bundle.params, _jcfg(**TURBO),
                          jax_bundle.encode_prompt, max_peers=2).start("p")
    pm = MultiPeerEngine(port_bundle.stream_models, port_bundle.params, _pcfg(**TURBO),
                         port_bundle.encode_prompt, max_peers=2, device="cpu").start("p")
    slots = [jm.connect(p, seed=i) for i, p in enumerate(("a cat", "a dog"))]
    assert [pm.connect(p, seed=i) for i, p in enumerate(("a cat", "a dog"))] == slots
    bridge.states_from_jax(_np(jm.states), pm.states)
    for a, b in zip(_frames(3, seed=80), _frames(3, seed=81)):
        batch = np.stack([a, b])
        got, want = pm.step_all(batch), np.asarray(jm.step_all(batch))
        for s in slots:
            assert _levels(got[s], want[s]) <= 1


def test_the_pipelines_take_a_controlnet(port_bundle):
    pipe = StreamDiffusionPipeline("tiny-test", device="cpu", params=port_bundle.params,
                                   controlnet=CNET)
    assert pipe.config.use_controlnet and pipe.bundle.stream_models.controlnet is not None
    assert pipe(_frames(1, seed=9)[0]).shape == (64, 64, 3)
    sched = BatchScheduler.from_pipeline(pipe, max_sessions=1)
    try:
        assert "cnet_cond" in sched.states and sched.states["cnet_cond"].shape[:2] == (1, 3)
    finally:
        sched.close()
    mp = MultiPeerPipeline("tiny-test", max_peers=1, device="cpu", params=port_bundle.params,
                           controlnet=CNET)
    try:
        assert mp.config.use_controlnet and "cnet_scale" in mp.engine.states
    finally:
        mp.close()


def test_keys_separate_controlnet_graphs_as_the_jax_keys_do():
    keys = {}
    for name, over in (("plain", {}), ("canny", dict(use_controlnet=True)),
                       ("hed", dict(use_controlnet=True, annotator="hed"))):
        pcfg = PREG.default_stream_config("tiny-test", device="cpu", **over)
        jcfg = dataclasses.replace(JREG.default_stream_config("tiny-test", **over),
                                   attn_impl=pcfg.attn_impl,
                                   use_fused_epilogue=pcfg.use_fused_epilogue)
        jkey = JENG.stream_engine_key("tiny-test", jcfg, sbucket=2)
        pkey = stream_engine_key("tiny-test", pcfg, sbucket=2)
        assert pkey.split("--v-")[0] == jkey.split("--v-")[0]
        keys[name] = pkey
    assert len(set(keys.values())) == 3
    assert "cnet-0" in keys["plain"] and "cnet-1canny" in keys["canny"] \
        and "cnet-1hed" in keys["hed"]


# -- the refusals -----------------------------------------------------------------------

def test_w8_with_the_hed_annotator_fails_on_both_packages(jax_bundle, port_bundle, monkeypatch):
    """QUANT_WEIGHTS=w8 quantizes HED's larger convs (QUANT_MIN_SIZE 1000 at
    TINY_STAGES: the 8->16 conv); the JAX engine raises KeyError 'kernel' at
    its first step, the port refuses at build, naming the combination."""
    monkeypatch.setenv("QUANT_WEIGHTS", "w8")
    monkeypatch.setenv("QUANT_MIN_SIZE", "1000")
    jq = JREG.cast_params(jax_bundle.params, "float32")
    assert "kernel_q" in jq["hed"]["block2"]["convs"][0]
    jeng = JENG.StreamEngine(jax_bundle.stream_models, jq, _jcfg(annotator="hed"),
                             jax_bundle.encode_prompt, jit_compile=False, donate=False)
    jeng.prepare("a cat", seed=1)
    with pytest.raises(KeyError, match="kernel"):
        jeng(_frames(1, seed=1)[0])
    pq = PREG.cast_params(port_bundle.params, "float32")
    for build in (
            lambda: PENG.StreamEngine(port_bundle.stream_models, pq, _pcfg(annotator="hed"),
                                      port_bundle.encode_prompt, device="cpu"),
            lambda: BatchScheduler(port_bundle.stream_models, pq, _pcfg(annotator="hed"),
                                   port_bundle.encode_prompt, max_sessions=1, device="cpu"),
            lambda: StreamDiffusionPipeline("tiny-test", device="cpu", params=port_bundle.params,
                                            controlnet=CNET, config=_pcfg(annotator="hed"))):
        with pytest.raises(ValueError, match="annotator='hed' with QUANT_WEIGHTS=w8"):
            build()
    # canny serves the same w8 params
    PENG.StreamEngine(port_bundle.stream_models, pq, _pcfg(), port_bundle.encode_prompt,
                      device="cpu")


def test_the_jax_refusals_are_kept(jax_bundle, port_bundle):
    def raised(fn, kind=ValueError) -> str:
        with pytest.raises(kind) as e:
            fn()
        return str(e.value)

    plain = PREG.load_model_bundle("tiny-test", device="cpu", params={
        k: v for k, v in port_bundle.params.items() if k in ("unet", "clip", "taesd")})
    jplain = JREG.load_model_bundle("tiny-test")
    assert raised(lambda: PENG.make_step_fn(plain.stream_models, _pcfg())) == raised(
        lambda: JENG.make_step_fn(jplain.stream_models, _jcfg()))
    assert raised(lambda: StreamDiffusionPipeline("tiny-test", device="cpu", config=_pcfg(),
                                                  params=plain.params)) == raised(
        lambda: JPIPE.StreamDiffusionPipeline("tiny-test", config=_jcfg()))
    assert raised(lambda: _pcfg(unet_cache_interval=2)) == raised(
        lambda: _jcfg(unet_cache_interval=2))
