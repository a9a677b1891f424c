"""The SDXL family in the port against the JAX package, on the CPU.

``tiny-xl-test`` is the JAX package's hermetic SDXL-style family: two text
towers (``tiny_dual`` and the projected ``tiny_g``) whose hidden states
concatenate into the cross-attention context, and a UNet with SDXL's
topology (no attention at the first tier) and its ``text_time`` addition
embedding fed by the second tower's pooled projection and six
micro-conditioning time ids.  Weights come from one JAX init and cross
through ``bridge.params_from_jax``; JAX states cross through
``bridge.state_from_jax`` / ``states_from_jax``; inputs come from numpy
seeds.  The JAX side runs as its own tests run on the CPU (plain XLA
attention, the composed epilogue); the port takes its kernels' plain
versions on CPU tensors.

Tolerances: the text towers, the embeddings and the UNet in f32 within
rtol 1e-4 / atol 1e-5 (1e-4 for the UNet's outputs); uint8 frames within 1
level (a pixel whose value lands within float noise of a rounding tie may
round either way, the class of tests/test_torch_stream.py); key maps,
shapes and snapshot bytes exactly.

At SDXL's full geometry only the key maps and the parameter shapes are
compared (a meta tree on the port's side, ``jax.eval_shape`` on the JAX
side): an f32 SDXL UNet is about 10 GB.
"""

import asyncio
import base64
import dataclasses
import re
from fractions import Fraction
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.adapters import AdapterRegistry as JAdapterRegistry
from ai_rtc_agent_tpu.media import frames as JF
from ai_rtc_agent_tpu.models import clip as JC
from ai_rtc_agent_tpu.models import loader as JLD
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.models import unet as JU
from ai_rtc_agent_tpu.parallel import checkpoint as JCK
from ai_rtc_agent_tpu.parallel.multipeer import MultiPeerEngine as JMultiPeerEngine
from ai_rtc_agent_tpu.server import agent as JA
from ai_rtc_agent_tpu.server import signaling as JS
from ai_rtc_agent_tpu.stream import engine as JENG
from ai_rtc_agent_tpu.stream.scheduler import BatchScheduler as JBatchScheduler
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.adapters import AdapterRegistry
from ai_rtc_agent_tpu_torch.media import frames as PF
from ai_rtc_agent_tpu_torch.models import clip as PC
from ai_rtc_agent_tpu_torch.models import loader as PLD
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.models import unet as PU
from ai_rtc_agent_tpu_torch.parallel import checkpoint as PCK
from ai_rtc_agent_tpu_torch.parallel.multipeer import MultiPeerEngine
from ai_rtc_agent_tpu_torch.server import agent as PA
from ai_rtc_agent_tpu_torch.server import signaling as PS
from ai_rtc_agent_tpu_torch.stream import engine as PENG
from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

XL = "tiny-xl-test"
PROMPT, SWAP = "an sdxl-style prompt", "a totally different style"
TURBO = dict(t_index_list=(0,), num_inference_steps=1, timestep_spacing="trailing",
             scheduler="turbo", cfg_type="none")
N_FRAMES, SWAP_AT = 5, 3  # the prompt swap lands before frame SWAP_AT


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _frames(n, seed, size=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(n)]


def _levels(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _close(got, want, rtol=1e-4, atol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def xl():
    """The module's one JAX tiny-xl-test bundle, and the port's over its
    weights (bridged)."""
    jb = JREG.load_model_bundle(XL)
    pb = PREG.load_model_bundle(XL, device="cpu", params=bridge.params_from_jax(_np(jb.params)))
    return SimpleNamespace(jb=jb, pb=pb)


# -- the models ----------------------------------------------------------------------

def test_configs_match_jax():
    """The SDXL and tiny configs field for field, and the family's."""
    for name in ("sdxl", "tiny_xl"):
        assert vars(getattr(PU.UNetConfig, name)()) == vars(getattr(JU.UNetConfig, name)())
    for name in ("sdxl_g", "tiny_dual", "tiny_g"):
        assert vars(getattr(PC.CLIPTextConfig, name)()) == vars(getattr(JC.CLIPTextConfig, name)())
    for fam in ("sdxl", "tinyxl"):
        (pu, pc, _), (ju, jc, _) = PREG._model_configs(fam), JREG._model_configs(fam)
        assert (vars(pu), vars(pc)) == (vars(ju), vars(jc))
    assert vars(PREG.clip2_config("sdxl")) == vars(JC.CLIPTextConfig.sdxl_g())
    assert PREG.clip2_config("sd21") is None


@pytest.mark.parametrize("tower", ["clip", "clip2"])
def test_text_towers_match_jax(xl, tower):
    """Both towers on the same ids: hidden, pooled and (the second) the
    projected pooled state."""
    cfg = (JREG._model_configs("tinyxl")[1] if tower == "clip" else JC.CLIPTextConfig.tiny_g())
    pcfg = (PREG._model_configs("tinyxl")[1] if tower == "clip" else PREG.clip2_config("tinyxl"))
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, cfg.max_length))
    want = JC.apply_clip_text(xl.jb.params[tower], jnp.asarray(ids, jnp.int32), cfg)
    got = PC.apply_clip_text(xl.pb.params[tower], torch.as_tensor(ids), pcfg)
    assert sorted(got) == sorted(want) == sorted(
        ["hidden", "pooled"] + (["projected"] if tower == "clip2" else []))
    for key in want:
        _close(got[key], want[key])


def _added(rng, cfg, b):
    return {"time_ids": rng.uniform(0, 128, (b, cfg.addition_num_time_ids)).astype(np.float32),
            "text_embeds": rng.standard_normal((b, cfg.addition_pooled_dim)).astype(np.float32)}


def test_time_cond_embedding_matches_jax(xl):
    """The timestep embedding plus the text_time addition; without
    ``added_cond`` both packages refuse."""
    cfg, pcfg = JU.UNetConfig.tiny_xl(), PU.UNetConfig.tiny_xl()
    rng = np.random.default_rng(2)
    t = np.array([999.0, 10.0, 500.0], np.float32)
    added = _added(rng, cfg, 3)
    want = JU.time_cond_embedding(xl.jb.params["unet"], cfg, jnp.asarray(t),
                                  jax.tree.map(jnp.asarray, added))
    got = PU.time_cond_embedding(xl.pb.params["unet"], pcfg, torch.as_tensor(t),
                                 {k: torch.as_tensor(v) for k, v in added.items()})
    _close(got, want)
    for fn, params, c, tt in ((JU.time_cond_embedding, xl.jb.params, cfg, jnp.asarray(t)),
                              (PU.time_cond_embedding, xl.pb.params, pcfg, torch.as_tensor(t))):
        with pytest.raises(ValueError, match="requires added_cond"):
            fn(params["unet"], c, tt)


@pytest.mark.parametrize("variant", ["off", "capture", "use"])
def test_unet_matches_jax(xl, variant):
    """``apply_unet`` with the addition conditioning: the full forward, the
    DeepCache capture (and its deep feature) and the cached pass around the
    JAX capture's feature (the JAX test_deepcache is parametrized over tiny
    and tiny_xl)."""
    cfg, pcfg = JU.UNetConfig.tiny_xl(), PU.UNetConfig.tiny_xl()
    rng = np.random.default_rng(3)
    # the engine's rows (4 stages, 16 tokens): the JAX side's op by op
    # compiles are the ones its engine tests reuse
    x = rng.standard_normal((4, 16, 16, 4)).astype(np.float32)
    t = np.array([999.0, 250.0, 500.0, 10.0], np.float32)
    ctx = rng.standard_normal((4, 16, cfg.cross_attention_dim)).astype(np.float32)
    added = _added(rng, cfg, 4)
    jargs = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    pargs = (torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(ctx))
    jadd = jax.tree.map(jnp.asarray, added)
    padd = {k: torch.as_tensor(v) for k, v in added.items()}
    jp, pp = xl.jb.params["unet"], xl.pb.params["unet"]
    if variant == "use":
        _, deep = JU.apply_unet(jp, *jargs, cfg, added_cond=jadd, deep_cache="capture")
        want = JU.apply_unet(jp, *jargs, cfg, added_cond=jadd, deep_cache="use", cached_h=deep)
        got = PU.apply_unet(pp, *pargs, pcfg, added_cond=padd, deep_cache="use",
                            cached_h=torch.as_tensor(np.asarray(deep)))
    else:
        want = JU.apply_unet(jp, *jargs, cfg, added_cond=jadd, deep_cache=variant)
        got = PU.apply_unet(pp, *pargs, pcfg, added_cond=padd, deep_cache=variant)
    if variant == "capture":
        (got, deep), (want, jdeep) = got, want
        assert tuple(deep.shape) == PU.deep_cache_shape(pcfg, x.shape) == jdeep.shape
        _close(deep, jdeep, atol=1e-4)
    _close(got, want, atol=1e-4)
    with pytest.raises(ValueError, match="requires added_cond"):
        PU.apply_unet(pp, *pargs, pcfg)


def test_encode_prompt_matches_jax(xl):
    """(cond, uncond, {"pooled"}): ViT-L's and bigG's (here tiny_dual's and
    tiny_g's) hidden states side by side, and the second tower's projected
    pooled state of the prompt."""
    for prompt in (PROMPT, SWAP, ""):
        jc, ju, je = xl.jb.encode_prompt(prompt)
        pc, pu, pe = xl.pb.encode_prompt(prompt)
        assert tuple(pc.shape) == jc.shape == (1, 16, 32) and sorted(pe) == sorted(je)
        for got, want in ((pc, jc), (pu, ju), (pe["pooled"], je["pooled"])):
            _close(got, want)


# -- the engine --------------------------------------------------------------------------

def _engines(jb, pb, over=None, jparams=None, pparams=None):
    """The JAX engine at ``over`` prepared from PROMPT, and the port's with
    the JAX state handed across."""
    over = over or {}
    jcfg = JREG.default_stream_config(XL, **over)
    jeng = JENG.StreamEngine(jb.stream_models, jb.params if jparams is None else jparams, jcfg,
                             jb.encode_prompt).prepare(PROMPT, guidance_scale=1.4, delta=0.9,
                                                       seed=6)
    pcfg = PREG.default_stream_config(XL, device="cpu", **over)
    peng = PENG.StreamEngine(pb.stream_models, pb.params if pparams is None else pparams, pcfg,
                             pb.encode_prompt, device="cpu", model_id=XL)
    state = peng.build_state(PROMPT, seed=6)
    peng.state = bridge.state_from_jax(_np(jeng.state))
    assert sorted(peng.state) == sorted(state)  # the port builds the JAX state's leaves
    return jeng, peng


def _stream(jeng, peng, seed, n=N_FRAMES):
    """The same frames into both engines, the prompt swapped before frame
    SWAP_AT on both: every frame within 1 level; the pooled embeds swap with
    the prompt, as the JAX engine's do.  -> the port's frames."""
    outs = []
    for i, f in enumerate(_frames(n, seed)):
        if i == SWAP_AT:
            before = peng.state["added_text"].clone()
            for eng in (jeng, peng):
                eng.update_prompt(SWAP)
            assert not torch.equal(before, peng.state["added_text"])
            _close(peng.state["added_text"], jeng.state["added_text"])
        got = peng(f)
        assert _levels(got, jeng(f)) <= 1, f"frame {i}"
        outs.append(got)
    return outs


@pytest.mark.parametrize("over", [{}, TURBO, {"cfg_type": "full"}, {"cfg_type": "initialize"}],
                         ids=["lcm_self", "turbo", "full_cfg", "initialize"])
def test_engine_step_and_prompt_swap_match_jax(xl, over, monkeypatch):
    """The JAX test_tinyxl_added_cond_stream_and_prompt_swap on both
    packages: the state carries ``added_text`` and ``added_time_ids``
    ([[h, w, 0, 0, h, w]] f32), the stream and the prompt swap match, the
    engine key is the JAX engine's.  ``initialize`` seeds its stock with an
    uncond pass under the pooled embeds; full CFG doubles them with the
    rows."""
    jeng, peng = _engines(xl.jb, xl.pb, over)
    assert peng.state["added_time_ids"].tolist() == [[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]]
    assert peng.state["added_time_ids"].dtype == torch.float32
    if over.get("cfg_type") == "initialize":
        # the port's prepare() from the JAX noise seeds the JAX stock
        noise = torch.as_tensor(np.asarray(jeng.state["noise"]))
        monkeypatch.setattr(torch, "randn", lambda *a, **k: noise.clone())
        fresh = peng.build_state(PROMPT, guidance_scale=1.4, delta=0.9, seed=6)
        monkeypatch.undo()
        _close(fresh["stock"], jeng.state["stock"], atol=1e-4)
    outs = _stream(jeng, peng, seed=13)
    assert not np.array_equal(outs[SWAP_AT - 1], outs[SWAP_AT])
    jcfg = dataclasses.replace(jeng.cfg, use_fused_epilogue=peng.cfg.use_fused_epilogue,
                               attn_impl=peng.cfg.attn_impl)
    want_key = JENG.stream_engine_key(XL, jcfg)
    assert peng.key.rpartition("--v-")[0] == want_key.rpartition("--v-")[0]


def test_default_engines_keep_the_added_cond_off(xl):
    """Without ``use_added_cond`` a tinyxl engine has no pooled leaves, and
    its UNet refuses the step, on both packages."""
    jcfg = JREG.default_stream_config(XL, use_added_cond=False)
    pcfg = PREG.default_stream_config(XL, device="cpu", use_added_cond=False)
    frame = _frames(1, 0)[0]
    with pytest.raises(ValueError, match="requires added_cond"):
        JENG.StreamEngine(xl.jb.stream_models, xl.jb.params, jcfg, xl.jb.encode_prompt).prepare(
            PROMPT)(frame)
    peng = PENG.StreamEngine(xl.pb.stream_models, xl.pb.params, pcfg, xl.pb.encode_prompt,
                             device="cpu").prepare(PROMPT)
    assert "added_text" not in peng.state
    with pytest.raises(ValueError, match="requires added_cond"):
        peng(frame)


# -- the variants ------------------------------------------------------------------------

def test_deepcache_matches_jax(xl):
    """DeepCache (interval 2) at tinyxl: the capture and cached steps both
    carry the addition conditioning; the cadence and every frame follow the
    JAX engine's through the prompt swap."""
    jeng, peng = _engines(xl.jb, xl.pb, {"unet_cache_interval": 2})
    assert peng.variants == ("capture", "cached")
    _stream(jeng, peng, seed=21)
    assert peng._tick == jeng._tick


def test_w8_matches_jax(xl, monkeypatch):
    """QUANT_WEIGHTS=w8 at tinyxl: the quantized trees are the JAX tree (the
    second tower and the addition embedding included) and the stream follows
    the JAX w8 stream; the keys gain quant-w8 on both."""
    monkeypatch.setenv("QUANT_WEIGHTS", "w8")
    monkeypatch.setenv("QUANT_MIN_SIZE", "256")
    jq = JREG.cast_params(xl.jb.params, "float32")
    pq = PREG.cast_params(bridge.params_from_jax(_np(xl.jb.params)), "float32")
    want = bridge.params_from_jax(_np(jq))
    assert "kernel_q" in pq["unet"]["add_embedding"]["linear_1"]
    assert "kernel_q" in pq["clip2"]["layers"][0]["fc1"]
    _same_tree(pq, want)
    jeng, peng = _engines(xl.jb, xl.pb, jparams=jq, pparams=pq)
    assert "quant-w8" in peng.key
    _stream(jeng, peng, seed=22)


def _same_tree(got, want):
    """The same leaf paths, and each leaf of the same dtype, bit for bit."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype and torch.equal(got[path], w), path


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def test_controlnet_matches_jax():
    """A ControlNet at tinyxl (canny; its zero convs non-zero from a seed)
    carries the UNet's addition embedding in its encoder half and takes the
    pooled embeds, as the JAX ControlNet does: the stream follows the JAX
    engine's."""
    jb = JREG.load_model_bundle(XL, controlnet="tiny-cnet")
    cnet = jb.params["controlnet"]
    assert "add_embedding" in cnet
    rng = np.random.default_rng(0)
    for zc in cnet["zero_convs"] + [cnet["mid_zero_conv"], cnet["cond_embedding"]["conv_out"]]:
        zc["kernel"] = jnp.asarray(0.3 * rng.standard_normal(zc["kernel"].shape), jnp.float32)
    pb = PREG.load_model_bundle(XL, device="cpu", controlnet="tiny-cnet",
                                params=bridge.params_from_jax(_np(jb.params)))
    jeng, peng = _engines(jb, pb, {"use_controlnet": True})
    assert "cnet-1canny" in peng.key
    _stream(jeng, peng, seed=23)
    # the port's own init carries an addition embedding in its encoder half too
    own = PREG.load_model_bundle(XL, device="cpu", controlnet="tiny-cnet")
    assert sorted(own.params["controlnet"]["add_embedding"]) == ["linear_1", "linear_2"]


def _adapter_registry(cls, ld, bundle):
    rng = np.random.default_rng(7)
    reg = cls(bundle.params["unet"], ld.unet_key_map(bundle.unet_cfg))
    mods = ("down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q",
            "mid_block.attentions.0.transformer_blocks.1.attn1.to_v")
    reg.add("style", {m: {"down": (rng.normal(size=(2, 16)) * 0.4).astype(np.float32),
                          "up": (rng.normal(size=(16, 2)) * 0.4).astype(np.float32),
                          "alpha": 2.0} for m in mods})
    return reg


def _schedulers(xl, over=None, adapters=False, model_id=""):
    over = over or {}
    js = JBatchScheduler(xl.jb.stream_models, xl.jb.params, JREG.default_stream_config(XL, **over),
                         xl.jb.encode_prompt, max_sessions=2, window_ms=10_000.0, prewarm=False,
                         dp=1, model_id=model_id,
                         adapters=_adapter_registry(JAdapterRegistry, JLD, xl.jb) if adapters
                         else None)
    ps = BatchScheduler(xl.pb.stream_models, xl.pb.params,
                        PREG.default_stream_config(XL, device="cpu", **over), xl.pb.encode_prompt,
                        max_sessions=2, window_ms=10_000.0, prewarm=False, device="cpu",
                        model_id=model_id,
                        adapters=_adapter_registry(AdapterRegistry, PLD, xl.pb) if adapters
                        else None)
    return js, ps


def _lockstep(sess, streams, j):
    handles = [s.submit(f[j]) for s, f in zip(sess, streams)]
    return [s.fetch(h) for s, h in zip(sess, handles)]


@pytest.fixture(scope="module")
def pair(xl):
    """A JAX and a port scheduler (2 slots, turbo) over the same weights."""
    js, ps = _schedulers(xl, TURBO, model_id=XL)
    try:
        yield SimpleNamespace(js=js, ps=ps)
    finally:
        js.close()
        ps.close()


@pytest.mark.parametrize("adapters", [False, True], ids=["plain", "styled"])
def test_scheduler_per_slot_swap_matches_jax(xl, pair, adapters):
    """Two sessions in the bucket of 2 on the JAX BatchScheduler and on the
    port's (turbo), the JAX states carried across, a prompt swap on slot 1
    before step SWAP_AT: the slot's pooled embeds change in place (the
    captured graphs read these buffers), the other slot's stay, every frame
    within 1 level.  ``styled``: session 0 carries a style adapter from the
    factor bank (adapters/), as the JAX scheduler serves it at tinyxl."""
    js, ps = _schedulers(xl, TURBO, True) if adapters else (pair.js, pair.ps)
    kw = {"adapter": "style"} if adapters else {}
    jsess = [js.claim(f"j{i}", prompt=PROMPT, seed=i, **(kw if i == 0 else {}))
             for i in range(2)]
    psess = [ps.claim(f"p{i}", prompt=PROMPT, seed=i, **(kw if i == 0 else {}))
             for i in range(2)]
    try:
        bridge.states_from_jax(_np(js.states), ps.states)
        buffer = ps.states["added_text"]
        streams = [_frames(N_FRAMES, seed=30 + i) for i in range(2)]
        steps = ps.steps_total
        for j in range(N_FRAMES):
            if j == SWAP_AT:
                before = ps.states["added_text"].clone()
                jsess[1].update_prompt(SWAP)
                psess[1].update_prompt(SWAP)
                after = ps.states["added_text"]
                assert after is buffer and torch.equal(after[0], before[0])
                assert not torch.equal(after[1], before[1])
                _close(after, np.asarray(js.states["added_text"]))
            for got, want in zip(_lockstep(psess, streams, j), _lockstep(jsess, streams, j)):
                assert _levels(got, want) <= 1, f"step {j}"
        assert ps.steps_total - steps == N_FRAMES  # both sessions in every bucket step
    finally:
        for s in jsess + psess:
            s.release()
        if adapters:
            js.close()
            ps.close()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_snapshot_crosses_between_the_packages(pair, direction):
    """A tinyxl session steps 2 frames and is exported: its row carries the
    pooled embeds and the time ids under the JAX fingerprint; the row's
    bytes re-encode to the snapshot's bit for bit on the other package,
    restore there, and the next frames stay within 1 level of the source's
    own continuation."""
    js, ps = pair.js, pair.ps
    src_s, dst_s = (js, ps) if direction == "jax_to_port" else (ps, js)
    src = dst = None
    try:
        assert ps.snapshot_fingerprint() == js.snapshot_fingerprint()
        frames = _frames(5, seed=40)
        src = src_s.claim("src", prompt=PROMPT, seed=5)
        for f in frames[:2]:
            src.fetch(src.submit(f))
        snap = src_s.snapshot_session("src")
        blob = base64.b64decode(snap["state_b64"])
        row = JCK.deserialize_pytree(blob)
        assert row["added_text"].shape == (1, 16) and row["added_time_ids"].shape == (1, 6)
        assert PCK.serialize_pytree(PCK.deserialize_pytree(blob)) == blob
        assert JCK.serialize_pytree(JCK.deserialize_pytree(blob)) == blob
        dst = dst_s.restore_session(snap, "dst")
        again = base64.b64decode(dst_s.snapshot_session("dst")["state_b64"])
        assert again == blob
        for f in frames[2:]:
            assert _levels(dst.fetch(dst.submit(f)), src.fetch(src.submit(f))) <= 1
    finally:
        for s in (src, dst):
            if s is not None:
                s.release()


def test_multipeer_update_prompt_matches_jax(xl):
    """The JAX test_multipeer_sdxl_extras_swap_on_prompt_update (slow there)
    on both packages' peer engines: a per-slot prompt update swaps slot 1's
    pooled embeds, in place, and leaves slot 0's; the port's rows equal the
    JAX rows, and a step of both slots runs."""
    cfg = JREG.default_stream_config(XL)
    jm = JMultiPeerEngine(xl.jb.stream_models, xl.jb.params, cfg, xl.jb.encode_prompt,
                          max_peers=2).start("base prompt")
    pm = MultiPeerEngine(xl.pb.stream_models, xl.pb.params,
                         PREG.default_stream_config(XL, device="cpu"), xl.pb.encode_prompt,
                         max_peers=2, device="cpu").start("base prompt")
    buffer = pm.states["added_text"]
    before = pm.states["added_text"].clone()
    jm.update_prompt(1, "a different sdxl prompt")
    pm.update_prompt(1, "a different sdxl prompt")
    assert pm.states["added_text"] is buffer
    assert torch.equal(before[0], buffer[0]) and not torch.equal(before[1], buffer[1])
    for key in ("added_text", "added_time_ids", "cond", "uncond"):
        _close(pm.states[key], np.asarray(jm.states[key]))
    out = pm.step_all(np.stack(_frames(2, seed=50)))
    assert out.shape == (2, 64, 64, 3) and out.dtype == np.uint8


# -- loading at full geometry and from a snapshot ----------------------------------------

def _shapes(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _shapes(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _shapes(v, path + (i,))
    elif tree is not None:
        yield path, tuple(tree.shape)


def test_sdxl_key_maps_and_shapes_match_jax():
    """SDXL's full geometry: the diffusers UNet key map (with
    ``add_embedding``), the bigG tower's (with ``text_projection``), and
    every parameter's shape (the port's from a meta tree; 4-D kernels OIHW
    against the JAX HWIO)."""
    ucfg, clip_cfg = JU.UNetConfig.sdxl(), JC.CLIPTextConfig.sdxl_g()
    assert PLD.unet_key_map(PU.UNetConfig.sdxl()) == JLD.unet_key_map(ucfg)
    assert PLD.clip_key_map(PREG.clip2_config("sdxl")) == JLD.clip_key_map(clip_cfg)
    assert "add_embedding.linear_1.weight" in PLD.unet_key_map(PU.UNetConfig.sdxl())
    assert PLD.clip_key_map(PREG.clip2_config("sdxl"))["text_projection.weight"] == (
        "text_projection", "kernel")
    meta = PREG.init_params("sdxl", device="meta")
    key = jax.random.PRNGKey(0)
    want = {
        "unet": jax.eval_shape(lambda: JU.init_unet(key, ucfg)),
        "clip": jax.eval_shape(lambda: JC.init_clip_text(key, JC.CLIPTextConfig.sd15())),
        "clip2": jax.eval_shape(lambda: JC.init_clip_text(key, clip_cfg)),
    }
    for part, tree in want.items():
        got = dict(_shapes(meta[part]))
        exp = {p: (s[3], s[2], s[0], s[1]) if len(s) == 4 else s for p, s in _shapes(tree)}
        assert got == exp, part
    n = sum(int(np.prod(s)) for _, s in _shapes(meta["unet"]))
    assert 2.5e9 < n < 2.6e9  # SDXL's UNet, about 2.57 B parameters


def test_a_tinyxl_snapshot_with_text_encoder_2_loads_alike(tmp_path):
    """A synthetic tinyxl snapshot (unet, text_encoder, vae and
    text_encoder_2, written with ``loader.write_safetensors``) loaded by
    both packages: the UNet, the first tower and TAESD equal the written
    trees bit for bit on both; neither reads ``text_encoder_2`` for tinyxl
    (the JAX package reads it for sdxl only)."""
    seeded = PREG.init_params("tinyxl", seed=3)
    ucfg, ccfg, tcfg = PREG._model_configs("tinyxl")
    snap = tmp_path / "tiny-xl-snapshot"
    for sub, km, tree in (("unet", PLD.unet_key_map(ucfg), seeded["unet"]),
                          ("text_encoder", PLD.clip_key_map(ccfg), seeded["clip"]),
                          ("vae", PLD.taesd_key_map(tcfg), seeded["taesd"]),
                          ("text_encoder_2", PLD.clip_key_map(PREG.clip2_config("tinyxl")),
                           seeded["clip2"])):
        (snap / sub).mkdir(parents=True)
        PLD.write_safetensors(str(snap / sub / "model.safetensors"),
                              PLD.tree_to_state_dict(tree, km))
    jb = JREG.load_model_bundle(str(snap))
    pb = PREG.load_model_bundle(str(snap), device="cpu")
    assert jb.loaded_real_weights and pb.loaded_real_weights
    carried = bridge.params_from_jax(_np(jb.params))
    for part in ("unet", "clip", "taesd"):
        _same_tree(pb.params[part], seeded[part])
        _same_tree(carried[part], seeded[part])
    _same_tree(pb.params["clip2"], PREG.init_params("tinyxl", seed=0)["clip2"])
    assert not torch.equal(carried["clip2"]["token_embedding"],
                           seeded["clip2"]["token_embedding"])


# -- the agent ---------------------------------------------------------------------------

SIDES = {
    "jax": SimpleNamespace(agent=JA, signaling=JS, frames=JF, kw={}),
    "port": SimpleNamespace(agent=PA, signaling=PS, frames=PF, kw={"device": "cpu"}),
}
N_VIEW = 3
UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")


async def _offer_whip_config(m, carry):
    """``--model-id tiny-xl-test`` on ``m``'s agent (the batch scheduler, 2
    slots): one /offer and one /whip session, frames into both, a /config
    prompt swap after N_VIEW frames, N_VIEW more.  -> (the transcript of
    every response: status, content type and body with ids masked; the
    frames each session gave)."""
    app = m.agent.build_app(model_id=XL, provider=m.signaling.LoopbackProvider(), **m.kw)
    client = TestClient(TestServer(app))
    await client.start_server()
    script = []

    async def note(r):
        body = UUID.sub("<id>", await r.text())
        location = UUID.sub("<id>", r.headers.get("Location", ""))
        script.append((r.status, r.content_type, location, body))
        return r

    try:
        r = await note(await client.post("/offer", json={"room_id": "r", "offer": {
            "sdp": m.signaling.make_loopback_offer(), "type": "offer"}}))
        assert r.status == 200
        offer_pc = next(iter(app["pcs"]))
        r = await note(await client.post("/whip", data=m.signaling.make_loopback_offer(),
                                         headers={"Content-Type": "application/sdp"}))
        assert r.status == 201
        whip_id = r.headers["Location"].rsplit("/", 1)[1]
        whip_track = app["state"]["whip_tracks"][whip_id]
        pcs = [offer_pc, app["state"]["whip_pcs"][whip_id]]
        carry(app)
        for j, pc in enumerate(pcs):
            for i, f in enumerate(_frames(2 * N_VIEW + 2, seed=60 + j)):
                vf = m.frames.VideoFrame.from_ndarray(f)
                vf.pts, vf.time_base = i, Fraction(1, 30)
                await pc.in_track.push(vf)
        tracks = [offer_pc.out_tracks[0], whip_track]

        async def view(track, n):
            return [(await asyncio.wait_for(track.recv(), 120)).to_ndarray() for _ in range(n)]

        seen = await asyncio.gather(*(view(t, N_VIEW) for t in tracks))
        sched = app["batch_scheduler"]
        while any(q.depth for q in sched._queues):
            await asyncio.sleep(0.005)
        await note(await client.post("/config", json={"prompt": SWAP}))
        more = await asyncio.gather(*(view(t, N_VIEW) for t in tracks))
        pooled = np.asarray(sched.states["added_text"], np.float32)
        return script, [a + b for a, b in zip(seen, more)], pooled
    finally:
        await client.close()


def test_agent_offer_whip_and_config_match_the_jax_agent(monkeypatch):
    """The port's agent booted at tiny-xl-test against the JAX agent's: the
    transcripts of /offer, /whip and /config (a prompt swap) are equal
    (statuses, content types, Location and bodies, ids masked); the JAX
    weights and session
    states carried across, each session's frames within 1 level of the JAX
    agent's, before and after the swap; the swap reached both sessions'
    pooled embeds."""
    monkeypatch.setenv("SUPERVISOR", "0")
    monkeypatch.setenv("WARMUP_FRAMES", "0")
    monkeypatch.setenv("BATCHSCHED_MAX_SESSIONS", "2")
    monkeypatch.setenv("OVERLOAD_LOOP_LAG_BUDGET_MS", "100000")
    for name in ("HW_ENCODE", "NVENC", "PIPELINE_DEPTH", "DROP_FRAMES", "BATCHSCHED",
                 "BATCHSCHED_WINDOW_MS", "BATCHSCHED_PREWARM"):
        monkeypatch.delenv(name, raising=False)
    got = {}

    def keep(app):
        got["params"] = _np(app["pipeline"].engine.params)
        got["states"] = _np(app["batch_scheduler"].states)

    want = asyncio.run(_offer_whip_config(SIDES["jax"], keep))
    params = bridge.params_from_jax(got["params"])
    monkeypatch.setattr(PREG, "init_params", lambda fam, seed=0, device="cpu": params)
    port = asyncio.run(_offer_whip_config(
        SIDES["port"], lambda app: bridge.states_from_jax(got["states"],
                                                          app["batch_scheduler"].states)))
    assert port[0] == want[0]
    assert [s[0] for s in want[0]] == [200, 201, 200]
    for j in range(2):
        assert len(port[1][j]) == len(want[1][j]) == 2 * N_VIEW
        for i, (a, b) in enumerate(zip(port[1][j], want[1][j])):
            assert _levels(a, b) <= 1, f"session {j} frame {i}"
    _close(port[2], want[2])
    assert not np.allclose(port[2], np.asarray(got["states"]["added_text"], np.float32))
