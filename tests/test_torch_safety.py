"""The port's safety checker (models/safety.py over models/clip_vision.py)
against the JAX package's, on the CPU, ``CLIPVisionConfig.tiny()``.

* The tower and ``check_images`` within 1e-5 in f32 with the JAX weights
  carried by ``bridge.params_from_jax`` (the rule by rank: the patch
  embedding is the one 4-D leaf; ``concept_embeds`` and
  ``special_care_embeds`` stay as they are);
* ``preprocess_clip``: Keys' cubic with antialias (jax.image.resize's) on
  square and non-square frames, up and down, and 512 -> 224 at the real
  tower's size, within 1e-5;
* the key map and a JAX state dict loaded into the port;
* the flags, the special-care adjustment, the blanking and the memo, and
  the checker on the served path (the pipeline and the batch scheduler)
  against the JAX pipeline and scheduler with the same checker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.models import clip_vision as JCV
from ai_rtc_agent_tpu.models import loader as JLD
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.models import safety as JS
from ai_rtc_agent_tpu.stream.pipeline import StreamDiffusionPipeline as JPipeline
from ai_rtc_agent_tpu.stream.scheduler import BatchScheduler as JBatchScheduler
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.models import clip_vision as PCV
from ai_rtc_agent_tpu_torch.models import loader as PLD
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.models import safety as PS
from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline as PPipeline
from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

JCFG, PCFG = JCV.CLIPVisionConfig.tiny(), PCV.CLIPVisionConfig.tiny()
TURBO = dict(t_index_list=(0,), num_inference_steps=1, timestep_spacing="trailing",
             scheduler="turbo", cfg_type="none")


@pytest.fixture(scope="module")
def jparams():
    return JS.init_safety_checker(jax.random.PRNGKey(0), JCFG)


def _port(jtree):
    return bridge.params_from_jax(jax.tree.map(np.asarray, jtree))


def _imgs(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def test_configs_match():
    for j, p in ((JCFG, PCFG), (JCV.CLIPVisionConfig.vit_l14(), PCV.CLIPVisionConfig.vit_l14())):
        assert (j.image_size, j.patch_size, j.width, j.layers, j.heads, j.activation,
                j.num_patches) == (p.image_size, p.patch_size, p.width, p.layers, p.heads,
                                   p.activation, p.num_patches)


@pytest.mark.parametrize("shape,cfg", [
    ((1, 64, 48, 3), "tiny"), ((2, 40, 40, 3), "tiny"), ((1, 20, 28, 3), "tiny"),
    ((1, 48, 64, 3), "tiny"), ((1, 32, 32, 3), "tiny"), ((1, 512, 512, 3), "vit_l14"),
    ((1, 512, 384, 3), "vit_l14"),
])
def test_preprocess_matches_jax_cubic_resize(shape, cfg):
    """The resized pixels (the normalisation undone: dividing by CLIP's std
    of ~0.27 multiplies every f32 rounding by ~3.7) within 1e-5 of JAX's; at
    512 rows each output sums hundreds of taps, and the port's f32 result
    is within 1e-6 of the same weights in f64, JAX's within ~6e-6."""
    x = _imgs(shape, seed=sum(shape))
    want = np.asarray(JCV.preprocess_clip(jnp.asarray(x), getattr(JCV.CLIPVisionConfig, cfg)()))
    got = PCV.preprocess_clip(torch.from_numpy(x), getattr(PCV.CLIPVisionConfig, cfg)())
    assert got.shape == want.shape
    pixels = lambda a: a * np.array(PCV.CLIP_STD, np.float32) + np.array(  # noqa: E731
        PCV.CLIP_MEAN, np.float32)
    np.testing.assert_allclose(pixels(got.numpy()), pixels(want), rtol=0, atol=1e-5)
    exact = PCV.preprocess_clip(torch.from_numpy(x).double(),
                                getattr(PCV.CLIPVisionConfig, cfg)()).numpy()
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=4e-6)


def test_resize_weights_are_jax_scale_and_translate():
    from jax._src.image import scale as jscale

    for n_in, n_out in ((512, 224), (48, 43), (20, 32), (7, 7)):
        want = np.asarray(jscale.compute_weight_mat(
            n_in, n_out, n_out / n_in, 0.0, jscale._fill_keys_cubic_kernel, True))
        np.testing.assert_allclose(PCV.resize_weights(n_in, n_out), want, rtol=1e-6, atol=1e-7)


def test_clip_vision_tower_matches_jax(jparams):
    x = _imgs((2, 32, 32, 3), seed=3)
    want = JCV.apply_clip_vision(jparams["vision"], jnp.asarray(x), JCFG)
    got = PCV.apply_clip_vision(_port(jparams)["vision"], torch.from_numpy(x), PCFG)
    for k in ("hidden", "pooled"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5)


def _embeddings(params, img01):
    """The JAX checker's unit image embeddings of the frames."""
    x = JCV.preprocess_clip(jnp.asarray(img01), JCFG)
    emb = JS.linear(params["visual_projection"],
                    JCV.apply_clip_vision(params["vision"], x, JCFG)["pooled"])
    return emb / jnp.linalg.norm(emb, axis=-1, keepdims=True)


def _mixed(jparams, frames01):
    """The JAX tree with concept 0 aimed along frame 0's departure from the
    frames' mean embedding (the frames of one stream share most of theirs)
    and its threshold in the widest gap of their scores: some frames
    flagged, some not, none near the threshold."""
    emb = _embeddings(jparams, frames01)
    d = emb[0] - emb.mean(axis=0)
    scores = np.sort(np.asarray(emb @ (d / jnp.linalg.norm(d))))
    i = int(np.argmax(np.diff(scores)))
    assert scores[i + 1] - scores[i] > 1e-4, "the frames' scores sit too close to split"
    p = dict(jparams)
    p["concept_embeds"] = jparams["concept_embeds"].at[0].set(d)
    p["concept_embeds_weights"] = jparams["concept_embeds_weights"].at[0].set(
        float((scores[i] + scores[i + 1]) / 2))
    return p


def test_check_images_matches_jax_flags_and_special_care(jparams):
    frames = _imgs((6, 40, 48, 3), seed=4)
    p = _mixed(jparams, frames)
    want = np.asarray(JS.check_images(p, jnp.asarray(frames), JCFG))
    got = PS.check_images(_port(p), torch.from_numpy(frames), PCFG).numpy()
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(got, want)
    # a special-care hit lowers every threshold by 0.01: aim special 0 at
    # frame 0 and put concept 0 just out of its reach without it
    embn = _embeddings(p, frames[:1])[0]
    q = dict(p, special_care_embeds=p["special_care_embeds"].at[0].set(embn),
             special_care_embeds_weights=p["special_care_embeds_weights"].at[0].set(0.9),
             concept_embeds=p["concept_embeds"].at[0].set(embn),
             concept_embeds_weights=p["concept_embeds_weights"].at[0].set(1.005))
    for special in (0.9, 2.0):
        q["special_care_embeds_weights"] = q["special_care_embeds_weights"].at[0].set(special)
        want = np.asarray(JS.check_images(q, jnp.asarray(frames[:1]), JCFG))
        got = PS.check_images(_port(q), torch.from_numpy(frames[:1]), PCFG).numpy()
        assert got.tolist() == want.tolist() == [special < 1.0]


def test_key_map_and_a_jax_state_dict_cross(jparams):
    jkm, pkm = JS.safety_key_map(JCFG), PS.safety_key_map(PCFG)
    assert list(pkm.items()) == list(jkm.items())
    sd = JLD.tree_to_state_dict(jparams, jkm)
    port0 = PS.init_safety_checker(torch.Generator().manual_seed(1), PCFG)
    loaded, n = PLD.load_into_tree(port0, sd, pkm, strict=False)
    assert n == len(sd)
    want = _port(jparams)
    for path in (("concept_embeds",), ("special_care_embeds",), ("visual_projection", "kernel"),
                 ("vision", "patch_embedding", "kernel"), ("vision", "position_embedding")):
        a, b = loaded, want
        for k in path:
            a, b = a[k], b[k]
        assert torch.equal(a, b), path
    assert loaded["concept_embeds"].shape == (PS.N_CONCEPTS, PS.PROJECTION_DIM)


def _checker(params):
    return PS.SafetyChecker(params=params, cfg=PCFG)


def test_checker_blanks_as_the_jax_checker_and_memoises(jparams):
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (6, 40, 48, 3), dtype=np.uint8)
    p = _mixed(jparams, frames.astype(np.float32) / 255.0)
    want = JS.SafetyChecker(params=p, cfg=JCFG)(frames)
    chk = _checker(_port(p))
    calls = []
    real = chk.flags
    chk.flags = lambda batch: calls.append(1) or real(batch)
    got = chk(frames)
    np.testing.assert_array_equal(got, want)
    blank = (want == 0).all(axis=(1, 2, 3))
    assert 0 < blank.sum() < len(frames)
    np.testing.assert_array_equal(chk(frames), want)  # a repeat hits the memo
    assert len(calls) == 1
    np.testing.assert_array_equal(chk(frames[0]), want[0])  # [H,W,3] in, [H,W,3] out
    assert len(calls) == 2
    # a random checker (thresholds 1.0) flags nothing, as the JAX one
    untouched = PS.SafetyChecker.load(None, cfg=PCFG, device="cpu")(frames)
    np.testing.assert_array_equal(untouched, frames)


# -- the served path: the pipeline and the batch scheduler ---------------------------------

def _frames(n=5, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def served(jparams):
    """The JAX tiny-test turbo pipeline's unchecked outputs, the checker
    tree split over them, and the JAX pipeline's checked outputs."""
    cfg = JREG.default_stream_config("tiny-test", use_fused_epilogue=False, **TURBO)
    jpipe = JPipeline("tiny-test", config=cfg, use_safety_checker=False)
    state0 = jax.tree.map(np.asarray, jpipe.engine.state)
    raw = [np.asarray(jpipe(f)) for f in _frames()]
    p = _mixed(jparams, np.stack(raw).astype(np.float32) / 255.0)
    jpipe.safety_checker = JS.SafetyChecker(params=p, cfg=JCFG)
    jpipe.engine.state = jax.tree.map(jnp.asarray, state0)
    want = [np.asarray(jpipe(f)) for f in _frames()]
    return dict(jpipe=jpipe, state0=state0, p=p, want=want, raw=raw)


def test_pipeline_checker_matches_the_jax_pipeline(served):
    jpipe = served["jpipe"]
    params = _port(jax.tree.map(np.asarray, jpipe.engine.params))
    pipe = PPipeline("tiny-test", device="cpu", params=params, prompt=jpipe.prompt,
                     config=PREG.default_stream_config("tiny-test", device="cpu", **TURBO),
                     use_safety_checker=False)
    assert pipe.safety_checker is None
    pipe.safety_checker = _checker(_port(served["p"]))
    pipe.engine.state = bridge.state_from_jax(served["state0"])
    got = [pipe(f) for f in _frames()]
    flagged = [bool((w == 0).all()) for w in served["want"]]
    assert 0 < sum(flagged) < len(flagged)
    for g, w, f in zip(got, served["want"], flagged):
        assert bool((g == 0).all()) == f
        diff = np.abs(g.astype(np.int16) - w.astype(np.int16))
        assert diff.max() <= 1, diff.max()


def test_scheduler_checker_matches_the_jax_scheduler(served):
    """One session on each scheduler built from its pipeline (the checker
    rides ``from_pipeline``), the JAX session state carried across."""
    jpipe = served["jpipe"]
    js = JBatchScheduler.from_pipeline(jpipe, max_sessions=1, window_ms=10_000.0,
                                       prewarm=False, dp=1)
    params = _port(jax.tree.map(np.asarray, jpipe.engine.params))
    pipe = PPipeline("tiny-test", device="cpu", params=params, prompt=jpipe.prompt,
                     config=PREG.default_stream_config("tiny-test", device="cpu", **TURBO),
                     use_safety_checker=False)
    pipe.safety_checker = _checker(_port(served["p"]))
    ps = BatchScheduler.from_pipeline(pipe, max_sessions=1, window_ms=10_000.0)
    assert ps.safety_checker is pipe.safety_checker
    try:
        jsess, psess = js.claim("j", seed=0), ps.claim("p", seed=0)
        bridge.states_from_jax(jax.tree.map(np.asarray, js.states), ps.states)
        want = [np.asarray(jsess(f)) for f in _frames()]
        got = [psess(f) for f in _frames()]
    finally:
        js.close()
        ps.close()
    flagged = [bool((w == 0).all()) for w in want]
    assert any(flagged)
    for g, w, f in zip(got, want, flagged):
        assert bool((g == 0).all()) == f
        assert np.abs(g.astype(np.int16) - w.astype(np.int16)).max() <= 1


def test_env_turns_the_checker_on(monkeypatch):
    monkeypatch.setenv("SAFETY_CHECKER", "1")
    monkeypatch.setattr(PS.CV.CLIPVisionConfig, "vit_l14", staticmethod(PCV.CLIPVisionConfig.tiny))
    pipe = PPipeline("tiny-test", device="cpu",
                     config=PREG.default_stream_config("tiny-test", device="cpu", **TURBO))
    assert isinstance(pipe.safety_checker, PS.SafetyChecker)
    assert not pipe.safety_checker.loaded_real_weights
    out = pipe(_frames(1)[0])
    assert out.shape == (64, 64, 3)
    monkeypatch.setenv("SAFETY_CHECKER", "0")
    assert PPipeline("tiny-test", device="cpu").safety_checker is None
