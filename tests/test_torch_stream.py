"""Port parity for the slice as a whole: the tiny-test stream engine against
the JAX engine, frame for frame, plus the port's policies.

The JAX engine runs with its Pallas kernels (flash attention + the fused
epilogue, interpret mode on the CPU); its prepared state is handed to the
port by ``bridge.state_from_jax`` (jax.random and torch.Generator never
draw the same noise), its weights by ``bridge.params_from_jax``.  Each JAX
engine is built once per module (two builds in all) and its frames are
recorded; every port variant replays the same frames and control-plane
updates against the recording.

Tolerance: output frames at most 1 uint8 level apart (f32 on both sides;
a pixel whose value lands within float noise of a rounding tie may round
either way — the <=1-level class the JAX package's own parity legs allow);
ring state rtol=1e-4 / atol=1e-4.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.stream import engine as JENG
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.ops.kernels import attention as KA
from ai_rtc_agent_tpu_torch.ops.kernels import build as KB
from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF
from ai_rtc_agent_tpu_torch.ops.kernels import norm as KN
from ai_rtc_agent_tpu_torch.stream import engine as PENG
from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline

REPO = Path(__file__).resolve().parents[1]
TURBO = dict(
    t_index_list=(0,), num_inference_steps=1, timestep_spacing="trailing",
    scheduler="turbo", cfg_type="none",
)
# (frame index, action) applied to both engines before that frame
UPDATES = {3: ("prompt", "a dog in space"), 4: ("t_index", None)}
N_FRAMES = 6


def _frames(n=N_FRAMES, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_bundle():
    return JREG.load_model_bundle("tiny-test", attn_impl="pallas")


def _record(bundle, overrides):
    """Run the JAX engine over the frames (with the mid-stream updates) and
    record its prepared state, outputs and final ring state."""
    cfg = JREG.default_stream_config("tiny-test", use_fused_epilogue=True, **overrides)
    eng = JENG.StreamEngine(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt)
    eng.prepare("a cat", guidance_scale=1.4, delta=0.9, seed=1)
    rec = {"state0": jax.tree.map(np.asarray, eng.state), "outs": [], "t_index": None}
    rec["t_index"] = [min(t + 5, cfg.num_inference_steps - 1) for t in cfg.t_index_list]
    for i, f in enumerate(_frames()):
        _apply_update(eng, i, rec)
        rec["outs"].append(eng(f))
    rec["state"] = jax.tree.map(np.asarray, eng.state)
    return rec


def _apply_update(eng, i, rec):
    if i not in UPDATES:
        return
    kind, arg = UPDATES[i]
    if kind == "prompt":
        eng.update_prompt(arg)
    else:
        eng.update_t_index_list(rec["t_index"])


@pytest.fixture(scope="module")
def jax_lcm(jax_bundle):
    return _record(jax_bundle, {})


@pytest.fixture(scope="module")
def jax_turbo(jax_bundle):
    return _record(jax_bundle, TURBO)


@pytest.fixture(scope="module")
def port_params(jax_bundle):
    return bridge.params_from_jax(jax.tree.map(np.asarray, jax_bundle.params))


def _port_engine(params, overrides, fused, attn_impl):
    bundle = PREG.load_model_bundle("tiny-test", device="cpu", attn_impl=attn_impl, params=params)
    cfg = PREG.default_stream_config(
        "tiny-test", device="cpu", use_fused_epilogue=fused, **overrides
    )
    return PENG.StreamEngine(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt,
                             device="cpu")


def _replay(port_params, rec, overrides, fused, attn_impl):
    eng = _port_engine(port_params, overrides, fused, attn_impl)
    eng.state = bridge.state_from_jax(rec["state0"])
    for i, (f, want) in enumerate(zip(_frames(), rec["outs"])):
        _apply_update(eng, i, rec)
        got = eng(f)
        assert got.shape == want.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1, f"frame {i}: max diff {diff.max()}"
    for key in ("x_buf", "stock"):
        np.testing.assert_allclose(
            eng.state[key].numpy(), rec["state"][key], rtol=1e-4, atol=1e-4, err_msg=key
        )
    return eng


VARIANTS = [(True, "kernel"), (False, "plain"), (True, "plain"), (False, "kernel")]


@pytest.mark.parametrize("fused,attn_impl", VARIANTS)
def test_lcm_self_ring_matches_jax_engine(port_params, jax_lcm, fused, attn_impl):
    """tiny default: lcm, cfg_type self, 4-stage ring (rotation + stock)."""
    eng = _replay(port_params, jax_lcm, {}, fused, attn_impl)
    assert eng.cfg.cfg_type == "self" and eng.cfg.batch_size == 4


@pytest.mark.parametrize("fused,attn_impl", VARIANTS[:2])
def test_turbo_matches_jax_engine(port_params, jax_turbo, fused, attn_impl):
    """The sd-turbo step at tiny size: 1 step, trailing, cfg none, B=1."""
    eng = _replay(port_params, jax_turbo, TURBO, fused, attn_impl)
    assert eng.cfg.scheduler == "turbo" and eng.cfg.batch_size == 1


class _OpLog(TorchDispatchMode):
    """Names of the aten ops dispatched while ``section`` is set, by section."""

    def __init__(self):
        super().__init__()
        self.section = None
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.section is not None:
            self.ops.setdefault(self.section, set()).add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("overrides", [{}, TURBO], ids=["lcm_self", "turbo_none"])
def test_fused_step_has_no_glue_around_the_epilogue(monkeypatch, port_params, overrides):
    """With the fused epilogue on, the step launches nothing between the
    UNet and the decode but the epilogue (views and no-op casts only: no
    cat, fill or copy), and nothing after the decode writes the state."""
    log = _OpLog()
    bundle = PREG.load_model_bundle("tiny-test", device="cpu", attn_impl="plain", params=port_params)
    m = bundle.stream_models

    def unet(*a):
        out = m.unet(*a)
        log.section = "glue"
        return out

    def decode(*a):
        log.section = None
        out = m.vae_decode(*a)
        log.section = "after decode"
        return out

    def epilogue(*a, **k):
        section, log.section = log.section, None
        out = epilogue_kernel(*a, **k)
        log.section = section
        return out

    epilogue_kernel = PENG.fused_stream_epilogue
    monkeypatch.setattr(PENG, "fused_stream_epilogue", epilogue)
    cfg = PREG.default_stream_config("tiny-test", device="cpu", use_fused_epilogue=True, **overrides)
    eng = PENG.StreamEngine(PENG.StreamModels(unet, m.vae_encode, decode), bundle.params, cfg,
                            bundle.encode_prompt, device="cpu").prepare("a cat", seed=1)
    x_buf, stock = eng.state["x_buf"].clone(), eng.state["stock"].clone()
    with log:
        eng(_frames(1)[0])
    glue, after = log.ops.get("glue", set()), log.ops["after decode"]
    assert glue <= {"slice", "to"}, glue
    assert not after & {"copy_", "cat", "fill_", "zero_"}, after
    if cfg.batch_size > cfg.frame_buffer_size:  # the epilogue wrote the ring and the stock
        assert not torch.equal(eng.state["x_buf"], x_buf)
        assert not torch.equal(eng.state["stock"], stock)


def test_prompt_embedding_matches_jax(jax_bundle, port_params):
    bundle = PREG.load_model_bundle("tiny-test", device="cpu", params=port_params)
    for prompt in ("a cat", "a dog in space", ""):
        jc, ju = jax_bundle.encode_prompt(prompt)
        pc, pu = bundle.encode_prompt(prompt)
        np.testing.assert_allclose(pc.numpy(), jc, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(pu.numpy(), ju, rtol=1e-4, atol=1e-5)


def test_stream_config_field_set_matches_jax():
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]
    assert names(PENG.StreamConfig) == names(JENG.StreamConfig)
    # and the defaults agree field for field, except the attention choice
    # (the port defaults to its kernel; the JAX "" resolves from the backend)
    assert PENG.StreamConfig().attn_impl == "kernel"
    assert PENG.StreamConfig() == dataclasses.replace(
        PENG.StreamConfig(), **{
            k: v for k, v in dataclasses.asdict(JENG.StreamConfig()).items()
            if k != "attn_impl"
        }
    )


@pytest.mark.parametrize("model_id", [
    "stabilityai/sd-turbo", "tiny-test", "runwayml/stable-diffusion-v1-5",
    "stabilityai/stable-diffusion-2-1", "stabilityai/stable-diffusion-2-1-base",
    "tiny-xl-test", "stabilityai/sdxl-turbo",
])
def test_default_stream_config_matches_jax(model_id):
    """Same serving defaults; the port turns its kernels on (the main path)
    and serves bf16 on a CUDA device."""
    want = JREG.default_stream_config(model_id)
    got = PREG.default_stream_config(model_id, device="cpu")
    skip = {"use_fused_epilogue", "attn_impl", "dtype"}
    for f in dataclasses.fields(want):
        if f.name not in skip:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.use_fused_epilogue and got.dtype == "float32"
    assert PREG.default_stream_config(model_id, device="cuda").dtype == "bfloat16"
    assert PREG.family_of(model_id) == JREG.family_of(model_id)


@pytest.mark.parametrize("overrides", [
    {"use_controlnet": True}, {"use_added_cond": True}, {"unet_cache_interval": 2},
    {"unet_cache_interval": 3},
])
def test_later_slices_raise(port_params, overrides):
    """Every later slice is served now.  SDXL's added conditioning: a
    tiny-xl-test engine builds, with the key the JAX engine gives
    (tests/test_torch_sdxl.py holds it to the JAX engine); ControlNet is
    served (tests/test_torch_controlnet.py): a bundle without one is refused
    with the JAX engine's ValueError and a bundle with one builds; DeepCache
    (from its smallest interval, 2) builds its capture + cached pair
    (tests/test_torch_deepcache.py); the engine modes run
    (tests/test_torch_modes.py)."""
    if overrides.get("unet_cache_interval", 0) >= 2:
        eng = _port_engine(port_params, overrides, True, "kernel")
        assert eng.variants == ("capture", "cached") and set(eng.keys) == set(eng.variants)
        return
    if overrides.get("use_controlnet"):
        with pytest.raises(ValueError, match="StreamModels.controlnet is None"):
            _port_engine(port_params, overrides, True, "kernel")
        bundle = PREG.load_model_bundle("tiny-test", device="cpu", params=port_params,
                                        controlnet="tiny-cnet")
        cfg = PREG.default_stream_config("tiny-test", device="cpu", **overrides)
        eng = PENG.StreamEngine(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt,
                                device="cpu")
        assert "cnet-1canny" in eng.key
        return
    bundle = PREG.load_model_bundle("tiny-xl-test", device="cpu")
    cfg = PREG.default_stream_config("tiny-xl-test", device="cpu", **overrides)
    eng = PENG.StreamEngine(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt,
                            device="cpu", model_id="tiny-xl-test").prepare("a cat")
    jcfg = dataclasses.replace(JREG.default_stream_config("tiny-xl-test"),
                               use_fused_epilogue=cfg.use_fused_epilogue, attn_impl=cfg.attn_impl)
    want = JENG.stream_engine_key("tiny-xl-test", jcfg)
    assert eng.key.rpartition("--v-")[0] == want.rpartition("--v-")[0]
    assert tuple(eng.state["added_text"].shape) == (1, 16)


def test_entry_points_raise_without_a_card(monkeypatch, port_params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamDiffusionPipeline("tiny-test")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PREG.load_model_bundle("tiny-test")
    bundle = PREG.load_model_bundle("tiny-test", device="cpu", params=port_params)
    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PENG.StreamEngine(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PENG.StreamEngine(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt,
                          device="cuda")


def test_cpu_path_never_builds_or_launches_a_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("kernel build attempted on the CPU path")

    for mod, name in ((KB, "build_library"), (KB, "load_library"), (KA, "load"), (KF, "load"),
                      (KN, "load")):
        monkeypatch.setattr(mod, name, refuse)
    a0, e0, n0 = KA.launches, KF.launches, KN.launches
    pipe = StreamDiffusionPipeline("tiny-test", device="cpu")
    assert pipe.config.use_fused_epilogue and pipe.config.attn_impl == "kernel"
    for f in _frames(3):
        assert pipe(f).shape == (64, 64, 3)
    assert (KA.launches, KF.launches, KN.launches) == (a0, e0, n0)


def test_pipeline_surface_on_cpu():
    frames = _frames(6, seed=4)
    ref = StreamDiffusionPipeline("tiny-test", device="cpu")
    seq = [ref(f) for f in frames]
    pipe = StreamDiffusionPipeline("tiny-test", device="cpu")
    # two in flight through submit/fetch == the same frames through __call__
    pending, outs = [], []
    for f in frames:
        pending.append(pipe.submit(f))
        if len(pending) == 2:
            outs.append(pipe.fetch(pending.pop(0)))
    outs += [pipe.fetch(h) for h in pending]
    for a, b in zip(outs, seq):
        np.testing.assert_array_equal(a, b)
    # control plane: accepted values are what restart() restores
    pipe.update_prompt("a red boat")
    pipe.update_guidance(1.8, 0.7)
    pipe.update_t_index_list([12, 22, 32, 42])
    with pytest.raises(ValueError):
        pipe.update_t_index_list([10, 20])
    assert pipe.prompt == "a red boat" and pipe.guidance_scale == 1.8 and pipe.delta == 0.7
    pipe.restart()
    assert float(pipe.engine.state["guidance"]) == pytest.approx(1.8)
    fresh = StreamDiffusionPipeline("tiny-test", device="cpu", prompt="a red boat")
    fresh.update_guidance(1.8, 0.7)
    fresh.update_t_index_list([12, 22, 32, 42])
    fresh.restart()
    for f in frames[:3]:
        np.testing.assert_array_equal(pipe(f), fresh(f))
    # an odd-sized frame is resized to the config's geometry
    assert pipe(np.zeros((50, 70, 3), np.uint8)).shape == (64, 64, 3)


def test_similarity_filter_matches_jax():
    base = _frames(1, seed=9)[0]
    seq = [base, base, base.copy(), np.clip(base.astype(int) + 3, 0, 255).astype(np.uint8),
           _frames(1, seed=10)[0], base, base, base, base, np.zeros_like(base), np.zeros_like(base)]
    p, j = PENG.SimilarityFilter(0.95, 2, seed=3), JENG.SimilarityFilter(0.95, 2, seed=3)
    got = [p.should_skip(f, have_output=i > 0) for i, f in enumerate(seq)]
    want = [j.should_skip(f, have_output=i > 0) for i, f in enumerate(seq)]
    assert got == want and any(got) and not all(got)


def test_engine_similarity_skip_duplicates_last_output(port_params):
    eng = _port_engine(port_params, {"similar_image_filter": True,
                                     "similar_image_threshold": 0.5}, True, "kernel")
    eng.prepare("a cat", seed=1)
    f = _frames(1)[0]
    first = eng(f)
    second = eng(f)  # identical frame: always skipped, output duplicated
    assert eng.last_submit_was_skip
    np.testing.assert_array_equal(first, second)


def test_bridge_carries_convs_as_oihw_and_linears_as_is():
    tree = {"conv": {"kernel": np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)},
            "lin": {"kernel": np.ones((4, 6), np.float32)}, "none": None, "list": [np.zeros(2)]}
    out = bridge.params_from_jax(tree)
    assert out["conv"]["kernel"].shape == (5, 4, 2, 3)
    assert out["conv"]["kernel"][1, 2, 0, 1] == tree["conv"]["kernel"][0, 1, 2, 1]
    assert out["lin"]["kernel"].shape == (4, 6) and out["none"] is None
    assert isinstance(out["list"], list)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Nor triton: both kernels are CUDA C++ built with nvcc."""
    files = sorted((REPO / "ai_rtc_agent_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "scripts" / "torch_step_profile.py",
        REPO / "scripts" / "epilogue_ab.py", REPO / "scripts" / "smoke_loop.py",
        REPO / "scripts" / "torch_trace_window.py", REPO / "scripts" / "torch_golden_capture.py",
    ]
    assert len(files) > 10 and REPO / "ai_rtc_agent_tpu_torch" / "aot" / "cache.py" in files
    for name in ("assets/download", "assets/build_engines", "utils/contract", "utils/hwfp",
                 "utils/perfbank", "utils/golden"):
        assert REPO / "ai_rtc_agent_tpu_torch" / f"{name}.py" in files
    for name in ("loader", "lora", "safety", "clip_vision"):
        assert REPO / "ai_rtc_agent_tpu_torch" / "models" / f"{name}.py" in files
    for name in ("__init__", "__main__", "core", "env_registry", "http_contract"):
        assert REPO / "ai_rtc_agent_tpu_torch" / "analysis" / f"{name}.py" in files
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "ai_rtc_agent_tpu", "triton"), f"{path}: imports {name}"
