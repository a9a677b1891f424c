"""w8 weights (QUANT_WEIGHTS=w8) in the port against the JAX package, on the CPU.

* The tree: ``quantize_params`` of the port's dense tree (carried over by
  ``bridge.params_from_jax``) equals ``params_from_jax`` of the JAX
  ``quantize_params`` tree — ``kernel_q`` bit for bit, ``scale`` exactly,
  the same leaves quantized — in f32 and after the bf16 cast, both through
  ``cast_params`` under QUANT_WEIGHTS / QUANT_MIN_SIZE.  The bridge's rank
  rule carries a quantized JAX tree: a 4-D ``kernel_q`` becomes OIHW and a
  (1,1,1,O) scale (O,1,1,1).  ``cast_params`` keeps the pair's scale f32
  and puts 4-D kernels, int8 ones too, channels_last.
* The primitives: the dequantized kernel equals the JAX ``_kernel`` bit for
  bit in bf16 and f32; ``linear`` / ``conv2d`` with a w8 kernel match the
  JAX primitives within f32 round-off (rtol 1e-5, atol 1e-5).
* The stream: the tiny-test LCM ring (cfg self, 4 stages) with w8 weights,
  the JAX engine's prepared state handed over, a prompt update mid-stream:
  every output frame within 1 uint8 level of the JAX w8 engine's (the
  rounding-tie class of tests/test_torch_stream.py).
* The keys: a w8 engine's key is the JAX ``stream_engine_key`` with
  ``params_variant_extra`` (``quant-w8``); a dense one has none.
* The import rule: the modules this slice adds or touches import nothing
  of JAX or the JAX package.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.models import layers as JL
from ai_rtc_agent_tpu.models import quant as JQ
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.stream import engine as JENG
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.models import layers as PL
from ai_rtc_agent_tpu_torch.models import quant as PQ
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.stream import engine as PENG
from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline

REPO = Path(__file__).resolve().parents[1]
MIN_SIZE = 256  # quantizes most of the tiny-test kernels (the default 16384 none)


@pytest.fixture(scope="module")
def jax_bundle():
    return JREG.load_model_bundle("tiny-test")


@pytest.fixture
def w8(monkeypatch):
    monkeypatch.setenv("QUANT_WEIGHTS", "w8")
    monkeypatch.setenv("QUANT_MIN_SIZE", str(MIN_SIZE))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _walk_equal(got, want, path=""):
    """Leaf for leaf: the same structure, dtype, shape and bits."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _walk_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _walk_equal(a, b, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        assert (got.dtype, tuple(got.shape)) == (want.dtype, tuple(want.shape)), path
        assert torch.equal(got, want), path


def _count(tree, key) -> int:
    if isinstance(tree, dict):
        return sum((k == key) + _count(v, key) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_count(v, key) for v in tree)
    return 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_tree_equals_the_jax_tree(jax_bundle, w8, monkeypatch, dtype):
    jq = JREG.cast_params(jax_bundle.params, dtype)  # the JAX cast, then quantize
    want = bridge.params_from_jax(_np(jq))
    dense = bridge.params_from_jax(_np(jax_bundle.params))
    got = PREG.cast_params(dense, dtype)  # the port's cast, then quantize
    n = _count(got, "kernel_q")
    assert n > 10 and n == _count(want, "kernel_q")
    _walk_equal(got, want)
    assert PQ.quantized_bytes_saved(got) == JQ.quantized_bytes_saved(jq)
    # quantize_params itself, on the carried-over tree the JAX cast made
    monkeypatch.delenv("QUANT_WEIGHTS")
    cast = bridge.params_from_jax(_np(JREG.cast_params(jax_bundle.params, dtype)))
    direct, m = PQ.quantize_params(cast, min_size=MIN_SIZE)
    assert m == n
    _walk_equal(direct, want)


def test_the_bridge_and_the_cast_keep_the_w8_layout(jax_bundle, w8):
    jq = JREG.cast_params(jax_bundle.params, "bfloat16")
    conv_j = jq["unet"]["up_blocks"][0]["resnets"][0]["conv1"]
    lin_j = jq["unet"]["time_embedding"]["linear_2"]
    carried = bridge.params_from_jax(_np(jq))
    conv, lin = (carried["unet"]["up_blocks"][0]["resnets"][0]["conv1"],
                 carried["unet"]["time_embedding"]["linear_2"])
    h, w, i, o = conv_j["kernel_q"].shape
    assert conv["kernel_q"].dtype == torch.int8 and tuple(conv["kernel_q"].shape) == (o, i, h, w)
    assert tuple(conv_j["scale"].shape) == (1, 1, 1, o)
    assert tuple(conv["scale"].shape) == (o, 1, 1, 1)
    assert tuple(lin["scale"].shape) == tuple(lin_j["scale"].shape) == (1, lin["kernel_q"].shape[1])
    served = PREG.cast_params(bridge.params_from_jax(_np(jax_bundle.params)), "bfloat16")
    conv_s = served["unet"]["up_blocks"][0]["resnets"][0]["conv1"]
    assert conv_s["scale"].dtype == torch.float32 and conv_s["kernel_q"].dtype == torch.int8
    assert conv_s["kernel_q"].is_contiguous(memory_format=torch.channels_last)
    assert served["unet"]["up_blocks"][0]["resnets"][0]["norm1"]["scale"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dequant_is_the_jax_kernel_bit_for_bit(jax_bundle, w8, dtype):
    jq = JREG.cast_params(jax_bundle.params, "float32")
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for pick in (lambda t: t["up_blocks"][0]["resnets"][0]["conv1"],
                 lambda t: t["time_embedding"]["linear_2"]):
        pj = pick(jq["unet"])
        want = np.asarray(JL._kernel(pj, jdt).astype(jnp.float32))
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        got = PL._kernel(pick(bridge.params_from_jax(_np(jq))["unet"]), dtype).float().numpy()
        np.testing.assert_array_equal(got, want)


def test_w8_linear_and_conv_match_jax(jax_bundle, w8):
    jq = JREG.cast_params(jax_bundle.params, "float32")
    pq = bridge.params_from_jax(_np(jq))
    rng = np.random.default_rng(0)
    lin_j = jq["unet"]["time_embedding"]["linear_2"]
    lin_p = pq["unet"]["time_embedding"]["linear_2"]
    x = rng.normal(size=(3, lin_p["kernel_q"].shape[0])).astype(np.float32)
    np.testing.assert_allclose(PL.linear(lin_p, torch.from_numpy(x)).numpy(),
                               np.asarray(JL.linear(lin_j, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    conv_j = jq["unet"]["up_blocks"][0]["resnets"][0]["conv1"]
    conv_p = pq["unet"]["up_blocks"][0]["resnets"][0]["conv1"]
    x = rng.normal(size=(2, 16, 16, conv_p["kernel_q"].shape[1])).astype(np.float32)
    np.testing.assert_allclose(PL.conv2d(conv_p, torch.from_numpy(x)).numpy(),
                               np.asarray(JL.conv2d(conv_j, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_w8_stream_matches_the_jax_w8_stream(jax_bundle, w8):
    """The LCM ring with w8 weights, the JAX engine's state handed over, a
    prompt update before frame 3: every frame within 1 uint8 level."""
    jq = JREG.cast_params(jax_bundle.params, "float32")
    cfg = JREG.default_stream_config("tiny-test")
    eng = JENG.StreamEngine(jax_bundle.stream_models, jq, cfg, jax_bundle.encode_prompt)
    eng.prepare("a cat", guidance_scale=1.4, delta=0.9, seed=1)
    state0 = _np(eng.state)
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(5)]
    want = []
    for i, f in enumerate(frames):
        if i == 3:
            eng.update_prompt("a dog in space")
        want.append(eng(f))
    # the port's pipeline quantizes the carried dense tree itself (cast_params)
    pipe = StreamDiffusionPipeline(
        "tiny-test", config=PREG.default_stream_config("tiny-test", device="cpu"), device="cpu",
        params=bridge.params_from_jax(_np(jax_bundle.params)))
    assert _count(pipe.bundle.params, "kernel_q") == _count(jq, "kernel_q")
    assert "quant-w8" in pipe.engine.key
    peng = pipe.engine
    peng.state = bridge.state_from_jax(state0)
    dense = PENG.StreamEngine(
        pipe.bundle.stream_models, bridge.params_from_jax(_np(jax_bundle.params)),
        pipe.config, pipe.bundle.encode_prompt, device="cpu")
    dense.state = bridge.state_from_jax(state0)
    moved = 0
    for i, (f, w) in enumerate(zip(frames, want)):
        if i == 3:
            peng.update_prompt("a dog in space")
            dense.update_prompt("a dog in space")
        got = peng(f)
        assert got.shape == w.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(np.int16) - w.astype(np.int16))
        assert diff.max() <= 1, f"frame {i}: max diff {diff.max()}"
        moved = max(moved, int(np.abs(dense(f).astype(np.int16) - got).max()))
    assert moved > 1  # w8 is not the dense stream


def test_w8_engine_key_is_the_jax_key(jax_bundle, w8):
    jq = JREG.cast_params(jax_bundle.params, "float32")
    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    jcfg = JREG.default_stream_config("tiny-test", **{
        k: v for k, v in dataclasses.asdict(cfg).items()
        if k in {f.name for f in dataclasses.fields(JENG.StreamConfig)}})
    dense = bridge.params_from_jax(_np(jax_bundle.params))
    for params, jparams in ((PREG.cast_params(dense, "float32"), jq), (dense, jax_bundle.params)):
        got = PENG.params_variant_extra(params)
        assert got == JENG.params_variant_extra(jparams)
        want = JENG.stream_engine_key("tiny-test", jcfg, **got)
        assert PENG.StreamEngine(PREG.load_model_bundle("tiny-test", device="cpu").stream_models,
                                 params, cfg, lambda p: None, device="cpu",
                                 model_id="tiny-test").key.split("--v-")[0] == want.split("--v-")[0]


def _all_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add((node.module or "").split(".")[0])
    return names


@pytest.mark.parametrize("rel", [
    "ai_rtc_agent_tpu_torch/models/quant.py", "ai_rtc_agent_tpu_torch/utils/quality.py",
    "ai_rtc_agent_tpu_torch/models/unet.py", "ai_rtc_agent_tpu_torch/models/layers.py",
    "ai_rtc_agent_tpu_torch/models/registry.py", "ai_rtc_agent_tpu_torch/stream/engine.py",
    "ai_rtc_agent_tpu_torch/stream/scheduler.py", "ai_rtc_agent_tpu_torch/parallel/multipeer.py",
    "ai_rtc_agent_tpu_torch/server/agent.py", "chip_smoke.py"])
def test_the_slice_imports_no_jax(rel):
    assert not _all_imports(REPO / rel) & {"jax", "jaxlib", "ai_rtc_agent_tpu", "ml_dtypes"}
