"""The port's LoRA fusion (models/lora.py, ``lora_dict`` in the registry)
against the JAX package's, on the CPU, tiny-test UNet.

Factors made from a numpy seed in both formats: diffusers/peft
(``<module>.lora_A.weight``/``lora_B``, no alpha) and kohya
(``lora_unet_<module_underscored>.lora_down.weight``/``lora_up`` and
``alpha``), on linear targets (attention projections, ``to_out.0``, the
feed-forward) and conv targets (a 1x1 ``proj_in``, a 3x3 resnet conv with
a linear-shaped LoRA on its centre tap, one with a 3x3 LoRA).  The port's
fused tree must equal ``bridge.params_from_jax`` of the JAX fusion within 1e-6
(f32 on both sides).  A miskeyed adapter is loud and a zero-match one
raises at the registry, as in JAX.
"""

import logging
import os

import jax
import numpy as np
import pytest
import torch

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.models import loader as JLD
from ai_rtc_agent_tpu.models import lora as JLR
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.models import unet as JU
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.models import loader as PLD
from ai_rtc_agent_tpu_torch.models import lora as PLR
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline

ATTN = "down_blocks.0.attentions.0"
BLOCK = f"{ATTN}.transformer_blocks.0"
# (module, down shape, up shape) on the tiny UNet (block 0 is 8 wide)
TARGETS = [
    (f"{BLOCK}.attn1.to_q", (4, 8), (8, 4)),
    (f"{BLOCK}.attn1.to_k", (4, 8), (8, 4)),
    (f"{BLOCK}.attn2.to_v", (4, 32), (8, 4)),
    (f"{BLOCK}.attn2.to_out.0", (4, 8), (8, 4)),
    (f"{BLOCK}.ff.net.2", (4, 32), (8, 4)),
    (f"{ATTN}.proj_in", (4, 8, 1, 1), (8, 4, 1, 1)),
    ("down_blocks.0.resnets.0.conv1", (4, 8), (8, 4)),
    ("up_blocks.1.resnets.0.conv2", (4, 8, 3, 3), (8, 4, 1, 1)),
]


def _factors(seed):
    rng = np.random.default_rng(seed)
    return [(m, rng.standard_normal(d).astype(np.float32) * 0.3,
             rng.standard_normal(u).astype(np.float32) * 0.3) for m, d, u in TARGETS]


def lora_state_dict(fmt: str, seed: int = 0) -> dict:
    sd = {}
    for module, down, up in _factors(seed):
        if fmt == "diffusers":
            sd[f"unet.{module}.lora_A.weight"] = down
            sd[f"unet.{module}.lora_B.weight"] = up
        else:
            base = "lora_unet_" + module.replace(".", "_")
            sd[f"{base}.lora_down.weight"] = down
            sd[f"{base}.lora_up.weight"] = up
            sd[f"{base}.alpha"] = np.array(2.0, np.float32)
    return sd


@pytest.fixture(scope="module")
def jax_unet():
    return JU.init_unet(jax.random.PRNGKey(6), JU.UNetConfig.tiny())


def _max_diff(got, want):
    worst = 0.0
    for (pg, a), (pw, b) in zip(_leaves(got), _leaves(want)):
        assert pg == pw
        worst = max(worst, float((a - b).abs().max()))
    return worst


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


@pytest.mark.parametrize("scale", [1.0, 0.7])
@pytest.mark.parametrize("fmt", ["diffusers", "kohya"])
def test_fusion_matches_the_jax_fusion(jax_unet, fmt, scale):
    sd = lora_state_dict(fmt)
    jgroups, pgroups = JLR.parse_lora_state_dict(sd), PLR.parse_lora_state_dict(sd)
    assert list(pgroups) == list(jgroups) and len(pgroups) == len(TARGETS)
    jkm = JLD.unet_key_map(JU.UNetConfig.tiny())
    pkm = PLD.unet_key_map(PREG._model_configs("tiny")[0])
    for path in pgroups:
        assert PLR.resolve_lora_target(path, pkm) == JLR.resolve_lora_target(path, jkm)
    jfused, jn, jun = JLR.fuse_lora_into_unet(jax_unet, jgroups, jkm, scale=scale)
    base = bridge.params_from_jax(jax.tree.map(np.asarray, jax_unet))
    pfused, pn, pun = PLR.fuse_lora_into_unet(base, pgroups, pkm, scale=scale)
    assert (pn, pun) == (jn, jun) == (len(TARGETS), [])
    want = bridge.params_from_jax(jax.tree.map(np.asarray, jfused))
    assert _max_diff(pfused, want) <= 1e-6
    # every target moved; the input tree kept its leaves
    assert _max_diff(base, bridge.params_from_jax(jax.tree.map(np.asarray, jax_unet))) == 0.0
    q = pfused["down_blocks"][0]["attentions"][0]["blocks"][0]["attn1"]["to_q"]["kernel"]
    assert not torch.equal(q, base["down_blocks"][0]["attentions"][0]["blocks"][0]["attn1"]
                           ["to_q"]["kernel"])


def test_delta_layouts_against_torch_modules():
    """The delta in the port's layouts equals torch's W + up @ down on the
    checkpoint layout, turned by the loader's rule: a linear's [O,I]
    transposed, a conv's OIHW as it is (a linear-shaped LoRA on a 3x3 conv
    on the centre tap)."""
    rng = np.random.default_rng(3)
    down, up = rng.standard_normal((2, 5)).astype(np.float32), rng.standard_normal(
        (7, 2)).astype(np.float32)
    np.testing.assert_allclose(PLR.lora_delta((5, 7), down, up), (up @ down).T, rtol=1e-6)
    got = PLR.lora_delta((7, 5, 3, 3), down, up)
    want = np.zeros((7, 5, 3, 3), np.float32)
    want[:, :, 1, 1] = up @ down
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_miskeyed_adapter_is_loud_and_a_zero_match_raises(jax_unet, tmp_path, caplog):
    rng = np.random.default_rng(1)
    sd = {
        "lora_unet_mid_block_bogus_module_to_q.lora_down.weight":
            rng.standard_normal((2, 8)).astype(np.float32),
        "lora_unet_mid_block_bogus_module_to_q.lora_up.weight":
            rng.standard_normal((8, 2)).astype(np.float32),
    }
    groups = PLR.parse_lora_state_dict(sd)
    base = bridge.params_from_jax(jax.tree.map(np.asarray, jax_unet))
    km = PLD.unet_key_map(PREG._model_configs("tiny")[0])
    with caplog.at_level(logging.WARNING, logger="ai_rtc_agent_tpu_torch.models.lora"):
        fused, applied, unmatched = PLR.fuse_lora_into_unet(base, groups, km)
    assert applied == 0 and unmatched == list(groups)
    assert any("DROPPED" in rec.message for rec in caplog.records)
    assert fused["mid_block"] is base["mid_block"]
    path = os.path.join(tmp_path, "bogus_style.safetensors")
    PLD.write_safetensors(path, sd)
    for load in (lambda: JREG.load_model_bundle("tiny-test", lora_dict={path: 1.0}),
                 lambda: PREG.load_model_bundle("tiny-test", device="cpu",
                                                lora_dict={path: 1.0})):
        with pytest.raises(ValueError, match="matched 0 of"):
            load()


def test_registry_fuses_lora_files_as_the_jax_registry(tmp_path):
    """Two LoRA files, one in each format, fused at load by both registries
    into the same base weights: the port's bundle equals the JAX bundle's
    within 1e-6, and the pipeline serves the fused weights (f32)."""
    paths = {}
    for i, fmt in enumerate(("diffusers", "kohya")):
        paths[fmt] = os.path.join(tmp_path, f"{fmt}.safetensors")
        PLD.write_safetensors(paths[fmt], lora_state_dict(fmt, seed=10 + i))
    lora_dict = {paths["diffusers"]: 1.0, paths["kohya"]: 0.5}
    jbase = JREG.load_model_bundle("tiny-test")
    jfused = JREG.load_model_bundle("tiny-test", lora_dict=lora_dict)
    base = bridge.params_from_jax(jax.tree.map(np.asarray, jbase.params))
    pb = PREG.load_model_bundle("tiny-test", device="cpu", params=base, lora_dict=lora_dict)
    want = bridge.params_from_jax(jax.tree.map(np.asarray, jfused.params))
    assert _max_diff(pb.params, want) <= 1e-6
    pipe = StreamDiffusionPipeline("tiny-test", device="cpu", params=base, lora_dict=lora_dict)
    assert _max_diff(pipe.bundle.params, pb.params) == 0.0
