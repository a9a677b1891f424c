"""The port's weight loading (models/loader.py, the snapshot path of
models/registry.py) against the JAX package's, on the CPU.

* safetensors files cross both ways between the JAX reader/writer and the
  port's, byte for byte;
* the key maps equal the JAX key maps key for key (unet, taesd, clip);
* a state dict from the JAX ``tree_to_state_dict`` loads into the port
  equal, exactly, to ``bridge.params_from_jax`` of the same tree, and the
  port's own export equals the JAX export;
* value pins (the port's counterparts of tests/test_loader_value_pin.py):
  a checkpoint conv and linear through the port's layers against torch on
  the original weights;
* a missing key raises, SD1.5's full-width tree takes every key at its
  leaf's shape (``proj_in``/``proj_out`` stay 1x1 convs), a snapshot dir
  (or an HF_HUB_CACHE entry) loads through ``load_model_bundle``, and real
  weights with no vocab raise as in JAX.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.models import clip as JC
from ai_rtc_agent_tpu.models import loader as JLD
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.models import taesd as JT
from ai_rtc_agent_tpu.models import unet as JU
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.models import clip as PC
from ai_rtc_agent_tpu_torch.models import layers as PL
from ai_rtc_agent_tpu_torch.models import loader as PLD
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.models import taesd as PT
from ai_rtc_agent_tpu_torch.models import unet as PU
from ai_rtc_agent_tpu_torch.tree import tree_map


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for path, a in g.items():
        assert a.dtype == w[path].dtype and torch.equal(a, w[path]), path


# -- safetensors ---------------------------------------------------------------------

def _tensors(rng):
    return {
        "a": rng.standard_normal((3, 4)).astype(np.float32),
        "b": rng.integers(0, 10, (2,)).astype(np.int32),
        "c": rng.standard_normal((2, 3, 1, 1)).astype(np.float16),
        "d": rng.integers(0, 255, (5,)).astype(np.uint8),
        "e": rng.integers(0, 1 << 40, (2, 2)).astype(np.int64),
    }


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_safetensors_cross_both_ways_byte_for_byte(tmp_path, writer):
    tensors = _tensors(np.random.default_rng(0))
    paths = {side: str(tmp_path / f"{side}.safetensors") for side in ("jax", "port")}
    JLD.write_safetensors(paths["jax"], tensors)
    PLD.write_safetensors(paths["port"], tensors)
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    for reader in (JLD.read_safetensors, PLD.read_safetensors):
        back = reader(paths[writer])
        assert list(back) == list(tensors)
        for k, v in tensors.items():
            assert back[k].dtype == v.dtype
            np.testing.assert_array_equal(back[k], v)


def test_bf16_file_reads_as_jax_reads_it(tmp_path):
    """A BF16 tensor (the packages write none; checkpoints do) widens to f32."""
    vals = np.array([1.0, -2.5, 3.140625, 0.0078125], np.float32)
    raw = (vals.view(np.uint32) >> 16).astype(np.uint16).tobytes()
    header = json.dumps({"w": {"dtype": "BF16", "shape": [2, 2], "data_offsets": [0, len(raw)]},
                         "__metadata__": {"format": "pt"}}).encode()
    path = tmp_path / "bf16.safetensors"
    path.write_bytes(len(header).to_bytes(8, "little") + header + raw)
    got, want = PLD.read_safetensors(str(path)), JLD.read_safetensors(str(path))
    assert list(got) == ["w"] and got["w"].dtype == np.float32
    np.testing.assert_array_equal(got["w"], want["w"])
    np.testing.assert_array_equal(got["w"].ravel(), vals)


# -- key maps ------------------------------------------------------------------------------

KEY_MAPS = {
    "unet-tiny": (JLD.unet_key_map, JU.UNetConfig.tiny(), PLD.unet_key_map, PU.UNetConfig.tiny()),
    "unet-sd15": (JLD.unet_key_map, JU.UNetConfig.sd15(), PLD.unet_key_map, PU.UNetConfig.sd15()),
    "unet-sd21": (JLD.unet_key_map, JU.UNetConfig.sd21(), PLD.unet_key_map, PU.UNetConfig.sd21()),
    "taesd-tiny": (JLD.taesd_key_map, JT.TAESDConfig.tiny(), PLD.taesd_key_map,
                   PT.TAESDConfig.tiny()),
    "taesd": (JLD.taesd_key_map, JT.TAESDConfig(), PLD.taesd_key_map, PT.TAESDConfig()),
    "clip-tiny": (JLD.clip_key_map, JC.CLIPTextConfig.tiny(), PLD.clip_key_map,
                  PC.CLIPTextConfig.tiny()),
    "clip-sd15": (JLD.clip_key_map, JC.CLIPTextConfig.sd15(), PLD.clip_key_map,
                  PC.CLIPTextConfig.sd15()),
    "clip-sd21": (JLD.clip_key_map, JC.CLIPTextConfig.sd21(), PLD.clip_key_map,
                  PC.CLIPTextConfig.sd21()),
}


@pytest.mark.parametrize("name", list(KEY_MAPS))
def test_key_maps_equal_the_jax_key_maps(name):
    jmap, jcfg, pmap, pcfg = KEY_MAPS[name]
    want, got = jmap(jcfg), pmap(pcfg)
    assert list(got.items()) == list(want.items())


# -- trees across ------------------------------------------------------------------------

def _jax_trees():
    k = jax.random.PRNGKey(7)
    return {
        "unet": (JU.init_unet(k, JU.UNetConfig.tiny()), JLD.unet_key_map(JU.UNetConfig.tiny()),
                 lambda: PU.init_unet(torch.Generator().manual_seed(3), PU.UNetConfig.tiny())),
        "taesd": (JT.init_taesd(k, JT.TAESDConfig.tiny()),
                  JLD.taesd_key_map(JT.TAESDConfig.tiny()),
                  lambda: PT.init_taesd(torch.Generator().manual_seed(3), PT.TAESDConfig.tiny())),
        "clip": (JC.init_clip_text(k, JC.CLIPTextConfig.tiny()),
                 JLD.clip_key_map(JC.CLIPTextConfig.tiny()),
                 lambda: PC.init_clip_text(torch.Generator().manual_seed(3),
                                           PC.CLIPTextConfig.tiny())),
    }


@pytest.mark.parametrize("piece", ["unet", "taesd", "clip"])
def test_jax_state_dict_loads_into_the_port_as_params_from_jax(piece):
    jtree, km, port_init = _jax_trees()[piece]
    sd = JLD.tree_to_state_dict(jtree, km)
    loaded, n = PLD.load_into_tree(port_init(), sd, km)
    assert n == len(sd)
    _assert_trees_equal(loaded, bridge.params_from_jax(jax.tree.map(np.asarray, jtree)))
    # and back: the port's export of that tree is the JAX export
    back = PLD.tree_to_state_dict(loaded, km)
    assert list(back) == list(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_load_into_tree_leaves_its_input_and_shares_the_rest():
    params = PC.init_clip_text(torch.Generator().manual_seed(0), PC.CLIPTextConfig.tiny())
    km = PLD.clip_key_map(PC.CLIPTextConfig.tiny())
    sd = {"text_model.final_layer_norm.weight": np.full(32, 2.0, np.float32)}
    before = params["final_norm"]["scale"].clone()
    out, n = PLD.load_into_tree(params, sd, km, strict=False)
    assert n == 1 and torch.equal(params["final_norm"]["scale"], before)
    assert torch.equal(out["final_norm"]["scale"], torch.full((32,), 2.0))
    assert out["layers"][0]["q"]["kernel"] is params["layers"][0]["q"]["kernel"]


@pytest.mark.parametrize("strict", [True, False])
def test_missing_key_raises_only_when_strict(strict):
    cfg = PC.CLIPTextConfig.tiny()
    p = PC.init_clip_text(torch.Generator().manual_seed(5), cfg)
    km = PLD.clip_key_map(cfg)
    sd = PLD.tree_to_state_dict(p, km)
    sd.pop("text_model.final_layer_norm.weight")
    if strict:
        with pytest.raises(KeyError):
            PLD.load_into_tree(p, sd, km, strict=True)
    else:
        assert PLD.load_into_tree(p, sd, km, strict=False)[1] == len(sd)


def test_shape_mismatch_raises():
    cfg = PC.CLIPTextConfig.tiny()
    p = PC.init_clip_text(torch.Generator().manual_seed(5), cfg)
    sd = {"text_model.final_layer_norm.weight": np.zeros(31, np.float32)}
    with pytest.raises(ValueError, match="shape mismatch"):
        PLD.load_into_tree(p, sd, PLD.clip_key_map(cfg), strict=False)


def test_sd15_tree_takes_every_key_at_its_leaf_shape():
    """Full-width SD1.5 (shapes only, on the meta device): every UNet leaf
    has a key whose checkpoint shape lands on it after the layout rule; the
    1x1 proj_in/proj_out convs load as 4-D OIHW kernels."""
    cfg = PU.UNetConfig.sd15()
    tree = PU.init_unet(None, cfg, device="meta")
    km = PLD.unet_key_map(cfg)
    covered = set()
    for key, path in km.items():
        node, exists = PLD._lookup(tree, path)
        if not exists:
            assert "conv_shortcut" in key, key
            continue
        covered.add(path)
        leaf = node[path[-1]]
        if path[-2] in ("proj_in", "proj_out") and path[-1] == "kernel":
            assert leaf.ndim == 4 and leaf.shape[2:] == (1, 1), key
    assert covered == {p for p, _ in _leaves(tree)}


# -- value pins (torch on the checkpoint's own layout) --------------------------------------

def _asym(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture()
def crafted(tmp_path):
    sd = {
        "conv.weight": _asym((5, 3, 3, 3), 1),  # OIHW
        "conv.bias": _asym((5,), 2),
        "fc.weight": _asym((7, 5), 3),  # [O, I]
        "fc.bias": _asym((7,), 4),
    }
    path = str(tmp_path / "model.safetensors")
    JLD.write_safetensors(path, sd)
    params = {"conv": {"kernel": torch.zeros(5, 3, 3, 3), "bias": torch.zeros(5)},
              "fc": {"kernel": torch.zeros(5, 7), "bias": torch.zeros(7)}}
    key_map = {"conv.weight": ("conv", "kernel"), "conv.bias": ("conv", "bias"),
               "fc.weight": ("fc", "kernel"), "fc.bias": ("fc", "bias")}
    loaded, n = PLD.load_into_tree(params, PLD.read_safetensors(path), key_map)
    assert n == 4
    return sd, loaded


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_values_match_torch(crafted, stride):
    sd, loaded = crafted
    x = _asym((2, 8, 6, 3), 10)
    ours = PL.conv2d(loaded["conv"], torch.from_numpy(x), stride=stride,
                     padding="SAME" if stride == 1 else 1)
    ref = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(sd["conv.weight"]),
                   torch.from_numpy(sd["conv.bias"]), stride=stride, padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(ours, ref, rtol=1e-5, atol=1e-5)


def test_linear_values_match_torch(crafted):
    sd, loaded = crafted
    x = torch.from_numpy(_asym((4, 5), 12))
    ref = F.linear(x, torch.from_numpy(sd["fc.weight"]), torch.from_numpy(sd["fc.bias"]))
    torch.testing.assert_close(PL.linear(loaded["fc"], x), ref, rtol=1e-5, atol=1e-5)


# -- the registry's snapshot path --------------------------------------------------------------

def _write_snapshot(root, params, unet_cfg, clip_cfg, taesd_cfg, vocab=True):
    for sub, km, tree in (("unet", PLD.unet_key_map(unet_cfg), params["unet"]),
                          ("text_encoder", PLD.clip_key_map(clip_cfg), params["clip"]),
                          ("vae", PLD.taesd_key_map(taesd_cfg), params["taesd"])):
        os.makedirs(root / sub, exist_ok=True)
        PLD.write_safetensors(str(root / sub / "model.safetensors"),
                              PLD.tree_to_state_dict(tree, km))
    if vocab:
        tok = root / "tokenizer"
        tok.mkdir(exist_ok=True)
        words = {"<|startoftext|>": 0, "<|endoftext|>": 1, "a</w>": 2, "cat</w>": 3}
        (tok / "vocab.json").write_text(json.dumps(words))
        (tok / "merges.txt").write_text("#version: 0.2\nc at</w>\n")


def test_snapshot_dir_as_model_id_loads_its_weights(tmp_path):
    """A tiny-test snapshot written from seed 11 loads into a bundle built
    from seed 0: the bundle's tree is the written one, leaf for leaf."""
    snap = tmp_path / "tiny-test-snapshot"
    written = PREG.init_params("tiny", seed=11)
    _write_snapshot(snap, written, *PREG._model_configs("tiny"))
    bundle = PREG.load_model_bundle(str(snap), device="cpu", seed=0)
    assert bundle.loaded_real_weights and bundle.family == "tiny"
    _assert_trees_equal(bundle.params, written)
    assert not PREG.load_model_bundle("tiny-test", device="cpu").loaded_real_weights


def test_hf_hub_cache_resolves_as_jax_resolves(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    for rev in ("0abc", "1def"):
        (tmp_path / "models--org--sd15-x" / "snapshots" / rev).mkdir(parents=True)
    for mid in ("org/sd15-x", "org/none", str(tmp_path)):
        assert PREG.resolve_snapshot_dir(mid) == JREG.resolve_snapshot_dir(mid)
    assert PREG.resolve_snapshot_dir("org/sd15-x").endswith("1def")


def test_real_weights_with_missing_vocab_is_a_hard_error(tmp_path, monkeypatch):
    """As the JAX registry: a real family whose weights loaded but whose
    snapshot has no vocab refuses (hash ids over a real embedding table
    are garbage); with the vocab files the bundle builds and encodes."""
    monkeypatch.setattr(PREG, "family_of", lambda mid: "sd15")
    tiny = PREG._model_configs("tiny")
    monkeypatch.setattr(PREG, "_model_configs", lambda fam: tiny)
    monkeypatch.setattr(PREG, "resolve_snapshot_dir", lambda mid: str(tmp_path))
    monkeypatch.setattr(PREG, "_try_load_weights", lambda *a, **k: True)
    with pytest.raises(FileNotFoundError, match="HashTokenizer"):
        PREG.load_model_bundle("fake/real-model", device="cpu")
    _write_snapshot(tmp_path, PREG.init_params("tiny", seed=1), *tiny)
    bundle = PREG.load_model_bundle("fake/real-model", device="cpu")
    assert bundle.loaded_real_weights
    cond, uncond = bundle.encode_prompt("a cat")
    assert torch.isfinite(cond).all() and cond.shape == uncond.shape


def test_registry_matches_the_jax_bundle_loaded_from_the_same_snapshot(tmp_path):
    """One snapshot, both registries: the port's bundle tree is
    ``params_from_jax`` of the JAX bundle's, exactly."""
    snap = tmp_path / "tiny-test-snap"
    _write_snapshot(snap, PREG.init_params("tiny", seed=4), *PREG._model_configs("tiny"))
    jb = JREG.load_model_bundle(str(snap))
    pb = PREG.load_model_bundle(str(snap), device="cpu")
    assert jb.loaded_real_weights and pb.loaded_real_weights
    want = bridge.params_from_jax(jax.tree.map(np.asarray, jb.params))
    _assert_trees_equal(pb.params, tree_map(lambda a: a, want))


def test_phase12_snapshot_helpers_load_bit_for_bit(tmp_path, monkeypatch):
    """chip_smoke phase 12a's helpers at tiny size: a snapshot written from
    a seeded tree and the two synthetic LCM-LoRAs (diffusers and kohya)
    load through load_model_bundle as the seeded tree plus the f32 fusion,
    bit for bit in f32 and cast once to bf16; a tree without the fusion
    fails the check."""
    import chip_smoke

    model_id = "org/tiny-test-hub"
    snap = tmp_path / "models--org--tiny-test-hub" / "snapshots" / "x"
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    seeded = PREG.init_params("tiny", seed=3)
    sizes = chip_smoke.sd15_snapshot(torch, np, seeded, snap, model_id)
    lora_dict, plans = chip_smoke.lcm_lora_files(torch, np, seeded["unet"], tmp_path, model_id)
    want = chip_smoke.expected_unet(torch, np, seeded["unet"], plans)
    assert set(sizes) == {"unet", "text_encoder", "vae"} and len(lora_dict) == 2
    assert all(len(plan) for _, plan in plans)
    bundle = PREG.load_model_bundle(model_id, device="cpu", attn_impl="plain",
                                    lora_dict=lora_dict)
    assert bundle.loaded_real_weights
    n = chip_smoke.hold_loaded(torch, "f32", bundle.params, seeded, want, torch.float32)
    assert n == sum(1 for _ in chip_smoke._tree_paths(seeded))
    cast = PREG.cast_params(bundle.params, "bfloat16")
    assert chip_smoke.hold_loaded(torch, "bf16", cast, seeded, want, torch.bfloat16) == n
    with pytest.raises(SystemExit):
        chip_smoke.hold_loaded(torch, "unfused", seeded, seeded, want, torch.float32)
