"""Per-session style adapters (``adapters/``, ADAPTER_DIR) in the port against
the JAX package, on the CPU: tiny-test, f32, the JAX weights carried by
``bridge``, the JAX scheduler's stacked states (the factor bank among them)
handed over by ``states_from_jax``.

* The registry, case by case as ``tests/test_adapters.py`` pins the JAX
  one: rank buckets and their refusals, the loud drops, a wrong base model,
  ``factor_rows``' zero extension (equal to the JAX rows), the alpha fold,
  the graft, the fingerprint (equal to the JAX registry's on tiny-test and
  at SD2.1's and SD1.5's full geometry, shapes only), ``build_registry``
  over a directory, ``ADAPTER_RANK_BUCKETS``.  w8 params fail on both
  packages: the JAX registry with KeyError 'kernel', the port with a
  ValueError naming the combination.
* ``layers.linear`` with shared and per-row factors against the JAX linear
  (and its vmap), rtol 1e-5.
* The session step: k = 3 sessions (a rank-4 style, none, a rank-8 style) in
  a rank-8 bank, the bucket of 4 padded, through the port's and the JAX
  ``BatchScheduler`` in every mode (the ring with the fused epilogue and
  without, full CFG, sequential, txt2img, DeepCache capture and cached, a
  ControlNet), a per-session swap mid-stream: every frame within 1 uint8
  level.
* A zero slot is bit for bit the same session of a rank-0 scheduler, and a
  styled session is within 1 level of its style fused offline.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.adapters import AdapterRegistry as JAdapterRegistry
from ai_rtc_agent_tpu.adapters.registry import targets_digest as jtargets_digest
from ai_rtc_agent_tpu.models import layers as JL
from ai_rtc_agent_tpu.models import loader as JLD
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.models import unet as JU
from ai_rtc_agent_tpu.stream.scheduler import BatchScheduler as JBatchScheduler
from ai_rtc_agent_tpu.utils import env as jenv
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.adapters import (
    AdapterRegistry,
    build_registry,
    graft_unet_params,
    targets_digest,
    zero_factor_rows,
)
from ai_rtc_agent_tpu_torch.models import layers as PL
from ai_rtc_agent_tpu_torch.models import loader as PLD
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.models import unet as PU
from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler
from ai_rtc_agent_tpu_torch.utils import env as penv
from test_torch_controlnet import CNET, wake_zero_convs

# the diffusers spelling (what the parser emits) of two tiny-test attention linears
MQ_DIFF = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q"
MV_DIFF = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_v"
# the tree spelling (bank rows, graft paths)
MQ_TREE = "down_blocks.0.attentions.0.blocks.0.attn1.to_q"
MV_TREE = "down_blocks.0.attentions.0.blocks.0.attn1.to_v"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _frames(n, seed, size=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(n)]


def _levels(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max())


@pytest.fixture(scope="module")
def jax_bundle():
    b = JREG.load_model_bundle("tiny-test", controlnet=CNET)
    wake_zero_convs(b.params["controlnet"])
    return b


@pytest.fixture(scope="module")
def port_bundle(jax_bundle):
    return PREG.load_model_bundle("tiny-test", device="cpu", controlnet=CNET,
                                  params=bridge.params_from_jax(_np(jax_bundle.params)))


@pytest.fixture()
def reg(port_bundle):
    return AdapterRegistry(port_bundle.params["unet"], PLD.unet_key_map(port_bundle.unet_cfg))


def _group(rng, r=2, din=8, dout=8, alpha=None):
    return {
        "down": (rng.normal(size=(r, din)) * 0.2).astype(np.float32),
        "up": (rng.normal(size=(dout, r)) * 0.2).astype(np.float32),
        "alpha": float(r) if alpha is None else float(alpha),
    }


# -- the registry ----------------------------------------------------------------------

def test_rank_bucketing_pads_and_refuses(reg, rng):
    reg.add("small", {MQ_DIFF: _group(rng, r=2)})
    assert reg.rank_of("small") == 4
    reg.add("mid", {MQ_DIFF: _group(rng, r=5)})
    assert reg.rank_of("mid") == 8 and reg.bank_rank == 8
    with pytest.raises(ValueError, match="refusing to truncate"):
        reg.add("huge", {MQ_DIFF: _group(rng, r=17)})
    assert "huge" not in reg
    down = reg.factor_rows("small")[MQ_TREE]["down"]
    assert down.shape == (8, 8) and down.dtype == torch.float32
    assert torch.all(down[2:] == 0) and torch.any(down[:2] != 0)


def test_drops_te_conv_unmatched_loudly(reg, rng, caplog):
    groups = {
        MQ_DIFF: _group(rng),
        f"te.{MQ_DIFF}": _group(rng),
        "down_blocks.0.resnets.0.conv1": _group(rng, din=8),
        "mid_block.bogus.to_q": _group(rng),
    }
    with caplog.at_level(logging.WARNING, logger="ai_rtc_agent_tpu_torch.adapters.registry"):
        applied, dropped = reg.add("partial", groups)
    assert applied == 1 and len(dropped) == 3
    assert "DROPPED" in caplog.text and "mid_block.bogus.to_q" in caplog.text
    assert list(reg.targets) == [MQ_TREE]
    with pytest.raises(ValueError, match="matched 0 of"):
        reg.add("bogus", {"mid_block.bogus.to_q": _group(rng)})
    assert "bogus" not in reg


def test_shape_mismatch_is_wrong_base_model(reg, rng):
    with pytest.raises(ValueError, match="wrong base model"):
        reg.add("misfit", {MQ_DIFF: _group(rng, din=16)})


def test_factor_rows_zero_extension_refusals_and_the_jax_rows(reg, jax_bundle, rng):
    gA, gB = {MQ_DIFF: _group(rng)}, {MQ_DIFF: _group(rng), MV_DIFF: _group(rng)}
    jreg = JAdapterRegistry(jax_bundle.params["unet"], JLD.unet_key_map(jax_bundle.unet_cfg))
    for r in (reg, jreg):
        r.add("styleA", gA)
        r.add("styleB", gB)
    assert set(reg.targets) == {MQ_TREE, MV_TREE} and reg.targets == jreg.targets
    rows = reg.factor_rows("styleA")
    assert set(rows) == {MQ_TREE, MV_TREE}
    assert torch.any(rows[MQ_TREE]["down"] != 0)
    assert not torch.any(rows[MV_TREE]["down"]) and not torch.any(rows[MV_TREE]["up"])
    for name in ("styleA", "styleB", None):
        got, want = reg.factor_rows(name), _np(jreg.factor_rows(name))
        for path in want:
            for part in ("down", "up"):
                assert got[path][part].numpy().tobytes() == want[path][part].tobytes()
    z = reg.factor_rows(None, dtype=torch.bfloat16)
    assert z[MQ_TREE]["down"].dtype == torch.bfloat16 and not torch.any(z[MQ_TREE]["down"])
    with pytest.raises(KeyError, match="unknown adapter"):
        reg.factor_rows("nope")
    with pytest.raises(ValueError, match="rebuild the scheduler"):
        reg.factor_rows("styleA", rank=2)
    with pytest.raises(ValueError, match="outside the bound bank target set"):
        reg.factor_rows("styleB", targets={MQ_TREE: (8, 8)})


def test_scale_alpha_folded_into_up(reg, rng):
    g = _group(rng, r=2, alpha=1.0)  # alpha/r = 0.5
    reg.add("scaled", {MQ_DIFF: g}, scale=2.0)  # s = 2.0 * 0.5 = 1.0
    rows = reg.factor_rows("scaled")
    np.testing.assert_allclose(rows[MQ_TREE]["up"].numpy()[:, :2], g["up"], rtol=1e-6)
    np.testing.assert_allclose(rows[MQ_TREE]["down"].numpy()[:2], g["down"], rtol=1e-6)


def test_graft_inserts_factors_beside_kernel(port_bundle, reg, rng):
    unet = port_bundle.params["unet"]
    reg.add("styleA", {MQ_DIFF: _group(rng)})
    rows = reg.factor_rows("styleA")
    grafted = graft_unet_params(unet, rows)
    base_mod = unet["down_blocks"][0]["attentions"][0]["blocks"][0]["attn1"]["to_q"]
    mod = grafted["down_blocks"][0]["attentions"][0]["blocks"][0]["attn1"]["to_q"]
    assert "lora_down" in mod and "lora_up" in mod and mod["kernel"] is base_mod["kernel"]
    assert grafted["mid_block"] is unet["mid_block"]
    assert "lora_down" not in base_mod  # the served tree is untouched
    x = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    want = PL.linear(base_mod, x) + (x @ rows[MQ_TREE]["down"].T) @ rows[MQ_TREE]["up"].T
    torch.testing.assert_close(PL.linear(mod, x), want, rtol=1e-6, atol=0)
    zrows = zero_factor_rows({MQ_TREE: (8, 8)}, 4)
    zmod = dict(mod, lora_down=zrows[MQ_TREE]["down"], lora_up=zrows[MQ_TREE]["up"])
    assert torch.equal(PL.linear(zmod, x), PL.linear(base_mod, x))


def test_fingerprint_tracks_bank_shape_not_names_and_equals_the_jax_one(reg, jax_bundle, rng):
    jreg = JAdapterRegistry(jax_bundle.params["unet"], JLD.unet_key_map(jax_bundle.unet_cfg))
    assert reg.fingerprint() == jreg.fingerprint() == {
        "adapter_rank": 0, "adapter_targets": targets_digest({})}
    gA, gA2, gB = {MQ_DIFF: _group(rng)}, {MQ_DIFF: _group(rng)}, {MV_DIFF: _group(rng)}
    for r in (reg, jreg):
        r.add("styleA", gA)
    fp1 = reg.fingerprint()
    assert fp1 == jreg.fingerprint() and fp1["adapter_rank"] == 4
    reg.add("styleA2", gA2)
    assert reg.fingerprint() == fp1
    for r in (reg, jreg):
        r.add("styleB", gB)
    assert reg.fingerprint() != fp1 and reg.fingerprint() == jreg.fingerprint()


@pytest.mark.parametrize("geometry,n_targets,n_convs", [("sd21", 192, 0), ("sd15", 160, 32)])
def test_full_geometry_targets_and_digest_equal_the_jax_registry(geometry, n_targets, n_convs,
                                                                 tmp_path):
    """chip_smoke phase 15's synthetic adapter over every transformer block of
    the full UNet, resolved on shape-only trees of both packages: the same
    targets, dims and digest (16 blocks x 12 targets at SD2.1; at SD1.5 the
    1x1-conv proj_in/proj_out are dropped)."""
    pcfg, jcfg = getattr(PU.UNetConfig, geometry)(), getattr(JU.UNetConfig, geometry)()
    modules = chip_smoke.adapter_modules(pcfg)
    assert len(modules) == n_targets + n_convs
    assert sum(len(s) == 4 for s in modules.values()) == n_convs
    sd = {}
    rng = np.random.default_rng(0)
    for mod, shape in modules.items():  # rank 1: the digest reads names and dims only
        din, dout = (shape[1], shape[0]) if len(shape) == 4 else shape
        tail = (1, 1) if len(shape) == 4 else ()
        key = "lora_unet_" + mod.replace(".", "_")
        sd[f"{key}.lora_down.weight"] = rng.standard_normal((1, din) + tail).astype(np.float32)
        sd[f"{key}.lora_up.weight"] = rng.standard_normal((dout, 1) + tail).astype(np.float32)
    from ai_rtc_agent_tpu.models import lora as JLR
    from ai_rtc_agent_tpu_torch.models import lora as PLR

    ptree = PU.init_unet(None, pcfg, "meta")
    jtree = jax.eval_shape(lambda: JU.init_unet(jax.random.PRNGKey(0), jcfg))
    preg = AdapterRegistry(ptree, PLD.unet_key_map(pcfg))
    jreg = JAdapterRegistry(jtree, JLD.unet_key_map(jcfg))
    applied, dropped = preg.add("full", PLR.parse_lora_state_dict(sd))
    japplied, jdropped = jreg.add("full", JLR.parse_lora_state_dict(sd))
    assert (applied, len(dropped)) == (japplied, len(jdropped)) == (n_targets, n_convs)
    assert preg.targets == jreg.targets
    assert preg.fingerprint() == jreg.fingerprint()
    assert targets_digest(preg.targets) == jtargets_digest(jreg.targets)
    per_rank = sum(i + o for i, o in preg.targets.values())  # a slot's elements per rank unit
    assert per_rank == {"sd21": 432128, "sd15": 374016}[geometry]


def test_build_registry_scans_directory(port_bundle, rng, tmp_path):
    kohya = "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q"
    for name in ("ghibli", "noir"):
        g = _group(rng)
        PLD.write_safetensors(str(tmp_path / f"{name}.safetensors"), {
            f"{kohya}.lora_down.weight": g["down"],
            f"{kohya}.lora_up.weight": g["up"],
            f"{kohya}.alpha": np.array(g["alpha"], np.float32),
        })
    unet, cfg = port_bundle.params["unet"], port_bundle.unet_cfg
    got = build_registry(unet, cfg, str(tmp_path))
    assert got.names == ["ghibli", "noir"] and got.bank_rank == 4
    empty = build_registry(unet, cfg, None)
    assert len(empty) == 0 and empty.bank_rank == 0
    broken = tmp_path / "broken.safetensors"
    PLD.write_safetensors(str(broken), {
        "lora_unet_mid_block_bogus_to_q.lora_down.weight": _group(rng)["down"],
        "lora_unet_mid_block_bogus_to_q.lora_up.weight": _group(rng)["up"],
    })
    with pytest.raises(ValueError, match="matched 0 of") as e:
        build_registry(unet, cfg, str(tmp_path))
    assert str(broken) in str(e.value)  # the boot refusal names the file


def test_env_rank_buckets_parsing(monkeypatch):
    for env in (penv, jenv):
        monkeypatch.delenv("ADAPTER_RANK_BUCKETS", raising=False)
        assert env.adapter_rank_buckets() == (4, 8, 16)
        monkeypatch.setenv("ADAPTER_RANK_BUCKETS", "2, 8,32")
        assert env.adapter_rank_buckets() == (2, 8, 32)
        for bad in ("8,zero", "0,4"):
            monkeypatch.setenv("ADAPTER_RANK_BUCKETS", bad)
            with pytest.raises(ValueError):
                env.adapter_rank_buckets()
        monkeypatch.delenv("ADAPTER_RANK_BUCKETS", raising=False)
        monkeypatch.delenv("ADAPTER_DIR", raising=False)
        assert env.adapter_dir() is None
        monkeypatch.setenv("ADAPTER_DIR", "/styles")
        assert env.adapter_dir() == "/styles"


def test_w8_with_adapters_fails_on_both_packages(jax_bundle, port_bundle, rng, monkeypatch):
    """QUANT_WEIGHTS=w8 turns the target kernels into int8 pairs: the JAX
    registry raises KeyError 'kernel' (its agent then serves the shared
    engine without styles); the port refuses with a ValueError naming the
    combination, so the agent does not boot."""
    monkeypatch.setenv("QUANT_WEIGHTS", "w8")
    monkeypatch.setenv("QUANT_MIN_SIZE", "16")
    jq = JREG.cast_params(jax_bundle.params, "float32")
    pq = PREG.cast_params(port_bundle.params, "float32")
    g = {MQ_DIFF: _group(rng)}
    with pytest.raises(KeyError, match="kernel"):
        JAdapterRegistry(jq["unet"], JLD.unet_key_map(jax_bundle.unet_cfg)).add("s", g)
    with pytest.raises(ValueError, match="ADAPTER_DIR with QUANT_WEIGHTS=w8"):
        AdapterRegistry(pq["unet"], PLD.unet_key_map(port_bundle.unet_cfg)).add("s", g)


# -- layers.linear -----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 8), (5, 7, 8)])
@pytest.mark.parametrize("per_row", [False, True])
def test_linear_with_factors_matches_jax(shape, per_row):
    rng = np.random.default_rng(3)
    p = {"kernel": rng.normal(size=(8, 6)).astype(np.float32),
         "bias": rng.normal(size=(6,)).astype(np.float32)}
    lead = (shape[0],) if per_row else ()
    down = rng.normal(size=lead + (4, 8)).astype(np.float32)
    up = rng.normal(size=lead + (6, 4)).astype(np.float32)
    x = rng.normal(size=shape).astype(np.float32)

    def jlin(pp, xx, d, u):
        return JL.linear(dict(pp, lora_down=d, lora_up=u), xx)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = (jax.vmap(jlin, in_axes=(None, 0, 0, 0)) if per_row else jlin)(
        jp, jnp.asarray(x), jnp.asarray(down), jnp.asarray(up))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = PL.linear(dict(tp, lora_down=torch.from_numpy(down), lora_up=torch.from_numpy(up)),
                    torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    zero = dict(tp, lora_down=torch.zeros_like(torch.from_numpy(down)),
                lora_up=torch.zeros_like(torch.from_numpy(up)))
    assert torch.equal(PL.linear(zero, torch.from_numpy(x)), PL.linear(tp, torch.from_numpy(x)))
    if per_row:  # each row its own factors: another row count is refused
        with pytest.raises(ValueError, match="per-row factors"):
            PL.lora_residual(torch.from_numpy(down)[:2], torch.from_numpy(up)[:2],
                             torch.from_numpy(x))


# -- the session step --------------------------------------------------------------------

STYLE_MODULES_A = [MQ_DIFF, MV_DIFF, "mid_block.attentions.0.transformer_blocks.0.attn2.to_k",
                   "up_blocks.1.attentions.1.transformer_blocks.0.ff.net.2"]
STYLE_MODULES_B = [m.replace("attn1", "attn2") for m in STYLE_MODULES_A[:2]] + [
    "up_blocks.1.attentions.0.transformer_blocks.0.attn1.to_out.0",
    "mid_block.attentions.0.transformer_blocks.0.ff.net.0.proj",
    "time_embedding.linear_1", "down_blocks.0.resnets.0.time_emb_proj"]
SESSIONS = (("a", "a cat", 1, "styleA"), ("b", "a dog", 2, None), ("c", "a fox", 3, "styleB"))
MODES = {
    "ring_fused": {},
    "ring_unfused": dict(use_fused_epilogue=False),
    "full": dict(cfg_type="full", use_fused_epilogue=False),
    "sequential": dict(use_denoising_batch=False, use_fused_epilogue=False),
    "txt2img": dict(mode="txt2img"),
    "deepcache": dict(unet_cache_interval=2),
    "controlnet": dict(use_controlnet=True),
}


def _style_groups(unet_cfg, modules, r, seed):
    rng = np.random.default_rng(seed)
    params = PU.init_unet(None, unet_cfg, "meta")
    key_map = PLD.unet_key_map(unet_cfg)
    out = {}
    for m in modules:
        path = key_map[m + ".weight"]
        node = params
        for p in path:
            node = node[p]
        din, dout = node.shape
        out[m] = {"down": (rng.normal(size=(r, din)) * 0.5).astype(np.float32),
                  "up": (rng.normal(size=(dout, r)) * 0.5).astype(np.float32),
                  "alpha": float(r)}
    return out


@pytest.fixture(scope="module")
def styles(port_bundle):
    """styleA: rank 3 (bucket 4) on four modules; styleB: rank 6 (bucket 8) on
    six, two of them 2-D time-embedding linears: a rank-8 bank."""
    return {"styleA": _style_groups(port_bundle.unet_cfg, STYLE_MODULES_A, 3, 51),
            "styleB": _style_groups(port_bundle.unet_cfg, STYLE_MODULES_B, 6, 52)}


def _registries(jax_bundle, port_bundle, styles):
    jreg = JAdapterRegistry(jax_bundle.params["unet"], JLD.unet_key_map(jax_bundle.unet_cfg))
    preg = AdapterRegistry(port_bundle.params["unet"], PLD.unet_key_map(port_bundle.unet_cfg))
    for name, g in styles.items():
        jreg.add(name, g)
        preg.add(name, g)
    assert preg.bank_rank == jreg.bank_rank == 8
    return jreg, preg


def _port_sched(b, cfg, adapters=None):
    return BatchScheduler(b.stream_models, b.params, cfg, b.encode_prompt, max_sessions=4,
                          window_ms=10_000.0, device="cpu", adapters=adapters)


@pytest.mark.parametrize("mode", list(MODES))
def test_session_step_with_a_mixed_adapter_bucket_matches_the_jax_bucket_step(
        jax_bundle, port_bundle, styles, mode):
    over = MODES[mode]
    jcfg = JREG.default_stream_config("tiny-test", **over)
    pcfg = PREG.default_stream_config("tiny-test", device="cpu", **over)
    jreg, preg = _registries(jax_bundle, port_bundle, styles)
    js = JBatchScheduler(jax_bundle.stream_models, jax_bundle.params, jcfg,
                         jax_bundle.encode_prompt, max_sessions=4, window_ms=10_000.0,
                         prewarm=False, dp=1, adapters=jreg)
    ps = _port_sched(port_bundle, pcfg, preg)
    try:
        jsess = [js.claim(key, prompt=p, seed=s, adapter=a) for key, p, s, a in SESSIONS]
        psess = [ps.claim(key, prompt=p, seed=s, adapter=a) for key, p, s, a in SESSIONS]
        assert [s.slot for s in psess] == [s.slot for s in jsess]
        bridge.states_from_jax(_np(js.states), ps.states)
        bank = ps.states["adapters"]
        assert set(bank) == set(preg.targets)
        assert bank[MQ_TREE]["down"].shape == (4, 8, 8)
        assert not torch.any(bank[MQ_TREE]["down"][psess[1].slot])  # the zero slot
        streams = [_frames(4, seed=90 + i) for i in range(3)]
        for j in range(4):
            if j == 2:  # a swap mid-stream: session a takes styleB, c clears
                for sess in (jsess, psess):
                    sess[0].update_adapter("styleB")
                    sess[2].update_adapter(None)
            got = {}
            for name, sess in (("jax", jsess), ("port", psess)):
                handles = [s.submit(f[j]) for s, f in zip(sess, streams)]
                got[name] = [s.fetch(h) for s, h in zip(sess, handles)]
            for i, (a, b) in enumerate(zip(got["port"], got["jax"])):
                assert a.shape == b.shape
                assert _levels(a, b) <= 1, (mode, j, i)
        assert ps.snapshot_fingerprint() == js.snapshot_fingerprint()
        for keys in (ps.bucket_keys(), js.bucket_keys()):
            assert all("--lrank-8--" in key for key in keys.values())
    finally:
        js.close()
        ps.close()


@pytest.mark.parametrize("mode", ["ring_fused", "full", "sequential", "deepcache"])
def test_a_zero_slot_is_a_rank0_scheduler_bit_for_bit(port_bundle, styles, mode):
    """Session b rides the zero rows between two styled sessions; the same
    sessions through a scheduler with no bank: b's frames are equal bit for
    bit, and the styled ones are not."""
    pcfg = PREG.default_stream_config("tiny-test", device="cpu", **MODES[mode])
    preg = AdapterRegistry(port_bundle.params["unet"], PLD.unet_key_map(port_bundle.unet_cfg))
    for name, g in styles.items():
        preg.add(name, g)
    styled, plain = _port_sched(port_bundle, pcfg, preg), _port_sched(port_bundle, pcfg)
    try:
        assert "adapters" not in plain.states and "lrank" not in str(plain.bucket_keys())
        ss = [styled.claim(k, prompt=p, seed=s, adapter=a) for k, p, s, a in SESSIONS]
        zs = [plain.claim(k, prompt=p, seed=s) for k, p, s, _ in SESSIONS]
        streams = [_frames(3, seed=40 + i) for i in range(3)]
        moved = 0
        for j in range(3):
            outs = []
            for sess in (ss, zs):
                handles = [s.submit(f[j]) for s, f in zip(sess, streams)]
                outs.append([s.fetch(h) for s, h in zip(sess, handles)])
            assert np.array_equal(outs[0][1], outs[1][1]), (mode, j)
            moved = max(moved, _levels(outs[0][0], outs[1][0]), _levels(outs[0][2], outs[1][2]))
        assert moved > 1
    finally:
        styled.close()
        plain.close()


def test_a_styled_session_is_the_style_fused_offline(port_bundle, styles):
    """The runtime factors against the offline fusion (``fuse_lora_into_unet``,
    the chip phase's references): each session of the mixed bucket within 1
    level of a dedicated engine over weights with its style fused, fed its
    state row; a swap mid-stream moves it to the other style's engine."""
    from ai_rtc_agent_tpu_torch.models import lora as PLR
    from ai_rtc_agent_tpu_torch.stream.engine import StreamEngine

    b = port_bundle
    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    preg = AdapterRegistry(b.params["unet"], PLD.unet_key_map(b.unet_cfg))
    params = {None: b.params}
    for name, g in styles.items():
        preg.add(name, g)
        unet, applied, _ = PLR.fuse_lora_into_unet(b.params["unet"], g,
                                                  PLD.unet_key_map(b.unet_cfg))
        assert applied == len(g)
        params[name] = dict(b.params, unet=unet)
    sched = _port_sched(b, cfg, preg)
    try:
        sess = [sched.claim(k, prompt=p, seed=s, adapter=a) for k, p, s, a in SESSIONS]
        streams = [_frames(4, seed=20 + i) for i in range(3)]
        for j in range(4):
            if j == 2:
                sess[0].update_adapter("styleB")
            rows = [chip_smoke.session_row(sched.states, s.slot) for s in sess]
            handles = [s.submit(f[j]) for s, f in zip(sess, streams)]
            for s, h, row, f in zip(sess, handles, rows, streams):
                ded = StreamEngine(b.stream_models, params[s.adapter], cfg, b.encode_prompt,
                                   device="cpu", graphs=False)
                ded.state = {k: v for k, v in row.items() if k != "adapters"}
                assert _levels(s.fetch(h), ded(f[j])) <= 1, (j, s.adapter)
    finally:
        sched.close()
