"""The port's golden-output procedure (ai_rtc_agent_tpu_torch/utils/golden.py
and scripts/torch_golden_capture.py) against the JAX package's, on the CPU.

* ``golden_input``, ``fingerprint`` and ``compare`` are copies: equal to the
  JAX functions exactly on seeded frames, structured and noise alike.
* The procedure: JAX's ``tiny-test`` procedure in f32 (its own engine and
  prepared state) against the port's ``outputs``/``record`` on an engine
  built from ``bridge.params_from_jax`` of the same weights and handed the
  JAX state (``bridge.state_from_jax``).  Tolerance: every output frame
  within 1 uint8 level, and ``compare`` of the two records empty.
* The committed ``tests/golden_torch/tiny-test.json`` (the port's capture on
  the CPU in f32) replays through ``capture`` on the CPU.  The JAX goldens
  in ``tests/golden/`` are the JAX test's and stay apart.
* A real family with no snapshot raises the no-weights error before any
  init (the init is made to raise, so a run that reached it would say so).
* The capture script prints one ``ok: false`` line and exits non-zero on a
  bogus model id, as the JAX script does.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.stream import engine as JENG
from ai_rtc_agent_tpu.utils import golden as JG
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.stream import engine as PENG
from ai_rtc_agent_tpu_torch.utils import golden as PG

REPO = Path(__file__).resolve().parents[1]
PORT_GOLDEN = REPO / "tests" / "golden_torch" / "tiny-test.json"


def _frames(seed: int, n: int = 3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in [(64, 64), (48, 80), (512, 512)][:n]]


def test_constants_are_the_jax_procedure():
    assert (PG.GOLDEN_PROMPT, PG.FRAMES) == (JG.GOLDEN_PROMPT, JG.FRAMES)


@pytest.mark.parametrize("hw", [(64, 64), (48, 80), (512, 512), (1, 1)])
def test_golden_input_is_the_jax_input(hw):
    np.testing.assert_array_equal(PG.golden_input(*hw), JG.golden_input(*hw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fingerprint_is_the_jax_fingerprint(seed):
    for frame in _frames(seed) + [PG.golden_input(64, 64), PG.golden_input(96, 128)]:
        assert PG.fingerprint(frame) == JG.fingerprint(frame)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compare_is_the_jax_compare(seed):
    """Structured against noise (the failure the golden guards), against
    small drift, and against itself, at the default and tight tolerances."""
    rng = np.random.default_rng(seed)
    base = PG.golden_input(64, 64)
    noise = rng.integers(0, 256, base.shape, dtype=np.uint8)
    drift = np.clip(base.astype(np.int16) + rng.integers(-2, 3, base.shape), 0, 255)
    shifted = np.clip(base.astype(np.int16) + 40, 0, 255)
    gold = {"fingerprint": PG.fingerprint(base)}
    for frame in (noise, drift.astype(np.uint8), shifted.astype(np.uint8), base):
        got = {"fingerprint": PG.fingerprint(frame)}
        for kw in ({}, {"thumb_corr_min": 0.999, "stat_atol": 0.5}):
            assert PG.compare(gold, got, **kw) == JG.compare(gold, got, **kw)
    assert PG.compare(gold, {"fingerprint": PG.fingerprint(noise)})
    assert PG.compare(gold, {"fingerprint": PG.fingerprint(drift.astype(np.uint8))}) == []


def test_save_writes_what_the_jax_save_writes(tmp_path):
    rec = PG.record("tiny-test", PREG.default_stream_config("tiny-test", device="cpu"),
                    PG.golden_input(64, 64))
    PG.save(rec, tmp_path / "port.json")
    JG.save(rec, tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_the_procedure_matches_the_jax_procedure():
    """JAX's tiny-test procedure (its capture's steps, in f32) against the
    port's on the same weights and the JAX prepared state."""
    jb = JREG.load_model_bundle("tiny-test")
    jcfg = JREG.default_stream_config("tiny-test", dtype="float32")
    jeng = JENG.StreamEngine(jb.stream_models, jb.params, jcfg, jb.encode_prompt)
    jeng.prepare(JG.GOLDEN_PROMPT, guidance_scale=1.0, seed=1234)
    state0 = jax.tree.map(np.asarray, jeng.state)
    frame = JG.golden_input(jcfg.height, jcfg.width)
    want = [np.asarray(jeng(frame)) for _ in range(JG.FRAMES)]

    params = bridge.params_from_jax(jax.tree.map(np.asarray, jb.params))
    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    pb = PREG.load_model_bundle("tiny-test", device="cpu", attn_impl=cfg.attn_impl, params=params)
    eng = PENG.StreamEngine(pb.stream_models, pb.params, cfg, pb.encode_prompt, device="cpu",
                            model_id="tiny-test")
    eng.state = bridge.state_from_jax(state0)
    got = PG.outputs(eng)
    assert len(got) == len(want) == PG.FRAMES
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == np.uint8
        diff = np.abs(g.astype(np.int16) - w.astype(np.int16)).max()
        assert diff <= 1, f"frame {i}: {diff} levels"
    port_rec = PG.record("tiny-test", cfg, got[-1])
    jax_rec = {"fingerprint": JG.fingerprint(want[-1])}
    assert PG.compare(jax_rec, port_rec) == []
    assert {k: port_rec[k] for k in ("prompt", "frames", "seed", "hw")} == {
        "prompt": JG.GOLDEN_PROMPT, "frames": JG.FRAMES, "seed": 1234,
        "hw": [jcfg.height, jcfg.width]}


def test_committed_port_golden_replays_on_the_cpu():
    gold = json.loads(PORT_GOLDEN.read_text())
    assert gold["model_id"] == "tiny-test" and gold["frames"] == PG.FRAMES
    got = PG.capture("tiny-test", device="cpu")
    assert PG.compare(gold, got) == []
    assert {k: got[k] for k in ("prompt", "frames", "seed", "hw")} == {
        k: gold[k] for k in ("prompt", "frames", "seed", "hw")}


def test_prepare_draws_its_noise_from_a_cpu_generator():
    """The procedure's noise comes from a CPU generator seeded with
    ``SEED``, whatever the engine's device (so the card replays the CPU
    golden); on a CPU engine that is the serving default's noise too."""
    import torch

    cfg = PREG.default_stream_config("tiny-test", device="cpu")
    b = PREG.load_model_bundle("tiny-test", device="cpu")
    eng = PENG.StreamEngine(b.stream_models, b.params, cfg, b.encode_prompt, device="cpu")
    got = PG.prepare(eng).state["noise"].clone()
    gen = torch.Generator(device="cpu").manual_seed(PG.SEED)
    want = torch.randn((cfg.batch_size, *cfg.latent_hw, cfg.latent_channels), generator=gen)
    assert got.equal(want)
    assert got.equal(eng.build_state(PG.GOLDEN_PROMPT, seed=PG.SEED)["noise"])


def test_real_family_without_weights_raises_before_any_init(monkeypatch, tmp_path):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))

    def no_init(*a, **k):
        raise AssertionError("the full-geometry init ran")

    monkeypatch.setattr(PREG, "init_params", no_init)
    monkeypatch.setattr(PREG, "load_model_bundle", no_init)
    for model_id in ("stabilityai/sd-turbo", "stabilityai/sdxl-turbo", "lykon/dreamshaper-8"):
        with pytest.raises(RuntimeError, match="no local weights for"):
            PG.capture(model_id, device="cpu")


def test_capture_script_contract_line_on_failure(tmp_path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["HF_HUB_CACHE"] = str(tmp_path)
    out = tmp_path / "never.json"
    r = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_golden_capture.py"),
         "--model-id", "bogus/nonexistent", "--device", "cpu", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=240, cwd=REPO,
    )
    assert r.returncode != 0
    lines = [ln for ln in r.stdout.strip().splitlines() if ln.startswith("{")]
    assert len(lines) == 1, r.stdout
    d = json.loads(lines[0])
    assert d["ok"] is False and "no local weights for bogus/nonexistent" in d["error"]
    assert not out.exists()
