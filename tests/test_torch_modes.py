"""The engine modes against the JAX engine: full CFG, sequential mode
(``use_denoising_batch=False``) and txt2img, on the tiny-test model.

* One session: the JAX ``StreamEngine`` runs each mode over the frames
  (Pallas attention and, where its ``fused_ok`` holds, the Pallas epilogue,
  interpret mode on the CPU); the port's engine replays them from the JAX
  engine's prepared state (``bridge.state_from_jax``), with the epilogue
  fused and composed.  Full CFG and sequential mode run the composed ops on
  both packages whatever ``use_fused_epilogue`` says; txt2img with cfg self
  keeps the kernel.
* k=2 through the bucket step: the JAX step vmapped over two stacked
  session states (what the JAX bucket step runs) against the port's
  session step over the same states (``bridge.states_from_jax``), each
  session with its own prompt, noise and guidance.

Tolerance: output frames at most 1 uint8 level apart (the rounding-tie
class of tests/test_torch_stream.py); the state the step writes (ring,
stock) rtol/atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.models import registry as JREG
from ai_rtc_agent_tpu.stream import engine as JENG
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF
from ai_rtc_agent_tpu_torch.stream import engine as PENG
from ai_rtc_agent_tpu_torch.tree import tree_map

MODES = {
    "full_cfg": dict(cfg_type="full"),
    "sequential": dict(use_denoising_batch=False),
    "txt2img": dict(mode="txt2img"),
}
N_FRAMES = 4


def _frames(n=N_FRAMES, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(n)]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == want.shape and diff.max() <= 1, diff.max()


@pytest.fixture(scope="module")
def jax_bundle():
    return JREG.load_model_bundle("tiny-test", attn_impl="pallas")


@pytest.fixture(scope="module")
def port_params(jax_bundle):
    return bridge.params_from_jax(jax.tree.map(np.asarray, jax_bundle.params))


@pytest.fixture(scope="module")
def jax_runs(jax_bundle):
    """{mode: the JAX engine's prepared state, outputs and final state}."""
    runs = {}
    for name, overrides in MODES.items():
        cfg = JREG.default_stream_config("tiny-test", use_fused_epilogue=True, **overrides)
        eng = JENG.StreamEngine(jax_bundle.stream_models, jax_bundle.params, cfg,
                                jax_bundle.encode_prompt)
        eng.prepare("a cat", guidance_scale=1.4, delta=0.9, seed=1)
        state0 = jax.tree.map(np.asarray, eng.state)
        outs = [np.asarray(eng(f)) for f in _frames()]
        runs[name] = dict(state0=state0, outs=outs, state=jax.tree.map(np.asarray, eng.state))
    return runs


def _port_cfg(overrides, fused):
    return PREG.default_stream_config("tiny-test", device="cpu", use_fused_epilogue=fused,
                                      **overrides)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
@pytest.mark.parametrize("mode", list(MODES))
def test_engine_mode_matches_the_jax_engine(jax_runs, port_params, mode, fused):
    rec = jax_runs[mode]
    bundle = PREG.load_model_bundle("tiny-test", device="cpu", params=port_params)
    cfg = _port_cfg(MODES[mode], fused)
    eng = PENG.StreamEngine(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt,
                            device="cpu")
    eng.state = bridge.state_from_jax(rec["state0"])
    launches = KF.launches
    for f, want in zip(_frames(), rec["outs"]):
        _close(eng(f), want)
    for leaf in ("x_buf", "stock"):
        np.testing.assert_allclose(eng.state[leaf].numpy(), rec["state"][leaf], rtol=1e-4,
                                   atol=1e-4, err_msg=leaf)
    # the epilogue wrapper runs (its plain version on the CPU) exactly where
    # the JAX fused_ok holds: txt2img with cfg self, never full CFG or sequential
    assert PENG.fused_ok(cfg) == (fused and mode == "txt2img")
    assert KF.launches == launches  # a CPU tensor never launches the kernel


def test_txt2img_ignores_the_pixels(port_params):
    bundle = PREG.load_model_bundle("tiny-test", device="cpu", params=port_params)
    outs = []
    for seed in (0, 1):
        eng = PENG.StreamEngine(bundle.stream_models, bundle.params, _port_cfg(MODES["txt2img"],
                                True), bundle.encode_prompt, device="cpu").prepare("a cat")
        outs.append([eng(f) for f in _frames(seed=seed)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _jax_vmapped(bundle, overrides, states, frames):
    """The JAX step vmapped over the stacked session states, as the JAX
    bucket step runs it; -> (outputs per step, final states)."""
    cfg = JREG.default_stream_config("tiny-test", use_fused_epilogue=True, **overrides)
    vstep = jax.jit(jax.vmap(JENG.make_step_fn(bundle.stream_models, cfg), in_axes=(None, 0, 0)))
    outs = []
    for f in frames:
        states, out = vstep(bundle.params, states, jnp.asarray(f))
        outs.append(np.asarray(out)[:, 0])  # each session's [fbs=1,H,W,3]
    return outs, jax.tree.map(np.asarray, states)


@pytest.fixture(scope="module")
def jax_sessions(jax_bundle):
    """{mode: two JAX session states (prompts, seeds and guidance of their
    own), stacked, the outputs of the vmapped step over 3 ticks, the final
    states}."""
    runs = {}
    frames = [np.stack(pair) for pair in zip(_frames(3, seed=5), _frames(3, seed=6))]
    for name, overrides in MODES.items():
        cfg = JREG.default_stream_config("tiny-test", use_fused_epilogue=True, **overrides)
        eng = JENG.StreamEngine(jax_bundle.stream_models, jax_bundle.params, cfg,
                                jax_bundle.encode_prompt)
        rows = []
        for prompt, seed, g in (("a cat", 1, 1.4), ("a dog on the moon", 2, 1.1)):
            eng.prepare(prompt, guidance_scale=g, delta=0.9, seed=seed)
            rows.append(jax.tree.map(np.asarray, eng.state))
        states0 = jax.tree.map(lambda *a: np.stack(a), *rows)
        outs, states = _jax_vmapped(jax_bundle, overrides, jax.tree.map(jnp.asarray, states0),
                                    frames)
        runs[name] = dict(states0=states0, outs=outs, states=states, frames=frames)
    return runs


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
@pytest.mark.parametrize("mode", list(MODES))
def test_session_step_mode_matches_the_vmapped_jax_step(jax_sessions, port_params, mode, fused):
    rec = jax_sessions[mode]
    bundle = PREG.load_model_bundle("tiny-test", device="cpu", params=port_params)
    cfg = _port_cfg(MODES[mode], fused)
    template = PENG.StreamEngine(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt,
                                 device="cpu")
    states = PENG.stack_states([template.build_state("x", seed=0)] * 2)
    bridge.states_from_jax(rec["states0"], states)
    step = PENG.make_session_step_fn(bundle.stream_models, cfg)
    slots = torch.tensor([0, 1], dtype=torch.int32)
    for frames, want in zip(rec["frames"], rec["outs"]):
        got = step(bundle.params, states, torch.from_numpy(frames), slots, 2)
        _close(got.numpy(), want)
    for leaf in ("x_buf", "stock"):
        np.testing.assert_allclose(states[leaf].numpy(), rec["states"][leaf], rtol=1e-4,
                                   atol=1e-4, err_msg=leaf)


@pytest.mark.parametrize("mode", list(MODES))
def test_session_step_mode_matches_dedicated_engines_with_padding(port_params, mode):
    """A bucket of 4 carrying 2 real sessions (slots 2 and 0, the tail
    padded with slot 0): each session's frames equal a dedicated engine's
    fed the same state row, and the padding writes nothing."""
    bundle = PREG.load_model_bundle("tiny-test", device="cpu", params=port_params)
    cfg = _port_cfg(MODES[mode], False)
    mk = lambda: PENG.StreamEngine(bundle.stream_models, bundle.params, cfg,  # noqa: E731
                                   bundle.encode_prompt, device="cpu")
    template = mk()
    rows = [template.build_state(p, seed=s) for p, s in (("a cat", 1), ("x", 9), ("a dog", 2))]
    states = PENG.stack_states(rows)
    untouched = {k: states[k][1].clone() for k in ("x_buf", "stock")}
    dedicated = {}
    for slot in (2, 0):
        eng = mk()
        eng.state = tree_map(torch.clone, rows[slot])
        dedicated[slot] = eng
    step = PENG.make_session_step_fn(bundle.stream_models, cfg)
    slots = torch.tensor([2, 0, 0, 0], dtype=torch.int32)
    for a, b in zip(_frames(3, seed=7), _frames(3, seed=8)):
        frames = torch.from_numpy(np.stack([a, b, b, b]))
        got = step(bundle.params, states, frames, slots, 2).numpy()
        _close(got[0], dedicated[2](a))
        _close(got[1], dedicated[0](b))
    for k, v in untouched.items():
        assert torch.equal(states[k][1], v), k
