"""Port parity: ops (schedule, LCM step math, R-CFG, uint8 image io) and the
tokenizer, each against its JAX counterpart on the same numpy inputs.

Tolerance: f32 elementwise math, rtol=1e-4 / atol=1e-5 (the two frameworks
may order or fuse the same f32 operations differently); host numpy tables
and integer outputs must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.models import tokenizer as JTK
from ai_rtc_agent_tpu.ops import image as JI
from ai_rtc_agent_tpu.ops import lcm as JL
from ai_rtc_agent_tpu.ops import rcfg as JR
from ai_rtc_agent_tpu.ops import schedule as JS
from ai_rtc_agent_tpu_torch.models import tokenizer as PTK
from ai_rtc_agent_tpu_torch.ops import image as PI
from ai_rtc_agent_tpu_torch.ops import lcm as PL
from ai_rtc_agent_tpu_torch.ops import rcfg as PR
from ai_rtc_agent_tpu_torch.ops import schedule as PS

RTOL, ATOL = 1e-4, 1e-5

T_INDEX_CASES = [
    ((18, 26, 35, 45), 50, 1, "leading"),
    ((0,), 1, 1, "trailing"),
    ((10, 20, 30, 40), 50, 2, "leading"),
    ((0, 2), 4, 1, "trailing"),
]


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", ["scaled_linear", "linear"])
def test_schedule_tables_identical(kind):
    a, b = PS.make_schedule(kind=kind), JS.make_schedule(kind=kind)
    np.testing.assert_array_equal(a.alphas_cumprod, b.alphas_cumprod)
    np.testing.assert_array_equal(a.betas, b.betas)


@pytest.mark.parametrize("t_index,steps,fbs,spacing", T_INDEX_CASES)
def test_sub_timesteps_and_coeffs_identical(t_index, steps, fbs, spacing):
    np.testing.assert_array_equal(
        PS.inference_timesteps(steps, spacing=spacing),
        JS.inference_timesteps(steps, spacing=spacing),
    )
    bt = PS.batched_sub_timesteps(t_index, steps, fbs, spacing=spacing)
    np.testing.assert_array_equal(bt, JS.batched_sub_timesteps(t_index, steps, fbs, spacing=spacing))
    pc = PL.make_step_coeffs(PS.make_schedule(), bt, fbs)
    jc = JL.make_step_coeffs(JS.make_schedule(), bt, fbs)
    for name, v in pc.as_dict().items():
        np.testing.assert_array_equal(v, getattr(jc, name), err_msg=name)


@pytest.mark.parametrize(
    "args",
    [((5, 3), 50), ((), 50), ((50,), 50), ((-1,), 50)],
)
def test_sub_timesteps_refuses_like_jax(args):
    for mod in (PS, JS):
        with pytest.raises(ValueError):
            mod.sub_timesteps(*args)


def _coeffs(t_index=(18, 26, 35, 45), steps=50, spacing="leading"):
    bt = JS.batched_sub_timesteps(t_index, steps, spacing=spacing)
    jc = JL.make_step_coeffs(JS.make_schedule(), bt)
    return PL.make_step_coeffs(PS.make_schedule(), bt).to("cpu"), jc.as_jnp()


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_lcm_step_math_matches_jax(rng, prediction_type):
    pc, jc = _coeffs()
    x, out, noise = (rng.standard_normal((4, 8, 8, 4)).astype(np.float32) for _ in range(3))
    tx, to, tn = (torch.from_numpy(a) for a in (x, out, noise))
    _close(PL.pred_x0(tx, to, pc, prediction_type), JL.pred_x0(x, out, jc, prediction_type))
    _close(PL.lcm_denoise(tx, to, pc, prediction_type), JL.lcm_denoise(x, out, jc, prediction_type))
    _close(PL.turbo_denoise(tx, to, pc, prediction_type), JL.turbo_denoise(x, out, jc, prediction_type))
    _close(PL.renoise_next(tx, tn, pc), JL.renoise_next(x, noise, jc))


def test_rcfg_matches_jax(rng):
    pc, jc = _coeffs()
    eps_c, eps_u, stock = (rng.standard_normal((4, 8, 8, 4)).astype(np.float32) for _ in range(3))
    te, tu, ts = (torch.from_numpy(a) for a in (eps_c, eps_u, stock))
    g, d = torch.tensor(1.7), torch.tensor(0.8)
    _close(PR.combine_residual(te, ts, g, d), JR.combine_residual(eps_c, stock, 1.7, 0.8))
    _close(PR.combine_full(tu, te, g), JR.combine_full(eps_u, eps_c, 1.7))
    _close(
        PR.update_stock_noise(ts, te, pc.alpha, pc.sigma),
        JR.update_stock_noise(stock, eps_c, jc.alpha, jc.sigma),
    )


@pytest.mark.parametrize("shape", [(16, 24, 3), (2, 16, 24, 3)])
def test_preprocess_uint8_matches_jax(rng, shape):
    frame = rng.integers(0, 256, shape, dtype=np.uint8)
    got = PI.preprocess_uint8(torch.from_numpy(frame))
    want = JI.preprocess_uint8(frame)
    assert got.shape == want.shape
    # x * (1/255) in f32 on both sides: bit-identical
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_postprocess_uint8_round_half_even_pinned():
    # round-half-even on both sides: torch.round and jnp.round agree on ties
    ties = [0.5, 1.5, 2.5, 254.5]
    assert torch.round(torch.tensor(ties)).tolist() == [0.0, 2.0, 2.0, 254.0]
    assert np.asarray(jnp.round(jnp.array(ties))).tolist() == [0.0, 2.0, 2.0, 254.0]
    x = np.array([[[[0.5, 1.5, 2.5], [3.5, 254.5, 300.0]]]], np.float32) / 255.0
    got = PI.postprocess_uint8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JI.postprocess_uint8(jnp.asarray(x))))


def test_postprocess_uint8_matches_jax_on_noise(rng):
    x = rng.uniform(-0.1, 1.1, (2, 16, 16, 3)).astype(np.float32)
    got = PI.postprocess_uint8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JI.postprocess_uint8(jnp.asarray(x))))


@pytest.mark.parametrize(
    "text",
    ["a cat", "Fireworks in the night sky!", "", "x " * 100, "naïve café 123"],
)
def test_hash_tokenizer_matches_jax(text):
    for vocab, n in ((49408, 77), (256, 16)):
        assert PTK.HashTokenizer(vocab, n)(text) == JTK.HashTokenizer(vocab, n)(text)


def test_bpe_tokenizer_matches_jax(tmp_path):
    import json

    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for i, tok in enumerate(["a</w>", "c", "a", "t</w>", "ca", "cat</w>", "d", "o", "g</w>",
                             "do", "dog</w>", "!</w>", "s", "s</w>"]):
        vocab[tok] = i + 2
    (tmp_path / "tokenizer").mkdir()
    (tmp_path / "tokenizer" / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "tokenizer" / "merges.txt").write_text(
        "#version: 0.2\nc a\nca t</w>\nd o\ndo g</w>\n"
    )
    p = PTK.find_clip_tokenizer(str(tmp_path), max_length=12)
    j = JTK.find_clip_tokenizer(str(tmp_path), max_length=12)
    assert isinstance(p, PTK.CLIPBPETokenizer)
    for text in ("a cat", "dog dogs!", "cats and  dogs", ""):
        assert p(text) == j(text)
    assert isinstance(PTK.find_clip_tokenizer(str(tmp_path / "none")), PTK.HashTokenizer)
