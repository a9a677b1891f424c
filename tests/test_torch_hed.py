"""The HED annotator (``--annotator hed``) in the port against the JAX package,
on the CPU, in f32.

* ``apply_hed`` at TINY_STAGES on even and odd sizes (the JAX "SAME" 2x2
  max-pool keeps a partial window at an odd edge) and once at FULL_STAGES
  on a 32x32 image, the JAX init carried by ``bridge``: rtol 1e-4, atol
  1e-5 (a sigmoid of convolutions in two frameworks' f32).
* The bilinear resize back to the input size: ``F.interpolate(mode=
  "bilinear", align_corners=False)`` against ``jax.image.resize(method=
  "bilinear")`` at every upsample factor the stages make, square and not,
  atol 1e-5 (shown here, not assumed).
* ``load_hed_from_torch`` on a synthetic ControlNetHED.pth (with and
  without the ``netNetwork.`` prefix): the same leaves in both packages,
  bit for bit, and the same count.
* The bridge carries HED's ``norm`` ([1,1,1,3], no conv kernel) unchanged
  while every conv kernel goes HWIO -> OIHW.
* HED_CHECKPOINT and the bundle's HED (TINY_STAGES for the tiny family,
  FULL_STAGES otherwise, with the JAX tree's shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.models import hed as JH
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.models import hed as PH
from ai_rtc_agent_tpu_torch.models import registry as PREG


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_hed(stages, seed=0):
    p = JH.init_hed(jax.random.PRNGKey(seed), stages=stages)
    # a non-zero input bias and biases: the loader and the bridge must carry them
    rng = np.random.default_rng(seed)
    p["norm"] = jnp.asarray(rng.uniform(50, 150, (1, 1, 1, 3)), jnp.float32)
    for i in range(1, len(stages) + 1):
        for c in p[f"block{i}"]["convs"]:
            c["bias"] = jnp.asarray(0.1 * rng.standard_normal(c["bias"].shape), jnp.float32)
    return p


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 21, 15, 3)])
def test_apply_hed_tiny_matches_jax(shape):
    jp = _jax_hed(JH.TINY_STAGES)
    img = np.random.default_rng(1).random(shape, dtype=np.float32)
    want = np.asarray(JH.apply_hed(jp, jnp.asarray(img)))
    got = PH.apply_hed(bridge.params_from_jax(_np(jp)), torch.from_numpy(img))
    assert got.shape == want.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    assert float(got.std()) > 1e-4  # an edge map, not a constant


def test_apply_hed_full_stages_matches_jax_on_32x32():
    jp = _jax_hed(JH.FULL_STAGES, seed=2)
    img = np.random.default_rng(2).random((1, 32, 32, 3), dtype=np.float32)
    want = np.asarray(JH.apply_hed(jp, jnp.asarray(img)))
    with torch.inference_mode():
        got = PH.apply_hed(bridge.params_from_jax(_np(jp)), torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((16, 16), (32, 32)), ((8, 8), (64, 64)),
                                     ((2, 2), (32, 32)), ((4, 3), (16, 12)), ((11, 8), (21, 15)),
                                     ((5, 5), (5, 5))])
def test_bilinear_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(3).standard_normal((2, *src, 1)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 1), method="bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=dst, mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _torch_state_dict(jp, stages) -> dict:
    """The checkpoint's layout of a JAX HED tree: OIHW convs, norm [1,3,1,1]."""
    sd = {"norm": torch.from_numpy(np.asarray(jp["norm"]).reshape(1, 3, 1, 1).copy())}
    for i in range(1, len(stages) + 1):
        blk = jp[f"block{i}"]
        for j, c in enumerate(blk["convs"]):
            sd[f"block{i}.convs.{j}.weight"] = torch.from_numpy(
                np.asarray(c["kernel"]).transpose(3, 2, 0, 1).copy())
            sd[f"block{i}.convs.{j}.bias"] = torch.from_numpy(np.asarray(c["bias"]).copy())
        sd[f"block{i}.projection.weight"] = torch.from_numpy(
            np.asarray(blk["projection"]["kernel"]).transpose(3, 2, 0, 1).copy())
        sd[f"block{i}.projection.bias"] = torch.from_numpy(
            np.asarray(blk["projection"]["bias"]).copy())
    return sd


@pytest.mark.parametrize("prefix", ["", "netNetwork."])
def test_load_hed_from_torch_matches_the_jax_loader(tmp_path, prefix):
    src = _jax_hed(JH.TINY_STAGES, seed=4)
    path = tmp_path / "ControlNetHED.pth"
    torch.save({prefix + k: v for k, v in _torch_state_dict(src, JH.TINY_STAGES).items()}, path)
    jp, jn = JH.load_hed_from_torch(JH.init_hed(jax.random.PRNGKey(9), JH.TINY_STAGES), str(path))
    pp, pn = PH.load_hed_from_torch(PH.init_hed(torch.Generator().manual_seed(9), PH.TINY_STAGES),
                                    str(path))
    assert pn == jn == 1 + 4 * len(JH.TINY_STAGES)
    carried = bridge.params_from_jax(_np(jp))
    for a, b in zip(jax.tree.leaves(_np(pp)), jax.tree.leaves(_np(carried))):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    want = bridge.params_from_jax(_np(src))
    assert torch.equal(pp["norm"], want["norm"]) and torch.equal(
        pp["block2"]["convs"][0]["kernel"], want["block2"]["convs"][0]["kernel"])


def test_the_bridge_carries_the_norm_unchanged():
    jp = _np(_jax_hed(JH.TINY_STAGES, seed=5))
    pp = bridge.params_from_jax({"hed": jp})["hed"]
    assert tuple(pp["norm"].shape) == (1, 1, 1, 3)
    assert pp["norm"].numpy().tobytes() == jp["norm"].tobytes()
    k = jp["block1"]["convs"][0]["kernel"]  # HWIO [3,3,3,8]
    assert torch.equal(pp["block1"]["convs"][0]["kernel"],
                       torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
    # the rank rule, applied to the norm, would have made it [3,1,1,1]
    assert tuple(bridge.params_from_jax({"x": jp["norm"]})["x"].shape) == (3, 1, 1, 1)


def test_hed_checkpoint_env_and_the_bundles_hed(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    monkeypatch.delenv("HED_CHECKPOINT", raising=False)
    assert PH.find_hed_checkpoint() is None
    ckpt = tmp_path / "ControlNetHED.pth"
    torch.save({}, ckpt)
    monkeypatch.setenv("HED_CHECKPOINT", str(ckpt))
    assert PH.find_hed_checkpoint() == str(ckpt) == JH.find_hed_checkpoint()
    snap = tmp_path / "hub" / "models--lllyasviel--Annotators" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    (snap / "ControlNetHED.pth").write_bytes(b"")
    monkeypatch.delenv("HED_CHECKPOINT")
    assert PH.find_hed_checkpoint() == str(snap / "ControlNetHED.pth") == JH.find_hed_checkpoint()
    tiny = PREG.load_model_bundle("tiny-test", device="cpu", controlnet="tiny-cnet",
                                  annotator="hed")
    assert sorted(tiny.params["hed"]) == ["block1", "block2", "norm"]
    full = PREG._hed_params("sd15", 0, "meta")
    want = jax.eval_shape(lambda: JH.init_hed(jax.random.PRNGKey(0), JH.FULL_STAGES))
    want = bridge.params_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), want))
    assert jax.tree.map(lambda a: tuple(a.shape), full) == jax.tree.map(
        lambda a: tuple(a.shape), want)
