"""Port parity: layers, UNet, TAESD and the CLIP text tower against the JAX
models, with the JAX weights carried across by ``bridge.params_from_jax``.

Tolerance: f32 on both sides, rtol=1e-4 / atol=1e-5 (the frameworks order
the same f32 sums differently; nothing here is rounded to bf16).  The
full-size architectures (SD2.1 / SD-Turbo, SD1.5) are compared by shape
only: the port initialises on the meta device and JAX by ``eval_shape``.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.models import clip as JC
from ai_rtc_agent_tpu.models import layers as JLY
from ai_rtc_agent_tpu.models import taesd as JT
from ai_rtc_agent_tpu.models import unet as JU
from ai_rtc_agent_tpu_torch import bridge
from ai_rtc_agent_tpu_torch.models import clip as PC
from ai_rtc_agent_tpu_torch.models import layers as PLY
from ai_rtc_agent_tpu_torch.models import registry as PREG
from ai_rtc_agent_tpu_torch.models import taesd as PT
from ai_rtc_agent_tpu_torch.models import unet as PU
from ai_rtc_agent_tpu_torch.tree import tree_map

RTOL, ATOL = 1e-4, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return bridge.params_from_jax(_np(tree))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _randomize(tree, seed):
    """Give zero-initialised biases/norm params random values so they count."""
    leaves, treedef = jax.tree.flatten(tree)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(
        treedef,
        [a + 0.1 * jax.random.normal(k, a.shape) for a, k in zip(leaves, keys)],
    )


@pytest.mark.parametrize("k,stride,padding", [(3, 1, "SAME"), (1, 1, "SAME"), (3, 2, 1)])
def test_conv2d_matches_jax(rng, k, stride, padding):
    p = _randomize(JLY.init_conv(jax.random.PRNGKey(0), 6, 10, k), 1)
    x = rng.standard_normal((2, 9, 11, 6)).astype(np.float32)
    want = JLY.conv2d(p, x, stride=stride, padding=padding)
    got = PLY.conv2d(_port(p), torch.from_numpy(x), stride=stride, padding=padding)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("c,groups", [(16, 4), (12, 8), (7, 32)])
def test_group_norm_matches_jax(rng, c, groups):
    p = _randomize(JLY.init_norm(c), 2)
    x = (3 * rng.standard_normal((2, 5, 6, c)) + 1).astype(np.float32)
    _close(PLY.group_norm(_port(p), torch.from_numpy(x), groups),
           JLY.group_norm(p, x, groups))


def test_layer_norm_linear_and_activations_match_jax(rng):
    x = rng.standard_normal((3, 7, 24)).astype(np.float32)
    tx = torch.from_numpy(x)
    pn = _randomize(JLY.init_norm(24), 3)
    _close(PLY.layer_norm(_port(pn), tx), JLY.layer_norm(pn, x))
    pl = _randomize(JLY.init_linear(jax.random.PRNGKey(1), 24, 40), 4)
    _close(PLY.linear(_port(pl), tx), JLY.linear(pl, x))
    for name in ("silu", "gelu", "quick_gelu"):
        _close(PLY.ACTIVATIONS[name](tx), JLY.ACTIVATIONS[name](x))
    pf = _randomize(JLY.init_geglu_ff(jax.random.PRNGKey(2), 24), 5)
    _close(PLY.geglu_ff(_port(pf), tx), JLY.geglu_ff(pf, x))


@pytest.mark.parametrize("dim", [32, 33, 320])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0, 1, 250, 999], np.int32)
    # the f32 argument t*freq reaches 999 rad, where one ulp is 6e-5 and the
    # two exp() implementations may differ by an ulp of freq: atol 2e-4
    _close(PLY.timestep_embedding(torch.from_numpy(t), dim), JLY.timestep_embedding(t, dim),
           atol=2e-4)


@pytest.mark.parametrize("attn_impl", ["plain", "kernel"])
@pytest.mark.parametrize("cross", [False, True])
def test_attention_matches_jax(rng, attn_impl, cross):
    ctx_dim = 12 if cross else None
    p = JLY.init_attention(jax.random.PRNGKey(3), 16, ctx_dim, 2, 8)
    x = rng.standard_normal((2, 10, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 12)).astype(np.float32) if cross else None
    want = JLY.attention(p, x, ctx, heads=2, attn_impl="xla")
    got = PLY.attention(_port(p), torch.from_numpy(x),
                        None if ctx is None else torch.from_numpy(ctx), 2, attn_impl)
    _close(got, want)


def test_sdpa_plain_matches_jax_with_mask(rng):
    q, k, v = (rng.standard_normal((1, 6, 2, 4)).astype(np.float32) for _ in range(3))
    mask = np.array(JLY.causal_mask(6))
    np.testing.assert_array_equal(PLY.causal_mask(6).numpy(), mask)
    _close(PLY.sdpa_plain(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask)),
           JLY._sdpa_xla(q, k, v, mask))


def _tiny_unet_cfgs():
    # the tiny preset (conv projections, SD1.5-style) and the same with
    # linear projections (the SD2.1 / SD-Turbo style)
    return [
        ("tiny", JU.UNetConfig.tiny(), PU.UNetConfig.tiny()),
        ("tiny-linear", replace(JU.UNetConfig.tiny(), use_linear_projection=True),
         replace(PU.UNetConfig.tiny(), use_linear_projection=True)),
    ]


@pytest.mark.parametrize("attn_impl", ["plain", "kernel"])
@pytest.mark.parametrize("name,jcfg,pcfg", _tiny_unet_cfgs())
def test_unet_tiny_matches_jax(rng, attn_impl, name, jcfg, pcfg):
    p = _randomize(JU.init_unet(jax.random.PRNGKey(4), jcfg), 6)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([999, 259], np.int32)
    ctx = rng.standard_normal((2, 16, jcfg.cross_attention_dim)).astype(np.float32)
    want = jax.jit(JU.apply_unet, static_argnames=("cfg", "attn_impl"))(
        p, x, t, ctx, cfg=jcfg, attn_impl="xla"
    )
    got = PU.apply_unet(_port(p), torch.from_numpy(x), torch.from_numpy(t),
                        torch.from_numpy(ctx), pcfg, attn_impl=attn_impl)
    assert got.shape == want.shape
    _close(got, want)


def test_taesd_tiny_encode_decode_match_jax(rng):
    cfg_j, cfg_p = JT.TAESDConfig.tiny(), PT.TAESDConfig.tiny()
    p = _randomize(JT.init_taesd(jax.random.PRNGKey(5), cfg_j), 7)
    pp = _port(p)
    img = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    z = JT.encode(p["encoder"], img, cfg_j)
    got_z = PT.encode(pp["encoder"], torch.from_numpy(img), cfg_p)
    assert got_z.shape == z.shape == (2, 8, 8, 4)
    _close(got_z, z)
    lat = (3 * rng.standard_normal((2, 8, 8, 4))).astype(np.float32)
    _close(PT.decode(pp["decoder"], torch.from_numpy(lat), cfg_p),
           JT.decode(p["decoder"], lat, cfg_j))


@pytest.mark.parametrize("variant", ["tiny", "tiny-sd21-style"])
def test_clip_text_tiny_matches_jax(variant):
    cfg_j, cfg_p = JC.CLIPTextConfig.tiny(), PC.CLIPTextConfig.tiny()
    if variant == "tiny-sd21-style":  # gelu + penultimate hidden state
        cfg_j = replace(cfg_j, activation="gelu", clip_skip=1)
        cfg_p = replace(cfg_p, activation="gelu", clip_skip=1)
    p = _randomize(JC.init_clip_text(jax.random.PRNGKey(6), cfg_j), 8)
    ids = np.array([[254, 3, 77, 255] + [255] * 12, [254, 9, 255] + [255] * 13], np.int32)
    want = JC.apply_clip_text(p, jnp.asarray(ids), cfg_j)
    got = PC.apply_clip_text(_port(p), torch.from_numpy(ids).long(), cfg_p)
    _close(got["hidden"], want["hidden"])
    _close(got["pooled"], want["pooled"])


def _shapes(tree, transpose_convs=False):
    def shape(a):
        s = tuple(a.shape)
        return (s[3], s[2], s[0], s[1]) if transpose_convs and len(s) == 4 else s

    return jax.tree.map(shape, tree, is_leaf=lambda a: hasattr(a, "shape"))


@pytest.mark.parametrize("fam", ["sd21", "sd15", "tiny"])
def test_full_architecture_shapes_match_jax(fam):
    """The port's random init builds the JAX tree, leaf for leaf, at full
    width (meta device: shapes only, no memory)."""
    from ai_rtc_agent_tpu.models import registry as JREG

    ucfg, ccfg, tcfg = JREG._model_configs(fam)
    key = jax.random.PRNGKey(0)
    want = {
        "unet": jax.eval_shape(lambda k: JU.init_unet(k, ucfg), key),
        "clip": jax.eval_shape(lambda k: JC.init_clip_text(k, ccfg), key),
        "taesd": jax.eval_shape(lambda k: JT.init_taesd(k, tcfg), key),
    }
    got = PREG.init_params(fam, device="meta")
    assert _shapes(got) == _shapes(want, transpose_convs=True)
    leaves = []
    tree_map(leaves.append, got["unet"])
    n = sum(a.numel() for a in leaves)
    if fam == "sd21":
        assert 860e6 < n < 870e6  # the SD2.1 UNet's ~865M parameters
