"""The fused-norm wrappers (ops/kernels/norm.py) on the CPU.

A CPU tensor takes the plain versions, which are the port's norms as they
were written before the kernel (f32 statistics, the affine, one cast, SiLU
after it in the activation's dtype): the references below are that code,
held bit for bit.  The kernels themselves are held against the plain
versions on the card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu_torch.models import layers as PLY
from ai_rtc_agent_tpu_torch.models.unet import UNetConfig
from ai_rtc_agent_tpu_torch.ops.kernels import build as KB
from ai_rtc_agent_tpu_torch.ops.kernels import norm as KN
from benchmark import trace


def _group_norm_reference(p, x, groups=32, eps=1e-5):
    n, h, w, c = x.shape
    g = min(groups, c)
    while c % g:
        g -= 1
    xf = x.float().reshape(n, h * w, g, c // g)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    return (xf * p["scale"] + p["bias"]).to(x.dtype)


def _layer_norm_reference(p, x, eps=1e-5):
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _silu_reference(x):
    return x * torch.sigmoid(x)


@pytest.fixture
def no_norm_build(monkeypatch):
    """Any build or load of a kernel library fails loudly."""

    def refuse(*a, **k):
        raise AssertionError("a kernel build was attempted for a CPU tensor")

    for mod, name in ((KB, "build_library"), (KB, "load_library"), (KN, "load")):
        monkeypatch.setattr(mod, name, refuse)


def _params(rng, c, dtype):
    return {"scale": torch.from_numpy(1 + 0.1 * rng.standard_normal(c).astype(np.float32)).to(dtype),
            "bias": torch.from_numpy(0.1 * rng.standard_normal(c).astype(np.float32)).to(dtype)}


def _x(rng, shape, dtype):
    return torch.from_numpy((3 * rng.standard_normal(shape) + 1).astype(np.float32)).to(dtype)


# (shape, groups): SD's 32 groups, the tiny families' 4, odd channels and a
# group count that shrinks until it divides C
GROUP_CASES = [((2, 8, 8, 64), 32), ((1, 5, 6, 7), 32), ((2, 9, 11, 12), 8), ((3, 4, 4, 24), 4),
               ((1, 3, 3, 16), 4)]
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32)]
DTYPE_IDS = ["f32", "bf16", "bf16-f32params"]


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("dtype,wdtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape,groups", GROUP_CASES)
def test_group_norm_on_cpu_is_the_plain_norm_bit_for_bit(rng, no_norm_build, shape, groups,
                                                         dtype, wdtype, act):
    p = _params(rng, shape[-1], wdtype)
    x = _x(rng, shape, dtype)
    want = _group_norm_reference(p, x, groups)
    if act == "silu":
        want = _silu_reference(want)
    fn = PLY.silu if act else None
    before = KN.launches
    for got in (KN.group_norm(x, p["scale"], p["bias"], groups, silu=fn),
                KN.group_norm_plain(x, p["scale"], p["bias"], groups, silu=fn),
                PLY.group_norm(p, x, groups, act=act)):
        assert got.dtype == dtype and torch.equal(got, want)
    assert KN.launches == before
    # the fused act is the two calls it replaces
    assert torch.equal(PLY.group_norm(p, x, groups, act=act),
                       PLY.silu(PLY.group_norm(p, x, groups)) if act else PLY.group_norm(p, x, groups))


@pytest.mark.parametrize("dtype,wdtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape", [(3, 7, 24), (5, 320), (2, 77, 768), (4, 9)])
def test_layer_norm_on_cpu_is_the_plain_norm_bit_for_bit(rng, no_norm_build, shape, dtype, wdtype):
    p = _params(rng, shape[-1], wdtype)
    x = _x(rng, shape, dtype)
    want = _layer_norm_reference(p, x)
    before = KN.launches
    for got in (KN.layer_norm(x, p["scale"], p["bias"]), KN.layer_norm_plain(x, p["scale"], p["bias"]),
                PLY.layer_norm(p, x)):
        assert got.dtype == dtype and torch.equal(got, want)
    assert KN.launches == before


def test_silu_is_the_plain_silu(rng):
    """SiLU stays the model's activation (models/layers.py); the kernel
    module takes it from its caller and owns none."""
    x = _x(rng, (4, 9), torch.bfloat16)
    assert PLY.ACTIVATIONS["silu"] is PLY.silu and not hasattr(KN, "silu")
    assert torch.equal(PLY.silu(x), _silu_reference(x))


@pytest.mark.parametrize("which", ["group", "layer"])
def test_wrapper_refuses_a_call_that_needs_a_gradient(rng, which):
    p = _params(rng, 16, torch.float32)
    x = _x(rng, (1, 4, 4, 16), torch.float32).requires_grad_()
    call = ((lambda: KN.group_norm(x, p["scale"], p["bias"], 4)) if which == "group"
            else (lambda: KN.layer_norm(x, p["scale"], p["bias"])))
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    with torch.no_grad():
        call()  # the same call without grad runs (its plain version, here on the CPU)


@pytest.mark.parametrize("grad_on", ["x", "params"])
@pytest.mark.parametrize("which", ["group", "layer"])
def test_layers_take_the_plain_norm_when_grad_is_needed(rng, monkeypatch, which, grad_on):
    """The trainer's route: a call that needs a gradient never reaches the
    wrapper, and its gradient is the plain version's."""

    def refuse(*a, **k):
        raise AssertionError("the kernel wrapper was called for a call that needs a gradient")

    monkeypatch.setattr(KN, "group_norm", refuse)
    monkeypatch.setattr(KN, "layer_norm", refuse)
    p = _params(rng, 16, torch.float32)
    x = _x(rng, (2, 4, 4, 16), torch.float32)
    if grad_on == "x":
        x.requires_grad_()
    else:
        for t in p.values():
            t.requires_grad_()
    if which == "group":
        y = PLY.group_norm(p, x, 4, act="silu")
        want = _silu_reference(_group_norm_reference(p, x, 4))
    else:
        y = PLY.layer_norm(p, x)
        want = _layer_norm_reference(p, x)
    assert torch.equal(y, want) and y.grad_fn is not None
    leaf = x if grad_on == "x" else p["scale"]
    (g,) = torch.autograd.grad(y.square().sum(), leaf)
    (g_want,) = torch.autograd.grad(want.square().sum(), leaf)
    assert torch.equal(g, g_want)


@pytest.mark.parametrize("bad", ["act", "device"])
def test_wrapper_rejects_an_unknown_act_or_device(rng, bad):
    p = _params(rng, 8, torch.float32)
    if bad == "act":
        with pytest.raises(ValueError, match="act"):
            PLY.group_norm(p, _x(rng, (1, 2, 2, 8), torch.float32), act="gelu")
    else:
        x = torch.empty((1, 2, 2, 8), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            KN.group_norm(x, p["scale"].to("meta"), p["bias"].to("meta"))
        with pytest.raises(ValueError, match="unsupported device"):
            KN.layer_norm(x, p["scale"].to("meta"), p["bias"].to("meta"))


@pytest.mark.parametrize("c,groups,want", [(320, 32, 32), (7, 32, 7), (12, 8, 6), (24, 4, 4),
                                           (2560, 32, 32), (10, 4, 2)])
def test_num_groups_shrinks_until_it_divides_c(c, groups, want):
    assert KN.num_groups(c, groups) == want


def _global_names():
    src = (KB.CSRC_DIR / KN.SOURCE).read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)


def test_every_norm_kernel_counts_as_norm_reduce_in_the_device_trace():
    names = _global_names()
    assert set(names) == {"group_norm_stats_kernel", "group_norm_apply_kernel",
                          "layer_norm_rows_kernel"}
    for name in names:
        # as the profiler names an instantiation: namespace, template and argument types
        for shown in (name, f"void (anonymous namespace)::{name}<__nv_bfloat16, true, "
                            f"false>((anonymous namespace)::GroupNormArgs)",
                      f"void (anonymous namespace)::{name}<float, 8, true>"
                      f"((anonymous namespace)::LayerNormArgs)"):
            assert trace.classify(shown) == "norm/reduce", shown
            assert trace.classify(shown) in trace.POINTWISE


@pytest.mark.parametrize("cfg", ["sd15", "sd21", "sdxl", "tiny", "tiny_xl"])
def test_norm_launches_per_pass_match_the_pass_s_calls(cfg):
    """The count the card tests hold a captured step to (two launches a
    GroupNorm, one a LayerNorm), against the calls one pass makes: 170 for
    SD1.5 and SD2.1, 45 of the 61 GroupNorms with a fused SiLU."""
    ucfg = getattr(UNetConfig, cfg)()
    calls = chip_smoke.unet_norm_calls(torch, ucfg, 2, 16)
    launches = sum(2 if c[0] == "group" else 1 for c in calls)
    assert launches == chip_smoke.norm_launches_per_pass(ucfg)
    if cfg in ("sd15", "sd21"):
        assert launches == 170
        groups = [c for c in calls if c[0] == "group"]
        assert len(groups) == 61 and sum(c[3] == "silu" for c in groups) == 45


@pytest.mark.parametrize("name,source", [("MAX_CHANNELS", r"MAX_CHANNELS = (\d+);"),
                                         ("MAX_ROW", r"MAX_ROW = 32 \* ROW_CHUNKS \* 8;")])
def test_wrapper_limits_are_the_kernel_source_s(name, source):
    """The widths the wrapper refuses above are the ones the .cu holds."""
    src = (KB.CSRC_DIR / KN.SOURCE).read_text()
    m = re.search(source, src)
    assert m, source
    if name == "MAX_CHANNELS":
        assert KN.MAX_CHANNELS == int(m.group(1))
    else:
        chunks = int(re.search(r"ROW_CHUNKS = (\d+);", src).group(1))
        assert KN.MAX_ROW == 32 * chunks * 8


def test_kernel_library_path_tracks_the_norm_source():
    p = KB.library_path(KN.SOURCE)
    assert p.parent == KB.BUILD_DIR and p.name.startswith("libfused_norm-")
    assert (KB.CSRC_DIR / KN.SOURCE).exists()
