"""The port's kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA card (marker ``gpu``) and skips without
one.  The file imports nothing of JAX, so on a machine without JAX it runs
on its own, without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances (bf16 on the card) are those of
``ai_rtc_agent_tpu_torch/ops/kernels/tolerance.py``, which ``chip_smoke.py``
holds the kernels to as well.
"""

import pytest
import torch

from ai_rtc_agent_tpu_torch.ops import lcm as PL
from ai_rtc_agent_tpu_torch.ops import schedule as PS
from ai_rtc_agent_tpu_torch.ops.kernels import attention as KA
from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF
from ai_rtc_agent_tpu_torch.ops.kernels import tolerance

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


# Key rows per tile of the instantiation serving (D, Lq), as the .cu header
# lists them; test_attention_key_tiles holds the built library to it.
KEY_TILES = {(64, 100): 128, (40, 100): 128, (80, 100): 64, (160, 100): 64,
             (64, 2100): 128, (40, 2100): 128}


def _edges():
    """Lk of 1, 77, BK-1, BK+1 and 2*BK+13 at each head dim, with Lq ragged
    against the 64-row query tile (and the 192-row one where D <= 64)."""
    return [(1, lq, lk, 2, d) for (d, lq), bk in KEY_TILES.items()
            for lk in (1, 77, bk - 1, bk + 1, 2 * bk + 13)]


@pytest.mark.parametrize("b,lq,lk,h,d", [
    (1, 4096, 4096, 5, 64), (1, 1024, 77, 10, 64), (2, 1000, 77, 8, 40), (1, 64, 64, 2, 160),
    (4, 1024, 1024, 5, 64), (4, 300, 77, 2, 64), (4, 1024, 77, 8, 80),
] + _edges())
def test_attention_kernel_matches_plain(cuda, b, lq, lk, h, d):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device=cuda).to(torch.bfloat16)
               for n in (lq, lk, lk))
    before = KA.launches
    out = KA.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert KA.launches == before + 1
    err = tolerance.attention_error(out, KA.attention_plain(q, k, v))
    assert err["ok"], err


def test_attention_key_tiles(cuda):
    assert {key: KA.key_tile(*key) for key in KEY_TILES} == KEY_TILES
    assert KA.key_tile(12, 100) == 0


def test_attention_kernel_refuses_what_it_cannot_run(cuda):
    x = torch.zeros((1, 8, 1, 12), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head dim not a multiple of 8
        KA.flash_attention(x, x, x)
    y = torch.zeros((1, 8, 1, 168), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head dim above 160
        KA.flash_attention(y, y, y)
    for dtype in (torch.float16, torch.float32):  # the kernel computes in bf16 only
        z = torch.zeros((1, 8, 1, 64), device=cuda, dtype=dtype)
        with pytest.raises(TypeError):
            KA.flash_attention(z, z, z)


def _coeffs(kind: str, device):
    if kind == "lcm":
        bt = PS.batched_sub_timesteps([18, 26, 35, 45], 50)
    else:
        bt = PS.batched_sub_timesteps([0], 1, spacing="trailing")
    c = PL.make_step_coeffs(PS.make_schedule(), bt).to(device)
    if kind == "turbo":
        c = PL.StepCoeffs(c.timesteps, c.alpha, c.sigma, torch.zeros_like(c.c_skip),
                          torch.ones_like(c.c_out), c.next_alpha, c.next_sigma)
    return c


@pytest.mark.parametrize("cfg_type,kind", [("none", "turbo"), ("self", "lcm"), ("initialize", "lcm")])
def test_epilogue_kernel_matches_plain(cuda, cfg_type, kind):
    pc = _coeffs(kind, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = [torch.randn((len(pc.alpha), 64, 64, 4), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(4)]
    g, d = torch.tensor(1.2, device=cuda), torch.tensor(0.9, device=cuda)
    before = KF.launches
    got = KF.fused_stream_epilogue(*args, pc, g, d, cfg_type=cfg_type)
    torch.cuda.synchronize()
    assert KF.launches == before + 1
    want = KF.epilogue_plain(*args, pc, g, d, cfg_type=cfg_type)
    for a, b in zip(got, want):
        err = tolerance.epilogue_error(a, b)
        assert err["ok"], err
