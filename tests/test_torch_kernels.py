"""Port parity: the two Hopper kernels' wrappers and plain versions.

On the CPU a wrapper takes its kernel's plain version, so these tests hold
the plain versions against the JAX Pallas kernels run in interpret mode
(as tests/test_pallas_kernels.py runs them), on the same numpy inputs.
Tolerance: f32, rtol=2e-4 / atol=2e-5 for attention (two softmax orders:
the Pallas kernel's blockwise online softmax vs a dense one), rtol=1e-4 /
atol=1e-5 for the elementwise epilogue, with and without the session axis
(the JAX kernel under ``jax.vmap`` over sessions).

The kernels themselves are held against these plain versions on the card
by tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import few_torch_threads  # noqa: F401  (autouse)
from ai_rtc_agent_tpu.ops import lcm as JL
from ai_rtc_agent_tpu.ops import schedule as JS
from ai_rtc_agent_tpu.ops.pallas import attention as JA
from ai_rtc_agent_tpu.ops.pallas import fused_scheduler as JF
from ai_rtc_agent_tpu_torch.ops import lcm as PL
from ai_rtc_agent_tpu_torch.ops import rcfg as PR
from ai_rtc_agent_tpu_torch.ops import schedule as PS
from ai_rtc_agent_tpu_torch.ops.kernels import attention as KA
from ai_rtc_agent_tpu_torch.ops.kernels import build as KB
from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF

# (B, Lq, Lk, H, D, block_q, block_k) for the JAX kernel
ATTENTION_CASES = [
    (2, 64, 64, 2, 16, 32, 32),  # self, divisible
    (1, 64, 13, 2, 8, 32, 256),  # cross: short context (block_k = Lk)
    (1, 40, 40, 2, 8, 16, 8),  # ragged Lq: the JAX kernel pads q
    (1, 10, 7, 2, 8, 8, 8),  # ragged Lk: the JAX kernel falls back to dense
    (2, 32, 77, 4, 40, 32, 77),  # SD1.5 head dim, 77-token context
    # the Hopper kernel's tiling edges: Lk of 1, 77, BK-1, BK+1 and 2*BK+13
    # for its key tiles of 128 (D <= 64) and 64 (D > 64) rows, Lq ragged
    # against its 64-row query tile, the cfg-self batch of 4
    (1, 100, 1, 2, 8, 64, 8),  # one key: block_k = Lk = 1
    (1, 100, 77, 1, 16, 64, 77),
    (1, 100, 127, 1, 8, 64, 127),
    (1, 100, 129, 1, 8, 64, 43),  # three key blocks of 43
    (1, 100, 269, 1, 8, 64, 256),  # ragged against block_k: dense fallback
    (1, 100, 63, 2, 8, 64, 21),
    (1, 100, 65, 2, 8, 64, 13),
    (1, 100, 141, 1, 8, 64, 47),
    (4, 70, 77, 1, 8, 32, 77),  # B=4, Lq ragged against block_q
    (1, 40, 77, 1, 80, 16, 77),  # SD1.5's middle head dim
    (1, 24, 65, 1, 160, 8, 13),  # SD1.5's widest head dim
]


@pytest.fixture
def no_kernel_build(monkeypatch):
    """Make any kernel build or load fail loudly: CPU tensors must never
    reach one."""

    def refuse(*a, **k):
        raise AssertionError("a kernel build was attempted for a CPU tensor")

    monkeypatch.setattr(KB, "build_library", refuse)
    monkeypatch.setattr(KB, "load_library", refuse)
    monkeypatch.setattr(KF, "load", refuse)
    monkeypatch.setattr(KA, "load", refuse)


def _qkv(rng, b, lq, lk, h, d):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, lq, h, d), (b, lk, h, d), (b, lk, h, d))]


@pytest.mark.parametrize("b,lq,lk,h,d,bq,bk", ATTENTION_CASES)
def test_attention_plain_matches_jax_flash_kernel(rng, no_kernel_build, b, lq, lk, h, d, bq, bk):
    q, k, v = _qkv(rng, b, lq, lk, h, d)
    want = np.asarray(JA.flash_attention(q, k, v, block_q=bq, block_k=bk, interpret=True))
    before = KA.launches
    got = KA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert KA.launches == before  # the plain version ran, no kernel
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        KA.attention_plain(*(torch.from_numpy(a) for a in (q, k, v))).numpy(),
        np.asarray(JA._xla_attention(q, k, v)), rtol=2e-4, atol=2e-5,
    )


def test_attention_rejects_mask():
    q = torch.zeros(1, 8, 1, 8)
    with pytest.raises(NotImplementedError):
        KA.flash_attention(q, q, q, mask=torch.zeros(8, 8))
    with pytest.raises(NotImplementedError):
        JA.flash_attention(jnp.zeros((1, 8, 1, 8)), jnp.zeros((1, 8, 1, 8)),
                           jnp.zeros((1, 8, 1, 8)), mask=jnp.zeros((8, 8)))


def test_attention_plain_keeps_bf16_io(rng):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(rng, 1, 16, 9, 2, 8))
    out = KA.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    ref = KA.attention_plain(q.float(), k.float(), v.float())
    # f32 math on bf16 inputs; only the output rounds to bf16 (2^-8 relative)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=2**-7, atol=1e-3)


def _coeffs(kind: str):
    """(port StepCoeffs on CPU, JAX StepCoeffs): lcm 4-stage at B=4, or the
    engine's turbo coefficients (c_skip=0, c_out=1) at B=1."""
    if kind == "lcm":
        bt = JS.batched_sub_timesteps([18, 26, 35, 45], 50)
    else:
        bt = JS.batched_sub_timesteps([0], 1, spacing="trailing")
    jc = JL.make_step_coeffs(JS.make_schedule(), bt)
    pc = PL.make_step_coeffs(PS.make_schedule(), bt)
    if kind == "turbo":
        zero, one = np.zeros_like(jc.c_skip), np.ones_like(jc.c_out)
        jc = JL.StepCoeffs(jc.timesteps, jc.alpha, jc.sigma, zero, one, jc.next_alpha, jc.next_sigma)
        pc = PL.StepCoeffs(pc.timesteps, pc.alpha, pc.sigma, zero, one, pc.next_alpha, pc.next_sigma)
    return pc.to("cpu"), jc.as_jnp()


@pytest.mark.parametrize("cfg_type", ["self", "none", "initialize"])
@pytest.mark.parametrize("kind", ["lcm", "turbo"])
def test_epilogue_plain_matches_jax_fused_kernel(rng, no_kernel_build, cfg_type, kind):
    pc, jc = _coeffs(kind)
    shape = (len(pc.alpha), 8, 8, 4)
    x, eps, stock, noise = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    g, d = 1.5, 0.9
    want = JF.fused_stream_epilogue(x, eps, stock, noise, jc, g, d, cfg_type, interpret=True)
    before = KF.launches
    got = KF.fused_stream_epilogue(
        *(torch.from_numpy(a) for a in (x, eps, stock, noise)), pc,
        torch.tensor(g), torch.tensor(d), cfg_type=cfg_type,
    )
    assert KF.launches == before
    for name, a, b in zip(("denoised", "advanced", "stock"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5, err_msg=name)


# (B, fbs) -> (t_index_list, num_inference_steps, spacing) of the stream batch
CHAIN_BATCHES = {(1, 1): ([0], 1, "trailing"), (4, 1): ([18, 26, 35, 45], 50, "leading"),
                 (4, 2): ([18, 35], 50, "leading")}


@pytest.mark.parametrize("latent", [(8, 8, 4), (5, 7, 4)], ids=["8x8x4", "ragged5x7x4"])
@pytest.mark.parametrize("turbo", [False, True], ids=["lcm", "turbo"])
@pytest.mark.parametrize("b,fbs", list(CHAIN_BATCHES), ids=["B1fbs1", "B4fbs1", "B4fbs2"])
@pytest.mark.parametrize("cfg_type", ["none", "self", "initialize"])
def test_epilogue_chain_keywords_match_jax_fused_kernel(rng, no_kernel_build, cfg_type, b, fbs,
                                                        turbo, latent):
    """The keywords that carry the engine's whole post-UNet chain (turbo,
    noise_shift, in-place advanced rows and stock) against the JAX kernel
    fed as the JAX engine feeds it: the shifted noise by concatenation, the
    turbo coefficients as explicit zeros and ones."""
    t_index, steps, spacing = CHAIN_BATCHES[(b, fbs)]
    bt = JS.batched_sub_timesteps(t_index, steps, fbs, spacing=spacing)
    jc = JL.make_step_coeffs(JS.make_schedule(), bt, fbs)
    pc = PL.make_step_coeffs(PS.make_schedule(), bt, fbs).to("cpu")
    if turbo:  # the port's c_skip/c_out stay the LCM ones: turbo must not read them
        jc = JL.StepCoeffs(jc.timesteps, jc.alpha, jc.sigma, np.zeros_like(jc.c_skip),
                           np.ones_like(jc.c_out), jc.next_alpha, jc.next_sigma)
    shape = (b, *latent)
    x, eps, stock, noise = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    noise_next = (np.concatenate([noise[fbs:], np.zeros_like(noise[:fbs])])
                  if b > fbs else np.zeros_like(noise))
    g, d = 1.5, 0.9
    want = JF.fused_stream_epilogue(x, eps, stock, noise_next, jc.as_jnp(), g, d, cfg_type,
                                    interpret=True)
    t = lambda a: torch.from_numpy(a.copy())
    kw = dict(cfg_type=cfg_type, turbo=turbo, noise_shift=fbs)
    before = KF.launches
    got = KF.fused_stream_epilogue(t(x), t(eps), t(stock), t(noise), pc, torch.tensor(g),
                                   torch.tensor(d), **kw)
    for name, a, w in zip(("denoised", "advanced", "stock"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name)
    # in place, as the engine calls it: the advanced rows into the ring buffer
    # (B - fbs rows), the new stock into the stock tensor it reads
    x_buf = torch.full((b - fbs, *latent), float("nan"))
    stock_io = t(stock)
    den, adv, new_stock = KF.fused_stream_epilogue(
        t(x), t(eps), stock_io, t(noise), pc, torch.tensor(g), torch.tensor(d), **kw,
        advanced_out=x_buf, stock_out=stock_io,
    )
    assert KF.launches == before  # the plain version ran, no kernel
    assert adv is x_buf and new_stock is stock_io
    assert torch.equal(den, got[0])
    assert torch.equal(x_buf, got[1][: b - fbs])
    assert torch.equal(stock_io, got[2])


# The session axis: S stacked slots, a bucket of sessions naming slots.
# (slots, k_real): a ragged count of 3, a bucket of 4 padded with a
# duplicate of its last real slot, one of 2, and a bucket of 4 whose slot
# vector names a 4th distinct slot with 3 real sessions (a captured bucket
# step's buffers after a 4-session step: that slot's rows must keep their
# bits).
SESSION_BUCKETS = {"k3": ([4, 0, 2], 3), "k4pad": ([1, 3, 0, 0], 3), "k2": ([2, 1], 2),
                   "k4stale": ([1, 3, 0, 2], 3)}
N_SLOTS = 5


def _slot_coeffs(kind: str, n_slots: int):
    """Per-slot coefficient tables (each slot its own t_index list):
    (port StepCoeffs of [S, B] tensors, list of JAX StepCoeffs)."""
    tables = []
    for i in range(n_slots):
        if kind == "lcm":
            bt = JS.batched_sub_timesteps([18 + i, 26 + i, 35 + i, 45 + i], 50)
        else:
            bt = JS.batched_sub_timesteps([i], 8, spacing="trailing")
        tables.append(JL.make_step_coeffs(JS.make_schedule(), bt))
    stack = lambda f: torch.from_numpy(np.stack([getattr(t, f) for t in tables]))
    pc = PL.StepCoeffs(*(stack(f) for f in ("timesteps", "alpha", "sigma", "c_skip", "c_out",
                                             "next_alpha", "next_sigma")))
    return pc, tables


@pytest.mark.parametrize("k_real_as", ["int", "device"])
@pytest.mark.parametrize("bucket", list(SESSION_BUCKETS))
@pytest.mark.parametrize("kind", ["lcm", "turbo"])
@pytest.mark.parametrize("cfg_type", ["none", "self", "initialize"])
def test_epilogue_session_axis_matches_jax_fused_kernel_under_vmap(rng, no_kernel_build, cfg_type,
                                                                     kind, bucket, k_real_as):
    """The segmented epilogue (one segment of B rows per session, per-slot
    coefficients, guidance and delta, the renoise shift inside each slot,
    the ring rows and stock written in place at the slots) against the JAX
    kernel under ``jax.vmap`` over the bucket's sessions, each fed as the
    JAX engine feeds it (the slot's shifted noise by concatenation, turbo
    coefficients as zeros and ones).  Padding segments write nothing; the
    count of real sessions comes as an int or as an int32 tensor (what a
    captured bucket step reads)."""
    import jax

    slots, k_real = SESSION_BUCKETS[bucket]
    k, turbo = len(slots), kind == "turbo"
    pc, tables = _slot_coeffs(kind, N_SLOTS)
    B = pc.alpha.shape[1]
    lat = (6, 5, 4)
    x, eps = (rng.standard_normal((k * B, *lat)).astype(np.float32) for _ in range(2))
    stock, noise = (rng.standard_normal((N_SLOTS, B, *lat)).astype(np.float32) for _ in range(2))
    x_buf = rng.standard_normal((N_SLOTS, B - 1, *lat)).astype(np.float32)
    g = (1.1 + 0.2 * np.arange(N_SLOTS)).astype(np.float32)
    d = (0.9 - 0.1 * np.arange(N_SLOTS)).astype(np.float32)

    def jax_session(x, e, st, nz, g, d, *c):
        cs, co = (jax.numpy.zeros_like(c[3]), jax.numpy.ones_like(c[4])) if turbo else c[3:5]
        jc = JL.StepCoeffs(c[0], c[1], c[2], cs, co, c[5], c[6])
        nz_next = jax.numpy.concatenate([nz[1:], jax.numpy.zeros_like(nz[:1])])
        return JF.fused_stream_epilogue(x, e, st, nz_next, jc, g, d, cfg_type, interpret=True)

    fields = ("timesteps", "alpha", "sigma", "c_skip", "c_out", "next_alpha", "next_sigma")
    cols = [np.stack([getattr(tables[i], f) for i in slots]) for f in fields]
    want = [np.asarray(a) for a in jax.vmap(jax_session)(
        x.reshape(k, B, *lat), eps.reshape(k, B, *lat), stock[slots], noise[slots], g[slots],
        d[slots], *cols)]

    t = lambda a: torch.from_numpy(a.copy())
    ring, stock_io = t(x_buf), t(stock)
    before = KF.launches
    den, adv, new_stock = KF.fused_stream_epilogue(
        t(x), t(eps), stock_io, t(noise), pc, t(g), t(d), cfg_type=cfg_type, turbo=turbo,
        noise_shift=1, advanced_out=ring, stock_out=stock_io,
        slots=torch.tensor(slots, dtype=torch.int32),
        k_real=k_real if k_real_as == "int" else torch.tensor(k_real, dtype=torch.int32))
    assert KF.launches == before  # the plain version ran, no kernel
    assert adv is ring
    real = slots[:k_real]
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(den.numpy()[: k_real * B], want[0][:k_real].reshape(-1, *lat), **tol)
    np.testing.assert_allclose(ring.numpy()[real], want[1][:k_real, : B - 1], **tol)
    idle = [i for i in range(N_SLOTS) if i not in real]
    np.testing.assert_array_equal(ring.numpy()[idle], x_buf[idle])
    if cfg_type == "self":
        assert new_stock is stock_io
        np.testing.assert_allclose(stock_io.numpy()[real], want[2][:k_real], **tol)
        np.testing.assert_array_equal(stock_io.numpy()[idle], stock[idle])
    else:  # the stock does not change
        np.testing.assert_array_equal(stock_io.numpy(), stock)


@pytest.mark.parametrize("cfg_type", ["none", "self", "initialize"])
def test_epilogue_one_session_is_the_single_call(rng, no_kernel_build, cfg_type):
    """One session at slot 0 of a one-slot stack gives what today's call
    gives for today's arguments."""
    pc, _ = _coeffs("lcm")
    shape = (4, 8, 8, 4)
    x, eps, stock, noise = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                            for _ in range(4))
    x_buf = torch.zeros((3, 8, 8, 4))
    kw = dict(cfg_type=cfg_type, noise_shift=1)
    one = KF.fused_stream_epilogue(x, eps, stock.clone(), noise, pc, torch.tensor(1.3),
                                   torch.tensor(0.8), advanced_out=x_buf.clone(), **kw)
    ring, stock_io = x_buf[None].clone(), stock[None].clone()
    stacked = PL.StepCoeffs(*(v[None] for v in pc.as_dict().values()))
    seg = KF.fused_stream_epilogue(x, eps, stock_io, noise[None], stacked, torch.tensor([1.3]),
                                   torch.tensor([0.8]), advanced_out=ring, stock_out=stock_io,
                                   slots=torch.zeros(1, dtype=torch.int32), **kw)
    assert torch.equal(seg[0], one[0])
    assert torch.equal(ring[0], one[1])
    assert torch.equal(stock_io[0], one[2])


def test_epilogue_session_axis_needs_the_ring_in_place():
    pc, _ = _coeffs("lcm")
    x = torch.zeros(4, 2, 2, 4)
    stacked = PL.StepCoeffs(*(v[None] for v in pc.as_dict().values()))
    with pytest.raises(ValueError, match="advanced_out"):
        KF.fused_stream_epilogue(x, x, x[None], x[None], stacked, torch.ones(1), torch.ones(1),
                                 cfg_type="none", slots=torch.zeros(1, dtype=torch.int32))


def test_epilogue_plain_matches_composed_port_ops(rng):
    pc, _ = _coeffs("lcm")
    x, eps, stock, noise = (torch.from_numpy(rng.standard_normal((4, 8, 8, 4)).astype(np.float32))
                            for _ in range(4))
    den, adv, new_stock = KF.epilogue_plain(x, eps, stock, noise, pc, 1.3, 0.7, "self")
    e = PR.combine_residual(eps, stock, 1.3, 0.7)
    den_ref = PL.lcm_denoise(x, e, pc)
    torch.testing.assert_close(den, den_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(adv, PL.renoise_next(den_ref, noise, pc), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(
        new_stock, PR.update_stock_noise(stock, eps, pc.alpha, pc.sigma), rtol=1e-4, atol=1e-5
    )


def test_epilogue_rejects_full_cfg():
    pc, _ = _coeffs("turbo")
    x = torch.zeros(1, 4, 4, 4)
    with pytest.raises(ValueError):
        KF.fused_stream_epilogue(x, x, x, x, pc, 1.0, 1.0, cfg_type="full")


def test_kernel_library_path_tracks_source():
    for source, stem in ((KA.SOURCE, "flash_attention"), (KF.SOURCE, "fused_stream_epilogue")):
        p = KB.library_path(source)
        assert p.parent == KB.BUILD_DIR and p.name.startswith(f"lib{stem}-")
        assert (KB.CSRC_DIR / source).exists()
    assert KB.BUILD_DIR.name == "build" and KB.BUILD_DIR.parent == KB.PACKAGE_DIR.parent
