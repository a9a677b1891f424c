"""The port's kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA card (marker ``gpu``) and skips without
one.  The file imports nothing of JAX, so on a machine without JAX it runs
on its own, without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances (bf16 on the card) are those of
``ai_rtc_agent_tpu_torch/ops/kernels/tolerance.py``, which ``chip_smoke.py``
holds the kernels to as well; the epilogue's call copies and graph replay
are chip_smoke's own helpers (it imports only the standard library).
"""

import asyncio
import time

import numpy as np
import pytest
import torch

import chip_smoke
from ai_rtc_agent_tpu_torch.ops import lcm as PL
from ai_rtc_agent_tpu_torch.ops import schedule as PS
from ai_rtc_agent_tpu_torch.ops.kernels import attention as KA
from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF
from ai_rtc_agent_tpu_torch.ops.kernels import tolerance
from ai_rtc_agent_tpu_torch.server import sessions
from ai_rtc_agent_tpu_torch.server.signaling import LoopbackProvider
from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline
from ai_rtc_agent_tpu_torch.tree import tree_equal

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
    # SD1.5's own step shapes (8 heads): D=160 at Lq 256 and 64, D=40 self at 4096
    (4, 256, 256, 8, 160), (4, 64, 64, 8, 160), (4, 4096, 4096, 8, 40), (16, 4096, 77, 8, 40),
    # head dims off a multiple of 8, zero-padded by the wrapper: 12, and
    # tiny-test's 4; with tiny-test's D=8 level
    (1, 100, 77, 2, 12), *chip_smoke.TINY_ATTENTION,
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


# (B, fbs) -> (t_index_list, num_inference_steps, spacing) of the stream batch
CHAIN_BATCHES = {(1, 1): ([0], 1, "trailing"), (4, 1): ([18, 26, 35, 45], 50, "leading"),
                 (4, 2): ([18, 35], 50, "leading")}
# (cfg_type, turbo, B, fbs, latent, element offset of every tensor)
CHAIN_CASES = [
    ("none", True, 1, 1, (64, 64, 4), 0),  # the sd-turbo main path
    ("self", False, 4, 1, (64, 64, 4), 0),
    ("initialize", False, 4, 1, (64, 64, 4), 0),
    ("self", False, 4, 2, (64, 64, 4), 0),  # fbs=2: two exit rows, shift 2
    ("self", False, 4, 1, (5, 7, 4), 0),  # n=140: a ragged tail; bf16 rows 1, 3 off 16 bytes
    ("none", True, 4, 2, (5, 7, 4), 0),
    ("initialize", True, 1, 1, (3, 3, 3), 0),  # n=27: three 8-element chunks and a tail
    ("self", False, 4, 1, (64, 64, 4), 1),  # every row base off 16 bytes
]


def _chain_call(device, dtype, cfg_type, turbo, b, fbs, latent, offset):
    """(args, kwargs) of the engine's call, in place: the advanced rows into
    a [B-fbs] ring buffer, the new stock into the stock it reads; every
    tensor ``offset`` elements into its storage."""
    t_index, steps, spacing = CHAIN_BATCHES[(b, fbs)]
    bt = PS.batched_sub_timesteps(t_index, steps, fbs, spacing=spacing)
    pc = PL.make_step_coeffs(PS.make_schedule(), bt, fbs).to(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def tensor(rows):
        shape = (rows, *latent)
        n = rows * latent[0] * latent[1] * latent[2]
        buf = torch.randn(n + offset, generator=gen, device=device).to(dtype)
        return buf[offset:].view(shape)

    args = (*(tensor(b) for _ in range(4)), pc, torch.tensor(1.2, device=device),
            torch.tensor(0.9, device=device))
    kwargs = dict(cfg_type=cfg_type, turbo=turbo, noise_shift=fbs,
                  advanced_out=tensor(b - fbs), stock_out=args[2])
    return args, kwargs


def _assert_close(got, want):
    for name, a, b in zip(("denoised", "advanced", "stock"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.numel():
            err = tolerance.epilogue_error(a, b)
            assert err["ok"], (name, err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("cfg_type,turbo,b,fbs,latent,offset", CHAIN_CASES)
def test_epilogue_chain_kernel_matches_plain(cuda, dtype, cfg_type, turbo, b, fbs, latent, offset):
    """The engine's in-place call (aliased stock, advanced rows into the ring
    buffer) and the out-of-place one, against the plain version."""
    args, kwargs = _chain_call(cuda, dtype, cfg_type, turbo, b, fbs, latent, offset)
    before = KF.launches
    a, kw = chip_smoke.fresh_epilogue_call(args, kwargs)
    got = KF.fused_stream_epilogue(*a, **kw)
    torch.cuda.synchronize()
    assert got[1] is kw["advanced_out"] and got[2] is a[2]
    _assert_close(got, chip_smoke.plain_epilogue_call(KF, args, kwargs))
    oop = dict(kwargs, advanced_out=None, stock_out=None)
    got = KF.fused_stream_epilogue(*args, **oop)
    torch.cuda.synchronize()
    assert KF.launches == before + 2
    _assert_close(got, KF.epilogue_plain(*args, **oop))


def test_epilogue_kernel_refuses_mixed_dtypes_and_non_f32_coefficients(cuda):
    args, kwargs = _chain_call(cuda, torch.bfloat16, "self", False, 4, 1, (8, 8, 4), 0)
    x, e, s, n, pc, g, d = args
    with pytest.raises(TypeError):  # eps in another dtype than x
        KF.fused_stream_epilogue(x, e.float(), s, n, pc, g, d, **kwargs)
    with pytest.raises(TypeError):  # a ring buffer in another dtype
        KF.fused_stream_epilogue(*args, **dict(kwargs, advanced_out=kwargs["advanced_out"].float()))
    for bad in (pc.alpha.double(), pc.alpha.to(torch.bfloat16), pc.alpha.cpu()):
        with pytest.raises(TypeError):  # coefficient vectors: f32 on the card
            KF.fused_stream_epilogue(x, e, s, n, PL.StepCoeffs(
                pc.timesteps, bad, *[getattr(pc, f) for f in (
                    "sigma", "c_skip", "c_out", "next_alpha", "next_sigma")]), g, d, **kwargs)
    with pytest.raises(TypeError):  # guidance: an f32 device scalar, read by pointer
        KF.fused_stream_epilogue(x, e, s, n, pc, 1.2, d, **kwargs)
    with pytest.raises(TypeError):
        KF.fused_stream_epilogue(x, e, s, n, pc, g.double(), d, **kwargs)
    with pytest.raises(TypeError):  # f16 is neither of the kernel's types
        h = x.half()
        KF.fused_stream_epilogue(h, h, h, h, pc, g, d, cfg_type="none")


@pytest.mark.parametrize("cfg_type,turbo,b,fbs", [("none", True, 1, 1), ("self", False, 4, 1)])
def test_epilogue_launch_replays_in_a_cuda_graph(cuda, cfg_type, turbo, b, fbs):
    """The wrapper does no host sync: its launch is captured in a CUDA graph
    and the replay, from the call's starting state, matches the plain version."""
    args, kwargs = _chain_call(cuda, torch.bfloat16, cfg_type, turbo, b, fbs, (64, 64, 4), 0)
    _assert_close(*chip_smoke.epilogue_graph_replay(torch, KF, args, kwargs))


def test_loopback_session_on_the_card(cuda, monkeypatch):
    """One WHIP publisher and one WHEP viewer through server/sessions.py on
    the card, sd-turbo 512x512 bf16 with random weights: the served frames
    carry their pts in order, sit within 1 uint8 level of __call__ from the
    same state, and each step launches what a direct call does (32
    attention, 1 epilogue); closing both sessions leaves no connection."""
    monkeypatch.setenv("WARMUP_FRAMES", "0")
    monkeypatch.setenv("PIPELINE_DEPTH", "2")
    pipe = StreamDiffusionPipeline("stabilityai/sd-turbo")
    frames = chip_smoke._frames(np, 4)
    before = KA.launches, KF.launches
    direct = [pipe(f) for f in frames]
    assert (KA.launches - before[0], KF.launches - before[1]) == (32 * 4, 4)

    async def serve():
        state = {}
        sessions.configure(state, pipeline=pipe, provider=LoopbackProvider())
        await sessions.startup(state)
        pub_id, pub_pc, view_id, viewer = await chip_smoke.open_loopback_session(state)
        pipe.restart()
        start = KA.launches, KF.launches
        served, _ = await chip_smoke.exchange(pub_pc, viewer, frames + frames[-1:], 0, 4)
        launches = KA.launches - start[0], KF.launches - start[1]
        closed = [await sessions.close(state, "whep", view_id),
                  await sessions.close(state, "whip", pub_id)]
        left = len(state["pcs"])
        await sessions.shutdown(state)
        return served, launches, closed, left

    served, launches, closed, left = asyncio.run(serve())
    assert launches == (32 * 5, 5)  # 4 viewed, 1 more in flight
    assert [vf.pts for vf in served] == [0, 1, 2, 3]
    for vf, d in zip(served, direct):
        got = vf.to_ndarray()
        assert got.shape == (512, 512, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(np.int16) - d).max() <= 1
    assert closed == [True, True] and left == 0


@pytest.mark.parametrize("cfg_type,k_real,slots", chip_smoke.SESSION_EPILOGUE)
def test_epilogue_session_axis_kernel_matches_plain(cuda, cfg_type, k_real, slots):
    """The bucket step's call: k sessions over a stacked state, slot-indexed
    in-place writes of the ring and stock (a padded bucket repeats a slot),
    against the plain version from the same state: the real sessions'
    denoised rows and the whole stacked ring and stock."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    args, kwargs = chip_smoke.session_epilogue_call(torch, cfg_type, k_real, slots, gen)
    seg = args[0].shape[0] // len(slots)
    before = KF.launches
    a, kw = chip_smoke.fresh_epilogue_call(args, kwargs)
    got = KF.fused_stream_epilogue(*a, **kw)
    torch.cuda.synchronize()
    assert KF.launches == before + 1
    assert got[1] is kw["advanced_out"] and got[2] is a[2]
    want = chip_smoke.plain_epilogue_call(KF, args, kwargs)
    _assert_close((got[0][: k_real * seg], *got[1:]), (want[0][: k_real * seg], *want[1:]))
    idle = [i for i in range(chip_smoke.N_SLOTS) if i not in slots[:k_real]]
    assert torch.equal(kw["advanced_out"][idle], kwargs["advanced_out"][idle])


def test_epilogue_session_axis_replays_in_a_cuda_graph(cuda):
    cfg_type, k_real, slots = chip_smoke.SESSION_EPILOGUE[1]  # the padded bucket
    gen = torch.Generator(device=cuda).manual_seed(1)
    args, kwargs = chip_smoke.session_epilogue_call(torch, cfg_type, k_real, slots, gen)
    got, want = chip_smoke.epilogue_graph_replay(torch, KF, args, kwargs)
    rows = k_real * (args[0].shape[0] // len(slots))
    _assert_close((got[0][:rows], *got[1:]), (want[0][:rows], *want[1:]))


def test_epilogue_session_axis_refuses_what_it_cannot_run(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    args, kwargs = chip_smoke.session_epilogue_call(torch, "self", 2, [5, 2], gen)
    with pytest.raises(TypeError):  # slots: int32 on the card
        KF.fused_stream_epilogue(*args, **dict(kwargs, slots=kwargs["slots"].long()))
    with pytest.raises(ValueError):  # the stacked ring is required
        KF.fused_stream_epilogue(*args, **dict(kwargs, advanced_out=None))
    with pytest.raises(ValueError):  # k_real past the bucket
        KF.fused_stream_epilogue(*args, **dict(kwargs, k_real=3))


def test_scheduler_steps_match_dedicated_engines_on_the_card(cuda):
    """tiny-test (f32, plain attention: the difference is the batch) through
    the batch scheduler on the card (its buckets replayed from CUDA graphs):
    3 sessions in the bucket of 4, one epilogue launch per bucket step,
    every frame within 1 uint8 level of a dedicated engine, stepping
    eagerly, fed the same state row."""
    from dataclasses import replace

    from ai_rtc_agent_tpu_torch.models import registry
    from ai_rtc_agent_tpu_torch.stream.engine import StreamEngine
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    cfg = replace(registry.default_stream_config("tiny-test"), dtype="float32", attn_impl="plain")
    bundle = registry.load_model_bundle("tiny-test", attn_impl="plain")
    sched = BatchScheduler(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt,
                           max_sessions=4, window_ms=10_000.0)
    try:
        sess = [sched.claim(f"s{i}", prompt=f"prompt {i}", seed=i) for i in range(3)]
        engines = []
        for s in sess:
            eng = StreamEngine(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt,
                               graphs=False)
            eng.state = chip_smoke.session_row(sched.states, s.slot)
            engines.append(eng)
        frames = [chip_smoke._frames(np, 4, seed=i, size=64) for i in range(3)]
        before, steps0 = KF.launches, sched.steps_total
        for j in range(4):
            handles = [s.submit(f[j]) for s, f in zip(sess, frames)]
            outs = [s.fetch(h) for s, h in zip(sess, handles)]
            for out, eng, f in zip(outs, engines, frames):
                assert np.abs(out.astype(np.int16) - eng(f[j])).max() <= 1
        assert sched.steps_total - steps0 == 4
        assert KF.launches - before == 4 + 4 * 3  # 4 bucket steps, 12 dedicated steps
    finally:
        sched.close()


# -- the captured step: one CUDA graph per engine and per bucket size -------------------

def test_native_rtp_session_through_the_scheduler_on_the_card(cuda, monkeypatch):
    """One /offer session over the native tier (WEBRTC_PROVIDER=native-rtp,
    the C++ runtime of native/, NullCodec) on loopback UDP into a 2-slot
    graph scheduler over sd-turbo 512x512 bf16: the returned frames come
    back in pts order, each equal bit for bit to a direct call of its
    scheduler session through the bucket step of the same occupancy, 32 + 1
    launches a bucket step; closing leaves no connection and frees the slot."""
    from ai_rtc_agent_tpu_torch.media import native
    from ai_rtc_agent_tpu_torch.server.signaling import get_provider
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    assert native.load() is not None, native.load_error()
    for name, value in (("WEBRTC_PROVIDER", "native-rtp"), ("WARMUP_FRAMES", "0"),
                        ("OVERLOAD_RX_QUEUE_BOUND", "16384")):
        monkeypatch.setenv(name, value)
    pipe = StreamDiffusionPipeline("stabilityai/sd-turbo")
    provider = get_provider()
    provider.use_h264 = False  # lossless, so that frames compare bit for bit
    sched = BatchScheduler.from_pipeline(pipe, max_sessions=2)
    tap = chip_smoke.StepTap(sched)
    frames = chip_smoke._frames(np, 12, seed=5)

    async def serve():
        state = {}
        sessions.configure(state, pipeline=pipe, provider=provider, batch_scheduler=sched)
        await sessions.startup(state)
        leg = await chip_smoke.open_native_leg(np, state, "offer", 0, 30, frames, False)
        start = KA.launches, KF.launches
        await chip_smoke.drive_native([leg], 30, len(frames))
        launches = KA.launches - start[0], KF.launches - start[1]
        direct = await asyncio.to_thread(chip_smoke.direct_outputs, np, tap, [leg])
        await chip_smoke.close_native(state, "offer", [leg])
        left = len(state["pcs"]), sched.free_slots
        await sessions.shutdown(state)
        return leg, launches, direct, left

    leg, (attn, epi), direct, left = asyncio.run(serve())
    pts = [p for p, _, _ in leg.got]
    assert pts and pts == sorted(set(pts))
    assert epi >= len(pts) and attn == 32 * epi
    for p, arr, _ in leg.got:
        assert arr.shape == (512, 512, 3) and np.array_equal(arr, direct[(leg.key, p)]), p
    assert left == (0, 2)


def test_broadcast_group_fans_one_encode_out_to_4_viewers_on_the_card(cuda, turbo_pipe,
                                                                       monkeypatch):
    """One /whip publisher over the native tier (NullCodec, loopback UDP) into
    a 2-slot graph scheduler over sd-turbo 512x512 bf16, and 4 plain WHEP
    viewers of its broadcast group in a process of their own: every viewer's
    datagrams equal but for SSRC, seq and ts, the frames two of them
    reassemble equal bit for bit to direct calls, 32 + 1 launches a bucket
    step, a 5th viewer refused with 503 and Retry-After (chip_smoke's phase
    11 run at V=4)."""
    from ai_rtc_agent_tpu_torch.media import native
    from ai_rtc_agent_tpu_torch.server.signaling import get_provider
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    assert native.load() is not None, native.load_error()
    for name, value in (("WEBRTC_PROVIDER", "native-rtp"), ("WARMUP_FRAMES", "0"),
                        ("OVERLOAD_RX_QUEUE_BOUND", "16384")):
        monkeypatch.setenv(name, value)
    provider = get_provider()
    provider.use_h264 = False
    sched = BatchScheduler.from_pipeline(turbo_pipe, max_sessions=2)
    tap = chip_smoke.StepTap(sched)
    frames = chip_smoke._frames(np, 8, seed=11)

    async def serve():
        state = {}
        sessions.configure(state, pipeline=turbo_pipe, provider=provider, batch_scheduler=sched)
        await sessions.startup(state)
        viewers = await chip_smoke.ViewerProcess.start(512)
        try:
            return await chip_smoke.broadcast_once(np, state, tap, sched, viewers, "group", 4,
                                                   frames, 512, "card test")
        finally:
            await viewers.close()
            await sessions.shutdown(state)

    out = asyncio.run(serve())  # broadcast_once fails (SystemExit) on any broken hold
    assert len(set(out["datagrams"])) == 1 and out["datagrams"][0] > 0
    assert out["held"] > 0 and out["attn"] == 32 * out["epi"] == 32 * out["steps"]
    assert out["refused"][:2] == [503, "2"]


def _tiny_ring(device, graphs):
    """tiny-test's 4-stage LCM cfg-self ring in f32 with plain attention (the
    ring and stock move every step), as an engine (graph or eager)."""
    from dataclasses import replace

    from ai_rtc_agent_tpu_torch.models import registry
    from ai_rtc_agent_tpu_torch.stream.engine import StreamEngine

    cfg = replace(registry.default_stream_config("tiny-test"), dtype="float32", attn_impl="plain")
    bundle = registry.load_model_bundle("tiny-test", attn_impl="plain")
    return StreamEngine(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt,
                        device=device, graphs=graphs)


@pytest.fixture(scope="module")
def turbo_pipe():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return StreamDiffusionPipeline("stabilityai/sd-turbo")


def _eager_twin(engine):
    """An eager engine over the same weights, from a copy of ``engine``'s state."""
    from ai_rtc_agent_tpu_torch.stream.engine import StreamEngine

    twin = StreamEngine(engine.models, engine.params, engine.cfg, engine.encode_prompt,
                        device=engine.device, graphs=False)
    twin.state = chip_smoke.session_row(engine.state, None)
    return twin


def test_engine_replay_equals_eager(cuda, turbo_pipe):
    """sd-turbo 512x512 bf16: the pipeline's captured step replays the eager
    step bit for bit from one state, 32 attention and 1 epilogue launches a
    replay, with 2 steps in flight over its one static output."""
    eng = turbo_pipe.engine
    step = eng.graph_cache.steps()[eng.key]
    assert step.captured and step.launches == (32, 1)
    eager = _eager_twin(eng)
    frames = chip_smoke._frames(np, 4, seed=3)
    before = KA.launches, KF.launches
    pending = [eng.submit(f) for f in frames[:2]]  # two in flight, different frames
    got = [eng.fetch(h) for h in pending] + [eng(f) for f in frames[2:]]
    assert (KA.launches - before[0], KF.launches - before[1]) == (32 * 4, 4)
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, eager(f))


@pytest.mark.parametrize("k,n", [(1, 1), (2, 2), (4, 3), (4, 4), (8, 8)],
                         ids=["k1", "k2", "k3of4", "k4", "k8"])
def test_bucket_replay_equals_eager(cuda, turbo_pipe, k, n):
    """The bucket step of n sessions in the bucket of k (sd-turbo 512x512 bf16,
    8 stacked slots with their own prompts and noise), replayed from its
    graph and stepped eagerly from copies of one state: the same frames
    and the same state after 2 steps."""
    from ai_rtc_agent_tpu_torch.parallel.multipeer import BucketStep
    from ai_rtc_agent_tpu_torch.stream.engine import stack_states
    from ai_rtc_agent_tpu_torch.tree import tree_map

    eng = turbo_pipe.engine
    states = stack_states([eng.build_state(f"prompt {i}", seed=i) for i in range(8)])
    twin = tree_map(lambda a: a.clone(), states)
    graph = BucketStep(eng.models, eng.cfg, cuda, graphs=True)
    eager = BucketStep(eng.models, eng.cfg, cuda, graphs=False)
    slots = [5, 2, 7, 0, 3, 6, 1, 4][:n]
    for j in range(2):
        frames = np.stack(chip_smoke._frames(np, n, seed=10 + j))
        got = graph(eng.params, states, frames, slots, k).cpu().numpy()
        want = eager(eng.params, twin, frames, slots, k).cpu().numpy()
        np.testing.assert_array_equal(got[:n], want[:n])
    for key in ("x_buf", "stock"):
        assert torch.equal(states[key], twin[key])


@pytest.mark.parametrize("b,lq,lk,h,d", [case[:5] for case in chip_smoke.MAIN_ATTENTION]
                         + chip_smoke.SESSION_ATTENTION)
def test_attention_replays_in_a_cuda_graph(cuda, b, lq, lk, h, d):
    """Attention captured at every main-path shape and at the bucket's
    batches (B=8, 32), replayed on new inputs written in place."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device=cuda).to(torch.bfloat16)
               for n in (lq, lk, lk))
    err = chip_smoke.attention_graph_replay(torch, KA, q, k, v, gen)
    assert err["ok"], err


def test_control_plane_updates_show_in_the_next_replay(cuda):
    """A prompt, a t-index and a guidance update between replays (the tiny
    ring, f32): each lands in place, so the next replayed frame is the eager
    engine's with the same update, and differs from a frame without it."""
    graph = _tiny_ring(cuda, True).prepare("a cat", seed=1)
    eager, still = _eager_twin(graph), _eager_twin(graph)
    frames = chip_smoke._frames(np, 8, seed=5, size=64)
    updates = {2: lambda e: e.update_prompt("a dog in space"),
               4: lambda e: e.update_t_index_list([10, 20, 30, 40]),
               6: lambda e: e.update_guidance(1.8, 0.6)}
    for i, f in enumerate(frames):
        if i in updates:
            updates[i](graph)
            updates[i](eager)
        got, want, without = graph(f), eager(f), still(f)
        np.testing.assert_array_equal(got, want)
        if i in updates:
            assert not np.array_equal(got, without), f"update before frame {i} did not show"
            still.state = chip_smoke.session_row(eager.state, None)


def test_replay_from_a_fresh_thread(cuda, turbo_pipe):
    """A thread that never touched CUDA replays the captured step: the same
    frame as the main thread's replay from the same state."""
    import threading

    eng = turbo_pipe.engine
    frame = chip_smoke._frames(np, 1, seed=6)[0]
    here = eng(frame)
    got = []
    worker = threading.Thread(target=lambda: got.append(eng(frame)))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and len(got) == 1
    np.testing.assert_array_equal(got[0], here)


def test_a_captured_step_keeps_its_source_graph(cuda):
    """A captured graph keeps the graph it was instantiated from as long as
    it lives (ROADMAP §C.16): without it, a graph's first launch in a
    profiler window faulted inside CUPTI after much graph churn."""
    from ai_rtc_agent_tpu_torch.aot.cache import CapturedStep

    x = torch.arange(8.0, device=cuda)
    step = CapturedStep("k", lambda b: b["x"] * 2, {"x": x}, graph=True).capture()
    assert step._cuda_graph.raw_cuda_graph() != 0  # raises unless the source graph is kept
    assert torch.equal(step.run(), x * 2)


def test_capture_while_another_thread_stages_frames(cuda):
    """A bucket captured while another thread keeps staging frames from
    pinned memory (thread-local capture rules): the capture succeeds and
    its replay equals the eager step."""
    import threading

    from ai_rtc_agent_tpu_torch.parallel.multipeer import BucketStep, stage_rows
    from ai_rtc_agent_tpu_torch.stream.engine import stack_states
    from ai_rtc_agent_tpu_torch.tree import tree_map

    eng = _tiny_ring(cuda, False)
    states = stack_states([eng.build_state(f"p{i}", seed=i) for i in range(4)])
    twin = tree_map(lambda a: a.clone(), states)
    stop, staged = threading.Event(), []

    def stage():
        frame = np.zeros((1, 64, 64, 3), np.uint8)
        while not stop.is_set():  # as a submitter stages: pinned, non-blocking
            staged.append(stage_rows(frame, cuda).shape[0])

    worker = threading.Thread(target=stage)
    worker.start()
    try:
        graph = BucketStep(eng.models, eng.cfg, cuda, graphs=True)
        graph.warm(eng.params, states, 4)  # the capture, on this thread
    finally:
        stop.set()
        worker.join(timeout=60)
    assert staged and not worker.is_alive()
    eager = BucketStep(eng.models, eng.cfg, cuda, graphs=False)
    frames = np.stack(chip_smoke._frames(np, 3, seed=7, size=64))
    got = graph(eng.params, states, frames, [2, 0, 1], 4).cpu().numpy()
    want = eager(eng.params, twin, frames, [2, 0, 1], 4).cpu().numpy()
    np.testing.assert_array_equal(got[:3], want[:3])


def test_padded_bucket_leaves_the_padded_slot_untouched(cuda):
    """The bucket of 4 captured once (its capture steps write no slot), then
    replayed with a slot vector naming 4 distinct slots and a count of 3
    real sessions in device memory: the 4th slot's ring and stock keep
    their bits while the real slots' move; then a padded layout."""
    from ai_rtc_agent_tpu_torch.parallel.multipeer import BucketStep
    from ai_rtc_agent_tpu_torch.stream.engine import stack_states
    from ai_rtc_agent_tpu_torch.tree import tree_map

    eng = _tiny_ring(cuda, False)
    states = stack_states([eng.build_state(f"p{i}", seed=i) for i in range(5)])
    start = tree_map(lambda a: a.clone(), states)
    bucket = BucketStep(eng.models, eng.cfg, cuda, graphs=True)
    step = bucket.step_for(eng.params, states, 4)
    assert step.captured
    for key in ("x_buf", "stock"):  # the capture's warm-up steps wrote nothing
        assert torch.equal(states[key], start[key])
    step.inputs["frames"].copy_(torch.from_numpy(np.stack(
        chip_smoke._frames(np, 4, seed=8, size=64))).to(cuda))
    step.inputs["slots"].copy_(torch.tensor([1, 3, 0, 2], dtype=torch.int32))
    step.inputs["k_real"].fill_(3)
    step.run()
    torch.cuda.synchronize()
    for key in ("x_buf", "stock"):
        assert torch.equal(states[key][2], start[key][2]), key
        assert torch.equal(states[key][4], start[key][4]), key
        for real in (1, 3, 0):
            assert not torch.equal(states[key][real], start[key][real]), (key, real)
    before = tree_map(lambda a: a.clone(), states)
    bucket(eng.params, states, np.stack(chip_smoke._frames(np, 3, seed=9, size=64)), [4, 2, 3], 4)
    torch.cuda.synchronize()
    for key in ("x_buf", "stock"):
        assert torch.equal(states[key][0], before[key][0]) and torch.equal(
            states[key][1], before[key][1]), key


# -- the fault domain on the card: the engine guard over the captured bucket steps -------

def _tiny_guarded(max_sessions, sessions, deadline_s=30.0, fbs=1):
    """tiny-test's 4-stage ring (f32, plain attention) through a graph
    scheduler under an engine guard that rebuilds only when asked, with
    ``sessions`` claimed and the bank refreshed after every step."""
    import os
    from dataclasses import replace

    from ai_rtc_agent_tpu_torch.models import registry
    from ai_rtc_agent_tpu_torch.resilience.engine_guard import EngineGuard
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    cfg = replace(registry.default_stream_config("tiny-test", frame_buffer_size=fbs),
                  dtype="float32", attn_impl="plain")
    bundle = registry.load_model_bundle("tiny-test", attn_impl="plain")
    os.environ["ENGINE_SNAPSHOT_EVERY_S"] = "0.000001"
    try:
        sched = BatchScheduler(bundle.stream_models, bundle.params, cfg, bundle.encode_prompt,
                               max_sessions=max_sessions, window_ms=50.0)
    finally:
        del os.environ["ENGINE_SNAPSHOT_EVERY_S"]
    guard = EngineGuard(sched, deadline_s=deadline_s, cold_deadline_s=60.0, auto_rebuild=False,
                        sleep=lambda s: None)
    sess = [sched.claim(f"s{i}", prompt=f"prompt {i}", seed=i) for i in range(sessions)]
    return sched, guard, sess


def _step_all(sess, frames):
    handles = [s.submit(f) for s, f in zip(sess, frames)]
    return [s.fetch(h) for s, h in zip(sess, handles)]


def _row(sched, slot):
    return chip_smoke.session_row(sched.states, slot)


def _rows_equal(a, b):
    return tree_equal(a, b)


def test_guard_trips_on_the_completion_deadline(cuda):
    """A sleep kernel holds the default stream for 3 s: the bucket step
    queued behind it trips the guard on its 0.5 s completion deadline (the
    riders get the quarantine error within a second, nothing waits for the
    device), and a rebuild started behind the stall re-arms the plane."""
    from ai_rtc_agent_tpu_torch.resilience.engine_guard import EngineQuarantinedError

    sched, guard, sess = _tiny_guarded(2, 2, deadline_s=0.5)
    try:
        frames = [chip_smoke._frames(np, 2, seed=i, size=64) for i in range(2)]
        _step_all(sess, [f[0] for f in frames])
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(20_000_000)
        e1.record()
        torch.cuda.synchronize()
        torch.cuda._sleep(int(3000 * 20_000_000 / e0.elapsed_time(e1)))
        t = time.perf_counter()
        with pytest.raises(EngineQuarantinedError):
            _step_all(sess, [f[1] for f in frames])
        assert time.perf_counter() - t < 1.5
        assert guard.state == "QUARANTINED" and "deadline" in guard.last_trip_reason
        assert guard.run_rebuild() and guard.state == "ARMED"
        out = _step_all(sess, [f[1] for f in frames])
        assert all(o.shape == (64, 64, 3) for o in out)
    finally:
        guard.close()
        sched.close()


def test_late_replay_after_a_rebuild_writes_nothing(cuda):
    """A wedged step (fault plan) trips the guard; after the rebuild has
    restored the plane, the wedge is released: the held step replays
    nothing, and the rebuilt rows keep their bits."""
    from ai_rtc_agent_tpu_torch.resilience import faults
    from ai_rtc_agent_tpu_torch.resilience.engine_guard import EngineQuarantinedError

    sched, guard, sess = _tiny_guarded(2, 2, deadline_s=0.5)
    try:
        frames = [chip_smoke._frames(np, 2, seed=i, size=64) for i in range(2)]
        _step_all(sess, [f[0] for f in frames])
        faults.activate(faults.FaultPlan(specs=(faults.FaultSpec(
            target="engine", kind="wedge", start=0, stop=1),)))
        sched._fault_scope = faults.scope("engine")
        held = guard._runner
        with pytest.raises(EngineQuarantinedError):
            _step_all(sess, [f[1] for f in frames])
        assert guard.run_rebuild()
        rebuilt = [_row(sched, s.slot) for s in sess]
        before = KF.launches
        faults.release_wedge()
        held._thread.join(10)
        torch.cuda.synchronize()
        assert not held._thread.is_alive() and KF.launches == before
        assert all(_rows_equal(_row(sched, s.slot), r) for s, r in zip(sess, rebuilt))
    finally:
        faults.deactivate()
        guard.close()
        sched.close()


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_bank_restore_is_bit_exact(cuda, k):
    """k sessions step (the bucket of k), the bank clones their rows; a lost
    device trips the guard; the rebuild (new buffers, a new graph pool,
    every bucket captured again) restores each row bit for bit, and the
    next steps equal those of a scheduler that never tripped."""
    from ai_rtc_agent_tpu_torch.resilience import faults

    sched, guard, sess = _tiny_guarded(8, k)
    twin, twin_guard, twin_sess = _tiny_guarded(8, k)
    try:
        frames = [chip_smoke._frames(np, 3, seed=10 + i, size=64) for i in range(k)]
        for j in range(2):
            assert all(np.array_equal(a, b) for a, b in zip(
                _step_all(sess, [f[j] for f in frames]),
                _step_all(twin_sess, [f[j] for f in frames])))
        bank = {slot: chip_smoke.session_row(row, None) for slot, row in sched._snap_rows.items()}
        assert set(bank) == {s.slot for s in sess}
        old_pool = sched._bucket.graph_cache.pool
        faults.activate(faults.FaultPlan(specs=(faults.FaultSpec(
            target="engine", kind="device_lost", start=0, stop=1),)))
        sched._fault_scope = faults.scope("engine")
        with pytest.raises(faults.DeviceLostError):
            _step_all(sess, [f[2] for f in frames])
        faults.deactivate()
        assert guard.run_rebuild() and guard.state == "ARMED"
        assert sched._bucket.graph_cache.pool != old_pool
        assert all(sched.graph_status().values())  # every bucket captured again
        assert all(_rows_equal(_row(sched, s.slot), bank[s.slot]) for s in sess)
        assert all(np.array_equal(a, b) for a, b in zip(
            _step_all(sess, [f[2] for f in frames]), _step_all(twin_sess, [f[2] for f in frames])))
    finally:
        faults.deactivate()
        for g, s in ((guard, sched), (twin_guard, twin)):
            g.close()
            s.close()


@pytest.mark.parametrize("cfg_type,k_real,slots", chip_smoke.SESSION_EPILOGUE_FBS2)
def test_epilogue_session_axis_with_a_frame_shift_of_2(cuda, cfg_type, k_real, slots):
    """--fbs 2 through the bucket step: 2 new frames per session, the renoise
    moving rows by 2 within each session's rows; against the plain version
    from the same state (real sessions' denoised rows, the whole stacked
    ring and stock)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    args, kwargs = chip_smoke.session_epilogue_call(torch, cfg_type, k_real, slots, gen, fbs=2)
    assert kwargs["noise_shift"] == 2
    seg = args[0].shape[0] // len(slots)
    a, kw = chip_smoke.fresh_epilogue_call(args, kwargs)
    got = KF.fused_stream_epilogue(*a, **kw)
    torch.cuda.synchronize()
    want = chip_smoke.plain_epilogue_call(KF, args, kwargs)
    _assert_close((got[0][: k_real * seg], *got[1:]), (want[0][: k_real * seg], *want[1:]))


def test_fbs2_sessions_through_the_scheduler_on_the_card(cuda):
    """frame_buffer_size 2 through the graph scheduler: two sessions' groups
    in one bucket step, each frame equal to a dedicated engine's (tiny-test,
    f32, plain attention: the difference is the batch), within 1 level."""
    from ai_rtc_agent_tpu_torch.stream.engine import StreamEngine

    sched, guard, sess = _tiny_guarded(2, 2, fbs=2)
    try:
        engines = []
        for s in sess:
            eng = StreamEngine(sched._template.models, sched.params, sched.cfg,
                               sched._template.encode_prompt, graphs=False)
            eng.state = _row(sched, s.slot)
            engines.append(eng)
        frames = [chip_smoke._frames(np, 4, seed=20 + i, size=64) for i in range(2)]
        for j in range(0, 4, 2):
            handles = [s.submit_batch(f[j:j + 2]) for s, f in zip(sess, frames)]
            outs = [s.fetch_batch(h) for s, h in zip(sess, handles)]
            for out, eng, f in zip(outs, engines, frames):
                want = eng(np.stack(f[j:j + 2]))
                for o, w in zip(out, want):
                    assert np.abs(o.astype(np.int16) - w).max() <= 1
    finally:
        guard.close()
        sched.close()


# -- observability on the card (obs/) ----------------------------------------------------

def test_devtel_memory_gauges_are_the_allocator_s(cuda):
    """A forced sample of the device telemetry's memory gauges reads the
    serving device's allocator: in use between two readings of
    memory_allocated() taken around it, the peak no lower, the limit the
    card's total memory, live buffers the allocator's active blocks."""
    from ai_rtc_agent_tpu_torch.obs import devtel

    plane = devtel.DevTelPlane(device=cuda)
    keep = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats(cuda)
    plane.sample_memory(force=True)
    after = torch.cuda.memory_stats(cuda)
    snap = plane.snapshot()

    def between(value, key):
        return min(before[key], after[key]) <= value <= max(before[key], after[key])

    # other threads of the process may allocate meanwhile: the sample lies
    # between the two readings around it
    assert between(snap["device_mem_bytes_in_use"], "allocated_bytes.all.current")
    assert between(snap["device_live_buffers"], "active.all.current")
    assert snap["device_mem_peak_bytes_in_use"] >= snap["device_mem_bytes_in_use"]
    assert snap["device_mem_bytes_limit"] == torch.cuda.mem_get_info(cuda)[1]
    del keep


def test_serve_time_capture_breaches_and_a_guard_rebuild_does_not(cuda):
    """With a device telemetry plane serving: a bucket evicted from the
    scheduler's graph cache is captured again at dispatch, a breach
    attributed to its key with the capture's ms; the guard's rebuild, which
    captures every bucket again, is none; the graph-cache gauges count the
    captures and the pools' bytes."""
    from ai_rtc_agent_tpu_torch.obs import devtel

    sched, guard, sess = _tiny_guarded(2, 1)
    fired = []
    plane = devtel.activate(devtel.DevTelPlane(on_breach=fired.append, device=cuda))
    try:
        plane.retrace_min_ms = 0.0  # a tiny bucket captures in well under the default
        plane.serving()
        frames = chip_smoke._frames(np, 3, seed=4, size=64)
        _step_all(sess, [frames[0]])
        assert plane.retrace_breaches == 0 and plane.aot_hits >= 1
        key = sched.bucket_keys()[(1, "full")]
        sched._bucket.graph_cache._steps.pop(key)
        _step_all(sess, [frames[1]])
        assert plane.retrace_breaches == 1 and len(fired) == 1
        assert fired[0]["context"] == key and fired[0]["phase"] == "serving"
        assert fired[0]["duration_ms"] > 0 and plane.aot_bytes > 0
        builds = plane.aot_builds
        guard._trip("test trip")
        assert guard.run_rebuild() and guard.state == "ARMED"
        assert plane.aot_builds == builds + len(sched.bucket_keys())
        assert plane.retrace_breaches == 1 and plane.phase == "serving"
        _step_all(sess, [frames[2]])
        assert plane.retrace_breaches == 1
    finally:
        devtel.deactivate(plane)
        guard.close()
        sched.close()


def test_profiler_bridge_sees_the_kernels_of_a_replayed_bucket_step(cuda, turbo_pipe, tmp_path):
    """The torch.profiler bridge, opened and closed on threads of its own,
    traces one replayed sd-turbo bucket step launched from the scheduler's
    dispatcher thread: 32 flash_attention and 1 epilogue kernels."""
    from ai_rtc_agent_tpu_torch.obs import export
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    sched = BatchScheduler.from_pipeline(turbo_pipe, max_sessions=1)
    try:
        sess = sched.claim("s0")
        frame = chip_smoke._frames(np, 1, seed=5)[0]
        sess(frame)
        torch.cuda.synchronize()
        assert export.start_profiler_bridge(str(tmp_path)) is None
        steps = sched.steps_total
        sess(frame)
        torch.cuda.synchronize()
        assert export.stop_profiler_bridge() is None
        assert sched.steps_total - steps == 1
        counts = chip_smoke.trace_kernels(export.last_trace_path)
        assert (counts["attention"], counts["epilogue"]) == (32, 1), counts
    finally:
        sched.close()


def test_debug_trace_counts_every_kernel_of_work_sent_at_once(cuda, turbo_pipe, tmp_path):
    """/debug/trace through the session layer, its window opened and closed
    right around a bucket step (no sync and no wait on the caller's side):
    the bridge syncs and settles the card at both edges of its window, so
    each of 3 traces holds every kernel of its traced sd-turbo bucket step,
    32 flash_attention and 1 epilogue.  Without the settle, 2 traces in 8 of
    work sent at once lost their first kernels
    (scripts/torch_trace_window.py)."""
    import json

    from ai_rtc_agent_tpu_torch.obs import export
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    sched = BatchScheduler.from_pipeline(turbo_pipe, max_sessions=1)
    frame = chip_smoke._frames(np, 1, seed=5)[0]

    async def traced():
        state = {}
        sessions.configure(state, pipeline=turbo_pipe, batch_scheduler=sched,
                           provider=LoopbackProvider())
        await sessions.startup(state)
        try:
            sess = sched.claim("s0")
            await asyncio.to_thread(sess, frame)
            counts = []
            for i in range(3):
                r = await sessions.debug_trace(state, {"action": "start",
                                                       "jax_profiler_dir": str(tmp_path / str(i))})
                assert r.status == 200 and json.loads(r.body)["jax_profiler"].startswith("tracing")
                steps = sched.steps_total
                await asyncio.to_thread(sess, frame)
                r = await sessions.debug_trace(state, {"action": "stop"})
                assert r.status == 200 and "jax_profiler" not in json.loads(r.body)
                assert sched.steps_total - steps == 1
                counts.append(chip_smoke.trace_kernels(export.last_trace_path))
            sess.release()
            return counts
        finally:
            await sessions.shutdown(state)

    counts = asyncio.run(traced())
    assert [(c["attention"], c["epilogue"]) for c in counts] == [(32, 1)] * 3, counts


def test_a_restored_row_is_what_the_replay_reads(cuda):
    """A session's snapshot restored into another graph scheduler, beside a
    session of its own: the restored row is written into the stacked
    buffers the captured graphs read (a rebound leaf would leave the replay
    on the slot's old rows), so its next frames equal the source's own
    continuation bit for bit, and its export is the snapshot's row."""
    src, src_guard, (a,) = _tiny_guarded(2, 1)
    dst, dst_guard, (other,) = _tiny_guarded(2, 1)
    try:
        frames = chip_smoke._frames(np, 6, seed=40, size=64)
        for f in frames[:3]:
            a(f)
        snap = src.snapshot_session("s0")
        moved = dst.restore_session(snap, "moved")
        assert moved.slot == 1 and other.slot == 0
        assert dst.snapshot_session("moved")["state_b64"] == snap["state_b64"]
        for f in frames[3:]:
            assert np.array_equal(moved(f), a(f))
    finally:
        for g, s in ((src_guard, src), (dst_guard, dst)):
            g.close()
            s.close()


def test_the_quarantine_capture_does_not_wait_behind_a_stalled_step(cuda):
    """A sleep kernel holds the default stream for 2 s after a step: the
    quarantine capture still reads the bank at once (its copy waits only for
    the bank's own event, on a side stream) and the banked row is the row
    after that step."""
    sched, guard, (a,) = _tiny_guarded(2, 1)
    try:
        frames = chip_smoke._frames(np, 2, seed=41, size=64)
        for f in frames:
            a(f)
        torch.cuda.synchronize()
        row = _row(sched, a.slot)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(50_000_000)
        e1.record()
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2000 * 50_000_000 / e0.elapsed_time(e1)))
        t = time.perf_counter()
        bank = sched.capture_quarantine_snapshots()
        took = time.perf_counter() - t
        torch.cuda.synchronize()
        assert took < 1.0, f"the capture waited {took:.2f} s behind the stall"
        assert _rows_equal(chip_smoke._to_cpu(row), chip_smoke._row_of(bank["s0"]))
    finally:
        guard.close()
        sched.close()


# -- SD1.5 (the reference's own default): the loaded and fused bundle, the modes ----------

def test_sd15_snapshot_and_lcm_loras_load_bit_for_bit(cuda, tmp_path, monkeypatch):
    """A synthetic SD1.5 snapshot from the seeded tree and two rank-64
    LCM-LoRAs (diffusers and kohya) load through load_model_bundle: every
    leaf is the seeded tree plus the f32 fusion, bit for bit, in f32 and
    cast once to bf16; proj_in stays a 1x1 conv."""
    from ai_rtc_agent_tpu_torch.models import registry

    snap = tmp_path / f"models--{chip_smoke.SD15_ID.replace('/', '--')}" / "snapshots" / "x"
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    seeded = registry.init_params("sd15", seed=3, device=cuda)
    chip_smoke.sd15_snapshot(torch, np, seeded, snap)
    lora_dict, plans = chip_smoke.lcm_lora_files(torch, np, seeded["unet"], tmp_path)
    want = chip_smoke.expected_unet(torch, np, seeded["unet"], plans)
    bundle = registry.load_model_bundle(chip_smoke.SD15_ID, attn_impl="plain",
                                        lora_dict=lora_dict)
    assert bundle.loaded_real_weights
    n = chip_smoke.hold_loaded(torch, "f32", bundle.params, seeded, want, torch.float32)
    cast = registry.cast_params(bundle.params, "bfloat16")
    assert chip_smoke.hold_loaded(torch, "bf16", cast, seeded, want, torch.bfloat16) == n
    proj = bundle.params["unet"]["mid_block"]["attention"]["proj_out"]["kernel"]
    assert proj.shape == (1280, 1280, 1, 1)


@pytest.fixture(scope="module")
def sd15_bundle():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    from ai_rtc_agent_tpu_torch.models import registry

    bundle = registry.load_model_bundle("runwayml/stable-diffusion-v1-5", seed=0)
    bundle.params = registry.cast_params(bundle.params, "bfloat16")
    return bundle


@pytest.mark.parametrize("mode", ["ring", "full", "sequential", "txt2img"])
def test_sd15_modes_launch_counts(cuda, sd15_bundle, mode):
    """The session step at k=2 eagerly and bucket 2's captured graph: the
    ring and txt2img 32 + 1 launches a step, full CFG 32 (at 2x the rows)
    and no epilogue, sequential mode 4 x 32 and no epilogue."""
    from dataclasses import replace

    from ai_rtc_agent_tpu_torch.models import registry
    from ai_rtc_agent_tpu_torch.parallel.multipeer import BucketStep
    from ai_rtc_agent_tpu_torch.stream.engine import StreamEngine, make_session_step_fn, \
        stack_states

    overrides = {"ring": {}, "full": {"cfg_type": "full"},
                 "sequential": {"use_denoising_batch": False}, "txt2img": {"mode": "txt2img"}}
    cfg = replace(registry.default_stream_config("runwayml/stable-diffusion-v1-5"),
                  **overrides[mode])
    b = sd15_bundle
    eng = StreamEngine(b.stream_models, b.params, cfg, b.encode_prompt, graphs=False)
    states = stack_states([eng.build_state("a cat", seed=s) for s in (1, 2)])
    frames = torch.from_numpy(np.stack(chip_smoke._frames(np, 2, seed=5))).to(cuda)
    slots = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    step = make_session_step_fn(b.stream_models, cfg)
    a0, e0 = KA.launches, KF.launches
    out = step(b.params, states, frames, slots, 2)
    torch.cuda.synchronize()
    assert out.shape == (2, 512, 512, 3)
    assert (KA.launches - a0, KF.launches - e0) == chip_smoke.MODE_LAUNCHES[mode]
    captured = BucketStep(b.stream_models, cfg, cuda).step_for(b.params, states, 2)
    assert captured.captured and captured.launches == chip_smoke.MODE_LAUNCHES[mode]


# -- ControlNet on the SD1.5 ring -----------------------------------------------------------

@pytest.fixture(scope="module")
def sd15_cnet_bundle():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    from ai_rtc_agent_tpu_torch.models import registry

    bundle = registry.load_model_bundle("runwayml/stable-diffusion-v1-5", seed=0,
                                        controlnet="lllyasviel/control_v11p_sd15_canny",
                                        annotator="hed")
    gen = torch.Generator(device="cuda").manual_seed(14)
    cnet = bundle.params["controlnet"]
    for zc in cnet["zero_convs"] + [cnet["mid_zero_conv"], cnet["cond_embedding"]["conv_out"]]:
        zc["kernel"] = torch.randn(zc["kernel"].shape, generator=gen, device="cuda") * 0.02
    bundle.params = registry.cast_params(bundle.params, "bfloat16")
    return bundle


@pytest.mark.parametrize("mode,annotator", [("ring", "canny"), ("ring", "hed"), ("full", "canny"),
                                            ("sequential", "identity")])
def test_controlnet_session_step_launches_and_replay(cuda, sd15_cnet_bundle, mode, annotator):
    """The ControlNet session step at k=2: the ring 46 + 1 launches a step
    (the UNet's 32 and the ControlNet's 14), full CFG 46 and no epilogue,
    sequential 4 x 46; bucket 2's captured graph launches the same and its
    replay equals the eager step bit for bit, the conditioning ring too."""
    from dataclasses import replace

    from ai_rtc_agent_tpu_torch.models import registry
    from ai_rtc_agent_tpu_torch.parallel.multipeer import BucketStep
    from ai_rtc_agent_tpu_torch.stream.engine import StreamEngine, make_session_step_fn, \
        stack_states
    from ai_rtc_agent_tpu_torch.tree import tree_map

    overrides = {"ring": {}, "full": {"cfg_type": "full"},
                 "sequential": {"use_denoising_batch": False}}[mode]
    cfg = replace(registry.default_stream_config("runwayml/stable-diffusion-v1-5",
                                                 use_controlnet=True, annotator=annotator),
                  **overrides)
    b = sd15_cnet_bundle
    eng = StreamEngine(b.stream_models, b.params, cfg, b.encode_prompt, graphs=False)
    states = stack_states([eng.build_state("a cat", seed=s) for s in (1, 2)])
    frames = torch.from_numpy(np.stack(chip_smoke._frames(np, 2, seed=5))).to(cuda)
    slots = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    want_launches = (46 * (4 if mode == "sequential" else 1), 1 if mode == "ring" else 0)
    eager_states = tree_map(lambda a: a.clone(), states)
    a0, e0 = KA.launches, KF.launches
    want = make_session_step_fn(b.stream_models, cfg)(b.params, eager_states, frames, slots, 2)
    torch.cuda.synchronize()
    assert (KA.launches - a0, KF.launches - e0) == want_launches
    step = BucketStep(b.stream_models, cfg, cuda).step_for(b.params, states, 2)
    assert step.captured and step.launches == want_launches
    step.inputs["frames"].copy_(frames)
    step.inputs["slots"].copy_(slots)
    step.inputs["k_real"].fill_(2)
    got = step.run()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(states["cnet_cond"], eager_states["cnet_cond"])
    assert float(states["cnet_cond"][:, 0].float().abs().max()) > 0


def test_a_styled_bucket_step_and_a_swap_on_the_card(cuda, turbo_pipe, tmp_path):
    """sd-turbo 512x512 bf16 with a rank-16 bank of chip_smoke phase 15's
    synthetic styles: the bucket of 2 (a styled session and an adapterless
    one) launches 32 + 1 a replay and equals the eager step bit for bit; a
    swap writes the bank in place (no graph is built, every bank leaf keeps
    its storage) and moves the styled session's frame, swapping back gives
    it again bit for bit, and the adapterless session never moves."""
    from ai_rtc_agent_tpu_torch.adapters import build_registry
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler
    from ai_rtc_agent_tpu_torch.tree import tree_map

    chip_smoke.adapter_files(np, tmp_path, turbo_pipe.bundle.unet_cfg)
    reg = build_registry(turbo_pipe.engine.params["unet"], turbo_pipe.bundle.unet_cfg,
                         str(tmp_path))
    assert reg.bank_rank == 16 and len(reg.targets) == 192
    sched = BatchScheduler.from_pipeline(turbo_pipe, max_sessions=2, window_ms=10_000.0,
                                         adapters=reg)
    try:
        key = sched.bucket_keys()[(2, "full")]
        step = sched._bucket.graph_cache.steps()[key]
        assert "--lrank-16--" in key and step.captured and step.launches == (32, 1)
        a = sched.claim("a", prompt="a red cat", seed=1, adapter="r16")
        b = sched.claim("b", prompt="a blue dog", seed=2)
        frames = chip_smoke._frames(np, 2, seed=9)
        chip_smoke.replay_equals_eager(torch, np, "styled bucket 2", sched, np.stack(frames),
                                       [a.slot, b.slot])
        ptrs = tree_map(lambda t: t.data_ptr(), sched.states["adapters"])
        built = len(sched._bucket.graph_cache.steps())

        def both():
            return chip_smoke.lockstep([a, b], [[f] for f in frames], 1)

        first = both()
        a.update_adapter("r4")
        swapped = both()
        a.update_adapter("r16")
        back = both()
        assert tree_map(lambda t: t.data_ptr(), sched.states["adapters"]) == ptrs
        assert len(sched._bucket.graph_cache.steps()) == built
        assert chip_smoke._levels(first[0][0], swapped[0][0]) > 1
        np.testing.assert_array_equal(first[0][0], back[0][0])
        np.testing.assert_array_equal(first[1][0], swapped[1][0])
        np.testing.assert_array_equal(first[1][0], back[1][0])
    finally:
        sched.close()


def test_preflight_at_tiny_test_captures_every_key(cuda):
    """The deploy preflight at tiny-test on the card: both kernel libraries
    built and loaded, every key (the engine's, --peers 2's buckets 1 and 2,
    the scheduler's buckets 1 and 2) captured on the attention kernel, each
    replay = its eager step bit for bit (the preflight raises otherwise),
    both kernels launched."""
    from ai_rtc_agent_tpu_torch.assets import build_engines
    from ai_rtc_agent_tpu_torch.ops.kernels import build as KB

    attn, epi = KA.launches, KF.launches
    keys = build_engines.main(["--model-id", "tiny-test", "--peers", "2", "--sched-buckets", "2"])
    assert len(keys) == 5 and all(isinstance(s, float) and s > 0 for s in keys.values())
    assert all("attn-kernel" in key and "dtype-bfloat16" in key for key in keys)
    assert KA.launches > attn and KF.launches > epi
    sources = [p.name for p in KB.CSRC_DIR.glob("*.cu")]
    assert len(sources) == 2
    for source in sources:
        assert KB.library_path(source).exists() and source in KB._loaded


def test_tiny_test_serves_on_the_card(cuda):
    """tiny-test on the card: its head dim 4 goes through the attention
    kernel (the wrapper pads it to 8), so its pipeline captures and steps
    (it raised at its capture before) on both kernels."""
    attn, epi = KA.launches, KF.launches
    pipe = StreamDiffusionPipeline("tiny-test")
    frame = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    out = pipe(frame)
    assert pipe.config.attn_impl == "kernel" and out.shape == (64, 64, 3)
    assert KA.launches > attn and KF.launches > epi


def test_golden_tiny_test_replays_the_cpu_capture(cuda):
    """The committed tiny-test golden, captured on the CPU in f32, replayed
    on the card in bf16 (the same weights and noise, from CPU generators),
    within the card's limits (chip_smoke.GOLDEN_CARD_LIMITS)."""
    import json
    from pathlib import Path

    from ai_rtc_agent_tpu_torch.utils import golden

    gold = json.loads((Path(__file__).parent / "golden_torch" / "tiny-test.json").read_text())
    assert golden.compare(gold, golden.capture("tiny-test"), **chip_smoke.GOLDEN_CARD_LIMITS) == []
