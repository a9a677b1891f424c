#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each prints its own lines; any failure exits non-zero):
  1. device   — needs torch.cuda; prints nvidia-smi's name and power limit;
                sets and prints the TF32 switches (both off).
  2. build    — compiles both kernels from this checkout's sources into
                build/ (nvcc for the CUDA attention, Triton for the fused
                epilogue), in parallel.
  3. kernels  — each kernel against its plain PyTorch version on the card
                at the main path's shapes and at the attention tiling's
                edges, with the tolerance stated; kernel / plain / library /
                bound times and TFLOP/s, and the attention wrapper's host
                time per call.
  4. main     — the default serving path, StreamDiffusionPipeline(
                "stabilityai/sd-turbo") at 512x512 in bf16 with random
                weights from a seed: frames through __call__ and through
                submit/fetch with 2 in flight, one update_prompt; checks the
                launch counts (32 attention + 1 epilogue per step), the
                output frames, and one step against the plain path and an
                f32 reference from the same state.
  5. a "kernels" JSON line, then the last line {"ok": true, "device": ...}.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3

# (B, Lq, Lk, H, D, launches per sd-turbo 512x512 step): 16 transformer
# blocks x (self + cross) = 32 attention launches per step
MAIN_ATTENTION = [
    (1, 4096, 4096, 5, 64, 5), (1, 4096, 77, 5, 64, 5),
    (1, 1024, 1024, 10, 64, 5), (1, 1024, 77, 10, 64, 5),
    (1, 256, 256, 20, 64, 5), (1, 256, 77, 20, 64, 5),
    (1, 64, 64, 20, 64, 1), (1, 64, 77, 20, 64, 1),
]
# checked too, off the main path: ragged Lq, the cfg-self batch of 4, SD1.5's
# head dims 40, 80 and 160
EXTRA_ATTENTION = [
    (1, 1000, 77, 10, 64), (1, 65, 300, 2, 64), (2, 1000, 1000, 8, 40), (1, 256, 77, 2, 160),
    (4, 1024, 1024, 5, 64), (4, 4096, 77, 8, 40), (4, 1024, 77, 8, 80),
]
# head dim -> query rows ragged against the 64-row tile and (D <= 64) the 192-row one
EDGE_LQ = {64: (100, 2100), 40: (100, 2100), 80: (100,), 160: (100,)}
# (D, Lq) of each kernel instantiation, for its key tile and registers
INSTANTIATIONS = [(64, 4096), (64, 1024), (80, 1024), (160, 1024)]


def edge_attention(key_tile) -> list:
    """The kernel's tiling edges at each head dim: Lk of 1, 77 and the
    instantiation's key tile (BK rows) less one, plus one and twice plus 13,
    against query rows ragged against its query tile."""
    cases = []
    for d, lqs in EDGE_LQ.items():
        for lq in lqs:
            bk = key_tile(d, lq)
            cases += [(1, lq, lk, 2, d) for lk in (1, 77, bk - 1, bk + 1, 2 * bk + 13)]
    return cases


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events,
    after a warm-up).  A sleep kernel holds the device while the host
    queues every launch, so the events time the device and not the host's
    launch rate (which alone is ~0.1 ms for a small Triton launch)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


HOST_CALLS = 1000


def host_us_per_call(torch, fn):
    """Host time per call of ``fn`` while the device sleeps, so that the
    host's own work (checks, launch) is what the clock reads.  Returns
    (us, held): ``held`` is False if the device woke before the host had
    queued every call (a full launch queue or a synchronising call: SDPA
    hits one or the other), and then the time is not the host's alone."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    woke = torch.cuda.Event()
    woke.record()
    t = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    us = (time.perf_counter() - t) * 1e6 / HOST_CALLS
    held = not woke.query()
    torch.cuda.synchronize()
    return us, held


def bound(flops: float, peak: float, nbytes: float):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(
        f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
    )
    return card


def _epilogue_inputs(torch, cfg_type: str, gen):
    """Main-path epilogue inputs: turbo coefficients / cfg none at B=1, or
    LCM 4-stage coefficients / cfg self at B=4, on [B,64,64,4] bf16."""
    from ai_rtc_agent_tpu_torch.ops import lcm as L
    from ai_rtc_agent_tpu_torch.ops import schedule as S

    sch = S.make_schedule()
    if cfg_type == "none":
        bt = S.batched_sub_timesteps((0,), 1, spacing="trailing")
    else:
        bt = S.batched_sub_timesteps((18, 26, 35, 45), 50)
    c = L.make_step_coeffs(sch, bt).to("cuda")
    if cfg_type == "none":  # the turbo step: c_skip=0, c_out=1
        c = L.StepCoeffs(c.timesteps, c.alpha, c.sigma, torch.zeros_like(c.c_skip),
                         torch.ones_like(c.c_out), c.next_alpha, c.next_sigma)
    B = len(bt)
    x, e, s, n = (
        torch.randn((B, 64, 64, 4), generator=gen, device="cuda").to(torch.bfloat16)
        for _ in range(4)
    )
    g = torch.tensor(1.2, device="cuda")
    d = torch.tensor(0.9, device="cuda")
    return (x, e, s, n, c, g, d)


def phase_build(torch):
    from ai_rtc_agent_tpu_torch.ops.kernels import attention as KA
    from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF

    def build_attention():
        t = time.perf_counter()
        KA.load()
        return time.perf_counter() - t

    def build_epilogue():
        # Triton compiles at first launch: launch each main-path variant once
        t = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        for cfg_type in ("none", "self"):
            KF.fused_stream_epilogue(*_epilogue_inputs(torch, cfg_type, gen), cfg_type=cfg_type)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        fa, fe = pool.submit(build_attention), pool.submit(build_epilogue)
        ta, te = fa.result(), fe.result()
    say(
        f"build: flash_attention (nvcc) {ta:.1f}s, fused_stream_epilogue (triton) "
        f"{te:.1f}s, wall {time.perf_counter() - t0:.1f}s"
    )
    plans = [(d, lq, KA.key_tile(d, lq), KA.registers(d, lq)) for d, lq in INSTANTIATIONS]
    say("flash_attention instantiations (D, Lq: key tile, launch registers per thread): " + ", ".join(
        f"D={d} Lq={lq}: BK {bk}, {regs} regs" for d, lq, bk, regs in plans))
    if any(regs <= 0 for *_, regs in plans):
        fail("an attention instantiation's register plan cannot run on this card")


def phase_attention(torch):
    import torch.nn.functional as F

    from ai_rtc_agent_tpu_torch.ops.kernels import attention as KA
    from ai_rtc_agent_tpu_torch.ops.kernels import tolerance

    gen = torch.Generator(device="cuda").manual_seed(1)
    totals = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms", "ops", "bytes"), 0.0)
    max_err = 0.0

    def case(b, lq, lk, h, d):
        q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for n in (lq, lk, lk))
        out = KA.flash_attention(q, k, v)
        torch.cuda.synchronize()
        e = tolerance.attention_error(out, KA.attention_plain(q, k, v))
        label = (
            f"attention B={b} Lq={lq} Lk={lk} H={h} D={d} bf16: max_abs_err {e['max_abs']:.3e} "
            f"(tol {e['tol_abs']:.3e} = 2^-6 max|ref|), rel L2 {e['rel_l2']:.3e} "
            f"(tol {e['tol_rel_l2']:.0e})"
        )
        if not e["ok"]:
            fail(f"{label}: over tolerance")
        return q, k, v, e["max_abs"], label

    for b, lq, lk, h, d, per_step in MAIN_ATTENTION:
        q, k, v, err, label = case(b, lq, lk, h, d)
        max_err = max(max_err, err)
        reps = 20 if lq * lk >= 1 << 20 else 100
        ms = time_ms(torch, lambda: KA.flash_attention(q, k, v), reps)
        plain = time_ms(torch, lambda: KA.attention_plain(q, k, v), max(5, reps // 4))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), reps)
        flops = 4.0 * b * h * lq * lk * d
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        bms, by = bound(flops, PEAK_BF16_FLOPS, nbytes)
        say(
            f"{label} | kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"plain {plain:.4f} ms, sdpa {lib:.4f} ms ({flops / lib / 1e9:.1f} TFLOP/s), "
            f"bound {bms:.4f} ms ({by}), x{per_step}/step"
        )
        totals["ms"] += per_step * ms
        totals["plain_ms"] += per_step * plain
        totals["library_ms"] += per_step * lib
        totals["ops"] += per_step * flops / PEAK_BF16_FLOPS * 1e3
        totals["bytes"] += per_step * nbytes / PEAK_BYTES * 1e3
        totals["bound_ms"] += per_step * bms
    # the last main-path shape's inputs (64 x 77, H20): the wrapper's host cost per call
    host_us, held = host_us_per_call(torch, lambda: KA.flash_attention(q, k, v))
    say(
        f"attention wrapper host time per call ({tuple(q.shape)} x {tuple(k.shape)}, {HOST_CALLS} "
        f"calls queued behind a sleeping device, host clock): {host_us:.2f} us"
        + ("" if held else " (the device woke first: not the host's time alone)")
    )
    for b, lq, lk, h, d in EXTRA_ATTENTION + edge_attention(KA.key_tile):
        say(f"{case(b, lq, lk, h, d)[-1]} ok")
    say(
        f"attention per step (32 launches): kernel {totals['ms']:.4f} ms, plain "
        f"{totals['plain_ms']:.4f} ms, sdpa {totals['library_ms']:.4f} ms, bound "
        f"{totals['bound_ms']:.4f} ms"
    )
    return {
        "max_abs_err": max_err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "operations" if totals["ops"] >= totals["bytes"] else "bytes",
        "library_ms": totals["library_ms"],
    }


def phase_epilogue(torch):
    from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF
    from ai_rtc_agent_tpu_torch.ops.kernels import tolerance

    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    max_err = max_rel = 0.0
    for cfg_type in ("none", "self"):
        args = _epilogue_inputs(torch, cfg_type, gen)
        got = KF.fused_stream_epilogue(*args, cfg_type=cfg_type)
        torch.cuda.synchronize()
        want = KF.epilogue_plain(*args, cfg_type=cfg_type)
        for name, a, b in zip(("denoised", "advanced", "stock"), got, want):
            e = tolerance.epilogue_error(a, b)
            if not e["ok"]:
                fail(f"epilogue {cfg_type} {name}: max_abs_err {e['max_abs']:.3e} over tolerance")
            max_err = max(max_err, e["max_abs"])
            max_rel = max(max_rel, e["max_rel"])
        x = args[0]
        ms = time_ms(torch, lambda: KF.fused_stream_epilogue(*args, cfg_type=cfg_type), 200)
        plain = time_ms(torch, lambda: KF.epilogue_plain(*args, cfg_type=cfg_type), 50)
        slabs = (4 + 3) if cfg_type == "self" else (3 + 2)
        nbytes = slabs * x.numel() * x.element_size()
        bms, by = bound(12.0 * x.numel(), PEAK_F32_FLOPS, nbytes)
        say(
            f"epilogue cfg={cfg_type} B={x.shape[0]} [B,64,64,4] bf16: max_abs_err "
            f"{max_err:.3e}, max rel {max_rel:.2e} (tol 1 bf16 ulp = 2^-7 rel) | "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {bms:.5f} ms ({by})"
        )
        out[cfg_type] = {"ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by}
    main = out["none"]  # the sd-turbo path: turbo coefficients, cfg none, B=1
    return {"max_abs_err": max_err, **main, "library_ms": None}


def _frames(np, n: int, seed: int = 0):
    """Structured 512x512 frames (gradients + a moving disc + mild noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:512, 0:512]
    out = []
    for i in range(n):
        cy, cx = 256 + 80 * math.sin(i / 3), 256 + 80 * math.cos(i / 3)
        disc = (np.hypot(yy - cy, xx - cx) < 96) * 180.0
        img = np.stack([xx / 511 * 255, yy / 511 * 255, disc + 40], axis=-1)
        img = img + rng.normal(0, 4, img.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def phase_main(torch, card: str):
    import numpy as np

    from ai_rtc_agent_tpu_torch.models import registry
    from ai_rtc_agent_tpu_torch.ops.kernels import attention as KA
    from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF
    from ai_rtc_agent_tpu_torch.stream.engine import StreamEngine
    from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline
    from ai_rtc_agent_tpu_torch.tree import tree_map

    t0 = time.perf_counter()
    pipe = StreamDiffusionPipeline("stabilityai/sd-turbo", seed=2)
    cfg = pipe.config
    torch.cuda.synchronize()
    say(
        f"main: pipeline built in {time.perf_counter() - t0:.1f}s | {cfg.height}x{cfg.width} "
        f"{cfg.dtype} scheduler={cfg.scheduler} cfg_type={cfg.cfg_type} "
        f"t_index_list={cfg.t_index_list} fused_epilogue={cfg.use_fused_epilogue} "
        f"attn={cfg.attn_impl}"
    )
    frames = _frames(np, 24)
    for f in frames[:3]:  # warm-up
        pipe(f)
    torch.cuda.synchronize()

    KA.launches = 0
    KF.launches = 0
    outs = []
    t = time.perf_counter()
    for f in frames[3:13]:
        outs.append(pipe(f))
    call_ms = (time.perf_counter() - t) * 1e3 / 10
    pending = []
    t = time.perf_counter()
    for f in frames[13:23]:
        pending.append(pipe.submit(f))
        if len(pending) == 2:
            outs.append(pipe.fetch(pending.pop(0)))
    while pending:
        outs.append(pipe.fetch(pending.pop(0)))
    inflight_ms = (time.perf_counter() - t) * 1e3 / 10
    pipe.update_prompt("a watercolor painting of a harbor at dawn")
    outs.append(pipe(frames[23]))
    steps = 21
    attn_launches, epi_launches = KA.launches, KF.launches

    say(f"main: launches over {steps} steps: attention {attn_launches}, epilogue {epi_launches}")
    if attn_launches != 32 * steps or epi_launches != steps:
        fail(f"expected {32 * steps} attention and {steps} epilogue launches")
    for o in outs:
        if o.shape != (512, 512, 3) or o.dtype != np.uint8:
            fail(f"bad output frame {o.shape} {o.dtype}")
    say(
        f"main: {card} | __call__ {call_ms:.2f} ms/frame ({1e3 / call_ms:.2f} fps) | "
        f"submit/fetch 2 in flight {inflight_ms:.2f} ms/frame ({1e3 / inflight_ms:.2f} fps) | "
        f"last frame mean {outs[-1].mean():.2f} std {outs[-1].std():.2f}"
    )

    # one step from the same state: kernel path vs plain bf16 path vs an f32
    # plain reference (same random weights, uncast)
    plain_cfg = replace(cfg, attn_impl="plain", use_fused_epilogue=False)
    ref_cfg = replace(plain_cfg, dtype="float32")
    bundle = pipe.bundle
    plain_bundle = registry.load_model_bundle(
        pipe.model_id, attn_impl="plain", params=bundle.params
    )
    ref_bundle = registry.load_model_bundle(pipe.model_id, attn_impl="plain", seed=0)
    ref_bundle.params = registry.cast_params(ref_bundle.params, "float32")
    served_w = bundle.params["unet"]["conv_in"]["kernel"]
    if not torch.equal(ref_bundle.params["unet"]["conv_in"]["kernel"].to(served_w.dtype), served_w):
        fail("f32 reference weights do not match the served weights")
    engines = {
        "kernel": pipe.engine,
        "plain": StreamEngine(plain_bundle.stream_models, plain_bundle.params, plain_cfg,
                              plain_bundle.encode_prompt),
        "f32": StreamEngine(ref_bundle.stream_models, ref_bundle.params, ref_cfg,
                            ref_bundle.encode_prompt),
    }
    base = tree_map(lambda a: a.clone(), pipe.engine.state)
    frame = torch.from_numpy(frames[5]).cuda()
    x_t = None
    eps, img = {}, {}
    for name, eng in engines.items():
        cast = torch.float32 if name == "f32" else torch.bfloat16
        # latents and embeddings in the engine's dtype; coefficients,
        # guidance and delta stay f32 as prepare() makes them
        st = tree_map(lambda a: a.clone(), base)
        for key in ("x_buf", "noise", "stock", "cond", "uncond"):
            st[key] = base[key].to(cast, copy=True)
        with torch.inference_mode():
            if x_t is None:  # the step's UNet input, built once in f32
                img01 = frame[None].to(bundle.params["unet"]["conv_in"]["kernel"].dtype) / 255
                z0 = bundle.stream_models.vae_encode(bundle.params, img01).float()
                c = st["coeffs"]
                x_new = c["alpha"][0] * z0 + c["sigma"][0] * base["noise"][:1].float()
                x_t = torch.cat([x_new, base["x_buf"].float()])
            ctx = st["cond"].expand(x_t.shape[0], *st["cond"].shape[1:])
            e = eng.models.unet(eng.params, x_t.to(cast), st["coeffs"]["timesteps"], ctx)
            eps[name] = e.float()
            _, out = eng._step(eng.params, st, frame)
            img[name] = out.float()
    torch.cuda.synchronize()

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    ek, ep = rel(eps["kernel"], eps["f32"]), rel(eps["plain"], eps["f32"])
    fk = (img["kernel"] - img["f32"]).abs().mean().item()
    fp = (img["plain"] - img["f32"]).abs().mean().item()
    fkp = (img["kernel"] - img["plain"]).abs()
    say(
        f"main: one step vs f32 reference — UNet eps rel L2 err: kernel {ek:.3e}, plain "
        f"{ep:.3e} | frame mean |diff| (levels): kernel {fk:.3f}, plain {fp:.3f}; "
        f"kernel vs plain mean {fkp.mean().item():.3f} max {fkp.max().item():.0f}"
    )
    # bf16 rounds differently in the two paths; the kernel path must be as
    # close to the f32 reference as the plain bf16 path is (2x slack, plus a
    # floor for when the plain path happens to land very close)
    if not all(torch.isfinite(t).all() for t in (*eps.values(), *img.values())):
        fail("non-finite UNet output or frame")
    if ek > 2 * ep + 1e-3 or ek > 0.1:
        fail(f"UNet with the attention kernel strays from the f32 reference ({ek:.3e} vs {ep:.3e})")
    if fk > 2 * fp + 0.5:
        fail(f"kernel-path frame strays from the f32 reference ({fk:.3f} vs {fp:.3f} levels)")
    return attn_launches, epi_launches


def main():
    import torch

    card = phase_device(torch)
    phase_build(torch)
    attn = phase_attention(torch)
    epi = phase_epilogue(torch)
    attn_launches, epi_launches = phase_main(torch, card)
    kernels = [
        {
            "name": "flash_attention", "route": "cuda",
            "source": "ai_rtc_agent_tpu_torch/csrc/flash_attention.cu",
            "replaces": "ai_rtc_agent_tpu/ops/pallas/attention.py:57",
            "launches": attn_launches, **attn,
        },
        {
            "name": "fused_stream_epilogue", "route": "triton",
            "source": "ai_rtc_agent_tpu_torch/ops/kernels/fused_scheduler.py",
            "replaces": "ai_rtc_agent_tpu/ops/pallas/fused_scheduler.py:81",
            "launches": epi_launches, **epi,
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
