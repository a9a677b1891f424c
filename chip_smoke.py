#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each prints its own lines; any failure exits non-zero):
  1. device   — needs torch.cuda; prints nvidia-smi's name and power limit;
                sets and prints the TF32 switches (both off).
  2. build    — compiles both CUDA kernels from this checkout's sources
                into build/, one nvcc each, in parallel.
  3. kernels  — each kernel against its plain PyTorch version on the card
                at the main path's shapes and at the attention tiling's
                edges, with the tolerance stated; kernel / plain / library /
                bound times and TFLOP/s, and each wrapper's host time per
                call.  The epilogue is called as the engine calls it (turbo,
                renoise shift, advanced rows and stock in place) for cfg
                none at B=1, self and initialize at B=4, beside the launch
                floor (an empty kernel from its library on its grid), and
                once more through a CUDA graph replay.
  4. main     — the default serving path, StreamDiffusionPipeline(
                "stabilityai/sd-turbo") at 512x512 in bf16 with random
                weights from a seed: frames through __call__ and through
                submit/fetch with 2 in flight, one update_prompt; checks the
                launch counts (32 attention + 1 epilogue per step), the
                output frames, and one step against the plain path and an
                f32 reference from the same state.
  5. serve    — the same pipeline served through the port's session layer
                (server/sessions.py, loopback provider, no HTTP): one WHIP
                publisher and one WHEP viewer, 24 frames with pts pushed and
                24 pulled with PIPELINE_DEPTH frames in flight; checks the
                frames, their pts order and the launch counts (32 attention
                + 1 epilogue per step), holds each served frame within 1
                uint8 level of the same frame through __call__ after a
                restart(), applies a /config prompt mid-session (the frames
                after it must change), closes both sessions (no peer
                connection left) and prints the served ms/frame and fps and
                FrameStats' fps and latency p50.
  6. a "kernels" JSON line (launch counts of phases 4 and 5), then the last
     line {"ok": true, "device": ...}.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import subprocess
import sys
import threading
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


def attention_query_tile(d: int, lq: int) -> int:
    """Query rows per block of the attention instantiation serving (D, Lq),
    as csrc/flash_attention.cu's header lists them: 192 for D <= 64 at
    Lq >= 2048 (Wide64), 64 otherwise."""
    return 192 if d <= 64 and lq >= 2048 else 64


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
    launch rate (tens of microseconds a call, phase 3).  If the device woke
    before the host had queued them all (a slow host, or a full launch
    queue), the reading is the host's: it is taken again with half the
    launches, down to 10."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    while True:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(reps):
            fn()
        held = not start.query()
        end.record()
        torch.cuda.synchronize()
        if held or reps <= 10:
            return start.elapsed_time(end) / reps
        reps //= 2


HOST_CALLS = 1000


def host_us_per_call(torch, fn, calls: int = HOST_CALLS):
    """Host time per call of ``fn`` over ``calls`` calls while the device
    sleeps, so that the host's own work (checks, launch) is what the clock
    reads.  Returns (us, held): ``held`` is False if the device woke before
    the host had queued every call (a full launch queue or a synchronising
    call: SDPA hits one or the other), and then the time is not the host's
    alone."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    woke = torch.cuda.Event()
    woke.record()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) * 1e6 / calls
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


def epilogue_call(torch, cfg_type: str, gen, device="cuda"):
    """The engine's epilogue call at its main-path shapes, as (args, kwargs):
    the sd-turbo step (turbo, cfg none, B=1) or the 4-stage LCM stream batch
    (cfg self/initialize, B=4), [B,64,64,4] bf16, renoise shift 1, the
    advanced rows into a [B-1,...] ring buffer and the new stock into the
    stock it reads; coefficients as the engine keeps them (f32 on the card)."""
    from ai_rtc_agent_tpu_torch.ops import lcm as L
    from ai_rtc_agent_tpu_torch.ops import schedule as S

    turbo = cfg_type == "none"
    if turbo:
        bt = S.batched_sub_timesteps((0,), 1, spacing="trailing")
    else:
        bt = S.batched_sub_timesteps((18, 26, 35, 45), 50)
    c = L.make_step_coeffs(S.make_schedule(), bt).to(device)
    B = len(bt)
    x, e, s, n = (
        torch.randn((B, 64, 64, 4), generator=gen, device=device).to(torch.bfloat16)
        for _ in range(4)
    )
    g = torch.tensor(1.2, device=device)
    d = torch.tensor(0.9, device=device)
    x_buf = torch.empty((B - 1, 64, 64, 4), dtype=torch.bfloat16, device=device)
    kwargs = dict(cfg_type=cfg_type, turbo=turbo, noise_shift=1, advanced_out=x_buf, stock_out=s)
    return (x, e, s, n, c, g, d), kwargs


def epilogue_work(args, kwargs):
    """(flops, bytes) one epilogue call needs with these inputs: each input
    read once and each output written once, counting only what the call
    reads and keeps (x and eps; the stock unless cfg none; the noise rows
    that some kept advanced row renoises with; den; the kept advanced rows;
    the new stock for cfg self; the coefficient vectors)."""
    x = args[0]
    B = x.shape[0]
    n = x.numel() // B
    cfg_type, turbo = kwargs["cfg_type"], kwargs["turbo"]
    rcfg, is_self = cfg_type != "none", cfg_type == "self"
    adv = kwargs["advanced_out"]
    adv_rows = B if adv is None else adv.shape[0]
    noise_rows = max(0, min(adv_rows, args[3].shape[0] - kwargs["noise_shift"]))
    rows = 2 * B + rcfg * B + noise_rows + B + adv_rows + is_self * B
    coeff_bytes = 4 * B * (4 if turbo else 6) + 8 * rcfg
    # per element: x0 3; R-CFG combine 3; blend 3 (not turbo); stock 3;
    # renoise 3 with a noise row, 1 without
    flops = n * (B * (3 + 3 * rcfg + 3 * (not turbo) + 3 * is_self)
                 + 3 * noise_rows + (adv_rows - noise_rows))
    return flops, rows * n * x.element_size() + coeff_bytes


def phase_build(torch):
    from ai_rtc_agent_tpu_torch.ops.kernels import attention as KA
    from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF

    def timed(load):
        t = time.perf_counter()
        load()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc each, in parallel
        fa, fe = pool.submit(timed, KA.load), pool.submit(timed, KF.load)
        ta, te = fa.result(), fe.result()
    say(
        f"build: flash_attention (nvcc) {ta:.1f}s, fused_stream_epilogue (nvcc) "
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
    from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF
    from ai_rtc_agent_tpu_torch.ops.kernels import tolerance

    gen = torch.Generator(device="cuda").manual_seed(1)
    totals = dict.fromkeys(
        ("ms", "plain_ms", "library_ms", "bound_ms", "ops", "bytes", "floor_ms"), 0.0)
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
        # launch floor: the empty kernel of the epilogue's library on as many
        # blocks as this launch's grid (query tiles x heads x batch)
        blocks = b * h * -(-lq // attention_query_tile(d, lq))
        floor = time_ms(torch, lambda: KF.launch_empty(blocks, 1), reps)
        say(
            f"{label} | kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"plain {plain:.4f} ms, sdpa {lib:.4f} ms ({flops / lib / 1e9:.1f} TFLOP/s), "
            f"bound {bms:.4f} ms ({by}), launch floor {floor:.5f} ms ({blocks} blocks), "
            f"x{per_step}/step"
        )
        totals["floor_ms"] += per_step * floor
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
        f"{totals['bound_ms']:.4f} ms, launch floor {totals['floor_ms']:.4f} ms"
    )
    return {
        "max_abs_err": max_err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "operations" if totals["ops"] >= totals["bytes"] else "bytes",
        "library_ms": totals["library_ms"],
    }


EPILOGUE_CASES = ("none", "self", "initialize")  # none: the main path (sd-turbo, B=1)


def fresh_epilogue_call(args, kwargs):
    """A copy of an epilogue call whose in-place outputs are new tensors
    holding the same values (the stock stays aliased with stock_out)."""
    stock = args[2].clone()
    kw = dict(kwargs, advanced_out=kwargs["advanced_out"].clone(), stock_out=stock)
    return (*args[:2], stock, *args[3:]), kw


def plain_epilogue_call(KF, args, kwargs):
    """The plain version of an epilogue call, from a copy of its state."""
    a, kw = fresh_epilogue_call(args, kwargs)
    return KF.epilogue_plain(*a, **kw)


def _epilogue_errors(label, got, want) -> tuple:
    """Max abs and rel error over the non-empty outputs; fails out of tolerance."""
    from ai_rtc_agent_tpu_torch.ops.kernels import tolerance

    max_abs = max_rel = 0.0
    for name, a, b in zip(("denoised", "advanced", "stock"), got, want):
        if a.shape != b.shape:
            fail(f"{label} {name}: shape {tuple(a.shape)} vs {tuple(b.shape)}")
        if not a.numel():
            continue
        e = tolerance.epilogue_error(a, b)
        if not e["ok"]:
            fail(f"{label} {name}: max_abs_err {e['max_abs']:.3e} over tolerance")
        max_abs, max_rel = max(max_abs, e["max_abs"]), max(max_rel, e["max_rel"])
    return max_abs, max_rel


def epilogue_graph_replay(torch, KF, args, kwargs):
    """The engine's epilogue call captured in a CUDA graph, replayed from the
    call's starting state, against the plain version from that state."""
    start = fresh_epilogue_call(args, kwargs)
    a, kw = fresh_epilogue_call(*start)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        KF.fused_stream_epilogue(*a, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = KF.fused_stream_epilogue(*a, **kw)
    kw["advanced_out"].copy_(start[1]["advanced_out"])
    kw["stock_out"].copy_(start[1]["stock_out"])
    graph.replay()
    torch.cuda.synchronize()
    return got, plain_epilogue_call(KF, *start)


def phase_epilogue(torch):
    from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF

    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    max_err = 0.0
    for cfg_type in EPILOGUE_CASES:
        args, kwargs = epilogue_call(torch, cfg_type, gen)
        x = args[0]
        B, n = x.shape[0], x.numel() // x.shape[0]
        label = f"epilogue cfg={cfg_type} B={B} [B,64,64,4] bf16"
        # as the engine calls it (in place) and out of place, from one state
        a, kw = fresh_epilogue_call(args, kwargs)
        got = KF.fused_stream_epilogue(*a, **kw)
        torch.cuda.synchronize()
        if got[1] is not kw["advanced_out"] or got[2] is not a[2]:
            fail(f"{label}: the in-place outputs are not the tensors passed in")
        errs = [_epilogue_errors(f"{label} in place", got, plain_epilogue_call(KF, args, kwargs))]
        oop = dict(kwargs, advanced_out=None, stock_out=None)
        got = KF.fused_stream_epilogue(*args, **oop)
        errs.append(_epilogue_errors(f"{label} out of place", got, KF.epilogue_plain(*args, **oop)))
        errs.append(_epilogue_errors(f"{label} graph replay",
                                     *epilogue_graph_replay(torch, KF, args, kwargs)))
        err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
        max_err = max(max_err, err)
        ms = time_ms(torch, lambda: KF.fused_stream_epilogue(*args, **kwargs), 500)
        floor = time_ms(torch, lambda: KF.launch_empty(B, n), 500)
        plain = time_ms(torch, lambda: KF.epilogue_plain(*args, **kwargs), 50)
        host_us, held = host_us_per_call(torch, lambda: KF.fused_stream_epilogue(*args, **kwargs))
        flops, nbytes = epilogue_work(args, kwargs)
        bms, by = bound(flops, PEAK_F32_FLOPS, nbytes)
        say(
            f"{label} (turbo={kwargs['turbo']}, noise_shift 1, advanced rows and stock in place; "
            f"in place, out of place and graph replay): max_abs_err {err:.3e}, max rel {rel:.2e} "
            f"(tol 1 bf16 ulp = 2^-7 rel) | kernel {ms:.5f} ms, launch floor {floor:.5f} ms "
            f"(empty kernel, same grid), plain {plain:.4f} ms, bound {bms:.6f} ms ({by}; "
            f"{nbytes} B, {flops} flop) | wrapper host {host_us:.2f} us per call"
            + ("" if held else " (the device woke first: not the host's time alone)")
        )
        out[cfg_type] = {"ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by}
    return {"max_abs_err": max_err, **out["none"], "library_ms": None}


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
    return pipe, attn_launches, epi_launches


SERVE_PROMPT = "an oil painting of a lighthouse in a storm"


async def open_loopback_session(state: dict):
    """One WHIP publisher and one WHEP viewer through the session layer;
    returns (publisher session id, its pc, viewer session id, viewer track)."""
    from ai_rtc_agent_tpu_torch.server import sessions
    from ai_rtc_agent_tpu_torch.server.signaling import make_loopback_offer

    pub = await sessions.publish(state, make_loopback_offer())
    view = await sessions.subscribe(state, make_loopback_offer(video=False, datachannel=False))
    if (pub.status, view.status) != (201, 201):
        fail(f"serve: publish {pub.status}, subscribe {view.status} (want 201, 201)")
    pub_id = pub.headers["Location"].rsplit("/", 1)[1]
    view_id = view.headers["Location"].rsplit("/", 1)[1]
    live = state["state"]
    return pub_id, live["whip_pcs"][pub_id], view_id, live["whep_pcs"][view_id].out_tracks[0]


async def exchange(publisher_pc, viewer, frames, first_pts: int, n_view: int, timeout_s=120.0):
    """Push ``frames`` (uint8 arrays) into the publisher's track as
    VideoFrames with pts first_pts, first_pts+1, ... while pulling
    ``n_view`` frames from the viewer; returns the frames pulled and the
    host clock (perf_counter) at each."""
    from fractions import Fraction

    from ai_rtc_agent_tpu_torch.media.frames import VideoFrame

    async def push():
        for i, f in enumerate(frames):
            vf = VideoFrame.from_ndarray(f)
            vf.pts, vf.time_base = first_pts + i, Fraction(1, 30)
            await publisher_pc.in_track.push(vf)

    pusher = asyncio.ensure_future(push())
    views, times = [], []
    try:
        for _ in range(n_view):
            views.append(await asyncio.wait_for(viewer.recv(), timeout_s))
            times.append(time.perf_counter())
        return views, times
    finally:
        await pusher


def phase_serve(torch, card: str, pipe):
    import numpy as np

    from ai_rtc_agent_tpu_torch.ops.kernels import attention as KA
    from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF
    from ai_rtc_agent_tpu_torch.server import sessions
    from ai_rtc_agent_tpu_torch.server.signaling import LoopbackProvider
    from ai_rtc_agent_tpu_torch.utils import env

    os.environ["WARMUP_FRAMES"] = "0"
    os.environ["DROP_FRAMES"] = "0"
    depth = env.pipeline_depth()
    n = 24
    frames = _frames(np, n)
    # the track returns a frame once the next `depth - 1` are in flight, so
    # the last viewed frame needs that many more pushed behind it
    pushed = frames + frames[-1:] * (depth - 1)

    def step_ms(new_thread: bool) -> float:
        """Host clock of one synchronised step, on a thread of its own (as a
        session's worker thread runs it) or on this one."""
        took = []

        def step():
            t = time.perf_counter()
            pipe(frames[0])
            torch.cuda.synchronize()
            took.append((time.perf_counter() - t) * 1e3)

        if new_thread:
            worker = threading.Thread(target=step)
            worker.start()
            worker.join()
        else:
            step()
        return took[0]

    first, second, here = step_ms(True), step_ms(True), step_ms(False)
    say(f"serve: one step on a new thread {first:.2f} ms, on a second new thread {second:.2f} ms, "
        f"on the main thread {here:.2f} ms")

    async def serve():
        state = {}
        sessions.configure(state, model_id=pipe.model_id, pipeline=pipe, provider=LoopbackProvider())
        sessions.startup(state)
        pub_id, pub_pc, view_id, viewer = await open_loopback_session(state)
        pipe.restart()
        torch.cuda.synchronize()
        KA.launches = 0
        KF.launches = 0
        t = time.perf_counter()
        served, times = await exchange(pub_pc, viewer, pushed, 0, n)
        launches = KA.launches, KF.launches
        times = [x - t for x in times]
        stats = sessions.metrics(state)

        pipe.restart()  # the same frames through __call__ from the same state
        direct = [pipe(f) for f in frames]
        await sessions.update_config(state, {"prompt": SERVE_PROMPT})
        after, _ = await exchange(pub_pc, viewer, frames[:4], len(pushed), 4)
        closed = (await sessions.close(state, "whep", view_id), await sessions.close(state, "whip", pub_id))
        left = len(state["pcs"])
        await sessions.shutdown(state)
        return served, times, launches, stats, direct, after, closed, left

    served, times, (attn, epi), stats, direct, after, closed, left = asyncio.run(serve())
    served_s = times[-1]
    steps = len(pushed)  # every pushed frame was submitted when the last view arrived
    say(f"serve: launches over {steps} steps ({n} viewed, {depth} in flight): attention {attn}, "
        f"epilogue {epi}")
    if attn != 32 * steps or epi != steps:
        fail(f"serve: expected {32 * steps} attention and {steps} epilogue launches")
    geometry = (pipe.config.height, pipe.config.width, 3)
    for i, vf in enumerate(served):
        a = vf.to_ndarray()
        if a.shape != geometry or a.dtype != np.uint8:
            fail(f"serve: bad frame {i}: {a.shape} {a.dtype}")
    pts = [vf.pts for vf in served]
    if pts != list(range(n)):
        fail(f"serve: pts out of order: {pts}")
    diff = np.stack([np.abs(vf.to_ndarray().astype(np.int16) - d) for vf, d in zip(served, direct)])
    say(f"serve: {n} served frames vs __call__ after restart(): max |diff| {diff.max()} levels, "
        f"mean {diff.mean():.4f}")
    if diff.max() > 1:
        fail("serve: a served frame is more than 1 uint8 level from its direct counterpart")
    # after the /config prompt: the frames still in flight (old prompt), then
    # frames 0, 1, ... again under the new prompt
    if [vf.pts for vf in after] != list(range(n, n + 4)):
        fail(f"serve: pts after /config out of order: {[vf.pts for vf in after]}")
    renewed = after[depth - 1:]
    change = np.mean([np.abs(a.to_ndarray().astype(np.int16) - b.to_ndarray()).mean()
                      for a, b in zip(renewed, served)])
    say(f"serve: /config prompt {SERVE_PROMPT!r} mid-session: frames 0-{len(renewed) - 1} after "
        f"it differ from before by a mean {change:.3f} levels")
    if change == 0:
        fail("serve: the prompt change did not reach the served frames")
    if closed != (True, True) or left:
        fail(f"serve: closing returned {closed}, {left} peer connection(s) left")
    steady = (times[-1] - times[0]) / (n - 1)
    say(
        f"serve: {card} | {n} frames publish -> diffuse -> view, {depth} in flight: "
        f"{served_s * 1e3 / n:.2f} ms/frame ({n / served_s:.2f} fps); first view after "
        f"{times[0] * 1e3:.2f} ms, then {steady * 1e3:.2f} ms/frame ({1 / steady:.2f} fps) | "
        f"FrameStats fps {stats['fps']:.2f}, latency p50 {stats['latency_p50_ms']:.2f} ms "
        f"(submit return -> fetch return) | sessions closed, 0 peer connections left"
    )
    return attn, epi


def main():
    import torch

    card = phase_device(torch)
    phase_build(torch)
    attn = phase_attention(torch)
    epi = phase_epilogue(torch)
    pipe, attn_launches, epi_launches = phase_main(torch, card)
    serve_attn, serve_epi = phase_serve(torch, card, pipe)
    attn_launches += serve_attn
    epi_launches += serve_epi
    kernels = [
        {
            "name": "flash_attention", "route": "cuda",
            "source": "ai_rtc_agent_tpu_torch/csrc/flash_attention.cu",
            "replaces": "ai_rtc_agent_tpu/ops/pallas/attention.py:57",
            "launches": attn_launches, **attn,
        },
        {
            "name": "fused_stream_epilogue", "route": "cuda",
            "source": "ai_rtc_agent_tpu_torch/csrc/fused_stream_epilogue.cu",
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
