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
                once more through a CUDA graph replay.  With the session
                axis (the bucket step's call over 8 stacked slots): the
                4-stage ring (cfg self) at 2, 3 (padded to 4 with a
                duplicate slot) and 8 sessions, cfg initialize at 3 and
                sd-turbo's cfg none at 8, slot-indexed in place, one graph
                replay, each beside its floor and bound; the same with a
                frame shift of 2 (--fbs 2) for the ring and sd-turbo; attention at B=8
                and B=32 on two main-path shapes.  Attention captured in a
                CUDA graph and replayed on new inputs at every main-path
                shape and at B=8 and 32.
  4. main     — the default serving path, StreamDiffusionPipeline(
                "stabilityai/sd-turbo") at 512x512 in bf16 with random
                weights from a seed, its step captured as one CUDA graph at
                build (32 attention + 1 epilogue launches per replay):
                frames through __call__ and through submit/fetch with 2 in
                flight, one update_prompt; checks the launch counts, the
                output frames, and one step against the plain path and an
                f32 reference from the same state.  Then the replays
                against an eager engine from the same state (the level
                difference, and phase 4's criterion against the f32
                reference), a device trace of one replay (32 attention and
                1 epilogue kernels), graph vs eager ms/frame interleaved
                over 8 rounds (__call__ and 2 in flight), and one step on a
                fresh thread each way.
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
  6. sessions — cross-session batching (stream/scheduler.py, parallel/
                multipeer.py).  6a: BatchScheduler.from_pipeline over phase
                4's pipeline, 8 slots, every bucket captured at startup (the
                capture time per bucket and the pool's memory printed), and
                an eager scheduler beside it; 1, 2, 3 (bucket of 4), 4 and 8
                sessions with distinct prompts and seeds on both, one
                submitting thread each, 2 frames in flight: 32 attention + 1
                epilogue launches per bucket step, each session's first
                frames held to a dedicated engine fed its state row (phase
                4's criterion against the f32 reference) and to the eager
                scheduler's; two rounds of timed runs of 24 frames per
                session at each k, graph and eager in turns (ABBA), each
                round followed by the same sessions through the shared
                pipeline in turns (the eager peak memory at k=8): ms between
                bucket steps, aggregate and per-session fps over a steady
                window (each session's outputs past its 4th, so the fill
                and the first step are out), each session's first frame;
                a prompt update on one session moves its frames only; a
                release and claim again, the 9th claim raises
                CapacityError.  6b: the 4-stage LCM cfg-self ring at
                SD2.1-base geometry (random weights), 2 sessions x 8 frames
                against dedicated engines (the renoise shift within each
                session), through graphs.  6c: MultiPeerPipeline with 2
                peers (its coordinator captures every bucket at startup):
                launches per tick, each peer's frames against a dedicated
                engine that replays its slot's ticks.
  7. faults   — the fault domain (server/sessions.py's wiring, resilience/).
                7a: --fbs 2 through a graph scheduler, 2 sessions x 8 frames
                two per bucket step (32 + 1 launches a step), each held to
                a dedicated engine at fbs 2 and the f32 reference; a prompt
                on one session moves only its frames; two WHIP publishers
                at --fbs 2 claim their own scheduler sessions.  7b: a
                slow_step under a session's supervisor on the pipeline
                path: the delayed frame is its source bit for bit, HEALTHY
                -> DEGRADED -> RECOVERING -> HEALTHY, the step held past
                restart() replays nothing, the frames after it meet phase
                4's criterion.  7c: the engine guard over a 2-slot graph
                scheduler wired as the agent wires it: (i) a wedge trips
                it (riders passthrough, /whip 503 with Retry-After, claims
                refused), the rebuild recaptures every bucket and restores
                the snapshot bank bit for bit, the released step replays
                nothing, frames resume within phase 4's criterion; (ii) a
                sleep kernel holds the default stream past a 1 s deadline:
                the guard trips on the completion deadline and re-arms
                after the stall; (iii) device_lost with a rebuild that
                keeps failing: EVACUATING -> FAILED, passthrough goes on;
                trip -> ARMED printed.  7d: a slow bucket step raises the
                admission EWMA and /whip answers 503 (the /health and
                /capacity bodies printed); ms between bucket steps at k =
                1, 4, 8 with the guard and supervision on and off (on,
                off, off, on), the snapshot bank's refresh at k=8, served
                fps with SUPERVISOR on and off in turns.
  8. native   — the native WebRTC tier (server/rtc_native.py, media/) over
                real loopback UDP into the default serving path: the C++
                runtime of native/ built with g++ into build/ (its path, build
                seconds and whether H.264 is available: without libavcodec
                the tier carries raw frames as NullCodec, which is lossless),
                WEBRTC_PROVIDER=native-rtp, a 2-slot BatchScheduler over phase
                4's pipeline (every bucket captured) with supervision,
                overload control and the engine guard wired by
                server/sessions.py as the agent wires them.  Three runs of
                the port's NativeRtpClient in this process (paced packets,
                an 8 MiB receive buffer; the agent's sockets as the JAX tier
                leaves them): one session over a JSON-envelope /offer at 30
                fps, one over /whip + /whep at 60 fps (the viewer a member
                of the publisher's broadcast group), two /offer sessions
                at 30 fps each; then a probe of one /offer session whose
                client runs in a process of its own (its packets spread over
                half of each frame interval).  Each returned frame, matched
                by pts, equals bit for bit a direct call of its scheduler
                session through the bucket step of the occupancy that
                served it; pts in order; 32 + 1 launches a bucket step; each
                run returns frames (the probe may lose them all: it measures
                the agent's default receive buffer).  Prints frames pushed
                and returned, RTP lost each way (the agent's and the
                client's reception stats), ring drops, NACKs and PLI
                requests, first view, steady served fps beside phase 5's
                loopback fps and the pace the client achieved, ms between
                bucket steps, decode/encode/glass p50 and the host plane's
                µs per frame (packetize and send from /metrics
                host_plane_sessions, recv summed over the agent's receive
                callbacks).
  9. obs      — observability on the card (obs/, wired by server/sessions.py
                as the agent wires it, the JAX defaults: SLO, device telemetry
                and the flight recorder on) over phase 4's pipeline and a
                4-slot graph BatchScheduler under the guard.  9a: a trace
                window opened through the /debug/trace body with the
                torch.profiler bridge writing into build/; one and then four
                loopback WHIP/WHEP sessions of 24 frames (the viewer's
                receipt seals each frame ``sent``, the hop a wire tier's
                sender stamps): every viewed frame's spans submit,
                batch_join, engine_step, fetch and postprocess in order and
                non-negative; the session's Chrome rendering (one track per
                stage, ph/ts/dur); the /metrics Prometheus text parsed (every
                sample's family declared, histogram buckets cumulative, +Inf
                = _count); the H2D/D2H meters against the frames submitted
                and fetched x 512*512*3; aot_cache_entries against the
                captured graphs; a forced memory sample between two readings
                of memory_allocated(); no serve-time breach; the profiler
                trace's kernels against 32 + 1 per bucket step counted; each
                stage's p50 at k=1 and k=4 beside the ms between bucket
                steps.  9b: a 2-slot scheduler whose prewarm left out bucket
                1, with the window closed and DEVTEL_RETRACE_MIN_MS at 0: a
                live session's first dispatch captures it, the only
                serve-time build, one RETRACE_BREACH on the flight recorder, the
                webhook (a local sink) and retrace_breaches_total (JSON and
                Prometheus), attributed to the bucket's key with its capture
                ms.  9c: served fps and ms between bucket steps at k=1 and
                k=4 with the planes at their defaults, all off and with the
                window open, interleaved (A B C C B A).  Phase 8 prints the
                SLO plane's breaches per stage.
 10. fleet    — sessions that move (server/sessions.py's migration, journeys
                and restart in place; fleet/ the router's core, in this
                process through fleet/transport.py's InProcessTransport) over
                phase 4's pipeline: port agents A and B, each a 4-slot graph
                BatchScheduler under the guard (every bucket captured), with
                loopback WHIP/WHEP placed through the router.  10a: B serves
                a resident session; a session placed on A streams 24 frames,
                /fleet/drain?agent=A&mode=migrate exports it, B imports it,
                the pinned re-offer adopts it as journey leg 2 and it streams
                24 frames on B: held bit for bit to a reference scheduler
                with the exported row restored at the same slot (else phase
                4's criterion, printed which); the resident row unchanged by
                the import, its frames to its dedicated references; the
                journey bundle's live fragments from both agents; the
                snapshot's bytes, export and import ms, the gap between the
                last frame from A and the first from B.  10b: A's guard
                exhausts its rebuild (device_lost, one attempt refused);
                EVACUATE_URL is the router behind a stdlib HTTP server on
                127.0.0.1, the router exports A's banked snapshot while A is
                quarantined and B imports it: the banked row equals A's rows
                at its last refresh, the frames after the move are held to
                a reference restored from the same banked snapshot; trip ->
                evacuation request -> first frame on B.  10c: POST
                /admin/recycle on B (2 sessions) writes the handoff
                (build/phase10-handoff.json) and shuts B down (its scheduler
                collected); a replacement app-state with RECYCLE_HANDOFF
                captures its buckets, imports the handoff before it reports
                healthy and announces AGENT_RECYCLED; the re-offers adopt,
                each export equals the handoff's row byte for byte, the
                frames after are held to 10a's reference; handoff write ms,
                start -> healthy split into captures and imports.  (The
                process spawn of a recycle is covered on the CPU by
                tests/test_torch_recycle_proc.py.)
 11. broadcast — the broadcast fan-out (server/broadcast.py, the header
                rewrite of media/rtp.py, the grouped sendmmsg of
                media/sockio.py) on the native tier: WEBRTC_PROVIDER=
                native-rtp, NullCodec, phase 4's pipeline under a 2-slot
                graph BatchScheduler with the guard, real loopback UDP; the
                viewers in a process of their own (``--broadcast-viewers``:
                two reassemble frames, the rest count and hash datagrams).
                11a: one /whip publisher at 30 fps (16 frames) and V = 1, 4
                and 16 WHEP viewers of its group, BROADCAST_MAX_VIEWERS=V:
                viewer V+1 refused with 503 and Retry-After; every viewer's
                datagrams equal but for SSRC, seq and ts; the reassembled
                frames each bit for bit its direct call through the same
                captured bucket step; at most one bucket step a frame and
                32 + 1 launches a step, whatever V; a PLI from every viewer
                twice: one GOP replay, then none inside the coalesce window,
                no engine step, no encoder IDR.  The group's µs per frame
                (encode, packetize, the rewrites, the one burst: their p50s)
                at each V; at V=4 the same beside BROADCAST_FANOUT=0's
                dedicated chain (each viewer's encode, packetize and send),
                in ABBA order.  11b: the edge pull: port agents A (the
                owner, the same scheduler) and B (no engine) behind the
                router's core in this process (fleet/transport.py's
                InProcessTransport, the media over real UDP); the publisher
                placed on A through the router, one viewer on A, two placed
                through the router on B, whose POST /broadcast/pull answers
                pulling, then exists; A's group counts one viewer for B's
                pull; 8 frames: B's viewers' payload equal to A's viewer's,
                frames bit for bit; PLI storms at B reach A at most once.
 12. sd15     — SD1.5 stream-batch LCM, the reference's own default, at
                512^2 bf16 with weights from a snapshot (phases 4-11's
                pipeline and f32 reference are dropped first).  12a: the
                port's seeded sd15 tree written as an HF snapshot under
                build/phase12-hub (HF_HUB_CACHE; unet/, text_encoder/, vae/
                in f32 through tree_to_state_dict and write_safetensors, a
                tiny tokenizer/ vocab) and two rank-64 LCM-LoRAs (diffusers
                on every attention projection, kohya on every proj_in/
                proj_out and again on attn2.to_k); load_model_bundle(
                lora_dict=...) in f32 and the served pipeline in bf16, every
                leaf the seeded tree plus the f32 fusion (cast once) bit for
                bit; load seconds and bytes.  12b: the 4-stage cfg-self ring
                through a graph BatchScheduler at k = 1, 2 and 4 sessions:
                one bucket replay = an eager bucket step bit for bit, 32 + 1
                launches a bucket step, each session held to phase 4's
                criterion, ms between bucket steps and fps, and a
                device-only trace of the served run (busy ms a bucket step,
                idle share).  12c: full CFG (32 launches at 2x the rows, no
                epilogue) and sequential mode (4 x 32, no epilogue) through
                graph schedulers at k = 1 and 2, held the same way; then
                --mode txt2img as the agent hands it to server/sessions.py
                (startup builds the pipeline from the snapshot and the
                scheduler), SAFETY_CHECKER=1: one loopback /offer, 32 + 1
                launches a step, frames equal to a dedicated engine's fed
                black frames.  12d: the random-weight checker flags nothing;
                every concept threshold below every score and a second
                /offer: every frame black; a repeated frame runs the tower
                once; its ms a frame.  12e: attention at one SD1.5 step's 32
                launches (D 40/80/160) at B = 4, 8 and 16, each against its
                plain version, with kernel, plain, SDPA and bound times.
 13. variants — the JAX agent's two speed variants through the captured
                steps, random weights at full width.  13a, w8 (QUANT_WEIGHTS=
                w8): sd-turbo's pipeline graph and the SD1.5 ring's bucket
                graphs at k = 1 and 2; the parameter bytes on the device, w8
                against bf16 (the UNet and the bundle; every kernel_q int8,
                every scale f32); each replay = its eager step bit for bit;
                4 frames from one state no further from an f32 reference
                with the same quantized weights than the dense path is from
                its own (2x + 0.5 level), the w8 vs dense distance; device
                busy ms a step and a bucket step, dense and w8 in ABBA turns.
                13b, DeepCache at N=3: sd-turbo's pipeline captures both graphs
                at build (launches a replay: 32 + 1 and 10 + 1), 12 frames
                capture at ticks 0, 3, 6, 9, replay = eager for both, PSNR/SSIM
                of N=3 against the full stream on moving_scene, busy ms of
                each graph and attention's share; the SD1.5 ring's 2-slot
                scheduler captures every (bucket, variant) at prewarm, a
                session alone, a second that joins while the first steps on,
                its first ride mid-cadence a capture, a prompt update a
                capture (the bucket steps' variants and launches counted), a
                snapshot restored on another scheduler rides a capture and
                equals a reference restored from the same snapshot bit for
                bit, busy ms of capture and cached at k = 1 and 2, fps full
                vs N=3 at k=1 (ABBA, phase 6a's steady window), PSNR/SSIM.
                13c: w8 + DeepCache through a 2-slot scheduler at k=2: both
                replays = eager, one run, the launches a step counted.
 14. controlnet — the reference's conditioned stream: the SD1.5 LCM ring
                with a ControlNet of control_v11p_sd15_canny's geometry at
                512^2 bf16 (random base weights from a seed).  14a: the
                port's seeded ControlNet, its zero convs and the cond
                embedding's conv_out filled from a seed (non-zero: zero, the
                ControlNet is an exact no-op), written as a diffusers-named
                snapshot under build/phase14-hub through controlnet_key_map,
                and a synthetic ControlNetHED.pth (HED_CHECKPOINT);
                load_model_bundle(controlnet=<dir>, annotator="hed") holds
                every leaf of both bit for bit, the served pipeline every
                ControlNet leaf cast once.  14b: the canny ring through
                BatchScheduler.from_pipeline's bucket graphs at k = 1 and 2
                beside the plain ring over the same weights: from one state
                the residuals move the frames and cnet_scale 0 is the plain
                ring within 1 level; replay = eager bit for bit; 46 attention
                + 1 epilogue launches a bucket step; phase 4's criterion
                against the f32 reference; the conditioning ring's head is
                the frame's canny map and it rotates with the latents; busy
                ms a bucket step (its kernels counted), idle share, ms
                between bucket steps and fps, ControlNet and plain in ABBA
                turns.  14c: hed (FULL_STAGES) and identity beside canny from
                one state (hed's frames differ from canny's), each
                annotator's ms on a frame and kernels a step; full CFG (46, no
                epilogue) and sequential (4 x 46) at k=1; --fbs 2 at k=2 and
                --multipeer 2, each held to dedicated engines; w8 HED params
                refused at engine build.  14d: one WHIP session through the
                session layer configured as --controlnet <dir>: its frames
                equal direct calls from the same row; its snapshot (bytes
                printed) restored on another scheduler equals a reference
                restored from it, bit for bit.  14e: attention at the
                ControlNet pass's 14 launches at B = 4 and 8, as 12e.
 15. adapters — per-session style adapters (ADAPTER_DIR) through the captured
                bucket steps, run right after phase 11 on phase 4's pipeline
                (see phase_adapters: 15a-15e).
 16. sdxl     — SDXL-Turbo at its full geometry, 1024^2 bf16, random weights
                from a seed (2.57 B UNet, ViT-L and bigG towers), run after
                phase 14 with the earlier pipelines freed, served by the
                session layer booted as --model-id stabilityai/sdxl-turbo (a
                2-slot scheduler).  16a: the pipeline's graph: replay = eager
                bit for bit, 140 + 1 launches a step, one eager UNet pass's
                140 attention launches, one step against the plain bf16 and
                the f32 engines (phase 4's criterion), ms a frame.  16b: one
                WHIP session, its frames = direct calls, its snapshot
                restored on another scheduler = the reference restored from
                it, bit for bit.  16c: k = 1 and 2 through the bucket graphs
                (replay = eager, launches, phase 4's criterion against
                dedicated engines, ms between bucket steps, fps, busy ms and
                idle share from a device-only trace), and a mid-stream
                prompt swap on one slot of k=2: its pooled embeds change in
                place, the first replay after it = an eager step, the other
                slot's frames unchanged bit for bit.  16e: attention at one
                SDXL UNet pass's 140 launches (H 10/20, D 64, Lk 77 across)
                at B = 1 and 2 against its plain version, with SDPA and the
                bound; the epilogue on [k,128,128,4] at k = 1 and 2.
 17. train    — the training path (parallel/: mesh, sharding, collectives,
                ring_attention, trainer, the train-state checkpoints) at
                world size 1: an NCCL group brought up by init_distributed on
                loopback, make_mesh() = (1,1,1), make_mesh(tp=2) refused
                with the JAX text, one all_reduce on the world.  17a:
                ShardedTrainer over sd-turbo's UNet (SD2.1 geometry, 866 M
                parameters, random from a seed, f32, attn_impl="plain"),
                batch 2 of [64,64,4] latents and [77,1024] context with one
                fixed (t, noise), 5 steps on that batch: losses finite and
                falling, every to_q/to_k/to_v kernel with a finite non-zero
                gradient after the first backward; ms a step (median of
                steps 2-5), peak memory, the train state's bytes, the TF32
                switches.  17b: neither kernel launched by training; a bf16
                q requiring grad refused by flash_attention.  17c: one tiny
                trainer step on the card = the same step on the CPU (loss
                rtol 1e-5, every parameter atol 5e-5 at lr 1e-3).  17d: a
                tiny checkpoint round trip on the card: restored bit for
                bit, the next step's loss within 5e-6.  The group is
                destroyed at the end of the phase, whatever happens.
 18. mesh     — the serving mesh (MESH_SHAPE, BATCHSCHED_DP, --tp/--sp,
                ATTN_IMPL; parallel/serving.py) on one card, on phase 4's
                pipeline, run right after phase 15, the whole phase in an
                NCCL world of 1 (brought up as phase 17 does), 18b's device
                traces included: there, before the captured graphs kept
                their source graphs, a profiler window faulted inside CUPTI
                (ROADMAP §C.16, repaired; scripts/smoke_loop.py reproduces
                the order).  18a: MESH_SHAPE=1,1,1, --tp 1
                --sp 1 and BATCHSCHED_DP=1 build no mesh, and their 2-slot
                scheduler's keys and frames equal a scheduler's built with
                no knob, bit for bit.  18b: a dp=2 scheduler with both shards
                on cuda:0: two sessions land on shards 0 and 1, each shard's
                replay = its eager step bit for bit, each session's frames
                meet phase 4's criterion against the dp=1 scheduler's (the
                f32 reference from the same rows), 2 x (32 + 1) kernels a
                bucket step in a settled device trace, busy ms a bucket step
                beside the dp=1 scheduler's (a check of the mechanism on one
                card, not a scale-out), no capture through a leave, a join
                and a prompt swap.  18c: ATTN_IMPL=ring with no sp group
                launches the attention kernel 32 times a step and its frame
                equals the default engine's bit for bit.  18d:
                MESH_SHAPE=1,1,1 builds no mesh; BATCHSCHED_DP=2 (default devices), --tp 2 and w8
                params on a tp mesh are refused with the JAX texts.
 19. preflight — the port's deploy CLIs (assets/, utils/golden.py), run last.
                19a: assets.build_engines.main(["--model-id",
                "stabilityai/sd-turbo", "--peers", "2", "--sched-buckets",
                "2"]): both kernel libraries built, every key (the engine's,
                --multipeer 2's buckets, the scheduler's buckets 1 and 2)
                captured and its replay = its eager step bit for bit, each
                printed with its capture seconds, then its bundle and graphs
                freed.  19b: utils.golden.capture("tiny-test") in bf16
                against the committed CPU f32 golden
                (tests/golden_torch/tiny-test.json): compare() empty, the
                thumbnail correlation and the largest stat gap.  19c:
                capture("stabilityai/sd-turbo") with no snapshot raises the
                no-weights error, timed.  19d: scripts/torch_golden_capture.py
                on a bogus id prints one ok:false line and exits non-zero.
 20. a "kernels" JSON line (launch counts of phases 4 to 16, 18 and 19), then
     the last line {"ok": true, "device": ...}.

Imports nothing of JAX or of the JAX package.  `python3 chip_smoke.py
--native-client SPEC` is phase 8's client process and `--broadcast-viewers
SPEC` phase 11's viewers (no CUDA), each started by its phase.
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
from pathlib import Path
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
    (4, 256, 256, 8, 160), (4, 64, 64, 8, 160), (4, 4096, 4096, 8, 40),
]
# the tiny families' golden and preflight steps (phase 19): tiny-test's first
# tier at head dim 4, zero-padded to 8 by the wrapper, and its D=8 tier
TINY_ATTENTION = [(4, 256, 256, 2, 4), (4, 256, 16, 2, 4), (4, 64, 64, 2, 8), (4, 64, 16, 2, 8)]
# the bucket step's batches: k sessions x B rows (sd-turbo: 1 row, up to 8
# sessions; the 4-stage LCM ring: 4 rows, 8 at 2 sessions, 32 at 8), at two
# main-path shapes (self 4096^2 H5, cross 1024x77 H10)
SESSION_ATTENTION = [(b, lq, lk, h, 64) for b in (8, 32)
                     for lq, lk, h in ((4096, 4096, 5), (1024, 77, 10))]
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
    """Print the failure on both streams (a caller may keep only one) and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
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
    """Phase 1: the card's identity from the port's ``utils/hwfp.fingerprint``
    (fails without a card); the TF32 switches off.  -> the nvidia-smi line
    (name, power limit)."""
    from ai_rtc_agent_tpu_torch.utils import hwfp

    fp = hwfp.fingerprint()
    if fp["backend"] != "cuda":
        fail(f"this script needs an NVIDIA card: {fp.get('error')}")
    card = fp["card"]
    say(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(
        f"device: {fp['device_kind']} x{fp['device_count']} "
        f"torch {fp['torch']} cuda {fp['cuda']} | "
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
    the new stock for cfg self; the coefficient vectors, guidance and delta
    of the slots it reads).  With ``slots``, only the first k_real sessions
    keep advanced rows and stock."""
    x = args[0]
    R = x.shape[0]
    n = x.numel() // R
    cfg_type, turbo = kwargs["cfg_type"], kwargs["turbo"]
    rcfg, is_self = cfg_type != "none", cfg_type == "self"
    adv, slots = kwargs["advanced_out"], kwargs.get("slots")
    if slots is None:
        k, k_real, axis = 1, 1, 0
    else:
        k, axis = slots.numel(), 1
        k_real = kwargs.get("k_real") or k
    seg = R // k
    adv_rows = seg if adv is None else adv.shape[axis]
    noise_rows = max(0, min(adv_rows, args[3].shape[axis] - kwargs["noise_shift"]))
    kept, noisy = k_real * adv_rows, k_real * noise_rows
    rows = 2 * R + rcfg * R + noisy + R + kept + is_self * k_real * seg
    coeff_bytes = 4 * k * seg * (4 if turbo else 6) + 8 * rcfg * k
    # per element: x0 3; R-CFG combine 3; blend 3 (not turbo); stock 3;
    # renoise 3 with a noise row, 1 without
    flops = n * (R * (3 + 3 * rcfg + 3 * (not turbo) + 3 * is_self) + 3 * noisy + (kept - noisy))
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

    def case(b, lq, lk, h, d, replay=False):
        q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for n in (lq, lk, lk))
        out = KA.flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = KA.attention_plain(q, k, v)
        e = tolerance.attention_error(out, want)
        label = (
            f"attention B={b} Lq={lq} Lk={lk} H={h} D={d} bf16: max_abs_err {e['max_abs']:.3e} "
            f"(tol {e['tol_abs']:.3e} = 2^-6 max|ref|), rel L2 {e['rel_l2']:.3e} "
            f"(tol {e['tol_rel_l2']:.0e})"
        )
        if not e["ok"]:
            fail(f"{label}: over tolerance")
        if replay:  # the launch captured in a CUDA graph, replayed on new inputs
            r = attention_graph_replay(torch, KA, q, k, v, gen)
            label += (f"; graph replay max_abs_err {r['max_abs']:.3e}, rel L2 "
                      f"{r['rel_l2']:.3e}")
            if not r["ok"]:
                fail(f"{label}: the graph replay is over tolerance")
        return q, k, v, e["max_abs"], label

    for b, lq, lk, h, d, per_step in MAIN_ATTENTION:
        q, k, v, err, label = case(b, lq, lk, h, d, replay=True)
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
    for b, lq, lk, h, d in TINY_ATTENTION:  # D=4 timed with the wrapper's padding copies
        q, k, v, err, label = case(b, lq, lk, h, d, replay=True)
        ms = time_ms(torch, lambda: KA.flash_attention(q, k, v), 50)
        plain = time_ms(torch, lambda: KA.attention_plain(q, k, v), 50)
        say(f"{label} | kernel {ms:.4f} ms, plain {plain:.4f} ms")
    for b, lq, lk, h, d in SESSION_ATTENTION:  # the bucket step's batches
        q, k, v, err, label = case(b, lq, lk, h, d, replay=True)
        ms = time_ms(torch, lambda: KA.flash_attention(q, k, v), 10)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), 10)
        flops = 4.0 * b * h * lq * lk * d
        bms, by = bound(flops, PEAK_BF16_FLOPS, 2.0 * (2 * q.numel() + k.numel() + v.numel()))
        say(f"{label} | kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), sdpa {lib:.4f} ms, "
            f"bound {bms:.4f} ms ({by})")
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


def attention_graph_replay(torch, KA, q, k, v, gen) -> dict:
    """The attention launch captured in a CUDA graph over q, k and v (after
    a warm-up launch: the first launch per device sets the kernel's
    attributes, which a capture must not do), then q, k and v refilled in
    place with new values and the graph replayed: the replay against the
    plain version on the new values (the TMA descriptors hold the captured
    addresses, so only in-place inputs reach a replay)."""
    from ai_rtc_agent_tpu_torch.ops.kernels import tolerance

    KA.flash_attention(q, k, v)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = KA.flash_attention(q, k, v)
    for t in (q, k, v):
        t.copy_(torch.randn(t.shape, generator=gen, device=t.device))
    graph.replay()
    torch.cuda.synchronize()
    return tolerance.attention_error(out, KA.attention_plain(q, k, v))


EPILOGUE_CASES = ("none", "self", "initialize")  # none: the main path (sd-turbo, B=1)
# The bucket step's epilogue over a stacked state of N_SLOTS sessions:
# (cfg_type, real sessions, the bucket's slots).  The 4-stage LCM ring
# (cfg self) at 2, 3 (padded to 4 with a duplicate) and 8 sessions, its
# cfg initialize at 3, and sd-turbo (cfg none, turbo, 1 row) at 8.
N_SLOTS = 8
SESSION_EPILOGUE = [
    ("self", 2, [5, 2]), ("self", 3, [6, 1, 3, 3]), ("self", 8, [7, 0, 5, 2, 4, 1, 6, 3]),
    ("initialize", 3, [2, 0, 4, 4]), ("none", 8, [3, 6, 0, 7, 1, 5, 2, 4]),
]
# the same call at frame_buffer_size 2 (--fbs 2 through the scheduler): two
# new frames per session, the renoise shift 2 within each session's rows
SESSION_EPILOGUE_FBS2 = [
    ("self", 2, [5, 2]), ("self", 3, [6, 1, 3, 3]), ("none", 2, [3, 6]), ("none", 3, [7, 0, 4, 4]),
]


def session_epilogue_call(torch, cfg_type: str, k_real: int, slots: list, gen, device="cuda",
                          fbs: int = 1, latent: int = 64):
    """The bucket step's epilogue call as (args, kwargs): k = len(slots)
    sessions of B rows (4 stages, or sd-turbo's 1 with turbo, times fbs
    frames) of [latent,latent,4] bf16 (64: 512^2 frames; SDXL's 1024^2:
    128) over a stacked state of N_SLOTS slots, each
    slot with its own coefficients (its t-indices moved by its slot
    number), guidance and delta; renoise shift fbs within each session, the
    advanced rows into the stacked ring and the new stock into the stacked
    stock it reads."""
    from ai_rtc_agent_tpu_torch.ops import lcm as L
    from ai_rtc_agent_tpu_torch.ops import schedule as S

    turbo = cfg_type == "none"
    tables = []
    for i in range(N_SLOTS):
        if turbo:
            bt = S.batched_sub_timesteps((0,), 1, fbs, spacing="trailing")
        else:
            bt = S.batched_sub_timesteps((10 + i, 20 + i, 30 + i, 40 + i), 50, fbs)
        tables.append(L.make_step_coeffs(S.make_schedule(), bt, fbs).to(device).as_dict())
    c = L.StepCoeffs(*(torch.stack([t[f] for t in tables]) for f in tables[0]))
    B = c.alpha.shape[1]
    rand = lambda *shape: torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)  # noqa: E731
    lat = (latent, latent, 4)
    x, e = rand(len(slots) * B, *lat), rand(len(slots) * B, *lat)
    stock, noise = rand(N_SLOTS, B, *lat), rand(N_SLOTS, B, *lat)
    ring = rand(N_SLOTS, B - fbs, *lat)
    g = 1.1 + 0.1 * torch.arange(N_SLOTS, device=device, dtype=torch.float32)
    d = 0.95 - 0.05 * torch.arange(N_SLOTS, device=device, dtype=torch.float32)
    kwargs = dict(cfg_type=cfg_type, turbo=turbo, noise_shift=fbs, advanced_out=ring,
                  stock_out=stock, slots=torch.tensor(slots, dtype=torch.int32, device=device),
                  k_real=k_real)
    return (x, e, stock, noise, c, g, d), kwargs


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


def _epilogue_errors(label, got, want, den_rows=None) -> tuple:
    """Max abs and rel error over the non-empty outputs (denoised: its first
    ``den_rows`` rows, those of the real sessions); fails out of tolerance."""
    from ai_rtc_agent_tpu_torch.ops.kernels import tolerance

    max_abs = max_rel = 0.0
    got = (got[0][:den_rows], *got[1:])
    want = (want[0][:den_rows], *want[1:])
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
    max_err = max(max_err, phase_session_epilogue(torch, KF))
    return {"max_abs_err": max_err, **out["none"], "library_ms": None}


def phase_session_epilogue(torch, KF) -> float:
    """The epilogue with the session axis (SESSION_EPILOGUE), as the bucket
    step calls it, against its plain version from the same state: the real
    sessions' denoised rows and the whole stacked ring and stock (idle and
    padded slots untouched); once through a CUDA graph replay; the kernel's
    time beside its launch floor and bound."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    max_err = 0.0
    cases = [c + (1,) for c in SESSION_EPILOGUE] + [c + (2,) for c in SESSION_EPILOGUE_FBS2]
    for i, (cfg_type, k_real, slots, fbs) in enumerate(cases):
        args, kwargs = session_epilogue_call(torch, cfg_type, k_real, slots, gen, fbs=fbs)
        R = args[0].shape[0]
        n, seg = args[0].numel() // R, R // len(slots)
        label = (f"epilogue cfg={cfg_type} {k_real} sessions in a bucket of {len(slots)} "
                 f"(slots {slots}) x {seg} rows [64,64,4] bf16, {N_SLOTS} stacked slots, "
                 f"frame shift {fbs}")
        a, kw = fresh_epilogue_call(args, kwargs)
        got = KF.fused_stream_epilogue(*a, **kw)
        torch.cuda.synchronize()
        if got[1] is not kw["advanced_out"] or got[2] is not a[2]:
            fail(f"{label}: the in-place outputs are not the stacked tensors passed in")
        errs = [_epilogue_errors(f"{label} in place", got, plain_epilogue_call(KF, args, kwargs),
                                 k_real * seg)]
        if i == 1 or (fbs == 2 and i == len(SESSION_EPILOGUE) + 1):  # padded buckets, through a graph
            errs.append(_epilogue_errors(f"{label} graph replay",
                                         *epilogue_graph_replay(torch, KF, args, kwargs), k_real * seg))
        err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
        max_err = max(max_err, err)
        ms = time_ms(torch, lambda: KF.fused_stream_epilogue(*args, **kwargs), 500)
        floor = time_ms(torch, lambda: KF.launch_empty(R, n), 500)
        plain = time_ms(torch, lambda: KF.epilogue_plain(*args, **kwargs), 50)
        host_us, held = host_us_per_call(torch, lambda: KF.fused_stream_epilogue(*args, **kwargs))
        flops, nbytes = epilogue_work(args, kwargs)
        bms, by = bound(flops, PEAK_F32_FLOPS, nbytes)
        say(
            f"{label}{', and graph replay' if len(errs) > 1 else ''}: max_abs_err {err:.3e}, max rel "
            f"{rel:.2e} (tol 1 bf16 ulp = 2^-7 rel) | kernel {ms:.5f} ms, launch floor {floor:.5f} ms "
            f"(empty kernel, same grid), plain {plain:.4f} ms, bound {bms:.6f} ms ({by}; {nbytes} B, "
            f"{flops} flop) | wrapper host {host_us:.2f} us per call"
            + ("" if held else " (the device woke first: not the host's time alone)")
        )
    return max_err


def _frames(np, n: int, seed: int = 0, size: int = 512):
    """Structured size x size frames (gradients + a moving disc + mild noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    c, r = size / 2, size * 80 / 512
    out = []
    for i in range(n):
        cy, cx = c + r * math.sin(i / 3), c + r * math.cos(i / 3)
        disc = (np.hypot(yy - cy, xx - cx) < size * 96 / 512) * 180.0
        img = np.stack([xx / (size - 1) * 255, yy / (size - 1) * 255, disc + 40], axis=-1)
        img = img + rng.normal(0, 4, img.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def step_vs_f32(torch, label: str, engines: dict, base: dict, frame):
    """Phase 4's criterion for one step from the same state ``base``: the
    UNet's eps and the frame of the served kernels' engine ("kernel"), the
    plain bf16 engine ("plain") and the plain f32 reference ("f32"), each
    fed ``base`` in its dtype (SDXL's addition conditioning with it).  The
    kernel path must be as close to the f32 reference as the plain bf16
    path is (2x slack, plus a floor for when the plain path happens to land
    very close).  ``frame``: uint8 [H,W,3] on the card."""
    from ai_rtc_agent_tpu_torch.stream.engine import added_cond
    from ai_rtc_agent_tpu_torch.tree import tree_map

    kernel = engines["kernel"]
    x_t = None
    eps, img = {}, {}
    for name, eng in engines.items():
        cast = torch.float32 if name == "f32" else torch.bfloat16
        # latents and embeddings in the engine's dtype; coefficients,
        # guidance, delta and time ids stay f32 as prepare() makes them
        st = tree_map(lambda a: a.clone(), base)
        for key in ("x_buf", "noise", "stock", "cond", "uncond", "added_text"):
            if key in st:
                st[key] = base[key].to(cast, copy=True)
        with torch.inference_mode():
            if x_t is None:  # the step's UNet input, built once in f32
                img01 = frame[None].to(kernel.cfg.torch_dtype) / 255
                z0 = kernel.models.vae_encode(kernel.params, img01).float()
                c = st["coeffs"]
                x_new = c["alpha"][0] * z0 + c["sigma"][0] * base["noise"][:1].float()
                x_t = torch.cat([x_new, base["x_buf"].float()])
            ctx = st["cond"].expand(x_t.shape[0], *st["cond"].shape[1:])
            added = added_cond(eng.cfg, st.get("added_time_ids"), st.get("added_text"),
                               x_t.shape[0])
            e = eng.models.unet(eng.params, x_t.to(cast), st["coeffs"]["timesteps"], ctx,
                                **({} if added is None else {"added": added}))
            eps[name] = e.float()
            _, out = eng._step(eng.params, st, frame)
            img[name] = out.float()
    _sync(torch, frame.device)

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    ek, ep = rel(eps["kernel"], eps["f32"]), rel(eps["plain"], eps["f32"])
    fk = (img["kernel"] - img["f32"]).abs().mean().item()
    fp = (img["plain"] - img["f32"]).abs().mean().item()
    fkp = (img["kernel"] - img["plain"]).abs()
    say(
        f"{label}: one step vs f32 reference — UNet eps rel L2 err: kernel {ek:.3e}, plain "
        f"{ep:.3e} | frame mean |diff| (levels): kernel {fk:.3f}, plain {fp:.3f}; "
        f"kernel vs plain mean {fkp.mean().item():.3f} max {fkp.max().item():.0f}"
    )
    if not all(torch.isfinite(t).all() for t in (*eps.values(), *img.values())):
        fail(f"{label}: non-finite UNet output or frame")
    if ek > 2 * ep + 1e-3 or ek > 0.1:
        fail(f"{label}: UNet with the attention kernel strays from the f32 reference "
             f"({ek:.3e} vs {ep:.3e})")
    if fk > 2 * fp + 0.5:
        fail(f"{label}: kernel-path frame strays from the f32 reference ({fk:.3f} vs {fp:.3f} "
             "levels)")


def phase_main(torch, card: str):
    import numpy as np

    from ai_rtc_agent_tpu_torch.aot.cache import WARMUP_STEPS
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
    step = pipe.engine.graph_cache.steps()[pipe.engine.key]
    say(
        f"main: pipeline built in {time.perf_counter() - t0:.1f}s (the step captured as one CUDA "
        f"graph in {step.capture_s:.3f}s, its {WARMUP_STEPS} eager warm-up steps on a side "
        f"stream included) | {cfg.height}x{cfg.width} "
        f"{cfg.dtype} scheduler={cfg.scheduler} cfg_type={cfg.cfg_type} "
        f"t_index_list={cfg.t_index_list} fused_epilogue={cfg.use_fused_epilogue} "
        f"attn={cfg.attn_impl} | key {pipe.engine.key}"
    )
    if not step.captured or step.launches != (32, 1):
        fail(f"main: the captured step records {step.launches} (attention, epilogue) launches "
             "per replay, want (32, 1)")
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
    step_vs_f32(torch, "main", engines, tree_map(lambda a: a.clone(), pipe.engine.state),
                torch.from_numpy(frames[5]).cuda())
    return pipe, ref_bundle, attn_launches, epi_launches


GRAPH_ROUNDS = 8  # phase 4's interleaved rounds, graph and eager in turns
GRAPH_FRAMES = 8  # frames per side per round, through __call__ and with 2 in flight
GRAPH_PARITY_FRAMES = 6
# An idle card on each side of a traced call.  The profiler keeps only the
# device records whose timestamps fall inside the window it opened on the
# host clock, and the card's timestamps can run behind it: work launched at
# once could drop its first kernels from the trace, while the wrappers
# counted every launch (scripts/torch_trace_window.py shows it).
TRACE_SETTLE_S = 0.5


def _step_profile():
    """scripts/torch_step_profile.py as a module (its kernel classes)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "scripts" / "torch_step_profile.py"
    spec = importlib.util.spec_from_file_location("torch_step_profile", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_trace(torch, fn, classes: bool = False) -> dict:
    """A device-only torch.profiler trace of one call of ``fn``: kernel
    counts {"attention", "epilogue", "kernels"}, the attention kernels' ms,
    with ``classes`` the device ms by kernel class (``by_class``, the classes
    of scripts/torch_step_profile.py), and busy ms (the union of the device intervals), the span from the
    first one's start to the last one's end and the idle share 1 -
    busy/span.  The window opens and closes TRACE_SETTLE_S away from
    ``fn``'s work, so every kernel of it lies inside."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_SETTLE_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_SETTLE_S)
    evs = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in evs
                   if ev.time_range.end > ev.time_range.start)
    if not spans:
        fail("the profiler recorded no device time")
    busy, (cur_start, cur_end) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    span = spans[-1][1] - spans[0][0]
    names = [ev.name for ev in evs if "emcpy" not in ev.name and "emset" not in ev.name]
    attention_us = sum(ev.time_range.end - ev.time_range.start for ev in evs
                       if "flash_attention_kernel" in ev.name)
    by_class: dict = {}
    classify = _step_profile().classify if classes else None
    for ev in evs if classes else ():
        label = classify(ev.name)
        by_class[label] = by_class.get(label, 0.0) + (ev.time_range.end - ev.time_range.start) / 1e3
    return {"attention": sum("flash_attention_kernel" in n for n in names),
            "by_class": by_class,
            "attention_ms": attention_us / 1e3,
            "epilogue": sum("stream_epilogue_kernel" in n for n in names),
            "kernels": len(names), "busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "idle": 1.0 - busy / span}


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else 0.5 * (xs[len(xs) // 2 - 1] + xs[len(xs) // 2])


def phase_graph_ab(torch, card: str, pipe, ref_bundle):
    """Phase 4, the captured step: its replays against an eager engine from
    the same state (the level difference, held to phase 4's criterion
    against the f32 reference), the kernels one replay launches from a
    device trace, graph vs eager ms/frame interleaved over GRAPH_ROUNDS
    rounds, and one step on a fresh thread each way."""
    import numpy as np

    from ai_rtc_agent_tpu_torch.stream.engine import install_state

    eng = pipe.engine
    b = pipe.bundle
    frames = _frames(np, GRAPH_FRAMES + GRAPH_PARITY_FRAMES, seed=7)
    start = session_row(eng.state, None)
    ded = Dedicated(torch, b.stream_models, b.params, pipe.config, b.encode_prompt, ref_bundle,
                    start, pipe.device)
    graph_outs = []
    for f in frames[:GRAPH_PARITY_FRAMES]:
        graph_outs.append(eng(f))
        ded(f)
    say(f"main: {GRAPH_PARITY_FRAMES} frames by graph replay vs the eager step from the same "
        f"state: " + hold_to_references(np, "main graph replay", graph_outs, ded))
    install_state(eng.state, start)

    trace = kernel_trace(torch, lambda: eng(frames[0]))
    say(f"main: device trace of one replay: {trace['kernels']} kernels, attention "
        f"{trace['attention']}, epilogue {trace['epilogue']}")
    if (trace["attention"], trace["epilogue"]) != (32, 1):
        fail("main: the trace of one replay must show 32 attention and 1 epilogue kernels")

    eager = ded.eng  # the served kernels, stepping eagerly
    sides = {"graph": eng, "eager": eager}
    call_ms = {name: [] for name in sides}
    flight_ms = {name: [] for name in sides}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / GRAPH_FRAMES

    def two_in_flight(e):
        pending = []
        for f in frames[GRAPH_PARITY_FRAMES:]:
            pending.append(e.submit(f))
            if len(pending) == 2:
                e.fetch(pending.pop(0))
        while pending:
            e.fetch(pending.pop(0))

    for r in range(GRAPH_ROUNDS):
        for name in (("graph", "eager") if r % 2 == 0 else ("eager", "graph")):
            e = sides[name]
            call_ms[name].append(timed(lambda: [e(f) for f in frames[GRAPH_PARITY_FRAMES:]]))
            flight_ms[name].append(timed(lambda: two_in_flight(e)))
    for name in sides:
        say(f"main: {card} | {name} ms/frame over {GRAPH_ROUNDS} interleaved rounds of "
            f"{GRAPH_FRAMES} frames: __call__ median {_median(call_ms[name]):.2f} "
            f"({[round(x, 2) for x in call_ms[name]]}), 2 in flight median "
            f"{_median(flight_ms[name]):.2f} ({[round(x, 2) for x in flight_ms[name]]})")
    wins = sum(g < e for g, e in zip(call_ms["graph"], call_ms["eager"]))
    say(f"main: graph faster than eager through __call__ in {wins} of {GRAPH_ROUNDS} rounds")

    def fresh_thread_ms(e) -> float:
        took = []

        def step():
            t = time.perf_counter()
            e(frames[0])
            torch.cuda.synchronize()
            took.append((time.perf_counter() - t) * 1e3)

        worker = threading.Thread(target=step)
        worker.start()
        worker.join()
        return took[0]

    fresh = {name: [fresh_thread_ms(e) for _ in range(2)] for name, e in sides.items()}
    say("main: one step on a fresh thread (ms; two fresh threads each): "
        + ", ".join(f"{name} {[round(x, 2) for x in v]}" for name, v in fresh.items()))
    install_state(eng.state, start)


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


async def exchange(publisher_pc, viewer, frames, first_pts: int, n_view: int, timeout_s=120.0,
                   on_view=None):
    """Push ``frames`` (uint8 arrays) into the publisher's track as
    VideoFrames with pts first_pts, first_pts+1, ... while pulling
    ``n_view`` frames from the viewer; returns the frames pulled and the
    host clock (perf_counter) at each.  ``on_view(frame)`` runs at each
    frame's arrival."""
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
            if on_view is not None:
                on_view(views[-1])
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
        await sessions.startup(state)
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
    return attn, epi, 1 / steady


# -- phase 6: sessions --------------------------------------------------------------

SESSION_PROMPTS = [
    "a watercolor fox in the snow", "a neon city at night", "an oil painting of a harbor",
    "a pencil sketch of a cat", "a mosaic of a sunflower", "a stained glass owl",
    "a comic book robot", "a charcoal drawing of a horse", "a pastel beach at dawn",
]
SCHED_OCCUPANCY = (1, 2, 3, 4, 8)  # 3 rides the bucket of 4, padded
SCHED_FRAMES = 24  # frames per session in each timed run at each occupancy
SCHED_FILL = 4  # of them, each session's first outputs: outside the steady window
SCHED_ROUNDS = 2  # timed runs per occupancy, scheduler and shared pipeline in turn
PARITY_FRAMES = 3  # each session's first frames, held to dedicated engines
RING_FRAMES = 8  # 6b: frames per session through the 4-stage LCM ring
RING_FILL = 2  # of them, each session's first outputs: outside the steady window
PEER_FRAMES = 4  # 6c: frames per peer


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches():
    from ai_rtc_agent_tpu_torch.ops.kernels import attention as KA
    from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF

    return KA.launches, KF.launches


def _reset_launches():
    from ai_rtc_agent_tpu_torch.ops.kernels import attention as KA
    from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF

    KA.launches = KF.launches = 0


def _memory(torch, cuda: bool) -> tuple:
    """(allocated, reserved, peak allocated) bytes on the card; zeros on the CPU."""
    if not cuda:
        return 0, 0, 0
    torch.cuda.synchronize()
    return (torch.cuda.memory_allocated(), torch.cuda.memory_reserved(),
            torch.cuda.max_memory_allocated())


def session_row(states, slot, dtype=None) -> dict:
    """A copy of one slot's row of a stacked state (``slot`` None: a copy of
    a single-session state), latents and embeddings cast to ``dtype`` when
    given."""
    from ai_rtc_agent_tpu_torch.tree import tree_map

    row = tree_map(lambda a: (a if slot is None else a[slot]).clone(), states)
    if dtype is not None:
        for key in ("x_buf", "noise", "stock", "cond", "uncond", "cnet_cond", "added_text"):
            if key in row:
                row[key] = row[key].to(dtype)
    return row


class Dedicated:
    """One session's references, fed its state row: a dedicated engine of the
    served kernels and dtype, stepping eagerly, and the plain f32 engine
    (the f32 reference of phase 4)."""

    def __init__(self, torch, models, params, cfg, encode_prompt, ref_bundle, row, device):
        from ai_rtc_agent_tpu_torch.stream.engine import StreamEngine

        ref_cfg = replace(cfg, attn_impl="plain", use_fused_epilogue=False, dtype="float32")
        self.eng = StreamEngine(models, params, cfg, encode_prompt, device=device, graphs=False)
        self.ref = StreamEngine(ref_bundle.stream_models, ref_bundle.params, ref_cfg,
                                ref_bundle.encode_prompt, device=device, graphs=False)
        self.eng.state = session_row(row, None)
        self.ref.state = session_row(row, None, torch.float32)
        self.outs, self.refs = [], []

    def __call__(self, frame):
        self.outs.append(self.eng(frame))
        self.refs.append(self.ref(frame))

    def update_prompt(self, prompt):
        self.eng.update_prompt(prompt)
        self.ref.update_prompt(prompt)


def hold_to_references(np, label, got, ded: Dedicated) -> str:
    """Phase 4's criterion for one session's frames: no further from the f32
    reference than the dedicated engine is, with 2x slack (+0.5 level)."""
    got = np.stack([np.asarray(g, np.float32) for g in got])
    want = np.stack([np.asarray(o, np.float32) for o in ded.outs])
    ref = np.stack([np.asarray(r, np.float32) for r in ded.refs])
    fs, fd = np.abs(got - ref).mean(), np.abs(want - ref).mean()
    vs = np.abs(got - want)
    if not np.isfinite(got).all() or got.shape != want.shape:
        fail(f"{label}: bad frames {got.shape}")
    if fs > 2 * fd + 0.5:
        fail(f"{label}: frames stray from the f32 reference ({fs:.3f} vs the dedicated engine's "
             f"{fd:.3f} levels)")
    return f"vs f32 {fs:.3f} (dedicated {fd:.3f}), vs dedicated mean {vs.mean():.3f} max {vs.max():.0f}"


class Drive:
    """One run of :func:`drive_sessions`: each session's outputs, the times
    (s from the common start) at which its fetches returned, its handles,
    and the wall time of the whole run."""

    def __init__(self, outs, stamps, handles, wall):
        self.outs, self.stamps, self.handles, self.wall = outs, stamps, handles, wall

    def first_ms(self) -> list:
        """Each session's first frame: the start to its first output."""
        return [1e3 * st[0] for st in self.stamps]

    def steady_fps(self, fill: int) -> list:
        """Each session's rate between its ``fill``-th and its last output:
        the pipeline's fill and the first step are outside the window."""
        return [(len(st) - fill) / (st[-1] - st[fill - 1]) for st in self.stamps]

    def steady_step_ms(self, fill: int) -> tuple:
        """(ms between bucket steps, steps) over the steps that carried the
        sessions' frames past their first ``fill`` (each step stamps its
        riders with one dispatch time)."""
        t = sorted({h.t_dispatch for hs in self.handles for h in hs[fill:]})
        return 1e3 * (t[-1] - t[0]) / (len(t) - 1), len(t)


def drive_sessions(torch, sessions, frames, n: int, depth: int = 2, warm: bool = False) -> Drive:
    """One thread per session, each submitting its ``n`` frames with ``depth``
    in flight (as a track does) and fetching in order, all started together.
    ``warm``: each thread steps one frame first, before the start."""
    outs = [None] * len(sessions)
    stamps = [[] for _ in sessions]
    handles = [[] for _ in sessions]
    errors = []
    t0 = [0.0]

    def start():
        t0[0] = time.perf_counter()

    gate = threading.Barrier(len(sessions) + 1, action=start)

    def run(i, sess):
        try:
            if warm:
                sess(frames[i][0])
            gate.wait()
            got, pending = [], []

            def fetch():
                got.append(sess.fetch(pending.pop(0)))
                stamps[i].append(time.perf_counter() - t0[0])

            for f in frames[i][:n]:
                pending.append(sess.submit(f))
                handles[i].append(pending[-1])
                if len(pending) == depth:
                    fetch()
            while pending:
                fetch()
            outs[i] = got
        except BaseException as e:  # noqa: BLE001 - reported on the main thread
            errors.append(e)
            gate.abort()

    threads = [threading.Thread(target=run, args=(i, s)) for i, s in enumerate(sessions)]
    for t in threads:
        t.start()
    try:
        gate.wait()
    except threading.BrokenBarrierError:
        pass
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0[0]
    if errors:
        raise errors[0]
    return Drive(outs, stamps, handles, wall)


def phase_sessions(torch, card: str, pipe, ref_bundle, ring_model="stabilityai/stable-diffusion-2-1-base",
                   occupancy=SCHED_OCCUPANCY, n=SCHED_FRAMES):
    """6a: the batch scheduler over phase 4's pipeline (8 slots); 6b: the
    4-stage LCM ring; 6c: --multipeer's pipeline with 2 peers.  -> the
    attention and epilogue launches of the scheduler and peer steps."""
    import numpy as np

    from ai_rtc_agent_tpu_torch.parallel.multipeer import CapacityError
    from ai_rtc_agent_tpu_torch.server.multipeer_serving import MultiPeerPipeline
    from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    dev = pipe.device
    b = pipe.bundle
    total = [0, 0]

    def count(before, steps, label):
        a, e = (x - y for x, y in zip(_launches(), before))
        say(f"{label}: launches over {steps} steps: attention {a}, epilogue {e}")
        if a != 32 * steps or e != steps:
            fail(f"{label}: expected {32 * steps} attention and {steps} epilogue launches")
        total[0] += a
        total[1] += e

    # -- 6a: sd-turbo sessions ---------------------------------------------------------
    # the graph scheduler (every bucket captured at startup, in one pool)
    # and an eager one over the same pipeline, run in turns at each k
    cuda = dev.type == "cuda"
    mem0 = _memory(torch, cuda)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    sched = BatchScheduler.from_pipeline(pipe, max_sessions=8)
    _sync(torch, dev)
    built = time.perf_counter() - t
    mem1 = _memory(torch, cuda)
    steps = sched._bucket.graph_cache.steps()
    captures = {k: round(steps[key].capture_s, 3) for k, key in sched.bucket_keys().items()
                if key in steps and steps[key].captured}
    say(f"sessions 6a: BatchScheduler.from_pipeline, 8 slots, buckets {sched._bucket_sizes}, "
        f"window {1e3 * sched.window_s:.1f} ms, every bucket prewarmed on the dispatcher thread "
        f"in {built:.1f}s; captured {sched.graph_status()}, capture s per bucket {captures}; "
        f"{card} | the graphs of buckets {sched._bucket_sizes} in one pool: allocated "
        f"+{(mem1[0] - mem0[0]) / 2**20:.0f} MiB, reserved +{(mem1[1] - mem0[1]) / 2**20:.0f} MiB, "
        f"peak allocated while capturing +{(mem1[2] - mem0[0]) / 2**20:.0f} MiB | keys "
        f"{sched.bucket_keys()[(1, 'full')]} (k=1) ...")
    eager = BatchScheduler.from_pipeline(pipe, max_sessions=8, graphs=False)
    sides = {"graph": sched, "eager": eager}
    size = pipe.config.height
    frames = [_frames(np, n, seed=20 + i, size=size) for i in range(8)]
    try:
        for k in occupancy:
            claims = {name: [sc.claim(f"{name}{i}", prompt=SESSION_PROMPTS[i], seed=100 + i)
                             for i in range(k)] for name, sc in sides.items()}
            sess = claims["graph"]
            rows = [session_row(sched.states, s.slot) for s in sess]
            # SCHED_ROUNDS rounds: the graph and the eager scheduler in turns
            # (ABBA), then the same k sessions through the shared pipeline in
            # turns (one engine, its submit lock, on warmed threads); they are
            # compared only within one round
            runs = {name: [] for name in sides}
            shared = []
            for r in range(SCHED_ROUNDS):
                for name in (("graph", "eager") if r % 2 == 0 else ("eager", "graph")):
                    sc = sides[name]
                    _sync(torch, dev)
                    _reset_launches()
                    steps0 = sc.steps_total
                    before = _launches()
                    if cuda and name == "eager" and k == occupancy[-1] and r == 0:
                        torch.cuda.reset_peak_memory_stats(dev)
                    runs[name].append(drive_sessions(torch, claims[name], frames, n))
                    if cuda and name == "eager" and k == occupancy[-1] and r == 0:
                        peak = torch.cuda.max_memory_allocated(dev) - torch.cuda.memory_allocated(dev)
                        say(f"sessions 6a: {card} | eager at k={k}: peak allocated "
                            f"+{peak / 2**20:.0f} MiB over what is held between steps")
                    count(before, sc.steps_total - steps0, f"sessions 6a k={k} {name} run {r + 1}")
                shared.append(drive_sessions(torch, [pipe] * k, frames, n, warm=True))
            outs = runs["graph"][0].outs
            deds = []  # each session's references (the last k's, for the prompt update)
            for i, s in enumerate(sess):  # each session's first frames, held to its references
                deds.append(Dedicated(torch, b.stream_models, b.params, pipe.config,
                                      b.encode_prompt, ref_bundle, rows[i], dev))
                for f in frames[i][:PARITY_FRAMES]:
                    deds[i](f)
                # the two schedulers batch differently (a session whose frame
                # misses a step rides the next), and another batch size runs
                # other GEMM algorithms: bucket replay vs eager at equal
                # batches is tests/test_torch_gpu.py's (bit-equal)
                vs_eager = np.abs(np.stack(outs[i]).astype(np.int16)
                                  - np.stack(runs["eager"][0].outs[i]))
                say(f"sessions 6a k={k} session {i} (slot {s.slot}): " + hold_to_references(
                    np, f"6a k={k} session {i}", outs[i][:PARITY_FRAMES], deds[i])
                    + f"; vs the eager scheduler's run over {n} frames: mean {vs_eager.mean():.3f} "
                    f"max {vs_eager.max()}")
            for r in range(SCHED_ROUNDS):
                sh_fps = shared[r].steady_fps(SCHED_FILL)
                line = []
                for name in sides:
                    run = runs[name][r]
                    fps = run.steady_fps(SCHED_FILL)
                    step_ms, nsteps = run.steady_step_ms(SCHED_FILL)
                    line.append(
                        f"{name}: {step_ms:.2f} ms between bucket steps over {nsteps} steps, "
                        f"aggregate {sum(fps):.2f} fps, per session {min(fps):.2f}-{max(fps):.2f} "
                        f"fps, whole run {run.wall:.3f} s, first frame per session (ms) "
                        f"{[round(x, 1) for x in run.first_ms()]}")
                say(
                    f"sessions 6a k={k} (bucket {sched._bucket_for(k)}) round {r + 1}: {card} | "
                    f"steady window (outputs {SCHED_FILL + 1}-{n} of each session) | "
                    + " | ".join(line) + f" | shared pipeline (graph) in turns, steady: aggregate "
                    f"{sum(sh_fps):.2f} fps, per session {min(sh_fps):.2f}-{max(sh_fps):.2f} fps"
                )
            if k != occupancy[-1]:
                for ss in claims.values():
                    for s in ss:
                        s.release()
        # a prompt update on session 0: its frame moves, and every session
        # (session 0 against its references with the new prompt, the others
        # with theirs) stays within phase 4's criterion.  Other bucket
        # layouts than the timed run's move a bf16 frame by about a level
        # (other GEMM algorithms), so the others are held to their references,
        # not to their earlier frames.
        before_outs = [o[0] for o in outs]
        sess[0].update_prompt(SESSION_PROMPTS[-1])
        deds[0].update_prompt(SESSION_PROMPTS[-1])
        after = drive_sessions(torch, sess, [f[:1] for f in frames], 1, depth=1).outs
        moved = [np.abs(after[i][0].astype(np.int16) - before_outs[i]).mean()
                 for i in range(len(sess))]
        for i, ded in enumerate(deds):
            ded.outs, ded.refs = [], []
            ded(frames[i][0])
            say(f"sessions 6a: after update_prompt on session 0, session {i} moved by a mean "
                f"{moved[i]:.3f} levels; " + hold_to_references(np, f"6a prompt, session {i}",
                                                                   after[i], ded))
        if moved[0] <= 2 * max(moved[1:]) + 0.5:
            fail("sessions 6a: a prompt update must move its own session's frames, and clearly "
                 "more than the other sessions' move")
        slot = sess[3].slot
        sess[3].release()
        again = sched.claim("again", prompt=SESSION_PROMPTS[3], seed=103)
        try:
            sched.claim("ninth")
            fail("sessions 6a: a 9th claim on 8 slots did not raise CapacityError")
        except CapacityError:
            pass
        say(f"sessions 6a: release and claim again -> slot {again.slot} (was {slot}); the 9th "
            f"claim raises CapacityError")
        if again.slot != slot:
            fail("sessions 6a: the released slot was not the one claimed again")
    finally:
        sched.close()
        eager.close()

    # -- 6b: the 4-stage LCM cfg-self ring --------------------------------------------
    t = time.perf_counter()
    ring_pipe = StreamDiffusionPipeline(ring_model, seed=2, device=dev)
    rcfg = ring_pipe.config
    sched = BatchScheduler.from_pipeline(ring_pipe, max_sessions=2)
    rb = ring_pipe.bundle
    served_w = rb.params["unet"]["conv_in"]["kernel"]
    if not torch.equal(ref_bundle.params["unet"]["conv_in"]["kernel"].to(served_w.dtype), served_w):
        fail("sessions 6b: the f32 reference weights do not match the ring model's")
    say(f"sessions 6b: {ring_model} {rcfg.height}x{rcfg.width} {rcfg.dtype} "
        f"scheduler={rcfg.scheduler} cfg_type={rcfg.cfg_type} t_index_list={rcfg.t_index_list}, "
        f"pipeline and scheduler built in {time.perf_counter() - t:.1f}s, buckets captured "
        f"{sched.graph_status()}")
    try:
        sess = [sched.claim(f"r{i}", prompt=SESSION_PROMPTS[i], seed=200 + i) for i in range(2)]
        rows = [session_row(sched.states, s.slot) for s in sess]
        ring_frames = [_frames(np, RING_FRAMES, seed=40 + i, size=size) for i in range(2)]
        _sync(torch, dev)
        _reset_launches()
        steps0, before = sched.steps_total, _launches()
        run = drive_sessions(torch, sess, ring_frames, RING_FRAMES)
        outs = run.outs
        steps = sched.steps_total - steps0
        count(before, steps, "sessions 6b")
        for i, s in enumerate(sess):
            ded = Dedicated(torch, rb.stream_models, rb.params, rcfg, rb.encode_prompt, ref_bundle,
                            rows[i], dev)
            for f in ring_frames[i]:
                ded(f)
            say(f"sessions 6b session {i} (slot {s.slot}), {RING_FRAMES} frames through the ring: "
                + hold_to_references(np, f"6b session {i}", outs[i], ded))
        step_ms, nsteps = run.steady_step_ms(RING_FILL)
        say(f"sessions 6b: {card} | 2 sessions, {steps} bucket steps, whole run "
            f"{run.wall * 1e3 / steps:.2f} ms per step; steady window (outputs {RING_FILL + 1}-"
            f"{RING_FRAMES}): {step_ms:.2f} ms between bucket steps over {nsteps} steps, aggregate "
            f"{sum(run.steady_fps(RING_FILL)):.2f} fps")
    finally:
        sched.close()
    del ring_pipe

    # -- 6c: --multipeer 2 ----------------------------------------------------------------
    mp = MultiPeerPipeline(pipe.model_id, max_peers=2, device=dev)
    ticks = []
    submit = mp.engine.submit

    def record(batch):
        ticks.append(np.array(batch, copy=True))
        return submit(batch)

    mp.engine.submit = record
    try:
        peers = [mp.claim(SESSION_PROMPTS[i]) for i in range(2)]
        rows = [session_row(mp.engine.states, p.slot) for p in peers]
        peer_frames = [_frames(np, PEER_FRAMES, seed=60 + i, size=size) for i in range(2)]
        _sync(torch, dev)
        _reset_launches()
        before = _launches()
        run = drive_sessions(torch, peers, peer_frames, PEER_FRAMES)
        outs = run.outs
        count(before, len(ticks), "sessions 6c")
        me = mp.engine
        for i, p in enumerate(peers):
            # the peer's slot steps every tick: its new frame, or its last one
            # again (that output is dropped); replay every tick, keep the new
            ded = Dedicated(torch, me.models, me.params, mp.config, me._template.encode_prompt,
                            ref_bundle, rows[i], dev)
            kept, nxt = [], 0
            for batch in ticks:
                ded(batch[p.slot])
                if nxt < PEER_FRAMES and np.array_equal(batch[p.slot], peer_frames[i][nxt]):
                    kept.append(len(ded.outs) - 1)
                    nxt += 1
            if nxt != PEER_FRAMES:
                fail(f"sessions 6c: peer {i}'s frames were not all stepped")
            ded.outs = [ded.outs[j] for j in kept]
            ded.refs = [ded.refs[j] for j in kept]
            say(f"sessions 6c peer {i} (slot {p.slot}): "
                + hold_to_references(np, f"6c peer {i}", outs[i], ded))
        say(f"sessions 6c: {card} | MultiPeerPipeline, 2 peers x {PEER_FRAMES} frames in "
            f"{len(ticks)} ticks, whole run {run.wall * 1e3 / len(ticks):.2f} ms per tick (the "
            f"coordinator captured buckets {mp.engine.graph_status()} at startup)")
    finally:
        mp.close()
    return tuple(total)


# -- phase 7: the fault domain ------------------------------------------------------------

FBS_FRAMES = 8  # 7a: frames per session at --fbs 2
SLOW_STEP_S = 1.5  # 7b: the injected slow step, against a 0.5 s step budget
STALL_S = 3.0  # 7c (ii): how long a sleep kernel holds the device, against a 1 s deadline
OVERLOAD_STEP_S = 3.0  # 7d: a slow step of one session, against a 1 s budget (EWMA alpha 0.4)
COST_OCCUPANCY = (1, 4, 8)  # 7d: ms between bucket steps, the plane on and off
COST_FRAMES = 24
SERVE_TURNS = ("on", "off", "off", "on")  # 7d: served fps, SUPERVISOR on and off (ABBA)


class _Env:
    """Set environment variables for a block and put them back after."""

    def __init__(self, **values):
        self.values, self.saved = values, {}

    def __enter__(self):
        for k, v in self.values.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = str(v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _wait_for(pred, timeout_s: float, what: str, phase: str = "faults") -> float:
    """Poll ``pred`` until it holds; -> the seconds it took (fails past the
    timeout: nothing in phases 7 and 10 may hang)."""
    t = time.perf_counter()
    while not pred():
        if time.perf_counter() - t > timeout_s:
            fail(f"{phase}: no {what} within {timeout_s:.0f} s")
        time.sleep(0.002)
    return time.perf_counter() - t


def _inject(faults, kind: str, **kw):
    """A fault plan of one ``kind`` engine fault on the next step; -> its scope."""
    faults.activate(faults.FaultPlan(
        specs=(faults.FaultSpec(target="engine", kind=kind, start=0, stop=1, **kw),), seed=7))
    return faults.scope("engine")


def capture_seconds(sched) -> dict:
    """{bucket size: seconds its capture took} for a scheduler's buckets."""
    steps = sched._bucket.graph_cache.steps()
    return {k: round(steps[key].capture_s, 3) for k, key in sched.bucket_keys().items()
            if key in steps and steps[key].captured}


def drive_groups(sessions, frames, n: int) -> list:
    """One thread per session, each stepping its ``n`` frames two at a time
    through ``submit_batch``/``fetch_batch`` (a --fbs 2 track); -> outputs."""
    outs, errors = [[] for _ in sessions], []

    def run(i, sess):
        try:
            for j in range(0, n, 2):
                outs[i] += sess.fetch_batch(sess.submit_batch(frames[i][j:j + 2]))
        except BaseException as e:  # noqa: BLE001 - reported on the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, s)) for i, s in enumerate(sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return outs


def phase_faults(torch, card: str, pipe, ref_bundle):
    """7a --fbs 2 through the scheduler; 7b supervision on the pipeline path;
    7c the engine guard over the scheduler (a wedge, a real device stall, an
    exhausted rebuild); 7d overload, and the cost of the plane.  -> the
    attention and epilogue launches of the steps it drove."""
    import numpy as np

    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    total = [0, 0]

    def count(before, steps, label):
        a, e = (x - y for x, y in zip(_launches(), before))
        say(f"{label}: launches over {steps} steps: attention {a}, epilogue {e}")
        if a != 32 * steps or e != steps:
            fail(f"{label}: expected {32 * steps} attention and {steps} epilogue launches")
        total[0] += a
        total[1] += e

    with _Env(WARMUP_FRAMES=0, DROP_FRAMES=0):
        fault_fbs(torch, card, pipe, ref_bundle, count, BatchScheduler)
        fault_supervision(torch, card, pipe, ref_bundle, count)
        with _Env(ENGINE_STEP_DEADLINE_S=1.0, ENGINE_COLD_DEADLINE_S=60.0,
                  ENGINE_REBUILD_BACKOFF_S=0.25, ENGINE_SNAPSHOT_EVERY_S=1e-6):
            asyncio.run(fault_guard(torch, card, pipe, ref_bundle, count, BatchScheduler))
        fault_cost(torch, card, pipe, count, BatchScheduler)
    return tuple(total)


def fault_fbs(torch, card, pipe, ref_bundle, count, BatchScheduler):
    """7a: sd-turbo at --fbs 2 through graphs, 2 sessions x FBS_FRAMES frames,
    each held to its own references; a prompt on one session moves only its
    frames; then two WHIP publishers at --fbs 2 through the session layer."""
    import numpy as np

    from ai_rtc_agent_tpu_torch.server import sessions as SL
    from ai_rtc_agent_tpu_torch.server.signaling import LoopbackProvider, make_loopback_offer

    eng, dev = pipe.engine, pipe.device
    size = pipe.config.height
    cfg2 = replace(pipe.config, frame_buffer_size=2)
    t = time.perf_counter()
    # a window longer than a step, so that the two sessions' groups coalesce
    sched = BatchScheduler(eng.models, eng.params, cfg2, eng.encode_prompt, model_id=pipe.model_id,
                           max_sessions=2, default_prompt=pipe.prompt, schedule=eng.schedule,
                           window_ms=50.0, device=dev)
    say(f"faults 7a: BatchScheduler at fbs 2 (frames [k,2,{size},{size},3]), buckets "
        f"{sched.graph_status()} captured in {time.perf_counter() - t:.1f}s, queue bound "
        f"{sched.queue_bound} | key {sched.bucket_keys()[(2, 'full')]}")
    try:
        sess = [sched.claim(f"f{i}", prompt=SESSION_PROMPTS[i], seed=300 + i) for i in range(2)]
        rows = [session_row(sched.states, s.slot) for s in sess]
        frames = [_frames(np, FBS_FRAMES, seed=80 + i, size=size) for i in range(2)]
        _sync(torch, dev)
        steps0, before = sched.steps_total, _launches()
        t = time.perf_counter()
        outs = drive_groups(sess, frames, FBS_FRAMES)
        wall = time.perf_counter() - t
        steps = sched.steps_total - steps0
        count(before, steps, "faults 7a fbs 2")
        hist = sched.snapshot()["batchsched_occupancy_hist"]
        if "2" not in hist:
            fail(f"faults 7a: the two sessions never shared a bucket step ({hist})")
        for i, s in enumerate(sess):
            ded = Dedicated(torch, eng.models, eng.params, cfg2, eng.encode_prompt, ref_bundle,
                            rows[i], dev)
            for j in range(0, FBS_FRAMES, 2):
                ded(np.stack(frames[i][j:j + 2]))
            ded.outs = [o for group in ded.outs for o in group]
            ded.refs = [o for group in ded.refs for o in group]
            say(f"faults 7a session {i} (slot {s.slot}), {FBS_FRAMES} frames two per step: "
                + hold_to_references(np, f"7a session {i}", outs[i], ded))
        say(f"faults 7a: {card} | 2 sessions x {FBS_FRAMES} frames in {steps} bucket steps "
            f"(occupancy {hist}), {wall * 1e3 / steps:.2f} ms per step, "
            f"{2 * FBS_FRAMES / wall:.2f} fps in all")
        # the prompt of session 0: its frames move, session 1's stay
        first = [f[:2] for f in frames]
        before_outs = drive_groups(sess, first, 2)
        sess[0].update_prompt(SESSION_PROMPTS[-1])
        after = drive_groups(sess, first, 2)
        moved = [np.mean([np.abs(a.astype(np.int16) - b).mean() for a, b in zip(after[i],
                                                                              before_outs[i])])
                 for i in range(2)]
        ded = Dedicated(torch, eng.models, eng.params, cfg2, eng.encode_prompt, ref_bundle,
                        session_row(sched.states, sess[0].slot), dev)
        ded(np.stack(first[0]))
        ded.outs, ded.refs = list(ded.outs[0]), list(ded.refs[0])
        say(f"faults 7a: update_prompt on session 0 moved its frames by a mean {moved[0]:.3f} "
            f"levels, session 1's by {moved[1]:.3f}; session 0 after it: "
            + hold_to_references(np, "7a prompt", after[0], ded))
        if moved[0] <= 2 * moved[1] + 0.5:
            fail("faults 7a: a prompt update must move its own session's frames, not the other's")
        for s in sess:
            s.release()

        async def two_publishers():
            state = {}
            SL.configure(state, model_id=pipe.model_id, pipeline=pipe, provider=LoopbackProvider(),
                         fbs=2, batch_scheduler=sched)
            await SL.startup(state)
            try:
                sids = []
                for _ in range(2):
                    r = await SL.publish(state, make_loopback_offer())
                    if r.status != 201:
                        fail(f"faults 7a: WHIP at --fbs 2 answered {r.status} {r.body}")
                    sids.append(r.headers["Location"].rsplit("/", 1)[1])
                live = state["state"]
                slots = sorted(s.slot for s in sched._sessions.values())
                keys = sorted(s.session_key for s in sched._sessions.values())
                if keys != sorted(sids) or len(set(slots)) != 2:
                    fail(f"faults 7a: two publishers did not claim two scheduler sessions "
                         f"({keys} vs {sids})")
                for j, sid in enumerate(sids):
                    for f in _frames(np, 4, seed=120 + j, size=size):
                        await live["whip_pcs"][sid].in_track.push(f)
                got = [[await asyncio.wait_for(live["whip_tracks"][sid].recv(), 60)
                        for _ in range(2)] for sid in sids]
                for g in got:
                    for a in g:
                        a = np.asarray(a)
                        if a.shape != (size, size, 3) or a.dtype != np.uint8:
                            fail(f"faults 7a: bad served frame {a.shape} {a.dtype}")
                for sid in sids:
                    await SL.close(state, "whip", sid)
                return slots, sum(len(g) for g in got)
            finally:
                await SL.shutdown(state)

        slots, viewed = asyncio.run(two_publishers())
        say(f"faults 7a: two WHIP publishers at --fbs 2 through the session layer claimed "
            f"scheduler slots {slots}; {viewed} processed frames read back")
    finally:
        sched.close()


def fault_supervision(torch, card, pipe, ref_bundle, count):
    """7b: a slow step on the pipeline path under its supervisor: the delayed
    frame comes back as its source bit for bit, HEALTHY -> DEGRADED ->
    RECOVERING -> HEALTHY, the step released after restart() replays
    nothing, and the frames after recovery meet phase 4's criterion."""
    import numpy as np

    from ai_rtc_agent_tpu_torch.resilience import faults
    from ai_rtc_agent_tpu_torch.resilience.supervisor import ResilientPipeline, SessionSupervisor
    from ai_rtc_agent_tpu_torch.tree import tree_equal

    eng, dev = pipe.engine, pipe.device
    frames = _frames(np, 10, seed=90, size=pipe.config.height)
    pipe.restart()
    sup = SessionSupervisor("7b", restart_backoff_s=0.05)
    rp = ResilientPipeline(pipe, sup, step_timeout_s=0.5, first_step_timeout_s=0.5, warm_steps=0)
    try:
        before = _launches()
        for f in frames[:3]:
            rp(f)
        count(before, 3, "faults 7b healthy steps")
        eng._fault_scope = _inject(faults, "slow_step", delay_s=SLOW_STEP_S)
        held_runner = rp._runner
        t = time.perf_counter()
        out = rp(frames[3])
        degraded_ms = (time.perf_counter() - t) * 1e3
        if not np.array_equal(np.asarray(out), frames[3]):
            fail("faults 7b: the delayed frame did not come back as its source")
        restart_s = _wait_for(lambda: sup.state == "RECOVERING", 30.0, "restart (RECOVERING)")
        restarted = session_row(eng.state, None)
        before = _launches()
        held_runner._thread.join(SLOW_STEP_S + 10.0)  # the held step wakes now
        if held_runner._thread.is_alive():
            fail("faults 7b: the held step did not return")
        late = tuple(x - y for x, y in zip(_launches(), before))
        if late != (0, 0) or not tree_equal(session_row(eng.state, None), restarted):
            fail(f"faults 7b: the step held past restart() replayed ({late} launches) or moved "
                 "the state")
        eng._fault_scope = None
        faults.deactivate()
        ded = Dedicated(torch, eng.models, eng.params, pipe.config, eng.encode_prompt, ref_bundle,
                        restarted, dev)
        before = _launches()
        after = [rp(f) for f in frames[4:10]]
        count(before, 6, "faults 7b after recovery")
        for f in frames[4:10]:
            ded(f)
        path = [t["to"] for t in sup.snapshot()["transitions"]]
        snap = sup.snapshot()
        say(f"faults 7b: {card} | slow_step {SLOW_STEP_S}s against a 0.5 s budget: passthrough "
            f"of the source frame after {degraded_ms:.1f} ms, restart() done {restart_s:.3f} s "
            f"later; the held step woke after it: 0 launches, ring and stock as restarted, bit "
            f"for bit | states HEALTHY -> {' -> '.join(path)} | processed "
            f"{snap['processed_frames']}, passthrough {snap['passthrough_frames']} | after "
            f"recovery: " + hold_to_references(np, "7b after recovery", after, ded))
        if path != ["DEGRADED", "RECOVERING", "HEALTHY"]:
            fail(f"faults 7b: supervisor states {path}")
    finally:
        eng._fault_scope = None
        faults.deactivate()
        rp.close()


async def fault_guard(torch, card, pipe, ref_bundle, count, BatchScheduler):
    """7c (i) a wedge, (ii) a device stall, then 7d's overload, then 7c (iii)
    an exhausted rebuild: the engine guard over a 2-slot scheduler (graphs)
    wired as the agent wires it (server/sessions.py startup)."""
    import numpy as np

    from ai_rtc_agent_tpu_torch.parallel.multipeer import CapacityError
    from ai_rtc_agent_tpu_torch.resilience import faults
    from ai_rtc_agent_tpu_torch.resilience.supervisor import ResilientPipeline
    from ai_rtc_agent_tpu_torch.server import sessions as SL
    from ai_rtc_agent_tpu_torch.server.signaling import LoopbackProvider, make_loopback_offer
    from ai_rtc_agent_tpu_torch.tree import tree_equal, tree_map

    eng, dev = pipe.engine, pipe.device
    sched = BatchScheduler.from_pipeline(pipe, max_sessions=2)
    state = {}
    SL.configure(state, model_id=pipe.model_id, pipeline=pipe, provider=LoopbackProvider(),
                 batch_scheduler=sched)
    await SL.startup(state)
    guard = state["engine_guard"]
    events = []
    handler = state["stream_event_handler"]
    fire = handler.handle_engine_state

    def record(event, st, reason="", **extra):
        events.append((event, st, time.perf_counter()))
        return fire(event, st, reason=reason, **extra)

    handler.handle_engine_state = record
    sess = [sched.claim(f"g{i}", prompt=SESSION_PROMPTS[i], seed=400 + i) for i in range(2)]
    rps = [ResilientPipeline(s) for s in sess]
    size = pipe.config.height
    frames = [_frames(np, 16, seed=130 + i, size=size) for i in range(2)]

    async def tick(i):
        return await asyncio.gather(*(asyncio.to_thread(lambda rp=rp, f=f[i]: rp.fetch(
            rp.submit(f))) for rp, f in zip(rps, frames)))

    async def ticks(idx, label):
        steps0, before = sched.steps_total, _launches()
        outs = [await tick(i) for i in idx]
        count(before, sched.steps_total - steps0, label)
        return outs

    def passthrough(outs, i, label):
        if not all(np.array_equal(np.asarray(o), f[i]) for o, f in zip(outs, frames)):
            fail(f"faults {label}: a rider's frame was not its source (passthrough)")

    async def rearmed(n: int, what: str) -> float:
        """Wait for the n-th EngineRecovered webhook; -> ms from the trip's
        EngineDegraded to it."""
        await asyncio.to_thread(_wait_for, lambda: [e for e, _, _ in events].count(
            "EngineRecovered") == n, 60.0, f"rebuild ({what})")
        t0 = next(t for e, _, t in reversed(events) if e == "EngineDegraded")
        t1 = next(t for e, _, t in reversed(events) if e == "EngineRecovered")
        if guard.state != "ARMED":
            fail(f"faults 7c: the guard is {guard.state} after the rebuild ({what})")
        return (t1 - t0) * 1e3

    try:
        await ticks(range(3), "faults 7c healthy steps")
        bank = {slot: tree_map(torch.clone, row) for slot, row in sched._snap_rows.items()}
        # (i) a wedge holds the step until released
        held_runner = guard._runner
        sched._fault_scope = _inject(faults, "wedge")
        t = time.perf_counter()
        outs = await tick(3)
        tripped_ms = (time.perf_counter() - t) * 1e3
        passthrough(outs, 3, "7c wedge")
        r = await SL.publish(state, make_loopback_offer())
        if (r.status, r.body) != (503, "engine quarantined") or "Retry-After" not in r.headers:
            fail(f"faults 7c: a claim during the quarantine answered {r.status} {r.body!r}")
        try:
            sched.claim("late")
            fail("faults 7c: the scheduler took a claim while quarantined")
        except CapacityError:
            pass
        wedge_ms = await rearmed(1, "wedge")
        captures = capture_seconds(sched)
        restored = all(tree_equal(session_row(sched.states, s.slot), bank[s.slot])
                       for s in sess)
        if not restored or set(bank) != {s.slot for s in sess}:
            fail("faults 7c: the rebuilt rows are not the banked rows bit for bit")
        rebuilt = [session_row(sched.states, s.slot) for s in sess]
        before = _launches()
        faults.release_wedge()  # the held step wakes after the rebuild
        held_runner._thread.join(10.0)
        late = tuple(x - y for x, y in zip(_launches(), before))
        if held_runner._thread.is_alive() or late != (0, 0) or not all(
                tree_equal(session_row(sched.states, s.slot), row)
                for s, row in zip(sess, rebuilt)):
            fail(f"faults 7c: the wedged step released after the rebuild replayed ({late}) or "
                 "wrote the plane")
        sched._fault_scope = None
        faults.deactivate()
        deds = [Dedicated(torch, eng.models, eng.params, pipe.config, eng.encode_prompt,
                          ref_bundle, bank[s.slot], dev) for s in sess]
        outs = await ticks(range(4, 8), "faults 7c after the wedge")
        for j, ded in enumerate(deds):
            for i in range(4, 8):
                ded(frames[j][i])
        held = [hold_to_references(np, f"7c session {j} after the rebuild", [o[j] for o in outs],
                                   ded) for j, ded in enumerate(deds)]
        say(f"faults 7c (i) wedge: {card} | the guard tripped in {tripped_ms:.1f} ms (deadline "
            f"{guard.deadline_s:g} s), both riders passthrough, /whip 503 'engine quarantined' "
            f"Retry-After {r.headers['Retry-After']}, claim refused | rebuild recaptured "
            f"buckets (s) {captures}, restored rows = bank bit for bit, the released step "
            f"replayed nothing | trip -> ARMED {wedge_ms:.1f} ms | after: " + "; ".join(held))

        # (ii) a device stall: a sleep kernel holds the default stream (the
        # card only: a CPU rehearsal of this phase has no stream to hold)
        recovered = 2 if dev.type == "cuda" else 1
        if dev.type == "cuda":
            await fault_stall(torch, card, sched, tick, ticks, rearmed, passthrough, size)

        # 7d: a slow bucket step raises the admission EWMA; /whip answers 503
        adm = state["overload"].admission
        ewma0 = adm.step_ewma.value
        guard.deadline_s = 30.0
        sched._fault_scope = _inject(faults, "slow_step", delay_s=OVERLOAD_STEP_S)
        steps0, before = sched.steps_total, _launches()
        await asyncio.to_thread(lambda: rps[0].fetch(rps[0].submit(frames[0][11])))
        count(before, sched.steps_total - steps0, "faults 7d slow step")
        sched._fault_scope = None
        faults.deactivate()
        r = await SL.publish(state, make_loopback_offer())
        if (r.status, r.body) != (503, "overloaded") or "Retry-After" not in r.headers:
            fail(f"faults 7d: /whip under pressure answered {r.status} {r.body!r}")
        say(f"faults 7d: a {OVERLOAD_STEP_S:g} s bucket step of 1 session: admission step EWMA "
            f"{ewma0 * 1e3:.1f} -> {adm.step_ewma.value * 1e3:.1f} ms per session (budget "
            f"{adm.step_budget_s * 1e3:.0f}), pressure {adm.pressure():.3f}; /whip {r.status} "
            f"{r.body!r} Retry-After {r.headers['Retry-After']}")
        say(f"faults 7d /health: {json.dumps(SL.health(state), sort_keys=True)}")
        say(f"faults 7d /capacity: {json.dumps(SL.capacity(state), sort_keys=True)}")

        # (iii) device lost, and a rebuild that keeps failing
        def refuse(*a, **k):
            raise RuntimeError("device still gone (injected)")

        sched.rebuild_engine = refuse
        guard.deadline_s = 1.0
        sched._fault_scope = _inject(faults, "device_lost")
        outs = await tick(12)
        passthrough(outs, 12, "7c device lost")
        await asyncio.to_thread(_wait_for, lambda: guard.state == "FAILED" and "AgentEvacuating"
                                in [e for e, _, _ in events], 30.0, "evacuation (FAILED)")
        for i in (13, 14):
            passthrough(await tick(i), i, "7c after FAILED")
        names = [e for e, _, _ in events]
        say(f"faults 7c (iii) device_lost, rebuild refused 3 times: guard {guard.health()} | "
            f"webhooks {names} | passthrough goes on")
        if names != ["EngineDegraded", "EngineRecovered"] * recovered + ["EngineDegraded",
                                                                          "AgentEvacuating"]:
            fail(f"faults 7c: engine webhooks {names}")
    finally:
        faults.deactivate()
        for rp in rps:
            rp.close()
        await SL.shutdown(state)


async def fault_stall(torch, card, sched, tick, ticks, rearmed, passthrough, size):
    """7c (ii): a sleep kernel holds the default stream past the guard's
    1 s deadline: the bucket step behind it trips the guard on its
    completion deadline (nothing blocks), and the rebuild behind the stall
    re-arms the plane once the sleep ends."""
    import numpy as np

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    torch.cuda._sleep(50_000_000)
    e1.record()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(STALL_S * 1e3 * 50_000_000 / e0.elapsed_time(e1)))
    t = time.perf_counter()
    outs = await tick(8)
    tripped_ms = (time.perf_counter() - t) * 1e3
    passthrough(outs, 8, "7c stall")
    if tripped_ms > 1e3 * STALL_S:
        fail(f"faults 7c: the stalled step returned after {tripped_ms:.0f} ms, past the stall: "
             "the completion deadline did not trip")
    armed_ms = await rearmed(2, "stall")
    outs = await ticks(range(9, 11), "faults 7c after the stall")
    if any(np.asarray(o).shape != (size, size, 3) for row in outs for o in row):
        fail("faults 7c: bad frames after the stall")
    say(f"faults 7c (ii) device stall: {card} | a sleep kernel held the default stream "
        f"{STALL_S:g} s; the guard tripped on the completion deadline after {tripped_ms:.1f} ms "
        f"(both riders passthrough, nothing blocked); the rebuild behind the stall: trip -> "
        f"ARMED {armed_ms:.1f} ms, buckets (s) "
        f"{capture_seconds(sched)}; steps resumed")


def fault_cost(torch, card, pipe, count, BatchScheduler):
    """7d: ms between bucket steps at k = 1, 4, 8 with the guard and
    supervision on and off (ABBA), the snapshot bank's device cost per
    refresh at k = 8, and served fps with SUPERVISOR on and off in turns."""
    import numpy as np

    from ai_rtc_agent_tpu_torch.resilience.engine_guard import EngineGuard
    from ai_rtc_agent_tpu_torch.resilience.supervisor import ResilientPipeline
    from ai_rtc_agent_tpu_torch.server import sessions as SL
    from ai_rtc_agent_tpu_torch.server.signaling import LoopbackProvider

    sched = BatchScheduler.from_pipeline(pipe, max_sessions=8)
    guard = EngineGuard(sched, deadline_s=30.0, cold_deadline_s=600.0)
    frames = [_frames(np, COST_FRAMES, seed=150 + i, size=pipe.config.height) for i in range(8)]
    try:
        for k in COST_OCCUPANCY:
            sess = [sched.claim(f"c{i}", prompt=SESSION_PROMPTS[i], seed=500 + i) for i in range(k)]
            wrapped = [ResilientPipeline(s) for s in sess]
            res = {"on": [], "off": []}
            for name in ("on", "off", "off", "on"):
                sched.attach_guard(guard if name == "on" else None)
                steps0, before = sched.steps_total, _launches()
                run = drive_sessions(torch, wrapped if name == "on" else sess, frames, COST_FRAMES)
                count(before, sched.steps_total - steps0, f"faults 7d k={k} plane {name}")
                # a supervised session's handle is ("live", the scheduler's handle, frame)
                run.handles = [[h[1] if isinstance(h, tuple) else h for h in hs]
                               for hs in run.handles]
                ms, n = run.steady_step_ms(SCHED_FILL)
                res[name].append(f"{ms:.2f} ms ({n} steps, {sum(run.steady_fps(SCHED_FILL)):.2f} fps)")
            if k == 8 and pipe.device.type == "cuda":
                sched.attach_guard(guard)
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                with sched._step_lock:
                    sched._last_snap_t = 0.0
                    e0.record()
                    sched._maybe_bank_rows_locked()
                    e1.record()
                torch.cuda.synchronize()
                nbytes = sum(a.numel() * a.element_size() for row in sched._snap_rows.values()
                             for a in _leaves(row))
                say(f"faults 7d: {card} | snapshot bank refresh at k=8: {e0.elapsed_time(e1):.4f} "
                    f"ms on the device, {nbytes / 2**20:.3f} MiB cloned")
            say(f"faults 7d k={k}: {card} | ms between bucket steps (steady, outputs "
                f"{SCHED_FILL + 1}-{COST_FRAMES}), guard + supervision on: {res['on']}; off: "
                f"{res['off']} (order on, off, off, on)")
            for w in wrapped:
                w.close()
            for s in sess:
                s.release()
    finally:
        guard.close()
        sched.close()

    depth = 2
    pushed_n = 24

    async def served(on: bool):
        with _Env(SUPERVISOR=int(on)):
            state = {}
            SL.configure(state, model_id=pipe.model_id, pipeline=pipe, provider=LoopbackProvider())
            await SL.startup(state)
            try:
                pub_id, pub_pc, view_id, viewer = await open_loopback_session(state)
                fr = _frames(np, pushed_n, seed=170, size=pipe.config.height)
                before = _launches()
                t = time.perf_counter()
                got, times = await exchange(pub_pc, viewer, fr + fr[-1:] * (depth - 1), 0, pushed_n)
                count(before, pushed_n + depth - 1, f"faults 7d served, SUPERVISOR {int(on)}")
                times = [x - t for x in times]
                return (pushed_n - 1) / (times[-1] - times[0]), times[0] * 1e3
            finally:
                await SL.shutdown(state)

    runs = [(turn, asyncio.run(served(turn == "on"))) for turn in SERVE_TURNS]
    say(f"faults 7d: {card} | served (phase 5's loopback session, {pushed_n} frames), steady fps "
        f"and first view ms, in turns: "
        + ", ".join(f"SUPERVISOR {turn} {fps:.2f} fps / {first:.2f} ms" for turn, (fps, first) in runs))


# -- phase 8: native RTP ---------------------------------------------------------------

NATIVE_RUNS = (  # label, signaling, sessions, client fps, frames pushed per session
    ("1 session at 30 fps, /offer", "offer", 1, 30, 48),
    ("1 session at 60 fps, /whip + /whep", "whip", 1, 60, 72),
    ("2 sessions at 30 fps each, /offer", "offer", 2, 30, 48),
)
NATIVE_FILL = 4  # each session's first returned frames: outside the steady window
NATIVE_RCVBUF = 8 << 20  # the clients' receive buffers (a browser sizes its own)
NATIVE_BURST = 16  # the clients' pacer: packets per burst
NATIVE_TAIL_S = 0.5  # after the last push: the wait for a frame still on its way
NATIVE_DISTINCT = 16  # distinct frames per session, cycled (made before the loop runs)
# a probe beside the runs: the client in a process of its own, its packets
# spread over half of each frame interval; the agent's loop then drains its
# socket only when it is free, as it would for a remote peer
NATIVE_PROBE = ("1 session at 30 fps, /offer, the client in a process of its own", 30, 48)
NATIVE_PROBE_SPREAD = 0.5


class StepTap:
    """The scheduler's claims, tapped: each claimed session by its key, and
    for each frame served to the track (by session key and pts) the
    occupancy and dispatch time of the bucket step it rode."""

    def __init__(self, sched):
        from ai_rtc_agent_tpu_torch.resilience.overload import ShedFrame

        self.sched, self.sessions, self.rode = sched, {}, {}
        claim = sched.claim

        def tapped(session_key=None, *args, **kw):
            sess = claim(session_key, *args, **kw)
            fetch = sess.fetch

            def fetch_tap(handle, src_frame=None):
                out = fetch(handle, src_frame)
                if src_frame is not None and not isinstance(out, ShedFrame):
                    self.rode[(session_key, src_frame.pts)] = (handle.occupancy, handle.t_dispatch)
                return out

            sess.fetch = fetch_tap
            self.sessions[session_key] = sess
            return sess

        sched.claim = tapped


class NativeLeg:
    """One session of a native run: its publishing client, the client that
    views its processed stream (the same one for /offer), the agent's peer
    connections and the frames pushed, by pts."""

    def __init__(self, key, pub, view, pcs, frames, fps):
        self.key, self.pub, self.view, self.pcs = key, pub, view, pcs
        self.step = 90_000 // fps
        self.frames = frames
        self.got: list = []  # (pts, frame, time.monotonic()) as the viewer decoded them
        self.pushed: list = []  # time.monotonic() as each push began
        self.pli_requests = 0
        self.recv_s, self.recv_calls = 0.0, 0  # the agent's receive callbacks
        self.downlink: dict | None = None  # the viewer's reception stats at the end


class ClientProcess:
    """The client side of a leg in a process of its own (``python3
    chip_smoke.py --native-client SPEC``): its process and the file it
    writes what came back to."""

    def __init__(self, proc, out):
        self.proc, self.out = proc, out

    def close(self):
        if self.proc.returncode is None:
            self.proc.kill()


async def open_native_leg(np, state, how: str, s: int, fps: int, frames, use_h264: bool) -> NativeLeg:
    """Session ``s`` over the native tier: a JSON-envelope /offer, or /whip
    with a second client viewing through /whep; the clients on loopback UDP."""
    from ai_rtc_agent_tpu_torch.media.rtp_client import NativeRtpClient
    from ai_rtc_agent_tpu_torch.server import sessions

    size = frames[0].shape[0]

    async def client():
        return await NativeRtpClient(size, size, fps=fps, use_h264=use_h264,
                                     rcvbuf=NATIVE_RCVBUF).open()

    pub = await client()
    live = state["state"]
    if how == "offer":
        r = await sessions.offer(state, {"room_id": f"native-{s}",
                                         "offer": {"sdp": pub.offer_envelope(), "type": "offer"}})
        if r.status != 200:
            fail(f"native: /offer answered {r.status} {r.body}")
        key, view = r.headers["X-Stream-Id"], pub
        port = json.loads(json.loads(r.body)["sdp"])["server_port"]
        pcs = [pc for pc in state["pcs"] if pc.server_port == port]
    else:
        r = await sessions.publish(state, pub.offer_envelope())
        view = await client()
        envelope = {"native_rtp": True, "video": False, "width": size, "height": size,
                    "client_addr": ["127.0.0.1", view.port]}
        rv = await sessions.subscribe(state, json.dumps(envelope))
        if (r.status, rv.status) != (201, 201):
            fail(f"native: /whip {r.status}, /whep {rv.status} (want 201, 201)")
        key = r.headers["Location"].rsplit("/", 1)[1]
        port = json.loads(r.body)["server_port"]
        pcs = [live["whip_pcs"][key], live["whep_pcs"][rv.headers["Location"].rsplit("/", 1)[1]]]
    await pub.connect(port)
    return _leg(key, pub, view, pcs, frames, fps, s)


def _leg(key, pub, view, pcs, frames, fps, s) -> NativeLeg:
    """A leg whose agent side came up, with its PLI requests counted and the
    host time of its receive callbacks summed (the plane's recv histogram
    keeps a window of samples, not a total)."""
    if len(pcs) not in (1, 2) or pcs[0].in_track is None:
        fail(f"native: session {s} came up without its peer connection or inbound track")
    leg = NativeLeg(key, pub, view, pcs, frames, fps)
    proto = pcs[0]._recv_protocol
    send_pli, received = proto._send_pli, proto.datagram_received

    def counted_pli():
        leg.pli_requests += 1
        send_pli()

    def timed_receive(data, addr):
        t = time.perf_counter()
        received(data, addr)
        leg.recv_s += time.perf_counter() - t
        leg.recv_calls += 1

    proto._send_pli, proto.datagram_received = counted_pli, timed_receive
    return leg


async def open_process_leg(state, s: int, fps: int, frames, seed: int) -> NativeLeg:
    """Session ``s`` over a JSON-envelope /offer, its client in a process of
    its own (the same frames, made there from the same seed); the client
    starts pushing once it has the agent's port."""
    from ai_rtc_agent_tpu_torch.server import sessions

    size = frames[0].shape[0]
    here = Path(__file__).resolve().parent
    out = here / "build" / f"native_client_{s}.npz"
    out.parent.mkdir(exist_ok=True)
    spec = {"size": size, "fps": fps, "n": len(frames), "seed": seed, "out": str(out)}
    proc = await asyncio.create_subprocess_exec(
        sys.executable, str(here / "chip_smoke.py"), "--native-client", json.dumps(spec),
        stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE)
    client = ClientProcess(proc, out)
    try:
        port = json.loads(await asyncio.wait_for(proc.stdout.readline(), 120))["port"]
    except (ValueError, KeyError, asyncio.TimeoutError):
        client.close()
        fail("native: the client process did not report its port")
    envelope = {"native_rtp": True, "video": True, "width": size, "height": size,
                "client_addr": ["127.0.0.1", port]}
    r = await sessions.offer(state, {"room_id": f"native-process-{s}",
                                     "offer": {"sdp": json.dumps(envelope), "type": "offer"}})
    if r.status != 200:
        client.close()
        fail(f"native: /offer answered {r.status} {r.body}")
    server_port = json.loads(json.loads(r.body)["sdp"])["server_port"]
    leg = _leg(r.headers["X-Stream-Id"], client, client,
               [pc for pc in state["pcs"] if pc.server_port == server_port], frames, fps, s)
    proc.stdin.write(json.dumps({"server_port": server_port}).encode() + b"\n")
    await proc.stdin.drain()
    return leg


async def finish_process_leg(np, leg, timeout_s: float = 120.0):
    """Wait for the client process and read back what it received."""
    proc = leg.pub.proc
    try:
        rc = await asyncio.wait_for(proc.wait(), timeout_s)
    except asyncio.TimeoutError:
        leg.pub.close()
        fail("native: the client process did not finish")
    if rc != 0:
        fail(f"native: the client process exited with {rc}")
    with np.load(leg.pub.out) as got:
        leg.got = [(int(p), a, float(t)) for p, a, t in zip(got["pts"], got["frames"], got["times"])]
        leg.pushed = [float(t) for t in got["pushed"]]
        leg.downlink = json.loads(str(got["downlink"]))
        return float(got["t0"])


def native_client(spec: dict):
    """``python3 chip_smoke.py --native-client SPEC``: the client side of one
    /offer leg in this process (no CUDA): print the receive port, read the
    agent's port from stdin, push the leg's frames at ``fps`` with the
    frame's packets spread over NATIVE_PROBE_SPREAD of its interval, and
    write what came back, its reception stats and the clock at the first
    push to ``spec["out"]``."""
    import numpy as np

    from ai_rtc_agent_tpu_torch.media.rtp_client import NativeRtpClient

    async def run():
        size, fps, n = spec["size"], spec["fps"], spec["n"]
        base = _frames(np, NATIVE_DISTINCT, seed=spec["seed"], size=size)
        c = await NativeRtpClient(size, size, fps=fps, use_h264=False,
                                  rcvbuf=NATIVE_RCVBUF).open()
        try:
            print(json.dumps({"port": c.port}), flush=True)
            line = await asyncio.get_running_loop().run_in_executor(None, sys.stdin.readline)
            await c.connect(json.loads(line)["server_port"])
            leg = NativeLeg(None, c, c, [], [base[i % NATIVE_DISTINCT] for i in range(n)], fps)
            bursts = math.ceil(3 * size * size / (1200 - 14) / NATIVE_BURST)
            t0 = await drive_native([leg], fps, n, gap_s=NATIVE_PROBE_SPREAD / fps / bursts)
        finally:
            c.close()
        frames = [a for _, a, _ in leg.got]
        np.savez(spec["out"], pts=np.array([p for p, _, _ in leg.got], np.int64),
                 frames=np.stack(frames) if frames else np.zeros((0, size, size, 3), np.uint8),
                 times=np.array([t for _, _, t in leg.got]), t0=t0, pushed=np.array(leg.pushed),
                 downlink=json.dumps(c.rx_stats.report_block()))

    asyncio.run(run())


async def drive_native(legs, fps: int, n: int, gap_s: float = 0.0) -> float:
    """Push each leg's ``n`` frames at ``fps`` (paced packets, bursts
    ``gap_s`` apart) while draining every viewer; wait out the frames still
    on their way.  -> time.monotonic() at the first push."""
    stop = asyncio.Event()

    async def drain():
        while not stop.is_set():
            for leg in legs:
                leg.view.drain(lambda arr, pts, leg=leg: leg.got.append(
                    (pts, arr, time.monotonic())))
            await asyncio.sleep(0.001)

    async def push(leg):
        t_next = time.monotonic()
        for i in range(n):
            leg.pushed.append(time.monotonic())
            await leg.pub.send_paced(leg.frames[i], i, NATIVE_BURST, gap_s)
            t_next += 1.0 / fps
            await asyncio.sleep(max(0.0, t_next - time.monotonic()))

    drainer = asyncio.ensure_future(drain())
    t0 = time.monotonic()
    await asyncio.gather(*[push(leg) for leg in legs])
    seen = -1
    while seen != sum(len(leg.got) for leg in legs):  # until nothing more arrives
        seen = sum(len(leg.got) for leg in legs)
        await asyncio.sleep(NATIVE_TAIL_S)
    stop.set()
    await drainer
    return t0


def direct_outputs(np, tap, legs) -> dict:
    """Each served frame again through its own scheduler session, at the
    occupancy of the bucket step that served it (the other leg's frame
    riding beside it at 2, both submitted at a barrier under a long
    coalescing window): {(key, pts): direct frame}."""
    out = {}
    gate = threading.Barrier(2)

    def step(sess, arr, paired=False):
        if paired:
            gate.wait(timeout=10)
        h = sess.submit(arr)
        return np.asarray(sess.fetch(h)), h.occupancy

    by_key = {leg.key: leg for leg in legs}
    for leg in legs:
        sess = tap.sessions[leg.key]
        for pts, _, _ in leg.got:
            occ, _ = tap.rode[(leg.key, pts)]
            arr = leg.frames[pts // leg.step]
            if occ == 1:
                got, occ_now = step(sess, arr)
                if occ_now != 1:
                    fail(f"native: a direct call rode occupancy {occ_now}, not 1")
            else:
                other = next(k for k in by_key if k != leg.key)
                window, tap.sched.window_s = tap.sched.window_s, 0.5
                try:
                    with ThreadPoolExecutor(2) as ex:
                        for _ in range(4):
                            a = ex.submit(step, sess, arr, True)
                            b = ex.submit(step, tap.sessions[other], by_key[other].frames[0], True)
                            (got, occ_now), (_, occ_b) = a.result(), b.result()
                            if occ_now == occ_b == occ:
                                break
                        else:
                            fail(f"native: no direct step of occupancy {occ} in 4 tries")
                finally:
                    tap.sched.window_s = window
            out[(leg.key, pts)] = got
    return out


def plane_stages(provider, legs) -> dict:
    """Host-plane µs per frame of one leg: packetize and send from /metrics'
    host_plane_sessions (one sample a frame; a WHEP viewer's from its
    broadcast group), recv summed over the agent's receive callbacks (each
    drains a burst of datagrams)."""
    snap = provider.host_plane_snapshot()
    leg = legs[0]
    merged = {}
    for pc in leg.pcs:
        merged.update(snap.get(pc.pc_id, {}))
        group = getattr(pc, "_broadcast_group", None)
        if group is not None:
            merged.update({k: v for k, v in group.stats.stage_snapshot_us().items()
                           if k.startswith(("packetize", "send", "tx_packets"))})
    frames = max(1, len(leg.got))
    return {
        "recv_us_per_frame": round(1e6 * leg.recv_s / len(leg.frames), 2),
        "recv_callbacks_per_frame": round(leg.recv_calls / len(leg.frames), 2),
        "recv_p50_us_per_callback": merged.get("recv_p50_us"),
        "packetize_p50_us": merged.get("packetize_p50_us"),
        "send_p50_us": merged.get("send_p50_us"),
        "rx_datagrams": merged.get("rx_datagrams_total"),
        "tx_packets_per_frame": round(merged.get("tx_packets_total", 0) / frames, 1),
    }


async def close_native(state, how: str, legs):
    from ai_rtc_agent_tpu_torch.server import sessions

    if how == "offer":
        for leg in legs:
            await leg.pcs[0].close()
    else:
        live = state["state"]
        for leg in legs:
            view_id = next(k for k, pc in live["whep_pcs"].items() if pc is leg.pcs[1])
            if not (await sessions.close(state, "whep", view_id)
                    and await sessions.close(state, "whip", leg.key)):
                fail("native: closing a WHIP/WHEP session found nothing to close")
    await asyncio.sleep(0)
    await asyncio.gather(*state["releasing"])
    for leg in legs:
        leg.pub.close()
        if leg.view is not leg.pub:
            leg.view.close()


def phase_native(torch, card: str, pipe, loopback_fps: float):
    """Phase 8: the native tier on the card (see the module docstring)."""
    import numpy as np

    from ai_rtc_agent_tpu_torch.media import native
    from ai_rtc_agent_tpu_torch.server import sessions
    from ai_rtc_agent_tpu_torch.server.signaling import get_provider
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    t_phase = t = time.perf_counter()
    lib = native.load()
    took = time.perf_counter() - t
    if lib is None:
        fail(f"native: the C++ runtime did not build or load: {native.load_error()}")
    h264 = native.h264_available()
    built = (f"built in {native.build_seconds:.2f} s" if native.build_seconds is not None
             else "reused from build/")
    say(f"native: C++ runtime {native.library_path()} ({built}; loaded in {took:.2f} s); "
        f"H.264 (libavcodec) {'available' if h264 else 'absent: NullCodec'}")
    rmem = {}
    for name in ("rmem_default", "rmem_max"):
        try:
            with open(f"/proc/sys/net/core/{name}") as f:
                rmem[name] = int(f.read())
        except OSError:
            rmem[name] = None
    say(f"native: net.core {rmem}; the agent's sockets keep the default receive buffer")
    size = pipe.config.width
    # made off the event loop: a loop blocked for seconds reads as lag to the
    # overload plane's watchdog, and admission would refuse the next session
    bases = [_frames(np, NATIVE_DISTINCT, seed=80 + s, size=size) for s in range(2)]
    with _Env(WEBRTC_PROVIDER="native-rtp", WARMUP_FRAMES=0, DROP_FRAMES=0,
              OVERLOAD_RX_QUEUE_BOUND=16384):
        provider = get_provider()
        if type(provider).__name__ != "NativeRtpProvider":
            fail(f"native: WEBRTC_PROVIDER=native-rtp gave {type(provider).__name__}")
        if h264:
            # lossy: the frames could not be held bit for bit
            say("native: H.264 is available; this phase serves NullCodec, which is lossless")
        provider.use_h264 = False
        t = time.perf_counter()
        sched = BatchScheduler.from_pipeline(pipe, max_sessions=2)
        say(f"native: BatchScheduler.from_pipeline, 2 slots, buckets {sched._bucket_sizes} "
            f"captured in {time.perf_counter() - t:.2f} s")
        tap = StepTap(sched)
        attn_total = epi_total = 0

        async def run_all():
            nonlocal attn_total, epi_total
            state = {}
            sessions.configure(state, model_id=pipe.model_id, pipeline=pipe, provider=provider,
                               batch_scheduler=sched)
            await sessions.startup(state)
            slo_breaches.update(count_slo_breaches(state["slo"]))
            results = []
            for label, how, k, fps, n in NATIVE_RUNS:
                legs = [await open_native_leg(np, state, how, s, fps,
                                              [bases[s][i % NATIVE_DISTINCT] for i in range(n)],
                                              False)
                        for s in range(k)]
                _sync(torch, pipe.device)
                _reset_launches()
                t0 = await drive_native(legs, fps, n)
                attn, epi = _launches()
                attn_total += attn
                epi_total += epi
                metrics = sessions.metrics(state)
                stages = plane_stages(provider, legs)
                uplink = [leg.pcs[0]._rtcp_state.recv.report_block() for leg in legs]
                downlink = [leg.view.rx_stats.report_block() for leg in legs]
                ring_drops = [leg.pcs[0].in_track.dropped for leg in legs]
                direct = await asyncio.to_thread(direct_outputs, np, tap, legs)
                results.append((label, how, k, fps, n, legs, t0, attn, epi, metrics, stages,
                                uplink, downlink, ring_drops, direct))
                await close_native(state, how, legs)
                if state["pcs"] or sched.free_slots != 2:
                    fail(f"native: {label}: {len(state['pcs'])} peer connection(s) and "
                         f"{2 - sched.free_slots} slot(s) left after closing")
            label, fps, n = NATIVE_PROBE
            leg = await open_process_leg(state, 0, fps, [bases[0][i % NATIVE_DISTINCT]
                                                         for i in range(n)], seed=80)
            _reset_launches()
            t0 = await finish_process_leg(np, leg)
            attn, epi = _launches()
            attn_total += attn
            epi_total += epi
            metrics, stages = sessions.metrics(state), plane_stages(provider, [leg])
            uplink, ring_drops = [leg.pcs[0]._rtcp_state.recv.report_block()], [leg.pcs[0].in_track.dropped]
            direct = await asyncio.to_thread(direct_outputs, np, tap, [leg])
            probe = (label, "offer", 1, fps, n, [leg], t0, attn, epi, metrics, stages, uplink,
                     [leg.downlink], ring_drops, direct)
            await close_native(state, "offer", [leg])
            slo_stages.update(state["slo"].snapshot()["slo_stages"])
            await sessions.shutdown(state)
            return results, probe

        slo_breaches, slo_stages = {}, {}
        results, probe = asyncio.run(run_all())
    for (label, how, k, fps, n, legs, t0, attn, epi, metrics, stages, uplink, downlink,
         ring_drops, direct) in results + [probe]:
        report_native_run(np, card, label, k, fps, n, legs, t0, attn, epi, metrics, stages,
                          uplink, downlink, ring_drops, direct, tap, loopback_fps,
                          probe=label == NATIVE_PROBE[0])
    say(f"native: {card} | the SLO plane over phase 8 (the JAX budgets, 1 s ticks): breaches "
        f"per stage {json.dumps(slo_breaches['breach'])}, over budget / frames per stage "
        f"{json.dumps({k: [v['over'], v['count'], v['budget_ms']] for k, v in slo_stages.items()})}")
    say(f"native: phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return attn_total, epi_total


def count_slo_breaches(slo) -> dict:
    """{"breach": {stage: transitions into breach}}, counted from now on: the
    plane's breach callback, wrapped (the agent's webhooks still fire)."""
    counts = {"breach": {}}
    inner = slo.on_breach

    def counting(session_key, stage, state, info):
        if state == "breach":
            counts["breach"][stage] = counts["breach"].get(stage, 0) + 1
        if inner is not None:
            inner(session_key, stage, state, info)

    slo.on_breach = counting
    return counts


def report_native_run(np, card, label, k, fps, n, legs, t0, attn, epi, metrics, stages, uplink,
                      downlink, ring_drops, direct, tap, loopback_fps, probe=False):
    """Check one run (frames returned in pts order, each its direct call bit
    for bit, 32 + 1 launches a bucket step) and print its numbers.  The probe
    may lose every frame on the agent's default receive buffer: that is
    what it measures; the frames it does get back are held as the runs' are."""
    name = f"native {label}"
    if attn != 32 * epi or (epi == 0 and not probe):
        fail(f"{name}: {attn} attention and {epi} epilogue launches (want 32 per bucket step)")
    firsts, fps_each, steps, pushed = [], [], set(), []
    for leg in legs:
        pts = [p for p, _, _ in leg.got]
        if not pts:
            if probe:
                continue
            fail(f"{name}: session {leg.key[:8]} got no frame back")
        if pts != sorted(set(pts)):
            fail(f"{name}: session {leg.key[:8]}'s frames came back out of pts order: {pts}")
        bad = [p for p, arr, _ in leg.got
               if arr.shape != legs[0].frames[0].shape or not np.array_equal(arr, direct[(leg.key, p)])]
        if bad:
            p = bad[0]
            arr = next(a for q, a, _ in leg.got if q == p)
            diff = np.abs(arr.astype(np.int16) - direct[(leg.key, p)]).max()
            fail(f"{name}: {len(bad)} returned frame(s) differ from their direct call "
                 f"(pts {p}: max {diff} levels)")
        pushed.append((len(leg.pushed) - 1) / (leg.pushed[-1] - leg.pushed[0]))
        times = [tm - t0 for _, _, tm in leg.got]
        if not times:
            continue
        firsts.append(1e3 * times[0])
        if len(times) > NATIVE_FILL:
            fps_each.append((len(times) - NATIVE_FILL) / (times[-1] - times[NATIVE_FILL - 1]))
        steps.update(t for (key, p), (_, t) in tap.rode.items()
                     if key == leg.key and p // leg.step >= NATIVE_FILL)
    steps = sorted(steps)
    step_ms = 1e3 * (steps[-1] - steps[0]) / (len(steps) - 1) if len(steps) > 1 else float("nan")
    returned = [len(leg.got) for leg in legs]
    st = metrics

    def lost(blocks):
        return [f"{b['cumulative_lost']} of {b['highest_seq'] + 1}" if b else "none received"
                for b in blocks]

    say(f"{name}: launches over {epi} bucket steps: attention {attn}, epilogue {epi}")
    say(f"{name}: {card} | frames pushed {n} x {k}, returned {returned} (pts in order, each equal "
        f"bit for bit to its direct call through the same captured bucket step) | RTP lost: "
        f"uplink (the agent's reception stats) {lost(uplink)}, downlink (the client's) "
        f"{lost(downlink)} | the agent's ring dropped {ring_drops} | NACKs {st.get('rtcp_nacks_total', 0)}, PLI "
        f"requests {[leg.pli_requests for leg in legs]}")
    say(f"{name}: {card} | first view {[round(x, 2) for x in firsts]} ms | served "
        f"{[round(x, 2) for x in fps_each]} fps (steady, past each session's {NATIVE_FILL}th "
        f"frame; aggregate {sum(fps_each):.2f}; phase 5's loopback session {loopback_fps:.2f}) | "
        f"pushed at {[round(x, 2) for x in pushed]} fps (the client's pace as achieved) | "
        f"{step_ms:.2f} ms between bucket steps over {len(steps)} | decode "
        f"{st.get('decode_p50_ms', float('nan')):.3f} / encode {st.get('encode_p50_ms', float('nan')):.3f}"
        f" / glass {st.get('glass_p50_ms', float('nan')):.2f} ms p50 | host plane (first session) "
        f"{json.dumps(stages)}")


# -- phase 9: observability --------------------------------------------------------------

OBS_FRAMES = 24  # frames viewed per session in each run
OBS_FILL = 4  # each session's first viewed frames: outside the steady window
OBS_SESSIONS = (1, 4)
OBS_STAGES = ("submit", "batch_join", "engine_step", "fetch", "postprocess")
OBS_TURNS = ("defaults", "off", "window", "window", "off", "defaults")  # 9c, A B C C B A
OBS_PLANES_OFF = {"SLO_ENABLE": 0, "DEVTEL_ENABLE": 0, "FLIGHT_RECORDER": 0}
OBS_TRACE_DIR = Path(__file__).resolve().parent / "build" / "obs-trace"
OBS_RETRACE_MIN_MS = 0  # 9b: every unblessed serve-time build is a breach


def trace_kernels(path) -> dict:
    """Kernels of a torch.profiler Chrome trace: {"attention", "epilogue",
    "kernels"} (device kernel events by name)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"attention": sum("flash_attention_kernel" in n for n in names),
            "epilogue": sum("stream_epilogue_kernel" in n for n in names),
            "kernels": len(names)}


def check_prom(text: str) -> int:
    """Parse a Prometheus text exposition as a scraper would: every sample's
    family declared by a TYPE line, histogram buckets cumulative in ``le``
    order with the +Inf terminal equal to ``_count``; -> the sample count."""
    types, hist, n = {}, {}, 0
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            if name in types:
                fail(f"obs: prom family {name} declared twice")
            types[name] = kind
            continue
        if line.startswith("#") or not line:
            continue
        head, value = line.rsplit(" ", 1)
        float(value)
        name, _, labels = head.partition("{")
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and types.get(name[: -len(suffix)]) == "histogram":
                base = name[: -len(suffix)]
        if base not in types:
            fail(f"obs: prom sample {name} has no TYPE line")
        n += 1
        if base != name:
            series = dict(kv.split("=", 1) for kv in labels.rstrip("}").split(",") if kv)
            le = series.pop("le", None)
            key = (base, tuple(sorted(series.items())))
            entry = hist.setdefault(key, {"buckets": [], "count": None})
            if name.endswith("_bucket"):
                entry["buckets"].append((le.strip('"'), float(value)))
            elif name.endswith("_count"):
                entry["count"] = float(value)
    for key, entry in hist.items():
        les = [le for le, _ in entry["buckets"]]
        counts = [c for _, c in entry["buckets"]]
        bounds = [math.inf if le == "+Inf" else float(le) for le in les]
        if not les or les[-1] != "+Inf" or bounds != sorted(bounds) or counts != sorted(counts):
            fail(f"obs: prom histogram {key} malformed: {entry['buckets']}")
        if entry["count"] != counts[-1]:
            fail(f"obs: prom histogram {key}: _count {entry['count']} != +Inf {counts[-1]}")
    return n


class ObsRun:
    """k loopback WHIP/WHEP sessions through the session layer, each fed
    OBS_FRAMES (+ the track's in-flight tail) and viewed: the viewed frames
    (the viewer's receipt seals each trace ``sent``), their arrival times."""

    def __init__(self, k):
        self.k, self.pairs, self.views, self.times = k, [], [], []

    async def run(self, np, state, size, seed, depth):
        from ai_rtc_agent_tpu_torch.obs.trace import get_trace

        def seal(frame):
            trace = get_trace(frame)
            if trace is not None:
                trace.finish("sent")

        for _ in range(self.k):
            self.pairs.append(await open_loopback_session(state))
        frames = [_frames(np, OBS_FRAMES, seed=seed + i, size=size) for i in range(self.k)]
        self.t0 = time.perf_counter()
        got = await asyncio.gather(*[
            exchange(pc, viewer, fr + fr[-1:] * (depth - 1), 0, OBS_FRAMES, on_view=seal)
            for (_, pc, _, viewer), fr in zip(self.pairs, frames)])
        self.views = [v for v, _ in got]
        self.times = [[t - self.t0 for t in ts] for _, ts in got]
        return self

    async def close(self, state):
        from ai_rtc_agent_tpu_torch.server import sessions

        for pub_id, _, view_id, _ in self.pairs:
            await sessions.close(state, "whep", view_id)
            await sessions.close(state, "whip", pub_id)

    def fps(self) -> float:
        return sum((len(t) - OBS_FILL) / (t[-1] - t[OBS_FILL - 1]) for t in self.times)

    def step_ms(self, tap) -> tuple:
        """(ms between bucket steps, steps) over the steps that carried
        each session's frames past its first OBS_FILL."""
        keys = {pub_id for pub_id, _, _, _ in self.pairs}
        t = sorted({td for (key, pts), (_, td) in tap.rode.items()
                    if key in keys and pts >= OBS_FILL})
        return (1e3 * (t[-1] - t[0]) / (len(t) - 1) if len(t) > 1 else float("nan")), len(t)


def check_timeline(trace, label):
    """A viewed frame's timeline: the scheduler's spans in order and
    non-negative, sealed ``sent``; -> {stage: ms}."""
    if trace is None or trace.terminal != "sent":
        fail(f"obs: {label}: a viewed frame without a sealed trace ({trace})")
    spans = {}
    for name, t0, t1 in trace.spans:
        if t1 < t0:
            fail(f"obs: {label}: span {name} is negative: {t0} -> {t1}")
        spans.setdefault(name, (t0, t1))
    order = [n for n, _, _ in trace.spans if n in OBS_STAGES]
    if order != list(OBS_STAGES):
        fail(f"obs: {label}: spans {[n for n, _, _ in trace.spans]}, want {OBS_STAGES} in order")
    sub, join, step, fetch, post = (spans[n] for n in OBS_STAGES)
    if not (sub[0] <= join[0] and join[1] == step[0] and step[1] == fetch[1] <= post[0]):
        fail(f"obs: {label}: spans out of order: {trace.spans}")
    return {n: 1e3 * (t1 - t0) for n, (t0, t1) in spans.items()}


def phase_obs(torch, card: str, pipe):
    """Phase 9: observability on the card (see the module docstring)."""
    import gc

    import numpy as np

    from ai_rtc_agent_tpu_torch.aot import cache as aot_cache
    from ai_rtc_agent_tpu_torch.obs import export
    from ai_rtc_agent_tpu_torch.server import sessions
    from ai_rtc_agent_tpu_torch.server.signaling import LoopbackProvider
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler
    from ai_rtc_agent_tpu_torch.utils import env

    t_phase = time.perf_counter()
    cuda = pipe.device.type == "cuda"  # False only in a CPU rehearsal
    size = pipe.config.width
    frame_bytes = size * size * 3
    depth = env.pipeline_depth()
    os.environ["WARMUP_FRAMES"] = "0"  # read where each session's track is made
    os.environ["DROP_FRAMES"] = "0"
    gc.collect()  # earlier phases' graph caches leave the inventory
    sched = BatchScheduler.from_pipeline(pipe, max_sessions=max(OBS_SESSIONS))
    tap = StepTap(sched)
    attn_total = epi_total = 0

    async def start(extra_env=None):
        state = {}
        with _Env(**(extra_env or {})):
            sessions.configure(state, model_id=pipe.model_id, pipeline=pipe,
                               provider=LoopbackProvider(), batch_scheduler=sched)
            await sessions.startup(state)
        return state

    async def stop(state):
        state["batch_scheduler"] = None  # the next turn serves it again
        await sessions.shutdown(state)

    # -- 9a: a traced serve -----------------------------------------------------------
    async def traced():
        nonlocal attn_total, epi_total
        state = await start()
        plane = state["devtel"]
        if plane is None or state["slo"] is None or state["flight"] is None:
            fail("obs: the planes are not on by default")
        reply = await sessions.debug_trace(state, {"action": "start", "duration_s": 600,
                                                   "jax_profiler_dir": str(OBS_TRACE_DIR)})
        body = json.loads(reply.body)
        if reply.status != 200 or body.get("jax_profiler") != f"tracing to {OBS_TRACE_DIR}":
            fail(f"obs: /debug/trace start answered {reply.status} {reply.body}")
        await asyncio.sleep(TRACE_SETTLE_S)  # the window opens on an idle card (kernel_trace)
        steps0, launches0 = sched.steps_total, _launches()
        runs, results = [], {}
        for k in OBS_SESSIONS:
            run = await ObsRun(k).run(np, state, size, 900 + 10 * k, depth)
            runs.append(run)
            stages = {}
            for s, views in enumerate(run.views):
                for i, vf in enumerate(views):
                    if vf.pts != i or vf.to_ndarray().shape != (size, size, 3):
                        fail(f"obs: k={k} session {s}: frame {i} has pts {vf.pts}")
                    for n, ms in check_timeline(vf.trace, f"k={k} session {s} frame {i}").items():
                        stages.setdefault(n, []).append(ms)
            pub_id = run.pairs[0][0]
            reply = sessions.debug_flight(state, {"session": pub_id, "format": "chrome"})
            doc = json.loads(reply.body)
            tracks = {e["args"]["name"].split(" #")[0] for e in doc["traceEvents"]
                      if e["ph"] == "M" and e["name"] == "thread_name"}
            xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
            if not set(OBS_STAGES) <= tracks or not xs or any(
                    not {"ph", "ts", "dur"} <= set(e) or e["dur"] < 0 for e in xs):
                fail(f"obs: k={k}: the Chrome rendering lacks a stage track or ph/ts/dur: "
                     f"{sorted(tracks)}")
            results[k] = (stages, run.step_ms(tap), run.fps(), len(xs))
            await run.close(state)
        # the window closes on an idle card: each session's tail frame may
        # still be stepping after its close
        last = -1
        while sched.steps_total != last:
            last = sched.steps_total
            await asyncio.sleep(0.3)
        _sync(torch, pipe.device)
        steps = sched.steps_total - steps0
        attn, epi = _launches()
        launches = (attn - launches0[0], epi - launches0[1])
        attn_total += launches[0]
        epi_total += launches[1]
        reply = await sessions.debug_trace(state, {"action": "stop"})
        if reply.status != 200 or "jax_profiler" in json.loads(reply.body):
            fail(f"obs: /debug/trace stop answered {reply.status} {reply.body}")
        prom = sessions.metrics_reply(state, "prom")
        samples = check_prom(prom.body)
        metrics = sessions.metrics(state)
        submitted = sum(sess.frames_submitted for sess in tap.sessions.values())
        fetched = len(tap.rode)
        _sync(torch, pipe.device)
        before = torch.cuda.memory_allocated() if cuda else 0
        plane.sample_memory(force=True)
        after = torch.cuda.memory_allocated() if cuda else 0
        snap = plane.snapshot()
        graphs = (sum(len(c.steps()) for c in list(aot_cache._LIVE)),
                  sum(pipe.engine.graph_cache.status().values()),
                  sum(sched.graph_status().values()))
        health = sessions.health(state)
        await stop(state)
        return (results, steps, launches, prom, samples, metrics, submitted, fetched, before, after,
                snap, graphs, health)

    (results, steps, (attn, epi), prom, samples, metrics, submitted, fetched, before, after, snap,
     graphs, health) = asyncio.run(traced())
    counts = trace_kernels(export.last_trace_path)
    say(f"obs 9a: {card} | torch.profiler trace {export.last_trace_path} "
        f"({os.path.getsize(export.last_trace_path) / 2**20:.1f} MiB): {counts['kernels']} kernels, "
        f"attention {counts['attention']}, epilogue {counts['epilogue']} over {steps} bucket steps "
        f"(launches counted: {attn}, {epi})")
    if (attn, epi) != (32 * steps, steps) or cuda and (
            counts["attention"], counts["epilogue"]) != (32 * steps, steps):
        fail("obs: the profiler trace must hold 32 attention and 1 epilogue kernels a bucket step")
    if (metrics["devtel_h2d_bytes_total"], metrics["devtel_d2h_bytes_total"]) != (
            submitted * frame_bytes, fetched * frame_bytes):
        fail(f"obs: H2D/D2H bytes {metrics['devtel_h2d_bytes_total']}/"
             f"{metrics['devtel_d2h_bytes_total']}, want {submitted} and {fetched} frames")
    if metrics["aot_cache_entries"] != graphs[0] or cuda and graphs[2] != len(sched.bucket_keys()):
        fail(f"obs: aot_cache_entries {metrics['aot_cache_entries']}; steps held by the live "
             f"caches, the pipeline's and the scheduler's graphs {graphs}")
    if cuda and not min(before, after) <= snap["device_mem_bytes_in_use"] <= max(before, after):
        fail(f"obs: device_mem_bytes_in_use {snap['device_mem_bytes_in_use']} outside "
             f"[{before}, {after}]")
    if metrics.get("retrace_breaches_total", 0) or metrics["devtel_serving_compiles_total"]:
        fail(f"obs: a serve-time build while serving steadily: {health['devtel']}")
    say(f"obs 9a: {card} | H2D {metrics['devtel_h2d_bytes_total']} B ({submitted} frames), D2H "
        f"{metrics['devtel_d2h_bytes_total']} B ({fetched} frames) | aot_cache_entries "
        f"{metrics['aot_cache_entries']} (the pipeline's graph {graphs[1]}, the scheduler's "
        f"{graphs[2]}), aot_cache_bytes "
        f"{metrics['aot_cache_bytes']}, hits {metrics['aot_cache_hits_total']} | device memory in "
        f"use {snap.get('device_mem_bytes_in_use')} (memory_allocated {before}, {after}), peak "
        f"{snap.get('device_mem_peak_bytes_in_use')}, limit {snap.get('device_mem_bytes_limit')}, "
        f"live buffers {snap['device_live_buffers']} | prom: {samples} samples parsed | breaches 0 | "
        f"SLO over budget / frames {json.dumps({k: [v['over'], v['count']] for k, v in metrics['slo_stages'].items()})}")
    for k, (stages, (step_ms, n_steps), fps, n_x) in results.items():
        p50 = {n: round(_median(v), 3) for n, v in stages.items()}
        say(f"obs 9a k={k}: {card} | stage p50 ms {json.dumps(p50)} | {step_ms:.2f} ms between "
            f"bucket steps over {n_steps} | served {fps:.2f} fps | {n_x} spans rendered")

    # -- 9b: a serve-time capture ---------------------------------------------------------
    sched_b = BatchScheduler.from_pipeline(pipe, max_sessions=2, prewarm=False)
    with sched_b._step_lock:  # its "prewarm" leaves out bucket 1
        sched_b._warm_shards(sched_b._shards, 2, "full")
    key = sched_b.bucket_keys()[(1, "full")]

    posted = []

    class Sink:  # the webhook endpoint, in process
        async def post(self, url, headers=None, json=None):
            posted.append(json)
            return type("Resp", (), {"status": 200})()

    async def breach():
        state = {}
        # the plane's threshold at 0 ms: a bucket's capture takes 0.2-0.7 s on
        # the card, so at the 250 ms default whether it breaches is the clock's
        with _Env(DEVTEL_RETRACE_MIN_MS=OBS_RETRACE_MIN_MS):
            sessions.configure(state, model_id=pipe.model_id, pipeline=pipe,
                               provider=LoopbackProvider(), batch_scheduler=sched_b)
            await sessions.startup(state)
        handler = state["stream_event_handler"]
        handler.webhook_url, handler.token = "http://127.0.0.1/sink", "tok"
        handler._session_factory = Sink
        try:
            run = await ObsRun(1).run(np, state, size, 990, depth)
            pub_id = run.pairs[0][0]
            for _ in range(200):
                if any(p.get("state") == "RETRACE_BREACH" for p in posted):
                    break
                await asyncio.sleep(0.01)
            events = [e for e in state["flight"].session(pub_id).events if e["kind"] == "retrace"]
            metrics = sessions.metrics(state)
            prom = sessions.metrics_reply(state, "prom").body
            plane = state["devtel"]
            await run.close(state)
            return events, metrics, prom, plane.last_breach, plane.retrace_breaches
        finally:
            await sessions.shutdown(state)

    launches0 = _launches()
    events, metrics, prom, last, n_breach = asyncio.run(breach())
    attn, epi = _launches()
    attn_total += attn - launches0[0]
    epi_total += epi - launches0[1]
    hooks = [p for p in posted if p.get("state") == "RETRACE_BREACH"]
    if (n_breach != 1 or len(events) != 1 or len(hooks) != 1
            or metrics.get("retrace_breaches_total") != 1
            or metrics["devtel_serving_compiles_total"] != 1
            or "retrace_breaches_total 1" not in prom.splitlines()):
        fail(f"obs 9b: want exactly one breach on each surface: plane {n_breach}, events "
             f"{events}, webhooks {hooks}, retrace_breaches_total "
             f"{metrics.get('retrace_breaches_total')}, serve-time builds "
             f"{metrics['devtel_serving_compiles_total']}")
    if events[0]["context"] != key or key not in hooks[0]["reason"] or last["context"] != key:
        fail(f"obs 9b: the breach is not attributed to bucket 1's key {key}: {events[0]}")
    say(f"obs 9b: {card} | one serve-time capture of bucket 1 at dispatch, a session live: "
        f"{last['duration_ms']:.1f} ms (DEVTEL_RETRACE_MIN_MS={OBS_RETRACE_MIN_MS}), attributed "
        f"to {key}; the only serve-time build; one RETRACE_BREACH on the flight "
        f"recorder, the webhook ({hooks[0]['reason']!r}) and retrace_breaches_total (JSON and "
        f"prom) | graph-cache builds {metrics['aot_cache_builds_total']}, captures "
        f"{sum(sched_b.graph_status().values())} of {len(sched_b.graph_status())} buckets")
    sched_b.close()

    # -- 9c: what the planes cost --------------------------------------------------------
    async def turn(setting):
        nonlocal attn_total, epi_total
        state = await start(OBS_PLANES_OFF if setting == "off" else None)
        if (state["devtel"] is None) != (setting == "off"):
            fail(f"obs 9c: setting {setting} did not take")
        if setting == "window":
            await sessions.debug_trace(state, {"action": "start", "duration_s": 600})
        out = {}
        try:
            for k in OBS_SESSIONS:
                before = _launches()
                run = await ObsRun(k).run(np, state, size, 950 + 10 * k, depth)
                after = _launches()
                attn_total += after[0] - before[0]
                epi_total += after[1] - before[1]
                out[k] = (run.step_ms(tap)[0], run.fps())
                await run.close(state)
        finally:
            if setting == "window":
                await sessions.debug_trace(state, {"action": "stop"})
            await stop(state)
        return out

    cost = {setting: [] for setting in set(OBS_TURNS)}
    for setting in OBS_TURNS:
        cost[setting].append(asyncio.run(turn(setting)))
    sched.close()
    for k in OBS_SESSIONS:
        say(f"obs 9c k={k}: {card} | ms between bucket steps / served fps, {len(OBS_TURNS)} turns "
            f"({', '.join(OBS_TURNS)}): " + "; ".join(
                f"{setting} {[f'{r[k][0]:.2f} ms / {r[k][1]:.2f} fps' for r in cost[setting]]}"
                for setting in ("defaults", "off", "window")))
    say(f"obs: phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return attn_total, epi_total


# -- phase 10: sessions that move ------------------------------------------------------

MOVE_FRAMES = 24  # 10a: frames streamed before and after the move
EVAC_FRAMES = 8  # 10b: frames on A before the trip, and on B after the move
RECYCLE_FRAMES = 8  # 10c: frames after the restart in place
RESIDENT_FRAMES = 4  # 10a: the resident session's frames before and after the import
FLEET_PORTS = {"A": 18101, "B": 18102}  # in-process agents: the base URLs' keys, never bound


class _RouterPoster:
    """An agent's webhook sender into the in-process router's /fleet/events
    (the card's machine has no aiohttp)."""

    def __init__(self, router: dict):
        self.router = router

    def __call__(self):
        return self

    async def post(self, url, headers=None, json=None):
        from ai_rtc_agent_tpu_torch.fleet import routing

        return await routing.handle(self.router, "POST", "/fleet/events", headers=headers,
                                    body=json)


class _ClientSink:
    """The clients' notification endpoint: the router's webhooks land here,
    stamped with the host clock."""

    status = 200

    def __init__(self):
        self.events = []

    def __call__(self):
        return self

    async def post(self, url, headers=None, json=None):
        self.events.append((json, time.perf_counter()))
        return self

    def of(self, name: str, state: str | None = None) -> list:
        return [e for e, _ in self.events
                if e.get("event") == name and (state is None or e.get("state") == state)]


class _LocalRouter:
    """The router's core behind a stdlib HTTP server on 127.0.0.1 (an agent's
    self-evacuation is an HTTP POST to EVACUATE_URL): each request runs on
    the phase's event loop; the arrival times are kept."""

    def __init__(self, router: dict, loop):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qsl, urlsplit

        from ai_rtc_agent_tpu_torch.fleet import routing

        self.arrivals = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                outer.arrivals.append((self.path, time.perf_counter()))
                parts = urlsplit(self.path)
                body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                reply = asyncio.run_coroutine_threadsafe(routing.handle(
                    router, "POST", parts.path, query=dict(parse_qsl(parts.query)),
                    headers=dict(self.headers), body=body), loop).result(60)
                data = reply.body.encode() if isinstance(reply.body, str) else reply.body or b""
                self.send_response(reply.status)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(10)


def _timed(obj, name: str, log: list):
    """Wrap ``obj.name`` to append (result, ms on the host clock) to ``log``."""
    fn = getattr(obj, name)

    def wrapper(*a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        log.append((out, (time.perf_counter() - t) * 1e3))
        return out

    setattr(obj, name, wrapper)


def _state_bytes(snap: dict) -> bytes:
    import base64

    return base64.b64decode(snap["state_b64"])


def _row_of(snap: dict, device=None) -> dict:
    """A snapshot's state row (on ``device``, else the host)."""
    from ai_rtc_agent_tpu_torch.parallel.checkpoint import deserialize_pytree
    from ai_rtc_agent_tpu_torch.tree import tree_map

    row = deserialize_pytree(_state_bytes(snap))
    return row if device is None else tree_map(lambda a: a.to(device), row)


def _same_frames(np, got, want) -> bool:
    return len(got) == len(want) and all(np.array_equal(np.asarray(a), np.asarray(b))
                                         for a, b in zip(got, want))


def phase_fleet(torch, card: str, pipe, ref_bundle):
    """10a live migration, 10b evacuation from the engine guard's bank, 10c
    restart in place: port agents (server/sessions.py app-states, each a
    4-slot graph scheduler under the guard) behind the router's core
    (fleet/routing.py) in this process.  -> the attention and epilogue
    launches of the steps it drove."""
    # sessions sit idle between the sub-phases: the output-age watchdog
    # (phase 7's subject) would degrade them, and a StreamDegraded webhook
    # marks their agent DEGRADED at the router, no migration target
    with _Env(WARMUP_FRAMES=0, DROP_FRAMES=0, FLEET_POLL_S=3600, ENGINE_SNAPSHOT_EVERY_S=1e-6,
              ENGINE_REBUILD_MAX_ATTEMPTS=1, ENGINE_REBUILD_BACKOFF_S=0.05, AUTH_TOKEN="t",
              RECYCLE_EXIT_DELAY_S=0.05, WORKER_ID="A", SUPERVISOR_STALL_AFTER_S=600):
        return asyncio.run(fleet_run(torch, card, pipe, ref_bundle))


async def fleet_run(torch, card, pipe, ref_bundle):
    import gc
    import weakref

    import numpy as np

    from ai_rtc_agent_tpu_torch.fleet import routing
    from ai_rtc_agent_tpu_torch.fleet.transport import InProcessTransport
    from ai_rtc_agent_tpu_torch.resilience import faults
    from ai_rtc_agent_tpu_torch.server import lifecycle
    from ai_rtc_agent_tpu_torch.server import sessions as SL
    from ai_rtc_agent_tpu_torch.server.events import StreamEventHandler
    from ai_rtc_agent_tpu_torch.server.signaling import LoopbackProvider, make_loopback_offer
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler
    from ai_rtc_agent_tpu_torch.tree import tree_equal

    loop = asyncio.get_running_loop()
    eng, dev, size = pipe.engine, pipe.device, pipe.config.height
    depth = int(os.environ.get("PIPELINE_DEPTH", "2"))
    sdp = {"Content-Type": "application/sdp"}
    clients = _ClientSink()
    transport = InProcessTransport()
    R = routing.configure({}, events_handler=StreamEventHandler(
        session_factory=clients, webhook_url="inproc://clients", token="t"), transport=transport)
    await routing.startup(R)
    local = _LocalRouter(R, loop)
    scheds, deds, agents = [], [], {}

    def steps() -> int:
        return sum(s.steps_total for s in scheds) + sum(len(d.outs) for d in deds)

    def count(before, steps0, label):
        n = steps() - steps0
        a, e = (x - y for x, y in zip(_launches(), before))
        say(f"fleet {label}: launches over {n} steps: attention {a}, epilogue {e}")
        if a != 32 * n or e != n:
            fail(f"fleet {label}: expected {32 * n} attention and {n} epilogue launches")
        return a, e

    def scheduler():
        s = BatchScheduler.from_pipeline(pipe, max_sessions=4)
        scheds.append(s)
        return s

    async def agent(name, sched):
        st = {}
        SL.configure(st, model_id=pipe.model_id, pipeline=pipe, provider=LoopbackProvider(),
                     batch_scheduler=sched, events_handler=StreamEventHandler(
                         session_factory=_RouterPoster(R), webhook_url="inproc://router",
                         token="t"))
        await SL.startup(st)
        url = f"http://127.0.0.1:{FLEET_PORTS[name]}"
        transport.add(url, st)
        r = await routing.handle(R, "POST", "/fleet/register", body={
            "worker_id": name, "public_ip": "127.0.0.1", "public_port": str(FLEET_PORTS[name]),
            "status": "ready", "capacity": 4, "boot_id": st["boot_id"]})
        if r.status != 200:
            fail(f"fleet: registering {name} answered {r.status} {r.body!r}")
        agents[name] = st
        return st

    async def poll():
        await R["poller"].poll_once()

    def owner(sid):
        return R["session_table"].owner(sid)

    async def place(kind, headers=None, video=True):
        offer = make_loopback_offer() if video else make_loopback_offer(video=False,
                                                                          datachannel=False)
        r = await routing.handle(R, "POST", f"/{kind}", headers={**sdp, **(headers or {})},
                                 body=offer)
        if r.status != 201:
            fail(f"fleet: {kind} through the router answered {r.status} {r.body!r}")
        sid = r.headers["Location"].rsplit("/", 1)[1]
        return sid, r.headers

    async def publisher(headers=None):
        sid, h = await place("whip", headers)
        st = agents[owner(sid)]
        return sid, h, st["state"]["whip_pcs"][sid]

    async def viewer():
        vid, _ = await place("whep", video=False)
        st = agents[owner(vid)]
        return vid, st["state"]["whep_pcs"][vid].out_tracks[0]

    async def close(kind, sid):
        r = await routing.handle(R, "DELETE", f"/{kind}/{sid}")
        if r.status != 200:
            fail(f"fleet: DELETE /{kind}/{sid} answered {r.status}")

    async def stream(sched, pub_pc, view, frames, first_pts):
        """Push ``frames`` (and the depth - 1 behind the last that bring it
        out) through a publisher; -> the viewed frames, their times, and
        once every pushed frame has stepped."""
        pushed = frames + frames[-1:] * (depth - 1)
        s0 = sched.steps_total
        got, times = await exchange(pub_pc, view, pushed, first_pts, len(frames))
        await asyncio.to_thread(_wait_for, lambda: sched.steps_total >= s0 + len(pushed), 30.0,
                                "the pushed frames' steps", "fleet")
        return [vf.to_ndarray() for vf in got], times, pushed

    async def migrated(sid, n=1):
        await asyncio.to_thread(_wait_for, lambda: len([e for e in clients.of("StreamMigrated")
                                                        if e["stream_id"] == sid]) >= n, 60.0,
                                f"StreamMigrated for {sid}", "fleet")
        return [e for e in clients.of("StreamMigrated") if e["stream_id"] == sid][-1]

    def hold(label, got, ref_sess, frames, row):
        """Against ``ref_sess`` (the same snapshot restored into another
        scheduler at the same slot) stepping the same frames, bit for bit or
        not; and always phase 4's criterion against a dedicated engine fed
        ``row`` eagerly (a restore that rebound a leaf would leave both
        schedulers' replays on stale storage, alike)."""
        want = [ref_sess(f) for f in frames]
        ded = Dedicated(torch, eng.models, eng.params, pipe.config, eng.encode_prompt, ref_bundle,
                        row, dev)
        deds.append(ded)
        for f in frames[:len(got)]:
            ded(f)
        criterion = hold_to_references(np, label, got, ded)
        if _same_frames(np, got, want[:len(got)]):
            return f"bit for bit with the reference scheduler; phase 4's criterion: {criterion}"
        diff = max(int(np.abs(np.asarray(a, np.int16) - np.asarray(b)).max())
                   for a, b in zip(got, want))
        return (f"not bit for bit (max {diff} levels from the reference scheduler); phase 4's "
                f"criterion held: {criterion}")

    # every input made before the agents start: a loop blocked for seconds
    # reads as loop lag to the overload plane, which then refuses sessions
    res_frames = _frames(np, 2 * RESIDENT_FRAMES, seed=600, size=size)
    frames = _frames(np, MOVE_FRAMES, seed=610, size=size)
    frames3 = _frames(np, 2 * EVAC_FRAMES, seed=620, size=size)
    frames5 = _frames(np, RECYCLE_FRAMES, seed=630, size=size)
    launches = [0, 0]

    def add(pair):
        launches[0] += pair[0]
        launches[1] += pair[1]

    try:
        # -- 10a: live migration ------------------------------------------------
        t = time.perf_counter()
        A = await agent("A", scheduler())
        B = await agent("B", scheduler())
        schedA, schedB = A["batch_scheduler"], B["batch_scheduler"]
        ref_sched = scheduler()  # the references: rows restored from the same snapshots
        ref_sched.claim("filler", prompt=SESSION_PROMPTS[1], seed=500)
        say(f"fleet: two agents up in {time.perf_counter() - t:.2f} s, buckets captured (s) "
            f"A {capture_seconds(schedA)}, B {capture_seconds(schedB)}")
        before, s0 = _launches(), steps()
        res = schedB.claim("resident", prompt=SESSION_PROMPTS[1], seed=500)
        res_row = session_row(schedB.states, res.slot)
        res_ded = Dedicated(torch, eng.models, eng.params, pipe.config, eng.encode_prompt,
                            ref_bundle, res_row, dev)
        res_out = await asyncio.to_thread(lambda: [res(f) for f in res_frames[:RESIDENT_FRAMES]])
        await poll()
        sid, h, pub = await publisher()
        jid = h["X-Journey-Id"]
        vid, view = await viewer()
        if (owner(sid), owner(vid)) != ("A", "A"):
            fail(f"fleet 10a: placed on {owner(sid)}, viewer on {owner(vid)} (want A, A)")
        on_a, times_a, _ = await stream(schedA, pub, view, frames, 0)
        exports, imports = [], []
        _timed(schedA, "snapshot_session", exports)
        _timed(schedB, "restore_session", imports)
        res_before = session_row(schedB.states, res.slot)
        await close("whep", vid)  # the viewer re-subscribes after the move
        await poll()
        r = await routing.handle(R, "POST", "/fleet/drain", query={"agent": "A",
                                                                    "mode": "migrate"})
        body = json.loads(r.body)
        if r.status != 200 or body["migrating"] != 1:
            fail(f"fleet 10a: drain answered {r.status} {body}")
        ev = await migrated(sid)
        res_unmoved = tree_equal(session_row(schedB.states, res.slot), res_before)
        if not res_unmoved:
            fail("fleet 10a: the import moved the resident session's row")
        snap = exports[-1][0]
        raw, b64 = len(_state_bytes(snap)), len(snap["state_b64"])
        sid2, h2, pub2 = await publisher({"X-Journey-Id": jid})
        if (owner(sid2), h2["X-Journey-Leg"], B["imported_sessions"]) != ("B", "2", {}):
            fail(f"fleet 10a: the re-offer landed on {owner(sid2)} leg {h2['X-Journey-Leg']}, "
                 f"parked {list(B['imported_sessions'])}")
        adopted = await SL.migrate_export(B, {"session": sid2})
        if _state_bytes(json.loads(adopted.body)) != _state_bytes(snap):
            fail("fleet 10a: the adopted session's row is not the exported row byte for byte")
        r = await routing.handle(R, "GET", f"/fleet/debug/journey/{jid}")
        bundle = json.loads(r.body)
        live = sorted(f["agent"] for f in bundle["fragments"] if f["source"] == "live")
        legs = [leg["agent"] for leg in bundle["journey"]["legs"]]
        if r.status != 200 or live != ["A", "B"] or legs != ["A", "B"]:
            fail(f"fleet 10a: the journey bundle has fragments {live}, legs {legs}")
        await close("whip", sid)
        vid2, view2 = await viewer()
        on_b, times_b, pushed_b = await stream(schedB, pub2, view2, frames, MOVE_FRAMES + depth)
        res_out += await asyncio.to_thread(lambda: [res(f) for f in res_frames[RESIDENT_FRAMES:]])
        ref = await asyncio.to_thread(ref_sched.restore_session, snap, "reference")
        if ref.slot != schedB.session(sid2).slot:
            fail(f"fleet 10a: the reference row sits at slot {ref.slot}, the moved one at "
                 f"{schedB.session(sid2).slot}")
        held = await asyncio.to_thread(hold, "10a moved session", on_b, ref, pushed_b,
                                       _row_of(snap, dev))
        deds.append(res_ded)
        await asyncio.to_thread(lambda: [res_ded(f) for f in res_frames])
        res_held = hold_to_references(np, "10a resident session", res_out, res_ded)
        add(count(before, s0, "10a"))
        say(f"fleet 10a live migration: {card} | session {sid[:8]} (journey {jid[:8]}) "
            f"{MOVE_FRAMES} frames on A, drain mode=migrate -> StreamMigrated {ev['source_agent']}"
            f" -> {ev['target_agent']} ({ev['reason']}), the re-offer adopted on B as leg 2 | "
            f"snapshot {raw} B raw, {b64} B base64; export {exports[-1][1]:.2f} ms, import "
            f"{imports[-1][1]:.2f} ms (host clock) | last frame from A -> first from B "
            f"{(times_b[0] - times_a[-1]) * 1e3:.1f} ms (with the re-offer and the viewer's "
            f"re-subscribe) | moved frames: {held} | resident row unchanged by the import byte for"
            f" byte; resident frames: {res_held} | journey bundle: live fragments from {live}")

        # -- 10b: evacuation from the bank ------------------------------------------
        before, s0 = _launches(), steps()
        r = await routing.handle(R, "POST", "/fleet/drain", query={"agent": "A",
                                                                    "action": "cancel"})
        await close("whep", vid2)
        await poll()
        sid3, h3, pub3 = await publisher()
        jid3 = h3["X-Journey-Id"]
        vid3, view3 = await viewer()
        if (owner(sid3), owner(vid3)) != ("A", "A"):
            fail(f"fleet 10b: placed on {owner(sid3)}, viewer on {owner(vid3)} (want A, A)")
        await stream(schedA, pub3, view3, frames3[:EVAC_FRAMES], 0)
        sess3 = schedA.session(sid3)
        last_rows = session_row(schedA.states, sess3.slot)  # the bank refreshes after every step
        guard = A["engine_guard"]
        events = []
        fire = A["stream_event_handler"].handle_engine_state

        def record(event, st, reason="", **extra):
            events.append((event, time.perf_counter()))
            return fire(event, st, reason=reason, **extra)

        def refuse(*a, **k):
            raise RuntimeError("device still gone (injected)")

        A["stream_event_handler"].handle_engine_state = record
        os.environ["EVACUATE_URL"] = f"{local.url}/fleet/evacuate"
        schedA.rebuild_engine = refuse
        schedA._fault_scope = _inject(faults, "device_lost")
        t_trip = time.perf_counter()
        try:
            out = await asyncio.to_thread(lambda: sess3.fetch(sess3.submit(frames3[0])))
        except Exception as e:  # noqa: BLE001 - the tripping step's own error
            out = e
        ev3 = await migrated(sid3)
        schedA._fault_scope = None
        faults.deactivate()
        banked = schedA._quarantine_snaps.get(sid3)
        if guard.state not in ("EVACUATING", "FAILED") or banked is None:
            fail(f"fleet 10b: guard {guard.state}, banked {banked is not None}")
        if not tree_equal(_row_of(banked), _to_cpu(last_rows)):
            fail("fleet 10b: the banked row is not the row A held at its last refresh")
        t_request = next(t for p, t in local.arrivals if p.startswith("/fleet/evacuate"))
        sid4, h4, pub4 = await publisher({"X-Journey-Id": jid3})
        if (owner(sid4), h4["X-Journey-Leg"]) != ("B", "2"):
            fail(f"fleet 10b: the re-offer landed on {owner(sid4)} leg {h4['X-Journey-Leg']}")
        vid4, view4 = await viewer()
        on_b4, times_b4, pushed_b4 = await stream(schedB, pub4, view4, frames3[EVAC_FRAMES:],
                                                  0)
        ref4 = await asyncio.to_thread(ref_sched.restore_session, banked, "reference-evac")
        if ref4.slot != schedB.session(sid4).slot:
            fail(f"fleet 10b: the reference row sits at slot {ref4.slot}, the moved one at "
                 f"{schedB.session(sid4).slot}")
        held4 = await asyncio.to_thread(hold, "10b evacuated session", on_b4, ref4, pushed_b4,
                                        _row_of(banked, dev))
        names = [e for e, _ in events]
        add(count(before, s0, "10b"))
        t_degraded = next(t for e, t in events if e == "EngineDegraded")
        say(f"fleet 10b evacuation: {card} | device_lost with 1 rebuild attempt (refused): "
            f"engine webhooks {names}, guard {guard.state}; the router's /fleet/evacuate "
            f"migrate-placed {sid3[:8]} from the bank on {ev3['target_agent']} "
            f"({ev3['reason']}) | trip -> EngineDegraded {(t_degraded - t_trip) * 1e3:.1f} ms -> "
            f"evacuation request {(t_request - t_trip) * 1e3:.1f} ms -> first frame on B "
            f"{(times_b4[0] - t_trip) * 1e3:.1f} ms | banked row = A's rows at its last refresh "
            f"byte for byte; the tripping step: {type(out).__name__} | frames after the move: "
            f"{held4}")

        # -- 10c: restart in place -------------------------------------------------
        res.release()
        await close("whep", vid4)
        handoff = str(Path("build") / "phase10-handoff.json")
        os.environ["RECYCLE_HANDOFF"] = handoff
        wrote, done = [], threading.Event()
        write = lifecycle.write_handoff

        def timed_write(*a, **kw):
            t = time.perf_counter()
            write(*a, **kw)
            wrote.append((time.perf_counter() - t) * 1e3)

        def exit_in_process(app, respawn, path):
            asyncio.run_coroutine_threadsafe(SL.shutdown(app), loop).result(120)
            done.set()
            return True

        mem0 = _memory(torch, dev.type == "cuda")
        lifecycle.write_handoff = timed_write
        B["recycle_exit"] = exit_in_process
        try:
            t = time.perf_counter()
            r = await SL.admin_recycle(B, {"respawn": True})
            recycle_ms = (time.perf_counter() - t) * 1e3
        finally:
            lifecycle.write_handoff = write
        body = json.loads(r.body)
        if (r.status, body["sessions"]) != (202, 2):
            fail(f"fleet 10c: /admin/recycle answered {r.status} {body}")
        handoff_bytes = os.path.getsize(handoff)
        with open(handoff) as f:
            written = {e["session"]: e for e in json.load(f)["sessions"]}
        await asyncio.to_thread(_wait_for, lambda: done.is_set() and not B["recycle_tasks"],
                                120.0, "the recycled agent's shutdown", "fleet")
        # the old plane goes before the replacement's pools grow
        transport.remove(f"http://127.0.0.1:{FLEET_PORTS['B']}")
        scheds.remove(schedB)
        agents.pop("B")
        old = weakref.ref(schedB)
        imports.clear()
        del schedB, B, res, pub2, view2, pub4, view4
        gc.collect()
        if old() is not None:
            fail(f"fleet 10c: the recycled agent's scheduler is still referenced "
                 f"({len(gc.get_referrers(old()))} referrers)")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        mem1 = _memory(torch, dev.type == "cuda")
        t_start = time.perf_counter()
        sched2 = scheduler()
        t_captured = time.perf_counter()
        restores = []
        _timed(sched2, "restore_session", restores)
        B2 = await agent("B", sched2)
        t_healthy = time.perf_counter()
        before, s0 = _launches(), steps()
        if os.path.exists(handoff):
            fail("fleet 10c: the replacement did not consume the handoff")
        await poll()
        await asyncio.to_thread(_wait_for, lambda: len(clients.of(
            "StreamDegraded", "AGENT_RECYCLED")) >= 2, 30.0, "AGENT_RECYCLED re-points", "fleet")
        by_stream = {e["stream_id"]: e for e in clients.of("StreamDegraded", "AGENT_RECYCLED")}
        if set(by_stream) != set(written):
            fail(f"fleet 10c: AGENT_RECYCLED for {sorted(by_stream)}, handoff {sorted(written)}")
        order = [s for s in written if s != sid2] + [sid2]  # the 10a session last: the viewer's
        moved = {}
        for old in order:
            new, hh, pp = await publisher({"X-Journey-Id": by_stream[old]["journey_id"]})
            if owner(new) != "B":
                fail(f"fleet 10c: the re-offer of {old[:8]} landed on {owner(new)}")
            got = await SL.migrate_export(B2, {"session": new})
            if _state_bytes(json.loads(got.body)) != _state_bytes(written[old]["snapshot"]):
                fail(f"fleet 10c: {old[:8]}'s export after the restart is not the handoff's row")
            moved[old] = (new, pp)
        if B2["imported_sessions"]:
            fail(f"fleet 10c: parked imports left {list(B2['imported_sessions'])}")
        new, pp = moved[sid2]
        vid5, view5 = await viewer()
        on_b2, _, pushed5 = await stream(sched2, pp, view5, frames5, 0)
        held5 = await asyncio.to_thread(hold, "10c restarted session", on_b2, ref, pushed5,
                                        _row_of(written[sid2]["snapshot"], dev))
        add(count(before, s0, "10c"))
        mem2 = _memory(torch, dev.type == "cuda")
        say(f"fleet 10c restart in place: {card} | /admin/recycle of B (2 sessions) answered 202 "
            f"in {recycle_ms:.1f} ms (handoff write {wrote[0]:.2f} ms, {handoff_bytes} B); "
            f"the old plane shut down and its scheduler collected (allocated {mem0[0]} -> "
            f"{mem1[0]} B, reserved {mem0[1]} -> {mem1[1]} B) | "
            f"replacement start -> healthy {(t_healthy - t_start) * 1e3:.1f} ms: captures "
            f"{(t_captured - t_start) * 1e3:.1f} ms (buckets {capture_seconds(sched2)} s), "
            f"imports {sum(ms for _, ms in restores):.2f} ms for {len(restores)} | "
            f"AGENT_RECYCLED x{len(by_stream)}, the re-offers adopted, each export = the "
            f"handoff's row byte for byte | frames after: {held5} | allocated now {mem2[0]} B, "
            f"peak {mem2[2]} B")
        for name, st in agents.items():
            breaches = SL.metrics(st).get("retrace_breaches_total", 0)
            if breaches:
                fail(f"fleet: agent {name} had {breaches} serve-time capture(s)")
    finally:
        faults.deactivate()
        os.environ.pop("EVACUATE_URL", None)
        os.environ.pop("RECYCLE_HANDOFF", None)
        local.close()
        for st in list(agents.values()):
            await SL.shutdown(st)
        await routing.cleanup(R)
        for s in scheds:
            s.close()
    return tuple(launches)


# -- phase 11: the broadcast plane --------------------------------------------------------

BROADCAST_AUDIENCES = (1, 4, 16)  # 11a: viewers of one publisher
BROADCAST_AB = ("group", "dedicated", "dedicated", "group")  # 11a at V=4, ABBA
BROADCAST_AB_V = 4
BROADCAST_FRAMES = 16  # frames the publisher pushes in each run, at 30 fps
BROADCAST_REASSEMBLE = 2  # viewers that reassemble frames; the rest count and hash datagrams
BROADCAST_RCVBUF = 32 << 20  # each viewer socket's receive buffer (the viewers' process)
BROADCAST_QUIET_S = 0.3  # the viewers' process: this long without a datagram ends a run
EDGE_FRAMES = 8  # 11b: frames pushed through the owner
EDGE_PORTS = {"A": 18111, "B": 18112}  # 11b: the in-process agents' base URLs, never bound


def broadcast_viewers(spec: dict):
    """``python3 chip_smoke.py --broadcast-viewers SPEC``: phase 11's viewers
    in a process of their own (no CUDA; the receive path's Python must not
    share the agent's loop).  One JSON command a line on stdin, one JSON
    answer a line on stdout:
      {"cmd": "open", "n": N}      N UDP sockets on 127.0.0.1 with a
                                   BROADCAST_RCVBUF receive buffer, drained by
                                   a thread -> {"ports", "rcvbuf"}
      {"cmd": "mark"}              note how many datagrams each has so far
      {"cmd": "pli", "ports": [p]} a PLI from socket i to the agent's port
                                   p[i] (null: none)
      {"cmd": "close", "out": path, "reassemble": R}
                                   once no datagram came for BROADCAST_QUIET_S:
                                   per socket the datagrams, a sha256 over every
                                   packet's bytes but SSRC, seq and ts (up to
                                   the mark, and of all), the SSRCs, the seq
                                   gaps; the first R sockets' packets
                                   depacketized and decoded into frames, saved
                                   to ``path`` (npz)
      {"cmd": "exit"}"""
    import hashlib
    import selectors
    import socket

    import numpy as np

    from ai_rtc_agent_tpu_torch.media.plane import H264RingSource
    from ai_rtc_agent_tpu_torch.media.rtp import make_pli
    from ai_rtc_agent_tpu_torch.media.sockio import set_rcvbuf

    size = spec["size"]
    socks, boxes, marks, stop, thread = [], [], [], None, None

    def drain(socks, boxes, stop):
        sel = selectors.DefaultSelector()
        for i, s in enumerate(socks):
            sel.register(s, selectors.EVENT_READ, i)
        while not stop.is_set():
            for key, _ in sel.select(0.02):
                box = boxes[key.data]
                try:
                    while True:
                        box.append(key.fileobj.recv(2048))
                except BlockingIOError:
                    pass
        sel.close()

    def digest(box):
        h = hashlib.sha256()
        for p in box:
            h.update(p[:2])
            h.update(p[12:])
        return h.hexdigest()

    def reply(obj):
        print(json.dumps(obj), flush=True)

    while True:
        line = sys.stdin.readline()
        if not line:
            break
        cmd = json.loads(line)
        op = cmd["cmd"]
        if op == "open":
            socks = []
            for _ in range(cmd["n"]):
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                s.bind(("127.0.0.1", 0))
                set_rcvbuf(s, BROADCAST_RCVBUF)
                s.setblocking(False)
                socks.append(s)
            boxes, marks = [[] for _ in socks], None
            stop = threading.Event()
            thread = threading.Thread(target=drain, args=(socks, boxes, stop), daemon=True)
            thread.start()
            reply({"ports": [s.getsockname()[1] for s in socks],
                   "rcvbuf": socks[0].getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)})
        elif op == "mark":
            marks = [len(b) for b in boxes]
            reply({"datagrams": marks})
        elif op == "pli":
            pli = make_pli()
            for s, port in zip(socks, cmd["ports"]):
                if port is not None:
                    s.sendto(pli, ("127.0.0.1", port))
            reply({"sent": sum(p is not None for p in cmd["ports"])})
        elif op == "close":
            seen = -1
            while seen != sum(len(b) for b in boxes):
                seen = sum(len(b) for b in boxes)
                time.sleep(BROADCAST_QUIET_S)
            stop.set()
            thread.join()
            views = []
            for i, box in enumerate(boxes):
                seqs = [int.from_bytes(p[2:4], "big") for p in box]
                upto = box if marks is None else box[:marks[i]]
                views.append({"datagrams": len(box), "sha256": digest(upto),
                              "sha256_all": digest(box),
                              "ssrcs": sorted({p[8:12].hex() for p in box}),
                              "seq_gaps": sum((a + 1) & 0xFFFF != b for a, b in zip(seqs, seqs[1:]))})
            saved = {}
            for i, box in enumerate(boxes[:cmd["reassemble"]]):
                src = H264RingSource(size, size, use_h264=False)
                got = []
                for p in box:
                    src.feed_packet(p)
                    while (item := src.poll()) is not None:
                        got.append((item[1], item[0].copy()))
                src.close()
                saved[f"pts{i}"] = np.array([p for p, _ in got], np.int64)
                saved[f"frames{i}"] = (np.stack([a for _, a in got]) if got
                                       else np.zeros((0, size, size, 3), np.uint8))
            np.savez(cmd["out"], **saved)
            for s in socks:
                s.close()
            reply({"viewers": views})
        elif op == "exit":
            break


class ViewerProcess:
    """Phase 11's viewers (``--broadcast-viewers``), driven from the agent's
    loop: one command, one answer."""

    def __init__(self, proc):
        self.proc = proc

    @classmethod
    async def start(cls, size: int) -> "ViewerProcess":
        here = Path(__file__).resolve().parent
        proc = await asyncio.create_subprocess_exec(
            sys.executable, str(here / "chip_smoke.py"), "--broadcast-viewers",
            json.dumps({"size": size}), stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE)
        return cls(proc)

    async def call(self, **cmd) -> dict:
        self.proc.stdin.write(json.dumps(cmd).encode() + b"\n")
        await self.proc.stdin.drain()
        try:
            line = await asyncio.wait_for(self.proc.stdout.readline(), 120)
        except asyncio.TimeoutError:
            line = b""
        if not line:
            self.kill()
            fail(f"broadcast: the viewers' process gave no answer to {cmd['cmd']}")
        return json.loads(line)

    def kill(self):
        if self.proc.returncode is None:
            self.proc.kill()

    async def close(self):
        if self.proc.returncode is None:
            self.proc.stdin.write(b'{"cmd": "exit"}\n')
            try:
                await asyncio.wait_for(self.proc.wait(), 30)
            except asyncio.TimeoutError:
                self.kill()
                await self.proc.wait()


def _viewer_offer(size: int, port: int) -> str:
    return json.dumps({"native_rtp": True, "video": False, "width": size, "height": size,
                       "client_addr": ["127.0.0.1", port]})


async def _push(pub, frames, fps: int = 30):
    """The publisher's frames at ``fps``, each frame's packets in paced bursts."""
    t_next = time.monotonic()
    for i, arr in enumerate(frames):
        await pub.send_paced(arr, i, NATIVE_BURST)
        t_next += 1.0 / fps
        await asyncio.sleep(max(0.0, t_next - time.monotonic()))


async def _settle(read, quiet_s: float = 0.5, timeout_s: float = 60.0):
    """Wait until ``read()`` stops changing for ``quiet_s``."""
    t_end = time.monotonic() + timeout_s
    last = read()
    while time.monotonic() < t_end:
        await asyncio.sleep(quiet_s)
        now = read()
        if now == last:
            return now
        last = now
    fail(f"broadcast: the stream did not settle within {timeout_s:.0f} s")


def _group_us(stats) -> dict:
    """µs per frame of a group's TX plane from its stage p50s: encode once,
    packetize once, the rewrites of every viewer, the one sendmmsg burst."""
    st = stats.stage_snapshot_us()
    out = {k: st.get(f"{k}_p50_us", 0.0) for k in ("encode", "packetize", "rewrite", "send")}
    out["per_frame"] = round(sum(out.values()), 2)
    return out


def _dedicated_us(encode_stats, pcs) -> dict:
    """The same for the dedicated chain: each viewer's own encode,
    packetize and send (the p50s of its plane stats and the shared encode
    stage), summed over the viewers."""
    enc = encode_stats.stage_snapshot_us().get("encode_p50_us", 0.0)
    pk = [pc.plane_stats.stage_snapshot_us().get("packetize_p50_us", 0.0) for pc in pcs]
    sd = [pc.plane_stats.stage_snapshot_us().get("send_p50_us", 0.0) for pc in pcs]
    return {"encode": enc, "packetize": pk, "send": sd,
            "per_frame": round(len(pcs) * enc + sum(pk) + sum(sd), 2)}


def _hold_reassembled(np, label, tap, key, frames, saved, n: int, same: bool = True) -> int:
    """The reassembling viewers' frames (``saved``, npz) each bit for bit the
    direct call of the publisher's session on the pushed frame of its pts;
    with ``same``, the viewers decoded the same frames.  -> frames held."""
    got, lists = {}, []
    for i in range(n):
        pts, arrs = saved[f"pts{i}"], saved[f"frames{i}"]
        lists.append(sorted({int(p) for p in pts}))  # a GOP replay repeats the last
        for p, arr in zip(pts, arrs):
            if int(p) in got and not np.array_equal(got[int(p)], arr):
                fail(f"{label}: viewer {i} decoded pts {int(p)} unlike another viewer")
            got[int(p)] = arr
    if not got or (same and any(lst != lists[0] for lst in lists)):
        fail(f"{label}: the reassembling viewers decoded {[len(x) for x in lists]} frames, "
             "not the same ones")
    leg = NativeLeg(key, None, None, [], frames, 30)
    leg.got = [(p, arr, 0.0) for p, arr in sorted(got.items())]
    direct = direct_outputs(np, tap, [leg])
    bad = [p for p, arr, _ in leg.got if not np.array_equal(arr, direct[(key, p)])]
    if bad:
        fail(f"{label}: {len(bad)} reassembled frame(s) differ from their direct call "
             f"(pts {bad[:4]})")
    return len(got)


async def _pli_storm(viewers, group, ports, sched, label) -> dict:
    """Every viewer sends a PLI, twice: past the last grant, one GOP replay
    for the first storm and none for the second (inside the coalesce
    window), and no engine step."""
    await asyncio.sleep(group.governor.coalesce_s)
    s0, out = sched.steps_total, []
    for storm in (1, 2):
        c0 = group.stats.stage_snapshot_us()
        g0 = group.governor.granted
        sent = (await viewers.call(cmd="pli", ports=ports))["sent"]
        t_end = time.monotonic() + 10
        while group.stats.stage_snapshot_us().get("broadcast_pli_total", 0) < \
                c0.get("broadcast_pli_total", 0) + sent:
            if time.monotonic() > t_end:
                fail(f"{label}: the group heard {sent} PLIs only in part")
            await asyncio.sleep(0.005)
        c1 = group.stats.stage_snapshot_us()
        out.append({k: c1.get(f"broadcast_{k}_total", 0) - c0.get(f"broadcast_{k}_total", 0)
                    for k in ("pli", "pli_coalesced", "gop_replays", "encoder_idr")})
        out[-1]["granted"] = group.governor.granted - g0
    steps = sched.steps_total - s0
    want = [{"pli": len([p for p in ports if p is not None]), "granted": g, "gop_replays": g,
             "encoder_idr": 0} for g in (1, 0)]
    for got, w in zip(out, want):
        if any(got[k] != v for k, v in w.items()) or steps:
            fail(f"{label}: PLI storms {out} with {steps} engine step(s) (want {want}, none)")
    return {"storms": out, "engine_steps": steps}


async def broadcast_once(np, state, tap, sched, viewers, mode: str, V: int, frames, size: int,
                         label: str) -> dict:
    """One publisher at 30 fps and V viewers in the viewers' process: through
    the publisher's broadcast group (``mode`` "group", BROADCAST_MAX_VIEWERS=V,
    viewer V+1 refused) or each through its own sink and pump ("dedicated",
    BROADCAST_FANOUT=0).  -> its readings (see phase_broadcast)."""
    from ai_rtc_agent_tpu_torch.media.rtp_client import NativeRtpClient
    from ai_rtc_agent_tpu_torch.server import sessions

    live = state["state"]
    pub = await NativeRtpClient(size, size, fps=30, use_h264=False, rcvbuf=NATIVE_RCVBUF).open()
    r = await sessions.publish(state, pub.offer_envelope())
    if r.status != 201:
        fail(f"{label}: /whip answered {r.status} {r.body}")
    key = r.headers["Location"].rsplit("/", 1)[1]
    await pub.connect(json.loads(r.body)["server_port"])
    opened = await viewers.call(cmd="open", n=V + 1)  # the last: the refused viewer's
    ports, vids, refused = opened["ports"], [], None
    group_mode = mode == "group"
    with _Env(BROADCAST_FANOUT=int(group_mode), BROADCAST_MAX_VIEWERS=V if group_mode else 0):
        for port in ports[:V]:
            rv = await sessions.subscribe(state, _viewer_offer(size, port))
            if rv.status != 201:
                fail(f"{label}: /whep answered {rv.status} {rv.body}")
            vids.append(rv.headers["Location"].rsplit("/", 1)[1])
        if group_mode:
            rv = await sessions.subscribe(state, _viewer_offer(size, ports[V]))
            refused = [rv.status, rv.headers.get("Retry-After"), rv.body]
            if rv.status != 503 or not rv.headers.get("Retry-After"):
                fail(f"{label}: viewer {V + 1} past BROADCAST_MAX_VIEWERS={V} answered "
                     f"{refused} (want 503 with Retry-After)")
    pcs = [live["whep_pcs"][v] for v in vids]
    group = live["broadcast_groups"].get(key)
    if group_mode and (group is None or group.viewer_count != V
                       or any(pc._sink is not None for pc in pcs)):
        fail(f"{label}: the viewers did not all join the publisher's group")
    if not group_mode and (live["broadcast_groups"] or any(pc._sink is None for pc in pcs)):
        fail(f"{label}: BROADCAST_FANOUT=0 and a viewer has no sink of its own")
    _reset_launches()
    s0 = sched.steps_total
    t0 = time.perf_counter()
    await _push(pub, frames)
    if group_mode:
        await _settle(lambda: (sched.steps_total, group.frames))
    else:
        await _settle(lambda: (sched.steps_total,
                               [pc.plane_stats.stage_snapshot_us().get("tx_packets_total")
                                for pc in pcs]))
    wall = time.perf_counter() - t0
    attn, epi = _launches()
    steps = sched.steps_total - s0
    if not 0 < steps <= len(frames) or epi != steps or attn != 32 * steps:
        fail(f"{label}: {steps} bucket steps for {len(frames)} frames pushed, launches "
             f"attention {attn}, epilogue {epi} (want at most one step a frame, 32 + 1 a step)")
    out = {"label": label, "mode": mode, "V": V, "steps": steps, "attn": attn, "epi": epi,
           "wall_s": wall, "refused": refused, "rcvbuf": opened["rcvbuf"]}
    if group_mode:
        out["us"] = _group_us(group.stats)
        out["fanned"] = group.frames
        await viewers.call(cmd="mark")
        out["pli"] = await _pli_storm(viewers, group, [group.port] * V + [None], sched, label)
    else:
        out["us"] = _dedicated_us(state["stats"], pcs)
    R = min(BROADCAST_REASSEMBLE, V)
    npz = Path(__file__).resolve().parent / "build" / "broadcast_viewers.npz"
    npz.parent.mkdir(exist_ok=True)
    report = (await viewers.call(cmd="close", out=str(npz), reassemble=R))["viewers"][:V]
    out["datagrams"] = [v["datagrams"] for v in report]
    if group_mode:
        if (len({v["sha256_all"] for v in report}) != 1 or len(set(out["datagrams"])) != 1
                or any(v["ssrcs"] != ["00005eed"] or v["seq_gaps"] for v in report)):
            fail(f"{label}: the viewers' streams differ beyond SSRC, seq and ts: {report}")
    with np.load(npz) as saved:
        out["held"] = await asyncio.to_thread(_hold_reassembled, np, label, tap, key, frames,
                                              dict(saved), R, group_mode)
    for vid in vids:
        if not await sessions.close(state, "whep", vid):
            fail(f"{label}: closing a viewer found nothing to close")
    if not await sessions.close(state, "whip", key):
        fail(f"{label}: closing the publisher found nothing to close")
    pub.close()
    await asyncio.sleep(0)
    await asyncio.gather(*state["releasing"])
    if state["pcs"] or sched.free_slots != sched.max_sessions:
        fail(f"{label}: {len(state['pcs'])} peer connection(s) and "
             f"{sched.max_sessions - sched.free_slots} slot(s) left after closing")
    return out


class _PullTap:
    """An InProcessTransport whose /broadcast/pull answers are kept."""

    def __init__(self, inner):
        self.inner, self.pulls = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    async def request(self, method, url, **kw):
        resp = await self.inner.request(method, url, **kw)
        if url.endswith("/broadcast/pull"):
            self.pulls.append((resp.status, resp.json() if resp.status == 200 else resp.text()))
        return resp


async def edge_pull(np, A, provider_b, tap, sched, viewers, transport, frames, size: int) -> dict:
    """11b: agent A (``A``, the owner) and B (the edge) behind the router's
    core in this process; the publisher placed on A through the router, one
    viewer on A, two placed through the router (on B, which pulls one copy
    from A)."""
    from ai_rtc_agent_tpu_torch.fleet import routing
    from ai_rtc_agent_tpu_torch.media.rtp_client import NativeRtpClient
    from ai_rtc_agent_tpu_torch.server import sessions

    label = "broadcast 11b"
    sdp = {"Content-Type": "application/sdp"}
    R = routing.configure({}, transport=transport)
    await routing.startup(R)
    B = {}
    sessions.configure(B, model_id=A["model_id"], pipeline=A["pipeline"], provider=provider_b,
                       transport=transport)
    await sessions.startup(B)
    pub = None
    try:
        async def register(name, st):
            transport.add(f"http://127.0.0.1:{EDGE_PORTS[name]}", st)
            r = await routing.handle(R, "POST", "/fleet/register", body={
                "worker_id": name, "public_ip": "127.0.0.1", "public_port": str(EDGE_PORTS[name]),
                "status": "ready", "capacity": 2, "boot_id": st["boot_id"]})
            if r.status != 200:
                fail(f"{label}: registering {name} answered {r.status} {r.body!r}")
            await R["poller"].poll_once()

        def owner(sid):
            return R["session_table"].owner(sid)

        await register("A", A)  # A alone: the publisher lands there
        pub = await NativeRtpClient(size, size, fps=30, use_h264=False,
                                    rcvbuf=NATIVE_RCVBUF).open()
        r = await routing.handle(R, "POST", "/whip", headers=sdp, body=pub.offer_envelope())
        if r.status != 201:
            fail(f"{label}: /whip through the router answered {r.status} {r.body!r}")
        key = r.headers["Location"].rsplit("/", 1)[1]
        await pub.connect(json.loads(r.body)["server_port"])
        await register("B", B)
        ports = (await viewers.call(cmd="open", n=3))["ports"]
        rv = await sessions.subscribe(A, _viewer_offer(size, ports[0]))
        if rv.status != 201:
            fail(f"{label}: /whep on A answered {rv.status}")
        a_view = rv.headers["Location"].rsplit("/", 1)[1]
        placed = []
        for port in ports[1:]:
            rv = await routing.handle(R, "POST", "/whep", headers=sdp,
                                      body=_viewer_offer(size, port))
            if rv.status != 201:
                fail(f"{label}: /whep through the router answered {rv.status} {rv.body!r}")
            placed.append(rv.headers["Location"].rsplit("/", 1)[1])
        where = [owner(key)] + [owner(v) for v in placed]
        pulls = [p[1]["status"] if isinstance(p[1], dict) else p for p in transport.pulls]
        if where != ["A", "B", "B"] or pulls != ["pulling", "exists"]:
            fail(f"{label}: publisher and viewers placed on {where}, B's pulls answered "
                 f"{transport.pulls} (want A, B, B; pulling, exists)")
        ga, gb = A["state"]["broadcast_groups"][key], B["state"]["broadcast_groups"]["edge"]
        puller = B["state"]["edge_puller"]
        pull_port = puller._transport.get_extra_info("sockname")[1]
        from_b = [a for a in ga._by_addr if a[1] == pull_port]
        if (ga.viewer_count, len(from_b), gb.viewer_count) != (2, 1, 2):
            fail(f"{label}: A's group has {ga.viewer_count} viewers ({len(from_b)} from B's "
                 f"pull), B's {gb.viewer_count} (want 2 with 1 from B's pull, and 2)")
        _reset_launches()
        s0 = sched.steps_total
        await _push(pub, frames)
        await _settle(lambda: (sched.steps_total, ga.frames, gb.frames))
        attn, epi = _launches()
        steps = sched.steps_total - s0
        if not 0 < steps <= len(frames) or epi != steps or attn != 32 * steps:
            fail(f"{label}: {steps} bucket steps, launches attention {attn}, epilogue {epi}")
        await viewers.call(cmd="mark")
        a_pli0 = ga.stats.stage_snapshot_us().get("broadcast_pli_total", 0)
        storm = await _pli_storm(viewers, gb, [None, gb.port, gb.port], sched, label)
        a_pli = ga.stats.stage_snapshot_us().get("broadcast_pli_total", 0) - a_pli0
        if a_pli > 1:
            fail(f"{label}: B's PLI storms reached A {a_pli} times in one coalesce window")
        npz = Path(__file__).resolve().parent / "build" / "broadcast_edge.npz"
        report = (await viewers.call(cmd="close", out=str(npz), reassemble=2))["viewers"]
        if len({v["sha256"] for v in report}) != 1 or any(v["seq_gaps"] for v in report):
            fail(f"{label}: B's viewers' payload differs from A's viewer's: {report}")
        with np.load(npz) as saved:
            held = await asyncio.to_thread(_hold_reassembled, np, label, tap, key, frames,
                                           dict(saved), 2)
        out = {"steps": steps, "attn": attn, "epi": epi, "pulls": pulls, "where": where,
               "fanned": [ga.frames, gb.frames], "aus": puller.aus, "held": held,
               "pull_rcvbuf": puller.rcvbuf,
               "datagrams": [v["datagrams"] for v in report], "pli": storm, "a_pli": a_pli,
               "us": {"A": _group_us(ga.stats), "B": _group_us(gb.stats)}}
        for vid in placed:
            r = await routing.handle(R, "DELETE", f"/whep/{vid}")
            if r.status != 200:
                fail(f"{label}: DELETE /whep through the router answered {r.status}")
        await sessions.close(A, "whep", a_view)
        r = await routing.handle(R, "DELETE", f"/whip/{key}")
        if r.status != 200:
            fail(f"{label}: DELETE /whip through the router answered {r.status}")
        return out
    finally:
        if pub is not None:
            pub.close()
        await sessions.shutdown(B)
        await routing.cleanup(R)


def phase_broadcast(torch, card: str, pipe):
    """Phase 11 (see the module docstring).  -> the attention and epilogue
    launches of the steps it drove."""
    # the fan-out to 16 viewers holds the loop for tens of ms a frame: the
    # overload plane would read that as loop lag and refuse the next /whip;
    # a publisher sits idle while its frames are held to direct calls, past
    # the output-age watchdog (phase 7's subject)
    with _Env(WEBRTC_PROVIDER="native-rtp", WARMUP_FRAMES=0, DROP_FRAMES=0,
              OVERLOAD_RX_QUEUE_BOUND=16384, OVERLOAD_LOOP_LAG_BUDGET_MS=5000,
              FLEET_POLL_S=3600, SUPERVISOR_STALL_AFTER_S=600):
        return asyncio.run(broadcast_run(torch, card, pipe))


async def broadcast_run(torch, card, pipe):
    import numpy as np

    from ai_rtc_agent_tpu_torch.fleet.transport import InProcessTransport
    from ai_rtc_agent_tpu_torch.server import sessions
    from ai_rtc_agent_tpu_torch.server.signaling import get_provider
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    t_phase = time.perf_counter()
    size = pipe.config.width
    base = _frames(np, NATIVE_DISTINCT, seed=1100, size=size)
    frames = [base[i % NATIVE_DISTINCT] for i in range(BROADCAST_FRAMES)]
    edge_frames = _frames(np, EDGE_FRAMES, seed=1110, size=size)
    providers = [get_provider(), get_provider()]
    for p in providers:
        if type(p).__name__ != "NativeRtpProvider":
            fail(f"broadcast: WEBRTC_PROVIDER=native-rtp gave {type(p).__name__}")
        p.use_h264 = False  # NullCodec: lossless, so frames compare bit for bit
    sched = BatchScheduler.from_pipeline(pipe, max_sessions=2)
    tap = StepTap(sched)
    transport = _PullTap(InProcessTransport())
    state = {}
    sessions.configure(state, model_id=pipe.model_id, pipeline=pipe, provider=providers[0],
                       batch_scheduler=sched, transport=transport)
    await sessions.startup(state)
    viewers = await ViewerProcess.start(size)
    runs, edge = [], None
    try:
        order = [("group", BROADCAST_AUDIENCES[0])]
        order += [(mode, BROADCAST_AB_V) for mode in BROADCAST_AB]
        order += [("group", v) for v in BROADCAST_AUDIENCES[1:] if v != BROADCAST_AB_V]
        for mode, V in order:
            label = f"broadcast 11a {mode} V={V}"
            runs.append(await broadcast_once(np, state, tap, sched, viewers, mode, V, frames,
                                             size, label))
        edge = await edge_pull(np, state, providers[1], tap, sched, viewers, transport,
                               edge_frames, size)
    finally:
        await viewers.close()
        await sessions.shutdown(state)
    attn = sum(r["attn"] for r in runs) + edge["attn"]
    epi = sum(r["epi"] for r in runs) + edge["epi"]
    for r in runs:
        say(f"{r['label']}: {card} | {r['steps']} bucket steps for {BROADCAST_FRAMES} frames "
            f"pushed, launches attention {r['attn']}, epilogue {r['epi']} (32 + 1 a step) | "
            f"datagrams per viewer {r['datagrams']} | reassembled frames held bit for bit to "
            f"their direct calls: {r['held']} | µs per frame {json.dumps(r['us'])} | wall "
            f"{r['wall_s']:.2f} s | viewer socket rcvbuf {r['rcvbuf']} B")
        if r["mode"] == "group":
            say(f"{r['label']}: {r['fanned']} frames fanned out; every viewer's datagrams equal "
                f"but for SSRC, seq and ts (one SSRC, no seq gap); viewer {r['V'] + 1} refused "
                f"{r['refused'][:2]}; PLI storms {json.dumps(r['pli'])}")
    ab = [r["us"]["per_frame"] for r in runs if r["V"] == BROADCAST_AB_V]
    say(f"broadcast 11a: {card} | µs per frame, group at V = "
        f"{[(r['V'], r['us']['per_frame']) for r in runs if r['mode'] == 'group']}; at "
        f"V={BROADCAST_AB_V}, ABBA {list(zip(BROADCAST_AB, ab))}")
    say(f"broadcast 11b: {card} | placed {edge['where']}, B's pulls {edge['pulls']}, A counts 1 "
        f"viewer for B's pull | {edge['steps']} bucket steps, launches attention "
        f"{edge['attn']}, epilogue {edge['epi']} | fanned out A {edge['fanned'][0]}, B "
        f"{edge['fanned'][1]} ({edge['aus']} AUs pulled; the pull socket's rcvbuf "
        f"{edge['pull_rcvbuf']} B) | datagrams [A's viewer, B's two] "
        f"{edge['datagrams']}, payload equal | frames held {edge['held']} | PLI storms at B "
        f"{json.dumps(edge['pli'])}, PLIs reaching A {edge['a_pli']} | µs per frame "
        f"{json.dumps(edge['us'])}")
    say(f"broadcast: phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return attn, epi


# -- phase 12: SD1.5 stream-batch LCM, the reference's own default ---------------------

SD15_ID = "runwayml/stable-diffusion-v1-5"
SD15_SEED = 12
SD15_HUB = Path(__file__).resolve().parent / "build" / "phase12-hub"
SD15_RING_K = (1, 2, 4)  # 12b: sessions (4, 8 and 16 UNet rows a bucket step)
SD15_FRAMES = 24  # 12b/12c: frames per session at each k (phase 6a's window)
SD15_FILL = 4  # of them, each session's first outputs: outside the steady window
SD15_PARITY = 8  # of them, each session's first outputs: held to dedicated engines
SD15_TRACE_FRAMES = 6  # 12b/12c: frames per session in the traced run
MODE_K = (1, 2)  # 12c: sessions in each mode
TXT_FRAMES = 6  # 12c/12d: frames viewed through each /offer session
LORA_RANK = 64
# SD1.5 at 512^2, 8 heads: (Lq, Lk, D, launches per UNet pass); 32 in all
SD15_ATTENTION = [
    (4096, 4096, 40, 5), (4096, 77, 40, 5), (1024, 1024, 80, 5), (1024, 77, 80, 5),
    (256, 256, 160, 5), (256, 77, 160, 5), (64, 64, 160, 1), (64, 77, 160, 1),
]
SD15_ATTENTION_B = (4, 8, 16)  # the ring's rows at k = 1, 2 and 4 sessions
# per mode: (attention, epilogue) launches a bucket step
MODE_LAUNCHES = {"ring": (32, 1), "full": (32, 0), "sequential": (128, 0), "txt2img": (32, 1)}


def sd15_snapshot(torch, np, seeded: dict, snap: Path, model_id: str = SD15_ID) -> dict:
    """Write ``seeded`` (the port's f32 tree of ``model_id``) as an HF snapshot at
    ``snap`` through the port's tree_to_state_dict and write_safetensors:
    unet/, text_encoder/ and vae/ in f32, and a tokenizer/ vocab of single
    characters (every lowercase prompt gets ids).  -> {piece: bytes}."""
    from ai_rtc_agent_tpu_torch.models import loader as LD
    from ai_rtc_agent_tpu_torch.models import registry

    unet_cfg, clip_cfg, taesd_cfg = registry._model_configs(registry.family_of(model_id))
    sizes = {}
    for sub, name, km, tree in (
        ("unet", "diffusion_pytorch_model.safetensors", LD.unet_key_map(unet_cfg), seeded["unet"]),
        ("text_encoder", "model.safetensors", LD.clip_key_map(clip_cfg), seeded["clip"]),
        ("vae", "diffusion_pytorch_model.safetensors", LD.taesd_key_map(taesd_cfg),
         seeded["taesd"]),
    ):
        (snap / sub).mkdir(parents=True, exist_ok=True)
        LD.write_safetensors(str(snap / sub / name), LD.tree_to_state_dict(tree, km))
        sizes[sub] = (snap / sub / name).stat().st_size
    chars = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for piece in chars + [c + "</w>" for c in chars]:
        vocab[piece] = len(vocab)
    (snap / "tokenizer").mkdir(exist_ok=True)
    (snap / "tokenizer" / "vocab.json").write_text(json.dumps(vocab))
    (snap / "tokenizer" / "merges.txt").write_text("#version: 0.2\n")
    return sizes


def lcm_lora_files(torch, np, seeded_unet: dict, root: Path, model_id: str = SD15_ID) -> tuple:
    """Two synthetic LCM-LoRAs of rank LORA_RANK from a numpy seed: one in
    the diffusers (peft) format on every attention projection (to_q, to_k,
    to_v, to_out.0 of attn1 and attn2), one in the kohya format on every
    proj_in/proj_out (1x1 convs) and again on every attn2.to_k (two LoRAs
    on one kernel, fused in order).  -> (lora_dict {path: scale}, the
    factors per file: [(tree path, down, up, alpha)])."""
    import re

    from ai_rtc_agent_tpu_torch.models import loader as LD
    from ai_rtc_agent_tpu_torch.models import registry

    km = LD.unet_key_map(registry._model_configs(registry.family_of(model_id))[0])
    rng = np.random.default_rng(SD15_SEED)
    r = LORA_RANK

    def factors(module):
        path = km[module + ".weight"]
        node = seeded_unet
        for key in path:
            node = node[key]
        if node.ndim == 2:  # [in, out]
            cin, cout, tap = node.shape[0], node.shape[1], ()
        else:  # OIHW 1x1
            cout, cin, tap = node.shape[0], node.shape[1], (1, 1)
        down = (rng.standard_normal((r, cin) + tap) / math.sqrt(cin)).astype(np.float32)
        up = (rng.standard_normal((cout, r) + tap) * 0.05 / math.sqrt(r)).astype(np.float32)
        return path, down, up

    modules = [k[: -len(".weight")] for k in km]
    attn = [m for m in modules if re.search(r"\.attn[12]\.to_(q|k|v|out\.0)$", m)]
    proj = [m for m in modules if re.search(r"\.proj_(in|out)$", m)]
    twice = [m for m in attn if m.endswith("attn2.to_k")]
    diffusers, kohya, plan = {}, {}, {}
    plan["diffusers"] = []
    for m in attn:
        path, down, up = factors(m)
        diffusers[f"unet.{m}.lora_A.weight"] = down
        diffusers[f"unet.{m}.lora_B.weight"] = up
        plan["diffusers"].append((path, down, up, None))
    plan["kohya"] = []
    for m in proj + twice:
        path, down, up = factors(m)
        base = "lora_unet_" + m.replace(".", "_")
        kohya[f"{base}.lora_down.weight"] = down
        kohya[f"{base}.lora_up.weight"] = up
        kohya[f"{base}.alpha"] = np.array(r / 2, np.float32)
        plan["kohya"].append((path, down, up, r / 2))
    paths = {}
    for name, sd in (("diffusers", diffusers), ("kohya", kohya)):
        paths[name] = str(root / f"lcm-lora-{name}.safetensors")
        LD.write_safetensors(paths[name], sd)
    scales = {"diffusers": 1.0, "kohya": 0.5}
    return {paths[n]: scales[n] for n in ("diffusers", "kohya")}, [
        (scales[n], plan[n]) for n in ("diffusers", "kohya")]


def expected_unet(torch, np, seeded_unet: dict, plans) -> dict:
    """{tree path: the f32 kernel} of every LoRA target: the seeded kernel
    plus each LoRA in order, as plain f32 arithmetic on the host
    (models/lora.py ``lora_delta``, scale * alpha / r)."""
    from ai_rtc_agent_tpu_torch.models import lora as LR

    want = {}
    for scale, plan in plans:
        for path, down, up, alpha in plan:
            if path not in want:
                node = seeded_unet
                for key in path:
                    node = node[key]
                want[path] = node.float().cpu().numpy()
            s = float(scale) * (float(alpha) / down.shape[0] if alpha is not None else 1.0)
            want[path] = want[path] + s * LR.lora_delta(want[path].shape, down, up)
    return want


def _tree_paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_paths(v, path + (i,))
    elif tree is not None:
        yield path, tree


def hold_loaded(torch, label: str, got: dict, seeded: dict, want_unet: dict, dtype) -> int:
    """Every leaf of ``got`` bit for bit: the seeded leaf, or for a LoRA
    target the expected fused kernel, each cast once to ``dtype``.
    -> leaves checked."""
    seeded_leaves = dict(_tree_paths(seeded))
    n = 0
    for path, leaf in _tree_paths(got):
        if path[0] == "unet" and path[1:] in want_unet:
            want = torch.from_numpy(want_unet[path[1:]]).to(leaf.device)
        else:
            want = seeded_leaves[path]
        if leaf.shape != want.shape or not torch.equal(leaf, want.to(dtype)):
            fail(f"{label}: leaf {'/'.join(map(str, path))} is not the seeded tree plus the "
                 "f32 fusion, cast once")
        n += 1
    return n


def replay_equals_eager(torch, np, label: str, sched, frames: np.ndarray, slots: list,
                        variant: str | None = None) -> str:
    """One bucket step of the scheduler's captured graph (its ``variant``:
    DeepCache's capture or cached; default the first) against an eager
    bucket step over a copy of the same states, frames and slots, under the
    step lock: the preflight's check (assets/build_engines.py), the outputs
    and every state leaf bit for bit."""
    from ai_rtc_agent_tpu_torch.assets.build_engines import bucket_replay_equals_eager

    k = sched._bucket_for(len(slots))
    with sched._step_lock:
        try:
            bucket_replay_equals_eager(sched._bucket, sched._template.models, sched.cfg,
                                       sched.params, sched.states, frames, slots, k, variant,
                                       f"{label} bucket {k}")
        except RuntimeError as e:
            fail(str(e))
    return f"replay = eager bit for bit (bucket {k}, outputs and state)"


def phase_sd15(torch, card: str) -> tuple:
    """Phase 12: SD1.5 stream-batch LCM with weights from a snapshot and a
    fused LCM-LoRA (12a), the ring on the captured bucket steps at k = 1, 2
    and 4 (12b), full CFG, sequential mode and txt2img (12c), the safety
    checker on the served path (12d), attention at SD1.5's shapes (12e).
    -> the attention and epilogue launches of 12b and 12c's steps."""
    import shutil

    import numpy as np

    from ai_rtc_agent_tpu_torch.models import registry
    from ai_rtc_agent_tpu_torch.models import tokenizer as TK
    from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline

    t_phase = time.perf_counter()
    shutil.rmtree(SD15_HUB, ignore_errors=True)
    os.environ["HF_HUB_CACHE"] = str(SD15_HUB)
    snap = SD15_HUB / f"models--{SD15_ID.replace('/', '--')}" / "snapshots" / "phase12"
    total = [0, 0]
    try:
        # -- 12a: the snapshot, the LoRAs, the load ---------------------------------------
        t = time.perf_counter()
        seeded = registry.init_params(registry.family_of(SD15_ID), seed=SD15_SEED, device="cuda")
        sizes = sd15_snapshot(torch, np, seeded, snap)
        lora_dict, plans = lcm_lora_files(torch, np, seeded["unet"], SD15_HUB)
        write_s = time.perf_counter() - t
        lora_bytes = sum(os.path.getsize(p) for p in lora_dict)
        t = time.perf_counter()
        ref = registry.load_model_bundle(SD15_ID, attn_impl="plain", lora_dict=lora_dict)
        _sync(torch, ref.device)
        load_s = time.perf_counter() - t
        if not ref.loaded_real_weights or not isinstance(
                TK.find_clip_tokenizer(str(snap)), TK.CLIPBPETokenizer):
            fail("sd15 12a: the snapshot's weights or its vocab did not load")
        want_unet = expected_unet(torch, np, seeded["unet"], plans)
        n32 = hold_loaded(torch, "sd15 12a f32", ref.params, seeded, want_unet, torch.float32)
        proj = ref.params["unet"]["down_blocks"][0]["attentions"][0]["proj_in"]["kernel"]
        t = time.perf_counter()
        pipe = StreamDiffusionPipeline(SD15_ID, lora_dict=lora_dict, seed=2)
        _sync(torch, pipe.device)
        pipe_s = time.perf_counter() - t
        n16 = hold_loaded(torch, f"sd15 12a {pipe.config.dtype}", pipe.bundle.params, seeded,
                          want_unet, pipe.config.torch_dtype)
        del seeded
        targets = sum(len(p) for _, p in plans)
        say(f"sd15 12a: {card} | snapshot {SD15_ID} written from the seeded sd15 tree in "
            f"{write_s:.1f}s (f32 bytes: " + ", ".join(f"{k} {v}" for k, v in sizes.items())
            + f"; two LCM-LoRAs of rank {LORA_RANK}, diffusers on {len(plans[0][1])} attention "
            f"projections and kohya on {len(plans[1][1])} proj_in/proj_out/attn2.to_k kernels, "
            f"{lora_bytes} B) | load_model_bundle(lora_dict=...) f32 in {load_s:.1f}s: "
            f"{n32} leaves = seeded + the f32 fusion ({targets} LoRA pairs) bit for bit, proj_in "
            f"{tuple(proj.shape)} (a 1x1 conv) | the served pipeline (load, fuse, one bf16 cast, "
            f"capture) in {pipe_s:.1f}s: {n16} leaves = the same, cast once, bit for bit")
        attn, epi = phase_sd15_ring(torch, np, card, pipe, ref)
        total[0] += attn
        total[1] += epi
        attn, epi = phase_sd15_modes(torch, np, card, pipe, ref)
        total[0] += attn
        total[1] += epi
        del ref, pipe
        attn, epi = phase_sd15_served(torch, np, card)
        total[0] += attn
        total[1] += epi
        phase_sd15_attention(torch, card)
    finally:
        shutil.rmtree(SD15_HUB, ignore_errors=True)
    say(f"sd15: phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return tuple(total)


def _count(label: str, before: tuple, steps: int, per_step: tuple) -> tuple:
    a, e = (x - y for x, y in zip(_launches(), before))
    say(f"{label}: launches over {steps} bucket steps: attention {a}, epilogue {e} "
        f"({per_step[0]} + {per_step[1]} a step)")
    if steps < 1 or (a, e) != (per_step[0] * steps, per_step[1] * steps):
        fail(f"{label}: expected {per_step[0] * steps} attention and {per_step[1] * steps} "
             "epilogue launches")
    return a, e


def sd15_run(torch, np, label: str, card: str, sched, sess, frames, make_ded, per_step: tuple,
             what: str, n: int = SD15_FRAMES, fill: int = SD15_FILL, parity: int = SD15_PARITY,
             trace_frames: int = SD15_TRACE_FRAMES) -> tuple:
    """One run of ``sess`` through ``sched``'s captured bucket steps: a replay
    against the eager step, then ``n`` frames a session with the launches
    counted (``per_step`` (attention, epilogue) a bucket step), each
    session's first ``parity`` outputs held to phase 4's criterion against
    ``make_ded(row)``, the steady window past each session's first ``fill``
    outputs on the host clock, and a device-only trace of ``trace_frames``
    frames a session whose kernels must be ``per_step`` a bucket step too.
    (Phase 16 passes SDXL's smaller counts.)  -> the launches counted."""
    dev = sched.device
    rows = [session_row(sched.states, s.slot) for s in sess]
    eq = replay_equals_eager(torch, np, label, sched, np.stack([f[0] for f in frames[:len(sess)]]),
                             [s.slot for s in sess])
    _sync(torch, dev)
    _reset_launches()
    steps0, before = sched.steps_total, _launches()
    run = drive_sessions(torch, sess, frames, n)
    counted = _count(label, before, sched.steps_total - steps0, per_step)
    held = []
    for i, s in enumerate(sess):
        ded = make_ded(rows[i])
        for f in frames[i][:parity]:
            ded(f)
        held.append(f"session {i} (slot {s.slot}): " + hold_to_references(
            np, f"{label} session {i}", run.outs[i][:parity], ded))
    step_ms, nsteps = run.steady_step_ms(fill)
    fps = run.steady_fps(fill)
    trace = kernel_trace(torch, lambda: drive_sessions(
        torch, sess, [f[:trace_frames] for f in frames], trace_frames))
    traced = trace["attention"] // per_step[0]
    say(f"{label}: {card} | {eq} | {what}; steady window (outputs {fill + 1}-"
        f"{n} of each session): {step_ms:.2f} ms between bucket steps over {nsteps} "
        f"steps, aggregate {sum(fps):.2f} fps, per session {min(fps):.2f}-{max(fps):.2f} fps | "
        f"device trace of {trace_frames} frames a session ({traced} bucket steps): busy "
        f"{trace['busy_ms'] / max(traced, 1):.3f} ms a bucket step, idle share "
        f"{trace['idle']:.3f} of {trace['span_ms']:.1f} ms, {trace['kernels']} kernels "
        f"(attention {trace['attention']}, epilogue {trace['epilogue']}) | first "
        f"{parity} outputs of each " + "; ".join(held))
    if not traced or (trace["attention"], trace["epilogue"]) != (per_step[0] * traced,
                                                                  per_step[1] * traced):
        fail(f"{label}: the trace must show {per_step[0]} attention and {per_step[1]} epilogue "
             "kernels a bucket step")
    return counted


def phase_sd15_ring(torch, np, card: str, pipe, ref) -> tuple:
    """12b: the 4-stage cfg-self LCM ring through a graph BatchScheduler at
    k = 1, 2 and 4 sessions."""
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    b, cfg, dev = pipe.bundle, pipe.config, pipe.device
    t = time.perf_counter()
    sched = BatchScheduler.from_pipeline(pipe, max_sessions=max(SD15_RING_K))
    say(f"sd15 12b: {SD15_ID} {cfg.height}x{cfg.width} {cfg.dtype} scheduler={cfg.scheduler} "
        f"cfg_type={cfg.cfg_type} t_index_list={cfg.t_index_list} fused_epilogue="
        f"{cfg.use_fused_epilogue}, buckets {sched._bucket_sizes} captured {sched.graph_status()} "
        f"in {time.perf_counter() - t:.1f}s")
    frames = [_frames(np, SD15_FRAMES, seed=120 + i, size=cfg.height)
              for i in range(max(SD15_RING_K))]
    total = [0, 0]
    try:
        for k in SD15_RING_K:
            sess = [sched.claim(f"sd15-{k}-{i}", prompt=SESSION_PROMPTS[i], seed=300 + i)
                    for i in range(k)]
            counted = sd15_run(
                torch, np, f"sd15 12b k={k}", card, sched, sess, frames,
                lambda row: Dedicated(torch, b.stream_models, b.params, cfg, b.encode_prompt, ref,
                                      row, dev),
                MODE_LAUNCHES["ring"], f"{k * cfg.batch_size} UNet rows a bucket step")
            for i, x in enumerate(counted):
                total[i] += x
            for s in sess:
                s.release()
    finally:
        sched.close()
    return tuple(total)


def phase_sd15_modes(torch, np, card: str, pipe, ref) -> tuple:
    """12c: full CFG and sequential mode through graph BatchSchedulers over
    the served weights, at k = 1 and 2 sessions."""
    from ai_rtc_agent_tpu_torch.stream.engine import fused_ok
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    eng, dev = pipe.engine, pipe.device
    total = [0, 0]
    for mode, overrides in (("full", dict(cfg_type="full")),
                            ("sequential", dict(use_denoising_batch=False))):
        cfg = replace(pipe.config, **overrides)
        if fused_ok(cfg):
            fail(f"sd15 12c {mode}: must run the composed ops, not the epilogue kernel")
        t = time.perf_counter()
        sched = BatchScheduler(eng.models, eng.params, cfg, eng.encode_prompt, model_id=SD15_ID,
                               max_sessions=max(MODE_K), schedule=eng.schedule, device=dev)
        say(f"sd15 12c {mode}: cfg_type={cfg.cfg_type} use_denoising_batch="
            f"{cfg.use_denoising_batch}, buckets {sched._bucket_sizes} captured "
            f"{sched.graph_status()} in {time.perf_counter() - t:.1f}s")
        frames = [_frames(np, SD15_FRAMES, seed=140 + i, size=cfg.height)
                  for i in range(max(MODE_K))]
        try:
            for k in MODE_K:
                sess = [sched.claim(f"{mode}-{k}-{i}", prompt=SESSION_PROMPTS[i], seed=400 + i)
                        for i in range(k)]
                counted = sd15_run(
                    torch, np, f"sd15 12c {mode} k={k}", card, sched, sess, frames,
                    lambda row: Dedicated(torch, eng.models, eng.params, cfg, eng.encode_prompt,
                                          ref, row, dev),
                    MODE_LAUNCHES[mode], f"{k} session(s)")
                for i, x in enumerate(counted):
                    total[i] += x
                for s in sess:
                    s.release()
        finally:
            sched.close()
    return tuple(total)


def phase_sd15_served(torch, np, card: str) -> tuple:
    """12c txt2img and 12d: ``--mode txt2img`` as the agent passes it to the
    session layer (server/sessions.py ``configure(mode=...)``; startup
    builds the pipeline from the snapshot and the batch scheduler over it),
    with SAFETY_CHECKER=1 (random weights): one loopback /offer session
    whose frames must not depend on the pixels pushed, no frame flagged;
    then the checker's concept thresholds below every score and a second
    /offer: every frame black; the memo; the checker's ms a frame."""
    from ai_rtc_agent_tpu_torch.models import registry
    from ai_rtc_agent_tpu_torch.server import sessions
    from ai_rtc_agent_tpu_torch.server.signaling import LoopbackProvider, make_loopback_offer
    from ai_rtc_agent_tpu_torch.utils import env

    saved_env = {k: os.environ.get(k) for k in
                 ("SAFETY_CHECKER", "BATCHSCHED_MAX_SESSIONS", "WARMUP_FRAMES", "DROP_FRAMES")}
    os.environ.update(SAFETY_CHECKER="1", BATCHSCHED_MAX_SESSIONS="1", WARMUP_FRAMES="0",
                      DROP_FRAMES="0")
    depth = env.pipeline_depth()
    # the snapshot without the LoRA, f32: the served pipeline's reference
    ref = registry.load_model_bundle(SD15_ID, attn_impl="plain")
    size = registry.default_stream_config(SD15_ID).height
    frames = _frames(np, TXT_FRAMES + depth - 1, seed=160, size=size)
    blank_frames = [np.zeros_like(f) for f in frames]
    total = [0, 0]

    async def one_offer(state, label):
        """One /offer session: TXT_FRAMES viewed, its launches counted once
        every pushed frame has been stepped; -> (frames, state row, pc)."""
        known = set(state["pcs"])
        r = await sessions.offer(state, {"room_id": label, "offer": {
            "sdp": make_loopback_offer(), "type": "offer"}})
        if r.status != 200:
            fail(f"{label}: /offer answered {r.status}")
        pc = next(iter(state["pcs"] - known))
        sched = state["batch_scheduler"]
        row = session_row(sched.states, sched.active.index(True))
        _sync(torch, sched.device)
        _reset_launches()
        steps0, before = sched.steps_total, _launches()
        views, _ = await exchange(pc, pc.out_tracks[0], frames, 0, TXT_FRAMES)
        deadline = time.perf_counter() + 30
        while sched.steps_total - steps0 < len(frames) and time.perf_counter() < deadline:
            await asyncio.sleep(0.01)
        _sync(torch, sched.device)
        a, e = _count(label, before, sched.steps_total - steps0, MODE_LAUNCHES["txt2img"])
        total[0] += a
        total[1] += e
        await pc.close()
        await asyncio.sleep(0)
        await asyncio.gather(*state["releasing"])
        return [v.to_ndarray() for v in views], row

    async def serve():
        state = {}
        sessions.configure(state, model_id=SD15_ID, mode="txt2img", provider=LoopbackProvider())
        t = time.perf_counter()
        await sessions.startup(state)
        built = time.perf_counter() - t
        pipe, sched = state["pipeline"], state["batch_scheduler"]
        checker = pipe.safety_checker
        if pipe.config.mode != "txt2img" or sched is None or sched.safety_checker is not checker \
                or checker is None or checker.loaded_real_weights:
            fail("sd15 12c txt2img: the session layer did not build a txt2img pipeline and "
                 "scheduler with the random-weight safety checker")
        say(f"sd15 12c txt2img: sessions.configure(mode='txt2img') + startup in {built:.1f}s: "
            f"config mode={pipe.config.mode} cfg_type={pipe.config.cfg_type}, the pipeline's "
            f"weights from the snapshot (loaded_real_weights={pipe.bundle.loaded_real_weights}), "
            f"SafetyChecker on {checker.device} (random weights), buckets "
            f"{sched.graph_status()}")
        served, row = await one_offer(state, "sd15 12c txt2img")
        # 12d (ii): every concept threshold below every score
        checker.params["concept_embeds_weights"].fill_(-2.0)
        checker._memo_in = None
        blacked, _ = await one_offer(state, "sd15 12d thresholds below every score")
        await sessions.shutdown(state)
        return pipe, checker, served, row, blacked

    try:
        pipe, checker, served, row, blacked = asyncio.run(serve())
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    b = pipe.bundle
    ded = Dedicated(torch, b.stream_models, b.params, pipe.config, b.encode_prompt, ref, row,
                    pipe.device)
    for f in blank_frames[:TXT_FRAMES]:  # other pixels: txt2img reads none
        ded(f)
    diff = np.stack([np.abs(s.astype(np.int16) - d) for s, d in zip(served, ded.outs)])
    black = [bool((s == 0).all()) for s in served]
    say(f"sd15 12c txt2img: {card} | {TXT_FRAMES} frames viewed through /offer vs a dedicated "
        f"engine from the same state fed black frames: max |diff| {diff.max()} levels, mean "
        f"{diff.mean():.4f}; " + hold_to_references(np, "sd15 12c txt2img", served, ded)
        + f" | 12d: frames flagged by the random-weight checker: {sum(black)} of {len(black)}")
    if diff.max() > 1:
        fail("sd15 12c txt2img: the served frames depend on the pixels pushed")
    if any(black):
        fail("sd15 12d: the random-weight safety checker flagged a frame")
    if not all((f == 0).all() for f in blacked) or len(blacked) != TXT_FRAMES:
        fail("sd15 12d: with every threshold below every score, a served frame was not black")
    # 12d (iii): the memo and the checker's cost a frame
    calls = []
    real = checker.flags
    checker.flags = lambda batch: calls.append(1) or real(batch)
    checker._memo_in = None
    checker(served[0])
    checker(served[0])
    memo_calls = len(calls)
    checker.flags = real
    _sync(torch, checker.device)
    t = time.perf_counter()
    for s in served:
        checker.flags(s[None])
    ms = (time.perf_counter() - t) * 1e3 / len(served)
    t = time.perf_counter()
    for s in served:  # the crossing alone: the frame to the card, as flags() sends it
        torch.from_numpy(np.ascontiguousarray(s[None])).to(checker.device)
        _sync(torch, checker.device)
    h2d = (time.perf_counter() - t) * 1e3 / len(served)
    trace = kernel_trace(torch, lambda: [checker.flags(s[None]) for s in served])
    say(f"sd15 12d: {card} | second /offer with every concept threshold at -2: {len(blacked)} of "
        f"{len(blacked)} frames black | the same frame twice: the tower ran {memo_calls} time(s) "
        f"| the checker (ViT-L/14 f32, the 512^2 frame to the card, resize, tower, heads, flags "
        f"back; host clock, synchronous) {ms:.2f} ms a frame over {len(served)} frames: the "
        f"frame's crossing {h2d:.3f} ms, device busy {trace['busy_ms'] / len(served):.3f} ms "
        f"({trace['kernels'] / len(served):.0f} kernels a frame, idle share {trace['idle']:.3f} "
        f"of the traced span: the host's launches)")
    if memo_calls != 1:
        fail("sd15 12d: a repeated frame ran the tower again")
    return tuple(total)


def phase_sd15_attention(torch, card: str, shapes=SD15_ATTENTION, batches=SD15_ATTENTION_B,
                         label: str = "sd15 12e", what: str = "SD1.5 step") -> dict:
    """12e: the attention kernel at one SD1.5 step's 32 launches (8 shapes,
    8 heads, D 40/80/160) at B = 4, 8 and 16 rows: each checked against its
    plain version (ops/kernels/tolerance.py), timed as phase 3 times it,
    beside SDPA and the bound; the sums over one step's launches.  (14e
    passes the ControlNet pass's 14 launches, 16e SDXL's 140; a shape's
    optional fifth entry is its heads, else 8.)  -> {B: the sums}."""
    import torch.nn.functional as F

    from ai_rtc_agent_tpu_torch.ops.kernels import attention as KA
    from ai_rtc_agent_tpu_torch.ops.kernels import tolerance

    gen = torch.Generator(device="cuda").manual_seed(12)
    n_launches = sum(x[3] for x in shapes)
    per_batch = {}
    for b in batches:
        sums = dict.fromkeys(("ms", "plain_ms", "sdpa_ms", "bound_ms"), 0.0)
        worst = 0.0
        for lq, lk, d, per_step, *heads in shapes:
            h = heads[0] if heads else 8
            q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                       for n in (lq, lk, lk))
            out = KA.flash_attention(q, k, v)
            torch.cuda.synchronize()
            e = tolerance.attention_error(out, KA.attention_plain(q, k, v))
            name = f"{label} attention B={b} Lq={lq} Lk={lk} H={h} D={d}"
            if not e["ok"]:
                fail(f"{name}: over tolerance ({e})")
            worst = max(worst, e["max_abs"] / max(e["tol_abs"], 1e-30))
            reps = 10 if lq * lk >= 1 << 20 else 50
            ms = time_ms(torch, lambda: KA.flash_attention(q, k, v), reps)
            plain = time_ms(torch, lambda: KA.attention_plain(q, k, v), max(3, reps // 5))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), reps)
            flops = 4.0 * b * h * lq * lk * d
            bms, by = bound(flops, PEAK_BF16_FLOPS, 2.0 * (2 * q.numel() + k.numel() + v.numel()))
            say(f"{name}: max_abs_err {e['max_abs']:.3e} (tol {e['tol_abs']:.3e}), rel L2 "
                f"{e['rel_l2']:.3e} | kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
                f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.4f} ms ({by}), x{per_step}/step")
            for key, val in (("ms", ms), ("plain_ms", plain), ("sdpa_ms", lib), ("bound_ms", bms)):
                sums[key] += per_step * val
            del q, k, v, out
        say(f"{label} attention per {what} ({n_launches} launches, B={b}): {card} | kernel "
            f"{sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f} ms, sdpa {sums['sdpa_ms']:.4f} ms, "
            f"bound {sums['bound_ms']:.4f} ms; worst max_abs_err {worst:.2f} of its tolerance")
        per_batch[b] = sums
    return per_batch


DC_INTERVAL = 3  # 13b/13c: UNET_CACHE=3, the JAX bench default
VARIANT_PARITY = 4  # 13a: frames held to the f32 references from one state
AB_STEPS = 6  # 13a/13b: steps traced per side in each turn
AB_TURNS = ("dense", "w8", "w8", "dense")  # 13a: ABBA, the busy time a step
DC_FRAMES = 16  # 13b: frames per session in each timed run at k=1 (outputs 5-16 steady)
DC_TURNS = ("full", "deepcache", "deepcache", "full")  # 13b: fps at k=1, ABBA
CADENCE_STEPS = 12  # 13b: the pipeline's cadence, captures at ticks 0, 3, 6, 9
QUALITY_FRAMES, QUALITY_WARMUP = 18, 6  # 13b: moving_scene, steady outputs only
VARIANT_K = (1, 2)  # 13a-c: sessions through the bucket graphs


def _tensors(tree):
    """Every tensor leaf of a param tree (dicts, lists, None)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif tree is not None:
        yield tree


def param_bytes(tree) -> int:
    """Bytes of a param tree's tensors as they sit in memory."""
    return sum(a.numel() * a.element_size() for a in _tensors(tree))


def w8_pairs(tree) -> list:
    """The (kernel_q, scale) pairs of a param tree."""
    if isinstance(tree, dict):
        if "kernel_q" in tree:
            return [(tree["kernel_q"], tree["scale"])]
        return [p for v in tree.values() for p in w8_pairs(v)]
    if isinstance(tree, (list, tuple)):
        return [p for v in tree for p in w8_pairs(v)]
    return []


def graft_w8(f32_tree, w8_tree):
    """``f32_tree`` with each kernel that ``w8_tree`` holds as a w8 pair
    replaced by that pair (its int8 values, its f32 scale): the f32
    reference with the same quantized weights; every other leaf stays f32."""
    if isinstance(w8_tree, dict):
        if "kernel_q" in w8_tree:
            out = {k: v for k, v in f32_tree.items() if k != "kernel"}
            out.update(kernel_q=w8_tree["kernel_q"], scale=w8_tree["scale"])
            return out
        return {k: graft_w8(f32_tree[k], v) for k, v in w8_tree.items()}
    if isinstance(w8_tree, (list, tuple)):
        return type(w8_tree)(graft_w8(a, b) for a, b in zip(f32_tree, w8_tree))
    return f32_tree


def attention_per_pass(ucfg, cached: bool) -> int:
    """Attention launches of one UNet pass (self and cross in each
    transformer block); ``cached``: a DeepCache cached pass, which keeps
    only the first down block's and the last up block's."""
    if cached:
        n = (2 * ucfg.layers_per_block + 1) if ucfg.attn_blocks[0] else 0
        return 2 * ucfg.transformer_layers_per_block[0] * n
    blocks = sum(d * (2 * ucfg.layers_per_block + 1)
                 for d, a in zip(ucfg.transformer_layers_per_block, ucfg.attn_blocks) if a)
    return 2 * (blocks + ucfg.transformer_layers_per_block[-1])


def engine_replay_equals_eager(torch, label: str, eng, frame) -> str:
    """Each captured step of an engine (both DeepCache variants) against its
    eager step from a copy of the same state and frame: the preflight's
    check (assets/build_engines.py), the outputs and every state leaf bit
    for bit."""
    from ai_rtc_agent_tpu_torch.assets.build_engines import engine_replay_equals_eager as check

    try:
        keys = check(eng, frame[None])
    except RuntimeError as e:
        fail(f"{label}: {e}")
    return f"replay = eager bit for bit ({len(keys)} captured steps: outputs and state)"


def bucket_launches(sched) -> dict:
    """{(k, variant): (attention, epilogue) a replay} of a scheduler's captured buckets."""
    steps = sched._bucket.graph_cache.steps()
    return {kv: steps[key].launches for kv, key in sched.bucket_keys().items() if key in steps}


def timed_busy(torch, fn, steps: int = 0, attention_a_step: int = 0) -> dict:
    """A device-only trace of ``fn``: busy ms a step, idle share, attention
    ms a step (the trace's attention kernels), over ``steps`` steps, or
    over the trace's attention kernels / ``attention_a_step``."""
    tr = kernel_trace(torch, fn)
    steps = steps or tr["attention"] // attention_a_step
    if not steps:
        fail("the trace shows no step")
    return {"busy": tr["busy_ms"] / steps, "idle": tr["idle"], "attn": tr["attention_ms"] / steps,
            "kernels": tr["kernels"] / steps, "steps": steps}


def variant_busy(torch, sched, k: int, variant: str, reps: int) -> dict:
    """Busy ms of ``reps`` replays of bucket k's ``variant`` over k blank
    frames and slots 0..k-1 (the states are put back after)."""
    from ai_rtc_agent_tpu_torch.stream.engine import install_state
    from ai_rtc_agent_tpu_torch.tree import tree_map

    frames = torch.zeros((k, sched.height, sched.width, 3), dtype=torch.uint8, device=sched.device)
    with sched._step_lock:
        saved = tree_map(lambda a: a.clone(), sched.states)
        out = timed_busy(torch, lambda: [sched._bucket(sched.params, sched.states, list(frames),
                                                       list(range(k)), k, variant)
                                         for _ in range(reps)], reps)
        install_state(sched.states, saved)
    return out


def phase_variants(torch, card: str, turbo_id: str = "stabilityai/sd-turbo",
                   ring_id: str = SD15_ID) -> tuple:
    """Phase 13: the speed variants through the captured steps — w8 weights
    (13a), DeepCache at N=3 (13b), both at once (13c), on sd-turbo's
    pipeline and the SD1.5 ring's bucket graphs.  -> the attention and
    epilogue launches of its counted runs."""
    import numpy as np

    from ai_rtc_agent_tpu_torch.models import registry
    from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline

    t_phase = time.perf_counter()
    total = [0, 0]
    turbo = StreamDiffusionPipeline(turbo_id, seed=2)
    ring = StreamDiffusionPipeline(ring_id, seed=2)
    with _Env(QUANT_WEIGHTS="w8"):
        turbo8 = StreamDiffusionPipeline(turbo_id, seed=2)
        ring8 = StreamDiffusionPipeline(ring_id, seed=2)
    for part in (variants_w8, variants_deepcache, variants_both):
        a, e = part(torch, np, card, turbo, turbo8, ring, ring8, registry)
        total[0] += a
        total[1] += e
    say(f"variants: phase 13 took {time.perf_counter() - t_phase:.1f} s; launches counted "
        f"attention {total[0]}, epilogue {total[1]}")
    return tuple(total)


def variants_w8(torch, np, card, turbo, turbo8, ring, ring8, registry) -> tuple:
    """13a: w8 weights (QUANT_WEIGHTS=w8) on sd-turbo's pipeline graph and the
    SD1.5 ring's bucket graphs at k = 1 and 2."""
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    cuda = turbo.device.type == "cuda"
    total = [0, 0]
    per = attention_per_pass(turbo.bundle.unet_cfg, False)
    # -- the bytes on the device, and int8 staying int8 ---------------------------------
    for name, dense, w8 in (("sd-turbo", turbo, turbo8), ("sd15", ring, ring8)):
        pairs = w8_pairs(w8.bundle.params)
        if not pairs or any(q.dtype != torch.int8 or q.device.type != w8.device.type
                            or s.dtype != torch.float32 for q, s in pairs):
            fail(f"variants 13a {name}: the w8 kernels are not int8 (+ f32 scale) on the device")
        u_d, u_w = param_bytes(dense.bundle.params["unet"]), param_bytes(w8.bundle.params["unet"])
        a_d, a_w = param_bytes(dense.bundle.params), param_bytes(w8.bundle.params)
        q = sum(k.numel() for k, _ in pairs)
        say(f"variants 13a {name}: {card} | parameter bytes on the device, {dense.config.dtype} -> "
            f"w8: UNet "
            f"{u_d} -> {u_w} ({(u_d - u_w) / 1e9:.3f} GB less, x{u_w / u_d:.3f}), bundle {a_d} -> "
            f"{a_w} ({(a_d - a_w) / 1e9:.3f} GB less, x{a_w / a_d:.3f}) | {len(pairs)} kernels "
            f"int8 ({q} elements, {q / 1e6:.1f}M), key {w8.engine.key.split('--v-')[0][-60:]}")
        if "quant-w8" not in w8.engine.key or u_w >= u_d:
            fail(f"variants 13a {name}: the w8 tree is not smaller, or its key lacks quant-w8")
    # -- sd-turbo through the pipeline's graph ------------------------------------------
    frames = _frames(np, VARIANT_PARITY + 2, seed=131, size=turbo.config.height)
    eq = engine_replay_equals_eager(torch, "variants 13a sd-turbo w8", turbo8.engine, frames[0])
    ref_d = registry.load_model_bundle(turbo.model_id, attn_impl="plain", seed=0)
    ref_d.params = registry.cast_params(ref_d.params, "float32")
    ref_w = registry.load_model_bundle(turbo.model_id, attn_impl="plain",
                                       params=graft_w8(ref_d.params, turbo8.bundle.params))
    dist = {}
    outs = {}
    for name, pipe, ref in (("dense", turbo, ref_d), ("w8", turbo8, ref_w)):
        ded = Dedicated(torch, pipe.bundle.stream_models, pipe.bundle.params, pipe.config,
                        pipe.bundle.encode_prompt, ref, session_row(pipe.engine.state, None),
                        pipe.device)
        _reset_launches()
        got = [pipe(f) for f in frames[:VARIANT_PARITY]]
        a, e = _launches()
        for f in frames[:VARIANT_PARITY]:
            ded(f)
        if (a, e) != (per * VARIANT_PARITY, VARIANT_PARITY):
            fail(f"variants 13a sd-turbo {name}: {a} attention and {e} epilogue launches over "
                 f"{VARIANT_PARITY} steps, want {per} + 1 a step")
        total[0] += a
        total[1] += e
        g = np.stack(got).astype(np.float32)
        dist[name] = (np.abs(g - np.stack(ded.refs)).mean(), np.abs(g - np.stack(ded.outs)).max())
        outs[name] = g
        del ded
    del ref_d, ref_w
    moved = np.abs(outs["w8"] - outs["dense"])
    say(f"variants 13a sd-turbo: {card} | {eq} | {VARIANT_PARITY} frames from one state, each "
        f"against the f32 reference with its own weights: w8 {dist['w8'][0]:.3f} levels (its "
        f"eager engine max {dist['w8'][1]:.0f}), dense {dist['dense'][0]:.3f} (max "
        f"{dist['dense'][1]:.0f}) | w8 vs dense: mean {moved.mean():.3f} max {moved.max():.0f} "
        f"levels")
    if dist["w8"][0] > 2 * dist["dense"][0] + 0.5:
        fail(f"variants 13a sd-turbo: w8 strays from its f32 reference ({dist['w8'][0]:.3f} vs "
             f"the dense path's {dist['dense'][0]:.3f} levels)")
    if cuda:  # busy ms a step, ABBA
        busy = {"dense": [], "w8": []}
        for side in AB_TURNS:
            pipe = turbo if side == "dense" else turbo8
            f = frames[-1]
            pipe(f)
            busy[side].append(timed_busy(torch, lambda: [pipe(f) for _ in range(AB_STEPS)],
                                         AB_STEPS))
        say(f"variants 13a sd-turbo A/B ({' '.join(AB_TURNS)}, {AB_STEPS} steps a turn, device "
            f"busy ms a step): {card} | dense " + " / ".join(
                f"{b['busy']:.3f}" for b in busy["dense"]) + " | w8 " + " / ".join(
                f"{b['busy']:.3f}" for b in busy["w8"]) + f" | w8 - dense "
            f"{_median([b['busy'] for b in busy['w8']]) - _median([b['busy'] for b in busy['dense']]):+.3f} ms")
    # -- the SD1.5 ring through the bucket graphs, k = 1 and 2 ------------------------------
    ref_d = registry.load_model_bundle(ring.model_id, attn_impl="plain", seed=0)
    ref_d.params = registry.cast_params(ref_d.params, "float32")
    ref_w = registry.load_model_bundle(ring.model_id, attn_impl="plain",
                                       params=graft_w8(ref_d.params, ring8.bundle.params))
    del ref_d
    scheds = {name: BatchScheduler.from_pipeline(p, max_sessions=max(VARIANT_K))
              for name, p in (("dense", ring), ("w8", ring8))}
    per = attention_per_pass(ring.bundle.unet_cfg, False)
    try:
        frames = [_frames(np, VARIANT_PARITY + 2 * AB_STEPS, seed=133 + i, size=ring.config.height)
                  for i in range(max(VARIANT_K))]
        for k in VARIANT_K:
            sess = {name: [s.claim(f"w8-{name}-{k}-{i}", prompt=SESSION_PROMPTS[i], seed=500 + i)
                           for i in range(k)] for name, s in scheds.items()}
            s8 = scheds["w8"]
            eq = replay_equals_eager(torch, np, f"variants 13a sd15 w8 k={k}", s8,
                                     np.stack([f[0] for f in frames[:k]]),
                                     [x.slot for x in sess["w8"]])
            rows = [session_row(s8.states, x.slot) for x in sess["w8"]]
            _sync(torch, s8.device)
            _reset_launches()
            steps0 = s8.steps_total
            run = drive_sessions(torch, sess["w8"], frames, VARIANT_PARITY)
            a, e = _count(f"variants 13a sd15 w8 k={k}", (0, 0), s8.steps_total - steps0,
                          (per, 1))
            total[0] += a
            total[1] += e
            held = []
            for i, x in enumerate(sess["w8"]):
                ded = Dedicated(torch, ring8.bundle.stream_models, ring8.bundle.params,
                                ring8.config, ring8.bundle.encode_prompt, ref_w, rows[i],
                                ring8.device)
                for f in frames[i][:VARIANT_PARITY]:
                    ded(f)
                held.append(hold_to_references(np, f"variants 13a sd15 w8 k={k} session {i}",
                                               run.outs[i], ded))
            dense_run = drive_sessions(torch, sess["dense"], frames, VARIANT_PARITY)
            moved = max(np.abs(np.asarray(x, np.int16) - y).max()
                        for o, d in zip(run.outs, dense_run.outs) for x, y in zip(o, d))
            line = (f"variants 13a sd15 w8 k={k}: {card} | {eq} | {VARIANT_PARITY} frames a "
                    f"session: " + "; ".join(held) + f" | w8 vs dense max {moved} levels")
            if cuda:  # busy ms a bucket step, ABBA
                busy = {"dense": [], "w8": []}
                for j, side in enumerate(AB_TURNS):
                    sl = slice(VARIANT_PARITY + (j % 2) * AB_STEPS,
                               VARIANT_PARITY + (j % 2 + 1) * AB_STEPS)
                    busy[side].append(timed_busy(torch, lambda: drive_sessions(
                        torch, sess[side], [f[sl] for f in frames], AB_STEPS),
                        attention_a_step=per))
                line += (f" | A/B busy ms a bucket step ({' '.join(AB_TURNS)}, {AB_STEPS} frames a "
                         f"session a turn): dense " + " / ".join(
                             f"{b['busy']:.3f} ({b['steps']} steps)" for b in busy["dense"])
                         + ", w8 " + " / ".join(
                             f"{b['busy']:.3f} ({b['steps']} steps)" for b in busy["w8"]))
            say(line)
            for x in sess["dense"] + sess["w8"]:
                x.release()
    finally:
        for s in scheds.values():
            s.close()
    del ref_w
    return tuple(total)


def variants_deepcache(torch, np, card, turbo, turbo8, ring, ring8, registry) -> tuple:
    """13b: DeepCache at N=3 on sd-turbo's pipeline graphs and the SD1.5
    ring's bucket graphs: both graphs of every bucket captured at prewarm,
    each replay = its eager step, the cadence, forced captures (a join, a
    prompt), a move between schedulers, busy ms capture vs cached, fps full
    vs N=3 at k=1, PSNR/SSIM against the full stream."""
    from ai_rtc_agent_tpu_torch.ops.kernels import attention as KA
    from ai_rtc_agent_tpu_torch.stream.engine import fused_ok
    from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler
    from ai_rtc_agent_tpu_torch.utils.quality import moving_scene, psnr, ssim

    cuda = turbo.device.type == "cuda"
    total = [0, 0]
    # -- sd-turbo: the pipeline's two graphs and the cadence ----------------------------
    t = time.perf_counter()
    dc = StreamDiffusionPipeline(turbo.model_id, seed=2,
                                 config=replace(turbo.config, unet_cache_interval=DC_INTERVAL))
    built = time.perf_counter() - t
    eng = dc.engine
    ucfg = dc.bundle.unet_cfg
    per = {"capture": attention_per_pass(ucfg, False), "cached": attention_per_pass(ucfg, True)}
    epi = 1 if fused_ok(dc.config) else 0
    steps = eng.graph_cache.steps()
    launches = {v: steps[eng.keys[v]].launches for v in eng.variants}
    if cuda and launches != {v: (per[v], epi) for v in eng.variants}:
        fail(f"variants 13b sd-turbo: the captured pair records {launches} launches a replay, "
             f"want {per} + {epi}")
    if eng._tick != 0 or (cuda and not all(eng.graph_cache.status().values())):
        fail("variants 13b sd-turbo: the pipeline did not capture both graphs and reset the cadence")
    frames = moving_scene(max(CADENCE_STEPS, QUALITY_FRAMES), dc.config.height, dc.config.width)
    seq = []
    _reset_launches()
    for f in frames[:CADENCE_STEPS]:
        before = KA.launches
        dc(f)
        seq.append(KA.launches - before)
    a, e = _launches()
    want = [per["capture"] if i % DC_INTERVAL == 0 else per["cached"]
            for i in range(CADENCE_STEPS)]
    if seq != want:
        fail(f"variants 13b sd-turbo: attention launches per step {seq}, want {want} (captures at "
             f"ticks 0, 3, 6, 9)")
    total[0] += a
    total[1] += e
    eq = engine_replay_equals_eager(torch, "variants 13b sd-turbo", eng, frames[0])
    # the quality of N=3 against the full stream, from one state
    eng.prepare(dc.prompt, seed=2)
    turbo.engine.prepare(turbo.prompt, seed=2)
    full = [turbo(f) for f in frames[:QUALITY_FRAMES]]
    cached = [dc(f) for f in frames[:QUALITY_FRAMES]]
    # one stage and no ring: a capture step's frame is the full stream's, so
    # the cached steps' frames carry the comparison
    same = sum(np.array_equal(x, y) for i, (x, y) in enumerate(zip(full, cached))
               if i % DC_INTERVAL == 0)
    pairs = [(x, y) for i, (x, y) in enumerate(zip(full, cached))
             if i >= QUALITY_WARMUP and i % DC_INTERVAL]
    p = float(np.mean([psnr(x, y) for x, y in pairs]))
    s = float(np.mean([ssim(x, y) for x, y in pairs]))
    line = (f"variants 13b sd-turbo N={DC_INTERVAL}: {card} | pipeline built in {built:.1f}s, "
            f"both graphs captured ({', '.join(f'{v} {launches[v]}' for v in eng.variants)} "
            f"launches a replay), the first frame a capture | attention launches per step over "
            f"{CADENCE_STEPS} frames {seq} | {eq} | moving_scene {dc.config.height}^2, "
            f"{QUALITY_FRAMES} frames from one state vs the full stream: the capture steps' frames "
            f"equal it ({same} of {len(range(0, QUALITY_FRAMES, DC_INTERVAL))}), the cached steps' "
            f"frames past output {QUALITY_WARMUP} ({len(pairs)}): PSNR {p:.2f} dB, SSIM {s:.4f}")
    if cuda:
        busy = {}
        for v, step in eng._static_steps_locked().items():
            busy[v] = timed_busy(torch, lambda step=step: [step.run() for _ in range(AB_STEPS)],
                                 AB_STEPS)
        line += (f" | busy ms a replay: capture {busy['capture']['busy']:.3f} (attention "
                 f"{busy['capture']['attn']:.3f}), cached {busy['cached']['busy']:.3f} (attention "
                 f"{busy['cached']['attn']:.3f}, {busy['cached']['attn'] / busy['cached']['busy']:.3f}"
                 f" of it), ratio {busy['cached']['busy'] / busy['capture']['busy']:.3f} (the JAX "
                 f"package's FLOP count: 0.54x)")
        eng.prepare(dc.prompt, seed=2)
    say(line)
    del dc, eng
    # -- the SD1.5 ring through the bucket graphs ---------------------------------------
    cfg = replace(ring.config, unet_cache_interval=DC_INTERVAL)
    rdc = StreamDiffusionPipeline(ring.model_id, seed=2, config=cfg)
    t = time.perf_counter()
    # a long window: every bucket step carries every live session that has a
    # frame waiting (a session alone steps at once), so the cadence's steps
    # are the ones counted below
    sched = BatchScheduler.from_pipeline(rdc, max_sessions=max(VARIANT_K), window_ms=10_000.0)
    built = time.perf_counter() - t
    dest = BatchScheduler.from_pipeline(rdc, max_sessions=max(VARIANT_K), window_ms=10_000.0)
    full = BatchScheduler.from_pipeline(ring, max_sessions=max(VARIANT_K))
    ucfg = rdc.bundle.unet_cfg
    per = {"capture": attention_per_pass(ucfg, False), "cached": attention_per_pass(ucfg, True)}
    try:
        got = bucket_launches(sched)
        want = {(k, v): (per[v], 1) for k in sched._bucket_sizes for v in ("capture", "cached")}
        if cuda and (got != want or not all(sched.graph_status().values())):
            fail(f"variants 13b sd15: prewarm captured {sched.graph_status()} with {got} "
                 f"launches a replay, want every (bucket, variant) and {want}")
        say(f"variants 13b sd15 N={DC_INTERVAL}: {card} | buckets {sched._bucket_sizes} x "
            f"(capture, cached) captured at prewarm in {built:.1f}s: {got}")
        frames = [_frames(np, DC_FRAMES, seed=150 + i, size=cfg.height) for i in range(2)]
        variants = []
        real = sched._next_variant_locked

        def spy(slots):
            v = real(slots)
            variants.append((sched._bucket_for(len(slots)), v))
            return v

        sched._next_variant_locked = spy
        # a alone (capture, cached); b joins, and a steps on alone (the join
        # resets the cadence: capture, cached); b's first ride, mid-cadence
        # at tick 2, captures; a prompt on a: the next step captures
        a_ = sched.claim("dc-a", prompt=SESSION_PROMPTS[0], seed=600)
        eqs = [f"k=1 {v}: " + replay_equals_eager(
            torch, np, f"variants 13b sd15 k=1 {v}", sched, np.stack(frames[0][:1]), [a_.slot], v)
            for v in ("capture", "cached")]
        _reset_launches()
        drive_sessions(torch, [a_], frames, 2)
        b_ = sched.claim("dc-b", prompt=SESSION_PROMPTS[1], seed=601)
        window, sched.window_s = sched.window_s, 0.0  # a alone while b is live
        drive_sessions(torch, [a_], [frames[0][2:]], 2)
        sched.window_s = window
        both = [a_, b_]
        drive_sessions(torch, both, [frames[0][4:], frames[1]], 3)
        a_.update_prompt(SESSION_PROMPTS[2])
        drive_sessions(torch, both, [frames[0][7:], frames[1][3:]], 2)
        a, e = _launches()
        sched._next_variant_locked = real
        eqs += [f"k=2 {v}: " + replay_equals_eager(
            torch, np, f"variants 13b sd15 k=2 {v}", sched, np.stack([frames[0][9], frames[1][5]]),
            [x.slot for x in both], v) for v in ("capture", "cached")]
        want = [(1, "capture"), (1, "cached"), (1, "capture"), (1, "cached"), (2, "capture"),
                (2, "capture"), (2, "cached"), (2, "capture"), (2, "cached")]
        if variants != want:
            fail(f"variants 13b sd15: bucket steps {variants}, want {want} (a join and a prompt "
                 "force a capture)")
        want = (sum(per[v] for _, v in want), len(want))
        if (a, e) != want:
            fail(f"variants 13b sd15: {a} attention and {e} epilogue launches, want {want}")
        total[0] += a
        total[1] += e
        say(f"variants 13b sd15: {card} | " + "; ".join(eqs) + f" | bucket steps (a alone, b joins "
            f"and a steps on alone, both, a prompt, both): {variants}, launches attention {a}, "
            f"epilogue {e}")
        # a move: a's snapshot restored on another scheduler, and as the reference on this one
        snap = sched.snapshot_session("dc-a")
        b_.release()
        a_.release()
        t = time.perf_counter()
        moved = dest.restore_session(snap, "dc-moved")
        ref = sched.restore_session(snap, "dc-ref")
        restore_ms = (time.perf_counter() - t) * 1e3
        if moved.slot != ref.slot or moved.slot not in dest._uncaptured:
            fail("variants 13b sd15: the restored sessions are not at one slot, uncaptured")
        seen = []
        real = dest._next_variant_locked
        dest._next_variant_locked = lambda slots: seen.append(real(slots)) or seen[-1]
        after = [frames[0][8:14]]
        mv = drive_sessions(torch, [moved], after, 6)
        rf = drive_sessions(torch, [ref], after, 6)
        dest._next_variant_locked = real
        same = all(np.array_equal(x, y) for x, y in zip(mv.outs[0], rf.outs[0]))
        nbytes = len(_state_bytes(snap))
        say(f"variants 13b sd15 move: {card} | snapshot {nbytes} B (the row with its deep cache "
            f"{tuple(dest.states['unet_cache'][moved.slot].shape)}), cache_tick "
            f"{snap['cache_tick']}, "
            f"uncaptured {snap['cache_uncaptured']}; restored on another scheduler and as the "
            f"reference in {restore_ms:.1f} ms; its steps {seen}; 6 frames vs the reference: "
            f"{'bit for bit' if same else 'DIFFER'}")
        if seen[0] != "capture" or not same:
            fail("variants 13b sd15 move: the restored session must ride a capture first and then "
                 "match the reference restored from the same snapshot bit for bit")
        moved.release()
        ref.release()
        # busy ms of each variant at k = 1 and 2, and fps full vs N=3 at k = 1
        if cuda:
            rows = []
            for k in VARIANT_K:
                b = {v: variant_busy(torch, sched, k, v, AB_STEPS) for v in ("capture", "cached")}
                rows.append(f"k={k}: capture {b['capture']['busy']:.3f} ms (attention "
                            f"{b['capture']['attn']:.3f}), cached {b['cached']['busy']:.3f} ms "
                            f"(attention {b['cached']['attn']:.3f}, "
                            f"{b['cached']['attn'] / b['cached']['busy']:.3f} of it), ratio "
                            f"{b['cached']['busy'] / b['capture']['busy']:.3f}")
            fps = {"full": [], "deepcache": []}
            steps_ms = {"full": [], "deepcache": []}
            captures = []
            for side in DC_TURNS:
                s_ = full if side == "full" else sched
                x = s_.claim(f"fps-{side}", prompt=SESSION_PROMPTS[0], seed=610)
                before, steps0 = KA.launches, s_.steps_total
                run = drive_sessions(torch, [x], frames, DC_FRAMES)
                fps[side].append(run.steady_fps(SD15_FILL)[0])
                steps_ms[side].append(run.steady_step_ms(SD15_FILL)[0])
                if side == "deepcache":  # captures among the run's steps, from its launches
                    n = s_.steps_total - steps0
                    c = (KA.launches - before - per["cached"] * n) // (
                        per["capture"] - per["cached"])
                    captures.append(f"{c} of {n}")
                x.release()
            say(f"variants 13b sd15 busy ms a bucket step (replays of blank frames, "
                f"{AB_STEPS} each): {card} | " + "; ".join(rows) + f" | k=1 steady window "
                f"(outputs {SD15_FILL + 1}-{DC_FRAMES}, {' '.join(DC_TURNS)}): full " + " / ".join(
                    f"{f:.2f} fps ({m:.2f} ms)" for f, m in zip(fps["full"], steps_ms["full"]))
                + f", N={DC_INTERVAL} " + " / ".join(
                    f"{f:.2f} fps ({m:.2f} ms, captures {c})" for f, m, c in zip(
                        fps["deepcache"], steps_ms["deepcache"], captures)))
        # quality on the ring: N=3 vs the full stream from one state
        scene = moving_scene(QUALITY_FRAMES, cfg.height, cfg.width)
        outs = {}
        for side, s_ in (("full", full), ("deepcache", sched)):
            x = s_.claim(f"q-{side}", prompt=SESSION_PROMPTS[0], seed=620)
            outs[side] = [x(f) for f in scene][QUALITY_WARMUP:]
            x.release()
        p = float(np.mean([psnr(x, y) for x, y in zip(outs["full"], outs["deepcache"])]))
        s = float(np.mean([ssim(x, y) for x, y in zip(outs["full"], outs["deepcache"])]))
        say(f"variants 13b sd15 quality: {card} | moving_scene {cfg.height}^2, {QUALITY_FRAMES} "
            f"frames (outputs {QUALITY_WARMUP + 1}-{QUALITY_FRAMES}), N={DC_INTERVAL} vs the full "
            f"stream, random weights: PSNR {p:.2f} dB, SSIM {s:.4f}")
    finally:
        for s_ in (sched, dest, full):
            s_.close()
    return tuple(total)


def variants_both(torch, np, card, turbo, turbo8, ring, ring8, registry) -> tuple:
    """13c: w8 weights and DeepCache at once, through the scheduler's bucket
    graphs at k=2: one run of both variants, each replay = its eager step,
    the launches counted."""
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    eng = ring8.engine
    cfg = replace(ring8.config, unet_cache_interval=DC_INTERVAL)
    sched = BatchScheduler(eng.models, eng.params, cfg, eng.encode_prompt, model_id=ring8.model_id,
                           max_sessions=2, schedule=eng.schedule, device=ring8.device,
                           window_ms=10_000.0)
    ucfg = ring8.bundle.unet_cfg
    per = {"capture": attention_per_pass(ucfg, False), "cached": attention_per_pass(ucfg, True)}
    try:
        keys = sched.bucket_keys()
        if not all("quant-w8" in k and f"dcache-{DC_INTERVAL}" in k for k in keys.values()):
            fail(f"variants 13c: the keys lack quant-w8 or dcache: {keys}")
        sess = [sched.claim(f"both-{i}", prompt=SESSION_PROMPTS[i], seed=700 + i) for i in range(2)]
        frames = [_frames(np, 2 * DC_INTERVAL, seed=170 + i, size=cfg.height) for i in range(2)]
        eqs = [replay_equals_eager(torch, np, f"variants 13c {v}", sched,
                                   np.stack([f[0] for f in frames]), [x.slot for x in sess], v)
               for v in ("capture", "cached")]
        _reset_launches()
        steps0 = sched.steps_total
        seen = []
        real = sched._next_variant_locked
        sched._next_variant_locked = lambda slots: seen.append(real(slots)) or seen[-1]
        run = drive_sessions(torch, sess, frames, 2 * DC_INTERVAL)
        sched._next_variant_locked = real
        a, e = _launches()
        n = sched.steps_total - steps0
        want = (sum(per[v] for v in seen), len(seen))
        if (a, e) != want or n != len(seen) or seen[0] != "capture":
            fail(f"variants 13c: {a} attention and {e} epilogue launches over {n} bucket steps "
                 f"{seen}, want {want}")
        ok = all(o.shape == (cfg.height, cfg.width, 3) for out in run.outs for o in out)
        say(f"variants 13c w8 + DeepCache N={DC_INTERVAL}, k=2: {card} | {'; '.join(eqs)} | "
            f"{n} bucket steps {seen}: attention {a}, epilogue {e} launches | frames "
            f"{'ok' if ok else 'BAD'} | keys {keys[(2, 'cached')].split('--v-')[0][-70:]}")
        if not ok:
            fail("variants 13c: bad output frames")
        for x in sess:
            x.release()
        return a, e
    finally:
        sched.close()


CNET_HUB = Path(__file__).resolve().parent / "build" / "phase14-hub"
CNET_DIR = CNET_HUB / "control_v11p_sd15_canny"  # a diffusers-named ControlNet snapshot
HED_PTH = CNET_HUB / "ControlNetHED.pth"
CNET_SEED = 14
CNET_ZERO_GAIN = 0.5  # 14a: zero convs N(0, (gain / sqrt(fan_in))^2): the residuals move the output
CNET_K = (1, 2)  # 14b: sessions through the bucket graphs
CNET_PARITY = 6  # 14b-c: each session's first outputs held to its references
CNET_AB_FRAMES = 10  # 14b: frames a session in each timed turn (outputs 5-10 steady)
CNET_TURNS = ("cnet", "plain", "plain", "cnet")  # 14b: ABBA against the plain ring
CNET_TRACE_FRAMES = 6  # 14b: frames a session in each turn's device trace
CNET_SERVE = 6  # 14d: frames viewed through the WHIP session, then again after the move
# the ControlNet pass at 512^2, 8 heads: (Lq, Lk, D, launches): 14 in all
CNET_ATTENTION = [
    (4096, 4096, 40, 2), (4096, 77, 40, 2), (1024, 1024, 80, 2), (1024, 77, 80, 2),
    (256, 256, 160, 2), (256, 77, 160, 2), (64, 64, 160, 1), (64, 77, 160, 1),
]
CNET_ATTENTION_B = (4, 8)  # the ring's rows at k = 1 and 2


def cnet_snapshot(torch, np, model_id: str, device) -> tuple:
    """14a: the port's seeded ControlNet of ``model_id``'s family
    (control_v11p_sd15_canny's geometry for SD1.5) with every zero conv and
    the cond embedding's conv_out filled from a seed (kernel N(0, (
    CNET_ZERO_GAIN / sqrt(fan_in))^2), bias N(0, 0.01^2)), written as
    diffusers' ControlNetModel safetensors at CNET_DIR through
    loader.controlnet_key_map (f32); and HED_PTH, a ControlNetHED.pth of the
    seeded FULL_STAGES net with a non-zero input bias and biases, in the
    checkpoint's names (``netNetwork.`` prefix).  -> (the ControlNet tree,
    the HED tree, bytes written)."""
    from ai_rtc_agent_tpu_torch.models import controlnet as CN
    from ai_rtc_agent_tpu_torch.models import hed as HED
    from ai_rtc_agent_tpu_torch.models import loader as LD
    from ai_rtc_agent_tpu_torch.models import registry

    fam = registry.family_of(model_id)
    cfg = registry._model_configs(fam)[0]
    num_down = 2 if fam == "tiny" else 3
    gen = torch.Generator(device=device).manual_seed(CNET_SEED)
    tree = CN.init_controlnet(gen, cfg, num_down=num_down, device=device)
    for zc in tree["zero_convs"] + [tree["mid_zero_conv"], tree["cond_embedding"]["conv_out"]]:
        shape = zc["kernel"].shape
        zc["kernel"] = torch.randn(shape, generator=gen, device=device) * (
            CNET_ZERO_GAIN / math.sqrt(shape[1] * shape[2] * shape[3]))
        zc["bias"] = torch.randn(zc["bias"].shape, generator=gen, device=device) * 0.01
    CNET_DIR.mkdir(parents=True, exist_ok=True)
    path = CNET_DIR / "diffusion_pytorch_model.safetensors"
    LD.write_safetensors(str(path), LD.tree_to_state_dict(
        tree, LD.controlnet_key_map(cfg, num_down)))
    hed = HED.init_hed(torch.Generator().manual_seed(CNET_SEED), HED.FULL_STAGES)
    rng = np.random.default_rng(CNET_SEED)
    hed["norm"] = torch.from_numpy(rng.uniform(90, 130, (1, 1, 1, 3)).astype(np.float32))
    sd = {"netNetwork.norm": hed["norm"].reshape(1, 3, 1, 1)}
    for i, (_, cout, _) in enumerate(HED.FULL_STAGES, start=1):
        blk = hed[f"block{i}"]
        for j, conv in enumerate(blk["convs"]):
            conv["bias"] = torch.from_numpy((0.05 * rng.standard_normal(cout)).astype(np.float32))
            sd[f"netNetwork.block{i}.convs.{j}.weight"] = conv["kernel"]
            sd[f"netNetwork.block{i}.convs.{j}.bias"] = conv["bias"]
        sd[f"netNetwork.block{i}.projection.weight"] = blk["projection"]["kernel"]
        sd[f"netNetwork.block{i}.projection.bias"] = blk["projection"]["bias"]
    torch.save(sd, HED_PTH)
    return tree, hed, path.stat().st_size + HED_PTH.stat().st_size


def _levels(a, b) -> int:
    """The largest difference of two uint8 frames, in levels."""
    import numpy as np

    return int(np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max())


def hold_tree(torch, label: str, got, want, dtype) -> int:
    """Every leaf of ``got`` equal to ``want``'s at the same path, cast once
    to ``dtype``, bit for bit, and no leaf missing.  -> leaves checked."""
    want_leaves = dict(_tree_paths(want))
    n = 0
    for path, leaf in _tree_paths(got):
        ref = want_leaves.get(path)
        if ref is None or leaf.shape != ref.shape or not torch.equal(
                leaf, ref.to(device=leaf.device, dtype=dtype)):
            fail(f"{label}: leaf {'/'.join(map(str, path))} is not the written tree, cast once")
        n += 1
    if n != len(want_leaves):
        fail(f"{label}: {n} leaves loaded of the {len(want_leaves)} written")
    return n


def cnet_per_step(ucfg, cfg) -> tuple:
    """(attention, epilogue) launches of a ControlNet bucket step of ``cfg``:
    each UNet pass (one; sequential mode one a stage) beside one ControlNet
    pass, whose transformers are the encoder half's and the mid block's
    (14 at SD1.5); the epilogue where the ring runs it."""
    from ai_rtc_agent_tpu_torch.stream.engine import fused_ok

    unet = attention_per_pass(ucfg, False)
    up = 2 * sum(d * (ucfg.layers_per_block + 1)
                 for d, a in zip(ucfg.transformer_layers_per_block, ucfg.attn_blocks) if a)
    passes = 1 if cfg.use_denoising_batch else cfg.n_stages
    return passes * (2 * unet - up), int(fused_ok(cfg))


def _install_rows(sched, sess, rows, **edits):
    """Each session's slot set to its saved row (``edits`` replacing leaves,
    e.g. cnet_scale); leaves the scheduler's state lacks are left out."""
    for x, row in zip(sess, rows):
        sched._install(x.slot, {k: edits.get(k, v) for k, v in row.items() if k in sched.states})


def bucket_outputs(sched, sess, frames, n: int):
    """``n`` steps of the sessions ``sess`` through ``sched``'s bucket of
    len(sess) (its graph on the card), under the step lock: -> uint8
    [n, k, H, W, 3].  Every step has the same riders, so two schedulers
    compare bucket for bucket."""
    import numpy as np

    k, slots = len(sess), [x.slot for x in sess]
    outs = []
    with sched._step_lock:
        for j in range(n):
            out = sched._bucket(sched.params, sched.states, np.stack([f[j] for f in frames[:k]]),
                                slots, k)
            outs.append(out[:k].cpu().numpy())
    return np.stack(outs)


def _light_run(torch, np, label, card, sched, sess, frames, make_ded, per_step) -> tuple:
    """A bucket replay against its eager step, then CNET_PARITY frames a
    session with the launches counted (``per_step`` a bucket step), each
    session's outputs held to phase 4's criterion against ``make_ded(row)``.
    -> (launches, each session's outputs)."""
    rows = [session_row(sched.states, x.slot) for x in sess]
    eq = replay_equals_eager(torch, np, label, sched, np.stack([f[0] for f in frames[:len(sess)]]),
                             [x.slot for x in sess])
    _sync(torch, sched.device)
    _reset_launches()
    steps0 = sched.steps_total
    run = drive_sessions(torch, sess, frames, CNET_PARITY)
    counted = _count(label, (0, 0), sched.steps_total - steps0, per_step)
    held = []
    for i, x in enumerate(sess):
        ded = make_ded(rows[i])
        for f in frames[i][:CNET_PARITY]:
            ded(f)
        held.append(f"session {i}: " + hold_to_references(np, f"{label} session {i}",
                                                          run.outs[i], ded))
    say(f"{label}: {card} | {eq} | {CNET_PARITY} frames a session: " + "; ".join(held))
    return counted, run.outs


def phase_controlnet(torch, card: str, model_id: str = SD15_ID) -> tuple:
    """Phase 14: ControlNet on the card — the SD1.5 LCM ring conditioned by a
    ControlNet of control_v11p_sd15_canny's geometry at 512^2 bf16 (random
    base weights from a seed; the ControlNet and HED from synthetic
    checkpoints whose zero convs are non-zero): the weights (14a), the
    canny ring through the captured bucket steps at k = 1 and 2 against the
    plain ring (14b), HED, identity, full CFG, sequential, --fbs 2,
    --multipeer 2 and the w8 + HED refusal (14c), one WHIP session through
    the session layer and its move (14d), attention at the ControlNet
    pass's shapes (14e).  -> the attention and epilogue launches counted."""
    import shutil

    import numpy as np

    from ai_rtc_agent_tpu_torch.models import registry
    from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline

    t_phase = time.perf_counter()
    shutil.rmtree(CNET_HUB, ignore_errors=True)
    total = [0, 0]
    try:
        with _Env(HED_CHECKPOINT=str(HED_PTH)):
            # -- 14a: the synthetic checkpoints and their load ------------------------------
            t = time.perf_counter()
            dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
            tree, hed, nbytes = cnet_snapshot(torch, np, model_id, dev)
            write_s = time.perf_counter() - t
            t = time.perf_counter()
            ref = registry.load_model_bundle(model_id, attn_impl="plain", controlnet=str(CNET_DIR),
                                             annotator="hed")
            _sync(torch, ref.device)
            load_s = time.perf_counter() - t
            n32 = hold_tree(torch, "controlnet 14a f32", ref.params["controlnet"], tree,
                            torch.float32)
            full_hed = registry.family_of(model_id) != "tiny"  # tiny: TINY_STAGES, no file read
            nh = hold_tree(torch, "controlnet 14a hed f32", ref.params["hed"], hed,
                           torch.float32) if full_hed else 0
            t = time.perf_counter()
            pipe = StreamDiffusionPipeline(model_id, controlnet=str(CNET_DIR), seed=2)
            _sync(torch, pipe.device)
            pipe_s = time.perf_counter() - t
            n16 = hold_tree(torch, f"controlnet 14a {pipe.config.dtype}",
                            pipe.bundle.params["controlnet"], tree, pipe.config.torch_dtype)
            zc = tree["mid_zero_conv"]["kernel"]
            say(f"controlnet 14a: {card} | {CNET_DIR.name} ({registry.family_of(model_id)} "
                f"geometry) and ControlNetHED.pth (FULL_STAGES) written from seed {CNET_SEED} in "
                f"{write_s:.1f}s ({nbytes} B; zero convs non-zero, mid_zero_conv std "
                f"{float(zc.std()):.4f}) | load_model_bundle(controlnet=<dir>, annotator='hed') "
                f"f32 in {load_s:.1f}s: {n32} ControlNet leaves and {nh} HED leaves "
                f"(HED_CHECKPOINT) bit for bit | the served pipeline (use_controlnet="
                f"{pipe.config.use_controlnet}, annotator {pipe.config.annotator}; load, one "
                f"{pipe.config.dtype} cast, capture) in {pipe_s:.1f}s: {n16} ControlNet leaves = "
                "the written tree cast once, bit for bit")
            del tree
            hed_params = registry.cast_params({"hed": ref.params["hed"]}, pipe.config.dtype)["hed"]
            for part in (controlnet_ring, controlnet_modes):
                a, e = part(torch, np, card, pipe, ref, hed_params)
                total[0] += a
                total[1] += e
            del pipe, ref, hed_params
            a, e = controlnet_served(torch, np, card, model_id)
            total[0] += a
            total[1] += e
        if torch.cuda.is_available():
            phase_sd15_attention(torch, card, CNET_ATTENTION, CNET_ATTENTION_B, "controlnet 14e",
                                 "ControlNet pass")
    finally:
        shutil.rmtree(CNET_HUB, ignore_errors=True)
    say(f"controlnet: phase 14 took {time.perf_counter() - t_phase:.1f} s; launches counted "
        f"attention {total[0]}, epilogue {total[1]}")
    return tuple(total)


def controlnet_ring(torch, np, card, pipe, ref, hed_params) -> tuple:
    """14b: the ControlNet-canny ring through BatchScheduler.from_pipeline's
    bucket graphs at k = 1 and 2, beside the plain ring over the same
    weights: the residuals move the frames and scale 0 does not, replay =
    eager, the launches a bucket step, phase 4's criterion, the ring's
    rotation, and ABBA turns of busy, idle, ms between bucket steps and fps."""
    from ai_rtc_agent_tpu_torch.models import controlnet as CN
    from ai_rtc_agent_tpu_torch.ops import image as I
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    b, cfg, eng, dev = pipe.bundle, pipe.config, pipe.engine, pipe.device
    per = cnet_per_step(b.unet_cfg, cfg)
    per_plain = attention_per_pass(b.unet_cfg, False)
    t = time.perf_counter()
    sched = BatchScheduler.from_pipeline(pipe, max_sessions=max(CNET_K))
    plain = BatchScheduler(eng.models, eng.params, replace(cfg, use_controlnet=False),
                           eng.encode_prompt, model_id=pipe.model_id, max_sessions=max(CNET_K),
                           schedule=eng.schedule, device=dev)
    key, pkey = sched.bucket_keys()[(1, "full")], plain.bucket_keys()[(1, "full")]
    say(f"controlnet 14b: {pipe.model_id} + ControlNet {cfg.height}x{cfg.width} {cfg.dtype} "
        f"cfg_type={cfg.cfg_type} t_index_list={cfg.t_index_list} annotator={cfg.annotator}, "
        f"buckets {sched._bucket_sizes} captured {sched.graph_status()}, the plain ring's "
        f"{plain.graph_status()}, in {time.perf_counter() - t:.1f}s | the keys' cnet field: "
        f"{key.split('--cnet-')[1].split('--')[0]} vs the plain ring's "
        f"{pkey.split('--cnet-')[1].split('--')[0]}")
    if key == pkey or f"cnet-1{cfg.annotator}" not in key:
        fail("controlnet 14b: the ControlNet bucket key must name it and differ from the plain one")
    n = max(CNET_PARITY, 2 * CNET_AB_FRAMES)
    frames = [_frames(np, n, seed=140 + i, size=cfg.height) for i in range(max(CNET_K))]
    total = [0, 0]
    try:
        for k in CNET_K:
            sess = [sched.claim(f"cnet-{k}-{i}", prompt=SESSION_PROMPTS[i], seed=800 + i)
                    for i in range(k)]
            psess = [plain.claim(f"plain-{k}-{i}", prompt=SESSION_PROMPTS[i], seed=800 + i)
                     for i in range(k)]
            rows = [session_row(sched.states, x.slot) for x in sess]
            # from one state, through bucket k's graph on both sides (a bucket of
            # another size rounds bf16 otherwise): the residuals move the frames,
            # scale 0 is the plain ring
            _install_rows(plain, psess, rows)
            base = bucket_outputs(plain, psess, frames, CNET_PARITY)
            on = bucket_outputs(sched, sess, frames, CNET_PARITY)
            _install_rows(sched, sess, rows, cnet_scale=torch.zeros((), device=dev))
            off = bucket_outputs(sched, sess, frames, CNET_PARITY)
            moved = np.abs(on.astype(np.int16) - base)
            zero = _levels(off, base)
            say(f"controlnet 14b k={k}: {card} | {CNET_PARITY} frames a session from one state: "
                f"the ControlNet ring vs the plain ring mean {moved.mean():.3f} max "
                f"{moved.max()} levels; cnet_scale 0 vs the plain ring max {zero} levels")
            if moved.max() <= 1 or zero > 1:
                fail(f"controlnet 14b k={k}: the residuals must move the frames, and scale 0 "
                     "must stay within 1 level of the plain ring")
            _install_rows(sched, sess, rows)
            counted, _ = _light_run(
                torch, np, f"controlnet 14b k={k}", card, sched, sess, frames,
                lambda row: Dedicated(torch, b.stream_models, b.params, cfg, b.encode_prompt, ref,
                                      row, dev), per)
            for i, x in enumerate(counted):
                total[i] += x
            if k == 1:  # the ring's head is the newest annotation and rotates with the latents
                x = sess[0]
                x(frames[0][0])
                ring0 = sched.states["cnet_cond"][x.slot].clone()
                x(frames[0][1])
                ring1 = sched.states["cnet_cond"][x.slot].clone()
                src = torch.from_numpy(frames[0][0]).to(dev)
                head = CN.canny_soft(I.preprocess_uint8(src, dtype=cfg.torch_dtype))[0]
                err = (ring0[0].float() - head.float()).abs().max().item()
                rot = torch.equal(ring1[1], ring0[0]) and torch.equal(ring1[2], ring0[1])
                say(f"controlnet 14b ring: after a frame the ring's head is that frame's canny map "
                    f"(max |diff| {err:.4f} against canny_soft called alone), after the next it "
                    f"sits one slot on, the rest with it: {'bit for bit' if rot else 'NOT'}")
                if err > 1 / 64 or not rot:
                    fail("controlnet 14b: the conditioning ring does not rotate with the latents")
            if dev.type == "cuda":  # ABBA against the plain ring
                res = {"cnet": [], "plain": []}
                for j, side in enumerate(CNET_TURNS):
                    s_, xs, a_step = (sched, sess, per[0]) if side == "cnet" else (
                        plain, psess, per_plain)
                    part = [f[(j % 2) * CNET_AB_FRAMES:(j % 2 + 1) * CNET_AB_FRAMES]
                            for f in frames]
                    run = drive_sessions(torch, xs, part, CNET_AB_FRAMES)
                    tr = kernel_trace(torch, lambda: drive_sessions(
                        torch, xs, [f[:CNET_TRACE_FRAMES] for f in part], CNET_TRACE_FRAMES))
                    steps = tr["attention"] // a_step
                    if not steps or tr["attention"] != a_step * steps or tr["epilogue"] != steps:
                        fail(f"controlnet 14b k={k} {side}: the trace shows {tr['attention']} "
                             f"attention and {tr['epilogue']} epilogue kernels, not {a_step} + 1 "
                             "a bucket step")
                    rep = variant_busy(torch, s_, k, "full", CNET_TRACE_FRAMES)
                    res[side].append(dict(busy=tr["busy_ms"] / steps, idle=tr["idle"],
                                          attn=tr["attention_ms"] / steps, steps=steps,
                                          kernels=tr["kernels"] / steps,
                                          ms=run.steady_step_ms(SD15_FILL)[0],
                                          fps=sum(run.steady_fps(SD15_FILL)),
                                          rep=rep["busy"], rep_attn=rep["attn"]))
                say(f"controlnet 14b k={k} A/B ({' '.join(CNET_TURNS)}; {CNET_AB_FRAMES} frames a "
                    f"session a turn, steady past each session's {SD15_FILL}th output; a "
                    f"device-only trace of {CNET_TRACE_FRAMES} more, whose steps carry "
                    f"{k * CNET_TRACE_FRAMES} frames; then {CNET_TRACE_FRAMES} replays of bucket "
                    f"{k} over {k} slots): {card} | " + " | ".join(
                        f"{side}: " + " / ".join(
                            f"served: busy {r['busy']:.3f} ms a bucket step (attention "
                            f"{r['attn']:.3f}, {r['kernels']:.0f} kernels, {r['steps']} steps), "
                            f"idle {r['idle']:.3f}, {r['ms']:.2f} ms between bucket steps, "
                            f"{r['fps']:.2f} fps; bucket {k} replay busy {r['rep']:.3f} ms "
                            f"(attention {r['rep_attn']:.3f})" for r in res[side])
                        for side in ("cnet", "plain")))
            for x in sess + psess:
                x.release()
    finally:
        sched.close()
        plain.close()
    return tuple(total)


def controlnet_modes(torch, np, card, pipe, ref, hed_params) -> tuple:
    """14c: HED at FULL_STAGES and identity beside canny on the ring at k=1,
    full CFG and sequential mode with ControlNet at k=1, --fbs 2 at k=2,
    --multipeer 2, and the w8 + HED refusal."""
    from ai_rtc_agent_tpu_torch.models import controlnet as CN
    from ai_rtc_agent_tpu_torch.models import hed as HED
    from ai_rtc_agent_tpu_torch.models import quant as Q
    from ai_rtc_agent_tpu_torch.ops import image as I
    from ai_rtc_agent_tpu_torch.parallel.multipeer import MultiPeerEngine
    from ai_rtc_agent_tpu_torch.stream.engine import StreamEngine
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    b, cfg, eng, dev = pipe.bundle, pipe.config, pipe.engine, pipe.device
    params = dict(eng.params, hed=hed_params)
    total = [0, 0]
    frames = [_frames(np, 2 * CNET_PARITY, seed=150 + i, size=cfg.height) for i in range(2)]

    def scheduler(k=1, **over):
        return BatchScheduler(eng.models, params, replace(cfg, **over), eng.encode_prompt,
                              model_id=pipe.model_id, max_sessions=k, schedule=eng.schedule,
                              device=dev, window_ms=50.0)

    def ded_of(c):
        return lambda row: Dedicated(torch, eng.models, params, c, eng.encode_prompt, ref, row, dev)

    def add(counted):
        for i, v in enumerate(counted):
            total[i] += v

    # -- the annotators on the ring at k=1, from one state
    outs, traces = {}, {}
    for ann in ("canny", "hed", "identity"):
        s_ = scheduler(annotator=ann)
        try:
            x = s_.claim(f"{ann}-0", prompt=SESSION_PROMPTS[0], seed=900)
            counted, out = _light_run(torch, np, f"controlnet 14c {ann} k=1", card, s_, [x],
                                      frames, ded_of(s_.cfg), cnet_per_step(b.unet_cfg, s_.cfg))
            add(counted)
            outs[ann] = out[0]
            if dev.type == "cuda":
                traces[ann] = kernel_trace(torch, lambda: drive_sessions(
                    torch, [x], [frames[0][CNET_PARITY:]], CNET_PARITY))
            x.release()
        finally:
            s_.close()
    diff = {a: max(_levels(p, q) for p, q in zip(outs[a], outs["canny"]))
            for a in ("hed", "identity")}
    line = (f"controlnet 14c annotators: {card} | {CNET_PARITY} frames from one state, max |diff| "
            f"against canny's: hed {diff['hed']}, identity {diff['identity']} levels")
    if dev.type == "cuda":
        img = I.preprocess_uint8(torch.from_numpy(frames[0][0]).to(dev), dtype=cfg.torch_dtype)
        ms = {"canny": time_ms(torch, lambda: CN.canny_soft(img), 50),
              "hed": time_ms(torch, lambda: HED.apply_hed(hed_params, img), 10)}
        line += (f" | the annotator alone on one {cfg.height}^2 frame: canny {ms['canny']:.4f} ms, "
                 f"hed (FULL_STAGES) {ms['hed']:.4f} ms | a bucket step (device trace of "
                 f"{CNET_PARITY}): " + ", ".join(
                     f"{a} {tr['kernels'] / CNET_PARITY:.0f} kernels, busy "
                     f"{tr['busy_ms'] / CNET_PARITY:.3f} ms" for a, tr in traces.items()))
    say(line)
    if diff["hed"] <= 1:
        fail("controlnet 14c: the hed ring's frames must differ from canny's")
    # -- full CFG and sequential mode with ControlNet, k=1
    for mode, over in (("full", dict(cfg_type="full")),
                       ("sequential", dict(use_denoising_batch=False))):
        s_ = scheduler(**over)
        try:
            x = s_.claim(f"{mode}-0", prompt=SESSION_PROMPTS[1], seed=910)
            add(_light_run(torch, np, f"controlnet 14c {mode} k=1", card, s_, [x], frames,
                           ded_of(s_.cfg), cnet_per_step(b.unet_cfg, s_.cfg))[0])
            x.release()
        finally:
            s_.close()
    # -- --fbs 2 through the scheduler, 2 sessions, two frames a session a bucket step
    s_ = scheduler(k=2, frame_buffer_size=2)
    try:
        sess = [s_.claim(f"fbs-{i}", prompt=SESSION_PROMPTS[i], seed=920 + i) for i in range(2)]
        rows = [session_row(s_.states, x.slot) for x in sess]
        _reset_launches()
        steps0 = s_.steps_total
        got = drive_groups(sess, frames, 2 * CNET_PARITY)
        add(_count("controlnet 14c fbs 2", (0, 0), s_.steps_total - steps0,
                   cnet_per_step(b.unet_cfg, s_.cfg)))
        held = []
        for i in range(2):
            ded = ded_of(s_.cfg)(rows[i])
            for j in range(0, 2 * CNET_PARITY, 2):
                ded(np.stack(frames[i][j:j + 2]))
            ded.outs = [o for g in ded.outs for o in g]
            ded.refs = [o for g in ded.refs for o in g]
            held.append(f"session {i}: " + hold_to_references(np, f"14c fbs 2 session {i}",
                                                              got[i], ded))
        say(f"controlnet 14c fbs 2: {card} | 2 sessions x {2 * CNET_PARITY} frames, two a "
            f"session a bucket step, occupancy {s_.snapshot()['batchsched_occupancy_hist']} | "
            + "; ".join(held))
    finally:
        s_.close()
    # -- --multipeer 2: each peer against a dedicated engine fed its slot's ticks
    mp = MultiPeerEngine(eng.models, params, cfg, eng.encode_prompt, max_peers=2, device=dev,
                         model_id=pipe.model_id).start(pipe.prompt)
    mp.prewarm_buckets()
    slots = [mp.connect(SESSION_PROMPTS[i], seed=930 + i) for i in range(2)]
    rows = [session_row(mp.states, s) for s in slots]
    _sync(torch, dev)
    _reset_launches()
    ticks = [mp.step_all(np.stack([frames[0][j], frames[1][j]])) for j in range(CNET_PARITY)]
    _sync(torch, dev)
    want = cnet_per_step(b.unet_cfg, cfg)
    a, e = _launches()
    if (a, e) != (want[0] * CNET_PARITY, want[1] * CNET_PARITY):
        fail(f"controlnet 14c multipeer: {a} attention and {e} epilogue launches over "
             f"{CNET_PARITY} ticks, want {want} a tick")
    add((a, e))
    held = []
    for i, s in enumerate(slots):
        ded = ded_of(cfg)(rows[i])
        for j in range(CNET_PARITY):
            ded(frames[i][j])
        held.append(f"peer {s}: " + hold_to_references(
            np, f"14c multipeer peer {s}", [np.asarray(tk[s]) for tk in ticks], ded))
    say(f"controlnet 14c multipeer 2: {card} | {CNET_PARITY} ticks, {a} attention + {e} epilogue "
        "launches | " + "; ".join(held))
    del mp
    # -- w8 + HED: refused at build
    # (QUANT_MIN_SIZE's default at FULL_STAGES; TINY_STAGES' convs need a smaller one)
    min_size = Q.MIN_SIZE if "block5" in hed_params else 1000
    qhed, n = Q.quantize_params(hed_params, min_size=min_size)
    try:
        StreamEngine(eng.models, dict(params, hed=qhed), replace(cfg, annotator="hed"),
                     eng.encode_prompt, device=dev)
    except ValueError as err:
        say(f"controlnet 14c w8 + hed: {n} of HED's convs int8 at QUANT_MIN_SIZE {min_size}; "
            f"the engine refuses at build: {err}")
    else:
        fail("controlnet 14c: an engine was built for HED with w8 params")
    return tuple(total)


def controlnet_served(torch, np, card, model_id: str = SD15_ID) -> tuple:
    """14d: one WHIP session through the port's session layer configured as
    the agent's ``--controlnet <dir>`` (startup builds the pipeline and the
    scheduler): its served frames equal direct calls of a session of the
    same scheduler from the same row; then its snapshot restored on another
    scheduler and, as the reference, on this one: bit for bit."""
    from ai_rtc_agent_tpu_torch.server import sessions
    from ai_rtc_agent_tpu_torch.server.signaling import LoopbackProvider
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler
    from ai_rtc_agent_tpu_torch.utils import env

    total = [0, 0]

    def direct_and_move(pipe, sched, row, served, pushed, snap) -> str:
        direct = sched.claim("direct", prompt=pipe.prompt, seed=0)
        sched._install(direct.slot, row)
        want = [direct(f) for f in pushed[:CNET_SERVE]]
        direct.release()
        if len(served) != CNET_SERVE or not all(
                np.array_equal(x, y) for x, y in zip(served, want)):
            fail("controlnet 14d: the served frames must equal direct calls bit for bit")
        dest = BatchScheduler.from_pipeline(pipe, max_sessions=1)
        try:
            t = time.perf_counter()
            moved = dest.restore_session(snap, "moved")
            refs = sched.restore_session(snap, "ref")
            restore_ms = (time.perf_counter() - t) * 1e3
            after = [_frames(np, CNET_SERVE, seed=171, size=pipe.config.height)]
            mv = drive_sessions(torch, [moved], after, CNET_SERVE)
            rf = drive_sessions(torch, [refs], after, CNET_SERVE)
            if not all(np.array_equal(x, y) for x, y in zip(mv.outs[0], rf.outs[0])):
                fail("controlnet 14d: the moved session must match the reference restored from "
                     "the same snapshot bit for bit")
            ring = dest.states["cnet_cond"][moved.slot]
            moved.release()
            refs.release()
        finally:
            dest.close()
        return (f"{CNET_SERVE} frames viewed = direct calls from the same row, bit for bit | "
                f"snapshot {len(_state_bytes(snap))} B (the row with its conditioning ring "
                f"{tuple(ring.shape)} {ring.dtype}, {ring.numel() * ring.element_size()} B of "
                f"it), {len(json.dumps(snap))} B as JSON; restored on another scheduler and as "
                f"the reference in {restore_ms:.1f} ms; {CNET_SERVE} frames after the move = "
                "the reference's, bit for bit")

    async def serve():
        state = {}
        sessions.configure(state, model_id=model_id, controlnet=str(CNET_DIR),
                           provider=LoopbackProvider())
        t = time.perf_counter()
        await sessions.startup(state)
        built = time.perf_counter() - t
        try:
            pipe, sched = state["pipeline"], state["batch_scheduler"]
            if not (pipe.config.use_controlnet and sched.cfg.use_controlnet):
                fail("controlnet 14d: the session layer did not build a ControlNet plane")
            depth = env.pipeline_depth()
            pushed = _frames(np, CNET_SERVE + depth - 1, seed=170, size=pipe.config.height)
            pub_id, pub_pc, _view_id, viewer = await open_loopback_session(state)
            row = session_row(sched.states, sched.session(pub_id).slot)
            _sync(torch, sched.device)
            _reset_launches()
            steps0 = sched.steps_total
            views, _ = await exchange(pub_pc, viewer, pushed, 0, CNET_SERVE)
            deadline = time.perf_counter() + 60
            while sched.steps_total - steps0 < len(pushed) and time.perf_counter() < deadline:
                await asyncio.sleep(0.01)
            _sync(torch, sched.device)
            counted = _count("controlnet 14d served", (0, 0), sched.steps_total - steps0,
                             cnet_per_step(pipe.bundle.unet_cfg, pipe.config))
            total[0] += counted[0]
            total[1] += counted[1]
            snap = sched.snapshot_session(pub_id)
            await pub_pc.close()
            await asyncio.sleep(0)
            await asyncio.gather(*state["releasing"])
            line = await asyncio.to_thread(direct_and_move, pipe, sched, row,
                                           [v.to_ndarray() for v in views], pushed, snap)
            say(f"controlnet 14d: {card} | sessions.configure(controlnet=<dir>) + startup in "
                f"{built:.1f}s, one WHIP publisher and a WHEP viewer | {line}")
        finally:
            await sessions.shutdown(state)

    with _Env(BATCHSCHED_MAX_SESSIONS=2, WARMUP_FRAMES=0, DROP_FRAMES=0):
        asyncio.run(serve())
    return tuple(total)


ADAPTER_RANKS = {"r4": 4, "r8": 8, "r16": 16}  # 15: the synthetic styles, name -> rank
ADAPTER_GAIN = 0.2  # up factors N(0, (gain / sqrt(r))^2): each target's output moves ~20%


def adapter_modules(unet_cfg) -> dict:
    """{diffusers module path: its kernel's shape in the port's layout} of
    every transformer block's linears and of each attention's proj_in and
    proj_out (2-D at SD2.1, 1x1 convs at SD1.5), from the key map over a
    shape-only tree."""
    from ai_rtc_agent_tpu_torch.models import loader
    from ai_rtc_agent_tpu_torch.models import unet as U

    tree = U.init_unet(None, unet_cfg, "meta")
    out = {}
    for key, path in loader.unet_key_map(unet_cfg).items():
        if ".attentions." not in key or not key.endswith(".weight") or path[-1] != "kernel":
            continue
        node = tree
        for p in path:
            node = node[p]
        out[key[: -len(".weight")]] = tuple(node.shape)
    return out


def write_style_adapter(np, path, modules: dict, rank: int, seed: int,
                        gain: float = ADAPTER_GAIN) -> int:
    """A synthetic kohya LoRA file of ``rank`` over ``modules``
    (:func:`adapter_modules`; alpha = rank, so its scale is 1): down
    N(0, 1/in), up N(0, (gain/sqrt(r))^2), 1x1 convs in conv layout (the
    registry drops those).  -> the bytes written."""
    from ai_rtc_agent_tpu_torch.models import loader

    rng = np.random.default_rng(seed)
    tensors = {}
    for mod, shape in modules.items():
        conv = len(shape) == 4
        din, dout = (shape[1], shape[0]) if conv else shape
        tail = (1, 1) if conv else ()
        key = "lora_unet_" + mod.replace(".", "_")
        tensors[f"{key}.lora_down.weight"] = (
            rng.standard_normal((rank, din) + tail) / np.sqrt(din)).astype(np.float32)
        tensors[f"{key}.lora_up.weight"] = (
            rng.standard_normal((dout, rank) + tail) * (gain / np.sqrt(rank))).astype(np.float32)
        tensors[f"{key}.alpha"] = np.array(float(rank), np.float32)
    loader.write_safetensors(str(path), tensors)
    return os.path.getsize(path)


ADAPTER_ROOT = Path(__file__).resolve().parent / "build" / "phase15-adapters"
ADAPTER_SEED = 15
ADAPTER_STYLES = {1: ("r16",), 2: ("r8", None), 4: ("r4", None, "r16", "r8")}  # 15a, sd-turbo
RING_STYLES = {1: ("r16",), 2: ("r4", None)}  # 15c, the SD1.5 ring
ADAPTER_PARITY = 3  # 15a/15c: frames a session held to its references
ADAPTER_WINDOW_MS = 10_000.0  # 15: a bucket step waits for every live session (lock-step buckets)
CHURN = (("join", "r8"), ("swap", "r4"), ("global", "r16"), ("join", None), ("swap", None),
         ("global", None), ("swap", "r8"), ("leave", None))  # 15b, each before a step
ADAPTER_AB = ("styled", "plain", "plain", "styled")  # 15e: ABBA, busy ms a bucket step
ADAPTER_AB_REPS = 4  # 15e: replays a turn
RING_CNET_ID = "lllyasviel/control_v11p_sd15_canny"  # 15c: random ControlNet weights


def adapter_files(np, root: Path, unet_cfg) -> tuple:
    """The three synthetic styles of :data:`ADAPTER_RANKS` at ``unet_cfg``'s
    full geometry under ``root`` -> ({name: path}, bytes written)."""
    root.mkdir(parents=True, exist_ok=True)
    modules = adapter_modules(unet_cfg)
    files, nbytes = {}, 0
    for i, (name, rank) in enumerate(ADAPTER_RANKS.items()):
        files[name] = root / f"{name}.safetensors"
        nbytes += write_style_adapter(np, files[name], modules, rank, ADAPTER_SEED + i)
    return files, nbytes


def fused_references(torch, registry, pipe, ref32: dict, files: dict, reg) -> dict:
    """{style: (the served pipeline's params with the style fused offline into
    the UNet, then cast once; an f32 plain bundle with it fused)}, None for
    the base weights.  Only the groups the registry serves are fused (an
    SD1.5 file's conv groups are dropped at runtime, so here too)."""
    from ai_rtc_agent_tpu_torch.models import loader, lora

    km = loader.unet_key_map(pipe.bundle.unet_cfg)
    def kept(path):
        target = lora.resolve_lora_target(path, km)
        return target is not None and ".".join(map(str, target[:-1])) in reg.targets

    out = {None: (pipe.bundle.params, registry.load_model_bundle(
        pipe.model_id, attn_impl="plain", params=ref32))}
    for name, path in files.items():
        groups = {p: g for p, g in lora.parse_lora_state_dict(loader.read_safetensors(path)).items()
                  if kept(p)}
        unet32, applied, _ = lora.fuse_lora_into_unet(ref32["unet"], groups, km)
        if applied != len(reg.targets):
            fail(f"adapters: the offline fuse of {name} applied {applied} of "
                 f"{len(reg.targets)} targets")
        served = dict(pipe.bundle.params, unet=registry.cast_params(
            {"unet": unet32}, pipe.config.dtype)["unet"])
        out[name] = (served, registry.load_model_bundle(
            pipe.model_id, attn_impl="plain", params=dict(ref32, unet=unet32)))
    return out


def styled_dedicated(torch, pipe, refs: dict, style, row) -> "Dedicated":
    """Phase 4's references of one session fed its state row: a dedicated
    engine and an f32 plain engine over weights with ``style`` fused
    offline (the row's factor bank left out)."""
    params, ref = refs[style]
    row = {k: v for k, v in row.items() if k != "adapters"}
    return Dedicated(torch, pipe.bundle.stream_models, params, pipe.config,
                     pipe.bundle.encode_prompt, ref, row, pipe.device)


def lockstep(sessions, frames, n: int, start: int = 0) -> list:
    """``n`` frames a session, every session's frame submitted before any
    fetch (so each bucket step carries them all) -> each session's outputs."""
    outs = [[] for _ in sessions]
    for j in range(start, start + n):
        handles = [s.submit(f[j]) for s, f in zip(sessions, frames)]
        for i, (s, h) in enumerate(zip(sessions, handles)):
            outs[i].append(s.fetch(h))
    return outs


def bank_bytes(sched) -> int:
    return param_bytes(sched.states.get("adapters"))


def build_counts(sched) -> tuple:
    """(graphs built in the scheduler's cache, the device-telemetry plane's
    cache builds and retrace breaches)."""
    from ai_rtc_agent_tpu_torch.obs import devtel

    plane = devtel.active()
    return (len(sched._bucket.graph_cache.steps()), plane.aot_builds, plane.retrace_breaches)


def phase_adapters(torch, card: str, pipe, ref_bundle, ring_id: str = SD15_ID,
                   cnet_id: str = RING_CNET_ID) -> tuple:
    """Phase 15: per-session style adapters (ADAPTER_DIR) through the captured
    bucket steps — three synthetic kohya styles of ranks 4, 8 and 16 over
    every transformer block's linears at full geometry, loaded by the
    agent's own loader into a rank-16 bank: sd-turbo at k = 1, 2 and 4 with a
    style per session and an adapterless one (15a), join/leave/swap churn
    with no capture (15b), the SD1.5 ring at k = 1 and 2 with DeepCache and a
    ControlNet (15c), a styled session's move and the refused cross-restores
    (15d), busy ms a bucket step with and without the bank, ABBA (15e).
    -> the attention and epilogue launches counted."""
    import shutil

    import numpy as np

    from ai_rtc_agent_tpu_torch.models import registry
    from ai_rtc_agent_tpu_torch.obs import devtel
    from ai_rtc_agent_tpu_torch.server import sessions as S

    t_phase = time.perf_counter()
    total = [0, 0]
    shutil.rmtree(ADAPTER_ROOT, ignore_errors=True)
    saved_plane = devtel.active()
    plane = devtel.activate(devtel.DevTelPlane())
    try:
        for part in (adapters_turbo, adapters_ring):
            a, e = part(torch, np, card, pipe, ref_bundle, registry, S, plane, ring_id, cnet_id)
            total[0] += a
            total[1] += e
    finally:
        devtel.deactivate(plane)
        if saved_plane is not None:
            devtel.activate(saved_plane)
        shutil.rmtree(ADAPTER_ROOT, ignore_errors=True)
    say(f"adapters: phase 15 took {time.perf_counter() - t_phase:.1f} s; launches counted "
        f"attention {total[0]}, epilogue {total[1]}")
    return tuple(total)


def _styled_k(torch, np, label, card, styled, plain, styles, refs, pipe, per, seed) -> tuple:
    """One bucket of ``styles`` (a style name or None per session) through
    ``styled``'s graphs and the same sessions through ``plain``'s (no bank):
    replay = eager, the launches, each styled session held to phase 4's
    criterion against its offline-fused references, each adapterless one
    bit for bit the plain scheduler's and held to the base references.
    -> the launches counted."""
    k = len(styles)
    ss = [styled.claim(f"{label}-s{i}", prompt=SESSION_PROMPTS[i % len(SESSION_PROMPTS)],
                       seed=seed + i, adapter=st) for i, st in enumerate(styles)]
    zs = [plain.claim(f"{label}-p{i}", prompt=SESSION_PROMPTS[i % len(SESSION_PROMPTS)],
                      seed=seed + i) for i in range(k)]
    try:
        frames = [_frames(np, ADAPTER_PARITY, seed=seed + 50 + i, size=styled.height)
                  for i in range(k)]
        eq = replay_equals_eager(torch, np, label, styled, np.stack([f[0] for f in frames]),
                                 [s.slot for s in ss])
        rows = [session_row(styled.states, s.slot) for s in ss]
        _sync(torch, styled.device)
        _reset_launches()
        steps0, before = styled.steps_total, _launches()
        got = lockstep(ss, frames, ADAPTER_PARITY)
        counted = _count(label, before, styled.steps_total - steps0, (per, 1))
        base = lockstep(zs, frames, ADAPTER_PARITY)
        held = []
        for i, st in enumerate(styles):
            ded = styled_dedicated(torch, pipe, refs, st, rows[i])
            for f in frames[i]:
                ded(f)
            moved = max(_levels(a, b) for a, b in zip(got[i], base[i]))
            if st is None and not _same_frames(np, got[i], base[i]):
                fail(f"{label} session {i}: the zero slot differs from the rank-0 scheduler "
                     f"(max {moved} levels)")
            if st is not None and moved < 2:
                fail(f"{label} session {i}: style {st} does not move the frames ({moved} levels)")
            held.append(f"{st or 'none'} (slot {ss[i].slot}; vs rank 0 "
                        + ("bit for bit" if st is None else f"max {moved} levels") + "): "
                        + hold_to_references(np, f"{label} session {i} ({st})", got[i], ded))
        say(f"{label}: {card} | {eq} | {ADAPTER_PARITY} frames a session, {per} + 1 launches a "
            f"bucket step | " + "; ".join(held))
    finally:
        for s in ss + zs:
            s.release()
    return counted


def adapters_turbo(torch, np, card, pipe, ref_bundle, registry, S, plane, ring_id,
                   cnet_id) -> tuple:
    """15a, 15b, 15d and 15e's sd-turbo half, on the served sd-turbo pipeline."""
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler, SnapshotMismatch

    total = [0, 0]
    t = time.perf_counter()
    files, nbytes = adapter_files(np, ADAPTER_ROOT / "sd-turbo", pipe.bundle.unet_cfg)
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    with _Env(ADAPTER_DIR=str(ADAPTER_ROOT / "sd-turbo")):
        reg = S.load_adapters(pipe)  # the agent's own boot path
    load_s = time.perf_counter() - t
    linears = sum(len(sh) == 2 for sh in adapter_modules(pipe.bundle.unet_cfg).values())
    if reg.bank_rank != 16 or len(reg.targets) != linears:
        fail(f"adapters 15a: the registry holds rank {reg.bank_rank} over {len(reg.targets)} "
             "targets")
    refs = fused_references(torch, registry, pipe, ref_bundle.params, files, reg)
    mk = lambda bank, n: BatchScheduler.from_pipeline(  # noqa: E731
        pipe, max_sessions=n, window_ms=ADAPTER_WINDOW_MS, adapters=bank)
    t = time.perf_counter()
    styled = mk(reg, max(ADAPTER_STYLES))
    build_s = time.perf_counter() - t
    plain = mk(None, max(ADAPTER_STYLES))
    per = attention_per_pass(pipe.bundle.unet_cfg, False)
    bank = bank_bytes(styled)
    key = styled.bucket_keys()[(1, styled._variants[0])]
    say(f"adapters 15a sd-turbo: {card} | {len(files)} styles (ranks "
        f"{', '.join(str(reg.rank_of(n)) for n in reg.names)}) over {len(reg.targets)} targets "
        f"written in {write_s:.1f}s ({nbytes} B), loaded through ADAPTER_DIR in {load_s:.2f}s; "
        f"the scheduler with a rank-{styled._adapter_rank} bank of {max(ADAPTER_STYLES)} slots "
        f"built and captured in {build_s:.1f}s | bank {bank} B on the device "
        f"({bank // max(ADAPTER_STYLES)} B a slot, {styled.cfg.dtype}) | key "
        f"...{key.split('--v-')[0][-40:]} | fingerprint {styled.snapshot_fingerprint()['adapter_targets']}")
    if "--lrank-16--" not in key or "lrank" in str(plain.bucket_keys()):
        fail("adapters 15a: the keys must carry lrank-16 with the bank and nothing without")
    try:
        for k, styles in ADAPTER_STYLES.items():
            a, e = _styled_k(torch, np, f"adapters 15a sd-turbo k={k}", card, styled, plain,
                             styles, refs, pipe, per, 1500 + 10 * k)
            total[0] += a
            total[1] += e
        a, e = adapters_churn(torch, np, card, pipe, styled, refs, plane, per)
        total[0] += a
        total[1] += e
        adapters_move(torch, np, card, pipe, styled, plain, reg, mk, SnapshotMismatch)
        if styled.device.type == "cuda":
            adapters_busy(torch, card, "sd-turbo", styled, plain, tuple(ADAPTER_STYLES))
    finally:
        styled.close()
        plain.close()
    return tuple(total)


def adapters_churn(torch, np, card, pipe, styled, refs, plane, per) -> tuple:
    """15b: joins, leaves, per-session and global swaps and clears while the
    sessions stream, each operation landing between a step's submit and its
    fetch: no graph is built and no retrace is counted once prewarm is done,
    and the launches stay 32 + 1 a step; the first frames after each
    operation carry the new style, held afterwards to the same references
    as 15a; each swap's ms."""
    plane.serving()  # from here on a serve-time build would be a breach
    before = build_counts(styled)
    _reset_launches()
    steps0 = styled.steps_total
    live = [styled.claim("churn-lead", prompt=SESSION_PROMPTS[0], seed=1600, adapter="r16")]
    frames = _frames(np, 3 * len(CHURN), seed=1601, size=styled.height)
    swap_ms, after_op, n = [], [], 0
    try:
        for op, style in CHURN:
            handles = [s.submit(frames[n]) for s in live]  # a step in flight
            t = time.perf_counter()
            if op == "join":
                live.append(styled.claim(f"churn-{len(live)}", prompt=SESSION_PROMPTS[1],
                                         seed=1610 + len(live), adapter=style))
                want = style if style is not None else styled.default_adapter
            elif op == "leave":
                live.pop().release()
            elif op == "swap":
                live[-1].update_adapter(style)
                want = style
            else:
                styled.update_adapter(style)
                want = style
            op_ms = (time.perf_counter() - t) * 1e3
            if op in ("swap", "global"):
                swap_ms.append(op_ms)
            for s, h in zip(live[: len(handles)], handles):
                s.fetch(h)
            n += 1
            if op == "leave":
                continue
            target = live[-1]
            if target.adapter != want or (op == "global" and any(s.adapter != want for s in live)):
                fail(f"adapters 15b: {op} {style} left {[s.adapter for s in live]}, want {want!r}")
            # the first frames after the operation, every live session in lock-step
            row = session_row(styled.states, target.slot)
            outs = lockstep(live, [frames[n:n + 2]] * len(live), 2)
            after_op.append((f"{op} {style or 'none'}", want, row, frames[n:n + 2],
                             outs[live.index(target)]))
            n += 2
        idle_ms = []  # swaps with no step in flight, each to its end on the device
        for style in ("r4", "r16", None, "r8") * 2:
            t = time.perf_counter()
            live[0].update_adapter(style)
            _sync(torch, styled.device)
            idle_ms.append((time.perf_counter() - t) * 1e3)
        after = build_counts(styled)
        steps = styled.steps_total - steps0
        a, e = _count("adapters 15b", (0, 0), steps, (per, 1))
        held = []
        for label, want, row, fs, outs in after_op:
            ded = styled_dedicated(torch, pipe, refs, want, row)
            for f in fs:
                ded(f)
            held.append(f"{label}: " + hold_to_references(
                np, f"adapters 15b after {label}", outs, ded).split(",")[0])
        say(f"adapters 15b sd-turbo churn: {card} | {' '.join(f'{o}:{s}' for o, s in CHURN)} over "
            f"{steps} bucket steps | graphs, cache builds, retrace breaches before {before} after "
            f"{after} | swaps {styled.adapter_swaps_total}, swap ms "
            + " / ".join(f"{m:.2f}" for m in swap_ms) + f" (median {_median(swap_ms):.2f}; "
            f"each waits for the step in flight), with no step in flight "
            + " / ".join(f"{m:.2f}" for m in idle_ms) + f" (median {_median(idle_ms):.2f}) | "
            f"first 2 frames after each, vs f32: " + "; ".join(held))
        if after != before:
            fail(f"adapters 15b: the churn built graphs or counted retraces ({before} -> {after})")
        metrics = styled.snapshot()
        if metrics["adapter_swaps_total"] != styled.adapter_swaps_total or \
                metrics["adapter_rank"] != 16:
            fail(f"adapters 15b: /metrics adapter fields {metrics}")
    finally:
        for s in live:
            s.release()
        plane.warmup()
    return a, e


def adapters_move(torch, np, card, pipe, styled, plain, reg, mk, SnapshotMismatch):
    """15d: a styled session's snapshot restored on a second scheduler with
    the same bank and as the reference on the first: bit for bit; the
    cross-restores between a bank and no bank are refused by the
    fingerprint, both ways."""
    frames = _frames(np, 8, seed=1700, size=styled.height)
    src = styled.claim("move-src", prompt=SESSION_PROMPTS[2], seed=1700, adapter="r8")
    lockstep([src], [frames], 2)
    t = time.perf_counter()
    snap = styled.snapshot_session("move-src")
    export_ms = (time.perf_counter() - t) * 1e3
    src.release()
    dest = mk(reg, 1)
    try:
        t = time.perf_counter()
        moved = dest.restore_session(snap, "move-dst")
        import_ms = (time.perf_counter() - t) * 1e3
        ref = styled.restore_session(snap, "move-ref")
        if moved.adapter != "r8" or ref.adapter != "r8":
            fail(f"adapters 15d: the restored sessions carry {moved.adapter!r} / {ref.adapter!r}")
        got = lockstep([moved], [frames], 4, start=2)[0]
        want = lockstep([ref], [frames], 4, start=2)[0]
        same = _same_frames(np, got, want)
        ref.release()
        plain_src = plain.claim("move-plain", seed=1701)
        plain_snap = plain.snapshot_session("move-plain")
        plain_src.release()
        refused = []
        for name, target, s in (("bank -> no bank", plain, snap),
                                ("no bank -> bank", styled, plain_snap)):
            try:
                target.restore_session(s, "move-refused")
            except SnapshotMismatch as e:
                if "adapter_rank" not in str(e) or "adapter_targets" not in str(e):
                    fail(f"adapters 15d: {name} refused without naming the adapter keys: {e}")
                refused.append(name)
            else:
                fail(f"adapters 15d: {name} restored")
        say(f"adapters 15d move: {card} | snapshot {len(_state_bytes(snap))} B (adapter "
            f"{snap['adapter']!r}, the row's bank {param_bytes(_row_of(snap)['adapters'])} B), "
            f"export {export_ms:.1f} ms, import {import_ms:.1f} ms | 4 frames vs the reference "
            f"restored from the same snapshot: {'bit for bit' if same else 'DIFFER'} | refused by "
            f"the fingerprint: {', '.join(refused)}")
        if not same:
            fail("adapters 15d: the moved styled session differs from its reference")
    finally:
        dest.close()


def adapters_busy(torch, card, what, styled, plain, ks):
    """15e: busy ms a bucket step and kernels a step, with the rank-16 bank and
    without, ABBA over the same buckets (``variant_busy``) in one call."""
    rows = []
    for k in ks:
        got = {"styled": [], "plain": []}
        for side in ADAPTER_AB:
            sched = styled if side == "styled" else plain
            got[side].append(variant_busy(torch, sched, k, sched._variants[0], ADAPTER_AB_REPS))
        med = {side: _median([b["busy"] for b in v]) for side, v in got.items()}
        kern = {side: got[side][0]["kernels"] for side in got}
        rows.append(f"k={k}: styled " + " / ".join(f"{b['busy']:.3f}" for b in got["styled"])
                    + ", plain " + " / ".join(f"{b['busy']:.3f}" for b in got["plain"])
                    + f" ms (+{med['styled'] - med['plain']:.3f} ms, "
                    f"x{med['styled'] / med['plain']:.3f}); kernels a step {kern['styled']:.0f} vs "
                    f"{kern['plain']:.0f} (+{kern['styled'] - kern['plain']:.0f} for the factor "
                    f"path); idle share " + " / ".join(f"{b['idle']:.3f}" for b in got["styled"])
                    + " vs " + " / ".join(f"{b['idle']:.3f}" for b in got["plain"]))
    say(f"adapters 15e {what} A/B ({' '.join(ADAPTER_AB)}, {ADAPTER_AB_REPS} replays a turn, "
        f"device busy ms a bucket step): {card} | bank {bank_bytes(styled)} B | "
        + " | ".join(rows))


def adapters_ring(torch, np, card, pipe, ref_bundle, registry, S, plane, ring_id,
                  cnet_id) -> tuple:
    """15c and 15e's ring half: the SD1.5 ring's bucket graphs at k = 1 and 2
    with its own rank-16 bank, DeepCache N=3 (a swap forces a capture) and
    one ControlNet bucket step."""
    from dataclasses import replace

    from ai_rtc_agent_tpu_torch.stream.engine import install_state
    from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler
    from ai_rtc_agent_tpu_torch.tree import tree_map

    total = [0, 0]
    t = time.perf_counter()
    ring = StreamDiffusionPipeline(ring_id, seed=2)
    ref32 = registry.cast_params(
        registry.load_model_bundle(ring_id, attn_impl="plain", seed=0).params, "float32")
    files, nbytes = adapter_files(np, ADAPTER_ROOT / "sd15", ring.bundle.unet_cfg)
    with _Env(ADAPTER_DIR=str(ADAPTER_ROOT / "sd15")):
        reg = S.load_adapters(ring)
    modules = adapter_modules(ring.bundle.unet_cfg)
    convs = sum(len(s) == 4 for s in modules.values())
    refs = fused_references(torch, registry, ring, ref32, {n: files[n] for n in ("r4", "r16")},
                            reg)
    del ref32
    mk = lambda bank, cfg=ring.config, models=ring.bundle.stream_models, \
        params=ring.bundle.params, n=max(RING_STYLES): BatchScheduler(  # noqa: E731
            models, params, cfg, ring.bundle.encode_prompt, model_id=ring.model_id,
            max_sessions=n, window_ms=ADAPTER_WINDOW_MS, schedule=ring.engine.schedule,
            device=ring.device, adapters=bank)
    styled, plain = mk(reg), mk(None)
    per = attention_per_pass(ring.bundle.unet_cfg, False)
    say(f"adapters 15c sd15: {card} | built in {time.perf_counter() - t:.1f}s | {len(reg.targets)} "
        f"targets of {len(modules)} written ({convs} 1x1-conv proj_in/proj_out groups dropped "
        f"at load), {nbytes} B | bank {bank_bytes(styled)} B on the device")
    try:
        for k, styles in RING_STYLES.items():
            a, e = _styled_k(torch, np, f"adapters 15c sd15 k={k}", card, styled, plain, styles,
                             refs, ring, per, 1800 + 10 * k)
            total[0] += a
            total[1] += e
        # DeepCache N=3: a swap makes the slot uncaptured; its next step captures
        dc = mk(reg, replace(ring.config, unet_cache_interval=DC_INTERVAL), n=1)
        try:
            sess = dc.claim("dc", prompt=SESSION_PROMPTS[0], seed=1850, adapter="r16")
            frames = _frames(np, 8, seed=1851, size=dc.height)
            seen = []
            real = dc._next_variant_locked
            dc._next_variant_locked = lambda slots: seen.append(real(slots)) or seen[-1]
            lockstep([sess], [frames], 4)
            eqs = [replay_equals_eager(torch, np, f"adapters 15c sd15 deepcache {v}", dc,
                                       frames[4][None], [sess.slot], v)
                   for v in dc._variants]
            sess.update_adapter("r4")
            uncaptured, tick = sess.slot in dc._uncaptured, dc._tick
            lockstep([sess], [frames], 3, start=4)
            dc._next_variant_locked = real
            say(f"adapters 15c sd15 deepcache N={DC_INTERVAL}: {card} | "
                + "; ".join(f"{v} {e_}" for v, e_ in zip(dc._variants, eqs))
                + f" | steps {seen[:4]} then swap r16 -> r4 (slot uncaptured {uncaptured}, tick "
                f"{tick}) then {seen[4:]}")
            if seen[0] != "capture" or "cached" not in seen[:4] or not uncaptured or tick != 0 \
                    or seen[4] != "capture":
                fail("adapters 15c deepcache: a swap must make the slot uncaptured and its next "
                     "step a capture")
            sess.release()
        finally:
            dc.close()
        # one ControlNet bucket step, styled: 46 + 1 launches
        cb = registry.load_model_bundle(ring_id, params=ring.bundle.params, controlnet=cnet_id,
                                        latent_scale=ring.config.latent_scale)
        cparams = dict(ring.bundle.params, controlnet=registry.cast_params(
            {"controlnet": cb.params["controlnet"]}, ring.config.dtype)["controlnet"])
        cn = mk(reg, replace(ring.config, use_controlnet=True), cb.stream_models, cparams, 2)
        try:
            ss = [cn.claim(f"cn-{i}", prompt=SESSION_PROMPTS[i], seed=1860 + i, adapter=st)
                  for i, st in enumerate(("r16", None))]
            frames = [_frames(np, 2, seed=1870 + i, size=cn.height) for i in range(2)]
            eq = replay_equals_eager(torch, np, "adapters 15c sd15 controlnet", cn,
                                     np.stack([f[0] for f in frames]), [s.slot for s in ss])
            cper = cnet_per_step(ring.bundle.unet_cfg, cn.cfg)
            with cn._step_lock:
                saved = tree_map(lambda a: a.clone(), cn.states)
            _sync(torch, cn.device)
            _reset_launches()
            steps0, before = cn.steps_total, _launches()
            styled_out = lockstep(ss, frames, 1)
            a, e = _count("adapters 15c sd15 controlnet", before, cn.steps_total - steps0, cper)
            total[0] += a
            total[1] += e
            # the same step again from the same states, session 0's style cleared
            with cn._step_lock:
                install_state(cn.states, saved)
            ss[0].update_adapter(None)
            plain_out = lockstep(ss, frames, 1)
            moved = _levels(styled_out[0][0], plain_out[0][0])
            same = _same_frames(np, styled_out[1], plain_out[1])
            say(f"adapters 15c sd15 controlnet: {card} | {eq} | one bucket step of 2 (r16, none): "
                f"{cper[0]} + {cper[1]} launches | the same step with r16 cleared: the styled "
                f"session moves max {moved} levels, the adapterless one "
                f"{'bit for bit' if same else 'DIFFERS'}")
            if moved < 1 or not same or not all(np.isfinite(o[0]).all() for o in styled_out):
                fail("adapters 15c controlnet: the style must move its session's frame and only "
                     "its own")
            for s in ss:
                s.release()
        finally:
            cn.close()
        if styled.device.type == "cuda":
            adapters_busy(torch, card, "sd15 ring", styled, plain, tuple(RING_STYLES))
    finally:
        styled.close()
        plain.close()
    return tuple(total)


SDXL_ID = "stabilityai/sdxl-turbo"
SDXL_K = (1, 2)  # 16c
SDXL_DIRECT = 6  # 16a: frames timed through __call__
SDXL_SERVE = 4  # 16b: frames viewed
SDXL_FRAMES = 12  # 16c: frames a session in the timed run
SDXL_FILL = 3  # of them, each session's first outputs
SDXL_PARITY = 3  # of them, held to phase 4's criterion
SDXL_TRACE_FRAMES = 4  # 16c: the device trace's frames a session
SDXL_SWAP_STEPS = 6  # 16c: bucket steps of the swap run at k=2
SDXL_SWAP_AT = 3  # the swap lands before this step
SDXL_SWAP_PROMPT = "a charcoal sketch of a harbor at night"
SDXL_LAUNCHES = (140, 1)  # attention and epilogue launches a step (the config's, checked)
# One SDXL UNet pass's attention at 1024^2 (a 128^2 latent), D=64: the
# 640-wide tier at 64^2 tokens (H=10) has 10 transformer blocks, the
# 1280-wide tier and the mid block at 32^2 (H=20) 60, each a self and a
# cross launch (77 keys of the 2048-wide context): (Lq, Lk, D, launches, H)
SDXL_ATTENTION = [(4096, 4096, 64, 10, 10), (4096, 77, 64, 10, 10),
                  (1024, 1024, 64, 60, 20), (1024, 77, 64, 60, 20)]
SDXL_ATTENTION_B = (1, 2)


def phase_sdxl(torch, card: str, model_id: str = SDXL_ID) -> tuple:
    """Phase 16: SDXL-Turbo on the card at its full geometry, 1024^2 bf16,
    from seeded random weights, served by the port's session layer booted as
    the agent's ``--model-id stabilityai/sdxl-turbo`` (startup builds the
    pipeline and a 2-slot batch scheduler; ``model_id="tiny-xl-test"``
    rehearses it on the CPU).  16a one session direct through
    the pipeline's graph: replay = eager, phase 4's criterion against an f32
    copy of the weights, the launches; 16b one WHIP session served over
    loopback, its frames = direct calls, and its move; 16c k = 1 and 2
    through the bucket graphs against dedicated engines, the steady window,
    a device-only trace, and a mid-stream prompt swap on one slot; 16e the
    kernels at SDXL's shapes.  -> the attention and epilogue launches."""
    import numpy as np

    from ai_rtc_agent_tpu_torch.models import registry
    from ai_rtc_agent_tpu_torch.server import sessions
    from ai_rtc_agent_tpu_torch.server.signaling import LoopbackProvider

    t_phase = time.perf_counter()
    total = [0, 0]

    def add(counted):
        total[0] += counted[0]
        total[1] += counted[1]

    async def run():
        state = {}
        sessions.configure(state, model_id=model_id, provider=LoopbackProvider())
        t = time.perf_counter()
        await sessions.startup(state)
        built = time.perf_counter() - t
        try:
            pipe, sched = state["pipeline"], state["batch_scheduler"]
            b, cfg = pipe.bundle, pipe.config
            per_step = (attention_per_pass(b.unet_cfg, False), 1)
            if not (cfg.use_added_cond and sched is not None) or (
                    model_id == SDXL_ID and per_step != SDXL_LAUNCHES):
                fail(f"sdxl 16: the session layer did not build an SDXL plane ({per_step} "
                     "launches a step)")
            sizes = {name: sum(a.numel() for a in _tensors(b.params[name]))
                     for name in ("unet", "clip", "clip2", "taesd")}
            say(f"sdxl 16: {card} | sessions.configure(model_id={model_id!r}) + startup in "
                f"{built:.1f}s (random weights from seed 0, the pipeline's step and the "
                f"scheduler's buckets {sched.graph_status()} captured) | {cfg.height}x{cfg.width} "
                f"{cfg.dtype} scheduler={cfg.scheduler} cfg_type={cfg.cfg_type} t_index_list="
                f"{cfg.t_index_list} use_added_cond={cfg.use_added_cond} | params: "
                + ", ".join(f"{k} {v / 1e9:.3f} B" for k, v in sizes.items())
                + f" | key {pipe.engine.key}")
            t = time.perf_counter()
            ref = registry.load_model_bundle(model_id, attn_impl="plain", seed=0,
                                             device=pipe.device)
            ref.params = registry.cast_params(ref.params, "float32")
            _sync(torch, ref.device)
            say(f"sdxl 16: the f32 reference bundle (the same seed, uncast) in "
                f"{time.perf_counter() - t:.1f}s")
            add(await asyncio.to_thread(sdxl_direct, torch, np, card, pipe, ref, per_step))
            add(await sdxl_served(torch, np, card, state, per_step))
            add(await asyncio.to_thread(sdxl_sessions, torch, np, card, pipe, sched, ref,
                                        per_step))
        finally:
            await sessions.shutdown(state)

    with _Env(BATCHSCHED_MAX_SESSIONS=max(SDXL_K), WARMUP_FRAMES=0, DROP_FRAMES=0):
        asyncio.run(run())
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        sdxl_kernels(torch, card)
    say(f"sdxl: phase 16 took {time.perf_counter() - t_phase:.1f} s; launches counted attention "
        f"{total[0]}, epilogue {total[1]}")
    return tuple(total)


def sdxl_direct(torch, np, card: str, pipe, ref, per_step: tuple) -> tuple:
    """16a: the pipeline's captured step against its eager step; SDXL_DIRECT
    frames through ``__call__`` with the launches counted; one eager UNet
    pass's attention launches; one step from the same state against the
    plain bf16 and the f32 engines (phase 4)."""
    from ai_rtc_agent_tpu_torch.models import registry
    from ai_rtc_agent_tpu_torch.stream.engine import StreamEngine, added_cond

    eng, cfg = pipe.engine, pipe.config
    step = eng.graph_cache.steps()[eng.key]
    if pipe.device.type == "cuda" and (not step.captured or step.launches != per_step):
        fail(f"sdxl 16a: the captured step records {step.launches} (attention, epilogue) "
             f"launches a replay, want {per_step}")
    frames = _frames(np, SDXL_DIRECT + 2, seed=160, size=cfg.height)
    eq = engine_replay_equals_eager(torch, "sdxl 16a", eng, frames[0])
    for f in frames[:2]:
        pipe(f)
    _sync(torch, pipe.device)
    _reset_launches()
    t = time.perf_counter()
    outs = [pipe(f) for f in frames[2:]]
    call_ms = (time.perf_counter() - t) * 1e3 / SDXL_DIRECT
    counted = _count("sdxl 16a __call__", (0, 0), SDXL_DIRECT, per_step)
    if any(o.shape != (cfg.height, cfg.width, 3) or o.dtype != np.uint8 for o in outs):
        fail("sdxl 16a: bad output frame")
    st = eng.state
    x = torch.randn((1, *cfg.latent_hw, cfg.latent_channels), device=pipe.device).to(
        cfg.torch_dtype)
    before = _launches()[0]
    with torch.inference_mode():
        out = eng.models.unet(eng.params, x, st["coeffs"]["timesteps"][:1], st["cond"],
                              added=added_cond(cfg, st["added_time_ids"], st["added_text"], 1))
    _sync(torch, pipe.device)
    per_pass = _launches()[0] - before
    want = attention_per_pass(pipe.bundle.unet_cfg, False)
    if per_pass != per_step[0] or want != per_pass or not torch.isfinite(out).all():
        fail(f"sdxl 16a: one eager UNet pass launched {per_pass} attention kernels (the config "
             f"gives {want}, want {per_step[0]}), finite {bool(torch.isfinite(out).all())}")
    served_w = pipe.bundle.params["unet"]["conv_in"]["kernel"]
    if not torch.equal(ref.params["unet"]["conv_in"]["kernel"].to(served_w.dtype), served_w):
        fail("sdxl 16a: the f32 reference weights do not match the served weights")
    plain_cfg = replace(cfg, attn_impl="plain", use_fused_epilogue=False)
    plain = registry.load_model_bundle(pipe.model_id, attn_impl="plain", device=pipe.device,
                                       params=pipe.bundle.params)
    engines = {
        "kernel": eng,
        "plain": StreamEngine(plain.stream_models, plain.params, plain_cfg, plain.encode_prompt,
                              device=pipe.device, graphs=False),
        "f32": StreamEngine(ref.stream_models, ref.params, replace(plain_cfg, dtype="float32"),
                            ref.encode_prompt, device=pipe.device, graphs=False),
    }
    say(f"sdxl 16a: {card} | {eq} | __call__ {call_ms:.2f} ms/frame ({1e3 / call_ms:.2f} fps) "
        f"over {SDXL_DIRECT} frames | one eager UNet pass: {per_pass} attention launches, out "
        f"{tuple(out.shape)} finite | pooled embeds {tuple(eng.state['added_text'].shape)} "
        f"{eng.state['added_text'].dtype}, time ids {eng.state['added_time_ids'].tolist()}")
    step_vs_f32(torch, "sdxl 16a", engines, session_row(eng.state, None),
                torch.from_numpy(frames[1]).to(pipe.device))
    return counted


async def sdxl_served(torch, np, card: str, state, per_step: tuple) -> tuple:
    """16b: one WHIP publisher and a WHEP viewer through the session layer:
    SDXL_SERVE frames viewed with the launches counted, equal to direct
    calls of a session of the same scheduler from the same row; then the
    session's snapshot restored on another scheduler over the same pipeline
    and, as the reference, on this one: SDXL_SERVE frames each, bit for
    bit."""
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler
    from ai_rtc_agent_tpu_torch.utils import env

    pipe, sched = state["pipeline"], state["batch_scheduler"]
    size = pipe.config.height
    pushed = _frames(np, SDXL_SERVE + env.pipeline_depth() - 1, seed=170, size=size)
    pub_id, pub_pc, _view_id, viewer = await open_loopback_session(state)
    row = session_row(sched.states, sched.session(pub_id).slot)
    _sync(torch, sched.device)
    _reset_launches()
    steps0 = sched.steps_total
    views, _ = await exchange(pub_pc, viewer, pushed, 0, SDXL_SERVE)
    deadline = time.perf_counter() + 60
    while sched.steps_total - steps0 < len(pushed) and time.perf_counter() < deadline:
        await asyncio.sleep(0.01)
    _sync(torch, sched.device)
    counted = _count("sdxl 16b served", (0, 0), sched.steps_total - steps0, per_step)
    snap = sched.snapshot_session(pub_id)
    await pub_pc.close()
    await asyncio.sleep(0)
    await asyncio.gather(*state["releasing"])
    served = [v.to_ndarray() for v in views]

    def direct_and_move() -> str:
        direct = sched.claim("direct", prompt=pipe.prompt, seed=0)
        sched._install(direct.slot, row)
        want = [direct(f) for f in pushed[:SDXL_SERVE]]
        direct.release()
        if len(served) != SDXL_SERVE or not all(np.array_equal(x, y)
                                                for x, y in zip(served, want)):
            fail("sdxl 16b: the served frames must equal direct calls bit for bit")
        t = time.perf_counter()
        dest = BatchScheduler.from_pipeline(pipe, max_sessions=1)
        dest_s = time.perf_counter() - t
        try:
            t = time.perf_counter()
            moved = dest.restore_session(snap, "moved")
            refs = sched.restore_session(snap, "ref")
            restore_ms = (time.perf_counter() - t) * 1e3
            after = [_frames(np, SDXL_SERVE, seed=171, size=size)]
            mv = drive_sessions(torch, [moved], after, SDXL_SERVE)
            rf = drive_sessions(torch, [refs], after, SDXL_SERVE)
            if not all(np.array_equal(x, y) for x, y in zip(mv.outs[0], rf.outs[0])):
                fail("sdxl 16b: the moved session must match the reference restored from the "
                     "same snapshot bit for bit")
            pooled = dest.states["added_text"][moved.slot]
            moved.release()
            refs.release()
        finally:
            dest.close()
        return (f"{SDXL_SERVE} frames viewed = direct calls from the same row, bit for bit | "
                f"snapshot {len(_state_bytes(snap))} B (the row with its pooled embeds "
                f"{tuple(pooled.shape)} {pooled.dtype} and time ids), {len(json.dumps(snap))} B "
                f"as JSON; another scheduler's bucket captured in {dest_s:.1f}s; restored there "
                f"and as the reference in {restore_ms:.1f} ms; {SDXL_SERVE} frames after the "
                "move = the reference's, bit for bit")

    line = await asyncio.to_thread(direct_and_move)
    say(f"sdxl 16b: {card} | one WHIP publisher and a WHEP viewer | {line}")
    return counted


def sdxl_sessions(torch, np, card: str, pipe, sched, ref, per_step: tuple) -> tuple:
    """16c: k = 1 and 2 sessions through the scheduler's bucket graphs
    (:func:`sd15_run` at SDXL's counts: replay = eager, the launches, phase
    4's criterion against dedicated engines, the steady window, the device
    trace), then at k = 2 the prompt swap of one slot (:func:`sdxl_swap`)."""
    b, cfg, dev = pipe.bundle, pipe.config, pipe.device
    frames = [_frames(np, SDXL_FRAMES, seed=180 + i, size=cfg.height) for i in range(max(SDXL_K))]
    total = [0, 0]
    for k in SDXL_K:
        sess = [sched.claim(f"sdxl-{k}-{i}", prompt=SESSION_PROMPTS[i], seed=500 + i)
                for i in range(k)]
        counted = sd15_run(
            torch, np, f"sdxl 16c k={k}", card, sched, sess, frames,
            lambda row: Dedicated(torch, b.stream_models, b.params, cfg, b.encode_prompt, ref,
                                  row, dev),
            per_step, f"{k} session(s), {k * cfg.batch_size} UNet rows a bucket step",
            n=SDXL_FRAMES, fill=SDXL_FILL, parity=SDXL_PARITY, trace_frames=SDXL_TRACE_FRAMES)
        total[0] += counted[0]
        total[1] += counted[1]
        if k == 2:
            sdxl_swap(torch, np, card, sched, sess, frames)
        for s in sess:
            s.release()
    return tuple(total)


def sdxl_swap(torch, np, card: str, sched, sess, frames):
    """16c: a prompt swap on slot 0 of a k=2 bucket mid-stream (the
    session's runtime config, as a datachannel message or /config carries
    it): the swapped slot's pooled embeds change and the other's do not;
    the first replay after the swap equals an eager bucket step under the
    new prompt (a rebinding in place of a ``copy_`` would leave the graph
    reading the old pooled embeds); the other slot's frames are bit for bit
    those of the same steps without the swap, the swapped slot's change."""
    from ai_rtc_agent_tpu_torch.server.sessions import apply_runtime_config

    rows = [session_row(sched.states, s.slot) for s in sess]
    slots = [s.slot for s in sess]
    n, m = SDXL_SWAP_STEPS, SDXL_SWAP_AT
    _install_rows(sched, sess, rows)
    plain = bucket_outputs(sched, sess, frames, n)
    _install_rows(sched, sess, rows)
    first = bucket_outputs(sched, sess, frames, m)
    before = sched.states["added_text"].clone()
    apply_runtime_config(sess[0], {"prompt": SDXL_SWAP_PROMPT})
    after = sched.states["added_text"].clone()
    if torch.equal(before[slots[0]], after[slots[0]]) or not torch.equal(before[slots[1]],
                                                                         after[slots[1]]):
        fail("sdxl 16c swap: the swapped slot's pooled embeds must change and the other's stay")
    eq = replay_equals_eager(torch, np, "sdxl 16c first replay after the swap", sched,
                             np.stack([f[m] for f in frames[:2]]), slots)
    rest = bucket_outputs(sched, sess, [f[m:] for f in frames], n - m)
    swapped = np.concatenate([first, rest])
    if not np.array_equal(swapped[:, 1], plain[:, 1]):
        fail("sdxl 16c swap: the other slot's frames changed")
    if not np.array_equal(swapped[:m, 0], plain[:m, 0]) or any(
            np.array_equal(swapped[j, 0], plain[j, 0]) for j in range(m, n)):
        fail("sdxl 16c swap: the swapped slot's frames must change from the swap on, and only "
             "then")
    d = np.abs(swapped[m:, 0].astype(np.int16) - plain[m:, 0]).mean()
    say(f"sdxl 16c swap: {card} | slot {slots[0]}'s prompt swapped before bucket step {m + 1} "
        f"of {n}: its pooled embeds changed (mean |diff| "
        f"{(after[slots[0]] - before[slots[0]]).float().abs().mean().item():.4f}), slot "
        f"{slots[1]}'s kept; first replay after the swap: {eq}; slot {slots[1]}'s {n} frames = "
        f"the run without the swap, bit for bit; slot {slots[0]}'s frames {m + 1}-{n} moved by "
        f"{d:.2f} levels on average")


def sdxl_kernels(torch, card: str):
    """16e: the attention kernel at one SDXL UNet pass's shapes at B = 1 and
    2 (against its plain version, beside SDPA and the bound:
    :func:`phase_sd15_attention`) and the epilogue at SDXL's step on
    [k,128,128,4] at k = 1 and 2 against its plain version."""
    from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF

    phase_sd15_attention(torch, card, SDXL_ATTENTION, SDXL_ATTENTION_B, "sdxl 16e",
                         "SDXL UNet pass")
    gen = torch.Generator(device="cuda").manual_seed(16)
    for k in SDXL_ATTENTION_B:
        args, kwargs = session_epilogue_call(torch, "none", k, list(range(k)), gen, latent=128)
        R, n = args[0].shape[0], args[0].numel() // args[0].shape[0]
        label = f"sdxl 16e epilogue cfg=none turbo, {k} session(s) [{R},128,128,4] bf16"
        a, kw = fresh_epilogue_call(args, kwargs)
        got = KF.fused_stream_epilogue(*a, **kw)
        err, rel = _epilogue_errors(label, got, plain_epilogue_call(KF, args, kwargs), R)
        ms = time_ms(torch, lambda: KF.fused_stream_epilogue(*args, **kwargs), 500)
        floor = time_ms(torch, lambda: KF.launch_empty(R, n), 500)
        plain = time_ms(torch, lambda: KF.epilogue_plain(*args, **kwargs), 50)
        flops, nbytes = epilogue_work(args, kwargs)
        bms, by = bound(flops, PEAK_F32_FLOPS, nbytes)
        say(f"{label}: {card} | max_abs_err {err:.3e}, max rel {rel:.2e} | kernel {ms:.5f} ms, "
            f"launch floor {floor:.5f} ms, plain {plain:.4f} ms, bound {bms:.6f} ms ({by}; "
            f"{nbytes} B, {flops} flop)")


TRAIN_STEPS = 5  # 17a: steps on one batch at full width
TRAIN_LR = 1e-4  # 17a's learning rate (TrainerConfig's default is 1e-5)
TRAIN_TINY_LR = 1e-3  # 17c/17d, as the CPU parity tests
TRAIN_PARAM_ATOL = 5e-5  # 17c: 5% of lr, the largest move of one Adam step


def phase_train(torch, card: str, unet_cfg=None, device="cuda"):
    """Phase 17: the training path at world size 1 (17a-17d, see the module
    docstring).  ``unet_cfg`` and ``device="cpu"`` rehearse it on the CPU
    (a gloo world; 17c then compares the CPU with itself)."""
    import numpy as np
    import torch.distributed as dist

    from ai_rtc_agent_tpu_torch.models import registry
    from ai_rtc_agent_tpu_torch.models import unet as U
    from ai_rtc_agent_tpu_torch.ops.kernels import attention as KA
    from ai_rtc_agent_tpu_torch.parallel import mesh as M

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    # a world of 1: with no MASTER_PORT, init_distributed takes a free loopback port
    dev = M.init_distributed(rank=0, world_size=1, backend="nccl" if cuda else "gloo",
                             device=device)
    try:
        mesh = M.make_mesh()
        try:
            M.make_mesh(tp=2)
            fail("train 17: make_mesh(tp=2) over a world of 1 must raise")
        except ValueError as e:
            if str(e) != "mesh dp*tp*sp=2 exceeds 1 available devices":
                fail(f"train 17: make_mesh(tp=2) raised {e!r}, not the JAX text")
        one = torch.ones(4, device=dev)
        dist.all_reduce(one)
        _sync(torch, dev)
        if mesh.shape != {"dp": 1, "tp": 1, "sp": 1} or not torch.equal(one.cpu(), torch.ones(4)):
            fail(f"train 17: mesh {mesh.shape}, all_reduce over the world gave {one.tolist()}")
        say(f"train 17: {card} | {dist.get_backend()} world of {dist.get_world_size()} up "
            f"through init_distributed on loopback, make_mesh() = {mesh.shape}, make_mesh(tp=2) "
            "refused with the JAX text, one all_reduce over the world")
        cfg = unet_cfg or registry._model_configs(registry.family_of("stabilityai/sd-turbo"))[0]
        launched = _launches()
        train_full(torch, np, card, mesh, cfg, dev)
        if _launches() != launched:
            fail(f"train 17b: training launched kernels: (attention, epilogue) {launched} -> "
                 f"{_launches()}")
        q = torch.randn((1, 64, 2, 64), device=dev, dtype=torch.bfloat16, requires_grad=True)
        try:
            KA.flash_attention(q, q, q)
            fail("train 17b: flash_attention must refuse a q that requires grad")
        except RuntimeError as e:
            if 'attn_impl="plain"' not in str(e):
                fail(f"train 17b: the refusal must name the plain route: {e}")
        say(f"train 17b: {card} | the training steps launched no kernel (attention and "
            f"epilogue counts {launched} before and after); flash_attention refused a bf16 q "
            "that requires grad")
        train_card_vs_cpu(torch, np, card, mesh, U.UNetConfig.tiny(), dev)
        train_checkpoint(torch, np, card, mesh, U.UNetConfig.tiny(), dev)
    finally:
        M.shutdown_distributed()
    say(f"train: phase 17 took {time.perf_counter() - t_phase:.1f} s")


def _trainer(torch, mesh, cfg, params, device, lr):
    from ai_rtc_agent_tpu_torch.models import unet as U
    from ai_rtc_agent_tpu_torch.ops import schedule as S
    from ai_rtc_agent_tpu_torch.parallel.trainer import ShardedTrainer, TrainerConfig

    def unet_apply(p, x, t, ctx, added):
        return U.apply_unet(p, x, t, ctx, cfg, attn_impl="plain", added_cond=added)

    return ShardedTrainer(unet_apply, S.make_schedule(), mesh, params,
                          TrainerConfig(learning_rate=lr), device=device)


def _train_batch(torch, cfg, batch: int, hw: int, ctx_len: int, seed: int, device):
    """A batch and one fixed (t, noise) from a seed, drawn on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    latents = torch.randn((batch, hw, hw, cfg.in_channels), generator=g, device=device)
    context = torch.randn((batch, ctx_len, cfg.cross_attention_dim), generator=g, device=device)
    t = torch.randint(0, 1000, (batch,), generator=g, device=device)
    noise = torch.randn(latents.shape, generator=g, device=device)
    return {"latents": latents, "context": context}, t, noise


def _nbytes(state) -> int:
    return sum(a.numel() * a.element_size() for a in _tensors(state))


def train_step_flops(torch, cfg, batch: int, hw: int, ctx_len: int) -> float:
    """The matmul, conv and einsum FLOPs of one training step (forward and
    backward) at these shapes, counted by torch.utils.flop_counter on the
    meta device (no memory, no device)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ai_rtc_agent_tpu_torch.models import unet as U

    params = U.init_unet(None, cfg, device="meta")
    for a in _tensors(params):
        a.requires_grad_(True)
    x = torch.empty((batch, hw, hw, cfg.in_channels), device="meta")
    ctx = torch.empty((batch, ctx_len, cfg.cross_attention_dim), device="meta")
    t = torch.zeros((batch,), dtype=torch.long, device="meta")
    with FlopCounterMode(display=False) as counter:
        U.apply_unet(params, x, t, ctx, cfg, attn_impl="plain").square().mean().backward()
    return float(counter.get_total_flops())


def train_full(torch, np, card: str, mesh, cfg, dev):
    """17a: TRAIN_STEPS steps of the full-width trainer on one batch, beside
    the step's bound: its products' FLOPs over the f32 peak (the products
    run in f32 with TF32 off, outside the tensor cores)."""
    from ai_rtc_agent_tpu_torch.models import unet as U
    from ai_rtc_agent_tpu_torch.parallel.sharding import leaves_with_paths

    cuda = dev.type == "cuda"
    t = time.perf_counter()
    params = U.init_unet(torch.Generator(device=dev).manual_seed(17), cfg, device=dev)
    n_params = sum(a.numel() for a in _tensors(params))
    tr = _trainer(torch, mesh, cfg, params, dev, TRAIN_LR)
    del params
    if cuda:
        torch.cuda.empty_cache()
    _sync(torch, dev)
    built = time.perf_counter() - t
    hw = 64 if cfg.block_out_channels[0] == 320 else 8
    batch, t_, noise = _train_batch(torch, cfg, 2, hw, 77, 170, dev)
    base = torch.cuda.memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    proj = []
    for i in range(TRAIN_STEPS):
        _sync(torch, dev)
        t0 = time.perf_counter()
        losses.append(tr.step(batch, t=t_, noise=noise))
        _sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            proj = [(p, a.grad) for p, a in leaves_with_paths(tr.state["params"])
                    if p[-2] in ("to_q", "to_k", "to_v")]
            bad = [p for p, g in proj
                   if g is None or not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0)]
            if not proj or bad:
                fail(f"train 17a: {len(bad)} of {len(proj)} attention projections without a "
                     f"finite non-zero gradient after the first backward: {bad[:3]}")
            grad_max = min(float(g.abs().max()) for _p, g in proj)
            proj = len(proj)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    flops = train_step_flops(torch, cfg, 2, hw, 77)
    step_ms = _median(ms[1:])
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"train 17a: the losses must be finite and the last below the first: {losses}")
    st = tr.state
    state = _nbytes([st["params"], st["opt"]["mu"], st["opt"]["nu"]])
    grads = sum(a.grad.numel() * a.grad.element_size() for a in _tensors(st["params"]))
    say(f"train 17a: {card} | ShardedTrainer over sd-turbo's UNet ({n_params / 1e6:.1f} M "
        f"parameters, f32, attn_impl=\"plain\", mesh {mesh.shape}) built in {built:.1f}s | "
        f"batch 2 of {list(batch['latents'].shape[1:])} latents and "
        f"{list(batch['context'].shape[1:])} context, t {t_.tolist()} fixed, lr {TRAIN_LR} | "
        f"losses {[round(x, 6) for x in losses]} | ms a step {[round(x, 1) for x in ms]}, "
        f"median of steps 2-{TRAIN_STEPS} {step_ms:.1f}; the step's products {flops / 1e12:.3f} "
        f"TFLOP (flop_counter), {flops / step_ms / 1e9:.1f} TFLOP/s achieved, bound "
        f"{flops / PEAK_F32_FLOPS * 1e3:.1f} ms at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s f32 | "
        f"{proj} to_q/to_k/to_v "
        f"gradients finite and non-zero (smallest max |g| {grad_max:.3e}) | train state "
        f"(params + mu + nu) {state / 1e9:.3f} GB, with grads {(state + grads) / 1e9:.3f} GB | "
        f"max_memory_allocated {peak / 1e9:.3f} GB ({base / 1e9:.3f} GB allocated before the "
        f"first step) | matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    if cuda:
        tr_ = kernel_trace(torch, lambda: tr.step(batch, t=t_, noise=noise), classes=True)
        say(f"train 17a: {card} | a sixth step traced (device only): busy {tr_['busy_ms']:.1f} "
            f"ms, idle share {tr_['idle']:.3f}, {tr_['kernels']} kernels, attention kernels "
            f"{tr_['attention']}; device ms by class: " + ", ".join(
                f"{k} {v:.1f}" for k, v in sorted(tr_["by_class"].items(), key=lambda kv: -kv[1])))
        if tr_["attention"] or tr_["epilogue"]:
            fail("train 17a: the traced training step ran a port kernel")
    del tr
    if cuda:
        torch.cuda.empty_cache()


def train_card_vs_cpu(torch, np, card: str, mesh, cfg, dev):
    """17c: one tiny trainer step on ``dev`` and on the CPU from the same
    state and (t, noise)."""
    from ai_rtc_agent_tpu_torch.models import unet as U
    from ai_rtc_agent_tpu_torch.parallel.sharding import leaves_with_paths

    params = U.init_unet(torch.Generator().manual_seed(171), cfg)
    batch, t_, noise = _train_batch(torch, cfg, 4, 8, 7, 172, "cpu")
    runs = {}
    for where in (dev, torch.device("cpu")):
        tr = _trainer(torch, mesh, cfg, params, where, TRAIN_TINY_LR)
        loss = tr.step(batch, t=t_, noise=noise)
        runs[where.type if where == dev else "cpu"] = (loss, {
            p: a.detach().cpu() for p, a in leaves_with_paths(tr.state["params"])})
    (lc, pc), (lh, ph) = runs[dev.type], runs["cpu"]
    err = max(float((pc[p] - ph[p]).abs().max()) for p in ph)
    rel = abs(lc - lh) / abs(lh)
    if rel > 1e-5 or err > TRAIN_PARAM_ATOL:
        fail(f"train 17c: the {dev.type} step is not the CPU step: loss {lc} vs {lh} (rel "
             f"{rel:.2e}, limit 1e-5), max |param diff| {err:.3e} (limit {TRAIN_PARAM_ATOL})")
    say(f"train 17c: {card} | one tiny trainer step (lr {TRAIN_TINY_LR}, batch 4) on "
        f"{dev.type} vs the CPU from one state and (t, noise): loss {lc:.7f} vs {lh:.7f} "
        f"(rel {rel:.2e}, limit 1e-5), every parameter within {err:.3e} (limit "
        f"{TRAIN_PARAM_ATOL})")


def train_checkpoint(torch, np, card: str, mesh, cfg, dev):
    """17d: a tiny checkpoint round trip on ``dev``."""
    import shutil

    from ai_rtc_agent_tpu_torch.models import unet as U

    ckpt = Path(__file__).resolve().parent / "build" / "phase17-ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        params = U.init_unet(torch.Generator().manual_seed(173), cfg)
        batch, t_, noise = _train_batch(torch, cfg, 4, 8, 7, 174, "cpu")
        tr = _trainer(torch, mesh, cfg, params, dev, TRAIN_TINY_LR)
        tr.step(batch, t=t_, noise=noise)
        t = time.perf_counter()
        path = tr.save(str(ckpt))
        save_ms = (time.perf_counter() - t) * 1e3
        fresh = _trainer(torch, mesh, cfg, params, dev, TRAIN_TINY_LR)
        t = time.perf_counter()
        if not fresh.restore(str(ckpt)):
            fail("train 17d: restore found no checkpoint")
        restore_ms = (time.perf_counter() - t) * 1e3
        a, b = _tensors(tr.full_state()), _tensors(fresh.full_state())
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail("train 17d: the restored state must equal the saved one bit for bit")
        _batch2, t2, noise2 = _train_batch(torch, cfg, 4, 8, 7, 175, "cpu")
        la, lb = tr.step(batch, t=t2, noise=noise2), fresh.step(batch, t=t2, noise=noise2)
        if abs(la - lb) > 5e-6:
            fail(f"train 17d: the resumed step's loss {lb} vs the continued {la}")
        size = sum(f.stat().st_size for f in Path(path).iterdir())
        say(f"train 17d: {card} | tiny train state saved at step 1 ({Path(path).name}, {size} B, "
            f"{save_ms:.1f} ms) and restored by a fresh trainer bit for bit ({restore_ms:.1f} "
            f"ms); the next step's loss {lb:.7f} vs the continued {la:.7f}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def _to_cpu(v):
    return {k: _to_cpu(x) for k, x in v.items()} if isinstance(v, dict) else v.cpu()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


MESH_FRAMES = 4  # frames a session in 18a and 18b
MESH_TRACED = 4  # bucket steps in 18b's device traces


def phase_mesh(torch, card: str, pipe, ref_bundle, device="cuda", traced=True,
               world=True) -> tuple:
    """Phase 18: the serving mesh at world size 1 (18a-18d, see the module
    docstring), on phase 4's pipeline.  ``traced`` takes 18b's device
    traces;
    ``world=False`` leaves the process group down and skips 18d, which needs
    it.  ``device="cpu"`` rehearses it on the CPU (a gloo world, eager steps;
    the device trace is card-only).  -> the attention and epilogue launches
    counted."""
    import numpy as np

    from ai_rtc_agent_tpu_torch.parallel import mesh as M

    t_phase = time.perf_counter()
    total = [0, 0]
    saved = {k: os.environ.get(k) for k in ("MESH_SHAPE", "BATCHSCHED_DP", "ATTN_IMPL")}
    # the whole phase in a world of 1, as an agent started under torchrun runs
    if world:
        M.init_distributed(rank=0, world_size=1, backend="nccl" if device == "cuda" else "gloo",
                           device=device)
    try:
        counts, dp1 = mesh_default(torch, np, card, pipe)
        for a, e in (counts, mesh_dp2(torch, np, card, pipe, ref_bundle, dp1, traced),
                     mesh_ring(torch, np, card, pipe)):
            total[0] += a
            total[1] += e
        if world:
            mesh_refusals(torch, card, pipe)
    finally:
        if world:
            M.shutdown_distributed()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    say(f"mesh: phase 18 took {time.perf_counter() - t_phase:.1f} s; launches counted "
        f"attention {total[0]}, epilogue {total[1]}")
    return tuple(total)


def _two_sessions(sched, seeds=(300, 301)):
    return [sched.claim(f"mesh{i}", prompt=SESSION_PROMPTS[i], seed=s)
            for i, s in enumerate(seeds)]


def _lockstep_frames(sessions, frames, n: int) -> list:
    """``n`` frames through each session in lockstep (every session's frame
    submitted before any is fetched: one bucket step carries them all)."""
    outs = [[] for _ in sessions]
    for j in range(n):
        handles = [s.submit(f[j]) for s, f in zip(sessions, frames)]
        for i, (s, h) in enumerate(zip(sessions, handles)):
            outs[i].append(s.fetch(h))
    return outs


def mesh_default(torch, np, card, pipe) -> tuple:
    """18a: the trivial mesh's knobs change nothing.  -> (the launches
    counted, the knob-free dp=1 scheduler with its two live sessions)."""
    from ai_rtc_agent_tpu_torch.server import sessions as S
    from ai_rtc_agent_tpu_torch.stream.engine import stream_engine_key
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler
    from ai_rtc_agent_tpu_torch.utils import env

    A = attention_per_pass(pipe.bundle.unet_cfg, False)  # attention launches a step (32)
    for k in ("MESH_SHAPE", "BATCHSCHED_DP", "ATTN_IMPL"):
        os.environ.pop(k, None)
    plain = BatchScheduler.from_pipeline(pipe, max_sessions=2, window_ms=10_000.0)
    os.environ.update(MESH_SHAPE="1,1,1", BATCHSCHED_DP="1")
    knobs = None
    try:
        mesh = S.serving_mesh({"tp": 1, "sp": 1})
        cfg = S.stream_config({"model_id": pipe.model_id, "tp": 1, "sp": 1}, pipe.device)
        knobs = BatchScheduler.from_pipeline(pipe, dp=env.batchsched_dp(), max_sessions=2,
                                             window_ms=10_000.0)
        if mesh is not None or cfg is not None or knobs.dp != 1 or knobs.mesh is not None:
            fail(f"mesh 18a: the trivial knobs built mesh {mesh}, config {cfg}, dp {knobs.dp}")
        if (knobs.bucket_keys() != plain.bucket_keys()
                or stream_engine_key(pipe.model_id, pipe.config) != pipe.engine.key):
            fail("mesh 18a: the trivial knobs changed the graph keys")
        launched = _launches()
        frames = [_frames(np, MESH_FRAMES, seed=70 + i, size=pipe.config.height) for i in range(2)]
        got = [_lockstep_frames(_two_sessions(sc), frames, MESH_FRAMES) for sc in (plain, knobs)]
        a, e = (x - y for x, y in zip(_launches(), launched))
        same = all(np.array_equal(x, y) for p, q in zip(*got) for x, y in zip(p, q))
        if not same or (a, e) != (2 * A * MESH_FRAMES, 2 * MESH_FRAMES):
            fail(f"mesh 18a: frames equal {same}, launches ({a}, {e}) over {2 * MESH_FRAMES} "
                 "bucket steps")
        say(f"mesh 18a: {card} | MESH_SHAPE=1,1,1 BATCHSCHED_DP=1 --tp 1 --sp 1: no mesh, the "
            f"default config, dp 1, buckets {knobs._bucket_sizes}, keys equal the knob-free "
            f"scheduler's ({knobs.bucket_keys()[(2, 'full')]}), 2 sessions x {MESH_FRAMES} "
            f"frames equal bit for bit; launches ({a}, {e})")
    except BaseException:
        plain.close()
        raise
    finally:
        if knobs is not None:
            knobs.close()
    return (a, e), plain


def mesh_dp2(torch, np, card, pipe, ref_bundle, dp1=None, traced=True) -> tuple:
    """18b: the dp=2 scheduler, both shards on one card, against ``dp1``
    (closed after); ``traced``: with its device traces."""
    from ai_rtc_agent_tpu_torch.parallel.multipeer import BucketStep, on_device
    from ai_rtc_agent_tpu_torch.stream.engine import install_row, install_state
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler
    from ai_rtc_agent_tpu_torch.tree import tree_map

    A = attention_per_pass(pipe.bundle.unet_cfg, False)  # attention launches a step (32)
    dev = torch.device(pipe.device.type, 0) if pipe.device.type == "cuda" else pipe.device
    counted = [0, 0]
    try:
        t = time.perf_counter()
        sched = None
        sched = BatchScheduler.from_pipeline(pipe, dp=2, devices=[dev, dev], max_sessions=2,
                                             window_ms=10_000.0)
        built = time.perf_counter() - t
        sess = _two_sessions(sched)
        ref_sess = [s for s in dp1._sessions.values()]
        shards = [s.snapshot()["shard"] for s in sess]
        if [s.slot for s in sess] != [0, 1] or shards != [0, 1]:
            fail(f"mesh 18b: two claims landed on slots {[s.slot for s in sess]} shards {shards}")
        # the dp=1 scheduler's live rows, as they are now, into the shards
        rows = {s.slot: session_row(dp1.states, s.slot) for s in ref_sess}
        for s, r in zip(sess, ref_sess):
            sh, i = sched._row(s.slot)
            install_row(sh.states, i, rows[r.slot])
        deds = [Dedicated(torch, pipe.bundle.stream_models, pipe.bundle.params, pipe.config,
                          pipe.bundle.encode_prompt, ref_bundle, rows[r.slot], pipe.device)
                for r in ref_sess]
        frames = [_frames(np, MESH_FRAMES, seed=80 + i, size=pipe.config.height) for i in range(2)]
        # each shard's replay against its eager step, from copies of its rows
        replay = []
        for sh in sched._shards:
            with sched._step_lock, on_device(sh.device):
                saved = tree_map(lambda a: a.clone(), sh.states)
                copy = tree_map(lambda a: a.clone(), sh.states)
                f = np.stack(frames[sh.index][:1])
                eager = BucketStep(sched._template.models, sched.cfg, sh.device, graphs=False)
                want = eager(sh.params, copy, f, [0], 1).clone()
                got = sh.bucket(sh.params, sh.states, f, [0], 1).clone()
                _sync(torch, sh.device)
                same = torch.equal(got, want) and all(
                    torch.equal(a, b) for (_, a), (_, b) in
                    zip(_tree_paths(sh.states), _tree_paths(copy)))
                install_state(sh.states, saved)
            if not same:
                fail(f"mesh 18b: shard {sh.index}'s replay differs from its eager step")
            replay.append(sh.bucket.graph_cache.steps()[sched.bucket_keys()[(2, "full")]].launches)
        launched = _launches()
        got = _lockstep_frames(sess, frames, MESH_FRAMES)
        a, e = (x - y for x, y in zip(_launches(), launched))
        want = _lockstep_frames(ref_sess, frames, MESH_FRAMES)
        counted = [a, e]
        if (a, e) != (2 * A * MESH_FRAMES, 2 * MESH_FRAMES):
            fail(f"mesh 18b: ({a}, {e}) launches over {MESH_FRAMES} dp=2 bucket steps, want "
                 f"2 x ({A} + 1) a step")
        lines = []
        for i, ded in enumerate(deds):  # phase 4's criterion, the dp=1 frames as the baseline
            for f in frames[i]:
                ded(f)
            ref = np.stack(ded.refs).astype(np.float32)
            g, w = np.stack(got[i]).astype(np.float32), np.stack(want[i]).astype(np.float32)
            fs, fd = np.abs(g - ref).mean(), np.abs(w - ref).mean()
            if not np.isfinite(g).all() or fs > 2 * fd + 0.5:
                fail(f"mesh 18b session {i}: {fs:.3f} levels from the f32 reference against the "
                     f"dp=1 scheduler's {fd:.3f}")
            lines.append(f"session {i} (shard {shards[i]}): vs f32 {fs:.3f} (dp=1 {fd:.3f}), vs "
                         f"dp=1 mean {np.abs(g - w).mean():.3f} max {np.abs(g - w).max():.0f}")
        say(f"mesh 18b: {card} | dp=2 scheduler on [{dev}, {dev}] built in {built:.1f} s, "
            f"buckets {sched._bucket_sizes}, captured {sched.graph_status()}, each shard's k=1 "
            f"graph {replay} launches a replay, replay = eager bit for bit on each shard; "
            f"launches ({a}, {e}) over {MESH_FRAMES} bucket steps; " + " | ".join(lines)
            + f"; key {sched.bucket_keys()[(2, 'full')]}")
        if traced and pipe.device.type == "cuda":
            busy = {}
            before = _launches()
            for name, sc, ss in (("dp=1", dp1, ref_sess), ("dp=2", sched, sess),
                                 ("dp=2", sched, sess), ("dp=1", dp1, ref_sess)):
                tr = bucket_trace(torch, sc, [s.slot for s in ss],
                                  [f[0] for f in frames], MESH_TRACED)
                per = 2 if sc is sched else 1
                if (tr["attention"], tr["epilogue"]) != (per * A * MESH_TRACED,
                                                         per * MESH_TRACED):
                    fail(f"mesh 18b: the {name} trace shows {tr['attention']} attention and "
                         f"{tr['epilogue']} epilogue kernels over {MESH_TRACED} bucket steps")
                busy.setdefault(name, []).append(tr["busy_ms"] / MESH_TRACED)
            counted = [c + x - y for c, x, y in zip(counted, _launches(), before)]
            say(f"mesh 18b: {card} | settled device traces of {MESH_TRACED} bucket steps of 2 "
                f"sessions, in turns (dp=1, dp=2, dp=2, dp=1): dp=2 {2 * A} attention + 2 "
                f"epilogue kernels a step, dp=1 {A} + 1; busy ms a step dp=1 "
                f"{[round(x, 3) for x in busy['dp=1']]}, dp=2 "
                f"{[round(x, 3) for x in busy['dp=2']]} (two k=1 graphs on one card against one "
                "k=2 graph: the mechanism, not a scale-out)")
        # no capture through a leave, a join and a prompt swap
        built_steps = [len(sh.bucket.graph_cache.steps()) for sh in sched._shards]
        sess[1].release()
        before = _launches()
        solo = _lockstep_frames(sess[:1], frames, 1)
        a1, e1 = (x - y for x, y in zip(_launches(), before))
        again = sched.claim("mesh-rejoin", prompt=SESSION_PROMPTS[2], seed=302)
        sess[0].update_prompt(SESSION_PROMPTS[3])
        before = _launches()
        _lockstep_frames([sess[0], again], frames, 1)
        a2, e2 = (x - y for x, y in zip(_launches(), before))
        after = [len(sh.bucket.graph_cache.steps()) for sh in sched._shards]
        if after != built_steps or (a1, e1, a2, e2) != (A, 1, 2 * A, 2) or again.slot != 1:
            fail(f"mesh 18b churn: graphs {built_steps} -> {after}, launches solo ({a1}, {e1}) "
                 f"pair ({a2}, {e2}), the rejoin on slot {again.slot}")
        counted = [counted[0] + a1 + a2, counted[1] + e1 + e2]
        say(f"mesh 18b: leave, solo step (one shard stepped: ({a1}, {e1}) launches), a join "
            f"back onto shard {sched._slot_shard(again.slot)} and a prompt swap, then both "
            f"({a2}, {e2}): no capture (graphs per shard {after}); solo frame mean "
            f"{solo[0][0].mean():.2f}")
    finally:
        if sched is not None:
            sched.close()
        dp1.close()
    return tuple(counted)


def bucket_trace(torch, sched, slots: list, frames: list, steps: int) -> dict:
    """A settled device trace of ``steps`` bucket steps of ``slots`` (one host
    frame each) through the scheduler's captured graphs, every shard's, on
    this thread under the step lock; the states are put back after."""
    from ai_rtc_agent_tpu_torch.stream.engine import install_state
    from ai_rtc_agent_tpu_torch.tree import tree_map

    k = sched._bucket_for_slots(slots)
    staged = [torch.from_numpy(f[None]).to(sched._slot_device(s)) for s, f in zip(slots, frames)]
    with sched._step_lock:
        saved = [tree_map(lambda a: a.clone(), st) for st in sched.shard_states()]
        tr = kernel_trace(torch, lambda: [sched._step_shards(staged, slots, k, "full").row(0)
                                          for _ in range(steps)])
        for st, sv in zip(sched.shard_states(), saved):
            install_state(st, sv)
    return tr


def mesh_ring(torch, np, card, pipe) -> tuple:
    """18c: ATTN_IMPL=ring with no sp group: the kernel route, bit for bit."""
    from ai_rtc_agent_tpu_torch.models import registry
    from ai_rtc_agent_tpu_torch.stream.engine import StreamEngine, install_state
    from ai_rtc_agent_tpu_torch.tree import tree_map

    os.environ["ATTN_IMPL"] = "ring"
    try:
        route = registry.default_stream_config(pipe.model_id, device=pipe.device).attn_impl
    finally:
        os.environ.pop("ATTN_IMPL", None)
    if route != "ring":
        fail(f"mesh 18c: ATTN_IMPL=ring gave the route {route!r}")
    cfg = replace(pipe.config, attn_impl=route)
    bundle = registry.load_model_bundle(pipe.model_id, device=pipe.device, attn_impl="ring",
                                        params=pipe.bundle.params)
    eng = StreamEngine(bundle.stream_models, pipe.bundle.params, cfg, bundle.encode_prompt,
                       device=pipe.device, model_id=pipe.model_id)
    A = attention_per_pass(pipe.bundle.unet_cfg, False)  # attention launches a step (32)
    base = pipe.engine
    eng.state = tree_map(lambda a: a.clone(), base.state)
    eng.capture()
    frame = _frames(np, 1, seed=90, size=pipe.config.height)[0]
    with base._submit_lock:
        saved = tree_map(lambda a: a.clone(), base.state)
    before = _launches()
    got = eng(frame)
    a, e = (x - y for x, y in zip(_launches(), before))
    want = base(frame)
    with base._submit_lock:
        install_state(base.state, saved)
    step = eng.graph_cache.steps()[eng.key]
    want_launches = (A, 1) if eng.graphs else (0, 0)  # an eager step records none
    if (a, e) != (A, 1) or step.launches != want_launches or not np.array_equal(got, want):
        fail(f"mesh 18c: ATTN_IMPL=ring without an sp group launched ({a}, {e}) (graph "
             f"{step.launches}), frame equal to the default's {np.array_equal(got, want)}")
    say(f"mesh 18c: {card} | ATTN_IMPL=ring, no sp group: key {eng.key}, the captured step "
        f"records {step.launches} (attention, epilogue) launches a replay, ({a}, {e}) counted; "
        "its frame equals the default engine's bit for bit (the local case takes the kernel)")
    return a, e


def mesh_refusals(torch, card, pipe):
    """18d, in a world of 1: MESH_SHAPE=1,1,1 builds no mesh, and what one
    card cannot serve raises the JAX texts."""
    import numpy as np

    from ai_rtc_agent_tpu_torch.models import quant as Q
    from ai_rtc_agent_tpu_torch.parallel import mesh as M
    from ai_rtc_agent_tpu_torch.server import sessions as S
    from ai_rtc_agent_tpu_torch.stream.engine import StreamEngine
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    import torch.distributed as dist

    os.environ["MESH_SHAPE"] = "1,1,1"
    if S.serving_mesh({"tp": 1, "sp": 1}) is not None:
        fail("mesh 18d: MESH_SHAPE=1,1,1 --tp 1 --sp 1 built a mesh in a world of 1")
    n = torch.cuda.device_count() if pipe.device.type == "cuda" else 0
    over = f"mesh dp*tp*sp=2 exceeds {n} available devices"
    texts = {}
    for name, fn in (
            ("BATCHSCHED_DP=2", lambda: BatchScheduler.from_pipeline(pipe, dp=2, max_sessions=2)),
            ("--tp 2", lambda: S.serving_mesh({"tp": 2, "sp": 0}))):
        try:
            fn()
            fail(f"mesh 18d: {name} on one card must raise")
        except ValueError as e:
            texts[name] = str(e)
    params = dict(pipe.engine.params)
    params["unet"] = dict(params["unet"], conv_in=Q.quantize_params(
        {"conv_in": params["unet"]["conv_in"]}, min_size=1)[0]["conv_in"])
    tp2 = M.Mesh({"dp": 1, "tp": 2, "sp": 1}, np.arange(2).reshape(1, 2, 1), 0,
                 {"dp": 0, "tp": 0, "sp": 0})
    try:
        StreamEngine(pipe.bundle.stream_models, params, pipe.config, pipe.bundle.encode_prompt,
                     device=pipe.device, mesh=tp2)
        fail("mesh 18d: w8 params on a tp mesh must raise")
    except ValueError as e:
        texts["w8 on tp=2"] = str(e)
    want_w8 = ("QUANT_WEIGHTS int8 kernels are incompatible with tensor-parallel serving (tp>1): "
               "quantized leaves have no sharding rules and would replicate. Disable one.")
    if (texts["BATCHSCHED_DP=2"] != over or texts["--tp 2"] != f"mesh dp*tp*sp=2 exceeds 1 "
            "available devices" or texts["w8 on tp=2"] != want_w8):
        fail(f"mesh 18d: refusals {texts}")
    say(f"mesh 18d: {card} | {dist.get_backend()} world of {dist.get_world_size()}: "
        f"MESH_SHAPE=1,1,1 --tp 1 --sp 1 build no mesh; refused with the JAX texts: "
        f"{json.dumps(texts)}")


PREFLIGHT_ARGV = ["--model-id", "stabilityai/sd-turbo", "--peers", "2", "--sched-buckets", "2"]
GOLDEN_TINY = Path(__file__).resolve().parent / "tests" / "golden_torch" / "tiny-test.json"
EMPTY_HF_CACHE = Path(__file__).resolve().parent / "build" / "empty-hf-cache"
# golden.compare's limits for the card's bf16 tiny-test against the CPU f32
# golden (the JAX defaults, 0.9 and 24 levels, are for any device's drift
# from a real-weight capture); two H100 runs read 0.999952 and 0.07 levels
GOLDEN_CARD_LIMITS = dict(thumb_corr_min=0.999, stat_atol=0.5)
# what the preflight may leave allocated on the card once it has returned,
# its garbage is collected and cuBLAS's per-stream workspaces are cleared
# (cleared before it too: the earlier phases' come to GBs)
PREFLIGHT_LEFT_BYTES = 16 << 20


def live_cuda_tensors(torch, top: int = 8) -> list:
    """The ``top`` largest groups of live CUDA tensors the garbage collector
    sees, as (shape, dtype, count, MB of their storages)."""
    import gc

    groups = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            key = (tuple(o.shape), str(o.dtype))
            n, b = groups.get(key, (0, 0))
            groups[key] = (n + 1, b + o.untyped_storage().nbytes())
    big = sorted(groups.items(), key=lambda kv: -kv[1][1])[:top]
    return [(shape, dtype, n, round(b / 1e6, 3)) for (shape, dtype), (n, b) in big]


def phase_preflight(torch, card: str, argv=None, device="cuda") -> tuple:
    """Phase 19: the port's deploy CLIs.  19a: ``assets.build_engines.main``
    (``argv``, default PREFLIGHT_ARGV; ``device="cpu"`` with a tiny model
    rehearses it, capturing nothing): every kernel library built, every key
    captured and its replay = its eager step bit for bit, each key with its
    capture seconds, both kernels launched; then what it leaves allocated
    on the card (its garbage collected, cuBLAS's workspaces cleared) is
    held under PREFLIGHT_LEFT_BYTES.  19b: ``utils.golden.capture
    ("tiny-test")`` (bf16 on the card, both kernels) against the committed
    CPU golden, ``compare()`` empty within GOLDEN_CARD_LIMITS.  19c: a real family with no
    snapshot raises the no-weights error, timed.  19d: the golden script's
    one ``ok: false`` line and non-zero exit in a subprocess.
    -> the attention and epilogue launches of 19a and 19b."""
    import gc

    import numpy as np

    from ai_rtc_agent_tpu_torch.assets import build_engines
    from ai_rtc_agent_tpu_torch.ops.kernels import build as KB
    from ai_rtc_agent_tpu_torch.utils import golden

    t_phase = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    argv = list(PREFLIGHT_ARGV if argv is None else argv) + ["--device", device]
    EMPTY_HF_CACHE.mkdir(parents=True, exist_ok=True)
    total = [0, 0]
    with _Env(HF_HUB_CACHE=EMPTY_HF_CACHE):
        _sync(torch, torch.device(device))
        if cuda:  # cuBLAS keeps a workspace for every stream a capture ran on
            torch._C._cuda_clearCublasWorkspaces()
        mem0 = _memory(torch, cuda)[0]
        _reset_launches()
        t = time.perf_counter()
        keys = build_engines.main(argv)
        took = time.perf_counter() - t
        a, e = _launches()
        total[0] += a
        total[1] += e
        libs = {p.name: KB.library_path(p.name).exists() for p in KB.CSRC_DIR.glob("*.cu")}
        if cuda and not (libs and all(libs.values())):
            fail(f"preflight 19a: kernel libraries not built: {libs}")
        if cuda and not all(isinstance(s, float) for s in keys.values()):
            fail(f"preflight 19a: keys not captured: {keys}")
        if cuda and not (a and e):
            fail(f"preflight 19a: the preflight launched attention {a}, epilogue {e} times")
        for key, s in keys.items():
            say(f"preflight 19a: {key} " + ("stepped eagerly" if s is None else
                                            f"captured in {s:.2f}s, replay = eager bit for bit"))
        gc.collect()
        _sync(torch, torch.device(device))
        mem1 = _memory(torch, cuda)[0]
        if cuda:  # the workspaces of the preflight's streams
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.empty_cache()
        mem2 = _memory(torch, cuda)[0]
        if mem2 - mem0 > PREFLIGHT_LEFT_BYTES:
            fail(f"preflight 19a: {(mem2 - mem0) / 1e6:.1f} MB more allocated after the "
                 f"preflight than before it (limit {PREFLIGHT_LEFT_BYTES / 1e6:.1f} MB); the "
                 f"largest live CUDA tensors: {live_cuda_tensors(torch)}")
        say(f"preflight 19a: {card} | build_engines.main({argv}) in {took:.1f}s: kernel "
            f"libraries built {libs}, {len(keys)} keys captured and held to their eager "
            f"steps; launches attention {a}, epilogue {e}; allocated {mem0 / 1e9:.4f} GB "
            f"before (cuBLAS's workspaces cleared), {mem1 / 1e9:.4f} GB after it returned, "
            f"{mem2 / 1e9:.4f} GB with them cleared again (limit +{PREFLIGHT_LEFT_BYTES / 1e6:.1f} "
            "MB)")

        gold = json.loads(GOLDEN_TINY.read_text())
        _reset_launches()
        t = time.perf_counter()
        got = golden.capture("tiny-test", device=device)
        took = time.perf_counter() - t
        a, e = _launches()
        total[0] += a
        total[1] += e
        problems = golden.compare(gold, got, **GOLDEN_CARD_LIMITS)
        corr = float(np.corrcoef(gold["fingerprint"]["thumb"], got["fingerprint"]["thumb"])[0, 1])
        gap = max(abs(x - y) for k in ("mean", "std")
                  for x, y in zip(gold["fingerprint"][k], got["fingerprint"][k]))
        if problems:
            fail(f"preflight 19b: the tiny-test golden differs from the CPU capture: {problems}")
        if cuda and not (a and e):
            fail(f"preflight 19b: the golden procedure launched attention {a}, epilogue {e} times")
        say(f"preflight 19b: golden.capture('tiny-test') on {device} in {took:.2f}s against the "
            f"committed CPU f32 golden: compare() empty, thumbnail correlation {corr:.6f}, "
            f"largest mean/std gap {gap:.4f} levels (limits {GOLDEN_CARD_LIMITS}); launches "
            f"attention {a}, epilogue {e}")

        t = time.perf_counter()
        try:
            golden.capture("stabilityai/sd-turbo", device=device)
        except RuntimeError as err:
            if "no local weights for stabilityai/sd-turbo" not in str(err):
                fail(f"preflight 19c: the wrong error: {err}")
        else:
            fail("preflight 19c: a real family with no snapshot did not raise")
        say(f"preflight 19c: golden.capture('stabilityai/sd-turbo') with no snapshot raised the "
            f"no-weights error in {1e3 * (time.perf_counter() - t):.1f} ms")

        script = Path(__file__).resolve().parent / "scripts" / "torch_golden_capture.py"
        out = EMPTY_HF_CACHE.parent / "golden-never-written.json"
        t = time.perf_counter()
        r = subprocess.run([sys.executable, str(script), "--model-id", "bogus/nonexistent",
                            "--device", device, "--out", str(out)],
                           capture_output=True, text=True, timeout=300)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        line = json.loads(lines[0]) if len(lines) == 1 else {}
        if r.returncode == 0 or line.get("ok") is not False or out.exists() or \
                "no local weights for bogus/nonexistent" not in line.get("error", ""):
            fail(f"preflight 19d: the golden script's contract line on failure: rc "
                 f"{r.returncode}, stdout {r.stdout!r}, stderr {r.stderr[-2000:]!r}")
        say(f"preflight 19d: scripts/torch_golden_capture.py --model-id bogus/nonexistent: rc "
            f"{r.returncode}, one line {json.dumps(line)} in {time.perf_counter() - t:.1f}s")
    say(f"preflight: phase 19 took {time.perf_counter() - t_phase:.1f} s; launches counted "
        f"attention {total[0]}, epilogue {total[1]}")
    return tuple(total)


def main():
    if sys.argv[1:2] == ["--native-client"]:  # phase 8's probe: the client side
        native_client(json.loads(sys.argv[2]))
        return
    if sys.argv[1:2] == ["--broadcast-viewers"]:  # phase 11's viewers
        broadcast_viewers(json.loads(sys.argv[2]))
        return
    import faulthandler

    import torch

    faulthandler.enable(all_threads=True)  # a crash in native code prints every thread's stack
    card = phase_device(torch)
    phase_build(torch)
    attn = phase_attention(torch)
    epi = phase_epilogue(torch)
    pipe, ref_bundle, attn_launches, epi_launches = phase_main(torch, card)
    phase_graph_ab(torch, card, pipe, ref_bundle)
    serve_attn, serve_epi, serve_fps = phase_serve(torch, card, pipe)
    sessions_attn, sessions_epi = phase_sessions(torch, card, pipe, ref_bundle)
    faults_attn, faults_epi = phase_faults(torch, card, pipe, ref_bundle)
    native_attn, native_epi = phase_native(torch, card, pipe, serve_fps)
    obs_attn, obs_epi = phase_obs(torch, card, pipe)
    fleet_attn, fleet_epi = phase_fleet(torch, card, pipe, ref_bundle)
    broadcast_attn, broadcast_epi = phase_broadcast(torch, card, pipe)
    adapters_attn, adapters_epi = phase_adapters(torch, card, pipe, ref_bundle)
    mesh_attn, mesh_epi = phase_mesh(torch, card, pipe, ref_bundle)
    del pipe, ref_bundle
    sd15_attn, sd15_epi = phase_sd15(torch, card)
    variants_attn, variants_epi = phase_variants(torch, card)
    cnet_attn, cnet_epi = phase_controlnet(torch, card)
    sdxl_attn, sdxl_epi = phase_sdxl(torch, card)
    phase_train(torch, card)
    preflight_attn, preflight_epi = phase_preflight(torch, card)
    attn_launches += (serve_attn + sessions_attn + faults_attn + native_attn + obs_attn
                      + fleet_attn + broadcast_attn + sd15_attn + variants_attn + cnet_attn
                      + adapters_attn + sdxl_attn + mesh_attn + preflight_attn)
    epi_launches += (serve_epi + sessions_epi + faults_epi + native_epi + obs_epi + fleet_epi
                     + broadcast_epi + sd15_epi + variants_epi + cnet_epi + adapters_epi
                     + sdxl_epi + mesh_epi + preflight_epi)
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
