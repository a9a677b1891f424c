"""Typed environment-variable reads — the port's copy of the getters the
serving seam uses (counterpart of ai_rtc_agent_tpu/utils/env.py).

Variables read by the port's server:
  WARMUP_FRAMES, DROP_FRAMES        track warm-up / OBS stutter workaround
  PIPELINE_DEPTH                    frames in flight per track
  HW_ENCODE (alias NVENC)           bare ndarray frames out (no pts wrap);
                                    the native tier's H.264 encoder (else NullCodec)
  HW_DECODE (alias NVDEC)           the native tier's H.264 decoder (else NullCodec)
  ENC_PRESET, ENC_TUNING_INFO, ENC_DEFAULT/MIN/MAX_BITRATE (aliases NVENC_*)
                                    H.264 encoder tuning (media/codec.py)
  WEBRTC_PROVIDER                   aiortc | native-rtp | loopback
  ADVERTISE_HOST                    the address real-SDP answers carry (127.0.0.1)
  HOST_PLANE_BATCH, HOST_PLANE_RX_BATCH, HOST_PLANE_SENDMMSG,
  HOST_PLANE_POOL_SLOTS, HOST_PLANE_RX_POOL_SLOTS, HOST_PLANE_RX_MTU,
  HOST_PLANE_RX_DRAIN_MAX, HOST_PLANE_RING_POP_POOL
                                    the media plane's batched TX/RX (media/)
  RTCP_REPORT_INTERVAL_S            RTCP report cadence (media/rtcp.py)
  OVERLOAD_TX_DEADLINE_MS, OVERLOAD_RX_QUEUE_BOUND
                                    the media plane's encode deadline, client RX bound
  NETADAPT, NETADAPT_*              the network-adaptation ladder
                                    (resilience/netadapt.py, via overload.py)
  BROADCAST_GOP_CACHE_AUS, BROADCAST_GOP_CACHE_BYTES   the GOP cache's bounds (media/gop.py)
  WEBHOOK_URL, AUTH_TOKEN           stream lifecycle webhooks
  ICE_SERVERS, TWILIO_ACCOUNT_SID, TWILIO_AUTH_TOKEN   TURN servers
  BATCHSCHED                        the cross-session batch scheduler (default on)
  BATCHSCHED_MAX_SESSIONS           its session slots (8)
  BATCHSCHED_WINDOW_MS              its coalescing window (3 ms)
  BATCHSCHED_QUEUE_BOUND            frames queued per session (2)
  BATCHSCHED_PREWARM                step every bucket once at startup (on)
  BATCHSCHED_DP                     the scheduler's dp session axis (shards of one process)
  MESH_SHAPE                        the serving mesh "dp,tp,sp" (or "8x1x1")
  ATTN_IMPL                         pallas (the kernel) | ring | ulysses; xla is refused
  ADAPTER_DIR                       per-session style adapters: a directory of LoRA
                                    *.safetensors served as factor banks (unset: off)
  ADAPTER_RANK_BUCKETS              the banks' padded ranks (4,8,16)
  MULTIPEER_BUCKETS                 --multipeer steps only the active slots (on)
  OVERLOAD_PEER_QUEUE_BOUND         --multipeer's frames queued per peer (2; at least 1)
  SUPERVISOR                        per-session supervision (on)
  SUPERVISOR_STALL_AFTER_S          output-age watchdog (5 s)
  RESILIENCE_STEP_TIMEOUT_S         a supervised step's budget (5 s)
  RESILIENCE_FIRST_STEP_TIMEOUT_S   the first steps' budget (300 s)
  OVERLOAD_CONTROL                  admission, shedding ladder, ingest shed (on)
  OVERLOAD_STEP_BUDGET_MS, OVERLOAD_LOOP_LAG_BUDGET_MS   pressure budgets (1000, 200)
  OVERLOAD_MAX_SESSIONS             session cap (0: none)
  OVERLOAD_RETRY_AFTER_S            Retry-After base (2 s)
  OVERLOAD_FRAME_DEADLINE_MS        ingest freshness deadline (500 ms)
  OVERLOAD_TICK_S, OVERLOAD_UP_TICKS, OVERLOAD_DOWN_TICKS, OVERLOAD_PROBE_S,
  OVERLOAD_LAG_INTERVAL_MS          the ladder's cadence and hysteresis
  ENGINE_GUARD                      the engine guard over the batch scheduler (on)
  ENGINE_STEP_DEADLINE_S            a bucket step's deadline, to its completion (30 s)
  ENGINE_COLD_DEADLINE_S            a capturing step's and a rebuild's (600 s)
  ENGINE_REBUILD_MAX_ATTEMPTS       rebuild attempts before evacuating (3)
  ENGINE_REBUILD_BACKOFF_S          the first attempt's backoff, doubling (1 s)
  ENGINE_SNAPSHOT_EVERY_S           snapshot bank cadence (5 s; <= 0 off)
  EVACUATE_URL, WORKER_ID           self-evacuation on an exhausted rebuild
  FAULT_PLAN                        fault injection plan (JSON, or @file)
  TRACE_ENABLE                      frame tracing from startup (off; /debug/trace opens windows)
  TRACE_RING_FRAMES                 completed timelines kept per session (256)
  TRACE_MAX_CAPTURE_S               a /debug/trace window's cap (300 s)
  FLIGHT_RECORDER                   the flight recorder, tracing and the SLO feed (on)
  FLIGHT_EVENTS, FLIGHT_SNAPSHOTS   its event log per session (256), snapshots kept (8)
  SLO_ENABLE                        the stage-latency SLO plane (on; needs FLIGHT_RECORDER)
  SLO_<STAGE>_BUDGET_MS             each stage's budget (obs/slo.py, the JAX defaults)
  SLO_TICK_S, SLO_OBJECTIVE, SLO_BURN_THRESHOLD, SLO_FAST_WINDOW_S, SLO_SLOW_WINDOW_S,
  SLO_UP_TICKS, SLO_DOWN_TICKS      its burn-rate cadence, windows and hysteresis
  DEVTEL_ENABLE                     device telemetry: the build watchdog, graph-cache,
                                    transfer and memory gauges (on)
  DEVTEL_RETRACE_MIN_MS             a serving-phase build that breaches (250 ms)
  DEVTEL_MEM_INTERVAL_S             the memory sample's rate limit (5 s)
  DEVTEL_COMPILE_LOG                builds kept for /health (64)
  DEVTEL_BREACH_COALESCE_S          one breach alert volley per window (5 s)
  MIGRATE_ENABLE                    live session migration: /migrate/export, /migrate/import,
                                    the router's drain?mode=migrate and crash restore (on)
  MIGRATE_TIMEOUT_S                 one migrate-drain sweep's budget; the rest keep
                                    kill-drain semantics (30 s)
  MIGRATE_MAX_PARALLEL              sessions moved at once in a sweep (2)
  RECYCLE_ENABLE                    the agent's POST /admin/recycle restart-in-place (on)
  RECYCLE_HANDOFF                   the handoff file of exported sessions (unset: a per-pid
                                    file under the temp dir); the replacement reads and
                                    removes it at startup, before it reports healthy
  RECYCLE_EXEC_HOOK                 shell command that spawns the replacement (unset:
                                    argv re-exec)
  RECYCLE_EXIT_DELAY_S              beat between the 202 and the old process's exit (0.2 s)
  UPGRADE_STEP_TIMEOUT_S            each phase of one rolling-upgrade step (60 s)
  JOURNEY_ENABLE                    the fleet journey plane: X-Journey-Id per placed session,
                                    journey rings, incident bundles (on)
  JOURNEY_MAX, JOURNEY_RING, JOURNEY_EVIDENCE, JOURNEY_BUNDLES
                                    its bounds: journeys (1024), ring entries (64), evidence
                                    captures per journey (4), sealed bundles (8)
  FLEET_POLL_S, FLEET_POLL_TIMEOUT_S  the router's poll cadence and timeout (0.25, 2 s)
  FLEET_DEAD_AFTER                  failed polls before an agent is DEAD (3)
  FLEET_MAX_AGENTS                  bounded membership (64)
  FLEET_PLACE_ATTEMPTS              agents tried per placement (3)
  FLEET_RETRY_AFTER_S               fleet-wide refusal's Retry-After (2 s)
  FLEET_PROXY_TIMEOUT_S             one proxied signaling exchange (30 s)
  FLEET_SESSION_TABLE               the router's session table bound (4096)
  AUTOSCALE_ENABLE                  the router's demand-driven scaling loop (off)
  AUTOSCALE_HIGH, AUTOSCALE_LOW, AUTOSCALE_ALPHA, AUTOSCALE_UP_TICKS,
  AUTOSCALE_DOWN_TICKS, AUTOSCALE_COOLDOWN_S, AUTOSCALE_MIN_AGENTS,
  AUTOSCALE_MAX_AGENTS, AUTOSCALE_TICK_S
                                    its pressure EWMA, hysteresis, cooldown and bounds
                                    (0.8, 0.2, 0.3, 3, 10, 30 s, 1, 16, 1 s)
  AUTOSCALE_EXEC_HOOK               shell command that provisions one new agent
  WORKER_PUBLISH_URL                the worker sidecar's publish target (the router's
                                    /fleet/register); unset: log only
  WORKER_ID                         identity published (hostname)
  PUBLIC_IP, PUBLIC_PORT            the published address (unset / the agent's port)
  AGENT_TIMEOUT                     the worker's lease after publishing (600 s)
  WORKER_REPUBLISH_S                capacity re-check cadence during the lease (5 s)
  BROADCAST_FANOUT                  WHEP viewers of a native-tier stream join the
                                    publisher's broadcast group (on; server/broadcast.py)
  BROADCAST_MAX_VIEWERS             viewers admitted per agent (256; 0: uncapped)
  BROADCAST_EDGE_PULL               the router places viewers on edge agents, which
                                    pull one copy from the owner (on)
  HF_HUB_CACHE                      the local HF snapshot cache the registry looks in
                                    (~/.cache/huggingface/hub; models/registry.py)
  HED_CHECKPOINT                    a local ControlNetHED.pth for --annotator hed (else a
                                    snapshot of lllyasviel/Annotators; models/hed.py)
  SAFETY_CHECKER                    the NSFW gate on every served frame (off;
                                    models/safety.py, stream/pipeline.py)
  QUANT_WEIGHTS                     w8 (or int8): large kernels stored as int8 + a
                                    per-output-channel scale (models/quant.py; off)
  QUANT_MIN_SIZE                    elements below which a kernel stays dense (16384)
  UNET_CACHE                        DeepCache interval, N or deepcache:N (the agent's
                                    --unet-cache; 0/1 off; models/registry.py)
  CXX                               the C++ compiler that builds native/ (g++; media/native.py)
  RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT
                                    torchrun's process-group variables, read by
                                    parallel/mesh.init_distributed (unset: one process)
  PERF_LOG_PATH                     where utils/perfbank.bank appends (unset: the repo's
                                    PERF_LOG.jsonl; empty or os.devnull: off)
  CIVITAI_CACHE                     assets/download.py's Civitai LoRA directory
                                    (./models/civitai)

The knob registries are docs/environment.md (the knobs both agents answer) and
ai_rtc_agent_tpu_torch/environment.md (the port's own, and the documented knobs it
leaves unread, with why); ``python -m ai_rtc_agent_tpu_torch.analysis`` holds the
reads here to them.
"""

from __future__ import annotations

import os


def get_str(name: str, default: str | None = None) -> str | None:
    v = os.getenv(name)
    return v if v is not None and v != "" else default


def get_int(name: str, default: int) -> int:
    v = os.getenv(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError as e:
        raise ValueError(f"env var {name}={v!r} is not an integer") from e


def get_float(name: str, default: float) -> float:
    v = os.getenv(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError as e:
        raise ValueError(f"env var {name}={v!r} is not a number") from e


def get_bool(name: str, default: bool = False) -> bool:
    """Truthy iff set to a non-empty value that is not 0/false/no/off."""
    v = os.getenv(name)
    if v is None or v == "":
        return default
    return v.strip().lower() not in ("0", "false", "no", "off")


def get_str_aliased(name: str, alias: str, default: str | None = None):
    """get_str with a legacy alias read only when ``name`` is unset, so a
    stale alias never shadows a valid primary value (ENC_* takes NVENC_*)."""
    v = os.getenv(name)
    if v not in (None, ""):
        return v
    return get_str(alias, default)


def get_int_aliased(name: str, alias: str, default: int) -> int:
    """get_int with a lazy legacy alias (see get_str_aliased)."""
    if os.getenv(name) not in (None, ""):
        return get_int(name, default)
    return get_int(alias, default)


def warmup_frames() -> int:
    return get_int("WARMUP_FRAMES", 10)


def drop_frames() -> int:
    return get_int("DROP_FRAMES", 0)


def civitai_cache() -> str:
    return get_str("CIVITAI_CACHE") or "./models/civitai"


def perf_log_path(default: str) -> str:
    """PERF_LOG_PATH with the bench-banking semantics: unset -> the
    caller's default (the repo log); an EMPTY value -> ``""`` (banking
    disabled: the caller's own append-and-commit is the sole writer).
    Plain :func:`get_str` would collapse empty to the default and
    silently re-enable self-banking."""
    v = os.getenv("PERF_LOG_PATH")
    return default if v is None else v


def hw_encode() -> bool:
    return get_bool("HW_ENCODE", get_bool("NVENC", False))


def hw_decode() -> bool:
    return get_bool("HW_DECODE", get_bool("NVDEC", False))


def pipeline_depth() -> int:
    """Frames kept in flight on the device per track (PIPELINE_DEPTH); 1 is
    synchronous, more overlaps one frame's step with the next frame's
    readback at the cost of ``depth`` frames of latency."""
    return max(1, get_int("PIPELINE_DEPTH", 2))


def batchsched_enabled() -> bool:
    """The continuous cross-session batch scheduler (stream/scheduler.py) is
    the default single-device serving path; BATCHSCHED=0 serves every
    session through the one shared pipeline."""
    return get_bool("BATCHSCHED", True)


def slo_enabled() -> bool:
    """The stage-latency SLO plane (obs/slo.py); it rides the session
    tracers, so it also needs FLIGHT_RECORDER on."""
    return get_bool("SLO_ENABLE", True)


def devtel_enabled() -> bool:
    """The device telemetry plane (obs/devtel.py); DEVTEL_ENABLE=0 leaves
    its hooks one module-global read each."""
    return get_bool("DEVTEL_ENABLE", True)


def journey_enabled() -> bool:
    """The fleet journey plane (fleet/journey.py): the router mints an
    ``X-Journey-Id`` per placed session, keeps a bounded event ring per
    journey and serves incident bundles; ``JOURNEY_ENABLE=0`` removes it
    (no ids minted or forwarded, the debug endpoints 404, agents ignore
    the headers)."""
    return get_bool("JOURNEY_ENABLE", True)


def migrate_enabled() -> bool:
    """Live session migration: the agent's /migrate/export and
    /migrate/import and the router's ``drain?mode=migrate`` and crash
    restore; ``MIGRATE_ENABLE=0`` turns the whole surface off (the agent
    endpoints 404, the router refuses mode=migrate with 409)."""
    return get_bool("MIGRATE_ENABLE", True)


def broadcast_fanout_enabled() -> bool:
    """The broadcast TX plane (server/broadcast.py): WHEP viewers of a
    native-tier stream share one encode and one packetize and pay only a
    header rewrite, their SRTP (secure viewers) and a share of one
    ``sendmmsg`` burst each.  ``BROADCAST_FANOUT=0`` gives each viewer its
    own sink and sender pump."""
    return get_bool("BROADCAST_FANOUT", True)


def broadcast_max_viewers() -> int:
    """Viewers admitted per agent (``BROADCAST_MAX_VIEWERS``): /whep answers
    503 with Retry-After past it.  Viewers claim no engine slot, so this
    bounds the fan-out's host cost, not the device's.  0 = uncapped."""
    return max(0, get_int("BROADCAST_MAX_VIEWERS", 256))


def broadcast_edge_pull_enabled() -> bool:
    """The router's two-level fan-out (fleet/routing.py): a viewer placed
    on a non-owner agent first asks it to pull one copy of the publisher's
    stream (``POST /broadcast/pull``, 409 when the agent's fan-out or edge
    pull is off, and the viewer lands on the owner).
    ``BROADCAST_EDGE_PULL=0`` pins every viewer onto the owning agent."""
    return get_bool("BROADCAST_EDGE_PULL", True)


def adapter_dir() -> str | None:
    """The boot-time style-adapter catalog (ADAPTER_DIR): a directory of
    ``*.safetensors`` LoRA files (adapter name = file stem) served as
    per-session factor banks through the batch scheduler (adapters/).
    Unset (the default) keeps the factors path off: the stacked state
    carries no bank and the graph keys are an adapterless build's."""
    return get_str("ADAPTER_DIR")


def adapter_rank_buckets() -> tuple:
    """The rank buckets (ADAPTER_RANK_BUCKETS, e.g. "4,8,16"): every adapter
    is zero-padded to the smallest bucket that holds its rank, and the
    scheduler sizes its bank at the largest bucket in use, so every swap is
    a write of one shape into captured buffers.  An adapter above the
    largest bucket is refused, never truncated."""
    v = get_str("ADAPTER_RANK_BUCKETS")
    if not v:
        return (4, 8, 16)
    try:
        buckets = tuple(sorted(int(p) for p in v.split(",") if p.strip()))
    except ValueError as e:
        raise ValueError(f"ADAPTER_RANK_BUCKETS={v!r} is not comma-separated ints") from e
    if not buckets or any(b < 1 for b in buckets):
        raise ValueError(f"ADAPTER_RANK_BUCKETS={v!r}: buckets must be >= 1")
    return buckets


def mesh_shape() -> tuple:
    """(dp, tp, sp) serving-mesh axis sizes from MESH_SHAPE ("8,1,1" or
    "8x1x1"; trailing axes default to 1): the declarative alternative to
    the --tp/--sp flags that also carries the scheduler's dp axis.  Unset
    -> (1, 1, 1).  The JAX parsing and error texts."""
    v = get_str("MESH_SHAPE")
    if not v:
        return (1, 1, 1)
    parts = [p.strip() for p in v.replace("x", ",").split(",") if p.strip()]
    if len(parts) > 3:
        raise ValueError(f"MESH_SHAPE={v!r}: at most 3 axis sizes (dp,tp,sp)")
    try:
        sizes = [int(p) for p in parts]
    except ValueError as e:
        raise ValueError(f"MESH_SHAPE={v!r} is not integer axis sizes") from e
    if any(s < 1 for s in sizes):
        raise ValueError(f"MESH_SHAPE={v!r}: axis sizes must be >= 1")
    return tuple(sizes + [1] * (3 - len(sizes)))


def batchsched_dp() -> int:
    """dp shard count of the batch scheduler's session axis (BATCHSCHED_DP):
    the stacked [S, ...] state splits slot-major over this many devices,
    all driven by this one process.  0/1 (default) keeps the
    single-device scheduler.  Taken from MESH_SHAPE's dp component only
    when BATCHSCHED_DP is unset: an explicit 0/1 is the per-box kill
    switch even under a fleet-wide MESH_SHAPE."""
    if get_str("BATCHSCHED_DP") is not None:
        return max(1, get_int("BATCHSCHED_DP", 0))
    return max(1, mesh_shape()[0])


# ATTN_IMPL's values -> the port's attention routes (models/layers.py)
_ATTN_ROUTES = {"pallas": "kernel", "ring": "ring", "ulysses": "ulysses"}


def attn_impl() -> str:
    """The serving attention route from ATTN_IMPL: unset or ``pallas`` ->
    ``kernel`` (the hand-written flash-attention kernel), ``ring`` /
    ``ulysses`` -> the sequence-parallel routes over an sp group (their
    local case is the kernel too).  ``xla`` is refused: the JAX package's
    dense XLA route has no serving counterpart here, since on the card the
    port computes attention only through the kernel."""
    v = get_str("ATTN_IMPL")
    if v is None:
        return "kernel"
    if v == "xla":
        raise ValueError(
            "ATTN_IMPL='xla' is not served by the port: its one attention route on the card "
            "is the hand-written flash-attention kernel (ATTN_IMPL unset or pallas; ring or "
            "ulysses over an sp mesh)")
    if v not in _ATTN_ROUTES:
        raise ValueError(f"ATTN_IMPL={v!r} unknown (xla | pallas | ring | ulysses)")
    return _ATTN_ROUTES[v]


def dist_rank() -> int | None:
    """This process's rank in a torchrun world (RANK; None when unset)."""
    v = get_int("RANK", -1)
    return None if v < 0 else v


def dist_world_size() -> int | None:
    """The torchrun world's process count (WORLD_SIZE; None when unset)."""
    v = get_int("WORLD_SIZE", 0)
    return None if v <= 0 else v


def dist_local_rank() -> int:
    """This process's GPU on its host (LOCAL_RANK; 0 when unset)."""
    return get_int("LOCAL_RANK", 0)


def dist_master() -> tuple:
    """(MASTER_ADDR, MASTER_PORT) of a torchrun world: the rendezvous that
    rank 0 hosts (127.0.0.1 and None when unset)."""
    port = get_int("MASTER_PORT", 0)
    return get_str("MASTER_ADDR", "127.0.0.1"), (port or None)
