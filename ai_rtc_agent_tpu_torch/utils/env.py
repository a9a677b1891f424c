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
  MULTIPEER_BUCKETS                 --multipeer steps only the active slots (on)
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
