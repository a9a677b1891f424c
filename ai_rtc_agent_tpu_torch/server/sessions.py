"""The serving seam's session layer: publish, subscribe, offer, config and
close as plain async functions over an app-state mapping, with no HTTP.

The JAX agent keeps this logic inside its aiohttp handlers
(ai_rtc_agent_tpu/server/agent.py: ``offer``, ``whep``, ``whip``,
``update_config``, ``on_startup``, ``on_shutdown``); here it is split out so
that ``chip_smoke.py`` drives a whole session on the card, where aiohttp is
not installed, and ``server/agent.py`` maps HTTP requests onto it.

The app-state mapping (an aiohttp ``Application`` or a plain dict) holds
``model_id``, ``pipeline``, ``provider``, ``fbs``, ``mode``, ``unet_cache``, ``device``,
``multipeer``, ``multipeer_pipeline`` and ``batch_scheduler`` from
:func:`configure`, and after :func:`startup` also ``pcs`` (every live peer
connection), ``state`` (publishers, their tracks and relays, viewers),
``stats`` (FrameStats for /metrics) and ``stream_event_handler``.

Each flow returns a :class:`Reply` (status, body, content type, headers)
or raises ``ValueError`` for a client error (HTTP 400); any other
exception is a server error.  Every failure closes and drops the peer
connection it made.

Serving planes, as the JAX agent picks them: with ``--multipeer N`` each
connection claims a slot of the batched peer engine; otherwise, on the
default path, each connection claims a session of the continuous batch
scheduler (stream/scheduler.py), which steps every waiting session in one
step on the card (``--fbs`` N > 1: N consecutive frames of each session
in that step); with ``BATCHSCHED=0`` or an injected pipeline every
connection shares the one pipeline.  A full slot pool answers 503 with
``Retry-After``; closing a connection releases its slot.  Steps run in
worker threads or the planes' own threads; this layer adds no torch work
of its own (the pts wrap and fbs stacking are numpy).

The fault domain, on by the JAX agent's defaults:
* ``SUPERVISOR``: every video session rides a ``ResilientPipeline`` under
  its ``SessionSupervisor`` (a late or failed step degrades the stream to
  passthrough, the engine restarts in the background; StreamDegraded /
  StreamRecovered webhooks; ``health`` lists each session).
* ``OVERLOAD_CONTROL``: an ``OverloadControlPlane`` gates /offer and /whip
  (503 with Retry-After under pressure, a counted reservation per offer),
  walks each session down the shedding ladder, sheds stale frames at
  ingest, and reads the batch scheduler's amortised step latency.
* ``ENGINE_GUARD``: an ``EngineGuard`` over the batch scheduler (step
  deadline, quarantine, rebuild from the snapshot bank, evacuation;
  Engine* and AgentEvacuating webhooks).
``health``, ``capacity`` and ``drain`` are the bodies of /health,
/capacity and /drain.

With the native provider (server/rtc_native.py) the provider shares the
agent's FrameStats (decode/encode/glass stages at /metrics), each
session's RTCP feedback walks its network ladder (``NETADAPT``,
resilience/netadapt.py, joined to the overload ladder), ``/metrics``
carries each session's host-plane stage histograms
(``host_plane_sessions``) and ``/config {"encoder": ...}`` reconfigures
every live session's encoder.

Observability, on by the JAX agent's defaults (obs/):
* ``DEVTEL_ENABLE``: the device telemetry plane, activated before anything
  is built (every build of startup is a warmup build) and flipped to
  serving at the end of :func:`startup`; a serve-time breach lands in every
  live session's event log, the StreamDegraded webhook
  (``RETRACE_BREACH``) and ``retrace_breaches_total``.
* ``FLIGHT_RECORDER``: one recorder and one frame tracer per session (the
  track mints at ingest; the native tier at decode), the event log fed by
  the supervisor, the overload and network ladders and the webhooks, and
  a snapshot frozen at DEGRADED/FAILED whose id rides StreamDegraded.
* ``SLO_ENABLE`` (with the recorder): per-stage budgets, breaches as
  StreamDegraded ``SLO_BREACH``.
``debug_trace``, ``debug_flight`` and ``metrics_reply`` are the bodies of
/debug/trace, /debug/flight and /metrics (JSON or ``format=prom``), and
``health`` carries each session's ``slo`` and ``devtel`` views.

Sessions that move (the fleet tier, fleet/):
* **Journeys** (``JOURNEY_ENABLE``): the router's ``X-Journey-Id`` /
  ``X-Journey-Leg`` headers bind the session before its SDP exchange (the
  journey map, the flight recorder and its tracer, the supervisor's
  context, every webhook) and come back in the answer; ``debug_flight``
  answers ``?journey=`` with this agent's fragment.
* **Migration** (``MIGRATE_ENABLE``): ``migrate_export`` serialises one
  live session (the scheduler's snapshot, or a control-plane one; while
  the guard holds the plane quarantined, the bank), ``migrate_import``
  takes a counted admission reservation under the router's token,
  restores the snapshot into a slot and parks it; the client's re-offer
  carrying ``X-Migrated-Session`` adopts it and its reservation
  (``_admit_or_adopt``); an unadopted import expires with its reservation.
* **Restart in place** (``RECYCLE_ENABLE``): ``admin_recycle`` exports every
  live session into a handoff file (server/lifecycle.py), spawns the
  replacement and exits; a replacement started with ``RECYCLE_HANDOFF``
  parks each session at the end of :func:`startup`, after its buckets are
  captured and before it reports healthy, and announces it with an
  ``AGENT_RECYCLED`` webhook.  ``app["recycle_exit"]`` replaces the
  spawn-and-exit step (an in-process restart).

The broadcast fan-out (``BROADCAST_FANOUT``, server/broadcast.py): a WHEP
viewer on the native tier joins its publisher's ``BroadcastGroup`` (one
encode and one packetize for the audience, a header rewrite per viewer),
within ``BROADCAST_MAX_VIEWERS``; a viewer that cannot join is refused, and
the loopback provider's viewers keep their relayed views.
``broadcast_pull`` (``POST /broadcast/pull``) makes this agent an edge of
another's stream: one ``EdgePuller`` subscribed to the owner's /whep through
``app["transport"]`` feeds a local AU-mode group.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
import uuid
from dataclasses import dataclass, field

from .. import resolve_device
from ..aot.cache import inventory
from ..models import registry
from ..obs import devtel as obs_devtel
from ..obs import export as obs_export
from ..obs.promexport import CONTENT_TYPE, render
from ..obs.recorder import FlightRecorder
from ..obs.slo import SloPlane
from ..obs.trace import safe_list
from ..parallel.multipeer import CapacityError
from ..resilience.engine_guard import EngineGuard
from ..resilience.overload import OverloadControlPlane, QueueProbe, ShedFrame
from ..resilience.supervisor import ResilientPipeline, SessionSupervisor, worst_state
from ..stream.pipeline import StreamDiffusionPipeline
from ..utils import env
from ..utils.dispatch import spawn
from ..utils.profiling import FrameStats
from . import lifecycle, turn, wire
from .events import StreamEventHandler
from .relay import TrackRelay
from .signaling import get_provider
from .tracks import VideoStreamTrack

logger = logging.getLogger(__name__)


@dataclass
class Reply:
    status: int
    body: str | None = None
    content_type: str | None = None
    headers: dict = field(default_factory=dict)


class TimedPipeline:
    """Wraps a pipeline with per-frame fps/latency accounting (FrameStats).

    Forwards the submit/fetch surface when the pipeline has one, so the
    track keeps PIPELINE_DEPTH frames in flight; latency is submit -> fetch."""

    def __init__(self, pipeline, stats: FrameStats):
        self._pipeline = pipeline
        self._stats = stats
        if hasattr(pipeline, "submit"):
            self.submit = self._submit
            self.fetch = self._fetch
        if hasattr(pipeline, "submit_batch"):
            self.submit_batch = self._submit_batch
            self.fetch_batch = self._fetch_batch

    def __getattr__(self, name):
        # the rest of the surface (restart, the control plane,
        # owns_step_signal); the hot path is bound above
        if name == "_pipeline":
            raise AttributeError(name)
        return getattr(self._pipeline, name)

    @property
    def frame_buffer_size(self) -> int:
        return int(getattr(self._pipeline, "frame_buffer_size", 1) or 1)

    def __call__(self, frame):
        t0 = time.monotonic()
        out = self._pipeline(frame)
        if not isinstance(out, ShedFrame):  # a shed is no step: not a latency sample
            self._stats.record(time.monotonic() - t0)
        return out

    def _submit(self, frame):
        return self._pipeline.submit(frame), time.monotonic()

    def _fetch(self, handle, src_frame=None):
        inner, t_sub = handle
        out = self._pipeline.fetch(inner, src_frame)
        if not isinstance(out, ShedFrame):
            self._stats.record(time.monotonic() - t_sub)
        return out

    def _submit_batch(self, frames):
        return self._pipeline.submit_batch(frames), time.monotonic()

    def _fetch_batch(self, handle, src_frames=None):
        inner, t_sub = handle
        outs = self._pipeline.fetch_batch(inner, src_frames)
        dt = time.monotonic() - t_sub
        for o in outs:
            if not isinstance(o, ShedFrame):
                self._stats.record(dt)
        return outs


# -- runtime config (POST /config and the config datachannel) ------------------

def encoder_surface(provider):
    """The provider's runtime encoder-config surface
    (``validate_encoder_config``/``apply_encoder_config``: the native
    tier), or None when it has none (loopback, aiortc)."""
    if provider is not None and hasattr(provider, "apply_encoder_config"):
        return provider
    return None


def apply_runtime_config(pipeline, config: dict, encoders=None):
    """Apply a runtime config object to ``pipeline``: ``adapter``, ``prompt``,
    ``t_index_list``, ``guidance_scale``/``delta``, and ``encoder`` through
    ``encoders`` (:func:`encoder_surface`).  Every capability and value
    check runs before anything changes, so a ``ValueError`` means nothing
    was applied.  ``adapter`` is keyed by presence (JSON null clears the
    style; an absent key touches nothing), needs the pipeline's
    ``update_adapter`` (the batch scheduler's, and its sessions') and is
    applied first: the name is checked against the registry before any
    slot is written, so an unknown one refuses the whole body unapplied."""
    if not isinstance(config, dict):
        raise ValueError("config must be a JSON object")
    guidance_scale = config.get("guidance_scale")
    delta = config.get("delta")
    update_guidance = getattr(pipeline, "update_guidance", None)
    if guidance_scale is not None or delta is not None:
        if update_guidance is None:
            raise ValueError("guidance_scale/delta not supported by this pipeline")
        guidance_scale = None if guidance_scale is None else float(guidance_scale)
        delta = None if delta is None else float(delta)
    encoder = config.get("encoder")
    if encoder is not None:
        if encoders is None:
            raise ValueError("encoder reconfigure not supported by this provider")
        encoder = encoders.validate_encoder_config(encoder)
    has_adapter = "adapter" in config
    update_adapter = getattr(pipeline, "update_adapter", None)
    if has_adapter:
        if update_adapter is None:
            raise ValueError("adapter hot-swap not supported by this pipeline (the batch "
                             "scheduler with a bound adapter registry owns it)")
        adapter = config["adapter"]
        if adapter is not None and not isinstance(adapter, str):
            raise ValueError("adapter must be a string name or null")
        update_adapter(adapter)
    t_index_list = config.get("t_index_list")
    if t_index_list is not None:
        pipeline.update_t_index_list(t_index_list)
    prompt = config.get("prompt")
    if prompt is not None:
        pipeline.update_prompt(prompt)
    if guidance_scale is not None or delta is not None:
        update_guidance(guidance_scale=guidance_scale, delta=delta)
    if encoder is not None:
        encoders.apply_encoder_config(encoder)


def wire_datachannel(pipeline, channel, guard=None, encoders=None):
    """Config messages on ``channel`` reach ``pipeline`` (off the loop: a
    prompt update runs the text encoder); a bad message is logged."""

    @channel.on("message")
    async def on_message(message):
        if guard is not None and not guard():
            return
        logger.info("received config: %s", message)
        try:
            await asyncio.to_thread(apply_runtime_config, pipeline, json.loads(message), encoders)
        except (ValueError, KeyError, TypeError) as e:
            logger.error("bad config message: %s", e)


# -- lifecycle -------------------------------------------------------------------

def configure(app, model_id: str = "stabilityai/sd-turbo", pipeline=None, provider=None,
              fbs: int = 0, device=None, multipeer: int = 0, multipeer_pipeline=None,
              batch_scheduler=None, events_handler=None, transport=None,
              mode: str = "img2img", unet_cache: int = 0, controlnet: str | None = None,
              annotator: str | None = None, tp: int = 0, sp: int = 0):
    """Fill the app state's configuration.  ``pipeline=None`` builds the
    port's StreamDiffusionPipeline at :func:`startup`, and the batch
    scheduler over it; ``multipeer`` N > 0 builds the N-slot peer engine
    instead.  ``pipeline``, ``multipeer_pipeline`` and ``batch_scheduler``
    are injectable (tests), and so is ``events_handler``, the webhook
    sender (a ``StreamEventHandler`` that posts elsewhere than aiohttp).
    ``transport`` (fleet/transport.py): how this agent reaches other
    agents (the edge pull); None: HTTP through aiohttp, made at first use.
    ``unet_cache`` N >= 2: the DeepCache interval (``--unet-cache``).
    ``controlnet`` (a model id or a snapshot dir) and ``annotator`` (canny,
    hed or identity): the ControlNet every serving plane conditions on
    (``--controlnet``, ``--annotator``; an annotator without a ControlNet
    is refused at :func:`startup`).  ``tp``/``sp`` (``--tp``/``--sp``; 0 or 1
    off, MESH_SHAPE's axes when unset): the serving mesh of
    :func:`serving_mesh`."""
    app["model_id"] = model_id
    app["tp"] = tp
    app["sp"] = sp
    app["controlnet"] = controlnet
    app["annotator"] = annotator
    app["pipeline"] = pipeline
    app["provider"] = provider or get_provider()
    app["fbs"] = fbs
    app["mode"] = mode
    app["unet_cache"] = unet_cache
    app["device"] = device
    app["multipeer"] = multipeer
    app["multipeer_pipeline"] = multipeer_pipeline
    app["batch_scheduler"] = batch_scheduler
    app["events_handler"] = events_handler
    app["transport"] = transport
    app["owns_transport"] = False
    # the fleet journey binding of each session (JOURNEY_ENABLE=0: the
    # router's headers are ignored)
    app["journey_enabled"] = env.journey_enabled()
    app["journey_map"] = {}
    # migrated-in sessions parked until the client's re-offer adopts them
    app["imported_sessions"] = {}
    app["importing_tokens"] = set()
    app["import_timers"] = {}  # token -> the expiry timer of its parked import
    # the process nonce on /capacity: the fleet registry tells a recycled
    # replacement from the process it replaced by it
    app["boot_id"] = uuid.uuid4().hex[:12]
    app["recycling"] = False
    app["recycle_tasks"] = set()
    app["recycle_exit"] = None  # None: spawn the replacement, then exit the process


def stream_config(app, device):
    """The served stream config: the family's default with the agent's
    flags (``--fbs`` N > 1, ``--unet-cache`` N >= 2, ``--mode``,
    ``--annotator``, and ControlNet on with ``--controlnet``), for both
    serving modes (no silent flag drops); None (the family's default,
    UNET_CACHE and all; ControlNet on when the plane is given one) without
    any."""
    overrides = {}
    if app.get("fbs", 0) > 1:
        overrides["frame_buffer_size"] = app["fbs"]
    if app.get("unet_cache", 0) >= 2:
        overrides["unet_cache_interval"] = app["unet_cache"]
    if app.get("mode", "img2img") != "img2img":
        overrides["mode"] = app["mode"]
    if app.get("annotator"):
        overrides["annotator"] = app["annotator"]
    if app.get("sp", 0) > 1 and env.attn_impl() not in ("ring", "ulysses"):
        # an sp mesh shards the tokens only through the sp routes: any other
        # route would compute whole on every rank of an N-rank mesh
        overrides["attn_impl"] = "ring"
        logger.warning(
            "--sp %d: attention impl defaulted to 'ring' so the sequence axis shards over the "
            "sp mesh (set ATTN_IMPL=ring|ulysses to choose explicitly)", app["sp"])
    if not overrides:
        return None
    if app.get("controlnet"):
        overrides["use_controlnet"] = True
    return registry.default_stream_config(app["model_id"], device=device, **overrides)


def build_pipeline(app, mesh=None) -> StreamDiffusionPipeline:
    """The served pipeline, on the card unless the app's ``device`` says
    otherwise (raises without one: the server never carries on on the CPU),
    on the tp/sp ``mesh`` of :func:`serving_mesh` when there is one."""
    dev = resolve_device(app["device"])
    return StreamDiffusionPipeline(app["model_id"], config=stream_config(app, dev), device=dev,
                                   controlnet=app.get("controlnet"), mesh=mesh)


def serving_mesh(app):
    """The tp/sp serving mesh over the world's ranks (the JAX agent's
    wiring), or None: ``--tp``/``--sp``, MESH_SHAPE's tp and sp where they
    are unset.  Every rank of the world calls it (``make_mesh`` is
    collective), which raises when the mesh asks for more ranks than the
    world has; a world larger than the mesh is refused too.  A declared dp
    is ignored, with the JAX warning: a tp/sp mesh keeps the shared-engine
    path, which has no session axis."""
    from ..parallel import mesh as M

    _, mesh_tp, mesh_sp = env.mesh_shape()
    tp = app.get("tp", 0) or mesh_tp
    sp = app.get("sp", 0) or mesh_sp
    want, world = max(1, tp) * max(1, sp), M.host_count()
    if want == 1 and world == 1:
        return None
    mesh = M.make_mesh(tp=max(1, tp), sp=max(1, sp))
    if world > want:
        raise ValueError(f"a world of {world} ranks serves a tp*sp={want} mesh: start {want} "
                         f"(torchrun --nproc-per-node {want})")
    if env.batchsched_dp() > 1:
        logger.warning(
            "MESH_SHAPE/BATCHSCHED_DP dp=%d IGNORED: tp=%d/sp=%d route serving through the "
            "shared-engine mesh path, which does not shard the session axis — drop the tp/sp "
            "axes to use the dp-sharded scheduler", env.batchsched_dp(), tp, sp)
    return mesh


def load_adapters(pipeline):
    """The ADAPTER_DIR style catalog resolved against ``pipeline``'s served
    UNet (w8 params included), or None when ADAPTER_DIR is unset.  A bad
    catalog raises with the file's name: the agent refuses to boot rather
    than serve the shared pipeline without styles."""
    adir = env.adapter_dir()
    if not adir:
        return None
    from ..adapters import build_registry

    if not os.path.isdir(adir):
        raise ValueError(f"ADAPTER_DIR {adir} is not a directory")
    return build_registry(pipeline.engine.params["unet"], pipeline.bundle.unet_cfg, adir)


async def startup(app):
    """Build the serving plane (see the module docstring), the fault domain
    and the observability planes over it, on the running loop.  A plane
    that cannot be built raises: the agent never serves another one
    instead."""
    # device telemetry first: every build of startup is then a warmup build
    app["devtel"] = None
    if env.devtel_enabled():
        app["devtel"] = obs_devtel.activate(obs_devtel.DevTelPlane())
    if app.get("annotator") and not app.get("controlnet"):
        raise ValueError("--annotator requires --controlnet")
    if app["multipeer"] and app["multipeer_pipeline"] is None:
        from .multipeer_serving import MultiPeerPipeline

        if app["fbs"] > 1:
            raise ValueError(
                "--fbs is not supported with --multipeer (peers are already the batch dimension)"
            )
        dev = resolve_device(app["device"])
        app["multipeer_pipeline"] = MultiPeerPipeline(
            app["model_id"], max_peers=app["multipeer"], device=dev,
            config=stream_config(app, dev), controlnet=app.get("controlnet"),
        )
    elif app["pipeline"] is None and app["multipeer_pipeline"] is None:
        mesh = serving_mesh(app)
        app["pipeline"] = build_pipeline(app, mesh)
        # a tp/sp mesh keeps the shared pipeline (those axes shard the model,
        # not the sessions); otherwise the scheduler, on BATCHSCHED_DP shards
        if mesh is None and app["batch_scheduler"] is None and env.batchsched_enabled():
            from ..stream.scheduler import BatchScheduler

            app["batch_scheduler"] = BatchScheduler.from_pipeline(
                app["pipeline"], dp=env.batchsched_dp(), adapters=load_adapters(app["pipeline"]))
    app["pcs"] = set()
    app["releasing"] = set()  # slot releases in flight
    app["stream_event_handler"] = app["events_handler"] or StreamEventHandler()
    app["state"] = {
        "source_track": None,  # the newest live publisher's processed track
        "source_relay": None,  # and its relay, which viewers subscribe to
        "whip_pcs": {},
        "whip_tracks": {},
        "whip_relays": {},
        "whep_pcs": {},
        "broadcast_groups": {},  # publisher session id (or "edge") -> BroadcastGroup
        "edge_puller": None,  # this agent's pull of another's stream (/broadcast/pull)
    }
    app["stats"] = FrameStats()
    if hasattr(app["provider"], "attach_stats"):
        # the media plane's decode/encode/glass stages land beside the
        # submit -> fetch latency at /metrics
        app["provider"].attach_stats(app["stats"])
    app["supervisors"] = {}
    _start_observability(app)
    if app["slo"] is not None:
        await app["slo"].start()
    app["overload"] = None
    if env.get_bool("OVERLOAD_CONTROL", True):
        app["overload"] = OverloadControlPlane(app["stats"])
        flight = app["flight"]
        if flight is not None:

            def overload_event(session_key, kind, **data):
                rec = flight.session(session_key)
                if rec is not None:
                    rec.event(kind, **data)

            app["overload"].on_event = overload_event
        await app["overload"].start()
    sched = app["batch_scheduler"]
    if sched is not None and app["flight"] is not None and hasattr(sched, "tracer"):
        # the dispatcher's spans ride the recorder's trace window (/debug/trace)
        sched.tracer = app["flight"].steps
    if sched is not None and app["overload"] is not None:
        # the admission EWMA reads the step's cost per session (dt / occupancy)
        admission = app["overload"].admission
        sched.on_step = lambda dt_s, occ: admission.note_step_latency(dt_s)
    app["engine_guard"] = None
    if sched is not None and hasattr(sched, "attach_guard") and env.get_bool("ENGINE_GUARD", True):
        loop = asyncio.get_running_loop()
        handler = app["stream_event_handler"]

        def engine_transition(event_name, info):
            extra = {k: v for k, v in info.items() if k not in ("state", "reason")}
            # guard trips and rebuilds happen off the loop
            _call_on_loop(loop, lambda: handler.handle_engine_state(
                event_name, info.get("state", ""), reason=str(info.get("reason", "")), **extra))

        app["engine_guard"] = EngineGuard(sched, on_transition=engine_transition,
                                          on_exhausted=lambda: evacuate_agent(app))
    plane = app["devtel"]
    if plane is not None:
        plane.device = _serving_device(app)
        # the graph caches built before the plane (an injected plane) count too
        plane.set_aot_inventory(*inventory())
        if app["overload"] is not None:
            # the memory sample rides the ladder's tick (rate-limited there)
            app["overload"].on_tick = plane.sample_memory
        # startup is done: a build from here on that no expected scope
        # blesses is a serve-time breach
        plane.serving()
    # a recycled replacement adopts its predecessor's handoff last: the
    # planes exist, and the agent reports healthy only after it
    await import_handoff(app)


def _serving_device(app):
    """The serving plane's device (None for an injected plane without one)."""
    for plane in (app["batch_scheduler"], app["multipeer_pipeline"], app["pipeline"]):
        dev = getattr(plane, "device", None)
        if getattr(dev, "type", None) is not None:
            return dev
    return None


def _call_on_loop(loop, fn):
    """Run ``fn`` on ``loop`` from any thread (webhooks belong on the loop)."""
    try:
        loop.call_soon_threadsafe(fn)
    except RuntimeError:
        pass  # the loop closed (teardown)


def _start_observability(app):
    """The SLO plane, the flight recorder and the device telemetry's breach
    fan-out, as the JAX agent wires them (the SLO plane first, so that every
    session tracer is born with its feed)."""
    loop = asyncio.get_running_loop()
    handler: StreamEventHandler = app["stream_event_handler"]
    recorder_on = env.get_bool("FLIGHT_RECORDER", True)
    plane = app["devtel"]
    if plane is not None:
        plane.stats = app["stats"]  # breaches land as retrace_breaches_total
    app["slo"] = None
    if env.slo_enabled() and recorder_on:
        app["slo"] = SloPlane(stats=app["stats"])

        def slo_breach(session_key, stage, state, info):
            flight = app.get("flight")
            rec = flight.session(session_key) if flight is not None else None
            if rec is not None:
                rec.event("slo", stage=stage, state=state, **info)
            if state != "breach":
                return
            recent = rec.recent_events() if rec is not None else None
            reason = (f"slo breach: {stage} over {info['budget_ms']}ms budget "
                      f"(burn fast={info['burn_fast']} slow={info['burn_slow']})")
            journey = journey_of(app, session_key)
            _call_on_loop(loop, lambda: handler.handle_session_state(
                session_key, "", "SLO_BREACH", reason, recent_events=recent, journey=journey))

        app["slo"].on_breach = slo_breach
    app["flight"] = None
    if recorder_on:
        flight = app["flight"] = FlightRecorder(stats=app["stats"], slo=app["slo"])

        def webhook_emitted(event_name, stream_id):
            rec = flight.session(stream_id)
            if rec is not None:
                rec.event("webhook", event=event_name)

        handler.on_emit = webhook_emitted
    if plane is not None:

        def retrace_breach(info):
            # the capture froze every live session: each black box hears it
            flight = app.get("flight")
            if flight is not None:
                for rec in list(flight.sessions.values()):
                    rec.event("retrace", **info)
            reason = (f"serve-time retrace: {info['context']} compiled "
                      f"{info['duration_ms']}ms after prewarm completed")
            _call_on_loop(loop, lambda: handler.handle_session_state(
                "device-telemetry", "", "RETRACE_BREACH", reason))

        plane.on_breach = retrace_breach


def evacuate_agent(app):
    """Self-evacuation when the guard's rebuild is exhausted: POST
    ``{"agent", "reason"}`` to ``EVACUATE_URL`` (the fleet router's
    /fleet/evacuate) with the bearer token, from the guard's thread,
    stdlib HTTP (the loop may be wedged too).  No URL: nothing to do (a
    standalone agent)."""
    url = env.get_str("EVACUATE_URL")
    if not url:
        return
    import urllib.request

    guard = app.get("engine_guard")
    payload = json.dumps({
        "agent": env.get_str("WORKER_ID") or "",
        "reason": (guard.last_trip_reason or "") if guard else "",
    }).encode("utf-8")
    headers = {"Content-Type": "application/json"}
    token = env.get_str("AUTH_TOKEN")
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(url, data=payload, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=10.0) as resp:
            logger.warning("self-evacuation accepted by router (%d)", resp.status)
    except Exception:
        logger.exception("self-evacuation POST failed (%s)", url)


async def shutdown(app):
    for task in list(app["recycle_tasks"]):
        task.cancel()
    if app["devtel"] is not None:
        obs_devtel.deactivate(app["devtel"])
    if app["slo"] is not None:
        app["slo"].stop()
    ov = app["overload"]
    if ov is not None:
        ov.stop()
    for sup in app["supervisors"].values():
        sup.stop()
    app["supervisors"].clear()
    pcs = app["pcs"]
    await asyncio.gather(*[pc.close() for pc in pcs])
    pcs.clear()
    for relay in app["state"]["whip_relays"].values():
        relay.stop()
    puller = app["state"]["edge_puller"]
    if puller is not None:
        await puller.close()
    groups = app["state"]["broadcast_groups"]
    await asyncio.gather(*[g.close() for g in groups.values()])
    groups.clear()
    if app["owns_transport"]:
        await app["transport"].close()
    await asyncio.gather(*app["releasing"])
    for timer in app["import_timers"].values():
        timer.cancel()
    app["import_timers"].clear()
    for entry in app["imported_sessions"].values():
        # unadopted migrated-in sessions die with the scheduler
        sess = entry.get("session")
        if sess is not None:
            try:
                sess.release()
            except Exception:
                logger.exception("releasing an imported session failed")
    app["imported_sessions"].clear()
    if app["engine_guard"] is not None:
        app["engine_guard"].close()
    for plane in (app["multipeer_pipeline"], app["batch_scheduler"]):
        if plane is not None:
            plane.close()
    close = getattr(getattr(app["pipeline"], "engine", None), "close", None)
    if close is not None:  # a lockstep engine: the other ranks stop following
        close()


def metrics(app) -> dict:
    """FrameStats, the native provider's per-session host-plane stages
    (``host_plane_sessions``), the overload plane, the batch scheduler's
    ``batchsched_*`` gauges, the engine guard's counters, the flight
    recorder's, the SLO plane's and the device telemetry's gauges (the
    cached memory sample: never a device probe per scrape), the broadcast
    plane's (``broadcast``, ``broadcast_sessions``)."""
    out = app["stats"].snapshot()
    snapshot = getattr(app["provider"], "host_plane_snapshot", None)
    if snapshot is not None:
        out["host_plane_sessions"] = snapshot()
    ov = app["overload"]
    if ov is not None:
        if app["multipeer_pipeline"] is not None:
            out["overload_peer_frames_shed"] = app["multipeer_pipeline"].frames_shed
        out.update(ov.snapshot())
    if app["batch_scheduler"] is not None:
        out.update(app["batch_scheduler"].snapshot())
    if app["engine_guard"] is not None:
        out.update(app["engine_guard"].snapshot())
    flight = app["flight"]
    if flight is not None:
        out["trace_enabled"] = int(flight.controller.active())
        out["flight_sessions"] = len(flight.sessions)
        out["flight_snapshots_stored"] = len(flight.snapshots)
    if app["slo"] is not None:
        out.update(app["slo"].snapshot())
    if app["devtel"] is not None:
        out.update(app["devtel"].snapshot())
    # the broadcast plane: the audience's gauges, and each group's snapshot
    # with its stage histograms (keyed by publisher, never by viewer)
    out["broadcast"] = broadcast_gauges(app)
    bsessions = {}
    for sid, g in app["state"]["broadcast_groups"].items():
        if not g.closed:
            bsessions[sid] = {**g.snapshot(), **g.stats.stage_snapshot_us()}
    if bsessions:
        out["broadcast_sessions"] = bsessions
    return out


def metrics_reply(app, fmt: str = "json") -> Reply:
    """/metrics: the :func:`metrics` dict as JSON, or with ``format=prom``
    the Prometheus text exposition (the same scalars and the SLO plane's
    stage histograms); 400 for another format."""
    out = metrics(app)
    if fmt == "prom":
        return Reply(200, render(out, slo=app["slo"]), None, {"Content-Type": CONTENT_TYPE})
    if fmt != "json":
        return Reply(400, f"unknown format {fmt!r}")
    return Reply(200, json.dumps(out), "application/json")


def health(app) -> dict:
    """/health: the worst live session state and each session's supervisor
    snapshot, with its ladder rungs and scheduler view; the overload and
    engine planes."""
    sessions = {k: sup.snapshot() for k, sup in app["supervisors"].items()}
    ov = app["overload"]
    if ov is not None:
        for k, ladder in ov.ladders.items():
            if k in sessions:
                sessions[k]["overload_rung"] = ladder.rung
                sessions[k]["effective_rung"] = ladder.effective_rung
        for k, na in ov.netadapt.items():
            if k in sessions:
                sessions[k]["netadapt"] = na.snapshot()
    sched = app["batch_scheduler"]
    if sched is not None:
        for k, snap in sched.session_snapshots().items():
            if k in sessions:
                sessions[k]["batchsched"] = snap
    slo_plane = app["slo"]
    if slo_plane is not None:
        for k in sessions:
            snap = slo_plane.session_snapshot(k)
            if snap is not None:
                sessions[k]["slo"] = snap
    plane = app["devtel"]
    if plane is not None:
        # a serve-time capture freezes every live session: each carries it
        view = plane.session_view()
        for k in sessions:
            sessions[k]["devtel"] = view
    body = {"status": worst_state(s["state"] for s in sessions.values()), "sessions": sessions}
    # the audience beside the sessions: a publisher can be at its viewer
    # cap with no engine pressure
    body["broadcast"] = broadcast_gauges(app)
    if ov is not None:
        body["overload"] = {"pressure": round(ov.admission.pressure(), 4),
                            "frozen": ov.admission.frozen, "draining": ov.draining}
    if plane is not None:
        body["devtel"] = plane.health()
    guard = app["engine_guard"]
    if guard is not None:
        body["engine"] = guard.health()
    return body


def capacity(app) -> dict:
    """/capacity: the sessions this agent still admits (-1: no structural
    bound), whether admission refuses now, and the Retry-After hint."""
    mp, sched = app["multipeer_pipeline"], app["batch_scheduler"]
    free = mp.free_slots if mp is not None else sched.free_slots if sched is not None else None
    ov = app["overload"]
    if ov is None:
        body = {"capacity": free if free is not None else -1, "saturated": free == 0,
                "retry_after_s": 0.0}
    else:
        body = ov.capacity(free_slots=free)
    body["boot_id"] = app["boot_id"]
    # viewers are a pool of their own: a broadcast viewer claims no slot
    body["broadcast"] = broadcast_gauges(app)
    guard = app["engine_guard"]
    if guard is not None and guard.quarantined:
        body["saturated"] = True
        body["retry_after_s"] = guard.retry_after_s()
    if guard is not None:
        body["engine"] = guard.health()
    return body


def drain(app, body) -> Reply:
    """/drain: ``{"action": "freeze"}`` holds the admission freeze (new
    sessions 503, live ones untouched), ``unfreeze`` releases it; 409
    without the overload plane."""
    ov = app["overload"]
    if ov is None:
        return Reply(409, "overload control disabled — no admission-freeze rung to drain with")
    action = body.get("action") if isinstance(body, dict) else None
    if action not in ("freeze", "unfreeze"):
        return Reply(400, "action must be freeze|unfreeze")
    changed = ov.begin_drain() if action == "freeze" else ov.end_drain()
    return Reply(200, json.dumps({"draining": ov.draining, "changed": changed,
                                  "live_sessions": len(app["supervisors"])}),
                 "application/json")


# -- the debug surface (/debug/trace, /debug/flight) -----------------------------------

DEMO_PAGE = os.path.join(os.path.dirname(__file__), "static", "demo.html")


def demo() -> Reply:
    """GET /demo: the bundled browser client for /offer; 404 when the page
    is not bundled."""
    if not os.path.exists(DEMO_PAGE):
        return Reply(404, "demo page not bundled")
    with open(DEMO_PAGE, encoding="utf-8") as f:
        return Reply(200, f.read(), "text/html")


def _debug_error(status: int, message: str) -> Reply:
    """The debug surface's errors are JSON bodies (tooling reads them)."""
    return Reply(status, json.dumps({"error": message}), "application/json")


def _json(body) -> Reply:
    return Reply(200, json.dumps(body), "application/json")


async def debug_trace(app, body=None) -> Reply:
    """/debug/trace: ``body=None`` is the GET (the trace window's status);
    a POST body ``{"action": "start", "duration_s": 30, "jax_profiler_dir":
    DIR}`` opens a window (capped at TRACE_MAX_CAPTURE_S) and, with a
    directory, the torch.profiler bridge over it (obs/export.py; its Chrome
    trace lands in DIR at stop), ``{"action": "stop"}`` closes both.  The
    bridge starts and stops off the loop.  404 without the recorder."""
    flight = app["flight"]
    if flight is None:
        return Reply(404, "flight recorder disabled")
    if body is None:
        return _json(flight.controller.status())
    action = body.get("action") if isinstance(body, dict) else None
    if action == "start":
        duration = body.get("duration_s")
        if duration is not None:
            try:
                duration = float(duration)
            except (TypeError, ValueError):
                return Reply(400, "duration_s must be a number")
        granted = flight.controller.start(duration)
        out = {"tracing": True, "duration_s": round(granted, 3)}
        log_dir = body.get("jax_profiler_dir")
        if log_dir:
            err = await asyncio.to_thread(obs_export.start_profiler_bridge, log_dir)
            out["jax_profiler"] = err or f"tracing to {log_dir}"
        return _json(out)
    if action == "stop":
        flight.controller.stop()
        err = await asyncio.to_thread(obs_export.stop_profiler_bridge)
        out = {"tracing": False}
        if err:
            out["jax_profiler"] = err
        return _json(out)
    return Reply(400, "action must be start|stop")


def debug_flight(app, query: dict) -> Reply:
    """/debug/flight: no query, the index (sessions, snapshots); ``session=``
    a live capture; ``id=`` a stored snapshot; ``journey=`` this agent's
    fragment of a fleet journey (404 when no session or snapshot carries
    it); ``format=json|chrome|jsonl`` renders a capture.  Bad
    queries answer 400, unknown ids 404, both with a JSON error."""
    flight = app["flight"]
    if flight is None:
        return _debug_error(404, "flight recorder disabled")
    unknown = sorted(k for k in query if k not in ("id", "session", "format", "journey"))
    if unknown:
        return _debug_error(400, f"unknown query param(s): {', '.join(unknown)}")
    fmt = query.get("format", "json")
    if fmt not in ("json", "chrome", "jsonl"):
        return _debug_error(400, f"unknown format {fmt!r}")
    if "journey" in query:
        if "id" in query or "session" in query:
            return _debug_error(400, "journey= is a selector of its own — drop id=/session=")
        if fmt != "json":
            return _debug_error(
                400, "journey fragments are JSON — the router's /fleet/debug/journey "
                     "endpoint renders the merged chrome trace")
        return _journey_fragment(app, flight, query["journey"])
    if "id" in query:
        snap = flight.get_snapshot(query["id"])
        if snap is None:
            return _debug_error(404, f"unknown snapshot {query['id']!r}")
    elif "session" in query:
        rec = flight.session(query["session"])
        if rec is None:
            return _debug_error(404, f"unknown session {query['session']!r}")
        snap = rec.snapshot(reason="on-demand")
    else:
        if fmt != "json":
            return _debug_error(400, "format= applies to a capture — pass id= or session=")
        return _json(flight.index())
    if fmt == "chrome":
        # on the last profiler bridge window's time base once there is one
        return _json(obs_export.to_chrome_trace(snap, clock=obs_export.last_clock))
    if fmt == "jsonl":
        return Reply(200, obs_export.to_jsonl(snap), "application/x-ndjson")
    return _json(snap)


def _journey_fragment(app, flight, journey_id: str) -> Reply:
    """This agent's share of a fleet journey: live captures of its sessions,
    stored snapshots that carry it, the device telemetry's fragment; 404
    when nothing here carries it."""
    captures = {sid: rec.snapshot(reason="journey-pull")
                for sid, rec in list(flight.sessions.items())
                if (rec.journey or {}).get("journey_id") == journey_id}
    snapshots = [snap for snap in safe_list(flight.snapshots)
                 if (snap.get("journey") or {}).get("journey_id") == journey_id]
    if not captures and not snapshots:
        return _debug_error(404, f"no records for journey {journey_id!r} on this agent")
    fragment = {"agent": env.get_str("WORKER_ID") or "", "journey_id": journey_id,
                "sessions": captures, "snapshots": snapshots}
    if app["devtel"] is not None:
        fragment["devtel"] = app["devtel"].fragment()
    return _json(fragment)


async def update_config(app, config):
    """POST /config, off the loop: every multipeer slot, else every live
    scheduler session and the scheduler's defaults for future ones, else
    the shared pipeline."""
    target = app["multipeer_pipeline"] or app["batch_scheduler"] or app["pipeline"]
    try:
        await asyncio.to_thread(apply_runtime_config, target, config,
                                encoder_surface(app["provider"]))
    except (TypeError, KeyError) as e:  # structurally wrong JSON
        raise ValueError(str(e)) from e


# -- admission and supervision ---------------------------------------------------------

def overloaded(app, text: str = "overloaded", retry_after: float | None = None) -> Reply:
    """503 with a Retry-After scaled to the live pressure (or the value the
    refusing gate computed)."""
    if retry_after is None:
        ov = app["overload"]
        retry_after = ov.admission.retry_after_s() if ov is not None else 2.0
    return Reply(503, text, None, {wire.RETRY_AFTER: str(max(1, int(round(retry_after))))})


def admission_gate(app, session_key: str) -> Reply | None:
    """Refuse a new session before it claims anything: the guard is
    quarantined, or the overload plane says the agent cannot hold one more.
    Admitting reserves the session's place until its supervision registers
    (or :func:`release_admission` cancels it).  None: admitted."""
    guard = app["engine_guard"]
    if guard is not None and guard.quarantined:
        return overloaded(app, "engine quarantined", guard.retry_after_s())
    ov = app["overload"]
    if ov is None:
        return None
    ok, retry_after = ov.admission_gate(key=session_key)
    return None if ok else overloaded(app, retry_after=retry_after)


def release_admission(app, session_key: str):
    if app["overload"] is not None:
        app["overload"].release_admission(session_key)


def _slots_full(app) -> Reply:
    """503 naming the slot pool that refused (the JAX agent's text)."""
    return overloaded(app, "all peer slots in use" if app["multipeer_pipeline"] is not None
                      else "all batch-scheduler session slots in use")


def supervise(app, pc, pipeline, session_key: str, room_id: str = ""):
    """``pipeline`` under a SessionSupervisor (on the running loop: its
    output-age watchdog starts there) and the session's overload ladder;
    the pipeline as it is with ``SUPERVISOR=0``."""
    if not env.get_bool("SUPERVISOR", True):
        return pipeline
    stats: FrameStats = app["stats"]
    handler: StreamEventHandler = app["stream_event_handler"]
    loop = asyncio.get_running_loop()
    flight = app["flight"]
    rec = flight.register(session_key) if flight is not None else None

    def resync():
        # a keyframe after recovery: our encoder's IDR and the publisher's
        force = getattr(pc, "_force_sink_keyframe", None)
        if force is not None:
            force()
        proto = getattr(pc, "_recv_protocol", None)
        if proto is not None:
            proto._send_pli()

    def on_transition(old, new, reason):
        # tpurtc: allow[metrics-registry] -- closed enum: new is one of the 4 supervisor states (resilience/supervisor.py), keys supervisor_{healthy,degraded,recovering,failed}_total
        stats.count(f"supervisor_{new.lower()}")
        snap_id = recent = None
        if rec is not None:
            rec.event("supervisor", old=old, new=new, reason=reason)
            if new in ("DEGRADED", "FAILED"):
                # the black box freezes now, before recovery churns the
                # rings; the snapshot's id rides the StreamDegraded webhook
                snap_id = flight.take_snapshot(session_key, reason=f"{new}: {reason}")
            recent = rec.recent_events()
        journey = journey_of(app, session_key)
        # may fire on a worker thread: webhooks belong on the loop
        _call_on_loop(loop, lambda: handler.handle_session_state(
            session_key, room_id, new, reason, flight_snapshot_id=snap_id,
            recent_events=recent, journey=journey))

    sup = SessionSupervisor(session_key, resync=resync, on_transition=on_transition)
    # the recycle handoff's AGENT_RECYCLED announce needs each session's room
    sup.context["room_id"] = room_id
    jmeta = journey_of(app, session_key)
    if jmeta is not None:
        sup.context["journey"] = jmeta  # /health shows which journey this is a leg of
    if rec is not None:
        sup.on_event = rec.event  # restart attempts and outcomes -> the event log
    wrapped = ResilientPipeline(pipeline, sup)
    ov = app["overload"]
    if ov is not None:
        wrapped.throttle = ov.register_session(session_key, sup)
        # the network ladder, registered after the compute ladder so that
        # its frame-skip floor joins it; providers without RTCP (loopback,
        # aiortc) never feed it
        na = ov.register_netadapt(session_key)
        attach = getattr(pc, "attach_netadapt", None)
        if na is not None and attach is not None:
            attach(na)
    app["supervisors"][session_key] = sup
    sup.start_watchdog()
    return wrapped


def register_ingest_queue(app, session_key: str, track):
    """The session's source queue at /metrics (the loopback track has one)."""
    src_q = getattr(track, "_q", None)
    if app["overload"] is not None and src_q is not None:
        app["overload"].register_queue(f"ingest:{session_key}", QueueProbe(src_q))


def session_tracer(app, session_key: str, src_track=None):
    """The session's frame tracer, registered with the flight recorder; None
    without the recorder.  A native-tier source (``H264RingSource``) gets
    it too, so that its frames' ids mint at decode."""
    flight = app["flight"]
    if flight is None:
        return None
    tracer = flight.register(session_key).tracer
    if src_track is not None and hasattr(src_track, "tracer"):
        src_track.tracer = tracer
    return tracer


def end_supervision(app, session_key: str):
    sup = app["supervisors"].pop(session_key, None)
    app["journey_map"].pop(session_key, None)
    if sup is not None:
        sup.stop()
    if app["overload"] is not None:
        app["overload"].unregister_session(session_key)
    if app["flight"] is not None:
        # the live rings go with the session; stored snapshots stay
        app["flight"].unregister(session_key)


def _release_off_loop(app, sess):
    """``sess.release()`` on a worker thread, awaited at shutdown."""
    releasing = app["releasing"]
    task = asyncio.ensure_future(asyncio.to_thread(sess.release))
    releasing.add(task)
    task.add_done_callback(releasing.discard)


async def claim_pipeline(app, session_key: str, imported=None):
    """-> (pipeline, release) for a new connection: a multipeer slot, a
    scheduler session or the shared pipeline; (None, None) when the slots
    are full.  The claim (a text encode and a state build) runs off the
    loop, and so does the release, which is safe to call twice.  A
    scheduler session's window queue joins the overload plane's registry.
    ``imported``: a restored session parked by :func:`migrate_import`,
    adopted as the claim under this connection's key (no prepare: the
    stream resumes where the source froze it)."""
    mp, sched = app["multipeer_pipeline"], app["batch_scheduler"]
    if imported is not None:
        imported.session_key = session_key
        claimed = imported
    elif mp is None and sched is None:
        return app["pipeline"], lambda: None
    else:
        try:
            if mp is not None:
                claimed = await asyncio.to_thread(mp.claim)
            else:
                claimed = await asyncio.to_thread(sched.claim, session_key)
        except CapacityError:
            return None, None
    if (sched is not None or imported is not None) and app["overload"] is not None:
        app["overload"].register_queue(f"batchwin:{session_key}", claimed.window_queue)
    return claimed, lambda: _release_off_loop(app, claimed)


# -- fleet journeys ---------------------------------------------------------------------

def journey_of(app, session_key: str) -> dict | None:
    """The session's journey binding (``{"journey_id", "leg", "agent"}``),
    or None on a single-process deployment."""
    return app["journey_map"].get(session_key)


def parse_journey(app, headers) -> dict | None:
    """The router's ``X-Journey-Id``/``X-Journey-Leg`` headers as a binding;
    None without them or with ``JOURNEY_ENABLE=0``."""
    if not app["journey_enabled"] or not headers:
        return None
    journey_id = headers.get(wire.JOURNEY_ID)
    if not journey_id:
        return None
    try:
        leg = max(1, int(headers.get(wire.JOURNEY_LEG, "1")))
    except ValueError:
        leg = 1
    return {"journey_id": journey_id, "leg": leg, "agent": env.get_str("WORKER_ID") or ""}


def bind_journey(app, headers, session_key: str) -> dict | None:
    """Thread the journey headers into the session: the journey map
    (webhooks, /health) and its flight recorder and tracer (every snapshot
    and sealed timeline), before its SDP exchange."""
    meta = parse_journey(app, headers)
    if meta is None:
        return None
    app["journey_map"][session_key] = meta
    flight = app["flight"]
    if flight is not None:
        flight.register(session_key).set_journey(**meta)
    return meta


def journey_headers(meta: dict | None) -> dict:
    """The answer's echo of the journey (the client learns its id here)."""
    if not meta:
        return {}
    return {wire.JOURNEY_ID: meta["journey_id"], wire.JOURNEY_LEG: str(meta["leg"])}


# -- live session migration ----------------------------------------------------------

_IMPORTED_TTL_S = 30.0  # the admission reservation's TTL

_BAD_JSON = object()  # a request body that did not parse

# control-plane-only snapshots (a serving tier without a state row to
# move: the target primes like a fresh offer); scheduler snapshots carry
# stream/scheduler.SESSION_SNAPSHOT_SCHEMA
_CONTROL_SNAPSHOT_SCHEMA = 1


def _scheduler_session(app, sid: str):
    """The batch scheduler when it holds ``sid`` (live, or banked while
    quarantined), else None."""
    sched = app["batch_scheduler"]
    if sched is None or not hasattr(sched, "snapshot_session"):
        return None
    if sched.session(sid) is None:
        return None
    return sched


def _expire_imported(app, token: str | None = None):
    """Drop stale parked imports (or the one ``token`` whose timer fired):
    release the restored slot and the import's admission reservation."""
    imp = app["imported_sessions"]
    if token is not None:
        keys = [token] if token in imp else []
    else:
        now = time.monotonic()
        keys = [k for k, e in imp.items() if now - e["ts"] >= _IMPORTED_TTL_S]
    for k in keys:
        entry = imp.pop(k, None)
        if entry is None:
            continue
        timer = app["import_timers"].pop(k, None)
        if timer is not None:
            timer.cancel()
        if entry.get("session") is not None:
            _release_off_loop(app, entry["session"])
        release_admission(app, k)
        logger.warning("imported session %s expired unadopted", k)


def _park_import(app, token: str, sess):
    """Park an import until a re-offer adopts it, with its expiry timer
    (the reservation's TTL; an adopted token makes it a no-op)."""
    app["imported_sessions"][token] = {"session": sess, "ts": time.monotonic()}
    old = app["import_timers"].pop(token, None)
    if old is not None:
        old.cancel()
    app["import_timers"][token] = asyncio.get_running_loop().call_later(
        _IMPORTED_TTL_S + 1.0, _expire_imported, app, token)


def _admit_or_adopt(app, headers, stream_id: str):
    """Admission for /offer and /whip, migration-aware: a re-offer carrying
    ``X-Migrated-Session`` takes the parked import (its admission
    reservation moves to ``stream_id``; a restored session is adopted in
    place of a fresh claim).  -> (imported session or None, refusal or None)."""
    token = headers.get(wire.MIGRATED_SESSION) if headers else None
    entry = None
    if token:
        _expire_imported(app)
        entry = app["imported_sessions"].pop(token, None)
        timer = app["import_timers"].pop(token, None)
        if timer is not None:
            timer.cancel()
    ov = app["overload"]
    adopted = False
    if entry is not None:
        adopted = ov.adopt_reservation(token, stream_id) if ov is not None else True
    if not adopted:
        # tpurtc: allow[reservation-pairing] -- the admitted reservation deliberately outlives this helper: ownership transfers to the caller (offer/publish), which consumes it via the track's supervision registration or releases it via release_admission/end_supervision on every failure path
        rejected = admission_gate(app, stream_id)
        if rejected is not None:
            if entry is not None and entry.get("session") is not None:
                # the reservation lapsed and the agent refuses: free the slot
                _release_off_loop(app, entry["session"])
            return None, rejected
    return (entry or {}).get("session"), None


def _control_snapshot(sid: str) -> dict:
    return {"schema": _CONTROL_SNAPSHOT_SCHEMA, "kind": "control-plane", "session": sid}


async def _export_session(app, sid: str) -> dict | None:
    """``sid``'s scheduler snapshot (the row read takes the step lock: off
    the loop), or None when the scheduler does not hold it."""
    sched = _scheduler_session(app, sid)
    if sched is None:
        return None
    try:
        snap = await asyncio.to_thread(sched.snapshot_session, sid)
    except KeyError:
        return None  # released between the lookup and the read
    snap.setdefault("kind", "scheduler")
    snap["session"] = sid
    return snap


async def migrate_export(app, query) -> Reply:
    """GET /migrate/export?session=<stream id>: one live session for
    migration (the scheduler's snapshot, or a control-plane one on another
    tier).  The session keeps serving here until the client moves."""
    if not env.migrate_enabled():
        return _debug_error(404, "session migration disabled (MIGRATE_ENABLE=0)")
    sid = query.get("session")
    if not sid:
        return _debug_error(400, "session= query required")
    if _scheduler_session(app, sid) is not None:
        snap = await _export_session(app, sid)
        if snap is None:
            return _debug_error(404, f"unknown session {sid!r}")
        return _json(snap)
    if sid not in app["supervisors"]:
        return _debug_error(404, f"unknown session {sid!r}")
    return _json(_control_snapshot(sid))


async def migrate_import(app, body) -> Reply:
    """POST /migrate/import {"token", "snapshot"}: land a migrated session.
    A counted admission reservation under the token comes first; a
    scheduler snapshot then restores into a slot, parked until the re-offer
    carrying ``X-Migrated-Session`` adopts it.  409 for a refused snapshot
    (terminal for the router's retry), 503 with Retry-After when slots or
    admission are exhausted; a retried token answers the parked import."""
    if not env.migrate_enabled():
        return _debug_error(404, "session migration disabled (MIGRATE_ENABLE=0)")
    if body is _BAD_JSON:
        return _debug_error(400, "invalid JSON body")
    if not isinstance(body, dict):
        return _debug_error(400, "body must be an object")
    token = str(body.get("token") or "")
    snap = body.get("snapshot")
    if not token or not isinstance(snap, dict):
        return _debug_error(400, "token and snapshot object required")
    _expire_imported(app)
    parked = app["imported_sessions"].get(token)
    if parked is not None:
        # an idempotent retry: restoring again would orphan the parked slot
        return _json({"ok": True, "token": token, "restored": parked.get("session") is not None})
    importing: set = app["importing_tokens"]
    if token in importing:
        return overloaded(app, "import already in progress")
    rejected = admission_gate(app, token)  # the reservation comes first
    if rejected is not None:
        return rejected
    kind = snap.get("kind")
    sess = None
    importing.add(token)
    try:
        if kind == "scheduler":
            sched = app["batch_scheduler"]
            if sched is None or not hasattr(sched, "restore_session"):
                release_admission(app, token)
                return _debug_error(409, "no batch scheduler on this agent to restore into")
            from ..stream.scheduler import SnapshotMismatch

            try:
                sess = await asyncio.to_thread(sched.restore_session, snap, token)
            except SnapshotMismatch as e:
                release_admission(app, token)
                return _debug_error(409, f"snapshot refused: {e}")
            except CapacityError:
                release_admission(app, token)
                return _slots_full(app)
            except BaseException:
                # the 500 the router retries must not strand the reservation
                release_admission(app, token)
                raise
        elif kind == "control-plane":
            if snap.get("schema") != _CONTROL_SNAPSHOT_SCHEMA:
                release_admission(app, token)
                return _debug_error(
                    409, f"control-plane snapshot schema {snap.get('schema')!r} unsupported "
                         f"(this build speaks {_CONTROL_SNAPSHOT_SCHEMA})")
        else:
            release_admission(app, token)
            return _debug_error(400, f"unknown snapshot kind {kind!r}")
        # parked before the in-flight mark clears: a racing retry sees one or the other
        _park_import(app, token, sess)
    finally:
        importing.discard(token)
    app["stats"].count("migrate_imports")
    return _json({"ok": True, "token": token, "restored": sess is not None})


# -- restart in place ---------------------------------------------------------------

async def _export_all_sessions(app) -> list:
    """Every live session as a handoff entry: its migration snapshot, its
    journey binding and its room."""
    out = []
    for sid, sup in list(app["supervisors"].items()):
        snap = await _export_session(app, sid) or _control_snapshot(sid)
        out.append({"session": sid, "snapshot": snap, "journey": journey_of(app, sid),
                    "room_id": str(sup.context.get("room_id") or "")})
    return out


def _exit_and_respawn(app, respawn: bool, handoff: str) -> bool:
    """The process path of a recycle (blocking): spawn the replacement, then
    exit at once.  False when no backend could spawn."""
    if respawn and not lifecycle.spawn_replacement(handoff):
        return False
    logger.info("recycling: exiting (respawn=%s, handoff=%s)", respawn, handoff)
    lifecycle.exit_process(0)
    return True


def _spawn_recycle_exit(app, respawn: bool, handoff: str):
    """After a beat (the 202 and any webhooks flush first), the recycle's
    exit: ``app["recycle_exit"]`` (an in-process restart) or
    :func:`_exit_and_respawn`, off the loop.  A failed spawn aborts the
    recycle: the sessions keep serving here."""
    step = app["recycle_exit"] or _exit_and_respawn

    async def run():
        await asyncio.sleep(env.get_float("RECYCLE_EXIT_DELAY_S", 0.2))
        if not await asyncio.to_thread(step, app, respawn, handoff):
            logger.error("recycle aborted: replacement spawn failed")
            app["recycling"] = False

    tasks = app["recycle_tasks"]
    task = asyncio.get_running_loop().create_task(run())
    tasks.add(task)
    task.add_done_callback(tasks.discard)


async def admin_recycle(app, body) -> Reply:
    """POST /admin/recycle {"respawn": true|false}: restart (or retire) this
    agent in place.  Every live session goes into the handoff file; the
    replacement imports it before it reports healthy and announces each
    session (AGENT_RECYCLED).  Answers 202 at once; the exit comes a beat
    later.  ``respawn: false`` (the autoscaler's retire) writes nothing
    and only exits."""
    if not env.get_bool("RECYCLE_ENABLE", True):
        return _debug_error(404, "recycle disabled (RECYCLE_ENABLE=0)")
    if app["recycling"]:
        return _debug_error(409, "recycle already in progress")
    respawn = bool(body.get("respawn", True)) if isinstance(body, dict) else True
    app["recycling"] = True
    sessions = await _export_all_sessions(app)
    path = lifecycle.handoff_path()
    if respawn:
        handler = app["stream_event_handler"]
        # the webhook configuration survives the swap: the replacement's
        # AGENT_RECYCLED announces are the handoff's point
        meta = {"worker_id": env.get_str("WORKER_ID") or "",
                "webhook": {"url": handler.webhook_url, "token": handler.token}}
        await asyncio.to_thread(lifecycle.write_handoff, path, sessions, meta)
    _spawn_recycle_exit(app, respawn, path)
    app["stats"].count("recycles")
    return Reply(202, json.dumps({"recycling": True, "respawn": respawn,
                                  "sessions": len(sessions),
                                  "handoff": path if respawn else None}),
                 "application/json")


async def import_handoff(app):
    """A recycled replacement's last startup step: adopt the predecessor's
    handoff (``RECYCLE_HANDOFF``).  Each session takes a counted admission
    reservation and parks like a /migrate/import under the token
    ``rcy-<stream id>`` (the router builds the same token from the
    AGENT_RECYCLED webhook and pins the re-offer here with it); the file is
    consumed whatever happens, so a crash loop never adopts it twice."""
    path = env.get_str("RECYCLE_HANDOFF")
    if not path or not os.path.exists(path):
        return
    data = await asyncio.to_thread(lifecycle.read_handoff, path)
    await asyncio.to_thread(lifecycle.consume_handoff, path)
    if data is None:
        logger.warning("recycle handoff at %s unreadable: booting clean", path)
        return
    handler: StreamEventHandler = app["stream_event_handler"]
    webhook = data.get("webhook")
    if isinstance(webhook, dict) and handler.webhook_url is None and webhook.get("url"):
        handler.webhook_url = webhook["url"]
        handler.token = webhook.get("token")
    sched = app["batch_scheduler"]
    restored = 0
    for entry in data.get("sessions", ()):
        if not isinstance(entry, dict):
            continue
        sid = str(entry.get("session") or "")
        snap = entry.get("snapshot")
        if not sid or not isinstance(snap, dict):
            continue
        token = f"rcy-{sid}"
        # tpurtc: allow[reservation-pairing] -- every admitted token is released when its restore fails, else parked by _park_import (a store under the token in app["imported_sessions"], the park the walk recognises only when written inline)
        if admission_gate(app, token) is not None:
            logger.warning("handoff session %s refused at admission", sid)
            continue
        sess = None
        if snap.get("kind") == "scheduler" and sched is not None and hasattr(
                sched, "restore_session"):
            from ..stream.scheduler import SnapshotMismatch

            try:
                sess = await asyncio.to_thread(sched.restore_session, snap, token)
            except (SnapshotMismatch, CapacityError) as e:
                release_admission(app, token)
                logger.warning("handoff restore of %s refused: %s", sid, e)
                continue
            except Exception:
                # an entry the restore chokes on boots clean like a refused one:
                # its token goes back and the other sessions still come over
                release_admission(app, token)
                logger.exception("handoff restore of %s failed", sid)
                continue
        _park_import(app, token, sess)
        jmeta = entry.get("journey")
        journey = jmeta if isinstance(jmeta, dict) and jmeta.get("journey_id") else None
        handler.handle_session_state(
            sid, str(entry.get("room_id") or ""), "AGENT_RECYCLED",
            "agent recycled in place — re-offer through the router to resume on the same box",
            journey=journey)
        restored += 1
        app["stats"].count("recycle_imports")
    if restored:
        logger.info("recycle handoff adopted: %d session(s) parked", restored)


# -- flows -------------------------------------------------------------------------

async def _discard_pc(pc, pcs: set):
    """Close and drop a half-built peer connection of a failed flow."""
    if pc is None:
        return
    try:
        await pc.close()
    except Exception:
        logger.exception("closing half-built pc failed")
    pcs.discard(pc)


def _client_error(e: Exception, kinds: tuple) -> Exception:
    """What a failed flow raises: a client error of one of ``kinds`` as a
    ``ValueError`` (HTTP 400), anything else as it is."""
    if isinstance(e, kinds) and not isinstance(e, ValueError):
        err = ValueError(str(e))
        err.__cause__ = e
        return err
    return e


def _sdp_answer(sdp: str, location: str, journey: dict | None = None) -> Reply:
    return Reply(201, sdp, "application/sdp", {
        "Access-Control-Allow-Origin": "*",
        "Access-Control-Allow-Headers": "*",
        wire.LOCATION: location,
        **journey_headers(journey),
    })


def _refresh_source_track(state: dict):
    """Point source_track and source_relay at the newest still-live
    publisher (or None), after stopping the relays and closing the
    broadcast groups of every dead one (their viewers stay open, fed
    nothing)."""
    live, tracks, relays = state["whip_pcs"], state["whip_tracks"], state["whip_relays"]
    groups = state["broadcast_groups"]
    for sid in [s for s in tracks if s not in live]:
        tracks.pop(sid, None)
        dead = relays.pop(sid, None)
        if dead is not None:
            dead.stop()
        group = groups.pop(sid, None)
        if group is not None:
            spawn(group.close())
    for sid in reversed(list(tracks)):
        state["source_track"] = tracks[sid]
        state["source_relay"] = relays.get(sid)
        return
    state["source_track"] = None
    state["source_relay"] = None


def has_stream(app) -> bool:
    """Whether a viewer has something to view: a live publisher, or an
    edge-pulled stream."""
    return app["state"]["source_track"] is not None or _edge_group(app) is not None


def _edge_group(app):
    """The live AU-mode group of this agent's edge pull, or None."""
    group = app["state"]["broadcast_groups"].get("edge")
    return None if group is None or group.closed else group


async def _ensure_broadcast_group(app):
    """The broadcast group of the edge-pulled stream, else of the newest
    publisher, made (and its pump started on a view of the publisher's
    relay) at its first viewer.  None when there is no publisher's relay to
    subscribe to."""
    groups = app["state"]["broadcast_groups"]
    edge = _edge_group(app)
    if edge is not None:
        return edge
    relay = app["state"]["source_relay"]
    if relay is None:
        return None
    sid = next((s for s, r in app["state"]["whip_relays"].items() if r is relay), None)
    if sid is None:
        return None
    group = groups.get(sid)
    if group is None or group.closed:
        from .broadcast import BroadcastGroup

        provider = app["provider"]
        group = BroadcastGroup(
            sid,
            width=getattr(provider, "default_width", 512),
            height=getattr(provider, "default_height", 512),
            use_h264=getattr(provider, "use_h264", None),
            stats=relay.stats,  # the relay's drop and freshness counts beside the group's
        )
        await group.start(relay.subscribe())
        groups[sid] = group
    return group


def broadcast_gauges(app) -> dict:
    """The broadcast plane's gauges on /health, /capacity and /metrics:
    groups and viewers against the viewer cap."""
    groups = [g for g in app["state"]["broadcast_groups"].values() if not g.closed]
    viewers = sum(g.viewer_count for g in groups)
    cap = env.broadcast_max_viewers()
    return {
        "broadcast_groups": len(groups),
        "broadcast_viewers": viewers,
        "broadcast_max_viewers": cap,
        "broadcast_viewer_slots_free": max(0, cap - viewers) if cap else -1,
    }


def _transport(app):
    """How this agent reaches another (the edge pull's calls to the owner):
    the configured transport, else HTTP through aiohttp, made at first use."""
    if app["transport"] is None:
        from ..fleet.transport import AiohttpTransport

        app["transport"] = AiohttpTransport(env.get_float("FLEET_PROXY_TIMEOUT_S", 30.0))
        app["owns_transport"] = True
    return app["transport"]


async def broadcast_pull(app, body) -> Reply:
    """POST /broadcast/pull ``{"owner_url": ...}``: pull one copy of the
    publisher's stream from its owning agent into a local AU-mode group, so
    that viewers placed here (by the fleet router) fan out from this agent.
    Idempotent while the same owner's pull is live (``exists``); another
    owner_url replaces the pull.  409 with fan-out or the edge pull off,
    400 for a bad body, 502 when the pull cannot be set up."""
    if not (env.broadcast_fanout_enabled() and env.broadcast_edge_pull_enabled()):
        return Reply(409, "broadcast edge pull disabled")
    if body is _BAD_JSON:
        return Reply(400, "invalid JSON body")
    owner_url = body.get("owner_url") if isinstance(body, dict) else None
    if not owner_url or not isinstance(owner_url, str):
        return Reply(400, "owner_url required")
    state = app["state"]
    groups = state["broadcast_groups"]
    puller = state["edge_puller"]
    if puller is not None and not puller.closed and puller.owner_url == owner_url.rstrip("/"):
        group = _edge_group(app)
        if group is not None:
            return _json({"status": "exists", "aus": puller.aus, "viewers": group.viewer_count})
    from .broadcast import BroadcastGroup, EdgePuller

    provider = app["provider"]
    old = groups.pop("edge", None)
    if old is not None:
        await old.close()
    if puller is not None:
        await puller.close()
        state["edge_puller"] = None
    group = BroadcastGroup(
        "edge",
        width=getattr(provider, "default_width", 512),
        height=getattr(provider, "default_height", 512),
        use_h264=getattr(provider, "use_h264", None),
    )
    await group.start()  # AU mode: the puller feeds it, no local sink
    try:
        puller = await EdgePuller(group, owner_url, _transport(app)).open()
    except Exception as e:
        # no native runtime, the owner unreachable or refusing: the viewer
        # goes to the owning agent instead
        await group.close()
        return Reply(502, f"edge pull failed: {e}")
    groups["edge"] = group
    state["edge_puller"] = puller
    return _json({"status": "pulling", "owner_url": puller.owner_url})


async def publish(app, sdp: str, headers=None) -> Reply:
    """WHIP: a publisher's stream goes through the pipeline; its processed
    track becomes the source that viewers subscribe to (newest wins).
    ``headers``: the request's (a journey, a migrated session's token)."""
    pcs, provider, state, stats = app["pcs"], app["provider"], app["state"], app["stats"]
    session_id = str(uuid.uuid4())
    imported, rejected = _admit_or_adopt(app, headers, session_id)
    if rejected is not None:
        return rejected
    # tpurtc: allow[reservation-pairing] -- the one path the walk flags is the refusal below: claim_pipeline gave (None, None), so nothing was claimed, and _slots_full is this plane's refusal helper (overloaded(), a 503 with Retry-After) where the JAX agent returns _overloaded_response directly
    pipeline, release_pipeline = await claim_pipeline(app, session_id, imported=imported)
    if pipeline is None:
        release_admission(app, session_id)
        return _slots_full(app)
    jmeta = bind_journey(app, headers, session_id)
    pc = None
    try:
        offer_sdp = provider.session_description(sdp=sdp, type="offer")
        # no TURN here: OBS does not trickle ICE, so a TURN permission
        # exchange cannot complete; STUN and pinned UDP ports instead
        pc = provider.peer_connection()
        pcs.add(pc)
        state["whip_pcs"][session_id] = pc
        transceiver = pc.addTransceiver("video")
        transceiver.setCodecPreferences(provider.h264_codec_preferences("video"))

        @pc.on("datachannel")
        def on_datachannel(channel):
            wire_datachannel(pipeline, channel, encoders=encoder_surface(provider))

        @pc.on("iceconnectionstatechange")
        async def on_iceconnectionstatechange():
            logger.info("ICE connection state is %s", pc.iceConnectionState)
            if pc.iceConnectionState == "failed":
                await pc.close()
                pcs.discard(pc)

        @pc.on("track")
        def on_track(track):
            logger.info("Track received: %s", track.kind)
            if track.kind == "video":
                supervised = supervise(app, pc, TimedPipeline(pipeline, stats), session_id)
                register_ingest_queue(app, session_id, track)
                vt = VideoStreamTrack(track, supervised, overload=app["overload"],
                                      tracer=session_tracer(app, session_id, track))
                relay = TrackRelay(vt, stats=FrameStats())
                state["whip_tracks"][session_id] = vt
                state["whip_relays"][session_id] = relay
                state["source_track"] = vt
                state["source_relay"] = relay

        @pc.on("connectionstatechange")
        async def on_connectionstatechange():
            logger.info("Connection state is: %s", pc.connectionState)
            if pc.connectionState in ("failed", "closed"):
                await pc.close()
                pcs.discard(pc)
                state["whip_pcs"].pop(session_id, None)
                _refresh_source_track(state)
                release_pipeline()
                end_supervision(app, session_id)

        await pc.setRemoteDescription(offer_sdp)
        # OBS: gather every ICE candidate before answering (it does not trickle)
        await pc._RTCPeerConnection__gather()
        answer = await pc.createAnswer()
        await pc.setLocalDescription(answer)
    except Exception as e:
        release_pipeline()
        await _discard_pc(pc, pcs)
        state["whip_pcs"].pop(session_id, None)
        state["whip_tracks"].pop(session_id, None)
        _refresh_source_track(state)
        # on_track may have registered supervision already (it fires inside
        # setRemoteDescription); its end releases the admission reservation
        end_supervision(app, session_id)
        raise _client_error(e, (LookupError,))
    return _sdp_answer(answer.sdp, f"/whip/{session_id}", jmeta)


async def subscribe(app, sdp: str, headers=None) -> Reply:
    """WHEP: a viewer of the newest publisher's processed stream, or of the
    edge-pulled one; 401 when there is neither.  On a provider that can
    join one (the native tier) with ``BROADCAST_FANOUT`` on, the viewer
    joins the publisher's broadcast group, within ``BROADCAST_MAX_VIEWERS``
    (503 with Retry-After past it), and is refused when no group can be
    had; otherwise (the loopback and aiortc providers, or fan-out off) it
    gets its own relayed view.  A viewer echoes its journey without
    binding it (it owns no recorder)."""
    state = app["state"]
    source_track = state["source_track"]
    if source_track is None and _edge_group(app) is None:
        return Reply(401)
    pcs, provider = app["pcs"], app["provider"]
    offer_sdp = provider.session_description(sdp=sdp, type="offer")
    pc = provider.peer_connection()
    session_id = str(uuid.uuid4())
    # the broadcast fan-out: viewers share one encode and one packetize and
    # claim no engine slot; their admission is the viewer cap
    group = None
    joins = env.broadcast_fanout_enabled() and hasattr(pc, "join_broadcast")
    if joins:
        group = await _ensure_broadcast_group(app)
    if group is None and (joins or source_track is None):
        await _discard_pc(pc, pcs)
        if source_track is None:
            return overloaded(app, "edge stream requires the broadcast plane")
        return overloaded(app, "no broadcast group for the publisher")
    if group is not None:
        cap = env.broadcast_max_viewers()
        if cap and group.viewer_count >= cap:
            await _discard_pc(pc, pcs)
            return overloaded(app, "broadcast viewer capacity reached", retry_after=2.0)
        pc.join_broadcast(group)
    pcs.add(pc)
    state["whep_pcs"][session_id] = pc
    # a viewer outside a group gets its own relayed view (never concurrent
    # recv() on the track); a group holds the one subscription of its members
    relay = state["source_relay"] if group is None else None
    viewer_track = relay.subscribe() if relay is not None else source_track

    def end_viewer():
        state["whep_pcs"].pop(session_id, None)
        if relay is not None:
            viewer_track.stop()

    @pc.on("iceconnectionstatechange")
    async def on_iceconnectionstatechange():
        logger.info("ICE connection state is %s", pc.iceConnectionState)
        if pc.iceConnectionState == "failed":
            await pc.close()
            pcs.discard(pc)

    @pc.on("connectionstatechange")
    async def on_connectionstatechange():
        logger.info("Connection state is: %s", pc.connectionState)
        if pc.connectionState in ("failed", "closed"):
            await pc.close()
            pcs.discard(pc)
            end_viewer()

    try:
        if group is None:
            sender = pc.addTrack(viewer_track)
            provider.force_codec(pc, sender, "video/H264")
        await pc.setRemoteDescription(offer_sdp)
        await pc._RTCPeerConnection__gather()
        answer = await pc.createAnswer()
        await pc.setLocalDescription(answer)
    except Exception:
        await _discard_pc(pc, pcs)
        end_viewer()
        raise
    return _sdp_answer(answer.sdp, f"/whep/{session_id}", parse_journey(app, headers))


async def offer(app, params: dict, headers=None) -> Reply:
    """/offer: a bidirectional browser session — the peer's track comes back
    processed on the same connection; webhooks on connect and close.
    ``headers``: the request's (a journey, a migrated session's token)."""
    try:
        room_id = params["room_id"]
        offer_params = params["offer"]
    except LookupError as e:
        raise ValueError(str(e)) from e
    pcs, provider, stats = app["pcs"], app["provider"], app["stats"]
    events: StreamEventHandler = app["stream_event_handler"]
    stream_id = str(uuid.uuid4())
    imported, rejected = _admit_or_adopt(app, headers, stream_id)
    if rejected is not None:
        return rejected
    # tpurtc: allow[reservation-pairing] -- the one path the walk flags is the refusal below: claim_pipeline gave (None, None), so nothing was claimed, and _slots_full is this plane's refusal helper (overloaded(), a 503 with Retry-After) where the JAX agent returns _overloaded_response directly
    pipeline, release_pipeline = await claim_pipeline(app, stream_id, imported=imported)
    if pipeline is None:
        release_admission(app, stream_id)
        return _slots_full(app)
    # bound before the SDP exchange: on_track (inside setRemoteDescription)
    # supervises a session that already knows its journey
    jmeta = bind_journey(app, headers, stream_id)
    pc = None
    try:
        offer_sdp = provider.session_description(sdp=offer_params["sdp"], type=offer_params["type"])
        # Twilio is blocking HTTP (up to 10 s): never on the event loop
        ice_servers = await asyncio.to_thread(turn.get_ice_servers)
        pc = provider.peer_connection(ice_servers if ice_servers else None)
        pcs.add(pc)
        video = {}  # "track": the processed track, once the peer's arrives
        transceiver = pc.addTransceiver("video")
        transceiver.setCodecPreferences(provider.h264_codec_preferences("video"))

        @pc.on("datachannel")
        def on_datachannel(channel):
            wire_datachannel(pipeline, channel, guard=lambda: "track" in video,
                             encoders=encoder_surface(provider))

        @pc.on("track")
        def on_track(track):
            logger.info("Track received: %s", track.kind)
            if track.kind == "video":
                supervised = supervise(app, pc, TimedPipeline(pipeline, stats), stream_id, room_id)
                register_ingest_queue(app, stream_id, track)
                video["track"] = VideoStreamTrack(track, supervised, overload=app["overload"],
                                                  tracer=session_tracer(app, stream_id, track))
                sender = pc.addTrack(video["track"])
                provider.force_codec(pc, sender, "video/H264")

        @pc.on("connectionstatechange")
        async def on_connectionstatechange():
            conn = pc.connectionState  # close() below re-enters with "closed"
            logger.info("Connection state is: %s", conn)
            if conn in ("failed", "closed"):
                await pc.close()
                pcs.discard(pc)
                release_pipeline()
                journey = journey_of(app, stream_id)  # before the map clears
                end_supervision(app, stream_id)
                if conn == "closed":
                    events.handle_stream_ended(stream_id, room_id, journey=journey)
            elif conn == "connected":
                events.handle_stream_started(stream_id, room_id, journey=journey_of(app, stream_id))

        await pc.setRemoteDescription(offer_sdp)
        answer = await pc.createAnswer()
        await pc.setLocalDescription(answer)
    except Exception as e:
        release_pipeline()
        await _discard_pc(pc, pcs)
        end_supervision(app, stream_id)
        raise _client_error(e, (KeyError,))
    return Reply(
        200,
        json.dumps({"sdp": pc.localDescription.sdp, "type": pc.localDescription.type}),
        "application/json",
        {wire.STREAM_ID: stream_id, **journey_headers(jmeta)},
    )


async def close(app, kind: str, session: str | None = None) -> bool:
    """DELETE /whip or /whep: close one session (False when unknown) or,
    with ``session=None``, all of that kind."""
    state = app["state"]
    live: dict = state[f"{kind}_pcs"]
    if session is not None:
        pc = live.pop(session, None)
        closing = [] if pc is None else [pc]
    else:
        closing = list(live.values())
        live.clear()
    await asyncio.gather(*[pc.close() for pc in closing])
    for pc in closing:
        app["pcs"].discard(pc)
    if kind == "whip":
        _refresh_source_track(state)
    return session is None or bool(closing)


# -- the routes ------------------------------------------------------------------------

def _mime(headers) -> tuple:
    """(media type, charset) of a request's Content-Type, as aiohttp reads
    them (no header: application/octet-stream)."""
    raw = (headers or {}).get("Content-Type") or ""
    mime, *params = raw.split(";")
    charset = None
    for param in params:
        key, _, value = param.strip().partition("=")
        if key.strip().lower() == "charset":
            charset = value.strip().strip('"') or None
    return mime.strip().lower() or "application/octet-stream", charset


def _text(headers, body: bytes) -> str:
    """The body decoded by its charset (utf-8 without one); ValueError for
    bytes that do not decode, LookupError for an unknown charset."""
    return body.decode(_mime(headers)[1] or "utf-8")


def _json_body(headers, body: bytes):
    return json.loads(_text(headers, body))


async def route(app, method: str, path: str, query=None, headers=None, body: bytes = b"") -> Reply:
    """One request to the agent: the status mapping of every route the HTTP
    layer (server/agent.py) serves, over the flows above.  The fleet's
    in-process transport (fleet/transport.py) calls it the same way, so an
    agent answers alike over HTTP and in the same process.  404 for a path
    no route serves."""
    query = query if query is not None else {}
    kind, _, session = path.strip("/").partition("/")
    if kind in ("whip", "whep") and method == "DELETE":
        ok = await close(app, kind, session or None)
        return Reply(200 if ok else 404)
    if (method, path) == ("POST", "/offer"):
        try:
            params = _json_body(headers, body)
        except (ValueError, LookupError) as e:  # bad JSON, or an unknown charset=
            return Reply(400, f"invalid offer request: {e}")
        try:
            return await offer(app, params, headers)
        except ValueError as e:
            return Reply(400, f"invalid offer request: {e}")
    if (method, path) == ("POST", "/whep"):
        if _mime(headers)[0] != "application/sdp":
            return Reply(400)
        if not has_stream(app):
            return Reply(401)
        try:
            text = _text(headers, body)
        except (ValueError, LookupError) as e:
            return Reply(400, f"invalid offer body: {e}")
        try:
            return await subscribe(app, text, headers)
        except ValueError as e:
            return Reply(400, f"invalid offer: {e}")
    if (method, path) == ("POST", "/whip"):
        if _mime(headers)[0] != "application/sdp":
            return Reply(400)
        try:
            return await publish(app, _text(headers, body), headers)
        except (ValueError, LookupError) as e:
            return Reply(400, f"invalid offer: {e}")
    if (method, path) == ("POST", "/broadcast/pull"):
        try:
            parsed = _json_body(headers, body)
        except (ValueError, LookupError):
            parsed = _BAD_JSON
        return await broadcast_pull(app, parsed)
    if (method, path) == ("GET", "/demo"):
        return demo()
    if (method, path) == ("POST", "/config"):
        try:
            config = _json_body(headers, body)
        except (ValueError, LookupError):
            return Reply(400, "invalid JSON body")
        logger.info("received config: %s", config)
        try:
            await update_config(app, config)
        except ValueError as e:
            return Reply(400, str(e))
        return Reply(200, "OK", "application/json")
    if (method, path) == ("GET", "/"):
        return Reply(200, "OK", "application/json")
    if (method, path) == ("GET", "/health"):
        return _json(health(app))
    if (method, path) == ("GET", "/capacity"):
        return _json(capacity(app))
    if (method, path) == ("POST", "/drain"):
        if app["overload"] is None:
            return drain(app, None)
        try:
            return drain(app, _json_body(headers, body))
        except (ValueError, LookupError):
            return Reply(400, "invalid JSON body")
    if (method, path) == ("GET", "/metrics"):
        return metrics_reply(app, query.get("format", "json"))
    if path == "/debug/trace" and method in ("GET", "POST"):
        if method == "GET" or app["flight"] is None:
            return await debug_trace(app)
        try:
            parsed = _json_body(headers, body)
        except (ValueError, LookupError):
            return Reply(400, "invalid JSON body")
        return await debug_trace(app, parsed)
    if (method, path) == ("GET", "/debug/flight"):
        return debug_flight(app, query)
    if (method, path) == ("GET", "/migrate/export"):
        return await migrate_export(app, query)
    if (method, path) == ("POST", "/migrate/import"):
        try:
            parsed = _json_body(headers, body)
        except (ValueError, LookupError):
            parsed = _BAD_JSON
        return await migrate_import(app, parsed)
    if (method, path) == ("POST", "/admin/recycle"):
        try:
            parsed = _json_body(headers, body)
        except (ValueError, LookupError):
            parsed = {}
        return await admin_recycle(app, parsed)
    return Reply(404, "404: Not Found")
