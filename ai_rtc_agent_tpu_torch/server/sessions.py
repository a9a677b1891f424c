"""The serving seam's session layer: publish, subscribe, offer, config and
close as plain async functions over an app-state mapping, with no HTTP.

The JAX agent keeps this logic inside its aiohttp handlers
(ai_rtc_agent_tpu/server/agent.py: ``offer``, ``whep``, ``whip``,
``update_config``, ``on_startup``, ``on_shutdown``); here it is split out so
that ``chip_smoke.py`` drives a whole session on the card, where aiohttp is
not installed, and ``server/agent.py`` maps HTTP requests onto it.

The app-state mapping (an aiohttp ``Application`` or a plain dict) holds
``model_id``, ``pipeline``, ``provider``, ``fbs``, ``device``,
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
step on the card; with ``BATCHSCHED=0``, an injected pipeline or
``--fbs`` > 1 every connection shares the one pipeline.  A full slot pool
answers 503 with ``Retry-After``; closing a connection releases its slot.
Steps run in worker threads or the planes' own threads; this layer adds
no torch work of its own (the pts wrap and fbs stacking are numpy).

Admission, supervision, the overload plane, journeys and broadcast
fan-out are later slices of the port.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
import uuid
from dataclasses import dataclass, field

from .. import resolve_device
from ..models import registry
from ..parallel.multipeer import CapacityError
from ..resilience.overload import ShedFrame
from ..stream.pipeline import StreamDiffusionPipeline
from ..utils import env
from ..utils.profiling import FrameStats
from . import turn, wire
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
        for _ in outs:
            self._stats.record(dt)
        return outs


# -- runtime config (POST /config and the config datachannel) ------------------

def apply_runtime_config(pipeline, config: dict):
    """Apply a runtime config object to ``pipeline``: ``prompt``,
    ``t_index_list``, ``guidance_scale``/``delta``.  Every capability and
    value check runs before anything changes, so a ``ValueError`` means
    nothing was applied."""
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
    if config.get("encoder") is not None:
        raise ValueError("encoder reconfigure not supported by this provider")
    if "adapter" in config:
        raise ValueError("adapter hot-swap not supported by this pipeline")
    t_index_list = config.get("t_index_list")
    if t_index_list is not None:
        pipeline.update_t_index_list(t_index_list)
    prompt = config.get("prompt")
    if prompt is not None:
        pipeline.update_prompt(prompt)
    if guidance_scale is not None or delta is not None:
        update_guidance(guidance_scale=guidance_scale, delta=delta)


def wire_datachannel(pipeline, channel, guard=None):
    """Config messages on ``channel`` reach ``pipeline`` (off the loop: a
    prompt update runs the text encoder); a bad message is logged."""

    @channel.on("message")
    async def on_message(message):
        if guard is not None and not guard():
            return
        logger.info("received config: %s", message)
        try:
            await asyncio.to_thread(apply_runtime_config, pipeline, json.loads(message))
        except (ValueError, KeyError, TypeError) as e:
            logger.error("bad config message: %s", e)


# -- lifecycle -------------------------------------------------------------------

def configure(app, model_id: str = "stabilityai/sd-turbo", pipeline=None, provider=None,
              fbs: int = 0, device=None, multipeer: int = 0, multipeer_pipeline=None,
              batch_scheduler=None):
    """Fill the app state's configuration.  ``pipeline=None`` builds the
    port's StreamDiffusionPipeline at :func:`startup`, and the batch
    scheduler over it; ``multipeer`` N > 0 builds the N-slot peer engine
    instead.  ``pipeline``, ``multipeer_pipeline`` and ``batch_scheduler``
    are injectable (tests)."""
    app["model_id"] = model_id
    app["pipeline"] = pipeline
    app["provider"] = provider or get_provider()
    app["fbs"] = fbs
    app["device"] = device
    app["multipeer"] = multipeer
    app["multipeer_pipeline"] = multipeer_pipeline
    app["batch_scheduler"] = batch_scheduler


def build_pipeline(model_id: str, fbs: int = 0, device=None) -> StreamDiffusionPipeline:
    """The served pipeline, on the card unless ``device`` says otherwise
    (raises without one: the server never carries on on the CPU)."""
    dev = resolve_device(device)
    cfg = None
    if fbs > 1:
        cfg = registry.default_stream_config(model_id, device=dev, frame_buffer_size=fbs)
    return StreamDiffusionPipeline(model_id, config=cfg, device=dev)


def startup(app):
    """Build the serving plane (see the module docstring).  A plane that
    cannot be built raises: the agent never serves another one instead."""
    if app["multipeer"] and app["multipeer_pipeline"] is None:
        from .multipeer_serving import MultiPeerPipeline

        if app["fbs"] > 1:
            raise ValueError(
                "--fbs is not supported with --multipeer (peers are already the batch dimension)"
            )
        app["multipeer_pipeline"] = MultiPeerPipeline(
            app["model_id"], max_peers=app["multipeer"], device=resolve_device(app["device"])
        )
    elif app["pipeline"] is None and app["multipeer_pipeline"] is None:
        app["pipeline"] = build_pipeline(app["model_id"], app["fbs"], app["device"])
        if app["batch_scheduler"] is None and env.batchsched_enabled():
            if app["fbs"] > 1:
                logger.info("--fbs %d: serving the shared pipeline (frame batches through "
                            "the batch scheduler are a later slice of the port)", app["fbs"])
            else:
                from ..stream.scheduler import BatchScheduler

                app["batch_scheduler"] = BatchScheduler.from_pipeline(app["pipeline"])
    app["pcs"] = set()
    app["releasing"] = set()  # slot releases in flight
    app["stream_event_handler"] = StreamEventHandler()
    app["state"] = {
        "source_track": None,  # the newest live publisher's processed track
        "source_relay": None,  # and its relay, which viewers subscribe to
        "whip_pcs": {},
        "whip_tracks": {},
        "whip_relays": {},
        "whep_pcs": {},
    }
    app["stats"] = FrameStats()


async def shutdown(app):
    pcs = app["pcs"]
    await asyncio.gather(*[pc.close() for pc in pcs])
    pcs.clear()
    for relay in app["state"]["whip_relays"].values():
        relay.stop()
    await asyncio.gather(*app["releasing"])
    for plane in (app["multipeer_pipeline"], app["batch_scheduler"]):
        if plane is not None:
            plane.close()


def metrics(app) -> dict:
    """FrameStats, and the batch scheduler's ``batchsched_*`` gauges."""
    out = app["stats"].snapshot()
    if app["batch_scheduler"] is not None:
        out.update(app["batch_scheduler"].snapshot())
    return out


async def update_config(app, config):
    """POST /config, off the loop: every multipeer slot, else every live
    scheduler session and the scheduler's defaults for future ones, else
    the shared pipeline."""
    target = app["multipeer_pipeline"] or app["batch_scheduler"] or app["pipeline"]
    try:
        await asyncio.to_thread(apply_runtime_config, target, config)
    except (TypeError, KeyError) as e:  # structurally wrong JSON
        raise ValueError(str(e)) from e


def _slots_full(app) -> Reply:
    """503 with Retry-After, naming the slot pool that refused (the JAX
    agent's text)."""
    text = ("all peer slots in use" if app["multipeer_pipeline"] is not None
            else "all batch-scheduler session slots in use")
    return Reply(503, text, None, {wire.RETRY_AFTER: "2"})


async def claim_pipeline(app, session_key: str):
    """-> (pipeline, release) for a new connection: a multipeer slot, a
    scheduler session or the shared pipeline; (None, None) when the slots
    are full.  The claim (a text encode and a state build) runs off the
    loop, and so does the release, which is safe to call twice."""
    mp, sched = app["multipeer_pipeline"], app["batch_scheduler"]
    if mp is None and sched is None:
        return app["pipeline"], lambda: None
    try:
        if mp is not None:
            claimed = await asyncio.to_thread(mp.claim)
        else:
            claimed = await asyncio.to_thread(sched.claim, session_key)
    except CapacityError:
        return None, None
    releasing = app["releasing"]

    def release():
        task = asyncio.ensure_future(asyncio.to_thread(claimed.release))
        releasing.add(task)
        task.add_done_callback(releasing.discard)

    return claimed, release


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


def _sdp_answer(sdp: str, location: str) -> Reply:
    return Reply(201, sdp, "application/sdp", {
        "Access-Control-Allow-Origin": "*",
        "Access-Control-Allow-Headers": "*",
        wire.LOCATION: location,
    })


def _refresh_source_track(state: dict):
    """Point source_track and source_relay at the newest still-live
    publisher (or None), after stopping the relays of every dead one."""
    live, tracks, relays = state["whip_pcs"], state["whip_tracks"], state["whip_relays"]
    for sid in [s for s in tracks if s not in live]:
        tracks.pop(sid, None)
        dead = relays.pop(sid, None)
        if dead is not None:
            dead.stop()
    for sid in reversed(list(tracks)):
        state["source_track"] = tracks[sid]
        state["source_relay"] = relays.get(sid)
        return
    state["source_track"] = None
    state["source_relay"] = None


def has_publisher(app) -> bool:
    return app["state"]["source_track"] is not None


async def publish(app, sdp: str) -> Reply:
    """WHIP: a publisher's stream goes through the pipeline; its processed
    track becomes the source that viewers subscribe to (newest wins)."""
    pcs, provider, state, stats = app["pcs"], app["provider"], app["state"], app["stats"]
    session_id = str(uuid.uuid4())
    pipeline, release_pipeline = await claim_pipeline(app, session_id)
    if pipeline is None:
        return _slots_full(app)
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
            wire_datachannel(pipeline, channel)

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
                vt = VideoStreamTrack(track, TimedPipeline(pipeline, stats))
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
        raise _client_error(e, (LookupError,))
    return _sdp_answer(answer.sdp, f"/whip/{session_id}")


async def subscribe(app, sdp: str) -> Reply:
    """WHEP: a viewer gets its own relayed view of the newest publisher's
    processed stream; 401 when there is no publisher."""
    state = app["state"]
    source_track = state["source_track"]
    if source_track is None:
        return Reply(401)
    pcs, provider = app["pcs"], app["provider"]
    offer_sdp = provider.session_description(sdp=sdp, type="offer")
    pc = provider.peer_connection()
    session_id = str(uuid.uuid4())
    pcs.add(pc)
    state["whep_pcs"][session_id] = pc
    # each viewer its own relayed view: never concurrent recv() on the track
    relay = state["source_relay"]
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
    return _sdp_answer(answer.sdp, f"/whep/{session_id}")


async def offer(app, params: dict) -> Reply:
    """/offer: a bidirectional browser session — the peer's track comes back
    processed on the same connection; webhooks on connect and close."""
    try:
        room_id = params["room_id"]
        offer_params = params["offer"]
    except LookupError as e:
        raise ValueError(str(e)) from e
    pcs, provider, stats = app["pcs"], app["provider"], app["stats"]
    events: StreamEventHandler = app["stream_event_handler"]
    stream_id = str(uuid.uuid4())
    pipeline, release_pipeline = await claim_pipeline(app, stream_id)
    if pipeline is None:
        return _slots_full(app)
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
            wire_datachannel(pipeline, channel, guard=lambda: "track" in video)

        @pc.on("track")
        def on_track(track):
            logger.info("Track received: %s", track.kind)
            if track.kind == "video":
                video["track"] = VideoStreamTrack(track, TimedPipeline(pipeline, stats))
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
                if conn == "closed":
                    events.handle_stream_ended(stream_id, room_id)
            elif conn == "connected":
                events.handle_stream_started(stream_id, room_id)

        await pc.setRemoteDescription(offer_sdp)
        answer = await pc.createAnswer()
        await pc.setLocalDescription(answer)
    except Exception as e:
        release_pipeline()
        await _discard_pc(pc, pcs)
        raise _client_error(e, (KeyError,))
    return Reply(
        200,
        json.dumps({"sdp": pc.localDescription.sdp, "type": pc.localDescription.type}),
        "application/json",
        {wire.STREAM_ID: stream_id},
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
