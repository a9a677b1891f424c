"""Stream lifecycle webhooks (counterpart of ai_rtc_agent_tpu/server/events.py).

The started and ended events, the supervisor's degraded and recovered
events, the fleet's migrated event and the engine guard's degraded,
recovered and evacuating events, posted as JSON with a bearer token to ``WEBHOOK_URL`` (``AUTH_TOKEN``),
fire-and-forget on the event loop so a slow endpoint never stalls the media
path.  The events are plain dataclasses whose ``asdict`` equals the JAX
package's pydantic dump (keyword arguments that are not fields are
dropped, as pydantic drops them); ``aiohttp`` is imported only when a
webhook is posted.  The fleet router runs a handler of its own, pointed at
the clients' notification endpoint (``webhook_url``/``token``).

Started, ended, degraded and migrated events carry the fleet journey's
correlation key (``journey_id``, ``journey_leg``) when the session is a
leg of one; the router's AGENT_DEAD and AGENT_RECYCLED re-points ride
StreamDegraded.

A StreamDegraded event carries the flight recorder's snapshot id and the
last entries of the session's event log (obs/recorder.py); the SLO and
device telemetry planes raise StreamDegraded with ``state="SLO_BREACH"``
and ``"RETRACE_BREACH"`` through :meth:`StreamEventHandler.handle_session_state`.
``on_emit`` tells the flight recorder what the outside world was told.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time

from ..utils import env

logger = logging.getLogger(__name__)

#: the closed webhook vocabulary (the JAX module's sets)
EVENT_NAMES = frozenset({
    "StreamStarted", "StreamEnded", "StreamDegraded",
    "StreamRecovered", "StreamMigrated",
    # the engine fault domain (resilience/engine_guard.py)
    "EngineDegraded", "EngineRecovered", "AgentEvacuating",
})
STATE_NAMES = frozenset({
    # supervisor states (resilience/supervisor.py)
    "HEALTHY", "DEGRADED", "RECOVERING", "FAILED",
    # fleet agent states (fleet/registry.py AGENT_STATES)
    "DRAINING", "DEAD",
    # breach and lifecycle states ridden by StreamDegraded
    "SLO_BREACH", "RETRACE_BREACH", "AGENT_DEAD", "AGENT_RECYCLED",
    # engine guard states (terminal FAILED is the supervisor's word too)
    "ARMED", "QUARANTINED", "REBUILDING", "EVACUATING",
})


@dataclasses.dataclass
class WebhookEvent:
    """``journey_id``/``journey_leg`` are the fleet's correlation key
    (fleet/journey.py), threaded by the router's ``X-Journey-Id`` header;
    None on a single-process deployment."""

    stream_id: str
    room_id: str
    timestamp: int
    journey_id: str | None = None
    journey_leg: int | None = None


@dataclasses.dataclass
class StreamStartedEvent(WebhookEvent):
    event: str = "StreamStarted"


@dataclasses.dataclass
class StreamEndedEvent(WebhookEvent):
    event: str = "StreamEnded"


@dataclasses.dataclass
class StreamDegradedEvent(WebhookEvent):
    """The supervisor moved the session out of HEALTHY (``state``: the new
    state, ``reason``: the trigger); the stream keeps flowing in passthrough."""

    event: str = "StreamDegraded"
    state: str = "DEGRADED"
    reason: str = ""
    flight_snapshot_id: str | None = None
    recent_events: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class StreamRecoveredEvent(WebhookEvent):
    event: str = "StreamRecovered"
    state: str = "HEALTHY"
    reason: str = ""


@dataclasses.dataclass
class StreamMigratedEvent(WebhookEvent):
    """The fleet moved this session to another agent (drain-as-move,
    evacuation or crash restore): its state already waits on
    ``target_agent``; the client re-offers through the router echoing
    ``journey_id`` and resumes mid-stream."""

    event: str = "StreamMigrated"
    source_agent: str = ""
    target_agent: str = ""
    reason: str = ""


@dataclasses.dataclass
class EngineDegradedEvent(WebhookEvent):
    """The engine guard tripped: every session serves passthrough while the
    rebuild runs (``state``: QUARANTINED or REBUILDING)."""

    event: str = "EngineDegraded"
    state: str = "QUARANTINED"
    reason: str = ""


@dataclasses.dataclass
class EngineRecoveredEvent(WebhookEvent):
    """The guard re-armed; ``rebuild_ms`` is the winning attempt's wall time."""

    event: str = "EngineRecovered"
    state: str = "ARMED"
    rebuild_ms: float = 0.0
    attempt: int = 0


@dataclasses.dataclass
class AgentEvacuatingEvent(WebhookEvent):
    """The rebuild spent its attempts: the agent evacuates, then parks FAILED."""

    event: str = "AgentEvacuating"
    state: str = "EVACUATING"
    reason: str = ""


EVENTS = {cls.event: cls for cls in (
    StreamStartedEvent, StreamEndedEvent, StreamDegradedEvent, StreamRecoveredEvent,
    StreamMigratedEvent, EngineDegradedEvent, EngineRecoveredEvent, AgentEvacuatingEvent)}


class StreamEventHandler:
    def __init__(self, session_factory=None, webhook_url=None, token=None):
        """``session_factory`` returns an object with an async ``post(url,
        headers=, json=)`` in place of an aiohttp session; ``webhook_url``
        and ``token`` override WEBHOOK_URL and AUTH_TOKEN (the router's
        handler posts to the clients, not to itself)."""
        self.webhook_url = env.get_str("WEBHOOK_URL") if webhook_url is None else webhook_url
        self.token = env.get_str("AUTH_TOKEN") if token is None else token
        self._session_factory = session_factory
        self._tasks: set = set()
        # flight-recorder hook: callable(event_name, stream_id), fired when a
        # webhook is dispatched
        self.on_emit = None

    async def _post(self, event: WebhookEvent):
        headers = {"Content-Type": "application/json", "Authorization": f"Bearer {self.token}"}
        body = dataclasses.asdict(event)
        try:
            if self._session_factory:
                resp = await self._session_factory().post(self.webhook_url, headers=headers, json=body)
                status = getattr(resp, "status", 200)
            else:
                import aiohttp

                async with aiohttp.ClientSession() as session:
                    async with session.post(
                        self.webhook_url, headers=headers, json=body,
                        timeout=aiohttp.ClientTimeout(total=10),
                    ) as resp:
                        status = resp.status
            if status != 200:
                logger.error("failed to send %s event with %s", event.event, status)
        except Exception as e:  # a webhook failure must never reach the session
            logger.error("webhook %s failed: %s", event.event, e)

    def send_request(self, event_name: str, stream_id: str, room_id: str, **extra):
        """Fire-and-forget; returns the task (or None when unconfigured)."""
        if self.webhook_url is None or self.token is None:
            return None
        cls = EVENTS.get(event_name)
        if cls is None:
            raise ValueError(f"unknown event: {event_name}")
        fields = {f.name for f in dataclasses.fields(cls)}
        ev = cls(stream_id=stream_id, room_id=room_id, timestamp=int(time.time()),
                 **{k: v for k, v in extra.items() if k in fields})
        if self.on_emit is not None:
            try:
                self.on_emit(event_name, stream_id)
            except Exception:
                logger.exception("webhook on_emit hook failed")
        try:
            # tpurtc: allow[task-lifecycle] -- the except branch runs only when get_running_loop()/create_task raise, before any task exists; a created task is registered with its done-callback below
            task = asyncio.get_running_loop().create_task(self._post(ev))
        except RuntimeError:
            # no running loop (sync context): post blocking, best effort
            asyncio.run(self._post(ev))
            return None
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    @staticmethod
    def _journey_extra(journey: dict | None) -> dict:
        """``journey``: the agent's ``{"journey_id", "leg"}`` binding,
        flattened into the event's correlation fields."""
        if not journey:
            return {}
        return {"journey_id": journey.get("journey_id"), "journey_leg": journey.get("leg")}

    def handle_stream_started(self, stream_id: str, room_id: str, journey: dict | None = None):
        return self.send_request("StreamStarted", stream_id, room_id,
                                 **self._journey_extra(journey))

    def handle_stream_ended(self, stream_id: str, room_id: str, journey: dict | None = None):
        return self.send_request("StreamEnded", stream_id, room_id,
                                 **self._journey_extra(journey))

    def handle_stream_migrated(self, stream_id: str, room_id: str, source_agent: str,
                               target_agent: str, reason: str = "",
                               journey: dict | None = None):
        """The router's move notice: the client re-offers echoing the
        journey id and lands on ``target_agent``, where its state waits."""
        return self.send_request("StreamMigrated", stream_id, room_id,
                                 source_agent=source_agent, target_agent=target_agent,
                                 reason=reason, **self._journey_extra(journey))

    def handle_engine_state(self, event_name: str, state: str, reason: str = "", **extra):
        """An engine-guard transition (EngineDegraded / EngineRecovered /
        AgentEvacuating).  The fault domain is the agent, not one stream:
        ``stream_id`` is the reserved ``"engine-guard"``."""
        return self.send_request(event_name, "engine-guard", "", state=state, reason=reason,
                                 **extra)

    def handle_session_state(self, stream_id: str, room_id: str, state: str, reason: str,
                             flight_snapshot_id: str | None = None,
                             recent_events: list | None = None,
                             journey: dict | None = None):
        """A supervisor transition: StreamRecovered on a return to HEALTHY,
        StreamDegraded (with the new state) otherwise; the journey's key
        rides either."""
        name = "StreamRecovered" if state == "HEALTHY" else "StreamDegraded"
        extra = {"state": state, "reason": reason}
        if name == "StreamDegraded":
            if flight_snapshot_id is not None:
                extra["flight_snapshot_id"] = flight_snapshot_id
            if recent_events:
                extra["recent_events"] = recent_events
        extra.update(self._journey_extra(journey))
        return self.send_request(name, stream_id, room_id, **extra)
