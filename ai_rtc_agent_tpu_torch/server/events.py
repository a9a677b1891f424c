"""Stream lifecycle webhooks (counterpart of ai_rtc_agent_tpu/server/events.py).

The started and ended events, posted as JSON with a bearer token to
``WEBHOOK_URL`` (``AUTH_TOKEN``), fire-and-forget on the event loop so a
slow endpoint never stalls the media path.  The events are plain
dataclasses whose ``asdict`` equals the JAX package's pydantic dump;
``aiohttp`` is imported only when a webhook is posted.  The degraded,
recovered, migrated, engine and evacuating events come with supervision
and migration.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time

from ..utils import env

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class WebhookEvent:
    """``journey_id``/``journey_leg`` are the fleet's correlation key; None
    on a single-process deployment (the port has no fleet yet)."""

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


EVENTS = {"StreamStarted": StreamStartedEvent, "StreamEnded": StreamEndedEvent}


class StreamEventHandler:
    def __init__(self, session_factory=None):
        """``session_factory`` returns an object with an async ``post(url,
        headers=, json=)`` in place of an aiohttp session."""
        self.webhook_url = env.get_str("WEBHOOK_URL")
        self.token = env.get_str("AUTH_TOKEN")
        self._session_factory = session_factory
        self._tasks: set = set()

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

    def send_request(self, event_name: str, stream_id: str, room_id: str):
        """Fire-and-forget; returns the task (or None when unconfigured)."""
        if self.webhook_url is None or self.token is None:
            return None
        cls = EVENTS.get(event_name)
        if cls is None:
            raise ValueError(f"unknown event: {event_name}")
        ev = cls(stream_id=stream_id, room_id=room_id, timestamp=int(time.time()))
        try:
            task = asyncio.get_running_loop().create_task(self._post(ev))
        except RuntimeError:
            # no running loop (sync context): post blocking, best effort
            asyncio.run(self._post(ev))
            return None
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    def handle_stream_started(self, stream_id: str, room_id: str):
        return self.send_request("StreamStarted", stream_id, room_id)

    def handle_stream_ended(self, stream_id: str, room_id: str):
        return self.send_request("StreamEnded", stream_id, room_id)
