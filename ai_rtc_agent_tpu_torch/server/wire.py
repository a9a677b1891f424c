"""The HTTP header names of the serving seam's wire contract (counterpart of
ai_rtc_agent_tpu/server/wire.py; the journey and migration headers come
with the slices that send them)."""

from __future__ import annotations

STREAM_ID = "X-Stream-Id"  # /offer answer: the agent's server-side session id
LOCATION = "Location"  # WHIP/WHEP answer: /whip/<session>, /whep/<session>
RETRY_AFTER = "Retry-After"  # every 503 carries one
