"""The HTTP header names of the serving seam's wire contract (counterpart of
ai_rtc_agent_tpu/server/wire.py): every header that crosses a process
boundary (router -> agent forwarding, agent -> client answers, worker ->
router publishes) is named here and nowhere else."""

from __future__ import annotations

# correlation and identity (fleet/journey.py)
JOURNEY_ID = "X-Journey-Id"  # router-minted per placed session
JOURNEY_LEG = "X-Journey-Leg"  # 1-based hop count within a journey
STREAM_ID = "X-Stream-Id"  # /offer answer: the agent's server-side session id
MIGRATED_SESSION = "X-Migrated-Session"  # the adoption token of a migrated client's re-offer

# standard names with this system's semantics
RETRY_AFTER = "Retry-After"  # every 503 carries one
LOCATION = "Location"  # WHIP/WHEP answer: /whip/<session>, /whep/<session>

#: response headers the fleet router carries back through its proxy verbatim
PASS_HEADERS = (
    "Content-Type", LOCATION, RETRY_AFTER, STREAM_ID,
    JOURNEY_ID, JOURNEY_LEG,
)
