"""Fleet-wide session journeys: cross-process trace correlation (counterpart
of ai_rtc_agent_tpu/fleet/journey.py).

One **journey** per placed session, minted at placement by the router,
carried to the agents as the ``X-Journey-Id`` / ``X-Journey-Leg``
headers, and recorded here as a bounded event ring per journey from which
the incident-bundle endpoint (``GET /fleet/debug/journey/<id>``) assembles
the whole story.

* a **leg** is one placement: leg 1 the original /offer, /whip or /whep,
  leg 2 the re-placement after a crash, a migration or a recycle (the
  client's re-offer echoes the journey id and the router increments it);
* **evidence** is an agent-side capture pulled over
  ``GET /debug/flight?journey=`` when a breach webhook arrives, stored
  here so that it survives the agent;
* a **bundle** is the sealed incident record (ring and evidence) frozen
  on the alert paths (AGENT_DEAD, a breach volley).

The journey id is never a metric label: ``/metrics`` carries aggregate
counters and the placement -> first-frame percentiles only.  Knobs:
``JOURNEY_ENABLE``, ``JOURNEY_MAX``, ``JOURNEY_RING``,
``JOURNEY_EVIDENCE``, ``JOURNEY_BUNDLES``.
"""

from __future__ import annotations

import collections
import time
import uuid

from ..utils import env

# closed enum: every kind a journey ring entry may carry (rollup
# counters use literal names; the id itself never labels a metric)
JOURNEY_EVENTS = (
    "placed",        # leg 1 landed on an agent
    "re_placed",     # leg N>1 landed (crash replacement)
    "agent_503",     # an agent's admission gate refused mid-placement
    "rejected",      # the whole fleet refused a continuation re-offer
    "started",       # StreamStarted webhook arrived (first-frame proxy)
    "degraded",      # StreamDegraded-family breach webhook arrived
    "agent_dead",    # the serving agent was declared DEAD
    "migrated",      # state moved to another agent (drain-as-move /
                     # crash restore) — the re-offer continues as leg+1
    "migrate_failed",  # a migration attempt aborted; the source keeps
                       # serving (kill-drain semantics take over)
    "recycled",      # the serving agent restarted in place: state parked
                     # on the SAME box, the re-offer re-adopts as leg+1
    "upgraded",      # the session moved as a rolling-upgrade sweep step
    "scaled",        # the session moved because the autoscaler retired
                     # its (emptiest) agent
    "evacuated",     # the session moved because its agent's engine guard
                     # exhausted rebuilds (POST /fleet/evacuate)
    "ended",         # StreamEnded webhook arrived
    "evidence",      # an agent-side capture was stored
    "bundle",        # the journey was sealed into the incident store
)


class _Journey:
    """One journey's record: legs + bounded event ring + evidence."""

    __slots__ = ("journey_id", "created_at", "legs", "events", "evidence")

    def __init__(self, journey_id: str, ring: int, evidence: int,
                 created_at: float):
        self.journey_id = journey_id
        self.created_at = created_at
        self.legs: list = []  # {"leg","agent","stream_id","kind","room_id","placed_at"}
        self.events: collections.deque = collections.deque(maxlen=ring)
        self.evidence: collections.deque = collections.deque(maxlen=evidence)


class JourneyLog:
    """Bounded per-session journey records + the sealed-bundle store.

    All mutation happens on the router's event loop (the one writer);
    the bench's synthetic load is single-threaded too, so no lock —
    the hot ``note()`` path is one enabled-check + one dict get + one
    bounded-deque append."""

    def __init__(self, stats=None, clock=time.time):
        self.enabled = env.journey_enabled()
        self.max_journeys = max(1, env.get_int("JOURNEY_MAX", 1024))
        self.ring = max(1, env.get_int("JOURNEY_RING", 64))
        self.evidence_bound = max(1, env.get_int("JOURNEY_EVIDENCE", 4))
        self.stats = stats
        self._clock = clock
        self._j: dict = {}          # journey_id -> _Journey (insertion order)
        self._by_stream: dict = {}  # stream_id -> journey_id
        self.bundles: collections.deque = collections.deque(
            maxlen=max(1, env.get_int("JOURNEY_BUNDLES", 8))
        )
        # aggregate rollup (the only thing /metrics ever sees)
        self.journeys_total = 0
        self.legs_total = 0
        self.replacements_total = 0
        self.events_total = 0
        self.evicted_total = 0
        self.evidence_total = 0
        self.bundles_total = 0
        self.started_total = 0
        self._place_to_start_ms: collections.deque = collections.deque(
            maxlen=512
        )

    # -- identity --------------------------------------------------------------

    def mint(self) -> str:
        """A fresh journey id.  The record itself is created lazily at
        the first successful placement (:meth:`place`), so a rejected
        burst cannot evict real journeys from the bounded table."""
        return f"j-{uuid.uuid4().hex[:12]}"

    def known(self, journey_id: str | None) -> bool:
        return bool(journey_id) and journey_id in self._j

    def next_leg(self, journey_id: str) -> int:
        rec = self._j.get(journey_id)
        return 1 if rec is None else len(rec.legs) + 1

    def journey_for_stream(self, stream_id: str) -> str | None:
        return self._by_stream.get(stream_id)

    def last_agent(self, journey_id: str) -> str | None:
        """The agent serving the journey's most recent leg — the
        authoritative attribution when a breach webhook's stream was
        already evicted from the router's bounded session table."""
        rec = self._j.get(journey_id)
        if rec is None or not rec.legs:
            return None
        return rec.legs[-1]["agent"]

    # -- recording -------------------------------------------------------------

    def place(self, journey_id: str, agent_id: str, stream_id: str,
              kind: str, room_id: str = "", retried: int = 0,
              leg: int | None = None) -> int:
        """One successful placement; -> the leg number it became.
        Creates the journey record on leg 1 (evicting the oldest when
        the bounded table is full).  ``leg``: the number the router
        already forwarded to the agent (computed before the proxy
        await) — honoring it keeps the record consistent with what the
        agent's recorder was told even when concurrent re-offers or a
        table eviction raced the placement; None computes it here."""
        if not self.enabled:
            return 1
        now = self._clock()
        rec = self._j.get(journey_id)
        if rec is None:
            while len(self._j) >= self.max_journeys:
                old = self._j.pop(next(iter(self._j)))
                for old_leg in old.legs:
                    self._by_stream.pop(old_leg["stream_id"], None)
                self.evicted_total += 1
            rec = self._j[journey_id] = _Journey(
                journey_id, self.ring, self.evidence_bound, round(now, 3)
            )
            self.journeys_total += 1
        leg_n = len(rec.legs) + 1 if leg is None else leg
        rec.legs.append({
            "leg": leg_n, "agent": agent_id, "stream_id": stream_id,
            "kind": kind, "room_id": room_id, "placed_at": round(now, 3),
        })
        self.legs_total += 1
        self._by_stream[stream_id] = journey_id
        kind_ev = "placed" if leg_n == 1 else "re_placed"
        if leg_n > 1:
            self.replacements_total += 1
        data = {"agent": agent_id, "leg": leg_n, "stream_id": stream_id}
        if retried:
            data["retried"] = retried
        self.note(journey_id, kind_ev, **data)
        return leg_n

    def note(self, journey_id: str, kind: str, **data):
        """One ring entry (wall-clock stamped).  The router's per-request
        hot hook: with the plane disabled this is a single attribute
        read; for an unknown journey it is one dict get."""
        if not self.enabled:
            return
        if kind not in JOURNEY_EVENTS:
            # a typo'd kind is a programming error, not telemetry —
            # failing here keeps the enum genuinely closed (metric
            # rollups and the runbook enumerate exactly these)
            raise ValueError(f"unknown journey event kind {kind!r}")
        rec = self._j.get(journey_id)
        if rec is None:
            return
        entry = {"t": round(self._clock(), 3), "kind": kind}
        entry.update(data)
        rec.events.append(entry)
        self.events_total += 1

    def note_started(self, stream_id: str):
        """StreamStarted webhook ingest: the placement→first-frame
        latency sample (placed_at of the leg that owns this stream)."""
        jid = self._by_stream.get(stream_id)
        rec = self._j.get(jid) if jid else None
        if rec is None:
            return
        now = self._clock()
        for leg in reversed(rec.legs):
            if leg["stream_id"] == stream_id:
                dt_ms = max(0.0, 1e3 * (now - leg["placed_at"]))
                self._place_to_start_ms.append(dt_ms)
                self.started_total += 1
                self.note(jid, "started", leg=leg["leg"],
                          place_to_start_ms=round(dt_ms, 1))
                return

    def end_stream(self, stream_id: str):
        """StreamEnded ingest: the leg is over; the journey record stays
        (bounded table) so a post-mortem GET still tells the story."""
        jid = self._by_stream.pop(stream_id, None)
        if jid is not None:
            self.note(jid, "ended", stream_id=stream_id)

    # -- evidence + bundles ----------------------------------------------------

    def add_evidence(self, journey_id: str, agent_id: str, fragment: dict):
        """Store one agent-side capture (``/debug/flight?journey=``
        body) against the journey — pulled the moment a breach webhook
        arrives, so the records survive the agent's later corpse."""
        rec = self._j.get(journey_id)
        if rec is None or not self.enabled:
            return
        rec.evidence.append({
            "captured_at": round(self._clock(), 3),
            "agent": agent_id,
            "fragment": fragment,
        })
        self.evidence_total += 1
        self.note(journey_id, "evidence", agent=agent_id)

    def seal_bundle(self, journey_id: str, reason: str) -> dict | None:
        """Freeze the journey (ring + evidence) into the bounded
        incident store — the alert-path auto-capture.  One bundle per
        journey: a re-seal REPLACES the journey's earlier bundle (the
        newer ring subsumes it), so a flapping session's breach volleys
        cannot evict OTHER journeys' only incident record from the
        bounded store."""
        rec = self._j.get(journey_id)
        if rec is None or not self.enabled:
            return None
        self.note(journey_id, "bundle", reason=reason)
        bundle = {
            "journey_id": journey_id,
            "reason": reason,
            "sealed_at": round(self._clock(), 3),
            "journey": self._snap(rec),
            "evidence": list(rec.evidence),
        }
        stale = [b for b in self.bundles if b["journey_id"] == journey_id]
        for b in stale:
            self.bundles.remove(b)
        self.bundles.append(bundle)
        self.bundles_total += 1
        if self.stats is not None:
            self.stats.count("journey_bundles_sealed")
        return bundle

    # -- reads -----------------------------------------------------------------

    def _snap(self, rec: _Journey) -> dict:
        return {
            "journey_id": rec.journey_id,
            "created_at": rec.created_at,
            "legs": [dict(leg) for leg in rec.legs],
            "events": [dict(e) for e in rec.events],
        }

    def get(self, journey_id: str) -> dict | None:
        rec = self._j.get(journey_id)
        return None if rec is None else self._snap(rec)

    def evidence_for(self, journey_id: str) -> list:
        rec = self._j.get(journey_id)
        return [] if rec is None else list(rec.evidence)

    def bundles_for(self, journey_id: str) -> list:
        return [b for b in list(self.bundles)
                if b["journey_id"] == journey_id]

    def index(self) -> dict:
        """The ``GET /fleet/debug/journeys`` directory listing."""
        return {
            "journeys": [
                {
                    "journey_id": rec.journey_id,
                    "created_at": rec.created_at,
                    "legs": len(rec.legs),
                    "agents": sorted({leg["agent"] for leg in rec.legs}),
                    "events": len(rec.events),
                    "evidence": len(rec.evidence),
                }
                for rec in self._j.values()
            ],
            "bundles": [
                {
                    "journey_id": b["journey_id"],
                    "reason": b["reason"],
                    "sealed_at": b["sealed_at"],
                }
                for b in list(self.bundles)
            ],
        }

    def snapshot(self) -> dict:
        """Aggregate-only /metrics gauges — the journey id never appears
        (metric-cardinality discipline; per-journey detail is the JSON
        debug endpoint)."""
        out = {
            "journeys_tracked": len(self._j),
            "journeys_total": self.journeys_total,
            "journey_legs_total": self.legs_total,
            "journey_replacements_total": self.replacements_total,
            "journey_events_total": self.events_total,
            "journeys_evicted_total": self.evicted_total,
            "journey_evidence_captured_total": self.evidence_total,
            "journey_bundles_sealed_total": self.bundles_total,
            "journey_bundles_stored": len(self.bundles),
            "journey_started_total": self.started_total,
            "journey_place_to_start_ms_p50": None,
            "journey_place_to_start_ms_p95": None,
            "journey_place_to_start_ms_p99": None,
        }
        samples = sorted(self._place_to_start_ms)
        if samples:
            n = len(samples)
            out["journey_place_to_start_ms_p50"] = round(samples[n // 2], 1)
            out["journey_place_to_start_ms_p95"] = round(
                samples[min(n - 1, int(n * 0.95))], 1
            )
            out["journey_place_to_start_ms_p99"] = round(
                samples[min(n - 1, int(n * 0.99))], 1
            )
        return out
