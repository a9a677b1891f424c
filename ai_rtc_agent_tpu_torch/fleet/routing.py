"""The fleet router's core, with no web framework (counterpart of
ai_rtc_agent_tpu/fleet/router.py, which keeps it inside its aiohttp
handlers; here it is split out as ``server/sessions.py`` is split from
``server/agent.py``, so that ``chip_smoke.py`` drives the fleet on the
card, where aiohttp is not installed).

Each route is ``async def handler(app, req: Request) -> Reply`` over a
router app-state mapping (an aiohttp ``Application`` or a plain dict,
filled by :func:`configure`); every call to an agent goes through the
app-state's transport (fleet/transport.py: aiohttp, or agents in this
process).  ``fleet/router.py`` serves :data:`ROUTES` over HTTP;
:func:`handle` calls one in-process.

  POST /offer | /whip | /whep    place onto the least-loaded healthy agent
                                 and proxy the signaling exchange (a
                                 journey id minted or continued; a
                                 migrated journey's re-offer pinned to the
                                 agent that holds its imported state)
  DELETE /whip/{s} | /whep/{s}   routed back to the owning agent
  POST /fleet/register           the worker sidecar's publish target
  POST /fleet/events             webhook ingest (journeys, breaches,
                                 AGENT_RECYCLED re-pins, StreamEnded)
  POST /fleet/drain?agent=ID     drain through the agent's admission-freeze
                                 rung; ``&mode=migrate`` moves each session
                                 (export -> import -> StreamMigrated ->
                                 pinned re-offer), ``&action=cancel`` reverts
  POST /fleet/evacuate           an agent whose rebuild is exhausted: FAILED,
                                 and its sessions migrate-placed elsewhere
  POST /fleet/upgrade            rolling restart in place, one agent at a time
  GET  /fleet/health             per-agent membership view
  GET  /fleet/debug/journeys     tracked journeys and sealed bundles
  GET  /fleet/debug/journey/{id} one incident bundle (``?format=chrome``)
  GET  /metrics                  the fleet rollup (``?format=prom``)

Placement: the agent's own counted admission reservation decides; an
agent's 503 opens a Retry-After backoff for that agent and the request is
re-placed at most ``FLEET_PLACE_ATTEMPTS`` agents deep; a fleet-wide
refusal is one 503 with the soonest Retry-After.  A DEAD agent's sessions
are re-pointed through AGENT_DEAD webhooks, or restored from a recent
banked export (crash restore).
"""

from __future__ import annotations

import asyncio
import collections
import json
import logging
import time
import uuid
from dataclasses import dataclass, field

from ..resilience.retry import RetryError, RetryPolicy
from ..server import wire
from ..server.events import StreamEventHandler
from ..utils import env
from ..utils.profiling import FrameStats
from .journey import JourneyLog
from .registry import AutoscaleController, FleetPoller, FleetRegistry
from .transport import AiohttpTransport, Headers, TransportError


@dataclass
class Request:
    """One request to the router: what a handler reads of it."""

    method: str = "GET"
    query: dict = field(default_factory=dict)
    headers: Headers = field(default_factory=Headers)
    body: bytes = b""
    match_info: dict = field(default_factory=dict)

    def json(self):
        """The body as JSON; ``ValueError`` when it is not."""
        return json.loads(self.body.decode("utf-8"))


@dataclass
class Reply:
    """A handler's answer: a text body (str), raw bytes (a proxied agent
    answer, the Prometheus text) or none; ``content_type`` None is plain
    text for a str body."""

    status: int = 200
    body: bytes | str | None = None
    content_type: str | None = None
    headers: dict = field(default_factory=dict)


def _json_reply(data, status: int = 200) -> Reply:
    return Reply(status, json.dumps(data), "application/json")


logger = logging.getLogger(__name__)

def _refuse_503(text: str, retry_after: float) -> Reply:
    """The router's ONE refusal constructor: every fleet-side 503 carries
    a Retry-After so clients back off instead of hammering (the same
    contract the agent's ``_overloaded_response`` holds — enforced by the
    refusal-discipline checker on both planes)."""
    return Reply(
        503,
        text,
        headers={wire.RETRY_AFTER: str(max(1, int(round(retry_after))))},
    )


def _parse_retry_after(value: str | None) -> float | None:
    if not value:
        return None
    try:
        return max(0.0, float(value))
    except ValueError:
        return None  # HTTP-date form — the fleet's own agents never send it


def _session_from_location(location: str | None) -> str | None:
    """WHIP/WHEP answers carry ``Location: /whip/<session>``."""
    if not location:
        return None
    tail = location.rstrip("/").rsplit("/", 1)[-1]
    return tail or None


class _SessionTable:
    """Bounded stream-id -> placement map (insertion-ordered dict with
    oldest-first eviction): DELETE routing and crash replacement both
    need to know which agent owns a session, and the table must not
    grow without limit under session churn."""

    def __init__(self, bound: int):
        self.bound = max(1, bound)
        self._m: dict[str, dict] = {}
        self.evicted = 0

    def remember(self, stream_id: str, agent_id: str, room_id: str,
                 kind: str, journey_id: str | None = None, leg: int = 1,
                 epoch: int | None = None):
        self._m.pop(stream_id, None)
        while len(self._m) >= self.bound:
            self._m.pop(next(iter(self._m)))
            self.evicted += 1
        self._m[stream_id] = {
            "agent": agent_id, "room_id": room_id, "kind": kind,
            "journey_id": journey_id, "leg": leg,
            # the owning record's epoch AT PLACEMENT: a webhook whose
            # entry epoch no longer matches the record is the OLD
            # process talking about a superseded placement
            "epoch": epoch,
        }

    def owner(self, stream_id: str) -> str | None:
        entry = self._m.get(stream_id)
        return entry["agent"] if entry else None

    def newest_of_kind(self, kind: str) -> tuple[str, dict] | None:
        """Most recently placed session of ``kind`` (insertion order IS
        recency here) — the broadcast tier resolves 'which agent owns the
        live publisher' with this."""
        for sid in reversed(list(self._m)):
            e = self._m[sid]
            if e["kind"] == kind:
                return sid, dict(e)
        return None

    def entry(self, stream_id: str) -> dict | None:
        return self._m.get(stream_id)

    def sessions_of(self, agent_id: str) -> list[tuple[str, dict]]:
        """Non-destructive twin of :meth:`pop_agent_sessions` — the
        migrate-drain sweep reads the worklist while the SOURCE keeps
        every mapping until its sessions actually move or end."""
        return [
            (sid, dict(e)) for sid, e in self._m.items()
            if e["agent"] == agent_id
        ]

    def forget(self, stream_id: str):
        self._m.pop(stream_id, None)

    def pop_agent_sessions(self, agent_id: str) -> list[tuple[str, dict]]:
        dead = [(sid, e) for sid, e in self._m.items()
                if e["agent"] == agent_id]
        for sid, _ in dead:
            self._m.pop(sid, None)
        return dead

    def __len__(self):
        return len(self._m)


# ---------------------------------------------------------------------------
# handlers
# ---------------------------------------------------------------------------

async def _place_and_proxy(app, req: Request, path: str,
                           kind: str, pin=None) -> Reply:
    """``pin``: a caller-chosen first-attempt agent (the broadcast tier's
    edge placement) — tried before the registry's pick, with the normal
    503/unreachable fallback walk behind it.  A migration pin (imported
    stream state) outranks it: only that target holds the session."""
    reg: FleetRegistry = app["fleet"]
    stats: FrameStats = app["stats"]
    body = req.body
    headers = {}
    ct = req.headers.get("Content-Type")
    if ct:
        headers["Content-Type"] = ct
    room_id = ""
    if kind == "offer":
        try:  # best-effort: the webhook re-point wants the room id
            room_id = str(json.loads(body.decode()).get("room_id", ""))
        except (ValueError, AttributeError, UnicodeDecodeError):
            room_id = ""

    # journey correlation (fleet/journey.py): mint one id per placed
    # session, or — when the client echoes a KNOWN X-Journey-Id (the
    # crash-replacement re-offer, taught by the AGENT_DEAD webhook) —
    # continue that journey with an incremented leg so the survivor's
    # records join the dead agent's.  An unknown echoed id is ignored
    # (a client cannot graft itself onto ring state it never had).
    journeys: JourneyLog | None = app["journeys"]
    journey_id = None
    leg = 1
    pinned = pin
    if journeys is not None:
        echoed = req.headers.get(wire.JOURNEY_ID)
        if journeys.known(echoed):
            journey_id = echoed
            leg = journeys.next_leg(echoed)
            # a migrated journey's re-offer is PINNED to the agent that
            # already holds its imported stream state: the adoption
            # token rides the forwarded headers and the agent resumes
            # the session mid-stream instead of claiming fresh.  The pin
            # is one-shot — consumed here whether or not the attempt
            # lands (the target's unadopted import expires on its TTL).
            mig = app["migrations"].pop(echoed, None)
            if mig is not None and (
                time.monotonic() - mig["ts"] <= _PIN_TTL_S
            ):
                cand = reg.agents.get(mig["target"])
                if cand is not None and cand.state != "DEAD":
                    pinned = cand
                    headers[wire.MIGRATED_SESSION] = mig["token"]
        else:
            journey_id = journeys.mint()
        headers[wire.JOURNEY_ID] = journey_id
        headers[wire.JOURNEY_LEG] = str(leg)

    tried: set = set()
    hint: float | None = None
    for _ in range(app["place_attempts"]):
        if pinned is not None:
            rec, pinned = pinned, None
        else:
            # only the pinned target holds the imported state — every
            # fallback placement must claim fresh, not adopt
            headers.pop(wire.MIGRATED_SESSION, None)
            rec = reg.pick(exclude=tried)
        if rec is None:
            break
        tried.add(rec.agent_id)
        try:
            resp = await app["http"].request(
                "POST", rec.base_url + path, data=body, headers=headers
            )
        except TransportError as e:
            # connection refused / reset mid-exchange: the same evidence
            # a failed poll gives — count it toward DEAD and move on
            logger.warning("proxy to %s failed: %s", rec.agent_id, e)
            reg.note_poll_fail(rec)
            continue
        payload = resp.body
        if resp.status == 503:
            # the agent's counted admission gate refused — honor
            # ITS hint before this agent is ever offered again,
            # then re-place on the next-best agent
            ra = _parse_retry_after(resp.headers.get(wire.RETRY_AFTER))
            if ra is None:
                ra = rec.retry_after_s or app["retry_after_s"]
            rec.saturated = True
            rec.backoff(ra, reg.now())
            hint = ra if hint is None else min(hint, ra)
            stats.count("fleet_placement_retries")
            if journeys is not None:
                # a continuation's refusal belongs in its ring
                # (fresh journeys have no record yet — minted
                # ids only materialize at a placement)
                journeys.note(
                    journey_id, "agent_503",
                    agent=rec.agent_id, retry_after=ra,
                )
            continue
        if 200 <= resp.status < 300:
            reg.note_placed(rec)
            sid = resp.headers.get(wire.STREAM_ID) or (
                _session_from_location(resp.headers.get(wire.LOCATION))
            )
            if sid:
                app["session_table"].remember(
                    sid, rec.agent_id, room_id, kind,
                    journey_id=journey_id, leg=leg,
                    epoch=rec.epoch,
                )
                if journeys is not None:
                    # the SAME leg number the agent was told in
                    # the forwarded header — concurrent
                    # re-offers or a table eviction racing the
                    # proxy await must not desync the record
                    # from the agent-side recorder bindings
                    journeys.place(
                        journey_id, rec.agent_id, sid, kind,
                        room_id, retried=len(tried) - 1, leg=leg,
                    )
        out_headers = {
            k: resp.headers[k]
            for k in wire.PASS_HEADERS if k in resp.headers
        }
        if journey_id is not None and 200 <= resp.status < 300:
            # stamp even when the agent tier predates the echo
            out_headers.setdefault(wire.JOURNEY_ID, journey_id)
            out_headers.setdefault(wire.JOURNEY_LEG, str(leg))
        return Reply(resp.status, payload, None, out_headers)
    stats.count("fleet_rejects")
    if journeys is not None and journeys.known(journey_id):
        journeys.note(journey_id, "rejected")
    retry = hint if hint is not None else reg.retry_after_hint(
        app["retry_after_s"]
    )
    return _refuse_503("fleet saturated", retry)


async def offer(app, req: Request) -> Reply:
    return await _place_and_proxy(app, req, "/offer", "offer")


async def whip(app, req: Request) -> Reply:
    if req.method == "DELETE":
        return await _routed_delete(app, req, "/whip")
    return await _place_and_proxy(app, req, "/whip", "whip")


async def _edge_pull_pin(app) -> object | None:
    """Two-level fan-out placement: pick a NON-owner edge for
    the next viewer leg and make sure it is pulling ONE copy of the
    publisher's stream (``POST /broadcast/pull`` is idempotent on the
    agent).  Returns the record to pin the placement to, or None for the
    plain registry walk.  Failures fall back to the owner — a viewer on
    the owning agent is always correct, just not scaled out."""
    reg: FleetRegistry = app["fleet"]
    stats: FrameStats = app["stats"]
    newest = app["session_table"].newest_of_kind("whip")
    if newest is None:
        return None
    owner = reg.agents.get(newest[1]["agent"])
    if owner is None or owner.state == "DEAD":
        return None
    edge = reg.pick(exclude={owner.agent_id})
    if edge is None:
        return owner  # single-agent fleet: every viewer is local
    try:
        resp = await app["http"].request(
            "POST", edge.base_url + "/broadcast/pull",
            json={"owner_url": owner.base_url},
        )
        if 200 <= resp.status < 300:
            stats.count("fleet_edge_pulls")
            return edge
        # 409 = fan-out/edge-pull disabled on the agent; anything
        # else = pull setup failed — either way the owner serves
        stats.count("fleet_edge_pull_refused")
    except TransportError as e:
        logger.warning("edge pull via %s failed: %s", edge.agent_id, e)
        stats.count("fleet_edge_pull_failures")
        reg.note_poll_fail(edge)
    return owner


async def whep(app, req: Request) -> Reply:
    if req.method == "DELETE":
        return await _routed_delete(app, req, "/whep")
    pin = None
    if env.broadcast_edge_pull_enabled():
        pin = await _edge_pull_pin(app)
    return await _place_and_proxy(app, req, "/whep", "whep", pin=pin)


async def _routed_delete(app, req: Request, path: str) -> Reply:
    session = req.match_info.get("session")
    if not session:
        return Reply(400, "session-scoped DELETE only at the router")
    table: _SessionTable = app["session_table"]
    agent_id = table.owner(session)
    rec = app["fleet"].agents.get(agent_id) if agent_id else None
    if rec is None:
        return Reply(404, "unknown session")
    try:
        resp = await app["http"].request("DELETE", f"{rec.base_url}{path}/{session}")
        payload = resp.body
        if resp.status < 500:
            # 2xx: torn down; 404: the agent no longer knows it —
            # either way the mapping is dead.  A transient agent
            # 5xx must NOT drop it, or the client's retry DELETE
            # 404s here and the session leaks from crash re-point
            # coverage too.
            table.forget(session)
        return Reply(resp.status, payload)
    except TransportError as e:
        return Reply(502, f"agent unreachable: {e}")


async def fleet_register(app, req: Request) -> Reply:
    """The worker sidecar's publish target: a 2xx here IS the publish
    succeeding (server/worker.py treats 4xx as terminal, 5xx/timeouts as
    retryable — a full registry answers 503 accordingly)."""
    try:
        info = req.json()
    except (ValueError, LookupError):
        return Reply(400, "invalid JSON body")
    if not isinstance(info, dict):
        return Reply(400, "publish must be an object")
    try:
        rec = app["fleet"].register(info)
    except ValueError as e:
        return Reply(400, str(e))
    if rec is None:
        return _refuse_503("registry full", app["retry_after_s"])
    return _json_reply(
        {"agent_id": rec.agent_id, "agents": len(app["fleet"].agents)}
    )


async def fleet_events(app, req: Request) -> Reply:
    """Webhook ingest: agents point WEBHOOK_URL here.  The bearer token
    is checked when the router has one configured (same AUTH_TOKEN the
    agents sign with); session ownership resolves through the session
    table — an unattributable event still counts in the rollup."""
    handler: StreamEventHandler = app["fleet_events"]
    if handler.token:
        auth = req.headers.get("Authorization", "")
        if auth != f"Bearer {handler.token}":
            return Reply(401, "bad token")
    try:
        event = req.json()
    except (ValueError, LookupError):
        return Reply(400, "invalid JSON body")
    if not isinstance(event, dict):
        return Reply(400, "event must be an object")
    stream_id = str(event.get("stream_id", ""))
    entry = app["session_table"].entry(stream_id)
    agent_id = entry["agent"] if entry else None
    state = str(event.get("state", ""))
    recycled = (
        event.get("event") == "StreamDegraded" and state == "AGENT_RECYCLED"
    )
    rec = app["fleet"].agents.get(agent_id) if agent_id else None
    if (entry is not None and rec is not None
            and entry.get("epoch") is not None
            and entry["epoch"] != rec.epoch and not recycled):
        # the placement predates the record's current epoch: this webhook
        # was minted by the process the registry has since superseded
        # (recycle/revival) — reading it as the NEW process's evidence is
        # the old-process-ghost shape.  AGENT_RECYCLED is exempt: only
        # the NEW process ever announces the swap itself.
        app["fleet"].note_stale_epoch()
        return Reply(200, "OK")
    breach_state = app["fleet"].ingest_event(event, agent_id)
    _journey_ingest(app, event, stream_id, agent_id, breach_state)
    if recycled:
        _recycled_ingest(app, event, stream_id, agent_id, entry)
    if event.get("event") == "StreamEnded":
        # the session is gone on the agent — keeping the mapping would
        # send spurious AGENT_DEAD re-points to long-idle clients and
        # crowd live sessions out of the bounded table under churn
        app["session_table"].forget(stream_id)
        # its banked migration snapshot is dead weight too (and must
        # never crash-restore a stream the client already ended)
        app["snapshot_bank"].pop(stream_id, None)
    return Reply(200, "OK")


def _journey_ingest(app, event: dict, stream_id: str,
                    agent_id: str | None, breach_state: str | None):
    """Thread one ingested webhook into the journey ring — and on a
    breach volley, auto-capture the owning agent's evidence NOW (the
    one moment the records are guaranteed still alive; an agent that
    later dies by SIGKILL gives no second chance)."""
    journeys: JourneyLog | None = app["journeys"]
    if journeys is None:
        return
    # the webhook carries the journey id once the agent tier threads it;
    # the session table resolves legacy payloads
    jid = str(event.get("journey_id") or "") or journeys.journey_for_stream(
        stream_id
    )
    if not journeys.known(jid):
        return
    name = event.get("event")
    if name == "StreamStarted":
        journeys.note_started(stream_id)
        return
    if name == "StreamEnded":
        journeys.end_stream(stream_id)
        return
    if breach_state is not None:
        journeys.note(jid, "degraded", state=breach_state,
                      stream_id=stream_id)
        # session-table attribution first; the journey's own last leg is
        # the authoritative fallback (a long-lived stream can have been
        # evicted from the bounded table — its breach must still capture)
        owner = agent_id or journeys.last_agent(jid)
        if owner is not None:
            _capture_evidence(
                app, jid, owner, seal_reason=f"breach {breach_state}"
            )


def _recycled_ingest(app, event: dict, stream_id: str,
                     agent_id: str | None, entry: dict | None):
    """An AGENT_RECYCLED announce from a restart-in-place replacement
    (server/agent.py ``_import_handoff``): the predecessor's session is
    parked on the SAME box under the deterministic token
    ``rcy-<stream-id>``.  Pin the journey's next re-offer there with
    that token, ring the ``recycled`` kind, re-point the client
    (AGENT_RECYCLED rides the same StreamDegraded webhook plane as
    AGENT_DEAD — deliberately NOT a breach: recycling is not an
    incident), and drop the old placement row (the re-offer mints a
    fresh stream id)."""
    journeys: JourneyLog | None = app["journeys"]
    jid = str(event.get("journey_id") or "")
    if journeys is not None and not journeys.known(jid):
        jid = journeys.journey_for_stream(stream_id)
    owner = agent_id
    if owner is None and journeys is not None and journeys.known(jid):
        owner = journeys.last_agent(jid)
    if journeys is not None and journeys.known(jid):
        if owner is not None:
            _remember_bounded(app["migrations"], jid, {
                "target": owner, "token": f"rcy-{stream_id}",
                "ts": time.monotonic(),
            })
        journeys.note(jid, "recycled", agent=owner or "",
                      stream_id=stream_id)
    app["stats"].count("fleet_recycled_sessions")
    leg = entry.get("leg", 1) if entry else 1
    room_id = entry.get("room_id", "") if entry else ""
    app["fleet_events"].handle_session_state(
        stream_id, room_id, "AGENT_RECYCLED",
        "agent recycled in place — re-offer through the router to "
        "resume on the same box",
        journey=({"journey_id": jid, "leg": leg} if jid else None),
    )
    # the replacement parked the session under a NEW adoption token; the
    # re-offer creates a fresh placement row, so the old one is done
    # (keeping it would feed spurious AGENT_DEAD re-points later)
    app["session_table"].forget(stream_id)
    app["snapshot_bank"].pop(stream_id, None)


async def _pull_fragment(app, rec, journey_id: str):
    """ONE pull of an agent's ``/debug/flight?journey=`` fragment —
    the single spelling of the evidence-pull protocol shared by the
    breach-path capture and the bundle endpoint's live fan-out.
    -> (fragment dict | None, error string | None); a 404 is (None,
    None): the agent holds no records for this journey."""
    try:
        resp = await app["http"].request(
            "GET", rec.base_url + "/debug/flight", params={"journey": journey_id}
        )
        if resp.status == 200:
            body = resp.json()
            if isinstance(body, dict):
                return body, None
            return None, "non-object fragment body"
        if resp.status == 404:
            return None, None
        return None, f"HTTP {resp.status}"
    except (TransportError, ValueError) as e:
        return None, str(e)


def _capture_evidence(app, journey_id: str, agent_id: str,
                      seal_reason: str | None = None):
    """Pull the agent's journey fragment into the evidence store
    (fire-and-forget task, bounded in-flight set), then optionally seal
    an incident bundle so the evidence survives even the bounded
    evidence ring's later churn."""
    tasks: set = app["journey_tasks"]
    inflight: set = app["journey_inflight"]
    key = (journey_id, agent_id)
    if key in inflight or len(tasks) >= 16:
        # a breach volley's duplicate pulls (DEGRADED→FAILED→SLO within
        # ms) and capture storms must not fan out redundant HTTP — near-
        # identical fragments would churn the bounded evidence ring out
        # of its DISTINCT captures.  The seal is cheap local work
        # though: freeze the bundle from whatever is banked rather than
        # losing the incident.
        journeys: JourneyLog | None = app["journeys"]
        if seal_reason is not None and journeys is not None:
            journeys.seal_bundle(journey_id, seal_reason)
        return

    async def run():
        journeys: JourneyLog | None = app["journeys"]
        if journeys is None:
            return
        rec = app["fleet"].agents.get(agent_id)
        if rec is not None and rec.state != "DEAD":
            fragment, err = await _pull_fragment(app, rec, journey_id)
            if fragment is not None:
                journeys.add_evidence(journey_id, agent_id, fragment)
            elif err is not None:
                logger.debug("evidence pull from %s failed: %s",
                             agent_id, err)
        # seal even when the pull was impossible (record gone, agent
        # DEAD by the time the task ran): an incident with only banked
        # evidence still beats an incident with no bundle at all
        if seal_reason is not None:
            journeys.seal_bundle(journey_id, seal_reason)

    inflight.add(key)
    task = asyncio.get_running_loop().create_task(run())
    tasks.add(task)

    def _done(t, key=key):
        tasks.discard(t)
        inflight.discard(key)

    task.add_done_callback(_done)


# ---------------------------------------------------------------------------
# live session migration: drain-as-move + crash restore
# ---------------------------------------------------------------------------

# how long a banked snapshot stays "recent" for the crash-restore path
# (not an operator knob: it tracks the migration sweep's own lifetime,
# and a stale stream state is worse than a clean keyframe re-prime)
_SNAPSHOT_BANK_TTL_S = 120.0
_BOUNDED_MAP = 256  # migrations pin table + snapshot bank bound
# a re-offer pin is only honored while the target's parked import can
# still be adopted (server/agent.py _IMPORTED_TTL_S): a stale pin would
# bypass placement's load/health checks to chase a token that already
# expired
_PIN_TTL_S = 30.0


class _MigrateRefused(Exception):
    """4xx from a migration peer — terminal after ONE attempt (the
    retry-4xx rule: a schema/fingerprint refusal cannot succeed on
    retry)."""


class _MigrateTransient(Exception):
    """5xx / connection trouble from a migration peer — retryable."""


def _remember_bounded(d: dict, key, value, bound: int = _BOUNDED_MAP):
    """Insertion-ordered bounded map (the _SessionTable discipline):
    oldest-first eviction so a burst cannot grow router memory."""
    d.pop(key, None)
    while len(d) >= bound:
        d.pop(next(iter(d)))
    d[key] = value


async def _migrate_call(app, method: str, rec, path: str, *,
                        params=None, json_body=None):
    """One migration HTTP exchange riding the shared RetryPolicy:
    bounded per-attempt timeout (the proxy timeout), full-jitter backoff
    on transient trouble, and a 4xx TERMINAL after one attempt.
    -> (body dict | None, error string | None)."""
    policy = RetryPolicy(
        attempts=3, base_delay_s=0.2, max_delay_s=1.0, full_jitter=True
    )

    async def attempt():
        try:
            resp = await app["http"].request(
                method, rec.base_url + path, params=params, json=json_body,
                timeout=app["proxy_timeout_s"],
            )
            if 200 <= resp.status < 300:
                try:
                    body = resp.json()
                except ValueError as e:
                    raise _MigrateTransient(f"bad JSON body: {e}") from e
                if not isinstance(body, dict):
                    raise _MigrateRefused("non-object body")
                return body
            text = resp.text()[:200]
            if 400 <= resp.status < 500:
                raise _MigrateRefused(f"HTTP {resp.status}: {text}")
            raise _MigrateTransient(f"HTTP {resp.status}: {text}")
        except TransportError as e:
            raise _MigrateTransient(str(e)) from e

    try:
        body = await policy.arun(
            attempt, retry_on=(_MigrateTransient,),
            label=f"migrate {path}",
        )
        return body, None
    except _MigrateRefused as e:
        return None, f"refused: {e}"
    except RetryError as e:
        return None, str(e.last or e)




async def _import_and_repoint(app, sid: str, entry: dict, snapshot: dict,
                              source_id: str, reason: str) -> bool:
    """The shared tail of drain-as-move and crash restore: land the
    snapshot on the least-loaded HEALTHY target, pin the journey's next
    re-offer to it (the adoption token), and only then tell the client
    to move (StreamMigrated).  False leaves the source — when it still
    exists — serving untouched."""
    journeys: JourneyLog | None = app["journeys"]
    stats: FrameStats = app["stats"]
    jid = entry.get("journey_id")
    if journeys is None or not journeys.known(jid):
        # without a live journey record the client's re-offer can never
        # be pinned to the target — the import would park unadopted,
        # burning a slot + reservation while the client re-primes fresh.
        # Refuse up front; kill-drain semantics keep the session alive.
        return _migrate_failed(
            app, sid, entry, source_id,
            "no journey correlation — the re-offer cannot be pinned",
        )
    target = app["fleet"].pick(exclude={source_id}, healthy_only=True)
    if target is None:
        return _migrate_failed(
            app, sid, entry, source_id, "no healthy migration target"
        )
    token = f"mig-{uuid.uuid4().hex[:12]}"
    body, err = await _migrate_call(
        app, "POST", target, "/migrate/import",
        json_body={"token": token, "snapshot": snapshot},
    )
    if body is None:
        return _migrate_failed(
            app, sid, entry, source_id,
            f"import on {target.agent_id} failed: {err}",
        )
    # the journey's next re-offer lands on the target holding the
    # imported state — the adoption handshake the agent completes
    _remember_bounded(app["migrations"], jid, {
        "target": target.agent_id, "token": token,
        "ts": time.monotonic(),
    })
    journeys.note(
        jid, "migrated", source=source_id,
        target=target.agent_id, stream_id=sid, reason=reason,
    )
    # lifecycle-driven moves get their own ring kind on top of the
    # mechanical "migrated": an operator reading a journey should see
    # WHY the session moved, not just that it did
    lifecycle_kind = {
        "upgrade": "upgraded", "autoscale": "scaled",
        "evacuate": "evacuated",
    }.get(reason)
    if lifecycle_kind is not None:
        journeys.note(
            jid, lifecycle_kind, source=source_id,
            target=target.agent_id, stream_id=sid,
        )
    # the session moved: its banked export must never crash-restore a
    # SECOND copy if the (now-empty) source dies inside the bank TTL
    app["snapshot_bank"].pop(sid, None)
    stats.count("migrations")
    handler: StreamEventHandler = app["fleet_events"]
    journey = (
        {"journey_id": jid, "leg": entry.get("leg", 1)} if jid else None
    )
    handler.handle_stream_migrated(
        sid, entry.get("room_id", ""), source_id, target.agent_id,
        reason=reason, journey=journey,
    )
    return True


def _migrate_failed(app, sid: str, entry: dict, source_id: str,
                    why: str) -> bool:
    """One migration giving up: counted, ringed, and — when the journey
    plane is on — the SOURCE's evidence captured now (the failure may be
    the first symptom of the incident that kills it next)."""
    journeys: JourneyLog | None = app["journeys"]
    app["stats"].count("migrations_failed")
    logger.warning("migration of %s aborted: %s", sid, why)
    jid = entry.get("journey_id")
    if journeys is not None and journeys.known(jid):
        journeys.note(jid, "migrate_failed", stream_id=sid, why=why[:200])
        src = app["fleet"].agents.get(source_id)
        if src is not None and src.state != "DEAD":
            # a corpse answers no pulls (the crash-restore path's source)
            # — don't burn a bounded capture-task slot on it
            _capture_evidence(app, jid, source_id)
    return False


async def _migrate_session(app, rec, sid: str, entry: dict,
                           reason: str = "drain") -> bool:
    """Move ONE session off a draining agent — export, then the shared
    import/re-point tail.  Every failure is abort-safe: the source keeps
    serving and the kill-drain finishes the job."""
    snapshot, err = await _migrate_call(
        app, "GET", rec, "/migrate/export", params={"session": sid},
    )
    if snapshot is None:
        if app["session_table"].owner(sid) != rec.agent_id:
            # the session ended naturally while queued in the sweep
            # (StreamEnded pruned the table, the agent 404s the export):
            # the drain got what it wanted — this is NOT a failed
            # migration and must not pollute the failure metrics or
            # capture incident evidence
            logger.info(
                "migration of %s skipped: session ended mid-sweep", sid
            )
            return False
        return _migrate_failed(
            app, sid, entry, rec.agent_id, f"export failed: {err}"
        )
    # bank the freshest export per stream (bounded, TTL'd): the
    # AGENT_DEAD crash path restores from here when the source dies
    # after exporting but before the client moved
    _remember_bounded(app["snapshot_bank"], sid, {
        "snapshot": snapshot, "ts": time.monotonic(),
    })
    return await _import_and_repoint(
        app, sid, entry, snapshot, rec.agent_id, reason=reason
    )


async def _run_migrate_drain(app, rec, sessions, gen: int,
                             reason: str = "drain"):
    """The drain-as-move sweep: every live session on the draining agent
    is exported, imported on a healthy target and re-pointed — at most
    MIGRATE_MAX_PARALLEL in flight, the whole sweep bounded by
    MIGRATE_TIMEOUT_S.  On timeout (or per-session failure) the
    remaining sessions simply keep the existing kill-drain semantics:
    admission stays frozen and they finish naturally.  ``gen`` is this
    sweep's drain generation: cancel (and any restart) bumps it, so a
    stale sweep's queued work can never run concurrently with — or
    instead of — the sweep the operator actually asked for."""
    t0 = time.monotonic()
    sem = asyncio.Semaphore(app["migrate_max_parallel"])
    moved = 0

    async def one(sid, entry):
        nonlocal moved
        async with sem:
            if not rec.draining or app["drain_gen"].get(
                rec.agent_id
            ) != gen:
                # action=cancel mid-sweep (or a cancel/restart cycle that
                # superseded this sweep): in-flight moves finish, but no
                # NEW session leaves under a drain the operator revoked
                return
            t_sess = time.monotonic()
            if await _migrate_session(app, rec, sid, entry, reason=reason):
                moved += 1
                # per-SESSION export-to-re-point latency (the semaphore
                # queue wait is not migration time)
                move_ms = round(1e3 * (time.monotonic() - t_sess), 3)
                app["migration_ms"].append(move_ms)
                if reason == "upgrade":
                    # the rolling-upgrade acceptance metric: how long a
                    # session was between boxes during a sweep step
                    app["upgrade_move_ms"].append(move_ms)
                elif reason == "evacuate":
                    # the engine-fault-domain acceptance metric
                    # (evacuation_session_move_ms)
                    app["evacuation_move_ms"].append(move_ms)

    try:
        results = await asyncio.wait_for(
            asyncio.gather(
                *[one(s, e) for s, e in sessions], return_exceptions=True
            ),
            timeout=app["migrate_timeout_s"],
        )
        for r in results:
            if isinstance(r, BaseException):
                # an unexpected per-session error (outside _migrate_call's
                # handled set) must not abort the sweep's bookkeeping or
                # die unretrieved — that session simply keeps kill-drain
                # semantics
                logger.exception(
                    "migrate-drain move raised", exc_info=r
                )
    except asyncio.TimeoutError:
        app["stats"].count("migration_fallbacks")
        logger.warning(
            "migrate-drain of %s hit MIGRATE_TIMEOUT_S with %d/%d moved "
            "— falling back to kill-drain for the rest",
            rec.agent_id, moved, len(sessions),
        )
    logger.info(
        "migrate-drain of %s: %d/%d sessions moved in %.1fs",
        rec.agent_id, moved, len(sessions), time.monotonic() - t0,
    )


async def _crash_restore(app, rec, sid: str, entry: dict, banked: dict):
    """AGENT_DEAD with a recent snapshot banked: reuse the migration
    restore surface so the client resumes MID-STREAM instead of
    re-priming from a keyframe.  Any failure falls back to the plain
    AGENT_DEAD re-point — the client still learns to re-offer."""
    ok = False
    try:
        ok = await _import_and_repoint(
            app, sid, entry, banked["snapshot"], rec.agent_id,
            reason="agent_dead",
        )
    except Exception:
        logger.exception("crash restore of %s failed", sid)
    if not ok:
        app["fleet_events"].handle_session_state(
            sid, entry.get("room_id", ""), "AGENT_DEAD",
            f"agent {rec.agent_id} is unreachable — re-offer through "
            f"the router to land on a replacement",
            journey=(
                {"journey_id": entry.get("journey_id"),
                 "leg": entry.get("leg", 1)}
                if entry.get("journey_id") else None
            ),
        )


def _next_drain_gen(app, agent_id: str) -> int:
    """Mint this agent's next drain generation from ONE router-wide
    monotonic counter: generation numbers are unique forever, so even if
    the bounded per-agent map evicts an entry under pathological churn,
    a later drain/cancel can never re-mint a number a stale sweep still
    holds (eviction then only STOPS a sweep early — the safe direction —
    never resurrects a cancelled one)."""
    gen = app["drain_gen_next"]
    app["drain_gen_next"] = gen + 1
    _remember_bounded(app["drain_gen"], agent_id, gen)
    return gen


def _spawn_migrate_task(app, coro):
    """Migration background work: strong-ref'd in the bounded task set,
    reaped by done-callback (the task-lifecycle discipline)."""
    tasks: set = app["migrate_tasks"]
    task = asyncio.get_running_loop().create_task(coro)
    tasks.add(task)
    task.add_done_callback(tasks.discard)
    return task


async def fleet_drain(app, req: Request) -> Reply:
    """POST /fleet/drain?agent=ID[&action=start|cancel][&mode=kill|migrate]:
    stop routing to the agent AND flip its own admission-freeze rung (the
    agent stops admitting locally — sessions arriving around the router
    are refused too).  ``mode=kill`` (default) then lets live sessions
    finish; ``mode=migrate`` MOVES them — each session's stream state is
    exported, imported on the least-loaded healthy target, and the client
    re-pointed (StreamMigrated), falling back to kill-drain semantics per
    session on any failure and wholesale after MIGRATE_TIMEOUT_S.
    /fleet/health flips ``recyclable`` at zero.  ``cancel`` reverts both
    sides (in-flight moves finish but no new ones start... their targets'
    unadopted imports expire on their own TTL)."""
    agent_id = req.query.get("agent")
    if not agent_id:
        return Reply(400, "agent= query required")
    rec = app["fleet"].agents.get(agent_id)
    if rec is None:
        return Reply(404, f"unknown agent {agent_id!r}")
    action = req.query.get("action", "start")
    if action not in ("start", "cancel"):
        return Reply(400, "action must be start|cancel")
    mode = req.query.get("mode", "kill")
    if mode not in ("kill", "migrate"):
        return Reply(400, "mode must be kill|migrate")
    if action == "start" and mode == "migrate":
        refusal = _migrate_mode_refusal(app)
        if refusal is not None:
            return refusal
    result = await _apply_drain(app, rec, action == "start", mode)
    return _json_reply(result)


def _migrate_mode_refusal(app) -> Reply | None:
    """The mode=migrate preconditions shared by /fleet/drain and
    /fleet/upgrade (the autoscaler's retire path checks the same flags
    inline — it has no HTTP response to return)."""
    if not app["migrate_enabled"]:
        return Reply(
            409,
            "session migration disabled (MIGRATE_ENABLE=0) — "
                 "drain with mode=kill",
        )
    if app["journeys"] is None:
        # migration rides the journey plane end to end (the pin that
        # routes the re-offer to the imported state is keyed by
        # journey id) — without it every "move" would silently
        # degrade to a fresh re-prime while burning target slots
        return Reply(
            409,
            "mode=migrate needs the journey plane "
                 "(JOURNEY_ENABLE=0) — drain with mode=kill",
        )
    return None


def _start_migrate_sweep(app, rec, reason: str = "drain") -> int:
    """Begin (or join) a migrate-drain sweep of ``rec``: flip its
    draining guard, mint the drain generation, spawn the sweep task.
    Returns how many sessions the sweep will move — 0 when a CURRENT-
    generation sweep is already active (an operator retry must not spawn
    a second concurrent sweep over the same sessions).  A SUPERSEDED
    sweep (cancel bumped the gen) merely finishing its in-flight moves
    does NOT block a restart — cancel-then-restart must migrate, not
    silently degrade to kill semantics."""
    agent_id = rec.agent_id
    active_sweep = app["migrate_sweeps"].get(agent_id)
    if active_sweep is not None and active_sweep == app["drain_gen"].get(
        agent_id
    ):
        return 0
    # no active sweep — this also upgrades a plain kill-drain to
    # move-not-kill, and re-migrates whatever a timed-out sweep
    # left behind (the re-assertion is visible as migrating=N)
    sessions = app["session_table"].sessions_of(agent_id)
    if sessions:
        rec.draining = True  # before the sweep: its cancel guard
        gen = _next_drain_gen(app, agent_id)
        _remember_bounded(app["migrate_sweeps"], agent_id, gen)
        task = _spawn_migrate_task(
            app, _run_migrate_drain(app, rec, sessions, gen, reason=reason)
        )

        def _sweep_done(_t, a=agent_id, g=gen):
            # only THIS sweep's registration — a newer sweep that
            # replaced the entry must not be unregistered by the
            # old task finishing late
            if app["migrate_sweeps"].get(a) == g:
                app["migrate_sweeps"].pop(a, None)

        task.add_done_callback(_sweep_done)
    return len(sessions)


async def _apply_drain(app, rec, starting: bool, mode: str,
                       reason: str = "drain") -> dict:
    """The drain transition shared by /fleet/drain, the rolling-upgrade
    sweep, and the autoscaler's retire path: registry flags + the
    agent's own admission-freeze rung + (mode=migrate) the drain-as-move
    sweep.  Validation — agent exists, migrate preconditions hold — is
    the callers' job."""
    agent_id = rec.agent_id
    was_draining = rec.draining
    migrating = 0
    if starting and mode == "migrate":
        migrating = _start_migrate_sweep(app, rec, reason)
    if starting and not was_draining:
        app["stats"].count("fleet_drains")
    if not starting:
        # cancel supersedes any in-flight sweep: mint a fresh generation
        # so its queued moves die even if a new drain re-flips
        # rec.draining before they reach the semaphore
        _next_drain_gen(app, agent_id)
    rec.draining = starting
    if starting:
        rec.state = "DRAINING" if rec.state != "DEAD" else rec.state
        # recyclable only on POLLED evidence: live_sessions defaults to 0
        # before the first successful /health read, and recycling a box
        # on that default would hard-drop every session it is serving
        rec.recyclable = rec.recyclable or (
            rec.last_ok is not None and rec.live_sessions == 0
        )
    else:
        rec.recyclable = False
        if rec.state == "DRAINING":
            rec.state = "HEALTHY"  # next poll re-evaluates
    agent_ack = False
    try:
        resp = await app["http"].request(
            "POST", rec.base_url + "/drain",
            json={"action": "freeze" if starting else "unfreeze"},
        )
        agent_ack = resp.status == 200
    except TransportError as e:
        logger.warning("drain call to %s failed: %s", agent_id, e)
    return {
        "agent": agent_id,
        "draining": rec.draining,
        "recyclable": rec.recyclable,
        "live_sessions": rec.live_sessions,
        "agent_ack": agent_ack,
        "mode": mode if starting else "cancel",
        "migrating": migrating,
    }


async def fleet_evacuate(app, req: Request) -> Reply:
    """POST /fleet/evacuate {"agent": id, "reason": str} — an agent whose
    engine guard exhausted its rebuild attempts (resilience/engine_guard)
    self-reports an unrecoverable device fault: mark it FAILED (out of
    placement until it re-registers at a bumped epoch) and migrate-place
    its sessions on healthy agents via the drain-as-move sweep
    (reason="evacuate": journeys continue leg+1 with an ``evacuated``
    ring entry).  Exports run against the FAILED agent — its HTTP plane
    still answers; only its device is gone.  Same bearer auth as the
    webhook ingest: this call moves every session on the box."""
    handler: StreamEventHandler = app["fleet_events"]
    if handler.token:
        auth = req.headers.get("Authorization", "")
        if auth != f"Bearer {handler.token}":
            return Reply(401, "bad token")
    try:
        body = req.json()
    except ValueError:
        body = {}
    agent_id = str(body.get("agent") or req.query.get("agent") or "")
    if not agent_id:
        return Reply(400, "agent required")
    reg: FleetRegistry = app["fleet"]
    rec = reg.agents.get(agent_id)
    if rec is None:
        return Reply(404, f"unknown agent {agent_id!r}")
    refusal = _migrate_mode_refusal(app)
    if refusal is not None:
        return refusal
    if rec.state != "FAILED":
        reg.mark_failed(rec)
    moving = _start_migrate_sweep(app, rec, reason="evacuate")
    app["stats"].count("evacuations")
    logger.warning(
        "agent %s evacuating %d session(s): %s",
        agent_id, moving, str(body.get("reason", ""))[:200],
    )
    return _json_reply(
        {"agent": agent_id, "state": rec.state, "evacuating": moving}
    )


async def fleet_upgrade(app, req: Request) -> Reply:
    """POST /fleet/upgrade?action=start|cancel — rolling restart-in-place
    of the whole fleet, one agent at a time: drain-as-move →
    ``/admin/recycle`` → wait for the replacement to re-register at a
    bumped epoch and pass the prewarm probe → next agent.  Any step's
    failure HALTS the sweep with the current agent un-drained and
    serving; ``cancel`` aborts between (and within) steps the same way.
    Status rides /fleet/health under ``upgrade``."""
    action = req.query.get("action", "start")
    if action not in ("start", "cancel"):
        return Reply(400, "action must be start|cancel")
    up = app["upgrade"]
    if action == "cancel":
        if up["active"]:
            up["cancel"] = True
            current = up.get("current")
            if current:
                # abort-safe: supersede the in-flight target's sweep so
                # queued moves die at the drain-generation guard,
                # exactly like /fleet/drain?action=cancel
                _next_drain_gen(app, current)
        return _json_reply(dict(up))
    if up["active"]:
        return Reply(409, "upgrade already in progress")
    refusal = _migrate_mode_refusal(app)
    if refusal is not None:
        return refusal
    reg: FleetRegistry = app["fleet"]
    targets = [aid for aid, rec in reg.agents.items() if rec.state != "DEAD"]
    if not targets:
        return Reply(409, "no live agents to upgrade")
    up.update({
        "active": True, "cancel": False, "current": None,
        "done": [], "halted": None, "total": len(targets),
    })
    _spawn_migrate_task(app, _run_upgrade(app, targets))
    return _json_reply(dict(up), status=202)


async def _run_upgrade(app, targets: list):
    """The sweep's loop: strictly one agent in flight at a time —
    upgrading two at once halves serving capacity mid-sweep and can
    strand the fleet if both replacements fail."""
    up = app["upgrade"]
    reg: FleetRegistry = app["fleet"]
    try:
        for agent_id in targets:
            if up["cancel"]:
                up["halted"] = "cancelled"
                return
            rec = reg.agents.get(agent_id)
            if rec is None or rec.state == "DEAD":
                # the crash path (AGENT_DEAD → crash-restore) owns this
                # one; the sweep must not fight it
                continue
            up["current"] = agent_id
            ok, why = await _upgrade_one(app, rec)
            if not ok:
                up["halted"] = f"{agent_id}: {why}"
                app["stats"].count("fleet_upgrade_halts")
                logger.warning("upgrade halted at %s: %s", agent_id, why)
                return
            up["done"].append(agent_id)
        app["stats"].count("fleet_upgrades")
        logger.info("rolling upgrade complete: %d agents", len(up["done"]))
    finally:
        up["active"] = False
        up["current"] = None


async def _upgrade_one(app, rec) -> tuple:
    """One agent through the sweep: drain-to-zero (as moves), recycle,
    wait for the higher-epoch replacement to prove itself.  Returns
    (ok, why); every failure path leaves the OLD agent un-drained and
    serving — a halted sweep never shrinks the fleet."""
    up = app["upgrade"]
    reg: FleetRegistry = app["fleet"]
    agent_id = rec.agent_id
    old_epoch = rec.epoch

    async def _undrain():
        if reg.agents.get(agent_id) is rec and rec.state != "DEAD":
            await _apply_drain(app, rec, False, "kill", reason="upgrade")

    await _apply_drain(app, rec, True, "migrate", reason="upgrade")
    deadline = time.monotonic() + app["upgrade_step_timeout_s"]
    while True:
        if up["cancel"]:
            await _undrain()
            return False, "cancelled"
        if reg.agents.get(agent_id) is not rec or rec.state == "DEAD":
            # crash-restore owns its sessions now; halt rather than
            # recycle a corpse
            return False, "agent died mid-drain (crash-restore owns its sessions)"
        if (
            not app["session_table"].sessions_of(agent_id)
            and rec.live_sessions == 0
            # polled evidence only — live_sessions defaults to 0 before
            # the first /health read, and recycling on that default
            # would hard-drop whatever the box is actually serving
            and rec.last_ok is not None
            and app["migrate_sweeps"].get(agent_id) is None
        ):
            break
        if time.monotonic() >= deadline:
            await _undrain()
            return False, "drain-to-zero timed out"
        await asyncio.sleep(0.1)
    _body, err = await _migrate_call(
        app, "POST", rec, "/admin/recycle", json_body={"respawn": True}
    )
    if err is not None:
        await _undrain()
        return False, f"recycle refused: {err}"
    # the old process is gone (or going); wait for the replacement to
    # re-register at a bumped epoch AND answer the prewarm probe before
    # moving on — a 200 /health from it means the handoff import already
    # ran (on_startup precedes the socket bind)
    deadline = time.monotonic() + app["upgrade_step_timeout_s"]
    while True:
        if up["cancel"]:
            return False, "cancelled"
        new_rec = reg.agents.get(agent_id)
        if (
            new_rec is not None and new_rec is not rec
            and new_rec.epoch > old_epoch and new_rec.state != "DEAD"
        ):
            if await _prewarm_probe(app, new_rec):
                return True, ""
        if time.monotonic() >= deadline:
            return False, "replacement never re-registered/prewarmed"
        await asyncio.sleep(0.1)


async def _prewarm_probe(app, rec) -> bool:
    """Replacement readiness beyond registration: /health answers 200 AND
    /capacity returns a coherent JSON body whose boot_id matches what the
    record registered with (a stale old-process socket answering the
    address must not pass the new process's gate)."""
    try:
        resp = await app["http"].request("GET", rec.base_url + "/health")
        if resp.status != 200:
            return False
        resp = await app["http"].request("GET", rec.base_url + "/capacity")
        if resp.status != 200:
            return False
        cap = resp.json()
    except (TransportError, ValueError):
        return False
    if not isinstance(cap, dict):
        return False
    bid = str(cap.get("boot_id") or "")
    if rec.boot_id and bid and bid != rec.boot_id:
        return False
    return True


def _default_autoscale_spawn() -> bool:
    """Scale-up backend: fire AUTOSCALE_EXEC_HOOK (sync — the loop pushes
    this off-thread).  The new box proves itself by registering."""
    from ..server import lifecycle

    return lifecycle.run_exec_hook(env.get_str("AUTOSCALE_EXEC_HOOK"))


async def _run_retire(app, rec):
    """Scale-down: migrate-drain the emptiest agent to zero, then recycle
    it WITHOUT respawn and forget it.  Zero session loss by construction:
    if the drain can't reach zero inside the step timeout the retire is
    abandoned and the agent un-drained — the fleet never shrinks by
    dropping a session."""
    reg: FleetRegistry = app["fleet"]
    agent_id = rec.agent_id
    await _apply_drain(app, rec, True, "migrate", reason="autoscale")
    deadline = time.monotonic() + app["upgrade_step_timeout_s"]
    while True:
        if reg.agents.get(agent_id) is not rec or rec.state == "DEAD":
            return  # crash path owns it now
        if (
            not app["session_table"].sessions_of(agent_id)
            and rec.live_sessions == 0
            and rec.last_ok is not None
            and app["migrate_sweeps"].get(agent_id) is None
        ):
            break
        if time.monotonic() >= deadline:
            logger.warning(
                "autoscale retire of %s abandoned: drain-to-zero timed out",
                agent_id,
            )
            await _apply_drain(app, rec, False, "kill", reason="autoscale")
            return
        await asyncio.sleep(0.1)
    _body, err = await _migrate_call(
        app, "POST", rec, "/admin/recycle", json_body={"respawn": False}
    )
    if err is not None:
        # proceed anyway: the agent is drained and empty; if it lingers
        # it just re-registers and the controller re-evaluates
        logger.warning("retire recycle of %s failed: %s", agent_id, err)
    reg.remove(agent_id)
    app["stats"].count("autoscale_retires")
    logger.info("autoscale retired %s", agent_id)


async def _autoscale_loop(app):
    """The demand controller's clock: fold fleet-wide pressure into the
    EWMA each tick and execute the (rare, hysteresis- and cooldown-gated)
    spawn/retire decisions."""
    ctl = app["autoscale"]
    try:
        while True:
            await asyncio.sleep(app["autoscale_tick_s"])
            try:
                rejects = int(
                    app["stats"].snapshot().get("fleet_rejects_total", 0) or 0
                )
                decision = ctl.tick(rejects)
                if decision == "up":
                    ok = await asyncio.to_thread(app["autoscale_spawn"])
                    if ok:
                        app["stats"].count("autoscale_spawns")
                    else:
                        logger.warning(
                            "autoscale wanted to spawn but no backend "
                            "succeeded (AUTOSCALE_EXEC_HOOK unset?)"
                        )
                elif decision == "down":
                    rec = ctl.retire_candidate()
                    if (
                        rec is not None and app["migrate_enabled"]
                        and app["journeys"] is not None
                    ):
                        _spawn_migrate_task(app, _run_retire(app, rec))
            except Exception:
                logger.exception("autoscale tick failed")
    except asyncio.CancelledError:
        pass


async def fleet_health(app, req: Request) -> Reply:
    """Per-agent membership view (JSON only — agent identity never
    becomes a /metrics label)."""
    reg: FleetRegistry = app["fleet"]
    agents = {aid: rec.snapshot() for aid, rec in reg.agents.items()}
    worst = "HEALTHY"
    order = {
        "HEALTHY": 0, "DEGRADED": 1, "DRAINING": 2, "FAILED": 3, "DEAD": 4,
    }
    for rec in agents.values():
        if order.get(rec["state"], 0) > order[worst]:
            worst = rec["state"]
    return _json_reply({
        "status": worst,
        "agents": agents,
        "sessions_tracked": len(app["session_table"]),
        "upgrade": dict(app["upgrade"]),
    })


async def health(_):
    return Reply(200, "OK", "application/json")


async def journey_index(app, req: Request) -> Reply:
    """``GET /fleet/debug/journeys``: the directory of tracked journeys
    + sealed incident bundles (JSON only — journey identity never
    becomes a /metrics label)."""
    journeys: JourneyLog | None = app["journeys"]
    if journeys is None:
        return _json_reply(
            {"error": "journey plane disabled (JOURNEY_ENABLE=0)"},
            status=404,
        )
    return _json_reply(journeys.index())


async def journey_bundle(app, req: Request) -> Reply:
    """``GET /fleet/debug/journey/<id>``: ONE incident bundle for the
    whole cross-process session journey —

    * the router's journey ring (placed → degraded → agent_dead →
      re_placed → …, wall-clock stamped),
    * evidence captured from agents on the alert paths (flight
      snapshots + timelines + devtel compiles, surviving dead agents),
    * a LIVE fan-out over every agent that served any leg, pulling its
      current ``/debug/flight?journey=`` fragment, and
    * the sealed bundles the alert paths froze.

    ``?format=chrome`` merges every captured leg into a single Perfetto
    trace with per-agent process ids (obs/export.py)."""
    journeys: JourneyLog | None = app["journeys"]
    if journeys is None:
        return _json_reply(
            {"error": "journey plane disabled (JOURNEY_ENABLE=0)"},
            status=404,
        )
    unknown = sorted(k for k in req.query if k != "format")
    if unknown:
        # a tooling URL with a mistyped param must fail loudly, not
        # quietly serve the unfiltered bundle as if the filter applied
        return _json_reply(
            {"error": f"unknown query param(s): {', '.join(unknown)}"},
            status=400,
        )
    fmt = req.query.get("format", "json")
    if fmt not in ("json", "chrome"):
        return _json_reply(
            {"error": f"unknown format {fmt!r}"}, status=400
        )
    jid = req.match_info["id"]
    record = journeys.get(jid)
    if record is None:
        return _json_reply(
            {"error": f"unknown journey {jid!r}"}, status=404
        )

    # live fan-out over the agents that served any leg (the DEAD ones
    # are exactly what the evidence store exists for) — pulls run
    # CONCURRENTLY: an incident GET must not serialize N slow agents'
    # timeouts exactly when the operator is debugging
    fragments = []
    seen_agents = []
    for leg in record["legs"]:
        if leg["agent"] not in seen_agents:
            seen_agents.append(leg["agent"])
    live_recs = []
    for agent_id in seen_agents:
        rec = app["fleet"].agents.get(agent_id)
        if rec is None or rec.state == "DEAD":
            fragments.append({
                "source": "unreachable", "agent": agent_id,
                "state": rec.state if rec is not None else "unknown",
            })
        else:
            live_recs.append((agent_id, rec))
    if live_recs:
        pulls = await asyncio.gather(*[
            _pull_fragment(app, rec, jid) for _aid, rec in live_recs
        ])
        for (agent_id, _rec), (fragment, err) in zip(live_recs, pulls):
            if fragment is not None:
                # the router's registry id is authoritative — spread
                # FIRST so the agent's self-reported "agent" (WORKER_ID,
                # possibly unset/divergent) cannot overwrite it and
                # desync the chrome-merge dedup keys from the evidence
                # entries keyed by the same id
                fragments.append(
                    {**fragment, "source": "live", "agent": agent_id}
                )
            elif err is not None:
                fragments.append({
                    "source": "error", "agent": agent_id, "error": err,
                })
            # (None, None): the agent holds no records for this journey
    bundle = {
        "journey_id": jid,
        "journey": record,
        "fragments": fragments,
        "evidence": journeys.evidence_for(jid),
        "bundles": journeys.bundles_for(jid),
    }
    if fmt == "chrome":
        from ..obs.export import merge_chrome_traces

        sources = _chrome_sources(bundle)
        if not sources:
            return _json_reply(
                {"error": f"no captures recorded for journey {jid!r}"},
                status=404,
            )
        return _json_reply(merge_chrome_traces(sources, journey=jid))
    return _json_reply(bundle)


def _chrome_sources(bundle: dict) -> list:
    """Collect every captured snapshot in the bundle as
    ``(snapshot, meta)`` merge sources — evidence first (it may be all
    that survives a corpse), then live fragments, deduplicated by
    (agent, capture identity)."""
    sources: list = []
    seen: set = set()

    def add(agent: str, snap):
        if not isinstance(snap, dict):
            return
        key = (agent, snap.get("id")
               or (snap.get("session"), snap.get("taken_at")))
        if key in seen:
            return
        seen.add(key)
        meta = dict(snap.get("journey") or {})
        meta.setdefault("agent", agent)
        sources.append((snap, meta))

    def add_fragment(agent: str, frag: dict):
        for snap in frag.get("snapshots") or []:
            add(agent, snap)
        for snap in (frag.get("sessions") or {}).values():
            add(agent, snap)

    for sealed in bundle.get("bundles", []):
        for ev in sealed.get("evidence", []):
            add_fragment(ev.get("agent", ""), ev.get("fragment") or {})
    for ev in bundle.get("evidence", []):
        add_fragment(ev.get("agent", ""), ev.get("fragment") or {})
    for frag in bundle.get("fragments", []):
        if frag.get("source") == "live":
            add_fragment(frag.get("agent", ""), frag)
    return sources


async def metrics(app, req: Request) -> Reply:
    """Fleet rollup: counters from the router's FrameStats plus the
    registry's aggregate gauges.  Aggregated across agents by
    construction — nothing here is keyed by agent or session identity
    (?format=prom renders the same flat dict through obs/promexport)."""
    out = app["stats"].snapshot()
    out.update(app["fleet"].snapshot())
    out["fleet_sessions_tracked"] = len(app["session_table"])
    out["fleet_session_table_evicted"] = app["session_table"].evicted
    # live-migration rollup (aggregate only — no per-session/per-agent
    # labels ever; migrations_total/_failed_total land via FrameStats)
    out["migration_snapshots_banked"] = len(app["snapshot_bank"])
    samples = sorted(app["migration_ms"])
    if samples:
        n = len(samples)
        out["migration_ms_p50"] = round(samples[n // 2], 3)
        out["migration_ms_p99"] = round(samples[min(n - 1, int(n * 0.99))], 3)
    # rolling-upgrade move latency (the subset of migrations driven by
    # /fleet/upgrade — the zero-downtime SLO the upgrade bench fences)
    moves = sorted(app["upgrade_move_ms"])
    if moves:
        n = len(moves)
        out["upgrade_session_move_ms_p50"] = round(moves[n // 2], 3)
        out["upgrade_session_move_ms_p99"] = round(
            moves[min(n - 1, int(n * 0.99))], 3
        )
    # evacuation move latency (the subset driven by /fleet/evacuate —
    # the engine-fault-domain SLO the recovery bench fences)
    moves = sorted(app["evacuation_move_ms"])
    if moves:
        n = len(moves)
        out["evacuation_session_move_ms_p50"] = round(moves[n // 2], 3)
        out["evacuation_session_move_ms_p99"] = round(
            moves[min(n - 1, int(n * 0.99))], 3
        )
    if app["autoscale"].enabled:
        out.update(app["autoscale"].snapshot())
    if app["journeys"] is not None:
        # journey rollup (fleet/journey.py): aggregate counters + the
        # placement→first-frame percentiles — the journey id itself is
        # never a label (metric-cardinality discipline)
        out.update(app["journeys"].snapshot())
    fmt = req.query.get("format", "json")
    if fmt == "prom":
        from ..obs.promexport import CONTENT_TYPE, render

        return Reply(200, render(out).encode("utf-8"), None,
                     {"Content-Type": CONTENT_TYPE})
    if fmt != "json":
        return Reply(400, f"unknown format {fmt!r}")
    return _json_reply(out)


# ---------------------------------------------------------------------------
# app assembly
# ---------------------------------------------------------------------------

def _on_agent_dead(app):
    """Crash replacement: re-point every client the router placed on the
    dead agent through the existing webhook path — the StreamDegraded
    event (state=AGENT_DEAD) tells the client to re-offer; placement
    lands it on a replacement and the PLI re-sync machinery re-primes."""

    def on_dead(rec):
        handler: StreamEventHandler = app["fleet_events"]
        stats: FrameStats = app["stats"]
        journeys: JourneyLog | None = app["journeys"]
        now = time.monotonic()
        for sid, entry in app["session_table"].pop_agent_sessions(
            rec.agent_id
        ):
            stats.count("fleet_sessions_repointed")
            journey = None
            jid = entry.get("journey_id")
            if journeys is not None and journeys.known(jid):
                journeys.note(jid, "agent_dead", agent=rec.agent_id,
                              stream_id=sid)
                # seal NOW: the corpse answers no more pulls, so the
                # bundle is whatever evidence the breach path banked
                journeys.seal_bundle(jid, f"AGENT_DEAD {rec.agent_id}")
                journey = {"journey_id": jid, "leg": entry.get("leg", 1)}
            banked = (
                app["snapshot_bank"].get(sid)
                if app["migrate_enabled"] else None
            )
            if banked is not None and (
                now - banked["ts"] <= _SNAPSHOT_BANK_TTL_S
            ):
                # a recent snapshot exists (an interrupted drain-as-move
                # exported it before the agent died): reuse the restore
                # surface — the client resumes MID-STREAM instead of
                # re-priming from a keyframe.  Failure inside falls back
                # to the plain AGENT_DEAD re-point below.
                _spawn_migrate_task(
                    app, _crash_restore(app, rec, sid, entry, banked)
                )
                continue
            handler.handle_session_state(
                sid, entry.get("room_id", ""), "AGENT_DEAD",
                f"agent {rec.agent_id} is unreachable — re-offer through "
                f"the router to land on a replacement",
                journey=journey,
            )

    return on_dead


async def startup(app):
    """Open the transport (aiohttp unless one was configured), then the
    poller and, with it, the autoscaler's loop."""
    if app["http"] is None:
        app["http"] = AiohttpTransport(app["proxy_timeout_s"])
        app["owns_http"] = True
    if app["poll"]:
        app["poller"] = FleetPoller(app["fleet"], transport=app["http"])
        await app["poller"].start()
    if app["poll"] and app["autoscale"].enabled:
        # the demand controller rides the poller's liveness plane: no
        # poll, no trustworthy pressure signal, no autoscaling
        app["autoscale_task"] = asyncio.get_running_loop().create_task(
            _autoscale_loop(app)
        )


async def cleanup(app):
    poller = app.get("poller")
    if poller is not None:
        await poller.stop()
    auto = app.get("autoscale_task")
    if auto is not None:
        auto.cancel()
        await asyncio.gather(auto, return_exceptions=True)
    # pending evidence pulls and migration sweeps go before their transport
    tasks = list(app.get("journey_tasks", ())) + list(
        app.get("migrate_tasks", ())
    )
    for task in tasks:
        task.cancel()
    if tasks:
        await asyncio.gather(*tasks, return_exceptions=True)
    if app.get("owns_http"):
        await app["http"].close()
        app["http"], app["owns_http"] = None, False


def configure(
    app,
    *,
    registry: FleetRegistry | None = None,
    events_handler: StreamEventHandler | None = None,
    poll: bool = True,
    transport=None,
):
    """Fill a router app-state mapping.  ``transport``: how agents are
    reached (None: :func:`startup` opens an aiohttp transport)."""
    app["stats"] = FrameStats()
    app["poll"] = poll
    app["http"] = transport
    app["owns_http"] = False
    app["retry_after_s"] = env.get_float("FLEET_RETRY_AFTER_S", 2.0)
    app["place_attempts"] = max(1, env.get_int("FLEET_PLACE_ATTEMPTS", 3))
    app["proxy_timeout_s"] = env.get_float("FLEET_PROXY_TIMEOUT_S", 30.0)
    app["session_table"] = _SessionTable(
        env.get_int("FLEET_SESSION_TABLE", 4096)
    )
    app["fleet"] = registry if registry is not None else FleetRegistry(
        stats=app["stats"]
    )
    if app["fleet"].stats is None:
        app["fleet"].stats = app["stats"]
    app["fleet_events"] = events_handler or StreamEventHandler()
    # the journey plane: JOURNEY_ENABLE=0 removes it (no ids minted or
    # forwarded, the debug endpoints 404)
    app["journeys"] = (
        JourneyLog(stats=app["stats"]) if env.journey_enabled() else None
    )
    app["journey_tasks"] = set()
    app["journey_inflight"] = set()  # (journey_id, agent_id) pull dedup
    # live session migration: drain-as-move and crash restore;
    # MIGRATE_ENABLE=0 turns the whole surface off
    app["migrate_enabled"] = env.migrate_enabled()
    app["migrate_timeout_s"] = env.get_float("MIGRATE_TIMEOUT_S", 30.0)
    app["migrate_max_parallel"] = max(
        1, env.get_int("MIGRATE_MAX_PARALLEL", 2)
    )
    app["migrations"] = {}     # journey_id -> re-offer pin (bounded)
    app["snapshot_bank"] = {}  # stream_id -> freshest export (bounded)
    app["drain_gen"] = {}      # agent_id -> sweep generation (bounded)
    app["drain_gen_next"] = 1  # router-wide monotonic generation mint
    app["migrate_sweeps"] = {}  # agent_id -> gen of its ACTIVE sweep task
    app["migrate_tasks"] = set()
    app["migration_ms"] = collections.deque(maxlen=512)
    # the fleet lifecycle: the one-at-a-time upgrade sweep's status and
    # move latencies, and the demand controller
    app["upgrade"] = {
        "active": False, "cancel": False, "current": None,
        "done": [], "halted": None, "total": 0,
    }
    app["upgrade_step_timeout_s"] = env.get_float(
        "UPGRADE_STEP_TIMEOUT_S", 60.0
    )
    app["upgrade_move_ms"] = collections.deque(maxlen=512)
    app["evacuation_move_ms"] = collections.deque(maxlen=512)
    app["autoscale"] = AutoscaleController(app["fleet"])
    app["autoscale_tick_s"] = env.get_float("AUTOSCALE_TICK_S", 1.0)
    app["autoscale_spawn"] = _default_autoscale_spawn
    app["fleet"].on_dead = _on_agent_dead(app)
    return app


#: (method, path, handler); ``{name}`` segments land in ``req.match_info``
ROUTES = (
    ("POST", "/offer", offer),
    ("POST", "/whip", whip),
    ("DELETE", "/whip/{session}", whip),
    ("POST", "/whep", whep),
    ("DELETE", "/whep/{session}", whep),
    ("POST", "/fleet/register", fleet_register),
    ("POST", "/fleet/events", fleet_events),
    ("POST", "/fleet/drain", fleet_drain),
    ("POST", "/fleet/upgrade", fleet_upgrade),
    ("POST", "/fleet/evacuate", fleet_evacuate),
    ("GET", "/fleet/health", fleet_health),
    ("GET", "/fleet/debug/journeys", journey_index),
    ("GET", "/fleet/debug/journey/{id}", journey_bundle),
    ("GET", "/", health),
    ("GET", "/metrics", metrics),
)


def _match(pattern: str, path: str) -> dict | None:
    want, got = pattern.strip("/").split("/"), path.strip("/").split("/")
    if len(want) != len(got):
        return None
    info = {}
    for w, g in zip(want, got):
        if w.startswith("{") and w.endswith("}"):
            if not g:
                return None
            info[w[1:-1]] = g
        elif w != g:
            return None
    return info


async def handle(app, method: str, path: str, *, query=None, headers=None,
                 body: bytes | str | dict = b"") -> Reply:
    """One in-process request to the router (a dict ``body`` is sent as
    JSON, a str as UTF-8); 404 for an unknown route."""
    if isinstance(body, dict):
        body = json.dumps(body)
    if isinstance(body, str):
        body = body.encode("utf-8")
    for m, pattern, fn in ROUTES:
        info = _match(pattern, path) if m == method.upper() else None
        if info is not None:
            req = Request(method.upper(), dict(query or {}), Headers(headers or {}), body, info)
            return await fn(app, req)
    return Reply(404, "not found")
