"""Fleet membership and health: the agent registry behind the router
(counterpart of ai_rtc_agent_tpu/fleet/registry.py).

Each serving agent process is one :class:`AgentRecord`.  Records enter
when a worker sidecar publishes (``POST /fleet/register``, a valid
``WORKER_PUBLISH_URL``) and stay current through two feeds:

* the **poll loop** (:class:`FleetPoller`): every ``FLEET_POLL_S`` each
  live agent's ``GET /capacity`` and ``GET /health``, through the
  router's transport (fleet/transport.py: aiohttp, or agents in this
  process); the capacity body is the agent's own counted admission view,
  the health body's worst session state drives HEALTHY <-> DEGRADED;
* **webhook ingestion** (the router's ``POST /fleet/events``): a
  StreamDegraded or RETRACE_BREACH volley marks the owner DEGRADED ahead
  of the next poll.

State machine per agent::

    HEALTHY <-> DEGRADED --(polls keep failing)--> DEAD
       |            |
       +-- drain ---+--> DRAINING --(live sessions reach 0)--> recyclable

DEAD is terminal until the worker re-registers.  Every record carries an
**epoch**: a revival (a DEAD re-publish, an address change, or a new
process ``boot_id`` behind the same address, as after a restart in place)
bumps it, and anything the old process minted (a webhook, a poll answer
in flight across the swap, a ghost republish) is dropped and counted as
``fleet_stale_epoch_dropped``.  Between polls the router counts its own
placements against the advertised headroom (``placed``), reset by every
poll.  :class:`AutoscaleController` is the demand controller's pure
decision logic.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time

from ..utils import env
from .transport import AiohttpTransport, TransportError

logger = logging.getLogger(__name__)

# closed enum: every state a fleet rollup gauge may be keyed by.
# FAILED: the agent self-reported an unrecoverable engine fault and
# evacuated its sessions (POST /fleet/evacuate) — unlike DEAD (poll
# silence) the process may still answer HTTP; it stays FAILED until a
# re-register revives it (docs/resilience.md "Engine fault domain").
AGENT_STATES = ("HEALTHY", "DEGRADED", "DRAINING", "FAILED", "DEAD")

# session states whose webhook marks the owning agent DEGRADED (the
# StreamDegraded family + the device-telemetry/SLO breach volleys)
BREACH_STATES = ("DEGRADED", "FAILED", "RETRACE_BREACH", "SLO_BREACH",
                 "AGENT_DEAD")


class AgentRecord:
    """One serving agent process as the fleet sees it."""

    __slots__ = (
        "agent_id", "base_url", "state", "capacity", "saturated",
        "retry_after_s", "live_sessions", "draining", "recyclable",
        "fail_count", "placed", "not_before", "last_ok", "epoch",
        "boot_id",
    )

    def __init__(self, agent_id: str, base_url: str):
        self.agent_id = agent_id
        self.base_url = base_url.rstrip("/")
        self.state = "HEALTHY"
        self.epoch = 1  # bumped on every revival/replacement of this id
        self.boot_id = ""  # the process nonce behind this record (if known)
        self.capacity = -1  # agent-advertised remaining sessions; -1 = unbounded
        self.saturated = False
        self.retry_after_s = 0.0
        self.live_sessions = 0
        self.draining = False
        self.recyclable = False
        self.fail_count = 0
        self.placed = 0  # optimistic placements since the last capacity poll
        self.not_before = 0.0  # Retry-After honor window (monotonic deadline)
        self.last_ok: float | None = None

    def effective_capacity(self) -> int | None:
        """Advertised headroom minus placements not yet visible in a
        poll; None = unbounded."""
        if self.capacity < 0:
            return None
        return max(0, self.capacity - self.placed)

    def available(self, now: float) -> bool:
        """Can the router place a session here right now?"""
        if self.state in ("DEAD", "FAILED") or self.draining:
            return False
        if now < self.not_before:
            # a 503's Retry-After (or a saturated /capacity hint) is the
            # agent saying "not before then" — re-offering sooner is the
            # hot-loop this window exists to kill
            return False
        if self.saturated:
            return False
        ec = self.effective_capacity()
        return ec is None or ec > 0

    def backoff(self, retry_after_s: float, now: float):
        self.not_before = max(self.not_before, now + max(0.0, retry_after_s))

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "base_url": self.base_url,
            "epoch": self.epoch,
            "capacity": self.capacity,
            "saturated": self.saturated,
            "live_sessions": self.live_sessions,
            "draining": self.draining,
            "recyclable": self.recyclable,
            "fail_count": self.fail_count,
        }


class FleetRegistry:
    """Membership + placement policy; all mutation on the event loop.

    ``stats`` is a FrameStats: fleet counters land as ``fleet_*_total``
    in the rollup.  ``on_dead(record)`` fires exactly once per death —
    the router re-points that agent's clients from it.  ``on_event``
    (``callable(kind, agent_id, **data)``) observes transitions for
    logs/debugging; failures never break the control plane.
    """

    def __init__(
        self,
        *,
        max_agents: int | None = None,
        dead_after: int | None = None,
        clock=time.monotonic,
        stats=None,
        on_dead=None,
    ):
        self.max_agents = (
            env.get_int("FLEET_MAX_AGENTS", 64)
            if max_agents is None else max_agents
        )
        self.dead_after = max(
            1,
            env.get_int("FLEET_DEAD_AFTER", 3)
            if dead_after is None else dead_after,
        )
        self._clock = clock
        self.stats = stats
        self.on_dead = on_dead
        self.agents: dict[str, AgentRecord] = {}
        # boot ids this registry has superseded, per agent id: a worker
        # republish carrying one is a ghost (the pre-recycle process's
        # sidecar racing its own death) and must not touch the record.
        # Both dimensions bounded: ids evict oldest-first past the
        # membership cap, each id keeps only its last few boots.
        self._retired_boots: dict[str, collections.deque] = {}

    def now(self) -> float:
        return self._clock()

    # -- membership (worker publishes) ---------------------------------------

    def register(self, info: dict) -> AgentRecord | None:
        """Ingest one worker publish (server/worker.py ``info`` dict).
        Returns the record, or None when the registry is full (bounded
        membership — a rogue publisher cannot grow it without limit).
        A publish for a known id refreshes it; publishing over a DEAD
        record — or under a new ``boot_id`` (a recycled replacement on
        the same address) — is the recycle path and revives it fresh
        with the epoch bumped.  A publish carrying a RETIRED boot id is
        the old process's ghost and is dropped (counted, record
        untouched)."""
        agent_id = str(info.get("worker_id") or "")
        port = str(info.get("public_port") or "")
        if not agent_id or not port:
            raise ValueError("publish needs worker_id and public_port")
        host = str(info.get("public_ip") or "127.0.0.1")
        base_url = f"http://{host}:{port}"
        boot_id = str(info.get("boot_id") or "")
        rec = self.agents.get(agent_id)
        if (rec is not None and boot_id
                and boot_id in self._retired_boots.get(agent_id, ())):
            # old-process ghost: its worker sidecar republishing after
            # the replacement already registered — ingesting this would
            # hand the NEW process the old one's capacity view
            self._count("fleet_stale_epoch_dropped")
            return rec
        if rec is None:
            if len(self.agents) >= self.max_agents:
                # corpses must not lock out replacements: orchestrators
                # recycle crashed agents under NEW ids (fresh pod/host
                # names), so a churning fleet would otherwise fill the
                # registry with DEAD records and 503 every newcomer
                dead = [
                    aid for aid, r in self.agents.items()
                    if r.state == "DEAD"
                ]
                if dead:
                    self.agents.pop(dead[0])  # oldest corpse goes first
            if len(self.agents) >= self.max_agents:
                self._count("fleet_registers_refused")
                return None
            rec = AgentRecord(agent_id, base_url)
            rec.boot_id = boot_id
            self.agents[agent_id] = rec
        elif (rec.state in ("DEAD", "FAILED")
                or rec.base_url != base_url.rstrip("/")
                or (boot_id and rec.boot_id and boot_id != rec.boot_id)):
            # replacement (same id re-published: revival, a new address,
            # or a NEW process behind the same address — the
            # restart-in-place recycle): forget the old history entirely
            # but BUMP the epoch and retire the old boot id, so nothing
            # the old process minted can read as the new one's evidence
            old_epoch = rec.epoch
            self._retire_boot(agent_id, rec.boot_id)
            self.agents[agent_id] = rec = AgentRecord(agent_id, base_url)
            rec.epoch = old_epoch + 1
            rec.boot_id = boot_id
        elif boot_id and not rec.boot_id:
            rec.boot_id = boot_id  # first publish that carries a nonce
        if "capacity" in info:
            try:
                rec.capacity = int(info["capacity"])
            except (TypeError, ValueError):
                pass
            rec.saturated = bool(info.get("saturated", False))
        self._count("fleet_registers")
        return rec

    def remove(self, agent_id: str) -> bool:
        return self.agents.pop(agent_id, None) is not None

    def _retire_boot(self, agent_id: str, boot_id: str):
        if not boot_id:
            return
        seen = self._retired_boots.get(agent_id)
        if seen is None:
            while len(self._retired_boots) >= self.max_agents * 4:
                self._retired_boots.pop(next(iter(self._retired_boots)))
            seen = self._retired_boots[agent_id] = collections.deque(
                maxlen=8)
        seen.append(boot_id)

    def note_stale_epoch(self):
        """One stale-epoch artifact dropped by a caller that resolved
        attribution itself (a webhook whose session-table epoch no
        longer matches the record, a poll answer that landed after the
        record it was fetched for was superseded)."""
        self._count("fleet_stale_epoch_dropped")

    # -- health feeds ---------------------------------------------------------

    def note_poll(self, rec: AgentRecord, capacity: dict | None,
                  health: dict | None):
        """One successful poll round-trip for ``rec``."""
        rec.fail_count = 0
        rec.last_ok = self._clock()
        if capacity is not None:
            try:
                rec.capacity = int(capacity.get("capacity", -1))
            except (TypeError, ValueError):
                rec.capacity = -1
            rec.saturated = bool(capacity.get("saturated", False))
            try:
                rec.retry_after_s = float(capacity.get("retry_after_s", 0.0))
            except (TypeError, ValueError):
                rec.retry_after_s = 0.0
            # the agent's ledger has absorbed our placements by now —
            # its advertised number supersedes the optimistic decrement
            rec.placed = 0
        status = "HEALTHY"
        if health is not None:
            sessions = health.get("sessions")
            if isinstance(sessions, dict):
                rec.live_sessions = len(sessions)
            status = str(health.get("status", "HEALTHY"))
        if rec.state in ("DEAD", "FAILED"):
            # dead stays dead — and a FAILED (evacuated) agent stays
            # failed even while its HTTP plane still answers polls —
            # until the worker re-registers (fresh process, epoch bump)
            return
        if rec.draining:
            rec.state = "DRAINING"
            if rec.live_sessions == 0 and not rec.recyclable:
                rec.recyclable = True
                logger.info("agent %s drained to zero — recyclable",
                            rec.agent_id)
        elif status == "HEALTHY":
            rec.state = "HEALTHY"
        else:
            rec.state = "DEGRADED"

    def note_poll_fail(self, rec: AgentRecord):
        """One failed poll (or failed proxy attempt — a connection
        refused on placement is the same evidence)."""
        rec.fail_count += 1
        self._count("fleet_polls_failed")
        if (rec.fail_count >= self.dead_after
                and rec.state not in ("DEAD", "FAILED")):
            # FAILED is sticky past poll silence: its sessions were
            # already evacuated — the on_dead crash-restore volley would
            # re-point clients a second time
            self.mark_dead(rec)

    def mark_dead(self, rec: AgentRecord):
        rec.state = "DEAD"
        rec.recyclable = False
        self._count("fleet_agents_died")
        logger.warning("agent %s declared DEAD after %d failures",
                       rec.agent_id, rec.fail_count)
        if self.on_dead is not None:
            try:
                self.on_dead(rec)
            except Exception:
                logger.exception("fleet on_dead handler failed")

    def mark_failed(self, rec: AgentRecord):
        """Agent self-reported an unrecoverable engine fault
        (POST /fleet/evacuate): out of placement until it re-registers."""
        rec.state = "FAILED"
        rec.recyclable = False
        self._count("fleet_agents_failed")
        logger.warning("agent %s FAILED (engine fault, self-evacuating)",
                       rec.agent_id)

    def ingest_event(self, event: dict, agent_id: str | None) -> str | None:
        """One webhook volley from an agent (StreamDegraded family).
        ``agent_id`` is the owner resolved from the router's session
        table (None when unattributable, e.g. a RETRACE_BREACH's
        synthetic stream id) — the event still counts in the rollup.
        Returns the breach state when the volley was one (the router's
        journey plane auto-captures evidence on exactly that signal),
        else None."""
        self._count("fleet_events_ingested")
        state = str(event.get("state", ""))
        if event.get("event") == "StreamDegraded" and state in BREACH_STATES:
            self._count("fleet_breaches")
            rec = self.agents.get(agent_id) if agent_id else None
            if rec is not None and rec.state == "HEALTHY":
                # accelerate: the next poll confirms or clears this
                rec.state = "DEGRADED"
            return state
        return None

    # -- placement ------------------------------------------------------------

    def pick(self, exclude=(), healthy_only: bool = False) -> AgentRecord | None:
        """The least-loaded agent a new session should land on, or None.
        HEALTHY agents strictly first; DEGRADED ones only when no
        healthy agent can take the session (degraded still serves —
        refuse the fleet over it only when nothing better exists).
        ``healthy_only`` drops the DEGRADED fallback — a migration
        TARGET must be a box worth moving to, not one already alerting.
        Least-loaded = most effective free capacity (unbounded sorts
        first), ties broken by fewest live sessions."""
        now = self._clock()
        candidates = [
            r for r in self.agents.values()
            if r.agent_id not in exclude and r.available(now)
        ]
        for tier in ("HEALTHY",) if healthy_only else ("HEALTHY", "DEGRADED"):
            tier_recs = [r for r in candidates if r.state == tier]
            if not tier_recs:
                continue

            def load_key(r: AgentRecord):
                ec = r.effective_capacity()
                free = float("inf") if ec is None else float(ec)
                return (-free, r.live_sessions + r.placed)

            return min(tier_recs, key=load_key)
        return None

    def note_placed(self, rec: AgentRecord):
        rec.placed += 1
        self._count("fleet_placements")

    def retry_after_hint(self, default_s: float) -> float:
        """One coherent Retry-After for a fleet-wide refusal: the
        SOONEST any non-dead agent might admit again (its backoff window
        remainder, else its advertised hint), floored at 1s so clients
        never hammer."""
        now = self._clock()
        hints = []
        for r in self.agents.values():
            if r.state in ("DEAD", "FAILED") or r.draining:
                continue
            if now < r.not_before:
                hints.append(r.not_before - now)
            elif r.retry_after_s > 0:
                hints.append(r.retry_after_s)
            else:
                hints.append(default_s)
        return max(1.0, min(hints) if hints else default_s)

    # -- observability --------------------------------------------------------

    def snapshot(self) -> dict:
        """Fleet-rollup gauges: aggregated across agents, NEVER keyed by
        agent identity (metric-cardinality discipline — per-agent detail
        lives at /fleet/health, which is JSON-only)."""
        by_state = dict.fromkeys(AGENT_STATES, 0)
        cap_free = 0
        unbounded = 0
        sessions = 0
        recyclable = 0
        for r in self.agents.values():
            by_state[r.state] = by_state.get(r.state, 0) + 1
            sessions += r.live_sessions
            if r.recyclable:
                recyclable += 1
            if r.state in ("HEALTHY", "DEGRADED"):
                ec = r.effective_capacity()
                if ec is None:
                    unbounded += 1
                elif not r.saturated:
                    cap_free += ec
        return {
            "fleet_agents": len(self.agents),
            "fleet_agents_healthy": by_state["HEALTHY"],
            "fleet_agents_degraded": by_state["DEGRADED"],
            "fleet_agents_draining": by_state["DRAINING"],
            "fleet_agents_failed": by_state["FAILED"],
            "fleet_agents_dead": by_state["DEAD"],
            "fleet_agents_recyclable": recyclable,
            "fleet_capacity_free": cap_free,
            "fleet_capacity_unbounded_agents": unbounded,
            "fleet_sessions": sessions,
        }

    def _count(self, name: str, n: int = 1):
        if self.stats is not None:
            # tpurtc: allow[metrics-registry] -- closed set: every name this registry counts is a literal at its call sites (fleet_registers, fleet_registers_refused, fleet_polls_failed, fleet_agents_died, fleet_agents_failed, fleet_events_ingested, fleet_breaches, fleet_placements, fleet_stale_epoch_dropped)
            self.stats.count(name, n)


class FleetPoller:
    """Polls every live agent's /capacity and /health on the overload-tick
    cadence through ``transport`` (fleet/transport.py; without one,
    :meth:`start` opens an aiohttp transport of its own)."""

    def __init__(
        self,
        registry: FleetRegistry,
        *,
        interval_s: float | None = None,
        timeout_s: float | None = None,
        transport=None,
    ):
        self.registry = registry
        self.interval_s = (
            env.get_float("FLEET_POLL_S", 0.25)
            if interval_s is None else interval_s
        )
        self.timeout_s = (
            env.get_float("FLEET_POLL_TIMEOUT_S", 2.0)
            if timeout_s is None else timeout_s
        )
        self._task = None
        self._transport = transport
        self._owns_transport = False

    async def start(self):
        if self._transport is None:
            self._transport = AiohttpTransport(self.timeout_s)
            self._owns_transport = True
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self):
        try:
            while True:
                await asyncio.sleep(self.interval_s)
                try:
                    await self.poll_once()
                except Exception:
                    # the poll task dying is the one failure the fleet
                    # cannot see (stale capacity, no death detection) —
                    # a bad round must never end the loop
                    logger.exception("fleet poll round failed")
        except asyncio.CancelledError:
            pass

    async def poll_once(self):
        """One poll round over the whole membership (public so tests —
        and the drain handler — can drive it without waiting a tick)."""
        recs = [
            r for r in self.registry.agents.values() if r.state != "DEAD"
        ]
        if recs:
            await asyncio.gather(*[self._poll_agent(r) for r in recs])

    async def _poll_agent(self, rec: AgentRecord):
        epoch = rec.epoch
        try:
            cap, health = await asyncio.gather(
                self._get_json(rec.base_url + "/capacity"),
                self._get_json(rec.base_url + "/health"),
            )
        except TransportError as e:
            logger.debug("poll of %s failed: %s", rec.agent_id, e)
            if self.registry.agents.get(rec.agent_id) is not rec:
                return  # superseded mid-poll: not the new record's failure
            self.registry.note_poll_fail(rec)
            return
        if (self.registry.agents.get(rec.agent_id) is not rec
                or rec.epoch != epoch):
            # the record was replaced while this request was in flight —
            # the bodies describe the OLD process, not the current one
            self.registry.note_stale_epoch()
            return
        if (cap is not None and rec.boot_id
                and str(cap.get("boot_id") or "")
                and str(cap.get("boot_id")) != rec.boot_id):
            # a different process answered this record's address (a
            # recycled replacement bound before its worker re-registered)
            self.registry.note_stale_epoch()
            return
        if cap is None and health is None:
            # 200s that carry no parseable agent surface (a reverse proxy
            # serving an error page, garbage JSON) are NOT health — an
            # agent that never answers usefully must still reach DEAD
            self.registry.note_poll_fail(rec)
            return
        self.registry.note_poll(rec, cap, health)

    async def _get_json(self, url: str):
        resp = await self._transport.request("GET", url, timeout=self.timeout_s)
        if resp.status != 200:
            return None
        try:
            body = resp.json()
        except (ValueError, UnicodeDecodeError):
            return None
        # note_poll assumes dict surfaces; a 200 carrying a JSON
        # array/string must read as "no data", not kill the poller
        return body if isinstance(body, dict) else None

    async def stop(self):
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if self._owns_transport:
            await self._transport.close()
            self._transport, self._owns_transport = None, False


class AutoscaleController:
    """Demand-driven fleet sizing: pure decision logic, no
    I/O — the router's tick task samples, calls :meth:`tick`, and
    executes what comes back ("up" = spawn one agent, "down" = retire
    the emptiest via migrate-drain).

    The pressure signal is the fraction of live (non-DEAD, non-draining)
    agents that cannot take a session right now — saturated, inside a
    Retry-After window, or at zero effective capacity — pushed to 1.0
    for any tick in which the ROUTER itself refused a placement
    (``fleet_rejects`` moved): a fleet-wide 503 is full pressure no
    matter what the per-agent reads say.  The sample feeds an EWMA, and
    the overload-ladder hysteresis discipline applies on top: "up" only
    after ``up_ticks`` consecutive smoothed reads at/above ``high`` AND
    the cooldown since the last action has elapsed; "down" only after
    ``down_ticks`` consecutive reads at/below ``low``.  Every action
    resets both streaks and re-arms the cooldown, so one spawn cannot
    cascade into a flap.  ``min_agents``/``max_agents`` bound the fleet;
    the controller is inert unless ``AUTOSCALE_ENABLE`` is on.
    """

    def __init__(
        self,
        registry: FleetRegistry,
        *,
        clock=time.monotonic,
        enabled: bool | None = None,
        high: float | None = None,
        low: float | None = None,
        alpha: float | None = None,
        up_ticks: int | None = None,
        down_ticks: int | None = None,
        cooldown_s: float | None = None,
        min_agents: int | None = None,
        max_agents: int | None = None,
    ):
        self.registry = registry
        self._clock = clock
        self.enabled = (
            env.get_bool("AUTOSCALE_ENABLE", False)
            if enabled is None else enabled
        )
        self.high = (
            env.get_float("AUTOSCALE_HIGH", 0.8) if high is None else high
        )
        self.low = env.get_float("AUTOSCALE_LOW", 0.2) if low is None else low
        self.alpha = (
            env.get_float("AUTOSCALE_ALPHA", 0.3) if alpha is None else alpha
        )
        self.up_ticks = max(1, (
            env.get_int("AUTOSCALE_UP_TICKS", 3)
            if up_ticks is None else up_ticks
        ))
        self.down_ticks = max(1, (
            env.get_int("AUTOSCALE_DOWN_TICKS", 10)
            if down_ticks is None else down_ticks
        ))
        self.cooldown_s = (
            env.get_float("AUTOSCALE_COOLDOWN_S", 30.0)
            if cooldown_s is None else cooldown_s
        )
        self.min_agents = max(1, (
            env.get_int("AUTOSCALE_MIN_AGENTS", 1)
            if min_agents is None else min_agents
        ))
        self.max_agents = (
            env.get_int("AUTOSCALE_MAX_AGENTS", 16)
            if max_agents is None else max_agents
        )
        self.ewma = 0.0
        self._above = 0
        self._below = 0
        self._last_action_at: float | None = None
        self._last_rejects = 0

    def _live(self) -> list[AgentRecord]:
        return [
            r for r in self.registry.agents.values()
            if r.state != "DEAD" and not r.draining
        ]

    def sample(self, rejects_total: int = 0) -> float:
        """One raw pressure observation in [0, 1]."""
        rejected = rejects_total > self._last_rejects
        self._last_rejects = max(self._last_rejects, rejects_total)
        live = self._live()
        if not live:
            # an empty (or fully draining) fleet refusing traffic is the
            # definition of under-provisioned; idle-and-empty is calm
            return 1.0 if rejected else 0.0
        if rejected:
            return 1.0
        now = self._clock()
        pressed = sum(
            1 for r in live
            if r.saturated or not r.available(now)
            or r.effective_capacity() == 0
        )
        return pressed / len(live)

    def tick(self, rejects_total: int = 0) -> str | None:
        """Fold one observation in; return "up", "down", or None.
        Callers execute the decision — a returned action re-arms the
        cooldown even if execution later fails (failed spawns must not
        retry at tick cadence)."""
        if not self.enabled:
            return None
        p = self.sample(rejects_total)
        self.ewma += self.alpha * (p - self.ewma)
        if self.ewma >= self.high:
            self._above += 1
            self._below = 0
        elif self.ewma <= self.low:
            self._below += 1
            self._above = 0
        else:
            self._above = 0
            self._below = 0
        now = self._clock()
        if (self._last_action_at is not None
                and now - self._last_action_at < self.cooldown_s):
            return None
        n_live = len(self._live())
        if self._above >= self.up_ticks and n_live < self.max_agents:
            self._mark_action(now)
            return "up"
        if (self._below >= self.down_ticks and n_live > self.min_agents
                and self.retire_candidate() is not None):
            self._mark_action(now)
            return "down"
        return None

    def _mark_action(self, now: float):
        self._last_action_at = now
        self._above = 0
        self._below = 0

    def retire_candidate(self) -> AgentRecord | None:
        """The emptiest HEALTHY agent, or None when shrinking would
        break the floor (migration makes retirement free, but only a
        box in good standing is worth paying a sweep for)."""
        live = self._live()
        if len(live) <= self.min_agents:
            return None
        healthy = [r for r in live if r.state == "HEALTHY"]
        if not healthy:
            return None
        return min(healthy, key=lambda r: (r.live_sessions + r.placed))

    def snapshot(self) -> dict:
        """Rollup gauges (zero-cardinality: no agent identity)."""
        return {
            "autoscale_pressure_ewma": round(self.ewma, 4),
            "autoscale_up_streak": self._above,
            "autoscale_down_streak": self._below,
        }
