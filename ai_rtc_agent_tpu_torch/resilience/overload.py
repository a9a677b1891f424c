"""Overload control plane: admission, bounded deadline queues, shedding
(the port's copy of ai_rtc_agent_tpu/resilience/overload.py; its network
half, the netadapt ladder of each session, is resilience/netadapt.py).

The stream-batch pipeline's unit of work is a *perishable frame*: a frame
delivered late is worth less than no frame at all, because every queued
stale frame delays every frame behind it.  Left alone, one slow diffusion
step turns into compounding latency at every hop — the classic overload
collapse.  This module applies the DAGOR discipline (adaptive admission +
load shedding, "Overload Control for Scaling WeChat Microservices",
SoCC '18) to that frame path:

* :class:`DeadlineQueue` — every hop where frames or packets can pile up
  gets an explicit bound and a per-entry freshness stamp.  On pressure the
  policy is **freshest-frame-wins**: the *oldest* undelivered entry is
  dropped, the caller never blocks, and every shed is counted by reason
  (``overflow`` vs ``stale``).
* :class:`AdmissionController` — live pressure signals (engine
  step-latency EWMA, event-loop lag from :class:`LoopLagWatchdog`, a
  session cap) gate *new* sessions: ``/offer``/``/whip`` turn into
  503 + ``Retry-After`` **before** the box accepts a stream it cannot
  hold, and the worker sidecar publishes remaining capacity instead of a
  boolean "ready".
* :class:`OverloadLadder` — sustained pressure walks each live session
  down a shedding ladder (process every frame → 1-in-2 → 1-in-4 →
  passthrough → admission freeze) with hysteresis, and back up on
  recovery.  The passthrough rung rides the existing supervisor machinery
  (:meth:`SessionSupervisor.note_overload` → DEGRADED; the first healthy
  steps after de-escalation drive DEGRADED → RECOVERING → HEALTHY), so
  there is exactly one per-session health state machine.
* :class:`OverloadControlPlane` — owns the above per agent process,
  registers sessions/queues, ticks the ladders, and snapshots everything
  for ``/metrics`` in O(sessions) without touching any frame queue's
  contents.

Everything is injectable (clock, env-free ctor args) so the whole plane
unit-tests without wall-clock sleeps, and the chaos tier reproduces
overload deterministically via the existing fault plans (faults.py
``slow_step``).
"""

from __future__ import annotations

import asyncio
import collections
import logging
import threading
import time
from concurrent.futures import InvalidStateError

from ..utils import env

logger = logging.getLogger(__name__)

# ladder rungs, mildest first; _SKIP[r] = process 1 of every N frames
# (0 = probe-only: one frame per probe interval keeps the step-latency
# signal alive so the ladder can ever climb back down)
RUNG_LABELS = ("normal", "skip2", "skip4", "passthrough", "frozen")
_SKIP = (1, 2, 4, 0, 0)
RUNG_PASSTHROUGH = RUNG_LABELS.index("passthrough")
RUNG_FROZEN = RUNG_LABELS.index("frozen")


class ShedFrame:
    """Marker wrapping the source pixels of a frame a bounded queue shed
    under pressure.  The shed frame's waiter unblocks with passthrough
    pixels immediately (recv never hangs), but the marker lets upstream
    accounting tell it apart from real engine output: a shed must never
    feed the admission step EWMA or count as a healthy engine step — a
    ~0ms "step" would dilute the pressure signal at exactly the moment
    the shed is evidence of overload."""

    __slots__ = ("frame",)

    def __init__(self, frame):
        self.frame = frame


def shed_to_passthrough(future, frame):
    """Resolve a shed frame's waiter at once with its ``ShedFrame`` (a
    waiter already cancelled or resolved stays so)."""
    try:
        if not future.done():
            future.set_result(ShedFrame(frame))
    except InvalidStateError:
        pass  # lost a race with a cancel: the waiter is unblocked either way


class DeadlineQueue:
    """Bounded freshest-frame-wins queue with per-entry deadline stamps.

    ``push`` never blocks: at the bound the OLDEST entry is shed (counted
    as ``overflow``).  ``pop`` returns the oldest entry still inside its
    deadline, shedding expired ones on the way (counted as ``stale``).
    Thread-safe; depth and shed counters are plain ints readable without
    the lock (GIL-atomic loads), which is what keeps /metrics snapshots
    O(1) per queue.
    """

    def __init__(
        self,
        bound: int,
        deadline_s: float = 0.0,
        clock=time.monotonic,
        on_shed=None,
        on_evict=None,
    ):
        self.bound = max(1, int(bound))
        self.deadline_s = deadline_s
        self._clock = clock
        self._on_shed = on_shed  # callable(reason, n) — metrics hook
        # callable(item, reason) — hands every shed ITEM back to the owner
        # (outside the lock).  The batch scheduler needs this: a shed frame
        # carries a waiter future that must resolve as passthrough, not
        # vanish inside the queue (stream/scheduler.py coalescing window)
        self._on_evict = on_evict
        self._lock = threading.Lock()
        self._q: collections.deque = collections.deque(maxlen=self.bound)
        self.shed_overflow = 0
        self.shed_stale = 0

    @property
    def depth(self) -> int:
        return len(self._q)

    def push(self, item, stamp: float | None = None) -> bool:
        """Append ``item``; -> True when the bound forced a shed."""
        shed = None
        with self._lock:
            if len(self._q) >= self.bound:
                # freshest-frame-wins: the OLDEST queued entry is the one
                # whose delivery value has decayed furthest — drop it, keep
                # the newcomer (never drop-new, never block)
                shed = self._q.popleft()
                self.shed_overflow += 1
            self._q.append((item, self._clock() if stamp is None else stamp))
        if shed is not None:
            if self._on_evict is not None:
                self._on_evict(shed[0], "overflow")
            if self._on_shed is not None:
                self._on_shed("overflow", 1)
        return shed is not None

    def pop(self):
        """-> (item, stamp) of the oldest in-deadline entry, or None."""
        stale = []
        out = None
        with self._lock:
            now = self._clock()
            while self._q:
                item, stamp = self._q.popleft()
                if self.deadline_s and now - stamp > self.deadline_s:
                    stale.append(item)
                    continue
                out = (item, stamp)
                break
            self.shed_stale += len(stale)
        if stale:
            if self._on_evict is not None:
                for item in stale:
                    self._on_evict(item, "stale")
            if self._on_shed is not None:
                self._on_shed("stale", len(stale))
        return out

    def oldest_stamp(self) -> float | None:
        """Enqueue stamp of the oldest queued entry (None when empty) —
        the batch scheduler's coalescing window is measured from this."""
        with self._lock:
            return self._q[0][1] if self._q else None

    def clear(self):
        with self._lock:
            self._q.clear()


class QueueProbe:
    """Snapshot adapter over a foreign bounded queue (e.g. an
    asyncio.Queue source track): depth/bound reads for /metrics; the
    owning hop counts its own sheds."""

    shed_overflow = 0
    shed_stale = 0

    def __init__(self, q):
        self._q = q

    @property
    def depth(self) -> int:
        q = self._q
        return q.qsize() if hasattr(q, "qsize") else len(q)

    @property
    def bound(self) -> int:
        b = getattr(self._q, "maxsize", None) or getattr(
            self._q, "maxlen", None
        )
        return b if b else -1


class Ewma:
    """Exponentially-weighted moving average; 0.0 until the first sample."""

    __slots__ = ("alpha", "value", "samples")

    def __init__(self, alpha: float = 0.4):
        self.alpha = alpha
        self.value = 0.0
        self.samples = 0

    def update(self, x: float) -> float:
        self.samples += 1
        if self.samples == 1:
            self.value = x
        else:
            self.value = self.alpha * x + (1.0 - self.alpha) * self.value
        return self.value


class AdmissionController:
    """Cost-aware admission: live pressure signals decide whether this box
    can hold one more session — refusing at the door (503 + Retry-After)
    instead of accepting a stream that will only add to the collapse.

    Signals: engine step-latency EWMA vs its budget, event-loop lag EWMA
    vs its budget, an optional hard session cap, and freeze holds from
    ladders that reached the top rung."""

    def __init__(
        self,
        *,
        step_budget_s: float = 1.0,
        lag_budget_s: float = 0.2,
        max_sessions: int = 0,
        retry_after_s: float = 2.0,
        clock=time.monotonic,
    ):
        self.step_budget_s = max(1e-6, step_budget_s)
        self.lag_budget_s = max(1e-6, lag_budget_s)
        self.max_sessions = max(0, int(max_sessions))
        self.retry_after_base_s = retry_after_s
        self._clock = clock
        self.step_ewma = Ewma()
        self.lag_ewma = Ewma()
        self._last_step_t: float | None = None
        self._freeze_holds = 0
        self._freeze_lock = threading.Lock()
        self.rejected = 0

    # -- signal feeds (any thread; EWMA writes are GIL-atomic enough) -------

    def note_step_latency(self, dt_s: float):
        self._last_step_t = self._clock()
        self.step_ewma.update(dt_s)

    def note_step_timeout(self, budget_s: float):
        """A step that blew its budget never reports a true duration — feed
        the budget doubled so wedged steps register as severe, not absent."""
        self.note_step_latency(budget_s * 2.0)

    def decay_stale_step_signal(
        self, stale_after_s: float, factor: float = 0.8
    ):
        """No step sample for ``stale_after_s`` means the step signal is
        evidence-free — the last session left, or frames stopped flowing
        entirely.  Without decay a single wedged step (EWMA pinned at 2x
        budget) would keep pressure >= 1 and an IDLE box would 503 every
        new session until process restart.  Called from the control
        plane's tick loop."""
        if self.step_ewma.value == 0.0:
            return
        t = self._last_step_t
        if t is None or self._clock() - t > stale_after_s:
            self.step_ewma.value *= factor

    def note_loop_lag(self, lag_s: float):
        self.lag_ewma.update(lag_s)

    # -- freeze holds (top ladder rung; counted so N sessions compose) ------

    def hold_freeze(self):
        with self._freeze_lock:
            self._freeze_holds += 1

    def release_freeze(self):
        with self._freeze_lock:
            self._freeze_holds = max(0, self._freeze_holds - 1)

    @property
    def frozen(self) -> bool:
        return self._freeze_holds > 0

    # -- decisions -----------------------------------------------------------

    def pressure(self) -> float:
        """Composite pressure: >= 1.0 means at least one signal is over
        budget (the worst signal dominates — overload is a max, not a
        mean: one saturated resource is enough to collapse)."""
        return max(
            self.step_ewma.value / self.step_budget_s,
            self.lag_ewma.value / self.lag_budget_s,
        )

    def retry_after_s(self) -> float:
        """Backpressure hint scaled by how far over budget the box is,
        clamped so clients neither hammer nor give up."""
        return self.retry_after_base_s * min(8.0, max(1.0, self.pressure()))

    def admit(self, live_sessions: int = 0) -> tuple[bool, float]:
        """-> (admit, retry_after_s).  Refuses while frozen, over pressure,
        or at the session cap."""
        if self.frozen or self.pressure() >= 1.0:
            self.rejected += 1
            return False, self.retry_after_s()
        if self.max_sessions and live_sessions >= self.max_sessions:
            self.rejected += 1
            return False, self.retry_after_base_s
        return True, 0.0

    def capacity(
        self, live_sessions: int = 0, free_slots: int | None = None
    ) -> dict:
        """Remaining-session estimate for the worker sidecar's publish —
        capacity, not a boolean.  ``-1`` = no structural bound.
        ``saturated`` covers everything that would make /offer 503 —
        pressure/freeze, the session cap, AND an exhausted slot pool
        (``free_slots=0``; /offer refuses at the claim even when the
        admission controller itself would admit) — so an orchestrator
        reading /capacity never routes to a box whose /offer would 503."""
        pressured = self.frozen or self.pressure() >= 1.0
        full = (
            bool(self.max_sessions) and live_sessions >= self.max_sessions
        ) or (free_slots is not None and free_slots <= 0)
        # tightest structural bound wins: advertising free engine slots
        # beyond the session-cap headroom (or vice versa) oversells —
        # admit()/the slot claim would 503 the excess
        bounds = []
        if free_slots is not None:
            bounds.append(free_slots)
        if self.max_sessions:
            bounds.append(self.max_sessions - live_sessions)
        if pressured:
            cap = 0
        elif bounds:
            cap = max(0, min(bounds))
        else:
            cap = -1
        if pressured:
            retry = self.retry_after_s()
        elif full:
            retry = self.retry_after_base_s
        else:
            retry = 0.0
        return {
            "capacity": cap,
            "saturated": pressured or full,
            "retry_after_s": round(retry, 3),
        }


class LoopLagWatchdog:
    """Event-loop lag sampler: ``asyncio.sleep(dt)`` returning late means
    the loop is saturated — every session in the process shares that loop,
    so lag is a first-class admission signal, not a curiosity."""

    def __init__(
        self,
        admission: AdmissionController,
        interval_s: float = 0.1,
        clock=time.monotonic,
    ):
        self.admission = admission
        self.interval_s = interval_s
        self._clock = clock
        self._task = None

    def start(self):
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self._task

    async def _run(self):
        try:
            while True:
                t0 = self._clock()
                await asyncio.sleep(self.interval_s)
                lag = max(0.0, self._clock() - t0 - self.interval_s)
                self.admission.note_loop_lag(lag)
        except asyncio.CancelledError:
            pass

    def stop(self):
        if self._task is not None:
            self._task.cancel()
            self._task = None

    @property
    def lag_ms(self) -> float:
        return 1e3 * self.admission.lag_ewma.value


class OverloadLadder:
    """Per-session shedding ladder with hysteresis.

    ``tick(pressure)`` runs on the control plane's cadence: ``up_after``
    consecutive pressure ticks escalate one rung, ``down_after`` quiet
    ticks de-escalate one — asymmetric on purpose (shed fast, recover
    deliberately).  ``admit_frame()`` is the hot-path gate consulted by
    the resilient pipeline wrapper; skipped frames are delivered as
    passthrough, so the stream thins instead of freezing.  The
    passthrough rung flips the session's supervisor to DEGRADED (no
    restart — this is capacity, not a fault); the top rung additionally
    holds an admission freeze."""

    def __init__(
        self,
        session_id: str,
        admission: AdmissionController,
        supervisor=None,
        *,
        up_after: int = 3,
        down_after: int = 8,
        probe_interval_s: float = 1.0,
        clock=time.monotonic,
        on_rung=None,
    ):
        self.session_id = session_id
        self.admission = admission
        self.supervisor = supervisor
        self.up_after = max(1, up_after)
        self.down_after = max(1, down_after)
        self.probe_interval_s = probe_interval_s
        self._clock = clock
        self._on_rung = on_rung  # callable(old, new) — metrics hook
        self.rung = 0
        self._hot = 0
        self._cool = 0
        self._frame_i = 0
        self._next_probe = 0.0
        self.frames_skipped = 0
        self._closed = False
        # frame-skip floor imposed by the session's NETWORK ladder
        # (resilience/netadapt.py): the effective rung is the max of
        # compute and network pressure.  Clamped below passthrough — a bad
        # network degrades quality, never engine output, on its own.
        self.net_floor = 0

    # -- cadence (control-plane tick task) -----------------------------------

    def tick(self, pressure: bool):
        if self._closed:
            return
        if pressure:
            self._hot += 1
            self._cool = 0
            if self._hot >= self.up_after and self.rung < RUNG_FROZEN:
                self._move(self.rung + 1)
                self._hot = 0
            elif self.rung >= RUNG_PASSTHROUGH and self.supervisor is not None:
                # successful (slow) probe steps would otherwise walk the
                # supervisor back to HEALTHY while this ladder still sheds
                # every frame — keep /health truthful: shedding under
                # pressure IS degraded (note_overload only ever transitions
                # from HEALTHY/RECOVERING, so this is idempotent)
                self.supervisor.note_overload(
                    f"overload shedding: {RUNG_LABELS[self.rung]}"
                )
        else:
            self._cool += 1
            self._hot = 0
            if self._cool >= self.down_after and self.rung > 0:
                self._move(self.rung - 1)
                self._cool = 0

    def _move(self, new: int):
        old, self.rung = self.rung, new
        logger.warning(
            "session %s: overload ladder %s -> %s",
            self.session_id, RUNG_LABELS[old], RUNG_LABELS[new],
        )
        if new > old and not _SKIP[new]:
            # escalating INTO a probe-only rung: the pressure reading that
            # brought us here is fresh — schedule the first probe a full
            # interval out instead of burning one immediately
            self._next_probe = self._clock() + self.probe_interval_s
        if new >= RUNG_FROZEN > old:
            self.admission.hold_freeze()
        elif old >= RUNG_FROZEN > new:
            self.admission.release_freeze()
        if new >= RUNG_PASSTHROUGH > old and self.supervisor is not None:
            # reuse the one health machine: DEGRADED without a restart —
            # the engine is fine, the box is over capacity.  The first
            # healthy steps after de-escalation walk it back through
            # RECOVERING to HEALTHY (supervisor.on_step_ok).
            self.supervisor.note_overload(
                f"overload shedding: {RUNG_LABELS[new]}"
            )
        elif old >= RUNG_PASSTHROUGH > new and self.supervisor is not None:
            # de-escalated below the shedding rungs: release the hold so
            # real steps can recover the session normally
            self.supervisor.note_overload_clear()
        if self._on_rung is not None:
            self._on_rung(old, new)

    # -- network-ladder join (resilience/netadapt.py) -------------------------

    def set_net_floor(self, floor: int):
        """Impose a frame-skip floor from network pressure.  Clamped to the
        skip rungs: passthrough/frozen stay compute-ladder decisions (shed
        before you batch; degrade quality before you degrade freshness)."""
        self.net_floor = max(0, min(int(floor), RUNG_PASSTHROUGH - 1))

    @property
    def effective_rung(self) -> int:
        """The rung the hot path actually runs: max(compute, network)."""
        return max(self.rung, self.net_floor)

    # -- hot path (pipeline wrapper) ------------------------------------------

    def admit_frame(self) -> bool:
        """Should THIS frame run the engine?  False = deliver passthrough."""
        r = self.effective_rung
        if r == 0:
            return True
        self._frame_i += 1
        skip = _SKIP[r]
        if skip:
            if self._frame_i % skip == 0:
                return True
        else:
            # probe-only rungs: one engine frame per interval keeps the
            # step-latency EWMA fed, otherwise pressure could never clear
            now = self._clock()
            if now >= self._next_probe:
                self._next_probe = now + self.probe_interval_s
                return True
        self.frames_skipped += 1
        return False

    def note_step(self, dt_s: float):
        self.admission.note_step_latency(dt_s)

    def note_step_timeout(self, budget_s: float):
        self.admission.note_step_timeout(budget_s)

    def close(self):
        """Session teardown: release any freeze hold this ladder owns."""
        if self._closed:
            return
        self._closed = True
        if self.rung >= RUNG_FROZEN:
            self.admission.release_freeze()
        self.rung = 0


class OverloadControlPlane:
    """One per agent process: owns the admission controller, the lag
    watchdog, the per-session ladders and the queue registry; ticks the
    ladders; snapshots for /metrics.

    Snapshots are O(sessions): per-queue depth/shed counters and per-ladder
    rung/skip counters are plain int reads — frame queues are never
    traversed, so the observability endpoints themselves survive overload.
    """

    def __init__(self, stats=None, clock=time.monotonic):
        self._clock = clock
        self.stats = stats  # FrameStats — counters land as overload_*_total
        self.frame_deadline_s = (
            env.get_float("OVERLOAD_FRAME_DEADLINE_MS", 500.0) / 1e3
        )
        self.tick_s = env.get_float("OVERLOAD_TICK_S", 0.25)
        self.admission = AdmissionController(
            step_budget_s=env.get_float("OVERLOAD_STEP_BUDGET_MS", 1000.0) / 1e3,
            lag_budget_s=env.get_float("OVERLOAD_LOOP_LAG_BUDGET_MS", 200.0) / 1e3,
            max_sessions=env.get_int("OVERLOAD_MAX_SESSIONS", 0),
            retry_after_s=env.get_float("OVERLOAD_RETRY_AFTER_S", 2.0),
            clock=clock,
        )
        self.lag = LoopLagWatchdog(
            self.admission,
            interval_s=env.get_float("OVERLOAD_LAG_INTERVAL_MS", 100.0) / 1e3,
            clock=clock,
        )
        self._up_after = env.get_int("OVERLOAD_UP_TICKS", 3)
        self._down_after = env.get_int("OVERLOAD_DOWN_TICKS", 8)
        self._probe_s = env.get_float("OVERLOAD_PROBE_S", 1.0)
        self.ladders: dict = {}
        self.queues: dict = {}
        # admitted-but-not-yet-registered sessions: registration only
        # happens when on_track fires (inside the awaited
        # setRemoteDescription), so without a reservation a burst of
        # concurrent offers would all see len(ladders)==0 and sail past
        # OVERLOAD_MAX_SESSIONS.  admission_gate() reserves; session
        # registration (or explicit release on a failed offer) consumes;
        # the TTL expires strays from sessions that never deliver a
        # video track, so a leaked reservation cannot shrink the cap
        # forever.  TTL is setup-sized (TURN fetch + SDP dance), not an
        # operator knob.
        self._pending: dict = {}  # session key -> reservation deadline
        self._pending_ttl_s = 30.0
        # flight-recorder hook (obs/recorder.py): callable(session_key,
        # kind, **data) fed ladder rung moves — overload escalation is
        # exactly what a post-mortem needs on its event timeline
        self.on_event = None
        # ladder-cadence hook: callable() fired once per tick — the
        # device-telemetry plane (obs/devtel.py) samples device memory
        # on it (rate-limited on its side; failures never break a tick)
        self.on_tick = None
        # delivered-frame freshness reservoir (bounded; appended per frame,
        # percentiles computed per snapshot over <=512 floats — cost is
        # constant, independent of session count or queue depth)
        self._fresh: collections.deque = collections.deque(maxlen=512)
        self._task = None
        # drain-for-recycle (fleet tier, ISSUE 11): one counted freeze
        # hold owned by the drain surface — admission refuses, live
        # sessions finish untouched, /capacity says saturated+draining
        self._draining = False
        # network-adaptation ladders (resilience/netadapt.py) ride the same
        # tick cadence; NETADAPT=0 removes the subsystem per process
        self.netadapt_enabled = env.get_bool("NETADAPT", True)
        self._na_up = env.get_int("NETADAPT_UP_TICKS", 2)
        self._na_down = env.get_int("NETADAPT_DOWN_TICKS", 12)
        self._na_loss_up = env.get_float("NETADAPT_LOSS_UP", 0.08)
        self._na_loss_down = env.get_float("NETADAPT_LOSS_DOWN", 0.02)
        self._na_base_bitrate = env.get_int_aliased(
            "ENC_DEFAULT_BITRATE", "NVENC_DEFAULT_BITRATE", 3_000_000
        )
        self._na_min_bitrate = env.get_int("NETADAPT_MIN_BITRATE", 250_000)
        self._na_factor = env.get_float("NETADAPT_BITRATE_FACTOR", 0.6)
        self._na_coalesce_s = env.get_float("NETADAPT_PLI_COALESCE_MS", 700.0) / 1e3
        self._na_rr_timeout_s = env.get_float("NETADAPT_RR_TIMEOUT_S", 6.0)
        self._na_fb_burst = env.get_int("NETADAPT_FEEDBACK_BURST", 8)
        self.netadapt: dict = {}

    # -- session / queue registry --------------------------------------------

    def register_session(self, key: str, supervisor=None) -> OverloadLadder:
        self._pending.pop(key, None)  # reservation becomes a live ladder
        ladder = OverloadLadder(
            key,
            self.admission,
            supervisor,
            up_after=self._up_after,
            down_after=self._down_after,
            probe_interval_s=self._probe_s,
            clock=self._clock,
            on_rung=lambda old, new, key=key: self._rung_moved(key, old, new),
        )
        self.ladders[key] = ladder
        return ladder

    def register_netadapt(self, key: str):
        """The session's network rung (resilience/netadapt.py), joined to
        its compute ladder when one is registered; None when NETADAPT=0.
        Rung moves land in the same stats counter and event hook as compute
        rung moves."""
        if not self.netadapt_enabled:
            return None
        from .netadapt import NetworkAdaptLadder

        na = NetworkAdaptLadder(
            key,
            up_after=self._na_up,
            down_after=self._na_down,
            loss_up=self._na_loss_up,
            loss_down=self._na_loss_down,
            base_bitrate=self._na_base_bitrate,
            min_bitrate=self._na_min_bitrate,
            bitrate_factor=self._na_factor,
            pli_coalesce_s=self._na_coalesce_s,
            rr_timeout_s=self._na_rr_timeout_s,
            feedback_burst=self._na_fb_burst,
            compute_ladder=self.ladders.get(key),
            clock=self._clock,
            on_rung=lambda old, new, key=key: self._na_moved(key, old, new),
        )
        self.netadapt[key] = na
        return na

    def _na_moved(self, key: str, old: int, new: int):
        from .netadapt import NET_RUNG_LABELS

        if self.stats is not None:
            self.stats.count("netadapt_ladder_moves")
        cb = self.on_event
        if cb is not None:
            try:
                cb(key, "netadapt_rung", old=NET_RUNG_LABELS[old], new=NET_RUNG_LABELS[new])
            except Exception:
                logger.exception("netadapt on_event handler failed")

    def unregister_session(self, key: str):
        self._pending.pop(key, None)
        ladder = self.ladders.pop(key, None)
        if ladder is not None:
            ladder.close()
        na = self.netadapt.pop(key, None)
        if na is not None:
            na.close()
        # session-scoped queue registrations ("<kind>:<session>") go too
        for name in [n for n in self.queues if n.endswith(f":{key}")]:
            self.queues.pop(name, None)

    def _rung_moved(self, key: str, old: int, new: int):
        if self.stats is not None:
            self.stats.count("overload_ladder_moves")
        cb = self.on_event
        if cb is not None:
            try:
                cb(
                    key, "overload_rung",
                    old=RUNG_LABELS[old], new=RUNG_LABELS[new],
                )
            except Exception:
                logger.exception("overload on_event handler failed")

    def register_queue(self, name: str, q) -> object:
        """Register any object exposing ``depth``/``bound``/``shed_overflow``
        /``shed_stale`` for the /metrics snapshot."""
        self.queues[name] = q
        return q

    def unregister_queue(self, name: str):
        self.queues.pop(name, None)

    # -- frame-path hooks (VideoStreamTrack) ----------------------------------

    def frame_age(self, frame) -> float:
        """Seconds since the frame's decode stamp (0 when unstamped)."""
        wall = getattr(frame, "wall_ts", None)
        if wall is None:
            return 0.0
        return max(0.0, self._clock() - wall)

    def note_shed_ingest(self, n: int = 1):
        if self.stats is not None:
            self.stats.count("overload_shed_ingest", n)

    def note_delivered(self, age_s: float):
        self._fresh.append(age_s)

    # -- admission gate (HTTP handlers) ---------------------------------------

    def _expire_pending(self):
        now = self._clock()
        for key in [k for k, exp in self._pending.items() if exp <= now]:
            self._pending.pop(key, None)

    def admission_gate(self, key: str | None = None) -> tuple[bool, float]:
        """Admit or refuse a new session.  ``key`` (the session id) makes
        the admission a counted reservation until :meth:`register_session`
        converts it, :meth:`release_admission` cancels it (failed offer),
        or the TTL expires it — so concurrent offers racing ahead of
        on_track still see each other at the session cap."""
        self._expire_pending()
        ok, retry_after = self.admission.admit(
            live_sessions=len(self.ladders) + len(self._pending)
        )
        if ok and key is not None:
            self._pending[key] = self._clock() + self._pending_ttl_s
        if not ok and self.stats is not None:
            self.stats.count("overload_admission_rejected")
        return ok, retry_after

    def release_admission(self, key: str):
        """Cancel a reservation for an offer that failed before its track
        (and therefore its ladder) ever existed."""
        self._pending.pop(key, None)

    def adopt_reservation(self, old_key: str, new_key: str) -> bool:
        """Move a reservation to a new session key (the migration handshake:
        /migrate/import reserved under its token; the adopting re-offer
        serves under a new stream id), with its original deadline.  False
        when it already expired: the caller runs the gate instead."""
        self._expire_pending()
        deadline = self._pending.pop(old_key, None)
        if deadline is None:
            return False
        self._pending[new_key] = deadline
        return True

    def capacity(self, free_slots: int | None = None) -> dict:
        """/capacity body: admission view of remaining headroom, with
        pending reservations counted as live so a burst of in-flight
        offers is not double-sold to orchestrators.  ``draining`` tells
        the fleet router this box is being recycled on purpose — the
        freeze hold already zeroes capacity and flips ``saturated``."""
        self._expire_pending()
        out = self.admission.capacity(
            live_sessions=len(self.ladders) + len(self._pending),
            free_slots=free_slots,
        )
        out["draining"] = self._draining
        return out

    # -- drain-for-recycle (fleet control plane, POST /drain) -----------------

    def begin_drain(self) -> bool:
        """Stop admitting via the admission-freeze rung so live sessions
        can finish and an orchestrator can recycle the process.  Counted
        (one hold per plane, idempotent) so a drain composes with
        ladders at the frozen rung.  -> True when state changed."""
        if self._draining:
            return False
        self._draining = True
        self.admission.hold_freeze()
        logger.warning("admission drain engaged (freeze hold)")
        return True

    def end_drain(self) -> bool:
        """Cancel a drain: release the freeze hold; admission resumes
        under the normal pressure signals.  -> True when state changed."""
        if not self._draining:
            return False
        self._draining = False
        self.admission.release_freeze()
        logger.warning("admission drain released")
        return True

    @property
    def draining(self) -> bool:
        return self._draining

    # -- cadence ---------------------------------------------------------------

    async def start(self):
        self.lag.start()
        self._task = asyncio.get_running_loop().create_task(self._tick_loop())

    async def _tick_loop(self):
        try:
            while True:
                await asyncio.sleep(self.tick_s)
                self.tick()
        except asyncio.CancelledError:
            pass

    def tick(self):
        """One ladder cadence step (public so tests drive it clocklessly)."""
        # stale-evidence decay: the lag signal is self-refreshing (the
        # watchdog samples regardless of traffic) but the step signal only
        # exists while frames flow — decay it once samples stop arriving
        # so a departed/silent session cannot pin admission shut
        self.admission.decay_stale_step_signal(
            max(2.0 * self._probe_s, 4.0 * self.tick_s)
        )
        self._expire_pending()
        pressure = self.admission.pressure() >= 1.0
        for ladder in list(self.ladders.values()):
            ladder.tick(pressure)
        for na in list(self.netadapt.values()):
            na.tick()
        cb = self.on_tick
        if cb is not None:
            try:
                cb()
            except Exception:
                logger.exception("overload on_tick hook failed")

    def stop(self):
        self.lag.stop()
        self.end_drain()  # release the drain's freeze hold on teardown
        if self._task is not None:
            self._task.cancel()
            self._task = None
        for key in list(self.ladders):
            self.unregister_session(key)

    # -- observability ---------------------------------------------------------

    def snapshot(self) -> dict:
        """Flat gauges + a per-queue sub-dict; O(sessions + queues) int
        reads, never a frame-queue traversal."""
        fresh = sorted(self._fresh)
        out = {
            "overload_pressure": round(self.admission.pressure(), 4),
            "overload_step_ewma_ms": round(
                1e3 * self.admission.step_ewma.value, 3
            ),
            "overload_loop_lag_ms": round(1e3 * self.admission.lag_ewma.value, 3),
            "overload_admission_frozen": int(self.admission.frozen),
            "overload_draining": int(self._draining),
            "overload_sessions": len(self.ladders),
            "overload_admission_pending": len(self._pending),
            "overload_rung_max": max(
                (lad.rung for lad in self.ladders.values()), default=0
            ),
            "overload_rung_effective_max": max(
                (lad.effective_rung for lad in self.ladders.values()),
                default=0,
            ),
            "overload_frames_skipped": sum(
                lad.frames_skipped for lad in self.ladders.values()
            ),
            "netadapt_rung_max": max(
                (na.rung for na in self.netadapt.values()), default=0
            ),
            "netadapt_loss_ewma_max": round(
                max((na.loss_ewma.value for na in self.netadapt.values()), default=0.0), 4
            ),
        }
        if fresh:
            n = len(fresh)
            out["overload_freshness_p50_ms"] = round(1e3 * fresh[n // 2], 3)
            out["overload_freshness_p99_ms"] = round(
                1e3 * fresh[min(n - 1, int(n * 0.99))], 3
            )
        out["overload_queues"] = {
            name: {
                "depth": q.depth,
                "bound": q.bound,
                "shed_overflow": q.shed_overflow,
                "shed_stale": q.shed_stale,
            }
            for name, q in self.queues.items()
        }
        return out
