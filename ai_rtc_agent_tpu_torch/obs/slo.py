"""Stage-latency SLO plane: per-hop budgets, burn rates, breach events
(the port's copy of ai_rtc_agent_tpu/obs/slo.py, with the same stage
budgets and knobs).

Every completed frame timeline (obs/trace.py) feeds fixed-bucket latency
histograms, one per stage, per session and process-wide, and an
over-budget counter against the stage's budget (``SLO_<STAGE>_BUDGET_MS``).
A tick task (``SLO_TICK_S``) derives **multi-window burn rates** from
those counters:

* *burn* = (fraction of frames over budget in the window) / (1 −
  ``SLO_OBJECTIVE``): burn 1.0 spends the error budget exactly, burn N
  spends it N times too fast;
* a breach needs both the **slow window** (``SLO_SLOW_WINDOW_S``) and the
  **fast window** (``SLO_FAST_WINDOW_S``) at or over
  ``SLO_BURN_THRESHOLD`` for ``SLO_UP_TICKS`` consecutive ticks, and
  clears after ``SLO_DOWN_TICKS`` ticks with the fast window quiet.

A breach transition shows three ways: the per-session SLO state at
``GET /health``, an ``slo`` entry in the flight recorder's event log, and
the StreamDegraded webhook (``state="SLO_BREACH"``).  The process-wide
histograms are served as Prometheus histograms by obs/promexport.py
(``/metrics?format=prom``).

:class:`~.trace.SessionTracer` mints a timeline whenever this plane is on
(even with tracing off; the completed-timeline ring is kept only while
tracing proper is on) and hands every sealed timeline to
:meth:`SloPlane.observe`.  ``SLO_ENABLE=0`` turns the plane off.  Exported
label values come only from the closed STAGES enum; per-session detail
lives at /health, never as a /metrics label.

The budgets are the JAX package's, set for 30 fps; they are not retuned
for the card (a budget the card misses is a finding, not a default to
move).
"""

from __future__ import annotations

import bisect
import collections
import logging
import threading

from ..utils import env
from .trace import STAGES

# fixed bucket upper bounds, milliseconds — chosen to straddle every
# stage's regime (µs-scale packetize/protect up to multi-second compile
# stalls); cumulative rendering + the +Inf terminal happen at export
BUCKET_BOUNDS_MS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
)

STATE_OK = "ok"
STATE_BREACH = "breach"


def stage_budgets_ms() -> dict:
    """Per-stage latency budgets, ``SLO_<STAGE>_BUDGET_MS`` each (the JAX
    defaults).  They bracket the 30 fps steady-state numbers with headroom;
    the engine_step and batch_join budgets assume a warmed engine (capture
    stalls are the supervisor's problem, not a latency SLO's)."""
    return {
        "decode": env.get_float("SLO_DECODE_BUDGET_MS", 15.0),
        "ingest": env.get_float("SLO_INGEST_BUDGET_MS", 50.0),
        "submit": env.get_float("SLO_SUBMIT_BUDGET_MS", 10.0),
        "batch_join": env.get_float("SLO_BATCH_JOIN_BUDGET_MS", 15.0),
        "engine_step": env.get_float("SLO_ENGINE_STEP_BUDGET_MS", 50.0),
        "fetch": env.get_float("SLO_FETCH_BUDGET_MS", 15.0),
        "postprocess": env.get_float("SLO_POSTPROCESS_BUDGET_MS", 5.0),
        "encode": env.get_float("SLO_ENCODE_BUDGET_MS", 15.0),
        "packetize": env.get_float("SLO_PACKETIZE_BUDGET_MS", 3.0),
        "protect": env.get_float("SLO_PROTECT_BUDGET_MS", 3.0),
        "send": env.get_float("SLO_SEND_BUDGET_MS", 3.0),
    }


class StageHistogram:
    """Fixed-bucket latency histogram + over-budget counter for one
    stage.  O(log buckets) observe under a tiny lock (≲ a dozen
    observations per frame at 30 fps — nothing against a 33 ms budget);
    snapshot reads are plain copies."""

    __slots__ = ("counts", "count", "sum_ms", "over", "budget_ms", "_lock")

    def __init__(self, budget_ms: float):
        self.counts = [0] * (len(BUCKET_BOUNDS_MS) + 1)  # last = >max bound
        self.count = 0
        self.sum_ms = 0.0
        self.over = 0  # observations past budget_ms
        self.budget_ms = budget_ms
        self._lock = threading.Lock()

    def observe(self, ms: float):
        i = bisect.bisect_left(BUCKET_BOUNDS_MS, ms)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum_ms += ms
            if ms > self.budget_ms:
                self.over += 1

    def cumulative(self) -> list:
        """Prometheus-shaped ``[(le, cumulative_count), ...]`` ending at
        ``("+Inf", count)`` — buckets are cumulative *at export*, kept
        disjoint internally so observe stays one increment."""
        with self._lock:
            counts = list(self.counts)
            total = self.count
        out = []
        acc = 0
        for bound, n in zip(BUCKET_BOUNDS_MS, counts):
            acc += n
            out.append((_fmt_le(bound), acc))
        out.append(("+Inf", total))
        return out

    def quantile_ms(self, q: float):
        """Histogram-estimated quantile (bucket upper bound containing
        the q-th observation) — coarse by design; exact percentiles live
        in the FrameStats reservoirs.  Quantiles landing in the +Inf
        bucket are CENSORED to the top finite bound: this value feeds
        /health and /metrics JSON bodies, and ``float("inf")`` would
        serialize as bare ``Infinity`` — invalid JSON that breaks the
        observability endpoints exactly mid-incident.  The bucket counts
        (cumulative() / the ``over`` counter) carry the true tail."""
        with self._lock:
            counts = list(self.counts)
            total = self.count
        if total == 0:
            return None
        target = max(1, int(q * total))
        acc = 0
        for bound, n in zip(BUCKET_BOUNDS_MS, counts):
            acc += n
            if acc >= target:
                return bound
        return float(BUCKET_BOUNDS_MS[-1])


def _fmt_le(bound: float) -> str:
    """Canonical ``le`` label value: integral bounds render bare
    ("1" not "1.0") so the label set is stable across exporters."""
    return str(int(bound)) if float(bound).is_integer() else repr(bound)


class _StageSloState:
    """One (session, stage) burn-rate tracker: a bounded ring of
    per-tick cumulative (count, over) samples + the breach hysteresis
    state machine."""

    __slots__ = (
        "hist", "window", "state", "up_streak", "down_streak",
        "burn_fast", "burn_slow",
    )

    def __init__(self, hist: StageHistogram, window_ticks: int):
        self.hist = hist
        # +1: burn over N ticks needs the sample N ticks ago as the base;
        # seeded at zero so frames observed before the first tick (lazy
        # registration happens at first observe) still count toward burn
        self.window = collections.deque(maxlen=window_ticks + 1)
        self.window.append((0, 0))
        self.state = STATE_OK
        self.up_streak = 0
        self.down_streak = 0
        self.burn_fast = 0.0
        self.burn_slow = 0.0

    def sample(self):
        self.window.append((self.hist.count, self.hist.over))

    def burn(self, ticks: int, error_budget: float) -> float:
        """Burn rate over the last ``ticks`` ticks; 0.0 when the window
        carried no frames (no evidence is not a breach)."""
        if not self.window:
            return 0.0
        now = self.window[-1]
        base = self.window[max(0, len(self.window) - 1 - ticks)]
        frames = now[0] - base[0]
        if frames <= 0:
            return 0.0
        over_rate = (now[1] - base[1]) / frames
        return over_rate / error_budget


class SessionSlo:
    """Per-session, per-stage SLO state (histograms + burn trackers)."""

    def __init__(self, session_id: str, plane: "SloPlane"):
        self.session_id = session_id
        self.plane = plane
        self.stages = {
            s: _StageSloState(
                StageHistogram(plane.budgets_ms[s]), plane.slow_ticks
            )
            for s in STAGES
        }

    def tick(self):
        p = self.plane
        for name, st in self.stages.items():
            st.sample()
            st.burn_fast = st.burn(p.fast_ticks, p.error_budget)
            st.burn_slow = st.burn(p.slow_ticks, p.error_budget)
            firing = (
                st.burn_fast >= p.burn_threshold
                and st.burn_slow >= p.burn_threshold
            )
            if st.state == STATE_OK:
                st.up_streak = st.up_streak + 1 if firing else 0
                if st.up_streak >= p.up_ticks:
                    st.state = STATE_BREACH
                    st.up_streak = 0
                    st.down_streak = 0
                    p._breach_moved(self.session_id, name, st)
            else:
                # clear on the FAST window alone: the slow window keeps
                # remembering a past burn long after the incident ends
                quiet = st.burn_fast < p.burn_threshold
                st.down_streak = st.down_streak + 1 if quiet else 0
                if st.down_streak >= p.down_ticks:
                    st.state = STATE_OK
                    st.up_streak = 0
                    st.down_streak = 0
                    p._breach_moved(self.session_id, name, st)

    def snapshot(self) -> dict:
        """The /health rendering: only stages that saw frames, each with
        its budget, state and burn pair — bounded by the closed STAGES
        set, O(stages) int reads."""
        out = {}
        for name, st in self.stages.items():
            h = st.hist
            if h.count == 0:
                continue
            out[name] = {
                "state": st.state,
                "budget_ms": h.budget_ms,
                "count": h.count,
                "over": h.over,
                "burn_fast": round(st.burn_fast, 3),
                "burn_slow": round(st.burn_slow, 3),
                "p50_ms": h.quantile_ms(0.5),
                "p99_ms": h.quantile_ms(0.99),
            }
        return out

    def breached_stages(self) -> list:
        return [n for n, st in self.stages.items() if st.state == STATE_BREACH]


class SloPlane:
    """Process-wide SLO aggregation: global per-stage histograms (the
    Prometheus surface), per-session burn/breach state (the /health +
    webhook surface), and the tick cadence.

    ``enabled`` is THE hot-path gate the tracer mint site reads — one
    attribute read when off, exactly like ``TraceController.enabled``.
    """

    def __init__(self, stats=None, on_breach=None):
        self.enabled = env.slo_enabled()
        self.stats = stats  # FrameStats: breaches land as slo_breaches_total
        self.on_breach = on_breach  # callable(session, stage, state, info)
        self.tick_s = max(0.05, env.get_float("SLO_TICK_S", 1.0))
        objective = env.get_float("SLO_OBJECTIVE", 0.99)
        if not 0.0 < objective < 1.0:
            raise ValueError(f"SLO_OBJECTIVE={objective} must be in (0, 1)")
        self.error_budget = 1.0 - objective
        self.burn_threshold = env.get_float("SLO_BURN_THRESHOLD", 2.0)
        self.fast_ticks = max(
            1, round(env.get_float("SLO_FAST_WINDOW_S", 60.0) / self.tick_s)
        )
        self.slow_ticks = max(
            self.fast_ticks,
            round(env.get_float("SLO_SLOW_WINDOW_S", 600.0) / self.tick_s),
        )
        self.up_ticks = max(1, env.get_int("SLO_UP_TICKS", 2))
        self.down_ticks = max(1, env.get_int("SLO_DOWN_TICKS", 6))
        self.budgets_ms = stage_budgets_ms()
        self.global_hist = {
            s: StageHistogram(self.budgets_ms[s]) for s in STAGES
        }
        self.sessions: dict = {}
        self.frames_observed = 0
        self.breaches_total = 0
        self._task = None

    # -- feed path (SessionTracer.complete) -----------------------------------

    def observe(self, session_id: str, frame_trace):
        """One sealed frame timeline: every span whose name is a STAGES
        member lands in the session's and the global histogram.  Called
        from whatever thread sealed the trace; histogram locks make the
        increments safe."""
        if not self.enabled:
            return
        session = self.sessions.get(session_id)
        if session is None:
            # lazy registration: the tracer mints before the HTTP layer
            # knows the session exists (native tier mints at decode)
            session = self.sessions[session_id] = SessionSlo(session_id, self)
        for name, t0, t1 in frame_trace.spans:
            st = session.stages.get(name)
            if st is None:
                continue  # non-stage span (never happens today)
            ms = (t1 - t0) * 1e3
            st.hist.observe(ms)
            self.global_hist[name].observe(ms)
        self.frames_observed += 1

    # -- session registry ------------------------------------------------------

    def unregister(self, session_id: str):
        self.sessions.pop(session_id, None)

    def session_snapshot(self, session_id: str):
        s = self.sessions.get(session_id)
        return s.snapshot() if s is not None else None

    # -- cadence ---------------------------------------------------------------

    async def start(self):
        import asyncio

        self._task = asyncio.get_running_loop().create_task(self._tick_loop())

    async def _tick_loop(self):
        import asyncio

        try:
            while True:
                await asyncio.sleep(self.tick_s)
                self.tick()
        except asyncio.CancelledError:
            pass

    def tick(self):
        """One burn-rate cadence step (public so tests drive it
        clocklessly, like OverloadControlPlane.tick)."""
        for session in list(self.sessions.values()):
            session.tick()

    def stop(self):
        if self._task is not None:
            self._task.cancel()
            self._task = None

    # -- breach fan-out --------------------------------------------------------

    def _breach_moved(self, session_id: str, stage: str, st: _StageSloState):
        if st.state == STATE_BREACH:
            self.breaches_total += 1
            if self.stats is not None:
                self.stats.count("slo_breaches")
        cb = self.on_breach
        if cb is not None:
            try:
                cb(
                    session_id, stage, st.state,
                    {
                        "budget_ms": st.hist.budget_ms,
                        "burn_fast": round(st.burn_fast, 3),
                        "burn_slow": round(st.burn_slow, 3),
                    },
                )
            except Exception:  # observability must never break serving
                logging.getLogger(__name__).exception(
                    "slo on_breach handler failed"
                )

    # -- observability ---------------------------------------------------------

    def snapshot(self) -> dict:
        """/metrics JSON keys — flat gauges plus one bounded ``slo_stages``
        sub-dict (closed STAGES domain, like ``overload_queues``); per-
        session state stays on /health, keeping /metrics cardinality
        session-free."""
        breached = sum(
            len(s.breached_stages()) for s in self.sessions.values()
        )
        out = {
            "slo_enabled": int(self.enabled),
            "slo_sessions": len(self.sessions),
            "slo_stages_breached": breached,
            "slo_frames_observed": self.frames_observed,
        }
        stages = {}
        for name in STAGES:
            h = self.global_hist[name]
            if h.count == 0:
                continue
            stages[name] = {
                "count": h.count,
                "over": h.over,
                "budget_ms": h.budget_ms,
                "p50_ms": h.quantile_ms(0.5),
                "p99_ms": h.quantile_ms(0.99),
            }
        out["slo_stages"] = stages
        return out
