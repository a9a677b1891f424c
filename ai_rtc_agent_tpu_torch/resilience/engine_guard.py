"""Engine-level fault domain: step deadline, quarantine, rebuild, evacuate
(the port's copy of ai_rtc_agent_tpu/resilience/engine_guard.py).

Per-session supervision (:mod:`supervisor`) survives faults scoped to ONE
stream, but the batch scheduler shares one compiled step plane across
every session — a wedged bucket step or a lost device takes the whole
batch down at once, and no per-slot state machine can express that.  The
:class:`EngineGuard` is the device-scoped layer above it:

* **dispatch deadline** — the scheduler routes its one device step
  through :meth:`dispatch`, which runs it on a dedicated worker thread
  (the supervisor's ``_StepRunner`` discipline) and bounds the wait with
  ``ENGINE_STEP_DEADLINE_S``.  On the card the step ends at its
  completion event, polled (stream/scheduler.py), so a stalled device
  trips the guard like a wedged launch.  A cold step (a bucket's first
  use, which captures its CUDA graph) gets ``ENGINE_COLD_DEADLINE_S``.
* **trip → quarantine** — a blown deadline or a :class:`DeviceLostError`
  trips the guard: state leaves ``ARMED``, the wedged worker is abandoned
  (daemon thread; its late result is discarded), and the scheduler stops
  dispatching — queued frames shed to their sessions' passthrough path,
  new admissions are refused with Retry-After from the backoff schedule.
* **rebuild** — a background loop re-creates the step plane
  (``scheduler.rebuild_engine``: new static buffers, a new graph pool,
  every bucket captured again) with exponential backoff, up to
  ``ENGINE_REBUILD_MAX_ATTEMPTS`` attempts, restoring every live slot
  from the snapshot bank captured before the fault, bit for bit.  The
  device telemetry (obs/devtel.py) is in its warmup phase meanwhile, so
  the recaptures are no serve-time breach.
* **evacuate** — on exhaustion the guard calls ``on_exhausted`` (the
  agent's self-evacuation client, a no-op without ``EVACUATE_URL``) and
  parks in ``FAILED``.

States (the JAX guard's closed vocabulary): ``ARMED`` →
``QUARANTINED`` → ``REBUILDING`` → ``ARMED`` on success, or
``EVACUATING`` → ``FAILED`` on exhaustion.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

from ..obs import devtel
from ..utils import env
from .faults import DeviceLostError
from .supervisor import _StepRunner, _StepTimeout

logger = logging.getLogger(__name__)


class EngineQuarantinedError(RuntimeError):
    """Dispatch refused: the engine is quarantined (trip or rebuild)."""


def _pct(samples: list, frac: float) -> float:
    n = len(samples)
    if frac >= 0.99:
        return round(samples[min(n - 1, int(n * 0.99))], 3)
    return round(samples[n // 2], 3)


class EngineGuard:
    """Device fault domain around one :class:`BatchScheduler`.

    ``on_transition(event, info)`` fires on EngineDegraded /
    EngineRecovered / AgentEvacuating (the agent turns these into
    webhooks); ``on_exhausted()`` runs the self-evacuation.  ``sleep`` and
    ``clock`` are injectable so chaos tests drive the backoff schedule
    deterministically; ``auto_rebuild=False`` lets a test trip the guard
    and run :meth:`run_rebuild` synchronously.
    """

    def __init__(
        self,
        scheduler,
        *,
        deadline_s: float | None = None,
        cold_deadline_s: float | None = None,
        max_attempts: int | None = None,
        backoff_s: float | None = None,
        on_transition=None,
        on_exhausted=None,
        auto_rebuild: bool = True,
        sleep=time.sleep,
        clock=time.monotonic,
    ):
        self._sched = scheduler
        self.deadline_s = (
            env.get_float("ENGINE_STEP_DEADLINE_S", 30.0)
            if deadline_s is None else float(deadline_s)
        )
        # cold = a bucket's first use, which captures its graph: never a wedge
        self.cold_deadline_s = (
            env.get_float("ENGINE_COLD_DEADLINE_S", 600.0)
            if cold_deadline_s is None else float(cold_deadline_s)
        )
        self.max_attempts = (
            env.get_int("ENGINE_REBUILD_MAX_ATTEMPTS", 3)
            if max_attempts is None else int(max_attempts)
        )
        self.backoff_s = (
            env.get_float("ENGINE_REBUILD_BACKOFF_S", 1.0)
            if backoff_s is None else float(backoff_s)
        )
        self._on_transition = on_transition
        self._on_exhausted = on_exhausted
        self._auto_rebuild = auto_rebuild
        self._sleep = sleep
        self._clock = clock
        self._lock = threading.Lock()
        self.state = "ARMED"
        self.trips = 0
        self.rebuilds = 0
        self.last_trip_reason: str | None = None
        self._attempt = 0  # rebuild attempts spent THIS quarantine
        self._rebuild_ms: deque = deque(maxlen=256)
        self._runner = _StepRunner()
        scheduler.attach_guard(self)

    # -- dispatch path --------------------------------------------------------

    @property
    def quarantined(self) -> bool:
        return self.state != "ARMED"

    def dispatch(self, fn, *, cold: bool = False):
        """Run one device step under the deadline; returns ``fn()``'s
        result.  A blown deadline or DeviceLostError trips the guard and
        raises; any other exception propagates WITHOUT tripping (a shape
        bug is the caller's problem, not a device fault)."""
        with self._lock:
            if self.state != "ARMED":
                raise EngineQuarantinedError(
                    f"engine {self.state.lower()}: dispatch refused"
                )
            runner = self._runner
        box = runner.submit(fn)
        deadline = self.cold_deadline_s if cold else self.deadline_s
        try:
            return box.result(timeout=deadline)
        except _StepTimeout:
            self._trip(
                f"step exceeded {'cold ' if cold else ''}deadline "
                f"({deadline:g}s)"
            )
            raise EngineQuarantinedError(
                f"engine step wedged past {deadline:g}s deadline"
            ) from None
        except DeviceLostError as e:
            self._trip(f"device lost: {e}")
            raise

    def run_bounded(self, fn, timeout_s: float, what: str = "call"):
        """Run ``fn()`` on the stepping runner (the thread that steps, so a
        rebuild's captures run there) and wait at most ``timeout_s``: a
        call stuck behind a stalled device raises instead of hanging, and
        its runner is abandoned for a fresh one."""
        with self._lock:
            runner = self._runner
        try:
            return runner.submit(fn).result(timeout=timeout_s)
        except _StepTimeout:
            with self._lock:
                if self._runner is runner:
                    self._runner = _StepRunner()
                    runner.shutdown()
            raise TimeoutError(f"{what} exceeded {timeout_s:g}s") from None

    def _trip(self, reason: str) -> None:
        with self._lock:
            if self.state != "ARMED":
                return  # concurrent dispatches: first trip wins
            self.state = "QUARANTINED"
            self.trips += 1
            self._attempt = 0
            self.last_trip_reason = reason
            # abandon the (possibly wedged) worker — daemon thread, its
            # late result lands in a box nobody reads
            old, self._runner = self._runner, _StepRunner()
            old.shutdown()
        logger.error("engine guard TRIPPED: %s — quarantined", reason)
        self._fire("EngineDegraded", {"reason": reason})
        if self._auto_rebuild:
            threading.Thread(
                target=self.run_rebuild, name="engine-rebuild", daemon=True
            ).start()

    def _fire(self, event: str, info: dict) -> None:
        cb = self._on_transition
        if cb is None:
            return
        try:
            cb(event, dict(info, state=self.state))
        except Exception:
            logger.exception("engine guard transition callback failed")

    # -- rebuild loop ---------------------------------------------------------

    def run_rebuild(self) -> bool:
        """Quarantine recovery: snapshot-bank capture, then backed-off
        rebuild attempts; True when the guard re-arms."""
        try:
            snaps = self._sched.capture_quarantine_snapshots()
        except Exception:
            logger.exception("quarantine snapshot capture failed")
            snaps = {}
        for attempt in range(1, self.max_attempts + 1):
            self._sleep(self.backoff_s * (2 ** (attempt - 1)))
            with self._lock:
                self.state = "REBUILDING"
                self._attempt = attempt
            t0 = self._clock()
            plane, was_serving = self._devtel_plane()
            try:
                if plane is not None:
                    plane.warmup()  # the rebuild's captures are no serve-time stall
                try:
                    restored = self._sched.rebuild_engine(snaps)
                finally:
                    if plane is not None and was_serving:
                        plane.serving()
            except Exception:
                logger.exception(
                    "engine rebuild attempt %d/%d failed",
                    attempt, self.max_attempts,
                )
                with self._lock:
                    self.state = "QUARANTINED"
                continue
            ms = round(1e3 * (self._clock() - t0), 3)
            with self._lock:
                self.rebuilds += 1
                self._rebuild_ms.append(ms)
                self.state = "ARMED"
            logger.warning(
                "engine rebuilt in %.1fms (attempt %d, %d slot(s) bit-exact)",
                ms, attempt, restored,
            )
            self._fire(
                "EngineRecovered",
                {"rebuild_ms": ms, "attempt": attempt, "restored": restored},
            )
            return True
        with self._lock:
            self.state = "EVACUATING"
        logger.error(
            "engine rebuild exhausted after %d attempt(s) — evacuating",
            self.max_attempts,
        )
        self._fire("AgentEvacuating", {"reason": self.last_trip_reason or ""})
        if self._on_exhausted is not None:
            try:
                self._on_exhausted()
            except Exception:
                logger.exception("engine evacuation hook failed")
        with self._lock:
            self.state = "FAILED"
        return False

    @staticmethod
    def _devtel_plane():
        """(the active device telemetry plane or None, whether it serves)."""
        plane = devtel.active()
        if plane is None:
            return None, False
        return plane, plane.phase == devtel.PHASE_SERVING

    # -- observability --------------------------------------------------------

    def retry_after_s(self) -> float:
        """Refusal Retry-After: the backoff step the rebuild loop is
        about to (or would next) sleep, capped at 60s."""
        with self._lock:
            if self.state == "ARMED":
                return 0.0
            if self.state in ("EVACUATING", "FAILED"):
                return 60.0
            step = self.backoff_s * (
                2 ** min(self._attempt, self.max_attempts - 1)
            )
        return min(60.0, max(1.0, step))

    def health(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "trips": self.trips,
                "rebuilds": self.rebuilds,
                "last_trip_reason": self.last_trip_reason,
            }

    def snapshot(self) -> dict:
        """Flat metric dict for /metrics."""
        with self._lock:
            out = {
                "engine_trips_total": self.trips,
                "engine_rebuilds_total": self.rebuilds,
                "engine_quarantined": int(self.state != "ARMED"),
            }
            samples = sorted(self._rebuild_ms)
        if samples:
            out["engine_rebuild_ms_p50"] = _pct(samples, 0.5)
            out["engine_rebuild_ms_p99"] = _pct(samples, 0.99)
        return out

    def close(self) -> None:
        self._runner.shutdown()
