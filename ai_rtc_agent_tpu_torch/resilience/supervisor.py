"""Per-session health state machine and supervised degradation (the port's
copy of ai_rtc_agent_tpu/resilience/supervisor.py).

    HEALTHY ──stall/error burst──► DEGRADED ──engine restarted──► RECOVERING
       ▲                              │                               │
       └──────── N healthy steps ─────┼───────────────────────────────┘
                                      └──restart budget exhausted──► FAILED

Two watchdogs drive it:

* **step latency** — :class:`ResilientPipeline` runs every diffusion step on
  its own worker with a timeout.  A step that blows the budget (wedged
  device, injected stall) flips the session to DEGRADED and the stream
  *keeps flowing*: the wrapper returns the source frame unchanged
  (passthrough) instead of freezing behind the stuck step.  A background
  thread re-prepares the engine (``pipeline.restart()``) under the shared
  :class:`~..resilience.retry.RetryPolicy`; success moves to RECOVERING and
  fires a PLI-driven keyframe re-sync so viewers get a clean IDR as real
  frames resume.
* **output-frame age** — an asyncio task watches the time since the last
  frame left the session.  Output stalling with no step in flight means the
  *input* died (wedged RTP receiver, publisher gone silent): the watchdog
  degrades the session and fires the re-sync (an upstream PLI) instead of
  restarting a healthy engine.

FAILED is terminal for the engine but NOT for the stream — passthrough
continues, so a session with a dead accelerator degrades to a relay rather
than a black screen.  Every transition is observable: the agent surfaces
supervisor snapshots at ``GET /health``, counters at ``/metrics``, and
StreamDegraded/StreamRecovered webhooks (server/events.py).
"""

from __future__ import annotations

import asyncio
import logging
import queue
import threading
import time

from ..obs.trace import get_trace
from ..utils import env
from .faults import DeviceLostError
from .overload import ShedFrame
from .retry import RetryError, RetryPolicy

logger = logging.getLogger(__name__)

HEALTHY = "HEALTHY"
DEGRADED = "DEGRADED"
RECOVERING = "RECOVERING"
FAILED = "FAILED"

_SEVERITY = {HEALTHY: 0, RECOVERING: 1, DEGRADED: 2, FAILED: 3}


def worst_state(states) -> str:
    """The most degraded of a set of session states (health endpoint
    rollup); HEALTHY when the set is empty."""
    worst = HEALTHY
    for s in states:
        if _SEVERITY.get(s, 0) > _SEVERITY[worst]:
            worst = s
    return worst


class SessionSupervisor:
    """Thread-safe health state machine for one media session.

    Callbacks (all optional):
      ``restart()``      — re-prepare the engine; run on a daemon thread,
                           retried under a RetryPolicy, never on the loop.
      ``resync()``       — keyframe re-sync (force sink IDR + upstream PLI);
                           marshalled onto the event loop when one is bound.
      ``on_transition(old, new, reason)`` — observability hook; may fire on
                           any thread.
    """

    def __init__(
        self,
        session_id: str = "session",
        *,
        stall_after_s: float | None = None,
        check_interval_s: float = 0.5,
        healthy_after: int = 3,
        error_burst: int = 3,
        max_restarts: int = 3,
        restart_backoff_s: float = 0.25,
        probe_interval_s: float = 2.0,
        restart=None,
        resync=None,
        on_transition=None,
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        self.session_id = session_id
        self.stall_after_s = (
            env.get_float("SUPERVISOR_STALL_AFTER_S", 5.0)
            if stall_after_s is None
            else stall_after_s
        )
        self.check_interval_s = check_interval_s
        self.healthy_after = healthy_after
        self.error_burst = error_burst
        self.max_restarts = max_restarts
        self.restart_backoff_s = restart_backoff_s
        self.probe_interval_s = probe_interval_s
        self._next_probe = 0.0
        self.restart = restart
        self.resync = resync
        self.on_transition = on_transition
        # flight-recorder hook (obs/recorder.py): callable(kind, **data)
        # fed restart attempts/outcomes — the event-log entries that
        # explain a post-mortem; may fire from any thread
        self.on_event = None
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.RLock()
        self._state = HEALTHY
        self._since = clock()
        self._reason = "session started"
        self._restarts = 0
        self._errors_in_row = 0
        self._healthy_steps = 0
        self._last_frame_out: float | None = None
        self._recovery_pending = False
        # overload hold (resilience/overload.py): while set, successful
        # steps must NOT walk the session out of DEGRADED — the shedding
        # ladder's probes succeed by design, and without the hold every
        # probe would flap DEGRADED<->RECOVERING, spraying webhooks and
        # counters once per probe for as long as the box stays saturated
        self._overload_hold = False
        self._watchdog_task = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self.passthrough_frames = 0
        self.processed_frames = 0
        # owner-stamped correlation context (e.g. the fleet journey the
        # agent threads off the router's X-Journey-Id header) — rendered
        # verbatim in snapshot() so /health answers "which journey is
        # this session a leg of" without a second lookup
        self.context: dict = {}
        self.transitions: list = []  # (t, old, new, reason), bounded
        # resources owned by wrappers (ResilientPipeline's step worker):
        # released in stop() so session teardown needs only the supervisor
        self._close_hooks: list = []

    # -- introspection ------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def recovery_pending(self) -> bool:
        with self._lock:
            return self._recovery_pending

    def should_try_engine(self) -> bool:
        """Gate for the pipeline wrapper: FAILED never runs the engine;
        DEGRADED runs it only as a throttled probe (and never while a
        background recovery holds the wedged step) — everything else runs
        normally."""
        with self._lock:
            if self._state == FAILED:
                return False
            if self._state == DEGRADED:
                if self._recovery_pending:
                    return False
                if self._overload_hold:
                    # overload-DEGRADED (not a fault): the shedding ladder's
                    # admit_frame() token already throttles probes to one
                    # per OVERLOAD_PROBE_S, and it is consumed BEFORE this
                    # gate runs — throttling again here burned every probe
                    # that landed inside this gate's own (longer) interval,
                    # halving the cadence and starving the step EWMA those
                    # probes exist to feed.  While the hold is set the
                    # ladder owns the probe cadence.
                    return True
                now = self._clock()
                if now < self._next_probe:
                    return False
                self._next_probe = now + self.probe_interval_s
            return True

    def engine_available(self) -> bool:
        """Non-consuming peek at :meth:`should_try_engine`'s hard refusals
        (FAILED, recovery holding the wedged step) — lets the overload
        gate skip a frame WITHOUT burning a ladder probe token when the
        engine gate would refuse it anyway."""
        with self._lock:
            return self._state != FAILED and not self._recovery_pending

    def may_finish_inflight(self) -> bool:
        """A frame whose submit was granted keeps that grant through its
        fetch.  The probe throttle is a TOKEN consumed at submit time —
        the token rides with the in-flight frame, so re-checking
        :meth:`should_try_engine` at fetch would always see the window
        closed and discard every pipelined probe as passthrough, pinning
        the session DEGRADED forever (ROADMAP open item 1).  Only FAILED
        revokes work already in flight."""
        with self._lock:
            return self._state != FAILED

    def snapshot(self) -> dict:
        with self._lock:
            now = self._clock()
            return {
                "state": self._state,
                **({"context": dict(self.context)} if self.context else {}),
                "reason": self._reason,
                "since_s": round(now - self._since, 3),
                "restarts": self._restarts,
                "processed_frames": self.processed_frames,
                "passthrough_frames": self.passthrough_frames,
                "last_frame_age_s": (
                    None
                    if self._last_frame_out is None
                    else round(now - self._last_frame_out, 3)
                ),
                "transitions": [
                    {"t": round(t, 3), "from": a, "to": b, "reason": r}
                    for t, a, b, r in self.transitions[-8:]
                ],
            }

    # -- signals from the pipeline wrapper ----------------------------------

    def note_frame_out(self, n: int = 1, processed: bool = False):
        with self._lock:
            self._last_frame_out = self._clock()
            if processed:
                self.processed_frames += n
            else:
                self.passthrough_frames += n

    def on_step_ok(self, dt_s: float | None = None):
        fire = None
        with self._lock:
            self._errors_in_row = 0
            if self._overload_hold:
                # shedding under pressure: a successful probe is expected
                # and proves nothing about capacity — stay DEGRADED until
                # the ladder de-escalates (note_overload_clear)
                return
            if self._state == RECOVERING:
                self._healthy_steps += 1
                if self._healthy_steps >= self.healthy_after:
                    fire = self._transition_locked(HEALTHY, "engine steps healthy")
            elif self._state == DEGRADED and not self._recovery_pending:
                # input-stall degrade: steps are flowing again
                self._healthy_steps = 1
                fire = self._transition_locked(RECOVERING, "frames flowing again")
        self._notify(fire)

    def on_step_error(self, exc: BaseException):
        with self._lock:
            self._errors_in_row += 1
            burst = self._errors_in_row >= self.error_burst
        if burst or isinstance(exc, DeviceLostError):
            self.on_stall(f"engine step failing: {exc!r}")
        else:
            logger.warning(
                "session %s: engine step error (%d/%d before degrade): %r",
                self.session_id, self._errors_in_row, self.error_burst, exc,
            )

    def note_overload(self, reason: str):
        """Overload-ladder passthrough (resilience/overload.py): degrade
        WITHOUT spending the restart budget — the engine is healthy, the
        box is over capacity, and restarting would only add load.  Sets a
        hold so successful probe steps cannot flap the session back out of
        DEGRADED while shedding continues; :meth:`note_overload_clear`
        (ladder de-escalation) releases it, after which healthy steps walk
        the session through RECOVERING to HEALTHY via :meth:`on_step_ok`."""
        fire = None
        with self._lock:
            self._overload_hold = True
            if self._state in (HEALTHY, RECOVERING):
                self._next_probe = self._clock() + self.probe_interval_s
                fire = self._transition_locked(DEGRADED, reason)
        self._notify(fire)

    def note_overload_clear(self):
        """The shedding ladder dropped below its passthrough rung: release
        the hold so real steps can recover the session normally."""
        with self._lock:
            self._overload_hold = False

    def on_stall(self, reason: str):
        """A step blew its budget or errors burst: degrade NOW, recover in
        the background.  Idempotent while a recovery is already running."""
        start = False
        fire = None
        with self._lock:
            if self._state == FAILED or self._recovery_pending:
                return
            # with no restart hook, DEGRADED probes the engine on an
            # interval — back off before the first probe
            self._next_probe = self._clock() + self.probe_interval_s
            if self._state != DEGRADED:
                fire = self._transition_locked(DEGRADED, reason)
            if self.restart is not None:
                if self._restarts >= self.max_restarts:
                    fire = self._transition_locked(
                        FAILED, "restart budget exhausted"
                    )
                else:
                    self._recovery_pending = True
                    start = True
        self._notify(fire)
        if start:
            threading.Thread(
                target=self._run_restart,
                daemon=True,
                name=f"supervisor-restart-{self.session_id}",
            ).start()

    # -- recovery -----------------------------------------------------------

    def _fire_event(self, kind: str, **data):
        cb = self.on_event
        if cb is None:
            return
        try:
            cb(kind, **data)
        except Exception:
            logger.exception("supervisor on_event handler failed")

    def _restart_once(self):
        with self._lock:
            self._restarts += 1
            n = self._restarts
        self._fire_event("restart_attempt", attempt=n)
        self.restart()

    def _run_restart(self):
        with self._lock:
            budget = self.max_restarts - self._restarts
        policy = RetryPolicy(
            attempts=max(1, budget),
            base_delay_s=self.restart_backoff_s,
            max_delay_s=5.0,
        )
        try:
            policy.run(
                self._restart_once,
                sleep=self._sleep,
                label=f"engine restart ({self.session_id})",
            )
        except RetryError as e:
            self._fire_event("restart_failed", error=repr(e.last))
            with self._lock:
                self._recovery_pending = False
                fire = self._transition_locked(
                    FAILED, f"engine restart failed: {e.last!r}"
                )
            self._notify(fire)
            return
        self._fire_event("restart_ok")
        with self._lock:
            self._recovery_pending = False
            self._healthy_steps = 0
            self._errors_in_row = 0
            fire = None
            if self._state == DEGRADED:
                fire = self._transition_locked(RECOVERING, "engine restarted")
        self._notify(fire)
        self._fire_resync()

    def _fire_resync(self):
        """Keyframe re-sync, marshalled onto the loop when one is bound
        (the PLI/IDR plumbing is loop-affine)."""
        if self.resync is None:
            return
        loop = self._loop
        if loop is not None and loop.is_running():
            try:
                loop.call_soon_threadsafe(self._safe_resync)
                return
            except RuntimeError:
                pass  # loop shut down between check and call
        self._safe_resync()

    def _safe_resync(self):
        try:
            self.resync()
        except Exception:
            logger.exception("session %s: resync failed", self.session_id)

    # -- output-age watchdog --------------------------------------------------

    def start_watchdog(self):
        """Start the output-frame-age watchdog on the running loop."""
        self._loop = asyncio.get_running_loop()
        self._watchdog_task = self._loop.create_task(self._watch())
        return self._watchdog_task

    async def _watch(self):
        try:
            while True:
                await asyncio.sleep(self.check_interval_s)
                self.check()
        except asyncio.CancelledError:
            pass

    def check(self, now: float | None = None) -> str:
        """One watchdog tick (public so tests drive it without sleeping):
        output frames stalled while the engine isn't mid-recovery means the
        INPUT died — fire an upstream keyframe re-sync and degrade."""
        now = self._clock() if now is None else now
        fire = None
        resync = False
        with self._lock:
            last = self._last_frame_out
            if (
                self._state == HEALTHY
                and last is not None
                and now - last > self.stall_after_s
            ):
                fire = self._transition_locked(
                    DEGRADED,
                    f"no output frames for {now - last:.1f}s (input stalled?)",
                )
                resync = True
            state = self._state
        self._notify(fire)
        if resync:
            self._fire_resync()
        return state

    def stop(self):
        if self._watchdog_task is not None:
            self._watchdog_task.cancel()
            self._watchdog_task = None
        for hook in self._close_hooks:
            try:
                hook()
            except Exception:
                logger.exception("supervisor close hook failed")
        self._close_hooks.clear()

    # -- transitions ----------------------------------------------------------

    def _transition_locked(self, new: str, reason: str):
        old = self._state
        if old == new:
            return None
        self._state = new
        self._reason = reason
        self._since = self._clock()
        self.transitions.append((self._since, old, new, reason))
        del self.transitions[:-64]
        logger.warning(
            "session %s: %s -> %s (%s)", self.session_id, old, new, reason
        )
        return (old, new, reason)

    def _notify(self, fire):
        if fire is None or self.on_transition is None:
            return
        try:
            self.on_transition(*fire)
        except Exception:
            logger.exception("on_transition handler failed")


class _StepTimeout(Exception):
    """A bounded step blew its budget (internal to ResilientPipeline)."""


class _StepResult:
    """One pending step's result slot (Event-based future)."""

    __slots__ = ("_ev", "_val", "_exc")

    def __init__(self):
        self._ev = threading.Event()
        self._val = None
        self._exc = None

    def set_result(self, v):
        self._val = v
        self._ev.set()

    def set_exception(self, e):
        self._exc = e
        self._ev.set()

    def result(self, timeout: float):
        if not self._ev.wait(timeout):
            raise _StepTimeout()
        if self._exc is not None:
            raise self._exc
        return self._val


class _StepRunner:
    """Single DAEMON worker thread running engine steps.

    Not a ThreadPoolExecutor: its workers are non-daemon and joined at
    interpreter exit, so one genuinely wedged step would block process
    shutdown forever — the exact fault this layer exists to survive.  A
    daemon thread dies with the process; an abandoned runner drains its
    sentinel and exits once the stuck call finally returns."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="resilient-step"
        )
        self._thread.start()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args, box = item
            try:
                box.set_result(fn(*args))
            except BaseException as e:  # delivered to the waiter
                box.set_exception(e)

    def submit(self, fn, *args) -> _StepResult:
        box = _StepResult()
        self._q.put((fn, args, box))
        return box

    def shutdown(self):
        self._q.put(None)


def _non_finite(out) -> bool:
    """Injected-NaN / poisoned-latent detector: float ndarray output with
    any non-finite value.  uint8 and wrapped frames pass untouched."""
    import numpy as np

    if isinstance(out, np.ndarray) and out.dtype.kind == "f":
        return not bool(np.isfinite(out).all())
    return False


class ResilientPipeline:
    """Bounded-latency pipeline wrapper: every engine call runs on a
    dedicated worker with a timeout; a blown budget degrades the session to
    passthrough (the source frame is returned unchanged) instead of
    freezing the stream.  Forwards the pipelined submit/fetch surface when
    the wrapped pipeline has one, so PIPELINE_DEPTH serving keeps working
    under supervision."""

    def __init__(
        self,
        pipeline,
        supervisor: SessionSupervisor | None = None,
        *,
        step_timeout_s: float | None = None,
        first_step_timeout_s: float | None = None,
        warm_steps: int = 2,
    ):
        self._inner = pipeline
        self.supervisor = supervisor or SessionSupervisor()
        if self.supervisor.restart is None:
            self.supervisor.restart = getattr(pipeline, "restart", None)
        self.step_timeout_s = (
            env.get_float("RESILIENCE_STEP_TIMEOUT_S", 5.0)
            if step_timeout_s is None
            else step_timeout_s
        )
        # the first steps may pay a capture or a new thread's library
        # handles — a stall verdict there would "recover" into the same cost
        self.first_step_timeout_s = (
            env.get_float("RESILIENCE_FIRST_STEP_TIMEOUT_S", 300.0)
            if first_step_timeout_s is None
            else first_step_timeout_s
        )
        self._warm_steps = warm_steps
        self._steps = 0
        # optional overload-ladder gate (resilience/overload.py): consulted
        # before every engine call; a refused frame is delivered passthrough
        # (the stream thins under load instead of queueing stale work)
        self.throttle = None
        # batch-scheduler sessions (stream/scheduler.py) feed the admission
        # step-EWMA themselves with PER-BATCH-AMORTIZED latency (dt / batch
        # occupancy) — feeding the raw submit->fetch duration here too would
        # overstate per-session cost by the batch width, erasing exactly the
        # capacity gain batching buys.  Timeouts still feed (a wedge is a
        # wedge regardless of who owns the healthy-step signal).
        self._owns_step_signal = bool(
            getattr(pipeline, "owns_step_signal", False)
        )
        self._runner = _StepRunner()
        # teardown rides the supervisor's stop() so the agent's session
        # cleanup releases the worker without holding a wrapper reference
        self.supervisor._close_hooks.append(self.close)
        if hasattr(pipeline, "submit"):
            self.submit = self._submit
            self.fetch = self._fetch
        if hasattr(pipeline, "submit_batch"):
            self.submit_batch = self._submit_batch
            self.fetch_batch = self._fetch_batch

    def __getattr__(self, name):
        # control-plane passthrough (update_prompt, frame_buffer_size, …);
        # hot-path methods are bound explicitly in __init__ so delegation
        # can never bypass supervision
        if name == "_inner":  # not yet set (unpickling) — avoid recursion
            raise AttributeError(name)
        return getattr(self._inner, name)

    # -- helpers --------------------------------------------------------------

    def _timeout(self) -> float:
        if self._steps < self._warm_steps:
            return max(self.step_timeout_s, self.first_step_timeout_s)
        return self.step_timeout_s

    def _engine_enabled(self) -> bool:
        # FAILED never runs the engine; DEGRADED with a recovery in flight
        # doesn't queue behind the wedged step; DEGRADED without one probes
        # the engine on the supervisor's throttle (the recovery path for
        # restart-less pipelines and input stalls)
        return self.supervisor.should_try_engine()

    def _run_bounded(self, fn, *args):
        timeout = self._timeout()
        box = self._runner.submit(fn, *args)
        try:
            out = box.result(timeout=timeout)
        except _StepTimeout:
            self._abandon_runner()
            if self.throttle is not None and self._steps >= self._warm_steps:
                # a wedged steady-state step never reports a duration —
                # feed the admission EWMA its budget (doubled) so overload
                # pressure registers wedges as severe, not absent.  A blown
                # WARM-UP step is a fault (on_stall restarts it below), not
                # a capacity signal — first_step_timeout_s is compile-sized
                # and would pin pressure over budget on every cold start
                self.throttle.note_step_timeout(timeout)
            self.supervisor.on_stall(f"engine step exceeded {timeout:.1f}s")
            return False, None
        except Exception as e:
            self._steps += 1
            self.supervisor.on_step_error(e)
            return False, None
        self._steps += 1
        return True, out

    def _abandon_runner(self):
        """The worker is wedged mid-step: strand it (a daemon thread — it
        drains its shutdown sentinel when the stuck call finally returns,
        and never blocks interpreter exit) and serve subsequent steps from
        a fresh one."""
        old = self._runner
        self._runner = _StepRunner()
        old.shutdown()

    def close(self):
        """Release the step worker (idempotent; also runs via
        supervisor.stop())."""
        self._runner.shutdown()

    def _passthrough(self, frame, n: int = 1):
        self.supervisor.note_frame_out(n, processed=False)
        frame_trace = get_trace(frame)
        if frame_trace is not None:
            # the terminal marker: the engine was bypassed and the source
            # pixels delivered; the timeline seals here (the frame flows on)
            frame_trace.finish("passthrough")
        return frame

    def _admit_frame(self) -> bool:
        """Overload-ladder gate (before the supervisor's own gate): a
        refused frame sheds engine WORK, not the frame — it is delivered
        passthrough immediately instead of queueing behind slow steps."""
        t = self.throttle
        if t is None:
            return True
        if not self.supervisor.engine_available():
            # the engine gate would refuse this frame anyway (FAILED /
            # recovery holds the wedged step) — refuse it HERE so the
            # ladder's once-per-interval probe token isn't consumed and
            # then discarded, starving the step EWMA during recovery
            return False
        return t.admit_frame()

    def _note_step(self, dt_s: float):
        # warm-up steps may carry a capture (first_step_timeout_s exists
        # for them): feeding them to the
        # admission EWMA would drive pressure over budget on EVERY cold
        # session start, 503ing concurrent offers and walking live ladders
        # up — only steady-state steps measure capacity
        if self._steps <= self._warm_steps:
            return
        if self._owns_step_signal:
            return
        t = self.throttle
        if t is not None:
            t.note_step(dt_s)

    # -- synchronous surface ---------------------------------------------------

    def __call__(self, frame):
        if not self._admit_frame() or not self._engine_enabled():
            return self._passthrough(frame)
        t0 = time.monotonic()
        ok, out = self._run_bounded(self._inner, frame)
        if not ok:
            return self._passthrough(frame)
        if isinstance(out, ShedFrame):
            # a bounded queue shed this frame under pressure: source
            # pixels, not an engine step — deliver passthrough and feed
            # NOTHING (same rationale as _fetch)
            return self._passthrough(frame)
        if _non_finite(out):
            self.supervisor.on_step_error(
                FloatingPointError("non-finite frame from engine")
            )
            return self._passthrough(frame)
        dt = time.monotonic() - t0
        self._note_step(dt)
        self.supervisor.on_step_ok(dt)
        self.supervisor.note_frame_out(processed=True)
        return out

    # -- pipelined surface -----------------------------------------------------

    def _submit(self, frame):
        if not self._admit_frame() or not self._engine_enabled():
            return ("passthrough", frame)
        ok, handle = self._run_bounded(self._inner.submit, frame)
        if not ok:
            return ("passthrough", frame)
        return ("live", handle, frame)

    def _fetch(self, handle, src_frame=None):
        if handle[0] == "passthrough":
            return self._passthrough(
                src_frame if src_frame is not None else handle[1]
            )
        _, inner_handle, frame = handle
        src = src_frame if src_frame is not None else frame
        # a "live" handle carries its submit-time grant (probe token
        # included) — do NOT re-run the throttled gate here
        if not self.supervisor.may_finish_inflight():
            return self._passthrough(src)
        t0 = time.monotonic()
        ok, out = self._run_bounded(self._inner.fetch, inner_handle, src_frame)
        if not ok:
            return self._passthrough(src)
        if isinstance(out, ShedFrame):
            # a bounded queue shed this frame under pressure: source
            # pixels, not an engine step — deliver passthrough and feed
            # NOTHING (a ~0ms "step" would dilute the admission EWMA at
            # exactly the moment the shed is evidence of overload)
            return self._passthrough(src)
        if _non_finite(out):
            self.supervisor.on_step_error(
                FloatingPointError("non-finite frame from engine")
            )
            return self._passthrough(src)
        dt = time.monotonic() - t0
        self._note_step(dt)
        self.supervisor.on_step_ok(dt)
        self.supervisor.note_frame_out(processed=True)
        return out

    def _submit_batch(self, frames):
        if not self._admit_frame() or not self._engine_enabled():
            return ("passthrough", list(frames))
        ok, handle = self._run_bounded(self._inner.submit_batch, frames)
        if not ok:
            return ("passthrough", list(frames))
        return ("live", handle, list(frames))

    def _fetch_batch(self, handle, src_frames=None):
        if handle[0] == "passthrough":
            srcs = src_frames if src_frames is not None else handle[1]
            self.supervisor.note_frame_out(len(srcs), processed=False)
            return list(srcs)
        _, inner_handle, frames = handle
        srcs = src_frames if src_frames is not None else frames
        if not self.supervisor.may_finish_inflight():
            self.supervisor.note_frame_out(len(srcs), processed=False)
            return list(srcs)
        t0 = time.monotonic()
        ok, outs = self._run_bounded(
            self._inner.fetch_batch, inner_handle, src_frames
        )
        if not ok or any(
            _non_finite(o)
            for o in outs or []
            if not isinstance(o, ShedFrame)
        ):
            if ok:
                self.supervisor.on_step_error(
                    FloatingPointError("non-finite frame from engine")
                )
            self.supervisor.note_frame_out(len(srcs), processed=False)
            return list(srcs)
        # per-output sheds (the scheduler's bounded window can evict some
        # of a group under pressure): source pixels, not an engine step —
        # passthrough delivery for those positions, and only the frames
        # that actually stepped feed the EWMA/counters (same discipline
        # as the single-frame path above)
        results, live = [], 0
        for o, src in zip(outs, list(srcs)):
            if isinstance(o, ShedFrame):
                results.append(self._passthrough(src))
            else:
                results.append(o)
                live += 1
        if live:
            dt = time.monotonic() - t0
            self._note_step(dt)
            self.supervisor.on_step_ok(dt)
            self.supervisor.note_frame_out(live, processed=True)
        return results
