"""The one retry/backoff helper: jittered exponential backoff and a deadline
(the port's copy of ai_rtc_agent_tpu/resilience/retry.py).

One policy object owns the schedule; a call site chooses only what counts as
retryable and how long to keep trying (the supervisor's engine restarts,
the TURN token fetch).  Sleep, clock and rng are injectable, so tests run
the schedule without sleeping.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from dataclasses import dataclass

logger = logging.getLogger(__name__)

_RAISE = object()  # sentinel: re-raise on exhaustion instead of a default


class RetryError(Exception):
    """All attempts exhausted.  ``last`` carries the final exception."""

    def __init__(self, message: str, last: BaseException | None = None):
        super().__init__(message)
        self.last = last


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff with an optional wall-clock deadline.

    ``attempts=None`` means unbounded — the deadline is then the only stop
    (the health-poll shape).  ``jitter`` is the ± fraction of each delay
    drawn uniformly (0.1 → delay * U[0.9, 1.1]); full determinism comes
    from passing an explicitly seeded ``rng``.
    """

    attempts: int | None = 5
    base_delay_s: float = 0.5
    max_delay_s: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.1
    deadline_s: float | None = None
    # Full jitter (AWS-style): each delay is drawn uniformly from
    # [0, base * multiplier**n] instead of base * multiplier**n * (1 ± j).
    # Fractional jitter keeps a fleet of workers phase-locked within ±j of
    # the same schedule — after a shared control-plane blip they all
    # re-POST inside one narrow window and the recovering service eats a
    # synchronized retry storm.  Full jitter decorrelates them across the
    # whole backoff interval while preserving the exponential envelope.
    # Deterministic when a seeded ``rng`` is passed (like faults.py plans).
    full_jitter: bool = False

    def __post_init__(self):
        if self.attempts is not None and self.attempts < 1:
            raise ValueError("attempts must be >= 1 (or None for unbounded)")
        if self.attempts is None and self.deadline_s is None:
            raise ValueError("unbounded attempts require a deadline_s")

    def delays(self, rng: random.Random | None = None):
        """Generator of successive sleep durations (unjittered core:
        base * multiplier**n, capped at max_delay_s).  ``full_jitter``
        draws each delay from U[0, core] and takes precedence over the
        fractional ``jitter`` band."""
        rng = rng or random
        d = self.base_delay_s
        while True:
            if self.full_jitter:
                yield d * rng.random()
            else:
                j = (
                    1.0 + self.jitter * (2.0 * rng.random() - 1.0)
                    if self.jitter
                    else 1.0
                )
                yield max(0.0, d * j)
            d = min(self.max_delay_s, d * self.multiplier)

    # -- shared attempt bookkeeping (one copy for run AND arun) -------------

    class _Attempts:
        """Attempt counter + deadline clamp + backoff schedule: every
        retry decision lives here once, so the sync and async drivers
        cannot drift."""

        def __init__(self, policy: "RetryPolicy", clock, rng, on_retry, label):
            self.policy = policy
            self.clock = clock
            self.on_retry = on_retry
            self.label = label
            self.deadline = (
                None if policy.deadline_s is None else clock() + policy.deadline_s
            )
            self.delays = policy.delays(rng)
            self.i = 0
            self.last: BaseException | None = None

        def next_delay(self, exc: BaseException) -> float | None:
            """Record a failure; -> seconds to back off, or None when
            exhausted (attempts or deadline)."""
            self.last = exc
            self.i += 1
            p = self.policy
            if p.attempts is not None and self.i >= p.attempts:
                return None
            d = next(self.delays)
            if self.deadline is not None:
                remaining = self.deadline - self.clock()
                if remaining <= 0:
                    return None
                d = min(d, remaining)
            if self.on_retry is not None:
                self.on_retry(self.i, exc, d)
            else:
                logger.debug(
                    "retry %s#%d in %.2fs after %s", self.label, self.i, d, exc
                )
            return d

        def expired(self) -> bool:
            return self.deadline is not None and self.clock() >= self.deadline

        def exhaust(self, fn, default):
            if default is not _RAISE:
                return default
            raise RetryError(
                f"{self.label or getattr(fn, '__name__', 'call')} failed "
                f"after {self.i} attempt(s)", self.last
            ) from self.last

    def run(
        self,
        fn,
        *,
        retry_on: tuple = (Exception,),
        sleep=time.sleep,
        clock=time.monotonic,
        rng: random.Random | None = None,
        on_retry=None,
        default=_RAISE,
        label: str = "",
    ):
        """Call ``fn()`` until it returns, attempts run out, or the deadline
        passes.  On exhaustion: return ``default`` when given, else raise
        :class:`RetryError` chaining the last exception.  ``on_retry(i, exc,
        delay)`` observes every scheduled retry (logging/metrics hook)."""
        st = self._Attempts(self, clock, rng, on_retry, label)
        while True:
            try:
                return fn()
            except retry_on as e:
                d = st.next_delay(e)
            if d is None:
                break
            sleep(d)
            if st.expired():
                break
        return st.exhaust(fn, default)

    async def arun(
        self,
        fn,
        *,
        retry_on: tuple = (Exception,),
        clock=time.monotonic,
        rng: random.Random | None = None,
        on_retry=None,
        default=_RAISE,
        label: str = "",
    ):
        """Async twin of :meth:`run` — ``fn`` may be sync or a coroutine
        function; delays await ``asyncio.sleep`` so the event loop never
        blocks (signaling reconnects live here)."""
        st = self._Attempts(self, clock, rng, on_retry, label)
        while True:
            try:
                r = fn()
                if asyncio.iscoroutine(r):
                    r = await r
                return r
            except retry_on as e:
                d = st.next_delay(e)
            if d is None:
                break
            await asyncio.sleep(d)
            if st.expired():
                break
        return st.exhaust(fn, default)


# Shared shapes, named so call sites say what they mean:
# steady poll until a service comes up (no backoff growth, no jitter)
def poll_policy(budget_s: float, interval_s: float = 1.0) -> RetryPolicy:
    return RetryPolicy(
        attempts=None,
        base_delay_s=interval_s,
        max_delay_s=interval_s,
        multiplier=1.0,
        jitter=0.0,
        deadline_s=budget_s,
    )


# a handful of backed-off tries for one-shot control-plane calls.  Full
# jitter by default: these call sites (worker publish, Twilio tokens,
# Civitai downloads, example signaling) are exactly the fan-in points
# where a fleet retrying one shared service must not synchronize.
def transient_policy(attempts: int = 3, base_delay_s: float = 0.5) -> RetryPolicy:
    return RetryPolicy(
        attempts=attempts, base_delay_s=base_delay_s, full_jitter=True
    )
