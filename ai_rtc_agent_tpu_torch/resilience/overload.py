"""Bounded frame queues and the shed marker — the port's copy of the part of
ai_rtc_agent_tpu/resilience/overload.py that the batch scheduler and
``--multipeer`` need (``ShedFrame``, ``DeadlineQueue``).  The overload
ladder, admission and the loop-lag watchdog are a later slice.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future, InvalidStateError


class ShedFrame:
    """The source pixels of a frame a bounded queue shed under pressure.

    Its waiter resolves with this marker at once (recv never hangs); the
    marker tells accounting that no step produced it, and the track
    delivers ``frame`` as it is (passthrough)."""

    __slots__ = ("frame",)

    def __init__(self, frame):
        self.frame = frame


def shed_to_passthrough(future: Future, frame):
    """Resolve a shed frame's waiter at once with its ``ShedFrame`` (a
    waiter already cancelled or resolved stays so)."""
    try:
        if not future.done():
            future.set_result(ShedFrame(frame))
    except InvalidStateError:
        pass  # lost a race with a cancel: the waiter is unblocked either way


class DeadlineQueue:
    """Bounded freshest-frame-wins queue with per-entry stamps (the JAX
    class without its per-entry deadline, which the scheduler never sets).

    ``push`` never blocks: at the bound the OLDEST entry is shed (counted
    as ``shed_overflow``) and goes to ``on_evict(item, "overflow")``
    outside the lock.  ``pop`` returns the oldest entry.  Depth and the shed
    counter are plain ints, readable without the lock."""

    def __init__(self, bound: int, on_evict=None):
        self.bound = max(1, int(bound))
        self._on_evict = on_evict
        self._lock = threading.Lock()
        self._q: collections.deque = collections.deque(maxlen=self.bound)
        self.shed_overflow = 0

    @property
    def depth(self) -> int:
        return len(self._q)

    def push(self, item, stamp: float | None = None) -> bool:
        """Append ``item``; -> True when the bound forced a shed."""
        shed = None
        with self._lock:
            if len(self._q) >= self.bound:
                shed = self._q.popleft()
                self.shed_overflow += 1
            self._q.append((item, time.monotonic() if stamp is None else stamp))
        if shed is not None and self._on_evict is not None:
            self._on_evict(shed[0], "overflow")
        return shed is not None

    def pop(self):
        """-> (item, stamp) of the oldest entry, or None."""
        with self._lock:
            return self._q.popleft() if self._q else None

    def oldest_stamp(self) -> float | None:
        """Stamp of the oldest queued entry (None when empty): the batch
        scheduler's coalescing window runs from it."""
        with self._lock:
            return self._q[0][1] if self._q else None
