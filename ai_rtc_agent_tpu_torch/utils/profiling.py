"""fps / latency gauges for /metrics (counterpart of ``FrameStats`` in
ai_rtc_agent_tpu/utils/profiling.py; the JAX profiler hook has no
counterpart here)."""

from __future__ import annotations

import collections
import threading
import time


class FrameStats:
    """Sliding-window fps + latency percentiles (thread-safe, O(1) record),
    per-stage durations, monotonic counters and last-value gauges."""

    def __init__(self, window: int = 240):
        self._lat = collections.deque(maxlen=window)
        self._times = collections.deque(maxlen=window)
        self._stages: dict = {}
        self._window = window
        self._lock = threading.Lock()
        self._counts: dict = {}
        self._gauges: dict = {}
        self.frames_total = 0

    def record(self, latency_s: float, t: float | None = None):
        with self._lock:
            self._lat.append(latency_s)
            self._times.append(t if t is not None else time.monotonic())
            self.frames_total += 1

    def record_stage(self, stage: str, seconds: float):
        with self._lock:
            q = self._stages.get(stage)
            if q is None:
                q = self._stages[stage] = collections.deque(maxlen=self._window)
            q.append(seconds)

    def count(self, name: str, n: int = 1):
        """Monotonic event counter; lands in the snapshot as ``<name>_total``."""
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def gauge(self, name: str, value):
        """Last-value gauge (receiver-report loss and jitter); lands in the
        snapshot under its own name."""
        with self._lock:
            self._gauges[name] = value

    def stage_snapshot_us(self, stages=None) -> dict:
        """Microsecond stage percentiles (p50/p90/p99 and the sample count)
        of the host media plane's stages (packetize/protect/send/recv),
        which the ms-scaled snapshot floors to noise; ``stages=None`` takes
        every recorded stage.  Counters ride along as ``<name>_total``."""
        with self._lock:
            items = {k: sorted(q) for k, q in self._stages.items()
                     if q and (stages is None or k in stages)}
            counts = dict(self._counts)
        out: dict = {}
        for name, q in items.items():
            n = len(q)
            out[f"{name}_p50_us"] = round(1e6 * q[n // 2], 2)
            out[f"{name}_p90_us"] = round(1e6 * q[min(n - 1, int(n * 0.9))], 2)
            out[f"{name}_p99_us"] = round(1e6 * q[min(n - 1, int(n * 0.99))], 2)
            out[f"{name}_count"] = n
        for name, c in counts.items():
            out[f"{name}_total"] = c
        return out

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            times = list(self._times)
            stages = {k: sorted(q) for k, q in self._stages.items()}
            counts = dict(self._counts)
            gauges = dict(self._gauges)
        out = {
            "frames_total": self.frames_total,
            "fps": 0.0,
            "latency_p50_ms": None,
            "latency_p90_ms": None,
            "latency_max_ms": None,
        }
        if len(times) >= 2 and times[-1] > times[0]:
            out["fps"] = (len(times) - 1) / (times[-1] - times[0])
        if lat:
            out["latency_p50_ms"] = 1e3 * lat[len(lat) // 2]
            out["latency_p90_ms"] = 1e3 * lat[min(len(lat) - 1, int(len(lat) * 0.9))]
            out["latency_max_ms"] = 1e3 * lat[-1]
        for name, q in stages.items():
            if q:
                out[f"{name}_p50_ms"] = 1e3 * q[len(q) // 2]
                out[f"{name}_p90_ms"] = 1e3 * q[min(len(q) - 1, int(len(q) * 0.9))]
        for name, n in counts.items():
            out[f"{name}_total"] = n
        out.update(gauges)
        return out
