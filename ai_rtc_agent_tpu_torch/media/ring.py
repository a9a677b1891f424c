"""The decoded-frame ring between the media plane's decode thread and the
track that feeds the pipeline (the port's copy of
ai_rtc_agent_tpu/media/ring.py).

Frames move as uint8 [H, W, 3] through the native latest-wins SPSC ring
(native/frame_ring.cpp): a slow consumer drops stale frames instead of
building a latency queue.  Without the native runtime a Python list with
the same latest-wins rule stands in.
"""

from __future__ import annotations

import ctypes
import logging
import threading

import numpy as np

from . import native

logger = logging.getLogger(__name__)


class FrameRing:
    """numpy-facing wrapper over the native SPSC ring (python fallback when
    the native lib is unavailable)."""

    def __init__(self, frame_shape, n_slots: int = 4, pop_pool: int | None = None):
        self.frame_shape = tuple(frame_shape)
        self.slot_bytes = int(np.prod(self.frame_shape))
        self._lib = native.load()
        # pop() allocates a fresh frame per call by default.  With
        # ``pop_pool=N`` (or HOST_PLANE_RING_POP_POOL=N) frames rotate
        # through N preallocated buffers instead — zero steady-state
        # allocation, but a popped frame is only valid until N more pops,
        # so ONLY consumers that hand the pixels off (device_put) before
        # then may opt in.  Off by default: plenty of callers retain
        # frames (tests, quality probes).
        if pop_pool is None:
            from ..utils import env as env_util

            pop_pool = env_util.get_int("HOST_PLANE_RING_POP_POOL", 0)
        self._pop_pool = (
            [np.empty(self.slot_bytes, np.uint8) for _ in range(pop_pool)]
            if pop_pool and pop_pool >= 2
            else None
        )
        self._pop_i = 0
        if self._lib is not None:
            self._ring = self._lib.tr_ring_create(self.slot_bytes, n_slots)
        else:
            self._ring = None
            self._q: list = []
            self._lock = threading.Lock()
            self._n = n_slots
            self._dropped = 0

    def push_latest(self, frame: np.ndarray, meta: int = 0) -> bool:
        frame = np.ascontiguousarray(frame, np.uint8)
        if self._ring:
            p = frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            return bool(
                self._lib.tr_ring_push_latest(self._ring, p, frame.nbytes, meta)
            )
        with self._lock:
            if len(self._q) >= self._n:
                self._q.pop(0)
                self._dropped += 1
            self._q.append((frame.copy(), meta))
        return True

    def pop(self):
        """-> (frame [*shape] uint8, meta) or None (always None once
        closed — a late consumer must get an empty answer, not a crash)."""
        if getattr(self, "_destroyed", False):
            return None
        if self._ring:
            if self._pop_pool is not None:
                out = self._pop_pool[self._pop_i]
                self._pop_i = (self._pop_i + 1) % len(self._pop_pool)
            else:
                out = np.empty(self.slot_bytes, np.uint8)
            meta = ctypes.c_int64(0)
            n = self._lib.tr_ring_try_pop(
                self._ring,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                out.size,
                ctypes.byref(meta),
            )
            if n < 0:
                return None
            return out[:n].reshape(self.frame_shape), meta.value
        with self._lock:
            if not self._q:
                return None
            return self._q.pop(0)

    @property
    def size(self) -> int:
        if self._ring:
            return int(self._lib.tr_ring_size(self._ring))
        return len(self._q)

    @property
    def dropped(self) -> int:
        if self._ring:
            return int(self._lib.tr_ring_dropped(self._ring))
        return self._dropped

    def close(self):
        self._destroyed = True
        if self._ring:
            self._lib.tr_ring_destroy(self._ring)
            self._ring = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


