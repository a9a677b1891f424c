"""Short GOP cache for broadcast viewer re-sync (the port's copy of
ai_rtc_agent_tpu/media/gop.py; the broadcast plane that reads it is a later
slice of the port).

A WHEP viewer that joins mid-stream (or loses packets and sends a PLI)
needs an IDR before it can decode — the dedicated-chain design served
that by forcing the ENCODER to emit one per viewer event, and nothing
protected the engine/encoder from a viewer storm.  The broadcast plane
instead keeps the stream's current GOP — the last IDR access unit plus
every delta AU encoded since — as stable bytes, so re-sync is a
packetize + per-viewer header-rewrite replay that never touches the
engine or the encoder.  Storms are additionally coalesced by the
per-publisher :class:`~ai_rtc_agent_tpu_torch.resilience.netadapt.KeyframeGovernor`
(one replay per coalesce window).

Memory is bounded two ways (``BROADCAST_GOP_CACHE_AUS`` /
``BROADCAST_GOP_CACHE_BYTES``): a GOP that outgrows either bound clears
the cache entirely rather than evicting its head — a GOP missing its
IDR can't re-sync anyone, so holding the tail would be dead weight that
LOOKS serviceable.  The next IDR re-arms it; ``overflows`` counts how
often that happened (a sustained count means the encoder GOP length and
the cache budget disagree).

Thread contract: ``add`` runs on the encode worker thread (the sink's
AU tap); ``snapshot``/``clear`` run on the event loop — one lock, held
only for deque/counter mutation, never across a copy of AU bytes.
"""

from __future__ import annotations

import collections
import threading

from .codec import NullCodec
from .rtp import split_nals
from ..utils import env

IDR_NAL = 5


def au_is_idr(au) -> bool:
    """True when the access unit can open a decode (re-sync point).

    Real H.264: any NAL of type 5 (IDR slice).  NullCodec AUs (the
    hermetic tier) are all intra — recognized by the TRAW magic in the
    first NAL payload."""
    for s, e in split_nals(au):
        if (au[s] & 0x1F) == IDR_NAL:
            return True
        if au[s:s + 4] == NullCodec.MAGIC:
            return True
    return False


class GopCache:
    """Bounded cache of the current GOP: (AU bytes, RTP timestamp)."""

    def __init__(self, max_aus: int | None = None,
                 max_bytes: int | None = None):
        if max_aus is None:
            max_aus = env.get_int("BROADCAST_GOP_CACHE_AUS", 64)
        if max_bytes is None:
            max_bytes = env.get_int("BROADCAST_GOP_CACHE_BYTES", 8 << 20)
        self.max_aus = max(1, max_aus)
        self.max_bytes = max(1, max_bytes)
        # tpurtc: allow[bounded-queue] -- bounded by max_aus/max_bytes in add(); overflow clears the cache WHOLE (an IDR-less GOP can't re-sync anyone), which deque(maxlen=) head-eviction would silently violate
        self._aus: collections.deque = collections.deque()
        self._bytes = 0
        self._lock = threading.Lock()
        self.idrs = 0       # IDR boundaries observed (monotonic)
        self.overflows = 0  # bound-exceeded clears (monotonic)

    def add(self, au, ts: int) -> bool:
        """Record one encoded AU; returns whether it was an IDR boundary.

        Stabilizes ``au`` to bytes (the cache holds across frames, so a
        pooled view must never land here un-copied)."""
        data = au if isinstance(au, bytes) else bytes(au)
        is_idr = au_is_idr(data)
        with self._lock:
            if is_idr:
                self._aus.clear()
                self._bytes = 0
                self.idrs += 1
            elif not self._aus:
                # mid-GOP with no cached IDR: nothing here could re-sync
                # a viewer — stay empty until the next boundary
                return False
            if (
                len(self._aus) + 1 > self.max_aus
                or self._bytes + len(data) > self.max_bytes
            ):
                self._aus.clear()
                self._bytes = 0
                self.overflows += 1
                return is_idr
            self._aus.append((data, ts & 0xFFFFFFFF))
            self._bytes += len(data)
        return is_idr

    def snapshot(self) -> list:
        """The replayable GOP, oldest (IDR) first — stable bytes, safe to
        packetize at any later time."""
        with self._lock:
            return list(self._aus)

    def clear(self) -> None:
        with self._lock:
            self._aus.clear()
            self._bytes = 0

    @property
    def aus(self) -> int:
        with self._lock:
            return len(self._aus)

    @property
    def bytes(self) -> int:
        with self._lock:
            return self._bytes
