"""Device telemetry: the serve-time build watchdog, graph-cache and transfer
accounting, device memory (the port's counterpart of
ai_rtc_agent_tpu/obs/devtel.py).

The host-side planes (span timelines, SLO budgets) watch what this
process does to a frame; this one watches the device side, with the same
zero-cost-off discipline (``DEVTEL_ENABLE=0`` removes it: every ``note_*``
hook is then one module-global read and a None test).

* **Build watchdog.**  The JAX package hears every XLA compile through
  ``jax.monitoring``.  The port has no such listener: its builds happen at
  its own sites, and each site times itself, which is the JAX plane's
  fallback mode (``watchdog = "cache-wrap"``):

  - a :class:`~..aot.cache.GraphCache` build of a key (the CUDA graph
    capture on the card, the eager builder on the CPU; aot/cache.py);
  - an nvcc build of a kernel library (ops/kernels/build.py);
  - the g++ build of the native media runtime (media/native.py).

  Each build is recorded with its *phase* (``warmup`` while the process
  builds and prewarms, ``serving`` once the agent's startup is done), its
  duration and its attribution (the engine key, or the thread-local label
  of :func:`compile_scope`).  A build in the serving phase that no
  :func:`expected_scope` blessed and that takes at least
  ``DEVTEL_RETRACE_MIN_MS`` is a **serve-time breach** (the counterpart of
  a serve-time retrace: a capture freezes every session riding the
  plane).  It rides the JAX alert path: the flight recorder's event log of
  every live session, the StreamDegraded webhook with
  ``state="RETRACE_BREACH"``, and ``retrace_breaches_total`` at
  ``/metrics``.  The engine guard flips the phase back to ``warmup``
  around its rebuild, which recaptures every bucket: that is no breach.
* **Graph-cache accounting** (``aot_cache_*``, the JAX AOT cache's names):
  hits and misses of ``GraphCache.get`` (a step fetches its graph once per
  step), builds (captures) with their seconds, entries (steps held by the
  live caches: captured graphs on the card) and bytes (their graph pools'
  memory on the card; 0 on the CPU), refreshed at each build.
* **Transfer accounting**: H2D bytes and count at the staging paths
  (``stream/engine.py`` ``stage_into``, ``parallel/multipeer.py``
  ``stage_rows``), D2H at the readbacks (the engine's, the bucket step's
  rows).
* **Device memory**, sampled on the overload ladder's tick, rate-limited by
  ``DEVTEL_MEM_INTERVAL_S`` (a scrape reads the cached sample):
  ``device_mem_bytes_in_use`` / ``_peak_bytes_in_use`` from
  ``torch.cuda.memory_stats(device)`` (``allocated_bytes.all.current`` /
  ``.peak``), ``device_mem_bytes_limit`` from ``torch.cuda.mem_get_info``'s
  total, ``device_live_buffers`` from ``active.all.current`` (the
  allocator's live blocks), always for the serving device named, so no
  context is made on another device.  On the CPU the ``device_mem_*``
  gauges are absent, as the JAX plane omits them there, and
  ``device_live_buffers`` counts the static buffers of every step the live
  graph caches hold (``aot.cache.live_buffers``): the CPU allocator keeps
  no count of its blocks, and counting every tensor (a gc scan) blocks the
  loop for a tenth of a second.  So on the CPU it is not the JAX value
  (``len(jax.live_arrays())``): a comparison holds the key only.

Knobs: ``DEVTEL_ENABLE``, ``DEVTEL_RETRACE_MIN_MS``,
``DEVTEL_MEM_INTERVAL_S``, ``DEVTEL_COMPILE_LOG``,
``DEVTEL_BREACH_COALESCE_S``.
"""

from __future__ import annotations

import collections
import logging
import threading

import torch

from ..utils import env
from .trace import clock, safe_list

logger = logging.getLogger(__name__)

PHASE_WARMUP = "warmup"
PHASE_SERVING = "serving"


class DevTelPlane:
    """Process-wide device telemetry state, made the process's sink by
    :func:`activate`.  ``device``: the serving device, whose memory the
    sample reads (None or a CPU device: the CPU's gauges)."""

    def __init__(self, stats=None, on_breach=None, device=None):
        self.enabled = env.devtel_enabled()
        self.stats = stats  # FrameStats: breaches land as retrace_breaches_total
        self.on_breach = on_breach  # callable(info dict)
        self.device = device
        # a capture of a bucket takes hundreds of ms; a stray small build
        # stays recorded but quiet under the threshold
        self.retrace_min_ms = max(0.0, env.get_float("DEVTEL_RETRACE_MIN_MS", 250.0))
        self.mem_interval_s = max(0.5, env.get_float("DEVTEL_MEM_INTERVAL_S", 5.0))
        # the counters record every breach; the alert fan-out (webhook and
        # black-box events) coalesces to one volley per window
        self.breach_coalesce_s = max(0.0, env.get_float("DEVTEL_BREACH_COALESCE_S", 5.0))
        self._breach_fired_at = None
        self.phase = PHASE_WARMUP
        self.watchdog = "inactive"  # set by activate()
        self.compiles: collections.deque = collections.deque(
            maxlen=max(1, env.get_int("DEVTEL_COMPILE_LOG", 64))
        )
        self.compiles_total = 0
        self.compile_seconds_total = 0.0
        self.warmup_compiles = 0
        self.serving_compiles = 0
        self.retrace_breaches = 0
        self.last_breach = None
        self.aot_hits = 0
        self.aot_misses = 0
        self.aot_builds = 0
        self.aot_build_seconds = 0.0
        self.aot_entries = 0
        self.aot_bytes = 0
        self.h2d_transfers = 0
        self.h2d_bytes = 0
        self.d2h_transfers = 0
        self.d2h_bytes = 0
        self._mem: dict = {}
        self._mem_at = 0.0
        self._lock = threading.Lock()  # builds and cache touches
        self._tlock = threading.Lock()  # transfer counters (per frame)

    # -- phase machine ---------------------------------------------------------

    def serving(self):
        """Startup is done: from here on an unblessed build is a breach."""
        self.phase = PHASE_SERVING

    def warmup(self):
        """Back to the grace phase (the engine guard's rebuild)."""
        self.phase = PHASE_WARMUP

    # -- build watchdog -----------------------------------------------------------

    def record_compile(self, duration_s: float, context=None, expected: bool = False):
        """One build at a site of the port.  A breach iff serving phase, not
        blessed by an expected scope, and at least DEVTEL_RETRACE_MIN_MS."""
        ms = duration_s * 1e3
        entry = {
            "phase": self.phase,
            "duration_ms": round(ms, 3),
            "context": context or "unattributed",
            "expected": bool(expected),
        }
        with self._lock:
            self.compiles_total += 1
            self.compile_seconds_total += duration_s
            if entry["phase"] == PHASE_SERVING:
                self.serving_compiles += 1
            else:
                self.warmup_compiles += 1
            breach = (entry["phase"] == PHASE_SERVING and not expected
                      and ms >= self.retrace_min_ms)
            fire = False
            if breach:
                self.retrace_breaches += 1
                self.last_breach = entry
                now = clock()
                fire = (self._breach_fired_at is None
                        or now - self._breach_fired_at >= self.breach_coalesce_s)
                if fire:
                    self._breach_fired_at = now
            self.compiles.append(entry)
        if breach:
            if self.stats is not None:
                self.stats.count("retrace_breaches")
            cb = self.on_breach
            if cb is not None and fire:
                try:
                    cb(dict(entry))
                except Exception:  # observability must never break serving
                    logger.exception("devtel on_breach handler failed")

    # -- graph-cache accounting (aot/cache.py) -------------------------------------

    def note_aot(self, event: str, seconds: float = 0.0):
        with self._lock:
            if event == "hit":
                self.aot_hits += 1
            elif event == "miss":
                self.aot_misses += 1
            elif event == "build":
                self.aot_builds += 1
                self.aot_build_seconds += seconds

    def set_aot_inventory(self, entries: int, nbytes: int):
        with self._lock:  # a scrape never sees a torn entries/bytes pair
            self.aot_entries = int(entries)
            self.aot_bytes = int(nbytes)

    # -- transfer accounting ---------------------------------------------------------

    def note_h2d(self, nbytes: int):
        with self._tlock:
            self.h2d_transfers += 1
            self.h2d_bytes += nbytes

    def note_d2h(self, nbytes: int):
        with self._tlock:
            self.d2h_transfers += 1
            self.d2h_bytes += nbytes

    # -- device memory -------------------------------------------------------------

    def sample_memory(self, force: bool = False):
        """Refresh the memory gauges (rate-limited; the overload tick calls
        it, and :meth:`snapshot` lazily).  Best effort: a probe that fails
        leaves its gauge out."""
        if not self.enabled:
            return
        now = clock()
        if not force and now - self._mem_at < self.mem_interval_s:
            return
        self._mem_at = now
        mem: dict = {}
        dev = self.device
        try:
            if dev is not None and dev.type == "cuda":
                stats = torch.cuda.memory_stats(dev)
                for src, dst in (("allocated_bytes.all.current", "device_mem_bytes_in_use"),
                                 ("allocated_bytes.all.peak", "device_mem_peak_bytes_in_use")):
                    if src in stats:
                        mem[dst] = int(stats[src])
                mem["device_mem_bytes_limit"] = int(torch.cuda.mem_get_info(dev)[1])
                if "active.all.current" in stats:
                    mem["device_live_buffers"] = int(stats["active.all.current"])
            else:
                from ..aot.cache import live_buffers

                mem["device_live_buffers"] = live_buffers()
        except Exception:
            logger.debug("devtel memory sample failed", exc_info=True)
        self._mem = mem

    # -- observability ---------------------------------------------------------------

    def snapshot(self) -> dict:
        """/metrics gauges (the memory sample is the cached one).
        ``retrace_breaches_total`` rides the FrameStats counter."""
        self.sample_memory()  # a no-op within DEVTEL_MEM_INTERVAL_S
        out = {
            "devtel_enabled": int(self.enabled),
            "devtel_phase_serving": int(self.phase == PHASE_SERVING),
            "devtel_compiles_total": self.compiles_total,
            "devtel_compile_ms_total": round(1e3 * self.compile_seconds_total, 3),
            "devtel_serving_compiles_total": self.serving_compiles,
            "aot_cache_hits_total": self.aot_hits,
            "aot_cache_misses_total": self.aot_misses,
            "aot_cache_builds_total": self.aot_builds,
            "aot_cache_entries": self.aot_entries,
            "aot_cache_bytes": self.aot_bytes,
            "devtel_h2d_transfers_total": self.h2d_transfers,
            "devtel_h2d_bytes_total": self.h2d_bytes,
            "devtel_d2h_transfers_total": self.d2h_transfers,
            "devtel_d2h_bytes_total": self.d2h_bytes,
        }
        out.update(self._mem)
        return out

    def session_view(self) -> dict:
        """/health's per-session rendering: a serve-time capture freezes
        every live session, so each carries the same breach state."""
        return {
            "phase": self.phase,
            "retrace_breaches": self.retrace_breaches,
            "serving_compiles": self.serving_compiles,
            "last_breach": self.last_breach,
        }

    def health(self) -> dict:
        """/health's process-level dict: the phase and the recent builds."""
        return {
            "phase": self.phase,
            "watchdog": self.watchdog,
            "compiles_total": self.compiles_total,
            "retrace_breaches": self.retrace_breaches,
            "recent_compiles": safe_list(self.compiles)[-8:],
        }

    def fragment(self) -> dict:
        """The incident-bundle rendering: the /health view plus the breach."""
        return {**self.health(), "last_breach": self.last_breach}


# ---------------------------------------------------------------------------
# module-level dispatch: the note_* hooks the hot paths call are one global
# read and a None test when no plane is active
# ---------------------------------------------------------------------------

_ACTIVE: DevTelPlane | None = None
_CTX = threading.local()  # .label / .expected: the build attribution


def activate(plane: DevTelPlane) -> DevTelPlane:
    """Make ``plane`` the process's telemetry sink.  A disabled plane is
    activated too (its no-op hooks are the off path)."""
    global _ACTIVE
    _ACTIVE = plane
    plane.watchdog = "cache-wrap" if plane.enabled else "disabled"
    return plane


def deactivate(plane: DevTelPlane | None = None):
    """Detach (idempotent); with ``plane``, only if it is still the active one."""
    global _ACTIVE
    if plane is None or _ACTIVE is plane:
        _ACTIVE = None


def active() -> DevTelPlane | None:
    return _ACTIVE


# -- hot-path hooks (one global read + None test when off) -------------------

def note_h2d(nbytes: int):
    plane = _ACTIVE
    if plane is not None and plane.enabled:
        plane.note_h2d(int(nbytes))


def note_d2h(nbytes: int):
    plane = _ACTIVE
    if plane is not None and plane.enabled:
        plane.note_d2h(int(nbytes))


def note_aot(event: str, seconds: float = 0.0, context=None, inventory=None):
    """A graph-cache touch (aot/cache.py).  A ``build`` is also the build
    record (the cache-wrap watchdog), attributed to ``context`` or the
    scope's label; ``inventory``: a callable -> (entries, bytes), read
    after a build."""
    plane = _ACTIVE
    if plane is None or not plane.enabled:
        return
    plane.note_aot(event, seconds=seconds)
    if event != "build":
        return
    plane.record_compile(seconds, context=context or getattr(_CTX, "label", None),
                         expected=getattr(_CTX, "expected", False))
    if inventory is not None:
        try:
            entries, nbytes = inventory()
        except Exception:
            logger.debug("devtel inventory read failed", exc_info=True)
        else:
            plane.set_aot_inventory(entries, nbytes)


def note_build(seconds: float, context: str):
    """A toolchain build (nvcc, g++) that this process ran, timed by its site."""
    plane = _ACTIVE
    if plane is not None and plane.enabled:
        plane.record_compile(seconds, context=context, expected=getattr(_CTX, "expected", False))


# -- attribution scopes ------------------------------------------------------

class _NullScope:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullScope()


class _Scope:
    """Thread-local build attribution; save and restore, so nested scopes
    compose."""

    __slots__ = ("label", "expected", "_prev")

    def __init__(self, label, expected):
        self.label = label
        self.expected = expected

    def __enter__(self):
        self._prev = (getattr(_CTX, "label", None), getattr(_CTX, "expected", False))
        _CTX.label = self.label
        _CTX.expected = self.expected
        return self

    def __exit__(self, *exc):
        _CTX.label, _CTX.expected = self._prev
        return False


def compile_scope(label: str, expected: bool = False):
    """Attribute a build inside the body to ``label`` (a bucket
    ``sbucket-<k>:<variant>``, ``peers-<k>:<variant>``, ``engine-step``).
    ``expected=True`` also blesses it (recorded, never a breach): the
    prewarm sites; a lazy build at dispatch keeps ``expected=False``."""
    plane = _ACTIVE
    if plane is None or not plane.enabled:
        return _NULL
    return _Scope(label, expected)


def expected_scope(label: str = "host-state-build"):
    """Bless the body's builds: recorded and attributed, never a breach
    (session state builds, slot installs, prompt encodes, control writes)."""
    plane = _ACTIVE
    if plane is None or not plane.enabled:
        return _NULL
    return _Scope(label, True)
