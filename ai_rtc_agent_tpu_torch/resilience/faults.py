"""Deterministic, seedable fault injection for the media and compute paths
(the port's copy of ai_rtc_agent_tpu/resilience/faults.py).

A *fault plan* is a list of fault specs plus a seed.  Every injection
decision is drawn from a per-scope PRNG seeded from ``(plan seed, scope
target, scope instance)``, so the same plan replays the same faults step for
step: chaos tests are ordinary deterministic tests.

Activation: ``activate(FaultPlan(...))``, or the ``FAULT_PLAN`` env var
(inline JSON, or ``@/path/to/plan.json``) read once at import.  Hook sites
bind a scope at construction (``faults.scope("engine")``, None when no plan
targets them) and guard the hot path with one ``is not None`` test.

Plan JSON shape::

    {"seed": 7, "faults": [
        {"target": "engine", "kind": "slow_step", "start": 50, "stop": 55,
         "delay_s": 3.0},
        {"target": "engine", "kind": "nan", "start": 60, "stop": 62},
        {"target": "engine", "kind": "device_lost", "start": 70, "stop": 71},
        {"target": "engine", "kind": "wedge", "start": 80, "stop": 81},
        {"target": "rx", "kind": "drop", "p": 0.3, "start": 100, "stop": 400}]}

``engine`` faults fire once per step, before the step: ``slow_step`` blocks
the stepping thread for ``delay_s``, ``wedge`` blocks it until
:func:`release_wedge`, ``device_lost`` raises :class:`DeviceLostError`,
``nan`` makes the step's output a float array of NaNs.  The ``rx``/``tx``
kinds (drop, dup, reorder, delay, truncate, loss_burst) are carried whole
for the media plane, which has no hook site in the port yet.
``start``/``stop`` bound a fault to an index window (``stop`` exclusive);
``p`` is the per-event probability (1.0 by default).
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
from dataclasses import dataclass

logger = logging.getLogger(__name__)

NET_KINDS = ("drop", "dup", "reorder", "delay", "truncate", "loss_burst")
ENGINE_KINDS = ("slow_step", "nan", "device_lost", "wedge")
TARGETS = ("rx", "tx", "engine")


class DeviceLostError(RuntimeError):
    """Injected accelerator loss (the XLA 'device halted' analog)."""


@dataclass(frozen=True)
class FaultSpec:
    target: str
    kind: str
    p: float = 1.0
    start: int = 0
    stop: int | None = None  # exclusive; None = unbounded
    delay_s: float = 0.05  # for delay / slow_step
    keep: int = 8  # for truncate: bytes kept
    period: int = 10  # for loss_burst: packets per on/off duty cycle
    burst: int = 5  # for loss_burst: packets DROPPED at each cycle start

    def __post_init__(self):
        if self.target not in TARGETS:
            raise ValueError(f"unknown fault target {self.target!r}")
        kinds = ENGINE_KINDS if self.target == "engine" else NET_KINDS
        if self.kind not in kinds:
            raise ValueError(
                f"unknown {self.target} fault kind {self.kind!r} "
                f"(expected one of {kinds})"
            )
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault p={self.p} outside [0, 1]")
        if self.kind == "loss_burst":
            if self.period < 1:
                raise ValueError(f"loss_burst period={self.period} must be >= 1")
            if not 0 <= self.burst <= self.period:
                raise ValueError(
                    f"loss_burst burst={self.burst} outside [0, period="
                    f"{self.period}]"
                )

    def in_window(self, index: int) -> bool:
        return index >= self.start and (self.stop is None or index < self.stop)

    def in_burst_phase(self, index: int) -> bool:
        """loss_burst duty cycle: the first ``burst`` of every ``period``
        packets (counted from the window start) drop.  Pure index
        arithmetic — a sustained-loss episode replays packet-for-packet
        with no per-packet probability to tune, which is what lets tier-1
        script the network ladder's hysteresis deterministically."""
        return (index - self.start) % self.period < self.burst


@dataclass(frozen=True)
class FaultPlan:
    specs: tuple = ()
    seed: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        specs = tuple(
            FaultSpec(**{k: v for k, v in f.items()}) for f in d.get("faults", [])
        )
        return cls(specs=specs, seed=int(d.get("seed", 0)))

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    def for_target(self, target: str) -> tuple:
        return tuple(s for s in self.specs if s.target == target)


# The one process-global activation slot.  Hot paths never read it — they
# bind a scope at session construction; this exists so sessions created
# while a plan is live pick it up, and so deactivation is one assignment.
ACTIVE: FaultPlan | None = None
_SCOPE_SEQ = 0  # distinct per-scope RNG streams within one plan

# wedge release gate — plan-global so one call frees every wedged scope.
# activate() swaps in a FRESH event (after freeing stragglers from the
# previous plan), so a released wedge never leaks into the next plan.
_WEDGE_RELEASE = threading.Event()


def activate(plan: FaultPlan) -> FaultPlan:
    global ACTIVE, _SCOPE_SEQ, _WEDGE_RELEASE
    _WEDGE_RELEASE.set()  # free any step still wedged on the old plan
    _WEDGE_RELEASE = threading.Event()
    ACTIVE = plan
    _SCOPE_SEQ = 0
    logger.warning(
        "FAULT INJECTION ACTIVE: %d spec(s), seed=%d", len(plan.specs), plan.seed
    )
    return plan


def deactivate() -> None:
    global ACTIVE
    ACTIVE = None
    _WEDGE_RELEASE.set()


def release_wedge() -> None:
    """Unblock every step currently held by a ``wedge`` fault (and any
    future wedge hit under the SAME plan — a released wedge stays open)."""
    _WEDGE_RELEASE.set()


def active() -> FaultPlan | None:
    return ACTIVE


def scope(target: str):
    """Bind a fault scope for one hook site, or None when injection is off
    (or the active plan has no faults for this target) — the None is what
    makes disabled injection free."""
    if target not in TARGETS:
        raise ValueError(f"unknown fault target {target!r}")
    plan = ACTIVE
    if plan is None:
        return None
    specs = plan.for_target(target)
    if not specs:
        return None
    global _SCOPE_SEQ
    _SCOPE_SEQ += 1
    rng = random.Random(f"{plan.seed}:{target}:{_SCOPE_SEQ}")
    if target == "engine":
        return EngineFaultScope(specs, rng)
    return NetFaultScope(specs, rng)


class NetFaultScope:
    """Datagram-path fault transformer (one per socket direction).

    ``apply(data) -> [(datagram, delay_s), ...]`` — empty list = dropped,
    two entries = duplicated, ``delay_s > 0`` = deliver that one late.
    ``reorder`` holds the datagram and releases it after the next one that
    passes through, swapping their order deterministically.
    """

    def __init__(self, specs, rng: random.Random):
        self.specs = specs
        self.rng = rng
        self.index = 0  # packets seen
        self.stats = {k: 0 for k in NET_KINDS}
        self._held: bytes | None = None  # reorder slot

    def apply(self, data: bytes) -> list:
        i = self.index
        self.index += 1
        out = [(data, 0.0)]
        for s in self.specs:
            if not s.in_window(i) or self.rng.random() >= s.p:
                continue
            if s.kind == "loss_burst":
                # deterministic on/off duty cycle (the p gate above still
                # applies; default p=1.0 keeps it purely index-driven)
                if not s.in_burst_phase(i):
                    continue
                self.stats[s.kind] += 1
                out = []
                break
            self.stats[s.kind] += 1
            if s.kind == "drop":
                out = []
                break
            if s.kind == "dup":
                out = out + [(data, 0.0)]
            elif s.kind == "delay":
                out = [(d, dl + s.delay_s) for d, dl in out]
            elif s.kind == "truncate":
                out = [(d[: s.keep], dl) for d, dl in out]
            elif s.kind == "reorder":
                if self._held is None:
                    self._held = data
                    out = []
                    break
        if self._held is not None and out:
            held, self._held = self._held, None
            out = out + [(held, 0.0)]
        return out


class EngineFaultScope:
    """Compute-path fault driver (one per engine).

    ``step()`` is called once per diffusion step *before* dispatch:
    ``slow_step`` blocks the calling (worker) thread for ``delay_s`` —
    a stalled device step; ``wedge`` blocks it open-endedly until
    :func:`release_wedge` (the guard-deadline test shape); ``device_lost``
    raises :class:`DeviceLostError`; ``nan`` returns ``"nan"`` and the
    engine substitutes a non-finite output (NaN latents that survived the
    decode).
    """

    def __init__(self, specs, rng: random.Random, sleep=time.sleep):
        self.specs = specs
        self.rng = rng
        self.index = 0
        self.stats = {k: 0 for k in ENGINE_KINDS}
        self._sleep = sleep
        # bound at scope construction (scopes are created under an active
        # plan, after activate() armed the fresh event)
        self._wedge = _WEDGE_RELEASE

    def step(self) -> str | None:
        i = self.index
        self.index += 1
        for s in self.specs:
            if not s.in_window(i) or self.rng.random() >= s.p:
                continue
            self.stats[s.kind] += 1
            if s.kind == "slow_step":
                self._sleep(s.delay_s)
                return "slow_step"
            if s.kind == "wedge":
                self._wedge.wait()
                return "wedge"
            if s.kind == "device_lost":
                raise DeviceLostError(
                    f"injected device loss at step {i} (fault plan)"
                )
            if s.kind == "nan":
                return "nan"
        return None


def _install_from_env() -> None:
    from ..utils import env as env_util

    raw = env_util.get_str("FAULT_PLAN")
    if not raw:
        return
    try:
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        activate(FaultPlan.from_json(raw))
    except (OSError, ValueError, TypeError) as e:
        # a malformed plan must not take the agent down — injection simply
        # stays off, loudly
        logger.error("FAULT_PLAN ignored (unparseable): %s", e)


_install_from_env()
