"""First-party AST static analysis over the port: the cross-cutting
invariants of its serving process, enforced by machine.

The port's agent runs the same planes as the JAX one (an asyncio WebRTC
plane, daemon step-runner threads, pooled zero-copy buffers, an admission
gate) in one address space, so it carries the same hazards.  Sixteen rules
are the JAX package's checkers (docs/static-analysis.md); the last two are
its device rules rewritten for torch and CUDA graphs.  All are stdlib
``ast`` only, with every tree-specific path and name drawn from a
:class:`~.core.Profile`:

  async-blocking      blocking calls lexically inside ``async def``
  bounded-queue       asyncio.Queue/deque without an explicit finite bound
  encoder-reconfig    encoder bitrate/GOP mutations outside the single
                      reconfigure() path (media/codec.py owns tr_h264_*)
  lock-discipline     an attribute written under ``with self._lock:`` in
                      one method, lock-free in another
  loop-affinity       thread-tainted code touching loop-bound asyncio
                      objects; async-def code blocking on threads
  task-lifecycle      spawned tasks / minted futures that never reach an
                      owner on some path
  pooled-view         pool-returned memoryviews escaping frame scope
  span-pairing        trace.begin() without a matching end on some path
  env-registry        env knobs <-> docs/environment.md and
                      ai_rtc_agent_tpu_torch/environment.md, both directions
  metric-cardinality  exported metric label values must come from closed enums
  metrics-registry    /metrics name grammar + collision freedom
  retry-4xx           permanent HTTP 4xx retried as transient
  restart-defaults    recovery paths re-applying compile-time defaults
  http-contract       routes (aiohttp registrations and the literal ROUTES
                      tables) <-> docs/http-api.md; headers <-> server/wire.py
  refusal-discipline  503s carry Retry-After; webhook vocabulary is closed
  reservation-pairing admission/claim reservations released on every path
  device-transfer     frames cross host <-> card only in the staging and
                      readback helpers (stray H2D, stray D2H, stray async
                      D2H, a whole step output drained to the host)
  capture-purity      no host read or host crossing inside a function a
                      CUDA graph captures (the JAX trace-purity rule)

Entry point: ``python -m ai_rtc_agent_tpu_torch.analysis`` (text/json,
--changed, shrink-only baseline ``analysis/baseline.json``).
"""

from .core import (  # noqa: F401
    ALL_CHECKERS,
    PORT,
    Finding,
    Profile,
    Project,
    load_project,
    run_checkers,
)
