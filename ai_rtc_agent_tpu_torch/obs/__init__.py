"""Observability (the port's counterpart of ai_rtc_agent_tpu/obs/):

* trace.py: :class:`FrameTrace` span timelines through every hop of the
  media path, zero-cost when off.
* recorder.py: :class:`FlightRecorder`, bounded per-session rings of
  completed timelines and an always-on event log, snapshotted on
  StreamDegraded/FAILED and on demand (``GET /debug/flight``).
* export.py: Chrome trace-event JSON and JSONL renderings, and the
  torch.profiler bridge.
* slo.py: per-stage latency budgets and burn-rate breaches.
* promexport.py: the Prometheus text exposition of ``/metrics``.
* devtel.py: device telemetry: the serve-time build watchdog, graph-cache
  and transfer accounting, device memory.
"""

from .recorder import FlightRecorder, SessionRecorder  # noqa: F401
from .trace import (  # noqa: F401
    STAGES,
    TERMINALS,
    FrameTrace,
    SessionTracer,
    TraceController,
    get_trace,
)
