"""The fleet control plane: capacity-aware routing across agent processes
(counterpart of ai_rtc_agent_tpu/fleet/).

* :mod:`.registry`: membership and health (agent records fed by worker
  publishes and by polling each agent's /capacity and /health), the
  HEALTHY/DEGRADED/DRAINING/FAILED/DEAD state machine, epochs and boot ids,
  and the autoscaler's decision logic;
* :mod:`.journey`: cross-process trace correlation and incident bundles;
* :mod:`.routing`: the router's core with no web framework (placement, the
  session table, drain and migrate-drain, evacuation, rolling upgrade,
  event ingest, journey bundles, the rollup), reaching agents through
  :mod:`.transport` (aiohttp, or agents in this process);
* :mod:`.router`: the aiohttp application over it (``build_router_app``,
  imported on first use: the card's machine has no aiohttp).
"""

from .journey import JourneyLog
from .registry import AGENT_STATES, AgentRecord, FleetPoller, FleetRegistry

__all__ = [
    "AGENT_STATES",
    "AgentRecord",
    "FleetPoller",
    "FleetRegistry",
    "JourneyLog",
    "build_router_app",
]


def __getattr__(name):
    if name == "build_router_app":
        from .router import build_router_app

        return build_router_app
    raise AttributeError(name)
