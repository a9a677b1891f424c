"""Prometheus text exposition (format 0.0.4) for ``/metrics?format=prom``
(the port's copy of ai_rtc_agent_tpu/obs/promexport.py).

The default ``/metrics`` body stays the JSON snapshot; this renders the
same numbers in the exposition format scrapers speak: ``# HELP`` /
``# TYPE`` per family, one sample per line, and the SLO plane's stage
histograms (obs/slo.py) as histogram families with cumulative ``le``
buckets and the ``+Inf`` terminal.

* Flat numeric snapshot keys give one sample each; ``*_total`` names are
  ``counter`` (``FrameStats.count`` is monotonic), the rest ``gauge``;
  bools render 0/1; ``None`` is omitted (an absent series is "no data").
* Nested sub-dicts (``overload_queues``, ``host_plane_sessions``,
  ``slo_stages``, ...) are not flattened into labels: their keys are
  per-session identities.  Per-session detail lives at ``/health``.
* The only labeled families are the SLO stage histograms and their
  budget and over-budget companions, labeled ``stage=<member of STAGES>``,
  a closed enum.
"""

from __future__ import annotations

from .slo import SloPlane
from .trace import STAGES

# the exposition-format version is a content-type PARAMETER — scrapers
# negotiate on it, so it must be byte-exact (Prometheus docs, text format)
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# families whose semantics deserve a real HELP string; everything else
# gets a generic one (HELP is mandatory grammar, not optional prose)
_HELP = {
    "fps": "sliding-window output frames per second",
    "frames_total": "frames recorded by the latency gauge",
    "slo_stage_latency_ms": (
        "per-stage frame latency, fixed buckets (obs/slo.py; stage label "
        "from the closed STAGES enum)"
    ),
    "slo_stage_budget_ms": "per-stage latency budget (SLO_<STAGE>_BUDGET_MS)",
    "slo_stage_over_budget_total": "observations past the stage budget",
    # the fleet router's rollup (fleet/routing.py): aggregated across
    # agents; per-agent detail is /fleet/health, JSON only
    "fleet_sessions": "live sessions across the fleet (summed per-agent /health)",
    "fleet_capacity_free": (
        "remaining admission capacity summed over bounded, unsaturated agents"
    ),
    "fleet_placements_total": "sessions placed by the fleet router",
    "fleet_drains_total": "agent drains initiated via POST /fleet/drain",
    "fleet_sessions_repointed_total": (
        "clients re-pointed off DEAD agents through AGENT_DEAD webhooks"
    ),
    # journey rollup (fleet/journey.py): the journey id is never a label;
    # per-journey detail lives at GET /fleet/debug/journey/<id>
    "journeys_total": "session journeys placed by the router (one per client session, across every leg)",
    "journeys_tracked": "journeys currently held in the bounded router table",
    "journey_legs_total": "placements across all journeys (leg 1 + crash re-placements)",
    "journey_replacements_total": "crash re-placements: legs that continued an existing journey on a new agent",
    "journey_events_total": "entries appended to journey event rings",
    "journeys_evicted_total": "journeys evicted from the bounded table (oldest first)",
    "journey_evidence_captured_total": "agent-side captures stored on breach webhooks (the records that survive a corpse)",
    "journey_bundles_sealed_total": "incident bundles frozen on the alert paths (AGENT_DEAD, breach volleys)",
    "journey_bundles_stored": "sealed incident bundles currently retained (bounded store)",
    "journey_started_total": "StreamStarted webhooks joined to a placement (placement-to-first-frame samples)",
    "journey_place_to_start_ms_p50": "placement-to-first-frame latency, median (bounded reservoir)",
    "journey_place_to_start_ms_p95": "placement-to-first-frame latency, p95",
    "journey_place_to_start_ms_p99": "placement-to-first-frame latency, p99",
    # live session migration (the router's drain-as-move and crash
    # restore): never a per-session or per-agent label
    "migrations_total": "sessions moved to another agent (drain-as-move + crash restore)",
    "migrations_failed_total": "migration attempts aborted (source kept serving; kill-drain semantics)",
    "migration_fallbacks_total": "migrate-drains that hit MIGRATE_TIMEOUT_S and fell back to kill-drain",
    "migration_snapshots_banked": "recent session exports held for the crash-restore path (bounded, TTL'd)",
    "migration_ms_p50": "export-to-re-point migration latency, median (bounded reservoir)",
    "migration_ms_p99": "export-to-re-point migration latency, p99",
    # engine fault domain (resilience/engine_guard.py): the guard's counters
    "engine_trips_total": "engine guard trips (step deadline blown or device lost)",
    "engine_rebuilds_total": "successful engine rebuilds after a trip",
    "engine_quarantined": "1 while the engine guard is not ARMED (no dispatches)",
    "engine_rebuild_ms_p50": "engine rebuild wall time, median (bounded reservoir)",
    "engine_rebuild_ms_p99": "engine rebuild wall time, p99",
    # the router's evacuation rollup
    "fleet_agents_failed": "agents parked FAILED after self-evacuation",
    "evacuations_total": "agent self-evacuations accepted via POST /fleet/evacuate",
    "evacuation_session_move_ms_p50": "per-session evacuation move latency, median",
    "evacuation_session_move_ms_p99": "per-session evacuation move latency, p99",
}


def _is_valid_name(name: str) -> bool:
    # snake_case: stricter than Prometheus's grammar, so exposition-safe
    if not name or not name[0].isalpha():
        return False
    return all(c.isalnum() or c == "_" for c in name)


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if f != f:  # NaN never leaves this process — an absent series is honest
        raise ValueError("NaN sample")
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def labeled(name: str, labels: dict, value) -> str:
    """One labeled sample line.  Label values must come from closed enums,
    never a session or frame id."""
    body = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in labels.items()
    )
    return f"{name}{{{body}}} {_fmt_value(value)}"


class _Family:
    def __init__(self, name: str, kind: str):
        self.name = name
        self.kind = kind
        self.samples: list = []

    def render(self, out: list):
        help_text = _HELP.get(self.name, f"{self.name} ({self.kind})")
        out.append(f"# HELP {self.name} {_escape_help(help_text)}")
        out.append(f"# TYPE {self.name} {self.kind}")
        out.extend(self.samples)


def render(snapshot: dict, slo: SloPlane | None = None) -> str:
    """The full exposition body for one scrape."""
    families: list = []
    for key in snapshot:
        value = snapshot[key]
        if value is None or isinstance(value, (dict, list, str)):
            continue  # nested/per-session detail stays JSON-only
        if not _is_valid_name(key):
            continue  # never emit a line the scraper will reject
        kind = "counter" if key.endswith("_total") else "gauge"
        fam = _Family(key, kind)
        try:
            fam.samples.append(f"{key} {_fmt_value(value)}")
        except (TypeError, ValueError):
            continue
        families.append(fam)

    if slo is not None and slo.enabled:
        families.extend(_slo_families(slo))

    out: list = []
    for fam in families:
        fam.render(out)
    return "\n".join(out) + "\n"


def _slo_families(slo: SloPlane) -> list:
    hist = _Family("slo_stage_latency_ms", "histogram")
    budget = _Family("slo_stage_budget_ms", "gauge")
    over = _Family("slo_stage_over_budget_total", "counter")
    for stage in STAGES:
        h = slo.global_hist[stage]
        for le, acc in h.cumulative():
            hist.samples.append(
                labeled(
                    "slo_stage_latency_ms_bucket",
                    {"stage": stage, "le": le},
                    acc,
                )
            )
        hist.samples.append(
            labeled("slo_stage_latency_ms_sum", {"stage": stage}, h.sum_ms)
        )
        hist.samples.append(
            labeled("slo_stage_latency_ms_count", {"stage": stage}, h.count)
        )
        budget.samples.append(
            labeled("slo_stage_budget_ms", {"stage": stage}, h.budget_ms)
        )
        over.samples.append(
            labeled("slo_stage_over_budget_total", {"stage": stage}, h.over)
        )
    return [hist, budget, over]
