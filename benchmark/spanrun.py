"""run.py with the program's own spans on (spans.py).

    python3 -m benchmark.spanrun --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The same run, options and last line as run.py, with the port's tracing
on.  With ``--trace 1`` the tracers are on while the device profiler's
window is open, the line's metrics gain SPAN_METRICS (read from the
program's spans on the device trace's clock) and a ``spans:`` line on
standard error splits the settled span by them.  With ``--trace 0`` they
are on from the first claim to the end and there is no profiler: the run's
end-to-end metrics are what they read with tracing on, its cost against
run.py.

It wires the tracers in for the one run, with run.py and harness.py as
they are: subclasses stand in for camera.CameraFrame (a ``trace`` slot for
the track's tracer to hang a frame's trace on), tracks.VideoStreamTrack
(each track's tracer) and trace.Profiler (spans.ClockedProfiler),
harness.serve hands the scheduler its tracer, run.reader gives every
reader ``ctx["spans"]`` (collected once) and run.metrics_of adds
SPAN_METRICS.  A program without the pieces (spans.Tracing.make is None)
runs as under run.py.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from . import run as R
from .spans import ClockedProfiler, Tracing, collect, summary

SEAM = "track seam (server/tracks.py to ScheduledSession)"
SPAN_METRICS = [
    {"name": "idle_queued_share", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "batching (stream/scheduler.py)", "moves": "served_fps"},
    {"name": "resolve_lag_ms_p50", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": SEAM, "moves": "served_fps"},
    {"name": "submit_copy_ms_p50", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": SEAM, "moves": "frame_ms_p95"},
    {"name": "ingest_ms_p50", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": SEAM, "moves": "frame_ms_p95"},
]
UNTRACED_S = 3600.0  # --trace 0: the tracers' window (TRACE_MAX_CAPTURE_S caps it)


@contextlib.contextmanager
def spans_on(traffic: dict, traced: bool):
    """The tracers wired into run.py's run for the duration; yields the
    spans.Tracing, or None (and wires nothing) where the program lacks it."""
    from ai_rtc_agent_tpu_torch.server import tracks

    from . import camera as CAM
    from . import harness
    from . import trace as TR

    tracing = Tracing.make(traffic)
    if tracing is None:
        yield None
        return
    made = {"tracks": 0, "profile": None}

    class Frame(CAM.CameraFrame):
        __slots__ = ("trace",)

    class Track(tracks.VideoStreamTrack):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.tracer = tracing.tracer(made["tracks"])
            made["tracks"] += 1

    class Profiler(ClockedProfiler):
        def __init__(self):
            super().__init__(tracing)
            made["profile"] = self

    serve0, metrics0, reader0 = harness.serve, R.metrics_of, R.reader

    def serve(sched, *a, **k):
        tracing.attach(sched)
        if not traced:
            tracing.start(UNTRACED_S)
        return serve0(sched, *a, **k)

    def metrics_of(bench, workload, trace):
        out = metrics0(bench, workload, trace)
        have = {m["name"] for m in out}
        return out + [m for m in SPAN_METRICS if trace and m["name"] not in have]

    def reader(root, name):
        read = reader0(root, name)

        def with_spans(ctx):
            if "spans" not in ctx:
                ctx["spans"] = collect(tracing, made["profile"]) if ctx.get("trace_host") else None
                if ctx["spans"] is not None:
                    print(summary(ctx), file=sys.stderr, flush=True)
            return read(ctx)

        return with_spans

    swaps = [(CAM, "CameraFrame", Frame), (tracks, "VideoStreamTrack", Track),
             (TR, "Profiler", Profiler), (harness, "serve", serve),
             (R, "metrics_of", metrics_of), (R, "reader", reader)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, new in swaps:
        setattr(mod, name, new)
    try:
        yield tracing
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--trace", type=int, default=0)
    args, _ = ap.parse_known_args(argv)
    try:
        traffic = R.load_cell(R.ROOT, args.workload)[2]
    except Exception:  # run.py says why, and exits as it does
        return R.main(argv)
    with spans_on(traffic, bool(args.trace)):
        return R.main(argv)


if __name__ == "__main__":
    sys.exit(main())
