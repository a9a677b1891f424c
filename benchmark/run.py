"""Run one cell of the port's benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``ai_rtc_agent_tpu_torch``)
and ``BENCHMARK.json``.  The cell names a configuration
(``benchmark/configs/<name>.json``), whose model comes from the family
module that it names (``benchmark/reference/<family>.py``, families.py),
and a traffic mix (``benchmark/traffic/<name>.json``); each metric is read
by ``benchmark/metrics/<name>.py``.  With ``--trace 0`` the run reports the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics (a
device profiler window inside the measured one) and a ``breakdown``.

Set-up: the weights drawn on the card from the seed, the program built
and every bucket of the cell captured, the sessions claimed and their
cameras served until each has returned frames (setup_s ends here).  Then
``--seconds`` are measured; then the program is freed and the plain
reference checks the frames the window produced (compare.py).  The last
line of standard output is one JSON object: ``correct``, ``attempted``
(frames the tracks submitted in the window), ``failed`` (of those, frames
that came back unprocessed or raised), ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit, also the last lines on standard error.

It exits non-zero and prints no result when the cell or its
configuration's family module is not there, when the port cannot be
imported, when no CUDA card answers or fewer than the cell asks for, when
JAX or the JAX package is loaded once the window has closed, on SIGTERM, on any
error, and when it is still going after ``WATCHDOG_S`` (then with every
thread's stack on standard error).  ``--control fp8`` (not a benchmark run) puts the reference's frames
in float8 in the program's place: the same check then has to read
``correct`` false.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import signal  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

from . import families  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DEVICE = "cuda:0"  # the one card a one-chip cell runs on
FORBIDDEN = ("jax", "jaxlib", "flax", "ai_rtc_agent_tpu")
WATCHDOG_S = 340.0  # a run still going then prints every thread's stack and exits 1


class Refused(Exception):
    """A run that must end with no result: (exit code, reason)."""

    def __init__(self, code: int, reason: str):
        super().__init__(reason)
        self.code = code


def load_cell(root: Path, workload: str):
    """-> (the cell, its configuration, its traffic, the benchmark's metrics)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(2, f"no workload {workload!r} in BENCHMARK.json ({', '.join(cells)})")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / cfg_entry["file"]).read_text())
    if "family" not in cfg:
        raise Refused(2, f"{cfg_entry['file']} names no family")
    module = families.path(cfg, root)
    if not module.is_file():
        raise Refused(2, f"{cfg_entry['file']} names family {cfg['family']!r}: no module {module}")
    traffic = json.loads((root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, cfg, traffic, bench


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The cell's metric entries: end-to-end without trace, per-layer with."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or workload in m["workloads"]]


def reader(root: Path, name: str):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(root: Path, workload: str, cell: dict, cfg: dict, traffic: dict, metrics: list,
             seed: int, seconds: float, trace: bool, device, control: str | None = None,
             t_start: float = T_START, say=None) -> dict:
    """Set up, serve, measure, free, check.  -> the result object."""
    import torch

    from . import camera as CAM
    from . import compare, harness
    from . import trace as TR
    from .readings import hist_delta, latencies_ms, returns_in

    say = say or (lambda *a: None)
    device = torch.device(device)
    cuda = device.type == "cuda"
    n = traffic["sessions"]
    plan = CAM.session_plan(traffic, seed)
    scenes = compare.scenes_of(traffic, plan)
    checks = compare.plan_checks(cfg, traffic, seed)
    dtype = torch.bfloat16 if cfg["stream"]["dtype"] == "bfloat16" else torch.float32
    family = families.of(cfg)

    say(f"set-up: {time.monotonic() - t_start:.2f} s at the first weight")
    tree = family.make_tree(cfg, seed, device, dtype)
    say(f"set-up: {time.monotonic() - t_start:.2f} s with the weights drawn")
    sched = harness.build(cfg, tree, n, device)
    del tree
    say(f"set-up: {time.monotonic() - t_start:.2f} s with the program built, "
        f"buckets {sorted(sched.graph_status())}")

    def memory(reset=False):
        if not cuda:
            return None
        if reset:
            torch.cuda.reset_peak_memory_stats(device)
            return None
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device))

    profile = None
    if trace and cuda:
        TR.warm_up()
        profile = TR.Profiler()
    try:
        served = harness.serve(sched, cfg, traffic, plan, scenes, compare.keepers(checks, n),
                               seconds, t_start, profile, memory, say)
    finally:
        harness.release(sched)
        del sched
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    window = (served.t0, served.t1)
    say(f"window: {seconds} s after {served.t0 - t_start:.3f} s of set-up")

    # the reference, once the program is freed; TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree = family.make_tree(cfg, seed, device, dtype)
    records = served.records
    if control:  # the reference at the lower precision in the program's place
        ctl = compare.check(cfg, tree, plan, scenes, records, window, checks, device,
                            precision=control)
        records = compare.substitute(records, ctl["refs"])
        say(f"control: the {control} reference's {len(ctl['refs'])} frames in place of the "
            "served ones")
        del ctl
    t_ref = time.monotonic()
    result = compare.check(cfg, tree, plan, scenes, records, window, checks, device)
    say(f"reference: {result['frames']} frames compared in {time.monotonic() - t_ref:.1f} s"
        + (f", gaps median {statistics.median(result['gaps']):.4f}" if result["gaps"] else ""))
    say(f"reference frames: {compare.ref_stats(result['refs'])}")
    del tree
    gc.collect()

    ctx = {"seconds": seconds, "window": window, "setup_s": served.t0 - t_start,
           "records": served.records, "cameras": served.cameras, "counters": served.counters,
           "trace": TR.reduce(profile.records()) if served.trace_host else None,
           "trace_host": served.trace_host, "trace_counters": served.trace_counters,
           "cfg": cfg, "traffic": traffic}
    if ctx["trace"] is not None:
        tr = ctx["trace"]
        say(f"trace: span {tr['window_us'] / 1e6:.3f} s, busy {tr['busy_us'] / 1e6:.3f} s, "
            f"{tr['steps']} steps, {tr['launches']} launches, classes "
            + ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in sorted(tr["by_class_us"].items())))
    values = {}
    for m in metrics:
        v = reader(root, m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    t0, t1 = window
    attempted = sum(1 for rec in served.records for t, _ in rec.submit_spans if t0 <= t <= t1)
    failed = sum(1 for rec in served.records for t, _, _ in rec.failed if t0 <= t <= t1)
    say(f"occupancy in the window: {sorted(hist_delta(*served.counters.values()).items())}; "
        f"frames a session: {[sum(1 for s, _, _ in returns_in(ctx) if s == k) for k in range(n)]}; "
        f"frames a second: {[len(returns_in(ctx, t0 + j, t0 + j + 1))
                             for j in range(int(seconds))]}")
    lat = latencies_ms(ctx)
    late = [x for cam in served.cameras for x in cam.late]
    say(f"frames returned {len(lat)}, latency median {statistics.median(lat):.2f} ms"
        if lat else "frames returned 0")
    if late:
        say(f"camera lateness median {1e3 * statistics.median(late):.3f} ms, "
            f"max {1e3 * max(late):.3f} ms over {len(late)} waits")

    limit = cfg["limits"]["frame_gap_levels"]
    live_limit = cfg["limits"]["live_share"]
    gap, live = result["frame_gap_levels"], result["live_share"]
    correct = bool(gap is not None and limit is not None and gap <= limit
                   and result["frames"] > 0 and live is not None and live >= live_limit)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.get("chips", 1), "memory_peak_bytes": served.memory_peak_bytes}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": values,
           "device": dev}
    if ctx["trace"] is not None:
        dev["busy_s"] = ctx["trace"]["busy_us"] / 1e6
        dev["window_s"] = ctx["trace"]["window_us"] / 1e6
        out["breakdown"] = TR.breakdown(ctx["trace"])
    if control:
        out["control"] = control
    checks_out = {"frame_gap_levels": {"value": gap, "limit": limit},
                  "frames_compared_at_least": {"value": result["frames"], "limit": 1},
                  "live_share_at_least": {"value": live, "limit": live_limit}}
    out["checks"] = checks_out
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8",), default=None)
    args = ap.parse_args(argv)

    def say(*a):
        print(*a, file=sys.stderr, flush=True)

    def on_term(signum, frame):
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, on_term)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True, file=sys.__stderr__)
    try:
        return _main(args, say)
    finally:
        faulthandler.cancel_dump_traceback_later()


def _main(args, say) -> int:
    try:
        cell, cfg, traffic, bench = load_cell(ROOT, args.workload)
        try:
            import torch

            import ai_rtc_agent_tpu_torch  # noqa: F401
        except ImportError as e:
            raise Refused(2, f"cannot import the program under test: {e}") from e
        if not torch.cuda.is_available():
            raise Refused(3, "torch.cuda.is_available() is false: no CUDA card")
        if torch.cuda.device_count() < cell.get("chips", 1):
            raise Refused(3, f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
                             f"{cell.get('chips', 1)}")
        out = run_cell(ROOT, args.workload, cell, cfg, traffic,
                       metrics_of(bench, args.workload, bool(args.trace)), args.seed,
                       args.seconds, bool(args.trace), DEVICE, args.control, say=say)
        found = forbidden_modules()
        if found:
            raise Refused(4, f"loaded in the measuring process: {', '.join(found)}")
    except Refused as e:
        say(f"refused: {e}")
        return e.code
    except SystemExit:
        say("stopped by a signal: no result")
        raise
    except Exception:
        traceback.print_exc()
        say("error: no result")
        return 1
    for name, c in out["checks"].items():
        say(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
