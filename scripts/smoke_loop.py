#!/usr/bin/env python3
"""Phases of ``chip_smoke.py`` over and over in one process on the card, to
find a check that fails only now and then.

    python3 scripts/smoke_loop.py [--loops N] [--phases faults,native,obs,fleet]
                                  [--once faults] [--busy N] [--no-trace]
                                  [--no-world] [--native-stack]
                                  [--amplify]

Phases 1 and 2 run once (the card, the kernels' build), and phases 4 and 5
too (the pipeline; phase 5 for phase 8's served rate) when a chosen phase
runs on them; then each loop runs the chosen phases in turn: ``faults`` (7),
``native`` (8), ``obs`` (9), ``fleet`` (10), ``adapters`` (15), ``mesh``
(18), or ``sdxl`` (16) and ``preflight`` (19), which build their own models:
``--loops 1 --phases sdxl`` runs phase 16 alone after the build, ``--loops 1
--phases preflight`` phase 19, ``--loops 1 --phases mesh``
phase 18 on phase 4's pipeline, ``--loops 3 --once adapters --phases
adapters,mesh`` phase 18 after phase 15, as the script runs it: there a
profiler window over 18b's replays faulted inside CUPTI before the
captured graphs kept their source graphs (ROADMAP §C.16, repaired).
``--no-trace`` runs phase 18 without 18b's device traces; ``--no-world``
without its NCCL world of 1 (and without 18d, which needs it);
``--native-stack`` builds scripts/native_stack.c with ``cc`` and prints the
native frames of a segfault before faulthandler's Python stacks;
``--amplify`` runs a full garbage collection and a device sync just before
every profiler window of ``chip_smoke.kernel_trace`` opens, printing the
live graph caches before and after it: without the repair that made the
fault near certain.  A failed check prints its
``FAIL:`` line and the loop goes on with the next phase.  ``--once`` names
phases run in the first loop only; ``--busy N`` keeps N host processes
spinning throughout the loops, as a host shared with other work would.  The
last line is the JSON list of failures, ``[loop, phase, message]``; the exit
code is 1 if there was any.  Needs one NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


# the phases that run on phase 4's pipeline
ON_THE_PIPELINE = {"faults", "native", "obs", "fleet", "adapters", "mesh"}


class CheckFailed(Exception):
    pass


def native_stack():
    """Build scripts/native_stack.c into build/ and install its handler over
    faulthandler's (which it hands the signal on to)."""
    import ctypes

    out = ROOT / "build" / "native_stack.so"
    out.parent.mkdir(exist_ok=True)
    subprocess.run(["cc", "-shared", "-fPIC", "-O1", "-o", str(out),
                    str(ROOT / "scripts" / "native_stack.c")], check=True)
    ctypes.CDLL(str(out)).native_stack_install()


def collect_before_windows(torch, cs):
    """Wrap ``cs.kernel_trace`` so that a full collection and a device sync
    run just before its window opens, printing the live graph caches
    around the collection."""
    import gc

    from ai_rtc_agent_tpu_torch.aot import cache

    trace = cs.kernel_trace

    def kernel_trace(torch_, fn, classes: bool = False) -> dict:
        live = len(cache._LIVE)
        found = gc.collect()
        torch.cuda.synchronize()
        print(f"amplify: {found} objects collected, graph caches live "
              f"{live} -> {len(cache._LIVE)}", flush=True)
        return trace(torch_, fn, classes)

    cs.kernel_trace = kernel_trace


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loops", type=int, default=5)
    ap.add_argument("--phases", default="faults,native,obs,fleet")
    ap.add_argument("--once", default="", help="phases run in the first loop only")
    ap.add_argument("--busy", type=int, default=0, help="host processes kept spinning")
    ap.add_argument("--no-trace", action="store_true", help="phase 18 without its device traces")
    ap.add_argument("--no-world", action="store_true", help="phase 18 without its NCCL world")
    ap.add_argument("--native-stack", action="store_true",
                    help="print a segfault's native frames (scripts/native_stack.c)")
    ap.add_argument("--amplify", action="store_true",
                    help="collect garbage and sync the card just before every profiler window")
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    import faulthandler

    import torch

    import chip_smoke as cs

    faulthandler.enable(all_threads=True)  # a crash in native code prints every thread's stack
    if args.native_stack:
        native_stack()

    def fail(msg: str):
        print(f"FAIL: {msg}", flush=True)
        raise CheckFailed(msg)

    cs.fail = fail
    if args.amplify:
        collect_before_windows(torch, cs)
    phases = [p for p in args.phases.split(",") if p]
    once = {p for p in args.once.split(",") if p}
    card = cs.phase_device(torch)
    cs.phase_build(torch)
    pipe = ref_bundle = fps = None
    if ON_THE_PIPELINE & set(phases):
        pipe, ref_bundle, _, _ = cs.phase_main(torch, card)
    if "native" in phases:
        _, _, fps = cs.phase_serve(torch, card, pipe)
    run = {
        "faults": lambda: cs.phase_faults(torch, card, pipe, ref_bundle),
        "native": lambda: cs.phase_native(torch, card, pipe, fps),
        "obs": lambda: cs.phase_obs(torch, card, pipe),
        "fleet": lambda: cs.phase_fleet(torch, card, pipe, ref_bundle),
        "adapters": lambda: cs.phase_adapters(torch, card, pipe, ref_bundle),
        "sdxl": lambda: cs.phase_sdxl(torch, card),
        "preflight": lambda: cs.phase_preflight(torch, card),
        "mesh": lambda: cs.phase_mesh(torch, card, pipe, ref_bundle, traced=not args.no_trace,
                                      world=not args.no_world),
    }
    unknown = [p for p in phases + sorted(once) if p not in run]
    if unknown:
        ap.error(f"unknown phase(s) {unknown}; known: {sorted(run)}")
    busy = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(args.busy)]
    failures = []
    try:
        for i in range(args.loops):
            for name in phases:
                if name in once and i > 0:
                    continue
                t = time.perf_counter()
                try:
                    run[name]()
                    verdict = "ok"
                except CheckFailed as e:
                    failures.append([i, name, str(e)])
                    verdict = "FAILED"
                except Exception as e:  # noqa: BLE001 - recorded, and the loop goes on
                    traceback.print_exc()
                    failures.append([i, name, repr(e)])
                    verdict = "RAISED"
                print(f"loop {i} {name} {verdict} in {time.perf_counter() - t:.1f} s", flush=True)
    finally:
        for p in busy:
            p.kill()
            p.wait()
    print(json.dumps(failures), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
