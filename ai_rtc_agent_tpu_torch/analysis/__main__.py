"""Run the port's invariant analyzer over the port package.

    python -m ai_rtc_agent_tpu_torch.analysis                 # full scan, text report
    python -m ai_rtc_agent_tpu_torch.analysis --format json   # machine-readable
    python -m ai_rtc_agent_tpu_torch.analysis --changed       # git-changed files only
    python -m ai_rtc_agent_tpu_torch.analysis --update-baseline

Exit codes: 0 clean, 1 findings (or baseline violations), 2 usage/internal.

The baseline (``baseline.json`` beside this file) may only SHRINK: a finding
not listed there fails the run, and a listed finding that no longer fires
must be removed (``--update-baseline`` does it; it refuses to *add* entries
and refuses a partial scan).  It ships empty — keep it that way: fix a
finding, or suppress it inline with a reason.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from .core import PORT, REGISTRY_CHECKERS, ALL_CHECKERS, load_project, run_checkers

REPO_ROOT = Path(__file__).resolve().parents[2]
BASELINE_PATH = Path(__file__).resolve().parent / "baseline.json"


def load_baseline(path: Path) -> set:
    if not path.exists():
        return set()
    return set(json.loads(path.read_text()).get("findings", []))


def changed_files(root: Path) -> list:
    """Tracked-modified + staged + untracked .py files under the scan roots
    (the pre-commit scope)."""
    out = subprocess.run(
        # -uall: expand untracked DIRECTORIES to their files (a plain listing
        # compacts a new package to one "?? dir/" row)
        ["git", "-C", str(root), "status", "--porcelain", "-uall"],
        capture_output=True, text=True, check=True,
    ).stdout
    files = []
    top = {r.split("/")[0] for r in PORT.roots}
    for line in out.splitlines():
        rel = line[3:].split(" -> ")[-1].strip().strip('"')
        if not rel.endswith(".py"):
            continue
        if rel.split("/")[0] not in top and rel not in PORT.roots:
            continue
        p = root / rel
        if p.exists():
            files.append(str(p))
    return files


def classify(findings, baseline: set):
    """-> (new findings, stale baseline keys)."""
    current = {f.key() for f in findings}
    new = [f for f in findings if f.key() not in baseline]
    stale = sorted(baseline - current)
    return new, stale


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ai_rtc_agent_tpu_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--changed", action="store_true",
                    help="scan only git-changed files (baseline still applies; "
                    "cross-file registry rules see a partial world, so they are skipped)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to the current findings; refuses to grow it")
    ap.add_argument("--baseline", default=str(BASELINE_PATH))
    ap.add_argument("--root", default=str(REPO_ROOT),
                    help="repo root to scan (default: this checkout)")
    ap.add_argument("paths", nargs="*", help="explicit files (overrides the default roots)")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()

    baseline_path = Path(args.baseline)
    baseline = load_baseline(baseline_path)

    checkers = None
    files = None
    if args.paths:
        files = args.paths
    elif args.changed:
        files = changed_files(root)
        if not files:
            print("analysis: no changed files")
            return 0
    if files is not None:
        # a partial scan set cannot prove registry completeness (unread knobs,
        # metric collisions, undocumented routes live across files)
        checkers = tuple(c for c in ALL_CHECKERS if c not in REGISTRY_CHECKERS)

    project, parse_errors = load_project(root, roots=PORT.roots, files=files)
    findings = list(parse_errors) + run_checkers(project, checkers)
    new, stale = classify(findings, baseline)
    if args.changed:
        stale = []  # a partial scan cannot prove a baseline entry is gone

    if args.update_baseline:
        if files is not None:
            # a partial scan can't see findings in unscanned files: rewriting
            # from it would drop their entries, which the shrink-only rule
            # then forbids putting back
            print("--update-baseline requires a full scan (drop --changed / "
                  "explicit paths)", file=sys.stderr)
            return 2
        if new:
            print("refusing to grow the baseline; fix or suppress (with a "
                  "reason) these findings:", file=sys.stderr)
            for f in new:
                print("  " + f.render(), file=sys.stderr)
            return 1
        baseline_path.write_text(json.dumps(
            {"findings": sorted(f.key() for f in findings)}, indent=2
        ) + "\n")
        print(f"baseline written: {len(findings)} entr"
              f"{'y' if len(findings) == 1 else 'ies'}")
        return 0

    if args.format == "json":
        print(json.dumps({
            "findings": [vars(f) | {"key": f.key()} for f in findings],
            "new": [f.key() for f in new],
            "stale_baseline": stale,
            "scanned_files": len(project.modules),
        }, indent=2))
    else:
        for f in findings:
            marker = "" if f.key() in baseline else " [NEW]"
            print(f.render() + marker)
        if stale:
            print("\nbaseline entries that no longer fire (the baseline must "
                  "only shrink — run --update-baseline):")
            for k in stale:
                print("  " + k)
        print(f"\nanalysis: {len(project.modules)} files, {len(findings)} "
              f"finding(s), {len(new)} new, {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'}")
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        sys.exit(2)
