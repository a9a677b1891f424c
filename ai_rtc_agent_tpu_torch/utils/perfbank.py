"""PERF_LOG.jsonl banking and the paired-ratio estimator for the port's
measurement scripts — the port's copy of ai_rtc_agent_tpu/utils/perfbank.py.

Semantics (the JAX module's, unchanged):
* ``PERF_LOG_PATH`` unset -> append to the repo's ``PERF_LOG.jsonl``;
* ``PERF_LOG_PATH`` set EMPTY (or to os.devnull) -> banking DISABLED, so a
  harness that appends and commits its own labelled line is the only writer;
* an OSError never raises: the contract line must still print, the
  failure is recorded on the entry as ``bank_error``.
"""

from __future__ import annotations

import json
import os

from . import env

#: repo root (this file lives at <repo>/ai_rtc_agent_tpu_torch/utils/)
_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def bank(entry: dict, repo_root: str | None = None) -> None:
    """Append one contract line to the banked trajectory (see module
    docstring for the PERF_LOG_PATH semantics)."""
    default = os.path.join(repo_root or _REPO, "PERF_LOG.jsonl")
    path = env.perf_log_path(default)
    if not path or path == os.devnull:
        return
    try:
        with open(path, "a") as f:
            f.write(json.dumps(entry) + "\n")
    except OSError as e:
        entry["bank_error"] = str(e)


def paired(leg_a, leg_b, reps: int):
    """Alternating paired reps: run both legs adjacently ``reps`` times,
    swapping order each pair, and take the MEDIAN of per-pair a/b ratios.
    Two short legs measured back to back see the same machine state (the
    same clocks, the same neighbours), so the median paired ratio converges
    where absolute times drift between calls: the ABBA discipline.
    -> (min_a, min_b, median a/b)."""
    a_vals, b_vals, ratios = [], [], []
    for i in range(reps):
        if i % 2 == 0:
            a, b = leg_a(), leg_b()
        else:
            b, a = leg_b(), leg_a()
        a_vals.append(a)
        b_vals.append(b)
        ratios.append(a / b if b > 0 else 0.0)
    ratios.sort()
    return min(a_vals), min(b_vals), ratios[len(ratios) // 2]
