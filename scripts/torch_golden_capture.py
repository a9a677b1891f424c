#!/usr/bin/env python
"""Capture the port's golden output fingerprint (ai_rtc_agent_tpu_torch/utils/golden.py).

    python scripts/torch_golden_capture.py --model-id tiny-test --device cpu
    python scripts/torch_golden_capture.py --model-id stabilityai/sd-turbo

writes tests/golden_torch/<model>.json (``--out`` elsewhere); a later run on
any device compares against it with ``golden.compare``.  A real family needs
its safetensors locally (a snapshot under HF_HUB_CACHE); the tiny families
are hermetic.  Prints exactly one JSON line on every exit path, SIGTERM
included, and exits non-zero unless the capture was written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-id", default="stabilityai/sd-turbo")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    out = args.out or os.path.join(REPO, "tests", "golden_torch",
                                   args.model_id.replace("/", "--") + ".json")
    result = {"ok": False, "check": "torch_golden_capture", "model_id": args.model_id}
    try:
        from ai_rtc_agent_tpu_torch.utils.contract import sigterm_to_exception

        sigterm_to_exception("timeout")
        from ai_rtc_agent_tpu_torch.utils import golden, hwfp

        cap = golden.capture(args.model_id, device=args.device)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        golden.save(cap, out)
        result.update(ok=True, path=out, fingerprint_stats={
            "mean": cap["fingerprint"]["mean"], "std": cap["fingerprint"]["std"],
        })
        result["hardware"] = hwfp.fingerprint(probe_device=args.device != "cpu")
    except BaseException as e:  # noqa: BLE001 -- the contract line reports every failure
        result["error"] = f"{type(e).__name__}: {e}"
    finally:
        print(json.dumps(result))
        sys.stdout.flush()
    sys.exit(0 if result["ok"] else 1)


if __name__ == "__main__":
    main()
