"""Hardware fingerprint for measurement records — the port's copy of
ai_rtc_agent_tpu/utils/hwfp.py, with the card's identity in place of the
JAX backend's.

A number is only worth what the record says about the hardware that made
it, so every measurement the port prints or banks carries the same dict,
from this one helper:

    {"host_cpus": 8, "machine": "x86_64", "python": "3.12.3",
     "backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
     "device_count": 1, "card": "NVIDIA H100 80GB HBM3, 700.00 W",
     "power_limit": "700.00 W", "torch": "2.11.0+cu128", "cuda": "12.8"}

``card`` is the first line of ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``, as printed; ``power_limit`` its second field.

``probe_device=False`` keeps the card out of the picture for pure-host
measurements; they fingerprint the host and say so with ``backend:
"unprobed"``.  A probe that finds no card (or whose ``nvidia-smi`` fails)
records ``backend: "unavailable"`` and the error: the helper only records,
and a caller that needs the card checks ``backend == "cuda"`` and stops.
"""

from __future__ import annotations

import os
import platform
import subprocess

NVIDIA_SMI = ("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")


def card_line() -> str:
    """The first line ``nvidia-smi`` prints for the card's name and power
    limit; raises when it fails or prints nothing."""
    smi = subprocess.run(NVIDIA_SMI, capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not line:
        raise RuntimeError(f"nvidia-smi failed (rc={smi.returncode}): {smi.stderr.strip()}")
    return line


def fingerprint(probe_device: bool = True) -> dict:
    """The hardware identity dict every measurement record carries."""
    fp = {
        "host_cpus": os.cpu_count() or 1,
        "machine": platform.machine(),
        "python": platform.python_version(),
    }
    if not probe_device:
        fp["backend"] = "unprobed"
        return fp
    try:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is false: no CUDA device answered")
        card = card_line()
        fp.update(
            backend="cuda",
            device_kind=torch.cuda.get_device_name(0),
            device_count=torch.cuda.device_count(),
            card=card,
            power_limit=card.rpartition(",")[2].strip(),
            torch=torch.__version__,
            cuda=torch.version.cuda,
        )
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        # no card, or its tools failing, IS a fingerprint fact
        fp["backend"] = "unavailable"
        fp["error"] = f"{type(e).__name__}: {e}"
    return fp
