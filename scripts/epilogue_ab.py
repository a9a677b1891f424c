#!/usr/bin/env python3
"""The fused stream epilogue of one checkout of the port, timed on the card.

    python3 scripts/epilogue_ab.py [--root DIR]

Imports ``ai_rtc_agent_tpu_torch`` from the checkout at ``--root`` (default:
this one) and times its epilogue as that checkout's engine calls it after
the UNet, on the main path (sd-turbo: turbo, cfg none, B=1) and on the
4-stage LCM stream batch (cfg self, B=4), [B,64,64,4] bf16 with the inputs
of ``chip_smoke.epilogue_call``.  For each it prints, in one JSON line:

* ``kernel_ms``: device time of the wrapper call alone (its inputs built
  beforehand), ``chip_smoke.time_ms``;
* ``chain_ms``: device time of the whole post-UNet chain as the engine runs
  it: the wrapper plus whatever glue the checkout's step launches around it;
* ``host_us`` / ``chain_host_us``: host time per call of the wrapper (1,000
  calls) / the chain (CHAIN_CALLS, so that a chain of several launches does
  not fill the launch queue), ``chip_smoke.host_us_per_call``, each with its
  ``*_held`` flag (the device slept through the reading);
* ``floor_ms``: an empty kernel on the epilogue's grid, where the checkout's
  library has one (null otherwise).

A checkout whose wrapper lacks the ``noise_shift`` keyword is one from before
the epilogue carried the chain: its engine built the turbo coefficients
and the shifted noise itself and copied the advanced rows and the stock
back, and the script does the same.  Compare two checkouts inside one
call on one card, in turns (A, B, B, A), each run its own process.  Needs
one NVIDIA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the card's timing helpers; stdlib imports only)

CHAIN_CALLS = 150  # x up to 6 launches a chain: under the launch queue's depth


def engine_chain(torch, KF, args, kwargs):
    """(wrapper call, post-UNet chain) as this checkout's engine runs them."""
    x, e, s, noise, c, g, d = args
    if "noise_shift" in inspect.signature(KF.fused_stream_epilogue).parameters:
        call = lambda: KF.fused_stream_epilogue(*args, **kwargs)
        return call, call
    from dataclasses import replace

    cfg_type, turbo, shift = kwargs["cfg_type"], kwargs["turbo"], kwargs["noise_shift"]
    x_buf, B = kwargs["advanced_out"], x.shape[0]

    def glue():
        kc = c
        if turbo:
            kc = replace(c, c_skip=torch.zeros_like(c.c_skip), c_out=torch.ones_like(c.c_out))
        noise_next = (torch.cat([noise[shift:], torch.zeros_like(noise[:shift])])
                      if B > shift else torch.zeros_like(noise))
        return kc, noise_next

    kc, noise_next = glue()
    call = lambda: KF.fused_stream_epilogue(x, e, s, noise_next, kc, g, d, cfg_type=cfg_type)

    def chain():
        kc, noise_next = glue()
        _, adv, new_stock = KF.fused_stream_epilogue(x, e, s, noise_next, kc, g, d,
                                                     cfg_type=cfg_type)
        if B > shift:
            x_buf.copy_(adv[: B - shift])
        if new_stock is not s:
            s.copy_(new_stock)

    return call, chain


def card_fingerprint() -> dict:
    """This checkout's ``utils/hwfp.fingerprint``, taken before ``--root``'s
    package goes on the path (that checkout may predate the helper).  The
    port's modules imported for it then leave ``sys.modules``, so the
    package loads whole from ``--root``."""
    from ai_rtc_agent_tpu_torch.utils import hwfp

    fp = hwfp.fingerprint()
    for name in [m for m in sys.modules if m.split(".")[0] == "ai_rtc_agent_tpu_torch"]:
        del sys.modules[name]
    return fp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO), help="root of the checkout to time")
    args = ap.parse_args()

    import torch

    fp = card_fingerprint()
    if fp["backend"] != "cuda":
        print(f"FAIL: needs an NVIDIA card: {fp.get('error')}", flush=True)
        sys.exit(1)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from ai_rtc_agent_tpu_torch.ops.kernels import fused_scheduler as KF

    if not Path(KF.__file__).resolve().is_relative_to(root):
        print(f"FAIL: imported {KF.__file__}, not from {root}", flush=True)
        sys.exit(1)
    card = fp["card"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = {}
    for cfg_type in ("none", "self"):
        call_args, kwargs = chip_smoke.epilogue_call(torch, cfg_type, gen)
        call, chain = engine_chain(torch, KF, call_args, kwargs)
        B, n = call_args[0].shape[0], call_args[0][0].numel()
        floor = None
        if hasattr(KF, "launch_empty"):
            floor = chip_smoke.time_ms(torch, lambda: KF.launch_empty(B, n), 200)
        host_us, held = chip_smoke.host_us_per_call(torch, call)
        chain_host_us, chain_held = chip_smoke.host_us_per_call(torch, chain, CHAIN_CALLS)
        cases[f"{cfg_type}_B{B}"] = {
            "kernel_ms": chip_smoke.time_ms(torch, call, 200),
            "chain_ms": chip_smoke.time_ms(torch, chain, 100),
            "floor_ms": floor,
            "host_us": host_us,
            "host_held": held,
            "chain_host_us": chain_host_us,
            "chain_host_held": chain_held,
        }
    print(json.dumps({
        "metric": "epilogue_ab",
        "root": str(root),
        "module": str(Path(KF.__file__).resolve().relative_to(root)),
        "card": card,
        "device": fp["device_kind"],
        "cases": cases,
    }), flush=True)


if __name__ == "__main__":
    main()
