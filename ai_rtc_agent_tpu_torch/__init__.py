"""ai_rtc_agent_tpu_torch — the PyTorch/CUDA port of ai_rtc_agent_tpu.

The JAX package beside it stays the reference; this package mirrors its
layout so each module has an obvious counterpart:

  ops/       numerics: noise schedules, LCM/Turbo step math, R-CFG, uint8
             image io, and ops/kernels/ (the hand-written Hopper kernels,
             each beside its plain PyTorch version).
  models/    UNet, TAESD, CLIP text tower, tokenizer, registry (a local
             HF snapshot through loader.py's key maps, LoRA fused at load
             by lora.py; random init at full architecture without one),
             and the safety checker (safety.py over clip_vision.py).
  stream/    the stream-batch engine and the pipeline façade.
  aot/       engine keys (the JAX recipe) and the captured steps: one
             CUDA graph per engine and per bucket size.
  bridge.py  carries a JAX param tree / prepared stream state across
             (numpy in, torch out) for the parity tests.
  csrc/      CUDA C++ kernel sources, compiled with nvcc at first use.

The package imports torch and nothing of JAX or of ai_rtc_agent_tpu.
Entry points run on the card ("cuda") unless the caller passes
``device="cpu"``; without a card they raise instead of carrying on.
"""

import torch

__version__ = "0.1.0+torch"  # the version part of every engine key (aot/cache.py)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and no
    card is present — the port never falls back to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
