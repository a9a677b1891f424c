"""Per-session style adapters: LoRA as a batch axis (counterpart of
ai_rtc_agent_tpu/adapters/).

An offline-fused LoRA (``load_model_bundle(lora_dict=...)``) bakes one
style into the weights, so every style would need an engine of its own.
Here the base weights stay shared and each session's low-rank factors ride
the scheduler's stacked ``[S, ...]`` state instead:

* :class:`~.registry.AdapterRegistry` loads kohya/peft LoRA files through
  ``models/lora.py``'s parser, resolves them against
  ``models/loader.unet_key_map``, keeps the 2-D UNet linears (conv and
  text-encoder groups are dropped with a warning), folds ``scale·alpha/r``
  into the up factor and zero-pads each adapter to the smallest rank
  bucket that holds it, so every adapter of a deployment has one bank
  shape.
* :func:`~.bank.graft_unet_params` puts a bank's (down, up) factors beside
  each target ``kernel``, and ``models/layers.linear`` adds
  ``(x @ down.T) @ up.T``; in the session step each row meets its own
  session's factors, gathered from the stacked bank on the device, so one
  captured bucket step serves sessions of different styles, and a zero row
  adds exactly 0.0.

Join, leave and hot-swap are in-place writes of one shape into the bank,
so the captured graphs read the live factors at every replay and nothing
is captured again.
"""

from .bank import gather_factor_rows, graft_unet_params, zero_factor_rows
from .registry import DEFAULT_RANK_BUCKETS, AdapterRegistry, build_registry, targets_digest

__all__ = [
    "AdapterRegistry",
    "DEFAULT_RANK_BUCKETS",
    "build_registry",
    "gather_factor_rows",
    "graft_unet_params",
    "targets_digest",
    "zero_factor_rows",
]
