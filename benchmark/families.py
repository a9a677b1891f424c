"""Where the harness finds a configuration's model: its family module.

A configuration file names its family (``"family": "sd_unet"``), and
``benchmark/reference/<family>.py`` holds every step of the harness that
depends on the model.  A family module exposes exactly these names:

* ``make_tree(cfg, seed, device, dtype)``: the weights, drawn on the device
  from the seed, in the tree layout the program's model bundle takes as
  ``params=``; the same seed gives the same tree, bit for bit;
* ``Reference(cfg, tree, device, precision)``: the plain reference of one
  session's served stream over that tree, at ``precision`` "f32" (the
  reference) or "fp8" (the control), with ``start(prompt, seed)`` -> a
  session's first state and ``step(states, frames, decode)`` -> per session
  an [H, W, 3] uint8 frame, or None where ``decode`` says it is not wanted;
* ``stateless(stream)``: whether a stream of these ``stream`` settings
  depends on the current frame alone (its frames are checked by sample) or
  carries state from frame to frame (a session is replayed whole);
* ``attention_shapes(cfg, rows)``: (B, Lq, Lk, H, D) of every attention
  launch of one model pass over ``rows`` latent rows;
* ``frame_flops(cfg)``: the operations of one served frame, counted by
  ``torch.utils.flop_counter`` over the family's reference on the meta
  device.

A family module imports nothing of the program under test, nor JAX.  The
program's side of a family is the port's model registry (``model_id``),
and that program must launch the fused stream epilogue (trace.STEP_MARKER)
once a bucket step, or every per-step metric reads None.  What stays the
same for every family: the traffic, the cameras and the track seam
(camera.py, harness.py), the stream settings handed to the program
(harness.stream_config), the rule that decides ``correct`` (compare.py:
``frame_gap_levels`` against the configuration's ``limits``), and every
metric reader.

So a new architecture comes as new files alone: its family module (with
whatever reference modules it needs) under ``benchmark/reference/``, its
configuration under ``benchmark/configs/``, its traffic under
``benchmark/traffic/``, and its entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]  # the checkout this harness runs from
_loaded: dict = {}  # family module path -> the module


def path(cfg: dict, root: Path | None = None) -> Path:
    """The file of the family that ``cfg`` names, under ``root``'s benchmark."""
    return (root or ROOT) / "benchmark" / "reference" / f"{cfg['family']}.py"


def of(cfg: dict):
    """The family module of ``cfg``, loaded by file once."""
    where = path(cfg)
    mod = _loaded.get(where)
    if mod is None:
        spec = importlib.util.spec_from_file_location(f"benchmark.reference.{cfg['family']}",
                                                      where)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod  # where a dataclass looks up its module's names
        spec.loader.exec_module(mod)
        _loaded[where] = mod
    return mod
