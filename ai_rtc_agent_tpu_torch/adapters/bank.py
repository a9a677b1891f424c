"""Factor-bank tree helpers (counterpart of ai_rtc_agent_tpu/adapters/bank.py).

A factor bank is ``{dotted module path: {"down": [R, in], "up": [out, R]}}``
addressing 2-D linear modules of ``params["unet"]``; a stacked bank has a
leading slot axis, a gathered one a leading row axis.  Dotted paths use the
tree's spelling, int-looking segments indexing lists
("down_blocks.0.attentions.0.blocks.0.attn1.to_q").

:func:`graft_unet_params` puts the factors beside each target kernel
(``lora_down`` / ``lora_up``), and ``models/layers.linear`` applies
``y += (x @ down.T) @ up.T`` (per row when the factors carry a row axis).
``scale·alpha/r`` is folded into ``up`` at load, so zero factors add
exactly 0.0: padded ranks and adapterless slots are bit for bit the base
model.
"""

from __future__ import annotations

import torch


def _path_parts(path: str):
    return [int(p) if p.isdigit() else p for p in path.split(".")]


def graft_unet_params(unet_params, factors):
    """A shallow copy of the UNet tree with each bank entry's (down, up)
    beside its target module's kernel; untouched subtrees are the same
    objects."""
    out = unet_params
    for path, f in factors.items():
        out = _graft_one(out, _path_parts(path), f)
    return out


def _graft_one(node, parts, f):
    if not parts:
        mod = dict(node)
        mod["lora_down"] = f["down"]
        mod["lora_up"] = f["up"]
        return mod
    copy = dict(node) if isinstance(node, dict) else list(node)
    copy[parts[0]] = _graft_one(copy[parts[0]], parts[1:], f)
    return copy


def gather_factor_rows(bank, index: torch.Tensor):
    """The rows ``index`` of a stacked bank ([S, ...] leaves): one gather per
    leaf on the device, so a captured step reads the bank's live contents
    at every replay."""
    return {path: {"down": f["down"].index_select(0, index),
                   "up": f["up"].index_select(0, index)}
            for path, f in bank.items()}


def zero_factor_rows(targets, rank: int, dtype=torch.float32, device="cpu"):
    """An all-zero bank for one session row.  ``targets``: {dotted module
    path: (in_dim, out_dim)}.  Every slot is born with it and a clear writes
    it back: its contribution is exactly 0.0."""
    return {
        path: {
            "down": torch.zeros((rank, dims[0]), dtype=dtype, device=device),
            "up": torch.zeros((dims[1], rank), dtype=dtype, device=device),
        }
        for path, dims in targets.items()
    }
