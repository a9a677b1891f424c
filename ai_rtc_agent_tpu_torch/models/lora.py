"""Offline LoRA fusion (LCM-LoRA and style LoRAs) — the port's copy of
ai_rtc_agent_tpu/models/lora.py.

Fused weights keep the served step as it is: a LoRA costs no work per
frame.  Math, in the torch convention W'[o,i] = W[o,i] + scale * (alpha/r)
* up[o,r] @ down[r,i].  The port's layouts (models/loader.py): linear
kernels are [in, out], so the delta lands as ``down.T @ up.T``; conv
kernels are OIHW, so it lands as ``einsum("or,rihw->oihw", up, down)``,
with a tapless ([r, in]) down factor on a kxk conv placed on the centre
tap.

The fusion runs in f32 on the host (numpy), on kernels still in f32, before
the bundle is cast to the compute dtype, as the JAX bundle orders it: a
fusion after the bf16 cast gives other weights.
"""

from __future__ import annotations

import logging
import re
from typing import Mapping

import numpy as np
import torch

logger = logging.getLogger(__name__)


def lora_delta(shape, down, up) -> np.ndarray:
    """The f32 update ``up @ down`` in the port's layout of a kernel of
    ``shape`` ([in, out] or OIHW), before its scale.  ``down``: torch
    layout [r, in] (or [r, in, kh, kw]); ``up``: [out, r] (or [out, r, 1, 1])."""
    down = np.asarray(down, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    r = down.shape[0]
    if len(shape) == 2:
        return down.reshape(r, -1).T @ up.reshape(-1, r).T
    if len(shape) == 4:
        cout, cin, kh, kw = shape
        d = down.reshape(r, cin, kh, kw) if down.ndim == 4 else down.reshape(r, cin, 1, 1)
        if d.shape[2:] != (kh, kw):  # a tapless down on a kxk conv: the centre tap
            dd = np.zeros((r, cin, kh, kw), np.float32)
            dd[:, :, kh // 2, kw // 2] = d[:, :, 0, 0]
            d = dd
        return np.einsum("or,rihw->oihw", up.reshape(cout, r), d)
    raise ValueError(f"unsupported kernel rank {len(shape)}")


def fuse_lora_delta(kernel: torch.Tensor, down, up, scale: float,
                    alpha: float | None = None) -> torch.Tensor:
    """One LoRA pair fused into one kernel leaf: a new tensor on the
    kernel's device in its dtype, the sum taken in f32 on the host."""
    r = np.asarray(down).shape[0]
    s = float(scale) * (float(alpha) / r if alpha is not None else 1.0)
    k = kernel.detach().float().cpu().numpy()
    fused = k + s * lora_delta(k.shape, down, up)
    return torch.from_numpy(fused).to(device=kernel.device, dtype=kernel.dtype)


_KOHYA_RE = re.compile(
    r"^lora_(unet|te|text_encoder)_(.+)\.(lora_down|lora_up|alpha)(?:\.weight)?$")


def parse_lora_state_dict(sd: Mapping[str, np.ndarray]) -> dict:
    """Group a kohya or diffusers (peft) LoRA state dict into
    ``{module path: {"down": A, "up": B, "alpha": a}}``; kohya paths keep
    their underscores (matching is underscore-normalised, see
    :func:`resolve_lora_target`).  Groups without both factors are dropped."""
    groups: dict[str, dict] = {}
    for key, val in sd.items():
        m = _KOHYA_RE.match(key)
        if m:
            tower, path, part = m.groups()
            path = f"{tower}.{path}"
        elif ".lora_A" in key or ".lora_B" in key:
            path, part_raw = key.rsplit(".lora_", 1)
            part = "lora_down" if part_raw.startswith("A") else "lora_up"
        elif key.endswith(".alpha"):
            path, part = key[: -len(".alpha")], "alpha"
        else:
            continue
        g = groups.setdefault(path, {})
        if part == "alpha":
            g["alpha"] = float(np.asarray(val).reshape(()))
        elif part == "lora_down":
            g["down"] = np.asarray(val)
        else:
            g["up"] = np.asarray(val)
    return {k: v for k, v in groups.items() if "down" in v and "up" in v}


def _underscore_map(key_map) -> dict:
    return {k[: -len(".weight")].replace(".", "_"): v
            for k, v in key_map.items() if k.endswith(".weight")}


def resolve_lora_target(path: str, key_map, u_map=None):
    """One parsed LoRA module path -> the tree path of its kernel, or None.
    Takes the diffusers dotted spelling and the kohya underscored one
    (module names hold underscores themselves, so the match is made with
    every dot turned into an underscore)."""
    if u_map is None:
        u_map = _underscore_map(key_map)
    mod = path.split(".", 1)[1] if path.startswith(("unet.", "te.", "text_encoder.")) else path
    return key_map.get(mod + ".weight") or u_map.get(mod.replace(".", "_"))


def fuse_lora_into_unet(params, lora_groups: dict, key_map: dict, scale: float = 1.0):
    """Fuse parsed LoRA groups into a UNet tree.  ``key_map``: the weight
    key map (models/loader.py ``unet_key_map``); a LoRA path names the same
    module as a weight key without its ``.weight``.

    Returns ``(params, applied, unmatched)``: a new tree (leaves not fused
    are shared with the input), the groups fused, and the module paths that
    matched nothing, which are warned about loudly here (a partly fused
    style is a wrong style).  Whether ``applied == 0`` is fatal is the call
    site's decision (models/registry.py raises)."""
    u_map = _underscore_map(key_map)
    applied, unmatched = 0, []
    for path, g in lora_groups.items():
        target = resolve_lora_target(path, key_map, u_map)
        if target is None:
            unmatched.append(path)
            continue
        params = _replace_leaf(
            params, target,
            lambda k, g=g: fuse_lora_delta(k, g["down"], g["up"], scale, g.get("alpha")))
        applied += 1
    if unmatched:
        logger.warning(
            "LoRA fuse: %d/%d module paths matched nothing in this UNet and were DROPPED — "
            "the fused style is partial. First unmatched: %s",
            len(unmatched), len(lora_groups), unmatched[:5])
    return params, applied, unmatched


def _replace_leaf(tree, path, fn):
    """A copy of ``tree`` along ``path`` (the rest shared) with ``fn`` applied
    to the leaf at its end."""
    node = dict(tree) if isinstance(tree, dict) else list(tree)
    node[path[0]] = fn(node[path[0]]) if len(path) == 1 else _replace_leaf(
        node[path[0]], path[1:], fn)
    return node
