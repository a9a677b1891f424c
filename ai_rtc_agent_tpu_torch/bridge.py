"""Carry a JAX param tree and a prepared stream state across to the port.

Inputs are plain numpy trees (``jax.tree.map(np.asarray, tree)`` on the
JAX side), so this module needs no JAX.

* ``params_from_jax``: the rule is by rank.  Every 4-D leaf but one is a
  conv kernel in these trees (the UNet's, the ControlNet's zero convs and
  cond embedding, HED's, TAESD's, the safety checker's patch embedding)
  and goes HWIO -> OIHW.  The one exception is HED's ``norm``, a 4-D leaf
  [1,1,1,3] that is no kernel but the input bias the NHWC image broadcasts
  against: a leaf named ``norm`` crosses as it is (everywhere else
  ``norm`` names a dict of scale and bias).  Every other leaf crosses as
  it is: linear kernels keep the JAX [in, out] layout, because the port
  applies them as ``x @ w`` (models/layers.linear), and 2-D leaves that
  are no kernel (embedding tables, the safety checker's ``concept_embeds``
  and ``special_care_embeds``) must not be transposed either.
* ``state_from_jax``: ``jax.random`` and ``torch.Generator`` never draw the
  same noise, so a parity test hands the JAX engine's prepared state
  (noise, x_buf, stock, cond/uncond, coeffs, guidance, delta; SDXL's
  ``added_text`` and f32 ``added_time_ids``) to the port.  Every tree
  crosses whole: SDXL's second text tower ``clip2`` (its 2-D
  ``text_projection`` kernel kept [in, out]) and the UNet's
  ``add_embedding`` need no rule of their own.
* ``train_state_from_jax``: a JAX trainer state ({"params", "opt",
  "step"}) as the port's trainer holds it ({"params", "opt": {"count",
  "mu", "nu"}, "step"}).  optax's ``ScaleByAdamState`` is found by its
  fields inside the ``clip_by_global_norm`` -> ``adamw`` chain's tuple of
  states; its moments cross as params do.
* ``states_from_jax``: the same for a stacked ``[S, ...]`` state (a JAX
  ``BatchScheduler.states`` or ``MultiPeerEngine.states``), written into
  the port's stacked state slot for slot, in place.
"""

from __future__ import annotations

import numpy as np
import torch

from .tree import tree_map


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree, device="cpu") -> dict:
    def leaf(a):
        a = np.asarray(a)
        if a.ndim == 4:
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        return _tensor(a, device)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if node is None:
            return None
        return _tensor(node, device) if key == "norm" else leaf(node)

    return walk(tree)


def state_from_jax(state, device="cpu") -> dict:
    return tree_map(lambda a: _tensor(a, device), state)


def _adam_state(node):
    """optax's ScaleByAdamState (a NamedTuple of count, mu, nu) in a tree
    of tuples, or None."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        return node
    if isinstance(node, (list, tuple)):
        for v in node:
            found = _adam_state(v)
            if found is not None:
                return found
    return None


def train_state_from_jax(state, device="cpu") -> dict:
    adam = _adam_state(state["opt"])
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the optimizer state")
    return {
        "params": params_from_jax(state["params"], device),
        "opt": {"count": torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32,
                                      device=device),
                "mu": params_from_jax(adam.mu, device),
                "nu": params_from_jax(adam.nu, device)},
        "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32, device=device),
    }


def states_from_jax(states, into: dict, slots=None) -> dict:
    """Copy rows ``slots`` (default: all) of a stacked JAX state into the
    same rows of the port's stacked state ``into`` (a scheduler's or a
    multipeer engine's ``states``), in place, so the storage its kernels
    write stays the same; every leaf must match in shape past the slot
    axis.  Returns ``into``."""
    def copy(src, dst):
        for key, value in src.items():
            if isinstance(value, dict):
                copy(value, dst[key])
                continue
            a = _tensor(value, "cpu")
            rows = range(a.shape[0]) if slots is None else slots
            if a.shape[1:] != dst[key].shape[1:]:
                raise ValueError(f"{key}: {tuple(a.shape)} vs {tuple(dst[key].shape)}")
            for r in rows:
                dst[key][r].copy_(a[r])

    copy(states, into)
    return into
